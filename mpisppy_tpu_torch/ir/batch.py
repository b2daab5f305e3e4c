"""ScenarioBatch: the stacked, device-ready scenario tensor block.

This replaces the reference's per-rank dict of Pyomo
models (ref. mpisppy/spbase.py:242 _create_scenarios): all S scenarios of a
problem are lowered to StandardForm and stacked along a leading scenario
axis. Everything the algorithms need per-iteration lives in these arrays.

Nonant bookkeeping mirrors _attach_nonant_indices (ref. spbase.py:272):
``nonant_idx`` maps the K nonanticipative slots (concatenated over non-leaf
stages) into columns of x, and ``nonant_stage`` records each slot's stage.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .standard_form import StandardForm, lower
from .tree import ScenarioTree


@dataclass
class ScenarioBatch:
    tree: ScenarioTree
    template: StandardForm          # scenario 0's form (shared structure)
    # stacked numeric data (numpy on host; engines move to device)
    c: np.ndarray                   # (S, n)
    c0: np.ndarray                  # (S,)
    P_diag: np.ndarray              # (S, n)
    A: np.ndarray                   # (S, m, n); or (m, n) when every
                                    # scenario shares one constraint
                                    # matrix (see shared_A) — the
                                    # representation that lets a
                                    # reference-scale UC batch (m·n ~
                                    # 3.4e8 entries) hold ONE matrix
                                    # instead of S copies
    l: np.ndarray                   # (S, m)
    u: np.ndarray                   # (S, m)
    lb: np.ndarray                  # (S, n)
    ub: np.ndarray                  # (S, n)
    c_stage: np.ndarray             # (S, T, n)
    c0_stage: np.ndarray            # (S, T)
    prob: np.ndarray                # (S,)
    # nonant structure (shared across scenarios)
    nonant_idx: np.ndarray          # (K,) int columns of x
    nonant_stage: np.ndarray        # (K,) int 1-based stage per slot
    stage_slot_slices: list = field(default_factory=list)  # per non-leaf stage: slice into K

    @property
    def S(self):
        return self.c.shape[0]

    @property
    def n(self):
        return self.c.shape[1]

    @property
    def m(self):
        return self.A.shape[-2]

    @property
    def K(self):
        return self.nonant_idx.shape[0]

    @property
    def integer(self):
        return self.template.integer

    @property
    def shared_A(self):
        """True when one (m, n) matrix serves every scenario."""
        return self.A.ndim == 2

    def A_of(self, s):
        """Scenario s's (m, n) constraint matrix under either layout."""
        return self.A if self.A.ndim == 2 else self.A[s]

    def nonants_of(self, x):
        """Extract the (.., K) nonant slots from a (.., n) x array."""
        return x[..., self.nonant_idx]


def _nonant_indexing(f0, tree):
    """Nonant slots, concatenated by stage (ref. spbase.py:272)."""
    nonant_idx, nonant_stage, slot_slices = [], [], []
    k = 0
    for t, names in enumerate(tree.nonant_names_per_stage, start=1):
        for vn in names:
            sl = f0.var_slices[vn]
            nonant_idx.extend(range(sl.start, sl.stop))
            nonant_stage.extend([t] * (sl.stop - sl.start))
        slot_slices.append(slice(k, len(nonant_idx)))
        k = len(nonant_idx)
    return (np.asarray(nonant_idx, dtype=np.int32),
            np.asarray(nonant_stage, dtype=np.int32), slot_slices)


# vector fields a vector_patch may address, with their (kind ->
# name-space) mapping: constraint-row fields address con_slices,
# variable-column fields address var_slices
_PATCH_ROW_FIELDS = ("l", "u")
_PATCH_COL_FIELDS = ("lb", "ub", "c")


def _apply_patch(vecs, f0, patch, scen_name):
    """Apply one scenario's {(field, block_name): values} patch to copies
    of the template vectors (see build_batch's vector_patch)."""
    for (fld, bname), val in patch.items():
        val = np.asarray(val, dtype=np.float64)
        if fld in _PATCH_ROW_FIELDS:
            sl = f0.con_slices.get(bname)
            if sl is None:
                raise KeyError(
                    f"{scen_name}: patch addresses unknown constraint "
                    f"{bname!r} (known: {list(f0.con_slices)})")
        elif fld in _PATCH_COL_FIELDS:
            sl = f0.var_slices.get(bname)
            if sl is None:
                raise KeyError(
                    f"{scen_name}: patch addresses unknown variable "
                    f"{bname!r} (known: {list(f0.var_slices)})")
        else:
            raise KeyError(
                f"{scen_name}: patch field {fld!r} not supported "
                f"(row fields: {_PATCH_ROW_FIELDS}, column fields: "
                f"{_PATCH_COL_FIELDS})")
        want = sl.stop - sl.start
        if val.shape != (want,):
            raise ValueError(
                f"{scen_name}: patch ({fld!r}, {bname!r}) has shape "
                f"{val.shape}, block needs ({want},)")
        if fld == "c":
            # keep the per-stage cost split consistent: a patched var's
            # cost lives in exactly its own stage's row (enforced), so
            # the total and that row move together
            t = int(f0.stage_of_var[sl.start]) - 1
            others = [tt for tt in range(vecs["c_stage"].shape[0])
                      if tt != t]
            if others and np.abs(vecs["c_stage"][others, sl]).max() > 0:
                raise ValueError(
                    f"{scen_name}: cannot patch c of {bname!r} — its "
                    "cost spans stages other than its own")
            vecs["c_stage"][t, sl] = val
            vecs["c"][sl] = val
        else:
            vecs[fld][sl] = val
    return vecs


def build_batch(scenario_creator, tree: ScenarioTree, creator_kwargs=None,
                num_stages=None, vector_patch=None) -> ScenarioBatch:
    """Call `scenario_creator(name, **kwargs) -> Model` for every scenario in
    the tree and stack the lowered forms. The creator contract mirrors the
    reference's (ref. spbase.py:477-492) minus the Pyomo attachments: the
    tree (not the model) declares the nonant variable names per stage.

    When every scenario lowers to the SAME constraint matrix and
    quadratic (randomness in the rhs/bounds/costs only — uc, sizes,
    sslp, hydro), the batch stores ``A`` once as (m, n) instead of
    (S, m, n): detected by comparison on the default path, declared by
    construction on the fast path below.

    ``vector_patch``: the structure-shared FAST path for large
    instances, where re-running the creator S times would rebuild an
    identical (m, n) matrix per scenario (minutes of host time and
    S × |A| transient memory at reference-UC scale, ref.
    examples/uc/2013-05-11: ~90 generators × 48 periods). The creator
    runs ONCE (scenario 0 → template); every scenario's vectors are the
    template's with ``vector_patch(scenario_name, **creator_kwargs) ->
    {(field, block): values}`` applied, addressing named constraint
    rows ("l"/"u" via Model.constr names) and variable columns
    ("lb"/"ub"/"c"). Scenario 0 is patched too — so a correct patch
    function reproduces the template's own vectors at scenario 0, which
    is asserted (cheap, and catches creator/patch drift)."""
    creator_kwargs = creator_kwargs or {}
    T = num_stages or tree.num_stages

    if vector_patch is not None:
        f0 = lower(scenario_creator(tree.scen_names[0], **creator_kwargs),
                   num_stages=T)
        fields = dict(c=f0.c, c0=np.float64(f0.c0), P_diag=f0.P_diag,
                      l=f0.l, u=f0.u, lb=f0.lb, ub=f0.ub,
                      c_stage=f0.c_stage, c0_stage=f0.c0_stage)
        stacks = {k: [] for k in fields}
        for s, name in enumerate(tree.scen_names):
            vecs = {k: np.array(v, dtype=np.float64)
                    for k, v in fields.items()}
            _apply_patch(vecs, f0, vector_patch(name, **creator_kwargs),
                         name)
            if s == 0:
                for k, v in vecs.items():
                    if not np.array_equal(v, np.asarray(fields[k],
                                                        dtype=np.float64)):
                        raise ValueError(
                            f"vector_patch({name}) changed template "
                            f"field {k!r} at scenario 0 — the patch "
                            "must reproduce the creator's own data "
                            "there (creator/patch drift)")
            for k, v in vecs.items():
                stacks[k].append(v)
        nonant_idx, nonant_stage, slot_slices = _nonant_indexing(f0, tree)
        return ScenarioBatch(
            tree=tree, template=f0,
            c=np.stack(stacks["c"]), c0=np.stack(stacks["c0"]),
            P_diag=np.stack(stacks["P_diag"]),
            A=f0.A,                         # ONE shared matrix
            l=np.stack(stacks["l"]), u=np.stack(stacks["u"]),
            lb=np.stack(stacks["lb"]), ub=np.stack(stacks["ub"]),
            c_stage=np.stack(stacks["c_stage"]),
            c0_stage=np.stack(stacks["c0_stage"]),
            prob=tree.probabilities.copy(),
            nonant_idx=nonant_idx, nonant_stage=nonant_stage,
            stage_slot_slices=slot_slices,
        )

    forms = [lower(scenario_creator(name, **creator_kwargs), num_stages=T)
             for name in tree.scen_names]
    f0 = forms[0]
    for f in forms[1:]:
        if f.n != f0.n or f.m != f0.m or f.var_names != f0.var_names:
            raise ValueError(
                f"scenario {f.name} has different structure from {f0.name}: "
                "all scenarios must share variables and constraint counts")

    nonant_idx, nonant_stage, slot_slices = _nonant_indexing(f0, tree)

    # shared-structure compaction: one (m, n) matrix when every scenario
    # carries the same A and P (the chunked/single-factor kernel path;
    # detection mirrors what core/spbase.py used to re-derive from the
    # stacked copies)
    shared = len(forms) > 1 and all(
        np.array_equal(f.A, f0.A) and np.array_equal(f.P_diag, f0.P_diag)
        for f in forms[1:])

    stack = lambda attr: np.stack([getattr(f, attr) for f in forms])
    return ScenarioBatch(
        tree=tree, template=f0,
        c=stack("c"), c0=stack("c0"), P_diag=stack("P_diag"),
        A=f0.A if shared else stack("A"), l=stack("l"), u=stack("u"),
        lb=stack("lb"), ub=stack("ub"),
        c_stage=stack("c_stage"), c0_stage=stack("c0_stage"),
        prob=tree.probabilities.copy(),
        nonant_idx=nonant_idx, nonant_stage=nonant_stage,
        stage_slot_slices=slot_slices,
    )


def subtree(t: ScenarioTree, lo: int, hi: int) -> ScenarioTree:
    """Scenarios [lo, hi) of a tree, keeping GLOBAL probabilities and the
    full per-stage node index space (membership columns stay global, so
    cross-shard node summands add)."""
    # COPIES, not views: np.asarray in ScenarioTree.__init__ keeps a
    # slice view alive, and a caller overwriting the subtree's
    # probabilities would silently corrupt the parent tree's
    return ScenarioTree(
        t.scen_names[lo:hi], t.node_path[lo:hi].copy(),
        t.nodes_per_stage, t.nonant_names_per_stage,
        probabilities=t.probabilities[lo:hi].copy())


def shard_batch(batch: ScenarioBatch, lo: int, hi: int) -> ScenarioBatch:
    """Slice scenarios [lo, hi) into a shard batch for a multi-process
    scenario-sharded engine (core/aph_shard.py) — the analog of a
    reference rank's local-scenario subset (ref. spbase.py:172
    _calculate_scenario_ranks contiguous shard map). Probabilities stay
    GLOBAL (the shard's prob sums to its mass, not 1; pass
    ``partial_probabilities`` to the engine), and membership matrices
    keep their full per-stage node columns so cross-shard reductions are
    plain sums of per-node summands."""
    from dataclasses import replace

    sub_tree = subtree(batch.tree, lo, hi)
    sl = slice(lo, hi)
    return replace(
        batch, tree=sub_tree,
        c=batch.c[sl], c0=batch.c0[sl], P_diag=batch.P_diag[sl],
        A=batch.A if batch.shared_A else batch.A[sl],
        l=batch.l[sl], u=batch.u[sl],
        lb=batch.lb[sl], ub=batch.ub[sl],
        c_stage=batch.c_stage[sl], c0_stage=batch.c0_stage[sl],
        prob=batch.prob[sl])


_BATCH_ARRAYS = ("c", "c0", "P_diag", "A", "l", "u", "lb", "ub", "c_stage",
                 "c0_stage", "prob", "nonant_idx", "nonant_stage")
_FORM_ARRAYS = ("c", "P_diag", "l", "u", "lb", "ub", "integer",
                "stage_of_var", "c_stage", "c0_stage")


def save_batch(batch: ScenarioBatch, path) -> None:
    """Write ``batch`` to one uncompressed ``.npz``: the stacked arrays,
    the tree, the slot slices and the template form (whose A is not
    written again when the batch shares it), with the names and slices
    as one JSON string. ``load_batch`` reads it back; the ranks of a
    mesh use the pair to start from one host batch built once."""
    import json
    t, f = batch.tree, batch.template
    meta = {
        "tree": {"scen_names": list(t.scen_names),
                 "nodes_per_stage": [int(n) for n in t.nodes_per_stage],
                 "nonant_names_per_stage": t.nonant_names_per_stage},
        "slot_slices": [[s.start, s.stop] for s in batch.stage_slot_slices],
        "form": {"name": f.name, "n": int(f.n), "m": int(f.m),
                 "c0": float(f.c0), "sense": f.sense,
                 "var_names": list(f.var_names),
                 "var_slices": {k: [s.start, s.stop]
                                for k, s in f.var_slices.items()},
                 "con_slices": {k: [s.start, s.stop]
                                for k, s in f.con_slices.items()},
                 "A_shared": f.A is batch.A}}
    arrays = {k: np.asarray(getattr(batch, k)) for k in _BATCH_ARRAYS}
    arrays.update({f"form_{k}": np.asarray(getattr(f, k))
                   for k in _FORM_ARRAYS})
    if f.A is not batch.A:
        arrays["form_A"] = np.asarray(f.A)
    arrays["tree_node_path"] = t.node_path
    arrays["tree_probabilities"] = t.probabilities
    np.savez(path, meta=np.asarray(json.dumps(meta)), **arrays)


def load_batch(path) -> ScenarioBatch:
    """The ScenarioBatch ``save_batch`` wrote to ``path``."""
    import json

    with np.load(path) as z:
        meta = json.loads(str(z["meta"]))
        arr = {k: z[k] for k in z.files if k != "meta"}
    fm = meta["form"]
    sl = lambda d: {k: slice(*v) for k, v in d.items()}  # noqa: E731
    form = StandardForm(
        name=fm["name"], n=fm["n"], m=fm["m"], c0=fm["c0"],
        A=arr["A"] if fm["A_shared"] else arr["form_A"],
        var_names=fm["var_names"], var_slices=sl(fm["var_slices"]),
        con_slices=sl(fm["con_slices"]), sense=fm["sense"],
        **{k: arr[f"form_{k}"] for k in _FORM_ARRAYS})
    tm = meta["tree"]
    tree = ScenarioTree(tm["scen_names"], arr["tree_node_path"],
                        tm["nodes_per_stage"], tm["nonant_names_per_stage"],
                        probabilities=arr["tree_probabilities"])
    return ScenarioBatch(
        tree=tree, template=form,
        stage_slot_slices=[slice(a, b) for a, b in meta["slot_slices"]],
        **{k: arr[k] for k in _BATCH_ARRAYS})
