"""Instance building + the scenario-axis batcher (host side): the
port's copy of the JAX package's serve/batch.py.

A serve *instance* is a base model family plus a **data patch**: the
request names vector entries — constraint rows (``l``/``u``) by
constraint-block name, variable columns (``lb``/``ub``/``c``) by
variable name — exactly the fields ``ir/batch.build_batch``'s
``vector_patch`` fast path may touch. Structure (the constraint
matrix, the quadratic, the tree, the nonant set) is determined by
(model, structural ``model_kwargs``, num_scens) alone. That split IS
the serving contract: every instance of one bucket shares the warm
engine, the kernel plans and the KKT factorizations (serve/cache),
and differs only in stacked scenario vectors.

**Stacking** (``stack_instances``): k same-bucket instances coalesce
into ONE batch of k·S scenarios whose tree is the *forest* of the k
instance trees — each instance keeps its own stage-1 root (node ids
offset per block), so the nonanticipativity reductions
(``compute_xbar``'s per-node averages) never couple tenants, while
the whole group rides one kernel launch per PH iteration. Randomness-
in-rhs instances share one factorization by construction (README
execution model), so batching makes the kernels MORE efficient per
request, not less. Probabilities are scaled 1/k (the stacked
objective is the uniform mixture); per-request expectations divide
back out by block mass (``demux_expectation``).

numpy + the ir/ host layer only.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..ir.batch import (ScenarioBatch, _PATCH_COL_FIELDS,
                        _PATCH_ROW_FIELDS, _apply_patch)
from ..ir.tree import ScenarioTree
from ..utils.config import KNOWN_MODELS, AlgoConfig, RunConfig
from .cache import bucket_fingerprint

_PATCH_FIELDS = _PATCH_ROW_FIELDS + _PATCH_COL_FIELDS
_ALGO_KEYS = tuple(f.name for f in dataclasses.fields(AlgoConfig))


class BadRequest(ValueError):
    """A payload the service refuses at admission (HTTP 400)."""


def request_algo(payload: dict) -> AlgoConfig:
    """The request's engine options: AlgoConfig defaults overlaid with
    the payload's ``algo`` dict (whitelisted to AlgoConfig fields —
    part of the bucket identity, since knobs like the kernel mode or
    iteration budgets change the engine's factors and kernel plans)."""
    overrides = dict(payload.get("algo") or {})
    bad = sorted(set(overrides) - set(_ALGO_KEYS))
    if bad:
        raise BadRequest(f"unknown algo option(s) {bad}; "
                         f"known: {sorted(_ALGO_KEYS)}")
    algo = AlgoConfig(**overrides)
    algo.validate()
    return algo


def base_runconfig(payload: dict) -> RunConfig:
    """The structural RunConfig an instance's base batch is built from
    (utils/vanilla.build_batch_for consumes it)."""
    return RunConfig(
        model=payload["model"],
        num_scens=int(payload.get("num_scens", 3)),
        model_kwargs=dict(payload.get("model_kwargs") or {}),
        hub="ph", algo=request_algo(payload)).validate()


def bucket_key(payload: dict) -> str:
    """The request's shape-bucket fingerprint: model + structural
    kwargs + scenario count + algo knobs + hub family. Everything that
    shapes the engine's tensors, factors and kernel plans; nothing that is per-request data."""
    algo = request_algo(payload)
    return bucket_fingerprint({
        "model": payload["model"],
        "num_scens": int(payload.get("num_scens", 3)),
        "model_kwargs": dict(payload.get("model_kwargs") or {}),
        "hub": "ph", "algo": algo.to_options()})


def engine_key(bucket: str, stack: int) -> str:
    """The warm-cache key: a stacked wheel of k requests is its own
    engine shape (k·S scenario rows), so it buckets separately from
    the solo shape while repeating group sizes still reuse."""
    return f"{bucket}:x{int(stack)}"


def validate_payload(payload) -> dict:
    """Admission-time validation (no model build): raises
    :class:`BadRequest` with a client-facing message. Returns the
    payload (dict) on success."""
    if not isinstance(payload, dict):
        raise BadRequest("request body must be a JSON object")
    model = payload.get("model")
    if model not in KNOWN_MODELS:
        raise BadRequest(f"unknown model {model!r}; known: "
                         f"{list(KNOWN_MODELS)}")
    try:
        n = int(payload.get("num_scens", 3))
    except (TypeError, ValueError):
        raise BadRequest("num_scens must be an integer") from None
    if n <= 0:
        raise BadRequest("num_scens must be positive")
    if not isinstance(payload.get("model_kwargs") or {}, dict):
        raise BadRequest("model_kwargs must be an object")
    request_algo(payload)               # raises BadRequest on bad knobs
    dl = payload.get("deadline")
    if dl is not None and (not isinstance(dl, (int, float)) or dl <= 0):
        raise BadRequest("deadline must be a positive number of seconds")
    patch = payload.get("patch")
    chain = payload.get("chain")
    if patch is not None and chain is not None:
        raise BadRequest("give either 'patch' or 'chain', not both")
    if chain is not None:
        if not isinstance(chain, list) or not chain:
            raise BadRequest("chain must be a non-empty list of steps")
        for i, step in enumerate(chain):
            if not isinstance(step, dict):
                raise BadRequest(f"chain step {i} must be an object")
            _check_patch_shape(step.get("patch"), f"chain step {i}")
    else:
        _check_patch_shape(patch, "patch")
    return payload


def _check_patch_shape(patch, what):
    if patch is None:
        return
    if not isinstance(patch, dict):
        raise BadRequest(f"{what} must be an object "
                         "{field: {block: values}}")
    for fld, blocks in patch.items():
        if fld not in _PATCH_FIELDS:
            raise BadRequest(
                f"{what}: field {fld!r} not patchable (row fields: "
                f"{_PATCH_ROW_FIELDS}, column fields: "
                f"{_PATCH_COL_FIELDS}) — structure is bucket identity")
        if not isinstance(blocks, dict):
            raise BadRequest(f"{what}: {fld!r} must map block names "
                             "to value lists")
        for bname, vals in blocks.items():
            try:
                np.asarray(vals, dtype=np.float64)
            except (TypeError, ValueError):
                raise BadRequest(
                    f"{what}: ({fld!r}, {bname!r}) values must be "
                    "numeric") from None


def _per_scenario_patches(patch: dict, S: int) -> list:
    """JSON patch -> one ``{(field, block): (len,) row}`` dict per
    scenario. Values are either one row (applied to every scenario)
    or an (S, len) list-of-rows (per-scenario data)."""
    per = [dict() for _ in range(S)]
    for fld, blocks in (patch or {}).items():
        for bname, vals in blocks.items():
            a = np.asarray(vals, dtype=np.float64)
            if a.ndim == 1:
                rows = [a] * S
            elif a.ndim == 2 and a.shape[0] == S:
                rows = [a[s] for s in range(S)]
            else:
                raise BadRequest(
                    f"patch ({fld!r}, {bname!r}): give one row or "
                    f"(num_scens, len) = ({S}, ...) rows; got shape "
                    f"{a.shape}")
            for s in range(S):
                per[s][(fld, bname)] = rows[s]
    return per


def apply_patch(batch: ScenarioBatch, patch: dict) -> ScenarioBatch:
    """A new batch = ``batch`` with the request's data patch applied
    (the stacked-array twin of ir/batch's per-scenario vector_patch
    application; same validation, same c/c_stage consistency rule).
    The input batch is never mutated — base batches are shared."""
    if not patch:
        return batch
    per = _per_scenario_patches(patch, batch.S)
    arrs = {k: np.array(getattr(batch, k))
            for k in ("c", "l", "u", "lb", "ub", "c_stage")}
    for s in range(batch.S):
        if not per[s]:
            continue
        # rows of the stacked arrays are views — _apply_patch mutates
        # them in place with the block-name/shape/stage-cost checks
        vecs = {k: arrs[k][s] for k in arrs}
        _apply_patch(vecs, batch.template, per[s],
                     batch.tree.scen_names[s])
    return dataclasses.replace(batch, **arrs)


def forest_tree(trees: list) -> ScenarioTree:
    """The stacked group's tree: the disjoint union of k instance
    trees, each keeping its OWN root (stage-t node ids offset by
    block), probabilities scaled 1/k. Consensus therefore never
    couples blocks: compute_xbar's per-node averages see k independent
    families of nodes. Node contiguity (the sharding contract the
    tree validates) is preserved — blocks are contiguous."""
    base = trees[0]
    k = len(trees)
    T1 = base.num_stages - 1
    for t in trees[1:]:
        if t.num_stages != base.num_stages or t.S != base.S \
                or t.nodes_per_stage != base.nodes_per_stage:
            raise BadRequest("stacked instances must share one tree "
                             "shape (same bucket)")
    paths = np.concatenate(
        [t.node_path
         + np.asarray([i * n for n in base.nodes_per_stage],
                      dtype=np.int32)[None, :]
         for i, t in enumerate(trees)], axis=0)
    tree = ScenarioTree(
        scen_names=[f"b{i}~{nm}" for i, t in enumerate(trees)
                    for nm in t.scen_names],
        node_paths=paths,
        nodes_per_stage=[n * k for n in base.nodes_per_stage],
        nonant_names_per_stage=base.nonant_names_per_stage,
        probabilities=np.concatenate(
            [t.probabilities / k for t in trees]))
    assert tree.node_path.shape == (k * base.S, T1)
    tree.validate()
    return tree


def stack_instances(batches: list) -> tuple:
    """k same-bucket instance batches -> (stacked batch, block slices).

    Structure is bucket-shared: A (and a shared template) comes from
    block 0 — per-scenario A blocks are IDENTICAL across instances of
    one bucket (only vectors were patched), so a shared-A base stays
    one (m, n) matrix and a per-scenario A stacks k identical copies
    of the base block layout."""
    base = batches[0]
    k = len(batches)
    if k == 1:
        return base, [slice(0, base.S)]
    cat = lambda attr: np.concatenate(
        [np.asarray(getattr(b, attr)) for b in batches], axis=0)
    stacked = ScenarioBatch(
        tree=forest_tree([b.tree for b in batches]),
        template=base.template,
        c=cat("c"), c0=cat("c0"), P_diag=cat("P_diag"),
        A=base.A if base.shared_A else cat("A"),
        l=cat("l"), u=cat("u"), lb=cat("lb"), ub=cat("ub"),
        c_stage=cat("c_stage"), c0_stage=cat("c0_stage"),
        prob=np.concatenate([np.asarray(b.prob) / k for b in batches]),
        nonant_idx=base.nonant_idx, nonant_stage=base.nonant_stage,
        stage_slot_slices=base.stage_slot_slices)
    blocks = [slice(i * base.S, (i + 1) * base.S) for i in range(k)]
    return stacked, blocks


def demux_expectation(per_scen, prob, blocks) -> list:
    """Per-request expectations from a stacked per-scenario vector:
    E_k[v] = sum(p_s v_s over block k) / block mass (the 1/k scaling
    divides back out — each request's answer is ITS OWN expectation,
    independent of how many tenants shared the wheel)."""
    v = np.asarray(per_scen, dtype=np.float64)
    p = np.asarray(prob, dtype=np.float64)
    out = []
    for bl in blocks:
        mass = float(p[bl].sum())
        out.append(float(np.dot(p[bl], v[bl]) / mass) if mass > 0
                   else None)
    return out
