"""SPBase: the root runtime object of the port's engines (the port of
mpisppy_tpu/core/spbase.py).

The whole scenario batch lives on the device as stacked tensors:
probabilities and nonant indices come from the ScenarioBatch, the
per-tree-node reductions are membership matmuls (ref. spbase.py:311
_create_communicators), and a batch whose scenarios share one
constraint matrix and quadratic keeps them unbatched, so the solver
factors ONE (n, n) KKT matrix for the whole batch.

Per-batch device cache (``batch_cache``): every in-process cylinder of
a wheel builds an engine over the SAME host batch, so the shipped
shared matrix and the bound vectors are cached on the batch, keyed by
(field, dtype, device), and shared by every engine instead of each
holding its own copy (reference UC: 2.7 GB of A per engine). Torch
tensors are mutable: no consumer writes a cached tensor in place, the
rule the chunked path keeps for its shared states.

Scenario-axis mesh (``mesh=``, parallel/mesh.py): the batch is padded
with zero-probability copies of its last scenario to a multiple of the
world size (rounded further so a per-rank ``subproblem_chunk`` divides
the shard), and the engine holds only this rank's contiguous shard of
every per-scenario tensor (``ir/batch.shard_batch``: global
probabilities, global tree-node columns); a shared A and its factors
are each rank's own copy. ``self.batch`` is the shard, ``global_batch``
the padded whole and ``_S_orig`` the real scenario count. Reductions
over scenarios are this shard's terms summed over the ranks (one
all-reduce each; parallel/mesh.node_means for x̄, the same body as
without a mesh), and the batch device cache is bypassed: the shard is
this engine's own.

Scenario sources (``scenario_source``, mpisppy_tpu_torch/stream): a
``streamed`` or ``synthesized`` source replaces the device residency of
the five per-scenario vector fields (l/u/lb/ub/c) with per-chunk
staging. It needs the chunked loop (``subproblem_chunk``) and a shared
structure; ``qp_data`` then carries the source's exact 2-row setup
surrogates, ``c`` the cost surrogate, and ``P_diag`` / ``c_stage`` stay
on the host (the chunked loop broadcasts the shared P row). On a mesh
each rank's source covers its shard, and a synthesized source folds the
GLOBAL scenario ids (the shard's offset).
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from .. import obs
from ..ir.batch import ScenarioBatch
from ..ops.qp_solver import QPData, SplitMatrix, split_f32_np
from ..utils.runtime import DTYPE, resolve_device, to_host


def ship_stacked(a_np, dtype, device):
    """(S, ...) stacked host array -> device tensor of ``dtype``, its
    bytes booked on ``xfer.device_put_bytes``."""
    a = np.asarray(a_np)
    if not a.flags.writeable:
        # a zero-stride view (a synthesized batch's template rows)
        a = np.array(a)
    t = torch.as_tensor(a, dtype=dtype)
    obs.counter_add("xfer.device_put_bytes",
                    t.numel() * t.element_size())
    return t.to(device)


def ship_shared_matrix(A2d, dtype, device, split=False):
    """Shared (m, n) constraint matrix -> device tensor, or the df32
    SplitMatrix pair with its packed structure: the host structure
    analysis (ops/packed.analyze_structure) runs here, while the
    sparsity pattern is in hand, and ships as index arrays that
    qp_setup turns into the packed matvec form. No f64 copy of a split
    matrix ever reaches the device."""
    A = np.asarray(A2d)
    if not split:
        return ship_stacked(A, dtype, device)
    from ..ops.packed import analyze_structure
    rows, cols = np.nonzero(A)
    struct = analyze_structure(rows, cols, A.shape[0], A.shape[1])
    hi_np, lo_np = split_f32_np(A)
    obs.counter_add("xfer.device_put_bytes", hi_np.nbytes + lo_np.nbytes)
    return SplitMatrix(torch.as_tensor(hi_np).to(device),
                       torch.as_tensor(lo_np).to(device), struct=struct)


_CACHE_LOCK = threading.Lock()


def batch_cache(batch):
    """(cache dict, lock) of ``batch``'s device cache, created on first
    use. Cylinder threads build engines concurrently, so every build of
    a cached entry runs under the lock: otherwise each thread would put
    its own multi-GB copy on the device before any cache write landed."""
    with _CACHE_LOCK:
        cache = getattr(batch, "_dev_cache", None)
        if cache is None:
            cache = batch._dev_cache = {"_lock": threading.Lock()}
    return cache, cache["_lock"]


def cached(batch, key, fn):
    """``fn()`` once per (batch, key), shared by every engine."""
    cache, lock = batch_cache(batch)
    with lock:
        if key not in cache:
            cache[key] = fn()
        return cache[key]


class SPBase:
    def __init__(self, batch: ScenarioBatch, options=None, dtype=None,
                 device=None, mesh=None):
        """``device``: None for the CUDA device (raises without one);
        ``"cpu"`` runs on the CPU. ``mesh``: a parallel/mesh.Mesh whose
        ranks shard the scenario axis (the mesh's device is the
        engine's)."""
        self._S_orig = batch.S
        self.mesh = mesh
        self._shard_ops = None
        self._row0 = 0
        if mesh is not None:
            from ..parallel.mesh import mesh_padding, pad_batch_for_mesh
            chunk = int((options or {}).get("subproblem_chunk", 0) or 0)
            batch, self._S_orig = pad_batch_for_mesh(
                batch, mesh_padding(batch.S, mesh.size, chunk))
            device = mesh.device
        # the padded whole: structure detection and the probability
        # check read it; every tensor ships from the shard below
        self.global_batch = whole = batch
        if mesh is not None and mesh.size > 1:
            from ..ir.batch import shard_batch
            from ..parallel.mesh import ShardedScenarioOps
            self._shard_ops = ShardedScenarioOps(
                mesh, whole.tree,
                tuple((sl.start, sl.stop)
                      for sl in whole.stage_slot_slices), whole.S)
            self._row0 = self._shard_ops.lo
            batch = shard_batch(whole, self._shard_ops.lo,
                                self._shard_ops.hi)
        self.device = resolve_device(device)
        self.batch = batch
        self.options = dict(options or {})
        self.dtype = dtype or DTYPE
        self.spcomm = None
        self._stream_source = None
        from ..utils.config import STREAM_SOURCES
        stream_kind = str(self.options.get("scenario_source", "resident"))
        if stream_kind not in STREAM_SOURCES:
            raise ValueError(f"unknown scenario_source {stream_kind!r}; "
                             f"known: {STREAM_SOURCES}")
        streaming = stream_kind != "resident"
        if streaming and not int(self.options.get("subproblem_chunk",
                                                  0) or 0):
            raise ValueError(
                "scenario_source='streamed'/'synthesized' requires "
                "subproblem_chunk: the chunked hot loop is the "
                "streaming consumer")
        b = batch
        # partial_probabilities: this engine holds one SHARD of the
        # scenario set (core/aph_shard.py), whose scenarios carry their
        # GLOBAL probabilities and sum to the shard's mass
        if not self.options.get("partial_probabilities") \
                and abs(float(whole.prob.sum()) - 1.0) > 1e-6:
            raise ValueError("scenario probabilities must sum to 1 "
                             "(ref. spbase.py:443 checks)")
        t, dev = self.dtype, self.device
        self.prob = ship_stacked(b.prob, t, dev)
        self.vprob = None
        if not streaming:
            self.c = ship_stacked(b.c, t, dev)
            self.c_stage = ship_stacked(b.c_stage, t, dev)
            self.P_diag = ship_stacked(b.P_diag, t, dev)
        else:
            # c is the source's surrogate (below); the stage-split cost
            # and the stacked P stay on the host
            self.c = self.c_stage = self.P_diag = None
        self.c0 = ship_stacked(b.c0, t, dev)
        self.c0_stage = ship_stacked(b.c0_stage, t, dev)
        self.nonant_idx = torch.as_tensor(np.asarray(b.nonant_idx),
                                          dtype=torch.long).to(dev)
        # shared-structure detection: every scenario carries the SAME
        # constraint matrix and quadratic (UC: randomness in the rhs)
        A_np, P_np = np.asarray(whole.A), np.asarray(whole.P_diag)
        if A_np.ndim == 2:
            self.shared_structure = bool((P_np == P_np[0]).all())
            if not self.shared_structure:
                raise ValueError(
                    "batch has a shared A but per-scenario P_diag — the "
                    "QP kernel's shared mode needs both")
        else:
            self.shared_structure = bool(
                whole.S > 1 and (A_np == A_np[0]).all()
                and (P_np == P_np[0]).all())
        # a mesh engine's tensors are its own (the shard is a new host
        # batch, and the shared A is each rank's copy): no cache
        cache_on = mesh is None
        if self.shared_structure:
            # df32: A lives on the device only as the two-term f32 split
            split = str(self.options.get("subproblem_precision",
                                         "")) == "df32"
            if split and t != torch.float64:
                raise ValueError("subproblem_precision='df32' needs "
                                 f"dtype=float64; got {t}")
            A2d = A_np if A_np.ndim == 2 else A_np[0]
            def ship_A():
                return ship_shared_matrix(A2d, t, dev, split=split)
            A_dev = cached(b, ("A", str(t), str(dev), split), ship_A) \
                if cache_on else ship_A()
            P_dev = ship_stacked(P_np[0], t, dev)

            def vec(name):
                if not cache_on:
                    return ship_stacked(getattr(b, name), t, dev)
                return cached(b, (name, str(t), str(dev)),
                              lambda: ship_stacked(getattr(b, name), t,
                                                   dev))
        else:
            A_dev = ship_stacked(np.asarray(b.A), t, dev)
            P_dev = self.P_diag

            def vec(name):
                return ship_stacked(getattr(b, name), t, dev)
        if streaming:
            if not self.shared_structure:
                raise ValueError(
                    "scenario_source='streamed'/'synthesized' requires "
                    "a shared-structure batch (one A/P across "
                    "scenarios, the representation the chunked "
                    "single-factor loop streams over; farmer's synth "
                    "family shares A: stream.synth.synth_batch)")
            from ..stream.source import make_source
            self._stream_source = make_source(b, self.options, t, dev,
                                              id_offset=self._row0)
            # the exact 2-row setup surrogates (stream/source.py):
            # factors bit-equal to the resident path's, without the
            # (S, m) / (S, n) residency
            l2, u2, lb2, ub2, c2 = self._stream_source.setup_arrays(t)
            self.c = c2
            self.qp_data = QPData(P_dev, A_dev, l2, u2, lb2, ub2)
        else:
            self.qp_data = QPData(P_dev, A_dev, vec("l"), vec("u"),
                                  vec("lb"), vec("ub"))
        self.memberships = [ship_stacked(b.tree.membership(s + 1), t, dev)
                            for s in range(b.tree.num_stages - 1)]
        self.slot_slices = b.stage_slot_slices
        self.slot_bounds = tuple((sl.start, sl.stop)
                                 for sl in b.stage_slot_slices)

    def close_stream(self):
        """Shut the scenario source's prefetch thread down (idempotent;
        the next chunked pass binds again). The hub calls it at
        finalize."""
        if self._stream_source is not None:
            self._stream_source.close()

    def _refuse_streamed(self, what):
        """Raise for an entry point that reads full-width scenario
        blocks, which a streamed or synthesized source never ships."""
        if self._stream_source is not None:
            raise RuntimeError(
                f"{what} reads the full-width scenario blocks, which a "
                "streamed/synthesized scenario source never ships; the "
                "chunked loop's per-chunk passes cover the PH surface")

    # ---- reductions (the reference's Allreduce family) ----
    def Eobjective(self, obj_per_scen):
        """Probability-weighted expected objective (ref. phbase.py:279);
        on a mesh the local dot summed over the ranks."""
        v = torch.dot(self.prob, obj_per_scen)
        return v if self._shard_ops is None else self.mesh.all_sum(v)

    # ---- mesh plumbing (identities without a sharded mesh) ----
    @property
    def shard_mesh(self):
        """The mesh when this engine is sharded over more than one rank,
        else None: the argument the collective helpers take."""
        return None if self._shard_ops is None else self.mesh

    def _all_ranks(self, flag) -> bool:
        """``flag`` (host or device bool) on every rank."""
        if self._shard_ops is None:
            return bool(flag)
        return self.mesh.all_true(flag)

    def gather_rows(self, t):
        """The (S_pad, ...) whole of a per-scenario tensor on every rank
        (``t`` itself without a sharded mesh)."""
        if self._shard_ops is None:
            return t
        return self.mesh.gather_rows(t, self._shard_ops.S)

    def scenario_objectives(self, x):
        """Per-scenario objective values of an (S, n) solution block."""
        self._refuse_streamed("scenario_objectives")
        quad = 0.5 * torch.sum(self.P_diag * x * x, dim=-1)
        return quad + torch.sum(self.c * x, dim=-1) + self.c0

    @property
    def xbar_weights(self):
        """(S,) scenario probabilities, or (S, K) per-variable weights."""
        return self.prob if self.vprob is None else self.vprob

    def compute_xbar(self, xn):
        """x̄ of an (S, K) nonant block: this engine's rows, reduced
        over the ranks on a sharded mesh (one all-reduce)."""
        from ..parallel.mesh import node_means
        if self._shard_ops is not None:
            self._shard_ops.book_collective(xn.dtype, full=False)
        return node_means(self.memberships, self.slot_bounds,
                          self.xbar_weights, xn, self.shard_mesh)[0]

    def nonants_of(self, x):
        return x[..., self.nonant_idx]

    # ---- reporting (ref. spbase.py:516-576) ----
    def gather_var_values(self, x):
        """Host-side dict {var_name: (S, size) ndarray}."""
        xh = to_host(x)
        return {name: xh[:, sl]
                for name, sl in self.batch.template.var_slices.items()}
