"""Scenario-axis sharding over torch.distributed ranks (the port of the
JAX package's parallel/mesh.py).

The reference shards scenario objects over MPI ranks and Allreduces the
per-node x̄/x̄² vectors (ref. mpisppy/spbase.py:172
_calculate_scenario_ranks, phbase.py:196-201). The JAX package maps
that onto a 1-D device mesh ("scen") driven by ONE process, with
shard_map and psum inside jitted programs. The port goes back to the
reference's own model: one process per rank, each rank owning a
contiguous shard of the padded scenario axis on its own device, running
the same engine loop on its rows, with ``torch.distributed`` collectives
where the reference calls ``Allreduce``:

- :class:`Mesh` is one rank's view of the mesh (its rank, the world
  size, its device and the process group) and the few collectives the
  engines use: ``all_reduce`` (sum, max, min) and ``broadcast``. A rank
  that needs a full (S, ...) array writes its rows into a zero buffer
  and the buffer is all-reduced (``gather_rows``): the gloo backend has
  no ``all_gather`` on CUDA tensors, and one rank sharing a card with
  another runs gloo.
- :func:`node_means` and :func:`scenario_combine` are Compute_Xbar,
  Update_W and the scaled L1 convergence: local membership products
  over the global tree nodes, followed on a sharded mesh by one
  ``all_reduce`` of the per-stage (N_t, k_t) node tables (and one more
  for the convergence scalar), the per-node Allreduce of the
  reference. Every engine, sharded or not, reduces through them;
  :class:`ShardedScenarioOps` holds a rank's layout (its shard, the
  chunk layout) and the JAX names ``xbar``/``combine``.

Every host decision of a sharded engine is made from reduced values, so
all ranks take the same branch at the same iteration and meet in the
same collectives.

Scenario counts that do not divide the mesh are padded with
zero-probability copies of the last scenario (``pad_batch_for_mesh``);
pads contribute nothing to the probability-weighted reductions.
"""

from __future__ import annotations

import os

import numpy as np
import torch


class Mesh:
    """One rank's view of the scenario mesh. ``size`` is the world
    size (the JAX mesh's ``devices.size``); with a world of one there
    is no process group and every collective is the identity."""

    def __init__(self, rank, world, device, group=None, backend=None):
        self.rank = int(rank)
        self.world = int(world)
        self.device = torch.device(device)
        self.group = group
        self.backend = backend

    @property
    def size(self) -> int:
        return self.world

    def __repr__(self):
        return (f"Mesh(rank={self.rank}, world={self.world}, "
                f"device={self.device}, backend={self.backend})")

    def _reduce(self, t, op):
        if self.world == 1:
            return t
        import torch.distributed as dist
        buf = t.detach().clone().contiguous()
        dist.all_reduce(buf, op=op, group=self.group)
        return buf

    def all_sum(self, t):
        """Sum of ``t`` over the ranks (a new tensor)."""
        import torch.distributed as dist
        return self._reduce(t, dist.ReduceOp.SUM)

    def all_max(self, t):
        import torch.distributed as dist
        return self._reduce(t, dist.ReduceOp.MAX)

    def all_min(self, t):
        import torch.distributed as dist
        return self._reduce(t, dist.ReduceOp.MIN)

    def all_true(self, flag) -> bool:
        """Whether a host or device boolean holds on every rank (one
        host read)."""
        v = torch.as_tensor(bool(flag) if not isinstance(
            flag, torch.Tensor) else flag, device=self.device)
        return bool(self.all_min(v.to(torch.float64)).item())

    def broadcast(self, t, src=0):
        """``t`` as rank ``src`` holds it (a new tensor)."""
        if self.world == 1:
            return t
        import torch.distributed as dist
        buf = t.detach().clone().contiguous()
        dist.broadcast(buf, src=src, group=self.group)
        return buf

    def row_range(self, S: int):
        """[lo, hi) of this rank's contiguous shard of S rows."""
        L = S // self.world
        return self.rank * L, (self.rank + 1) * L

    def gather_rows(self, local, S: int):
        """The full (S, ...) array on every rank: each rank writes its
        rows into a zero buffer and the buffer is summed over the ranks
        (exact: every row has one writer)."""
        if self.world == 1:
            return local
        lo, hi = self.row_range(S)
        buf = torch.zeros((S,) + tuple(local.shape[1:]), dtype=local.dtype,
                          device=local.device)
        buf[lo:hi] = local
        return self.all_sum(buf)


def _local_rank() -> int:
    import torch.distributed as dist
    env = os.environ.get("LOCAL_RANK")
    return int(env) if env is not None else dist.get_rank()


def rank_device(device=None) -> torch.device:
    """This rank's device: ``cuda:(local_rank % device_count)`` unless
    the caller names one (the CPU tests pass ``"cpu"``)."""
    from ..utils.runtime import resolve_device
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "mpisppy_tpu_torch runs on a CUDA device and none is "
                "available; pass device='cpu' to run on the CPU")
        device = f"cuda:{_local_rank() % torch.cuda.device_count()}"
    return resolve_device(device)


def make_mesh(n_devices=None, device=None) -> Mesh:
    """This rank's Mesh over the process group that
    ``parallel/launch.launch`` or ``utils/runtime.maybe_init_distributed``
    set up. Without a process group the mesh is one rank (``n_devices``
    must then be None or 1). ``n_devices`` None or 0 means the whole
    world; any other count must equal it (the port runs one rank per
    mesh device)."""
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()):
        if n_devices not in (None, 0, 1):
            raise ValueError(
                f"a {n_devices}-rank mesh needs a process group (start "
                "the ranks with parallel/launch.launch)")
        from ..utils.runtime import resolve_device
        return Mesh(0, 1, resolve_device(device))
    world = dist.get_world_size()
    if n_devices not in (None, 0) and int(n_devices) != world:
        raise ValueError(f"n_devices={n_devices} differs from the "
                         f"process group's {world} ranks")
    return Mesh(dist.get_rank(), world, rank_device(device),
                group=dist.group.WORLD, backend=dist.get_backend())


def local_chunk_layout(shard_rows: int, chunk: int) -> tuple[int, int]:
    """(n_chunks, lc) for a per-rank shard of ``shard_rows`` scenarios
    under the ``subproblem_chunk`` per-rank microbatch bound: lc is
    rounded so n_chunks · lc covers the shard with the pad below one
    chunk-row per rank. The single source of this formula: the mesh
    padding (core/spbase) and the chunk size of the sharded loop
    (core/ph) both derive from it."""
    n_chunks = -(-shard_rows // int(chunk))
    return n_chunks, -(-shard_rows // n_chunks)


def node_means(memberships, slot_bounds, weights, xn, mesh=None,
               want_sq=False):
    """Nonanticipative per-tree-node means of ``xn``'s nonant slots,
    broadcast back to the rows: Compute_Xbar (ref. phbase.py:144-221),
    the one body of every engine's x̄, sharded or not. Per non-leaf
    stage t with membership B_t (these rows x the stage's GLOBAL nodes),
    num = B_tᵀ(w⊙x), den = B_tᵀw [, sq = B_tᵀ(w⊙x⊙x)]; on a sharded
    ``mesh`` every stage's tables are summed over the ranks in ONE
    ``all_reduce`` (a node's partial sums are nonzero only on the ranks
    that hold its scenarios); then x̄ = B_t (num/den). ``weights``: the
    (S,) scenario probabilities or (S, K) per-variable weights. Returns
    (xbar, xsqbar or None)."""
    tables = []
    for B, (lo, hi) in zip(memberships, slot_bounds):
        xt = xn[:, lo:hi]
        if B.dtype != xn.dtype:
            B = B.to(xn.dtype)
        if weights.ndim == 2:
            w = weights[:, lo:hi]
            tabs = [B.T @ (w * xt), B.T @ w]
        else:
            w = weights.unsqueeze(-1)
            tabs = [B.T @ (w * xt), B.T @ weights]
        if want_sq:
            tabs.append(B.T @ (w * (xt * xt)))
        tables.append(tabs)
    if mesh is not None and mesh.size > 1:
        flat = mesh.all_sum(torch.cat([t.reshape(-1) for tabs in tables
                                       for t in tabs]))
        off = 0
        for tabs in tables:
            for j, t in enumerate(tabs):
                tabs[j] = flat[off:off + t.numel()].reshape(t.shape)
                off += t.numel()
    xbar, xsqbar = [], []
    for B, tabs in zip(memberships, tables):
        if B.dtype != xn.dtype:
            B = B.to(xn.dtype)
        den = tabs[1] if tabs[1].ndim == 2 else tabs[1].unsqueeze(-1)
        xbar.append(B @ (tabs[0] / den))
        if want_sq:
            xsqbar.append(B @ (tabs[2] / den))
    return (torch.cat(xbar, dim=1),
            torch.cat(xsqbar, dim=1) if want_sq else None)


def scenario_combine(memberships, slot_bounds, xn, prob, weights, W, rho,
                     wmask, mesh=None):
    """Compute_Xbar + Update_W + the scaled-L1 convergence: (xbar,
    xsqbar, W_new, conv). x̄ and x̄² through :func:`node_means` (one
    all-reduce on a sharded mesh), ``W += ρ(x−x̄)`` on these rows, and
    the convergence as this rank's probability-weighted sum, summed over
    the ranks (one more all-reduce)."""
    K = xn.shape[1]
    xbar, xsqbar = node_means(memberships, slot_bounds, weights, xn, mesh,
                              want_sq=True)
    W_new = W + rho * (xn - xbar)
    if wmask is not None:
        W_new = torch.where(wmask, W_new, 0.0)
    conv = torch.dot(prob, torch.sum(torch.abs(xn - xbar), dim=1))
    if mesh is not None:
        conv = mesh.all_sum(conv)
    return xbar, xsqbar, W_new, conv / K


class ShardedScenarioOps:
    """The collective scenario-axis operations of one rank.

    - ``xbar``/``combine``: :func:`node_means` and
      :func:`scenario_combine` over this rank's rows, whose membership
      columns are the tree's GLOBAL nodes: the per-stage (N_t, k_t)
      num/den[/sq] tables are packed into ONE ``all_reduce``, the
      convergence scalar is one more. The engines call the same two
      functions with their own memberships, without a mesh when they
      are not sharded, so a sharded and an unsharded engine run one
      body.
    - the sharded chunk layout: chunk ci of the sharded loop is local
      rows [ci·lc, (ci+1)·lc) of EVERY rank's shard, so the JAX
      package's ``to_chunks``/``from_chunks`` reshapes become the
      engine's own local slicing (core/ph ``_chunk_index``) with no
      communication; the global scenario ids of a chunk are strided
      (``chunk_global_index``).

    The JAX package's ``colocate`` has no counterpart: a rank's tensors
    all live on its one device."""

    def __init__(self, mesh: Mesh, tree, slot_bounds, S: int):
        self.mesh = mesh
        self.n_devices = int(mesh.size)
        if S % self.n_devices:
            raise ValueError(f"S={S} not divisible by the "
                             f"{self.n_devices}-rank mesh (pad first: "
                             "pad_batch_for_mesh)")
        self.S = S
        self.shard_size = S // self.n_devices
        self.lo, self.hi = mesh.row_range(S)
        self.slot_bounds = tuple(slot_bounds)
        self.n_nodes = tuple(int(n) for n in tree.nodes_per_stage)
        self._tree = tree
        self._memberships = None

    @property
    def memberships(self):
        """This rank's rows of every non-leaf stage's membership matrix
        (global node columns), built on first use."""
        if self._memberships is None:
            self._memberships = [
                torch.as_tensor(
                    np.asarray(self._tree.membership(t + 1))[
                        self.lo:self.hi], dtype=torch.float64,
                    device=self.mesh.device)
                for t in range(self._tree.num_stages - 1)]
        return self._memberships

    def book_collective(self, dtype, full):
        """Count one x̄ (``full`` False) or combine reduction's payload
        under ``xfer.collective_bytes``."""
        from .. import obs
        if obs.enabled():
            obs.counter_add(
                "xfer.collective_bytes",
                self.combine_collective_bytes(
                    torch.empty((), dtype=dtype).element_size(),
                    full=full))

    def xbar(self, weights, xn):
        """Collective Compute_Xbar (the nonanticipative per-node mean,
        gathered back to this rank's rows)."""
        self.book_collective(xn.dtype, full=False)
        return node_means(self.memberships, self.slot_bounds, weights, xn,
                          self.mesh)[0]

    def combine(self, xn, prob, weights, W, rho, wmask):
        """Collective _ph_combine: (xbar, xsqbar, W_new, conv)."""
        self.book_collective(xn.dtype, full=True)
        return scenario_combine(self.memberships, self.slot_bounds, xn,
                                prob, weights, W, rho, wmask, self.mesh)

    def combine_collective_bytes(self, itemsize, full=True):
        """Bytes one combine's reductions carry (operand sizes: the
        per-stage (N_t, k_t) num/den[/sq] node tables and the conv
        scalar): the ``xfer.collective_bytes`` accounting basis. An
        estimate of logical all-reduce payload, not link traffic."""
        total = 0
        for N, (lo, hi) in zip(self.n_nodes, self.slot_bounds):
            per_stage = 3 if full else 2
            total += per_stage * N * (hi - lo) * itemsize
        if full:
            total += itemsize
        return total

    # ---- sharded chunk staging ----
    def chunk_layout(self, lc: int):
        """(n_chunks, chunk_rows_global) for local chunk size ``lc``;
        raises unless lc divides the shard (core/spbase pads S so it
        does)."""
        if self.shard_size % lc:
            raise ValueError(
                f"local chunk {lc} does not divide the per-rank shard "
                f"{self.shard_size} (S={self.S} on {self.n_devices} "
                "ranks): the batch padding should have rounded S up")
        return self.shard_size // lc, lc * self.n_devices

    def chunk_global_index(self, ci: int, lc: int) -> np.ndarray:
        """Global scenario ids of sharded chunk ``ci`` in chunk-row
        order (rank-major: row d·lc + r is local row ci·lc + r of rank
        d's shard)."""
        L = self.shard_size
        return np.concatenate([d * L + ci * lc + np.arange(lc)
                               for d in range(self.n_devices)])


def pad_batch_for_mesh(batch, n_shards: int):
    """Pad a ScenarioBatch to a multiple of n_shards scenarios with
    zero-probability copies of the last scenario. Returns (batch,
    S_orig)."""
    S = batch.S
    rem = (-S) % n_shards
    if rem == 0:
        return batch, S
    import dataclasses

    def pad(a):
        a = np.asarray(a)
        return np.concatenate([a, np.repeat(a[-1:], rem, axis=0)], axis=0)

    tree = batch.tree
    from ..ir.tree import ScenarioTree
    new_tree = ScenarioTree(
        scen_names=tree.scen_names + [f"_pad{i}" for i in range(rem)],
        node_paths=np.concatenate([tree.node_path,
                                   np.repeat(tree.node_path[-1:], rem,
                                             axis=0)]),
        nodes_per_stage=tree.nodes_per_stage,
        nonant_names_per_stage=tree.nonant_names_per_stage,
        probabilities=np.concatenate([tree.probabilities, np.zeros(rem)]),
    )
    return dataclasses.replace(
        batch, tree=new_tree,
        c=pad(batch.c), c0=pad(batch.c0), P_diag=pad(batch.P_diag),
        A=batch.A if batch.shared_A else pad(batch.A),
        l=pad(batch.l), u=pad(batch.u),
        lb=pad(batch.lb), ub=pad(batch.ub),
        c_stage=pad(batch.c_stage), c0_stage=pad(batch.c0_stage),
        prob=new_tree.probabilities.copy(),
    ), S


def mesh_padding(S: int, n_dev: int, chunk: int) -> int:
    """The multiple S is padded to on an ``n_dev``-rank mesh: n_dev, or
    under a per-rank ``subproblem_chunk`` below the shard, the multiple
    that makes the local chunk divide the shard (the JAX package's
    core/spbase rule)."""
    mult = n_dev
    if n_dev > 1 and chunk:
        L0 = -(-S // n_dev)
        if chunk < L0:
            n_chunks, lc = local_chunk_layout(L0, chunk)
            mult = n_dev * n_chunks * lc
    return mult
