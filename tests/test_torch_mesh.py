"""The port's scenario mesh (mpisppy_tpu_torch.parallel) against the JAX
package's parallel/mesh.py: the padding and chunk layouts bit for bit,
the collective combine at 1e-12 on the same inputs, and the rank model's
own contracts: one gate sync per iteration per rank, every rank's host
trace the same, and a rank that raises failing the launch.

The ranks are gloo CPU processes started by parallel/launch (one torch
thread each); their programs are in tests/torch_mesh_ranks.py. The JAX
side runs in this process on the virtual CPU devices of conftest."""

import numpy as np
import pytest

from mpisppy_tpu.ir.batch import build_batch as jax_build_batch
from mpisppy_tpu.models import farmer as jax_farmer
from mpisppy_tpu.models import hydro as jax_hydro
from mpisppy_tpu.models import uc as jax_uc
from mpisppy_tpu.parallel.mesh import ShardedScenarioOps as JaxOps
from mpisppy_tpu.parallel.mesh import local_chunk_layout as jax_layout
from mpisppy_tpu.parallel.mesh import make_mesh as jax_make_mesh
from mpisppy_tpu.parallel.mesh import pad_batch_for_mesh as jax_pad
from mpisppy_tpu_torch.parallel import mesh as pmesh
from mpisppy_tpu_torch.parallel.launch import choose_backend, launch

import torch_mesh_ranks as ranks
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

_FIELDS = ("c", "c0", "P_diag", "A", "l", "u", "lb", "ub", "c_stage",
           "c0_stage", "prob")


def _jax_batch(model, S=None):
    if model == "farmer":
        return jax_build_batch(jax_farmer.scenario_creator,
                               jax_farmer.make_tree(S))
    if model == "hydro":
        return jax_build_batch(jax_hydro.scenario_creator,
                               jax_hydro.make_tree())
    return jax_build_batch(jax_uc.scenario_creator, jax_uc.make_tree(S),
                           creator_kwargs=dict(ranks._UC_KW),
                           vector_patch=jax_uc.scenario_vector_patch)


def _bounds(batch):
    return tuple((sl.start, sl.stop) for sl in batch.stage_slot_slices)


class _OneRank:
    """A stand-in Mesh of ``world`` ranks for the layout arithmetic
    (rank 0's view; no collective is called)."""

    def __init__(self, world):
        self.rank, self.world, self.device = 0, world, "cpu"

    @property
    def size(self):
        return self.world

    def row_range(self, S):
        return pmesh.Mesh.row_range(self, S)


@pytest.mark.parametrize("S, ndev, chunk", [(10, 4, 2), (1024, 8, 32)])
def test_padding_and_chunk_layouts_match_jax_bit_for_bit(S, ndev, chunk):
    """pad_batch_for_mesh, local_chunk_layout, chunk_layout and
    chunk_global_index against the JAX package's: S = 10 on 4 (two
    zero-probability pads) and S = 1024 on 8 (no pad)."""
    pb = ranks.build("farmer", S)
    jb = _jax_batch("farmer", S)
    p_pad, p_S0 = pmesh.pad_batch_for_mesh(pb, ndev)
    j_pad, j_S0 = jax_pad(jb, ndev)
    assert p_S0 == j_S0 == S
    assert p_pad.S == j_pad.S == S + (-S) % ndev
    for f in _FIELDS:
        a, b = np.asarray(getattr(p_pad, f)), np.asarray(getattr(j_pad, f))
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert p_pad.tree.scen_names == j_pad.tree.scen_names
    assert np.array_equal(p_pad.tree.node_path, j_pad.tree.node_path)
    assert np.array_equal(p_pad.tree.probabilities,
                          j_pad.tree.probabilities)
    for rows in (1, 2, 3, 5, 7, 128, 1000):
        for ch in (1, 2, 3, 32):
            assert pmesh.local_chunk_layout(rows, ch) \
                == jax_layout(rows, ch)
    # chunk-aware padding: the multiple both packages pad S to
    mult = pmesh.mesh_padding(S, ndev, chunk)
    padded, _ = pmesh.pad_batch_for_mesh(pb, mult)
    jops = JaxOps(jax_make_mesh(ndev), jax_pad(jb, mult)[0].tree,
                  _bounds(jb), padded.S)
    pops = pmesh.ShardedScenarioOps(_OneRank(ndev), padded.tree,
                                    _bounds(pb), padded.S)
    assert pops.shard_size == jops.shard_size
    lc = pmesh.local_chunk_layout(pops.shard_size, chunk)[1]
    assert pops.chunk_layout(lc) == jops.chunk_layout(lc)
    for ci in range(pops.chunk_layout(lc)[0]):
        assert np.array_equal(pops.chunk_global_index(ci, lc),
                              jops.chunk_global_index(ci, lc))
    assert pops.combine_collective_bytes(8) \
        == jops.combine_collective_bytes(8)
    with pytest.raises(ValueError, match="does not divide"):
        pops.chunk_layout(pops.shard_size + 1)


@pytest.mark.parametrize("model, S, world", [("uc", 8, 2), ("hydro", None, 4)])
def test_combine_matches_jax_collective_op(model, S, world):
    """The collective x̄/x̄²/W/conv of every rank against the JAX op on
    the same global inputs, at 1e-12: two-stage UC on 2 ranks, and
    3-stage hydro on 4 (9 scenarios padded to 12, stage-2 nodes of 3
    scenarios straddling the 3-row shards)."""
    import jax.numpy as jnp
    spec = {"model": model, "S": S, "seed": 3}
    outs = launch(ranks.combine_check, world, (spec,), device="cpu")
    r0 = outs[0]
    for o in outs[1:]:
        for k in ("xbar", "W_new", "conv"):
            assert np.array_equal(np.asarray(o[k]), np.asarray(r0[k])), k
    jb, _ = jax_pad(_jax_batch(model, S), world)
    jops = JaxOps(jax_make_mesh(world), jb.tree, _bounds(jb), jb.S)
    p = jnp.asarray(r0["prob"])
    xbar, xsqbar, W_new, conv = jops.combine(
        jnp.asarray(r0["xn"]), p, p, jnp.asarray(r0["W"]),
        jnp.asarray(r0["rho"]), None)
    for got, ref in ((r0["xbar"], xbar), (r0["xsqbar"], xsqbar),
                     (r0["W_new"], W_new)):
        np.testing.assert_allclose(got, np.asarray(ref), rtol=0,
                                   atol=1e-12)
    assert r0["conv"] == pytest.approx(float(conv), rel=1e-12)
    assert r0["bytes"] == jops.combine_collective_bytes(8)


_GATE = {"defaultPHrho": 50.0, "subproblem_max_iter": 1200,
         "subproblem_eps": 1e-6, "subproblem_chunk": 2,
         "subproblem_kernel_mode": "fused"}


@pytest.mark.parametrize("world", [1, 2, 4])
def test_gate_syncs_one_per_iteration_per_rank(world):
    """The stacked gate row is gathered over the ranks before its one
    read: a steady-state chunked iteration books ONE gate sync on every
    rank, on 1, 2 and 4 ranks (JAX tests/test_kernels.py:198)."""
    spec = {"model": "uc", "S": 16, "opts": _GATE, "main": False,
            "iters": 3}
    outs = launch(ranks.ph_run, world, (spec,), device="cpu")
    for o in outs:
        syncs = [row["gate_syncs"] for row in o["trace"]]
        assert syncs[2] - syncs[1] == 1, syncs
        assert o["pt"]["devices"] == world
        assert o["pt"]["mode"] == ("sharded" if world > 1 else "host")
        assert o["pt"]["kernel"]["mode"] == "fused"
        assert o["pt"]["gate_d2h_syncs_per_call"] == 1.0
    assert outs[0]["shard"] == 16 // world


def test_every_rank_host_trace_agrees():
    """Every host decision comes from reduced values: the ranks' traces
    (iteration, conv, the chunk-retry blacklist, the gate reads) are
    identical, also when only rank 1's rows of chunk 0 go bad (NaN warm
    iterates at iteration 2): every rank retries chunk 0 from cold, as
    the unsharded loop retries the whole chunk."""
    spec = {"model": "uc", "S": 12, "opts": _GATE, "main": False,
            "iters": 4, "poison": (1, 2)}
    outs = launch(ranks.ph_run, 3, (spec,), device="cpu")
    for o in outs[1:]:
        assert o["trace"] == outs[0]["trace"]
        assert o["gate_syncs"] == outs[0]["gate_syncs"]
    syncs = [row["gate_syncs"] for row in outs[0]["trace"]]
    # iteration 2 read the gate and the retry's residuals: two reads
    assert syncs[2] - syncs[1] == 2 and syncs[3] - syncs[2] == 1, syncs
    assert all(np.isfinite(row["conv"]) for row in outs[0]["trace"])
    assert np.isfinite(outs[0]["xbar"]).all()


def test_a_rank_that_raises_fails_the_launch():
    """Rank 1 raises while rank 0 waits in a collective: the launch
    raises with rank 1's traceback and leaves no rank running."""
    with pytest.raises(RuntimeError, match="rank 1 of 2") as ei:
        launch(ranks.raise_on, 2, (1,), device="cpu", timeout=120)
    assert "planted failure on rank 1" in str(ei.value)
    assert "Traceback" in str(ei.value)
    assert launch(ranks.raise_on, 2, (5,), device="cpu") == [0, 1]


def test_backend_rule_and_single_rank_mesh():
    """gloo on the CPU and for ranks sharing a card, NCCL only when each
    rank has a card of its own; without a process group make_mesh is
    one rank whose collectives are the identity."""
    import torch
    assert choose_backend(4, "cpu") == "gloo"
    if not torch.cuda.is_available():
        assert choose_backend(2) == "gloo"
    m = pmesh.make_mesh(device="cpu")
    assert (m.rank, m.size, m.device.type) == (0, 1, "cpu")
    t = torch.arange(3.0)
    assert m.all_sum(t) is t and m.gather_rows(t, 3) is t
    with pytest.raises(ValueError, match="process group"):
        pmesh.make_mesh(2, device="cpu")
