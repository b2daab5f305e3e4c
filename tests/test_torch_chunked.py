"""The port's scenario-chunked PH loop (mpisppy_tpu_torch.core.ph
._solve_loop_chunked) against the JAX package's on the same batches,
built from the same seed, on the CPU (the port's block through its plain
version, the JAX block in interpret mode).

Where the chunked port is held against the JAX package's UNCHUNKED loop:
the JAX package's chunked loop warm-starts a new mode's chunk states
from a mix of unscaled solutions and scaled slacks (ROADMAP.md C.2), so
its first prox-on solve starts far out, fails the recovery gate and is
retried with adaptive rho, whose trajectory moves with roundoff. The
port transplants the scaled iterates, as both packages' unchunked loops
do, so its chunked trajectory is the unchunked one to roundoff."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpisppy_tpu.core.ph import PH as JaxPH
from mpisppy_tpu.core.ph import PHBase as JaxPHBase
from mpisppy_tpu.ir.batch import build_batch as jax_build_batch
from mpisppy_tpu.models import uc as jax_uc
from mpisppy_tpu.ops.qp_solver import _factorize as jax_factorize
from mpisppy_tpu_torch import obs
from mpisppy_tpu_torch.core.ph import PH, PHBase, _solver_call
from mpisppy_tpu_torch.ir.batch import build_batch
from mpisppy_tpu_torch.models import farmer, uc
from mpisppy_tpu_torch.ops.qp_solver import _factorize, stacked_residuals
from mpisppy_tpu_torch.utils.carry import from_numpy_state
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

_UC_KW = {"num_gens": 3, "num_hours": 6}
# the slice's fused options at this size (tests/test_torch_ph.py)
_FUSED = {"defaultPHrho": 100.0, "PHIterLimit": 3,
          "subproblem_kernel_mode": "fused",
          "subproblem_kernel_backend": "pallas",
          "subproblem_max_iter": 400, "subproblem_polish_hot": False,
          "subproblem_polish_chunk": 2}
# tests/test_pipeline.py's options
_PIPE = {"defaultPHrho": 50.0, "subproblem_max_iter": 1200,
         "subproblem_eps": 1e-6, "subproblem_chunk": 3}


class _ConvLog:
    """Extension recording conv after every PH iteration."""

    def __init__(self):
        self.conv = []

    def miditer(self, ph):
        self.conv.append(ph.conv)

    def __getattr__(self, name):
        return lambda ph: None


def _jax_uc(S=8):
    return jax_build_batch(jax_uc.scenario_creator, jax_uc.make_tree(S),
                           creator_kwargs=_UC_KW,
                           vector_patch=jax_uc.scenario_vector_patch)


def _port_uc(S=8):
    return build_batch(uc.scenario_creator, uc.make_tree(S),
                       creator_kwargs=_UC_KW,
                       vector_patch=uc.scenario_vector_patch)


def _rel_close(ref, got, tol):
    ref = np.asarray(ref)
    got = got.cpu().numpy() if hasattr(got, "cpu") else np.asarray(got)
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * scale)


def _run(opts, iters=3, S=8):
    ph = PHBase(_port_uc(S), dict(opts), device="cpu")
    for it in range(iters):
        ph.solve_loop(w_on=(it > 0), prox_on=(it > 0))
        ph.W = ph.W_new
    return ph


# ---------------- (a) port against the JAX package ----------------

def test_chunked_fused_ph_matches_jax():
    """S = 8 in chunks of 3 (the last padded), fused mode, the block's
    backend, 3 PH iterations: conv per iteration, x̄, W and the expected
    objective at 1e-8 relative against the JAX package's unchunked run.
    The chunked path runs one block call per chunk, no retry and one
    gate sync per call.

    The trivial bound is held at 2e-6 relative. It is the certified
    dual objective of the polish's best dual candidate, which moves
    with roundoff in either package (ROADMAP.md C.1): on this batch the
    JAX package alone gives 20388.5110 with polish_chunk 1 and
    20388.4930 with polish_chunk 2 (8.8e-7 apart), and the port's
    unchunked loop against the JAX package's reads 9.3e-7, its chunked
    loop 1.04e-6."""
    log_j, log_p = _ConvLog(), _ConvLog()
    j = JaxPH(_jax_uc(), dict(_FUSED), dtype=jnp.float64, extensions=log_j)
    p = PH(_port_uc(), {**_FUSED, "subproblem_chunk": 3}, device="cpu",
           extensions=log_p)
    conv_j, eobj_j, tb_j = j.ph_main()
    obs.configure()
    try:
        conv_p, eobj_p, tb_p = p.ph_main()
        retries = obs.counters_snapshot().get("ph.chunk_retries", 0)
    finally:
        obs.shutdown()
    assert len(p._chunk_states[True]) == 3
    assert p._kernel_plans[True].backend == "cuda"
    assert retries == 0
    assert p.phase_timing(True)["gate_d2h_syncs_per_call"] == 1.0
    assert len(log_p.conv) == len(log_j.conv) == 3
    np.testing.assert_allclose(log_p.conv, log_j.conv, rtol=1e-8)
    _rel_close(j.xbar, p.xbar, 1e-8)
    _rel_close(j.W, p.W, 1e-8)
    assert eobj_p == pytest.approx(eobj_j, rel=1e-8)
    assert tb_p == pytest.approx(tb_j, rel=2e-6)
    w_sum = (p.prob @ p.W).abs().max()
    assert float(w_sum) <= 1e-8 * float(p.W.abs().max())


def test_chunked_fused_iter0_matches_jax_chunked():
    """The iter-0 pass (prox off, with the polish) of both packages'
    chunked loops, chunk for chunk: x, x̄, W and the per-scenario
    residuals at 1e-8."""
    opts = {**_FUSED, "subproblem_chunk": 3}
    j = JaxPHBase(_jax_uc(), dict(opts), dtype=jnp.float64)
    p = PHBase(_port_uc(), dict(opts), device="cpu")
    for e in (j, p):
        e.solve_loop(w_on=False, prox_on=False)
    _rel_close(j.x, p.x, 1e-8)
    _rel_close(j.xbar, p.xbar, 1e-8)
    _rel_close(j.W_new, p.W_new, 1e-8)
    assert p.conv == pytest.approx(j.conv, rel=1e-8)
    pj = np.asarray(j._qp_states[False].pri_rel)
    pp = p._qp_states[False].pri_rel.numpy()
    assert pp.shape == pj.shape == (8,)
    np.testing.assert_allclose(pp, pj, rtol=1e-6, atol=1e-12)


def test_chunked_segmented_ph_matches_jax_chunked():
    """Segmented mode (adaptive rho, budget large enough to converge):
    both packages' chunked loops, 3 iterations, at the bars of the JAX
    package's fused-vs-segmented chunked test (tests/test_kernels.py:111):
    x̄ 1e-6, W 1e-5, conv 1e-8."""
    opts = {"defaultPHrho": 50.0, "subproblem_max_iter": 6000,
            "subproblem_eps": 1e-8, "subproblem_chunk": 3,
            "subproblem_segment": 1000,
            "subproblem_kernel_mode": "segmented"}
    j = JaxPHBase(_jax_uc(), dict(opts), dtype=jnp.float64)
    p = PHBase(_port_uc(), dict(opts), device="cpu")
    for it in range(3):
        for e in (j, p):
            e.solve_loop(w_on=(it > 0), prox_on=(it > 0))
            e.W = e.W_new
    assert p.phase_timing(True)["kernel"]["mode"] == "segmented"
    assert p.conv == pytest.approx(j.conv, abs=1e-8)
    np.testing.assert_allclose(p.xbar.numpy(), np.asarray(j.xbar),
                               atol=1e-6)
    np.testing.assert_allclose(p.W.numpy(), np.asarray(j.W), atol=1e-5)
    assert float(p._qp_states[True].pri_rel.max()) < 1e-6


# ---------------- (b) chunked against unchunked ----------------

def test_chunked_solve_loop_matches_unchunked():
    """tests/test_precision.py:344 on the port: chunking (with an uneven
    final chunk) reproduces the unchunked trajectory, and the chunked
    certified bound sits at or below the unchunked one."""
    opts = {"defaultPHrho": 50.0, "subproblem_max_iter": 4000,
            "subproblem_eps": 1e-9}
    ph_a = PHBase(_port_uc(), dict(opts), device="cpu")
    ph_b = PHBase(_port_uc(), {**opts, "subproblem_chunk": 3},
                  device="cpu")
    assert ph_a.shared_structure
    for ph in (ph_a, ph_b):
        ph.solve_loop(w_on=False, prox_on=False)
        ph.W = ph.W_new
        ph.solve_loop(w_on=True, prox_on=True)
        ph.W = ph.W_new
        ph.solve_loop(w_on=True, prox_on=True)
    np.testing.assert_allclose(ph_b.xbar.numpy(), ph_a.xbar.numpy(),
                               atol=2e-5)
    np.testing.assert_allclose(ph_b._last_solved_obj.numpy(),
                               ph_a._last_solved_obj.numpy(), rtol=2e-3)
    Wn = ph_b.W_new.numpy()
    p = ph_b.prob.numpy()
    assert np.abs(p @ Wn).max() < 1e-6 * (1 + np.abs(Wn).max())
    assert ph_b.conv == pytest.approx(ph_a.conv, abs=1e-5)
    assert ph_b.Eobjective_value() == pytest.approx(
        ph_a.Eobjective_value(), rel=1e-6)
    ph_a.solve_loop(w_on=True, prox_on=False, update=False)
    ph_b.solve_loop(w_on=True, prox_on=False, update=False)
    ea, eb = ph_a.Ebound(), ph_b.Ebound()
    assert eb <= ea + 1e-6 * abs(ea)
    # the concatenated state view serves the feasibility consumers
    assert tuple(ph_b._qp_states[False].pri_rel.shape) == (8,)


def test_chunk_index_pads_the_last_chunk_and_the_view_trims_it():
    """Chunks of 3 over 8 scenarios: the last index repeats scenario 7,
    the concatenated view and the engine's x hold 8 rows in order, and
    the duplicate row solved to the same values as its original."""
    ph = _run({**_FUSED, "subproblem_chunk": 3}, iters=1)
    sl = ph._chunk_index(3)
    assert [idx.tolist() for idx, _ in sl] == [[0, 1, 2], [3, 4, 5],
                                               [6, 7, 7]]
    assert [real for _, real in sl] == [3, 3, 2]
    view = ph._qp_states[False]
    for f in ("x", "zA", "pri_rel", "dua_res"):
        assert getattr(view, f).shape[0] == 8
    last = ph._chunk_states[False][2]
    assert torch.equal(last.x[1], last.x[2])
    assert torch.equal(view.x[6:], last.x[:2])
    assert ph.x.shape[0] == 8


def test_stacked_residuals_is_one_matrix_of_every_chunk():
    ph = _run({**_FUSED, "subproblem_chunk": 3}, iters=1)
    states = ph._chunk_states[False]
    st = stacked_residuals(states)
    assert tuple(st.shape) == (3, 3)
    for ci, s in enumerate(states):
        assert torch.equal(st[ci], s.pri_rel)
    assert torch.equal(stacked_residuals(states, "dua_rel")[1],
                       states[1].dua_rel)


# ---------------- (c) pipelined against sequential ----------------

@pytest.fixture(scope="module")
def seq_and_pip():
    ph_seq = _run({**_PIPE, "subproblem_pipeline": 0})
    ph_pip = _run(_PIPE)
    return ph_seq, ph_pip


def test_pipelined_matches_sequential(seq_and_pip):
    """tests/test_pipeline.py:37: the pipelined loop runs the same solves
    in the same order as the sequential one, so the iterates agree to
    roundoff."""
    ph_seq, ph_pip = seq_and_pip
    np.testing.assert_allclose(ph_pip.xbar.numpy(), ph_seq.xbar.numpy(),
                               atol=1e-9)
    np.testing.assert_allclose(ph_pip.W.numpy(), ph_seq.W.numpy(),
                               atol=1e-7)
    assert ph_pip.conv == pytest.approx(ph_seq.conv, abs=1e-12)
    pr_s = ph_seq._qp_states[True].pri_rel.numpy()
    pr_p = ph_pip._qp_states[True].pri_rel.numpy()
    assert np.abs(pr_s - pr_p).max() < 1e-8


def test_gate_one_sync_per_iteration(seq_and_pip):
    """tests/test_pipeline.py:74: the pipelined gate reads every chunk's
    residuals in one device-to-host copy per call; the sequential loop
    pays one read per chunk."""
    ph_seq, ph_pip = seq_and_pip
    n_chunks = len(ph_seq._chunk_index(3))
    assert n_chunks == 3
    pt_pip = ph_pip.phase_timing(True)
    pt_seq = ph_seq.phase_timing(True)
    assert pt_pip["gate_d2h_syncs_per_call"] == 1.0
    assert pt_seq["gate_d2h_syncs_per_call"] == float(n_chunks)
    for phase in ("assemble", "solve", "gate", "reduce"):
        assert pt_pip["seconds_per_call"][phase] >= 0.0
    assert 0.0 < pt_pip["occupancy"] <= 1.0
    tot = ph_pip._phase_totals()
    assert tot["solve"] > 0.0 and set(tot) == {"assemble", "solve",
                                               "gate", "reduce"}
    ph_pip.reset_phase_timing()
    assert ph_pip.phase_timing(True) is None
    summ = ph_pip.residual_summary(True)
    assert summ["pri_rel_max"] < 1e-2
    assert ph_pip.residual_summary("never") is None


# ---------------- (d) the poisoned-rho chunk ----------------

def test_poisoned_chunk_recovery_matches_jax():
    """tests/test_precision.py:416 / test_pipeline.py:94: after two
    iterations of the JAX package's chunked loop, chunk 0's rho_scale is
    poisoned (1e-6, with its factor) and its iterates zeroed. The same state (every chunk's
    iterates, solve operator and rho_scale, W, x̄, the blacklists) is
    carried into the port; one prox-on pass in each package (the block
    runs at the poisoned fixed rho) retries the poisoned chunk from a
    reset rho, and both come out below the gate with identical
    blacklists."""
    opts = {**_PIPE, "subproblem_chunk": 4,
            "subproblem_kernel_mode": "fused",
            "subproblem_kernel_backend": "pallas"}
    j = JaxPHBase(_jax_uc(), dict(opts), dtype=jnp.float64)
    for it in range(2):
        j.solve_loop(w_on=(it > 0), prox_on=(it > 0))
        j.W = j.W_new
    sts = j._qp_states[("chunks", True)]
    factors, _ = j._get_factors(True)
    bad_rho = jnp.full_like(sts[0].rho_scale, 1e-6)
    # ...and its iterates zeroed, so its fixed-rho solve cannot reach
    # the gate and the retry path runs
    sts[0] = sts[0]._replace(rho_scale=bad_rho,
                             L=jax_factorize(factors, bad_rho),
                             **{f: jnp.zeros_like(getattr(sts[0], f))
                                for f in ("x", "yA", "yB", "zA", "zB")})
    chunks = []
    for st in sts:
        c = {k: np.asarray(getattr(st, k)) for k in
             ("x", "yA", "yB", "zA", "zB", "rho_scale", "pri_res",
              "dua_res", "pri_rel", "dua_rel")}
        c["F"] = np.asarray(st.L)
        chunks.append(c)
    arrays = {"W": np.asarray(j.W), "xbar": np.asarray(j.xbar),
              "chunks": chunks,
              "chunk_no_retry": sorted(j._chunk_no_retry.get(True, ())),
              "hospital_no_retry": sorted(j._hospital_no_retry.get(True,
                                                                   ())),
              "blacklist_calls": j._blacklist_calls[True]}
    p = from_numpy_state(PHBase(_port_uc(), dict(opts), device="cpu"),
                         arrays)
    carried = p._chunk_states[True]
    assert len(carried) == 2
    assert float(carried[0].rho_scale) == pytest.approx(1e-6)
    assert p._blacklist_calls[True] == 1
    obs.configure()
    try:
        j.solve_loop(w_on=True, prox_on=True)
        p.solve_loop(w_on=True, prox_on=True)
        retries = obs.counters_snapshot().get("ph.chunk_retries", 0)
    finally:
        obs.shutdown()
    assert retries >= 1
    pr_j = np.asarray(j._qp_states[True].pri_rel)
    pr_p = p._qp_states[True].pri_rel.numpy()
    assert pr_j.max() < 1e-2 and pr_p.max() < 1e-2
    assert p._chunk_no_retry.get(True, set()) \
        == j._chunk_no_retry.get(True, set())
    assert p._hospital_no_retry.get(True, set()) \
        == j._hospital_no_retry.get(True, set())
    np.testing.assert_allclose(p.xbar.numpy(), np.asarray(j.xbar),
                               atol=1e-3)


def test_poisoned_chunk_pipelined_matches_sequential():
    """tests/test_pipeline.py:94 on the port: the pipelined gate
    recovers a poisoned chunk exactly like the sequential one."""
    def poisoned(pipeline):
        ph = _run({**_PIPE, "subproblem_chunk": 4,
                   "subproblem_pipeline": pipeline}, iters=2)
        sts = ph._chunk_states[True]
        factors, _ = ph._get_factors(True)
        bad = torch.full_like(sts[0].rho_scale, 1e-6)
        sts[0] = sts[0]._replace(rho_scale=bad, L=_factorize(factors, bad))
        ph.solve_loop(w_on=True, prox_on=True)
        return ph

    ph_p, ph_s = poisoned(1), poisoned(0)
    assert float(ph_p._qp_states[True].pri_rel.max()) < 1e-2
    assert float(ph_s._qp_states[True].pri_rel.max()) < 1e-2
    assert ph_p._chunk_no_retry.get(True, set()) \
        == ph_s._chunk_no_retry.get(True, set())
    # the retry's own read is booked beside the gate's one
    assert ph_p.phase_timing(True)["gate_d2h_syncs_per_call"] \
        < ph_s.phase_timing(True)["gate_d2h_syncs_per_call"]


# ---------------- (e) the hospital ----------------

def test_hospital_rescues_flagged_row():
    """tests/test_precision.py:440: one row of chunk 1 flagged grossly
    unconverged is re-solved non-shared, cured, and its solution and
    residual rows land in the record; the other records are untouched
    and no input tensor is written."""
    opts = {"defaultPHrho": 50.0, "subproblem_max_iter": 1500,
            "subproblem_eps": 1e-6, "subproblem_chunk": 3,
            "subproblem_hospital_max": 4}
    ph = _run(opts, iters=2)
    factors, data = ph._get_factors(True)
    slices = ph._chunk_index(3)
    states = ph._chunk_states[True]
    n, m = ph.batch.n, ph.batch.m
    recs = []
    for ci, _ in enumerate(slices):
        st = states[ci]
        if ci == 1:     # flag one row of chunk 1 as grossly unconverged
            st = st._replace(pri_rel=st.pri_rel.index_fill(
                0, torch.tensor([0]), 1.0))
        recs.append([st, torch.zeros(3, n, dtype=torch.float64),
                     torch.zeros(3, m, dtype=torch.float64),
                     torch.zeros(3, n, dtype=torch.float64), None, None])
    flagged_x = recs[1][1]
    kw = dict(prox_on=True, precision=ph.sub_precision,
              sub_max_iter=ph.sub_max_iter, sub_eps=ph.sub_eps,
              sub_eps_hot=ph.sub_eps_hot,
              sub_eps_dua_hot=ph.sub_eps_dua_hot,
              tail_iter=ph.sub_tail_iter, stall_rel=ph.sub_stall_rel,
              segment=ph.sub_segment, polish_hot=ph.sub_polish_hot,
              polish_chunk=0)
    assert ph._hospitalize(True, slices, recs, data, thr=1e-2, w_on=True,
                           prox_on=True, kw=kw) == 1
    assert float(recs[1][0].pri_rel[0]) < 1e-2
    assert float(recs[1][1][0].abs().max()) > 0.0
    # unflagged rows and chunks untouched, the input record not written
    assert float(recs[0][1].abs().max()) == 0.0
    assert float(recs[1][1][1:].abs().max()) == 0.0
    assert float(flagged_x.abs().max()) == 0.0
    assert 4 not in ph._hospital_no_retry.get(True, set())


# ---------------- (f) blacklist re-admission ----------------

def test_blacklist_readmission_recovers_row():
    """tests/test_precision.py:479: both blacklists are cleared every
    ``subproblem_blacklist_readmit`` solves of a mode, and a row that is
    in fact curable leaves them cured."""
    opts = {"defaultPHrho": 50.0, "subproblem_max_iter": 1200,
            "subproblem_eps": 1e-6, "subproblem_chunk": 4,
            "subproblem_blacklist_readmit": 2}
    ph = _run(opts, iters=2)                        # mode-True call #1
    key = True
    ph._chunk_no_retry[key] = {0, 1}
    ph._hospital_no_retry[key] = {5}
    ph.solve_loop(w_on=True, prox_on=True)          # mode-True call #2
    assert ph._chunk_no_retry.get(key) == set()
    assert 5 not in ph._hospital_no_retry.get(key, set())
    assert float(ph._qp_states[key].pri_rel.max()) < 1e-2


def test_rho_change_clears_chunk_states_and_blacklists():
    ph = _run({**_PIPE, "subproblem_chunk": 4}, iters=2)
    ph._chunk_no_retry[True] = {1}
    ph._hospital_no_retry[True] = {3}
    ph.invalidate_factors()
    assert True not in ph._qp_states and True not in ph._chunk_states
    assert False in ph._chunk_states
    assert not ph._chunk_no_retry and not ph._hospital_no_retry
    assert not ph._blacklist_calls and not ph._kernel_plans
    ph.solve_loop(w_on=True, prox_on=True)
    assert float(ph._qp_states[True].pri_rel.max()) < 1e-2


# ---------------- (g) shared structure only ----------------

def test_chunked_requires_shared_structure():
    """tests/test_precision.py:506 with farmer, whose yields sit in A."""
    b = build_batch(farmer.scenario_creator, farmer.make_tree(3))
    ph = PHBase(b, {"subproblem_chunk": 2,
                    "subproblem_kernel_mode": "segmented"}, device="cpu")
    assert not ph.shared_structure
    with pytest.raises(ValueError, match="shared-structure"):
        ph.solve_loop(w_on=False, prox_on=False)


# ---------------- (h) no chunk writes a sibling's buffers ----------------

def _snapshot(states):
    return [{f: getattr(st, f).clone() for f in
             ("x", "yA", "yB", "zA", "zB", "L", "rho_scale", "pri_res",
              "dua_res", "pri_rel", "dua_rel")} for st in states]


def _unchanged(states, snap):
    return all(torch.equal(getattr(st, f), v)
               for st, s in zip(states, snap) for f, v in s.items())


@pytest.mark.parametrize("mode", ["fused", "segmented"])
def test_solving_a_chunk_leaves_sibling_states_unchanged(mode):
    """Every chunk of a fresh mode starts from ONE cold state (factor
    included). Solving chunk 0 leaves the tensors chunk 1 holds
    bit-unchanged; so does a whole pass, for the states it replaces."""
    opts = {**_FUSED, "subproblem_chunk": 3,
            "subproblem_kernel_mode": mode}
    ph = PHBase(_port_uc(), opts, device="cpu")
    factors, data = ph._get_factors(False)
    slices = ph._chunk_index(3)
    states = list(ph._ensure_chunk_states(False, factors, data, slices))
    assert states[0] is states[1]           # one cold state serves all
    snap = _snapshot(states)
    idx = slices[0][0]
    d0 = data._replace(l=data.l[idx], u=data.u[idx], lb=data.lb[idx],
                       ub=data.ub[idx])
    kw = dict(prox_on=False, precision="native", sub_max_iter=200,
              sub_eps=1e-8, sub_eps_hot=None, sub_eps_dua_hot=None,
              stall_rel=0.0, segment=100, polish_hot=True,
              polish_chunk=2, kernel=ph._kernel_plan(False, factors))
    st, x, _, _ = _solver_call(factors, d0, ph.c[idx], states[0], **kw)
    assert not torch.equal(st.x, states[1].x)
    assert _unchanged(states, snap)
    ph.solve_loop(w_on=False, prox_on=False)
    assert _unchanged(states, snap)
    warm = list(ph._chunk_states[False])
    snap = _snapshot(warm)
    ph.W = ph.W_new
    ph.solve_loop(w_on=True, prox_on=False)
    assert _unchanged(warm, snap)


# ---------------- (i) the branches of later slices ----------------

@pytest.mark.parametrize("case, message", [
    ("mixed", "subproblem_precision='mixed'"),
    ("df32", "subproblem_precision='df32'"),
    ("shrink_fix", "problem shrinking"),
    ("shrink_compact", "problem shrinking"),
    ("shrink_rho", "problem shrinking"),
    ("mesh", "device mesh"),
    ("stream", "scenario streaming"),
    ("dispatch", "dispatch-masked solve")])
def test_unported_branches_raise(case, message):
    """Each branch that belongs to a later slice raises its own
    NotImplementedError naming ROADMAP.md; none runs another path. The
    mixed and df32 precisions run since their slice landed; asked to
    combine with a later slice's branch (compaction of the split-f32
    data, A9b, here) they raise, naming the precision. Problem shrinking
    runs since its slice landed (A9): each option builds the engine and
    solves, compaction only with the device fixer (the JAX package's
    ValueError otherwise). The device mesh runs since A8 landed: a
    one-rank mesh solves as the unsharded engine does. The dispatch-masked solve runs since APH
    landed: it solves only the ids given, and refuses the W/x̄ update
    (the JAX package's ValueError). Scenario streaming runs since its
    slice landed (A12): a streamed engine solves as the resident one
    does, and an unknown source is the JAX package's ValueError."""
    opts = {"subproblem_chunk": 3}
    kw, solve_kw = {}, {}
    if case in ("mixed", "df32"):
        opts["subproblem_precision"] = case
        opts["shrink_fix"] = opts["shrink_compact"] = True
    elif case.startswith("shrink"):
        if case == "shrink_compact":
            with pytest.raises(ValueError, match="needs shrink_fix"):
                PHBase(_port_uc(), dict(opts, shrink_compact=True),
                       device="cpu")
            opts["shrink_fix"] = True
        opts[case] = True
        ph = PHBase(_port_uc(), opts, device="cpu")
        ph.solve_loop(w_on=False, prox_on=False)
        assert ph._shrink_status is not None and ph.x is not None
        return
    elif case == "mesh":
        # runs since its slice landed (A8): a one-rank mesh is the
        # unsharded engine on the mesh's device
        from mpisppy_tpu_torch.parallel.mesh import make_mesh
        ph = PHBase(_port_uc(), opts, mesh=make_mesh(device="cpu"))
        ph.solve_loop(w_on=False, prox_on=False)
        ref = PHBase(_port_uc(), opts, device="cpu")
        ref.solve_loop(w_on=False, prox_on=False)
        assert ph._shard_ops is None and ph.device.type == "cpu"
        assert torch.equal(ph.xbar, ref.xbar)
        assert ph.phase_timing(False)["mode"] == "host"
        return
    elif case == "stream":
        # runs since its slice landed (A12): streamed equals resident
        ph = PHBase(_port_uc(), dict(opts, scenario_source="streamed"),
                    device="cpu")
        ph.solve_loop(w_on=False, prox_on=False)
        ph.close_stream()
        ref = PHBase(_port_uc(), opts, device="cpu")
        ref.solve_loop(w_on=False, prox_on=False)
        assert torch.equal(ph.xbar, ref.xbar)
        with pytest.raises(ValueError, match="unknown scenario_source"):
            PHBase(_port_uc(), dict(opts, scenario_source="banana"),
                   device="cpu")
        return
    else:
        ph = PHBase(_port_uc(), opts, device="cpu")
        ph.solve_loop(w_on=False, prox_on=False)
        x0 = ph.x.clone()
        ph.solve_loop(w_on=False, prox_on=False, update=False,
                      dispatch=np.arange(3))
        assert torch.equal(ph.x[3:], x0[3:])
        with pytest.raises(ValueError, match=message):
            ph.solve_loop(w_on=False, prox_on=False,
                          dispatch=np.arange(3))
        return
    with pytest.raises(NotImplementedError,
                       match=f"{message}.*ROADMAP\\.md"):
        ph = PHBase(_port_uc(), opts, device="cpu", **kw)
        ph.solve_loop(w_on=False, prox_on=False, **solve_kw)
