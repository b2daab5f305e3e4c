"""The port's PH engine in df32 precision (mpisppy_tpu_torch.core.ph
with ``subproblem_precision="df32"``, chunked and unchunked, both kernel
modes; mixed: tests/test_torch_mixed_ph.py) against the JAX package's on the same
batches, built from the same seed, on the CPU.

Whole PH runs are held at the JAX tests' own bars
(tests/test_precision.py, tests/test_kernels.py,
tests/test_pipeline.py), each stated where it is checked: torch and XLA
sum f32 products in different orders, the bulk phase and the rho
adaptation amplify that, and loosely converged solves of this
degenerate LP land on different points of its optimal face."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpisppy_tpu import obs as jax_obs
from mpisppy_tpu.core.ph import PHBase as JaxPHBase
from mpisppy_tpu.ir.batch import build_batch as jax_build_batch
from mpisppy_tpu.models import uc as jax_uc
from mpisppy_tpu_torch import obs
from mpisppy_tpu_torch.core.ph import PHBase
from mpisppy_tpu_torch.ir.batch import build_batch
from mpisppy_tpu_torch.models import uc
from mpisppy_tpu_torch.ops import qp_solver as T


# ---------------- PH engines ----------------

def _uc_batches(S=4, patch=False, G=3, T_=6):
    kw = {"num_gens": G, "num_hours": T_}
    if patch:
        return (jax_build_batch(jax_uc.scenario_creator,
                                jax_uc.make_tree(S), creator_kwargs=kw,
                                vector_patch=jax_uc.scenario_vector_patch),
                build_batch(uc.scenario_creator, uc.make_tree(S),
                            creator_kwargs=kw,
                            vector_patch=uc.scenario_vector_patch))
    kw["relax_integrality"] = True
    return (jax_build_batch(jax_uc.scenario_creator, jax_uc.make_tree(S),
                            creator_kwargs=kw),
            build_batch(uc.scenario_creator, uc.make_tree(S),
                        creator_kwargs=kw))


def _iterate(ph, iters):
    for it in range(iters):
        ph.solve_loop(w_on=it > 0, prox_on=it > 0)
        ph.W = ph.W_new
    return ph


_E2E = {"defaultPHrho": 50.0, "subproblem_max_iter": 1500,
        "subproblem_eps": 1e-7, "subproblem_tail_iter": 2000}


@pytest.mark.parametrize("chunk", [0, 2])
def test_df32_ph_engine_end_to_end(chunk):
    """PHBase(..., subproblem_precision='df32'): spbase ships the split
    A, the engine swaps in the ScaledView, every mode shares one scaled
    split, and after 4 iterations the run prices the consensus like the
    JAX package's native-f64 engine on the same batch
    (tests/test_precision.py:249): pri_rel below 5e-3, conv within 10x,
    Eobjective within 2e-2 (5e-2 chunked, the JAX test's band for the
    per-chunk rho trajectories)."""
    bj, bp = _uc_batches()
    ref = _iterate(JaxPHBase(bj, dict(_E2E), dtype=jnp.float64), 4)
    ph = PHBase(bp, {**_E2E, "subproblem_precision": "df32",
                     "subproblem_chunk": chunk}, device="cpu")
    assert isinstance(ph.qp_data.A, T.SplitMatrix)
    _iterate(ph, 4)
    assert isinstance(ph.qp_data.A, T.ScaledView)
    f_off, f_on = ph._factors[False][0], ph._factors[True][0]
    assert f_on.A_s is f_off.A_s and f_on.D is f_off.D
    assert float(ph._qp_states[True].pri_rel.max()) < 5e-3
    assert ph.conv < 10 * max(ref.conv, 1e-3)
    assert ph.Eobjective_value() == pytest.approx(
        ref.Eobjective_value(), rel=5e-2 if chunk else 2e-2)


# tests/test_kernels.py / tests/test_pipeline.py's chunked df32 options
_CHUNKED = {"defaultPHrho": 50.0, "subproblem_precision": "df32",
            "subproblem_max_iter": 400, "subproblem_eps": 1e-5,
            "subproblem_eps_hot": 1e-4, "subproblem_eps_dua_hot": 1e-2,
            "subproblem_stall_rel": 1.5e-3, "subproblem_tail_iter": 150,
            "subproblem_segment": 150, "subproblem_polish_hot": False,
            "subproblem_hospital": False, "subproblem_chunk": 2}


@pytest.mark.parametrize("mode", ["fused", "segmented"])
def test_chunked_df32_iter0_matches_jax(mode):
    """Iter 0 of chunked df32 (no transplant yet, see ROADMAP.md C.2)
    against the JAX package's: both below the 1e-2 recovery gate, the
    expected objective within the JAX package's 5e-2 band for per-chunk
    rho trajectories (tests/test_precision.py:305), one gate sync. The
    fused solves run fixed budgets, so there the per-chunk iteration
    counts, L⁻¹ builds and retries are the JAX package's too; segmented
    solves exit on residual tests whose crossings move with f32
    roundoff, and a retry there is one such crossing."""
    bj, bp = _uc_batches(patch=True)
    j = JaxPHBase(bj, {**_CHUNKED, "subproblem_kernel_mode": mode},
                  dtype=jnp.float64)
    p = PHBase(bp, {**_CHUNKED, "subproblem_kernel_mode": mode},
               device="cpu")
    jax_obs.configure(out_dir=None)
    obs.configure()
    try:
        j.solve_loop(w_on=False, prox_on=False)
        p.solve_loop(w_on=False, prox_on=False)
        cj, cp = jax_obs.counters_snapshot(), obs.counters_snapshot()
    finally:
        jax_obs.shutdown()
        obs.shutdown()
    assert cj.get("ph.gate_syncs") == 1 + cj.get("ph.chunk_retries", 0)
    assert cp.get("ph.gate_syncs") == 1 + cp.get("ph.chunk_retries", 0)
    if mode == "fused":
        for k in ("kernel.l_inv_factorizations", "ph.chunk_retries"):
            assert cp.get(k, 0) == cj.get(k, 0), k
        assert [s.iters for s in p._chunk_states[False]] \
            == [int(s.iters) for s in j._qp_states[("chunks", False)]]
    assert float(p._qp_states[False].pri_rel.max()) < 1e-2
    assert float(np.asarray(j._qp_states[False].pri_rel).max()) < 1e-2
    assert p.Eobjective_value() == pytest.approx(j.Eobjective_value(),
                                                 rel=5e-2)


def test_pipelined_matches_sequential_df32():
    """The split factor flow is sequential either way; pipelining only
    pre-assembles (tests/test_pipeline.py:56): conv to 1e-6, x̄ to
    1e-5, pri_rel below 1e-2. The flowed factor is one object across
    every chunk state after a pass."""
    _, bp = _uc_batches(patch=True)
    _, bp2 = _uc_batches(patch=True)
    ph_seq = _iterate(PHBase(bp, {**_CHUNKED, "subproblem_pipeline": 0},
                             device="cpu"), 3)
    ph_pip = _iterate(PHBase(bp2, dict(_CHUNKED), device="cpu"), 3)
    assert ph_pip.conv == pytest.approx(ph_seq.conv, abs=1e-6)
    np.testing.assert_allclose(ph_pip.xbar.numpy(), ph_seq.xbar.numpy(),
                               atol=1e-5)
    assert float(ph_pip._qp_states[True].pri_rel.max()) < 1e-2
    sts = ph_pip._chunk_states[True]
    assert all(s.L is sts[0].L for s in sts)


def test_fused_and_segmented_recover_a_pathological_chunk_alike():
    """tests/test_kernels.py:153's set-up: after two iterations the
    flowed rho of chunk 0 is forced to 1e-6. In both kernel modes the
    recovery machinery acts alike: the chunk goes to the segmented
    native-precision retry; a retry result is adopted exactly when it
    improved, and a chunk is blacklisted exactly when its retry ended
    above the 1e-2 gate; every chunk not blacklisted ends below it; the
    fused plan runs the L⁻¹ trade.

    The JAX test's stronger claim, that both modes recover, land the
    same blacklists and a conv within 25 %, holds in neither package on
    this batch (ROADMAP.md C.2): there the fused mode blacklists chunk
    1, here the segmented mode's retry of chunk 0 ends above the gate
    (0.035), and conv follows the chunk left loose (0.037 fused, 0.022
    segmented)."""
    def poisoned(mode):
        _, bp = _uc_batches(patch=True)
        ph = _iterate(PHBase(bp, {**_CHUNKED,
                                  "subproblem_kernel_mode": mode},
                             device="cpu"), 2)
        sts = ph._chunk_states[True]
        factors, _ = ph._get_factors(True)
        bad = torch.full_like(sts[0].rho_scale, 1e-6)
        sts[0] = sts[0]._replace(rho_scale=bad,
                                 L=T._factorize(factors, bad))
        obs.configure()
        try:
            ph.solve_loop(w_on=True, prox_on=True)
            retries = [e[1] for e in obs.events("ph.chunk_retry")]
        finally:
            obs.shutdown()
        return ph, retries

    thr = 1e-2
    for mode in ("fused", "segmented"):
        ph, retries = poisoned(mode)
        assert 0 in [r["chunk"] for r in retries]
        black = ph._chunk_no_retry.get(True, set())
        assert black == {r["chunk"] for r in retries
                         if not r["pri_rel_after"] <= thr}
        pr = ph._qp_states[True].pri_rel.numpy()
        for ci, (_, real) in enumerate(ph._chunk_index(2)):
            rows = pr[2 * ci:2 * ci + real]
            retry = [r for r in retries if r["chunk"] == ci]
            if retry:
                r = retry[0]
                kept = min(r["pri_rel_before"], r["pri_rel_after"])
                assert float(rows.max()) == pytest.approx(kept, rel=1e-12)
            if ci not in black:
                assert float(rows.max()) < thr
        assert np.isfinite(ph.conv)
        if mode == "fused":
            assert ph.phase_timing(True)["kernel"]["l_inv"]
