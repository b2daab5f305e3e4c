"""Active-set compaction in the port's engines (mpisppy_tpu_torch
core/ph.py maybe_compact and the compacted solve paths, core/aph.py under
compaction) against the JAX package's and against the port's own
pin-box runs, on the CPU.

Against the JAX package: UC with the slice's fixed-rho block options
(the block's plain version here, the JAX block in interpret mode), a
device fixer that fixes about half the nonant slots at iteration 2 and
more later, buckets 0.5 and 0.75, so the run compacts twice and the
second transition transplants compacted iterates into a smaller width.
x̄ and W are held at 1e-8 and the trivial bound at 2e-6 (the polish's
reproducibility, ROADMAP.md C.1). The chunked port is held against the
JAX package's UNCHUNKED loop: the JAX chunked loop warm-starts a new
mode from a mix of scaled and unscaled iterates (ROADMAP.md C.2).

Against the port's pin-box run, at tests/test_shrink.py's bars: chunked
UC at 1e-8, farmer at 1e-5. Then tests/test_shrink.py's full-width
bypass and compacted hospital cases on the port; its other cases are in
tests/test_torch_shrink.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mpisppy_tpu.extensions as jax_ext
from mpisppy_tpu.core.ph import PH as JaxPH
from mpisppy_tpu.extensions.fixer import uniform_fix_list as jax_ufl
from mpisppy_tpu.ir.batch import build_batch as jax_build_batch
from mpisppy_tpu.models import uc as jax_uc
from mpisppy_tpu_torch import obs
from mpisppy_tpu_torch.core.ph import PH
from mpisppy_tpu_torch.extensions.fixer import uniform_fix_list
from mpisppy_tpu_torch.ir.batch import build_batch
from mpisppy_tpu_torch.models import farmer, uc
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

BIG = 2 ** 30
_UC_KW = {"num_gens": 3, "num_hours": 6}
# the slice's block options at this size, with the device fixer and two
# buckets
_BLOCK = {"defaultPHrho": 100.0, "PHIterLimit": 8, "convthresh": -1.0,
          "subproblem_kernel_mode": "fused",
          "subproblem_kernel_backend": "pallas",
          "subproblem_max_iter": 400, "subproblem_polish_hot": False,
          "subproblem_polish_chunk": 2, "shrink_fix": True,
          "shrink_compact": True, "shrink_buckets": "0.5,0.75"}
_SPEC = dict(tol=1e-2, nb=2, lb=2, ub=2, integer_only=False)


def slot0_fix_list(b):
    """Only slot 0 ever fixes: a PARTIAL fixed set, so compaction keeps
    free slots (tests/test_shrink.py)."""
    spec = uniform_fix_list(b, tol=5e-1, nb=3, lb=3, ub=3,
                            integer_only=False)
    for k in ("nb", "lb", "ub"):
        a = np.minimum(spec[k], BIG).copy()
        a[1:] = BIG
        spec[k] = a
    return spec


# tests/test_shrink.py's options
FARMER_OPTS = {"defaultPHrho": 5.0, "PHIterLimit": 25, "convthresh": 0.0,
               "subproblem_max_iter": 3000, "subproblem_eps": 1e-8,
               "shrink_fix": True, "id_fix_list_fct": slot0_fix_list}
UC_OPTS = {"defaultPHrho": 50.0, "PHIterLimit": 10, "convthresh": 0.0,
           "subproblem_max_iter": 4000, "subproblem_eps": 1e-6,
           "subproblem_chunk": 3, "iter0_infeasibility_abort": False,
           "shrink_fix": True,
           "id_fix_list_fct":
               lambda b: uniform_fix_list(b, tol=1e-2, nb=3, lb=3, ub=3)}


def farmer_batch(S=3):
    return build_batch(farmer.scenario_creator, farmer.make_tree(S))


def uc_batch(S=4, G=2, T=4, **kw):
    return build_batch(uc.scenario_creator, uc.make_tree(S),
                       creator_kwargs={"num_gens": G, "num_hours": T, **kw},
                       vector_patch=uc.scenario_vector_patch)


def uc_int(S=6):
    """tests/test_shrink.py's uc_batch(6, 3, 6): integer commitments."""
    return uc_batch(S, 3, 6, relax_integrality=False)


def _rel_close(ref, got, tol):
    ref = np.asarray(ref)
    got = got.cpu().numpy() if hasattr(got, "cpu") else np.asarray(got)
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * scale)


@pytest.fixture
def mem_obs():
    rec = obs.configure()
    yield rec
    obs.shutdown()


# ---------------- against the JAX package ----------------

@pytest.mark.parametrize("S,chunk", [(4, 0), (8, 3)],
                         ids=["unchunked", "chunked"])
def test_compacted_run_matches_jax(S, chunk):
    """8 PH iterations with two compactions (buckets 0.5 and 0.75) in
    both packages: the same fixed slots, the same compacted widths, x̄
    and W at 1e-8, the Eobjective at 1e-8 and the trivial bound at 2e-6,
    one transplant per transition and no cold fallback; the port's
    full-width x and the compacted width of its last solve."""
    jb = jax_build_batch(jax_uc.scenario_creator, jax_uc.make_tree(S),
                         creator_kwargs=_UC_KW,
                         vector_patch=jax_uc.scenario_vector_patch)
    j = JaxPH(jb, dict(_BLOCK, id_fix_list_fct=lambda b: jax_ufl(
        b, **_SPEC)), dtype=jnp.float64)
    conv_j, eobj_j, tb_j = j.ph_main()
    o = dict(_BLOCK, id_fix_list_fct=lambda b: uniform_fix_list(b, **_SPEC))
    if chunk:
        o["subproblem_chunk"] = chunk
    p = PH(uc_batch(S, **_UC_KW), o, device="cpu")
    conv_p, eobj_p, tb_p = p.ph_main()
    sj, sp = j._shrink_status, p._shrink_status
    assert sp["compactions"] == sj["compactions"] == 2
    for k in ("fixed", "bucket", "n_cols", "m_rows", "transplants"):
        assert sp[k] == sj[k], k
    assert sp["transplant_cold"] == 0 and sp["refactorizations"] == 2
    np.testing.assert_array_equal(p._shrink.keep_cols_np,
                                  j._shrink.keep_cols_np)
    np.testing.assert_array_equal(p._fixed_mask.numpy(),
                                  np.asarray(j._fixed_mask))
    _rel_close(j.xbar, p.xbar, 1e-8)
    _rel_close(j.W, p.W, 1e-8)
    assert conv_p == pytest.approx(conv_j, rel=1e-8)
    assert eobj_p == pytest.approx(eobj_j, rel=1e-8)
    assert tb_p == pytest.approx(tb_j, rel=2e-6)
    assert p.x.shape == (S, p.batch.n)
    factors, data = p._get_factors(True)
    assert data.lb.shape[-1] == p._shrink.n_c < p.batch.n
    assert p._kernel_plans[True].backend == "cuda"


# ---------------- against the port's pin-box runs ----------------

def test_compaction_roundtrip_farmer():
    """Compact -> solve -> expand equals the pin-box run to solver
    tolerance on the batched-A farmer, the certified prox-off dual bound
    through the dual fold included (tests/test_shrink.py's bars)."""
    base = dict(FARMER_OPTS, PHIterLimit=40)   # settles W (the JAX case)
    ph0 = PH(farmer_batch(), base, device="cpu")
    ph0.ph_main()
    ph1 = PH(farmer_batch(), dict(base, shrink_compact=True,
                                  shrink_buckets="0.2"), device="cpu")
    ph1.ph_main()
    st = ph1._shrink_status
    assert st["compactions"] == 1 and st["bucket"] == 0.2
    assert st["n_cols"] < ph1.batch.n and ph1._shrink is not None
    assert ph1.x.shape == ph0.x.shape
    np.testing.assert_allclose(ph1.xbar.numpy(), ph0.xbar.numpy(),
                               rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(ph1.W.numpy(), ph0.W.numpy(), atol=5e-2)
    assert ph1.Eobjective_value() == pytest.approx(
        ph0.Eobjective_value(), rel=1e-5)
    ph0.solve_loop(w_on=True, prox_on=False, update=False)
    ph1.solve_loop(w_on=True, prox_on=False, update=False)
    assert ph1.Ebound() == pytest.approx(ph0.Ebound(), rel=1e-5)
    # fixed-mode consumers keep the FULL system
    xhat = ph1.xbar.numpy()[0]
    assert ph1.calculate_incumbent(xhat) == pytest.approx(
        ph0.calculate_incumbent(xhat), rel=1e-5)
    ph1.solve_loop(w_on=True, prox_on=True)
    assert ph1.x.shape[1] == ph1.batch.n


def test_compaction_roundtrip_uc_chunked(mem_obs):
    """Shared-A UC through the chunked loop: the compacted chunk chain
    reproduces the pin-box trajectory (x̄ at 1e-8, W at 1e-6, Eobjective
    at 1e-8), with one stacked gate read per solve call plus one per
    chunk retry, and the byte model tracking the active set.

    The gate count: on this batch the transplanted start of chunk 0's
    first compacted solve stalls at pri_rel 1.47e-2 (the JAX qp_solve
    from the same start stalls there too) and its retry costs one read;
    the JAX package's chunked loop starts that solve elsewhere (ROADMAP
    C.2). tests/test_shrink.py's bound, at most two reads over one per
    call, holds."""
    o = dict(UC_OPTS, PHIterLimit=6)     # the compaction lands at 3
    ph0 = PH(uc_int(), o, device="cpu")
    ph0.ph_main()
    hbm_full = ph0._shrink_status["est_hbm_bytes_per_iter"]
    ph1 = PH(uc_int(), dict(o, shrink_compact=True,
                            shrink_buckets="0.1,0.5"), device="cpu")
    c0 = obs.counters_snapshot()
    ph1.ph_main()
    c1 = obs.counters_snapshot()
    st = ph1._shrink_status
    assert st["compactions"] >= 1
    assert st["n_cols"] < ph1.batch.n and st["m_rows"] <= ph1.batch.m
    assert st["est_hbm_bytes_per_iter"] < hbm_full
    np.testing.assert_allclose(ph1.xbar.numpy(), ph0.xbar.numpy(),
                               atol=1e-8)
    np.testing.assert_allclose(ph1.W.numpy(), ph0.W.numpy(), atol=1e-6)
    assert ph1.Eobjective_value() == pytest.approx(
        ph0.Eobjective_value(), rel=1e-8)

    def delta(k):
        return c1.get(k, 0) - c0.get(k, 0)

    syncs, calls = delta("ph.gate_syncs"), delta("ph.solve_loop_calls")
    assert -(-ph1.batch.S // 3) > 1
    assert syncs == calls + delta("ph.chunk_retries") \
        + delta("ph.hospital_treated")
    assert syncs <= calls + 2


def test_full_width_consumers_bypass_compacted_factors():
    """dive_nonant_candidates builds full-width operands against self.c:
    under an active plan it pairs them with FULL factors and a
    full-width cold state, and leaves the compacted hot-loop state
    alone."""
    ph = PH(uc_int(), dict(UC_OPTS, PHIterLimit=4, shrink_compact=True,
                           shrink_buckets="0.1"), device="cpu")
    ph.ph_main()
    assert ph._shrink is not None
    hot = ph._qp_states[True]
    cands, feas = ph.dive_nonant_candidates()
    assert cands.shape == (ph.batch.S, ph.batch.K)
    assert ph._qp_states[True] is hot
    ph.solve_loop(w_on=True, prox_on=True)
    assert ph.x.shape[1] == ph.batch.n


# ---------------- the compacted hospital ----------------

def test_compacted_hospital_treats_flagged_rows(mem_obs):
    """The hospital runs against the COMPACTED system: it assembles from
    the compacted cost and the free-slot hub blocks, factors at the
    compacted width and scatters cured rows back into compacted-width
    records; the compacted loop keeps working with it armed."""
    ph = PH(uc_int(), dict(UC_OPTS, PHIterLimit=4, shrink_compact=True,
                           shrink_buckets="0.01",
                           id_fix_list_fct=slot0_fix_list), device="cpu")
    ph.ph_main()
    shrink = ph._shrink
    assert shrink is not None
    factors, data = ph._get_factors(True)
    assert data.lb.shape[-1] == shrink.n_c < ph.batch.n
    slices = ph._chunk_index(3)
    states = ph._chunk_states[True]
    nc, mc = shrink.n_c, data.l.shape[-1]
    z = lambda k: torch.zeros((3, k), dtype=torch.float64)  # noqa: E731
    recs = []
    for ci, _ in enumerate(slices):
        st = states[ci]
        if ci == 1:     # one row of chunk 1 grossly unconverged
            pr = st.pri_rel.clone()
            pr[0] = 1.0
            st = st._replace(pri_rel=pr)
        recs.append([st, z(nc), z(mc), z(nc), None, None])
    kw = dict(prox_on=True, precision=ph.sub_precision,
              sub_max_iter=ph.sub_max_iter, sub_eps=ph.sub_eps,
              sub_eps_hot=ph.sub_eps_hot,
              sub_eps_dua_hot=ph.sub_eps_dua_hot,
              tail_iter=ph.sub_tail_iter, stall_rel=ph.sub_stall_rel,
              segment=ph.sub_segment, polish_hot=ph.sub_polish_hot,
              polish_chunk=0, segment_lo=ph.sub_segment_lo)
    treated0 = obs.counters_snapshot().get("ph.hospital_treated", 0)
    ph._hospitalize(True, slices, recs, data, thr=1e-2, w_on=True,
                    prox_on=True, kw=kw, shrink=shrink)
    assert obs.counters_snapshot().get("ph.hospital_treated", 0) \
        - treated0 == 1
    assert float(recs[1][0].pri_rel[0]) < 1e-2
    assert recs[1][1].shape == (3, nc)
    assert float(recs[1][1][0].abs().max()) > 0.0
    assert float(recs[0][1].abs().max()) == 0.0
    ph.solve_loop(w_on=True, prox_on=True)
    assert ph.x.shape[1] == ph.batch.n
