"""The port's PH engine in mixed precision (mpisppy_tpu_torch.core.ph
with ``subproblem_precision="mixed"``: an f32 bulk phase, then an f64
tail, in both kernel modes) against the JAX package's on the same
batches, built from the same seed, on the CPU. Each test states its
bar, the JAX tests' own (tests/test_precision.py,
tests/test_kernels.py)."""

import jax.numpy as jnp
import numpy as np
import pytest

from mpisppy_tpu.core.ph import PHBase as JaxPHBase
from mpisppy_tpu.ir.batch import build_batch as jax_build_batch
from mpisppy_tpu.models import farmer as jax_farmer
from mpisppy_tpu.models import uc as jax_uc
from mpisppy_tpu_torch.core.ph import PH, PHBase
from mpisppy_tpu_torch.ir.batch import build_batch
from mpisppy_tpu_torch.models import farmer, uc
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


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


_MIXED = {"defaultPHrho": 50.0, "subproblem_max_iter": 1200,
          "subproblem_eps": 1e-6, "subproblem_eps_hot": 1e-4,
          "subproblem_eps_dua_hot": 1e-3, "subproblem_precision": "mixed",
          "subproblem_tail_iter": 1500}


@pytest.mark.parametrize("mode", ["segmented", "fused"])
def test_ph_precision_mixed_option(mode):
    """Mixed PH with production-shaped options
    (tests/test_precision.py:105), in both packages: the prox-on solve
    lands below 1e-3 pri_rel; the iter-0 expected objective agrees with
    the JAX package's within 3e-2 (the f32 bulk picks its own point on
    this degenerate LP's plateau; tests/test_precision.py:229's band)
    and each package's certified bound sits below its objective. The
    bounds themselves are not compared: at this budget the duals are
    far from converged and the certified value moves by whole percents
    with roundoff in either package."""
    bj, bp = _uc_batches()
    j = JaxPHBase(bj, {**_MIXED, "subproblem_kernel_mode": mode},
                  dtype=jnp.float64)
    p = PHBase(bp, {**_MIXED, "subproblem_kernel_mode": mode},
               device="cpu")
    for ph in (j, p):
        ph.solve_loop(w_on=False, prox_on=False)
        ph.W = ph.W_new
        assert ph.Ebound() <= ph.Eobjective_value()
    assert p.Eobjective_value() == pytest.approx(j.Eobjective_value(),
                                                 rel=3e-2)
    for ph in (j, p):
        ph.solve_loop(w_on=True, prox_on=True)
        assert float(np.asarray(ph._qp_states[True].pri_rel).max()) < 1e-3


def test_fused_matches_segmented_ph_farmer_mixed():
    """Farmer under 'mixed' (tests/test_kernels.py:135): fused and
    segmented agree at the converged-solve level (conv rel 1e-6, x̄
    1e-6). Against the JAX package's fused run x̄ agrees to 1e-5
    relative: each tail stops at its 1e-8 residual test from its own
    f32 warm start, and farmer's conditioning (~1e3) turns that into
    ~1e-5 in x (measured 4e-6)."""
    opts = {"defaultPHrho": 1.0, "subproblem_precision": "mixed",
            "subproblem_max_iter": 4000, "subproblem_eps": 1e-8,
            "subproblem_segment": 1000}
    runs = {m: _iterate(PHBase(build_batch(farmer.scenario_creator,
                                           farmer.make_tree(3)),
                               {**opts, "subproblem_kernel_mode": m},
                               device="cpu"), 3)
            for m in ("segmented", "fused")}
    ph_s, ph_f = runs["segmented"], runs["fused"]
    assert ph_f.conv == pytest.approx(ph_s.conv, rel=1e-6, abs=1e-9)
    np.testing.assert_allclose(ph_f.xbar.numpy(), ph_s.xbar.numpy(),
                               rtol=1e-6, atol=1e-6)
    j = _iterate(JaxPHBase(jax_build_batch(jax_farmer.scenario_creator,
                                           jax_farmer.make_tree(3)),
                           {**opts, "subproblem_kernel_mode": "fused"},
                           dtype=jnp.float64), 3)
    np.testing.assert_allclose(ph_f.xbar.numpy(), np.asarray(j.xbar),
                               rtol=1e-5)


def test_chunked_mixed_fused_equals_segmented():
    """UC 3 x 6, S = 8 in chunks of 3, mixed, one PH iteration (iter 0
    and one prox-on solve) in both kernel modes, with the bulk and tail
    budgets equal to one segment: the fused solve then runs the
    segmented driver's arithmetic, so x̄ and W agree to 1e-10 x
    max(1, |.|) (chip_smoke.py's mixed check holds the card to the same
    bar)."""
    opts = {"defaultPHrho": 50.0, "PHIterLimit": 1, "convthresh": -1.0,
            "subproblem_precision": "mixed", "subproblem_chunk": 3,
            "subproblem_max_iter": 1000, "subproblem_tail_iter": 1000,
            "subproblem_segment": 1000, "subproblem_eps": 1e-6}
    out = {}
    for mode in ("fused", "segmented"):
        ph = PH(_uc_batches(S=8, patch=True)[1],
                {**opts, "subproblem_kernel_mode": mode}, device="cpu")
        ph.ph_main()
        out[mode] = ph
    assert out["fused"].phase_timing(True)["kernel"]["mode"] == "fused"
    for k in ("xbar", "W"):
        ref, got = getattr(out["segmented"], k), getattr(out["fused"], k)
        scale = max(1.0, float(ref.abs().max()))
        assert float((got - ref).abs().max()) <= 1e-10 * scale
