"""The port's scenario bundling (mpisppy_tpu_torch core/bundles.py)
against the JAX package's: form_bundles on the same batches (every
array bit-equal; a shared constraint matrix stays one 2-D matrix equal
to each bundle's matrix of the JAX stack), unbundle_x, the cases of
tests/test_bundles.py (the bundled EF against the unbundled one, PH over
bundles against unbundled PH, the round trip), and a bundled UC on the
fixed-rho block path."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpisppy_tpu.core.bundles import form_bundles as jax_form_bundles
from mpisppy_tpu.core.bundles import unbundle_x as jax_unbundle_x
from mpisppy_tpu.ir.batch import build_batch as jax_build_batch
from mpisppy_tpu.models import farmer as jax_farmer
from mpisppy_tpu.models import uc as jax_uc
from mpisppy_tpu_torch.core.bundles import form_bundles, unbundle_x
from mpisppy_tpu_torch.core.ef import ExtensiveForm
from mpisppy_tpu_torch.core.ph import PH, PHBase
from mpisppy_tpu_torch.ir.batch import build_batch
from mpisppy_tpu_torch.models import farmer, uc
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

_UC_KW = {"num_gens": 3, "num_hours": 6}
_FIELDS = ("c", "c0", "P_diag", "l", "u", "lb", "ub", "c_stage",
           "c0_stage", "prob", "nonant_idx", "nonant_stage")


def _batch(S=4):
    return build_batch(farmer.scenario_creator, farmer.make_tree(S))


def _pair(model, S):
    if model == "farmer":
        return (jax_build_batch(jax_farmer.scenario_creator,
                                jax_farmer.make_tree(S)), _batch(S))
    return (jax_build_batch(jax_uc.scenario_creator, jax_uc.make_tree(S),
                            creator_kwargs=_UC_KW,
                            vector_patch=jax_uc.scenario_vector_patch),
            build_batch(uc.scenario_creator, uc.make_tree(S),
                        creator_kwargs=_UC_KW,
                        vector_patch=uc.scenario_vector_patch))


def _opts(**kw):
    o = {"defaultPHrho": 1.0, "PHIterLimit": 40, "convthresh": 1e-4,
         "subproblem_max_iter": 3000}
    o.update(kw)
    return o


@pytest.mark.parametrize("model,S,B", [("farmer", 4, 2), ("farmer", 6, 3),
                                       ("uc", 4, 2), ("uc", 6, 2)])
def test_form_bundles_matches_jax(model, S, B):
    """Every array of the bundled batch bit-equal to the JAX package's;
    the constraint matrix is a (B, mB, nB) stack for farmer's
    per-scenario matrices, and for UC's shared matrix one 2-D (mB, nB)
    matrix equal to each JAX A[b]. Tree, template slices and integer
    mask equal."""
    jb, pb = _pair(model, S)
    j = jax_form_bundles(jb, B)
    p = form_bundles(pb, B)
    assert p.S == j.S == B and p.n == j.n and p.m == j.m
    for f in _FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(p, f)),
                                      np.asarray(getattr(j, f)), err_msg=f)
    jA = np.asarray(j.A)
    assert jA.ndim == 3
    if model == "uc":
        assert pb.shared_A and p.shared_A and p.A.shape == jA.shape[1:]
        for b in range(B):
            np.testing.assert_array_equal(p.A, jA[b])
    else:
        assert not p.shared_A
        np.testing.assert_array_equal(p.A, jA)
    np.testing.assert_array_equal(p.integer, j.integer)
    assert p.template.var_slices == j.template.var_slices
    assert p.template.sense == j.template.sense
    assert p.tree.scen_names == j.tree.scen_names
    np.testing.assert_array_equal(p.tree.probabilities,
                                  j.tree.probabilities)
    assert p.stage_slot_slices == j.stage_slot_slices


def test_form_bundles_refusals():
    with pytest.raises(ValueError, match="must divide"):
        form_bundles(_batch(4), 3)
    from mpisppy_tpu_torch.models import hydro
    with pytest.raises(ValueError, match="two-stage only"):
        form_bundles(build_batch(hydro.scenario_creator, hydro.make_tree()),
                     1)


@pytest.mark.parametrize("model", ["farmer", "uc"])
def test_unbundle_x_matches_jax(model):
    """unbundle_x maps the same bundled block to the same scenario
    block as the JAX package's, from numpy and from a tensor."""
    jb, pb = _pair(model, 4)
    bundled = form_bundles(pb, 2)
    xB = np.random.RandomState(0).randn(2, bundled.n)
    want = jax_unbundle_x(jb, jax_form_bundles(jb, 2), xB)
    np.testing.assert_array_equal(unbundle_x(pb, bundled, xB), want)
    np.testing.assert_array_equal(
        unbundle_x(pb, bundled, torch.as_tensor(xB)), want)


# ---- tests/test_bundles.py ----

def test_bundled_ef_matches_unbundled():
    batch = _batch(4)
    obj0, _ = ExtensiveForm(batch, device="cpu").solve_extensive_form()
    bundled = form_bundles(_batch(4), 2)
    assert bundled.S == 2 and abs(float(bundled.prob.sum()) - 1.0) < 1e-12
    obj1, _ = ExtensiveForm(bundled, device="cpu").solve_extensive_form()
    assert obj1 == pytest.approx(obj0, abs=1.0)


def test_bundled_ph_agrees_with_unbundled():
    batch = _batch(4)
    ph0 = PH(batch, _opts(), device="cpu")
    ph0.ph_main(finalize=False)

    bundled = form_bundles(_batch(4), 2)
    ph1 = PH(bundled, _opts(), device="cpu")
    ph1.ph_main(finalize=False)

    # converged first-stage means agree
    assert np.allclose(ph1.xbar.numpy()[0], ph0.xbar.numpy()[0], atol=2.0)
    # bundling tightens the wait-and-see (trivial) bound:
    # E_b[min over bundle EF] >= E_s[min over scenario]
    assert ph1.trivial_bound >= ph0.trivial_bound - 1e-6
    # and it stays a valid outer bound
    obj0, _ = ExtensiveForm(_batch(4), device="cpu").solve_extensive_form()
    assert ph1.trivial_bound <= obj0 + 1.0


def test_unbundle_roundtrip():
    batch = _batch(4)
    bundled = form_bundles(_batch(4), 2)
    ph = PHBase(bundled, _opts(), device="cpu")
    ph.solve_loop(w_on=False, prox_on=False)
    x = unbundle_x(batch, bundled, ph.x)
    assert x.shape == (4, batch.n)
    # members of a bundle share first-stage values
    idx = np.asarray(batch.nonant_idx)
    assert np.allclose(x[0, idx], x[1, idx])
    assert np.allclose(x[2, idx], x[3, idx])
    # and each scenario's rows are feasible at the unbundled data
    for s in range(4):
        Ax = np.asarray(batch.A_of(s)) @ x[s]
        scale = 1.0 + np.maximum(
            np.where(np.isfinite(batch.l[s]), np.abs(batch.l[s]), 0.0),
            np.where(np.isfinite(batch.u[s]), np.abs(batch.u[s]), 0.0))
        assert (Ax >= batch.l[s] - 1e-5 * scale).all()
        assert (Ax <= batch.u[s] + 1e-5 * scale).all()


# ---- a bundled UC on the block path ----

_UC_OPTS = {"defaultPHrho": 100.0, "PHIterLimit": 2, "convthresh": -1.0,
            "subproblem_kernel_mode": "fused",
            "subproblem_kernel_backend": "pallas",
            "subproblem_max_iter": 400, "subproblem_polish_hot": False,
            "subproblem_polish_chunk": 2}


def test_bundled_uc_ph_matches_jax_on_the_block_path():
    """PH over UC 4 x 6 in 2 bundles with the slice's block options in
    both packages (the JAX package on its dense (B, mB, nB) stack, the
    port on its one shared matrix, which puts the bundles on the
    block's shared-A path): the port's plan is the cuda block, x̄ and W
    after two prox-on iterations agree to 1e-8 of their largest entries
    (measured 8e-12 and 2e-10), Σ p W = 0, and the certified trivial
    bound agrees to 2e-6 relative, the polish's reproducibility
    (ROADMAP.md C.1, the bar of tests/test_torch_chunked.py; measured
    1.2e-6 here, 2.9e-7 unbundled)."""
    from mpisppy_tpu.core.ph import PH as JaxPH
    jb, pb = _pair("uc", 4)
    j = JaxPH(jax_form_bundles(jb, 2), dict(_UC_OPTS), dtype=jnp.float64)
    j.ph_main(finalize=False)
    p = PH(form_bundles(pb, 2), dict(_UC_OPTS), device="cpu")
    p.ph_main(finalize=False)
    assert p.shared_structure and p.qp_data.A.ndim == 2
    assert {pl.backend for pl in p._kernel_plans.values()} == {"cuda"}
    assert p.trivial_bound == pytest.approx(j.trivial_bound, rel=2e-6)
    for name in ("xbar", "W"):
        a, b = getattr(p, name).numpy(), np.asarray(getattr(j, name))
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=1e-8 * max(1.0, np.abs(b).max()))
    W = p.W
    assert float((p.prob @ W).abs().max()) \
        <= 1e-9 * max(1.0, float(W.abs().max()))
