"""The port's Progressive Hedging (mpisppy_tpu_torch.core.ph) against
the JAX package's on the same scenario batches: the slice's path (UC,
fused mode, the hand-written block's backend) and the segmented path
on farmer."""

import jax.numpy as jnp
import numpy as np
import pytest

from mpisppy_tpu.core.ph import PH as JaxPH
from mpisppy_tpu.ir.batch import build_batch as jax_build_batch
from mpisppy_tpu.models import uc as jax_uc
from mpisppy_tpu_torch.core.ph import PH
from mpisppy_tpu_torch.ir.batch import build_batch
from mpisppy_tpu_torch.models import farmer, uc
from mpisppy_tpu_torch.utils.carry import from_numpy_state
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

_UC_KW = {"num_gens": 3, "num_hours": 6}
# the slice's options at this size (the block runs the whole budget at
# fixed rho; prox-on solves skip the polish)
_OPTS = {"defaultPHrho": 100.0, "PHIterLimit": 3,
         "subproblem_kernel_mode": "fused",
         "subproblem_kernel_backend": "pallas",
         "subproblem_max_iter": 400, "subproblem_polish_hot": False,
         "subproblem_polish_chunk": 2}


class _ConvLog:
    """Extension recording conv after every PH iteration (any other hook
    is a no-op)."""

    def __init__(self):
        self.conv = []

    def miditer(self, ph):
        self.conv.append(ph.conv)

    def __getattr__(self, name):
        return lambda ph: None


def _jax_uc(S=4):
    return jax_build_batch(jax_uc.scenario_creator, jax_uc.make_tree(S),
                           creator_kwargs=_UC_KW,
                           vector_patch=jax_uc.scenario_vector_patch)


def _port_uc(S=4):
    return build_batch(uc.scenario_creator, uc.make_tree(S),
                       creator_kwargs=_UC_KW,
                       vector_patch=uc.scenario_vector_patch)


def _rel_close(ref, got, tol):
    ref = np.asarray(ref)
    got = got.cpu().numpy() if hasattr(got, "cpu") else np.asarray(got)
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * scale)


def test_ph_main_uc_fused_matches_jax():
    """3 PH iterations: conv per iteration, x̄, W and the expected
    objective at 1e-8 relative. The trivial bound is held at 1e-6
    relative: it is the certified dual objective of the polish's best
    dual candidate, which moves with roundoff in either package (the
    JAX package alone gives 21033.3437 with polish_chunk 2 and
    21033.3413 with polish_chunk 1, mathematically the same solve)."""
    log_j, log_p = _ConvLog(), _ConvLog()
    j = JaxPH(_jax_uc(), dict(_OPTS), dtype=jnp.float64, extensions=log_j)
    p = PH(_port_uc(), dict(_OPTS), device="cpu", extensions=log_p)
    conv_j, eobj_j, tb_j = j.ph_main()
    conv_p, eobj_p, tb_p = p.ph_main()
    assert p._kernel_plans[True].backend == "cuda"
    assert len(log_p.conv) == len(log_j.conv) == 3
    np.testing.assert_allclose(log_p.conv, log_j.conv, rtol=1e-8)
    _rel_close(j.xbar, p.xbar, 1e-8)
    _rel_close(j.W, p.W, 1e-8)
    assert eobj_p == pytest.approx(eobj_j, rel=1e-8)
    assert tb_p == pytest.approx(tb_j, rel=1e-6)
    # nonanticipativity of the multipliers: sum_s p_s W_s = 0 per slot
    w_sum = (p.prob @ p.W).abs().max()
    assert float(w_sum) <= 1e-8 * float(p.W.abs().max())


def test_one_iteration_from_carried_jax_state():
    """Both packages start one prox-on PH iteration from the JAX engine's
    state after 2 iterations (W, x̄, ρ and the warm QPState with its
    solve operator), carried through utils/carry: x̄, W and conv agree
    at 1e-9."""
    j = JaxPH(_jax_uc(), {**_OPTS, "PHIterLimit": 2}, dtype=jnp.float64)
    j.ph_main()
    st = j._qp_states[True]
    b = j.batch
    arrays = {"c": b.c, "l": b.l, "u": b.u, "lb": b.lb, "ub": b.ub,
              "W": np.asarray(j.W), "xbar": np.asarray(j.xbar),
              "rho": np.asarray(j.rho),
              "qp_state": {k: np.asarray(getattr(st, k)) for k in
                           ("x", "yA", "yB", "zA", "zB", "rho_scale")}}
    arrays["qp_state"]["F"] = np.asarray(st.L)
    p = from_numpy_state(PH(_port_uc(), dict(_OPTS), device="cpu"),
                         arrays)
    j.solve_loop(w_on=True, prox_on=True)
    p.solve_loop(w_on=True, prox_on=True)
    assert p.conv == pytest.approx(j.conv, rel=1e-9)
    _rel_close(j.xbar, p.xbar, 1e-9)
    _rel_close(j.W_new, p.W_new, 1e-9)
    _rel_close(j.x, p.x, 1e-9)


def test_farmer_segmented_trivial_bound_and_w_sum():
    """The canonical sanity drive: farmer(3) on the segmented path gives
    the wait-and-see bound −115405.56 (to the rel 1e-4 of
    tests/test_farmer_ph.py) and W sums to zero."""
    batch = build_batch(farmer.scenario_creator, farmer.make_tree(3))
    ph = PH(batch, {"defaultPHrho": 1.0, "PHIterLimit": 5,
                    "convthresh": 1e-7, "subproblem_max_iter": 4000,
                    "subproblem_kernel_mode": "segmented"}, device="cpu")
    conv, eobj, tbound = ph.ph_main()
    assert ph._kernel_plans[False].mode == "segmented"
    assert tbound == pytest.approx(-115405.56, rel=1e-4)
    assert tbound <= -108390.0 + 1.0
    np.testing.assert_allclose((ph.prob @ ph.W).numpy(), 0.0, atol=1e-6)
