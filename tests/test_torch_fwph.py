"""The port's FWPH (mpisppy_tpu_torch core/fwph.py, ops/simplex_qp.py,
cylinders/fwph_spoke.py) against the JAX package's: the simplex
projection and the weight QP on the same inputs, one SDM pass on UC
3 x 6 started from the JAX engine's carried state on the fixed-rho
block path, the cases of tests/test_fwph.py on farmer, and the FWPH
spoke as a child process."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpisppy_tpu.core.fwph import FWPH as JaxFWPH
from mpisppy_tpu.ir.batch import build_batch as jax_build_batch
from mpisppy_tpu.models import uc as jax_uc
from mpisppy_tpu.ops import simplex_qp as jax_sqp
from mpisppy_tpu_torch.core.fwph import FWPH
from mpisppy_tpu_torch.core.ph import PH
from mpisppy_tpu_torch.cylinders.fwph_spoke import FrankWolfeOuterBound
from mpisppy_tpu_torch.cylinders.hub import PHHub
from mpisppy_tpu_torch.ir.batch import build_batch
from mpisppy_tpu_torch.models import farmer, uc
from mpisppy_tpu_torch.ops import simplex_qp
from mpisppy_tpu_torch.utils.carry import from_numpy_state
from mpisppy_tpu_torch.utils.sputils import spin_the_wheel
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

EF_OBJ = -108390.0
_UC_KW = {"num_gens": 3, "num_hours": 6}
# the slice's options at this size: the hand-written block's backend
# (its plain version on the CPU), the whole budget at fixed rho
_UC_OPTS = {"defaultPHrho": 100.0, "PHIterLimit": 1, "convthresh": -1.0,
            "subproblem_kernel_mode": "fused",
            "subproblem_kernel_backend": "pallas",
            "subproblem_max_iter": 400, "subproblem_polish_hot": False,
            "subproblem_polish_chunk": 2, "FW_iter_limit": 2,
            "fwph_max_columns": 4}


def _farmer(num_scens=3):
    return build_batch(farmer.scenario_creator, farmer.make_tree(num_scens))


# ---- ops/simplex_qp ----

@pytest.mark.parametrize("seed", [0, 3])
def test_project_simplex_matches_jax(seed):
    """The same points through both projections: equal to 1e-10, on the
    simplex (tests/test_fwph.py's checks), and the identity on a point
    already on it."""
    rng = np.random.RandomState(seed)
    v = rng.randn(7, 5) * 3.0
    p = simplex_qp.project_simplex(torch.as_tensor(v)).numpy()
    np.testing.assert_allclose(
        p, np.asarray(jax_sqp.project_simplex(jnp.asarray(v))), rtol=0,
        atol=1e-10)
    assert np.allclose(p.sum(axis=1), 1.0, atol=1e-9)
    assert (p >= -1e-12).all()
    q = np.full((1, 4), 0.25)
    assert np.allclose(simplex_qp.project_simplex(torch.as_tensor(q)), q)


@pytest.mark.parametrize("seed", [0, 1])
def test_simplex_qp_solve_matches_jax(seed):
    """The weight QP on the same (S, C, K) inputs: the weights, the
    nonant values and the objective equal to 1e-10."""
    rng = np.random.RandomState(seed)
    S, C, K = 4, 6, 5
    args = (rng.randn(S, C, K), rng.randn(S, C), rng.randn(S, K),
            np.abs(rng.randn(S, K)) + 0.5, rng.randn(S, K),
            np.full((S, C), 1.0 / C))
    ja, jx = jax_sqp.simplex_qp_solve(*(jnp.asarray(a) for a in args),
                                      iters=300)
    ta, tx = simplex_qp.simplex_qp_solve(*(torch.as_tensor(a)
                                           for a in args), iters=300)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=0,
                               atol=1e-10)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=0,
                               atol=1e-10)
    jo = jax_sqp.qp_objective_value(*(jnp.asarray(a) for a in args[:5]),
                                    ja)
    to = simplex_qp.qp_objective_value(*(torch.as_tensor(a)
                                         for a in args[:5]), ta)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=1e-10)


# ---- one SDM pass from carried state ----

def _carry(j):
    """The JAX FWPH engine's PH state, prox-off solver state and column
    pool, as the port's engine holds them."""
    st = j._qp_states[False]
    qp = {k: np.asarray(getattr(st, k))
          for k in ("x", "yA", "yB", "zA", "zB", "rho_scale")}
    qp["F"] = np.asarray(st.L)
    return ({"W": np.asarray(j.W), "xbar": np.asarray(j.xbar),
             "qp_state": qp},
            {k: np.array(getattr(j, k)) for k in
             ("columns", "_a", "_xn_t")})


def test_sdm_pass_from_carried_jax_state_matches():
    """Both packages run one SDM pass on UC 3 x 6 from the JAX engine's
    state after one outer iteration (W, x̄, the prox-off warm state, the
    column pool, the weights and the QP iterate), with the slice's block
    options: the weights a, the QP nonants xn_t and Γ agree to 1e-8
    (relative to the largest entry) and the local bound to 1e-6
    relative."""
    jb = jax_build_batch(jax_uc.scenario_creator, jax_uc.make_tree(3),
                         creator_kwargs=_UC_KW,
                         vector_patch=jax_uc.scenario_vector_patch)
    pb = build_batch(uc.scenario_creator, uc.make_tree(3),
                     creator_kwargs=_UC_KW,
                     vector_patch=uc.scenario_vector_patch)
    j = JaxFWPH(jb, dict(_UC_OPTS), dtype=jnp.float64)
    j.fwph_main(finalize=False)
    arrays, pool = _carry(j)
    p = FWPH(pb, dict(_UC_OPTS), device="cpu")
    from_numpy_state(p, arrays, prox_on=False)
    p.xsqbar = torch.as_tensor(np.array(j.xsqbar))
    for k, v in pool.items():
        setattr(p, k, torch.as_tensor(v))
    p._col_ptr = j._col_ptr
    p._local_bound = j._local_bound
    # the pass's first linearized solve satisfies E[w] = 0
    w_t = p.W + p.rho * (p._xn_t - p.xbar)
    assert float((p.prob @ w_t).abs().max()) \
        <= 1e-9 * max(1.0, float(w_t.abs().max()))
    xj, gj = j.SDM()
    xp, gp = p.SDM()
    assert p._kernel_plans[False].backend == "cuda"
    scale = max(1.0, float(np.abs(np.asarray(xj)).max()))
    np.testing.assert_allclose(xp.numpy(), np.asarray(xj), rtol=0,
                               atol=1e-8 * scale)
    np.testing.assert_allclose(p._a.numpy(), np.asarray(j._a), rtol=0,
                               atol=1e-8)
    assert gp == pytest.approx(gj, rel=0, abs=1e-8 * max(1.0, abs(gj)))
    assert p._local_bound == pytest.approx(j._local_bound, rel=1e-6)
    assert p._col_ptr == j._col_ptr
    a = p._a.numpy()
    assert np.allclose(a.sum(axis=1), 1.0, atol=1e-9) and (a >= -1e-12).all()


# ---- tests/test_fwph.py ----

def test_fwph_bound_improves_on_trivial():
    fw = FWPH(_farmer(), {"defaultPHrho": 10.0, "PHIterLimit": 30,
                          "convthresh": -1.0, "FW_iter_limit": 2},
              device="cpu")
    conv, bound, tbound = fw.fwph_main()
    # the dual bound stays a valid outer bound and improves on
    # wait-and-see
    assert bound <= EF_OBJ + 1.0
    assert bound > tbound - 1.0
    assert bound - tbound > 100.0  # material improvement over 30 iters


def test_fwph_as_spoke():
    batch = _farmer()
    opts = {"defaultPHrho": 10.0, "PHIterLimit": 60, "convthresh": -1.0}
    hub_dict = {
        "hub_class": PHHub,
        "hub_kwargs": {"options": {"rel_gap": 1e-3}},
        "opt_class": PH,
        "opt_kwargs": {"batch": batch, "options": opts, "device": "cpu"},
    }
    spoke_dicts = [
        {"spoke_class": FrankWolfeOuterBound, "opt_class": FWPH,
         "opt_kwargs": {"batch": batch,
                        "options": dict(opts, FW_iter_limit=2),
                        "device": "cpu"}},
    ]
    wheel = spin_the_wheel(hub_dict, spoke_dicts)
    assert wheel.best_outer_bound <= EF_OBJ + 1.0
    assert np.isfinite(wheel.best_outer_bound)


def test_fwph_refuses_multistage():
    from mpisppy_tpu_torch.models import hydro
    batch = build_batch(hydro.scenario_creator, hydro.make_tree())
    with pytest.raises(ValueError, match="two-stage only"):
        FWPH(batch, {}, device="cpu")


def test_fwph_spoke_as_a_process():
    """The FWPH spoke as a child process through the port's launcher
    (utils/multiproc), a PH hub in this process: the hub consumes the
    spoke's bounds and its outer bound lies below the EF optimum."""
    from mpisppy_tpu_torch.utils.config import (AlgoConfig, RunConfig,
                                                SpokeConfig)
    from mpisppy_tpu_torch.utils.multiproc import spin_the_wheel_processes
    cfg = RunConfig(
        model="farmer", num_scens=3,
        algo=AlgoConfig(default_rho=10.0, max_iterations=200,
                        convthresh=-1.0, subproblem_max_iter=4000),
        spokes=[SpokeConfig(kind="fwph", options={"FW_iter_limit": 2})],
        rel_gap=0.05, wheel_deadline=60.0, device="cpu")
    hub = spin_the_wheel_processes(cfg, join_timeout=120.0)
    assert hub._spoke_last_ids[0] > 1, "no FWPH bound consumed"
    assert np.isfinite(hub.BestOuterBound)
    assert hub.BestOuterBound <= EF_OBJ + 1.0
