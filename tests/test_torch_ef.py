"""The port's extensive form (mpisppy_tpu_torch core/ef.py) against the
JAX package's ExtensiveForm on the same batches, against the
independent host HiGHS LP of tests/test_models.py, and as a MIP; the
EF-MIP spoke (cylinders/ef_bounder.py) in a wheel and as a process."""

import math

import jax.numpy as jnp
import numpy as np
import pytest

from mpisppy_tpu.core.ef import ExtensiveForm as JaxEF
from mpisppy_tpu.ir.batch import build_batch as jax_build_batch
from mpisppy_tpu.models import farmer as jax_farmer
from mpisppy_tpu.models import sizes as jax_sizes
from mpisppy_tpu_torch.core.ef import ExtensiveForm
from mpisppy_tpu_torch.core.ph import PH, PHBase
from mpisppy_tpu_torch.ir.batch import build_batch
from mpisppy_tpu_torch.models import battery, farmer, hydro, netdes, sizes, \
    sslp, uc
from test_models import ef_linprog
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

EF_OBJ = -108390.0


def round_pos_sig(x, sig=2):
    """ref. mpisppy/tests/test_ef_ph.py round_pos_sig."""
    return round(x, -int(math.floor(math.log10(abs(x)))) + (sig - 1))


@pytest.mark.parametrize("S", [3, 30])
def test_farmer_ef_matches_jax(S):
    """tests/test_farmer_ef.py on the port, with the objective and
    x_batch held against the JAX engine's on the same batch at that
    test's bars (objective rel 2e-4, acreage abs 0.5)."""
    jb = jax_build_batch(jax_farmer.scenario_creator,
                         jax_farmer.make_tree(S))
    batch = build_batch(farmer.scenario_creator, farmer.make_tree(S))
    j_obj, j_x = JaxEF(jb, dtype=jnp.float64).solve_extensive_form()
    ef = ExtensiveForm(batch, device="cpu")
    obj, x_batch = ef.solve_extensive_form()
    assert obj == pytest.approx(j_obj, rel=2e-4)
    np.testing.assert_allclose(x_batch, np.asarray(j_x), atol=0.5)
    assert ef.get_objective_value() == pytest.approx(obj, rel=1e-12)
    nons = x_batch[:, batch.nonant_idx]
    assert np.allclose(nons, nons[0], atol=1e-9)
    assert ef.ef_data.A.device.type == "cpu"
    if S == 3:
        assert obj == pytest.approx(EF_OBJ, rel=2e-4)
        assert ef.get_root_solution() == pytest.approx([170.0, 80.0, 250.0],
                                                       abs=0.5)
    else:
        assert -140000 < obj < -90000


def _sizes(mod=sizes, bb=build_batch):
    return bb(mod.scenario_creator, mod.make_tree(3),
              creator_kwargs={"scenario_count": 3})


CASES = [
    ("sizes", _sizes),
    ("sslp", lambda: build_batch(sslp.scenario_creator, sslp.make_tree(4),
                                 creator_kwargs={"num_servers": 3,
                                                 "num_clients": 8})),
    ("netdes", lambda: build_batch(netdes.scenario_creator,
                                   netdes.make_tree(4),
                                   creator_kwargs={"num_nodes": 5})),
    ("battery", lambda: build_batch(battery.scenario_creator,
                                    battery.make_tree(3),
                                    creator_kwargs={"T": 12})),
]


@pytest.mark.parametrize("name,mk", CASES, ids=[c[0] for c in CASES])
def test_ef_matches_scipy(name, mk):
    """tests/test_models.py::test_ef_matches_scipy on the port: the EF
    against the independent HiGHS LP, at that test's band."""
    batch = mk()
    want = ef_linprog(batch)
    got, _ = ExtensiveForm(batch, {"subproblem_max_iter": 60000,
                                   "subproblem_eps": 1e-9},
                           device="cpu").solve_extensive_form()
    assert got == pytest.approx(want, rel=2e-3, abs=2e-2), \
        f"{name}: ADMM EF {got} vs HiGHS {want}"


@pytest.mark.parametrize("name,mk", CASES, ids=[c[0] for c in CASES])
def test_ph_bound_sandwich(name, mk):
    """tests/test_models.py::test_ph_bound_sandwich on the port: the
    trivial bound is a certified outer bound on the EF LP."""
    batch = mk()
    ef_obj = ef_linprog(batch)
    ph = PH(batch, {"defaultPHrho": 5.0, "PHIterLimit": 30,
                    "convthresh": 1e-6, "subproblem_max_iter": 4000},
            device="cpu")
    _, _, trivial = ph.ph_main()
    assert trivial <= ef_obj + 1e-2 * max(1.0, abs(ef_obj))


def test_sslp_feasibility_invariant():
    """Each present client is assigned at the EF optimum."""
    batch = CASES[1][1]()
    _, x_batch = ExtensiveForm(batch, device="cpu").solve_extensive_form()
    vals = {name: x_batch[:, sl]
            for name, sl in batch.template.var_slices.items()}
    for s in range(4):
        h = sslp.client_presence(s, 8)
        assign = vals["Assign"][s].reshape(3, 8)
        assert np.allclose(assign.sum(axis=0), h, atol=1e-4)


def test_battery_flow_balance_at_opt():
    batch = CASES[3][1]()
    _, x_batch = ExtensiveForm(batch, device="cpu").solve_extensive_form()
    vals = {name: x_batch[:, sl]
            for name, sl in batch.template.var_slices.items()}
    eff = battery.DEFAULTS["eff"]
    for s in range(3):
        x, p, q = (vals["StateOfCharge"][s], vals["Charge"][s],
                   vals["Discharge"][s])
        resid = x[1:] - x[:-1] - eff * p[:-1] + q[:-1] / eff
        assert np.max(np.abs(resid)) < 1e-3


def test_hydro_multistage_ef():
    """tests/test_hydro.py::test_hydro_ef on the port (three stages:
    stage-2 nonants shared within each stage-2 node), equal to the JAX
    engine's objective at that test's 2-digit bar and at 1e-6."""
    from mpisppy_tpu.models import hydro as jax_hydro
    batch = build_batch(hydro.scenario_creator, hydro.make_tree((3, 3)))
    ef = ExtensiveForm(batch, device="cpu")
    obj, x_batch = ef.solve_extensive_form()
    j_obj, _ = JaxEF(jax_build_batch(jax_hydro.scenario_creator,
                                     jax_hydro.make_tree((3, 3))),
                     dtype=jnp.float64).solve_extensive_form()
    assert round_pos_sig(obj) == 190.0
    assert obj == pytest.approx(j_obj, rel=1e-6)
    xn = x_batch[:, batch.nonant_idx]
    s2 = batch.stage_slot_slices[1]
    for g in range(3):
        grp = xn[3 * g:3 * g + 3, s2]
        assert np.allclose(grp, grp[0], atol=1e-9)


def test_ef_tensors_equal_jax():
    """The column map and the EF tensors equal the JAX engine's."""
    jef = JaxEF(_sizes(jax_sizes, jax_build_batch), dtype=jnp.float64)
    ef = ExtensiveForm(_sizes(), device="cpu")
    assert ef.n_ef == jef.n_ef
    np.testing.assert_array_equal(ef.colmap, jef.colmap)
    for fld in ef.ef_data._fields:
        np.testing.assert_array_equal(getattr(ef.ef_data, fld).numpy(),
                                      np.asarray(getattr(jef.ef_data, fld)),
                                      err_msg=fld)
    np.testing.assert_array_equal(ef.c_ef.numpy(), np.asarray(jef.c_ef))
    assert ef.c0_ef == jef.c0_ef


def test_sizes_integer_ef_matches_jax():
    """sizes(3) as a MIP through milp_solve (host HiGHS) at mip_gap 5e-2:
    the same EF reaches HiGHS in both packages, so the B&B returns the
    same incumbent; it lies within the gap above the JAX reference's
    sizes value (tests/test_mip.py:32, 220000 to 2 digits)."""
    kw = dict(integer=True, time_limit=60.0, mip_gap=5e-2)
    j_obj, _ = JaxEF(_sizes(jax_sizes, jax_build_batch),
                     dtype=jnp.float64).solve_extensive_form(**kw)
    obj, x_batch = ExtensiveForm(_sizes(), device="cpu") \
        .solve_extensive_form(**kw)
    assert obj == pytest.approx(j_obj, rel=1e-9)
    assert 215000 <= obj <= 225000 * (1 + 5e-2)
    ints = np.asarray(_sizes().integer)
    assert np.allclose(x_batch[:, ints], np.round(x_batch[:, ints]))


@pytest.mark.slow
def test_sizes3_integer_ef_matches_reference():
    """tests/test_mip.py::test_sizes3_integer_ef_matches_reference on the
    port: the EF MIP objective is 220000 to 2 significant digits."""
    obj, _ = ExtensiveForm(_sizes(), device="cpu").solve_extensive_form(
        integer=True, time_limit=45.0)
    assert round_pos_sig(obj, 2) == 220000


def test_ef_needs_a_card_or_cpu(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ExtensiveForm(_sizes())


# ---- the EF-MIP spoke ----

def _uc_batch(S=3, G=3, T=6):
    return build_batch(uc.scenario_creator, uc.make_tree(S),
                       creator_kwargs={"num_gens": G, "num_hours": T,
                                       "relax_integrality": False})


def _efmip_wheel(opts, rel_gap, spokes_extra=()):
    from mpisppy_tpu_torch.cylinders.ef_bounder import EFMipBound
    from mpisppy_tpu_torch.cylinders.hub import PHHub
    from mpisppy_tpu_torch.utils.sputils import spin_the_wheel
    batch = _uc_batch()
    hub_dict = {"hub_class": PHHub,
                "hub_kwargs": {"options": {"rel_gap": rel_gap}},
                "opt_class": PH,
                "opt_kwargs": {"batch": batch, "options": opts,
                               "device": "cpu"}}
    spoke_dicts = list(spokes_extra) + [
        {"spoke_class": EFMipBound, "opt_class": PHBase,
         "opt_kwargs": {"batch": batch, "device": "cpu", "options": {
             **opts, "efmip_time_limit": 60.0, "efmip_gap": 1e-5}}}]
    return spin_the_wheel(hub_dict, spoke_dicts), batch


def test_efmip_spoke_closes_gap_on_integer_uc():
    """The EF-MIP spoke alone beside a PH hub on a small integer UC: its
    one B&B publishes both sides, the hub closes to the B&B gap and
    keeps the spoke's integer first stage; both bounds bracket the
    port's own integer EF objective."""
    opts = {"defaultPHrho": 50.0, "PHIterLimit": 500, "convthresh": -1.0,
            "subproblem_max_iter": 1500, "subproblem_eps": 1e-7}
    wheel, batch = _efmip_wheel(opts, 1e-4)
    ef_obj, _ = ExtensiveForm(_uc_batch(), device="cpu") \
        .solve_extensive_form(integer=True, time_limit=60.0, mip_gap=1e-6)
    _, rel_gap = wheel.gap()
    assert rel_gap < 1e-4
    assert wheel.best_outer_bound <= wheel.best_inner_bound + 1e-9
    assert wheel.best_outer_bound <= ef_obj + 1e-6 * abs(ef_obj)
    assert wheel.best_inner_bound >= ef_obj - 1e-6 * abs(ef_obj)
    xhat = wheel.best_xhat()
    assert xhat is not None and xhat.shape[-1] == batch.K
    ints = np.asarray(batch.integer)[np.asarray(batch.nonant_idx)]
    assert np.allclose(xhat[..., ints], np.round(xhat[..., ints]))


@pytest.mark.slow
def test_efmip_spoke_wheel_closes_gap():
    """tests/test_host_oracle.py::test_efmip_spoke_wheel_closes_gap on
    the port: the EF-MIP spoke with the warm-started MIP-oracle
    Lagrangian spoke closes the gap to ~the oracle mip_gap."""
    from mpisppy_tpu_torch.cylinders.lagrangian_bounder import \
        LagrangianOuterBound
    opts = {"defaultPHrho": 50.0, "PHIterLimit": 500, "convthresh": -1.0,
            "subproblem_max_iter": 1500, "subproblem_eps": 1e-7}
    lag = {"spoke_class": LagrangianOuterBound, "opt_class": PHBase,
           "opt_kwargs": {"batch": _uc_batch(), "device": "cpu",
                          "options": {**opts,
                                      "lagrangian_exact_oracle": True,
                                      "lagrangian_mip_oracle": True,
                                      "lagrangian_mip_time_limit": 20.0,
                                      "lagrangian_mip_gap": 1e-5,
                                      "lagrangian_oracle_workers": 0}}}
    wheel, batch = _efmip_wheel(opts, 5e-5, [lag])
    _, rel_gap = wheel.gap()
    assert rel_gap < 1e-4
    assert wheel.best_outer_bound <= wheel.best_inner_bound + 1e-9
    xhat = wheel.best_xhat()
    assert xhat is not None and xhat.shape[-1] == batch.K


def _efmip_process_wheel():
    """tests/test_multiproc.py::test_efmip_process_wheel's wheel: the
    dual-typed EF-MIP spoke as a child process."""
    from mpisppy_tpu_torch.utils.config import (AlgoConfig, RunConfig,
                                                SpokeConfig)
    from mpisppy_tpu_torch.utils.multiproc import spin_the_wheel_processes
    cfg = RunConfig(
        model="uc", num_scens=3,
        model_kwargs={"num_gens": 3, "num_hours": 6,
                      "relax_integrality": False},
        algo=AlgoConfig(default_rho=50.0, max_iterations=4000,
                        convthresh=-1.0, subproblem_max_iter=1500,
                        subproblem_eps=1e-7),
        spokes=[SpokeConfig(kind="efmip",
                            options={"efmip_time_limit": 60.0,
                                     "efmip_gap": 1e-5})],
        rel_gap=1e-4, device="cpu")
    return spin_the_wheel_processes(cfg, join_timeout=180.0)


def test_efmip_process_wheel():
    """The EF-MIP spoke's 2-value window is sized alike on both sides
    (from the class's payload_length) and the hub consumes both bound
    sides from it; the B&B at gap 1e-5 certifies a tight sandwich."""
    hub = _efmip_process_wheel()
    assert hub._spoke_last_ids[0] > 1, "no EF bound payload consumed"
    assert np.isfinite(hub.BestOuterBound)
    assert np.isfinite(hub.BestInnerBound)
    assert hub.BestOuterBound <= hub.BestInnerBound + 1e-6
    rel = (hub.BestInnerBound - hub.BestOuterBound) / abs(hub.BestInnerBound)
    assert rel < 1e-3
