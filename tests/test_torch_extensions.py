"""The port's extensions (mpisppy_tpu_torch extensions/) against their
JAX twins on the same engine run: both packages run PH on UC 3 x 6 with
the slice's fixed-rho block options (where their PH trajectories agree
to 1e-8, tests/test_torch_ph.py), one engine with the JAX extension and
one with the port's, and what each extension decides or records is
compared: the fixed slots and values (Fixer, two-stage and multistage),
the eps schedule (Gapper), the rho sequence (NormRhoUpdater), the
chosen scenario and its value (XhatClosest), the dumped objectives and
the min/avg/max rows (Diagnoser, MinMaxAvg). Farmer runs with adaptive
rho, whose trace roundoff drives apart in the two packages (ROADMAP.md
C.1), so the cases of tests/test_extensions.py run on the port alone at
that file's bars. The names that belong to later slices raise on
import."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest

import mpisppy_tpu.extensions as jax_ext
from mpisppy_tpu.core.ph import PH as JaxPH
from mpisppy_tpu.ir.batch import build_batch as jax_build_batch
from mpisppy_tpu.models import hydro as jax_hydro
from mpisppy_tpu.models import uc as jax_uc
import mpisppy_tpu_torch.extensions as ext
from mpisppy_tpu_torch.core.ef import ExtensiveForm
from mpisppy_tpu_torch.core.ph import PH
from mpisppy_tpu_torch.ir.batch import build_batch
from mpisppy_tpu_torch.models import farmer, hydro, uc
from mpisppy_tpu_torch.utils.runtime import to_host
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

_UC_KW = {"num_gens": 3, "num_hours": 6}
# the slice's options at this size: the hand-written block's backend
# (its plain version on the CPU), the whole budget at fixed rho
_UC_OPTS = {"defaultPHrho": 100.0, "convthresh": -1.0,
            "subproblem_kernel_mode": "fused",
            "subproblem_kernel_backend": "pallas",
            "subproblem_max_iter": 400, "subproblem_polish_hot": False,
            "subproblem_polish_chunk": 2}
# tests/test_extensions.py's make_ph options (farmer)
_FARMER_OPTS = {"defaultPHrho": 1.0, "convthresh": 1e-7,
                "subproblem_max_iter": 2000, "subproblem_eps": 1e-7}


def _pair(iters, jax_exts, port_exts):
    """(JAX engine, port engine) after ph_main on UC 3 x 6 with the
    slice's block options, each with its own package's extensions."""
    opts = dict(_UC_OPTS, PHIterLimit=iters)
    j = JaxPH(jax_build_batch(jax_uc.scenario_creator, jax_uc.make_tree(3),
                              creator_kwargs=_UC_KW,
                              vector_patch=jax_uc.scenario_vector_patch),
              dict(opts), dtype=jnp.float64,
              extensions=jax_ext.MultiExtension(jax_exts))
    j.ph_main()
    p = PH(build_batch(uc.scenario_creator, uc.make_tree(3),
                       creator_kwargs=_UC_KW,
                       vector_patch=uc.scenario_vector_patch), dict(opts),
           extensions=ext.MultiExtension(port_exts), device="cpu")
    p.ph_main()
    return j, p


def make_ph(iters=5, extensions=None, **over):
    """tests/test_extensions.py's make_ph on the port: farmer(3)."""
    return PH(build_batch(farmer.scenario_creator, farmer.make_tree(3)),
              dict(_FARMER_OPTS, PHIterLimit=iters, **over),
              extensions=extensions, device="cpu")


def _recorder(base, field):
    """An extension of ``base``'s package that records ``field(opt)``
    at every miditer."""
    class Rec(base):
        def __init__(self):
            super().__init__()
            self.rows = []

        def miditer(self, opt):
            self.rows.append(field(opt))
    return Rec()


def test_fixer_fixes_the_same_slots():
    """The Fixer in both packages over UC 3 x 6 (every nonant slot
    eligible, parked-at-bound after 2 agreeing iterations, at the common
    value after 3): the same slots fixed at the same iterations, at
    values equal to 1e-8 relative, and the port's last solve respects
    its fixings."""
    from mpisppy_tpu.extensions.fixer import uniform_fix_list as jax_ufl
    from mpisppy_tpu_torch.extensions.fixer import uniform_fix_list
    spec = dict(tol=0.05, nb=3, lb=2, ub=2, integer_only=False)
    opts = {"boundtol": 1e-4}
    jf = jax_ext.Fixer(dict(opts, id_fix_list_fct=lambda b: jax_ufl(b,
                                                                  **spec)))
    pf = ext.Fixer(dict(opts, id_fix_list_fct=lambda b: uniform_fix_list(
        b, **spec)))
    jr = _recorder(jax_ext.Extension, lambda o: int(jf.nfixed))
    pr = _recorder(ext.Extension, lambda o: int(pf.nfixed))
    j, p = _pair(5, [jf, jr], [pf, pr])
    assert pf.nfixed > 0 and pr.rows == jr.rows
    np.testing.assert_array_equal(pf.fixed_mask, jf.fixed_mask)
    np.testing.assert_allclose(pf.fixed_vals, jf.fixed_vals, rtol=1e-8,
                               atol=1e-12)
    for name in ("conv_count", "lb_count", "ub_count"):
        np.testing.assert_array_equal(getattr(pf, name), getattr(jf, name))
    xn = to_host(p._hub_nonants())
    mask = pf.fixed_mask
    assert np.allclose(xn[mask], pf.fixed_vals[mask], atol=1e-2)


def test_fixer_multistage_fixes_per_scenario_values():
    """tests/test_extensions.py's multistage case on hydro in both
    packages: the same slots fixed, each scenario at its own node's
    value (equal to the JAX package's to 1e-6 relative)."""
    from mpisppy_tpu.extensions.fixer import uniform_fix_list as jax_ufl
    from mpisppy_tpu_torch.extensions.fixer import uniform_fix_list
    spec = dict(tol=1e10, nb=1, lb=None, ub=None, integer_only=False)
    opts = {"defaultPHrho": 1.0, "PHIterLimit": 2, "convthresh": -1.0,
            "subproblem_max_iter": 2000}
    jf = jax_ext.Fixer({"id_fix_list_fct": lambda b: jax_ufl(b, **spec)})
    JaxPH(jax_build_batch(jax_hydro.scenario_creator,
                          jax_hydro.make_tree()), dict(opts),
          dtype=jnp.float64, extensions=jf).ph_main(finalize=False)
    batch = build_batch(hydro.scenario_creator, hydro.make_tree())
    pf = ext.Fixer({"id_fix_list_fct": lambda b: uniform_fix_list(b,
                                                                  **spec)})
    ph = PH(batch, dict(opts), extensions=pf, device="cpu")
    ph.ph_main(finalize=False)
    assert pf.fixed_mask.any()
    np.testing.assert_array_equal(pf.fixed_mask, jf.fixed_mask)
    np.testing.assert_allclose(pf.fixed_vals, jf.fixed_vals, rtol=1e-6,
                               atol=1e-9)
    # stage-2 nonants belong to different nodes per scenario branch: the
    # fixed values reproduce each scenario's own xbar row
    xbar = to_host(ph.xbar)
    k2 = batch.stage_slot_slices[1]
    fixed2 = pf.fixed_mask[0, k2]
    if fixed2.any():
        vals = pf.fixed_vals[:, k2][:, fixed2]
        assert not np.allclose(vals, vals[0:1, :], atol=1e-9) or \
            np.allclose(xbar[:, k2][:, fixed2], xbar[0:1, k2][:, fixed2])


def test_gapper_schedule_matches_jax():
    """The same eps at every iteration in both packages, the last
    scheduled one in force at the end, and the runs' expected objectives
    equal to 1e-8 relative."""
    sched = {"mipgapdict": {0: 1e-3, 2: 1e-6}}
    jr = _recorder(jax_ext.Extension, lambda o: o.sub_eps)
    pr = _recorder(ext.Extension, lambda o: o.sub_eps)
    j, p = _pair(3, [jax_ext.Gapper(sched), jr], [ext.Gapper(sched), pr])
    assert pr.rows == jr.rows == [1e-3, 1e-6, 1e-6]
    assert p.sub_eps == j.sub_eps == 1e-6
    assert p.Eobjective_value() == pytest.approx(j.Eobjective_value(),
                                                 rel=1e-8)


def test_norm_rho_updater_matches_jax():
    """The rho updater (primal/dual mult 0.5, factor 1.5) in both
    packages: the same rho after every iteration (1e-12 relative, so the
    same multiply/divide decisions), rho moved at least once, and the
    residual histories at 1e-6 relative."""
    upd = {"primal_dual_mult": 0.5, "rho_update_factor": 1.5}
    jr = _recorder(jax_ext.Extension, lambda o: np.array(o.rho))
    pr = _recorder(ext.Extension, lambda o: to_host(o.rho))
    ju, pu = jax_ext.NormRhoUpdater(upd), ext.NormRhoUpdater(upd)
    j, p = _pair(6, [ju, jr], [pu, pr])
    assert len(pu.prim_hist) == len(ju.prim_hist) > 0
    np.testing.assert_allclose(list(pu.prim_hist), list(ju.prim_hist),
                               rtol=1e-6)
    np.testing.assert_allclose(list(pu.dual_hist), list(ju.dual_hist),
                               rtol=1e-6)
    assert len(pr.rows) == len(jr.rows) == 6
    for a, b in zip(pr.rows, jr.rows):
        np.testing.assert_allclose(a, b, rtol=1e-12)
    assert len({float(r[0, 0]) for r in pr.rows}) > 1, "rho never moved"


def _closest_recorder(base):
    class Rec(base):
        def __init__(self):
            super().__init__()
            self.picks = []

        def try_closest(self, opt):
            s = int(np.argmin(self._distance(opt)))
            val = super().try_closest(opt)
            self.picks.append((s, val))
            return val
    return Rec()


def test_xhatclosest_matches_jax():
    """The same scenario chosen at every call and the same incumbent
    value (1e-6 relative), the same kept x̂ (UC's relaxed commitments
    are not rounded: 1e-8 relative)."""
    jx = _closest_recorder(jax_ext.XhatClosest)
    px = _closest_recorder(ext.XhatClosest)
    _pair(4, [jx], [px])
    assert len(px.picks) == len(jx.picks) == 5
    assert [s for s, _ in px.picks] == [s for s, _ in jx.picks]
    for (_, a), (_, b) in zip(px.picks, jx.picks):
        assert (a is None) == (b is None)
        if a is not None:
            assert a == pytest.approx(b, rel=1e-6)
    assert px.best_bound is not None
    assert px.best_bound == pytest.approx(jx.best_bound, rel=1e-6)
    np.testing.assert_allclose(px.best_xhat, jx.best_xhat, rtol=1e-8,
                               atol=1e-9)


def test_diagnoser_and_minmaxavg_match_jax(tmp_path):
    """The dumped (iter, scenario, objective) rows and the MinMaxAvg
    history of the dispatch ``p`` equal the JAX package's (values at
    1e-8 relative); the CSV has the JAX file's header and length."""
    jd = jax_ext.Diagnoser({"diagnoser_outdir": str(tmp_path / "jax")})
    pd = ext.Diagnoser({"diagnoser_outdir": str(tmp_path / "port")})
    jm = jax_ext.MinMaxAvg({"avgminmax_name": "p"})
    pm = ext.MinMaxAvg({"avgminmax_name": "p"})
    _pair(2, [jd, jm], [pd, pm])
    assert [r[:2] for r in pd.rows] == [r[:2] for r in jd.rows]
    np.testing.assert_allclose([r[2] for r in pd.rows],
                               [r[2] for r in jd.rows], rtol=1e-8)
    lines = (tmp_path / "port" / "diagnoser.csv").read_text().strip() \
        .splitlines()
    assert lines[0] == "iter,scenario,objective" and len(lines) > 3
    assert len(lines) == len((tmp_path / "jax" / "diagnoser.csv")
                             .read_text().strip().splitlines())
    assert len(pm.history) == len(jm.history) >= 2
    for a, b in zip(pm.history, jm.history):
        assert a[0] == b[0]
        np.testing.assert_allclose(a[1:], b[1:], rtol=1e-8)


# ---- tests/test_extensions.py's cases, on the port ----

def test_fixer_fixes_converged_nonants():
    # farmer's nonants oscillate with variance O(1) near convergence, so
    # a loose value tolerance is needed to see fixing in a short run
    from mpisppy_tpu_torch.extensions.fixer import uniform_fix_list
    fixer = ext.Fixer({"id_fix_list_fct":
                       lambda b: uniform_fix_list(b, tol=3.0, nb=2, lb=2,
                                                  ub=2, integer_only=False),
                       "boundtol": 1e-4})
    ph = make_ph(iters=18, extensions=fixer, defaultPHrho=2.0)
    ph.ph_main()
    # farmer converges fast at rho=2; slots must have been fixed and the
    # fixed values must be respected by the final solve
    assert fixer.nfixed > 0
    xn = to_host(ph._hub_nonants())
    mask = fixer.fixed_mask
    assert np.allclose(xn[mask], fixer.fixed_vals[mask], atol=1e-2)


def test_gapper_schedule_applies():
    g = ext.Gapper({"mipgapdict": {0: 1e-3, 2: 1e-6}})
    ph = make_ph(iters=3, extensions=g)
    ph.ph_main()
    assert ph.sub_eps == 1e-6


def test_norm_rho_updater_runs_and_keeps_convergence():
    upd = ext.NormRhoUpdater({"primal_dual_mult": 0.5,
                              "rho_update_factor": 1.5})
    ph = make_ph(iters=8, extensions=upd)
    conv, eobj, tbound = ph.ph_main()
    assert len(upd.prim_hist) > 0
    assert np.isfinite(eobj)
    # rho stayed positive and factors usable
    assert float(to_host(ph.rho).min()) > 0


def test_xhatclosest_produces_valid_inner_bound():
    xc = ext.XhatClosest()
    ph = make_ph(iters=5, extensions=xc)
    ph.ph_main()
    assert xc.best_bound is not None
    # inner bound (feasible objective) >= EF optimum for a min problem
    batch = build_batch(farmer.scenario_creator, farmer.make_tree(3))
    ef = ExtensiveForm(batch, {"subproblem_max_iter": 8000,
                               "subproblem_eps": 1e-8}, device="cpu")
    ef_obj, _ = ef.solve_extensive_form()
    assert xc.best_bound >= ef_obj - 1e-2 * abs(ef_obj)


def test_diagnoser_and_minmaxavg(tmp_path):
    d = ext.Diagnoser({"diagnoser_outdir": str(tmp_path)})
    mm = ext.MinMaxAvg({"avgminmax_name": "DevotedAcreage"})
    ph = make_ph(iters=2, extensions=ext.MultiExtension([d, mm]))
    ph.ph_main()
    out = tmp_path / "diagnoser.csv"
    assert out.exists()
    lines = out.read_text().strip().splitlines()
    assert lines[0] == "iter,scenario,objective"
    assert len(lines) > 3
    assert len(mm.history) >= 2


# ROADMAP.md items whose names the port now has
_LANDED_ITEMS = {"A9"}


@pytest.mark.parametrize("module,name,item", [
    ("mpisppy_tpu_torch.extensions.fixer", "DeviceFixer", "A9"),
    ("mpisppy_tpu_torch.extensions.norm_rho_updater",
     "DeviceNormRhoUpdater", "A9"),
    ("mpisppy_tpu_torch.extensions", "DeviceFixer", "A9"),
    ("mpisppy_tpu_torch.extensions", "DeviceNormRhoUpdater", "A9"),
    ("mpisppy_tpu_torch.extensions", "WXBarWriter", "A14"),
    ("mpisppy_tpu_torch.extensions", "WXBarReader", "A14"),
])
def test_unported_extensions_raise_on_import(module, name, item):
    """A name of a slice still to come raises on import, naming its
    ROADMAP.md item; a name whose item has landed (A9, the shrinking
    slice) imports as an Extension."""
    mod = importlib.import_module(module)
    if item in _LANDED_ITEMS:
        ns = {}
        exec(f"from {module} import {name}", ns)
        assert issubclass(ns[name], ext.Extension)
    else:
        with pytest.raises(NotImplementedError,
                           match=f"ROADMAP.md {item}"):
            exec(f"from {module} import {name}", {})
    with pytest.raises(AttributeError):
        getattr(mod, "NoSuchName")
