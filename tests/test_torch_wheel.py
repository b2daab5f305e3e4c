"""The port's hub-and-spoke wheel and its CLI (mpisppy_tpu_torch
cylinders/, utils/{sputils,vanilla,config,synchronizer}, __main__):
the Lagrangian device bound against the JAX spoke's at one W, the
farmer wheel and the CLI sandwiching the EF optimum, the refusals of
what is not ported, and the cases of the JAX package's protocol,
config and synchronizer tests run against the port's copies."""

import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest

from mpisppy_tpu.core.ph import PH as JaxPH, PHBase as JaxPHBase
from mpisppy_tpu.cylinders.lagrangian_bounder import \
    LagrangianOuterBound as JaxLagrangian
from mpisppy_tpu.ir.batch import build_batch as jax_build_batch
from mpisppy_tpu.models import uc as jax_uc
from mpisppy_tpu_torch.__main__ import config_from_args, main, make_parser
from mpisppy_tpu_torch.core.ph import PH, PHBase
from mpisppy_tpu_torch.cylinders.hub import CrossScenarioHub, PHHub
from mpisppy_tpu_torch.cylinders.lagrangian_bounder import \
    LagrangianOuterBound
from mpisppy_tpu_torch.cylinders.spcommunicator import Window
from mpisppy_tpu_torch.cylinders.spoke import ConvergerSpokeType, Spoke
from mpisppy_tpu_torch.cylinders.xhat_bounders import (XhatLooperInnerBound,
                                                       XhatShuffleInnerBound)
from mpisppy_tpu_torch.ir.batch import build_batch
from mpisppy_tpu_torch.models import farmer, uc
from mpisppy_tpu_torch.utils.config import (KNOWN_SPOKES, AlgoConfig,
                                            RunConfig, SpokeConfig,
                                            config_from_dict)
from mpisppy_tpu_torch.utils.sputils import spin_the_wheel
from mpisppy_tpu_torch.utils.synchronizer import Synchronizer
from mpisppy_tpu_torch.utils.vanilla import hub_dict, spoke_dict, wheel_dicts
from torch_threads import one_torch_thread  # noqa: F401

EF_OBJ = -108390.0
_UC_KW = {"num_gens": 3, "num_hours": 6}
# the slice's options at this size: the hand-written block's backend
# (its plain version on the CPU), the whole budget at fixed rho
_UC_OPTS = {"defaultPHrho": 100.0, "PHIterLimit": 2,
            "subproblem_kernel_mode": "fused",
            "subproblem_kernel_backend": "pallas",
            "subproblem_max_iter": 400, "subproblem_polish_hot": False,
            "subproblem_polish_chunk": 2}


def _farmer(num_scens=3):
    return build_batch(farmer.scenario_creator, farmer.make_tree(num_scens))


def _opts(**kw):
    o = {"defaultPHrho": 10.0, "PHIterLimit": 25, "convthresh": -1.0,
         "subproblem_max_iter": 4000}
    o.update(kw)
    return o


# ---- the Lagrangian device bound ----

def _uc_pair():
    return (jax_build_batch(jax_uc.scenario_creator, jax_uc.make_tree(3),
                            creator_kwargs=_UC_KW,
                            vector_patch=jax_uc.scenario_vector_patch),
            build_batch(uc.scenario_creator, uc.make_tree(3),
                        creator_kwargs=_UC_KW,
                        vector_patch=uc.scenario_vector_patch))


def test_lagrangian_device_bound_matches_jax():
    """At one W from a JAX hub run (two PH iterations on UC 3 x 6 with
    the block's backend, whose plain version runs here), the port's
    spoke bound equals the JAX spoke's.

    - The engine's own dual certificate (host certification off) at
      1e-6 relative, ROADMAP.md C.1's bar for certified bounds after
      the polish.
    - The device-dual mode's host-certified bound (duals moved to the
      host in f32, repaired, certified in f64) as closely as the JAX
      package reproduces it itself: its two mathematically equal
      polish layouts (polish_chunk 1 and 2) give certified bounds
      1.9e-5 apart, since the f32 transfer turns 1e-7 dual differences
      into ulp flips that the certificate's reduced-cost terms amplify
      (ROADMAP.md C.1)."""
    bj, bp = _uc_pair()
    hub = JaxPH(bj, dict(_UC_OPTS), dtype=jnp.float64)
    hub.ph_main()
    W = np.asarray(hub.W)

    def jax_spoke(**kw):
        opts = {**_UC_OPTS, "lagrangian_device_duals": True, **kw}
        return JaxLagrangian(JaxPHBase(bj, dict(opts), dtype=jnp.float64))

    def spokes(**kw):
        opts = {**_UC_OPTS, "lagrangian_device_duals": True, **kw}
        return (jax_spoke(**kw),
                LagrangianOuterBound(PHBase(bp, dict(opts), device="cpu")))

    sj, sp = spokes(lagrangian_certify_host=False)
    Wj, Wp = sj._project_W(W), sp._project_W(W)
    np.testing.assert_allclose(Wp, Wj, rtol=0, atol=1e-12)
    dev_j, dev_p = sj._device_bound(Wj), sp._device_bound(Wp)
    assert dev_p == pytest.approx(dev_j, rel=1e-6)
    assert sp.opt._kernel_plans[False].backend == "cuda"
    sj, sp = spokes()
    cert_j, cert_p = sj._device_bound(Wj), sp._device_bound(Wp)
    drift = abs(jax_spoke(subproblem_polish_chunk=1)._device_bound(Wj)
                - cert_j)
    assert abs(cert_p - cert_j) <= max(1e-6 * abs(cert_j), 2.0 * drift)


def test_engines_share_the_batch_device_cache():
    """Engines over one shared-structure batch hold ONE copy of the
    shipped constraint matrix and bound vectors (core/spbase)."""
    _, bp = _uc_pair()
    a, b = (PHBase(bp, dict(_UC_OPTS), device="cpu") for _ in range(2))
    for f in ("A", "l", "u", "lb", "ub"):
        assert getattr(a.qp_data, f) is getattr(b.qp_data, f)
    assert PHBase(_uc_pair()[1], dict(_UC_OPTS),
                  device="cpu").qp_data.A is not a.qp_data.A


# ---- the farmer wheel and the CLI ----

def test_ph_hub_with_lagrangian_and_xhat():
    """The twin of the JAX package's farmer wheel (same options and
    asserts): the certified outer bound and the incumbent sandwich the
    EF optimum."""
    batch = _farmer()
    hub_d = {
        "hub_class": PHHub,
        "hub_kwargs": {"options": {"rel_gap": 2e-3}},
        "opt_class": PH,
        "opt_kwargs": {"batch": batch, "options": _opts(PHIterLimit=200),
                       "device": "cpu"},
    }
    spoke_ds = [
        {"spoke_class": LagrangianOuterBound, "opt_class": PHBase,
         "opt_kwargs": {"batch": batch, "options": _opts(),
                        "device": "cpu"}},
        {"spoke_class": XhatShuffleInnerBound, "opt_class": PHBase,
         "opt_kwargs": {"batch": batch, "options": _opts(),
                        "device": "cpu"}},
    ]
    wheel = spin_the_wheel(hub_d, spoke_ds)
    assert wheel.best_outer_bound <= EF_OBJ + 1.0
    assert wheel.best_inner_bound >= EF_OBJ - 1.0
    assert np.isfinite(wheel.best_outer_bound)
    assert np.isfinite(wheel.best_inner_bound)
    abs_gap, rel_gap = wheel.gap()
    assert rel_gap < 0.1
    xhat = wheel.best_xhat()
    assert xhat is not None and xhat.shape[-1] == batch.K


def test_cli_farmer_wheel(capsys):
    """``python -m mpisppy_tpu_torch farmer ... --device cpu``: the same
    sandwich, printed as the last line."""
    assert main(["farmer", "--num-scens", "3", "--default-rho", "10",
                 "--max-iterations", "8", "--convthresh", "-1",
                 "--subproblem-max-iter", "4000", "--with-lagrangian",
                 "--with-xhatshuffle", "--device", "cpu"]) == 0
    import json
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert result["outer_bound"] <= EF_OBJ + 2.0
    assert result["inner_bound"] >= EF_OBJ - 2.0


def test_cli_without_a_card_raises(monkeypatch):
    """No card and no --device cpu: the wheel's engines raise instead of
    running on the CPU."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["farmer", "--num-scens", "3", "--with-lagrangian"])


def test_cli_aph_hub(capsys, monkeypatch):
    """``python -m mpisppy_tpu_torch farmer --hub aph --dispatch-frac 0.5
    --device cpu`` with the Lagrangian and x̂ spokes: finite bounds
    sandwiching the EF optimum within the JAX APH test's 1.0. Without
    --device cpu and without a card it raises."""
    import json
    assert main(["farmer", "--hub", "aph", "--dispatch-frac", "0.5",
                 "--num-scens", "3", "--default-rho", "10",
                 "--max-iterations", "10", "--convthresh", "-1",
                 "--subproblem-max-iter", "3000", "--with-lagrangian",
                 "--with-xhatshuffle", "--device", "cpu"]) == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert np.isfinite(result["outer_bound"])
    assert np.isfinite(result["inner_bound"])
    assert result["outer_bound"] <= EF_OBJ + 1.0
    assert result["inner_bound"] >= EF_OBJ - 1.0
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["farmer", "--hub", "aph", "--dispatch-frac", "0.5"])


@pytest.mark.parametrize("argv,item", [
    (["farmer", "--with-cross-scenario"], "A11c"),
    (["farmer", "--scenario-source", "streamed",
      "--subproblem-chunk", "2", "--telemetry-dir", "t"], "A13"),
    (["farmer", "--mesh-devices", "2", "--with-fwph"], "A8"),
    (["farmer", "--telemetry-dir", "t"], "A13"),
    (["farmer", "--status-port", "0"], "A13"),
    (["farmer", "--checkpoint-dir", "c"], "A14"),
    (["analyze", "t"], "A13"),
    (["serve"], "A15"),
])
def test_cli_refuses_what_is_not_ported(argv, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md {item}"):
        main(argv + ["--device", "cpu"] if argv[0] not in ("analyze",
                                                             "serve")
             else argv)


# what the refusals above named before the EF, L-shaped and FWPH
# engines, bundling and the models were ported, now run on the CPU: the
# command line, the flags that let its spokes report, and what the last
# line must hold
_SIZES_LP_EF = 220378.4643     # the sizes(3) EF LP, HiGHS (test_models)


@pytest.mark.parametrize("argv,check", [
    (["farmer", "--hub", "lshaped"], "sandwich"),
    (["farmer", "--with-efmip", "--default-rho", "10", "--convthresh",
      "-1", "--max-iterations", "400", "--rel-gap", "1e-3"], "sandwich"),
    (["farmer", "--with-xhatlshaped", "--default-rho", "10",
      "--convthresh", "-1", "--max-iterations", "30"], "sandwich"),
    (["farmer", "--EF"], "ef"),
    (["sizes", "--max-iterations", "5"], "sizes"),
    (["farmer", "--hub", "lshaped", "--with-xhatlshaped"], "sandwich"),
    (["farmer", "--with-fwph", "--default-rho", "10", "--convthresh",
      "-1", "--max-iterations", "10", "--subproblem-max-iter", "4000"],
     "outer"),
    (["farmer", "--num-scens", "4", "--num-bundles", "2", "--default-rho",
      "10", "--convthresh", "-1", "--max-iterations", "5",
      "--with-xhatshuffle"], "bundles"),
], ids=["lshaped-hub", "efmip", "xhatlshaped", "EF", "sizes",
        "lshaped-xhatlshaped", "fwph", "bundles"])
@pytest.mark.usefixtures("one_torch_thread")
def test_cli_runs_what_is_now_ported(argv, check, capsys):
    """``python -m mpisppy_tpu_torch ... --device cpu``: the L-shaped
    hub, the EF-MIP and x̂-lshaped spokes end with outer <= -108390 <=
    inner (within the JAX wheel tests' 1.0; a null inner bound only for
    the hub alone, as the JAX CLI prints it), ``--EF`` prints the EF
    value -108390 (rel 1e-4), the sizes PH wheel's outer bound lies
    below the sizes EF LP (tests/test_models.py's 1e-2 band), the FWPH
    spoke's wheel ends with an outer bound <= -108390 + 1, and farmer(4)
    in 2 bundles with the x̂ spoke brackets the farmer(4) EF within
    1.0."""
    import json
    assert main(argv + ["--device", "cpu"]) == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    if check == "ef":
        assert result["ef_objective"] == pytest.approx(EF_OBJ, rel=1e-4)
        return
    outer, inner = result["outer_bound"], result["inner_bound"]
    assert np.isfinite(outer)
    if check == "sizes":
        assert outer <= _SIZES_LP_EF + 1e-2 * _SIZES_LP_EF
        return
    if check == "outer":
        assert outer <= EF_OBJ + 1.0
        return
    if check == "bundles":
        from mpisppy_tpu_torch.core.ef import ExtensiveForm
        ef4, _ = ExtensiveForm(_farmer(4), device="cpu") \
            .solve_extensive_form()
        assert inner is not None
        assert outer <= ef4 + 1.0 and inner >= ef4 - 1.0
        assert outer <= inner + 1e-5 * abs(inner)
        return
    assert outer <= EF_OBJ + 1.0
    if inner is not None or len(argv) > 3:
        assert inner is not None and inner >= EF_OBJ - 1.0
        assert outer <= inner + 1e-5 * abs(inner)


@pytest.mark.slow
@pytest.mark.usefixtures("one_torch_thread")
def test_cli_sizes_integer_ef(capsys):
    """``sizes --EF --EF-integer --device cpu``: the EF MIP through host
    HiGHS at the JAX CLI's 120 s limit, 220000 to 2 significant digits
    (tests/test_mip.py:32's bar)."""
    import json
    import math
    assert main(["sizes", "--EF", "--EF-integer", "--device", "cpu"]) == 0
    obj = json.loads(capsys.readouterr().out.strip().splitlines()[-1])[
        "ef_objective"]
    assert round(obj, -int(math.floor(math.log10(abs(obj)))) + 1) == 220000


@pytest.mark.parametrize("argv", [
    ["farmer", "--EF"],
    ["sizes", "--EF", "--EF-integer"],
    ["farmer", "--hub", "lshaped", "--with-xhatlshaped"],
    ["farmer", "--with-efmip"],
], ids=["EF", "EF-integer", "lshaped", "efmip"])
def test_cli_new_paths_without_a_card_raise(argv, monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(argv)


def test_wheel_dicts_cover_every_ported_spoke_kind():
    """Every spoke kind either builds its dicts (on the run's device) or
    raises naming its ROADMAP.md item; FWPH is ported (its opt class is
    the FWPH engine)."""
    ported = [k for k in KNOWN_SPOKES if k != "cross_scenario"]
    assert "fwph" in ported
    with pytest.raises(NotImplementedError, match="ROADMAP.md A11c"):
        wheel_dicts(RunConfig(model="farmer", num_scens=3, device="cpu",
                              spokes=[SpokeConfig(kind="cross_scenario")]))
    cfg = RunConfig(model="farmer", num_scens=3, device="cpu",
                    spokes=[SpokeConfig(kind=k) for k in ported])
    hub_d, spoke_ds = wheel_dicts(cfg)
    assert hub_d["hub_class"] is PHHub and hub_d["opt_class"] is PH
    assert len(spoke_ds) == len(ported)
    for sd in [hub_d] + spoke_ds:
        assert sd["opt_kwargs"]["device"] == "cpu"
        assert sd["opt_kwargs"]["batch"] is hub_d["opt_kwargs"]["batch"]
    from mpisppy_tpu_torch.core.fwph import FWPH
    from mpisppy_tpu_torch.cylinders.fwph_spoke import FrankWolfeOuterBound
    fw = spoke_ds[ported.index("fwph")]
    assert fw["opt_class"] is FWPH
    assert fw["spoke_class"] is FrankWolfeOuterBound


# ---- the protocol cases of the JAX package's cylinder tests ----

def test_window_protocol():
    w = Window(3)
    vals, wid = w.read()
    assert wid == 0
    w.put([1.0, 2.0, 3.0])
    vals, wid = w.read()
    assert wid == 1 and list(vals) == [1.0, 2.0, 3.0]
    w.put([4.0, 5.0, 6.0])
    assert w.read_id() == 2
    w.kill()
    assert w.read_id() == Window.KILL


def test_kill_interrupts_candidate_stream():
    """A spoke mid-candidate-loop honors the kill signal between
    evaluations: a terminating wheel never waits out the remaining
    candidates."""
    batch = _farmer()
    opt = PHBase(batch, _opts(), device="cpu")
    opt.solve_loop(w_on=False, prox_on=False)

    class SlowStream(XhatLooperInnerBound):
        def candidates(self, X):
            for s in range(self.opt.batch.S):
                yield X[s] + s          # distinct keys: no dedup skips

    sp = SlowStream(opt, options={"xhat_scen_limit": 3})
    sp.hub_window = Window(sp.remote_window_length())
    sp.my_window = Window(sp.local_window_length())
    orig = opt.calculate_incumbent

    def slow_eval(xhat, **kw):
        time.sleep(0.5)
        return orig(xhat, **kw)

    opt.calculate_incumbent = slow_eval
    th = threading.Thread(target=sp.main, daemon=True)
    th.start()
    sp.hub_window.put(np.zeros(batch.S * batch.K))
    time.sleep(0.6)
    sp.hub_window.kill()
    th.join(timeout=3.0)
    assert not th.is_alive(), "spoke ignored kill mid-candidate-stream"
    bound, xhat = sp.finalize()
    assert bound is None or np.isfinite(bound)


def test_base_receive_does_not_consume_cut_windows():
    """A cut payload written between the subclass's read and the base
    bound loop is NOT marked consumed (it would be lost). The cut
    engine is not ported (ROADMAP.md A11c): a stub engine and a stub
    cut spoke stand in for CrossScenarioPH and its spoke."""
    class _Batch:
        S, K = 3, 2

    class _Engine:
        batch = _Batch()
        options = {}

        def __init__(self):
            self.cuts = []

        def add_cuts(self, rhs, rows):
            self.cuts.append((rhs, rows))

    class _CutSpoke(Spoke):
        converger_spoke_types = (ConvergerSpokeType.NONANT_GETTER,)
        converger_spoke_char = "C"
        is_cut_spoke = True

        @staticmethod
        def payload_length(S, K):
            return S * (1 + K)

    eng = _Engine()
    spoke = _CutSpoke(_Engine())
    hub = CrossScenarioHub(eng, spokes=[spoke])
    hub.make_windows()
    hub.setup_hub()
    ci = next(iter(hub.cut_spoke_indices))
    spoke.spoke_to_hub(np.zeros(3 * 3))
    super(CrossScenarioHub, hub).receive_bounds()
    assert hub._spoke_last_ids[ci] == 0
    hub.receive_bounds()
    assert hub._spoke_last_ids[ci] > 0 and len(eng.cuts) == 1


def test_hub_refuses_unported_options():
    opt = PH(_farmer(), _opts(), device="cpu")
    for key, item in (("status_port", "A13"), ("checkpoint_dir", "A14"),
                      ("resume_from", "A14")):
        with pytest.raises(NotImplementedError, match=f"ROADMAP.md {item}"):
            PHHub(opt, options={key: 0 if key == "status_port" else "d"})
    with pytest.raises(NotImplementedError, match="ROADMAP.md A14"):
        LagrangianOuterBound(PHBase(_farmer(), _opts(), device="cpu"),
                             options={"checkpoint_dir": "d"})


# ---- the config and parser cases of the JAX package's CLI tests ----

def test_config_validation_rejects_bad_values():
    for bad in (RunConfig(model="nope"), RunConfig(num_scens=0),
                RunConfig(hub="simplex"),
                RunConfig(num_scens=5, num_bundles=2),
                RunConfig(spokes=[SpokeConfig(kind="mystery")]),
                RunConfig(algo=AlgoConfig(default_rho=-1.0)),
                RunConfig(hub="lshaped", spokes=[SpokeConfig(kind="fwph")]),
                RunConfig(hub="aph",
                          spokes=[SpokeConfig(kind="cross_scenario")]),
                RunConfig(algo=AlgoConfig(
                    subproblem_kernel_backend="tpu"))):
        with pytest.raises(ValueError):
            bad.validate()
    # the port's backend and its alias validate
    for be in ("cuda", "pallas", "reference"):
        RunConfig(algo=AlgoConfig(subproblem_kernel_backend=be)).validate()


def test_parser_builds_config():
    args = make_parser().parse_args(
        ["farmer", "--num-scens", "4", "--default-rho", "2.5",
         "--max-iterations", "7", "--with-lagrangian",
         "--with-xhatshuffle", "--rel-gap", "0.01", "--device", "cpu"])
    cfg = config_from_args(args)
    assert cfg.model == "farmer" and cfg.num_scens == 4
    assert cfg.algo.default_rho == 2.5
    assert {sp.kind for sp in cfg.spokes} == {"lagrangian", "xhatshuffle"}
    assert cfg.rel_gap == 0.01 and cfg.device == "cpu"
    default = config_from_args(make_parser().parse_args(["uc"]))
    assert default.device is None
    # the port's run default is its hand-written block
    assert default.algo.subproblem_kernel_backend == "cuda"


def test_robustness_config_fields_validate_and_plumb():
    args = make_parser().parse_args(
        ["farmer", "--wheel-deadline", "120.5", "--with-lagrangian"])
    assert config_from_args(args).wheel_deadline == 120.5
    cfg = RunConfig(model="farmer", num_scens=3, wheel_deadline=60.0,
                    spoke_sleep_time=0.002, device="cpu",
                    spokes=[SpokeConfig(kind="lagrangian")],
                    supervisor={"max_respawns": 1,
                                "crossed_bound_tol": 1e-3}).validate()
    hd = hub_dict(cfg)
    assert hd["hub_kwargs"]["options"]["wheel_deadline"] == 60.0
    assert hd["hub_kwargs"]["options"]["crossed_bound_tol"] == 1e-3
    sd = spoke_dict(cfg, cfg.spokes[0], batch=hd["opt_kwargs"]["batch"])
    assert sd["opt_kwargs"]["options"]["spoke_sleep_time"] == 0.002
    cfg2 = RunConfig(model="farmer", num_scens=3, spoke_sleep_time=0.5,
                     spokes=[SpokeConfig(
                         kind="lagrangian",
                         options={"spoke_sleep_time": 0.001})])
    sd2 = spoke_dict(cfg2, cfg2.spokes[0], batch=hd["opt_kwargs"]["batch"])
    assert sd2["opt_kwargs"]["options"]["spoke_sleep_time"] == 0.001
    rt = config_from_dict(cfg.to_dict())
    assert rt.wheel_deadline == 60.0 and rt.supervisor == cfg.supervisor
    assert rt.device == "cpu"
    for bad in (RunConfig(wheel_deadline=0.0),
                RunConfig(spoke_ready_timeout=-1.0),
                RunConfig(supervisor={"bogus_knob": 1})):
        with pytest.raises(ValueError):
            bad.validate()


# ---- the synchronizer cases ----

def _group(names_lens, n):
    wins = Synchronizer.make_thread_windows(names_lens, n)
    return [Synchronizer(names_lens, n, i, windows=wins, sleep_secs=0.002)
            for i in range(n)]


def test_sync_allreduce_rounds():
    syncs = _group({"red": 4}, 3)
    out = [[] for _ in range(3)]

    def worker(i):
        for r in range(5):
            out[i].append(syncs[i].sync_allreduce(
                np.full(4, float((i + 1) * (r + 1)))))

    ts = [threading.Thread(target=worker, args=(i,)) for i in range(3)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=30)
    for i in range(3):
        for r in range(5):
            assert np.allclose(out[i][r], 6.0 * (r + 1))


def test_keep_up_folds_newest_local():
    syncs = _group({"v": 2}, 2)
    g = {"v": np.zeros(2)}
    syncs[0].compute_global_data({"v": np.array([3.0, 4.0])}, g,
                                 keep_up=True)
    assert np.allclose(g["v"], [3.0, 4.0])
    g2 = {"v": np.zeros(2)}
    syncs[0].compute_global_data({"v": np.array([9.0, 9.0])}, g2)
    assert np.allclose(g2["v"], [3.0, 4.0])


def test_async_staleness_no_blocking():
    syncs = _group({"v": 1}, 2)
    got3 = threading.Event()

    def fast():
        g = {"v": np.zeros(1)}
        syncs[0].compute_global_data({"v": np.array([1.0])}, g,
                                     keep_up=True)
        assert g["v"][0] == 1.0
        deadline = time.monotonic() + 20
        while g["v"][0] < 3.0 and time.monotonic() < deadline:
            syncs[0].get_global_data(g)
            time.sleep(0.005)
        if g["v"][0] == 3.0:
            got3.set()

    def slow():
        time.sleep(0.3)
        g = {"v": np.zeros(1)}
        syncs[1].compute_global_data({"v": np.array([2.0])}, g,
                                     keep_up=True)
        while syncs[1].global_quitting == 0:
            time.sleep(0.01)

    ta = threading.Thread(target=lambda: syncs[0].run(fast))
    tb = threading.Thread(target=lambda: syncs[1].run(slow))
    ta.start(), tb.start()
    ta.join(timeout=30), tb.join(timeout=30)
    assert got3.is_set(), "straggler's summand never reached the global"


def test_listener_overlaps_worker():
    syncs = _group({"v": 1}, 1)

    def worker():
        b0 = syncs[0].beats
        time.sleep(0.2)
        return syncs[0].beats - b0

    assert syncs[0].run(worker) >= 5


def test_side_gig_runs_under_lock():
    calls = []

    def gig(sync):
        calls.append(sync.global_data["v"].copy())
        sync.enable_side_gig = False

    wins = Synchronizer.make_thread_windows({"v": 1}, 1)
    s = Synchronizer({"v": 1}, 1, 0, windows=wins, sleep_secs=0.002,
                     listener_gigs={"v": (gig, None)})

    def worker():
        g = {"v": np.zeros(1)}
        s.compute_global_data({"v": np.array([7.0])}, g, keep_up=True,
                              enable_side_gig=True)
        deadline = time.monotonic() + 10
        while not calls and time.monotonic() < deadline:
            time.sleep(0.005)

    s.run(worker)
    assert calls and calls[-1][0] == 7.0
