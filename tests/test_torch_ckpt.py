"""The port's checkpoints (mpisppy_tpu_torch/ckpt, the hub's and the
spokes' arming, the SIGTERM capture) against the JAX package's: the
cases of tests/test_ckpt.py on the port at that file's bars, and
bundles crossing the packages both ways on farmer(3) and UC 3 x 6 — the
manifests' fingerprints equal, the installed (W, x̄, x̄², ρ) bit-equal
to the source, and each continued trajectory within the band of
tests/test_extensions.py:259 of the other package's uninterrupted run.
"""

import json
import math
import os

import numpy as np
import pytest

from mpisppy_tpu_torch import obs
from mpisppy_tpu_torch.ckpt import bundle, spoke_state
from mpisppy_tpu_torch.ckpt.bundle import CheckpointError
from mpisppy_tpu_torch.ckpt.manager import resume_hub
from mpisppy_tpu_torch.core.ph import PH
from mpisppy_tpu_torch.cylinders.hub import Hub
from mpisppy_tpu_torch.ir.batch import build_batch
from mpisppy_tpu_torch.models import farmer, uc
from mpisppy_tpu_torch.testing import faults
from mpisppy_tpu_torch.utils.config import AlgoConfig, RunConfig, SpokeConfig
from mpisppy_tpu_torch.utils.runtime import to_host
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

EF3 = -108390.0


def make_ph(iters=3, num_scens=3, **opt_overrides):
    batch = build_batch(farmer.scenario_creator,
                        farmer.make_tree(num_scens))
    options = {"defaultPHrho": 1.0, "PHIterLimit": iters,
               "convthresh": 1e-9, "subproblem_max_iter": 2000,
               "subproblem_eps": 1e-7}
    options.update(opt_overrides)
    return PH(batch, options, device="cpu")


@pytest.fixture
def mem_obs():
    rec = obs.configure(out_dir=None)
    yield rec
    obs.shutdown()


def _count(name):
    return obs.counters_snapshot().get(name, 0)


def _events(etype):
    return [e for _, e in obs.events(etype)]


def _hub_arrays(S=3, K=4, it=5):
    return {"W": np.random.RandomState(0).standard_normal((S, K)),
            "xbar": np.ones((S, K)), "xsqbar": np.ones((S, K)),
            "rho": np.full((S, K), 2.0), "iter": np.asarray(it)}


# ---------------- bundle format ----------------

def test_bundle_roundtrip_latest_and_retention(tmp_path):
    d = str(tmp_path)
    spoke_state.save_spoke_state(d, 0, "LagrangianOuterBound",
                                 "lagrangian",
                                 {"bound": -1.5, "W": np.ones((3, 4))})
    p = bundle.write_bundle(d, _hub_arrays(), {"fingerprint": "fp"},
                            iteration=5, seq=1)
    assert bundle.latest_bundle(d) == p
    assert bundle.resolve_bundle(d) == p        # dir resolves via LATEST
    assert bundle.resolve_bundle(p) == p        # bundle resolves to itself
    manifest, arrays, spokes = bundle.load_bundle(d, fingerprint="fp")
    assert manifest["iter"] == 5 and arrays["iter"] == 5
    np.testing.assert_array_equal(arrays["rho"], np.full((3, 4), 2.0))
    # the live spoke snapshot was copied INTO the bundle
    assert "spoke0.npz" in spokes
    st = spoke_state.load_spoke_state(spokes["spoke0.npz"],
                                      "LagrangianOuterBound")
    assert st["bound"] == -1.5 and st["W"].shape == (3, 4)
    # retention: keep=2 prunes the oldest, LATEST re-points
    for it in (6, 7, 8):
        last = bundle.write_bundle(d, _hub_arrays(it=it), {},
                                   iteration=it, seq=it, keep=2)
    names = sorted(n for n in os.listdir(d) if n.startswith("bundle-"))
    assert len(names) == 2
    assert bundle.latest_bundle(d) == last
    # no temp debris survives
    assert not [n for n in os.listdir(d) if n.startswith(".tmp-")]


def test_bundle_rejections_are_reasoned(tmp_path):
    d = str(tmp_path)
    with pytest.raises(CheckpointError) as e:
        bundle.resolve_bundle(d)
    assert e.value.reason == "not_found"

    p = bundle.write_bundle(d, _hub_arrays(), {"fingerprint": "fp"},
                            iteration=1, seq=1)
    with pytest.raises(CheckpointError) as e:
        bundle.load_bundle(p, fingerprint="other")
    assert e.value.reason == "fingerprint_mismatch"

    m = json.load(open(os.path.join(p, "manifest.json")))
    m["schema_version"] = 999
    open(os.path.join(p, "manifest.json"), "w").write(json.dumps(m))
    with pytest.raises(CheckpointError) as e:
        bundle.load_bundle(p)
    assert e.value.reason == "schema_mismatch"
    open(os.path.join(p, "manifest.json"), "w").write("{not json")
    with pytest.raises(CheckpointError) as e:
        bundle.load_bundle(p)
    assert e.value.reason == "bad_manifest"

    p2 = bundle.write_bundle(d, _hub_arrays(), {}, iteration=2, seq=2)
    with open(os.path.join(p2, "hub.npz"), "r+b") as f:
        f.truncate(16)
    with pytest.raises(CheckpointError) as e:
        bundle.load_bundle(p2)
    assert e.value.reason == "truncated"

    bad = _hub_arrays()
    bad["W"][0, 0] = np.nan
    p3 = bundle.write_bundle(d, bad, {}, iteration=3, seq=3)
    with pytest.raises(CheckpointError) as e:
        bundle.load_bundle(p3)
    assert e.value.reason == "nonfinite"
    with pytest.raises(CheckpointError) as e:
        bundle.validate_state_arrays(_hub_arrays(it=-1))
    assert e.value.reason == "bad_iter"
    with pytest.raises(CheckpointError) as e:
        bundle.validate_state_arrays(
            {**_hub_arrays(), "rho": np.zeros((3, 4))})
    assert e.value.reason == "bad_rho"


def test_atomic_savez_never_tears(tmp_path, monkeypatch):
    """A crash mid-write (simulated: os.replace fails) leaves the
    previous complete file untouched."""
    path = str(tmp_path / "state.npz")
    bundle.atomic_savez(path, a=np.arange(3))
    with np.load(path) as d:
        np.testing.assert_array_equal(d["a"], np.arange(3))
    real_replace = os.replace
    monkeypatch.setattr(bundle.os, "replace",
                        lambda *a: (_ for _ in ()).throw(OSError("boom")))
    with pytest.raises(OSError):
        bundle.atomic_savez(path, a=np.arange(9))
    monkeypatch.setattr(bundle.os, "replace", real_replace)
    with np.load(path) as d:
        np.testing.assert_array_equal(d["a"], np.arange(3))  # untouched


# ---------------- spoke warm state ----------------

def test_spoke_state_roundtrip_and_class_guard(tmp_path, mem_obs):
    d = str(tmp_path)
    spoke_state.save_spoke_state(
        d, 1, "DiveInnerBound", "dive",
        {"bound": -7.0, "rounds": 12, "best_xhat": np.ones(4),
         "skipped": None})
    path = spoke_state.spoke_state_path(d, 1)
    st = spoke_state.load_spoke_state(path, "DiveInnerBound")
    assert st["bound"] == -7.0 and st["rounds"] == 12
    assert st["kind"] == "dive" and st["index"] == 1
    assert "skipped" not in st
    with pytest.raises(CheckpointError) as e:
        spoke_state.load_spoke_state(path, "XhatShuffleInnerBound")
    assert e.value.reason == "class_mismatch"
    spoke_state.save_spoke_state(d, 2, "X", "x", {"bound": float("inf")})
    with pytest.raises(CheckpointError) as e:
        spoke_state.load_spoke_state(spoke_state.spoke_state_path(d, 2))
    assert e.value.reason == "nonfinite"


def test_spoke_resume_options_generation_aware(tmp_path):
    ck = str(tmp_path / "ck")
    assert spoke_state.spoke_resume_options(None, None, 0, "x") == {}
    o = spoke_state.spoke_resume_options(ck, None, 0, "lagrangian")
    assert o == {"checkpoint_dir": ck, "checkpoint_index": 0,
                 "checkpoint_kind": "lagrangian"}
    # a respawn (gen > 0) picks up the LIVE file the dead gen wrote
    spoke_state.save_spoke_state(ck, 0, "LagrangianOuterBound",
                                 "lagrangian", {"bound": -1.0})
    o = spoke_state.spoke_resume_options(ck, None, 0, "lagrangian",
                                         gen=1)
    assert o["resume_state"] == spoke_state.spoke_state_path(ck, 0)
    # an initial launch resumes from the bundle's copied snapshot
    p = bundle.write_bundle(ck, _hub_arrays(), {}, iteration=1, seq=1)
    o = spoke_state.spoke_resume_options(None, ck, 0, "lagrangian")
    assert o.get("resume_state") == os.path.join(p, "spoke0.npz")
    o = spoke_state.spoke_resume_options(None, str(tmp_path / "nope"),
                                         0, "lagrangian")
    assert "resume_state" not in o


# ---------------- hub capture + resume (engine level) ----------------

def test_manager_capture_and_resume_roundtrip(tmp_path, mem_obs):
    d = str(tmp_path)
    ph = make_ph(iters=3)
    ph.ph_main(finalize=False)
    hub = Hub(ph, spokes=[], options={"checkpoint_dir": d,
                                      "checkpoint_fingerprint": "fp"})
    hub.OuterBoundUpdate(-115000.0, "L")
    hub.InnerBoundUpdate(-108000.0, "X")
    path = hub.ckpt.capture("test")
    assert path and os.path.isfile(os.path.join(path, "manifest.json"))
    assert _count("ckpt.captures") == 1
    st = hub.ckpt.status()
    assert st["last_bundle"] == path and st["last_iter"] == ph._iter
    assert hub.status_snapshot()["checkpoint"]["last_bundle"] == path

    ph2 = make_ph(iters=3)
    hub2 = Hub(ph2, spokes=[])
    assert resume_hub(hub2, d, fingerprint="fp") is not None
    for k in ("W", "xbar", "xsqbar", "rho"):
        np.testing.assert_array_equal(to_host(getattr(ph2, k)),
                                      to_host(getattr(ph, k)))
        assert getattr(ph2, k).dtype == getattr(ph, k).dtype
        assert getattr(ph2, k).device == ph.W.device
    assert ph2._iter == ph._iter
    assert getattr(ph2, "_warm_started", False)
    assert getattr(ph2, "_warm_started_xbar", False)
    assert hub2.BestOuterBound == -115000.0
    assert hub2.latest_ob_char == "L" and hub2.latest_ib_char == "X"
    assert [k for _, k, _, _ in hub2.bound_events] == ["outer", "inner"]
    assert _count("ckpt.resumed") == 1

    # fingerprint mismatch: reasoned rejection, engine untouched
    ph3 = make_ph(iters=3)
    hub3 = Hub(ph3, spokes=[])
    assert resume_hub(hub3, d, fingerprint="OTHER") is None
    assert float(to_host(ph3.W).__abs__().max()) == 0.0
    assert hub3.BestOuterBound == -math.inf
    assert _count("ckpt.rejected.fingerprint_mismatch") == 1
    evs = _events("ckpt.resume_rejected")
    assert evs and evs[-1]["reason"] == "fingerprint_mismatch"


def test_resumed_wheel_keeps_its_bundles_in_its_own_directory(tmp_path,
                                                              mem_obs):
    """A wheel resumed into its own checkpoint directory keeps what it
    captures there: ``keep`` bundles written by the JAX package
    (iterations 5, 10, 15), a port hub resumed from the directory and
    checkpointing into it, one capture. The JAX package names that
    capture from the engine's restarted iteration and its retention
    deletes it at once; the port names it on from the resumed bundle,
    so it survives, LATEST and both packages' ``latest_bundle`` resolve
    to it, both packages load it, and the JAX-written predecessors
    still load."""
    from mpisppy_tpu.ckpt import bundle as jax_bundle
    d = str(tmp_path)
    keep = 3
    ph = make_ph(iters=1)
    S, K = ph.batch.S, ph.batch.K
    for it in (5, 10, 15):
        arrays = _hub_arrays(S=S, K=K, it=it)
        jax_bundle.write_bundle(d, arrays, {"fingerprint": "fp"},
                                iteration=it, seq=it // 5, keep=keep)
    ph.ph_main(finalize=False)
    hub = Hub(ph, spokes=[], options={"checkpoint_dir": d,
                                      "checkpoint_keep": keep,
                                      "resume_from": d,
                                      "checkpoint_fingerprint": "fp"})
    assert ph._iter == 15          # the installed bundle's iteration
    # the engine runs its warm iteration 0 and ph_main's reset; at
    # iteration 1 the hub's termination check captures (its first
    # interval capture): iteration 15 + 1, sequence 3 + 1
    ph._iter = 1
    path = hub.ckpt.maybe_capture()
    assert path is not None and os.path.isdir(path)
    name = os.path.basename(path)
    assert name == bundle._bundle_name(16, 4)
    assert bundle.latest_bundle(d) == path
    assert jax_bundle.latest_bundle(d) == path
    assert open(os.path.join(d, bundle.LATEST)).read().strip() == name
    manifest, arrays, _ = bundle.load_bundle(d, fingerprint="fp")
    assert manifest["iter"] == arrays["iter"] == 16
    np.testing.assert_array_equal(arrays["W"], to_host(ph.W))
    jm, ja, _ = jax_bundle.load_bundle(d, fingerprint="fp")
    assert jm["iter"] == 16 and ja["iter"] == 16
    # retention kept the newest ``keep``: the capture and the two
    # newest JAX-written predecessors, which still load
    names = sorted(n for n in os.listdir(d) if n.startswith("bundle-"))
    assert names == [bundle._bundle_name(10, 2),
                     bundle._bundle_name(15, 3), name]
    for it, seq in ((10, 2), (15, 3)):
        m, a, _ = bundle.load_bundle(
            os.path.join(d, bundle._bundle_name(it, seq)),
            fingerprint="fp")
        assert m["iter"] == a["iter"] == it
    assert ph._iter == 1           # the engine's own count is untouched


def test_resume_refuses_implausible_bounds_but_keeps_state(tmp_path,
                                                           mem_obs):
    d = str(tmp_path)
    ph = make_ph(iters=1)
    ph.ph_main(finalize=False)
    hub = Hub(ph, spokes=[], options={"checkpoint_dir": d})
    hub.ckpt.capture("test")
    p = bundle.latest_bundle(d)
    m = json.load(open(os.path.join(p, "manifest.json")))
    m["outer"] = -1e30
    open(os.path.join(p, "manifest.json"), "w").write(json.dumps(m))
    ph2 = make_ph(iters=1)
    hub2 = Hub(ph2, spokes=[])
    assert resume_hub(hub2, p) is not None      # state installs
    np.testing.assert_allclose(to_host(ph2.W), to_host(ph.W))
    assert hub2.BestOuterBound == -math.inf     # garbage bound refused
    assert _count("ckpt.rejected.implausible_bound") == 1


def test_wxbar_load_rejects_poisoned_payload(tmp_path, mem_obs):
    from mpisppy_tpu_torch.extensions import wxbar_io

    ph = make_ph(iters=1)
    ph.ph_main(finalize=False)
    ck = str(tmp_path / "state.npz")
    wxbar_io.save_state(ph, ck)
    assert not [f for f in os.listdir(tmp_path) if ".tmp" in f]
    good = dict(np.load(ck))
    bad = dict(good)
    bad["xbar"] = np.array(bad["xbar"])
    bad["xbar"][0, 0] = np.nan
    np.savez(str(tmp_path / "bad.npz"), **bad)
    ph2 = make_ph(iters=1)
    W0 = to_host(ph2.W).copy()
    with pytest.raises(CheckpointError) as e:
        wxbar_io.load_state(ph2, str(tmp_path / "bad.npz"))
    assert e.value.reason == "nonfinite"
    np.testing.assert_array_equal(to_host(ph2.W), W0)  # untouched
    assert _count("ckpt.rejected.nonfinite") == 1
    bad2 = dict(good)
    bad2["iter"] = np.asarray(-3)
    np.savez(str(tmp_path / "bad2.npz"), **bad2)
    with pytest.raises(CheckpointError) as e:
        wxbar_io.load_state(ph2, str(tmp_path / "bad2.npz"))
    assert e.value.reason == "bad_iter"


# ---------------- preempt fault kind ----------------

def test_preempt_fault_plan_validates():
    faults.validate_plan({"spokes": {"0": [
        {"action": "preempt", "at_update": 2}]},
        "hub": [{"action": "preempt", "at_iteration": 5}]})
    with pytest.raises(ValueError):
        faults.validate_plan({"hub": [{"action": "explode"}]})
    with pytest.raises(ValueError):
        faults.validate_plan({"hub": [
            {"action": "preempt", "at_publish": 1}]})


def test_preempt_action_sends_sigterm_to_self(monkeypatch):
    sent = []
    monkeypatch.setattr(faults.os, "kill",
                        lambda pid, sig: sent.append((pid, sig)))
    inj = faults.FaultInjector.from_spec(
        {"spokes": {"0": [{"action": "preempt", "at_update": 1}]}},
        index=0)
    inj.on_publish(np.array([1.0]))
    assert sent == [(os.getpid(), faults.signal.SIGTERM)]


def test_install_hub_faults_preempts_at_iteration(monkeypatch):
    sent = []
    monkeypatch.setattr(faults.os, "kill",
                        lambda pid, sig: sent.append(sig))

    class _FakeOpt:
        options = {}
        _iter = 0

    class _FakeHub:
        opt = _FakeOpt()
        checks = 0

        def determine_termination(self):
            type(self).checks += 1
            return False

    hub = _FakeHub()
    assert faults.install_hub_faults(
        hub, json.dumps({"spokes": {"0": []}})) is None  # no hub specs
    inj = faults.install_hub_faults(
        hub, {"hub": [{"action": "preempt", "at_iteration": 3}]})
    assert inj is not None
    for it in (0, 1, 2):
        _FakeOpt._iter = it
        assert hub.determine_termination() is False
    assert sent == []
    _FakeOpt._iter = 3
    hub.determine_termination()
    assert sent == [faults.signal.SIGTERM]
    hub.determine_termination()             # fires ONCE
    assert sent == [faults.signal.SIGTERM]
    assert _FakeHub.checks == 5             # the wrapped original ran


# ---------------- config / CLI plumbing ----------------

def test_checkpoint_config_and_cli_plumbing(tmp_path):
    """The JAX case, plus: one configuration fingerprints the same in
    both packages (the JAX package's ckpt_fingerprint of the same
    fields)."""
    from mpisppy_tpu.utils.config import config_from_dict as jax_cfd
    from mpisppy_tpu.utils.vanilla import ckpt_fingerprint as jax_fp
    from mpisppy_tpu_torch.__main__ import config_from_args, make_parser
    from mpisppy_tpu_torch.utils.config import config_from_dict
    from mpisppy_tpu_torch.utils.vanilla import ckpt_fingerprint, hub_dict

    args = make_parser().parse_args(
        ["farmer", "--num-scens", "3", "--checkpoint-dir", "/tmp/ck",
         "--checkpoint-interval", "5", "--checkpoint-keep", "2",
         "--resume-from", "/tmp/ck", "--device", "cpu"])
    cfg = config_from_args(args)
    assert cfg.checkpoint_dir == "/tmp/ck"
    assert cfg.checkpoint_interval == 5.0 and cfg.checkpoint_keep == 2
    assert cfg.resume_from == "/tmp/ck"
    assert config_from_dict(cfg.to_dict()).checkpoint_dir == "/tmp/ck"
    with pytest.raises(ValueError):
        RunConfig(checkpoint_interval=0.0).validate()
    with pytest.raises(ValueError):
        RunConfig(checkpoint_keep=0).validate()
    hd = hub_dict(cfg)
    o = hd["hub_kwargs"]["options"]
    assert o["checkpoint_dir"] == "/tmp/ck"
    assert o["resume_from"] == "/tmp/ck"
    assert o["checkpoint_fingerprint"] == ckpt_fingerprint(cfg)
    cfg2 = config_from_dict(cfg.to_dict())
    cfg2.num_scens = 4
    assert ckpt_fingerprint(cfg2) != ckpt_fingerprint(cfg)
    d = cfg.to_dict()
    d.pop("device", None)
    assert jax_fp(jax_cfd(d)) == ckpt_fingerprint(cfg)


# ---------------- the live preemption-resume wheel ----------------

def test_preempt_resume_wheel(tmp_path, monkeypatch):
    """THE acceptance wheel: a live spawn-ctx farmer wheel is SIGTERM'd
    mid-run via the ``preempt`` fault kind, relaunched with
    ``resume_from``, and the resumed wheel reaches the killed run's gap
    in strictly fewer iterations than the cold start, best-bound ledger
    monotone across the restart; a truncated bundle falls back to cold
    start with a reasoned event (reason ``truncated``)."""
    from mpisppy_tpu_torch.obs import analyze
    from mpisppy_tpu_torch.utils.multiproc import spin_the_wheel_processes

    ck = str(tmp_path / "ckpt")
    t1 = str(tmp_path / "t1")
    algo = AlgoConfig(default_rho=1.0, max_iterations=50000,
                      convthresh=-1.0, subproblem_max_iter=2000,
                      subproblem_eps=1e-7)
    cfg = RunConfig(model="farmer", num_scens=3, algo=algo,
                    spokes=[SpokeConfig(kind="xhatshuffle")],
                    rel_gap=1e-12,          # unreachable: preempt wins
                    wheel_deadline=600.0, checkpoint_dir=ck,
                    checkpoint_interval=1000.0, telemetry_dir=t1,
                    device="cpu")
    monkeypatch.setenv("MPISPPY_TPU_FAULT_PLAN", json.dumps(
        {"hub": [{"action": "preempt", "at_iteration": 4}]}))
    try:
        hub = spin_the_wheel_processes(cfg, join_timeout=180.0)
    finally:
        obs.shutdown()
    monkeypatch.delenv("MPISPPY_TPU_FAULT_PLAN")
    assert hub._preempted
    killed_iter = hub.opt._iter
    _, killed_gap = hub.compute_gaps()
    assert killed_iter >= 4 and math.isfinite(killed_gap)
    assert os.path.isfile(os.path.join(ck, "LATEST"))
    t1_types = [json.loads(ln).get("type")
                for ln in open(os.path.join(t1, "events.jsonl"))]
    assert "hub.preempted" in t1_types and "ckpt.capture" in t1_types
    reasons = {json.load(open(os.path.join(ck, n, "manifest.json")))
               ["reason"] for n in os.listdir(ck)
               if n.startswith("bundle-")}
    assert "preempt" in reasons

    # ---- relaunch from the bundle (spokeless: the seeded ledger alone
    # must satisfy the killed run's gap) ----
    t2 = str(tmp_path / "t2")
    cfg2 = RunConfig(model="farmer", num_scens=3, algo=algo,
                     spokes=[], rel_gap=killed_gap * (1 + 1e-6),
                     wheel_deadline=600.0, resume_from=ck,
                     telemetry_dir=t2, device="cpu")
    try:
        hub2 = spin_the_wheel_processes(cfg2, join_timeout=180.0)
    finally:
        obs.shutdown()
    assert hub2.opt._iter < killed_iter
    assert hub2.BestOuterBound >= hub.BestOuterBound - 1e-6
    assert hub2.BestInnerBound <= hub.BestInnerBound + 1e-6
    outs = [v for _, k, _, v in hub2.bound_events if k == "outer"]
    inns = [v for _, k, _, v in hub2.bound_events if k == "inner"]
    assert outs == sorted(outs)
    assert inns == sorted(inns, reverse=True)
    r = analyze.load_run(t2)
    ckd = analyze.checkpoint_summary(r)
    assert ckd is not None and ckd["resumed"]
    assert "== checkpoint ==" in analyze.render_report(r)
    c1 = analyze.checkpoint_summary(analyze.load_run(t1))
    assert c1["preempted"] and c1["captures"] >= 1
    assert "preempt" in c1["reasons"]

    # ---- corrupt bundle: cold start, reasoned event, no crash ----
    b = bundle.latest_bundle(ck)
    with open(os.path.join(b, "hub.npz"), "r+b") as f:
        f.truncate(20)
    t3 = str(tmp_path / "t3")
    cfg3 = RunConfig(
        model="farmer", num_scens=3,
        algo=AlgoConfig(default_rho=1.0, max_iterations=2,
                        convthresh=-1.0, subproblem_max_iter=2000,
                        subproblem_eps=1e-7),
        spokes=[], resume_from=b, telemetry_dir=t3, device="cpu")
    try:
        hub3 = spin_the_wheel_processes(cfg3, join_timeout=60.0)
    finally:
        obs.shutdown()
    assert math.isfinite(hub3.BestOuterBound)   # cold trivial seed
    rej = [json.loads(ln) for ln in open(os.path.join(t3, "events.jsonl"))
           if json.loads(ln).get("type") == "ckpt.resume_rejected"]
    assert rej and rej[0]["reason"] == "truncated"


# ---------------- warm respawn ----------------

def test_respawn_resumes_spoke_from_checkpoint(tmp_path):
    """The supervisor hands the latest checkpoint to the respawned
    generation: a respawned Lagrangian spoke's first published bound is
    no worse than its pre-crash best (it IS the pre-crash best,
    re-published by resume_publish). The crash fires on publish #2, so
    generation 0 only lands its prep bound, whose gap can never satisfy
    rel_gap = 0.05: termination needs the respawned generation."""
    from mpisppy_tpu_torch.utils.multiproc import spin_the_wheel_processes

    ck = str(tmp_path / "ckpt")
    tdir = str(tmp_path / "run")
    cfg = RunConfig(
        model="farmer", num_scens=3,
        algo=AlgoConfig(default_rho=1.0, max_iterations=50000,
                        convthresh=-1.0, subproblem_max_iter=2000,
                        subproblem_eps=1e-7),
        spokes=[SpokeConfig(
            kind="lagrangian",
            options={"fault_plan": {"spokes": {"0": [
                {"action": "crash", "at_update": 2}]}}}),
            SpokeConfig(kind="xhatshuffle")],
        rel_gap=0.05, wheel_deadline=600.0,
        supervisor={"respawn_backoff": 0.1, "max_respawns": 3},
        checkpoint_dir=ck, telemetry_dir=tdir, device="cpu")
    try:
        hub = spin_the_wheel_processes(cfg, join_timeout=180.0)
        assert not hub._watchdog_fired
        assert hub.supervisor.health[0].gen >= 1    # it did respawn
        assert hub.BestOuterBound <= EF3 + 2.0
        assert hub.BestInnerBound >= EF3 - 2.0
    finally:
        obs.shutdown()
    g0 = [json.loads(ln) for ln in
          open(os.path.join(tdir, "events-spoke0-lagrangian.jsonl"))]
    g1 = [json.loads(ln) for ln in
          open(os.path.join(tdir, "events-spoke0-lagrangian-r1.jsonl"))]
    pre_crash = [e["value"] for e in g0 if e.get("type") == "spoke.bound"]
    resumed = [e["value"] for e in g1 if e.get("type") == "spoke.bound"]
    assert pre_crash and resumed
    assert resumed[0] >= max(pre_crash) - 1e-9
    assert any(e.get("type") == "ckpt.spoke_resume" for e in g1)


# ---------------- spoke-state capture cadence ----------------

def test_bound_spoke_checkpoints_best_not_last(tmp_path, mem_obs):
    from mpisppy_tpu_torch.cylinders.spcommunicator import Window
    from mpisppy_tpu_torch.cylinders.spoke import OuterBoundSpoke

    class _Opt:
        options = {}

        class batch:
            S, K = 3, 4

    sp = OuterBoundSpoke(_Opt(), options={
        "checkpoint_dir": str(tmp_path), "checkpoint_index": 0,
        "checkpoint_kind": "lagrangian"})
    sp.my_window = Window(sp.local_window_length())
    for v in (-115000.0, -112000.0, -114000.0):     # best is -112000
        sp.update_bound(v)
    st = spoke_state.load_spoke_state(
        spoke_state.spoke_state_path(str(tmp_path), 0), "OuterBoundSpoke")
    assert st["bound"] == -112000.0
    sp2 = OuterBoundSpoke(_Opt(), options={
        "resume_state": spoke_state.spoke_state_path(str(tmp_path), 0)})
    sp2.my_window = Window(sp2.local_window_length())
    sp2.resume_publish()
    assert sp2.bound == -112000.0
    values, wid = sp2.my_window.read()
    assert wid == 1 and values[0] == -112000.0
    assert _count("ckpt.spoke_resumed") == 1


# ---------------- the in-process wheel: SIGTERM and resume ----------

def test_sigterm_in_process_wheel_leaves_preempt_bundle(tmp_path, mem_obs):
    """The in-process wheel (utils/sputils) with checkpoints armed and a
    hub fault plan: the ``preempt`` spec sends this process a real
    SIGTERM, whose handler captures a ``preempt`` bundle that LATEST
    names at that moment, stops the wheel and leaves no spoke thread;
    the handler is restored afterwards. A wheel resumed from that
    directory books both spokes' resumes."""
    import signal
    import threading

    from mpisppy_tpu_torch.utils.sputils import spin_the_wheel
    from mpisppy_tpu_torch.utils.vanilla import wheel_dicts

    ck = str(tmp_path / "ck")
    base = dict(model="farmer", num_scens=3,
                algo=AlgoConfig(default_rho=10.0, max_iterations=6,
                                convthresh=-1.0, subproblem_max_iter=4000),
                spokes=[SpokeConfig(kind="lagrangian"),
                        SpokeConfig(kind="xhatshuffle")], device="cpu")
    seen = {}

    def arm(hub):
        faults.install_hub_faults(
            hub, {"hub": [{"action": "preempt", "at_iteration": 2}]})
        orig = hub.handle_preemption

        def preempted(source="sigterm"):
            orig(source)
            latest = bundle.latest_bundle(ck)
            seen["reason"] = json.load(open(os.path.join(
                latest, "manifest.json")))["reason"]
            seen["iter"] = hub.opt._iter
        hub.handle_preemption = preempted

    before = signal.getsignal(signal.SIGTERM)
    wheel = spin_the_wheel(*wheel_dicts(RunConfig(**base,
                                                  checkpoint_dir=ck)),
                           register_hub=arm)
    assert signal.getsignal(signal.SIGTERM) == before
    assert wheel.hub._preempted and seen == {"reason": "preempt",
                                             "iter": 2}
    assert wheel.hub.opt._iter == 2
    assert not [t for t in threading.enumerate()
                if t.name.startswith("spoke") and t.is_alive()]
    assert _count("hub.preempted") == 1
    resumed = spin_the_wheel(*wheel_dicts(RunConfig(
        **dict(base, algo=AlgoConfig(default_rho=10.0, max_iterations=1,
                                     convthresh=-1.0,
                                     subproblem_max_iter=4000)),
        resume_from=ck)))
    assert _count("ckpt.resumed") == 1
    assert _count("ckpt.spoke_resumed") == 2
    assert resumed.hub.BestOuterBound >= wheel.hub.BestOuterBound
    assert resumed.hub.BestInnerBound <= wheel.hub.BestInnerBound


def test_hub_refuses_checkpoints_of_a_sharded_engine():
    """A hub engine sharded over ranks cannot take checkpoints yet
    (ROADMAP.md A8b): the configuration and the hub refuse, naming it.
    The sharded APH wheel refuses them too."""
    from mpisppy_tpu_torch.core.aph_shard import spin_aph_shard_wheel
    from mpisppy_tpu_torch.utils.vanilla import refuse_unported

    with pytest.raises(NotImplementedError, match="ROADMAP.md A8b"):
        refuse_unported(RunConfig(mesh_devices=2, checkpoint_dir="d",
                                  device="cpu"))

    class _Sharded:
        shard_mesh = object()
        options = {}
    for key in ("checkpoint_dir", "resume_from"):
        with pytest.raises(NotImplementedError, match="ROADMAP.md A8b"):
            Hub(_Sharded(), spokes=[], options={key: "d"})
    with pytest.raises(NotImplementedError, match="ROADMAP.md A8b"):
        spin_aph_shard_wheel(RunConfig(hub="aph", checkpoint_dir="d",
                                       device="cpu"), n_shards=2)


# ---------------- bundles across the packages ----------------

_UC_KW = {"num_gens": 3, "num_hours": 6}
# solves converged to subproblem_eps (the band of the resume test
# assumes it; a fixed 400-step budget would make the continued run
# depend on the cold solver states of the resumed engine)
_UC_OPTS = {"defaultPHrho": 100.0, "convthresh": -1.0,
            "subproblem_max_iter": 4000, "subproblem_eps": 1e-7}
_FARMER_OPTS = {"defaultPHrho": 1.0, "convthresh": -1.0,
                "subproblem_max_iter": 2000, "subproblem_eps": 1e-7}


def _cfg_fields(model):
    if model == "uc":
        return dict(model="uc", num_scens=3, model_kwargs=dict(_UC_KW))
    return dict(model="farmer", num_scens=3)


def _wheel(pkg, model, iters, **ckpt):
    """One package's hub-only wheel (its vanilla.wheel_dicts and
    sputils.spin_the_wheel) for ``iters`` PH iterations; returns the
    hub engine."""
    opts = dict(_UC_OPTS if model == "uc" else _FARMER_OPTS,
                PHIterLimit=iters)
    if pkg == "jax":
        from mpisppy_tpu.utils.config import RunConfig as Cfg
        from mpisppy_tpu.utils.sputils import spin_the_wheel as spin
        from mpisppy_tpu.utils.vanilla import wheel_dicts as dicts
        extra = {}
    else:
        Cfg = RunConfig
        from mpisppy_tpu_torch.utils.sputils import spin_the_wheel as spin
        from mpisppy_tpu_torch.utils.vanilla import wheel_dicts as dicts
        extra = {"device": "cpu"}
    cfg = Cfg(**_cfg_fields(model), hub_options=opts, **ckpt, **extra)
    cfg.algo.max_iterations = iters
    wheel = spin(*dicts(cfg))
    return wheel.hub.opt


def _host(a):
    return a.detach().cpu().numpy() if hasattr(a, "detach") \
        else np.asarray(a)


@pytest.mark.parametrize("model", ["farmer", "uc"])
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_bundle_crosses_packages(model, direction, tmp_path):
    """A bundle written by one package's wheel resumes the other's: the
    two packages fingerprint the configuration the same (the resume is
    not refused), the installed (W, x̄, x̄², ρ) are bit-equal to the
    source engine's, and the continued run agrees with the other
    package's uninterrupted run at tests/test_extensions.py:259's band
    (atol 1e-4 x scale, rtol 1e-5)."""
    k, extra = 3, 3
    ck = str(tmp_path / "ck")
    src_pkg, dst_pkg = direction.split("_to_")
    src = _wheel(src_pkg, model, k, checkpoint_dir=ck)
    manifest, arrays, _ = bundle.load_bundle(ck)
    for key in ("W", "xbar", "xsqbar", "rho"):
        np.testing.assert_array_equal(arrays[key],
                                      _host(getattr(src, key)))
    # read the state the resume installed, before the continued run
    from importlib import import_module
    installed = {}
    wx = import_module(("mpisppy_tpu_torch" if dst_pkg == "port"
                        else "mpisppy_tpu") + ".extensions.wxbar_io")
    real = wx.install_state_arrays

    def spy(opt, d):
        real(opt, d)
        installed.update({key: _host(getattr(opt, key)).copy()
                          for key in ("W", "xbar", "xsqbar", "rho")})
        installed["iter"] = opt._iter
    wx.install_state_arrays = spy
    try:
        dst = _wheel(dst_pkg, model, extra, resume_from=ck)
    finally:
        wx.install_state_arrays = real
    assert installed, "the bundle was refused"
    assert installed["iter"] == manifest["iter"] == k
    for key in ("W", "xbar", "xsqbar", "rho"):
        np.testing.assert_array_equal(installed[key], arrays[key])
    full = _wheel(src_pkg, model, k + extra)
    scale = float(np.abs(_host(full.xbar)).max())
    np.testing.assert_allclose(_host(dst.xbar), _host(full.xbar),
                               atol=1e-4 * scale, rtol=1e-5)
    np.testing.assert_allclose(_host(dst.W), _host(full.W),
                               atol=1e-4 * scale, rtol=1e-5)


def test_profile_fingerprint_is_the_bundle_one():
    """obs/profile keys its shape buckets by ckpt/bundle's
    config_fingerprint (one body in the port, as in the JAX package),
    and the bucket ids are what they were: the 16-hex sha256 of the
    canonical JSON, equal to the JAX package's ids of the same
    buckets."""
    import hashlib

    from mpisppy_tpu.obs.profile import _fingerprint as jax_bucket_id
    from mpisppy_tpu_torch.obs import profile
    assert profile.config_fingerprint is bundle.config_fingerprint
    for entry, key in (("kernel.cuda", (10, 26016, 13056, 1500)),
                       ("qp.solve", ("f", "i", 3)),
                       ("ph.iteration", ())):
        fields = {"entry": entry, "key": [str(k) for k in key]}
        want = hashlib.sha256(json.dumps(fields, sort_keys=True).encode(
            "utf-8")).hexdigest()[:16]
        assert profile.config_fingerprint(fields) == want
        assert jax_bucket_id(entry, key) == want
