"""The port's supervised wheel and fault plans (mpisppy_tpu_torch/
testing/faults.py, cylinders/supervisor.py, the hub's ingest
validation, the wheel watchdog) at the bars of the JAX package's
tests/test_faults.py: the 22 cases on the port, the process wheels on
the CPU (``device="cpu"``), and the clean path's import check in a
fresh interpreter with jax and mpisppy_tpu poisoned.
"""

import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import pytest

from mpisppy_tpu_torch import obs
from mpisppy_tpu_torch.cylinders.hub import Hub
from mpisppy_tpu_torch.cylinders.spcommunicator import (LINEAGE_SLOTS,
                                                        Window,
                                                        wire_payload)
from mpisppy_tpu_torch.cylinders.spoke import ConvergerSpokeType
from mpisppy_tpu_torch.cylinders import supervisor as sup_mod
from mpisppy_tpu_torch.cylinders.supervisor import WheelSupervisor
from mpisppy_tpu_torch.testing import faults
from mpisppy_tpu_torch.utils.config import AlgoConfig, RunConfig, SpokeConfig
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EF3 = -108390.0


def _counter(name):
    return obs.counters_snapshot().get(name, 0)


# ---------------- test doubles ----------------

class _Opt:
    """Minimal weakref-able engine stand-in for communicator tests."""

    def __init__(self):
        self.options = {}


class _FakeSpoke:
    """Proxy-shaped spoke: classification surface + window pair.
    ``publish`` stamps the bound-flow lineage suffix exactly like
    ``Spoke.spoke_to_hub`` (the on-wire format is payload + 3 lineage
    doubles — spcommunicator.wire_payload)."""

    def __init__(self, types=(ConvergerSpokeType.OUTER_BOUND,),
                 char="O", length=1):
        self.converger_spoke_types = types
        self.converger_spoke_char = char
        self.my_window = Window(length + LINEAGE_SLOTS)
        self.hub_window = Window(1)
        self._seq = 0

    def publish(self, values):
        self._seq += 1
        self.my_window.put(wire_payload(values, self._seq))


class _FakeProc:
    def __init__(self):
        self._alive = True
        self.exitcode = None
        self.pid = 4242

    def is_alive(self):
        return self._alive

    def terminate(self):
        self._alive = False
        self.exitcode = -15

    def join(self, timeout=None):
        pass


@pytest.fixture
def mem_obs():
    """In-memory telemetry session (events tail + counters)."""
    rec = obs.configure(out_dir=None)
    yield rec
    obs.shutdown()


def _events(rec, etype):
    return [e for _, e in obs.events(etype)]


# ---------------- fault-plan harness (pure logic) ----------------

def test_fault_plan_validation():
    faults.validate_plan({"seed": 1, "spokes": {"0": [
        {"action": "crash", "at_update": 1},
        {"action": "corrupt", "from_update": 2, "value": "garbage"},
        {"action": "delay_hello", "seconds": 0.5},
        {"action": "hang", "after_s": 1.0, "gen": 1}]}})
    with pytest.raises(ValueError):
        faults.validate_plan({"spokes": {"0": [{"action": "explode"}]}})
    with pytest.raises(ValueError):
        faults.validate_plan({"spokes": {"0": [
            {"action": "crash", "at_iteration": 3}]}})
    with pytest.raises(ValueError):
        faults.validate_plan({"typo": {}})
    with pytest.raises(ValueError):
        faults.validate_plan({"spokes": {"0": [
            {"action": "corrupt", "value": "purple"}]}})


def test_fault_injector_resolution_and_gen_scoping():
    plan = {"spokes": {"0": [{"action": "crash", "at_update": 1},
                             {"action": "hang", "after_s": 9, "gen": 1}]}}
    # JSON string specs parse identically to dicts
    inj = faults.FaultInjector.from_spec(json.dumps(plan), index=0)
    assert [s["action"] for s in inj.specs] == ["crash"]
    # gen 1 sees only its own specs — a respawned incarnation runs
    # clean of the crash that killed gen 0
    inj1 = faults.FaultInjector.from_spec(plan, index=0, gen=1)
    assert [s["action"] for s in inj1.specs] == ["hang"]
    # other spokes get nothing
    assert faults.FaultInjector.from_spec(plan, index=1).specs == []


def test_fault_crash_trigger_is_exact_and_before_write(monkeypatch):
    killed = []
    monkeypatch.setattr(faults.os, "kill",
                        lambda pid, sig: killed.append((pid, sig)))
    monkeypatch.setattr(faults.os, "_exit",
                        lambda code: (_ for _ in ()).throw(SystemExit))
    inj = faults.FaultInjector.from_spec(
        {"spokes": {"0": [{"action": "crash", "at_update": 2}]}}, index=0)
    assert inj.on_publish(np.array([1.0]))[0] == 1.0
    with pytest.raises(SystemExit):
        inj.on_publish(np.array([2.0]))    # the write never happens
    assert killed and killed[0][1] == faults.signal.SIGKILL


def test_fault_corrupt_values_deterministic():
    spec = {"seed": 11, "spokes": {"0": [
        {"action": "corrupt", "from_update": 1, "value": "garbage"}]}}
    a = faults.FaultInjector.from_spec(spec, index=0)
    b = faults.FaultInjector.from_spec(spec, index=0)
    va = [a.on_publish(np.zeros(3)) for _ in range(3)]
    vb = [b.on_publish(np.zeros(3)) for _ in range(3)]
    for x, y in zip(va, vb):
        np.testing.assert_array_equal(x, y)
    # inf / nan / literal corruption
    for val, check in (("inf", lambda v: np.isposinf(v).all()),
                       ("nan", lambda v: np.isnan(v).all()),
                       (-7.5, lambda v: (v == -7.5).all())):
        inj = faults.FaultInjector.from_spec(
            {"spokes": {"0": [{"action": "corrupt", "from_update": 1,
                               "value": val}]}}, index=0)
        assert check(inj.on_publish(np.zeros(2)))


def test_fault_hang_trigger(monkeypatch):
    hung = []
    inj = faults.FaultInjector.from_spec(
        {"spokes": {"0": [{"action": "hang", "after_s": 0.0}]}}, index=0)
    monkeypatch.setattr(inj, "_hang", lambda: hung.append(True))
    inj.on_poll()
    assert hung


def test_clean_path_never_imports_testing(tmp_path):
    """THE zero-overhead contract: importing (and wiring) the whole
    multi-process wheel machinery must not import
    mpisppy_tpu_torch.testing — the fault harness exists only in
    children given an explicit plan (and in the hub process under the
    environment variable)."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['mpisppy_tpu'] = None\n"
        "import mpisppy_tpu_torch.utils.multiproc\n"
        "import mpisppy_tpu_torch.utils.sputils\n"
        "import mpisppy_tpu_torch.utils.vanilla\n"
        "import mpisppy_tpu_torch.cylinders.hub\n"
        "import mpisppy_tpu_torch.cylinders.supervisor\n"
        "import mpisppy_tpu_torch.cylinders.spoke\n"
        "import mpisppy_tpu_torch.ckpt\n"
        "import mpisppy_tpu_torch.__main__\n"
        "bad = [m for m in sys.modules if m.startswith("
        "'mpisppy_tpu_torch.testing')]\n"
        "assert not bad, bad\n"
        "print('CLEAN')\n")
    env = {**os.environ, "PYTHONPATH": REPO}
    env.pop("MPISPPY_TPU_FAULT_PLAN", None)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "CLEAN" in out.stdout


# ---------------- hub ingest validation ----------------

def test_hub_refuses_nonfinite_bounds_directly(mem_obs):
    hub = Hub(_Opt(), spokes=[])
    assert not hub.OuterBoundUpdate(math.inf)
    assert not hub.OuterBoundUpdate(math.nan)
    assert not hub.InnerBoundUpdate(-math.inf)
    assert hub.BestOuterBound == -math.inf
    assert hub.BestInnerBound == math.inf
    # the poison scenario of the issue: a +inf outer bound must not
    # freeze the gap at inf
    assert hub.OuterBoundUpdate(-110.0) and hub.InnerBoundUpdate(-100.0)
    ag, rg = hub.compute_gaps()
    assert math.isfinite(ag) and math.isfinite(rg)
    assert _counter("hub.bound_rejected") == 2  # the two infs


def test_receive_bounds_quarantines_inf_and_crossed(mem_obs):
    outer = _FakeSpoke((ConvergerSpokeType.OUTER_BOUND,), "O")
    inner = _FakeSpoke((ConvergerSpokeType.INNER_BOUND,), "I")
    hub = Hub(_Opt(), spokes=[outer, inner])
    hub.classify_spokes()
    # startup hello: all-NaN consumed silently
    outer.my_window.put(np.full(1 + LINEAGE_SLOTS, np.nan))
    hub.receive_bounds()
    assert hub.BestOuterBound == -math.inf
    assert _counter("hub.bound_rejected") == 0
    # +inf payload: rejected, gap machinery untouched
    outer.publish(np.array([np.inf]))
    hub.receive_bounds()
    assert hub.BestOuterBound == -math.inf
    # legit inner, then a crossed outer (above inner + tol): rejected
    inner.publish(np.array([-100.0]))
    hub.receive_bounds()
    outer.publish(np.array([-99.5]))
    hub.receive_bounds()
    assert hub.BestOuterBound == -math.inf
    # a legit outer lands fine
    outer.publish(np.array([-100.8]))
    hub.receive_bounds()
    assert hub.BestOuterBound == -100.8
    assert _counter("hub.bound_rejected") == 2
    assert _counter("hub.bound_crossed") == 1
    evs = _events(mem_obs, "hub.bound_rejected")
    assert [e["reason"] for e in evs] == ["nonfinite", "crossed"]
    assert all(e["spoke"] == 0 for e in evs)
    # and noise-level crossings (2e-6 rel, the healthy-wheel case) are
    # NOT flagged as corruption
    outer.publish(np.array([-100.0 + 2e-6 * 100.0]))
    hub.receive_bounds()
    assert hub.BestOuterBound > -100.001
    assert _counter("hub.bound_crossed") == 1


def test_finite_garbage_rejected_before_it_can_poison(mem_obs):
    """The arrival-order poisoning hole: finite garbage (the
    injector's 'garbage' mode emits ~1e30) arriving while the
    opposite side is still unset must NOT install — it would turn the
    crossed-bound firewall against every legitimate bound that
    follows."""
    inner = _FakeSpoke((ConvergerSpokeType.INNER_BOUND,), "I")
    outer = _FakeSpoke((ConvergerSpokeType.OUTER_BOUND,), "O")
    hub = Hub(_Opt(), spokes=[inner, outer])
    hub.classify_spokes()
    inner.publish(np.array([-1e30]))      # garbage "incumbent"
    hub.receive_bounds()
    assert hub.BestInnerBound == math.inf       # rejected, not installed
    evs = _events(mem_obs, "hub.bound_rejected")
    assert evs[-1]["reason"] == "implausible"
    # legitimate traffic flows unharmed afterwards
    inner.publish(np.array([-100.0]))
    outer.publish(np.array([-110.0]))
    hub.receive_bounds()
    assert hub.BestInnerBound == -100.0 and hub.BestOuterBound == -110.0
    assert _counter("hub.bound_crossed") == 0


def test_crossed_rejection_does_not_blame_the_sender(mem_obs):
    """A crossed conflict proves SOME bound is corrupt but cannot
    attribute which — it must be flagged, but must not count toward
    quarantining the (possibly healthy) sender."""
    outer = _FakeSpoke((ConvergerSpokeType.OUTER_BOUND,), "O")
    inner = _FakeSpoke((ConvergerSpokeType.INNER_BOUND,), "I")
    hub = Hub(_Opt(), spokes=[outer, inner])
    hub.classify_spokes()
    sup = WheelSupervisor(hub.spokes, [_FakeProc(), _FakeProc()],
                          kinds=["lagrangian", "xhatshuffle"],
                          options={"max_rejections": 2,
                                   "poll_interval": 0.0})
    sup.attach(hub)
    inner.publish(np.array([-100.0]))
    hub.receive_bounds()
    for _ in range(3):                      # crossed payloads galore
        outer.publish(np.array([-99.0]))
        hub.receive_bounds()
    assert _counter("hub.bound_crossed") == 3
    assert sup.state(0) == sup_mod.RUNNING  # sender NOT quarantined
    # unambiguous garbage still counts toward quarantine
    for _ in range(2):
        outer.publish(np.array([np.inf]))
        hub.receive_bounds()
    assert sup.state(0) == sup_mod.QUARANTINED


def test_dual_window_validates_both_sides(mem_obs):
    ef = _FakeSpoke((ConvergerSpokeType.OUTER_BOUND,
                     ConvergerSpokeType.INNER_BOUND), "E", length=2)
    hub = Hub(_Opt(), spokes=[ef])
    hub.classify_spokes()
    ef.publish(np.array([np.inf, -100.0]))
    hub.receive_bounds()
    assert hub.BestOuterBound == -math.inf      # inf side rejected
    assert hub.BestInnerBound == -100.0         # finite side installed
    assert _counter("hub.bound_rejected") == 1


def test_rejections_quarantine_the_spoke(mem_obs):
    outer = _FakeSpoke((ConvergerSpokeType.OUTER_BOUND,), "O")
    hub = Hub(_Opt(), spokes=[outer])
    hub.classify_spokes()
    sup = WheelSupervisor(hub.spokes, [_FakeProc()], kinds=["lagrangian"],
                          options={"max_rejections": 3,
                                   "poll_interval": 0.0})
    sup.attach(hub)
    for _ in range(3):
        outer.publish(np.array([np.inf]))
        hub.receive_bounds()
    assert sup.state(0) == sup_mod.QUARANTINED
    assert 0 not in hub.outer_bound_spoke_indices
    # the poisonous-but-alive spoke was released via its kill signal
    assert outer.hub_window.read_id() == Window.KILL
    assert _counter("hub.spoke_quarantined") == 1


# ---------------- supervisor state machine ----------------

def _make_supervised(mem_obs, n=2, **opts):
    spokes = [_FakeSpoke((ConvergerSpokeType.OUTER_BOUND,), "O")
              for _ in range(n)]
    procs = [_FakeProc() for _ in range(n)]
    hub = Hub(_Opt(), spokes=spokes)
    hub.classify_spokes()
    spawned = []

    def respawner(i, gen):
        spawned.append((i, gen))
        return (_FakeSpoke((ConvergerSpokeType.OUTER_BOUND,), "O"),
                _FakeProc())

    options = {"poll_interval": 0.0, "respawn_backoff": 0.01,
               "respawn_backoff_cap": 0.05, **opts}
    sup = WheelSupervisor(spokes, procs, kinds=["lagrangian"] * n,
                          options=options, respawner=respawner, owned=[])
    sup.attach(hub)
    return hub, sup, spokes, procs, spawned


def test_supervisor_respawns_dead_spoke(mem_obs):
    hub, sup, spokes, procs, spawned = _make_supervised(mem_obs)
    hub._spoke_last_ids[0] = 7
    procs[0]._alive = False
    procs[0].exitcode = -9
    sup.poll()
    assert sup.state(0) == sup_mod.DOWN
    time.sleep(0.02)
    sup.poll()
    assert sup.state(0) == sup_mod.RUNNING
    assert spawned == [(0, 1)]
    # the hub's OWN spoke list (Hub.__init__ copies it) carries the
    # fresh proxy — sends/receives see the new window pair, and
    # freshness was reset so the respawned hello is consumed
    assert hub.spokes[0] is not spokes[0]
    assert sup.spokes is hub.spokes
    assert hub._spoke_last_ids[0] == 0
    assert _counter("hub.spoke_down") == 1
    assert _counter("hub.spoke_respawn") == 1
    down = _events(mem_obs, "hub.spoke_down")[0]
    assert down["reason"] == "died" and down["exitcode"] == -9


def test_supervisor_quarantines_after_max_respawns(mem_obs):
    hub, sup, spokes, procs, spawned = _make_supervised(
        mem_obs, max_respawns=1)
    for _ in range(2):
        procs[0]._alive = False
        sup.poll()                  # detect
        time.sleep(0.03)
        sup.poll()                  # respawn / quarantine
    assert sup.state(0) == sup_mod.QUARANTINED
    assert spawned == [(0, 1)]      # second crash exceeded the budget
    assert 0 not in hub.outer_bound_spoke_indices
    assert 1 in hub.outer_bound_spoke_indices       # survivor untouched
    assert _counter("hub.spoke_quarantined") == 1
    q = _events(mem_obs, "hub.spoke_quarantined")[0]
    assert q["cause"] == "crashes" and q["spoke"] == 0


def test_supervisor_heartbeat_stall_detection(mem_obs):
    hub, sup, spokes, procs, spawned = _make_supervised(
        mem_obs, n=1, heartbeat_timeout=0.02)
    sup.poll()                      # baseline
    spokes[0].publish(np.array([1.0]))
    sup.poll()                      # progress observed
    time.sleep(0.05)
    sup.poll()                      # frozen past the timeout
    assert sup.state(0) == sup_mod.DOWN
    assert not procs[0].is_alive()  # hung process was terminated
    assert _events(mem_obs, "hub.spoke_down")[0]["reason"] == "stalled"
    time.sleep(0.02)
    sup.poll()
    assert sup.state(0) == sup_mod.RUNNING and spawned == [(0, 1)]


def test_supervisor_closed_never_respawns(mem_obs):
    hub, sup, spokes, procs, spawned = _make_supervised(mem_obs, n=1)
    sup.shutdown()
    procs[0]._alive = False
    sup.poll()
    assert spawned == [] and sup.state(0) == sup_mod.RUNNING


# ---------------- wheel watchdog ----------------

def test_hub_deadline_fires_watchdog_once(mem_obs):
    spoke = _FakeSpoke()
    hub = Hub(_Opt(), spokes=[spoke], options={"wheel_deadline": 0.01})
    hub.classify_spokes()
    assert not hub.determine_termination()      # young wheel: no fire
    hub._wheel_t0 -= 1.0
    assert hub.determine_termination() is True
    assert hub._watchdog_fired
    assert spoke.hub_window.read_id() == Window.KILL
    assert hub.determine_termination() is True  # latched
    assert _counter("hub.watchdog_fired") == 1
    ev = _events(mem_obs, "hub.watchdog_fired")[0]
    assert ev["source"] == "hub" and ev["elapsed"] >= 1.0


def test_supervisor_watchdog_timer_thread(mem_obs):
    spoke = _FakeSpoke()
    hub = Hub(_Opt(), spokes=[spoke])
    hub.classify_spokes()
    sup = WheelSupervisor([spoke], [_FakeProc()], kinds=["lagrangian"])
    sup.attach(hub)
    sup.start_watchdog(0.02)
    # the once-guard flag is raised BEFORE the terminate signal goes
    # out, so wait on the kill id — the last effect of the fire
    deadline = time.monotonic() + 5.0
    while spoke.hub_window.read_id() != Window.KILL \
            and time.monotonic() < deadline:
        time.sleep(0.01)
    assert hub._watchdog_fired
    assert spoke.hub_window.read_id() == Window.KILL
    assert _events(mem_obs, "hub.watchdog_fired")[0]["source"] \
        == "supervisor"
    sup.shutdown()


def test_watchdog_cancelled_by_shutdown(mem_obs):
    hub = Hub(_Opt(), spokes=[])
    sup = WheelSupervisor([], [], kinds=[])
    sup.attach(hub)
    sup.start_watchdog(0.05)
    sup.shutdown()
    time.sleep(0.1)
    assert not hub._watchdog_fired


# ---------------- the live degraded wheel (tier-1 acceptance) --------

def test_sigkill_spoke_respawn_wheel(tmp_path):
    """THE acceptance wheel: a real spawn-context farmer wheel whose
    Lagrangian spoke SIGKILLs itself (deterministic fault plan) before
    its first bound publish. The supervisor must detect the death,
    respawn the spoke on a fresh window pair, and the wheel must close
    the gap from the respawned spoke's bounds — then ``analyze``
    renders the degraded-run section from the telemetry."""
    from mpisppy_tpu_torch.obs import analyze
    from mpisppy_tpu_torch.utils.multiproc import spin_the_wheel_processes

    tdir = str(tmp_path / "run")
    cfg = RunConfig(
        model="farmer", num_scens=3,
        algo=AlgoConfig(default_rho=1.0, max_iterations=50000,
                        convthresh=-1.0, subproblem_max_iter=2000,
                        subproblem_eps=1e-7),
        spokes=[SpokeConfig(
            kind="lagrangian",
            options={"fault_plan": {"spokes": {"0": [
                {"action": "crash", "at_update": 1}]}}}),
            SpokeConfig(kind="xhatshuffle")],
        rel_gap=0.05,
        wheel_deadline=600.0,       # backstop: a busted respawn fails
        supervisor={"respawn_backoff": 0.1, "max_respawns": 3},
        telemetry_dir=tdir, device="cpu",
    )
    try:
        hub = spin_the_wheel_processes(cfg, join_timeout=180.0)
        # the wheel completed on gap with bounds from the RESPAWNED
        # Lagrangian (gen 0 died before publishing anything) + the
        # surviving xhat spoke
        assert not hub._watchdog_fired
        assert hub.BestOuterBound <= EF3 + 2.0
        assert hub.BestInnerBound >= EF3 - 2.0
        assert hub.BestOuterBound <= hub.BestInnerBound \
            + 1e-5 * abs(hub.BestInnerBound)
        assert _counter("hub.spoke_down") >= 1
        assert _counter("hub.spoke_respawn") >= 1
        assert _counter("hub.spoke_quarantined") == 0
        assert hub.supervisor.state(0) == sup_mod.RUNNING
        # (the parent-side zero-import contract is covered by
        # test_clean_path_never_imports_testing in a fresh interpreter
        # — this module imports faults itself, so sys.modules here
        # proves nothing)
    finally:
        obs.shutdown()
    # events landed in the hub's stream
    types = [json.loads(ln).get("type")
             for ln in open(os.path.join(tdir, "events.jsonl"),
                            encoding="utf-8")]
    assert "hub.spoke_down" in types and "hub.spoke_respawn" in types
    # the respawned incarnation captured under its gen-suffixed role
    assert os.path.exists(
        os.path.join(tdir, "events-spoke0-lagrangian-r1.jsonl"))
    # analyze renders the degraded-run section + WARN invariant stays
    # green (downs+respawns degrade, but nothing was quarantined)
    rc = analyze.main([tdir])
    assert rc == 0
    # the bound-flow section renders a per-spoke verdict on the
    # FAULT-INJECTED wheel too: the respawned
    # Lagrangian published and was consumed -> its bounds closed the
    # gap, so neither spoke may read REJECTED
    r = analyze.load_run(tdir)
    bf = analyze.bound_flow_summary(r)
    assert bf is not None and len(bf) >= 2
    rep = analyze.render_report(r)
    assert "== bound flow ==" in rep
    for label, ent in bf.items():
        assert ent["verdict"] in ("HEALTHY", "SLOW", "STARVED",
                                  "REJECTED"), ent
    lag = bf.get("spoke0", {})
    assert lag.get("consumed", 0) >= 1      # respawned gen was consumed
    assert lag.get("verdict") != "REJECTED"
    # spoke-side publish truth was merged across generations (the
    # gen-1 role artifacts carry the respawned incarnation's updates)
    assert lag.get("published", 0) >= 1


def test_corrupt_payload_wheel_quarantines_spoke(tmp_path):
    """A live wheel whose Lagrangian publishes +inf from its first
    bound on: every payload is rejected, the spoke is quarantined
    after max_rejections, and the wheel finishes on the surviving
    spokes with the trivial outer seed intact (never inf)."""
    from mpisppy_tpu_torch.utils.multiproc import spin_the_wheel_processes

    cfg = RunConfig(
        model="farmer", num_scens=3,
        algo=AlgoConfig(default_rho=1.0, max_iterations=400,
                        convthresh=-1.0, subproblem_max_iter=2000,
                        subproblem_eps=1e-7),
        spokes=[SpokeConfig(
            kind="lagrangian",
            options={"fault_plan": {"spokes": {"0": [
                {"action": "corrupt", "from_update": 1,
                 "value": "inf"}]}}}),
            SpokeConfig(kind="xhatshuffle")],
        rel_gap=0.02,               # unreachable from the trivial seed
        supervisor={"max_rejections": 2},
        telemetry_dir=str(tmp_path / "run"), device="cpu",
    )
    try:
        hub = spin_the_wheel_processes(cfg, join_timeout=180.0)
        assert math.isfinite(hub.BestOuterBound)        # trivial seed held
        assert hub.BestInnerBound >= EF3 - 2.0
        assert _counter("hub.bound_rejected") >= 2
        assert _counter("hub.spoke_quarantined") >= 1
        assert hub.supervisor.state(0) == sup_mod.QUARANTINED
    finally:
        obs.shutdown()


def test_watchdog_terminates_hung_wheel(tmp_path):
    """A wheel that cannot close its gap (the only outer-bound spoke
    hangs) must be cleanly terminated by the wheel deadline: the run
    returns (no join-timeout hang), the watchdog event carries the
    partial bounds, and the telemetry was flushed."""
    from mpisppy_tpu_torch.utils.multiproc import spin_the_wheel_processes

    tdir = str(tmp_path / "run")
    cfg = RunConfig(
        model="farmer", num_scens=3,
        algo=AlgoConfig(default_rho=1.0, max_iterations=10 ** 6,
                        convthresh=-1.0, subproblem_max_iter=2000,
                        subproblem_eps=1e-7),
        spokes=[SpokeConfig(
            kind="lagrangian",
            options={"fault_plan": {"spokes": {"0": [
                {"action": "hang", "after_s": 0.0}]}}})],
        rel_gap=1e-9,               # unreachable
        # the JAX case's 30 s deadline and 20 s join, shortened: the
        # port's spoke child starts in seconds
        wheel_deadline=10.0,
        join_timeout=10.0,
        telemetry_dir=tdir, device="cpu",
    )
    t0 = time.monotonic()
    try:
        hub = spin_the_wheel_processes(cfg)
        assert hub._watchdog_fired
        assert time.monotonic() - t0 < 180.0
        assert _counter("hub.watchdog_fired") == 1
    finally:
        obs.shutdown()
    types = [json.loads(ln).get("type")
             for ln in open(os.path.join(tdir, "events.jsonl"),
                            encoding="utf-8")]
    assert "hub.watchdog_fired" in types
