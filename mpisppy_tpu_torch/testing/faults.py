"""Deterministic, seeded fault injection for cylinder wheels (the port's
copy of the JAX package's testing/faults.py).

The supervisor layer (cylinders/supervisor.py, doc/fault_tolerance.md)
exists to survive crashed, hung, and garbage-publishing spokes — faults
that are miserable to reproduce organically. This module makes them
reproducible: a *fault plan* names, per spoke index, exactly which
fault fires and when (the Nth bound publish, a wall-clock delay), so a
test can SIGKILL spoke 0 at its first publish on every run and assert
the same recovery path every time.

Activation is explicit and child-side only: `_spoke_worker` imports
this module IFF the spoke's options carry a ``fault_plan`` or the
``MPISPPY_TPU_FAULT_PLAN`` env var is set. A clean run never imports
it (asserted by tests/test_torch_faults.py), so production wheels pay zero
overhead — the injection points are plain instance-attribute wrappers
installed on one spoke object, not patches to the framework.

Fault-plan schema (dict, JSON string, or path to a JSON file)::

    {"seed": 42,                      # optional, default 0
     "spokes": {
       "0": [                         # spoke index (string or int keys)
         {"action": "crash",  "at_update": 1},        # SIGKILL self
         {"action": "crash",  "after_s": 3.0},        # ... on a timer
         {"action": "hang",   "after_s": 2.0},        # stop responding
         {"action": "delay_hello", "seconds": 5.0},   # late handshake
         {"action": "preempt", "at_update": 2},       # SIGTERM self
         {"action": "corrupt", "from_update": 2,      # poison payloads
          "value": "inf"}                             # inf|nan|garbage|float
       ]},
     "hub": [                         # the HUB process (wheel launcher)
       {"action": "preempt", "at_iteration": 5}       # preemption notice
     ],
     "serve": [                       # the SERVE process (serving fleet)
       {"action": "kill",    "after_s": 3.0},         # SIGKILL self
       {"action": "preempt", "at_wheel": 2},          # SIGTERM mid-wheel
       {"action": "wedge_wheel", "at_wheel": 1,       # hang a wheel past
        "seconds": 30.0},                             #  its deadline
       {"action": "tear_transfer", "at_transfer": 1}, # truncate a bundle
       {"action": "refuse_peer", "at_offer": 1},      # refuse a handoff
       {"action": "timeout_peer", "at_offer": 2,      # stall a handoff
        "seconds": 20.0}
     ]}

Triggers: ``at_update`` fires on exactly the Nth ``spoke_to_hub``
publish (1-based); ``from_update`` on every publish >= N; ``after_s``
on the first poll/publish after that many seconds from install;
``at_iteration`` (hub specs) on the first termination check at that
engine iteration. A spec may carry ``gen`` (default 0): faults apply
only to that incarnation of the spoke, so a respawned replacement
(gen 1) runs clean unless the plan says otherwise — the property the
respawn tests rely on.

``crash`` fires *before* the write (the poisoned value never lands);
``preempt`` delivers SIGTERM to the process' own pid — the preemption
notice: a checkpointing wheel's handler captures a final bundle and
terminates cleanly (doc/fault_tolerance.md), a bare spoke dies and is
respawned warm. ``corrupt`` replaces the payload and lets the write
proceed. ``garbage`` corruption values are drawn from a RandomState
keyed on (seed, spoke index, update number) — deterministic across
runs and processes.

Hub-side plans (the ``"hub"`` key) are installed by
``spin_the_wheel_processes`` when the ``MPISPPY_TPU_FAULT_PLAN`` env
var is set — same explicit-activation contract as the spoke side: the
clean path never imports this module.

Serve-side plans (the ``"serve"`` key) target the SERVING process
(serve/manager): ``kill``/``preempt`` die at the Nth wheel launch or on
a timer; ``wedge_wheel`` sleeps the Nth wheel for ``seconds`` — past
its deadline, the WheelDeadline watchdog fires exactly as for an
organically hung iteration; ``tear_transfer`` truncates the Nth
migration bundle member mid-stream (the receiver's sha256 gate refuses
it); ``refuse_peer``/``timeout_peer`` make this host's receiver
endpoint refuse or stall the Nth incoming offer. Installed by
``serve_main`` under the same env var (:class:`ServeFaultInjector`).
"""

from __future__ import annotations

import json
import os
import signal
import threading
import time

import numpy as np

_ACTIONS = ("crash", "hang", "delay_hello", "corrupt", "preempt")
_TRIGGERS = ("at_update", "from_update", "after_s", "seconds")
# hub specs trade the publish-count triggers for the iteration one:
# the hub has no spoke_to_hub, spokes have no engine iteration
_HUB_TRIGGERS = ("at_iteration", "after_s")
_VALUES = ("inf", "-inf", "nan", "garbage")
# service-level faults (the "serve" plan key): process kills, wedged
# wheels, torn migration transfers, refused/stalled peer endpoints
_SERVE_ACTIONS = ("kill", "preempt", "wedge_wheel", "tear_transfer",
                  "refuse_peer", "timeout_peer")
_SERVE_TRIGGERS = ("at_wheel", "at_transfer", "at_offer", "after_s",
                   "seconds")


def _load_spec(spec):
    """dict | JSON string | path-to-JSON-file -> plan dict."""
    if isinstance(spec, dict):
        return spec
    s = str(spec)
    if os.path.exists(s):
        with open(s, encoding="utf-8") as f:
            return json.load(f)
    return json.loads(s)


def validate_plan(plan: dict) -> dict:
    """Schema check (fail at install time, not mid-wheel)."""
    if not isinstance(plan, dict):
        raise ValueError(f"fault plan must be a dict, got {type(plan)}")
    unknown = set(plan) - {"seed", "spokes", "hub", "serve"}
    if unknown:
        raise ValueError(f"unknown fault-plan keys {sorted(unknown)}")

    def _check_specs(specs, triggers, actions=_ACTIONS):
        for sp in specs:
            act = sp.get("action")
            if act not in actions:
                raise ValueError(f"unknown fault action {act!r}; known: "
                                 f"{actions}")
            bad = set(sp) - {"action", "value", "gen", *triggers}
            if bad:
                raise ValueError(f"unknown fault-spec keys {sorted(bad)} "
                                 f"in {sp}")
            v = sp.get("value")
            if act == "corrupt" and v is not None \
                    and not isinstance(v, (int, float)) and v not in _VALUES:
                raise ValueError(f"corrupt value {v!r}; known: {_VALUES} "
                                 "or a number")

    for idx, specs in (plan.get("spokes") or {}).items():
        int(idx)            # keys must be spoke indices
        _check_specs(specs, _TRIGGERS)
    _check_specs(plan.get("hub") or [], _HUB_TRIGGERS)
    _check_specs(plan.get("serve") or [], _SERVE_TRIGGERS,
                 actions=_SERVE_ACTIONS)
    return plan


class FaultInjector:
    """The per-spoke fault machine: wraps ONE spoke instance's
    ``spoke_to_hub`` (publish-count triggers) and ``got_kill_signal``
    (time triggers) with the specs resolved for (index, gen)."""

    def __init__(self, specs, index=0, gen=0, seed=0):
        self.index = int(index)
        self.gen = int(gen)
        self.seed = int(seed)
        self.specs = [s for s in specs
                      if int(s.get("gen", 0)) == int(gen)]
        self.n_puts = 0
        self._t0 = time.monotonic()

    @classmethod
    def from_spec(cls, spec, index=0, gen=0):
        plan = validate_plan(_load_spec(spec))
        spokes = plan.get("spokes") or {}
        specs = spokes.get(str(index)) or spokes.get(int(index)) or []
        return cls(specs, index=index, gen=gen,
                   seed=plan.get("seed", 0))

    # -- triggers --
    def _timed_out(self, spec):
        s = spec.get("after_s")
        return s is not None and time.monotonic() - self._t0 >= float(s)

    def _update_hit(self, spec):
        at = spec.get("at_update")
        frm = spec.get("from_update")
        return (at is not None and self.n_puts == int(at)) or \
            (frm is not None and self.n_puts >= int(frm))

    # -- actions --
    def _die(self):
        os.kill(os.getpid(), signal.SIGKILL)
        os._exit(137)           # unreachable unless SIGKILL is blocked

    def _preempt(self):
        """The preemption notice: SIGTERM to our own pid. A process
        with the checkpointing handler installed (the hub — see
        utils/multiproc) captures a final bundle and terminates
        cleanly; a handler-less spoke child dies and is respawned
        warm. Unlike _die, execution CONTINUES after a handled
        signal — the wheel winds down through its normal exit path."""
        os.kill(os.getpid(), signal.SIGTERM)

    def _hang(self):
        while True:             # ignores the kill signal on purpose
            time.sleep(3600.0)

    def _corrupted(self, values, spec):
        v = spec.get("value", "inf")
        out = np.array(values, dtype=np.float64, copy=True).reshape(-1)
        if v == "garbage":
            rng = np.random.RandomState(
                (self.seed * 1000003 + self.index * 9176
                 + self.n_puts) % (2 ** 32))
            out[:] = rng.standard_normal(out.shape[0]) * 1e30
        elif v in ("inf", "-inf", "nan"):
            out[:] = float(v)
        else:
            out[:] = float(v)
        return out

    # -- hook bodies --
    def hello_delay(self) -> float:
        return sum(float(s.get("seconds", 0.0)) for s in self.specs
                   if s["action"] == "delay_hello")

    def sleep_before_hello(self):
        d = self.hello_delay()
        if d > 0:
            time.sleep(d)

    def on_publish(self, values):
        """Called with every outgoing payload; may not return (crash),
        may return a corrupted copy."""
        self.n_puts += 1
        for s in self.specs:
            if s["action"] == "crash" and (self._update_hit(s)
                                           or self._timed_out(s)):
                self._die()
        for s in self.specs:
            if s["action"] == "preempt" and (self._update_hit(s)
                                             or self._timed_out(s)):
                self._preempt()
        for s in self.specs:
            if s["action"] == "hang" and self._update_hit(s):
                self._hang()
        for s in self.specs:
            if s["action"] == "corrupt" and (self._update_hit(s)
                                             or self._timed_out(s)):
                values = self._corrupted(values, s)
        return values

    def on_poll(self):
        """Called from the spoke's kill-signal poll loop (time
        triggers for spokes that never publish)."""
        for s in self.specs:
            if s["action"] == "crash" and self._timed_out(s):
                self._die()
        for s in self.specs:
            if s["action"] == "preempt" and self._timed_out(s):
                self._preempt()
        for s in self.specs:
            if s["action"] == "hang" and self._timed_out(s):
                self._hang()

    def install(self, spoke):
        """Wrap the spoke instance's publish + poll methods. Instance
        attributes only — the class (and every other spoke) stays
        untouched."""
        orig_put = spoke.spoke_to_hub
        orig_poll = spoke.got_kill_signal

        def _put(values, **kw):
            # kwargs (lineage t_compute) pass through untouched: faults
            # corrupt the semantic payload, never the lineage stamps
            return orig_put(self.on_publish(values), **kw)

        def _poll():
            self.on_poll()
            return orig_poll()

        spoke.spoke_to_hub = _put
        spoke.got_kill_signal = _poll
        return self

    # -- hub-side triggers --
    def on_iteration(self, it):
        """Called once per hub termination check with the engine's
        current iteration: ``at_iteration`` / ``after_s`` triggers for
        HUB specs (preempt = the deterministic preemption notice the
        checkpoint-resume tests drive; crash/hang for completeness).
        Each spec fires at most once — termination checks repeat at
        the same iteration."""
        fired = getattr(self, "_fired", None)
        if fired is None:
            fired = self._fired = set()
        for i, s in enumerate(self.specs):
            if i in fired:
                continue
            at = s.get("at_iteration")
            hit = (at is not None and it is not None
                   and int(it) >= int(at)) or self._timed_out(s)
            if not hit:
                continue
            fired.add(i)
            if s["action"] == "crash":
                self._die()
            elif s["action"] == "preempt":
                self._preempt()
            elif s["action"] == "hang":
                self._hang()


def install_hub_faults(hub, spec):
    """Wrap ``hub.determine_termination`` with the plan's ``"hub"``
    specs (instance attribute only — the class stays untouched, same
    discipline as the spoke install). Returns the injector, or None
    when the plan carries no hub specs. Activated exclusively by
    ``spin_the_wheel_processes`` under the MPISPPY_TPU_FAULT_PLAN env
    var — the deterministic harness's handle on the WHEEL process."""
    plan = validate_plan(_load_spec(spec))
    specs = plan.get("hub") or []
    if not specs:
        return None
    inj = FaultInjector(specs, index=-1, seed=plan.get("seed", 0))
    orig = hub.determine_termination

    def _check():
        inj.on_iteration(getattr(hub.opt, "_iter", None))
        return orig()

    hub.determine_termination = _check
    return inj


class ServeFaultInjector:
    """The serving-process fault machine (the plan's ``"serve"`` key).

    Counted triggers are 1-based like the spoke side: ``at_wheel``
    fires on the Nth wheel launch, ``at_transfer`` on the Nth outgoing
    migration bundle member, ``at_offer`` on the Nth INCOMING
    ``/migrate/offer``; ``after_s`` arms a timer from
    :meth:`start_timers`. Each spec fires at most once. Installed by
    ``serve_main`` under the MPISPPY_TPU_FAULT_PLAN env var — the
    clean serving path never imports this module (tests assert it)."""

    def __init__(self, specs, seed=0):
        self.specs = list(specs)
        self.seed = int(seed)
        self._fired = set()
        self._lock = threading.Lock()
        self.n_wheels = 0
        self.n_transfers = 0
        self.n_offers = 0

    @classmethod
    def from_spec(cls, spec):
        plan = validate_plan(_load_spec(spec))
        specs = plan.get("serve") or []
        if not specs:
            return None
        return cls(specs, seed=plan.get("seed", 0))

    @classmethod
    def from_env(cls):
        spec = os.environ.get("MPISPPY_TPU_FAULT_PLAN")
        return cls.from_spec(spec) if spec else None

    def _die(self):
        os.kill(os.getpid(), signal.SIGKILL)
        os._exit(137)           # unreachable unless SIGKILL is blocked

    def _preempt(self):
        os.kill(os.getpid(), signal.SIGTERM)

    def _take(self, i) -> bool:
        """Claim spec ``i`` (once-only, thread-safe: wheel workers and
        HTTP handler threads consult the same injector)."""
        with self._lock:
            if i in self._fired:
                return False
            self._fired.add(i)
            return True

    def start_timers(self):
        """Arm daemon timers for ``after_s`` kill/preempt specs — the
        process-level faults that must fire even while the service is
        idle (no wheel to count)."""
        for i, s in enumerate(self.specs):
            if s["action"] not in ("kill", "preempt"):
                continue
            delay = s.get("after_s")
            if delay is None:
                continue

            def _fire(i=i, s=s):
                if self._take(i):
                    (self._die if s["action"] == "kill"
                     else self._preempt)()

            t = threading.Timer(float(delay), _fire)
            t.daemon = True
            t.start()
        return self

    def on_wheel_start(self):
        """Called by the wheel worker right before ``hub.main()``:
        counted kill/preempt/wedge faults. ``wedge_wheel`` sleeps here
        with the WheelDeadline watchdog already armed — the wedge is
        indistinguishable from a hung iteration, which is the point."""
        with self._lock:
            self.n_wheels += 1
            n = self.n_wheels
        for i, s in enumerate(self.specs):
            at = s.get("at_wheel")
            if at is None or n != int(at) or not self._take(i):
                continue
            if s["action"] == "kill":
                self._die()
            elif s["action"] == "preempt":
                self._preempt()
            elif s["action"] == "wedge_wheel":
                time.sleep(float(s.get("seconds", 30.0)))

    def on_transfer(self) -> bool:
        """Called by the donor's MigrationClient per outgoing bundle
        member; True = tear THIS member (truncate mid-stream with the
        full Content-Length still promised — the receiver's sha256
        gate refuses it, exercising the retry/abort path)."""
        with self._lock:
            self.n_transfers += 1
            n = self.n_transfers
        for i, s in enumerate(self.specs):
            if s["action"] != "tear_transfer":
                continue
            at = s.get("at_transfer")
            if at is not None and n == int(at) and self._take(i):
                return True
        return False

    def on_offer(self):
        """Called by the receiver per incoming ``/migrate/offer`` ->
        ``(verdict, sleep_seconds)``: ``("refuse", 0)`` rejects the
        handoff with a reasoned 4xx, ``(None, s)`` stalls the reply so
        the donor's per-transfer deadline machinery takes over."""
        with self._lock:
            self.n_offers += 1
            n = self.n_offers
        for i, s in enumerate(self.specs):
            at = s.get("at_offer")
            if at is None or n != int(at):
                continue
            if s["action"] == "refuse_peer" and self._take(i):
                return "refuse", 0.0
            if s["action"] == "timeout_peer" and self._take(i):
                return None, float(s.get("seconds", 20.0))
        return None, 0.0
