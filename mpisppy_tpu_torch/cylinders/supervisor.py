"""Wheel supervisor: liveness, spoke respawn, quarantine, watchdog.

The reference inherits MPI's fault model — one dead rank kills the
whole job. Our wheel runs spokes as OS processes over shared-memory
seqlock windows (utils/multiproc.py), so a crashed, hung, or
garbage-publishing spoke is *survivable*: the supervisor is the piece
that makes it actually survived instead of silently degrading.

Four mechanisms (doc/fault_tolerance.md has the full semantics):

- **liveness** — polled from the hub's sync path (``Hub.receive_bounds``
  calls :meth:`WheelSupervisor.poll`): ``Process.is_alive()`` per spoke,
  plus optional write-id heartbeat progress (bound spokes re-stamp
  their window when idle — cylinders/spoke.py ``_heartbeat`` — so a
  healthy-but-boundless spoke still pulses; a spoke whose write-id
  stops advancing for ``heartbeat_timeout`` seconds is declared
  stalled and terminated).
- **recovery** — a dead spoke is respawned through the launcher's
  ``respawner`` callback on a FRESH window pair (generation-suffixed
  shm names; the dead generation's windows are retired in place and
  unlinked at wheel teardown), with capped exponential backoff
  between attempts. With checkpointing armed (``checkpoint_dir``,
  the checkpoint layer), the respawner's spawn body hands generation N
  the latest warm-state file generation N-1 persisted, so a respawn
  RESUMES the spoke — first published bound no worse than the dead
  generation's best — instead of restarting it cold
  (doc/fault_tolerance.md §checkpoint/resume).
- **quarantine** — after ``max_respawns`` crashes (or
  ``max_rejections`` corrupt payloads flagged by the hub's ingest
  validation) the spoke is retired: removed from the hub's
  classification sets so sends/receives skip it, and the wheel
  continues without it.
- **watchdog** — ``start_watchdog(deadline)`` arms a timer that fires
  :meth:`Hub.fire_watchdog` (terminate + telemetry flush + partial
  bounds) if the wheel outlives its deadline, the wheel-level analog
  of bench.py's SIGTERM flush.

Every transition lands in telemetry: ``hub.spoke_down`` /
``hub.spoke_respawn`` / ``hub.spoke_quarantined`` events + same-named
counters (catalogued in doc/observability.md; ``analyze`` renders them
as the faults section and the degraded-run invariant).

The supervisor runs on the hub's thread (poll is called from
``receive_bounds``), so spoke-list/window swaps never race hub reads;
only the watchdog timer runs on its own daemon thread, and it touches
nothing but the once-guarded ``fire_watchdog``.
"""

from __future__ import annotations

import threading
import time

from .. import global_toc, obs

# states a supervised spoke moves through
RUNNING = "running"
DOWN = "down"              # dead/stalled, respawn scheduled (in backoff)
QUARANTINED = "quarantined"

_DEFAULTS = {
    "poll_interval": 0.25,        # min seconds between full liveness sweeps
    "heartbeat_timeout": None,    # None = write-id progress not enforced
    "max_respawns": 2,            # crashes beyond this quarantine the spoke
    "respawn_backoff": 0.5,       # first-respawn delay (doubles per crash)
    "respawn_backoff_cap": 30.0,
    "max_rejections": 5,          # corrupt payloads before quarantine
}

KNOWN_OPTIONS = (*_DEFAULTS, "crossed_bound_tol")


class WheelDeadline:
    """The watchdog timer half of the supervisor, standalone — for
    wheels with no spoke processes to supervise (the serving layer's
    in-process hub-only wheels, serve/). Arms a daemon
    timer that fires the hub's once-guarded :meth:`Hub.fire_watchdog`
    if the wheel outlives its deadline, even when an iteration wedges
    and the hub never reaches another termination check — exactly
    ``WheelSupervisor.start_watchdog``'s contract, minus the process
    management."""

    def __init__(self, hub, deadline: float):
        self.hub = hub
        self._timer = threading.Timer(float(deadline), self._fire)
        self._timer.daemon = True
        self._cancelled = False

    def start(self):
        self._timer.start()
        return self

    def _fire(self):
        if not self._cancelled and self.hub is not None:
            self.hub.fire_watchdog("deadline_timer")

    def cancel(self):
        self._cancelled = True
        self._timer.cancel()


class _SpokeHealth:
    __slots__ = ("state", "crashes", "rejections", "next_respawn_at",
                 "last_wid", "last_progress", "gen")

    def __init__(self, now):
        self.state = RUNNING
        self.crashes = 0
        self.rejections = 0
        self.next_respawn_at = 0.0
        self.last_wid = 0
        self.last_progress = now
        self.gen = 0


class WheelSupervisor:
    """Supervises one multi-process wheel's spokes.

    ``spokes`` / ``procs`` / ``owned`` are the launcher's LIVE lists
    (utils/multiproc.spin_the_wheel_processes): the supervisor mutates
    them in place on respawn/quarantine so the hub's sends, the final
    join loop, and the window-unlink cleanup always see current state.
    ``respawner(i, gen) -> (proxy, proc)`` spawns generation ``gen`` of
    spoke ``i`` on a fresh window pair.
    """

    def __init__(self, spokes, procs, kinds=None, options=None,
                 respawner=None, owned=None):
        bad = set(options or ()) - set(KNOWN_OPTIONS)
        if bad:
            raise ValueError(f"unknown supervisor options {sorted(bad)}; "
                             f"known: {sorted(KNOWN_OPTIONS)}")
        self.opts = {**_DEFAULTS, **(options or {})}
        self.spokes = spokes
        self.procs = procs
        self.kinds = list(kinds or ["?"] * len(spokes))
        self._respawner = respawner
        self._owned = owned if owned is not None else []
        now = time.monotonic()
        self.health = [_SpokeHealth(now) for _ in spokes]
        self.hub = None
        self._last_poll = 0.0
        self._closed = False
        self._watchdog = None

    # ---- wiring ----
    def attach(self, hub):
        hub.supervisor = self
        self.hub = hub
        # the hub COPIES the spoke list at construction (Hub.__init__);
        # supervise the hub's own list so a respawn swap is what the
        # hub's sends/receives actually see
        if getattr(hub, "spokes", None) is not None:
            self.spokes = hub.spokes
        return self

    def start_watchdog(self, deadline: float):
        """Arm the wheel deadline: after ``deadline`` seconds the hub's
        watchdog fires even if the hub never reaches another
        termination check (terminate signal to every spoke + telemetry
        flush + partial bounds event)."""
        self._watchdog = threading.Timer(float(deadline),
                                         self._watchdog_fire)
        self._watchdog.daemon = True
        self._watchdog.start()

    def _watchdog_fire(self):
        if self._closed or self.hub is None:
            return
        self.hub.fire_watchdog("supervisor")

    def shutdown(self):
        """Stop supervising (called before the hub's own terminate):
        no further respawns, watchdog cancelled. Idempotent."""
        self._closed = True
        if self._watchdog is not None:
            self._watchdog.cancel()
            self._watchdog = None

    # ---- state queries ----
    def state(self, i) -> str:
        return self.health[i].state

    def quarantined(self):
        return [i for i, h in enumerate(self.health)
                if h.state == QUARANTINED]

    # ---- the sync-path poll ----
    def poll(self):
        """One rate-limited liveness sweep; runs on the hub thread."""
        if self._closed:
            return
        now = time.monotonic()
        if now - self._last_poll < self.opts["poll_interval"]:
            return
        self._last_poll = now
        for i, h in enumerate(self.health):
            if h.state == QUARANTINED:
                continue
            if h.state == DOWN:
                if now >= h.next_respawn_at:
                    self._respawn(i, h)
                continue
            p = self.procs[i]
            if not p.is_alive():
                self._mark_down(i, h, "died",
                                exitcode=getattr(p, "exitcode", None))
                continue
            hb = self.opts["heartbeat_timeout"]
            if hb is not None:
                wid = self.spokes[i].my_window.read_id()
                if wid != h.last_wid:
                    h.last_wid = wid
                    h.last_progress = now
                elif now - h.last_progress > float(hb):
                    # alive but not pulsing: treat as hung — terminate
                    # so the respawn path takes over
                    p.terminate()
                    self._mark_down(i, h, "stalled")

    # ---- transitions ----
    def _mark_down(self, i, h, reason, exitcode=None):
        h.crashes += 1
        obs.counter_add("hub.spoke_down")
        obs.event("hub.spoke_down",
                  {"spoke": i, "kind": self.kinds[i], "reason": reason,
                   "exitcode": exitcode, "crashes": h.crashes})
        global_toc(f"supervisor: spoke {i} ({self.kinds[i]}) {reason} "
                   f"(crash {h.crashes}, exitcode {exitcode})")
        if h.crashes > int(self.opts["max_respawns"]) \
                or self._respawner is None:
            self._quarantine(i, h, "crashes")
            return
        backoff = min(self.opts["respawn_backoff"] * 2 ** (h.crashes - 1),
                      self.opts["respawn_backoff_cap"])
        h.state = DOWN
        h.next_respawn_at = time.monotonic() + backoff

    def _respawn(self, i, h):
        h.gen += 1
        try:
            proxy, proc = self._respawner(i, h.gen)
        except Exception as e:
            # a failed spawn counts as another crash (backoff doubles,
            # quarantine eventually) — never raises into the hub loop
            global_toc(f"supervisor: respawn of spoke {i} failed ({e!r})")
            self._mark_down(i, h, "respawn_failed")
            return
        # adopt the fresh pair; the dead generation's windows STAY in
        # the launcher's owned list and are unlinked at wheel teardown,
        # not here — closing them now could race the watchdog timer
        # thread's send_terminate sweep over a stale spoke reference
        # (a kill() on a freed shm handle). They are tiny (a few
        # doubles each) and bounded by the crash budget.
        self._owned += [proxy.hub_window, proxy.my_window]
        self.spokes[i] = proxy
        self.procs[i] = proc
        now = time.monotonic()
        h.state = RUNNING
        h.last_wid = 0
        h.last_progress = now
        if self.hub is not None:
            # fresh window pair starts at write-id 0 — reset freshness
            # so the respawned spoke's hello/bounds are consumed; the
            # bound-flow tracker likewise restarts its lineage seq
            self.hub._spoke_last_ids[i] = 0
            self.hub.note_spoke_respawn(i, h.gen)
        obs.counter_add("hub.spoke_respawn")
        obs.event("hub.spoke_respawn",
                  {"spoke": i, "kind": self.kinds[i], "gen": h.gen,
                   "crashes": h.crashes})
        global_toc(f"supervisor: spoke {i} ({self.kinds[i]}) respawned "
                   f"(gen {h.gen})")

    def _quarantine(self, i, h, cause):
        h.state = QUARANTINED
        obs.counter_add("hub.spoke_quarantined")
        obs.event("hub.spoke_quarantined",
                  {"spoke": i, "kind": self.kinds[i], "cause": cause,
                   "crashes": h.crashes, "rejections": h.rejections})
        global_toc(f"WARNING: supervisor quarantined spoke {i} "
                   f"({self.kinds[i]}) after {cause}; wheel continues "
                   "without it")
        hub = self.hub
        if hub is not None:
            for attr in ("outer_bound_spoke_indices",
                         "inner_bound_spoke_indices",
                         "w_spoke_indices", "nonant_spoke_indices",
                         "cut_spoke_indices"):
                getattr(hub, attr, set()).discard(i)
        # a live-but-poisonous spoke (rejection quarantine) is released
        # via its own kill signal so it exits before the final join
        p = self.procs[i]
        if p is not None and p.is_alive():
            self.spokes[i].hub_window.kill()

    def note_rejection(self, i):
        """The hub's ingest validation flags one rejected payload from
        spoke ``i`` (see Hub._reject_bound); enough of them retire the
        spoke — a corrupt publisher is as dead as a crashed one."""
        if self._closed or i >= len(self.health):
            return
        h = self.health[i]
        h.rejections += 1
        if h.state == RUNNING \
                and h.rejections >= int(self.opts["max_rejections"]):
            self._quarantine(i, h, "rejections")
