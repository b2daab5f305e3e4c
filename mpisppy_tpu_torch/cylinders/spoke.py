"""Spoke base classes and the converger-spoke taxonomy.

Mirrors mpisppy/cylinders/spoke.py:17-322: spokes declare what they give
to / take from the hub via ``converger_spoke_types``; ``_BoundSpoke``
publishes a single bound value, nonant-variants receive the hub's nonant
vector. Kill-signal polling is rate-limited by SPOKE_SLEEP_TIME
(ref. spoke.py:101-111).
"""

from __future__ import annotations

import enum
import time

import numpy as np

from .. import obs
from . import SPOKE_SLEEP_TIME
from .spcommunicator import (LINEAGE_SLOTS, SPCommunicator, Window,
                             wire_payload)


class ConvergerSpokeType(enum.Enum):
    OUTER_BOUND = 1
    INNER_BOUND = 2
    W_GETTER = 3
    NONANT_GETTER = 4


class Spoke(SPCommunicator):
    converger_spoke_types = ()
    converger_spoke_char = "?"

    @staticmethod
    def payload_length(S, K) -> int:
        """Spoke→hub window length as a function of batch dims — the
        ONE layout definition: the instance's local_window_length and
        the multi-process SpokeProxy (which never holds an instance)
        must size the same shared buffer from it. Default: a single
        bound value."""
        return 1

    def __init__(self, spbase_object, options=None, trace_prefix=None):
        super().__init__(spbase_object, options)
        self.hub_window: Window | None = None   # hub writes, we read
        self.my_window: Window | None = None    # we write, hub reads
        self._last_hub_id = 0
        self._last_kill_check = 0.0
        self.bound = None
        self._trace = []  # (time, bound) pairs (ref. spoke.py:140-153)
        self._trace_prefix = trace_prefix   # file created by _BoundSpoke
        # poll cadence / heartbeat knobs, configurable per run so fault
        # tests can run fast scenarios without monkeypatching the
        # module constant (RunConfig.spoke_sleep_time plumbs through
        # the engine options — see utils/vanilla.spoke_dict)
        self._sleep_time = float(self.options.get("spoke_sleep_time",
                                                  SPOKE_SLEEP_TIME))
        self._pulse_interval = float(self.options.get(
            "spoke_pulse_interval", 1.0))
        self._last_put = time.monotonic()
        # bound-flow lineage (spcommunicator wire_payload): per-spoke
        # publish counter + the last full wire buffer, re-put verbatim
        # by heartbeat pulses so a pulse never masquerades as a fresh
        # publish (same seq, same stamps — only the write-id advances)
        self._publish_seq = 0
        self._last_wire = None
        # ---- durable warm state (ckpt/, doc/fault_tolerance.md):
        # with "checkpoint_dir" set, this spoke keeps a
        # tiny atomic state file fresh (best bound, incumbent, duals,
        # cycler position — whatever spoke_state() reports) so the
        # hub's bundles stay self-contained and a respawned
        # incarnation resumes instead of restarting. "resume_state"
        # names the file THIS incarnation starts from; a corrupt file
        # cold-starts with a reasoned counter, never a crashed child.
        self._ckpt_dir = self.options.get("checkpoint_dir")
        self._ckpt_index = int(self.options.get("checkpoint_index", 0))
        self._ckpt_kind = str(self.options.get("checkpoint_kind", "?"))
        self._ckpt_min_interval = float(self.options.get(
            "spoke_checkpoint_interval", 2.0))
        self._ckpt_last_write = 0.0
        self._resume_bound = None
        # loaded lazily by resume_publish(): install_spoke_state
        # touches subclass attributes that do not exist yet this early
        # in the ctor chain
        self._resume_state_path = self.options.get("resume_state")

    # -- wire protocol (ref. spoke.py:59-99) --
    def spoke_to_hub(self, values, t_compute=None):
        """Publish one payload with its lineage stamp. ``t_compute`` is
        the wall-clock instant the value was COMPUTED (defaults to now:
        compute and publish coincide for every current spoke — the slot
        exists so a spoke that batches results can stamp honestly)."""
        self._publish_seq += 1
        self._last_wire = wire_payload(values, self._publish_seq,
                                       t_compute=t_compute)
        self._last_put = time.monotonic()
        self.my_window.put(self._last_wire)

    def spoke_from_hub(self):
        """Return (fresh, values). Fresh iff the hub's write-id advanced.
        Peek the id first so stale polls don't copy the whole payload."""
        wid = self.hub_window.read_id()
        if wid == Window.KILL or wid <= self._last_hub_id:
            return False, None
        values, wid = self.hub_window.read()
        if wid == Window.KILL:
            return False, None
        self._last_hub_id = wid
        return True, values

    def got_kill_signal(self) -> bool:
        """Rate-limited kill check (ref. spoke.py:101-111). Doubles as
        the liveness beat: each poll gives ``_heartbeat`` a chance to
        re-stamp the spoke's window so the supervisor's write-id
        progress monitoring sees a pulse even when no new bound has
        been published (doc/fault_tolerance.md)."""
        now = time.monotonic()
        if now - self._last_kill_check < self._sleep_time:
            time.sleep(self._sleep_time)
        self._last_kill_check = time.monotonic()
        self._heartbeat()
        self.maybe_write_spoke_state()
        return self.killed()

    def _heartbeat(self):
        """No-op by default; _BoundSpoke re-stamps its window when idle
        (the write-id doubles as the heartbeat — no extra channel)."""

    # ---- warm state (ckpt/) ----
    def spoke_state(self) -> dict:
        """This spoke's resumable warm state as plain host values
        (arrays/scalars/strings). Subclasses EXTEND the dict — the
        base carries the published best bound; x̂ spokes add their
        incumbent and cycler position, the Lagrangian its dual block,
        the dive spoke its round counter (the RNG fold index)."""
        return {"bound": self.bound}

    def install_spoke_state(self, state: dict):
        """Inverse of :meth:`spoke_state`; subclasses extend. The
        restored bound is parked for :meth:`resume_publish` (windows
        are not wired yet at construction time)."""
        b = state.get("bound")
        if b is not None:
            self.bound = float(b)
            self._resume_bound = float(b)

    def _load_resume_state(self, path):
        from .. import global_toc, obs
        from ..ckpt.bundle import CheckpointError
        from ..ckpt.spoke_state import load_spoke_state
        try:
            state = load_spoke_state(path,
                                     spoke_class=type(self).__name__)
        except CheckpointError as e:
            obs.counter_add(f"ckpt.rejected.{e.reason}")
            obs.event("ckpt.resume_rejected",
                      {"reason": e.reason, "detail": str(e),
                       "spoke": self._ckpt_index})
            global_toc(f"{type(self).__name__}: spoke resume state "
                       f"rejected ({e.reason}); cold start")
            return
        self.install_spoke_state(state)
        obs.counter_add("ckpt.spoke_resumed")
        obs.event("ckpt.spoke_resume",
                  {"spoke": self._ckpt_index,
                   "bound": obs.finite_or_none(self._resume_bound)})

    def resume_publish(self):
        """Install the parked resume state (deferred from the ctor —
        subclass attributes exist by now) and publish the checkpointed
        best bound as this incarnation's FIRST publish (called by the
        launchers after the hello, before main()): the value was a
        valid bound when captured and the config fingerprint guards
        the model, so re-publishing it is sound — and it makes a
        respawned spoke's first bound no worse than its predecessor's
        best. No-op without resume state."""
        if self._resume_state_path:
            path, self._resume_state_path = self._resume_state_path, None
            self._load_resume_state(path)
        if self._resume_bound is None or self.my_window is None:
            return
        b, self._resume_bound = self._resume_bound, None
        # _BoundSpoke publishes through update_bound; a spoke with a
        # custom wire layout (the dual-typed EF-MIP bounder) keeps the
        # installed self.bound and re-publishes through its own loop
        if hasattr(self, "update_bound"):
            self.update_bound(b)

    def maybe_write_spoke_state(self, force=False):
        """Throttled atomic refresh of this spoke's warm-state file;
        cheap no-op without a checkpoint dir. Called from the bound
        publish path and the kill-poll beat, so the state tracks the
        spoke even between publishes (dive rounds, cycler walks). A
        full disk books a counter and the spoke keeps running."""
        if self._ckpt_dir is None:
            return
        now = time.monotonic()
        if not force and now - self._ckpt_last_write \
                < self._ckpt_min_interval:
            return
        self._ckpt_last_write = now
        from .. import obs
        from ..ckpt.spoke_state import save_spoke_state
        try:
            save_spoke_state(self._ckpt_dir, self._ckpt_index,
                             type(self).__name__, self._ckpt_kind,
                             self.spoke_state())
            obs.counter_add("ckpt.spoke_writes")
        except OSError:
            obs.counter_add("ckpt.write_failed")

    def killed(self) -> bool:
        """Non-sleeping kill probe for use INSIDE long spoke work
        (candidate loops, oracle refreshes): one atomic id read, no
        rate limiting. Long-running spoke steps must poll this so a
        terminating wheel never waits out a mid-flight refresh
        (the reference's kill window is likewise checked between
        subproblem solves, ref. spoke.py:101-111)."""
        return self.hub_window.read_id() == Window.KILL

    def local_window_length(self) -> int:
        # payload_length is the ONE override point for spoke→hub layout;
        # every spoke→hub window carries the lineage suffix behind it
        # (spcommunicator.LINEAGE_SLOTS — the hub strips it on read)
        return self.payload_length(self.opt.batch.S, self.opt.batch.K) \
            + LINEAGE_SLOTS

    def _init_trace(self, header):
        """Create the live trace CSV when a trace_prefix was given
        (ref. spoke.py:140-153): one naming scheme for every spoke
        kind; subclasses choose the header/columns."""
        self._trace_path = (f"{self._trace_prefix}{type(self).__name__}"
                            ".csv" if self._trace_prefix else None)
        if self._trace_path:
            with open(self._trace_path, "w") as f:
                f.write(header + "\n")

    def main(self):
        raise NotImplementedError

    def hub_read_layout(self):
        """(has_W, has_nonants) from the declared spoke types."""
        return (ConvergerSpokeType.W_GETTER in self.converger_spoke_types,
                ConvergerSpokeType.NONANT_GETTER in self.converger_spoke_types)

    def remote_window_length(self) -> int:
        S, K = self.opt.batch.S, self.opt.batch.K
        has_w, has_x = self.hub_read_layout()
        return (S * K if has_w else 0) + (S * K if has_x else 0)

    def unpack_hub(self, values):
        """Split the hub payload into (W or None, nonants or None)."""
        S, K = self.opt.batch.S, self.opt.batch.K
        has_w, has_x = self.hub_read_layout()
        off = 0
        W = None
        X = None
        if has_w:
            W = values[off:off + S * K].reshape(S, K)
            off += S * K
        if has_x:
            X = values[off:off + S * K].reshape(S, K)
        return W, X


class _BoundSpoke(Spoke):
    """Publishes [bound]; CSV-style (time, bound) trace kept in memory and
    dumpable via ``write_trace``. With ``trace_prefix`` set, a live
    ``<prefix><SpokeClass>.csv`` is appended on every bound update
    (ref. spoke.py:135-188 trace_prefix) — the file machinery is the
    base class's _init_trace; this class picks the (time, bound)
    columns."""

    def __init__(self, spbase_object, options=None, trace_prefix=None):
        super().__init__(spbase_object, options, trace_prefix)
        self._init_trace("time,bound")

    def spoke_state(self):
        """The checkpointed bound is this spoke's BEST published value,
        not the last: bound sources oscillate (a Lagrangian bound at a
        fresh W can be looser than at an earlier W), ``self.bound`` is
        whatever was computed most recently, and resume_publish
        re-publishes the checkpoint — a respawned incarnation's first
        bound must not regress below its predecessor's best."""
        state = super().spoke_state()
        if self._trace:
            vals = [b for _, b in self._trace]
            ts = self.converger_spoke_types
            if ConvergerSpokeType.OUTER_BOUND in ts \
                    and ConvergerSpokeType.INNER_BOUND not in ts:
                state["bound"] = max(vals)
            elif ConvergerSpokeType.INNER_BOUND in ts \
                    and ConvergerSpokeType.OUTER_BOUND not in ts:
                state["bound"] = min(vals)
        return state

    def _heartbeat(self):
        """Idle re-stamp: re-put the current payload (the best bound,
        or the all-NaN hello when none exists yet) when nothing has
        been written for a pulse interval. The hub re-reads an
        identical value harmlessly (it never wins a bound comparison),
        but the advancing write-id tells the supervisor this spoke is
        alive even while it computes between publishes."""
        if self._pulse_interval <= 0 or self.my_window is None:
            return
        if time.monotonic() - self._last_put >= self._pulse_interval:
            # direct window put, NOT spoke_to_hub: pulses must stay
            # invisible to publish-count semantics (fault-plan
            # ``at_update`` triggers count real publishes only, and the
            # hub's bound-flow accounting keys on the lineage seq).
            # Re-put the LAST wire buffer verbatim — same seq, same
            # stamps — or the all-NaN hello when nothing was published
            self._last_put = time.monotonic()
            self.my_window.put(self._last_wire if self._last_wire
                               is not None
                               else np.full(self.local_window_length(),
                                            np.nan))

    def update_bound(self, value: float):
        t_compute = time.time()      # lineage compute stamp (wall clock)
        prev_t = self._trace[-1][0] if self._trace else None
        self.bound = float(value)
        self._trace.append((time.monotonic(), self.bound))
        # the telemetry event stream subsumes the CSV trace (one event
        # type across every spoke kind, monotonic stamps, merged with
        # the hub's bound events); the CSV stays for trace_prefix users
        obs.counter_add("spoke.bound_updates")
        obs.event("spoke.bound",
                  {"spoke": type(self).__name__,
                   "char": self.converger_spoke_char,
                   "value": self.bound})
        if prev_t is not None:
            # bound cadence histogram: a spoke that stops publishing
            # shows up as a p99 spike, not a silent gap in the stream
            obs.histogram_observe("spoke.bound_interval_seconds",
                                  self._trace[-1][0] - prev_t)
        if self._trace_path:
            with open(self._trace_path, "a") as f:
                f.write(f"{self._trace[-1][0]},{self.bound}\n")
        # refresh the durable warm state BEFORE the wire write (forced,
        # not throttled): a crash during or right after the publish
        # must find the file already carrying this bound, or the
        # respawned incarnation's first publish could regress below a
        # value the wheel has seen
        self.maybe_write_spoke_state(force=True)
        self.spoke_to_hub(np.array([self.bound]), t_compute=t_compute)

    def write_trace(self, path):
        with open(path, "w") as f:
            f.write("time,bound\n")
            for t, b in self._trace:
                f.write(f"{t},{b}\n")

    def finalize(self):
        # the spoke-side run_footer context: in a multi-process wheel
        # this lands in the child's role-suffixed event stream just
        # before its recorder closes
        obs.event("spoke.finalize",
                  {"spoke": type(self).__name__, "bound": self.bound,
                   "updates": len(self._trace)})
        return self.bound


class InnerBoundSpoke(_BoundSpoke):
    converger_spoke_types = (ConvergerSpokeType.INNER_BOUND,)
    converger_spoke_char = "I"


class OuterBoundSpoke(_BoundSpoke):
    converger_spoke_types = (ConvergerSpokeType.OUTER_BOUND,)
    converger_spoke_char = "O"


class OuterBoundWSpoke(_BoundSpoke):
    converger_spoke_types = (ConvergerSpokeType.OUTER_BOUND,
                             ConvergerSpokeType.W_GETTER)
    converger_spoke_char = "O"


class InnerBoundNonantSpoke(_BoundSpoke):
    converger_spoke_types = (ConvergerSpokeType.INNER_BOUND,
                             ConvergerSpokeType.NONANT_GETTER)
    converger_spoke_char = "I"


class OuterBoundNonantSpoke(_BoundSpoke):
    converger_spoke_types = (ConvergerSpokeType.OUTER_BOUND,
                             ConvergerSpokeType.NONANT_GETTER)
    converger_spoke_char = "O"
