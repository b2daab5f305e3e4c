"""Request lifecycle: bounded admission queue + durable request store.

A request is durable from the moment it is admitted: its state lives
as ``<state_dir>/requests/<id>.json`` (atomic tmp+``os.replace``, the
ckpt/live.json contract), updated on every transition —

    queued -> running -> done | failed | preempted
                      -> migrating -> migrated   (live handoff)

so results outlive the connection (``GET /result/<id>`` replays the
file), and a killed service re-admits everything that was queued or
in flight at the next start (preempted/running requests resume from
their ``ckpt/`` bundle — serve/manager).

The admission queue is BOUNDED (``queue_limit``): a full queue rejects
with 429 + ``serve.requests.rejected`` instead of buffering unbounded
work the deadline watchdog would kill anyway. Per-request deadlines
(seconds from admission) ride the request and become the wheel's
``wheel_deadline`` (the hub's watchdog) at dispatch — an expired deadline
is settled at pop time without spending a wheel on it.

stdlib + the store's json files only.
"""

from __future__ import annotations

import json
import os
import secrets
import threading
import time

from .. import obs
from ..ckpt.bundle import atomic_write_json

REQUEST_SCHEMA = 1

# terminal states never re-admit; the rest re-enter the queue on a
# service restart (serve/manager.recover_requests). "migrating" is the
# two-phase-commit limbo of a live handoff (serve/migrate): recovery
# resolves it by probing the peer. "migrated" is this host's FINAL
# state for a handed-off request — not in TERMINAL (the result lives
# on the peer, clients follow the recorded peer hint) but never
# re-admitted and swept with the terminals.
TERMINAL = ("done", "failed")
STATES = ("queued", "running", "done", "failed", "preempted",
          "migrating", "migrated")


class QueueFull(RuntimeError):
    """Admission refused: the bounded queue is at queue_limit."""


class Request:
    """One admitted solve request (or rolling-horizon chain)."""

    def __init__(self, payload: dict, req_id=None, bucket=None,
                 batchable=True, deadline=None):
        self.id = req_id or f"req-{secrets.token_hex(6)}"
        self.payload = payload
        self.bucket = bucket              # serve/batch.bucket_key
        self.batchable = bool(batchable)
        self.status = "queued"
        self.submitted_unix = time.time()
        self.started_unix = None
        self.finished_unix = None
        # absolute wall-clock deadline (None = no SLO); the dispatcher
        # converts the remainder into the wheel's wheel_deadline
        self.deadline_unix = None if deadline is None \
            else self.submitted_unix + float(deadline)
        self.group = None                 # stacked-wheel group id
        self.result = None
        self.error = None
        self.resume_from = None           # ckpt bundle to resume from
        self.resumed = False
        self.no_batch = False             # set after a failed group run
        self.chain_results = []           # completed rolling-horizon steps
        # fleet fields (serve/migrate): how many times startup recovery
        # has re-admitted this record (poison-pill quarantine trips at
        # --max-recoveries), the peer base URL a handoff targeted, and
        # — on the RECEIVER — the donor this request migrated in from
        self.recoveries = 0
        self.peer = None
        self.migrated_from = None

    def deadline_remaining(self, now=None) -> float | None:
        if self.deadline_unix is None:
            return None
        return self.deadline_unix - (time.time() if now is None else now)

    def to_json(self) -> dict:
        return {"schema": REQUEST_SCHEMA, "id": self.id,
                "status": self.status, "bucket": self.bucket,
                "batchable": self.batchable, "no_batch": self.no_batch,
                "payload": self.payload,
                "submitted_unix": self.submitted_unix,
                "started_unix": self.started_unix,
                "finished_unix": self.finished_unix,
                "deadline_unix": self.deadline_unix,
                "group": self.group, "result": self.result,
                "error": self.error, "resumed": self.resumed,
                "chain_results": self.chain_results,
                "recoveries": self.recoveries, "peer": self.peer,
                "migrated_from": self.migrated_from}

    @classmethod
    def from_json(cls, d: dict) -> "Request":
        req = cls(d.get("payload") or {}, req_id=d["id"],
                  bucket=d.get("bucket"),
                  batchable=d.get("batchable", True))
        req.status = d.get("status", "queued")
        req.submitted_unix = d.get("submitted_unix") or time.time()
        req.started_unix = d.get("started_unix")
        req.finished_unix = d.get("finished_unix")
        req.deadline_unix = d.get("deadline_unix")
        req.group = d.get("group")
        req.result = d.get("result")
        req.error = d.get("error")
        req.resumed = bool(d.get("resumed", False))
        req.no_batch = bool(d.get("no_batch", False))
        req.chain_results = list(d.get("chain_results") or [])
        req.recoveries = int(d.get("recoveries") or 0)
        req.peer = d.get("peer")
        req.migrated_from = d.get("migrated_from")
        return req

    def summary(self) -> dict:
        """The light row GET /queue lists."""
        return {"id": self.id, "status": self.status,
                "bucket": self.bucket, "group": self.group,
                "submitted_unix": self.submitted_unix,
                "deadline_unix": self.deadline_unix,
                "resumed": self.resumed, "peer": self.peer}


class RequestStore:
    """Durable request state under ``<state_dir>/requests/`` — one
    atomic json file per request, rewritten on every transition."""

    def __init__(self, state_dir: str):
        self.dir = os.path.join(str(state_dir), "requests")
        os.makedirs(self.dir, exist_ok=True)
        self._lock = threading.Lock()

    def _path(self, req_id: str) -> str:
        # request ids are service-minted (req-<hex>); refuse anything
        # path-shaped from the wire
        if os.sep in req_id or req_id.startswith("."):
            raise KeyError(req_id)
        return os.path.join(self.dir, f"{req_id}.json")

    def save(self, req: Request):
        with self._lock:
            atomic_write_json(self._path(req.id), req.to_json())

    def load(self, req_id: str) -> Request | None:
        try:
            with open(self._path(req_id), encoding="utf-8") as f:
                return Request.from_json(json.load(f))
        except (OSError, ValueError, KeyError):
            return None

    def delete(self, req_id: str):
        """Remove a record (admission rolled back on a full queue — a
        429'd request must not resurrect at the next start)."""
        try:
            os.remove(self._path(req_id))
        except OSError:
            pass

    def load_all(self) -> list:
        out = []
        try:
            names = sorted(os.listdir(self.dir))
        except OSError:
            return out
        for fn in names:
            if not fn.endswith(".json"):
                continue
            req = self.load(fn[:-len(".json")])
            if req is not None:
                out.append(req)
        return out


class AdmissionQueue:
    """Bounded FIFO of :class:`Request` with bucket-aware group pops.

    ``pop_group`` is the scenario-axis batcher's front half: it takes
    the head request and, when that request is batchable, collects up
    to ``batch_max - 1`` more QUEUED requests of the SAME bucket,
    waiting up to ``batch_window`` seconds for stragglers — so a burst
    of same-shape instances rides one stacked wheel while a lone
    request never waits longer than the window."""

    def __init__(self, limit: int = 64):
        self.limit = max(1, int(limit))
        self._items: list[Request] = []
        self._cond = threading.Condition()
        self._stopped = False

    def __len__(self):
        with self._cond:
            return len(self._items)

    def push(self, req: Request, front: bool = False,
             force: bool = False):
        """``force`` bypasses the bound: restart recovery and group
        fallbacks re-admit work that was ALREADY accepted once — the
        limit guards new clients, not the durable backlog."""
        with self._cond:
            if not force and len(self._items) >= self.limit:
                raise QueueFull(
                    f"admission queue at limit ({self.limit})")
            if front:
                self._items.insert(0, req)
            else:
                self._items.append(req)
            obs.gauge_set("serve.queue_depth", len(self._items))
            self._cond.notify_all()

    def stop(self):
        with self._cond:
            self._stopped = True
            self._cond.notify_all()

    def _take_same_bucket(self, first: Request, batch_max: int,
                          group: list):
        taken = []
        for r in self._items:
            if len(group) + len(taken) >= batch_max:
                break
            if r.batchable and not r.no_batch \
                    and r.bucket == first.bucket:
                taken.append(r)
        for r in taken:
            self._items.remove(r)
        group.extend(taken)

    def pop_group(self, batch_window: float = 0.0, batch_max: int = 1,
                  timeout: float | None = None) -> list:
        """Next dispatch unit: ``[request]`` or a same-bucket group.
        Empty list = queue stopped or ``timeout`` expired idle."""
        with self._cond:
            deadline = None if timeout is None \
                else time.monotonic() + timeout
            while not self._items or self._stopped:
                if self._stopped:
                    # stopped = no new dispatches, ever: whatever is
                    # still queued stays durable for the next start
                    return []
                remaining = None if deadline is None \
                    else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    return []
                self._cond.wait(timeout=remaining)
            first = self._items.pop(0)
            group = [first]
            if first.batchable and not first.no_batch and batch_max > 1:
                self._take_same_bucket(first, batch_max, group)
                window_end = time.monotonic() + max(0.0,
                                                    float(batch_window))
                while len(group) < batch_max and not self._stopped:
                    remaining = window_end - time.monotonic()
                    if remaining <= 0:
                        break
                    self._cond.wait(timeout=remaining)
                    self._take_same_bucket(first, batch_max, group)
            obs.gauge_set("serve.queue_depth", len(self._items))
            return group

    def snapshot(self) -> list:
        with self._cond:
            return [r.summary() for r in self._items]
