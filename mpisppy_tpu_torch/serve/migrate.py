"""Live wheel migration: the donor→receiver handoff protocol.

The port's copy of the JAX package's serve/migrate.py. Checkpoint
bundles are host-portable and namespaced
by construction, and the SIGTERM path (``Hub.handle_preemption``) is
the donor half, already built. This module adds the service-to-service
handoff on top: a donor drains a wheel at an iteration boundary
(forced bundle), streams the bundle + the durable request record to a
peer, and the receiver resumes the request through the existing
force-push recovery + ``--resume-from`` machinery.

The wire protocol (three endpoints on the receiving service plane):

    POST /migrate/offer          {migration_id, request, bundle?}
    PUT  /migrate/bundle/<id>?file=<name>     (raw member bytes)
    POST /migrate/commit         {migration_id}
    POST /migrate/abort          {migration_id}   (donor gave up)

Two-phase commit: the donor flips the durable request record to the
``migrating`` state BEFORE the first wire byte and settles it to
``migrated`` only after the receiver's commit ack. Any failure —
receiver refuses, transfer times out, a member hash mismatches, the
bundle fails the ``load_bundle`` gates — aborts the migration with a
reasoned ``serve.migrate.aborted.<reason>`` and the donor finishes
the wheel itself. The receiver's commit is idempotent by request id
(a re-sent commit of an already-admitted request acks without
re-admitting), so migration can never lose or double-run a request.

Transport is deliberately boring: chunked member streaming over the
stdlib HTTP client, sha256-per-member verification against the offer's
transfer manifest (ckpt/bundle.transfer_manifest), jittered
exponential retry/backoff per call under ONE per-transfer wall-clock
deadline.

The protocol is bytes + json + the ckpt bundle
helpers; only serve/manager — which composes these halves — touches
the engine.
"""

from __future__ import annotations

import http.client
import json
import os
import random
import secrets
import shutil
import threading
import time
import urllib.parse

from .. import obs
from ..ckpt.bundle import (LATEST, CheckpointError, _atomic_write_bytes,
                           load_bundle, transfer_manifest)

MIGRATE_SCHEMA = 1
_CHUNK = 64 * 1024


class MigrationError(RuntimeError):
    """A handoff that did not complete. ``reason`` is a short machine
    token (``no_live_peer``, ``refused``, ``unreachable``, ``timeout``,
    ``transfer``, ``bundle_rejected``, ...) — the suffix of the
    ``serve.migrate.aborted.<reason>`` counter the donor books before
    re-admitting the request locally."""

    def __init__(self, reason: str, detail: str = ""):
        self.reason = reason
        super().__init__(f"migration failed ({reason})"
                         + (f": {detail}" if detail else ""))


# ------------------------------------------------------------ transport


def _split(base: str):
    u = urllib.parse.urlsplit(base if "//" in base else f"http://{base}")
    return u.hostname or "127.0.0.1", u.port or 80


def http_json(method: str, base: str, path: str, obj=None,
              timeout: float = 10.0):
    """One JSON round trip -> ``(status, parsed_body_or_None)``.
    Connection-level failures raise ``OSError`` — the retry wrapper's
    signal that the peer (not the payload) is the problem."""
    host, port = _split(base)
    conn = http.client.HTTPConnection(host, port, timeout=timeout)
    try:
        body = None if obj is None else json.dumps(obj).encode()
        headers = {"Content-Type": "application/json"} if body else {}
        conn.request(method, path, body=body, headers=headers)
        r = conn.getresponse()
        raw = r.read()
        try:
            parsed = json.loads(raw.decode("utf-8")) if raw else None
        except ValueError:
            parsed = None
        return r.status, parsed
    finally:
        conn.close()


def _put_stream(base: str, path: str, fp, length: int,
                timeout: float = 30.0) -> tuple:
    """Stream ``length`` bytes from file object ``fp`` as a PUT body
    (http.client sends a file body in blocks — the chunked half of the
    transfer contract). Returns ``(status, parsed_body)``."""
    host, port = _split(base)
    conn = http.client.HTTPConnection(host, port, timeout=timeout)
    try:
        conn.request("PUT", path, body=fp,
                     headers={"Content-Length": str(length),
                              "Content-Type":
                                  "application/octet-stream"})
        r = conn.getresponse()
        raw = r.read()
        try:
            parsed = json.loads(raw.decode("utf-8")) if raw else None
        except ValueError:
            parsed = None
        return r.status, parsed
    finally:
        conn.close()


class _Truncated:
    """A file object that garbles on purpose: the chaos harness's
    ``tear_transfer`` fault delivers only the first ``allow`` real
    bytes and pads the rest with zeros, so the wire sees the promised
    Content-Length (no socket stall on either side) but the receiver's
    sha256 gate refuses the member — the mid-transfer corruption it
    stands in for."""

    def __init__(self, fp, allow: int):
        self._fp = fp
        self._left = max(0, int(allow))

    def read(self, n=-1):
        b = self._fp.read(n)
        if not b:
            return b
        if self._left >= len(b):
            self._left -= len(b)
            return b
        keep = b[:self._left]
        pad = b"\0" * (len(b) - self._left)
        self._left = 0
        return keep + pad


# --------------------------------------------------------------- peers


class PeerRegistry:
    """The ``--peers`` fleet registry: ordered peer base URLs with
    ``/healthz``-probed liveness (short-TTL cached so drain loops do
    not hammer a dead peer). A peer is *live for migration* only when
    it answers ok AND is not itself preempting or draining — handing a
    wheel to an evacuating host would just bounce it again."""

    def __init__(self, peers, probe_timeout: float = 2.0,
                 ttl: float = 2.0):
        self.peers = [str(p).rstrip("/") for p in (peers or []) if p]
        self.probe_timeout = float(probe_timeout)
        self.ttl = float(ttl)
        self._cache: dict[str, tuple] = {}     # peer -> (checked_at, live)
        self._lock = threading.Lock()

    def __len__(self):
        return len(self.peers)

    def probe(self, peer: str) -> bool:
        now = time.monotonic()
        with self._lock:
            hit = self._cache.get(peer)
            if hit is not None and now - hit[0] < self.ttl:
                return hit[1]
        live = False
        try:
            status, body = http_json("GET", peer, "/healthz",
                                     timeout=self.probe_timeout)
            live = (status == 200 and isinstance(body, dict)
                    and body.get("ok")
                    and not body.get("preempting")
                    and not body.get("draining"))
        except OSError:
            live = False
        with self._lock:
            self._cache[peer] = (now, live)
        return live

    def first_live(self) -> str | None:
        for p in self.peers:
            if self.probe(p):
                return p
        return None

    def any_live(self) -> bool:
        return self.first_live() is not None


# --------------------------------------------------------------- donor


class MigrationClient:
    """The donor half of one handoff: offer -> stream members ->
    commit, each call retried with jittered exponential backoff under
    one per-transfer wall-clock deadline. ``tear_hook`` is the chaos
    harness's injection point (returns True to tear the next member
    mid-stream); production passes None."""

    def __init__(self, peer: str, *, deadline: float = 60.0,
                 retries: int = 3, backoff: float = 0.25,
                 call_timeout: float = 10.0, tear_hook=None,
                 rng=None):
        self.peer = peer.rstrip("/")
        self.deadline = float(deadline)
        self.retries = max(1, int(retries))
        self.backoff = float(backoff)
        self.call_timeout = float(call_timeout)
        self.tear_hook = tear_hook
        self._rng = rng or random.Random()
        self._t_end = None

    # -- retry plumbing --
    def _remaining(self) -> float:
        return self._t_end - time.monotonic()

    def _sleep(self, attempt: int):
        # jittered exponential: base * 2^k scaled by U[0.5, 1.5), capped
        # by what the transfer deadline still allows
        delay = self.backoff * (2 ** attempt) \
            * (0.5 + self._rng.random())
        time.sleep(max(0.0, min(delay, self._remaining())))

    def _call(self, what: str, fn):
        """Run ``fn()`` (one HTTP round trip) with retry. ``fn`` returns
        (status, body); a 2xx returns the body, a 4xx is a REFUSAL
        (no retry — the peer understood and said no), anything else
        (5xx, connection error) retries until the attempt budget or
        the transfer deadline runs out."""
        last = None
        for attempt in range(self.retries):
            if self._remaining() <= 0:
                raise MigrationError("timeout",
                                     f"transfer deadline exhausted "
                                     f"during {what}")
            try:
                status, body = fn()
            except OSError as e:
                last = f"{what}: {e!r}"
                self._sleep(attempt)
                continue
            if 200 <= status < 300:
                return body
            if 400 <= status < 500:
                # a reasoned refusal body (http.py sends the receiver's
                # MigrationError reason) survives the wire so the donor
                # books the REAL abort cause (draining, transfer,
                # bundle_rejected) instead of a generic "refused"
                detail = body if isinstance(body, dict) else {}
                raise MigrationError(
                    str(detail.get("reason") or "refused"),
                    f"{what} -> {status} {detail.get('error', '')}")
            last = f"{what} -> {status}"
            self._sleep(attempt)
        raise MigrationError("unreachable", last or what)

    # -- the handoff --
    def migrate(self, record: dict, bundle_dir: str | None) -> dict:
        """Run the full offer/stream/commit sequence for one durable
        request record (+ optionally its checkpoint bundle dir).
        Returns the receiver's commit ack; raises MigrationError with
        a reasoned token on any non-completed path."""
        self._t_end = time.monotonic() + self.deadline
        mid = f"mig-{secrets.token_hex(6)}"
        files = {}
        bundle = None
        if bundle_dir:
            files = transfer_manifest(bundle_dir)
            bundle = {"name": os.path.basename(bundle_dir.rstrip("/")),
                      "files": files}
        offer = {"schema": MIGRATE_SCHEMA, "migration_id": mid,
                 "request": record, "bundle": bundle}
        ack = self._call("offer", lambda: http_json(
            "POST", self.peer, "/migrate/offer", offer,
            timeout=self.call_timeout)) or {}
        if ack.get("already"):
            # idempotency fast path: the receiver has this request id
            # from an earlier (interrupted) handoff — nothing to send
            return ack
        try:
            for fn in sorted(files):
                self._send_member(mid, bundle_dir, fn, files[fn])
            commit = {"schema": MIGRATE_SCHEMA, "migration_id": mid,
                      "request_id": record.get("id")}
            try:
                out = self._call("commit", lambda: http_json(
                    "POST", self.peer, "/migrate/commit", commit,
                    timeout=self.call_timeout)) or {}
            except MigrationError as e:
                if e.reason in ("unreachable", "timeout"):
                    # the commit outcome is AMBIGUOUS (ack may have
                    # been lost after the receiver admitted) — probe
                    # the durable record before declaring the handoff
                    # dead, else both hosts could run the request
                    if self.probe_committed(record.get("id")):
                        return {"ok": True, "already": True}
                    raise
                if e.reason == "refused":
                    # a bare commit refusal means the receiver
                    # examined the staged bundle and said no
                    # (load_bundle gate) — a semantic refusal, not a
                    # transport failure
                    raise MigrationError("bundle_rejected",
                                         str(e)) from e
                raise   # reasoned refusal (bundle_rejected, draining)
            return out
        except MigrationError:
            # the receiver may still hold the staged offer — tell it
            # to drop the staging now instead of leaking it until its
            # TTL sweep (best-effort; the sweep is the backstop)
            self._abort_offer(mid)
            raise

    def _send_member(self, mid: str, bundle_dir: str, name: str,
                     meta: dict):
        path = (f"/migrate/bundle/{urllib.parse.quote(mid)}"
                f"?file={urllib.parse.quote(name)}")
        size = int(meta["size"])

        def _once():
            tear = self.tear_hook is not None and self.tear_hook()
            with open(os.path.join(bundle_dir, name), "rb") as fp:
                body = _Truncated(fp, size // 2) if tear else fp
                return _put_stream(self.peer, path, body, size,
                                   timeout=max(self.call_timeout,
                                               self._remaining()
                                               if self._remaining() > 0
                                               else self.call_timeout))

        try:
            self._call(f"bundle member {name}", _once)
        except MigrationError as e:
            if e.reason in ("refused", "transfer"):
                # hash/size mismatch is a transfer integrity failure
                # (retried inside _call only for transport errors) —
                # re-stream the member once more before giving up
                try:
                    self._call(f"bundle member {name} (resend)", _once)
                    return
                except MigrationError:
                    raise MigrationError("transfer", str(e)) from e
            raise

    def _abort_offer(self, mid: str):
        """Best-effort: release the receiver's staged offer after the
        donor gives up, so the migrate_in dir does not linger on the
        peer until its TTL sweep. Idempotent and allowed to fail — an
        already-consumed or unknown id is a no-op over there."""
        try:
            http_json("POST", self.peer, "/migrate/abort",
                      {"schema": MIGRATE_SCHEMA, "migration_id": mid},
                      timeout=self.call_timeout)
        except OSError:
            pass

    def probe_committed(self, req_id: str | None) -> bool:
        """Does the peer durably OWN this request? Used to resolve an
        ambiguous commit and by startup recovery to settle a request
        found mid-``migrating`` (donor died before the ack landed).
        A peer record in the ``migrated`` state does not count: that
        is the peer's own hand-AWAY marker (it gave the request to
        someone — possibly us), and settling our copy against it
        would lose a round-tripped request."""
        if not req_id:
            return False
        try:
            status, body = http_json(
                "GET", self.peer,
                f"/result/{urllib.parse.quote(req_id)}",
                timeout=self.call_timeout)
        except OSError:
            return False
        if status != 200:
            return False
        return not (isinstance(body, dict)
                    and body.get("status") == "migrated")


def resolve_interrupted_migration(peer: str | None, req_id: str,
                                  timeout: float = 5.0) -> bool:
    """Startup-recovery helper: a request found in the ``migrating``
    state means the donor died mid-handoff with the commit outcome
    unknown. True iff the recorded peer durably has the request (the
    handoff DID land — settle ``migrated``); False (peer unknown,
    unreachable, or 404) re-admits locally — the at-least-once arm of
    the protocol, with the receiver's idempotent commit as the
    double-admission guard."""
    if not peer:
        return False
    return MigrationClient(peer, deadline=timeout,
                           retries=1,
                           call_timeout=timeout).probe_committed(req_id)


# ------------------------------------------------------------- receiver


class MigrationReceiver:
    """The receiver half's staging machinery: offers open a staging
    dir under ``<state_dir>/migrate_in/<migration id>/``, PUT members
    stream into it with incremental sha256 verification against the
    offer's transfer manifest, and finalize assembles the staged files
    into the request's checkpoint namespace — THROUGH the
    ``load_bundle`` fingerprint/finiteness gates — before the manager
    admits the request. Everything here is refusable: a bad member, a
    missing member, or a gate failure cleans the staging dir and
    raises ``MigrationError`` so the HTTP plane can answer with a
    reasoned 4xx."""

    def __init__(self, state_dir: str, offer_ttl: float = 900.0):
        self.dir = os.path.join(str(state_dir), "migrate_in")
        self.offer_ttl = float(offer_ttl)
        self._offers: dict[str, dict] = {}
        self._lock = threading.Lock()
        # stale staging from a killed receiver is dead weight — a new
        # donor always starts a fresh migration id
        shutil.rmtree(self.dir, ignore_errors=True)
        os.makedirs(self.dir, exist_ok=True)

    def _staging(self, mid: str) -> str:
        if os.sep in mid or mid.startswith("."):
            raise MigrationError("refused", "malformed migration id")
        return os.path.join(self.dir, mid)

    def offer(self, payload: dict) -> dict:
        if not isinstance(payload, dict) \
                or payload.get("schema") != MIGRATE_SCHEMA:
            raise MigrationError(
                "refused", f"unknown migrate schema "
                           f"{payload.get('schema') if isinstance(payload, dict) else payload!r}")
        mid = payload.get("migration_id")
        record = payload.get("request")
        if not mid or not isinstance(record, dict) \
                or not record.get("id"):
            raise MigrationError("refused",
                                 "offer needs migration_id + request")
        bundle = payload.get("bundle")
        files = dict((bundle or {}).get("files") or {})
        for fn in files:
            if os.sep in fn or fn.startswith("."):
                raise MigrationError("refused",
                                     f"path-shaped member name {fn!r}")
        staging = self._staging(str(mid))
        os.makedirs(staging, exist_ok=True)
        with self._lock:
            self._offers[str(mid)] = {
                "request": record,
                "bundle_name": (bundle or {}).get("name"),
                "files": files, "received": set(),
                "staging": staging, "opened_unix": time.time()}
        return {"migration_id": mid, "files": sorted(files)}

    def _offer_for(self, mid: str) -> dict:
        with self._lock:
            off = self._offers.get(str(mid))
        if off is None:
            raise MigrationError("refused",
                                 f"unknown migration id {mid!r}")
        return off

    def offer_record(self, mid: str) -> dict:
        """The durable request record riding an open offer."""
        return self._offer_for(mid)["request"]

    def put_member(self, mid: str, name: str, stream, length: int) -> dict:
        """Stream one member into staging, hashing as it lands; size
        or sha256 mismatch refuses (the donor re-streams or aborts)."""
        import hashlib
        off = self._offer_for(mid)
        meta = off["files"].get(name)
        if meta is None:
            raise MigrationError("refused",
                                 f"member {name!r} not in the offer "
                                 "manifest")
        want_size, want_sha = int(meta["size"]), str(meta["sha256"])
        h = hashlib.sha256()
        got = 0
        tmp = os.path.join(off["staging"], f".tmp-{name}")
        with open(tmp, "wb") as out:
            left = int(length)
            while left > 0:
                b = stream.read(min(_CHUNK, left))
                if not b:
                    break
                h.update(b)
                out.write(b)
                got += len(b)
                left -= len(b)
        if got != want_size:
            try:
                os.remove(tmp)
            except OSError:
                pass
            raise MigrationError(
                "transfer", f"{name}: got {got} bytes, manifest says "
                            f"{want_size} (torn transfer)")
        if h.hexdigest() != want_sha:
            try:
                os.remove(tmp)
            except OSError:
                pass
            raise MigrationError("transfer",
                                 f"{name}: sha256 mismatch")
        os.replace(tmp, os.path.join(off["staging"], name))
        off["received"].add(name)
        return {"name": name, "size": got}

    def finalize(self, mid: str, ckpt_ns: str,
                 fingerprint: str | None) -> tuple:
        """All members in? Assemble the staged bundle under the
        request's checkpoint namespace, gate it through
        ``load_bundle`` (schema / fingerprint / member sizes /
        finiteness — the same firewall a local resume runs), and
        return ``(record, bundle_path_or_None)``. The staging entry is
        consumed either way."""
        off = self._offer_for(mid)
        record = off["request"]
        missing = set(off["files"]) - off["received"]
        if missing:
            self.abort(mid)
            raise MigrationError(
                "transfer", f"commit before members arrived: "
                            f"missing {sorted(missing)}")
        if not off["files"]:
            self.abort(mid)
            return record, None       # record-only handoff (no bundle)
        name = off["bundle_name"] or f"bundle-{mid}"
        if os.sep in str(name) or str(name).startswith("."):
            self.abort(mid)
            raise MigrationError("refused",
                                 f"path-shaped bundle name {name!r}")
        os.makedirs(ckpt_ns, exist_ok=True)
        final = os.path.join(ckpt_ns, str(name))
        shutil.rmtree(final, ignore_errors=True)
        os.replace(off["staging"], final)
        with self._lock:
            self._offers.pop(str(mid), None)
        try:
            load_bundle(final, fingerprint)
        except CheckpointError as e:
            shutil.rmtree(final, ignore_errors=True)
            raise MigrationError("bundle_rejected",
                                 f"{e.reason}: {e}") from e
        _atomic_write_bytes(os.path.join(ckpt_ns, LATEST),
                            (str(name) + "\n").encode())
        return record, final

    def abort(self, mid: str):
        with self._lock:
            off = self._offers.pop(str(mid), None)
        if off is not None:
            shutil.rmtree(off["staging"], ignore_errors=True)

    def sweep(self, now: float | None = None) -> int:
        """Reclaim offers whose donor went silent — a successful offer
        whose commit (or abort) never arrived because the donor died,
        timed out, or lost connectivity. Anything older than
        ``offer_ttl`` drops with its staging dir, so a long-lived
        receiver under flaky donors cannot accumulate unbounded
        migrate_in disk or ``_offers`` memory. Returns the count
        swept; cheap enough for a worker loop to call every tick."""
        now = time.time() if now is None else float(now)
        with self._lock:
            expired = [mid for mid, off in self._offers.items()
                       if now - off["opened_unix"] > self.offer_ttl]
        for mid in expired:
            self.abort(mid)
            obs.counter_add("serve.migrate.rejected.offer_expired")
            obs.event("serve.migrate_expire", {"migration_id": mid})
        return len(expired)

    def open_offers(self) -> int:
        with self._lock:
            return len(self._offers)


# ------------------------------------------------------ endpoint files


def pid_alive(pid) -> bool:
    """Is this pid a live process? (signal 0 probe — permission errors
    count as alive: the pid exists, it just isn't ours)."""
    try:
        os.kill(int(pid), 0)
    except (ProcessLookupError, ValueError, TypeError):
        return False
    except PermissionError:
        return True
    except OSError:
        return False
    return True


def pid_start_time(pid) -> float | None:
    """Unix start time of a live pid via ``/proc`` (Linux); None when
    indeterminate (no /proc, pid gone, unparsable). The pid-reuse
    disambiguator for endpoint files: a recycled pid belongs to a
    process born AFTER the dead service wrote its record."""
    try:
        with open(f"/proc/{int(pid)}/stat", "rb") as f:
            stat = f.read().decode("ascii", "replace")
        # the parenthesized comm may itself contain spaces/parens —
        # split only what follows the LAST ')'; starttime is stat
        # field 22 (clock ticks since boot), index 19 after field 3
        ticks = int(stat.rsplit(")", 1)[1].split()[19])
        with open("/proc/stat", "rb") as f:
            for line in f:
                if line.startswith(b"btime"):
                    return (int(line.split()[1])
                            + ticks / os.sysconf("SC_CLK_TCK"))
        return None
    except (OSError, ValueError, IndexError, TypeError):
        return None


def read_endpoint(state_dir: str) -> tuple:
    """``(info, stale)`` for ``<state_dir>/serve.json``. ``info`` is
    the parsed endpoint record or None; ``stale`` is True when the
    file exists but its recorded pid is dead — OR alive yet provably
    not the writer: after a reboot or long downtime the pid can be
    recycled by an unrelated process, and the writer necessarily
    predates its own serve.json, so a pid holder born after the
    file's ``started_unix`` is a recycled pid, not the service.
    Clients (load benches, chaos harnesses, tests) must treat a stale
    file as "no service" instead of connecting to nothing."""
    path = os.path.join(str(state_dir), "serve.json")
    try:
        with open(path, encoding="utf-8") as f:
            info = json.load(f)
    except (OSError, ValueError):
        return None, False
    if not isinstance(info, dict):
        return None, False
    stale = not pid_alive(info.get("pid"))
    if not stale:
        born = pid_start_time(info.get("pid"))
        try:
            started = float(info["started_unix"])
        except (KeyError, TypeError, ValueError):
            started = None
        if born is not None and started is not None \
                and born > started + 1.0:     # 1s clock-granularity slack
            stale = True
    return info, stale
