"""The port's live wheel migration (mpisppy_tpu_torch/serve/migrate.py
and the manager's donor/receiver halves) against the JAX package's:
the cases of tests/test_migrate.py on the port (all but the chaos soak,
which drives a JAX tool), with every service on ``device="cpu"``, and
the wire protocol across the packages both ways — the port's client
hands a record and a bundle to the JAX receiver and the JAX client to
the port's, with equal transfer manifests (size and sha256 per member).

Layers under test, cheapest first:

- protocol units: MigrationClient retry/refusal semantics,
  MigrationReceiver staging + sha256 + load_bundle gates, the
  PeerRegistry liveness rules, endpoint-file staleness;
- the full wire protocol over a real ServeHTTPServer with a stub
  receiver service (record-only + with-bundle handoffs, idempotent
  commit, torn-transfer re-stream, bundle-verification refusal);
- donor state machine over a real ServeService (abort-and-finish-
  locally, poison-pill quarantine at --max-recoveries);
- the in-process fleet e2e: drain hands a running wheel to a live
  peer service which resumes it mid-trajectory;
- the subprocess e2e: SIGTERM'd donor -> receiver completes with
  resumed_from_iter > 0.
"""

from __future__ import annotations

import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

from mpisppy_tpu_torch import obs
from mpisppy_tpu_torch.ckpt import bundle as B
from mpisppy_tpu_torch.serve.migrate import (MigrationClient,
                                             MigrationError,
                                             MigrationReceiver,
                                             PeerRegistry, pid_alive,
                                             read_endpoint,
                                             resolve_interrupted_migration)
from mpisppy_tpu_torch.serve.queue import (AdmissionQueue, QueueFull,
                                           Request, RequestStore)
from mpisppy_tpu_torch.utils.config import ServeConfig
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

FARMER = {"model": "farmer", "num_scens": 3,
          "algo": {"max_iterations": 30}}


@pytest.fixture
def mem_obs():
    rec = obs.configure(out_dir=None)
    yield rec
    obs.shutdown()


def _write_test_bundle(ckpt_dir, fingerprint, iteration=7):
    arrays = {"W": np.zeros((3, 4)), "xbar": np.zeros((3, 4)),
              "xsqbar": np.zeros((3, 4)), "rho": np.ones((3, 4)),
              "iter": np.asarray(iteration)}
    return B.write_bundle(str(ckpt_dir), arrays,
                          {"fingerprint": fingerprint},
                          iteration=iteration, seq=1)


# ---------------- config + bundle helpers ----------------

def test_serve_config_migration_knobs_validation(tmp_path):
    ok = ServeConfig(state_dir=str(tmp_path), peers=("127.0.0.1:1",),
                     migrate_deadline=5.0, migrate_retries=2,
                     max_recoveries=1)
    assert ok.validate() is ok
    for bad in (dict(peers=("",)), dict(migrate_deadline=0),
                dict(migrate_retries=0), dict(max_recoveries=0)):
        with pytest.raises(ValueError):
            ServeConfig(state_dir=str(tmp_path), **bad).validate()


def test_transfer_manifest_hashes_every_member(tmp_path):
    bundle = _write_test_bundle(tmp_path / "ns", "fp-x")
    man = B.transfer_manifest(bundle)
    assert set(man) == set(os.listdir(bundle))
    for name, meta in man.items():
        fp = os.path.join(bundle, name)
        assert meta["size"] == os.path.getsize(fp)
        assert meta["sha256"] == B.file_sha256(fp)
    # the streaming hash agrees with a one-shot read
    import hashlib
    raw = open(os.path.join(bundle, "manifest.json"), "rb").read()
    assert B.file_sha256(os.path.join(bundle, "manifest.json")) \
        == hashlib.sha256(raw).hexdigest()


# ---------------- stub fleet plumbing ----------------

class _FleetStub:
    """Receiver-side duck-typed service for the HTTP plane: a REAL
    MigrationReceiver + dict store, with the manager's idempotency
    rules in miniature — the protocol under test without an engine."""

    def __init__(self, state_dir, receiver_cls=MigrationReceiver,
                 bundle_mod=B):
        self.state_dir = str(state_dir)
        self.receiver = receiver_cls(self.state_dir)
        self.B = bundle_mod
        self.queue = AdmissionQueue(limit=8)
        self.cache = {}
        self._active_hubs = {}
        self._preempting = False
        self._draining = False
        self._stop = False
        self.refuse_offers = False
        self.committed = {}

    def submit(self, payload):
        req = Request(payload, bucket="stub")
        self.queue.push(req)
        return req

    def result(self, rid):
        return self.committed.get(rid)

    def status_snapshot(self):
        return {"type": "stub"}

    def queue_snapshot(self):
        return {}

    def peer_hint(self):
        return None

    def drain(self, source="http"):
        self._draining = True
        return {"ok": True, "draining": True}

    def migrate_offer(self, payload):
        if self.refuse_offers or self._draining or self._preempting:
            raise MigrationError("refused", "receiver is draining")
        rid = ((payload or {}).get("request") or {}).get("id")
        if rid and rid in self.committed:
            return {"ok": True, "already": True, "request_id": rid}
        return {"ok": True, **self.receiver.offer(payload)}

    def migrate_put(self, mid, name, stream, length):
        return self.receiver.put_member(mid, name, stream, int(length))

    def migrate_abort(self, payload):
        mid = (payload or {}).get("migration_id")
        if not mid:
            raise MigrationError("refused", "abort needs migration_id")
        self.receiver.abort(str(mid))
        return {"ok": True, "migration_id": mid}

    def migrate_commit(self, payload):
        rid = (payload or {}).get("request_id")
        if rid and rid in self.committed:
            mid0 = (payload or {}).get("migration_id")
            if mid0:
                self.receiver.abort(mid0)
            return {"ok": True, "already": True, "request_id": rid}
        mid = (payload or {}).get("migration_id")
        if not mid:
            raise MigrationError("refused", "commit needs migration_id")
        rec0 = self.receiver.offer_record(mid)
        fp = self.B.config_fingerprint({"bucket": rec0.get("bucket"),
                                        "request": rec0["id"]})
        rec, bundle = self.receiver.finalize(
            mid, os.path.join(self.state_dir, "ckpt", rec0["id"]), fp)
        self.committed[rec["id"]] = {**rec, "bundle": bundle}
        return {"ok": True, "request_id": rec["id"],
                "resumed": bool(bundle)}


def _fleet_server(tmp_path, name="recv", jax_side=False):
    """A stub receiver behind a real HTTP plane: the port's, or with
    ``jax_side`` the JAX package's (its http plane, receiver and
    bundle module)."""
    if jax_side:
        from mpisppy_tpu.ckpt import bundle as JB
        from mpisppy_tpu.serve.http import ServeHTTPServer
        from mpisppy_tpu.serve.migrate import MigrationReceiver as JR
        svc = _FleetStub(tmp_path / name, receiver_cls=JR, bundle_mod=JB)
    else:
        from mpisppy_tpu_torch.serve.http import ServeHTTPServer
        svc = _FleetStub(tmp_path / name)
    srv = ServeHTTPServer(svc, 0).start()
    return svc, srv, f"127.0.0.1:{srv.port}"


def _record(payload=FARMER, bucket="bucket-x", rid=None):
    req = Request(payload, req_id=rid, bucket=bucket)
    return req.to_json()


# ---------------- peers + endpoint files ----------------

def test_peer_registry_live_semantics(tmp_path, mem_obs):
    svc, srv, peer = _fleet_server(tmp_path)
    try:
        reg = PeerRegistry([peer], ttl=0.0)
        assert len(reg) == 1
        assert reg.probe(peer) and reg.first_live() == peer
        # a draining peer is NOT live for migration — handing a wheel
        # to an evacuating host would just bounce it again
        svc._draining = True
        assert not reg.probe(peer) and not reg.any_live()
        svc._draining = False
        svc._preempting = True
        assert not reg.probe(peer)
        svc._preempting = False
        # TTL caching: a fresh verdict is reused inside the window
        cached = PeerRegistry([peer], ttl=60.0)
        assert cached.probe(peer)
        svc._draining = True
        assert cached.probe(peer)      # stale-but-cached
        assert not PeerRegistry([peer], ttl=0.0).probe(peer)
    finally:
        srv.stop()
    # dead port: not live, no exception
    assert PeerRegistry([peer], ttl=0.0).first_live() is None


def test_endpoint_file_pid_staleness(tmp_path):
    state = tmp_path / "state"
    state.mkdir()
    assert read_endpoint(str(state)) == (None, False)
    # a dead pid: fork a child that exits immediately and reap it
    pid = os.fork()
    if pid == 0:
        os._exit(0)
    os.waitpid(pid, 0)
    assert not pid_alive(pid)
    assert pid_alive(os.getpid())
    (state / "serve.json").write_text(
        json.dumps({"port": 1, "pid": pid}))
    info, stale = read_endpoint(str(state))
    assert info["pid"] == pid and stale is True
    (state / "serve.json").write_text(
        json.dumps({"port": 1, "pid": os.getpid()}))
    assert read_endpoint(str(state))[1] is False


def test_endpoint_file_detects_recycled_pid(tmp_path, mem_obs):
    """A live pid is not proof of a live service: after a reboot the
    dead service's pid can be recycled by an unrelated process. The
    writer necessarily predates its own serve.json, so a pid holder
    born AFTER the recorded started_unix is recycled — stale, and
    startup overwrites instead of refusing the state dir forever."""
    from mpisppy_tpu_torch.serve.manager import _check_endpoint_file
    from mpisppy_tpu_torch.serve.migrate import pid_start_time
    if pid_start_time(os.getpid()) is None:
        pytest.skip("/proc start-time probe unavailable")
    state = tmp_path / "state"
    state.mkdir()
    # this (live) process stands in for the recycled holder: the file
    # claims a service that started long before we were born
    (state / "serve.json").write_text(
        json.dumps({"port": 1, "pid": os.getpid(),
                    "started_unix": 0.0}))
    info, stale = read_endpoint(str(state))
    assert info["pid"] == os.getpid() and stale is True
    # a coherent record (writer born before it wrote) stays live
    (state / "serve.json").write_text(
        json.dumps({"port": 1, "pid": os.getpid(),
                    "started_unix": time.time() + 5.0}))
    assert read_endpoint(str(state))[1] is False
    # startup: a live FOREIGN pid born after the recorded start reads
    # as recycled — overwritten, not refused (pid 1 was born at boot,
    # long after a claimed started_unix of epoch 0)
    if pid_start_time(1) is not None:
        (state / "serve.json").write_text(
            json.dumps({"port": 1, "pid": 1, "started_unix": 0.0}))
        assert _check_endpoint_file(str(state)) is True
        # ...while one we cannot date still refuses conservatively
        (state / "serve.json").write_text(
            json.dumps({"port": 1, "pid": 1}))
        assert _check_endpoint_file(str(state)) is False


def test_check_endpoint_file_overwrites_dead_refuses_live(tmp_path,
                                                          mem_obs):
    from mpisppy_tpu_torch.serve.manager import _check_endpoint_file
    state = tmp_path / "state"
    state.mkdir()
    assert _check_endpoint_file(str(state)) is True      # no file
    pid = os.fork()
    if pid == 0:
        os._exit(0)
    os.waitpid(pid, 0)
    (state / "serve.json").write_text(
        json.dumps({"port": 1, "pid": pid}))
    assert _check_endpoint_file(str(state)) is True      # stale: overwrite
    # pid 1 is alive and not us: two writers over one store would
    # corrupt it — startup must refuse
    (state / "serve.json").write_text(
        json.dumps({"port": 1, "pid": 1}))
    assert _check_endpoint_file(str(state)) is False


# ---------------- client retry/refusal state machine ----------------

class _CodesHandler(BaseHTTPRequestHandler):
    def log_message(self, *args):
        pass

    def do_POST(self):
        n = int(self.headers.get("Content-Length") or 0)
        self.rfile.read(n)
        srv = self.server
        srv.calls.append(self.path)
        code = srv.codes.pop(0) if srv.codes else 200
        body = b"{}"
        self.send_response(code)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    do_GET = do_POST


def _code_server(codes):
    srv = ThreadingHTTPServer(("127.0.0.1", 0), _CodesHandler)
    srv.daemon_threads = True
    srv.codes = list(codes)
    srv.calls = []
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, f"127.0.0.1:{srv.server_address[1]}"


def test_client_refusal_is_terminal_transport_errors_retry(tmp_path):
    # 4xx = the peer understood and said no: ONE call, no retry
    srv, peer = _code_server([400])
    try:
        c = MigrationClient(peer, deadline=10, retries=3, backoff=0.01)
        with pytest.raises(MigrationError) as ei:
            c.migrate(_record(), None)
        assert ei.value.reason == "refused"
        assert len(srv.calls) == 1
    finally:
        srv.shutdown()
    # 5xx retries up to the attempt budget, then "unreachable"
    srv, peer = _code_server([500, 500, 500])
    try:
        c = MigrationClient(peer, deadline=10, retries=3, backoff=0.01)
        with pytest.raises(MigrationError) as ei:
            c.migrate(_record(), None)
        assert ei.value.reason == "unreachable"
        assert len(srv.calls) == 3
    finally:
        srv.shutdown()
    # transient 5xx then success: the retry path completes the offer
    srv, peer = _code_server([500, 200, 200])
    try:
        c = MigrationClient(peer, deadline=10, retries=3, backoff=0.01)
        assert c.migrate(_record(), None) == {}
        assert len(srv.calls) >= 2
    finally:
        srv.shutdown()
    # a dead port is "unreachable"; an exhausted deadline is "timeout"
    with pytest.raises(MigrationError) as ei:
        MigrationClient("127.0.0.1:1", deadline=5, retries=2,
                        backoff=0.01).migrate(_record(), None)
    assert ei.value.reason == "unreachable"
    with pytest.raises(MigrationError) as ei:
        MigrationClient("127.0.0.1:1", deadline=0.0,
                        retries=2).migrate(_record(), None)
    assert ei.value.reason == "timeout"


def test_resolve_interrupted_migration_probes_peer(tmp_path, mem_obs):
    assert resolve_interrupted_migration(None, "req-x") is False
    assert resolve_interrupted_migration("127.0.0.1:1", "req-x",
                                         timeout=0.5) is False
    svc, srv, peer = _fleet_server(tmp_path)
    try:
        assert resolve_interrupted_migration(peer, "req-x") is False
        svc.committed["req-x"] = {"id": "req-x", "status": "done"}
        assert resolve_interrupted_migration(peer, "req-x") is True
        # a peer record in the 'migrated' state is the PEER's own
        # hand-away marker, not ownership — settling ours against it
        # would lose a round-tripped request
        svc.committed["req-x"] = {"id": "req-x", "status": "migrated"}
        assert resolve_interrupted_migration(peer, "req-x") is False
    finally:
        srv.stop()


# ---------------- the wire protocol end to end ----------------

def test_protocol_record_only_handoff_and_idempotent_reoffer(
        tmp_path, mem_obs):
    svc, srv, peer = _fleet_server(tmp_path)
    try:
        rec = _record(rid="req-solo")
        c = MigrationClient(peer, deadline=20, backoff=0.01)
        out = c.migrate(rec, None)
        assert out["ok"] and out["request_id"] == "req-solo"
        assert out["resumed"] is False
        assert svc.committed["req-solo"]["payload"] == FARMER
        assert svc.receiver.open_offers() == 0
        # a re-offer of the same request id (donor retry after a lost
        # ack) takes the idempotency fast path: no staging, no
        # double-admission
        out2 = MigrationClient(peer, deadline=20,
                               backoff=0.01).migrate(rec, None)
        assert out2.get("already") is True
        assert c.probe_committed("req-solo") is True
        assert c.probe_committed("req-unknown") is False
    finally:
        srv.stop()


def test_protocol_bundle_handoff_streams_and_verifies(tmp_path,
                                                      mem_obs):
    svc, srv, peer = _fleet_server(tmp_path)
    try:
        rec = _record(rid="req-b", bucket="bucket-x")
        fp = B.config_fingerprint({"bucket": "bucket-x",
                                   "request": "req-b"})
        bundle = _write_test_bundle(tmp_path / "donor-ns", fp)
        out = MigrationClient(peer, deadline=30,
                              backoff=0.01).migrate(rec, bundle)
        assert out["ok"] and out["resumed"] is True
        landed = svc.committed["req-b"]["bundle"]
        # the receiver re-ran the SAME load_bundle gate a local resume
        # runs; the landed bundle is byte-identical and LATEST points
        # at it
        man, arrays, _ = B.load_bundle(landed, fingerprint=fp)
        assert man["fingerprint"] == fp and arrays["iter"] == 7
        ns = os.path.dirname(landed)
        assert B.latest_bundle(ns) == landed
        assert svc.receiver.open_offers() == 0
        assert not os.listdir(os.path.join(svc.state_dir, "migrate_in"))
    finally:
        srv.stop()


@pytest.mark.parametrize("donor", ["port", "jax"])
def test_protocol_crosses_the_packages(tmp_path, mem_obs, donor):
    """The wire protocol is the JAX package's byte for byte: the
    port's client hands a record and a bundle to the JAX receiver
    ("port"), and the JAX client to the port's ("jax"). Each landed
    bundle passes the receiving package's load_bundle gate with the
    solo-request fingerprint, and its transfer manifest (size and
    sha256 per member) equals the donor's exactly."""
    from mpisppy_tpu.ckpt import bundle as JB
    from mpisppy_tpu.serve.migrate import MigrationClient as JClient
    if donor == "port":
        donor_B, recv_B, client_cls = B, JB, MigrationClient
    else:
        donor_B, recv_B, client_cls = JB, B, JClient
    svc, srv, peer = _fleet_server(tmp_path, jax_side=donor == "port")
    try:
        assert svc.B is recv_B
        # record only
        out = client_cls(peer, deadline=20, backoff=0.01).migrate(
            _record(rid="req-x0"), None)
        assert out["ok"] and out["resumed"] is False
        assert svc.committed["req-x0"]["payload"] == FARMER
        # with a bundle written by the donor's package
        fp = donor_B.config_fingerprint({"bucket": "bucket-x",
                                         "request": "req-x1"})
        assert fp == recv_B.config_fingerprint({"bucket": "bucket-x",
                                                "request": "req-x1"})
        arrays = {"W": np.arange(12.0).reshape(3, 4),
                  "xbar": np.ones((3, 4)), "xsqbar": np.ones((3, 4)),
                  "rho": np.full((3, 4), 2.0), "iter": np.asarray(9)}
        bundle = donor_B.write_bundle(str(tmp_path / "donor-ns"),
                                      arrays, {"fingerprint": fp},
                                      iteration=9, seq=1)
        out = client_cls(peer, deadline=30, backoff=0.01).migrate(
            _record(rid="req-x1", bucket="bucket-x"), bundle)
        assert out["ok"] and out["resumed"] is True
        landed = svc.committed["req-x1"]["bundle"]
        assert recv_B.transfer_manifest(landed) \
            == donor_B.transfer_manifest(bundle)
        man, got, _ = recv_B.load_bundle(landed, fingerprint=fp)
        assert man["fingerprint"] == fp and got["iter"] == 9
        np.testing.assert_array_equal(got["W"], arrays["W"])
        assert recv_B.latest_bundle(os.path.dirname(landed)) == landed
        assert svc.receiver.open_offers() == 0
    finally:
        srv.stop()


def test_protocol_torn_transfer_restreams_once_then_aborts(tmp_path,
                                                           mem_obs):
    svc, srv, peer = _fleet_server(tmp_path)
    try:
        fp = B.config_fingerprint({"bucket": "bucket-x",
                                   "request": "req-t"})
        bundle = _write_test_bundle(tmp_path / "donor-ns", fp)
        # tear exactly the first member stream: the receiver's sha256
        # gate refuses it, the client re-streams clean, the handoff
        # completes — a torn transfer is a retry, not a loss
        tears = iter([True])
        out = MigrationClient(
            peer, deadline=30, backoff=0.01,
            tear_hook=lambda: next(tears, False)).migrate(
            _record(rid="req-t", bucket="bucket-x"), bundle)
        assert out["ok"] and out["resumed"] is True
        # tear EVERY stream: one re-stream is allowed, then the donor
        # aborts with the byte-layer reason
        with pytest.raises(MigrationError) as ei:
            MigrationClient(
                peer, deadline=30, backoff=0.01,
                tear_hook=lambda: True).migrate(
                _record(rid="req-t2", bucket="bucket-x"), bundle)
        assert ei.value.reason == "transfer"
        assert "req-t2" not in svc.committed
        # the donor's best-effort abort released the staged offer —
        # no migrate_in leak waiting on the receiver's TTL sweep
        assert svc.receiver.open_offers() == 0
        assert not os.listdir(os.path.join(svc.state_dir, "migrate_in"))
    finally:
        srv.stop()


def test_protocol_bundle_verification_refusal(tmp_path, mem_obs):
    """The staged bundle hashes clean on the wire but fails the
    load_bundle semantic gate (fingerprint mismatch): commit refuses
    with a reasoned 4xx, the donor books bundle_rejected, and the
    receiver keeps NO partial state."""
    svc, srv, peer = _fleet_server(tmp_path)
    try:
        bundle = _write_test_bundle(tmp_path / "donor-ns",
                                    "fp-of-somebody-else")
        with pytest.raises(MigrationError) as ei:
            MigrationClient(peer, deadline=30, backoff=0.01).migrate(
                _record(rid="req-v", bucket="bucket-x"), bundle)
        assert ei.value.reason == "bundle_rejected"
        assert "req-v" not in svc.committed
        ns = os.path.join(svc.state_dir, "ckpt", "req-v")
        assert not os.path.isdir(ns) or B.latest_bundle(ns) is None
    finally:
        srv.stop()


def test_receiver_refuses_malformed_offers_and_members(tmp_path):
    recv = MigrationReceiver(str(tmp_path / "state"))
    with pytest.raises(MigrationError, match="schema"):
        recv.offer({"schema": 99, "migration_id": "m", "request":
                    {"id": "r"}})
    with pytest.raises(MigrationError, match="migration_id"):
        recv.offer({"schema": 1, "request": {"id": "r"}})
    with pytest.raises(MigrationError, match="path-shaped"):
        recv.offer({"schema": 1, "migration_id": "m",
                    "request": {"id": "r"},
                    "bundle": {"name": "b",
                               "files": {"../evil": {"size": 1,
                                                     "sha256": "x"}}}})
    with pytest.raises(MigrationError, match="malformed"):
        recv.offer({"schema": 1, "migration_id": "../up",
                    "request": {"id": "r"}})
    import io
    recv.offer({"schema": 1, "migration_id": "m1",
                "request": {"id": "r1"},
                "bundle": {"name": "b",
                           "files": {"hub.npz": {"size": 3,
                                                 "sha256": "0" * 64}}}})
    with pytest.raises(MigrationError, match="not in the offer"):
        recv.put_member("m1", "other.npz", io.BytesIO(b"abc"), 3)
    with pytest.raises(MigrationError, match="sha256"):
        recv.put_member("m1", "hub.npz", io.BytesIO(b"abc"), 3)
    with pytest.raises(MigrationError, match="torn"):
        recv.put_member("m1", "hub.npz", io.BytesIO(b"a"), 1)
    # commit before the members arrived is a transfer failure and
    # consumes the staging entry
    with pytest.raises(MigrationError, match="missing"):
        recv.finalize("m1", str(tmp_path / "ckpt"), None)
    assert recv.open_offers() == 0
    with pytest.raises(MigrationError, match="unknown migration"):
        recv.put_member("m1", "hub.npz", io.BytesIO(b"abc"), 3)


def test_receiver_sweep_reclaims_abandoned_offers(tmp_path, mem_obs):
    """A donor that dies (or times out) after a successful offer never
    sends commit OR abort: the TTL sweep reclaims the staged offer and
    its migrate_in dir so a long-lived receiver under flaky donors
    cannot accumulate unbounded disk/memory."""
    recv = MigrationReceiver(str(tmp_path / "state"), offer_ttl=10.0)
    recv.offer({"schema": 1, "migration_id": "m-dead",
                "request": {"id": "r-dead"},
                "bundle": {"name": "b",
                           "files": {"hub.npz": {"size": 3,
                                                 "sha256": "0" * 64}}}})
    recv.offer({"schema": 1, "migration_id": "m-live",
                "request": {"id": "r-live"}})
    t0 = recv._offers["m-dead"]["opened_unix"]
    assert recv.sweep(now=t0 + 5.0) == 0       # young offers stay
    assert recv.open_offers() == 2
    recv._offers["m-dead"]["opened_unix"] = t0 - 60.0
    assert recv.sweep(now=t0) == 1
    assert recv.open_offers() == 1
    assert not os.path.isdir(os.path.join(recv.dir, "m-dead"))
    assert os.path.isdir(os.path.join(recv.dir, "m-live"))
    assert obs.counter_value(
        "serve.migrate.rejected.offer_expired") == 1
    # a swept offer is gone for good: the late commit refuses
    with pytest.raises(MigrationError, match="unknown migration"):
        recv.offer_record("m-dead")


# ---------------- Retry-After on the HTTP plane ----------------

def _raw_post(url, obj):
    req = urllib.request.Request(
        url, data=json.dumps(obj).encode(),
        headers={"Content-Type": "application/json"})
    return urllib.request.urlopen(req, timeout=10)


def test_http_429_and_503_carry_retry_after(tmp_path, mem_obs):
    svc, srv, peer = _fleet_server(tmp_path)
    base = f"http://{peer}"
    try:
        svc.queue = AdmissionQueue(limit=1)
        assert _raw_post(f"{base}/solve", FARMER).status == 202
        with pytest.raises(urllib.error.HTTPError) as ei:
            _raw_post(f"{base}/solve", FARMER)
        assert ei.value.code == 429
        assert ei.value.headers.get("Retry-After") == "1"
        # a draining service refuses with 503 + Retry-After + the live
        # peer hint the client should redirect to
        svc._draining = True
        svc.peer_hint = lambda: "127.0.0.1:9999"
        with pytest.raises(urllib.error.HTTPError) as ei:
            _raw_post(f"{base}/solve", FARMER)
        assert ei.value.code == 503
        assert ei.value.headers.get("Retry-After") == "2"
        body = json.loads(ei.value.read().decode())
        assert body["peer"] == "127.0.0.1:9999"
    finally:
        srv.stop()




# ---------------- fault-plan schema + injector ----------------

def test_serve_fault_plan_validation_and_injector():
    from mpisppy_tpu_torch.testing.faults import (ServeFaultInjector,
                                                  validate_plan)
    plan = {"seed": 1, "serve": [
        {"action": "kill", "at_wheel": 2},
        {"action": "tear_transfer", "at_transfer": 1},
        {"action": "refuse_peer", "at_offer": 1},
        {"action": "timeout_peer", "at_offer": 2, "seconds": 0.0},
        {"action": "wedge_wheel", "at_wheel": 9, "seconds": 0.0},
    ]}
    assert validate_plan(plan)
    with pytest.raises(ValueError):
        validate_plan({"serve": [{"action": "explode", "at_wheel": 1}]})
    with pytest.raises(ValueError):
        validate_plan({"serve": [{"action": "kill",
                                  "at_iteration": 1}]})
    # spoke/hub plans stay valid untouched
    assert validate_plan({"spokes": {"0": [{"action": "crash",
                                            "at_update": 1}]}})
    inj = ServeFaultInjector.from_spec(plan)
    # counted triggers are 1-based and fire ONCE
    assert inj.on_transfer() is True       # at_transfer 1
    assert inj.on_transfer() is False
    assert inj.on_offer() == ("refuse", 0.0)
    assert inj.on_offer() == (None, 0.0)   # timeout_peer seconds=0
    assert inj.on_offer() == (None, 0.0)
    # a plan with no serve specs installs nothing
    assert ServeFaultInjector.from_spec({"seed": 1}) is None


def test_clean_serve_path_never_imports_testing():
    """The env-gate contract: importing the serve stack (manager
    included) must not pull in testing/ — chaos machinery loads only
    under MPISPPY_TPU_FAULT_PLAN — nor jax or the JAX package."""
    probe = ("import sys; import mpisppy_tpu_torch.serve.migrate; "
             "import mpisppy_tpu_torch.serve.http; "
             "import mpisppy_tpu_torch.serve.manager; "
             "assert not any(m.startswith('mpisppy_tpu_torch.testing') "
             "for m in sys.modules), sorted(sys.modules); "
             "assert 'jax' not in sys.modules; "
             "assert 'mpisppy_tpu' not in sys.modules")
    env = {**os.environ, "PYTHONPATH": REPO}
    env.pop("MPISPPY_TPU_FAULT_PLAN", None)
    out = subprocess.run([sys.executable, "-c", probe], cwd=REPO,
                         env=env, capture_output=True, text=True)
    assert out.returncode == 0, out.stderr


# ---------------- donor state machine over a real service -----------

def _service(tmp_path, **over):
    from mpisppy_tpu_torch.serve.manager import ServeService
    kw = dict(state_dir=str(tmp_path / "state"), batch_window=0.5,
              batch_max=4, checkpoint_interval=0.2, device="cpu")
    kw.update(over)
    return ServeService(ServeConfig(**kw).validate())


def _wait(svc, rid, timeout=180, until=("done", "failed")):
    t0 = time.time()
    while time.time() - t0 < timeout:
        rec = svc.result(rid)
        if rec and rec["status"] in until:
            return rec
        time.sleep(0.1)
    raise TimeoutError(f"{rid}: {svc.result(rid)}")


def test_migrate_out_abort_restores_and_books_reason(tmp_path,
                                                     mem_obs):
    """Abort-and-finish-locally: every failed handoff restores the
    request's previous durable status and settles the per-process
    ledger (offered == handed_off + aborted.*)."""
    # no live peer at all
    svc = _service(tmp_path, peers=("127.0.0.1:1",))
    req = Request(FARMER, bucket="bucket-x")
    req.status = "running"
    svc.store.save(req)
    assert svc._migrate_out(req) is False
    assert req.status == "running" and req.peer is None
    assert obs.counter_value("serve.migrate.offered") == 1
    assert obs.counter_value(
        "serve.migrate.aborted.no_live_peer") == 1
    # a live peer that refuses the offer
    stub, srv, peer = _fleet_server(tmp_path)
    stub.refuse_offers = True
    try:
        svc2 = _service(tmp_path, state_dir=str(tmp_path / "b"),
                        peers=(peer,), migrate_deadline=10.0)
        req2 = Request(FARMER, bucket="bucket-x")
        req2.status = "running"
        svc2.store.save(req2)
        assert svc2._migrate_out(req2) is False
        assert req2.status == "running" and req2.peer is None
        assert svc2.store.load(req2.id).status == "running"
        assert obs.counter_value("serve.migrate.aborted.refused") == 1
        # ...and one that accepts: the record settles "migrated"
        stub.refuse_offers = False
        assert svc2._migrate_out(req2) is True
        assert req2.status == "migrated"
        assert svc2.store.load(req2.id).status == "migrated"
        assert req2.id in stub.committed
        offered = obs.counter_value("serve.migrate.offered")
        assert offered == obs.counter_value("serve.migrate.handed_off") \
            + obs.counter_value("serve.migrate.aborted.no_live_peer") \
            + obs.counter_value("serve.migrate.aborted.refused")
    finally:
        srv.stop()


def test_round_trip_handoff_supersedes_stale_migrated_record(
        tmp_path, mem_obs):
    """The rolling-deploy round trip (A migrates X to B, A restarts,
    B drains X back to A): A's leftover 'migrated' record is its
    hand-AWAY marker, not ownership — the inbound offer/commit must
    re-admit and supersede it. Acking 'already' here would settle
    BOTH hosts 'migrated' and silently lose the request."""
    svc = _service(tmp_path)
    stale = Request(FARMER, req_id="req-rt", bucket="bucket-x")
    stale.status = "migrated"
    stale.peer = "127.0.0.1:9"
    svc.store.save(stale)
    rec = _record(rid="req-rt")
    out = svc.migrate_offer({"schema": 1, "migration_id": "m-rt",
                             "request": rec, "bundle": None})
    assert out.get("already") is not True     # round trip re-admits
    out = svc.migrate_commit({"schema": 1, "migration_id": "m-rt",
                              "request_id": "req-rt"})
    assert out["ok"] and out.get("already") is not True
    landed = svc.store.load("req-rt")
    assert landed.status == "queued"          # superseded, runnable
    # whereas a record this host really owns (any non-migrated
    # status) keeps the idempotency fast path: no double admission
    out = svc.migrate_offer({"schema": 1, "migration_id": "m-rt2",
                             "request": rec, "bundle": None})
    assert out.get("already") is True
    out = svc.migrate_commit({"schema": 1, "migration_id": "m-rt2",
                              "request_id": "req-rt"})
    assert out.get("already") is True
    assert svc.receiver.open_offers() == 0


def test_migrate_commit_refused_while_draining(tmp_path, mem_obs):
    """The commit guard mirrors the offer guard: an offer staged just
    before the drain began must not commit onto an evacuating host —
    the staging drops and the donor (reasoned 'draining' refusal)
    finishes the wheel locally."""
    svc = _service(tmp_path)
    svc.migrate_offer({"schema": 1, "migration_id": "m-dg",
                       "request": {"id": "req-dg"}, "bundle": None})
    assert svc.receiver.open_offers() == 1
    svc._draining = True
    with pytest.raises(MigrationError) as ei:
        svc.migrate_commit({"schema": 1, "migration_id": "m-dg",
                            "request_id": "req-dg"})
    assert ei.value.reason == "draining"
    assert svc.receiver.open_offers() == 0    # staging dropped
    assert svc.store.load("req-dg") is None   # nothing admitted
    assert obs.counter_value("serve.migrate.rejected.draining") == 1


def test_quarantine_poison_pill_after_max_recoveries(tmp_path,
                                                     mem_obs):
    """A record that keeps getting recovered without finishing is
    failed with a reasoned error instead of crash-looping the fleet
    serially."""
    state = tmp_path / "state"
    store = RequestStore(str(state))
    poison = Request(FARMER, bucket="bucket-x")
    poison.status = "preempted"
    poison.recoveries = 2          # next recovery is the 3rd: > max 2
    store.save(poison)
    survivor = Request(FARMER, bucket="bucket-x")
    survivor.status = "preempted"
    survivor.recoveries = 0
    store.save(survivor)
    svc = _service(tmp_path, max_recoveries=2, max_wheels=1)
    svc._recover()
    rec = svc.result(poison.id)
    assert rec["status"] == "failed"
    assert "quarantined" in rec["error"]
    assert rec["recoveries"] == 3
    assert obs.counter_value("serve.request.quarantined") == 1
    # the healthy record was re-admitted, not quarantined
    s = svc.result(survivor.id)
    assert s["status"] == "queued" and s["recoveries"] == 1


def test_sweep_drops_migrated_records(tmp_path, mem_obs):
    """'migrated' is terminal for the donor: retention sweeps it with
    done/failed, so handed-off records do not pile up forever."""
    store = RequestStore(str(tmp_path / "state"))
    old = Request(FARMER, bucket="b")
    old.status = "migrated"
    old.finished_unix = time.time() - 10
    store.save(old)
    svc = _service(tmp_path, request_retention=1.0)
    svc._sweep_terminal()
    assert store.load(old.id) is None


# ---------------- the in-process fleet e2e ----------------

def test_drain_migrates_running_wheel_to_live_peer(tmp_path, mem_obs):
    """THE tier-1 migration e2e, in-process: a running wheel drained
    off host A lands on host B mid-trajectory (resumed_from_iter > 0),
    completes there, and every ledger counter reconciles. Two real
    ServeServices, one real HTTP plane between them."""
    from mpisppy_tpu_torch.serve.http import ServeHTTPServer
    b = _service(tmp_path, state_dir=str(tmp_path / "b")).start()
    srv = ServeHTTPServer(b, 0).start()
    a = _service(tmp_path, state_dir=str(tmp_path / "a"),
                 peers=(f"127.0.0.1:{srv.port}",),
                 migrate_deadline=30.0).start()
    try:
        slow = a.submit({**FARMER,
                         "algo": {"max_iterations": 500,
                                  "convthresh": -1.0}})
        ns = os.path.join(str(tmp_path / "a"), "ckpt", slow.id)
        t0 = time.time()
        while time.time() - t0 < 120:
            rec = a.result(slow.id)
            if rec["status"] == "running" and os.path.isdir(ns) \
                    and any(n.startswith("bundle-")
                            for n in os.listdir(ns)):
                break
            time.sleep(0.05)
        else:
            raise TimeoutError("no bundle before drain")
        out = a.drain("test")
        assert out["draining"] and out["peer"]
        # donor settles the handoff...
        t0 = time.time()
        while time.time() - t0 < 120:
            if a.result(slow.id)["status"] == "migrated":
                break
            time.sleep(0.1)
        else:
            raise TimeoutError(f"donor: {a.result(slow.id)}")
        assert a.result(slow.id)["peer"] == f"127.0.0.1:{srv.port}"
        # ...and the receiver finishes the wheel from the bundle
        rec = _wait(b, slow.id, timeout=240)
        assert rec["status"] == "done", rec
        assert rec["resumed"] is True
        assert rec["result"]["wheel"]["resumed_from_iter"] > 0
        assert rec["migrated_from"]
        # one shared in-process registry: the whole fleet's ledger
        assert obs.counter_value("serve.migrate.offered") == 1
        assert obs.counter_value("serve.migrate.handed_off") == 1
        assert obs.counter_value("serve.migrate.accepted") == 1
        assert obs.counter_value("serve.migrate.committed") == 1
        assert obs.counter_value("serve.migrate.completed") == 1
        assert obs.counter_value("serve.drained") == 1
    finally:
        a.stop(join_timeout=30)
        srv.stop()
        b.stop(join_timeout=30)


# ---------------- the subprocess e2e (SIGTERM escalation) -----------

def _free_port():
    s = socket.socket()
    s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _spawn_fleet_member(state, port, peer_port, tdir):
    env = {**os.environ, "PYTHONPATH": REPO}
    env.pop("MPISPPY_TPU_TELEMETRY_DIR", None)
    env.pop("MPISPPY_TPU_FAULT_PLAN", None)
    return subprocess.Popen(
        [sys.executable, "-m", "mpisppy_tpu_torch", "serve",
         "--device", "cpu",
         "--port", str(port), "--state-dir", state,
         "--peers", f"127.0.0.1:{peer_port}",
         "--telemetry-dir", tdir,
         "--batch-window", "0.05", "--checkpoint-interval", "0.2",
         "--migrate-deadline", "30"],
        cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


def _get(url):
    with urllib.request.urlopen(url, timeout=15) as r:
        return r.read().decode()


def _post(url, obj):
    req = urllib.request.Request(
        url, data=json.dumps(obj).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=15) as r:
        return json.loads(r.read().decode())


def test_sigterm_escalates_to_migrate_then_exit(tmp_path):
    """The regression-gate migration smoke, as a test: SIGTERM on the
    donor of a 2-process fleet must complete the in-flight request on
    the receiver with resumed_from_iter > 0 and exactly one
    serve.migrate.completed on the receiver's /metrics."""
    ports = (_free_port(), _free_port())
    procs = []
    try:
        for i in range(2):
            procs.append(_spawn_fleet_member(
                str(tmp_path / f"s{i}"), ports[i], ports[1 - i],
                str(tmp_path / f"obs{i}")))
        bases = [f"http://127.0.0.1:{p}" for p in ports]
        t0 = time.time()
        while time.time() - t0 < 180:
            if any(p.poll() is not None for p in procs):
                raise RuntimeError(
                    f"fleet member died: {procs[0].poll()} "
                    f"{procs[1].poll()}")
            try:
                if all(json.loads(_get(f"{x}/healthz")).get("ok")
                       for x in bases):
                    break
            except OSError:
                pass
            time.sleep(0.3)
        else:
            raise TimeoutError("fleet never became healthy")
        rid = _post(f"{bases[0]}/solve",
                    {**FARMER,
                     "algo": {"max_iterations": 600,
                              "convthresh": -1.0}})["request_id"]
        latest = os.path.join(str(tmp_path / "s0"), "ckpt", rid,
                              "LATEST")
        t0 = time.time()
        while time.time() - t0 < 120 and not os.path.exists(latest):
            time.sleep(0.1)
        assert os.path.exists(latest), "donor never checkpointed"
        procs[0].send_signal(signal.SIGTERM)
        assert procs[0].wait(timeout=120) == 0, procs[0].stdout.read()
        # the donor's durable record settled "migrated", not parked
        drec = json.load(open(os.path.join(
            str(tmp_path / "s0"), "requests", f"{rid}.json"),
            encoding="utf-8"))
        assert drec["status"] == "migrated", drec
        t0 = time.time()
        rec = None
        while time.time() - t0 < 300:
            try:
                rec = json.loads(_get(f"{bases[1]}/result/{rid}"))
                if rec["status"] in ("done", "failed"):
                    break
            except (OSError, ValueError):
                pass
            time.sleep(0.3)
        assert rec and rec["status"] == "done", rec
        assert rec["result"]["wheel"]["resumed_from_iter"] > 0
        metrics = _get(f"{bases[1]}/metrics")
        assert "mpisppy_tpu_serve_migrate_completed 1" in metrics
        assert "mpisppy_tpu_serve_migrate_committed 1" in metrics
    finally:
        for p in procs:
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
        for p in procs:
            if p.poll() is None:
                try:
                    p.wait(timeout=60)
                except subprocess.TimeoutExpired:
                    p.kill()


# ---------------- analyze: the migration ledger section -------------

def test_analyze_serving_migration_section(tmp_path):
    from mpisppy_tpu_torch.obs.analyze import (load_run, render_report,
                                               serving_summary)
    d = str(tmp_path / "run")
    obs.configure(out_dir=d, role="serve")
    try:
        obs.event("serve.start", {"state_dir": "x"})
        for _ in range(3):
            obs.counter_add("serve.migrate.offered")
        obs.counter_add("serve.migrate.handed_off", 2)
        obs.counter_add("serve.migrate.aborted.refused")
        obs.counter_add("serve.migrate.committed")
        obs.counter_add("serve.migrate.completed")
        obs.counter_add("serve.request.quarantined")
    finally:
        obs.shutdown()
    sv = serving_summary(load_run(d))
    mig = sv["migration"]
    assert mig["offered"] == 3 and mig["handed_off"] == 2
    assert mig["aborted"] == {"refused": 1}
    assert mig["committed"] == 1 and mig["completed"] == 1
    assert mig["reconciled"] is True
    assert sv["quarantined"] == 1
    rep = render_report(load_run(d))
    assert "migration: 3 offered" in rep
    assert "QUARANTINED" in rep
    assert "LEDGER MISMATCH" not in rep
    # an offer that never settled is a rendered mismatch
    d2 = str(tmp_path / "run2")
    obs.configure(out_dir=d2, role="serve")
    try:
        obs.counter_add("serve.migrate.offered")
    finally:
        obs.shutdown()
    sv2 = serving_summary(load_run(d2))
    assert sv2["migration"]["reconciled"] is False
    assert "LEDGER MISMATCH" in render_report(load_run(d2))
