"""The port's serving layer (mpisppy_tpu_torch/serve, ServeConfig, the
``serve`` subcommand) against the JAX package's: the cases of
tests/test_serve.py on the port (all but the load bench's, which drives
a JAX tool) with every engine on ``device="cpu"``, the serve cases of
tests/test_shrink.py and tests/test_stream.py, and parity with the JAX
package's serve modules:

- (a) the same payloads through both packages' validate_payload,
  apply_patch, stack_instances, forest_tree and demux_expectation give
  identical arrays and identical refusals (exact);
- (c) both services solve the same two patched UC 3 x 6 requests as one
  stacked wheel, with the fixed-rho block options of
  tests/test_torch_extensions.py: per-request objective and x̂ agree at
  the port's PH parity bar there (1e-8 relative);
- (d) install_batch into a warm engine runs the same trajectory as a
  fresh engine on the same instance (1e-10) and as the JAX package's
  install_batch (1e-8 relative).

The warm-bucket check is the port's: a second request of a bucket
builds no CUDA kernel and sets up no factorization
(``kernel_builds_delta`` and ``factor_builds_delta`` 0, and their sum
``xla_compiles_delta`` 0). A request preempted twice resumes the third
time from the second run's bundle (the retention repair of
ckpt/manager.CheckpointManager.resumed_from).

Tiers: unit tests of the service plane (bucket fingerprints, payload
validation, the forest-tree stacker and demux math, the warm-cache
LRU/lease protocol, the bounded queue's group pops, the durable request
store, the HTTP handlers over a stub service); in-process service
tests over real farmer wheels (solo vs stacked equivalence, chain warm
starts, deadline misses, preempt -> new-service resume, the one-bad-
tenant group fallback); and the end-to-end test: ``python -m
mpisppy_tpu_torch serve --device cpu`` on an ephemeral port —
build-once on the second same-shape request, two data-only requests
riding one stacked wheel with per-request results matching solo runs,
and a SIGTERM'd in-flight request resuming from its ckpt bundle in a
fresh server process.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

import torch

from mpisppy_tpu_torch import obs
from mpisppy_tpu_torch.serve import batch as sbatch
from mpisppy_tpu_torch.serve.batch import BadRequest
from mpisppy_tpu_torch.serve.cache import WarmCache
from mpisppy_tpu_torch.serve.queue import (AdmissionQueue, QueueFull,
                                           Request, RequestStore)
from mpisppy_tpu_torch.utils.config import ServeConfig
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

FARMER = {"model": "farmer", "num_scens": 3,
          "algo": {"max_iterations": 30}}
PATCH_B = {"u": {"EnforceCattleFeedRequirement":
                 [[250.0, 260.0, 0.0], [230.0, 250.0, 0.0],
                  [210.0, 230.0, 0.0]]}}
PATCH_C = {"c": {"DevotedAcreage": [160.0, 235.0, 250.0]}}


@pytest.fixture
def mem_obs():
    rec = obs.configure(out_dir=None)
    yield rec
    obs.shutdown()


def _payload(**over):
    p = {**FARMER}
    p.update(over)
    return p


# ---------------- unit: buckets, payloads, stacking ----------------

def test_bucket_key_is_shape_identity_not_data():
    base = sbatch.bucket_key(FARMER)
    # data patches never move the bucket (the whole point)
    assert sbatch.bucket_key(_payload(patch=PATCH_B)) == base
    assert sbatch.bucket_key(_payload(patch=PATCH_C)) == base
    # structure does: scenario count, algo knobs, model kwargs, model
    assert sbatch.bucket_key(_payload(num_scens=4)) != base
    assert sbatch.bucket_key(
        _payload(algo={"max_iterations": 31})) != base
    assert sbatch.bucket_key(
        _payload(model_kwargs={"crops_multiplier": 2})) != base
    assert sbatch.bucket_key(_payload(model="sizes")) != base
    assert sbatch.engine_key(base, 2).endswith(":x2")


def test_payload_validation_refuses_bad_requests():
    for bad, msg in [
            ({"model": "nope"}, "unknown model"),
            (_payload(num_scens=0), "num_scens"),
            (_payload(algo={"defaultPHrho": 2}), "unknown algo"),
            (_payload(patch={"A": {"x": [1.0]}}), "not patchable"),
            (_payload(patch={"l": "oops"}), "block names"),
            (_payload(patch={"l": {"b": ["x"]}}), "numeric"),
            (_payload(deadline=-1), "deadline"),
            (_payload(patch=PATCH_B, chain=[{}]), "not both"),
            (_payload(chain=[]), "non-empty"),
            (_payload(chain=["x"]), "must be an object"),
            ("not a dict", "JSON object")]:
        with pytest.raises(BadRequest, match=msg):
            sbatch.validate_payload(bad)
    assert sbatch.validate_payload(_payload(patch=PATCH_B)) is not None


def test_apply_patch_broadcast_and_per_scenario():
    from mpisppy_tpu_torch.utils.vanilla import build_batch_for
    base = build_batch_for(sbatch.base_runconfig(FARMER))
    sl = base.template.con_slices["EnforceCattleFeedRequirement"]
    patched = sbatch.apply_patch(base, PATCH_B)
    assert np.asarray(patched.u)[:, sl].tolist() == \
        PATCH_B["u"]["EnforceCattleFeedRequirement"]
    # broadcast: one row applies to every scenario; the base is never
    # mutated (it is shared across requests)
    p2 = sbatch.apply_patch(
        base, {"l": {"EnforceCattleFeedRequirement": [180.0, 220.0,
                                                      0.0]}})
    assert (np.asarray(p2.l)[:, sl] == [180.0, 220.0, 0.0]).all()
    assert np.isinf(np.asarray(base.u)[:, sl]).all()
    # c patches keep the stage split consistent (ir/batch's rule)
    vsl = base.template.var_slices["DevotedAcreage"]
    p3 = sbatch.apply_patch(base, PATCH_C)
    assert (np.asarray(p3.c)[:, vsl]
            == PATCH_C["c"]["DevotedAcreage"]).all()
    assert (np.asarray(p3.c_stage)[:, 0, vsl]
            == PATCH_C["c"]["DevotedAcreage"]).all()
    # wrong row count is a client error
    with pytest.raises(BadRequest, match="rows"):
        sbatch.apply_patch(base, {"c": {"DevotedAcreage":
                                        [[1.0, 2.0, 3.0]] * 2}})


def test_forest_tree_stacking_and_demux():
    from mpisppy_tpu_torch.utils.vanilla import build_batch_for
    base = build_batch_for(sbatch.base_runconfig(FARMER))
    b1 = sbatch.apply_patch(base, PATCH_B)
    b2 = sbatch.apply_patch(base, PATCH_C)
    stacked, blocks = sbatch.stack_instances([base, b1, b2])
    assert stacked.S == 3 * base.S
    assert blocks == [slice(0, 3), slice(3, 6), slice(6, 9)]
    # forest: each instance keeps its own stage-1 root
    t = stacked.tree
    assert t.nodes_per_stage == [3]
    assert t.node_path[:, 0].tolist() == [0] * 3 + [1] * 3 + [2] * 3
    t.validate()             # probabilities sum to 1, node-contiguous
    np.testing.assert_allclose(stacked.prob.sum(), 1.0)
    # consensus never couples blocks: membership columns are disjoint
    B = t.membership(1)
    assert (B.sum(axis=0) == 3).all() and (B.sum(axis=1) == 1).all()
    # each block's data is its instance's
    sl = base.template.con_slices["EnforceCattleFeedRequirement"]
    assert np.asarray(stacked.u)[blocks[1]][:, sl].tolist() == \
        PATCH_B["u"]["EnforceCattleFeedRequirement"]
    # demux divides the 1/k mixture back out to per-request E[...]
    per_scen = np.arange(9, dtype=float)
    got = sbatch.demux_expectation(per_scen, stacked.prob, blocks)
    np.testing.assert_allclose(got, [1.0, 4.0, 7.0])


def test_solo_stack_is_identity():
    from mpisppy_tpu_torch.utils.vanilla import build_batch_for
    base = build_batch_for(sbatch.base_runconfig(FARMER))
    stacked, blocks = sbatch.stack_instances([base])
    assert stacked is base and blocks == [slice(0, base.S)]


# ---------------- unit: cache, queue, store, config ----------------

def test_warm_cache_lru_lease_and_counters(mem_obs):
    cache = WarmCache(capacity=2)
    assert cache.checkout("k1") is None      # miss
    e1 = cache.admit("k1", object(), meta={"m": 1})
    cache.checkin(e1)
    e1b = cache.checkout("k1")               # hit (leased again)
    assert e1b is e1 and e1.hits == 1
    # leased entries refuse a second lease without waiting ...
    assert cache.checkout("k1", wait=False) is None
    # ... and survive eviction pressure while leased (k2, the only
    # unleased entry, is the LRU victim when k3 admits over capacity)
    cache.checkin(cache.admit("k2", object()))
    cache.checkin(cache.admit("k3", object()))
    assert {e["key"] for e in cache.status()["buckets"]} == {"k1", "k3"}
    cache.checkin(e1b)
    assert obs.counter_value("serve.cache.hit") == 1
    assert obs.counter_value("serve.cache.miss") == 2
    assert obs.counter_value("serve.cache.evict") == 1
    # a torn wheel discards its entry (lease released, bucket dropped,
    # never checked back in half-installed)
    e1d = cache.checkout("k1")
    cache.discard(e1d)
    assert cache.checkout("k1") is None      # gone: rebuilds cold
    assert obs.counter_value("serve.cache.evict") == 2


def test_admission_queue_bounds_and_group_pops(mem_obs):
    q = AdmissionQueue(limit=3)
    a = Request({"p": 1}, bucket="B1")
    b = Request({"p": 2}, bucket="B1")
    c = Request({"p": 3}, bucket="B2")
    for r in (a, b, c):
        q.push(r)
    with pytest.raises(QueueFull):
        q.push(Request({"p": 4}, bucket="B1"))
    # head request + same-bucket stragglers, never a foreign bucket
    g = q.pop_group(batch_window=0.0, batch_max=8)
    assert [r.id for r in g] == [a.id, b.id]
    assert q.pop_group(batch_window=0.0, batch_max=8) == [c]
    # a straggler arriving INSIDE the window still coalesces
    q.push(a)
    got = []
    t = threading.Thread(target=lambda: got.append(
        q.pop_group(batch_window=2.0, batch_max=2)))
    t.start()
    time.sleep(0.1)
    q.push(b)
    t.join(timeout=5)
    assert [r.id for r in got[0]] == [a.id, b.id]
    # non-batchable heads never group
    nb = Request({"p": 5}, bucket="B1", batchable=False)
    q.push(nb)
    q.push(a)
    assert q.pop_group(batch_window=0.0, batch_max=8) == [nb]
    # force pushes (restart recovery, group fallbacks) bypass the
    # bound — the limit guards NEW clients, not the durable backlog
    for k in range(5):
        q.push(Request({"p": k}, bucket="B9"), force=True)
    assert len(q) == 6
    q.stop()
    assert q.pop_group() == []


def test_request_store_roundtrip_outlives_process_object(tmp_path):
    store = RequestStore(str(tmp_path))
    req = Request(_payload(patch=PATCH_C), bucket="abc",
                  deadline=30.0)
    req.status = "done"
    req.result = {"objective": -1.5}
    store.save(req)
    # a FRESH store (the restarted-service view) replays the record
    back = RequestStore(str(tmp_path)).load(req.id)
    assert back.status == "done" and back.result == {"objective": -1.5}
    assert back.bucket == "abc" and back.deadline_unix is not None
    assert back.payload["patch"] == PATCH_C
    assert RequestStore(str(tmp_path)).load("no-such") is None
    # path-shaped ids off the wire resolve to nothing, never a
    # directory traversal
    assert store.load("../evil") is None
    with pytest.raises(KeyError):
        store._path("../evil")
    # a rolled-back admission leaves no record to resurrect
    store.delete(req.id)
    assert store.load(req.id) is None and store.load_all() == []


def test_serve_config_validation():
    ServeConfig(state_dir="x").validate()
    for kw in ({"state_dir": ""}, {"state_dir": "x", "port": 70000},
               {"state_dir": "x", "max_wheels": 0},
               {"state_dir": "x", "batch_max": 0},
               {"state_dir": "x", "batch_window": -1},
               {"state_dir": "x", "queue_limit": 0},
               {"state_dir": "x", "cache_buckets": 0},
               {"state_dir": "x", "checkpoint_interval": 0},
               {"state_dir": "x", "default_deadline": 0},
               {"state_dir": "x", "request_retention": 0}):
        with pytest.raises(ValueError):
            ServeConfig(**kw).validate()


def test_terminal_record_retention_sweep(tmp_path, mem_obs):
    """Startup retention: terminal records (and their ckpt
    namespaces) older than request_retention drop; fresh and
    non-terminal records survive — a long-lived service must not
    accrete one json per request forever."""
    from mpisppy_tpu_torch.serve.manager import ServeService
    svc = ServeService(ServeConfig(state_dir=str(tmp_path / "state"),
                                   request_retention=3600.0,
                                   device="cpu").validate())
    old_done = Request({"model": "farmer"}, bucket="b")
    old_done.status = "done"
    old_done.finished_unix = time.time() - 7200
    fresh_done = Request({"model": "farmer"}, bucket="b")
    fresh_done.status = "done"
    fresh_done.finished_unix = time.time() - 60
    old_preempted = Request({"model": "farmer"}, bucket="b")
    old_preempted.status = "preempted"
    old_preempted.submitted_unix = time.time() - 7200
    for r in (old_done, fresh_done, old_preempted):
        svc.store.save(r)
    ns = svc._ckpt_ns(old_done.id)
    os.makedirs(ns, exist_ok=True)
    svc._sweep_terminal()
    assert svc.store.load(old_done.id) is None
    assert not os.path.isdir(ns)
    assert svc.store.load(fresh_done.id) is not None
    assert svc.store.load(old_preempted.id) is not None


def test_wheel_deadline_timer_fires_and_cancels():
    from mpisppy_tpu_torch.cylinders.supervisor import WheelDeadline

    class _H:
        fired = None

        def fire_watchdog(self, source):
            self.fired = source

    h = _H()
    WheelDeadline(h, 0.05).start()
    t0 = time.time()
    while h.fired is None and time.time() - t0 < 5:
        time.sleep(0.01)
    assert h.fired == "deadline_timer"
    h2 = _H()
    wd = WheelDeadline(h2, 0.05).start()
    wd.cancel()
    time.sleep(0.15)
    assert h2.fired is None


# ---------------- unit: the HTTP plane over a stub ----------------

class _StubService:
    """Duck-typed service: the HTTP plane needs submit/result/
    snapshots + the introspection attrs, no engine."""

    def __init__(self):
        self.queue = AdmissionQueue(limit=2)
        self.cache = WarmCache(2)
        self._active_hubs = {}
        self._preempting = False
        self._stop = False
        self._reqs = {}

    def submit(self, payload):
        sbatch.validate_payload(payload)
        req = Request(payload, bucket="stub")
        self.queue.push(req)
        self._reqs[req.id] = req
        return req

    def result(self, rid):
        r = self._reqs.get(rid)
        return None if r is None else r.to_json()

    def status_snapshot(self):
        return {"type": "serve", "queue_depth": len(self.queue)}

    def queue_snapshot(self):
        return {"queued": self.queue.snapshot(), "requests": []}


def _http(method, url, body=None):
    req = urllib.request.Request(url, method=method,
                                 data=None if body is None
                                 else json.dumps(body).encode())
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def test_http_plane_endpoints_over_stub(mem_obs):
    from mpisppy_tpu_torch.serve.http import ServeHTTPServer
    svc = _StubService()
    drained = []
    srv = ServeHTTPServer(svc, 0, on_shutdown=lambda: drained.append(1))
    srv.start()
    base = f"http://127.0.0.1:{srv.port}"
    try:
        code, body = _http("POST", f"{base}/solve", FARMER)
        assert code == 202
        rid = json.loads(body)["request_id"]
        code, body = _http("GET", f"{base}/result/{rid}")
        assert code == 200 and json.loads(body)["status"] == "queued"
        assert _http("GET", f"{base}/result/nope")[0] == 404
        code, body = _http("POST", f"{base}/solve",
                           {"model": "bogus"})
        assert code == 400 and "unknown model" in body
        assert _http("POST", f"{base}/solve", FARMER)[0] == 202
        # the bounded queue's 429, mounted
        assert _http("POST", f"{base}/solve", FARMER)[0] == 429
        code, body = _http("GET", f"{base}/status")
        assert code == 200 and json.loads(body)["type"] == "serve"
        assert _http("GET", f"{base}/queue")[0] == 200
        code, body = _http("GET", f"{base}/metrics")
        # the live plane's exposition, mounted over the registry
        assert code == 200 and "mpisppy_tpu_serve_http_requests" in body
        assert _http("GET", f"{base}/healthz")[0] == 200
        assert _http("GET", f"{base}/bogus")[0] == 404
        assert _http("POST", f"{base}/shutdown")[0] == 200
        assert drained == [1]
        # a preempting service refuses new work with 503
        svc._preempting = True
        assert _http("POST", f"{base}/solve", FARMER)[0] == 503
    finally:
        srv.stop()


# ---------------- in-process service over real wheels ----------------

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


def test_service_stacked_wheel_matches_solo_runs(tmp_path, mem_obs):
    """The batching contract, in-process: two data-only same-bucket
    requests ride ONE stacked wheel and each gets its own answer,
    equal to its solo run within solver tolerance; the second
    same-shape wheel hits the warm cache with no new kernel or factor
    build."""
    svc = _service(tmp_path).start()
    try:
        a = svc.submit(_payload())
        ra = _wait(svc, a.id)
        assert ra["status"] == "done", ra
        assert ra["result"]["wheel"]["cache_hit"] is False
        assert ra["result"]["wheel"]["factor_builds_delta"] > 0
        # same shape, new data: warm engine, no new kernel or factor
        # build
        a2 = svc.submit(_payload(patch=PATCH_C, batchable=False))
        ra2 = _wait(svc, a2.id)
        w2 = ra2["result"]["wheel"]
        assert w2["cache_hit"] is True
        assert w2["kernel_builds_delta"] == 0
        assert w2["factor_builds_delta"] == 0
        assert w2["xla_compiles_delta"] == 0
        # the stacked pair
        b = svc.submit(_payload(patch=PATCH_B))
        c = svc.submit(_payload(patch=PATCH_C))
        rb, rc = _wait(svc, b.id), _wait(svc, c.id)
        assert rb["group"] is not None and rb["group"] == rc["group"]
        assert rb["result"]["wheel"]["stack"] == 2
        assert obs.counter_value("serve.batch.wheels") == 1
        assert obs.counter_value("serve.batch.coalesced") == 2
        # solo references
        bs = svc.submit(_payload(patch=PATCH_B, batchable=False))
        cs = svc.submit(_payload(patch=PATCH_C, batchable=False))
        rbs, rcs = _wait(svc, bs.id), _wait(svc, cs.id)
        for stacked, solo in ((rb, rbs), (rc, rcs)):
            ob = stacked["result"]["objective"]
            os_ = solo["result"]["objective"]
            assert ob is not None and os_ is not None
            assert abs(ob - os_) <= 1e-3 * (1 + abs(os_)), (ob, os_)
        # C's answer must differ from B's (its own data, not the
        # group's mixture)
        assert abs(rb["result"]["objective"]
                   - rc["result"]["objective"]) > 1.0
        assert svc.status_snapshot()["requests"]["done"] == 6
    finally:
        svc.stop()


def test_service_chain_warm_starts_each_step(tmp_path, mem_obs):
    svc = _service(tmp_path).start()
    try:
        ch = svc.submit(_payload(
            algo={"max_iterations": 15},
            chain=[{}, {"patch": PATCH_C}, {"patch": PATCH_B}]))
        rec = _wait(svc, ch.id)
        assert rec["status"] == "done", rec
        steps = rec["result"]["steps"]
        assert [s["step"] for s in steps] == [0, 1, 2]
        assert steps[0]["warm_started"] is False
        assert all(s["warm_started"] for s in steps[1:])
        assert all(len(s["committed_head"]) == 3 for s in steps)
        assert obs.counter_value("serve.chain.steps") == 3
        assert obs.counter_value("ckpt.resumed") >= 2
    finally:
        svc.stop()


def test_service_deadline_miss_books_and_fails(tmp_path, mem_obs):
    svc = _service(tmp_path).start()
    try:
        r = svc.submit(_payload(
            algo={"max_iterations": 100000, "convthresh": -1.0},
            deadline=1.0))
        rec = _wait(svc, r.id, timeout=120)
        assert rec["status"] == "failed"
        assert "deadline" in rec["error"]
        assert obs.counter_value("serve.requests.deadline_missed") >= 1
    finally:
        svc.stop()


def test_service_preempt_then_new_service_resumes(tmp_path, mem_obs):
    """The request-state-store contract, in-process: preempt a running
    wheel (its hub checkpoints under the request namespace), then a
    NEW service over the same state dir re-admits and resumes it from
    the bundle via the --resume-from machinery."""
    svc = _service(tmp_path).start()
    slow = svc.submit(_payload(
        algo={"max_iterations": 500, "convthresh": -1.0}))
    ns = os.path.join(str(tmp_path / "state"), "ckpt", slow.id)
    t0 = time.time()
    while time.time() - t0 < 120:
        rec = svc.result(slow.id)
        if rec["status"] == "running" and os.path.isdir(ns) and any(
                n.startswith("bundle-") for n in os.listdir(ns)):
            break
        time.sleep(0.05)
    else:
        raise TimeoutError("no bundle before preempt")
    svc.preempt("test")
    svc.stop(join_timeout=60)
    assert svc.result(slow.id)["status"] == "preempted"

    svc2 = _service(tmp_path).start()
    try:
        rec = _wait(svc2, slow.id, timeout=180)
        assert rec["status"] == "done", rec
        assert rec["resumed"] is True
        assert rec["result"]["wheel"]["resumed_from_iter"] > 0
        assert obs.counter_value("serve.requests.resumed") >= 1
    finally:
        svc2.stop()


def test_group_failure_reruns_members_solo(tmp_path, mem_obs):
    """One bad tenant must not take the stacked wheel's neighbors
    down: the failed group re-runs solo, the good member completes,
    only the offender fails."""
    svc = _service(tmp_path).start()
    try:
        good = svc.submit(_payload(patch=PATCH_C))
        # lb above the total-acreage cap: iter-0 infeasible
        bad = svc.submit(_payload(
            patch={"lb": {"DevotedAcreage": [600.0, 600.0, 600.0]}}))
        rg = _wait(svc, good.id, timeout=180)
        rb = _wait(svc, bad.id, timeout=180)
        assert rg["status"] == "done" and rg["result"]["objective"] \
            is not None
        assert rb["status"] == "failed" and rb["error"]
        assert rg["no_batch"] is True      # the solo fallback ran it
    finally:
        svc.stop()


def test_stacked_wheel_one_launch_path_o1_gate_syncs(mem_obs):
    """The batching acceptance rider, tier-1 half: a stacked wheel
    rides the IDENTICAL solve path as any engine — on farmer's fused
    (non-chunked) path that is ONE solve pass per iteration with ZERO
    recovery-gate syncs, however many tenants share the wheel (the
    analyze invariant's gate_syncs/solve_call <= 2, trivially)."""
    from mpisppy_tpu_torch.serve.manager import (build_engine,
                                                 consensus_results)
    from mpisppy_tpu_torch.utils.vanilla import build_batch_for
    base = build_batch_for(sbatch.base_runconfig(FARMER))
    stacked, blocks = sbatch.stack_instances(
        [sbatch.apply_patch(base, PATCH_B),
         sbatch.apply_patch(base, PATCH_C)])
    eng = build_engine(stacked, sbatch.request_algo(FARMER).to_options(),
                       device="cpu")
    g0 = obs.counter_value("ph.gate_syncs")
    s0 = obs.counter_value("ph.solve_loop_calls")
    eng.ph_main(finalize=False)
    solve_calls = obs.counter_value("ph.solve_loop_calls") - s0
    gate_syncs = obs.counter_value("ph.gate_syncs") - g0
    # one batched pass per iteration (iter0 + k iterations), no extra
    # per-tenant launches, no extra gates
    assert solve_calls == eng._iter + 1
    assert gate_syncs <= 2 * solve_calls, (gate_syncs, solve_calls)
    res = consensus_results(eng, blocks)
    assert all(r["feasible"] and r["objective"] is not None
               for r in res)


@pytest.mark.slow
def test_stacked_uc_chunked_wheel_o1_gate_syncs(mem_obs):
    """Full-suite half: a shared-structure (UC) stack through the
    CHUNKED dispatch — the stacked-residual gate stays O(1) per
    iteration (one fused D2H per solve call) with two tenants riding
    one factorization, and both blocks' consensus evaluates feasible
    to the same value (identical data stacked twice)."""
    from mpisppy_tpu_torch.serve.manager import (build_engine,
                                                 consensus_results)
    from mpisppy_tpu_torch.utils.vanilla import build_batch_for
    P = {"model": "uc", "num_scens": 2, "algo": {"max_iterations": 5}}
    base = build_batch_for(sbatch.base_runconfig(P))
    assert base.shared_A
    stacked, blocks = sbatch.stack_instances([base, base])
    assert stacked.shared_A
    eng = build_engine(stacked, {**sbatch.request_algo(P).to_options(),
                                 "subproblem_chunk": 2}, device="cpu")
    g0 = obs.counter_value("ph.gate_syncs")
    s0 = obs.counter_value("ph.solve_loop_calls")
    eng.ph_main(finalize=False)
    solve_calls = obs.counter_value("ph.solve_loop_calls") - s0
    gate_syncs = obs.counter_value("ph.gate_syncs") - g0
    assert solve_calls >= 2
    assert gate_syncs <= 2 * solve_calls, (gate_syncs, solve_calls)
    res = consensus_results(eng, blocks)
    assert all(r["feasible"] for r in res)
    assert res[0]["objective"] == pytest.approx(res[1]["objective"],
                                                rel=1e-9)


# ---------------- ckpt: concurrent writers, namespaced roots --------

def test_checkpoint_namespaces_isolate_concurrent_writers(tmp_path,
                                                          mem_obs):
    """CheckpointManager retention + LATEST assume ONE writer per
    directory. Two wheels checkpointing
    under one shared root must therefore write to per-request
    namespaces — under concurrent captures each namespace's LATEST
    only ever names its own bundles, and a cross-read is refused by
    fingerprint. (Sharing one directory would interleave LATEST and
    retention between writers — exactly what the serve manager's
    per-request namespace prevents by construction.)"""
    from mpisppy_tpu_torch.ckpt import bundle as B

    root = tmp_path / "ckpt"
    arrays = {"W": np.zeros((3, 4)), "xbar": np.zeros((3, 4)),
              "xsqbar": np.zeros((3, 4)), "rho": np.ones((3, 4)),
              "iter": np.asarray(7)}

    def writer(ns, fp, n=12, keep=2):
        d = str(root / ns)
        for seq in range(1, n + 1):
            B.write_bundle(d, arrays, {"fingerprint": fp},
                           iteration=seq, seq=seq, keep=keep)

    t1 = threading.Thread(target=writer, args=("req-a", "fp-a"))
    t2 = threading.Thread(target=writer, args=("req-b", "fp-b"))
    t1.start(); t2.start(); t1.join(timeout=60); t2.join(timeout=60)
    assert not t1.is_alive() and not t2.is_alive()
    for ns, fp in (("req-a", "fp-a"), ("req-b", "fp-b")):
        d = str(root / ns)
        latest = B.latest_bundle(d)
        assert latest is not None and latest.startswith(d)
        manifest, _, _ = B.load_bundle(d, fingerprint=fp)
        assert manifest["fingerprint"] == fp
        # retention pruned to keep=2 inside the namespace only
        assert len([n for n in os.listdir(d)
                    if n.startswith("bundle-")]) == 2
    # the cross-read the namespace exists to prevent is refused even
    # if someone resolves the wrong directory
    with pytest.raises(B.CheckpointError, match="fingerprint"):
        B.load_bundle(str(root / "req-a"), fingerprint="fp-b")


# ---------------- the end-to-end serve test ----------------

def _post(url, obj):
    req = urllib.request.Request(
        url, data=json.dumps(obj).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=15) as r:
        return json.loads(r.read().decode())


def _get(url):
    with urllib.request.urlopen(url, timeout=15) as r:
        return r.read().decode()


def _wait_http(base, rid, timeout, until=("done", "failed")):
    t0 = time.time()
    while time.time() - t0 < timeout:
        rec = json.loads(_get(f"{base}/result/{rid}"))
        if rec["status"] in until:
            return rec
        time.sleep(0.2)
    raise TimeoutError(f"{rid}: {rec}")


def _spawn_server(state, tdir, extra=()):
    env = {**os.environ, "PYTHONPATH": REPO}
    env.pop("MPISPPY_TPU_TELEMETRY_DIR", None)
    return subprocess.Popen(
        [sys.executable, "-m", "mpisppy_tpu_torch", "serve",
         "--device", "cpu", "--port", "0",
         "--state-dir", state, "--telemetry-dir", tdir,
         "--batch-window", "0.6", "--checkpoint-interval", "0.2",
         *extra],
        cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


def _endpoint(state, proc, timeout=180):
    ep = os.path.join(state, "serve.json")
    t0 = time.time()
    while time.time() - t0 < timeout:
        if proc.poll() is not None:
            raise RuntimeError(
                f"serve died rc {proc.returncode}:\n{proc.stdout.read()}")
        try:
            d = json.load(open(ep, encoding="utf-8"))
            if d.get("pid") == proc.pid:
                return f"http://127.0.0.1:{d['port']}"
        except (OSError, ValueError):
            pass
        time.sleep(0.2)
    raise TimeoutError("serve.json never appeared")


def test_serve_e2e_compile_once_batching_and_sigterm_resume(tmp_path):
    """The end-to-end serve test: a real ``python -m mpisppy_tpu_torch
    serve --device cpu`` process on an ephemeral port. (a) the second
    same-shape request builds no kernel and sets up no factorization
    (``xla_compiles_delta`` 0) and hits the cache; (b) two data-only
    requests run as ONE stacked wheel; (c) their results equal solo
    runs to solver tolerance; (d) a SIGTERM'd in-flight request
    resumes from its ckpt bundle in a fresh server process and
    completes."""
    state = str(tmp_path / "state")
    tdir = str(tmp_path / "obs1")
    tdir2 = str(tmp_path / "obs2")
    fast = {"model": "farmer", "num_scens": 3,
            "algo": {"max_iterations": 10}}
    proc = _spawn_server(state, tdir)
    try:
        base = _endpoint(state, proc)
        # (a) build-once: the first request sets up the factors, the
        # second same-shape request sets up none
        r1 = _post(f"{base}/solve", fast)["request_id"]
        w1 = _wait_http(base, r1, 300)
        assert w1["status"] == "done", w1
        assert w1["result"]["wheel"]["xla_compiles_delta"] > 0
        r2 = _post(f"{base}/solve",
                   {**fast, "patch": PATCH_C,
                    "batchable": False})["request_id"]
        w2 = _wait_http(base, r2, 120)
        assert w2["status"] == "done", w2
        assert w2["result"]["wheel"]["cache_hit"] is True
        assert w2["result"]["wheel"]["xla_compiles_delta"] == 0
        assert w2["result"]["wheel"]["kernel_builds_delta"] == 0
        assert w2["result"]["wheel"]["factor_builds_delta"] == 0
        # (b) the stacked wheel: post the pair back-to-back, inside
        # the batch window
        rb = _post(f"{base}/solve",
                   {**fast, "patch": PATCH_B})["request_id"]
        rc = _post(f"{base}/solve",
                   {**fast, "patch": PATCH_C})["request_id"]
        wb = _wait_http(base, rb, 180)
        wc = _wait_http(base, rc, 180)
        assert wb["group"] is not None and wb["group"] == wc["group"]
        assert wb["result"]["wheel"]["stack"] == 2
        metrics = _get(f"{base}/metrics")
        assert "mpisppy_tpu_serve_batch_wheels 1" in metrics
        assert "mpisppy_tpu_serve_cache_hit" in metrics
        # (c) per-request results equal solo runs to solver tolerance
        sb = _post(f"{base}/solve",
                   {**fast, "patch": PATCH_B,
                    "batchable": False})["request_id"]
        sc = _post(f"{base}/solve",
                   {**fast, "patch": PATCH_C,
                    "batchable": False})["request_id"]
        ws_b, ws_c = (_wait_http(base, sb, 120),
                      _wait_http(base, sc, 120))
        for stacked, solo in ((wb, ws_b), (wc, ws_c)):
            ob = stacked["result"]["objective"]
            os_ = solo["result"]["objective"]
            assert ob is not None and os_ is not None
            assert abs(ob - os_) <= 1e-3 * (1 + abs(os_)), (ob, os_)
        # /status carries the wheels + cache anatomy
        st = json.loads(_get(f"{base}/status"))
        assert st["type"] == "serve" and "cache" in st
        # (d) SIGTERM an in-flight request ...
        slow = _post(f"{base}/solve",
                     {**fast,
                      "algo": {"max_iterations": 600,
                               "convthresh": -1.0}})["request_id"]
        ns = os.path.join(state, "ckpt", slow)
        t0 = time.time()
        while time.time() - t0 < 120:
            rec = json.loads(_get(f"{base}/result/{slow}"))
            if rec["status"] == "running" and os.path.isdir(ns) \
                    and any(n.startswith("bundle-")
                            for n in os.listdir(ns)):
                break
            time.sleep(0.1)
        else:
            raise TimeoutError("no bundle before SIGTERM")
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=120) == 0, proc.stdout.read()
        rec = json.load(open(os.path.join(state, "requests",
                                          f"{slow}.json"),
                             encoding="utf-8"))
        assert rec["status"] == "preempted"
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    # ... and a FRESH server over the same state dir resumes it
    proc2 = _spawn_server(state, tdir2)
    try:
        base = _endpoint(state, proc2)
        w = _wait_http(base, slow, 300)
        assert w["status"] == "done", w
        assert w["resumed"] is True
        assert w["result"]["wheel"]["resumed_from_iter"] > 0
        proc2.send_signal(signal.SIGTERM)
        assert proc2.wait(timeout=120) == 0
    finally:
        if proc2.poll() is None:
            proc2.kill()
            proc2.wait(timeout=30)
    # each session's telemetry feeds analyze's serving section:
    # session 1 shows admission/batching/cache traffic, session 2 the
    # resume
    from mpisppy_tpu_torch.obs.analyze import load_run, serving_summary
    sv = serving_summary(load_run(tdir))
    assert sv is not None
    assert sv["admitted"] >= 7 and sv["cache_hits"] >= 1
    assert sv["stacked_wheels"] >= 1 and sv["coalesced"] >= 2
    assert sv["preempted_requests"] >= 1 and sv["service_preempted"]
    sv2 = serving_summary(load_run(tdir2))
    assert sv2 is not None and sv2["resumed"] >= 1


# ---------------- the port's own contracts ----------------

def test_service_without_a_card_raises(tmp_path, monkeypatch):
    """No card and no ``device="cpu"``: the service and the ``serve``
    subcommand raise before anything binds or is admitted; they never
    carry on quietly on the CPU."""
    from mpisppy_tpu_torch.serve.manager import ServeService, serve_main
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeService(ServeConfig(state_dir=str(tmp_path / "a")))
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeService(ServeConfig(state_dir=str(tmp_path / "b"),
                                 device="cuda"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_main(["--port", "0", "--state-dir", str(tmp_path / "c")])
    assert not os.path.exists(str(tmp_path / "c" / "serve.json"))
    svc = ServeService(ServeConfig(state_dir=str(tmp_path / "d"),
                                   device="cpu"))
    assert svc.device == torch.device("cpu")
    with pytest.raises(ValueError, match="device"):
        ServeConfig(state_dir="x", device=" ").validate()


def test_service_plane_imports_without_torch():
    """The layering of serve/__init__.py: the HTTP, queue, cache,
    batch and migration plane imports without torch (only the manager,
    the wheel runner, touches the engine)."""
    probe = ("import sys\n"
             "import mpisppy_tpu_torch.serve.http\n"
             "import mpisppy_tpu_torch.serve.migrate\n"
             "import mpisppy_tpu_torch.serve.batch\n"
             "import mpisppy_tpu_torch.serve.cache\n"
             "import mpisppy_tpu_torch.serve.queue\n"
             "assert 'torch' not in sys.modules\n"
             "assert 'mpisppy_tpu_torch.serve.manager' not in sys.modules\n")
    out = subprocess.run([sys.executable, "-c", probe], cwd=REPO,
                         env={**os.environ, "PYTHONPATH": REPO},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def _bundle_iter(path):
    from mpisppy_tpu_torch.ckpt import bundle as B
    return B.load_bundle(path)[0]["iter"]


def _wait_running_with_captures(svc, rid, ns, captures, beyond=-1,
                                timeout=120):
    """Wait until request ``rid`` runs, the process has booked
    ``captures`` more checkpoint captures, and ``ns`` holds a bundle
    whose iteration is above ``beyond``."""
    from mpisppy_tpu_torch.ckpt import bundle as B
    c0 = obs.counter_value("ckpt.captures")
    t0 = time.time()
    while time.time() - t0 < timeout:
        rec = svc.result(rid)
        latest = B.latest_bundle(ns) if os.path.isdir(ns) else None
        if rec["status"] == "running" and latest is not None \
                and obs.counter_value("ckpt.captures") - c0 >= captures:
            try:
                if _bundle_iter(latest) > beyond:
                    return
            except B.CheckpointError:
                pass          # pruned between the read and the load
        time.sleep(0.05)
    raise TimeoutError(f"{rid}: no capture run to wait for")


def test_service_preempted_twice_resumes_from_the_resumed_run(
        tmp_path, mem_obs):
    """A request preempted, resumed and preempted again resumes the
    third time from the SECOND run's bundle: the resumed wheel names
    its bundles on from the resumed one in the request's own
    namespace, so retention keeps them and LATEST resolves to them.
    The second run is preempted a few captures in, while its own
    iteration count is still far below the first run's: the JAX
    package names those bundles from iteration 0 again, prunes them at
    once and resumes the third run from the first run's state."""
    from mpisppy_tpu_torch.ckpt import bundle as B
    slow = {"algo": {"max_iterations": 500, "convthresh": -1.0}}
    svc = _service(tmp_path).start()
    req = svc.submit(_payload(**slow))
    ns = os.path.join(str(tmp_path / "state"), "ckpt", req.id)
    _wait_running_with_captures(svc, req.id, ns, 1, beyond=30)
    svc.preempt("test")
    svc.stop(join_timeout=60)
    assert svc.result(req.id)["status"] == "preempted"
    first = _bundle_iter(B.latest_bundle(ns))

    t_second = time.time()
    svc2 = _service(tmp_path).start()
    _wait_running_with_captures(svc2, req.id, ns, 3)
    svc2.preempt("test")
    svc2.stop(join_timeout=60)
    assert svc2.result(req.id)["status"] == "preempted"
    latest = B.latest_bundle(ns)
    man = B.load_bundle(latest)[0]
    # the second run's last bundle survived retention, LATEST names it
    # and it counts on from the first run's iteration
    assert man["wall_time_unix"] >= t_second
    assert open(os.path.join(ns, B.LATEST)).read().strip() \
        == os.path.basename(latest)
    second = man["iter"]
    assert second > first

    svc3 = _service(tmp_path).start()
    try:
        rec = _wait(svc3, req.id, timeout=180)
        assert rec["status"] == "done", rec
        assert rec["resumed"] is True
        assert rec["result"]["wheel"]["resumed_from_iter"] == second
    finally:
        svc3.stop()


# ---------------- the serve cases of test_shrink.py / test_stream.py --

_BIG = 2 ** 30


def _slot0_fix_list(b):
    """Only slot 0 ever fixes: a PARTIAL fixed set, so compaction keeps
    free slots (tests/test_shrink.py)."""
    from mpisppy_tpu_torch.extensions.fixer import uniform_fix_list
    spec = uniform_fix_list(b, tol=5e-1, nb=3, lb=3, ub=3,
                            integer_only=False)
    for k in ("nb", "lb", "ub"):
        a = np.minimum(spec[k], _BIG).copy()
        a[1:] = _BIG
        spec[k] = a
    return spec


# tests/test_shrink.py's farmer options (slot 0 fixes at iteration 8)
_SHRINK_OPTS = {"defaultPHrho": 5.0, "PHIterLimit": 25, "convthresh": 0.0,
                "subproblem_max_iter": 3000, "subproblem_eps": 1e-8,
                "shrink_fix": True, "id_fix_list_fct": _slot0_fix_list}
# tests/test_stream.py's farmer options
_STREAM_OPTS = {"defaultPHrho": 1.0, "PHIterLimit": 5, "convthresh": 0.0,
                "subproblem_chunk": 4, "subproblem_max_iter": 3000,
                "subproblem_eps": 1e-9}


def _farmer_batch(S=3):
    from mpisppy_tpu_torch.ir.batch import build_batch
    from mpisppy_tpu_torch.models import farmer
    return build_batch(farmer.scenario_creator, farmer.make_tree(S))


def test_install_batch_resets_shrink_and_extension_state():
    """A re-leased serve engine must not leak the previous tenant's
    fixer streaks / latched bounds / compaction state (the folded
    constants bake tenant data)."""
    from mpisppy_tpu_torch.core.ph import PH
    from mpisppy_tpu_torch.serve.manager import install_batch
    o = dict(_SHRINK_OPTS, shrink_compact=True, shrink_buckets="0.2")
    ph = PH(_farmer_batch(), o, device="cpu")
    ph.ph_main()
    assert ph._shrink is not None and ph.extensions.nfixed == 1
    hbm_compact = ph._shrink_status["est_hbm_bytes_per_iter"]
    install_batch(ph, _farmer_batch())
    assert ph._shrink is None and not ph._shrink_factors
    assert not ph._shrink_failed and ph._transplant_src is None
    st = ph._shrink_status
    assert st["compactions"] == 0 and st["fixed"] == 0
    assert st["n_cols"] == ph.batch.n
    assert st["est_hbm_bytes_per_iter"] > hbm_compact
    ext = ph.extensions
    assert ext.nfixed == 0 and not ext._init_done
    assert not bool(ph._fixed_mask.any())
    # and the engine runs the new tenant cleanly end to end
    ph.ph_main()
    assert ph._shrink_status["compactions"] == 1


def test_serve_bucket_key_separates_shrink_configs():
    """Shrink knobs are bucket identity — a shrink-enabled request must
    never share a leased engine with a shrink-disabled one (the
    compacted factor caches and folded constants are per-tenant
    state)."""
    from mpisppy_tpu_torch.serve.batch import bucket_key
    base = {"model": "farmer", "num_scens": 3}
    on = dict(base, algo={"shrink_fix": True, "shrink_compact": True})
    assert bucket_key(base) != bucket_key(on)
    assert bucket_key(dict(base, algo={"shrink_buckets": "0.5"})) \
        != bucket_key(on)
    assert bucket_key(base) == bucket_key(dict(base, algo={}))


def test_serve_bucket_key_separates_stream_sources():
    """Streamed-on and streamed-off requests must never share a leased
    engine — the knobs ride AlgoConfig.to_options() into the bucket
    fingerprint."""
    from mpisppy_tpu_torch.serve.batch import bucket_key
    base = {"model": "farmer", "num_scens": 3}
    k0 = bucket_key(dict(base))
    k1 = bucket_key(dict(base,
                         algo={"scenario_source": "streamed"}))
    k2 = bucket_key(dict(base, algo={"scenario_source": "streamed",
                                     "stream_int8": True}))
    assert len({k0, k1, k2}) == 3


def test_serve_install_batch_swaps_streamed_tenant(mem_obs):
    """install_batch on a streamed engine rebuilds the HOST store +
    surrogates instead of shipping device vectors: the re-leased
    engine solves tenant B's instance, not A's."""
    from mpisppy_tpu_torch.core.ph import PH
    from mpisppy_tpu_torch.models import farmer
    from mpisppy_tpu_torch.serve.manager import install_batch
    from mpisppy_tpu_torch.stream import synth_batch
    tree = farmer.make_tree(12)
    b_a, _ = synth_batch(farmer.scenario_creator, tree,
                         farmer.scenario_synth_spec, seed=7,
                         materialize_values=True)
    b_b, _ = synth_batch(farmer.scenario_creator, tree,
                         farmer.scenario_synth_spec, seed=99,
                         materialize_values=True)
    opts = dict(_STREAM_OPTS, scenario_source="streamed")
    ref_b = PH(b_b, options=dict(opts), device="cpu").ph_main()
    ph = PH(b_a, options=dict(opts), device="cpu")
    ph.ph_main(finalize=False)
    install_batch(ph, b_b)
    got = ph.ph_main()
    assert got == ref_b
    ph.close_stream()
