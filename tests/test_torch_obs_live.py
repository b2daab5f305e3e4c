"""The port's live plane, ``analyze`` and process-wheel telemetry
(mpisppy_tpu_torch obs/live.py, obs/analyze.py, obs/merge.py,
cylinders/hub.py, utils/multiproc.py) on the CPU: a mid-run /status and
/metrics fetch on a farmer wheel and the live.json it leaves, the
report of a port CLI run with every invariant PASS, ``--compare`` of a
JAX package run against a port run of the same command giving a
verdict, the merged trace of a process wheel, and the counter catalog:
every name the port emits is in doc/observability.md, except the
port-only names README lists."""

import json
import os
import threading
import time
import urllib.request

import pytest

from mpisppy_tpu_torch import obs
from mpisppy_tpu_torch.__main__ import main
from mpisppy_tpu_torch.utils.config import RunConfig, SpokeConfig
from mpisppy_tpu_torch.utils.sputils import spin_the_wheel
from mpisppy_tpu_torch.utils.vanilla import wheel_dicts
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EF_OBJ = -108390.0
_FARMER = ["--num-scens", "3", "--default-rho", "10", "--max-iterations",
           "6", "--convthresh", "-1", "--subproblem-max-iter", "3000",
           "--with-lagrangian", "--with-xhatshuffle"]
# names only the port emits (README's port section explains each)
PORT_ONLY = {"kernel.cuda_demotion", "kernel.build"}


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=10) as r:
        return r.status, r.read().decode()


def test_status_fetch_mid_run_and_live_json(tmp_path):
    """/status, /metrics and /healthz answer while the hub iterates;
    live.json holds the final snapshot after the wheel."""
    cfg = RunConfig(model="farmer", num_scens=3, status_port=0,
                    spokes=[SpokeConfig(kind="lagrangian")],
                    telemetry_dir=str(tmp_path), device="cpu")
    cfg.algo.default_rho = 10.0
    cfg.algo.max_iterations = 12
    cfg.algo.convthresh = -1.0
    seen, hubs = {}, []

    def poll():
        while not hubs:
            time.sleep(0.01)
        port = hubs[0]._status_server.port
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline and "status" not in seen:
            code, body = _get(port, "/status")
            snap = json.loads(body)
            if (snap.get("iter") or 0) >= 1:
                seen["status"] = snap
                seen["metrics"] = _get(port, "/metrics")
                seen["healthz"] = _get(port, "/healthz")[0]
            time.sleep(0.02)

    obs.configure(out_dir=str(tmp_path), config=cfg.to_dict())
    t = threading.Thread(target=poll, daemon=True)
    t.start()
    try:
        wheel = spin_the_wheel(*wheel_dicts(cfg),
                               register_hub=hubs.append)
    finally:
        obs.shutdown()
    t.join(timeout=30)
    snap = seen["status"]
    assert snap["type"] == "live" and snap["schema"] == 2
    assert snap["hub"] == "PHHub" and snap["iter"] >= 1
    assert [s["spoke"] for s in snap["spokes"]] == ["LagrangianOuterBound"]
    code, text = seen["metrics"]
    # booked by then: the live gauges and the hub engine's solve loops
    assert code == 200 and "mpisppy_tpu_live_iter" in text \
        and "mpisppy_tpu_ph_solve_loop_calls" in text
    assert seen["healthz"] == 200
    assert wheel.hub._status_server is None     # released at finalize
    with open(tmp_path / "live.json") as fh:
        live = json.load(fh)
    assert live["type"] == "live" and live["iter"] == 12
    for k in ("run_id", "outer", "inner", "rel_gap", "spokes", "phases",
              "roofline", "forensics", "elapsed_seconds"):
        assert k in live, k
    assert live["roofline"]["iter"] == 12
    assert live["roofline"]["hbm_bytes_per_iter"] > 0
    assert live["spokes"][0]["produced"] >= 1


def _analyze_json(tdir, capsys):
    capsys.readouterr()
    assert main(["analyze", tdir, "--json"]) == 0
    return json.loads(capsys.readouterr().out)


def test_analyze_port_cli_run_and_compare_with_jax(tmp_path, capsys):
    """``farmer --telemetry-dir D`` then ``analyze D``: every section
    renders and every invariant passes; ``analyze --compare`` of the JAX
    package's run of the same command against it gives a verdict (exit
    0 or 3), never the schema refusal (2)."""
    from mpisppy_tpu.__main__ import main as jax_main
    pdir, jdir = str(tmp_path / "port"), str(tmp_path / "jax")
    assert main(["farmer", "--telemetry-dir", pdir, "--forensics-interval",
                 "2", "--device", "cpu"] + _FARMER) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["outer_bound"] <= EF_OBJ + 1.0
    rep = _analyze_json(pdir, capsys)
    bad = [i for i in rep["invariants"] if not i["ok"]]
    assert not bad, bad
    assert {i["name"] for i in rep["invariants"]} >= {
        "no_late_retraces", "clean_shutdown_footer",
        "schema_consistent_across_roles", "no_silent_starvation"}
    assert rep["compile"]["compiles"] == 0
    rf = rep["roofline"]
    assert rf["ledger_matches"] and rf["jax_compiles"] == 0
    assert rf["device"]["device_kind"] == "cpu"
    assert rf["overall"]["iters"] == 6
    assert set(rep["bound_flow"]) == {"spoke0", "spoke1"}
    assert rep["forensics"]["samples"] == 3
    assert [r["iter"] for r in rep["iterations"]] == list(range(1, 7))
    capsys.readouterr()
    assert main(["analyze", pdir]) == 0
    text = capsys.readouterr().out
    for sec in ("== phase breakdown ==", "== roofline ==",
                "== bound flow ==", "== forensics ==",
                "== invariant checks =="):
        assert sec in text
    assert "[FAIL]" not in text
    assert jax_main(["farmer", "--telemetry-dir", jdir,
                     "--forensics-interval", "2"] + _FARMER) == 0
    capsys.readouterr()
    rc = main(["analyze", "--compare", jdir, pdir])
    out = capsys.readouterr().out
    assert rc in (0, 3), out
    assert "VERDICT:" in out


def test_process_wheel_role_artifacts_and_merged_trace(tmp_path):
    """A process wheel with a telemetry directory: the spoke child
    records under its role and the hub merges the traces into one
    trace_merged.json with one track per process."""
    from mpisppy_tpu_torch.utils.multiproc import spin_the_wheel_processes
    cfg = RunConfig(model="farmer", num_scens=3, rel_gap=0.05,
                    spokes=[SpokeConfig(kind="lagrangian")],
                    telemetry_dir=str(tmp_path), device="cpu")
    cfg.algo.default_rho = 10.0
    cfg.algo.max_iterations = 30
    try:
        spin_the_wheel_processes(cfg)
    finally:
        obs.shutdown()
    names = set(os.listdir(tmp_path))
    for f in ("events.jsonl", "trace.json", "metrics.json",
              "events-spoke0-lagrangian.jsonl",
              "trace-spoke0-lagrangian.json",
              "metrics-spoke0-lagrangian.json", "trace_merged.json"):
        assert f in names, (f, sorted(names))
    with open(tmp_path / "trace_merged.json") as fh:
        merged = json.load(fh)
    procs = {e["pid"] for e in merged["traceEvents"]
             if e.get("ph") == "M" and e.get("name") == "process_name"}
    assert len(procs) == 2
    with open(tmp_path / "events-spoke0-lagrangian.jsonl") as fh:
        spoke = [json.loads(line) for line in fh]
    assert spoke[0]["role"] == "spoke0-lagrangian"
    assert spoke[-1]["type"] == "run_footer"


def test_catalog_documents_every_port_name():
    """The lint extractor (tools/lint/rules/obscat.py, the JAX package's
    catalog guard) over the port: every metric and event name it emits
    is in doc/observability.md, except the listed port-only names."""
    from tools.lint.rules.obscat import extract_names
    names = set()
    for dirpath, _, files in os.walk(os.path.join(REPO,
                                                  "mpisppy_tpu_torch")):
        for fn in files:
            if fn.endswith(".py"):
                with open(os.path.join(dirpath, fn),
                          encoding="utf-8") as fh:
                    names |= extract_names(fh.read(),
                                           kinds=("metric", "event"))
    assert len(names) >= 60, sorted(names)
    with open(os.path.join(REPO, "doc", "observability.md"),
              encoding="utf-8") as fh:
        doc = fh.read()
    missing = sorted(n for n in names if n not in doc)
    assert set(missing) == PORT_ONLY, missing
    with open(os.path.join(REPO, "README.md"), encoding="utf-8") as fh:
        readme = fh.read()
    assert all(n in readme for n in PORT_ONLY)


def test_merged_trace_gives_every_process_a_track(tmp_path):
    """A process that recorded no span (a spoke stopped before its first
    solve) still gets its track in trace_merged.json, labelled with its
    role."""
    from mpisppy_tpu_torch.obs.merge import merge_traces
    from mpisppy_tpu_torch.obs.trace import TraceBuffer
    hub = TraceBuffer(str(tmp_path / "trace.json"))
    hub.complete("ph.solve", 0.0, 1.0)
    hub.flush()
    TraceBuffer(str(tmp_path / "trace-spoke0-xhatshuffle.json"),
                role="spoke0-xhatshuffle").flush()
    with open(merge_traces(str(tmp_path))) as fh:
        merged = json.load(fh)
    names = sorted(e["args"]["name"].split()[0]
                   for e in merged["traceEvents"]
                   if e.get("name") == "process_name")
    assert names == ["hub", "spoke0-xhatshuffle"]
