"""The port's process wheels: the native seqlock windows built from the
port's own source (mpisppy_tpu_torch/ops/native), the async
Synchronizer over them, the spokes-as-processes launcher
(utils/multiproc) and the scenario-sharded APH (core/aph_shard) — the
cases of tests/test_synchronizer.py and tests/test_multiproc.py:23-89
run on the port, on the CPU (every child is told device="cpu")."""

import multiprocessing as mp
import os
import threading
import time

import numpy as np
import pytest

from mpisppy_tpu_torch.cylinders.spcommunicator import SharedWindow, Window
from mpisppy_tpu_torch.ops import native
from mpisppy_tpu_torch.utils import multiproc
from mpisppy_tpu_torch.utils.config import AlgoConfig, RunConfig, SpokeConfig
from mpisppy_tpu_torch.utils.multiproc import (_spoke_window_names,
                                               spin_the_wheel_processes)
from mpisppy_tpu_torch.utils.synchronizer import Synchronizer

EF3 = -108390.0


# ---------------- the native library ----------------

def test_native_library_builds_from_the_ports_source():
    """The library is compiled from mpisppy_tpu_torch/ops/native/
    spwindow.cpp into build/native, under a name carrying the source's
    hash; the JAX package's committed .so is never loaded."""
    lib = native.build()
    assert lib == native.target() and lib.exists()
    assert lib.parent.parts[-2:] == ("build", "native")
    assert native.SRC.parent.name == "native" \
        and native.SRC.parent.parent.parent.name == "mpisppy_tpu_torch"
    loaded = native.load()
    assert os.path.samefile(loaded._name, lib)


def test_native_failed_build_raises(tmp_path, monkeypatch):
    bad = tmp_path / "spwindow.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "out")
    with pytest.raises(RuntimeError, match="failed"):
        native.build()
    assert not list((tmp_path / "out").glob("*.so"))


def _child_put(name, length, values):
    w = Window.shared(name, length, create=False)
    try:
        w.put(np.asarray(values, dtype=np.float64))
    finally:
        w.close(unlink=False)


def test_two_processes_share_one_window():
    """A spawned child opens the parent's window and writes it; the
    parent reads the payload and the bumped write id."""
    name = f"/spwtest2p{os.getpid():x}"
    w = Window.shared(name, 3, create=True)
    try:
        p = mp.get_context("spawn").Process(target=_child_put,
                                            args=(name, 3, [7.0, 8.0, 9.0]))
        p.start()
        p.join(timeout=60)
        assert not p.is_alive() and p.exitcode == 0
        vals, wid = w.read()
        assert wid == 1 and vals.tolist() == [7.0, 8.0, 9.0]
    finally:
        w.close()


# ---------------- tests/test_multiproc.py:23-89 ----------------

def test_window_names_generation_suffix():
    assert _spoke_window_names("/spwX", 2) == ("/spwXh2", "/spwXs2")
    assert _spoke_window_names("/spwX", 2, gen=0) == ("/spwXh2", "/spwXs2")
    assert _spoke_window_names("/spwX", 2, gen=3) \
        == ("/spwXh2r3", "/spwXs2r3")


def test_startup_timeout_reaps_children_and_windows(monkeypatch):
    """When the hello wait times out, every spawned child is terminated
    and joined and every window unlinked before the error re-raises.
    The run's window prefix is pinned, so only this run's segments are
    looked for (/dev/shm is shared with every other process)."""
    token = f"leak{os.getpid():x}"
    drawn = []

    def pinned(nbytes=None):
        drawn.append(nbytes)
        return token

    monkeypatch.setattr(multiproc.secrets, "token_hex", pinned)
    prefix = f"spw{os.getpid():x}{token}"
    cfg = RunConfig(model="farmer", num_scens=3,
                    spokes=[SpokeConfig(kind="lagrangian")], rel_gap=0.5,
                    # a child cannot import torch and build its engine
                    # this fast, so the wait times out
                    spoke_ready_timeout=0.5, device="cpu")
    before_pids = {p.pid for p in mp.active_children()}
    shm = "/dev/shm"
    with pytest.raises(TimeoutError):
        spin_the_wheel_processes(cfg)
    assert drawn, "the wheel did not draw its run id"
    deadline = time.monotonic() + 15.0
    while time.monotonic() < deadline:
        leftover = [p for p in mp.active_children()
                    if p.pid not in before_pids and p.is_alive()]
        if not leftover:
            break
        time.sleep(0.2)
    assert not leftover, f"leaked children: {leftover}"
    if os.path.isdir(shm):
        left = [f for f in os.listdir(shm) if f.startswith(prefix)]
        assert not left, f"leaked windows: {left}"


def test_shared_window_protocol():
    """Write-id/kill semantics across create/open handles."""
    name = f"/spwtest_proto{os.getpid():x}"
    w = Window.shared(name, 3, create=True)
    assert isinstance(w, SharedWindow)
    try:
        r = Window.shared(name, 3, create=False)
        assert r.read_id() == 0
        w.put(np.array([1.0, 2.0, 3.0]))
        vals, wid = r.read()
        assert wid == 1 and np.allclose(vals, [1, 2, 3])
        w.put(np.array([4.0, 5.0, 6.0]))
        vals, wid = r.read()
        assert wid == 2 and np.allclose(vals, [4, 5, 6])
        w.kill()
        assert r.read_id() == Window.KILL
        r.close(unlink=False)
    finally:
        w.close()
    with pytest.raises(OSError):
        Window.shared(name, 3, create=False)   # unlinked by its owner


def test_two_process_farmer_wheel():
    """A PH hub in this process, the Lagrangian and x̂ spokes as child
    processes: the hub consumes fresh spoke writes beyond the hello and
    the bounds sandwich the EF optimum."""
    cfg = RunConfig(
        model="farmer", num_scens=3,
        algo=AlgoConfig(default_rho=1.0, max_iterations=4000,
                        convthresh=-1.0, subproblem_max_iter=2000,
                        subproblem_eps=1e-7),
        spokes=[SpokeConfig(kind="lagrangian"),
                SpokeConfig(kind="xhatshuffle")],
        rel_gap=0.05, device="cpu")
    hub = spin_the_wheel_processes(cfg, join_timeout=180.0)
    assert hub._spoke_last_ids[0] > 1, "no Lagrangian update consumed"
    assert hub._spoke_last_ids[1] > 1, "no x̂ update consumed"
    assert hub.BestOuterBound <= EF3 + 2.0
    assert hub.BestInnerBound >= EF3 - 2.0
    assert hub.BestOuterBound <= hub.BestInnerBound \
        + 1e-5 * abs(hub.BestInnerBound)


# ---------------- tests/test_synchronizer.py ----------------

def _group(names_lens, n):
    wins = Synchronizer.make_thread_windows(names_lens, n)
    return [Synchronizer(names_lens, n, i, windows=wins, sleep_secs=0.002)
            for i in range(n)]


def test_sync_allreduce_rounds():
    syncs = _group({"red": 4}, 3)
    out = [[] for _ in range(3)]

    def worker(i):
        for r in range(5):
            out[i].append(syncs[i].sync_allreduce(
                np.full(4, float((i + 1) * (r + 1)))))

    ts = [threading.Thread(target=worker, args=(i,)) for i in range(3)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=30)
        assert not t.is_alive()
    for i in range(3):
        for r in range(5):
            assert np.allclose(out[i][r], 6.0 * (r + 1))


def test_keep_up_folds_newest_local():
    syncs = _group({"v": 2}, 2)
    g = {"v": np.zeros(2)}
    syncs[0].compute_global_data({"v": np.array([3.0, 4.0])}, g, keep_up=True)
    assert np.allclose(g["v"], [3.0, 4.0])
    g2 = {"v": np.zeros(2)}
    syncs[0].compute_global_data({"v": np.array([9.0, 9.0])}, g2)
    assert np.allclose(g2["v"], [3.0, 4.0])


def test_async_staleness_no_blocking():
    syncs = _group({"v": 1}, 2)
    got3 = threading.Event()

    def fast():
        g = {"v": np.zeros(1)}
        syncs[0].compute_global_data({"v": np.array([1.0])}, g, keep_up=True)
        assert g["v"][0] == 1.0
        deadline = time.monotonic() + 20
        while g["v"][0] < 3.0 and time.monotonic() < deadline:
            syncs[0].get_global_data(g)
            time.sleep(0.005)
        if g["v"][0] == 3.0:
            got3.set()

    def slow():
        time.sleep(0.3)
        g = {"v": np.zeros(1)}
        syncs[1].compute_global_data({"v": np.array([2.0])}, g, keep_up=True)
        while syncs[1].global_quitting == 0:
            time.sleep(0.01)

    def run(i, fct):
        return threading.Thread(target=lambda: syncs[i].run(fct))

    ta, tb = run(0, fast), run(1, slow)
    ta.start(), tb.start()
    ta.join(timeout=30), tb.join(timeout=30)
    assert not ta.is_alive() and not tb.is_alive()
    assert got3.is_set(), "straggler's summand never reached the global"


def test_listener_overlaps_worker():
    syncs = _group({"v": 1}, 1)

    def worker():
        b0 = syncs[0].beats
        time.sleep(0.2)
        return syncs[0].beats - b0

    assert syncs[0].run(worker) >= 5


def test_side_gig_runs_under_lock():
    calls = []

    def gig(sync):
        calls.append(sync.global_data["v"].copy())
        sync.enable_side_gig = False

    wins = Synchronizer.make_thread_windows({"v": 1}, 1)
    s = Synchronizer({"v": 1}, 1, 0, windows=wins, sleep_secs=0.002,
                     listener_gigs={"v": (gig, None)})

    def worker():
        g = {"v": np.zeros(1)}
        s.compute_global_data({"v": np.array([7.0])}, g, keep_up=True,
                              enable_side_gig=True)
        deadline = time.monotonic() + 10
        while not calls and time.monotonic() < deadline:
            time.sleep(0.005)

    s.run(worker)
    assert calls and calls[-1][0] == 7.0


# ---- sharded APH on farmer ----

APH_OPTS = {"defaultPHrho": 10.0, "PHIterLimit": 40, "convthresh": -1.0,
            "subproblem_max_iter": 3000, "subproblem_eps": 1e-8}


def _farmer(num_scens=3):
    from mpisppy_tpu_torch.ir.batch import build_batch
    from mpisppy_tpu_torch.models import farmer

    return build_batch(farmer.scenario_creator, farmer.make_tree(num_scens))


def _run_shards_threads(n_shards, num_scens=3, **opt):
    from mpisppy_tpu_torch.core.aph_shard import APHShard, make_shard

    batch = _farmer(num_scens)
    options = dict(APH_OPTS)
    options.update(opt)
    wins = Synchronizer.make_thread_windows(
        APHShard.reduction_lens(batch, n_shards), n_shards)
    engines = [make_shard(batch, options, n_shards, i, windows=wins,
                          device="cpu") for i in range(n_shards)]
    results = [None] * n_shards

    def go(i):
        results[i] = engines[i].run()

    ts = [threading.Thread(target=go, args=(i,)) for i in range(n_shards)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=300)
        assert not t.is_alive(), "shard worker hung"
    return engines, results


def test_aphshard_single_shard_matches_serial():
    """One shard is the serial math: its trivial bound equals the
    in-process APH's."""
    from mpisppy_tpu_torch.core.aph import APH

    engines, results = _run_shards_threads(1, PHIterLimit=5)
    conv, eobj, triv = results[0]
    serial = APH(_farmer(), dict(APH_OPTS, PHIterLimit=5), device="cpu")
    serial.APH_main(finalize=False)
    assert abs(triv - serial.trivial_bound) / abs(EF3) < 1e-6
    assert triv <= EF3 + 1.0


def test_aphshard_two_shards_converges():
    """Two shards agree on the consensus (x̄ from the same reduced
    vector, up to the last iteration's staleness), the trivial bound is
    the global one, and the consensus prices within 1 % of the EF."""
    from mpisppy_tpu_torch.core.aph import APH

    engines, results = _run_shards_threads(2, PHIterLimit=70)
    (c0, e0, t0), (c1, e1, t1) = results
    assert abs(t0 - t1) < 1e-9
    assert t0 <= EF3 + 1.0
    xb0 = engines[0].xbar.numpy()[0]
    xb1 = engines[1].xbar.numpy()[0]
    assert np.allclose(xb0, xb1, rtol=0.05, atol=1e-6)
    val = APH(_farmer(), dict(APH_OPTS), device="cpu").calculate_incumbent(
        xb0)
    assert val is not None
    assert abs(val - EF3) / abs(EF3) < 0.01


def test_aphshard_use_lag_runs():
    engines, results = _run_shards_threads(2, PHIterLimit=6,
                                           aph_use_lag=True,
                                           dispatch_frac=0.5)
    for conv, eobj, triv in results:
        assert np.isfinite(triv)
        assert triv <= EF3 + 1.0


def test_aphshard_async_frac_no_deadlock():
    engines, results = _run_shards_threads(2, PHIterLimit=10,
                                           async_frac_needed=0.5)
    for conv, eobj, triv in results:
        assert np.isfinite(triv)


def test_aphshard_processes_farmer():
    """One OS process per shard over the native windows; the shards'
    stats come back beside the result."""
    from mpisppy_tpu_torch.core.aph_shard import spin_aph_shards

    stats = []
    conv, eobj, triv, iters = spin_aph_shards(
        "farmer", 3, dict(APH_OPTS, PHIterLimit=15), 2, device="cpu",
        shard_stats=stats)
    assert triv <= EF3 + 1.0
    assert np.isfinite(eobj)
    assert iters >= 1
    assert [s["shard"] for s in stats] == [0, 1]
    assert [s["scenarios"] for s in stats] == [[0, 1], [1, 3]]
    assert all(s["device"] == "cpu" and s["seconds"] > 0 for s in stats)


def test_aph_shard_wheel_farmer():
    """Scenario-sharded APH processes over the Synchronizer, shard 0
    carrying the wheel hub, with the Lagrangian and x̂ spokes as
    processes: the bounds sandwich the 4-scenario farmer EF."""
    from mpisppy_tpu.core.ef import ExtensiveForm
    from mpisppy_tpu.ir.batch import build_batch as jax_build_batch
    from mpisppy_tpu.models import farmer as jax_farmer
    from mpisppy_tpu_torch.core.aph_shard import spin_aph_shard_wheel

    cfg = RunConfig(
        model="farmer", num_scens=4, hub="aph",
        algo=AlgoConfig(default_rho=10.0, max_iterations=800,
                        convthresh=-1.0, subproblem_max_iter=3000,
                        subproblem_eps=1e-8),
        spokes=[SpokeConfig(kind="lagrangian"),
                SpokeConfig(kind="xhatshuffle")],
        rel_gap=0.05, device="cpu")
    conv, eobj, triv, iters, outer, inner = spin_aph_shard_wheel(
        cfg, n_shards=2)
    ef_obj, _ = ExtensiveForm(
        jax_build_batch(jax_farmer.scenario_creator,
                        jax_farmer.make_tree(4))).solve_extensive_form()
    assert np.isfinite(outer), "lagrangian spoke never published a bound"
    assert np.isfinite(inner), "x̂ spoke never published an incumbent"
    assert outer <= ef_obj + 1e-4 * abs(ef_obj)
    assert inner >= ef_obj - 1e-4 * abs(ef_obj)
    assert triv <= ef_obj + 1.0


def _child_build(build_dir, q):
    from pathlib import Path

    from mpisppy_tpu_torch.ops import native as nat
    nat.BUILD_DIR = Path(build_dir)
    q.put(str(nat.load()._name))


def test_native_build_races_across_processes(tmp_path):
    """Two spawned processes load the library from an empty build
    directory at once: under the file lock one compiles, both load the
    same file, and no temporary file is left behind."""
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=_child_build, args=(str(tmp_path), q))
             for _ in range(2)]
    for p in procs:
        p.start()
    paths = [q.get(timeout=120) for _ in procs]
    for p in procs:
        p.join(timeout=60)
        assert not p.is_alive() and p.exitcode == 0
    assert paths[0] == paths[1]
    assert sorted(f.name for f in tmp_path.iterdir()) == \
        sorted([".lock", os.path.basename(paths[0])])
