"""The port's per-iteration record and telemetry session
(mpisppy_tpu_torch core/ph.py ``iteration_record``, obs/) against the
JAX package's on the same run, and the session's contracts: span
totals equal ``phase_timing``, ``ph.gate_syncs`` does not move with
forensics on, the disabled path allocates nothing, results are
bit-equal with telemetry on and off, and the roofline model books the
same work for the hand-written block's plain version and the reference
backend.

Both packages run PH on UC 3 x 6 with the slice's fixed-rho block
options, where their trajectories agree to 1e-8 (tests/test_torch_ph.py).
Bars: conv, the forensic sample's values and the shares at 1e-7
relative, the residual summary at 1e-6 relative (maxima of residuals
near 1e-6), the best outer bound at 1e-6 relative (the certified
trivial bounds of the two packages differ at 1e-7); the counter deltas
both packages book are equal, except the ``jax.*`` compile counters
(the port compiles nothing) and ``profile.*`` (XLA's cost model there,
the analytic model here)."""

import os
import tracemalloc

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpisppy_tpu import obs as jax_obs
from mpisppy_tpu.core.ph import PH as JaxPH
from mpisppy_tpu.ir.batch import build_batch as jax_build_batch
from mpisppy_tpu.models import uc as jax_uc
from mpisppy_tpu_torch import obs
from mpisppy_tpu_torch.core.ph import PH
from mpisppy_tpu_torch.ir.batch import build_batch
from mpisppy_tpu_torch.models import uc
from mpisppy_tpu_torch.obs import profile
from mpisppy_tpu_torch.ops import kernels
from mpisppy_tpu_torch.ops import qp_solver as T
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

_UC_KW = {"num_gens": 3, "num_hours": 6}
_UC_OPTS = {"defaultPHrho": 100.0, "convthresh": -1.0,
            "subproblem_kernel_mode": "fused",
            "subproblem_kernel_backend": "pallas",
            "subproblem_max_iter": 400, "subproblem_polish_hot": False,
            "subproblem_polish_chunk": 2}


def _uc(S=3):
    return build_batch(uc.scenario_creator, uc.make_tree(S),
                       creator_kwargs=_UC_KW,
                       vector_patch=uc.scenario_vector_patch)


def _port_run(opts, S=3, session=True):
    """(engine, ph.iteration records) of one port PH run."""
    if session:
        obs.configure()
    try:
        ph = PH(_uc(S), dict(opts), device="cpu")
        ph.ph_main()
        return ph, [e for _, e in obs.events("ph.iteration")]
    finally:
        if session:
            obs.shutdown()


def test_iteration_record_matches_jax():
    opts = dict(_UC_OPTS, PHIterLimit=3, forensics_interval=1)
    jax_obs.configure(out_dir=None)
    try:
        JaxPH(jax_build_batch(jax_uc.scenario_creator, jax_uc.make_tree(3),
                              creator_kwargs=_UC_KW,
                              vector_patch=jax_uc.scenario_vector_patch),
              dict(opts), dtype=jnp.float64).ph_main()
        jrecs = [e for e in jax_obs.active().events.tail
                 if e["type"] == "ph.iteration"]
    finally:
        jax_obs.shutdown()
    _, precs = _port_run(opts)
    assert [r["iter"] for r in precs] == [r["iter"] for r in jrecs] \
        == [1, 2, 3]
    for j, p in zip(jrecs, precs):
        assert set(p) - {"profile"} == set(j) - {"profile"}
        assert "profile" in p
        assert set(p["profile"]) == {"iter", "seconds", "flops_per_iter",
                                     "hbm_bytes_per_iter", "mfu",
                                     "hbm_gbps", "hbm_util"}
        assert p["conv"] == pytest.approx(j["conv"], rel=1e-7)
        assert p["best_outer"] == pytest.approx(j["best_outer"], rel=1e-6)
        for k in ("pri_rel_max", "pri_rel_mean", "dua_rel_max",
                  "dua_rel_mean"):
            assert p[k] == pytest.approx(j[k], rel=1e-6), k
        assert set(p["phase_seconds"]) == set(j["phase_seconds"])
        cj = {k: v for k, v in j["counter_deltas"].items()
              if not k.startswith(("jax.", "profile."))}
        cp = {k: v for k, v in p["counter_deltas"].items()
              if not k.startswith("profile.")}
        assert cp == cj
        assert p["counter_deltas"]["profile.hbm_bytes"] > 0
        fj, fp = j["forensics"], p["forensics"]
        assert set(fp) == set(fj)
        for k in ("samples", "it", "n_scens", "n_slots"):
            assert fp[k] == fj[k]
        for k in ("conv", "pri_total", "dua_total", "osc_mean",
                  "rho_log_ratio_mean", "xbar_move", "rho_mean"):
            assert fp[k] == pytest.approx(fj[k], rel=1e-7, abs=1e-12), k
        for k in ("top_slots", "osc_slots", "rho_slots", "scen_pri_shares",
                  "scen_dua_shares"):
            vj = [v for _, v in fj[k]]
            vp = [v for _, v in fp[k]]
            np.testing.assert_allclose(vp, vj, rtol=1e-7, atol=1e-12)
            for (ij, x), (ip, _) in zip(fj[k], fp[k]):
                # ids where the value is not tied on the leaderboard
                if sum(abs(x - y) <= 1e-9 * max(1.0, abs(x))
                       for y in vj) == 1:
                    assert ip == ij, (k, fj[k], fp[k])


def test_span_totals_equal_phase_timing():
    """The trace's phase spans share the engine's perf_counter marks:
    their totals per phase equal the phase_timing accumulators."""
    obs.configure()
    try:
        ph = PH(_uc(), dict(_UC_OPTS, PHIterLimit=2), device="cpu")
        ph.ph_main()
        events = obs.active().trace.to_json()["traceEvents"]
        spans = {p: [e for e in events if e["name"] == f"ph.{p}"]
                 for p in ("assemble", "solve", "gate", "reduce")}
    finally:
        obs.shutdown()
    tot = ph._phase_totals()
    for p, ss in spans.items():
        got = sum(s["dur"] for s in ss) / 1e6
        assert got == pytest.approx(tot[p], rel=1e-9, abs=1e-9), p
    n_calls = sum(e["calls"] for e in ph._phase_times.values())
    assert len(spans["solve"]) == n_calls


def test_gate_syncs_unchanged_with_forensics_on():
    """The forensic fetch rides the iteration record, after the gate:
    the chunked loop's ph.gate_syncs is the same with a sample every
    iteration as with none."""
    syncs = []
    for every in (0, 1):
        obs.configure()
        try:
            PH(_uc(6), dict(_UC_OPTS, PHIterLimit=3, subproblem_chunk=2,
                            forensics_interval=every), device="cpu").ph_main()
            syncs.append(obs.counters_snapshot()["ph.gate_syncs"])
            n = len(obs.events("forensics.sample"))
        finally:
            obs.shutdown()
    assert n == 3
    assert syncs[0] == syncs[1] == 4


def test_disabled_path_allocates_nothing():
    """With no session every hot-path call is a global read and a None
    test, and span() returns one shared singleton: tracemalloc sees
    nothing allocated in the obs package."""
    assert not obs.enabled()
    assert obs.span("a") is obs.span("b")
    obs.counter_add("w")
    obs.event("w")
    obs.complete_span("w", 0.0, 1.0)
    obs_dir = os.path.dirname(obs.__file__)
    tracemalloc.start()
    before = tracemalloc.take_snapshot()
    for _ in range(500):
        obs.counter_add("ph.gate_syncs")
        obs.complete_span("ph.solve", 0.0, 1.0)
        obs.event("ph.iteration")
        obs.gauge_set("g", 1.0)
        obs.histogram_observe("h", 1.0)
        with obs.span("ph.x"):
            pass
    after = tracemalloc.take_snapshot()
    tracemalloc.stop()
    leaked = sum(s.size_diff for s in after.compare_to(before, "lineno")
                 if s.size_diff > 0
                 and any(obs_dir in str(fr.filename) for fr in s.traceback))
    assert leaked < 500, f"disabled obs calls allocated {leaked} B"


@pytest.mark.parametrize("chunk", [None, 2])
def test_results_bit_equal_with_telemetry_on_and_off(chunk):
    opts = dict(_UC_OPTS, PHIterLimit=3, forensics_interval=1)
    if chunk:
        opts["subproblem_chunk"] = chunk
    off, _ = _port_run(opts, S=4, session=False)
    on, recs = _port_run(opts, S=4)
    assert len(recs) == 3 and all("forensics" in r for r in recs)
    assert torch.equal(on.xbar, off.xbar)
    assert torch.equal(on.W, off.W)
    assert on.conv == off.conv


def _tiny(S=3, m=6, n=4, seed=0):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(m, n))
    P = np.abs(rng.normal(size=n)) + 0.5
    mid = rng.normal(size=(S, m))
    d = T.QPData(*(torch.as_tensor(a) for a in (
        P, A, mid - 3.0, mid + 3.0, np.full((S, n), -5.0),
        np.full((S, n), 5.0))))
    q = torch.as_tensor(rng.normal(size=(S, n)))
    f = T.qp_setup(d, q_ref=q)
    return f, d, q, T.qp_cold_state(f, d)


def test_profile_model_books_the_same_work_for_both_backends():
    """20 fixed-rho steps through the hand-written block's wrapper (its
    plain version on the CPU) and through the reference backend, with
    one residual pass each: the same FLOPs and bytes, which are
    profile.block_cost's. The block's finisher books its own pass."""
    f, d, q, st = _tiny()
    kw = dict(precision="native", max_iter=20, tail_iter=0, e_pri=-1.0,
              e_dua=-1.0, stall_rel=0.0, polish=False, polish_chunk=0,
              ir_sweeps=1, check_every=20, adaptive_rho=False)
    totals = {}
    for backend in ("cuda", "reference"):
        obs.configure()
        try:
            plan = kernels.prepare(f, mode="fused", backend=backend)
            assert plan.backend == backend
            out = kernels.kernel_solve(plan, f, d, q, st, **kw)
            assert out[0].iters == 20
            totals[backend] = profile.entry_totals()
            dev = obs.events("profile.device")
        finally:
            obs.shutdown()
        assert dev and dev[0][1]["device_kind"] == "cpu"
    blk = totals["cuda"]["kernel.cuda"]
    ref = totals["reference"]["qp.solve"]
    assert blk["calls"] == ref["calls"] == 1
    assert (blk["flops"], blk["bytes"]) == (ref["flops"], ref["bytes"])
    assert (blk["flops"], blk["bytes"]) == profile.block_cost(3, 6, 4, 20)
    # the finisher: no steps, one residual pass
    fin = totals["cuda"]["qp.solve"]
    assert (fin["flops"], fin["bytes"]) == profile.qp_cost(3, 6, 4, 0, 20)


def test_block_model_at_the_reference_uc():
    """The block's byte floor at uc-ref-S10 (n = 13,056, m = 26,016,
    S = 10): 20 steps read A and F once each per step plus one pass of
    A, 84.3 GB, 25.18 ms at 3.35 TB/s; a 1500-step solve books
    25.5 TFLOP."""
    fl, by = profile.block_cost(10, 26016, 13056, 20)
    assert by == 8 * (20 * (26016 * 13056 + 13056 ** 2) + 26016 * 13056)
    assert by / 3.35e12 * 1e3 == pytest.approx(25.18, abs=0.01)
    fl, _ = profile.block_cost(10, 26016, 13056, 1500)
    assert fl / 1e12 == pytest.approx(25.5, abs=0.05)


def test_span_bridges_to_the_torch_profiler_only_while_it_records():
    """obs.span opens a record_function range only while a torch
    profiler records (no NVTX without ``annotations``): the range shows
    in the profiler's table by the span's name."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile
    obs.configure()
    try:
        sp = obs.span("ph.bridge_probe")
        with sp:
            assert sp._rf is None and not sp._nvtx
        with torch_profile(activities=[ProfilerActivity.CPU]) as prof:
            with obs.span("ph.bridge_probe"):
                torch.ones(8) @ torch.ones(8)
        events = obs.active().trace.to_json()["traceEvents"]
        assert sum(e["name"] == "ph.bridge_probe" for e in events) == 2
    finally:
        obs.shutdown()
    assert "ph.bridge_probe" in {e.key for e in prof.key_averages()}
    # a session with annotations on opens the range without a profiler
    # (NVTX too, once this process has a CUDA context)
    obs.configure(annotations=True)
    try:
        sp = obs.span("ph.bridge_probe")
        with sp:
            assert sp._rf is not None
        assert sp._rf is None
    finally:
        obs.shutdown()


def test_transfer_byte_helpers():
    """tree_nbytes sums a nested structure's tensor and array bytes;
    put_nbytes counts only the leaves whose device changes."""
    from mpisppy_tpu_torch.obs.resource import put_nbytes, tree_nbytes
    st = T.QPState(*(torch.zeros(3, 4) for _ in range(7)), 5,
                   *(torch.zeros(3) for _ in range(4)))
    tree = {"st": st, "host": np.zeros(10), "none": None}
    assert tree_nbytes(tree) == 7 * 48 + 4 * 12 + 80
    assert put_nbytes(tree, lambda leaf: "cpu") == 80
    assert put_nbytes(tree, lambda leaf: "meta") == tree_nbytes(tree)
