"""The port's scenario streaming (mpisppy_tpu_torch/stream, the chunked
loop of core/ph.py with a scenario source) on the CPU: resident,
streamed and synthesized runs of one family equal within the port, the
port held against the JAX package's runs of the same batches, the
transfer accounting, the prefetch thread's lifecycle, the hospital,
compaction, dispatch-driven staging, the incumbent surface, the CLI and
the S = 100k synthesized wheel.

Bars against the JAX package: the chunked tests' (x̄ and W 1e-8, the
bounds 2e-6, relative to max(1, |.|)), under the slice's fixed-rho
block options (tests/test_torch_chunked.py's ``_FUSED``; with adaptive
rho the two packages' farmer traces drift apart by ~1e-6 in W). The
port's chunked streamed runs are held against the JAX package's
UNCHUNKED runs: its chunked loop warm-starts from the mixed view of
ROADMAP.md C.2. The S = 100k run and the mesh are in
tests/test_torch_stream_scale.py."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpisppy_tpu.core.ph import PH as JaxPH
from mpisppy_tpu.ir.batch import build_batch as jax_build_batch
from mpisppy_tpu.models import farmer as jax_farmer
from mpisppy_tpu.models import uc as jax_uc
from mpisppy_tpu.stream import synth as jax_synth
from mpisppy_tpu_torch import obs
from mpisppy_tpu_torch.core.ph import PH, PHBase
from mpisppy_tpu_torch.cylinders.hub import Hub
from mpisppy_tpu_torch.ir.batch import build_batch
from mpisppy_tpu_torch.models import farmer, uc
from mpisppy_tpu_torch.stream import synth_batch

from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

FARMER_OPTS = {"defaultPHrho": 1.0, "PHIterLimit": 5, "convthresh": 0.0,
               "subproblem_chunk": 4, "subproblem_max_iter": 3000,
               "subproblem_eps": 1e-9}
UC_OPTS = {"defaultPHrho": 50.0, "PHIterLimit": 3, "convthresh": 0.0,
           "subproblem_chunk": 2, "subproblem_max_iter": 2000,
           "subproblem_eps": 1e-8}
UC_KW = {"num_gens": 3, "num_hours": 6}
# the slice's fused options at this size (tests/test_torch_chunked.py)
_FUSED = {"defaultPHrho": 100.0, "PHIterLimit": 3,
          "subproblem_kernel_mode": "fused",
          "subproblem_kernel_backend": "pallas",
          "subproblem_max_iter": 400, "subproblem_polish_hot": False,
          "subproblem_polish_chunk": 2}


@pytest.fixture
def mem_obs():
    rec = obs.configure()
    yield rec
    obs.shutdown()


def farmer_pair(S=12, seed=7):
    """(materialized batch, broadcast-view batch, spec) of the farmer
    synth family: one data source, three representations."""
    tree = farmer.make_tree(S)
    b_res, _ = synth_batch(farmer.scenario_creator, tree,
                           farmer.scenario_synth_spec, seed=seed)
    b_syn, spec = synth_batch(farmer.scenario_creator, tree,
                              farmer.scenario_synth_spec, seed=seed,
                              materialize_values=False)
    return b_res, b_syn, spec


def uc_vp_batch(S=6, **kw):
    return build_batch(uc.scenario_creator, uc.make_tree(S),
                       creator_kwargs=dict(UC_KW, **kw),
                       vector_patch=uc.scenario_vector_patch)


def _rel(ref, got):
    ref = np.asarray(ref)
    got = got.cpu().numpy() if hasattr(got, "cpu") else np.asarray(got)
    return float(np.abs(got - ref).max()) / max(1.0,
                                                float(np.abs(ref).max()))


def _run(batch, opts, **kw):
    ph = PH(batch, dict(opts), device="cpu", **kw)
    out = ph.ph_main()
    ph.close_stream()
    return ph, out


# ---------------- equality within the port ----------------

def test_farmer_resident_streamed_synthesized_identical(mem_obs):
    """The exact setup surrogates make the factors equal, and the staged
    chunk data is the resident data: the three sources give the SAME
    trajectory."""
    b_res, b_syn, spec = farmer_pair()
    ph0, r0 = _run(b_res, FARMER_OPTS)
    ph1, r1 = _run(b_res, dict(FARMER_OPTS, scenario_source="streamed"))
    ph2, r2 = _run(b_syn, dict(FARMER_OPTS, scenario_source="synthesized",
                               synth_spec=spec))
    assert r1 == r0 and r2 == r0
    for ph in (ph1, ph2):
        assert torch.equal(ph.xbar, ph0.xbar) and torch.equal(ph.W, ph0.W)
    ctr = obs.counters_snapshot()
    assert ctr["stream.chunks_shipped"] > 0 and ctr["stream.synth_chunks"] > 0
    # the stream engines hold no full-width vector on the device
    assert ph1.qp_data.l.shape[0] == 2 and ph2.P_diag is None
    rec = [e for _, e in obs.events("ph.iteration") if "stream" in e]
    assert {r["stream"]["source"] for r in rec} == {"streamed",
                                                    "synthesized"}


def test_uc_vector_patch_resident_streamed_identical():
    """The standard UC batch streams as it is: streamed never changes
    the instance."""
    b = uc_vp_batch()
    ph0, r0 = _run(b, UC_OPTS)
    ph1, r1 = _run(b, dict(UC_OPTS, scenario_source="streamed"))
    assert r1 == r0
    assert torch.equal(ph1.xbar, ph0.xbar) and torch.equal(ph1.W, ph0.W)


def test_uc_synth_family_resident_vs_synthesized_identical():
    """The JAX package's case (ROADMAP.md C.2) held to the invariant its
    test states: resident and synthesized agree exactly, the same
    trajectory if iter 0 passes the gate, or the same abort (the same
    scenario and pri_rel) if not. At this size, seed and budget iter 0
    aborts on scen5 in both (ADMM stops at pri_rel 7.0e-3 after 2000
    steps, though the scenario's LP is feasible: host HiGHS solves it)."""
    tree = uc.make_tree(6)
    b_res, _ = synth_batch(uc.scenario_creator, tree,
                           uc.scenario_synth_spec,
                           creator_kwargs=dict(UC_KW), seed=3)
    b_syn, spec = synth_batch(uc.scenario_creator, tree,
                              uc.scenario_synth_spec,
                              creator_kwargs=dict(UC_KW), seed=3,
                              materialize_values=False)
    outcomes = []
    for b, extra in ((b_res, {}), (b_syn, {"scenario_source":
                                           "synthesized",
                                           "synth_spec": spec})):
        ph = PH(b, dict(UC_OPTS, **extra), device="cpu")
        try:
            outcomes.append(("ran", ph.ph_main(), ph.xbar.numpy()))
        except RuntimeError as e:
            outcomes.append(("abort", str(e),
                             ph._qp_states[False].pri_rel.numpy()))
        ph.close_stream()
    (k0, m0, v0), (k1, m1, v1) = outcomes
    assert k0 == k1 and m0 == m1 and np.array_equal(v0, v1)
    if k0 == "abort":
        assert "scen5" in m0


# ---------------- against the JAX package ----------------

def _against_jax(jbatch, batch, opts, chunk, source, spec=None):
    """The JAX package's unchunked resident run against the port's
    chunked run from ``source``: x̄, W and conv at 1e-8, Eobjective and
    the trivial bound at 2e-6."""
    jph = JaxPH(jbatch, options=dict(opts), dtype=jnp.float64)
    jr = jph.ph_main()
    extra = {"scenario_source": source, "subproblem_chunk": chunk}
    if spec is not None:
        extra["synth_spec"] = spec
    ph, r = _run(batch, dict(opts, **extra))
    assert ph._kernel_plans[True].backend == "cuda"
    assert _rel(jph.xbar, ph.xbar) <= 1e-8
    assert _rel(jph.W, ph.W) <= 1e-8
    assert r[0] == pytest.approx(jr[0], rel=1e-8)
    for a, b in zip(jr[1:], r[1:]):
        assert abs(a - b) <= 2e-6 * max(1.0, abs(a))


@pytest.mark.parametrize("source", ["streamed", "synthesized"])
def test_farmer_family_against_jax(source):
    opts = dict(_FUSED, defaultPHrho=10.0, subproblem_max_iter=1500,
                convthresh=0.0)
    bj, _ = jax_synth.synth_batch(jax_farmer.scenario_creator,
                                  jax_farmer.make_tree(12),
                                  jax_farmer.scenario_synth_spec, seed=7)
    b_res, b_syn, spec = farmer_pair()
    if source == "streamed":
        _against_jax(bj, b_res, opts, 4, source)
    else:
        _against_jax(bj, b_syn, opts, 4, source, spec)


def test_uc_streamed_against_jax_unchunked():
    bj = jax_build_batch(jax_uc.scenario_creator, jax_uc.make_tree(8),
                         creator_kwargs=dict(UC_KW),
                         vector_patch=jax_uc.scenario_vector_patch)
    _against_jax(bj, uc_vp_batch(S=8), _FUSED, 3, "streamed")


# ---------------- int8 storage ----------------

def test_int8_gate_reject_keeps_exact_storage(mem_obs):
    """A tolerance the quantization cannot meet keeps f64 storage, books
    the fallback, and the run stays equal to the resident one."""
    b_res, _, _ = farmer_pair()
    _, r0 = _run(b_res, FARMER_OPTS)
    ph = PH(b_res, dict(FARMER_OPTS, scenario_source="streamed",
                        stream_int8=True, stream_int8_tol=1e-12),
            device="cpu")
    r1 = ph.ph_main()
    kinds = {f: k for f, (k, _) in ph._stream_source._store.items()}
    assert kinds["l"] == "f64" and kinds["c"] == "const"
    assert obs.counters_snapshot()["stream.int8_fallbacks"] >= 1
    assert r1 == r0
    ph.close_stream()


def test_int8_gate_accept_packs_and_tracks(mem_obs):
    b_res, _, _ = farmer_pair()
    ph0, r0 = _run(b_res, FARMER_OPTS)
    ph1 = PH(b_res, dict(FARMER_OPTS, scenario_source="streamed",
                         stream_int8=True, stream_int8_tol=1e-3),
             device="cpu")
    r1 = ph1.ph_main()
    src = ph1._stream_source
    assert {f: k for f, (k, _) in src._store.items()}["l"] == "int8"
    assert obs.counters_snapshot().get("stream.int8_fallbacks", 0) == 0
    full = sum(np.asarray(getattr(b_res, f)).nbytes
               for f in ("l", "u", "lb", "ub", "c"))
    assert src.host_nbytes() < full / 4
    assert r1[1] == pytest.approx(r0[1], rel=1e-3)
    assert _rel(ph0.xbar, ph1.xbar) <= 1e-3
    ph1.close_stream()


# ---------------- transfer accounting ----------------

@pytest.mark.parametrize("S", [32, 128])
def test_synthesized_steady_state_ships_nothing(mem_obs, S):
    _, b_syn, spec = farmer_pair(S=S)
    ph = PH(b_syn, dict(FARMER_OPTS, PHIterLimit=2, subproblem_chunk=8,
                        scenario_source="synthesized", synth_spec=spec),
            device="cpu")
    ph.ph_main(finalize=False)
    assert obs.counters_snapshot()["xfer.device_put_bytes"] > 0
    for _ in range(2):
        before = obs.counters_snapshot()["xfer.device_put_bytes"]
        ph.solve_loop(w_on=True, prox_on=True)
        assert obs.counters_snapshot()["xfer.device_put_bytes"] == before


def test_streamed_per_iteration_bytes_flat(mem_obs):
    """Streamed steady-state iterations ship a constant number of bytes:
    two in-order passes of the chunks' varying fields."""
    b_res, _, _ = farmer_pair(S=16)
    ph = PH(b_res, dict(FARMER_OPTS, PHIterLimit=2,
                        scenario_source="streamed"), device="cpu")
    ph.ph_main(finalize=False)
    deltas = []
    for _ in range(3):
        before = obs.counters_snapshot()["xfer.device_put_bytes"]
        ph.solve_loop(w_on=True, prox_on=True)
        deltas.append(obs.counters_snapshot()["xfer.device_put_bytes"]
                      - before)
    # only l varies: 2 passes x 16 rows x its width
    assert deltas == [2 * 16 * b_res.m * 8] * 3
    ph.close_stream()


# ---------------- lifecycle ----------------

def test_close_stream_stops_prefetch_and_restarts():
    b_res, _, _ = farmer_pair(S=8)
    ph = PH(b_res, dict(FARMER_OPTS, PHIterLimit=2,
                        scenario_source="streamed"), device="cpu")
    ph.ph_main(finalize=False)
    src = ph._stream_source
    assert src.prefetch_alive
    ph.close_stream()
    assert not src.prefetch_alive
    ph.solve_loop(w_on=True, prox_on=True)
    assert src.prefetch_alive
    ph.close_stream()
    assert not src.prefetch_alive


def test_hub_finalize_closes_stream_source(mem_obs):
    b_res, _, _ = farmer_pair(S=8)
    ph = PH(b_res, dict(FARMER_OPTS, PHIterLimit=2,
                        scenario_source="streamed"), device="cpu")
    ph.ph_main(finalize=False)
    assert ph._stream_source.prefetch_alive
    assert ph._stream_source._pipeline._thread.daemon
    hub = Hub(ph, spokes=[], options={})
    hub.handle_preemption(source="test")
    # the preemption notice leaves the in-flight pass alone
    assert ph._stream_source.prefetch_alive
    hub.hub_finalize()
    assert not ph._stream_source.prefetch_alive


# ---------------- hospital, compaction, dispatch ----------------

def test_hospital_rescues_flagged_row_under_streaming(mem_obs):
    """The hospital's rescue stages exactly the flagged rows from the
    streamed source (one direct fetch)."""
    b = uc_vp_batch(S=8)
    opts = {"defaultPHrho": 50.0, "subproblem_max_iter": 1500,
            "subproblem_eps": 1e-6, "subproblem_chunk": 3,
            "subproblem_hospital_max": 4, "scenario_source": "streamed"}
    ph = PHBase(b, opts, device="cpu")
    ph.solve_loop(w_on=False, prox_on=False)
    ph.W = ph.W_new
    ph.solve_loop(w_on=True, prox_on=True)
    factors, data = ph._get_factors(True)
    slices = ph._chunk_index(3)
    states = ph._chunk_states[True]
    n, m = b.n, b.m
    recs = []
    for ci, (idx_c, real) in enumerate(slices):
        st = states[ci]
        if ci == 1:
            pr = st.pri_rel.clone()
            pr[0] = 1.0
            st = st._replace(pri_rel=pr)
        recs.append([st, torch.zeros(3, n, dtype=torch.float64),
                     torch.zeros(3, m, dtype=torch.float64),
                     torch.zeros(3, n, dtype=torch.float64), None, None,
                     factors])
    kw = dict(prox_on=True, precision=ph.sub_precision,
              sub_max_iter=ph.sub_max_iter, sub_eps=ph.sub_eps,
              sub_eps_hot=ph.sub_eps_hot,
              sub_eps_dua_hot=ph.sub_eps_dua_hot,
              tail_iter=ph.sub_tail_iter, stall_rel=ph.sub_stall_rel,
              segment=ph.sub_segment, polish_hot=ph.sub_polish_hot,
              polish_chunk=0, segment_lo=ph.sub_segment_lo,
              ir_sweeps=ph.sub_ir_sweeps, kernel=None)
    before = obs.counters_snapshot().get("stream.direct_fetches", 0)
    ph._hospitalize(True, slices, recs, data, 1e-2, True, True, kw)
    assert float(recs[1][0].pri_rel[0]) < 1e-2
    assert float(recs[1][1][0].abs().max()) > 0.0
    assert obs.counters_snapshot()["stream.direct_fetches"] == before + 1
    ph.close_stream()


_SHRINK = {"defaultPHrho": 50.0, "PHIterLimit": 10, "convthresh": 0.0,
           "subproblem_chunk": 2, "subproblem_max_iter": 4000,
           "subproblem_eps": 1e-6, "iter0_infeasibility_abort": False,
           "shrink_fix": True, "shrink_compact": True,
           "shrink_buckets": "0.1"}


def _fix_list(b):
    from mpisppy_tpu_torch.extensions.fixer import uniform_fix_list
    return uniform_fix_list(b, tol=1e-2, nb=3, lb=3, ub=3)


def test_streamed_compaction_bit_equal_resident_compaction(mem_obs):
    """Compacted + streamed equals compacted + resident: the transition
    restages once out of band (booked apart from bytes_shipped), the
    host store re-blocks at the compacted width, and the per-iteration
    bytes fall after the compaction (UC's varying ub block stages at the
    compacted column width)."""
    opts = dict(_SHRINK, id_fix_list_fct=_fix_list)
    ph0, r0 = _run(uc_vp_batch(relax_integrality=False), opts)
    assert ph0._shrink_status["compactions"] == 1
    from mpisppy_tpu_torch.extensions.extension import (Extension,
                                                        MultiExtension)
    from mpisppy_tpu_torch.extensions.fixer import DeviceFixer
    shipped = []

    class Bytes(Extension):
        def miditer(self, ph):
            st = ph._stream_source.status()
            shipped.append((st["bytes_shipped"],
                            st["compacted_transitions"]))

    opts1 = dict(opts, scenario_source="streamed")
    ph1 = PH(uc_vp_batch(relax_integrality=False), opts1, device="cpu",
             extensions=MultiExtension([DeviceFixer(opts1), Bytes()]))
    r1 = ph1.ph_main()
    ph1.close_stream()
    assert ph1._shrink_status["compactions"] == 1
    assert ph1._shrink_status["n_cols"] == ph0._shrink_status["n_cols"] \
        < ph1.batch.n
    assert r1 == r0
    assert torch.equal(ph1.xbar, ph0.xbar) and torch.equal(ph1.W, ph0.W)
    ss = ph1._stream_source.status()
    assert ss["compacted_transitions"] == 1
    assert ss["compacted_restage_bytes"] > 0
    per_iter = np.diff([0] + [s for s, _ in shipped])
    tr = next(i for i, (_, t) in enumerate(shipped) if t)
    before = per_iter[1:tr]          # steady full-width iterations
    after = per_iter[tr + 1:]        # steady compacted iterations
    assert len(before) and len(after)
    assert max(after) < min(before)
    assert obs.counters_snapshot()["stream.compacted_restage_bytes"] \
        == ss["compacted_restage_bytes"]


def test_synthesized_source_keeps_pin_boxes(mem_obs):
    """A synthesized source has no store to re-block: compaction is
    skipped (booked once per target) and fixing stays in the pin
    boxes."""
    tree = uc.make_tree(6)
    kw = dict(UC_KW, relax_integrality=False)
    b_syn, spec = synth_batch(uc.scenario_creator, tree,
                              uc.scenario_synth_spec, creator_kwargs=kw,
                              seed=1, materialize_values=False)
    ph = PH(b_syn, dict(_SHRINK, PHIterLimit=6, id_fix_list_fct=_fix_list,
                        scenario_source="synthesized", synth_spec=spec),
            device="cpu")
    ph.ph_main()
    assert ph._shrink_status["compactions"] == 0
    assert obs.counters_snapshot().get("shrink.compaction_skipped",
                                       0) <= 1


def test_streamed_dispatch_ships_fewer_bytes(mem_obs):
    """A partial APH pass stages only the dispatched chunks (the JAX
    package's tests/test_dispatch.py case, on the farmer synth family
    streamed)."""
    from mpisppy_tpu_torch.core.aph import APH
    b_res, _, _ = farmer_pair(S=12)
    aph = APH(b_res, {"defaultPHrho": 1.0, "PHIterLimit": 2,
                      "convthresh": -1.0, "subproblem_max_iter": 3000,
                      "subproblem_eps": 1e-8, "dispatch_frac": 0.25,
                      "subproblem_chunk": 4,
                      "scenario_source": "streamed"}, device="cpu")
    aph.APH_main(finalize=False)
    try:
        kw = dict(w_on=True, prox_on=True, update=False)

        def shipped(**extra):
            b0 = obs.counters_snapshot()["xfer.device_put_bytes"]
            aph.solve_loop(**kw, **extra)
            return obs.counters_snapshot()["xfer.device_put_bytes"] - b0

        shipped()                                    # warm the full path
        full_bytes = shipped()
        ids = np.array([0, 1, 2])                    # 1 chunk of 4
        shipped(dispatch=ids)                        # warm the skip path
        part_bytes = shipped(dispatch=ids)
    finally:
        aph.close_stream()
    assert 0 < part_bytes < full_bytes
    # 1 of 3 chunks staged: a third of the bytes
    assert part_bytes * 3 == full_bytes


# ---------------- the incumbent surface and the guards ----------------

def test_fixed_mode_consensus_eval_and_pool_refusals():
    b_res, _, _ = farmer_pair()
    ph0, _ = _run(b_res, FARMER_OPTS)
    ph = PH(b_res, dict(FARMER_OPTS, scenario_source="streamed"),
            device="cpu")
    ph.ph_main()
    xhat = ph.xbar[0].numpy()
    assert ph.calculate_incumbent(xhat) == pytest.approx(
        ph0.calculate_incumbent(xhat), rel=1e-9)
    with pytest.raises(RuntimeError, match="full-width"):
        ph.evaluate_incumbent_pool(np.zeros((2, b_res.K)))
    with pytest.raises(RuntimeError, match="full-width"):
        ph.dive_nonant_candidates()
    with pytest.raises(RuntimeError, match="full-width"):
        ph.scenario_objectives(ph.x)
    ph.close_stream()


def test_engine_rejects_stream_without_chunk_or_shared_structure():
    b_res, _, _ = farmer_pair(S=4)
    with pytest.raises(ValueError, match="subproblem_chunk"):
        PHBase(b_res, {"scenario_source": "streamed"}, device="cpu")
    with pytest.raises(ValueError, match="unknown scenario_source"):
        PHBase(b_res, {"scenario_source": "banana",
                       "subproblem_chunk": 2}, device="cpu")
    with pytest.raises(ValueError, match="synth_spec"):
        PHBase(b_res, {"scenario_source": "synthesized",
                       "subproblem_chunk": 2}, device="cpu")
    # the standard farmer carries per-scenario A: not streamable
    b_std = build_batch(farmer.scenario_creator, farmer.make_tree(3))
    with pytest.raises(ValueError, match="shared-structure"):
        PHBase(b_std, {"scenario_source": "streamed",
                       "subproblem_chunk": 2}, device="cpu")
    # a chunk that covers the batch is not the chunked loop
    ph = PHBase(b_res, {"scenario_source": "streamed",
                        "subproblem_chunk": 8}, device="cpu")
    with pytest.raises(ValueError, match="CHUNKED hot loop"):
        ph.solve_loop(w_on=False, prox_on=False)


def test_vanilla_guards_spokes_missing_spec_and_process_wheels():
    from mpisppy_tpu_torch.utils.config import (AlgoConfig, RunConfig,
                                                SpokeConfig)
    from mpisppy_tpu_torch.utils.multiproc import \
        spin_the_wheel_processes
    from mpisppy_tpu_torch.utils.vanilla import build_batch_for, \
        wheel_dicts
    cfg = RunConfig(model="farmer", num_scens=4, device="cpu",
                    algo=AlgoConfig(scenario_source="synthesized"),
                    hub_options={"subproblem_chunk": 2},
                    spokes=[SpokeConfig(kind="lagrangian")])
    with pytest.raises(ValueError, match="hub-only"):
        wheel_dicts(cfg)
    with pytest.raises(NotImplementedError, match="ROADMAP.md A8b"):
        spin_the_wheel_processes(cfg)
    cfg2 = RunConfig(model="hydro", num_scens=4, device="cpu",
                     algo=AlgoConfig(scenario_source="synthesized"))
    with pytest.raises(ValueError, match="scenario_synth_spec"):
        build_batch_for(cfg2)


@pytest.mark.parametrize("source", ["streamed", "synthesized"])
def test_cli_runs_stream_sources(capsys, source):
    """``python -m mpisppy_tpu_torch uc --scenario-source ...`` on the
    CPU: the hub-only chunked wheel, with finite bounds."""
    from mpisppy_tpu_torch.__main__ import main
    assert main(["uc", "--num-scens", "6", "--model-kwargs",
                 json.dumps(UC_KW), "--scenario-source", source,
                 "--subproblem-chunk", "2", "--default-rho", "50",
                 "--max-iterations", "3", "--convthresh", "-1",
                 "--subproblem-max-iter", "1500", "--device",
                 "cpu"]) == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert np.isfinite(result["outer_bound"])


_STREAMED = ["farmer", "--scenario-source", "streamed",
             "--subproblem-chunk", "2", "--device", "cpu"]


@pytest.mark.parametrize("argv,item", [
    (_STREAMED + ["--telemetry-dir", "t"], "A13"),
    (_STREAMED + ["--checkpoint-dir", "c"], "A14"),
    (_STREAMED + ["--resume-from", "c"], "A14"),
    (["serve", "--scenario-source", "streamed"], "A15")])
def test_cli_refuses_what_streaming_still_lacks(argv, item):
    """Streaming's analyze section (A13), a streamed wheel's checkpoint
    and resume (A14) and streamed serve tenants (A15) refuse, naming
    their items."""
    from mpisppy_tpu_torch.__main__ import main
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md {item}"):
        main(argv)
