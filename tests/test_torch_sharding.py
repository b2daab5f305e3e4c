"""Scenario-axis sharding of the port's engines (PH, APH, compaction,
the wheel, the CLI and the twin of dryrun_multichip) on gloo CPU ranks,
against the JAX package's sharded runs on conftest's virtual CPU devices
and against the port's own unsharded run: the cases of
tests/test_sharding.py, tests/test_dispatch.py:238 and
tests/test_shrink.py:198 at their bars.

Bars: the JAX sharding tests' (x̄, W at 5e-3 and the trivial bound at
rel 1e-5 on farmer; hydro's value-level checks) wherever rho adapts.
With the fixed-rho block options the sharded run IS the unsharded run
up to the order of summation: x̄, W and conv at 1e-8, the trivial bound
at 2e-6 (the polish's reproducibility, ROADMAP.md C.1)."""

import json

import numpy as np
import pytest

from mpisppy_tpu.core.aph import APH as JaxAPH
from mpisppy_tpu.core.ph import PH as JaxPH
from mpisppy_tpu.core.ph import PHBase as JaxPHBase
from mpisppy_tpu.ir.batch import build_batch as jax_build_batch
from mpisppy_tpu.models import farmer as jax_farmer
from mpisppy_tpu.models import hydro as jax_hydro
from mpisppy_tpu.models import uc as jax_uc
from mpisppy_tpu.parallel.mesh import make_mesh as jax_make_mesh
from mpisppy_tpu_torch.parallel.launch import launch

import torch_mesh_ranks as ranks
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _opts(iters):
    return {"defaultPHrho": 1.0, "PHIterLimit": iters, "convthresh": 0.0,
            "subproblem_max_iter": 3000}


def _on(world, fn, spec):
    return launch(fn, world, (spec,), device="cpu")


def _same_on_every_rank(outs, keys=("xbar", "W", "conv")):
    for o in outs[1:]:
        for k in keys:
            assert np.array_equal(np.asarray(o[k]), np.asarray(outs[0][k]))


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_farmer_matches_jax_and_unsharded(world):
    """2-stage PH through the collective combine on 2 and 4 ranks tracks
    the unsharded port and the JAX package's sharded run (JAX
    tests/test_sharding.py:31)."""
    spec = {"model": "farmer", "S": 8, "opts": _opts(3)}
    outs = _on(world, ranks.ph_run, spec)
    _same_on_every_rank(outs)
    r = outs[0]
    assert r["pt"]["devices"] == world and r["pt"]["mode"] == "sharded"
    ref = ranks.ph_run(None, spec)
    jph = JaxPH(jax_build_batch(jax_farmer.scenario_creator,
                                jax_farmer.make_tree(8)), _opts(3),
                mesh=jax_make_mesh(world))
    jph.ph_main()
    for xbar, W, tb in ((ref["xbar"], ref["W"], ref["trivial_bound"]),
                        (np.asarray(jph.xbar), np.asarray(jph.W),
                         jph.trivial_bound)):
        np.testing.assert_allclose(r["xbar"], xbar, atol=5e-3)
        np.testing.assert_allclose(r["W"], W, atol=5e-3)
        assert r["trivial_bound"] == pytest.approx(tb, rel=1e-5)


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_hydro_multistage_matches(world):
    """Multistage nodes reduce across shard boundaries: hydro's 9
    scenarios pad to 10 (2 ranks) or 12 (4 ranks) with zero-probability
    copies; values held tight, coordinates loosely (the LP is
    degenerate), and the subgroup invariants exactly (JAX
    tests/test_sharding.py:51)."""
    opts = {"defaultPHrho": 1.0, "PHIterLimit": 3, "convthresh": 0.0,
            "subproblem_max_iter": 4000}
    spec = {"model": "hydro", "opts": opts}
    outs = _on(world, ranks.ph_run, spec)
    _same_on_every_rank(outs)
    r = outs[0]
    assert r["S"] == 9 + (-9) % world and r["S_orig"] == 9
    assert float(r["prob"][9:].sum()) == 0.0
    ref = ranks.ph_run(None, spec)
    jph = JaxPH(jax_build_batch(jax_hydro.scenario_creator,
                                jax_hydro.make_tree()), dict(opts),
                mesh=jax_make_mesh(world))
    _, jeobj, _ = jph.ph_main()
    for tb, eobj, xbar in ((ref["trivial_bound"], ref["eobj"], ref["xbar"]),
                           (jph.trivial_bound, jeobj,
                            np.asarray(jph.xbar)[:9])):
        assert r["trivial_bound"] == pytest.approx(tb, rel=1e-6)
        assert r["eobj"] == pytest.approx(eobj, rel=1e-3)
        np.testing.assert_allclose(r["xbar"][:9], xbar, atol=0.5)
    xb, W, p = r["xbar"][:9], r["W"][:9], r["prob"][:9]
    s2 = ranks.build("hydro").stage_slot_slices[1]
    for g in range(3):
        grp = xb[3 * g:3 * g + 3, s2]
        np.testing.assert_allclose(grp - grp[0], 0.0, atol=1e-9)
    B2 = jax_hydro.make_tree().membership(2)
    np.testing.assert_allclose((B2.T @ (p[:, None] * W))[:, s2], 0.0,
                               atol=1e-8)
    assert np.isfinite(r["residual_summary"]["pri_rel_max"])


def test_ragged_s10_on_4_ranks():
    """S = 10 on 4 ranks pads to 12 zero-probability rows and reproduces
    the unpadded trajectory (JAX tests/test_sharding.py:95)."""
    spec = {"model": "farmer", "S": 10, "opts": _opts(2)}
    r = _on(4, ranks.ph_run, spec)[0]
    assert r["S"] == 12 and r["S_orig"] == 10 and r["shard"] == 3
    assert abs(float(r["prob"].sum()) - 1.0) < 1e-12
    ref = ranks.ph_run(None, spec)
    np.testing.assert_allclose(r["xbar"][:10], ref["xbar"], atol=5e-3)


_UC = {"defaultPHrho": 50.0, "subproblem_max_iter": 6000,
       "subproblem_eps": 1e-8}


def _jax_uc(S, uc_kw):
    return jax_build_batch(jax_uc.scenario_creator, jax_uc.make_tree(S),
                           creator_kwargs=dict(uc_kw),
                           vector_patch=jax_uc.scenario_vector_patch)


def test_chunk_aware_padding_rounds_shard_to_local_chunk():
    """S = 10 on 4 ranks with a per-rank chunk of 2 pads to 16 (shard 4
    = two local chunks), and the sharded chunked consensus matches the
    unpadded run and the JAX package's (JAX
    tests/test_sharding.py:131)."""
    spec = {"model": "uc", "S": 10, "main": False, "iters": 2,
            "opts": dict(_UC, subproblem_chunk=2)}
    outs = _on(4, ranks.ph_run, spec)
    _same_on_every_rank(outs)
    r = outs[0]
    assert r["S"] == 16 and r["S_orig"] == 10
    assert r["pt"]["mode"] == "sharded" and r["pt"]["devices"] == 4
    ref = ranks.ph_run(None, dict(spec, opts=_UC))
    np.testing.assert_allclose(r["xbar"][:10], ref["xbar"], atol=5e-3)
    assert r["conv"] == pytest.approx(ref["conv"], abs=1e-4)
    jph = JaxPHBase(_jax_uc(10, ranks._UC_KW),
                    dict(_UC, subproblem_chunk=2), mesh=jax_make_mesh(4))
    for it in range(2):
        jph.solve_loop(w_on=it > 0, prox_on=it > 0)
        jph.W = jph.W_new
    np.testing.assert_allclose(r["xbar"], np.asarray(jph.xbar), atol=5e-3)
    assert r["conv"] == pytest.approx(float(jph.conv), abs=1e-4)


# the fixed-rho block options (the chip check's main path at this size):
# the whole budget at fixed rho in the block, whose CPU twin is its plain
# version, then the finisher
_BLOCK = {"defaultPHrho": 100.0, "PHIterLimit": 2, "convthresh": -1.0,
          "subproblem_kernel_mode": "fused",
          "subproblem_kernel_backend": "cuda",
          "subproblem_max_iter": 400, "subproblem_eps": 1e-5,
          "subproblem_eps_hot": 1e-4, "subproblem_eps_dua_hot": 1e-2,
          "subproblem_polish_hot": False, "subproblem_polish_chunk": 2}


def test_fixed_rho_block_run_equals_unsharded():
    """With the block's fixed-rho options the sharded run is the
    unsharded one up to the order of summation: x̄, W and conv at 1e-8,
    the trivial bound and Eobjective at 2e-6 (UC S = 10 on 2 ranks)."""
    spec = {"model": "uc", "S": 10, "opts": _BLOCK}
    outs = _on(2, ranks.ph_run, spec)
    _same_on_every_rank(outs)
    r = outs[0]
    ref = ranks.ph_run(None, spec)
    for k in ("xbar", "W"):
        scale = max(1.0, float(np.abs(ref[k]).max()))
        np.testing.assert_allclose(r[k], ref[k], rtol=0, atol=1e-8 * scale)
    assert r["conv"] == pytest.approx(ref["conv"], rel=1e-8, abs=1e-12)
    assert r["trivial_bound"] == pytest.approx(ref["trivial_bound"],
                                               rel=2e-6)
    assert r["eobj"] == pytest.approx(ref["eobj"], rel=2e-6)


@pytest.mark.parametrize("precision", ["native", "df32"])
def test_chunked_under_mesh_matches(precision):
    """The sharded chunked loop at small size (JAX
    tests/test_sharding.py:202 and :242, unmarked here): native on 4
    ranks (shard 4, chunks of 2) against the fused sharded step, the
    single-device chunked run and the JAX package's sharded chunked run
    on 4 devices; df32 on 2 ranks (shard 8, chunks of 4) against a
    single-device run over the permuted scenario order whose contiguous
    chunks are the mesh's strided ones, after 3 prox-on iterations at
    the JAX test's band for the third, and after the prox-off iteration
    against the JAX package's sharded df32 run on 2 devices."""
    if precision == "native":
        base = {"model": "uc", "S": 16, "main": False, "iters": 2,
                "opts": dict(_UC)}
        chunked = _on(4, ranks.ph_run,
                      dict(base, opts=dict(_UC, subproblem_chunk=2)))
        fused = _on(4, ranks.ph_run, base)[0]
        single = ranks.ph_run(None, dict(base, opts=dict(
            _UC, subproblem_chunk=8)))
        _same_on_every_rank(chunked)
        r = chunked[0]
        assert r["pt"]["mode"] == "sharded"
        jph = JaxPHBase(_jax_uc(16, ranks._UC_KW),
                        dict(_UC, subproblem_chunk=2), mesh=jax_make_mesh(4))
        for it in range(2):
            jph.solve_loop(w_on=it > 0, prox_on=it > 0)
            jph.W = jph.W_new
        assert jph.phase_timing(True)["mode"] == "sharded"
        jax_run = {"xbar": np.asarray(jph.xbar), "conv": float(jph.conv)}
        for o in (fused, single, jax_run):
            np.testing.assert_allclose(r["xbar"], o["xbar"], atol=5e-3)
            assert r["conv"] == pytest.approx(o["conv"], abs=1e-4)
        return
    opts = {"defaultPHrho": 100.0, "subproblem_precision": "df32",
            "subproblem_max_iter": 400, "subproblem_eps": 1e-5,
            "subproblem_eps_hot": 1e-4, "subproblem_eps_dua_hot": 1e-2,
            "subproblem_stall_rel": 1.5e-3, "subproblem_tail_iter": 150,
            "subproblem_segment": 150, "subproblem_segment_lo": 400,
            "subproblem_polish_hot": False, "subproblem_hospital": False}
    spec = {"model": "uc", "S": 16, "uc_kw": ranks.UC_FULL, "main": False,
            "iters": 4, "opts": dict(opts, subproblem_chunk=4)}
    outs = _on(2, ranks.ph_run, spec)
    _same_on_every_rank(outs)
    r = outs[0]
    assert r["pt"]["mode"] == "sharded" and r["pt"]["devices"] == 2
    perm = np.array([0, 1, 2, 3, 8, 9, 10, 11, 4, 5, 6, 7, 12, 13, 14, 15])
    single = ranks.ph_run(None, dict(spec, S=("perm", perm),
                                     opts=dict(opts, subproblem_chunk=8)))
    # the band of the JAX test's third prox-on iteration
    tol = 1e-2 * 3
    np.testing.assert_allclose(single["xbar"], r["xbar"][perm], atol=tol)
    np.testing.assert_allclose(single["W"], r["W"][perm], atol=200 * tol)
    assert r["conv"] == pytest.approx(single["conv"], abs=tol)
    # the JAX sharded df32 run solves the same strided chunks; held
    # after the prox-off iteration at the first band. Its prox-on
    # chunked iterates leave the port's, and its own unchunked run's,
    # from iteration 1 on (ROADMAP.md C.1), unsharded as much as here
    jph = JaxPHBase(_jax_uc(16, ranks.UC_FULL),
                    dict(opts, subproblem_chunk=4), mesh=jax_make_mesh(2))
    jph.solve_loop(w_on=False, prox_on=False)
    assert jph.phase_timing(False)["mode"] == "sharded"
    r0, tol = r["iter0"], 1e-2
    np.testing.assert_allclose(r0["xbar"], np.asarray(jph.xbar), atol=tol)
    np.testing.assert_allclose(r0["W"], np.asarray(jph.W_new),
                               atol=200 * tol)
    assert r0["conv"] == pytest.approx(float(jph.conv), abs=tol)


def test_sharded_hospital_cures_a_straggler_on_another_rank():
    """A chunked hydro run on 2 ranks (S = 9 padded to 12, shards of 6,
    chunks of 2): scenario 7 (rank 1's) comes back from iteration 1's
    chunk solve flagged unconverged with a zero row, and the chunk
    retries are blacklisted. Every rank sends it, and only it, to the
    hospital, which cures it below the gate, as the unsharded run does.
    Called again on the same planted row with the system in its shared
    (m, n) form and in the per-scenario (S, m, n) form, the hospital
    returns the same rescued rows bit for bit on the mesh (each rank
    ships its picks' A rows) and without one. The stage-2 nodes' x̄
    stays nonanticipative across the shard boundary."""
    spec = {"model": "hydro", "plant": 7,
            "opts": {"defaultPHrho": 1.0, "subproblem_max_iter": 4000,
                     "subproblem_chunk": 2}}
    outs = _on(2, ranks.hospital_run, spec)
    ref = ranks.hospital_run(None, spec)
    _same_on_every_rank(outs, keys=("xbar", "W"))
    assert outs[0]["S"] == 12 and ref["S"] == 9
    for o in outs + [ref]:
        (note,) = o["notes"]
        (treated,) = note["scenarios"]
        assert note["treated"] == 1 and treated["scenario"] == 7
        assert treated["pri_rel_before"] == 1.0
        assert treated["pri_rel_after"] < 1e-2
        for form in ("shared", "batched"):
            assert o[form]["syncs"] == 1
    for o in (outs[1], ref):
        for a, b in zip(o["shared"]["rows"], o["batched"]["rows"]):
            assert np.isfinite(a).all() and np.abs(a).max() > 0.0
            np.testing.assert_array_equal(a, b)
    assert outs[0]["shared"]["rows"] is None
    for form in ("shared", "batched"):
        glob = outs[0][form]["pri_glob"]
        np.testing.assert_array_equal(glob, outs[1][form]["pri_glob"])
        assert float(glob[1, 0, 1]) < 1e-2
    s2 = ranks.build("hydro").stage_slot_slices[1]
    xb = outs[0]["xbar"][:9]
    for g in range(3):
        grp = xb[3 * g:3 * g + 3, s2]
        np.testing.assert_allclose(grp - grp[0], 0.0, atol=1e-9)


@pytest.mark.parametrize("world", [2, 4])
def test_aph_on_mesh_one_gate_row_masked_accept(world):
    """APH over a mesh: one gate row per iteration, the GLOBAL φ ranked
    (every rank takes the same selection), pad rows never dispatched
    (S = 6 pads to 8 on 4 ranks) and the masked-accept solve path (JAX
    tests/test_dispatch.py:238)."""
    iters = 4
    spec = {"model": "farmer", "S": 6,
            "opts": {"defaultPHrho": 1.0, "PHIterLimit": iters,
                     "convthresh": -1.0, "subproblem_max_iter": 3000,
                     "subproblem_eps": 1e-8, "dispatch_frac": 0.5}}
    outs = _on(world, ranks.aph_run, spec)
    _same_on_every_rank(outs)
    for o in outs:
        assert o["gate_syncs"] == iters
        assert not o["capable"]
        assert [rec["dispatched"] for rec in o["recs"]] \
            == [rec["dispatched"] for rec in outs[0]["recs"]]
    r = outs[0]
    st = r["recs"][-1]["status"]
    assert st["scnt"] == 3 and st["dispatched"] == 3
    assert st["solve_path"] == "masked-accept"
    for rec in r["recs"]:
        assert not any(rec["dispatched"][r["S_orig"]:])
    ref = ranks.aph_run(None, spec)
    japh = JaxAPH(jax_build_batch(jax_farmer.scenario_creator,
                                  jax_farmer.make_tree(6)),
                  dict(spec["opts"]), mesh=jax_make_mesh(world))
    japh.APH_main(finalize=False)
    for xbar in (ref["xbar"], np.asarray(japh.xbar)[:6]):
        np.testing.assert_allclose(r["xbar"][:6], xbar, atol=5e-3)
    assert r["conv"] == pytest.approx(ref["conv"], rel=1e-3)


@pytest.mark.parametrize("world", [2, 4])
def test_compaction_on_mesh_matches_and_plans_agree(world):
    """Compaction under sharding: every rank builds the same plan (the
    checksum all-reduce holds), and the sharded compacted run tracks the
    unsharded one (JAX tests/test_shrink.py:198)."""
    opts = {"defaultPHrho": 5.0, "PHIterLimit": 20, "convthresh": 0.0,
            "subproblem_max_iter": 3000, "subproblem_eps": 1e-8,
            "shrink_fix": True, "shrink_compact": True,
            "shrink_buckets": "0.2", "id_fix_list_fct": ranks.slot0_fix_list}
    spec = {"model": "farmer", "S": 8, "opts": opts}
    outs = _on(world, ranks.shrink_run, spec)
    _same_on_every_rank(outs)
    ref = ranks.shrink_run(None, spec)
    r = outs[0]
    assert r["status"]["compactions"] == 1
    assert r["status"]["n_cols"] == ref["status"]["n_cols"]
    assert all(o["checksum"] == r["checksum"] for o in outs)
    assert r["checksum"] is not None
    np.testing.assert_allclose(r["xbar"], ref["xbar"], atol=5e-3)
    np.testing.assert_allclose(r["W"], ref["W"], atol=5e-2)
    assert r["trivial_bound"] == pytest.approx(ref["trivial_bound"],
                                               rel=1e-5)


def test_sharded_hub_wheel_stops_on_gap_with_every_rank_exited():
    """A PH hub sharded over 2 ranks with the Lagrangian and x̂ spokes on
    rank 0: the wheel stops on its gap, rank 0 returns the bounds and
    rank 1 (which ran only the hub loop) returns None; the launch
    returning at all means no rank was left in a collective."""
    cfg = {"model": "farmer", "num_scens": 3, "device": "cpu",
           "mesh_devices": 2, "rel_gap": 5e-2,
           "algo": {"default_rho": 10.0, "convthresh": -1.0,
                    "max_iterations": 200},
           "spokes": ["lagrangian", "xhatshuffle"]}
    outs = launch(ranks.wheel_run, 2, (cfg,), device="cpu")
    assert outs[1] is None
    ob, ib = outs[0]["outer_bound"], outs[0]["inner_bound"]
    assert np.isfinite(ob) and np.isfinite(ib) and ob <= ib + 1e-6
    assert (ib - ob) / abs(ib) <= 5e-2
    assert ob <= -108390.0 + 1.0 and ib >= -108390.0 - 1.0


def test_cli_mesh_devices_on_the_cpu(capsys):
    """``python -m mpisppy_tpu_torch farmer --mesh-devices 2 --device
    cpu`` starts two ranks and prints rank 0's result (the hub alone:
    its trivial bound, no incumbent); the process wheels refuse a mesh,
    naming A8b."""
    from mpisppy_tpu_torch.__main__ import main
    from mpisppy_tpu_torch.utils.config import RunConfig
    from mpisppy_tpu_torch.utils.multiproc import spin_the_wheel_processes
    assert main(["farmer", "--mesh-devices", "2", "--device", "cpu",
                 "--max-iterations", "5"]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert np.isfinite(res["outer_bound"])
    assert res["outer_bound"] <= -108390.0 + 1.0
    assert res["inner_bound"] is None
    with pytest.raises(NotImplementedError, match="ROADMAP.md A8b"):
        spin_the_wheel_processes(RunConfig(model="farmer", device="cpu",
                                           mesh_devices=2))


def test_dryrun_multichip_twin_on_2_ranks():
    """The twin of __graft_entry__.dryrun_multichip: the chunked df32 PH
    step (chunk 1 per rank, 2 shards of 2) and the integer dive on 2
    gloo ranks."""
    from mpisppy_tpu_torch.entry import dryrun_multichip
    r = dryrun_multichip(2, device="cpu")
    assert r["mode"] == "sharded" and r["devices"] == 2
    assert r["S"] == 4 and r["shard"] == 2 and r["backend"] == "gloo"
    assert np.isfinite(r["conv"])
    assert r["cands_shape"][0] == 4 and 0 <= r["dive_feasible"] <= 4
