"""The port's APH φ-dispatch (mpisppy_tpu_torch.ops.dispatch and the
dispatch-masked chunked pass of core/ph.py) against the JAX package's:
the single-device cases of tests/test_dispatch.py run on the port, and
the selection held bit for bit against the JAX function.

The JAX package's dispatch cases run on a shared-structure farmer built
by its streaming synthesizer; the port's run on the shared-structure
UC, 3 generators x 6 hours, through the hand-written block's path (its
plain version on the CPU), with the bands of the JAX cases, and, since
the port has the synthesizer (mpisppy_tpu_torch/stream), the JAX cases
also run as they are on the port's farmer synth family (the same
batch bit for bit, tests/test_torch_stream_prng.py)."""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpisppy_tpu.core.aph import APH as JaxAPH
from mpisppy_tpu.ops.dispatch import dispatch_gate as jax_dispatch_gate
from mpisppy_tpu.ops.dispatch import dispatch_select as jax_dispatch_select
from mpisppy_tpu.ops.dispatch import scalar_gate as jax_scalar_gate
from mpisppy_tpu_torch import obs
from mpisppy_tpu_torch.core.aph import APH
from mpisppy_tpu_torch.core.ph import PH
from mpisppy_tpu_torch.ir.batch import build_batch
from mpisppy_tpu_torch.models import farmer, uc
from mpisppy_tpu_torch.ops.dispatch import (GATE_HEAD, dispatch_gate,
                                            dispatch_select, gather_rows,
                                            scalar_gate, scatter_rows)

from torch_threads import one_torch_thread  # noqa: F401

_UC_KW = {"num_gens": 3, "num_hours": 6}
# the slice's block options at this size (tests/test_torch_ph.py)
_BLOCK = {"defaultPHrho": 100.0, "convthresh": -1.0,
          "subproblem_kernel_mode": "fused",
          "subproblem_kernel_backend": "pallas",
          "subproblem_max_iter": 400, "subproblem_polish_hot": False,
          "subproblem_polish_chunk": 2}


def _uc(S):
    return build_batch(uc.scenario_creator, uc.make_tree(S),
                       creator_kwargs=_UC_KW,
                       vector_patch=uc.scenario_vector_patch)


@pytest.fixture
def mem_obs():
    rec = obs.configure()
    yield rec
    obs.shutdown()


# ---------------- selection parity ----------------

def _host_mask(cls, phis, last_dispatch, scnt, S_real, S):
    """A package's APH._dispatch_mask on a bare namespace: the JAX
    package's is its numpy host reference, the port's goes through
    dispatch_select."""
    ns = SimpleNamespace(batch=SimpleNamespace(S=S), _S_orig=S_real,
                         phis=phis, _last_dispatch=last_dispatch,
                         device=torch.device("cpu"))
    # frac chosen so ceil(S_real * frac) == scnt exactly
    return cls._dispatch_mask(ns, 0, (scnt - 0.5) / S_real)


def test_dispatch_select_bit_equal_to_jax_and_host_reference():
    """The port's selection equals the JAX function, the JAX package's
    numpy host reference and the port's host-side mask bit for bit on
    320 seeded cases with ties (quantized φ, repeated last-dispatch
    iterations) and pad rows (S_real < S)."""
    rng = np.random.default_rng(0)
    cases = 0
    for S, S_real in [(8, 8), (8, 6), (12, 12), (12, 9), (16, 13)]:
        for scnt in sorted({1, 2, S_real // 2, S_real - 1}):
            if not 0 < scnt < S_real:
                continue
            for _ in range(16):
                phis = rng.integers(-3, 4, S).astype(np.float64) / 4.0
                phis[S_real:] = 0.0   # pad rows: probability 0, φ 0
                last = rng.integers(0, 4, S).astype(np.int64)
                want = np.asarray(jax_dispatch_select(
                    jnp.asarray(phis), jnp.asarray(last), scnt=scnt,
                    S_real=S_real))
                got = dispatch_select(torch.as_tensor(phis),
                                      torch.as_tensor(last), scnt,
                                      S_real).numpy()
                assert got.tolist() == want.tolist(), \
                    (S, S_real, scnt, phis.tolist(), last.tolist())
                for cls in (APH, JaxAPH):
                    host = _host_mask(cls, phis, last, scnt, S_real, S)
                    assert host.tolist() == got.tolist()
                assert not got[S_real:].any() and got.sum() == scnt
                cases += 1
    assert cases >= 200


def test_gate_packing_layout():
    """dispatch_gate == [τ, φ, θ, conv, φ stats] ++ mask, scalar_gate is
    its head, and both equal the JAX package's rows."""
    phis = np.array([-2.0, 0.5, -1.0, 3.0, 0.0, 0.0])
    last = np.array([5, 1, 2, 3, 0, 0])
    g = dispatch_gate(1.5, -0.25, 0.75, 2.0, torch.as_tensor(phis),
                      torch.as_tensor(last), 2, 4).numpy()
    assert g.shape == (GATE_HEAD + 6,)
    tau, phi, theta, conv, pmin, pmax, pneg = g[:GATE_HEAD].tolist()
    assert (tau, phi, theta, conv) == (1.5, -0.25, 0.75, 2.0)
    assert (pmin, pmax, int(pneg)) == (-2.0, 3.0, 2)
    want = dispatch_select(torch.as_tensor(phis), torch.as_tensor(last),
                           2, 4).numpy()
    assert ((g[GATE_HEAD:] != 0) == want).all()
    s = scalar_gate(1.5, -0.25, 0.75, 2.0, torch.as_tensor(phis),
                    4).numpy()
    assert s.tolist() == g[:GATE_HEAD].tolist()
    jg = np.asarray(jax_dispatch_gate(1.5, -0.25, 0.75, 2.0,
                                      jnp.asarray(phis), jnp.asarray(last),
                                      scnt=2, S_real=4))
    assert g.tolist() == jg.tolist()
    js = np.asarray(jax_scalar_gate(1.5, -0.25, 0.75, 2.0,
                                    jnp.asarray(phis), S_real=4))
    assert s.tolist() == js.tolist()


def test_gather_scatter_rows_with_duplicate_pads():
    """The chunk-pad convention: ids repeat the last one, the repeated
    rows carry equal values, and the scatter writes exactly them."""
    rng = np.random.default_rng(3)
    full = torch.as_tensor(rng.normal(size=(7, 4)))
    idx = torch.as_tensor([1, 4, 6, 6, 6])
    rows = gather_rows(full, idx)
    assert torch.equal(rows, full[idx])
    new = rows * 2.0
    out = scatter_rows(full, idx, new)
    assert torch.equal(out[idx], new)
    keep = [0, 2, 3, 5]
    assert torch.equal(out[keep], full[keep])
    assert not torch.equal(out, full)    # a new tensor; full unchanged
    assert torch.equal(full, torch.as_tensor(
        np.random.default_rng(3).normal(size=(7, 4))))


# ---------------- the dispatch-masked chunked pass ----------------

def _settled_ph(S=6, chunk=2, iters=2):
    ph = PH(_uc(S), {**_BLOCK, "PHIterLimit": iters,
                     "subproblem_chunk": chunk}, device="cpu")
    ph.ph_main(finalize=False)
    return ph


def test_solve_loop_dispatch_full_ids_equivalent():
    """solve_loop(dispatch=arange(S)) reproduces the plain chunked pass
    to the JAX case's bands (x rtol 1e-4 / atol 1e-3, the expected
    objective 1e-5). Not bit-equal: the row store carries ONE
    (L, rho_scale), the last chunk's."""
    ph_a, ph_b = _settled_ph(), _settled_ph()
    assert torch.equal(ph_a.x, ph_b.x)
    ph_a.solve_loop(w_on=True, prox_on=True, update=False)
    ph_b.solve_loop(w_on=True, prox_on=True, update=False,
                    dispatch=np.arange(ph_b.batch.S))
    np.testing.assert_allclose(ph_b.x.numpy(), ph_a.x.numpy(),
                               rtol=1e-4, atol=1e-3)
    assert ph_b.Eobjective_value() == \
        pytest.approx(ph_a.Eobjective_value(), rel=1e-5)
    # the store serves the state consumers at full width
    assert ph_b._qp_states[True].x.shape[0] == ph_b.batch.S
    assert ph_b.residual_summary(True)["pri_rel_max"] >= 0


def test_solve_loop_dispatch_partial_touches_only_dispatched():
    ph = _settled_ph()
    x0 = ph.x.clone()
    objs0 = ph._last_base_obj.clone()
    ph.solve_loop(w_on=True, prox_on=True, update=False,
                  dispatch=np.array([1, 4]))
    for s in (0, 2, 3, 5):
        assert torch.equal(ph.x[s], x0[s])
        assert torch.equal(ph._last_base_obj[s], objs0[s])
    assert not torch.equal(ph.x[1], x0[1])


def test_solve_loop_dispatch_validation():
    ph = _settled_ph()
    with pytest.raises(ValueError):
        ph.solve_loop(w_on=True, prox_on=True, update=True,
                      dispatch=np.array([0]))
    with pytest.raises(ValueError):
        ph.solve_loop(w_on=True, prox_on=True, update=False,
                      dispatch=np.array([], dtype=np.int64))
    ph_nochunk = PH(build_batch(farmer.scenario_creator,
                                farmer.make_tree(3)),
                    {"defaultPHrho": 1.0, "PHIterLimit": 1}, device="cpu")
    ph_nochunk.ph_main(finalize=False)
    with pytest.raises(ValueError):
        ph_nochunk.solve_loop(w_on=True, prox_on=True, update=False,
                              dispatch=np.array([0]))


def test_full_width_pass_drops_the_dispatch_store():
    ph = _settled_ph()
    ph.solve_loop(w_on=True, prox_on=True, update=False,
                  dispatch=np.array([0, 3, 5]))
    assert True in ph._dispatch_stores
    ph.solve_loop(w_on=True, prox_on=True, update=False)
    assert True not in ph._dispatch_stores
    assert ph._qp_states[True].x.shape[0] == ph.batch.S


# ---------------- frac=1.0 bit-equality + determinism ----------------

def _farmer_aph(iters=5, **opt):
    o = {"defaultPHrho": 1.0, "PHIterLimit": iters, "convthresh": -1.0,
         "subproblem_max_iter": 3000, "subproblem_eps": 1e-8}
    o.update(opt)
    return APH(build_batch(farmer.scenario_creator, farmer.make_tree(3)),
               o, device="cpu")


def test_full_dispatch_bit_equal_to_default():
    """frac 1.0 ships the scalar gate only: the trajectory is bit-equal
    to an APH built without the option, and deterministic."""
    runs = []
    for opt in ({}, {"dispatch_frac": 1.0}, {"dispatch_frac": 1.0}):
        aph = _farmer_aph(**opt)
        aph.APH_main(finalize=False)
        runs.append(aph)
    for aph in runs[1:]:
        assert torch.equal(runs[0].x, aph.x)
        assert torch.equal(runs[0].W, aph.W)
        assert torch.equal(runs[0].z, aph.z)
        assert runs[0].tau == aph.tau and runs[0].phi == aph.phi
        assert runs[0].conv == aph.conv


# ---------------- solve savings ----------------

def _uc_aph(S, iters, **opt):
    return APH(_uc(S), {**_BLOCK, "PHIterLimit": iters,
                        "subproblem_chunk": 2, **opt}, device="cpu")


def test_frac02_solve_count_quarter_of_full_at_same_gap(mem_obs):
    """At dispatch_frac 0.2 the counted scenario solves are <= 0.25x
    full dispatch (S at iter 1, then ceil(0.2 S) per iteration:
    genuinely skipped, not masked), and both runs land in one objective
    neighbourhood (5 %). The block runs the slice's budget of 1500
    fixed-rho steps per solve: at 400 the loose solves leave the two
    trajectories 6.8 % apart after 21 iterations."""
    iters, S = 21, 10
    c0 = obs.counters_snapshot()
    full = _uc_aph(S, iters, subproblem_max_iter=1500)
    full.APH_main(finalize=False)
    c1 = obs.counters_snapshot()
    part = _uc_aph(S, iters, dispatch_frac=0.2, subproblem_max_iter=1500)
    part.APH_main(finalize=False)
    c2 = obs.counters_snapshot()

    def delta(a, b, k):
        return b.get(k, 0) - a.get(k, 0)

    solved_full = delta(c0, c1, "dispatch.solved_scenarios")
    solved_part = delta(c1, c2, "dispatch.solved_scenarios")
    assert solved_full == S * iters
    assert solved_part == S + 2 * (iters - 1)
    assert solved_part <= 0.25 * solved_full
    assert delta(c1, c2, "dispatch.skipped_scenarios") == \
        (S - 2) * (iters - 1)
    assert part._aph_status["solve_path"] == "chunked-skip"
    # one block call per partial pass: ceil(2 / 2) chunk
    assert delta(c1, c2, "aph.gate_syncs") == iters
    of, op = full.Eobjective_value(), part.Eobjective_value()
    assert abs(op - of) / abs(of) < 0.05


def test_compile_count_tracks_dispatch_bucket_transitions(mem_obs):
    """What a dispatch shape costs the port (torch compiles nothing per
    shape, so the JAX package's bucket registry has no counterpart): the
    dispatch row store (core/ph ``_dispatch_store``) is built once for
    a solve width, seeded from the full pass's chunk states, reused by
    every following partial pass (a changed chunk count included), and
    rebuilt when the width changes: after a compaction bucket
    transition the next partial pass builds it at the compacted width,
    and the pass after reuses it."""
    iters = 5
    aph = _uc_aph(8, iters, dispatch_frac=0.5, shrink_fix=True,
                  shrink_compact=True, shrink_buckets="0.02",
                  id_fix_list_fct=lambda b: {
                      "tol": np.full(b.K, 1e-4),
                      **{k: np.full(b.K, 2 ** 30) for k in
                         ("nb", "lb", "ub")}})
    builds = []
    orig = aph._dispatch_store

    def spy(key, factors, data, slices):
        before = aph._dispatch_stores.get(key)
        st = orig(key, factors, data, slices)
        if st is not before:
            builds.append((aph._iter, tuple(st.x.shape)))
        return st

    aph._dispatch_store = spy
    aph.APH_main(finalize=False)
    n = aph.batch.n
    # iter 1 dispatches everyone; iters 2..5 partial, one store build
    assert builds == [(2, (8, n))]
    assert aph.extensions.nfixed == 0 and aph._shrink is None
    aph.solve_loop(w_on=True, prox_on=True, update=False,
                   dispatch=np.arange(6))   # 3 chunks, not 2
    assert len(builds) == 1
    # a width change: pin slot 0 and compact; the transition's pass
    # dispatches everyone (as APH_main does), then two partial passes
    mask = torch.zeros_like(aph._fixed_mask)
    mask[:, 0] = True
    aph.fix_nonants(aph.xbar, mask=mask)
    assert aph.maybe_compact(1)
    aph.solve_loop(w_on=True, prox_on=True, update=False)
    aph.solve_loop(w_on=True, prox_on=True, update=False,
                   dispatch=np.arange(4))
    aph.solve_loop(w_on=True, prox_on=True, update=False,
                   dispatch=np.arange(4, 8))
    n_c = aph._shrink.n_c
    assert n_c < n and builds[1:] == [(iters, (8, n_c))]
    assert aph._dispatch_stores[True].x.shape == (8, n_c)


# ---------------- config + CLI plumbing ----------------

def test_dispatch_config_validation_and_cli():
    from mpisppy_tpu_torch.__main__ import config_from_args, make_parser
    from mpisppy_tpu_torch.utils.config import AlgoConfig, RunConfig
    for bad in (dict(dispatch_frac=0.0), dict(dispatch_frac=1.5),
                dict(dispatch_frac=-0.2), dict(aph_nu=0.0),
                dict(aph_gamma=-1.0)):
        with pytest.raises(ValueError):
            AlgoConfig(**bad).validate()
    # partial dispatch is φ-based: APH hub only
    with pytest.raises(ValueError):
        RunConfig(hub="ph", algo=AlgoConfig(dispatch_frac=0.5)).validate()
    RunConfig(hub="aph", algo=AlgoConfig(dispatch_frac=0.5)).validate()
    args = make_parser().parse_args(
        ["farmer", "--hub", "aph", "--dispatch-frac", "0.3",
         "--aph-nu", "2.0", "--aph-gamma", "0.5"])
    cfg = config_from_args(args)
    assert cfg.algo.dispatch_frac == 0.3
    assert cfg.algo.aph_nu == 2.0 and cfg.algo.aph_gamma == 0.5
    o = cfg.algo.to_options()
    assert o["dispatch_frac"] == 0.3
    assert o["APHnu"] == 2.0 and o["APHgamma"] == 0.5


# ---------------- the JAX cases on the farmer synth family ----------------

def _farmer_shared(S=6, seed=7):
    from mpisppy_tpu_torch.stream import synth_batch
    b, _ = synth_batch(farmer.scenario_creator, farmer.make_tree(S),
                       farmer.scenario_synth_spec, seed=seed)
    return b


def _settled_farmer(S=6, chunk=2, iters=2):
    ph = PH(_farmer_shared(S), {"defaultPHrho": 1.0, "PHIterLimit": iters,
                                "convthresh": -1.0,
                                "subproblem_chunk": chunk,
                                "subproblem_max_iter": 3000,
                                "subproblem_eps": 1e-8}, device="cpu")
    ph.ph_main(finalize=False)
    return ph


@pytest.mark.usefixtures("one_torch_thread")
def test_farmer_family_dispatch_full_ids_equivalent():
    """The JAX case as it is: solve_loop(dispatch=arange(S)) reproduces
    the plain chunked pass to solver tolerance (the row store's one
    rho_scale; the objective is the dual-invariant check)."""
    ph_a, ph_b = _settled_farmer(), _settled_farmer()
    assert torch.equal(ph_a.x, ph_b.x)
    ph_a.solve_loop(w_on=True, prox_on=True, update=False)
    ph_b.solve_loop(w_on=True, prox_on=True, update=False,
                    dispatch=np.arange(ph_b.batch.S))
    np.testing.assert_allclose(ph_b.x.numpy(), ph_a.x.numpy(),
                               rtol=1e-4, atol=1e-3)
    assert ph_b.Eobjective_value() == \
        pytest.approx(ph_a.Eobjective_value(), rel=1e-5)


@pytest.mark.usefixtures("one_torch_thread")
def test_farmer_family_dispatch_partial_touches_only_dispatched():
    ph = _settled_farmer()
    x0 = ph.x.clone()
    ph.solve_loop(w_on=True, prox_on=True, update=False,
                  dispatch=np.array([1, 4]))
    for s in (0, 2, 3, 5):
        assert torch.equal(ph.x[s], x0[s])


@pytest.mark.usefixtures("one_torch_thread")
def test_farmer_family_frac02_solve_count_quarter_of_full(mem_obs):
    """The JAX acceptance case on the farmer synth family (rho 10,
    chunks of 2, 21 iterations): at dispatch_frac 0.2 the counted
    scenario solves are <= 0.25x full dispatch, genuinely skipped, and
    both runs land in one objective neighbourhood (5 %)."""
    iters, S = 21, 10
    opts = {"defaultPHrho": 10.0, "PHIterLimit": iters,
            "convthresh": -1.0, "subproblem_max_iter": 3000,
            "subproblem_eps": 1e-8, "subproblem_chunk": 2}
    c0 = obs.counters_snapshot()
    full = APH(_farmer_shared(S), dict(opts), device="cpu")
    full.APH_main(finalize=False)
    c1 = obs.counters_snapshot()
    part = APH(_farmer_shared(S), dict(opts, dispatch_frac=0.2),
               device="cpu")
    part.APH_main(finalize=False)
    c2 = obs.counters_snapshot()

    def delta(a, b, k):
        return b.get(k, 0) - a.get(k, 0)

    solved_full = delta(c0, c1, "dispatch.solved_scenarios")
    solved_part = delta(c1, c2, "dispatch.solved_scenarios")
    assert solved_full == S * iters
    assert solved_part == S + 2 * (iters - 1)
    assert solved_part <= 0.25 * solved_full
    assert delta(c1, c2, "dispatch.skipped_scenarios") == \
        (S - 2) * (iters - 1)
    assert part._aph_status["solve_path"] == "chunked-skip"
    of, op = full.Eobjective_value(), part.Eobjective_value()
    assert abs(op - of) / abs(of) < 0.05



# ---------------- checkpoint resume (tests/test_dispatch.py:357, :406)

def _make_aph(num_scens=3, iters=5, **opt):
    """tests/test_dispatch.py's make_aph(shared=True) on the port: the
    farmer synth family (one shared A)."""
    options = {"defaultPHrho": 1.0, "PHIterLimit": iters,
               "convthresh": -1.0, "subproblem_max_iter": 3000,
               "subproblem_eps": 1e-8}
    options.update(opt)
    return APH(_farmer_shared(num_scens), options, device="cpu")


@pytest.mark.usefixtures("one_torch_thread")
def test_ckpt_aph_state_roundtrip_and_resume_determinism(tmp_path,
                                                         mem_obs):
    """The APH extras of a hub bundle round-trip bit-equal, and two
    engines resumed from one bundle walk identical trajectories (the
    same dispatch picks)."""
    from mpisppy_tpu_torch.ckpt.manager import resume_hub
    from mpisppy_tpu_torch.cylinders.hub import Hub
    from mpisppy_tpu_torch.utils.runtime import to_host
    d = str(tmp_path)
    opt = dict(num_scens=4, iters=4, dispatch_frac=0.5,
               subproblem_chunk=2)
    src = _make_aph(**opt)
    src.APH_main(finalize=False)
    hub = Hub(src, spokes=[], options={"checkpoint_dir": d,
                                       "checkpoint_fingerprint": "fp"})
    assert hub.ckpt.capture("test") is not None

    resumed = []
    for _ in range(2):
        aph = _make_aph(**opt)
        assert resume_hub(Hub(aph, spokes=[]), d,
                          fingerprint="fp") is not None
        resumed.append(aph)
    for aph in resumed:
        for name in ("z", "y_aph", "x", "phis"):
            np.testing.assert_array_equal(to_host(getattr(aph, name)),
                                          to_host(getattr(src, name)))
        assert aph._last_dispatch.tolist() == src._last_dispatch.tolist()
        assert aph._dispatched.tolist() == src._dispatched.tolist()
        assert aph._iter == src._iter
    for aph in resumed:
        aph.spcomm = None
        aph.APH_main(finalize=False)
    a, b = resumed
    for name in ("x", "W", "z", "phis"):
        np.testing.assert_array_equal(to_host(getattr(a, name)),
                                      to_host(getattr(b, name)))
    assert a._dispatched.tolist() == b._dispatched.tolist()


@pytest.mark.usefixtures("one_torch_thread")
def test_ckpt_pre_aph_bundle_cold_starts_projective_state(tmp_path,
                                                          mem_obs):
    """A PH-hub bundle resumed into an APH wheel: (W, x̄, ρ) install
    warm, the APH extras are absent, and the projective state stays
    cold — no crash, no rejection."""
    from mpisppy_tpu_torch.ckpt.manager import resume_hub
    from mpisppy_tpu_torch.cylinders.hub import Hub
    from mpisppy_tpu_torch.utils.runtime import to_host
    d = str(tmp_path)
    ph = PH(_farmer_shared(4), {"defaultPHrho": 1.0, "PHIterLimit": 3,
                                "convthresh": -1.0,
                                "subproblem_max_iter": 2000,
                                "subproblem_eps": 1e-7}, device="cpu")
    ph.ph_main(finalize=False)
    hub = Hub(ph, spokes=[], options={"checkpoint_dir": d})
    assert hub.ckpt.capture("test") is not None
    aph = _make_aph(num_scens=4)
    assert resume_hub(Hub(aph, spokes=[]), d) is not None
    np.testing.assert_allclose(to_host(aph.W), to_host(ph.W))
    assert float(np.abs(to_host(aph.z)).max()) == 0.0
    assert getattr(aph, "_warm_started", False)
