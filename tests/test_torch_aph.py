"""The port's APH engine (mpisppy_tpu_torch.core.aph) against the JAX
package's: the cases of tests/test_aph.py on the port, and parity on
the same batches, from the same seeds, in f64 on the CPU.

Tolerances: the fused update at 1e-12 (the same elementwise arithmetic
in another order of summation); whole runs at 1e-8 relative to
max(1, |reference|). A run's iterates are held only as far as its
subproblem solves are converged, so the parity runs solve to 1e-13
(farmer) and 1e-9 (UC) on the segmented solver."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpisppy_tpu import obs as jax_obs
from mpisppy_tpu.core.aph import APH as JaxAPH
from mpisppy_tpu.core.aph import _aph_update as jax_aph_update
from mpisppy_tpu.ir.batch import build_batch as jax_build_batch
from mpisppy_tpu.models import farmer as jax_farmer
from mpisppy_tpu.models import uc as jax_uc
from mpisppy_tpu_torch import obs
from mpisppy_tpu_torch.core.aph import APH, _aph_update
from mpisppy_tpu_torch.ir.batch import build_batch
from mpisppy_tpu_torch.models import farmer, uc
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

EF3 = -108390.0
_UC_KW = {"num_gens": 3, "num_hours": 6}


def make_aph(num_scens=3, iters=20, **opt):
    batch = build_batch(farmer.scenario_creator, farmer.make_tree(num_scens))
    options = {"defaultPHrho": 1.0, "PHIterLimit": iters, "convthresh": -1.0,
               "subproblem_max_iter": 3000, "subproblem_eps": 1e-8}
    options.update(opt)
    return APH(batch, options, device="cpu")


def _host(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _rel_close(ref, got, tol):
    ref, got = np.asarray(ref, dtype=np.float64), _host(got)
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * scale)


# ---------------- the cases of tests/test_aph.py ----------------

def test_aph_trivial_bound_is_outer():
    aph = make_aph(iters=2)
    conv, eobj, trivial = aph.APH_main()
    assert trivial <= EF3 + 1.0
    assert np.isfinite(conv)


def test_aph_step_invariants():
    aph = make_aph(iters=8, APHnu=1.0, APHgamma=1.0)
    aph.APH_main(finalize=False)
    assert aph.tau >= 0
    if aph.theta != 0:
        assert aph.phi > 0
    # z sits in the nonanticipative subspace: rows equal at the root
    z = aph.z.numpy()
    assert np.allclose(z, z[0][None, :], atol=1e-8)


def test_aph_converges_near_ef():
    aph = make_aph(iters=60, defaultPHrho=10.0)
    conv, eobj, trivial = aph.APH_main()
    val = aph.calculate_incumbent(aph.xbar.numpy()[0])
    assert val is not None
    assert abs(val - EF3) / abs(EF3) < 0.01
    assert trivial <= EF3 + 1.0


def test_aph_partial_dispatch_preserves_undispatched():
    aph = make_aph(iters=1)
    aph.APH_main(finalize=False)          # iter 1 dispatches everyone
    x_before = aph.x.clone()
    aph._iter = 2
    aph.phis = np.array([-1.0, 5.0, 5.0])  # only scenario 0 is negative
    mask = aph._dispatch_mask(2, 1.0 / 3.0)
    assert mask.tolist() == [True, False, False]
    aph._aph_solve(mask)
    assert torch.equal(aph.x[1], x_before[1])
    assert torch.equal(aph.x[2], x_before[2])
    assert aph._last_dispatch.tolist() == [2, 1, 1]


def test_aph_dispatch_tiebreak_least_recent():
    aph = make_aph(num_scens=6, iters=1)
    aph.APH_main(finalize=False)
    aph.phis = np.zeros(6)                 # nobody negative
    aph._last_dispatch = np.array([3, 1, 2, 5, 4, 1])
    mask = aph._dispatch_mask(6, 0.5)      # scnt = 3
    assert mask.tolist() == [False, True, True, False, False, True]


def test_aph_use_lag_runs():
    aph = make_aph(iters=10, aph_use_lag=True, dispatch_frac=0.5,
                   defaultPHrho=5.0)
    conv, eobj, trivial = aph.APH_main()
    assert np.isfinite(conv)
    assert trivial <= EF3 + 1.0


def test_aph_with_hub_spokes():
    """APH as hub with the Lagrangian and x̂ spokes: the bounds sandwich
    the EF optimum."""
    from mpisppy_tpu_torch.core.ph import PHBase
    from mpisppy_tpu_torch.cylinders.hub import APHHub
    from mpisppy_tpu_torch.cylinders.lagrangian_bounder import \
        LagrangianOuterBound
    from mpisppy_tpu_torch.cylinders.xhat_bounders import \
        XhatShuffleInnerBound
    from mpisppy_tpu_torch.utils.sputils import spin_the_wheel

    batch = build_batch(farmer.scenario_creator, farmer.make_tree(3))
    o = {"defaultPHrho": 10.0, "PHIterLimit": 40, "convthresh": -1.0,
         "subproblem_max_iter": 3000}
    wheel = spin_the_wheel(
        {"hub_class": APHHub, "hub_kwargs": {"options": {"rel_gap": 5e-3}},
         "opt_class": APH, "opt_kwargs": {"batch": batch, "options": o,
                                          "device": "cpu"}},
        [{"spoke_class": LagrangianOuterBound, "opt_class": PHBase,
          "opt_kwargs": {"batch": batch, "options": dict(o),
                         "device": "cpu"}},
         {"spoke_class": XhatShuffleInnerBound, "opt_class": PHBase,
          "opt_kwargs": {"batch": batch, "options": dict(o),
                         "device": "cpu"}}])
    assert wheel.best_outer_bound <= EF3 + 1.0
    assert wheel.best_inner_bound >= EF3 - 1.0
    assert np.isfinite(wheel.best_outer_bound)
    assert np.isfinite(wheel.best_inner_bound)


# ---------------- parity with the JAX package ----------------

def test_aph_update_matches_jax():
    """The fused projective update on seeded inputs, both iter-1 and
    later forms, at 1e-12."""
    rng = np.random.default_rng(11)
    S, K = 7, 5
    xn, W, y, z, xbar, ybar = (rng.normal(size=(S, K)) for _ in range(6))
    rho = np.abs(rng.normal(size=(S, K))) + 0.5
    prob = rng.random(S)
    prob /= prob.sum()
    # W − y along z − x makes φ > 0, so the θ-step is live
    y = W - 0.5 * (z - xn)
    for iter1 in (True, False):
        ref = jax_aph_update(*(jnp.asarray(a) for a in
                               (xn, W, y, z, rho, prob, xbar, ybar)),
                             0.7, 1.3, iter1=iter1)
        got = _aph_update(*(torch.as_tensor(a) for a in
                            (xn, W, y, z, rho, prob, xbar, ybar)),
                          0.7, 1.3, iter1=iter1)
        for r, g in zip(ref, got):
            _rel_close(np.asarray(r), g, 1e-12)
    assert float(ref[4]) != 0.0     # θ was live in the compared draw


class _Trace:
    """Extension recording, per APH iteration, the projective scalars,
    the φ vector, the dispatch mask and whether undispatched rows of x
    kept their bits across the solve."""

    def __init__(self):
        self.rows = []
        self._x = None

    def miditer(self, a):
        self._x = a.x.clone() if isinstance(a.x, torch.Tensor) \
            else np.asarray(a.x).copy()
        self.rows.append({"tau": a.tau, "phi": a.phi, "theta": a.theta,
                          "conv": a.conv, "phis": _host(a.phis).copy()})

    def enditer(self, a):
        mask = np.asarray(a._dispatched)
        x1 = a.x
        if isinstance(x1, torch.Tensor):
            same = torch.equal(x1[~torch.as_tensor(mask)],
                               self._x[~torch.as_tensor(mask)])
        else:
            same = np.array_equal(np.asarray(x1)[~mask], self._x[~mask])
        self.rows[-1].update(mask=mask.copy(), undispatched_same=same,
                             path=a._aph_status["solve_path"])

    def __getattr__(self, name):
        return lambda a: None


def _hold_runs(jax_eng, port_eng, tj, tp, tol):
    assert len(tj.rows) == len(tp.rows) > 0
    for rj, rp in zip(tj.rows, tp.rows):
        assert rp["mask"].tolist() == rj["mask"].tolist()
        for k in ("tau", "phi", "theta", "conv"):
            assert abs(rp[k] - rj[k]) <= tol * max(1.0, abs(rj[k])), k
    for name in ("W", "z", "xbar", "x"):
        _rel_close(getattr(jax_eng, name), getattr(port_eng, name), tol)


def test_farmer_masked_accept_matches_jax():
    """8 APH iterations on farmer(3) at dispatch_frac 0.5 (per-scenario
    A: every scenario solves and only the dispatched rows are accepted):
    the masks equal the JAX package's every iteration, and W, z, x̄, τ,
    φ, θ and conv match at 1e-8."""
    o = {"defaultPHrho": 10.0, "PHIterLimit": 8, "convthresh": -1.0,
         "subproblem_max_iter": 50000, "subproblem_eps": 1e-13,
         "dispatch_frac": 0.5}
    tj, tp = _Trace(), _Trace()
    j = JaxAPH(jax_build_batch(jax_farmer.scenario_creator,
                               jax_farmer.make_tree(3)), dict(o),
               dtype=jnp.float64, extensions=tj)
    j.APH_main(finalize=False)
    p = APH(build_batch(farmer.scenario_creator, farmer.make_tree(3)),
            dict(o), device="cpu", extensions=tp)
    p.APH_main(finalize=False)
    _hold_runs(j, p, tj, tp, 1e-8)
    assert {r["path"] for r in tp.rows[1:]} == {"masked-accept"}
    assert all(r["undispatched_same"] for r in tp.rows)


def _phi_margin(phis, scnt):
    """How far the φ vector sits from a different selection: the
    smallest |φ_s| (the sign decides the pool) and, when the negative
    pool is cut, the gap at the cut."""
    m = float(np.abs(phis).min())
    neg = np.sort(phis[phis < 0])
    if neg.size > scnt:
        m = min(m, float(neg[scnt] - neg[scnt - 1]))
    return m


def test_uc_chunked_skip_matches_jax():
    """5 APH iterations on a shared-A UC (S = 6, chunks of 2, f = 1/3)
    on the chunked-skip path: identical masks every iteration (with the
    φ margin at each cut above 100x the drift bar, so the equality is a
    claim), x/W/z at 1e-8, undispatched rows of x bit-unchanged across
    every partial pass, and the dispatch counters equal the JAX
    package's. Both packages run the segmented solver: the JAX chunked
    loop's block path transplants unscaled solutions into the first
    prox-on chunk states (ROADMAP.md C.2) and retries them, which
    forks its trajectory from the port's."""
    o = {"defaultPHrho": 50.0, "PHIterLimit": 5, "convthresh": -1.0,
         "subproblem_max_iter": 3000, "subproblem_eps": 1e-9,
         "subproblem_chunk": 2, "dispatch_frac": 1.0 / 3.0}
    tol = 1e-8
    tj, tp = _Trace(), _Trace()
    j = JaxAPH(jax_build_batch(jax_uc.scenario_creator, jax_uc.make_tree(6),
                               creator_kwargs=_UC_KW,
                               vector_patch=jax_uc.scenario_vector_patch),
               dict(o), dtype=jnp.float64, extensions=tj)
    jax_obs.configure(out_dir=None)
    try:
        j.APH_main(finalize=False)
        cj = jax_obs.counters_snapshot()
    finally:
        jax_obs.shutdown()
    p = APH(build_batch(uc.scenario_creator, uc.make_tree(6),
                        creator_kwargs=_UC_KW,
                        vector_patch=uc.scenario_vector_patch),
            dict(o), device="cpu", extensions=tp)
    obs.configure()
    try:
        p.APH_main(finalize=False)
        cp = obs.counters_snapshot()
    finally:
        obs.shutdown()
    _hold_runs(j, p, tj, tp, tol)
    for r in tj.rows[1:]:
        scale = max(1.0, float(np.abs(r["phis"]).max()))
        assert _phi_margin(r["phis"], 2) > 100 * tol * scale
    assert [r["path"] for r in tp.rows] == ["full"] + ["chunked-skip"] * 4
    assert all(r["undispatched_same"] for r in tp.rows)
    for k in ("aph.gate_syncs", "dispatch.solved_scenarios",
              "dispatch.skipped_scenarios"):
        assert cp.get(k, 0) == cj.get(k, 0), k
    assert cp["dispatch.solved_scenarios"] == 6 + 2 * 4


def test_state_arrays_roundtrip():
    """aph_state_arrays / install_aph_state restore the projective state
    and the dispatch bookkeeping bit for bit."""
    src = make_aph(num_scens=4, iters=3, dispatch_frac=0.5)
    src.APH_main(finalize=False)
    arrs = src.aph_state_arrays()
    dst = make_aph(num_scens=4, iters=3, dispatch_frac=0.5)
    dst.install_aph_state(arrs)
    for name in ("z", "y_aph", "x", "phis"):
        assert np.array_equal(_host(getattr(dst, name)),
                              _host(getattr(src, name)))
    assert dst._last_dispatch.tolist() == src._last_dispatch.tolist()
    assert dst._dispatched.tolist() == src._dispatched.tolist()

