"""The port's shrinking ops and device extensions (mpisppy_tpu_torch
ops/shrink.py, extensions DeviceFixer and DeviceNormRhoUpdater) against
the JAX package's on the same inputs, on the CPU.

The ops take the same seeded numpy inputs in both packages: the fixer
pass and the per-slot rho update at 1e-12, the compaction plan's kept
rows and columns bit for bit and its compacted data at 1e-12, on the
shared-A UC and the batched-A farmer. The extensions run inside PH on UC
3 x 6 with the slice's fixed-rho block options (where the two packages'
PH runs agree to 1e-8, tests/test_torch_ph.py): the device fixer's
masks equal the JAX DeviceFixer's and the port's host Fixer's bit for
bit, its values at 1e-9. The remaining cases are tests/test_shrink.py's
on the port: the integer-only default on farmer, the bounded rho
history, the config validation and the CLI flags, the refusal of
compaction at mixed and df32 precision (ROADMAP.md A9b), the engines'
re-factorization count, the memoized failed target, the cross-bucket
transplant, APH under compaction (tests/test_dispatch.py) and the
CLI's shrink flags reaching the engine."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mpisppy_tpu.extensions as jax_ext
from mpisppy_tpu.core.ph import PH as JaxPH
from mpisppy_tpu.extensions.fixer import uniform_fix_list as jax_ufl
from mpisppy_tpu.ir.batch import build_batch as jax_build_batch
from mpisppy_tpu.models import farmer as jax_farmer
from mpisppy_tpu.models import uc as jax_uc
from mpisppy_tpu.ops import shrink as jax_shrink
from mpisppy_tpu.ops.qp_solver import QPData as JaxQPData
import mpisppy_tpu_torch.core.ph as ph_mod
import mpisppy_tpu_torch.extensions as ext
from mpisppy_tpu_torch import obs
from mpisppy_tpu_torch.core.aph import APH
from mpisppy_tpu_torch.core.ph import PH
from mpisppy_tpu_torch.extensions.fixer import uniform_fix_list
from mpisppy_tpu_torch.ir.batch import build_batch
from mpisppy_tpu_torch.models import farmer, uc
from mpisppy_tpu_torch.ops import shrink
from mpisppy_tpu_torch.ops.qp_solver import QPData, qp_cold_state
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

_UC_KW = {"num_gens": 3, "num_hours": 6}
# the slice's block options at this size (tests/test_torch_extensions.py)
_UC_OPTS = {"defaultPHrho": 100.0, "convthresh": -1.0,
            "subproblem_kernel_mode": "fused",
            "subproblem_kernel_backend": "pallas",
            "subproblem_max_iter": 400, "subproblem_polish_hot": False,
            "subproblem_polish_chunk": 2}
# fixes about half the nonant slots at iteration 2 on UC 3 x 6 and more
# later (19, 21, ..., 29 of 36 with these options)
_SPEC = dict(tol=1e-2, nb=2, lb=2, ub=2, integer_only=False)


def _j(a):
    return jnp.asarray(np.asarray(a))


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _close(ref, got, tol):
    ref = np.asarray(ref)
    got = got.cpu().numpy() if hasattr(got, "cpu") else np.asarray(got)
    scale = max(1.0, float(np.abs(ref).max())) if ref.size else 1.0
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * scale)


def _batches(model, S):
    if model == "uc":
        kw = dict(creator_kwargs=_UC_KW)
        return (jax_build_batch(jax_uc.scenario_creator,
                                jax_uc.make_tree(S),
                                vector_patch=jax_uc.scenario_vector_patch,
                                **kw),
                build_batch(uc.scenario_creator, uc.make_tree(S),
                            vector_patch=uc.scenario_vector_patch, **kw))
    return (jax_build_batch(jax_farmer.scenario_creator,
                            jax_farmer.make_tree(S)),
            build_batch(farmer.scenario_creator, farmer.make_tree(S)))


# ---------------- the ops against the JAX package's ----------------

def test_fixer_update_matches_jax():
    """Ten seeded passes of the fixer op in both packages: counters and
    masks equal bit for bit, values at 1e-12, every precedence branch
    (parked at lb, at ub, converged at the common value) and the
    integral snap exercised."""
    rng = np.random.default_rng(0)
    S, K = 5, 12
    slot_lb = np.zeros((S, K))
    slot_ub = np.full((S, K), 3.0)
    imask = rng.random(K) < 0.5
    tol = np.full(K, 0.1)
    nbc = rng.integers(1, 4, K)
    lbc = np.minimum(rng.integers(1, 4, K), 2 ** 30)
    ubc = rng.integers(1, 4, K)
    jst = [_j(np.zeros(K, np.int64))] * 3 + [
        _j(np.zeros((S, K), bool)), _j(np.zeros((S, K)))]
    pst = [_t(np.zeros(K, np.int64))] * 3 + [
        _t(np.zeros((S, K), bool)), _t(np.zeros((S, K)))]
    hits = set()
    for _ in range(10):
        base = rng.choice([0.0, 3.0, 1.3, 2.6], K)
        noise = rng.normal(size=(S, K)) * (rng.random(K) < 0.4) * 0.5
        xn = np.clip(base + noise, 0.0, 3.0)
        xbar = np.broadcast_to(xn.mean(axis=0), (S, K)).copy()
        xsqbar = np.broadcast_to((xn * xn).mean(axis=0), (S, K)).copy()
        args = (xbar, xsqbar, xn, slot_lb, slot_ub, tol)
        jo = jax_shrink.fixer_update(
            *jst, *[_j(a) for a in args], 1e-6, _j(nbc), _j(lbc),
            _j(ubc), _j(imask))
        po = shrink.fixer_update(
            *pst, *[_t(a) for a in args], 1e-6, _t(nbc), _t(lbc),
            _t(ubc), _t(imask))
        for k in range(4):
            np.testing.assert_array_equal(po[k].numpy(), np.asarray(jo[k]))
        _close(jo[4], po[4], 1e-12)
        assert int(po[5]) == int(jo[5])
        jst, pst = list(jo[:5]), list(po[:5])
        vals = po[4].numpy()[po[3].numpy()]
        hits |= {float(v) for v in np.unique(np.round(vals, 6))}
    assert int(pst[3][0].sum()) > 0 and {0.0, 3.0} <= hits


def test_per_slot_rho_update_matches_jax():
    """tests/test_shrink.py's unit case (primal-heavy slots scale up,
    dual-heavy down, balanced hold; rho uniform across scenarios; one
    packed stats row) in the port, and seeded inputs against the JAX op
    at 1e-12."""
    S, K = 4, 3
    rho = torch.full((S, K), 2.0, dtype=torch.float64)
    prob = torch.full((S,), 0.25, dtype=torch.float64)
    xbar = torch.zeros((S, K), dtype=torch.float64)
    prev = xbar.clone()
    prev[:, 1] -= 10.0
    xn = xbar.clone()
    xn[:, 0] += 8.0
    new_rho, stats = shrink.per_slot_rho_update(rho, prob, xn, xbar, prev,
                                                2.0, 3.0)
    r = new_rho.numpy()
    assert (r == r[:1]).all()
    assert r[0, 0] == pytest.approx(6.0)
    assert r[0, 1] == pytest.approx(2.0 / 3.0)
    assert r[0, 2] == pytest.approx(2.0)
    assert stats.shape == (3,) and float(stats[0]) == 1.0
    rng = np.random.default_rng(1)
    S, K = 6, 9
    for _ in range(5):
        rho = np.broadcast_to(rng.uniform(1, 5, K), (S, K)).copy()
        prob = rng.dirichlet(np.ones(S))
        xn, xbar, prev = (rng.normal(size=(S, K)) for _ in range(3))
        args = (rho, prob, xn, xbar, prev)
        jr, js = jax_shrink.per_slot_rho_update(*[_j(a) for a in args],
                                                1.5, 2.0)
        pr, ps = shrink.per_slot_rho_update(*[_t(a) for a in args], 1.5,
                                            2.0)
        _close(jr, pr, 1e-12)
        _close(js, ps, 1e-12)


def _half_fixed(jb, S, K, seed):
    rng = np.random.default_rng(seed)
    slot = rng.random(K) < 0.5
    slot[0], slot[-1] = True, False
    mask = np.broadcast_to(slot, (S, K)).copy()
    lb = np.asarray(jb.lb)[:, np.asarray(jb.nonant_idx)]
    ub = np.asarray(jb.ub)[:, np.asarray(jb.nonant_idx)]
    vals = np.where(np.isfinite(ub), lb + 0.5 * (ub - lb),
                    lb + rng.uniform(0, 50, (S, K)))
    return mask, vals


@pytest.mark.parametrize("model,S", [("uc", 4), ("farmer", 3)])
def test_build_plan_matches_jax(model, S):
    """build_plan on the same batch and fixed set (about half the slots):
    kept rows and columns equal bit for bit, the compacted A, l, u, lb,
    ub, P, c and c0_fold, the rhs shift and the folded values at 1e-12,
    on the shared 2-D A (UC) and the batched 3-D A (farmer); the dual
    fold and the expansion of a compacted block too."""
    jb, pb = _batches(model, S)
    K = pb.K
    mask, vals = _half_fixed(jb, S, K, 3)
    A = np.asarray(jb.A)
    P = np.asarray(jb.P_diag)
    if A.ndim == 2:
        P = P[0]
    arrs = (P, A, jb.l, jb.u, jb.lb, jb.ub)
    jd = JaxQPData(*[_j(a) for a in arrs])
    pd = QPData(*[_t(a) for a in arrs])
    jp = jax_shrink.build_plan(jd, _j(jb.c), _j(jb.c0), _j(jb.nonant_idx),
                               _j(mask), _j(vals), 0.25,
                               dtype=jnp.float64)
    pp = shrink.build_plan(pd, _t(pb.c), _t(pb.c0), _t(pb.nonant_idx),
                           _t(mask), _t(vals), 0.25, dtype=torch.float64)
    np.testing.assert_array_equal(pp.keep_rows_np, jp.keep_rows_np)
    np.testing.assert_array_equal(pp.keep_cols_np, jp.keep_cols_np)
    np.testing.assert_array_equal(pp.idx_c.numpy(), np.asarray(jp.idx_c))
    np.testing.assert_array_equal(pp.free_slots, jp.free_slots)
    assert (pp.n_c, pp.m_c) == (jp.n_c, jp.m_c)
    assert pp.n_c < pb.n and pp.m_c <= pb.m
    for f in QPData._fields:
        _close(getattr(jp.data_c, f), getattr(pp.data_c, f), 1e-12)
    for f in ("c_c", "c0_fold", "rhs_shift", "fixed_colvals"):
        _close(getattr(jp, f), getattr(pp, f), 1e-12)
    rng = np.random.default_rng(4)
    W, xbar, rho = (rng.normal(size=(S, K)) for _ in range(3))
    fs = pp.fixed_slots
    for w_on, prox_on in ((True, True), (True, False), (False, True),
                          (False, False)):
        jf = jax_shrink.dual_fold(jp.c0_fold, _j(vals[:, fs]),
                                  _j(W[:, fs]), _j(xbar[:, fs]),
                                  _j(rho[:, fs]), None, w_on=w_on,
                                  prox_on=prox_on)
        pf = shrink.dual_fold(pp.c0_fold, _t(vals[:, fs]), _t(W[:, fs]),
                              _t(xbar[:, fs]), _t(rho[:, fs]), None,
                              w_on=w_on, prox_on=prox_on)
        _close(jf, pf, 1e-12)
    x_c = rng.normal(size=(S, pp.n_c))
    je = jax_shrink.expand_solution(_j(x_c), jp.fixed_colvals,
                                    jp.keep_cols, jp.fixed_cols,
                                    jnp.zeros(pb.n))
    pe = shrink.expand_solution(_t(x_c), pp.fixed_colvals, pp.keep_cols,
                                pp.fixed_cols, pb.n)
    np.testing.assert_array_equal(pe.numpy(), np.asarray(je))


def test_transplant_rescale_matches_jax():
    """The cross-bucket rescale on seeded iterates and scalings (shared
    old factors, per-scenario new ones, one excluded row) at 1e-12."""
    rng = np.random.default_rng(5)
    S, n, m, nc, mc = 4, 9, 7, 6, 5
    pos_c = np.sort(rng.choice(n, nc, replace=False))
    pos_r = np.sort(rng.choice(m, mc, replace=False))
    it = [rng.normal(size=(S, k)) for k in (n, m, n, m, n)]
    pos = lambda k: rng.uniform(0.5, 2.0, k)          # noqa: E731
    scal = (pos(n), pos((S, nc)), pos(m), pos((S, mc)), pos(n),
            pos((S, nc)), pos(S), rng.normal(size=(1, m)),
            rng.normal(size=(S, mc)))
    ok = np.array([True, False, True, True])
    jo = jax_shrink._transplant_rescale(
        *[_j(a) for a in it], _j(pos_c), _j(pos_r),
        *[_j(a) for a in scal], _j(ok))
    po = shrink._transplant_rescale(
        *[_t(a) for a in it], _t(pos_c), _t(pos_r),
        *[_t(a) for a in scal], _t(ok))
    for a, b in zip(jo, po):
        _close(a, b, 1e-12)
    assert float(po[0][1].abs().max()) == 0.0


# ---------------- the device extensions ----------------

def _pair(iters, jax_exts, port_exts, S=4):
    opts = dict(_UC_OPTS, PHIterLimit=iters)
    jb, pb = _batches("uc", S)
    j = JaxPH(jb, dict(opts), dtype=jnp.float64,
              extensions=jax_ext.MultiExtension(jax_exts))
    j.ph_main()
    p = PH(pb, dict(opts), extensions=ext.MultiExtension(port_exts),
           device="cpu")
    p.ph_main()
    return j, p


class _Record(ext.Extension):
    """Records ``field(opt)`` at every miditer (the port's package)."""

    def __init__(self, field):
        super().__init__()
        self.field, self.rows = field, []

    def miditer(self, opt):
        self.rows.append(self.field(opt))


def test_device_fixer_matches_jax_and_host_fixer():
    """tests/test_shrink.py's device-vs-host parity, on both packages:
    on UC 4 x (3, 6) with the block options, the port's DeviceFixer
    makes the same decisions at the same iterations as the JAX
    DeviceFixer and as the port's host Fixer: masks equal bit for bit,
    values at 1e-9; the engines' Eobjective at 1e-8."""
    jf = jax_ext.DeviceFixer({"id_fix_list_fct": lambda b: jax_ufl(
        b, **_SPEC)})
    pf = ext.DeviceFixer({"id_fix_list_fct": lambda b: uniform_fix_list(
        b, **_SPEC)})
    rec = _Record(lambda o: pf.nfixed)
    j, p = _pair(6, [jf], [pf, rec])
    hf = ext.Fixer({"id_fix_list_fct": lambda b: uniform_fix_list(
        b, **_SPEC)})
    h = PH(_batches("uc", 4)[1], dict(_UC_OPTS, PHIterLimit=6),
           extensions=hf, device="cpu")
    h.ph_main()
    assert 0 < pf.nfixed < p.batch.K and rec.rows[0] == 0
    assert pf.nfixed == jf.nfixed == hf.nfixed
    m_p = p._fixed_mask.numpy()
    np.testing.assert_array_equal(m_p, np.asarray(j._fixed_mask))
    np.testing.assert_array_equal(m_p, hf.fixed_mask)
    _close(np.asarray(j._fixed_vals)[m_p], p._fixed_vals.numpy()[m_p],
           1e-9)
    _close(hf.fixed_vals[m_p], p._fixed_vals.numpy()[m_p], 1e-9)
    for name in ("_conv_count", "_lb_count", "_ub_count"):
        np.testing.assert_array_equal(getattr(pf, name).numpy(),
                                      np.asarray(getattr(jf, name)))
    assert p.Eobjective_value() == pytest.approx(j.Eobjective_value(),
                                                 rel=1e-8)
    pf.reset()
    assert pf.nfixed == 0 and not pf._init_done


def test_device_fixer_never_fixes_without_integer_slots():
    """The default spec on a continuous model (integer slots only) fixes
    nothing: the INT_NEVER sentinel holds."""
    opts = {"defaultPHrho": 5.0, "PHIterLimit": 6, "convthresh": 0.0,
            "subproblem_max_iter": 2000, "subproblem_eps": 1e-7,
            "shrink_fix": True, "shrink_fix_iters": 1,
            "shrink_fix_tol": 10.0}
    ph = PH(_batches("farmer", 3)[1], opts, device="cpu")
    ph.ph_main()
    assert isinstance(ph.extensions, ext.DeviceFixer)
    assert ph.extensions.nfixed == 0
    assert not bool(ph._fixed_mask.any())


def test_device_rho_updater_matches_jax():
    """The per-slot rho updater in both packages on UC with the block
    options: the rho trajectory at 1e-12 relative (rho uniform across
    scenarios, slots moving independently), the update count, and one
    re-factorization booked per applied update, every second iteration
    (``shrink_rho_interval`` 2)."""
    o = {"primal_dual_mult": 0.5, "rho_update_factor": 1.5,
         "shrink_rho_interval": 2}
    ju = jax_ext.DeviceNormRhoUpdater(dict(o))
    pu = ext.DeviceNormRhoUpdater(dict(o))
    rec = _Record(lambda o: pu.updates)
    j, p = _pair(7, [ju], [pu, rec])
    assert pu.updates == ju.updates > 0
    _close(j.rho, p.rho, 1e-12)
    rho = p.rho.numpy()
    assert (rho == rho[:1]).all()
    # an update rebuilds the prox-on factors at the next solve: every
    # update but one made in the last iteration
    assert rec.rows == [0, 1, 1, 2, 2, 3, 3]
    assert p.refactorizations == rec.rows[-2]
    np.testing.assert_allclose(list(pu.prim_hist), list(ju.prim_hist),
                               rtol=1e-8)
    assert len(pu.prim_hist) == 3      # iterations 2, 4 and 6


def test_device_rho_updater_runs_and_bounds_history():
    """tests/test_shrink.py's farmer case on the port: ``shrink_rho``
    attaches the updater, which moves slots independently with rho
    uniform across scenarios and keeps ``history_cap`` samples."""
    opts = {"defaultPHrho": 1.0, "PHIterLimit": 10, "convthresh": 0.0,
            "subproblem_max_iter": 2000, "subproblem_eps": 1e-7,
            "shrink_rho": True, "primal_dual_mult": 0.5,
            "rho_update_factor": 1.5, "history_cap": 4}
    ph = PH(_batches("farmer", 3)[1], opts, device="cpu")
    upd = ph.extensions
    rec = _Record(lambda o: upd.updates)
    ph.extensions = ext.MultiExtension([upd, rec])
    ph.ph_main()
    assert isinstance(upd, ext.DeviceNormRhoUpdater)
    assert upd.updates > 0
    rho = ph.rho.numpy()
    assert (rho == rho[:1]).all()
    assert len(set(np.round(rho[0], 9))) > 1
    assert len(upd.prim_hist) == 4 and len(upd.dual_hist) == 4
    assert ph.refactorizations == rec.rows[-2]
    upd.reset()
    assert upd.updates == 0 and not upd.prim_hist


# ---------------- construction, config and the CLI ----------------

@pytest.mark.parametrize("precision", ["mixed", "df32"])
def test_compaction_at_mixed_and_df32_precision_raises(precision):
    """shrink_compact with the split-f32 or mixed solve refuses at
    construction, naming ROADMAP.md A9b; the device fixer alone runs at
    every precision (it fixes through the pin boxes)."""
    pb = _batches("uc", 3)[1]
    o = {"subproblem_precision": precision, "shrink_fix": True}
    with pytest.raises(NotImplementedError, match="ROADMAP.md A9b"):
        PH(pb, dict(o, shrink_compact=True), device="cpu")
    ph = PH(pb, o, device="cpu")
    assert isinstance(ph.extensions, ext.DeviceFixer)
    with pytest.raises(ValueError, match="needs shrink_fix"):
        PH(pb, {"shrink_compact": True}, device="cpu")


def test_shrink_config_validation():
    from mpisppy_tpu_torch.utils.config import (AlgoConfig,
                                                parse_shrink_buckets)
    assert parse_shrink_buckets("0.25,0.5,0.75") == (0.25, 0.5, 0.75)
    assert parse_shrink_buckets((0.1,)) == (0.1,)
    for bad in ("0.5,0.25", "1.5", ""):
        with pytest.raises(ValueError):
            parse_shrink_buckets(bad)
    AlgoConfig(shrink_fix=True, shrink_compact=True).validate()
    for bad in (dict(shrink_compact=True), dict(shrink_fix_iters=0),
                dict(shrink_rho_interval=0),
                dict(shrink_fix=True, shrink_buckets="2.0",
                     shrink_compact=True)):
        with pytest.raises(ValueError):
            AlgoConfig(**bad).validate()


def test_shrink_cli_flags_reach_algo_config():
    from mpisppy_tpu_torch.__main__ import config_from_args, make_parser
    cfg = config_from_args(make_parser().parse_args(
        ["farmer", "--shrink-compact", "--shrink-buckets", "0.3,0.6",
         "--shrink-rho", "--shrink-rho-interval", "2"]))
    cfg.validate()
    assert cfg.algo.shrink_fix and cfg.algo.shrink_compact
    assert cfg.algo.shrink_buckets == "0.3,0.6"
    assert cfg.algo.shrink_rho and cfg.algo.shrink_rho_interval == 2
    opts = cfg.algo.to_options()
    assert opts["shrink_compact"] and opts["shrink_buckets"] == "0.3,0.6"


# ---------------- the engines' shrink bookkeeping ----------------

BIG = 2 ** 30


def slot0_fix_list(b):
    """Only slot 0 ever fixes: a PARTIAL fixed set, so compaction keeps
    free slots (tests/test_shrink.py)."""
    spec = uniform_fix_list(b, tol=5e-1, nb=3, lb=3, ub=3,
                            integer_only=False)
    for k in ("nb", "lb", "ub"):
        a = np.minimum(spec[k], BIG).copy()
        a[1:] = BIG
        spec[k] = a
    return spec


# tests/test_shrink.py's farmer options (slot 0 fixes at iteration 8)
FARMER_OPTS = {"defaultPHrho": 5.0, "PHIterLimit": 25, "convthresh": 0.0,
               "subproblem_max_iter": 3000, "subproblem_eps": 1e-8,
               "shrink_fix": True, "id_fix_list_fct": slot0_fix_list}


def farmer_batch(S=3):
    return build_batch(farmer.scenario_creator, farmer.make_tree(S))


@pytest.fixture
def mem_obs():
    rec = obs.configure()
    yield rec
    obs.shutdown()


def test_refactorizations_track_bucket_transitions():
    """One re-factorization per (bucket transition, mode) and none at a
    repeated target: a wheel's compaction builds the compacted prox-on
    factors once, a prox-off pass builds its own once, repeated
    maybe_compact calls at the same fixed count build nothing, and a
    second engine of the same shapes pays the same (torch keeps no
    compile cache to hit)."""
    # slot 0 fixes at iteration 8
    o = dict(FARMER_OPTS, PHIterLimit=10, shrink_compact=True,
             shrink_buckets="0.2")
    for _ in range(2):
        ph = PH(farmer_batch(), dict(o), device="cpu")
        ph.ph_main()
        st = ph._shrink_status
        assert st["compactions"] == 1
        assert st["refactorizations"] == ph.refactorizations == 1
        for _ in range(3):
            assert not ph.maybe_compact(ph.extensions.nfixed)
        ph.solve_loop(w_on=True, prox_on=True)
        assert st["refactorizations"] == 1
        ph.solve_loop(w_on=True, prox_on=False, update=False)
        assert st["refactorizations"] == 2
        ph.solve_loop(w_on=True, prox_on=False, update=False)
        assert st["refactorizations"] == 2


def test_failed_compaction_target_memoized(monkeypatch):
    """When ALL slots fix the plan comes back None: its host staging
    runs once per target, not every miditer."""
    calls = {"n": 0}
    orig = shrink.build_plan

    def counting(*a, **kw):
        calls["n"] += 1
        return orig(*a, **kw)

    monkeypatch.setattr(shrink, "build_plan", counting)
    o = {"defaultPHrho": 5.0, "PHIterLimit": 12, "convthresh": 0.0,
         "subproblem_max_iter": 2000, "subproblem_eps": 1e-7,
         "shrink_fix": True, "shrink_compact": True,
         "shrink_buckets": "0.5",
         "id_fix_list_fct": lambda b: uniform_fix_list(
             b, tol=50.0, nb=1, lb=1, ub=1, integer_only=False)}
    ph = PH(farmer_batch(), o, device="cpu")
    ph.ph_main()
    assert ph.extensions.nfixed == ph.batch.K
    assert ph._shrink is None
    assert calls["n"] == 1



# ---------------- cross-bucket warm transplant ----------------

def test_warm_transplant_reconverges_in_fewer_iterations(monkeypatch):
    """At a bucket transition the surviving rows and columns of the ADMM
    states transplant into the compacted width, and the transplanted
    start re-converges in strictly fewer solver iterations than a cold
    start of the same solve (both re-run at the hot-loop band, 1e-4);
    a transplant-off run lands on the same trajectory to solver
    tolerance (tests/test_shrink.py's bars)."""
    o = dict(FARMER_OPTS, PHIterLimit=12, shrink_compact=True,
             shrink_buckets="0.2", subproblem_segment=25)
    ph = PH(farmer_batch(), o, device="cpu")
    flag, rec = {}, {}
    pull_orig = ph._transplant_pull

    def pull(key, fnew):
        tp = pull_orig(key, fnew)
        if tp is not None:
            flag["armed"], flag["n"] = True, tp["x"].shape[-1]
        return tp

    monkeypatch.setattr(ph, "_transplant_pull", pull)
    orig = ph_mod._solver_call

    def spy(fac, d, q, st, **kw):
        out = orig(fac, d, q, st, **kw)
        if flag.get("armed") and "warm" not in rec \
                and st.x.shape[-1] == flag["n"] \
                and bool(st.x.abs().max() > 0):
            kw2 = dict(kw, sub_eps=1e-4, sub_eps_hot=1e-4,
                       sub_eps_dua_hot=1e-4)
            rec["warm"] = int(orig(fac, d, q, st, **kw2)[0].iters)
            rec["cold"] = int(orig(fac, d, q, qp_cold_state(fac, d),
                                   **kw2)[0].iters)
        return out

    monkeypatch.setattr(ph_mod, "_solver_call", spy)
    obs.configure()
    try:
        ph.ph_main()
        ctr = obs.counters_snapshot()
    finally:
        obs.shutdown()
    st = ph._shrink_status
    assert st["transplants"] >= 1 and st["transplant_cold"] == 0
    assert ctr.get("shrink.transplants", 0) >= 1
    assert ctr.get("shrink.transplant_cold_fallbacks", 0) == 0
    assert "warm" in rec, "compacted-width transition solve not seen"
    assert rec["warm"] < rec["cold"], rec
    monkeypatch.setattr(ph_mod, "_solver_call", orig)
    ph_c = PH(farmer_batch(), dict(o, shrink_transplant=False),
              device="cpu")
    ph_c.ph_main()
    assert ph_c._shrink_status["transplants"] == 0
    np.testing.assert_allclose(ph.xbar.numpy(), ph_c.xbar.numpy(),
                               rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(ph.W.numpy(), ph_c.W.numpy(), atol=5e-2)


def test_transplant_poisoned_rows_zeroed_to_cold(mem_obs):
    """The capture gate certifies each row: a scenario whose iterates
    fail the unscaled consensus checks (x != zB or A x != zA) starts
    cold inside the transplant, which the ``shrink.transplant`` event
    reports as ``cold_rows``."""
    ph = PH(farmer_batch(), dict(FARMER_OPTS, PHIterLimit=10,
                                 shrink_compact=True, shrink_buckets="0.2"),
            device="cpu")
    cap_orig = ph._transplant_capture

    def poison_then_capture(plan_new):
        for mode in (True, False):
            st = ph._qp_states.get(mode)
            if hasattr(st, "_replace"):
                x = st.x.clone()
                x[0] = 1e6
                ph._qp_states[mode] = st._replace(x=x)
        return cap_orig(plan_new)

    ph._transplant_capture = poison_then_capture
    ph.ph_main()
    assert ph._shrink_status["transplants"] >= 1
    tps = [e for _, e in obs.events("shrink.transplant")]
    assert tps and all(e["cold_rows"] >= 1 for e in tps), tps



# ---------------- APH and the CLI ----------------

def test_aph_partial_dispatch_under_compaction(mem_obs):
    """tests/test_dispatch.py's composition case on the port's UC: a
    compacted APH wheel (dispatch 0.5, chunks of 2) keeps skipping
    solves on the chunked-skip path, dispatches everyone on the
    transition's iteration, keeps full-width x and z, and stays within
    5 % of the full-dispatch pin-box trajectory's objective."""
    def make(**o):
        base = {"defaultPHrho": 100.0, "PHIterLimit": 25,
                "convthresh": -1.0, "subproblem_kernel_mode": "fused",
                "subproblem_kernel_backend": "pallas",
                "subproblem_max_iter": 400, "subproblem_polish_hot": False,
                "subproblem_polish_chunk": 2, "subproblem_chunk": 2,
                "shrink_fix": True, "id_fix_list_fct": slot0_fix_list}
        return APH(_batches("uc", 6)[1], dict(base, **o), device="cpu")

    paths = []

    class Paths(ext.Extension):
        def enditer(self, opt):
            paths.append((opt._aph_status["solve_path"],
                          opt._shrink_status["compactions"]))

    ref = make()
    ref.APH_main(finalize=False)
    aph = make(dispatch_frac=0.5, shrink_compact=True,
               shrink_buckets="0.02")
    fixer = aph.extensions
    aph.extensions = ext.MultiExtension([fixer, Paths()])
    aph.APH_main(finalize=False)
    st = aph._shrink_status
    assert st["compactions"] == 1 and aph._shrink is not None
    # the transition's iteration dispatched everyone, then partial
    # dispatch resumed
    k = next(i for i, (_, c) in enumerate(paths) if c == 1)
    assert k > 1 and paths[k][0] == "full"
    assert paths[k - 1][0] == paths[k + 1][0] == "chunked-skip"
    assert aph._aph_status["solve_path"] == "chunked-skip"
    assert aph.x.shape == (6, aph.batch.n)
    assert aph.z.shape[1] == aph.batch.K
    assert aph.yA.shape[1] == aph._shrink.m_c
    assert obs.counters_snapshot().get("dispatch.skipped_scenarios", 0) > 0
    o_ref, o_c = ref.Eobjective_value(), aph.Eobjective_value()
    assert abs(o_c - o_ref) / abs(o_ref) < 0.05


def test_cli_shrink_flags_reach_the_engine(capsys):
    """``python -m mpisppy_tpu_torch uc --shrink-compact ...``: the flags
    reach the hub engine through vanilla, which attaches the device
    fixer and compacts; the CLI run itself ends with a finite outer
    bound."""
    import json
    from mpisppy_tpu_torch.__main__ import (config_from_args, main,
                                            make_parser)
    from mpisppy_tpu_torch.utils import vanilla
    argv = ["uc", "--num-scens", "4", "--model-kwargs",
            '{"num_gens": 3, "num_hours": 6, "relax_integrality": false}',
            "--default-rho", "100",
            "--max-iterations", "8", "--convthresh", "-1",
            "--subproblem-max-iter", "400", "--shrink-compact",
            "--shrink-fix-iters", "2", "--shrink-fix-tol", "0.01",
            "--shrink-buckets", "0.5,0.75", "--device", "cpu"]
    cfg = config_from_args(make_parser().parse_args(argv))
    hd = vanilla.hub_dict(cfg)
    eng = hd["opt_class"](**hd["opt_kwargs"])
    assert isinstance(eng.extensions, ext.DeviceFixer)
    eng.ph_main()
    assert eng._shrink_status["compactions"] >= 1
    assert main(argv) == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert np.isfinite(result["outer_bound"])
