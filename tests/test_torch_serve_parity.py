"""The port's serve layer held against the JAX package's on the same
instances (the parity cases of the serving slice; the protocol's,
(b), are in tests/test_torch_migrate.py):

- (a) the same payloads through both packages' validate_payload,
  apply_patch, stack_instances, forest_tree and demux_expectation give
  identical arrays and identical refusals (exact equality);
- (c) both services solve the same two patched UC 3 x 6 requests as one
  stacked wheel, with the fixed-rho block options of
  tests/test_torch_extensions.py: each request's objective and x̂
  agree at the port's PH parity bar there (1e-8 relative);
- (d) install_batch into a warm engine runs the same trajectory as a
  fresh engine on the same instance (1e-10) without a new factor
  build, and the same as the JAX package's install_batch (1e-8
  relative; the certified trivial bound, which passes through the
  polish, at the 2e-6 that ROADMAP.md C.1 states for it).
"""

import time

import jax.numpy as jnp
import numpy as np
import pytest

from mpisppy_tpu.core.ph import PH as JaxPH
from mpisppy_tpu.serve import batch as jax_sbatch
from mpisppy_tpu.serve import manager as jax_manager
from mpisppy_tpu.utils import config as jax_config
from mpisppy_tpu.utils.vanilla import build_batch_for as jax_build_for
from mpisppy_tpu_torch.core.ph import PH
from mpisppy_tpu_torch.serve import batch as sbatch
from mpisppy_tpu_torch.serve import manager
from mpisppy_tpu_torch.utils.config import ServeConfig
from mpisppy_tpu_torch.utils.runtime import to_host
from mpisppy_tpu_torch.utils.vanilla import build_batch_for
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

FARMER = {"model": "farmer", "num_scens": 3,
          "algo": {"max_iterations": 30}}
FARMER_PATCHES = [
    {"u": {"EnforceCattleFeedRequirement":
           [[250.0, 260.0, 0.0], [230.0, 250.0, 0.0],
            [210.0, 230.0, 0.0]]}},
    {"c": {"DevotedAcreage": [160.0, 235.0, 250.0]}},
    {"l": {"EnforceCattleFeedRequirement": [180.0, 220.0, 0.0]}}]
_UC_KW = {"num_gens": 3, "num_hours": 6}
# tests/test_torch_extensions.py's fixed-rho block options, as the
# request's algo knobs (AlgoConfig names)
_UC_ALGO = {"default_rho": 100.0, "convthresh": -1.0, "max_iterations": 3,
            "subproblem_kernel_mode": "fused",
            "subproblem_kernel_backend": "pallas",
            "subproblem_max_iter": 400, "subproblem_polish_chunk": 2}
UC = {"model": "uc", "num_scens": 3, "model_kwargs": _UC_KW,
      "algo": _UC_ALGO}
_FIELDS = ("c", "c0", "P_diag", "A", "l", "u", "lb", "ub", "c_stage",
           "c0_stage", "prob", "nonant_idx", "nonant_stage")


def _uc_patches(base):
    """Two data-only requests: every scenario's own net load on the
    balance rows (l = u) at 1.00 and 1.01, given per scenario as
    (S, len) rows."""
    sl = base.template.con_slices["balance"]
    load = np.asarray(base.l)[:, sl]
    return [{"l": {"balance": (load * f).tolist()},
             "u": {"balance": (load * f).tolist()}} for f in (1.0, 1.01)]


def _same_batch(p, j):
    for f in _FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(p, f)),
                                      np.asarray(getattr(j, f)),
                                      err_msg=f)
    np.testing.assert_array_equal(p.tree.node_path, j.tree.node_path)
    np.testing.assert_array_equal(p.tree.probabilities,
                                  j.tree.probabilities)
    assert p.tree.scen_names == j.tree.scen_names
    assert p.tree.nodes_per_stage == j.tree.nodes_per_stage
    assert [(s.start, s.stop) for s in p.stage_slot_slices] \
        == [(s.start, s.stop) for s in j.stage_slot_slices]


@pytest.mark.parametrize("model", ["farmer", "uc"])
def test_batch_helpers_match_jax(model):
    payload = FARMER if model == "farmer" else UC
    assert sbatch.validate_payload(payload) is payload
    assert jax_sbatch.validate_payload(payload) is payload
    pb = build_batch_for(sbatch.base_runconfig(payload))
    jb = jax_build_for(jax_sbatch.base_runconfig(payload))
    _same_batch(pb, jb)
    patches = FARMER_PATCHES if model == "farmer" else _uc_patches(pb)
    pp = [sbatch.apply_patch(pb, p) for p in patches]
    jp = [jax_sbatch.apply_patch(jb, p) for p in patches]
    for a, b in zip(pp, jp):
        _same_batch(a, b)
    ps, pblocks = sbatch.stack_instances([pb, *pp])
    js, jblocks = jax_sbatch.stack_instances([jb, *jp])
    assert pblocks == jblocks
    _same_batch(ps, js)
    pt = sbatch.forest_tree([b.tree for b in pp])
    jt = jax_sbatch.forest_tree([b.tree for b in jp])
    np.testing.assert_array_equal(pt.node_path, jt.node_path)
    np.testing.assert_array_equal(pt.probabilities, jt.probabilities)
    for s in range(1, pt.num_stages):
        np.testing.assert_array_equal(pt.membership(s), jt.membership(s))
    v = np.random.RandomState(0).standard_normal(ps.S)
    assert sbatch.demux_expectation(v, ps.prob, pblocks) \
        == jax_sbatch.demux_expectation(v, js.prob, jblocks)
    # a patch of the wrong row count is refused alike
    sl_name = next(iter(patches[0][next(iter(patches[0]))]))
    bad = {"l": {sl_name: [[1.0]] * 2}}
    with pytest.raises(sbatch.BadRequest) as pe:
        sbatch.apply_patch(pb, bad)
    with pytest.raises(jax_sbatch.BadRequest) as je:
        jax_sbatch.apply_patch(jb, bad)
    assert str(pe.value) == str(je.value)


_BAD = [
    {"model": "nope"},
    {**FARMER, "num_scens": 0},
    {**FARMER, "algo": {"defaultPHrho": 2}},
    {**FARMER, "patch": {"A": {"x": [1.0]}}},
    {**FARMER, "patch": {"l": "oops"}},
    {**FARMER, "patch": {"l": {"b": ["x"]}}},
    {**FARMER, "deadline": -1},
    {**FARMER, "patch": FARMER_PATCHES[0], "chain": [{}]},
    {**FARMER, "chain": []},
    {**FARMER, "chain": ["x"]},
    {**FARMER, "algo": {"subproblem_kernel_mode": "bogus"}},
    "not a dict",
]


def test_refusals_match_jax():
    """Each bad payload is refused by both packages with the same
    exception class and message (a BadRequest, or the algo knobs'
    ValueError)."""
    for bad in _BAD:
        with pytest.raises(ValueError) as pe:
            sbatch.validate_payload(bad)
        with pytest.raises(ValueError) as je:
            jax_sbatch.validate_payload(bad)
        assert type(pe.value).__name__ == type(je.value).__name__, bad
        assert str(pe.value) == str(je.value), bad


def _wait(svc, rid, timeout=300):
    t0 = time.time()
    while time.time() - t0 < timeout:
        rec = svc.result(rid)
        if rec and rec["status"] in ("done", "failed"):
            return rec
        time.sleep(0.05)
    raise TimeoutError(f"{rid}: {svc.result(rid)}")


def _serve_pair(svc, payloads):
    svc.start()
    try:
        reqs = [svc.submit(p) for p in payloads]
        return [_wait(svc, r.id) for r in reqs]
    finally:
        svc.stop()


def test_stacked_uc_wheel_matches_jax_service(tmp_path):
    base = build_batch_for(sbatch.base_runconfig(UC))
    payloads = [{**UC, "patch": p} for p in _uc_patches(base)]
    kw = dict(batch_window=2.0, batch_max=2, checkpoint_interval=60.0)
    got = _serve_pair(manager.ServeService(ServeConfig(
        state_dir=str(tmp_path / "port"), device="cpu", **kw)), payloads)
    ref = _serve_pair(jax_manager.ServeService(jax_config.ServeConfig(
        state_dir=str(tmp_path / "jax"), **kw)), payloads)
    for g, r in zip(got, ref):
        assert g["status"] == "done" and r["status"] == "done", (g, r)
        assert g["group"] is not None and g["group"] == got[0]["group"]
        assert g["result"]["wheel"]["stack"] == 2
        assert r["result"]["wheel"]["stack"] == 2
        go, ro = g["result"]["objective"], r["result"]["objective"]
        assert go is not None and ro is not None
        assert go == pytest.approx(ro, rel=1e-8)
        np.testing.assert_allclose(g["result"]["xhat"],
                                   r["result"]["xhat"], rtol=1e-8,
                                   atol=1e-8)
        # the stamp keeps every key of the JAX record
        assert set(r["result"]["wheel"]) <= set(g["result"]["wheel"])
    # the patch reached the solves: the two requests' answers differ
    assert abs(got[0]["result"]["objective"]
               - got[1]["result"]["objective"]) > 1.0


def _state(e):
    return {k: to_host(getattr(e, k)) for k in ("W", "xbar", "xsqbar",
                                                 "rho")}


def test_install_batch_warm_equals_fresh_and_jax():
    opts = sbatch.request_algo(UC).to_options()
    pbase = build_batch_for(sbatch.base_runconfig(UC))
    jbase = jax_build_for(jax_sbatch.base_runconfig(UC))
    pa, pb = (sbatch.apply_patch(pbase, p) for p in _uc_patches(pbase))
    ja, jb = (jax_sbatch.apply_patch(jbase, p)
              for p in _uc_patches(pbase))
    # the port: a warm engine re-leased to tenant B against a fresh one
    warm = manager.build_engine(pa, opts, device="cpu")
    warm.ph_main()
    builds = warm.factor_builds
    manager.install_batch(warm, pb)
    got = warm.ph_main()
    assert warm.factor_builds == builds      # the factors were kept
    fresh = manager.build_engine(pb, opts, device="cpu")
    ref = fresh.ph_main()
    np.testing.assert_allclose(got, ref, rtol=1e-10, atol=1e-10)
    for k, v in _state(fresh).items():
        np.testing.assert_allclose(_state(warm)[k], v, rtol=1e-10,
                                   atol=1e-10, err_msg=k)
    # the JAX package's install_batch on its own engine
    jopts = jax_sbatch.request_algo(UC).to_options()
    jwarm = JaxPH(ja, dict(jopts), dtype=jnp.float64)
    jwarm.ph_main()
    jax_manager.install_batch(jwarm, jb)
    jgot = jwarm.ph_main()
    np.testing.assert_allclose(got[:2], jgot[:2], rtol=1e-8)
    assert got[2] == pytest.approx(jgot[2], rel=2e-6)
    for k in ("W", "xbar", "xsqbar", "rho"):
        np.testing.assert_allclose(to_host(getattr(warm, k)),
                                   np.asarray(getattr(jwarm, k)),
                                   rtol=1e-8, atol=1e-8, err_msg=k)
