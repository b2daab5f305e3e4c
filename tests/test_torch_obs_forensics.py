"""Wheel forensics (mpisppy_tpu_torch/ops/forensics.py) against the JAX
package's ops/forensics.forensic_reduce on the same seeded (S, K)
inputs, over three samples so the dW and sign-flip gates open, and the
sharded sample on 2 gloo ranks against the unsharded one, both for the
bare reduction and for the engine's per-iteration samples.

Bars: every value at 1e-12 (relative, floor 1e-12 absolute): the two
reductions sum the same products in possibly different orders.
``torch.topk`` does not promise ``jax.lax.top_k``'s order among equal
values (zero-mass slots before the gates open, pads at -1), so ids are
compared only where the value is not tied within the leaderboard. The
sizes keep every real scenario and slot on the leaderboards, so a tie
can only be with a listed value."""

import jax.numpy as jnp
import numpy as np
import pytest

from mpisppy_tpu.ops import forensics as jax_forensics
from mpisppy_tpu_torch.ops import forensics
from mpisppy_tpu_torch.parallel.launch import launch

import torch_mesh_ranks as ranks
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TOL = 1e-12
_HDR = 8


def _blocks(v, kk, ks):
    """[(ids, values, abs-ranked?)] of a packed vector's leaderboards."""
    o, out = _HDR, []
    for abs_ranked in (False, False, True):
        out.append((v[o:o + kk], v[o + kk:o + 2 * kk], abs_ranked))
        o += 2 * kk
    for _ in range(2):
        out.append((v[o:o + ks], v[o + ks:o + 2 * ks], False))
        o += 2 * ks
    return out


def _assert_packed_equal(a, b, kk, ks):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape == (forensics.packed_size(kk, ks),)
    np.testing.assert_allclose(b[:_HDR], a[:_HDR], rtol=TOL, atol=TOL)
    for (ia, va, ab), (ib, vb, _) in zip(_blocks(a, kk, ks),
                                         _blocks(b, kk, ks)):
        np.testing.assert_allclose(vb, va, rtol=TOL, atol=TOL)
        score = np.abs(va) if ab else va
        for j in range(len(va)):
            tied = np.sum(np.abs(score - score[j])
                          <= TOL * max(1.0, abs(score[j]))) > 1
            if not tied:
                assert ia[j] == ib[j], (j, ia, ib)


def _inputs(seed, S, K, S_real):
    """The global inputs forensic_samples draws, in the same order."""
    rng = np.random.default_rng(seed)
    prob = np.zeros(S)
    prob[:S_real] = rng.dirichlet(np.ones(S_real))
    rho = rng.uniform(0.5, 2.0, size=(S, K))
    for _ in range(3):
        xn = rng.normal(size=(S, K))
        yield prob, rho, xn, np.broadcast_to(prob @ xn, (S, K)), \
            rng.normal(size=(S, K))


@pytest.mark.parametrize("S,K,S_real", [(5, 6, 5), (6, 4, 5)])
def test_forensic_reduce_matches_jax_over_three_samples(S, K, S_real):
    """The port's reduction, packed vector for packed vector, against
    the JAX package's on the same inputs; (6, 4, 5) carries a
    zero-probability pad row, which scores -1 and never wins."""
    kk, ks = min(forensics.TOPK, K), min(forensics.TOPK, S_real)
    spec = {"seed": 7, "S": S, "K": K, "S_real": S_real}
    got = ranks.forensic_samples(None, spec)
    st = jax_forensics.init_state(S, K)
    for i, (prob, rho, xn, xbar, w) in enumerate(
            _inputs(7, S, K, S_real)):
        st, packed = jax_forensics.forensic_reduce(
            st, jnp.asarray(xn), jnp.asarray(xbar), jnp.asarray(w),
            jnp.asarray(prob), jnp.asarray(rho), kk=kk, ks=ks)
        _assert_packed_equal(np.asarray(packed), got[i], kk, ks)
        fj = jax_forensics.unpack(packed, kk, ks)
        fp = forensics.unpack(got[i], kk, ks)
        assert fp.keys() == fj.keys()
        assert fp["samples"] == fj["samples"] == i + 1
        # the slot masses decompose conv exactly
        assert sum(m for _, m in fp["top_slots"]) / K == pytest.approx(
            fp["conv"], rel=TOL)
        assert all(s < S_real for s, _ in fp["scen_pri_shares"])
    # the gates opened: dual totals from sample 2, flips from sample 3
    assert forensics.unpack(got[1], kk, ks)["dua_total"] > 0
    assert forensics.unpack(got[2], kk, ks)["osc_mean"] > 0


def test_sharded_sample_equals_unsharded_on_two_ranks():
    """Each rank reduces its rows; the slot sums go through one
    all-reduce and the scenario candidates, carrying global ids, are
    gathered and re-ranked: both ranks pack the unsharded sample."""
    spec = {"seed": 3, "S": 8, "K": 5, "S_real": 7}
    kk, ks = 5, 7
    ref = ranks.forensic_samples(None, spec)
    outs = launch(ranks.forensic_samples, 2, (spec,), device="cpu")
    for o in outs:
        for a, b in zip(ref, o):
            _assert_packed_equal(a, b, kk, ks)


_MESH_PH = {"model": "uc", "S": 6,
            "opts": {"defaultPHrho": 100.0, "PHIterLimit": 3,
                     "convthresh": -1.0, "subproblem_kernel_mode": "fused",
                     "subproblem_kernel_backend": "cuda",
                     "subproblem_max_iter": 400,
                     "subproblem_polish_hot": False}}


def test_engine_samples_on_two_ranks_equal_the_unsharded_run():
    """PH's per-iteration samples on a 2-rank mesh (every rank records:
    the sample's reductions are collectives) against the unsharded
    engine's, at the bar the sharded PH runs themselves meet
    (tests/test_torch_sharding.py: 1e-8)."""
    ref = ranks.ph_forensics(None, _MESH_PH)
    outs = launch(ranks.ph_forensics, 2, (_MESH_PH,), device="cpu")
    assert len(ref) == 3
    for o in outs:
        assert len(o) == len(ref)
        for a, b in zip(ref, o):
            assert a.keys() == b.keys()
            for k in ("conv", "pri_total", "dua_total", "osc_mean",
                      "rho_log_ratio_mean", "xbar_move", "rho_mean"):
                assert b[k] == pytest.approx(a[k], rel=1e-8, abs=1e-10), k
            for k in ("top_slots", "scen_pri_shares", "scen_dua_shares"):
                np.testing.assert_allclose(
                    [v for _, v in b[k]], [v for _, v in a[k]],
                    rtol=1e-8, atol=1e-10)
            assert (b["it"], b["n_scens"], b["n_slots"]) == \
                (a["it"], a["n_scens"], a["n_slots"])
