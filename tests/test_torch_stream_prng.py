"""The port's scenario-streaming building blocks against the JAX
package's, on the CPU: the jax-semantics threefry generator
(mpisppy_tpu_torch/stream/prng.py) against ``jax.random``, the synth
specs and batches (stream/synth.py, the models' ``scenario_synth_spec``)
against the JAX package's, the int8 gate and dequantization
(stream/quant.py) against its ``quantize_field`` / ``dequantize``, and
the chunk pipeline's order, backpressure, stalls, restart and gated
passes (stream/pipeline.py).

Bars: keys, fold_in, the 64-bit draws and [0, 1) f64 uniforms, the farmer
family's values and the int8 packs are bit-equal; a general
[minval, maxval) draw agrees to one ulp of the range's bound (XLA:CPU
fuses its scale and shift into one multiply-add). Normal draws go through
``erfinv``: torch's agrees with scipy's to a few ulp, XLA's f64
erf_inv is off by up to ~1.2e-11 absolute in the tails (5 sigma), so
the normal bar is 2e-11 x max(1, |x|); the UC family's values (the
normal walk scaled by the fleet's capacity) are held at 1e-12 x
max(1, |v|)."""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpisppy_tpu.models import farmer as jax_farmer
from mpisppy_tpu.models import uc as jax_uc
from mpisppy_tpu.stream import quant as jax_quant
from mpisppy_tpu.stream import synth as jax_synth
from mpisppy_tpu_torch import obs
from mpisppy_tpu_torch.models import farmer, uc
from mpisppy_tpu_torch.stream import (ChunkPipeline, SynthField, SynthSpec,
                                      dequantize, dequantize_cols,
                                      materialize, prng, quantize_field,
                                      synth_batch, synth_values)
from mpisppy_tpu_torch.stream.quant import _reconstruct_f32

from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

NORMAL_BAR = 2e-11
UC_BAR = 1e-12
UC_KW = {"num_gens": 3, "num_hours": 6}
SEEDS = (0, 1, 7, 123456789, 2 ** 33 + 5)


@pytest.fixture
def mem_obs():
    rec = obs.configure()
    yield rec
    obs.shutdown()


def _jax_keys(seed, ids):
    k = jax.random.PRNGKey(seed)
    return jax.vmap(lambda s: jax.random.fold_in(k, s))(
        jnp.asarray(ids, jnp.int32))


# ---------------- the generator ----------------

@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_and_fold_in_bit_equal_jax(seed):
    ids = np.arange(0, 3000, 3)
    k = prng.prng_key(seed)
    assert np.array_equal(k.numpy(),
                          np.asarray(jax.random.PRNGKey(seed), np.int64))
    got = prng.fold_in(k, torch.as_tensor(ids))
    want = np.asarray(_jax_keys(seed, ids), np.int64)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", SEEDS)
def test_uniform_bit_equal_jax(seed):
    ids = np.arange(0, 2000, 7)
    keys = prng.fold_in(prng.prng_key(seed), torch.as_tensor(ids))
    jk = _jax_keys(seed, ids)
    for shape in ((5,), (3, 4), (48,)):
        want = np.asarray(jax.vmap(
            lambda k: jax.random.uniform(k, shape))(jk))
        got = prng.uniform(keys, shape).numpy()
        assert np.array_equal(got, want), shape
    # a general [minval, maxval): XLA:CPU contracts the scale and shift
    # into one fused multiply-add, torch rounds twice, so these draws
    # agree to one unit in the last place of the range's bound (the
    # specs draw on [0, 1))
    want = np.asarray(jax.vmap(lambda k: jax.random.uniform(
        k, (6,), minval=-2.5, maxval=4.0))(jk))
    got = prng.uniform(keys, (6,), minval=-2.5, maxval=4.0).numpy()
    assert np.abs(got - want).max() <= np.spacing(4.0)
    want = np.asarray(jax.vmap(lambda k: jax.random.bits(
        k, (9,), dtype=jnp.uint64))(jk))
    hi, lo = prng.random_bits(keys, (9,))
    assert np.array_equal(hi.numpy(), (want >> 32).astype(np.int64))
    assert np.array_equal(lo.numpy(),
                          (want & 0xFFFFFFFF).astype(np.int64))


@pytest.mark.parametrize("seed", SEEDS)
def test_normal_within_bar_of_jax(seed):
    from scipy.special import erfinv
    ids = np.arange(4000)
    keys = prng.fold_in(prng.prng_key(seed), torch.as_tensor(ids))
    want = np.asarray(jax.vmap(lambda k: jax.random.normal(k, (48,)))(
        _jax_keys(seed, ids)))
    got = prng.normal(keys, (48,)).numpy()
    diff = np.abs(got - want) / np.maximum(1.0, np.abs(want))
    assert diff.max() <= NORMAL_BAR, diff.max()
    # the port's draw is the accurate one: within a few ulp of scipy's
    u = prng.uniform(keys, (48,), minval=float(np.nextafter(-1.0, 0.0)))
    ref = np.sqrt(2.0) * erfinv(u.numpy())
    ulps = np.abs(got - ref) / np.spacing(np.maximum(1.0, np.abs(ref)))
    assert ulps.max() <= 8


# ---------------- synth specs and batches ----------------

@pytest.mark.parametrize("seed", (0, 7, 11))
def test_farmer_synth_batch_bit_equal_jax(seed):
    bj, _ = jax_synth.synth_batch(jax_farmer.scenario_creator,
                                  jax_farmer.make_tree(40),
                                  jax_farmer.scenario_synth_spec,
                                  seed=seed)
    bt, spec = synth_batch(farmer.scenario_creator, farmer.make_tree(40),
                           farmer.scenario_synth_spec, seed=seed)
    for f in ("c", "l", "u", "lb", "ub", "c_stage", "P_diag", "c0",
              "prob"):
        assert np.array_equal(getattr(bt, f), getattr(bj, f)), f
    assert np.array_equal(bt.A, bj.A)
    sl = spec.fields[0]
    vals = synth_values(spec, np.arange(40))[0].numpy()
    assert np.array_equal(vals, bt.l[:, sl.start:sl.stop])


@pytest.mark.parametrize("seed", (0, 3))
def test_uc_synth_batch_within_bar_of_jax(seed):
    bj, _ = jax_synth.synth_batch(jax_uc.scenario_creator,
                                  jax_uc.make_tree(64),
                                  jax_uc.scenario_synth_spec,
                                  creator_kwargs=dict(UC_KW), seed=seed)
    bt, _ = synth_batch(uc.scenario_creator, uc.make_tree(64),
                        uc.scenario_synth_spec,
                        creator_kwargs=dict(UC_KW), seed=seed)
    assert np.array_equal(bt.A, bj.A)
    for f in ("c", "l", "u", "lb", "ub"):
        a, b = getattr(bj, f), getattr(bt, f)
        fin = np.isfinite(a)
        assert np.array_equal(np.isfinite(b), fin), f
        rel = np.abs(a[fin] - b[fin]) / np.maximum(1.0, np.abs(a[fin]))
        assert rel.max(initial=0.0) <= UC_BAR, (f, rel.max())


def test_synth_values_chunk_invariant_and_views():
    """fold_in(seed, id) makes a scenario's data independent of which
    chunk asks for it; the synthesized twin is zero-stride views."""
    b_res, spec = synth_batch(uc.scenario_creator, uc.make_tree(8),
                              uc.scenario_synth_spec,
                              creator_kwargs=dict(UC_KW), seed=5)
    b_syn, _ = synth_batch(uc.scenario_creator, uc.make_tree(8),
                           uc.scenario_synth_spec,
                           creator_kwargs=dict(UC_KW), seed=5,
                           materialize_values=False)
    whole = synth_values(spec, np.arange(8))
    parts = [synth_values(spec, torch.arange(lo, lo + 2))
             for lo in range(0, 8, 2)]
    for i in range(len(spec.fields)):
        glued = torch.cat([p[i] for p in parts])
        assert torch.equal(whole[i], glued)
    mat = materialize(spec, 8, batch_rows=3)
    for f, blocks in mat.items():
        for start, stop, vals in blocks:
            assert np.array_equal(vals, getattr(b_res, f)[:, start:stop])
    assert b_syn.l.strides[0] == 0 and b_syn.shared_A and b_res.shared_A


def test_synth_spec_rejections():
    with pytest.raises(ValueError, match="may perturb"):
        SynthField("c", 0, 3)
    with pytest.raises(ValueError, match="bad synth block"):
        SynthField("l", 3, 3)

    def bad_width(f0, seed=0, **kw):
        return SynthSpec(seed=seed, fields=(SynthField("l", 0, 2),),
                         fn=lambda k: (torch.zeros(k.shape[0], 3,
                                                   dtype=torch.float64),))

    def bad_arity(f0, seed=0, **kw):
        return SynthSpec(seed=seed, fields=(SynthField("l", 0, 2),
                                            SynthField("u", 0, 2)),
                         fn=lambda k: torch.zeros(k.shape[0], 2))

    def too_wide(f0, seed=0, **kw):
        return SynthSpec(seed=seed,
                         fields=(SynthField("lb", 0, f0.n + 1),),
                         fn=lambda k: (torch.zeros(k.shape[0], 1),))

    for make_spec, msg in ((bad_width, "per-scenario shape"),
                         (bad_arity, "returns 1 arrays"),
                         (too_wide, "exceeds the field width")):
        with pytest.raises(ValueError, match=msg):
            synth_batch(farmer.scenario_creator, farmer.make_tree(3),
                        make_spec)


# ---------------- the int8 gate ----------------

def _same_pack(got, want):
    assert (got is None) == (want is None)
    if got is None:
        return
    for f in ("tmpl", "varying", "q", "scale", "zero"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and np.array_equal(a, b,
                                                     equal_nan=True), f


@pytest.mark.parametrize("case", ["smooth", "unperturbed", "coarse",
                                  "nonfinite", "farmer"])
def test_int8_gate_cases_bit_equal_jax(case):
    """Accept and reject cases of the gate, each against the JAX
    package's quantize_field on the same inputs."""
    if case == "smooth":
        tmpl = np.array([1.0, 2.0, np.inf, 0.0])
        a = tmpl[None] + np.array([[0.0, 0.01, 0.0, 0.002],
                                   [0.005, -0.01, 0.0, 0.0]])
        a[:, 2] = np.inf
        tol = 1e-3
    elif case == "unperturbed":
        tmpl = np.array([3.0, -5.0, 0.0])
        a, tol = np.repeat(tmpl[None], 4, axis=0), 1e-12
    elif case == "coarse":
        tmpl, a, tol = np.zeros(3), np.array([[1.0, 3.0, 1e6]]), 1e-6
    elif case == "nonfinite":
        tmpl, a, tol = np.array([1.0, 2.0]), np.array([[1.0, np.inf]]), \
            1e-3
    else:
        b, _ = synth_batch(farmer.scenario_creator, farmer.make_tree(12),
                           farmer.scenario_synth_spec, seed=7)
        a, tmpl, tol = b.l, b.l[0], 1e-3
    got = quantize_field(a, tmpl, tol)
    _same_pack(got, jax_quant.quantize_field(a, tmpl, tol))
    if case in ("coarse", "nonfinite"):
        assert got is None
        return
    assert got is not None
    rec = _reconstruct_f32(got, slice(None))
    fin = np.isfinite(a)
    assert np.array_equal(np.isfinite(rec), fin)
    err = np.abs(rec[fin] - a[fin]) / (1.0 + np.abs(a[fin]))
    assert err.max(initial=0.0) <= tol
    if case == "unperturbed":
        assert np.array_equal(rec, a)


def test_dequantize_matches_jax():
    b, _ = synth_batch(farmer.scenario_creator, farmer.make_tree(12),
                       farmer.scenario_synth_spec, seed=7)
    fld = quantize_field(b.l, b.l[0], 1e-3)
    rows = np.array([3, 0, 7, 7])
    vidx = np.flatnonzero(fld.varying)
    args_np = (fld.tmpl, fld.varying, fld.q[rows], fld.scale[rows],
               fld.zero[rows])
    want = np.asarray(jax_quant.dequantize(*map(jnp.asarray, args_np),
                                           jnp.float64))
    got = dequantize(*map(torch.as_tensor, args_np), torch.float64)
    assert np.array_equal(got.numpy(), want)
    cols_np = (fld.tmpl, vidx, fld.q[rows][:, vidx], fld.scale[rows],
               fld.zero[rows])
    want_c = np.asarray(jax_quant.dequantize_cols(
        *map(jnp.asarray, cols_np), jnp.float64))
    got_c = dequantize_cols(*map(torch.as_tensor, cols_np), torch.float64)
    assert np.array_equal(got_c.numpy(), want_c)
    assert np.array_equal(got_c.numpy(), _reconstruct_f32(fld, rows))


# ---------------- the pipeline ----------------

def test_chunk_pipeline_inorder_backpressure_stalls_restart(mem_obs):
    staged = []

    def loader(ci):
        # chunk 0 outlasts one 50 ms poll of get: a booked stall
        time.sleep(0.12 if ci == 0 else 0.0)
        staged.append(ci)
        return {"ci": ci}

    pipe = ChunkPipeline(loader, n_chunks=6, depth=2)
    pipe.start_pass()
    got = [pipe.get(ci)["ci"] for ci in range(6)]
    assert got == list(range(6))
    # the consumer outran the loader at least at chunk 0
    assert obs.counters_snapshot().get("stream.prefetch_stalls", 0) >= 1
    # a second pass rewinds; a slow consumer never sees more than depth
    # chunks staged ahead (plus one in flight)
    pipe.start_pass()
    time.sleep(0.3)
    assert len(staged) <= 6 + 2 + 1
    assert pipe.get(0)["ci"] == 0
    with pytest.raises(RuntimeError, match="out of order"):
        pipe.get(2)
    # a restart mid-pass discards the stale pass
    pipe.start_pass()
    assert [pipe.get(ci)["ci"] for ci in range(3)] == [0, 1, 2]
    pipe.close()
    assert not pipe.alive
    pipe.close()                      # idempotent
    with pytest.raises(RuntimeError, match="gone"):
        pipe.get(3)


def test_gated_pass_stages_after_release():
    """A gated pass stages chunk k+1 only after the consumer released
    chunk k, and hands the loader the release's event."""
    seen = []
    lock = threading.Lock()

    def loader(ci, after=None):
        with lock:
            seen.append((ci, after))
        return ci

    pipe = ChunkPipeline(loader, n_chunks=3, depth=2)
    pipe.start_pass(gated=True)
    assert pipe.get(0) == 0
    time.sleep(0.2)
    assert [c for c, _ in seen] == [0]
    pipe.release(0, "ev0")
    assert pipe.get(1) == 1
    pipe.release(1, "ev1")
    assert pipe.get(2) == 2
    assert seen == [(0, None), (1, "ev0"), (2, "ev1")]
    # an ungated pass prefetches depth ahead
    seen.clear()
    pipe.start_pass()
    time.sleep(0.2)
    assert len(seen) >= 2
    pipe.close()


def test_loader_error_surfaces_in_get():
    def loader(ci):
        if ci == 1:
            raise KeyError("boom")
        return ci

    pipe = ChunkPipeline(loader, n_chunks=3)
    pipe.start_pass()
    assert pipe.get(0) == 0
    with pytest.raises(KeyError, match="boom"):
        pipe.get(1)
    pipe.close()


def test_pipeline_stress_restarts_under_fast_switching():
    """Producer and consumer under a 1 us switch interval, 300 passes of
    random length (gated and not, most abandoned early by a restart):
    every get returns the chunk asked for, of the current pass, and
    close() stops the thread."""
    import random
    import sys

    rng = random.Random(0)
    gen = [0]

    def loader(ci, after=None):
        return (gen[0], ci)

    pipe = ChunkPipeline(loader, n_chunks=7, depth=2)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        t_end = time.monotonic() + 30.0
        for p in range(300):
            assert time.monotonic() < t_end
            gen[0] = p
            gated = rng.random() < 0.5
            pipe.start_pass(gated=gated)
            for ci in range(rng.randint(0, 7)):
                g, got = pipe.get(ci)
                assert got == ci and g == p
                if gated:
                    pipe.release(ci)
    finally:
        sys.setswitchinterval(old)
        pipe.close()
    assert not pipe.alive
