"""A counter-based generator with jax.random's semantics, as torch ops.

The synthesized scenario source (stream/source.py) and the models'
synth specs draw each scenario's perturbations from
``fold_in(PRNGKey(seed), scenario_id)``. The JAX package does that with
``jax.random``; this module gives the same draws without jax, so a
synth family means the same data in both packages:

- ``threefry2x32``: the Threefry-2x32 hash (20 rounds, jax's rotation
  schedule and key-injection order);
- ``prng_key(seed)``: the raw key (seed >> 32, seed & 0xFFFFFFFF);
- ``fold_in(key, ids)``: threefry of the counter pair (0, id) under
  the key, vectorized over a tensor of ids;
- ``random_bits`` / ``uniform`` / ``normal``, f64 as under jax's x64
  mode, in its partitionable layout (``jax_threefry_partitionable=
  True``): element i of a draw of shape ``shape`` hashes the 64-bit
  counter i split into (hi, lo) words, and its 64 bits are
  (y0 << 32) | y1. ``uniform`` keeps the top 52 bits under the exponent
  of 1.0 and subtracts 1 (then scales into [minval, maxval) and clamps
  at minval); ``normal`` is sqrt(2) * erfinv(uniform(nextafter(-1, 0),
  1)).

uint32 words live in int64 tensors masked to 32 bits (torch has no
unsigned 32-bit arithmetic on every device). The integer work is exact
everywhere, so keys, bits and uniforms agree bit for bit with jax on
the CPU and on CUDA; ``normal`` goes through ``torch.special.erfinv``,
which is not XLA's erf_inv, and agrees to a few units in the last
place (tests/test_torch_stream_prng.py states the bar).
"""

from __future__ import annotations

import math

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 of the counter words (x0, x1) under the key words
    (k0, k1): int64 tensors holding uint32 values, broadcast against
    each other. Returns the two output words."""
    ks = (k0, k1, (k0 ^ k1) ^ _PARITY)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def prng_key(seed: int, device=None) -> torch.Tensor:
    """jax.random.PRNGKey(seed) as a (2,) int64 tensor of uint32
    words: (seed >> 32, seed & 0xFFFFFFFF), two's complement for a
    negative seed."""
    s = int(seed) & 0xFFFFFFFFFFFFFFFF
    return torch.tensor([s >> 32, s & _M32], dtype=torch.int64,
                        device=device)


def fold_in(key: torch.Tensor, ids) -> torch.Tensor:
    """jax.random.fold_in(key, id) for every id of ``ids`` (a tensor or
    array of integers, taken mod 2^32 as jax's uint32 cast does): the
    (B, 2) folded keys, on ``key``'s device."""
    ids = torch.as_tensor(ids, device=key.device).to(torch.int64) & _M32
    zero = torch.zeros_like(ids)
    y0, y1 = threefry2x32(key[..., 0:1].squeeze(-1),
                          key[..., 1:2].squeeze(-1), zero, ids)
    return torch.stack([y0, y1], dim=-1)


def _counter_words(shape, device):
    """The (hi, lo) words of the flat 64-bit iota over ``shape``."""
    size = math.prod(shape)
    i = torch.arange(size, dtype=torch.int64, device=device)
    return (i >> 32).reshape(shape), (i & _M32).reshape(shape)


def _hash_keys(keys, shape):
    """(y0, y1) of shape (B, *shape) for (B, 2) keys."""
    hi, lo = _counter_words(tuple(shape), keys.device)
    ex = (slice(None),) + (None,) * len(shape)
    return threefry2x32(keys[:, 0][ex], keys[:, 1][ex], hi[None],
                        lo[None])


def random_bits(keys: torch.Tensor, shape):
    """jax.random.bits per key, 64 bits wide: the (hi, lo) uint32 words
    of each (B, *shape) draw (a uint64 does not fit an int64)."""
    return _hash_keys(keys, shape)


def uniform(keys: torch.Tensor, shape, minval=0.0,
            maxval=1.0) -> torch.Tensor:
    """jax.random.uniform per key: (B, *shape) f64 values in
    [minval, maxval)."""
    hi, lo = random_bits(keys, shape)
    # the top 52 bits of (hi << 32 | lo), under 1.0's exponent
    fb = (hi << 20) | (lo >> 12) | 0x3FF0000000000000
    floats = fb.view(torch.float64) - 1.0
    lo_v = torch.as_tensor(minval, dtype=torch.float64, device=keys.device)
    hi_v = torch.as_tensor(maxval, dtype=torch.float64, device=keys.device)
    return torch.maximum(lo_v, floats * (hi_v - lo_v) + lo_v)


def normal(keys: torch.Tensor, shape) -> torch.Tensor:
    """jax.random.normal per key: sqrt(2) * erfinv(u), u f64 uniform on
    [nextafter(-1, 0), 1)."""
    u = uniform(keys, shape, float(np.nextafter(-1.0, 0.0)), 1.0)
    return torch.special.erfinv(u) * float(np.sqrt(2.0))
