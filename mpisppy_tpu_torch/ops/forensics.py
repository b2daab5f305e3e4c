"""Wheel forensics: the per-iteration convergence-attribution reduction
(the port of the JAX package's ops/forensics.py, as torch ops on the
engine's device).

The hub reduces all convergence signal to ONE scalar (``conv`` in
``core/ph.py``). This module computes the per-slot and per-scenario
attribution on the device as one reduction over the ``(S, K)`` hub
state and packs everything into one small vector, so the host pays
exactly one extra transfer per SAMPLED iteration (riding the
iteration's gate, which has already synced) and ``ph.gate_syncs``
does not move.

Per sample (every ``forensics_interval`` iterations, telemetry on):

- **slot mass** ``m_k = Σ_s p_s · |x_sk − x̄_sk|`` — the prob-weighted
  disagreement carried by nonant slot k. Decomposes the convergence
  scalar exactly: ``conv = Σ_k m_k / K``. Top-k slots by mass are the
  culprit slots.
- **scenario primal share** ``p_s · Σ_k |x_sk − x̄_sk| / Σ`` and
  **scenario dual share** ``p_s · Σ_k |ΔW_sk| / Σ`` — which scenarios
  carry the residual. Mesh pads (zero-probability rows) score −1 and
  can never win a top-k slot over a real scenario.
- **W-oscillation score** — per-slot EMA of the prob-weighted
  sign-flip fraction of ΔW against the previous sample's ΔW.
- **rho health** — per-slot log10 of primal mass vs dual mass
  ``(m_k + ε) / (Σ_s p_s|ΔW_sk| + ε)``, clipped to ±6.
- **xbar movement** — mean per-slot |x̄ − x̄_prev|.

The carried :class:`ForensicState` (prev W, prev ΔW, flip EMA, prev
x̄-by-slot, sample count) lives on the device next to the hub state;
dual/oscillation stats are validity-gated by the sample count so the
first samples never report garbage deltas. Everything here except
:func:`unpack` stays on the device; :func:`unpack` performs the ONE
designed host fetch.

On a sharded mesh (``mesh`` with more than one rank) each rank holds
its rows: the slot sums and totals go through one all-reduce, and each
rank's scenario top-k candidates, carrying global scenario ids, are
gathered and re-ranked, so every rank packs the unsharded sample.

``torch.topk`` does not promise ``jax.lax.top_k``'s order among equal
values (slots at zero mass, pads at −1): the values agree, and the ids
agree wherever the values differ.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

# top-k width for both the slot and scenario leaderboards (callers
# clamp to the actual K / S)
TOPK = 8
# EMA decay for the per-slot sign-flip fraction
FLIP_DECAY = 0.5
_EPS = 1e-12
_HDR = 8          # header scalars in the packed vector


class ForensicState(NamedTuple):
    """Device-resident carry between forensic samples."""

    prev_w: torch.Tensor      # (S, K) W at the previous sample
    prev_dw: torch.Tensor     # (S, K) ΔW of the previous sample
    flip_ema: torch.Tensor    # (K,)  EMA'd sign-flip fraction per slot
    prev_xbar: torch.Tensor   # (K,)  prob-collapsed x̄ at previous sample
    samples: int              # completed samples (validity gate; host)


def init_state(S: int, K: int, dtype=torch.float64,
               device=None) -> ForensicState:
    z = dict(dtype=dtype, device=device)
    return ForensicState(torch.zeros((S, K), **z), torch.zeros((S, K), **z),
                         torch.zeros((K,), **z), torch.zeros((K,), **z), 0)


def packed_size(kk: int, ks: int) -> int:
    """Length of the packed stats vector for top-``kk`` slots and
    top-``ks`` scenarios: 8 header scalars + three slot (id, value)
    blocks + two scenario (id, value) blocks."""
    return _HDR + 6 * kk + 4 * ks


def _top(v, k):
    vals, ids = torch.topk(v, k)
    return vals, ids


def forensic_reduce(state: ForensicState, xn, xbar, w, prob, rho, *,
                    kk: int, ks: int, mesh=None, row_offset: int = 0):
    """One forensic sample over the hub state: returns
    ``(new_state, packed)`` where ``packed`` is the flat device vector
    :func:`unpack` decodes. O(S·K) reductions and a few ``topk`` calls,
    no host read. ``row_offset`` is the global id of this rank's first
    row on a sharded ``mesh``."""
    dtype = xn.dtype
    xbar_full = torch.broadcast_to(xbar, xn.shape)
    adev = torch.abs(xn - xbar_full)                  # (S, K)
    K = xn.shape[1]
    samples = int(state.samples)
    valid_dw = 1.0 if samples >= 1 else 0.0
    valid_flip = 1.0 if samples >= 2 else 0.0

    dw = w - state.prev_w
    dwa = torch.abs(dw)
    flip = ((torch.sign(dw) * torch.sign(state.prev_dw)) < 0).to(dtype)
    pri = prob * torch.sum(adev, dim=1)               # (S,)
    dua = prob * torch.sum(dwa, dim=1) * valid_dw     # (S,)
    # the slot sums and totals: one all-reduce on a mesh
    sums = torch.cat([prob @ adev, prob @ dwa, prob @ flip,
                      prob @ xbar_full, prob @ rho,
                      torch.stack([torch.sum(pri), torch.sum(dua)])])
    if mesh is not None and mesh.size > 1:
        sums = mesh.all_sum(sums)
    slot_mass = sums[:K]
    dua_slot = sums[K:2 * K] * valid_dw
    flip_frac = sums[2 * K:3 * K] * valid_flip
    xbar_slot = sums[3 * K:4 * K]
    rhobar_mean = torch.mean(sums[4 * K:5 * K])
    pri_total, dua_total = sums[5 * K], sums[5 * K + 1]
    conv = pri_total / K

    flip_ema = (FLIP_DECAY * state.flip_ema
                + (1.0 - FLIP_DECAY) * flip_frac) * valid_flip

    log_ratio = torch.log10((slot_mass + _EPS) / (dua_slot + _EPS))
    log_ratio = torch.clamp(log_ratio, -6.0, 6.0) * valid_dw
    ratio_mean = torch.mean(log_ratio)
    xbar_move = torch.mean(torch.abs(xbar_slot - state.prev_xbar)) \
        * valid_dw

    sm_v, sm_i = _top(slot_mass, kk)
    os_v, os_i = _top(flip_ema, kk)
    _, rh_i = _top(torch.abs(log_ratio), kk)
    real = prob > 0
    neg = torch.full_like(pri, -1.0)
    pri_share = torch.where(real, pri / (pri_total + _EPS), neg)
    dua_share = torch.where(real, dua / (dua_total + _EPS), neg)
    S_loc = pri.shape[0]
    kl = min(ks, S_loc)
    ps_v, ps_i = _top(pri_share, kl)
    ds_v, ds_i = _top(dua_share, kl)
    ps_i, ds_i = ps_i + row_offset, ds_i + row_offset
    if mesh is not None and mesh.size > 1:
        # every rank's candidates with global ids, gathered and
        # re-ranked: the unsharded sample's leaderboard
        cand = torch.stack([ps_v, ps_i.to(dtype), ds_v, ds_i.to(dtype)])
        allc = mesh.gather_rows(cand.T.contiguous(), kl * mesh.size).T
        pv, pi = _top(allc[0], ks)
        dv, di = _top(allc[2], ks)
        ps_v, ps_i = pv, allc[1][pi]
        ds_v, ds_i = dv, allc[3][di]

    def f(a):
        return a.to(dtype).reshape(-1)

    one = torch.ones((), dtype=dtype, device=xn.device)
    packed = torch.cat([
        f(one * (samples + 1)), f(conv), f(pri_total), f(dua_total),
        f(torch.mean(flip_ema)), f(ratio_mean), f(xbar_move),
        f(rhobar_mean),
        f(sm_i), f(sm_v),
        f(os_i), f(os_v),
        f(rh_i), f(log_ratio[rh_i]),        # signed, abs-ranked
        f(ps_i), f(ps_v),
        f(ds_i), f(ds_v),
    ])
    new_state = ForensicState(w, dw, flip_ema, xbar_slot, samples + 1)
    return new_state, packed


def unpack(packed, kk: int, ks: int) -> dict:
    """Decode one packed stats vector into the plain host dict the
    diagnosis engine / telemetry record consume. THE designed fetch:
    by record-emission time the iteration already synced ``conv``, so
    this transfers ``packed_size(kk, ks)`` floats without adding a
    pipeline stall."""
    if isinstance(packed, torch.Tensor):
        packed = packed.detach().cpu().numpy()
    v = np.asarray(packed, dtype=np.float64)
    if v.shape != (packed_size(kk, ks),):
        raise ValueError(
            f"packed forensics vector has shape {v.shape}, expected "
            f"({packed_size(kk, ks)},) for kk={kk} ks={ks}")
    o = _HDR
    blocks = {}
    for name in ("slots", "osc_slots", "rho_slots"):
        ids, vals = v[o:o + kk], v[o + kk:o + 2 * kk]
        blocks[name] = (ids, vals)
        o += 2 * kk
    for name in ("scens_pri", "scens_dua"):
        ids, vals = v[o:o + ks], v[o + ks:o + 2 * ks]
        blocks[name] = (ids, vals)
        o += 2 * ks

    def pairs(name, drop_below=None):
        ids, vals = blocks[name]
        out = []
        for i, x in zip(ids, vals):
            if drop_below is not None and x < drop_below:
                continue       # masked pad row (score −1), never real
            out.append([int(i), float(x)])
        return out

    return {
        "samples": int(v[0]),
        "conv": float(v[1]),
        "pri_total": float(v[2]),
        "dua_total": float(v[3]),
        "osc_mean": float(v[4]),
        "rho_log_ratio_mean": float(v[5]),
        "xbar_move": float(v[6]),
        "rho_mean": float(v[7]),
        "top_slots": pairs("slots"),
        "osc_slots": pairs("osc_slots"),
        "rho_slots": pairs("rho_slots"),
        "scen_pri_shares": pairs("scens_pri", drop_below=0.0),
        "scen_dua_shares": pairs("scens_dua", drop_below=0.0),
    }
