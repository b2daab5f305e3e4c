"""int8 packed-block storage for streamed scenario vectors (the port of
mpisppy_tpu/stream/quant.py: the host half copied, the device half as
torch ops).

The streamed scenario source (stream/source.py) holds the per-scenario
vector blocks (l/u/lb/ub/c) on the host and ships one chunk at a time;
int8 packing quarters those bytes, host residency and the H2D wire.

Representation: per (scenario row, field) block, the stored value is
the int8-quantized DELTA from the field's template row with a
per-block scale/zero-point:

    value[s, j] = template[j] + scale[s] * q[s, j] + zero[s]

Scenario randomness perturbs a few entries of a shared template, so
deltas are small and mostly zero; an unperturbed row stores scale = 0
exactly (bit-exact roundtrip).

Quantization changes the problem data, so it is guarded twice:

- the gate (``quantize_field``) measures the worst per-entry
  reconstruction error on the host, reproducing the device's f32
  dequantization arithmetic exactly; a too-coarse block keeps
  full-precision host storage and books ``stream.int8_fallbacks``;
- int8 packing is an explicit opt-in (``stream_int8``), never engaged
  by ``scenario_source='streamed'`` alone.

Non-finite entries (±inf bounds) must come from the template: a
scenario whose non-finite pattern differs from the template's is
rejected by the gate.

Dequantization (``dequantize`` / ``dequantize_cols``) runs on the
engine's device: the scale/zero arithmetic is pinned to f32 (the
storage precision) and only the final template add runs in the engine
dtype.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class Int8Field(NamedTuple):
    """Host-side packed storage of one (S, w) field: template row +
    per-scenario-block int8 deltas over the VARYING columns. Columns
    no scenario ever perturbs are excluded from the block range (the
    ``varying`` mask) and reconstruct as the template exactly."""
    tmpl: np.ndarray       # (w,) f64 template row (non-finites live here)
    varying: np.ndarray    # (w,) bool: columns with any nonzero delta
    q: np.ndarray          # (S, w) int8 quantized deltas
    scale: np.ndarray      # (S, 1) f32 per-block scale
    zero: np.ndarray       # (S, 1) f32 per-block zero-point

    @property
    def nbytes(self) -> int:
        return (self.q.nbytes + self.scale.nbytes + self.zero.nbytes
                + self.varying.nbytes)


def _reconstruct_f32(fld: Int8Field, rows) -> np.ndarray:
    """Host twin of the device dequantization (f32 scale/zero arithmetic
    over the varying columns, template add in f64), so the gate
    measures exactly the values the solver will see."""
    delta = (fld.scale[rows] * fld.q[rows].astype(np.float32)
             + fld.zero[rows]).astype(np.float64)
    delta = np.where(fld.varying[None, :], delta, 0.0)
    with np.errstate(invalid="ignore"):   # ±inf template entries
        return fld.tmpl[None, :] + delta


def quantize_field(a, tmpl, tol: float):
    """Gate + pack one (S, w) host field against its template row.
    Returns an :class:`Int8Field`, or ``None`` when the block set fails
    the gate (worst per-entry reconstruction error above ``tol``
    relative to 1 + |value|, or a non-finite pattern differing from the
    template's)."""
    a = np.asarray(a, np.float64)
    tmpl = np.asarray(tmpl, np.float64)
    finite_t = np.isfinite(tmpl)
    if (np.isfinite(a) != finite_t[None, :]).any():
        return None
    with np.errstate(invalid="ignore"):   # inf - inf at non-finite
        delta = np.where(finite_t[None, :], a - tmpl[None, :], 0.0)
    varying = (delta != 0.0).any(axis=0)
    if varying.any():
        dv = delta[:, varying]
        dmin = dv.min(axis=1, keepdims=True)
        dmax = dv.max(axis=1, keepdims=True)
    else:
        dmin = dmax = np.zeros((a.shape[0], 1))
    zero = ((dmax + dmin) / 2.0).astype(np.float32)
    scale = ((dmax - dmin) / 254.0).astype(np.float32)
    safe = np.where(scale > 0, scale, 1.0).astype(np.float64)
    q = np.clip(np.rint((delta - zero.astype(np.float64)) / safe),
                -127, 127).astype(np.int8)
    q = np.where(varying[None, :], q, 0).astype(np.int8)
    fld = Int8Field(tmpl=tmpl, varying=varying, q=q, scale=scale,
                    zero=zero)
    recon = _reconstruct_f32(fld, slice(None))
    with np.errstate(invalid="ignore"):   # inf - inf at non-finite
        err = np.abs(np.where(finite_t[None, :], recon - a, 0.0)) \
            / (1.0 + np.abs(np.where(finite_t[None, :], a, 0.0)))
    if float(err.max(initial=0.0)) > tol:
        return None
    return fld


def dequantize(tmpl_dev, varying_dev, q_dev, scale_dev, zero_dev, dtype):
    """Device dequantization of one shipped chunk: f32 scale/zero
    arithmetic over the varying columns, template add in ``dtype``."""
    delta = scale_dev * q_dev.to(torch.float32) + zero_dev
    delta = torch.where(varying_dev[None, :], delta,
                        torch.zeros((), dtype=torch.float32,
                                    device=delta.device))
    return tmpl_dev.to(dtype)[None, :] + delta.to(dtype)


def dequantize_cols(tmpl_dev, vidx_dev, qv_dev, scale_dev, zero_dev,
                    dtype):
    """Varying-columns-only dequantization: the wire carries q over the
    varying columns alone (``qv = q[:, varying]``) and the deltas land
    on a broadcast template row. The same arithmetic as
    :func:`dequantize` on the varying columns; the other columns are
    the template verbatim."""
    delta = scale_dev * qv_dev.to(torch.float32) + zero_dev
    rows = qv_dev.shape[0]
    base = tmpl_dev.to(dtype)[None, :].expand(rows, tmpl_dev.shape[0])
    return base.index_add(1, vidx_dev.to(torch.int64), delta.to(dtype))
