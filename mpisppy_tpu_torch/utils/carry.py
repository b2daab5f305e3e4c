"""State carried into a port engine from elsewhere — the JAX package's
arrays as numpy, for instance — so both packages can start the same PH
iteration from the same state.

``from_numpy_state(engine, arrays, device)`` installs, each when its
key is present:
  batch vectors  ``c``, ``l``, ``u``, ``lb``, ``ub`` (S, ·);
  PH state       ``W``, ``xbar``, ``rho`` (S, K) — a new ``rho``
                 invalidates the prox-on factors, as a rho setter does;
  solver state   ``qp_state``: {``x``, ``yA``, ``yB``, ``zA``, ``zB``,
                 ``F`` (the solve operator), ``rho_scale``} for the
                 mode ``prox_on`` (default True);
  chunk states   ``chunks``: a list of such dicts, one per chunk of the
                 engine's ``subproblem_chunk`` layout, each optionally
                 with ``pri_res``/``dua_res``/``pri_rel``/``dua_rel``
                 (infinite when absent), installed under
                 the engine's per-chunk store for ``prox_on``, with
                 the concatenated view as its solver state;
  blacklists     ``chunk_no_retry`` (chunk numbers),
                 ``hospital_no_retry`` (scenario ids) and
                 ``blacklist_calls`` (solves of the mode so far).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..ops.qp_solver import QPState


def _t(a, engine, device):
    return torch.tensor(np.asarray(a), dtype=engine.dtype, device=device)


def from_numpy_state(engine, arrays: dict, device=None, prox_on=True):
    """Install ``arrays`` (numpy) into ``engine`` on ``device`` (the
    engine's device when None). Returns the engine."""
    dev = engine.device if device is None else torch.device(device)
    key = bool(prox_on)
    d = engine.qp_data
    vec = {k: _t(arrays[k], engine, dev)
           for k in ("l", "u", "lb", "ub") if k in arrays}
    if vec:
        engine.qp_data = d._replace(**vec)
        engine._factors.clear()
        engine._kernel_plans.clear()
    if "c" in arrays:
        engine.c = _t(arrays["c"], engine, dev)
    for k in ("W", "xbar"):
        if k in arrays:
            setattr(engine, k, _t(arrays[k], engine, dev))
    if "rho" in arrays:
        engine.rho = _t(arrays["rho"], engine, dev)
        engine.invalidate_factors()
    if "qp_state" in arrays:
        src = arrays["qp_state"]
        st = engine._ensure_state(prox_on)
        st = st._replace(
            **{k: _t(src[k], engine, dev)
               for k in ("x", "yA", "yB", "zA", "zB", "rho_scale")},
            L=_t(src["F"], engine, dev))
        engine._qp_states[key] = st
    if "chunks" in arrays:
        from ..core.ph import _ChunkStateView
        slices = engine._chunk_index(
            int(engine.options.get("subproblem_chunk", 0)))
        if len(arrays["chunks"]) != len(slices):
            raise ValueError(f"{len(arrays['chunks'])} chunk states for "
                             f"a layout of {len(slices)} chunks")
        states = []
        for src in arrays["chunks"]:
            rows = np.asarray(src["x"]).shape[0]
            states.append(QPState(
                L=_t(src["F"], engine, dev), iters=0,
                **{k: _t(src[k], engine, dev)
                   for k in ("x", "yA", "yB", "zA", "zB", "rho_scale")},
                **{k: _t(src[k] if k in src else np.full(rows, math.inf),
                         engine, dev)
                   for k in ("pri_res", "dua_res", "pri_rel", "dua_rel")}))
        engine._chunk_states[key] = states
        engine._qp_states[key] = _ChunkStateView(
            states, [real for _, real in slices])
    for name, attr in (("chunk_no_retry", "_chunk_no_retry"),
                       ("hospital_no_retry", "_hospital_no_retry")):
        if name in arrays:
            getattr(engine, attr)[key] = {int(v) for v in arrays[name]}
    if "blacklist_calls" in arrays:
        engine._blacklist_calls[key] = int(arrays["blacklist_calls"])
    return engine
