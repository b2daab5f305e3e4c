"""Device-side φ-dispatch for APH (the port of the JAX package's
ops/dispatch.py).

The reference's APH worker re-ranks its scenario pool on the host every
iteration: most-negative post-step φ first, least-recently-dispatched
fill for the shortfall (ref. mpisppy/opt/aph.py:592-640 _dispatch_list).
Here the selection runs on the engine's device as plain torch ops:

- :func:`dispatch_select`: both pools and their tie-breaks are one
  lexicographic INTEGER key (group, rank) sorted by two stable argsorts
  (an LSD radix), so the mask is bit-identical to the reference's host
  sorts, tie order included;
- :func:`dispatch_gate` / :func:`scalar_gate`: every scalar the host
  loop reads (τ, φ, θ, conv and the φ stats) and the dispatch mask ride
  ONE device vector, read by one device-to-host copy per iteration
  (``aph.gate_syncs``);
- :func:`gather_rows` / :func:`scatter_rows`: the dispatch layout's row
  moves. Chunk pads repeat the last id and carry equal values, so a
  scatter with duplicate indices is deterministic in value.

The JAX package's dispatch-bucket registry (``dispatch.bucket.*``)
counts jit compiles per dispatch shape; torch compiles nothing per
shape, so the port keeps no such registry. What a dispatch pass does
hold per width is the engine's row store (core/ph ``_dispatch_store``).
"""

from __future__ import annotations

import torch

from .. import obs

GATE_HEAD = 7   # scalar head width of both gate spellings


def dispatch_select(phis, last_dispatch, scnt: int, S_real: int):
    """The ``scnt`` most-negative-φ scenarios, then least-recently-
    dispatched fill, as a boolean (S,) mask on ``phis``' device.

    Selection = the first ``scnt`` rows of the ascending lexicographic
    order of (group, rank, index):
      group 0: real rows with φ < 0, ranked by ascending φ;
      group 1: the other real rows, ranked by ``last_dispatch``;
      group 2: zero-probability pad rows (never dispatched).
    Two stable argsorts implement the radix: by the secondary rank, then
    stably by group; stability makes the index the final tie-break, as
    in the host reference's stable fill sort."""
    S = phis.shape[0]
    dev = phis.device
    idx = torch.arange(S, device=dev)
    real = idx < S_real
    neg = (phis < 0) & real
    group = torch.where(neg, 0, torch.where(real, 1, 2))
    # ascending-φ rank within the negative pool (inverse permutation of
    # a stable argsort; rows outside the pool sort last through +inf)
    p = torch.argsort(torch.where(neg, phis, torch.inf), stable=True)
    phi_rank = torch.empty_like(idx).scatter_(0, p, idx)
    sec = torch.where(neg, phi_rank,
                      torch.as_tensor(last_dispatch, device=dev).long())
    perm1 = torch.argsort(sec, stable=True)
    order = perm1[torch.argsort(group[perm1], stable=True)]
    mask = torch.zeros(S, dtype=torch.bool, device=dev)
    mask[order[:scnt]] = True
    return mask


def _head(tau, phi, theta, conv, phis, S_real):
    """[τ, φ, θ, conv, φ_min, φ_max, φ_neg count] in ``phis``' dtype.
    The φ stats cover the real rows only (pad rows carry φ ≡ 0)."""
    pr = phis[:S_real]
    scal = torch.stack([torch.as_tensor(v, dtype=phis.dtype,
                                        device=phis.device)
                        for v in (tau, phi, theta, conv)])
    stats = torch.stack([pr.min(), pr.max(), (pr < 0).sum().to(pr.dtype)])
    return torch.cat([scal, stats])


def _profiled(entry, fn, phis, reads, writes):
    """``fn()``, booked on the measured roofline (obs/profile.py) as an
    (S,)-row op of ``reads`` inputs and ``writes`` outputs when
    telemetry is on."""
    if not obs.enabled():
        return fn()
    from ..obs import profile as _profile
    S = int(phis.shape[0])
    return _profile.call(
        entry, fn, lambda _: ((S,), *_profile.elementwise(
            S, reads, writes, itemsize=phis.element_size())),
        device=phis.device)


def dispatch_gate(tau, phi, theta, conv, phis, last_dispatch, scnt: int,
                  S_real: int):
    """One packed device row for APH's per-iteration host read:
    ``[τ, φ, θ, conv, φ_min, φ_max, φ_neg_count] ++ mask``."""
    def gate():
        mask = dispatch_select(phis, last_dispatch, scnt, S_real)
        return torch.cat([_head(tau, phi, theta, conv, phis, S_real),
                          mask.to(phis.dtype)])
    return _profiled("aph.dispatch_gate", gate, phis, 2, 1)


def scalar_gate(tau, phi, theta, conv, phis, S_real: int):
    """The full-dispatch twin of :func:`dispatch_gate`: every real row
    dispatches, so only the scalar head ships."""
    return _profiled("aph.scalar_gate",
                     lambda: _head(tau, phi, theta, conv, phis, S_real),
                     phis, 1, 0)


def gather_rows(full, idx):
    """Rows ``idx`` of ``full`` (a new tensor)."""
    return full.index_select(0, idx)


def scatter_rows(full, idx, rows):
    """``full`` with rows ``idx`` replaced by ``rows``, as a new tensor.
    Duplicate ids must carry equal rows (the chunk-pad convention)."""
    return full.index_copy(0, idx, rows)
