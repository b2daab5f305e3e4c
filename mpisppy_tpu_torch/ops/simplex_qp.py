"""Batched simplex-constrained QP solver (FWPH's per-scenario weight QP;
the port of the JAX package's ops/simplex_qp.py).

FWPH keeps, per scenario, a convex-combination QP over the subproblem
solutions found so far ("columns"): the reference builds a Pyomo QP with
weight vars `a` and x = Σ a_j x_j links (ref. mpisppy/fwph/fwph.py:
691-777, :943-987). With the x variables eliminated (x = aᵀX, X the
(C, n) column stack) it is a C-dimensional QP over the probability
simplex per scenario:

    min_a  b·a + w·(aG) + (ρ/2)‖aG − x̄‖²    s.t. a ≥ 0, Σa = 1

with G = X[:, nonant] (C, K) and b = X c the per-column base costs. C is
a small fixed pad (the rolling column buffer), so the solve batches over
scenarios as (S, C) / (S, C, K) tensors: accelerated projected gradient,
a few hundred small batched products. The loop never reads a device
value on the host: the FISTA momentum does not depend on the data and
stays a host float.
"""

from __future__ import annotations

import math

import torch


def project_simplex(v):
    """Batched Euclidean projection onto the probability simplex
    (Held et al.; sort-based). v: (..., C)."""
    C = v.shape[-1]
    mu = torch.sort(v, dim=-1, descending=True).values
    cssv = torch.cumsum(mu, dim=-1) - 1.0
    rho_idx = torch.arange(1, C + 1, dtype=v.dtype, device=v.device)
    cond = mu - cssv / rho_idx > 0
    k = torch.sum(cond, dim=-1, keepdim=True)   # number of positive coords
    tau = torch.gather(cssv, -1, k - 1) / k
    return torch.clamp(v - tau, min=0.0)


def simplex_qp_solve(G, b, w, rho, xbar, a0, iters=300):
    """Solve the weight QP for every scenario.

    G: (S, C, K) column nonant blocks; b: (S, C) base costs; w: (S, K)
    dual weights; rho: (S, K); xbar: (S, K) prox center; a0: (S, C) warm
    start. Returns (a, xn) with xn = aG the QP-optimal nonant values.

    FISTA with a per-scenario Lipschitz bound L = ‖G diag(ρ) Gᵀ‖_F; the
    objective is smooth, so acceleration gives 1/t² decay.
    """
    # gradient: ∇ = b + G(w − ρ x̄) + G diag(ρ) Gᵀ a
    lin = b + (G @ (w - rho * xbar).unsqueeze(-1)).squeeze(-1)  # (S, C)
    H = (G * rho.unsqueeze(1)) @ G.transpose(1, 2)              # (S, C, C)
    L = torch.sqrt(torch.sum(H * H, dim=(1, 2))) + 1e-12        # (S,)
    step = (1.0 / L).unsqueeze(-1)
    a, y, t = a0, a0, 1.0
    for _ in range(int(iters)):
        grad = lin + (H @ y.unsqueeze(-1)).squeeze(-1)
        a_new = project_simplex(y - step * grad)
        t_new = 0.5 * (1.0 + math.sqrt(1.0 + 4.0 * t * t))
        y = a_new + ((t - 1.0) / t_new) * (a_new - a)
        a, t = a_new, t_new
    xn = (a.unsqueeze(1) @ G).squeeze(1)
    return a, xn


def qp_objective_value(G, b, w, rho, xbar, a):
    """φ(a) per scenario (for Γ calculations)."""
    xn = (a.unsqueeze(1) @ G).squeeze(1)
    return (torch.sum(b * a, dim=-1) + torch.sum(w * xn, dim=-1)
            + 0.5 * torch.sum(rho * (xn - xbar) ** 2, dim=-1))
