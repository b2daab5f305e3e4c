"""ccopf: 4-stage DC optimal power flow under demand uncertainty.

The acopf3-class multistage stress model (ref. examples/acopf3/
ccopf2wood.py, fourstage.py, ACtree.py: a 4-stage chance-constrained
AC-OPF on small networks via egret). The TPU-native analog keeps the
structure that stresses the framework — a FOUR-stage tree (branching
2×2×2 = 8 scenarios by default), per-stage nonanticipative generator
setpoints, network flow physics, ramping that couples stages, and a
QUADRATIC generation cost (exercising the kernel's P_diag path) — on a
deterministic 5-bus DC network instead of egret's AC data files.

  min  Σ_t [ Σ_g (a_g·gen²  + b_g·gen) + VOLL·Σ_b shed ]
  s.t. per stage t:  A_gᵀ gen_t − d_t^s + shed_t = B_bus θ_t   (balance)
       |θ_i − θ_j|/x_l ≤ cap_l                                (flow limits)
       |gen_t − gen_{t−1}| ≤ ramp                             (t ≥ 2)
       θ_ref = 0,   0 ≤ gen ≤ gmax,   0 ≤ shed ≤ d_t^s

Nonants: Gen1..Gen3 (stages 1..3); stage 4 is pure recourse. Demand
scales along the tree-node path, so only the rhs varies per scenario and
the shared-structure kernel path applies.
"""

from __future__ import annotations

import re

import numpy as np

from ..ir.model import Model
from ..ir.tree import balanced_tree

NBUS = 5
# lines: (from, to, reactance, capacity) — ring + two chords
LINES = [(0, 1, 0.2, 120.0), (1, 2, 0.25, 100.0), (2, 3, 0.2, 110.0),
         (3, 4, 0.3, 90.0), (4, 0, 0.25, 120.0), (0, 2, 0.4, 80.0),
         (1, 3, 0.5, 70.0)]
NL = len(LINES)
# generators: (bus, gmax, a_quad, b_lin, ramp)
GENS = [(0, 180.0, 0.020, 18.0, 60.0), (2, 140.0, 0.035, 24.0, 50.0),
        (4, 100.0, 0.055, 32.0, 40.0)]
NG = len(GENS)
BASE_DEMAND = np.array([38.0, 58.0, 46.0, 66.0, 34.0])
STAGE_SHAPE = np.array([0.9, 1.0, 1.15, 1.05])   # diurnal-ish profile
VOLL = 2000.0
T = 4


def _network():
    inc = np.zeros((NL, NBUS))       # line-bus incidence
    binv = np.zeros(NL)
    cap = np.zeros(NL)
    for i, (a, b, xr, cp) in enumerate(LINES):
        inc[i, a] = 1.0
        inc[i, b] = -1.0
        binv[i] = 1.0 / xr
        cap[i] = cp
    Bbus = inc.T @ np.diag(binv) @ inc
    Ag = np.zeros((NBUS, NG))
    for j, (bus, *_rest) in enumerate(GENS):
        Ag[bus, j] = 1.0
    return inc, binv, cap, Bbus, Ag


def demand_path(scennum: int, branching=(2, 2, 2)):
    """Per-stage demand multipliers along the scenario's node path
    (stage 1 is common). Branch digit d of a b-way node moves demand by
    a multiplier spread EVENLY over [+10%, -10%] — d=0 is +10%, d=b-1
    is -10%, intermediate digits interpolate — so every sibling node
    carries DISTINCT demand data at any branching factor (a constant
    per-digit move would collapse b>2 siblings into duplicates)."""
    mults = [1.0]
    digits = []
    s = scennum
    for b in reversed(branching):
        digits.append((s % b, b))
        s //= b
    digits = digits[::-1]
    level = 1.0
    for d, b in digits:
        move = 0.10 if b <= 1 else 0.10 * (1.0 - 2.0 * d / (b - 1))
        level *= 1.0 + move
        mults.append(level)
    return np.asarray(mults)          # (T,) with mults[0] = 1.0


def scenario_creator(scenario_name, branching=(2, 2, 2)) -> Model:
    scennum = int(re.search(r"(\d+)$", scenario_name).group(1)) - 1
    inc, binv, cap, Bbus, Ag = _network()
    mults = demand_path(scennum, branching)

    m = Model(scenario_name, sense="min")
    gens, thetas, sheds = [], [], []
    for t in range(1, T + 1):
        g = m.var(f"Gen{t}", NG, lb=0.0,
                  ub=np.array([gm for _, gm, *_ in GENS]), stage=t)
        th = m.var(f"Theta{t}", NBUS, lb=-np.pi, ub=np.pi, stage=t)
        d_t = BASE_DEMAND * STAGE_SHAPE[t - 1] * mults[t - 1]
        sh = m.var(f"Shed{t}", NBUS, lb=0.0, ub=d_t, stage=t)
        gens.append(g)
        thetas.append(th)
        sheds.append(sh)
        # bus balance: Ag g − Bbus θ + shed = d
        m.constr((Ag @ g) - (Bbus @ th) + sh == d_t, name=f"Balance{t}")
        # reference angle
        ref = np.zeros((1, NBUS))
        ref[0, 0] = 1.0
        m.constr((ref @ th) == 0.0, name=f"RefAngle{t}")
        # line flow limits: |diag(binv) inc θ| ≤ cap
        F = np.diag(binv) @ inc
        m.constr((F @ th) <= cap, name=f"FlowUB{t}")
        m.constr((F @ th) >= -cap, name=f"FlowLB{t}")
        # ramping couples consecutive stages
        if t > 1:
            ramp = np.array([r for *_x, r in GENS])
            m.constr(g - gens[t - 2] <= ramp, name=f"RampUp{t}")
            m.constr(g - gens[t - 2] >= -ramp, name=f"RampDn{t}")
        # costs: quadratic + linear generation, VOLL shedding
        a = np.array([aq for _, _, aq, _, _ in GENS])
        b = np.array([bl for _, _, _, bl, _ in GENS])
        m.quad_cost(g, 2.0 * a)
        m.stage_cost(t, g.dot(b) + VOLL * sh.sum())
    return m


def make_tree(branching=(2, 2, 2)):
    """4-stage balanced tree; nonants are the stage-1..3 gen setpoints
    (stage-4 decisions are leaf recourse)."""
    return balanced_tree(list(branching),
                         [["Gen1"], ["Gen2"], ["Gen3"]],
                         scen_name_fmt="CCopf{}")


def scenario_denouement(*args, **kwargs):
    pass
