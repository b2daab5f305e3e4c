"""Hydro: the reference's 3-stage hydro-thermal scheduling example.

Same model and data as the reference (ref. mpisppy/tests/examples/hydro/
hydro.py, data in PySP/scenariodata/Scen*.dat): 3 stages, 9 scenarios from
branching factors [3, 3]; per-stage thermal generation Pgt, hydro Pgh,
unserved demand PDns, reservoir volume Vol; demand balance, water
conservation with stochastic inflows A, and a terminal future-cost "fcfe"
constraint. Nonants at stage t are (Pgt[t], Pgh[t], PDns[t], Vol[t])
(ref. hydro.py MakeNodesforScen).

Stochastic data: stage-2 inflow A2 in {10, 50, 90}, stage-3 inflow
A3 in {40, 50, 60}; the reference's EF trivial bound is ~180 and PH
Eobjective ~190 (ref. mpisppy/tests/test_ef_ph.py:554-559).
"""

from __future__ import annotations

import numpy as np

from ..ir.model import Model
from ..ir.tree import balanced_tree

T = 3
D = np.array([90.0, 160.0, 110.0])          # demand per stage
BETA_GT, BETA_GH, BETA_DNS = 1.0, 0.0, 10.0
PGT_MAX, PGH_MAX, V_MAX = 100.0, 100.0, 100.0
U = np.array([0.6048, 0.6048, 1.2096])      # conversion factors
DURACION = np.array([168.0, 168.0, 336.0])
V0 = 60.48
T_HOURS = 8760.0
A2_VALUES = [10.0, 50.0, 90.0]
A3_VALUES = [40.0, 50.0, 60.0]
FCFE_COEF = 4166.67

DISCOUNT = (1.0 / 1.1) ** (DURACION / T_HOURS)   # r[t]


def scenario_inflows(scen_one_based: int) -> np.ndarray:
    """Inflow vector A for scenario s in 1..9 (matches Scen{s}.dat)."""
    s = scen_one_based - 1
    return np.array([50.0, A2_VALUES[s // 3], A3_VALUES[s % 3]])


def scenario_creator(scenario_name, branching_factors=None) -> Model:
    snum = int("".join(ch for ch in scenario_name if ch.isdigit()))
    A = scenario_inflows(snum)

    m = Model(scenario_name, sense="min")
    # one var block per stage so the tree can name per-stage nonants
    pgt = [m.var(f"Pgt{t+1}", 1, lb=0.0, ub=PGT_MAX, stage=t + 1) for t in range(T)]
    pgh = [m.var(f"Pgh{t+1}", 1, lb=0.0, ub=PGH_MAX, stage=t + 1) for t in range(T)]
    pdns = [m.var(f"PDns{t+1}", 1, lb=0.0, ub=D[t], stage=t + 1) for t in range(T)]
    vol = [m.var(f"Vol{t+1}", 1, lb=0.0, ub=V_MAX, stage=t + 1) for t in range(T)]
    sl = m.var("sl", 1, lb=0.0, stage=T)

    for t in range(T):
        m.constr(pgt[t] + pgh[t] + pdns[t] == D[t], name=f"demand{t+1}")
        prev = vol[t - 1] if t > 0 else None
        # Vol[t] - Vol[t-1] <= u[t] (A[t] - Pgh[t])
        lhs = vol[t] - prev if prev is not None else vol[t] - V0
        m.constr(lhs + U[t] * pgh[t] <= U[t] * A[t], name=f"conserv{t+1}")
    m.constr(sl + FCFE_COEF * vol[T - 1] >= FCFE_COEF * V0, name="fcfe")

    for t in range(T):
        cost = DISCOUNT[t] * (BETA_GT * pgt[t] + BETA_GH * pgh[t] + BETA_DNS * pdns[t])
        if t == T - 1:
            cost = cost + sl
        m.stage_cost(t + 1, cost)
    return m


def make_tree(branching_factors=(3, 3)):
    BFs = list(branching_factors)
    nonants = [["Pgt1", "Pgh1", "PDns1", "Vol1"],
               ["Pgt2", "Pgh2", "PDns2", "Vol2"]]
    return balanced_tree(BFs, nonant_names_per_stage=nonants,
                         scen_name_fmt="Scen{}")


def scenario_denouement(rank, scenario_name, values):
    pass
