"""Battery: hybrid solar-battery storage arbitrage (Singh & Knueven).

Same problem as the reference's battery example (ref. examples/battery/
battery.py:19-90, the Lagrangian relaxation (4) of the chance-constrained
model): sell y_t (first-stage nonant), charge p_t, discharge q_t, state of
charge x_t, and a recourse indicator z; flow balance
x_{t+1} = x_t + eff·p_t − q_t/eff, big-M solar availability
y_t − q_t + p_t <= solar_t(ξ) + M·z, objective
−rev·y + char·Σp + disc·Σq + λ·z. Solar traces are seeded per scenario
instead of read from a file.
"""

from __future__ import annotations

import re

import numpy as np

from ..ir.model import Model
from ..ir.tree import two_stage_tree

DEFAULTS = dict(T=24, eff=0.9, cMax=5.0, dMax=5.0, eMin=1.0, eMax=10.0,
                char=0.1, disc=0.1, lam=100.0, bigM=50.0)


def solar_trace(scennum, T, peak=8.0):
    """Seeded diurnal solar curve with scenario-level cloud noise."""
    rng = np.random.RandomState(3000 + scennum)
    t = np.arange(T)
    clear = peak * np.maximum(0.0, np.sin(np.pi * (t - 6.0) / 12.0))
    cloud = rng.uniform(0.4, 1.0, size=T)
    return clear * cloud


def revenue_prices(T, base_seed=11):
    rng = np.random.RandomState(base_seed)
    return rng.uniform(1.0, 3.0, size=T)


def scenario_creator(scenario_name, T=None, use_LP=True, lam=None,
                     base_seed=11, **over) -> Model:
    cfg = dict(DEFAULTS)
    cfg.update(over)
    if T is not None:
        cfg["T"] = T
    if lam is not None:
        cfg["lam"] = lam
    T = int(cfg["T"])
    scennum = int(re.search(r"(\d+)$", scenario_name).group(1))
    solar = solar_trace(scennum, T)
    rev = revenue_prices(T, base_seed)

    m = Model(scenario_name, sense="min")
    y = m.var("Sell", T, lb=0.0, stage=1)                      # the nonant
    p = m.var("Charge", T, lb=0.0, ub=cfg["cMax"], stage=2)
    q = m.var("Discharge", T, lb=0.0, ub=cfg["dMax"], stage=2)
    x = m.var("StateOfCharge", T, lb=cfg["eMin"], ub=cfg["eMax"], stage=2)
    z = m.var("Recourse", 1, lb=0.0, ub=1.0, integer=not use_LP, stage=2)

    # x_{t+1} = x_t + eff p_t - q_t/eff for t = 0..T-2
    # (ref. battery.py:60-64 flow_balance_constraint_rule)
    shift = np.eye(T)[1:]            # rows select x_{t+1}
    keep = np.eye(T)[:-1]            # rows select x_t
    m.constr((shift @ x) - (keep @ x) - cfg["eff"] * (keep @ p)
             + (1.0 / cfg["eff"]) * (keep @ q) == 0.0, name="FlowBalance")

    # y_t - q_t + p_t <= solar_t + M z (ref. battery.py:67-71)
    onesM = np.full((T, 1), cfg["bigM"])
    m.constr(y - q + p - (onesM @ z) <= solar, name="SolarBigM")

    # first-stage cost is the (negative) revenue on y
    # (ref. battery.py:74-81: obj = -rev.y + char sum p + disc sum q + lam z)
    m.stage_cost(1, y.dot(-rev))
    m.stage_cost(2, cfg["char"] * p.sum() + cfg["disc"] * q.sum()
                 + cfg["lam"] * z.sum())
    return m


def make_tree(num_scens, **_):
    names = [f"Scenario{i}" for i in range(num_scens)]
    return two_stage_tree(names, nonant_names=["Sell"])


def scenario_denouement(rank, scenario_name, values):
    pass
