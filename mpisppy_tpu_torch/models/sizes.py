"""SIZES: two-stage production-sizing MIP (Løkketangen & Woodruff 1996).

Same problem data as the reference's test fixture (ref. mpisppy/tests/
examples/sizes/ReferenceModel.py:24-200 and SIZES3/SIZES10 .dat files):
10 product sizes, capacity 200000, setup cost 453, unit production cost
0.748 + 0.0104·(i−1), cut-down cost 0.008; scenario s scales the
second-stage demands by a multiplier (3-scenario set: {0.7, 1.0, 1.3};
10-scenario set: {0.5..1.5}\\{1.0}), equally likely.

First-stage nonants are NumProducedFirstStage and NumUnitsCutFirstStage
(ref. tests/examples/sizes/sizes.py:26-27 varlist).
"""

from __future__ import annotations

import re

import numpy as np

from ..ir.model import Model
from ..ir.tree import two_stage_tree

NUM_SIZES = 10
CAPACITY = 200000.0
DEMANDS_FIRST = np.array([2500, 7500, 12500, 10000, 35000,
                          25000, 15000, 12500, 12500, 5000], dtype=np.float64)
UNIT_COST = 0.748 + 0.0104 * np.arange(NUM_SIZES)
SETUP_COST = np.full(NUM_SIZES, 453.0)
UNIT_REDUCTION_COST = 0.008

MULT3 = [0.7, 1.0, 1.3]
MULT10 = [0.5, 0.6, 0.7, 0.8, 0.9, 1.1, 1.2, 1.3, 1.4, 1.5]

# (i, j) pairs with i >= j (0-based): units of size i cut down to size j
PAIRS = [(i, j) for i in range(NUM_SIZES) for j in range(i + 1)]
NP = len(PAIRS)
# D_cut[j, p] = 1 iff pair p supplies size j;  I_cut[i, p] = 1 iff pair p
# consumes inventory of size i;  offdiag[p] = 1 iff i != j (cut cost)
D_CUT = np.zeros((NUM_SIZES, NP))
I_CUT = np.zeros((NUM_SIZES, NP))
OFFDIAG = np.zeros(NP)
for p, (i, j) in enumerate(PAIRS):
    D_CUT[j, p] = 1.0
    I_CUT[i, p] = 1.0
    if i != j:
        OFFDIAG[p] = 1.0


def demand_multiplier(scennum: int, scenario_count: int) -> float:
    mults = MULT3 if scenario_count == 3 else MULT10
    return mults[scennum % len(mults)]


def scenario_creator(scenario_name, scenario_count=3) -> Model:
    """ref. tests/examples/sizes/sizes.py:7 (scenario_count in {3, 10})."""
    if scenario_count not in (3, 10):
        raise ValueError("sizes scenario count must be 3 or 10")
    scennum = int(re.search(r"(\d+)$", scenario_name).group(1))
    mults = MULT3 if scenario_count == 3 else MULT10
    d2 = DEMANDS_FIRST * demand_multiplier(scennum, scenario_count)

    # Demand-implied bound strengthening (valid tightening; the optimum is
    # unchanged — producing or cutting beyond total possible demand only
    # adds cost). Size i can only supply sizes j <= i, so the useful
    # production of size i is capped by the cumulative demand of sizes
    # <= i over both stages; a cut pair (i, j) is capped by size j's
    # demand. This replaces the reference's loose CAPACITY big-M with a
    # per-size big-M that HiGHS's B&B prunes orders of magnitude faster.
    # The 1.5 slack factor keeps the caps from sitting exactly on the
    # covering rows (exactly-tight boxes make the LP degenerate, which
    # stalls the first-order ADMM kernel); B&B pruning only needs the
    # order of magnitude.
    SLACK = 1.5
    d2_max = DEMANDS_FIRST * max(mults)
    ub_made1 = np.minimum(CAPACITY, SLACK * np.cumsum(DEMANDS_FIRST + d2_max))
    ub_made2 = np.minimum(CAPACITY, SLACK * np.cumsum(d2))
    ub_cut1 = SLACK * np.array([DEMANDS_FIRST[j] for (_, j) in PAIRS])
    ub_cut2 = SLACK * np.array([d2[j] for (_, j) in PAIRS])

    m = Model(scenario_name, sense="min")
    produce1 = m.var("ProduceSizeFirstStage", NUM_SIZES, lb=0.0, ub=1.0,
                     integer=True, stage=1)
    produce2 = m.var("ProduceSizeSecondStage", NUM_SIZES, lb=0.0, ub=1.0,
                     integer=True, stage=2)
    made1 = m.var("NumProducedFirstStage", NUM_SIZES, lb=0.0, ub=ub_made1,
                  integer=True, stage=1)
    made2 = m.var("NumProducedSecondStage", NUM_SIZES, lb=0.0, ub=ub_made2,
                  integer=True, stage=2)
    cut1 = m.var("NumUnitsCutFirstStage", NP, lb=0.0, ub=ub_cut1,
                 integer=True, stage=1)
    cut2 = m.var("NumUnitsCutSecondStage", NP, lb=0.0, ub=ub_cut2,
                 integer=True, stage=2)

    # demand satisfaction (ref. ReferenceModel.py:97-104)
    m.constr(D_CUT @ cut1 >= DEMANDS_FIRST, name="DemandSatisfiedFirstStage")
    m.constr(D_CUT @ cut2 >= d2, name="DemandSatisfiedSecondStage")
    # big-M setup enforcement (ref. :107-115), with the tightened M
    m.constr(made1 - ub_made1 * produce1 <= 0.0,
             name="EnforceProductionBinaryFirstStage")
    m.constr(made2 - ub_made2 * produce2 <= 0.0,
             name="EnforceProductionBinarySecondStage")
    # per-stage capacity (ref. :118-125)
    m.constr(made1.sum() <= CAPACITY, name="EnforceCapacityLimitFirstStage")
    m.constr(made2.sum() <= CAPACITY, name="EnforceCapacityLimitSecondStage")
    # inventory conservation (ref. :128-141): cuts from size i can't exceed
    # what has been produced at size i so far
    m.constr(I_CUT @ cut1 - made1 <= 0.0, name="EnforceInventoryFirstStage")
    m.constr((I_CUT @ cut1) + (I_CUT @ cut2) - made1 - made2 <= 0.0,
             name="EnforceInventorySecondStage")

    m.stage_cost(1, produce1.dot(SETUP_COST) + made1.dot(UNIT_COST)
                 + cut1.dot(UNIT_REDUCTION_COST * OFFDIAG))
    m.stage_cost(2, produce2.dot(SETUP_COST) + made2.dot(UNIT_COST)
                 + cut2.dot(UNIT_REDUCTION_COST * OFFDIAG))
    return m


def make_tree(num_scens=3):
    names = [f"Scenario{i + 1}" for i in range(num_scens)]
    return two_stage_tree(names, nonant_names=["NumProducedFirstStage",
                                               "NumUnitsCutFirstStage"])


def _rho_setter(batch, rho_factor=0.001):
    """Cost-proportional rho (ref. tests/examples/sizes/sizes.py:37-57):
    production slots get RF·unit_cost, cut slots RF·reduction_cost."""
    K = batch.K
    rho = np.empty(K)
    rho[:NUM_SIZES] = rho_factor * UNIT_COST
    rho[NUM_SIZES:] = rho_factor * UNIT_REDUCTION_COST
    return rho


def id_fix_list_fct(batch):
    """Fixer spec matching the reference's iterk tuples (ref. sizes.py:62-98:
    th=0.2, nb=3, lb=1, ub=2 on all first-stage quantity vars)."""
    K = batch.K
    return {"tol": np.full(K, 0.2),
            "nb": np.full(K, 3, dtype=np.int64),
            "lb": np.full(K, 1, dtype=np.int64),
            "ub": np.full(K, 2, dtype=np.int64)}


def scenario_denouement(rank, scenario_name, values):
    pass
