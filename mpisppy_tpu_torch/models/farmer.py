"""Farmer: the canonical scalable 2-stage stochastic LP/MIP.

Same mathematical problem and scenario-generation scheme as the reference
(ref. mpisppy/tests/examples/farmer.py:23-225, examples/farmer/farmer.py):
Birge & Louveaux's farmer with 3·crops_multiplier crops; scenario i maps to
{below, average, above}-average yields by i mod 3, and scenario groups
beyond the first add U[0,1) noise from a RandomState seeded with the
scenario number — reproduced exactly so objective values are comparable.
Expressed in the mpisppy_tpu DSL instead of Pyomo.
"""

from __future__ import annotations

import re

import numpy as np

from ..ir.model import Model
from ..ir.tree import two_stage_tree

CROPS = ["WHEAT", "CORN", "SUGAR_BEETS"]
BASE_YIELD = {
    "BelowAverage": np.array([2.0, 2.4, 16.0]),
    "Average": np.array([2.5, 3.0, 20.0]),
    "AboveAverage": np.array([3.0, 3.6, 24.0]),
}
PRICE_QUOTA = np.array([100000.0, 100000.0, 6000.0])
SUBQUOTA_PRICE = np.array([170.0, 150.0, 36.0])
SUPERQUOTA_PRICE = np.array([0.0, 0.0, 10.0])
CATTLE_FEED = np.array([200.0, 240.0, 0.0])
PURCHASE_PRICE = np.array([238.0, 210.0, 100000.0])
PLANTING_COST = np.array([150.0, 230.0, 260.0])
BASENAMES = ["BelowAverage", "Average", "AboveAverage"]


def extract_num(name: str) -> int:
    """Scenario number scraped off the right of the name (ref. sputils.extract_num)."""
    return int(re.search(r"(\d+)$", name).group(1))


def scenario_yields(scennum: int, crops_multiplier: int = 1) -> np.ndarray:
    basenum = scennum % 3
    groupnum = scennum // 3
    y = np.tile(BASE_YIELD[BASENAMES[basenum]], crops_multiplier)
    if groupnum != 0:
        # same RNG discipline as the reference: RandomState seeded with the
        # scenario number, one rand() per crop in declaration order
        stream = np.random.RandomState(scennum)
        y = y + stream.rand(3 * crops_multiplier)
    return y


def scenario_creator(scenario_name, use_integer=False, crops_multiplier=1,
                     sense="min") -> Model:
    scennum = extract_num(scenario_name)
    cm = crops_multiplier
    nC = 3 * cm
    y = scenario_yields(scennum, cm)
    total_acreage = 500.0 * cm

    tile = lambda a: np.tile(a, cm)
    m = Model(scenario_name, sense="min")
    acres = m.var("DevotedAcreage", nC, lb=0.0, ub=total_acreage,
                  integer=use_integer, stage=1)
    sell_sub = m.var("QuantitySubQuotaSold", nC, lb=0.0, ub=tile(PRICE_QUOTA), stage=2)
    sell_super = m.var("QuantitySuperQuotaSold", nC, lb=0.0, stage=2)
    buy = m.var("QuantityPurchased", nC, lb=0.0, stage=2)

    m.constr(acres.sum() <= total_acreage, name="ConstrainTotalAcreage")
    m.constr(acres * y + buy - sell_sub - sell_super >= tile(CATTLE_FEED),
             name="EnforceCattleFeedRequirement")
    m.constr(sell_sub + sell_super - acres * y <= 0.0, name="LimitAmountSold")

    sign = 1.0 if sense == "min" else -1.0
    m.stage_cost(1, sign * acres.dot(tile(PLANTING_COST)))
    m.stage_cost(2, sign * (buy.dot(tile(PURCHASE_PRICE))
                            - sell_sub.dot(tile(SUBQUOTA_PRICE))
                            - sell_super.dot(tile(SUPERQUOTA_PRICE))))
    return m


def scenario_synth_spec(template, seed=0, use_integer=False,
                        crops_multiplier=1, sense="min",
                        feed_spread=0.1):
    """The farmer-family randomness-in-rhs synth spec (stream/synth.py;
    the JAX package's models/farmer.py spec on stream/prng.py's
    generator): yields are pinned at the template scenario's (one
    shared constraint matrix, the representation the chunked and
    streamed loops need), and the randomness moves to the cattle-feed
    REQUIREMENT rhs: scenario s demands ``CATTLE_FEED * (1 + feed_spread
    * (2u - 1))`` with ``u ~ U[0,1)^crops`` drawn from
    ``fold_in(prng_key(seed), s)``. Zero-requirement crops keep a zero
    rhs exactly. Uniform draws are exact, so the values equal the JAX
    package's bit for bit."""
    import torch

    from ..stream import prng
    from ..stream.synth import SynthField, SynthSpec

    sl = template.con_slices["EnforceCattleFeedRequirement"]
    base_np = np.tile(CATTLE_FEED, crops_multiplier).astype(np.float64)
    spread = float(feed_spread)

    def fn(keys):
        base = torch.as_tensor(base_np, device=keys.device)
        u = prng.uniform(keys, base_np.shape)
        return (base * (1.0 + spread * (2.0 * u - 1.0)),)

    return SynthSpec(seed=int(seed),
                     fields=(SynthField("l", sl.start, sl.stop),),
                     fn=fn)


def make_tree(num_scens, crops_multiplier=1):
    names = [f"scen{i}" for i in range(num_scens)]
    return two_stage_tree(names, nonant_names=["DevotedAcreage"])


def scenario_denouement(rank, scenario_name, values):
    pass
