"""NETDES: two-stage stochastic network design.

Same problem class as the reference's netdes example (ref. examples/netdes/
netdes.py:33-76): first stage builds arcs (binary x_e, cost c_e), second
stage routes flow y_e at cost d_e subject to arc capacity u_e·x_e and node
flow balance b_i(ξ). The reference reads 100+ pre-generated .dat instances;
here instances are seeded random strongly-connected digraphs scalable via
num_nodes, with per-scenario random demand vectors.
"""

from __future__ import annotations

import re

import numpy as np

from ..ir.model import Model
from ..ir.tree import two_stage_tree


def build_graph(num_nodes=5, extra_arc_prob=0.5, base_seed=7):
    """A ring (guarantees feasibility of any balanced demand) plus seeded
    random chords. Returns (edge list, incidence matrix, c, d, u)."""
    rng = np.random.RandomState(base_seed)
    edges = [(i, (i + 1) % num_nodes) for i in range(num_nodes)]
    for i in range(num_nodes):
        for j in range(num_nodes):
            if i != j and (i, j) not in edges and rng.rand() < extra_arc_prob:
                edges.append((i, j))
    E = len(edges)
    inc = np.zeros((num_nodes, E))   # +1 out, -1 in (flow balance rows)
    for e, (i, j) in enumerate(edges):
        inc[i, e] = 1.0
        inc[j, e] = -1.0
    c = rng.uniform(10.0, 40.0, size=E)    # build cost
    d = rng.uniform(1.0, 5.0, size=E)      # per-unit routing cost
    u = rng.uniform(10.0, 30.0, size=E)    # capacity
    return edges, inc, c, d, u


def scenario_demand(scennum, num_nodes, scale=5.0):
    """b_i(ξ): seeded supply/demand vector summing to zero."""
    rng = np.random.RandomState(2000 + scennum)
    b = rng.uniform(-scale, scale, size=num_nodes)
    return b - b.mean()


def scenario_creator(scenario_name, num_nodes=5, extra_arc_prob=0.5,
                     base_seed=7, demand_scale=5.0) -> Model:
    scennum = int(re.search(r"(\d+)$", scenario_name).group(1))
    edges, inc, c, d, u = build_graph(num_nodes, extra_arc_prob, base_seed)
    b = scenario_demand(scennum, num_nodes, demand_scale)
    E = len(edges)

    m = Model(scenario_name, sense="min")
    x = m.var("BuildArc", E, lb=0.0, ub=1.0, integer=True, stage=1)
    y = m.var("Flow", E, lb=0.0, stage=2)

    # variable upper bounds y_e <= u_e x_e (ref. netdes.py:59-62)
    m.constr(y - (np.diag(u) @ x) <= 0.0, name="ArcCapacity")
    # flow balance per node (ref. netdes.py:65-71); drop the last row — it
    # is implied (rows of inc sum to 0 and b sums to 0) and keeping it makes
    # the equality block rank-deficient
    m.constr(inc[:-1] @ y == b[:-1], name="FlowBalance")

    m.stage_cost(1, x.dot(c))
    m.stage_cost(2, y.dot(d))
    return m


def make_tree(num_scens, **_):
    names = [f"Scenario{i}" for i in range(num_scens)]
    return two_stage_tree(names, nonant_names=["BuildArc"])


def scenario_denouement(rank, scenario_name, values):
    pass
