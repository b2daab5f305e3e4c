"""SSLP: two-stage stochastic server location (Ntaimo & Sen).

Same problem class as the reference's sslp example (ref. examples/sslp/
sslp.py:18-110, which instantiates an abstract Pyomo model from
sslp_<m>_<n>_<s> .dat files): first stage opens servers (binary y_i, cost
c_i), second stage assigns present clients to open servers (x_ij) for
revenue r_ij, subject to server capacity u; client presence h_j(ξ) is the
stochastic element. Instances here are generated from a seeded RNG in the
published SSLP data ranges instead of .dat files, scalable via
(num_servers, num_clients).
"""

from __future__ import annotations

import re

import numpy as np

from ..ir.model import Model
from ..ir.tree import two_stage_tree


def instance_data(num_servers=5, num_clients=25, base_seed=1):
    """Instance-level (scenario-independent) data, seeded like the SSLP
    generators: c_i ~ U[40,80], client demand d_j ~ U[1,10], revenue
    r_ij ~ U[0,25], capacity scaled so ~half the servers suffice."""
    rng = np.random.RandomState(base_seed)
    c = rng.uniform(40.0, 80.0, size=num_servers)
    d = rng.uniform(1.0, 10.0, size=num_clients)
    r = rng.uniform(0.0, 25.0, size=(num_servers, num_clients))
    u = 2.0 * d.sum() / num_servers
    return {"c": c, "d": d, "r": r, "u": u}


def client_presence(scennum, num_clients, presence_prob=0.5):
    """h_j(ξ) ~ Bernoulli(presence_prob), seeded per scenario (the SSLP
    uncertainty model: a client either shows up or doesn't)."""
    rng = np.random.RandomState(1000 + scennum)
    h = (rng.rand(num_clients) < presence_prob).astype(np.float64)
    if not h.any():
        h[rng.randint(num_clients)] = 1.0
    return h


def scenario_creator(scenario_name, num_servers=5, num_clients=25,
                     presence_prob=0.5, base_seed=1) -> Model:
    scennum = int(re.search(r"(\d+)$", scenario_name).group(1))
    data = instance_data(num_servers, num_clients, base_seed)
    h = client_presence(scennum, num_clients, presence_prob)
    nS, nC = num_servers, num_clients

    m = Model(scenario_name, sense="min")
    y = m.var("OpenServer", nS, lb=0.0, ub=1.0, integer=True, stage=1)
    x = m.var("Assign", nS * nC, lb=0.0, ub=1.0, integer=True, stage=2)

    # each present client assigned exactly once (ref. sslp abstract model's
    # client satisfaction constraint); absent clients: x forced to 0
    assign_of_client = np.zeros((nC, nS * nC))
    for j in range(nC):
        assign_of_client[j, j::nC] = 1.0
    m.constr(assign_of_client @ x == h, name="ClientAssignment")

    # server capacity with open-gate: sum_j d_j x_ij <= u * y_i
    demand_on_server = np.zeros((nS, nS * nC))
    for i in range(nS):
        demand_on_server[i, i * nC:(i + 1) * nC] = data["d"]
    gate = -data["u"] * np.eye(nS)
    m.constr((demand_on_server @ x) + (gate @ y) <= 0.0,
             name="ServerCapacity")

    m.stage_cost(1, y.dot(data["c"]))
    m.stage_cost(2, x.dot(-data["r"].reshape(-1)))   # revenue: negative cost
    return m


def make_tree(num_scens, **_):
    names = [f"Scenario{i}" for i in range(num_scens)]
    return two_stage_tree(names, nonant_names=["OpenServer"])


def scenario_denouement(rank, scenario_name, values):
    pass
