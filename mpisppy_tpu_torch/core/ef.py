"""ExtensiveForm: build and solve the monolithic deterministic equivalent
(the port of mpisppy_tpu/core/ef.py).

The reference flattens the scenario dict into one Pyomo model with
explicit nonanticipativity constraints and hands it to a commercial
solver (ref. mpisppy/utils/sputils.py:168 create_EF, mpisppy/opt/ef.py:61
solve_extensive_form). Here shared columns replace the equality rows:
every tree node owns one copy of its nonant variables, scenario-local
variables get their own columns, and each scenario's constraint block
maps through a column-index gather. The column map and the EF tensors
are built on the host in numpy and moved to the engine's device once;
the result is one batch-of-one QP, solved by the host-segmented ADMM
driver ``qp_solve_segmented``.

The EF never reaches the hand-written ADMM block: its A is a
batch-of-one (1, S·m, n_ef) tensor, and the block's scope
(``ops/kernels/admm_block.scope_supported``) asks for a shared 2-D A.
The solve runs the reference ADMM loop in torch operations.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ir.batch import ScenarioBatch
from ..ops.qp_solver import (QPData, qp_cold_state, qp_setup,
                             qp_solve_segmented)
from ..utils.runtime import to_host
from .spbase import SPBase


class ExtensiveForm(SPBase):
    def __init__(self, batch: ScenarioBatch, options=None, dtype=None,
                 device=None):
        """``device``: None for the CUDA device (raises without one);
        ``"cpu"`` runs on the CPU."""
        super().__init__(batch, options, dtype, device=device)
        self._build_columns()

    def _build_columns(self):
        b = self.batch
        S, n = b.S, b.n
        tree = b.tree
        nonant_set = set(np.asarray(b.nonant_idx).tolist())
        local_cols = [j for j in range(n) if j not in nonant_set]
        n_local = len(local_cols)

        # global node ids: stage-major offsets per non-leaf stage
        node_offsets = np.cumsum([0] + tree.nodes_per_stage)
        total_nodes = int(node_offsets[-1])

        # nonant column table: (global node, slot within stage) -> EF col
        stage_slot_counts = [sl.stop - sl.start
                             for sl in b.stage_slot_slices]
        nonant_col_offset = np.zeros(total_nodes + 1, dtype=np.int64)
        g = 0
        for t, N in enumerate(tree.nodes_per_stage):
            for _ in range(N):
                nonant_col_offset[g + 1] = nonant_col_offset[g] \
                    + stage_slot_counts[t]
                g += 1
        n_nonant_cols = int(nonant_col_offset[-1])

        # per-scenario column map: x_s[j] = x_EF[colmap[s, j]]
        colmap = np.zeros((S, n), dtype=np.int64)
        for s in range(S):
            for t in range(tree.num_stages - 1):
                node_g = int(node_offsets[t] + tree.node_path[s, t])
                sl = b.stage_slot_slices[t]
                for k_local, j in enumerate(b.nonant_idx[sl.start:sl.stop]):
                    colmap[s, j] = nonant_col_offset[node_g] + k_local
            for k_local, j in enumerate(local_cols):
                colmap[s, j] = n_nonant_cols + s * n_local + k_local

        self.n_ef = n_nonant_cols + S * n_local
        self.colmap = colmap
        self._n_local = n_local

        m = b.m
        A_ef = np.zeros((S * m, self.n_ef))
        for s in range(S):
            # colmap[s] is injective, so this is a pure column scatter
            A_ef[s * m:(s + 1) * m][:, colmap[s]] = np.asarray(b.A_of(s))
        l_ef = np.asarray(b.l).reshape(-1)
        u_ef = np.asarray(b.u).reshape(-1)

        c_ef = np.zeros(self.n_ef)
        P_ef = np.zeros(self.n_ef)
        lb_ef = np.full(self.n_ef, -np.inf)
        ub_ef = np.full(self.n_ef, np.inf)
        for s in range(S):
            p = float(b.prob[s])
            np.add.at(c_ef, colmap[s], p * np.asarray(b.c[s]))
            np.add.at(P_ef, colmap[s], p * np.asarray(b.P_diag[s]))
            lb_ef[colmap[s]] = np.maximum(lb_ef[colmap[s]],
                                          np.asarray(b.lb[s]))
            ub_ef[colmap[s]] = np.minimum(ub_ef[colmap[s]],
                                          np.asarray(b.ub[s]))
        self.c0_ef = float(np.dot(b.prob, b.c0))

        t, dev = self.dtype, self.device

        def ship(a):
            return torch.as_tensor(a, dtype=t).to(dev)[None]

        A_dev = ship(A_ef)
        del A_ef
        self.ef_data: QPData = QPData(ship(P_ef), A_dev, ship(l_ef),
                                      ship(u_ef), ship(lb_ef), ship(ub_ef))
        self.c_ef = ship(c_ef)

    def solve_extensive_form(self, max_iter=40000, eps_abs=1e-7,
                             eps_rel=1e-7, integer=False,
                             integer_method="milp", time_limit=120.0,
                             mip_gap=None):
        """Solve the EF; mirrors opt/ef.py:61. Returns (objective,
        x_batch) with x_batch the per-scenario (S, n) host solution.

        ``integer=True`` solves the EF as a MIP: ``"milp"`` (default)
        is the host HiGHS B&B (core/mip.milp_solve), ``"dive"`` the
        batched device fix-and-dive (core/mip.dive_integers,
        integer-feasible with a small gap). HiGHS is LP-only, so a
        quadratic EF always dives."""
        factors = qp_setup(self.ef_data, q_ref=self.c_ef)
        st = qp_cold_state(factors, self.ef_data)
        st, x_ef, _, _ = qp_solve_segmented(
            factors, self.ef_data, self.c_ef, st, max_iter=max_iter,
            segment=min(500, max_iter), eps_abs=eps_abs, eps_rel=eps_rel)
        integer_cols = np.asarray(self.batch.integer)
        if integer and integer_cols.any():
            integer_ef = np.zeros(self.n_ef, bool)
            for s in range(self.batch.S):
                integer_ef[self.colmap[s]] = integer_cols
            if integer_method == "milp" and float(
                    self.ef_data.P_diag.abs().max()) > 0.0:
                integer_method = "dive"
            if integer_method == "milp":
                from .mip import milp_solve
                x_int, _, feasible = milp_solve(
                    self.ef_data, self.c_ef, self.c0_ef, integer_ef,
                    time_limit=time_limit, mip_gap=mip_gap)
                x_int = torch.as_tensor(x_int, dtype=self.dtype)
            else:
                from .mip import dive_integers
                x_int, _, feasible, st = dive_integers(
                    factors, self.ef_data, self.c_ef, self.c0_ef, st,
                    integer_ef, max_iter=max_iter, eps=eps_abs)
            if not bool(np.all(to_host(feasible))):
                raise RuntimeError("EF integer solve failed to reach an "
                                   "integer-feasible point")
            x_ef = x_int
        self.solver_state = st
        x_ef = to_host(x_ef[0])
        x_batch = x_ef[self.colmap]  # (S, n)
        self.ef_x = x_ef
        self.x_batch = x_batch
        return self._objective_of(x_batch), x_batch

    def _objective_of(self, x_batch):
        x = torch.as_tensor(x_batch, dtype=self.dtype).to(self.device)
        return float(self.Eobjective(self.scenario_objectives(x)))

    def get_objective_value(self):
        """User-sense objective (ref. opt/ef.py:102)."""
        if not hasattr(self, "x_batch"):
            raise RuntimeError("call solve_extensive_form first")
        obj = self._objective_of(self.x_batch)
        return obj if self.batch.template.sense == "min" else -obj

    def get_root_solution(self):
        """First-stage nonant values (shared across scenarios)."""
        sl = self.batch.stage_slot_slices[0]
        return self.x_batch[0, self.batch.nonant_idx[sl]]
