"""Slam heuristics: per-variable max/min over scenarios as an incumbent.

Mirrors mpisppy/cylinders/slam_heuristic.py:24-153: reshape the hub's
nonants to (scenario x var), take the per-var MAX (SlamUp) or MIN
(SlamDown) across all scenarios, round integers, fix everything, evaluate.
The reference's local-then-Allreduce(MAX/MIN) two-step collapses to one
axis reduction over the batched nonant block.

The same two rows ride the device incumbent pool as members
(ops/incumbent.build_pool slam block, doc/incumbents.md) —
ops/incumbent.slam_rows is the one host implementation both share.
"""

from __future__ import annotations

from .xhat_bounders import _XhatInnerBound


class _SlamHeuristic(_XhatInnerBound):
    converger_spoke_char = "S"
    mpi_op = None  # "max" | "min"

    def candidates(self, X):
        from ..ops.incumbent import slam_rows
        up, down = slam_rows(X)
        yield up if self.mpi_op == "max" else down


class SlamUpHeuristic(_SlamHeuristic):
    mpi_op = "max"


class SlamDownHeuristic(_SlamHeuristic):
    mpi_op = "min"
