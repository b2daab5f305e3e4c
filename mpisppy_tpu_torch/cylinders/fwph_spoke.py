"""FWPH outer-bound spoke (the port of mpisppy_tpu/cylinders/
fwph_spoke.py; ref. mpisppy/cylinders/fwph_spoke.py:5-28).

Wraps the FWPH engine; the engine's per-iteration spcomm.sync()
publishes ``_local_bound`` and its is_converged() doubles as the kill
check, the reference's pattern.
"""

from __future__ import annotations

from .spoke import OuterBoundSpoke


class FrankWolfeOuterBound(OuterBoundSpoke):
    converger_spoke_char = "F"

    def sync(self):
        if self.opt._local_bound is not None:
            self.update_bound(self.opt._local_bound)

    def is_converged(self):
        return self.got_kill_signal()

    def main(self):
        self.opt.fwph_main(finalize=False)
