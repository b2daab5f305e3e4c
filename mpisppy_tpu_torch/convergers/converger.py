"""Converger ABC (ref. mpisppy/convergers/converger.py:13-29)."""

from __future__ import annotations

import abc


class Converger(abc.ABC):
    """Constructed with the engine after iter 0; ``is_converged`` is polled
    once per iteration after the solve/update."""

    def __init__(self, opt):
        self.opt = opt

    @abc.abstractmethod
    def is_converged(self) -> bool:
        ...
