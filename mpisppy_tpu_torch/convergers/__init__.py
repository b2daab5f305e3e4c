"""Convergers: pluggable supplemental termination criteria.

ref. mpisppy/convergers/converger.py:13 — engines construct the converger
after iter 0 and call ``is_converged()`` each iteration
(ref. phbase.py:1527-1531).
"""

from .converger import Converger
from .fracintsnotconv import FractionalConverger
from .norm_rho_converger import NormRhoConverger

__all__ = ["Converger", "FractionalConverger", "NormRhoConverger"]
