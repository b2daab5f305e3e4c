"""Extension (plugin) protocol for algorithm engines, and the
extensions the port runs (the port of the JAX package's extensions/).

Engines call the hooks ``pre_iter0 / post_iter0 / miditer / enditer /
post_everything`` around the iteration loop and ``post_solve`` after
each batched solve pass, each with the engine as its argument.

Not ported yet, each naming its ROADMAP.md item when imported:
``WXBarWriter`` / ``WXBarReader`` (the checkpoint slice, A14).
"""

from .extension import Extension, MultiExtension
from .fixer import DeviceFixer, Fixer, FixerTuple
from .mipgapper import Gapper
from .norm_rho_updater import DeviceNormRhoUpdater, NormRhoUpdater
from .xhatclosest import XhatClosest
from .diagnoser import Diagnoser
from .avgminmaxer import MinMaxAvg

__all__ = [
    "Extension", "MultiExtension", "DeviceFixer", "Fixer", "FixerTuple",
    "Gapper", "DeviceNormRhoUpdater", "NormRhoUpdater", "XhatClosest",
    "Diagnoser", "MinMaxAvg",
]

# name -> (what it is, its ROADMAP.md item)
_UNPORTED = {
    "WXBarWriter": ("the W/x̄ checkpoint writer", "A14"),
    "WXBarReader": ("the W/x̄ checkpoint reader", "A14"),
}


def __getattr__(name):
    if name in _UNPORTED:
        what, item = _UNPORTED[name]
        raise NotImplementedError(f"{name} ({what}) is not ported yet "
                                  f"(see ROADMAP.md {item})")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
