"""Extension (plugin) protocol for algorithm engines, and the
extensions the port runs (the port of the JAX package's extensions/).

Engines call the hooks ``pre_iter0 / post_iter0 / miditer / enditer /
post_everything`` around the iteration loop and ``post_solve`` after
each batched solve pass, each with the engine as its argument.
"""

from .extension import Extension, MultiExtension
from .fixer import DeviceFixer, Fixer, FixerTuple
from .mipgapper import Gapper
from .norm_rho_updater import DeviceNormRhoUpdater, NormRhoUpdater
from .xhatclosest import XhatClosest
from .diagnoser import Diagnoser
from .avgminmaxer import MinMaxAvg
from .wxbar_io import WXBarReader, WXBarWriter

__all__ = [
    "Extension", "MultiExtension", "DeviceFixer", "Fixer", "FixerTuple",
    "Gapper", "DeviceNormRhoUpdater", "NormRhoUpdater", "XhatClosest",
    "Diagnoser", "MinMaxAvg", "WXBarWriter", "WXBarReader",
]
