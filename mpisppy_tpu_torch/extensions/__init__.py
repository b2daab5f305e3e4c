"""Extension (plugin) protocol for algorithm engines (the port's copy
of the JAX package's extensions/extension.py; its other extensions
are not ported yet, ROADMAP.md A11).

Engines call the hooks ``pre_iter0 / post_iter0 / miditer / enditer /
post_everything`` around the iteration loop and ``post_solve`` after
each batched solve pass, each with the engine as its argument.
"""

from .extension import Extension, MultiExtension

__all__ = ["Extension", "MultiExtension"]
