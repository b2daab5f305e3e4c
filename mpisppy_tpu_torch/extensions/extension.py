"""Extension base class and composition.

ref. mpisppy/extensions/extension.py:14 (Extension), :90 (MultiPHExtension).
"""

from __future__ import annotations


class Extension:
    """Base extension: every hook is a no-op. Engines call hooks through
    ``PHBase._ext`` with themselves as the single argument."""

    def __init__(self, options=None):
        self.options = dict(options or {})

    def pre_iter0(self, opt):
        pass

    def post_iter0(self, opt):
        pass

    def miditer(self, opt):
        pass

    def enditer(self, opt):
        pass

    def post_everything(self, opt):
        pass

    def post_solve(self, opt):
        pass


class MultiExtension(Extension):
    """Compose a list of extension classes or instances in order
    (ref. extension.py:90 MultiPHExtension)."""

    def __init__(self, ext_classes, options=None):
        super().__init__(options)
        self.extensions = [e if isinstance(e, Extension) else e(options)
                           for e in ext_classes]

    def _all(self, hook, opt):
        for e in self.extensions:
            getattr(e, hook)(opt)

    def pre_iter0(self, opt):
        self._all("pre_iter0", opt)

    def post_iter0(self, opt):
        self._all("post_iter0", opt)

    def miditer(self, opt):
        self._all("miditer", opt)

    def enditer(self, opt):
        self._all("enditer", opt)

    def post_everything(self, opt):
        self._all("post_everything", opt)

    def post_solve(self, opt):
        self._all("post_solve", opt)
