"""Hub-owned checkpoint capture + the resume installer (the port of the
JAX package's ckpt/manager.py).

:class:`CheckpointManager` rides the hub's termination-check path
(``Hub.determine_termination`` calls :meth:`maybe_capture` the way it
writes live.json): rate-limited periodic bundles, forced bundles on
watchdog fire, SIGTERM (the preemption notice — see
``Hub.handle_preemption``), and finalize. Capture reads the engine's
algorithm-state tensors in one stacked device-to-host copy between
iterations — nothing is added to the solve path.

:func:`resume_hub` is the other direction: validate a bundle
(schema + fingerprint + finiteness — doc/fault_tolerance.md), install
the hub engine's (W, x̄, x̄², ρ, iter) through the same
pad/placement/invalidation path the wxbar warm start uses, and seed
the hub's monotone best-bound ledger through the ingest-validated
updates. A wheel resumed into a checkpoint directory names its bundles
on from the resumed bundle (:meth:`CheckpointManager.resumed_from`), so
retention keeps them and ``LATEST`` resolves to them (the JAX package
names them from the engine's iteration, which restarts at 0, so its
retention deletes them at once). A rejected bundle books ``ckpt.rejected.<reason>`` + a
``ckpt.resume_rejected`` event and the wheel cold-starts — corruption
degrades, it never crashes.
"""

from __future__ import annotations

import math
import os
import threading
import time

import numpy as np

from .. import global_toc, obs
from . import bundle as _bundle
from .bundle import CheckpointError

_DEF_INTERVAL = 30.0
_DEF_KEEP = 3


def hub_state_arrays(opt) -> dict:
    """The hub engine's algorithm state as host numpy in the engine's
    dtype, REAL scenarios only (mesh pads are re-derived on install —
    the same portability contract as extensions/wxbar_io), read in one
    stacked device-to-host copy. The consensus/z block is NOT captured:
    the resumed engine's warm iter-0 pass recomputes x from the
    installed (W, x̄, ρ) before any spoke push, so stored nonants
    would be dead bytes in every bundle."""
    from ..extensions.wxbar_io import state_blocks
    arrays = state_blocks(opt)
    arrays["iter"] = np.asarray(int(getattr(opt, "_iter", 0)))
    if hasattr(opt, "aph_state_arrays"):
        # APH wheels bundle their projective + dispatch state too
        # (``aph_``-prefixed extras — core/aph.py): without (z, y, x,
        # phis, recency) a resumed APH wheel would re-dispatch from
        # scratch and the trajectory would fork
        arrays.update(opt.aph_state_arrays())
    return arrays


class CheckpointManager:
    """One per hub process. Never raises into the hub loop: a full
    disk books ``ckpt.write_failed`` and the wheel keeps iterating."""

    def __init__(self, hub, ckpt_dir, interval=None, keep=None,
                 fingerprint=None):
        self.hub = hub
        self.ckpt_dir = str(ckpt_dir)
        self.interval = _DEF_INTERVAL if interval is None \
            else float(interval)
        self.keep = _DEF_KEEP if keep is None else int(keep)
        self.fingerprint = fingerprint
        self._seq = 0
        # iterations of the runs this wheel resumed (resumed_from); the
        # engine's own _iter restarts at 0 in ph_main, so a bundle's
        # iteration is the base plus it once the engine counts again
        self._iter_base = 0
        self._counting = True
        self._last_capture = 0.0       # monotonic; 0 = never
        self.last_bundle = None
        self.last_iter = None
        self.last_unix = None
        # capture reaches here from THREE contexts: the hub loop, the
        # supervisor's watchdog timer thread, and the SIGTERM signal
        # frame (which can interrupt the hub loop MID-capture on the
        # same thread — a blocking lock would deadlock there).
        # Non-blocking: an overlapping capture is simply skipped; the
        # in-flight one is at most one iteration stale, and the
        # finalize capture runs after the loop exits regardless.
        self._capture_lock = threading.Lock()

    def resumed_from(self, manifest: dict, path: str):
        """Name this wheel's bundles on from a resumed bundle: each
        capture's iteration is the resumed ``iter`` plus the engine's
        count, and the capture sequence continues above every bundle
        in this directory and above the resumed one. Bundle names then
        sort after the predecessor's, so ``_prune`` keeps the new ones
        and the ``LATEST`` fallback finds them. The engine's ``_iter``
        is left alone: convergers, the fixer and iteration limits
        count from it."""
        self._iter_base = int(manifest.get("iter") or 0)
        self._counting = False
        names = [os.path.basename(path)] + _bundle._bundle_dirs(
            self.ckpt_dir)
        self._seq = max([self._seq] + [_bundle.bundle_seq(n)
                                       for n in names])

    def _iteration(self, opt) -> int:
        """The capture's iteration. Until the hub's first termination
        check after a resume, the engine runs the resumed wheel's warm
        iteration 0 and its ``_iter`` still holds the installed value:
        the state is the resumed bundle's iteration. From that check on
        (ph_main has reset ``_iter``) it is the base plus ``_iter``."""
        if not self._counting:
            return self._iter_base
        return self._iter_base + int(getattr(opt, "_iter", 0))

    def maybe_capture(self, force=False, reason="interval"):
        if not force:
            # only the hub's termination check captures unforced: the
            # engine counts this run's iterations from here on
            self._counting = True
            now = time.monotonic()
            if self.interval <= 0 \
                    or now - self._last_capture < self.interval:
                return None
        return self.capture(reason)

    def capture(self, reason="interval"):
        hub = self.hub
        opt = hub.opt
        if not hasattr(opt, "W"):      # non-PH-family hub engine
            return None
        if not self._capture_lock.acquire(blocking=False):
            return None     # capture already in flight (see ctor note)
        try:
            return self._capture_locked(reason)
        finally:
            self._capture_lock.release()

    def _capture_locked(self, reason):
        hub = self.hub
        opt = hub.opt
        t0 = time.perf_counter()
        try:
            arrays = hub_state_arrays(opt)
            arrays["iter"] = np.asarray(self._iteration(opt))
            self._seq += 1
            meta = {
                "fingerprint": self.fingerprint,
                "reason": reason,
                "run_id": getattr(obs.active(), "run_id", None)
                if obs.active() is not None else None,
                "outer": obs.finite_or_none(hub.BestOuterBound),
                "inner": obs.finite_or_none(hub.BestInnerBound),
                "ob_char": hub.latest_ob_char,
                "ib_char": hub.latest_ib_char,
                "trivial_seed": obs.finite_or_none(hub._trivial_seed),
            }
            path = _bundle.write_bundle(
                self.ckpt_dir, arrays, meta,
                iteration=int(arrays["iter"]), seq=self._seq,
                keep=self.keep)
        except Exception as e:   # full disk, torn perms, anything —
            # a checkpoint failure must never kill the wheel it exists
            # to protect
            obs.counter_add("ckpt.write_failed")
            global_toc(f"WARNING: checkpoint capture failed ({e!r}); "
                       "wheel continues")
            return None
        self._last_capture = time.monotonic()
        self.last_bundle = path
        self.last_iter = int(arrays["iter"])
        self.last_unix = time.time()
        obs.counter_add("ckpt.captures")
        if obs.enabled():
            obs.histogram_observe("ckpt.capture_seconds",
                                  time.perf_counter() - t0)
        obs.event("ckpt.capture",
                  {"bundle": path, "iter": self.last_iter,
                   "reason": reason,
                   "seconds": time.perf_counter() - t0})
        return path

    def status(self) -> dict:
        """live.json / /status stamp (doc/observability.md)."""
        return {"dir": self.ckpt_dir, "last_bundle": self.last_bundle,
                "last_iter": self.last_iter,
                "last_wall_time_unix": self.last_unix,
                "interval_seconds": self.interval}


def _reject(reason, detail):
    obs.counter_add(f"ckpt.rejected.{reason}")
    obs.event("ckpt.resume_rejected", {"reason": reason,
                                       "detail": detail})
    global_toc(f"WARNING: resume checkpoint rejected ({reason}): "
               f"{detail} — cold start")


def resume_hub(hub, path, fingerprint=None):
    """Install a bundle into a constructed hub + engine. Returns the
    manifest on success, None on a rejected bundle (reasoned event +
    ``ckpt.rejected.<reason>`` counter; the wheel cold-starts)."""
    t0 = time.perf_counter()
    try:
        manifest, arrays, _spokes = _bundle.load_bundle(
            path, fingerprint=fingerprint)
    except CheckpointError as e:
        _reject(e.reason, str(e))
        return None
    opt = hub.opt
    if not hasattr(opt, "W"):
        _reject("unsupported_hub",
                f"{type(opt).__name__} has no PH algorithm state")
        return None
    try:
        from ..extensions.wxbar_io import install_state_arrays
        install_state_arrays(opt, arrays)
        if hasattr(opt, "install_aph_state") \
                and "aph_z" in arrays:
            # the APH extras travel as a set — a bundle either carries
            # all of them (same capture) or none (pre-APH bundle /
            # PH-hub bundle resumed into an APH wheel: projective
            # state then cold-starts while (W, x̄, ρ) stay warm)
            opt.install_aph_state(arrays)
    except (CheckpointError, ValueError, KeyError) as e:
        _reject(getattr(e, "reason", "shape_mismatch"), str(e))
        return None
    opt._warm_started = True
    opt._warm_started_xbar = True
    if getattr(hub, "ckpt", None) is not None:
        hub.ckpt.resumed_from(manifest, _bundle.resolve_bundle(path))
    # seed the monotone best-bound ledger through the SAME validation
    # ingested bounds pass: non-finite refuses inside the
    # update; implausible magnitudes refuse here
    cap = float(hub.options.get("bound_magnitude_cap", 1e25))
    for kind, key, char_key in (("outer", "outer", "ob_char"),
                                ("inner", "inner", "ib_char")):
        v = manifest.get(key)
        if v is None:
            continue
        v = float(v)
        if not math.isfinite(v) or abs(v) > cap:
            reason = "implausible_bound"
            obs.counter_add(f"ckpt.rejected.{reason}")
            continue
        char = str(manifest.get(char_key) or " ")
        if kind == "outer":
            hub.OuterBoundUpdate(v, char)
        else:
            hub.InnerBoundUpdate(v, char)
    ts = manifest.get("trivial_seed")
    if ts is not None and hub._trivial_seed is None \
            and math.isfinite(float(ts)):
        hub._trivial_seed = float(ts)
    obs.counter_add("ckpt.resumed")
    obs.event("ckpt.resume",
              {"bundle": _bundle.resolve_bundle(path),
               "iter": manifest.get("iter"),
               "outer": manifest.get("outer"),
               "inner": manifest.get("inner"),
               "seconds": time.perf_counter() - t0})
    global_toc(f"checkpoint resume: iter {manifest.get('iter')} "
               f"outer {manifest.get('outer')} inner "
               f"{manifest.get('inner')} from {path}")
    return manifest
