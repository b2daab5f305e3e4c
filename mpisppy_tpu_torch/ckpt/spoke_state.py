"""Per-spoke warm-state files: tiny, atomic, continuously refreshed (the
port's copy of the JAX package's ckpt/spoke_state.py).

Each spoke process writes its own warm state into
``<ckpt_dir>/spokes/spoke<i>.npz`` (atomic tmp+``os.replace``, so a
SIGKILL mid-write leaves the previous complete snapshot): the best
bound it has published, its standing incumbent, its Lagrangian dual
block, its scenario-cycler position, its dive round counter — whatever
:meth:`Spoke.spoke_state` reports for its class. Two consumers:

- the hub's :class:`~mpisppy_tpu_torch.ckpt.manager.CheckpointManager`
  copies the live files into every bundle (the bundle stays
  self-contained while the live files keep moving), and
- the supervisor's respawn path (utils/multiproc._spawn_one_spoke)
  hands the live file back to generation N+1 via the
  ``resume_state`` option, so a respawned spoke RESUMES where the dead
  generation left off instead of cold-starting.

Scalars and strings ride the npz beside the arrays (numpy 0-d and
str arrays round-trip without pickle); ``load_spoke_state`` validates
finiteness the same way the bundle loader does and raises the same
reasoned :class:`CheckpointError` so a corrupt file degrades to a
cold spoke start, never a crashed child.
"""

from __future__ import annotations

import os

import numpy as np

from .bundle import CheckpointError, atomic_savez

# keys every spoke-state file carries (class identity guards against a
# wheel whose composition changed between capture and resume)
_META_KEYS = ("spoke_class", "kind", "index")


def spoke_state_path(ckpt_dir: str, index: int) -> str:
    return os.path.join(ckpt_dir, "spokes", f"spoke{int(index)}.npz")


def save_spoke_state(ckpt_dir: str, index: int, spoke_class: str,
                     kind: str, state: dict) -> str:
    """Atomically persist one spoke's warm state; returns the path.
    ``state`` values may be numpy arrays, scalars, or short strings;
    None entries are dropped."""
    path = spoke_state_path(ckpt_dir, index)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    payload = {k: np.asarray(v) for k, v in state.items()
               if v is not None}
    payload["spoke_class"] = np.asarray(str(spoke_class))
    payload["kind"] = np.asarray(str(kind))
    payload["index"] = np.asarray(int(index))
    atomic_savez(path, **payload)
    return path


def spoke_resume_options(checkpoint_dir, resume_from, index, kind,
                         gen=0) -> dict:
    """The spoke-side option block for one (index, generation): where
    to WRITE warm state (``checkpoint_dir``/``checkpoint_index``/
    ``checkpoint_kind``) and — when a source exists — where to RESUME
    from (``resume_state``). Respawned generations (gen > 0) prefer
    the LIVE file the dead generation kept refreshing (the freshest
    state — this is what turns the supervisor's respawn from "restart
    the spoke" into "resume the spoke"); initial launches resume from
    the bundle named by ``resume_from``. Shared by the thread-wheel
    builder (utils/vanilla.wheel_dicts) and the process launcher
    (utils/multiproc._spawn_one_spoke)."""
    from .bundle import CheckpointError, resolve_bundle

    opts = {}
    if checkpoint_dir:
        opts["checkpoint_dir"] = str(checkpoint_dir)
        opts["checkpoint_index"] = int(index)
        opts["checkpoint_kind"] = str(kind)
    path = None
    if gen and checkpoint_dir:
        live = spoke_state_path(checkpoint_dir, index)
        if os.path.isfile(live):
            path = live
    if path is None and resume_from:
        try:
            b = resolve_bundle(str(resume_from))
        except CheckpointError:
            b = None        # the hub books the reasoned rejection
        if b is not None:
            cand = os.path.join(b, f"spoke{int(index)}.npz")
            if os.path.isfile(cand):
                path = cand
    if path is not None:
        opts["resume_state"] = path
    return opts


def load_spoke_state(path: str, spoke_class: str | None = None) -> dict:
    """Read + validate one spoke-state file into a plain dict (host
    numpy arrays; 0-d unwrapped to Python scalars, strings to str).
    ``spoke_class`` given: refuse a file captured for a different
    spoke class (``class_mismatch``). Raises :class:`CheckpointError`
    on any defect."""
    try:
        with np.load(path) as d:
            raw = {k: np.asarray(d[k]) for k in d.files}
    except OSError as e:
        raise CheckpointError("not_found", str(e)) from e
    except Exception as e:
        raise CheckpointError("bad_npz", str(e)) from e
    out = {}
    for k, a in raw.items():
        if a.dtype.kind in "fc" and not np.isfinite(a).all():
            raise CheckpointError("nonfinite",
                                  f"{k} carries non-finite entries")
        if a.ndim == 0:
            v = a.item()
            out[k] = v.decode() if isinstance(v, bytes) else v
        else:
            out[k] = a
    for k in _META_KEYS:
        if k not in out:
            raise CheckpointError("truncated", f"missing field {k!r}")
    if spoke_class is not None \
            and str(out["spoke_class"]) != str(spoke_class):
        raise CheckpointError(
            "class_mismatch",
            f"state was captured by {out['spoke_class']!r}, this spoke "
            f"is {spoke_class!r}")
    return out
