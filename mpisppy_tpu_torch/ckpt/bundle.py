"""Checkpoint bundle format: atomic manifest'd directories (the port's
copy of the JAX package's ckpt/bundle.py, numpy and stdlib only: the
schema, the state keys and the fingerprint are the same, so a bundle
written by either package loads in the other).

A *bundle* is one durable snapshot of a run::

    <ckpt_dir>/
      LATEST                    # text: name of the newest bundle dir
      spokes/                   # live per-spoke warm state (spoke_state)
        spoke0.npz
      bundle-00000012-0003/     # <iter>-<capture seq>
        manifest.json           # schema, fingerprint, bounds, file sizes
        hub.npz                 # W, xbar, xsqbar, rho, iter
        spoke0.npz              # copied per-spoke warm-state snapshots

Crash-safety contract (the live.json pattern, obs/live.py): every file
is written into a temp sibling and ``os.replace``'d; the bundle
directory itself is assembled under a dot-prefixed temp name and
renamed into place ONLY after its manifest — the last file written —
is complete. A reader therefore either sees a whole bundle or no
bundle; a SIGKILL mid-capture leaves at most an ignorable temp dir.

Validation on load mirrors the hub's bound-ingest firewall
(doc/fault_tolerance.md): corrupt manifests, truncated members,
schema/fingerprint mismatches, non-finite state blocks, and absurd
iteration counters are each REJECTED with a reasoned
:class:`CheckpointError` — the caller books ``ckpt.rejected.<reason>``
and cold-starts instead of installing NaNs into the prox center.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import time

import numpy as np

SCHEMA_VERSION = 1
MANIFEST = "manifest.json"
HUB_NPZ = "hub.npz"
LATEST = "LATEST"
_BUNDLE_PREFIX = "bundle-"
_TMP_PREFIX = ".tmp-"

# hub.npz payload: the (S, K) algorithm-state blocks + scalars
STATE_KEYS = ("W", "xbar", "xsqbar", "rho")
_MAX_ITER = 10 ** 9       # beyond this, "iter" is bit garbage, not a run


class CheckpointError(ValueError):
    """A bundle that must not be installed. ``reason`` is a short
    machine token (``bad_manifest``, ``schema_mismatch``,
    ``fingerprint_mismatch``, ``truncated``, ``bad_npz``,
    ``nonfinite``, ``bad_iter``, ``bad_rho``, ``not_found``, ...) —
    the suffix of the ``ckpt.rejected.<reason>`` counter the caller
    books."""

    def __init__(self, reason: str, detail: str = ""):
        self.reason = reason
        super().__init__(f"checkpoint rejected ({reason})"
                         + (f": {detail}" if detail else ""))


def config_fingerprint(fields: dict) -> str:
    """Stable fingerprint of the run identity a checkpoint is only
    valid for: same model family, scenario count, model kwargs,
    bundling, and hub algorithm. A bundle from a different
    configuration refuses cleanly at load instead of installing
    foreign (or shape-mismatched) state."""
    canon = json.dumps(fields, sort_keys=True, default=str)
    return hashlib.sha256(canon.encode("utf-8")).hexdigest()[:16]


def _atomic_write_bytes(path: str, data: bytes):
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)


def atomic_write_json(path: str, obj, indent=1):
    """One JSON document under the tmp+``os.replace`` contract — the
    durability pattern of this package, exported so its consumers
    (serve request records, group files, the endpoint file) share one
    implementation instead of hand-rolling the sequence."""
    _atomic_write_bytes(path,
                        (json.dumps(obj, indent=indent) + "\n").encode())


def atomic_savez(path: str, **arrays):
    """``np.savez`` with the tmp+rename contract — and WITHOUT savez's
    implicit ``.npz`` suffix games (the file lands at exactly
    ``path``). A SIGKILL mid-write can never leave a torn npz at the
    target."""
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)


def validate_state_arrays(d, keys=STATE_KEYS) -> dict:
    """The load-side ingest validation (the firewall of ingested bounds
    applied to checkpoint payloads): every state block finite, rho
    positive, iter a sane non-negative integer. Returns the plain-dict payload
    (host numpy) or raises a reasoned :class:`CheckpointError`."""
    out = {}
    for key in keys:
        if key not in d:
            raise CheckpointError("truncated", f"missing array {key!r}")
        a = np.asarray(d[key])
        if not np.isfinite(a).all():
            raise CheckpointError(
                "nonfinite", f"{key} carries non-finite entries")
        out[key] = a
    if "rho" in out and out["rho"].size and float(out["rho"].min()) <= 0:
        raise CheckpointError("bad_rho", "rho must be positive")
    if "iter" not in d:
        raise CheckpointError("truncated", "missing iter")
    it = int(np.asarray(d["iter"]))
    if it < 0 or it > _MAX_ITER:
        raise CheckpointError("bad_iter", f"iter={it}")
    out["iter"] = it
    return out


def _bundle_name(iteration: int, seq: int) -> str:
    return f"{_BUNDLE_PREFIX}{int(iteration):08d}-{int(seq):04d}"


def bundle_seq(name: str) -> int:
    """The capture sequence of a bundle directory name (0 for any other
    name)."""
    parts = name[len(_BUNDLE_PREFIX):].split("-") \
        if name.startswith(_BUNDLE_PREFIX) else []
    return int(parts[1]) if len(parts) == 2 and parts[1].isdigit() else 0


def write_bundle(ckpt_dir: str, hub_arrays: dict, meta: dict,
                 iteration: int, seq: int, keep: int = 3) -> str:
    """Capture one bundle under ``ckpt_dir``; returns the bundle path.

    ``hub_arrays``: host numpy blocks for ``hub.npz`` (STATE_KEYS +
    ``iter`` + anything extra, e.g. the hub nonant block).
    ``meta``: manifest fields (fingerprint, bounds, source chars, run
    id, reason). Live per-spoke snapshots under ``<ckpt_dir>/spokes/``
    are copied INTO the bundle so it stays self-contained — the live
    files keep moving after the capture. Retention prunes all but the
    newest ``keep`` bundles and re-points ``LATEST``."""
    os.makedirs(ckpt_dir, exist_ok=True)
    name = _bundle_name(iteration, seq)
    tmp_dir = os.path.join(ckpt_dir, f"{_TMP_PREFIX}{name}.{os.getpid()}")
    shutil.rmtree(tmp_dir, ignore_errors=True)
    os.makedirs(tmp_dir)
    with open(os.path.join(tmp_dir, HUB_NPZ), "wb") as f:
        np.savez(f, **hub_arrays)
    spoke_files = []
    live_spokes = os.path.join(ckpt_dir, "spokes")
    if os.path.isdir(live_spokes):
        for fn in sorted(os.listdir(live_spokes)):
            if fn.endswith(".npz"):
                shutil.copy2(os.path.join(live_spokes, fn),
                             os.path.join(tmp_dir, fn))
                spoke_files.append(fn)
    files = {fn: os.path.getsize(os.path.join(tmp_dir, fn))
             for fn in os.listdir(tmp_dir)}
    manifest = {
        "schema_version": SCHEMA_VERSION,
        "iter": int(iteration),
        "wall_time_unix": time.time(),
        "files": files,
        "spoke_files": spoke_files,
        **meta,
    }
    # the manifest is written LAST inside the temp dir: its presence is
    # what load_bundle treats as "this directory is a whole bundle"
    _atomic_write_bytes(os.path.join(tmp_dir, MANIFEST),
                        (json.dumps(manifest, indent=1) + "\n").encode())
    final = os.path.join(ckpt_dir, name)
    shutil.rmtree(final, ignore_errors=True)   # same (iter, seq) re-capture
    os.replace(tmp_dir, final)
    _atomic_write_bytes(os.path.join(ckpt_dir, LATEST),
                        (name + "\n").encode())
    _prune(ckpt_dir, keep)
    return final


def _bundle_dirs(ckpt_dir: str) -> list:
    try:
        names = os.listdir(ckpt_dir)
    except OSError:
        return []
    return sorted(n for n in names if n.startswith(_BUNDLE_PREFIX)
                  and os.path.isdir(os.path.join(ckpt_dir, n)))


def _prune(ckpt_dir: str, keep: int):
    """Retention: newest ``keep`` bundles survive; stale temp dirs from
    killed captures are swept too."""
    names = _bundle_dirs(ckpt_dir)
    for n in names[:max(0, len(names) - max(1, int(keep)))]:
        shutil.rmtree(os.path.join(ckpt_dir, n), ignore_errors=True)
    for n in os.listdir(ckpt_dir):
        if n.startswith(_TMP_PREFIX):
            shutil.rmtree(os.path.join(ckpt_dir, n), ignore_errors=True)


def latest_bundle(ckpt_dir: str) -> str | None:
    """Newest bundle path under a checkpoint dir, or None. The LATEST
    pointer wins; a missing/garbled pointer falls back to the
    lexicographically newest ``bundle-*`` dir (names sort by (iter,
    seq) by construction)."""
    try:
        name = open(os.path.join(ckpt_dir, LATEST),
                    encoding="utf-8").read().strip()
        if name and os.path.isfile(os.path.join(ckpt_dir, name, MANIFEST)):
            return os.path.join(ckpt_dir, name)
    except OSError:
        pass
    names = _bundle_dirs(ckpt_dir)
    return os.path.join(ckpt_dir, names[-1]) if names else None


def resolve_bundle(path: str) -> str:
    """``--resume-from`` accepts either a bundle dir or a checkpoint
    dir (resolved through LATEST/newest). Raises CheckpointError when
    neither holds a bundle."""
    if os.path.isfile(os.path.join(path, MANIFEST)):
        return path
    b = latest_bundle(path)
    if b is None:
        raise CheckpointError("not_found", f"no bundle under {path!r}")
    return b


def load_bundle(path: str, fingerprint: str | None = None):
    """Read + validate one bundle. Returns ``(manifest, hub_arrays,
    spoke_paths)`` where ``hub_arrays`` passed
    :func:`validate_state_arrays` and ``spoke_paths`` maps copied
    spoke-state filenames to absolute paths (each validated lazily by
    its consumer). Raises :class:`CheckpointError` with a reasoned
    token on ANY defect — the caller falls back to cold start."""
    path = resolve_bundle(path)
    mpath = os.path.join(path, MANIFEST)
    try:
        manifest = json.loads(open(mpath, encoding="utf-8").read())
    except OSError as e:
        raise CheckpointError("not_found", str(e)) from e
    except ValueError as e:
        raise CheckpointError("bad_manifest", str(e)) from e
    if not isinstance(manifest, dict):
        raise CheckpointError("bad_manifest", "manifest is not an object")
    if manifest.get("schema_version") != SCHEMA_VERSION:
        raise CheckpointError(
            "schema_mismatch",
            f"bundle schema {manifest.get('schema_version')!r} != "
            f"{SCHEMA_VERSION}")
    want = manifest.get("fingerprint")
    if fingerprint is not None and want is not None and want != fingerprint:
        raise CheckpointError(
            "fingerprint_mismatch",
            f"bundle was captured for config {want}, this run is "
            f"{fingerprint}")
    # size check against the manifest: a file torn by a mid-copy kill
    # (or a hand-truncated member) fails BEFORE np.load can misparse it
    for fn, size in (manifest.get("files") or {}).items():
        fp = os.path.join(path, fn)
        if not os.path.isfile(fp):
            raise CheckpointError("truncated", f"missing member {fn}")
        if os.path.getsize(fp) != int(size):
            raise CheckpointError(
                "truncated",
                f"{fn} is {os.path.getsize(fp)} bytes, manifest says "
                f"{size}")
    try:
        with np.load(os.path.join(path, HUB_NPZ)) as d:
            arrays = {k: np.asarray(d[k]) for k in d.files}
    except Exception as e:
        raise CheckpointError("bad_npz", str(e)) from e
    hub_arrays = validate_state_arrays(arrays)
    # carry validated extras (hub nonant block) through untouched —
    # finiteness applies to them too
    for k, a in arrays.items():
        if k not in hub_arrays and k != "iter":
            if not np.isfinite(a).all():
                raise CheckpointError("nonfinite",
                                      f"{k} carries non-finite entries")
            hub_arrays[k] = a
    spoke_paths = {fn: os.path.join(path, fn)
                   for fn in manifest.get("spoke_files") or []
                   if os.path.isfile(os.path.join(path, fn))}
    return manifest, hub_arrays, spoke_paths


def file_sha256(path: str, chunk: int = 1 << 16) -> str:
    """Streaming sha256 of one file (chunked — bundle members can be
    large and the migration transfer verifies them incrementally)."""
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            b = f.read(chunk)
            if not b:
                break
            h.update(b)
    return h.hexdigest()


def transfer_manifest(bundle_dir: str) -> dict:
    """``{name: {"size", "sha256"}}`` over every member of one bundle
    dir — the wire-integrity half of a live migration offer
    (serve/migrate): the receiver verifies each streamed member
    against this BEFORE the load_bundle semantic gates run, so a torn
    transfer is refused at the byte layer with a reasoned abort
    instead of surfacing as a mysterious npz parse error."""
    out = {}
    for fn in sorted(os.listdir(bundle_dir)):
        fp = os.path.join(bundle_dir, fn)
        if os.path.isfile(fp):
            out[fn] = {"size": os.path.getsize(fp),
                       "sha256": file_sha256(fp)}
    return out
