"""W / x̄ save & load: warm start and algorithm-state checkpointing (the
port of the JAX package's extensions/wxbar_io.py).

ref. mpisppy/utils/wxbarwriter.py:31, wxbarreader.py:32, wxbarutils.py:40-368.
The reference round-trips (W, x̄) through CSV files as its only warm-start /
checkpoint mechanism (SURVEY §5.4). The algorithm state here is a handful of
device tensors, so the native format is a single ``.npz`` holding
(W, xbar, xsqbar, rho, iter); a CSV mode matching the reference's
``(scenario, slot, value)`` / ``(slot, value)`` row shapes is kept for
interop and human inspection. The files are the JAX package's: either
package reads what the other writes.

Files carry REAL scenarios only. On an engine sharded over ranks
(parallel/mesh) every function here is collective: each rank calls it,
the blocks are gathered across the ranks, rank 0 alone writes, and on
load each rank installs its own rows of the re-padded whole.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..utils.runtime import to_host
from .extension import Extension

STATE_BLOCKS = ("W", "xbar", "xsqbar", "rho")


def _real_S(opt):
    """A sharded engine pads its scenario axis with zero-probability
    copies (parallel/mesh.pad_batch_for_mesh); a file with pad rows
    would refuse to load into an unsharded run of the same model."""
    return getattr(opt, "_S_orig", opt.batch.S)


def _writes(opt) -> bool:
    """True on the rank that writes files (every unsharded engine)."""
    mesh = getattr(opt, "shard_mesh", None)
    return mesh is None or mesh.rank == 0


def _scen_names(opt):
    return getattr(opt, "global_batch", opt.batch).tree.scen_names


def state_blocks(opt, keys=STATE_BLOCKS) -> dict:
    """The engine's (S_real, K) blocks ``keys`` as host numpy in the
    engine's dtype: one stack on the device, one gather across the
    ranks of a sharded engine, one device-to-host copy."""
    stacked = opt.gather_rows(torch.stack([getattr(opt, k) for k in keys],
                                          dim=1))
    host = to_host(stacked)[:_real_S(opt)]
    return {k: np.ascontiguousarray(host[:, i]) for i, k in enumerate(keys)}


def _placer(opt):
    """Engine-matched placement of a full (S_pad, K) host block: the
    engine's own device and dtype (taken from its W, never a default
    device), and on a sharded engine this rank's rows only."""
    ref = opt.W
    lo = getattr(opt, "_row0", 0)
    hi = lo + opt.batch.S

    def place(a):
        return torch.as_tensor(np.ascontiguousarray(a[lo:hi]),
                               dtype=ref.dtype, device=ref.device)
    return place


def _pad_rows(opt, a):
    """Real rows -> the engine's padded whole: pads ARE copies of the
    last scenario, so its rows are the consistent fill (pad W carries
    no objective weight)."""
    S = getattr(opt, "global_batch", opt.batch).S
    if a.shape[0] == S:
        return a
    return np.concatenate([a, np.repeat(a[-1:], S - a.shape[0], axis=0)])


def save_state(opt, path):
    """Checkpoint the PH algorithm state to ``path`` (npz). ATOMIC:
    written to a temp sibling and ``os.replace``'d, so a mid-write
    SIGKILL never leaves a torn npz at the target."""
    from ..ckpt.bundle import atomic_savez

    blocks = state_blocks(opt)
    if _writes(opt):
        atomic_savez(path, **blocks, iter=np.asarray(opt._iter))


def install_state_arrays(opt, d):
    """Install validated (W, x̄, x̄², ρ, iter) host blocks onto an
    engine: shape-checked against the REAL scenario count, mesh pads
    re-filled from the last real row, placed on the engine's device in
    its dtype, and the factors invalidated when rho moved. The one
    install body behind ``load_state`` and the checkpoint bundle resume
    (ckpt/manager.resume_hub)."""
    S_real, K = _real_S(opt), opt.batch.K
    for key in STATE_BLOCKS:
        if d[key].shape != (S_real, K):
            raise ValueError(f"{key} shape {d[key].shape} != "
                             f"({S_real}, {K})")
    place = _placer(opt)
    opt.W = place(_pad_rows(opt, np.asarray(d["W"])))
    opt.xbar = place(_pad_rows(opt, np.asarray(d["xbar"])))
    opt.xsqbar = place(_pad_rows(opt, np.asarray(d["xsqbar"])))
    new_rho = place(_pad_rows(opt, np.asarray(d["rho"])))
    moved = not torch.allclose(opt.rho.to(new_rho.dtype), new_rho)
    opt.rho = new_rho
    opt._iter = int(d["iter"])
    if moved:
        opt.invalidate_factors()


def load_state(opt, path):
    """Restore a checkpoint saved by ``save_state``. Payloads pass the
    same load-side validation as checkpoint bundles
    (ckpt.bundle.validate_state_arrays): non-finite blocks and absurd
    iteration counters are rejected with a reasoned error and a
    ``ckpt.rejected.<reason>`` counter instead of installing NaNs into
    the prox center."""
    from .. import obs
    from ..ckpt.bundle import CheckpointError, validate_state_arrays

    with np.load(path) as f:
        raw = {k: np.asarray(f[k]) for k in f.files}
    try:
        d = validate_state_arrays(raw)
    except CheckpointError as e:
        obs.counter_add(f"ckpt.rejected.{e.reason}")
        raise
    install_state_arrays(opt, d)


def _write_scen_csv(opt, path, arr):
    """(scenario, slot, value) rows of a real-row (S, K) block (mesh pad
    rows carry generated ``_pad*`` names an unsharded reader of the
    same model could never resolve)."""
    if not _writes(opt):
        return
    with open(path, "w") as f:
        f.write("scenario,slot,value\n")
        for s, name in enumerate(_scen_names(opt)[:_real_S(opt)]):
            for k in range(opt.batch.K):
                f.write(f"{name},{k},{arr[s, k]:.17g}\n")


def _read_scen_csv(opt, path, arr):
    """Fill a real-row (S, K) array in place from _write_scen_csv
    output, or from the legacy 2-column (slot, value) format
    (broadcast to all rows)."""
    name_to_s = {n: i for i, n in enumerate(_scen_names(opt))}
    with open(path) as f:
        header = next(f)
        per_scen = header.strip().startswith("scenario")
        for line in f:
            if per_scen:
                name, k, v = line.rsplit(",", 2)
                arr[name_to_s[name], int(k)] = float(v)
            else:
                k, v = line.split(",")
                arr[:, int(k)] = float(v)
    return arr


def write_w_csv(opt, path):
    """(scenario, slot, value) rows (ref. wxbarutils.py:40 w_writer)."""
    _write_scen_csv(opt, path, state_blocks(opt, ("W",))["W"])


def _read_and_install(opt, path, key):
    """Shared body of the CSV readers: fill real rows from the file,
    re-fill mesh pad rows from the last real row (as ``load_state``),
    and place them as the engine's."""
    a = _read_scen_csv(opt, path, state_blocks(opt, (key,))[key].copy())
    return _placer(opt)(_pad_rows(opt, a))


def read_w_csv(opt, path):
    opt.W = _read_and_install(opt, path, "W")


def write_xbar_csv(opt, path):
    """(scenario, slot, value) rows: the full (S, K) block. On multistage
    trees x̄ rows differ per node path, so a root-row-only dump would
    lose every non-root node's mean (ref. wxbarutils.py xbar_writer
    writes per-node values)."""
    _write_scen_csv(opt, path, state_blocks(opt, ("xbar",))["xbar"])


def read_xbar_csv(opt, path):
    opt.xbar = _read_and_install(opt, path, "xbar")


class WXBarWriter(Extension):
    """options: {"W_fname": path or None, "Xbar_fname": path or None,
    "ckpt_fname": path or None, "every": int}. CSV names mirror the
    reference's PHoptions keys (ref. wxbarwriter.py:52-66)."""

    def __init__(self, options=None):
        super().__init__(options)
        self.w_fname = self.options.get("W_fname")
        self.x_fname = self.options.get("Xbar_fname")
        self.ckpt_fname = self.options.get("ckpt_fname")
        self.every = int(self.options.get("every", 0))  # 0 = only at end

    def _dump(self, opt):
        if self.w_fname:
            write_w_csv(opt, self.w_fname)
        if self.x_fname:
            write_xbar_csv(opt, self.x_fname)
        if self.ckpt_fname:
            save_state(opt, self.ckpt_fname)

    def enditer(self, opt):
        if self.every and opt._iter % self.every == 0:
            self._dump(opt)

    def post_everything(self, opt):
        self._dump(opt)


class WXBarReader(Extension):
    """options: {"init_W_fname", "init_Xbar_fname", "init_ckpt_fname"}
    (ref. wxbarreader.py:40-55). Loads before iter 0 so PH resumes."""

    def __init__(self, options=None):
        super().__init__(options)
        self.w_fname = self.options.get("init_W_fname")
        self.x_fname = self.options.get("init_Xbar_fname")
        self.ckpt_fname = self.options.get("init_ckpt_fname")

    def pre_iter0(self, opt):
        if self.ckpt_fname and os.path.exists(self.ckpt_fname):
            load_state(opt, self.ckpt_fname)
            opt._warm_started = True
            opt._warm_started_xbar = True   # the file restores x̄ too
            return
        if self.w_fname and os.path.exists(self.w_fname):
            read_w_csv(opt, self.w_fname)
            opt._warm_started = True
        if self.x_fname and os.path.exists(self.x_fname):
            read_xbar_csv(opt, self.x_fname)
            # an x̄-only load must keep iter 0 from overwriting the
            # loaded prox center, or the warm start is a silent no-op
            opt._warm_started_xbar = True
