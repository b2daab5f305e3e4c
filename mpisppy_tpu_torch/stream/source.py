"""ScenarioSource: where a chunked engine's per-scenario vectors come
from (the port of mpisppy_tpu/stream/source.py).

The chunked hot loop (core/ph._solve_loop_chunked) consumes five
per-scenario vector fields: ``l``/``u`` (S, m) and ``lb``/``ub``/``c``
(S, n). The resident path ships all of them to the device at engine
build (core/spbase) and slices per chunk; at the reference UC one
scenario's fields take 0.73 MB, so S = 100k would need 73 GB before any
solver state. A :class:`ScenarioSource` stages them per chunk instead:

- :class:`StreamedSource`: the fields live on the HOST (optionally int8
  delta-packed, stream/quant.py); a :class:`~.pipeline.ChunkPipeline`
  prefetch thread copies chunk k+1's blocks through pinned buffers on
  a side stream while the card solves chunk k.
- :class:`SynthesizedSource`: nothing is stored or copied: the seeded
  generator (stream/synth.py) makes each chunk's rhs/bound
  perturbations on the device from ``(seed, scenario_id)``.

Both give the engine the same surface:

- ``setup_arrays(dtype)``: EXACT 2-row surrogates of the full-width
  setup reductions (below), so qp_setup builds factors bit-equal to
  the resident path's;
- ``bind(key, ids)`` / ``begin_pass()`` / ``chunk(ci)``: the in-order
  chunk staging protocol (two passes per PH iteration: solve and
  objectives);
- ``fetch(ci)`` / ``rows(ids)``: direct staging for the exceptional
  paths (cold-state build, chunk retries, the scenario hospital);
- ``status()``: a plain host dict; ``close()``: idempotent pipeline
  shutdown (engine ``close_stream``, hub finalize).

The setup surrogate: for a shared-structure batch, qp_setup reads the
full-width vectors only through three reductions (ops/qp_solver
``_rho_patterns`` and ``_setup_vectors``): the all-scenario equality
patterns ``all_s(l == u)`` / ``all_s(lb == ub)`` (under ``_is_eq``'s
relative tolerance) and the cost scale ``max_{s,j} |D_j c_{s,j}|``;
equilibration reads A and P only. A 2-row surrogate that encodes those
reductions (pattern rows: (0, 0) where equal, (0, 1) where not; c rows:
the per-column |c| max) therefore yields the same factors, which is
what makes streamed and synthesized trajectories EQUAL to resident ones
rather than close. On a scenario mesh each rank's surrogates cover its
shard, and qp_setup's own all-reduces (``_global_all``,
``_global_max``) combine them.

Every device placement goes through one ``_put`` (or the pinned
stager) that books ``xfer.device_put_bytes`` and
``stream.bytes_shipped``, or ``stream.compacted_restage_bytes`` for the
out-of-band restage of a compaction.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import obs
from .pipeline import ChunkPipeline, H2DStager, adopt
from .quant import _reconstruct_f32, dequantize_cols, quantize_field
from .synth import SOURCE_FIELDS, synth_values

# must match ops/qp_solver._is_eq's predicate
_EQ_TOL = 1e-9

_NP_DTYPES = {torch.float64: np.float64, torch.float32: np.float32}


def _np_dtype(dtype):
    """The engine dtype as a numpy dtype (host casts must round the way
    the device ship would)."""
    return np.dtype(_NP_DTYPES[dtype])


def _eq_pattern(l, u, dtype=None):
    """The qp_setup equality predicate, on values cast to the engine
    dtype first (the resident path computes it on the shipped arrays)."""
    if dtype is not None:
        t = _np_dtype(dtype)
        l = np.asarray(l, t)
        u = np.asarray(u, t)
    with np.errstate(invalid="ignore"):    # inf - inf
        d = u - l
        return np.isfinite(d) & (np.abs(d) <= _EQ_TOL * (1.0 + np.abs(u)))


def _surrogate_pair(eq: np.ndarray):
    """(lo, hi) 2-row surrogates whose all-rows equality pattern is
    exactly ``eq``: row 0 is (0, 0) everywhere, row 1 breaks the
    non-eq columns with (0, 1)."""
    lo = np.zeros((2,) + eq.shape)
    hi = np.stack([np.zeros(eq.shape), np.where(eq, 0.0, 1.0)])
    return lo, hi


class ScenarioSource:
    """Shared plumbing: layout binding, direct staging, device
    placement, status accounting. Subclasses stage rows
    (``_stage_rows``) and serve the in-order chunks (``chunk``).
    ``id_offset``: the global id of this engine's row 0 (a mesh rank's
    shard offset); rows and chunk ids are local."""

    kind = "abstract"
    fields = SOURCE_FIELDS

    def __init__(self, dtype, device, depth: int = 2, id_offset: int = 0):
        self.dtype = dtype
        self.device = torch.device(device)
        self.depth = int(depth)
        self.id_offset = int(id_offset)
        self._layout_key = None
        self._np_ids = None          # list[np.ndarray] per chunk
        # a compaction's one full restage books on its own counter, not
        # the per-iteration bytes_shipped
        self._oob_book = False
        # whether the bound layout stages COMPACTED blocks
        self._bind_compacted = False
        self._status = {"source": self.kind, "chunks_shipped": 0,
                        "bytes_shipped": 0, "synth_chunks": 0,
                        "int8_fallbacks": 0, "direct_fetches": 0}

    # ---- layout ----
    @property
    def bound_key(self):
        """The bound chunk-layout key (None when unbound)."""
        return self._layout_key

    def bind(self, key, np_ids, compacted=False):
        """(Re)bind the chunk layout: ``np_ids[ci]`` are chunk ci's
        local scenario rows in chunk-row order (tail chunks repeat their
        last row, as core/ph's slice maps do). A changed layout starts
        afresh; an unchanged one is a no-op. ``compacted`` is part of
        the layout: a full-width bind and a compacted bind never share a
        key."""
        if key == self._layout_key:
            return
        self.close()
        self._layout_key = key
        self._bind_compacted = bool(compacted)
        self._np_ids = [np.asarray(ids) for ids in np_ids]
        self._after_bind()

    def _after_bind(self):
        pass

    def begin_pass(self, gated=False):
        """Rewind staging to chunk 0 (before the solve pass, ``gated``,
        and again before the objective pass of each PH iteration)."""

    def release(self, ci: int):
        """The engine is about to solve chunk ``ci`` (a gated pass)."""

    def fetch(self, ci: int) -> dict:
        """Direct (pipeline-bypassing) staging of chunk ci: cold-state
        builds and chunk retries."""
        self._status["direct_fetches"] += 1
        obs.counter_add("stream.direct_fetches")
        return self._stage_rows(self._np_ids[ci])

    def rows(self, np_ids, compacted=None) -> dict:
        """Device blocks for arbitrary local scenario rows (the
        hospital's rescue assembly). ``compacted`` overrides the bound
        layout's store (None: follow the bind)."""
        self._status["direct_fetches"] += 1
        obs.counter_add("stream.direct_fetches")
        return self._stage_rows(np.asarray(np_ids), compacted=compacted)

    # ---- lifecycle / accounting ----
    def status(self) -> dict:
        """Plain host ints."""
        return dict(self._status)

    def close(self):
        """Idempotent: forget the bound layout (the next pass binds)."""
        self._layout_key = None

    @property
    def prefetch_alive(self) -> bool:
        return False

    def _book(self, nb):
        obs.counter_add("xfer.device_put_bytes", nb)
        if self._oob_book:
            self._status["compacted_restage_bytes"] = \
                self._status.get("compacted_restage_bytes", 0) + nb
            obs.counter_add("stream.compacted_restage_bytes", nb)
        else:
            self._status["bytes_shipped"] += nb
            obs.counter_add("stream.bytes_shipped", nb)

    def _put(self, a_np):
        """Host block -> device tensor on the calling thread's current
        stream (a blocking copy from page-locked memory on the card),
        with the placement bytes booked."""
        a = np.ascontiguousarray(a_np)
        if not a.flags.writeable:
            a = a.copy()
        self._book(int(a.nbytes))
        t = torch.from_numpy(a)
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device)
        return t


class StreamedSource(ScenarioSource):
    """Host-resident field store, double-buffered H2D chunk staging.
    With ``int8`` the store packs each field's per-scenario deltas int8
    behind the host-side gate (stream/quant.py); gate-rejected fields
    keep f64 storage and book ``stream.int8_fallbacks``. Fields whose
    rows are all identical (the template-shared c of a rhs-randomness
    family) are detected at build and never shipped per chunk: the
    template row lives on the device once and broadcasts."""

    kind = "streamed"

    def __init__(self, batch, dtype, device, depth=2, id_offset=0,
                 int8=False, int8_tol=1e-3):
        super().__init__(dtype, device, depth=depth, id_offset=id_offset)
        self._store = {}       # field -> ("const", tmpl) | ("f64", arr)
        #                        | ("int8", Int8Field)
        self._cstore = None    # compacted-width twin (install_compacted)
        self._tmpl_dev = {}
        self._tmpl_dev_c = {}
        self._pipeline = None
        self._stager = None
        self._status["compacted_transitions"] = 0
        self._status["compacted_restage_bytes"] = 0
        self.install(batch, int8=int8, int8_tol=int8_tol)

    def install(self, batch, int8=None, int8_tol=None):
        """(Re)build the host store from a batch's stacked arrays. Keeps
        the quantization policy unless overridden."""
        if int8 is not None:
            self._int8 = bool(int8)
        if int8_tol is not None:
            self._int8_tol = float(int8_tol)
        self.close()
        self._store = self._build_store(
            {f: getattr(batch, f) for f in self.fields})
        self._cstore = None
        self._tmpl_dev = {}
        self._tmpl_dev_c = {}
        self._S = int(np.asarray(batch.l).shape[0])

    def _build_store(self, arrays, compacted=False):
        store = {}
        for f, a in arrays.items():
            a = np.asarray(a, np.float64)
            tmpl = a[0]
            if a.shape[0] > 1 and (a == tmpl[None, :]).all():
                store[f] = ("const", tmpl.copy())
                continue
            if self._int8:
                fld = quantize_field(a, tmpl, self._int8_tol)
                if fld is not None:
                    store[f] = ("int8", fld)
                    continue
                self._status["int8_fallbacks"] += 1
                obs.counter_add("stream.int8_fallbacks")
                obs.event("stream.int8_fallback",
                          {"field": f, "compacted": compacted})
            store[f] = ("f64", a.copy())
        return store

    def host_nbytes(self) -> int:
        """Host residency of the store (Int8Field.nbytes counts the
        packed representation)."""
        nb = sum(val.nbytes for _, val in self._store.values())
        if self._cstore is not None:
            nb += sum(val.nbytes for _, val in self._cstore.values())
        return nb

    def _after_bind(self):
        self._templates(self._bind_compacted)
        self._pipeline = ChunkPipeline(
            self._stage_chunk_async, len(self._np_ids), depth=self.depth,
            device=self.device if self.device.type == "cuda" else None)

    def begin_pass(self, gated=False):
        self._pipeline.start_pass(gated=gated)

    def release(self, ci: int):
        """On a gated pass the producer may now stage chunk ci + 1, its
        copy ordered after this point of the engine's stream."""
        ev = None
        if self.device.type == "cuda":
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(self.device))
        self._pipeline.release(ci, ev)

    def chunk(self, ci: int) -> dict:
        """Chunk ci's staged device blocks (in order, prefetched)."""
        blk, ev = self._pipeline.get(ci)
        return adopt(blk, ev, self.device)

    def close(self):
        if self._pipeline is not None:
            self._pipeline.close()
            self._pipeline = None
        super().close()

    @property
    def prefetch_alive(self) -> bool:
        return self._pipeline is not None and self._pipeline.alive

    def _templates(self, compacted):
        """The store's device-resident parts, placed once per store on
        the calling (engine) thread: a const field's template row, an
        int8 field's template row and varying-column index."""
        store = self._cstore if compacted else self._store
        cache = self._tmpl_dev_c if compacted else self._tmpl_dev
        placed = False
        for f in self.fields:
            kind, val = store[f]
            if f in cache or kind == "f64":
                continue
            if kind == "const":
                # pre-cast on the host: engine-dtype bytes on the wire
                cache[f] = self._put(np.asarray(val,
                                                _np_dtype(self.dtype)))
            else:
                vidx = np.flatnonzero(val.varying).astype(np.int64)
                cache[f] = (self._put(np.asarray(val.tmpl, np.float64)),
                            self._put(vidx), vidx)
            placed = True
        if placed and self.device.type == "cuda":
            # the producer thread's side stream reads these: their
            # copies finish before any chunk of the layout is staged
            torch.cuda.current_stream(self.device).synchronize()
        return store, cache

    def _host_parts(self, ids, store, cache):
        """The host arrays one chunk ships: per f64 field its rows cast
        to the engine dtype on the host (an f32 engine pays f32 wire
        bytes; the rounding is the device's), per int8 field q over the
        varying columns and the per-block scale and zero."""
        parts = {}
        for f in self.fields:
            kind, val = store[f]
            if kind == "int8":
                parts[f + ".q"] = val.q[ids][:, cache[f][2]]
                parts[f + ".s"] = val.scale[ids]
                parts[f + ".z"] = val.zero[ids]
            elif kind == "f64":
                parts[f] = val[ids].astype(_np_dtype(self.dtype))
        return parts

    def _finish(self, dev, store, cache, rows):
        """Device blocks from the placed parts: const fields broadcast
        their template row, int8 fields dequantize."""
        out = {}
        for f in self.fields:
            kind, _ = store[f]
            if kind == "const":
                td = cache[f]
                out[f] = td[None, :].expand(rows, td.shape[0])
            elif kind == "int8":
                td = cache[f]
                out[f] = dequantize_cols(td[0], td[1], dev[f + ".q"],
                                         dev[f + ".s"], dev[f + ".z"],
                                         self.dtype)
            else:
                out[f] = dev[f]
        return out

    def _store_for(self, compacted):
        if compacted is None:
            compacted = self._bind_compacted
        if compacted and self._cstore is None:
            raise RuntimeError(
                "compacted staging requested before install_compacted")
        return self._templates(compacted)

    def _count_chunk(self):
        if not self._oob_book:   # restages are not chunks
            self._status["chunks_shipped"] += 1
            obs.counter_add("stream.chunks_shipped")

    def _stage_rows(self, ids, compacted=None) -> dict:
        """Direct staging on the calling thread's current stream."""
        store, cache = self._store_for(compacted)
        parts = self._host_parts(ids, store, cache)
        dev = {k: self._put(a) for k, a in parts.items()}
        out = self._finish(dev, store, cache, ids.shape[0])
        self._count_chunk()
        return out

    def _stage_chunk_async(self, ci: int, after=None):
        """The producer thread's staging of chunk ci: the parts go
        through the pinned ring on the side stream (after ``after``, a
        gated pass's release event; dequantization runs there too) and
        the chunk's event closes it."""
        ids = self._np_ids[ci]
        store = self._cstore if self._bind_compacted else self._store
        cache = self._tmpl_dev_c if self._bind_compacted \
            else self._tmpl_dev
        if self._stager is None:
            self._stager = H2DStager(self.device, self.depth + 2)
        parts = self._host_parts(ids, store, cache)
        dev = self._stager.stage(parts, after=after)
        for a in parts.values():
            self._book(int(np.asarray(a).nbytes))
        side = self._stager.stream
        if side is not None:
            with torch.cuda.stream(side):
                out = self._finish(dev, store, cache, ids.shape[0])
        else:
            out = self._finish(dev, store, cache, ids.shape[0])
        ev = self._stager.record()
        self._count_chunk()
        return out, ev

    def stage_full(self) -> dict:
        """One out-of-band FULL-width staging of every scenario row (a
        compaction transition's build_plan input). Its bytes book on
        ``stream.compacted_restage_bytes`` and it counts as neither a
        chunk nor a direct fetch."""
        self._oob_book = True
        try:
            return self._stage_rows(np.arange(self._S), compacted=False)
        finally:
            self._oob_book = False

    def install_compacted(self, plan):
        """Rebuild the host store at a shrink plan's compacted widths.
        The folded/shifted ``l``/``u`` and kept-column ``lb``/``ub``
        come to the host once per transition from the plan's device
        blocks; const detection and int8 re-quantization run again at
        the compacted width. ``c`` stays the FULL-width store entry: the
        loop gathers the kept columns per chunk, and the objectives want
        full width. The values round-trip exactly, so compacted
        streamed chunks equal compacted resident slices wherever int8
        is off."""
        self.close()
        arrays = {}
        for f in ("l", "u", "lb", "ub"):
            a = getattr(plan.data_c, f).cpu().numpy().astype(np.float64)
            obs.counter_add("xfer.d2h_bytes", a.nbytes)
            arrays[f] = a
        cstore = self._build_store(arrays, compacted=True)
        cstore["c"] = self._store["c"]
        self._cstore = cstore
        self._tmpl_dev_c = {}
        self._status["compacted_transitions"] += 1
        obs.counter_add("stream.compacted_transitions")

    def setup_arrays(self, dtype, keep_cols=None):
        """Exact 2-row setup surrogates from one host pass over the
        store (module docstring). ``keep_cols``: the COMPACTED problem's
        surrogates: l/u/lb/ub patterns over the compacted store, the
        cost scale as the FULL per-column |c| max gathered at the kept
        columns (gather and per-column max commute)."""
        store = self._store if keep_cols is None else self._cstore
        vals = {}
        for f in self.fields:
            kind, val = store[f]
            if kind == "const":
                vals[f] = val[None, :]
            elif kind == "int8":
                # the pattern must reflect the QUANTIZED values
                vals[f] = _reconstruct_f32(val, slice(None))
            else:
                vals[f] = val
        eq_rows = _eq_pattern(vals["l"], vals["u"], dtype).all(axis=0)
        eq_cols = _eq_pattern(vals["lb"], vals["ub"], dtype).all(axis=0)
        c_max = np.abs(np.asarray(vals["c"],
                                  _np_dtype(dtype))).max(axis=0)
        if keep_cols is not None:
            c_max = c_max[np.asarray(keep_cols)]
        return _surrogates(eq_rows, eq_cols, c_max, dtype, self.device)


def _surrogates(eq_rows, eq_cols, c_max, dtype, device):
    l2, u2 = _surrogate_pair(eq_rows)
    lb2, ub2 = _surrogate_pair(eq_cols)
    c2 = np.broadcast_to(c_max, (2,) + c_max.shape)
    return tuple(torch.as_tensor(np.ascontiguousarray(a),
                                 dtype=dtype).to(device)
                 for a in (l2, u2, lb2, ub2, c2))


class SynthesizedSource(ScenarioSource):
    """Template rows on the device + the seeded generator: chunk
    staging ships no scenario data (a steady-state iteration's
    ``xfer.device_put_bytes`` is zero). Chunks are made on the engine
    thread's stream: no prefetch thread, no copy."""

    kind = "synthesized"

    def __init__(self, batch, spec, dtype, device, depth=2, id_offset=0):
        super().__init__(dtype, device, depth=depth, id_offset=id_offset)
        self.spec = spec
        # this engine's row count (a mesh shard's, pads included: pad
        # ids synthesize fresh zero-probability scenarios)
        self._S = int(batch.S)
        # template rows (the batch vectors are broadcast views of them,
        # synth.synth_batch(materialize_values=False))
        self._tmpl = {f: np.asarray(getattr(batch, f), np.float64)[0]
                      for f in self.fields}
        self._tmpl_dev = None
        self._ids_dev = None

    def _after_bind(self):
        # synthesis is full-width by construction (the engine keeps
        # compaction off synthesized sources). The per-chunk GLOBAL id
        # vectors live on the device once, booked as the one placement
        # of a synth bind
        self._ids_dev = [self._put(ids.astype(np.int64) + self.id_offset)
                         for ids in self._np_ids]

    def _assemble(self, gids):
        if self._tmpl_dev is None:
            # the shared template rows: placed once per source
            self._tmpl_dev = {f: self._put(
                np.asarray(v, _np_dtype(self.dtype)))
                for f, v in self._tmpl.items()}
        rows = int(gids.shape[0])
        out = {f: t[None, :].expand(rows, t.shape[0])
               for f, t in self._tmpl_dev.items()}
        owned = set()
        for fld, v in zip(self.spec.fields,
                          synth_values(self.spec, gids)):
            if fld.field not in owned:
                out[fld.field] = out[fld.field].clone()
                owned.add(fld.field)
            out[fld.field][:, fld.start:fld.stop] = v.to(self.dtype)
        return out

    def chunk(self, ci: int) -> dict:
        self._status["synth_chunks"] += 1
        obs.counter_add("stream.synth_chunks")
        return self._assemble(self._ids_dev[ci])

    def fetch(self, ci: int) -> dict:
        self._status["direct_fetches"] += 1
        obs.counter_add("stream.direct_fetches")
        return self.chunk(ci)

    def _stage_rows(self, ids, compacted=None) -> dict:
        return self._assemble(torch.as_tensor(
            np.asarray(ids, np.int64) + self.id_offset, device=self.device))

    def setup_arrays(self, dtype, batch_rows: int = 8192):
        """Exact surrogates from ONE streaming pass of the generator
        over this engine's scenarios: id batches are generated on the
        device, their equality patterns folded into the running
        all-scenario AND on the host, and the batch dropped (S = 1M
        costs time, never memory). Untouched fields keep the template's
        own pattern; c is untouched by every synth spec, so the cost
        surrogate is |template c|."""
        tmpl = self._tmpl
        eq_rows = _eq_pattern(tmpl["l"][None], tmpl["u"][None], dtype)[0]
        eq_cols = _eq_pattern(tmpl["lb"][None], tmpl["ub"][None],
                              dtype)[0]
        touched = {f.field for f in self.spec.fields}
        if touched:
            # for a pair the spec touches, the all-scenario pattern is
            # the generated scenarios' alone: it REPLACES the
            # template's (a spec may pin a row the template left open)
            gen_rows = np.ones(tmpl["l"].shape, bool)
            gen_cols = np.ones(tmpl["lb"].shape, bool)
            for lo in range(0, self._S, batch_rows):
                hi = min(lo + batch_rows, self._S)
                gids = torch.arange(lo + self.id_offset,
                                    hi + self.id_offset,
                                    dtype=torch.int64, device=self.device)
                blk = {f: np.broadcast_to(
                    tmpl[f], (hi - lo,) + tmpl[f].shape).copy()
                    for f in touched}
                for fld, v in zip(self.spec.fields,
                                  synth_values(self.spec, gids)):
                    blk[fld.field][:, fld.start:fld.stop] = \
                        v.cpu().numpy().astype(np.float64)
                if touched & {"l", "u"}:
                    gen_rows &= _eq_pattern(
                        blk.get("l", tmpl["l"][None]),
                        blk.get("u", tmpl["u"][None]), dtype).all(axis=0)
                if touched & {"lb", "ub"}:
                    gen_cols &= _eq_pattern(
                        blk.get("lb", tmpl["lb"][None]),
                        blk.get("ub", tmpl["ub"][None]),
                        dtype).all(axis=0)
            if touched & {"l", "u"}:
                eq_rows = gen_rows
            if touched & {"lb", "ub"}:
                eq_cols = gen_cols
        c_max = np.abs(np.asarray(tmpl["c"], _np_dtype(dtype)))
        return _surrogates(eq_rows, eq_cols, c_max, dtype, self.device)


def make_source(batch, options: dict, dtype, device, id_offset=0):
    """The engine build's factory (core/spbase): the ``scenario_source``
    option as a source, or None for the resident path. ``id_offset``:
    the global id of the engine's row 0 (a mesh rank's shard)."""
    src = str(options.get("scenario_source", "resident"))
    if src == "resident":
        return None
    depth = int(options.get("stream_depth", 2))
    if src == "streamed":
        return StreamedSource(
            batch, dtype, device, depth=depth, id_offset=id_offset,
            int8=bool(options.get("stream_int8", False)),
            int8_tol=float(options.get("stream_int8_tol", 1e-3)))
    if src == "synthesized":
        spec = options.get("synth_spec")
        if spec is None:
            raise ValueError(
                "scenario_source='synthesized' needs a synth_spec "
                "engine option (models exporting scenario_synth_spec "
                "get it through utils/vanilla)")
        return SynthesizedSource(batch, spec, dtype, device, depth=depth,
                                 id_offset=id_offset)
    raise ValueError(f"unknown scenario_source {src!r}; known: "
                     "('resident', 'streamed', 'synthesized')")
