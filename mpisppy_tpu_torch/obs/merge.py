"""Merge per-process telemetry traces onto one wall-clock timeline.
(A copy of the JAX package's obs/merge.py; the port keeps its own.)

A multi-process cylinder run leaves one Chrome trace per process in
the shared run directory: the hub's ``trace.json`` plus one
``trace-<role>.json`` per spoke child (utils/multiproc.py). Each
process stamps spans with its OWN ``time.perf_counter()`` — monotonic
but with an arbitrary per-process origin, so the raw files cannot be
overlaid. Every :class:`.trace.TraceBuffer` therefore
records a (wall_time_unix, perf_counter) anchor pair read
back-to-back at construction; this module uses those anchors to map
every span to the shared wall clock and emits ONE Perfetto-loadable
``trace_merged.json`` where the hub's PH phases and each spoke's
bound work render as parallel process tracks.

Alignment: for a process with anchor (w, p), a span stamp ``ts`` (in
perf_counter microseconds) happened at wall time ``w + (ts/1e6 - p)``
seconds. The merge rebases all processes onto the earliest anchor so
merged timestamps stay small. Pre-anchor traces (schema 1) fall back
to their events file's ``run_header`` anchor; a file with no anchor at
all is included unshifted on its own timeline (still loadable, just
not aligned) and flagged in the metadata.
"""

from __future__ import annotations

import glob
import json
import os


def _anchor_from_events(run_dir, role):
    """Fallback anchor for pre-anchor traces: the matching events
    file's run_header carries the same (wall, perf_counter) pair.
    Rotation-transparent by construction: a size-capped rotation
    (obs/events.py) re-emits the ORIGINAL header — same anchor pair,
    plus a ``rotated`` marker — as the new current file's first line,
    so this first-line read stays correct mid-rotation."""
    name = f"events-{role}.jsonl" if role else "events.jsonl"
    path = os.path.join(run_dir, name)
    try:
        with open(path, encoding="utf-8") as f:
            head = json.loads(f.readline())
        if head.get("type") == "run_header":
            return {"wall_time_unix": head["wall_time_unix"],
                    "perf_counter": head["t"]}
    except Exception:
        pass
    return None


def trace_files(run_dir):
    """The hub trace + every role trace in a run directory (merged
    outputs excluded)."""
    out = []
    hub = os.path.join(run_dir, "trace.json")
    if os.path.exists(hub):
        out.append(hub)
    out += sorted(glob.glob(os.path.join(run_dir, "trace-*.json")))
    return [p for p in out if not p.endswith("trace_merged.json")]


def merge_traces(run_dir, out_name="trace_merged.json"):
    """Merge every per-process trace in ``run_dir`` into one aligned
    Chrome trace. Returns the output path, or None when there is
    nothing to merge. Each source file's events keep their relative
    timing exactly; only the origin shifts (monotonic stamps cannot be
    reordered by the alignment — the anchors are the single sanctioned
    monotonic->wall conversion, doc/observability.md "Clocks")."""
    files = trace_files(run_dir)
    if not files:
        return None
    sources = []
    for path in files:
        try:
            with open(path, encoding="utf-8") as f:
                data = json.load(f)
        except Exception:
            continue        # a torn write (killed child) skips one file
        meta = data.get("metadata") or {}
        anchor = None
        if "perf_counter" in meta and "wall_time_unix" in meta:
            anchor = {"wall_time_unix": meta["wall_time_unix"],
                      "perf_counter": meta["perf_counter"]}
        else:
            anchor = _anchor_from_events(run_dir, meta.get("role"))
        sources.append((path, data, meta, anchor))
    if not sources:
        return None
    anchored = [a["wall_time_unix"] for _, _, _, a in sources if a]
    wall0 = min(anchored) if anchored else None
    merged = []
    roles = []
    unaligned = []
    for i, (path, data, meta, anchor) in enumerate(sources):
        role = meta.get("role") or ("hub" if i == 0 else
                                    os.path.basename(path))
        roles.append(role)
        if anchor is not None and wall0 is not None:
            # perf µs -> µs since the earliest process's anchor
            shift_us = ((anchor["wall_time_unix"] - wall0)
                        - anchor["perf_counter"]) * 1e6
        else:
            shift_us = 0.0
            unaligned.append(role)
        # remap pids per source: a same-host run CAN reuse pids (and
        # in-process tests share one), which would fold two processes
        # onto one Perfetto track
        pid_map = {}

        def track(old_pid):
            new_pid = pid_map.get(old_pid)
            if new_pid is None:
                new_pid = pid_map[old_pid] = (i + 1) * 1000 \
                    + len(pid_map)
                merged.append({"name": "process_name", "ph": "M",
                               "pid": new_pid, "tid": 0,
                               "args": {"name": f"{role} "
                                                f"(pid {old_pid})"}})
            return new_pid

        for ev in data.get("traceEvents", ()):
            if ev.get("ph") == "M" and ev.get("name") == "process_name":
                # replaced by a role-labelled process_name: every
                # process gets its track, also one that recorded no
                # span (a spoke stopped before its first solve)
                track(ev.get("pid", 0))
                continue
            ev = dict(ev)
            ev["pid"] = track(ev.get("pid", 0))
            if "ts" in ev:
                ev["ts"] = ev["ts"] + shift_us
            merged.append(ev)
    out_path = os.path.join(run_dir, out_name)
    tmp = out_path + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"traceEvents": merged,
                   "displayTimeUnit": "ms",
                   "metadata": {"merged_from": [os.path.basename(p)
                                                for p, _, _, _ in sources],
                                "roles": roles,
                                "unaligned_roles": unaligned,
                                "clock": "wall_us_since_first_anchor",
                                "wall_time_unix_origin": wall0}}, f)
    os.replace(tmp, out_path)
    return out_path
