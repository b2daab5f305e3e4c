"""Resource accounting: device memory and transfer bytes (the port of
the JAX package's obs/resource.py).

Two surfaces:

 - **Memory watermarks** (:func:`sample_memory`): per-card
   ``torch.cuda.memory_allocated`` / ``max_memory_allocated`` gauges
   (``mem.cuda<i>.bytes_in_use`` + ``.peak_bytes_in_use``), sampled
   once per PH iteration. A guarded no-op on the CPU and in a process
   whose CUDA context never started (sampling must not start one).
 - **Transfer byte helpers** (:func:`tree_nbytes`, :func:`put_nbytes`):
   the instrumented sites (the chunked loop's gate reads, the batch
   shipping of core/spbase, the stream stagers, the mesh collectives)
   guard with ``obs.enabled()`` and add to ``xfer.d2h_bytes`` /
   ``xfer.device_put_bytes`` / ``xfer.collective_bytes`` so the
   disabled path never computes a byte count.

The JAX module's third surface, the XLA compile hooks, has no
counterpart: the port compiles no programs at run time (its one
kernel build is booked as a ``kernel.build`` event by
ops/kernels/_build.py), so a port run books no ``jax.*`` counters and
``analyze`` reads it as a run without compiles.
"""

from __future__ import annotations


def _active():
    from . import active
    return active()


# ---- device memory watermarks ----
def sample_memory(event=False):
    """Sample the CUDA caching allocator of every visible card into
    gauges (``mem.cuda<i>.bytes_in_use`` + ``.peak_bytes_in_use``).
    Returns the sampled {dev: stats} map ({} when disabled, on the CPU,
    or before this process started CUDA). With ``event=True`` also
    emits one ``resource.memory`` event carrying the per-device byte
    counts."""
    r = _active()
    if r is None:
        return {}
    try:
        import torch
        if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
            return {}
        n = torch.cuda.device_count()
    except Exception:
        return {}
    out = {}
    for i in range(n):
        key = f"cuda{i}"
        in_use = int(torch.cuda.memory_allocated(i))
        peak = int(torch.cuda.max_memory_allocated(i))
        r.metrics.gauge_set(f"mem.{key}.bytes_in_use", in_use)
        r.metrics.gauge_set(f"mem.{key}.peak_bytes_in_use", peak)
        out[key] = {"bytes_in_use": in_use, "peak_bytes_in_use": peak}
    if event and out:
        r.event("resource.memory", {"devices": out})
    return out


# ---- transfer byte accounting ----
def _leaves(tree):
    """Tensors / arrays of a nested tuple, list, dict or NamedTuple."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _nbytes(leaf) -> int:
    numel = getattr(leaf, "numel", None)
    esize = getattr(leaf, "element_size", None)
    if callable(numel) and callable(esize):        # a torch tensor
        return int(numel()) * int(esize())
    nb = getattr(leaf, "nbytes", None)             # numpy and friends
    return int(nb) if isinstance(nb, int) else 0


def tree_nbytes(tree) -> int:
    """Total array bytes across a nested structure's leaves (0 for
    leaves with no size). Callers guard with ``obs.enabled()`` — the
    byte walk must never run on the disabled path."""
    return sum(_nbytes(leaf) for leaf in _leaves(tree))


def put_nbytes(tree, target_of) -> int:
    """Bytes a move to a device will actually copy: tensors already on
    their target are free passthroughs and don't count (a host array
    always moves). ``target_of(leaf)`` returns the leaf's destination
    ``torch.device``. Callers guard with ``obs.enabled()``."""
    import torch

    total = 0
    for leaf in _leaves(tree):
        nb = _nbytes(leaf)
        if not nb:
            continue
        if isinstance(leaf, torch.Tensor):
            target = torch.device(target_of(leaf))
            dev = leaf.device
            if dev.type == target.type and (
                    target.index is None or dev.index == target.index):
                continue
        total += nb
    return total
