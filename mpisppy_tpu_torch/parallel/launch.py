"""Start the ranks of a scenario mesh on this machine.

``launch(fn, world, args)`` spawns ``world`` processes (the ``spawn``
start method), joins them into one ``torch.distributed`` process group
and runs ``fn(mesh, *args)`` on every rank, with ``mesh`` the rank's
``parallel/mesh.Mesh``. It returns the ranks' return values in rank
order; they travel back pickled, so ``fn`` returns host objects (numpy
arrays, floats, dicts), never CUDA tensors.

Rendezvous: a ``FileStore`` under a fresh temporary directory, so
launches running side by side (parallel test workers) never contend
for a TCP port; with a ``coordinator`` ({"address": "host:port"}) the
ranks meet at ``tcp://host:port`` instead.

Backend (``choose_backend``): NCCL when every rank has a CUDA device of
its own, gloo on the CPU. When several ranks share one card NCCL
refuses the duplicate devices, so the backend is gloo over the CUDA
tensors: a rule decided before the group starts and reported on the
mesh (``mesh.backend``), not a caught NCCL failure retried on gloo.

A rank that raises makes the launch raise, with the rank's traceback;
the other ranks are terminated (they may be waiting in a collective
for the rank that failed).
"""

from __future__ import annotations

import datetime
import os
import shutil
import tempfile
import time
import traceback


def choose_backend(world: int, device=None) -> str:
    """"gloo" for CPU ranks and for ranks that share a card, "nccl"
    when each of the ``world`` ranks has a card of its own."""
    import torch
    if device is not None and str(device).startswith("cpu"):
        return "gloo"
    n_cards = torch.cuda.device_count() if torch.cuda.is_available() \
        else 0
    return "nccl" if n_cards >= world else "gloo"


def _rank_main(rank, world, init_method, device, backend, timeout, fn,
               args, queue):
    os.environ["LOCAL_RANK"] = str(rank)
    import torch
    import torch.distributed as dist

    from .mesh import make_mesh
    try:
        if backend == "nccl":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(
            backend, init_method=init_method, rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=timeout))
        result = (rank, True, fn(make_mesh(world, device=device), *args))
    except Exception:
        # the process boundary: the launch re-raises it with this text
        result = (rank, False, traceback.format_exc())
    # report before the teardown: a rank that failed must not wait for
    # peers still blocked in a collective (the launch ends them)
    queue.put(result)
    if dist.is_initialized():
        dist.destroy_process_group()


def launch(fn, world: int, args=(), *, device=None, coordinator=None,
           timeout: float = 1800.0):
    """Run ``fn(mesh, *args)`` on ``world`` spawned ranks; returns the
    list of their return values. ``device`` None gives each rank
    ``cuda:(rank % device_count)``; ``"cpu"`` runs every rank on the
    CPU. ``timeout`` bounds the whole launch and every collective."""
    import multiprocessing as mp

    world = int(world)
    if world < 1:
        raise ValueError(f"world must be positive; got {world}")
    backend = choose_backend(world, device)
    tmp = None
    if coordinator is not None and coordinator.get("address"):
        init_method = f"tcp://{coordinator['address']}"
    else:
        tmp = tempfile.mkdtemp(prefix="mesh_store_")
        init_method = "file://" + os.path.join(tmp, "store")
    ctx = mp.get_context("spawn")
    queue = ctx.SimpleQueue()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, init_method, device, backend,
                               timeout, fn, tuple(args), queue),
                         name=f"mesh-rank{r}")
             for r in range(world)]
    results, failure = {}, None
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        while len(results) < world and failure is None:
            while not queue.empty():
                r, ok, payload = queue.get()
                if ok:
                    results[r] = payload
                elif failure is None:
                    failure = (r, payload)
            if failure is not None or len(results) == world:
                break
            for r, p in enumerate(procs):
                if r not in results and not p.is_alive() \
                        and queue.empty():
                    failure = (r, f"rank {r} exited with code "
                                  f"{p.exitcode} before reporting")
                    break
            if time.monotonic() > deadline:
                failure = (-1, f"the launch exceeded {timeout:.0f} s")
            time.sleep(0.02)
    finally:
        if failure is not None:
            for p in procs:
                if p.is_alive():
                    p.terminate()
        for p in procs:
            if p.pid is None:       # never started
                continue
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)
    if failure is not None:
        r, msg = failure
        who = "the launch" if r < 0 else f"rank {r} of {world}"
        raise RuntimeError(f"{who} failed ({backend}):\n{msg}")
    return [results[r] for r in range(world)]
