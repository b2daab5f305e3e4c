#!/usr/bin/env python3
"""How far the port's df32 iteration-0 objective moves with the torch
CPU thread count (ROADMAP.md C.1 (b)).

    python3 df32_thread_spread.py            # threads 1, 2, 4, default
    python3 df32_thread_spread.py --threads 1 3

Runs iteration 0 of the JAX bench's df32 recipe on the batch of
tests/test_torch_df32_recipe.py (UC 10 x 24 with every constraint block,
S = 20 in chunks of 8) on the CPU, once per thread count, each in a
fresh process (``torch.set_num_threads`` before any torch work), and
prints one JSON line per run (threads, Eobjective, Ebound, seconds) and
a last line with the spread: the largest and smallest Eobjective and
their difference relative to the smallest. The split-f32 reductions
sum in an order that depends on the thread count, and the recipe's
loose stopping point carries that roundoff into the objective.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

_KW = dict(num_gens=10, num_hours=24, min_up_down=True, ramping=True,
           t0_state=True, startup_shutdown_ramps=True,
           relax_integrality=False)
_S0, _CHUNK0 = 20, 8
# bench.py's DF32 dict, as tests/test_torch_df32_recipe.py runs it
_DF32 = {
    "subproblem_precision": "df32",
    "defaultPHrho": 100.0,
    "subproblem_max_iter": 400,
    "subproblem_eps": 1e-5,
    "subproblem_eps_hot": 1e-4,
    "subproblem_eps_dua_hot": 1e-2,
    "subproblem_stall_rel": 1.5e-3,
    "subproblem_tail_iter": 100,
    "subproblem_segment": 100,
    "subproblem_segment_lo": 400,
    "subproblem_polish_hot": False,
    "subproblem_hospital": False,
    "display_timing": True,
    "subproblem_chunk": _CHUNK0,
}


def one_run(threads: int) -> dict:
    """Iteration 0 of the recipe on ``threads`` torch threads (0 keeps
    torch's default)."""
    import torch
    if threads > 0:
        torch.set_num_threads(threads)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from mpisppy_tpu_torch.core.ph import PHBase
    from mpisppy_tpu_torch.ir.batch import build_batch
    from mpisppy_tpu_torch.models import uc
    batch = build_batch(uc.scenario_creator, uc.make_tree(_S0),
                        creator_kwargs=_KW,
                        vector_patch=uc.scenario_vector_patch)
    t0 = time.perf_counter()
    ph = PHBase(batch, dict(_DF32), device="cpu")
    ph.solve_loop(w_on=False, prox_on=False)
    return {"threads": torch.get_num_threads(),
            "eobjective": ph.Eobjective_value(), "ebound": ph.Ebound(),
            "seconds": time.perf_counter() - t0}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--threads", type=int, nargs="*", default=[1, 2, 4, 0],
                   help="torch thread counts (0 = torch's default)")
    p.add_argument("--one", type=int, default=None,
                   help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.one is not None:
        print(json.dumps(one_run(args.one)), flush=True)
        return 0
    rows = []
    for t in args.threads:
        env = dict(os.environ)
        env.pop("OMP_NUM_THREADS", None)
        out = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--one", str(t)], env=env,
                             capture_output=True, text=True, check=True)
        row = json.loads(out.stdout.strip().splitlines()[-1])
        rows.append(row)
        print(json.dumps(row), flush=True)
    e = [r["eobjective"] for r in rows]
    print(json.dumps({"eobjective_max": max(e), "eobjective_min": min(e),
                      "spread_rel": (max(e) - min(e)) / abs(min(e))}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
