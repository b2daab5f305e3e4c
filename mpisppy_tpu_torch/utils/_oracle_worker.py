"""Worker side of the host oracle pool (utils/host_oracle.py).

Runs as a standalone subprocess (``python -m
mpisppy_tpu_torch.utils._oracle_worker``) speaking length-prefixed pickle
frames over stdin/stdout: first frame in is the static problem payload,
then one frame per solve task, one result frame back per task. A
dedicated subprocess — not multiprocessing — because every stdlib start
method is wrong here: fork clones the parent's accelerator runtime
(jax/grpc threads are not fork-safe), and spawn/forkserver re-import
the user's ``__main__`` in every worker, re-executing unguarded driver
scripts wholesale. This module imports ONLY numpy/scipy, so worker
startup is light and torch never loads.

This is the TPU framework's analog of the reference's per-rank rented
CPU solvers (ref. mpisppy/phbase.py:1304-1362 SolverFactory per
subproblem; ref. mpisppy/phbase.py:999 parallel solve fan-out across
ranks): the host cores are the "ranks", HiGHS is the solver.
"""

from __future__ import annotations

import pickle
import struct

import numpy as np


def read_msg(f):
    """Read one length-prefixed pickle frame; None on EOF/short read."""
    hdr = f.read(8)
    if len(hdr) < 8:
        return None
    (ln,) = struct.unpack("<Q", hdr)
    data = f.read(ln)
    if len(data) < ln:
        return None
    return pickle.loads(data)


def write_frame(f, b: bytes):
    f.write(struct.pack("<Q", len(b)))
    f.write(b)
    f.flush()


def write_msg(f, obj):
    write_frame(f, pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL))

def init_worker(payload: dict) -> dict:
    """Build a solver state dict from the static payload, pre-seeding
    the A→CSR conversion cache. Returned (not stored in a module
    global) so multiple INLINE pools in one process can coexist — a
    shared global would let a second pool silently clobber the first's
    problem data. The subprocess main() holds exactly one state.

    payload keys: A ((m,n) shared or (S,m,n)), l, u, lb, ub (per-scenario
    row/box bounds), integrality ((n,) int), with A possibly shared.
    """
    from scipy import sparse

    state = dict(payload)
    A = payload["A"]
    if sparse.issparse(A):
        state["A_csr"] = sparse.csr_matrix(A)
        state["A_shared"] = True
    elif A.ndim == 2:
        state["A_csr"] = sparse.csr_matrix(A)
        state["A_shared"] = True
    else:
        # convert lazily per scenario — a 1000-scenario batch would
        # otherwise pay the full conversion in every worker
        state["A_csr"] = {}
        state["A_shared"] = False
    return state


def _A_of(state: dict, s: int):
    from scipy import sparse

    if state["A_shared"]:
        return state["A_csr"]
    cache = state["A_csr"]
    if s not in cache:
        cache[s] = sparse.csr_matrix(state["A"][s])
    return cache[s]


def solve_scenario(state: dict, task):
    """Solve one scenario LP/MILP: min q·x s.t. l<=Ax<=u, lb<=x<=ub
    (+ integrality when milp=True).

    task = (s, q, milp, time_limit, mip_gap[, want_x[, fixed]]).
    ``fixed`` — optional (idx, vals) pinning columns idx at vals via
    lb=ub (incumbent evaluation: first-stage nonants fixed at a
    candidate x̂, the dispatch solved exactly on host).
    Returns (s, value, ok, optimal, primal):
      value — a certified LOWER bound on the scenario minimum (the LP
        optimum, or HiGHS's B&B dual bound for MILPs — valid even when
        the solve stops on time_limit/mip_gap);
      ok — value is a usable finite bound;
      optimal — the solve finished proven-optimal (so re-solving with a
        tighter budget cannot improve it);
      primal — (obj, x) of the solver's feasible point when want_x and
        one exists, else None. For MILPs obj is the INCUMBENT objective
        (an upper bound), distinct from the dual `value`.
    """
    from scipy.optimize import Bounds, LinearConstraint, milp as _milp

    s, q, want_milp, time_limit, mip_gap = task[:5]
    want_x = bool(task[5]) if len(task) > 5 else False
    fixed = task[6] if len(task) > 6 else None
    integrality = state["integrality"] if want_milp else None
    opts = {"presolve": True}
    if time_limit is not None:
        opts["time_limit"] = float(time_limit)
    if want_milp and mip_gap is not None:
        opts["mip_rel_gap"] = float(mip_gap)
    lb, ub = state["lb"][s], state["ub"][s]
    if fixed is not None:
        idx, vals = fixed
        lb, ub = lb.copy(), ub.copy()
        lb[idx] = vals
        ub[idx] = vals
    res = _milp(
        q,
        constraints=LinearConstraint(_A_of(state, s),
                                     state["l"][s], state["u"][s]),
        bounds=Bounds(lb, ub),
        integrality=(integrality if integrality is not None
                     else np.zeros(q.shape[0], dtype=np.uint8)),
        options=opts,
    )
    primal = (float(res.fun), np.asarray(res.x)) \
        if want_x and res.x is not None else None
    if want_milp:
        # HiGHS's dual (best) bound is a valid lower bound at ANY stop
        # reason; -inf / None means nothing was proven. On a model with
        # no integer columns scipy returns mip_dual_bound=None even at
        # optimality — the LP optimum IS the dual bound there
        val = res.mip_dual_bound
        if val is None and res.status == 0 and res.fun is not None:
            val = res.fun
        ok = val is not None and np.isfinite(val)
        optimal = bool(res.status == 0)
        return s, (float(val) if ok else -np.inf), ok, optimal, primal
    ok = bool(res.status == 0 and res.x is not None)
    return s, (float(res.fun) if ok else -np.inf), ok, ok, primal


def main():
    """Subprocess entry: payload frame, then task frames until EOF."""
    import os
    import sys

    # claim the protocol channel and route stray library prints (HiGHS
    # logs, warnings) to stderr so they can never corrupt a frame
    out = os.fdopen(os.dup(sys.stdout.fileno()), "wb")
    os.dup2(sys.stderr.fileno(), sys.stdout.fileno())
    inp = os.fdopen(os.dup(sys.stdin.fileno()), "rb")
    payload = read_msg(inp)
    if payload is None:
        return
    state = init_worker(payload)
    while True:
        task = read_msg(inp)
        if task is None:
            return
        write_msg(out, solve_scenario(state, task))


if __name__ == "__main__":
    main()
