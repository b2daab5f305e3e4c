"""Scenario-sharded APH over the async Synchronizer, multi-process (the
port of the JAX package's core/aph_shard.py).

The reference's APH runtime (ref. mpisppy/opt/aph.py:818-921 and
mpisppy/utils/listener_util/listener_util.py:277-327): ranks hold
scenario shards, a listener thread on each rank keeps reducing the
(x̄, x̄², ȳ) "FirstReduce" and (τ, φ, norms) "SecondReduce"
concatenations while the worker solves, and the worker proceeds once
enough ranks have fresh data (``async_frac_needed``).

Here a rank is an OS process owning a contiguous scenario shard
(ir/batch.shard_batch) with its own engine on its own device context;
the listener exchange rides the native seqlock windows through
utils/synchronizer.Synchronizer. The in-process APH (core/aph.py)
stays the one-device path; this module is the multi-process shape.

Telemetry: with a telemetry directory every shard process records into
it, shard 0 (which carries the wheel's hub) under the plain artifact
names and shard i under the role ``shard<i>``; the wheel's spoke
processes record under their own roles (utils/multiproc.py), and the
launcher merges every process's trace into ``trace_merged.json``.

Reduction layout (per-stage node summands, flattened and concatenated;
membership columns are global, see shard_batch):

  First  = [Σp·x | Σp·x² | Σp·y  per (node, slot) | Σp per node
            | per-shard timestamps]                  (3·Σ N_t k_t + Σ N_t + n)
  Second = [τ, φ, pusq, pvsq, pwsq, pzsq | per-shard timestamps]   (6 + n)

Timestamps live in per-shard slots (each shard sums in only its own),
so the reduced vector carries every shard's iteration count: the
enough-fresh check of the reference's side gig (ref. aph.py:204-324).
The convergence norms ride the same iteration's SecondReduce from the
PRE-step (W, z): conv is "one notch behind", the staleness the
reference's worker accepts (ref. listener_util.py:164-182 keep_up).
"""

from __future__ import annotations

import importlib
import time

import numpy as np
import torch

from .. import global_toc, obs
from ..ir.batch import shard_batch
from ..utils.runtime import to_host
from ..utils.synchronizer import Synchronizer
from .aph import APH, aph_conv_metric, aph_theta_step


class APHShard(APH):
    """One shard's APH engine and worker loop. Build with
    ``make_shard``; drive with ``run`` (which owns the Synchronizer
    listener)."""

    def __init__(self, batch, options, n_shards, my_shard, shm_prefix=None,
                 windows=None, **kw):
        opts = dict(options or {})
        opts["partial_probabilities"] = True
        super().__init__(batch, opts, **kw)
        self.n_shards = int(n_shards)
        self.my_shard = int(my_shard)
        self.async_frac_needed = float(
            self.options.get("async_frac_needed", 1.0))
        self.async_sleep_secs = float(
            self.options.get("async_sleep_secs", 0.002))
        self._stage_shapes = self.stage_shapes(self.batch)
        self._nk = sum(N * k for N, k in self._stage_shapes)
        self._nden = sum(N for N, _ in self._stage_shapes)
        # wheel mode: aph_wheel_S = the GLOBAL scenario count enables
        # the on-demand WX gather; shard 0 also carries the hub
        # communicator (set by the wheel launcher)
        self._wheel_S = self.options.get("aph_wheel_S")
        ondemand = None
        if self._wheel_S is not None:
            self._wheel_S = int(self._wheel_S)
            self._shard_lo = shard_range(self._wheel_S, self.my_shard,
                                         self.n_shards)[0]
            K = sum(k for _, k in self._stage_shapes)
            ondemand = {"WX": 2 * self._wheel_S * K}
            if int(self.options.get("aph_sync_every", 0)):
                raise ValueError("aph_sync_every cannot be combined "
                                 "with wheel mode (aph_wheel_S): the "
                                 "hub's gap termination breaks the "
                                 "barrier call-count alignment")
        lens = self.reduction_lens(self.batch, self.n_shards)
        self.sync = Synchronizer(
            lens, self.n_shards, self.my_shard, shm_prefix=shm_prefix,
            windows=windows, ondemand_lens=ondemand,
            sleep_secs=float(self.options.get("listener_sleep_secs", 0.005)))
        self._g = {r: np.zeros(n) for r, n in lens.items()}
        self._l = {r: np.zeros(n) for r, n in lens.items()}

    # ---- wire layout (thread-mode embedders prebuild the window table
    # from it) ----
    @staticmethod
    def stage_shapes(batch):
        return [(batch.tree.nodes_per_stage[t], sl.stop - sl.start)
                for t, sl in enumerate(batch.stage_slot_slices)]

    @classmethod
    def reduction_lens(cls, batch, n_shards):
        shapes = cls.stage_shapes(batch)
        nk = sum(N * k for N, k in shapes)
        nden = sum(N for N, _ in shapes)
        return {"First": 3 * nk + nden + n_shards,
                "Second": 6 + n_shards}

    # ---- summand packing (host float64 vectors) ----
    def _node_summands(self, arr):
        """Per-stage B_tᵀ(p⊙arr[:, sl]) flattened and concatenated."""
        p = self.prob[:, None]
        outs = [torch.ravel(B.T @ (p * arr[:, sl]))
                for B, sl in zip(self.memberships,
                                 self.batch.stage_slot_slices)]
        return torch.cat(outs)

    def _den_summands(self):
        return torch.cat([B.T @ self.prob for B in self.memberships])

    def _broadcast_nodes(self, flat):
        """Inverse of _node_summands: (Σ N_t k_t,) node values -> (S, K)
        on the engine's device."""
        out, off = [], 0
        for B, (N, k) in zip(self.memberships, self._stage_shapes):
            blk = torch.as_tensor(flat[off:off + N * k].reshape(N, k),
                                  dtype=self.dtype, device=self.device)
            out.append(B @ blk)
            off += N * k
        return torch.cat(out, dim=1)

    def _expand_den(self, dens):
        """(Σ N_t,) per-node masses -> (Σ N_t k_t,) aligned with the
        flattened per-(node, slot) numerators. A node no shard passes
        through has zero mass; this shard never consumes such nodes, so
        the placeholder 1 only keeps NaN out of the broadcast."""
        out, off = [], 0
        for N, k in self._stage_shapes:
            d = dens[off:off + N]
            out.append(np.repeat(np.where(d > 0, d, 1.0), k))
            off += N
        return np.concatenate(out)

    def _wait_fresh(self, red, it, vec):
        """Stage my summand (timestamp = it) and spin until the reduced
        vector shows >= async_frac_needed shards at timestamp >= it
        (ref. aph.py:327-448). A hard-killed peer never publishes: the
        deadline turns that into an error instead of an endless spin.
        Returns a COPY of the reduced payload."""
        ts = np.zeros(self.n_shards)
        ts[self.my_shard] = it
        self._l[red][:] = np.concatenate([vec, ts])
        need = max(1, int(np.ceil(self.async_frac_needed * self.n_shards)))
        self.sync.compute_global_data(self._l, self._g, rednames=[red],
                                      keep_up=True)
        deadline = time.monotonic() + float(
            self.options.get("aph_wait_timeout", 600.0))
        while True:
            fresh = int((self._g[red][-self.n_shards:] >= it).sum())
            if fresh >= need or self.sync.global_quitting:
                self.sync.compute_global_data(self._l, self._g,
                                              rednames=[red], keep_up=True)
                return self._g[red][:-self.n_shards].copy()
            if time.monotonic() > deadline:
                raise RuntimeError(
                    f"shard {self.my_shard}: {red} never got "
                    f"{need}/{self.n_shards} fresh shards at iter {it}; "
                    "a peer process likely died without publishing quit")
            time.sleep(self.async_sleep_secs)
            self._g[red][-self.n_shards:] = self.sync.peek_tail(
                red, self.n_shards)

    # ---- wheel citizenship (spin_aph_shard_wheel) ----
    def _wheel_sync(self, xn):
        """Publish this shard's (W, x-nonant) rows into the WX gather;
        on the hub-carrying shard, stage the gathered FULL arrays and
        run the cylinder sync. Returns True when the wheel terminated."""
        if self._wheel_S is None:
            return False
        K = self.batch.K
        off = self._wheel_S * K
        lo = self._shard_lo * K
        n_loc = self.batch.S * K
        buf = np.zeros(2 * off)
        buf[lo:lo + n_loc] = to_host(self.W, np.float64).reshape(-1)
        buf[off + lo:off + lo + n_loc] = to_host(xn, np.float64).reshape(-1)
        if self.spcomm is None:
            # non-hub shards only publish; the hub shard gathers
            self.sync.publish_now("WX", buf)
            return False
        # disjoint rows: the sum is an exact concatenation, stale for
        # other shards by at most their publish lag
        g, min_wid = self.sync.reduce_now("WX", buf, return_min_wid=True)
        if min_wid < 1:
            # a shard has not published yet: its rows would read zero;
            # skip this round's cylinder sync, the next gather retries
            return False
        self.wheel_W = g[:off].reshape(self._wheel_S, K)
        self.wheel_X = g[off:].reshape(self._wheel_S, K)
        self.spcomm.sync()
        return bool(self.spcomm.is_converged())

    # ---- the worker loop (one shard's APH_iterk) ----
    def _work(self):
        warm = getattr(self, "_warm_started", False)
        self.solve_loop(w_on=warm, prox_on=False, update=False)
        # iter-0 feasibility and the trivial bound are collective: the
        # reference runs Iter0 synchronously before the listener starts
        # (ref. aph.py:889); sync_allreduce is that barrier
        ok, _ = self.iter0_feasible_mask()
        feas, bound = self.sync.sync_allreduce(
            np.array([float(np.dot(to_host(self.prob), ok)),
                      self.Ebound()]))
        if self.options.get("iter0_infeasibility_abort", True) \
                and abs(feas - 1.0) > 1e-6:
            raise RuntimeError(f"iter 0: global feasible probability {feas} "
                               "!= 1 (ref. phbase.py:1415-1427 abort)")
        self.trivial_bound = self.best_bound = bound
        # the global iter-0 x̄ (a shard-local mean would seed W
        # inconsistently across shards)
        xn0 = self.nonants_of(self.x)
        nk = self._nk
        g0 = self.sync.sync_allreduce(np.concatenate([
            to_host(self._node_summands(xn0)),
            to_host(self._den_summands())]))
        self.xbar = self._broadcast_nodes(g0[:nk] / self._expand_den(g0[nk:]))
        if not warm:
            self.Update_W()
        if self.use_lag:
            self._W_lag = self.W
            self._z_lag = self.z
        global_toc(f"APHShard[{self.my_shard}] iter 0: trivial bound = "
                   f"{bound:.4f}", self.verbose and self.my_shard == 0)
        wheel_done = self._wheel_sync(xn0)

        nu, gamma = self.nu, self.gamma
        nden = self._nden
        self.conv = np.inf
        it = self._iter = 0
        while not wheel_done and it < self.max_iterations \
                and not self.sync.global_quitting:
            it += 1
            self._iter = it
            xn = self.nonants_of(self.x)
            if it > 1:
                W_y = self._W_lag if self.use_lag else self.W
                z_y = self._z_lag if self.use_lag else self.z
                y_new = W_y + self.rho * (xn - z_y)
                d = torch.as_tensor(self._dispatched,
                                    device=self.device)[:, None]
                self.y_aph = torch.where(d, y_new, self.y_aph)
            first = to_host(torch.cat([
                self._node_summands(xn), self._node_summands(xn * xn),
                self._node_summands(self.y_aph), self._den_summands()]))
            gfirst = self._wait_fresh("First", it, first)
            if self.sync.global_quitting:
                break
            den = self._expand_den(gfirst[3 * nk:3 * nk + nden])
            xbar = self._broadcast_nodes(gfirst[:nk] / den)
            xsqbar = self._broadcast_nodes(gfirst[nk:2 * nk] / den)
            ybar = self._broadcast_nodes(gfirst[2 * nk:3 * nk] / den)

            u = xn - xbar
            p = self.prob
            pusq = float(torch.dot(p, torch.sum(u * u, dim=1)))
            pvsq = float(torch.dot(p, torch.sum(ybar * ybar, dim=1)))
            phi = float(torch.dot(p, torch.sum(
                (self.z - xn) * (self.W - self.y_aph), dim=1)))
            pwsq = float(torch.dot(p, torch.sum(self.W * self.W, dim=1)))
            pzsq = float(torch.dot(p, torch.sum(self.z * self.z, dim=1)))
            second = np.array([pusq + pvsq / gamma, phi, pusq, pvsq, pwsq,
                               pzsq])
            gsecond = self._wait_fresh("Second", it, second)
            if self.sync.global_quitting:
                break
            gtau, gphi, gpusq, gpvsq, gpwsq, gpzsq = gsecond
            # with async_frac_needed < 1 each shard computes θ from its
            # own stale view of (τ, φ); aph_sync_every barriers the full
            # SecondReduce periodically so every shard applies one θ
            sync_every = int(self.options.get("aph_sync_every", 0))
            synced = False
            if sync_every and it % sync_every == 0:
                try:
                    gsync = self.sync.sync_allreduce(
                        second, timeout=float(
                            self.options.get("aph_wait_timeout", 600.0)))
                except RuntimeError:
                    if self.sync.global_quitting:
                        break
                    raise
                (gtau, gphi, gpusq, gpvsq, gpwsq, gpzsq) = (
                    float(v) for v in gsync[:6])
                synced = True
            self.W, self.z, theta = aph_theta_step(
                u, ybar, self.W, self.z, xbar, gtau, gphi, nu, gamma,
                iter1=(it == 1))
            theta = float(theta)
            self.xbar, self.xsqbar, self.ybar = xbar, xsqbar, ybar
            self.tau, self.phi, self.theta = gtau, gphi, theta
            # conv from THIS SecondReduce's (W, z) norms: the pre-step
            # norms, "one notch behind"
            self.conv = float(aph_conv_metric(gpusq, gpvsq, gpwsq, gpzsq))
            self.phis = self.prob * torch.sum(
                (self.z - xn) * (self.W - self.y_aph), dim=1)
            global_toc(f"APHShard iter {it}: conv={self.conv:.3e} "
                       f"theta={theta:.3e}",
                       self.verbose and self.my_shard == 0 and it % 10 == 0)
            if self._wheel_sync(xn):
                global_toc(f"APHShard wheel: termination at iter {it}",
                           self.verbose and self.my_shard == 0)
                break
            # with the barrier on, the convthresh exit is taken only at
            # synced iterations (conv is then the same on every shard)
            if self.conv < self.convthresh and (not sync_every or synced):
                break
            frac = 1.0 if it == 1 else self.dispatch_frac
            self._aph_solve(self._dispatch_mask(it, frac))

        self.sync.quitting = 1
        # final collective: the global expected objective of the CURRENT
        # local solutions (self.x: rejected rows were reverted)
        try:
            eobj = self.sync.sync_allreduce(
                np.array([float(self.Eobjective(
                    self.scenario_objectives(self.x)))]),
                abort_on_quit=False, timeout=60.0)[0]
        except TimeoutError:
            # a peer died before the wrap-up collective; its own error is
            # the cause, so report "no global objective"
            eobj = np.nan
        return self.conv, float(eobj), self.trivial_bound

    def run(self):
        try:
            return self.sync.run(self._work)
        finally:
            self.sync.close()


def shard_range(S, my_shard, n_shards):
    """The contiguous [lo, hi) scenario range of a shard (ref.
    spbase.py:172 _calculate_scenario_ranks)."""
    if n_shards > S:
        raise ValueError(
            f"{n_shards} shards for {S} scenarios would leave empty "
            "shards (the reference requires scenarios >= ranks too, "
            "ref. spbase.py:172)")
    return (S * my_shard) // n_shards, (S * (my_shard + 1)) // n_shards


def make_shard(batch, options, n_shards, my_shard, shm_prefix=None,
               windows=None, **kw):
    """Shard ``my_shard`` of ``n_shards`` from the FULL batch: the
    contiguous range with its global probabilities."""
    lo, hi = shard_range(batch.S, my_shard, n_shards)
    return APHShard(shard_batch(batch, lo, hi), options, n_shards, my_shard,
                    shm_prefix=shm_prefix, windows=windows, **kw)


def _model(name):
    """The port's model module ``name``."""
    return importlib.import_module(f"..models.{name}", __package__)


def _shard_batch(model, num_scens, creator_kwargs, lo, hi):
    """Lower ONLY scenarios [lo, hi) of the model's tree (ref.
    spbase.py:242 _create_scenarios), on the structure-shared fast path
    when the model has one."""
    from ..ir.batch import build_batch, subtree

    mod = _model(model)
    return build_batch(mod.scenario_creator,
                       subtree(mod.make_tree(num_scens), lo, hi),
                       creator_kwargs=creator_kwargs,
                       vector_patch=getattr(mod, "scenario_vector_patch",
                                            None))


def _shard_worker(model, num_scens, creator_kwargs, options, n_shards,
                  my_shard, prefix, q, device=None, wheel=None,
                  telemetry_dir=None):
    """One shard process. ``device``: the engine's device (None for the
    card). ``wheel``: {run_id, spoke_kinds, hub_options} for shard 0 of
    a wheel, which then opens the spoke windows and carries an
    APHShardHub. ``telemetry_dir``: record into it (shard 0 unsuffixed,
    the others as ``shard<i>``). Puts (shard, result, stats) on ``q``:
    the stats (block launches, kernel backends, seconds, peak device
    memory) ride beside the result."""
    t0 = time.perf_counter()
    if telemetry_dir:
        obs.configure(out_dir=telemetry_dir,
                      role=None if my_shard == 0 else f"shard{my_shard}",
                      config={"model": model, "num_scens": num_scens,
                              "n_shards": n_shards, "shard": my_shard})
    try:
        lo, hi = shard_range(num_scens, my_shard, n_shards)
        batch = _shard_batch(model, num_scens, creator_kwargs, lo, hi)
        eng = APHShard(batch, options, n_shards, my_shard,
                       shm_prefix=prefix, device=device)
        on_card = eng.device.type == "cuda"
        if on_card:
            torch.cuda.reset_peak_memory_stats(eng.device)
        hub = None
        if wheel is not None:
            from ..cylinders.hub import APHShardHub
            from ..utils.multiproc import open_spoke_proxies

            proxies = open_spoke_proxies(wheel["spoke_kinds"],
                                         wheel["run_id"], num_scens,
                                         batch.K)
            hub = APHShardHub(eng, spokes=proxies,
                              options=wheel.get("hub_options") or {})
            hub.classify_spokes()
            hub.windows_made = True
            hub.setup_hub()
            eng.spcomm = hub
        try:
            conv, eobj, triv = eng.run()
        finally:
            if hub is not None:
                # release the spoke processes whatever happened to the
                # APH loop (the launcher joins them)
                hub.send_terminate()
        res = (conv, eobj, triv, eng._iter)
        if hub is not None:
            outer, inner = hub.hub_finalize()
            for proxy in hub.spokes:
                proxy.hub_window.close(unlink=False)
                proxy.my_window.close(unlink=False)
            res = res + (outer, inner)
        stats = {"shard": my_shard, "scenarios": [lo, hi],
                 "device": str(eng.device),
                 "launches": eng.kernel_launches,
                 "backends": sorted({p.backend for p in
                                     eng._kernel_plans.values()}),
                 "seconds": time.perf_counter() - t0,
                 "peak_gb": (torch.cuda.max_memory_allocated(eng.device)
                             / 1e9 if on_card else None)}
        # this process's artifacts are complete before the launcher
        # hears of the result (and merges the traces)
        obs.shutdown()
        q.put((my_shard, res, stats))
    except Exception as e:
        obs.shutdown()
        # construction failures must reach the queue too, or the parent
        # waits out its timeout
        q.put((my_shard, e, None))
        raise


def spin_aph_shards(model: str, num_scens: int, options, n_shards: int,
                    creator_kwargs=None, join_timeout=600.0, device=None,
                    shard_stats=None, _wheel=None, telemetry_dir=None):
    """One OS process per scenario shard (``spawn`` context: CUDA does
    not survive a fork), each running APHShard on ``device`` (None for
    the card). Returns shard 0's (conv, Eobjective, trivial_bound,
    iters[, outer, inner]); ``shard_stats``, when a list, receives each
    shard's stats dict (see _shard_worker) in shard order. With
    ``telemetry_dir`` every shard records into it (see the module
    docstring)."""
    import multiprocessing as mp
    import os
    import queue as _queue
    import secrets

    from ..utils.multiproc import reap
    from ..utils.synchronizer import cleanup_shm

    shard_range(num_scens, 0, n_shards)   # fail fast on empty shards
    ctx = mp.get_context("spawn")
    prefix = f"/aphs{os.getpid():x}{secrets.token_hex(3)}"
    q = ctx.Queue()
    procs = [ctx.Process(target=_shard_worker,
                         args=(model, num_scens, creator_kwargs,
                               dict(options or {}), n_shards, i, prefix, q,
                               device, _wheel if i == 0 else None,
                               telemetry_dir),
                         daemon=True)
             for i in range(n_shards)]
    for p in procs:
        p.start()
    results, stats = {}, {}
    try:
        # drain the queue before joining: a child blocks on exit until
        # its queued result is read
        for _ in range(n_shards):
            try:
                shard, res, st = q.get(timeout=join_timeout)
            except _queue.Empty:
                dead = [i for i, p in enumerate(procs) if not p.is_alive()]
                raise RuntimeError(
                    f"APH shards never reported within {join_timeout:.0f}s; "
                    f"dead shard processes: {dead or 'none (hung)'}")
            if isinstance(res, Exception):
                raise RuntimeError(f"APH shard {shard} failed: {res!r}")
            results[shard], stats[shard] = res, st
    finally:
        for p in procs:
            p.join(timeout=30.0)
        reap(procs)
        # terminated children never reach Synchronizer.close(): reap
        # whatever segments the group left in /dev/shm
        cleanup_shm(prefix)
    if shard_stats is not None:
        shard_stats[:] = [stats[i] for i in range(n_shards)]
    return results[0]


def spin_aph_shard_wheel(cfg, n_shards: int, join_timeout=600.0,
                         spoke_ready_timeout=300.0, shard_stats=None):
    """The reference's "APH hub + bound spokes under mpiexec" shape
    (ref. mpisppy/cylinders/hub.py:606 APHHub over rank groups): one OS
    process per scenario shard running APHShard over the Synchronizer,
    plus one OS process per spoke (utils/multiproc's worker), shard 0
    carrying the wheel's hub communicator (cylinders/hub.APHShardHub).
    ``cfg`` is a RunConfig whose hub is "aph"; every process runs on
    ``cfg.device``. Returns (conv, Eobjective, trivial_bound, iters,
    best_outer, best_inner). With a telemetry directory (the config's,
    else the environment variable) every process records into it under
    its role and the traces are merged into ``trace_merged.json`` when
    the wheel ends; the launching process records nothing itself."""
    import multiprocessing as mp
    import os
    import secrets

    from ..utils.multiproc import (merge_run_traces, reap,
                                   spawn_spoke_processes,
                                   wait_spoke_hellos)
    from ..utils.vanilla import _not_ported, mesh_ranks, refuse_unported

    cfg.validate()
    refuse_unported(cfg)
    if mesh_ranks(cfg, warn=False) > 1:
        raise _not_ported("a scenario mesh in the process wheels", "A8b")
    if cfg.checkpoint_dir or cfg.resume_from:
        # the JAX package's shard wheel takes no checkpoint either;
        # refuse rather than run without one
        raise _not_ported("checkpoints of the sharded APH wheel", "A8b")
    if cfg.algo.scenario_source != "resident":
        raise _not_ported("a streamed or synthesized scenario source in "
                          "the process wheels", "A8b")
    if cfg.hub != "aph":
        raise ValueError(f"the sharded APH wheel needs hub='aph', not "
                         f"{cfg.hub!r}")
    S = cfg.num_scens
    # K without lowering the whole batch: scenario 0 only
    K = _shard_batch(cfg.model, S, cfg.model_kwargs, 0, 1).K
    run_id = f"/apw{os.getpid():x}{secrets.token_hex(3)}"
    tdir = cfg.telemetry_dir \
        or os.environ.get("MPISPPY_TPU_TELEMETRY_DIR") or None
    ctx = mp.get_context("spawn")
    owned, spoke_procs = [], []
    try:
        proxies, spoke_procs, owned = spawn_spoke_processes(
            cfg, run_id, ctx, S, K)
        # every spoke's hello first, so a fast APH run cannot end
        # before the spokes are wired (shard 0 opens its own proxies)
        wait_spoke_hellos(cfg, proxies, spoke_procs, spoke_ready_timeout)
        options = dict(cfg.algo.to_options())
        options.update(cfg.hub_options)
        options["aph_wheel_S"] = S
        hub_options = {}
        if cfg.rel_gap is not None:
            hub_options["rel_gap"] = cfg.rel_gap
        if cfg.abs_gap is not None:
            hub_options["abs_gap"] = cfg.abs_gap
        wheel = {"run_id": run_id,
                 "spoke_kinds": [sp.kind for sp in cfg.spokes],
                 "hub_options": hub_options}
        res = spin_aph_shards(cfg.model, S, options, n_shards,
                              creator_kwargs=cfg.model_kwargs,
                              join_timeout=join_timeout, device=cfg.device,
                              shard_stats=shard_stats, _wheel=wheel,
                              telemetry_dir=tdir)
    finally:
        for p in spoke_procs:
            p.join(timeout=30.0)
        reap(spoke_procs)
        for w in owned:
            w.close(unlink=True)
    if tdir:
        # every shard and spoke closed its session before it exited
        merge_run_traces(tdir)
    return res
