"""The multi-tenant wheel manager: warm engines, stacked wheels, resume
(the port of the JAX package's serve/manager.py).

This is the one serve module that touches the engine and torch. One
:class:`ServeService` owns

- the durable request store + bounded admission queue (serve/queue),
- the shape-bucketed warm cache (serve/cache): checkout an engine,
  **install** the request's vectors into it (:func:`install_batch` —
  factors and kernel plans survive, W/x̄ and warm states reset), run
  the wheel, check it back in,
- N wheel workers, each running one wheel at a time as an in-process
  hub-only cylinder (PHHub over the warm engine — the hub brings the
  ``wheel_deadline`` watchdog, the live/status plumbing and the
  CheckpointManager), with per-wheel deadline timers
  (:class:`~mpisppy_tpu_torch.cylinders.supervisor.WheelDeadline`) as
  the wheel-level process manager,
- the request-state store on ``ckpt/``: every wheel checkpoints under
  its own namespace ``<state_dir>/ckpt/<request-or-group-id>/`` (one
  writer per directory — the LATEST/retention contract), so a
  preempted (SIGTERM) service resumes every in-flight request through
  the ``--resume-from`` machinery at the next start,
- rolling-horizon chains: solve a horizon, commit the head, roll
  forward warm-started from the previous step's bundle via the same
  resume path.

Every engine the service builds lives on ``ServeConfig.device``: the
CUDA device unless the caller asks for the CPU (the service raises at
construction without a card otherwise). On the card the engines' QP
solves run the hand-written ADMM block (ops/kernels/admm_block.py)
wherever the request's algo options select it.

Results are computed from the converged consensus: nonants fixed at
x̄ (integer slots rounded), one prox-off feasibility solve, and the
per-scenario objectives demultiplexed per request
(serve/batch.demux_expectation) — for a stacked wheel each tenant
gets exactly its own expectation.

The wheel stamp of a result keeps every key of the JAX package's
record. The JAX package's ``xla_compiles_delta`` counts XLA compiles;
the port's cold-shape costs are CUDA kernel builds (``kernel.build``,
ops/kernels/_build.py) and engine factor builds
(``PHBase.factor_builds``), stamped as ``kernel_builds_delta`` and
``factor_builds_delta``, with ``xla_compiles_delta`` holding their
sum. A warm-bucket request shows 0 for all three.
"""

from __future__ import annotations

import os
import secrets
import threading
import time

import numpy as np
import torch

from .. import global_toc, obs
from ..obs import diagnose as _obs_diagnose
from ..ckpt.bundle import (atomic_write_json, config_fingerprint,
                           latest_bundle)
from ..ops.kernels import _build as _kernel_build
from ..utils.config import ServeConfig
from ..utils.runtime import resolve_device, to_host
from . import batch as sbatch
from .cache import WarmCache
from .migrate import (MigrationClient, MigrationError, MigrationReceiver,
                      PeerRegistry, read_endpoint,
                      resolve_interrupted_migration)
from .queue import AdmissionQueue, Request, RequestStore

_CONSENSUS_FEAS_TOL = 1e-4


# ---------------------------------------------------------------- engine


def build_engine(stacked, algo_options: dict, device=None, dtype=None):
    """A fresh PH engine over a stacked batch on ``device`` (None = the
    CUDA device). The warm cache keeps it, so the next request of the
    bucket reuses its factorizations and kernel plans."""
    from ..core.ph import PH
    return PH(stacked, options=dict(algo_options), dtype=dtype,
              device=device)


def install_batch(engine, stacked):
    """Install a new instance's (or group's) vector data into a warm
    engine of the same bucket, on the engine's own device and dtype,
    preserving everything the bucket shares: the KKT factorizations
    (``_factors`` depend on (A, P, rho) — all bucket identity) and the
    kernel plans. Resets the PH state (W/x̄/x̄²), the warm-start QP
    states, and the recovery blacklists — per-request artifacts that
    must not leak across tenants."""
    from ..core.spbase import ship_stacked

    b_old, b = engine.batch, stacked
    if (b.S, b.n, b.m, b.K) != (b_old.S, b_old.n, b_old.m, b_old.K):
        raise ValueError(
            f"install_batch: shape mismatch (engine "
            f"{(b_old.S, b_old.n, b_old.m, b_old.K)}, batch "
            f"{(b.S, b.n, b.m, b.K)}) — bucket keys must prevent this")
    t, dev = engine.dtype, engine.device
    engine.batch = engine.global_batch = b
    engine._S_orig = b.S
    engine.prob = ship_stacked(b.prob, t, dev)
    engine.c0 = ship_stacked(b.c0, t, dev)
    engine.c0_stage = ship_stacked(b.c0_stage, t, dev)
    src = getattr(engine, "_stream_source", None)
    if src is None:
        engine.c = ship_stacked(b.c, t, dev)
        engine.c_stage = ship_stacked(b.c_stage, t, dev)
        # structure (P_diag, A) is bucket-shared — only the bound/rhs
        # vectors re-ship; the factorizations built from (A, P, rho)
        # stay valid and warm
        engine.qp_data = engine.qp_data._replace(
            l=ship_stacked(b.l, t, dev), u=ship_stacked(b.u, t, dev),
            lb=ship_stacked(b.lb, t, dev), ub=ship_stacked(b.ub, t, dev))
    else:
        # streamed/synthesized scenario source (stream/): the engine's
        # qp_data carries setup SURROGATES, not data — the tenant swap
        # installs the new vectors into the HOST store (streamed; tears
        # down the previous tenant's pipeline and staged buffers) and
        # refreshes the surrogates so the factor snapshots below see
        # the new tenant's eq patterns/cost scale. Synthesized engines
        # have no vectors to install — their data IS bucket identity
        # (model + model_kwargs derive the spec) — so the swap only
        # resets staging. Bucket fingerprints include scenario_source /
        # stream_int8 (AlgoConfig.to_options), so a resident request
        # can never lease this engine.
        if src.kind == "streamed":
            src.install(b)
        else:
            src.close()
        l2, u2, lb2, ub2, c2 = src.setup_arrays(t)
        engine.c = c2
        engine.qp_data = engine.qp_data._replace(l=l2, u=u2, lb=lb2,
                                                 ub=ub2)
    S, K = b.S, b.K
    rho = torch.full((S, K), float(engine.rho_default), dtype=t,
                     device=dev)
    moved = not torch.equal(engine.rho, rho)
    engine.rho = rho
    if moved:
        # the previous tenant's rho updater moved rho: its prox-on
        # factors are stale for the default rho (a genuine rebuild)
        engine.invalidate_factors()
    engine.W = torch.zeros((S, K), dtype=t, device=dev)
    engine.xbar = torch.zeros((S, K), dtype=t, device=dev)
    engine.xsqbar = torch.zeros((S, K), dtype=t, device=dev)
    engine.x = None
    engine.conv = None
    engine._iter = 0
    engine.best_bound = -float("inf")
    engine._fixed_mask = torch.zeros((S, K), dtype=torch.bool, device=dev)
    engine._fixed_vals = torch.zeros((S, K), dtype=t, device=dev)
    # active-set compaction state is PER-TENANT: the folded constants
    # bake the previous request's rhs/cost values, so the plan, its
    # compacted factors and the kernel plans of the compacted modes
    # drop with the install (_compact_invalidate retires them; the
    # full-system factors survive) — the next tenant's fixer
    # re-accumulates and re-compacts against ITS data. Bucket
    # fingerprints include the shrink knobs, so shrink-on and
    # shrink-off requests never share a lease.
    if getattr(engine, "_shrink", None) is not None:
        engine._compact_invalidate()
        engine._shrink = None
    engine._shrink_factors.clear()
    # the port's counterparts of the JAX package's _shrink_skip_noted:
    # the targets whose plan came back None (not staged again) and the
    # cross-bucket transplant snapshot
    engine._shrink_failed.clear()
    engine._transplant_src = None
    if engine._shrink_status is not None:
        engine._shrink_status.update(
            {"fixed": 0, "free": K, "compactions": 0, "bucket": 0.0,
             "n_cols": int(b.n), "m_rows": int(b.m),
             # full-width estimate again — leaving the previous
             # tenant's compacted figure would stamp wrong est-HBM
             # evidence on the next tenant's bucket-0 iterations
             "est_hbm_bytes_per_iter": engine._shrink_est_hbm(
                 int(b.n), int(b.m))})
    # the factor cache stores (factors, data) pairs and the solvers
    # read THE CACHED DATA — refresh each entry's data snapshot to the
    # new vectors while keeping the factors (equilibration + scaled
    # matrices depend on (A, P, rho) + the reference cost scale, all
    # bucket identity or exact arithmetic transformations — the same
    # license that lets PH move q every iteration under one
    # factorization). ``_data_with_prox`` rebuilds from the qp_data
    # just installed; a ScaledView A swapped in by _get_factors rides
    # qp_data and is preserved by the _replace above.
    for fkey in list(engine._factors):
        fac, _stale = engine._factors[fkey]
        prox_on = fkey[1] if isinstance(fkey, tuple) else fkey
        engine._factors[fkey] = (fac,
                                 engine._data_with_prox(bool(prox_on)))
    # per-run EXTENSION state is per-tenant too: the device fixer's
    # streak counters / latched slot bounds and the rho updaters'
    # prox-center history would otherwise leak the previous tenant's
    # trajectory into the next wheel
    ext = getattr(engine, "extensions", None)
    for e in ([ext] if ext is not None else []) \
            + list(getattr(ext, "extensions", []) or []):
        r = getattr(e, "reset", None)
        if callable(r):
            r()
    # per-request caches: warm-start states carry the previous
    # tenant's iterates/scales, blacklists its pathology — drop them;
    # factors/plans stay. The port keeps no donation bookkeeping (the
    # JAX package's _chunk_donatable / _chunk_dirty / _pool_dirty):
    # its counterparts are the per-chunk states, the dispatch row
    # stores and the pool states themselves, all cleared here.
    for cache in (engine._qp_states, engine._chunk_states,
                  engine._dispatch_stores, engine._pool_states,
                  engine._chunk_no_retry, engine._hospital_no_retry,
                  engine._blacklist_calls):
        cache.clear()
    # the forensics carry holds the previous tenant's trajectory
    engine._forensic_state = None
    engine._forensic_last = None
    for attr in ("_warm_started", "_warm_started_xbar", "trivial_bound",
                 "W_new"):
        if hasattr(engine, attr):
            delattr(engine, attr)
    return engine


def consensus_results(engine, blocks, feas_tol=_CONSENSUS_FEAS_TOL):
    """Per-request results from a finished (possibly stacked) wheel:
    fix every scenario at its own node's consensus (integer nonant
    slots rounded), one prox-off feasibility solve, per-scenario
    objectives demultiplexed per block. Returns one dict per block:
    ``{"objective", "feasible", "xhat", "conv"}`` (objective None when
    the block's consensus is infeasible at tolerance — the
    ref. xhatbase "infeasibility => no bound" convention)."""
    vals = engine.round_nonants(to_host(engine.xbar, np.float64))
    engine.fix_nonants(vals)
    try:
        engine.solve_loop(w_on=False, prox_on=False, update=False,
                          fixed=True)
        st = engine._qp_states[("fixed", False)]
        pri = to_host(st.pri_res).reshape(-1)
        rel = to_host(st.pri_rel).reshape(-1)
        row_ok = (pri <= feas_tol) | (rel <= feas_tol)
        objs = to_host(engine._last_base_obj, np.float64).reshape(-1)
    finally:
        engine.unfix_nonants()
        # an infeasible block leaves a diverged fixed-mode state behind
        # — drop the warm states (the chunked mode's per-chunk ones
        # too) so the next tenant's evaluation starts clean
        engine._qp_states.pop(("fixed", False), None)
        engine._chunk_states.pop(("fixed", False), None)
    prob = to_host(engine.prob, np.float64)
    e_objs = sbatch.demux_expectation(objs, prob, blocks)
    out = []
    for bl, e in zip(blocks, e_objs):
        feas = bool(row_ok[bl].all())
        out.append({"objective": e if feas else None,
                    "feasible": feas,
                    "xhat": vals[bl][0].tolist(),
                    "conv": obs.finite_or_none(
                        float(engine.conv)
                        if engine.conv is not None else None)})
    return out


def dive_incumbent_result(engine) -> dict:
    """Solo-consensus result through ``calculate_incumbent`` — the
    path that DIVES second-stage integers to integral values (exactly
    the CLI x̂ evaluation semantics). Used for every solo wheel of a
    recourse-integer model, chain steps included; such models never
    stack (consensus_results' prox-off solve would leave the recourse
    integers fractional)."""
    vals = engine.round_nonants(to_host(engine.xbar, np.float64))
    obj = engine.calculate_incumbent(vals)
    return {"objective": obj, "feasible": obj is not None,
            "xhat": vals[0].tolist(),
            "conv": obs.finite_or_none(
                float(engine.conv)
                if engine.conv is not None else None)}


# ---------------------------------------------------------------- service


class ServeService:
    """The serving loop: admission -> batcher -> warm wheels -> durable
    results. Start with :meth:`start`; feed it via :meth:`submit` (the
    HTTP plane calls it); stop with :meth:`stop` (drain) or
    :meth:`preempt` (checkpoint + exit, the SIGTERM path)."""

    def __init__(self, cfg: ServeConfig, dtype=None):
        cfg.validate()
        self.cfg = cfg
        # every engine of the service lives here: raises now, before
        # any request is admitted, when there is no card and the
        # caller did not ask for the CPU
        self.device = resolve_device(cfg.device)
        self.dtype = dtype
        os.makedirs(cfg.state_dir, exist_ok=True)
        self.store = RequestStore(cfg.state_dir)
        self.queue = AdmissionQueue(cfg.queue_limit)
        self.cache = WarmCache(cfg.cache_buckets)
        self._requests: dict[str, Request] = {}
        self._req_lock = threading.Lock()
        self._base_batches: dict[str, object] = {}   # bucket -> base batch
        self._base_lock = threading.Lock()
        self._recovered_groups: list[list] = []
        self._active_hubs: dict[str, object] = {}    # ns -> live hub
        self._hub_lock = threading.Lock()
        self._workers: list[threading.Thread] = []
        self._stop = False
        self._preempting = False
        self._started_unix = None
        # the fleet half (serve/migrate): peer registry (None = solo
        # host), the receiver staging machinery, drain state, and the
        # SIGTERM escalation latch (bundle-and-exit becomes
        # migrate-then-exit when a live peer exists)
        self.peers = PeerRegistry(cfg.peers) if cfg.peers else None
        # a legit open offer lives at most one donor transfer deadline;
        # 4x is the generous bound past which the donor is presumed
        # dead and the staged offer reclaimed (sweep)
        self.receiver = MigrationReceiver(
            cfg.state_dir,
            offer_ttl=max(120.0, 4.0 * cfg.migrate_deadline))
        self._draining = False
        self._migrate_exit = False
        self._fault_injector = None   # testing/faults.ServeFaultInjector

    # ---- paths ----
    def _ckpt_ns(self, ns: str) -> str:
        """Per-request/group checkpoint namespace: ONE writer per
        directory, so retention and the LATEST pointer can never
        cross-read between concurrent wheels (the checkpoint manager's
        single-writer assumption, enforced by construction)."""
        return os.path.join(self.cfg.state_dir, "ckpt", ns)

    def _group_dir(self) -> str:
        d = os.path.join(self.cfg.state_dir, "groups")
        os.makedirs(d, exist_ok=True)
        return d

    def _sweep_terminal(self):
        """Startup retention (the request-store twin of checkpoint
        keep-N): terminal records older than ``request_retention``
        drop with their ckpt namespace; group files past retention go
        too (live groups are always younger — they are rewritten at
        dispatch). Results stay durable for the whole window."""
        import shutil
        horizon = time.time() - self.cfg.request_retention
        for r in self.store.load_all():
            if r.status in ("done", "failed", "migrated") \
                    and (r.finished_unix or r.submitted_unix) < horizon:
                self.store.delete(r.id)
                shutil.rmtree(self._ckpt_ns(r.id), ignore_errors=True)
        gdir = self._group_dir()
        for fn in os.listdir(gdir):
            fp = os.path.join(gdir, fn)
            try:
                if os.path.getmtime(fp) < horizon:
                    os.remove(fp)
                    shutil.rmtree(self._ckpt_ns(fn[:-len(".json")]),
                                  ignore_errors=True)
            except OSError:
                pass

    # ---- lifecycle ----
    def start(self):
        self._started_unix = time.time()
        self._sweep_terminal()
        self._recover()
        obs.event("serve.start",
                  {"state_dir": self.cfg.state_dir,
                   "max_wheels": self.cfg.max_wheels,
                   "batch_max": self.cfg.batch_max,
                   "cache_buckets": self.cfg.cache_buckets,
                   "device": str(self.device)})
        for i in range(self.cfg.max_wheels):
            t = threading.Thread(target=self._worker_loop,
                                 name=f"serve-wheel{i}", daemon=True)
            t.start()
            self._workers.append(t)
        return self

    def stop(self, join_timeout=60.0):
        """Graceful drain: finish active wheels, leave queued requests
        durable for the next start. When exiting under migrate-then-
        exit (SIGTERM with a live peer) or a deploy drain, whatever
        never reached a worker hands off record-only — queued work is
        pure payload, nothing to bundle."""
        self._stop = True
        self.queue.stop()
        for t in self._workers:
            t.join(timeout=join_timeout)
        if self.peers is not None and (self._migrate_exit
                                       or self._draining):
            for r in self.store.load_all():
                if r.status == "queued":
                    self._migrate_out(r)
        obs.event("serve.stop", {"preempted": self._preempting})

    def preempt(self, source="sigterm"):
        """The preemption notice (SIGTERM): checkpoint every in-flight
        wheel through its hub (forced final bundle), mark the wheel
        terminated, and stop. Solo host: in-flight requests persist as
        ``preempted`` and resume from their bundle at the next start —
        the serve-level twin of Hub.handle_preemption. With a live
        peer (``--peers``), SIGTERM ESCALATES from bundle-and-exit to
        migrate-then-exit: each forced bundle hands off to the peer
        and the request finishes THERE instead of waiting for this
        host to come back."""
        if self._preempting:
            return
        self._preempting = True
        self._migrate_exit = (self.peers is not None
                              and self.peers.any_live())
        obs.counter_add("serve.preempted")
        obs.event("serve.preempt", {"source": source,
                                    "active": len(self._active_hubs),
                                    "migrate_exit": self._migrate_exit})
        global_toc(f"serve: preemption notice ({source}); "
                   + ("migrating in-flight wheels to a peer"
                      if self._migrate_exit
                      else "checkpointing in-flight wheels"))
        self.queue.stop()
        self._stop = True
        with self._hub_lock:
            hubs = list(self._active_hubs.values())
        for hub in hubs:
            try:
                hub.handle_preemption(source)
            except Exception:     # a torn wheel must not block the rest
                pass

    def drain(self, source="http") -> dict:
        """Drain-for-deploy (``POST /drain``): refuse new admissions
        (503 + ``Retry-After`` + a peer hint), hand queued and
        in-flight work to a live peer, and finish locally whatever
        cannot migrate — the service stays up (and keeps answering
        ``GET /result``) until ``/shutdown``. Idempotent."""
        if not self._draining:
            self._draining = True
            obs.counter_add("serve.drained")
            obs.event("serve.drain", {"source": source,
                                      "active": len(self._active_hubs)})
            global_toc(f"serve: draining ({source}); "
                       + ("migrating work to peers"
                          if self.peers is not None else
                          "no peers configured — finishing work "
                          "locally"))
            with self._hub_lock:
                hubs = list(self._active_hubs.values())

            def _kick(hubs=hubs):
                # force every active wheel to a bundle at its next
                # iteration boundary; the wheel exits "preempted" and
                # its worker hands the request off (or requeues it
                # no-migrate to finish locally)
                for hub in hubs:
                    try:
                        hub.handle_preemption("drain")
                    except Exception:
                        pass
            threading.Thread(target=_kick, name="serve-drain-kick",
                             daemon=True).start()
        return {"ok": True, "draining": True,
                "queued": len(self.queue),
                "active": len(self._active_hubs),
                "peer": self.peer_hint()}

    def peer_hint(self) -> str | None:
        """The live peer a refused client should try (rides draining
        503 bodies)."""
        return self.peers.first_live() if self.peers is not None \
            else None

    # ---- admission (the HTTP plane calls these) ----
    def submit(self, payload: dict) -> Request:
        sbatch.validate_payload(payload)
        batchable = bool(payload.get("batchable", True)) \
            and "chain" not in payload
        req = Request(payload, bucket=sbatch.bucket_key(payload),
                      batchable=batchable,
                      deadline=payload.get("deadline",
                                           self.cfg.default_deadline))
        self.store.save(req)
        with self._req_lock:
            self._requests[req.id] = req
        try:
            self.queue.push(req)
        except Exception:
            # roll the admission back entirely: the client was told
            # no, so the durable record must not resurrect at restart
            with self._req_lock:
                self._requests.pop(req.id, None)
            self.store.delete(req.id)
            obs.counter_add("serve.requests.rejected")
            raise
        obs.counter_add("serve.requests.admitted")
        obs.event("serve.admit", {"id": req.id, "bucket": req.bucket,
                                  "batchable": req.batchable,
                                  "chain": "chain" in payload})
        return req

    def result(self, req_id: str) -> dict | None:
        with self._req_lock:
            req = self._requests.get(req_id)
        if req is None:
            req = self.store.load(req_id)    # results outlive the process
        return None if req is None else req.to_json()

    def status_snapshot(self) -> dict:
        with self._req_lock:
            counts = {}
            for r in self._requests.values():
                counts[r.status] = counts.get(r.status, 0) + 1
        with self._hub_lock:
            wheels = []
            for ns, hub in self._active_hubs.items():
                try:
                    wheels.append(hub.status_snapshot())
                except Exception:
                    wheels.append({"request_tag": ns,
                                   "error": "snapshot failed"})
        return {"type": "serve", "wall_time_unix": time.time(),
                "started_unix": self._started_unix,
                "state_dir": self.cfg.state_dir,
                "preempting": self._preempting,
                "draining": self._draining,
                "peers": self.peers.peers if self.peers else [],
                "queue_depth": len(self.queue),
                "requests": counts,
                "wheels": wheels,
                "cache": self.cache.status()}

    def queue_snapshot(self) -> dict:
        with self._req_lock:
            reqs = [r.summary() for r in self._requests.values()]
        return {"queued": self.queue.snapshot(), "requests": reqs}

    # ---- migration: the donor half (serve/migrate) ----
    def _resume_bundle_for(self, r) -> str | None:
        """The newest resumable bundle for one request — the same
        lookup startup recovery runs (chain requests fall back to
        their newest committed step's namespace)."""
        bundle = latest_bundle(self._ckpt_ns(r.id))
        if bundle is None and "chain" in r.payload:
            step = len(r.chain_results)
            for j in (step, step - 1):
                if j < 0:
                    break
                bundle = latest_bundle(
                    self._ckpt_ns(f"{r.id}-step{j}"))
                if bundle is not None:
                    break
        return bundle

    def _migrate_out(self, req, gid=None) -> bool:
        """Hand one request to a live peer. Two-phase: the durable
        record flips to ``migrating`` BEFORE the first wire byte and
        settles ``migrated`` only after the receiver's commit ack —
        any failure books ``serve.migrate.aborted.<reason>``, restores
        the previous status and returns False so the caller finishes
        the wheel itself. The ledger invariant: every ``offered``
        settles as exactly one of ``handed_off`` / ``aborted.*``."""
        if self.peers is None:
            return False
        obs.counter_add("serve.migrate.offered")
        peer = self.peers.first_live()
        if peer is None:
            reason = "no_live_peer"
            obs.counter_add(f"serve.migrate.aborted.{reason}")
            obs.event("serve.migrate_abort",
                      {"id": req.id, "reason": reason})
            return False
        # group bundles do not transfer (their fingerprint is stack-
        # specific — config_fingerprint over the member ids): group
        # members hand off record-only and restart cold on the peer
        bundle = self._resume_bundle_for(req) if gid is None else None
        prev_status = req.status
        req.status = "migrating"
        req.peer = peer
        self.store.save(req)
        inj = self._fault_injector
        client = MigrationClient(
            peer, deadline=self.cfg.migrate_deadline,
            retries=self.cfg.migrate_retries,
            tear_hook=inj.on_transfer if inj is not None else None)
        rec = req.to_json()
        rec["status"] = "queued"     # the receiver admits it fresh
        rec["group"] = None
        try:
            client.migrate(rec, bundle)
        except MigrationError as e:
            obs.counter_add(f"serve.migrate.aborted.{e.reason}")
            obs.event("serve.migrate_abort",
                      {"id": req.id, "peer": peer, "reason": e.reason,
                       "detail": str(e)})
            global_toc(f"serve: migration of {req.id} -> {peer} "
                       f"aborted ({e.reason}); finishing locally")
            req.status = prev_status
            req.peer = None
            self.store.save(req)
            return False
        req.finished_unix = time.time()
        req.status = "migrated"
        self.store.save(req)
        obs.counter_add("serve.migrate.handed_off")
        obs.event("serve.migrate", {"id": req.id, "peer": peer,
                                    "bundle": bool(bundle)})
        global_toc(f"serve: migrated {req.id} -> {peer}"
                   + (" (with bundle)" if bundle else " (record only)"))
        return True

    def _park_or_migrate(self, r, gid=None):
        """A wheel interrupted by preemption or drain either hands its
        request to a peer, requeues it to finish locally (drain with
        no taker — the degradation guarantee), or parks it
        ``preempted`` for this host's own restart."""
        if (self._draining or self._migrate_exit) \
                and not getattr(r, "_no_migrate", False) \
                and self._migrate_out(r, gid=gid):
            return
        if self._draining and not self._preempting:
            r._no_migrate = True
            r.group = None
            r.no_batch = True
            r.status = "queued"
            self.store.save(r)
            self.queue.push(r, front=True, force=True)
            return
        r.status = "preempted"
        self.store.save(r)
        obs.counter_add("serve.requests.preempted")

    # ---- migration: the receiver half (the HTTP plane calls these) ----
    def migrate_offer(self, payload: dict) -> dict:
        try:
            if self._preempting or self._stop or self._draining:
                raise MigrationError("draining",
                                     "receiver is draining/stopping")
            inj = self._fault_injector
            if inj is not None:
                verdict, sleep_s = inj.on_offer()
                if sleep_s:
                    time.sleep(sleep_s)
                if verdict == "refuse":
                    raise MigrationError("refused",
                                         "fault plan: refuse_peer")
            self.receiver.sweep()
            rid = ((payload or {}).get("request") or {}).get("id")
            prior = self.store.load(rid) if rid else None
            if prior is not None and prior.status != "migrated":
                # idempotent by request id: an earlier handoff of this
                # request already landed (or it ran here) — ack
                # without re-staging. A local record in the
                # ``migrated`` state is the ONE exception: that is
                # this host's hand-AWAY marker, not ownership — a
                # round-trip offer (we migrated it out, the peer now
                # drains it back) must re-admit and supersede the
                # stale record, because acking 'already' would leave
                # BOTH hosts settled 'migrated' and lose the request.
                return {"ok": True, "already": True, "request_id": rid}
            out = self.receiver.offer(payload)
            obs.counter_add("serve.migrate.accepted")
            return {"ok": True, **out}
        except MigrationError as e:
            obs.counter_add(f"serve.migrate.rejected.{e.reason}")
            raise

    def migrate_put(self, mid: str, name: str, stream, length) -> dict:
        try:
            return self.receiver.put_member(mid, name, stream,
                                            int(length))
        except MigrationError as e:
            obs.counter_add(f"serve.migrate.rejected.{e.reason}")
            raise

    def migrate_commit(self, payload: dict) -> dict:
        try:
            mid = (payload or {}).get("migration_id")
            if self._preempting or self._stop or self._draining:
                # mirror the offer guard: an offer staged just before
                # the drain began must not commit onto an evacuating
                # host (it would be admitted only to migrate straight
                # back out) — drop the staging and send the donor a
                # reasoned refusal so it finishes the wheel locally
                if mid:
                    self.receiver.abort(mid)
                raise MigrationError("draining",
                                     "receiver is draining/stopping")
            rid = (payload or {}).get("request_id")
            prior = self.store.load(rid) if rid else None
            if prior is not None and prior.status != "migrated":
                # the donor's ack got lost and it re-committed (or
                # re-offered): the request is already durable here —
                # ack idempotently, never admit twice. A stale
                # ``migrated`` record (this host handed the request
                # away earlier; it is round-tripping home) does NOT
                # short-circuit — the admission below supersedes it.
                if mid:
                    self.receiver.abort(mid)
                return {"ok": True, "already": True, "request_id": rid}
            if not mid:
                raise MigrationError("refused",
                                     "commit needs migration_id")
            rec0 = self.receiver.offer_record(mid)
            # the solo-request checkpoint fingerprint is (bucket,
            # request id) — both ride the record, so the recomputed
            # value is bit-identical on any host and the staged bundle
            # passes the SAME load_bundle gate a local resume runs
            fingerprint = config_fingerprint(
                {"bucket": rec0.get("bucket"), "request": rec0["id"]})
            rec, bundle = self.receiver.finalize(
                mid, self._ckpt_ns(rec0["id"]), fingerprint)
            req = Request.from_json(rec)
            req.status = "queued"
            req.group = None
            req.peer = None
            req.migrated_from = str(mid)
            req.resume_from = bundle
            req.resumed = bool(bundle) or req.resumed
            self.store.save(req)
            with self._req_lock:
                self._requests[req.id] = req
            self.queue.push(req, front=True, force=True)
            obs.counter_add("serve.migrate.committed")
            obs.event("serve.migrate_in",
                      {"id": req.id, "migration_id": mid,
                       "bundle": bool(bundle)})
            global_toc(f"serve: migrated-in {req.id}"
                       + (" (with bundle)" if bundle
                          else " (record only)"))
            return {"ok": True, "request_id": req.id,
                    "resumed": bool(bundle)}
        except MigrationError as e:
            obs.counter_add(f"serve.migrate.rejected.{e.reason}")
            raise

    def migrate_abort(self, payload: dict) -> dict:
        """The donor gave up after a successful offer (transfer
        failed, deadline hit, commit refused): drop the staged offer
        now instead of leaking it until the TTL sweep. Idempotent —
        an unknown or already-consumed id is a no-op."""
        mid = (payload or {}).get("migration_id")
        if not mid:
            raise MigrationError("refused", "abort needs migration_id")
        self.receiver.abort(str(mid))
        obs.counter_add("serve.migrate.offer_aborted")
        return {"ok": True, "migration_id": mid}

    # ---- recovery (restart after preemption / kill) ----
    def _recover(self):
        import json as _json
        reqs = [r for r in self.store.load_all()
                if r.status in ("queued", "running", "preempted",
                                "migrating")]
        if not reqs:
            return
        live = []
        for r in reqs:
            if r.status == "migrating":
                # the donor (us, last life) died mid-handoff with the
                # commit outcome unknown — the peer's durable record
                # is the truth. Present: the handoff DID land, settle
                # migrated. Absent/unreachable: re-admit locally (the
                # receiver's idempotent commit is the double-admission
                # guard if the ack was merely late). Either way the
                # restarted process re-books the offer so ITS ledger
                # balances (the dead process's counters died with it).
                obs.counter_add("serve.migrate.offered")
                if resolve_interrupted_migration(r.peer, r.id):
                    r.finished_unix = r.finished_unix or time.time()
                    r.status = "migrated"
                    self.store.save(r)
                    with self._req_lock:
                        self._requests[r.id] = r
                    obs.counter_add("serve.migrate.handed_off")
                    obs.event("serve.migrate",
                              {"id": r.id, "peer": r.peer,
                               "resolved": "interrupted handoff had "
                                           "landed"})
                    continue
                reason = "interrupted"
                obs.counter_add(f"serve.migrate.aborted.{reason}")
                obs.event("serve.migrate_abort",
                          {"id": r.id, "peer": r.peer,
                           "reason": reason})
                r.peer = None
            if r.status in ("running", "preempted", "migrating"):
                # poison-pill quarantine: a record that keeps getting
                # re-admitted without ever finishing is taking the
                # service down with it — settle it failed with the
                # count instead of crash-looping forever
                r.recoveries += 1
                if r.recoveries > self.cfg.max_recoveries:
                    obs.counter_add("serve.request.quarantined")
                    obs.event("serve.quarantine",
                              {"id": r.id, "recoveries": r.recoveries})
                    global_toc(f"serve: quarantining {r.id} "
                               f"(recovered {r.recoveries}x without "
                               "finishing)")
                    self._finish(
                        r, "failed",
                        error=f"quarantined: recovered {r.recoveries} "
                              f"times without finishing (poison "
                              f"pill? raise --max-recoveries to "
                              f"retry)")
                    with self._req_lock:
                        self._requests[r.id] = r
                    continue
            live.append(r)
        reqs = live
        if not reqs:
            return
        by_id = {r.id: r for r in reqs}
        claimed = set()
        gdir = self._group_dir()
        for fn in sorted(os.listdir(gdir)):
            if not fn.endswith(".json"):
                continue
            try:
                g = _json.load(open(os.path.join(gdir, fn),
                                    encoding="utf-8"))
            except (OSError, ValueError):
                continue
            members = [by_id.get(i) for i in g.get("members") or []]
            if not members or any(m is None or m.status == "queued"
                                  for m in members):
                continue        # incomplete group: members recover solo
            gid = g.get("gid") or fn[:-len(".json")]
            bundle = latest_bundle(self._ckpt_ns(gid))
            if bundle is None:
                continue        # no state: members re-run solo
            for m in members:
                m.group = gid
                m.resume_from = bundle
                m.resumed = True
                claimed.add(m.id)
            self._recovered_groups.append(members)
        for r in reqs:
            if r.id in claimed:
                obs.counter_add("serve.requests.resumed")
                obs.event("serve.resume", {"id": r.id, "group": r.group,
                                           "bundle": r.resume_from})
                continue
            r.group = None
            if r.status in ("running", "preempted", "migrating"):
                bundle = self._resume_bundle_for(r)
                if bundle is not None:
                    r.resume_from = bundle
                    r.resumed = True
                    obs.counter_add("serve.requests.resumed")
                    obs.event("serve.resume",
                              {"id": r.id, "bundle": bundle})
            r.status = "queued"
            self.store.save(r)
            self.queue.push(r, force=True)
            with self._req_lock:
                self._requests[r.id] = r
        for members in self._recovered_groups:
            for m in members:
                m.status = "queued"
                self.store.save(m)
                with self._req_lock:
                    self._requests[m.id] = m

    # ---- the wheel workers ----
    def _worker_loop(self):
        while not self._stop:
            self.receiver.sweep()   # reclaim offers from dead donors
            group = None
            if self._recovered_groups:
                try:
                    group = self._recovered_groups.pop(0)
                except IndexError:
                    group = None
            if group is None:
                group = self.queue.pop_group(self.cfg.batch_window,
                                             self.cfg.batch_max,
                                             timeout=0.5)
            if not group:
                continue
            group = self._settle_expired(group)
            if not group:
                continue
            try:
                if "chain" in group[0].payload:
                    self._run_chain(group[0])
                else:
                    self._run_group(group)
            except Exception as e:   # a torn wheel must not kill the loop
                self._fail_group(group, e)

    def _settle_expired(self, group):
        live = []
        for r in group:
            rem = r.deadline_remaining()
            if rem is not None and rem <= 0:
                # counter BEFORE the status flip: a poller that sees
                # "failed" must already see the miss booked
                obs.counter_add("serve.requests.deadline_missed")
                self._finish(r, "failed", error="deadline expired in "
                                                "queue")
            else:
                live.append(r)
        return live

    def _finish(self, req, status, result=None, error=None):
        # result/error land BEFORE the status flip: a concurrent
        # GET /result serializes this object, and "done" with a null
        # result would end a client's poll loop on half a record
        if result is not None:
            req.result = result
        if error is not None:
            req.error = str(error)
        req.finished_unix = time.time()
        req.status = status
        self.store.save(req)
        if status == "done":
            obs.counter_add("serve.requests.completed")
            if req.migrated_from:
                # the receiver-side close of a handoff: the migrated-in
                # request actually finished here — the gate's e2e
                # signal (regression_gate migrate smoke)
                obs.counter_add("serve.migrate.completed")
        elif status == "failed":
            obs.counter_add("serve.requests.failed")
        obs.event("serve.result", {"id": req.id, "status": status,
                                   "error": req.error})

    def _fail_group(self, group, exc):
        if len(group) > 1 and not self._stop:
            # one bad tenant must not take the group down: members
            # requeue as solo (no_batch) so only the offender fails
            global_toc(f"serve: stacked wheel failed ({exc!r}); "
                       f"re-running {len(group)} member(s) solo")
            for r in group:
                r.group = None
                r.no_batch = True
                r.status = "queued"
                self.store.save(r)
                self.queue.push(r, front=True, force=True)
            return
        for r in group:
            self._finish(r, "failed", error=exc)

    def _base_batch(self, bucket, payload):
        # serialized: concurrent workers must not build the same
        # (potentially expensive) base twice or race the FIFO eviction
        with self._base_lock:
            b = self._base_batches.get(bucket)
            if b is None:
                from ..utils.vanilla import build_batch_for
                b = build_batch_for(sbatch.base_runconfig(payload))
                while len(self._base_batches) >= self.cfg.cache_buckets:
                    self._base_batches.pop(
                        next(iter(self._base_batches)), None)
                self._base_batches[bucket] = b
            return b

    def _has_recourse_integers(self, base) -> bool:
        nonant_cols = np.zeros(base.n, bool)
        nonant_cols[np.asarray(base.nonant_idx)] = True
        return bool((np.asarray(base.integer) & ~nonant_cols).any())

    def _run_group(self, group):
        if self._preempting:
            # popped in the race window around the preemption notice:
            # park (or hand off) instead of launching a wheel the
            # shutdown would kill
            for r in group:
                self._park_or_migrate(r)
            return
        if self._draining:
            # drain-for-deploy: queued work leaves BEFORE spending a
            # wheel on it; whatever no peer takes runs here, solo
            # no-batch — drain degrades to "finish local work", never
            # to losing it
            keep = []
            for r in group:
                if getattr(r, "_no_migrate", False) \
                        or not self._migrate_out(r):
                    r._no_migrate = True
                    keep.append(r)
            group = keep
            if not group:
                return
        bucket = group[0].bucket
        base = self._base_batch(bucket, group[0].payload)
        rec_ints = self._has_recourse_integers(base)
        if len(group) > 1 and rec_ints:
            # batching eligibility: blocks with
            # recourse integers need the dive evaluation path, which is
            # single-consensus — run them solo
            for r in group[1:]:
                r.no_batch = True
                self.queue.push(r, front=True, force=True)
            group = group[:1]
        gid = None
        if len(group) > 1:
            gid = f"grp-{secrets.token_hex(5)}"
            atomic_write_json(
                os.path.join(self._group_dir(), f"{gid}.json"),
                {"gid": gid, "members": [r.id for r in group]})
            obs.counter_add("serve.batch.wheels")
            obs.counter_add("serve.batch.coalesced", len(group))
        ns = gid or group[0].id
        now = time.time()
        for r in group:
            r.group = gid
            r.status = "running"
            r.started_unix = now
            if obs.enabled():
                obs.histogram_observe("serve.queue_wait_seconds",
                                      max(0.0, now - r.submitted_unix))
            self.store.save(r)
        obs.histogram_observe("serve.batch.occupancy", len(group))
        resume_from = group[0].resume_from if gid is None \
            else (group[0].resume_from if all(r.resumed for r in group)
                  else None)
        fingerprint = config_fingerprint(
            {"bucket": bucket, "stack": [r.id for r in group]}
            if gid else {"bucket": bucket, "request": group[0].id})
        stacked, blocks = sbatch.stack_instances(
            [sbatch.apply_patch(base, r.payload.get("patch"))
             for r in group])
        wheel = self._run_wheel(ns, bucket, len(group), stacked,
                                group[0].payload, fingerprint,
                                resume_from,
                                deadline=self._group_deadline(group),
                                solo_incumbent=dive_incumbent_result
                                if (gid is None and rec_ints)
                                else None)
        if wheel["preempted"]:
            # the donor half of a live handoff: the hub's forced final
            # bundle (handle_preemption) is exactly what the peer
            # resumes from — solo wheels ship it, group members hand
            # off record-only (the stacked bundle's fingerprint is
            # stack-specific)
            for r in group:
                self._park_or_migrate(r, gid=gid)
            return
        if wheel["deadline_missed"]:
            if gid is not None:
                # the stacked wheel ran under min() of the members'
                # SLOs — the tightest tenant's deadline must not fail
                # its neighbors: members re-run solo, where each gets
                # its OWN verdict (already-expired ones settle at the
                # next pop, unconstrained ones simply complete)
                global_toc(f"serve: stacked wheel {gid} missed its "
                           "tightest member deadline; re-running "
                           f"{len(group)} member(s) solo")
                for r in group:
                    r.group = None
                    r.no_batch = True
                    r.status = "queued"
                    self.store.save(r)
                    self.queue.push(r, front=True, force=True)
                return
            # counter BEFORE the status flip (same contract as the
            # chain path): a poller that sees "failed" must already
            # see the miss booked
            obs.counter_add("serve.requests.deadline_missed")
            self._finish(group[0], "failed",
                         error="wheel deadline exceeded")
            return
        for r, res in zip(group, wheel["results"]):
            self._finish(r, "done", result={**res, "wheel": wheel["stamp"]})
        if gid is not None:
            # the group file exists to re-form an IN-FLIGHT group at
            # restart; a settled group's file is dead weight
            try:
                os.remove(os.path.join(self._group_dir(),
                                       f"{gid}.json"))
            except OSError:
                pass

    def _group_deadline(self, group):
        rems = [r.deadline_remaining() for r in group]
        rems = [x for x in rems if x is not None]
        return min(rems) if rems else None

    def _run_wheel(self, ns, bucket, stack, stacked, payload,
                   fingerprint, resume_from, deadline=None,
                   solo_incumbent=None):
        """One wheel over a (possibly warm) engine: checkout/install
        or build+admit, hub-only cylinder with checkpointing under the
        request namespace, per-request deadline timer, results from
        the consensus. Returns the wheel record."""
        from ..cylinders.hub import PHHub
        from ..cylinders.supervisor import WheelDeadline

        algo = sbatch.request_algo(payload)
        ekey = sbatch.engine_key(bucket, stack)
        t0 = time.perf_counter()
        kbuilds0 = _kernel_build.BUILDS
        fbuilds0 = 0
        ent = None
        watchdog = None
        hub = None
        torn = True
        try:
            # wait=False: a concurrently-leased bucket builds an
            # unmanaged twin instead of head-of-line blocking this
            # worker behind another tenant's wheel (the documented
            # lease semantics — the twin re-pays the factorizations
            # and the kernel plans)
            leased = self.cache.checkout(ekey, wait=False)
            cache_hit = leased is not None
            t_engine = time.perf_counter()
            if leased is None:
                engine = build_engine(stacked, algo.to_options(),
                                      device=self.device, dtype=self.dtype)
                ent = self.cache.admit(ekey, engine,
                                       meta={"model":
                                             payload.get("model"),
                                             "stack": stack})
            else:
                ent = leased
                fbuilds0 = ent.engine.factor_builds
                engine = install_batch(ent.engine, stacked)
            engine_seconds = time.perf_counter() - t_engine
            hub_opts = {"checkpoint_dir": self._ckpt_ns(ns),
                        "checkpoint_interval":
                            self.cfg.checkpoint_interval,
                        "checkpoint_keep": 2,
                        "checkpoint_fingerprint": fingerprint,
                        "request_tag": ns}
            if resume_from:
                hub_opts["resume_from"] = resume_from
            if deadline is not None:
                hub_opts["wheel_deadline"] = max(0.1, float(deadline))
            hub = PHHub(engine, spokes=[], options=hub_opts)
            hub.make_windows()
            hub.setup_hub()
            with self._hub_lock:
                self._active_hubs[ns] = hub
            if deadline is not None:
                # the per-wheel process manager's timer half: fires
                # the hub watchdog even if an iteration wedges
                watchdog = WheelDeadline(hub, max(0.1, float(deadline)))
                watchdog.start()
            obs.counter_add("serve.wheels")
            if self._fault_injector is not None:
                # chaos harness (testing/faults "serve" plan): kill /
                # SIGTERM / wedge at the Nth wheel launch — the wedge
                # sleeps here so the WheelDeadline watchdog (already
                # armed above) fires exactly as it would for a hung
                # iteration
                self._fault_injector.on_wheel_start()
            resumed_iter = int(getattr(engine, "_iter", 0) or 0)
            hub.main()
            outer, inner = hub.hub_finalize()
            preempted = bool(hub._preempted)
            deadline_missed = bool(hub._watchdog_fired) \
                and not preempted
            # results AND the engine-state stamp fields are read
            # INSIDE the lease: another worker may checkout+install
            # this engine the moment it frees
            results = []
            if not (preempted or deadline_missed):
                if solo_incumbent is not None:
                    results = [solo_incumbent(engine)]
                else:
                    blocks = [slice(k * (stacked.S // stack),
                                    (k + 1) * (stacked.S // stack))
                              for k in range(stack)]
                    results = consensus_results(engine, blocks)
            final_iter = int(getattr(engine, "_iter", 0) or 0)
            fbuilds = engine.factor_builds - fbuilds0
            final_conv = obs.finite_or_none(
                float(engine.conv) if engine.conv is not None else None)
            torn = False
        finally:
            if watchdog is not None:
                watchdog.cancel()
            with self._hub_lock:
                self._active_hubs.pop(ns, None)
            if ent is not None:
                if torn:
                    # the wheel raised mid-flight: the engine's state
                    # is not trustworthy — drop the entry so the next
                    # request of this bucket rebuilds cold (and the
                    # lease can never leak)
                    self.cache.discard(ent)
                else:
                    self.cache.checkin(ent)
        # the port's cold-shape costs: CUDA kernel builds and engine
        # factor builds (a fresh engine's are all new); their sum
        # stands where the JAX record counts XLA compiles
        kbuilds = _kernel_build.BUILDS - kbuilds0
        compiles = kbuilds + fbuilds
        if compiles:
            obs.counter_add(f"serve.bucket.compiles.{ekey}",
                            int(compiles))
        seconds = time.perf_counter() - t0
        if obs.enabled():
            obs.histogram_observe("serve.wheel_seconds", seconds)
        stamp = {"bucket": bucket, "engine_key": ekey, "stack": stack,
                 "cache_hit": cache_hit,
                 "xla_compiles_delta": int(compiles),
                 "kernel_builds_delta": int(kbuilds),
                 "factor_builds_delta": int(fbuilds),
                 # building the engine (a miss) or installing the
                 # request into the warm one (a hit)
                 "engine_seconds": engine_seconds,
                 "iterations": final_iter,
                 "resumed_from_iter": resumed_iter or None,
                 "outer_bound": obs.finite_or_none(outer)
                 if not (preempted or deadline_missed) else None,
                 "conv": final_conv,
                 "seconds": seconds}
        # per-wheel forensics (obs/diagnose.py): the wheel's diagnosis
        # verdict + top culprits ride the request stamp — a DNF'd
        # serve request names its stall instead of just timing out
        # (lock-free plain-dict read; the /metrics gauges ride the
        # registry automatically)
        snap = _obs_diagnose.snapshot()
        if snap:
            stamp["forensics"] = {
                "verdict": snap.get("verdict"),
                "top_slot": snap.get("top_slot"),
                "top_scen_share": snap.get("top_scen_share")}
        return {"stamp": stamp, "results": results,
                "preempted": preempted,
                "deadline_missed": deadline_missed,
                "outer": outer, "inner": inner}

    # ---- rolling-horizon chains ----
    def _run_chain(self, req):
        """First-class rolling-horizon request: one wheel per step,
        each warm-started from the previous step's bundle through the
        resume path; the committed head (stage-1 consensus) of every
        step rides the durable request record as it lands."""
        req.status = "running"
        req.started_unix = time.time()
        self.store.save(req)
        base = self._base_batch(req.bucket, req.payload)
        steps = req.payload["chain"]
        start = len(req.chain_results)     # restart skips committed steps
        fingerprint = config_fingerprint({"bucket": req.bucket,
                                          "request": req.id})
        for j in range(start, len(steps)):
            if self._stop or self._preempting:
                self._park_or_migrate(req)
                return
            ns = f"{req.id}-step{j}"
            resume_from = req.resume_from if j == start else None
            if resume_from is None and j > 0:
                # roll forward warm-started from the previous horizon
                resume_from = latest_bundle(
                    self._ckpt_ns(f"{req.id}-step{j - 1}"))
            req.resume_from = None
            stepb = sbatch.apply_patch(base,
                                       (steps[j] or {}).get("patch"))
            wheel = self._run_wheel(
                ns, req.bucket, 1, stepb, req.payload, fingerprint,
                resume_from, deadline=req.deadline_remaining(),
                solo_incumbent=dive_incumbent_result
                if self._has_recourse_integers(base) else None)
            if wheel["preempted"]:
                self._park_or_migrate(req)
                return
            if wheel["deadline_missed"]:
                obs.counter_add("serve.requests.deadline_missed")
                self._finish(req, "failed",
                             error=f"deadline exceeded at chain step "
                                   f"{j}")
                return
            res = wheel["results"][0]
            obs.counter_add("serve.chain.steps")
            req.chain_results.append(
                {"step": j, "committed_head": res["xhat"],
                 "objective": res["objective"],
                 "warm_started": bool(resume_from),
                 "wheel": wheel["stamp"]})
            self.store.save(req)       # commit the head durably per step
        self._finish(req, "done", result={"steps": req.chain_results})


# ------------------------------------------------------------- CLI


def _write_endpoint_file(state_dir, port):
    """``<state_dir>/serve.json``: where clients (and the tier-1 test)
    find an ephemeral-port service. Atomic like every serve artifact.
    ``pid`` + ``started_at`` make staleness decidable: clients
    (serve/migrate.read_endpoint) and a restarting service check the
    recorded pid before trusting the port — a file left by a killed
    process must read as "no service", not as an endpoint."""
    path = os.path.join(state_dir, "serve.json")
    now = time.time()
    atomic_write_json(path, {"port": port, "pid": os.getpid(),
                             "started_unix": now,
                             "started_at": time.strftime(
                                 "%Y-%m-%dT%H:%M:%S%z",
                                 time.localtime(now))})
    return path


def _check_endpoint_file(state_dir) -> bool:
    """Startup guard for ``serve.json``: a recorded LIVE foreign pid
    means another service already owns this state dir (two writers
    would corrupt the request store) — refuse. A dead pid is just a
    stale file from a killed process: overwrite and carry on."""
    info, stale = read_endpoint(state_dir)
    if info is None or info.get("pid") in (None, os.getpid()):
        return True
    if not stale:
        global_toc(f"serve: {state_dir}/serve.json records a live "
                   f"service (pid {info['pid']}, port "
                   f"{info.get('port')}) — refusing a second writer "
                   "on this state dir")
        return False
    obs.event("serve.endpoint_stale", {"pid": info.get("pid"),
                                       "port": info.get("port")})
    global_toc(f"serve: overwriting stale serve.json "
               f"(dead pid {info.get('pid')})")
    return True


def make_serve_parser():
    import argparse
    p = argparse.ArgumentParser(
        prog="python -m mpisppy_tpu_torch serve",
        description="persistent stochastic-program serving layer "
                    "(serve/)")
    p.add_argument("--port", type=int, default=8765,
                   help="bind port (0 = ephemeral; the bound port is "
                        "written to <state-dir>/serve.json)")
    p.add_argument("--host", type=str, default="127.0.0.1",
                   help="bind host (loopback default; the endpoints "
                        "accept work unauthenticated — 0.0.0.0 is an "
                        "explicit opt-in)")
    p.add_argument("--state-dir", type=str, required=True,
                   help="durable service state: request records, "
                        "per-request ckpt/ bundles, group files — a "
                        "restarted service resumes from here")
    p.add_argument("--max-wheels", type=int, default=1,
                   help="concurrent wheel workers (wheels beyond this "
                        "queue; same-bucket wheels serialize on the "
                        "warm engine lease)")
    p.add_argument("--queue-limit", type=int, default=64,
                   help="bounded admission queue size (full = 429)")
    p.add_argument("--batch-window", type=float, default=0.25,
                   help="seconds the scenario-axis batcher waits for "
                        "same-bucket stragglers before launching")
    p.add_argument("--batch-max", type=int, default=8,
                   help="max requests per stacked wheel (1 disables "
                        "coalescing)")
    p.add_argument("--cache-buckets", type=int, default=8,
                   help="warm-cache capacity (LRU over shape buckets)")
    p.add_argument("--checkpoint-interval", type=float, default=5.0,
                   help="seconds between periodic per-wheel bundles")
    p.add_argument("--default-deadline", type=float, default=None,
                   help="default per-request SLO seconds (requests may "
                        "override); wired to the wheel_deadline "
                        "watchdog")
    p.add_argument("--request-retention", type=float,
                   default=7 * 24 * 3600.0,
                   help="sweep terminal request records (and their "
                        "ckpt namespaces) older than this many "
                        "seconds at startup (default 7 days)")
    p.add_argument("--peers", type=str, default="",
                   help="comma-separated peer base URLs "
                        "(host:port or http://host:port) this host "
                        "may hand live wheels to; empty = solo host "
                        "(SIGTERM stays bundle-and-exit)")
    p.add_argument("--migrate-deadline", type=float, default=60.0,
                   help="per-transfer wall-clock budget (seconds) for "
                        "one live handoff; on expiry the donor aborts "
                        "and finishes the wheel itself")
    p.add_argument("--migrate-retries", type=int, default=3,
                   help="retry attempts per migration HTTP call "
                        "(jittered exponential backoff under the "
                        "transfer deadline)")
    p.add_argument("--max-recoveries", type=int, default=3,
                   help="poison-pill bound: a request re-admitted by "
                        "startup recovery more than this many times "
                        "settles failed (quarantined) instead of "
                        "crash-looping the service")
    p.add_argument("--telemetry-dir", type=str, default=None,
                   help="unified telemetry for the service process "
                        "(obs/); also enables the "
                        "per-wheel build/batch counters analyze's "
                        "serving section reads")
    p.add_argument("--f32", action="store_true",
                   help="run engines in float32 (see the run CLI flag)")
    p.add_argument("--device", type=str, default=None,
                   help="device of every engine: default the CUDA "
                        "device (the service raises without one); "
                        "'cpu' runs on the CPU")
    return p


def serve_main(argv=None) -> int:
    """``python -m mpisppy_tpu_torch serve ...`` — bring up the service,
    write the endpoint file, serve until SIGTERM/SIGINT (preempt:
    checkpoint in-flight wheels, durable statuses, exit 0) or
    ``POST /shutdown`` (graceful drain)."""
    import signal

    from ..utils.runtime import pin_precision
    from .http import ServeHTTPServer

    args = make_serve_parser().parse_args(argv)
    cfg = ServeConfig(
        host=args.host, port=args.port, state_dir=args.state_dir,
        max_wheels=args.max_wheels, queue_limit=args.queue_limit,
        batch_window=args.batch_window, batch_max=args.batch_max,
        cache_buckets=args.cache_buckets,
        checkpoint_interval=args.checkpoint_interval,
        default_deadline=args.default_deadline,
        request_retention=args.request_retention,
        telemetry_dir=args.telemetry_dir,
        peers=tuple(p.strip() for p in args.peers.split(",")
                    if p.strip()),
        migrate_deadline=args.migrate_deadline,
        migrate_retries=args.migrate_retries,
        max_recoveries=args.max_recoveries,
        device=args.device).validate()
    pin_precision()
    if cfg.telemetry_dir:
        obs.configure(out_dir=cfg.telemetry_dir, role="serve",
                      config={"serve": cfg.to_dict()})
    else:
        obs.maybe_configure_from_env(role="serve")
    if not _check_endpoint_file(cfg.state_dir):
        return 2

    service = ServeService(cfg,
                           dtype=torch.float32 if args.f32 else None)
    if os.environ.get("MPISPPY_TPU_FAULT_PLAN"):
        # env-gated: the clean path never imports testing (chaos runs
        # opt in through MPISPPY_TPU_FAULT_PLAN)
        from ..testing.faults import ServeFaultInjector
        inj = ServeFaultInjector.from_env()
        if inj is not None:
            service._fault_injector = inj
            inj.start_timers()
    service.start()
    done = threading.Event()

    def _drain():
        threading.Thread(target=lambda: (service.stop(), done.set()),
                         name="serve-drain", daemon=True).start()

    server = ServeHTTPServer(service, cfg.port, host=cfg.host,
                             on_shutdown=_drain).start()
    _write_endpoint_file(cfg.state_dir, server.port)
    global_toc(f"serve: listening on {cfg.host}:{server.port} "
               f"(state {cfg.state_dir})")

    def _on_signal(signum, frame):
        service.preempt(signal.Signals(signum).name.lower())
        done.set()

    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            signal.signal(sig, _on_signal)
        except ValueError:
            pass      # not the main thread (programmatic callers)
    try:
        done.wait()
    finally:
        server.stop()
        service.stop(join_timeout=30.0)
        obs.shutdown() if cfg.telemetry_dir else obs.flush()
    return 0
