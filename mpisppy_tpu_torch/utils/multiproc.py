"""Multi-process cylinders over the native shared-memory windows (the
port of the JAX package's utils/multiproc.py).

The reference runs each cylinder as its own MPI process group and wires
the hub-spoke star with MPI RMA windows (ref. mpisppy/utils/sputils.py:
133-151 make_comms, cylinders/spcommunicator.py:97-124). Here each spoke
runs as its own OS process with its own engine, its own interpreter and
its own CUDA context, talking to the hub through the native seqlock
windows (ops/native). The write-id/kill protocol is the in-process
backend's, so hub and spoke code runs unchanged.

Children start from the ``spawn`` context (CUDA does not survive a
fork) and run this module's ``_spoke_worker`` by its import path, so
they run the port's code. Each child builds its engine on the device
the config names (``RunConfig.device``: None for the card, ``"cpu"``
in the tests) and, as every engine does, loads torch's CUDA linear-
algebra library in its constructing thread.

The wheel is supervised (cylinders/supervisor.py): dead spokes are
respawned on fresh window pairs, repeat offenders quarantined, and
``wheel_deadline`` arms a watchdog. Telemetry: every child records
into the run's telemetry directory under its own role
(``events-spoke<i>-<kind>.jsonl``, ``trace-...``, ``metrics-...``), and
the hub merges every process's trace into one ``trace_merged.json``
with one track per process after the wheel ends (obs/merge.py). What
the port does not run yet raises, naming its ROADMAP.md item.

Checkpoints (ckpt/): with ``checkpoint_dir`` each spoke child keeps its
warm-state file fresh and a respawned generation resumes from the one
its predecessor wrote; ``resume_from`` resumes the hub and the spokes
from a bundle; a SIGTERM to the hub process captures a final bundle and
stops the wheel cleanly. Fault plans (testing/faults.py): a spoke's
``fault_plan`` option or the ``MPISPPY_TPU_FAULT_PLAN`` environment
variable arms the injectors, imported only when a plan is given.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import secrets
import signal
import time

from .. import global_toc, obs
from ..cylinders.spcommunicator import LINEAGE_SLOTS, Window
from ..cylinders.spoke import ConvergerSpokeType
from .config import RunConfig, config_from_dict


def _telemetry_out_dir(cfg):
    """The run directory the children capture into: the config's
    ``telemetry_dir`` wins, then a programmatically configured parent
    session (``obs.configure(out_dir=...)``), then the environment
    variable the spawned children inherit anyway."""
    d = getattr(cfg, "telemetry_dir", None)
    if d:
        return d
    rec = obs.active()
    if rec is not None and rec.out_dir:
        return rec.out_dir
    return os.environ.get("MPISPPY_TPU_TELEMETRY_DIR") or None


def merge_run_traces(tdir):
    """Persist this process's trace, then merge every process's trace
    in ``tdir`` onto one wall-clock timeline (``trace_merged.json``).
    Returns its path, or None. A failed merge is reported, never
    raised: diagnostics must not kill a finished run."""
    obs.flush()
    from ..obs.merge import merge_traces
    try:
        merged = merge_traces(tdir)
        if merged:
            global_toc(f"telemetry: merged multi-process trace -> "
                       f"{merged}")
        return merged
    except Exception as e:
        global_toc(f"telemetry: trace merge failed: {e!r}")
        return None


class SpokeProxy:
    """Hub-side stand-in for a spoke living in another process: the
    classification surface and the shared window pair."""

    def __init__(self, spoke_cls, S, K, hub_window, my_window):
        self._spoke_cls = spoke_cls
        self.converger_spoke_types = spoke_cls.converger_spoke_types
        self.converger_spoke_char = spoke_cls.converger_spoke_char
        self.is_cut_spoke = bool(getattr(spoke_cls, "is_cut_spoke", False))
        self._S, self._K = S, K
        self.hub_window = hub_window
        self.my_window = my_window

    def hub_read_layout(self):
        ts = self.converger_spoke_types
        return (ConvergerSpokeType.W_GETTER in ts,
                ConvergerSpokeType.NONANT_GETTER in ts)

    def remote_window_length(self) -> int:
        has_w, has_x = self.hub_read_layout()
        return self._S * self._K * (int(has_w) + int(has_x))

    def local_window_length(self) -> int:
        # the spoke class owns its payload layout; every spoke-to-hub
        # window carries the bound-flow lineage suffix
        return self._spoke_cls.payload_length(self._S, self._K) \
            + LINEAGE_SLOTS


def _spoke_worker(cfg_dict, spoke_cfg_dict, hub_name, my_name,
                  telemetry=None):
    """Runs in the child process: build the engine from the config on
    the config's device, wire the shared windows, send the startup
    hello and loop until the hub's kill signal. ``telemetry`` ({out_dir,
    role}) opens this process's own session under its role."""
    import numpy as np

    if telemetry and telemetry.get("out_dir"):
        obs.configure(out_dir=telemetry["out_dir"],
                      role=telemetry.get("role"), config=spoke_cfg_dict)
    elif telemetry:
        obs.maybe_configure_from_env(role=telemetry.get("role"))

    from .config import SpokeConfig
    from .vanilla import spoke_dict

    cfg = config_from_dict(cfg_dict)
    sd = spoke_dict(cfg, SpokeConfig(**spoke_cfg_dict))
    opt = sd["opt_class"](**sd["opt_kwargs"])
    spoke = sd["spoke_class"](opt, **sd.get("spoke_kwargs", {}))
    spoke.hub_window = Window.shared(hub_name,
                                     spoke.remote_window_length(),
                                     create=False)
    spoke.my_window = Window.shared(my_name, spoke.local_window_length(),
                                    create=False)
    # fault injection (testing/faults.py) is gated on an EXPLICIT plan
    # (spoke option or env var): the import — and every wrapper it
    # installs — exists only in faulted test children, never on the
    # production path (the clean path imports nothing of testing/)
    fault_spec = (spoke_cfg_dict.get("options") or {}).get("fault_plan") \
        or os.environ.get("MPISPPY_TPU_FAULT_PLAN")
    if fault_spec:
        from ..testing.faults import FaultInjector
        injector = FaultInjector.from_spec(
            fault_spec,
            index=(telemetry or {}).get("index", 0),
            gen=(telemetry or {}).get("gen", 0))
        injector.sleep_before_hello()
        injector.install(spoke)
    # startup handshake: a NaN hello tells the hub this spoke is wired
    # and looping (ref. hub.py:285-308); NaN never wins a bound
    # comparison, so the hub consumes it harmlessly
    spoke.my_window.put(np.full(spoke.local_window_length(), np.nan))
    try:
        # warm resume (ckpt/): a spoke handed a ``resume_state`` option
        # re-publishes its checkpointed best bound as its FIRST publish
        # — after the hello (the hub's readiness gate) and before
        # main() recomputes anything, so a respawned incarnation's
        # first bound is never worse than its predecessor's best
        spoke.resume_publish()
        spoke.main()
        spoke.finalize()
    finally:
        # flush + close this process's telemetry BEFORE the windows
        # drop, so the hub's merge right after the join sees complete
        # role artifacts
        obs.shutdown()
        spoke.hub_window.close(unlink=False)
        spoke.my_window.close(unlink=False)


def _spoke_window_names(run_id, i, gen=0):
    """THE window naming scheme (creator and opener must agree).
    ``gen`` > 0 names a respawned incarnation's FRESH pair: a dead
    generation's windows are never reused (a crashed writer may have
    died mid-seqlock); the launcher unlinks them at teardown."""
    suffix = f"r{gen}" if gen else ""
    return f"{run_id}h{i}{suffix}", f"{run_id}s{i}{suffix}"


def _spoke_proxy(kind, run_id, i, S, K, create, gen=0):
    """One spoke's proxy with its window pair, on either side of the
    handshake (create=True: the wheel launcher; False: a consumer in
    another process, the sharded-APH hub shard)."""
    from .vanilla import spoke_classes

    spoke_cls, _ = spoke_classes(kind)
    hub_name, my_name = _spoke_window_names(run_id, i, gen)
    proxy = SpokeProxy(spoke_cls, S, K, None, None)
    proxy.hub_window = Window.shared(
        hub_name, proxy.remote_window_length(), create=create)
    proxy.my_window = Window.shared(
        my_name, proxy.local_window_length(), create=create)
    return proxy


def open_spoke_proxies(spoke_kinds, run_id, S, K):
    """Open (create=False) the window pairs spawn_spoke_processes
    created: the consumer side of the one naming scheme."""
    return [_spoke_proxy(kind, run_id, i, S, K, create=False)
            for i, kind in enumerate(spoke_kinds)]


def _spawn_one_spoke(cfg: RunConfig, i, run_id, ctx, S, K, gen=0):
    """Window pair and worker process for ONE spoke (generation
    ``gen``): the spawn body of the first launch and of the
    supervisor's respawns alike."""
    from dataclasses import asdict

    sp = cfg.spokes[i]
    proxy = _spoke_proxy(sp.kind, run_id, i, S, K, create=True, gen=gen)
    sp_dict = asdict(sp)
    if cfg.checkpoint_dir or cfg.resume_from:
        # checkpoint/resume wiring (ckpt/): where this incarnation
        # WRITES its warm state, and — for respawns (gen > 0, the
        # supervisor path) or a --resume-from launch — the state file
        # it resumes FROM: generation N starts from the freshest state
        # generation N-1 persisted
        from ..ckpt.spoke_state import spoke_resume_options
        for k, v in spoke_resume_options(
                cfg.checkpoint_dir, cfg.resume_from, i, sp.kind,
                gen=gen).items():
            sp_dict["options"].setdefault(k, v)
    # each child captures into the shared run dir under its own role,
    # so artifacts never clobber; a respawned incarnation gets a
    # gen-suffixed role so the dead child's events survive beside it.
    # The index and generation key the child's fault plan.
    telemetry = {"out_dir": _telemetry_out_dir(cfg),
                 "role": f"spoke{i}-{sp.kind}" + (f"-r{gen}" if gen
                                                  else ""),
                 "index": i, "gen": gen}
    p = ctx.Process(target=_spoke_worker,
                    args=(cfg.to_dict(), sp_dict,
                          *_spoke_window_names(run_id, i, gen), telemetry),
                    daemon=True)
    p.start()
    return proxy, p


def spawn_spoke_processes(cfg: RunConfig, run_id, ctx, S, K):
    """The window pair and worker process of every spoke in ``cfg``
    (window names ``{run_id}h{i}`` / ``{run_id}s{i}``). Returns
    (proxies, procs, owned_windows); the caller owns the windows'
    unlink and the processes' joins."""
    proxies, procs, owned = [], [], []
    for i in range(len(cfg.spokes)):
        proxy, p = _spawn_one_spoke(cfg, i, run_id, ctx, S, K)
        owned += [proxy.hub_window, proxy.my_window]
        proxies.append(proxy)
        procs.append(p)
    return proxies, procs, owned


def wait_spoke_hellos(cfg: RunConfig, proxies, procs, timeout, hub=None):
    """Block until every spoke's startup hello lands, so gap-based
    termination cannot fire before cold-starting spoke processes have
    joined the wheel. With ``hub`` given, a fired wheel watchdog aborts
    the wait."""
    deadline = time.monotonic() + timeout
    for i, proxy in enumerate(proxies):
        while proxy.my_window.read_id() == 0:
            if hub is not None and hub._watchdog_fired:
                raise TimeoutError(
                    "wheel deadline fired while waiting for spoke "
                    f"hellos (spoke {cfg.spokes[i].kind} still silent)")
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"spoke {cfg.spokes[i].kind} (pid {procs[i].pid}) "
                    "never sent its startup hello")
            if not procs[i].is_alive():
                raise RuntimeError(
                    f"spoke {cfg.spokes[i].kind} died during startup")
            time.sleep(0.05)


def reap(procs, timeout=10.0):
    """Terminate and join every live process of ``procs``."""
    for p in procs:
        if p.is_alive():
            p.terminate()
    for p in procs:
        p.join(timeout=timeout)
        if p.is_alive():
            p.kill()
            p.join(timeout=timeout)


def spin_the_wheel_processes(cfg: RunConfig, join_timeout=None,
                             spoke_ready_timeout=None):
    """One hub (this process) plus one OS process per spoke. Returns the
    hub after termination; ``hub._spoke_last_ids`` counts consumed
    updates (1 is the startup hello; more means bound traffic).

    The hub waits up to ``spoke_ready_timeout`` for every spoke's hello
    before iterating. Both timeouts default from the config
    (``cfg.join_timeout`` / ``cfg.spoke_ready_timeout``)."""
    from .vanilla import _not_ported, hub_dict, mesh_ranks, \
        refuse_unported

    cfg.validate()
    refuse_unported(cfg)
    if mesh_ranks(cfg, warn=False) > 1:
        raise _not_ported("a sharded hub engine in the process wheels",
                          "A8b")
    if cfg.algo.scenario_source != "resident":
        raise _not_ported("a streamed or synthesized scenario source in "
                          "the process wheels", "A8b")
    join_timeout = cfg.join_timeout if join_timeout is None \
        else join_timeout
    spoke_ready_timeout = cfg.spoke_ready_timeout \
        if spoke_ready_timeout is None else spoke_ready_timeout

    # a config-carried telemetry dir opens the hub's session too
    # (programmatic callers bypass __main__.run): the hub's own
    # artifacts must land beside the spokes' for the merge
    if cfg.telemetry_dir and not obs.enabled():
        obs.configure(out_dir=cfg.telemetry_dir, config=cfg.to_dict())
    hub_d = hub_dict(cfg)
    hub_opt = hub_d["opt_class"](**hub_d["opt_kwargs"])
    S, K = hub_opt._S_orig, hub_opt.batch.K
    run_id = f"/spw{os.getpid():x}{secrets.token_hex(4)}"

    ctx = mp.get_context("spawn")
    procs, owned = [], []
    supervisor = None
    prev_sigterm = None
    try:
        proxies, procs, owned = spawn_spoke_processes(cfg, run_id, ctx,
                                                      S, K)
        hub = hub_d["hub_class"](hub_opt, spokes=proxies,
                                 **hub_d.get("hub_kwargs", {}))
        hub.classify_spokes()
        hub.windows_made = True
        hub.setup_hub()
        from ..cylinders.supervisor import WheelSupervisor

        def _respawner(i, gen):
            return _spawn_one_spoke(cfg, i, run_id, ctx, S, K, gen=gen)

        supervisor = WheelSupervisor(
            proxies, procs, kinds=[sp.kind for sp in cfg.spokes],
            options=cfg.supervisor, respawner=_respawner, owned=owned)
        supervisor.attach(hub)
        if cfg.wheel_deadline:
            supervisor.start_watchdog(cfg.wheel_deadline)
        # deterministic hub-side faults (testing/faults.py): the
        # harness can preempt (SIGTERM) or crash the HUB process at a
        # named iteration, the way spoke plans crash spokes. Imported
        # only under the env var: the clean path imports nothing of
        # testing/.
        hub_fault_spec = os.environ.get("MPISPPY_TPU_FAULT_PLAN")
        if hub_fault_spec:
            from ..testing.faults import install_hub_faults
            install_hub_faults(hub, hub_fault_spec)
        # the preemption notice path (doc/fault_tolerance.md): with
        # checkpointing armed, SIGTERM forces one final bundle +
        # nonblocking telemetry flush + clean terminate instead of
        # losing the whole optimization state. Handler restored on
        # every exit path (outermost finally).
        if cfg.checkpoint_dir:
            from .sputils import install_preemption_handler
            prev_sigterm = install_preemption_handler(hub)
        wait_spoke_hellos(cfg, proxies, procs, spoke_ready_timeout,
                          hub=hub)
        try:
            hub.main()
        finally:
            # no respawns once termination starts; then release the
            # spokes, or the children poll windows the cleanup unlinks
            supervisor.shutdown()
            hub.send_terminate()
            for p in procs:
                p.join(timeout=join_timeout)
                if p.is_alive():
                    global_toc(f"multiproc: spoke pid {p.pid} missed the "
                               "join timeout; terminating")
                    p.terminate()
        hub.receive_bounds()
        hub.hub_finalize()
        tdir = _telemetry_out_dir(cfg)
        if tdir:
            # every child flushed its role artifacts before its join
            # returned: one wall-clock-aligned timeline of all processes
            merge_run_traces(tdir)
        return hub
    except BaseException:
        # startup-failure cleanup: a hello timeout (or any raise before
        # the normal terminate/join path) must not leak live children
        if supervisor is not None:
            supervisor.shutdown()
        reap(procs)
        if 'hub' in locals():
            hub.shutdown_live()
        raise
    finally:
        if prev_sigterm is not None:
            signal.signal(signal.SIGTERM, prev_sigterm)
        for w in owned:
            w.close(unlink=True)
