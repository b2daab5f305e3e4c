"""Typed, validated configuration tree — the baseparsers/PHoptions analog
(the port's copy of the JAX package's utils/config.py, with the port's
kernel backends and a ``device`` field).

The reference stacks three stringly layers with NO unknown-key checking
(PHoptions dicts + argparse builders + vanilla, ref. utils/baseparsers.py
:11-451, doc/src/drivers.rst:80-86 "design choice"). SURVEY §5.6 calls for
one typed validated tree instead; this is it. The three reference roles
survive as three dataclasses:

  AlgoConfig   — engine options (PHoptions analog, ref. phbase.py:1240
                 options_check keys)
  SpokeConfig  — one cylinder beyond the hub (vanilla's *_spoke dicts)
  RunConfig    — the whole run: model family + algo + hub + spokes
                 (the drivers' argparse surface, baseparsers.py:11-132)

``RunConfig.validate()`` rejects unknown model names, non-positive
scenario counts, unknown spoke kinds, and contradictory termination
settings — errors the reference only surfaces as mid-run KeyErrors.
"""

from __future__ import annotations

from dataclasses import dataclass, field, asdict

KNOWN_MODELS = ("farmer", "sizes", "sslp", "netdes", "hydro", "uc",
                "battery", "ccopf")
# subproblem kernel-backend selection (ops/kernels). Defined HERE (not
# in ops.kernels) so validation never imports torch's kernel layer;
# ops.kernels imports these as its single source of truth.
KERNEL_MODES = ("auto", "fused", "segmented")
# "cuda" is the hand-written Hopper ADMM block (ops/kernels/admm_block);
# "pallas" is accepted as an alias of "cuda" so the JAX package's option
# dicts run unchanged against the port
KERNEL_BACKENDS = ("reference", "cuda", "pallas")
KERNEL_BACKEND_ALIASES = {"pallas": "cuda"}
# the df32 tail's L⁻¹ trade (ops/kernels/reference.l_inv_profitable)
# and the bulk phase's packed-block storage: the JAX package's values,
# of which the port runs f32 only ("bf16" raises, ROADMAP.md A4r)
KERNEL_L_INV_MODES = ("auto", "on", "off")
KERNEL_BLOCK_DTYPES = ("auto", "bf16", "f32")
# the fused program unrolls the df32 IR sweeps statically (and the
# pallas block bakes them into its instruction stream): sweep counts
# outside this band must fail HERE as a config error, not as a deep
# trace explosion inside the fused jit (ISSUE 7 small fix)
FUSED_IR_SWEEPS = range(1, 5)


def canonical_backend(name: str) -> str:
    """The backend a (possibly aliased) option value selects."""
    return KERNEL_BACKEND_ALIASES.get(name, name)


KNOWN_SPOKES = ("lagrangian", "lagranger", "xhatshuffle", "xhatlooper",
                "xhatspecific", "xhatlshaped", "fwph", "slamup",
                "slamdown", "cross_scenario", "efmip", "dive")
# incumbent source policy for the x̂ / dive spokes (doc/incumbents.md):
# "device" = batched on-device pool/dive only (host OraclePool never
# constructed), "oracle" = host-oracle sources only, "auto" = device
# sources with the oracle as the opt-in fallback/polish. Defined HERE
# (jax-free) like the kernel constants: cylinder validation and the
# CLI both read it.
INCUMBENT_MODES = ("device", "oracle", "auto")
# scenario-source selection for the chunked hot loop (mpisppy_tpu/
# stream, doc/streaming.md): "resident" = full-width device arrays
# (today's path), "streamed" = host store + double-buffered H2D chunk
# pipeline, "synthesized" = device-side seeded generation for
# randomness-in-rhs families. Defined HERE (jax-free) like the kernel
# constants: engine validation, the CLI, and the serve payload
# whitelist all read one tuple.
STREAM_SOURCES = ("resident", "streamed", "synthesized")
KNOWN_HUBS = ("ph", "aph", "lshaped")


def parse_shrink_buckets(spec) -> tuple:
    """``shrink_buckets`` knob -> strictly increasing fractions in
    (0, 1). Accepts the CLI's comma-separated string or any iterable
    of numbers. Defined HERE (jax-free) like the kernel constants:
    AlgoConfig validation, the serve payload whitelist, and the
    jax-touching ops/shrink module all read one parser."""
    if isinstance(spec, str):
        parts = [p for p in (s.strip() for s in spec.split(",")) if p]
        vals = tuple(float(p) for p in parts)
    else:
        vals = tuple(float(v) for v in spec)
    if not vals:
        raise ValueError("shrink_buckets must name at least one "
                         "threshold fraction")
    if any(not (0.0 < v < 1.0) for v in vals):
        raise ValueError(f"shrink_buckets fractions must lie in (0, 1); "
                         f"got {vals}")
    if list(vals) != sorted(set(vals)):
        raise ValueError(f"shrink_buckets must be strictly increasing; "
                         f"got {vals}")
    return vals


@dataclass
class AlgoConfig:
    """Engine options (the PHoptions analog)."""
    default_rho: float = 1.0
    max_iterations: int = 100
    convthresh: float = 1e-4
    # keep in sync with PHBase's own defaults (core/ph.py) so a CLI run
    # with no flags matches a programmatic run with no options
    subproblem_max_iter: int = 5000
    subproblem_eps: float = 1e-8
    subproblem_polish_chunk: int = 0
    # df32 x-update iterative-refinement sweeps (ops/qp_solver
    # ._m_solve_ir); validated against the kernel mode below
    subproblem_ir_sweeps: int = 1
    # kernel-backend selection (ops/kernels, doc/kernels.md):
    # "segmented" = today's host-segmented drivers bit-for-bit,
    # "fused" = one device program per solve, "auto" = fused wherever
    # the solve is eligible (the default)
    subproblem_kernel_mode: str = "auto"
    # the port's run default is its hand-written block ("cuda"; the JAX
    # package's default is "reference"): solves outside the block's
    # scope (a batched A, mixed/df32) take the reference backend
    subproblem_kernel_backend: str = "cuda"
    subproblem_kernel_l_inv: str = "auto"       # explicit L⁻¹ matmuls
    subproblem_kernel_block_dtype: str = "auto"  # bf16 packed blocks
    # pipelined chunk dispatch (doc/pipelining.md): pre-assembled
    # chunks + fused quality-gate sync + donated warm starts; 0 opts
    # back into the strictly sequential debug loop
    subproblem_pipeline: int = 1
    # ---- progressive problem shrinking (ops/shrink, doc/extensions.md
    # §shrinking): device-side WW fixing counters, active-set
    # compaction, per-slot adaptive rho ----
    shrink_fix: bool = False        # jitted per-var convergence counters
    shrink_fix_iters: int = 3       # consecutive converged iterations
    shrink_fix_tol: float = 1e-4    # variance-test tolerance
    shrink_compact: bool = False    # active-set compaction at bucket
    #                                 thresholds (requires shrink_fix)
    shrink_buckets: str = "0.25,0.5,0.75"   # fixed-fraction thresholds
    shrink_rho: bool = False        # per-slot device-side adaptive rho
    shrink_rho_interval: int = 1    # iterations between rho updates
    shrink_transplant: bool = True  # warm-state transplant across
    #                                 bucket transitions (iterates-only
    #                                 free-slot gather; False = the old
    #                                 cold-rebuild spelling)
    # ---- scenario streaming (mpisppy_tpu/stream, doc/streaming.md):
    # per-chunk staging of the per-scenario vector blocks instead of
    # full-width HBM residency ----
    scenario_source: str = "resident"   # STREAM_SOURCES
    stream_int8: bool = False       # int8 delta-packed host storage
    #                                 (explicit opt-in, host-side gate)
    stream_int8_tol: float = 1e-3   # gate: max per-entry recon error
    stream_depth: int = 2           # prefetch pipeline double-buffer
    # ---- APH φ-dispatch (core/aph.py + ops/dispatch.py, doc/aph.md):
    # fraction of scenarios solved per iteration (most-negative-φ first,
    # least-recently-dispatched fill; ref. aph.py dispatch_frac) plus
    # the ν/γ projective-step parameters. 1.0 = full dispatch (every
    # scenario solves; bit-identical to the pre-dispatch engine) ----
    dispatch_frac: float = 1.0      # ∈ (0, 1]; partial needs hub="aph"
    aph_nu: float = 1.0             # APHnu: step scale θ = ν·φ/τ
    aph_gamma: float = 1.0          # APHgamma: z-update damping
    linearize_proximal_terms: bool = False   # accepted + ignored (see ph.py)
    verbose: bool = False

    def to_options(self) -> dict:
        return {
            "defaultPHrho": self.default_rho,
            "PHIterLimit": self.max_iterations,
            "convthresh": self.convthresh,
            "subproblem_max_iter": self.subproblem_max_iter,
            "subproblem_eps": self.subproblem_eps,
            "subproblem_polish_chunk": self.subproblem_polish_chunk,
            "subproblem_ir_sweeps": self.subproblem_ir_sweeps,
            "subproblem_kernel_mode": self.subproblem_kernel_mode,
            "subproblem_kernel_backend": self.subproblem_kernel_backend,
            "subproblem_kernel_l_inv": self.subproblem_kernel_l_inv,
            "subproblem_kernel_block_dtype":
                self.subproblem_kernel_block_dtype,
            "subproblem_pipeline": self.subproblem_pipeline,
            # shrink_* knobs ride to_options() so they reach the engine
            # AND the serve bucket fingerprint (serve/batch.bucket_key
            # hashes algo.to_options(): shrink-enabled and
            # shrink-disabled requests never share a leased engine)
            "shrink_fix": self.shrink_fix,
            "shrink_fix_iters": self.shrink_fix_iters,
            "shrink_fix_tol": self.shrink_fix_tol,
            "shrink_compact": self.shrink_compact,
            "shrink_buckets": self.shrink_buckets,
            "shrink_rho": self.shrink_rho,
            "shrink_rho_interval": self.shrink_rho_interval,
            "shrink_transplant": self.shrink_transplant,
            # stream knobs ride to_options() so they reach the engine
            # AND the serve bucket fingerprint (a streamed engine's
            # surrogate qp_data and host store must never be leased to
            # a resident-source request, and int8-packed data is a
            # different numerical contract than exact storage)
            "scenario_source": self.scenario_source,
            "stream_int8": self.stream_int8,
            "stream_int8_tol": self.stream_int8_tol,
            "stream_depth": self.stream_depth,
            # APH knobs ride to_options() under the reference's names so
            # they reach the engine AND the serve bucket fingerprint (a
            # partial-dispatch APH engine compiles dispatch-width
            # buckets a full-dispatch engine never sees — the leases
            # must not mix)
            "dispatch_frac": self.dispatch_frac,
            "APHnu": self.aph_nu,
            "APHgamma": self.aph_gamma,
            "verbose": self.verbose,
        }

    def validate(self):
        if self.default_rho <= 0:
            raise ValueError("default_rho must be positive")
        if self.max_iterations < 0:
            raise ValueError("max_iterations must be >= 0")
        if self.subproblem_max_iter <= 0:
            raise ValueError("subproblem_max_iter must be positive")
        if self.subproblem_ir_sweeps < 1:
            raise ValueError("subproblem_ir_sweeps must be >= 1")
        if self.subproblem_kernel_mode not in KERNEL_MODES:
            raise ValueError(
                f"unknown subproblem_kernel_mode "
                f"{self.subproblem_kernel_mode!r}; known: {KERNEL_MODES}")
        if self.subproblem_kernel_backend not in KERNEL_BACKENDS:
            raise ValueError(
                f"unknown subproblem_kernel_backend "
                f"{self.subproblem_kernel_backend!r}; known: "
                f"{KERNEL_BACKENDS}")
        if self.subproblem_kernel_l_inv not in KERNEL_L_INV_MODES:
            raise ValueError(
                f"unknown subproblem_kernel_l_inv "
                f"{self.subproblem_kernel_l_inv!r}; known: "
                f"{KERNEL_L_INV_MODES}")
        if self.subproblem_kernel_block_dtype not in KERNEL_BLOCK_DTYPES:
            raise ValueError(
                f"unknown subproblem_kernel_block_dtype "
                f"{self.subproblem_kernel_block_dtype!r}; known: "
                f"{KERNEL_BLOCK_DTYPES}")
        if self.shrink_fix_iters < 1:
            raise ValueError("shrink_fix_iters must be >= 1")
        if self.shrink_fix_tol <= 0:
            raise ValueError("shrink_fix_tol must be positive")
        if self.shrink_rho_interval < 1:
            raise ValueError("shrink_rho_interval must be >= 1")
        if self.shrink_compact and not self.shrink_fix:
            raise ValueError("shrink_compact needs shrink_fix (the "
                             "compaction triggers on the device fixer's "
                             "fixed-fraction trajectory)")
        parse_shrink_buckets(self.shrink_buckets)
        if self.scenario_source not in STREAM_SOURCES:
            raise ValueError(
                f"unknown scenario_source {self.scenario_source!r}; "
                f"known: {STREAM_SOURCES}")
        if self.stream_int8 and self.scenario_source != "streamed":
            raise ValueError(
                "stream_int8 packs the STREAMED host store — it needs "
                "scenario_source='streamed' (synthesized sources ship "
                "nothing; resident arrays are not packed)")
        if self.stream_int8_tol <= 0:
            raise ValueError("stream_int8_tol must be positive")
        if self.stream_depth < 1:
            raise ValueError("stream_depth must be >= 1")
        if not (0.0 < self.dispatch_frac <= 1.0):
            raise ValueError(f"dispatch_frac must lie in (0, 1]; got "
                             f"{self.dispatch_frac}")
        if self.aph_nu <= 0:
            raise ValueError("aph_nu must be positive (θ = ν·φ/τ)")
        if self.aph_gamma <= 0:
            raise ValueError("aph_gamma must be positive (z-update "
                             "damping γ)")
        if self.scenario_source == "synthesized" and self.shrink_compact:
            raise ValueError(
                "shrink_compact cannot run over a SYNTHESIZED scenario "
                "source (the generator manufactures full-width blocks "
                "in-kernel; there is no host store to re-block at the "
                "compacted width — streamed sources compose, and the "
                "device fixer alone — shrink_fix — composes with "
                "everything)")
        # the combined rule (ISSUE 7 small fix): an explicitly-fused
        # kernel unrolls the IR sweeps statically — out-of-band counts
        # must fail here with a clear error, not as a deep jit failure.
        # "auto" instead falls back to segmented (ops/kernels.prepare).
        if self.subproblem_kernel_mode == "fused" \
                and self.subproblem_ir_sweeps not in FUSED_IR_SWEEPS:
            raise ValueError(
                f"subproblem_kernel_mode='fused' supports "
                f"subproblem_ir_sweeps in "
                f"[{FUSED_IR_SWEEPS.start}, {FUSED_IR_SWEEPS.stop - 1}] "
                f"(the fused program unrolls the sweeps statically); "
                f"got {self.subproblem_ir_sweeps}. Use "
                f"subproblem_kernel_mode='segmented' for larger sweep "
                f"counts.")


@dataclass
class SpokeConfig:
    """One spoke cylinder (vanilla's *_spoke dict analog,
    ref. utils/vanilla.py:95-408)."""
    kind: str
    options: dict = field(default_factory=dict)

    def validate(self):
        if self.kind not in KNOWN_SPOKES:
            raise ValueError(f"unknown spoke kind {self.kind!r}; "
                             f"known: {KNOWN_SPOKES}")


@dataclass
class RunConfig:
    """A full cylinder run (the driver-script surface)."""
    model: str = "farmer"
    num_scens: int = 3
    model_kwargs: dict = field(default_factory=dict)
    num_bundles: int = 0             # 0 = no bundling
    hub: str = "ph"
    algo: AlgoConfig = field(default_factory=AlgoConfig)
    hub_options: dict = field(default_factory=dict)  # hub-engine overrides
    spokes: list = field(default_factory=list)   # list[SpokeConfig]
    rel_gap: float | None = None
    abs_gap: float | None = None
    # run-level incumbent source policy (INCUMBENT_MODES above): seeds
    # every inner-bound spoke's ``incumbent_mode`` option (per-spoke
    # options win). None keeps each spoke's own default ("auto"; the
    # dive spoke defaults to "device").
    incumbent_mode: str | None = None
    solve_ef: bool = False           # solve the EF instead of a wheel
    ef_integer: bool = False
    trace_prefix: str | None = None
    # telemetry output directory (telemetry files): when set, the run
    # writes events.jsonl + trace.json + metrics.json there and the
    # config snapshot lands in the stream's run_header
    telemetry_dir: str | None = None
    # ---- live plane (obs/live.py, doc/observability.md) ----
    # in-run status server owned by the hub process: /metrics
    # (Prometheus text exposition of the Recorder registry) + /status
    # (JSON wheel state). None = off; 0 = bind an ephemeral port.
    # live.json rides telemetry_dir and needs no port. The bind host
    # defaults to LOOPBACK — the endpoints serve full run state with
    # no auth; "0.0.0.0" is the explicit opt-in for remote scrapers.
    status_port: int | None = None
    status_host: str = "127.0.0.1"
    # ---- robustness (doc/fault_tolerance.md) ----
    # wheel watchdog: terminate a wheel that outlives this many seconds
    # (telemetry flushed, partial bounds reported); None = no deadline
    wheel_deadline: float | None = None
    # spoke kill-poll cadence (None = the SPOKE_SLEEP_TIME module
    # default) and the process-wheel handshake/join deadlines — typed
    # config instead of module-constant monkeypatching, so fault tests
    # can run fast scenarios
    spoke_sleep_time: float | None = None
    spoke_ready_timeout: float = 300.0
    join_timeout: float = 120.0
    # WheelSupervisor options (cylinders/supervisor.KNOWN_OPTIONS):
    # heartbeat_timeout, max_respawns, respawn_backoff(+_cap),
    # max_rejections, poll_interval, crossed_bound_tol
    supervisor: dict = field(default_factory=dict)
    # ---- durable checkpoints + resume (the checkpoint layer) ----
    # checkpoint_dir arms hub-owned run-state bundles (periodic from
    # the termination-check path; forced on watchdog fire and SIGTERM
    # — the preemption notice), per-spoke warm-state files the
    # supervisor hands back to respawned incarnations, and LATEST/
    # retention bookkeeping. resume_from relaunches the wheel from a
    # bundle (or a checkpoint dir, resolved through LATEST); a
    # corrupt/mismatched bundle falls back to cold start with a
    # reasoned event, never a crash (doc/fault_tolerance.md).
    checkpoint_dir: str | None = None
    checkpoint_interval: float = 30.0
    checkpoint_keep: int = 3
    resume_from: str | None = None
    # ---- scenario-axis sharding (doc/sharding.md) ----
    # mesh over the local (or, with ``coordinator``, global) device
    # set for the hub engine: None = single-device; 0 = all devices;
    # n > 0 = the first n. The engine shards every per-scenario tensor
    # over the mesh's "scen" axis and runs the PH step SPMD.
    mesh_devices: int | None = None
    # multi-process JAX over DCN (jax.distributed.initialize), so the
    # supervised process wheel spans hosts: {"address": "host:port",
    # "num_processes": N, "process_id": I, "local_device_ids": [...]}
    # — every field but ``address`` optional (TPU pods self-discover).
    coordinator: dict | None = None
    # the port's device for every engine of the run: None = the CUDA
    # device (raises without one), "cpu" runs on the CPU
    # (utils/runtime.resolve_device)
    device: str | None = None

    def validate(self):
        if self.model not in KNOWN_MODELS:
            raise ValueError(f"unknown model {self.model!r}; "
                             f"known: {KNOWN_MODELS}")
        if self.num_scens <= 0:
            raise ValueError("num_scens must be positive")
        if self.hub not in KNOWN_HUBS:
            raise ValueError(f"unknown hub {self.hub!r}; known: "
                             f"{KNOWN_HUBS}")
        if self.num_bundles:
            if self.num_scens % self.num_bundles != 0:
                raise ValueError("num_bundles must divide num_scens")
        if self.rel_gap is not None and not (0 <= self.rel_gap):
            raise ValueError("rel_gap must be >= 0")
        if self.abs_gap is not None and not (0 <= self.abs_gap):
            raise ValueError("abs_gap must be >= 0")
        if self.wheel_deadline is not None and self.wheel_deadline <= 0:
            raise ValueError("wheel_deadline must be positive")
        if self.incumbent_mode is not None \
                and self.incumbent_mode not in INCUMBENT_MODES:
            raise ValueError(
                f"unknown incumbent_mode {self.incumbent_mode!r}; "
                f"known: {INCUMBENT_MODES}")
        if self.status_port is not None \
                and not (0 <= int(self.status_port) <= 65535):
            raise ValueError("status_port must be in [0, 65535] "
                             "(0 = ephemeral) or None (off)")
        if self.spoke_sleep_time is not None and self.spoke_sleep_time < 0:
            raise ValueError("spoke_sleep_time must be >= 0")
        if self.spoke_ready_timeout <= 0 or self.join_timeout <= 0:
            raise ValueError("spoke_ready_timeout and join_timeout must "
                             "be positive")
        if self.checkpoint_interval <= 0:
            raise ValueError("checkpoint_interval must be positive "
                             "(seconds between periodic bundles)")
        if self.checkpoint_keep < 1:
            raise ValueError("checkpoint_keep must be >= 1")
        from ..cylinders.supervisor import KNOWN_OPTIONS
        bad = set(self.supervisor) - set(KNOWN_OPTIONS)
        if bad:
            raise ValueError(f"unknown supervisor options {sorted(bad)}; "
                             f"known: {sorted(KNOWN_OPTIONS)}")
        if self.mesh_devices is not None and self.mesh_devices < 0:
            raise ValueError("mesh_devices must be None (no mesh), 0 "
                             "(all devices), or a positive count")
        if self.coordinator is not None:
            known = {"address", "num_processes", "process_id",
                     "local_device_ids"}
            bad = set(self.coordinator) - known
            if bad:
                raise ValueError(f"unknown coordinator keys {sorted(bad)};"
                                 f" known: {sorted(known)}")
            if not self.coordinator.get("address"):
                raise ValueError("coordinator needs an 'address' "
                                 "(\"host:port\" of process 0)")
            for k in ("num_processes", "process_id"):
                v = self.coordinator.get(k)
                if v is not None and int(v) < 0:
                    raise ValueError(f"coordinator.{k} must be >= 0")
        self.algo.validate()
        if self.algo.dispatch_frac < 1.0 and self.hub != "aph":
            raise ValueError(
                "dispatch_frac < 1 is φ-based partial dispatch — only "
                "the APH hub scores φ and can skip solves (hub='aph'); "
                "synchronous PH must solve every scenario each iteration")
        for sp in self.spokes:
            sp.validate()
        if self.hub == "lshaped" and any(
                sp.kind == "fwph" for sp in self.spokes):
            raise ValueError("fwph spoke expects a PH-family hub")
        if self.hub != "ph" and any(
                sp.kind == "cross_scenario" for sp in self.spokes):
            raise ValueError("cross_scenario cuts require the 'ph' hub "
                             "(only CrossScenarioHub consumes cut windows)")
        return self

    def to_dict(self) -> dict:
        return asdict(self)


@dataclass
class ServeConfig:
    """The serving layer's surface (``python -m mpisppy_tpu_torch
    serve``, serve/). Like the rest of this module it needs no device:
    the HTTP/queue plane validates it without one.
    """
    state_dir: str = ""
    host: str = "127.0.0.1"          # loopback default, like status_host
    port: int = 8765                 # 0 = ephemeral (serve.json records it)
    # wheel workers: concurrent wheels; same-bucket wheels additionally
    # serialize on the warm engine lease (serve/cache)
    max_wheels: int = 1
    queue_limit: int = 64            # bounded admission (full = 429)
    # scenario-axis batcher: wait up to batch_window seconds for
    # same-bucket stragglers, stack at most batch_max requests into one
    # wheel (1 disables coalescing)
    batch_window: float = 0.25
    batch_max: int = 8
    cache_buckets: int = 8           # warm-cache LRU capacity
    checkpoint_interval: float = 5.0  # per-wheel bundle cadence
    default_deadline: float | None = None   # per-request SLO seconds
    # terminal request records (and their ckpt namespaces + stale
    # group files) are swept at startup once older than this — the
    # request-store twin of checkpoint_keep retention. Results remain
    # durable for the whole window; a production service must not
    # accrete one json per request forever.
    request_retention: float = 7 * 24 * 3600.0
    telemetry_dir: str | None = None
    # fleet (serve/migrate): peer base URLs this host may hand live
    # wheels to (empty = solo host, SIGTERM stays bundle-and-exit);
    # per-transfer wall-clock budget + per-call retry attempts for one
    # handoff; and the poison-pill bound — a request re-admitted by
    # startup recovery more than max_recoveries times quarantines
    # (settles failed) instead of crash-looping the service forever.
    peers: tuple = ()
    migrate_deadline: float = 60.0
    migrate_retries: int = 3
    max_recoveries: int = 3
    # the device of every engine the service builds: None = the CUDA
    # device (the service raises without one), "cpu" runs on the CPU
    # (utils/runtime.resolve_device)
    device: str | None = None

    def validate(self):
        if not self.state_dir:
            raise ValueError("serve needs a state_dir (durable request "
                             "records + ckpt bundles live there)")
        if not (0 <= int(self.port) <= 65535):
            raise ValueError("port must be in [0, 65535] (0 = ephemeral)")
        if self.max_wheels < 1:
            raise ValueError("max_wheels must be >= 1")
        if self.queue_limit < 1:
            raise ValueError("queue_limit must be >= 1")
        if self.batch_window < 0:
            raise ValueError("batch_window must be >= 0 seconds")
        if self.batch_max < 1:
            raise ValueError("batch_max must be >= 1")
        if self.cache_buckets < 1:
            raise ValueError("cache_buckets must be >= 1")
        if self.checkpoint_interval <= 0:
            raise ValueError("checkpoint_interval must be positive")
        if self.default_deadline is not None and self.default_deadline <= 0:
            raise ValueError("default_deadline must be positive seconds")
        if self.request_retention <= 0:
            raise ValueError("request_retention must be positive seconds")
        for p in self.peers:
            if not str(p).strip():
                raise ValueError("peers must be non-empty host[:port] "
                                 "or http:// base URLs")
        if self.migrate_deadline <= 0:
            raise ValueError("migrate_deadline must be positive seconds")
        if self.migrate_retries < 1:
            raise ValueError("migrate_retries must be >= 1")
        if self.max_recoveries < 1:
            raise ValueError("max_recoveries must be >= 1")
        if self.device is not None and not str(self.device).strip():
            raise ValueError("device must be None (the CUDA device) or "
                             "a torch device string such as 'cpu'")
        return self

    def to_dict(self) -> dict:
        return asdict(self)


def config_from_dict(d: dict) -> RunConfig:
    """Inverse of RunConfig.to_dict() (for process workers)."""
    d = dict(d)
    d["algo"] = AlgoConfig(**d["algo"])
    d["spokes"] = [SpokeConfig(**s) for s in d["spokes"]]
    return RunConfig(**d)
