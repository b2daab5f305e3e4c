"""Command-line driver: ``python -m mpisppy_tpu_torch <model> [options]``
(the port's twin of the JAX package's ``python -m mpisppy_tpu``).

The baseparsers + driver-script analog (ref. mpisppy/utils/baseparsers.py
:11-451 and examples/*_cylinders.py): one entry point that builds the
validated RunConfig, wires the hub and the requested spokes through
utils.vanilla, and spins the wheel, or with ``--EF`` solves the
extensive form (core/ef.py; ``--EF-integer`` as a MIP) and prints
``{"ef_objective": ...}``. Flag names mirror the JAX package's;
``--device`` picks the engines' device (default: the CUDA device; the
run raises without one unless ``--device cpu`` is given). What the port
does not run yet refuses, naming its ROADMAP.md item: the cross-scenario
spoke. ``serve`` starts the persistent service (serve/: ``python -m
mpisppy_tpu_torch serve --port 0 --state-dir D --device cpu``). ``--checkpoint-dir D`` writes
checkpoint bundles into D and ``--resume-from D`` resumes a wheel from
the newest of them (ckpt/).

``--telemetry-dir D`` (or ``MPISPPY_TPU_TELEMETRY_DIR``) writes the run's
events.jsonl, trace.json, metrics.json and live.json into D, and the
``analyze`` subcommand reads them: ``python -m mpisppy_tpu_torch analyze
D`` (``--json``, ``--compare A B``, ``--watch``); it reads the JAX
package's runs too.

Examples:
  python -m mpisppy_tpu_torch farmer --num-scens 3 --default-rho 1 \\
      --max-iterations 50 --with-lagrangian --with-xhatshuffle --device cpu
  python -m mpisppy_tpu_torch uc --num-scens 10 --default-rho 100 \\
      --with-lagrangian --with-xhatshuffle --rel-gap 0.001
  python -m mpisppy_tpu_torch farmer --hub lshaped --with-xhatlshaped \\
      --device cpu
  python -m mpisppy_tpu_torch sizes --EF --EF-integer --device cpu
  python -m mpisppy_tpu_torch farmer --default-rho 10 --with-fwph \\
      --device cpu
  python -m mpisppy_tpu_torch farmer --num-scens 4 --num-bundles 2 \\
      --with-lagrangian --with-xhatshuffle --device cpu
  python -m mpisppy_tpu_torch farmer --telemetry-dir runs/f1 --device cpu
  python -m mpisppy_tpu_torch analyze runs/f1
"""

from __future__ import annotations

import argparse
import json
import sys

from .utils.config import (AlgoConfig, RunConfig, SpokeConfig, KNOWN_MODELS,
                           KNOWN_SPOKES, KNOWN_HUBS, KERNEL_MODES,
                           INCUMBENT_MODES, STREAM_SOURCES)


def make_parser() -> argparse.ArgumentParser:
    """ref. baseparsers.py:134-168 make_parser + per-spoke *_args packs."""
    p = argparse.ArgumentParser(prog="python -m mpisppy_tpu_torch")
    p.add_argument("model", choices=KNOWN_MODELS)
    p.add_argument("--num-scens", type=int, default=3)
    p.add_argument("--model-kwargs", type=str, default="{}",
                   help="JSON dict forwarded to the scenario creator")
    p.add_argument("--num-bundles", type=int, default=0,
                   help="bundles_per_rank analog (0 = no bundling)")
    p.add_argument("--hub", choices=KNOWN_HUBS, default="ph")
    # algo options (ref. baseparsers.py:11-132)
    p.add_argument("--default-rho", type=float, default=1.0)
    p.add_argument("--max-iterations", type=int, default=100)
    p.add_argument("--convthresh", type=float, default=1e-4)
    p.add_argument("--subproblem-max-iter", type=int, default=5000)
    p.add_argument("--subproblem-eps", type=float, default=1e-8)
    p.add_argument("--subproblem-polish-chunk", type=int, default=0)
    p.add_argument("--subproblem-ir-sweeps", type=int, default=1,
                   help="df32 x-update iterative-refinement sweeps "
                        "(doc/roofline.md §2; fused kernel mode "
                        "supports 1-4)")
    p.add_argument("--subproblem-kernel-mode", choices=KERNEL_MODES,
                   default="auto",
                   help="subproblem kernel backend (doc/kernels.md): "
                        "'segmented' = host-segmented drivers "
                        "bit-for-bit, 'fused' = one device program per "
                        "solve, 'auto' = fused where eligible")
    # progressive problem shrinking (ops/shrink): device fixer,
    # active-set compaction, per-slot rho
    p.add_argument("--shrink-fix", action="store_true",
                   help="device-side WW fixing: per-var convergence "
                        "counters on the device pin converged nonants "
                        "(the host Fixer's test-and-fix, one scalar "
                        "read per iteration)")
    p.add_argument("--shrink-fix-iters", type=int, default=3,
                   help="consecutive converged iterations before a "
                        "nonant slot fixes")
    p.add_argument("--shrink-fix-tol", type=float, default=1e-4,
                   help="variance-test tolerance of the device fixer")
    p.add_argument("--shrink-compact", action="store_true",
                   help="active-set compaction: gather unfixed "
                        "columns (and the rows they touch) into a "
                        "smaller system at bucketed fixed-fraction "
                        "thresholds (one re-factorization per bucket "
                        "transition and mode); implies --shrink-fix")
    p.add_argument("--shrink-buckets", type=str, default="0.25,0.5,0.75",
                   help="comma-separated fixed-fraction thresholds for "
                        "compaction bucket transitions")
    p.add_argument("--shrink-rho", action="store_true",
                   help="per-slot device-side adaptive rho "
                        "(residual-balancing vector rho on the prox "
                        "diagonal)")
    p.add_argument("--shrink-rho-interval", type=int, default=1,
                   help="iterations between per-slot rho update passes")
    p.add_argument("--no-shrink-transplant", action="store_true",
                   help="disable the warm-state transplant across "
                        "compaction bucket transitions (states rebuild "
                        "cold, the pre-transplant spelling; transplant "
                        "is on by default when --shrink-compact is)")
    # scenario streaming (mpisppy_tpu/stream, doc/streaming.md)
    p.add_argument("--scenario-source", choices=STREAM_SOURCES,
                   default="resident",
                   help="where the chunked hot loop's per-scenario "
                        "vector blocks come from (doc/streaming.md): "
                        "'resident' = full-width device arrays, "
                        "'streamed' = host store + double-buffered H2D "
                        "chunk pipeline, 'synthesized' = device-side "
                        "seeded generation (models exporting "
                        "scenario_synth_spec; zero steady-state "
                        "transfer). Non-resident sources need "
                        "--subproblem-chunk and run hub-only")
    p.add_argument("--stream-int8", action="store_true",
                   help="int8 delta-packed host storage for the "
                        "streamed source (explicit opt-in behind a "
                        "host-side quantization gate, like the bf16 "
                        "packed blocks — doc/streaming.md)")
    p.add_argument("--stream-int8-tol", type=float, default=1e-3,
                   help="int8 gate: max per-entry reconstruction error "
                        "relative to 1+|value| before a field falls "
                        "back to full-precision storage")
    p.add_argument("--stream-depth", type=int, default=2,
                   help="prefetch pipeline depth (staged chunks; 2 = "
                        "double buffering)")
    p.add_argument("--subproblem-chunk", type=int, default=None,
                   help="scenario microbatch rows per device solve "
                        "call (the chunked hot loop; required by "
                        "non-resident --scenario-source). Lands in "
                        "hub_options like the programmatic spelling")
    p.add_argument("--forensics-interval", type=int, default=None,
                   help="sample the per-slot/per-scenario forensic "
                        "reduction every N iterations when telemetry "
                        "is on (default 5; 0 disables — see "
                        "doc/forensics.md). Lands in hub_options like "
                        "the programmatic spelling")
    # APH φ-dispatch (--hub aph; core/aph.py + ops/dispatch.py,
    # doc/aph.md)
    p.add_argument("--dispatch-frac", type=float, default=1.0,
                   help="APH: fraction of scenarios solved per "
                        "iteration, most-negative-φ first with "
                        "least-recently-dispatched fill (doc/aph.md); "
                        "1.0 = full dispatch. Partial dispatch needs "
                        "--hub aph")
    p.add_argument("--aph-nu", type=float, default=1.0,
                   help="APH projective step scale ν (θ = ν·φ/τ; ref. "
                        "APHnu)")
    p.add_argument("--aph-gamma", type=float, default=1.0,
                   help="APH z-update damping γ (ref. APHgamma)")
    p.add_argument("--linearize-proximal-terms", action="store_true")
    p.add_argument("--verbose", action="store_true")
    # termination (ref. baseparsers.py:172 two_sided_args)
    p.add_argument("--rel-gap", type=float, default=None)
    p.add_argument("--abs-gap", type=float, default=None)
    # spokes (ref. baseparsers.py:224-451)
    for kind in KNOWN_SPOKES:
        p.add_argument(f"--with-{kind.replace('_', '-')}",
                       action="store_true", dest=f"with_{kind}")
    p.add_argument("--incumbent-mode", choices=INCUMBENT_MODES,
                   default=None,
                   help="incumbent source policy for the inner-bound "
                        "spokes (doc/incumbents.md): 'device' = batched "
                        "on-device candidate pools/dives only (zero "
                        "host solver subprocesses), 'oracle' = "
                        "host-oracle sources only, 'auto' = device "
                        "with the oracle as opt-in fallback/polish. "
                        "Default: each spoke's own default (--with-dive "
                        "defaults to device)")
    # EF path (ref. examples/farmer/farmer_ef.py)
    p.add_argument("--EF", action="store_true", dest="solve_ef")
    p.add_argument("--EF-integer", action="store_true", dest="ef_integer")
    p.add_argument("--trace-prefix", type=str, default=None)
    # telemetry files, the live plane (obs/) and checkpoints (ckpt/)
    p.add_argument("--telemetry-dir", type=str, default=None,
                   help="enable telemetry (mpisppy_tpu_torch.obs): "
                        "events.jsonl, trace.json, metrics.json and "
                        "live.json in this directory; read them with "
                        "'python -m mpisppy_tpu_torch analyze DIR'")
    p.add_argument("--status-port", type=int, default=None,
                   help="serve the hub's live status plane on this port "
                        "(/status JSON, /metrics Prometheus text, "
                        "/healthz; 0 = an ephemeral port)")
    p.add_argument("--status-host", type=str, default="127.0.0.1")
    p.add_argument("--checkpoint-dir", type=str, default=None,
                   help="durable run-state checkpoints: the hub "
                        "captures manifest'd bundles (W, x̄, ρ, "
                        "bounds, per-spoke warm state) here — "
                        "periodic, plus forced on watchdog fire and "
                        "SIGTERM (the preemption notice). See "
                        "doc/fault_tolerance.md")
    p.add_argument("--checkpoint-interval", type=float, default=30.0,
                   help="seconds between periodic checkpoint bundles "
                        "(default 30)")
    p.add_argument("--checkpoint-keep", type=int, default=3,
                   help="retain the newest N bundles (default 3); "
                        "LATEST always points at the newest")
    p.add_argument("--resume-from", type=str, default=None,
                   help="relaunch the wheel from a checkpoint bundle "
                        "(or a --checkpoint-dir, resolved through its "
                        "LATEST pointer): hub state + best-bound "
                        "ledger + spoke warm state restored; a "
                        "corrupt or config-mismatched bundle falls "
                        "back to cold start with a reasoned event")
    p.add_argument("--wheel-deadline", type=float, default=None,
                   help="watchdog: cleanly terminate the wheel after "
                        "this many seconds (kill signal to spokes, "
                        "telemetry flushed, partial bounds reported — "
                        "see doc/fault_tolerance.md)")
    p.add_argument("--f32", action="store_true",
                   help="run every engine in float32 (bounds and "
                        "objectives carry ~1e-3 relative noise). Default "
                        "is float64 for solver-grade accuracy.")
    p.add_argument("--device", type=str, default=None,
                   help="device of every engine: default the CUDA "
                        "device (the run raises without one); 'cpu' "
                        "runs on the CPU")
    # scenario-axis sharding of the ph/aph hub engine over ranks
    # (parallel/), and the multi-process rendezvous
    p.add_argument("--mesh-devices", type=int, default=None,
                   help="shard the ph/aph hub engine's scenarios over "
                        "this many ranks, one per card (0 = every "
                        "visible card; on --device cpu, ranks are "
                        "processes); the spokes run on rank 0")
    p.add_argument("--coordinator-address", type=str, default=None,
                   help="host:port of rank 0 when this process is one "
                        "rank of a run started elsewhere (with "
                        "--num-processes and --process-id)")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    return p


def config_from_args(args) -> RunConfig:
    algo = AlgoConfig(
        default_rho=args.default_rho,
        max_iterations=args.max_iterations,
        convthresh=args.convthresh,
        subproblem_max_iter=args.subproblem_max_iter,
        subproblem_eps=args.subproblem_eps,
        subproblem_polish_chunk=args.subproblem_polish_chunk,
        subproblem_ir_sweeps=args.subproblem_ir_sweeps,
        subproblem_kernel_mode=args.subproblem_kernel_mode,
        shrink_fix=args.shrink_fix or args.shrink_compact,
        shrink_fix_iters=args.shrink_fix_iters,
        shrink_fix_tol=args.shrink_fix_tol,
        shrink_compact=args.shrink_compact,
        shrink_buckets=args.shrink_buckets,
        shrink_rho=args.shrink_rho,
        shrink_rho_interval=args.shrink_rho_interval,
        shrink_transplant=not args.no_shrink_transplant,
        scenario_source=args.scenario_source,
        stream_int8=args.stream_int8,
        stream_int8_tol=args.stream_int8_tol,
        stream_depth=args.stream_depth,
        dispatch_frac=args.dispatch_frac,
        aph_nu=args.aph_nu,
        aph_gamma=args.aph_gamma,
        linearize_proximal_terms=args.linearize_proximal_terms,
        verbose=args.verbose,
    )
    hub_options = {"dtype": "float32"} if args.f32 else {}
    if args.subproblem_chunk is not None:
        hub_options["subproblem_chunk"] = args.subproblem_chunk
    if args.forensics_interval is not None:
        hub_options["forensics_interval"] = args.forensics_interval
    spokes = [SpokeConfig(kind=k,
                          options={"dtype": "float32"} if args.f32 else {})
              for k in KNOWN_SPOKES if getattr(args, f"with_{k}")]
    # build the dict whenever ANY coordinator flag is present, so
    # --num-processes without --coordinator-address hits validate()'s
    # "coordinator needs an 'address'" error instead of silently
    # running single-process
    coordinator = None
    if (args.coordinator_address or args.num_processes is not None
            or args.process_id is not None):
        coordinator = {"address": args.coordinator_address}
        if args.num_processes is not None:
            coordinator["num_processes"] = args.num_processes
        if args.process_id is not None:
            coordinator["process_id"] = args.process_id
    return RunConfig(
        model=args.model, num_scens=args.num_scens,
        model_kwargs=json.loads(args.model_kwargs),
        num_bundles=args.num_bundles, hub=args.hub, algo=algo,
        hub_options=hub_options,
        spokes=spokes, rel_gap=args.rel_gap, abs_gap=args.abs_gap,
        incumbent_mode=args.incumbent_mode,
        solve_ef=args.solve_ef, ef_integer=args.ef_integer,
        trace_prefix=args.trace_prefix, telemetry_dir=args.telemetry_dir,
        status_port=args.status_port, status_host=args.status_host,
        wheel_deadline=args.wheel_deadline,
        checkpoint_dir=args.checkpoint_dir,
        checkpoint_interval=args.checkpoint_interval,
        checkpoint_keep=args.checkpoint_keep,
        resume_from=args.resume_from,
        mesh_devices=args.mesh_devices, coordinator=coordinator,
        device=args.device,
    ).validate()


def run(cfg: RunConfig):
    from . import obs
    from .utils.sputils import spin_the_wheel, wheel_result, wheel_on_mesh
    from .utils.vanilla import mesh_ranks, refuse_unported, wheel_dicts

    refuse_unported(cfg)
    # the telemetry session: --telemetry-dir wins, then the environment
    # variable. The ranks of a mesh each open their own session
    # (utils/sputils.wheel_on_mesh), so the launching process opens none
    launched = cfg.coordinator is None and mesh_ranks(cfg, warn=False) > 1
    own = bool(cfg.telemetry_dir) and not launched \
        and cfg.coordinator is None
    if own:
        obs.configure(out_dir=cfg.telemetry_dir, config=cfg.to_dict())
    elif not launched and cfg.coordinator is None:
        obs.maybe_configure_from_env()
    if cfg.solve_ef:
        from . import global_toc
        from .core.ef import ExtensiveForm
        from .utils.vanilla import build_batch_for

        ef = ExtensiveForm(build_batch_for(cfg), device=cfg.device)
        obj, _ = ef.solve_extensive_form(integer=cfg.ef_integer)
        global_toc(f"EF objective: {obj:.4f}")
        result = {"ef_objective": obj}
    elif cfg.coordinator is not None:
        # this process is one rank of a run started elsewhere
        from .parallel.mesh import make_mesh
        from .utils.runtime import maybe_init_distributed
        maybe_init_distributed(cfg.coordinator)
        device = "cpu" if str(cfg.device or "").startswith("cpu") \
            else None
        result = wheel_on_mesh(make_mesh(device=device), cfg)
    elif mesh_ranks(cfg) > 1:
        # start the ranks here: rank 0 runs the wheel, the others follow
        # its hub loop (utils/sputils.spin_the_wheel)
        from .parallel.launch import launch
        device = "cpu" if str(cfg.device or "").startswith("cpu") \
            else None
        result = launch(wheel_on_mesh, mesh_ranks(cfg, warn=False),
                        (cfg,), device=device)[0]
    else:
        result = wheel_result(spin_the_wheel(*wheel_dicts(cfg)))
    obs.event("run.result", result)
    if own:
        # close the session: the footer and the final trace/metrics
        obs.shutdown()
    else:
        obs.flush()
    return result


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv and argv[0] == "analyze":
        # diagnostics only: reads telemetry artifacts, builds nothing
        from .obs.analyze import main as analyze_main
        return analyze_main(argv[1:])
    if argv and argv[0] == "serve":
        # the persistent service (serve/): runs until SIGTERM/SIGINT or
        # POST /shutdown
        from .serve.manager import serve_main
        return serve_main(argv[1:])
    args = make_parser().parse_args(argv)
    result = run(config_from_args(args))
    if result is not None:       # None: a follower rank of a mesh
        print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
