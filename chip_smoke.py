#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (mpisppy_tpu_torch) on one CUDA card.

    python3 chip_smoke.py            # the full check, one card

1. prints the card's name and power limit and builds the CUDA kernels
   from the sources in this checkout;
2. holds the hand-written ADMM block against its plain PyTorch version
   on the card (a tiny shared QP and the 10 x 24 UC batch, both solve
   operators, 20 steps), shows that planted faults fail the same bar,
   and holds a scenario-tiled call against an untiled one (S = 256,
   tile 128: bit-equal);
3. runs the main path, ``PH(batch, options).ph_main()``, on the
   reference-scale UC instance (90 generators x 48 h, every constraint
   block on: n = 13056, m = 26016 per scenario, S = 10) in native f64
   with the fused kernel path, and checks that every kernel of the path
   launched, that no demotion was booked, that iter 0 passed the
   feasibility gate, that sum_s p_s W_s = 0 per nonant slot and that
   the bounds are finite;
4. holds the block against its plain version at the main path's shapes
   (from the engine's last prox-on state), times it there (kernel, plain
   version, torch.matmul products with and without the residual tail's
   two) and breaks the kernel's time down per product against streaming
   each product's matrix once;
5. runs the scenario-chunked PH loop on the same instance, S = 34 in
   chunks of 16 (16, 16 and a padded 2), with the hospital off, and
   checks the launch count (one block call per chunk and solve), no
   demotion, one gate sync per iteration, iter-0 feasibility,
   sum_s p_s W_s = 0, finite results, holds the block against its plain
   version at this path's 16-row shapes (the first chunk and the padded
   last one, from the engine's prox-on chunk states), and checks that
   x̄ and W after one prox-on iteration equal an unchunked run's on the
   same batch to 1e-9;
6. times one 20-step block call at full width for S = 16, 48 and 128
   rows tiled from the chunked batch (``block_scaling``), beside the
   step's three products as library calls and the step's floors;
7. runs the native chunked loop on the reference backend (rho adapts)
   for DF32_ITERS PH iterations on the chunked path's batch
   (``native_reference``), then the JAX bench's df32 recipe (its DF32
   dict, chunks of 16, DF32_ITERS PH iterations, kernel mode auto) through
   ``PH(...).ph_main()`` on that batch (``df32_path``): checks the
   engine's iter-0 gate at the bench's 5e-3, the post-solve prox-on
   residual, the Eobjective within 2e-2 of the reference-backend run's,
   the certified trivial bound against both native runs' iter-0 primal
   objectives, that the ADMM block was never launched, and the packed
   split matvec against the dense one on the card with a planted fault;
   times one chunk's split factorization, L⁻¹ build, f32 bulk step and
   df32 tail step beside the byte model;
8. times the df32 bulk and tail steps and one fused solve call with the
   chunk's operands tiled to 16 and 128 rows (``df32_scaling``), beside
   phase 6's native block at the same rows;
9. runs one fused and one segmented mixed-precision PH iteration on a
   small chunked UC and checks that x̄ and W agree (``mixed_check``);
10. spins the hub-and-spoke wheel that ``python -m mpisppy_tpu_torch``
   runs (``wheel_path``: a RunConfig through utils/vanilla.wheel_dicts
   and utils/sputils.spin_the_wheel) on the slice's S = 10 batch: a PH
   hub, the Lagrangian spoke in device-dual mode and the shuffled x̂
   spoke with host-oracle candidates and exact evaluation, the JAX
   bench's device-certified gap wheel with the cuts listed at
   WHEEL_ITERS; checks that the hub's and the Lagrangian spoke's
   engines each launched the block (counted per engine) with no
   demotion, iter-0 feasibility, finite bounds with outer <= inner and
   outer >= the trivial bound, and holds the block against its plain
   version at full width from the Lagrangian engine's prox-off W-on
   state; the wheel writes checkpoint bundles (``checkpoint_dir``);
22. resumes that wheel (``ckpt_path``, cell uc-ref-S10-wheel-resume):
   a fresh wheel of the same configuration on phase 10's batch with
   ``resume_from`` phase 10's checkpoint directory, and a hub fault
   plan (mpisppy_tpu_torch/testing/faults.py) whose ``preempt`` sends
   the process a real SIGTERM at the resumed hub's first prox-on
   iteration; checks that the installed (W, x̄, x̄², ρ) are bit-equal
   to phase 10's final hub state and ``_iter`` to its count, that the
   seeded best-bound ledger starts at phase 10's best bounds and never
   loosens, that both resumed spokes booked ``ckpt.spoke_resumed``, that
   the SIGTERM left a ``preempt`` bundle that ``LATEST`` named and no
   spoke thread, that the hub's and the Lagrangian spoke's engines
   launched the block with no demotion, and holds the block against its
   plain version on the resumed hub's prox-on operands; prints the
   capture and install milliseconds, the bundle's bytes and the
   resumed wheel's seconds;
11. spins the wheel that ``python -m mpisppy_tpu_torch uc --hub aph
   --dispatch-frac 0.25 --subproblem-chunk 16 --with-xhatshuffle``
   builds (``aph_path``: the RunConfig through utils/vanilla's hub and
   spoke dicts and utils/sputils.spin_the_wheel) on the chunked path's
   S = 34 batch: the APH hub for APH_ITERS iterations, the x̂ spoke with
   the bench's oracle recipe; checks the block launches against the
   plan (three chunk calls at iters 0 and 1, one per partial iteration),
   no demotion, one gate sync per iteration, the dispatch counters, the
   chunked-skip path from iter 2, bit-unchanged undispatched rows of x
   across every partial pass, sum_s p_s W_s = 0, finite bounds with the
   trivial bound at most the incumbent, and holds the block against its
   plain version on one dispatched chunk's rows gathered from the row
   store, pad rows included;
12. spins the scenario-sharded APH wheel (``aph_shard_wheel``:
   core/aph_shard.spin_aph_shard_wheel) on the full-width instance at
   S = APH_SHARD_SCENARIOS, two shard processes and the x̂ spoke as a
   process, every process on the card; checks finite bounds with outer
   <= inner and that each shard ran the block with no demotion (the
   shards' launch counts come back beside their results), then holds
   the block against its plain version at a shard's shapes (shard 0's
   rows at full width, from an engine built here with the shards'
   options after iter 0 and one APH iteration);
13. spins the L-shaped wheel that ``python -m mpisppy_tpu_torch uc --hub
   lshaped --with-xhatlshaped`` builds (``lshaped_path``: the RunConfig
   through utils/vanilla's hub and spoke dicts and
   utils/sputils.spin_the_wheel) on phase 10's S = 10 batch for
   LSHAPED_ITERS iterations, PH_OPTS' native options on the cuda block;
   checks that the hub engine launched the block on its prox-off (eta
   bounds) and pinned (cut solves) plans with no demotion, a finite
   outer bound that never decreases and sits at or above the
   probability-weighted eta bounds, outer <= inner where an inner bound
   exists, and at each round whose pinned solve passed the engine's
   feasibility test that every scenario's cut lies below that solve's
   objective at the round's point (JAX tests/test_lshaped.py's bar);
   then holds the block against its plain version on the pinned
   operands at full width;
15. spins the wheel that ``python -m mpisppy_tpu_torch uc --with-fwph``
   builds (``fwph_path``: the RunConfig through utils/vanilla's hub and
   spoke dicts and utils/sputils.spin_the_wheel) on phase 10's S = 10
   batch, PH_OPTS' native options on the cuda block: the FWPH spoke runs
   its iter 0 and FWPH_ITERS outer iterations while the PH hub iterates;
   checks that the FWPH engine launched the block (counted per engine)
   with no demotion, both iter-0 solves passed the gate,
   sum_s p_s w_s = 0 at every first SDM pass, every published FWPH bound
   is finite, at least FWPH's trivial bound less 1e-6 relative and at
   most phase 10's incumbent value, and the simplex weights lie on the
   simplex; holds the block against its plain version at full width on
   the FWPH engine's linearized operands;
16. runs ``python -m mpisppy_tpu_torch uc --num-bundles 5`` on that
   batch (``bundle_path``: core/bundles.form_bundles, then
   ``PH(...).ph_main()`` for BUNDLE_ITERS prox-on iterations): checks
   that the bundled A is one shared 2-D matrix (52,032 x 17,472), the
   block launched as planned with no demotion, the iter-0 gate,
   sum_s p_s W_s = 0, finite bounds and a bundled trivial bound at most
   phase 10's incumbent; holds the block against its plain version at
   the bundled shapes and times it there beside the byte floor;
17. runs problem shrinking on that batch (``shrink_path``): PH with
   PH_OPTS and bench.py's hub shrink settings (the device fixer after 4
   agreeing iterations at tol 1e-3, compaction at buckets 0.25 / 0.5 /
   0.75) for SHRINK_ITERS prox-on iterations; checks that a compaction
   happened, that the compacted prox-on solves ran the block on their
   own plan with no demotion, iter 0, sum_s p_s W_s = 0 and finite
   results; prints the fixed fraction, (m_c, n_c) and seconds per
   iteration, the re-factorizations and the peak memory; holds the block
   against its plain version on the first compacted solve's operands and
   times it there beside the byte bound and three torch.matmul per step;
   then one prox-on iteration compacted against one on the full pin-box
   system from the same carried PH and solver state, both solved to
   1e-5 on the reference backend (their Eobjective and x̄ differences
   beside the JAX round-trip bar);
18. runs the port's twin of ``__graft_entry__.entry()`` (``entry_path``:
   one PH step on uc(8, 4, 6)) once on the card and checks its shapes and
   that it is finite;
19. runs the main path's batch (shipped to the ranks as an npz) and
   options sharded over MESH_RANKS ranks (``mesh_path``, cell
   uc-ref-S10-mesh2: parallel/launch.launch, one ``PH(batch, options,
   mesh=mesh).ph_main()`` per rank, each rank's hand-written block on
   its 5-row shard of the card; NCCL with a card per rank, else gloo
   with the ranks sharing the card, printed beside the card count);
   checks every rank's launch count against the plan, no demotion, no
   gate read (the unchunked loop has none), x̄ and W after prox-on
   iteration 1 and after the run and conv against the main path's at
   MESH_BAR, Eobjective and the trivial bound at 2e-6, and holds the
   block against its plain version on every rank's prox-on operands;
   rank 0 times the block at the shard's shapes while rank 1 waits;
14. solves ``python -m mpisppy_tpu_torch uc --EF`` on the reference
   instance at EF_SCENARIOS scenarios and ``farmer --EF`` on the card
   (``ef_path``: utils/vanilla.build_batch_for and core/ef.ExtensiveForm)
   and holds them against the host HiGHS LP of the same EF
   (tests/test_models.py's band: rel 2e-3, abs 2e-2) and -108390
   (rel 1e-4);
20. runs PH from both scenario sources of mpisppy_tpu_torch/stream on
   the reference UC synth family (``stream_path``, cells
   uc-ref-S16-chunk8-synth and uc-ref-S16-chunk8-streamed: S = 16 in
   chunks of 8 built by utils/vanilla at synth_seed 0, PH_OPTS with one
   prox-on iteration): the synthesized source makes each chunk on the
   card, the streamed one copies the family, materialized on the card,
   from pinned host memory on a side stream; checks that the two runs
   are bit-equal, that every synthesized chunk equals the materialized
   rows, the launch plan, the block against its plain version at the
   first synthesized chunk, the profiler's host-to-device records of
   the prox-on iteration (nothing of a scenario row's size when
   synthesized; the booked bytes, pinned, each chunk's copy inside the
   previous chunk's solve interval when streamed) and int8 staging;
21. rides phases 3, 10 and 12 with telemetry (mpisppy_tpu_torch/obs):
   the main path runs with a session writing to a temporary directory
   and a forensic sample every iteration; ``analyze`` must render every
   section with every invariant PASS, ``profile.device`` must name the
   card and its peaks, the block's profile entry must book the byte
   floor (1500 x (A + F) + one pass of A per call) for the path's
   calls, the prox-on iteration's ``hbm_util`` must lie in (0, 1.05],
   the memory gauges must equal the allocator's readings at the
   sample, the forensic sample must decompose conv (the slot masses /
   K = conv to 1e-12), and a torch.profiler pass around one block call
   must see the ``kernel.cuda`` range by name (``telemetry_main``);
   the wheel runs with ``status_port`` 0 and a telemetry directory, a
   mid-run fetch of /status and /metrics must succeed, live.json must
   parse and ``analyze`` must give a bound-flow verdict per spoke
   (``telemetry_wheel``); the sharded APH wheel records every process
   under its role and its merged trace must have one track per process
   (``telemetry_shards``);
23. serves two requests through the port's service (``serve_path``,
   cell uc-ref-S2-serve): ``ServeService`` (serve/manager.py) behind
   ``ServeHTTPServer`` on 127.0.0.1 at port 0, a temporary state
   directory, engines on the card, one request per wheel; the reference
   UC at SERVE_SCENARIOS scenarios (its widths; relax_integrality True
   for the consensus evaluation), SERVE_ALGO's fused cuda options and
   one prox-on iteration, each request with its own data-only patch of
   the balance rows, POSTed over loopback with urllib one after the
   other; checks that both reach ``done``, that the second hits the
   warm bucket with no kernel build and no factor build, that each
   request launched the block SERVE_SOLVES x one solve's count with no
   demotion and every plan cuda, that each objective is finite, feasible
   and at or above its wheel's outer bound, that the two requests'
   outer bounds differ (the patch reached the card) and that LATEST
   resolves to a bundle in each request's checkpoint namespace; holds
   the block against its plain version on the warm engine's prox-on
   operands;
then prints one {"kernels": [...]} line whose launches count phases 3,
5, 10, 11, 12, 13, 15, 16, 17, 19 (every rank's), 20, 22 and 23 and
whose max_abs_err is the largest of phases 4, 5, 10, 11, 12, 13, 15,
16, 17, 19, 20, 22 and 23.
The last line is {"ok": true, "device": {...}}; any failed check raises.
"""

from __future__ import annotations

import gc
import json
import os
import subprocess
import sys
import time

# H100 SXM data-sheet peaks (700 W): HBM bandwidth and the f64 tensor-
# core rate, the highest f64 rate of the card
HBM_BYTES_PER_S = 3.35e12
F64_FLOP_PER_S = 67e12
ALPHA = 1.6

# the slice's configuration: the reference UC instance, S scenarios and
# the block's fixed-rho step budget per subproblem solve
SLICE_INSTANCE = dict(num_gens=90, num_hours=48, min_up_down=True,
                      ramping=True, t0_state=True,
                      startup_shutdown_ramps=True, relax_integrality=False)
SLICE_SCENARIOS = 10
SLICE_BUDGET = 1500
# the main path's PH options (a prox-on solve: the whole budget at fixed
# rho in the block, then the finisher without the polish); 1 prox-on
# iteration (3, then 2, until cuts in depth for the script's time)
PH_OPTS = {"defaultPHrho": 100.0, "PHIterLimit": 1, "convthresh": -1.0,
           "subproblem_kernel_mode": "fused",
           "subproblem_kernel_backend": "cuda",
           "subproblem_max_iter": SLICE_BUDGET,
           "subproblem_eps": 1e-5, "subproblem_eps_hot": 1e-4,
           "subproblem_eps_dua_hot": 1e-2,
           "subproblem_polish_hot": False,
           "subproblem_polish_chunk": 2}
# the chunked path: S scenarios in chunks of CHUNK rows (the JAX
# package's bench runs 1024 in chunks of 128; cut for the run's time:
# 40 until the serve phase; the unchunked comparison's block call and
# the df32 steps scale with the rows, the chunked solves do not, since
# the padded last chunk polishes its pad rows too)
CHUNK_SCENARIOS = 34
CHUNK = 16
# prox-on iterations of the chunked path (PH_OPTS' 2 until a cut in depth
# for the script's time; its unchunked comparison is after iteration 1)
CHUNK_ITERS = 1
# rows per call timed by block_scaling (128: the JAX bench's chunk)
SCALING_ROWS = (16, 48, 128)

# the wheel (phase 10): the JAX bench's device-certified gap wheel
# (bench.py bench_uc10_gap_device_bound through its _wheel) on the
# slice's batch, with these cuts: the base options are PH_OPTS (native
# f64 on the cuda block, not the bench's df32 recipe, which never
# enters the block), no padding to 128 rows (a TPU program-shape
# device), a wheel deadline of WHEEL_DEADLINE seconds, and WHEEL_ITERS
# hub iterations where the bench runs 25 (a cut in depth for the
# script's time: 25 took about 136 s on an H100 80GB HBM3 at 700 W;
# 3 until phase 22's resumed wheel ran the third).
# The x̂ spoke's first oracle round (three host MILPs and the exact
# evaluation of one candidate) lands within the hub's iter 0 and the
# Lagrangian spoke's first bound within the first hub iterations, so
# the deadline is a guard that the hub's iteration limit normally beats
WHEEL_ITERS = 2
WHEEL_DEADLINE = 300.0
WHEEL_REL_GAP = 0.004
WHEEL_GAP_MARKS = (0.01, 0.005)
# the bench's oracle candidate recipe (bench.py _XHAT_ORACLE)
# the resumed wheel (phase 22): phase 10's configuration resumed from
# its checkpoint directory; the hub fault plan preempts it (a real
# SIGTERM) at its first prox-on iteration, under an iteration limit
# one above, so only the preemption can stop it there
CKPT_FAULT_PLAN = {"hub": [{"action": "preempt", "at_iteration": 1}]}
CKPT_ITERS = 2
XHAT_ORACLE = {"xhat_oracle_candidates": True,
               "xhat_dive_candidates": False,
               "xhat_device_prescreen": False,
               "xhat_union_fallback": True, "xhat_scen_limit": 3,
               "xhat_oracle_time_limit": 120.0, "xhat_oracle_gap": 5e-3}

# APH (phases 11 and 12): the chunked path's batch under φ-dispatch of
# a quarter of the scenarios (9 of 34: one 16-row chunk call per
# partial iteration) for APH_ITERS iterations (5, then 3, until cuts in
# depth for the script's time), and the sharded wheel at S = 4 (cut from the
# chunked path's 34 for the run's time; the widths stay the reference
# instance's) for APH_SHARD_ITERS iterations (4 until a cut in depth for
# the script's time)
APH_ITERS = 2
APH_FRAC = 0.25
APH_SHARD_SCENARIOS = 4
APH_SHARDS = 2
APH_SHARD_ITERS = 2

# L-shaped (phase 13): the slice's S = 10 batch, LSHAPED_ITERS
# iterations (a cut in depth, for time). The EF (phase 14): the
# reference instance at EF_SCENARIOS (its dense EF matrix is 7.3 GB in
# f64; S = 10 would not fit the card) with EF_BUDGET ADMM iterations
# (cuts in depth for the script's time: 12,000 steps landed 1.8e-5
# from host HiGHS, 6,000 steps 3.3e-5, 4,000 steps 5.7e-5, 3,000 steps
# 1.4e-5, 2,000 steps 8.1e-5, the band is 2e-3)
LSHAPED_ITERS = 4
# the reference-backend cut solve of phase 13's cut-at-point check: the
# slice's step budget (rho adapts; the dual residual on the dispatch
# columns still decides whether a cut is finite, at any budget a run
# can afford)
REF_CUT_ITERS = SLICE_BUDGET
EF_SCENARIOS = 2
EF_BUDGET = 1500
# FWPH (phase 15): the slice's S = 10 batch; the spoke runs its iter 0
# and FWPH_ITERS outer iterations of FWPH_FW_ITERS linearized solves
# (cuts in depth, for time; with 2, the first outer iteration took
# 113 s beside the hub on an H100 80GB HBM3 at 700 W), and the hub
# iterates until the spoke starts its last outer iteration (at most
# FWPH_HUB_ITERS iterations). Bundles (phase 16):
# that batch in BUNDLES bundles of 2 scenarios (n = 17,472, m = 52,032
# per bundle), PH for BUNDLE_ITERS prox-on iterations (a cut in depth:
# 2 until the streaming phase needed the time)
FWPH_ITERS = 1
FWPH_FW_ITERS = 1
FWPH_HUB_ITERS = 40
BUNDLES = 5
BUNDLE_ITERS = 1
# problem shrinking (phase 17): the slice's S = 10 batch with bench.py's
# hub settings (bench.py:901-903: the device fixer after 4 agreeing
# iterations at tol 1e-3, compaction at the 0.25 / 0.5 / 0.75 buckets);
# SHRINK_ITERS prox-on iterations, the earliest fixing landing at 4
SHRINK_OPTS = {"shrink_fix": True, "shrink_compact": True,
               "shrink_buckets": "0.25,0.5,0.75", "shrink_fix_iters": 4,
               "shrink_fix_tol": 1e-3}
SHRINK_ITERS = 6
# the equivalence check's solves (phase 17): adaptive rho to 1e-5 (to
# 1e-6 they took 24 s compacted and 51 s pinned on an H100 80GB HBM3 at
# 700 W, too long for the script's limit)
SHRINK_EQUIV_SOLVE = {"subproblem_kernel_backend": "reference",
                      "subproblem_max_iter": 20000,
                      "subproblem_eps_hot": 1e-5,
                      "subproblem_eps_dua_hot": 1e-5}

# the mesh path (phase 19, uc-ref-S10-mesh2): the main path's batch,
# shipped to the ranks as an npz, and options on MESH_RANKS ranks
# (parallel/launch): one card per rank and NCCL where the machine has
# the cards, else the ranks share the card over gloo
MESH_RANKS = 2
# x̄, W and conv of the sharded run against the main path's: the CPU
# tests' bar for the same comparison (tests/test_torch_sharding.py).
# Every operation but the combine gives a 5-row shard's rows bit for bit
# as at 10 rows; the combine's node tables are summed over the ranks, a
# 4.4e-16 difference in iteration 0's x̄ that iteration 1's 1500
# fixed-rho block steps carry to 2.2e-10 in x̄ and 1.1e-9 in W
# (trace_mesh_gap.py; PERF.md §6)
MESH_BAR = 1e-8

# kernel vs plain (see compare): the multiple of the plain version's
# own roundoff spread that the bar allows, and the multiple of the bar
# that every planted fault must reach
BAR_SPREAD = 4.0
FAULT_MARGIN = 10.0


def log(msg):
    print(msg, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _sync():
    import torch
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def cuda_ms(fn, reps):
    """Mean milliseconds of ``fn`` over ``reps`` calls (CUDA events),
    after one warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def block_operands(f, d, q, st):
    """The operands fused_admm_block hands the kernel (and the plain
    version), keyed as admm_block_plain's positional arguments."""
    from mpisppy_tpu_torch.ops import qp_solver as T
    g, l_s, u_s, lb_s, ub_s, csx, q_s = T._scaled_problem(f, d, q)
    L = st.L
    F = L.inv if isinstance(L, T.LInv) else L
    rs = st.rho_scale
    return (f.A_s, F, f.P_s, g, q_s, l_s, u_s, lb_s, ub_s, f.rho_A * rs,
            f.rho_b * rs, 1.0 / f.E, 1.0 / f.Eb, 1.0 / (f.D * csx), f.D,
            st.x, st.yA, st.yB, st.zA, st.zB)


_PER_SCEN = (4, 5, 6, 7, 8, 15, 16, 17, 18, 19)
_OUTS = ("x", "yA", "yB", "zA", "zB", "pri", "dua")


def plain_rowwise(ops, **kw):
    """The plain version one scenario row at a time: the same
    arithmetic as one batched call in another order of summation."""
    import torch
    from mpisppy_tpu_torch.ops.kernels import admm_block
    rows = []
    for s in range(ops[15].shape[0]):
        sub = [o[s:s + 1] if (i in _PER_SCEN or (i > 1 and o.ndim == 2))
               else o for i, o in enumerate(ops)]
        rows.append(admm_block.admm_block_plain(*sub, **kw))
    return [torch.cat(p) for p in zip(*rows)]


def _drop_g_yB(ops, kw):
    """A planted fault: the plain version with the -g*yB term left out
    of the x-update's right-hand side (K1's epilogue). One step at a
    time, the term folded into the cost, then the residual tail with the
    true cost."""
    from mpisppy_tpu_torch.ops.kernels import admm_block
    ops = list(ops)
    q_s = ops[4]
    for _ in range(kw["n_steps"]):
        step = list(ops)
        step[4] = q_s - ops[3] * ops[17]
        ops[15:20] = admm_block.admm_block_plain(
            *step, **dict(kw, n_steps=1))[:5]
    return admm_block.admm_block_plain(*ops, **dict(kw, n_steps=0))


def _ulp_perturbed(ops):
    """The operands with the iterates (x, yA, yB, zA, zB) moved by one
    unit in the last place, with a seeded random sign per entry."""
    import torch
    gen = torch.Generator(device=ops[15].device).manual_seed(0)
    out = list(ops)
    for i in range(15, 20):
        sign = (torch.randint(0, 2, ops[i].shape, generator=gen,
                              device=ops[i].device) * 2 - 1).to(ops[i].dtype)
        out[i] = ops[i] * (1.0 + sign * 2.0 ** -52)
    return out


def compare(f, d, q, st, n_steps, label, sink=None):
    """Kernel vs plain version on the same CUDA inputs. Returns the
    largest absolute difference and the list of failures; its record
    line goes to ``sink`` (default: printed).

    The bar for each output is 1e-9 x max(1, |plain|) + BAR_SPREAD x the
    plain version's own roundoff spread: the larger of the spread
    between two of its summation orders (batched and one row at a time)
    and its spread under a one-ulp perturbation of its inputs. The
    kernel is f64 with a third order of summation, where each ADMM step
    multiplies a roundoff-level difference in the slacks by rho (up to
    100 on the equality rows of UC) and the dual residual scales it by
    1/(D x cost scale); at some row counts the two plain orders happen
    to agree more closely than either agrees with a third, and the
    one-ulp spread measures the same amplification without depending on
    which orders coincide. The bar is held to planted faults of the same
    inputs (the plain version one step short, with alpha 1.5, without
    the g*yB term): each must read at least FAULT_MARGIN times its bar
    on some output."""
    from mpisppy_tpu_torch.ops import qp_solver as T
    from mpisppy_tpu_torch.ops.kernels import admm_block
    import torch
    l_inv = isinstance(st.L, T.LInv)
    got = admm_block.fused_admm_block(f, d, q, st, n_steps=n_steps,
                                      scen_tile=0)
    ops = block_operands(f, d, q, st)
    kw = dict(sigma=f.sigma, n_steps=n_steps, alpha=ALPHA,
              l_inv_pair=l_inv)
    ref = admm_block.admm_block_plain(*ops, **kw)
    alt = plain_rowwise(ops, **kw)
    ulp = admm_block.admm_block_plain(*_ulp_perturbed(ops), **kw)
    faults = {
        "one_step_short": admm_block.admm_block_plain(
            *ops, **dict(kw, n_steps=n_steps - 1)),
        "alpha_1.5": admm_block.admm_block_plain(*ops, **dict(kw,
                                                            alpha=1.5)),
        "no_g_yB_in_rhs": _drop_g_yB(ops, kw)}
    _sync()
    worst, rows, bars, failures = 0.0, {}, [], []
    for name, a, b, c, u in zip(_OUTS, ref, got, alt, ulp):
        if not bool(torch.isfinite(b).all()):
            failures.append(f"{label}: kernel {name} is not finite")
        diff = float((b - a).abs().max())
        spread = float((c - a).abs().max())
        ulp_spread = float((u - a).abs().max())
        size = float(a.abs().max())
        tol = 1e-9 * max(1.0, size) + BAR_SPREAD * max(spread, ulp_spread)
        rows[name] = {"diff": diff, "plain_spread": spread,
                      "plain_ulp_spread": ulp_spread,
                      "plain_max": size, "tol": tol}
        bars.append(tol)
        worst = max(worst, diff)
        if not diff <= tol:
            failures.append(f"{label}: kernel {name} differs from the "
                            f"plain version by {diff:.3e} (bar {tol:.3e})")
    readings = {}
    for fault, outs in faults.items():
        ratios = [float((o - a).abs().max()) / tol
                  for o, a, tol in zip(outs, ref, bars)]
        top = max(range(len(ratios)), key=ratios.__getitem__)
        readings[fault] = {"worst_output": _OUTS[top],
                           "diff_over_bar": ratios[top]}
        if not ratios[top] >= FAULT_MARGIN:
            failures.append(f"{label}: planted fault {fault} reads only "
                            f"{ratios[top]:.3g} x the bar")
    (sink or log)(json.dumps({"check": "kernel_vs_plain", "case": label,
                              "steps": n_steps, "l_inv_pair": l_inv,
                              "bar_spread": BAR_SPREAD, "outputs": rows,
                              "planted_faults": readings}))
    return worst, failures


def with_l_inv(f, st):
    """``st`` with the L⁻¹-pair operator of the same KKT matrix."""
    import torch
    from mpisppy_tpu_torch.ops import qp_solver as T
    g = f.Eb * f.D
    M = f.A_s.T @ (f.rho_A.unsqueeze(-1) * f.A_s) \
        + torch.diag(f.P_s + f.sigma + g * g * f.rho_b)
    Lc = torch.linalg.cholesky(M)
    eye = torch.eye(M.shape[0], dtype=M.dtype, device=M.device)
    return st._replace(L=T.LInv(
        torch.linalg.solve_triangular(Lc, eye, upper=False).contiguous(), Lc))


def uc_problem(S, G, T_, dev, **kw):
    """Factors, data, a cost vector and a cold state of a UC batch."""
    import torch
    from mpisppy_tpu_torch.ir.batch import build_batch
    from mpisppy_tpu_torch.models import uc
    from mpisppy_tpu_torch.ops import qp_solver as T
    b = build_batch(uc.scenario_creator, uc.make_tree(S),
                    creator_kwargs=dict(num_gens=G, num_hours=T_, **kw),
                    vector_patch=uc.scenario_vector_patch)
    d = T.QPData(*(torch.as_tensor(a).to(dev) for a in
                   (b.P_diag[0], b.A, b.l, b.u, b.lb, b.ub)))
    q = torch.as_tensor(b.c).to(dev)
    f = T.qp_setup(d, q_ref=q)
    return f, d, q, T.qp_cold_state(f, d)


def kernel_checks(dev):
    """Phase 2: the kernel against its plain version on the card."""
    import numpy as np
    import torch
    from mpisppy_tpu_torch.ops import qp_solver as T
    from mpisppy_tpu_torch.ops.kernels import admm_block
    rng = np.random.default_rng(0)
    S, m, n = 4, 6, 4
    A = rng.normal(size=(m, n))
    mid = rng.normal(size=(S, m))
    # bounds of +-2 on x hold some of the box rows active, so the
    # compared steps move yB as well
    arrs = (np.abs(rng.normal(size=n)) + 0.5, A, mid - 3.0, mid + 3.0,
            np.full((S, n), -2.0), np.full((S, n), 2.0))
    d = T.QPData(*(torch.as_tensor(a, device=dev) for a in arrs))
    q = torch.as_tensor(rng.normal(size=(S, n)), device=dev)
    f = T.qp_setup(d, q_ref=q)
    st = T.qp_cold_state(f, d)
    cases = [(f, d, q, st, "tiny"), (f, d, q, with_l_inv(f, st), "tiny")]
    f, d, q, st = uc_problem(10, 10, 24, dev)
    # warm the iterates first so the compared steps move every block
    st = st._replace(**dict(zip(("x", "yA", "yB", "zA", "zB"),
                                admm_block.fused_admm_block(
                                    f, d, q, st, n_steps=50)[:5])))
    cases += [(f, d, q, st, "uc_10x24"),
              (f, d, q, with_l_inv(f, st), "uc_10x24")]
    failures = []
    for f, d, q, st, label in cases:
        failures += compare(f, d, q, st, 20, label)[1]
    f, d, q, st = uc_problem(256, 10, 24, dev)
    untiled = admm_block.fused_admm_block(f, d, q, st, n_steps=20,
                                          scen_tile=0)
    tiled = admm_block.fused_admm_block(f, d, q, st, n_steps=20,
                                        scen_tile=128)
    _sync()
    equal = all(torch.equal(a, b) for a, b in zip(untiled, tiled))
    log(json.dumps({"check": "tiled_vs_untiled", "S": 256, "tile": 128,
                    "bit_equal": equal}))
    if not equal:
        failures.append("scenario-tiled block differs from untiled")
    if failures:
        raise RuntimeError("kernel checks failed: " + "; ".join(failures))


class IterLog:
    """PH extension: per-iteration conv and wall seconds, and the iter-0
    (wait-and-see) primal Eobjective."""

    def __init__(self):
        self.rows = []
        self.t = None
        self.t0 = time.perf_counter()
        self.iter0_eobjective = None

    def post_solve(self, ph):
        if ph._iter == 0 and self.t is None:
            st = ph._qp_states[False]
            log(json.dumps({"phase": "iter0_solve",
                            "max_pri_rel": float(st.pri_rel.max()),
                            "max_pri_res": float(st.pri_res.max()),
                            "seconds": time.perf_counter() - self.t0}))

    def post_iter0(self, ph):
        self.iter0_eobjective = ph.Eobjective_value()
        self.t = time.perf_counter()

    def miditer(self, ph):
        now = time.perf_counter()
        self.rows.append({"iter": ph._iter, "conv": ph.conv,
                          "seconds": now - self.t})
        self.t = now

    def __getattr__(self, name):
        return lambda ph: None


def main_path(dev):
    """Phase 3: PH on the slice's configuration, on the card."""
    import numpy as np
    import torch
    from mpisppy_tpu_torch import obs
    from mpisppy_tpu_torch.core.ph import PH
    from mpisppy_tpu_torch.ir.batch import build_batch
    from mpisppy_tpu_torch.models import uc
    from mpisppy_tpu_torch.ops.kernels import admm_block

    t0 = time.perf_counter()
    batch = build_batch(uc.scenario_creator, uc.make_tree(SLICE_SCENARIOS),
                        creator_kwargs=SLICE_INSTANCE,
                        vector_patch=uc.scenario_vector_patch)
    t_batch = time.perf_counter() - t0
    # phase 21 rides this run: a telemetry session writing to a
    # temporary directory, a forensic sample every iteration
    opts = dict(PH_OPTS, forensics_interval=1)
    # x̄ and W after prox-on iteration 1: what phase 19 holds its
    # sharded run against
    it_log = Snapshot(at=1)
    on_card = torch.device(dev).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ph = PH(batch, opts, device=dev, extensions=it_log)
    _sync()
    t_ship = time.perf_counter() - t0
    log(json.dumps({"phase": "setup", "n": batch.n, "m": batch.m,
                    "S": batch.S, "K": batch.K,
                    "batch_build_s": t_batch, "ship_s": t_ship}))
    import tempfile
    tdir = tempfile.mkdtemp(prefix="telemetry_main_")
    obs.configure(out_dir=tdir)
    admm_block.LAUNCHES = 0
    t0 = it_log.t0 = time.perf_counter()
    conv, eobj, tbound = ph.ph_main()
    _sync()
    t_main = time.perf_counter() - t0
    launches = admm_block.LAUNCHES
    demotions = obs.events("kernel.cuda_demotion")
    telemetry = telemetry_in_session(ph) if on_card else None
    obs.shutdown()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9 if on_card else None

    st0 = ph._qp_states[False]
    pri0 = float(st0.pri_rel.max())
    solves = 1 + len(it_log.rows)
    expected = solves * admm_block.admm_block_launches(SLICE_BUDGET, False)
    W = ph.W
    w_sum = float((ph.prob @ W).abs().max())
    w_scale = max(1.0, float(W.abs().max()))
    factors, _ = ph._get_factors(True)
    _sync()
    t0 = time.perf_counter()
    from mpisppy_tpu_torch.ops.qp_solver import _factorize
    _factorize(factors, ph._qp_states[True].rho_scale)
    _sync()
    t_fac = time.perf_counter() - t0
    log(json.dumps({"phase": "main_path", "iter0_max_pri_rel": pri0,
                    "iter0_gate": "passed", "trivial_bound": tbound,
                    "eobjective": eobj, "conv": conv,
                    "iterations": it_log.rows,
                    "ph_main_s": t_main, "factorize_s": t_fac,
                    "phase_seconds": {str(k): v["acc"] for k, v in
                                      ph._phase_times.items()},
                    "launches": launches, "expected_launches": expected,
                    "demotions": len(demotions),
                    "sum_p_W_max": w_sum, "peak_gb": peak_gb}))
    if launches != expected or launches == 0:
        raise RuntimeError(f"admm_block launched {launches} kernels on the "
                           f"main path, expected {expected}")
    if demotions:
        raise RuntimeError(f"kernel demotion booked: {demotions}")
    if any(p.backend != "cuda" for p in ph._kernel_plans.values()):
        raise RuntimeError("a kernel plan of the main path is not cuda")
    if w_sum > 1e-8 * w_scale:
        raise RuntimeError(f"sum_s p_s W_s = {w_sum:.3e} is not 0")
    finite = [tbound, eobj, conv] + [r["conv"] for r in it_log.rows]
    if not all(np.isfinite(v) for v in finite) \
            or not bool(torch.isfinite(ph.xbar).all()):
        raise RuntimeError(f"non-finite bound or iterate: {finite}")
    if telemetry is not None:
        telemetry_main_checks(ph, tdir, telemetry, solves)
    import shutil
    shutil.rmtree(tdir, ignore_errors=True)
    return ph, launches


def telemetry_in_session(ph):
    """Phase 21, inside the main path's telemetry session: the profile's
    per-entry totals, a memory sample beside the allocator's own
    readings, and one 20-step block call at the main path's shapes
    under torch.profiler, whose record_function range named after the
    block's profile entry (obs/trace.py's bridge) must appear by name.
    The call's launches are not the path's. Returns what
    telemetry_main_checks holds."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from mpisppy_tpu_torch.obs import profile as obs_profile
    from mpisppy_tpu_torch.obs import resource
    from mpisppy_tpu_torch.ops import kernels
    from mpisppy_tpu_torch.ops.kernels import admm_block
    totals = obs_profile.entry_totals()
    sample = resource.sample_memory()
    mem = {"bytes_in_use": torch.cuda.memory_allocated(0),
           "peak_bytes_in_use": torch.cuda.max_memory_allocated(0)}
    factors, data = ph._get_factors(True)
    st = ph._qp_states[True]
    q, _, _ = _assembled_q(ph, data)
    plan = kernels.prepare(factors, mode="fused", backend="cuda")
    saved = admm_block.LAUNCHES
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        kernels.kernel_solve(plan, factors, data, q, st,
                             precision="native", max_iter=20, tail_iter=0,
                             e_pri=1e-5, e_dua=1e-2, stall_rel=0.0,
                             polish=False, polish_chunk=2, ir_sweeps=1)
        _sync()
    admm_block.LAUNCHES = saved
    ranges = {e.key: e for e in prof.key_averages()}
    span = ranges.get("kernel.cuda")
    return {"totals": totals, "sample": sample, "mem": mem,
            "profiler_range": None if span is None else {
                "count": span.count,
                "cpu_time_total_us": span.cpu_time_total}}


def telemetry_main_checks(ph, tdir, tel, solves):
    """Phase 21 on the main path's artifacts (the session is closed):
    the files parse and ``analyze`` renders every section with every
    invariant PASS, profile.device names the card and its peaks, the
    block entry booked the byte formula for the path's calls, the
    prox-on iteration's hbm_util lies in (0, 1.05], the memory gauges
    equal the allocator's readings at the sample, the forensic sample
    decomposes conv, and the profiler saw the block's range. Prints one
    JSON line; raises on a failed check."""
    import torch
    from mpisppy_tpu_torch.obs import analyze
    from mpisppy_tpu_torch.ops import forensics
    failures = []
    run = analyze.load_run(tdir)
    report = analyze.render_report(run)
    checks = analyze.invariant_checks(run)
    bad = [(n, d) for n, ok, d, _ in checks if not ok]
    if bad:
        failures.append(f"analyze invariants not PASS: {bad}")
    names = {n for n, *_ in checks}
    if "gate_syncs_per_solve_call_O1" not in names:
        failures.append("no gate-sync invariant in the report")
    for sec in ("== phase breakdown ==", "== roofline ==",
                "== forensics ==", "== invariant checks =="):
        if sec not in report:
            failures.append(f"analyze report lacks {sec}")
    rf = analyze.roofline_summary(run)
    dev = (rf or {}).get("device") or {}
    kind = torch.cuda.get_device_name(0)
    if dev.get("device_kind") != kind or dev.get("peak_flops") != 67e12 \
            or dev.get("peak_hbm_gbps") != 3350.0:
        failures.append(f"profile.device {dev} does not name the card "
                        f"{kind!r} and its peaks")
    m, n = ph.batch.m, ph.batch.n
    # the block's byte floor, written out here: per step A and F once,
    # then one pass of A, f64
    want = solves * 8 * (SLICE_BUDGET * (m * n + n * n) + m * n)
    blk = tel["totals"].get("kernel.cuda", {})
    if blk.get("calls") != solves or blk.get("bytes") != want:
        failures.append(f"kernel.cuda booked {blk}, expected {solves} "
                        f"calls and {want} bytes")
    recs = analyze.iteration_rows(run)
    prof = (recs[-1].get("profile") or {}) if recs else {}
    util, mfu = prof.get("hbm_util"), prof.get("mfu")
    if util is None or not 0.0 < util <= 1.05:
        failures.append(f"prox-on hbm_util {util} outside (0, 1.05]")
    peak_gauge = run.gauges().get("mem.cuda0.peak_bytes_in_use")
    samp = tel["sample"].get("cuda0", {})
    if samp != tel["mem"] or peak_gauge is None:
        failures.append(f"memory sample {samp} != allocator {tel['mem']} "
                        f"(gauge {peak_gauge})")
    fx = ph._forensic_last or {}
    if fx.get("conv") is None or abs(fx["conv"] - ph.conv) \
            > 1e-12 * abs(ph.conv):
        failures.append(f"forensic conv {fx.get('conv')} != conv "
                        f"{ph.conv}")
    # every slot on the leaderboard: the masses sum to K · conv
    xn = ph.nonants_of(ph.x)
    K = xn.shape[1]
    st0 = forensics.init_state(*xn.shape, dtype=xn.dtype, device=xn.device)
    _, packed = forensics.forensic_reduce(
        st0, xn, ph.xbar, ph.W, ph.prob, ph.rho, kk=K,
        ks=min(forensics.TOPK, ph._S_orig))
    full = forensics.unpack(packed, K, min(forensics.TOPK, ph._S_orig))
    mass = sum(v for _, v in full["top_slots"])
    if abs(mass / K - full["conv"]) > 1e-12 * abs(full["conv"]) \
            or abs(full["conv"] - ph.conv) > 1e-12 * abs(ph.conv):
        failures.append(f"slot masses / K {mass / K} vs conv "
                        f"{full['conv']} vs engine {ph.conv}")
    if tel["profiler_range"] is None:
        failures.append("torch.profiler saw no 'kernel.cuda' range")
    log(json.dumps({
        "phase": "telemetry_main", "iterations": [
            {k: r.get(k) for k in ("iter", "seconds", "conv")}
            | {"profile": r.get("profile")} for r in recs],
        "prox_on_hbm_util": util, "prox_on_mfu": mfu,
        # PERF.md §6's figure for the same iteration: the block at 54 %
        # of its byte bound (H100 80GB HBM3 at 700 W)
        "perf_md_block_byte_bound_share": 0.54,
        "kernel_cuda": blk, "qp_solve": tel["totals"].get("qp.solve"),
        "memory_sample": samp, "memory_allocator": tel["mem"],
        "forensics": {k: fx.get(k) for k in ("conv", "pri_total",
                                             "top_slots",
                                             "scen_pri_shares")},
        "slot_mass_over_K": mass / K, "profiler_range":
            tel["profiler_range"],
        "invariants": [[n, ok] for n, ok, *_ in checks],
        "failures": failures}))
    if failures:
        raise RuntimeError("telemetry (main path) failed: "
                           + "; ".join(failures))


def block_bound(S, m, n, steps):
    """(bytes floor, operations floor) in ms of one ``steps``-step block
    call on S rows: the least time for the same work is the larger.
    A (m x n) and F (n x n) are gigabytes, far over the 50 MB L2, and
    every step reads the previous step's result through them, so each is
    read at least once per step; the residual tail reads A once more.
    The vectors: scalings (6n + 2m), scaled problem vectors (3Sn + 2Sm),
    iterates in and out (2 x (3Sn + 2Sm)), pri and dua (2S). The
    operations are f64 at the card's f64 peak."""
    vec_bytes = 8 * (6 * n + 2 * m + 9 * S * n + 6 * S * m + 2 * S)
    bytes_floor = steps * 8 * (m * n + n * n) + 8 * m * n + vec_bytes
    flops = steps * (4 * S * m * n + 2 * S * n * n) + 4 * S * m * n
    return (bytes_floor / HBM_BYTES_PER_S * 1e3,
            flops / F64_FLOP_PER_S * 1e3)


def time_block(ph, steps, reps):
    """Phase 4: the block at the main path's shapes, from the engine's
    prox-on state: kernel vs plain, the timings and the bounds."""
    import torch
    from mpisppy_tpu_torch.ops.kernels import admm_block
    from mpisppy_tpu_torch.ops.qp_solver import LInv
    factors, data = ph._get_factors(True)
    st = ph._qp_states[True]
    q, _, _ = _assembled_q(ph, data)
    err, failures = compare(factors, data, q, st, steps, "main_path_shapes")
    if failures:
        raise RuntimeError("kernel checks failed: " + "; ".join(failures))
    ops = block_operands(factors, data, q, st)
    A, F = ops[0], ops[1]
    S, n = st.x.shape
    m = st.zA.shape[1]

    def kern():
        admm_block.fused_admm_block(factors, data, q, st, n_steps=steps,
                                    sigma=factors.sigma, scen_tile=0)

    def plain():
        admm_block.admm_block_plain(*ops, sigma=factors.sigma,
                                    n_steps=steps, alpha=ALPHA)

    w = torch.randn(S, m, dtype=A.dtype, device=A.device)
    v = torch.randn(S, n, dtype=A.dtype, device=A.device)

    def library():
        for _ in range(steps):
            torch.matmul(w, A)
            torch.matmul(v, F)
            torch.matmul(v, A.T)

    def library_with_tail():
        # the same with the residual tail's two products (x·Aᵀ, yA·A),
        # which the block also computes once per call
        library()
        torch.matmul(v, A.T)
        torch.matmul(w, A)

    def kern_l_inv():
        # the L⁻¹-pair operator's products at the same shapes; F stands in
        # for L⁻¹ (the kernel's time does not depend on the values)
        admm_block.fused_admm_block(factors, data, q,
                                    st._replace(L=LInv(F, F)),
                                    n_steps=steps, sigma=factors.sigma,
                                    scen_tile=0)

    before = admm_block.LAUNCHES
    t = {"plain": [], "kernel": [], "library": [], "library_with_tail": []}
    for name, fn in (("plain", plain), ("kernel", kern),
                     ("kernel", kern), ("plain", plain),
                     ("library", library),
                     ("library_with_tail", library_with_tail)):
        t[name].append(cuda_ms(fn, reps))
    breakdown = kernel_breakdown(kern)
    products = product_table(breakdown, kernel_breakdown(kern_l_inv), S,
                             m, n, steps)
    library_breakdown = kernel_breakdown(library_with_tail)
    admm_block.LAUNCHES = before   # timing launches are not the path's
    ms = sum(t["kernel"]) / len(t["kernel"])
    plain_ms = sum(t["plain"]) / len(t["plain"])
    lib_ms = t["library"][0]
    t_bytes, t_ops = block_bound(S, m, n, steps)
    # what the design streams: one pass per matrix per step (2 A + F),
    # plus the tail's 2 A, at the data-sheet bandwidth (computed, not
    # measured)
    stream_ms = (steps * 8 * (2 * m * n + n * n) + 16 * m * n) \
        / HBM_BYTES_PER_S * 1e3
    log(json.dumps({"phase": "block_timing", "steps_per_call": steps,
                    "measured_ms": t, "device_ms_by_kernel": breakdown,
                    "computed_one_pass_bound_ms": stream_ms,
                    "products": products,
                    "products_note": "the block's kernels launch with "
                    "programmatic dependent launch, so a kernel's span "
                    "starts while its predecessor drains: a sum kernel's "
                    "span includes that wait",
                    "device_ms_total": sum(v["ms"] for v in
                                           breakdown.values()),
                    "library_device_ms_by_kernel": library_breakdown,
                    "library_with_tail_device_ms_total": sum(
                        v["ms"] for v in library_breakdown.values())}))
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "library_ms": lib_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "ms_per_step": ms / steps}


# kernel name -> (product, the matrix it streams, its reduction axis)
# in csrc/admm_block.cu; the *_sum kernels add a product's partials
PRODUCTS = {"k1_rhs": ("K1 w·A", "A", "A_col"),
            "linv1": ("LINV1 rhs·Fᵀ", "F", "F_row"),
            "k2_xupd": ("K2 rhs·F", "F", "F_col"),
            "k3_za": ("K3 x̃·Aᵀ", "A", "A_row"),
            "pri_rows": ("tail x·Aᵀ", "A", "A_row"),
            "dua_cols": ("tail yA·A", "A", "A_col")}


def product_table(breakdown, breakdown_l_inv, S, m, n, steps):
    """Per product of the block: device ms per step (per call for the
    tail) from the profiler, beside the computed time to stream its
    matrix once at the data-sheet bandwidth; for each sum kernel, the
    computed time to read its partials once. LINV1 comes from the call
    with the L⁻¹-pair operator; the rest from the M⁻¹ call."""
    import re
    from mpisppy_tpu_torch.ops.kernels import admm_block
    sched = admm_block.block_schedule(m, n)
    mat = {"A": 8 * m * n, "F": 8 * n * n}
    out_len = {"A_col": n, "F_col": n, "F_row": n, "A_row": m}
    by_name = {}
    for src, bd in (("m_inv", breakdown), ("l_inv", breakdown_l_inv)):
        for key, v in bd.items():
            hit = re.search(r"(\w+?)(_sum)?(?:<\d+>)?\(", key)
            if hit and hit.group(1) in PRODUCTS:
                by_name.setdefault((src, hit.group(1) + (hit.group(2) or "")),
                                   v)
    rows = {}
    for name, (label, matrix, axis) in PRODUCTS.items():
        src = "l_inv" if name == "linv1" else "m_inv"
        per = 1 if name in ("pri_rows", "dua_cols") else steps
        unit = "call" if per == 1 else "step"
        parts = sched[axis][0]
        for kname, bytes_once in (
                (name, mat[matrix]),
                (name + "_sum", 8 * (parts + 1) * S * out_len[axis])):
            got = by_name.get((src, kname))
            rows[kname] = {
                "product": label + (" partial sums" if kname != name
                                    else ""),
                "parts": parts,
                f"device_ms_per_{unit}": (got["ms"] / per if got else None),
                f"one_pass_ms_per_{unit}":
                    bytes_once / HBM_BYTES_PER_S * 1e3,
                "calls": got["calls"] if got else 0}
    return rows


def kernel_breakdown(fn):
    """Device milliseconds per CUDA kernel name over one call of ``fn``
    (torch.profiler; empty if the profiler sees no device activity)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None)
        if us is None:
            us = getattr(ev, "cuda_time_total", 0.0)
        if us:
            out[ev.key[:80]] = {"ms": us / 1e3, "calls": ev.count}
    return out


def _assembled_q(ph, data):
    """The prox-on linear cost of the engine's current iteration."""
    from mpisppy_tpu_torch.core.ph import _ph_assemble
    return _ph_assemble(data, ph.c, ph.W, ph.xbar, ph.rho, ph.nonant_idx,
                        ph._fixed_mask, ph._fixed_vals, ph._w_scale,
                        w_on=True, prox_on=True)


class Snapshot(IterLog):
    """IterLog that also keeps x̄ and W after prox-on iteration ``at``."""

    def __init__(self, at=1):
        super().__init__()
        self.at = at
        self.xbar = self.W = None

    def miditer(self, ph):
        super().miditer(ph)
        if ph._iter == self.at:
            self.xbar, self.W = ph.xbar.clone(), ph.W.clone()


def _max_rel_diff(ref, got):
    """max |got - ref| / max(1, max |ref|)."""
    return float((got - ref).abs().max()) / max(1.0,
                                                float(ref.abs().max()))


def chunk_batch():
    """The S = CHUNK_SCENARIOS reference-scale UC batch that the chunked
    and df32 paths share (built once). Returns (batch, seconds)."""
    from mpisppy_tpu_torch.ir.batch import build_batch
    from mpisppy_tpu_torch.models import uc
    t0 = time.perf_counter()
    batch = build_batch(uc.scenario_creator, uc.make_tree(CHUNK_SCENARIOS),
                        creator_kwargs=SLICE_INSTANCE,
                        vector_patch=uc.scenario_vector_patch)
    return batch, time.perf_counter() - t0


def chunked_path(dev, batch, t_batch):
    """Phase 5: the scenario-chunked PH loop on the card. Returns the
    operands block_scaling tiles, the block launches of its run, the
    block's largest difference from its plain version at this path's
    shapes, the run's iter-0 primal Eobjective and max pri_rel, its
    Eobjective and trivial bound, and the list of failed checks; prints
    one JSON line."""
    import numpy as np
    import torch
    from mpisppy_tpu_torch import obs
    from mpisppy_tpu_torch.core.ph import PH
    from mpisppy_tpu_torch.ops.kernels import admm_block

    opts = {**PH_OPTS, "subproblem_chunk": CHUNK,
            "subproblem_hospital": False, "PHIterLimit": CHUNK_ITERS}
    on_card = torch.device(dev).type == "cuda"
    snap = Snapshot(at=1)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    ph = PH(batch, opts, device=dev, extensions=snap)
    obs.configure()
    admm_block.LAUNCHES = 0
    t0 = snap.t0 = time.perf_counter()
    conv, eobj, tbound = ph.ph_main()
    _sync()
    t_main = time.perf_counter() - t0
    launches = admm_block.LAUNCHES
    counters = obs.counters_snapshot()
    demotions = obs.events("kernel.cuda_demotion")
    retries = [e[1] for e in obs.events("ph.chunk_retry")]
    obs.shutdown()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9 if on_card else None

    n_chunks = len(ph._chunk_index(CHUNK))
    solves = 1 + len(snap.rows)
    expected = n_chunks * solves \
        * admm_block.admm_block_launches(SLICE_BUDGET, False)
    pri0 = float(ph._qp_states[False].pri_rel.max())
    W = ph.W
    w_sum = float((ph.prob @ W).abs().max())
    w_scale = max(1.0, float(W.abs().max()))
    timing = {str(k): ph.phase_timing(k) for k in (False, True)}
    blacklisted = {"chunks": {str(k): sorted(v) for k, v in
                              ph._chunk_no_retry.items()},
                   "hospital": {str(k): sorted(v) for k, v in
                                ph._hospital_no_retry.items()}}
    failures = []
    if pri0 >= 1e-3:
        failures.append(f"iter-0 max pri_rel {pri0:.3e} is not below 1e-3")
    if launches != expected or launches == 0:
        failures.append(f"admm_block launched {launches} kernels on the "
                        f"chunked path, expected {expected} ({n_chunks} "
                        f"chunks x {solves} solves)")
    if demotions:
        failures.append(f"kernel demotion booked: {demotions}")
    if any(p.backend != "cuda" for p in ph._kernel_plans.values()):
        failures.append("a kernel plan of the chunked path is not cuda")
    for k, t in timing.items():
        if t["gate_d2h_syncs_per_call"] != 1.0:
            failures.append(f"mode {k}: {t['gate_d2h_syncs_per_call']} "
                            "gate syncs per call, expected 1")
    if w_sum > 1e-8 * w_scale:
        failures.append(f"sum_s p_s W_s = {w_sum:.3e} is not 0")
    finite = [tbound, eobj, conv] + [r["conv"] for r in snap.rows]
    if not all(np.isfinite(v) for v in finite) \
            or not bool(torch.isfinite(ph.xbar).all()):
        failures.append(f"non-finite bound, conv or x̄: {finite}")
    # the kernel against its plain version at this path's shapes: the
    # first chunk and the padded last one, from the prox-on chunk states
    states = ph._chunk_states[True]
    scaling_ops = _scaling_operands(ph, states, 0)
    err = 0.0
    for ops, label in ((scaling_ops, "chunked_path_shapes"),
                       (_scaling_operands(ph, states, n_chunks - 1),
                        "chunked_path_shapes_padded")):
        e, f = compare(*ops, 20, label)
        err, failures = max(err, e), failures + f
    # the same batch unchunked, iter 0 and one prox-on iteration
    xbar1, W1 = snap.xbar, snap.W
    del ph, states
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    ref = PH(batch, {**PH_OPTS, "PHIterLimit": 1}, device=dev)
    ref.ph_main()
    _sync()
    admm_block.LAUNCHES = launches   # the comparison's are not the path's
    d_xbar = _max_rel_diff(ref.xbar, xbar1)
    d_W = _max_rel_diff(ref.W, W1)
    if not (d_xbar <= 1e-9 and d_W <= 1e-9):
        failures.append(f"chunked differs from unchunked after one "
                        f"prox-on iteration: x̄ {d_xbar:.3e}, W {d_W:.3e} "
                        "(bar 1e-9 x max(1, |.|))")
    del ref
    gc.collect()
    rows = snap.rows
    log(json.dumps({
        "phase": "chunked_path", "S": CHUNK_SCENARIOS, "chunk": CHUNK,
        "chunks": n_chunks, "n": batch.n, "m": batch.m,
        "batch_build_s": t_batch, "ph_main_s": t_main,
        "iterations": rows,
        "ph_s_per_iteration": [r["seconds"] for r in rows],
        "phase_seconds": {k: t["seconds_per_call"] for k, t in
                          timing.items()},
        "occupancy": {k: t["occupancy"] for k, t in timing.items()},
        "gate_d2h_syncs_per_call": {k: t["gate_d2h_syncs_per_call"]
                                    for k, t in timing.items()},
        "iter0_max_pri_rel": pri0,
        "iter0_eobjective": snap.iter0_eobjective,
        "trivial_bound": tbound, "eobjective": eobj, "conv": conv,
        "retries": len(retries), "retry_events": retries,
        "blacklisted": blacklisted,
        "gate_syncs_total": counters.get("ph.gate_syncs"),
        "launches": launches, "expected_launches": expected,
        "demotions": len(demotions), "sum_p_W_max": w_sum,
        "peak_gb": peak_gb,
        "unchunked_max_rel_diff": {"xbar": d_xbar, "W": d_W}}))
    native = {"iter0_eobjective": snap.iter0_eobjective,
              "iter0_max_pri_rel": pri0, "eobjective": eobj,
              "trivial_bound": tbound,
              "ph_s_per_iteration": [r["seconds"] for r in rows],
              "ph_main_s": t_main}
    return scaling_ops, launches, err, native, failures


def _scaling_operands(ph, states, ci):
    """(factors, data, q, state) of the engine's prox-on chunk ``ci``;
    those of chunk 0 are the operands block_scaling tiles."""
    from mpisppy_tpu_torch.core.ph import _ph_assemble
    factors, data = ph._get_factors(True)
    idx, _ = ph._chunk_index(CHUNK)[ci]
    d = data._replace(l=data.l[idx], u=data.u[idx], lb=data.lb[idx],
                      ub=data.ub[idx])
    q, bl, bu = _ph_assemble(d, ph.c[idx], ph.W[idx], ph.xbar[idx],
                             ph.rho[idx], ph.nonant_idx,
                             ph._fixed_mask[idx], ph._fixed_vals[idx],
                             None, w_on=True, prox_on=True)
    return factors, d._replace(lb=bl, ub=bu), q, states[ci]


def block_scaling(ops, steps=20, reps=2):
    """Phase 6: one ``steps``-step block call at full width for each row
    count in SCALING_ROWS, the chunk's rows tiled to it. Prints ms per
    step and per scenario-step beside the groups on grid.y, the
    one-pass streaming time of groups x (2A + F) per step, the plain
    version's and the library's time."""
    import torch
    from mpisppy_tpu_torch.ops import qp_solver as T
    from mpisppy_tpu_torch.ops.kernels import admm_block
    factors, d, q, st = ops
    S0 = st.x.shape[0]
    m, n = factors.A_s.shape
    before = admm_block.LAUNCHES
    rows = []
    for S in SCALING_ROWS:
        rep = -(-S // S0)

        def tile(t, S=S, rep=rep):
            return t.repeat((rep,) + (1,) * (t.ndim - 1))[:S].contiguous()

        d_s = d._replace(l=tile(d.l), u=tile(d.u), lb=tile(d.lb),
                         ub=tile(d.ub))
        st_s = st._replace(x=tile(st.x), yA=tile(st.yA), yB=tile(st.yB),
                           zA=tile(st.zA), zB=tile(st.zB))
        q_s = tile(q)
        ms = cuda_ms(lambda: admm_block.fused_admm_block(
            factors, d_s, q_s, st_s, n_steps=steps, sigma=factors.sigma,
            scen_tile=0), reps)
        ops_s = block_operands(factors, d_s, q_s, st_s)
        kw = dict(sigma=factors.sigma, n_steps=steps, alpha=ALPHA,
                  l_inv_pair=isinstance(st.L, T.LInv))
        plain_ms = cuda_ms(lambda: admm_block.admm_block_plain(*ops_s,
                                                                **kw), reps)
        A, F = factors.A_s, st.L
        w = torch.randn(S, m, dtype=A.dtype, device=A.device)
        v = torch.randn(S, n, dtype=A.dtype, device=A.device)

        def library():
            # the step's three products as library calls
            for _ in range(steps):
                torch.matmul(w, A)
                torch.matmul(v, F)
                torch.matmul(v, A.T)

        lib_ms = cuda_ms(library, reps)
        groups = -(-S // admm_block.SCEN_GROUP)
        stream_ms = groups * 8 * (2 * m * n + n * n) \
            / HBM_BYTES_PER_S * 1e3
        # one step's floors: A and F read once, 2S(2mn + n²) f64 flops
        bytes_ms = 8 * (m * n + n * n) / HBM_BYTES_PER_S * 1e3
        ops_ms = 2 * S * (2 * m * n + n * n) / F64_FLOP_PER_S * 1e3
        rows.append({"S": S, "ms_per_call": ms, "ms_per_step": ms / steps,
                     "ms_per_scenario_step": ms / steps / S,
                     "groups": groups,
                     "streaming_ms_per_step": stream_ms,
                     "plain_ms_per_step": plain_ms / steps,
                     "library_ms_per_step": lib_ms / steps,
                     "bound_ms_per_step": max(bytes_ms, ops_ms),
                     "bound_by": "bytes" if bytes_ms >= ops_ms
                     else "operations",
                     "byte_floor_ms_per_step": bytes_ms,
                     "compute_floor_ms_per_step": ops_ms})
    admm_block.LAUNCHES = before   # timing launches are not the path's
    log(json.dumps({"phase": "block_scaling", "steps_per_call": steps,
                    "reps": reps, "rows": rows}))
    return {r["S"]: r["ms_per_step"] for r in rows}


# the JAX package's df32 recipe for the reference instance, bench.py's
# DF32 dict unchanged (packed-f32 bulk, packed split-f32 IR tail, L⁻¹
# products in the tail, hospital off)
DF32 = {
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
}
# the JAX bench runs S = 1024 in chunks of 128; cut to the chunked
# path's S = 34 in chunks of 16 for the run's time, and to DF32_ITERS
# PH iterations (3 until a cut in depth)
DF32_CHUNK = 16
DF32_ITERS = 2
# the engine's iter-0 feasibility gate as the JAX bench sets it beside
# the DF32 dict (bench.py:640 for its PH hub, :697 for its gap warm-up)
DF32_ITER0_TOL = 5e-3
# rows per call of df32_scaling (beside block_scaling's native rows)
DF32_SCALING_ROWS = (16, 128)
# steps per timed df32 call (one residual check at the end; 100, with
# two timed calls per piece, until the serve phase)
DF32_STEPS = 50
# the split matvec's f32 floor, relative to each row's sum of |terms|
SPLIT_FLOOR = 2e-6


def _df32_operands(ph, ci=0):
    """(factors, data, q, state) of the df32 engine's prox-on chunk
    ``ci``, with the flowed factor (LInv or raw) of the last pass."""
    from mpisppy_tpu_torch.core.ph import _ph_assemble
    factors, data = ph._get_factors(True)
    idx, _ = ph._chunk_index(DF32_CHUNK)[ci]
    d = data._replace(l=data.l[idx], u=data.u[idx], lb=data.lb[idx],
                      ub=data.ub[idx])
    q, bl, bu = _ph_assemble(d, ph.c[idx], ph.W[idx], ph.xbar[idx],
                             ph.rho[idx], ph.nonant_idx,
                             ph._fixed_mask[idx], ph._fixed_vals[idx],
                             None, w_on=True, prox_on=True)
    return factors, d._replace(lb=bl, ub=bu), q, ph._chunk_states[True][ci]


def packed_fault_check(factors, dev):
    """The packed split matvec against the dense split matvec of the same
    scaled matrix on the card, row by row against SPLIT_FLOOR x the row's
    sum of |terms|, and a planted fault (one value of pk_hi changed by
    1 %) that must read at least FAULT_MARGIN x that bar."""
    import torch
    from mpisppy_tpu_torch.ops import packed
    from mpisppy_tpu_torch.ops import qp_solver as T
    A = factors.A_s
    m, n = A.shape
    g = torch.Generator(device="cpu").manual_seed(11)
    x = torch.randn(DF32_CHUNK, n, generator=g,
                    dtype=torch.float64).to(dev)
    xh, xl = T._split_vec(x)
    dense = T._Ax(T.SplitMatrix(A.hi, A.lo), x)
    scale = xh.abs() @ A.hi.abs().T

    def worst(pk_hi):
        got = packed.pk_Ax_split(pk_hi, A.pk_lo, xh, xl, m)
        return float(((got - dense).abs() / scale.clamp(min=1e-300)).max())

    ok = worst(A.pk_hi)
    c, r, k = (int(v) for v in torch.nonzero(A.pk_hi.l_vals)[0])
    vals = A.pk_hi.l_vals.clone()
    vals[c, r, k] *= 1.01
    hit = worst(A.pk_hi._replace(l_vals=vals))
    row = {"check": "packed_vs_dense_split", "rows": DF32_CHUNK,
           "worst_rel_to_row_abs_sum": ok, "bar": SPLIT_FLOOR,
           "planted_fault_over_bar": hit / SPLIT_FLOOR,
           "packed_mb": (packed.pk_nbytes(A.pk_hi)
                         + packed.pk_nbytes(A.pk_lo)) / 1e6,
           "dense_split_mb": 8 * m * n / 1e6}
    log(json.dumps(row))
    failures = []
    if not ok <= SPLIT_FLOOR:
        failures.append(f"packed split matvec differs from the dense one "
                        f"by {ok:.3e} of the row sums (bar {SPLIT_FLOOR})")
    if not hit >= FAULT_MARGIN * SPLIT_FLOOR:
        failures.append(f"planted pk_hi fault reads only "
                        f"{hit / SPLIT_FLOOR:.3g} x the bar")
    return failures


def df32_step_timing(factors, d, q, st, plan, reps=1, profile=False):
    """CUDA-event ms of one chunk's df32 pieces: the split factorization,
    the L⁻¹ build, a DF32_STEPS-step f32 bulk call and a DF32_STEPS-step
    df32 tail call (fixed rho, no exit, one residual check), each beside
    est_hbm_bytes_per_iter's byte model at the data-sheet bandwidth;
    with ``profile``, the top kernels of each step by device time."""
    import torch
    from mpisppy_tpu_torch.ops import kernels, packed
    from mpisppy_tpu_torch.ops import qp_solver as T
    if torch.get_float32_matmul_precision() != "highest" \
            or torch.backends.cuda.matmul.allow_tf32 is not False:
        raise RuntimeError("TF32 is on: df32 needs true f32 products")
    S = st.x.shape[0]
    m, n = factors.A_s.shape
    rho = st.rho_scale
    L = T._factorize(factors, rho)
    L_pair = T.make_l_inv(L)
    kw = dict(max_iter=DF32_STEPS, check_every=DF32_STEPS, eps_abs=0.0,
              eps_rel=0.0, adaptive_rho=False, polish=False)
    lo = torch.float32
    f_lo = T._cast_floats(factors._replace(A_s=None), lo)._replace(
        A_s=plan.A_lo)
    d_lo = T._cast_floats(d._replace(A=plan.A_lo), lo)
    st_lo = T._cast_floats(st._replace(L=L), lo)
    st_hi = st._replace(L=L_pair if plan.l_inv else L)
    def bulk():
        T.qp_solve(f_lo, d_lo, q.to(lo), st_lo, **kw)

    def tail():
        T.qp_solve(factors, d, q, st_hi, **kw)

    fac_ms = cuda_ms(lambda: T._factorize(factors, rho), reps)
    linv_ms = cuda_ms(lambda: T.make_l_inv(L), reps)
    bulk_ms = cuda_ms(bulk, reps) / DF32_STEPS
    tail_ms = cuda_ms(tail, reps) / DF32_STEPS
    pk_bytes = packed.pk_nbytes(factors.A_s.pk_hi) \
        + packed.pk_nbytes(factors.A_s.pk_lo)
    model = kernels.est_hbm_bytes_per_iter(
        n=n, m=m, s_chunk=S, pk_pass_bytes=pk_bytes)
    # the factorization reads the dense hi once and writes an n x n
    # factor; the L⁻¹ build reads and writes one n x n f32 matrix
    fac_bytes = 4 * m * n + 4 * n * n
    return {"rows": S, "factorize_ms": fac_ms,
            "factorize_model_ms": fac_bytes / HBM_BYTES_PER_S * 1e3,
            "l_inv_build_ms": linv_ms,
            "l_inv_model_ms": 8 * n * n / HBM_BYTES_PER_S * 1e3,
            "bulk_ms_per_step": bulk_ms,
            "bulk_model_ms_per_step": model["bulk"] / HBM_BYTES_PER_S * 1e3,
            "tail_ms_per_step": tail_ms,
            "tail_model_ms_per_step": model["tail"] / HBM_BYTES_PER_S * 1e3,
            "model_bytes": model, "packed_pass_bytes": pk_bytes,
            "device_ms_per_step_by_kernel": {
                "bulk": _top_kernels(bulk, DF32_STEPS),
                "tail": _top_kernels(tail, DF32_STEPS)} if profile else None}


def _top_kernels(fn, steps, top=8):
    """The ``top`` CUDA kernels of one call of ``fn`` by device time,
    in ms per step (torch.profiler)."""
    rows = sorted(kernel_breakdown(fn).items(), key=lambda kv: -kv[1]["ms"])
    return {k: {"ms_per_step": v["ms"] / steps, "calls": v["calls"]}
            for k, v in rows[:top]}


def native_reference(dev, batch):
    """Phase 7a: the native chunked PH loop on the same batch and for
    the same iterations as df32_path, on the reference backend (rho
    adapts; the chunked path's block holds rho fixed for its whole
    budget, so its objectives depend on that budget: on UC 10 x 24 its
    iter-0 Eobjective reads 22 % above the optimum in both packages,
    tests/test_torch_df32_recipe.py). Returns (iter-0 primal
    Eobjective, iter-0 max pri_rel, certified trivial bound,
    Eobjective); prints one JSON line."""
    import torch
    from mpisppy_tpu_torch.core.ph import PH
    from mpisppy_tpu_torch.ops.kernels import admm_block

    opts = {**PH_OPTS, "subproblem_chunk": DF32_CHUNK,
            "subproblem_hospital": False,
            "subproblem_kernel_backend": "reference",
            "PHIterLimit": DF32_ITERS}
    it_log = IterLog()
    launches = admm_block.LAUNCHES
    ph = PH(batch, opts, device=dev, extensions=it_log)
    t0 = it_log.t0 = time.perf_counter()
    conv, eobj, tbound = ph.ph_main()
    _sync()
    t_main = time.perf_counter() - t0
    admm_block.LAUNCHES = launches
    pri0 = float(ph._qp_states[False].pri_rel.max())
    row = {"phase": "native_reference", "S": batch.S, "chunk": DF32_CHUNK,
           "backend": "reference", "ph_main_s": t_main,
           "iterations": it_log.rows,
           "iter0_max_pri_rel": pri0,
           "iter0_eobjective": it_log.iter0_eobjective,
           "trivial_bound": tbound, "eobjective": eobj, "conv": conv,
           "plans": sorted({p.backend for p in ph._kernel_plans.values()})}
    log(json.dumps(row))
    del ph
    gc.collect()
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()
    return row


def df32_path(dev, batch, native, ref):
    """Phase 7b: the JAX bench's df32 recipe through PH(...).ph_main() on
    the chunked path's batch, held to: the engine's own iter-0 gate
    (raised inside ph_main, at the bench's DF32_ITER0_TOL), post-solve
    prox-on max pri_rel below 5e-3, an Eobjective within 2e-2 relative
    of the native reference-backend run's (``ref``, native_reference),
    a certified trivial bound at most each native run's iter-0 primal
    Eobjective (``native``: the chunked path's; and ``ref``'s) plus 1e-4
    relative, no launch of the ADMM block, the view swap and the packed
    split matvec on the card (packed_fault_check). Returns the engine
    and its failed checks; prints one JSON line."""
    import numpy as np
    import torch
    from mpisppy_tpu_torch import obs
    from mpisppy_tpu_torch.core.ph import PH
    from mpisppy_tpu_torch.ops import qp_solver as T
    from mpisppy_tpu_torch.ops.kernels import admm_block

    opts = {**DF32, "subproblem_chunk": DF32_CHUNK,
            "PHIterLimit": DF32_ITERS, "iter0_feas_tol": DF32_ITER0_TOL}
    it_log = IterLog()
    on_card = torch.device(dev).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ph = PH(batch, opts, device=dev, extensions=it_log)
    _sync()
    t_ship = time.perf_counter() - t0
    raw_split = isinstance(ph.qp_data.A, T.SplitMatrix) \
        and ph.qp_data.A.struct is not None
    obs.configure()
    admm_block.LAUNCHES = 0
    t0 = it_log.t0 = time.perf_counter()
    conv, eobj, tbound = ph.ph_main()
    _sync()
    t_main = time.perf_counter() - t0
    launches = admm_block.LAUNCHES
    counters = obs.counters_snapshot()
    retries = [e[1] for e in obs.events("ph.chunk_retry")]
    obs.shutdown()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9 if on_card else None
    pri0 = float(ph._qp_states[False].pri_rel.max())
    pri_on = float(ph._qp_states[True].pri_rel.max())
    timing = ph.phase_timing(True)
    plan = ph._kernel_plans[True]
    failures = []
    if not raw_split:
        failures.append("the df32 engine did not ship a packed split A")
    if not isinstance(ph.qp_data.A, T.ScaledView):
        failures.append("the engine's A was not swapped for the view")
    if launches != 0:
        failures.append(f"admm_block launched {launches} times on the "
                        "df32 path (df32 never enters the block)")
    if not pri_on < 5e-3:
        failures.append(f"post-solve prox-on max pri_rel {pri_on:.3e} "
                        "is not below 5e-3")
    eobj_rel = (eobj - ref["eobjective"]) / abs(ref["eobjective"])
    if not abs(eobj_rel) <= 2e-2:
        failures.append(f"Eobjective {eobj:.6f} is {eobj_rel:+.3e} "
                        "relative to the native reference run's "
                        f"{ref['eobjective']:.6f} (band 2e-2)")
    for name, run in (("chunked path", native), ("reference run", ref)):
        primal = run["iter0_eobjective"]
        if not tbound <= primal + 1e-4 * abs(primal):
            failures.append(f"certified trivial bound {tbound:.6f} "
                            f"exceeds the native {name}'s iter-0 primal "
                            f"Eobjective {primal:.6f} (+1e-4 rel)")
    if not all(np.isfinite(v) for v in
               [tbound, eobj, conv] + [r["conv"] for r in it_log.rows]):
        failures.append("non-finite bound, Eobjective or conv")
    factors, _ = ph._get_factors(True)
    failures += packed_fault_check(factors, dev)
    ops = _df32_operands(ph)
    breakdown = df32_step_timing(*ops, plan, profile=on_card)
    log(json.dumps({
        "phase": "df32_path", "S": batch.S, "chunk": DF32_CHUNK,
        "reduced": f"S 1024 -> {CHUNK_SCENARIOS}, chunk 128 -> 16 (the "
                   "JAX bench's uc1024 cell; cut for the run's time)",
        "options": opts, "ship_s": t_ship, "ph_main_s": t_main,
        "iterations": it_log.rows,
        "ph_s_per_iteration": [r["seconds"] for r in it_log.rows],
        "phase_seconds": timing["seconds_per_call"],
        "gate_d2h_syncs_per_call": timing["gate_d2h_syncs_per_call"],
        "iter0_max_pri_rel": pri0, "iter0_gate": "passed",
        "iter0_gate_tol": DF32_ITER0_TOL,
        "post_solve_max_pri_rel": pri_on, "trivial_bound": tbound,
        "iter0_eobjective": it_log.iter0_eobjective, "eobjective": eobj,
        "eobjective_rel_to_native_reference": eobj_rel,
        "native_iter0_eobjective": {
            "chunked_path": native["iter0_eobjective"],
            "reference_run": ref["iter0_eobjective"]},
        "native_trivial_bound": {
            "chunked_path": native["trivial_bound"],
            "reference_run": ref["trivial_bound"]},
        "native_eobjective": {"chunked_path": native["eobjective"],
                              "reference_run": ref["eobjective"]},
        "conv": [r["conv"] for r in it_log.rows],
        "retries": len(retries), "retry_events": retries,
        "l_inv_factorizations": counters.get(
            "kernel.l_inv_factorizations", 0),
        "plan": plan.descriptor(), "peak_gb": peak_gb,
        "admm_block_launches": launches, "breakdown": breakdown}))
    return ph, failures


def df32_scaling(ph, native_ms_per_step):
    """Phase 8: one prox-on df32 chunk's operands tiled to each row count
    of DF32_SCALING_ROWS: ms per f32 bulk step and per df32 tail step,
    and one whole fused solve call at the recipe's budgets with the
    polish off, beside block_scaling's native ms per step."""
    import torch
    from mpisppy_tpu_torch.ops import kernels
    factors, d, q, st = _df32_operands(ph)
    S0 = st.x.shape[0]
    rows = []
    for S in DF32_SCALING_ROWS:
        rep = -(-S // S0)

        def tile(t, S=S, rep=rep):
            return t.repeat((rep,) + (1,) * (t.ndim - 1))[:S].contiguous()

        d_s = d._replace(l=tile(d.l), u=tile(d.u), lb=tile(d.lb),
                         ub=tile(d.ub))
        st_s = st._replace(x=tile(st.x), yA=tile(st.yA), yB=tile(st.yB),
                           zA=tile(st.zA), zB=tile(st.zB),
                           pri_res=tile(st.pri_res),
                           dua_res=tile(st.dua_res),
                           pri_rel=tile(st.pri_rel),
                           dua_rel=tile(st.dua_rel))
        q_s = tile(q)
        plan_s = kernels.prepare(
            factors, mode="fused", l_inv=ph.sub_kernel_l_inv,
            precision="df32", tail_iter=DF32["subproblem_tail_iter"],
            s_chunk=S)
        row = df32_step_timing(factors, d_s, q_s, st_s, plan_s)

        def call():
            kernels.kernel_solve(
                plan_s, factors, d_s, q_s, st_s, precision="df32",
                max_iter=DF32["subproblem_max_iter"],
                tail_iter=DF32["subproblem_tail_iter"],
                e_pri=DF32["subproblem_eps_hot"],
                e_dua=DF32["subproblem_eps_dua_hot"],
                stall_rel=DF32["subproblem_stall_rel"], polish=False,
                polish_chunk=0, ir_sweeps=1)

        t0 = time.perf_counter()
        call()
        _sync()
        row["fused_call_s"] = time.perf_counter() - t0
        row["l_inv"] = plan_s.l_inv
        row["native_block_ms_per_step"] = native_ms_per_step.get(S)
        rows.append(row)
    log(json.dumps({"phase": "df32_scaling",
                    "steps_per_timed_call": DF32_STEPS, "rows": rows}))


# the mixed check: fused against segmented, one PH iteration on a small
# UC in chunks (tests/test_torch_mixed_ph.py states the bar)
MIXED_CHECK = {"defaultPHrho": 50.0, "PHIterLimit": 1, "convthresh": -1.0,
               "subproblem_precision": "mixed", "subproblem_chunk": 3,
               "subproblem_max_iter": 1000, "subproblem_tail_iter": 1000,
               "subproblem_segment": 1000, "subproblem_eps": 1e-6}
MIXED_BAR = 1e-10


def mixed_check(dev):
    """Phase 9: one fused and one segmented mixed PH iteration (iter 0
    and one prox-on solve) on UC 3 x 6, S = 8 in chunks of 3: x̄ and W
    must agree to MIXED_BAR x max(1, |.|)."""
    from mpisppy_tpu_torch.core.ph import PH
    from mpisppy_tpu_torch.ir.batch import build_batch
    from mpisppy_tpu_torch.models import uc
    out = {}
    for mode in ("fused", "segmented"):
        b = build_batch(uc.scenario_creator, uc.make_tree(8),
                        creator_kwargs={"num_gens": 3, "num_hours": 6},
                        vector_patch=uc.scenario_vector_patch)
        ph = PH(b, {**MIXED_CHECK, "subproblem_kernel_mode": mode},
                device=dev)
        ph.ph_main()
        _sync()
        out[mode] = ph
    d_xbar = _max_rel_diff(out["segmented"].xbar, out["fused"].xbar)
    d_W = _max_rel_diff(out["segmented"].W, out["fused"].W)
    log(json.dumps({"check": "mixed_fused_vs_segmented", "S": 8,
                    "chunk": 3, "xbar_max_rel_diff": d_xbar,
                    "W_max_rel_diff": d_W, "bar": MIXED_BAR,
                    "on": str(out["fused"].xbar.device)}))
    if not (d_xbar <= MIXED_BAR and d_W <= MIXED_BAR):
        raise RuntimeError(f"mixed fused differs from segmented: x̄ "
                           f"{d_xbar:.3e}, W {d_W:.3e} (bar {MIXED_BAR})")


def wheel_config(dev):
    """Phase 10's RunConfig: the JAX bench's device-certified gap wheel
    (see WHEEL_ITERS for the cuts), on ``dev``."""
    from mpisppy_tpu_torch.utils.config import (AlgoConfig, RunConfig,
                                                SpokeConfig)
    base = dict(PH_OPTS)
    algo = AlgoConfig(
        default_rho=base["defaultPHrho"], max_iterations=WHEEL_ITERS,
        convthresh=-1.0, subproblem_max_iter=base["subproblem_max_iter"],
        subproblem_eps=base["subproblem_eps"],
        subproblem_polish_chunk=base["subproblem_polish_chunk"],
        subproblem_kernel_mode=base["subproblem_kernel_mode"],
        subproblem_kernel_backend=base["subproblem_kernel_backend"])
    lag = dict(base, lagrangian_exact_oracle=False,
               lagrangian_lp_ef_warmstart=False,
               lagrangian_lp_time_limit=120.0,
               lagrangian_device_duals=True)
    # the bench's x̂ options (its xhat_oracle_time_limit is
    # XHAT_ORACLE's 120 s)
    xhat = dict(base, **XHAT_ORACLE, xhat_exact_eval=True,
                xhat_min_interval=5.0, xhat_pin_vars=["u"],
                xhat_eval_milp=False)
    return RunConfig(
        model="uc", num_scens=SLICE_SCENARIOS,
        model_kwargs=dict(SLICE_INSTANCE), algo=algo,
        hub_options=dict(base, PHIterLimit=WHEEL_ITERS, convthresh=-1.0,
                         iter0_feas_tol=5e-3),
        spokes=[SpokeConfig(kind="lagrangian", options=lag),
                SpokeConfig(kind="xhatshuffle", options=xhat)],
        rel_gap=WHEEL_REL_GAP, wheel_deadline=WHEEL_DEADLINE,
        device=str(dev))


def wheel_path(dev):
    """Phase 10: the wheel, as ``python -m mpisppy_tpu_torch`` spins it.
    Returns (block launches of the wheel, the block's largest
    difference from its plain version at the Lagrangian engine's
    shapes, the list of failed checks, the wheel's host batch, the x̂
    spoke's incumbent first stage or None, and a summary for phases 15
    and 16: the incumbent value, the hub's trivial bound and its
    seconds per iteration); prints one JSON line."""
    import math
    import numpy as np
    import torch
    from mpisppy_tpu_torch import obs
    from mpisppy_tpu_torch.core.ph import _ph_assemble
    from mpisppy_tpu_torch.ops.kernels import admm_block
    from mpisppy_tpu_torch.utils.sputils import spin_the_wheel
    from mpisppy_tpu_torch.utils.vanilla import wheel_dicts

    import tempfile
    cfg = wheel_config(dev)
    # phase 21 rides this wheel: the live plane on an ephemeral port
    # and a telemetry directory; phase 22 resumes it from its bundles
    cfg.status_port = 0
    tdir = tempfile.mkdtemp(prefix="telemetry_wheel_")
    cfg.checkpoint_dir = tempfile.mkdtemp(prefix="ckpt_wheel_")
    t0 = time.perf_counter()
    hub_d, spoke_ds = wheel_dicts(cfg)
    t_batch = time.perf_counter() - t0
    hub_d["hub_kwargs"]["options"]["gap_marks"] = WHEEL_GAP_MARKS
    it_log = IterLog()
    hub_d["opt_kwargs"]["extensions"] = it_log
    on_card = torch.device(dev).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    obs.configure(out_dir=tdir, config=cfg.to_dict())
    admm_block.LAUNCHES = 0
    live = LivePoller()
    t0 = it_log.t0 = time.perf_counter()
    try:
        wheel = spin_the_wheel(hub_d, spoke_ds, register_hub=live.start)
    finally:
        live.stop()
    _sync()
    t_wheel = time.perf_counter() - t0
    launches = admm_block.LAUNCHES
    demotions = obs.events("kernel.cuda_demotion")
    spoke_bounds = obs.events("spoke.bound")
    captures = obs.events("ckpt.capture")
    obs.shutdown()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9 if on_card else None
    hub = wheel.hub
    ph, lag, xhat = hub.opt, wheel.spokes[0].opt, wheel.spokes[1].opt
    per_engine = {"hub": ph.kernel_launches, "lagrangian": lag.kernel_launches,
                  "xhatshuffle": xhat.kernel_launches}
    outer, inner = wheel.best_outer_bound, wheel.best_inner_bound
    trivial = getattr(ph, "trivial_bound", None)
    pri0 = float(ph._qp_states[False].pri_rel.max())
    t_start = hub.clock_anchor["perf_counter"]

    def first(kind, chars=None):
        """Seconds from the wheel's start to the hub's first ``kind``
        bound (from the spokes of ``chars`` only, when given)."""
        for t, k, char, _ in hub.bound_events:
            if k == kind and (chars is None or char in chars):
                return t - t_start
        return None

    _, rel_gap = wheel.gap()
    failures = stuck_spokes("wheel_path")
    for name in ("hub", "lagrangian"):
        if per_engine[name] <= 0:
            failures.append(f"the {name} engine launched no block")
    if sum(per_engine.values()) != launches:
        failures.append(f"per-engine launches {per_engine} do not add up "
                        f"to the block's {launches}")
    if demotions:
        failures.append(f"kernel demotion booked: {demotions}")
    if not pri0 <= 5e-3:
        failures.append(f"iter-0 max pri_rel {pri0:.3e} above the gate")
    if not (math.isfinite(outer) and math.isfinite(inner)):
        failures.append(f"bounds not finite: outer {outer}, inner {inner}")
    elif not outer <= inner:
        failures.append(f"outer bound {outer} above inner bound {inner}")
    if trivial is None or not outer >= trivial:
        failures.append(f"outer bound {outer} below the trivial bound "
                        f"{trivial}")
    # the block at full width on the Lagrangian engine's prox-off W-on
    # operator: its last solve's state and factors, the cost at its W
    factors, data = lag._get_factors(False)
    st = lag._qp_states[False]
    q, _, _ = _ph_assemble(data, lag.c, lag.W, lag.xbar, lag.rho,
                           lag.nonant_idx, lag._fixed_mask, lag._fixed_vals,
                           lag._w_scale, w_on=True, prox_on=False)
    err, f = compare(factors, data, q, st, 20, "wheel_lagrangian_prox_off")
    failures += f
    admm_block.LAUNCHES = launches   # the comparison's are not the path's
    failures += telemetry_wheel_checks(tdir, live, len(wheel.spokes))
    rows = it_log.rows
    log(json.dumps({
        "phase": "wheel_path", "S": ph.batch.S, "n": ph.batch.n,
        "m": ph.batch.m, "batch_build_s": t_batch, "wheel_s": t_wheel,
        "hub_iterations": len(rows), "deadline_s": WHEEL_DEADLINE,
        "watchdog_fired": hub._watchdog_fired,
        "hub_s_per_iteration": [r["seconds"] for r in rows],
        "iter0_max_pri_rel": pri0, "trivial_bound": trivial,
        "best_outer": outer, "best_inner": inner, "rel_gap": rel_gap,
        "first_outer_s": first("outer"),
        "first_spoke_outer_s": first("outer", "L"),
        "first_inner_s": first("inner"),
        "gap_mark_s": {str(mk): (hub.gap_mark_times[mk] - t_start
                                 if mk in hub.gap_mark_times else None)
                       for mk in WHEEL_GAP_MARKS},
        "bound_events": [[t - t_start, k, c, v]
                         for t, k, c, v in hub.bound_events],
        # every bound each spoke computed (the hub books improvements)
        "spoke_bounds": [[e["t"] - t_start, e["char"], e["value"]]
                         for _, e in spoke_bounds],
        "solve_s_per_call": {
            "hub_prox_on": (ph.phase_timing(True) or {}).get(
                "seconds_per_call", {}).get("solve"),
            "lagrangian_prox_off": (lag.phase_timing(False) or {}).get(
                "seconds_per_call", {}).get("solve")},
        "launches_per_engine": per_engine, "launches": launches,
        "demotions": len(demotions), "peak_gb": peak_gb}))
    batch = ph.batch
    best_xhat = (None if wheel.spokes[1].best_xhat is None
                 else np.array(wheel.spokes[1].best_xhat, dtype=float))
    from mpisppy_tpu_torch.utils.runtime import to_host
    summary = {"inner": inner, "trivial_bound": trivial,
               "hub_s_per_iteration": [r["seconds"] for r in rows],
               # what phase 22 resumes and holds its install against
               "ckpt": {"dir": cfg.checkpoint_dir, "iter": ph._iter,
                        "outer": outer, "inner": inner,
                        "plans": {str(k): p.descriptor() for k, p in
                                  ph._kernel_plans.items()},
                        "bundle": hub.ckpt.last_bundle,
                        "capture_ms": [1e3 * e["seconds"]
                                       for _, e in captures],
                        "capture_reasons": [e["reason"]
                                            for _, e in captures],
                        "state": {k: to_host(getattr(ph, k))
                                  for k in ("W", "xbar", "xsqbar",
                                            "rho")}}}
    del wheel, hub, ph, lag, xhat, factors, data, st, q
    # phase 13 reuses the host batch; its device copies go now
    batch.__dict__.pop("_dev_cache", None)
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    return launches, err, failures, batch, best_xhat, summary


def ckpt_path(dev, batch, phase10):
    """Phase 22 (uc-ref-S10-wheel-resume): phase 10's wheel resumed from
    its checkpoint directory on its batch, preempted by a real SIGTERM
    at its first prox-on iteration. Returns (block launches of the
    resumed wheel, the block's largest difference from its plain
    version on the resumed hub's prox-on operands, the failed checks);
    prints one JSON line."""
    import math
    import shutil
    import tempfile
    import numpy as np
    import torch
    from mpisppy_tpu_torch import obs
    from mpisppy_tpu_torch.ckpt import bundle as ckpt_bundle
    from mpisppy_tpu_torch.core.ph import _ph_assemble
    from mpisppy_tpu_torch.ops.kernels import admm_block
    from mpisppy_tpu_torch.testing.faults import install_hub_faults
    from mpisppy_tpu_torch.utils.runtime import to_host
    from mpisppy_tpu_torch.utils.sputils import spin_the_wheel
    from mpisppy_tpu_torch.utils.vanilla import wheel_dicts

    src = phase10["ckpt"]
    cfg = wheel_config(dev)
    cfg.algo.max_iterations = CKPT_ITERS
    cfg.hub_options["PHIterLimit"] = CKPT_ITERS
    cfg.resume_from = src["dir"]
    # a directory of its own: phase 10's stays as that wheel wrote it
    # for the checks below
    cfg.checkpoint_dir = tempfile.mkdtemp(prefix="ckpt_resume_")
    failures = []
    manifest, _, spoke_files = ckpt_bundle.load_bundle(src["dir"])
    bundle_bytes = sum(int(v) for v in manifest["files"].values())
    if manifest["reason"] != "finalize" \
            or os.path.basename(ckpt_bundle.latest_bundle(src["dir"])) \
            != os.path.basename(src["bundle"]):
        failures.append(f"phase 10's LATEST bundle is {manifest['reason']!r}"
                        f", not its final one {src['bundle']}")
    if sorted(spoke_files) != ["spoke0.npz", "spoke1.npz"]:
        failures.append(f"phase 10's bundle holds spoke files "
                        f"{sorted(spoke_files)}")
    hub_d, spoke_ds = wheel_dicts(cfg, batch=batch)
    it_log = IterLog()
    hub_d["opt_kwargs"]["extensions"] = it_log
    installed, at_preempt = {}, {}

    def arm(hub):
        """After the hub (and the resume) is built, before its loop: read
        the installed state, arm the fault plan, and note what LATEST
        names once the preemption's capture has returned."""
        # the engines built and the bundle installed, from the spin
        installed["built_s"] = time.perf_counter() - t0
        installed.update({k: to_host(getattr(hub.opt, k))
                          for k in ("W", "xbar", "xsqbar", "rho")})
        installed["iter"] = hub.opt._iter
        installed["outer"] = hub.BestOuterBound
        installed["inner"] = hub.BestInnerBound
        install_hub_faults(hub, CKPT_FAULT_PLAN)
        orig = hub.handle_preemption

        def preempted(source="sigterm"):
            orig(source)
            latest = ckpt_bundle.latest_bundle(cfg.checkpoint_dir)
            at_preempt.update(
                source=source, iter=hub.opt._iter, latest=latest,
                t_s=time.perf_counter() - t0,
                reason=json.load(open(os.path.join(
                    latest, ckpt_bundle.MANIFEST)))["reason"]
                if latest else None)
        hub.handle_preemption = preempted

    obs.configure(out_dir=None)
    admm_block.LAUNCHES = 0
    t0 = time.perf_counter()
    wheel = spin_the_wheel(hub_d, spoke_ds, register_hub=arm)
    _sync()
    t_wheel = time.perf_counter() - t0
    launches = admm_block.LAUNCHES
    demotions = obs.events("kernel.cuda_demotion")
    resumes = obs.events("ckpt.resume")
    rejected = obs.events("ckpt.resume_rejected")
    counters = obs.counters_snapshot()
    obs.shutdown()
    hub = wheel.hub
    ph, lag = hub.opt, wheel.spokes[0].opt
    failures += stuck_spokes("ckpt_path")
    if rejected or len(resumes) != 1:
        failures.append(f"resume not installed: {len(resumes)} resumes, "
                        f"rejections {[e for _, e in rejected]}")
    for k, ref in src["state"].items():
        got = installed.get(k)
        if got is None or got.dtype != ref.dtype \
                or not np.array_equal(got, ref):
            failures.append(f"installed {k} is not bit-equal to phase "
                            f"10's final hub state")
    if installed.get("iter") != src["iter"]:
        failures.append(f"installed _iter {installed.get('iter')} != phase "
                        f"10's {src['iter']}")
    if installed.get("outer") != src["outer"] \
            or installed.get("inner") != src["inner"]:
        failures.append(f"seeded ledger ({installed.get('outer')}, "
                        f"{installed.get('inner')}) is not phase 10's best "
                        f"({src['outer']}, {src['inner']})")
    outs = [v for _, k, _, v in hub.bound_events if k == "outer"]
    inns = [v for _, k, _, v in hub.bound_events if k == "inner"]
    if outs != sorted(outs) or inns != sorted(inns, reverse=True) \
            or not hub.BestOuterBound >= src["outer"] \
            or not hub.BestInnerBound <= src["inner"]:
        failures.append(f"ledger not monotone across the resume: outer "
                        f"{outs}, inner {inns}")
    if counters.get("ckpt.spoke_resumed", 0) != len(spoke_ds):
        failures.append(f"ckpt.spoke_resumed = "
                        f"{counters.get('ckpt.spoke_resumed', 0)}, "
                        f"expected {len(spoke_ds)}")
    if not hub._preempted or at_preempt.get("reason") != "preempt" \
            or at_preempt.get("iter") != 1:
        failures.append(f"no preempt bundle named by LATEST at the "
                        f"resumed iteration 1: {at_preempt}")
    elif not os.path.isfile(os.path.join(at_preempt["latest"],
                                         ckpt_bundle.MANIFEST)):
        failures.append(f"the preempt bundle {at_preempt['latest']} is "
                        f"gone after the wheel")
    per_engine = {"hub": ph.kernel_launches, "lagrangian":
                  lag.kernel_launches, "xhatshuffle":
                  wheel.spokes[1].opt.kernel_launches}
    # the warm iteration 0 and the prox-on solve, each one block call
    per_solve = admm_block.admm_block_launches(SLICE_BUDGET, False)
    if per_engine["hub"] < 2 * per_solve:
        failures.append(f"the resumed hub launched {per_engine['hub']} "
                        f"kernels, under its two solves' {2 * per_solve}")
    if per_engine["lagrangian"] <= 0:
        failures.append("the resumed lagrangian engine launched no block")
    plans = {str(k): p.descriptor() for k, p in ph._kernel_plans.items()}
    moved = {k: (src["plans"][k], v) for k, v in plans.items()
             if k in src["plans"] and src["plans"][k] != v}
    if moved or not set(src["plans"]) & set(plans):
        failures.append(f"the resume changed the block's plan: {moved} "
                        f"(phase 10 {src['plans']}, resumed {plans})")
    if demotions:
        failures.append(f"kernel demotion booked: {demotions}")
    if any(p.backend != "cuda" for p in ph._kernel_plans.values()):
        failures.append("a kernel plan of the resumed hub is not cuda")
    outer, inner = hub.BestOuterBound, hub.BestInnerBound
    if not (math.isfinite(outer) and math.isfinite(inner)
            and outer <= inner):
        failures.append(f"resumed bounds: outer {outer}, inner {inner}")
    factors, data = ph._get_factors(True)
    st = ph._qp_states[True]
    q, _, _ = _ph_assemble(data, ph.c, ph.W, ph.xbar, ph.rho,
                           ph.nonant_idx, ph._fixed_mask, ph._fixed_vals,
                           ph._w_scale, w_on=True, prox_on=True)
    err, f = compare(factors, data, q, st, 20, "ckpt_resumed_prox_on")
    failures += f
    admm_block.LAUNCHES = launches   # the comparison's are not the path's
    log(json.dumps({
        "phase": "ckpt_path", "cell": "uc-ref-S10-wheel-resume",
        "S": ph.batch.S, "n": ph.batch.n, "m": ph.batch.m,
        "capture_ms_phase10": src["capture_ms"],
        "capture_reasons_phase10": src["capture_reasons"],
        "install_ms": 1e3 * resumes[0][1]["seconds"] if resumes else None,
        "bundle_bytes": bundle_bytes, "resumed_wheel_s": t_wheel,
        "built_s": installed.get("built_s"),
        "iter0_end_s": None if it_log.t is None else it_log.t - t0
        - sum(r["seconds"] for r in it_log.rows),
        "hub_s_per_iteration": [r["seconds"] for r in it_log.rows],
        "installed_iter": installed.get("iter"),
        "preempt": at_preempt, "best_outer": outer, "best_inner": inner,
        "bound_events": [[t - t0, k, c, v]
                         for t, k, c, v in hub.bound_events],
        "spoke_resumed": counters.get("ckpt.spoke_resumed", 0),
        "captures": counters.get("ckpt.captures", 0), "plans": plans,
        "schedule": admm_block.block_schedule(ph.batch.m, ph.batch.n),
        "launches_per_engine": per_engine, "launches": launches,
        "demotions": len(demotions)}))
    del wheel, hub, ph, lag, factors, data, st, q
    shutil.rmtree(cfg.checkpoint_dir, ignore_errors=True)
    shutil.rmtree(src["dir"], ignore_errors=True)
    batch.__dict__.pop("_dev_cache", None)
    gc.collect()
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()
    return launches, err, failures


class LivePoller:
    """Phase 21's live-plane client: once the hub is built
    (spin_the_wheel's ``register_hub``), a thread polls /status until
    the hub has finished an iteration, then fetches /status and
    /metrics once each and keeps what came back."""

    def __init__(self):
        import threading
        self.got = {}
        self._stop = threading.Event()
        self._thread = None

    def start(self, hub):
        import threading
        self._thread = threading.Thread(target=self._poll, args=(hub,),
                                        daemon=True)
        self._thread.start()

    def _poll(self, hub):
        import urllib.request
        base = f"http://127.0.0.1:{hub._status_server.port}"
        while not self._stop.is_set():
            try:
                with urllib.request.urlopen(base + "/status",
                                            timeout=30) as r:
                    snap = json.loads(r.read())
                if (snap.get("iter") or 0) >= 1:
                    with urllib.request.urlopen(base + "/metrics",
                                                timeout=30) as r:
                        metrics = r.read().decode()
                    self.got = {"status": snap, "metrics": metrics,
                                "t": time.perf_counter()}
                    return
            except OSError as e:
                self.got = {"error": repr(e)}
            self._stop.wait(0.5)

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=60)


def telemetry_wheel_checks(tdir, live, n_spokes):
    """Phase 21 on the wheel's artifacts: the mid-run /status and
    /metrics fetch succeeded, live.json parses after the wheel, and
    ``analyze`` gives a bound-flow verdict per spoke. Prints one JSON
    line; returns the failed checks."""
    import shutil
    from mpisppy_tpu_torch.obs import analyze
    failures = []
    snap = live.got.get("status")
    metrics = live.got.get("metrics", "")
    if not snap or snap.get("type") != "live" \
            or "mpisppy_tpu_live_iter" not in metrics \
            or "mpisppy_tpu_ph_solve_loop_calls" not in metrics:
        failures.append(f"no mid-run /status and /metrics: {live.got}")
    try:
        with open(os.path.join(tdir, "live.json")) as fh:
            final = json.load(fh)
    except (OSError, ValueError) as e:
        final = None
        failures.append(f"live.json did not parse: {e!r}")
    flow = analyze.bound_flow_summary(analyze.load_run(tdir)) or {}
    verdicts = {k: v.get("verdict") for k, v in flow.items()}
    if len(verdicts) != n_spokes or not all(verdicts.values()):
        failures.append(f"bound-flow verdicts {verdicts} for {n_spokes} "
                        "spokes")
    log(json.dumps({
        "phase": "telemetry_wheel",
        "mid_run_status": None if not snap else {
            k: snap.get(k) for k in ("iter", "outer", "inner", "rel_gap",
                                     "elapsed_seconds", "roofline")},
        "live_json": None if final is None else {
            k: final.get(k) for k in ("iter", "outer", "inner", "rel_gap",
                                      "roofline")},
        "bound_flow_verdicts": verdicts, "failures": failures}))
    shutil.rmtree(tdir, ignore_errors=True)
    return failures


class APHLog(IterLog):
    """APH hub extension: per iteration the wall seconds, the engine's
    block launches, the dispatch record, and whether the rows of x that
    the iteration did not dispatch kept their bits across its solve."""

    def __init__(self):
        super().__init__()
        self.x = None
        self.n0 = 0

    def post_iter0(self, ph):
        super().post_iter0(ph)
        self.rows.append({"iter": 0, "launches": ph.kernel_launches,
                          "seconds": self.t - self.t0})
        self.n0 = ph.kernel_launches

    def miditer(self, ph):
        self.x = ph.x.clone()

    def enditer(self, ph):
        import torch
        now = time.perf_counter()
        mask = torch.as_tensor(ph._dispatched, device=ph.x.device)
        st = ph._aph_status
        self.rows.append({
            "iter": ph._iter, "conv": ph.conv, "seconds": now - self.t,
            "launches": ph.kernel_launches - self.n0,
            "dispatched": st["dispatched"], "solve_path": st["solve_path"],
            "phi_neg": st.get("phi_neg"),
            "undispatched_unchanged": bool(torch.equal(ph.x[~mask],
                                                       self.x[~mask])),
            "ids": [int(i) for i in ph._dispatched.nonzero()[0]]})
        self.n0 = ph.kernel_launches
        self.t = now


def aph_config(dev):
    """Phase 11's RunConfig: what ``python -m mpisppy_tpu_torch uc --hub
    aph --dispatch-frac 0.25 --subproblem-chunk 16 --with-xhatshuffle``
    builds, with the main path's engine options, the chunked cell's
    hospital off, and phase 10's x̂ recipe."""
    from mpisppy_tpu_torch.utils.config import (AlgoConfig, RunConfig,
                                                SpokeConfig)
    base = dict(PH_OPTS)
    algo = AlgoConfig(
        default_rho=base["defaultPHrho"], max_iterations=APH_ITERS,
        convthresh=-1.0, subproblem_max_iter=base["subproblem_max_iter"],
        subproblem_eps=base["subproblem_eps"],
        subproblem_polish_chunk=base["subproblem_polish_chunk"],
        subproblem_kernel_mode=base["subproblem_kernel_mode"],
        subproblem_kernel_backend=base["subproblem_kernel_backend"],
        dispatch_frac=APH_FRAC)
    xhat = dict(base, **XHAT_ORACLE, xhat_exact_eval=True,
                xhat_min_interval=5.0, xhat_pin_vars=["u"],
                xhat_eval_milp=False)
    return RunConfig(
        model="uc", num_scens=CHUNK_SCENARIOS,
        model_kwargs=dict(SLICE_INSTANCE), hub="aph", algo=algo,
        hub_options=dict(base, PHIterLimit=APH_ITERS, convthresh=-1.0,
                         subproblem_chunk=CHUNK,
                         subproblem_hospital=False),
        spokes=[SpokeConfig(kind="xhatshuffle", options=xhat)],
        device=str(dev))


def aph_block_compare(aph, idx, st, label):
    """The block against its plain version on an APH engine's prox-on
    operands: rows ``idx`` of the engine's data and of its W and z (the
    prox centre of an APH solve), warm state ``st`` (``idx``'s rows)."""
    from mpisppy_tpu_torch.core.ph import _ph_assemble
    factors, data = aph._get_factors(True)
    d = data._replace(l=data.l[idx], u=data.u[idx], lb=data.lb[idx],
                      ub=data.ub[idx])
    q, bl, bu = _ph_assemble(d, aph.c[idx], aph.W[idx], aph.z[idx],
                             aph.rho[idx], aph.nonant_idx,
                             aph._fixed_mask[idx], aph._fixed_vals[idx],
                             None, w_on=True, prox_on=True)
    return compare(factors, d._replace(lb=bl, ub=bu), q, st, 20, label)


def aph_path(dev, batch, chunked):
    """Phase 11: the APH wheel on the chunked path's batch. ``chunked``:
    phase 5's per-iteration seconds, printed beside this path's.
    Returns (block launches of the wheel, the block's largest difference
    from its plain version on gathered padded rows, the list of failed
    checks); prints one JSON line."""
    import math
    import numpy as np
    import torch
    from mpisppy_tpu_torch import obs
    from mpisppy_tpu_torch.ops.dispatch import gather_rows
    from mpisppy_tpu_torch.ops.kernels import admm_block
    from mpisppy_tpu_torch.utils.sputils import spin_the_wheel
    from mpisppy_tpu_torch.utils.vanilla import hub_dict, spoke_dict

    cfg = aph_config(dev).validate()
    hub_d = hub_dict(cfg, batch=batch)
    spoke_ds = [spoke_dict(cfg, sp, batch=batch) for sp in cfg.spokes]
    log_ = APHLog()
    hub_d["opt_kwargs"]["extensions"] = log_
    on_card = torch.device(dev).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    obs.configure()
    admm_block.LAUNCHES = 0
    t0 = log_.t0 = time.perf_counter()
    wheel = spin_the_wheel(hub_d, spoke_ds)
    _sync()
    t_wheel = time.perf_counter() - t0
    launches = admm_block.LAUNCHES
    counters = obs.counters_snapshot()
    demotions = obs.events("kernel.cuda_demotion")
    obs.shutdown()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9 if on_card else None
    aph = wheel.hub.opt
    xhat = wheel.spokes[0].opt
    rows = log_.rows
    iters = len(rows) - 1
    per_call = admm_block.admm_block_launches(SLICE_BUDGET, False)
    n_chunks = -(-CHUNK_SCENARIOS // CHUNK)
    scnt = math.ceil(APH_FRAC * CHUNK_SCENARIOS)
    plan = [n_chunks, n_chunks] + [-(-scnt // CHUNK)] * (iters - 1)
    got = [r["launches"] // per_call for r in rows]
    outer, inner = wheel.best_outer_bound, wheel.best_inner_bound
    trivial = getattr(aph, "trivial_bound", None)
    w_sum = float((aph.prob @ aph.W).abs().max())
    w_scale = max(1.0, float(aph.W.abs().max()))
    failures = stuck_spokes("aph_path")
    if iters != APH_ITERS:
        failures.append(f"{iters} APH iterations ran, expected {APH_ITERS}")
    if got != plan[:len(got)] or any(r["launches"] % per_call
                                     for r in rows):
        failures.append(f"block calls per iteration {got} (launches "
                        f"{[r['launches'] for r in rows]}), planned {plan}")
    if aph.kernel_launches != launches or launches != sum(plan) * per_call:
        failures.append(f"launches: hub {aph.kernel_launches}, all "
                        f"{launches}, planned {sum(plan) * per_call}")
    if demotions or any(p.backend != "cuda"
                        for p in aph._kernel_plans.values()):
        failures.append(f"kernel demotion: {demotions}")
    if counters.get("aph.gate_syncs") != iters:
        failures.append(f"aph.gate_syncs {counters.get('aph.gate_syncs')}"
                        f" for {iters} iterations")
    want = CHUNK_SCENARIOS + scnt * (iters - 1)
    if counters.get("dispatch.solved_scenarios") != want:
        failures.append(f"dispatch.solved_scenarios "
                        f"{counters.get('dispatch.solved_scenarios')}, "
                        f"expected {want}")
    for r in rows[2:]:
        if r["solve_path"] != "chunked-skip" or r["dispatched"] != scnt:
            failures.append(f"iter {r['iter']}: {r['solve_path']} with "
                            f"{r['dispatched']} dispatched")
    if not all(r["undispatched_unchanged"] for r in rows[1:]):
        failures.append("an undispatched row of x changed in a partial "
                        "pass")
    if w_sum > 1e-8 * w_scale:
        failures.append(f"sum_s p_s W_s = {w_sum:.3e} is not 0")
    if not (math.isfinite(outer) and math.isfinite(inner)):
        failures.append(f"bounds not finite: outer {outer}, inner {inner}")
    elif trivial is None or not trivial <= inner or not outer <= inner:
        failures.append(f"trivial {trivial} / outer {outer} above the "
                        f"inner bound {inner}")
    # the block on one dispatched chunk's operands: the last partial
    # pass's ids padded to a full chunk, rows gathered from the store
    ids = np.asarray(rows[-1]["ids"])
    ids_pad = np.concatenate([ids, np.full(CHUNK - ids.size, ids[-1])])
    idx = torch.as_tensor(ids_pad, device=dev)
    store = aph._dispatch_stores[True]
    st = store._replace(**{k: gather_rows(getattr(store, k), idx)
                           for k in ("x", "yA", "yB", "zA", "zB",
                                     "pri_res", "dua_res", "pri_rel",
                                     "dua_rel")})
    err, f = aph_block_compare(aph, idx, st, "aph_gathered_padded_rows")
    failures += f
    admm_block.LAUNCHES = launches   # the comparison's are not the path's
    log(json.dumps({
        "phase": "aph_path", "S": CHUNK_SCENARIOS, "chunk": CHUNK,
        "dispatch_frac": APH_FRAC, "wheel_s": t_wheel,
        "aph_s_per_iteration": [r["seconds"] for r in rows],
        "chunked_ph_s_per_iteration": chunked["ph_s_per_iteration"],
        "chunked_ph_main_s": chunked["ph_main_s"],
        "iterations": rows, "block_calls_per_iteration": got,
        "planned_calls": plan, "launches": launches,
        "launches_per_engine": {"hub": aph.kernel_launches,
                                "xhatshuffle": xhat.kernel_launches},
        "counters": {k: v for k, v in counters.items()
                     if k.startswith(("aph.", "dispatch."))},
        "demotions": len(demotions), "trivial_bound": trivial,
        "best_outer": outer, "best_inner": inner,
        "sum_p_W_max": w_sum, "gathered_padded_ids": ids_pad.tolist(),
        "peak_gb": peak_gb}))
    del wheel, aph, xhat, store, st
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    return launches, err, failures


def _card_memory_sampler(stop, peak):
    """Sample the card's used memory (nvidia-smi, MiB, every process on
    it) until ``stop`` is set; ``peak[0]``: the largest reading."""
    while not stop.is_set():
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=memory.used",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=30)
        first = out.stdout.strip().splitlines()[:1]
        if first and first[0].strip().isdigit():
            peak[0] = max(peak[0], int(first[0].strip()))
        stop.wait(1.0)


def telemetry_shard_checks(cfg):
    """Phase 21 on the sharded APH wheel's directory: every process's
    role artifacts exist (shard 0, which carries the hub, unsuffixed;
    shard i as ``shard<i>``; each spoke under its role) and
    trace_merged.json has one track per process. Prints one JSON line;
    returns the failed checks."""
    import shutil
    tdir = cfg.telemetry_dir
    roles = [""] + [f"-shard{i}" for i in range(1, APH_SHARDS)] + [
        f"-spoke{i}-{sp.kind}" for i, sp in enumerate(cfg.spokes)]
    want = [f"{stem}{r}{ext}" for r in roles
            for stem, ext in (("events", ".jsonl"), ("trace", ".json"),
                              ("metrics", ".json"))]
    have = sorted(os.listdir(tdir))
    failures = [f"missing telemetry artifact {f}" for f in want
                if f not in have]
    tracks = None
    try:
        with open(os.path.join(tdir, "trace_merged.json")) as fh:
            merged = json.load(fh)
        tracks = len({e["pid"] for e in merged["traceEvents"]
                      if e.get("ph") == "M"
                      and e.get("name") == "process_name"})
    except (OSError, ValueError, KeyError) as e:
        failures.append(f"trace_merged.json: {e!r}")
    if tracks != len(roles):
        failures.append(f"trace_merged.json has {tracks} process tracks, "
                        f"expected {len(roles)}")
    log(json.dumps({"phase": "telemetry_shards", "files": have,
                    "merged_tracks": tracks, "failures": failures}))
    shutil.rmtree(tdir, ignore_errors=True)
    return failures


def shard_block_check(cfg):
    """The block against its plain version at the shapes a shard's solve
    gives it: shard 0's rows (S / shards of them) against the
    full-width A and F, with the shard engine's options, from the
    prox-on state after iter 0 and one APH iteration (masked
    acceptance: every row of the shard solves). Built in this process
    after the wheel. Returns (rows, largest difference, failures)."""
    import torch
    from mpisppy_tpu_torch.core.aph import APH
    from mpisppy_tpu_torch.core.aph_shard import _shard_batch, shard_range
    from mpisppy_tpu_torch.ops.kernels import admm_block

    lo, hi = shard_range(cfg.num_scens, 0, APH_SHARDS)
    batch = _shard_batch(cfg.model, cfg.num_scens, cfg.model_kwargs, lo, hi)
    opts = dict(cfg.algo.to_options())
    opts.update(cfg.hub_options)
    opts.update(partial_probabilities=True, PHIterLimit=1)
    saved = admm_block.LAUNCHES
    aph = APH(batch, opts, device=cfg.device)
    aph.APH_main(finalize=False)
    idx = torch.arange(batch.S, device=aph.device)
    err, failures = aph_block_compare(aph, idx, aph._qp_states[True],
                                      "aph_shard_rows")
    admm_block.LAUNCHES = saved   # the check's launches are not the path's
    return batch.S, err, failures


def aph_shard_wheel(dev):
    """Phase 12: the scenario-sharded APH wheel, every process on the
    card, then the block against its plain version at a shard's shapes.
    Returns (block launches of the shards, the block's largest
    difference from its plain version, the list of failed checks);
    prints one JSON line."""
    import math
    import threading
    import torch
    from mpisppy_tpu_torch.core.aph_shard import spin_aph_shard_wheel

    cfg = aph_config(dev)
    cfg.num_scens = APH_SHARD_SCENARIOS
    cfg.algo.max_iterations = APH_SHARD_ITERS
    cfg.algo.dispatch_frac = 0.5
    cfg.hub_options = {k: v for k, v in cfg.hub_options.items()
                       if k not in ("subproblem_chunk",
                                    "subproblem_hospital")}
    cfg.hub_options["PHIterLimit"] = APH_SHARD_ITERS
    # phase 21 rides this wheel: every process records into one
    # telemetry directory under its role
    import tempfile
    cfg.telemetry_dir = tempfile.mkdtemp(prefix="telemetry_shards_")
    cfg.validate()
    stats, peak = [], [0]
    stop = threading.Event()
    sampler = threading.Thread(target=_card_memory_sampler,
                               args=(stop, peak), daemon=True)
    sampler.start()
    t0 = time.perf_counter()
    try:
        conv, eobj, triv, iters, outer, inner = spin_aph_shard_wheel(
            cfg, n_shards=APH_SHARDS, join_timeout=600.0,
            spoke_ready_timeout=300.0, shard_stats=stats)
    finally:
        stop.set()
        sampler.join(timeout=60)
    t_wheel = time.perf_counter() - t0
    launches = sum(s["launches"] for s in stats)
    failures = []
    if not (math.isfinite(outer) and math.isfinite(inner)):
        failures.append(f"bounds not finite: outer {outer}, inner {inner}")
    elif not outer <= inner:
        failures.append(f"outer bound {outer} above inner bound {inner}")
    for s in stats:
        if not (s["device"].startswith("cuda") and s["launches"] > 0
                and s["backends"] == ["cuda"]):
            failures.append(f"shard {s['shard']} did not run the block on "
                            f"the card with no demotion: {s}")
    failures += telemetry_shard_checks(cfg)
    rows, err, f = shard_block_check(cfg)
    failures += f
    log(json.dumps({
        "phase": "aph_shard_wheel", "S": APH_SHARD_SCENARIOS,
        "shards": APH_SHARDS, "wheel_s": t_wheel,
        "iterations": iters, "conv": conv, "eobjective": eobj,
        "trivial_bound": triv, "best_outer": outer, "best_inner": inner,
        "shard_stats": stats, "launches": launches,
        "block_vs_plain": {"rows": rows, "max_abs_err": err},
        # per shard process: its torch peak (shard_stats); every process
        # of the wheel together: the card's used memory at its peak
        "card_used_mib_peak": peak[0]}))
    gc.collect()
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()
    return launches, err, failures



def _inf_free_columns(eng, x):
    """Per scenario, the free (unpinned) columns whose term of the
    Benders cut of ``eng``'s last pinned solve at ``x`` is -inf (a
    reduced cost of the wrong sign on an infinite bound), and the
    largest such reduced cost in size."""
    import torch
    from mpisppy_tpu_torch.ops import qp_solver as T
    d0 = eng._data_with_prox(False)
    idx = eng.nonant_idx
    pin = torch.as_tensor(x, dtype=eng.dtype).to(eng.device).expand(
        eng.batch.S, eng.batch.K)
    d = d0._replace(lb=d0.lb.index_copy(1, idx, pin),
                    ub=d0.ub.index_copy(1, idx, pin))
    yA = T._sanitize_row_duals(d.l, d.u, eng.yA)
    yB = T._sanitize_row_duals(d.lb, d.ub, eng.yB)
    r = eng.c + T._ATy(d.A, yA) + yB
    best = T._column_bound(d.P_diag, eng.c, r, yB, d.lb, d.ub, None, 1e-6)
    free = torch.ones(eng.batch.n, dtype=torch.bool, device=eng.device)
    free[idx] = False
    bad = torch.isneginf(best) & free
    worst = torch.where(bad, r.abs(), 0.0).amax(dim=-1)
    return {"count": bad.sum(dim=-1).tolist(),
            "max_abs_reduced_cost": worst.tolist()}


def stuck_spokes(label):
    """A failure for every in-process spoke thread still running after
    ``label``'s wheel returned (spin_the_wheel gives up joining a spoke
    after its budget). Such a thread keeps using its engine and the
    card: it would race the phase's later calls on that engine, and a
    daemon thread still inside a CUDA call when the interpreter exits
    aborts the process."""
    import threading
    return [f"{label}: {t.name} still running after the wheel returned"
            for t in threading.enumerate()
            if t.name.startswith("spoke") and t.is_alive()]


def _lshaped_recorder():
    """LShapedMethod that keeps, per round, the rounded point, the cuts,
    the pinned solve's per-scenario objectives and its feasibility
    verdict (the engine's own test), for phase 13's checks."""
    import numpy as np
    from mpisppy_tpu_torch.core.lshaped import LShapedMethod
    from mpisppy_tpu_torch.utils.runtime import to_host

    class Recorder(LShapedMethod):
        def generate_cuts(self, xf):
            const, g, ub = super().generate_cuts(xf)
            if not hasattr(self, "rounds"):
                self.rounds = []
            st = self._qp_states[("fixed", False)]
            x = np.asarray(self.round_nonants(xf))
            # the rounded point against the master's first-stage rows
            m1, K = self._m1, self.batch.K
            ax = self._mA[:m1, :K] @ x
            viol = np.maximum(self._ml[:m1] - ax, ax - self._mu[:m1])
            self.rounds.append({
                "x": x, "const": const,
                "g": g, "V": to_host(self._last_base_obj, np.float64),
                "dual": to_host(self._last_dual_obj, np.float64),
                "inf_columns": _inf_free_columns(self, x),
                "feasible": self._cut_timing["feasible"],
                "max_pri_rel": float(st.pri_rel.max()),
                "finite_cuts": int(np.isfinite(const).sum()),
                "first_stage_rows_broken": int((viol > 1e-9).sum()),
                "first_stage_max_violation": float(max(viol.max(), 0.0))})
            return const, g, ub

    return Recorder


def lshaped_config(dev):
    """Phase 13's RunConfig: what ``python -m mpisppy_tpu_torch uc --hub
    lshaped --with-xhatlshaped`` builds, on the slice's instance and S,
    with PH_OPTS' native f64 options on the cuda block, LSHAPED_ITERS
    L-shaped iterations and the x̂ spoke's dive off."""
    from mpisppy_tpu_torch.utils.config import (AlgoConfig, RunConfig,
                                                SpokeConfig)
    base = dict(PH_OPTS)
    algo = AlgoConfig(
        default_rho=base["defaultPHrho"], convthresh=-1.0,
        subproblem_max_iter=base["subproblem_max_iter"],
        subproblem_eps=base["subproblem_eps"],
        subproblem_polish_chunk=base["subproblem_polish_chunk"],
        subproblem_kernel_mode=base["subproblem_kernel_mode"],
        subproblem_kernel_backend=base["subproblem_kernel_backend"])
    # the x̂ spoke evaluates the master's point itself (a pinned solve
    # through the block): its default candidate source on integer
    # nonants, the prox-centred dive, runs the reference solver round
    # after round at this width, and on an H100 it kept the spoke busy
    # past the end of the script
    return RunConfig(
        model="uc", num_scens=SLICE_SCENARIOS,
        model_kwargs=dict(SLICE_INSTANCE), hub="lshaped", algo=algo,
        hub_options=dict(base, max_iter=LSHAPED_ITERS),
        spokes=[SpokeConfig(kind="xhatlshaped",
                            options=dict(base, xhat_dive_candidates=False))],
        device=str(dev))


def feasible_first_stage(ls, xhat):
    """A first stage of the slice's UC that every pinned solve can take:
    the commitments u of phase 10's incumbent (its x̂ spoke pins u only
    and certified the value on the host) with the startups they imply,
    st[g, t] = max(0, u[g, t] - u[g, t-1]) from the T0 state. Returns
    (the point (K,), the largest violation of the L-shaped master's
    first-stage rows and boxes)."""
    import numpy as np
    from mpisppy_tpu_torch.models.uc import t0_fleet_state
    G, T = SLICE_INSTANCE["num_gens"], SLICE_INSTANCE["num_hours"]
    u = np.round(np.asarray(xhat, float).reshape(-1)[:G * T]).reshape(G, T)
    on0 = np.asarray(t0_fleet_state(G)[0], float)
    prev = np.concatenate([on0[:, None], u[:, :-1]], axis=1)
    x = np.concatenate([u.reshape(-1),
                        np.maximum(u - prev, 0.0).reshape(-1)])
    m1, K = ls._m1, ls.batch.K
    ax = ls._mA[:m1, :K] @ x
    viol = np.concatenate([ls._ml[:m1] - ax, ax - ls._mu[:m1],
                           ls._lb_master[:K] - x, x - ls._ub_master[:K]])
    return x, max(float(viol.max()), 0.0)


def _cut_check(r, label):
    """The cut-at-point check of one pinned round (JAX
    tests/test_lshaped.py:56's bar): every scenario's cut at the
    round's point is at most that solve's objective plus 1e-4 x
    max(1, |V|). Returns (a summary, the failures)."""
    import numpy as np
    cut = r["const"] + r["g"] @ r["x"]
    bar = r["V"] + 1e-4 * np.maximum(1.0, np.abs(r["V"]))
    slack = bar - cut
    fin = np.isfinite(cut)
    out = {"label": label, "feasible": r["feasible"],
           "max_pri_rel": r["max_pri_rel"], "finite_cuts": int(fin.sum()),
           "min_slack": float(slack.min()),
           "cut_depth_below_V": [float(v) for v in (r["V"] - cut)[fin]],
           "inf_free_columns": r["inf_columns"],
           "finite_dual_bounds": int(np.isfinite(r["dual"]).sum()),
           "dual_gap_rel": [float(v) for v in
                            (r["V"] - r["dual"]) / np.maximum(1.0,
                                                              np.abs(r["V"]))]}
    failures = []
    if not bool((slack >= 0).all()):
        failures.append(f"{label}: a cut lies above the value function "
                        f"at its own point: {slack.tolist()}")
    # the same duals' certified bound at the point (with the witness;
    # what PH's bounds use) is a lower bound on that solve's objective
    if r["feasible"] and not bool((r["dual"] <= bar).all()):
        failures.append(f"{label}: a certified dual bound lies above the "
                        f"pinned objective: {(bar - r['dual']).tolist()}")
    return out, failures


def lshaped_path(dev, batch, xhat):
    """Phase 13: the L-shaped wheel on the slice's host batch (phase
    10's build), then the cut solve and the x̂-lshaped spoke's pinned
    evaluation at a first stage known to be feasible (built from phase
    10's incumbent ``xhat``: feasible_first_stage), twice on the hub
    (cold, then continued at the same point). Returns (block launches
    of the path, the block's largest difference from its plain version
    on the pinned operands, the list of failed checks); prints one
    JSON line."""
    import math
    import numpy as np
    import torch
    from mpisppy_tpu_torch import obs
    from mpisppy_tpu_torch.core.ph import _ph_assemble
    from mpisppy_tpu_torch.ops.kernels import admm_block
    from mpisppy_tpu_torch.utils import vanilla
    from mpisppy_tpu_torch.utils.sputils import spin_the_wheel

    cfg = lshaped_config(dev)
    cfg.validate()
    vanilla.refuse_unported(cfg)
    hub_d = vanilla.hub_dict(cfg, batch=batch)
    spoke_ds = [vanilla.spoke_dict(cfg, sp, batch=batch)
                for sp in cfg.spokes]
    hub_d["opt_class"] = _lshaped_recorder()
    on_card = torch.device(dev).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    obs.configure()
    admm_block.LAUNCHES = 0
    t0 = time.perf_counter()
    wheel = spin_the_wheel(hub_d, spoke_ds)
    _sync()
    t_wheel = time.perf_counter() - t0
    wheel_launches = admm_block.LAUNCHES
    ls, xhat_eng = wheel.hub.opt, wheel.spokes[0].opt
    wheel_per_engine = {"hub": ls.kernel_launches,
                        "xhatlshaped": xhat_eng.kernel_launches}
    outer, inner = wheel.best_outer_bound, wheel.best_inner_bound
    K, Se = ls.batch.K, len(ls._eta_scens)
    eta_lb = ls._lb_master[K:K + Se]
    eta_floor = float(np.dot(np.asarray(ls.batch.prob)[ls._eta_scens],
                             eta_lb))
    lbs = [r["lb"] for r in ls.lshaped_timing]
    n_wheel_rounds = len(getattr(ls, "rounds", []))
    failures = stuck_spokes("lshaped_path")
    if sum(wheel_per_engine.values()) != wheel_launches:
        failures.append(f"per-engine launches {wheel_per_engine} do not "
                        f"add up to the wheel's {wheel_launches}")
    if not lbs or not all(math.isfinite(v) for v in lbs):
        failures.append(f"outer bounds not finite: {lbs}")
    elif any(b < a for a, b in zip(lbs, lbs[1:])):
        failures.append(f"the outer bound decreased: {lbs}")
    if not (math.isfinite(outer)
            and outer >= eta_floor - 1e-7 * max(1.0, abs(eta_floor))):
        failures.append(f"outer bound {outer} below the eta floor "
                        f"{eta_floor}")
    if math.isfinite(inner) and not outer <= inner:
        failures.append(f"outer bound {outer} above inner bound {inner}")
    cut_rows, checked, skipped = [], 0, 0
    for i, r in enumerate(getattr(ls, "rounds", [])):
        if not r["feasible"]:
            skipped += 1
            continue
        checked += 1
        row, f = _cut_check(r, f"wheel round {i + 1}")
        cut_rows.append(row)
        failures += f

    # the feasible first stage: the hub's cut solve there (cold: the
    # wheel's last cut solve was at another point), the same point again
    # (the solve continues from its state), then the spoke's pinned
    # evaluation of it
    feas = {"point_from_phase_10": xhat is not None}
    x_feas = None
    if xhat is None:
        failures.append("phase 10 left no incumbent: no feasible first "
                        "stage for the cut-at-point check")
    else:
        x_feas, viol = feasible_first_stage(ls, xhat)
        feas["first_stage_max_violation"] = viol
        if viol > 1e-9:
            failures.append(f"the first stage built from phase 10's "
                            f"incumbent breaks a first-stage row by {viol}")
            x_feas = None
    tol_b = 1e-4 * max(1.0, abs(outer)) if math.isfinite(outer) else 0.0
    if x_feas is not None:
        for visit in ("cold", "continued"):
            t0 = time.perf_counter()
            _, _, ub = ls.generate_cuts(x_feas)
            _sync()
            r = ls.rounds[-1]
            row, f = _cut_check(r, f"feasible point, {visit}")
            row.update(seconds=time.perf_counter() - t0, ub=ub,
                       iters=int(ls._qp_states[("fixed", False)].iters))
            feas[visit] = row
            failures += f
            if not r["feasible"]:
                failures.append(f"the pinned solve at the feasible first "
                                f"stage ({visit}) failed the engine's "
                                f"test: max pri_rel {r['max_pri_rel']:.3e}")
            if ub is not None and not ub >= outer - tol_b:
                failures.append(f"the value {ub} at the feasible first "
                                f"stage ({visit}) is below the outer "
                                f"bound {outer}")
        before = xhat_eng.kernel_launches
        t0 = time.perf_counter()
        obj = xhat_eng.calculate_incumbent(x_feas)
        _sync()
        feas["spoke"] = {"value": obj, "seconds": time.perf_counter() - t0,
                         "launches": xhat_eng.kernel_launches - before}
        if obj is None:
            failures.append("the x̂-lshaped spoke's pinned evaluation of "
                            "the feasible first stage found it infeasible")
        elif not obj >= outer - tol_b:
            failures.append(f"the spoke's value {obj} at the feasible "
                            f"first stage is below the outer bound {outer}")
        # the block path's pinned duals run at fixed rho (ROADMAP B6) and
        # may certify no finite cut at all; the cut builder is checked at
        # full width on the reference backend's duals (rho adapts) at
        # the same point, with the same engine code
        ref = type(ls)(batch, dict(ls.options,
                                   subproblem_kernel_mode="segmented",
                                   subproblem_max_iter=REF_CUT_ITERS),
                       device=dev)
        t0 = time.perf_counter()
        _, _, ub_ref = ref.generate_cuts(x_feas)
        _sync()
        r_ref = ref.rounds[-1]
        row, f = _cut_check(r_ref, "feasible point, reference backend")
        row.update(seconds=time.perf_counter() - t0, ub=ub_ref,
                   iters=int(ref._qp_states[("fixed", False)].iters))
        feas["reference"] = row
        failures += f
        if not r_ref["feasible"]:
            failures.append(f"the reference backend's pinned solve at the "
                            f"feasible first stage failed the engine's "
                            f"test: max pri_rel {r_ref['max_pri_rel']:.3e}")
        # at the reference UC every cut may be -inf on both backends
        # (inf_free_columns says which terms): then only the dual
        # bounds were held, and the JSON says so
        feas["cuts_checked"] = sum(feas[k]["finite_cuts"] for k in
                                   ("cold", "continued", "reference"))
        # the block path's cuts against the reference's value function
        V_ref = r_ref["V"]
        for visit in ("cold", "continued"):
            blk = ls.rounds[n_wheel_rounds + (visit == "continued")]
            cut = blk["const"] + blk["g"] @ x_feas
            slack = V_ref + 1e-4 * np.maximum(1.0, np.abs(V_ref)) - cut
            feas[visit]["min_slack_vs_reference"] = float(slack.min())
            if not bool((slack >= 0).all()):
                failures.append(f"a block-path cut ({visit}) lies above "
                                f"the reference value function at the "
                                f"feasible first stage: {slack.tolist()}")
            if ub_ref is not None and blk["feasible"]:
                feas[visit]["ub_rel_to_reference"] = \
                    (feas[visit]["ub"] - ub_ref) / abs(ub_ref)
        del ref
    launches = admm_block.LAUNCHES
    demotions = obs.events("kernel.cuda_demotion")
    obs.shutdown()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9 if on_card else None
    plans = {str(k): {"backend": p.backend, "launches": p.launches}
             for k, p in ls._kernel_plans.items()}
    spoke_plans = {str(k): {"backend": p.backend, "launches": p.launches}
                   for k, p in xhat_eng._kernel_plans.items()}
    per_engine = {"hub": ls.kernel_launches,
                  "xhatlshaped": xhat_eng.kernel_launches}
    for key in ("False", "('fixed', False)"):
        plan = plans.get(key)
        if plan is None or plan["backend"] != "cuda" \
                or plan["launches"] <= 0:
            failures.append(f"the hub's {key} plan launched no block: "
                            f"{plan}")
    plan = spoke_plans.get("('fixed', False)")
    if plan is None or plan["backend"] != "cuda" or plan["launches"] <= 0:
        failures.append(f"the x̂-lshaped spoke's pinned plan launched no "
                        f"block: {plan}")
    if sum(per_engine.values()) != launches:
        failures.append(f"per-engine launches {per_engine} do not add up "
                        f"to the block's {launches}")
    if demotions:
        failures.append(f"kernel demotion booked: {demotions}")

    # the block at full width on the pinned operands as the path hands
    # them to it. Cold: every cut solve at a new point drops the
    # engine's ("fixed", False) state and rebuilds it (a fresh pinned
    # factor, the prox-off iterates transplanted); here at the wheel's
    # last point. Warm: the state a feasible pinned solve leaves, which
    # a cut solve at the same point continues from, as the spoke's
    # evaluations do; here at the feasible first stage
    def pinned_operands(x_pin):
        factors, data = ls._get_factors(False, fixed=True)
        ls.fix_nonants(x_pin)
        q, bl, bu = _ph_assemble(data, ls.c, ls.W, ls.xbar, ls.rho,
                                 ls.nonant_idx, ls._fixed_mask,
                                 ls._fixed_vals, None, w_on=False,
                                 prox_on=False)
        ls.unfix_nonants()
        return factors, data._replace(lb=bl, ub=bu), q

    err = 0.0
    if x_feas is not None:
        st = ls._qp_states[("fixed", False)]
        factors, d, q = pinned_operands(x_feas)
        e, f = compare(factors, d, q, st, 20, "lshaped_pinned_warm")
        err, failures = max(err, e), failures + f
    ls._qp_states.pop(("fixed", False), None)
    st = ls._ensure_state(False, fixed=True)
    factors, d, q = pinned_operands(ls.rounds[n_wheel_rounds - 1]["x"])
    e, f = compare(factors, d, q, st, 20, "lshaped_pinned_cold")
    err, failures = max(err, e), failures + f
    admm_block.LAUNCHES = launches   # the comparisons' are not the path's
    log(json.dumps({
        "phase": "lshaped_path", "S": ls.batch.S, "n": ls.batch.n,
        "m": ls.batch.m, "K": K, "master_rows": int(ls._mA.shape[0]),
        "master_cols": int(ls._mA.shape[1]), "first_stage_rows": ls._m1,
        "wheel_s": t_wheel,
        "iterations": ls.lshaped_timing, "eta_floor": eta_floor,
        "best_outer": outer, "best_inner": inner,
        "cut_checks": cut_rows, "wheel_rounds_checked": checked,
        "wheel_rounds_infeasible": skipped,
        "rounds": [{k: r[k] for k in (
            "max_pri_rel", "finite_cuts", "first_stage_rows_broken",
            "first_stage_max_violation")}
            for r in getattr(ls, "rounds", [])[:n_wheel_rounds]],
        "feasible_point": feas, "plans": plans, "spoke_plans": spoke_plans,
        "wheel_launches_per_engine": wheel_per_engine,
        "launches_per_engine": per_engine, "wheel_launches": wheel_launches,
        "launches": launches, "demotions": len(demotions),
        "peak_gb": peak_gb}))
    del wheel, ls, xhat_eng, factors, d, st, q
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    return launches, err, failures


def fwph_config(dev):
    """Phase 15's RunConfig: what ``python -m mpisppy_tpu_torch uc
    --with-fwph`` builds, on the slice's instance and S, with PH_OPTS'
    native f64 options on the cuda block for the hub and the FWPH spoke,
    the spoke cut to FWPH_ITERS outer iterations of FWPH_FW_ITERS
    linearized solves each (a cut in depth, for time)."""
    from mpisppy_tpu_torch.utils.config import (AlgoConfig, RunConfig,
                                                SpokeConfig)
    base = dict(PH_OPTS)
    algo = AlgoConfig(
        default_rho=base["defaultPHrho"], max_iterations=FWPH_HUB_ITERS,
        convthresh=-1.0, subproblem_max_iter=base["subproblem_max_iter"],
        subproblem_eps=base["subproblem_eps"],
        subproblem_polish_chunk=base["subproblem_polish_chunk"],
        subproblem_kernel_mode=base["subproblem_kernel_mode"],
        subproblem_kernel_backend=base["subproblem_kernel_backend"])
    fw = dict(base, PHIterLimit=FWPH_ITERS, FW_iter_limit=FWPH_FW_ITERS)
    return RunConfig(
        model="uc", num_scens=SLICE_SCENARIOS,
        model_kwargs=dict(SLICE_INSTANCE), algo=algo,
        hub_options=dict(base, PHIterLimit=FWPH_HUB_ITERS, convthresh=-1.0,
                         iter0_feas_tol=5e-3),
        spokes=[SpokeConfig(kind="fwph", options=fw)],
        wheel_deadline=WHEEL_DEADLINE, device=str(dev))


def _fwph_recorder(last):
    """FWPH that keeps, per outer iteration, its seconds, its linearized
    solves and max |Σ_s p_s w_s| at the pass's first linearized solve
    (the condition its bound rests on), and the iter-0 solve's max
    pri_rel; sets ``last["started"]`` when its last outer iteration
    starts, which the hub's converger (_until_fwph_last) reads."""
    from mpisppy_tpu_torch.core.fwph import FWPH

    class Recorder(FWPH):
        def solve_loop(self, w_on=True, prox_on=True, update=True,
                       fixed=False, dispatch=None):
            out = super().solve_loop(w_on=w_on, prox_on=prox_on,
                                     update=update, fixed=fixed,
                                     dispatch=dispatch)
            if w_on and not prox_on and not update and self._iter > 0:
                self._linearized += 1
            return out

        def SDM(self, first_pass_bound=True):
            if not hasattr(self, "sdm_rows"):
                self.sdm_rows = []
                self.iter0_max_pri_rel = float(
                    self._qp_states[False].pri_rel.max())
            if self._iter >= self.max_iterations:
                last["started"] = True
            _sync()
            t0 = time.perf_counter()
            self._linearized = 0
            w_t = self.W + self.rho * (self._xn_t - self.xbar)
            w_sum = float((self.prob @ w_t).abs().max())
            w_scale = max(1.0, float(w_t.abs().max()))
            out = super().SDM(first_pass_bound)
            _sync()
            self.sdm_rows.append({
                "iter": self._iter, "seconds": time.perf_counter() - t0,
                "linearized_solves": self._linearized, "gamma": out[1],
                "local_bound": self._local_bound,
                "sum_p_w_max": w_sum, "w_scale": w_scale})
            return out

    return Recorder


def _until_fwph_last(last):
    """Hub converger: the hub stops once the FWPH spoke has started its
    last outer iteration. The hub's kill ends the spoke's run only after
    that iteration publishes its bound (the engine tests the kill after
    each sync), and the hub reads that bound at its final receive."""
    class Until:
        def __init__(self, ph):
            pass

        def is_converged(self):
            return bool(last.get("started"))
    return Until


def fwph_path(dev, batch, phase10):
    """Phase 15: the FWPH wheel on the slice's host batch (phase 10's
    build): a PH hub and the FWPH spoke, which runs its iter 0 and
    FWPH_ITERS outer iterations on the cuda block; the hub iterates
    beside it until the spoke starts its last outer iteration, which
    then runs alone on the card. Returns (block launches of the path,
    the block's largest difference from its plain version at the FWPH
    engine's linearized operands, the list of failed checks); prints
    one JSON line."""
    import math
    import numpy as np
    import torch
    from mpisppy_tpu_torch import obs
    from mpisppy_tpu_torch.core.ph import _ph_assemble
    from mpisppy_tpu_torch.ops.kernels import admm_block
    from mpisppy_tpu_torch.ops.simplex_qp import simplex_qp_solve
    from mpisppy_tpu_torch.utils import vanilla
    from mpisppy_tpu_torch.utils.sputils import spin_the_wheel

    cfg = fwph_config(dev)
    cfg.validate()
    vanilla.refuse_unported(cfg)
    hub_d = vanilla.hub_dict(cfg, batch=batch)
    spoke_ds = [vanilla.spoke_dict(cfg, sp, batch=batch)
                for sp in cfg.spokes]
    last = {}
    spoke_ds[0]["opt_class"] = _fwph_recorder(last)
    it_log = IterLog()
    hub_d["opt_kwargs"]["extensions"] = it_log
    hub_d["opt_kwargs"]["converger"] = _until_fwph_last(last)
    on_card = torch.device(dev).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    obs.configure()
    admm_block.LAUNCHES = 0
    t0 = it_log.t0 = time.perf_counter()
    wheel = spin_the_wheel(hub_d, spoke_ds)
    _sync()
    t_wheel = time.perf_counter() - t0
    launches = admm_block.LAUNCHES
    demotions = obs.events("kernel.cuda_demotion")
    obs.shutdown()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9 if on_card else None
    ph, spoke = wheel.hub.opt, wheel.spokes[0]
    fw = spoke.opt
    per_engine = {"hub": ph.kernel_launches, "fwph": fw.kernel_launches}
    plans = {str(k): {"backend": p.backend, "launches": p.launches}
             for k, p in fw._kernel_plans.items()}
    published = [b for _, b in spoke._trace]
    rows = getattr(fw, "sdm_rows", [])
    trivial = getattr(fw, "trivial_bound", None)
    incumbent = phase10["inner"]
    pri0 = getattr(fw, "iter0_max_pri_rel", None)
    hub_pri0 = float(ph._qp_states[False].pri_rel.max())
    failures = stuck_spokes("fwph_path")
    if fw.kernel_launches <= 0:
        failures.append("the FWPH engine launched no block")
    plan = plans.get("False")
    if plan is None or plan["backend"] != "cuda" or plan["launches"] <= 0:
        failures.append(f"the FWPH engine's prox-off plan launched no "
                        f"block: {plan}")
    if sum(per_engine.values()) != launches:
        failures.append(f"per-engine launches {per_engine} do not add up "
                        f"to the block's {launches}")
    if demotions:
        failures.append(f"kernel demotion booked: {demotions}")
    if pri0 is None or not pri0 <= 5e-3:
        failures.append(f"FWPH iter-0 max pri_rel {pri0} above the gate")
    if not hub_pri0 <= 5e-3:
        failures.append(f"hub iter-0 max pri_rel {hub_pri0:.3e} above the "
                        f"gate")
    if len(rows) < FWPH_ITERS or len(published) < FWPH_ITERS:
        failures.append(f"FWPH ran {len(rows)} outer iterations and "
                        f"published {len(published)} bounds, expected "
                        f"{FWPH_ITERS}")
    elif not wheel.best_outer_bound >= max(published):
        failures.append(f"the hub's outer bound {wheel.best_outer_bound} "
                        f"is below the spoke's last bound {max(published)}")
    for r in rows:
        if not r["sum_p_w_max"] <= 1e-8 * r["w_scale"]:
            failures.append(f"sum_s p_s w_s = {r['sum_p_w_max']:.3e} at "
                            f"the first SDM pass of iteration {r['iter']}")
    tol = 1e-6 * max(1.0, abs(trivial)) if trivial is not None else 0.0
    for b in published:
        if not (math.isfinite(b) and trivial is not None
                and b >= trivial - tol
                and (incumbent is None or b <= incumbent)):
            failures.append(f"published FWPH bound {b} outside [trivial "
                            f"{trivial} - {tol:.3g}, incumbent "
                            f"{incumbent}]")
    a = getattr(fw, "_a", None)
    if a is None:
        failures.append("FWPH kept no simplex weights")
        a_sum_err = a_min = None
    else:
        a_sum_err = float((a.sum(dim=1) - 1.0).abs().max())
        a_min = float(a.min())
        if not (a_sum_err <= 1e-9 and a_min >= -1e-12):
            failures.append(f"simplex weights off the simplex: sum error "
                            f"{a_sum_err:.3e}, min {a_min:.3e}")
    # the weight QP alone at the engine's final shapes
    G = fw.columns[:, :, fw.nonant_idx]
    base = (fw.columns @ fw.c.unsqueeze(-1)).squeeze(-1)
    _sync()
    t0 = time.perf_counter()
    simplex_qp_solve(G, base, fw.W, fw.rho, fw.xbar, fw._a,
                     iters=fw.qp_iters)
    _sync()
    t_qp = time.perf_counter() - t0
    # the block at full width on the FWPH engine's linearized operands:
    # the prox-off factor, the warm state its last linearized solve
    # left, the cost at the next pass's w_t
    factors, data = fw._get_factors(False)
    st = fw._qp_states[False]
    w_t = fw.W + fw.rho * (fw._xn_t - fw.xbar)
    q, _, _ = _ph_assemble(data, fw.c, w_t, fw.xbar, fw.rho, fw.nonant_idx,
                           fw._fixed_mask, fw._fixed_vals, None, w_on=True,
                           prox_on=False)
    err, f = compare(factors, data, q, st, 20, "fwph_linearized")
    failures += f
    admm_block.LAUNCHES = launches   # the comparison's are not the path's
    log(json.dumps({
        "phase": "fwph_path", "S": fw.batch.S, "n": fw.batch.n,
        "m": fw.batch.m, "K": fw.batch.K, "wheel_s": t_wheel,
        "fw_iter_limit": fw.FW_iter_limit, "columns": fw.max_columns,
        "qp_iters": fw.qp_iters, "fwph_iter0_max_pri_rel": pri0,
        "hub_iter0_max_pri_rel": hub_pri0, "outer_iterations": rows,
        "s_per_outer_iteration": [r["seconds"] for r in rows],
        "simplex_qp_solve_s": t_qp, "fwph_trivial_bound": trivial,
        "published_bounds": published, "incumbent_phase_10": incumbent,
        "best_outer": wheel.best_outer_bound,
        "simplex_sum_err": a_sum_err, "simplex_min": a_min,
        "hub_iterations": len(it_log.rows),
        "hub_s_per_iteration": [r["seconds"] for r in it_log.rows],
        "hub_s_per_iteration_phase_10": phase10["hub_s_per_iteration"],
        "plans": plans, "launches_per_engine": per_engine,
        "launches": launches, "demotions": len(demotions),
        "peak_gb": peak_gb}))
    del wheel, ph, spoke, fw, factors, data, st, q, w_t, G, base
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    return launches, err, failures


def bundle_path(dev, batch, phase10):
    """Phase 16: ``python -m mpisppy_tpu_torch uc --num-bundles
    BUNDLES`` on the slice's host batch: form_bundles, then
    ``PH(...).ph_main()`` with PH_OPTS' native options for
    BUNDLE_ITERS prox-on iterations (a cut in depth, for time) and the
    wheel's iter-0 gate. Returns (block launches of the path, the
    block's largest difference from its plain version at the bundled
    shapes, the list of failed checks); prints one JSON line."""
    import numpy as np
    import torch
    from mpisppy_tpu_torch import obs
    from mpisppy_tpu_torch.core.bundles import form_bundles
    from mpisppy_tpu_torch.core.ph import PH
    from mpisppy_tpu_torch.ops.kernels import admm_block

    # phase 10's engines' device copies of the unbundled batch go first
    batch.__dict__.pop("_dev_cache", None)
    gc.collect()
    on_card = torch.device(dev).type == "cuda"
    if on_card:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    bundled = form_bundles(batch, BUNDLES)
    t_form = time.perf_counter() - t0
    failures = []
    if not (bundled.shared_A and np.asarray(bundled.A).ndim == 2):
        failures.append(f"the bundled A is not one shared 2-D matrix: "
                        f"shape {np.asarray(bundled.A).shape}")
    opts = dict(PH_OPTS, PHIterLimit=BUNDLE_ITERS, iter0_feas_tol=5e-3)
    it_log = IterLog()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ph = PH(bundled, opts, device=dev, extensions=it_log)
    _sync()
    t_ship = time.perf_counter() - t0
    import tempfile
    tdir = tempfile.mkdtemp(prefix="telemetry_main_")
    obs.configure(out_dir=tdir)
    admm_block.LAUNCHES = 0
    t0 = it_log.t0 = time.perf_counter()
    conv, eobj, tbound = ph.ph_main()
    _sync()
    t_main = time.perf_counter() - t0
    launches = admm_block.LAUNCHES
    demotions = obs.events("kernel.cuda_demotion")
    telemetry = telemetry_in_session(ph) if on_card else None
    obs.shutdown()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9 if on_card else None
    pri0 = float(ph._qp_states[False].pri_rel.max())
    solves = 1 + len(it_log.rows)
    expected = solves * admm_block.admm_block_launches(SLICE_BUDGET, False)
    W = ph.W
    w_sum = float((ph.prob @ W).abs().max())
    w_scale = max(1.0, float(W.abs().max()))
    incumbent = phase10["inner"]
    if ph.qp_data.A.ndim != 2:
        failures.append("the engine did not keep the bundles' shared A")
    if launches != expected:
        failures.append(f"admm_block launched {launches} kernels, "
                        f"expected {expected}")
    if any(p.backend != "cuda" for p in ph._kernel_plans.values()):
        failures.append("a kernel plan of the bundle path is not cuda")
    if demotions:
        failures.append(f"kernel demotion booked: {demotions}")
    if not pri0 <= 5e-3:
        failures.append(f"iter-0 max pri_rel {pri0:.3e} above the gate")
    if w_sum > 1e-8 * w_scale:
        failures.append(f"sum_s p_s W_s = {w_sum:.3e} is not 0")
    finite = [tbound, eobj, conv] + [r["conv"] for r in it_log.rows]
    if not all(np.isfinite(v) for v in finite) \
            or not bool(torch.isfinite(ph.xbar).all()):
        failures.append(f"non-finite bound or iterate: {finite}")
    if incumbent is not None and not tbound <= incumbent:
        failures.append(f"bundled trivial bound {tbound} above phase 10's "
                        f"incumbent {incumbent}")
    # the block at the bundled shapes, from the engine's prox-on state
    factors, data = ph._get_factors(True)
    st = ph._qp_states[True]
    q, _, _ = _assembled_q(ph, data)
    err, f = compare(factors, data, q, st, 20, "bundles_prox_on")
    failures += f
    steps = 20
    ms = cuda_ms(lambda: admm_block.fused_admm_block(
        factors, data, q, st, n_steps=steps, sigma=factors.sigma,
        scen_tile=0), 2)
    admm_block.LAUNCHES = launches   # the comparison's and timing's
    S, n = st.x.shape
    m = st.zA.shape[1]
    floor_ms = 8 * (m * n + n * n) / HBM_BYTES_PER_S * 1e3
    lib_ms = library_ms(factors.A_s, st.L, S, steps)
    log(json.dumps({
        "phase": "bundle_path", "bundles": bundled.S, "S": batch.S,
        "n": bundled.n, "m": bundled.m, "A_shape": list(ph.qp_data.A.shape),
        "form_bundles_s": t_form, "ship_s": t_ship, "ph_main_s": t_main,
        "iter0_max_pri_rel": pri0, "iterations": it_log.rows,
        "trivial_bound": tbound, "trivial_bound_unbundled_phase_10":
            phase10["trivial_bound"], "incumbent_phase_10": incumbent,
        "eobjective": eobj, "conv": conv,
        "phase_seconds": {str(k): v["acc"] for k, v in
                          ph._phase_times.items()},
        "block_ms_per_step": ms / steps,
        "byte_floor_ms_per_step": floor_ms,
        "library_ms_per_step": lib_ms,
        "launches": launches, "expected_launches": expected,
        "demotions": len(demotions), "sum_p_W_max": w_sum,
        "peak_gb": peak_gb}))
    del ph, factors, data, st, q, W, bundled
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    return launches, err, failures


def library_ms(A, F, S, steps, reps=2):
    """ms per step of the block's three products as torch.matmul calls
    (w·A, v·F, v·Aᵀ at S rows): the library yardstick of block_timing."""
    import torch
    m, n = A.shape
    w = torch.randn(S, m, dtype=A.dtype, device=A.device)
    v = torch.randn(S, n, dtype=A.dtype, device=A.device)

    def lib():
        for _ in range(steps):
            torch.matmul(w, A)
            torch.matmul(v, F)
            torch.matmul(v, A.T)

    return cuda_ms(lib, reps) / steps


def _shrink_log():
    """An extension (the port's Extension, so it composes after the
    device fixer): IterLog with the fixed fraction, the active shapes
    and the bucket after every prox-on iteration."""
    from mpisppy_tpu_torch.extensions import Extension

    class ShrinkLog(IterLog, Extension):
        solve_shape = None
        iter0_pri_rel = None

        def post_solve(self, ph):
            super().post_solve(ph)
            # the shape this solve ran at (before the fixer's miditer
            # may compact)
            plan = ph._shrink
            self.solve_shape = (ph.batch.n, ph.batch.m) if plan is None \
                else (plan.n_c, plan.m_c)

        def post_iter0(self, ph):
            super().post_iter0(ph)
            self.iter0_pri_rel = float(ph._qp_states[False].pri_rel.max())

        def miditer(self, ph):
            super().miditer(ph)
            st = ph._shrink_status
            self.rows[-1].update(
                solve_n=self.solve_shape[0], solve_m=self.solve_shape[1],
                fixed_fraction_after=st["fixed"] / ph.batch.K,
                bucket_after=st["bucket"])

    return ShrinkLog()


def _carried(src, dst):
    """``dst`` takes ``src``'s PH state (W, x̄, x̄², rho, the fixings)."""
    dst.W, dst.xbar, dst.xsqbar = src.W, src.xbar, src.xsqbar
    dst.rho = src.rho
    dst.fix_nonants(src._fixed_vals, mask=src._fixed_mask)
    dst._iter = src._iter


def shrink_path(dev, batch):
    """Phase 17: problem shrinking on the slice's S = 10 batch, the
    uc-ref-S10 options with the device fixer and active-set compaction
    at bench.py's hub settings (shrink_fix_iters 4, shrink_fix_tol 1e-3,
    buckets 0.25, 0.5, 0.75), SHRINK_ITERS prox-on iterations through
    ``PH(...).ph_main()``. Checks that a compaction happened, that the
    compacted solves ran the block (its own plans, no demotion), the
    iter-0 gate, sum_s p_s W_s = 0 and finite results; holds the block
    against its plain version on the first compacted solve's operands
    and times it there beside the byte bound and the library; then runs
    one prox-on iteration compacted and one on the full pin-box system
    from the same carried PH state (both solver states cold) and prints
    their relative differences in Eobjective and x̄ beside the JAX
    round-trip bar. Returns (block launches of the run, the block's
    largest difference from its plain version, failed checks)."""
    import numpy as np
    import torch
    from mpisppy_tpu_torch import obs
    import mpisppy_tpu_torch.core.ph as ph_mod
    from mpisppy_tpu_torch.core.ph import PH
    from mpisppy_tpu_torch.extensions import DeviceFixer, MultiExtension
    from mpisppy_tpu_torch.ops.kernels import admm_block

    opts = dict(PH_OPTS, PHIterLimit=SHRINK_ITERS, **SHRINK_OPTS)
    log_ = _shrink_log()
    on_card = torch.device(dev).type == "cuda"
    if on_card:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ph = PH(batch, opts, device=dev,
            extensions=MultiExtension([DeviceFixer(opts), log_]))
    _sync()
    t_ship = time.perf_counter() - t0
    first = {}
    orig = ph_mod._solver_call

    def spy(factors, d, q, state, **kw):
        # the first compacted solve's operands (nothing is written in
        # place, so references keep them)
        if ph._shrink is not None and "st" not in first \
                and kw.get("kernel") is not None:
            first.update(f=factors, d=d, q=q, st=state)
        return orig(factors, d, q, state, **kw)

    ph_mod._solver_call = spy
    obs.configure()
    admm_block.LAUNCHES = 0
    try:
        t0 = log_.t0 = time.perf_counter()
        conv, eobj, tbound = ph.ph_main()
        _sync()
        t_main = time.perf_counter() - t0
        launches = admm_block.LAUNCHES
    finally:
        ph_mod._solver_call = orig
        demotions = obs.events("kernel.cuda_demotion")
        obs.shutdown()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9 if on_card else None
    st = dict(ph._shrink_status)
    failures = []
    rows = log_.rows
    pri0 = log_.iter0_pri_rel
    if st["compactions"] < 1 or ph._shrink is None:
        failures.append(f"no compaction in {SHRINK_ITERS} iterations "
                        f"(fixed fraction {st['fixed'] / ph.batch.K:.3f})")
    plan = ph._kernel_plans.get(True)
    if plan is None or plan.backend != "cuda" or plan.launches == 0:
        failures.append("the compacted prox-on solves did not run the "
                        "block")
    if launches == 0:
        failures.append("admm_block launched no kernel on the path")
    if demotions:
        failures.append(f"kernel demotion booked: {demotions}")
    if pri0 is None or not pri0 <= 1e-3:
        failures.append(f"iter-0 max pri_rel {pri0:.3e} above the gate")
    w_sum = float((ph.prob @ ph.W).abs().max())
    if w_sum > 1e-8 * max(1.0, float(ph.W.abs().max())):
        failures.append(f"sum_s p_s W_s = {w_sum:.3e} is not 0")
    finite = [tbound, eobj, conv] + [r["conv"] for r in rows]
    if not all(np.isfinite(v) for v in finite) \
            or not bool(torch.isfinite(ph.xbar).all()):
        failures.append(f"non-finite bound or iterate: {finite}")
    if ph.x.shape != (batch.S, batch.n):
        failures.append(f"x is not full width: {tuple(ph.x.shape)}")
    row = {"phase": "shrink_path", "S": batch.S, "n": batch.n,
           "m": batch.m, "K": batch.K, "options": dict(SHRINK_OPTS),
           "ship_s": t_ship, "ph_main_s": t_main,
           "iter0_max_pri_rel": pri0, "iterations": rows,
           "shrink_status": st, "trivial_bound": tbound,
           "eobjective": eobj, "conv": conv, "launches": launches,
           "compacted_plan_launches": None if plan is None
           else plan.launches, "demotions": len(demotions),
           "sum_p_W_max": w_sum, "peak_gb": peak_gb}
    err = 0.0
    if "st" in first:
        f, d, q, st0 = first["f"], first["d"], first["q"], first["st"]
        S, n_c = st0.x.shape
        m_c = st0.zA.shape[1]
        row["first_compacted_shape"] = {"m_c": m_c, "n_c": n_c}
        row["last_compacted_shape"] = {"m_c": st["m_rows"],
                                       "n_c": st["n_cols"]}
        if not admm_block.scope_supported(f, st0):
            failures.append("the compacted solve left the block's scope")
        err, fl = compare(f, d, q, st0, 20, "shrink_compacted")
        failures += fl
        steps = 20
        ms = cuda_ms(lambda: admm_block.fused_admm_block(
            f, d, q, st0, n_steps=steps, sigma=f.sigma, scen_tile=0), 2)
        L = st0.L
        lib = library_ms(f.A_s, L, S, steps)
        admm_block.LAUNCHES = launches   # comparison and timing launches
        # the byte bound as PERF.md §6 works it: A and F each read once
        # per step, at the data-sheet bandwidth
        row.update(block_ms_per_step=ms / steps,
                   byte_bound_ms_per_step=8 * (m_c * n_c + n_c * n_c)
                   / HBM_BYTES_PER_S * 1e3,
                   full_width_byte_bound_ms_per_step=8 * (
                       batch.m * batch.n + batch.n * batch.n)
                   / HBM_BYTES_PER_S * 1e3,
                   library_ms_per_step=lib)
        del f, d, q, st0, L
    else:
        failures.append("no compacted solve was seen")
    first.clear()
    full = [r["seconds"] for r in rows if r["solve_n"] == batch.n]
    comp = [r["seconds"] for r in rows if r["solve_n"] < batch.n]
    row["s_per_iter_full_width"] = full
    row["s_per_iter_compacted"] = comp
    if not failures:
        row["equivalence"] = _shrink_equivalence(dev, batch, ph)
    log(json.dumps(row))
    del ph
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    return launches, err, failures


def _expanded_state(ph, full):
    """``ph``'s compacted prox-on solver state as a warm start of
    ``full``'s prox-on factors: unscaled with the compacted factors (the
    row slacks re-centred by the plan's rhs shift), expanded to full
    width (the fixed columns at their folded values, the dropped rows'
    slacks A·x, their duals and the fixed columns' bound duals 0), then
    scaled with the full factors (ops/shrink._transplant_rescale's
    relations, the other way)."""
    import torch
    from mpisppy_tpu_torch.ops.shrink import expand_solution
    plan = ph._shrink
    fc, _ = ph._get_factors(True)
    st = ph._qp_states[True]
    ff, fd = full._get_factors(True)

    def b2(v):
        return v if v.ndim == 2 else v.unsqueeze(0)

    S = st.x.shape[0]
    rows = torch.as_tensor(plan.keep_rows_np, device=st.x.device)
    n, m = plan.n_full, plan.m_full
    x_u = expand_solution(st.x * b2(fc.D), plan.fixed_colvals,
                          plan.keep_cols, plan.fixed_cols, n)
    zB_u = expand_solution(st.zB / b2(fc.Eb), plan.fixed_colvals,
                           plan.keep_cols, plan.fixed_cols, n)
    yB_u = torch.zeros((S, n), dtype=x_u.dtype, device=x_u.device) \
        .index_copy(1, plan.keep_cols, st.yB * b2(fc.Eb) / fc.cost_scale)
    zA_u = (x_u @ fd.A.T).index_copy(
        1, rows, st.zA / b2(fc.E) + plan.rhs_shift)
    yA_u = torch.zeros((S, m), dtype=x_u.dtype, device=x_u.device) \
        .index_copy(1, rows, st.yA * b2(fc.E) / fc.cost_scale)
    cs = ff.cost_scale
    return dict(x=x_u / b2(ff.D), zB=b2(ff.Eb) * zB_u,
                zA=b2(ff.E) * zA_u, yA=cs * yA_u / b2(ff.E),
                yB=cs * yB_u / b2(ff.Eb))


def _pin_boosted_factors(full):
    """Install ``full``'s prox-on factors set up on its PINNED boxes, so
    the ADMM rho of the fixed columns is eq-boosted as a pinned solve's
    is (core/ph _get_factors(fixed=True) does so for every nonant); the
    cached data stays unpinned, as there."""
    from mpisppy_tpu_torch.ops.qp_solver import qp_setup
    d = full._data_with_prox(True)
    idx, fm, fv = full.nonant_idx, full._fixed_mask, full._fixed_vals
    pinned = d._replace(
        lb=d.lb.index_copy(1, idx, d.lb[:, idx].where(~fm, fv)),
        ub=d.ub.index_copy(1, idx, d.ub[:, idx].where(~fm, fv)))
    full._factors[True] = (qp_setup(pinned, q_ref=full.c), d)


def _shrink_equivalence(dev, batch, ph):
    """One prox-on iteration compacted (``ph``, from its own warm state)
    and one on the full pin-box system (a new engine with uc-ref-S10's
    options and no compaction, carrying ``ph``'s PH state and its solver
    state expanded to full width), both solved to SHRINK_EQUIV_SOLVE's
    tolerance on the reference backend: the relative differences in
    Eobjective and x̄ beside the JAX round trip bar (tests/test_shrink.py
    :116, rel 1e-5)."""
    from mpisppy_tpu_torch.core.ph import PH
    from mpisppy_tpu_torch.ops.kernels import admm_block
    n0 = admm_block.LAUNCHES
    # both solves to solver tolerance: the block's fixed-rho budget
    # leaves each system's iterate short of its optimum (ROADMAP B6),
    # which would hide the compaction's arithmetic behind that gap
    solve = dict(SHRINK_EQUIV_SOLVE)
    full = PH(batch, dict(PH_OPTS, **solve), device=dev)
    ph.sub_kernel_backend = solve["subproblem_kernel_backend"]
    ph.sub_max_iter = solve["subproblem_max_iter"]
    ph.sub_eps_hot = solve["subproblem_eps_hot"]
    ph.sub_eps_dua_hot = solve["subproblem_eps_dua_hot"]
    ph._retired_launches += ph._kernel_plans.pop(True).launches
    _carried(ph, full)
    _pin_boosted_factors(full)
    warm = _expanded_state(ph, full)
    full._qp_states[True] = full._ensure_state(True)._replace(**warm)
    del warm
    t0 = time.perf_counter()
    ph.solve_loop(w_on=True, prox_on=True)
    _sync()
    t_c = time.perf_counter() - t0
    t0 = time.perf_counter()
    full.solve_loop(w_on=True, prox_on=True)
    _sync()
    t_f = time.perf_counter() - t0
    eobj_c, eobj_f = ph.Eobjective_value(), full.Eobjective_value()
    admm_block.LAUNCHES = n0
    out = {"eobjective_compacted": eobj_c, "eobjective_pin_box": eobj_f,
           "eobjective_rel_diff": abs(eobj_c - eobj_f) / abs(eobj_f),
           "xbar_rel_diff": _max_rel_diff(full.xbar, ph.xbar),
           "jax_roundtrip_bar_rel": 1e-5,
           "solve_loop_s_compacted": t_c, "solve_loop_s_pin_box": t_f}
    del full
    return out


class RankLog(Snapshot):
    """Snapshot for a mesh rank: x̄ and W after prox-on iteration
    ``at`` as every rank's rows (gathered on every rank, in step), and
    iter 0's seconds kept, not printed (the rank's result carries
    them)."""

    def post_solve(self, ph):
        if ph._iter == 0 and self.t is None:
            self.iter0_s = time.perf_counter() - self.t0

    def miditer(self, ph):
        IterLog.miditer(self, ph)
        if ph._iter == self.at:
            self.xbar = ph.gather_rows(ph.xbar).cpu().numpy()
            self.W = ph.gather_rows(ph.W).cpu().numpy()


def _mesh_rank(mesh, npz, steps, reps):
    """One rank of phase 19 (run by parallel/launch in its own process,
    on ``mesh.device``): load the main path's batch, run PH sharded over
    the mesh, gather x̄ and W (after prox-on iteration 1 and at the end),
    then every rank holds the block against its plain version on its
    prox-on operands; rank 0 then times the block on its own while the
    other ranks wait in a collective. Returns host values."""
    import torch
    from mpisppy_tpu_torch import obs
    from mpisppy_tpu_torch.core.ph import PH
    from mpisppy_tpu_torch.ir.batch import load_batch
    from mpisppy_tpu_torch.ops.kernels import admm_block
    from mpisppy_tpu_torch.utils.runtime import pin_precision
    pin_precision()
    dev = mesh.device
    on_card = dev.type == "cuda"     # a CPU rank only in a rehearsal

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    t0 = time.perf_counter()
    batch = load_batch(npz)
    t_load = time.perf_counter() - t0
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    it_log = RankLog()
    t0 = time.perf_counter()
    ph = PH(batch, dict(PH_OPTS), mesh=mesh, extensions=it_log)
    sync()
    t_ship = time.perf_counter() - t0
    obs.configure()
    admm_block.LAUNCHES = 0
    t0 = it_log.t0 = time.perf_counter()
    conv, eobj, tbound = ph.ph_main()
    sync()
    t_main = time.perf_counter() - t0
    launches = admm_block.LAUNCHES
    demotions = len(obs.events("kernel.cuda_demotion"))
    gate_syncs = obs.counters_snapshot().get("ph.gate_syncs", 0)
    obs.shutdown()
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9 if on_card \
        else None
    xbar = ph.gather_rows(ph.xbar).cpu().numpy()
    W = ph.gather_rows(ph.W).cpu().numpy()
    plans = sorted({p.backend for p in ph._kernel_plans.values()})
    factors, data = ph._get_factors(True)
    st = ph._qp_states[True]
    q, _, _ = _assembled_q(ph, data)
    # the parent prints every rank's record: two ranks writing one
    # stdout file at once can lose a line
    lines = []
    err, failures = compare(factors, data, q, st, steps,
                            f"mesh_rank{mesh.rank}", sink=lines.append)
    S, n = st.x.shape
    m = st.zA.shape[1]
    timing = None
    wait = torch.zeros(1, device=dev)
    mesh.all_sum(wait)            # rank 0 times the block alone
    if mesh.rank == 0 and on_card:
        ops = block_operands(factors, data, q, st)

        def kern():
            admm_block.fused_admm_block(factors, data, q, st,
                                        n_steps=steps,
                                        sigma=factors.sigma, scen_tile=0)

        def plain():
            admm_block.admm_block_plain(*ops, sigma=factors.sigma,
                                        n_steps=steps, alpha=ALPHA)

        t = {"plain": [], "kernel": []}
        for name, fn in (("plain", plain), ("kernel", kern),
                         ("kernel", kern), ("plain", plain)):
            t[name].append(cuda_ms(fn, reps))
        t_bytes, t_ops = block_bound(S, m, n, steps)
        timing = {"steps_per_call": steps, "measured_ms": t,
                  "ms": sum(t["kernel"]) / 2, "plain_ms": sum(t["plain"]) / 2,
                  "bound_ms": max(t_bytes, t_ops),
                  "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    mesh.all_sum(wait)            # the other ranks wait for the timing
    return {"rank": mesh.rank, "device": str(dev), "backend": mesh.backend,
            "rows": S, "n": n, "m": m, "launches": launches,
            "demotions": demotions, "gate_syncs": gate_syncs,
            "plans": plans, "conv": conv, "eobjective": eobj,
            "trivial_bound": tbound, "xbar": xbar, "W": W,
            "xbar1": it_log.xbar, "W1": it_log.W,
            "iterations": it_log.rows,
            "iter0_s": getattr(it_log, "iter0_s", None),
            "load_s": t_load, "ship_s": t_ship, "ph_main_s": t_main,
            "peak_gb": peak_gb, "max_abs_err": err, "failures": failures,
            "block_timing": timing, "log_lines": lines}


def mesh_path(ref, npz_dir):
    """Phase 19: the main path's batch and options sharded over
    MESH_RANKS ranks (uc-ref-S10-mesh2), held against the main path's
    run ``ref``. Returns (launches of every rank, the largest kernel vs
    plain difference, failures)."""
    import numpy as np
    import torch
    from mpisppy_tpu_torch.ops.kernels import admm_block
    from mpisppy_tpu_torch.parallel.launch import choose_backend, launch
    cards = torch.cuda.device_count()
    t0 = time.perf_counter()
    outs = launch(_mesh_rank, MESH_RANKS,
                  (os.path.join(npz_dir, "batch.npz"), 20, 3),
                  timeout=900)
    t_wall = time.perf_counter() - t0
    failures = []
    for o in outs:
        failures += o.pop("failures")
        for line in o.pop("log_lines"):
            log(line)
        solves = 1 + len(o["iterations"])
        expected = solves * admm_block.admm_block_launches(SLICE_BUDGET,
                                                           False)
        tag = f"rank {o['rank']}"
        if o["launches"] != expected or o["launches"] == 0:
            failures.append(f"{tag}: admm_block launched {o['launches']} "
                            f"kernels, expected {expected}")
        if o["demotions"] or o["plans"] != ["cuda"]:
            failures.append(f"{tag}: demotion or a non-cuda plan: "
                            f"{o['demotions']}, {o['plans']}")
        if o["gate_syncs"] != 0:
            failures.append(f"{tag}: {o['gate_syncs']} gate reads on the "
                            "unchunked loop")
    r0 = outs[0]
    d = {}
    # x̄ and W after prox-on iteration 1 and after the run, held at
    # MESH_BAR. Phase 5's chunked run equals its unchunked run bit for
    # bit (its 16-row chunks keep the 2-row polish groups), so it holds
    # 1e-9. The mesh's combine sums each rank's node tables, which
    # rounds x̄ another way than one product over 10 rows (see MESH_BAR)
    for k in ("xbar1", "W1", "xbar", "W"):
        a, b = torch.as_tensor(ref[k]), torch.as_tensor(r0[k])
        d[k] = _max_rel_diff(a, b)
        for o in outs[1:]:
            if not np.array_equal(o[k], r0[k]):
                failures.append(f"rank {o['rank']}'s {k} differs from "
                                "rank 0's")
        if not d[k] <= MESH_BAR:
            failures.append(f"mesh {k} differs from the main path's by "
                            f"{d[k]:.3e} (bar {MESH_BAR:g})")
    d["conv"] = abs(r0["conv"] - ref["conv"]) / max(1.0, abs(ref["conv"]))
    if not d["conv"] <= MESH_BAR:
        failures.append(f"mesh conv {r0['conv']} against {ref['conv']}")
    for k in ("eobjective", "trivial_bound"):
        d[k] = abs(r0[k] - ref[k]) / max(1.0, abs(ref[k]))
        if not d[k] <= 2e-6:
            failures.append(f"mesh {k} {r0[k]} against {ref[k]} "
                            f"(rel {d[k]:.3e}, bar 2e-6)")
    for o in outs:
        for k in ("xbar", "W", "xbar1", "W1"):
            del o[k]
    log(json.dumps({"phase": "mesh_path", "cell": "uc-ref-S10-mesh2",
                    "ranks": MESH_RANKS, "cards": cards,
                    "backend": choose_backend(MESH_RANKS),
                    "wall_s": t_wall, "rel_diff_vs_main_path": d,
                    "per_rank": outs}))
    return (sum(o["launches"] for o in outs),
            max(o["max_abs_err"] for o in outs), failures, r0)


def entry_path(dev):
    """Phase 18: the port's twin of __graft_entry__.entry() run once on
    the card: one PH step on uc(S=8, G=4, T=6); checks the output shapes
    and that every output is finite."""
    import torch
    from mpisppy_tpu_torch.entry import entry
    t0 = time.perf_counter()
    fn, args = entry(device=dev)
    out = fn(*args)
    _sync()
    t = time.perf_counter() - t0
    st, x, yA, yB, xn, xbar, xsqbar, W, conv, base, solved, dual = out
    S, n = args[3].shape
    K = args[10].shape[1]
    m = args[2].l.shape[1]
    want = {"x": (x, (S, n)), "yA": (yA, (S, m)), "yB": (yB, (S, n)),
            "xn": (xn, (S, K)), "xbar": (xbar, (S, K)),
            "xsqbar": (xsqbar, (S, K)), "W": (W, (S, K)),
            "conv": (conv, ()), "base_obj": (base, (S,)),
            "solved_obj": (solved, (S,)), "dual_obj": (dual, (S,)),
            "state.x": (st.x, (S, n))}
    failures = []
    for name, (v, shape) in want.items():
        if tuple(v.shape) != shape:
            failures.append(f"entry {name} shape {tuple(v.shape)}, "
                            f"expected {shape}")
        if v.device.type != torch.device(dev).type \
                or not bool(torch.isfinite(v).all()):
            failures.append(f"entry {name} not finite on the card")
    log(json.dumps({"phase": "entry_path", "S": S, "n": n, "m": m, "K": K,
                    "seconds": t, "conv": float(conv),
                    "eobjective": float(args[6] @ base),
                    "iters": int(st.iters), "ok": not failures}))
    return failures


def ef_linprog(batch):
    """The host HiGHS LP of ``batch``'s extensive form, built as
    tests/test_models.py's ef_linprog builds it: S copies of the
    scenario rows and boxes, the nonant columns tied to scenario 0 by
    equality rows, the probability-weighted cost (the blocks in sparse
    form). Returns (objective, seconds)."""
    import numpy as np
    from scipy import sparse
    from scipy.optimize import linprog

    t0 = time.perf_counter()
    S, n, K = batch.S, batch.n, batch.K
    idx = np.asarray(batch.nonant_idx)
    N = S * n
    cost = (batch.prob[:, None] * batch.c).reshape(-1)

    def place(block, s):
        block = sparse.csr_matrix(block)
        return sparse.hstack([sparse.csr_matrix((block.shape[0], s * n)),
                              block,
                              sparse.csr_matrix((block.shape[0],
                                                 N - (s + 1) * n))])

    ub_blocks, b_ub, eq_blocks, b_eq = [], [], [], []
    for s in range(S):
        A, l, u = np.asarray(batch.A_of(s)), batch.l[s], batch.u[s]
        eq = np.isfinite(l) & np.isfinite(u) & (l == u)
        ub_rows = np.isfinite(u) & ~eq
        lb_rows = np.isfinite(l) & ~eq
        for rows, sign, rhs in ((ub_rows, 1.0, u), (lb_rows, -1.0, -l)):
            if rows.any():
                ub_blocks.append(place(sign * A[rows], s))
                b_ub.append(rhs[rows])
        if eq.any():
            eq_blocks.append(place(A[eq], s))
            b_eq.append(l[eq])
        if s > 0:   # nonanticipativity: x_s[k] == x_0[k]
            kk = np.arange(K)
            eq_blocks.append(sparse.csr_matrix(
                (np.concatenate([np.ones(K), -np.ones(K)]),
                 (np.concatenate([kk, kk]),
                  np.concatenate([s * n + idx, idx]))), shape=(K, N)))
            b_eq.append(np.zeros(K))
    lb = np.asarray(batch.lb).reshape(-1)
    ub = np.asarray(batch.ub).reshape(-1)
    bounds = [(lo if np.isfinite(lo) else None,
               hi if np.isfinite(hi) else None) for lo, hi in zip(lb, ub)]
    res = linprog(cost,
                  A_ub=sparse.vstack(ub_blocks).tocsr() if ub_blocks
                  else None,
                  b_ub=np.concatenate(b_ub) if b_ub else None,
                  A_eq=sparse.vstack(eq_blocks).tocsr() if eq_blocks
                  else None,
                  b_eq=np.concatenate(b_eq) if b_eq else None,
                  bounds=bounds, method="highs")
    if res.status != 0:
        raise RuntimeError(f"host EF LP failed: {res.message}")
    return (float(res.fun + float(batch.prob @ batch.c0)),
            time.perf_counter() - t0)


def ef_path(dev):
    """Phase 14: ``python -m mpisppy_tpu_torch uc --EF`` on the reference
    instance at EF_SCENARIOS (every width kept) and ``farmer --EF``,
    through vanilla.build_batch_for and ExtensiveForm on the card, each
    held against its reference value. Returns the list of failed
    checks; prints one JSON line."""
    import numpy as np
    import torch
    from mpisppy_tpu_torch.core.ef import ExtensiveForm
    from mpisppy_tpu_torch.utils.config import RunConfig
    from mpisppy_tpu_torch.utils.vanilla import build_batch_for

    on_card = torch.device(dev).type == "cuda"
    failures, rows = [], {}
    for name, cfg, budget in (
            ("farmer", RunConfig(model="farmer", num_scens=3,
                                 solve_ef=True, device=str(dev)), 40000),
            ("uc", RunConfig(model="uc", num_scens=EF_SCENARIOS,
                             model_kwargs=dict(SLICE_INSTANCE),
                             solve_ef=True, device=str(dev)), EF_BUDGET)):
        cfg.validate()
        batch = build_batch_for(cfg)
        if name == "farmer":
            want, t_ref, rel, abs_ = -108390.0, 0.0, 1e-4, 0.0
        else:
            want, t_ref = ef_linprog(batch)
            rel, abs_ = 2e-3, 2e-2
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        ef = ExtensiveForm(batch, device=cfg.device)
        _sync()
        t_build = time.perf_counter() - t0
        t0 = time.perf_counter()
        got, xb = ef.solve_extensive_form(max_iter=budget)
        _sync()
        t_solve = time.perf_counter() - t0
        st = ef.solver_state
        tol = max(rel * abs(want), abs_)
        rows[name] = {
            "S": batch.S, "n_ef": ef.n_ef,
            "m_ef": int(ef.ef_data.A.shape[-2]),
            "ef_objective": got, "reference": want,
            "reference_s": t_ref, "abs_diff": abs(got - want), "tol": tol,
            "build_s": t_build, "solve_s": t_solve, "iterations": st.iters,
            "budget": budget, "pri_rel": float(st.pri_rel.max()),
            "dua_rel": float(st.dua_rel.max()),
            "peak_gb": (torch.cuda.max_memory_allocated() / 1e9
                        if on_card else None)}
        if not (np.isfinite(got) and np.isfinite(xb).all()
                and xb.shape == (batch.S, batch.n)):
            failures.append(f"{name} EF: non-finite or misshapen result")
        if not abs(got - want) <= tol:
            failures.append(f"{name} EF objective {got} is {abs(got - want)}"
                            f" from the reference {want} (band {tol})")
        del ef, st, xb, batch
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
    log(json.dumps({"phase": "ef_path", **rows}))
    return failures


# ---------------- phase 20: scenario streaming ----------------

# the streaming path (phase 20, cells uc-ref-S16-chunk8-synth and
# uc-ref-S16-chunk8-streamed): the UC synth family at the slice's
# widths, built through utils/vanilla's batch path at the CLI's default
# synth_seed, S = STREAM_SCENARIOS in chunks of STREAM_CHUNK (two
# chunks: chunk 1 crosses the bus while chunk 0 solves), PH_OPTS with
# STREAM_ITERS prox-on iterations
STREAM_SCENARIOS = 16
STREAM_CHUNK = 8
STREAM_SEED = 0
STREAM_ITERS = 1
# the int8 staging check's gate: at the CLI's --stream-int8-tol default
# (1e-3) the gate keeps every varying field of this family in f64 (the
# wind's range over 254 levels exceeds it, as measured on an H100 80GB
# HBM3 at 700 W), so the check packs at 1e-2
STREAM_INT8_TOL = 1e-2


class _ProfiledIteration(IterLog):
    """IterLog that runs torch.profiler over prox-on iteration 1 (from
    the end of iter 0 to the end of iteration 1's solve pass) and keeps
    the scenario source's status on both sides of it."""

    def __init__(self, trace_path):
        super().__init__()
        self.trace_path = trace_path
        self.prof = None
        self.before = self.after = None

    def post_iter0(self, ph):
        import torch
        super().post_iter0(ph)
        _sync()
        self.before = ph._stream_source.status()
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.start()
        self.t = time.perf_counter()

    def miditer(self, ph):
        if ph._iter == 1 and self.prof is not None:
            _sync()
            self.prof.stop()
            self.after = ph._stream_source.status()
            self.prof.export_chrome_trace(self.trace_path)
            self.prof = None
        super().miditer(ph)


def _device_records(trace_path):
    """(kernels, HtoD copies) of a chrome trace: kernels as (name, start
    us, end us), copies as (start us, end us, bytes, pinned)."""
    with open(trace_path) as fh:
        events = json.load(fh).get("traceEvents", [])
    kernels, copies = [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, name = e.get("cat", ""), e.get("name", "")
        t0, t1 = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0))
        if cat == "kernel":
            kernels.append((name, t0, t1))
        elif cat == "gpu_memcpy" and "HtoD" in name:
            copies.append((t0, t1, int(e.get("args", {}).get("bytes", 0)),
                           "Pinned" in name))
    kernels.sort(key=lambda k: k[1])
    copies.sort()
    return kernels, copies


def _block_calls(kernels):
    """(start, end) of each block call in the trace: its w_prologue
    kernel to its finalize kernel."""
    starts = [k[1] for k in kernels if "w_prologue" in k[0]]
    ends = [k[2] for k in kernels if "finalize_kernel" in k[0]]
    return list(zip(starts, ends))


def _stream_family(dev):
    """(synthesized batch, spec, the same family materialized on the card
    as a resident batch, seconds): the synthesized batch through
    utils/vanilla.build_batch_for, the twin from the same spec's values
    generated on ``dev``."""
    import dataclasses

    import numpy as np
    from mpisppy_tpu_torch.stream.synth import materialize
    from mpisppy_tpu_torch.utils.config import AlgoConfig, RunConfig
    from mpisppy_tpu_torch.utils.vanilla import build_batch_for

    cfg = RunConfig(model="uc", num_scens=STREAM_SCENARIOS,
                    model_kwargs=dict(SLICE_INSTANCE,
                                      synth_seed=STREAM_SEED),
                    algo=AlgoConfig(scenario_source="synthesized"),
                    hub_options={"subproblem_chunk": STREAM_CHUNK},
                    device=str(dev))
    cfg.validate()
    t0 = time.perf_counter()
    b_syn = build_batch_for(cfg)
    spec = b_syn._synth_spec
    vecs = {f: np.array(getattr(b_syn, f)) for f in ("l", "u", "lb", "ub")}
    for fname, blocks in materialize(spec, b_syn.S, device=dev).items():
        for start, stop, vals in blocks:
            vecs[fname][:, start:stop] = vals
    b_res = dataclasses.replace(b_syn, **vecs)
    return b_syn, spec, b_res, time.perf_counter() - t0


def _stream_run(dev, batch, opts, trace_path):
    """One PH run of phase 20. Returns the engine, its result, the
    profiling IterLog, launches, demotions, counters and peak GB."""
    import torch
    from mpisppy_tpu_torch import obs
    from mpisppy_tpu_torch.core.ph import PH
    from mpisppy_tpu_torch.ops.kernels import admm_block

    on_card = torch.device(dev).type == "cuda"
    log_ = _ProfiledIteration(trace_path)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    ph = PH(batch, opts, device=dev, extensions=log_)
    obs.configure()
    launches0 = admm_block.LAUNCHES
    log_.t0 = time.perf_counter()
    result = ph.ph_main()
    _sync()
    launches = admm_block.LAUNCHES - launches0
    counters = obs.counters_snapshot()
    demotions = obs.events("kernel.cuda_demotion")
    obs.shutdown()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9 if on_card else None
    return ph, result, log_, launches, demotions, counters, peak_gb


def _int8_staging_check(dev, b_res):
    """Quantize the materialized family (the streamed source's int8 store
    behind its gate), stage every chunk through the pinned side-stream
    pipeline with dequantization on the card, and hold the blocks
    against the exact rows at the gate's tolerance, relative to
    1 + |value|. No PH run. Returns (row, failures)."""
    import numpy as np
    import torch
    from mpisppy_tpu_torch.stream.quant import _reconstruct_f32
    from mpisppy_tpu_torch.stream.source import StreamedSource

    src = StreamedSource(b_res, torch.float64, dev, int8=True,
                         int8_tol=STREAM_INT8_TOL)
    ids = [np.arange(i, i + STREAM_CHUNK)
           for i in range(0, b_res.S, STREAM_CHUNK)]
    src.bind(("int8",), ids)
    kinds = {f: k for f, (k, _) in src._store.items()}
    worst, failures = {}, []
    src.begin_pass()
    for ci, rows in enumerate(ids):
        blk = src.chunk(ci)
        for f in src.fields:
            exact = np.asarray(getattr(b_res, f))[rows]
            got = blk[f].cpu().numpy()
            fin = np.isfinite(exact)
            if not np.array_equal(np.isfinite(got), fin):
                failures.append(f"int8 staging: {f} non-finite pattern")
                continue
            err = float((np.abs(got[fin] - exact[fin])
                         / (1.0 + np.abs(exact[fin]))).max(initial=0.0))
            worst[f] = max(worst.get(f, 0.0), err)
            if kinds[f] == "int8":
                host = _reconstruct_f32(src._store[f][1], rows)
                if not np.array_equal(got, host):
                    failures.append(f"int8 staging: {f} chunk {ci} differs"
                                    " from the host reconstruction")
    src.close()
    for f, e in worst.items():
        if not e <= STREAM_INT8_TOL:
            failures.append(f"int8 staging: {f} off by {e:.3e} (gate "
                            f"{STREAM_INT8_TOL})")
    if "int8" not in kinds.values():
        failures.append("int8 staging: the gate packed no field")
    return {"kinds": kinds, "max_rel_err": worst,
            "host_bytes": src.host_nbytes(),
            "f64_bytes": sum(np.asarray(getattr(b_res, f)).nbytes
                             for f in src.fields),
            "fallbacks": src.status()["int8_fallbacks"]}, failures


def stream_path(dev):
    """Phase 20: the synthesized and the streamed scenario source on the
    reference UC synth family (cells uc-ref-S16-chunk8-synth and
    uc-ref-S16-chunk8-streamed), PH_OPTS with STREAM_ITERS prox-on
    iterations, each chunk solved by the block. Checks: the two runs'
    x̄, W, conv, Eobjective and trivial bound bit-equal; every
    synthesized chunk's l/u/lb/ub/c rows bit-equal to the materialized
    family's; iter 0 under the gate; block launches by the plan (one
    call per chunk and solve), no demotion, one gate sync per call; the
    block against its plain version at the first synthesized chunk's
    prox-on operands (compare); the profiler's HtoD records of prox-on
    iteration 1: none of a scenario row's size for the synthesized run,
    the booked stream.bytes_shipped delta exactly and from pinned memory
    for the streamed run, with chunk k's solve-pass copy inside chunk
    k-1's solve interval (from the end of chunk k-2's block call, or of
    chunk 0's copy, to the end of chunk k-1's block call); and the int8
    staging check. Returns (launches, largest difference, failures)."""
    import tempfile

    import numpy as np
    import torch
    from mpisppy_tpu_torch.core.ph import _ph_assemble
    from mpisppy_tpu_torch.ops.kernels import admm_block

    b_syn, spec, b_res, t_family = _stream_family(dev)
    base = {**PH_OPTS, "PHIterLimit": STREAM_ITERS,
            "subproblem_chunk": STREAM_CHUNK}
    tmp = tempfile.mkdtemp(prefix="stream_trace_")
    failures, rows, ends = [], {}, {}
    n_chunks = -(-STREAM_SCENARIOS // STREAM_CHUNK)
    per_call = admm_block.admm_block_launches(SLICE_BUDGET, False)
    launches_all = 0
    row_bytes = 8 * b_syn.n
    # the streamed run first: its engine and its copy of A go before the
    # synthesized run, so each run's peak is its own
    for name, batch, extra in (
            ("streamed", b_res, {"scenario_source": "streamed"}),
            ("synthesized", b_syn, {"scenario_source": "synthesized",
                                    "synth_spec": spec})):
        trace = os.path.join(tmp, f"{name}.json")
        ph, result, it_log, launches, demotions, counters, peak_gb = \
            _stream_run(dev, batch, {**base, **extra}, trace)
        launches_all += launches
        ends[name] = {"xbar": ph.xbar.cpu(), "W": ph.W.cpu(),
                      "conv": ph.conv, "eobjective": result[1],
                      "trivial_bound": ph.trivial_bound}
        solves = 1 + len(it_log.rows)
        expected = n_chunks * solves * per_call
        pri0 = float(ph._qp_states[False].pri_rel.max())
        if pri0 >= 1e-3:
            failures.append(f"{name}: iter-0 max pri_rel {pri0:.3e}")
        if launches != expected:
            failures.append(f"{name}: {launches} block kernels launched, "
                            f"expected {expected}")
        if demotions:
            failures.append(f"{name}: kernel demotion booked: {demotions}")
        timing = {str(k): ph.phase_timing(k) for k in (False, True)}
        for k, t in timing.items():
            if t["gate_d2h_syncs_per_call"] != 1.0:
                failures.append(f"{name} mode {k}: "
                                f"{t['gate_d2h_syncs_per_call']} gate "
                                "syncs per call")
        kernels, copies = _device_records(trace)
        calls = _block_calls(kernels)
        row = {"ph_s_per_iteration": [r["seconds"] for r in it_log.rows],
               "iterations": it_log.rows, "iter0_max_pri_rel": pri0,
               "result": list(result), "launches": launches,
               "expected_launches": expected, "peak_gb": peak_gb,
               "prefetch_stalls": counters.get("stream.prefetch_stalls",
                                               0),
               "phase_seconds": {k: t["seconds_per_call"]
                                 for k, t in timing.items()},
               "profiled": {"kernels": len(kernels),
                            "block_calls": len(calls),
                            "htod_copies": len(copies),
                            "htod_bytes": sum(c[2] for c in copies)}}
        if not kernels:
            failures.append(f"{name}: the profiler recorded no kernel in "
                            "prox-on iteration 1")
        if len(calls) != n_chunks:
            failures.append(f"{name}: {len(calls)} block calls profiled "
                            f"in iteration 1, expected {n_chunks}")
        big = [c for c in copies if c[2] >= row_bytes and not c[3]]
        if name == "synthesized":
            big += [c for c in copies if c[2] >= row_bytes]
            if big:
                failures.append(f"synthesized: {len(big)} HtoD copies of "
                                "a scenario row's size or more in "
                                "iteration 1")
        else:
            booked = it_log.after["bytes_shipped"] \
                - it_log.before["bytes_shipped"]
            pinned = [c for c in copies if c[3]]
            row["htod_pinned_bytes"] = sum(c[2] for c in pinned)
            row["booked_bytes_shipped"] = booked
            if row["htod_pinned_bytes"] != booked:
                failures.append(f"streamed: the profiler's pinned HtoD "
                                f"bytes {row['htod_pinned_bytes']} differ"
                                f" from the booked {booked}")
            if big:
                failures.append(f"streamed: {len(big)} pageable HtoD "
                                "copies of a scenario row's size")
            # the copies group by chunk: the prox-on mode's cold-state
            # fetch of chunk 0, the solve pass, the objective pass
            src = ph._stream_source
            parts = len(src._host_parts(src._np_ids[0], src._store,
                                        src._tmpl_dev))
            groups = [pinned[i:i + parts]
                      for i in range(0, len(pinned), parts)]
            row["copy_groups"] = len(groups)
            if len(groups) != 1 + 2 * n_chunks:
                failures.append(f"streamed: {len(groups)} copy groups, "
                                f"expected {1 + 2 * n_chunks}")
            else:
                solve_pass = groups[1:1 + n_chunks]
                row["h2d_ms_per_chunk"] = [
                    sum(c[1] - c[0] for c in g) / 1e3 for g in solve_pass]
                overlap = []
                for k in range(1, n_chunks):
                    g = solve_pass[k]
                    lo = calls[k - 2][1] if k >= 2 \
                        else solve_pass[0][-1][1]
                    hi = calls[k - 1][1]
                    c0, c1 = g[0][0], g[-1][1]
                    overlap.append({
                        "chunk": k, "copy_us": c1 - c0,
                        "after_window_start_us": c0 - lo,
                        "before_window_end_us": hi - c1,
                        "after_block_start_us": c0 - calls[k - 1][0],
                        "before_next_block_us": calls[k][0] - c1})
                    if not (lo <= c0 and c1 <= hi):
                        failures.append(
                            f"streamed: chunk {k}'s copy "
                            f"[{c0:.1f}, {c1:.1f}] us lies outside chunk "
                            f"{k - 1}'s solve interval [{lo:.1f}, "
                            f"{hi:.1f}]")
                row["copy_in_solve_interval"] = overlap
        rows[name] = row
        if name == "streamed":
            ph.close_stream()
            del ph
            batch.__dict__.pop("_dev_cache", None)
            gc.collect()
            if torch.device(dev).type == "cuda":
                torch.cuda.empty_cache()
    syn = ph
    a, b = ends["synthesized"], ends["streamed"]
    same = {k: (torch.equal(a[k], b[k]) if k in ("xbar", "W")
                else a[k] == b[k]) for k in a}
    for k, ok in same.items():
        if not ok:
            failures.append(f"synthesized and streamed differ in {k}")
    # every synthesized chunk against the materialized rows
    src = syn._stream_source
    staged_equal = True
    for ci, ids in enumerate(src._np_ids):
        blk = src._assemble(src._ids_dev[ci])
        for f in src.fields:
            want = torch.as_tensor(np.asarray(getattr(b_res, f))[ids],
                                   device=dev)
            if not torch.equal(blk[f], want):
                staged_equal = False
                failures.append(f"synthesized chunk {ci}'s {f} rows "
                                "differ from the materialized family")
    if torch.device(dev).type == "cuda":
        synth_ms = cuda_ms(lambda: src._assemble(src._ids_dev[0]), 5)
    else:
        t0 = time.perf_counter()
        src._assemble(src._ids_dev[0])
        synth_ms = (time.perf_counter() - t0) * 1e3
    # the block against its plain version at the first synthesized
    # chunk's prox-on operands
    factors, data = syn._get_factors(True)
    blk = src._assemble(src._ids_dev[0])
    idx = syn._chunk_index(STREAM_CHUNK)[0][0]
    d = data._replace(l=blk["l"], u=blk["u"], lb=blk["lb"], ub=blk["ub"])
    q, bl, bu = _ph_assemble(d, blk["c"], syn.W[idx], syn.xbar[idx],
                             syn.rho[idx], syn.nonant_idx,
                             syn._fixed_mask[idx], syn._fixed_vals[idx],
                             syn._w_scale, w_on=True, prox_on=True)
    launches_cmp = admm_block.LAUNCHES
    err, f_cmp = compare(factors, d._replace(lb=bl, ub=bu), q,
                         syn._chunk_states[True][0], 20,
                         "stream_path_synthesized_chunk0")
    admm_block.LAUNCHES = launches_cmp   # comparisons are not the path's
    failures += f_cmp
    del syn, ph, src, factors, data, blk, d, q
    gc.collect()
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()
    int8_row, f_int8 = _int8_staging_check(dev, b_res)
    failures += f_int8
    import shutil
    shutil.rmtree(tmp, ignore_errors=True)
    log(json.dumps({
        "phase": "stream_path", "S": STREAM_SCENARIOS,
        "chunk": STREAM_CHUNK, "chunks": n_chunks, "n": b_syn.n,
        "m": b_syn.m, "synth_seed": STREAM_SEED,
        "family_build_s": t_family, "runs": rows,
        "bit_equal": same, "staged_rows_equal": staged_equal,
        "synthesis_ms_per_chunk": synth_ms, "max_abs_err": err,
        "int8_staging": int8_row}))
    return launches_all, err, failures


# the service (phase 23, uc-ref-S2-serve): two requests of the reference
# UC at its widths, SERVE_SCENARIOS scenarios each, one after the other
# (the second the warm-bucket request), each with its own data-only
# patch of the balance rows (every scenario's own net load times the
# factor); the QP is the reference UC's, with relax_integrality True so
# that the consensus evaluation does not round the commitments (x̄
# rounded after one PH iteration is infeasible at the reference UC)
SERVE_SCENARIOS = 2
SERVE_LOADS = (1.00, 1.01)
SERVE_ALGO = {"subproblem_kernel_mode": "fused",
              "subproblem_kernel_backend": "cuda",
              "subproblem_max_iter": SLICE_BUDGET, "default_rho": 100.0,
              "max_iterations": 1, "convthresh": -1.0}
# solves per request: iteration 0, one prox-on iteration and the
# consensus evaluation (fixed nonants, prox off)
SERVE_SOLVES = 3


def _serve_http(url, payload=None, timeout=30):
    import urllib.request
    req = urllib.request.Request(
        url, data=None if payload is None else json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read().decode())


def serve_path(dev):
    """Phase 23 (uc-ref-S2-serve): the port's service on the card. A
    ``ServeService`` (serve/manager.py) behind its HTTP plane
    (serve/http.py) on 127.0.0.1 at an ephemeral port, engines on
    ``dev``, one request per wheel; two UC requests POSTed over loopback
    one after the other: the first builds the bucket's engine, the
    second installs its data into the warm one. Returns (block launches
    of the two requests, the block's largest difference from its plain
    version on the warm request's prox-on operands, the failed checks);
    prints one JSON line."""
    import math
    import shutil
    import tempfile
    import numpy as np
    import torch
    from mpisppy_tpu_torch import obs
    from mpisppy_tpu_torch.ckpt import bundle as ckpt_bundle
    from mpisppy_tpu_torch.core.ph import _ph_assemble
    from mpisppy_tpu_torch.models import uc
    from mpisppy_tpu_torch.ops.kernels import admm_block
    from mpisppy_tpu_torch.serve.http import ServeHTTPServer
    from mpisppy_tpu_torch.serve.manager import ServeService
    from mpisppy_tpu_torch.utils.config import ServeConfig

    kw = dict(SLICE_INSTANCE, relax_integrality=True)
    names = uc.make_tree(SERVE_SCENARIOS).scen_names
    net = np.stack([uc.scenario_vector_patch(nm, **kw)[("l", "balance")]
                    for nm in names])
    per_solve = admm_block.admm_block_launches(SLICE_BUDGET, False)
    state = tempfile.mkdtemp(prefix="serve_state_")
    failures, rows, launches = [], [], 0
    on_card = torch.device(dev).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    obs.configure(out_dir=None)
    t0 = time.perf_counter()
    svc = ServeService(ServeConfig(state_dir=state, device=str(dev),
                                   batch_max=1, batch_window=0.0))
    svc.start()
    srv = ServeHTTPServer(svc, 0, host="127.0.0.1").start()
    base = f"http://127.0.0.1:{srv.port}"
    t_up = time.perf_counter() - t0
    try:
        for f in SERVE_LOADS:
            rhs = (net * f).tolist()
            payload = {"model": "uc", "num_scens": SERVE_SCENARIOS,
                       "model_kwargs": kw, "algo": SERVE_ALGO,
                       "patch": {"l": {"balance": rhs},
                                 "u": {"balance": rhs}}}
            calls0 = obs.counter_value("ph.solve_loop_calls")
            admm_block.LAUNCHES = 0
            t0 = time.perf_counter()
            rid = _serve_http(base + "/solve", payload)["request_id"]
            while True:
                rec = _serve_http(f"{base}/result/{rid}")
                if rec["status"] in ("done", "failed") \
                        or time.perf_counter() - t0 > 900:
                    break
                time.sleep(0.05)
            t_req = time.perf_counter() - t0
            n = admm_block.LAUNCHES
            launches += n
            solves = obs.counter_value("ph.solve_loop_calls") - calls0
            rows.append({"id": rid, "load": f, "status": rec["status"],
                         "error": rec.get("error"), "request_s": t_req,
                         "launches": n, "solves": solves,
                         "result": rec.get("result")})
    finally:
        srv.stop()
        svc.stop()
    demotions = obs.events("kernel.cuda_demotion")
    counters = obs.counters_snapshot()
    obs.shutdown()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9 if on_card else None
    for k, r in enumerate(rows):
        tag = f"request {k} ({r['id']})"
        res = r["result"] or {}
        wheel = res.get("wheel") or {}
        if r["status"] != "done":
            failures.append(f"{tag}: {r['status']} ({r['error']})")
            continue
        if wheel.get("cache_hit") is not bool(k):
            failures.append(f"{tag}: cache_hit {wheel.get('cache_hit')}")
        if k and (wheel.get("kernel_builds_delta") != 0
                  or wheel.get("factor_builds_delta") != 0
                  or wheel.get("xla_compiles_delta") != 0):
            failures.append(f"{tag}: the warm request built kernels or "
                            f"factors: {wheel}")
        if r["solves"] != SERVE_SOLVES \
                or r["launches"] != SERVE_SOLVES * per_solve:
            failures.append(f"{tag}: {r['launches']} block launches over "
                            f"{r['solves']} solves, expected "
                            f"{SERVE_SOLVES} x {per_solve}")
        obj, outer = res.get("objective"), wheel.get("outer_bound")
        if not (res.get("feasible") and obj is not None
                and outer is not None and math.isfinite(obj)
                and math.isfinite(outer) and obj >= outer):
            failures.append(f"{tag}: objective {obj} (feasible "
                            f"{res.get('feasible')}) against outer bound "
                            f"{outer}")
        ns = os.path.join(state, "ckpt", r["id"])
        latest = ckpt_bundle.latest_bundle(ns)
        try:
            pointer = open(os.path.join(ns, ckpt_bundle.LATEST),
                           encoding="utf-8").read().strip()
            ckpt_bundle.load_bundle(latest)
        except (OSError, TypeError, ckpt_bundle.CheckpointError) as e:
            pointer = f"unreadable: {e!r}"
        if latest is None or pointer != os.path.basename(latest):
            failures.append(f"{tag}: no bundle that LATEST resolves to "
                            f"under {ns} ({pointer})")
        r["bundle"] = None if latest is None else os.path.basename(latest)
    bounds = [((r["result"] or {}).get("wheel") or {}).get("outer_bound")
              for r in rows]
    if len(set(bounds)) != len(rows):
        failures.append(f"the requests' outer bounds do not differ: "
                        f"{bounds} (the patch did not reach the card)")
    if demotions:
        failures.append(f"kernel demotion booked: {demotions}")
    # the warm engine, checked back into the service's cache
    err, plans = float("nan"), {}
    ekey = ((rows[-1]["result"] or {}).get("wheel") or {}).get(
        "engine_key") if rows else None
    ent = svc.cache.checkout(ekey, wait=False) if ekey else None
    if ent is None:
        failures.append("the warm engine is not in the service's cache")
    else:
        ph = ent.engine
        plans = {str(k): p.descriptor() for k, p in
                 ph._kernel_plans.items()}
        if not plans or any(p.backend != "cuda"
                            for p in ph._kernel_plans.values()):
            failures.append(f"a kernel plan of the service is not cuda: "
                            f"{plans}")
        factors, data = ph._get_factors(True)
        st = ph._qp_states[True]
        q, _, _ = _ph_assemble(data, ph.c, ph.W, ph.xbar, ph.rho,
                               ph.nonant_idx, ph._fixed_mask,
                               ph._fixed_vals, ph._w_scale, w_on=True,
                               prox_on=True)
        err, f = compare(factors, data, q, st, 20, "serve_warm_prox_on")
        failures += f
        del ph, factors, data, st, q
        svc.cache.discard(ent)
    admm_block.LAUNCHES = launches   # the comparison's are not the path's
    log(json.dumps({
        "phase": "serve_path", "cell": "uc-ref-S2-serve",
        "card": card_line(), "service_up_s": t_up,
        "requests": [{
            "load": r["load"], "status": r["status"],
            "request_s": r["request_s"], "solves": r["solves"],
            "launches": r["launches"], "bundle": r.get("bundle"),
            **{k: ((r["result"] or {}).get("wheel") or {}).get(k)
               for k in ("cache_hit", "seconds", "engine_seconds",
                         "iterations", "outer_bound",
                         "kernel_builds_delta", "factor_builds_delta",
                         "xla_compiles_delta")},
            "objective": (r["result"] or {}).get("objective")}
            for r in rows],
        "expected_launches_per_request": SERVE_SOLVES * per_solve,
        "launches": launches, "demotions": len(demotions),
        "plans": plans, "peak_gb": peak_gb,
        "counters": {k: v for k, v in counters.items()
                     if k.startswith("serve.")}}))
    del svc, srv
    shutil.rmtree(state, ignore_errors=True)
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    return launches, err, failures


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from mpisppy_tpu_torch.ops.kernels import _build
    from mpisppy_tpu_torch.utils.runtime import pin_precision
    pin_precision()

    log(card_line())
    # wall seconds per phase group, printed before the kernels line
    seconds, t_mark = {}, [time.perf_counter()]

    def mark(name):
        now = time.perf_counter()
        seconds[name] = now - t_mark[0]
        t_mark[0] = now

    t0 = time.perf_counter()
    _build.build_all()
    t_build = time.perf_counter() - t0
    ptxas = [ln.strip() for info in _build.BUILD_INFO.values()
             for ln in info["log"].splitlines() if "registers" in ln
             or "spill" in ln]
    log(json.dumps({"phase": "build", "seconds": t_build,
                    "nvcc_seconds": {k: v["seconds"] for k, v in
                                     _build.BUILD_INFO.items()},
                    "ptxas": ptxas}))
    dev = torch.device("cuda")
    mark("1_build")
    kernel_checks(dev)
    mark("2_kernel_checks")
    ph, launches = main_path(dev)
    timing = time_block(ph, steps=20, reps=3)
    mark("3_4_main_path_and_timing")
    # phase 19 holds the mesh against this run, on this batch
    import tempfile
    from mpisppy_tpu_torch.ir.batch import save_batch
    ref = {"xbar": ph.xbar.cpu(), "W": ph.W.cpu(), "conv": ph.conv,
           "xbar1": ph.extensions.xbar.cpu(), "W1": ph.extensions.W.cpu(),
           "eobjective": ph.Eobjective_value(),
           "trivial_bound": ph.trivial_bound}
    npz_dir = tempfile.mkdtemp(prefix="mesh_batch_")
    save_batch(ph.batch, os.path.join(npz_dir, "batch.npz"))
    del ph
    gc.collect()
    torch.cuda.empty_cache()
    try:
        mesh_launches, mesh_err, failures, _ = mesh_path(ref, npz_dir)
    finally:
        import shutil
        shutil.rmtree(npz_dir, ignore_errors=True)
    mark("19_mesh_path")
    if failures:
        raise RuntimeError("mesh path failed: " + "; ".join(failures))
    batch, t_batch = chunk_batch()
    scaling_ops, chunk_launches, chunk_err, native, failures = \
        chunked_path(dev, batch, t_batch)
    mark("5_chunked_path")
    native_ms = block_scaling(scaling_ops)
    mark("6_block_scaling")
    if failures:
        raise RuntimeError("chunked path failed: " + "; ".join(failures))
    del scaling_ops
    gc.collect()
    torch.cuda.empty_cache()
    ref = native_reference(dev, batch)
    # the batch's device cache (core/spbase) still holds the native
    # engines' dense A; the df32 cell ships only the split pair, so its
    # peak must not count that copy
    batch.__dict__.pop("_dev_cache", None)
    gc.collect()
    torch.cuda.empty_cache()
    ph, failures = df32_path(dev, batch, native, ref)
    if failures:
        raise RuntimeError("df32 path failed: " + "; ".join(failures))
    df32_scaling(ph, native_ms)
    mark("7_8_native_reference_df32")
    del ph
    # the APH path ships the dense A again (phase 11)
    batch.__dict__.pop("_dev_cache", None)
    gc.collect()
    torch.cuda.empty_cache()
    mixed_check(dev)
    mark("9_mixed_check")
    (wheel_launches, wheel_err, failures, slice_batch, wheel_xhat,
     phase10) = wheel_path(dev)
    if failures:
        raise RuntimeError("wheel path failed: " + "; ".join(failures))
    mark("10_wheel_path")
    ckpt_launches, ckpt_err, failures = ckpt_path(dev, slice_batch, phase10)
    mark("22_ckpt_path")
    if failures:
        raise RuntimeError("ckpt path failed: " + "; ".join(failures))
    aph_launches, aph_err, failures = aph_path(dev, batch, native)
    mark("11_aph_path")
    if failures:
        raise RuntimeError("aph path failed: " + "; ".join(failures))
    del batch
    gc.collect()
    torch.cuda.empty_cache()
    shard_launches, shard_err, failures = aph_shard_wheel(dev)
    mark("12_aph_shard_wheel")
    if failures:
        raise RuntimeError("aph shard wheel failed: " + "; ".join(failures))
    ls_launches, ls_err, failures = lshaped_path(dev, slice_batch,
                                                 wheel_xhat)
    mark("13_lshaped_path")
    if failures:
        raise RuntimeError("lshaped path failed: " + "; ".join(failures))
    fw_launches, fw_err, failures = fwph_path(dev, slice_batch, phase10)
    mark("15_fwph_path")
    if failures:
        raise RuntimeError("fwph path failed: " + "; ".join(failures))
    bundle_launches, bundle_err, failures = bundle_path(dev, slice_batch,
                                                        phase10)
    mark("16_bundle_path")
    if failures:
        raise RuntimeError("bundle path failed: " + "; ".join(failures))
    shrink_launches, shrink_err, failures = shrink_path(dev, slice_batch)
    mark("17_shrink_path")
    if failures:
        raise RuntimeError("shrink path failed: " + "; ".join(failures))
    failures = entry_path(dev)
    mark("18_entry_path")
    if failures:
        raise RuntimeError("entry path failed: " + "; ".join(failures))
    del slice_batch
    gc.collect()
    torch.cuda.empty_cache()
    failures = ef_path(dev)
    mark("14_ef_path")
    if failures:
        raise RuntimeError("ef path failed: " + "; ".join(failures))
    gc.collect()
    torch.cuda.empty_cache()
    stream_launches, stream_err, failures = stream_path(dev)
    mark("20_stream_path")
    if failures:
        raise RuntimeError("stream path failed: " + "; ".join(failures))
    serve_launches, serve_err, failures = serve_path(dev)
    mark("23_serve_path")
    if failures:
        raise RuntimeError("serve path failed: " + "; ".join(failures))
    launches += chunk_launches + wheel_launches + aph_launches \
        + shard_launches + ls_launches + fw_launches + bundle_launches \
        + shrink_launches + mesh_launches + stream_launches \
        + ckpt_launches + serve_launches
    # the largest difference at any shape of the path
    timing["max_abs_err"] = max(timing["max_abs_err"], chunk_err,
                                wheel_err, aph_err, shard_err, ls_err,
                                fw_err, bundle_err, shrink_err, mesh_err,
                                stream_err, ckpt_err, serve_err)
    entry = {"name": "admm_block", "route": "cuda",
             "source": "mpisppy_tpu_torch/ops/kernels/csrc/admm_block.cu",
             "replaces": "mpisppy_tpu/ops/kernels/pallas_kernel.py:100",
             "launches": launches, **timing}
    log(json.dumps({"phase": "script_seconds", **seconds,
                    "total": sum(seconds.values())}))
    log(json.dumps({"kernels": [entry]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
