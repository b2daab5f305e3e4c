"""Config -> hub/spoke construction dicts (the vanilla analog; the port
of the JAX package's utils/vanilla.py).

Mirrors mpisppy/utils/vanilla.py:30-408: canned factories that turn the
validated RunConfig into the hub/spoke dict schema spin_the_wheel
consumes, one factory per cylinder kind. Every cylinder gets its OWN
engine over one shared host batch, on the run's ``device`` (None = the
CUDA device). What the port does not run yet raises, naming its
ROADMAP.md item: the cross-scenario spoke, and the FWPH spoke and
checkpoints beside a sharded hub. The live status plane
(``status_port``) and checkpoints (``checkpoint_dir``, ``resume_from``:
the hub's options and each spoke's warm-state wiring) ride to the
cylinders as in the JAX package.

Scenario sources (``scenario_source``, mpisppy_tpu_torch/stream): a
streamed or synthesized wheel is hub-only, as in the JAX package; a
synthesized run builds its batch from the model's
``scenario_synth_spec`` (``synth_seed`` in the model kwargs) and the
spec rides to the hub engine as the ``synth_spec`` option.

Scenario-axis mesh (``mesh_devices``): the PH and APH hub engines shard
over the ranks of a ``parallel/mesh.Mesh`` (``hub_dict(cfg, mesh=...)``
on every rank; ``__main__.run`` starts the ranks); the spokes stay
unsharded on rank 0. ``mesh_ranks`` resolves the count with the JAX
package's semantics.
"""

from __future__ import annotations

import torch

from .. import obs
from .config import RunConfig, SpokeConfig

_DTYPES = {"float32": torch.float32, "f32": torch.float32,
           "float64": torch.float64, "f64": torch.float64}

# spoke kinds whose engines are not ported, with their items
_UNPORTED_SPOKES = {"cross_scenario": "A11c"}


def _not_ported(what, item):
    return NotImplementedError(f"{what} is not ported yet (see ROADMAP.md "
                               f"{item})")


def refuse_unported(cfg: RunConfig):
    """Raise for every part of ``cfg`` the port does not run yet."""
    for sp in cfg.spokes:
        if sp.kind in _UNPORTED_SPOKES:
            raise _not_ported(f"the {sp.kind!r} spoke",
                              _UNPORTED_SPOKES[sp.kind])
    if mesh_ranks(cfg, warn=False) > 1 \
            and any(sp.kind == "fwph" for sp in cfg.spokes):
        raise _not_ported("the FWPH spoke beside a sharded hub", "A8b")
    if mesh_ranks(cfg, warn=False) > 1 \
            and (cfg.checkpoint_dir or cfg.resume_from):
        raise _not_ported("checkpoints of a sharded hub engine", "A8b")


def mesh_ranks(cfg: RunConfig, warn=True) -> int:
    """Ranks of the hub engine's scenario mesh (1: unsharded), with the
    JAX package's semantics (its utils/vanilla.py:171-200). ``None``
    is no mesh; 0 means every visible card; a count above the visible
    cards warns and is clipped. On the CPU a rank is a process, not a
    device: a count is taken as given and 0 means one rank. With a
    ``coordinator`` the world is the coordinator's ``num_processes``.
    The L-shaped hub keeps the unsharded path and warns that the flag
    is ignored."""
    import warnings

    if cfg.mesh_devices is None and cfg.coordinator is None:
        return 1
    if cfg.hub not in ("ph", "aph"):
        if warn:
            warnings.warn(
                f"mesh_devices is ignored for this wheel (hub="
                f"{cfg.hub!r}): scenario-axis sharding covers the ph/aph "
                "hubs only", RuntimeWarning, stacklevel=2)
        return 1
    if cfg.coordinator is not None:
        return int(cfg.coordinator.get("num_processes") or 1)
    n = int(cfg.mesh_devices)
    if str(cfg.device or "cuda").startswith("cpu"):
        return max(n, 1)
    n_vis = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n > n_vis and warn:
        warnings.warn(
            f"mesh_devices={n} exceeds the {n_vis} visible card(s) — "
            f"sharding over all {n_vis} (multi-host runs need the "
            "coordinator knob)", RuntimeWarning, stacklevel=2)
    return max(min(n, n_vis) if n else n_vis, 1)


def _pop_dtype(options):
    """Extract an optional per-cylinder "dtype" option ("float32"/"f64"/…)
    into an engine dtype kwarg — e.g. an f32 hub for hot-loop speed with
    f64 bound spokes for certified tightness in the same wheel."""
    name = options.pop("dtype", None)
    if name is None:
        return {}
    return {"dtype": _DTYPES[str(name)]}


def build_batch_for(cfg: RunConfig):
    """Model registry: name -> stacked batch (+ bundling). Models that export
    ``scenario_vector_patch`` get the structure-shared fast path
    (ir/batch.py build_batch(vector_patch=...)) automatically — at
    reference-UC scale that is the difference between one template
    lowering and S of them."""
    from ..ir.batch import build_batch
    from .. import models

    mod = getattr(models, cfg.model)
    kwargs = dict(cfg.model_kwargs)
    if cfg.model in ("hydro", "ccopf"):
        # the creator decodes scenario numbers with the SAME branching
        # the tree was built with: merge the branching given under
        # tree_kwargs or directly in model_kwargs into one source
        tk = dict(kwargs.pop("tree_kwargs", {}))
        bkey = "branching" if cfg.model == "ccopf" else "branching_factors"
        if bkey in kwargs:
            if bkey in tk and tuple(tk[bkey]) != tuple(kwargs[bkey]):
                raise ValueError(
                    f"{cfg.model}: {bkey} given in both model_kwargs and "
                    "tree_kwargs with different values")
            tk.setdefault(bkey, kwargs[bkey])
        tree = mod.make_tree(**tk)
        kwargs.update(tk)
    else:
        tree = mod.make_tree(cfg.num_scens)
    if cfg.algo.scenario_source == "synthesized":
        # the model's synth spec is the single source of the family's
        # data: the creator runs once for the shared template, the batch
        # vectors are zero-stride views of it, and the engine makes the
        # per-scenario perturbations on its device. The spec rides the
        # batch to hub_dict, which passes it as the synth_spec option
        if not hasattr(mod, "scenario_synth_spec"):
            raise ValueError(
                f"scenario_source='synthesized' needs model "
                f"{cfg.model!r} to export scenario_synth_spec (farmer "
                "and uc do)")
        if cfg.num_bundles:
            raise ValueError("bundling merges scenario blocks and is "
                             "not supported with a synthesized "
                             "scenario source")
        from ..stream.synth import synth_batch
        seed = int(kwargs.pop("synth_seed", 0))
        batch, spec = synth_batch(
            mod.scenario_creator, tree, mod.scenario_synth_spec,
            creator_kwargs=kwargs, seed=seed, materialize_values=False)
        batch._synth_spec = spec
        obs.event("batch.build", {"model": cfg.model, "S": batch.S,
                                  "K": batch.K, "n": batch.n,
                                  "shared_A": True,
                                  "scenario_source": "synthesized"})
        return batch
    batch = build_batch(mod.scenario_creator, tree, creator_kwargs=kwargs,
                        vector_patch=getattr(mod, "scenario_vector_patch",
                                             None))
    if cfg.num_bundles:
        from ..core.bundles import form_bundles
        batch = form_bundles(batch, cfg.num_bundles)
    obs.event("batch.build", {"model": cfg.model, "S": batch.S,
                              "K": batch.K, "n": batch.n,
                              "shared_A": bool(batch.shared_A)})
    return batch


def ckpt_fingerprint(cfg: RunConfig) -> str:
    """The run-identity fingerprint stamped into checkpoint bundles
    (ckpt/bundle.config_fingerprint): a bundle only resumes into a
    wheel with the same model family, scenario count, model kwargs,
    bundling, and hub algorithm — anything else would install
    foreign (or shape-mismatched) state. The fields are the JAX
    package's, so one configuration fingerprints the same in both."""
    from ..ckpt.bundle import config_fingerprint
    return config_fingerprint({
        "model": cfg.model, "num_scens": cfg.num_scens,
        "model_kwargs": cfg.model_kwargs,
        "num_bundles": cfg.num_bundles, "hub": cfg.hub})


def hub_dict(cfg: RunConfig, batch=None, mesh=None):
    """ref. vanilla.py:54 ph_hub / aph_hub / lshaped_hub. ``batch``:
    optionally a prebuilt batch shared across cylinders (engines never
    mutate the host arrays; wheel_dicts passes one build to all).
    ``mesh``: this rank's parallel/mesh.Mesh, which shards a PH or APH
    hub engine (its device is the engine's)."""
    from ..core.aph import APH
    from ..core.lshaped import LShapedMethod
    from ..core.ph import PH
    from ..cylinders.hub import APHHub, LShapedHub, PHHub

    refuse_unported(cfg)
    options = cfg.algo.to_options()
    options.update(cfg.hub_options)
    dtype_kw = _pop_dtype(options)
    hub_kwargs = {"options": {}}
    if cfg.rel_gap is not None:
        hub_kwargs["options"]["rel_gap"] = cfg.rel_gap
    if cfg.abs_gap is not None:
        hub_kwargs["options"]["abs_gap"] = cfg.abs_gap
    if cfg.wheel_deadline is not None:
        hub_kwargs["options"]["wheel_deadline"] = cfg.wheel_deadline
    if cfg.status_port is not None:
        # the hub process owns the live status server (obs/live.py)
        hub_kwargs["options"]["status_port"] = cfg.status_port
        hub_kwargs["options"]["status_host"] = cfg.status_host
    if "crossed_bound_tol" in cfg.supervisor:
        hub_kwargs["options"]["crossed_bound_tol"] = \
            cfg.supervisor["crossed_bound_tol"]
    if cfg.checkpoint_dir or cfg.resume_from:
        # durable run-state checkpoints + resume (ckpt/): the hub owns
        # capture; resume installs before iter 0. The fingerprint makes
        # a bundle from a different configuration refuse cleanly at
        # load.
        if cfg.checkpoint_dir:
            hub_kwargs["options"]["checkpoint_dir"] = cfg.checkpoint_dir
            hub_kwargs["options"]["checkpoint_interval"] = \
                cfg.checkpoint_interval
            hub_kwargs["options"]["checkpoint_keep"] = cfg.checkpoint_keep
        if cfg.resume_from:
            hub_kwargs["options"]["resume_from"] = cfg.resume_from
        hub_kwargs["options"]["checkpoint_fingerprint"] = \
            ckpt_fingerprint(cfg)
    opt_kwargs = {"batch": batch if batch is not None
                  else build_batch_for(cfg),
                  "options": options, "device": cfg.device, **dtype_kw}
    spec = getattr(opt_kwargs["batch"], "_synth_spec", None)
    if spec is not None:
        # the synthesized source's generator (build_batch_for attached
        # it): an engine option, since a callable cannot ride the config
        options["synth_spec"] = spec
    opt_cls, hub_cls = {"ph": (PH, PHHub), "aph": (APH, APHHub),
                        "lshaped": (LShapedMethod, LShapedHub)}[cfg.hub]
    if mesh is not None and mesh.size > 1 and cfg.hub in ("ph", "aph"):
        opt_kwargs["mesh"] = mesh
        opt_kwargs.pop("device")
    return {"hub_class": hub_cls, "hub_kwargs": hub_kwargs,
            "opt_class": opt_cls, "opt_kwargs": opt_kwargs}


def spoke_classes(kind: str):
    """(spoke_class, opt_class) for a spoke kind."""
    if kind in _UNPORTED_SPOKES:
        raise _not_ported(f"the {kind!r} spoke", _UNPORTED_SPOKES[kind])
    from ..core.fwph import FWPH
    from ..core.ph import PHBase
    from ..cylinders.lagrangian_bounder import (LagrangianOuterBound,
                                                LagrangerOuterBound)
    from ..cylinders.xhat_bounders import (DiveInnerBound,
                                           XhatLooperInnerBound,
                                           XhatLShapedInnerBound,
                                           XhatShuffleInnerBound,
                                           XhatSpecificInnerBound)
    from ..cylinders.slam_heuristic import (SlamUpHeuristic,
                                            SlamDownHeuristic)
    from ..cylinders.ef_bounder import EFMipBound
    from ..cylinders.fwph_spoke import FrankWolfeOuterBound

    return {
        "lagrangian": (LagrangianOuterBound, PHBase),
        "efmip": (EFMipBound, PHBase),
        "lagranger": (LagrangerOuterBound, PHBase),
        "xhatshuffle": (XhatShuffleInnerBound, PHBase),
        "xhatlooper": (XhatLooperInnerBound, PHBase),
        "xhatspecific": (XhatSpecificInnerBound, PHBase),
        "xhatlshaped": (XhatLShapedInnerBound, PHBase),
        "fwph": (FrankWolfeOuterBound, FWPH),
        "slamup": (SlamUpHeuristic, PHBase),
        "slamdown": (SlamDownHeuristic, PHBase),
        # device-side batched incumbent search
        "dive": (DiveInnerBound, PHBase),
    }[kind]


def spoke_dict(cfg: RunConfig, sp: SpokeConfig, batch=None):
    """ref. vanilla.py:95-408 — one factory per spoke kind."""
    spoke_cls, opt_cls = spoke_classes(sp.kind)
    options = cfg.algo.to_options()
    options.update(sp.options)
    # run-level spoke knobs (per-spoke options win)
    if cfg.spoke_sleep_time is not None:
        options.setdefault("spoke_sleep_time", cfg.spoke_sleep_time)
    if cfg.incumbent_mode is not None:
        options.setdefault("incumbent_mode", cfg.incumbent_mode)
    dtype_kw = _pop_dtype(options)
    spoke_kwargs = {}
    if cfg.trace_prefix:
        spoke_kwargs["trace_prefix"] = cfg.trace_prefix
    return {"spoke_class": spoke_cls, "spoke_kwargs": spoke_kwargs,
            "opt_class": opt_cls,
            "opt_kwargs": {"batch": batch if batch is not None
                           else build_batch_for(cfg),
                           "options": options, "device": cfg.device,
                           **dtype_kw}}


def wheel_dicts(cfg: RunConfig, mesh=None, batch=None):
    """The full (hub_dict, spoke_dicts) pair for spin_the_wheel. The
    batch is built ONCE and shared by every cylinder (engines read the
    host arrays, they never write them), and so is its device cache
    (core/spbase): the shipped constraint matrix and bound vectors.
    ``mesh``: this rank's mesh, for a sharded hub engine; on ranks
    other than 0 no spoke dict is built (those ranks run no spoke).
    ``batch``: a batch ``cfg`` already built (a resumed wheel on its
    predecessor's batch), else it is built here."""
    cfg.validate()
    refuse_unported(cfg)
    if cfg.algo.scenario_source != "resident" and cfg.spokes:
        # spoke engines read full-width batch arrays (incumbent pools,
        # Lagrangian warm states) that a streamed hub never ships
        raise ValueError(
            "scenario_source='streamed'/'synthesized' wheels are "
            "hub-only; drop the spokes or use scenario_source='resident'")
    obs.event("wheel.build", {"model": cfg.model,
                              "num_scens": cfg.num_scens,
                              "hub": cfg.hub,
                              "spokes": [sp.kind for sp in cfg.spokes]})
    if batch is None:
        batch = build_batch_for(cfg)
    follower = mesh is not None and mesh.size > 1 and mesh.rank != 0
    spoke_ds = [] if follower else [spoke_dict(cfg, sp, batch=batch)
                                    for sp in cfg.spokes]
    if mesh is not None and not follower:
        # the spokes run on rank 0's card
        for sd in spoke_ds:
            sd["opt_kwargs"]["device"] = mesh.device
    if cfg.checkpoint_dir or cfg.resume_from:
        # per-spoke checkpoint/resume wiring needs the spoke INDEX
        # (file naming), which spoke_dict alone never sees; the
        # process launcher does the same injection per spawn
        # (utils/multiproc._spawn_one_spoke, generation-aware)
        from ..ckpt.spoke_state import spoke_resume_options
        for i, (sp, sd) in enumerate(zip(cfg.spokes, spoke_ds)):
            for k, v in spoke_resume_options(
                    cfg.checkpoint_dir, cfg.resume_from, i,
                    sp.kind).items():
                sd["opt_kwargs"]["options"].setdefault(k, v)
    return hub_dict(cfg, batch=batch, mesh=mesh), spoke_ds
