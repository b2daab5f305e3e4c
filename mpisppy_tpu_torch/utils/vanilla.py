"""Config -> hub/spoke construction dicts (the vanilla analog; the port
of the JAX package's utils/vanilla.py).

Mirrors mpisppy/utils/vanilla.py:30-408: canned factories that turn the
validated RunConfig into the hub/spoke dict schema spin_the_wheel
consumes, one factory per cylinder kind. Every cylinder gets its OWN
engine over one shared host batch, on the run's ``device`` (None = the
CUDA device). What the port does not run yet raises, naming its
ROADMAP.md item: the FWPH and cross-scenario spokes, bundling, scenario
streaming, the scenario-axis mesh, checkpoints and the live plane.
"""

from __future__ import annotations

import torch

from .. import obs
from .config import RunConfig, SpokeConfig

_DTYPES = {"float32": torch.float32, "f32": torch.float32,
           "float64": torch.float64, "f64": torch.float64}

# spoke kinds whose engines are not ported, with their items
_UNPORTED_SPOKES = {"fwph": "A11b", "cross_scenario": "A11b"}


def _not_ported(what, item):
    return NotImplementedError(f"{what} is not ported yet (see ROADMAP.md "
                               f"{item})")


def refuse_unported(cfg: RunConfig):
    """Raise for every part of ``cfg`` the port does not run yet."""
    for sp in cfg.spokes:
        if sp.kind in _UNPORTED_SPOKES:
            raise _not_ported(f"the {sp.kind!r} spoke",
                              _UNPORTED_SPOKES[sp.kind])
    if cfg.num_bundles:
        raise _not_ported("scenario bundling", "A11b")
    if cfg.algo.scenario_source != "resident":
        raise _not_ported(f"scenario_source={cfg.algo.scenario_source!r}",
                          "A12")
    if cfg.mesh_devices is not None or cfg.coordinator is not None:
        raise _not_ported("the scenario-axis device mesh", "A8")
    if cfg.telemetry_dir or cfg.status_port is not None:
        raise _not_ported("telemetry files and the live status plane",
                          "A13")
    if cfg.checkpoint_dir or cfg.resume_from:
        raise _not_ported("checkpoints and resumes", "A14")


def _pop_dtype(options):
    """Extract an optional per-cylinder "dtype" option ("float32"/"f64"/…)
    into an engine dtype kwarg — e.g. an f32 hub for hot-loop speed with
    f64 bound spokes for certified tightness in the same wheel."""
    name = options.pop("dtype", None)
    if name is None:
        return {}
    return {"dtype": _DTYPES[str(name)]}


def build_batch_for(cfg: RunConfig):
    """Model registry: name -> stacked batch. Models that export
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
    batch = build_batch(mod.scenario_creator, tree, creator_kwargs=kwargs,
                        vector_patch=getattr(mod, "scenario_vector_patch",
                                             None))
    obs.event("batch.build", {"model": cfg.model, "S": batch.S,
                              "K": batch.K, "n": batch.n,
                              "shared_A": bool(batch.shared_A)})
    return batch


def hub_dict(cfg: RunConfig, batch=None):
    """ref. vanilla.py:54 ph_hub / aph_hub / lshaped_hub. ``batch``:
    optionally a prebuilt batch shared across cylinders (engines never
    mutate the host arrays; wheel_dicts passes one build to all)."""
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
    if "crossed_bound_tol" in cfg.supervisor:
        hub_kwargs["options"]["crossed_bound_tol"] = \
            cfg.supervisor["crossed_bound_tol"]
    opt_kwargs = {"batch": batch if batch is not None
                  else build_batch_for(cfg),
                  "options": options, "device": cfg.device, **dtype_kw}
    opt_cls, hub_cls = {"ph": (PH, PHHub), "aph": (APH, APHHub),
                        "lshaped": (LShapedMethod, LShapedHub)}[cfg.hub]
    return {"hub_class": hub_cls, "hub_kwargs": hub_kwargs,
            "opt_class": opt_cls, "opt_kwargs": opt_kwargs}


def spoke_classes(kind: str):
    """(spoke_class, opt_class) for a spoke kind."""
    if kind in _UNPORTED_SPOKES:
        raise _not_ported(f"the {kind!r} spoke", _UNPORTED_SPOKES[kind])
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

    return {
        "lagrangian": (LagrangianOuterBound, PHBase),
        "efmip": (EFMipBound, PHBase),
        "lagranger": (LagrangerOuterBound, PHBase),
        "xhatshuffle": (XhatShuffleInnerBound, PHBase),
        "xhatlooper": (XhatLooperInnerBound, PHBase),
        "xhatspecific": (XhatSpecificInnerBound, PHBase),
        "xhatlshaped": (XhatLShapedInnerBound, PHBase),
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


def wheel_dicts(cfg: RunConfig):
    """The full (hub_dict, spoke_dicts) pair for spin_the_wheel. The
    batch is built ONCE and shared by every cylinder (engines read the
    host arrays, they never write them), and so is its device cache
    (core/spbase): the shipped constraint matrix and bound vectors."""
    cfg.validate()
    refuse_unported(cfg)
    obs.event("wheel.build", {"model": cfg.model,
                              "num_scens": cfg.num_scens,
                              "hub": cfg.hub,
                              "spokes": [sp.kind for sp in cfg.spokes]})
    batch = build_batch_for(cfg)
    spoke_ds = [spoke_dict(cfg, sp, batch=batch) for sp in cfg.spokes]
    return hub_dict(cfg, batch=batch), spoke_ds
