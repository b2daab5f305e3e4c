"""Device-side scenario synthesis for randomness-in-rhs families (the
port of mpisppy_tpu/stream/synth.py).

The synthesized :class:`~mpisppy_tpu_torch.stream.source.ScenarioSource`
ships no scenario data: a seeded generator manufactures each scenario's
rhs/bound perturbations on the engine's device from ``(seed,
scenario_id)``, so chunk staging is device compute and a synthesized
iteration's ``xfer.device_put_bytes`` is zero.

The :class:`SynthSpec` is the single source of a family's data: the
resident and streamed twins are built by materializing the SAME
generator (:func:`materialize`), so synthesized == resident exactly.
The generator is stream/prng.py's threefry with jax.random's layout:
its integer work and uniform draws are exact on every device, normals
go through ``erfinv``, whose last bits may differ between the CPU and
the card, so a twin is materialized on the device that synthesizes.

Contract for ``SynthSpec.fn`` (model modules export it through
``scenario_synth_spec``, models/farmer.py, models/uc.py):

- ``fn(keys) -> tuple`` of per-field (B, stop - start) tensors in
  ``fields`` order, for a (B, 2) batch of folded keys
  (``fold_in(prng_key(seed), scenario_id)``, stream/prng.py) on a
  device, computed on that device; a scenario's data never depends on
  which chunk asks for it;
- fields address rhs/bound vectors only (``l``/``u``/``lb``/``ub``):
  cost randomness would have to track the per-stage cost split and is
  rejected at spec construction;
- the spec covers every scenario-dependent entry of the family; the
  template (scenario 0's creator output) provides the rest.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from . import prng

# fields a synth spec may perturb: rhs rows and variable boxes
SYNTH_FIELDS = ("l", "u", "lb", "ub")
# the per-scenario vector fields a scenario source serves (c rides
# along as a template-shared block)
SOURCE_FIELDS = ("l", "u", "lb", "ub", "c")


@dataclass(frozen=True)
class SynthField:
    """One perturbed block: ``field[start:stop]`` of the stacked
    vector (offsets from the template StandardForm's con_slices /
    var_slices)."""
    field: str
    start: int
    stop: int

    def __post_init__(self):
        if self.field not in SYNTH_FIELDS:
            raise ValueError(
                f"synth specs may perturb {SYNTH_FIELDS} only; got "
                f"{self.field!r} (cost randomness needs the c_stage "
                "split and is not supported)")
        if not (0 <= self.start < self.stop):
            raise ValueError(f"bad synth block [{self.start}, {self.stop})")


@dataclass(frozen=True)
class SynthSpec:
    """Seeded generator + the field layout it writes."""
    seed: int
    fields: tuple          # tuple[SynthField, ...]
    fn: Callable           # fn((B, 2) keys) -> tuple of (B, w) tensors


def synth_values(spec: SynthSpec, scen_ids, device="cpu"):
    """Per-scenario perturbation values for ``scen_ids`` (integers, a
    tensor or array), computed on ``device`` (a tensor's own device
    when ``scen_ids`` is one): the spec's generator over
    ``fold_in(prng_key(seed), id)``. Returns a tuple of (B, w)
    tensors."""
    if isinstance(scen_ids, torch.Tensor):
        device = scen_ids.device
    ids = torch.as_tensor(np.asarray(scen_ids) if not isinstance(
        scen_ids, torch.Tensor) else scen_ids, device=device)
    keys = prng.fold_in(prng.prng_key(spec.seed, device=ids.device),
                        ids.reshape(-1))
    vals = spec.fn(keys)
    return vals if isinstance(vals, tuple) else (vals,)


def materialize(spec: SynthSpec, S: int, batch_rows: int = 8192,
                device="cpu") -> dict:
    """Host materialization of the generator's values for scenarios
    [0, S): ``{field: [(start, stop, (S, w) ndarray), ...]}``, generated
    on ``device`` (the device that will synthesize, for a bit-equal
    twin) in id batches so only one batch is transient at a time."""
    parts = {f.field: [] for f in spec.fields}
    stacks = [[] for _ in spec.fields]
    for lo in range(0, S, batch_rows):
        ids = torch.arange(lo, min(lo + batch_rows, S), dtype=torch.int64,
                           device=device)
        for i, v in enumerate(synth_values(spec, ids)):
            stacks[i].append(v.cpu().numpy().astype(np.float64))
    for f, st in zip(spec.fields, stacks):
        parts[f.field].append((f.start, f.stop, np.concatenate(st)))
    return parts


def _validate_spec(spec: SynthSpec, widths: dict):
    """Check the declared blocks fit their field vectors and the
    generator's output arity and shapes, at build time rather than as a
    shape error inside a chunk's staging."""
    for f in spec.fields:
        w = widths[f.field]
        if f.stop > w:
            raise ValueError(
                f"synth block {f.field}[{f.start}:{f.stop}] exceeds the "
                f"field width {w}")
    outs = synth_values(spec, np.zeros(2, np.int64))
    if len(outs) != len(spec.fields):
        raise ValueError(
            f"synth fn returns {len(outs)} arrays for "
            f"{len(spec.fields)} declared fields")
    for f, v in zip(spec.fields, outs):
        if tuple(v.shape) != (2, f.stop - f.start):
            raise ValueError(
                f"synth fn output for {f.field}[{f.start}:{f.stop}] has "
                f"per-scenario shape {tuple(v.shape)[1:]}, block needs "
                f"({f.stop - f.start},)")


def synth_batch(scenario_creator, tree, spec_factory, creator_kwargs=None,
                seed: int = 0, materialize_values: bool = True,
                num_stages=None, device="cpu"):
    """A (ScenarioBatch, SynthSpec) pair for a synth family: the creator
    runs once (scenario 0 -> shared template) and the spec defines every
    scenario's perturbations, scenario 0's included, so the family's
    data is the same whether it runs resident, streamed or synthesized.

    ``materialize_values=True`` stacks real (S, ...) host arrays (the
    resident / streamed representation), generated on ``device``.
    ``materialize_values=False`` keeps the batch vectors as zero-stride
    ``np.broadcast_to`` views of the template (a synthesized engine
    never reads them; they only carry shape), so an S = 1M batch costs
    no host memory beyond the template."""
    from ..ir.batch import ScenarioBatch, _nonant_indexing
    from ..ir.standard_form import lower

    creator_kwargs = creator_kwargs or {}
    T = num_stages or tree.num_stages
    f0 = lower(scenario_creator(tree.scen_names[0], **creator_kwargs),
               num_stages=T)
    spec = spec_factory(f0, seed=seed, **creator_kwargs)
    S = len(tree.scen_names)
    widths = {"l": f0.m, "u": f0.m, "lb": f0.n, "ub": f0.n}
    _validate_spec(spec, widths)

    base = {"c": f0.c, "l": f0.l, "u": f0.u, "lb": f0.lb, "ub": f0.ub,
            "c_stage": f0.c_stage, "P_diag": f0.P_diag}
    if materialize_values:
        vecs = {k: np.repeat(np.asarray(v, np.float64)[None], S, axis=0)
                for k, v in base.items()}
        for fname, blocks in materialize(spec, S, device=device).items():
            for start, stop, vals in blocks:
                vecs[fname][:, start:stop] = vals
    else:
        vecs = {k: np.broadcast_to(np.asarray(v, np.float64),
                                   (S,) + np.shape(v))
                for k, v in base.items()}

    nonant_idx, nonant_stage, slot_slices = _nonant_indexing(f0, tree)
    batch = ScenarioBatch(
        tree=tree, template=f0,
        c=vecs["c"], c0=np.full(S, np.float64(f0.c0)),
        P_diag=vecs["P_diag"],
        A=f0.A,                               # one shared matrix
        l=vecs["l"], u=vecs["u"], lb=vecs["lb"], ub=vecs["ub"],
        c_stage=vecs["c_stage"],
        c0_stage=np.repeat(np.asarray(f0.c0_stage,
                                      np.float64)[None], S, axis=0),
        prob=tree.probabilities.copy(),
        nonant_idx=nonant_idx, nonant_stage=nonant_stage,
        stage_slot_slices=slot_slices,
    )
    return batch, spec
