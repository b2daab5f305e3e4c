"""The port's copies of the jax-free model families (mpisppy_tpu_torch
models/): every model's stacked batch equals the JAX package's, array
for array, through ``build_batch`` and through the CLI's
``vanilla.build_batch_for``; the sizes rho setter and fixer spec; the
structure cases of tests/test_models.py and tests/test_hydro.py."""

import numpy as np
import pytest

from mpisppy_tpu import models as jax_models
from mpisppy_tpu.ir.batch import build_batch as jax_build_batch
from mpisppy_tpu.utils import config as jax_config
from mpisppy_tpu.utils import vanilla as jax_vanilla
from mpisppy_tpu_torch import models
from mpisppy_tpu_torch.ir.batch import build_batch
from mpisppy_tpu_torch.utils.config import KNOWN_MODELS, RunConfig
from mpisppy_tpu_torch.utils.vanilla import build_batch_for, refuse_unported
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

# (model, make_tree args, creator kwargs, vector_patch) at small sizes
CASES = [
    ("farmer", (3,), {}, False),
    ("uc", (3,), {"num_gens": 3, "num_hours": 6}, True),
    ("sizes", (3,), {"scenario_count": 3}, False),
    ("sslp", (4,), {"num_servers": 3, "num_clients": 8}, False),
    ("netdes", (4,), {"num_nodes": 5}, False),
    ("hydro", ((3, 3),), {}, False),
    ("battery", (3,), {"T": 12}, False),
    ("ccopf", ((2, 2, 2),), {}, False),
]
_FIELDS = ("c", "c0", "P_diag", "A", "l", "u", "lb", "ub", "c_stage",
           "c0_stage", "prob", "nonant_idx", "nonant_stage", "integer")


def _pair(name, tree_args, kw, patch):
    jm, pm = getattr(jax_models, name), getattr(models, name)
    jb = jax_build_batch(jm.scenario_creator, jm.make_tree(*tree_args),
                         creator_kwargs=kw,
                         vector_patch=jm.scenario_vector_patch if patch
                         else None)
    pb = build_batch(pm.scenario_creator, pm.make_tree(*tree_args),
                     creator_kwargs=kw,
                     vector_patch=pm.scenario_vector_patch if patch
                     else None)
    return jb, pb


def _assert_batches_equal(jb, pb):
    for fld in _FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(pb, fld)),
                                      np.asarray(getattr(jb, fld)),
                                      err_msg=fld)
    assert pb.shared_A == jb.shared_A
    assert pb.stage_slot_slices == jb.stage_slot_slices
    assert pb.tree.num_stages == jb.tree.num_stages
    for t in range(1, jb.tree.num_stages):
        np.testing.assert_array_equal(pb.tree.membership(t),
                                      jb.tree.membership(t))
    assert pb.template.var_slices == jb.template.var_slices
    assert pb.template.con_slices == jb.template.con_slices
    assert pb.template.sense == jb.template.sense


@pytest.mark.parametrize("name,tree_args,kw,patch", CASES,
                         ids=[c[0] for c in CASES])
def test_build_batch_equals_jax(name, tree_args, kw, patch):
    _assert_batches_equal(*_pair(name, tree_args, kw, patch))


def test_every_known_model_is_ported():
    assert set(KNOWN_MODELS) == set(jax_config.KNOWN_MODELS)
    assert {c[0] for c in CASES} == set(KNOWN_MODELS)
    for name in KNOWN_MODELS:
        refuse_unported(RunConfig(model=name, device="cpu"))


@pytest.mark.parametrize("name,num_scens,kw", [
    ("sizes", 3, {}),
    ("netdes", 4, {"num_nodes": 5}),
    ("hydro", 9, {"branching_factors": [3, 3]}),
    ("hydro", 9, {"tree_kwargs": {"branching_factors": [3, 3]}}),
    ("ccopf", 8, {"branching": [2, 2, 2]}),
], ids=["sizes", "netdes", "hydro-kw", "hydro-tree_kwargs", "ccopf"])
def test_build_batch_for_equals_jax(name, num_scens, kw):
    """The CLI's model registry, the multistage branching merge
    included, builds the JAX registry's batch."""
    cfg = RunConfig(model=name, num_scens=num_scens, model_kwargs=kw,
                    device="cpu")
    jcfg = jax_config.RunConfig(model=name, num_scens=num_scens,
                                model_kwargs=kw)
    _assert_batches_equal(jax_vanilla.build_batch_for(jcfg),
                          build_batch_for(cfg))


def test_build_batch_for_refuses_conflicting_branching():
    cfg = RunConfig(model="hydro", device="cpu", model_kwargs={
        "branching_factors": [3, 3],
        "tree_kwargs": {"branching_factors": [2, 2]}})
    with pytest.raises(ValueError, match="different values"):
        build_batch_for(cfg)


def test_sizes_structure_rho_setter_and_fix_list():
    """tests/test_models.py's sizes case, and the helpers equal to the
    JAX package's."""
    from mpisppy_tpu.models import sizes as jax_sizes
    from mpisppy_tpu_torch.models import sizes
    jb, batch = _pair("sizes", (3,), {"scenario_count": 3}, False)
    assert batch.K == 10 + 55
    rho = sizes._rho_setter(batch)
    assert rho.shape == (65,) and np.all(rho > 0)
    np.testing.assert_array_equal(rho, jax_sizes._rho_setter(jb))
    np.testing.assert_array_equal(sizes._rho_setter(batch, 0.01),
                                  jax_sizes._rho_setter(jb, 0.01))
    spec, jspec = sizes.id_fix_list_fct(batch), jax_sizes.id_fix_list_fct(jb)
    assert spec["nb"].shape == (65,)
    assert set(spec) == set(jspec)
    for k in spec:
        np.testing.assert_array_equal(spec[k], jspec[k])
        assert spec[k].dtype == jspec[k].dtype
    assert sizes.demand_multiplier(0, 3) == 0.7
    assert sizes.demand_multiplier(2, 3) == 1.3
    assert len(set(sizes.demand_multiplier(i, 10) for i in range(10))) == 10
    with pytest.raises(ValueError, match="3 or 10"):
        sizes.scenario_creator("Scenario1", scenario_count=4)


def test_sizes_10_scenarios_builds():
    batch = build_batch(models.sizes.scenario_creator,
                        models.sizes.make_tree(10),
                        creator_kwargs={"scenario_count": 10})
    assert batch.S == 10
    assert abs(batch.prob.sum() - 1.0) < 1e-9


def test_hydro_tree_structure():
    """tests/test_hydro.py's structure case on the port's copy."""
    b = build_batch(models.hydro.scenario_creator,
                    models.hydro.make_tree((3, 3)))
    assert b.S == 9 and b.tree.num_stages == 3 and b.K == 8
    B2 = b.tree.membership(2)
    assert B2.shape == (9, 3) and (B2.sum(axis=0) == 3).all()


def test_model_helpers_equal_jax():
    """The data helpers the models export (demand paths, presence
    draws, traces) return the JAX package's values."""
    for s in range(8):
        np.testing.assert_array_equal(
            models.ccopf.demand_path(s), jax_models.ccopf.demand_path(s))
        np.testing.assert_array_equal(
            models.sslp.client_presence(s, 8),
            jax_models.sslp.client_presence(s, 8))
        np.testing.assert_array_equal(
            models.battery.solar_trace(s, 12),
            jax_models.battery.solar_trace(s, 12))
        np.testing.assert_array_equal(
            models.netdes.scenario_demand(s, 5),
            jax_models.netdes.scenario_demand(s, 5))
        np.testing.assert_array_equal(
            models.hydro.scenario_inflows(s + 1),
            jax_models.hydro.scenario_inflows(s + 1))
