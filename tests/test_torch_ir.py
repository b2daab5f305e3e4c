"""The port's IR and model copies (mpisppy_tpu_torch.ir / .models)
build the same scenario batches as the JAX package's, array for array."""

import numpy as np
import pytest

from mpisppy_tpu.ir.batch import build_batch as jax_build_batch
from mpisppy_tpu.models import farmer as jax_farmer
from mpisppy_tpu.models import uc as jax_uc
from mpisppy_tpu_torch.ir.batch import build_batch
from mpisppy_tpu_torch.models import farmer, uc
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

_FIELDS = ("c", "c0", "P_diag", "A", "l", "u", "lb", "ub", "c_stage",
           "c0_stage", "prob", "nonant_idx", "nonant_stage")
_UC_KW = {"num_gens": 3, "num_hours": 6, "min_up_down": True,
          "ramping": True, "t0_state": True,
          "startup_shutdown_ramps": True}


def _assert_same(b_jax, b_port):
    for f in _FIELDS:
        a, b = getattr(b_jax, f), getattr(b_port, f)
        assert a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert b_jax.stage_slot_slices == b_port.stage_slot_slices
    assert b_jax.template.var_slices == b_port.template.var_slices
    assert b_jax.template.con_slices == b_port.template.con_slices
    np.testing.assert_array_equal(b_jax.integer, b_port.integer)
    for t in range(1, b_jax.tree.num_stages):
        np.testing.assert_array_equal(b_jax.tree.membership(t),
                                      b_port.tree.membership(t))


@pytest.mark.parametrize("patched", [True, False])
def test_uc_batch_matches_jax_package(patched):
    kw = dict(creator_kwargs=_UC_KW)
    if patched:
        kw_j = dict(kw, vector_patch=jax_uc.scenario_vector_patch)
        kw_p = dict(kw, vector_patch=uc.scenario_vector_patch)
    else:
        kw_j = kw_p = kw
    b_j = jax_build_batch(jax_uc.scenario_creator, jax_uc.make_tree(4),
                          **kw_j)
    b_p = build_batch(uc.scenario_creator, uc.make_tree(4), **kw_p)
    assert b_p.shared_A and b_p.A.ndim == 2
    _assert_same(b_j, b_p)


def test_farmer_batch_matches_jax_package():
    b_j = jax_build_batch(jax_farmer.scenario_creator,
                          jax_farmer.make_tree(3))
    b_p = build_batch(farmer.scenario_creator, farmer.make_tree(3))
    # farmer's yields sit in A: one matrix per scenario
    assert b_p.A.ndim == 3
    _assert_same(b_j, b_p)
