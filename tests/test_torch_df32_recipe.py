"""The JAX bench's df32 recipe (bench.py's DF32 dict, as chip_smoke.py
runs it on the card) at a medium UC size on the CPU, both packages on
the same batches: UC 10 x 24, S = 20 in chunks of 8 at iter 0 and S =
8 in chunks of 4 for the PH runs.

What is held, each with its bar:
 - iter 0 of chunked df32, port against JAX: the same scenarios pass
   the engine's default iter-0 gate (1e-3) in both; the expected
   objective agrees to 1e-3 relative (measured 6.5e-5) and the
   certified trivial bound to 1e-2 relative (measured 1.2e-3: the
   recipe stops at loose duals, and each package's f32 sums reach them
   along its own path);
 - the df32 certified trivial bound of either package is at most the
   f64 primal optimum's objective (a native reference-backend solve,
   polished) plus 1e-4 relative, the form of tests/test_precision.py's
   bound check (measured: 5.3 % below it in the port);
 - three PH iterations of the recipe land within 2e-2 relative of the
   native reference-backend run's Eobjective (tests/test_precision.py's
   band);
 - the native chunked loop on the cuda backend (the ADMM block: rho
   fixed for the whole budget, the block's plain version on the CPU)
   gives the JAX package's pallas-backend iter-0 objective and bound to
   1e-8 relative. That run is no accuracy reference for the recipe: its
   iter-0 Eobjective reads about 22 % above the reference-backend
   run's here, in both packages (chip_smoke.py compares the df32 run
   with a reference-backend run for this reason)."""

import jax.numpy as jnp
import numpy as np
import pytest

from mpisppy_tpu.core.ph import PHBase as JaxPHBase
from mpisppy_tpu.ir.batch import build_batch as jax_build_batch
from mpisppy_tpu.models import uc as jax_uc
from mpisppy_tpu_torch.core.ph import PH, PHBase
from mpisppy_tpu_torch.ir.batch import build_batch
from mpisppy_tpu_torch.models import uc

_KW = dict(num_gens=10, num_hours=24, min_up_down=True, ramping=True,
           t0_state=True, startup_shutdown_ramps=True,
           relax_integrality=False)
_S, _CHUNK = 8, 4
# the iter-0 batch
_S0, _CHUNK0 = 20, 8
# bench.py's DF32 dict
_DF32 = {
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
    "subproblem_chunk": _CHUNK,
}
# chip_smoke.py's native PH options (the chunked path's)
_NATIVE = {"defaultPHrho": 100.0, "convthresh": -1.0,
           "subproblem_kernel_mode": "fused",
           "subproblem_kernel_backend": "reference",
           "subproblem_max_iter": 1500, "subproblem_eps": 1e-5,
           "subproblem_eps_hot": 1e-4, "subproblem_eps_dua_hot": 1e-2,
           "subproblem_polish_hot": False, "subproblem_polish_chunk": 2,
           "subproblem_chunk": _CHUNK, "subproblem_hospital": False}


def _port_batch(S=_S):
    return build_batch(uc.scenario_creator, uc.make_tree(S),
                       creator_kwargs=_KW,
                       vector_patch=uc.scenario_vector_patch)


def _jax_iter0(opts, S=_S):
    ph = JaxPHBase(jax_build_batch(jax_uc.scenario_creator,
                                   jax_uc.make_tree(S), creator_kwargs=_KW,
                                   vector_patch=jax_uc.scenario_vector_patch),
                   dict(opts), dtype=jnp.float64)
    ph.solve_loop(w_on=False, prox_on=False)
    return ph


def _port_iter0(opts, S=_S):
    ph = PHBase(_port_batch(S), dict(opts), device="cpu")
    ph.solve_loop(w_on=False, prox_on=False)
    return ph


@pytest.fixture(scope="module")
def iter0():
    """Iter 0 of the recipe in both packages and of the native
    reference-backend solve (the f64 primal) in the port, on the S = 20
    batch."""
    df = {**_DF32, "subproblem_chunk": _CHUNK0}
    return {"jax": _jax_iter0(df, _S0), "port": _port_iter0(df, _S0),
            "f64": _port_iter0({**_NATIVE, "subproblem_chunk": _CHUNK0},
                               _S0)}


def test_df32_recipe_iter0_matches_jax(iter0):
    j, p = iter0["jax"], iter0["port"]
    ok_j, tol_j = j.iter0_feasible_mask()
    ok_p, tol_p = p.iter0_feasible_mask()
    assert tol_j == tol_p == 1e-3
    np.testing.assert_array_equal(ok_p, np.asarray(ok_j))
    # every scenario is within the recipe's loose band: no retry fired
    assert float(p._qp_states[False].pri_rel.max()) < 1e-2
    assert p.Eobjective_value() == pytest.approx(j.Eobjective_value(),
                                                 rel=1e-3)
    assert p.Ebound() == pytest.approx(j.Ebound(), rel=1e-2)


def test_df32_trivial_bound_is_below_the_f64_primal(iter0):
    f64 = iter0["f64"]
    assert float(f64._qp_states[False].pri_rel.max()) < 1e-3
    primal = f64.Eobjective_value()
    for pkg in ("port", "jax"):
        bound = iter0[pkg].Ebound()
        assert np.isfinite(bound)
        assert bound <= primal + 1e-4 * abs(primal), pkg


def test_df32_ph_eobjective_within_band_of_native_reference():
    """ph_main, three PH iterations each. The iter-0 gate is set to 1e-2
    here: on this small batch the recipe leaves scenarios above the
    bench's 5e-3 (the JAX package's iter 0 reaches 7.2e-3)."""
    df = PH(_port_batch(), {**_DF32, "PHIterLimit": 3, "convthresh": -1.0,
                            "iter0_feas_tol": 1e-2}, device="cpu")
    nat = PH(_port_batch(), {**_NATIVE, "PHIterLimit": 3}, device="cpu")
    _, e_df, tb_df = df.ph_main()
    _, e_nat, tb_nat = nat.ph_main()
    assert np.isfinite([e_df, tb_df, e_nat, tb_nat]).all()
    assert abs(e_df - e_nat) <= 2e-2 * abs(e_nat)


def test_fixed_rho_block_iter0_matches_jax_pallas():
    cuda = {**_NATIVE, "subproblem_kernel_backend": "cuda"}
    p = _port_iter0(cuda)
    j = _jax_iter0({**cuda, "subproblem_kernel_backend": "pallas"})
    assert p.Eobjective_value() == pytest.approx(j.Eobjective_value(),
                                                 rel=1e-8)
    assert p.Ebound() == pytest.approx(j.Ebound(), rel=1e-8)
    # a valid bound on the same wait-and-see problem as the f64 primal,
    # and a near-feasible primal (max pri_rel below 1e-4) not below it
    primal = _port_iter0(_NATIVE).Eobjective_value()
    assert p.Ebound() <= primal + 1e-4 * abs(primal)
    assert float(p._qp_states[False].pri_rel.max()) < 1e-4
    assert p.Eobjective_value() >= primal - 1e-4 * abs(primal)
