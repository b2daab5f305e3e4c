"""The port's twin of ``__graft_entry__.entry()`` (mpisppy_tpu_torch
entry.py) against the JAX package's on the CPU: one PH step on
uc(S=8, G=4, T=6), the same three stages over the same arguments.

The example arguments agree bit for bit, the equilibration and scaled
matrices at 1e-13 and the explicit inverse at 1e-12
(tests/test_torch_qp_solver.py's setup bars). With the stage's solve at the micro-parity setting of
tests/test_kernels.py:64 (5 ADMM iterations, fixed rho, no polish) all
twelve outputs agree at 1e-10. The step as shipped (200 iterations of
adaptive rho, then the polish) is held at the bars of ROADMAP.md C.1:
the shared adaptive-rho trace is driven by roundoff after a few
adaptations in either package (the rho scales part at 4e-9 here), and
the certified dual bound after the polish is reproducible to ~1e-6; on
this batch the twelve outputs read at most 4.1e-6 apart (the dual
objective), x̄ 2.7e-8, W 6.7e-7 (rho 100 times the x̄ drift)."""

import numpy as np
import pytest
import torch

import __graft_entry__ as graft
import mpisppy_tpu.ops.qp_solver as jax_qp
import mpisppy_tpu_torch.ops.qp_solver as port_qp
from mpisppy_tpu_torch.entry import entry
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

_OUTS = ("qp_state", "x", "yA", "yB", "xn", "xbar", "xsqbar", "W", "conv",
         "base_obj", "solved_obj", "dual_obj")
_STATE = ("x", "yA", "yB", "zA", "zB", "L", "rho_scale", "pri_res",
          "dua_res", "pri_rel", "dua_rel")


def _rel(ref, got):
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got.cpu().numpy() if hasattr(got, "cpu") else got,
                     np.float64)
    assert ref.shape == got.shape
    fin = np.isfinite(ref)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    if not fin.any():
        return 0.0
    return float(np.abs(got[fin] - ref[fin]).max()) \
        / max(1.0, float(np.abs(ref[fin]).max()))


def _flat(outs):
    """name -> array of the twelve outputs, the state's fields spread."""
    st, rest = outs[0], outs[1:]
    out = {f"qp_state.{f}": getattr(st, f) for f in _STATE}
    out.update(zip(_OUTS[1:], rest))
    return out


def _run_both():
    fj, aj = graft.entry()
    fp, ap = entry(device="cpu")
    return aj, ap, _flat(fj(*aj)), _flat(fp(*ap))


def test_entry_example_args_match_jax():
    """The fifteen example arguments: data, costs and hub state bit for
    bit, the factors' scalings at 1e-13 and the solve operator (the
    explicit (n, n) inverse) at 1e-12; every tensor on the requested
    device."""
    aj, ap, _, _ = _run_both()
    assert len(ap) == len(aj) == 15
    for k, (a, b) in enumerate(zip(aj, ap)):
        if hasattr(a, "_fields"):
            factors = k == 1
            for f in a._fields:
                va, vb = getattr(a, f), getattr(b, f)
                if f == "L":
                    assert _rel(va, vb) <= 1e-12
                elif f == "iters" or isinstance(va, float):
                    assert float(va) == float(vb)
                else:
                    assert _rel(va, vb) <= (1e-13 if factors else 0.0), \
                        (k, f)
        elif isinstance(a, tuple):
            for va, vb in zip(a, b):
                assert _rel(va, vb) == 0.0
        else:
            assert _rel(a, b) == 0.0, k
            assert b.device.type == "cpu"


def test_entry_step_matches_jax_at_the_drift_bar(monkeypatch):
    """The twin's composition (assemble, solve, reduce) at the reference's
    drift bar: with both packages' stage solve at 5 fixed-rho ADMM
    iterations checked every step and no polish (tests/test_kernels.py:
    64), the twelve outputs, the solver state's fields included, agree
    at 1e-10."""
    def micro(orig):
        return lambda *a, **k: orig(*a, **dict(
            k, max_iter=5, check_every=1, adaptive_rho=False,
            polish=False))

    monkeypatch.setattr(jax_qp, "qp_solve", micro(jax_qp.qp_solve))
    monkeypatch.setattr(port_qp, "qp_solve", micro(port_qp.qp_solve))
    _, _, oj, op = _run_both()
    assert int(op["qp_state.rho_scale"]) == 1
    for name in oj:
        assert _rel(oj[name], op[name]) <= 1e-10, name


def test_entry_step_as_shipped_matches_jax():
    """The step as shipped (200 adaptive-rho iterations at eps 1e-4, the
    polish on) in both packages: shapes equal and finite, and the
    outputs at the C.1 bars: the primal side (x, the slacks, x̄, x̄², the
    objectives, conv) at 1e-6, W at 5e-6, the duals, residuals, solve
    operator and dual objective at 5e-5."""
    _, _, oj, op = _run_both()
    dual = {"qp_state.yA", "qp_state.yB", "qp_state.dua_res",
            "qp_state.dua_rel", "qp_state.pri_res", "yA", "yB",
            "dual_obj", "qp_state.L", "qp_state.rho_scale"}
    for name in oj:
        bar = 5e-5 if name in dual else (5e-6 if name == "W" else 1e-6)
        assert _rel(oj[name], op[name]) <= bar, name
    for name, v in op.items():
        assert bool(torch.isfinite(v).all()) or name.endswith(("res",
                                                              "rel"))
    assert op["x"].shape == (8, 84) and op["W"].shape == (8, 48)
