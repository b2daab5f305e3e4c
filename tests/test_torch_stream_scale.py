"""The port's scenario streaming at scale and across ranks, on the CPU:
an S = 100k synthesized farmer run whose steady-state iteration ships
nothing, and the streamed and synthesized farmer family over two gloo
ranks (tests/torch_mesh_ranks.py) against each other and against the
single-process resident run."""

import numpy as np
import pytest

from mpisppy_tpu_torch import obs
from mpisppy_tpu_torch.core.ph import PH
from mpisppy_tpu_torch.models import farmer
from mpisppy_tpu_torch.parallel.launch import launch
from mpisppy_tpu_torch.stream import synth_batch

import torch_mesh_ranks as ranks
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture
def mem_obs():
    rec = obs.configure()
    yield rec
    obs.shutdown()


def test_run_100k_synthesized_flat_transfer(mem_obs):
    """S = 100k farmer-family PH (synthesized source, chunks of 8192):
    iter 0, one prox-on iteration, then a steady-state iteration that
    books no device_put byte; the batch vectors stay zero-stride views
    and no (S, n) vector reaches the engine. The ADMM budget is cut
    (50 steps, eps 1e-3, no prox-on polish) for the CPU's time: iter
    0's polish alone is ~30 s at this S on one thread."""
    S = 100_000
    b, spec = synth_batch(farmer.scenario_creator, farmer.make_tree(S),
                          farmer.scenario_synth_spec, seed=11,
                          materialize_values=False)
    assert b.S == S and b.l.strides[0] == 0
    ph = PH(b, dict(defaultPHrho=1.0, PHIterLimit=1, convthresh=0.0,
                    subproblem_chunk=8192, subproblem_max_iter=50,
                    subproblem_eps=1e-3, subproblem_polish_hot=False,
                    subproblem_hospital=False,
                    scenario_source="synthesized", synth_spec=spec),
            device="cpu")
    assert ph.qp_data.l.shape[0] == 2 and ph.c.shape[0] == 2
    ph.ph_main(finalize=False)
    before = obs.counters_snapshot()
    ph.solve_loop(w_on=True, prox_on=True)
    ctr = obs.counters_snapshot()
    assert ctr["xfer.device_put_bytes"] == before["xfer.device_put_bytes"]
    # 13 chunks, two in-order passes, no direct fetch
    assert ctr["stream.synth_chunks"] - before["stream.synth_chunks"] \
        == 13 * 2
    assert np.isfinite(ph.conv) and ph.x.shape == (S, b.n)


def test_streamed_and_synthesized_over_two_ranks():
    """Two gloo ranks: streamed == synthesized exactly (the same chunk
    data on each rank, synthesis folding the GLOBAL scenario ids), both
    within the JAX package's 1e-4 of the single-process resident run."""
    opts = {"defaultPHrho": 1.0, "PHIterLimit": 4, "convthresh": 0.0,
            "subproblem_chunk": 2, "subproblem_max_iter": 3000,
            "subproblem_eps": 1e-9}
    ref = ranks.stream_run(None, {"S": 16, "source": "resident",
                                  "opts": opts})
    outs = {src: launch(ranks.stream_run, 2,
                        ({"S": 16, "source": src, "opts": opts},),
                        device="cpu")
            for src in ("streamed", "synthesized")}
    s, y = outs["streamed"][0], outs["synthesized"][0]
    assert outs["streamed"][1]["result"] == s["result"]
    assert y["result"] == s["result"]
    assert np.array_equal(y["xbar"], s["xbar"])
    assert np.array_equal(y["W"], s["W"])
    r0, r1 = ref["result"], s["result"]
    assert r1[0] == pytest.approx(r0[0], abs=1e-4)
    assert r1[1] == pytest.approx(r0[1], rel=1e-4)
    assert r1[2] == pytest.approx(r0[2], rel=1e-4)
