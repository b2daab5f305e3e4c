"""The sections of ``analyze`` (mpisppy_tpu_torch/obs/analyze.py) that
read engine-specific records, on port runs on the CPU: the shrinking
section (JAX tests/test_shrink.py::test_analyze_shrinking_section) and
the APH section with its compare verdict (JAX
tests/test_dispatch.py::test_analyze_aph_section_json_and_compare_verdict).
The streaming section is held by tests/test_torch_stream.py's A13
case."""

import json

import pytest

from mpisppy_tpu_torch import obs
from mpisppy_tpu_torch.__main__ import main
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _slot0_fix_list(b):
    """Only slot 0 ever fixes: a partial fixed set, so compaction keeps
    free slots (tests/test_shrink.py's list)."""
    import numpy as np
    from mpisppy_tpu_torch.extensions.fixer import uniform_fix_list
    big = 2 ** 30
    spec = uniform_fix_list(b, tol=5e-1, nb=3, lb=3, ub=3,
                            integer_only=False)
    for k in ("nb", "lb", "ub"):
        a = np.minimum(spec[k], big).copy()
        a[1:] = big
        spec[k] = a
    return spec


def test_analyze_shrinking_section(tmp_path):
    """JAX tests/test_shrink.py::test_analyze_shrinking_section on a
    port run: one compaction at the 0.2 bucket, its warm transplant and
    re-convergence row, the per-bucket s/iter rows, and the self-compare
    cold-fallback verdict. (The port has no compile-bucket registry, so
    the section's bucket compile counts read 0.)"""
    from mpisppy_tpu_torch.core.ph import PH
    from mpisppy_tpu_torch.ir.batch import build_batch
    from mpisppy_tpu_torch.models import farmer
    from mpisppy_tpu_torch.obs.analyze import (compare, load_run,
                                               render_report,
                                               shrink_summary)
    obs.configure(out_dir=str(tmp_path))
    try:
        ph = PH(build_batch(farmer.scenario_creator, farmer.make_tree(3)),
                {"defaultPHrho": 5.0, "PHIterLimit": 25, "convthresh": 0.0,
                 "subproblem_max_iter": 3000, "subproblem_eps": 1e-8,
                 "shrink_fix": True, "id_fix_list_fct": _slot0_fix_list,
                 "shrink_compact": True, "shrink_buckets": "0.2"},
                device="cpu")
        ph.ph_main()
    finally:
        obs.shutdown()
    run = load_run(str(tmp_path))
    sh = shrink_summary(run)
    assert sh["compactions"] == 1 and sh["fixed_final"] == 1
    assert sh["compaction_events"][0]["n_cols"] < ph.batch.n
    assert 0.2 in {r["bucket"] for r in sh["per_bucket"]}
    assert sh["transplants"] >= 1 and sh["transplant_cold_fallbacks"] == 0
    assert [r["bucket"] for r in sh["reconvergence"]] == [0.2]
    assert sh["reconvergence"][0]["mode"] == "warm"
    report = render_report(run)
    for line in ("== shrinking ==", "per-bucket s/iter",
                 "cross-bucket transplants",
                 "post-transition re-convergence"):
        assert line in report
    text, _ = compare(run, run)
    assert "cold-fallback verdict [PASS]" in text


def test_analyze_aph_section_json_and_compare_verdict(tmp_path, capsys):
    """JAX tests/test_dispatch.py's analyze case on a port CLI run:
    ``uc --hub aph --dispatch-frac 0.5 --subproblem-chunk 2`` records
    one gate sync per iteration on the chunked-skip path, the section
    renders in text and --json, and a self-compare's dispatch verdict
    passes."""
    from mpisppy_tpu_torch.obs.analyze import aph_summary, compare, load_run
    d = str(tmp_path / "a")
    assert main(["uc", "--hub", "aph", "--dispatch-frac", "0.5",
                 "--subproblem-chunk", "2", "--num-scens", "6",
                 "--model-kwargs", json.dumps({"num_gens": 3,
                                               "num_hours": 6}),
                 "--default-rho", "50", "--max-iterations", "5",
                 "--convthresh", "-1", "--subproblem-max-iter", "1500",
                 "--telemetry-dir", d, "--device", "cpu"]) == 0
    sa = aph_summary(load_run(d))
    assert sa["gate_syncs_per_iteration"] == 1.0
    assert sa["solve_path"] == "chunked-skip"
    assert sa["dispatch_frac"] == 0.5
    assert 0 < sa["skipped_solve_savings"] < 1
    assert len(sa["trajectory"]) == sa["iterations"] == 5
    capsys.readouterr()
    assert main(["analyze", d]) == 0
    assert "== aph ==" in capsys.readouterr().out
    assert main(["analyze", d, "--json"]) == 0
    assert json.loads(capsys.readouterr().out)["aph"]["solve_path"] \
        == "chunked-skip"
    run = load_run(d)
    text, passed = compare(run, run)
    assert "dispatch verdict [PASS]" in text and passed
