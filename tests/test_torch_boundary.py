"""The port's package boundary: mpisppy_tpu_torch, chip_smoke.py and
trace_mesh_gap.py import with JAX poisoned, hold no import of jax or mpisppy_tpu, and
refuse to run an entry point on the CPU unless asked to."""

import ast
import os
import pkgutil
import re
import subprocess
import sys

import pytest
import torch

import mpisppy_tpu_torch
from mpisppy_tpu_torch.ir.batch import build_batch
from mpisppy_tpu_torch.models import farmer
from mpisppy_tpu_torch.utils import runtime

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "mpisppy_tpu_torch")


def _modules():
    return ["mpisppy_tpu_torch"] + [
        m.name for m in pkgutil.walk_packages([PKG], "mpisppy_tpu_torch.")]


def test_every_module_imports_with_jax_poisoned():
    """The probe of tests/test_lint.py:414 aimed at the port: any static
    or lazy jax import raises immediately."""
    mods = _modules()
    for m in ("mpisppy_tpu_torch.ops.kernels.admm_block",
              "mpisppy_tpu_torch.ops.kernels.reference",
              "mpisppy_tpu_torch.ops.packed",
              # the wheel slice
              "mpisppy_tpu_torch.__main__",
              "mpisppy_tpu_torch.core.mip",
              "mpisppy_tpu_torch.ops.incumbent",
              "mpisppy_tpu_torch.cylinders.hub",
              "mpisppy_tpu_torch.cylinders.spoke",
              "mpisppy_tpu_torch.cylinders.spcommunicator",
              "mpisppy_tpu_torch.cylinders.lagrangian_bounder",
              "mpisppy_tpu_torch.cylinders.xhat_bounders",
              "mpisppy_tpu_torch.cylinders.slam_heuristic",
              "mpisppy_tpu_torch.cylinders.supervisor",
              "mpisppy_tpu_torch.convergers.converger",
              "mpisppy_tpu_torch.extensions.extension",
              "mpisppy_tpu_torch.utils.config",
              "mpisppy_tpu_torch.utils.vanilla",
              "mpisppy_tpu_torch.utils.sputils",
              "mpisppy_tpu_torch.utils.synchronizer",
              "mpisppy_tpu_torch.utils.certify",
              "mpisppy_tpu_torch.utils.host_oracle",
              "mpisppy_tpu_torch.utils._oracle_worker",
              # APH and the process wheels
              "mpisppy_tpu_torch.core.aph",
              "mpisppy_tpu_torch.core.aph_shard",
              "mpisppy_tpu_torch.ops.dispatch",
              "mpisppy_tpu_torch.ops.native",
              "mpisppy_tpu_torch.utils.multiproc",
              # FWPH, bundling and the extensions
              "mpisppy_tpu_torch.ops.simplex_qp",
              "mpisppy_tpu_torch.core.fwph",
              "mpisppy_tpu_torch.core.bundles",
              "mpisppy_tpu_torch.cylinders.fwph_spoke",
              "mpisppy_tpu_torch.extensions.fixer",
              "mpisppy_tpu_torch.extensions.mipgapper",
              "mpisppy_tpu_torch.extensions.norm_rho_updater",
              "mpisppy_tpu_torch.extensions.xhatclosest",
              "mpisppy_tpu_torch.extensions.diagnoser",
              "mpisppy_tpu_torch.extensions.avgminmaxer",
              # scenario-axis sharding
              "mpisppy_tpu_torch.parallel",
              "mpisppy_tpu_torch.parallel.mesh",
              "mpisppy_tpu_torch.parallel.launch",
              # scenario streaming
              "mpisppy_tpu_torch.stream",
              "mpisppy_tpu_torch.stream.prng",
              "mpisppy_tpu_torch.stream.quant",
              "mpisppy_tpu_torch.stream.synth",
              "mpisppy_tpu_torch.stream.pipeline",
              "mpisppy_tpu_torch.stream.source"):
        assert m in mods
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['mpisppy_tpu'] = None\n"
            "import importlib\n"
            + "".join(f"importlib.import_module({m!r})\n" for m in mods)
            # the synth specs' generators run with JAX poisoned too
            + "from mpisppy_tpu_torch.models import farmer, uc\n"
            "from mpisppy_tpu_torch.stream import synth_batch\n"
            "synth_batch(farmer.scenario_creator, farmer.make_tree(3),\n"
            "            farmer.scenario_synth_spec)\n"
            "synth_batch(uc.scenario_creator, uc.make_tree(3),\n"
            "            uc.scenario_synth_spec,\n"
            "            creator_kwargs={'num_gens': 3, 'num_hours': 4})\n"
            "import chip_smoke\n"
            "import trace_mesh_gap\n"
            "print('PORTFREE')\n")
    out = subprocess.run([sys.executable, "-c", code],
                         env={**os.environ, "PYTHONPATH": REPO},
                         capture_output=True, text=True, timeout=120,
                         cwd=REPO)
    assert out.returncode == 0, out.stderr
    assert "PORTFREE" in out.stdout


def _imported_roots(path):
    tree = ast.parse(open(path, encoding="utf-8").read())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_no_jax_or_reference_import_anywhere():
    files = _python_files()
    assert len(files) > 40
    for path in files:
        bad = _imported_roots(path) & {"jax", "jaxlib", "mpisppy_tpu"}
        assert not bad, f"{os.path.relpath(path, REPO)} imports {bad}"


def _python_files():
    files = [os.path.join(REPO, n) for n in ("chip_smoke.py",
                                             "trace_mesh_gap.py")]
    for dirpath, _, names in os.walk(PKG):
        files += [os.path.join(dirpath, n) for n in names
                  if n.endswith(".py")]
    return files


def test_no_string_names_a_jax_package_module():
    """No string literal in the port (docstrings included) names a
    module of the JAX package as a dotted path: a subprocess spawned
    with ``-m <that path>`` (the host oracle's workers) would run
    JAX-package code, which the import scan cannot see."""
    pat = re.compile(r"(?<![\w.])mpisppy_tpu\.[A-Za-z_]")
    for path in _python_files():
        tree = ast.parse(open(path, encoding="utf-8").read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Constant) and isinstance(node.value,
                                                             str):
                assert not pat.search(node.value), \
                    f"{os.path.relpath(path, REPO)}:{node.lineno} names " \
                    f"a JAX-package module: {node.value[:80]!r}"
    # the process wheels spawn the port's own workers and build the
    # port's own copy of the native windows
    scanned = {os.path.relpath(p, PKG) for p in _python_files()}
    assert {"utils/multiproc.py", "core/aph_shard.py",
            "ops/native/__init__.py"} <= scanned
    from mpisppy_tpu_torch.core import aph_shard
    from mpisppy_tpu_torch.ops import native
    from mpisppy_tpu_torch.utils import multiproc
    assert multiproc._spoke_worker.__module__ == \
        "mpisppy_tpu_torch.utils.multiproc"
    assert aph_shard._shard_worker.__module__ == \
        "mpisppy_tpu_torch.core.aph_shard"
    assert aph_shard._model("farmer").__name__ == \
        "mpisppy_tpu_torch.models.farmer"
    assert native.SRC.is_relative_to(PKG)
    # the oracle workers run the port's own worker module
    from mpisppy_tpu_torch.utils import _oracle_worker
    assert _oracle_worker.__name__ == "mpisppy_tpu_torch.utils._oracle_worker"
    src = open(os.path.join(PKG, "utils", "host_oracle.py"),
               encoding="utf-8").read()
    assert '"-m", _oracle_worker.__name__' in src


def test_entry_point_without_device_raises_without_a_card(monkeypatch):
    """No card and no device="cpu": the engine raises instead of
    running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    batch = build_batch(farmer.scenario_creator, farmer.make_tree(3))
    from mpisppy_tpu_torch.core.ph import PH
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PH(batch, {})
    with pytest.raises(RuntimeError, match="CUDA"):
        runtime.resolve_device("cuda")
    assert runtime.resolve_device("cpu") == torch.device("cpu")
    assert PH(batch, {}, device="cpu").device == torch.device("cpu")


def test_precision_pins():
    runtime.resolve_device("cpu")
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"
    assert mpisppy_tpu_torch.__version__


def test_chip_smoke_refuses_without_a_card():
    """Without CUDA the script exits non-zero and prints no result."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, os.path.join(REPO,
                                                       "chip_smoke.py")],
                         capture_output=True, text=True, timeout=120,
                         cwd=REPO)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
