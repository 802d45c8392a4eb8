"""The PyTorch port stands alone: no module of ``scalecube_cluster_tpu_torch``
and not ``chip_smoke.py`` imports ``jax`` or anything of the JAX package
``scalecube_cluster_tpu``, and the package imports with jax made
unimportable (checked in a subprocess, so this worker's jax is untouched).
"""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
from scalecube_cluster_tpu_torch.testing import one_cpu_thread

one_cpu_thread()

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "scalecube_cluster_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "scalecube_cluster_tpu")


def _sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name, node.lineno
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module, node.lineno
        elif (
            isinstance(node, ast.Call)
            and getattr(node.func, "attr", getattr(node.func, "id", None))
            in ("import_module", "__import__")
            and node.args
            and isinstance(node.args[0], ast.Constant)
        ):
            yield str(node.args[0].value), node.lineno


def test_sources_exist():
    names = {p.relative_to(ROOT).as_posix() for p in _sources()}
    assert "scalecube_cluster_tpu_torch/sim/sparse.py" in names
    assert "scalecube_cluster_tpu_torch/ops/sparse_core.py" in names
    for module in ("ops/sparse_persistent.py", "ops/delivery_merge.py",
                   "sim/checkpoint.py", "sim/monitor.py", "tools/__init__.py",
                   "tools/profile_tick.py", "tools/probe_kernels.py",
                   "tools/trace_explain.py", "obs/__init__.py", "obs/counters.py",
                   "obs/export.py", "obs/latency.py", "obs/profiling.py",
                   "obs/slo.py", "obs/trace.py", "obs/tracer.py"):
        assert f"scalecube_cluster_tpu_torch/{module}" in names, module
    assert "chip_smoke.py" in names


@pytest.mark.parametrize("path", _sources(), ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_or_reference_import(path):
    """Parse every port source with ast: no import of jax or of the JAX
    package (``scalecube_cluster_tpu`` exactly, not the port's own name)."""
    bad = [
        (name, line)
        for name, line in _imported_roots(path)
        if name.split(".")[0] in FORBIDDEN
    ]
    assert not bad, f"{path}: {bad}"


def test_package_imports_without_jax():
    """With ``sys.modules['jax'] = None`` every port module still imports."""
    modules = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts)
        for p in PORT.rglob("*.py")
    )
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['scalecube_cluster_tpu'] = None\n"
        "import importlib\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m.removesuffix('.__init__'))\n"
        "print('ok', len(sys.modules))\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
        timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")
