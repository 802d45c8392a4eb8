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
                   "obs/slo.py", "obs/trace.py", "obs/tracer.py", "obs/ensemble.py",
                   "sim/ensemble.py", "sim/ensemble_tick.py", "sim/rapid.py",
                   "testlib/__init__.py",
                   "testlib/invariants.py", "testlib/serving.py",
                   "serve/__init__.py", "serve/events.py", "serve/engine.py",
                   "serve/spec.py", "serve/bridge.py", "serve/ingest.py",
                   "serve/telemetry.py", "serve/load.py", "transport/__init__.py",
                   "transport/api.py", "transport/codec.py", "transport/message.py",
                   "transport/tcp.py", "native/__init__.py", "utils/__init__.py",
                   "utils/address.py", "utils/ids.py", "utils/streams.py"):
        assert f"scalecube_cluster_tpu_torch/{module}" in names, module
    assert "chip_smoke.py" in names
    assert (PORT / "native" / "framing.c").is_file()


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


def test_certifier_copy_matches_reference():
    """The port's copy of the SWIM certifiers (``testlib/invariants.py``)
    against the reference's on the same traces: ``REQUIRED_KEYS``,
    ``heal_bound`` for several parameter sets, ``certify_traces``'s summary
    and ``certify_population``'s verdicts, clean and with each of C1, C2,
    C4 and C6 broken."""
    import dataclasses

    import numpy as np

    from scalecube_cluster_tpu.testlib import invariants as JI
    from scalecube_cluster_tpu_torch.sim.params import SimParams as TSimParams
    from scalecube_cluster_tpu_torch.testlib import invariants as TI
    from tests.test_sim import small_params

    assert TI.REQUIRED_KEYS == JI.REQUIRED_KEYS
    assert TI._OPTIONAL_EVENT_KEYS == JI._OPTIONAL_EVENT_KEYS
    for kw in ({}, {"suspicion_ticks": 40}, {"sync_period_ticks": 3}):
        jp = small_params(32, **kw)
        assert TI.heal_bound(TSimParams(**dataclasses.asdict(jp))) == JI.heal_bound(jp)
    rng = np.random.default_rng(7)
    b, t = 5, 120
    tr = {k: np.zeros((b, t), np.int32) for k in JI.REQUIRED_KEYS}
    tr["fault_blocked"] = rng.integers(0, 3, (b, t)).astype(np.int32)
    tr["link_delivered"] = rng.integers(0, 9, (b, t)).astype(np.int32)
    tr["link_attempts"] = tr["link_delivered"] + tr["fault_blocked"]
    tr["plan_dirty"] = np.ones((b, t), bool)
    tr["plan_dirty"][:, 40:] = False
    tr["fault_blocked"][:, 40:] = 0
    tr["link_attempts"] = tr["link_delivered"] + tr["fault_blocked"]
    tr["pings"] = rng.integers(3, 6, (b, t)).astype(np.int32)
    tr["acks"] = tr["pings"] - (rng.random((b, t)) < 0.2)
    tr["suspicions_raised"][:, 30] = 2
    tr["inc_max"] = np.cumsum(rng.random((b, t)) < 0.05, axis=1).astype(np.int32)
    tr["restarts_fired"][:, 10] = 1
    tr["epoch_max"][:, 10:] = 1
    tr["plan_dirty"] = tr["plan_dirty"].astype(bool)
    tr["link_delivered"][1, 50] += 1  # C1
    tr["fault_blocked"][2, 60] = 1  # C2 on a clean tick
    tr["link_attempts"][2, 60] += 1
    tr["epoch_max"][3, 70:] = 2  # C4: no restart at tick 70
    tr["pings"][4, :31] = tr["acks"][4, :31]  # C6: no miss before the suspicion
    jp = small_params(32)
    tp = TSimParams(**dataclasses.asdict(jp))
    final = np.array([1.0, 1.0, 0.5, 1.0, 1.0], np.float32)
    want = JI.certify_population(jp, tr, final_convergence=final)
    got = TI.certify_population(tp, tr, final_convergence=final)
    assert list(got["ok"]) == [True, False, False, False, False]
    assert np.array_equal(got["ok"], want["ok"])
    assert got["violations"] == want["violations"]
    assert got["summaries"] == want["summaries"]
    one = {k: v[0] for k, v in tr.items()}
    assert TI.certify_traces(tp, one) == JI.certify_traces(jp, one)
