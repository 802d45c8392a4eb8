"""The port's experiments (``scalecube_cluster_tpu_torch/experiments/``)
against the reference's (``scalecube_cluster_tpu.experiments``), on the CPU.

Each grid scenario runs at reduced arguments through both packages: every
field of its row must be equal but the wall-clock ``member_rounds_per_sec``.
The chaos and sweep command lines run with ``--cpu`` through both packages'
``main``: the same stdout (the grow matrix's wall-clock ``promo_ms``
masked), the same ``--out`` JSONL rows apart from the ``run_metadata``
stamps, the same Prometheus gauges and the same exit status. The load
command line conserves every event. Without a card and without ``--cpu``
every command line, and every library entry point at its default device, raises.
Tolerance: none (exact).
"""

import json
import re

import pytest
import torch

from scalecube_cluster_tpu.experiments import chaos as JChaos
from scalecube_cluster_tpu.experiments import scenarios as JS
from scalecube_cluster_tpu.experiments import sweep as JSweep
from scalecube_cluster_tpu.obs import export as JExport
from scalecube_cluster_tpu_torch.experiments import __main__ as TMain
from scalecube_cluster_tpu_torch.experiments import chaos as TChaos
from scalecube_cluster_tpu_torch.experiments import load as TLoad
from scalecube_cluster_tpu_torch.experiments import scenarios as TS
from scalecube_cluster_tpu_torch.experiments import sweep as TSweep
from scalecube_cluster_tpu_torch.obs import export as TExport
from scalecube_cluster_tpu_torch.testlib import chaos as TC
from scalecube_cluster_tpu_torch.testing import one_cpu_thread, shared_result
from tests.test_torch_chaos import share_trials

one_cpu_thread()

#: Each scenario at a reduced size (the partition scenario's length is set
#: by its protocol constants: 1,024 ticks at n=32).
SCENARIOS = {
    "join": ("join_scenario", {"n": 32, "max_ticks": 100}),
    "lossy_suspicion": ("lossy_suspicion_scenario", {"n": 64, "ticks": 60}),
    "partition_recovery": ("partition_recovery_scenario", {"n": 32}),
    "churn": ("churn_benchmark", {"n": 64, "churn_per_chunk": 2, "ticks": 40}),
    "sparse_scale_failure": ("sparse_scale_scenario", {"n": 64, "ticks_per_phase": 48}),
    "sparse_churn": ("sparse_churn_scenario", {"n": 64, "churn_per_chunk": 4, "ticks": 96}),
}
TIMING = {"member_rounds_per_sec"}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_matches_reference(name):
    fn, kw = SCENARIOS[name]
    got = getattr(TS, fn)(**kw, device="cpu")
    want = shared_result(f"ref-scenario-{name}", lambda: getattr(JS, fn)(**kw))
    assert set(got) == set(want)
    assert {k: v for k, v in got.items() if k not in TIMING} == {
        k: v for k, v in want.items() if k not in TIMING
    }
    assert got["scenario"] == name
    if name == "partition_recovery":
        assert got["partition_detected"] and got["healed_convergence"] == 1.0
    if name == "lossy_suspicion":
        assert got["false_deaths"] == 0


_GRID_FNS = (
    "join_scenario", "lossy_suspicion_scenario", "partition_recovery_scenario",
    "churn_benchmark", "sparse_scale_scenario", "sparse_churn_scenario",
)


def _recorded_grid(module, monkeypatch, scale, **kw):
    """The scenario calls ``run_all(scale)`` makes, each recorded instead
    of run: ``(function, kwargs)`` in order."""
    calls = []
    for fn in _GRID_FNS:
        def record(fn=fn, **args):
            args.pop("device", None)
            calls.append((fn, args))
            return {"scenario": fn}

        monkeypatch.setattr(module, fn, record)
    module.run_all(scale, **kw)
    return calls


@pytest.mark.parametrize("scale", ["small", "large"])
def test_grid_matches_reference(scale, monkeypatch, capsys):
    """Both grids call the reference's scenarios, in its order, at its
    widths (the large grid is the one-card run, measured on the card)."""
    got = _recorded_grid(TS, monkeypatch, scale, device="cpu")
    assert got == _recorded_grid(JS, monkeypatch, scale)
    assert [fn for fn, _ in got] == list(_GRID_FNS)
    with pytest.raises(ValueError, match="unknown scale"):
        TS.run_all("medium", device="cpu")


def test_grid_main_writes_rows(tmp_path, monkeypatch, capsys):
    """``python -m ...experiments small --cpu --out F --prom F``: the rows
    run_all returns, stamped and written; the device is the CPU."""
    seen = {}

    def fake_run_all(scale, device):
        seen.update(scale=scale, device=device)
        return [{"scenario": "join", "n": 8, "converged": True}]

    monkeypatch.setattr(TMain, "run_all", fake_run_all)
    out, prom = tmp_path / "grid.jsonl", tmp_path / "grid.prom"
    assert TMain.main(["small", "--cpu", "--out", str(out), "--prom", str(prom)]) == 0
    assert seen == {"scale": "small", "device": "cpu"}
    (row,) = [json.loads(line) for line in out.read_text().splitlines()]
    assert row["kind"] == "experiment" and row["converged"] is True
    assert row["platform"] == "cpu"
    assert "scalecube_experiment_n{" in prom.read_text()


#: run_metadata's stamps: commit, platform, versions, device kind, census
#: digests (``n`` is a payload field too, and equal).
STAMPS = (set(JExport.run_metadata(commit="x")) | set(TExport.run_metadata(commit="x"))) - {"n"}
_PROMO = re.compile(r" promo_ms=\[[^\]]*\]")


def _rows(path):
    rows = [json.loads(line) for line in path.read_text().splitlines()]
    for row in rows:
        for key in STAMPS:
            row.pop(key, None)
        row.pop("promotion_wall_ms", None)
    return rows


def _cli(main, argv, out, capsys):
    status = main([*argv, "--out", str(out)])
    return status, _PROMO.sub("", capsys.readouterr().out), _rows(out)


#: Each case's trials are those of tests/test_torch_chaos.py (the same
#: seeds, widths and engines), read from its runs through ``share_trials``.
CHAOS_ARGS = {
    "soak": ["--seeds", "3", "--n", "24", "--engines", "rapid"],
    "soak-loop": ["--seeds", "2", "--n", "24", "--engines", "rapid_fb", "--no-ensemble"],
    "race": ["--race", "--seeds", "3", "--n", "24", "--swim-engine", "sparse"],
    "geo": ["--geo", "--seeds", "2", "--seed-start", "1", "--n", "16", "--engines", "rapid_fb"],
    "grow": ["--grow", "--seeds", "1", "--n", "16", "--tiers", "1"],
}


@pytest.mark.parametrize("case", sorted(CHAOS_ARGS))
def test_chaos_cli_matches_reference(case, tmp_path, capsys, monkeypatch):
    share_trials(monkeypatch)
    argv = ["--cpu", *CHAOS_ARGS[case]]
    got = _cli(TChaos.main, argv, tmp_path / "port.jsonl", capsys)
    want = _cli(JChaos.main, argv, tmp_path / "ref.jsonl", capsys)
    assert got == want
    status, stdout, rows = got
    assert status == 0 and json.loads(stdout.splitlines()[-1])["violations"] == 0
    assert rows and all(r["ok"] for r in rows)


def test_sweep_cli_matches_reference(tmp_path, capsys):
    """Seeds x suspicion multipliers x fan-out caps as one ensemble per
    engine: the population and universe rows, the Prometheus gauges, the
    summary line and the exit status."""
    argv = [
        "--cpu", "--seeds", "2", "--n", "16", "--ticks", "60",
        "--engines", "dense,sparse", "--suspicion-mults", "1.0,1.5",
        "--fanout-caps", "none,2",
    ]
    proms = tmp_path / "port.prom", tmp_path / "ref.prom"
    got = _cli(TSweep.main, [*argv, "--prom", str(proms[0])], tmp_path / "port.jsonl", capsys)
    want = _cli(JSweep.main, [*argv, "--prom", str(proms[1])], tmp_path / "ref.jsonl", capsys)
    assert got == want
    status, stdout, rows = got
    assert status == 0 and len(rows) == 2 * (1 + 8)
    assert [r["kind"] for r in rows[:2]] == ["ensemble_population", "ensemble_universe"]

    def gauges(path):
        """The gauge lines with the stamp labels taken out."""
        stamp = re.compile(r'(?:%s)="[^"]*",?' % "|".join(sorted(STAMPS)))
        return [stamp.sub("", line) for line in path.read_text().splitlines()]

    assert gauges(proms[0]) == gauges(proms[1])
    assert any("pass_rate" in line for line in gauges(proms[0]))


def test_load_cli_conserves(capsys):
    status = TLoad.main([
        "--cpu", "--producers", "8", "--adversarial", "5", "--events", "40",
        "--n", "24", "--max-pending", "256",
    ])
    lines = capsys.readouterr().out.splitlines()
    verdicts = json.loads(lines[-1])
    assert status == 0, lines
    assert verdicts == {
        "conservation_ok": True, "rejected_ok": True, "bounded_ok": True,
        "producer_errors": 0,
    }
    assert lines[-2].startswith("load: 8 producers (5 hostile)")


def test_entry_points_need_the_card_or_cpu():
    """Without a CUDA device, a command line given no ``--cpu`` and a library
    entry point at its default device both raise; neither falls back."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the entry points run on it")
    for main, argv in (
        (TMain.main, ["small"]),
        (TChaos.main, ["--seeds", "1"]),
        (TSweep.main, ["--seeds", "1"]),
        (TLoad.main, ["--producers", "1"]),
    ):
        with pytest.raises(SystemExit, match="no CUDA device"):
            main(argv)
    for call in (
        lambda: TC.chaos_trial(0, 16, "dense"),
        lambda: TC.chaos_ensemble([0], 16, "sparse"),
        lambda: TC.geo_trial(0, 16, "rapid_fb"),
        lambda: TC.grow_trial(0, 16, 1),
        lambda: TS.join_scenario(n=16),
    ):
        with pytest.raises((AssertionError, RuntimeError)) as e:
            call()
        assert "CUDA" in str(e.value) or "cuda" in str(e.value)
