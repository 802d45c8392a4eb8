"""Scenario runners for the BASELINE.json experiment configs and the
command lines (port of scalecube_cluster_tpu/experiments/):
``python -m scalecube_cluster_tpu_torch.experiments`` (the scenario grid),
``.experiments.chaos``, ``.experiments.sweep`` and ``.experiments.load``.
Each runs on the card unless given ``--cpu``."""

from scalecube_cluster_tpu_torch.experiments.scenarios import (
    churn_benchmark,
    join_scenario,
    lossy_suspicion_scenario,
    partition_recovery_scenario,
    run_all,
)

__all__ = [
    "churn_benchmark",
    "cli_device",
    "join_scenario",
    "lossy_suspicion_scenario",
    "partition_recovery_scenario",
    "run_all",
]


def cli_device(cpu: bool) -> str:
    """The device a command line runs on: ``"cpu"`` when asked
    (``--cpu``), else the card. Raises ``SystemExit`` when there is no CUDA
    device and the CPU was not asked for: a command line never falls back."""
    if cpu:
        return "cpu"
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --cpu to run on the CPU")
    return "cuda"
