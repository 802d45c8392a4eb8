"""Dense-engine runs with per-tick metric traces
(port of scalecube_cluster_tpu/sim/run.py over a fixed ``FaultPlan``).

The reference scans ``sim_tick`` under ``jit``; here a Python loop steps
the ticks eagerly. Fault schedules and knobs are not ported yet and raise
``NotImplementedError`` (ROADMAP A8).
"""

from __future__ import annotations

import numpy as np
import torch

from scalecube_cluster_tpu_torch.sim.faults import FaultPlan
from scalecube_cluster_tpu_torch.sim.params import SimParams
from scalecube_cluster_tpu_torch.sim.state import SimState
from scalecube_cluster_tpu_torch.sim.tick import sim_tick


def run_ticks(
    params: SimParams,
    state: SimState,
    plan: FaultPlan,
    seeds: torch.Tensor,
    n_ticks: int,
    collect: bool = True,
    knobs=None,
):
    """Run ``n_ticks`` gossip periods. Returns ``(final_state, traces)``:
    each metric stacked along a leading tick axis, as device tensors.
    ``collect=False`` trims the traces to the tick counter."""
    per_tick = []
    for _ in range(n_ticks):
        state, metrics = sim_tick(params, state, plan, seeds, collect=collect, knobs=knobs)
        per_tick.append(metrics)
    if not per_tick:
        return state, {}
    return state, {k: torch.stack([m[k] for m in per_tick]) for k in per_tick[0]}


def run_chunked(
    params: SimParams,
    state: SimState,
    plan: FaultPlan,
    seeds: torch.Tensor,
    n_ticks: int,
    chunk: int = 50,
    collect: bool = True,
    knobs=None,
):
    """Run ``n_ticks`` in ``chunk``-tick pieces. Returns ``(final_state,
    traces)`` with the traces as numpy arrays trimmed to exactly
    ``n_ticks``; the state advances to the next chunk boundary, as the
    reference's does (ceil(n_ticks / chunk) · chunk ticks)."""
    if chunk <= 0:
        raise ValueError("chunk must be positive")
    if n_ticks <= 0:
        return state, {}
    pieces = []
    done = 0
    while done < n_ticks:
        state, tr = run_ticks(params, state, plan, seeds, chunk, collect=collect, knobs=knobs)
        take = min(chunk, n_ticks - done)
        pieces.append({k: v.cpu().numpy()[:take] for k, v in tr.items()})
        done += take
    return state, {k: np.concatenate([p[k] for p in pieces], axis=0) for k in pieces[0]}


def run_until(
    params: SimParams,
    state: SimState,
    plan: FaultPlan,
    seeds: torch.Tensor,
    predicate,
    max_ticks: int,
    chunk: int = 16,
):
    """Run collected chunks until ``predicate(metrics)`` holds for the last
    tick's metrics (a dict of 0-d tensors) or ``max_ticks`` elapse.
    Returns ``(state, ticks_run, satisfied)``."""
    ticks = 0
    while ticks < max_ticks:
        state, traces = run_ticks(params, state, plan, seeds, chunk)
        ticks += chunk
        if predicate({k: v[-1] for k, v in traces.items()}):
            return state, ticks, True
    return state, ticks, False
