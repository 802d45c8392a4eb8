"""Dense-engine runs with per-tick metric traces
(port of scalecube_cluster_tpu/sim/run.py).

The reference scans ``sim_tick`` under ``jit``; here a Python loop steps
the ticks eagerly. ``plan`` is a fixed :class:`FaultPlan` or a
:class:`FaultSchedule`, resolved per global tick (sim/schedule.py): the
segment and the flap phase on the host, the events applied before the tick
only on ticks whose host table holds one. Scheduled collected traces add
``plan_dirty``, ``kills_fired``, ``restarts_fired`` and, with a world, the
``zone_*`` gauges.
"""

from __future__ import annotations

import numpy as np
import torch

from scalecube_cluster_tpu_torch.sim.faults import FaultPlan
from scalecube_cluster_tpu_torch.sim.params import SimParams
from scalecube_cluster_tpu_torch.sim.schedule import (
    FaultSchedule,
    apply_events_dense,
    host_events_at,
    plan_at,
    plan_dirty_at,
)
from scalecube_cluster_tpu_torch.sim.state import SimState
from scalecube_cluster_tpu_torch.sim.tick import sim_tick
from scalecube_cluster_tpu_torch.sim.topology import (
    zone_metrics_from_counts,
    zone_pair_counts,
)


def check_plan(plan) -> bool:
    """True for a :class:`FaultSchedule`, False for a :class:`FaultPlan`;
    anything else raises ``TypeError``."""
    if isinstance(plan, FaultSchedule):
        return True
    if isinstance(plan, FaultPlan):
        return False
    raise TypeError(f"plan must be a FaultPlan or a FaultSchedule, got {type(plan).__name__}")


def scheduled_inputs(schedule: FaultSchedule, t: int, n: int, device, traces=None,
                     joins: bool = False):
    """Global tick ``t``'s plan and ``(kill, restart)`` masks (device
    tensors; None when the host table holds no event at ``t``), recorded
    in ``traces`` (a :class:`ScheduleTraces`) when given. ``joins`` (an
    elastic state) fires the join lane too, as the 4-tuple ``(kill,
    restart, None, join)``."""
    ev = host_events_at(schedule, t, n, joins=joins)
    if traces is not None:
        traces.record(t, ev)
    if ev is None:
        return plan_at(schedule, t), None
    masks = tuple(torch.from_numpy(m).to(device) for m in ev)
    events = masks[:2] + (None, masks[2]) if joins else masks
    return plan_at(schedule, t), events


def stack_ticks(per_tick: list[dict], dim: int = 0) -> dict:
    """The runners' traces: each key's per-tick tensors stacked along a new
    tick axis ``dim`` (1 behind a leading universe axis)."""
    return {k: torch.stack([m[k] for m in per_tick], dim=dim) for k in per_tick[0]}


class ScheduleTraces:
    """The scheduled runners' extra per-tick trace keys, gathered on the
    host and stacked once per run (the zone gauges' per-viewer counts stay
    on the device until then)."""

    def __init__(self, schedule: FaultSchedule, joins: bool = False):
        self.schedule = schedule
        self.dirty, self.kills, self.restarts, self.zone_counts = [], [], [], []
        self.joins = [] if joins else None

    def record(self, t: int, ev) -> None:
        self.dirty.append(plan_dirty_at(self.schedule, t))
        self.kills.append(0 if ev is None else int(ev[0].sum()))
        self.restarts.append(0 if ev is None else int(ev[1].sum()))
        if self.joins is not None:
            self.joins.append(0 if ev is None else int(ev[2].sum()))

    def add_view(self, count_rows) -> None:
        """Count the zone gauges of this tick's view: ``count_rows(world)``
        returns the [4, N] per-viewer counts (sim/topology.py)."""
        if self.schedule.link_world is not None:
            self.zone_counts.append(count_rows(self.schedule.link_world))

    def finish(self, traces: dict, device) -> dict:
        traces = dict(traces)
        traces["plan_dirty"] = torch.tensor(self.dirty, dtype=torch.bool, device=device)
        traces["kills_fired"] = torch.tensor(self.kills, dtype=torch.int32, device=device)
        traces["restarts_fired"] = torch.tensor(self.restarts, dtype=torch.int32, device=device)
        if self.joins is not None:
            traces["joins_fired"] = torch.tensor(self.joins, dtype=torch.int32, device=device)
        world = self.schedule.link_world
        if world is not None:
            counts = torch.stack(self.zone_counts).cpu().numpy()
            zone = zone_metrics_from_counts(world.zone.cpu().numpy(), world.n_zones, counts)
            traces.update({k: torch.from_numpy(v).to(device) for k, v in zone.items()})
        return traces


def run_ticks(
    params: SimParams,
    state: SimState,
    plan: FaultPlan | FaultSchedule,
    seeds: torch.Tensor,
    n_ticks: int,
    collect: bool = True,
    knobs=None,
):
    """Run ``n_ticks`` gossip periods. Returns ``(final_state, traces)``:
    each metric stacked along a leading tick axis, as device tensors.
    ``collect=False`` trims the traces to the tick counter."""
    scheduled = check_plan(plan)
    extra = ScheduleTraces(plan) if scheduled and collect else None
    per_tick = []
    for _ in range(n_ticks):
        plan_t = plan
        if scheduled:
            plan_t, events = scheduled_inputs(
                plan, state.t_host + 1, params.n, state.device, extra
            )
            if events is not None:
                state = apply_events_dense(state, *events)
        state, metrics = sim_tick(params, state, plan_t, seeds, collect=collect, knobs=knobs)
        if extra is not None:
            extra.add_view(lambda w: zone_pair_counts(w, state.view, state.alive, state.epoch))
        per_tick.append(metrics)
    if not per_tick:
        return state, {}
    traces = stack_ticks(per_tick)
    if extra is not None:
        traces = extra.finish(traces, state.device)
    return state, traces


def run_chunked(
    params: SimParams,
    state: SimState,
    plan: FaultPlan | FaultSchedule,
    seeds: torch.Tensor,
    n_ticks: int,
    chunk: int = 50,
    collect: bool = True,
    knobs=None,
):
    """Run ``n_ticks`` in ``chunk``-tick pieces. Returns ``(final_state,
    traces)`` with the traces as numpy arrays trimmed to exactly
    ``n_ticks``; the state advances to the next chunk boundary, as the
    reference's does (ceil(n_ticks / chunk) · chunk ticks). A schedule is
    keyed by global ticks, so chunking never re-phases it."""
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
