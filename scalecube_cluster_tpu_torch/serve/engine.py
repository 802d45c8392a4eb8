"""Serve steps: k engine ticks driven by one EventBatch (port of the solo
entries of scalecube_cluster_tpu/serve/engine.py).

The serving twins of sim/sparse.py::run_sparse_ticks and
sim/rapid.py::run_rapid_ticks: the per-tick event masks come from the
batch's rows instead of a FaultSchedule lookup, the plan is one fixed
FaultPlan. The reference scans a jitted body; here a Python loop steps the
ticks eagerly, with every mask of the launch built at once on the state's
device (serve/events.py) and each tick handed its row. The traces keep the
reference's scan schema: the tick's metrics plus ``plan_dirty``,
``kills_fired``, ``restarts_fired``, ``gossip_fired`` / ``joins_fired``,
and ``ingest_overflow`` overridden by the batch's deferral counts (the
tick's own slot is a constant zero), stacked by the port runners' own
:func:`~scalecube_cluster_tpu_torch.sim.run.stack_ticks`. Nothing here reads
the device: the sparse entries consume their state as sparse_tick does
(the reference donates it); the Rapid entry reads one host flag a launch
(which rows fire an event) where the reference's ``lax.cond`` branches.

The fleet entries (the reference's ``run_fleet_*``) belong to the fleet
slice and are not here.
"""

from __future__ import annotations

import torch

from scalecube_cluster_tpu_torch.serve.events import (
    EventBatch,
    event_masks,
    event_masks_elastic,
    event_masks_rapid,
)
from scalecube_cluster_tpu_torch.sim.faults import FaultPlan, plan_any_faults
from scalecube_cluster_tpu_torch.sim.knobs import Knobs
from scalecube_cluster_tpu_torch.sim.rapid import (
    RapidParams,
    RapidState,
    _apply_events,
    _Consts,
    _lift,
    _lower,
    _tick,
)
from scalecube_cluster_tpu_torch.sim.run import stack_ticks
from scalecube_cluster_tpu_torch.sim.sparse import SparseParams, SparseState, sparse_tick

_I32 = torch.int32


def _fired(mask: torch.Tensor) -> torch.Tensor:
    """[k] int32: rows each tick's mask sets (over every axis after the first)."""
    return mask.reshape(mask.shape[0], -1).sum(dim=1, dtype=_I32)


def _serve_extras(traces: dict, plan: FaultPlan, batch: EventBatch, fired: dict) -> dict:
    """The collected serve trace extras of the reference's scan body."""
    traces = dict(traces)
    traces["plan_dirty"] = plan_any_faults(plan).reshape(1).expand(batch.n_ticks).clone()
    for key, mask in fired.items():
        traces[key] = _fired(mask)
    traces["ingest_overflow"] = batch.deferred
    return traces


def _run_sparse(params, state, plan, batch, collect, knobs, elastic):
    n = params.base.n
    g_slots = state.useen.shape[1]
    batch = batch.to(state.device)
    if elastic:
        masks = event_masks_elastic(batch.node, batch.kind, batch.arg, n, g_slots)
        keys = ("kills_fired", "restarts_fired", "gossip_fired", "joins_fired")
    else:
        masks = event_masks(batch.node, batch.kind, batch.arg, n, g_slots)
        keys = ("kills_fired", "restarts_fired", "gossip_fired")
    per_tick = []
    for r in range(batch.n_ticks):
        state, metrics = sparse_tick(
            params, state, plan, collect=collect,
            events=tuple(m[r] for m in masks), knobs=knobs,
        )
        per_tick.append(metrics)
    traces = stack_ticks(per_tick)
    if collect:
        traces = _serve_extras(traces, plan, batch, dict(zip(keys, masks)))
    return state, traces


def scan_serve_batch(
    params: SparseParams,
    state: SparseState,
    plan: FaultPlan,
    batch: EventBatch,
    collect: bool = True,
    knobs: Knobs | None = None,
):
    """Step the sparse engine ``batch.n_ticks`` ticks, one batch row per
    tick. Returns ``(state, traces)`` with the scheduled runners' trace
    schema plus ``gossip_fired`` and the ``ingest_overflow`` override.
    Consumes ``state``."""
    return _run_sparse(params, state, plan, batch, collect, knobs, elastic=False)


#: The reference's jitted entry over the same body (its state donated).
run_serve_batch = scan_serve_batch


def scan_serve_batch_elastic(
    params: SparseParams,
    state: SparseState,
    plan: FaultPlan,
    batch: EventBatch,
    collect: bool = True,
    knobs: Knobs | None = None,
):
    """The elastic flavor: the EV_JOIN lane routes to sparse_tick's 4-tuple
    events, so live ``join`` traffic activates masked capacity rows in the
    tick. Requires an elastic state (``live_mask``); the trace extras add
    ``joins_fired``. Consumes ``state``."""
    return _run_sparse(params, state, plan, batch, collect, knobs, elastic=True)


run_serve_batch_elastic = scan_serve_batch_elastic


def scan_rapid_serve_batch(
    params: RapidParams,
    state: RapidState,
    plan: FaultPlan,
    batch: EventBatch,
    collect: bool = True,
    knobs: Knobs | None = None,
):
    """Step the Rapid engine ``batch.n_ticks`` rounds: each row's kill /
    restart / join lanes go through :func:`apply_events_rapid`'s arithmetic
    (a join arms the seed-routed handshake), then the round. The trace
    extras carry ``joins_fired`` where the SWIM path has ``gossip_fired``.
    The input state is not consumed (the reference does not donate it);
    its trace ring, when armed, is."""
    batch = batch.to(state.device)
    kill, restart, join = event_masks_rapid(batch.node, batch.kind, params.n)
    fires = (kill | restart | join).any(dim=1).tolist()
    st = _lift(state)
    consts = _Consts(params.n, params.k, state.device)
    per_tick = []
    for r in range(batch.n_ticks):
        if fires[r]:
            st = _apply_events(params, st, kill[r][None], restart[r][None], join[r][None])
        st, metrics = _tick(params, st, plan, collect, knobs, consts)
        per_tick.append(metrics)
    traces = {k: v[0] for k, v in stack_ticks(per_tick, dim=1).items()}
    if collect:
        traces = _serve_extras(
            traces, plan, batch,
            {"kills_fired": kill, "restarts_fired": restart, "joins_fired": join},
        )
    return _lower(st), traces


run_rapid_serve_batch = scan_rapid_serve_batch
