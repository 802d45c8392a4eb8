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

The fleet entries (``run_fleet_*``, the reference's ``jax.vmap`` of the
solo bodies) step B tenant universes together: states, batches and knobs
stacked along a leading axis (sim/ensemble.py::stack_universes,
serve/events.py::stack_batches), the plan SHARED across universes (one
plan, expanded to the universe axis as a view: the pool's fault
environment, not the tenant's). A tick of a sparse fleet is ONE batched
tick (sim/ensemble_tick.py::ensemble_sparse_tick): one csrc/sparse_core.cu
launch for all B tenants on the kernel route. Tenants whose ticks differ
(a promoted tenant placed at its own tick) step as one batched tick per
group of equal ticks (sim/ensemble.py::_step). Traces are ``[B, k, ...]``
and ``traces[b]`` equals the solo run of universe b. The sparse fleet
entries consume the stacked state, as the reference donates it; the Rapid
one does not.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from scalecube_cluster_tpu_torch.serve.events import (
    EventBatch,
    event_masks,
    event_masks_elastic,
    event_masks_rapid,
)
from scalecube_cluster_tpu_torch.sim.ensemble import (
    _check_states,
    _step,
    ensemble_size,
    expand_plan,
)
from scalecube_cluster_tpu_torch.sim.ensemble_tick import ensemble_sparse_tick
from scalecube_cluster_tpu_torch.sim.faults import FaultPlan, plan_any_faults
from scalecube_cluster_tpu_torch.sim.knobs import Knobs
from scalecube_cluster_tpu_torch.sim.rapid import (
    FallbackState,
    RapidParams,
    RapidState,
    _apply_events,
    _Consts,
    _lift,
    _lower,
    _map_tensors,
    _tick,
)
from scalecube_cluster_tpu_torch.sim.run import stack_ticks
from scalecube_cluster_tpu_torch.sim.sparse import SparseParams, SparseState, sparse_tick

_I32 = torch.int32


def _fired(mask: torch.Tensor, lead: int = 1) -> torch.Tensor:
    """int32 rows each tick's mask sets, over every axis after the first
    ``lead`` (``[k]``, or ``[B, k]`` with ``lead=2``)."""
    return mask.flatten(lead).sum(dim=lead, dtype=_I32)


def _serve_extras(traces: dict, plan: FaultPlan, batch: EventBatch, fired: dict) -> dict:
    """The collected serve trace extras of the reference's scan body (a
    fleet batch's ``deferred`` is ``[B, k]`` and its masks ``[B, k, ...]``:
    every extra then leads with the universe axis)."""
    traces = dict(traces)
    lead = batch.deferred.dim()
    shape = tuple(batch.deferred.shape)
    traces["plan_dirty"] = plan_any_faults(plan).reshape((1,) * lead).expand(shape).clone()
    for key, mask in fired.items():
        traces[key] = _fired(mask, lead)
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


# ------------------------------------------------------------ fleet entries
def _shared_plan(plan: FaultPlan, b: int) -> FaultPlan:
    """The fleet's one plan over ``b`` universes (an expanded view)."""
    return expand_plan(plan, b) if plan.block.dim() == 2 else plan


def _run_fleet_sparse(params, states, plan, batches, collect, knobs, elastic):
    _check_states(states, elastic=True)
    if elastic != (states.live_mask is not None):
        raise ValueError(
            "the elastic fleet entry takes elastic states (live_mask) and the "
            "fixed-shape entry fixed-shape ones"
        )
    n = params.base.n
    b = ensemble_size(states)
    g_slots = states.useen.shape[2]
    batches = batches.to(states.device)
    if elastic:
        masks = event_masks_elastic(batches.node, batches.kind, batches.arg, n, g_slots)
        keys = ("kills_fired", "restarts_fired", "gossip_fired", "joins_fired")
    else:
        masks = event_masks(batches.node, batches.kind, batches.arg, n, g_slots)
        keys = ("kills_fired", "restarts_fired", "gossip_fired")
    plan_b = _shared_plan(plan, b)

    def tick(st, pl, events, kn):
        return ensemble_sparse_tick(params, st, pl, collect=collect, events=events, knobs=kn)

    per_tick = []
    for r in range(batches.node.shape[1]):  # [B, k, C]
        states, metrics = _step(tick, states, plan_b, tuple(m[:, r] for m in masks), knobs,
                                collect)
        per_tick.append(metrics)
    traces = stack_ticks(per_tick, dim=1)
    if collect:
        traces = _serve_extras(traces, plan, batches, dict(zip(keys, masks)))
    return states, traces


def run_fleet_serve_batch(
    params: SparseParams,
    states: SparseState,
    plan: FaultPlan,
    batches: EventBatch,
    collect: bool = True,
    knobs: Knobs | None = None,
):
    """Step B sparse tenant universes ``k`` ticks, one batched tick a tick.

    ``states``/``batches`` (and ``knobs`` when given) are stacked with
    leading axis B; ``plan`` is one universe's plan, shared. Consumes
    ``states`` (the stacked ``view_T`` and slab are updated in place).
    Returns ``(states, traces)`` with every trace ``[B, k, ...]``;
    ``traces[b]`` equals the solo run of universe ``b``."""
    return _run_fleet_sparse(params, states, plan, batches, collect, knobs, elastic=False)


def run_fleet_serve_batch_elastic(
    params: SparseParams,
    states: SparseState,
    plan: FaultPlan,
    batches: EventBatch,
    collect: bool = True,
    knobs: Knobs | None = None,
):
    """The elastic fleet entry: every universe carries a ``live_mask`` and
    its EV_JOIN lane activates capacity rows in the tick (the batched
    tick's join lane); the trace extras add ``joins_fired``. Consumes
    ``states``."""
    return _run_fleet_sparse(params, states, plan, batches, collect, knobs, elastic=True)


def _where_universe(fire: torch.Tensor, new, old):
    """``new`` on the universes ``fire`` marks, ``old`` elsewhere, leaf by
    leaf (the per-universe select the reference's ``lax.cond`` lowers to
    under vmap)."""
    fields = {}
    for f in dataclasses.fields(new):
        a, o = getattr(new, f.name), getattr(old, f.name)
        if isinstance(a, torch.Tensor):
            a = torch.where(fire.reshape((-1,) + (1,) * (a.dim() - 1)), a, o)
        elif isinstance(a, FallbackState):
            a = _where_universe(fire, a, o)
        fields[f.name] = a
    return type(new)(**fields)


def run_fleet_rapid_serve_batch(
    params: RapidParams,
    states: RapidState,
    plan: FaultPlan,
    batches: EventBatch,
    collect: bool = True,
    knobs: Knobs | None = None,
):
    """The Rapid fleet entry: B Rapid tenant universes a launch, one batched
    round a tick (Rapid's eager tick, no kernel). A row's events go
    through :func:`apply_events_rapid`'s arithmetic on the universes whose
    row fires (one host read a launch of which rows fire). The input
    states are not consumed, as the reference does not donate them."""
    _check_states(states)
    b = ensemble_size(states)
    batches = batches.to(states.device)
    kill, restart, join = event_masks_rapid(batches.node, batches.kind, params.n)
    fires = torch.stack([kill, restart, join]).flatten(3).any(dim=3).any(dim=0)  # [B, k]
    fires_host = fires.tolist()
    consts = _Consts(params.n, params.k, states.device)
    plan_b = _shared_plan(plan, b)
    if len(set(np.asarray(states.t_host).tolist())) > 1:
        # Mixed ticks merge groups into the stack in place: work on a copy.
        states = _map_tensors(states, torch.clone)

    def tick(st, pl, events, kn):
        if events is not None:
            k_m, r_m, j_m, fire = events
            st = _where_universe(fire, _apply_events(params, st, k_m, r_m, j_m), st)
        return _tick(params, st, pl, collect, kn, consts)

    per_tick = []
    for r in range(batches.node.shape[1]):  # [B, k, C]
        events = None
        if any(row[r] for row in fires_host):
            events = (kill[:, r], restart[:, r], join[:, r], fires[:, r])
        states, metrics = _step(tick, states, plan_b, events, knobs, collect)
        per_tick.append(metrics)
    traces = stack_ticks(per_tick, dim=1)
    if collect:
        traces = _serve_extras(
            traces, plan, batches,
            {"kills_fired": kill, "restarts_fired": restart, "joins_fired": join},
        )
    return states, traces
