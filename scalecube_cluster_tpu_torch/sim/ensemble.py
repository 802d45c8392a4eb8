"""Ensemble engine: B independent cluster universes stepped together
(port of scalecube_cluster_tpu/sim/ensemble.py).

B universes stack along a leading axis — states, plans or schedules,
knobs, every tensor leaf ``[B, ...]`` — and step together through ONE
batched tick a tick (sim/ensemble_tick.py), the port of the reference's
``jax.vmap`` over its scan cores: the launches a tick are those of one
universe, the device does B times the work, and the fused cores take the
universe as a grid axis (one csrc/sparse_core.cu or csrc/tick_core.cu
launch for the batch). Universe b of a batched run is bit-identical to the
same single run (tests/test_torch_ensemble.py holds both against the
reference's vmapped ensemble).

A stacked state's ``rng`` is ``uint32[B, 2]`` (each universe its own
PRNG stream) and ``t_host`` an ``int64[B]`` host mirror of each universe's
tick. Universes whose ticks differ — a fresh state put into a stack that
has run (:func:`set_universe`) — step as separate groups of the batch, so
each follows its own cadence, as the reference's per-universe select does.
A stacked :class:`~.schedule.FaultSchedule` resolves each universe at its
own global tick on the host; the stacked plan is built once per distinct
combination of segments and flap phases.

Population statistics over the batch live in obs/ensemble.py; the Rapid
twin (sim/rapid.py) steps through the same runner pieces (``_Inputs``
with the join lane, ``_step``).

Not ported yet (ROADMAP Queue A; the runners raise
``NotImplementedError``): flight-recorder rings and elastic states inside
an ensemble (A13/A14), zone worlds and tracked user gossip in ensembles,
the fleet (A13), chaos / sweep (A14) and the universe mesh (A15).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from scalecube_cluster_tpu_torch.cluster_api.member import MemberStatus
from scalecube_cluster_tpu_torch.ops.merge import decode_epoch, decode_status
from scalecube_cluster_tpu_torch.sim.ensemble_tick import (
    ensemble_sim_tick,
    ensemble_sparse_tick,
    write_back,
)
from scalecube_cluster_tpu_torch.sim.faults import FaultPlan
from scalecube_cluster_tpu_torch.sim.knobs import Knobs, make_knobs
from scalecube_cluster_tpu_torch.sim.params import SimParams
from scalecube_cluster_tpu_torch.sim.schedule import (
    EV_JOIN,
    EV_KILL,
    EV_RESTART,
    FaultSchedule,
    _Host,
    apply_events_dense,
    host_event_masks,
)
from scalecube_cluster_tpu_torch.sim.run import stack_ticks
from scalecube_cluster_tpu_torch.sim.sparse import (
    SparseParams,
    SparseState,
    _free_plan,
    effective_view,
    init_sparse_full_view,
)
from scalecube_cluster_tpu_torch.sim.state import SimState, init_full_view
from scalecube_cluster_tpu_torch.sim.tick import xla_cpu_sum_f32, xla_row_means_f32

_ALIVE = int(MemberStatus.ALIVE)
_DEAD = int(MemberStatus.DEAD)


# --------------------------------------------------------------- stacking
def _is_record(x) -> bool:
    return dataclasses.is_dataclass(x) and not isinstance(x, type)


def _structure(x):
    """What must agree for universes to stack: the dataclass type, every
    tensor's shape, dtype and device kind, and the None/non-None pattern of
    the optional fields."""
    if _is_record(x):
        return (type(x).__name__,) + tuple(
            (f.name, _structure(getattr(x, f.name))) for f in dataclasses.fields(x) if f.compare
        )
    if isinstance(x, torch.Tensor):
        return ("tensor", tuple(x.shape), str(x.dtype), x.device.type)
    if isinstance(x, np.ndarray):
        return ("array", x.shape, str(x.dtype))
    if x is None:
        return None
    return ("value", type(x).__name__)


def _stack(items: list):
    first = items[0]
    if _is_record(first):
        fields = {}
        for f in dataclasses.fields(first):
            vals = [getattr(it, f.name) for it in items]
            if f.compare:
                fields[f.name] = _stack(vals)
            else:
                # A host-side hint (FaultPlan.delay_free): kept where all agree.
                fields[f.name] = vals[0] if all(v == vals[0] for v in vals) else None
        return type(first)(**fields)
    if isinstance(first, torch.Tensor):
        return torch.stack(items)
    if isinstance(first, np.ndarray):
        return np.stack(items)
    if first is None:
        return None
    return np.asarray(items, dtype=np.int64)


def stack_universes(items):
    """Stack B same-structure states, plans, schedules or knobs into one
    batched record (leading axis B). Raises ``ValueError`` when the
    universes differ in dataclass type, in a tensor's shape, dtype or
    device, or in which optional fields are None."""
    items = list(items)
    if not items:
        raise ValueError("stack_universes needs at least one universe")
    shapes = {_structure(it) for it in items}
    if len(shapes) != 1:
        raise ValueError(
            f"universes disagree on structure: {sorted(map(str, shapes))}"
        )
    return _stack(items)


def index_universe(tree, b: int):
    """Slice universe ``b`` back out of a stacked record or trace dict."""
    if _is_record(tree):
        fields = {}
        for f in dataclasses.fields(tree):
            v = getattr(tree, f.name)
            fields[f.name] = index_universe(v, b) if f.compare else v
        return type(tree)(**fields)
    if isinstance(tree, dict):
        return {k: index_universe(v, b) for k, v in tree.items()}
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        if isinstance(tree, np.ndarray) and tree.ndim == 1:
            return int(tree[b])  # a host tick mirror
        return tree[b].clone() if isinstance(tree, torch.Tensor) else tree[b].copy()
    return tree


def set_universe(tree, b: int, sub):
    """Write one universe's record into slot ``b`` of a stacked record (the
    :func:`stack_universes` contract in reverse; structures must agree).
    The stacked tensors are written in place and returned in a new record;
    the host leaves (``rng``, ``t_host``) are copied."""
    if _structure(index_universe(tree, b)) != _structure(sub):
        raise ValueError("set_universe: the universe's structure differs from the stack's")
    return _set(tree, b, sub)


def _set(tree, b, sub):
    if _is_record(tree):
        fields = {}
        for f in dataclasses.fields(tree):
            v = getattr(tree, f.name)
            fields[f.name] = _set(v, b, getattr(sub, f.name)) if f.compare else v
        return type(tree)(**fields)
    if isinstance(tree, torch.Tensor):
        tree[b] = sub
        return tree
    if isinstance(tree, np.ndarray):
        out = tree.copy()
        out[b] = sub
        return out
    return tree


def _stack_built(make, count: int):
    """:func:`stack_universes` of ``make(0) .. make(count - 1)``, building
    one universe at a time into the stacked tensors (peak memory: the stack
    plus one universe, not twice the stack)."""
    one = make(0)
    shape = _structure(one)
    stack = _alloc(one, count)
    for b in range(count):
        if b:
            one = make(b)
        if _structure(one) != shape:
            raise ValueError("universes disagree on structure")
        stack = _set(stack, b, one)
        one = None  # free the universe before the next is built
    return stack


def _alloc(tree, count: int):
    """Uninitialised stacked leaves for ``count`` universes shaped like the
    one-universe record ``tree``."""
    if _is_record(tree):
        return type(tree)(**{
            f.name: _alloc(getattr(tree, f.name), count) if f.compare else getattr(tree, f.name)
            for f in dataclasses.fields(tree)
        })
    if isinstance(tree, torch.Tensor):
        return torch.empty((count,) + tuple(tree.shape), dtype=tree.dtype, device=tree.device)
    if isinstance(tree, np.ndarray):
        return np.zeros((count,) + tree.shape, dtype=tree.dtype)
    if tree is None:
        return None
    return np.zeros((count,), dtype=np.int64)


def init_ensemble_dense(n: int, init_seeds, user_gossip_slots: int = 4, device="cuda",
                        **kw) -> SimState:
    """Stacked :func:`init_full_view` states, one per RNG seed in
    ``init_seeds`` (each universe its own PRNG stream)."""
    seeds = [int(s) for s in init_seeds]
    return _stack_built(
        lambda b: init_full_view(n, user_gossip_slots, seed=seeds[b], device=device, **kw),
        len(seeds),
    )


def init_ensemble_sparse(n: int, init_seeds, slot_budget: int = 2048,
                         user_gossip_slots: int = 4, device="cuda", **kw) -> SparseState:
    """Stacked :func:`init_sparse_full_view` states, one per RNG seed."""
    seeds = [int(s) for s in init_seeds]
    return _stack_built(
        lambda b: init_sparse_full_view(
            n, slot_budget=slot_budget, seed=seeds[b], user_gossip_slots=user_gossip_slots,
            device=device, **kw,
        ),
        len(seeds),
    )


def knob_grid(params: SimParams, suspicion_mults=(1.0,), fanout_caps=(None,),
              device="cuda") -> Knobs:
    """Stacked knob lattice: the cross-product of the two sweeps, in
    ``suspicion_mults``-major order."""
    return stack_universes(
        make_knobs(params, suspicion_mult=float(m), fanout_cap=c, device=device)
        for m in suspicion_mults
        for c in fanout_caps
    )


def ensemble_size(states) -> int:
    """B, read off the stacked state's leading axis."""
    return int(states.alive.shape[0])


# --------------------------------------------------------------- stepping
def _check_states(states) -> None:
    if getattr(states, "trace", None) is not None:
        raise NotImplementedError(
            "flight-recorder rings inside an ensemble are not ported yet "
            "(ROADMAP A9 in ensembles): stack states without trace_capacity"
        )
    if getattr(states, "live_mask", None) is not None:
        raise NotImplementedError(
            "elastic states inside an ensemble are not ported yet "
            "(ROADMAP A10 in ensembles): stack fixed-shape states"
        )


def _stacked_hosts(schedule: FaultSchedule) -> list:
    """Per-universe host mirrors of a stacked schedule, read once."""
    hosts = schedule.__dict__.get("_stacked_hosts")
    if hosts is None:
        b, k = schedule.starts.shape
        delay = (schedule.mean_delay != 0).reshape(b, k, -1).any(dim=2).cpu().numpy()

        def np_(name):
            return getattr(schedule, name).cpu().numpy()

        cols = {name: np_(name) for name in (
            "starts", "flap_period", "flap_on", "seg_dirty", "flap_any",
            "ev_tick", "ev_node", "ev_kind")}
        hosts = [
            _Host(delay_free=~delay[i], **{name: a[i] for name, a in cols.items()})
            for i in range(b)
        ]
        schedule.__dict__["_stacked_hosts"] = hosts
    return hosts


class _Inputs:
    """Each tick's stacked plan and events, and the scheduled runners'
    per-universe trace gauges (``plan_dirty``, ``kills_fired``,
    ``restarts_fired``; ``joins_fired`` with ``joins``, which fires the
    join lane as a third event mask)."""

    def __init__(self, plans, b: int, n: int, device, collect: bool, joins: bool = False):
        if isinstance(plans, FaultSchedule):
            self.scheduled = True
            lead = plans.starts.shape[0] if plans.starts.dim() == 2 else None
        elif isinstance(plans, FaultPlan):
            self.scheduled = False
            lead = plans.block.shape[0] if plans.block.dim() == 3 else None
        else:
            raise TypeError(
                f"plans must be a stacked FaultPlan or FaultSchedule, got {type(plans).__name__}"
            )
        if lead != b:
            raise ValueError(
                f"plans must be stacked for {b} universes (stack_universes), got leading {lead}"
            )
        if plans.link_world is not None:
            raise NotImplementedError(
                "zone worlds inside an ensemble are not ported yet (ROADMAP A11 follow-up)"
            )
        self.plans, self.b, self.n, self.device = plans, b, n, device
        self.record = self.scheduled and collect
        self.kinds = (EV_KILL, EV_RESTART, EV_JOIN) if joins else (EV_KILL, EV_RESTART)
        self.dirty = []
        self.fired = [[] for _ in self.kinds]
        self._plan_key = None
        self._plan = None

    def at(self, ts: np.ndarray):
        """``(plan, events)`` at per-universe global ticks ``ts``."""
        if not self.scheduled:
            return self.plans, None
        sched = self.plans
        hosts = _stacked_hosts(sched)
        ks = [h.segment(int(t)) for h, t in zip(hosts, ts)]
        flaps = [bool(h.flap_any[k]) and h.flap_active(k, int(t)) for h, k, t in zip(hosts, ks, ts)]
        key = (tuple(ks), tuple(flaps))
        if key != self._plan_key:
            sel = torch.from_numpy(np.array([ks, flaps], dtype=np.int64)).to(self.device)
            bidx = torch.arange(self.b, device=self.device)
            block = sched.block[bidx, sel[0]]
            if any(flaps):
                block = block | (sched.flap_mask[bidx, sel[0]] & sel[1].bool()[:, None, None])
            self._plan = FaultPlan(
                block=block,
                loss=sched.loss[bidx, sel[0]],
                mean_delay=sched.mean_delay[bidx, sel[0]],
                delay_free=all(bool(h.delay_free[k]) for h, k in zip(hosts, ks)),
            )
            self._plan_key = key
        masks = None
        for i, (h, t) in enumerate(zip(hosts, ts)):
            fire = h.ev_tick == int(t)
            if not (fire & np.isin(h.ev_kind, self.kinds)).any():
                continue
            if masks is None:
                masks = np.zeros((len(self.kinds), self.b, self.n), bool)
            masks[:, i] = host_event_masks(h, int(t), self.n, self.kinds)
        if self.record:
            self.dirty.append([
                bool(h.seg_dirty[k]) or fl for h, k, fl in zip(hosts, ks, flaps)
            ])
            for j, rows in enumerate(self.fired):
                rows.append([0] * self.b if masks is None else masks[j].sum(axis=1).tolist())
        if masks is None:
            return self._plan, None
        return self._plan, tuple(torch.from_numpy(masks).to(self.device))

    def finish(self, traces: dict) -> dict:
        if not self.record:
            return traces
        traces = dict(traces)
        dev = self.device
        traces["plan_dirty"] = torch.tensor(np.asarray(self.dirty).T.copy(), device=dev)
        for key, rows in zip(("kills_fired", "restarts_fired", "joins_fired"), self.fired):
            traces[key] = torch.tensor(np.asarray(rows).T.copy(), dtype=torch.int32, device=dev)
        return traces


def _select(tree, idx: torch.Tensor, idx_np: np.ndarray):
    """Universes ``idx`` of a stacked record (copies)."""
    if tree is None:
        return None
    fields = {}
    for f in dataclasses.fields(tree):
        v = getattr(tree, f.name)
        if not f.compare:
            fields[f.name] = v
        elif isinstance(v, torch.Tensor):
            fields[f.name] = v.index_select(0, idx)
        elif isinstance(v, np.ndarray):
            fields[f.name] = v[idx_np].copy()
        elif _is_record(v):
            fields[f.name] = _select(v, idx, idx_np)
        else:
            fields[f.name] = v
    return type(tree)(**fields)


def _merge(full, part, idx: torch.Tensor, idx_np: np.ndarray):
    """Write universes ``idx`` of ``part`` back into ``full`` (tensors in
    place; host leaves copied)."""
    fields = {}
    for f in dataclasses.fields(full):
        v, w = getattr(full, f.name), getattr(part, f.name)
        if isinstance(v, torch.Tensor):
            v.index_copy_(0, idx, w)
            fields[f.name] = v
        elif isinstance(v, np.ndarray):
            out = v.copy()
            out[idx_np] = w
            fields[f.name] = out
        elif _is_record(v):
            fields[f.name] = _merge(v, w, idx, idx_np)
        else:
            fields[f.name] = v
    return type(full)(**fields)


def _step(tick_fn, states, plan, events, knobs, collect):
    """One tick of every universe: one batched tick when the universes
    share a host tick, else one per group of equal ticks."""
    ts = np.asarray(states.t_host)
    groups = np.unique(ts)
    if len(groups) == 1:
        return tick_fn(states, plan, events, knobs)
    b = ts.shape[0]
    dev = states.alive.device
    out_metrics: dict = {}
    for t in groups:
        idx_np = np.flatnonzero(ts == t)
        idx = torch.from_numpy(idx_np).to(dev)
        sub_ev = None if events is None else tuple(e.index_select(0, idx) for e in events)
        sub, m = tick_fn(
            _select(states, idx, idx_np), _select(plan, idx, idx_np), sub_ev,
            _select(knobs, idx, idx_np),
        )
        states = _merge(states, sub, idx, idx_np)
        for k, v in m.items():
            if k not in out_metrics:
                out_metrics[k] = torch.zeros((b,) + tuple(v.shape[1:]), dtype=v.dtype, device=dev)
            out_metrics[k].index_copy_(0, idx, v)
    if not collect:
        out_metrics = {"tick": states.tick}
    return states, out_metrics


# ---------------------------------------------------------- dense engine
def run_ensemble_ticks(params: SimParams, states: SimState, plans, seeds, n_ticks: int,
                       collect: bool = True, knobs: Knobs | None = None):
    """Step B dense universes ``n_ticks`` periods, one batched tick a tick.

    ``states``/``plans``/``knobs`` are stacked (leading axis B); ``seeds``
    is the SHARED ``[N]`` bool seed-slot mask. Returns ``(states, traces)``
    with every trace leaf ``[B, n_ticks, ...]`` (device tensors)."""
    _check_states(states)
    b = ensemble_size(states)
    inputs = _Inputs(plans, b, params.n, states.device, collect)

    def tick(st, plan, events, kn):
        if events is not None:
            st = apply_events_dense(st, *events)
        return ensemble_sim_tick(params, st, plan, seeds, collect=collect, knobs=kn)

    per_tick = []
    for _ in range(n_ticks):
        plan, events = inputs.at(np.asarray(states.t_host) + 1)
        states, metrics = _step(tick, states, plan, events, knobs, collect)
        per_tick.append(metrics)
    if not per_tick:
        return states, {}
    return states, inputs.finish(stack_ticks(per_tick, dim=1))


def run_ensemble_chunked(params: SimParams, states: SimState, plans, seeds, n_ticks: int,
                         chunk: int = 50, collect: bool = True, knobs: Knobs | None = None):
    """Chunked ensemble runner (sim/run.py::run_chunked over B): traces
    concatenate along the TICK axis and trim to ``[B, n_ticks, ...]``
    (numpy); the states advance to the next chunk boundary."""
    if chunk <= 0:
        raise ValueError("chunk must be positive")
    if n_ticks <= 0:
        return states, {}
    pieces = []
    done = 0
    while done < n_ticks:
        states, tr = run_ensemble_ticks(
            params, states, plans, seeds, chunk, collect=collect, knobs=knobs
        )
        take = min(chunk, n_ticks - done)
        pieces.append({k: v.cpu().numpy()[:, :take] for k, v in tr.items()})
        done += take
    return states, {k: np.concatenate([p[k] for p in pieces], axis=1) for k in pieces[0]}


# --------------------------------------------------------- sparse engine
def run_ensemble_sparse_ticks(params: SparseParams, states: SparseState, plans,
                              n_ticks: int, collect: bool = True,
                              knobs: Knobs | None = None):
    """Sparse twin of :func:`run_ensemble_ticks`: B working-set universes.
    Consumes ``states`` (the stacked ``view_T`` and slab are updated in
    place, as the reference donates them)."""
    _check_states(states)
    b = ensemble_size(states)
    inputs = _Inputs(plans, b, params.base.n, states.device, collect)

    def tick(st, plan, events, kn):
        return ensemble_sparse_tick(params, st, plan, collect=collect, events=events, knobs=kn)

    per_tick = []
    for _ in range(n_ticks):
        plan, events = inputs.at(np.asarray(states.t_host) + 1)
        states, metrics = _step(tick, states, plan, events, knobs, collect)
        per_tick.append(metrics)
    if not per_tick:
        return states, {}
    return states, inputs.finish(stack_ticks(per_tick, dim=1))


def ensemble_writeback_free(params: SparseParams, states: SparseState) -> SparseState:
    """Batched host-boundary slot free / write-back (sim/sparse.py::
    writeback_free per universe): one read of the ``[B, S]`` freed-slot
    mask, ``view_T`` updated in place."""
    freeing = _free_plan(params, states)
    slot_subj, subj_slot = write_back(params, states, freeing)
    states = states.replace(slot_subj=slot_subj, subj_slot=subj_slot)
    if states.wb_valid is not None:
        states = states.replace(wb_valid=torch.zeros_like(states.wb_valid))
    return states


def run_ensemble_sparse_chunked(params: SparseParams, states: SparseState, plans,
                                n_ticks: int, chunk: int = 48, collect: bool = True,
                                knobs: Knobs | None = None):
    """Chunked sparse ensemble runner with host-boundary frees between
    chunks (requires ``in_scan_writeback=False``). Traces accumulate on the
    host as ``[B, n_ticks, ...]``."""
    if params.in_scan_writeback:
        raise ValueError("use in_scan_writeback=False with the chunked runner")
    whole, tail = divmod(n_ticks, chunk)
    pieces = []
    for length in [chunk] * whole + ([tail] if tail else []):
        states, tr = run_ensemble_sparse_ticks(
            params, states, plans, length, collect=collect, knobs=knobs
        )
        states = ensemble_writeback_free(params, states)
        if collect:
            pieces.append({k: v.cpu().numpy() for k, v in tr.items()})
    if not pieces:
        return states, {}
    return states, {k: np.concatenate([p[k] for p in pieces], axis=1) for k in pieces[0]}


# ---------------------------------------------------------- convergence
def sparse_convergence_device(state: SparseState) -> torch.Tensor:
    """The dense engine's convergence measure on a sparse state's
    materialised view, as a 0-d device tensor — O(n²), small n only."""
    return _convergence(effective_view(state)[None], state.alive[None], state.epoch[None])[0]


def ensemble_sparse_convergence(states: SparseState) -> torch.Tensor:
    """``[B]`` final convergence across a stacked sparse ensemble, one
    device reduction."""
    s = states.subj_slot
    b, n = states.alive.shape
    cols = torch.clamp_min(s, 0).long()[:, None, :].expand(b, n, n)
    view = torch.where(
        (s >= 0)[:, None, :], torch.gather(states.slab, 2, cols), states.view_T.transpose(1, 2)
    )
    return _convergence(view, states.alive, states.epoch)


def _convergence(view, alive, epoch) -> torch.Tensor:
    n = view.shape[-1]
    status = decode_status(view)
    subj_alive = alive[:, None, :]
    truth_alive = subj_alive & (decode_epoch(view) == epoch[:, None, :])
    ok_alive = truth_alive & (status == _ALIVE)
    ok_dead = ~subj_alive & ((status == _DEAD) | (view < 0))
    eye = torch.eye(n, dtype=torch.bool, device=view.device)
    match = torch.where(subj_alive, ok_alive, ok_dead) | eye
    viewer_conv = xla_row_means_f32(match)
    n_alive = alive.sum(dim=1, dtype=torch.int32)
    return xla_cpu_sum_f32(viewer_conv * alive) / torch.clamp_min(n_alive, 1)
