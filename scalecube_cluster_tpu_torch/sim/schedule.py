"""Time-varying fault timelines (port of scalecube_cluster_tpu/sim/schedule.py).

A :class:`FaultSchedule` is a timeline over global tick numbers:

- **piecewise plans** — K segments, segment k active for
  ``starts[k] <= t < starts[k+1]`` (ticks before ``starts[0]`` clamp to
  segment 0); every segment's matrices are broadcast to one side M, so the
  stack is ``[K, M, M]`` (M = 1 for an all-uniform schedule);
- **flapping links** — per segment, the links of ``flap_mask[k]`` are also
  blocked while ``(t - starts[k]) % flap_period[k] < flap_on[k]``;
- **scripted events** — (tick, node, kind) records: kill, restart, join,
  applied at the top of their tick.

The reference resolves the timeline inside its scanned tick with gathers and
a ``lax.cond`` on "any event this tick". The port keeps host mirrors of the
small tables (starts, flap period and phase, the per-segment dirtiness and
delay flags, the event table), so the segment, the flap phase and the
presence of events are decided on the host without a device read:
:func:`plan_at` selects segment k's matrices (views, no copy) and the
runners build event masks and apply events only on ticks whose host table
holds one. Consuming no RNG, a scheduled run equals the same sequence of
fixed-plan runs with the same kill/restart calls between them.

Join events (kind :data:`EV_JOIN`) are built as the reference builds them;
like the reference's fixed-shape engines, the dense and sparse runners here
never fire them (elastic states that consume them are ROADMAP A9).
"""

from __future__ import annotations

import dataclasses
import hashlib
from dataclasses import dataclass

import numpy as np
import torch

from scalecube_cluster_tpu_torch.ops import merge as merge_ops
from scalecube_cluster_tpu_torch.sim.faults import FaultPlan
from scalecube_cluster_tpu_torch.sim.state import AGE_STALE, SimState
from scalecube_cluster_tpu_torch.sim.topology import (
    LinkWorld,
    stack_segment_worlds,
    world_segment,
)

#: Event kinds for ``FaultSchedule.ev_kind``.
EV_KILL = 0
EV_RESTART = 1
#: Protocol-level join (value 3: the serving layer's EV_GOSSIP owns 2).
EV_JOIN = 3

#: The reference's field order, which :meth:`FaultSchedule.digest` hashes.
_DIGEST_FIELDS = (
    "starts", "block", "loss", "mean_delay", "flap_mask", "flap_period",
    "flap_on", "seg_dirty", "flap_any", "ev_tick", "ev_node", "ev_kind",
    "link_world",
)


@dataclass
class _Host:
    """Host mirrors of a schedule's small tables."""

    starts: np.ndarray
    flap_period: np.ndarray
    flap_on: np.ndarray
    seg_dirty: np.ndarray
    flap_any: np.ndarray
    delay_free: np.ndarray  # [K] no link delay and no zone latency
    ev_tick: np.ndarray
    ev_node: np.ndarray
    ev_kind: np.ndarray

    def segment(self, t: int) -> int:
        k = int(np.searchsorted(self.starts, t, side="right")) - 1
        return min(max(k, 0), len(self.starts) - 1)

    def flap_active(self, k: int, t: int) -> bool:
        period = int(self.flap_period[k])
        return period > 0 and (t - int(self.starts[k])) % period < int(self.flap_on[k])


@dataclass
class FaultSchedule:
    """A piecewise fault timeline over global tick numbers (tensors on one
    device), built by :class:`ScheduleBuilder`. The runners in sim/run.py
    and sim/sparse.py accept it wherever they accept a :class:`FaultPlan`."""

    starts: torch.Tensor  # [K] int32 segment start ticks, increasing
    block: torch.Tensor  # [K, M, M] bool
    loss: torch.Tensor  # [K, M, M] float32
    mean_delay: torch.Tensor  # [K, M, M] float32
    flap_mask: torch.Tensor  # [K, M, M] bool links riding the square wave
    flap_period: torch.Tensor  # [K] int32, 0 = no flapping
    flap_on: torch.Tensor  # [K] int32 blocked-phase length in ticks
    seg_dirty: torch.Tensor  # [K] bool: block/loss/delay/world faults present
    flap_any: torch.Tensor  # [K] bool: flap_mask non-empty
    ev_tick: torch.Tensor  # [E] int32 global tick (-1 = unused slot)
    ev_node: torch.Tensor  # [E] int32 member index
    ev_kind: torch.Tensor  # [E] int32 EV_KILL | EV_RESTART | EV_JOIN
    link_world: LinkWorld | None = None  # zone [N], matrices [K, Z, Z]

    def replace(self, **changes) -> "FaultSchedule":
        return dataclasses.replace(self, **changes)

    @property
    def n_segments(self) -> int:
        return self.starts.shape[0]

    def digest(self) -> str:
        """The reference's 12-hex content hash: field name, shape and bytes
        of every field in its order, None fields skipped, the LinkWorld
        field by field."""
        h = hashlib.sha1()

        def update(name: str, value) -> None:
            if value is None:
                return
            if dataclasses.is_dataclass(value):
                for f in dataclasses.fields(value):
                    update(f"{name}.{f.name}", getattr(value, f.name))
                return
            arr = value.cpu().numpy()
            h.update(name.encode())
            h.update(str(arr.shape).encode())
            h.update(np.ascontiguousarray(arr).tobytes())

        for name in _DIGEST_FIELDS:
            update(name, getattr(self, name))
        return h.hexdigest()[:12]


def _host(schedule: FaultSchedule) -> _Host:
    """The schedule's host mirrors, read from the device once and cached."""
    host = schedule.__dict__.get("_host_mirror")
    if host is None:
        k = schedule.n_segments
        delay = (schedule.mean_delay != 0).reshape(k, -1).any(dim=1)
        if schedule.link_world is not None:
            delay = delay | (schedule.link_world.latency != 0).reshape(k, -1).any(dim=1)

        def np_(t):
            return t.cpu().numpy()

        host = _Host(
            starts=np_(schedule.starts), flap_period=np_(schedule.flap_period),
            flap_on=np_(schedule.flap_on), seg_dirty=np_(schedule.seg_dirty),
            flap_any=np_(schedule.flap_any), delay_free=~np_(delay),
            ev_tick=np_(schedule.ev_tick), ev_node=np_(schedule.ev_node),
            ev_kind=np_(schedule.ev_kind),
        )
        schedule.__dict__["_host_mirror"] = host
    return host


def segment_at(schedule: FaultSchedule, t: int) -> int:
    """Index of the segment active at global tick ``t`` (clamped)."""
    return _host(schedule).segment(int(t))


def plan_at(schedule: FaultSchedule, t: int) -> FaultPlan:
    """The :class:`FaultPlan` in force at global tick ``t``: segment k's
    matrices, plus the flap overlay while its wave is in the ON phase."""
    t = int(t)
    host = _host(schedule)
    k = host.segment(t)
    block = schedule.block[k]
    if host.flap_any[k] and host.flap_active(k, t):
        block = block | schedule.flap_mask[k]
    return FaultPlan(
        block=block,
        loss=schedule.loss[k],
        mean_delay=schedule.mean_delay[k],
        link_world=world_segment(schedule.link_world, k),
        delay_free=bool(host.delay_free[k]),
    )


def plan_dirty_at(schedule: FaultSchedule, t: int) -> bool:
    """Could any link fault fire at tick ``t``? (the per-segment flags, the
    flap flag gated on its ON phase)."""
    t = int(t)
    host = _host(schedule)
    k = host.segment(t)
    return bool(host.seg_dirty[k] or (host.flap_any[k] and host.flap_active(k, t)))


def _event_masks(schedule: FaultSchedule, t: int, n: int, kinds) -> list[np.ndarray]:
    return host_event_masks(_host(schedule), t, n, kinds)


def host_event_masks(host: _Host, t: int, n: int, kinds) -> list[np.ndarray]:
    """``[N]`` numpy masks, one per event kind in ``kinds``, of the events
    a schedule's host mirror fires at tick ``t``."""
    fire = host.ev_tick == t
    node = np.clip(host.ev_node, 0, n - 1)
    out = []
    for kind in kinds:
        mask = np.zeros((n,), bool)
        np.logical_or.at(mask, node, fire & (host.ev_kind == kind))
        out.append(mask)
    return out


def host_events_at(schedule: FaultSchedule, t: int, n: int, joins: bool = False):
    """``(kill, restart)`` numpy masks of tick ``t`` (``(kill, restart,
    join)`` with ``joins``), or None when the host table holds none of
    those events at ``t`` (the runners' cheap check)."""
    host = _host(schedule)
    kinds = (EV_KILL, EV_RESTART, EV_JOIN) if joins else (EV_KILL, EV_RESTART)
    fire = (host.ev_tick == int(t)) & np.isin(host.ev_kind, kinds)
    if not fire.any():
        return None
    return tuple(_event_masks(schedule, int(t), n, kinds))


def events_at(schedule: FaultSchedule, t: int, n: int):
    """``(kill_mask, restart_mask)`` — bool [N] tensors of the events firing
    at tick ``t`` (unused slots carry tick -1 and never fire; joins are not
    fired here)."""
    kill, restart = _event_masks(schedule, int(t), n, (EV_KILL, EV_RESTART))
    dev = schedule.ev_tick.device
    return torch.from_numpy(kill).to(dev), torch.from_numpy(restart).to(dev)


def rapid_events_at(schedule: FaultSchedule, t: int, n: int):
    """``(kill_mask, restart_mask, join_mask)`` — :func:`events_at` plus
    the EV_JOIN lane (the elastic sparse runners and the join-aware
    engines)."""
    masks = _event_masks(schedule, int(t), n, (EV_KILL, EV_RESTART, EV_JOIN))
    dev = schedule.ev_tick.device
    return tuple(torch.from_numpy(m).to(dev) for m in masks)


def scheduled_kill_ticks(schedule: FaultSchedule) -> dict[int, list[int]]:
    """Host-side ``{member: [kill ticks, ascending]}`` from the event table."""
    host = _host(schedule)
    out: dict[int, list[int]] = {}
    for t, node, kind in zip(host.ev_tick, host.ev_node, host.ev_kind):
        if t >= 0 and kind == EV_KILL:
            out.setdefault(int(node), []).append(int(t))
    for v in out.values():
        v.sort()
    return out


def resolve_tick(schedule: FaultSchedule, t: int, n: int):
    """``(plan_t, (kill_mask, restart_mask))`` — what a tick consumes at
    global tick ``t``."""
    return plan_at(schedule, t), events_at(schedule, t, n)


def apply_events_dense(state: SimState, kill_mask, restart_mask) -> SimState:
    """Scheduled kill/restart on the dense state (the vectorised twin of
    ``sim.state.kill``/``restart``), applied before the tick. The epoch bump
    clamps at EPOCH_MAX (the builder rejects schedules that would reach
    it). Consumes no RNG. An ensemble's stacked state takes ``[B, N]``
    masks (sim/ensemble.py)."""
    n = state.view.shape[-1]
    dev = state.device
    col = torch.arange(n, device=dev)
    diag = col[:, None] == col[None, :]
    new_epoch = torch.where(
        restart_mask, torch.clamp_max(state.epoch + 1, merge_ops.EPOCH_MAX), state.epoch
    )
    zeros_n = torch.zeros_like(new_epoch)
    self_keys = merge_ops.encode_key(zeros_n, zeros_n, new_epoch)
    fresh_view = torch.where(diag, self_keys[..., None], merge_ops.UNKNOWN_KEY)
    fresh_age = torch.where(diag, 0, AGE_STALE).to(state.rumor_age.dtype)
    row = restart_mask[..., None]
    uinf = torch.where(restart_mask[..., None, None], False, state.uinf)
    if state.uinf.shape[-2] == n:
        uinf = torch.where(restart_mask[..., None, :, None], False, uinf)
    return state.replace(
        alive=(state.alive & ~kill_mask) | restart_mask,
        epoch=new_epoch,
        inc_self=torch.where(restart_mask, 0, state.inc_self),
        view=torch.where(row, fresh_view, state.view),
        rumor_age=torch.where(row, fresh_age, state.rumor_age),
        suspect_left=torch.where(row, torch.zeros_like(state.suspect_left), state.suspect_left),
        rows=torch.where(row, fresh_view, state.rows),
        known_cnt=torch.where(restart_mask, 0, state.known_cnt),
        useen=torch.where(restart_mask[..., None], False, state.useen),
        uinf=uinf,
        uflight=torch.where(restart_mask[..., None, None], False, state.uflight),
    )


def _host_array(x, dtype) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.cpu().numpy()
    return np.asarray(x, dtype)


class ScheduleBuilder:
    """Host-side assembly of a :class:`FaultSchedule`::

        sched = (
            ScheduleBuilder(n)
            .add_segment(1, FaultPlan.clean(n).partition(a, b))
            .add_segment(500, FaultPlan.clean(n))
            .kill(200, 7)
            .restart(350, 7)
            .build()
        )

    Segments may mix compact ``[1, 1]`` and dense ``[n, n]`` plans; the
    builder broadcasts all to the largest side present. The schedule lives
    on the device of the first segment's plan."""

    def __init__(self, n: int):
        self.n = int(n)
        self._segments: list = []
        self._events: list[tuple[int, int, int]] = []

    def add_segment(
        self,
        start_tick: int,
        plan: FaultPlan,
        *,
        flap_mask=None,
        flap_period: int = 0,
        flap_on: int = 0,
        link_world: LinkWorld | None = None,
    ) -> "ScheduleBuilder":
        """Arm ``plan`` from global tick ``start_tick`` until the next
        segment; optionally block the links of ``flap_mask`` ([n, n] or
        [1, 1] bool) for the first ``flap_on`` ticks of every
        ``flap_period``-tick window, and arm a zone overlay (``link_world``
        here or on ``plan``, not both)."""
        if flap_period < 0 or flap_on < 0 or flap_on > flap_period:
            raise ValueError(
                f"need 0 <= flap_on <= flap_period, got {flap_on}/{flap_period}"
            )
        if (flap_period > 0) != (flap_mask is not None):
            raise ValueError("flap_mask and flap_period come together")
        if link_world is not None and plan.link_world is not None:
            raise ValueError(
                "pass the segment's LinkWorld either on the plan or as the "
                "link_world kwarg, not both"
            )
        world = link_world if link_world is not None else plan.link_world
        mask = None if flap_mask is None else _host_array(flap_mask, bool)
        self._segments.append(
            (int(start_tick), plan, mask, int(flap_period), int(flap_on), world)
        )
        return self

    def kill(self, tick: int, node: int) -> "ScheduleBuilder":
        """Hard-stop process ``node`` at the top of global tick ``tick``."""
        self._events.append((int(tick), int(node), EV_KILL))
        return self

    def restart(self, tick: int, node: int) -> "ScheduleBuilder":
        """Restart ``node`` as a fresh identity (epoch bump) at ``tick``."""
        self._events.append((int(tick), int(node), EV_RESTART))
        return self

    def join(self, tick: int, node: int) -> "ScheduleBuilder":
        """Cold-start ``node`` as a joining singleton at ``tick`` (spends
        the EPOCH_MAX budget like a restart). Only join-aware paths fire
        it; the fixed-shape runners here skip it, as the reference's do."""
        self._events.append((int(tick), int(node), EV_JOIN))
        return self

    def build(self, *, epoch0=0) -> FaultSchedule:
        """Validate and freeze. ``epoch0`` (scalar or [n]) is the starting
        epoch of the state the schedule will run against, for the static
        EPOCH_MAX restart budget."""
        if not self._segments:
            raise ValueError("a schedule needs at least one segment")
        segs = sorted(self._segments, key=lambda s: s[0])
        starts = [s[0] for s in segs]
        if len(set(starts)) != len(starts):
            raise ValueError(f"duplicate segment start ticks: {starts}")

        sides = {1}
        for _, plan, mask, _, _, _ in segs:
            for m in (plan.block, plan.loss, plan.mean_delay):
                if m.shape[0] not in (1, self.n) or m.shape[0] != m.shape[1]:
                    raise ValueError(
                        f"plan matrix side {tuple(m.shape)} is neither [1,1] nor"
                        f" [{self.n},{self.n}]"
                    )
                sides.add(int(m.shape[0]))
            if mask is not None and mask.shape not in ((1, 1), (self.n, self.n)):
                raise ValueError(f"flap_mask shape {mask.shape} invalid")
        m_side = max(sides)
        dev = segs[0][1].block.device

        def stack(mats, dtype):
            return torch.stack(
                [m.to(device=dev, dtype=dtype).expand(m_side, m_side) for m in mats]
            ).contiguous()

        block = stack([s[1].block for s in segs], torch.bool)
        loss = stack([s[1].loss for s in segs], torch.float32)
        delay = stack([s[1].mean_delay for s in segs], torch.float32)
        flap_np = [
            np.zeros((1, 1), bool) if s[2] is None else s[2] for s in segs
        ]
        flap = stack([torch.from_numpy(m.copy()) for m in flap_np], torch.bool)
        worlds = [s[5] for s in segs]
        stacked_world = stack_segment_worlds(worlds, self.n)
        k = len(segs)
        dirty = (
            block.reshape(k, -1).any(dim=1)
            | (loss > 0).reshape(k, -1).any(dim=1)
            | (delay > 0).reshape(k, -1).any(dim=1)
        ).cpu().numpy()
        world_dirty = np.array(
            [w is not None and bool(w.any_faults()) for w in worlds], bool
        )
        seg_dirty = dirty | world_dirty
        flap_any = np.array([bool(m.any()) for m in flap_np], bool)

        by_tick_node: dict[tuple[int, int], set[int]] = {}
        restarts_per_node: dict[int, int] = {}
        for tick, node, kind in self._events:
            if tick < 1:
                raise ValueError(f"event tick {tick} precedes the first tick")
            if not 0 <= node < self.n:
                raise ValueError(f"event node {node} outside [0, {self.n})")
            kinds = by_tick_node.setdefault((tick, node), set())
            if kind in kinds:
                kind_name = {EV_KILL: "kill", EV_RESTART: "restart"}.get(kind, "join")
                raise ValueError(
                    f"node {node} has duplicate {kind_name} events at tick {tick}"
                )
            kinds.add(kind)
            if kind in (EV_RESTART, EV_JOIN):
                restarts_per_node[node] = restarts_per_node.get(node, 0) + 1
        # A kill and a restart on the same (tick, node) is a bounce: the
        # restart wins, ``alive = (alive & ~kill) | restart``.
        e0 = np.broadcast_to(np.asarray(epoch0, np.int32), (self.n,))
        for node, count in restarts_per_node.items():
            if int(e0[node]) + count > merge_ops.EPOCH_MAX:
                raise ValueError(
                    f"node {node}: {count} scheduled restarts exhaust the"
                    f" {merge_ops.EPOCH_MAX}-epoch budget (start epoch"
                    f" {int(e0[node])})"
                )

        events = sorted(self._events)
        n_ev = max(1, len(events))  # at least one (inert) slot
        ev_tick = np.full((n_ev,), -1, np.int32)
        ev_node = np.zeros((n_ev,), np.int32)
        ev_kind = np.zeros((n_ev,), np.int32)
        for i, (tick, node, kind) in enumerate(events):
            ev_tick[i], ev_node[i], ev_kind[i] = tick, node, kind

        def i32(a):
            return torch.as_tensor(np.asarray(a, np.int32)).to(dev)

        return FaultSchedule(
            starts=i32(starts),
            block=block,
            loss=loss,
            mean_delay=delay,
            flap_mask=flap,
            flap_period=i32([s[3] for s in segs]),
            flap_on=i32([s[4] for s in segs]),
            seg_dirty=torch.from_numpy(seg_dirty).to(dev),
            flap_any=torch.from_numpy(flap_any).to(dev),
            ev_tick=i32(ev_tick),
            ev_node=i32(ev_node),
            ev_kind=i32(ev_kind),
            link_world=stacked_world,
        )
