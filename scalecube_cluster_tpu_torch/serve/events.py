"""Fixed-shape per-tick event planes for the serving bridge (port of
scalecube_cluster_tpu/serve/events.py).

:class:`EventBatch` generalizes :class:`~scalecube_cluster_tpu_torch.sim.schedule.FaultSchedule`'s
compact ``(tick, node, kind)`` event encoding to LIVE traffic: a batch
carries a ``[k, C]`` slab of events — row ``r`` holds the (at most ``C``)
events firing at the ``r``-th tick of the launch, unused cells carry node
-1. Its fields are numpy arrays while the batcher packs it on the host and
tensors once :meth:`EventBatch.to` has copied it to the state's device.

:func:`event_masks` resolves rows into the same ``(kill, restart, gossip)``
mask contract :func:`~scalecube_cluster_tpu_torch.sim.schedule.events_at`
produces for schedules, so a replayed batch whose cells match a schedule's
events yields value-identical masks and therefore a bit-identical
trajectory (mask application consumes no RNG). The reference writes each
mask as ``zeros.at[clip(node)].max(fire & (kind == K))``: padding cells
(node -1) clip to row 0 with ``fire`` False, and two cells may name one
row. The port keeps that max-reduction (``scatter_reduce_`` with
``"amax"`` over uint8, then ``> 0``): a plain boolean ``index_put_`` would
let a later padding cell overwrite row 0's True. The mask builders take
one row (``[C]``) or a whole batch (``[k, C]``, giving ``[k, N]`` masks):
the serving runners build a launch's masks at once.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

import numpy as np
import torch

from scalecube_cluster_tpu_torch.sim.schedule import EV_JOIN, EV_KILL, EV_RESTART

#: Serve-level event kind beyond the schedule's kill/restart: enqueue user
#: gossip payload ``arg`` at ``node`` (the in-tick twin of
#: sim/sparse.py::inject_gossip_sparse, applied through the 3-tuple events
#: of sparse_tick). Schedules have no gossip events, so the id lives here.
#: (EV_JOIN = 3 lives in sim/schedule.py and shares this kind space; 2
#: stays reserved for gossip on both sides.)
EV_GOSSIP = 2

_FIELDS = ("node", "kind", "arg", "deferred")


@dataclass
class EventBatch:
    """One launch worth of ingested events, ``k`` ticks × ``C`` event slots.

    ``node[r, c] == -1`` marks an unused cell. ``arg`` is the user-gossip
    payload slot for EV_GOSSIP cells and ignored otherwise.
    ``deferred[r]`` counts events whose target was the ``r``-th tick but
    which the batcher could not fit under capacity ``C`` — they fire later
    (never dropped); the serve runners stamp this count into the tick's
    ``ingest_overflow`` metric (obs/counters.py). All fields are int32,
    numpy arrays on the host or tensors on a device."""

    node: np.ndarray | torch.Tensor  # [k, C], -1 = unused cell
    kind: np.ndarray | torch.Tensor  # [k, C] EV_KILL | EV_RESTART | EV_GOSSIP | EV_JOIN
    arg: np.ndarray | torch.Tensor  # [k, C] gossip payload slot (EV_GOSSIP only)
    deferred: np.ndarray | torch.Tensor  # [k] events deferred past their target tick

    def replace(self, **changes) -> "EventBatch":
        return dataclasses.replace(self, **changes)

    @property
    def n_ticks(self) -> int:
        return self.node.shape[0]

    @property
    def capacity(self) -> int:
        return self.node.shape[1]

    def to(self, device) -> "EventBatch":
        """The batch as int32 tensors on ``device`` (itself when already
        there). On a CUDA device the host arrays are staged in pinned memory
        and copied with ``non_blocking=True`` on the current stream, so the
        host is free while the copy lands; the caching host allocator keeps
        each pinned buffer until its copy has run."""
        device = torch.device(device)
        out = {}
        for name in _FIELDS:
            x = getattr(self, name)
            if isinstance(x, torch.Tensor) and x.device == device:
                out[name] = x
                continue
            host = x if isinstance(x, torch.Tensor) else torch.from_numpy(
                np.ascontiguousarray(x, dtype=np.int32)
            )
            if device.type == "cuda":
                out[name] = host.pin_memory().to(device, non_blocking=True)
            else:
                out[name] = host.to(device)
        return EventBatch(**out)


def empty_batch(n_ticks: int, capacity: int) -> EventBatch:
    """An all-inert batch (host-side numpy; the device copy is the caller's
    pipeline stage — serve/bridge.py stages it beside the previous launch)."""
    return EventBatch(
        node=np.full((n_ticks, capacity), -1, np.int32),
        kind=np.zeros((n_ticks, capacity), np.int32),
        arg=np.zeros((n_ticks, capacity), np.int32),
        deferred=np.zeros((n_ticks,), np.int32),
    )


def stack_batches(batches) -> EventBatch:
    """Stack B same-geometry batches into one ``[B, k, C]`` fleet batch
    (host-side numpy, like :func:`empty_batch`)."""
    batches = list(batches)
    if not batches:
        raise ValueError("stack_batches needs at least one batch")
    geoms = {(b.n_ticks, b.capacity) for b in batches}
    if len(geoms) != 1:
        raise ValueError(f"batches disagree on (k, C) geometry: {sorted(geoms)}")
    return EventBatch(
        **{name: np.stack([np.asarray(getattr(b, name)) for b in batches]) for name in _FIELDS}
    )


def _scatter_max(size: int, rows: torch.Tensor, flags: torch.Tensor) -> torch.Tensor:
    """``[..., size]`` bool: ``zeros.at[rows].max(flags)`` per leading index.
    ``rows`` and ``flags`` are ``[..., C]``; duplicate rows OR together and
    a False flag never clears a True."""
    lead = tuple(rows.shape[:-1])
    count = math.prod(lead)
    base = torch.arange(count, device=rows.device).reshape(lead + (1,)) * size
    out = torch.zeros(count * size, dtype=torch.uint8, device=rows.device)
    out.scatter_reduce_(0, (base + rows).reshape(-1), flags.reshape(-1).to(torch.uint8), "amax")
    return out.reshape(lead + (size,)) > 0


def _fire(node: torch.Tensor, n: int):
    return node >= 0, torch.clamp(node, 0, n - 1).long()


def event_masks(node, kind, arg, n: int, g_slots: int):
    """Resolve batch rows into ``(kill [..., N], restart [..., N], gossip
    [..., N, G])``: the kill/restart scatters are the exact ops of
    sim/schedule.py::events_at (fire-guarded max onto clipped rows), and
    the gossip scatter extends the idiom to the ``[N, G]`` user-gossip
    plane consumed by sim/sparse.py::apply_events_sparse."""
    fire, safe = _fire(node, n)
    kill = _scatter_max(n, safe, fire & (kind == EV_KILL))
    restart = _scatter_max(n, safe, fire & (kind == EV_RESTART))
    slot = torch.clamp(arg, 0, g_slots - 1).long()
    gossip = _scatter_max(n * g_slots, safe * g_slots + slot, fire & (kind == EV_GOSSIP))
    return kill, restart, gossip.reshape(gossip.shape[:-1] + (n, g_slots))


def event_masks_elastic(node, kind, arg, n: int, g_slots: int):
    """Resolve batch rows for the elastic sparse engine: ``(kill, restart,
    gossip, join)``, the four lanes of sparse_tick's 4-tuple events. A join
    cell activates a masked capacity row in the tick; cell-for-cell
    agreement with a schedule's ``(t, node, EV_JOIN)`` events gives the
    same masks and a bit-identical trajectory."""
    kill, restart, gossip = event_masks(node, kind, arg, n, g_slots)
    fire, safe = _fire(node, n)
    join = _scatter_max(n, safe, fire & (kind == EV_JOIN))
    return kill, restart, gossip, join


def event_masks_rapid(node, kind, n: int):
    """Resolve batch rows for the join-aware Rapid engine: ``(kill,
    restart, join)``, the lanes of sim/schedule.py::rapid_events_at (Rapid
    sessions carry no user gossip)."""
    fire, safe = _fire(node, n)
    kill = _scatter_max(n, safe, fire & (kind == EV_KILL))
    restart = _scatter_max(n, safe, fire & (kind == EV_RESTART))
    join = _scatter_max(n, safe, fire & (kind == EV_JOIN))
    return kill, restart, join
