"""Device half of the causal flight recorder (port of
scalecube_cluster_tpu/obs/tracer.py): a fixed-shape event ring written
inside the tick.

:class:`TraceRing` rides the sparse state as an optional field (``None``
keeps the tick exactly as it is without the recorder). Positions are a
saturating append cursor (not circular, so ``cause`` can reference earlier
events), and every event past the capacity lands in ``overflow``:
emitted == recorded + overflow, the SHARED_COUNTERS discipline.

Two per-subject causal registers thread the chains across ticks:
``last_miss[j]`` (ring position of the latest PROBE_MISSED about j) and
``origin[j]`` (the SUSPECT_START, or the direct epoch-mismatch probe, that
began j's current verdict episode; reset on restart). A viewer's DEAD
verdict stamps ``origin[subject]`` as its ``cause``, so the explainer
(tools/trace_explain.py) can walk verdict → suspicion → missed probe.

The reference compacts each emission with ``flatnonzero(mask, size=cap)``.
Here the compaction has a fixed shape and reads nothing back to the host:
an inclusive ``cumsum`` of the flat mask ranks every event, an event is
recorded iff ``mask & rank <= cap & cursor + rank - 1 < R``, and a stable
partition (recorded events first, in flat index order) gives the first
``cap`` recorded flat indices. Their values land at ring positions
``cursor + k``; the rest of the ``cap`` positions, taken modulo ``R`` so
that all are distinct, are rewritten with the values they hold. ``ev_pos``,
``cursor`` and ``overflow`` equal the reference's bit for bit. Emission
writes the ring's event fields in place: the ring is consumed, as the tick
consumes the state.

The sharded recorder (:class:`ShardTraceRing`) belongs to the
explicit-SPMD engine (parallel/spmd.py): ``d`` rings on a leading shard
axis, each written by its shard with a shard-local cursor; the host merge
(obs/trace.py::merge_shard_rings) rebuilds the one global log.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from scalecube_cluster_tpu_torch.obs.trace import (  # noqa: F401 (re-export)
    TK_ALARM,
    TK_FB_ACCEPT,
    TK_FB_PREPARE,
    TK_GOSSIP_EDGE,
    TK_JOIN_ACK,
    TK_JOIN_CONFIRM,
    TK_JOIN_EV,
    TK_JOIN_REQ,
    TK_KILL,
    TK_PROBE_MISSED,
    TK_PROBE_SENT,
    TK_RESTART,
    TK_SUSPECT_START,
    TK_SYNC_ACCEPT,
    TK_VERDICT_ALIVE,
    TK_VERDICT_DEAD,
    TK_VIEW_COMMIT,
    TK_VOTE,
)

_I32 = torch.int32

#: The event fields, in the order ``cause`` chains and decoders read them.
EVENT_FIELDS = ("ev_kind", "ev_tick", "ev_actor", "ev_subject", "ev_cause", "ev_aux")


@dataclass
class TraceRing:
    """Bounded on-device event log + causal registers (all int32)."""

    ev_kind: torch.Tensor  # [R]
    ev_tick: torch.Tensor  # [R]
    ev_actor: torch.Tensor  # [R] member id, -1 = control plane
    ev_subject: torch.Tensor  # [R] member id / gossip slot
    ev_cause: torch.Tensor  # [R] ring position of the causing event, -1 = root
    ev_aux: torch.Tensor  # [R] kind-specific annotation
    cursor: torch.Tensor  # [] next free position (saturates at R)
    overflow: torch.Tensor  # [] events that did not fit
    last_miss: torch.Tensor  # [N] latest PROBE_MISSED position per subject
    origin: torch.Tensor  # [N] verdict-origin event position per subject

    def replace(self, **changes) -> "TraceRing":
        return dataclasses.replace(self, **changes)

    @property
    def capacity(self) -> int:
        return int(self.ev_kind.shape[0])


#: Every field of :class:`TraceRing`, in declaration order.
RING_FIELDS = tuple(f.name for f in dataclasses.fields(TraceRing))


def init_trace_ring(n: int, capacity: int, device="cuda") -> TraceRing:
    """Empty ring for an ``n``-member cluster. ``capacity`` bounds the whole
    run's event count (positions never recycle); the overflow counter says
    when it was too small."""
    if capacity < 1:
        raise ValueError("trace ring capacity must be >= 1")

    def full(shape, v):
        return torch.full(shape, v, dtype=_I32, device=device)

    return TraceRing(
        ev_kind=full((capacity,), 0),
        ev_tick=full((capacity,), -1),
        ev_actor=full((capacity,), -1),
        ev_subject=full((capacity,), -1),
        ev_cause=full((capacity,), -1),
        ev_aux=full((capacity,), 0),
        cursor=full((), 0),
        overflow=full((), 0),
        last_miss=full((n,), -1),
        origin=full((n,), -1),
    )


#: The single-device engine's refusal of a sharded recorder (the
#: reference's sim/sparse.py check).
SHARDED_RING_ERROR = (
    "single-device sparse_tick cannot carry a ShardTraceRing — the "
    "per-shard recorder belongs to the explicit-SPMD engine "
    "(parallel/spmd.py); init with trace_shards=0 for this engine"
)


@dataclass
class ShardTraceRing:
    """Per-shard flight recorder of the explicit-SPMD engine: ``d``
    independent :class:`TraceRing`\\ s stacked on a leading shard axis
    (a process running ``dl`` of the ``d`` shards holds their ``dl``
    rows). Each shard writes its own row through :func:`shard_local_ring`
    with the single-device emission code; cursors and causes are
    shard-local, so no collective touches the recorder."""

    ev_kind: torch.Tensor  # [d, R]
    ev_tick: torch.Tensor  # [d, R]
    ev_actor: torch.Tensor  # [d, R]
    ev_subject: torch.Tensor  # [d, R]
    ev_cause: torch.Tensor  # [d, R] shard-local ring position, -1 = root
    ev_aux: torch.Tensor  # [d, R]
    cursor: torch.Tensor  # [d] per-shard append cursor
    overflow: torch.Tensor  # [d] per-shard lossless overflow count
    last_miss: torch.Tensor  # [d, N] per-shard causal register
    origin: torch.Tensor  # [d, N] per-shard causal register

    def replace(self, **changes) -> "ShardTraceRing":
        return dataclasses.replace(self, **changes)

    @property
    def capacity(self) -> int:
        return int(self.ev_kind.shape[1])

    @property
    def shards(self) -> int:
        return int(self.ev_kind.shape[0])


def init_shard_trace_rings(n: int, capacity: int, d: int, device="cuda") -> ShardTraceRing:
    """``d`` empty per-shard rings for an ``n``-member cluster. Capacity is
    per shard (``d * capacity`` events in all)."""
    if capacity < 1:
        raise ValueError("trace ring capacity must be >= 1")
    if d < 1:
        raise ValueError("shard trace ring needs d >= 1 shards")

    def full(shape, v):
        return torch.full(shape, v, dtype=_I32, device=device)

    return ShardTraceRing(
        ev_kind=full((d, capacity), 0),
        ev_tick=full((d, capacity), -1),
        ev_actor=full((d, capacity), -1),
        ev_subject=full((d, capacity), -1),
        ev_cause=full((d, capacity), -1),
        ev_aux=full((d, capacity), 0),
        cursor=full((d,), 0),
        overflow=full((d,), 0),
        last_miss=full((d, n), -1),
        origin=full((d, n), -1),
    )


def shard_local_ring(rings: ShardTraceRing, q: int = 0) -> TraceRing:
    """Row ``q`` of a sharded recorder as a plain :class:`TraceRing` whose
    fields are views of the rows: :func:`trace_emit` writes its events in
    place into the stack; the new cursor, overflow and registers go back
    with :func:`shard_rewrap_ring`."""
    return TraceRing(**{name: getattr(rings, name)[q] for name in RING_FIELDS})


def shard_rewrap_ring(rings: ShardTraceRing, local: list) -> ShardTraceRing:
    """The inverse of :func:`shard_local_ring` over every row: ``local``
    holds one ring per row of ``rings``, in order, taken from it with
    :func:`shard_local_ring` and advanced by the emission code. Their
    events are already in ``rings`` (written in place through the views);
    the cursors, overflow counts and registers are stacked again."""
    return rings.replace(**{
        name: torch.stack([getattr(r, name) for r in local])
        for name in ("cursor", "overflow", "last_miss", "origin")
    })


def ring_from_fields(fields, device="cuda") -> TraceRing:
    """A :class:`TraceRing` on ``device`` from any object or dict holding
    the ring's fields (numpy arrays, tensors, or another package's ring),
    each copied."""
    get = fields.get if isinstance(fields, dict) else lambda k: getattr(fields, k)
    out = {}
    for name in RING_FIELDS:
        value = get(name)
        host = np.array(value.cpu() if hasattr(value, "cpu") else value, dtype=np.int32)
        out[name] = torch.from_numpy(host).to(device)
    return TraceRing(**out)


def ring_to_numpy(ring: TraceRing) -> dict:
    """Every field of ``ring`` as a numpy int32 array (copies)."""
    return {name: np.array(getattr(ring, name).cpu(), dtype=np.int32) for name in RING_FIELDS}


def pad_trace_ring(ring: TraceRing, n_new: int) -> TraceRing:
    """Grow the member axis of the causal registers to ``n_new`` rows
    (elastic geometry promotion): the event log, cursor and overflow carry
    verbatim, and the new rows start with empty registers (-1)."""
    n_old = int(ring.last_miss.shape[0])
    if n_new < n_old:
        raise ValueError(f"pad_trace_ring: n_new={n_new} < n_old={n_old}")
    if n_new == n_old:
        return ring

    def grow(x):
        return torch.cat([x, x.new_full((n_new - n_old,), -1)])

    return ring.replace(last_miss=grow(ring.last_miss), origin=grow(ring.origin))


def _gather_broadcast(x, shape, sel: torch.Tensor):
    """``broadcast_to(x, shape).reshape(-1)[sel]`` without materialising
    the broadcast (``x`` a tensor that broadcasts; a Python int is returned
    as it is, a scalar for ``torch.where``)."""
    if isinstance(x, int):
        return x
    x = x.to(_I32)
    if x.dim() == 0:
        return x.expand(sel.shape)
    x = x.reshape((1,) * (len(shape) - x.dim()) + tuple(x.shape))
    if tuple(x.shape) == tuple(shape):
        return x.reshape(-1)[sel]
    lin = torch.zeros_like(sel)
    rem = sel
    stride = 1
    for d in reversed(range(len(shape))):
        coord = rem % shape[d]
        rem = rem // shape[d]
        if x.shape[d] != 1:
            lin = lin + coord * stride
            stride *= x.shape[d]
    return x.contiguous().reshape(-1)[lin]


def trace_emit(ring: TraceRing, kind: int, mask: torch.Tensor, tick, actor, subject,
               cause=-1, aux=0):
    """Append one event per True element of ``mask`` (any shape).

    ``actor``/``subject``/``cause``/``aux`` broadcast against ``mask``.
    Returns ``(ring, ev_pos)`` where ``ev_pos`` (flat ``mask`` shape) maps
    each element to its ring position, -1 where unrecorded (False, past the
    per-call cap ``min(mask.numel(), R)``, or past the ring's capacity —
    the latter two counted into ``overflow``). Order: flat mask index.
    Consumes ``ring`` (its event fields are written in place)."""
    dev = mask.device
    shape = tuple(mask.shape)
    flat = mask.reshape(-1)
    size = flat.numel()
    R = ring.capacity
    cap = min(size, R)
    if size == 0:
        return ring, torch.full((0,), -1, dtype=_I32, device=dev)
    # Event ranks (inclusive) and the reference's recording rule.
    rank = torch.cumsum(flat, 0, dtype=_I32)
    pos = ring.cursor + rank - 1
    rec = flat & (rank <= cap) & (pos < R)
    ev_pos = torch.where(rec, pos, -1)
    total = rank[-1]
    # Stable partition: recorded elements first, each in flat order.
    rrank = torch.cumsum(rec, 0, dtype=_I32)
    recorded = rrank[-1]
    idx = torch.arange(size, dtype=_I32, device=dev)
    dst = torch.where(rec, rrank - 1, recorded + idx - rrank)
    order = torch.empty((size,), dtype=torch.int64, device=dev)
    order.scatter_(0, dst.long(), idx.long())
    sel = order[:cap]
    k = torch.arange(cap, dtype=_I32, device=dev)
    slot = ((ring.cursor + k) % R).long()
    write = k < recorded

    def put(field: torch.Tensor, values) -> None:
        field[slot] = torch.where(write, values, field[slot])

    put(ring.ev_kind, int(kind))
    put(ring.ev_tick, tick if isinstance(tick, int) else tick.to(_I32))
    put(ring.ev_actor, _gather_broadcast(actor, shape, sel))
    put(ring.ev_subject, _gather_broadcast(subject, shape, sel))
    put(ring.ev_cause, _gather_broadcast(cause, shape, sel))
    put(ring.ev_aux, _gather_broadcast(aux, shape, sel))
    ring = ring.replace(
        cursor=torch.clamp_max(ring.cursor + recorded, R),
        overflow=ring.overflow + (total - recorded),
    )
    return ring, ev_pos


def trace_reset_members(ring: TraceRing, member_mask: torch.Tensor) -> TraceRing:
    """Clear the causal registers of restarted members (fresh identity,
    fresh causal history)."""
    return ring.replace(
        last_miss=torch.where(member_mask, -1, ring.last_miss),
        origin=torch.where(member_mask, -1, ring.origin),
    )


def trace_host_event(ring: TraceRing, kind: int, tick, actor: int, subject: int,
                     cause: int = -1, aux: int = 0) -> TraceRing:
    """Single-event append for the host-side control ops (``kill_sparse``,
    ``restart_many_sparse``), with :func:`trace_emit`'s accounting; reads
    nothing back to the host. Consumes ``ring``."""
    R = ring.capacity
    pos = ring.cursor
    rec = pos < R
    slot = torch.clamp_max(pos, R - 1).long().reshape(1)
    for name, value in zip(EVENT_FIELDS, (kind, tick, actor, subject, cause, aux)):
        field = getattr(ring, name)
        field[slot] = torch.where(rec, int(value), field[slot])
    return ring.replace(
        cursor=pos + rec.to(_I32),
        overflow=ring.overflow + (~rec).to(_I32),
    )
