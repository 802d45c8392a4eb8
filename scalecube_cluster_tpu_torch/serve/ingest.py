"""Event ingestion for the serving bridge: trace replay, live TCP, batching.

Trace JSONL format (one event per line, blank lines and ``#`` comments
skipped)::

    {"tick": 17, "kind": "kill", "node": 5}
    {"tick": 20, "kind": "join", "node": 5}
    {"kind": "gossip", "node": 3, "slot": 1}

- ``kind`` — one of ``kill``, ``leave``, ``restart``, ``join``, ``gossip``.
  ``leave`` aliases to a kill (a crash-stop is how the serving plane models
  an abrupt leave). ``join`` parses to the protocol-level EV_JOIN kind
  (sim/schedule.py): for RAPID sessions (``EventBatcher(engine="rapid")``)
  it fires the real seed-routed join handshake — request → seed ack with a
  view digest → confirm certificate counted in the next view change
  (sim/rapid.py §4) — giving live ``join`` traffic real admission
  semantics. For SWIM sessions the routing depends on the session's shape:

  - **Elastic sessions** (capacity-tiered state, ``live_mask`` attached;
    the bridge wires an ``admit`` callback and ``legacy_join=False``):
    a ``join`` is wire-rate ADMISSION — the batcher asks the bridge's
    allocator for an unused capacity row, rewrites ``node`` to it, and the
    elastic engine activates the row in-scan (serve/engine.py::
    run_serve_batch_elastic). ``node`` may be omitted (or -1): "assign me
    an identity" — the normal elastic wire form. When every capacity row
    is taken the join is parked in ``deferred_joins`` — deferred to the
    next geometry promotion, never dropped — under the conservation
    contract ``joins_requested == joins_admitted + len(deferred_joins)``
    (:meth:`EventBatcher.join_ledger`).
  - **Fixed-shape sessions** (``legacy_join=True``, the default): SWIM has
    no join protocol, so the batcher normalizes EV_JOIN to EV_RESTART at
    push — the historical alias (a join is a fresh identity at a bumped
    epoch, exactly what an in-scan restart applies), byte-for-byte
    compatible with pre-join traces. TRACE-FORMAT NOTE: elastic sessions
    therefore change what a recorded ``join`` line replays to — real
    admission (a TK_JOIN_EV on an assigned row) instead of a restart of
    the named node; replaying a pre-elastic trace bit-exactly requires a
    fixed-shape session (or ``legacy_join=True`` explicitly).
- ``node`` — member index in ``[0, n)``; optional (or -1) for elastic
  ``join`` events, where admission assigns the row.
- ``tick`` — optional GLOBAL tick (1-based, the schedule convention) the
  event should fire at; omitted means "as soon as possible" (the earliest
  tick of the next batch with free capacity). Events whose tick already
  passed also fire ASAP — deferred, never dropped.
- ``slot`` — user-gossip payload slot in ``[0, G)``; ``gossip`` only.
- ``tenant`` — optional tenant id (int >= 0) for MULTI-TENANT fleet
  sessions (serve/fleet.py): the event targets that tenant's universe of
  the fleet, routed by :class:`~scalecube_cluster_tpu_torch.serve.fleet.TenantRouter`.
  Omitted means tenant 0, so every pre-fleet trace and wire producer is
  byte-compatible — a solo session IS the one-tenant fleet. Single-session
  batchers ignore the field (their bridge owns exactly one state).

The same JSON objects ride live TCP sessions as ``Message.data`` under
qualifier ``serve/event`` (transport/tcp.py length-framed frames), so a
recorded trace and a live client are interchangeable producers.

:class:`EventBatcher` packs pending events into fixed-shape
:class:`~scalecube_cluster_tpu_torch.serve.events.EventBatch` tensors. Capacity
overflow is LOSSLESS: an event that does not fit its target tick's ``C``
slots slides to the next tick with room (or the next batch), FIFO-stable,
and each such slide increments the target tick's ``deferred`` counter —
surfaced as the ``ingest_overflow`` counter (obs/counters.py).

Queue-depth overflow (a live session whose producers outrun the device) is
a SEPARATE, bounded axis: ``max_pending`` caps the pending deque and the
``overflow_policy`` chooses the trade when the cap is hit —

- ``"defer"`` (default, lossless): a full batcher REFUSES new pushes
  (:class:`BatcherFull`); the live pump propagates the refusal to producers
  as TCP flow control (:class:`TcpEventSource` pauses the transport's
  socket reads until the queue drains to ``low_watermark``), so memory is
  bounded and no accepted event is ever dropped.
- ``"shed-oldest"`` (bounded-latency): a full batcher drops its OLDEST
  pending event to admit the new one, counting ``shed_total`` — freshness
  wins over completeness, explicitly.

Either way the conservation invariant holds at every batch boundary::

    pushed_total == served + len(pending) + shed_total

— every event acked into the batcher is served, still pending, or
explicitly counted as shed; never silently lost (tests/test_load.py).
"""

from __future__ import annotations

import asyncio
import json
import logging
import time
from collections import deque
from dataclasses import dataclass

from scalecube_cluster_tpu_torch.serve.events import (
    EV_GOSSIP,
    EV_JOIN,
    EV_KILL,
    EV_RESTART,
    EventBatch,
    empty_batch,
)
from scalecube_cluster_tpu_torch.transport.message import Message

logger = logging.getLogger(__name__)

#: Message qualifier live serve traffic rides under (transport.listen()
#: multicasts everything; the source filters on this).
SERVE_QUALIFIER = "serve/event"

#: Wire vocabulary -> device event kind. ``leave`` aliases to a kill;
#: ``join`` is the protocol-level EV_JOIN — routed to the Rapid join
#: handshake by rapid sessions, normalized to the restart alias at push by
#: SWIM sessions (module docstring).
KIND_ALIASES = {
    "kill": EV_KILL,
    "leave": EV_KILL,
    "restart": EV_RESTART,
    "join": EV_JOIN,
    "gossip": EV_GOSSIP,
}

#: Engine flavors a batcher can feed (the serve session's protocol plane).
BATCHER_ENGINES = ("swim", "rapid")


@dataclass
class ServeEvent:
    """One ingested event, normalized to device kinds.

    ``t_ingest`` is the host monotonic clock at ingestion — the start of the
    SLO ingest→verdict window (obs/latency.py::percentile_summary rows).
    """

    kind: int
    node: int
    arg: int = 0
    tick: int | None = None
    t_ingest: float | None = None
    #: Flight-recorder position of this join's TK_JOIN_REQ host event,
    #: stamped by the elastic bridge at first admission attempt so a join
    #: that parks for a promotion keeps its request → ack cause link.
    req_pos: int | None = None
    #: Tenant id for fleet sessions (module docstring); 0 — the wire
    #: default — keeps solo sessions and pre-fleet traces byte-compatible.
    tenant: int = 0


def event_from_obj(obj: dict) -> ServeEvent:
    """Normalize one wire/trace JSON object (format: module docstring)."""
    if not isinstance(obj, dict):
        raise ValueError(f"serve event must be a JSON object, got {type(obj).__name__}")
    kind_name = obj.get("kind")
    if kind_name not in KIND_ALIASES:
        raise ValueError(
            f"unknown serve event kind {kind_name!r}; valid: {sorted(KIND_ALIASES)}"
        )
    kind = KIND_ALIASES[kind_name]
    if "node" not in obj:
        if kind != EV_JOIN:
            raise ValueError("serve event missing 'node'")
        node = -1  # elastic wire form: admission assigns a capacity row
    else:
        node = int(obj["node"])
    tick = obj.get("tick")
    tenant = int(obj.get("tenant", 0))
    if tenant < 0:
        raise ValueError(f"serve event tenant {tenant} must be >= 0")
    return ServeEvent(
        kind=kind,
        node=node,
        arg=int(obj.get("slot", 0)) if kind == EV_GOSSIP else 0,
        tick=None if tick is None else int(tick),
        tenant=tenant,
    )


def parse_trace_line(line: str) -> ServeEvent | None:
    """One trace line -> event; None for blank/comment lines."""
    stripped = line.strip()
    if not stripped or stripped.startswith("#"):
        return None
    return event_from_obj(json.loads(stripped))


def load_trace(path: str) -> list[ServeEvent]:
    """Load a whole JSONL trace file, in file order (replay determinism)."""
    events = []
    with open(path) as fh:
        for lineno, line in enumerate(fh, 1):
            try:
                ev = parse_trace_line(line)
            except ValueError as exc:
                raise ValueError(f"{path}:{lineno}: {exc}") from exc
            if ev is not None:
                events.append(ev)
    return events


def event_from_message(msg: Message) -> ServeEvent:
    """Normalize a live transport message's payload."""
    return event_from_obj(msg.data)


class BatcherFull(RuntimeError):
    """``push()`` on a full batcher under the lossless ``defer`` policy.

    The caller owns the event and must retry after the queue drains — the
    live pump turns this refusal into TCP flow control (pause the socket
    reads, :meth:`EventBatcher.wait_room`), a sync caller sees the error.
    The event was NOT enqueued and NOT counted.
    """


#: Queue-full trades an operator can choose (module docstring).
OVERFLOW_POLICIES = ("defer", "shed-oldest")


class EventBatcher:
    """Packs pending events into fixed-shape per-tick tensors, losslessly.

    ``next_batch(base_tick)`` covers global ticks ``base_tick + 1 ..
    base_tick + n_ticks``. Placement is FIFO-stable: each pending event
    targets its requested tick's row (ASAP events and past-due ticks target
    the first row), slides forward to the first row with free capacity if
    the target is full — counting one deferral at the TARGET row, the tick
    whose budget the host outran — and carries into a later batch when the
    whole launch is full. Events are never dropped; when capacity is
    adequate the packing reproduces a FaultSchedule's placement exactly
    (the bit-parity precondition, tests/test_serve.py).

    ``max_pending`` bounds the pending deque (0 = unbounded); at the cap,
    ``overflow_policy`` picks the trade (module docstring): ``defer``
    refuses the push (:class:`BatcherFull`, backpressure), ``shed-oldest``
    drops the oldest pending event and counts it. ``low_watermark`` is the
    drain level at which a paused producer resumes (hysteresis — resuming
    at the cap itself would thrash pause/resume per event).

    ``engine`` names the session's protocol plane: ``"swim"`` (default)
    normalizes EV_JOIN to the restart alias at push and accepts gossip;
    ``"rapid"`` keeps EV_JOIN intact (the real join handshake consumes it)
    and REJECTS gossip events (Rapid carries no user-gossip plane — a
    gossip cell would be silently inert in the tick, so it is refused at
    validation like any other out-of-contract payload).

    ``legacy_join`` / ``admit`` select the elastic admission plane (module
    docstring): with an ``admit`` allocator wired, EV_JOIN requests a
    capacity row at push — assigned rows ride the queue as normal events,
    exhausted capacity parks the join in ``deferred_joins`` until
    :meth:`replay_deferred_joins` (after a geometry promotion). With
    ``legacy_join=False`` and no allocator, EV_JOIN rides intact with its
    explicit node (scheduled-style elastic activation). The default —
    ``legacy_join=True``, no allocator — is byte-compatible with every
    pre-elastic session.
    """

    def __init__(
        self,
        n: int,
        g_slots: int,
        n_ticks: int,
        capacity: int,
        *,
        max_pending: int = 0,
        low_watermark: int | None = None,
        overflow_policy: str = "defer",
        engine: str = "swim",
        legacy_join: bool = True,
        admit=None,
    ):
        if n_ticks < 1 or capacity < 1:
            raise ValueError("need n_ticks >= 1 and capacity >= 1")
        if overflow_policy not in OVERFLOW_POLICIES:
            raise ValueError(
                f"unknown overflow_policy {overflow_policy!r}; "
                f"valid: {OVERFLOW_POLICIES}"
            )
        if engine not in BATCHER_ENGINES:
            raise ValueError(
                f"unknown engine {engine!r}; valid: {BATCHER_ENGINES}"
            )
        self.n = int(n)
        self.g_slots = int(g_slots)
        self.n_ticks = int(n_ticks)
        self.capacity = int(capacity)
        self.max_pending = int(max_pending)
        if low_watermark is None:
            low_watermark = self.max_pending // 2
        self.low_watermark = int(low_watermark)
        if self.max_pending and not 0 <= self.low_watermark < self.max_pending:
            raise ValueError(
                f"low_watermark {self.low_watermark} outside "
                f"[0, max_pending={self.max_pending})"
            )
        self.overflow_policy = overflow_policy
        self.engine = engine
        #: ``True`` (default) keeps the historical SWIM join->restart alias;
        #: ``False`` lets EV_JOIN ride to the device intact (elastic
        #: sessions — the bridge resolves this from the state's shape).
        self.legacy_join = bool(legacy_join)
        #: Elastic admission allocator: ``admit(ev) -> row | None`` assigns
        #: an unused capacity row (None = capacity exhausted, park the join
        #: until promotion). Wired by serve/bridge.py on elastic sessions.
        self.admit = admit
        #: Joins parked for the next geometry promotion — deferred, never
        #: dropped (:meth:`replay_deferred_joins` re-runs admission).
        self.deferred_joins: deque[ServeEvent] = deque()
        #: Admission ledger (host accounting; join_ledger() snapshots it).
        self.joins_requested = 0
        self.joins_admitted = 0
        self.joins_placed = 0  # admitted joins that reached a batch row
        self.joins_shed = 0  # admitted joins lost to shed-oldest (counted)
        self._pending: deque[ServeEvent] = deque()
        #: Session totals (host accounting; the bridge stamps them into rows).
        self.pushed_total = 0
        self.overflow_total = 0
        self.shed_total = 0
        #: Backpressure pause EPISODES (each full->wait->resume cycle of a
        #: producer, counted by the party that paused — TcpEventSource).
        self.backpressure_total = 0
        #: High-water mark of the pending deque — the certification witness
        #: that the queue never exceeded ``max_pending`` (tests/test_load.py).
        self.peak_pending = 0
        # One-shot waiter armed by wait_room(), fired by next_batch() when
        # the queue drains to the low watermark.
        self._room: asyncio.Event | None = None

    def __len__(self) -> int:
        return len(self._pending)

    @property
    def is_full(self) -> bool:
        return bool(self.max_pending) and len(self._pending) >= self.max_pending

    def validate(self, ev: ServeEvent) -> None:
        """Raise ``ValueError`` unless ``ev`` is in-range for this session.

        Split out of :meth:`push` so the live pump can REJECT a hostile
        event (out-of-range node/slot, unknown kind) before deciding to
        backpressure-pause for it — a malformed flood must cost accounting,
        never queue room or a pause cycle.
        """
        if not 0 <= ev.node < self.n:
            if not (ev.kind == EV_JOIN and ev.node == -1 and self.admit is not None):
                raise ValueError(f"event node {ev.node} outside [0, {self.n})")
        if ev.kind == EV_GOSSIP and not 0 <= ev.arg < self.g_slots:
            raise ValueError(
                f"gossip slot {ev.arg} outside [0, {self.g_slots})"
            )
        if ev.kind == EV_GOSSIP and self.engine == "rapid":
            # Rapid carries no user-gossip plane — a gossip cell would be
            # silently inert in rapid_tick, so refuse it like any other
            # out-of-contract payload instead of eating queue room.
            raise ValueError("gossip events are not valid on a rapid session")
        if ev.kind not in (EV_KILL, EV_RESTART, EV_GOSSIP, EV_JOIN):
            raise ValueError(f"unknown event kind {ev.kind}")

    def push(self, ev: ServeEvent, stamp: bool = True) -> None:
        """Validate and enqueue; stamps ``t_ingest`` if the source didn't.

        ``stamp=False`` leaves an unset ``t_ingest`` unset — trace replay
        uses it so per-batch SLO windows open at batch assembly instead of
        measuring how long a pre-loaded trace sat in the queue.

        At ``max_pending`` the overflow policy decides: ``defer`` raises
        :class:`BatcherFull` (nothing enqueued or counted), ``shed-oldest``
        drops the oldest pending event (counted in ``shed_total``) to admit
        this one.
        """
        self.validate(ev)
        if self.is_full:
            # Fullness resolves BEFORE admission: a defer-policy refusal must
            # leave no trace (no ledger count, no allocated row to leak) so
            # the caller's retry is idempotent. A join that would merely be
            # parked (allocator full) pays the same backpressure — refusing
            # early is conservative and keeps this path single-outcome.
            if self.overflow_policy == "shed-oldest":
                victim = self._pending.popleft()
                self.shed_total += 1
                if victim.kind == EV_JOIN:
                    self.joins_shed += 1
            else:
                raise BatcherFull(
                    f"{len(self._pending)} events pending >= "
                    f"max_pending={self.max_pending} (policy=defer)"
                )
        if ev.kind == EV_JOIN:
            if self.admit is not None:
                # Wire-rate admission (elastic sessions): ask the bridge's
                # allocator for an unused capacity row. Counted BEFORE the
                # outcome so the ledger is total: every request is admitted
                # (rides the queue as a normal event from here) or parked
                # for the next promotion — never dropped.
                self.joins_requested += 1
                row = self.admit(ev)
                if row is None:
                    self.deferred_joins.append(ev)
                    return
                ev.node = int(row)
                self.joins_admitted += 1
            elif self.engine == "swim" and self.legacy_join:
                # Historical alias: fixed-shape SWIM has no join protocol, so
                # a join lands as the restart event it always was — pre-join
                # replay traces stay byte-compatible
                # (tests/test_serve.py::test_trace_format_parsing).
                ev.kind = EV_RESTART
            # else: EV_JOIN rides intact with its explicit node — the Rapid
            # handshake, or a scheduled-style elastic activation.
        if stamp and ev.t_ingest is None:
            ev.t_ingest = time.monotonic()
        self._pending.append(ev)
        self.pushed_total += 1
        if len(self._pending) > self.peak_pending:
            self.peak_pending = len(self._pending)

    def join_ledger(self) -> dict:
        """Snapshot of the admission conservation ledger.

        Invariant (checked by :meth:`assert_join_conservation`, asserted at
        every batch boundary by the elastic bridge)::

            requested == placed + pending + deferred + shed

        — every join request has been served to the device, is admitted and
        riding the queue, is parked for the next geometry promotion, or was
        explicitly counted out by the shed-oldest policy; never silently
        lost. The batcher's ``pushed == served + pending + shed`` contract
        covers admitted joins like any other event; this ledger extends it
        upstream of admission.
        """
        pending_joins = sum(1 for e in self._pending if e.kind == EV_JOIN)
        return {
            "requested": self.joins_requested,
            "admitted": self.joins_admitted,
            "placed": self.joins_placed,
            "pending": pending_joins,
            "deferred": len(self.deferred_joins),
            "shed": self.joins_shed,
        }

    def assert_join_conservation(self) -> dict:
        """Raise ``AssertionError`` unless the admission ledger is exact;
        returns the :meth:`join_ledger` snapshot on success."""
        led = self.join_ledger()
        total = led["placed"] + led["pending"] + led["deferred"] + led["shed"]
        assert led["requested"] == total, (
            f"join conservation violated: requested={led['requested']} != "
            f"placed+pending+deferred+shed={total} ({led})"
        )
        assert led["admitted"] == led["placed"] + led["pending"] + led["shed"], led
        return led

    def replay_deferred_joins(self) -> int:
        """Re-run admission for parked joins (call after a geometry
        promotion opened capacity). Returns how many were admitted; joins
        the allocator still cannot place stay parked, FIFO order preserved.
        """
        parked, self.deferred_joins = self.deferred_joins, deque()
        admitted = 0
        while parked:
            ev = parked.popleft()
            # Un-count, then re-push through the full admission path so the
            # ledger sees one request per join regardless of replay count.
            self.joins_requested -= 1
            before = self.joins_admitted
            try:
                self.push(ev, stamp=False)
            except BatcherFull:
                # Queue backpressure mid-replay: restore the request count
                # and park everything untried — the next replay retries.
                self.joins_requested += 1
                parked.appendleft(ev)
                self.deferred_joins.extend(parked)
                break
            admitted += self.joins_admitted - before
        return admitted

    async def wait_room(self) -> None:
        """Block until the queue drains to ``low_watermark`` (no-op when
        unbounded). The defer-policy pump parks here with the transport's
        socket reads paused; :meth:`next_batch` fires the waiter."""
        while self.max_pending and len(self._pending) > self.low_watermark:
            self._room = asyncio.Event()
            await self._room.wait()

    def next_batch(self, base_tick: int) -> tuple[EventBatch, dict]:
        """Assemble the batch for ticks ``base_tick + 1 .. base_tick + k``.

        Returns host-side (numpy) tensors plus stats:
        ``n_events`` placed, ``n_deferred`` deferral increments this call,
        ``oldest_ingest`` — the earliest ``t_ingest`` among placed events
        (None when the batch is empty), the SLO window start.
        """
        k, cap = self.n_ticks, self.capacity
        batch = empty_batch(k, cap)
        fill = [0] * k
        keep: deque[ServeEvent] = deque()
        placed = 0
        oldest: float | None = None
        while self._pending:
            ev = self._pending.popleft()
            if ev.tick is not None and ev.tick > base_tick + k:
                keep.append(ev)  # scheduled for a future batch: not overflow
                continue
            target = 0 if ev.tick is None else max(ev.tick - base_tick - 1, 0)
            row = target
            while row < k and fill[row] >= cap:
                row += 1
            if row >= k:
                # The whole launch is full from the target on: defer to the
                # next batch, firing ASAP there (FIFO order preserved).
                batch.deferred[min(target, k - 1)] += 1
                ev.tick = None
                keep.append(ev)
                continue
            if row != target:
                batch.deferred[target] += 1
            batch.node[row, fill[row]] = ev.node
            batch.kind[row, fill[row]] = ev.kind
            batch.arg[row, fill[row]] = ev.arg
            fill[row] += 1
            placed += 1
            if ev.kind == EV_JOIN:
                self.joins_placed += 1
            if ev.t_ingest is not None:
                oldest = ev.t_ingest if oldest is None else min(oldest, ev.t_ingest)
        self._pending = keep
        if self._room is not None and (
            not self.max_pending or len(self._pending) <= self.low_watermark
        ):
            self._room.set()
            self._room = None
        n_deferred = int(batch.deferred.sum())
        self.overflow_total += n_deferred
        return batch, {
            "n_events": placed,
            "n_deferred": n_deferred,
            "oldest_ingest": oldest,
        }


class TcpEventSource:
    """Live ingestion: pump ``serve/event`` messages off a bound transport's
    inbound stream into a batcher.

    The stream terminates when the transport stops — with the listener's
    graceful drain (transport/tcp.py::stop), frames a client wrote before
    the shutdown are still dispatched, so :meth:`pump` returns only after
    the in-flight traffic reached the batcher.

    Backpressure (defer policy): when the batcher is full the pump PAUSES
    the transport's socket reads (transport/tcp.py::pause_reading) and
    parks in :meth:`EventBatcher.wait_room` until a launch drains the queue
    to the low watermark. Paused reads stop emptying the kernel socket
    buffers, the TCP receive windows close, and producers block in their
    own ``write()``/``drain()`` — flow control end to end, with nothing
    accepted ever dropped. Under ``shed-oldest`` the batcher itself sheds,
    so the pump never pauses and producers keep wire rate.
    """

    def __init__(self, transport):
        self._transport = transport
        self.rejected = 0  # malformed payloads (logged, never fatal)
        self.backpressure_pauses = 0  # full->pause->resume cycles taken

    async def pump(self, batcher: EventBatcher) -> None:
        stream = self._transport.listen()
        pause = getattr(self._transport, "pause_reading", None)
        resume = getattr(self._transport, "resume_reading", None)
        try:
            async for msg in stream:
                if msg.qualifier != SERVE_QUALIFIER:
                    continue
                try:
                    ev = event_from_message(msg)
                    batcher.validate(ev)
                except (ValueError, TypeError):
                    # Accounting (self.rejected -> ingest_rejected rows) is
                    # the record; per-event logs at warning would let an
                    # adversarial flood spam the operator's console.
                    self.rejected += 1
                    logger.debug("rejected malformed serve event: %s", msg)
                    continue
                if batcher.is_full and batcher.overflow_policy == "defer":
                    self.backpressure_pauses += 1
                    batcher.backpressure_total += 1
                    if pause is not None:
                        pause()
                    try:
                        await batcher.wait_room()
                    finally:
                        if resume is not None:
                            resume()
                # No await between wait_room() and push: nothing can refill
                # the queue in between, so this push cannot raise BatcherFull.
                batcher.push(ev)
        except asyncio.CancelledError:
            pass
        finally:
            stream.close()
