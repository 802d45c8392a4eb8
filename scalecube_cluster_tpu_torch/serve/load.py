"""Seeded multi-producer load harness: chaos at the wire for the bridge
(port of scalecube_cluster_tpu/serve/load.py).

The sim plane got its adversarial certifier in the FaultSchedule/chaos work;
this is the serving plane's — N concurrent TCP producers (honest and
adversarial, mixed) drive one live :class:`~scalecube_cluster_tpu_torch.serve.ServeBridge`
session through a real loopback transport, with arrival bursts, connection
churn (disconnect/redial mid-stream) and seeded randomness, then the session
is audited against the conservation invariant (serve/ingest.py)::

    pushed_total == served + len(pending) + shed_total
    rejected     == injected malformed events that reached the pump

Producer profiles (``PROFILES``):

- ``honest`` — well-formed kill/restart/gossip events at wire rate. Under
  the ``defer`` overflow policy these producers BLOCK in their own
  ``drain()`` when the server pauses reads (TCP flow control end to end).
- ``reject`` — valid frames, valid JSON ``Message``s, hostile serve
  semantics: unknown kinds, out-of-range nodes/slots, non-object payloads.
  Every one reaches the pump and must be counted (``ingest_rejected``),
  never served and never fatal.
- ``malformed`` — well-framed but undecodable payloads (broken JSON). The
  transport counts them (``decode_failures``) and drops the connection;
  the producer redials and keeps going.
- ``oversized`` — a frame header over ``max_frame_length`` (stream poisoned
  and closed, ``frames_oversized``), then ONE valid event per fresh redial
  — proving a poisoned stream doesn't poison the session.
- ``garbage`` — raw random bytes, no framing at all.
- ``slowloris`` — two bytes of frame header, then silence. With
  ``accept_idle_timeout_ms`` set the server must evict the connection
  (``accept_idle_timeouts``) instead of pinning a handler until stop().

Every profile keeps its hostility on its OWN connections, so the blast
radius of a poisoned stream is that stream — exactly the property the
harness certifies for the server side.

:func:`run_load` returns the audit dict and emits one schema-versioned
``kind="load"`` row (obs/export.py) with throughput, SLO percentiles and
the full wire/ingest accounting; ``bench.py --load`` is the benchmark rung.
:func:`run_fleet_load` is its multi-tenant twin against one live
:class:`~scalecube_cluster_tpu_torch.serve.fleet.FleetBridge`, audited per
victim tenant.
The session runs on ``device`` (the card unless the caller asks for the
CPU), through the fused sparse core where ``pallas_core`` and the width
allow it.
"""

from __future__ import annotations

import asyncio
import random
import time
from dataclasses import dataclass, field

from scalecube_cluster_tpu_torch.cluster_api.config import TransportConfig
from scalecube_cluster_tpu_torch.native import load_framing
from scalecube_cluster_tpu_torch.obs.export import make_row, run_metadata
from scalecube_cluster_tpu_torch.serve.bridge import ServeBridge
from scalecube_cluster_tpu_torch.serve.ingest import SERVE_QUALIFIER
from scalecube_cluster_tpu_torch.sim.sparse import SparseParams, init_sparse_full_view
from scalecube_cluster_tpu_torch.transport.codec import DEFAULT_CODEC
from scalecube_cluster_tpu_torch.transport.message import Message
from scalecube_cluster_tpu_torch.transport.tcp import TcpTransport

#: Producer behavior profiles (module docstring). Order matters: adversarial
#: producers are assigned round-robin over PROFILES[1:].
PROFILES = ("honest", "reject", "malformed", "oversized", "garbage", "slowloris")

#: Wire-vocabulary kinds an honest producer draws from.
_HONEST_KINDS = ("kill", "leave", "restart", "join", "gossip")


@dataclass
class ProducerStats:
    """Per-producer ground truth the audit reconciles against."""

    profile: str
    sent_valid: int = 0  # well-formed events written (reach the batcher)
    sent_reject: int = 0  # pump-level malformed events written (counted)
    sent_wire_bad: int = 0  # transport-level hostile writes (never decode)
    reconnects: int = 0  # churn + post-poison redials
    errors: list = field(default_factory=list)

    @property
    def expect_pump(self) -> int:
        """Events this producer expects to ARRIVE at the pump."""
        return self.sent_valid + self.sent_reject


def _honest_event(
    rng: random.Random, n: int, g_slots: int, tenant: int | None = None
) -> dict:
    kind = rng.choice(_HONEST_KINDS)
    obj: dict = {"kind": kind, "node": rng.randrange(n)}
    if kind == "gossip":
        obj["slot"] = rng.randrange(g_slots)
    if tenant is not None:
        obj["tenant"] = tenant
    return obj


def _reject_event(rng: random.Random, n: int, g_slots: int):
    """A payload that decodes fine but MUST be refused by the batcher."""
    return rng.choice(
        [
            {"kind": "flood", "node": 0},  # unknown kind
            {"kind": "kill", "node": n + rng.randrange(1, 9)},  # node range
            {"kind": "gossip", "node": 0, "slot": g_slots + 3},  # slot range
            {"kind": "kill"},  # missing node
            ["not", "an", "object"],  # non-object data
        ]
    )


def _frame(obj, encode, max_frame: int) -> bytes:
    msg = Message.create(qualifier=SERVE_QUALIFIER, data=obj)
    return encode(DEFAULT_CODEC.serialize(msg), max_frame)


async def _producer(
    host: str,
    port: int,
    stats: ProducerStats,
    rng: random.Random,
    *,
    n: int,
    g_slots: int,
    n_events: int,
    burst: int,
    churn_every: int,
    max_frame: int,
    idle_timeout_s: float,
    tenant: int | None = None,
) -> ProducerStats:
    """One producer task. Never raises: failures land in ``stats.errors``
    (the certification demands zero unhandled exceptions, so every failure
    must be an accounted observation, not a crash)."""
    encode, _, _ = load_framing()
    writer = None

    async def connect():
        nonlocal writer
        if writer is not None:
            with_suppress_close(writer)
            stats.reconnects += 1
        _, writer = await asyncio.open_connection(host, port)

    def with_suppress_close(w):
        try:
            w.close()
        except Exception:
            pass

    try:
        await connect()
        if stats.profile == "slowloris":
            # Two header bytes, then silence: the idle deadline must evict
            # us — we hold the socket open well past it and return.
            writer.write(b"\x00\x00")
            await writer.drain()
            stats.sent_wire_bad += 1
            await asyncio.sleep(idle_timeout_s * 2.5 if idle_timeout_s else 0.2)
            return stats
        since_churn = 0
        for i in range(n_events):
            if stats.profile == "honest":
                writer.write(
                    _frame(
                        _honest_event(rng, n, g_slots, tenant), encode, max_frame
                    )
                )
                stats.sent_valid += 1
            elif stats.profile == "reject":
                obj = _reject_event(rng, n, g_slots)
                if tenant is not None and isinstance(obj, dict):
                    # The hostile tenant's semantic garbage stays ITS
                    # garbage — tagged, so a cross-tenant audit can prove
                    # the rejects never cost another tenant anything.
                    obj["tenant"] = tenant
                writer.write(_frame(obj, encode, max_frame))
                stats.sent_reject += 1
            elif stats.profile == "malformed":
                # Well-framed, undecodable: the server counts a decode
                # failure and drops THIS connection — redial and continue.
                # The server may close while we still hold the socket, so
                # the drain itself can fail: that's the expected outcome of
                # hostility, not a harness error.
                try:
                    writer.write(
                        encode(b"{not json" + bytes([rng.randrange(256)]), max_frame)
                    )
                    stats.sent_wire_bad += 1
                    await writer.drain()
                except (ConnectionError, OSError):
                    pass
                await connect()
            elif stats.profile == "oversized":
                # Poison the stream with an over-limit header, then prove a
                # FRESH connection serves fine: one valid event per cycle.
                try:
                    writer.write((max_frame + 64).to_bytes(4, "big") + b"\xff" * 32)
                    stats.sent_wire_bad += 1
                    await writer.drain()
                except (ConnectionError, OSError):
                    pass
                await connect()
                writer.write(
                    _frame(
                        _honest_event(rng, n, g_slots, tenant), encode, max_frame
                    )
                )
                stats.sent_valid += 1
            elif stats.profile == "garbage":
                try:
                    writer.write(
                        bytes(rng.randrange(256) for _ in range(rng.randrange(1, 64)))
                    )
                    stats.sent_wire_bad += 1
                    await writer.drain()
                except (ConnectionError, OSError):
                    pass
                await connect()
            since_churn += 1
            if (i + 1) % burst == 0:
                # Flush the burst; under defer-policy backpressure this
                # drain() is where the producer BLOCKS (closed TCP window).
                await writer.drain()
                await asyncio.sleep(0)
            if churn_every and since_churn >= churn_every:
                # Mid-stream churn: drop the connection (frames already
                # drained) and redial — the server must treat the fresh
                # connection as first-class.
                await writer.drain()
                since_churn = 0
                await connect()
        await writer.drain()
    except Exception as exc:  # noqa: BLE001 — audit, never crash the harness
        stats.errors.append(f"{type(exc).__name__}: {exc}")
    finally:
        if writer is not None:
            with_suppress_close(writer)
    return stats


def _assign_profiles(producers: int, adversarial: int) -> list[str]:
    """Mixed population: ``adversarial`` of ``producers`` rotate over the
    hostile profiles, the rest are honest."""
    hostile = PROFILES[1:]
    out = ["honest"] * producers
    for j in range(min(adversarial, producers)):
        out[producers - 1 - j] = hostile[j % len(hostile)]
    return out


async def run_load(
    *,
    n: int = 32,
    slot_budget: int = 64,
    producers: int = 32,
    adversarial: int = 8,
    events_per_producer: int = 400,
    batch_ticks: int = 8,
    capacity: int = 64,
    max_pending: int = 4096,
    low_watermark: int | None = None,
    overflow_policy: str = "defer",
    burst: int = 32,
    churn_every: int = 0,
    seed: int = 0,
    accept_idle_timeout_ms: int = 1_000,
    max_accepted_connections: int = 0,
    settle_s: float = 0.002,
    deadline_s: float = 300.0,
    export_path: str | None = None,
    collect: bool = True,
    pallas_core: bool = False,
    device="cuda",
) -> dict:
    """Drive one live serving session with a seeded producer fleet; audit it.

    Returns the audit dict: the ``kind="load"`` row under ``"row"``, the
    session's ``kind="serve"`` summary under ``"serve_row"``, per-producer
    ground truth under ``"producer_stats"``, and the certification verdicts
    (``conservation_ok``, ``rejected_ok``, ``bounded_ok``, ``errors``).

    ``deadline_s`` bounds the whole run: a harness that cannot converge
    (a wedged producer, a lost wakeup) stops launching and FAILS the audit
    via the reconciliation counts instead of hanging the suite.
    """
    params = SparseParams.for_n(n, slot_budget=slot_budget, pallas_core=pallas_core)
    state = init_sparse_full_view(n, slot_budget, seed=seed, device=device)
    bridge = ServeBridge(
        params,
        state,
        batch_ticks=batch_ticks,
        capacity=capacity,
        max_pending=max_pending,
        low_watermark=low_watermark,
        overflow_policy=overflow_policy,
        collect=collect,
        export_path=export_path,
    )
    cfg = TransportConfig(
        connect_timeout=2_000,
        accept_idle_timeout_ms=accept_idle_timeout_ms,
        max_accepted_connections=max_accepted_connections,
    )
    server = await TcpTransport.bind(cfg)
    g_slots = bridge.batcher.g_slots
    profiles = _assign_profiles(producers, adversarial)
    stats = [ProducerStats(profile=p) for p in profiles]
    rngs = [random.Random((seed << 20) ^ (i * 0x9E3779B1)) for i in range(producers)]

    # Warm-up launch BEFORE traffic: the first launch pays the one-time
    # kernel build and load, which would otherwise block the event loop long
    # enough for the accept-idle deadline to evict honest producers.
    bridge.step_batch()

    t0 = time.monotonic()
    fleet_done = asyncio.Event()

    def stop_when() -> bool:
        if time.monotonic() - t0 > deadline_s:
            return True
        if not fleet_done.is_set():
            return False
        # Fleet finished writing: keep launching until every frame that
        # made the wire reached the pump and the queue fully drained.
        expected = sum(s.expect_pump for s in stats)
        arrived = bridge.batcher.pushed_total + bridge.ingest_rejected
        return arrived >= expected and len(bridge.batcher) == 0

    async def fleet():
        try:
            await asyncio.gather(
                *(
                    _producer(
                        server.address.host,
                        server.address.port,
                        stats[i],
                        rngs[i],
                        n=n,
                        g_slots=g_slots,
                        n_events=events_per_producer,
                        burst=burst,
                        churn_every=churn_every,
                        max_frame=cfg.max_frame_length,
                        idle_timeout_s=accept_idle_timeout_ms / 1000.0,
                    )
                    for i in range(producers)
                )
            )
        finally:
            fleet_done.set()

    fleet_task = asyncio.ensure_future(fleet())
    try:
        await bridge.run_live(
            server, settle_s=settle_s, stop_when=stop_when
        )
        # A wedged producer must fail the audit, not hang the suite.
        try:
            await asyncio.wait_for(asyncio.shield(fleet_task), timeout=30.0)
        except asyncio.TimeoutError:
            pass
    finally:
        if not fleet_task.done():
            fleet_task.cancel()
            try:
                await fleet_task
            except asyncio.CancelledError:
                pass
        await server.stop()
    wall_s = time.monotonic() - t0

    # -- the audit: reconcile session accounting against producer truth ----
    b = bridge.batcher
    served = bridge.events_served
    pending = len(b)
    injected_malformed = sum(s.sent_reject for s in stats)
    rejected = bridge.ingest_rejected
    errors = [e for s in stats for e in s.errors]
    conservation_ok = b.pushed_total == served + pending + b.shed_total
    rejected_ok = rejected == injected_malformed
    bounded_ok = (not b.max_pending) or b.peak_pending <= b.max_pending
    serve_row = bridge.close()

    # The transport counts pause_reading() TRANSITIONS; the batcher counts
    # full->wait cycles. Both matter, so the wire dict's key is renamed
    # before the spread — otherwise it would shadow the batcher's count.
    wire = server.wire_stats()
    wire["transport_pauses"] = wire.pop("backpressure_pauses")

    payload = {
        "producers": producers,
        "adversarial": adversarial,
        "profiles": {p: profiles.count(p) for p in PROFILES if p in profiles},
        "events_sent_valid": sum(s.sent_valid for s in stats),
        "events_injected_malformed": injected_malformed,
        "wire_bad_writes": sum(s.sent_wire_bad for s in stats),
        "reconnects": sum(s.reconnects for s in stats),
        "pushed": b.pushed_total,
        "served": served,
        "pending": pending,
        "shed": b.shed_total,
        "rejected": rejected,
        "backpressure_pauses": b.backpressure_total,
        "peak_pending": b.peak_pending,
        "max_pending": b.max_pending,
        "overflow_policy": b.overflow_policy,
        "ingest_overflow": b.overflow_total,
        "batches": bridge.serve_batches,
        "wall_s": wall_s,
        "events_per_sec": served / max(wall_s, 1e-9),
        "latency_ms_p50": serve_row["latency_ms_p50"],
        "latency_ms_p95": serve_row["latency_ms_p95"],
        "latency_ms_p99": serve_row["latency_ms_p99"],
        "conservation_ok": conservation_ok,
        "rejected_ok": rejected_ok,
        "bounded_ok": bounded_ok,
        "producer_errors": len(errors),
        "seed": seed,
        **wire,
    }
    row = make_row(
        "load", payload, run_metadata(n=n, slot_budget=slot_budget)
    )
    if export_path:
        from scalecube_cluster_tpu_torch.obs.export import append_jsonl

        append_jsonl(export_path, [row])
    return {
        "row": row,
        "serve_row": serve_row,
        "producer_stats": stats,
        "conservation_ok": conservation_ok,
        "rejected_ok": rejected_ok,
        "bounded_ok": bounded_ok,
        "errors": errors,
        "bridge": bridge,
        "wire": server.wire_stats(),
    }


async def run_fleet_load(
    *,
    n: int = 32,
    slot_budget: int = 64,
    tenants: int = 4,
    hostile_tenants: int = 1,
    hostile_producers: int = 5,
    events_per_producer: int = 200,
    fleet_size: int | None = None,
    batch_ticks: int = 8,
    capacity: int = 32,
    max_pending: int = 2048,
    overflow_policy: str = "defer",
    burst: int = 32,
    seed: int = 0,
    accept_idle_timeout_ms: int = 1_000,
    settle_s: float = 0.002,
    deadline_s: float = 300.0,
    export_path: str | None = None,
    pallas_core: bool = False,
    device="cuda",
) -> dict:
    """Multi-tenant producer fleet against ONE live FleetBridge session.

    Every tenant gets its own honest producer stream (tenant-tagged wire
    events); the last ``hostile_tenants`` tenants ALSO run a rotation of
    the adversarial profiles (reject / malformed / oversized / garbage /
    slowloris, ``hostile_producers`` connections each) — the cross-tenant
    blast-radius experiment. The audit certifies, per VICTIM (fully honest)
    tenant:

    - conservation: every tenant-tagged event acked into its batcher is
      served or still pending — ``pushed == served + pending + shed`` with
      ``shed == 0`` under the defer policy;
    - zero collateral backpressure: a victim's producers are never paused
      for a hostile tenant's queue (per-tenant ``backpressure_total == 0``
      as long as the victim's own rate fits its bound);
    - a live SLO row: the victim's ``fleet_tenant`` percentiles exist and
      its events all reached verdicts;

    plus the fleet ledger ``requested == placed + pending + deferred +
    evicted`` (asserted at every launch boundary during the run, snapshot
    returned). The fleet runs on ``device`` (the card unless the caller
    asks for the CPU), through the fused sparse core where ``pallas_core``
    and the width allow it.
    """
    from scalecube_cluster_tpu_torch.serve.fleet import FleetBridge

    params = SparseParams.for_n(n, slot_budget=slot_budget, pallas_core=pallas_core)
    fleet = FleetBridge(
        params,
        engine="sparse",
        fleet_size=tenants if fleet_size is None else fleet_size,
        batch_ticks=batch_ticks,
        capacity=capacity,
        max_pending=max_pending,
        overflow_policy=overflow_policy,
        export_path=export_path,
        device=device,
    )
    cfg = TransportConfig(
        connect_timeout=2_000,
        accept_idle_timeout_ms=accept_idle_timeout_ms,
    )
    server = await TcpTransport.bind(cfg)
    g_slots = fleet.base_pool.g_slots

    hostile_ids = set(range(tenants - hostile_tenants, tenants))
    hostile_rotation = PROFILES[1:]
    jobs: list[tuple[str, int]] = [("honest", t) for t in range(tenants)]
    for t in sorted(hostile_ids):
        for j in range(hostile_producers):
            jobs.append((hostile_rotation[j % len(hostile_rotation)], t))
    stats = [ProducerStats(profile=p) for p, _ in jobs]
    rngs = [
        random.Random((seed << 20) ^ (i * 0x9E3779B1)) for i in range(len(jobs))
    ]

    # Warm-up launch BEFORE traffic (the one-time kernel build; see run_load).
    fleet.step_fleet()

    t0 = time.monotonic()
    producers_done = asyncio.Event()

    def stop_when() -> bool:
        if time.monotonic() - t0 > deadline_s:
            return True
        if not producers_done.is_set():
            return False
        expected = sum(s.expect_pump for s in stats)
        arrived = (
            sum(s.batcher.pushed_total for s in fleet.tenants.values())
            + fleet.ingest_rejected
        )
        return arrived >= expected and len(fleet.router) == 0

    async def producer_fleet():
        try:
            await asyncio.gather(
                *(
                    _producer(
                        server.address.host,
                        server.address.port,
                        stats[i],
                        rngs[i],
                        n=n,
                        g_slots=g_slots,
                        n_events=events_per_producer,
                        burst=burst,
                        churn_every=0,
                        max_frame=cfg.max_frame_length,
                        idle_timeout_s=accept_idle_timeout_ms / 1000.0,
                        tenant=jobs[i][1],
                    )
                    for i in range(len(jobs))
                )
            )
        finally:
            producers_done.set()

    fleet_task = asyncio.ensure_future(producer_fleet())
    try:
        await fleet.run_live(server, settle_s=settle_s, stop_when=stop_when)
        try:
            await asyncio.wait_for(asyncio.shield(fleet_task), timeout=30.0)
        except asyncio.TimeoutError:
            pass
    finally:
        if not fleet_task.done():
            fleet_task.cancel()
            try:
                await fleet_task
            except asyncio.CancelledError:
                pass
        await server.stop()
    wall_s = time.monotonic() - t0

    # -- per-tenant audit ---------------------------------------------------
    ledger = fleet.assert_fleet_conservation()
    sent_by_tenant: dict[int, int] = {}
    for (profile, t), s in zip(jobs, stats):
        sent_by_tenant[t] = sent_by_tenant.get(t, 0) + s.sent_valid
    tenant_audits: dict[int, dict] = {}
    victims_clean = True
    for t in range(tenants):
        session = fleet.tenants.get(t)
        if session is None:
            # A tenant whose every frame was lost to wire hostility never
            # got admitted — only possible for hostile tenants.
            tenant_audits[t] = {"admitted": False, "hostile": t in hostile_ids}
            if t not in hostile_ids:
                victims_clean = False
            continue
        b = session.batcher
        conservation_ok = b.pushed_total == session.events_served + len(b) + b.shed_total
        audit = {
            "admitted": True,
            "hostile": t in hostile_ids,
            "sent_valid": sent_by_tenant.get(t, 0),
            "pushed": b.pushed_total,
            "served": session.events_served,
            "pending": len(b),
            "shed": b.shed_total,
            "backpressure_pauses": b.backpressure_total,
            "conservation_ok": conservation_ok,
        }
        tenant_audits[t] = audit
        if t not in hostile_ids:
            if not conservation_ok or b.shed_total or len(b):
                victims_clean = False
    errors = [e for s in stats for e in s.errors]
    summary = fleet.close()
    payload = {
        "tenants": tenants,
        "hostile_tenants": hostile_tenants,
        "producers": len(jobs),
        "events_sent_valid": sum(s.sent_valid for s in stats),
        "events_injected_malformed": sum(s.sent_reject for s in stats),
        "wire_bad_writes": sum(s.sent_wire_bad for s in stats),
        "rejected": fleet.ingest_rejected,
        "served": fleet.events_served,
        "launches": fleet.fleet_launches,
        "ledger": ledger,
        "victims_clean": victims_clean,
        "producer_errors": len(errors),
        "wall_s": wall_s,
        "seed": seed,
    }
    row = make_row(
        "fleet_load", payload, run_metadata(n=n, slot_budget=slot_budget)
    )
    if export_path:
        from scalecube_cluster_tpu_torch.obs.export import append_jsonl

        append_jsonl(export_path, [row])
    return {
        "row": row,
        "fleet_row": summary,
        "tenant_audits": tenant_audits,
        "ledger": ledger,
        "victims_clean": victims_clean,
        "errors": errors,
        "fleet": fleet,
    }
