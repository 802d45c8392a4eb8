"""Fleet control plane: multi-tenant twins multiplexed onto the universe axis
(port of scalecube_cluster_tpu/serve/fleet.py).

One card, many tenant clusters: the ensemble machinery (sim/ensemble.py)
steps B independent universes through one batched tick a tick, and the
serving bridge (serve/bridge.py) turns live traffic into fixed-shape
launches. This module multiplies them — a :class:`FleetBridge` owns one
:class:`FleetPool` per pinned ``(engine, n, B, k, C)`` geometry, routes
per-tenant event streams (the ``tenant`` field of the trace/wire format,
serve/ingest.py) into per-universe
:class:`~scalecube_cluster_tpu_torch.serve.events.EventBatch` planes through a
:class:`TenantRouter`, and steps every tenant of a pool together through the
fleet entries (serve/engine.py::run_fleet_serve_batch and friends),
double-buffered like the solo bridge. On the sparse kernel route a tick of a
pool is ONE csrc/sparse_core.cu launch for all its tenants (the kernel's
``grid.z``).

Isolation invariant (tests/test_torch_fleet.py): a tenant's state
trajectory in the fleet is bit-identical to the same trace replayed in a
solo session — universe ``b`` of a batched tick is the solo tick on
universe ``b``'s operands (sim/ensemble_tick.py), per-tenant batchers never
mix queues, and per-universe event planes never alias rows. A hostile
neighbour can cost a tenant wall-clock only, never a bit of state.

Admission is deferred-never-dropped under the fleet conservation ledger::

    requested == placed + pending + deferred + evicted

— every tenant that ever asked for a slot is serving (placed), mid-
migration (pending — zero at every launch boundary, where the ledger is
asserted), parked for capacity with its traffic buffering losslessly
(deferred), or explicitly evicted; never silently lost. The adaptive
control loop retunes the launch geometry ``(k, C)`` from the observed
arrival rate (states carry over untouched), and a tenant that outgrows its
``n`` is promoted through the checkpoint path (save_sparse_checkpoint
``pack_cold=True`` → promote_sparse_state → a larger-``n`` pool created on
demand) without dropping its ticks or its neighbours'.

The launch machinery is the solo bridge's: the stacked batch is staged in
pinned host memory and copied with ``non_blocking=True``
(serve/events.py::EventBatch.to), and a launch's verdicts are awaited on one
CUDA event recorded after its last tick, then its traces read once — where
the reference calls ``jax.device_get`` and ``block_until_ready``. Elastic
placement reads the slot's ``live_mask`` once per admission; nothing reads
the device per tick or per tenant.
"""

from __future__ import annotations

import asyncio
import dataclasses
import io
import time
from collections import OrderedDict

import numpy as np
import torch

from scalecube_cluster_tpu_torch.obs.export import append_jsonl, make_row, run_metadata
from scalecube_cluster_tpu_torch.obs.slo import RollingSLOTracker
from scalecube_cluster_tpu_torch.serve.events import empty_batch, stack_batches
from scalecube_cluster_tpu_torch.serve.ingest import EventBatcher, ServeEvent, TcpEventSource
from scalecube_cluster_tpu_torch.serve.spec import EngineSpec, resolve_engine_spec
from scalecube_cluster_tpu_torch.sim.checkpoint import (
    load_sparse_checkpoint,
    promote_sparse_state,
    save_sparse_checkpoint,
)
from scalecube_cluster_tpu_torch.sim.ensemble import _stack_built, index_universe, set_universe
from scalecube_cluster_tpu_torch.sim.faults import FaultPlan


def _on_device(record, device):
    """``record`` with every tensor leaf on ``device`` (nested records too)."""
    fields = {}
    for f in dataclasses.fields(record):
        v = getattr(record, f.name)
        if isinstance(v, torch.Tensor):
            v = v.to(device)
        elif dataclasses.is_dataclass(v) and not isinstance(v, type):
            v = _on_device(v, device)
        fields[f.name] = v
    return type(record)(**fields)


class TenantSession:
    """Host-side bookkeeping for one tenant: its stream, its SLO row.

    The batcher buffers the tenant's traffic whether or not the tenant
    holds a universe slot (a deferred tenant's events park here losslessly,
    bounded by ``max_pending`` with per-tenant backpressure — one tenant's
    flood can never eat another's queue). The SLO tracker survives
    migrations: capacity promotion re-homes the state, not the session.
    """

    def __init__(self, tid: int, batcher: EventBatcher, slo_window: int):
        self.tid = tid
        self.batcher = batcher
        self.slo = RollingSLOTracker(slo_window)
        #: Device counter totals demuxed from this tenant's universe plane.
        self.counter_totals: dict[str, int] = {}
        self.pool: FleetPool | None = None
        self.slot: int | None = None
        self.launches = 0
        self.ticks_run = 0
        self.events_served = 0
        self.promotions = 0
        self._bp_seen = 0
        # Per-tenant elastic admission allocator (sparse-elastic fleets):
        # the monotone next-free-row mirror of ServeBridge._admit_join,
        # scoped to this tenant's own universe.
        self.next_row = 0
        self.n = batcher.n

    @property
    def placed(self) -> bool:
        return self.slot is not None

    def admit_join(self, ev: ServeEvent):
        """Capacity-row allocator for this tenant's universe (None parks
        the join — for the tenant's next capacity-tier promotion, or until
        a deferred tenant lands a universe slot at all: row numbers minted
        before placement would go stale)."""
        if self.pool is None or self.next_row >= self.n:
            return None
        row = self.next_row
        self.next_row += 1
        return row


class FleetPool:
    """One pinned ``(engine, n, B, k, C)`` geometry on one device.

    ``states`` is the stacked universe record. Unclaimed slots hold
    deterministic placeholder universes (``spec.init(n, seed=slot)``) that
    tick along idle — every universe steps, claimed or not, so the pool's
    launches never depend on occupancy. Admission writes a tenant's fresh
    (or checkpoint-promoted) state into its slot with
    :func:`~scalecube_cluster_tpu_torch.sim.ensemble.set_universe`.
    """

    def __init__(
        self,
        spec: EngineSpec,
        params,
        fleet_size: int,
        batch_ticks: int,
        capacity: int,
        *,
        plan=None,
        knobs=None,
        init_kw: dict | None = None,
        collect: bool = True,
        device="cuda",
    ):
        if fleet_size < 1:
            raise ValueError("fleet_size must be >= 1")
        self.spec = spec
        self.params = params
        self.fleet_size = int(fleet_size)
        self.batch_ticks = int(batch_ticks)
        self.capacity = int(capacity)
        self.device = torch.device(device)
        self.plan = plan if plan is not None else FaultPlan.uniform(device=self.device)
        self.knobs = knobs
        self.collect = collect
        self.init_kw = dict(init_kw or {})
        self.n = spec.n_of(params)
        # Built one universe at a time into the stack (peak: the stack plus
        # one universe).
        self.states = _stack_built(lambda s: self._placeholder(seed=s), self.fleet_size)
        useen = getattr(self.states, "useen", None)
        self.g_slots = 1 if useen is None else int(useen.shape[2])
        #: slot -> tenant id (None = free / placeholder universe).
        self.slots: list[int | None] = [None] * self.fleet_size
        #: Host mirror of each universe's tick counter — batch assembly
        #: needs per-universe base ticks without a device round-trip.
        self.base_ticks: list[int] = [0] * self.fleet_size
        self.launches = 0

    def _placeholder(self, seed: int):
        """Deterministic idle universe for an unclaimed slot (and the state
        a fresh tenant starts from unless admission hands one in). Elastic
        pools init half the capacity rows live (``n_live`` in ``init_kw``
        overrides) so admitted tenants have headroom to grow into."""
        kw = dict(self.init_kw)
        if self.spec.init_kw_of is not None:
            for key, val in self.spec.init_kw_of(self.params).items():
                kw.setdefault(key, val)
        kw["device"] = self.device
        if self.spec.elastic:
            kw.setdefault("n_alloc", self.n)
            n_live = kw.pop("n_live", max(self.n // 2, 1))
            return self.spec.init(n_live, seed=seed, **kw)
        kw.pop("n_live", None)
        return self.spec.init(self.n, seed=seed, **kw)

    def free_slot(self) -> int | None:
        for i, tid in enumerate(self.slots):
            if tid is None:
                return i
        return None

    def place(self, session: TenantSession, slot: int, state=None, tick0=None):
        """Claim ``slot`` for ``session``; ``state`` (if given) lands in the
        universe — fresh tenants may also keep the placeholder state (seed =
        slot), which is what the solo-parity tests replay against.

        ``tick0`` pins the slot's launch mirror (a migrated state arrives
        mid-trajectory). With ``state=None`` the mirror is KEPT: the
        incumbent placeholder universe has been stepping with every fleet
        launch since the pool was built, so a tenant admitted mid-session
        adopts it at its CURRENT tick."""
        if self.slots[slot] is not None:
            raise RuntimeError(f"slot {slot} already owned by {self.slots[slot]}")
        self.slots[slot] = session.tid
        if state is not None:
            self.states = set_universe(self.states, slot, _on_device(state, self.device))
            self.base_ticks[slot] = int(tick0 or 0)
        elif tick0 is not None:
            self.base_ticks[slot] = int(tick0)
        session.pool = self
        session.slot = slot
        session.n = self.n
        session.batcher.n = self.n
        if self.spec.elastic:
            lm = self.states.live_mask[slot].cpu().numpy()  # one read an admission
            free = np.flatnonzero(~lm)
            first_free = int(free[0]) if free.size else int(lm.shape[0])
            # A migrated tenant keeps its allocator (monotone, as the solo
            # bridge's): rows it admitted whose joins are still queued are
            # not live yet, and must not be handed out again. (The
            # reference restarts at the first free row here, so a promotion
            # with admitted joins still queued loses their rows; ROADMAP
            # Queue C.)
            session.next_row = max(session.next_row, first_free)

    def vacate(self, session: TenantSession):
        """Release the session's slot and SCRUB it back to the slot's
        deterministic placeholder — a tenant placed here later (deferred
        replay after an eviction or a promotion) must inherit none of its
        predecessor's membership state. The mirror resets with the fresh
        universe's tick."""
        slot = session.slot
        self.slots[slot] = None
        session.pool = None
        session.slot = None
        self.states = set_universe(self.states, slot, self._placeholder(slot))
        self.base_ticks[slot] = 0

    def extract(self, slot: int):
        """One universe's state, copied back out (promotion migration)."""
        return index_universe(self.states, slot)

    # -- launch machinery ---------------------------------------------------

    def assemble(self, tenants: dict[int, TenantSession]):
        """Pack every universe's next batch and issue the stacked copy (the
        pipeline stage that overlaps the previous launch)."""
        batches, stats = [], []
        for slot, tid in enumerate(self.slots):
            if tid is None:
                batches.append(empty_batch(self.batch_ticks, self.capacity))
                stats.append(None)
                continue
            session = tenants[tid]
            batch, st = session.batcher.next_batch(self.base_ticks[slot])
            st["base_tick"] = self.base_ticks[slot]
            batches.append(batch)
            stats.append(st)
        stacked = stack_batches(batches).to(self.device)
        # The launch is committed here: advance the tick mirrors NOW so a
        # double-buffered caller assembling round i+1 before finishing
        # round i targets the right global ticks.
        for slot in range(self.fleet_size):
            self.base_ticks[slot] += self.batch_ticks
        return stacked, {"stats": stats, "t_assemble": time.monotonic()}

    def execute(self, batch_dev, meta: dict):
        """Issue one fleet launch, then (on the card) record its completion
        event on the stream the launch went to."""
        self.states, traces = self.spec.fleet_runner(
            self.params,
            self.states,
            self.plan,
            batch_dev,
            collect=self.collect,
            knobs=self.knobs,
        )
        if self.device.type == "cuda":
            meta["done"] = torch.cuda.Event()
            meta["done"].record()
        return traces

    def finish(self, traces, meta: dict):
        """Wait for the launch's verdicts (its completion event), read its
        traces once, and run the host-boundary write-back if the params
        chose it."""
        if "done" in meta:
            meta.pop("done").synchronize()
        traces = {k: v.cpu().numpy() for k, v in traces.items()}
        if self.spec.needs_writeback(self.params):
            self.states = self.spec.fleet_writeback(self.params, self.states)
        self.launches += 1
        return traces

    def retune(self, batch_ticks: int, capacity: int):
        """Re-pin the launch geometry ``(k, C)``. States, slots and tick
        mirrors carry over untouched — only the batch shape changes; pending
        events re-pack under the new geometry at the next assembly,
        losslessly."""
        if batch_ticks < 1 or capacity < 1:
            raise ValueError("need batch_ticks >= 1 and capacity >= 1")
        self.batch_ticks = int(batch_ticks)
        self.capacity = int(capacity)


class TenantRouter:
    """The fleet's batcher-shaped front door for the live ingest pump.

    :class:`~scalecube_cluster_tpu_torch.serve.ingest.TcpEventSource` speaks
    the EventBatcher protocol — ``validate`` / ``is_full`` / ``wait_room``
    / ``push`` / ``overflow_policy`` / ``backpressure_total``. The router
    implements it by DELEGATING per event to the target tenant's batcher,
    so flow control is per tenant: a slow-loris tenant fills only its own
    bounded queue and pauses only its own producers.

    The pump's check sequence is ``validate(ev)`` → ``is_full`` →
    ``push(ev)`` with no await between validate and the fullness check, so
    the router resolves ``is_full``/``wait_room`` against the LAST
    validated event's target — the one the pump is about to push.
    """

    def __init__(self, fleet: "FleetBridge"):
        self.fleet = fleet
        self._last: ServeEvent | None = None

    def _target(self, tenant: int) -> EventBatcher | None:
        session = self.fleet.tenants.get(tenant)
        return None if session is None else session.batcher

    @property
    def overflow_policy(self) -> str:
        return self.fleet.overflow_policy

    @property
    def backpressure_total(self) -> int:
        return sum(s.batcher.backpressure_total for s in self.fleet.tenants.values())

    @backpressure_total.setter
    def backpressure_total(self, value: int) -> None:
        # The pump counts a pause episode by incrementing the batcher's
        # total; attribute it to the tenant whose queue actually refused.
        delta = value - self.backpressure_total
        target = self._target(self._last.tenant) if self._last else None
        if target is not None and delta > 0:
            target.backpressure_total += delta

    def validate(self, ev: ServeEvent) -> None:
        self._last = ev
        target = self._target(ev.tenant)
        if target is None:
            # Not-yet-admitted tenant: validate against the fleet's base
            # geometry (admission itself happens at push).
            self.fleet._template_batcher.validate(ev)
        else:
            target.validate(ev)

    @property
    def is_full(self) -> bool:
        target = self._target(self._last.tenant) if self._last else None
        return bool(target is not None and target.is_full)

    async def wait_room(self) -> None:
        target = self._target(self._last.tenant) if self._last else None
        if target is not None:
            await target.wait_room()

    def push(self, ev: ServeEvent, stamp: bool = True) -> None:
        session = self.fleet.tenants.get(ev.tenant)
        if session is None:
            session = self.fleet.admit(ev.tenant)
        session.batcher.push(ev, stamp=stamp)

    def __len__(self) -> int:
        return sum(len(s.batcher) for s in self.fleet.tenants.values())


class FleetBridge:
    """Multi-tenant serving session: B tenant universes stepped together.

    ``params`` fixes the per-universe engine geometry, ``fleet_size`` (B)
    the universe count, ``batch_ticks``/``capacity`` (k, C) the launch
    geometry. Tenants are admitted on first sight of their id (wire
    traffic, replayed traces, or :meth:`admit`), claim free universe
    slots, and past capacity are DEFERRED (traffic buffering per tenant,
    never dropped) under the fleet conservation ledger asserted at every
    launch boundary.

    ``auto_retune`` arms the arrival-rate control loop (the ``(k, C)``
    ladder); ``auto_promote`` (sparse-elastic fleets) promotes a tenant
    whose universe ran out of capacity rows to the next ``n`` tier through
    the checkpoint path. The session runs on ``device`` (the card unless
    the caller asks for the CPU).
    """

    def __init__(
        self,
        params,
        *,
        engine: str | EngineSpec = "sparse",
        fleet_size: int = 4,
        batch_ticks: int = 8,
        capacity: int = 4,
        plan=None,
        knobs=None,
        collect: bool = True,
        export_path: str | None = None,
        meta: dict | None = None,
        max_pending: int = 65536,
        low_watermark: int | None = None,
        overflow_policy: str = "defer",
        slo_window: int = 64,
        init_kw: dict | None = None,
        retune_ladder=None,
        auto_retune: bool = False,
        auto_promote: bool = False,
        device="cuda",
    ):
        self.spec = resolve_engine_spec(engine)
        if self.spec.fleet_runner is None:
            raise ValueError(f"engine {self.spec.name!r} has no fleet entry")
        self.device = torch.device(device)
        self.collect = collect
        self.export_path = export_path
        self.overflow_policy = overflow_policy
        self.max_pending = int(max_pending)
        self.low_watermark = low_watermark
        self.slo_window = int(slo_window)
        self.auto_retune = auto_retune
        self.auto_promote = auto_promote
        #: Pools keyed by member-count tier n — the base pool plus any
        #: larger-geometry pools capacity promotions opened.
        self.pools: "OrderedDict[int, FleetPool]" = OrderedDict()
        base = FleetPool(
            self.spec,
            params,
            fleet_size,
            batch_ticks,
            capacity,
            plan=plan,
            knobs=knobs,
            init_kw=init_kw,
            collect=collect,
            device=self.device,
        )
        self.pools[base.n] = base
        self.base_pool = base
        #: (k, C) rungs the arrival-rate loop may pin, smallest first.
        self.retune_ladder = (
            [(batch_ticks, capacity), (batch_ticks, 2 * capacity),
             (batch_ticks, 4 * capacity)]
            if retune_ladder is None
            else [tuple(map(int, r)) for r in retune_ladder]
        )
        self._rung = 0
        for i, rung in enumerate(self.retune_ladder):
            if rung == (batch_ticks, capacity):
                self._rung = i
        self.tenants: dict[int, TenantSession] = {}
        self.router = TenantRouter(self)
        # Validation template for events of not-yet-admitted tenants. The
        # dummy admit allocator only marks the elastic wire form (node=-1
        # joins) valid — the template never enqueues.
        self._template_batcher = EventBatcher(
            base.n, base.g_slots, batch_ticks, capacity,
            engine=self.spec.batcher_engine,
            legacy_join=not self.spec.elastic and self.spec.batcher_engine == "swim",
            admit=(lambda ev: None) if self.spec.elastic else None,
        )
        #: Fleet admission ledger (requested == placed + pending +
        #: deferred + evicted; asserted at every launch boundary).
        self.tenants_requested = 0
        self.tenants_evicted = 0
        self._migrating = 0  # mid-promotion tenants (0 at boundaries)
        self.deferred_tenants: "OrderedDict[int, TenantSession]" = OrderedDict()
        self.meta = meta if meta is not None else run_metadata(**self.spec.meta_of(params))
        self.rows: list[dict] = []
        self.fleet_launches = 0
        self.ticks_run = 0
        self.events_served = 0
        self.retunes = 0
        self._sources: list[TcpEventSource] = []
        self._rejected_seen = 0
        #: Arrival-rate EMA (events/s) the (k, C) control loop watches.
        self.arrival_rate = 0.0
        self._arrived_seen = 0
        self._t_rate = time.monotonic()
        self.exec_s_total = 0.0

    # -- admission / eviction ----------------------------------------------

    def _new_session(self, tid: int) -> TenantSession:
        batcher = EventBatcher(
            self.base_pool.n,
            self.base_pool.g_slots,
            self.base_pool.batch_ticks,
            self.base_pool.capacity,
            max_pending=self.max_pending,
            low_watermark=self.low_watermark,
            overflow_policy=self.overflow_policy,
            engine=self.spec.batcher_engine,
            legacy_join=not self.spec.elastic and self.spec.batcher_engine == "swim",
        )
        session = TenantSession(tid, batcher, self.slo_window)
        if self.spec.elastic:
            batcher.legacy_join = False
            batcher.admit = session.admit_join
        return session

    def admit(self, tid: int, *, state=None, knobs=None) -> TenantSession:
        """Admit tenant ``tid``: claim a free universe slot of the base
        pool, or DEFER past capacity (traffic buffers in the tenant's own
        bounded queue until a slot frees — never dropped). ``state`` seeds
        the tenant's universe (default: the slot's deterministic
        placeholder, seed = slot index); ``knobs`` sets the tenant's
        per-universe knob point (pools built with stacked knobs only)."""
        tid = int(tid)
        if tid < 0:
            raise ValueError(f"tenant id {tid} must be >= 0")
        if tid in self.tenants:
            return self.tenants[tid]
        self.tenants_requested += 1
        session = self._new_session(tid)
        self.tenants[tid] = session
        slot = self.base_pool.free_slot()
        if slot is None:
            self.deferred_tenants[tid] = session
            return session
        self.base_pool.place(session, slot, state=state)
        if knobs is not None:
            self.set_tenant_knobs(tid, knobs)
        return session

    def evict(self, tid: int) -> None:
        """Explicitly evict a tenant (counted in the ledger); its slot is
        re-offered to the longest-deferred tenant immediately."""
        session = self.tenants.pop(int(tid))
        self.tenants_evicted += 1
        if session.placed:
            session.pool.vacate(session)
            self._replay_deferred_tenants()
        else:
            self.deferred_tenants.pop(session.tid, None)

    def _replay_deferred_tenants(self) -> int:
        """Offer freed base-pool slots to parked tenants, FIFO."""
        placed = 0
        while self.deferred_tenants:
            slot = self.base_pool.free_slot()
            if slot is None:
                break
            tid, session = next(iter(self.deferred_tenants.items()))
            del self.deferred_tenants[tid]
            self.base_pool.place(session, slot)
            if self.spec.elastic and session.batcher.deferred_joins:
                # Joins that arrived while the tenant was parked re-run
                # admission now that row numbers are real.
                session.batcher.replay_deferred_joins()
            placed += 1
        return placed

    def set_tenant_knobs(self, tid: int, knobs) -> None:
        """Retune one tenant's protocol knob point — per-universe data
        (sim/knobs.py) written into the pool's stacked knobs."""
        session = self.tenants[int(tid)]
        if not session.placed:
            raise RuntimeError(f"tenant {tid} is deferred; no universe to tune")
        pool = session.pool
        if pool.knobs is None:
            raise RuntimeError(
                "pool carries no knob plane; build the fleet with stacked "
                "identity knobs (knobs=...) to tune tenants per-universe"
            )
        pool.knobs = set_universe(pool.knobs, session.slot, _on_device(knobs, pool.device))

    # -- conservation ledger -------------------------------------------------

    def fleet_ledger(self) -> dict:
        placed = sum(1 for s in self.tenants.values() if s.placed)
        return {
            "requested": self.tenants_requested,
            "placed": placed,
            "pending": self._migrating,
            "deferred": len(self.deferred_tenants),
            "evicted": self.tenants_evicted,
        }

    def assert_fleet_conservation(self) -> dict:
        led = self.fleet_ledger()
        total = led["placed"] + led["pending"] + led["deferred"] + led["evicted"]
        assert led["requested"] == total, (
            f"fleet conservation violated: requested={led['requested']} != "
            f"placed+pending+deferred+evicted={total} ({led})"
        )
        return led

    @property
    def ingest_rejected(self) -> int:
        return sum(src.rejected for src in self._sources)

    # -- launch pipeline -----------------------------------------------------

    def _dispatch_round(self):
        """Assemble, copy and issue ONE launch per pool (host packing of the
        next pool overlaps the card finishing the previous one)."""
        work = []
        for pool in self.pools.values():
            batch_dev, meta = pool.assemble(self.tenants)
            traces = pool.execute(batch_dev, meta)
            work.append((pool, meta, traces))
        return work

    def _finish_round(self, work) -> list:
        """Wait for every pool's verdicts; demux per-tenant SLO/counters,
        emit per-pool ``fleet_batch`` rows, assert the ledger."""
        out = []
        for pool, meta, traces in work:
            traces = pool.finish(traces, meta)
            t_done = time.monotonic()
            exec_s = t_done - meta["t_assemble"]
            self.exec_s_total += exec_s
            n_events = 0
            overflow = 0
            for slot, st in enumerate(meta["stats"]):
                if st is None:
                    continue
                tid = pool.slots[slot]
                session = self.tenants.get(tid)
                if session is None:  # evicted mid-flight; drop accounting
                    continue
                t0 = st.get("oldest_ingest") or meta["t_assemble"]
                lat_ms = (t_done - t0) * 1000.0
                bp = session.batcher.backpressure_total
                session.slo.record(
                    lat_ms, st["n_events"], exec_s, backpressure=bp - session._bp_seen
                )
                session._bp_seen = bp
                if self.collect:
                    # Demux the launch's counters: universe `slot` of every
                    # [B, k] counter plane belongs to this tenant.
                    for key in self.spec.counter_keys:
                        if key in traces:
                            session.counter_totals[key] = session.counter_totals.get(
                                key, 0
                            ) + int(np.sum(traces[key][slot]))
                session.launches += 1
                session.ticks_run += pool.batch_ticks
                session.events_served += st["n_events"]
                n_events += st["n_events"]
                overflow += st["n_deferred"]
                if self.spec.elastic:
                    session.batcher.assert_join_conservation()
            self.fleet_launches += 1
            self.ticks_run += pool.batch_ticks
            self.events_served += n_events
            payload = {
                "launch": self.fleet_launches - 1,
                "n": pool.n,
                "fleet_size": pool.fleet_size,
                "tenants_placed": sum(1 for t in pool.slots if t is not None),
                "batch_ticks": pool.batch_ticks,
                "capacity": pool.capacity,
                "n_events": n_events,
                "ingest_overflow": overflow,
                "exec_s": exec_s,
            }
            rej = self.ingest_rejected
            payload["ingest_rejected"] = rej - self._rejected_seen
            self._rejected_seen = rej
            self.rows.append(make_row("fleet_batch", payload, self.meta))
            out.append(traces)
        # The launch boundary: conservation first, then the control loop.
        self.assert_fleet_conservation()
        self._observe_arrival_rate()
        if self.auto_retune:
            self.maybe_retune()
        if self.auto_promote:
            self._auto_promote()
        return out

    def step_fleet(self) -> list:
        """ONE launch per pool, unpipelined (live mode uses it directly so
        each launch sees the freshest traffic). Returns per-pool traces."""
        return self._finish_round(self._dispatch_round())

    def run_replay(self, events, n_ticks: int) -> list:
        """Replay ``events`` (tenant-tagged) for ``n_ticks`` ticks per
        universe, double-buffered: round ``i+1`` is assembled and its copy
        issued right after round ``i`` is issued, before waiting on ``i``'s
        verdicts."""
        for ev in events:
            self.router.push(ev, stamp=False)
        k = self.base_pool.batch_ticks
        rounds = -(-int(n_ticks) // k)
        out = []
        work = self._dispatch_round()
        for i in range(rounds):
            nxt = self._dispatch_round() if i + 1 < rounds else None
            out.append(self._finish_round(work))
            work = nxt
        return out

    async def run_live(
        self,
        transport,
        n_rounds: int | None = None,
        settle_s: float = 0.0,
        *,
        pace_s: float | None = None,
        stop_when=None,
    ) -> list:
        """Serve fleet launches from a live transport session: one pump
        drains tenant-tagged ``serve/event`` messages through the router;
        each round picks up whatever every tenant sent since the last one.
        Pacing and termination mirror ServeBridge.run_live."""
        if n_rounds is None and stop_when is None:
            raise ValueError("run_live needs n_rounds or stop_when")
        src = TcpEventSource(transport)
        self._sources.append(src)
        pump = asyncio.ensure_future(src.pump(self.router))
        out = []
        t0 = time.monotonic()
        i = 0
        try:
            while n_rounds is None or i < n_rounds:
                if stop_when is not None and stop_when():
                    break
                if pace_s is not None:
                    delay = t0 + i * pace_s - time.monotonic()
                    if delay > 0:
                        await asyncio.sleep(delay)
                elif settle_s:
                    await asyncio.sleep(settle_s)
                await asyncio.sleep(0)  # let queued frames reach the router
                out.append(self.step_fleet())
                i += 1
        finally:
            pump.cancel()
            try:
                await pump
            except asyncio.CancelledError:
                pass
        return out

    # -- adaptive geometry ----------------------------------------------------

    def _observe_arrival_rate(self, alpha: float = 0.3) -> None:
        now = time.monotonic()
        arrived = sum(s.batcher.pushed_total for s in self.tenants.values())
        dt = max(now - self._t_rate, 1e-9)
        inst = (arrived - self._arrived_seen) / dt
        self.arrival_rate = alpha * inst + (1.0 - alpha) * self.arrival_rate
        self._arrived_seen = arrived
        self._t_rate = now

    def maybe_retune(self) -> bool:
        """Arrival-rate-driven ``(k, C)`` rung selection: when the observed
        per-launch demand presses the current event budget (``k*C`` per
        tenant), climb the ladder; when it idles well under the next rung
        down, descend. A rung change re-pins every pool's geometry and
        counts one retune; states carry over untouched."""
        placed = max(sum(1 for s in self.tenants.values() if s.placed), 1)
        k, cap = self.retune_ladder[self._rung]
        pending = sum(len(s.batcher) for s in self.tenants.values() if s.placed)
        demand = pending / placed
        rung = self._rung
        if demand > 0.75 * k * cap and rung + 1 < len(self.retune_ladder):
            rung += 1
        elif rung > 0:
            k_dn, cap_dn = self.retune_ladder[rung - 1]
            if demand < 0.25 * k_dn * cap_dn:
                rung -= 1
        if rung == self._rung:
            return False
        self._rung = rung
        self.retune(*self.retune_ladder[rung])
        return True

    def retune(self, batch_ticks: int, capacity: int) -> None:
        """Re-pin every pool (and every tenant validation template) to the
        ``(k, C)`` launch geometry; emits a ``kind="retune"`` row."""
        for pool in self.pools.values():
            pool.retune(batch_ticks, capacity)
        self._template_batcher.n_ticks = int(batch_ticks)
        self._template_batcher.capacity = int(capacity)
        for session in self.tenants.values():
            session.batcher.n_ticks = int(batch_ticks)
            session.batcher.capacity = int(capacity)
        self.retunes += 1
        self.rows.append(make_row("retune", {
            "batch_ticks": int(batch_ticks),
            "capacity": int(capacity),
            "arrival_rate": self.arrival_rate,
            "retune": self.retunes,
        }, self.meta))

    def _pool_for_tier(self, n_new: int, like_params) -> FleetPool:
        pool = self.pools.get(n_new)
        if pool is None:
            pool = FleetPool(
                self.spec,
                like_params,
                self.base_pool.fleet_size,
                self.base_pool.batch_ticks,
                self.base_pool.capacity,
                plan=self.base_pool.plan,
                knobs=None,
                init_kw=self.base_pool.init_kw,
                collect=self.collect,
                device=self.device,
            )
            self.pools[n_new] = pool
        return pool

    def _auto_promote(self) -> None:
        for tid, session in list(self.tenants.items()):
            if session.placed and session.batcher.deferred_joins:
                self.promote_tenant(tid)

    def promote_tenant(self, tid: int, n_new: int | None = None) -> dict:
        """Capacity-tier promotion for ONE tenant, zero dropped ticks.

        At a launch boundary (the pipeline is drained: step_fleet waits in
        _finish_round before any promotion decision), the tenant's universe
        is copied out, round-tripped through
        save_sparse_checkpoint(``pack_cold=True``) on an in-memory buffer,
        embedded bit-exactly into ``n_new`` rows
        (sim/checkpoint.py::promote_sparse_state — tick and rng carry, so
        the tenant's trajectory continues without a gap), and placed into
        the ``n_new``-tier pool (created on demand). The SESSION — SLO
        tracker, batcher queue, transport — carries across; only the state
        re-homes. Joins parked for capacity replay immediately. Mid-flight
        the ledger counts the tenant ``pending``.

        Emits a ``kind="fleet_promotion"`` row; returns it.
        """
        if not (self.spec.elastic and self.spec.promotable):
            raise RuntimeError(
                "promote_tenant() needs an elastic, checkpoint-promotable "
                f"fleet (engine {self.spec.name!r})"
            )
        session = self.tenants[int(tid)]
        if not session.placed:
            raise RuntimeError(f"tenant {tid} is deferred; nothing to promote")
        pool = session.pool
        n_old = pool.n
        n_new = 2 * n_old if n_new is None else int(n_new)
        t0 = time.monotonic()
        self._migrating += 1
        slot_old = session.slot
        state = pool.extract(slot_old)
        tick0 = pool.base_ticks[slot_old]
        pool.vacate(session)
        try:
            buf = io.BytesIO()
            save_sparse_checkpoint(buf, state.replace(trace=None), pool.params, pack_cold=True)
            buf.seek(0)
            state_l, params_l = load_sparse_checkpoint(buf, device=self.device)
            del buf
            params_new, state_new = promote_sparse_state(params_l, state_l, n_new)
            del state_l
            target = self._pool_for_tier(n_new, params_new)
            slot_new = target.free_slot()
            if slot_new is None:
                raise RuntimeError(f"tier-{n_new} pool is full; grow its fleet_size first")
            target.place(session, slot_new, state=state_new, tick0=tick0)
        except Exception:
            # Roll the migration back into the old slot — a failed
            # promotion must not leak the tenant out of the ledger.
            self._migrating -= 1
            pool.place(session, slot_old, state=state, tick0=tick0)
            raise
        self._migrating -= 1
        session.promotions += 1
        replayed = session.batcher.replay_deferred_joins()
        self._replay_deferred_tenants()  # the vacated slot is capacity now
        payload = {
            "tenant": session.tid,
            "n_from": n_old,
            "n_to": n_new,
            "promotion": session.promotions,
            "base_tick": tick0,
            "joins_replayed": replayed,
            "joins_still_deferred": len(session.batcher.deferred_joins),
            "wall_ms": (time.monotonic() - t0) * 1000.0,
        }
        row = make_row("fleet_promotion", payload, self.meta)
        self.rows.append(row)
        return row

    # -- session rollup --------------------------------------------------------

    def counters(self) -> dict:
        """Fleet counter totals on the SHARED_COUNTERS schema: per-universe
        trace sums demuxed per tenant, with the fleet's host accounting —
        the four fleet gauges/counters plus the cross-tenant ingest totals
        — over the engines' constant-0 slots."""
        totals = {k: 0 for k in self.spec.counter_keys}
        for session in self.tenants.values():
            for key, v in session.counter_totals.items():
                totals[key] += v
        totals["serve_batches"] = self.fleet_launches
        totals["fleet_launches"] = self.fleet_launches
        totals["tenants_active"] = sum(1 for s in self.tenants.values() if s.placed)
        totals["tenants_deferred"] = len(self.deferred_tenants)
        totals["tenant_evictions"] = self.tenants_evicted
        totals["ingest_rejected"] = self.ingest_rejected
        totals["ingest_backpressure"] = self.router.backpressure_total
        totals["promotions"] = sum(s.promotions for s in self.tenants.values())
        totals["joins_deferred"] = sum(
            len(s.batcher.deferred_joins) for s in self.tenants.values()
        )
        return totals

    def tenant_row(self, tid: int) -> dict:
        """One tenant's ``kind="fleet_tenant"`` row: its SLO percentiles,
        its conservation ledger, its share of the fleet."""
        session = self.tenants[int(tid)]
        lat = session.slo.session()["latency"]
        b = session.batcher
        payload = {
            "tenant": session.tid,
            "placed": session.placed,
            "n": session.n,
            "launches": session.launches,
            "ticks": session.ticks_run,
            "events_total": session.events_served,
            "events_pending": len(b),
            "ingest_overflow": b.overflow_total,
            "ingest_backpressure": b.backpressure_total,
            "ingest_shed": b.shed_total,
            "promotions": session.promotions,
            "latency_ms_p50": lat.get("p50", 0.0),
            "latency_ms_p95": lat.get("p95", 0.0),
            "latency_ms_p99": lat.get("p99", 0.0),
            "latency_ms_mean": lat.get("mean", 0.0),
        }
        if self.spec.elastic:
            payload["join_ledger"] = b.join_ledger()
        if session.counter_totals:
            payload["counters"] = dict(session.counter_totals)
        return make_row("fleet_tenant", payload, self.meta)

    def summary_row(self) -> dict:
        """The ``kind="fleet"`` session row: the fleet ledger, the aggregate
        tenant·member·rounds/s, and the per-tenant SLO table."""
        exec_s = max(self.exec_s_total, 1e-9)
        tenant_rounds = sum(s.n * s.ticks_run for s in self.tenants.values())
        payload = {
            "engine": self.spec.name,
            "fleet_size": self.base_pool.fleet_size,
            "pools": {
                str(n): {
                    "fleet_size": p.fleet_size,
                    "launches": p.launches,
                    "batch_ticks": p.batch_ticks,
                    "capacity": p.capacity,
                }
                for n, p in self.pools.items()
            },
            "launches": self.fleet_launches,
            "ticks": self.ticks_run,
            "events_total": self.events_served,
            "events_pending": len(self.router),
            "ingest_rejected": self.ingest_rejected,
            "retunes": self.retunes,
            "arrival_rate": self.arrival_rate,
            "ledger": self.fleet_ledger(),
            "events_per_sec": self.events_served / exec_s,
            "tenant_member_rounds_per_sec": tenant_rounds / exec_s,
            "tenants": {
                str(tid): {
                    k: v
                    for k, v in self.tenant_row(tid).items()
                    if k.startswith(("latency_ms_", "events_", "ticks"))
                    or k in ("launches", "promotions", "n", "placed")
                }
                for tid in sorted(self.tenants)
            },
        }
        if self.collect:
            payload["counters"] = self.counters()
        return make_row("fleet", payload, self.meta)

    def close(self) -> dict:
        """Finalize: per-tenant rows + the fleet summary, flushed to
        ``export_path``."""
        for tid in sorted(self.tenants):
            self.rows.append(self.tenant_row(tid))
        summary = self.summary_row()
        self.rows.append(summary)
        if self.export_path:
            append_jsonl(self.export_path, self.rows)
        return summary
