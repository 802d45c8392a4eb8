"""ServeBridge: the host-side pipeline turning ingested traffic into launches
(port of scalecube_cluster_tpu/serve/bridge.py).

One bridge owns an engine state and steps it ``k`` ticks per launch through
its :class:`~scalecube_cluster_tpu_torch.serve.spec.EngineSpec`'s runner
(serve/engine.py). The pipeline keeps the reference's stages, spans and SLO
stamps — assemble, transfer, execute, finish — and its double buffer: in
:meth:`ServeBridge.run_replay`, batch ``i+1`` is packed and its device copy
issued right after launch ``i`` is issued, before the bridge waits for
``i``'s verdicts. The copy is staged in pinned host memory and issued with
``non_blocking=True`` on the session's (the current) stream
(serve/events.py), and the verdicts are awaited on a CUDA event recorded
after the launch's last write, not by reading a small output back.

Where the overlap is lost: the reference's launch is one asynchronous XLA
call, while the port's runner issues every tick's kernels from the host
(about 2.5k launches a sparse tick), so a launch returns only once the host
has issued its last tick — close to when the card finishes it on a
host-bound tick. What still overlaps is the card finishing the tail of
launch ``i`` while the host packs batch ``i+1``; the rest of the pipeline
runs in order.

Every launch emits a ``kind="serve_batch"`` row and the session close a
``kind="serve"`` summary row through the schema-versioned exporter
(obs/export.py), with ingest→verdict SLO latency percentiles from one
rolling tracker (obs/slo.py) that :meth:`ServeBridge.live_metrics` also
reads, so a live scrape and the close-time summary never disagree about
the same launches.
"""

from __future__ import annotations

import asyncio
import io
import time

import numpy as np
import torch

from scalecube_cluster_tpu_torch.obs.counters import SHARED_COUNTERS
from scalecube_cluster_tpu_torch.obs.export import append_jsonl, make_row, run_metadata
from scalecube_cluster_tpu_torch.obs.slo import RollingSLOTracker
from scalecube_cluster_tpu_torch.obs.trace import TK_JOIN_ACK, TK_JOIN_REQ, trace_occupancy
from scalecube_cluster_tpu_torch.obs.tracer import pad_trace_ring, trace_host_event
from scalecube_cluster_tpu_torch.serve.ingest import EventBatcher, ServeEvent, TcpEventSource
from scalecube_cluster_tpu_torch.serve.spec import MESH_ERROR, EngineSpec, resolve_engine_spec
from scalecube_cluster_tpu_torch.sim.checkpoint import (
    load_sparse_checkpoint,
    promote_sparse_state,
    save_sparse_checkpoint,
)
from scalecube_cluster_tpu_torch.sim.faults import FaultPlan
from scalecube_cluster_tpu_torch.sim.knobs import Knobs
from scalecube_cluster_tpu_torch.sim.sparse import SparseParams, SparseState


class ServeBridge:
    """Digital-twin serving session over one engine state.

    ``batch_ticks`` (k) and ``capacity`` (C) fix the launch geometry.
    ``engine`` selects the :class:`~scalecube_cluster_tpu_torch.serve.spec.EngineSpec`
    (a registry name, a spec object, or None — inferred from the state's
    type and shape). The session runs on the state's device; sparse
    engines consume the state on every launch, so callers must not hold
    references to it across :meth:`run_replay` / :meth:`run_live`.

    With ``params.in_scan_writeback=True`` the session equals one offline
    ``run_sparse_ticks`` call over the same timeline; with the big-n
    host-boundary mode the bridge frees slots between launches exactly like
    ``run_sparse_chunked`` with ``chunk=batch_ticks``. ``mesh`` raises:
    mesh placement needs the port's multi-device engine.
    """

    def __init__(
        self,
        params: SparseParams,
        state: SparseState,
        *,
        plan: FaultPlan | None = None,
        batch_ticks: int = 8,
        capacity: int = 4,
        knobs: Knobs | None = None,
        collect: bool = True,
        export_path: str | None = None,
        meta: dict | None = None,
        max_pending: int = 65536,
        low_watermark: int | None = None,
        overflow_policy: str = "defer",
        slo_window: int = 64,
        legacy_join: bool | None = None,
        auto_promote: bool = False,
        engine: str | EngineSpec | None = None,
        mesh=None,
    ):
        self.spec = resolve_engine_spec(engine, state)
        if mesh is not None:
            raise NotImplementedError(MESH_ERROR)
        self.params = params
        self.state = state
        self.device = state.device
        self.plan = plan if plan is not None else FaultPlan.uniform(device=self.device)
        self.knobs = knobs
        self.collect = collect
        self.export_path = export_path
        g_slots = self.spec.g_slots_of(state)
        # Elastic sessions (live_mask attached) route wire joins to
        # ADMISSION — an unused capacity row per join, activated in the
        # tick by run_serve_batch_elastic — instead of the fixed-shape
        # restart alias. ``legacy_join=None`` resolves from the spec; pass
        # True to replay a pre-elastic trace byte-compatibly.
        self.elastic = self.spec.elastic
        if legacy_join is None:
            legacy_join = not self.elastic and self.spec.batcher_engine == "swim"
        #: Geometry promotions taken this session (the n_alloc doubling
        #: ladder); stamped over the engines' constant-zero counter slot.
        self.promotions = 0
        #: ``auto_promote=True``: a launch boundary that finds joins parked
        #: for capacity promotes first (doubling) and replays them.
        self.auto_promote = auto_promote
        if self.elastic:
            # Monotone next-free-row allocator: bridge sessions activate rows
            # only through admission, so this host mirror stays exact.
            lm = state.live_mask.cpu().numpy()
            free = np.flatnonzero(~lm)
            self._next_row = int(free[0]) if free.size else int(lm.shape[0])
        # Bounded queue by default: a serving session degrades by CHOICE
        # (defer = lossless backpressure; shed-oldest = bounded latency,
        # shed counted). max_pending=0 is the unbounded queue.
        self.batcher = EventBatcher(
            self.spec.n_of(params),
            g_slots,
            batch_ticks,
            capacity,
            max_pending=max_pending,
            low_watermark=low_watermark,
            overflow_policy=overflow_policy,
            engine=self.spec.batcher_engine,
            legacy_join=legacy_join,
            admit=self._admit_join if self.elastic else None,
        )
        self.meta = (
            meta if meta is not None else run_metadata(**self.spec.meta_of(params))
        )
        self.rows: list[dict] = []
        # Launch spans for obs/trace.py::chrome_trace: one dict per launch,
        # monotonic clock [t0=assembly, t1=verdicts ready].
        self.spans: list[dict] = []
        self.serve_batches = 0  # host accounting: a batch is a launch
        self.ticks_run = 0
        self.events_served = 0
        self.slo = RollingSLOTracker(slo_window)
        self._bp_seen = 0  # backpressure total already attributed to a launch
        self._counter_totals = {k: 0 for k in SHARED_COUNTERS}
        # Live sources pumped from (run_live attaches one per call): their
        # malformed-payload rejections reach the export rows.
        self._sources: list[TcpEventSource] = []
        self._rejected_seen = 0  # rejected total already stamped into rows

    # -- ingestion ----------------------------------------------------------

    def push(self, ev: ServeEvent) -> None:
        """Enqueue one event (trace replay / programmatic producers)."""
        self.batcher.push(ev)

    def _admit_join(self, ev: ServeEvent) -> int | None:
        """Admission allocator the batcher calls per EV_JOIN push (elastic
        sessions): the next unused capacity row, or None to park the join
        for the next geometry promotion.

        Flight-recorder cause chain: the first attempt emits a host
        TK_JOIN_REQ (its ring position stamped on the event, so a parked
        join keeps the link across promotions); admission emits TK_JOIN_ACK
        with ``cause=req`` and parks the ack's position in the ring's
        ``origin[row]`` register, which the in-tick TK_JOIN_EV of the
        activation takes as its cause: request → ack → admit.
        """
        ring = self.state.trace
        tick = self.state.t_host
        if ring is not None and ev.req_pos is None:
            ev.req_pos = int(ring.cursor)
            ring = trace_host_event(ring, TK_JOIN_REQ, tick, -1, -1)
        if self._next_row >= self.spec.n_of(self.params):
            if ring is not None:
                self.state = self.state.replace(trace=ring)
            return None
        row = self._next_row
        self._next_row += 1
        if ring is not None:
            ack_pos = int(ring.cursor)
            ring = trace_host_event(
                ring, TK_JOIN_ACK, tick, -1, row,
                cause=-1 if ev.req_pos is None else ev.req_pos,
            )
            origin = ring.origin.clone()
            origin[row] = ack_pos
            self.state = self.state.replace(trace=ring.replace(origin=origin))
        return row

    def promote(self, n_alloc_new: int | None = None) -> dict:
        """Online geometry promotion: re-home the session at the next
        capacity tier and replay every join parked for it.

        Checkpoint-based: the state round-trips through
        ``save_sparse_checkpoint(pack_cold=True)`` on an in-memory buffer
        and ``load_sparse_checkpoint`` onto the state's device, then
        sim/checkpoint.py::promote_sparse_state embeds it bit-exactly into
        ``n_alloc_new`` rows (default: the doubling ladder), so every
        promotion exercises the persistence path a crash-restart would.
        The pipeline is drained (step_batch waits in _finish_launch before
        any promotion decision), and the bridge — transport sessions, SLO
        tracker, export rows — carries across; only ``params``/``state``
        (and the batcher's width) re-home. The flight recorder's ring pads
        in place (positions stable), so recorded join chains survive.

        Emits a ``kind="promotion"`` row; returns it.
        """
        if not (self.elastic and self.spec.promotable):
            raise RuntimeError(
                "promote() needs an elastic, checkpoint-promotable session "
                f"(engine {self.spec.name!r}, live_mask required)"
            )
        n_old = self.spec.n_of(self.params)
        n_new = 2 * n_old if n_alloc_new is None else int(n_alloc_new)
        t0 = time.monotonic()
        trace = self.state.trace
        buf = io.BytesIO()
        save_sparse_checkpoint(
            buf, self.state.replace(trace=None), self.params, pack_cold=True
        )
        buf.seek(0)
        state_l, params_l = load_sparse_checkpoint(buf, device=self.device)
        del buf
        params_new, state_new = promote_sparse_state(params_l, state_l, n_new)
        if trace is not None:
            state_new = state_new.replace(trace=pad_trace_ring(trace, n_new))
        self.params = params_new
        self.state = state_new
        self.batcher.n = n_new
        self.promotions += 1
        replayed = self.batcher.replay_deferred_joins()
        payload = {
            "n_from": n_old,
            "n_to": n_new,
            "promotion": self.promotions,
            "base_tick": self.state.t_host,
            "joins_replayed": replayed,
            "joins_still_deferred": len(self.batcher.deferred_joins),
            "wall_ms": (time.monotonic() - t0) * 1000.0,
        }
        row = make_row("promotion", payload, self.meta)
        self.rows.append(row)
        return row

    @property
    def ingest_rejected(self) -> int:
        """Malformed-payload rejections across every live source this session."""
        return sum(src.rejected for src in self._sources)

    # -- launch pipeline ----------------------------------------------------

    def _assemble(self, base_tick: int):
        """Pack the next batch and issue its device copy (the pipeline stage
        that overlaps the previous launch's tail)."""
        batch, stats = self.batcher.next_batch(base_tick)
        stats["t_assemble"] = time.monotonic()
        return batch.to(self.device), stats

    def _execute(self, batch_dev, stats: dict):
        """Issue one launch, then (on the card) record its completion event
        on the stream the launch went to."""
        self.state, traces = self.spec.runner(
            self.params,
            self.state,
            self.plan,
            batch_dev,
            collect=self.collect,
            knobs=self.knobs,
        )
        if self.device.type == "cuda":
            stats["done"] = torch.cuda.Event()
            stats["done"].record()
        return batch_dev, stats, traces

    def _finish_launch(self, stats: dict, traces) -> dict:
        """Wait until the launch's verdicts are ready; emit its row.

        The SLO window opens at the earliest ``t_ingest`` among the batch's
        events (live mode: true ingest→verdict wall time) and falls back to
        assembly start for event-free or replayed batches.
        """
        if "done" in stats:
            stats.pop("done").synchronize()
        traces = {k: v.cpu().numpy() for k, v in traces.items()}
        t_done = time.monotonic()
        if self.spec.needs_writeback(self.params):
            # Big-n host-boundary mode: free done slots between launches,
            # exactly run_sparse_chunked's cadence with chunk=batch_ticks.
            self.state = self.spec.writeback(self.params, self.state)
        t0 = stats.get("oldest_ingest") or stats["t_assemble"]
        lat_ms = (t_done - t0) * 1000.0
        exec_s = t_done - stats["t_assemble"]
        bp = self.batcher.backpressure_total
        self.slo.record(
            lat_ms, stats["n_events"], exec_s, backpressure=bp - self._bp_seen
        )
        self._bp_seen = bp
        self.serve_batches += 1
        self.ticks_run += self.batcher.n_ticks
        self.events_served += stats["n_events"]
        span = {
            "batch": self.serve_batches - 1,
            "base_tick": int(stats["base_tick"]),
            "batch_ticks": self.batcher.n_ticks,
            "n_events": stats["n_events"],
            "t0": stats["t_assemble"],
            "t1": t_done,
        }
        if self.state.trace is not None:
            span["ring_occupancy"] = trace_occupancy(self.state.trace)
        self.spans.append(span)
        payload = {
            "batch": self.serve_batches - 1,
            "base_tick": int(stats["base_tick"]),
            "batch_ticks": self.batcher.n_ticks,
            "capacity": self.batcher.capacity,
            "n_events": stats["n_events"],
            "ingest_overflow": stats["n_deferred"],
            "latency_ms": lat_ms,
        }
        # The rejections since the previous launch, not the running total.
        rej = self.ingest_rejected
        payload["ingest_rejected"] = rej - self._rejected_seen
        self._rejected_seen = rej
        if self.collect:
            for k in SHARED_COUNTERS:
                if k in traces:
                    self._counter_totals[k] += int(np.sum(traces[k]))
            for k in ("kills_fired", "restarts_fired", "gossip_fired",
                      "verdicts_dead", "verdicts_alive", "joins_fired"):
                if k in traces:
                    payload[k] = int(np.sum(traces[k]))
        if self.elastic:
            # The admission ledger is exact at EVERY launch boundary.
            self.batcher.assert_join_conservation()
        row = make_row("serve_batch", payload, self.meta)
        self.rows.append(row)
        return traces

    def step_batch(self):
        """Assemble → transfer → execute → record ONE launch (no lookahead).
        Returns the launch's traces as numpy arrays."""
        if self.elastic and self.auto_promote and self.batcher.deferred_joins:
            # Capacity ran out since the last launch: grow BEFORE stepping,
            # so the parked joins ride this very batch.
            self.promote()
        base = self.state.t_host
        batch_dev, stats = self._assemble(base)
        stats["base_tick"] = base
        _, stats, traces = self._execute(batch_dev, stats)
        return self._finish_launch(stats, traces)

    def run_replay(self, events, n_ticks: int) -> list:
        """Replay ``events`` deterministically for ``n_ticks`` ticks.

        Double-buffered: batch ``i+1`` is assembled and its copy issued
        right after launch ``i`` is issued, before waiting on ``i``'s
        verdicts. Returns the per-launch trace dicts.
        """
        for ev in events:
            # Unstamped: the SLO window of a replayed batch opens at its
            # assembly, not at trace load (see _finish_launch).
            self.batcher.push(ev, stamp=False)
        k = self.batcher.n_ticks
        n_batches = -(-n_ticks // k)
        out = []
        base = self.state.t_host
        pending = self._assemble(base)
        pending[1]["base_tick"] = base
        for i in range(n_batches):
            batch_dev, stats = pending
            _, stats, traces = self._execute(batch_dev, stats)
            if i + 1 < n_batches:
                next_base = base + (i + 1) * k
                pending = self._assemble(next_base)
                pending[1]["base_tick"] = next_base
            out.append(self._finish_launch(stats, traces))
        return out

    async def run_live(
        self,
        transport,
        n_batches: int | None = None,
        settle_s: float = 0.0,
        *,
        pace_s: float | None = None,
        stop_when=None,
    ) -> list:
        """Serve launches from a live transport session.

        A pump task drains ``serve/event`` messages into the batcher; each
        launch picks up whatever arrived since the last one. Pacing:
        ``pace_s`` fires launch ``i`` at ``t0 + i*pace_s`` on the monotonic
        clock (no drift accumulates); ``settle_s`` sleeps a fixed time per
        launch; neither launches back-to-back, yielding once to the loop.
        Termination: after ``n_batches`` launches, or when ``stop_when()``
        returns true (checked before each launch); at least one must be
        given. Returns the per-launch trace dicts.
        """
        if n_batches is None and stop_when is None:
            raise ValueError("run_live needs n_batches or stop_when")
        src = TcpEventSource(transport)
        self._sources.append(src)
        pump = asyncio.ensure_future(src.pump(self.batcher))
        out = []
        t0 = time.monotonic()
        i = 0
        try:
            while n_batches is None or i < n_batches:
                if stop_when is not None and stop_when():
                    break
                if pace_s is not None:
                    delay = t0 + i * pace_s - time.monotonic()
                    if delay > 0:
                        await asyncio.sleep(delay)
                elif settle_s:
                    await asyncio.sleep(settle_s)
                await asyncio.sleep(0)  # let queued frames reach the batcher
                out.append(self.step_batch())
                i += 1
        finally:
            pump.cancel()
            try:
                await pump
            except asyncio.CancelledError:
                pass
        return out

    # -- session rollup -----------------------------------------------------

    def _n_live(self) -> int:
        return int(self.state.live_mask.sum())

    def counters(self) -> dict:
        """Session counter totals on the SHARED_COUNTERS schema: trace sums,
        with ``serve_batches``, ``ingest_rejected``, ``ingest_backpressure``,
        ``promotions``, ``joins_deferred`` and (elastic) ``n_live`` from the
        host's accounting over the engines' constant-zero slots."""
        totals = dict(self._counter_totals)
        totals["serve_batches"] = self.serve_batches
        totals["ingest_rejected"] = self.ingest_rejected
        totals["ingest_backpressure"] = self.batcher.backpressure_total
        totals["promotions"] = self.promotions
        totals["joins_deferred"] = len(self.batcher.deferred_joins)
        if self.elastic:
            totals["n_live"] = self._n_live()
        return totals

    def live_metrics(self) -> dict:
        """The ``kind="serve_live"`` row: rolling-window SLO + queue state,
        what the telemetry plane publishes (serve/telemetry.py)."""
        roll = self.slo.rolling()
        lat = roll["latency"]
        payload = {
            "batches": self.serve_batches,
            "window": roll["window"],
            "window_launches": roll["launches"],
            "window_events": roll["events"],
            "events_per_sec": roll["events_per_sec"],
            "backpressure": roll["backpressure"],
            "events_pending": len(self.batcher),
            "ingest_rejected": self.ingest_rejected,
            "latency_ms_p50": lat.get("p50", 0.0),
            "latency_ms_p95": lat.get("p95", 0.0),
            "latency_ms_p99": lat.get("p99", 0.0),
            "latency_ms_mean": lat.get("mean", 0.0),
        }
        if self.elastic:
            payload["n_alloc"] = self.spec.n_of(self.params)
            payload["n_live"] = self._n_live()
            payload["promotions"] = self.promotions
            payload["joins_deferred"] = len(self.batcher.deferred_joins)
        if self.state.trace is not None:
            for occ in trace_occupancy(self.state.trace):
                payload[f"trace_occupancy_shard{occ['shard']}"] = occ["cursor"]
                payload[f"trace_overflow_shard{occ['shard']}"] = occ["overflow"]
        return make_row("serve_live", payload, self.meta)

    def summary_row(self) -> dict:
        """The ``kind="serve"`` session row (bench + artifacts schema)."""
        lat = self.slo.session()["latency"]
        exec_s = max(self.slo.exec_s_total, 1e-9)
        payload = {
            "batches": self.serve_batches,
            "batch_ticks": self.batcher.n_ticks,
            "capacity": self.batcher.capacity,
            "ticks": self.ticks_run,
            "events_total": self.events_served,
            "events_pending": len(self.batcher),
            "ingest_overflow": self.batcher.overflow_total,
            "ingest_rejected": self.ingest_rejected,
            "ingest_backpressure": self.batcher.backpressure_total,
            "ingest_shed": self.batcher.shed_total,
            "max_pending": self.batcher.max_pending,
            "peak_pending": self.batcher.peak_pending,
            "overflow_policy": self.batcher.overflow_policy,
            "events_per_sec": self.events_served / exec_s,
            "member_rounds_per_sec": self.spec.n_of(self.params) * self.ticks_run / exec_s,
            "latency_ms_p50": lat.get("p50", 0.0),
            "latency_ms_p95": lat.get("p95", 0.0),
            "latency_ms_p99": lat.get("p99", 0.0),
            "latency_ms_mean": lat.get("mean", 0.0),
        }
        if self.elastic:
            payload["n_alloc"] = self.spec.n_of(self.params)
            payload["n_live"] = self._n_live()
            payload["promotions"] = self.promotions
            payload["join_ledger"] = self.batcher.join_ledger()
        if self.collect:
            payload["counters"] = self.counters()
        return make_row("serve", payload, self.meta)

    def close(self) -> dict:
        """Finalize: append the summary row and flush to ``export_path``."""
        summary = self.summary_row()
        self.rows.append(summary)
        if self.export_path:
            append_jsonl(self.export_path, self.rows)
        return summary
