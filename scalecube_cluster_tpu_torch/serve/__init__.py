"""serve/ — streaming live-traffic bridge over the engines (port of
scalecube_cluster_tpu/serve/, solo serving).

Turns the sparse, elastic and Rapid engines into a digital-twin serving
system: join/leave/kill/restart/user-gossip traffic arrives from a live TCP
session (transport/tcp.py) or a deterministic JSONL trace replay
(ingest.py), is batched into fixed-shape per-tick event planes
(events.py::EventBatch — the live-traffic generalization of
sim/schedule.py's compact event encoding), and steps the engine ``k``
ticks per launch through a double-buffered pipeline (bridge.py). Verdict
and SLO-latency rows stream out through the schema-versioned exporter
(obs/export.py).

Correctness anchor: a trace replayed through the bridge is bit-identical
to the equivalent offline :class:`~scalecube_cluster_tpu_torch.sim.schedule.FaultSchedule`
run — the event masks are value-equal and mask application consumes no
RNG, so the trajectories cannot diverge.

The engine-agnostic contract lives in spec.py (:class:`EngineSpec`), and
the multi-tenant fleet control plane in fleet.py (:class:`FleetBridge` — B
tenant universes stepped together on the ensemble axis, one fused-core
launch a tick for a pool, with the same bit-parity anchor per tenant
against its solo replay).
"""

from scalecube_cluster_tpu_torch.serve.bridge import ServeBridge
from scalecube_cluster_tpu_torch.serve.engine import (
    run_fleet_rapid_serve_batch,
    run_fleet_serve_batch,
    run_fleet_serve_batch_elastic,
    run_rapid_serve_batch,
    run_serve_batch,
)
from scalecube_cluster_tpu_torch.serve.events import (
    EV_GOSSIP,
    EV_JOIN,
    EV_KILL,
    EV_RESTART,
    EventBatch,
    event_masks,
    event_masks_rapid,
    stack_batches,
)
from scalecube_cluster_tpu_torch.serve.fleet import (
    FleetBridge,
    FleetPool,
    TenantRouter,
    TenantSession,
)
from scalecube_cluster_tpu_torch.serve.ingest import (
    BATCHER_ENGINES,
    OVERFLOW_POLICIES,
    SERVE_QUALIFIER,
    BatcherFull,
    EventBatcher,
    ServeEvent,
    TcpEventSource,
    event_from_message,
    load_trace,
    parse_trace_line,
)
from scalecube_cluster_tpu_torch.serve.spec import (
    ENGINE_SPECS,
    EngineSpec,
    register_engine_spec,
    resolve_engine_spec,
)

__all__ = [
    "BATCHER_ENGINES",
    "ENGINE_SPECS",
    "EV_GOSSIP",
    "EV_JOIN",
    "EV_KILL",
    "EV_RESTART",
    "BatcherFull",
    "EngineSpec",
    "EventBatch",
    "EventBatcher",
    "FleetBridge",
    "FleetPool",
    "OVERFLOW_POLICIES",
    "SERVE_QUALIFIER",
    "ServeBridge",
    "ServeEvent",
    "TcpEventSource",
    "TenantRouter",
    "TenantSession",
    "event_from_message",
    "event_masks",
    "event_masks_rapid",
    "load_trace",
    "parse_trace_line",
    "register_engine_spec",
    "resolve_engine_spec",
    "run_fleet_rapid_serve_batch",
    "run_fleet_serve_batch",
    "run_fleet_serve_batch_elastic",
    "run_rapid_serve_batch",
    "run_serve_batch",
    "stack_batches",
]
