"""Observability of the port (twin of scalecube_cluster_tpu/obs/): the
shared counter schema (``counters``), detection latencies (``latency``),
rolling SLO windows (``slo``), profiler scopes (``profiling``), the
schema-versioned row exporter (``export``), and the causal flight
recorder — its device ring (``tracer``) and its host-side decoder
(``trace``) — and the ensembles' population report (``ensemble``). Each
module is a copy of the JAX package's, held against it by the tests."""

from scalecube_cluster_tpu_torch.obs.counters import SHARED_COUNTERS, ProtocolCounters
from scalecube_cluster_tpu_torch.obs.export import (
    SCHEMA_VERSION,
    append_jsonl,
    jsonl_line,
    make_row,
    prometheus_text,
    run_metadata,
    write_prometheus,
)
from scalecube_cluster_tpu_torch.obs.latency import detection_latencies, latency_histogram
from scalecube_cluster_tpu_torch.obs.profiling import trace_scope
from scalecube_cluster_tpu_torch.obs.trace import (
    DEAD_VIA_EXPIRY,
    DEAD_VIA_GOSSIP,
    TK_NAMES,
    chrome_trace,
    load_events_jsonl,
    ring_events,
    ring_overflow,
    write_chrome_trace,
    write_events_jsonl,
)
from scalecube_cluster_tpu_torch.obs.tracer import TraceRing, init_trace_ring

__all__ = [
    "DEAD_VIA_EXPIRY",
    "DEAD_VIA_GOSSIP",
    "SCHEMA_VERSION",
    "SHARED_COUNTERS",
    "TK_NAMES",
    "ProtocolCounters",
    "TraceRing",
    "append_jsonl",
    "chrome_trace",
    "detection_latencies",
    "init_trace_ring",
    "jsonl_line",
    "latency_histogram",
    "load_events_jsonl",
    "make_row",
    "prometheus_text",
    "ring_events",
    "ring_overflow",
    "run_metadata",
    "trace_scope",
    "write_chrome_trace",
    "write_events_jsonl",
    "write_prometheus",
]
