"""Detection-latency extraction from the sparse engine's verdict recorder
(the port's copy of scalecube_cluster_tpu/obs/latency.py; numpy only:
tensors, on the card or not, are copied to the host first).

When ``init_sparse_full_view(..., record_latency=True)``, the sparse state
carries two per-member int32 arrays — ``lat_first_suspect`` / ``lat_first_dead``
— holding the first tick at which any live viewer's working set held a
SUSPECT / DEAD record for that member (-1 = never). Rapid (PAPERS.md) makes
detection latency the headline evaluation metric; these helpers turn the raw
tick arrays into per-event latencies and histograms without re-running the
simulation.
"""

from __future__ import annotations

import numpy as np


def _host(x) -> np.ndarray:
    """``x`` as a numpy array; a tensor is copied to the host first."""
    return np.asarray(x.cpu() if hasattr(x, "cpu") else x)


def detection_latencies(state, kill_ticks) -> dict:
    """Latency (in ticks) from each member's kill to first-suspect/first-dead.

    ``kill_ticks`` maps member index -> tick the member was killed (a dict,
    or an array with -1 for never-killed members). Members whose recorder
    entry predates their kill (stale from an earlier life; the recorder is
    reset on restart) or never fired are skipped.
    """
    first_suspect = _host(state.lat_first_suspect)
    first_dead = _host(state.lat_first_dead)
    n = first_suspect.shape[0]
    if isinstance(kill_ticks, dict):
        kt = np.full((n,), -1, np.int64)
        for i, t in kill_ticks.items():
            kt[int(i)] = int(t)
    else:
        kt = _host(kill_ticks).astype(np.int64)
    killed = kt >= 0
    sus_ok = killed & (first_suspect >= kt)
    dead_ok = killed & (first_dead >= kt)
    return {
        "suspect_latency": (first_suspect - kt)[sus_ok].astype(np.int64),
        "dead_latency": (first_dead - kt)[dead_ok].astype(np.int64),
        "n_killed": int(killed.sum()),
        "n_suspected": int(sus_ok.sum()),
        "n_dead_detected": int(dead_ok.sum()),
    }


def percentile_summary(
    values, percentiles: tuple[float, ...] = (50.0, 95.0, 99.0)
) -> dict:
    """p50/p95/p99-style summary of a float sample, JSON-serializable.

    The serving bridge's SLO rollup (serve/bridge.py feeds per-batch
    ingest→verdict wall-clock milliseconds); shape-agnostic, so any
    latency-like sample works. Empty input returns ``{"count": 0}`` so
    callers can merge it into a row unconditionally.
    """
    vals = np.asarray(list(values), np.float64)
    if vals.size == 0:
        return {"count": 0}
    out = {
        "count": int(vals.size),
        "mean": float(vals.mean()),
        "max": float(vals.max()),
    }
    for p in percentiles:
        label = int(p) if float(p).is_integer() else p
        out[f"p{label}"] = float(np.percentile(vals, p))
    return out


def latency_histogram(latencies: np.ndarray, n_bins: int = 16) -> dict:
    """Histogram + summary stats for one latency array, JSON-serializable."""
    lat = np.asarray(latencies, np.int64)
    if lat.size == 0:
        return {"count": 0, "bin_edges": [], "bin_counts": []}
    counts, edges = np.histogram(lat, bins=min(n_bins, max(1, int(lat.max()) + 1)))
    return {
        "count": int(lat.size),
        "mean": float(lat.mean()),
        "p50": float(np.percentile(lat, 50)),
        "p99": float(np.percentile(lat, 99)),
        "max": int(lat.max()),
        "bin_edges": [float(e) for e in edges],
        "bin_counts": [int(c) for c in counts],
    }
