"""Population statistics over an ensemble run — reduced on the traces'
device, then one transfer (port of scalecube_cluster_tpu/obs/ensemble.py).

An ensemble run (sim/ensemble.py) leaves its traces shaped ``[B, T]`` per
counter. The per-universe numbers a sweep reports — convergence times,
first-verdict latencies, counter totals — are reductions over the tick
axis, and the population shape over universes (CDF support, nearest-rank
percentiles, min/mean/max envelopes) is a reduction over the batch axis.
:func:`population_stats` does both where the traces live, so the host sees
B-sized vectors and a handful of scalars.

:func:`ensemble_report` is the full pipeline: the device stats and the
certifier's traces in a SINGLE read-back, the batched C1-C7 certifier
(testlib/invariants.py::certify_population) for the per-universe pass/fail
bitmap, and schema-versioned rows (obs/export.py) — one
``ensemble_population`` row plus one ``ensemble_universe`` row per
universe.

Float means follow the reference's XLA:CPU arithmetic (sim/tick.py::
xla_cpu_sum_f32 order, then a product with the float32 reciprocal of the
count), so the rows equal the reference's bit for bit.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from scalecube_cluster_tpu_torch.obs.export import make_row
from scalecube_cluster_tpu_torch.sim.tick import xla_cpu_sum_f32
from scalecube_cluster_tpu_torch.testlib.invariants import REQUIRED_KEYS, certify_population

#: Nearest-rank percentiles reported for every latency population.
QUANTILES = (0.5, 0.9, 0.99)

#: Per-tick counters whose per-universe TOTALS get population envelopes.
ENVELOPE_KEYS = (
    "link_attempts",
    "link_delivered",
    "fault_blocked",
    "fault_lost",
    "msgs_gossip",
    "msgs_fd",
    "msgs_sync",
    "pings",
    "acks",
    "suspicions_raised",
    "verdicts_dead",
)

#: Trace keys excluded from generic counter handling (not event counts).
_NON_COUNTER = ("tick", "convergence")

#: Per-zone gauges of a LinkWorld-bearing scheduled run (sim/topology.py
#: ``zone_tick_metrics``): ``[B, T, Z]`` in ensemble traces, each with a
#: per-zone population envelope.
ZONE_ENVELOPE_KEYS = (
    "zone_intra_conv",
    "zone_false_dead",
    "zone_intra_suspects",
)

_F32 = torch.float32
_I32 = torch.int32


def _tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))


def first_tick_where(mask) -> torch.Tensor:
    """``[B, T]`` bool -> ``[B]`` int32: the first tick where the condition
    holds per universe, ``-1`` where it never does."""
    mask = _tensor(mask)
    hit = mask.any(dim=1)
    idx = mask.to(torch.int8).argmax(dim=1).to(_I32)
    return torch.where(hit, idx, -1).to(_I32)


def masked_quantiles(x, valid, qs=QUANTILES) -> torch.Tensor:
    """Nearest-rank quantiles of ``x[valid]`` with no host round trip:
    invalid entries sort to ``+inf`` and ranks index only the first
    ``count(valid)`` slots. ``[len(qs)]`` float32, NaN when nothing is
    valid."""
    x, valid = _tensor(x), _tensor(valid)
    xf = torch.where(valid, x.to(_F32), torch.inf)
    s = torch.sort(xf).values
    cnt = valid.sum(dtype=_I32)
    picks = []
    for q in qs:
        rank = torch.ceil(q * cnt.to(_F32)).to(_I32) - 1
        rank = torch.clamp(rank, 0, x.shape[0] - 1)
        picks.append(torch.where(cnt > 0, s[rank.long()], torch.nan))
    return torch.stack(picks)


def _mean_f32(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``jnp.mean(x.astype(float32), axis=dim)`` as XLA:CPU gives it."""
    xf = x.to(_F32).movedim(dim, -1)
    count = torch.tensor(float(xf.shape[-1]), dtype=_F32, device=xf.device)
    return xla_cpu_sum_f32(xf) * torch.reciprocal(count)


def _envelope(x: torch.Tensor, dim: int) -> torch.Tensor:
    return torch.stack([
        x.amin(dim=dim).to(_F32), _mean_f32(x, dim), x.amax(dim=dim).to(_F32),
    ])


def population_stats(traces: dict) -> dict:
    """Population reductions over ``[B, T]`` ensemble traces, on their
    device. Emits, per available signal: ``convergence_time`` ``[B]``
    (the first tick FROM WHICH the universe stays fully converged, -1 if
    still unconverged at the end), ``convergence_time_sorted`` (the CDF
    support, never-converged universes last as T), ``convergence_time_q``,
    ``frac_converged`` and ``final_convergence``; ``first_<k>_tick`` and
    ``first_<k>_q`` for the suspicion and DEAD-verdict counters; per
    universe totals ``<k>_total``, envelopes ``<k>_env`` [3] and per-tick
    envelopes ``<k>_tick_env`` [3, T] for every :data:`ENVELOPE_KEYS`
    counter; and the per-zone envelopes of the zone gauges."""
    traces = {k: _tensor(v) for k, v in traces.items()}
    stats: dict = {}
    some = next(iter(traces.values()))
    t_len = some.shape[1]
    if "convergence" in traces:
        conv = traces["convergence"]
        bad = conv < 1.0
        any_bad = bad.any(dim=1)
        last_bad = t_len - 1 - torch.flip(bad, [1]).to(torch.int8).argmax(dim=1).to(_I32)
        settled = torch.where(any_bad, last_bad + 1, 0).to(_I32)
        reached = conv[:, -1] >= 1.0
        ct = torch.where(reached, settled, -1).to(_I32)
        stats["convergence_time"] = ct
        stats["convergence_time_sorted"] = torch.sort(torch.where(reached, ct, t_len)).values
        stats["convergence_time_q"] = masked_quantiles(ct, reached)
        stats["frac_converged"] = _mean_f32(reached, 0)
        stats["final_convergence"] = conv[:, -1]
    for key in ("suspicions_raised", "verdicts_dead"):
        if key in traces:
            ft = first_tick_where(traces[key] > 0)
            stats[f"first_{key}_tick"] = ft
            stats[f"first_{key}_q"] = masked_quantiles(ft, ft >= 0)
    for key in ENVELOPE_KEYS:
        arr = traces.get(key)
        if arr is None or arr.dim() != 2 or key in _NON_COUNTER:
            continue
        tot = arr.sum(dim=1, dtype=arr.dtype if arr.dtype != torch.bool else _I32)
        stats[f"{key}_total"] = tot
        stats[f"{key}_env"] = _envelope(tot, 0)
        stats[f"{key}_tick_env"] = _envelope(arr, 0)
    for key in ZONE_ENVELOPE_KEYS:
        arr = traces.get(key)
        if arr is None or arr.dim() != 3:
            continue
        if key == "zone_intra_conv":
            floor = arr.amin(dim=1)  # [B, Z]
            stats["zone_intra_conv_floor"] = floor
            stats["zone_intra_conv_floor_env"] = _envelope(floor, 0)
            continue
        tot = arr.sum(dim=1, dtype=arr.dtype)  # [B, Z]
        stats[f"{key}_total"] = tot
        stats[f"{key}_peak"] = arr.amax(dim=1)
        stats[f"{key}_env"] = _envelope(tot, 0)
    return stats


def _read_back(tree: dict) -> dict:
    """Every tensor of a nested dict to numpy in ONE device-to-host copy
    (packed as float64, exact for the int32 / float32 / bool leaves)."""
    leaves = []

    def walk(d, path):
        for k, v in d.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
            else:
                leaves.append((path + (k,), _tensor(v)))

    walk(tree, ())
    if not leaves:
        return {}
    dev = leaves[0][1].device
    packed = torch.cat(
        [t.reshape(-1).to(device=dev, dtype=torch.float64) for _, t in leaves]
    ).cpu().numpy()
    out: dict = {}
    off = 0
    for path, t in leaves:
        size = t.numel()
        dtype = {torch.bool: np.bool_, torch.int32: np.int32, torch.int64: np.int64,
                 torch.float32: np.float32, torch.int16: np.int16, torch.int8: np.int8,
                 torch.float64: np.float64}[t.dtype]
        arr = packed[off:off + size].astype(dtype).reshape(tuple(t.shape))
        off += size
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = arr
    return out


def ensemble_report(params, traces: dict, final_convergence=None, meta: dict | None = None,
                    certify: bool = True) -> dict:
    """Full population report for one ensemble run.

    ``params`` is the run's :class:`~..sim.params.SimParams` (sparse runs
    pass ``sparse_params.base``); ``traces`` the ``[B, T]`` trace dict
    (tensors or numpy); ``final_convergence`` an optional ``[B]``
    end-of-run convergence vector. Returns ``{"stats", "certification",
    "rows"}``: host-side stats arrays, the :func:`certify_population`
    verdict (None when ``certify`` is off or the event gauges are absent),
    and one ``ensemble_population`` row followed by B ``ensemble_universe``
    rows (NaN quantiles dropped)."""
    dev = {"stats": population_stats(traces)}
    certifiable = certify and all(k in traces for k in REQUIRED_KEYS)
    if certifiable:
        dev["cert_traces"] = {k: traces[k] for k in REQUIRED_KEYS}
    if final_convergence is not None:
        dev["final_convergence"] = final_convergence
    pulled = _read_back(dev)
    stats = pulled["stats"]

    b_count = None
    for v in traces.values():
        b_count = int(v.shape[0])
        break
    if b_count is None:
        raise ValueError("ensemble_report needs at least one trace")

    final_conv = pulled.get("final_convergence")
    if final_conv is None and "final_convergence" in stats:
        final_conv = stats["final_convergence"]

    cert = None
    if certifiable:
        cert = certify_population(params, pulled["cert_traces"], final_convergence=final_conv)

    agg: dict = {"universes": b_count}
    if "frac_converged" in stats:
        agg["frac_converged"] = float(stats["frac_converged"])
        for q, v in zip(QUANTILES, stats["convergence_time_q"]):
            agg[f"convergence_time_p{int(q * 100)}"] = float(v)
    if "first_verdicts_dead_q" in stats:
        for q, v in zip(QUANTILES, stats["first_verdicts_dead_q"]):
            agg[f"verdict_latency_p{int(q * 100)}"] = float(v)
    for key in ENVELOPE_KEYS:
        env = stats.get(f"{key}_env")
        if env is None:
            continue
        agg[f"{key}_total_min"] = float(env[0])
        agg[f"{key}_total_mean"] = float(env[1])
        agg[f"{key}_total_max"] = float(env[2])
    floor_env = stats.get("zone_intra_conv_floor_env")
    if floor_env is not None:
        for z in range(floor_env.shape[1]):
            agg[f"zone{z}_intra_conv_floor_min"] = float(floor_env[0][z])
        fd_env = stats.get("zone_false_dead_env")
        if fd_env is not None:
            for z in range(fd_env.shape[1]):
                agg[f"zone{z}_false_dead_total_max"] = float(fd_env[2][z])
        sp_peak = stats.get("zone_intra_suspects_peak")
        if sp_peak is not None:
            peaks = sp_peak.max(axis=0)
            for z in range(peaks.shape[0]):
                agg[f"zone{z}_intra_suspects_peak"] = float(peaks[z])
    if cert is not None:
        agg["pass_rate"] = float(np.mean(cert["ok"]))
        agg["failures"] = int(np.sum(~cert["ok"]))
    # NaN quantiles would serialise as bare `NaN`, not RFC-8259 JSON.
    agg = {k: v for k, v in agg.items() if not (isinstance(v, float) and math.isnan(v))}
    rows = [make_row("ensemble_population", agg, meta)]

    for b in range(b_count):
        payload: dict = {"universe": b}
        if "convergence_time" in stats:
            payload["convergence_time"] = int(stats["convergence_time"][b])
        if final_conv is not None:
            payload["final_convergence"] = float(np.asarray(final_conv)[b])
        if "first_verdicts_dead_tick" in stats:
            payload["first_verdict_tick"] = int(stats["first_verdicts_dead_tick"][b])
        for key in ("link_attempts", "suspicions_raised", "verdicts_dead"):
            tot = stats.get(f"{key}_total")
            if tot is not None:
                payload[f"{key}_total"] = int(tot[b])
        if cert is not None:
            payload["ok"] = bool(cert["ok"][b])
            violation = cert["violations"][b]
            if violation is not None:
                payload["violation"] = violation["invariant"]
        rows.append(make_row("ensemble_universe", payload, meta))

    return {"stats": stats, "certification": cert, "rows": rows}
