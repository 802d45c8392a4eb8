"""The BASELINE.json experiment grid as reproducible sim scenarios (port of
scalecube_cluster_tpu/experiments/scenarios.py).

BASELINE.json names five configs; the first (3-node Alice/Bob/Carol join
over real sockets) belongs to the host backend, the other four run here on
the dense engine, and two more drive the sparse engine at its one-card
scale:

1. ``join_scenario``               — cold join of n members to s seeds
2. ``lossy_suspicion_scenario``    — steady state under packet loss, counting
   false deaths and refutations (1k @ 5% loss config)
3. ``partition_recovery_scenario`` — network partition, suspicion-timeout
   removal, SYNC anti-entropy heal (10k partition config)
4. ``churn_benchmark``             — sustained join/leave churn per tick
   (100k-member churn config; rate and n scale to the hardware)
5. ``sparse_scale_scenario``       — failure detection on the sparse engine
6. ``sparse_churn_scenario``       — slot-table pressure under churn

Each returns a metrics dict of plain floats/ints, equal to the reference's
on the same arguments apart from ``member_rounds_per_sec`` (host wall
clock around synchronised device work); ``run_all`` executes a grid and
prints one JSON line per scenario. Every scenario takes ``device``
(default ``"cuda"``).
"""

from __future__ import annotations

import json
import time

import numpy as np
import torch

from scalecube_cluster_tpu_torch.cluster_api.member import MemberStatus
from scalecube_cluster_tpu_torch.ops.merge import decode_status
from scalecube_cluster_tpu_torch.sim.faults import FaultPlan
from scalecube_cluster_tpu_torch.sim.params import SimParams
from scalecube_cluster_tpu_torch.sim.run import run_chunked, run_ticks
from scalecube_cluster_tpu_torch.sim.schedule import ScheduleBuilder
from scalecube_cluster_tpu_torch.sim.sparse import (
    SparseParams,
    init_sparse_full_view,
    kill_sparse,
    restart_many_sparse,
    run_sparse_chunked,
)
from scalecube_cluster_tpu_torch.sim.state import (
    init_full_view,
    init_seeded,
    kill,
    restart,
    seeds_mask,
)

_ALIVE = int(MemberStatus.ALIVE)
_DEAD = int(MemberStatus.DEAD)
_UNKNOWN = int(MemberStatus.UNKNOWN)


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _final(traces, key):
    return float(_host(traces[key])[-1])


def _frac(mask: torch.Tensor, alive: torch.Tensor) -> float:
    """``sum(mask) / sum(alive)`` as the reference's int32 / int32 true
    division: float32 operands, a float32 quotient."""
    num = mask.sum(dtype=torch.int32).to(torch.float32)
    return float(num / alive.sum(dtype=torch.int32).to(torch.float32))


def join_scenario(n: int = 100, n_seeds: int = 1, max_ticks: int = 400,
                  device="cuda") -> dict:
    """Cold join: all members discover each other from the seeds."""
    params = SimParams.from_cluster_config(n)
    state = init_seeded(n, list(range(n_seeds)), device=device)
    plan = FaultPlan.clean(n, device=device)
    seeds = seeds_mask(n, list(range(n_seeds)), device=device)
    state, traces = run_chunked(params, state, plan, seeds, max_ticks)
    conv = traces["convergence"]
    full = np.flatnonzero(conv >= 1.0)
    return {
        "scenario": "join",
        "n": n,
        "converged": bool(full.size),
        "ticks_to_full_view": int(full[0]) if full.size else None,
        "final_convergence": float(conv[-1]),
    }


def lossy_suspicion_scenario(
    n: int = 1000, loss_percent: float = 5.0, ticks: int = 600, device="cuda"
) -> dict:
    """Steady state under loss: suspicion churn must refute, never kill."""
    params = SimParams.from_cluster_config(n)
    state = init_full_view(n, device=device)
    plan = FaultPlan.clean(n, device=device).with_loss(loss_percent)
    state, traces = run_chunked(
        params, state, plan, seeds_mask(n, [0], device=device), ticks
    )
    status_dead_of_alive = torch.sum(
        (decode_status(state.view) == _DEAD)
        & state.alive[None, :]
        & state.alive[:, None]
    )
    return {
        "scenario": "lossy_suspicion",
        "n": n,
        "loss_percent": loss_percent,
        "final_convergence": _final(traces, "convergence"),
        "suspects_in_flight": int(_final(traces, "n_suspected")),
        "false_deaths": int(status_dead_of_alive),
        "refutations_max_incarnation": int(state.inc_self.max()),
    }


def partition_recovery_scenario(n: int = 1000, minority_frac: float = 0.3,
                                device="cuda") -> dict:
    """Partition → suspicion-timeout removal → SYNC heal after reconnection.

    The cut and the heal are segments of ONE :class:`FaultSchedule`
    (sim/schedule.py), so the whole scenario is a single ``run_chunked``
    call. Detection is read off the collected traces: with every
    cross-partition cell non-ALIVE the convergence metric sits exactly on
    the partition floor ``(k² + (n-k)²)/n²`` (each side matches only
    itself), and ``n_suspected == 0`` certifies the cells have progressed
    past SUSPECT to DEAD/UNKNOWN.
    """
    params = SimParams.from_cluster_config(n)
    k = int(n * minority_frac)
    side_a, side_b = list(range(k)), list(range(k, n))
    state = init_full_view(n, device=device)
    seeds = seeds_mask(n, [0, n - 1], device=device)  # a seed on each side
    cut = FaultPlan.clean(n, device=device).partition(side_a, side_b)

    # Cushion past the suspicion timeout: suspicion acceptance has a straggler
    # tail (~2×spread, re-originated by each prober), then DEAD tombstones
    # circulate for up to a sweep before expiring.
    hold = (
        params.suspicion_ticks
        + 2 * params.periods_to_spread
        + params.periods_to_sweep
        + 150
    )
    heal = params.sync_period_ticks * 3 + 200
    schedule = (
        ScheduleBuilder(n)
        .add_segment(0, cut)  # ticks 1..hold (global tick starts at 1)
        .add_segment(hold + 1, FaultPlan.clean(n, device=device))
        .build()
    )
    state, traces = run_chunked(params, state, schedule, seeds, hold + heal)
    conv = traces["convergence"]
    n_susp = traces["n_suspected"]
    floor = (k * k + (n - k) * (n - k)) / (n * n)
    detected = bool(conv[hold - 1] <= floor + 1e-6 and n_susp[hold - 1] == 0)
    return {
        "scenario": "partition_recovery",
        "n": n,
        "minority": k,
        "partition_detected": detected,
        "healed_convergence": float(conv[-1]),
    }


def churn_benchmark(
    n: int = 4096, churn_per_chunk: int = 8, ticks: int = 400, seed: int = 0,
    device="cuda",
) -> dict:
    """Sustained churn: every 20-tick chunk, kill ``churn_per_chunk`` members
    and restart half as many (the BASELINE churn config scaled to hardware)."""
    params = SimParams.from_cluster_config(n)
    state = init_full_view(n, seed=seed, device=device)
    plan = FaultPlan.clean(n, device=device)
    seeds = seeds_mask(n, [0, 1], device=device)
    rng = np.random.default_rng(seed)
    chunk = 20
    if ticks < chunk:
        raise ValueError(f"ticks must be >= {chunk}")
    down: set[int] = set()
    for _ in range(ticks // chunk):
        kills = rng.choice(
            [i for i in range(2, n) if i not in down],
            size=churn_per_chunk,
            replace=False,
        )
        state = kill(state, torch.as_tensor(kills, device=device))
        down.update(int(i) for i in kills)
        revive = [i for i in list(down)[: churn_per_chunk // 2]]
        for i in revive:
            state = restart(state, i)
            down.discard(i)
        state, traces = run_ticks(params, state, plan, seeds, chunk)
    return {
        "scenario": "churn",
        "n": n,
        "churned_down": len(down),
        "final_convergence": _final(traces, "convergence"),
        "max_epoch": int(state.epoch.max()),
    }


def col_status(state, j: int) -> torch.Tensor:
    """Subject ``j``'s status as every viewer holds it, read through the
    slab indirection: ``[N]``-sized, where the effective view would be an
    ``[N, N]`` temporary (4 GiB of int32 at n=32768). No host read."""
    s = state.subj_slot[j]
    col = torch.where(
        s >= 0, state.slab[:, torch.clamp_min(s, 0).long()], state.view_T[j, :]
    )
    return decode_status(col)


def sparse_scale_scenario(
    n: int = 32768, ticks_per_phase: int | None = None, device="cuda"
) -> dict:
    """Failure detection at the sparse engine's one-card scale: kill one
    member of an n-member cluster, drive until every live viewer holds
    SUSPECT, then until suspicion expires it DEAD/UNKNOWN."""
    params = SparseParams.for_n(n, in_scan_writeback=False)
    p = params.base
    state = kill_sparse(init_sparse_full_view(n, params.slot_budget, device=device), 7)
    plan = FaultPlan.uniform(loss_percent=5.0, device=device)

    chunk = 48

    def ceil_chunks(ticks):
        # Whole chunks only, as the reference (whose scan length is static).
        return -(-ticks // chunk) * chunk

    # Warmup chunk: advances the protocol — its ticks count toward phase 1,
    # its wall time does not count toward throughput (steady-state chunks
    # only). The large-buffer element read is the host sync.
    state, _ = run_sparse_chunked(params, state, plan, chunk, chunk=chunk)
    col_status(state, 7)
    int(state.view_T[0, 0])
    t0 = time.perf_counter()
    phase1 = max(
        ceil_chunks(ticks_per_phase or (p.fd_period_ticks * 8 + p.periods_to_spread))
        - chunk,
        chunk,
    )
    state, traces = run_sparse_chunked(params, state, plan, phase1, chunk=chunk)
    dead_col = col_status(state, 7)
    suspected = _frac((dead_col != _ALIVE) & state.alive, state.alive)
    phase2 = ceil_chunks(
        ticks_per_phase or (p.suspicion_ticks + p.periods_to_sweep + 60)
    )
    state, traces = run_sparse_chunked(params, state, plan, phase2, chunk=chunk)
    int(state.view_T[0, 0])
    dt = time.perf_counter() - t0
    dead_col = col_status(state, 7)
    removed = _frac(
        ((dead_col == _DEAD) | (dead_col == _UNKNOWN)) & state.alive, state.alive
    )
    total_ticks = phase1 + phase2  # timed ticks only (warmup excluded)
    return {
        "scenario": "sparse_scale_failure",
        "n": n,
        "suspected_frac_after_spread": round(suspected, 4),
        "removed_frac_after_timeout": round(removed, 4),
        "active_slots": int(torch.sum(state.slot_subj >= 0)),
        "member_rounds_per_sec": round(n * total_ticks / dt, 1),
    }


def sparse_churn_scenario(
    n: int = 32768,
    churn_per_chunk: int = 256,
    ticks: int = 480,
    chunk: int = 48,
    seed: int = 0,
    device="cuda",
) -> dict:
    """Sustained churn on the sparse engine, measuring the working set's
    behavior under pressure: ``slot_overflow`` (activation requests dropped
    because the slot table was full — the engine's documented
    bounded-memory deviation) and final slot occupancy. Kills/restarts land
    at chunk boundaries (host fault control), like the dense churn bench.
    """
    params = SparseParams.for_n(n, in_scan_writeback=False)
    state = init_sparse_full_view(n, params.slot_budget, device=device)
    plan = FaultPlan.uniform(loss_percent=1.0, device=device)
    rng = np.random.default_rng(seed)
    down: set[int] = set()
    max_overflow = 0.0
    sum_overflow = 0.0
    chunks = 0
    # Warmup chunk outside the timed region. The kill/restart host ops
    # between chunks are likewise excluded — only tick throughput is
    # reported; dt accumulates around the chunk runs alone.
    state, _ = run_sparse_chunked(params, state, plan, chunk, chunk=chunk)
    int(state.view_T[0, 0])
    dt = 0.0
    for _ in range(max(1, ticks // chunk)):
        kills = rng.choice(
            [i for i in range(2, n) if i not in down],
            size=churn_per_chunk,
            replace=False,
        )
        state = kill_sparse(state, kills)
        down.update(int(i) for i in kills)
        revive = list(down)[: churn_per_chunk // 2]
        state = restart_many_sparse(state, revive)
        down.difference_update(revive)
        int(state.view_T[0, 0])  # settle host ops before the timed chunk
        t0 = time.perf_counter()
        state, traces = run_sparse_chunked(params, state, plan, chunk, chunk=chunk)
        int(state.view_T[0, 0])  # large-buffer sync
        dt += time.perf_counter() - t0
        overflow = traces["slot_overflow"]
        max_overflow = max(max_overflow, float(overflow.max()))
        sum_overflow += float(overflow.sum())
        chunks += 1
    return {
        "scenario": "sparse_churn",
        "n": n,
        "churn_per_chunk": churn_per_chunk,
        "ticks": chunks * chunk,
        "churned_down": len(down),
        "slot_overflow_max_per_tick": max_overflow,
        "slot_overflow_total": sum_overflow,
        "active_slots": int(torch.sum(state.slot_subj >= 0)),
        "slot_budget": params.slot_budget,
        "member_rounds_per_sec": round(n * chunks * chunk / dt, 1),
    }


def grid(scale: str = "small", device="cuda") -> list:
    """The grid's scenarios as ``(name, call)`` pairs. ``small`` is the
    CPU-sized grid; ``large`` the one-card widths."""
    if scale not in ("small", "large"):
        raise ValueError(f"unknown scale {scale!r}; use 'small' or 'large'")
    d = {"device": device}
    if scale == "small":
        return [
            ("join", lambda: join_scenario(n=100, **d)),
            ("lossy_suspicion", lambda: lossy_suspicion_scenario(n=256, ticks=300, **d)),
            ("partition_recovery", lambda: partition_recovery_scenario(n=256, **d)),
            ("churn", lambda: churn_benchmark(n=256, churn_per_chunk=2, ticks=200, **d)),
            ("sparse_scale_failure", lambda: sparse_scale_scenario(n=256, **d)),
            ("sparse_churn",
             lambda: sparse_churn_scenario(n=256, churn_per_chunk=8, ticks=96, **d)),
        ]
    return [
        ("join", lambda: join_scenario(n=1000, **d)),
        ("lossy_suspicion", lambda: lossy_suspicion_scenario(n=1000, **d)),
        ("partition_recovery", lambda: partition_recovery_scenario(n=10_000, **d)),
        ("churn", lambda: churn_benchmark(n=8192, churn_per_chunk=16, **d)),
        ("sparse_scale_failure", lambda: sparse_scale_scenario(n=32768, **d)),
        ("sparse_churn",
         lambda: sparse_churn_scenario(n=32768, churn_per_chunk=256, **d)),
    ]


def run_all(scale: str = "small", device="cuda") -> list[dict]:
    """Run the grid. ``scale``: small (CPU-sized), large (one card)."""
    results = []
    for _, fn in grid(scale, device=device):
        result = fn()
        print(json.dumps(result))
        results.append(result)
    return results
