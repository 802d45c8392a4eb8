"""The port's benches of the two engines' main paths (the twins of the JAX
package's ``bench.py::_measure_sparse``, ladder rung 1, and
``bench.py::_measure_dense``, its rung ``("dense", 10240, None)``) and of
the persistent sparse core's k-sweep.

Sparse: ``SparseParams.for_n(n, slot_budget, in_scan_writeback=False,
pallas_core=True)`` (the fused kernel on every tick, the whole fold) with
the LAN preset, ``init_sparse_full_view`` then ``kill_sparse(…, 7)``,
and ``run_sparse_chunked`` over ``FaultPlan.uniform(5.0)`` in 48-tick
chunks with ``collect=False`` and a host-boundary write-back per chunk.

Dense: ``SimParams.from_cluster_config(n)`` with ``pallas_delivery=True``
(the fused tick-core kernel), ``init_full_view`` then ``kill(…, 7)``, seeds
``[0, 1]``, and ``run_ticks`` over ``FaultPlan.uniform(5.0)`` in 40-tick
chunks with ``collect=False``.

One chunk warms up; ``reps`` chunks are timed, each ending in a host fetch
from the large view table, which waits for the whole chunk.

Geo (``bench.py::_measure_geo``, ``--geo [n]``, default n=1024): the dense
engine (LAN preset, XLA core) under a one-segment ``FaultSchedule`` of
``FaultPlan.uniform(5.0)`` with a 2-zone ``LinkWorld`` whose cross-zone
latency is 400 ms, timed like the dense rung; the row also carries its
flat-world twin (the same schedule without the world), ``flat_value``, and
``geo_overhead`` = flat / geo (:func:`measure_geo`).

Tracer (``bench.py::_measure_tracer_overhead``, ``--tracer-overhead [n]``,
default n=4096): the sparse engine on the XLA chain (``SparseParams.for_n``,
in-tick write-back) under a churn schedule (5% loss, kills at ticks 3 and
5, a restart at 25), one warm-up and ``reps`` timed 48-tick chunks, run
without and then with the flight recorder; ``tracer_overhead`` = on / off
wall (:func:`measure_tracer_overhead`).

Persistent (``bench.py::_measure_persistent_ksweep``, ``python bench.py
--persistent-ksweep [n] [k_max]``): the persistent k-tick sparse core
(``ops/sparse_persistent.py``) swept over launch depth k = 1..k_max on one
build, over the seeded operands of the JAX rung (:func:`measure_persistent_ksweep`).

Ensemble (``bench.py::_measure_ensemble``, ``--ensemble B [n]``, default
n=1024): B dense universes (LAN preset, XLA core as there) under B uniform
5%-loss plans, seeds ``[0, 1]``, stepped together by sim/ensemble.py — one
warm-up and ``reps`` timed 40-tick chunks (collect=False, each ending in a
fetch from the stacked view); the value is universes·member·rounds/s
(:func:`measure_ensemble`). ``--profile`` works on it as on the engines.

Rapid (``bench.py::_measure_rapid``, ``--rapid [n]``, default n=1024):
the consistent-membership engine (sim/rapid.py) with ``RapidParams(n)``
under ``FaultPlan.uniform(5.0)``, collect=False, one warm-up and ``reps``
timed 40-tick chunks, each ending in a fetch from ``member_mask``; the row
adds the peak device memory and the synchronising CUDA calls a tick of one
more chunk (:func:`measure_rapid`). ``--profile`` works on it.

Serving (``bench.py::_measure_serve``, ``_measure_grow``, ``_measure_load``):
``--serve [n]`` (default 4096) replays a user-gossip stream through the
serving bridge (serve/bridge.py) over the one-kill, 5%-loss trajectory and
prints the bridge's ``kind="serve"`` row (:func:`measure_serve`);
``--grow [n0] [tiers]`` (default 64, 2) grows an elastic session through
checkpoint-based promotions and prints the ``kind="grow"`` row
(:func:`measure_grow`); ``--load [producers] [n]`` (default 32, 1024) runs
the wire load harness (serve/load.py) and prints its ``kind="load"`` audit
row (:func:`measure_load`). Each takes the reference's defaults; the
measuring functions also take ``pallas_core``, ``slot_budget``,
``batch_ticks`` and ``capacity`` as keywords.

Run on a CUDA card: ``python -m scalecube_cluster_tpu_torch.bench
[--engine sparse|dense] [n] [S] [--runs K]`` (or ``--geo [n]``, or
``--tracer-overhead [n] [S]``) prints one JSON line per run of ``CLI_REPS``
timed chunks; ``--profile`` instead prints where a tick's time goes
(:func:`profile_sparse`, :func:`profile_dense`). ``--engine persistent [n]
[S] [--k-max K]`` prints one JSON row per k. Every line is a row of
obs/export.py (``make_row``: schema version, kind, run metadata). There is
no CPU fallback for the measurement.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import statistics
import sys
import time

import torch

from scalecube_cluster_tpu_torch.obs.export import jsonl_line, make_row, run_metadata
from scalecube_cluster_tpu_torch.obs.trace import ring_overflow
from scalecube_cluster_tpu_torch.ops import sparse_persistent
from scalecube_cluster_tpu_torch.ops.sparse_core import sparse_core
from scalecube_cluster_tpu_torch.ops.tick_core import tick_core
from scalecube_cluster_tpu_torch.sim import state as dense
from scalecube_cluster_tpu_torch.sim.ensemble import (
    init_ensemble_dense,
    run_ensemble_ticks,
    stack_universes,
)
from scalecube_cluster_tpu_torch.sim.faults import FaultPlan
from scalecube_cluster_tpu_torch.sim.params import SimParams
from scalecube_cluster_tpu_torch.sim.rapid import RapidParams, init_rapid_full_view, run_rapid_ticks
from scalecube_cluster_tpu_torch.sim.run import run_ticks
from scalecube_cluster_tpu_torch.sim.schedule import ScheduleBuilder
from scalecube_cluster_tpu_torch.sim.topology import LinkWorld
from scalecube_cluster_tpu_torch.sim.sparse import (
    SparseParams,
    SparseState,
    init_sparse_full_view,
    kill_sparse,
    run_sparse_chunked,
    run_sparse_ticks,
)
from scalecube_cluster_tpu_torch.testing import persistent_operands

#: Timed chunks per command-line run: 768 sparse ticks (640 dense), long
#: enough to cross the SYNC ticks and many write-backs; the host-bound
#: sparse wall still spreads by up to a quarter between runs (PERF.md §2).
CLI_REPS = 16
#: The JAX bench's yardstick for ``vs_baseline`` (bench.py), 1e6
#: member·rounds/s.
BASELINE_MEMBER_ROUNDS_PER_SEC = 1_000_000.0
#: Peak working set of the sparse bench trajectory at n=32768
#: (bench.py::_BENCH_PEAK_SLOTS_32768), which sizes the rung's slab width.
_BENCH_PEAK_SLOTS_32768 = 455


def rung_slot_budget(n: int) -> int:
    """The JAX bench's rule-sized slab width (bench.py::_rung_slot_budget):
    the peak working set scaled linearly in n, a 12.5% burst margin, up to
    a multiple of 128, at least 256 — 512 at n=32768."""
    peak = _BENCH_PEAK_SLOTS_32768 * n / 32768.0
    return max(128 * math.ceil(peak * 1.125 / 128.0), 256)


def _warm_main_path(n: int, slot_budget: int, chunk: int):
    """The main path's set-up on the card, seed 0: params, the killed-member
    state after one warm-up chunk, and the 5%-loss plan."""
    params = SparseParams.for_n(
        n, slot_budget=slot_budget, in_scan_writeback=False, pallas_core=True
    )
    state = kill_sparse(init_sparse_full_view(n, params.slot_budget, device="cuda"), 7)
    plan = FaultPlan.uniform(loss_percent=5.0, device="cuda")
    state, _ = run_sparse_chunked(params, state, plan, chunk, chunk, collect=False)
    int(state.view_T[0, 0])
    return params, state, plan


def measure_sparse(n: int = 32768, slot_budget: int = 512, chunk: int = 48, reps: int = 4):
    """Drive the main path: 1 warm-up chunk + ``reps`` timed chunks.

    Returns ``(row, state)``: ``row`` holds ``member_rounds_per_s``,
    ``ms_per_tick`` (timed chunks only), ``chunk_ms_per_tick`` (each timed
    chunk) and its median, ``chunk_thread_cpu_ms_per_tick`` (the calling
    thread's CPU time in each timed chunk: near the wall time when the
    host's launch work is what the chunk waits on) and ``launches``
    (sparse-core kernel launches over warm-up and timed chunks); ``state``
    is the final state, for callers that go on driving it."""
    launches0 = sparse_core.launches
    params, state, plan = _warm_main_path(n, slot_budget, chunk)
    per_chunk, per_chunk_cpu = [], []
    for _ in range(reps):
        t0, c0 = time.perf_counter(), time.thread_time()
        state, _ = run_sparse_chunked(params, state, plan, chunk, chunk, collect=False)
        int(state.view_T[0, 0])
        per_chunk.append(time.perf_counter() - t0)
        per_chunk_cpu.append(time.thread_time() - c0)
    dt = sum(per_chunk)
    ticks = reps * chunk
    row = {
        "n": n,
        "slot_budget": params.slot_budget,
        "chunk": chunk,
        "timed_ticks": ticks,
        "member_rounds_per_s": n * ticks / dt,
        "ms_per_tick": dt * 1e3 / ticks,
        "median_chunk_ms_per_tick": statistics.median(per_chunk) * 1e3 / chunk,
        "chunk_ms_per_tick": [c * 1e3 / chunk for c in per_chunk],
        "chunk_thread_cpu_ms_per_tick": [c * 1e3 / chunk for c in per_chunk_cpu],
        "launches": sparse_core.launches - launches0,
    }
    return row, state


def _clone_state(state: SparseState) -> SparseState:
    """A copy that shares no storage (the tick updates ``view_T`` and the
    slab in place)."""
    return dataclasses.replace(state, **{
        f.name: getattr(state, f.name).clone()
        for f in dataclasses.fields(state)
        if isinstance(getattr(state, f.name), torch.Tensor)
    })


def _device_profile(run, ticks: int) -> dict:
    """Run ``run()`` (``ticks`` ticks) twice: untraced for the wall time,
    then under ``torch.profiler`` (device activity only) for the device
    busy time, launches and device time by kernel name. The profiler slows
    the host, so the idle share is the traced busy time against the
    untraced wall of the same ticks. ``run`` must start from the same
    state both times."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run(0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run(1)
        torch.cuda.synchronize()
    wall_traced = time.perf_counter() - t0
    spans = sorted(
        (e.time_range.start, e.time_range.end, e.name)
        for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA
    )
    if not spans:
        raise RuntimeError("profiler recorded no device activity")
    busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for s0, e0, _ in spans[1:]:
        if s0 > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s0, e0
        else:
            cur_e = max(cur_e, e0)
    busy += cur_e - cur_s
    # Kernels are grouped by the first 160 characters of their names (a
    # template's functor and dtype fit in them), summed within a group.
    by_name: dict = {}
    for s0, e0, name in spans:
        tot, cnt = by_name.get(name[:160], (0.0, 0))
        by_name[name[:160]] = (tot + (e0 - s0), cnt + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:16]
    return {
        "ticks": ticks,
        "wall_ms_per_tick": wall * 1e3 / ticks,
        "traced_wall_ms_per_tick": wall_traced * 1e3 / ticks,
        "device_busy_ms_per_tick": busy / 1e3 / ticks,
        "device_idle_share": 1.0 - (busy / 1e3) / (wall * 1e3),
        "device_launches_per_tick": len(spans) / ticks,
        "top_device_ms_per_tick": {
            name: [tot / 1e3 / ticks, cnt / ticks] for name, (tot, cnt) in top
        },
    }


def profile_sparse(n: int = 32768, slot_budget: int = 512, ticks: int = 48, chunk: int = 48):
    """Where the sparse main path's time goes on the card: after one
    warm-up chunk, the same ``ticks`` ticks (collect=False, no write-back
    inside) from one snapshot of the state, untraced and traced
    (:func:`_device_profile`)."""
    params, state, plan = _warm_main_path(n, slot_budget, chunk)
    first_tick = state.t_host + 1
    states = [state, _clone_state(state)]

    def run(i):
        run_sparse_ticks(params, states[i], plan, ticks, collect=False)

    row = {"n": n, "slot_budget": params.slot_budget, "first_tick": first_tick}
    row.update(_device_profile(run, ticks))
    return row


def _dense_main_path(n: int, chunk: int):
    """The dense main path's set-up on the card, seed 0: params (LAN preset,
    fused core), the killed-member state after one warm-up chunk, the
    5%-loss plan and the seed mask."""
    params = dataclasses.replace(SimParams.from_cluster_config(n), pallas_delivery=True)
    state = dense.kill(dense.init_full_view(n, device="cuda"), 7)
    plan = FaultPlan.uniform(loss_percent=5.0, device="cuda")
    seeds = dense.seeds_mask(n, [0, 1], device="cuda")
    state, _ = run_ticks(params, state, plan, seeds, chunk, collect=False)
    int(state.view[0, 0])
    return params, state, plan, seeds


def measure_dense(n: int = 10240, chunk: int = 40, reps: int = 4):
    """Drive the dense main path: 1 warm-up chunk + ``reps`` timed chunks.

    Returns ``(row, state)`` with the fields of :func:`measure_sparse`
    (``launches`` counts tick-core kernel launches over warm-up and timed
    chunks). The dense tick leaves its input untouched, so ``state`` is the
    final state only."""
    launches0 = tick_core.launches
    params, state, plan, seeds = _dense_main_path(n, chunk)
    per_chunk, per_chunk_cpu = [], []
    for _ in range(reps):
        t0, c0 = time.perf_counter(), time.thread_time()
        state, _ = run_ticks(params, state, plan, seeds, chunk, collect=False)
        int(state.view[0, 0])
        per_chunk.append(time.perf_counter() - t0)
        per_chunk_cpu.append(time.thread_time() - c0)
    dt = sum(per_chunk)
    ticks = reps * chunk
    row = {
        "engine": "dense",
        "n": n,
        "chunk": chunk,
        "timed_ticks": ticks,
        "member_rounds_per_s": n * ticks / dt,
        "ms_per_tick": dt * 1e3 / ticks,
        "median_chunk_ms_per_tick": statistics.median(per_chunk) * 1e3 / chunk,
        "chunk_ms_per_tick": [c * 1e3 / chunk for c in per_chunk],
        "chunk_thread_cpu_ms_per_tick": [c * 1e3 / chunk for c in per_chunk_cpu],
        "launches": tick_core.launches - launches0,
    }
    return row, state


def profile_dense(n: int = 10240, ticks: int = 40, chunk: int = 40):
    """Where the dense main path's time goes on the card: after one warm-up
    chunk, the same ``ticks`` ticks (collect=False; 8 FD ticks in 40) run
    from one state, untraced and traced (:func:`_device_profile`; the tick
    does not modify its input, so no snapshot is needed)."""
    params, state, plan, seeds = _dense_main_path(n, chunk)
    first_tick = state.t_host + 1

    def run(_):
        run_ticks(params, state, plan, seeds, ticks, collect=False)

    row = {"engine": "dense", "n": n, "first_tick": first_tick}
    row.update(_device_profile(run, ticks))
    return row


def _ensemble_path(b_count: int, n: int, chunk: int):
    """The ``--ensemble`` rung's set-up on the card after one warm-up
    chunk: params (LAN preset, XLA core), B states seeded ``range(B)``, B
    uniform 5%-loss plans, the seed mask."""
    params = dataclasses.replace(SimParams.from_cluster_config(n), pallas_delivery=False)
    states = init_ensemble_dense(
        n, range(b_count), user_gossip_slots=params.user_gossip_slots, device="cuda"
    )
    plans = stack_universes(
        FaultPlan.uniform(loss_percent=5.0, device="cuda") for _ in range(b_count)
    )
    seeds = dense.seeds_mask(n, [0, 1], device="cuda")
    states, _ = run_ensemble_ticks(params, states, plans, seeds, chunk, collect=False)
    int(states.view[0, 0, 0])
    return params, states, plans, seeds


def measure_ensemble(b_count: int, n: int = 1024, chunk: int = 40, reps: int = 4) -> dict:
    """The ``--ensemble B [n]`` rung (bench.py::_measure_ensemble): B dense
    universes stepped together, one warm-up and ``reps`` timed ``chunk``-
    tick runs (collect=False), each ending in a fetch from the stacked
    view. The value is B · n · ticks / s, the reference's
    ``bench_ensemble`` row."""
    params, states, plans, seeds = _ensemble_path(b_count, n, chunk)
    t0 = time.perf_counter()
    for _ in range(reps):
        states, _ = run_ensemble_ticks(params, states, plans, seeds, chunk, collect=False)
        int(states.view[0, 0, 0])
    dt = time.perf_counter() - t0
    value = b_count * n * reps * chunk / dt
    return {
        "metric": "ensemble_member_gossip_rounds_per_sec",
        "value": value,
        "unit": "universes·member·rounds/s",
        "per_universe": value / b_count,
        "ns_per_member": 1e9 / value,
        "vs_baseline": value / BASELINE_MEMBER_ROUNDS_PER_SEC,
        "n_members": n,
        "universes": b_count,
        "engine": "dense-ensemble",
        "ms_per_tick": dt * 1e3 / (reps * chunk),
    }


def profile_ensemble(b_count: int, n: int = 1024, ticks: int = 40, chunk: int = 40) -> dict:
    """Where the ``--ensemble`` rung's time goes on the card: after one
    warm-up chunk, the same ``ticks`` ticks from one stacked state,
    untraced and traced (:func:`_device_profile`; the dense tick leaves its
    input as it was)."""
    params, states, plans, seeds = _ensemble_path(b_count, n, chunk)

    def run(_):
        run_ensemble_ticks(params, states, plans, seeds, ticks, collect=False)

    row = {"engine": "dense-ensemble", "n": n, "universes": b_count}
    row.update(_device_profile(run, ticks))
    return row


def sync_calls(run) -> int:
    """Synchronising CUDA calls ``run()`` makes, counted as the warnings of
    ``torch.cuda.set_sync_debug_mode("warn")``."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            run()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum(1 for w in caught if "synchroniz" in str(w.message).lower())


def _rapid_path(n: int, chunk: int):
    """The ``--rapid`` rung's set-up on the card after one warm-up chunk."""
    params = RapidParams(n=n)
    state = init_rapid_full_view(params, device="cuda")
    plan = FaultPlan.uniform(loss_percent=5.0, device="cuda")
    state, _ = run_rapid_ticks(params, state, plan, chunk, collect=False)
    bool(state.member_mask[0, 0])
    return params, state, plan


def measure_rapid(n: int = 1024, chunk: int = 40, reps: int = 4) -> dict:
    """The ``--rapid [n]`` rung (bench.py::_measure_rapid): one warm-up and
    ``reps`` timed ``chunk``-tick runs (collect=False), each ending in a
    fetch from ``member_mask``; the reference's member·rounds/s row, plus
    ms/tick, the peak device memory over the timed chunks and the
    synchronising calls a tick of one more chunk."""
    params, state, plan = _rapid_path(n, chunk)
    torch.cuda.reset_peak_memory_stats()
    per_chunk = []
    for _ in range(reps):
        t0 = time.perf_counter()
        state, _ = run_rapid_ticks(params, state, plan, chunk, collect=False)
        bool(state.member_mask[0, 0])
        per_chunk.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    dt = sum(per_chunk)
    value = n * reps * chunk / dt
    syncs = sync_calls(lambda: run_rapid_ticks(params, state, plan, chunk, collect=False))
    return {
        "metric": "member_gossip_rounds_per_sec",
        "value": value,
        "unit": "member·rounds/s",
        "vs_baseline": value / BASELINE_MEMBER_ROUNDS_PER_SEC,
        "ns_per_member": 1e9 / value,
        "n_members": n,
        "engine": "rapid",
        "k_observers": params.k,
        "ms_per_tick": dt * 1e3 / (reps * chunk),
        "chunk_ms_per_tick": [c * 1e3 / chunk for c in per_chunk],
        "peak_gib": peak / 2**30,
        "sync_calls_per_tick": syncs / chunk,
    }


def profile_rapid(n: int = 1024, ticks: int = 40, chunk: int = 40) -> dict:
    """Where the ``--rapid`` rung's time goes on the card: after one
    warm-up chunk, the same ``ticks`` ticks from one state, untraced and
    traced (:func:`_device_profile`; the tick leaves its input as it was)."""
    params, state, plan = _rapid_path(n, chunk)

    def run(_):
        run_rapid_ticks(params, state, plan, ticks, collect=False)

    row = {"engine": "rapid", "n": n}
    row.update(_device_profile(run, ticks))
    return row


def measure_geo(n: int = 1024, chunk: int = 40, reps: int = 4) -> dict:
    """The ``--geo [n]`` rung (bench.py::_measure_geo): the dense engine
    (LAN preset, ``pallas_delivery`` off as there, no kill, seeds [0, 1])
    under a schedule of one segment from tick 0, ``FaultPlan.uniform(5.0)``
    with a 2-zone world at 400 ms cross-zone latency; one warm-up and
    ``reps`` timed ``chunk``-tick runs (collect=False, each ending in a
    fetch from the view), then the same for the flat-world twin."""
    params = SimParams.from_cluster_config(n)
    seeds = dense.seeds_mask(n, [0, 1], device="cuda")
    world = LinkWorld.even_zones(n, 2, device="cuda").with_zone_latency(0, 1, 400.0)

    def run(link_world):
        sched = (
            ScheduleBuilder(n)
            .add_segment(0, FaultPlan.uniform(loss_percent=5.0, device="cuda"),
                         link_world=link_world)
            .build()
        )
        state = dense.init_full_view(n, device="cuda")
        state, _ = run_ticks(params, state, sched, seeds, chunk, collect=False)
        int(state.view[0, 0])
        t0 = time.perf_counter()
        for _ in range(reps):
            state, _ = run_ticks(params, state, sched, seeds, chunk, collect=False)
            int(state.view[0, 0])
        return n * (reps * chunk / (time.perf_counter() - t0))

    flat_value = run(None)
    value = run(world)
    return {
        "metric": "member_gossip_rounds_per_sec",
        "value": value,
        "unit": "member·rounds/s",
        "vs_baseline": value / BASELINE_MEMBER_ROUNDS_PER_SEC,
        "ns_per_member": 1e9 / value,
        "n_members": n,
        "engine": "dense-geo",
        "n_zones": 2,
        "brownout_latency_ms": 400.0,
        "flat_value": flat_value,
        "geo_overhead": flat_value / value,
    }


#: The reference rung's ring at n=4096; :func:`measure_tracer_overhead`
#: scales it with n.
TRACER_RUNG_CAPACITY_4096 = 1 << 16


def tracer_schedule(n: int):
    """The tracer rung's churn timeline (bench.py::_measure_tracer_overhead):
    5% loss from tick 0, member 7 killed at tick 3 and member n/2 at 5,
    member 7 restarted at 25."""
    return (
        ScheduleBuilder(n)
        .add_segment(0, FaultPlan.uniform(loss_percent=5.0, device="cuda"))
        .kill(3, 7)
        .kill(5, n // 2)
        .restart(25, 7)
        .build()
    )


def measure_tracer_overhead(n: int = 4096, slot_budget: int | None = None, chunk: int = 48,
                            reps: int = 4):
    """The ``--tracer-overhead [n]`` rung (bench.py::_measure_tracer_overhead):
    the same sparse trajectory run without and then with the flight
    recorder, ``tracer_overhead`` = on / off wall time, beside the
    recorder-on throughput. ``SparseParams.for_n(n)`` (the XLA chain,
    in-tick write-back; ``slot_budget`` overrides its 2048), one warm-up
    and ``reps`` timed ``chunk``-tick runs (collect=False), each ending in a
    fetch from the view. The ring holds the reference's 1 << 16 events
    scaled by n / 4096; its overflow is counted.

    Returns ``(row, traced_state)``."""
    params = SparseParams.for_n(n, **({} if slot_budget is None else {"slot_budget": slot_budget}))
    sched = tracer_schedule(n)
    capacity = TRACER_RUNG_CAPACITY_4096 * max(1, n // 4096)

    def timed(trace_capacity: int):
        state = init_sparse_full_view(n, params.slot_budget, trace_capacity=trace_capacity,
                                      device="cuda")
        state, _ = run_sparse_ticks(params, state, sched, chunk, collect=False)
        int(state.view_T[0, 0])
        per_chunk = []
        for _ in range(reps):
            t0 = time.perf_counter()
            state, _ = run_sparse_ticks(params, state, sched, chunk, collect=False)
            int(state.view_T[0, 0])
            per_chunk.append(time.perf_counter() - t0)
        return per_chunk, state

    off, _ = timed(0)
    on, traced = timed(capacity)
    dt_off, dt_on = sum(off), sum(on)
    value = n * (reps * chunk / dt_on)
    row = {
        "metric": "member_gossip_rounds_per_sec",
        "value": value,
        "unit": "member·rounds/s",
        "vs_baseline": value / BASELINE_MEMBER_ROUNDS_PER_SEC,
        "ns_per_member": 1e9 / value,
        "tracer_overhead": dt_on / dt_off,
        "trace_capacity": capacity,
        "events_recorded": int(traced.trace.cursor),
        "trace_overflow": ring_overflow(traced.trace),
        "n_members": n,
        "slot_budget": params.slot_budget,
        "engine": "sparse-traced",
        "ms_per_tick_off": dt_off * 1e3 / (reps * chunk),
        "ms_per_tick_on": dt_on * 1e3 / (reps * chunk),
        "chunk_ms_per_tick_off": [c * 1e3 / chunk for c in off],
        "chunk_ms_per_tick_on": [c * 1e3 / chunk for c in on],
    }
    return row, traced


def serve_gossip_stream(n: int, total_ticks: int, per_tick: int, g_slots: int,
                        first_tick: int = 1) -> list:
    """The ``--serve`` rung's traffic (bench.py::_measure_serve): ``per_tick``
    user-gossip events a tick, on members ``(t * per_tick + j) % n`` and
    payload slots ``(t + j) % g_slots``, for global ticks ``first_tick`` to
    ``first_tick + total_ticks - 1``."""
    from scalecube_cluster_tpu_torch.serve import EV_GOSSIP, ServeEvent

    return [
        ServeEvent(EV_GOSSIP, (t * per_tick + j) % n, arg=(t + j) % g_slots, tick=t)
        for t in range(first_tick, first_tick + total_ticks)
        for j in range(per_tick)
    ]


def serve_session(n: int = 4096, batch_ticks: int = 32, capacity: int = 8, n_batches: int = 8,
                  *, slot_budget: int | None = None, pallas_core: bool = False,
                  in_scan_writeback: bool = True, device="cuda"):
    """The ``--serve`` rung's session (bench.py::_measure_serve), not closed:
    one warm-up batch through a throwaway bridge, then the serving bridge
    over the bench's one-kill, 5%-loss trajectory replaying
    :func:`serve_gossip_stream` (``capacity // 2`` events a tick) for
    ``n_batches`` launches with collect=False. Returns ``(bridge,
    wall_s)``, the bridge not closed and ``wall_s`` the replay's wall time
    up to its last verdicts."""
    from scalecube_cluster_tpu_torch.serve import ServeBridge

    params = SparseParams.for_n(
        n, slot_budget=slot_budget or rung_slot_budget(n), pallas_core=pallas_core,
        in_scan_writeback=in_scan_writeback,
    )
    plan = FaultPlan.uniform(loss_percent=5.0, device=device)

    def bridge(state):
        return ServeBridge(params, state, plan=plan, batch_ticks=batch_ticks,
                           capacity=capacity, collect=False)

    warm = bridge(init_sparse_full_view(n, params.slot_budget, device=device))
    warm.run_replay([], batch_ticks)
    del warm
    session = bridge(kill_sparse(init_sparse_full_view(n, params.slot_budget, device=device), 7))
    total_ticks = batch_ticks * n_batches
    events = serve_gossip_stream(n, total_ticks, max(capacity // 2, 1), session.batcher.g_slots)
    t0 = time.perf_counter()
    session.run_replay(events, total_ticks)
    return session, time.perf_counter() - t0


def measure_serve(n: int = 4096, batch_ticks: int = 32, capacity: int = 8, n_batches: int = 8,
                  **kw) -> dict:
    """The ``--serve [n]`` rung: :func:`serve_session`'s ``kind="serve"``
    summary row (events/s, member·rounds/s through the serving path and
    the batch-latency percentiles)."""
    return serve_session(n, batch_ticks, capacity, n_batches, **kw)[0].close()


def grow_session(n0: int = 64, tiers: int = 2, burst: int = 24, *, batch_ticks: int = 8,
                 capacity: int | None = None, slot_budget: int | None = None,
                 pallas_core: bool = False, in_scan_writeback: bool = True, device="cuda"):
    """The ``--grow [n0] [tiers]`` rung's session (bench.py::_measure_grow):
    ``n0`` live members in a ``2 * n0`` allocation grow to ``2 * n0 *
    2**tiers`` through ``tiers`` checkpoint-based promotions
    (``auto_promote``), ``burst`` wire joins (node omitted) pushed before
    each launch. Returns ``(bridge, wall_s, n_joins)``, the bridge not
    closed."""
    from scalecube_cluster_tpu_torch.serve import ServeBridge
    from scalecube_cluster_tpu_torch.serve.ingest import event_from_obj

    n_alloc0 = 2 * n0
    n_top = n_alloc0 * (2**tiers)
    params = SparseParams.for_n(
        n_alloc0, slot_budget=slot_budget or rung_slot_budget(n_top),
        pallas_core=pallas_core, in_scan_writeback=in_scan_writeback,
    )
    state = init_sparse_full_view(n0, params.slot_budget, n_alloc=n_alloc0, device=device)
    bridge = ServeBridge(
        params, state, plan=FaultPlan.uniform(device=device), batch_ticks=batch_ticks,
        capacity=capacity or max(burst, 8), collect=False, auto_promote=True,
    )
    n_joins = n_top - n0
    t0 = time.perf_counter()
    sent = 0
    while sent < n_joins or bridge.batcher.deferred_joins:
        for _ in range(min(burst, n_joins - sent)):
            bridge.push(event_from_obj({"kind": "join"}))
        sent += min(burst, n_joins - sent)
        bridge.step_batch()
    return bridge, time.perf_counter() - t0, n_joins


def grow_row(bridge, wall_s: float, n0: int, tiers: int, n_joins: int) -> dict:
    """The reference's ``--grow`` row for a finished :func:`grow_session`,
    after asserting the admission ledger: every join placed, none shed, one
    promotion per tier. Closes the bridge."""
    led = bridge.batcher.assert_join_conservation()
    assert led["placed"] == n_joins and led["shed"] == 0, led
    promo_ms = [r["wall_ms"] for r in bridge.rows if r.get("kind") == "promotion"]
    assert len(promo_ms) == tiers, (len(promo_ms), tiers)
    summary = bridge.close()
    return {
        "metric": "joins_admitted_per_sec",
        "value": round(n_joins / wall_s, 1),
        "unit": "joins/s",
        "n0": n0,
        "tiers": tiers,
        "n_top": 2 * n0 * (2**tiers),
        "n_live": summary["n_live"],
        "joins_total": n_joins,
        "dropped": led["shed"] + led["deferred"],
        "promotions": tiers,
        "promotion_wall_ms": [round(ms, 1) for ms in promo_ms],
        "promotion_wall_ms_mean": round(sum(promo_ms) / len(promo_ms), 1),
        "batches": summary["batches"],
        "ticks": summary["ticks"],
        "wall_s": round(wall_s, 2),
        "engine": "sparse-elastic",
    }


def measure_grow(n0: int = 64, tiers: int = 2, burst: int = 24, **kw) -> dict:
    """The ``--grow [n0] [tiers]`` rung: joins admitted a second across the
    promotions, the promotions' wall times, and a certified zero of dropped
    joins."""
    bridge, wall_s, n_joins = grow_session(n0, tiers, burst, **kw)
    return grow_row(bridge, wall_s, n0, tiers, n_joins)


def measure_load(producers: int = 32, n_members: int = 1024, *,
                 slot_budget: int | None = None, pallas_core: bool = False,
                 batch_ticks: int = 8, capacity: int = 64, settle_s: float = 0.002,
                 device="cuda") -> dict:
    """The ``--load [producers] [n]`` rung (bench.py::_measure_load): the
    seeded multi-producer wire harness (serve/load.py), honest and
    adversarial loopback-TCP producers with connection churn against one
    live bounded-queue session. Returns the harness's ``kind="load"`` audit
    row. The producers share the session's event loop, which a launch
    holds until its verdicts: ``settle_s`` is the loop's time for them
    between launches."""
    import asyncio

    from scalecube_cluster_tpu_torch.serve.load import run_load

    res = asyncio.run(
        run_load(
            n=n_members,
            slot_budget=slot_budget or rung_slot_budget(n_members),
            producers=producers,
            adversarial=max(producers // 4, 5),
            events_per_producer=400,
            batch_ticks=batch_ticks,
            capacity=capacity,
            max_pending=4096,
            churn_every=100,
            settle_s=settle_s,
            pallas_core=pallas_core,
            device=device,
        )
    )
    return res["row"]


def measure_persistent_ksweep(
    n: int = 4096, k_max: int = 8, reps: int = 4, slot_budget: int | None = None
) -> list[dict]:
    """The persistent core's k-sweep (bench.py::_measure_persistent_ksweep):
    the seeded operands of the JAX rung (numpy ``default_rng(0)``, f=3,
    spread 6, suspicion 20, age_stale 120, sweep 6, fold ``{countdown,
    wb_mask, view_rows}``), one warm-up launch at k_max, then ``reps``
    launches at each k in 1..k_max, each ending in a synchronize (the JAX
    rung's host fetch). One row per k with the JAX row's fields: ``value``
    in member·rounds/s from the wall, ``ns_per_member``, ``launches`` (the
    timed ones) and ``zero_recompile`` (the kernel library built and
    loaded once for the whole sweep); also ``device_ms_per_launch`` from
    CUDA events around each launch."""
    s = slot_budget or rung_slot_budget(n)
    ops = [torch.from_numpy(v).cuda() for v in persistent_operands(n, s, 3, k_max, seed=0).values()]
    kw = dict(
        spread=6, susp_ticks=20, age_stale=120, sweep=6, k_max=k_max,
        fold=frozenset({"countdown", "wb_mask", "view_rows"}),
    )

    def launch(k: int):
        return sparse_persistent.run_sparse_core_persistent(*ops, k, **kw)

    launch(k_max)
    torch.cuda.synchronize()
    rows = []
    for k in range(1, k_max + 1):
        device_ms = 0.0
        t0 = time.perf_counter()
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            launch(k)
            stop.record()
            torch.cuda.synchronize()
            device_ms += start.elapsed_time(stop)
        dt = time.perf_counter() - t0
        value = n * (reps * k / dt)
        rows.append({
            "metric": "member_gossip_rounds_per_sec",
            "value": value,
            "unit": "member·rounds/s",
            "vs_baseline": value / BASELINE_MEMBER_ROUNDS_PER_SEC,
            "ns_per_member": 1e9 / value,
            "n_members": n,
            "engine": "sparse-persistent-kernel",
            "slot_budget": s,
            "k": k,
            "k_max": k_max,
            "launches": reps,
            "zero_recompile": sparse_persistent.LIBRARY.loads == 1,
            "device_ms_per_launch": device_ms / reps,
        })
    return rows


def main(argv) -> int:
    ap = argparse.ArgumentParser(prog="python -m scalecube_cluster_tpu_torch.bench")
    ap.add_argument("--engine", choices=("sparse", "dense", "persistent"), default="sparse")
    ap.add_argument("n", type=int, nargs="?",
                    help="members (32768 sparse, 10240 dense, 4096 persistent)")
    ap.add_argument("slot_budget", type=int, nargs="?",
                    help="slab width S (sparse 512; persistent: the JAX rung's rule)")
    ap.add_argument("--runs", type=int, default=1, help="runs, each from a fresh state")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--k-max", type=int, default=8, help="persistent only")
    ap.add_argument("--geo", type=int, nargs="?", const=1024, default=None, metavar="N",
                    help="the dense geo-brownout rung at N members (default 1024)")
    ap.add_argument("--tracer-overhead", type=int, nargs="?", const=4096, default=None,
                    metavar="N", help="the flight-recorder cost rung at N members "
                    "(default 4096; the positional S overrides its slab width)")
    ap.add_argument("--ensemble", type=int, nargs="+", default=None, metavar="B",
                    help="the dense ensemble rung: B universes [of N members, default 1024]")
    ap.add_argument("--rapid", type=int, nargs="?", const=1024, default=None, metavar="N",
                    help="the Rapid engine rung at N members (default 1024)")
    ap.add_argument("--serve", type=int, nargs="?", const=4096, default=None, metavar="N",
                    help="the serving-bridge rung at N members (default 4096)")
    ap.add_argument("--grow", type=int, nargs="*", default=None, metavar="N0 TIERS",
                    help="the elastic serving rung: N0 live members (default 64) grown "
                    "through TIERS promotions (default 2)")
    ap.add_argument("--load", type=int, nargs="*", default=None, metavar="PRODUCERS N",
                    help="the wire load harness: PRODUCERS producers (default 32) against "
                    "N members (default 1024)")
    args = ap.parse_args(argv[1:])
    if not torch.cuda.is_available():
        print("bench: no CUDA device; the measurement needs the card", file=sys.stderr)
        return 2
    extra = {"device": torch.cuda.get_device_name(0), "torch": torch.__version__,
             "cuda": torch.version.cuda}

    def emit(kind: str, row: dict) -> None:
        print(jsonl_line(make_row(kind, {**row, **extra}, run_metadata(seed=0))), flush=True)

    if args.geo is not None:
        emit("bench_geo", measure_geo(args.geo))
        return 0
    if args.ensemble is not None:
        b_count = args.ensemble[0]
        n = args.ensemble[1] if len(args.ensemble) > 1 else 1024
        if args.profile:
            emit("bench_ensemble_profile", profile_ensemble(b_count, n))
        else:
            emit("bench_ensemble", measure_ensemble(b_count, n))
        return 0
    if args.rapid is not None:
        if args.profile:
            emit("bench_rapid_profile", profile_rapid(args.rapid))
        else:
            emit("bench_rapid", measure_rapid(args.rapid))
        return 0
    if args.serve is not None:
        print(jsonl_line(measure_serve(args.serve)), flush=True)
        return 0
    if args.grow is not None:
        n0, tiers = (args.grow + [64, 2][len(args.grow):])[:2]
        print(jsonl_line(make_row("grow", measure_grow(n0, tiers), run_metadata(seed=0))),
              flush=True)
        return 0
    if args.load is not None:
        producers, n = (args.load + [32, 1024][len(args.load):])[:2]
        print(jsonl_line(measure_load(producers, n)), flush=True)
        return 0
    if args.tracer_overhead is not None:
        emit("bench_tracer", measure_tracer_overhead(args.tracer_overhead, args.slot_budget)[0])
        return 0
    if args.engine == "persistent":
        for row in measure_persistent_ksweep(args.n or 4096, args.k_max,
                                             slot_budget=args.slot_budget):
            emit("bench_persistent", row)
        return 0
    slot_budget = args.slot_budget or 512
    for _ in range(args.runs):
        if args.engine == "dense":
            n = args.n or 10240
            row = profile_dense(n) if args.profile else measure_dense(n, reps=CLI_REPS)[0]
        elif args.profile:
            row = profile_sparse(args.n or 32768, slot_budget)
        else:
            row, _ = measure_sparse(args.n or 32768, slot_budget, reps=CLI_REPS)
        emit("bench", row)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
