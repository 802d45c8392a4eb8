"""The port's benches of the two engines' main paths (the twins of the JAX
package's ``bench.py::_measure_sparse``, ladder rung 1, and
``bench.py::_measure_dense``, its rung ``("dense", 10240, None)``).

Sparse: ``SparseParams.for_n(n, slot_budget, in_scan_writeback=False)``
with the LAN preset, ``init_sparse_full_view`` then ``kill_sparse(…, 7)``,
and ``run_sparse_chunked`` over ``FaultPlan.uniform(5.0)`` in 48-tick
chunks with ``collect=False`` and a host-boundary write-back per chunk.

Dense: ``SimParams.from_cluster_config(n)`` with ``pallas_delivery=True``
(the fused tick-core kernel), ``init_full_view`` then ``kill(…, 7)``, seeds
``[0, 1]``, and ``run_ticks`` over ``FaultPlan.uniform(5.0)`` in 40-tick
chunks with ``collect=False``.

One chunk warms up; ``reps`` chunks are timed, each ending in a host fetch
from the large view table, which waits for the whole chunk.

Run on a CUDA card: ``python -m scalecube_cluster_tpu_torch.bench
[--engine sparse|dense] [n] [S] [--runs K]`` prints one JSON line per run
of ``CLI_REPS`` timed chunks; ``--profile`` instead prints where a tick's
time goes (:func:`profile_sparse`, :func:`profile_dense`). There is no CPU
fallback for the measurement.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import sys
import time

import torch

from scalecube_cluster_tpu_torch.ops.sparse_core import sparse_core
from scalecube_cluster_tpu_torch.ops.tick_core import tick_core
from scalecube_cluster_tpu_torch.sim import state as dense
from scalecube_cluster_tpu_torch.sim.faults import FaultPlan
from scalecube_cluster_tpu_torch.sim.params import SimParams
from scalecube_cluster_tpu_torch.sim.run import run_ticks
from scalecube_cluster_tpu_torch.sim.sparse import (
    SparseParams,
    SparseState,
    init_sparse_full_view,
    kill_sparse,
    run_sparse_chunked,
    run_sparse_ticks,
)

#: Timed chunks per command-line run: 768 sparse ticks (640 dense), long
#: enough to cross the SYNC ticks and many write-backs; the host-bound
#: sparse wall still spreads by up to a quarter between runs (PERF.md §2).
CLI_REPS = 16


def _warm_main_path(n: int, slot_budget: int, chunk: int):
    """The main path's set-up on the card, seed 0: params, the killed-member
    state after one warm-up chunk, and the 5%-loss plan."""
    params = SparseParams.for_n(n, slot_budget=slot_budget, in_scan_writeback=False)
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


def main(argv) -> int:
    ap = argparse.ArgumentParser(prog="python -m scalecube_cluster_tpu_torch.bench")
    ap.add_argument("--engine", choices=("sparse", "dense"), default="sparse")
    ap.add_argument("n", type=int, nargs="?", help="members (32768 sparse, 10240 dense)")
    ap.add_argument("slot_budget", type=int, nargs="?", default=512, help="sparse only")
    ap.add_argument("--runs", type=int, default=1, help="runs, each from a fresh state")
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args(argv[1:])
    if not torch.cuda.is_available():
        print("bench: no CUDA device; the measurement needs the card", file=sys.stderr)
        return 2
    for _ in range(args.runs):
        if args.engine == "dense":
            n = args.n or 10240
            row = profile_dense(n) if args.profile else measure_dense(n, reps=CLI_REPS)[0]
        elif args.profile:
            row = profile_sparse(args.n or 32768, args.slot_budget)
        else:
            row, _ = measure_sparse(args.n or 32768, args.slot_budget, reps=CLI_REPS)
        row["device"] = torch.cuda.get_device_name(0)
        row["torch"] = torch.__version__
        row["cuda"] = torch.version.cuda
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
