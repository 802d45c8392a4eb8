#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (scalecube_cluster_tpu_torch).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero):

1. the card (``nvidia-smi`` name and power limit) and the torch / CUDA
   versions;
2. the kernel builds: ``csrc/sparse_core.cu`` and ``csrc/tick_core.cu``
   compiled for sm_90a, one nvcc each, both at once;
3. sparse kernel vs plain on the card: the sparse-core kernel and its plain
   PyTorch version on the same seeded operands, at the bench shape
   (n=32768, S=512, f=3) and at n=1024, S=256 — all five outputs
   bit-equal; kernel and plain times and the bound (the larger of the
   bytes moved and the int32 operations the function needs);
4. sparse card vs CPU: a 60-tick trajectory (n=1024, S=256: FD every 2
   ticks, SYNC every 10, suspicion 12, 10% loss, chunks of 12) run on the
   card and on the CPU — every state leaf and every counter equal after
   every chunk;
5. the sparse main path: n=32768, S=512 under 5% loss, one warm-up and four
   timed 48-tick chunks with collect=False (240 ticks, so the SYNC at tick
   150 and five write-back boundaries run at full width), the kernel
   launched on every tick; then one collect=True chunk;
6. dense kernel vs plain on the card: the tick-core kernel and its plain
   version on seeded operands at n=10240 and n=256 (f=3) — all six outputs
   bit-equal; times and the bound;
7. dense card vs CPU: a 60-tick trajectory (n=256, the fused core, FD
   every 2 ticks, SYNC every 10, suspicion 12, 10% loss, member 5 killed
   and restarted at tick 24 so the joining slow path runs, chunks of 12)
   — every state leaf and every metric equal after every chunk;
8. the dense main path: n=10240, LAN preset, fused core, 5% loss, one
   warm-up and four timed 40-tick chunks with collect=False (200 ticks;
   the kernel launched on every tick but the SYNC tick 150); then one
   collect=True chunk;
9. the kernel table as one JSON line, the card's name and power limit,
   and the device line last.

Each main path runs with every kernel count set to 0 just before it and
read just after. There is no CPU fallback: without a CUDA device the
script fails.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

#: Tolerance of every kernel-vs-plain and card-vs-CPU comparison: bit-exact
#: (integer state, order-free integer reductions and atomics).
TOLERANCE = 0
#: Published peaks of one H100 SXM at 700 W (NVIDIA data sheet, as the
#: on-chip-measurement guide lists them): HBM bytes/s, and the INT32 rate.
#: The sheet's 67e12 float32 FLOP/s counts a fused multiply-add as two
#: operations on 128 lanes per SM; the integer pipe has 64 lanes per SM,
#: one operation each, so the INT32 rate is a quarter of it.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12 / 4
#: Integer operations the two core functions need, counted from the kernel
#: bodies by these rules. A comparison, select, logic or arithmetic
#: operator counts one; loads, stores and address arithmetic are the bytes
#: side. A key's sign, DEAD and rank tests fold into one masked compare
#: (an and and a compare). Work that depends on the row alone (its point
#: lanes, its diagonal or own lane, its liveness, its edge bits) is charged
#: once per row or (row, channel); what a sender sends (its point
#: overrides, the young and alive masks of its records) once per sender
#: cell; only the two maxima per delivered (cell, channel).
#:
#: Sparse core, per cell of an active lane: the merge lattice 23; the
#: countdown, DEAD transition and aging 26; the aggregate bits 13.
OPS_PER_ACTIVE_CELL = 23 + 26 + 13
#: Per cell of an inactive lane: no merge; the countdown, DEAD transition
#: and aging with no re-arm and no refill 17; the aggregate bits 13.
OPS_PER_IDLE_CELL = 17 + 13
#: Per sender cell on an active lane: the FD/SYNC point overrides 6, the
#: young test 1, the alive-key test 2, the two masked payloads 3.
OPS_PER_SENDER_CELL = 12
#: Per row: the receiver's point lanes 7 and their two re-arm terms 2, the
#: own lane 3, the liveness test 1. Per lane: the active test 1.
OPS_PER_ROW = 13
OPS_PER_LANE = 1
#: Both cores: the edge test per (row, channel); best_any and best_alive
#: maxima per delivered (cell, channel).
OPS_PER_EDGE_TEST = 1
OPS_PER_DELIVERY = 2
#: Tick core, per cell: the merge lattice 23; the countdown, DEAD
#: transition, aging, tombstone demotion and refill 29; rows_next 2; the
#: known_cnt term 3.
DENSE_OPS_PER_CELL = 23 + 29 + 2 + 3
#: Per sender cell: the FD fix-up 2, the alive-key test 2, the masked
#: alive payload 1.
DENSE_OPS_PER_SENDER_CELL = 5
#: Per row: the diagonal (self-rumor and exclusion) 3, the FD cell (its
#: test, two selects, two re-arm terms) 5, the liveness test 1.
DENSE_OPS_PER_ROW = 9
#: Bytes per cell that csrc/tick_core.cu moves at f=3: the 3 sender rows
#: (int32) read for every cell, view0, age, susp read, four outputs written.
DENSE_KERNEL_BYTES_PER_CELL = 3 * 4 + 4 + 1 + 2 + 4 + 1 + 2 + 4

def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", flush=True)
    raise SystemExit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


def phase_card(torch):
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if proc.returncode != 0 or not proc.stdout.strip():
        fail(f"nvidia-smi failed: {proc.stderr.strip()}")
    card = proc.stdout.strip().splitlines()[0]
    say(card)
    say(
        f"[1] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}"
    )
    return card


def phase_build():
    from scalecube_cluster_tpu_torch.ops import cuda_build, sparse_core, tick_core

    libraries = [sparse_core.LIBRARY, tick_core.LIBRARY]
    t0 = time.perf_counter()
    cuda_build.compile_all(libraries)
    for lib in libraries:
        lib.load()
    names = ", ".join(lib.source.name for lib in libraries)
    say(f"[2] built {names} for sm_90a in {time.perf_counter() - t0:.2f} s (one nvcc each, at once)")


def _time_cuda(torch, fn, reps):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def core_work(ops):
    """The least the sparse core must do on these operands: the bytes it
    must move (each input read once, each output written once) and the
    integer operations its function needs, the data-dependent terms (active
    lanes, edges up) counted from the operands."""
    n, s = ops["slab"].shape
    f = ops["ginv"].shape[0]
    cells = n * s
    per_cell = 4 + 1 + 2  # slab i32, age i8, susp i16: read, and written again
    vectors = sum(
        t.numel() * t.element_size()
        for k, t in ops.items() if k not in ("slab", "age", "susp")
    )
    bytes_moved = 2 * cells * per_cell + vectors + 4 * n + 4 * s  # + self_rumor, aggr
    n_active = int((ops["slot_subj"] >= 0).sum())
    deliveries = int(ops["edge_ok"].sum()) * n_active
    n_ops = (
        n * n_active * (OPS_PER_ACTIVE_CELL + OPS_PER_SENDER_CELL)
        + n * (s - n_active) * OPS_PER_IDLE_CELL
        + deliveries * OPS_PER_DELIVERY
        + f * n * OPS_PER_EDGE_TEST
        + n * OPS_PER_ROW
        + s * OPS_PER_LANE
    )
    return bytes_moved, n_ops


def phase_kernel_vs_plain(torch):
    from scalecube_cluster_tpu_torch.ops.sparse_core import (
        sparse_core,
        sparse_core_reference,
    )
    from scalecube_cluster_tpu_torch.testing import random_operands

    consts = dict(spread=48, susp_ticks=400, age_stale=120, sweep=98)
    rows = {}
    for n, s, seed in ((32768, 512, 1), (1024, 256, 2)):
        f = 3
        ops = {
            k: torch.from_numpy(v).cuda()
            for k, v in random_operands(n, s, f, seed=seed).items()
        }
        args = tuple(ops.values())
        got = sparse_core(*args, **consts)
        want = sparse_core_reference(*args, **consts)
        torch.cuda.synchronize()
        err = 0
        for name, g, w in zip(("slab2", "age2", "susp2", "self_rumor", "aggr"), got, want):
            if g.dtype != w.dtype or g.shape != w.shape:
                fail(f"{name} at n={n}: {g.dtype}{tuple(g.shape)} vs {w.dtype}{tuple(w.shape)}")
            diff = int((g.long() - w.long()).abs().max())
            err = max(err, diff)
            if diff > TOLERANCE:
                bad = int((g != w).sum())
                fail(f"kernel disagrees with plain on {name} at n={n} S={s}: {bad} cells")
        reps_k, reps_p = (50, 5) if n > 4096 else (200, 20)
        k_ms = _time_cuda(torch, lambda: sparse_core(*args, **consts), reps_k)
        p_ms = _time_cuda(torch, lambda: sparse_core_reference(*args, **consts), reps_p)
        bytes_moved, n_ops = core_work(ops)
        bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
        ops_ms = n_ops / INT32_OPS_PER_S * 1e3
        row = {
            "n": n, "S": s, "f": f, "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": bytes_moved, "bytes_ms": bytes_ms,
            "int32_ops": n_ops, "ops_ms": ops_ms,
        }
        rows[(n, s)] = row
        say(
            f"[3] sparse_core n={n} S={s} f={f}: bit-equal to plain (max_abs_err {err}); "
            f"kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, bound {row['bound_ms']:.4f} ms "
            f"by {row['bound_by']} ({bytes_moved} B = {bytes_ms:.4f} ms; "
            f"{n_ops} int32 ops = {ops_ms:.4f} ms); library_ms null — no single "
            "PyTorch call computes this function"
        )
    return rows


def _fold_params(n, s):
    from scalecube_cluster_tpu_torch.sim.params import SimParams
    from scalecube_cluster_tpu_torch.sim.sparse import SparseParams

    base = SimParams(
        n=n, gossip_fanout=3, periods_to_spread=8, periods_to_sweep=18,
        fd_period_ticks=2, sync_period_ticks=10, suspicion_ticks=12,
        ping_req_members=2, user_gossip_slots=2,
    )
    return SparseParams(base=base, slot_budget=s, alloc_cap=16, in_scan_writeback=False)


def phase_card_vs_cpu(torch):
    from scalecube_cluster_tpu_torch.sim.convert import sparse_state_to_numpy
    from scalecube_cluster_tpu_torch.sim.faults import FaultPlan
    from scalecube_cluster_tpu_torch.sim.sparse import (
        init_sparse_full_view,
        kill_sparse,
        run_sparse_chunked,
    )
    import numpy as np

    n, s, ticks, chunk = 1024, 256, 60, 12
    params = _fold_params(n, s)
    runs = {}
    for dev in ("cuda", "cpu"):
        st = kill_sparse(
            init_sparse_full_view(n, s, user_gossip_slots=2, record_latency=True, device=dev), 5
        )
        plan = FaultPlan.uniform(10.0, device=dev)
        snaps = []
        for _ in range(ticks // chunk):
            st, tr = run_sparse_chunked(params, st, plan, chunk, chunk=chunk, collect=True)
            snaps.append((sparse_state_to_numpy(st), tr))
        runs[dev] = snaps
    for c, ((a, ta), (b, tb)) in enumerate(zip(runs["cuda"], runs["cpu"])):
        if set(a) != set(b) or set(ta) != set(tb):
            fail(f"card/CPU leaf or counter sets differ at chunk {c}")
        for k in a:
            if not np.array_equal(a[k], b[k]):
                fail(f"card/CPU state leaf {k} differs after chunk {c}")
        for k in ta:
            if not np.array_equal(ta[k], tb[k]):
                fail(f"card/CPU counter {k} differs in chunk {c}")
    card = runs["cuda"]
    dead = sum(int(tr["verdicts_dead"].sum()) for _, tr in card)
    say(
        f"[4] card == CPU over {ticks} ticks at n={n} S={s} "
        f"({len(card[-1][0])} leaves, {len(card[-1][1])} counters, every chunk); "
        f"verdicts_dead total {dead}"
    )


def _kernel_wrappers():
    from scalecube_cluster_tpu_torch.ops.sparse_core import sparse_core
    from scalecube_cluster_tpu_torch.ops.tick_core import tick_core

    return {"sparse_core": sparse_core, "tick_core": tick_core}


def reset_counts():
    for wrapper in _kernel_wrappers().values():
        wrapper.launches = 0


def read_counts():
    return {name: wrapper.launches for name, wrapper in _kernel_wrappers().items()}


def phase_main_path(torch):
    import numpy as np

    from scalecube_cluster_tpu_torch.bench import measure_sparse
    from scalecube_cluster_tpu_torch.sim.faults import FaultPlan
    from scalecube_cluster_tpu_torch.sim.sparse import SparseParams, run_sparse_chunked

    n, s, chunk, reps = 32768, 512, 48, 4
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    row, state = measure_sparse(n, s, chunk=chunk, reps=reps)
    counts = read_counts()
    launches = counts["sparse_core"]
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    expect = (reps + 1) * chunk
    say(
        f"[5] main path n={n} S={s}: {row['ms_per_tick']:.3f} ms/tick, "
        f"{row['member_rounds_per_s']:.1f} member·rounds/s, peak device memory "
        f"{peak_gib:.3f} GiB, launches {counts} (expect sparse_core {expect})"
    )
    if launches != expect:
        fail(f"sparse_core launched {launches} times on the main path, expected {expect}")

    params = SparseParams.for_n(n, slot_budget=s, in_scan_writeback=False)
    plan = FaultPlan.uniform(loss_percent=5.0, device="cuda")
    state, tr = run_sparse_chunked(params, state, plan, chunk, chunk, collect=True)
    for k, v in tr.items():
        if v.shape[0] != chunk or not np.all(np.isfinite(v)):
            fail(f"counter {k} malformed: shape {v.shape}")
    slot_subj = state.slot_subj.cpu().numpy()
    subj_slot = state.subj_slot.cpu().numpy()
    active = np.flatnonzero(slot_subj >= 0)
    if not np.array_equal(subj_slot[slot_subj[active]], active) or int(
        (subj_slot >= 0).sum()
    ) != active.size:
        fail("slot tables are inconsistent after the main path")
    if int(state.t_host) != int(state.tick) or int(state.tick) != expect + chunk:
        fail(f"tick {int(state.tick)} / mirror {state.t_host}, expected {expect + chunk}")
    if int(tr["slot_overflow"].sum()) != 0:
        fail(f"slot overflow {int(tr['slot_overflow'].sum())} at S={s}")
    # The killed member 7 is suspected or convicted by live viewers.
    s7 = int(subj_slot[7])
    rec7 = state.slab[:, s7] if s7 >= 0 else state.view_T[7, :]
    flagged = _flagging_viewers(state.alive, rec7, 7)
    if flagged == 0:
        fail("no live viewer suspects or convicts the killed member 7")
    say(
        f"[5] collect chunk: n_active_slots {int(tr['n_active_slots'][-1])}, "
        f"slot_overflow {int(tr['slot_overflow'].sum())}, msgs_gossip "
        f"{int(tr['msgs_gossip'].sum())}, n_suspected {int(tr['n_suspected'][-1])}, "
        f"live viewers flagging member 7: {flagged}"
    )
    return launches


def _flagging_viewers(alive, rec, subject):
    """Live viewers (other than ``subject``) whose record ``rec [N]`` of
    ``subject`` is SUSPECT or DEAD."""
    live = alive.clone()
    live[subject] = False
    return int(((rec >= 0) & ((rec & 1 != 0) | (rec & (1 << 21) != 0)) & live).sum())


def dense_core_work(ops):
    """The least the dense tick core must do on these operands: the bytes
    it must move (each [N, N] input read once, each output written once,
    plus the vectors) and the integer operations its function needs, the
    delivered (cell, channel) term counted from the edge bits. Also the
    bytes this simple kernel moves (the sender rows read for every cell)."""
    n = ops["view0"].shape[0]
    f = ops["ginv"].shape[0]
    cells = n * n
    vectors = sum(
        t.numel() * t.element_size()
        for k, t in ops.items() if k not in ("rows", "view0", "age", "susp")
    )
    per_cell = (4 + 4 + 1 + 2) + (4 + 1 + 2 + 4)  # read rows, view0, age, susp; write 4
    bytes_moved = cells * per_cell + vectors + 2 * 4 * n  # + self_rumor, known_cnt
    kernel_bytes = cells * DENSE_KERNEL_BYTES_PER_CELL + vectors + 2 * 4 * n
    deliveries = int(ops["edge_ok"].sum()) * n
    n_ops = (
        cells * (DENSE_OPS_PER_CELL + DENSE_OPS_PER_SENDER_CELL)
        + deliveries * OPS_PER_DELIVERY
        + f * n * OPS_PER_EDGE_TEST
        + n * DENSE_OPS_PER_ROW
    )
    return bytes_moved, n_ops, kernel_bytes


def phase_dense_kernel_vs_plain(torch):
    from scalecube_cluster_tpu_torch.ops.tick_core import tick_core, tick_core_reference
    from scalecube_cluster_tpu_torch.testing import random_tick_operands

    consts = dict(spread=42, sweep=86, susp_ticks=350, age_stale=120)
    names = ("view2", "age2", "susp2", "rows_next", "self_rumor", "known_cnt")
    rows = {}
    for n, seed in ((10240, 1), (256, 2)):
        f = 3
        ops = {
            k: torch.from_numpy(v).cuda()
            for k, v in random_tick_operands(n, f, seed=seed, susp_ticks=350).items()
        }
        args = tuple(ops.values())
        got = tick_core(*args, **consts)
        want = tick_core_reference(*args, **consts)
        torch.cuda.synchronize()
        err = 0
        for name, g, w in zip(names, got, want):
            if g.dtype != w.dtype or g.shape != w.shape:
                fail(f"{name} at n={n}: {g.dtype}{tuple(g.shape)} vs {w.dtype}{tuple(w.shape)}")
            diff = int((g.long() - w.long()).abs().max())
            err = max(err, diff)
            if diff > TOLERANCE:
                bad = int((g != w).sum())
                fail(f"tick_core disagrees with plain on {name} at n={n}: {bad} cells")
        del got, want
        reps_k, reps_p = (50, 5) if n > 4096 else (200, 20)
        k_ms = _time_cuda(torch, lambda: tick_core(*args, **consts), reps_k)
        p_ms = _time_cuda(torch, lambda: tick_core_reference(*args, **consts), reps_p)
        bytes_moved, n_ops, kernel_bytes = dense_core_work(ops)
        bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
        ops_ms = n_ops / INT32_OPS_PER_S * 1e3
        row = {
            "n": n, "f": f, "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": bytes_moved, "bytes_ms": bytes_ms,
            "int32_ops": n_ops, "ops_ms": ops_ms,
            "kernel_bytes": kernel_bytes,
            "kernel_bytes_ms": kernel_bytes / HBM_BYTES_PER_S * 1e3,
        }
        rows[n] = row
        say(
            f"[6] tick_core n={n} f={f}: bit-equal to plain (max_abs_err {err}); "
            f"kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, bound {row['bound_ms']:.4f} ms "
            f"by {row['bound_by']} ({bytes_moved} B = {bytes_ms:.4f} ms; "
            f"{n_ops} int32 ops = {ops_ms:.4f} ms); this kernel moves {kernel_bytes} B "
            f"= {row['kernel_bytes_ms']:.4f} ms; library_ms null — no single PyTorch "
            "call computes this function"
        )
        del ops, args
    return rows


def phase_dense_card_vs_cpu(torch):
    import numpy as np

    from scalecube_cluster_tpu_torch.ops.tick_core import tick_core
    from scalecube_cluster_tpu_torch.sim import state as dense
    from scalecube_cluster_tpu_torch.sim.convert import dense_state_to_numpy
    from scalecube_cluster_tpu_torch.sim.faults import FaultPlan
    from scalecube_cluster_tpu_torch.sim.params import SimParams
    from scalecube_cluster_tpu_torch.sim.run import run_chunked

    n, ticks, chunk, restart_after = 256, 60, 12, 1
    params = SimParams(
        n=n, gossip_fanout=3, periods_to_spread=8, periods_to_sweep=18,
        fd_period_ticks=2, sync_period_ticks=10, suspicion_ticks=12,
        ping_req_members=2, user_gossip_slots=2, pallas_delivery=True,
    )
    runs = {}
    card_launches = 0
    for dev in ("cuda", "cpu"):
        st = dense.kill(dense.init_full_view(n, user_gossip_slots=2, seed=3, device=dev), 5)
        plan = FaultPlan.uniform(10.0, device=dev)
        seeds = dense.seeds_mask(n, [0, 1], device=dev)
        before = tick_core.launches
        snaps = []
        for c in range(ticks // chunk):
            st, tr = run_chunked(params, st, plan, seeds, chunk, chunk=chunk)
            snaps.append((dense_state_to_numpy(st), tr))
            if c == restart_after:
                st = dense.restart(st, 5)
        if dev == "cuda":
            card_launches = tick_core.launches - before
        runs[dev] = snaps
    for c, ((a, ta), (b, tb)) in enumerate(zip(runs["cuda"], runs["cpu"])):
        if set(a) != set(b) or set(ta) != set(tb):
            fail(f"dense card/CPU leaf or metric sets differ at chunk {c}")
        for k in a:
            if not np.array_equal(a[k], b[k]):
                fail(f"dense card/CPU state leaf {k} differs after chunk {c}")
        for k in ta:
            if not np.array_equal(ta[k].view(np.uint8), tb[k].view(np.uint8)):
                fail(f"dense card/CPU metric {k} differs in chunk {c}")
    card = runs["cuda"]
    syncs = ticks // params.sync_period_ticks
    slow = ticks - card_launches
    if not syncs < slow < ticks:
        fail(f"dense card run: {card_launches} fused ticks of {ticks}; the joining "
             f"slow path did not run beside the {syncs} SYNC ticks")
    dead = sum(int(tr["verdicts_dead"].sum()) for _, tr in card)
    say(
        f"[7] dense card == CPU over {ticks} ticks at n={n} ({len(card[-1][0])} leaves, "
        f"{len(card[-1][1])} metrics, every chunk); fused ticks {card_launches}, slow "
        f"ticks {slow} ({syncs} SYNC, {slow - syncs} joining); verdicts_dead total {dead}; "
        f"final convergence {float(card[-1][1]['convergence'][-1]):.6f}"
    )


def phase_dense_main_path(torch):
    import numpy as np

    from scalecube_cluster_tpu_torch.bench import measure_dense
    from scalecube_cluster_tpu_torch.sim import state as dense
    from scalecube_cluster_tpu_torch.sim.faults import FaultPlan
    from scalecube_cluster_tpu_torch.sim.params import SimParams
    from scalecube_cluster_tpu_torch.sim.run import run_chunked

    n, chunk, reps = 10240, 40, 4
    params = SimParams.from_cluster_config(n)
    ticks = (reps + 1) * chunk
    expect = ticks - ticks // params.sync_period_ticks
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    row, state = measure_dense(n, chunk=chunk, reps=reps)
    counts = read_counts()
    launches = counts["tick_core"]
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    cpu_share = sum(row["chunk_thread_cpu_ms_per_tick"]) / sum(row["chunk_ms_per_tick"])
    say(
        f"[8] dense main path n={n}: {row['ms_per_tick']:.3f} ms/tick "
        f"(chunks {', '.join(f'{c:.3f}' for c in row['chunk_ms_per_tick'])}), "
        f"{row['member_rounds_per_s']:.1f} member·rounds/s, peak device memory "
        f"{peak_gib:.3f} GiB, launching thread on the CPU {cpu_share:.3f} of the wall, "
        f"launches {counts} (expect tick_core {expect}: {ticks} ticks less the SYNC ticks)"
    )
    if launches != expect:
        fail(f"tick_core launched {launches} times on the dense main path, expected {expect}")

    plan = FaultPlan.uniform(loss_percent=5.0, device="cuda")
    seeds = dense.seeds_mask(n, [0, 1], device="cuda")
    params = dataclasses.replace(params, pallas_delivery=True)
    state, tr = run_chunked(params, state, plan, seeds, chunk, chunk=chunk, collect=True)
    for k, v in tr.items():
        if v.shape[0] != chunk or not np.all(np.isfinite(v)):
            fail(f"dense metric {k} malformed: shape {v.shape}")
    if state.t_host != int(state.tick) or state.t_host != ticks + chunk:
        fail(f"tick {int(state.tick)} / mirror {state.t_host}, expected {ticks + chunk}")
    flagged = _flagging_viewers(state.alive, state.view[:, 7], 7)
    if flagged == 0:
        fail("no live viewer suspects or convicts the killed member 7")
    conv = float(tr["convergence"][-1])
    if not 0.0 < conv <= 1.0 or int(tr["n_alive"][-1]) != n - 1:
        fail(f"dense collect chunk: convergence {conv}, n_alive {int(tr['n_alive'][-1])}")
    say(
        f"[8] dense collect chunk: convergence {conv:.6f}, n_suspected "
        f"{int(tr['n_suspected'][-1])}, msgs_gossip {int(tr['msgs_gossip'].sum())}, "
        f"msgs_fd {int(tr['msgs_fd'].sum())}, live viewers flagging member 7: {flagged}"
    )
    return launches


def _kernel_entry(name, source, replaces, launches, row, checked_in):
    return {
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": launches,
        "max_abs_err": row["max_abs_err"],
        "ms": row["ms"],
        "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"],
        "bound_bytes_ms": row["bytes_ms"],
        "bound_ops_ms": row["ops_ms"],
        "library_ms": None,
        "checked_in": checked_in,
    }


def main() -> int:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device: the port's chip smoke runs only on the card")
    try:
        import scalecube_cluster_tpu_torch  # noqa: F401
    except ImportError as exc:
        fail(f"the port package is missing ({exc}); run from the repository root")

    t_start = time.perf_counter()
    card = phase_card(torch)
    phase_build()
    core_rows = phase_kernel_vs_plain(torch)
    phase_card_vs_cpu(torch)
    sparse_launches = phase_main_path(torch)
    dense_rows = phase_dense_kernel_vs_plain(torch)
    phase_dense_card_vs_cpu(torch)
    dense_launches = phase_dense_main_path(torch)

    kernels = {
        "kernels": [
            _kernel_entry(
                "sparse_core", "scalecube_cluster_tpu_torch/csrc/sparse_core.cu",
                "scalecube_cluster_tpu/ops/pallas_sparse.py:444", sparse_launches,
                core_rows[(32768, 512)],
                ["[3] kernel vs plain", "[4] card vs CPU", "[5] main path"],
            ),
            _kernel_entry(
                "tick_core", "scalecube_cluster_tpu_torch/csrc/tick_core.cu",
                "scalecube_cluster_tpu/ops/pallas_tick.py:476", dense_launches,
                dense_rows[10240],
                ["[6] kernel vs plain", "[7] card vs CPU", "[8] dense main path"],
            ),
        ]
    }
    say(f"[9] total {time.perf_counter() - t_start:.1f} s")
    say(json.dumps(kernels))
    say(card)
    say(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
