#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (scalecube_cluster_tpu_torch).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero):

1. the card (``nvidia-smi`` name and power limit) and the torch / CUDA
   versions;
2. the kernel builds: ``csrc/sparse_core.cu``, ``csrc/tick_core.cu``,
   ``csrc/sparse_persistent.cu``, ``csrc/delivery_merge.cu`` and
   ``csrc/probes.cu`` compiled for sm_90a, one nvcc each, all at once,
   with the compiler's register and spill report of each kernel;
3. sparse kernel vs plain on the card: the sparse-core kernel and its plain
   PyTorch version on the same seeded operands, at the bench shape
   (n=32768, S=512, f=3) and at n=1024, S=256 — all five outputs
   bit-equal; kernel and plain times and the bound (the larger of the
   bytes moved and the int32 operations the function needs); then at the
   kernel's tile edges (n=1024, S = 100, 260 and 101: point lanes beside
   every 128-lane tile boundary, one tile with no active lane, rows off
   16-byte alignment at S=101) — bit-equal;
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
   bit-equal; times and the bound; then at the kernel's tile edges (n = 264
   and 1032: FD targets beside every 256-column tile boundary, the
   diagonal in every tile) — bit-equal;
7. dense card vs CPU: a 60-tick trajectory (n=256, the fused core, FD
   every 2 ticks, SYNC every 10, suspicion 12, 10% loss, member 5 killed
   and restarted at tick 24 so the joining slow path runs, chunks of 12)
   — every state leaf and every metric equal after every chunk;
8. the dense main path: n=10240, LAN preset, fused core, 5% loss, one
   warm-up and four timed 40-tick chunks with collect=False (200 ticks;
   the kernel launched on every tick but the SYNC tick 150); then one
   collect=True chunk;
9. persistent kernel vs plain on the card: the k-tick sparse core and
   its plain version (k chained plain cores) at the sparse main path's
   width (n=32768, S=512, k_max=8) for k = 1, 2, 8, and at n=1024,
   S=256 (k_max=5) for k = 1, 3, 5 — all five outputs bit-equal; times
   per launch and per tick, the slope per added tick (from k=2) and the
   bound; then at the kernel's tile edges (S = 128 and 384: lanes beside
   every 128-lane boundary active, an idle second tile, ages and
   countdowns outside the packable range) and with the caller's planes
   off 16-byte alignment, at k = 1, 2 and k_max — bit-equal;
10. the persistent core's path: the k-sweep bench
    (``bench.py::measure_persistent_ksweep``) at n=32768, S=512, k_max=8,
    its rows and member·rounds/s per k printed; one cooperative launch per
    call, the library built and loaded once;
11. delivery-merge kernel vs plain on the card at n=10240, 256 and 96
    (f=3) — both outputs bit-equal; times and the bound; then at the
    kernel's tile edges (n = 264 and 1032: a partial last tile, fresh
    records beside every 256-column boundary, the diagonal in every tile)
    and with planes off 16-byte alignment — bit-equal;
12. the delivery-merge kernel's path: ``tools/profile_tick.py``'s ``main``
    at n=10240 with 4 iterations and 2 timed calls a piece, the kernel
    launched (2 + 1) x 4 times;
13. the five card probes (``tools/probe_kernels.py``) pass, each kernel
    equal to its plain version; their times, and the kernels' and library
    calls' times with the host's dispatch taken out (a CUDA-graph replay
    of the same 200 calls), beside the launch floor (an empty kernel's
    time, replayed the same way); each probe also bit-equal at ragged
    shapes (33x500, 1x4, 96x1028, 7x501, 3x2; p_window2d at 1 to 5 tiles
    and 8, 32 and 40 output rows), aligned and off 16-byte alignment, and
    at the dense main path's width (10240x10240; p_window2d 40 tiles into
    10240 output rows), where each is timed per call and alone beside its
    bound, its share of the bound and the launch floor (p_accum beside
    ``torch.sum``, p_roll beside ``torch.roll``);
14. the dense ``convergence`` sum (XLA:CPU's tree order) and the
    per-viewer means under it on the card equal the CPU's at n=10240 on
    seeded terms;
15. timelines, card vs CPU: one 3-segment ``FaultSchedule`` (5% loss under
    a 2-zone world with 400 ms cross-zone latency and zone loss; a dense
    partition with a flapping link set; clean), kill and restart events and
    host ops between chunks, run on both devices by the sparse engine at
    n=1024, S=256 (kernel route) and n=1000 (the XLA chain, 8-row fan-out
    groups) and by the dense engine at n=1024 (fused core) and with knobs
    (XLA core) — every state leaf and trace equal, the kernels launched on
    exactly the ticks the CPU run routes to them; and XLA:CPU's ``exp``
    and the world's loss composition card == CPU on seeded operands;
16. the scheduled sparse path at the bench width: n=32768, S=512, the
    kernel route, 48-tick chunks, one warm-up and 240 collected ticks under
    a 3-segment schedule (5% loss; the same with a 2-zone 400 ms brownout;
    5% loss) and one more uncollected chunk, 64 kills at tick 10, 32
    restarts at tick 100, and
    ``restart_many_sparse`` / ``leave_sparse`` / ``update_metadata_sparse``
    between chunks (the last two on live members that hold a slot: the
    kills fill the slab); ms/tick, member·rounds/s, peak memory and slot
    overflow; the kernel launched on every tick;
17. the dense timeline at the dense width: n=10240, fused core, 200 ticks
    in 40-tick chunks (the last collected) under the ``--geo`` brownout,
    then the partition-recovery cut (30% minority), then 5% loss; member 7
    killed at tick 5 and restarted at tick 120; the kernel launched on every
    tick the tick takes its fast path; then the ``--geo 10240`` bench row;
18. the flight recorder and elastic membership, card vs CPU at n=1024,
    S=256: a traced 60-tick churn timeline on the XLA chain (kills, a
    restart, 5% loss, a 2-zone brownout; host kills and restarts between
    chunks) — every state leaf, trace and ring field equal, no kernel
    launch; an elastic run (896 of 1024 live, the 128 capacity rows joined
    8 a tick) on the kernel route, ``promote_sparse_state`` to 2048 and 48
    more ticks joining 16 promoted rows, and a packed elastic checkpoint
    round trip — equal on both devices, ``sparse_core`` launched on the
    ticks the CPU run routes to it;
19. the elastic path at the sparse width: ``init_sparse_full_view(30720,
    512, n_alloc=32768)``, the main path's params, 5% loss, a kill, the
    2,048 capacity rows joined in 32 batches of 64 every 6 ticks from tick
    10, five collected 48-tick chunks (``sparse_core`` on every tick,
    ``n_live`` 30,720 → 32,768, ``joins_admitted`` 2,048), then
    ``promote_sparse_state`` to 65,536 and one collected chunk joining 64
    promoted rows; ms/tick before and after, the promotion's wall time and
    the peak device memory;
20. the flight recorder at the sparse width: the ``--tracer-overhead
    32768`` rung at S=512 (XLA chain, ring 1 << 19), the synchronising CUDA
    calls of one traced and one untraced chunk (the traced one makes no
    more), and a 528-tick run with a 1 << 27 ring whose decoded chains pass
    the C6 walk, every DEAD verdict's chain ending at a probe;
21. both fused cores over a leading universe axis (the grid's third
    axis): ``sparse_core`` at B=4, n=32768, S=512 and at B=3, n=1024,
    S=256 on tile-edge operands per universe; ``tick_core`` at B=16,
    n=1024 and at B=3, n=264 (tile edges) — each batched launch bit-equal
    to the batched plain version and to one launch per universe; its time
    beside one universe's launch and B times the single bound;
22. ensembles, card vs CPU: B=3 dense universes at n=256 under
    per-universe timelines (kills, a restart each, so one universe joins
    while the others do not) with knobs on the XLA core, then on the
    fused route without knobs; B=3 sparse universes at n=1024, S=256 on the
    XLA chain with knobs and on the kernel route — every leaf of every
    universe and every [B, T] trace equal after every chunk, and the
    ``ensemble_report`` rows equal;
23. the sparse ensemble at the main path's width: B=4 universes of
    n=32768, S=512 through the kernel (member 7 killed in each, 5% loss),
    one warm-up and four timed 48-tick chunks with
    ``ensemble_writeback_free`` between them, then one collected chunk —
    ``sparse_core`` launched once a tick for the whole batch; ms/tick,
    universes·member·rounds/s, peak memory, then launches a tick and the
    device idle share under the profiler; and the ``--ensemble 16 1024``
    rung beside the same rung at B=1;
24. the Rapid engine (sim/rapid.py, no kernel of its own), card vs CPU at
    n=16 and n=64 through the split-vote schedule of
    tests/test_rapid_fallback.py: the bare fast path (parked), the fallback
    with the flight recorder and a protocol join, 5% loss with knobs, an
    elastic run with joins then ``promote_rapid_state``, and a B=4 ensemble
    with the fallback — every leaf, metric and ring field equal, R1-R5
    certified, the fallback and join chains whole, no kernel launched;
25. the ``--rapid 1024`` rung: ms/tick, member·rounds/s, peak memory,
    synchronising calls a tick, and launches a tick and the idle share
    under the profiler;
26. Rapid at the dense width: n=10240, k=8, the fallback, a clean plan, 64
    members killed at tick 4 (every 160th row) and 32 of them restarted at
    tick 30 through the handshake, 60 collected ticks with a 1 << 20 ring —
    the batch committed as one view change on every live member, the
    readmission tick, R1-R5 and the chain walk certified, conservation on
    every tick; ms/tick (quiet against SYNC / vote ticks), peak memory and
    the synchronising calls of a quiet tick;
27. serving, card vs CPU (serve/bridge.py through testlib/serving.py's
    replays): kills, restarts (a duplicate cell, a capacity deferral) and
    user gossip at n=1024, S=256 through the fused core; wire joins with
    four parked, ``promote()`` to 2048 rows and more joins; joins aimed at
    ticks; Rapid at n=64 with the fallback, a kill and a protocol join —
    every state leaf, trace, export row, live row and counter equal, the
    kernel launched on every fused-core tick, and each replay with a
    schedule form equal on the card to its offline FaultSchedule run;
28. the serving main path: the ``--serve`` session at n=32768, S=512,
    the fused core, host-boundary write-backs, 5% loss, member 7 killed,
    a warm-up batch then six timed 48-tick batches of 4 gossip events a
    tick (capacity 8), collect=False; ms/tick against phase 5's, the
    bridge's row (events/s, member·rounds/s, batch latency p50/p95/p99),
    peak memory, synchronising calls a batch, ``sparse_core`` on 288 of
    288 serving ticks;
29. elastic serving at width: the ``--grow`` session, 16,384 live rows in
    32,768 grown by 49,152 wire joins (1,024 a batch) through one
    checkpoint-based promotion to 65,536, S=1024, the fused core; joins
    admitted a second, the promotion's wall time, ms/tick before and
    after it, peak memory, a certified zero of dropped joins;
30. the wire: ``native/framing.c`` built with ``cc`` and loaded, the
    ``--load`` harness (32 producers, 8 hostile, churn) against a session
    on the card at n=1024 (4-tick launches, 50 ms of the event loop for
    the producers between them) with every conservation verdict true, and
    a live session's ``serve/metrics`` poll equal to its Prometheus scrape;
31. the kernel table as one JSON line, the card's name and power limit,
    and the device line last.

Each path (the main paths, the k-sweep, the profile, the probes) runs
with every kernel count set to 0 just before it and read just after. There is no CPU fallback: without a CUDA device the
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
#: Bytes per cell that csrc/tick_core.cu moves from device memory by
#: design: rows once (its grid keeps each sender row's band in L2 across
#: its f reads), view0, age, susp read, four outputs written; the f - 1
#: other reads of each sender cell (:data:`DENSE_L2_REREAD_BYTES`) are
#: served by the L2.
DENSE_KERNEL_BYTES_PER_CELL = 4 + 4 + 1 + 2 + 4 + 1 + 2 + 4
DENSE_L2_REREAD_BYTES = 4
#: The same for csrc/sparse_core.cu: slab, age, susp read once and written
#: once; the f sender-window reads of each (slab, age) cell come from L2.
SPARSE_KERNEL_BYTES_PER_CELL = 2 * (4 + 1 + 2)
SPARSE_L2_REREAD_BYTES = 4 + 1
#: Persistent core, per tick: the sparse core's terms without the points.
#: Per cell of an active lane: the merge lattice 23; the countdown, DEAD
#: transition and aging 26; the cold lane's unpack (2) and pack (3) 5.
PERSIST_OPS_PER_ACTIVE_CELL = 23 + 26 + 5
#: Per cell of an inactive lane: the countdown, DEAD transition and aging
#: with no re-arm and no refill 17; the cold lane 5.
PERSIST_OPS_PER_IDLE_CELL = 17 + 5
#: Per sender cell on an active lane: the age unpack 1, the young test 1,
#: the alive-key test 2, the two masked payloads 3.
PERSIST_OPS_PER_SENDER_CELL = 7
#: Per row: the own lane 3, the liveness test 1 (the edge tests per (row,
#: channel) as in the sparse core).
PERSIST_OPS_PER_ROW = 4
#: The aggregate bits, per cell, on the last tick only.
OPS_PER_AGGR_CELL = 13
#: Bytes per cell and tick the persistent state streams between ticks
#: while it lives in device memory: slab i32 and cold i16, read and written.
PERSIST_STREAM_BYTES_PER_CELL = 2 * (4 + 2)
#: Delivery + merge, per cell: the merge lattice 23, the dead-row freeze 1.
DM_OPS_PER_CELL = 23 + 1
#: Per sender cell: the alive-key test 2, the masked alive payload 1.
DM_OPS_PER_SENDER_CELL = 3
#: Per row: the diagonal (self-rumor and exclusion) 3, the liveness test 1.
DM_OPS_PER_ROW = 4
#: Integer operations per cell of each probe's function: p_smallint's
#: compare, min, add and select (o8), subtract, max and select (o16) and
#: select (ov); p_accum's add per input cell; p_fdmask's compare and select;
#: the copies (p_window2d, p_roll) none. The kernels' extraction and
#: packing of bytes and halves within a word are the bytes side, as loads,
#: stores and address arithmetic are.
PROBE_OPS_PER_CELL = {
    "p_smallint": 8, "p_window2d": 0, "p_accum": 1, "p_fdmask": 2, "p_roll": 0,
}

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
    from scalecube_cluster_tpu_torch.ops import (
        cuda_build,
        delivery_merge,
        sparse_core,
        sparse_persistent,
        tick_core,
    )
    from scalecube_cluster_tpu_torch.tools import probe_kernels

    libraries = [sparse_core.LIBRARY, tick_core.LIBRARY, sparse_persistent.LIBRARY,
                 delivery_merge.LIBRARY, probe_kernels.LIBRARY]
    t0 = time.perf_counter()
    cuda_build.compile_all(libraries)
    for lib in libraries:
        lib.load()
    names = ", ".join(lib.source.name for lib in libraries)
    say(f"[2] built {names} for sm_90a in {time.perf_counter() - t0:.2f} s (one nvcc each, at once)")
    for lib in libraries:
        for line in lib.build_log.splitlines():
            if "Used" in line or "spill" in line or "Compiling entry" in line:
                say(f"[2] {lib.name}: {line.strip()}")


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


def _time_graph(torch, fn, reps):
    """Device ms per call of ``fn`` with the host's dispatch taken out:
    ``reps`` calls captured in one CUDA graph (after a warm-up on a side
    stream), timed with CUDA events over one replay after a first."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def _compare(outputs, got, want, what):
    """Fail unless every output of ``got`` equals ``want`` (dtype, shape,
    values); returns the largest absolute difference (0)."""
    err = 0
    for out, g, w in zip(outputs, got, want):
        if g.dtype != w.dtype or g.shape != w.shape:
            fail(f"{out} {what}: {g.dtype}{tuple(g.shape)} vs {w.dtype}{tuple(w.shape)}")
        diff = int((g.long() - w.long()).abs().max()) if g.numel() else 0
        err = max(err, diff)
        if diff > TOLERANCE:
            fail(f"kernel disagrees with plain on {out} {what}: {int((g != w).sum())} cells")
    return err


def _bound_row(bytes_moved, n_ops):
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    ops_ms = n_ops / INT32_OPS_PER_S * 1e3
    return {
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "bytes": bytes_moved, "bytes_ms": bytes_ms, "int32_ops": n_ops, "ops_ms": ops_ms,
    }


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
        TILE_LANES,
        sparse_core,
        sparse_core_reference,
    )
    from scalecube_cluster_tpu_torch.testing import random_operands, tile_edge_operands

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
        err = _compare(("slab2", "age2", "susp2", "self_rumor", "aggr"), got, want,
                       f"at n={n} S={s}")
        reps_k, reps_p = (50, 5) if n > 4096 else (200, 20)
        k_ms = _time_cuda(torch, lambda: sparse_core(*args, **consts), reps_k)
        p_ms = _time_cuda(torch, lambda: sparse_core_reference(*args, **consts), reps_p)
        row = {"n": n, "S": s, "f": f, "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
               **_bound_row(*core_work(ops))}
        rows[(n, s)] = row
        l2_bytes = f * n * s * SPARSE_L2_REREAD_BYTES
        say(
            f"[3] sparse_core n={n} S={s} f={f}: bit-equal to plain (max_abs_err {err}); "
            f"kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, bound {row['bound_ms']:.4f} ms "
            f"by {row['bound_by']} ({row['bytes']} B = {row['bytes_ms']:.4f} ms; "
            f"{row['int32_ops']} int32 ops = {row['ops_ms']:.4f} ms); the kernel moves "
            f"{n * s * SPARSE_KERNEL_BYTES_PER_CELL} B of planes from device memory by "
            f"design and re-reads {l2_bytes} B of sender windows from L2; library_ms null "
            "— no single PyTorch call computes this function"
        )
        del ops, args
    for n, s, seed in ((1024, 100, 3), (1024, 260, 4), (1024, 101, 5)):
        ops = {
            k: torch.from_numpy(v).cuda()
            for k, v in tile_edge_operands(n, s, 3, seed=seed).items()
        }
        args = tuple(ops.values())
        got = sparse_core(*args, **consts)
        want = sparse_core_reference(*args, **consts)
        torch.cuda.synchronize()
        err = _compare(("slab2", "age2", "susp2", "self_rumor", "aggr"), got, want,
                       f"at tile edges n={n} S={s}")
        say(f"[3] sparse_core tile edges n={n} S={s} (tile {TILE_LANES} lanes): bit-equal "
            f"to plain (max_abs_err {err})")
    return rows


def _fold_params(n, s):
    from scalecube_cluster_tpu_torch.sim.params import SimParams
    from scalecube_cluster_tpu_torch.sim.sparse import SparseParams

    base = SimParams(
        n=n, gossip_fanout=3, periods_to_spread=8, periods_to_sweep=18,
        fd_period_ticks=2, sync_period_ticks=10, suspicion_ticks=12,
        ping_req_members=2, user_gossip_slots=2,
    )
    return SparseParams(base=base, slot_budget=s, alloc_cap=16, in_scan_writeback=False,
                        pallas_core=True)


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
    from scalecube_cluster_tpu_torch.ops.delivery_merge import delivery_merge
    from scalecube_cluster_tpu_torch.ops.sparse_core import sparse_core
    from scalecube_cluster_tpu_torch.ops.sparse_persistent import sparse_core_persistent
    from scalecube_cluster_tpu_torch.ops.tick_core import tick_core
    from scalecube_cluster_tpu_torch.tools.probe_kernels import PROBES

    wrappers = {
        "sparse_core": sparse_core,
        "tick_core": tick_core,
        "sparse_core_persistent": sparse_core_persistent,
        "delivery_merge": delivery_merge,
    }
    wrappers.update({name: probe[1] for name, probe in PROBES.items()})
    return wrappers


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

    params = SparseParams.for_n(n, slot_budget=s, in_scan_writeback=False, pallas_core=True)
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
    return launches, row


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
    bytes the kernel moves from device memory by design and the sender-row
    re-reads its L2 serves."""
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
    l2_bytes = (f - 1) * cells * DENSE_L2_REREAD_BYTES
    deliveries = int(ops["edge_ok"].sum()) * n
    n_ops = (
        cells * (DENSE_OPS_PER_CELL + DENSE_OPS_PER_SENDER_CELL)
        + deliveries * OPS_PER_DELIVERY
        + f * n * OPS_PER_EDGE_TEST
        + n * DENSE_OPS_PER_ROW
    )
    return bytes_moved, n_ops, kernel_bytes, l2_bytes


def phase_dense_kernel_vs_plain(torch):
    from scalecube_cluster_tpu_torch.ops.tick_core import (
        TILE_COLS,
        tick_core,
        tick_core_reference,
    )
    from scalecube_cluster_tpu_torch.testing import random_tick_operands, tile_edge_tick_operands

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
        err = _compare(names, got, want, f"of tick_core at n={n}")
        del got, want
        reps_k, reps_p = (50, 5) if n > 4096 else (200, 20)
        k_ms = _time_cuda(torch, lambda: tick_core(*args, **consts), reps_k)
        p_ms = _time_cuda(torch, lambda: tick_core_reference(*args, **consts), reps_p)
        bytes_moved, n_ops, kernel_bytes, l2_bytes = dense_core_work(ops)
        row = {
            "n": n, "f": f, "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
            **_bound_row(bytes_moved, n_ops),
            "kernel_bytes": kernel_bytes,
            "kernel_bytes_ms": kernel_bytes / HBM_BYTES_PER_S * 1e3,
            "l2_reread_bytes": l2_bytes,
        }
        rows[n] = row
        say(
            f"[6] tick_core n={n} f={f}: bit-equal to plain (max_abs_err {err}); "
            f"kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, bound {row['bound_ms']:.4f} ms "
            f"by {row['bound_by']} ({bytes_moved} B = {row['bytes_ms']:.4f} ms; "
            f"{n_ops} int32 ops = {row['ops_ms']:.4f} ms); the kernel moves {kernel_bytes} B "
            f"= {row['kernel_bytes_ms']:.4f} ms from device memory by design and re-reads "
            f"{l2_bytes} B of sender rows from L2; library_ms null — no single PyTorch "
            "call computes this function"
        )
        del ops, args
    for n, seed in ((264, 3), (1032, 4)):
        ops = {
            k: torch.from_numpy(v).cuda()
            for k, v in tile_edge_tick_operands(n, 3, seed=seed, susp_ticks=350).items()
        }
        got = tick_core(*ops.values(), **consts)
        want = tick_core_reference(*ops.values(), **consts)
        torch.cuda.synchronize()
        err = _compare(names, got, want, f"of tick_core at tile edges n={n}")
        say(f"[6] tick_core tile edges n={n} (tile {TILE_COLS} columns): bit-equal to plain "
            f"(max_abs_err {err})")
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


def persistent_work(ops, k):
    """The least the persistent core must do for ``k`` ticks on these
    operands: the bytes of its own inputs and outputs (each read or written
    once: slab, age and susp in and out, the k ticks' tables, self-rumor
    and aggregate), the integer operations of k plain ticks and the last
    tick's aggregate (data-dependent terms from the operands); and the
    bytes a design that keeps the state in device memory between ticks
    streams (:data:`PERSIST_STREAM_BYTES_PER_CELL` per cell and tick)."""
    n, s = ops["slab"].shape
    f = ops["ginv"].shape[1]
    cells = n * s
    tables = sum(ops[k_].numel() * ops[k_].element_size() for k_ in ("ginv", "rots", "edge_ok"))
    k_max = ops["ginv"].shape[0]
    vectors = tables * k // k_max + sum(
        ops[k_].numel() * ops[k_].element_size() for k_ in ("slot_subj", "alive")
    )
    bytes_moved = 2 * cells * (4 + 1 + 2) + vectors + 4 * n + 4 * s
    n_active = int((ops["slot_subj"] >= 0).sum())
    per_tick = (
        n * n_active * (PERSIST_OPS_PER_ACTIVE_CELL + PERSIST_OPS_PER_SENDER_CELL)
        + n * (s - n_active) * PERSIST_OPS_PER_IDLE_CELL
        + f * n * OPS_PER_EDGE_TEST + n * PERSIST_OPS_PER_ROW + s * OPS_PER_LANE
    )
    deliveries = int(ops["edge_ok"][:k].sum()) * n_active
    n_ops = k * per_tick + deliveries * OPS_PER_DELIVERY + cells * OPS_PER_AGGR_CELL
    return bytes_moved, n_ops, k * cells * PERSIST_STREAM_BYTES_PER_CELL


def phase_persistent_vs_plain(torch):
    from scalecube_cluster_tpu_torch.ops.sparse_persistent import (
        sparse_core_persistent,
        sparse_core_persistent_reference,
    )
    from scalecube_cluster_tpu_torch.testing import (
        misaligned,
        persistent_operands,
        tile_edge_persistent_operands,
    )

    names = ("slab", "age", "susp", "self_rumor", "aggr")
    kw = dict(spread=6, susp_ticks=20, age_stale=120, sweep=6,
              fold=frozenset({"countdown", "wb_mask", "view_rows"}))
    rows = {}
    for n, s, k_max, ks in ((32768, 512, 8, (1, 2, 8)), (1024, 256, 5, (1, 3, 5))):
        ops = {k_: torch.from_numpy(v).cuda()
               for k_, v in persistent_operands(n, s, 3, k_max, seed=1).items()}
        args = tuple(ops.values())
        for k in ks:
            got = sparse_core_persistent(*args, k, k_max=k_max, **kw)
            want = sparse_core_persistent_reference(*args, k, k_max=k_max, **kw)
            torch.cuda.synchronize()
            err = _compare(names, got, want, f"at n={n} S={s} k={k}")
            del got, want
            reps_k, reps_p = (20, 2) if n > 4096 else (100, 10)
            k_ms = _time_cuda(torch, lambda: sparse_core_persistent(*args, k, k_max=k_max, **kw), reps_k)
            p_ms = _time_cuda(
                torch, lambda: sparse_core_persistent_reference(*args, k, k_max=k_max, **kw), reps_p)
            bytes_moved, n_ops, streamed = persistent_work(ops, k)
            row = {"n": n, "S": s, "k": k, "k_max": k_max, "max_abs_err": err,
                   "ms": k_ms, "ms_per_tick": k_ms / k, "plain_ms": p_ms,
                   "grid": sparse_core_persistent.grid,
                   "streamed_bytes": streamed,
                   "streamed_ms": streamed / HBM_BYTES_PER_S * 1e3,
                   **_bound_row(bytes_moved, n_ops)}
            rows[(n, k)] = row
            say(
                f"[9] sparse_core_persistent n={n} S={s} k={k} (k_max {k_max}, "
                f"{row['grid']} CTAs): bit-equal to plain (max_abs_err {err}); kernel "
                f"{k_ms:.4f} ms = {k_ms / k:.4f} ms/tick, plain {p_ms:.4f} ms; bound "
                f"{row['bound_ms']:.4f} ms by {row['bound_by']} ({bytes_moved} B = "
                f"{row['bytes_ms']:.4f} ms; {n_ops} int32 ops = {row['ops_ms']:.4f} ms); "
                f"state streamed between ticks {streamed} B = {row['streamed_ms']:.4f} ms; "
                "library_ms null — no single PyTorch call computes this function"
            )
        del ops, args
    # From k=2: a k=1 call is short enough for a slow host to set its time.
    slope = (rows[(32768, 8)]["ms"] - rows[(32768, 2)]["ms"]) / 6
    say(f"[9] sparse_core_persistent n=32768 S=512: {slope:.4f} ms per added tick "
        f"((k=8 - k=2) / 6); state streamed per tick "
        f"{rows[(32768, 1)]['streamed_ms']:.4f} ms at the card's memory rate")
    # Tile edges (an idle second tile, lanes beside every boundary active,
    # ages and countdowns outside the packable range), at f=3 and at the
    # general channel loop's f=2 and f=7.
    for n, s, f, k_max in ((1024, 128, 3, 4), (1024, 384, 3, 4), (512, 256, 2, 3),
                           (512, 256, 7, 3)):
        ops = [torch.from_numpy(v).cuda()
               for v in tile_edge_persistent_operands(n, s, f, k_max, seed=5).values()]
        for k in (1, 2, k_max):
            got = sparse_core_persistent(*ops, k, k_max=k_max, **kw)
            want = sparse_core_persistent_reference(*ops, k, k_max=k_max, **kw)
            torch.cuda.synchronize()
            err = _compare(names, got, want, f"at tile edges n={n} S={s} f={f} k={k}")
        say(f"[9] sparse_core_persistent tile edges n={n} S={s} f={f} k = 1, 2, {k_max}: "
            f"bit-equal to plain (max_abs_err {err})")
    # Caller planes off 16-byte alignment are refused before any launch.
    ops[0] = misaligned(ops[0])
    launches = sparse_core_persistent.launches
    try:
        sparse_core_persistent(*ops, 1, k_max=k_max, **kw)
        fail("sparse_core_persistent took a slab off 16-byte alignment")
    except ValueError as exc:
        if sparse_core_persistent.launches != launches:
            fail("sparse_core_persistent launched on a refused plane")
        say(f"[9] sparse_core_persistent slab off 16-byte alignment: refused ({exc})")
    return rows


def phase_persistent_path(torch):
    from scalecube_cluster_tpu_torch.bench import measure_persistent_ksweep
    from scalecube_cluster_tpu_torch.ops import sparse_persistent

    n, s, k_max, reps = 32768, 512, 8, 4
    reset_counts()
    sweep = measure_persistent_ksweep(n, k_max, reps=reps, slot_budget=s)
    counts = read_counts()
    launches = counts["sparse_core_persistent"]
    expect = 1 + k_max * reps
    for row in sweep:
        say(f"[10] {json.dumps(row)}")
    say("[10] member·rounds/s by k: " + ", ".join(
        f"k={r['k']} {r['value']:.1f}" for r in sweep))
    say(f"[10] k-sweep n={n} S={s} k_max={k_max}: launches {counts} (expect "
        f"sparse_core_persistent {expect}: one warm-up, {reps} per k); library "
        f"loads {sparse_persistent.LIBRARY.loads}")
    if launches != expect:
        fail(f"sparse_core_persistent launched {launches} times on the k-sweep, expected {expect}")
    if sparse_persistent.LIBRARY.loads != 1 or not all(r["zero_recompile"] for r in sweep):
        fail("the persistent kernel's library was built or loaded more than once")
    if [r["k"] for r in sweep] != list(range(1, k_max + 1)) or not all(
        r["value"] > 0 for r in sweep
    ):
        fail("k-sweep rows malformed")
    return launches, sweep


def delivery_merge_work(ops):
    """The least the delivery + merge must do on these operands: rows and
    local read once, merged written once (12 B per cell) plus the vectors
    and the self-rumor; the integer operations its function needs, the
    delivered (cell, channel) term counted from the edge bits."""
    n = ops["view0"].shape[0]
    f = ops["ginv"].shape[0]
    cells = n * n
    vectors = sum(ops[k].numel() * ops[k].element_size()
                  for k in ("ginv", "rots", "edge_ok", "alive"))
    bytes_moved = cells * 12 + vectors + 4 * n
    deliveries = int(ops["edge_ok"].sum()) * n
    n_ops = (
        cells * (DM_OPS_PER_CELL + DM_OPS_PER_SENDER_CELL)
        + deliveries * OPS_PER_DELIVERY
        + f * n * OPS_PER_EDGE_TEST
        + n * DM_OPS_PER_ROW
    )
    return bytes_moved, n_ops


def phase_delivery_merge_vs_plain(torch):
    from scalecube_cluster_tpu_torch.ops.delivery_merge import (
        delivery_merge,
        delivery_merge_reference,
    )
    from scalecube_cluster_tpu_torch.testing import (
        misaligned,
        random_tick_operands,
        tile_edge_merge_operands,
    )

    fields = ("rows", "view0", "ginv", "rots", "edge_ok", "alive")
    rows = {}
    for n, seed in ((10240, 3), (256, 4), (96, 5)):
        ops = {k: torch.from_numpy(v).cuda()
               for k, v in random_tick_operands(n, 3, seed=seed).items() if k in fields}
        args = tuple(ops[k] for k in fields)
        got = delivery_merge(*args)
        want = delivery_merge_reference(*args)
        torch.cuda.synchronize()
        err = _compare(("merged", "self_rumor"), got, want, f"at n={n}")
        del got, want
        reps_k, reps_p = (50, 5) if n > 4096 else (200, 20)
        k_ms = _time_cuda(torch, lambda: delivery_merge(*args), reps_k)
        p_ms = _time_cuda(torch, lambda: delivery_merge_reference(*args), reps_p)
        row = {"n": n, "f": 3, "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
               **_bound_row(*delivery_merge_work(ops))}
        rows[n] = row
        say(
            f"[11] delivery_merge n={n} f=3: bit-equal to plain (max_abs_err {err}); "
            f"kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, bound {row['bound_ms']:.4f} ms "
            f"by {row['bound_by']} ({row['bytes']} B = {row['bytes_ms']:.4f} ms; "
            f"{row['int32_ops']} int32 ops = {row['ops_ms']:.4f} ms); library_ms null — "
            "no single PyTorch call computes this function"
        )
        del ops, args
    # Tile edges (a partial last tile, fresh records beside every boundary,
    # the diagonal in every tile), planes off 16-byte alignment, and the
    # general channel loop's f=2 and f=8.
    for n, f, misalign in ((264, 3, False), (1032, 3, False), (264, 2, True), (264, 2, False),
                           (1032, 8, False)):
        ops = tile_edge_merge_operands(n, f, seed=6)
        args = [torch.from_numpy(ops[k]).cuda() for k in fields]
        if misalign:
            args[:2] = [misaligned(t) for t in args[:2]]
        got = delivery_merge(*args)
        want = delivery_merge_reference(*args)
        torch.cuda.synchronize()
        err = _compare(("merged", "self_rumor"), got, want, f"at tile edges n={n}")
        say(f"[11] delivery_merge tile edges n={n} f={f}"
            f"{' (planes off 16-byte alignment)' if misalign else ''}: bit-equal to plain "
            f"(max_abs_err {err})")
    return rows


def phase_delivery_merge_path(torch):
    from scalecube_cluster_tpu_torch.tools import profile_tick

    n, iters, calls = 10240, 4, 2
    reset_counts()
    pieces = profile_tick.main(n, iters=iters, calls=calls)
    counts = read_counts()
    launches = counts["delivery_merge"]
    expect = (calls + 1) * iters
    say(f"[12] profile_tick n={n} (iters {iters}, calls {calls}): "
        f"{json.dumps(pieces)}; launches {counts} (expect delivery_merge {expect})")
    if launches != expect:
        fail(f"delivery_merge launched {launches} times on the profile path, expected {expect}")
    if len(pieces) != 8 or not all(0.0 < ms < 1e5 for ms in pieces.values()):
        fail(f"profile_tick pieces malformed: {pieces}")
    return launches


def probe_work(pk, name, args, **kw):
    """The least probe ``name`` must do on ``args`` (``kw``: p_window2d's
    ``out_rows``): the bytes its function reads and writes, each once and
    only where the function needs them (p_window2d: each tile's window of
    min(out_rows, 8) rows of ``rows``; p_smallint: ``v`` only at the young
    cells of these ages), and its integer operations (per cell of the
    output, per input cell for p_smallint and p_accum)."""
    outs = pk.PROBES[name][2](*args, **kw)
    outs = outs if isinstance(outs, tuple) else (outs,)
    out_bytes = sum(o.numel() * o.element_size() for o in outs)
    if name == "p_window2d":
        rows, idx = args
        window = min(outs[0].shape[0], 8) * pk.WINDOW_MC * rows.element_size()
        in_bytes = idx.numel() * (window + idx.element_size())
    elif name == "p_smallint":
        a8, a16, v = args
        young = int((a8 < 7).sum())
        in_bytes = a8.numel() * (a8.element_size() + a16.element_size()) + young * v.element_size()
    else:
        in_bytes = sum(a.numel() * a.element_size() for a in args)
    cells = args[0].numel() if name in ("p_smallint", "p_accum") else outs[0].numel()
    return in_bytes + out_bytes, cells * PROBE_OPS_PER_CELL[name]


def _probe_vs_plain(torch, pk, name, args, what, **kw):
    """Fail unless probe ``name``'s kernel equals its plain version on
    ``args`` (``kw``: p_window2d's ``out_rows``), every output; returns the
    largest absolute difference (0)."""
    _, wrapper, reference, _ = pk.PROBES[name]
    got, want = wrapper(*args, **kw), reference(*args, **kw)
    torch.cuda.synchronize()
    got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
    return _compare([f"{name} output {i}" for i in range(len(got))], got, want, what)


def _probe_wide(torch, pk, name, floor_ms):
    """Probe ``name`` at the dense main path's width (p_window2d: 40 tiles
    of ``rows`` [10240, 10240] into 10240 output rows): bit-equal to the
    plain version, then timed per wrapper call (CUDA events) and on the
    device alone (graph replay), beside the bound and, for p_accum and
    p_roll, one ``torch.sum`` or ``torch.roll``."""
    _, wrapper, reference, _ = pk.PROBES[name]
    args = [torch.from_numpy(a).cuda() for a in pk.shaped_inputs(name, pk.WIDE_SHAPE, seed=7)]
    kw = {"out_rows": pk.WIDE_SHAPE[0]} if name == "p_window2d" else {}
    err = _probe_vs_plain(torch, pk, name, args, f"at {pk.WIDE_SHAPE}", **kw)
    reps = 20
    library = {"p_accum": lambda: torch.sum(args[0], dim=1, dtype=torch.int32),
               "p_roll": lambda: torch.roll(args[0], pk.ROLL_SHIFT, dims=0)}.get(name)
    row = {
        "shape": list(pk.WIDE_SHAPE), **kw, "max_abs_err": err,
        "ms": _time_cuda(torch, lambda: wrapper(*args, **kw), reps),
        "ms_device": _time_graph(torch, lambda: wrapper(*args, **kw), reps),
        "plain_ms": _time_cuda(torch, lambda: reference(*args, **kw), reps),
        "library_ms": _time_cuda(torch, library, reps) if library else None,
        "library_ms_device": _time_graph(torch, library, reps) if library else None,
        "launch_floor_ms": floor_ms,
        **_bound_row(*probe_work(pk, name, args, **kw)),
    }
    row["share_of_bound"] = row["bound_ms"] / row["ms_device"]
    lib = row["library_ms_device"]
    say(f"[13] {name} at {pk.WIDE_SHAPE[0]}x{pk.WIDE_SHAPE[1]}: bit-equal; kernel "
        f"{row['ms']:.4f} ms, {row['ms_device']:.4f} ms on the device alone "
        f"({row['share_of_bound']:.3f} of the bound); plain {row['plain_ms']:.4f} ms; library "
        f"{'null' if lib is None else f'{lib:.4f} ms alone'}; bound {row['bound_ms']:.4f} ms "
        f"by {row['bound_by']} ({row['bytes']} B); launch floor {floor_ms:.5f} ms")
    return row


def phase_probes(torch):
    from scalecube_cluster_tpu_torch.testing import misaligned
    from scalecube_cluster_tpu_torch.tools import probe_kernels as pk

    reset_counts()
    results = pk.run_probes("cuda")
    counts = read_counts()
    rows = {}
    errs = {r["name"]: r["max_abs_err"] for r in results}
    for r in results:
        say(f"[13] {'PASS' if r['ok'] else 'FAIL'} {r['name']} ({r['title']})")
        if not r["ok"]:
            fail(f"probe {r['name']} failed: {r['error'] or r['max_abs_err']}")
    # The launch floor: an empty kernel on the device alone, as the probes below.
    floor_ms = _time_graph(torch, pk.noop, 200)
    say(f"[13] launch floor: an empty kernel takes {floor_ms:.5f} ms on the device alone")
    for name, ops in pk.probe_inputs(0).items():
        _, wrapper, reference, _ = pk.PROBES[name]
        args = [torch.from_numpy(a).cuda() for a in ops]
        k_ms = _time_cuda(torch, lambda: wrapper(*args), 200)
        p_ms = _time_cuda(torch, lambda: reference(*args), 200)
        bytes_moved, n_ops = probe_work(pk, name, args)
        # One PyTorch call computes p_accum (a row sum) and p_roll (a roll).
        library = {"p_accum": lambda: torch.sum(args[0], dim=1, dtype=torch.int32),
                   "p_roll": lambda: torch.roll(args[0], pk.ROLL_SHIFT, dims=0)}.get(name)
        lib_ms = _time_cuda(torch, library, 200) if library else None
        # The same calls with the host's dispatch taken out: 200 captured in
        # one CUDA graph, timed over a replay.
        k_dev = _time_graph(torch, lambda: wrapper(*args), 200)
        lib_dev = _time_graph(torch, library, 200) if library else None
        row = {"max_abs_err": errs[name], "ms": k_ms, "plain_ms": p_ms, "library_ms": lib_ms,
               "ms_device": k_dev, "library_ms_device": lib_dev, "launch_floor_ms": floor_ms,
               **_bound_row(bytes_moved, n_ops)}
        rows[name] = row
        say(f"[13] {name}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, library "
            f"{'null' if lib_ms is None else f'{lib_ms:.4f} ms'}; graph replay (no host "
            f"dispatch): kernel {k_dev:.4f} ms, library "
            f"{'null' if lib_dev is None else f'{lib_dev:.4f} ms'}, launch floor "
            f"{floor_ms:.5f} ms; bound {row['bound_ms']:.6f} ms by {row['bound_by']} "
            f"({bytes_moved} B)")
    for name in pk.PROBES:
        if counts[name] != 1:
            fail(f"probe {name} launched {counts[name]} times on its path, expected 1")
    # Every probe beyond its own shape: ragged shapes (p_window2d: tile and
    # output row counts), the last operand (p_window2d: rows) off 16-byte
    # alignment (the scalar path), then the dense main path's width.
    for name in pk.PROBES:
        if name == "p_window2d":
            cases = [((n, tiles * pk.WINDOW_MC), {"out_rows": out_rows})
                     for n, tiles, out_rows in pk.WINDOW_SHAPES]
        else:
            cases = [(shape, {}) for shape in pk.RAGGED_SHAPES]
        for shape, kw in cases:
            args = [torch.from_numpy(a).cuda() for a in pk.shaped_inputs(name, shape, seed=7)]
            what = f"at {shape} {kw or ''}"
            _probe_vs_plain(torch, pk, name, args, what, **kw)
            i = 0 if name == "p_window2d" else -1
            args[i] = misaligned(args[i])
            _probe_vs_plain(torch, pk, name, args, f"{what} off 16-byte alignment", **kw)
        shown = (pk.WINDOW_SHAPES if name == "p_window2d" else pk.RAGGED_SHAPES)
        say(f"[13] {name}: bit-equal at {', '.join('x'.join(map(str, s)) for s in shown)}"
            f"{' (rows x tiles x output rows)' if name == 'p_window2d' else ''}, "
            "aligned and off 16-byte alignment")
        rows[name]["wide"] = _probe_wide(torch, pk, name, floor_ms)
        torch.cuda.empty_cache()
    return rows, counts


def phase_convergence_sum(torch):
    import numpy as np

    from scalecube_cluster_tpu_torch.sim.tick import xla_cpu_sum_f32, xla_row_means_f32

    n = 10240
    rng = np.random.default_rng(0)
    match = torch.from_numpy(rng.random((16, n)) < 0.97)
    means_card = xla_row_means_f32(match.cuda()).cpu()
    if not torch.equal(means_card.view(torch.int32), xla_row_means_f32(match).view(torch.int32)):
        fail("per-viewer means differ between the card and the CPU")
    terms = (rng.integers(n // 2, n + 1, n).astype(np.float32) / np.float32(n)) * (
        rng.random(n) < 0.95)
    card = xla_cpu_sum_f32(torch.from_numpy(terms).cuda()).cpu()
    cpu = xla_cpu_sum_f32(torch.from_numpy(terms))
    if card.view(torch.int32) != cpu.view(torch.int32):
        fail(f"convergence sum differs on the card: {float(card)!r} vs {float(cpu)!r}")
    say(f"[14] convergence sum (XLA:CPU tree order) and viewer means at n={n}: "
        f"card == CPU ({float(card)!r})")


def _timeline(n, device):
    """Phase 15's schedule: 5% loss under a 2-zone world (400 ms cross-zone
    latency, 5% zone loss) from tick 1; a dense partition (a third against
    the rest) with a flapping link set from tick 25; clean from tick 49;
    kills at ticks 3 and 4, restarts at 10 and 30, a bounce at 36."""
    import numpy as np

    from scalecube_cluster_tpu_torch.sim.faults import FaultPlan
    from scalecube_cluster_tpu_torch.sim.schedule import ScheduleBuilder
    from scalecube_cluster_tpu_torch.sim.topology import LinkWorld

    world = (LinkWorld.even_zones(n, 2, device=device)
             .with_zone_latency(0, 1, 400.0).with_zone_loss(0, 1, 0.05))
    flap = np.zeros((n, n), bool)
    flap[: n // 4, n // 2:] = True
    return (
        ScheduleBuilder(n)
        .add_segment(1, FaultPlan.uniform(5.0, device=device), link_world=world)
        .add_segment(25, FaultPlan.clean(n, device=device).partition(range(n // 3),
                                                                      range(n // 3, n)),
                     flap_mask=flap, flap_period=6, flap_on=2)
        .add_segment(49, FaultPlan.clean(n, device=device))
        .kill(3, 7).kill(4, 11).restart(10, 7).restart(30, 11).kill(36, 2).restart(36, 2)
        .build()
    )


class _RouteCounter:
    """Counts calls of a module-level function for the duration of a run
    (the CPU twin of a kernel's launch count)."""

    def __init__(self, module, name):
        self.module, self.name, self.calls = module, name, 0
        self.orig = getattr(module, name)

    def __enter__(self):
        def counted(*a, **kw):
            self.calls += 1
            return self.orig(*a, **kw)

        setattr(self.module, self.name, counted)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


def phase_timelines_card_vs_cpu(torch):
    import numpy as np

    from scalecube_cluster_tpu_torch.ops.sparse_core import sparse_core
    from scalecube_cluster_tpu_torch.ops.tick_core import tick_core
    from scalecube_cluster_tpu_torch.sim import faults, tick as tick_mod
    from scalecube_cluster_tpu_torch.sim import sparse as sparse_mod
    from scalecube_cluster_tpu_torch.sim import state as dense
    from scalecube_cluster_tpu_torch.sim.convert import (
        dense_state_to_numpy,
        sparse_state_to_numpy,
    )
    from scalecube_cluster_tpu_torch.sim.knobs import make_knobs
    from scalecube_cluster_tpu_torch.sim.params import SimParams
    from scalecube_cluster_tpu_torch.sim.run import run_chunked
    from scalecube_cluster_tpu_torch.sim.topology import LinkWorld

    # XLA:CPU's exp and the world's fused loss composition: card == CPU.
    rng = np.random.default_rng(15)
    x = torch.from_numpy(rng.uniform(-90.0, 89.0, 1 << 20).astype(np.float32))
    if not torch.equal(faults.xla_exp_f32(x.cuda()).cpu().view(torch.int32),
                       faults.xla_exp_f32(x).view(torch.int32)):
        fail("xla_exp_f32 differs between the card and the CPU")
    n = 4096
    src = torch.from_numpy(rng.integers(0, n, (n, 3)).astype(np.int32))
    dst = torch.arange(n, dtype=torch.int32)[:, None]
    u = torch.from_numpy(rng.uniform(size=(n, 3)).astype(np.float32))
    loss = {}
    for dev in ("cuda", "cpu"):
        world = LinkWorld.even_zones(n, 2, device=dev).with_zone_loss(0, 1, 0.05)
        plan = faults.FaultPlan.uniform(3.0, 400.0, device=dev).with_link_world(world)
        legs = [(src.to(dev), dst.to(dev)), (dst.to(dev), src.to(dev))]
        loss[dev] = (faults.edge_loss(plan, *legs[0]).cpu(),
                     faults.round_trip_in_time_from(u.to(dev), plan, legs, 200.0).cpu())
    if not all(torch.equal(a.view(torch.int32) if a.dtype == torch.float32 else a,
                           b.view(torch.int32) if b.dtype == torch.float32 else b)
               for a, b in zip(loss["cuda"], loss["cpu"])):
        fail("edge_loss / round_trip_in_time_from differ between the card and the CPU")

    ticks, chunk = 60, 12
    runs = {}

    def compare(name, card, cpu):
        for c, ((a, ta), (b, tb)) in enumerate(zip(card, cpu)):
            if set(a) != set(b) or set(ta) != set(tb):
                fail(f"[15] {name}: leaf or trace sets differ at chunk {c}")
            for k in a:
                if not np.array_equal(a[k], b[k]):
                    fail(f"[15] {name}: state leaf {k} differs after chunk {c}")
            for k in ta:
                if not np.array_equal(np.asarray(ta[k]).view(np.uint8),
                                      np.asarray(tb[k]).view(np.uint8)):
                    fail(f"[15] {name}: trace {k} differs in chunk {c}")

    # Sparse: the kernel route at n=1024, S=256; the XLA chain at n=1000.
    for n, s, pallas in ((1024, 256, True), (1000, 256, False)):
        params = dataclasses.replace(_fold_params(n, s), pallas_core=pallas)
        snaps, route = {}, {}
        for dev in ("cuda", "cpu"):
            sched = _timeline(n, dev)
            st = sparse_mod.init_sparse_full_view(n, s, user_gossip_slots=2,
                                                  record_latency=True, device=dev)
            out = []
            launches0 = sparse_core.launches
            with _RouteCounter(sparse_mod, "sparse_core") as counter:
                for c in range(ticks // chunk):
                    st, tr = sparse_mod.run_sparse_chunked(params, st, sched, chunk, chunk=chunk)
                    out.append((sparse_state_to_numpy(st), tr))
                    if c == 1:
                        st = sparse_mod.restart_many_sparse(st, [20, 21])
                    if c == 2:
                        st = sparse_mod.update_metadata_sparse(
                            sparse_mod.leave_sparse(st, 30), 31)
            snaps[dev] = out
            route[dev] = (counter.calls, sparse_core.launches - launches0)
        compare(f"sparse n={n}", snaps["cuda"], snaps["cpu"])
        expect = ticks if pallas and n % 32 == 0 else 0
        if route["cuda"] != (expect, expect) or route["cpu"][0] != expect:
            fail(f"[15] sparse n={n}: kernel routes {route}, expected {expect} of {ticks}")
        tr = snaps["cuda"][0][1]
        say(f"[15] sparse n={n} S={s} pallas_core={pallas}: card == CPU over {ticks} ticks "
            f"({len(snaps['cuda'][-1][0])} leaves, {len(tr)} trace keys); sparse_core "
            f"launches {route['cuda'][1]} (expected {expect}); zone_intra_conv[0] "
            f"{tr['zone_intra_conv'][0].tolist()}, kills_fired {int(tr['kills_fired'].sum())}")

    # Dense: the fused core, then knobs on the XLA core.
    n = 1024
    for label, pallas, knobbed in (("fused", True, False), ("knobs", False, True)):
        params = SimParams(
            n=n, gossip_fanout=3, periods_to_spread=8, periods_to_sweep=18,
            fd_period_ticks=2, sync_period_ticks=10, suspicion_ticks=12,
            ping_req_members=2, user_gossip_slots=2, pallas_delivery=pallas,
        )
        snaps, route = {}, {}
        for dev in ("cuda", "cpu"):
            sched = _timeline(n, dev)
            knobs = make_knobs(params, 1.5, 2, device=dev) if knobbed else None
            st = dense.init_full_view(n, user_gossip_slots=2, seed=3, device=dev)
            seeds = dense.seeds_mask(n, [0, 1], device=dev)
            out = []
            launches0 = tick_core.launches
            with _RouteCounter(tick_mod, "tick_core") as counter:
                for c in range(ticks // chunk):
                    st, tr = run_chunked(params, st, sched, seeds, chunk, chunk=chunk,
                                         knobs=knobs)
                    out.append((dense_state_to_numpy(st), tr))
                    if c == 1:
                        st = dense.restart(st, 40)
            snaps[dev] = out
            route[dev] = (counter.calls, tick_core.launches - launches0)
        compare(f"dense {label}", snaps["cuda"], snaps["cpu"])
        if route["cuda"] != (route["cpu"][0],) * 2 or (pallas and not 0 < route["cpu"][0] < ticks):
            fail(f"[15] dense {label}: kernel routes {route}")
        say(f"[15] dense n={n} {label}: card == CPU over {ticks} ticks; tick_core launches "
            f"{route['cuda'][1]} (the CPU run routed {route['cpu'][0]} ticks to the core); "
            f"final convergence {float(snaps['cuda'][-1][1]['convergence'][-1]):.6f}")
    say("[15] xla_exp_f32 (2^20 values), edge_loss and round_trip_in_time_from under a "
        "world: card == CPU")


def phase_scheduled_sparse(torch):
    import numpy as np

    from scalecube_cluster_tpu_torch.sim.faults import FaultPlan
    from scalecube_cluster_tpu_torch.sim.schedule import ScheduleBuilder
    from scalecube_cluster_tpu_torch.sim.sparse import (
        SparseParams,
        init_sparse_full_view,
        leave_sparse,
        restart_many_sparse,
        run_sparse_chunked,
        update_metadata_sparse,
    )
    from scalecube_cluster_tpu_torch.sim.topology import LinkWorld

    n, s, chunk, reps = 32768, 512, 48, 5
    killed = [7 + 512 * i for i in range(64)]
    b = (
        ScheduleBuilder(n)
        .add_segment(1, FaultPlan.uniform(5.0, device="cuda"))
        .add_segment(49, FaultPlan.uniform(5.0, device="cuda"),
                     link_world=LinkWorld.even_zones(n, 2, device="cuda")
                     .with_zone_latency(0, 1, 400.0))
        .add_segment(145, FaultPlan.uniform(5.0, device="cuda"))
    )
    for m in killed:
        b = b.kill(10, m)
    for m in killed[:32]:
        b = b.restart(100, m)
    sched = b.build()
    params = SparseParams.for_n(n, slot_budget=s, in_scan_writeback=False, pallas_core=True)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    state = init_sparse_full_view(n, s, device="cuda")
    state, _ = run_sparse_chunked(params, state, sched, chunk, chunk, collect=False)
    int(state.view_T[0, 0])
    host_restarted = killed[32:48]
    overflow, per_chunk = 0, []
    for c in range(reps):
        t0 = time.perf_counter()
        state, tr = run_sparse_chunked(params, state, sched, chunk, chunk, collect=True)
        int(state.view_T[0, 0])
        per_chunk.append(time.perf_counter() - t0)
        overflow += int(tr["slot_overflow"].sum())
        for k, v in tr.items():
            if v.shape[0] != chunk or not np.all(np.isfinite(v)):
                fail(f"[16] trace {k} malformed: shape {v.shape}")
        if c == 0:
            state = restart_many_sparse(state, host_restarted)
        if c == 1:
            # The slab is full here (the 64 kills pin their slots through
            # the 400-tick suspicion), so the two ops take live members that
            # already hold a slot (a host op on an unloaded member would
            # need a free one and raise, as the reference's does).
            slot_subj = state.slot_subj.cpu().numpy()
            alive = state.alive.cpu().numpy()
            loaded = [int(m) for m in slot_subj if m >= 0 and alive[m]][:2]
            state = update_metadata_sparse(leave_sparse(state, loaded[0]), loaded[1])
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    # One more chunk uncollected: the path without the counters and the
    # zone gauges' per-viewer counts.
    t0 = time.perf_counter()
    state, _ = run_sparse_chunked(params, state, sched, chunk, chunk, collect=False)
    int(state.view_T[0, 0])
    bare_ms = (time.perf_counter() - t0) * 1e3 / chunk
    counts = read_counts()
    ticks = (reps + 2) * chunk
    dt = sum(per_chunk)
    ms = dt * 1e3 / (reps * chunk)
    say(f"[16] scheduled sparse path n={n} S={s}: {ms:.3f} ms/tick collected "
        f"(chunks {', '.join(f'{c * 1e3 / chunk:.3f}' for c in per_chunk)}), "
        f"{n * reps * chunk / dt:.1f} member·rounds/s, peak device memory {peak_gib:.3f} GiB, "
        f"slot_overflow total {overflow}; then {bare_ms:.3f} ms/tick uncollected "
        f"({n * 1e3 / bare_ms:.1f} member·rounds/s); launches {counts} "
        f"(expect sparse_core {ticks})")
    if counts["sparse_core"] != ticks:
        fail(f"sparse_core launched {counts['sparse_core']} times on {ticks} scheduled ticks")
    slot_subj = state.slot_subj.cpu().numpy()
    subj_slot = state.subj_slot.cpu().numpy()
    active = np.flatnonzero(slot_subj >= 0)
    if not np.array_equal(subj_slot[slot_subj[active]], active) or int(
        (subj_slot >= 0).sum()
    ) != active.size:
        fail("[16] slot tables are inconsistent")
    if state.t_host != int(state.tick) or state.t_host != ticks:
        fail(f"[16] tick {int(state.tick)} / mirror {state.t_host}, expected {ticks}")
    still = killed[48:]
    alive = state.alive.cpu()
    if bool(alive[still].any()) or not bool(alive[killed[:48]].all()):
        fail("[16] kills and restarts did not land")
    unflagged = []
    for m in still:
        sm = int(subj_slot[m])
        rec = state.slab[:, sm] if sm >= 0 else state.view_T[m, :]
        if _flagging_viewers(state.alive, rec, m) == 0:
            unflagged.append(m)
    if unflagged:
        fail(f"[16] killed members no live viewer suspects or convicts: {unflagged}")
    say(f"[16] {len(still)} members still killed, each suspected or convicted by live viewers; "
        f"last chunk: zone_intra_conv {tr['zone_intra_conv'][-1].tolist()}, kills_fired "
        f"{int(tr['kills_fired'].sum())}, n_suspected {int(tr['n_suspected'][-1])}")
    return counts["sparse_core"], {"ms_per_tick": ms, "uncollected_ms_per_tick": bare_ms,
                                   "peak_gib": peak_gib, "slot_overflow": overflow}


def phase_dense_timeline(torch):
    import numpy as np

    from scalecube_cluster_tpu_torch.bench import measure_geo
    from scalecube_cluster_tpu_torch.sim import state as dense
    from scalecube_cluster_tpu_torch.sim import tick as tick_mod
    from scalecube_cluster_tpu_torch.sim.faults import FaultPlan
    from scalecube_cluster_tpu_torch.sim.params import SimParams
    from scalecube_cluster_tpu_torch.sim.run import run_chunked
    from scalecube_cluster_tpu_torch.sim.schedule import ScheduleBuilder
    from scalecube_cluster_tpu_torch.sim.topology import LinkWorld

    n, chunk, ticks = 10240, 40, 200
    params = dataclasses.replace(SimParams.from_cluster_config(n), pallas_delivery=True)
    torch.cuda.reset_peak_memory_stats()
    sched = (
        ScheduleBuilder(n)
        .add_segment(1, FaultPlan.uniform(5.0, device="cuda"),
                     link_world=LinkWorld.even_zones(n, 2, device="cuda")
                     .with_zone_latency(0, 1, 400.0))
        .add_segment(81, FaultPlan.clean(n, device="cuda").partition(range(3072),
                                                                      range(3072, n)))
        .add_segment(161, FaultPlan.clean(n, device="cuda").with_loss(5.0))
        .kill(5, 7)
        .restart(120, 7)
        .build()
    )
    seeds = dense.seeds_mask(n, [0, 1], device="cuda")
    state = dense.init_full_view(n, device="cuda")
    reset_counts()
    slow = []
    core_xla = tick_mod._core_xla

    def counted(params_, state_, *a, **kw):
        slow.append(state_.t_host + 1)
        return core_xla(params_, state_, *a, **kw)

    tick_mod._core_xla = counted
    per_chunk = []
    try:
        for c in range(ticks // chunk):
            t0 = time.perf_counter()
            state, tr = run_chunked(params, state, sched, seeds, chunk, chunk=chunk,
                                    collect=c == ticks // chunk - 1)
            int(state.view[0, 0])
            per_chunk.append(time.perf_counter() - t0)
    finally:
        tick_mod._core_xla = core_xla
    counts = read_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    fast = ticks - len(slow)
    say(f"[17] dense timeline n={n}: chunks {', '.join(f'{c * 1e3 / chunk:.3f}' for c in per_chunk)}"
        f" ms/tick (the last collected), peak device memory {peak_gib:.3f} GiB, slow ticks "
        f"{slow}, launches {counts} (expect tick_core {fast})")
    if counts["tick_core"] != fast or 150 not in slow or any(
        t != 150 and t < 120 for t in slow
    ):
        fail(f"[17] tick_core launched {counts['tick_core']} times; slow ticks {slow}")
    for k, v in tr.items():
        if v.shape[0] != chunk or not np.all(np.isfinite(v)):
            fail(f"[17] trace {k} malformed: shape {v.shape}")
    conv = tr["zone_intra_conv"]
    if not (np.all(conv >= 0) and np.all(conv <= 1)):
        fail(f"[17] zone_intra_conv outside [0, 1]: {conv.min()}..{conv.max()}")
    if not bool(state.alive[7]) or int(state.epoch[7]) != 1:
        fail("[17] member 7's restart did not land")
    say(f"[17] collected chunk: convergence {float(tr['convergence'][-1]):.6f}, zone_intra_conv "
        f"{conv[-1].tolist()}, plan_dirty {int(tr['plan_dirty'].sum())} of {chunk}, "
        f"n_suspected {int(tr['n_suspected'][-1])}")
    geo = measure_geo(n)
    say(f"[17] --geo {n}: {json.dumps(geo)}")
    return counts["tick_core"], {"chunk_ms_per_tick": [c * 1e3 / chunk for c in per_chunk],
                                 "peak_gib": peak_gib, "geo": geo}


def _flat_state(state):
    """A sparse state as flat numpy arrays, the recorder's ring fields as
    ``trace.<field>`` (copies: the tick consumes its state)."""
    from scalecube_cluster_tpu_torch.sim.convert import sparse_state_to_numpy

    flat = sparse_state_to_numpy(state)
    ring = flat.pop("trace", None)
    if ring is not None:
        flat.update({f"trace.{k}": v for k, v in ring.items()})
    return flat


def _compare_runs(tag, card, cpu):
    """Every leaf and trace key of two lists of (flat state, traces)."""
    import numpy as np

    for c, ((a, ta), (b, tb)) in enumerate(zip(card, cpu)):
        if set(a) != set(b) or set(ta or {}) != set(tb or {}):
            fail(f"{tag}: leaf or trace sets differ at step {c}")
        for k in a:
            if a[k].dtype != b[k].dtype or not np.array_equal(a[k], b[k]):
                fail(f"{tag}: state leaf {k} differs after step {c}")
        for k in ta or {}:
            if not np.array_equal(np.asarray(ta[k]).view(np.uint8),
                                  np.asarray(tb[k]).view(np.uint8)):
                fail(f"{tag}: trace {k} differs in step {c}")


def _churn_timeline(n, device):
    """Phase 18's traced timeline: 5% loss; the same under a 2-zone 400 ms
    brownout from tick 13; 5% loss from tick 37; kills at ticks 3 and 5, a
    restart at 25."""
    from scalecube_cluster_tpu_torch.sim.faults import FaultPlan
    from scalecube_cluster_tpu_torch.sim.schedule import ScheduleBuilder
    from scalecube_cluster_tpu_torch.sim.topology import LinkWorld

    return (
        ScheduleBuilder(n)
        .add_segment(1, FaultPlan.uniform(5.0, device=device))
        .add_segment(13, FaultPlan.uniform(5.0, device=device),
                     link_world=LinkWorld.even_zones(n, 2, device=device)
                     .with_zone_latency(0, 1, 400.0))
        .add_segment(37, FaultPlan.uniform(5.0, device=device))
        .kill(3, 7).kill(5, n // 2).restart(25, 7)
        .build()
    )


def _elastic_timeline(n_alloc, rows, device, first, every, batch, kill=None):
    """5% uniform loss over ``n_alloc`` members; the capacity ``rows``
    joined ``batch`` at a time, one batch every ``every`` ticks from tick
    ``first``; member ``kill`` killed at tick 5 when given."""
    from scalecube_cluster_tpu_torch.sim.faults import FaultPlan
    from scalecube_cluster_tpu_torch.sim.schedule import ScheduleBuilder

    b = ScheduleBuilder(n_alloc).add_segment(1, FaultPlan.uniform(5.0, device=device))
    if kill is not None:
        b = b.kill(5, kill)
    for k, j in enumerate(rows):
        b = b.join(first + every * (k // batch), j)
    return b.build()


def phase_recorder_elastic_card_vs_cpu(torch):
    """Phase 18: the traced XLA chain, an elastic run on the kernel route,
    a promotion and an elastic packed checkpoint, card == CPU at small n."""
    import io

    from scalecube_cluster_tpu_torch.ops.sparse_core import sparse_core
    from scalecube_cluster_tpu_torch.sim import checkpoint as ckpt
    from scalecube_cluster_tpu_torch.sim import sparse as sparse_mod

    n, s, chunk, ticks = 1024, 256, 12, 60
    # (a) The flight recorder on the XLA chain, host kills and restarts
    # between chunks.
    params = dataclasses.replace(_fold_params(n, s), pallas_core=False)
    runs, route = {}, {}
    for dev in ("cuda", "cpu"):
        sched = _churn_timeline(n, dev)
        st = sparse_mod.init_sparse_full_view(n, s, user_gossip_slots=2, trace_capacity=1 << 19,
                                              device=dev)
        out = []
        launches0 = sparse_core.launches
        with _RouteCounter(sparse_mod, "sparse_core") as counter:
            for c in range(ticks // chunk):
                st, tr = sparse_mod.run_sparse_chunked(params, st, sched, chunk, chunk=chunk)
                out.append((_flat_state(st), tr))
                if c == 1:
                    st = sparse_mod.kill_sparse(st, 100)
                if c == 2:
                    st = sparse_mod.restart_many_sparse(st, [100, 3])
        runs[dev] = out
        route[dev] = (counter.calls, sparse_core.launches - launches0)
    _compare_runs("[18] traced XLA chain", runs["cuda"], runs["cpu"])
    if route != {"cuda": (0, 0), "cpu": (0, 0)}:
        fail(f"[18] the traced run took the kernel route: {route}")
    final = runs["cuda"][-1][0]
    say(f"[18] traced XLA chain n={n} S={s}: card == CPU over {ticks} ticks ({len(final)} "
        f"leaves with the ring's 10 fields); {int(final['trace.cursor'])} events recorded, "
        f"overflow {int(final['trace.overflow'])}, verdicts_dead "
        f"{sum(int(tr['verdicts_dead'].sum()) for _, tr in runs['cuda'])}")
    if int(final["trace.overflow"]) != 0 or int(final["trace.cursor"]) == 0:
        fail("[18] the ring overflowed or recorded nothing")

    # (b) Elastic on the kernel route: 896 live of 1024, the 128 capacity
    # rows joined 8 a tick from tick 2; (c) promotion to 2048 and 48 more
    # ticks joining 16 of the new rows; (d) a packed elastic checkpoint.
    n_live, n2 = 896, 2 * n
    params = _fold_params(n, s)
    runs, route, promoted = {}, {}, {}
    for dev in ("cuda", "cpu"):
        sched = _elastic_timeline(n, range(n_live, n), dev, first=2, every=1, batch=8, kill=9)
        st = sparse_mod.init_sparse_full_view(n_live, s, user_gossip_slots=2, n_alloc=n,
                                              device=dev)
        out = []
        launches0 = sparse_core.launches
        with _RouteCounter(sparse_mod, "sparse_core") as counter:
            for _ in range(ticks // chunk):
                st, tr = sparse_mod.run_sparse_chunked(params, st, sched, chunk, chunk=chunk)
                out.append((_flat_state(st), tr))
            t0 = time.perf_counter()
            params2, st = ckpt.promote_sparse_state(params, st, n2)
            out.append((_flat_state(st), None))
            promoted[dev] = time.perf_counter() - t0
            sched2 = _elastic_timeline(n2, range(n, n + 16), dev, first=st.t_host + 2,
                                       every=2, batch=4)
            for _ in range(48 // chunk):
                st, tr = sparse_mod.run_sparse_chunked(params2, st, sched2, chunk, chunk=chunk)
                out.append((_flat_state(st), tr))
        buf = io.BytesIO()
        ckpt.save_sparse_checkpoint(buf, st, params2, pack_cold=True)
        buf.seek(0)
        back, _ = ckpt.load_sparse_checkpoint(buf, device=dev)
        out.append((_flat_state(back), None))
        runs[dev] = out
        route[dev] = (counter.calls, sparse_core.launches - launches0)
    _compare_runs("[18] elastic kernel route", runs["cuda"], runs["cpu"])
    expect = ticks + 48
    if route["cuda"] != (route["cpu"][0], route["cpu"][0]) or route["cpu"][0] != expect:
        fail(f"[18] elastic: kernel routes {route}, expected {expect} of {expect}")
    pre = [tr for _, tr in runs["cuda"][: ticks // chunk]]
    post = [tr for _, tr in runs["cuda"][ticks // chunk + 1: -1]]
    admitted = sum(int(tr["joins_admitted"].sum()) for tr in pre)
    if admitted != n - n_live or int(pre[-1]["n_live"][-1]) != n:
        fail(f"[18] elastic: joins_admitted {admitted}, n_live {int(pre[-1]['n_live'][-1])}")
    if int(post[-1]["n_live"][-1]) != n + 16:
        fail(f"[18] promoted run: n_live {int(post[-1]['n_live'][-1])}, expected {n + 16}")
    ring_free = {k: v for k, v in runs["cuda"][-2][0].items() if not k.startswith("trace.")}
    _compare_runs("[18] packed checkpoint", [(ring_free, None)], [(runs["cuda"][-1][0], None)])
    say(f"[18] elastic n_alloc={n} ({n_live} live) S={s}, kernel route: card == CPU over "
        f"{ticks} ticks, joins_admitted {admitted}, n_live {n}; promote to {n2} "
        f"(card {promoted['cuda'] * 1e3:.3f} ms) and 48 ticks: card == CPU, n_live {n + 16}; "
        f"sparse_core launches {route['cuda'][1]} (the CPU run routed {route['cpu'][0]}); "
        "the packed elastic checkpoint round trip equals the state on both devices")


def phase_elastic_full_width(torch):
    """Phase 19: the elastic path at the sparse main path's width."""
    import numpy as np

    from scalecube_cluster_tpu_torch.sim import checkpoint as ckpt
    from scalecube_cluster_tpu_torch.sim.sparse import (
        SparseParams,
        init_sparse_full_view,
        run_sparse_chunked,
    )

    n_live, n, s, chunk, chunks = 30720, 32768, 512, 48, 5
    params = SparseParams.for_n(n, slot_budget=s, in_scan_writeback=False, pallas_core=True)
    sched = _elastic_timeline(n, range(n_live, n), "cuda", first=10, every=6, batch=64, kill=7)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    state = init_sparse_full_view(n_live, s, n_alloc=n, device="cuda")
    per_chunk, traces = [], []
    for _ in range(chunks):
        t0 = time.perf_counter()
        state, tr = run_sparse_chunked(params, state, sched, chunk, chunk, collect=True)
        int(state.view_T[0, 0])
        per_chunk.append(time.perf_counter() - t0)
        traces.append(tr)
    pre_counts = read_counts()
    n_live_trace = np.concatenate([tr["n_live"] for tr in traces])
    admitted = int(sum(int(tr["joins_admitted"].sum()) for tr in traces))
    ticks = chunks * chunk
    if pre_counts["sparse_core"] != ticks:
        fail(f"[19] sparse_core launched {pre_counts['sparse_core']} times on {ticks} ticks")
    if int(n_live_trace[0]) != n_live or int(n_live_trace[-1]) != n or admitted != n - n_live:
        fail(f"[19] n_live {int(n_live_trace[0])} -> {int(n_live_trace[-1])}, "
             f"joins_admitted {admitted}")
    if np.any(np.diff(n_live_trace) < 0):
        fail("[19] n_live fell")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params2, state = ckpt.promote_sparse_state(params, state, 2 * n)
    torch.cuda.synchronize()
    promote_s = time.perf_counter() - t0
    sched2 = _elastic_timeline(2 * n, range(n, n + 64), "cuda", first=state.t_host + 2,
                               every=1, batch=64)
    t0 = time.perf_counter()
    state, tr2 = run_sparse_chunked(params2, state, sched2, chunk, chunk, collect=True)
    int(state.view_T[0, 0])
    after = time.perf_counter() - t0
    counts = read_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    if counts["sparse_core"] != ticks + chunk:
        fail(f"[19] sparse_core launched {counts['sparse_core'] - ticks} of {chunk} ticks "
             "after the promotion")
    if int(tr2["n_live"][-1]) != n + 64 or int(tr2["joins_admitted"].sum()) != 64:
        fail(f"[19] after promotion: n_live {int(tr2['n_live'][-1])}")
    for trs in traces + [tr2]:
        for k, v in trs.items():
            if not np.all(np.isfinite(v)):
                fail(f"[19] trace {k} not finite")
    ms = [c * 1e3 / chunk for c in per_chunk]
    row = {"chunk_ms_per_tick": ms, "ms_per_tick_before": sum(per_chunk[1:]) * 1e3 / (
        (chunks - 1) * chunk), "ms_per_tick_after": after * 1e3 / chunk,
        "promote_s": promote_s, "peak_gib": peak_gib, "joins_admitted": admitted}
    say(f"[19] elastic n_alloc={n} ({n_live} live) S={s}, kernel route, collected 48-tick "
        f"chunks: {', '.join(f'{m:.3f}' for m in ms)} ms/tick (joins at ticks 10-196, "
        f"{admitted} admitted, n_live {int(n_live_trace[0])} -> {int(n_live_trace[-1])}); "
        f"promote_sparse_state to {2 * n}: {promote_s * 1e3:.3f} ms wall; after it "
        f"{row['ms_per_tick_after']:.3f} ms/tick over {chunk} ticks (n_live "
        f"{int(tr2['n_live'][-1])}); peak device memory {peak_gib:.3f} GiB; launches {counts} "
        f"(expect sparse_core {ticks + chunk})")
    return counts["sparse_core"], row


def _sync_calls(torch, run):
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


def phase_recorder_full_width(torch):
    """Phase 20: the flight recorder at the sparse main path's width."""
    from scalecube_cluster_tpu_torch.bench import measure_tracer_overhead, tracer_schedule
    from scalecube_cluster_tpu_torch.obs.trace import (
        DEAD_VIA_EXPIRY,
        TK_NAMES,
        TK_PROBE_MISSED,
        TK_PROBE_SENT,
        TK_SUSPECT_START,
        TK_VERDICT_DEAD,
        ring_events,
        ring_overflow,
    )
    from scalecube_cluster_tpu_torch.sim.sparse import (
        SparseParams,
        init_sparse_full_view,
        run_sparse_ticks,
    )
    from scalecube_cluster_tpu_torch.tools.trace_explain import check_c6, walk_chain

    n, s, chunk = 32768, 512, 48
    reset_counts()
    row, _ = measure_tracer_overhead(n, slot_budget=s)
    timing_counts = read_counts()
    say(f"[20] --tracer-overhead {n} S={s}: tracer_overhead {row['tracer_overhead']:.4f}, "
        f"{row['ms_per_tick_off']:.3f} ms/tick off, {row['ms_per_tick_on']:.3f} on, "
        f"events_recorded {row['events_recorded']} of {row['trace_capacity']}, trace_overflow "
        f"{row['trace_overflow']}, launches {timing_counts}")
    if any(timing_counts.values()):
        fail(f"[20] a kernel launched on the XLA chain: {timing_counts}")

    # Synchronising calls of one 48-tick chunk, untraced and traced.
    params = SparseParams.for_n(n, slot_budget=s)
    sched = tracer_schedule(n)
    states = {}

    def one_chunk(label):
        states[label], _ = run_sparse_ticks(params, states[label], sched, chunk, collect=False)

    syncs = {}
    for label, cap in (("off", 0), ("on", row["trace_capacity"])):
        states[label] = init_sparse_full_view(n, s, trace_capacity=cap, device="cuda")
        one_chunk(label)
        syncs[label] = _sync_calls(torch, lambda: one_chunk(label))
    say(f"[20] synchronising CUDA calls in one {chunk}-tick chunk: untraced {syncs['off']}, "
        f"traced {syncs['on']}")
    if syncs["on"] > syncs["off"]:
        fail(f"[20] the recorder adds synchronising calls: {syncs}")

    # The recorder's cost with the host's drift spread over both sides:
    # untraced and traced chunks alternate, the order flipped every pair.
    ratios = []
    for k in range(6):
        wall = {}
        for label in ("off", "on")[:: 1 if k % 2 == 0 else -1]:
            t0 = time.perf_counter()
            one_chunk(label)
            int(states[label].view_T[0, 0])
            wall[label] = time.perf_counter() - t0
        ratios.append(wall["on"] / wall["off"])
    ratios.sort()
    interleaved = (ratios[2] + ratios[3]) / 2
    say(f"[20] tracer_overhead interleaved over 6 pairs of {chunk}-tick chunks: median "
        f"{interleaved:.4f}, pairs {', '.join(f'{r:.4f}' for r in ratios)}")
    row = {**row, "tracer_overhead_interleaved": interleaved, "interleaved_ratios": ratios}
    del states

    # Certifying: a ring sized for the whole run, to tick 528 (the kill at
    # tick 5 convicted by expiry after the 400-tick suspicion). The run
    # records ~130k events a tick, most of them the ALIVE verdicts of
    # refuted false suspicions, so the ring holds 2^27 (3 GiB).
    capacity, ticks = 1 << 27, 528
    st = init_sparse_full_view(n, s, trace_capacity=capacity, device="cuda")
    t0 = time.perf_counter()
    for _ in range(ticks // chunk):
        st, _ = run_sparse_ticks(params, st, sched, chunk, collect=False)
    int(st.view_T[0, 0])
    run_s = time.perf_counter() - t0
    cursor, overflow = int(st.trace.cursor), ring_overflow(st.trace)
    by_kind = torch.bincount(st.trace.ev_kind[:cursor].long(), minlength=19).tolist()
    say(f"[20] events by kind: "
        f"{ {TK_NAMES[k]: c for k, c in enumerate(by_kind) if c} }")
    t0 = time.perf_counter()
    # C6 walks DEAD verdicts back through suspicions and misses to probes:
    # decode those kinds, each at its ring position (a cause pointing to any
    # other kind is then absent, a violation as it is in the whole ring).
    events = ring_events(st.trace, kinds={TK_VERDICT_DEAD, TK_SUSPECT_START,
                                          TK_PROBE_MISSED, TK_PROBE_SENT})
    violations = check_c6(events)
    deads = [e for e in events if e["kind"] == TK_VERDICT_DEAD]
    by_pos = {e["i"]: e for e in events}
    incomplete = []
    missed = 0
    for ev in deads:
        # explain_verdict's walk, over one position index for every verdict.
        chain, broken = walk_chain(by_pos, ev)
        if broken or chain[-1]["kind"] != TK_PROBE_SENT:
            incomplete.append(ev["i"])
        missed += any(e["kind"] == TK_PROBE_MISSED for e in chain)
    check_s = time.perf_counter() - t0
    by_expiry = sum(1 for e in deads if e["aux"] == DEAD_VIA_EXPIRY)
    say(f"[20] certifying run n={n} S={s}, {ticks} ticks, ring {capacity}: {run_s / ticks * 1e3:.3f}"
        f" ms/tick, {cursor} events ({cursor / ticks:.1f} a tick), trace_overflow {overflow}; "
        f"{len(events)} chain events decoded, {len(deads)} DEAD verdicts ({by_expiry} by "
        f"expiry, {missed} with a missed probe in their chain), check_c6 violations "
        f"{len(violations)}, chains not ending at a probe {len(incomplete)}; decode and walk "
        f"{check_s:.1f} s")
    if violations or incomplete or not deads or not by_expiry or not missed:
        fail(f"[20] C6: {violations[:3]}, incomplete {incomplete[:3]}, deads {len(deads)}")
    return {**row, "syncs": syncs, "certify_events": cursor, "certify_overflow": overflow,
            "certify_ms_per_tick": run_s / ticks * 1e3, "deads": len(deads)}


def _stack_ops(torch, sets):
    """Seeded numpy operand sets, one per universe, stacked on the card."""
    import numpy as np

    return {k: torch.from_numpy(np.stack([o[k] for o in sets])).cuda() for k in sets[0]}


def phase_batched_kernels(torch):
    """Phase 21: both fused cores over a leading universe axis (the grid's
    third axis) vs their batched plain versions and vs one launch per
    universe, with times beside B times the single bound."""
    from scalecube_cluster_tpu_torch.ops.sparse_core import sparse_core, sparse_core_reference
    from scalecube_cluster_tpu_torch.ops.tick_core import tick_core, tick_core_reference
    from scalecube_cluster_tpu_torch.testing import (
        random_operands,
        random_tick_operands,
        tile_edge_operands,
        tile_edge_tick_operands,
    )

    rows = {"sparse_core": [], "tick_core": []}
    cases = (
        ("sparse_core", sparse_core, sparse_core_reference,
         dict(spread=48, susp_ticks=400, age_stale=120, sweep=98),
         ("slab2", "age2", "susp2", "self_rumor", "aggr"),
         ((4, 32768, 512, lambda u: random_operands(32768, 512, 3, seed=20 + u)),
          (3, 1024, 256, lambda u: tile_edge_operands(1024, 256, 3, seed=30 + u)))),
        ("tick_core", tick_core, tick_core_reference,
         dict(spread=42, sweep=86, susp_ticks=350, age_stale=120),
         ("view2", "age2", "susp2", "rows_next", "self_rumor", "known_cnt"),
         ((16, 1024, None, lambda u: random_tick_operands(1024, 3, seed=40 + u, susp_ticks=350)),
          (3, 264, None, lambda u: tile_edge_tick_operands(264, 3, seed=50 + u,
                                                           susp_ticks=350)))),
    )
    for name, kernel, plain, consts, outs, shapes in cases:
        for b, n, s, make in shapes:
            ops = _stack_ops(torch, [make(u) for u in range(b)])
            args = tuple(ops.values())
            got = kernel(*args, **consts)
            want = plain(*args, **consts)
            torch.cuda.synchronize()
            shape = f"B={b} n={n}" + (f" S={s}" if s else "")
            err = _compare(outs, got, want, f"of batched {name} at {shape}")
            for u in range(b):
                one = kernel(*(a[u] for a in args), **consts)
                _compare(outs, [g[u] for g in got], one,
                         f"of batched {name} vs its single launch on universe {u} at {shape}")
            del got, want
            single_args = tuple(a[0] for a in args)
            big = n * (s or n) > 1 << 20
            reps_k, reps_p = (20, 3) if big else (100, 10)
            k_ms = _time_cuda(torch, lambda: kernel(*args, **consts), reps_k)
            one_ms = _time_cuda(torch, lambda: kernel(*single_args, **consts), reps_k)
            p_ms = _time_cuda(torch, lambda: plain(*args, **consts), reps_p)
            if name == "sparse_core":
                work = core_work({k: v[0] for k, v in ops.items()})
            else:
                work = dense_core_work({k: v[0] for k, v in ops.items()})[:2]
            single = _bound_row(*work)
            row = {"B": b, "n": n, "S": s, "max_abs_err": err, "ms": k_ms, "single_ms": one_ms,
                   "plain_ms": p_ms, "bound_ms": b * single["bound_ms"],
                   "bound_by": single["bound_by"], "single_bound_ms": single["bound_ms"]}
            rows[name].append(row)
            say(f"[21] {name} {shape} f=3: one launch for the batch, bit-equal to the "
                f"batched plain version and to {b} single launches (max_abs_err {err}); "
                f"batched {k_ms:.4f} ms, one universe alone {one_ms:.4f} ms "
                f"({k_ms / one_ms:.2f}x for {b}x the work), plain {p_ms:.4f} ms, bound "
                f"{row['bound_ms']:.4f} ms by {single['bound_by']} ({b} x "
                f"{single['bound_ms']:.4f} ms)")
            del ops, args, single_args
    return rows


def _ensemble_schedules(n, b, device):
    """Per-universe timelines of equal shape: universe u has 3+u % loss,
    then 1% loss with 3 ms mean delay from tick 20+2u; kills of 7+u at tick
    4+u and of 40+u at 9+u; a restart (a joiner in the dense engine) of
    7+u at tick 26+5u."""
    from scalecube_cluster_tpu_torch.sim.faults import FaultPlan
    from scalecube_cluster_tpu_torch.sim.schedule import ScheduleBuilder

    return [
        ScheduleBuilder(n)
        .add_segment(1, FaultPlan.uniform(3.0 + u, device=device))
        .add_segment(20 + 2 * u, FaultPlan.uniform(1.0, 3.0, device=device))
        .kill(4 + u, 7 + u).kill(9 + u, 40 + u).restart(26 + 5 * u, 7 + u)
        .build()
        for u in range(b)
    ]


def phase_ensemble_card_vs_cpu(torch):
    """Phase 22: ensembles on the card equal the same ensembles on the CPU:
    every leaf of every universe and every [B, T] trace after every chunk,
    and the ensemble_report rows."""
    import numpy as np

    from scalecube_cluster_tpu_torch.obs.ensemble import ensemble_report
    from scalecube_cluster_tpu_torch.ops.sparse_core import sparse_core
    from scalecube_cluster_tpu_torch.ops.tick_core import tick_core
    from scalecube_cluster_tpu_torch.sim import ensemble as ens
    from scalecube_cluster_tpu_torch.sim import state as dense
    from scalecube_cluster_tpu_torch.sim.convert import (
        dense_state_to_numpy,
        sparse_state_to_numpy,
    )
    from scalecube_cluster_tpu_torch.sim.params import SimParams

    b, ticks, chunk = 3, 60, 12
    n = 256
    base = SimParams(
        n=n, gossip_fanout=3, periods_to_spread=8, periods_to_sweep=18,
        fd_period_ticks=2, sync_period_ticks=10, suspicion_ticks=12,
        ping_req_members=2, user_gossip_slots=2,
    )
    launches = {}
    for tag, params, knob_mults in (
        ("dense XLA core, knobs", base, (1.0, 1.5, 0.5)),
        ("dense fused route", dataclasses.replace(base, pallas_delivery=True), None),
    ):
        runs = {}
        for dev in ("cuda", "cpu"):
            states = ens.init_ensemble_dense(n, range(5, 5 + b), user_gossip_slots=2, device=dev)
            plans = ens.stack_universes(_ensemble_schedules(n, b, dev))
            seeds = dense.seeds_mask(n, [0, 1], device=dev)
            knobs = None if knob_mults is None else ens.knob_grid(
                params, suspicion_mults=knob_mults, device=dev)
            before = tick_core.launches
            snaps, traces = [], []
            for _ in range(ticks // chunk):
                states, tr = ens.run_ensemble_ticks(params, states, plans, seeds, chunk,
                                                    knobs=knobs)
                tr = {k: v.cpu().numpy() for k, v in tr.items()}
                snaps.append((dense_state_to_numpy(states), tr))
                traces.append(tr)
            if dev == "cuda":
                launches[tag] = tick_core.launches - before
            whole = {k: torch.from_numpy(np.concatenate([t[k] for t in traces], axis=1)).to(dev)
                     for k in traces[0]}
            runs[dev] = (snaps, ensemble_report(params, whole)["rows"])
        _compare_runs(f"[22] {tag}", runs["cuda"][0], runs["cpu"][0])
        if runs["cuda"][1] != runs["cpu"][1]:
            fail(f"[22] {tag}: ensemble_report rows differ between card and CPU")
        last = runs["cuda"][0][-1][1]
        say(f"[22] {tag}: B={b} n={n}, {ticks} ticks in chunks of {chunk}, card == CPU on "
            f"every leaf and [B, T] trace after every chunk and on the {len(runs['cuda'][1])} "
            f"ensemble_report rows; final convergence {last['convergence'][:, -1].tolist()}, "
            f"tick_core launches {launches[tag]}")
    if launches["dense XLA core, knobs"] != 0 or not 0 < launches["dense fused route"] < ticks:
        fail(f"[22] tick_core launches {launches}: expected none with knobs and some, not "
             "all, ticks on the fused route (SYNC and joining ticks take the slow core)")

    n, s = 1024, 256
    sparse_launches = {}
    for tag, params, knob_mults in (
        ("sparse XLA chain, knobs", dataclasses.replace(_fold_params(n, s), pallas_core=False),
         (1.0, 2.0, 0.5)),
        ("sparse kernel route", _fold_params(n, s), None),
    ):
        runs = {}
        for dev in ("cuda", "cpu"):
            states = ens.init_ensemble_sparse(n, range(5, 5 + b), slot_budget=s,
                                              user_gossip_slots=2, device=dev)
            plans = ens.stack_universes(_ensemble_schedules(n, b, dev))
            knobs = None if knob_mults is None else ens.knob_grid(
                params.base, suspicion_mults=knob_mults, device=dev)
            before = sparse_core.launches
            snaps, traces = [], []
            for _ in range(ticks // chunk):
                states, tr = ens.run_ensemble_sparse_chunked(
                    params, states, plans, chunk, chunk=chunk, knobs=knobs)
                snaps.append((sparse_state_to_numpy(states), tr))
                traces.append(tr)
            if dev == "cuda":
                sparse_launches[tag] = sparse_core.launches - before
            conv = ens.ensemble_sparse_convergence(states)
            whole = {k: torch.from_numpy(np.concatenate([t[k] for t in traces], axis=1)).to(dev)
                     for k in traces[0]}
            runs[dev] = (snaps, ensemble_report(params.base, whole,
                                                final_convergence=conv)["rows"])
        _compare_runs(f"[22] {tag}", runs["cuda"][0], runs["cpu"][0])
        if runs["cuda"][1] != runs["cpu"][1]:
            fail(f"[22] {tag}: ensemble_report rows differ between card and CPU")
        say(f"[22] {tag}: B={b} n={n} S={s}, {ticks} ticks in chunks of {chunk} with "
            f"host-boundary write-backs, card == CPU on every leaf and [B, T] trace after "
            f"every chunk and on the ensemble_report rows; sparse_core launches "
            f"{sparse_launches[tag]}")
    if sparse_launches != {"sparse XLA chain, knobs": 0, "sparse kernel route": ticks}:
        fail(f"[22] sparse_core launches {sparse_launches}: expected 0 and {ticks}")
    return launches["dense fused route"], sparse_launches["sparse kernel route"]


def phase_sparse_ensemble_full_width(torch):
    """Phase 23: the sparse ensemble through the kernel at the sparse main
    path's width (B=4), then the ``--ensemble`` rung at B=16 and B=1."""
    import numpy as np

    from scalecube_cluster_tpu_torch.bench import _device_profile, measure_ensemble
    from scalecube_cluster_tpu_torch.sim import ensemble as ens
    from scalecube_cluster_tpu_torch.sim.faults import FaultPlan
    from scalecube_cluster_tpu_torch.sim.sparse import SparseParams

    b, n, s, chunk, reps = 4, 32768, 512, 48, 4
    params = SparseParams.for_n(n, slot_budget=s, in_scan_writeback=False, pallas_core=True)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    states = ens.init_ensemble_sparse(n, range(b), slot_budget=s, device="cuda")
    alive = states.alive.clone()
    alive[:, 7] = False  # kill_sparse(..., 7) in every universe
    states = states.replace(alive=alive, wb_valid=torch.zeros_like(states.wb_valid))
    plans = ens.stack_universes(FaultPlan.uniform(loss_percent=5.0, device="cuda")
                                for _ in range(b))

    def chunk_run(st, collect=False):
        st, tr = ens.run_ensemble_sparse_ticks(params, st, plans, chunk, collect=collect)
        st = ens.ensemble_writeback_free(params, st)
        int(st.view_T[0, 0, 0])
        return st, tr

    states, _ = chunk_run(states)
    per_chunk = []
    for _ in range(reps):
        t0 = time.perf_counter()
        states, _ = chunk_run(states)
        per_chunk.append(time.perf_counter() - t0)
    states, tr = chunk_run(states, collect=True)
    counts = read_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    expect = (reps + 2) * chunk
    if counts["sparse_core"] != expect:
        fail(f"[23] sparse_core launched {counts['sparse_core']} times, expected {expect} "
             "(one a tick for the whole batch)")
    for k, v in tr.items():
        arr = v.cpu().numpy()
        if arr.shape[:2] != (b, chunk) or not np.all(np.isfinite(arr)):
            fail(f"[23] trace {k} malformed: shape {arr.shape}")
    if int(tr["slot_overflow"].sum()) != 0:
        fail(f"[23] slot overflow {int(tr['slot_overflow'].sum())}")
    flagged = []
    for u in range(b):
        st = ens.index_universe(states.replace(view_T=states.view_T[:, :, :0]), u)
        slot = int(st.subj_slot[7])
        rec = st.slab[:, slot] if slot >= 0 else states.view_T[u, 7, :]
        flagged.append(_flagging_viewers(st.alive, rec, 7))
    if min(flagged) == 0:
        fail(f"[23] live viewers flagging member 7 per universe: {flagged}")
    ticks = reps * chunk
    ms_tick = sum(per_chunk) * 1e3 / ticks
    rate = b * n * ticks / sum(per_chunk)
    say(f"[23] sparse ensemble B={b} n={n} S={s}, kernel route, 5% loss, member 7 killed in "
        f"each: {ms_tick:.3f} ms/tick (chunks {', '.join(f'{c * 1e3 / chunk:.3f}' for c in per_chunk)}), "
        f"{rate:.1f} universes·member·rounds/s, peak device memory {peak_gib:.3f} GiB, "
        f"launches {counts} (expect sparse_core {expect}); collect chunk: n_active_slots "
        f"{tr['n_active_slots'][:, -1].tolist()}, live viewers flagging member 7 {flagged}")

    snap = [states, dataclasses.replace(states, **{
        f.name: getattr(states, f.name).clone() for f in dataclasses.fields(states)
        if isinstance(getattr(states, f.name), torch.Tensor)})]

    def run(i):
        ens.run_ensemble_sparse_ticks(params, snap[i], plans, chunk, collect=False)

    prof = _device_profile(run, chunk)
    del snap, states
    say(f"[23] profile of {chunk} ticks: {prof['wall_ms_per_tick']:.3f} ms/tick, device busy "
        f"{prof['device_busy_ms_per_tick']:.3f} ms/tick, idle share "
        f"{prof['device_idle_share']:.4f}, {prof['device_launches_per_tick']:.3f} launches a "
        f"tick")
    rung = {}
    for bb in (16, 1):
        rung[bb] = measure_ensemble(bb, 1024)
        say(f"[23] --ensemble {bb} 1024: {rung[bb]['value']:.1f} universes·member·rounds/s, "
            f"{rung[bb]['per_universe']:.1f} per universe, {rung[bb]['ms_per_tick']:.3f} "
            "ms/tick")
    say(f"[23] batching 16 universes: {rung[16]['value'] / rung[1]['value']:.2f}x the "
        "throughput of one")
    return counts["sparse_core"], {"ms_per_tick": ms_tick, "rate": rate, "peak_gib": peak_gib,
                                   "profile": prof, "rung": rung}


def _short_kernel(name: str) -> str:
    """A device kernel's name without its namespaces, cut to 90 characters."""
    for prefix in ("void ", "at::native::", "(anonymous namespace)::", "at::"):
        name = name.replace(prefix, "")
    return name[:90]


def _rapid_split_vote(torch, n, device, with_join):
    """tests/test_rapid_fallback.py::_split_vote_schedule at n members (its
    own at n=16): members 0 and n/2 killed at tick 10 behind a one-way
    block {n/2+1..n-1} -> {1..n/2-1} over ticks [15, 17), so the two camps
    lock different cuts and the fast path parks; ``with_join`` re-admits
    n/2 through the handshake at tick 40."""
    from scalecube_cluster_tpu_torch.sim.faults import FaultPlan
    from scalecube_cluster_tpu_torch.sim.schedule import ScheduleBuilder

    h = n // 2
    blk = torch.zeros((n, n), dtype=torch.bool, device=device)
    blk[h + 1:, 1:h] = True
    one_way = FaultPlan.uniform(device=device).replace(block=blk)
    b = (ScheduleBuilder(n).add_segment(1, FaultPlan.clean(n, device=device))
         .add_segment(15, one_way).add_segment(17, FaultPlan.clean(n, device=device))
         .kill(10, 0).kill(10, h))
    if with_join:
        b.join(40, h)
    return b.build()


def _rapid_flat(state):
    """A Rapid state as flat numpy arrays, the fallback plane's leaves as
    ``fb.<field>`` and the ring's as ``trace.<field>``."""
    from scalecube_cluster_tpu_torch.sim.convert import rapid_state_to_numpy

    flat = rapid_state_to_numpy(state)
    for sub in ("fb", "trace"):
        leaves = flat.pop(sub, None)
        if leaves is not None:
            flat.update({f"{sub}.{k}": v for k, v in leaves.items()})
    return flat


def phase_rapid_card_vs_cpu(torch):
    """Phase 24: the Rapid engine on the card equals it on the CPU."""
    import numpy as np

    from scalecube_cluster_tpu_torch.obs.trace import ring_events
    from scalecube_cluster_tpu_torch.sim import ensemble as ens
    from scalecube_cluster_tpu_torch.sim import rapid
    from scalecube_cluster_tpu_torch.sim.faults import FaultPlan
    from scalecube_cluster_tpu_torch.sim.knobs import Knobs
    from scalecube_cluster_tpu_torch.sim.schedule import ScheduleBuilder
    from scalecube_cluster_tpu_torch.testlib.invariants import (
        certify_rapid_population,
        certify_rapid_traces,
    )
    from scalecube_cluster_tpu_torch.tools.trace_explain import check_rapid_chains

    def host(tr):
        return {k: v.cpu().numpy() for k, v in tr.items()}

    def solo(n, dev, plan, ticks, chunk, knobs=None, promote=None, **init):
        params = rapid.RapidParams(n=n)
        st = rapid.init_rapid_full_view(params, seed=7, device=dev, **init)
        kn = None if knobs is None else Knobs(
            suspicion_mult=torch.tensor(knobs[0], device=dev),
            fanout_cap=torch.tensor(knobs[1], dtype=torch.int32, device=dev))
        snaps = []
        for _ in range(ticks // chunk):
            st, tr = rapid.run_rapid_ticks(params, st, plan(n, dev), chunk, knobs=kn)
            snaps.append((_rapid_flat(st), host(tr)))
        if promote is not None:
            params, st = rapid.promote_rapid_state(params, st, promote[0])
            st, tr = rapid.run_rapid_ticks(params, st, promote[1](promote[0], dev), promote[2])
            snaps.append((_rapid_flat(st), host(tr)))
        return snaps, st, params

    def elastic_joins(n_live):
        def plan(n, dev):
            b = ScheduleBuilder(n).add_segment(1, FaultPlan.uniform(2.0, device=dev))
            for i, node in enumerate(range(n - 1, n_live - 1, -1)):
                b.join(3 + 2 * i, node)
            return b.build()
        return plan

    def promoted_joins(n, dev):
        return (ScheduleBuilder(n).add_segment(1, FaultPlan.uniform(2.0, device=dev))
                .join(45, n - 1).join(47, n - 2).build())

    reset_counts()
    for n in (16, 64):
        cases = [
            ("bare fast path, split vote", lambda n, d: _rapid_split_vote(torch, n, d, False), 120, 20,
             {}, {}),
            ("fallback + recorder, split vote and a join",
             lambda n, d: _rapid_split_vote(torch, n, d, True), 60, 20, {},
             {"fallback": True, "trace_capacity": 1 << 14}),
            ("5% loss with knobs (L x1.5, fan-out cap 7)",
             lambda n, d: FaultPlan.uniform(5.0, device=d), 60, 20, {"knobs": (1.5, 7)}, {}),
            (f"elastic {3 * n // 4} of {n} live, joins, then promoted to {3 * n // 2}",
             elastic_joins(3 * n // 4), 40, 20,
             {"promote": (3 * n // 2, promoted_joins, 20)},
             {"trace_capacity": 1 << 14, "n_live": 3 * n // 4}),
        ]
        for tag, plan, ticks, chunk, kw, init in cases:
            card, st_card, params = solo(n, "cuda", plan, ticks, chunk, **kw, **init)
            cpu, _, _ = solo(n, "cpu", plan, ticks, chunk, **kw, **init)
            _compare_runs(f"[24] n={n} {tag}", card, cpu)
            whole = {k: np.concatenate([c[1][k] for c in card[:ticks // chunk]])
                     for k in card[0][1]}
            fb = "fallback" in init
            certified = "not certified: a joiner holds a view of the same id its cohort does " \
                "not hold yet, which R1 rejects by design"
            if "n_live" not in init:
                summary = certify_rapid_traces(params, whole, fallback=fb)
                certified = (
                    f"R1-R5 ({'fallback' if fb else 'fast path'}): view_changes "
                    f"{summary['view_changes']}, parked {summary['views_parked']}, "
                    f"fallback_commits {summary.get('fallback_commits', 0)}"
                )
            extra = ""
            if st_card.trace is not None:
                chains = check_rapid_chains(ring_events(st_card.trace))
                if chains:
                    fail(f"[24] n={n} {tag}: chain violations {chains[:3]}")
                extra = f", {int(st_card.trace.cursor)} ring events, chains whole"
            say(f"[24] n={n} {tag}: {ticks} ticks, card == CPU on every leaf, metric and "
                f"ring field after every chunk; {certified}; final convergence "
                f"{float(card[-1][1]['convergence'][-1])}{extra}")

    b, n, ticks, chunk = 4, 64, 60, 20
    runs = {}
    for dev in ("cuda", "cpu"):
        params = rapid.RapidParams(n=n)
        states = rapid.init_ensemble_rapid(params, range(7, 7 + b), fallback=True, device=dev)
        plans = ens.stack_universes(_rapid_split_vote(torch, n, dev, True) for _ in range(b))
        snaps = []
        for _ in range(ticks // chunk):
            states, tr = rapid.run_ensemble_rapid_ticks(params, states, plans, chunk)
            snaps.append((_rapid_flat(states), host(tr)))
        runs[dev] = snaps
    _compare_runs(f"[24] ensemble B={b} n={n}", runs["cuda"], runs["cpu"])
    whole = {k: np.concatenate([c[1][k] for c in runs["cuda"]], axis=1) for k in runs["cuda"][0][1]}
    verdict = certify_rapid_population(rapid.RapidParams(n=n), whole, fallback=True)
    if not bool(np.all(verdict["ok"])):
        fail(f"[24] ensemble certification failed: {verdict['violations']}")
    counts = read_counts()
    if any(counts.values()):
        fail(f"[24] Rapid launched a kernel: {counts}")
    say(f"[24] ensemble B={b} n={n} with the fallback, split votes and joins: {ticks} ticks, "
        f"card == CPU on every leaf of every universe and every [B, T] trace; R1-R5 certify "
        f"every universe; no kernel launched")


def phase_rapid_rung(torch):
    """Phase 25: the ``--rapid 1024`` rung on the card."""
    from scalecube_cluster_tpu_torch.bench import measure_rapid, profile_rapid

    row = measure_rapid(1024)
    prof = profile_rapid(1024)
    say(f"[25] --rapid 1024 (5% loss, collect=False): {row['ms_per_tick']:.3f} ms/tick "
        f"(chunks {', '.join(f'{c:.3f}' for c in row['chunk_ms_per_tick'])}), "
        f"{row['value']:.1f} member·rounds/s, peak {row['peak_gib']:.3f} GiB, "
        f"{row['sync_calls_per_tick']:.3f} synchronising calls a tick; profile: "
        f"{prof['device_launches_per_tick']:.3f} launches a tick, device busy "
        f"{prof['device_busy_ms_per_tick']:.3f} ms/tick, idle share "
        f"{prof['device_idle_share']:.4f}")
    return {"row": row, "profile": prof}


def phase_rapid_dense_width(torch):
    """Phase 26: Rapid with the fallback at the dense width, a 64-member
    mass kill and 32 restarts through the handshake, collected and traced,
    certified R1-R5 and by the chain walk."""
    import numpy as np

    from scalecube_cluster_tpu_torch.bench import _device_profile, sync_calls
    from scalecube_cluster_tpu_torch.obs.trace import ring_events
    from scalecube_cluster_tpu_torch.obs.tracer import (
        TK_FB_ACCEPT,
        TK_FB_PREPARE,
        TK_JOIN_ACK,
        TK_JOIN_CONFIRM,
        TK_JOIN_REQ,
        TK_VIEW_COMMIT,
        TK_VOTE,
    )
    from scalecube_cluster_tpu_torch.sim import rapid
    from scalecube_cluster_tpu_torch.sim.faults import FaultPlan
    from scalecube_cluster_tpu_torch.sim.schedule import ScheduleBuilder
    from scalecube_cluster_tpu_torch.testlib.invariants import certify_rapid_traces
    from scalecube_cluster_tpu_torch.tools.trace_explain import check_rapid_chains

    n, ticks, kill_t, restart_t = 10240, 60, 4, 30
    victims = list(range(0, n, 160))  # every victim keeps live ring observers
    back = victims[::2]
    b = ScheduleBuilder(n).add_segment(1, FaultPlan.uniform(0.0, device="cuda"))
    for v in victims:
        b.kill(kill_t, v)
    for v in back:
        b.restart(restart_t, v)
    sched = b.build()
    params = rapid.RapidParams(n=n)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    st = rapid.init_rapid_full_view(params, seed=0, trace_capacity=1 << 20, fallback=True,
                                    device="cuda")
    per_tick, traces = [], []
    syncs = prof = None
    for t in range(1, ticks + 1):
        t0 = time.perf_counter()
        st, tr = rapid.run_rapid_ticks(params, st, sched, 1)
        traces.append({k: v.cpu().numpy() for k, v in tr.items()})
        per_tick.append(time.perf_counter() - t0)
        if t == 20:  # ticks 21-25 (one SYNC tick) from a copy: host reads, profile
            probe = st.replace(trace=None)  # the recorder reads nothing; keep the ring

            def five(_=None):
                rapid.run_rapid_ticks(params, probe, sched, 5, collect=False)

            syncs = sync_calls(five) / 5
            prof = _device_profile(five, 5)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    tr = {k: np.concatenate([x[k] for x in traces]) for k in traces[0]}
    if any(read_counts().values()):
        fail(f"[26] Rapid launched a kernel: {read_counts()}")
    cons = tr["link_attempts"] == tr["link_delivered"] + tr["fault_blocked"] + tr["fault_lost"]
    if not cons.all():
        fail(f"[26] conservation broken at ticks {np.flatnonzero(~cons)[:5] + 1}")
    if int(tr["trace_overflow"][-1]) != 0:
        fail(f"[26] the ring overflowed: {int(tr['trace_overflow'][-1])}")
    for k, v in tr.items():
        if not np.all(np.isfinite(v.astype(np.float64))):
            fail(f"[26] trace {k} is not finite")
    summary = certify_rapid_traces(params, tr, fallback=True)
    kinds = {TK_VIEW_COMMIT, TK_FB_ACCEPT, TK_FB_PREPARE, TK_VOTE, TK_JOIN_CONFIRM,
             TK_JOIN_ACK, TK_JOIN_REQ}
    events = ring_events(st.trace, kinds=kinds)
    chains = check_rapid_chains(events)
    if chains:
        fail(f"[26] chain violations: {chains[:3]}")
    vc_ticks = np.flatnonzero(tr["view_changes"] > 0) + 1
    if not len(vc_ticks):
        fail("[26] the mass kill never committed")
    first = int(vc_ticks[0])
    i = first - 1
    live = tr["alive_mask"][i]
    one_change = bool(
        tr["view_changes"][i] == live.sum()
        and np.all(tr["view_size"][i][live] == n - len(victims))
        and np.all(tr["view_id"][i][live] == 1)
        and tr["verdicts_dead"][i] == len(victims) * live.sum()
    )
    if not one_change:
        fail(f"[26] the 64-member batch did not commit as one view change on every live "
             f"member at tick {first}: view_changes {int(tr['view_changes'][i])} of "
             f"{int(live.sum())} live, sizes {np.unique(tr['view_size'][i][live]).tolist()}")
    readmit = [int(t) for t in vc_ticks if t > restart_t and tr["verdicts_alive"][t - 1] > 0]
    final_live = tr["alive_mask"][-1]
    final_sizes = np.unique(tr["view_size"][-1][final_live]).tolist()
    ms = np.array(per_tick) * 1e3
    # Busy ticks broadcast over [N, N] (votes, fallback or join messages, the
    # SYNC round); the first tick (the run's set-up) is left out of both.
    busy = (tr["msgs_sync"] > 0)[1:]
    later = ms[1:]
    say(f"[26] Rapid n={n} k={params.k} fallback, clean plan, {len(victims)} killed at tick "
        f"{kill_t} (every 160th row), {len(back)} restarted at {restart_t}, {ticks} ticks "
        f"collected, ring 1 << 20: the batch commits at tick {first} as one view change on "
        f"every live member ({int(tr['view_changes'][i])} members, view size "
        f"{n - len(victims)}, view id 1); readmission commits at ticks {readmit[:4]}; final "
        f"view sizes {final_sizes}, convergence {float(tr['convergence'][-1])}")
    say(f"[26] R1-R5 certified (fallback): view_changes {summary['view_changes']}, parked "
        f"{summary['views_parked']}, fallback_commits {summary['fallback_commits']}, "
        f"join_requests {summary['join_requests']}, join_confirms {summary['join_confirms']}; "
        f"{int(st.trace.cursor)} ring events, {len(events)} on the chain kinds, every "
        f"fallback commit and join confirm walks back whole; link_attempts == delivered + "
        f"blocked + lost on all {ticks} ticks")
    say(f"[26] ms per tick: {np.round(ms, 3).tolist()}")
    say(f"[26] {ms.mean():.3f} ms/tick mean over {ticks} ticks, each ending in a fetch; ticks "
        f"2-{ticks} sending no [N, N] message: median {np.median(later[~busy]):.3f} (min "
        f"{later[~busy].min():.3f}, max {later[~busy].max():.3f}, {int((~busy).sum())} ticks); "
        f"ticks sending votes, fallback or join messages or the SYNC round: median "
        f"{np.median(later[busy]):.3f} (max {later[busy].max():.3f}, {int(busy.sum())} ticks); "
        f"tick 1 {ms[0]:.3f}; peak device memory {peak_gib:.3f} GiB")
    top = sorted(prof["top_device_ms_per_tick"].items(), key=lambda kv: -kv[1][0])[:6]
    say(f"[26] ticks 21-25 (one SYNC tick), uncollected, from a copy at tick 20: "
        f"{syncs:.1f} synchronising calls a tick; profile {prof['wall_ms_per_tick']:.3f} "
        f"ms/tick, device busy {prof['device_busy_ms_per_tick']:.3f} ms/tick, idle share "
        f"{prof['device_idle_share']:.4f}, {prof['device_launches_per_tick']:.1f} launches a "
        f"tick; top kernels (ms, launches a tick): "
        + "; ".join(f"{_short_kernel(name)} {v[0]:.3f} {v[1]:.1f}" for name, v in top))
    return {"ms": ms.tolist(), "first_commit": first, "readmit": readmit,
            "peak_gib": peak_gib, "syncs": syncs, "profile": prof}


#: Phase 27's serving replays (testlib/serving.py) and their sizes on the
#: card: the fused core at n=1024, S=256 (kills, restarts, gossip; wire
#: joins and a promotion to 2048 rows), Rapid at n=64.
SERVE_CARD_SIZES = {
    "kill-restart": {"n": 1024, "s": 256},
    "gossip": {"n": 1024, "s": 256},
    "elastic": {"n": 1024, "n_live": 896, "s": 256, "pallas_core": True, "trace_capacity": 0,
                "capacity": 32},
    "elastic-ticked": {"n": 1024, "n_live": 896, "s": 256, "pallas_core": True},
    "rapid": {"n": 64},
}


def phase_serving_card_vs_cpu(torch):
    """Phase 27: serving replays through a ServeBridge, card vs CPU (every
    state leaf, trace, export row, live row and counter), and on the card
    against the offline FaultSchedule run of the same fired events."""
    import numpy as np

    from scalecube_cluster_tpu_torch.testlib import serving as SV

    launched_total = 0
    for name, sizes in SERVE_CARD_SIZES.items():
        sc = SV.scenario(name, **sizes)
        reset_counts()
        card = SV.serve_replay(name, "cuda", **sizes)
        launched = read_counts()["sparse_core"]
        cpu = SV.serve_replay(name, "cpu", **sizes)
        _compare_runs(f"[27] {name}", [(card["state"], None)] + [({}, t) for t in card["traces"]],
                      [(cpu["state"], None)] + [({}, t) for t in cpu["traces"]])
        if [SV.row_values(r) for r in card["rows"]] != [SV.row_values(r) for r in cpu["rows"]]:
            fail(f"[27] {name}: export rows differ between card and CPU")
        if SV.row_values(card["live"]) != SV.row_values(cpu["live"]) or (
                card["counters"] != cpu["counters"]):
            fail(f"[27] {name}: live row or counters differ between card and CPU")
        ticks = sum(len(t["tick"]) for t in card["traces"])
        expect = ticks if sc.get("pallas_core") else 0
        if launched != expect:
            fail(f"[27] {name}: sparse_core launched {launched} times on {ticks} ticks "
                 f"(expected {expect})")
        launched_total += launched
        anchor = "no schedule form (gossip)" if name == "gossip" else "promotion: no twin"
        if sc["fired"] is not None:
            off = SV.offline_run(name, "cuda", **sizes)
            tr = SV.concat_traces(card["traces"])
            _compare_runs(f"[27] {name} offline", [(off["state"], None)],
                          [(card["state"], None)])
            for k in set(off["traces"]) - {"ingest_overflow"}:
                if not np.array_equal(off["traces"][k], tr[k]):
                    fail(f"[27] {name}: trace {k} differs from the offline run")
            anchor = "equals its offline FaultSchedule run"
        if name == "elastic" and (card["counters"]["promotions"] != 1
                                  or card["counters"]["n_live"] != 1030):
            fail(f"[27] elastic: counters {card['counters']}")
        summary = card["rows"][-1]
        say(f"[27] {name} ({', '.join(f'{k}={v}' for k, v in sizes.items())}): card == CPU on "
            f"{len(card['state'])} leaves, {len(card['traces'])} launches, {ticks} ticks, "
            f"{len(card['rows'])} rows; {summary['events_total']} events served, "
            f"ingest_overflow {summary['ingest_overflow']}; sparse_core {launched}; {anchor}")
    return launched_total


def phase_serving_main_path(torch, main_row):
    """Phase 28: the serving main path at width — the --serve session at
    n=32768, S=512 through the fused core, one warm-up batch then six
    timed 48-tick batches of the rung's gossip stream."""
    import numpy as np

    from scalecube_cluster_tpu_torch.bench import serve_gossip_stream, serve_session

    n, s, k, c, batches = 32768, 512, 48, 8, 6
    ticks = k * batches
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    bridge, wall_s = serve_session(n, k, c, batches, slot_budget=s, pallas_core=True,
                                   in_scan_writeback=False, device="cuda")
    counts = read_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    row = bridge.close()
    launches = counts["sparse_core"]
    if launches != ticks + k:
        fail(f"[28] sparse_core launched {launches} times, expected {ticks} served + {k} warm-up")
    if row["ticks"] != ticks or row["events_total"] != ticks * (c // 2) or row["events_pending"]:
        fail(f"[28] session served {row['events_total']} events over {row['ticks']} ticks")
    state = bridge.state
    slot_subj, subj_slot = state.slot_subj.cpu().numpy(), state.subj_slot.cpu().numpy()
    active = np.flatnonzero(slot_subj >= 0)
    if not np.array_equal(subj_slot[slot_subj[active]], active):
        fail("[28] slot tables are inconsistent after the session")
    s7 = int(subj_slot[7])
    flagged = _flagging_viewers(state.alive, state.slab[:, s7] if s7 >= 0 else state.view_T[7, :], 7)
    if flagged == 0:
        fail("[28] no live viewer suspects or convicts the killed member 7")
    if not bool(state.useen.any()):
        fail("[28] no member holds the served user gossip")
    ms = wall_s * 1e3 / ticks
    g = bridge.batcher.g_slots
    syncs = _sync_calls(torch, lambda: bridge.run_replay(
        serve_gossip_stream(n, k, c // 2, g, first_tick=bridge.state.t_host + 1), k))
    ratio = ms / main_row["ms_per_tick"]
    say(f"[28] serving main path n={n} S={s}, batch_ticks={k}, capacity={c}, {batches} timed "
        f"batches: {ms:.3f} ms/tick ({ratio:.4f}x phase 5's {main_row['ms_per_tick']:.3f}), "
        f"close() row: {row['events_per_sec']:.1f} events/s, "
        f"{row['member_rounds_per_sec']:.1f} member·rounds/s, batch latency p50 "
        f"{row['latency_ms_p50']:.3f} / p95 {row['latency_ms_p95']:.3f} / p99 "
        f"{row['latency_ms_p99']:.3f} ms; peak device memory {peak_gib:.3f} GiB; "
        f"{syncs} synchronising calls a batch; sparse_core {launches - k} of {ticks} serving "
        f"ticks (+{k} warm-up); live viewers flagging member 7: {flagged}")
    return launches, {"ms_per_tick": ms, "ratio": ratio, "peak_gib": peak_gib, "syncs": syncs,
                      "row": row}


def phase_serving_grow(torch):
    """Phase 29: elastic serving at width — the --grow session from 16,384
    live rows in 32,768 through one promotion to 65,536, wire joins in
    bursts of 1,024 a batch, the fused core on every tick."""
    import statistics

    from scalecube_cluster_tpu_torch.bench import grow_row, grow_session, rung_slot_budget
    from scalecube_cluster_tpu_torch.sim.sparse import SparseParams, sparse_route

    n0, tiers, burst, k = 16384, 1, 1024, 8
    n_top = 2 * n0 * 2**tiers
    s = rung_slot_budget(n_top)
    if not sparse_route(SparseParams.for_n(n_top, slot_budget=s, pallas_core=True)):
        fail(f"[29] the kernel's gate refuses S={s} at n={n_top}")
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    bridge, wall_s, n_joins = grow_session(n0, tiers, burst, batch_ticks=k, capacity=burst,
                                           slot_budget=s, pallas_core=True,
                                           in_scan_writeback=False, device="cuda")
    counts = read_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    led = bridge.batcher.join_ledger()
    promos = [r for r in bridge.rows if r["kind"] == "promotion"]
    if led["placed"] != n_joins or led["shed"] or led["deferred"] or len(promos) != tiers:
        fail(f"[29] ledger {led}, promotions {len(promos)}")
    t_promo = promos[0]["base_tick"]
    spans = bridge.spans
    before, after = [], []
    for a, b in zip(spans, spans[1:]):
        if b["base_tick"] == t_promo:
            continue  # this step promoted first
        (before if b["base_tick"] < t_promo else after).append((b["t0"] - a["t0"]) * 1e3 / k)
    row = grow_row(bridge, wall_s, n0, tiers, n_joins)
    if row["n_live"] != n_top or row["dropped"] != 0:
        fail(f"[29] n_live {row['n_live']}, dropped {row['dropped']}")
    if counts["sparse_core"] != row["ticks"]:
        fail(f"[29] sparse_core launched {counts['sparse_core']} times on {row['ticks']} ticks")
    ms_before, ms_after = statistics.median(before), statistics.median(after)
    say(f"[29] elastic serving n0={n0} live in {2 * n0} -> {n_top}, S={s}, bursts of {burst} "
        f"joins a {k}-tick batch: {row['value']:.1f} joins admitted/s, {row['joins_total']} joins, "
        f"dropped {row['dropped']}, promotion wall {row['promotion_wall_ms']} ms, "
        f"{ms_before:.3f} ms/tick before and {ms_after:.3f} after it (medians over batches), "
        f"{row['batches']} batches / {row['ticks']} ticks in {row['wall_s']} s; peak device "
        f"memory {peak_gib:.3f} GiB; sparse_core {counts['sparse_core']} of {row['ticks']} ticks")
    return counts["sparse_core"], {"row": row, "ms_before": ms_before, "ms_after": ms_after,
                                   "peak_gib": peak_gib}


async def _telemetry_poll(torch):
    """A live session on the card fed over loopback TCP, then one
    ``serve/metrics`` poll and one Prometheus scrape of it."""
    import asyncio

    from scalecube_cluster_tpu_torch.cluster_api.config import TransportConfig
    from scalecube_cluster_tpu_torch.serve import ServeBridge
    from scalecube_cluster_tpu_torch.serve.telemetry import (
        METRICS_QUALIFIER,
        MetricsResponder,
        PrometheusEndpoint,
    )
    from scalecube_cluster_tpu_torch.sim.faults import FaultPlan
    from scalecube_cluster_tpu_torch.sim.sparse import SparseParams, init_sparse_full_view
    from scalecube_cluster_tpu_torch.transport.message import Message
    from scalecube_cluster_tpu_torch.transport.tcp import TcpTransport

    params = SparseParams.for_n(1024, slot_budget=256, pallas_core=True)
    bridge = ServeBridge(params, init_sparse_full_view(1024, 256, device="cuda"),
                         plan=FaultPlan.uniform(loss_percent=5.0, device="cuda"),
                         batch_ticks=8, capacity=4)
    server = await TcpTransport.bind(TransportConfig(connect_timeout=1000))
    client = await TcpTransport.bind(TransportConfig(connect_timeout=1000))
    responder = MetricsResponder(bridge, server)
    responder.start()
    prom = PrometheusEndpoint(bridge)
    await prom.start()
    try:
        live = asyncio.ensure_future(bridge.run_live(server, n_batches=3, settle_s=0.1))
        await asyncio.sleep(0.05)
        for node in (3, 4):
            await client.send(server.address, Message.create(
                qualifier="serve/event", data={"kind": "kill", "node": node},
                sender=client.address))
        await asyncio.wait_for(live, timeout=60)
        req = Message.create(qualifier=METRICS_QUALIFIER, correlation_id="m1",
                             sender=client.address)
        polled = (await client.request_response(server.address, req, timeout=5)).data
        reader, writer = await asyncio.open_connection("127.0.0.1", prom.port)
        writer.write(b"GET /metrics HTTP/1.0\r\nHost: x\r\n\r\n")
        await writer.drain()
        scraped = (await reader.read()).decode()
        writer.close()
    finally:
        await responder.stop()
        await prom.stop()
        await client.stop()
        await server.stop()
    return bridge, polled, scraped


def phase_serving_wire(torch):
    """Phase 30: the wire — native framing built and loaded, the --load
    harness against a session on the card, and the telemetry plane."""
    import asyncio

    from scalecube_cluster_tpu_torch import native
    from scalecube_cluster_tpu_torch.bench import measure_load
    from scalecube_cluster_tpu_torch.obs.export import prometheus_text

    _, _, is_native = native.load_framing(build=True)
    if not is_native:
        fail("[30] native/framing.c did not build with cc: the wire fell back to Python")
    reset_counts()
    k = 4
    row = measure_load(32, 1024, pallas_core=True, batch_ticks=k, capacity=256, settle_s=0.05,
                       device="cuda")
    launches = read_counts()["sparse_core"]
    if not (row["conservation_ok"] and row["rejected_ok"] and row["bounded_ok"]) or row[
            "producer_errors"] or row["pending"]:
        fail(f"[30] load audit failed: {json.dumps(row)}")
    if launches != row["batches"] * k:
        fail(f"[30] sparse_core launched {launches} times over {row['batches']} batches")
    say(f"[30] native framing: {native._so_path().name} loaded; --load 32 1024 on the card "
        f"({k}-tick launches, capacity 256, 50 ms of the event loop between launches): "
        f"{row['served']} of {row['pushed']} events served, {row['rejected']} rejected of "
        f"{row['events_injected_malformed']} malformed, {row['reconnects']} reconnects, "
        f"{row['backpressure_pauses']} backpressure pauses, peak_pending {row['peak_pending']}, "
        f"{row['batches']} batches in {row['wall_s']:.2f} s ({row['events_per_sec']:.1f} "
        f"events/s), latency p50 {row['latency_ms_p50']:.3f} / p99 {row['latency_ms_p99']:.3f} "
        f"ms, conservation / rejected / bounded all true, producer errors 0; sparse_core "
        f"{launches}")
    bridge, polled, scraped = asyncio.run(asyncio.wait_for(_telemetry_poll(torch), timeout=180))
    body = scraped.split("\r\n\r\n", 1)[-1]
    if not scraped.startswith("HTTP/1.0 200 OK") or body != prometheus_text([polled]):
        fail("[30] the Prometheus scrape differs from the serve/metrics poll")
    if polled["kind"] != "serve_live" or polled["batches"] != 3 or bridge.events_served != 2:
        fail(f"[30] live row {polled}")
    if bool(bridge.state.alive[3]) or bool(bridge.state.alive[4]):
        fail("[30] the wire kills did not land")
    say(f"[30] telemetry: serve/metrics poll == Prometheus scrape ({len(body.splitlines())} "
        f"lines), batches {polled['batches']}, latency p95 {polled['latency_ms_p95']:.3f} ms")
    return row


def _kernel_entry(name, source, replaces, launches, row, checked_in, by_path=None,
                  batched=None):
    entry = {
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
        "library_ms": row.get("library_ms"),
        **{key: row[key] for key in ("ms_device", "library_ms_device", "launch_floor_ms", "wide")
           if key in row},
        "checked_in": checked_in,
        **({"launches_by_path": by_path} if by_path else {}),
    }
    if batched:
        entry["batched"] = batched
    return entry


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

    from scalecube_cluster_tpu_torch.tools.probe_kernels import PROBES

    t_start = time.perf_counter()
    card = phase_card(torch)
    phase_build()
    core_rows = phase_kernel_vs_plain(torch)
    phase_card_vs_cpu(torch)
    sparse_launches, main_row = phase_main_path(torch)
    dense_rows = phase_dense_kernel_vs_plain(torch)
    phase_dense_card_vs_cpu(torch)
    dense_launches = phase_dense_main_path(torch)
    persist_rows = phase_persistent_vs_plain(torch)
    persist_launches, _ = phase_persistent_path(torch)
    dm_rows = phase_delivery_merge_vs_plain(torch)
    dm_launches = phase_delivery_merge_path(torch)
    probe_rows, probe_counts = phase_probes(torch)
    phase_convergence_sum(torch)
    phase_timelines_card_vs_cpu(torch)
    sched_sparse_launches, _ = phase_scheduled_sparse(torch)
    sched_dense_launches, _ = phase_dense_timeline(torch)
    phase_recorder_elastic_card_vs_cpu(torch)
    elastic_launches, _ = phase_elastic_full_width(torch)
    phase_recorder_full_width(torch)
    batched_rows = phase_batched_kernels(torch)
    ens_dense_launches, ens_card_launches = phase_ensemble_card_vs_cpu(torch)
    ens_launches, _ = phase_sparse_ensemble_full_width(torch)
    phase_rapid_card_vs_cpu(torch)
    phase_rapid_rung(torch)
    phase_rapid_dense_width(torch)
    serve_card_launches = phase_serving_card_vs_cpu(torch)
    serve_launches, _ = phase_serving_main_path(torch, main_row)
    grow_launches, _ = phase_serving_grow(torch)
    phase_serving_wire(torch)

    kernels = {
        "kernels": [
            _kernel_entry(
                "sparse_core", "scalecube_cluster_tpu_torch/csrc/sparse_core.cu",
                "scalecube_cluster_tpu/ops/pallas_sparse.py:444",
                sparse_launches + sched_sparse_launches + elastic_launches + ens_launches
                + serve_card_launches + serve_launches + grow_launches,
                core_rows[(32768, 512)],
                ["[3] kernel vs plain", "[4] card vs CPU", "[5] main path",
                 "[15] timelines card vs CPU", "[16] scheduled path",
                 "[18] elastic card vs CPU", "[19] elastic path",
                 "[21] batched kernel vs plain and vs single launches",
                 "[22] ensemble card vs CPU", "[23] sparse ensemble path",
                 "[27] serving card vs CPU", "[28] serving main path",
                 "[29] elastic serving path"],
                {"[5] main path": sparse_launches, "[16] scheduled path": sched_sparse_launches,
                 "[19] elastic path": elastic_launches, "[23] sparse ensemble path": ens_launches,
                 "[22] ensemble card vs CPU (card side)": ens_card_launches,
                 "[27] serving card vs CPU (card side)": serve_card_launches,
                 "[28] serving main path": serve_launches,
                 "[29] elastic serving path": grow_launches},
                batched=batched_rows["sparse_core"],
            ),
            _kernel_entry(
                "tick_core", "scalecube_cluster_tpu_torch/csrc/tick_core.cu",
                "scalecube_cluster_tpu/ops/pallas_tick.py:476",
                dense_launches + sched_dense_launches, dense_rows[10240],
                ["[6] kernel vs plain", "[7] card vs CPU", "[8] dense main path",
                 "[15] timelines card vs CPU", "[17] dense timeline",
                 "[21] batched kernel vs plain and vs single launches",
                 "[22] ensemble card vs CPU"],
                {"[8] dense main path": dense_launches, "[17] dense timeline": sched_dense_launches,
                 "[22] dense ensemble, fused route (card side)": ens_dense_launches},
                batched=batched_rows["tick_core"],
            ),
            _kernel_entry(
                "sparse_core_persistent",
                "scalecube_cluster_tpu_torch/csrc/sparse_persistent.cu",
                "scalecube_cluster_tpu/ops/pallas_sparse.py:867", persist_launches,
                persist_rows[(32768, 8)],
                ["[9] kernel vs plain (k = 1, 2, 8 at n=32768; 1, 3, 5 at n=1024; tile "
                 "edges at S = 128, 384 and f = 2, 7; planes off alignment refused)",
                 "[10] k-sweep path"],
            ),
            _kernel_entry(
                "delivery_merge", "scalecube_cluster_tpu_torch/csrc/delivery_merge.cu",
                "scalecube_cluster_tpu/ops/pallas_tick.py:195", dm_launches,
                dm_rows[10240],
                ["[11] kernel vs plain (n=10240, 256, 96; tile edges at n = 264, 1032 "
                 "and f = 2, 8; planes off alignment)", "[12] profile_tick path"],
            ),
            *(
                _kernel_entry(
                    name, "scalecube_cluster_tpu_torch/csrc/probes.cu",
                    f"tools/probe_mosaic.py:{probe[3]}", probe_counts[name],
                    probe_rows[name],
                    ["[13] probe PASS, kernel vs plain",
                     "[13] ragged shapes and 10240x10240, aligned and off alignment"],
                )
                for name, probe in PROBES.items()
            ),
        ]
    }
    say(f"[31] total {time.perf_counter() - t_start:.1f} s")
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
