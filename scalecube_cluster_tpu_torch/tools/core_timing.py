"""Time the port's four large kernels at their paths' shapes, and the
five card probes at theirs and at the dense main path's width, and count
their SASS.

Run on a CUDA card, as a file so that ``--root`` can pick the checkout
whose package is timed (another tree's, for a same-call A/B):

    python scalecube_cluster_tpu_torch/tools/core_timing.py [--root DIR]
        [--kernels tick_core,sparse_core,persistent,delivery_merge,p_smallint,
                   p_window2d,p_accum,p_fdmask,p_roll]
        [--sass OUT_DIR]

The two fused cores draw ``testing.py``'s seeded operands (dense n=10240,
f=3, seed 1; sparse n=32768, S=512, f=3, seed 1: the operands of
``chip_smoke.py``'s phases 3 and 6) under two fan-out layouts:

- ``random``: the drawn permutation, as on the main paths;
- ``neighbour``: ``ginv[c, g] = (g + c) % groups``, so the f receiver
  groups that read a sender group are neighbouring CTAs and read it at
  about the same time (the L2 serves all but the first read).

The gap between the two sizes the share of a kernel's time that sender
re-reads from device memory cost. The persistent core is timed on the
k-sweep's operands at n=32768, S=512, k_max=8 (seed 1, phase 9's) at k = 1
and k = 8, with the slope per added tick, (ms(8) - ms(1)) / 7;
delivery-merge on the dense operands at n=10240 (seed 3, phase 11's);
the five probes (``tools/probe_kernels.py``) at the probe's shape and at
[10240, 10240] (p_window2d: a [10240, 10240] ``rows``, 40 column tiles and
10240 output rows), on operands drawn here (seed 7), so that an older
tree's probes are timed on the same ones. p_window2d is launched through
its C launcher ``probe_window2d``, which takes the output's row count in
every tree (an older wrapper fixes it at 32), into one output allocated
once.
Each kernel is checked equal to its plain version once, then timed with
CUDA events (mean per wrapper call over ``REPS`` calls after one warm-up);
the persistent core and delivery-merge also by the profiler's device time
per call (``device_ms``, the host's enqueue taken out: the persistent
core's k=1 call is short enough for a slow host to set its event time);
the probes also on the device alone by a CUDA-graph replay
(``ms_device``, as ``chip_smoke.py`` phase 13 times them), p_accum beside
one ``torch.sum(x, dim=1, dtype=torch.int32)`` and p_roll beside one
``torch.roll(x, 3, dims=0)``, each timed both ways.
``--sass OUT_DIR`` writes ``cuobjdump -sass`` of the chosen kernels'
libraries there and prints, per kernel, its instruction count and each
loop's span (a backward branch and its target) with its memory
instructions by class.

One JSON line per measurement, the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import functools
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

REPS = 50
DENSE = dict(n=10240, f=3, seed=1)
SPARSE = dict(n=32768, s=512, f=3, seed=1)
DENSE_CONSTS = dict(spread=42, sweep=86, susp_ticks=350, age_stale=120)
SPARSE_CONSTS = dict(spread=48, susp_ticks=400, age_stale=120, sweep=98)
PERSISTENT = dict(n=32768, s=512, f=3, k_max=8, seed=1)
MERGE = dict(n=10240, f=3, seed=3)
WIDE = (10240, 10240)
PROBE_SHAPES = {"p_smallint": ((64, 256), WIDE), "p_window2d": ((64, 512), WIDE),
                "p_accum": ((32, 512), WIDE), "p_fdmask": ((64, 256), WIDE),
                "p_roll": ((8, 256), WIDE)}
#: p_window2d's output rows at each of its shapes (the probe's 32; the width's).
WINDOW_OUT_ROWS = {(64, 512): 32, WIDE: 10240}
WINDOW_MC = 256
KERNELS = ("tick_core", "sparse_core", "persistent", "delivery_merge", *PROBE_SHAPES)


def neighbour_ginv(ginv):
    """``ginv[c, g] = (g + c) % groups``: the f readers of a sender group
    are the neighbouring receiver groups g - c."""
    import numpy as np

    f, groups = ginv.shape
    base = np.arange(groups, dtype=np.int32)
    return np.stack([np.roll(base, -c) for c in range(f)]).astype(np.int32)


def time_cuda(torch, fn, reps=REPS):
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


def time_graph(torch, fn, reps=REPS):
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


def device_ms(torch, fn, reps=20):
    """Device ms per call of ``fn`` with the host taken out: the summed
    durations of its kernels and memsets under ``torch.profiler``, over
    ``reps`` calls after one warm-up. Where the host enqueues a call more
    slowly than the card runs it, :func:`time_cuda` reads the host."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    spans = [e.time_range.end - e.time_range.start for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    if not spans:
        raise SystemExit("core_timing: the profiler recorded no device activity")
    return sum(spans) / 1e3 / reps


def _check_equal(torch, got, want, what):
    for i, (g, w) in enumerate(zip(got, want)):
        if not torch.equal(g, w):
            raise SystemExit(f"core_timing: {what}: output {i} differs from the plain version")


def _time_core(torch, wrapper, reference, operands, consts, label):
    rows = []
    for layout in ("random", "neighbour"):
        ops = dict(operands)
        if layout == "neighbour":
            ops["ginv"] = neighbour_ginv(ops["ginv"])
        args = tuple(torch.from_numpy(v).cuda() for v in ops.values())
        _check_equal(torch, wrapper(*args, **consts), reference(*args, **consts),
                     f"{label} {layout}")
        ms = time_cuda(torch, lambda: wrapper(*args, **consts))
        rows.append({"kernel": label, "layout": layout, "ms": ms})
        del args
        torch.cuda.empty_cache()
    return rows


def _time_persistent(torch, sp, operands):
    """The persistent core at k = 1 and k = 8, and the slope per added tick."""
    kw = dict(spread=6, susp_ticks=20, age_stale=120, sweep=6, k_max=PERSISTENT["k_max"],
              fold=frozenset({"countdown", "wb_mask", "view_rows"}))
    args = tuple(torch.from_numpy(v).cuda() for v in operands.values())
    label = "sparse_core_persistent n=32768 S=512"
    rows = {}
    for k in (1, PERSISTENT["k_max"]):
        _check_equal(torch, sp.sparse_core_persistent(*args, k, **kw),
                     sp.sparse_core_persistent_reference(*args, k, **kw), f"{label} k={k}")
        call = functools.partial(sp.sparse_core_persistent, *args, k, **kw)
        rows[k] = {"kernel": label, "k": k, "ms": time_cuda(torch, call),
                   "device_ms": device_ms(torch, call)}
    k_hi = PERSISTENT["k_max"]
    slope = {key: (rows[k_hi][key] - rows[1][key]) / (k_hi - 1) for key in ("ms", "device_ms")}
    return [*rows.values(), {"kernel": label, "ms_per_added_tick": slope["ms"],
                             "device_ms_per_added_tick": slope["device_ms"]}]


def _time_merge(torch, dm, operands):
    fields = ("rows", "view0", "ginv", "rots", "edge_ok", "alive")
    args = tuple(torch.from_numpy(operands[k]).cuda() for k in fields)
    label = "delivery_merge n=10240"
    _check_equal(torch, dm.delivery_merge(*args), dm.delivery_merge_reference(*args), label)
    call = functools.partial(dm.delivery_merge, *args)
    return [{"kernel": label, "ms": time_cuda(torch, call), "device_ms": device_ms(torch, call)}]


def probe_operands(name, shape, seed=7):
    """Seeded numpy operands of probe ``name`` at ``shape``:
    ``probe_kernels.shaped_inputs``' draws, made here because an older
    tree's ``probe_kernels`` lacks it. p_smallint: ages in [0, 120),
    countdowns in [0, 400), payloads in [-1, 2**20); p_window2d: ``rows``
    over all of int32 and one window block in [0, n // 8) per 256-column
    tile; p_accum and p_roll: all of int32; p_fdmask: targets in [-1, m)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n, m = shape
    if name == "p_smallint":
        return (rng.integers(0, 120, shape).astype(np.int8),
                rng.integers(0, 400, shape).astype(np.int16),
                rng.integers(-1, 1 << 20, shape).astype(np.int32))
    if name == "p_window2d":
        return (rng.integers(-(1 << 31), 1 << 31, shape, dtype=np.int32),
                rng.integers(0, n // 8, m // WINDOW_MC).astype(np.int32))
    if name in ("p_accum", "p_roll"):
        return (rng.integers(-(1 << 31), 1 << 31, shape, dtype=np.int64).astype(np.int32),)
    return (rng.integers(-1, m, n).astype(np.int32), rng.integers(0, 1 << 20, n).astype(np.int32),
            rng.integers(-1, 1 << 20, shape).astype(np.int32))


def window2d_launcher(torch, pk, rows, idx, out_rows):
    """A call of ``probe_window2d`` (the C launcher) into one output
    allocated here, and its plain result: for tile j, ``rows``' 8-row
    window at block ``idx[j]`` repeated down ``out_rows`` rows."""
    lib = pk.LIBRARY.load()
    m = rows.shape[1]
    out = torch.empty((out_rows, m), dtype=torch.int32, device=rows.device)

    def call():
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.probe_window2d(rows.data_ptr(), idx.data_ptr(), out.data_ptr(), idx.numel(),
                                 m, WINDOW_MC, out_rows, stream)
        if err:
            raise SystemExit(f"core_timing: probe_window2d failed ({err})")
        return out

    want = torch.cat([rows[8 * g: 8 * g + 8, j * WINDOW_MC: (j + 1) * WINDOW_MC]
                      .repeat(out_rows // 8, 1) for j, g in enumerate(idx.tolist())], dim=1)
    return call, want


def _time_probe(torch, pk, name):
    """Probe ``name``'s wrapper (p_window2d's launcher) at its two shapes:
    checked once against its plain version, then per call (CUDA events)
    and on the device alone (graph replay, 20 calls at the wide shape)."""
    _, wrapper, reference, _ = pk.PROBES[name]
    rows = []
    for shape in PROBE_SHAPES[name]:
        args = tuple(torch.from_numpy(a).cuda() for a in probe_operands(name, shape))
        label = f"{name} {shape[0]}x{shape[1]}"
        if name == "p_window2d":
            call, want = window2d_launcher(torch, pk, *args, WINDOW_OUT_ROWS[shape])
            label += f" out_rows={WINDOW_OUT_ROWS[shape]}"
            want = (want,)
        else:
            call, want = functools.partial(wrapper, *args), reference(*args)
            want = want if isinstance(want, tuple) else (want,)
        got = call()
        _check_equal(torch, got if isinstance(got, tuple) else (got,), want, label)
        del got, want
        reps = REPS if shape[0] * shape[1] < 1 << 20 else 20
        row = {"kernel": label, "ms": time_cuda(torch, call, reps),
               "ms_device": time_graph(torch, call, reps)}
        library = {
            "p_accum": lambda: torch.sum(args[0], dim=1, dtype=torch.int32),
            "p_roll": lambda: torch.roll(args[0], 3, dims=0),
        }.get(name)
        if library is not None:
            row.update(library_ms=time_cuda(torch, library, reps),
                       library_ms_device=time_graph(torch, library, reps))
        rows.append(row)
        del args, call, library
        torch.cuda.empty_cache()
    return rows


#: Memory instruction classes counted per loop (global and shared loads
#: and stores, atomics and reductions).
MEMORY_OPS = ("LDG", "STG", "LDS", "STS", "ATOMG", "ATOMS", "REDG", "RED")


def loop_spans(sass: str):
    """Per kernel function of a ``cuobjdump -sass`` listing: its instruction
    count and each loop's span (target, branch, the static instructions
    between, and how many of them are of each :data:`MEMORY_OPS` class).
    Static counts include the paths a common case jumps over."""
    out = {}
    for block in re.split(r"\n\s*Function : ", sass)[1:]:
        name = block.split("\n", 1)[0].strip()
        ops, loops = [], []
        for m in re.finditer(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", block):
            addr = int(m.group(1), 16)
            text = re.sub(r"^@!?U?P[0-9T]+\s+", "", m.group(2).strip())
            ops.append((addr, text.split(".", 1)[0].split()[0] if text else ""))
            br = re.search(r"\bBRA\b.*?(0x[0-9a-f]+)", m.group(2))
            if br and int(br.group(1), 16) <= addr:
                target = int(br.group(1), 16)
                body = [op for a, op in ops if target <= a <= addr]
                loops.append({"from": hex(target), "to": hex(addr), "instructions": len(body),
                              "memory": {c: body.count(c) for c in MEMORY_OPS if c in body}})
        out[name] = {"instructions": len(ops), "loops": loops}
    return out


def dump_sass(libraries, out_dir: Path):
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out_dir.mkdir(parents=True, exist_ok=True)
    rows = []
    for lib in libraries:
        sass = subprocess.run([tool, "-sass", str(lib.target())], capture_output=True,
                              text=True, check=True).stdout
        (out_dir / f"{lib.name}.sass").write_text(sass)
        for fn, info in loop_spans(sass).items():
            rows.append({"library": lib.name, "function": fn, **info})
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="core_timing.py")
    ap.add_argument("--root", type=Path, default=Path(__file__).resolve().parents[2],
                    help="checkout whose scalecube_cluster_tpu_torch is timed")
    ap.add_argument("--kernels", default=",".join(KERNELS),
                    help=f"comma-separated subset of {', '.join(KERNELS)}")
    ap.add_argument("--sass", type=Path, help="write cuobjdump -sass here and count it")
    args = ap.parse_args(argv)
    chosen = args.kernels.split(",")
    if not set(chosen) <= set(KERNELS):
        ap.error(f"--kernels: unknown {sorted(set(chosen) - set(KERNELS))}")
    sys.path.insert(0, str(args.root.resolve()))

    import torch

    if not torch.cuda.is_available():
        print("core_timing: no CUDA device; the timing needs the card", file=sys.stderr)
        return 2
    from scalecube_cluster_tpu_torch import testing
    from scalecube_cluster_tpu_torch.ops import delivery_merge as dm
    from scalecube_cluster_tpu_torch.ops import sparse_core as sc
    from scalecube_cluster_tpu_torch.ops import sparse_persistent as sp
    from scalecube_cluster_tpu_torch.ops import tick_core as tc
    from scalecube_cluster_tpu_torch.tools import probe_kernels as pk

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    root = str(args.root.resolve())
    print(json.dumps({"card": card, "root": root, "torch": torch.__version__}), flush=True)
    timings = {
        "tick_core": lambda: _time_core(
            torch, tc.tick_core, tc.tick_core_reference,
            testing.random_tick_operands(DENSE["n"], DENSE["f"], seed=DENSE["seed"],
                                         susp_ticks=350),
            DENSE_CONSTS, "tick_core n=10240"),
        "sparse_core": lambda: _time_core(
            torch, sc.sparse_core, sc.sparse_core_reference,
            testing.random_operands(SPARSE["n"], SPARSE["s"], SPARSE["f"], seed=SPARSE["seed"]),
            SPARSE_CONSTS, "sparse_core n=32768 S=512"),
        "persistent": lambda: _time_persistent(
            torch, sp, testing.persistent_operands(**PERSISTENT)),
        "delivery_merge": lambda: _time_merge(
            torch, dm, testing.random_tick_operands(**MERGE)),
        **{name: functools.partial(_time_probe, torch, pk, name) for name in PROBE_SHAPES},
    }
    libraries = {"tick_core": tc.LIBRARY, "sparse_core": sc.LIBRARY,
                 "persistent": sp.LIBRARY, "delivery_merge": dm.LIBRARY,
                 **{name: pk.LIBRARY for name in PROBE_SHAPES}}
    for name in chosen:
        for row in timings[name]():
            print(json.dumps({**row, "root": root}), flush=True)
        torch.cuda.empty_cache()
    if args.sass:
        for row in dump_sass(list({id(libraries[n]): libraries[n] for n in chosen}.values()),
                             args.sass):
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
