"""Time the two fused cores (``tick_core``, ``sparse_core``) at the main
paths' shapes, by fan-out layout, and count their SASS.

Run on a CUDA card, as a file so that ``--root`` can pick the checkout
whose package is timed (another tree's, for a same-call A/B):

    python scalecube_cluster_tpu_torch/tools/core_timing.py [--root DIR]
        [--sass OUT_DIR]

For each core it draws ``testing.py``'s seeded operands (dense n=10240,
f=3, seed 1; sparse n=32768, S=512, f=3, seed 1: the operands of
``chip_smoke.py``'s phases 3 and 6) under two fan-out layouts:

- ``random``: the drawn permutation, as on the main paths;
- ``neighbour``: ``ginv[c, g] = (g + c) % groups``, so the f receiver
  groups that read a sender group are neighbouring CTAs and read it at
  about the same time (the L2 serves all but the first read).

The gap between the two sizes the share of a kernel's time that sender
re-reads from device memory cost. Each layout's kernel is checked equal
to the plain version once, then timed with CUDA events (mean per wrapper
call over ``REPS`` calls after one warm-up). ``--sass OUT_DIR`` writes
``cuobjdump -sass`` of both libraries there and prints, per kernel, its
instruction count and each loop's span (a backward branch and its target)
with its memory instructions by class.

One JSON line per measurement, the card's name and power limit first.
"""

from __future__ import annotations

import argparse
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
    ap.add_argument("--sass", type=Path, help="write cuobjdump -sass here and count it")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(args.root.resolve()))

    import torch

    if not torch.cuda.is_available():
        print("core_timing: no CUDA device; the timing needs the card", file=sys.stderr)
        return 2
    from scalecube_cluster_tpu_torch.ops import sparse_core as sc
    from scalecube_cluster_tpu_torch.ops import tick_core as tc
    from scalecube_cluster_tpu_torch.testing import random_operands, random_tick_operands

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    root = str(args.root.resolve())
    print(json.dumps({"card": card, "root": root, "torch": torch.__version__}), flush=True)
    dense_ops = random_tick_operands(DENSE["n"], DENSE["f"], seed=DENSE["seed"], susp_ticks=350)
    for row in _time_core(torch, tc.tick_core, tc.tick_core_reference, dense_ops,
                          DENSE_CONSTS, "tick_core n=10240"):
        print(json.dumps({**row, "root": root}), flush=True)
    del dense_ops
    sparse_ops = random_operands(SPARSE["n"], SPARSE["s"], SPARSE["f"], seed=SPARSE["seed"])
    for row in _time_core(torch, sc.sparse_core, sc.sparse_core_reference, sparse_ops,
                          SPARSE_CONSTS, "sparse_core n=32768 S=512"):
        print(json.dumps({**row, "root": root}), flush=True)
    if args.sass:
        for row in dump_sass([tc.LIBRARY, sc.LIBRARY], args.sass):
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
