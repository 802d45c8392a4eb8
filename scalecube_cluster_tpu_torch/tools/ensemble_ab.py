"""Time the B=4 sparse ensemble at the sparse main path's width
(``chip_smoke.py`` phase 23's path) from the package of a given checkout,
for a same-call A/B of two trees.

Run on a CUDA card, as a file so that ``--root`` can pick the checkout
whose package is timed:

    python scalecube_cluster_tpu_torch/tools/ensemble_ab.py [--root DIR] [--reps R]

Four universes of n=32768, S=512 through the kernel route (member 7 killed
in each, 5% loss), ``ensemble_writeback_free`` between 48-tick chunks: one
warm-up chunk, ``--reps`` timed chunks (default 8), each ending in a fetch
from the stacked view, then one chunk under ``bench.py::_device_profile``.
Prints one JSON line: ms/tick, universes·member·rounds/s, each chunk's
ms/tick, launches a tick, device busy ms a tick and the idle share.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", type=Path, default=Path(__file__).resolve().parents[2],
                    help="checkout whose scalecube_cluster_tpu_torch is timed")
    ap.add_argument("--reps", type=int, default=8, help="timed 48-tick chunks")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(args.root))
    import torch

    from scalecube_cluster_tpu_torch.bench import _device_profile
    from scalecube_cluster_tpu_torch.sim import ensemble as ens
    from scalecube_cluster_tpu_torch.sim.faults import FaultPlan
    from scalecube_cluster_tpu_torch.sim.sparse import SparseParams

    if not torch.cuda.is_available():
        print("ensemble_ab: no CUDA device", file=sys.stderr)
        return 2
    b, n, s, chunk = 4, 32768, 512, 48
    params = SparseParams.for_n(n, slot_budget=s, in_scan_writeback=False, pallas_core=True)
    states = ens.init_ensemble_sparse(n, range(b), slot_budget=s, device="cuda")
    alive = states.alive.clone()
    alive[:, 7] = False  # kill_sparse(..., 7) in every universe
    states = states.replace(alive=alive, wb_valid=torch.zeros_like(states.wb_valid))
    plans = ens.stack_universes(FaultPlan.uniform(loss_percent=5.0, device="cuda")
                                for _ in range(b))

    def chunk_run(st):
        st, _ = ens.run_ensemble_sparse_ticks(params, st, plans, chunk, collect=False)
        st = ens.ensemble_writeback_free(params, st)
        int(st.view_T[0, 0, 0])
        return st

    states = chunk_run(states)
    per = []
    for _ in range(args.reps):
        t0 = time.perf_counter()
        states = chunk_run(states)
        per.append(time.perf_counter() - t0)

    def run(_):
        ens.run_ensemble_sparse_ticks(params, states, plans, chunk, collect=False)

    prof = _device_profile(run, chunk)
    print(json.dumps({
        "root": str(args.root),
        "ms_per_tick": sum(per) * 1e3 / (args.reps * chunk),
        "rate": b * n * args.reps * chunk / sum(per),
        "chunks": [c * 1e3 / chunk for c in per],
        "launches_per_tick": prof["device_launches_per_tick"],
        "busy_ms": prof["device_busy_ms_per_tick"],
        "idle": prof["device_idle_share"],
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
