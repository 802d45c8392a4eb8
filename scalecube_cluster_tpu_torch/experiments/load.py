"""``python -m scalecube_cluster_tpu_torch.experiments.load`` — wire-rate load
soak (port of scalecube_cluster_tpu/experiments/load.py).

Drives the seeded multi-producer load harness (serve/load.py) against one
live serving session on the card (``--cpu``: on the CPU): N concurrent loopback-TCP producers, honest and
adversarial mixed (malformed JSON, unknown kinds, out-of-range nodes/slots,
oversized frames, garbage bytes, slow-loris half-frames), with bursts and
optional connection churn. Prints the audit verdicts and throughput; exit
status is 0 only when the conservation invariant held exactly, rejections
reconciled, the queue stayed bounded, and no producer crashed.

    python -m scalecube_cluster_tpu_torch.experiments.load --cpu
    python -m scalecube_cluster_tpu_torch.experiments.load --producers 64 --events 2000
    python -m scalecube_cluster_tpu_torch.experiments.load --policy shed-oldest
    python -m scalecube_cluster_tpu_torch.experiments.load --out artifacts/load.jsonl

``--out FILE`` appends the schema-versioned ``kind="load"`` row (plus the
session's ``kind="serve"`` summary and per-launch rows) as JSONL.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys

from scalecube_cluster_tpu_torch.experiments import cli_device
from scalecube_cluster_tpu_torch.serve.load import run_load


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--producers", type=int, default=32)
    ap.add_argument(
        "--adversarial",
        type=int,
        default=10,
        help="how many producers run hostile profiles (>=5 covers all of "
        "reject/malformed/oversized/garbage/slowloris)",
    )
    ap.add_argument("--events", type=int, default=400, help="events per producer")
    ap.add_argument("--n", type=int, default=32, help="cluster size")
    ap.add_argument("--batch-ticks", type=int, default=8)
    ap.add_argument("--capacity", type=int, default=64, help="events per tick row")
    ap.add_argument("--max-pending", type=int, default=4096)
    ap.add_argument(
        "--policy", default="defer", choices=("defer", "shed-oldest"),
        help="queue-full trade: lossless backpressure vs bounded latency",
    )
    ap.add_argument("--burst", type=int, default=32)
    ap.add_argument(
        "--churn", type=int, default=0, metavar="K",
        help="producers disconnect/redial every K events (0 = no churn)",
    )
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help="append JSONL rows to FILE")
    ap.add_argument(
        "--cpu", action="store_true", help="run on the CPU instead of the card"
    )
    args = ap.parse_args(argv)
    device = cli_device(args.cpu)

    res = asyncio.run(
        run_load(
            n=args.n,
            producers=args.producers,
            adversarial=args.adversarial,
            events_per_producer=args.events,
            batch_ticks=args.batch_ticks,
            capacity=args.capacity,
            max_pending=args.max_pending,
            overflow_policy=args.policy,
            burst=args.burst,
            churn_every=args.churn,
            seed=args.seed,
            export_path=args.out,
            device=device,
        )
    )
    row = res["row"]
    print(
        f"load: {row['producers']} producers ({row['adversarial']} hostile) "
        f"pushed={row['pushed']} served={row['served']} shed={row['shed']} "
        f"rejected={row['rejected']} pauses={row['backpressure_pauses']} "
        f"peak={row['peak_pending']}/{row['max_pending']} "
        f"({row['overflow_policy']}) "
        f"{row['events_per_sec']:.0f} ev/s p95={row['latency_ms_p95']:.2f} ms"
    )
    verdicts = {
        "conservation_ok": res["conservation_ok"],
        "rejected_ok": res["rejected_ok"],
        "bounded_ok": res["bounded_ok"],
        "producer_errors": len(res["errors"]),
    }
    print(json.dumps(verdicts))
    ok = (
        res["conservation_ok"]
        and res["rejected_ok"]
        and res["bounded_ok"]
        and not res["errors"]
    )
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
