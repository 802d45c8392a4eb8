"""``python -m scalecube_cluster_tpu_torch.experiments.sweep`` — seed×config
sweep as ONE batched ensemble per engine (port of scalecube_cluster_tpu/
experiments/sweep.py).

The loop-driven experiment scripts pay a host round trip per scenario
point. This command stacks the whole grid — every schedule seed × every
protocol-knob point (sim/knobs.py) — into one ensemble (sim/ensemble.py)
and steps all universes together on the card (``--cpu``: on the CPU), one
batched tick a tick; population statistics (convergence CDF,
verdict-latency percentiles, counter envelopes) reduce on the device and
the C1-C7 certifier replays every universe
(obs/ensemble.py::ensemble_report). One ``ensemble_population`` aggregate
row plus one ``ensemble_universe`` row per grid point land in the
schema-versioned export path (obs/export.py).

    python -m scalecube_cluster_tpu_torch.experiments.sweep --cpu --seeds 4
    python -m scalecube_cluster_tpu_torch.experiments.sweep --cpu --seeds 2 \
        --suspicion-mults 0.75,1.0,1.5 --fanout-caps none,2 --out sweep.jsonl

Exit status is the number of universes that failed certification.
"""

from __future__ import annotations

import argparse
import json
import sys

from scalecube_cluster_tpu_torch.experiments import cli_device
from scalecube_cluster_tpu_torch.obs.ensemble import ensemble_report
from scalecube_cluster_tpu_torch.obs.export import (
    append_jsonl,
    run_metadata,
    write_prometheus,
)
from scalecube_cluster_tpu_torch.sim.ensemble import (
    ensemble_sparse_convergence,
    init_ensemble_dense,
    init_ensemble_sparse,
    run_ensemble_sparse_ticks,
    run_ensemble_ticks,
    stack_universes,
)
from scalecube_cluster_tpu_torch.sim.knobs import make_knobs
from scalecube_cluster_tpu_torch.sim.sparse import SparseParams
from scalecube_cluster_tpu_torch.sim.state import seeds_mask
from scalecube_cluster_tpu_torch.testlib.chaos import (
    chaos_params,
    sample_schedule,
    trial_ticks,
)


def _parse_floats(text: str) -> tuple[float, ...]:
    return tuple(float(x) for x in text.split(",") if x)


def _parse_caps(text: str) -> tuple:
    caps = []
    for x in text.split(","):
        x = x.strip()
        if not x:
            continue
        caps.append(None if x.lower() in ("none", "full") else int(x))
    return tuple(caps)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, default=4, help="number of schedule seeds")
    ap.add_argument("--seed-start", type=int, default=0)
    ap.add_argument("--n", type=int, default=24, help="cluster size")
    ap.add_argument(
        "--engines", default="dense,sparse", help="comma list from {dense,sparse}"
    )
    ap.add_argument(
        "--suspicion-mults",
        default="1.0",
        help="comma list of suspicion-timeout multipliers (knob axis)",
    )
    ap.add_argument(
        "--fanout-caps",
        default="none",
        help="comma list of live-fanout caps; 'none' = full fan-out (knob axis)",
    )
    ap.add_argument(
        "--ticks",
        type=int,
        default=0,
        help="ticks per universe (0 = the chaos trial length: disturbance "
        "window + C7 heal bound)",
    )
    ap.add_argument("--out", default=None, help="append JSONL rows to FILE")
    ap.add_argument("--prom", default=None, help="write Prometheus text to FILE")
    ap.add_argument(
        "--cpu", action="store_true", help="run on the CPU instead of the card"
    )
    args = ap.parse_args(argv)
    device = cli_device(args.cpu)

    engines = tuple(e for e in args.engines.split(",") if e)
    seeds = list(range(args.seed_start, args.seed_start + args.seeds))
    mults = _parse_floats(args.suspicion_mults)
    caps = _parse_caps(args.fanout_caps)
    params = chaos_params(args.n)
    ticks = args.ticks or trial_ticks(params)

    # Seed-major grid: every schedule seed crossed with every knob point,
    # all stacked into one ensemble (B = seeds × mults × caps).
    points = [(s, m, c) for s in seeds for m in mults for c in caps]
    init_seeds = [s for s, _, _ in points]
    schedules = stack_universes(
        sample_schedule(s, args.n, device=device) for s, _, _ in points
    )
    # Identity knob points (the default) still thread as data — every
    # universe takes the knobbed tick; only the knob values change.
    knobs = stack_universes(
        make_knobs(params, suspicion_mult=m, fanout_cap=c, device=device)
        for _, m, c in points
    )

    meta = run_metadata(n=args.n, platform="cpu" if device == "cpu" else "gpu")
    all_rows: list[dict] = []
    failures = 0
    for engine in engines:
        if engine == "dense":
            states = init_ensemble_dense(
                args.n, init_seeds, user_gossip_slots=params.user_gossip_slots,
                device=device,
            )
            _, traces = run_ensemble_ticks(
                params,
                states,
                schedules,
                seeds_mask(args.n, [0], device=device),
                ticks,
                knobs=knobs,
            )
            report = ensemble_report(params, traces, meta=meta)
        elif engine == "sparse":
            sp = SparseParams(
                base=params, slot_budget=max(64, 4 * args.n), alloc_cap=16
            )
            states = init_ensemble_sparse(
                args.n,
                init_seeds,
                slot_budget=sp.slot_budget,
                user_gossip_slots=params.user_gossip_slots,
                device=device,
            )
            states, traces = run_ensemble_sparse_ticks(
                sp, states, schedules, ticks, knobs=knobs
            )
            conv = ensemble_sparse_convergence(states)
            report = ensemble_report(
                params, traces, final_convergence=conv, meta=meta
            )
        else:
            raise SystemExit(f"unknown engine {engine!r}")

        rows = report["rows"]
        rows[0]["engine"] = engine
        rows[0]["ticks"] = ticks
        for (s, m, c), row in zip(points, rows[1:]):
            row["engine"] = engine
            row["sweep_seed"] = s
            row["suspicion_mult"] = m
            row["fanout_cap"] = params.gossip_fanout if c is None else c
        all_rows.extend(rows)

        cert = report["certification"]
        bad = int((~cert["ok"]).sum()) if cert is not None else 0
        failures += bad
        agg = rows[0]
        print(
            f"{engine}: universes={agg['universes']} ticks={ticks} "
            f"frac_converged={agg.get('frac_converged', 'n/a')} "
            f"pass_rate={agg.get('pass_rate', 'n/a')} failures={bad}"
        )
        if cert is not None and bad:
            for b, violation in enumerate(cert["violations"]):
                if violation is not None:
                    s, m, c = points[b]
                    print(
                        f"FAIL engine={engine} seed={s} mult={m} cap={c} "
                        f":: {violation['error']}"
                    )
        sys.stdout.flush()

    if args.out:
        append_jsonl(args.out, all_rows)
    if args.prom:
        write_prometheus(args.prom, all_rows)
    print(
        json.dumps(
            {
                "engines": list(engines),
                "grid": {
                    "seeds": len(seeds),
                    "suspicion_mults": list(mults),
                    "fanout_caps": [
                        params.gossip_fanout if c is None else c for c in caps
                    ],
                },
                "universes_per_engine": len(points),
                "ticks": ticks,
                "failures": failures,
            }
        )
    )
    return failures


if __name__ == "__main__":
    sys.exit(main())
