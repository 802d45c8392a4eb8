"""``python -m scalecube_cluster_tpu_torch.experiments.chaos`` — seeded chaos soak
(port of scalecube_cluster_tpu/experiments/chaos.py).

Samples random fault schedules (testlib/chaos.py), runs each through the
engines on the card (``--cpu``: on the CPU), and certifies the SWIM
invariants (testlib/invariants.py). One line per trial; a violation
prints its ``CHAOS-REPRO`` stamp — paste the seed back into
``--seed-start``/``--seeds 1`` (or ``chaos_trial`` directly) to replay the
exact trajectory. Exit status is the number of violations.

    python -m scalecube_cluster_tpu_torch.experiments.chaos --cpu --seeds 25
    python -m scalecube_cluster_tpu_torch.experiments.chaos --n 64 --engines sparse
    python -m scalecube_cluster_tpu_torch.experiments.chaos --engines rapid
    python -m scalecube_cluster_tpu_torch.experiments.chaos --race --seeds 12

``--engines rapid`` soaks the Rapid consistent-membership engine
(sim/rapid.py) under the same schedule matrix, certified against C1-C7 AND
R1-R5 (``rapid_fb`` adds the classic-Paxos fallback plane and arms the R5
liveness raises). ``--race`` runs the SWIM-vs-Rapid comparison instead:
both engines on IDENTICAL seed/schedule matrices as one ensemble
call each (testlib/chaos.py::chaos_race), one side-by-side row per seed —
the Rapid side runs with the fallback attached, so each row also reports
``rapid_views_parked`` / ``rapid_fallback_commits`` (how often the classic
rounds had to rescue a split vote).

``--geo`` swaps the flat schedule sampler for the geo-distributed matrix
(testlib/chaos.py::geo_chaos_matrix): every trial draws a LinkWorld
timeline — a 2-zone split-brain, a 3-zone WAN brownout racing the probe
deadline, or an asymmetric one-way partition — and the SWIM engines are
additionally certified against the Z1-Z3 per-zone graceful-degradation
invariants. Geo CHAOS-REPRO digests hash the zone assignment and every
[Z, Z] matrix, so one line still pins the whole world.

``--grow`` runs the growth-under-chaos matrix instead
(testlib/chaos.py::grow_matrix): every trial is one elastic serve session
growing ``n//2`` live members to a full ``n * 2**tiers`` through
checkpoint-based geometry promotions, with wire joins racing kill/restart
churn and every promotion taken mid-brownout (a 2-zone LinkWorld latency
segment). Certified per inter-promotion segment (C1-C6 at that segment's
geometry) plus the admission conservation ledger and the elastic
live x live heal; the CHAOS-REPRO line carries the tier ladder
(``ladder=32->64->128``). ``--tiers`` sets the ladder depth.

``--out FILE`` appends each trial as schema-versioned JSONL (obs/export.py),
so soak results can be committed/diffed like the experiment grid's.
"""

from __future__ import annotations

import argparse
import json
import sys

from scalecube_cluster_tpu_torch.experiments import cli_device
from scalecube_cluster_tpu_torch.obs.export import (
    append_jsonl,
    make_row,
    run_metadata,
)
from scalecube_cluster_tpu_torch.testlib.chaos import (
    GEO_ENGINES,
    GROW_TIERS,
    chaos_race,
    chaos_soak,
    geo_chaos_matrix,
    grow_matrix,
)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, default=10, help="number of seeds")
    ap.add_argument("--seed-start", type=int, default=0)
    ap.add_argument("--n", type=int, default=24, help="cluster size")
    ap.add_argument(
        "--engines",
        default="dense,sparse",
        help="comma list from {dense,sparse,rapid,rapid_fb}",
    )
    ap.add_argument(
        "--race",
        action="store_true",
        help="SWIM-vs-Rapid race: both protocols over identical "
        "seed/schedule matrices, one paired row per seed",
    )
    ap.add_argument(
        "--geo",
        action="store_true",
        help="geo matrix: LinkWorld timelines (split2/brownout3/oneway) "
        "with Z1-Z3 zone certification on the SWIM engines",
    )
    ap.add_argument(
        "--grow",
        action="store_true",
        help="growth-under-chaos matrix: elastic serve sessions climbing "
        "the n_alloc doubling ladder under join/kill races with "
        "mid-brownout promotions (testlib/chaos.py::grow_matrix)",
    )
    ap.add_argument(
        "--tiers",
        type=int,
        default=None,
        help="promotions per grow trial (--grow only; default "
        "testlib.chaos.GROW_TIERS)",
    )
    ap.add_argument(
        "--swim-engine",
        default="sparse",
        choices=("dense", "sparse"),
        help="which SWIM engine races Rapid (--race only)",
    )
    ap.add_argument("--out", default=None, help="append JSONL rows to FILE")
    ap.add_argument(
        "--cpu", action="store_true", help="run on the CPU instead of the card"
    )
    ap.add_argument(
        "--no-ensemble",
        action="store_true",
        help="run trials as B host-driven loops instead of one batched "
        "ensemble call per engine (sim/ensemble.py); results are identical "
        "— this is the bisection/debug path",
    )
    args = ap.parse_args(argv)

    device = cli_device(args.cpu)
    platform = "cpu" if device == "cpu" else "gpu"

    engines = tuple(e for e in args.engines.split(",") if e)
    seeds = range(args.seed_start, args.seed_start + args.seeds)

    if args.race:
        rows = chaos_race(
            seeds, args.n, swim_engine=args.swim_engine, device=device
        )
        for r in rows:
            status = "ok" if r["ok"] else "FAIL"
            print(
                f"{status} seed={r['seed']} variant={r['variant']} "
                f"digest={r['digest']} | swim[{r['swim_engine']}] "
                f"susp={r['swim_suspicions']} dead={r['swim_verdicts_dead']} "
                f"| rapid vc={r['rapid_view_changes']} "
                f"views={r['rapid_max_view_id']} "
                f"parked={r['rapid_views_parked']} "
                f"fb_commits={r['rapid_fallback_commits']}"
            )
            if not r["ok"]:
                for side in ("swim", "rapid"):
                    if not r[side]["ok"]:
                        print(f"  {side}: {r[side]['reproducer']} :: "
                              f"{r[side]['error']}")
        failures = [r for r in rows if not r["ok"]]
        if args.out:
            meta = run_metadata(n=args.n, platform=platform)
            append_jsonl(
                args.out, [make_row("chaos_race", r, meta) for r in rows]
            )
        print(
            json.dumps(
                {"races": len(rows), "violations": len(failures)}
            )
        )
        return len(failures)

    if args.grow:
        tiers = args.tiers if args.tiers is not None else GROW_TIERS

        def emit_grow(r: dict) -> None:
            if r["ok"]:
                ladder = "->".join(str(x) for x in r["ladder"])
                print(
                    f"ok seed={r['seed']} ladder={ladder} "
                    f"digest={r['digest']} n_live={r['n_live']} "
                    f"joins={r['joins_placed']} "
                    f"promo_ms={r['promotion_wall_ms']} "
                    f"conv={r['final_convergence']:.3f}"
                )
            else:
                print(f"FAIL {r['reproducer']} :: {r['error']}")
            sys.stdout.flush()

        results = grow_matrix(
            seeds, args.n, tiers=tiers, on_result=emit_grow, device=device
        )
        failures = [r for r in results if not r["ok"]]
        if args.out:
            meta = run_metadata(n=args.n, platform=platform)
            append_jsonl(
                args.out, [make_row("chaos_grow", r, meta) for r in results]
            )
        print(
            json.dumps(
                {
                    "trials": len(results),
                    "violations": len(failures),
                    "reproducers": [r["reproducer"] for r in failures],
                }
            )
        )
        return len(failures)

    if args.geo:
        # --geo defaults to the full geo engine set (the explicit flag
        # still wins: --engines dense --geo runs a dense-only matrix).
        geo_engines = GEO_ENGINES if args.engines == "dense,sparse" else engines

        def emit_geo(r: dict) -> None:
            if r["ok"]:
                print(
                    f"ok seed={r['seed']} engine={r['engine']} "
                    f"variant={r['variant']} digest={r['digest']} "
                    f"conv={r['final_convergence']:.3f}"
                )
            else:
                print(
                    f"FAIL variant={r['variant']} {r['reproducer']} :: "
                    f"{r['error']}"
                )
            sys.stdout.flush()

        results = geo_chaos_matrix(
            seeds, args.n, engines=geo_engines, on_result=emit_geo,
            device=device,
        )
        failures = [r for r in results if not r["ok"]]
        if args.out:
            meta = run_metadata(n=args.n, platform=platform)
            append_jsonl(
                args.out, [make_row("chaos_geo", r, meta) for r in results]
            )
        print(
            json.dumps(
                {
                    "trials": len(results),
                    "violations": len(failures),
                    "reproducers": [r["reproducer"] for r in failures],
                }
            )
        )
        return len(failures)

    def emit(r: dict) -> None:
        if r["ok"]:
            print(
                f"ok seed={r['seed']} engine={r['engine']} "
                f"digest={r['digest']} conv={r['final_convergence']:.3f} "
                f"blocked={r['fault_blocked']} lost={r['fault_lost']} "
                f"kills={r['kills']} restarts={r['restarts']}"
            )
        else:
            print(f"FAIL {r['reproducer']} :: {r['error']}")
        sys.stdout.flush()

    results = chaos_soak(
        seeds,
        args.n,
        engines=engines,
        on_result=emit,
        ensemble=not args.no_ensemble,
        device=device,
    )
    failures = [r for r in results if not r["ok"]]
    if args.out:
        meta = run_metadata(platform=platform)
        append_jsonl(args.out, [make_row("chaos", r, meta) for r in results])
    print(
        json.dumps(
            {
                "trials": len(results),
                "violations": len(failures),
                "reproducers": [r["reproducer"] for r in failures],
            }
        )
    )
    return len(failures)


if __name__ == "__main__":
    sys.exit(main())
