"""Seeded chaos soak: sample random fault schedules, run them through the
engines, certify the SWIM invariants (port of scalecube_cluster_tpu/
testlib/chaos.py; the certifiers are testlib/invariants.py).

Every trial is a pure function of ``(seed, n, engine)``: the schedule is
drawn from ``np.random.default_rng(seed)`` and every engine is
deterministic, so a violation reproduces from its one-line stamp:

    CHAOS-REPRO seed=17 n=24 engine=sparse ticks=239 digest=3f1c0a9d2b41

One seed gives the same schedule, digest and stamp here as in the
reference. All sampled schedules share one shape — exactly
``CHAOS_SEGMENTS`` segments and ``CHAOS_KILLS`` kill/restart pairs over
dense ``[n, n]`` fault matrices — so a whole seed matrix steps as one
batch in the ensemble runners (sim/ensemble.py), every universe at the
same tick.

Timeline per trial: a clean warm-up, one disturbance window (uniform loss,
a minority partition, or a flapping cross-partition link set, plus the
kill/restart pairs), then a clean tail long enough for the C7 heal bound —
so every trial exercises detection AND recovery.

Every function that builds tensors takes ``device`` (default ``"cuda"``);
the runners follow the device of the schedule they are given.
"""

from __future__ import annotations

import hashlib

import numpy as np

from scalecube_cluster_tpu_torch.sim.ensemble import (
    ensemble_sparse_convergence,
    init_ensemble_dense,
    init_ensemble_sparse,
    run_ensemble_ticks,
    sparse_convergence_device,
    stack_universes,
)
from scalecube_cluster_tpu_torch.sim.faults import FaultPlan
from scalecube_cluster_tpu_torch.sim.params import SimParams
from scalecube_cluster_tpu_torch.sim.rapid import (
    RapidParams,
    init_ensemble_rapid,
    init_rapid_full_view,
    run_ensemble_rapid_ticks,
    run_rapid_ticks,
)
from scalecube_cluster_tpu_torch.sim.run import run_ticks
from scalecube_cluster_tpu_torch.sim.schedule import FaultSchedule, ScheduleBuilder
from scalecube_cluster_tpu_torch.sim.sparse import (
    SparseParams,
    effective_view,
    init_sparse_full_view,
)
from scalecube_cluster_tpu_torch.sim.state import init_full_view, seeds_mask
from scalecube_cluster_tpu_torch.sim.topology import LinkWorld
from scalecube_cluster_tpu_torch.testlib.donation import (
    run_ensemble_sparse_ticks_nodonate,
    run_sparse_ticks_nodonate,
)
from scalecube_cluster_tpu_torch.testlib.invariants import (
    RAPID_REQUIRED_KEYS,
    REQUIRED_KEYS,
    InvariantViolation,
    certify_heal,
    certify_population,
    certify_rapid_population,
    certify_rapid_traces,
    certify_traces,
    certify_zone_traces,
    heal_bound,
    zone_heal_bound,
)

#: Fixed schedule shape — every seed steps in one batch.
CHAOS_SEGMENTS = 3
CHAOS_KILLS = 2

#: Disturbance-window placement (global ticks). The clean tail after
#: ``DISTURB_END_MAX`` is sized by heal_bound, so total tick count is a
#: function of params only (shared across seeds).
DISTURB_START_LO, DISTURB_START_HI = 5, 15
DISTURB_LEN_LO, DISTURB_LEN_HI = 40, 60
DISTURB_END_MAX = DISTURB_START_HI + DISTURB_LEN_HI

ENGINES = ("dense", "sparse")
#: All engines chaos understands — the SWIM pair plus the Rapid
#: consistent-membership engine (sim/rapid.py) in both trims: ``rapid`` is
#: the bare fast path, ``rapid_fb`` attaches the classic-Paxos fallback +
#: join protocol (fallback=True) and is additionally certified against the
#: R5 liveness oracle (every detected cut must commit). All Rapid trials
#: run the SAME sampled schedules and are certified against C1-C7 AND R1-R4.
ALL_ENGINES = ("dense", "sparse", "rapid", "rapid_fb")
#: Scenario-variant names, indexed by the draw in :func:`sample_schedule`.
VARIANTS = ("loss", "partition", "flap")


def rapid_chaos_params(n: int) -> RapidParams:
    """Rapid constants matched to :func:`chaos_params`' cadence: the same
    2-tick FD period, k-ring width clipped for tiny clusters, and the
    default 4/6 watermarks — so a flap that stays up 4 of every 8 ticks
    (the chaos flap variant) can never string L consecutive misses."""
    k = min(8, n - 1)
    return RapidParams(
        n=n,
        k=k,
        low_watermark=4,
        high_watermark=min(6, k),
        fd_period_ticks=2,
        sync_period_ticks=5,
    )


def chaos_params(n: int) -> SimParams:
    """Fast protocol constants for chaos trials (tests/test_sim.py's small
    cadence): short FD/SYNC periods keep the heal bound — and therefore the
    trial length — in the low hundreds of ticks."""
    return SimParams(
        n=n,
        gossip_fanout=3,
        periods_to_spread=8,
        periods_to_sweep=18,
        fd_period_ticks=2,
        sync_period_ticks=10,
        suspicion_ticks=30,
        ping_req_members=2,
        user_gossip_slots=2,
    )


def trial_ticks(params: SimParams) -> int:
    """Trial length: worst-case disturbance end + the C7 heal bound + a
    cadence cushion. Static given params, so all seeds share it."""
    return DISTURB_END_MAX + heal_bound(params) + 10


def sample_schedule(seed: int, n: int, with_meta: bool = False, device="cuda"):
    """Draw one chaos schedule from ``seed``: clean warm-up, one disturbance
    segment (loss / partition / flap, uniformly chosen), kill+restart pairs
    inside the window, then clean through the end of the run.

    ``with_meta=True`` additionally returns a dict naming the drawn scenario
    (``variant``/``disturb_start``/``disturb_end``) — the race harness keys
    its per-scenario comparison on it."""
    rng = np.random.default_rng(seed)
    d0 = int(rng.integers(DISTURB_START_LO, DISTURB_START_HI + 1))
    d1 = d0 + int(rng.integers(DISTURB_LEN_LO, DISTURB_LEN_HI + 1))

    # Minority group for partition/flap variants (and the kill pool's
    # complement, so a partitioned minority never loses its restarts).
    m = max(1, n // 4)
    minority = np.arange(m)
    majority = np.arange(m, n)
    clean = FaultPlan.clean(n, device=device)
    variant = int(rng.integers(0, 3))
    flap_kw: dict = {}
    if variant == 0:
        disturb = clean.with_loss(float(rng.uniform(5.0, 30.0)))
    elif variant == 1:
        disturb = clean.partition(minority, majority)
    else:
        # Square-wave flap across the minority/majority cut: blocked half of
        # every 8-tick window — links heal and fail repeatedly.
        cross = np.zeros((n, n), bool)
        cross[minority[:, None], majority[None, :]] = True
        cross[majority[:, None], minority[None, :]] = True
        disturb = clean
        flap_kw = {"flap_mask": cross, "flap_period": 8, "flap_on": 4}

    b = (
        ScheduleBuilder(n)
        .add_segment(0, clean)
        .add_segment(d0, disturb, **flap_kw)
        .add_segment(d1, clean)
    )
    # Kill majority-side nodes early in the window, restart each before the
    # window closes — the heal tail then certifies full reintegration at
    # the bumped epoch. Restarts/tick stay far under the sparse engine's
    # alloc_cap, so the tick's announce never loses the slot-grant race.
    victims = rng.choice(majority, size=CHAOS_KILLS, replace=False)
    for i, node in enumerate(victims):
        k_tick = d0 + 1 + 2 * i
        r_tick = int(rng.integers(k_tick + 5, d1))
        b.kill(k_tick, int(node)).restart(r_tick, int(node))
    schedule = b.build()
    if with_meta:
        return schedule, {
            "variant": VARIANTS[variant],
            "disturb_start": d0,
            "disturb_end": d1,
        }
    return schedule


def sparse_convergence(state) -> float:
    """The dense engine's convergence measure (sim/tick.py metrics) computed
    on a sparse state's materialized view — O(n²), small-n trials only.
    Host-float wrapper of sim/ensemble.py::sparse_convergence_device (the
    formula lives there so the batched population form shares it bit-for-
    bit)."""
    return float(sparse_convergence_device(state))


def _host(traces: dict, keys=None) -> dict:
    """Trace tensors (``keys``, default all) read back as numpy arrays."""
    return {k: traces[k].cpu().numpy() for k in (traces if keys is None else keys)}


def _sparse_params(params: SimParams, n_top: int) -> SparseParams:
    """The sparse engine's constants for chaos trials (the XLA chain)."""
    return SparseParams(base=params, slot_budget=max(64, 4 * n_top), alloc_cap=16)


def run_scheduled(
    engine: str, params: SimParams, schedule: FaultSchedule, n_ticks: int,
    seed: int = 0
):
    """Run ``schedule`` for ``n_ticks`` on one engine from the standard
    full-view start, on the schedule's device. Returns ``(final_state,
    traces, final_convergence)`` with the traces as numpy arrays."""
    n = params.n
    device = schedule.starts.device
    if engine == "dense":
        state = init_full_view(n, params.user_gossip_slots, seed=seed, device=device)
        state, traces = run_ticks(
            params, state, schedule, seeds_mask(n, [0], device=device), n_ticks
        )
        traces = _host(traces)
        return state, traces, float(traces["convergence"][-1])
    if engine == "sparse":
        sp = _sparse_params(params, n)
        state = init_sparse_full_view(
            n,
            slot_budget=sp.slot_budget,
            seed=seed,
            user_gossip_slots=params.user_gossip_slots,
            device=device,
        )
        state, traces = run_sparse_ticks_nodonate(sp, state, schedule, n_ticks)
        return state, _host(traces), sparse_convergence(state)
    if engine in ("rapid", "rapid_fb"):
        rp = rapid_chaos_params(n)
        state = init_rapid_full_view(
            rp, seed=seed, fallback=engine == "rapid_fb", device=device
        )
        state, traces = run_rapid_ticks(rp, state, schedule, n_ticks)
        traces = _host(traces)
        return state, traces, float(traces["convergence"][-1])
    raise ValueError(
        f"unknown engine {engine!r}; expected one of {ALL_ENGINES}"
    )


def reproducer_line(seed: int, n: int, engine: str, ticks: int, digest: str) -> str:
    """The one-line stamp that fully determines a trial."""
    return (
        f"CHAOS-REPRO seed={seed} n={n} engine={engine} "
        f"ticks={ticks} digest={digest}"
    )


def chaos_trial(seed: int, n: int, engine: str, device="cuda") -> dict:
    """One seeded trial: sample, run, certify C1-C7. Never raises — a
    violation comes back as ``ok=False`` with the reproducer line."""
    params = chaos_params(n)
    schedule = sample_schedule(seed, n, device=device)
    ticks = trial_ticks(params)
    repro = reproducer_line(seed, n, engine, ticks, schedule.digest())
    result = {
        "seed": seed,
        "n": n,
        "engine": engine,
        "ticks": ticks,
        "digest": schedule.digest(),
        "reproducer": repro,
    }
    try:
        _, traces, conv = run_scheduled(engine, params, schedule, ticks)
        summary = certify_traces(params, traces)
        if engine in ("rapid", "rapid_fb"):
            # The consistency plane gets its own oracle on top of C1-C7;
            # the fallback trim additionally arms the R5 liveness raises.
            summary = {
                **summary,
                **certify_rapid_traces(
                    rapid_chaos_params(n), traces,
                    fallback=engine == "rapid_fb",
                ),
            }
        certify_heal(params, summary, conv)
    except InvariantViolation as e:
        result.update(ok=False, violation=e.invariant, error=str(e))
        return result
    result.update(ok=True, final_convergence=conv, **summary)
    return result


def chaos_ensemble(seeds, n: int, engine: str, device="cuda") -> list[dict]:
    """The whole seed matrix of one engine as ONE ensemble run
    (sim/ensemble.py): B sampled schedules stack into one schedule (their
    fixed shape is the point), B identical seed-0 start states step
    together, one batched tick a tick, and the batched certifier
    (testlib/invariants.py::certify_population) replays every universe.

    Returns per-seed result dicts IDENTICAL to :func:`chaos_trial`'s —
    universe b is bit-equal to the loop trial and so are its certifier
    summaries (tests/test_torch_chaos.py holds both).
    """
    params = chaos_params(n)
    ticks = trial_ticks(params)
    seeds = [int(s) for s in seeds]
    schedules = [sample_schedule(s, n, device=device) for s in seeds]
    plans = stack_universes(schedules)
    b_count = len(seeds)
    if engine == "dense":
        states = init_ensemble_dense(
            n, [0] * b_count, user_gossip_slots=params.user_gossip_slots,
            device=device,
        )
        _, traces = run_ensemble_ticks(
            params, states, plans, seeds_mask(n, [0], device=device), ticks
        )
        host = _host(traces, (*REQUIRED_KEYS, "convergence"))
        conv = host.pop("convergence")[:, -1]
    elif engine == "sparse":
        sp = _sparse_params(params, n)
        states = init_ensemble_sparse(
            n,
            [0] * b_count,
            slot_budget=sp.slot_budget,
            user_gossip_slots=params.user_gossip_slots,
            device=device,
        )
        states, traces = run_ensemble_sparse_ticks_nodonate(
            sp, states, plans, ticks
        )
        host = _host(traces, REQUIRED_KEYS)
        conv = ensemble_sparse_convergence(states).cpu().numpy()
    elif engine in ("rapid", "rapid_fb"):
        rp = rapid_chaos_params(n)
        states = init_ensemble_rapid(
            rp, [0] * b_count, fallback=engine == "rapid_fb", device=device
        )
        _, traces = run_ensemble_rapid_ticks(rp, states, plans, ticks)
        keys = dict.fromkeys(
            (*REQUIRED_KEYS, *RAPID_REQUIRED_KEYS, "convergence")
        )
        if engine == "rapid_fb":
            # The fallback trim's extra gauges feed the R5 oracle and the
            # race table's parked/committed columns.
            keys.update(dict.fromkeys(
                ("joins_fired", "fallback_rounds", "fallback_commits",
                 "join_requests", "join_confirms")
            ))
        host = _host(traces, keys)
        conv = host.pop("convergence")[:, -1]
    else:
        raise ValueError(
            f"unknown engine {engine!r}; expected one of {ALL_ENGINES}"
        )

    cert = certify_population(params, host, final_convergence=conv)
    if engine in ("rapid", "rapid_fb"):
        # Merge the R1-R5 verdicts: a universe passes only if BOTH oracles
        # pass; a SWIM-side violation (more fundamental accounting) wins
        # the report when both fire.
        rcert = certify_rapid_population(
            rapid_chaos_params(n), host, fallback=engine == "rapid_fb"
        )
        for b in range(b_count):
            if cert["ok"][b] and not rcert["ok"][b]:
                cert["ok"][b] = False
                cert["violations"][b] = rcert["violations"][b]
                cert["summaries"][b] = None
            elif cert["ok"][b]:
                cert["summaries"][b] = {
                    **cert["summaries"][b],
                    **rcert["summaries"][b],
                }
    results = []
    for b, seed in enumerate(seeds):
        digest = schedules[b].digest()
        result = {
            "seed": seed,
            "n": n,
            "engine": engine,
            "ticks": ticks,
            "digest": digest,
            "reproducer": reproducer_line(seed, n, engine, ticks, digest),
        }
        if cert["ok"][b]:
            result.update(
                ok=True,
                final_convergence=float(conv[b]),
                **cert["summaries"][b],
            )
        else:
            violation = cert["violations"][b]
            result.update(
                ok=False,
                violation=violation["invariant"],
                error=violation["error"],
            )
        results.append(result)
    return results


def chaos_race(seeds, n: int, swim_engine: str = "sparse", device="cuda") -> list[dict]:
    """SWIM vs Rapid on IDENTICAL seed/schedule matrices. Both engines run
    as one :func:`chaos_ensemble` call over the same sampled schedules
    (same seeds, same digests, same trial length), so every row pairs a
    SWIM trial with the Rapid trial of the *same* timeline,
    bit-reproducible from the shared CHAOS-REPRO digest.

    Each paired row reports SWIM's eventually-consistent plane
    (``suspicions_raised`` / ``verdicts_dead``) next to Rapid's consistent
    plane (``view_changes`` / ``alarms_raised``), plus the drawn scenario
    variant. On flap scenarios Rapid's L-watermark must yield ZERO
    flap-induced view changes (R4) — any view change in a Rapid row comes
    from the scripted kill/restart pairs, never from the square-wave link.

    The Rapid side runs the ``rapid_fb`` trim (classic fallback attached),
    so each row also carries ``rapid_views_parked`` (R5's count — must be
    0 for an ok row) and ``rapid_fallback_commits`` (view changes that
    needed the classic path rather than the fast quorum)."""
    seeds = [int(s) for s in seeds]
    swim = chaos_ensemble(seeds, n, swim_engine, device=device)
    rapid = chaos_ensemble(seeds, n, "rapid_fb", device=device)
    rows = []
    for s_row, r_row, seed in zip(swim, rapid, seeds):
        assert s_row["digest"] == r_row["digest"], "race rows must pair"
        _, meta = sample_schedule(seed, n, with_meta=True, device=device)
        rows.append(
            {
                "seed": seed,
                "n": n,
                "digest": s_row["digest"],
                "ticks": s_row["ticks"],
                "variant": meta["variant"],
                "ok": bool(s_row["ok"] and r_row["ok"]),
                "swim_engine": swim_engine,
                "swim_ok": s_row["ok"],
                "swim_suspicions": s_row.get("suspicions_raised"),
                "swim_verdicts_dead": s_row.get("verdicts_dead"),
                "swim_convergence": s_row.get("final_convergence"),
                "rapid_ok": r_row["ok"],
                "rapid_view_changes": r_row.get("view_changes"),
                "rapid_alarms_raised": r_row.get("alarms_raised"),
                "rapid_max_view_id": r_row.get("max_view_id"),
                "rapid_convergence": r_row.get("final_convergence"),
                "rapid_views_parked": r_row.get("views_parked"),
                "rapid_fallback_commits": r_row.get("fallback_commits"),
                "swim": s_row,
                "rapid": r_row,
            }
        )
    return rows


def chaos_soak(
    seeds, n: int, engines=ENGINES, on_result=None, ensemble: bool = False,
    device="cuda",
) -> list[dict]:
    """Run the seed x engine matrix; returns all trial results (violations
    included — callers assert). ``on_result`` (optional callable) sees each
    result as it lands, for streaming CLI output.

    ``ensemble=True`` routes each engine's whole seed matrix through ONE
    :func:`chaos_ensemble` call instead of B host-driven trials — same
    results in the same seed-major order (``on_result`` then fires after
    the batch lands rather than per trial)."""
    results = []
    if ensemble:
        seeds = [int(s) for s in seeds]
        per_engine = {e: chaos_ensemble(seeds, n, e, device=device) for e in engines}
        for i in range(len(seeds)):
            for engine in engines:
                r = per_engine[engine][i]
                results.append(r)
                if on_result is not None:
                    on_result(r)
        return results
    for seed in seeds:
        for engine in engines:
            r = chaos_trial(int(seed), n, engine, device=device)
            results.append(r)
            if on_result is not None:
                on_result(r)
    return results


# ------------------------------------------------------------------ geo
# Geo-distributed chaos: the same seeded-trial contract over LinkWorld
# timelines (sim/topology.py). Every geo trial is still a pure function of
# ``(seed, n, engine)`` and reproduces from the same CHAOS-REPRO line —
# the schedule digest hashes the zone assignment and the [Z, Z] matrices,
# so a geo one-liner pins the whole world, not just the flat plan.

#: Geo scenario variants, indexed by the draw in :func:`sample_geo_schedule`:
#: ``split2``    — symmetric 2-zone split-brain (both cross-zone directions
#:                 blocked); the minority datacenter goes dark.
#: ``brownout3`` — 3-zone WAN brownout: pure latency inflation on every
#:                 cross-zone pair, drawn to race the 500 ms probe deadline
#:                 (no message is ever dropped — suspicions must refute).
#: ``oneway``    — asymmetric partition: majority->minority direction
#:                 blocked, minority->majority stays up. Pings cross, acks
#:                 die — both sides suspect, but ``fault_blocked`` counts
#:                 only one direction.
GEO_VARIANTS = ("split2", "brownout3", "oneway")
#: Engines in the default geo matrix: zone gauges certify Z1-Z3 on the two
#: SWIM engines; the Rapid fallback trim is certified R1-R5 (its FD draws
#: no round-trip deadline, so geo coverage comes from the block variants).
GEO_ENGINES = ("dense", "sparse", "rapid_fb")
#: Cross-zone brownout latency band (ms): drawn against the 500 ms probe
#: deadline so round trips miss on the Erlang tail without any loss.
GEO_BROWNOUT_LO_MS, GEO_BROWNOUT_HI_MS = 350.0, 450.0


def geo_minority(n: int) -> int:
    """Minority-zone size for the split/oneway variants (the first
    ``m`` members form zone 1 — same pool the flat sampler partitions)."""
    return max(2, n // 4)


def geo_world(n: int, variant: str, rng, device="cuda") -> LinkWorld:
    """The LinkWorld of one geo variant (clean matrices disturbed per the
    variant's draw)."""
    if variant == "brownout3":
        w = LinkWorld.even_zones(n, 3, device=device)
        lat = float(rng.uniform(GEO_BROWNOUT_LO_MS, GEO_BROWNOUT_HI_MS))
        for za in range(3):
            for zb in range(za + 1, 3):
                w = w.with_zone_latency(za, zb, lat)
        return w
    m = geo_minority(n)
    zone = np.zeros(n, np.int32)
    zone[:m] = 1
    w = LinkWorld.from_zones(zone, n_zones=2, device=device)
    if variant == "split2":
        return w.block_zones(0, 1, symmetric=True)
    if variant == "oneway":
        # Majority -> minority blocked: the minority still reaches out,
        # nothing comes back.
        return w.block_zones(0, 1, symmetric=False)
    raise ValueError(f"unknown geo variant {variant!r}")


def geo_trial_ticks(params: SimParams) -> int:
    """Geo trial length: worst-case disturbance end + the Z3 zone-aware
    heal bound at the matrix's max zone count (3) + a cadence cushion —
    static given params, shared by every geo seed and engine."""
    return DISTURB_END_MAX + zone_heal_bound(params, 3) + 10


def sample_geo_schedule(seed: int, n: int, with_meta: bool = False, device="cuda"):
    """Draw one geo chaos schedule from ``seed``: clean warm-up, one
    LinkWorld disturbance window (split2 / brownout3 / oneway, uniformly
    chosen), the standard kill+restart pairs on majority-zone members, then
    clean through the end. Same shape as :func:`sample_schedule`
    (3 segments, ``CHAOS_KILLS`` event pairs).

    ``with_meta=True`` also returns the certification windows: ``variant``,
    ``disturb_start``/``disturb_end``, plus the Z1/Z2 kwargs for
    :func:`~scalecube_cluster_tpu_torch.testlib.invariants.certify_zone_traces`
    (``brownout``/``split`` window, ``n_zones``)."""
    rng = np.random.default_rng(seed)
    d0 = int(rng.integers(DISTURB_START_LO, DISTURB_START_HI + 1))
    d1 = d0 + int(rng.integers(DISTURB_LEN_LO, DISTURB_LEN_HI + 1))
    variant = GEO_VARIANTS[int(rng.integers(0, len(GEO_VARIANTS)))]
    world = geo_world(n, variant, rng, device=device)
    m = geo_minority(n)
    clean = FaultPlan.clean(n, device=device)

    b = (
        ScheduleBuilder(n)
        .add_segment(0, clean)
        .add_segment(d0, clean, link_world=world)
        .add_segment(d1, clean)
    )
    # Same churn recipe as the flat sampler: kill majority-zone members
    # early in the window, restart each before it closes (the minority
    # zone never loses a member, so Z2's clean-zone ledger stays sharp).
    majority = np.arange(m, n)
    victims = rng.choice(majority, size=CHAOS_KILLS, replace=False)
    for i, node in enumerate(victims):
        k_tick = d0 + 1 + 2 * i
        r_tick = int(rng.integers(k_tick + 5, d1))
        b.kill(k_tick, int(node)).restart(r_tick, int(node))
    schedule = b.build()
    if with_meta:
        # Certification windows in TRACE-ROW coordinates: global tick t is
        # trace row t-1 (the first tick run is t=1), so the disturbed
        # segment [d0, d1) covers rows [d0-1, d1-1) and the first heal row
        # is d1-1. Off by one and Z2 would see the post-heal tombstone
        # flood (majority DEAD records reaching the minority on the heal
        # tick, refuted ticks later) as a clean-zone verdict.
        window = (d0 - 1, d1 - 1)
        # Z2 scope: a zone only counts as clean if it cannot HEAR the
        # disturbance. Under split2 neither side hears the other, so both
        # zones certify. Under oneway the minority->majority direction
        # stays open: the stranded minority sweeps the unreachable
        # majority to DEAD and gossips those tombstones INTO the majority,
        # which transiently accepts them until the subjects refute —
        # protocol-correct traffic, not a majority-zone verdict. Only the
        # shielded minority (zone 1) certifies Z2 there.
        meta = {
            "variant": variant,
            "disturb_start": d0,
            "disturb_end": d1,
            "n_zones": world.n_zones,
            "minority": m if variant != "brownout3" else None,
            "brownout": window if variant == "brownout3" else None,
            "split": window if variant != "brownout3" else None,
            "clean_zones": [1] if variant == "oneway" else None,
            "heal_row": d1 - 1,
        }
        return schedule, meta
    return schedule


def geo_trial(seed: int, n: int, engine: str, device="cuda") -> dict:
    """One seeded geo trial: sample a LinkWorld timeline, run, certify.
    SWIM engines (``dense``/``sparse``) are certified C1-C7 **and** Z1-Z3
    from their per-zone gauges; Rapid engines add R1-R4 (R5 too for the
    fallback trim) on top of C1-C7. Never raises — violations come back as
    ``ok=False`` rows with the CHAOS-REPRO line, exactly like
    :func:`chaos_trial`."""
    params = chaos_params(n)
    schedule, meta = sample_geo_schedule(seed, n, with_meta=True, device=device)
    ticks = geo_trial_ticks(params)
    repro = reproducer_line(seed, n, engine, ticks, schedule.digest())
    result = {
        "seed": seed,
        "n": n,
        "engine": engine,
        "ticks": ticks,
        "digest": schedule.digest(),
        "reproducer": repro,
        "variant": meta["variant"],
    }
    try:
        _, traces, conv = run_scheduled(engine, params, schedule, ticks)
        summary = certify_traces(params, traces)
        if engine in ("rapid", "rapid_fb"):
            summary = {
                **summary,
                **certify_rapid_traces(
                    rapid_chaos_params(n), traces,
                    fallback=engine == "rapid_fb",
                ),
            }
        else:
            summary = {
                **summary,
                **certify_zone_traces(
                    params,
                    traces,
                    brownout=meta["brownout"],
                    split=meta["split"],
                    clean_zones=meta["clean_zones"],
                    heal_start=meta["heal_row"],
                    context=f"geo {meta['variant']} seed={seed}",
                ),
            }
        certify_heal(params, summary, conv)
    except InvariantViolation as e:
        result.update(ok=False, violation=e.invariant, error=str(e))
        return result
    result.update(ok=True, final_convergence=conv, **summary)
    return result


def geo_chaos_matrix(
    seeds, n: int, engines=GEO_ENGINES, on_result=None, device="cuda"
) -> list[dict]:
    """The seed x engine geo matrix (host-driven trials). Returns every
    row, violations included — callers assert."""
    results = []
    for seed in seeds:
        for engine in engines:
            r = geo_trial(int(seed), n, engine, device=device)
            results.append(r)
            if on_result is not None:
                on_result(r)
    return results


# ----------------------------------------------------------------- grow
# Growth-under-chaos: elastic membership (sim/sparse.py capacity tiers +
# serve/bridge.py admission/promotion) soaked under the chaos disciplines —
# wire joins racing scripted kill/restart churn, and every geometry
# promotion taken MID-BROWNOUT (a 2-zone LinkWorld latency segment drawn
# from the geo band). A grow trial is still a pure function of
# ``(seed, n, tiers)``; its CHAOS-REPRO line carries the tier ladder.

#: Capacity-doubling promotions per grow trial (the default ladder depth).
GROW_TIERS = 2


def grow_ladder(n_alloc0: int, tiers: int) -> list[int]:
    """The n_alloc doubling ladder a grow trial climbs."""
    return [n_alloc0 * (2**i) for i in range(tiers + 1)]


def grow_reproducer(seed: int, n: int, tiers: int, digest: str) -> str:
    """The one-line stamp of a grow trial — the ladder replaces the engine
    field (there is only one elastic engine) so a failure names every
    geometry it crossed."""
    ladder = "->".join(str(x) for x in grow_ladder(n, tiers))
    return (
        f"CHAOS-REPRO seed={seed} n={n} engine=grow "
        f"ladder={ladder} digest={digest}"
    )


def grow_trial(seed: int, n: int, tiers: int = GROW_TIERS, device="cuda") -> dict:
    """One seeded growth-under-chaos trial: a serve session starts with
    ``n//2`` live members in an ``n``-row allocation and grows to a full
    ``n * 2**tiers`` through ``tiers`` checkpoint-based promotions, while

    - wire-form joins (node omitted — bridge admission assigns capacity
      rows) race seeded kill/restart pairs on the founding cohort, and
    - a 2-zone WAN brownout (latency drawn from the geo band, no loss)
      covers the capacity-exhaustion window, so every promotion happens
      mid-brownout and the parked joins replay into a degraded cluster.

    Certifies, per inter-promotion segment, the C1-C6 trace invariants at
    that segment's geometry; across the whole session the admission
    conservation ledger (requested == placed, nothing shed or stranded),
    the ladder itself (exactly ``tiers`` promotions), and a full
    live x live heal after a clean settle tail (the elastic C7: capacity
    rows are UNKNOWN by contract, so the fixed-shape convergence measure
    would never read 1.0). Never raises — violations come back as
    ``ok=False`` rows with the reproducer line, like every chaos trial.
    ``promotion_wall_ms`` is host wall-clock time."""
    from scalecube_cluster_tpu_torch.serve.bridge import ServeBridge
    from scalecube_cluster_tpu_torch.serve.ingest import event_from_obj

    params = chaos_params(n)
    n_live0 = n // 2
    n_top = n * (2**tiers)
    n_joins = n_top - n_live0
    burst = max(4, n // 4)
    join_iters = -(-n_joins // burst)

    rng = np.random.default_rng(seed)
    lat_ms = float(rng.uniform(GEO_BROWNOUT_LO_MS, GEO_BROWNOUT_HI_MS))
    #: Launch index the brownout opens at — at or before the first
    #: capacity exhaustion (free capacity n//2, burst n//4), so promotions
    #: always land inside the degraded window.
    brown_start = int(rng.integers(1, 3))
    victims = rng.choice(n_live0, size=join_iters, replace=True)
    digest = hashlib.sha1(
        f"{seed}:{n}:{tiers}:{burst}:{lat_ms:.3f}:{brown_start}:"
        f"{victims.tolist()}".encode()
    ).hexdigest()[:12]
    result = {
        "seed": seed,
        "n": n,
        "tiers": tiers,
        "ladder": grow_ladder(n, tiers),
        "digest": digest,
        "reproducer": grow_reproducer(seed, n, tiers, digest),
    }

    def world_plan(n_cur: int, brown: bool) -> FaultPlan:
        # Clean vs brownout worlds of one geometry differ only in the
        # latency matrix.
        w = LinkWorld.even_zones(n_cur, 2, device=device)
        if brown:
            w = w.with_zone_latency(0, 1, lat_ms)
        return FaultPlan.uniform(device=device).with_link_world(w)

    sp = _sparse_params(params, n_top)
    state = init_sparse_full_view(
        n_live0,
        slot_budget=sp.slot_budget,
        seed=seed,
        user_gossip_slots=params.user_gossip_slots,
        n_alloc=n,
        device=device,
    )
    bridge = ServeBridge(
        sp, state, plan=world_plan(n, False), batch_ticks=16, capacity=8
    )

    def seg_traces(launches: list[dict]) -> dict:
        return {
            k: np.concatenate([np.asarray(tr[k]) for tr in launches])
            for k in launches[0]
        }

    segments: list[list] = []
    current: list = []
    promo_ms: list[float] = []
    try:
        sent = 0
        for i in range(join_iters):
            b = min(burst, n_joins - sent)
            for _ in range(b):
                bridge.push(event_from_obj({"kind": "join"}))
            sent += b
            if i >= 1:
                v = int(victims[i])
                bridge.push(event_from_obj({"kind": "kill", "node": v}))
                bridge.push(event_from_obj({"kind": "restart", "node": v}))
            if bridge.batcher.deferred_joins:
                # Promotion is driven HERE rather than via auto_promote so
                # the plan's LinkWorld re-homes to the new geometry before
                # the launch (zone assignment is per-member, [n]-shaped).
                row = bridge.promote()
                promo_ms.append(row["wall_ms"])
                segments.append(current)
                current = []
            bridge.plan = world_plan(
                bridge.params.base.n, i >= brown_start
            )
            current.append(bridge.step_batch())
        # Clean settle tail: brownout off, C7-length heal window.
        bridge.plan = world_plan(bridge.params.base.n, False)
        for _ in range(-(-(heal_bound(params) + 20) // 16)):
            current.append(bridge.step_batch())
        segments.append(current)

        if bridge.promotions != tiers:
            raise InvariantViolation(
                "GROW-ladder",
                f"expected {tiers} promotions, took {bridge.promotions}",
            )
        led = bridge.batcher.assert_join_conservation()
        if led["placed"] != n_joins or led["shed"] or led["deferred"]:
            raise InvariantViolation(
                "GROW-conservation",
                f"{n_joins} joins requested but ledger reads {led}",
            )
        # One certification per inter-promotion segment, each on the
        # CUMULATIVE trace up to that boundary: live rows carry verbatim
        # across a promotion (P1), so C6's causality horizon legitimately
        # crosses it — a probe missed before the boundary may raise its
        # suspicion after. Every C1-C6 check is per-tick or monotone, so
        # each prefix run covers its newest segment at full strength.
        ladder = grow_ladder(n, tiers)
        flat: list = []
        for n_seg, launches in zip(ladder, segments):
            flat.extend(launches)
            if launches:
                certify_traces(chaos_params(n_seg), seg_traces(flat))
        lm = bridge.state.live_mask.cpu().numpy()
        ev = effective_view(bridge.state).cpu().numpy()
        known = (ev != -1) & lm[:, None] & lm[None, :]
        conv = float(known.sum()) / float(lm.sum()) ** 2
        if conv < 1.0:
            raise InvariantViolation(
                "GROW-heal",
                f"live x live convergence {conv:.4f} after the clean tail",
            )
    except (InvariantViolation, AssertionError) as e:
        inv = getattr(e, "invariant", "GROW-assert")
        result.update(ok=False, violation=inv, error=str(e))
        return result
    result.update(
        ok=True,
        final_convergence=conv,
        n_live=int(lm.sum()),
        promotions=bridge.promotions,
        joins_placed=led["placed"],
        promotion_wall_ms=[round(ms, 1) for ms in promo_ms],
    )
    return result


def grow_matrix(
    seeds, n: int, tiers: int = GROW_TIERS, on_result=None, device="cuda"
) -> list[dict]:
    """The seeded grow matrix: one :func:`grow_trial` per seed (host-driven
    — each promotion re-homes the session at the next geometry). Returns
    every row, violations included — callers assert."""
    results = []
    for seed in seeds:
        r = grow_trial(int(seed), n, tiers, device=device)
        results.append(r)
        if on_result is not None:
            on_result(r)
    return results
