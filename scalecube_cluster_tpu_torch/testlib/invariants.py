"""Invariant certifiers: replay a scheduled run's traces and certify
protocol properties per tick (copy of scalecube_cluster_tpu/testlib/
invariants.py: the SWIM part, ``REQUIRED_KEYS``, :func:`heal_bound`,
:func:`certify_traces`, :func:`certify_heal` and the batched
:func:`certify_population` that obs/ensemble.py reports, and the Rapid
part, :func:`r5_bound`, :func:`certify_rapid_traces` and
:func:`certify_rapid_population`, the zone part, :func:`z1_recover_bound`,
:func:`zone_heal_bound` and :func:`certify_zone_traces`, and the
promotion certifier :func:`certify_promotion`).

C1  Counter conservation — ``link_attempts == link_delivered +
    fault_blocked + fault_lost`` at every tick.
C2  Clean ticks drop nothing — a tick whose resolved plan is clean
    (``plan_dirty`` False) reports zero ``fault_blocked``/``fault_lost``.
C3  No false verdicts under a clean timeline — a schedule that is never
    dirty and fires no events raises no suspicion and no DEAD verdict.
C4  Epoch monotonicity — ``epoch_max`` never decreases, and only increases
    on ticks where a scheduled restart (or join) fired.
C5  Incarnation monotonicity between events — ``inc_max`` never decreases
    except on restart ticks.
C6  Suspicion implies a prior missed probe — the first tick with
    ``suspicions_raised > 0`` is preceded (<=) by a tick where direct probes
    went unacked (``pings > acks``).
C7  Convergence within a computed bound after heal — once the timeline goes
    permanently clean, the cluster re-converges within :func:`heal_bound`
    ticks (the caller passes the engine's end-of-run convergence).

The Rapid engine (sim/rapid.py) is certified from its per-member view
traces (``view_id`` / ``view_digest`` / ``view_size`` / ``alive_mask``):

R1  View agreement — live members holding the same view id hold the same
    view digest.
R2  View monotonicity — a member's view id never decreases while it stays
    alive.
R3  No split-brain — for any view id, at most one digest group is a
    majority of the view size it claims (checked before R1).
R4  Stability — no view change before probes were missed on at least
    ``low_watermark`` distinct ticks.
R5  Liveness under the fallback — every detected cut commits a view change
    within :func:`r5_bound` ticks of the later of the cut and the last
    disturbance, and the first view change has a detected cut at or before
    it; raised only for ``fallback=True`` runs (``views_parked`` is counted
    for every run).

Violations raise :class:`InvariantViolation` with the failing tick and
values. The trace certifiers are numpy only: callers read the traces
back first. :func:`certify_promotion` reads the two states back itself.
"""

from __future__ import annotations

import numpy as np
import torch

from scalecube_cluster_tpu_torch.sim.params import SimParams

#: Trace keys every certified trajectory must carry (both engines emit them
#: with collect=True; the event gauges come from the scheduled runners).
REQUIRED_KEYS = (
    "link_attempts",
    "link_delivered",
    "fault_blocked",
    "fault_lost",
    "pings",
    "acks",
    "suspicions_raised",
    "verdicts_dead",
    "inc_max",
    "epoch_max",
    "plan_dirty",
    "kills_fired",
    "restarts_fired",
)


#: Optional per-tick gauges the batched certifiers carry through to the
#: per-universe slices when a run emitted them (join-aware Rapid schedules,
#: fallback counters). Never required.
_OPTIONAL_EVENT_KEYS = (
    "joins_fired",
    "plan_dirty",
    "kills_fired",
    "restarts_fired",
    "fallback_rounds",
    "fallback_commits",
    "join_requests",
    "join_confirms",
)


class InvariantViolation(AssertionError):
    """A protocol invariant failed at a specific tick of a trajectory."""

    def __init__(self, invariant: str, message: str):
        super().__init__(f"{invariant}: {message}")
        self.invariant = invariant


def heal_bound(params: SimParams) -> int:
    """Ticks after the last disturbance within which a cluster must fully
    re-converge (C7). Worst-case chain: a suspicion armed on the last dirty
    tick runs its full timeout, the DEAD tombstone circulates for a sweep,
    rumors take up to two spread windows to reach everyone, and the
    anti-entropy SYNC lattice needs a few periods to repair anything gossip
    missed. The constant cushion absorbs probe-cadence phase (an FD round
    may start just after the heal) and straggler re-origination."""
    return (
        params.suspicion_ticks
        + params.periods_to_sweep
        + 2 * params.periods_to_spread
        + 3 * params.sync_period_ticks
        + 60
    )


def _get(traces: dict, key: str) -> np.ndarray:
    if key not in traces:
        raise InvariantViolation(
            "schema", f"certified traces must carry {key!r} (collect=True "
            "scheduled run); got keys {sorted(traces)}"
        )
    return np.asarray(traces[key]).reshape(-1)


def certify_traces(params: SimParams, traces: dict) -> dict:
    """Certify one scheduled trajectory's traces (C1-C6). Returns a summary
    dict (tick counts, disturbance window, totals) on success; raises
    :class:`InvariantViolation` at the first breach.

    ``traces`` is the collected metrics dict of a FaultSchedule run on
    either engine (numpy or device arrays, leading axis = ticks).
    """
    tr = {k: _get(traces, k) for k in REQUIRED_KEYS}
    ticks = tr["link_attempts"].size
    if ticks == 0:
        raise InvariantViolation("schema", "empty trace")

    att, dlv = tr["link_attempts"], tr["link_delivered"]
    blk, lost = tr["fault_blocked"], tr["fault_lost"]
    dirty = tr["plan_dirty"].astype(bool)
    kills, restarts = tr["kills_fired"], tr["restarts_fired"]
    # Optional gauge from join-aware scheduled runs (Rapid fallback engine):
    # a scheduled join spends the same epoch budget as a restart, so C4
    # accepts epoch bumps on join ticks too. Absent everywhere else.
    joins = (
        np.asarray(traces["joins_fired"]).reshape(-1)
        if "joins_fired" in traces
        else np.zeros_like(restarts)
    )

    # C1 conservation, every tick.
    bad = np.flatnonzero(att != dlv + blk + lost)
    if bad.size:
        t = int(bad[0])
        raise InvariantViolation(
            "C1-conservation",
            f"tick {t}: attempts={int(att[t])} != delivered={int(dlv[t])} "
            f"+ blocked={int(blk[t])} + lost={int(lost[t])}",
        )
    # Buckets are counts: none may go negative.
    for name, arr in (("attempts", att), ("delivered", dlv),
                      ("blocked", blk), ("lost", lost)):
        if (arr < 0).any():
            t = int(np.flatnonzero(arr < 0)[0])
            raise InvariantViolation(
                "C1-conservation", f"tick {t}: negative {name} {int(arr[t])}"
            )

    # C2 clean ticks drop nothing.
    bad = np.flatnonzero(~dirty & ((blk > 0) | (lost > 0)))
    if bad.size:
        t = int(bad[0])
        raise InvariantViolation(
            "C2-clean-tick",
            f"tick {t}: plan clean but blocked={int(blk[t])} "
            f"lost={int(lost[t])}",
        )

    # C3 no false verdicts under a fully clean, event-free timeline.
    event_ticks = (kills > 0) | (restarts > 0) | (joins > 0)
    if not dirty.any() and not event_ticks.any():
        if tr["suspicions_raised"].sum() > 0:
            t = int(np.flatnonzero(tr["suspicions_raised"] > 0)[0])
            raise InvariantViolation(
                "C3-false-suspicion",
                f"tick {t}: {int(tr['suspicions_raised'][t])} suspicions "
                "raised on a clean event-free timeline",
            )
        if tr["verdicts_dead"].sum() > 0:
            t = int(np.flatnonzero(tr["verdicts_dead"] > 0)[0])
            raise InvariantViolation(
                "C3-false-dead",
                f"tick {t}: {int(tr['verdicts_dead'][t])} DEAD verdicts "
                "on a clean event-free timeline",
            )

    # C4 epoch monotonicity; bumps only on restart ticks.
    em = tr["epoch_max"]
    d_em = np.diff(em)
    if (d_em < 0).any():
        t = int(np.flatnonzero(d_em < 0)[0]) + 1
        raise InvariantViolation(
            "C4-epoch-monotone",
            f"tick {t}: epoch_max dropped {int(em[t - 1])} -> {int(em[t])}",
        )
    rose = np.flatnonzero(d_em > 0) + 1
    bad = rose[(restarts[rose] == 0) & (joins[rose] == 0)]
    if bad.size:
        t = int(bad[0])
        raise InvariantViolation(
            "C4-epoch-source",
            f"tick {t}: epoch_max rose {int(em[t - 1])} -> {int(em[t])} "
            "with no scheduled restart or join",
        )

    # C5 incarnation monotone except on restart ticks.
    im = tr["inc_max"]
    d_im = np.diff(im)
    fell = np.flatnonzero(d_im < 0) + 1
    bad = fell[restarts[fell] == 0]
    if bad.size:
        t = int(bad[0])
        raise InvariantViolation(
            "C5-incarnation-monotone",
            f"tick {t}: inc_max dropped {int(im[t - 1])} -> {int(im[t])} "
            "with no restart to explain it",
        )

    # C6 suspicion implies a prior missed probe.
    susp_ticks = np.flatnonzero(tr["suspicions_raised"] > 0)
    if susp_ticks.size:
        first_susp = int(susp_ticks[0])
        missed = np.flatnonzero(tr["pings"] > tr["acks"])
        if not missed.size or int(missed[0]) > first_susp:
            raise InvariantViolation(
                "C6-suspicion-cause",
                f"tick {first_susp}: suspicion raised but no missed probe "
                f"at or before it (first miss: "
                f"{int(missed[0]) if missed.size else None})",
            )

    last_disturb = -1
    disturb = dirty | event_ticks
    if disturb.any():
        last_disturb = int(np.flatnonzero(disturb)[-1])
    return {
        "ticks": int(ticks),
        "last_disturbance_tick": last_disturb,
        "dirty_ticks": int(dirty.sum()),
        "kills": int(kills.sum()),
        "restarts": int(restarts.sum()),
        "suspicions_raised": int(tr["suspicions_raised"].sum()),
        "verdicts_dead": int(tr["verdicts_dead"].sum()),
        "fault_blocked": int(blk.sum()),
        "fault_lost": int(lost.sum()),
        "link_attempts": int(att.sum()),
    }


def certify_population(
    params: SimParams, traces: dict, final_convergence=None
) -> dict:
    """Batched certifier over an ensemble run (sim/ensemble.py): every trace
    leaf carries a leading universe axis ``[B, T]``; universe b is certified
    exactly as a single run (C1-C6, plus C7 when ``final_convergence`` — a
    ``[B]`` vector of end-of-run convergence — is given).

    Never raises: returns ``{"ok": bool[B], "violations": [None | dict]*B,
    "summaries": [None | dict]*B}`` — the per-universe pass/fail bitmap the
    population report exports (obs/ensemble.py). Like the rest of this
    module it is numpy-only; callers ``device_get`` the traces first.
    """
    missing = [k for k in REQUIRED_KEYS if k not in traces]
    if missing:
        raise InvariantViolation(
            "schema", f"population traces must carry {missing!r}"
        )
    lead = np.asarray(traces[REQUIRED_KEYS[0]])
    if lead.ndim != 2:
        raise InvariantViolation(
            "schema",
            f"population traces need a [B, T] universe axis; got {lead.shape}",
        )
    b_count = lead.shape[0]
    if final_convergence is not None:
        final_convergence = np.asarray(final_convergence).reshape(-1)
        if final_convergence.size != b_count:
            raise InvariantViolation(
                "schema",
                f"final_convergence has {final_convergence.size} entries "
                f"for {b_count} universes",
            )
    ok = np.ones(b_count, bool)
    violations: list = [None] * b_count
    summaries: list = [None] * b_count
    for b in range(b_count):
        tb = {
            k: np.asarray(traces[k])[b]
            for k in REQUIRED_KEYS + tuple(
                k for k in _OPTIONAL_EVENT_KEYS if k in traces
            )
        }
        try:
            summary = certify_traces(params, tb)
            if final_convergence is not None:
                certify_heal(params, summary, float(final_convergence[b]))
            summaries[b] = summary
        except InvariantViolation as e:
            ok[b] = False
            violations[b] = {"invariant": e.invariant, "error": str(e)}
    return {"ok": ok, "violations": violations, "summaries": summaries}


#: Trace keys a certified Rapid trajectory must carry (sim/rapid.py with
#: collect=True; the per-member view traces are the consistency plane).
RAPID_REQUIRED_KEYS = (
    "view_id",
    "view_digest",
    "view_size",
    "alive_mask",
    "view_changes",
    "alarms_raised",
    "cut_detected",
    "pings",
    "acks",
)

#: Keys whose trace leaves carry a per-member axis ([T, N], not [T]).
_RAPID_MEMBER_KEYS = ("view_id", "view_digest", "view_size", "alive_mask")


def _get_rapid(traces: dict, key: str) -> np.ndarray:
    if key not in traces:
        raise InvariantViolation(
            "schema", f"certified Rapid traces must carry {key!r} "
            f"(collect=True run of sim/rapid.py); got keys {sorted(traces)}"
        )
    arr = np.asarray(traces[key])
    if key in _RAPID_MEMBER_KEYS:
        if arr.ndim != 2:
            raise InvariantViolation(
                "schema",
                f"{key!r} must be a [T, N] per-member trace; got {arr.shape}",
            )
        return arr
    return arr.reshape(-1)


def r5_bound(params) -> int:
    """Ticks within which a detected cut must commit a view change under
    the classic fallback (R5). Closed form over the protocol's cadences:
    the locked vote sits ``fallback_delay_ticks`` before arming, the
    rotating coordinator needs at most n+2 three-tick rounds to land on an
    armed live member of the right configuration (n candidates, plus the
    partial round in flight, plus one round of promise-state settling),
    laggards adopt within one sync period, and the constant cushion absorbs
    probe/alarm phase at the detection edge."""
    return (
        int(params.fallback_delay_ticks)
        + 3 * (int(params.n) + 2)
        + int(params.sync_period_ticks)
        + 20
    )


def certify_rapid_traces(params, traces: dict, fallback: bool = False) -> dict:
    """Certify one Rapid trajectory's traces (R1-R5). ``params`` is the
    run's :class:`~scalecube_cluster_tpu.sim.rapid.RapidParams` (the
    L-watermark parameterizes R4, the fallback cadences R5). Returns a
    summary dict on success; raises :class:`InvariantViolation` at the
    first breach.

    Check order is R3, R1, R2, R4, R5 — see the module docstring for why
    split-brain outranks plain disagreement. ``fallback=True`` (a run with
    the classic fallback attached) arms the R5 liveness raises; the
    ``views_parked`` summary field is computed either way.
    """
    vid = _get_rapid(traces, "view_id")
    dig = _get_rapid(traces, "view_digest")
    vsz = _get_rapid(traces, "view_size")
    alv = _get_rapid(traces, "alive_mask").astype(bool)
    vc = _get_rapid(traces, "view_changes")
    pings = _get_rapid(traces, "pings")
    acks = _get_rapid(traces, "acks")
    ticks = vid.shape[0]
    if ticks == 0:
        raise InvariantViolation("schema", "empty trace")

    # R3 no split-brain, then R1 agreement — per tick, per view id, among
    # live members only (a dead process's frozen view claims nothing).
    for t in range(ticks):
        live = np.flatnonzero(alv[t])
        if live.size == 0:
            continue
        for view in np.unique(vid[t, live]):
            grp = live[vid[t, live] == view]
            digests, first, counts = np.unique(
                dig[t, grp], return_index=True, return_counts=True
            )
            claimed = vsz[t, grp][first]  # one claimed size per digest group
            majorities = int((2 * counts > claimed).sum())
            if majorities > 1:
                raise InvariantViolation(
                    "R3-split-brain",
                    f"tick {t}: view id {int(view)} has {majorities} "
                    f"majority digest groups (sizes {counts.tolist()} of "
                    f"claimed views {claimed.tolist()})",
                )
            if digests.size > 1:
                raise InvariantViolation(
                    "R1-agreement",
                    f"tick {t}: {grp.size} live members share view id "
                    f"{int(view)} but split over {digests.size} digests "
                    f"(counts {counts.tolist()})",
                )

    # R2 per-member view-id monotonicity while continuously alive.
    if ticks > 1:
        fell = (vid[1:] < vid[:-1]) & alv[1:] & alv[:-1]
        if fell.any():
            t, m = map(int, np.argwhere(fell)[0])
            raise InvariantViolation(
                "R2-monotone",
                f"tick {t + 1}: member {m} view id dropped "
                f"{int(vid[t, m])} -> {int(vid[t + 1, m])} without a "
                "restart (member alive across both ticks)",
            )

    # R4 stability: the first view change needs >= L prior missed-probe
    # ticks — the alarm counter cannot cross the L-watermark any faster.
    low = int(params.low_watermark)
    vc_ticks = np.flatnonzero(vc > 0)
    first_vc = int(vc_ticks[0]) if vc_ticks.size else -1
    if vc_ticks.size:
        miss_ticks = int((pings[: first_vc + 1] > acks[: first_vc + 1]).sum())
        if miss_ticks < low:
            raise InvariantViolation(
                "R4-stability",
                f"tick {first_vc}: view changed after only {miss_ticks} "
                f"missed-probe ticks (< L watermark {low}) — a flap "
                "shorter than L must never surface as a view change",
            )

    # R5 liveness: every detected cut must commit within the closed-form
    # bound — counted for every run (``views_parked``), raised only for
    # fallback runs (the bare fast path may park by design).
    cut = _get_rapid(traces, "cut_detected")
    cut_ticks = np.flatnonzero(cut > 0)
    bound = r5_bound(params) if hasattr(params, "fallback_delay_ticks") else 0
    disturb = np.zeros(ticks, bool)
    for key in ("plan_dirty", "kills_fired", "restarts_fired", "joins_fired"):
        if key in traces:
            disturb |= np.asarray(traces[key]).reshape(-1)[:ticks].astype(bool)
    views_parked = 0
    first_parked = -1
    for t in cut_ticks:
        later = np.flatnonzero(disturb[int(t):]) + int(t)
        anchor = int(later[-1]) if later.size else int(t)
        deadline = anchor + bound
        if deadline >= ticks:
            continue  # trace too short to judge this cut
        # Window includes the cut tick itself: the fast path locks a vote
        # and commits it in the same round when the quorum is already there.
        if not (vc[int(t) : deadline + 1] > 0).any():
            views_parked += 1
            if first_parked < 0:
                first_parked = int(t)
    if fallback and views_parked:
        raise InvariantViolation(
            "R5-parked",
            f"tick {first_parked}: cut detected but no view change within "
            f"{bound} ticks of the last disturbance — {views_parked} parked "
            "cut(s) under the classic fallback, which guarantees commit",
        )
    if fallback and first_vc >= 0:
        if not cut_ticks.size or int(cut_ticks[0]) > first_vc:
            raise InvariantViolation(
                "R5-commit-cause",
                f"tick {first_vc}: view change committed with no detected "
                f"cut at or before it (first cut: "
                f"{int(cut_ticks[0]) if cut_ticks.size else None})",
            )

    summary = {
        "ticks": int(ticks),
        "view_changes": int(vc.sum()),
        "alarms_raised": int(_get_rapid(traces, "alarms_raised").sum()),
        "cut_detected": int(cut.sum()),
        "max_view_id": int(vid[-1].max()),
        "first_view_change_tick": first_vc,
        "views_parked": int(views_parked),
    }
    for key in ("fallback_rounds", "fallback_commits",
                "join_requests", "join_confirms"):
        if key in traces:
            summary[key] = int(np.asarray(traces[key]).sum())
    return summary


def certify_rapid_population(params, traces: dict, fallback: bool = False) -> dict:
    """Batched R1-R5 certifier over an ensemble Rapid run: every trace leaf
    carries a leading universe axis (scalars ``[B, T]``, member traces
    ``[B, T, N]``); universe b is certified exactly as a single run. Never
    raises — returns the same ``{"ok", "violations", "summaries"}``
    structure as :func:`certify_population`."""
    missing = [k for k in RAPID_REQUIRED_KEYS if k not in traces]
    if missing:
        raise InvariantViolation(
            "schema", f"population traces must carry {missing!r}"
        )
    lead = np.asarray(traces["view_changes"])
    if lead.ndim != 2:
        raise InvariantViolation(
            "schema",
            f"population traces need a [B, T] universe axis; got {lead.shape}",
        )
    b_count = lead.shape[0]
    ok = np.ones(b_count, bool)
    violations: list = [None] * b_count
    summaries: list = [None] * b_count
    for b in range(b_count):
        tb = {
            k: np.asarray(traces[k])[b]
            for k in RAPID_REQUIRED_KEYS + tuple(
                k for k in _OPTIONAL_EVENT_KEYS if k in traces
            )
        }
        try:
            summaries[b] = certify_rapid_traces(params, tb, fallback=fallback)
        except InvariantViolation as e:
            ok[b] = False
            violations[b] = {"invariant": e.invariant, "error": str(e)}
    return {"ok": ok, "violations": violations, "summaries": summaries}


def certify_heal(
    params: SimParams, summary: dict, final_convergence: float
) -> None:
    """C7: if the trace extends at least :func:`heal_bound` ticks past the
    last disturbance, the run must have fully re-converged. ``summary`` is
    :func:`certify_traces`'s return; ``final_convergence`` is the engine's
    end-of-run convergence measure (dense: the ``convergence`` trace's last
    sample; sparse: sim/ensemble.py::sparse_convergence_device on the final
    state). No-op when the clean tail is shorter than the bound."""
    tail = summary["ticks"] - 1 - summary["last_disturbance_tick"]
    if tail < heal_bound(params):
        return
    if final_convergence < 1.0:
        raise InvariantViolation(
            "C7-heal-convergence",
            f"convergence {final_convergence:.4f} < 1.0 after "
            f"{tail} clean ticks (bound {heal_bound(params)})",
        )


# ---------------------------------------------------------------- Z1-Z3
# Geo graceful-degradation invariants, certified from the per-zone gauges
# a LinkWorld-bearing scheduled run emits (sim/topology.py::
# zone_tick_metrics -> ``zone_intra_conv`` [T, Z], ``zone_false_dead``
# [T, Z], ``zone_intra_suspects`` [T, Z]):
#
# Z1  Brownout tolerance — a pure-latency inter-zone brownout (no block,
#     no loss anywhere in the window) may raise suspicions (inflated
#     round-trip draws race the probe deadline) but must never convert
#     one into a DEAD verdict about a zone-mate: ``zone_false_dead`` is 0
#     in every zone at every brownout tick, and intra-zone convergence
#     returns to 1.0 within :func:`z1_recover_bound` of the window's end
#     (suspect records refute instead of sweeping to tombstones).
# Z2  Split containment — during a cross-zone split (zone-level blocks),
#     a CLEAN zone (no intra-zone edge disturbed) never produces a false
#     DEAD verdict about its OWN members: ``zone_false_dead[t, z] == 0``
#     for every clean zone z across the split window. The splitter side
#     may legitimately tombstone the far side; its own rack stays sane.
# Z3  Zone-aware heal — once the timeline goes permanently clean, every
#     zone's intra-zone convergence returns to 1.0 (and false-dead to 0)
#     within :func:`zone_heal_bound` — the flat C7 bound plus one sync
#     period per zone, covering the anti-entropy rounds cross-zone
#     re-seeding needs after a split tore the rumor paths.

ZONE_KEYS = ("zone_intra_conv", "zone_false_dead", "zone_intra_suspects")


def _get_zone(traces: dict, key: str) -> np.ndarray:
    if key not in traces:
        raise InvariantViolation(
            "schema",
            f"zone certification needs {key!r} — run a FaultSchedule with "
            "a LinkWorld attached (collect=True); got keys "
            f"{sorted(traces)}",
        )
    arr = np.asarray(traces[key])
    if arr.ndim != 2:
        raise InvariantViolation(
            "schema", f"{key!r} must be [ticks, zones]; got {arr.shape}"
        )
    return arr


def z1_recover_bound(params: SimParams) -> int:
    """Ticks after a pure-latency brownout ends within which every zone's
    intra-zone convergence must be 1.0 again (Z1). Worst case: a suspicion
    armed on the last brownout tick refutes on the next successful probe
    round (the suspect re-asserts with a bumped incarnation), and the
    refutation rumor crosses the zone within a spread window; the cushion
    absorbs FD-cadence phase."""
    return (
        params.suspicion_ticks
        + 2 * params.fd_period_ticks
        + params.periods_to_spread
        + 20
    )


def zone_heal_bound(params: SimParams, n_zones: int) -> int:
    """Z3: the zone-aware heal deadline. The flat :func:`heal_bound` chain
    (suspicion run-out, tombstone sweep, rumor spread, SYNC repair) plus
    one anti-entropy SYNC period per zone — after a split, cross-zone
    records re-enter through pairwise syncs, and a Z-zone world needs up
    to Z such rounds before every zone has re-seeded every other."""
    return heal_bound(params) + n_zones * params.sync_period_ticks


def certify_zone_traces(
    params: SimParams,
    traces: dict,
    *,
    brownout: tuple[int, int] | None = None,
    split: tuple[int, int] | None = None,
    clean_zones=None,
    heal_start: int | None = None,
    context: str = "",
) -> dict:
    """Certify the Z1-Z3 graceful-degradation invariants of one
    LinkWorld-bearing scheduled trajectory.

    ``brownout`` / ``split`` are ``[start, end)`` tick windows of the
    schedule's latency-only and zone-block segments (the caller built the
    timeline, so it knows the windows); ``clean_zones`` names the zones
    whose intra-zone edges the split leaves undisturbed (default: all
    zones — correct for pure cross-zone splits). ``heal_start`` is the
    first permanently-clean tick; Z3 is skipped (parked, like R5's
    open-deadline cuts) when ``heal_start + zone_heal_bound`` reaches past
    the trace end. Returns a summary dict; raises
    :class:`InvariantViolation` at the first breach."""
    conv = _get_zone(traces, "zone_intra_conv")
    false_dead = _get_zone(traces, "zone_false_dead")
    suspects = _get_zone(traces, "zone_intra_suspects")
    ticks, n_zones = conv.shape
    ctx = f" [{context}]" if context else ""
    summary: dict = {
        "ticks": ticks,
        "n_zones": n_zones,
        "max_intra_suspects": int(suspects.max()) if suspects.size else 0,
        "z1_checked": False,
        "z2_checked": False,
        "z3_checked": False,
    }

    if brownout is not None:
        b0, b1 = int(brownout[0]), int(min(brownout[1], ticks))
        bad = np.argwhere(false_dead[b0:b1] > 0)
        if bad.size:
            t, z = int(bad[0][0]) + b0, int(bad[0][1])
            raise InvariantViolation(
                "Z1-brownout-verdict",
                f"tick {t}: zone {z} holds {int(false_dead[t, z])} false "
                f"DEAD record(s) for live zone-mates during a pure-latency "
                f"brownout — latency alone must never tombstone{ctx}",
            )
        recover_by = b1 + z1_recover_bound(params)
        if recover_by < ticks:
            window = conv[b1 : recover_by + 1]
            if not np.any(np.all(window >= 1.0, axis=1)):
                worst = int(np.argmin(window.min(axis=1)))
                raise InvariantViolation(
                    "Z1-brownout-recovery",
                    f"no tick in [{b1}, {recover_by}] has every zone's "
                    f"intra convergence at 1.0 (worst tick {b1 + worst}: "
                    f"{window[worst].min():.4f}) — brownout suspicions "
                    f"must refute within the budget{ctx}",
                )
        summary["z1_checked"] = True
        summary["z1_recover_by"] = b1 + z1_recover_bound(params)

    if split is not None:
        s0, s1 = int(split[0]), int(min(split[1], ticks))
        zones = (
            list(range(n_zones)) if clean_zones is None else list(clean_zones)
        )
        seg = false_dead[s0:s1][:, zones]
        bad = np.argwhere(seg > 0)
        if bad.size:
            t, zi = int(bad[0][0]) + s0, zones[int(bad[0][1])]
            raise InvariantViolation(
                "Z2-clean-zone-verdict",
                f"tick {t}: clean zone {zi} holds "
                f"{int(false_dead[t, zi])} false DEAD record(s) for its "
                f"own live members during a cross-zone split{ctx}",
            )
        summary["z2_checked"] = True

    if heal_start is not None:
        deadline = int(heal_start) + zone_heal_bound(params, n_zones)
        if deadline < ticks:
            tail_conv = conv[deadline:]
            tail_dead = false_dead[deadline:]
            if not (np.all(tail_conv >= 1.0) and np.all(tail_dead == 0)):
                bad_t = deadline + int(
                    np.argmax(
                        np.any(tail_conv < 1.0, axis=1)
                        | np.any(tail_dead > 0, axis=1)
                    )
                )
                raise InvariantViolation(
                    "Z3-zone-heal",
                    f"tick {bad_t}: zone state not healed past the "
                    f"deadline {deadline} (bound "
                    f"{zone_heal_bound(params, n_zones)}): intra conv "
                    f"{conv[bad_t].min():.4f}, false dead "
                    f"{int(false_dead[bad_t].max())}{ctx}",
                )
            summary["z3_checked"] = True
        summary["z3_deadline"] = deadline
    return summary


# ---------------------------------------------------------------------------
# Elastic membership: geometry-promotion certification (P1-P3)


def certify_promotion(params_old, state_old, params_new, state_new) -> dict:
    """Certify one capacity-tier promotion (sim/checkpoint.py::
    promote_sparse_state or serve/bridge.py::ServeBridge.promote) against the bit-exact
    resume contract:

    - **P1 live-row bit-exactness** — every state leaf's ``[:n_old]`` rows
      (and the ``[:n_old, :n_old]`` view corner) carry VERBATIM into the
      promoted state: views, slab working set including the suspicion and
      incarnation planes, slot tables, user-gossip planes, tick, rng. A
      promotion must be invisible to the protocol on live rows.
    - **P2 capacity-row inertness** — every new row is the init-time masked
      form: UNKNOWN along both view axes, dead, stale slab lanes,
      ``live_mask`` False. A promotion must not manufacture identities.
    - **P3 recorder continuity** — when both states carry a flight
      recorder, the event log and cursor carry verbatim (ring positions
      stable, so recorded cause chains survive) and the causal registers'
      old rows carry verbatim.

    Raises :class:`InvariantViolation` at the first breach; returns a
    summary dict on success.
    """
    n_old, n_new = params_old.base.n, params_new.base.n
    if n_new <= n_old:
        raise InvariantViolation(
            "P1-geometry", f"promotion must grow: {n_old} -> {n_new}"
        )

    def host(x):
        return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)

    def p1(name, a, b):
        if not np.array_equal(a, b):
            raise InvariantViolation(
                "P1-live-rows", f"{name}: old rows not bit-exact across promotion"
            )

    def p2(name, ok):
        if not ok:
            raise InvariantViolation(
                "P2-capacity-rows", f"{name}: new capacity rows are not inert"
            )

    so, sn = state_old, state_new
    view_o, view_n = host(so.view_T), host(sn.view_T)
    p1("view_T", view_o, view_n[:n_old, :n_old])
    p2("view_T", bool(np.all(view_n[n_old:, :] == -1))
       and bool(np.all(view_n[:, n_old:] == -1)))
    p1("slot_subj", host(so.slot_subj), host(sn.slot_subj))
    subj_slot_n = host(sn.subj_slot)
    p1("subj_slot", host(so.subj_slot), subj_slot_n[:n_old])
    p2("subj_slot", bool(np.all(subj_slot_n[n_old:] == -1)))
    for name in ("slab", "age", "susp", "inc_self", "epoch", "alive",
                 "useen", "uage", "uinf_ids", "uptr"):
        p1(name, host(getattr(so, name)), host(getattr(sn, name))[:n_old])
    alive_n = host(sn.alive)
    p2("alive", bool(not np.any(alive_n[n_old:])))
    lm_o = host(so.live_mask) if so.live_mask is not None else np.ones(n_old, bool)
    lm_n = host(sn.live_mask)
    p1("live_mask", lm_o, lm_n[:n_old])
    p2("live_mask", bool(not np.any(lm_n[n_old:])))
    p1("tick", host(so.tick), host(sn.tick))
    p1("rng", host(so.rng), host(sn.rng))
    for name in ("lat_first_suspect", "lat_first_dead"):
        a = getattr(so, name)
        if a is not None:
            p1(name, host(a), host(getattr(sn, name))[:n_old])

    summary = {
        "n_old": int(n_old),
        "n_new": int(n_new),
        "n_live": int(lm_n.sum()),
        "tick": int(host(sn.tick)),
        "p3_checked": False,
    }
    if so.trace is not None and sn.trace is not None:
        ro, rn = so.trace, sn.trace
        for name in ("ev_kind", "ev_tick", "ev_actor", "ev_subject",
                     "ev_cause", "ev_aux", "cursor", "overflow"):
            if not np.array_equal(host(getattr(ro, name)), host(getattr(rn, name))):
                raise InvariantViolation(
                    "P3-recorder",
                    f"trace {name}: event log not verbatim across promotion "
                    "(ring positions must stay stable for cause chains)",
                )
        for name in ("last_miss", "origin"):
            if not np.array_equal(host(getattr(ro, name)),
                                  host(getattr(rn, name))[:n_old]):
                raise InvariantViolation(
                    "P3-recorder",
                    f"trace {name}: old rows not carried across promotion",
                )
        summary["p3_checked"] = True
    return summary
