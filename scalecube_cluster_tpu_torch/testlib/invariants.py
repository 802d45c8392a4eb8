"""SWIM invariant certifiers: replay a scheduled run's traces and certify
protocol properties per tick (copy of the SWIM part of
scalecube_cluster_tpu/testlib/invariants.py: ``REQUIRED_KEYS``,
:func:`heal_bound`, :func:`certify_traces`, :func:`certify_heal` and the
batched :func:`certify_population` that obs/ensemble.py reports; the
Rapid, zone and promotion certifiers wait for ROADMAP A12-A14).

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

Violations raise :class:`InvariantViolation` with the failing tick and
values. Numpy only: callers read the traces back first.
"""

from __future__ import annotations

import numpy as np

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
