"""Verdict explainer: walk flight-recorder cause chains and check C6 (the
port's copy of the JAX package's ``tools/trace_explain.py``: ``walk_chain``,
``explain_verdict`` and ``check_c6``, over events decoded by
``obs/trace.py::ring_events`` or read back by ``load_events_jsonl``).

For every DEAD verdict the walk follows the ``cause`` chain back to the
originating probe:

    verdict_dead -> suspect_start -> probe_missed -> probe_sent   (expiry)
    verdict_dead -> probe_sent                                    (epoch-gone)

and machine-checks the C6 invariant ("no DEAD without a missed/refuting
probe round") per event: every link must point strictly backwards in the
ring, keep the subject fixed, keep the failure-detector actor fixed across
the probe episode, be of the kind the protocol allows at that link, and be
tick-ordered. The chain grammar also holds the Rapid links (fallback
rounds, the join handshake), which ``check_rapid_chains`` walks for every
fallback-committed view change and every join confirm:

    view_commit -> fb_accept -> fb_prepare -> vote   (classic fallback)
    join_confirm -> join_ack -> join_req             (join handshake)
"""

from __future__ import annotations

import argparse
import sys

from scalecube_cluster_tpu_torch.obs.trace import (
    TK_FB_ACCEPT,
    TK_FB_PREPARE,
    TK_JOIN_ACK,
    TK_JOIN_CONFIRM,
    TK_JOIN_REQ,
    TK_PROBE_MISSED,
    TK_PROBE_SENT,
    TK_SUSPECT_START,
    TK_VERDICT_DEAD,
    TK_VIEW_COMMIT,
    TK_VOTE,
    load_events_jsonl,
)

#: Allowed ``cause`` kinds per link of the chain (the protocol's grammar).
_CAUSE_KINDS = {
    TK_VERDICT_DEAD: (TK_SUSPECT_START, TK_PROBE_SENT),
    TK_SUSPECT_START: (TK_PROBE_MISSED,),
    TK_PROBE_MISSED: (TK_PROBE_SENT,),
    TK_VIEW_COMMIT: (TK_FB_ACCEPT,),
    TK_FB_ACCEPT: (TK_FB_PREPARE,),
    TK_FB_PREPARE: (TK_VOTE,),
    TK_JOIN_CONFIRM: (TK_JOIN_ACK,),
    TK_JOIN_ACK: (TK_JOIN_REQ,),
}

#: Kinds that legitimately end a chain (nothing caused them inside the ring).
_ROOT_KINDS = (TK_PROBE_SENT, TK_VOTE, TK_JOIN_REQ)

#: Kinds whose ``cause`` may be -1 at the chain HEAD: a view_commit with no
#: cause is a fast-path commit (no classic round ran) — a legitimate root,
#: not a truncated chain. Anywhere deeper, -1 is still a violation.
_OPTIONAL_CAUSE = (TK_VIEW_COMMIT,)

#: Links whose actor must stay fixed: the FD probe episode, the fallback
#: coordinator's prepare -> accept -> vote trail, and the seed's ack ->
#: confirm pair. (Verdict and fb-commit links legitimately cross actors.)
_ACTOR_FIXED = (
    TK_SUSPECT_START,
    TK_PROBE_MISSED,
    TK_FB_ACCEPT,
    TK_FB_PREPARE,
    TK_JOIN_CONFIRM,
)


def walk_chain(by_pos: dict[int, dict], ev: dict) -> tuple[list[dict], list[str]]:
    """Follow ``ev``'s cause references back to the originating probe.

    Returns ``(chain, violations)`` where ``chain`` starts at ``ev`` and
    ends at the last resolvable event. An empty ``violations`` list means
    the chain is complete and every per-event C6 check held.
    """
    chain = [ev]
    violations: list[str] = []
    cur = ev
    seen = {ev["i"]}
    while True:
        kinds = _CAUSE_KINDS.get(cur["kind"])
        if kinds is None:
            # A root kind (probe_sent / vote / join_req) legitimately ends
            # a chain.
            if cur["kind"] not in _ROOT_KINDS and cur is not ev:
                violations.append(
                    f"event {cur['i']}: chain ends at kind "
                    f"{cur['kind_name']}, not at a root kind"
                )
            break
        c = cur["cause"]
        if c < 0:
            if cur["kind"] in _OPTIONAL_CAUSE and cur is ev:
                break  # fast-path view_commit: causeless by design
            violations.append(
                f"event {cur['i']} ({cur['kind_name']}): unresolved cause "
                "(ref -1) — originating event missing from the ring"
            )
            break
        if c >= cur["i"]:
            violations.append(
                f"event {cur['i']}: cause {c} does not point strictly "
                "backwards in the ring"
            )
            break
        if c in seen:
            violations.append(f"event {cur['i']}: cause cycle at {c}")
            break
        nxt = by_pos.get(c)
        if nxt is None:
            violations.append(
                f"event {cur['i']}: cause {c} not present in the event file"
            )
            break
        if nxt["kind"] not in kinds:
            allowed = "/".join(str(k) for k in kinds)
            violations.append(
                f"event {cur['i']} ({cur['kind_name']}): cause {c} has kind "
                f"{nxt['kind_name']}, protocol allows kinds {allowed}"
            )
            break
        if cur["kind"] == TK_JOIN_ACK:
            # The only subject-swapping link: a seed's ack (actor=seed,
            # subject=joiner) answers the joiner's request (actor=joiner,
            # subject=seed) — roles invert across the wire.
            if nxt["actor"] != cur["subject"] or nxt["subject"] != cur["actor"]:
                violations.append(
                    f"event {cur['i']}: join ack does not answer its "
                    f"joiner's request (ack seed={cur['actor']} "
                    f"joiner={cur['subject']}, req actor={nxt['actor']} "
                    f"seed={nxt['subject']} at ref {c})"
                )
                break
        elif nxt["subject"] != cur["subject"]:
            violations.append(
                f"event {cur['i']}: subject changes along the chain "
                f"({cur['subject']} -> {nxt['subject']} at ref {c})"
            )
            break
        if nxt["tick"] > cur["tick"]:
            violations.append(
                f"event {cur['i']} (tick {cur['tick']}): cause {c} is from "
                f"the future (tick {nxt['tick']})"
            )
            break
        if cur["kind"] in _ACTOR_FIXED and nxt["actor"] != cur["actor"]:
            # Within one probe episode / fallback round / seed handshake the
            # acting member is fixed; only the verdict and fb-commit links
            # cross actors (viewer != prober, committer != coordinator).
            violations.append(
                f"event {cur['i']}: episode actor changes "
                f"({cur['actor']} -> {nxt['actor']} at ref {c})"
            )
            break
        seen.add(c)
        chain.append(nxt)
        cur = nxt
    return chain, violations


def explain_verdict(events: list[dict], verdict: dict) -> dict:
    """Explain one chain head (DEAD verdict, fb-committed view change, or
    join confirm): its full chain plus any per-link violations."""
    by_pos = {e["i"]: e for e in events}
    chain, violations = walk_chain(by_pos, verdict)
    tail = chain[-1]
    return {
        "verdict": verdict,
        "chain": chain,
        "violations": violations,
        "complete": not violations
        and (
            tail["kind"] in _ROOT_KINDS
            or (tail["kind"] in _OPTIONAL_CAUSE and tail["cause"] < 0)
        ),
    }


def check_c6(events: list[dict]) -> list[str]:
    """Machine-check C6 over EVERY dead verdict in the file. Returns the
    flat violation list (empty == the invariant held per-event)."""
    by_pos = {e["i"]: e for e in events}
    out: list[str] = []
    for ev in events:
        if ev["kind"] != TK_VERDICT_DEAD:
            continue
        _, violations = walk_chain(by_pos, ev)
        out.extend(
            f"DEAD(subject={ev['subject']}, viewer={ev['actor']}, "
            f"tick={ev['tick']}): {v}"
            for v in violations
        )
    return out


def check_rapid_chains(events: list[dict]) -> list[str]:
    """Machine-check the Rapid fallback and join chain families over EVERY
    fb-committed view change (``view_commit`` with ``cause >= 0``) and every
    ``join_confirm`` in the file. Returns the flat violation list (empty ==
    each one walks back to its originating vote / join request)."""
    by_pos = {e["i"]: e for e in events}
    out: list[str] = []
    for ev in events:
        if ev["kind"] == TK_VIEW_COMMIT and ev["cause"] >= 0:
            label = (
                f"FB_COMMIT(decree src={ev['subject']}, "
                f"member={ev['actor']}, tick={ev['tick']})"
            )
        elif ev["kind"] == TK_JOIN_CONFIRM:
            label = (
                f"JOIN_CONFIRM(joiner={ev['subject']}, "
                f"seed={ev['actor']}, tick={ev['tick']})"
            )
        else:
            continue
        _, violations = walk_chain(by_pos, ev)
        out.extend(f"{label}: {v}" for v in violations)
    return out


def format_chain(explained: dict) -> str:
    """One explained chain as text, a line per link; a merged multi-shard
    log (obs/trace.py::merge_shard_rings) shows each link's shard."""
    v = explained["verdict"]
    lines = [f"why {v['kind_name']}(subject={v['subject']}) at tick {v['tick']} "
             f"by member {v['actor']}:"]
    for ev in explained["chain"]:
        shard = f" shard={ev['shard']}" if "shard" in ev else ""
        lines.append(
            f"  [{ev['i']:>5}] tick {ev['tick']:>5}  {ev['kind_name']:<14} "
            f"actor={ev['actor']} subject={ev['subject']} cause={ev['cause']}{shard}"
        )
    lines += [f"  VIOLATION: {bad}" for bad in explained["violations"]]
    if explained["complete"]:
        lines.append("  => chain complete: rooted at its originating event")
    return "\n".join(lines)


def main(argv: list[str] | None = None) -> int:
    """``python -m scalecube_cluster_tpu_torch.tools.trace_explain EVENTS
    [--quiet]``: check C6 and the Rapid chains over an event JSONL
    (``obs/trace.py::write_events_jsonl`` of a ring's decode or of a
    merged sharded log). Exit 1 on any violation."""
    ap = argparse.ArgumentParser(prog="trace_explain")
    ap.add_argument("events", help="event JSONL from obs.trace.write_events_jsonl")
    ap.add_argument("--max-chains", type=int, default=8,
                    help="print at most this many chains (all are checked)")
    ap.add_argument("--quiet", action="store_true",
                    help="print only the summary lines and violations")
    args = ap.parse_args(argv)
    events = load_events_jsonl(args.events)
    if not args.quiet:
        heads = [e for e in events if e["kind"] == TK_VERDICT_DEAD][: args.max_chains]
        for ev in heads:
            print(format_chain(explain_verdict(events, ev)))
    rc = 0
    for name, violations in (("C6", check_c6(events)),
                             ("rapid chains", check_rapid_chains(events))):
        print(f"{name}: {len(violations)} violation(s)")
        for v in violations:
            print(f"  {v}")
        rc = rc or int(bool(violations))
    return rc


if __name__ == "__main__":
    sys.exit(main())
