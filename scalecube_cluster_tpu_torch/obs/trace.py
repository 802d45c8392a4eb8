"""Host-side span assembler for the causal flight recorder (the port's copy
of scalecube_cluster_tpu/obs/trace.py).

The device half (obs/tracer.py) fills a fixed-shape event ring inside the
tick; this module decodes rings into plain event dicts, writes and reads
them as JSONL, and renders them, with serving launch spans and transport
message spans where a caller has them, as Chrome-trace-event JSON that
Perfetto loads. The event kinds and the ``aux`` vocabulary are wire format,
equal to the JAX package's. Ring fields may be tensors on any device or
numpy arrays: they are copied to the host once per decode. The sharded
recorder's merge (``merge_shard_rings``) waits for the port's
multi-device engine.
"""

from __future__ import annotations

import json

import numpy as np

from scalecube_cluster_tpu_torch.obs.export import jsonl_line

# Event kinds — the device ring's ``ev_kind`` vocabulary. Values are wire
# format (trace JSONL + cause_ref chains), so additions only at the end.
TK_KILL = 1  # scheduled/host kill         actor=-1        subject=member
TK_RESTART = 2  # scheduled/host restart   actor=-1        subject=member
TK_PROBE_SENT = 3  # FD probe dispatched   actor=prober    subject=target
TK_PROBE_MISSED = 4  # probe round failed  actor=prober    subject=target
TK_SUSPECT_START = 5  # prober fires SUSPECT verdict       cause=missed probe
TK_SYNC_ACCEPT = 6  # own-record SYNC accepted             subject=partner
TK_GOSSIP_EDGE = 7  # user-gossip infection edge           subject=G slot
TK_VERDICT_DEAD = 8  # viewer's record became DEAD         cause=origin event
TK_VERDICT_ALIVE = 9  # viewer's record became ALIVE (refutation arrival)
TK_ALARM = 10  # Rapid watermark edge alarm actor=observer subject=subject
TK_VOTE = 11  # Rapid vote locked           actor=member
TK_VIEW_COMMIT = 12  # Rapid view commit     actor=member   subject=vote src
#                      cause=-1 fast path; cause>=0 points at the deciding
#                      coordinator's TK_FB_ACCEPT (classic fallback commit)
TK_FB_PREPARE = 13  # Paxos fallback prepare sent  actor=coordinator aux=rank
#                     cause = the coordinator's own TK_VOTE (the cut)
TK_FB_ACCEPT = 14  # fallback accept majority      actor=coordinator aux=rank
#                    cause = the round's TK_FB_PREPARE
TK_JOIN_EV = 15  # scheduled/host join event       actor=-1 subject=joiner
TK_JOIN_REQ = 16  # join handshake request         actor=joiner subject=seed
#                   aux = attempt counter; a chain root
TK_JOIN_ACK = 17  # seed ack delivered             actor=seed subject=joiner
#                   cause = the TK_JOIN_REQ it answers; aux = view digest
TK_JOIN_CONFIRM = 18  # seed latched the confirm   actor=seed subject=joiner
#                       cause = the TK_JOIN_ACK the joiner echoed

TK_NAMES = {
    TK_KILL: "kill",
    TK_RESTART: "restart",
    TK_PROBE_SENT: "probe_sent",
    TK_PROBE_MISSED: "probe_missed",
    TK_SUSPECT_START: "suspect_start",
    TK_SYNC_ACCEPT: "sync_accept",
    TK_GOSSIP_EDGE: "gossip_edge",
    TK_VERDICT_DEAD: "verdict_dead",
    TK_VERDICT_ALIVE: "verdict_alive",
    TK_ALARM: "alarm",
    TK_VOTE: "vote",
    TK_VIEW_COMMIT: "view_commit",
    TK_FB_PREPARE: "fb_prepare",
    TK_FB_ACCEPT: "fb_accept",
    TK_JOIN_EV: "join",
    TK_JOIN_REQ: "join_req",
    TK_JOIN_ACK: "join_ack",
    TK_JOIN_CONFIRM: "join_confirm",
}

#: ``aux`` vocabulary of TK_VERDICT_DEAD: where the viewer's DEAD record
#: came from (1 = its own suspicion countdown expired, 2 = learned through
#: gossip/SYNC delivery).
DEAD_VIA_EXPIRY = 1
DEAD_VIA_GOSSIP = 2


def _host(x) -> np.ndarray:
    """``x`` as a numpy array; a tensor is copied to the host first."""
    return np.asarray(x.cpu() if hasattr(x, "cpu") else x)


_RING_FIELDS = ("ev_kind", "ev_tick", "ev_actor", "ev_subject", "ev_cause", "ev_aux")


def ring_events(ring, kinds=None) -> list[dict]:
    """Decode a :class:`~scalecube_cluster_tpu_torch.obs.tracer.TraceRing`
    into plain event dicts, in emission order (``i`` == ring position ==
    the value ``cause`` references). ``kinds`` (a set of ``TK_*``) keeps
    only events of those kinds, each at its ring position: a ring of tens
    of millions of events decodes to the chains a check walks."""
    cursor = int(_host(ring.cursor))
    cols = [_host(getattr(ring, name)[:cursor]) for name in _RING_FIELDS]
    pos = range(cursor)
    if kinds is not None:
        keep = np.flatnonzero(np.isin(cols[0], sorted(kinds)))
        cols, pos = [c[keep] for c in cols], keep.tolist()
    cols = [c.tolist() for c in cols]
    return [
        {
            "i": i,
            "tick": tick,
            "kind": kind,
            "kind_name": TK_NAMES.get(kind, f"kind_{kind}"),
            "actor": actor,
            "subject": subject,
            "cause": cause,
            "aux": aux,
        }
        for i, kind, tick, actor, subject, cause, aux in zip(pos, *cols)
    ]


def ring_overflow(ring) -> int:
    """Events the bounded ring could not record (lossless accounting:
    emitted == recorded + overflow, the SHARED_COUNTERS discipline)."""
    return int(_host(ring.overflow).sum())


def trace_occupancy(ring) -> list[dict]:
    """Per-shard ring pressure gauges: one row per shard with ``cursor``
    (events recorded), ``capacity`` and ``overflow``. Duck-typed over both
    recorders — a plain TraceRing reports as shard 0."""
    cursors = _host(ring.cursor)
    overflows = _host(ring.overflow)
    cap = int(ring.capacity)
    if cursors.ndim == 0:
        cursors, overflows = cursors[None], overflows[None]
    return [
        {
            "shard": s,
            "cursor": int(cursors[s]),
            "capacity": cap,
            "overflow": int(overflows[s]),
        }
        for s in range(int(cursors.shape[0]))
    ]


def write_events_jsonl(path: str, events: list[dict]) -> None:
    """Deterministic JSONL export of decoded events (the trace-explain CLI's
    input format; same sorted-key serialization as obs/export.py)."""
    with open(path, "w") as fh:
        for ev in events:
            fh.write(jsonl_line(ev) + "\n")


def load_events_jsonl(path: str) -> list[dict]:
    with open(path) as fh:
        events = [json.loads(line) for line in fh if line.strip()]
    events.sort(key=lambda e: e["i"])
    return events


# -------------------------------------------------------------- message spans
# Host-transport request/response spans, keyed by the existing correlation
# ids (transport/api.py::request_response). Recording is opt-in: the hook in
# the transport is a no-op until :func:`start_message_spans` arms it, so the
# serving path pays nothing by default.
_MESSAGE_SPANS: list[dict] | None = None


def start_message_spans() -> None:
    """Arm the transport message-span recorder (idempotent)."""
    global _MESSAGE_SPANS
    if _MESSAGE_SPANS is None:
        _MESSAGE_SPANS = []


def stop_message_spans() -> list[dict]:
    """Disarm the recorder and return everything captured."""
    global _MESSAGE_SPANS
    spans, _MESSAGE_SPANS = _MESSAGE_SPANS or [], None
    return spans


def record_message_span(
    cid: str, qualifier: str, t0: float, t1: float, ok: bool = True
) -> None:
    """Called by the transport around each correlation-id-matched exchange.
    No-op unless armed."""
    if _MESSAGE_SPANS is not None:
        _MESSAGE_SPANS.append(
            {
                "correlation_id": cid,
                "qualifier": qualifier,
                "t0": float(t0),
                "t1": float(t1),
                "ok": bool(ok),
            }
        )


# -------------------------------------------------------------- chrome trace
def chrome_trace(
    events: list[dict] | None = None,
    launch_spans: list[dict] | None = None,
    message_spans: list[dict] | None = None,
    tick_us: float = 1000.0,
) -> dict:
    """Merge device events + serve launch spans + transport message spans
    into one Chrome-trace-event JSON object (Perfetto / chrome://tracing).

    Three synthetic processes: pid 0 = the device tick timeline (instant
    events at ``tick * tick_us``, one thread row per actor), pid 1 = serve
    launch spans, pid 2 = transport request/response spans. Host spans are
    re-based so the earliest one starts at ts 0 (monotonic-clock origins are
    arbitrary); the device timeline is tick-indexed, not wall-clock — the
    pids keep the two clock domains on separate tracks.
    """
    out: list[dict] = [
        {"ph": "M", "pid": 0, "name": "process_name",
         "args": {"name": "device sim (ticks)"}},
        {"ph": "M", "pid": 1, "name": "process_name",
         "args": {"name": "serve launches"}},
        {"ph": "M", "pid": 2, "name": "process_name",
         "args": {"name": "host transport"}},
    ]
    shard_tracks = sorted(
        {ev["shard"] for ev in events or [] if "shard" in ev}
    )
    for s in shard_tracks:
        out.append(
            {"ph": "M", "pid": 0, "tid": s, "name": "thread_name",
             "args": {"name": f"shard {s}"}}
        )
    for ev in events or []:
        # Merged multi-shard logs get one track per RECORDING shard (the
        # satellite contract for tools/trace_explain.py --chrome); plain
        # single-device decodes keep the original one-track-per-actor view.
        tid = ev["shard"] if "shard" in ev else max(ev["actor"], 0)
        args = {k: ev[k] for k in
                ("i", "tick", "actor", "subject", "cause", "aux")}
        if "shard" in ev:
            args["shard"] = ev["shard"]
        out.append(
            {
                "name": ev.get("kind_name", TK_NAMES.get(ev["kind"], "event")),
                "ph": "i",
                "s": "t",
                "ts": ev["tick"] * tick_us,
                "pid": 0,
                "tid": tid,
                "args": args,
            }
        )
    host_t0 = [s["t0"] for s in (launch_spans or [])] + [
        s["t0"] for s in (message_spans or [])
    ]
    origin = min(host_t0) if host_t0 else 0.0
    for i, sp in enumerate(launch_spans or []):
        out.append(
            {
                "name": "serve_launch",
                "ph": "X",
                "ts": (sp["t0"] - origin) * 1e6,
                "dur": max(sp["t1"] - sp["t0"], 0.0) * 1e6,
                "pid": 1,
                "tid": 0,
                "args": {
                    k: sp[k]
                    for k in ("batch", "base_tick", "batch_ticks", "n_events")
                    if k in sp
                },
            }
        )
        # Per-shard trace-ring pressure rides the launch timeline as
        # Perfetto counter tracks (one gauge per shard) when the serving
        # state carries a flight recorder (serve/bridge.py stamps
        # ``ring_occupancy`` from obs/trace.py::trace_occupancy).
        for occ in sp.get("ring_occupancy") or []:
            out.append(
                {
                    "name": f"trace_ring_occupancy/shard{occ['shard']}",
                    "ph": "C",
                    "ts": (sp["t1"] - origin) * 1e6,
                    "pid": 1,
                    "tid": 0,
                    "args": {"events": occ["cursor"],
                             "overflow": occ.get("overflow", 0)},
                }
            )
    for sp in message_spans or []:
        out.append(
            {
                "name": sp.get("qualifier", "message"),
                "ph": "X",
                "ts": (sp["t0"] - origin) * 1e6,
                "dur": max(sp["t1"] - sp["t0"], 0.0) * 1e6,
                "pid": 2,
                "tid": 0,
                "args": {
                    "correlation_id": sp.get("correlation_id"),
                    "ok": sp.get("ok", True),
                },
            }
        )
    return {"traceEvents": out, "displayTimeUnit": "ms"}


def write_chrome_trace(
    path: str,
    events: list[dict] | None = None,
    launch_spans: list[dict] | None = None,
    message_spans: list[dict] | None = None,
    tick_us: float = 1000.0,
) -> None:
    with open(path, "w") as fh:
        json.dump(
            chrome_trace(events, launch_spans, message_spans, tick_us), fh
        )
