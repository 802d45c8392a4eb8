"""Seeded serving replays (serve/bridge.py) that the parity tests, the card
tests and ``chip_smoke.py`` hold the port to: the same wire events through
a :class:`~scalecube_cluster_tpu_torch.serve.bridge.ServeBridge` on any
device, and the equivalent offline run through the engines' own runners
(the serving plane's correctness anchor).

Each scenario is plain data — sizes, launch geometry and the wire events
as the JSON objects a producer sends (serve/ingest.py::event_from_obj) —
so the parity tests build the reference's session from the same entries.
``fired`` lists each scenario's events as they fire on the device, ``(kind,
tick, node)``, after the batcher's capacity deferrals: the offline twin's
schedule.

- ``clean``: n=16, S=64, the XLA chain, no traffic.
- ``kill-restart``: n=64, S=128, the fused core with host-boundary
  write-backs; a duplicate kill cell, a restart, and three events on one
  tick at capacity 2 (the third deferred a tick).
- ``gossip``: the same session with user-gossip cells, two of them on one
  (member, slot) cell, beside a kill.
- ``knobbed``: n=16, S=64, the XLA chain under knobs, one kill.
- ``elastic``: 24 live rows of 32, the XLA chain with the flight
  recorder: wire joins (node omitted) admitted, four parked at capacity,
  ``promote()`` to 64 rows replaying them, more joins and a restart.
- ``elastic-ticked``: wire joins aimed at ticks, no promotion (its
  offline twin schedules the same rows at the same ticks).
- ``rapid``: n=16, the fallback plane armed, a clean plan, a kill and a
  protocol join of the same member.
"""

from __future__ import annotations

import numpy as np

#: A step of an elastic scenario that calls ServeBridge.promote() (every
#: other step is the events pushed before one launch).
_PROMOTE = "promote"

SERVE_SCENARIOS = {
    "clean": {
        "engine": "sparse", "n": 16, "s": 64, "pallas_core": False,
        "in_scan_writeback": True, "ticks": 8, "batch_ticks": 4, "capacity": 2,
        "events": [], "fired": [],
    },
    "kill-restart": {
        "engine": "sparse", "n": 64, "s": 128, "pallas_core": True,
        "in_scan_writeback": False, "ticks": 16, "batch_ticks": 8, "capacity": 2,
        "events": [
            {"kind": "kill", "node": 2, "tick": 3},
            {"kind": "kill", "node": 2, "tick": 3},
            {"kind": "restart", "node": 2, "tick": 9},
            {"kind": "kill", "node": 40, "tick": 5},
            {"kind": "leave", "node": 41, "tick": 5},
            {"kind": "kill", "node": 42, "tick": 5},
        ],
        "fired": [("kill", 3, 2), ("restart", 9, 2), ("kill", 5, 40), ("kill", 5, 41),
                  ("kill", 6, 42)],
    },
    "gossip": {
        "engine": "sparse", "n": 64, "s": 128, "pallas_core": True,
        "in_scan_writeback": False, "ticks": 16, "batch_ticks": 8, "capacity": 2,
        "events": [
            {"kind": "gossip", "node": 5, "slot": 1, "tick": 2},
            {"kind": "gossip", "node": 5, "slot": 1, "tick": 2},
            {"kind": "gossip", "node": 9, "slot": 3, "tick": 4},
            {"kind": "kill", "node": 9, "tick": 4},
            {"kind": "gossip", "node": 0, "slot": 0, "tick": 11},
        ],
        "fired": None,  # schedules carry no gossip: no offline twin
    },
    "knobbed": {
        "engine": "sparse", "n": 16, "s": 64, "pallas_core": False,
        "in_scan_writeback": True, "ticks": 8, "batch_ticks": 4, "capacity": 2,
        "knobs": {"suspicion_mult": 2.0, "fanout_cap": 1},
        "events": [{"kind": "kill", "node": 5, "tick": 2}], "fired": [("kill", 2, 5)],
    },
    "elastic": {
        "engine": "sparse-elastic", "n_live": 24, "n": 32, "s": 64, "pallas_core": False,
        "in_scan_writeback": True, "batch_ticks": 4, "capacity": 4, "trace_capacity": 4096,
        "steps": [
            [{"kind": "kill", "node": 3, "tick": 2}] + [{"kind": "join"}] * 4,
            [{"kind": "join"}] * 8,
            _PROMOTE,
            [{"kind": "restart", "node": 3}] + [{"kind": "join"}] * 2,
            [],
        ],
        "fired": None,
    },
    "elastic-ticked": {
        "engine": "sparse-elastic", "n_live": 24, "n": 32, "s": 64, "pallas_core": False,
        "in_scan_writeback": True, "ticks": 8, "batch_ticks": 4, "capacity": 4,
        "events": [
            {"kind": "join", "tick": 2}, {"kind": "join", "tick": 2},
            {"kind": "kill", "node": 3, "tick": 3}, {"kind": "join", "tick": 3},
            {"kind": "join", "tick": 5},
        ],
        "fired": [("join", 2, 24), ("join", 2, 25), ("kill", 3, 3), ("join", 3, 26),
                  ("join", 5, 27)],
    },
    "rapid": {
        "engine": "rapid-fallback", "n": 16, "seed": 11, "ticks": 40, "batch_ticks": 8,
        "capacity": 2,
        "events": [{"kind": "kill", "node": 2, "tick": 6}, {"kind": "join", "node": 2, "tick": 14}],
        "fired": [("kill", 6, 2), ("join", 14, 2)],
    },
}


def scenario(name: str, **sizes) -> dict:
    """The scenario's entry with ``sizes`` (``n``, ``n_live``, ``s``,
    ``pallas_core``, ``trace_capacity``, ...) replacing its own. The
    elastic scenarios follow ``n_live``: ``elastic`` joins half the free
    rows in its first launch and the rest and 4 more (parked until the
    promotion) in its second; ``elastic-ticked``'s joins land on the first
    capacity rows."""
    sc = dict(SERVE_SCENARIOS[name], **sizes)
    if name == "elastic-ticked":
        nl = sc["n_live"]
        sc["fired"] = [("join", 2, nl), ("join", 2, nl + 1), ("kill", 3, 3),
                       ("join", 3, nl + 2), ("join", 5, nl + 3)]
    if name == "elastic":
        free = sc["n"] - sc["n_live"]
        steps = list(sc["steps"])
        steps[0] = [steps[0][0]] + [{"kind": "join"}] * (free // 2)
        steps[1] = [{"kind": "join"}] * (free - free // 2 + 4)
        sc["steps"] = steps
    return sc


def rapid_params(n: int):
    """The chaos harness's Rapid constants (testlib/chaos.py::
    rapid_chaos_params): FD every 2 ticks, SYNC every 5, k clipped to n - 1."""
    from scalecube_cluster_tpu_torch.sim.rapid import RapidParams

    k = min(8, n - 1)
    return RapidParams(n=n, k=k, low_watermark=4, high_watermark=min(6, k),
                       fd_period_ticks=2, sync_period_ticks=5)


def _session(sc: dict, device):
    """``(params, state, plan, knobs)`` of a scenario on ``device``."""
    from scalecube_cluster_tpu_torch.sim.faults import FaultPlan
    from scalecube_cluster_tpu_torch.sim.knobs import make_knobs
    from scalecube_cluster_tpu_torch.sim.rapid import init_rapid_full_view
    from scalecube_cluster_tpu_torch.sim.sparse import SparseParams, init_sparse_full_view

    if sc["engine"].startswith("rapid"):
        params = rapid_params(sc["n"])
        state = init_rapid_full_view(params, seed=sc["seed"], fallback=True, device=device)
        return params, state, FaultPlan.clean(sc["n"], device=device), None
    params = SparseParams.for_n(
        sc["n"], slot_budget=sc["s"], pallas_core=sc["pallas_core"],
        in_scan_writeback=sc["in_scan_writeback"],
    )
    n_live = sc.get("n_live", sc["n"])
    state = init_sparse_full_view(
        n_live, sc["s"], n_alloc=sc["n"] if n_live != sc["n"] else None,
        trace_capacity=sc.get("trace_capacity", 0), device=device,
    )
    knobs = sc.get("knobs")
    if knobs is not None:
        knobs = make_knobs(params.base, device=device, **knobs)
    return params, state, FaultPlan.uniform(device=device), knobs


def state_to_numpy(state) -> dict:
    """Every leaf of a sparse or Rapid state as numpy copies, nested
    records (the ring, the fallback plane) flattened to ``"ring.field"``."""
    from scalecube_cluster_tpu_torch.sim.convert import rapid_state_to_numpy, sparse_state_to_numpy
    from scalecube_cluster_tpu_torch.sim.rapid import RapidState

    flat = (rapid_state_to_numpy if isinstance(state, RapidState) else sparse_state_to_numpy)(state)
    for sub in ("fb", "trace"):
        for k, v in flat.pop(sub, {}).items():
            flat[f"{sub}.{k}"] = v
    return flat


def serve_replay(name: str, device, **sizes) -> dict:
    """Run scenario ``name`` through a ServeBridge on ``device``. Returns
    ``{"state", "traces", "rows", "live", "counters"}``: the final state
    (:func:`state_to_numpy`), each launch's traces (numpy), the bridge's
    export rows (every ``serve_batch`` and ``promotion`` row and the
    closing ``serve`` row), the ``serve_live`` row and the counters."""
    from scalecube_cluster_tpu_torch.serve import ServeBridge
    from scalecube_cluster_tpu_torch.serve.ingest import event_from_obj

    sc = scenario(name, **sizes)
    params, state, plan, knobs = _session(sc, device)
    bridge = ServeBridge(params, state, plan=plan, knobs=knobs, batch_ticks=sc["batch_ticks"],
                         capacity=sc["capacity"], engine=sc["engine"])
    if "steps" in sc:
        traces = []
        for step in sc["steps"]:
            if step == _PROMOTE:
                bridge.promote()
                continue
            for obj in step:
                bridge.push(event_from_obj(dict(obj)))
            traces.append(bridge.step_batch())
    else:
        traces = bridge.run_replay([event_from_obj(dict(o)) for o in sc["events"]], sc["ticks"])
    live = bridge.live_metrics()
    counters = bridge.counters()
    bridge.close()
    return {"state": state_to_numpy(bridge.state), "traces": traces, "rows": bridge.rows,
            "live": live, "counters": counters}


def offline_run(name: str, device, **sizes) -> dict:
    """The scenario's offline twin: its ``fired`` events as a
    FaultSchedule, run by the engine's own runner over the same ticks (the
    host-boundary mode in ``batch_ticks`` chunks, as the bridge frees
    slots). Returns ``{"state", "traces"}`` (numpy)."""
    from scalecube_cluster_tpu_torch.sim.rapid import run_rapid_ticks
    from scalecube_cluster_tpu_torch.sim.schedule import ScheduleBuilder
    from scalecube_cluster_tpu_torch.sim.sparse import run_sparse_chunked, run_sparse_ticks

    sc = scenario(name, **sizes)
    params, state, plan, knobs = _session(sc, device)
    timeline = ScheduleBuilder(sc["n"]).add_segment(0, plan)
    for kind, tick, node in sc["fired"]:
        timeline = getattr(timeline, kind)(tick, node)
    sched = timeline.build()
    ticks = sc["ticks"]
    if sc["engine"].startswith("rapid"):
        state, traces = run_rapid_ticks(params, state, sched, ticks)
        traces = {k: v.cpu().numpy() for k, v in traces.items()}
    elif params.in_scan_writeback:
        state, traces = run_sparse_ticks(params, state, sched, ticks, knobs=knobs)
        traces = {k: v.cpu().numpy() for k, v in traces.items()}
    else:
        state, traces = run_sparse_chunked(params, state, sched, ticks, chunk=sc["batch_ticks"],
                                           knobs=knobs)
    return {"state": state_to_numpy(state), "traces": traces}


def concat_traces(launches: list) -> dict:
    """Per-launch trace dicts joined along the tick axis."""
    return {k: np.concatenate([np.asarray(t[k]) for t in launches]) for k in launches[0]}


#: Row keys whose values are wall-clock readings or identify the build,
#: not the trajectory: rows are held key for key, and value for value on
#: every other key.
TIMING_KEYS = frozenset({
    "latency_ms", "latency_ms_p50", "latency_ms_p95", "latency_ms_p99", "latency_ms_mean",
    "events_per_sec", "member_rounds_per_sec", "wall_ms", "jax_version", "jaxlib_version",
    "device_kind", "platform", "commit",
})


def row_values(row: dict) -> dict:
    """``row`` without :data:`TIMING_KEYS` (nested counter dicts kept)."""
    return {k: v for k, v in row.items() if k not in TIMING_KEYS}

