"""Seeded fleet sessions (serve/fleet.py) that the parity tests, the card
tests and ``chip_smoke.py`` hold the port to: the same steps through a
:class:`~scalecube_cluster_tpu_torch.serve.fleet.FleetBridge` on any device,
each tenant's solo replay through a ServeBridge, and — since the steps are
plain data and the two packages' fleets share their API — the reference's
session built from the same entries.

A scenario's ``steps`` are tuples: ``("replay", events, n_ticks)`` (wire
events as the JSON objects a producer sends, serve/ingest.py::
event_from_obj, each tagged with its ``tenant``; later steps aim every
event at a tick), ``("evict", tid)``, ``("admit", tid)``, ``("knob", tid,
knob_kwargs)`` and ``("promote", tid, n_new)`` (None: the doubling
ladder). ``solo`` maps each tenant
whose solo replay is checked to the slot (= placeholder seed) it starts
from.

- ``sparse``: n=16, S=64, B=4, the XLA chain: the victim's kill / gossip /
  restart arc beside three neighbours' traffic (a noisy flood included),
  then tenant 3 evicted and tenant 5 admitted into its scrubbed slot at
  tick 0 while the others run at tick 12 — a pool of two tick groups —
  and more traffic for 0 and 5.
- ``kernel``: the same arc at n=64, S=128, B=2 through the fused core with
  host-boundary write-backs; tenant 1 evicted and tenant 2 admitted at
  tick 0.
- ``knobbed``: n=16, B=3 on the XLA chain with stacked identity knobs,
  tenant 0 tuned (``suspicion_mult=2``).
- ``elastic``: 8 live rows of 16, B=2, host-boundary write-backs
  (``ensemble_writeback_free`` over elastic stacks): the victim arc plus wire joins
  (node omitted), tenant 0 promoted to twice its rows through the
  checkpoint path, then a kill and two more joins.
- ``rapid``: Rapid at n=16, B=2: a kill in each tenant.
"""

from __future__ import annotations

#: The victim tenant's arc: a kill, a user-gossip injection, the restart.
VICTIM = [
    {"kind": "kill", "node": 5, "tick": 2},
    {"kind": "gossip", "node": 3, "slot": 1, "tick": 4},
    {"kind": "restart", "node": 5, "tick": 7},
]
#: Independent neighbour traffic: other nodes and ticks, unscheduled
#: events, and a flood of eight kills.
NEIGHBOURS = {
    1: [{"kind": "kill", "node": 9, "tick": 1}, {"kind": "kill", "node": 2, "tick": 3}],
    2: [{"kind": "gossip", "node": 7, "slot": 0}, {"kind": "restart", "node": 9, "tick": 6}],
    3: [{"kind": "kill", "node": i} for i in range(8)],
}


def _tag(events, tenant):
    return [dict(e, tenant=tenant) for e in events]


def _arc(tenants):
    evs = _tag(VICTIM, 0)
    for t in tenants:
        evs += _tag(NEIGHBOURS[t], t)
    return evs


FLEET_SCENARIOS = {
    "sparse": {
        "engine": "sparse", "n": 16, "s": 64, "pallas_core": False, "in_scan_writeback": True,
        "fleet_size": 4, "batch_ticks": 4, "capacity": 2,
        "steps": [
            ("replay", _arc((1, 2, 3)), 12),
            ("evict", 3),
            ("admit", 5),
            ("replay", [{"kind": "kill", "node": 11, "tick": 14, "tenant": 0},
                        {"kind": "kill", "node": 2, "tick": 2, "tenant": 5},
                        {"kind": "gossip", "node": 6, "slot": 2, "tick": 5, "tenant": 5},
                        {"kind": "restart", "node": 2, "tick": 6, "tenant": 5}], 8),
        ],
        "solo": {0: 0, 1: 1, 5: 3},
    },
    "kernel": {
        "engine": "sparse", "n": 64, "s": 128, "pallas_core": True, "in_scan_writeback": False,
        "fleet_size": 2, "batch_ticks": 4, "capacity": 2,
        "steps": [
            ("replay", _arc((1,)), 8),
            ("evict", 1),
            ("admit", 2),
            ("replay", [{"kind": "kill", "node": 11, "tick": 10, "tenant": 0},
                        {"kind": "kill", "node": 2, "tick": 2, "tenant": 2},
                        {"kind": "gossip", "node": 6, "slot": 2, "tick": 3, "tenant": 2}], 8),
        ],
        "solo": {0: 0, 2: 1},
    },
    "knobbed": {
        "engine": "sparse", "n": 16, "s": 64, "pallas_core": False, "in_scan_writeback": True,
        "fleet_size": 3, "batch_ticks": 4, "capacity": 2, "knobs": True,
        "steps": [
            ("admit", 0),
            ("knob", 0, {"suspicion_mult": 2.0}),
            ("replay", _arc((1,)), 8),
        ],
        "solo": {0: 0, 1: 1},
    },
    "elastic": {
        "engine": "sparse-elastic", "n": 16, "s": 64, "pallas_core": False,
        "in_scan_writeback": False, "fleet_size": 2, "batch_ticks": 4, "capacity": 2,
        "steps": [
            ("replay", _arc((1,)) + [{"kind": "join", "tenant": 0}] * 3
             + [{"kind": "join", "tenant": 1}], 8),
            ("promote", 0, None),
            ("replay", [{"kind": "kill", "node": 1, "tick": 10, "tenant": 0},
                        {"kind": "join", "tick": 9, "tenant": 0},
                        {"kind": "join", "tick": 10, "tenant": 0}], 4),
        ],
        "solo": {0: 0, 1: 1},
    },
    "rapid": {
        "engine": "rapid", "n": 16, "fleet_size": 2, "batch_ticks": 4, "capacity": 2,
        "steps": [
            ("replay", [{"kind": "kill", "node": 3, "tick": 2, "tenant": 0},
                        {"kind": "kill", "node": 7, "tick": 1, "tenant": 1}], 8),
        ],
        "solo": {0: 0, 1: 1},
    },
}


def scenario(name: str, **sizes) -> dict:
    """The scenario's entry with ``sizes`` (``n``, ``s``, ``fleet_size``,
    ``pallas_core``, ...) replacing its own. A larger ``fleet_size`` admits
    tenants 10, 11, ... in the added slots from the start, with the
    neighbours' traffic of tenants 1-3 in turn (Rapid: one kill each)."""
    sc = dict(FLEET_SCENARIOS[name], **sizes)
    extra = sc["fleet_size"] - FLEET_SCENARIOS[name]["fleet_size"]
    if extra > 0:
        steps = list(sc["steps"])
        op, evs, ticks = steps[0]
        base = FLEET_SCENARIOS[name]["fleet_size"]
        for t in range(base, base + extra):
            extra_evs = (NEIGHBOURS[1 + (t - 1) % 3] if not sc["engine"].startswith("rapid")
                         else [{"kind": "kill", "node": 4 + t, "tick": 3}])  # no gossip
            evs = evs + _tag(extra_evs, 10 + t - base)
        steps[0] = (op, evs, ticks)
        sc["steps"] = steps
    return sc


def params_of(sc: dict):
    """The scenario's port params."""
    if sc["engine"].startswith("rapid"):
        from scalecube_cluster_tpu_torch.sim.rapid import RapidParams

        return RapidParams(n=sc["n"])
    from scalecube_cluster_tpu_torch.sim.sparse import SparseParams

    return SparseParams.for_n(sc["n"], slot_budget=sc["s"], pallas_core=sc["pallas_core"],
                              in_scan_writeback=sc["in_scan_writeback"])


def drive(fleet, sc: dict, event_from_obj, make_knobs) -> list:
    """Run the scenario's steps on ``fleet`` (either package's FleetBridge).
    ``make_knobs(**kw)`` builds one universe's knob point. Returns every
    round's per-pool traces."""
    out = []
    for step in sc["steps"]:
        op = step[0]
        if op == "replay":
            out += fleet.run_replay([event_from_obj(dict(o)) for o in step[1]], step[2])
        elif op == "evict":
            fleet.evict(step[1])
        elif op == "admit":
            fleet.admit(step[1])
        elif op == "knob":
            fleet.set_tenant_knobs(step[1], make_knobs(**step[2]))
        elif op == "promote":
            fleet.promote_tenant(step[1], n_new=step[2])
        else:
            raise ValueError(f"unknown fleet step {op!r}")
    return out


def fleet_replay(name: str, device, **sizes) -> dict:
    """Run scenario ``name`` through the port's FleetBridge on ``device``.
    Returns ``{"pools": {n: [universe leaves (numpy), ...]}, "traces":
    [[pool traces (numpy), ...] per round], "rows", "counters", "ledger",
    "placement": {tid: (n, slot, ticks_run)}, "fleet"}`` (the fleet closed)."""
    from scalecube_cluster_tpu_torch.serve.fleet import FleetBridge
    from scalecube_cluster_tpu_torch.serve.ingest import event_from_obj
    from scalecube_cluster_tpu_torch.sim.ensemble import index_universe, stack_universes
    from scalecube_cluster_tpu_torch.sim.faults import FaultPlan
    from scalecube_cluster_tpu_torch.sim.knobs import make_knobs
    from scalecube_cluster_tpu_torch.testlib.serving import state_to_numpy

    sc = scenario(name, **sizes)
    params = params_of(sc)
    knobs = None
    if sc.get("knobs"):
        knobs = stack_universes(make_knobs(params.base, device=device)
                                for _ in range(sc["fleet_size"]))
    fleet = FleetBridge(params, engine=sc["engine"], fleet_size=sc["fleet_size"],
                        batch_ticks=sc["batch_ticks"], capacity=sc["capacity"],
                        plan=FaultPlan.uniform(device=device), knobs=knobs, device=device)
    rounds = drive(fleet, sc, event_from_obj,
                   lambda **kw: make_knobs(params.base, device=device, **kw))
    ledger = fleet.assert_fleet_conservation()
    counters = fleet.counters()
    placement = {tid: (s.pool.n, s.slot, s.ticks_run)
                 for tid, s in fleet.tenants.items() if s.placed}
    fleet.close()
    return {
        "pools": {n: [state_to_numpy(index_universe(pool.states, b))
                      for b in range(pool.fleet_size)] for n, pool in fleet.pools.items()},
        "traces": rounds,
        "rows": fleet.rows,
        "counters": counters,
        "ledger": ledger,
        "placement": placement,
        "fleet": fleet,
    }


def solo_replay(name: str, tid: int, device, **sizes) -> dict:
    """Tenant ``tid``'s solo twin: a ServeBridge from its slot's placeholder
    state, fed the tenant's events of every replay step it was placed for
    (its promotions taken at the same boundaries). Returns the final state's
    leaves (numpy)."""
    from scalecube_cluster_tpu_torch.serve import ServeBridge
    from scalecube_cluster_tpu_torch.serve.ingest import event_from_obj
    from scalecube_cluster_tpu_torch.sim.faults import FaultPlan
    from scalecube_cluster_tpu_torch.sim.knobs import make_knobs
    from scalecube_cluster_tpu_torch.testlib.serving import state_to_numpy

    sc = scenario(name, **sizes)
    params = params_of(sc)
    seed = sc["solo"][tid]
    n = sc["n"]
    if sc["engine"].startswith("rapid"):
        from scalecube_cluster_tpu_torch.sim.rapid import init_rapid_full_view

        state = init_rapid_full_view(params, seed=seed, device=device)
    else:
        from scalecube_cluster_tpu_torch.sim.sparse import init_sparse_full_view

        elastic = sc["engine"] == "sparse-elastic"
        state = init_sparse_full_view(n // 2 if elastic else n, sc["s"], seed=seed,
                                      n_alloc=n if elastic else None, device=device)
    plan = FaultPlan.uniform(device=device)
    knobs = None
    bridge = None
    active = False
    for step in sc["steps"]:
        op = step[0]
        if op == "admit" and step[1] == tid:
            active = True
        elif op == "evict" and step[1] == tid:
            active = False
        elif op == "knob" and step[1] == tid:
            knobs = make_knobs(params.base, device=device, **step[2])
        elif op == "promote" and step[1] == tid:
            bridge.promote(step[2])
        elif op == "replay":
            mine = [o for o in step[1] if o.get("tenant", 0) == tid]
            active = active or bool(mine)
            if not active:
                continue
            if bridge is None:
                bridge = ServeBridge(params, state, plan=plan, knobs=knobs,
                                     batch_ticks=sc["batch_ticks"], capacity=sc["capacity"],
                                     engine=sc["engine"])
            bridge.run_replay([event_from_obj(dict(o)) for o in mine], step[2])
    return state_to_numpy(bridge.state)


def universe_of(result: dict, tid: int) -> dict:
    """Tenant ``tid``'s final leaves from :func:`fleet_replay`'s result."""
    n, slot, _ = result["placement"][tid]
    return result["pools"][n][slot]


#: Row keys whose values are wall-clock readings (beside
#: testlib/serving.py's TIMING_KEYS): launch execution spans, the arrival
#: rate the retune loop watches, and the rates derived from wall time.
FLEET_TIMING_KEYS = frozenset({
    "exec_s", "arrival_rate", "tenant_member_rounds_per_sec", "events_per_sec",
})


def fleet_row_values(row: dict) -> dict:
    """``row`` without wall-clock readings, the per-tenant table included."""
    from scalecube_cluster_tpu_torch.testlib.serving import row_values

    out = {k: v for k, v in row_values(row).items() if k not in FLEET_TIMING_KEYS}
    if "tenants" in out:
        out["tenants"] = {t: row_values(v) for t, v in out["tenants"].items()}
    return out
