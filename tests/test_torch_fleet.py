"""The port's fleet control plane (scalecube_cluster_tpu_torch/serve/fleet.py)
against the JAX package's, on the CPU.

The scenarios of ``testlib/fleet.py`` — the same steps (tenant-tagged wire
events, evictions, admissions, knob points, promotions) and sizes — run
through the reference's ``FleetBridge`` (its vmapped fleet entries on its
own CPU route: the XLA chain, or the Pallas core in interpret mode where
``pallas_core`` and the width allow) and through the port's on the CPU:

- reference parity: every universe of every pool (each state leaf), every
  round's per-pool ``[B, k]`` traces, the export rows (``fleet_batch``,
  ``fleet_promotion``, ``fleet_tenant``, ``fleet``; wall-clock readings
  aside), the counters and the ledger, for a sparse pool with a tenant
  placed at another tick, the fused core with write-backs, knobs, an
  elastic pool with wire joins and a promotion, and Rapid;
- isolation: each checked tenant's universe equals its own solo replay
  through the port's ServeBridge;
- the counterparts of the reference's fleet tests (tests/test_fleet.py):
  admission and eviction ledger, lossless retune, counters schema,
  promotion with zero dropped ticks (replayed and over live TCP), the
  cross-tenant load harness, and "zero recompile", which here reads: the
  aten operations and ``sparse_core`` calls of a launch do not change with
  admissions, evictions and traffic, and tenants at two ticks take one
  core call a tick per tick group;
- the batched tick's gossip and join lanes against per-universe solo
  ticks.

Reference trajectories go through ``testing.py::shared_result``.
Tolerance: none.
"""

import asyncio
import dataclasses

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from scalecube_cluster_tpu.serve.fleet import FleetBridge as JFleet
from scalecube_cluster_tpu.serve.ingest import event_from_obj as j_event
from scalecube_cluster_tpu.sim import ensemble as JE
from scalecube_cluster_tpu.sim.faults import FaultPlan as JPlan
from scalecube_cluster_tpu.sim.knobs import make_knobs as j_make_knobs
from scalecube_cluster_tpu.sim.rapid import RapidParams as JRapidParams
from scalecube_cluster_tpu.sim.sparse import SparseParams as JParams
from scalecube_cluster_tpu_torch.obs.counters import SHARED_COUNTERS
from scalecube_cluster_tpu_torch.serve import EV_JOIN, EV_KILL, FleetBridge, ServeEvent
from scalecube_cluster_tpu_torch.sim import ensemble as TE
from scalecube_cluster_tpu_torch.sim import ensemble_tick as ET
from scalecube_cluster_tpu_torch.sim.convert import sparse_state_to_numpy
from scalecube_cluster_tpu_torch.sim.faults import FaultPlan as TPlan
from scalecube_cluster_tpu_torch.sim.sparse import (
    SparseParams,
    init_sparse_full_view,
    sparse_tick,
)
from scalecube_cluster_tpu_torch.testing import one_cpu_thread, shared_result
from scalecube_cluster_tpu_torch.testlib import fleet as FL
from tests.test_torch_serve import assert_same_arrays, jax_flat

one_cpu_thread()

SCENARIOS = tuple(FL.FLEET_SCENARIOS)


# ------------------------------------------------------------ the reference
def _jax_fleet(name: str) -> dict:
    """testlib/fleet.py's scenario through the reference's FleetBridge."""
    sc = FL.scenario(name)
    if sc["engine"].startswith("rapid"):
        jp = JRapidParams(n=sc["n"])
    else:
        jp = JParams.for_n(sc["n"], slot_budget=sc["s"], pallas_core=sc["pallas_core"],
                           in_scan_writeback=sc["in_scan_writeback"])
    knobs = None
    if sc.get("knobs"):
        knobs = JE.stack_universes(j_make_knobs(jp.base) for _ in range(sc["fleet_size"]))
    fleet = JFleet(jp, engine=sc["engine"], fleet_size=sc["fleet_size"],
                   batch_ticks=sc["batch_ticks"], capacity=sc["capacity"],
                   plan=JPlan.uniform(), knobs=knobs)
    rounds = FL.drive(fleet, sc, j_event, lambda **kw: j_make_knobs(jp.base, **kw))
    ledger = fleet.assert_fleet_conservation()
    counters = fleet.counters()
    placement = {tid: (s.pool.n, s.slot, s.ticks_run)
                 for tid, s in fleet.tenants.items() if s.placed}
    fleet.close()
    return {
        "pools": {n: [jax_flat(JE.index_universe(pool.states, b))
                      for b in range(pool.fleet_size)] for n, pool in fleet.pools.items()},
        "traces": [[{k: np.asarray(v) for k, v in tr.items()} for tr in r] for r in rounds],
        "rows": fleet.rows, "counters": counters, "ledger": ledger, "placement": placement,
    }


def jax_fleet(name: str) -> dict:
    return shared_result(f"test_torch_fleet.jax_fleet.{name!r}", lambda: _jax_fleet(name))


def _port(name: str) -> dict:
    return FL.fleet_replay(name, "cpu")


# ----------------------------------------------------------------- parity
@pytest.mark.parametrize("name", SCENARIOS)
def test_fleet_matches_reference(name):
    """Every universe of every pool, every round's traces, the export rows,
    the counters, the ledger and the placements equal the reference's."""
    ref, port = jax_fleet(name), _port(name)
    assert ref["placement"] == port["placement"] and ref["ledger"] == port["ledger"]
    assert sorted(ref["pools"]) == sorted(port["pools"])
    for n in ref["pools"]:
        for b, (a, c) in enumerate(zip(ref["pools"][n], port["pools"][n])):
            assert_same_arrays(a, c, (name, n, b))
    assert len(ref["traces"]) == len(port["traces"])
    for i, (a, c) in enumerate(zip(ref["traces"], port["traces"])):
        assert len(a) == len(c)
        for j, (x, y) in enumerate(zip(a, c)):
            assert_same_arrays(x, y, (name, "round", i, "pool", j))
    assert [r["kind"] for r in ref["rows"]] == [r["kind"] for r in port["rows"]]
    for a, c in zip(ref["rows"], port["rows"]):
        assert FL.fleet_row_values(a) == FL.fleet_row_values(c), (name, a["kind"])
    assert ref["counters"] == port["counters"]


@pytest.mark.parametrize("name", SCENARIOS)
def test_fleet_tenant_equals_solo_replay(name):
    """Isolation: each checked tenant's universe equals its solo replay
    (the promoted elastic tenant's solo session promoted at the same
    boundary; tenant 5 of ``sparse`` placed into a scrubbed slot at tick 0
    beside tenants at tick 12)."""
    port = _port(name)
    for tid in FL.FLEET_SCENARIOS[name]["solo"]:
        assert_same_arrays(FL.solo_replay(name, tid, "cpu"), FL.universe_of(port, tid),
                           (name, tid))
    if name == "sparse":
        assert port["placement"][5] == (16, 3, 8) and port["placement"][0] == (16, 0, 20)


# ---------------------------------------------------- the batched lanes
@pytest.mark.parametrize("route", ["xla", "kernel"])
def test_batched_tick_lanes_match_solo_ticks(route):
    """The batched sparse tick's kill, restart, gossip and join lanes over
    three elastic universes equal each universe's solo tick, state and
    metrics (``n_live`` and ``joins_admitted`` per universe), tick by tick
    through FD, SYNC and write-back ticks."""
    b, na, nl, s = 3, 64, 48, 128
    p = SparseParams.for_n(na, slot_budget=s, pallas_core=route == "kernel",
                           in_scan_writeback=True)
    plan = TPlan.uniform(5.0, device="cpu")
    solo = [init_sparse_full_view(nl, s, seed=u, n_alloc=na, device="cpu") for u in range(b)]
    st = TE.stack_universes(init_sparse_full_view(nl, s, seed=u, n_alloc=na, device="cpu")
                            for u in range(b))
    rng = np.random.default_rng(3)
    g = st.useen.shape[2]
    for t in range(24):
        kill = torch.from_numpy(rng.uniform(size=(b, na)) < 0.02)
        restart = torch.from_numpy(rng.uniform(size=(b, na)) < 0.02)
        gossip = torch.from_numpy(rng.uniform(size=(b, na, g)) < 0.05)
        join = torch.zeros((b, na), dtype=torch.bool)
        join[t % b, nl + t // b] = True
        st, m = ET.ensemble_sparse_tick(p, st, TE.expand_plan(plan, b),
                                        events=(kill, restart, gossip, join))
        for u in range(b):
            solo[u], mu = sparse_tick(p, solo[u], plan,
                                      events=(kill[u], restart[u], gossip[u], join[u]))
            for k in mu:
                assert torch.equal(mu[k], m[k][u]), (t, u, k)
    for u in range(b):
        assert_same_arrays(sparse_state_to_numpy(solo[u]),
                           sparse_state_to_numpy(TE.index_universe(st, u)), u)
    assert m["n_live"].tolist() == [int(x.live_mask.sum()) for x in solo]


# ----------------------------------------------------------- launch work
class _OpCount(TorchDispatchMode):
    """Counts the aten operations that do work (views excluded)."""

    def __init__(self):
        super().__init__()
        self.count = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not func.is_view:
            self.count += 1
        return func(*args, **(kwargs or {}))


def _launch_work(engine, traffic, occupancy, monkeypatch):
    """Per launch: the aten operations of the fleet entry and its core
    calls, for the reference's zero-recompile sequence (admit 0 + traffic,
    admit 1 + traffic, evict 0, admit 2 + traffic), with or without the
    traffic and with or without the admissions and the eviction."""
    elastic = engine == "sparse-elastic"
    p = SparseParams.for_n(64, slot_budget=128, pallas_core=True, in_scan_writeback=False)
    fleet = FleetBridge(p, engine=engine, fleet_size=3, batch_ticks=3, capacity=2,
                        device="cpu")
    work = []
    calls = [0]
    core = ET.sparse_core

    def counted(*a, **kw):
        calls[0] += 1
        return core(*a, **kw)

    monkeypatch.setattr(ET, "sparse_core", counted)
    runner = fleet.base_pool.spec.fleet_runner

    def measured(*a, **kw):
        calls[0] = 0
        with _OpCount() as ops:
            out = runner(*a, **kw)
        work.append((ops.count, calls[0]))
        return out

    fleet.base_pool.spec = dataclasses.replace(fleet.base_pool.spec, fleet_runner=measured)

    def ev(tid, kind, node):
        return [ServeEvent(kind=kind, node=node, tenant=tid)] if traffic else []

    lane = EV_JOIN if elastic else EV_KILL
    for tid, node in ((0, -1 if elastic else 1), (1, -1 if elastic else 2)):
        if occupancy:
            fleet.admit(tid)
        fleet.run_replay(ev(tid, lane, node) if occupancy else [], 9)
    if occupancy:
        fleet.evict(0)
        fleet.admit(2)
    fleet.run_replay(ev(2, lane, -1 if elastic else 3) if occupancy else [], 9)
    return work


@pytest.mark.parametrize("engine", ["sparse", "sparse-elastic"])
def test_fleet_launch_work_independent_of_traffic(engine, monkeypatch):
    """The zero-recompile counterpart: a launch's aten operations and core
    calls are the same with and without traffic, and with and without
    admissions until the eviction; the eviction scrubs a slot back to tick
    0, so from then on every tick takes one core call per tick group
    (two), as the reference's one vmapped call steps both."""
    full = _launch_work(engine, True, True, monkeypatch)
    quiet = _launch_work(engine, False, True, monkeypatch)
    empty = _launch_work(engine, False, False, monkeypatch)
    assert len(full) == len(quiet) == len(empty) == 9
    assert full == quiet
    assert full[:6] == empty[:6]
    assert [c for _, c in full] == [3] * 6 + [6] * 3
    assert [c for _, c in empty] == [3] * 9


def test_mixed_tick_pool_core_calls(monkeypatch):
    """A pool whose tenants run at two ticks (a tenant placed into a
    scrubbed slot) steps as one batched tick per tick group: two core calls
    a tick, each over its group's universes, and every tenant still equals
    its solo replay (test_fleet_tenant_equals_solo_replay, ``kernel``)."""
    core = ET.sparse_core
    widths = []

    def counted(slab, *a, **kw):
        widths.append(int(slab.shape[0]))
        return core(slab, *a, **kw)

    monkeypatch.setattr(ET, "sparse_core", counted)
    sc = FL.scenario("kernel", fleet_size=3)
    res = FL.fleet_replay("kernel", "cpu", fleet_size=3)
    first, second = sc["steps"][0][2], sc["steps"][-1][2]
    assert widths[:first] == [3] * first
    assert widths[first:] == [1, 2] * second  # the lower tick group first
    # Slot 1 was scrubbed to tick 0 after the first step; 0 and 2 ran on.
    assert res["fleet"].base_pool.base_ticks == [first + second, second, first + second]


# ------------------------------------------------- the reference's tests
def _params(pallas=False):
    return SparseParams.for_n(16, slot_budget=64, pallas_core=pallas)


def test_fleet_admission_ledger_deferred_never_dropped():
    """Past capacity, tenants DEFER (their traffic buffering losslessly)
    under requested == placed + pending + deferred + evicted; an eviction
    re-offers the slot FIFO and the parked tenant's events are served."""
    fleet = FleetBridge(_params(), engine="sparse", fleet_size=2, batch_ticks=4, capacity=2,
                        device="cpu")
    evs = [ServeEvent(kind=EV_KILL, node=t + 1, tenant=t) for t in range(4)]
    fleet.run_replay(evs, 4)
    led = fleet.assert_fleet_conservation()
    assert led == {"requested": 4, "placed": 2, "pending": 0, "deferred": 2, "evicted": 0}
    assert len(fleet.tenants[2].batcher) == 1
    fleet.evict(0)
    led = fleet.assert_fleet_conservation()
    assert led["evicted"] == 1 and led["placed"] == 2 and led["deferred"] == 1
    assert fleet.tenants[2].placed
    fleet.run_replay([], 4)
    assert fleet.tenants[2].events_served == 1
    summary = fleet.close()
    assert summary["ledger"]["evicted"] == 1
    assert summary["counters"]["tenant_evictions"] == 1
    assert summary["counters"]["tenants_deferred"] == 1


def test_fleet_retune_lossless():
    """A (k, C) retune re-pins the launch geometry mid-session: pending
    events re-pack under the new shape and every event is still served."""
    fleet = FleetBridge(_params(), engine="sparse", fleet_size=2, batch_ticks=2, capacity=1,
                        device="cpu")
    evs = [ServeEvent(kind=EV_KILL, node=i, tick=1, tenant=0) for i in range(6)]
    fleet.run_replay(evs, 2)
    assert len(fleet.tenants[0].batcher) > 0
    fleet.retune(4, 4)
    fleet.run_replay([], 4)
    assert len(fleet.tenants[0].batcher) == 0
    assert fleet.tenants[0].events_served == 6
    assert fleet.retunes == 1
    assert any(r["kind"] == "retune" for r in fleet.rows)
    assert int(fleet.base_pool.states.tick[0]) == fleet.base_pool.base_ticks[0] == 6


def test_fleet_counters_schema():
    """Fleet counter totals live on the SHARED_COUNTERS schema: every key
    present, the fleet keys stamped by the host, and the engines' per-tick
    planes carry them as constant 0."""
    fleet = FleetBridge(_params(), engine="sparse", fleet_size=2, batch_ticks=4, capacity=2,
                        device="cpu")
    launches = fleet.run_replay([ServeEvent(kind=EV_KILL, node=1, tenant=0)], 4)
    totals = fleet.counters()
    for key in SHARED_COUNTERS:
        assert key in totals, key
    assert totals["tenants_active"] == 1 and totals["fleet_launches"] == 1
    traces = launches[0][0]
    for key in ("tenants_active", "tenants_deferred", "tenant_evictions", "fleet_launches"):
        assert key in traces and traces[key].shape == (2, 4)
        assert int(np.sum(traces[key])) == 0


def test_fleet_promotion_zero_dropped_ticks():
    """The promotion composes with isolation (test_fleet_tenant_equals_
    solo_replay, ``elastic``): the promoted universe's device tick equals
    its host mirror, for it and for its neighbour, and the ledger holds."""
    res = _port("elastic")
    fleet = res["fleet"]
    led = fleet.assert_fleet_conservation()
    assert led["pending"] == 0 and led["placed"] == 2
    session = fleet.tenants[0]
    assert session.promotions == 1 and session.n == 32
    for sess in fleet.tenants.values():
        pool = sess.pool
        assert int(pool.states.tick[sess.slot]) == pool.base_ticks[sess.slot]
    promo = [r for r in fleet.rows if r["kind"] == "fleet_promotion"]
    assert len(promo) == 1 and promo[0]["n_to"] == 32


async def test_fleet_live_tcp_promotion_zero_dropped_ticks():
    """A live multi-tenant TCP session (tenant field on the wire) completes
    a per-tenant capacity promotion with zero dropped ticks, the fleet
    ledger asserted at every launch boundary, both tenants' events
    served."""
    from scalecube_cluster_tpu_torch.cluster_api.config import TransportConfig
    from scalecube_cluster_tpu_torch.serve.ingest import SERVE_QUALIFIER
    from scalecube_cluster_tpu_torch.transport.message import Message
    from scalecube_cluster_tpu_torch.transport.tcp import TcpTransport

    fleet = FleetBridge(_params(), engine="sparse-elastic", fleet_size=2, batch_ticks=4,
                        capacity=4, auto_promote=True, device="cpu")
    free_rows = int((~fleet.base_pool._placeholder(0).live_mask).sum())
    server = await TcpTransport.bind(TransportConfig(connect_timeout=1000))
    client = await TcpTransport.bind(TransportConfig(connect_timeout=1000))
    try:
        want = 1 + free_rows + 3

        def done():
            return (sum(s.batcher.pushed_total for s in fleet.tenants.values()) >= want
                    and len(fleet.router) == 0
                    and any(s.promotions for s in fleet.tenants.values()))

        live = asyncio.ensure_future(fleet.run_live(server, settle_s=0.02, stop_when=done))
        await asyncio.sleep(0.05)

        async def send(data):
            await client.send(server.address, Message.create(
                qualifier=SERVE_QUALIFIER, data=data, sender=client.address))

        await send({"kind": "kill", "node": 2, "tenant": 1})
        for _ in range(free_rows + 3):
            await send({"kind": "join", "tenant": 0})
        await asyncio.wait_for(live, timeout=120)
    finally:
        await client.stop()
        await server.stop()
    session = fleet.tenants[0]
    assert session.promotions >= 1 and session.n > 16
    assert len(session.batcher.deferred_joins) == 0
    session.batcher.assert_join_conservation()
    assert fleet.assert_fleet_conservation()["pending"] == 0
    for tid, sess in fleet.tenants.items():
        assert int(sess.pool.states.tick[sess.slot]) == sess.pool.base_ticks[sess.slot], tid
    assert fleet.tenants[1].events_served == 1


async def test_fleet_load_cross_tenant_isolation():
    """One tenant's hostile producers cannot degrade another tenant's SLO
    row or the fleet ledger: the victims' conservation is exact with zero
    shed, the hostile tenant's rejects are counted, never served (the
    reference test's settings)."""
    from scalecube_cluster_tpu_torch.serve.load import run_fleet_load

    audit = await asyncio.wait_for(run_fleet_load(
        n=16, slot_budget=64, tenants=3, hostile_tenants=1, hostile_producers=5,
        events_per_producer=60, batch_ticks=4, capacity=16, accept_idle_timeout_ms=400,
        deadline_s=120.0, seed=7, device="cpu",
    ), timeout=240)
    assert audit["errors"] == []
    assert audit["victims_clean"], audit["tenant_audits"]
    led = audit["ledger"]
    assert led["requested"] == led["placed"] + led["pending"] + led["deferred"] + led["evicted"]
    assert audit["row"]["rejected"] == audit["row"]["events_injected_malformed"]
    for t in (0, 1):
        a = audit["tenant_audits"][t]
        assert a["conservation_ok"] and a["shed"] == 0 and a["pending"] == 0
        assert a["served"] == a["pushed"]
        trow = audit["fleet"].tenant_row(t)
        assert trow["latency_ms_p99"] >= trow["latency_ms_p50"] >= 0.0


def test_fleet_entries_refuse_mismatched_states():
    """The elastic entry takes elastic stacks and the fixed-shape entry
    fixed-shape ones; traced stacks are refused; the shared plan is an
    expanded view, not B copies."""
    from scalecube_cluster_tpu_torch.serve.engine import (
        run_fleet_serve_batch,
        run_fleet_serve_batch_elastic,
    )
    from scalecube_cluster_tpu_torch.serve.events import empty_batch, stack_batches

    p = _params()
    batch = stack_batches([empty_batch(2, 2)] * 2)
    fixed = TE.init_ensemble_sparse(16, range(2), slot_budget=64, device="cpu")
    elastic = TE.init_ensemble_sparse(8, range(2), slot_budget=64, n_alloc=16, device="cpu")
    plan = TPlan.uniform(device="cpu")
    with pytest.raises(ValueError, match="elastic"):
        run_fleet_serve_batch_elastic(p, fixed, plan, batch)
    with pytest.raises(ValueError, match="elastic"):
        run_fleet_serve_batch(p, elastic, plan, batch)
    traced = TE.init_ensemble_sparse(16, range(2), slot_budget=64, trace_capacity=64,
                                     device="cpu")
    with pytest.raises(NotImplementedError, match="A9"):
        run_fleet_serve_batch(p, traced, plan, batch)
    shared = TE.expand_plan(plan, 4)
    assert shared.loss.shape == (4, 1, 1) and shared.loss.stride()[0] == 0
    states, traces = run_fleet_serve_batch(p, fixed, plan, batch)
    assert traces["tick"].shape == (2, 2) and traces["plan_dirty"].shape == (2, 2)


def test_promotion_keeps_the_rows_of_queued_joins():
    """A promotion taken while admitted joins are still queued (ten joins
    at two a tick into eight free rows: two park, the promotion comes after
    the first tick) keeps the tenant's allocator, so every admitted join
    activates its own row: n_live 8 + 10 and the ledger's 10 placed. (The
    reference's allocator restarts at the promoted state's first free row
    and ends at 16 live; ROADMAP Queue C.)"""
    from scalecube_cluster_tpu_torch.serve.ingest import event_from_obj

    fleet = FleetBridge(_params(), engine="sparse-elastic", fleet_size=2, batch_ticks=1,
                        capacity=2, auto_promote=True, device="cpu")
    fleet.admit(0)
    fleet.admit(1)
    for _ in range(10):
        fleet.router.push(event_from_obj({"kind": "join", "tenant": 0}))
    rounds = 0
    while len(fleet.router) or fleet.tenants[0].batcher.deferred_joins:
        fleet.step_fleet()
        rounds += 1
    session = fleet.tenants[0]
    assert session.promotions == 1 and session.pool.n == 32 and rounds == 5
    assert session.batcher.join_ledger()["placed"] == 10
    live = session.pool.states.live_mask[session.slot]
    assert int(live.sum()) == 18 and bool(live[:18].all())
