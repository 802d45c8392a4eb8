"""The port's serving plane (scalecube_cluster_tpu_torch/serve/) against the
JAX package's, on the CPU.

The scenarios of ``testlib/serving.py`` — the same wire events, launch
geometry and sizes — run through the reference's ``ServeBridge`` (its own
CPU route: the XLA chain, or the Pallas core in interpret mode where
``pallas_core`` and the width allow) and through the port's on the CPU:

- replay parity: every state leaf after the session (the flight recorder's
  ring and the Rapid fallback plane included) and every launch's traces,
  key for key, for a clean session, kills and restarts through the fused
  core with host-boundary write-backs, user gossip, knobs, an elastic
  session with wire joins and ``promote()``, and Rapid with a join;
- the export rows (``serve_batch``, ``promotion``, ``serve``), the
  ``serve_live`` row and the counters, key for key, and value for value
  apart from wall-clock readings and build identifiers;
- the port's replay against the port's offline FaultSchedule run of the
  same fired events (the serving plane's correctness anchor);
- the event masks' padding and duplicate cells, row by row and a batch at
  once; the batcher's policies, overflow and join ledger on identical
  event streams; the engine registry.

Each reference session is run by the one test that reads it. Tolerance:
none.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from scalecube_cluster_tpu import serve as JS
from scalecube_cluster_tpu.serve import events as JEV
from scalecube_cluster_tpu.serve import ingest as JI
from scalecube_cluster_tpu.serve import spec as JSPEC
from scalecube_cluster_tpu.sim.faults import FaultPlan as JPlan
from scalecube_cluster_tpu.sim.knobs import make_knobs as j_make_knobs
from scalecube_cluster_tpu.sim.rapid import init_rapid_full_view as j_init_rapid
from scalecube_cluster_tpu.sim.sparse import SparseParams as JParams
from scalecube_cluster_tpu.sim.sparse import init_sparse_full_view as j_init_sparse
from scalecube_cluster_tpu.testlib.chaos import rapid_chaos_params
from scalecube_cluster_tpu_torch import serve as TS
from scalecube_cluster_tpu_torch.obs.tracer import RING_FIELDS
from scalecube_cluster_tpu_torch.serve import events as TEV
from scalecube_cluster_tpu_torch.serve import ingest as TI
from scalecube_cluster_tpu_torch.serve import spec as TSPEC
from scalecube_cluster_tpu_torch.testing import one_cpu_thread
from scalecube_cluster_tpu_torch.testlib import serving as SV

one_cpu_thread()

#: The replays held against the reference, grouped by the executable the
#: reference compiles for them (one test each, so one compile a test).
GROUPS = {
    "clean": ("clean",),
    "fused": ("kill-restart", "gossip"),
    "knobbed": ("knobbed",),
    "elastic": ("elastic",),
    "rapid": ("rapid",),
}
OFFLINE = ("clean", "kill-restart", "knobbed", "elastic-ticked", "rapid")


# ------------------------------------------------------------ the reference
def jax_flat(state) -> dict:
    """A reference state's leaves as numpy copies, nested records flattened
    to ``"trace.field"`` / ``"fb.field"`` (testlib/serving.py::state_to_numpy)."""
    out = {}
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if v is None:
            continue
        if f.name == "trace":
            out.update({f"trace.{g}": np.array(getattr(v, g)) for g in RING_FIELDS})
        elif dataclasses.is_dataclass(v):
            out.update({f"{f.name}.{g.name}": np.array(getattr(v, g.name))
                        for g in dataclasses.fields(v)})
        else:
            out[f.name] = np.array(v)
    return out


def _jax_session(sc):
    if sc["engine"].startswith("rapid"):
        params = rapid_chaos_params(sc["n"])
        state = j_init_rapid(params, seed=sc["seed"], fallback=True)
        return params, state, JPlan.clean(sc["n"]), None
    params = JParams.for_n(sc["n"], slot_budget=sc["s"], pallas_core=sc["pallas_core"],
                           in_scan_writeback=sc["in_scan_writeback"])
    n_live = sc.get("n_live", sc["n"])
    state = j_init_sparse(n_live, sc["s"], n_alloc=sc["n"] if n_live != sc["n"] else None,
                          trace_capacity=sc.get("trace_capacity", 0))
    knobs = sc.get("knobs")
    if knobs is not None:
        knobs = j_make_knobs(params.base, **knobs)
    return params, state, JPlan.uniform(), knobs


def jax_replay(name: str) -> dict:
    """testlib/serving.py::serve_replay through the reference's bridge."""
    sc = SV.scenario(name)
    params, state, plan, knobs = _jax_session(sc)
    bridge = JS.ServeBridge(params, state, plan=plan, knobs=knobs,
                            batch_ticks=sc["batch_ticks"], capacity=sc["capacity"],
                            engine=sc["engine"])
    if "steps" in sc:
        traces = []
        for step in sc["steps"]:
            if step == "promote":
                bridge.promote()
                continue
            for obj in step:
                bridge.push(JI.event_from_obj(dict(obj)))
            traces.append(bridge.step_batch())
    else:
        traces = bridge.run_replay([JI.event_from_obj(dict(o)) for o in sc["events"]],
                                   sc["ticks"])
    live = bridge.live_metrics()
    counters = bridge.counters()
    bridge.close()
    return {
        "state": jax_flat(bridge.state),
        "traces": [{k: np.asarray(v) for k, v in t.items()} for t in traces],
        "rows": bridge.rows, "live": live, "counters": counters,
    }


def _port(name: str) -> dict:
    return SV.serve_replay(name, "cpu")


def assert_same_arrays(a: dict, b: dict, where):
    assert set(a) == set(b), (where, sorted(set(a) ^ set(b)))
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, (where, k, x.dtype, y.dtype)
        bits = [np.ascontiguousarray(v).reshape(-1).view(np.uint8) for v in (x, y)]
        assert np.array_equal(*bits), (where, k)


def _rows_equal(a: dict, b: dict, where):
    assert set(a) == set(b), (where, sorted(set(a) ^ set(b)))
    assert SV.row_values(a) == SV.row_values(b), where


# ----------------------------------------------------------------- parity
@pytest.mark.parametrize("group", sorted(GROUPS))
def test_replay_matches_reference(group):
    """Each scenario of the group (one reference executable): every state
    leaf after the session, every launch's traces, the export rows, the
    live row and the counters."""
    for name in GROUPS[group]:
        ref, port = jax_replay(name), _port(name)
        assert_same_arrays(ref["state"], port["state"], (name, "state"))
        assert len(ref["traces"]) == len(port["traces"])
        for i, (a, b) in enumerate(zip(ref["traces"], port["traces"])):
            assert_same_arrays(a, b, (name, "launch", i))
        assert [r["kind"] for r in ref["rows"]] == [r["kind"] for r in port["rows"]]
        for i, (a, b) in enumerate(zip(ref["rows"], port["rows"])):
            _rows_equal(a, b, (name, i, a["kind"]))
        _rows_equal(ref["live"], port["live"], (name, "live"))
        assert ref["counters"] == port["counters"], name
        fired = SV.concat_traces(port["traces"])
        if name == "kill-restart":
            # The duplicate kill cell fires once; the third tick-5 event
            # slid to tick 6 and was counted.
            assert int(fired["kills_fired"].sum()) == 4
            assert fired["ingest_overflow"].tolist()[4] == 1
        if name == "gossip":
            # The duplicate (member, slot) cell sets one bit.
            assert int(fired["gossip_fired"].sum()) == 3
        if name == "elastic":
            assert port["counters"]["promotions"] == 1 and port["counters"]["n_live"] == 38


@pytest.mark.parametrize("name", OFFLINE)
def test_replay_matches_offline_run(name):
    """The bridge's session equals the engine's offline run of the same
    fired events as a FaultSchedule: every leaf, and every trace key the
    offline runner has (``ingest_overflow`` carries the batcher's
    deferrals, the offline run's are zero)."""
    port = _port(name)
    off = SV.offline_run(name, "cpu")
    assert_same_arrays(off["state"], port["state"], (name, "state"))
    tr = SV.concat_traces(port["traces"])
    assert set(tr) - set(off["traces"]) <= {"gossip_fired"}
    for k in set(off["traces"]) - {"ingest_overflow"}:
        assert np.array_equal(off["traces"][k], tr[k]), (name, k)
    assert int(tr["ingest_overflow"].sum()) == port["rows"][-1]["ingest_overflow"]


# ----------------------------------------------------------------- masks
def _mask_rows():
    """Batch rows with a padding cell after a real event on row 0,
    duplicate cells on one row and one (row, slot) cell, every kind, and
    an all-padding row."""
    node = np.array([[0, -1, 3, 3, -1, 7],
                     [5, 5, 0, -1, 2, 2],
                     [-1, -1, -1, -1, -1, -1]], np.int32)
    kind = np.array([[0, 0, 1, 1, 2, 3],
                     [2, 2, 0, 0, 3, 3],
                     [0, 1, 2, 3, 0, 1]], np.int32)
    arg = np.array([[0, 0, 0, 0, 1, 0],
                    [1, 1, 0, 0, 0, 0],
                    [0, 0, 0, 0, 0, 0]], np.int32)
    return node, kind, arg


def test_event_masks_padding_and_duplicates():
    """Each mask function, row by row and on the whole [k, C] batch, equals
    the reference's scatter-max: a padding cell (node -1, clipped to row 0)
    never clears row 0's kill, duplicate cells set one bit."""
    n, g = 8, 2
    node, kind, arg = _mask_rows()
    t = [torch.from_numpy(x) for x in (node, kind, arg)]
    batch = {
        "sparse": TEV.event_masks(*t, n, g),
        "elastic": TEV.event_masks_elastic(*t, n, g),
        "rapid": TEV.event_masks_rapid(t[0], t[1], n),
    }
    for r in range(node.shape[0]):
        row = [jnp.asarray(x[r]) for x in (node, kind, arg)]
        want = {
            "sparse": JEV.event_masks(*row, n, g),
            "elastic": JEV.event_masks_elastic(*row, n, g),
            "rapid": JEV.event_masks_rapid(row[0], row[1], n),
        }
        one = {
            "sparse": TEV.event_masks(*(x[r] for x in t), n, g),
            "elastic": TEV.event_masks_elastic(*(x[r] for x in t), n, g),
            "rapid": TEV.event_masks_rapid(t[0][r], t[1][r], n),
        }
        for lane in want:
            for j, (w, a, b) in enumerate(zip(want[lane], one[lane], batch[lane])):
                w = np.asarray(w)
                assert np.array_equal(w, a.numpy()), (r, lane, j)
                assert np.array_equal(w, b[r].numpy()), (r, lane, j)
    kill0 = TEV.event_masks(*(x[0] for x in t), n, g)[0]
    assert bool(kill0[0]) and int(kill0.sum()) == 1


def test_event_batch_host_and_device_forms():
    """``empty_batch`` / ``stack_batches`` equal the reference's numpy
    forms; ``EventBatch.to`` gives int32 tensors of the same values."""
    a, b = TEV.empty_batch(3, 2), TEV.empty_batch(3, 2)
    b.node[1, 0], b.kind[1, 0], b.deferred[2] = 4, TEV.EV_GOSSIP, 1
    ja, jb = JEV.empty_batch(3, 2), JEV.empty_batch(3, 2)
    jb.node[1, 0], jb.kind[1, 0], jb.deferred[2] = 4, JEV.EV_GOSSIP, 1
    got, want = TEV.stack_batches([a, b]), JEV.stack_batches([ja, jb])
    for f in ("node", "kind", "arg", "deferred"):
        assert np.array_equal(getattr(got, f), getattr(want, f)) and getattr(got, f).dtype == np.int32
    dev = b.to("cpu")
    assert all(getattr(dev, f).dtype == torch.int32 for f in ("node", "kind", "arg", "deferred"))
    assert np.array_equal(dev.node.numpy(), b.node) and dev.to("cpu").node is dev.node
    with pytest.raises(ValueError, match="geometry"):
        TEV.stack_batches([a, TEV.empty_batch(4, 2)])


# ----------------------------------------------------------------- batcher
def _stream():
    """One event stream of every wire kind, targeted and ASAP, with ticks
    already passed and out of order."""
    objs = [{"kind": "kill", "node": 3, "tick": 2}, {"kind": "gossip", "node": 1, "slot": 1},
            {"kind": "restart", "node": 3, "tick": 5}, {"kind": "leave", "node": 6, "tick": 2},
            {"kind": "kill", "node": 7, "tick": 2}, {"kind": "join", "node": 2},
            {"kind": "gossip", "node": 0, "slot": 0, "tick": 1}]
    return [dict(o) for o in objs * 3]


def _batcher_run(mod, policy, engine, admit_rows):
    rows = iter(range(admit_rows)) if admit_rows is not None else None

    def admit(ev):
        return next(rows, None)

    b = mod.EventBatcher(8, 2, 3, 2, max_pending=6, low_watermark=2, overflow_policy=policy,
                         engine=engine, legacy_join=admit_rows is None and engine == "swim",
                         admit=admit if admit_rows is not None else None)
    log = []
    for obj in _stream():
        if engine == "rapid" and obj["kind"] == "gossip":
            continue
        try:
            b.push(mod.event_from_obj(obj), stamp=False)
            log.append("ok")
        except mod.BatcherFull:
            batch, stats = b.next_batch(len(log))
            log.append(([np.asarray(getattr(batch, f)).tolist()
                         for f in ("node", "kind", "arg", "deferred")],
                        {k: v for k, v in stats.items() if not k.startswith("t_")
                         and k != "oldest_ingest"}))
    while len(b):
        batch, stats = b.next_batch(100 + len(log))
        log.append([np.asarray(batch.node).tolist(), stats["n_deferred"]])
    ledger = b.join_ledger() if admit_rows is not None else None
    return log, ledger, (b.pushed_total, b.shed_total, b.overflow_total, b.peak_pending,
                         b.backpressure_total, len(b.deferred_joins))


@pytest.mark.parametrize(
    "policy,engine,admit_rows",
    [("defer", "swim", None), ("shed-oldest", "swim", None), ("defer", "rapid", None),
     ("defer", "swim", 2)],
    ids=["defer", "shed-oldest", "rapid", "join-ledger"],
)
def test_batcher_matches_reference(policy, engine, admit_rows):
    """The copied batcher against the reference's on one event stream:
    every batch, its stats, the overflow and shed counts, and the
    admission ledger with two free rows (the rest parked)."""
    assert _batcher_run(TI, policy, engine, admit_rows) == _batcher_run(
        JI, policy, engine, admit_rows)


# ----------------------------------------------------------------- specs
def test_engine_specs_match_reference():
    """The same five names with the same facts, the fleet entries and
    fleet write-backs where the reference has them; inference from a state
    as the reference infers; mesh placement refused until the multi-device
    engine; the package exports the reference's names."""
    assert sorted(TSPEC.ENGINE_SPECS) == sorted(JSPEC.ENGINE_SPECS)
    for name, spec in TSPEC.ENGINE_SPECS.items():
        ref = JSPEC.ENGINE_SPECS[name]
        for f in ("batcher_engine", "elastic", "donates", "promotable", "counter_keys"):
            assert getattr(spec, f) == getattr(ref, f), (name, f)
        for f in ("writeback", "fleet_runner", "fleet_writeback"):
            assert (getattr(spec, f) is None) == (getattr(ref, f) is None), (name, f)
        if ref.fleet_runner is not None:
            assert spec.fleet_runner.__name__ == ref.fleet_runner.__name__, name
    sparse = SV._session(SV.scenario("clean"), "cpu")[1]
    elastic = SV._session(SV.scenario("elastic"), "cpu")[1]
    rapid = SV._session(SV.scenario("rapid"), "cpu")[1]
    assert TSPEC.resolve_engine_spec(None, sparse).name == "sparse"
    assert TSPEC.resolve_engine_spec(None, elastic).name == "sparse-elastic"
    assert TSPEC.resolve_engine_spec(None, rapid).name == "rapid-fallback"
    assert TSPEC.resolve_engine_spec(None, rapid.replace(fb=None)).name == "rapid"
    with pytest.raises(ValueError, match="unknown engine"):
        TSPEC.resolve_engine_spec("fleet")
    with pytest.raises(NotImplementedError, match="A15"):
        TSPEC.ENGINE_SPECS["sparse-gspmd"].place(sparse, mesh=object())
    with pytest.raises(NotImplementedError, match="A15"):
        TS.ServeBridge(SV._session(SV.scenario("clean"), "cpu")[0], sparse, mesh=object())
    assert set(JS.__all__) == set(TS.__all__)
