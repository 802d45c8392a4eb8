"""The port's flight recorder (obs/tracer.py, the sparse tick's emission
block, the traced host ops) against the JAX package's, on the CPU.

``trace_emit`` is held against the reference's on seeded masks (a cap
below the mask size, a ring that fills, an empty mask, masks of two
ranks with broadcast fields); then a traced churn trajectory at n=256,
S=128 on the XLA chain, with host kills and restarts between chunks:
every ring field (ev_kind/tick/actor/subject/cause/aux, cursor, overflow,
last_miss, origin), every state leaf and every counter (``trace_overflow``
included) bit-equal after every chunk. The port's decode and C6 walk give
what the reference's give on the same events. Tolerance: none.
"""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from scalecube_cluster_tpu.obs import trace as JTrace
from scalecube_cluster_tpu.obs import tracer as JTracer
from scalecube_cluster_tpu.sim import sparse as J
from scalecube_cluster_tpu.sim.faults import FaultPlan as JPlan
from scalecube_cluster_tpu.sim.schedule import ScheduleBuilder as JBuilder
from scalecube_cluster_tpu_torch.obs import trace as TTrace
from scalecube_cluster_tpu_torch.obs import tracer as TTracer
from scalecube_cluster_tpu_torch.sim import sparse as T
from scalecube_cluster_tpu_torch.sim.convert import sparse_state_to_numpy
from scalecube_cluster_tpu_torch.sim.faults import FaultPlan as TPlan
from scalecube_cluster_tpu_torch.sim.schedule import ScheduleBuilder as TBuilder
from scalecube_cluster_tpu_torch.testing import one_cpu_thread
from scalecube_cluster_tpu_torch.tools import trace_explain as TX
from tests.test_sparse import sparse_params
from tests.test_torch_sparse import assert_same_traces, port_params
from tools import trace_explain as JX

one_cpu_thread()


def jax_ring(ring) -> dict:
    """A reference ring's fields as numpy arrays (copies)."""
    return {f: np.array(getattr(ring, f)) for f in TTracer.RING_FIELDS}


def jax_full_dict(state) -> dict:
    """A reference sparse state as numpy copies, its ring as a dict of its
    fields: taken before the next run donates the state's buffers."""
    out = {}
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if v is not None:
            out[f.name] = jax_ring(v) if f.name == "trace" else np.array(v)
    return out


def assert_same_ring(a, tring, where):
    a = a if isinstance(a, dict) else jax_ring(a)
    b = TTracer.ring_to_numpy(tring)
    for f in TTracer.RING_FIELDS:
        assert a[f].dtype == b[f].dtype and np.array_equal(a[f], b[f]), (where, f)


def assert_same_full_state(a, ts, where):
    """Every leaf of a reference state (a :func:`jax_full_dict`) and a port
    state or its ``sparse_state_to_numpy`` snapshot, the ring and
    ``live_mask`` included."""
    b = ts if isinstance(ts, dict) else sparse_state_to_numpy(ts)
    assert set(a) == set(b), (where, set(a) ^ set(b))
    for k, v in a.items():
        if k == "trace":
            for f in TTracer.RING_FIELDS:
                assert v[f].dtype == b[k][f].dtype, (where, f)
                assert np.array_equal(v[f], b[k][f]), (where, f)
            continue
        assert v.dtype == b[k].dtype and np.array_equal(v, b[k]), (where, k)


# ------------------------------------------------------------ trace_emit
def _emit_case(name):
    """(capacity, cursor, [(kind, mask, actor, subject, cause, aux)]) on
    seeded masks: a mask larger than the ring (cap < size), calls that
    fill the ring mid-call and then find it full, an all-False mask, and
    an [N, S] mask with [N, 1] / [1, S] / [N, S] fields."""
    rng = np.random.default_rng(7)
    m1 = rng.random(40) < 0.5
    m2 = rng.random((12, 9)) < 0.3
    col = np.arange(12, dtype=np.int32)[:, None]
    row = rng.integers(-1, 50, (1, 9)).astype(np.int32)
    full = rng.integers(0, 3, (12, 9)).astype(np.int32)
    cases = {
        "cap-below-size": (16, 0, [(3, m1, np.arange(40, dtype=np.int32), 5, -1, 0)]),
        "fills-then-full": (24, 10, [(3, m1, 1, np.arange(40, dtype=np.int32), 2, 1),
                                     (4, m1, 2, 3, np.arange(40, dtype=np.int32), 7),
                                     (5, m1, 0, 0, 0, 0)]),
        "zero-mask": (32, 4, [(6, np.zeros(40, bool), 1, 2, 3, 4)]),
        "broadcast-2d": (64, 3, [(8, m2, col, row, row, full), (9, ~m2, col, row, -1, 0)]),
    }
    return cases[name]


@pytest.mark.parametrize("name", ["cap-below-size", "fills-then-full", "zero-mask", "broadcast-2d"])
def test_trace_emit_matches_jax(name):
    """Ring fields and ``ev_pos`` bit-equal after each emission; then a
    host event on the result (recorded, or counted as overflow on a full
    ring)."""
    cap, cursor, calls = _emit_case(name)
    jr = JTracer.init_trace_ring(8, cap).replace(cursor=jnp.asarray(cursor, jnp.int32))
    tr = TTracer.init_trace_ring(8, cap, device="cpu")
    tr = tr.replace(cursor=torch.tensor(cursor, dtype=torch.int32))
    for i, (kind, mask, actor, subject, cause, aux) in enumerate(calls):
        jargs = [jnp.asarray(x) if isinstance(x, np.ndarray) else x
                 for x in (actor, subject, cause, aux)]
        targs = [torch.from_numpy(x) if isinstance(x, np.ndarray) else x
                 for x in (actor, subject, cause, aux)]
        jr, jpos = JTracer.trace_emit(jr, kind, jnp.asarray(mask), 11 + i, *jargs)
        tr, tpos = TTracer.trace_emit(tr, kind, torch.from_numpy(mask), 11 + i, *targs)
        assert np.array_equal(np.asarray(jpos), tpos.numpy()), (name, i)
        assert_same_ring(jr, tr, (name, i))
    jr = JTracer.trace_host_event(jr, 1, 20, -1, 5)
    tr = TTracer.trace_host_event(tr, 1, 20, -1, 5)
    assert_same_ring(jr, tr, (name, "host"))


def test_ring_registers_match_jax():
    """``trace_reset_members`` and ``pad_trace_ring`` (its refusal to
    shrink included); the sharded recorder's init equals the reference's,
    and the single-device tick refuses it as the reference's does."""
    rng = np.random.default_rng(3)
    jr, tr = JTracer.init_trace_ring(16, 8), TTracer.init_trace_ring(16, 8, device="cpu")
    vals = rng.integers(-1, 8, 16).astype(np.int32)
    jr = jr.replace(last_miss=jnp.asarray(vals), origin=jnp.asarray(vals[::-1].copy()))
    tr = tr.replace(last_miss=torch.from_numpy(vals.copy()),
                    origin=torch.from_numpy(vals[::-1].copy()))
    mask = rng.random(16) < 0.4
    jr = JTracer.pad_trace_ring(JTracer.trace_reset_members(jr, jnp.asarray(mask)), 24)
    tr = TTracer.pad_trace_ring(TTracer.trace_reset_members(tr, torch.from_numpy(mask)), 24)
    assert_same_ring(jr, tr, "reset+pad")
    with pytest.raises(ValueError):
        TTracer.pad_trace_ring(tr, 8)
    assert_same_ring(JTracer.init_shard_trace_rings(16, 8, 2),
                     TTracer.init_shard_trace_rings(16, 8, 2, device="cpu"), "sharded init")
    sharded = T.init_sparse_full_view(16, 128, trace_capacity=8, trace_shards=2, device="cpu")
    assert isinstance(sharded.trace, TTracer.ShardTraceRing) and sharded.trace.shards == 2
    with pytest.raises(ValueError, match="ShardTraceRing"):
        T.sparse_tick(port_params(sparse_params(16)), sharded, TPlan.uniform(device="cpu"))
    for bad in ((16, 0, 2), (16, 8, 0)):
        with pytest.raises(ValueError):
            TTracer.init_shard_trace_rings(*bad, device="cpu")


# ------------------------------------------------------ traced trajectory
N, S, CAP = 256, 128, 1 << 14


def _sched(b, plan):
    """Clean for 9 ticks, then 5% loss; kills at 3 and 5, a restart at 25."""
    return (
        b(N).add_segment(1, plan.clean(N)).add_segment(10, plan.uniform(5.0))
        .kill(3, 7).kill(5, N // 2).restart(25, 7).build()
    )


_JAX_RUN = {}


def jax_traced_run():
    """The reference's traced trajectory, cached per module: 3 chunks of
    12 ticks (FD every 2, suspicion 12, SYNC every 10), a host kill after
    chunk 0 and a host restart after chunk 1; (state, traces) after each
    chunk and after each host op."""
    if not _JAX_RUN:
        jp = dataclasses.replace(sparse_params(N, suspicion_ticks=12), slot_budget=S,
                                 in_scan_writeback=False)
        js = J.init_sparse_full_view(N, S, trace_capacity=CAP)
        sched = _sched(JBuilder, JPlan)
        snaps = []
        for c in range(3):
            js, jtr = J.run_sparse_chunked(jp, js, sched, 12, chunk=12)
            snaps.append((jax_full_dict(js), jtr))
            if c == 0:
                js = J.kill_sparse(js, 40)
            elif c == 1:
                js = J.restart_many_sparse(js, [40, 9])
            snaps.append((jax_full_dict(js), None))
        _JAX_RUN.update(jp=jp, snaps=snaps)
    return _JAX_RUN["jp"], _JAX_RUN["snaps"]


def port_traced_run(trace_capacity=CAP):
    """The port's run of :func:`jax_traced_run`'s trajectory: snapshots
    (``sparse_state_to_numpy``: the tick consumes its state) and traces,
    and the final state."""
    jp, _ = jax_traced_run()
    tp = port_params(jp)
    ts = T.init_sparse_full_view(N, S, trace_capacity=trace_capacity, device="cpu")
    sched = _sched(TBuilder, _CpuPlan)
    out = []
    for c in range(3):
        ts, ttr = T.run_sparse_chunked(tp, ts, sched, 12, chunk=12)
        out.append((sparse_state_to_numpy(ts), ttr))
        if c == 0:
            ts = T.kill_sparse(ts, 40)
        elif c == 1:
            ts = T.restart_many_sparse(ts, [40, 9])
        out.append((sparse_state_to_numpy(ts), None))
    return out, ts


class _CpuPlan:
    """The port's FaultPlan builders, on the CPU."""

    @staticmethod
    def clean(n):
        return TPlan.clean(n, device="cpu")

    @staticmethod
    def uniform(loss):
        return TPlan.uniform(loss, device="cpu")


def test_traced_trajectory_matches_jax(tmp_path):
    """Every state leaf, every ring field and every counter after each
    chunk and each traced host op. Then, on the same run: arming the
    recorder changes no state leaf and no counter (the port's run without
    the ring); ``ring_events`` of the port's ring equals the reference's
    decode of its own; every DEAD verdict walks back to a probe (one by
    expiry at least), as the reference's tests/test_tracer.py asserts; the
    JSONL round trip, ``chrome_trace`` and the C6 walk (on the ring and on
    two tampered copies) give what the reference's give."""
    _, snaps = jax_traced_run()
    port, ts = port_traced_run()
    for i, ((jd, jtr), (td, ttr)) in enumerate(zip(snaps, port)):
        assert_same_full_state(jd, td, i)
        if jtr is not None:
            assert "trace_overflow" in ttr
            assert_same_traces(jtr, ttr, i)
    ring = ts.trace
    assert int(ring.cursor) > 0 and int(ring.overflow) == 0

    off, _ = port_traced_run(trace_capacity=0)
    for i, ((a, ttr), (b, otr)) in enumerate(zip(port, off)):
        assert "trace" not in b
        a = dict(a)
        a.pop("trace")
        assert set(a) == set(b)
        assert all(np.array_equal(a[k], b[k]) for k in a), i
        if ttr is not None:
            assert set(ttr) - set(otr) == {"trace_overflow"}
            assert all(np.array_equal(otr[k], ttr[k]) for k in otr), i

    jev = JTrace.ring_events(SimpleNamespace(**snaps[-1][0]["trace"]))
    tev = TTrace.ring_events(ring)
    assert jev == tev
    assert TTrace.ring_overflow(ring) == 0
    kinds = {e["kind"] for e in tev}
    assert {TTrace.TK_KILL, TTrace.TK_RESTART, TTrace.TK_PROBE_SENT,
            TTrace.TK_SUSPECT_START, TTrace.TK_VERDICT_DEAD} <= kinds
    deads = [e for e in tev if e["kind"] == TTrace.TK_VERDICT_DEAD]
    assert any(e["aux"] == TTrace.DEAD_VIA_EXPIRY for e in deads)
    assert TX.check_c6(tev) == [] == JX.check_c6(jev)
    for ev in deads:
        explained = TX.explain_verdict(tev, ev)
        assert explained == JX.explain_verdict(jev, ev)
        assert explained["complete"] and explained["chain"][-1]["kind"] == TTrace.TK_PROBE_SENT
    path = str(tmp_path / "events.jsonl")
    TTrace.write_events_jsonl(path, tev)
    assert TTrace.load_events_jsonl(path) == JTrace.load_events_jsonl(path) == jev
    spans = [{"t0": 1.0, "t1": 1.5, "batch": 0, "base_tick": 0, "batch_ticks": 4,
              "n_events": 3, "ring_occupancy": TTrace.trace_occupancy(ring)}]
    assert TTrace.chrome_trace(tev, spans) == JTrace.chrome_trace(jev, spans)
    t1 = [dict(e) for e in tev]
    t1[deads[0]["i"]]["cause"] = -1
    kill = next(e for e in tev if e["kind"] == TTrace.TK_KILL)
    t2 = [dict(e) for e in tev]
    t2[deads[-1]["i"]]["cause"] = kill["i"]
    for tampered in (t1, t2):
        assert TX.check_c6(tampered) == JX.check_c6(tampered) != []


def test_kernel_route_refuses_the_recorder():
    """A traced state on the kernel route raises, as the reference's gate
    does; the XLA chain (n % 32 != 0 here) takes it."""
    p = T.SparseParams.for_n(64, slot_budget=128, in_scan_writeback=False, pallas_core=True)
    st = T.init_sparse_full_view(64, 128, trace_capacity=64, device="cpu")
    with pytest.raises(ValueError, match="XLA tick core"):
        T.sparse_tick(p, st, TPlan.uniform(0.0, device="cpu"))
    p40 = T.SparseParams.for_n(40, slot_budget=128, in_scan_writeback=False, pallas_core=True)
    st40 = T.init_sparse_full_view(40, 128, trace_capacity=64, device="cpu")
    st40, metrics = T.sparse_tick(p40, st40, TPlan.uniform(0.0, device="cpu"))
    assert int(metrics["trace_overflow"]) == 0
