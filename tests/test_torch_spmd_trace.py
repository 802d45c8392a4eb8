"""The per-shard flight recorder of the port's explicit-SPMD engine
(obs/tracer.py::ShardTraceRing, obs/trace.py::merge_shard_rings) against
the reference's, on the CPU.

n=256, S=128, 30 ticks of a scheduled timeline (kills, a restart, a lossy
and delayed middle segment) under the compressed cadences of
testlib/certify.py, XLA core: at d=4 every ring field of every shard,
every state leaf and every trace key equal to the reference's sharded run,
and the port's merge equal to the reference's merge of the same rings; at
d=1 the ring equal to the reference's single-device ring and the merge to
its decode (but for the ``shard`` column). The merged log walks through
tools/trace_explain.py, cross-shard chains included, and a severed cause
fails it. Tolerance: none.
"""

import dataclasses

import jax
import numpy as np
import pytest

from scalecube_cluster_tpu.obs import trace as JTrace
from scalecube_cluster_tpu.parallel import mesh as JM
from scalecube_cluster_tpu.parallel import spmd as JS
from scalecube_cluster_tpu.sim import FaultPlan as JPlan
from scalecube_cluster_tpu.sim import ScheduleBuilder as JBuilder
from scalecube_cluster_tpu.sim import sparse as J
from scalecube_cluster_tpu.testlib.certify import certify_params
from scalecube_cluster_tpu_torch.obs import trace as TTrace
from scalecube_cluster_tpu_torch.obs import tracer as TTracer
from scalecube_cluster_tpu_torch.parallel import mesh as TM
from scalecube_cluster_tpu_torch.parallel import spmd as TS
from scalecube_cluster_tpu_torch.sim import sparse as T
from scalecube_cluster_tpu_torch.sim.convert import sparse_state_to_numpy
from scalecube_cluster_tpu_torch.sim.faults import FaultPlan as TPlan
from scalecube_cluster_tpu_torch.testing import one_cpu_thread, shared_result
from scalecube_cluster_tpu_torch.tools import trace_explain as TX
from tests.test_torch_rapid import port_schedule
from tests.test_torch_spmd import N, S, TICKS, _jax_spmd, _jparams, _np_state
from tests.test_torch_sparse import port_params
from tests.test_torch_tracer import assert_same_full_state, jax_full_dict

one_cpu_thread()

CAP = 8192


def _sched():
    return (
        JBuilder(N).add_segment(0, JPlan.uniform())
        .add_segment(12, JPlan.uniform(loss_percent=20.0, mean_delay_ms=40.0))
        .add_segment(24, JPlan.uniform())
        .kill(2, 3).kill(3, N // 2).restart(21, 3).build()
    )


def _ref(d):
    """The reference's traced run: the sharded engine at ``d`` shards, or
    (``d`` None) the single-device engine; state leaves (the ring as a dict
    of its fields) and traces."""
    def compute():
        jp = _jparams()
        if d is None:
            st = J.init_sparse_full_view(N, S, seed=3, trace_capacity=CAP)
            out, tr = J.run_sparse_ticks(jp, _np_state(st), _sched(), TICKS, collect=True)
        else:
            st = J.init_sparse_full_view(N, S, seed=3, trace_capacity=CAP, trace_shards=d)
            out, tr = _jax_spmd()(jp, JS.ShardConfig(d), JM.make_mesh(jax.devices()[:d]),
                                  _np_state(st), _sched(), TICKS, collect=True)
        merged = JTrace.merge_shard_rings(out.trace) if d else JTrace.ring_events(out.trace)
        return jax_full_dict(out), {k: np.asarray(v) for k, v in tr.items()}, merged

    return shared_result(f"test_torch_spmd_trace.ref.{d}", compute)


def _port(d, trace=True):
    st = T.init_sparse_full_view(N, S, seed=3, trace_capacity=CAP if trace else 0,
                                 trace_shards=d if trace else 0, device="cpu")
    return TS.run_sparse_ticks_spmd(port_params(_jparams()), TS.ShardConfig(d),
                                    TM.make_mesh(d), st, port_schedule(_sched()), TICKS)


def _assert_traces(jtr, ttr, where):
    assert set(jtr) == set(ttr), (where, set(jtr) ^ set(ttr))
    for k in jtr:
        assert np.array_equal(jtr[k].view(np.uint8), ttr[k].numpy().view(np.uint8)), (where, k)


def test_spmd_trace_d4_matches_jax(tmp_path):
    """d=4: every shard's ring, every leaf and trace key equal to the
    reference's; the merges equal; C6 holds on the merged log, at least one
    DEAD chain crosses shards, and the port's explain CLI passes the file
    and fails it once a cross-shard cause is severed."""
    jd, jtr, jmerged = _ref(4)
    out, tr = _port(4)
    assert isinstance(out.trace, TTracer.ShardTraceRing)
    assert_same_full_state(jd, out, "d=4")
    _assert_traces(jtr, tr, "d=4")
    assert TTrace.ring_overflow(out.trace) == 0
    merged = TTrace.merge_shard_rings(out.trace)
    assert merged == jmerged
    assert {e["shard"] for e in merged} == set(range(4))
    assert TX.check_c6(merged) == []
    deads = [e for e in merged if e["kind"] == TTrace.TK_VERDICT_DEAD]
    assert deads, "no DEAD verdict in the horizon"
    cross = []
    for ev in deads:
        explained = TX.explain_verdict(merged, ev)
        assert explained["complete"], explained["violations"]
        if any(c["shard"] != ev["shard"] for c in explained["chain"]):
            cross.append(ev)
    assert cross, "no cross-shard cause chain"
    good = tmp_path / "merged.jsonl"
    TTrace.write_events_jsonl(str(good), merged)
    assert TX.main([str(good), "--quiet"]) == 0
    bad = [dict(e) for e in merged]
    bad[cross[0]["i"]]["cause"] = -1
    bad_path = tmp_path / "tampered.jsonl"
    TTrace.write_events_jsonl(str(bad_path), bad)
    assert TX.main([str(bad_path), "--quiet"]) == 1


def test_spmd_trace_d1_equals_single_device_ring():
    """d=1: the sharded ring's one row is the reference's single-device
    ring, field by field, and the merge is its decode plus ``shard`` 0;
    the state and traces equal the single-device run's."""
    jd, jtr, jevents = _ref(None)
    out, tr = _port(1)
    local = TTracer.shard_local_ring(out.trace, 0)
    ring = TTracer.ring_to_numpy(local)
    for f in TTracer.RING_FIELDS:
        assert np.array_equal(jd["trace"][f], ring[f]), f
    jd = {k: v for k, v in jd.items() if k != "trace"}
    assert_same_full_state(jd, {k: v for k, v in sparse_state_to_numpy(out).items() if k != "trace"}, "d=1")
    _assert_traces(jtr, tr, "d=1")
    merged = TTrace.merge_shard_rings(out.trace)
    assert [dict(e, shard=0) for e in jevents] == merged


def test_spmd_tracer_is_a_pure_observer():
    """Arming the recorder changes no state leaf and no trace key (it only
    adds ``trace_overflow``)."""
    on, on_tr = _port(4)
    off, off_tr = _port(4, trace=False)
    a, b = sparse_state_to_numpy(on), sparse_state_to_numpy(off)
    assert set(a) - set(b) == {"trace"}
    for k in b:
        assert np.array_equal(a[k], b[k]), k
    assert set(on_tr) - set(off_tr) == {"trace_overflow"}
    for k in off_tr:
        assert np.array_equal(on_tr[k].numpy(), off_tr[k].numpy()), k


def test_merge_passes_a_plain_ring_through():
    ring = TTracer.init_trace_ring(8, 4, device="cpu")
    ring = TTracer.trace_host_event(ring, TTrace.TK_KILL, 1, -1, 3)
    assert TTrace.merge_shard_rings(ring) == [dict(e, shard=0) for e in TTrace.ring_events(ring)]


def test_host_ops_refuse_a_sharded_ring():
    """Host ops record into a single ring only: a sharded recorder takes
    its kills and restarts from the engine's schedule."""
    st = T.init_sparse_full_view(N, S, trace_capacity=64, trace_shards=4, device="cpu")
    with pytest.raises(ValueError, match="ShardTraceRing"):
        T.kill_sparse(st, 3)
    with pytest.raises(ValueError, match="ShardTraceRing"):
        T.restart_many_sparse(st, [3])


def test_spmd_trace_refusals_match_jax():
    """A plain TraceRing, a shard-count mismatch and the kernel route with
    a ring raise the reference's errors."""
    n, d = 128, 2
    jp = dataclasses.replace(certify_params(n), slot_budget=S)
    jmesh = JM.make_mesh(jax.devices()[:d])
    cases = [
        (dict(trace_capacity=256), jp),
        (dict(trace_capacity=256, trace_shards=4), jp),
        (dict(trace_capacity=256, trace_shards=d), dataclasses.replace(jp, pallas_core=True)),
    ]
    for kw, params in cases:
        with pytest.raises(ValueError) as jerr:
            JS.run_sparse_ticks_spmd(params, JS.ShardConfig(d), jmesh,
                                     J.init_sparse_full_view(n, S, **kw), JPlan.uniform(), 2)
        with pytest.raises(ValueError) as terr:
            TS.run_sparse_ticks_spmd(port_params(params), TS.ShardConfig(d),
                                     TM.make_mesh(d),
                                     T.init_sparse_full_view(n, S, device="cpu", **kw),
                                     TPlan.uniform(device="cpu"), 2)
        # The port's kernel is the CUDA one; the text is otherwise the same.
        assert str(terr.value) == str(jerr.value).replace("fused Pallas kernel", "fused kernel")
