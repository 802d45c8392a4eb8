"""The port's per-run knobs against the JAX package, on the CPU.

``make_knobs`` (and its range check), ``suspicion_fill`` and ``edge_live``
equal the reference's; whole trajectories of both engines with knobs (the
unfused cores) equal the reference's after every chunk, every state leaf and
every counter; identity knobs equal ``knobs=None`` bit for bit; knobs with
a fused core raise the reference's error. Tolerance: none.
"""

import dataclasses

import numpy as np
import pytest
import torch

from scalecube_cluster_tpu.sim import knobs as JK
from scalecube_cluster_tpu.sim import run as JR
from scalecube_cluster_tpu.sim import sparse as JS
from scalecube_cluster_tpu.sim import state as JD
from scalecube_cluster_tpu.sim.faults import FaultPlan as JPlan
from scalecube_cluster_tpu_torch.sim import knobs as TK
from scalecube_cluster_tpu_torch.sim import run as TR
from scalecube_cluster_tpu_torch.sim import sparse as TS
from scalecube_cluster_tpu_torch.sim import state as TD
from scalecube_cluster_tpu_torch.sim.convert import sparse_state_to_numpy
from scalecube_cluster_tpu_torch.sim.faults import FaultPlan as TPlan
from tests.test_sparse import sparse_params
from tests.test_torch_dense import assert_same_state as dense_same
from tests.test_torch_dense import assert_same_traces as dense_traces
from tests.test_torch_dense import jax_state_dict as dense_dict
from tests.test_torch_dense import params as dense_params
from tests.test_torch_sparse import assert_same_state, assert_same_traces, port_params
from scalecube_cluster_tpu_torch.testing import one_cpu_thread

one_cpu_thread()

POINTS = [(1.0, None), (0.5, 2), (2.25, 1), (1.7, 0)]


@pytest.mark.parametrize("mult,cap", POINTS)
def test_knob_helpers_match_jax(mult, cap):
    jp, tp = dense_params(64, False)
    jk = JK.make_knobs(jp, mult, cap)
    tk = TK.make_knobs(tp, mult, cap, device="cpu")
    assert np.asarray(jk.suspicion_mult).tobytes() == tk.suspicion_mult.numpy().tobytes()
    assert int(jk.fanout_cap) == int(tk.fanout_cap) and tk.fanout_cap.dtype == torch.int32
    assert int(JK.suspicion_fill(jp.suspicion_ticks, jk)) == int(
        TK.suspicion_fill(tp.suspicion_ticks, tk))
    assert np.array_equal(np.asarray(JK.edge_live(3, jk)), TK.edge_live(3, tk).numpy())
    assert TK.suspicion_fill(7, None) == 7 and TK.edge_live(3, None) is None


def test_make_knobs_range_check_matches_jax():
    jp, tp = dense_params(64, False)
    for cap in (-1, 4):
        with pytest.raises(ValueError) as je:
            JK.make_knobs(jp, 1.0, cap)
        with pytest.raises(ValueError) as te:
            TK.make_knobs(tp, 1.0, cap, device="cpu")
        assert str(je.value) == str(te.value)


def test_knobs_with_fused_cores_raise_like_jax():
    jp, tp = dense_params(64, True)
    st = TD.init_full_view(64, device="cpu")
    seeds = TD.seeds_mask(64, [0], device="cpu")
    tk = TK.make_knobs(tp, device="cpu")
    with pytest.raises(ValueError) as je:
        JR.run_ticks(jp, JD.init_full_view(64), JPlan.uniform(0.0), JD.seeds_mask(64, [0]), 1,
                     knobs=JK.make_knobs(jp))
    with pytest.raises(ValueError) as te:
        TR.run_ticks(tp, st, TPlan.uniform(0.0, device="cpu"), seeds, 1, knobs=tk)
    assert str(je.value) == str(te.value)
    jsp = dataclasses.replace(sparse_params(32, slot_budget=128), pallas_core=True)
    with pytest.raises(ValueError) as je:
        JS.run_sparse_ticks(jsp, JS.init_sparse_full_view(32, 128), JPlan.uniform(0.0), 1,
                            knobs=JK.make_knobs(jsp.base))
    with pytest.raises(ValueError) as te:
        TS.run_sparse_ticks(port_params(jsp), TS.init_sparse_full_view(32, 128, device="cpu"),
                            TPlan.uniform(0.0, device="cpu"), 1,
                            knobs=TK.make_knobs(port_params(jsp).base, device="cpu"))
    assert str(je.value) == str(te.value)


@pytest.mark.parametrize("mult,cap", POINTS[:3], ids=["identity", "half-2", "x2.25-1"])
def test_dense_trajectory_with_knobs_matches_jax(mult, cap):
    """n=64, the XLA core (pallas_delivery=False), a kill, 10% loss, 3
    chunks of 12 ticks, knobs on both sides; identity knobs also equal
    the knob-free port run."""
    n = 64
    jp, tp = dense_params(n, False)
    js = JD.kill(JD.init_full_view(n, user_gossip_slots=2, seed=4), 3)
    ts = TD.kill(TD.init_full_view(n, user_gossip_slots=2, seed=4, device="cpu"), 3)
    bare = TD.kill(TD.init_full_view(n, user_gossip_slots=2, seed=4, device="cpu"), 3)
    jk, tk = JK.make_knobs(jp, mult, cap), TK.make_knobs(tp, mult, cap, device="cpu")
    jseeds, tseeds = JD.seeds_mask(n, [0, 1]), TD.seeds_mask(n, [0, 1], device="cpu")
    jplan, tplan = JPlan.uniform(10.0), TPlan.uniform(10.0, device="cpu")
    for c in range(3):
        js, jtr = JR.run_chunked(jp, js, jplan, jseeds, 12, chunk=12, knobs=jk)
        ts, ttr = TR.run_chunked(tp, ts, tplan, tseeds, 12, chunk=12, knobs=tk)
        dense_same(dense_dict(js), ts, f"chunk {c}")
        dense_traces(jtr, ttr, f"chunk {c}")
        if mult == 1.0 and cap is None:
            bare, btr = TR.run_chunked(tp, bare, tplan, tseeds, 12, chunk=12)
            dense_same(dense_dict(js), bare, f"bare chunk {c}")
            dense_traces(jtr, btr, f"bare chunk {c}")


@pytest.mark.parametrize("mult,cap", POINTS[:3], ids=["identity", "half-2", "x2.25-1"])
def test_sparse_trajectory_with_knobs_matches_jax(mult, cap):
    """n=64, S=128, the XLA chain (pallas_core=False), a kill, FD every 2,
    suspicion 12, 10% loss, 3 chunks of 12 ticks with host-boundary frees,
    knobs on both sides; identity knobs also equal the knob-free run."""
    n, s = 64, 128
    jp = dataclasses.replace(sparse_params(n, slot_budget=s, suspicion_ticks=12),
                             in_scan_writeback=False)
    tp = port_params(jp)
    js = JS.kill_sparse(JS.init_sparse_full_view(n, s, user_gossip_slots=2), 5)
    ts = TS.kill_sparse(TS.init_sparse_full_view(n, s, user_gossip_slots=2, device="cpu"), 5)
    bare = TS.kill_sparse(TS.init_sparse_full_view(n, s, user_gossip_slots=2, device="cpu"), 5)
    jk, tk = JK.make_knobs(jp.base, mult, cap), TK.make_knobs(tp.base, mult, cap, device="cpu")
    jplan, tplan = JPlan.uniform(10.0), TPlan.uniform(10.0, device="cpu")
    for c in range(3):
        js, jtr = JS.run_sparse_chunked(jp, js, jplan, 12, chunk=12, knobs=jk)
        ts, ttr = TS.run_sparse_chunked(tp, ts, tplan, 12, chunk=12, knobs=tk)
        assert_same_state(js, ts, f"chunk {c}")
        assert_same_traces(jtr, ttr, f"chunk {c}")
        if mult == 1.0 and cap is None:
            bare, btr = TS.run_sparse_chunked(tp, bare, tplan, 12, chunk=12)
            a, b = sparse_state_to_numpy(ts), sparse_state_to_numpy(bare)
            assert all(np.array_equal(a[k], b[k]) for k in a)
            assert_same_traces(jtr, btr, f"bare chunk {c}")
