"""The port's sparse engine against the JAX package, whole trajectories.

Both engines start from the same seed (or the same mid-run state, carried
across by ``sim/convert.py``), run the same chunks on the CPU — the JAX side
with its fused Pallas core in interpret mode and the full fold, the port
with the plain version of its kernel — and after EVERY chunk every state
leaf (``rng`` included) and every collected counter (key set and values)
must be bit-equal. Tolerance: none.
"""

import dataclasses

import numpy as np
import pytest

from scalecube_cluster_tpu.sim import sparse as J
from scalecube_cluster_tpu.sim.faults import FaultPlan as JPlan
from scalecube_cluster_tpu_torch.sim import sparse as T
from scalecube_cluster_tpu_torch.sim.convert import (
    sparse_state_from_numpy,
    sparse_state_to_numpy,
)
from scalecube_cluster_tpu_torch.sim.faults import FaultPlan as TPlan
from scalecube_cluster_tpu_torch.sim.params import SimParams as TSimParams
from tests.test_sparse import sparse_params
from scalecube_cluster_tpu_torch.testing import one_cpu_thread, shared_result

one_cpu_thread()


def port_params(jp):
    """The port's SparseParams for a JAX SparseParams (same constants, the
    same core route and fold)."""
    return T.SparseParams(
        base=TSimParams(**dataclasses.asdict(jp.base)),
        slot_budget=jp.slot_budget,
        alloc_cap=jp.alloc_cap,
        writeback_period=jp.writeback_period,
        in_scan_writeback=jp.in_scan_writeback,
        pallas_core=jp.pallas_core,
        pallas_fold=jp.pallas_fold,
        sync_window=jp.sync_window,
    )


def jax_state_dict(state):
    """A JAX SparseState as a dict of numpy arrays (absent fields dropped)."""
    return {
        f.name: np.asarray(getattr(state, f.name))
        for f in dataclasses.fields(state)
        if getattr(state, f.name) is not None
    }


def assert_same_state(js, ts, where):
    a, b = jax_state_dict(js), sparse_state_to_numpy(ts)
    assert set(a) == set(b), (where, set(a) ^ set(b))
    for k in a:
        assert a[k].dtype == b[k].dtype, (where, k, a[k].dtype, b[k].dtype)
        assert np.array_equal(a[k], b[k]), (where, k)
    assert ts.t_host == int(a["tick"]), where


def assert_same_traces(jtr, ttr, where):
    assert set(jtr) == set(ttr), (where, set(jtr) ^ set(ttr))
    for k in jtr:
        a = np.asarray(jtr[k])
        if a.dtype == np.float32:
            assert np.array_equal(a.view(np.int32), ttr[k].view(np.int32)), (where, k)
        else:
            assert np.array_equal(a, ttr[k]), (where, k)


def run_both(jp, js, ts, loss, ticks, chunk, collect):
    """Chunk by chunk through run_sparse_chunked on both engines, comparing
    after each chunk. Returns the final states and the JAX traces."""
    tp = port_params(jp)
    jplan, tplan = JPlan.uniform(loss), TPlan.uniform(loss, device="cpu")
    traces = []
    for c in range(ticks // chunk):
        js, jtr = J.run_sparse_chunked(jp, js, jplan, chunk, chunk=chunk, collect=collect)
        ts, ttr = T.run_sparse_chunked(tp, ts, tplan, chunk, chunk=chunk, collect=collect)
        assert_same_state(js, ts, f"chunk {c}")
        assert_same_traces(jtr, ttr, f"chunk {c}")
        traces.append(jtr)
    return js, ts, traces


def test_fold_ladder_scenario_matches_jax():
    """tests/test_sparse.py::_fold_run's scenario: n=32, S=512, a kill,
    FD period 2, SYNC period 10, suspicion 12 (the DEAD transition lands
    inside the 36 ticks), 10% loss, write-back every 12 ticks, the
    verdict-latency recorder on, collect=True."""
    n, S = 32, 512
    jp = dataclasses.replace(
        sparse_params(n, suspicion_ticks=12), slot_budget=S,
        in_scan_writeback=False, pallas_core=True,
    )
    js = J.kill_sparse(J.init_sparse_full_view(n, S, record_latency=True), 5)
    ts = T.kill_sparse(
        T.init_sparse_full_view(n, S, user_gossip_slots=4, record_latency=True, device="cpu"), 5
    )
    assert_same_state(js, ts, "init")
    js, ts, traces = run_both(jp, js, ts, 10.0, 36, 12, collect=True)
    assert sum(int(tr["verdicts_dead"].sum()) for tr in traces) > 0
    assert sum(int(tr["msgs_sync"].sum()) for tr in traces) > 0
    assert int((np.asarray(js.lat_first_dead) >= 0).sum()) == 1


_JAX_BENCH = {}


def jax_bench_run(n, S, ticks=60, chunk=20):
    """The JAX bench trajectory (collect=True), cached per module: its
    params and the (state dict, traces) after each chunk. The JAX state
    does not depend on ``collect``, so both of the port's modes are held
    against this one run."""
    if (n, S) not in _JAX_BENCH:
        jp = J.SparseParams.for_n(n, slot_budget=S, in_scan_writeback=False, pallas_core=True)

        def compute():
            js = J.kill_sparse(J.init_sparse_full_view(n, S), 7)
            snaps = [(jax_state_dict(js), None)]
            for _ in range(ticks // chunk):
                js, jtr = J.run_sparse_chunked(
                    jp, js, JPlan.uniform(5.0), chunk, chunk=chunk, collect=True
                )
                snaps.append((jax_state_dict(js), {k: np.asarray(v) for k, v in jtr.items()}))
            return snaps

        snaps = shared_result(f"test_torch_sparse.jax_bench_run.{n}.{S}.{ticks}.{chunk}", compute)
        _JAX_BENCH[(n, S)] = (jp, chunk, snaps)
    return _JAX_BENCH[(n, S)]


def _continue_port(jp, chunk, ts, snaps, collect):
    tp = port_params(jp)
    plan = TPlan.uniform(5.0, device="cpu")
    for c, (jd, jtr) in enumerate(snaps):
        ts, ttr = T.run_sparse_chunked(tp, ts, plan, chunk, chunk=chunk, collect=collect)
        b = sparse_state_to_numpy(ts)
        assert set(jd) == set(b), c
        for k in jd:
            assert jd[k].dtype == b[k].dtype and np.array_equal(jd[k], b[k]), (c, k)
        if collect:
            assert_same_traces(jtr, ttr, f"chunk {c}")
        else:
            assert ttr == {}
    return ts


@pytest.mark.parametrize("collect", [False, True], ids=["nocollect", "collect"])
@pytest.mark.parametrize("n,S", [(256, 128), (1024, 256)], ids=["256", "1024"])
def test_bench_trajectory_matches_jax(n, S, collect):
    """The bench path (LAN preset via SparseParams.for_n, kill member 7,
    5% uniform loss, host-boundary write-back) over 60 ticks in chunks of
    20, in both of the port's collect modes."""
    jp, chunk, snaps = jax_bench_run(n, S)
    ts = T.kill_sparse(T.init_sparse_full_view(n, S, device="cpu"), 7)
    b = sparse_state_to_numpy(ts)
    assert all(np.array_equal(snaps[0][0][k], b[k]) for k in b)
    _continue_port(jp, chunk, ts, snaps[1:], collect)
    assert int((snaps[-1][0]["slot_subj"] >= 0).sum()) > 0


def test_mid_run_start_matches_jax():
    """A JAX state taken mid-run (tick 20: slots active, countdowns armed,
    a non-trivial rng key) carried into the port by sim/convert.py continues
    bit-identically for the remaining 40 ticks."""
    jp, chunk, snaps = jax_bench_run(256, 128)
    ts = sparse_state_from_numpy(snaps[1][0], device="cpu")
    assert ts.t_host == 20
    _continue_port(jp, chunk, ts, snaps[2:], collect=True)


#: The core routes of the reference's ``use_kernel`` gate, and fold subsets
#: of the kernel route (the carried pin mask and the recorder flags each
#: follow their fold piece): (n, S, pallas_core, pallas_fold).
ROUTES = {
    "chain-group8": (40, 128, False, None),
    "gate-n%32": (48, 128, True, None),
    "gate-S%128": (64, 100, True, None),
    "gate-S>=4096": (16, 4096, True, None),
    "fold-none": (64, 128, True, frozenset()),
    "fold-countdown": (64, 128, True, frozenset({"countdown"})),
    "fold-points": (64, 128, True, frozenset({"countdown", "points"})),
    "fold-wb_mask": (64, 128, True, frozenset({"countdown", "wb_mask"})),
    "fold-view_rows": (64, 128, True, frozenset({"countdown", "view_rows"})),
}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_core_routes_and_folds_match_jax(route):
    """The XLA chain where the reference's gate refuses the kernel (n % 32
    != 0 with 8-row fan-out groups, S % 128 != 0, S >= 4096, or
    ``pallas_core=False``) and the kernel route under fold subsets: 36
    ticks in chunks of 12 (FD every 2, suspicion 12, 10% loss, a kill, the
    latency recorder on), every state leaf (``wb_pinned``/``wb_valid``
    included) and counter equal after every chunk; then a
    ``writeback_free`` consumes or recomputes the carried mask."""
    n, S, pallas, fold = ROUTES[route]
    jp = dataclasses.replace(
        sparse_params(n, suspicion_ticks=12), slot_budget=S, in_scan_writeback=False,
        pallas_core=pallas,
        **({} if fold is None else {"pallas_fold": fold}),
    )
    js = J.kill_sparse(J.init_sparse_full_view(n, S, record_latency=True), 5)
    ts = T.kill_sparse(
        T.init_sparse_full_view(n, S, user_gossip_slots=4, record_latency=True, device="cpu"), 5
    )
    tp = port_params(jp)
    jplan, tplan = JPlan.uniform(10.0), TPlan.uniform(10.0, device="cpu")
    for c in range(3):
        js, jtr = J.run_sparse_ticks(jp, js, jplan, 12)
        ts, ttr = T.run_sparse_ticks(tp, ts, tplan, 12)
        assert_same_state(js, ts, f"chunk {c}")
        assert_same_traces(jtr, {k: v.numpy() for k, v in ttr.items()}, f"chunk {c}")
        js, ts = J.writeback_free(jp, js), T.writeback_free(tp, ts)
        assert_same_state(js, ts, f"free {c}")
