"""Elastic membership in the port (``init_sparse_full_view(..., n_alloc=)``,
the 4-tuple ``apply_events_sparse``, joins in the scheduled runners,
elastic checkpoints, ``promote_sparse_state``) against the JAX package's,
on the CPU.

A scheduled elastic trajectory — capacity rows joined in batches, a kill,
5% loss, host-boundary write-backs — runs on both core routes: the kernel
route at n_alloc=64, S=128 (the JAX side in Pallas interpret mode) and the
XLA chain at n_alloc=40 (8-row fan-out groups) with the flight recorder
armed, so the joins' events are in the ring. After every chunk every state
leaf (``live_mask`` and the ring included) and every counter
(``joins_admitted``, ``n_live``, ``joins_fired``) are bit-equal. Elastic
archives cross the packages both ways, plain and with the cold lane
packed; a promoted state equals the reference's leaf for leaf (card ==
CPU after promotion is ``chip_smoke.py``'s). Tolerance: none.
"""

import dataclasses
import io

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from scalecube_cluster_tpu.sim import checkpoint as JC
from scalecube_cluster_tpu.sim import sparse as J
from scalecube_cluster_tpu.sim.faults import FaultPlan as JPlan
from scalecube_cluster_tpu.sim.schedule import ScheduleBuilder as JBuilder
from scalecube_cluster_tpu_torch.sim import checkpoint as TC
from scalecube_cluster_tpu_torch.sim import sparse as T
from scalecube_cluster_tpu_torch.sim.convert import sparse_state_to_numpy
from scalecube_cluster_tpu_torch.sim.faults import FaultPlan as TPlan
from scalecube_cluster_tpu_torch.sim.schedule import ScheduleBuilder as TBuilder
from scalecube_cluster_tpu_torch.testing import one_cpu_thread
from tests.test_sparse import sparse_params
from tests.test_torch_checkpoint import assert_same_archive, read_archive
from tests.test_torch_sparse import assert_same_traces, port_params
from tests.test_torch_tracer import assert_same_full_state, jax_full_dict

one_cpu_thread()

#: route → (n_live, n_alloc, S, pallas_core, trace capacity)
ROUTES = {"kernel": (48, 64, 128, True, 0), "chain-traced": (32, 40, 128, False, 4096)}
CHUNK, CHUNKS = 12, 2


def _params(route):
    _, na, s, pallas, _ = ROUTES[route]
    return dataclasses.replace(
        sparse_params(na, suspicion_ticks=12), slot_budget=s, in_scan_writeback=False,
        pallas_core=pallas,
    )


def _sched(route, builder, uniform):
    """5% loss; the capacity rows joined 4 a tick from tick 2, a kill at 5."""
    n, na = ROUTES[route][:2]
    b = builder(na).add_segment(1, uniform(5.0)).kill(5, 3)
    for k, j in enumerate(range(n, na)):
        b = b.join(2 + k // 4, j)
    return b.build()


_JAX = {}


def jax_elastic_run(route):
    """The reference's elastic trajectory, cached per module: a snapshot and
    the traces after each chunk, and the final state (not donated again)."""
    if route not in _JAX:
        n, na, s, _, cap = ROUTES[route]
        jp = _params(route)
        js = J.init_sparse_full_view(n, s, n_alloc=na, trace_capacity=cap)
        sched = _sched(route, JBuilder, JPlan.uniform)
        snaps = [(jax_full_dict(js), None)]
        for _ in range(CHUNKS):
            js, jtr = J.run_sparse_chunked(jp, js, sched, CHUNK, chunk=CHUNK)
            snaps.append((jax_full_dict(js), jtr))
        _JAX[route] = (jp, snaps, js)
    return _JAX[route]


def port_elastic_run(route, jp):
    """The port's run of :func:`jax_elastic_run`'s trajectory: snapshots
    after each chunk, and the final state."""
    n, na, s, _, cap = ROUTES[route]
    tp = port_params(jp)
    ts = T.init_sparse_full_view(n, s, n_alloc=na, trace_capacity=cap, device="cpu")
    sched = _sched(route, TBuilder, lambda loss: TPlan.uniform(loss, device="cpu"))
    port = [(sparse_state_to_numpy(ts), None)]
    for _ in range(CHUNKS):
        ts, ttr = T.run_sparse_chunked(tp, ts, sched, CHUNK, chunk=CHUNK)
        port.append((sparse_state_to_numpy(ts), ttr))
    return port, ts


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_elastic_trajectory_matches_jax(route, tmp_path):
    """Every leaf and counter after every chunk; the joins all land. Then,
    from the final states: elastic archives cross the packages both ways
    (plain and packed), and ``promote_sparse_state``."""
    jp, snaps, js = jax_elastic_run(route)
    port, ts = port_elastic_run(route, jp)
    for c, ((jd, jtr), (td, ttr)) in enumerate(zip(snaps, port)):
        assert_same_full_state(jd, td, (route, c))
        if jtr is not None:
            assert_same_traces(jtr, ttr, (route, c))
    n, na = ROUTES[route][:2]
    traces = [tr for _, tr in port[1:]]
    assert sum(int(tr["joins_admitted"].sum()) for tr in traces) == na - n
    assert sum(int(tr["joins_fired"].sum()) for tr in traces) == na - n
    assert int(traces[0]["n_live"][0]) == n and int(traces[-1]["n_live"][-1]) == na
    assert bool(port[-1][0]["live_mask"].all())
    for pack_cold in (False, True):
        check_elastic_checkpoints(route, jp, js, ts, tmp_path, pack_cold)
    check_promotion(route, jp, js, ts)


def test_init_and_events_match_jax():
    """``n_alloc`` init and its errors; the 4-tuple ``apply_events_sparse``
    (joins, a restart, a kill, injected gossip) on a traced elastic state."""
    for n, na in ((24, 40), (40, 40), (40, None)):
        a = jax_full_dict(J.init_sparse_full_view(n, 128, n_alloc=na))
        assert_same_full_state(a, T.init_sparse_full_view(n, 128, n_alloc=na, device="cpu"), na)
    for bad in (16, 44):
        with pytest.raises(ValueError) as je:
            J.init_sparse_full_view(24, 128, n_alloc=bad)
        with pytest.raises(ValueError) as te:
            T.init_sparse_full_view(24, 128, n_alloc=bad, device="cpu")
        assert str(te.value) == str(je.value)
    rng = np.random.default_rng(5)
    na = 40
    kill, restart, join = (np.zeros(na, bool) for _ in range(3))
    kill[[2, 9]] = True
    restart[4] = True
    join[[30, 31, 35]] = True
    gossip = rng.random((na, 4)) < 0.1
    for g in (None, gossip):
        js = J.init_sparse_full_view(24, 128, n_alloc=na, trace_capacity=64)
        ts = T.init_sparse_full_view(24, 128, n_alloc=na, trace_capacity=64, device="cpu")
        jm = [jnp.asarray(m) for m in (kill, restart)]
        tm = [torch.from_numpy(m) for m in (kill, restart)]
        js = J.apply_events_sparse(js, *jm, None if g is None else jnp.asarray(g),
                                   jnp.asarray(join))
        ts = T.apply_events_sparse(ts, *tm, None if g is None else torch.from_numpy(g),
                                   torch.from_numpy(join))
        assert_same_full_state(jax_full_dict(js), ts, g is None)


def check_elastic_checkpoints(route, jp, js, ts, tmp_path, pack_cold):
    """An elastic archive written by either package loads in the other and,
    written again, is the same archive; the ring stays out of it."""
    buf = io.BytesIO()
    JC.save_sparse_checkpoint(buf, js, jp, pack_cold=pack_cold)
    jarch = read_archive(buf)
    assert "live_mask" in jarch and "trace" not in jarch
    buf.seek(0)
    ts2, tp2 = TC.load_sparse_checkpoint(buf, device="cpu")
    assert ts2.trace is None and bool(ts2.live_mask.all())
    path = tmp_path / "port.npz"
    TC.save_sparse_checkpoint(path, ts2, tp2, pack_cold=pack_cold)
    assert_same_archive(jarch, read_archive(path))
    # And the port's own run, written by the port and read by the reference.
    tp = port_params(jp)
    TC.save_sparse_checkpoint(path, ts, tp, pack_cold=pack_cold)
    js3, jp3 = JC.load_sparse_checkpoint(path)
    assert jp3 == jp
    expect = sparse_state_to_numpy(ts)
    expect.pop("trace", None)
    assert_same_full_state(jax_full_dict(js3), expect, route)


def check_promotion(route, jp, js, ts):
    """``promote_sparse_state`` to twice the allocation equals the
    reference's leaf for leaf (the ring's registers padded), and refuses to
    shrink with the reference's error; the promoted port state then runs
    on, joining a promoted row."""
    na = ROUTES[route][1]
    jp2, js2 = JC.promote_sparse_state(jp, js, 2 * na)
    tp2, ts2 = TC.promote_sparse_state(port_params(jp), ts, 2 * na)
    assert tp2 == port_params(jp2)
    assert_same_full_state(jax_full_dict(js2), ts2, route)
    with pytest.raises(ValueError) as je:
        JC.promote_sparse_state(jp, js, na)
    with pytest.raises(ValueError) as te:
        TC.promote_sparse_state(port_params(jp), ts, na)
    assert str(te.value) == str(je.value)
    t0 = CHUNK * CHUNKS
    sched = TBuilder(2 * na).add_segment(1, TPlan.uniform(5.0, device="cpu")).join(
        t0 + 2, na + 1).build()
    ts2, ttr = T.run_sparse_chunked(tp2, ts2, sched, CHUNK, chunk=CHUNK)
    assert int(ttr["joins_admitted"].sum()) == 1
    assert int(ttr["n_live"][-1]) == na + 1
