"""Card twins of the elastic and flight-recorder tests: the port on the
card against the port on the CPU, on the same seeded runs — the elastic
trajectory with joins on the kernel route (``csrc/sparse_core.cu`` on the
card, its plain version on the CPU), a promotion after it, and a traced run
on the XLA chain. Every state leaf, ring field and counter equal; the
kernel launched on every kernel-route tick. Tests marked ``cuda`` need a
card and skip without one; this file imports no jax, so it runs on a
machine without it, as ``python -m pytest --noconftest -m cuda
tests/test_torch_elastic_card.py``.
"""

import numpy as np
import pytest
import torch

from scalecube_cluster_tpu_torch.ops.sparse_core import sparse_core
from scalecube_cluster_tpu_torch.sim import checkpoint as TC
from scalecube_cluster_tpu_torch.sim import sparse as T
from scalecube_cluster_tpu_torch.sim.convert import sparse_state_to_numpy
from scalecube_cluster_tpu_torch.sim.faults import FaultPlan
from scalecube_cluster_tpu_torch.sim.params import SimParams
from scalecube_cluster_tpu_torch.sim.schedule import ScheduleBuilder
from scalecube_cluster_tpu_torch.testing import one_cpu_thread

one_cpu_thread()

CHUNK = 12


def _params(n, s, pallas):
    base = SimParams(n=n, gossip_fanout=3, periods_to_spread=8, periods_to_sweep=18,
                     fd_period_ticks=2, sync_period_ticks=10, suspicion_ticks=12,
                     ping_req_members=2, user_gossip_slots=2)
    return T.SparseParams(base=base, slot_budget=s, alloc_cap=16, in_scan_writeback=False,
                          pallas_core=pallas)


def _schedule(n_alloc, joins, device, first=2):
    """5% loss, member 3 killed at tick 5, ``joins`` joined 8 a tick from
    tick ``first``."""
    b = ScheduleBuilder(n_alloc).add_segment(1, FaultPlan.uniform(5.0, device=device)).kill(5, 3)
    for k, j in enumerate(joins):
        b = b.join(first + k // 8, j)
    return b.build()


def _flat(state):
    out = sparse_state_to_numpy(state)
    ring = out.pop("trace", None)
    if ring is not None:
        out.update({f"trace.{k}": v for k, v in ring.items()})
    return out


def _run(device, n_live, n_alloc, s, pallas, chunks, trace_capacity=0, promote_to=None):
    """Snapshots and traces of one seeded elastic run on ``device``."""
    params = _params(n_alloc, s, pallas)
    sched = _schedule(n_alloc, range(n_live, n_alloc), device)
    st = T.init_sparse_full_view(n_live, s, user_gossip_slots=2, n_alloc=n_alloc,
                                 trace_capacity=trace_capacity, device=device)
    out = []
    for _ in range(chunks):
        st, tr = T.run_sparse_chunked(params, st, sched, CHUNK, chunk=CHUNK)
        out.append((_flat(st), tr))
    if promote_to is not None:
        params, st = TC.promote_sparse_state(params, st, promote_to)
        sched = _schedule(promote_to, range(n_alloc, n_alloc + 8), device, first=st.t_host + 2)
        out.append((_flat(st), None))
        st, tr = T.run_sparse_chunked(params, st, sched, CHUNK, chunk=CHUNK)
        out.append((_flat(st), tr))
    return out


def _assert_same(card, cpu):
    for c, ((a, ta), (b, tb)) in enumerate(zip(card, cpu)):
        assert set(a) == set(b), c
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), (c, k)
        assert set(ta or {}) == set(tb or {}), c
        for k in ta or {}:
            assert np.array_equal(np.asarray(ta[k]).view(np.uint8),
                                  np.asarray(tb[k]).view(np.uint8)), (c, k)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["kernel-promote", "chain-traced"])
def test_elastic_card_matches_cpu(case):
    """The elastic run with joins (192 live of 256, S=128), then on the
    kernel route a promotion to 512 and 12 more ticks joining 8 promoted
    rows; on the XLA chain with the flight recorder armed."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    pallas = case == "kernel-promote"
    kw = dict(n_live=192, n_alloc=256, s=128, pallas=pallas, chunks=3,
              trace_capacity=0 if pallas else 1 << 16, promote_to=512 if pallas else None)
    before = sparse_core.launches
    card = _run("cuda", **kw)
    torch.cuda.synchronize()
    launched = sparse_core.launches - before
    cpu = _run("cpu", **kw)
    _assert_same(card, cpu)
    assert launched == (3 * CHUNK + CHUNK if pallas else 0)
    traces = [tr for _, tr in card if tr is not None]
    assert sum(int(tr["joins_admitted"].sum()) for tr in traces) == 64 + (8 if pallas else 0)
    if not pallas:
        assert int(card[-1][0]["trace.cursor"]) > 0 and int(card[-1][0]["trace.overflow"]) == 0
