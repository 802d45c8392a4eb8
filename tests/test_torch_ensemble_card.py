"""Card twins of the ensemble tests: the port's ensembles on the card
against the same ensembles on the CPU — the dense engine on the fused route
with one universe joining while the others do not, the sparse engine on
the kernel route, and both fused cores over a universe axis against one
launch per universe. Every leaf of every universe and every ``[B, T]``
trace equal; one kernel launch a tick for the whole batch. Tests marked
``cuda`` need a card and skip without one; this file imports no jax, so it
runs on a machine without it, as ``python -m pytest --noconftest -m cuda
tests/test_torch_ensemble_card.py``.
"""

import numpy as np
import pytest
import torch

from scalecube_cluster_tpu_torch.ops.sparse_core import sparse_core, sparse_core_reference
from scalecube_cluster_tpu_torch.ops.tick_core import tick_core, tick_core_reference
from scalecube_cluster_tpu_torch.sim import ensemble as TE
from scalecube_cluster_tpu_torch.sim import state as TS
from scalecube_cluster_tpu_torch.sim.convert import dense_state_to_numpy, sparse_state_to_numpy
from scalecube_cluster_tpu_torch.sim.faults import FaultPlan
from scalecube_cluster_tpu_torch.sim.params import SimParams
from scalecube_cluster_tpu_torch.sim.schedule import ScheduleBuilder
from scalecube_cluster_tpu_torch.sim.sparse import SparseParams
from scalecube_cluster_tpu_torch.testing import (
    one_cpu_thread,
    random_operands,
    random_tick_operands,
)

one_cpu_thread()

B, CHUNK = 3, 12


def _base(n, **kw):
    return SimParams(n=n, gossip_fanout=3, periods_to_spread=8, periods_to_sweep=18,
                     fd_period_ticks=2, sync_period_ticks=10, suspicion_ticks=12,
                     ping_req_members=2, user_gossip_slots=2, **kw)


def _schedules(n, device):
    """5% loss; member 5+u killed at tick 2; universe 1 restarts it at tick
    6 (a joiner), the others past the run."""
    return TE.stack_universes(
        ScheduleBuilder(n).add_segment(1, FaultPlan.uniform(5.0, device=device))
        .kill(2, 5 + u).restart(6 if u == 1 else 500, 5 + u).build()
        for u in range(B)
    )


def _run(engine, device, chunks=3):
    out = []
    if engine == "dense":
        n = 128
        params = _base(n, pallas_delivery=True)
        st = TE.init_ensemble_dense(n, range(B), user_gossip_slots=2, device=device)
        seeds = TS.seeds_mask(n, [0], device=device)
        plans = _schedules(n, device)
        for _ in range(chunks):
            st, tr = TE.run_ensemble_ticks(params, st, plans, seeds, CHUNK)
            out.append((dense_state_to_numpy(st), {k: v.cpu().numpy() for k, v in tr.items()}))
    else:
        n, s = 256, 128
        params = SparseParams(base=_base(n), slot_budget=s, alloc_cap=16,
                              in_scan_writeback=False, pallas_core=True)
        st = TE.init_ensemble_sparse(n, range(B), slot_budget=s, user_gossip_slots=2,
                                     device=device)
        plans = _schedules(n, device)
        for _ in range(chunks):
            st, tr = TE.run_ensemble_sparse_chunked(params, st, plans, CHUNK, chunk=CHUNK)
            out.append((sparse_state_to_numpy(st), tr))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["dense", "sparse"])
def test_ensemble_card_matches_cpu(engine):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    kernel = tick_core if engine == "dense" else sparse_core
    before = kernel.launches
    card = _run(engine, "cuda")
    torch.cuda.synchronize()
    launched = kernel.launches - before
    cpu = _run(engine, "cpu")
    for c, ((a, ta), (b, tb)) in enumerate(zip(card, cpu)):
        assert set(a) == set(b) and set(ta) == set(tb), c
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), (c, k)
        for k in ta:
            assert np.array_equal(np.asarray(ta[k]).view(np.uint8),
                                  np.asarray(tb[k]).view(np.uint8)), (c, k)
    if engine == "sparse":
        assert launched == 3 * CHUNK
    else:
        # SYNC ticks 10, 20, 30 and the joining ticks take the slow core.
        assert 0 < launched <= 3 * CHUNK - 3


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["sparse_core", "tick_core"])
def test_batched_kernel_matches_single_launches(kernel):
    """One batched launch equals the batched plain version and B single
    launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    if kernel == "sparse_core":
        fn, plain = sparse_core, sparse_core_reference
        sets = [random_operands(1024, 256, 3, seed=60 + u) for u in range(B)]
        consts = dict(spread=48, susp_ticks=400, age_stale=120, sweep=98)
    else:
        fn, plain = tick_core, tick_core_reference
        sets = [random_tick_operands(512, 3, seed=70 + u, susp_ticks=350) for u in range(B)]
        consts = dict(spread=42, sweep=86, susp_ticks=350, age_stale=120)
    args = tuple(torch.from_numpy(np.stack([o[k] for o in sets])).cuda() for k in sets[0])
    before = fn.launches
    got = fn(*args, **consts)
    assert fn.launches == before + 1
    want = plain(*args, **consts)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    for u in range(B):
        one = fn(*(a[u] for a in args), **consts)
        for g, w in zip(got, one):
            assert torch.equal(g[u], w), u
