"""Card twins of the explicit-SPMD parity tests: the sparse core's shard
mode on the card against its plain version and against one launch per
shard, and the sharded engine (parallel/spmd.py) on the card against the
same run on the CPU and against the single-device engine on the card,
kernel route and XLA core, launching ``csrc/sparse_core.cu`` once a tick
for all shards. Tests marked ``cuda`` need a card and skip without one;
this file imports no jax, so it runs on a machine without it, as
``python -m pytest --noconftest -m cuda tests/test_torch_spmd_card.py``.
Tolerance: none.
"""

import dataclasses

import numpy as np
import pytest
import torch

from scalecube_cluster_tpu_torch.ops.sparse_core import sparse_core, sparse_core_reference
from scalecube_cluster_tpu_torch.parallel import mesh as TM
from scalecube_cluster_tpu_torch.parallel import spmd as TS
from scalecube_cluster_tpu_torch.sim import sparse as T
from scalecube_cluster_tpu_torch.sim.convert import sparse_state_to_numpy
from scalecube_cluster_tpu_torch.sim.faults import FaultPlan
from scalecube_cluster_tpu_torch.sim.params import SimParams
from scalecube_cluster_tpu_torch.sim.schedule import ScheduleBuilder
from scalecube_cluster_tpu_torch.testing import (
    one_cpu_thread,
    shard_core_args,
    stacked_shard_operands,
)

one_cpu_thread()

CONSTS = dict(spread=48, susp_ticks=400, age_stale=120, sweep=98)
N, S, D, TICKS = 1024, 256, 4, 40


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("shards,nl,s,edges", [(8, 512, 512, False), (4, 256, 128, True),
                                               (4, 256, 384, True)])
def test_shard_core_kernel_matches_plain(shards, nl, s, edges):
    _need_card()
    ops = stacked_shard_operands(shards, nl, s, seed=nl + s, tile_edges=edges)
    args, kw = shard_core_args(ops, "cuda")
    launches0 = sparse_core.launches
    got = sparse_core(*args, **CONSTS, **kw)
    assert sparse_core.launches == launches0 + 1
    want = sparse_core_reference(*args, **CONSTS, **kw)
    cpu_args, cpu_kw = shard_core_args(ops, "cpu")
    cpu = sparse_core(*cpu_args, **CONSTS, **cpu_kw)
    for z in range(shards):
        one = sparse_core(*(a[z] for a in args), **CONSTS,
                          row_base=kw["row_base"][z], slab_windows=kw["slab_windows"][z],
                          age_windows=kw["age_windows"][z])
        for a, b in zip(got, one):
            assert torch.equal(a[z], b)
    for a, b, c in zip(got, want, cpu):
        assert torch.equal(a, b) and torch.equal(a.cpu(), c)


def _params(pallas):
    base = dataclasses.replace(SimParams.from_cluster_config(N), fd_period_ticks=5,
                               sync_period_ticks=30, suspicion_ticks=20)
    return T.SparseParams(base=base, slot_budget=S, pallas_core=pallas)


def _run(device, pallas, sharded=True):
    sched = (
        ScheduleBuilder(N).add_segment(0, FaultPlan.uniform(5.0, device=device))
        .kill(3, 7).kill(5, N // 2 + 3).restart(21, 7).build()
    )
    st = T.init_sparse_full_view(N, S, seed=3, device=device)
    if sharded:
        return TS.run_sparse_ticks_spmd(_params(pallas), TS.ShardConfig(D),
                                        TM.make_mesh(D), st, sched, TICKS)
    return T.run_sparse_ticks(_params(pallas), st, sched, TICKS)


def _same(card, card_tr, other, other_tr):
    a, b = sparse_state_to_numpy(card), sparse_state_to_numpy(other)
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    assert set(card_tr) == set(other_tr)
    for k in card_tr:
        assert torch.equal(card_tr[k].cpu(), other_tr[k].cpu()), k


@pytest.mark.cuda
@pytest.mark.parametrize("pallas", [True, False])
def test_sharded_engine_card_matches_cpu_and_single_device(pallas):
    _need_card()
    launches0 = sparse_core.launches
    card, card_tr = _run("cuda", pallas)
    torch.cuda.synchronize()
    assert sparse_core.launches - launches0 == (TICKS if pallas else 0)
    _same(card, card_tr, *_run("cpu", pallas))
    _same(card, card_tr, *_run("cuda", pallas, sharded=False))
