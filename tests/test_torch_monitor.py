"""The port's sim/monitor.py against the JAX package's: the same seeded
states (record keys of every status over a few epochs and incarnations,
dead members, active and free slots, a carried pin mask) give the same
node views and summaries, key for key and value for value. Tolerance:
none (the one float, ``viewed_alive_mean``, bit-equal)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from scalecube_cluster_tpu.sim import monitor as JM
from scalecube_cluster_tpu.sim import sparse as J
from scalecube_cluster_tpu.sim import state as JS
from scalecube_cluster_tpu_torch.sim import monitor as TM
from scalecube_cluster_tpu_torch.sim import sparse as T
from scalecube_cluster_tpu_torch.sim.convert import (
    dense_state_from_numpy,
    sparse_state_from_numpy,
)
from scalecube_cluster_tpu_torch.sim.faults import FaultPlan as TPlan
from scalecube_cluster_tpu_torch.testing import _random_keys, one_cpu_thread
from tests.test_torch_dense import jax_state_dict as dense_dict
from tests.test_torch_sparse import jax_state_dict as sparse_dict

one_cpu_thread()

N, S = 48, 128


def _dense_pair(seed):
    rng = np.random.default_rng(seed)
    js = JS.init_full_view(N)
    js = dataclasses.replace(
        js,
        view=jnp.asarray(_random_keys(rng, (N, N))),
        alive=jnp.asarray(rng.random(N) < 0.8),
        inc_self=jnp.asarray(rng.integers(0, 5, N).astype(np.int32)),
        epoch=jnp.asarray(rng.integers(0, 3, N).astype(np.int32)),
        useen=jnp.asarray(rng.random((N, js.useen.shape[1])) < 0.3),
        tick=jnp.asarray(17, jnp.int32),
    )
    return js, dense_state_from_numpy(dense_dict(js), device="cpu")


def _sparse_pair(seed):
    rng = np.random.default_rng(seed)
    js = J.init_sparse_full_view(N, S)
    subj = np.full(S, -1, np.int32)
    subj[rng.choice(S, 30, replace=False)] = rng.choice(N, 30, replace=False)
    js = js.replace(
        slab=jnp.asarray(_random_keys(rng, (N, S))),
        slot_subj=jnp.asarray(subj),
        alive=jnp.asarray(rng.random(N) < 0.8),
        inc_self=jnp.asarray(rng.integers(0, 5, N).astype(np.int32)),
        epoch=jnp.asarray(rng.integers(0, 3, N).astype(np.int32)),
        wb_pinned=jnp.asarray(rng.random(S) < 0.5),
        wb_valid=jnp.asarray(True),
        useen=jnp.asarray(rng.random((N, 4)) < 0.3),
        tick=jnp.asarray(33, jnp.int32),
    )
    return js, sparse_state_from_numpy(sparse_dict(js), device="cpu")


@pytest.mark.parametrize("seed", [0, 1])
def test_dense_views_and_summary_match_jax(seed):
    js, ts = _dense_pair(seed)
    for node in (0, 7, N - 1):
        assert dataclasses.asdict(TM.node_view(ts, node)) == dataclasses.asdict(
            JM.node_view(js, node))
    assert TM.cluster_summary(ts) == JM.cluster_summary(js)
    for node, slot in ((3, 0), (5, 2)):
        assert TM.user_gossip_swept(ts, node, slot) == JM.user_gossip_swept(js, node, slot)
    assert [TM.user_gossip_slot_free(ts, g) for g in range(4)] == [
        JM.user_gossip_slot_free(js, g) for g in range(4)
    ]


@pytest.mark.parametrize("seed", [0, 1])
def test_sparse_summary_matches_jax(seed):
    """With and without traces (device tensors and host arrays), and with
    the pin mask absent."""
    js, ts = _sparse_pair(seed)
    rng = np.random.default_rng(seed + 10)
    traces = {k: rng.integers(0, 50, 12).astype(np.int32)
              for k in ("link_attempts", "link_delivered", "fault_blocked", "fault_lost")}
    assert TM.sparse_summary(ts) == JM.sparse_summary(js)
    assert TM.sparse_summary(ts, traces) == JM.sparse_summary(js, traces)
    ttr = {k: torch.from_numpy(v) for k, v in traces.items()}
    assert TM.sparse_summary(ts, ttr) == JM.sparse_summary(js, traces)
    bare = ts.replace(wb_pinned=None, wb_valid=None)
    jbare = js.replace(wb_pinned=None, wb_valid=None)
    assert TM.sparse_summary(bare) == JM.sparse_summary(jbare)
    assert TM.user_gossip_slot_free(ts, 1) == JM.user_gossip_slot_free(js, 1)


def test_sparse_summary_on_a_port_run():
    """The summary of a state the port's own engine produced, and its
    batched form over two stacked universes (one vector per value)."""
    p = T.SparseParams.for_n(64, slot_budget=128, in_scan_writeback=False)
    ts = T.kill_sparse(T.init_sparse_full_view(64, 128, device="cpu"), 5)
    ts, tr = T.run_sparse_ticks(p, ts, TPlan.uniform(5.0, device="cpu"), 10)
    one = TM.sparse_summary(ts, tr)
    assert one["tick"] == 10 and one["n_alive_processes"] == 63 and one["n"] == 64
    assert one["link_attempts_total"] == int(tr["link_attempts"].sum())
    fields = {f.name: getattr(ts, f.name) for f in dataclasses.fields(ts)}
    stacked = ts.replace(**{
        k: torch.stack([v, v]) for k, v in fields.items()
        if isinstance(v, torch.Tensor)
    })
    two = TM.sparse_summary(stacked)
    for k, v in TM.sparse_summary(ts).items():
        if k in ("n", "slot_budget"):
            assert two[k] == v
        else:
            assert list(two[k]) == [v, v], k
