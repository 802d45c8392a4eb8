"""The port's sparse-engine write-back paths and host ops against the JAX
package, on the CPU.

The in-tick write-back (``in_scan_writeback=True``), the host-boundary
``writeback_free`` in both of its pin-mask modes (carried and recomputed),
the host ops and ``effective_view`` start both packages from the same state
and must agree bit for bit on every state leaf (``rng`` included) and every
counter. Tolerance: none.
"""

import dataclasses

import jax
import numpy as np

from scalecube_cluster_tpu.sim import sparse as J
from scalecube_cluster_tpu.sim.faults import FaultPlan as JPlan
from scalecube_cluster_tpu_torch.sim import sparse as T
from scalecube_cluster_tpu_torch.sim.convert import (
    sparse_state_from_numpy,
    sparse_state_to_numpy,
)
from scalecube_cluster_tpu_torch.sim.faults import FaultPlan as TPlan
from tests.test_sparse import sparse_params
from tests.test_torch_sparse import (
    assert_same_state,
    assert_same_traces,
    jax_state_dict,
    port_params,
)
from scalecube_cluster_tpu_torch.testing import one_cpu_thread

one_cpu_thread()

_RUN = {}


def _in_tick_writeback_run():
    """JAX: n=64, S=128, write-back every 4 ticks inside the tick, a kill,
    10% loss, 2 x 20 ticks collected — cached per module."""
    if not _RUN:
        n, S = 64, 128
        jp = dataclasses.replace(
            sparse_params(n, slot_budget=S, suspicion_ticks=12),
            writeback_period=4, pallas_core=True,
        )
        js = J.kill_sparse(J.init_sparse_full_view(n, S, user_gossip_slots=2), 9)
        snaps = [(jax_state_dict(js), None)]
        for _ in range(2):
            js, tr = J.run_sparse_ticks(jp, js, JPlan.uniform(10.0), 20)
            snaps.append((jax_state_dict(js), jax.tree_util.tree_map(np.asarray, tr)))
        _RUN.update(jp=jp, snaps=snaps)
    return _RUN["jp"], _RUN["snaps"]


def test_in_tick_writeback_matches_jax():
    """in_scan_writeback=True: frees and view_T write-backs inside the tick
    on its cadence, slot_frees counted, over 40 ticks."""
    jp, snaps = _in_tick_writeback_run()
    tp = port_params(jp)
    ts = T.kill_sparse(T.init_sparse_full_view(64, 128, user_gossip_slots=2, device="cpu"), 9)
    frees = 0
    for c, (jd, jtr) in enumerate(snaps[1:]):
        ts, ttr = T.run_sparse_ticks(tp, ts, TPlan.uniform(10.0, device="cpu"), 20)
        b = sparse_state_to_numpy(ts)
        for k in jd:
            assert np.array_equal(jd[k], b[k]), (c, k)
        assert_same_traces(jtr, {k: v.numpy() for k, v in ttr.items()}, f"chunk {c}")
        frees += int(jtr["slot_frees"].sum())
    assert frees > 0


def test_writeback_free_matches_jax_in_both_pin_modes():
    """writeback_free from a mid-run state, once consuming the kernel's
    carried pin mask (wb_valid) and once recomputing it after a host op
    invalidated the mask (kill_sparse)."""
    jp, snaps = _in_tick_writeback_run()
    tp = port_params(dataclasses.replace(jp, in_scan_writeback=False))
    jp = dataclasses.replace(jp, in_scan_writeback=False)
    base = snaps[1][0]
    assert bool(base["wb_valid"])
    for kill in (None, 3):
        js = J.SparseState(**{k: jax.numpy.asarray(v) for k, v in base.items()})
        ts = sparse_state_from_numpy(base, device="cpu")
        if kill is not None:
            js, ts = J.kill_sparse(js, kill), T.kill_sparse(ts, kill)
        js, ts = J.writeback_free(jp, js), T.writeback_free(tp, ts)
        assert_same_state(js, ts, f"kill={kill}")


def test_host_ops_and_effective_view_match_jax():
    """inject_gossip_sparse, kill_sparse and effective_view on a mid-run
    state; and the numpy round trip of sim/convert.py is the identity."""
    _, snaps = _in_tick_writeback_run()
    base = snaps[2][0]
    js = J.SparseState(**{k: jax.numpy.asarray(v) for k, v in base.items()})
    ts = sparse_state_from_numpy(base, device="cpu")
    rt = sparse_state_to_numpy(ts)
    assert set(rt) == set(base)
    assert all(np.array_equal(rt[k], base[k]) and rt[k].dtype == base[k].dtype for k in base)
    js = J.kill_sparse(J.inject_gossip_sparse(js, 11, 1), 12)
    ts = T.kill_sparse(T.inject_gossip_sparse(ts, 11, 1), 12)
    assert_same_state(js, ts, "host ops")
    assert np.array_equal(np.asarray(J.effective_view(js)), T.effective_view(ts).numpy())
