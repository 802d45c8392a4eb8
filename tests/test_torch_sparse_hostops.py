"""The sparse engine's host ops and scheduled events against the JAX
package, on the CPU.

From one mid-run state carried across by ``sim/convert.py``, each host op
(``leave_sparse``, ``update_metadata_sparse``, ``restart_sparse``,
``restart_many_sparse``, ``kill_sparse`` with an index array,
``inject_gossip_sparse``) and ``apply_events_sparse`` (2- and 3-tuple)
must leave every state leaf equal to the reference's, write-back pin mask
included; each error the reference raises is raised with its message.
Tolerance: none.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from scalecube_cluster_tpu.sim import sparse as J
from scalecube_cluster_tpu.sim.faults import FaultPlan as JPlan
from scalecube_cluster_tpu_torch.ops.merge import EPOCH_MAX
from scalecube_cluster_tpu_torch.sim import sparse as T
from scalecube_cluster_tpu_torch.sim.convert import sparse_state_from_numpy
from tests.test_sparse import sparse_params
from tests.test_torch_sparse import assert_same_state, jax_state_dict
from scalecube_cluster_tpu_torch.testing import one_cpu_thread, shared_result

one_cpu_thread()

_MID = {}


def mid_run():
    """A JAX state after 24 ticks (n=64, S=128, the kernel route, a kill,
    10% loss, the latency recorder on, a host-boundary free after tick 12):
    slots active, timers armed, the pin mask carried. Cached; each test gets fresh copies on both sides."""
    if not _MID:
        def compute():
            jp = dataclasses.replace(sparse_params(64, slot_budget=128, suspicion_ticks=12),
                                     in_scan_writeback=False, pallas_core=True)
            js = J.kill_sparse(J.init_sparse_full_view(64, 128, user_gossip_slots=2,
                                                       record_latency=True), 5)
            js, _ = J.run_sparse_chunked(jp, js, JPlan.uniform(10.0), 12, chunk=12)
            js, _ = J.run_sparse_ticks(jp, js, JPlan.uniform(10.0), 12)
            return jax_state_dict(js)

        _MID["d"] = shared_result("test_torch_sparse_hostops.mid_run", compute)
    d = _MID["d"]
    js = J.SparseState(**{k: jnp.asarray(v) for k, v in d.items()})
    return js, sparse_state_from_numpy(d, device="cpu")


OPS = {
    "leave": lambda st, m: m.leave_sparse(st, 9),
    "leave_active": lambda st, m: m.leave_sparse(st, 5),
    "update_metadata": lambda st, m: m.update_metadata_sparse(st, 12),
    "leaver_keeps_tombstone": lambda st, m: m.update_metadata_sparse(m.leave_sparse(st, 9), 9),
    "restart": lambda st, m: m.restart_sparse(st, 5),
    "restart_many": lambda st, m: m.restart_many_sparse(st, np.array([5, 17, 30, 2])),
    "restart_many_empty": lambda st, m: m.restart_many_sparse(st, []),
    "kill_array": lambda st, m: m.kill_sparse(st, np.array([3, 40, 41])),
    "inject_gossip": lambda st, m: m.inject_gossip_sparse(st, 7, 1),
}


@pytest.mark.parametrize("op", sorted(OPS))
def test_host_op_matches_jax(op):
    js, ts = mid_run()
    assert bool(js.wb_valid)
    assert_same_state(OPS[op](js, J), OPS[op](ts, T), op)


def test_host_op_errors_match_jax():
    js, ts = mid_run()
    cases = [
        lambda st, m: m.restart_many_sparse(st, [3, 4, 3]),
        lambda st, m: m.restart_sparse(st.replace(epoch=st.epoch.at[6].set(EPOCH_MAX))
                                       if m is J else _set_epoch(st, 6, EPOCH_MAX), 6),
    ]
    for case in cases:
        with pytest.raises(ValueError) as je:
            case(js, J)
        with pytest.raises(ValueError) as te:
            case(ts, T)
        assert str(je.value) == str(te.value)
    # A full slot table refuses both the single and the batched activation.
    for op in (lambda st, m: m.leave_sparse(st, 20),
               lambda st, m: m.restart_many_sparse(st, [20, 21])):
        js2 = J.init_sparse_full_view(32, 1)
        ts2 = T.init_sparse_full_view(32, 1, device="cpu")
        js2, ts2 = J.leave_sparse(js2, 3), T.leave_sparse(ts2, 3)
        with pytest.raises(RuntimeError) as je:
            op(js2, J)
        with pytest.raises(RuntimeError) as te:
            op(ts2, T)
        assert str(je.value) == str(te.value)


def _set_epoch(st, idx, value):
    epoch = st.epoch.clone()
    epoch[idx] = value
    return st.replace(epoch=epoch)


@pytest.mark.parametrize("gossip", [False, True], ids=["2-tuple", "3-tuple"])
def test_apply_events_sparse_matches_jax(gossip):
    js, ts = mid_run()
    n = 64
    kill = np.zeros(n, bool)
    kill[[2, 8, 33]] = True
    restart = np.zeros(n, bool)
    restart[[8, 5, 50]] = True
    g = np.zeros((n, 2), bool)
    g[[1, 9], [0, 1]] = True
    jev = [jnp.asarray(kill), jnp.asarray(restart)] + ([jnp.asarray(g)] if gossip else [])
    tev = [torch.from_numpy(kill), torch.from_numpy(restart)] + (
        [torch.from_numpy(g)] if gossip else [])
    assert_same_state(J.apply_events_sparse(js, *jev), T.apply_events_sparse(ts, *tev), "events")
    # No event: the state (its carried pin mask included) stays as it was.
    none = [np.zeros_like(kill), np.zeros_like(restart)]
    assert_same_state(
        J.apply_events_sparse(js, *map(jnp.asarray, none)),
        T.apply_events_sparse(ts, *map(torch.from_numpy, none)), "no event",
    )
    # The 4-tuple (a join mask, here on a fixed-shape state: fresh
    # identities without a live_mask to set) as the reference applies it.
    join = np.zeros(n, bool)
    join[[12, 60]] = True
    assert_same_state(
        J.apply_events_sparse(js, *jev[:2], jev[2] if gossip else None, jnp.asarray(join)),
        T.apply_events_sparse(ts, *tev[:2], tev[2] if gossip else None, torch.from_numpy(join)),
        "join",
    )
