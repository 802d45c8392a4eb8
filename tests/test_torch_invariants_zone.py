"""The port's zone and promotion certifiers (``scalecube_cluster_tpu_torch/
testlib/invariants.py``: ``z1_recover_bound``, ``zone_heal_bound``,
``certify_zone_traces``, ``certify_promotion``) against the reference's, on
the CPU.

The zone certifiers read the per-zone gauges of real geo runs (the
reference's dense engine on the chaos sampler's brownout3, oneway and split2
draws) with the sampler's windows, passing and tampered: both packages must
return the same summary or raise the same invariant with the same message.
The promotion certifier holds the port's ``promote_sparse_state`` (traced
and untraced, from the reference's grown elastic state) and the port's
``ServeBridge.promote``, and catches tampered promotions (the reference's
ghost capacity row and rewritten live row, a moved ring, lost causal
registers) under the reference's names and messages. Tolerance: none (exact).
"""

import dataclasses

import numpy as np
import pytest

from scalecube_cluster_tpu.sim.checkpoint import promote_sparse_state as j_promote
from scalecube_cluster_tpu.sim.params import SimParams as JSimParams
from scalecube_cluster_tpu.testlib import chaos as JC
from scalecube_cluster_tpu.testlib import invariants as JI
from scalecube_cluster_tpu_torch.serve.bridge import ServeBridge
from scalecube_cluster_tpu_torch.serve.ingest import event_from_obj
from scalecube_cluster_tpu_torch.sim.checkpoint import promote_sparse_state as t_promote
from scalecube_cluster_tpu_torch.sim.convert import (
    sparse_state_from_numpy,
    sparse_state_to_numpy,
)
from scalecube_cluster_tpu_torch.sim.params import SimParams as TSimParams
from scalecube_cluster_tpu_torch.sim.sparse import SparseParams, init_sparse_full_view
from scalecube_cluster_tpu_torch.testlib import invariants as TI
from scalecube_cluster_tpu_torch.testing import one_cpu_thread, shared_result
from tests.test_elastic import _grown_state
from tests.test_sim import small_params
from tests.test_torch_sparse import port_params
from tests.test_torch_tracer import jax_full_dict

one_cpu_thread()

GEO_N = 16
#: The chaos sampler's geo draws at n=16 (tests/test_torch_chaos.py pins
#: them): seed 0 brownout3, 1 oneway, 2 split2.
GEO_SEEDS = {"brownout3": 0, "oneway": 1, "split2": 2}


def _tparams(jp):
    return TSimParams(**dataclasses.asdict(jp))


@pytest.mark.parametrize(
    "jp",
    [
        JC.chaos_params(16),
        JC.chaos_params(1000),
        small_params(32),
        JSimParams.from_cluster_config(1000),
        JSimParams.from_cluster_config(10_000),
    ],
    ids=["chaos16", "chaos1000", "small32", "lan1000", "lan10000"],
)
def test_zone_bounds_match_reference(jp):
    tp = _tparams(jp)
    assert TI.z1_recover_bound(tp) == JI.z1_recover_bound(jp)
    for zones in (1, 2, 3, 5):
        assert TI.zone_heal_bound(tp, zones) == JI.zone_heal_bound(jp, zones)


def _geo_run(variant):
    """The reference's dense run of the sampler's ``variant`` draw: its
    traces as numpy arrays and the certification windows."""

    def compute():
        seed = GEO_SEEDS[variant]
        params = JC.chaos_params(GEO_N)
        sched, meta = JC.sample_geo_schedule(seed, GEO_N, with_meta=True)
        _, traces, _ = JC.run_scheduled("dense", params, sched, JC.geo_trial_ticks(params))
        return {k: np.array(v) for k, v in traces.items()}, meta

    return shared_result(f"zone-geo-run-{variant}-{GEO_N}", compute)


def _windows(meta):
    return dict(
        brownout=meta["brownout"],
        split=meta["split"],
        clean_zones=meta["clean_zones"],
        heal_start=meta["heal_row"],
        context=f"geo {meta['variant']}",
    )


def _zone_outcome(module, traces, **kw):
    """A certifier's summary, or the invariant and message it raised."""
    params = JC.chaos_params(GEO_N)
    if module is TI:
        params = _tparams(params)
    try:
        return module.certify_zone_traces(params, traces, **kw)
    except module.InvariantViolation as e:
        return (e.invariant, str(e))


def _tamper_brownout_verdict(tr, meta):
    tr["zone_false_dead"][meta["brownout"][0] + 3, 0] = 1


def _tamper_brownout_recovery(tr, meta):
    tr["zone_intra_conv"][meta["brownout"][1]:, 1] = 0.5


def _tamper_clean_zone_verdict(tr, meta):
    tr["zone_false_dead"][meta["split"][0] + 2, 1] = 2


def _tamper_heal(tr, meta):
    tr["zone_intra_conv"][-1, 0] = np.float32(0.9)


def _tamper_heal_dead(tr, meta):
    tr["zone_false_dead"][-2, -1] = 1


def _drop_key(tr, meta):
    del tr["zone_false_dead"]


def _flatten(tr, meta):
    tr["zone_intra_suspects"] = tr["zone_intra_suspects"][:, 0]


ZONE_CASES = [
    ("brownout3", None, None),
    ("oneway", None, None),
    ("split2", None, None),
    ("brownout3", _tamper_brownout_verdict, "Z1-brownout-verdict"),
    ("brownout3", _tamper_brownout_recovery, "Z1-brownout-recovery"),
    ("split2", _tamper_clean_zone_verdict, "Z2-clean-zone-verdict"),
    ("oneway", _tamper_clean_zone_verdict, "Z2-clean-zone-verdict"),
    ("split2", _tamper_heal, "Z3-zone-heal"),
    ("oneway", _tamper_heal_dead, "Z3-zone-heal"),
    ("brownout3", _drop_key, "schema"),
    ("split2", _flatten, "schema"),
]


@pytest.mark.parametrize(
    "variant, tamper, invariant",
    ZONE_CASES,
    ids=[f"{v}-{i or 'clean'}-{k}" for k, (v, _, i) in enumerate(ZONE_CASES)],
)
def test_certify_zone_traces_matches_reference(variant, tamper, invariant):
    traces, meta = _geo_run(variant)
    traces = {k: v.copy() for k, v in traces.items()}
    if tamper is not None:
        tamper(traces, meta)
    got = _zone_outcome(TI, traces, **_windows(meta))
    assert got == _zone_outcome(JI, traces, **_windows(meta))
    if invariant is None:
        assert isinstance(got, dict) and got["z3_checked"], got
        assert got["z1_checked"] == (variant == "brownout3")
        assert got["z2_checked"] == (variant != "brownout3")
    else:
        assert got[0] == invariant, got


def test_certify_zone_traces_without_windows_matches_reference():
    """No window given: nothing checked, the same summary."""
    traces, _ = _geo_run("split2")
    got = _zone_outcome(TI, traces)
    assert got == _zone_outcome(JI, traces)
    assert not (got["z1_checked"] or got["z2_checked"] or got["z3_checked"])


# ------------------------------------------------------------- promotion
_REF: dict = {}


def _grown(trace_capacity):
    """The reference's grown elastic state (24 live in 32 rows, joins,
    a kill and a restart over 160 ticks), its params, and the port's
    params and state converted from it (cached per module)."""
    if trace_capacity not in _REF:
        jp, js = _grown_state(trace_capacity=trace_capacity)
        _REF[trace_capacity] = (jp, js, port_params(jp), jax_full_dict(js))
    jp, js, tp, jd = _REF[trace_capacity]
    return jp, js, tp, sparse_state_from_numpy(jd, device="cpu")


def _promotion_outcome(module, params_old, state_old, params_new, state_new):
    try:
        return module.certify_promotion(params_old, state_old, params_new, state_new)
    except module.InvariantViolation as e:
        return (e.invariant, str(e))


@pytest.mark.parametrize("traced", [False, True], ids=["untraced", "traced"])
def test_certify_promotion_matches_reference(traced):
    """The port's promotion 32 -> 64 certifies P1-P3 with the reference's
    summary on the reference's promotion of the same state; the port's
    certifier also passes the reference's promoted state."""
    jp, js, tp, ts = _grown(2048 if traced else 0)
    tp2, ts2 = t_promote(tp, ts, 64)
    got = TI.certify_promotion(tp, ts, tp2, ts2)
    assert got["p3_checked"] == traced
    assert got["n_old"] == 32 and got["n_new"] == 64
    jp2, js2 = j_promote(jp, js, 64)
    assert got == JI.certify_promotion(jp, js, jp2, js2)
    js2_port = sparse_state_from_numpy(jax_full_dict(js2), device="cpu")
    assert TI.certify_promotion(tp, ts, tp2, js2_port) == got


def _ring(state, **changes):
    return state.replace(trace=state.trace.replace(**changes))


#: Each tamper as the port applies it and as the reference does.
PROMOTION_TAMPERS = {
    "ghost-row": (
        lambda s: s.replace(live_mask=s.live_mask.clone().index_fill_(0, _idx(50), True)),
        lambda s: s.replace(live_mask=s.live_mask.at[50].set(True)),
        "P2-capacity-rows",
    ),
    "rewritten-row": (
        lambda s: s.replace(view_T=s.view_T.clone().index_put_((_idx(3), _idx(5)), _one(s), accumulate=True)),
        lambda s: s.replace(view_T=s.view_T.at[3, 5].add(1)),
        "P1-live-rows",
    ),
    "moved-ring": (
        lambda s: _ring(s, cursor=s.trace.cursor + 1),
        lambda s: _ring(s, cursor=s.trace.cursor + 1),
        "P3-recorder",
    ),
    "lost-origin": (
        lambda s: _ring(s, origin=s.trace.origin.clone().fill_(-7)),
        lambda s: _ring(s, origin=s.trace.origin.at[:].set(-7)),
        "P3-recorder",
    ),
}


def _idx(i):
    import torch

    return torch.tensor([i])


def _one(s):
    import torch

    return torch.ones(1, dtype=s.view_T.dtype)


@pytest.mark.parametrize("case", sorted(PROMOTION_TAMPERS))
def test_tampered_promotion_caught_as_reference(case):
    """The reference's tampered promotions (tests/test_elastic.py) and two
    on the ring, applied to the port's promoted state and to the
    reference's: both certifiers raise the same invariant and message."""
    t_tamper, j_tamper, invariant = PROMOTION_TAMPERS[case]
    jp, js, tp, ts = _grown(2048)
    tp2, ts2 = t_promote(tp, ts, 64)
    got = _promotion_outcome(TI, tp, ts, tp2, t_tamper(ts2))
    jp2, js2 = j_promote(jp, js, 64)
    assert got == _promotion_outcome(JI, jp, js, jp2, j_tamper(js2))
    assert got[0] == invariant, got


def test_certify_promotion_refuses_shrink_as_reference():
    jp, js, tp, ts = _grown(0)
    got = _promotion_outcome(TI, tp, ts, tp, ts)
    assert got == _promotion_outcome(JI, jp, js, jp, js)
    assert got[0] == "P1-geometry"


def test_bridge_promotion_certifies():
    """``ServeBridge.promote`` (the checkpoint round trip, then the
    embedding) under a traced elastic session whose capacity the joins
    filled: certified P1-P3 against the state it started from. (A parked
    join replays through admission after the embedding and adds ring
    events, so P3 is held where none is parked.)"""
    params = SparseParams(base=small_params(16), slot_budget=64, alloc_cap=16)
    state = init_sparse_full_view(
        12, slot_budget=64, seed=3, n_alloc=16, trace_capacity=1024, device="cpu"
    )
    bridge = ServeBridge(params, state, batch_ticks=4, capacity=8)
    for _ in range(4):
        bridge.push(event_from_obj({"kind": "join"}))
    bridge.push(event_from_obj({"kind": "kill", "node": 2}))
    bridge.step_batch()
    bridge.step_batch()
    assert not bridge.batcher.deferred_joins
    before_params = bridge.params
    before = sparse_state_from_numpy(sparse_state_to_numpy(bridge.state), device="cpu")
    bridge.promote()
    summary = TI.certify_promotion(before_params, before, bridge.params, bridge.state)
    assert summary["p3_checked"] and summary["n_new"] == 32
    assert summary["n_live"] == 16
