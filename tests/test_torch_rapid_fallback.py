"""The port's Rapid fallback plane (classic Paxos rounds and the join
handshake, ``fallback=True``) against the reference's, on the CPU: the
split-vote schedule of tests/test_rapid_fallback.py parked on the bare fast
path and committed through the classic rounds (with the flight recorder
and a protocol join), the certifiers' R5 and R3 negatives, the fallback and
join chains on the port's own ring, ``fanout_cap`` below H, the ensemble
twin carrying the fallback plane, the minority-stranded coordinator under a
one-way zone world, and elastic ``n_live`` runs with joins, then
``promote_rapid_state``. Every state leaf (fallback plane and ring
included) and every metric key equal, bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scalecube_cluster_tpu.sim import FaultPlan as JPlan
from scalecube_cluster_tpu.sim import ScheduleBuilder as JBuilder
from scalecube_cluster_tpu.sim import rapid as JR
from scalecube_cluster_tpu.sim.ensemble import stack_universes as j_stack
from scalecube_cluster_tpu.sim.topology import LinkWorld as JWorld
from scalecube_cluster_tpu.testlib import invariants as JI
from scalecube_cluster_tpu.testlib.chaos import rapid_chaos_params
from scalecube_cluster_tpu_torch.obs.trace import TK_FB_ACCEPT, TK_JOIN_CONFIRM, TK_VIEW_COMMIT
from scalecube_cluster_tpu_torch.obs.trace import ring_events
from scalecube_cluster_tpu_torch.sim import ensemble as TE
from scalecube_cluster_tpu_torch.sim import rapid as TR
from scalecube_cluster_tpu_torch.testing import one_cpu_thread, shared_result
from scalecube_cluster_tpu_torch.testlib import invariants as TI
from scalecube_cluster_tpu_torch.tools.trace_explain import check_rapid_chains, explain_verdict
from tests.test_torch_rapid import (
    SCHED_ONLY,
    assert_same_state,
    assert_same_traces,
    check_pair,
    host,
    port_schedule,
    ref_leaves,
    tparams,
)

one_cpu_thread()

N = 16
TICKS = 60


def split_vote_schedule(with_join: bool):
    """tests/test_rapid_fallback.py::_split_vote_schedule: kill 0 and 8 at
    tick 10 behind a one-way block {9..15} -> {1..7} over ticks [15, 17),
    so the two camps lock different cuts; ``with_join`` re-admits 8
    through the handshake at tick 40."""
    def build(n):
        blk = np.zeros((n, n), bool)
        blk[9:16, 1:8] = True
        one_way = JPlan(block=blk, loss=np.zeros((1, 1), np.float32),
                        mean_delay=np.zeros((1, 1), np.float32))
        b = (JBuilder(n).add_segment(1, JPlan.clean(n)).add_segment(15, one_way)
             .add_segment(17, JPlan.clean(n)).kill(10, 0).kill(10, 8))
        if with_join:
            b.join(40, 8)
        return b.build()
    return build


@pytest.fixture(scope="module")
def parked_run():
    rp = rapid_chaos_params(N)
    return (rp,) + check_pair("parked120", rp, split_vote_schedule(False), 120, seed=7)


@pytest.fixture(scope="module")
def fallback_run():
    rp = rapid_chaos_params(N)
    return (rp,) + check_pair("fallback60", rp, split_vote_schedule(True), TICKS, seed=7,
                              trace_capacity=4096, fallback=True)


def test_fallback_off_state_has_no_fallback_plane():
    rp = tparams(rapid_chaos_params(N))
    assert TR.init_rapid_full_view(rp, device="cpu").fb is None
    assert TR.init_rapid_full_view(rp, fallback=True, device="cpu").fb is not None


def test_split_vote_parks_bare_fast_path(parked_run):
    rp, jtr, _, ttr = parked_run
    summary = TI.certify_rapid_traces(tparams(rp), ttr, fallback=False)
    assert summary == JI.certify_rapid_traces(rp, jtr, fallback=False)
    assert summary["cut_detected"] > 0 and summary["view_changes"] == 0
    assert summary["views_parked"] == 1
    assert float(ttr["convergence"][-1]) < 1.0


def test_split_vote_commits_under_fallback(fallback_run):
    rp, jtr, tst, ttr = fallback_run
    summary = TI.certify_rapid_traces(tparams(rp), ttr, fallback=True)
    assert summary == JI.certify_rapid_traces(rp, jtr, fallback=True)
    assert summary["views_parked"] == 0 and summary["fallback_commits"] > 0
    assert summary["join_requests"] >= 1 and summary["join_confirms"] >= 1
    assert float(ttr["convergence"][-1]) == 1.0
    assert bool(tst.alive[8])


def test_r5_bound_matches_reference():
    for n in (8, 16, 64):
        rp = rapid_chaos_params(n)
        assert TI.r5_bound(tparams(rp)) == JI.r5_bound(rp)


def _raises_same(rp, traces, fallback, expected):
    with pytest.raises(JI.InvariantViolation) as je:
        JI.certify_rapid_traces(rp, traces, fallback=fallback)
    with pytest.raises(TI.InvariantViolation) as te:
        TI.certify_rapid_traces(tparams(rp), traces, fallback=fallback)
    assert je.value.invariant == te.value.invariant == expected
    assert str(je.value) == str(te.value)


def test_certifier_negatives_under_fallback(parked_run, fallback_run):
    """R5-parked on the parked trace, R5-commit-cause on a commit with no
    cut behind it, and R3 still armed under the fallback: the port's copy
    raises what the reference raises."""
    rp, _, _, parked = parked_run
    _raises_same(rp, parked, True, "R5-parked")
    rp, _, _, traces = fallback_run
    tampered = dict(traces)
    tampered["cut_detected"] = np.zeros_like(traces["cut_detected"])
    _raises_same(rp, tampered, True, "R5-commit-cause")
    tampered = {k: np.array(v) for k, v in traces.items()}
    n = tampered["view_digest"].shape[1]
    tampered["alive_mask"][5, :] = True
    tampered["view_id"][5, :] = 3
    tampered["view_digest"][5, : n // 2] = 111
    tampered["view_digest"][5, n // 2:] = 222
    tampered["view_size"][5, :] = n // 2
    _raises_same(rp, tampered, True, "R3-split-brain")


def test_fallback_commit_chain_walks_to_vote(fallback_run):
    """The port's ring: a fallback-committed view change walks back through
    fb_accept -> fb_prepare to the coordinator's vote, a confirmed join to
    its request, ``check_rapid_chains`` finds nothing, and a severed chain
    is refused."""
    _, _, tst, _ = fallback_run
    events = ring_events(tst.trace)
    fb_commits = [e for e in events if e["kind"] == TK_VIEW_COMMIT and e["cause"] >= 0]
    joins = [e for e in events if e["kind"] == TK_JOIN_CONFIRM]
    assert fb_commits and joins
    assert check_rapid_chains(events) == []
    exp = explain_verdict(events, fb_commits[0])
    assert exp["complete"], exp["violations"]
    assert [e["kind_name"] for e in exp["chain"]] == [
        "view_commit", "fb_accept", "fb_prepare", "vote"]
    expj = explain_verdict(events, joins[0])
    assert [e["kind_name"] for e in expj["chain"]] == ["join_confirm", "join_ack", "join_req"]
    accept_i = next(e["i"] for e in events if e["kind"] == TK_FB_ACCEPT)
    tampered = [dict(e) for e in events]
    tampered[accept_i]["cause"] = -1
    assert any("unresolved cause" in v for v in check_rapid_chains(tampered))


def test_check_rapid_chains_copy_matches_reference(fallback_run):
    """The copy of tools/trace_explain.py::check_rapid_chains gives the
    reference's violations on the same events, clean and tampered."""
    from tools.trace_explain import check_rapid_chains as ref_check

    _, _, tst, _ = fallback_run
    events = ring_events(tst.trace)
    assert check_rapid_chains(events) == ref_check(events) == []
    tampered = [dict(e) for e in events]
    for e in tampered:
        if e["kind"] in (TK_FB_ACCEPT, TK_JOIN_CONFIRM):
            e["cause"] = -1
    assert check_rapid_chains(tampered) == ref_check(tampered) != []


def test_fanout_cap_below_h_starves_detection():
    rp = rapid_chaos_params(N)

    def plan(n):
        return JBuilder(n).add_segment(0, JPlan.clean(n)).kill(10, 3).build()

    _, _, ttr = check_pair("starved", rp, plan, TICKS, knobs=(1.0, rp.high_watermark - 1))
    assert int(ttr["cut_detected"].sum()) == 0 and int(ttr["view_changes"].sum()) == 0


def test_ensemble_twin_carries_fallback():
    """B=2 universes with the fallback plane against the reference's vmap,
    universe 1 against the port's solo run, and the batched certifier."""
    rp = rapid_chaos_params(N)
    ticks, seeds = 50, [7, 11]
    sched = split_vote_schedule(True)(N)

    def compute():
        states = JR.init_ensemble_rapid(rp, seeds, fallback=True)
        st, tr = JR.run_ensemble_rapid_ticks(rp, states, j_stack([sched, sched]), ticks)
        return ref_leaves(st), {k: np.asarray(v) for k, v in jax.device_get(tr).items()}

    jleaves, jtr = shared_result("test_torch_rapid_fallback.ensemble", compute)
    states = TR.init_ensemble_rapid(tparams(rp), seeds, fallback=True, device="cpu")
    plans = TE.stack_universes([port_schedule(sched), port_schedule(sched)])
    tst, ttr = TR.run_ensemble_rapid_ticks(tparams(rp), states, plans, ticks)
    assert_same_state(jleaves, tst, "ensemble")
    assert_same_traces(jtr, ttr, "ensemble")
    solo_st, solo = TR.run_rapid_ticks(
        tparams(rp), TR.init_rapid_full_view(tparams(rp), seed=11, fallback=True, device="cpu"),
        port_schedule(sched), ticks)
    for k in set(solo) - SCHED_ONLY:
        assert torch.equal(solo[k], ttr[k][1]), k
    for f in dataclasses.fields(solo_st.fb):
        assert torch.equal(getattr(solo_st.fb, f.name), getattr(tst.fb, f.name)[1]), f.name
    got = TI.certify_rapid_population(tparams(rp), host(ttr), fallback=True)
    want = JI.certify_rapid_population(rp, jtr, fallback=True)
    assert np.array_equal(got["ok"], want["ok"]) and got["summaries"] == want["summaries"]
    assert bool(np.all(got["ok"]))


GEO_MINORITY = (1, 4, 7, 10, 13)


def _stranded(n):
    """tests/test_rapid_fallback.py::_stranded_coordinator_schedule: the
    minority zone hears the majority but cannot speak to it from tick 8."""
    zone = np.zeros(n, np.int32)
    zone[list(GEO_MINORITY)] = 1
    world = JWorld.from_zones(jnp.asarray(zone), n_zones=2).block_zones(1, 0, symmetric=False)
    return (JBuilder(n).add_segment(0, JPlan.clean(n))
            .add_segment(8, JPlan.clean(n).with_link_world(world)).build())


def test_minority_stranded_coordinator_commits_after_rotation():
    rp = rapid_chaos_params(N)
    assert int((np.asarray(JR._mix32(jnp.uint32(0))) + 1) % N) == int(
        (TR._mix32(torch.tensor(0)) + 1) % N) in GEO_MINORITY
    _, _, bare = check_pair("stranded-bare", rp, _stranded, 120, seed=7)
    assert int(bare["cut_detected"].sum()) > 0 and int(bare["view_changes"].sum()) == 0
    jtr, _, ttr = check_pair("stranded-fb", rp, _stranded, 120, seed=7,
                             trace_capacity=4096, fallback=True)
    cut = np.nonzero(ttr["cut_detected"])[0]
    commit = np.nonzero(ttr["view_changes"])[0]
    assert int(commit[0] - cut[0]) <= TI.r5_bound(tparams(rp))
    assert int(ttr["fallback_commits"].sum()) > 0
    assert TI.certify_rapid_traces(tparams(rp), ttr, fallback=True) == \
        JI.certify_rapid_traces(rp, jtr, fallback=True)


@pytest.mark.parametrize("fallback", [False, True], ids=["fast-path", "fallback"])
def test_elastic_joins_then_promote(fallback):
    """``n_live`` of 24 in 32 rows, the capacity rows joined one every two
    ticks from tick 3, then ``promote_rapid_state`` to 48 rows and 30 more
    ticks joining two promoted rows: equal to the reference all along."""
    n, n_live, n_new = 32, 24, 48
    rp = rapid_chaos_params(n)

    def plan(nn):
        b = JBuilder(nn).add_segment(0, JPlan.uniform(2.0))
        for i, node in enumerate(range(nn - 1, n_live - 1, -1)):
            b.join(3 + 2 * i, node)
        return b.build()

    def plan2(nn):
        return JBuilder(nn).add_segment(0, JPlan.uniform(2.0)).join(45, 47).join(47, 46).build()

    init = {"n_live": n_live, "fallback": fallback, "trace_capacity": 2048}
    _, tst, _ = check_pair(f"elastic-{fallback}", rp, plan, 40, seed=5, **init)

    def compute():
        st = JR.init_rapid_full_view(rp, seed=5, **init)
        st, _ = JR.run_rapid_ticks(rp, st, plan(n), 40)
        rp2, st2 = JR.promote_rapid_state(rp, st, n_new)
        promoted = ref_leaves(st2)
        st3, tr3 = JR.run_rapid_ticks(rp2, st2, plan2(n_new), 30)
        return (dataclasses.asdict(rp2), promoted, ref_leaves(st3),
                {k: np.asarray(v) for k, v in jax.device_get(tr3).items()})

    rp2_fields, promoted, final, jtr3 = shared_result(
        f"test_torch_rapid_fallback.promote-{fallback}", compute)
    tp2, tst2 = TR.promote_rapid_state(tparams(rp), tst, n_new)
    assert dataclasses.asdict(tp2) == rp2_fields
    assert_same_state(promoted, tst2, "promoted")
    tst3, ttr3 = TR.run_rapid_ticks(tp2, tst2, port_schedule(plan2(n_new)), 30)
    assert_same_state(final, tst3, "after promotion")
    assert_same_traces(jtr3, ttr3, "after promotion")
    with pytest.raises(ValueError) as je:
        JR.promote_rapid_state(rp, JR.init_rapid_full_view(rp), n)
    with pytest.raises(ValueError) as te:
        TR.promote_rapid_state(tparams(rp), tst, n)
    assert str(je.value) == str(te.value)
