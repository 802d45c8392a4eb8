"""The port's fault timelines against the JAX package, on the CPU.

The same ``ScheduleBuilder`` calls on both packages give equal
``FaultSchedule`` fields and the same 12-hex digest; every lookup
(``segment_at``, ``plan_at`` with the flap overlay, ``plan_dirty_at``,
``events_at``, ``scheduled_kill_ticks``, ``resolve_tick``) agrees at every
tick; every static check of ``build`` raises the reference's error; and
whole dense and sparse trajectories under a schedule (a partition, a flap, a
geo world, kills and restarts, host ops between chunks) equal the
reference's after every chunk, every state leaf and every trace key.
Tolerance: none.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from scalecube_cluster_tpu.sim import run as JR
from scalecube_cluster_tpu.sim import schedule as JSch
from scalecube_cluster_tpu.sim import sparse as JS
from scalecube_cluster_tpu.sim import state as JD
from scalecube_cluster_tpu.sim.faults import FaultPlan as JPlan
from scalecube_cluster_tpu.sim.topology import LinkWorld as JWorld
from scalecube_cluster_tpu_torch.sim import run as TR
from scalecube_cluster_tpu_torch.sim import schedule as TSch
from scalecube_cluster_tpu_torch.sim import sparse as TS
from scalecube_cluster_tpu_torch.sim import state as TD
from scalecube_cluster_tpu_torch.sim.convert import dense_state_from_numpy
from scalecube_cluster_tpu_torch.sim.faults import FaultPlan as TPlan
from scalecube_cluster_tpu_torch.sim.topology import LinkWorld as TWorld
from tests.test_sparse import sparse_params
from tests.test_torch_dense import assert_same_state as dense_same
from tests.test_torch_dense import assert_same_traces as dense_traces
from tests.test_torch_dense import jax_state_dict as dense_dict
from tests.test_torch_dense import params as dense_params
from tests.test_torch_sparse import assert_same_state, assert_same_traces, port_params
from tests.test_torch_topology import same, same_world
from scalecube_cluster_tpu_torch.testing import one_cpu_thread

one_cpu_thread()

#: The two packages' schedule vocabularies, side by side.
JAX = dict(Plan=JPlan, World=JWorld, Builder=JSch.ScheduleBuilder, dev={})
PORT = dict(Plan=TPlan, World=TWorld, Builder=TSch.ScheduleBuilder, dev={"device": "cpu"})


def timeline(m, n, world=True, events=True):
    """Loss with a 2-zone brownout and zone loss; a dense partition with a
    flapping link set; clean; kills, restarts, a bounce and a join."""
    d = m["dev"]
    w = m["World"].even_zones(n, 2, **d).with_zone_latency(0, 1, 400.0).with_zone_loss(0, 1, 0.1)
    flap = np.zeros((n, n), bool)
    flap[: n // 4, n // 2:] = True
    b = (
        m["Builder"](n)
        .add_segment(1, m["Plan"].uniform(5.0, **d), link_world=w if world else None)
        .add_segment(
            13, m["Plan"].clean(n, **d).partition(range(n // 3), range(n // 3, n)).with_loss(2.0),
            flap_mask=flap, flap_period=5, flap_on=2,
        )
        .add_segment(25, m["Plan"].uniform(0.0, 20.0, **d))
    )
    if events:
        b = b.kill(3, 7).kill(4, 11).restart(10, 7).kill(16, 2).restart(16, 2).restart(30, 11)
        b = b.join(20, 5)
    return b.build()


def uniform_only(m, n):
    d = m["dev"]
    return m["Builder"](n).add_segment(1, m["Plan"].uniform(5.0, **d)).add_segment(
        9, m["Plan"].uniform(1.0, 3.0, **d)).kill(2, 0).build()


SCHEDULES = {
    "full": lambda m, n: timeline(m, n),
    "flat": lambda m, n: timeline(m, n, world=False),
    "no_events": lambda m, n: timeline(m, n, events=False),
    "uniform": uniform_only,
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedule_fields_digest_and_lookups_match_jax(name):
    n = 24
    js, ts = SCHEDULES[name](JAX, n), SCHEDULES[name](PORT, n)
    for f in dataclasses.fields(js):
        if f.name == "link_world":
            if js.link_world is None:
                assert ts.link_world is None
            else:
                same_world(js.link_world, ts.link_world, "link_world")
        else:
            same(getattr(js, f.name), getattr(ts, f.name), f.name)
    assert js.digest() == ts.digest()
    assert js.n_segments == ts.n_segments
    assert JSch.scheduled_kill_ticks(js) == TSch.scheduled_kill_ticks(ts)
    for t in range(0, 40):
        tj = jnp.int32(t)
        assert int(JSch.segment_at(js, tj)) == TSch.segment_at(ts, t)
        assert bool(JSch.plan_dirty_at(js, tj)) == TSch.plan_dirty_at(ts, t)
        (jp, (jk, jr)), (tp, (tk, tr)) = JSch.resolve_tick(js, tj, n), TSch.resolve_tick(ts, t, n)
        for f in ("block", "loss", "mean_delay"):
            same(getattr(jp, f), getattr(tp, f), f"t={t} {f}")
        if jp.link_world is not None:
            same_world(jp.link_world, tp.link_world, f"t={t}")
        same(jk, tk, f"t={t} kill")
        same(jr, tr, f"t={t} restart")


def test_digest_tracks_every_field():
    """The digest changes with the world's matrices and with an event."""
    n = 24
    base = timeline(PORT, n).digest()
    assert timeline(PORT, n, world=False).digest() != base
    assert timeline(PORT, n, events=False).digest() != base


def _errors(m, n):
    """Builder misuse, one case each (the reference's order of checks)."""
    d = m["dev"]
    P, B = m["Plan"], m["Builder"]
    w = m["World"].even_zones(n, 2, **d)
    return [
        lambda: B(n).build(),
        lambda: B(n).add_segment(1, P.uniform(**d)).add_segment(1, P.uniform(**d)).build(),
        lambda: B(n).add_segment(1, P.clean(n + 1, **d)).build(),
        lambda: B(n).add_segment(1, P.uniform(**d), flap_mask=np.ones((2, 2), bool),
                                 flap_period=3, flap_on=1).build(),
        lambda: B(n).add_segment(1, P.uniform(**d), flap_mask=np.ones((1, 1)), flap_period=2,
                                 flap_on=3),
        lambda: B(n).add_segment(1, P.uniform(**d), flap_period=2, flap_on=1),
        lambda: B(n).add_segment(1, P.uniform(**d).with_link_world(w), link_world=w),
        lambda: B(n).add_segment(1, P.uniform(**d)).kill(0, 1).build(),
        lambda: B(n).add_segment(1, P.uniform(**d)).kill(3, n).build(),
        lambda: B(n).add_segment(1, P.uniform(**d)).restart(3, 1).restart(3, 1).build(),
        lambda: B(n).add_segment(1, P.uniform(**d)).join(3, 1).join(3, 1).build(),
        lambda: B(n).add_segment(1, P.uniform(**d)).restart(3, 1).join(4, 1).build(
            epoch0=510),
        lambda: B(n).add_segment(1, P.uniform(**d)).add_segment(
            5, P.uniform(**d), link_world=m["World"].even_zones(n, 3, **d)).add_segment(
            9, P.uniform(**d), link_world=w).build(),
    ]


def test_builder_errors_match_jax():
    n = 16
    for k, (jf, tf) in enumerate(zip(_errors(JAX, n), _errors(PORT, n))):
        with pytest.raises(ValueError) as je:
            jf()
        with pytest.raises(ValueError) as te:
            tf()
        assert str(je.value) == str(te.value), k


def test_apply_events_dense_matches_jax():
    """Kill, restart and a bounce on a mid-run tracked state."""
    n = 32
    jp, _ = dense_params(n, False)
    js = JD.init_full_view(n, user_gossip_slots=2, seed=1, track_infected=True)
    jp = dataclasses.replace(jp, track_user_infected=True)
    js, _ = JR.run_ticks(jp, JD.inject_gossip(js, 3, 1), JPlan.uniform(10.0),
                         JD.seeds_mask(n, [0]), 7)
    ts = dense_state_from_numpy(dense_dict(js), device="cpu")
    kill = np.zeros(n, bool)
    kill[[2, 5, 9]] = True
    restart = np.zeros(n, bool)
    restart[[5, 3]] = True
    js = JSch.apply_events_dense(js, jnp.asarray(kill), jnp.asarray(restart))
    ts = TSch.apply_events_dense(ts, torch.from_numpy(kill), torch.from_numpy(restart))
    dense_same(dense_dict(js), ts, "events")


@pytest.mark.parametrize("pallas", [True, False], ids=["fused", "xla"])
def test_dense_trajectory_under_schedule_matches_jax(pallas):
    """n=128: the full timeline (world with zone loss, a partition whose
    flap mask rides a 5-tick wave, a uniform delay, kills, restarts, a
    bounce, a join the engine skips) over 36 ticks in chunks of 12, with a
    host restart between chunks; collected traces include ``plan_dirty``,
    ``kills_fired``, ``restarts_fired`` and the ``zone_*`` gauges."""
    n = 128
    jp, tp = dense_params(n, pallas)
    jsched, tsched = timeline(JAX, n), timeline(PORT, n)
    js = JD.init_full_view(n, user_gossip_slots=2, seed=5)
    ts = TD.init_full_view(n, user_gossip_slots=2, seed=5, device="cpu")
    jseeds, tseeds = JD.seeds_mask(n, [0, 1]), TD.seeds_mask(n, [0, 1], device="cpu")
    for c in range(3):
        js, jtr = JR.run_chunked(jp, js, jsched, jseeds, 12, chunk=12)
        ts, ttr = TR.run_chunked(tp, ts, tsched, tseeds, 12, chunk=12)
        dense_same(dense_dict(js), ts, f"chunk {c}")
        dense_traces(jtr, ttr, f"chunk {c}")
        if c == 0:
            js, ts = JD.restart(js, 40), TD.restart(ts, 40)
    assert "zone_intra_conv" in jtr and int(jtr["kills_fired"].sum()) >= 0


def sparse_case(n, s, pallas, **kw):
    jp = dataclasses.replace(
        sparse_params(n, slot_budget=s, suspicion_ticks=12), in_scan_writeback=False,
        pallas_core=pallas, **kw,
    )
    return jp, port_params(jp)


@pytest.mark.parametrize(
    "n,s,pallas",
    [(256, 128, True), (40, 100, False), (24, 64, False)],
    ids=["256-kernel", "40-group8", "24-group8"],
)
def test_sparse_trajectory_under_schedule_matches_jax(n, s, pallas):
    """The full timeline on the sparse engine over 36 ticks in chunks of
    12, host ops between chunks (restart_many_sparse, leave_sparse,
    update_metadata_sparse, kill_sparse with an array): the kernel route at
    n=256, S=128, and the XLA chain with 8-row groups at n=40 and n=24."""
    jp, tp = sparse_case(n, s, pallas)
    jsched, tsched = timeline(JAX, n), timeline(PORT, n)
    js = JS.init_sparse_full_view(n, s, user_gossip_slots=2, record_latency=True)
    ts = TS.init_sparse_full_view(n, s, user_gossip_slots=2, record_latency=True, device="cpu")
    between = [
        lambda st, m: m.restart_many_sparse(st, [1, 9]),
        lambda st, m: m.update_metadata_sparse(m.leave_sparse(st, 4), 6),
    ]
    for c in range(3):
        js, jtr = JS.run_sparse_chunked(jp, js, jsched, 12, chunk=12)
        ts, ttr = TS.run_sparse_chunked(tp, ts, tsched, 12, chunk=12)
        assert_same_state(js, ts, f"chunk {c}")
        assert_same_traces(jtr, ttr, f"chunk {c}")
        if c < len(between):
            js, ts = between[c](js, JS), between[c](ts, TS)
    idx = np.array([3, 8])
    assert_same_state(JS.kill_sparse(js, idx), TS.kill_sparse(ts, idx), "kill array")
