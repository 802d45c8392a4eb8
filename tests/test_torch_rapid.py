"""The port's Rapid engine (``scalecube_cluster_tpu_torch/sim/rapid.py``)
against the reference's (``scalecube_cluster_tpu.sim.rapid``), on the CPU.

The same seeds, plans and schedules (built on the reference side and
converted field by field) go through both packages; every state leaf (the
fallback plane and the flight recorder's ring included) and every metric
key of every tick must be equal, bit for bit. Cases: the static parts
(params, observer ring, digest, the coordinator mix, the knob watermark,
init), the scenarios of tests/test_rapid.py (a clean run, the zero-event
schedule against the fixed plan, a kill and restart cycle and a same-tick
bounce, flapping only, knobs, chaos schedules, the ensemble twin, the
certifiers' tamper negatives), the scripted events applied alone, the two
helpers that replace the reference's [N, N, N] and full [N, N, k]
temporaries (``vote_groups`` / ``count_same`` against the literal pairwise
definition; ``link_pass_where`` against the full draw), and the zone loss
composition on Rapid's own edge shapes inside the tick (ROADMAP Queue C).
tests/test_torch_rapid_fallback.py holds the fallback plane. Tolerance:
none (exact).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scalecube_cluster_tpu.sim import FaultPlan as JPlan
from scalecube_cluster_tpu.sim import Knobs as JKnobs
from scalecube_cluster_tpu.sim import ScheduleBuilder as JBuilder
from scalecube_cluster_tpu.sim import rapid as JR
from scalecube_cluster_tpu.sim.ensemble import stack_universes as j_stack
from scalecube_cluster_tpu.sim.topology import LinkWorld as JWorld
from scalecube_cluster_tpu.testlib import invariants as JI
from scalecube_cluster_tpu.testlib.chaos import chaos_params, rapid_chaos_params, sample_schedule
from scalecube_cluster_tpu_torch import prng
from scalecube_cluster_tpu_torch.sim import ensemble as TE
from scalecube_cluster_tpu_torch.sim import faults as TF
from scalecube_cluster_tpu_torch.sim import rapid as TR
from scalecube_cluster_tpu_torch.sim.convert import rapid_state_from_numpy, rapid_state_to_numpy
from scalecube_cluster_tpu_torch.sim.knobs import Knobs as TKnobs
from scalecube_cluster_tpu_torch.sim.params import SimParams as TSimParams
from scalecube_cluster_tpu_torch.sim.schedule import FaultSchedule as TSched
from scalecube_cluster_tpu_torch.sim.topology import LinkWorld as TWorld
from scalecube_cluster_tpu_torch.testing import one_cpu_thread, shared_result
from scalecube_cluster_tpu_torch.testlib import invariants as TI

one_cpu_thread()

N = 16
SCHED_ONLY = {"plan_dirty", "kills_fired", "restarts_fired", "joins_fired"}


# ------------------------------------------------------------ conversions
def tparams(rp) -> TR.RapidParams:
    return TR.RapidParams(**dataclasses.asdict(rp))


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def port_world(jw):
    if jw is None:
        return None
    return TWorld(**{f.name: _t(getattr(jw, f.name)) for f in dataclasses.fields(TWorld)})


def port_schedule(js) -> TSched:
    """The port's schedule of a reference one (single or stacked), field by
    field, its zone world included."""
    fields = {}
    for f in dataclasses.fields(TSched):
        v = getattr(js, f.name)
        fields[f.name] = port_world(v) if f.name == "link_world" else (
            None if v is None else _t(v))
    return TSched(**fields)


def port_plan(jp) -> TF.FaultPlan:
    return TF.FaultPlan(block=_t(jp.block), loss=_t(jp.loss), mean_delay=_t(jp.mean_delay),
                        link_world=port_world(jp.link_world))


def port_input(jp):
    return port_schedule(jp) if hasattr(jp, "starts") else port_plan(jp)


def port_knobs(mult, cap):
    return TKnobs(suspicion_mult=torch.tensor(mult, dtype=torch.float32),
                  fanout_cap=torch.tensor(cap, dtype=torch.int32))


def ref_knobs(mult, cap):
    return JKnobs(suspicion_mult=jnp.asarray(mult, jnp.float32),
                  fanout_cap=jnp.asarray(cap, jnp.int32))


def ref_leaves(state) -> dict:
    """A reference Rapid state as flat numpy arrays (``fb.*``, ``trace.*``)."""
    out = {}
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if v is None:
            continue
        if dataclasses.is_dataclass(v):
            for g in dataclasses.fields(v):
                out[f"{f.name}.{g.name}"] = np.asarray(getattr(v, g.name))
        else:
            out[f.name] = np.asarray(v)
    return out


def port_leaves(state) -> dict:
    flat = rapid_state_to_numpy(state)
    for sub in ("fb", "trace"):
        for k, v in flat.pop(sub, {}).items():
            flat[f"{sub}.{k}"] = v
    return flat


def ref_state_numpy(state) -> dict:
    """A reference state as the dict ``rapid_state_from_numpy`` takes."""
    leaves = ref_leaves(state)
    d = {k: v for k, v in leaves.items() if "." not in k}
    for sub in ("fb", "trace"):
        part = {k.split(".", 1)[1]: v for k, v in leaves.items() if k.startswith(sub + ".")}
        if part:
            d[sub] = part
    return d


def host(traces) -> dict:
    return {k: (v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
            for k, v in traces.items()}


def assert_same_state(jd: dict, ts, where=""):
    td = port_leaves(ts)
    assert set(jd) == set(td), (where, set(jd) ^ set(td))
    for k in jd:
        assert jd[k].dtype == td[k].dtype, (where, k, jd[k].dtype, td[k].dtype)
        assert np.array_equal(jd[k], td[k]), (where, k)


def assert_same_traces(jt: dict, tt: dict, where=""):
    tt = host(tt)
    assert set(jt) == set(tt), (where, set(jt) ^ set(tt))
    for k in jt:
        a, b = np.asarray(jt[k]), tt[k]
        assert a.dtype == b.dtype and a.shape == b.shape, (where, k, a.dtype, b.dtype, a.shape)
        assert np.array_equal(a.view(np.uint8), b.view(np.uint8)), (where, k)


def ref_run(key, rp, plan_fn, ticks, seed=0, knobs=None, **init):
    """The reference's run (computed once per test run across workers):
    ``(leaves, traces)`` as numpy."""
    def compute():
        st = JR.init_rapid_full_view(rp, seed=seed, **init)
        st, tr = JR.run_rapid_ticks(rp, st, plan_fn(rp.n), ticks,
                                    knobs=None if knobs is None else ref_knobs(*knobs))
        return ref_leaves(st), {k: np.asarray(v) for k, v in jax.device_get(tr).items()}

    return shared_result(f"test_torch_rapid.{key}", compute)


def port_run(rp, plan_fn, ticks, seed=0, knobs=None, **init):
    st = TR.init_rapid_full_view(tparams(rp), seed=seed, device="cpu", **init)
    return TR.run_rapid_ticks(tparams(rp), st, port_input(plan_fn(rp.n)), ticks,
                              knobs=None if knobs is None else port_knobs(*knobs))


def check_pair(key, rp, plan_fn, ticks, seed=0, knobs=None, **init):
    """Run both packages and hold every leaf and trace equal; returns the
    reference traces and the port's final state and traces."""
    jleaves, jtr = ref_run(key, rp, plan_fn, ticks, seed=seed, knobs=knobs, **init)
    tst, ttr = port_run(rp, plan_fn, ticks, seed=seed, knobs=knobs, **init)
    assert_same_state(jleaves, tst, key)
    assert_same_traces(jtr, ttr, key)
    return jtr, tst, host(ttr)


def clean_schedule(n, extra=None):
    b = JBuilder(n).add_segment(0, JPlan.clean(n))
    if extra:
        extra(b)
    return b.build()


def flap_schedule(n):
    """tests/test_rapid.py::_flap_schedule: links across a minority cut
    down 4 of every 8 ticks between ticks 10 and 50, no kills."""
    m = max(1, n // 4)
    cross = np.zeros((n, n), bool)
    cross[:m, m:] = True
    cross[m:, :m] = True
    clean = JPlan.clean(n)
    return (JBuilder(n).add_segment(0, clean)
            .add_segment(10, clean, flap_mask=cross, flap_period=8, flap_on=4)
            .add_segment(50, clean).build())


# ----------------------------------------------------------- static parts
@pytest.mark.parametrize("kw", [
    {"k": 0}, {"k": 16}, {"high_watermark": 0}, {"high_watermark": 9}, {"low_watermark": 0},
    {"quorum_num": 0}, {"quorum_num": 5}, {"quorum_num": 1, "quorum_den": 2},
    {"fd_period_ticks": 0}, {"sync_period_ticks": 0}, {"fallback_delay_ticks": 0},
])
def test_params_errors_match_reference(kw):
    with pytest.raises(ValueError) as je:
        JR.RapidParams(n=16, **kw)
    with pytest.raises(ValueError) as te:
        TR.RapidParams(n=16, **kw)
    assert str(je.value) == str(te.value)


def test_static_helpers_match_reference():
    for n, k in ((8, 3), (16, 8), (33, 5)):
        assert np.array_equal(np.asarray(JR.observer_matrix(n, k)),
                              TR.observer_matrix(n, k, "cpu").numpy())
        assert np.array_equal(JR._digest_weights(n), TR._digest_weights(n))
    rng = np.random.default_rng(3)
    for n in (1, 7, 32, 100):
        masks = rng.random((4, n, n)) < 0.6
        masks[0] = True
        want = np.asarray(JR.view_digest(jnp.asarray(masks)))
        assert np.array_equal(want, TR.view_digest(torch.from_numpy(masks)).numpy()), n
    vals = np.concatenate([rng.integers(0, 2**31 - 1, 2000), [0, 1, 2**31 - 1, 12345]])
    want = np.asarray(JR._mix32(jnp.asarray(vals, jnp.int32))).astype(np.int64)
    assert np.array_equal(want, TR._mix32(torch.from_numpy(vals).to(torch.int32)).numpy())
    rp = rapid_chaos_params(N)
    assert TR.rapid_low_watermark(tparams(rp), None) == JR.rapid_low_watermark(rp, None)
    for mult in (0.1, 0.125, 0.375, 0.5, 0.625, 1.0, 1.125, 1.5, 2.5, 3.0, 1e4):
        want = int(np.asarray(JR.rapid_low_watermark(rp, ref_knobs(mult, 8))))
        assert int(TR.rapid_low_watermark(tparams(rp), port_knobs(mult, 8))) == want, mult


def test_digest_is_membership_sensitive():
    """tests/test_rapid.py's digest check, on the port: every single-member
    flip of the full view changes the digest."""
    n = 32
    base = TR.view_digest(torch.ones((n, n), dtype=torch.bool))[0]
    for j in range(n):
        flipped = torch.ones((n, n), dtype=torch.bool)
        flipped[:, j] = False
        assert TR.view_digest(flipped)[0] != base


@pytest.mark.parametrize("init", [
    {}, {"seed": 5, "trace_capacity": 64}, {"fallback": True}, {"n_live": 10, "fallback": True},
], ids=["plain", "traced", "fallback", "elastic"])
def test_init_matches_reference(init):
    rp = rapid_chaos_params(N)
    jst = JR.init_rapid_full_view(rp, **init)
    tst = TR.init_rapid_full_view(tparams(rp), device="cpu", **init)
    assert_same_state(ref_leaves(jst), tst, str(init))
    back = rapid_state_from_numpy(ref_state_numpy(jst), device="cpu")
    assert_same_state(ref_leaves(jst), back, "round trip")
    for bad in (0, N + 1):
        with pytest.raises(ValueError) as je:
            JR.init_rapid_full_view(rp, n_live=bad)
        with pytest.raises(ValueError) as te:
            TR.init_rapid_full_view(tparams(rp), n_live=bad, device="cpu")
        assert str(je.value) == str(te.value)


@pytest.mark.parametrize("joins", [False, True])
def test_apply_events_matches_reference(joins):
    """Scripted events alone on a traced fallback state, from a converted
    mid-run reference state (votes locked, certificates, edge counters)."""
    rp = rapid_chaos_params(N)
    st = JR.init_rapid_full_view(rp, seed=3, trace_capacity=256, fallback=True)
    st, _ = JR.run_rapid_ticks(rp, st, sample_schedule(2, N), 23)
    rng = np.random.default_rng(int(joins))
    kill, restart, join = (rng.random((3, N)) < 0.25)
    jm = jnp.asarray(join) if joins else None
    want = JR.apply_events_rapid(rp, st, jnp.asarray(kill), jnp.asarray(restart), jm)
    tst = rapid_state_from_numpy(ref_state_numpy(st), device="cpu")
    got = TR.apply_events_rapid(tparams(rp), tst, torch.from_numpy(kill),
                                torch.from_numpy(restart),
                                torch.from_numpy(join) if joins else None)
    assert_same_state(ref_leaves(want), got)
    none = torch.zeros((N,), dtype=torch.bool)
    same = TR.apply_events_rapid(tparams(rp), got, none, none, none if joins else None)
    assert same is got


# --------------------------------------------------- the two [N, N, *] helpers
def _literal_cnt(recv, rm, add, members):
    """The reference's definition: ``recv @ same`` with ``same[m2, m]`` the
    pairwise equality of whole vote rows (an [N, N, N] comparison)."""
    same = np.all(rm[:, :, None, :] == rm[:, None, :, :], axis=-1) & np.all(
        add[:, :, None, :] == add[:, None, :, :], axis=-1)
    if members is not None:
        same = same & members[:, :, None]
    return np.einsum("brm,bmn->brn", recv.astype(np.int64), same.astype(np.int64))


@pytest.mark.parametrize("case", ["all-equal", "all-distinct", "not-proposing", "empty", "mixed"])
def test_vote_groups_match_literal_definition(case):
    rng = np.random.default_rng(len(case))
    b, n = 2, 24
    if case == "all-equal":
        row = rng.random(n) < 0.3
        rm, add = np.broadcast_to(row, (b, n, n)).copy(), np.zeros((b, n, n), bool)
    elif case == "all-distinct":
        rm, add = np.zeros((b, n, n), bool), np.zeros((b, n, n), bool)
        rm[:, np.arange(n), np.arange(n)] = True  # row m removes m alone
    elif case == "empty":
        rm, add = np.zeros((b, n, n), bool), np.zeros((b, n, n), bool)
    else:
        pool = rng.random((4, 2, n)) < 0.2
        pick = rng.integers(0, 4, (b, n))
        rm, add = pool[pick, 0], pool[pick, 1]
    members = rng.random((b, n)) < 0.6 if case in ("not-proposing", "mixed") else None
    recv = rng.random((b, n, n)) < 0.7
    gid, g = TR.vote_groups(torch.from_numpy(rm), torch.from_numpy(add))
    gid = gid.numpy()
    for u in range(b):
        for m in range(n):
            eq = np.all(rm[u] == rm[u, m], axis=1) & np.all(add[u] == add[u, m], axis=1)
            assert np.array_equal(gid[u] == gid[u, m], eq), (u, m)
    assert g == max(len(np.unique(np.concatenate([rm[u], add[u]], 1), axis=0)) for u in range(b))
    got = TR.count_same(torch.from_numpy(recv), torch.from_numpy(gid), g,
                        None if members is None else torch.from_numpy(members))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), _literal_cnt(recv, rm, add, members))


# ------------------------------------------------------ draws where sent
def _plans(kind, n):
    rng = np.random.default_rng(9)
    if kind == "block-matrix":
        block = rng.random((n, n)) < 0.2
        loss = rng.uniform(0, 0.4, (n, n)).astype(np.float32)
        return TF.FaultPlan(block=torch.from_numpy(block), loss=torch.from_numpy(loss),
                            mean_delay=torch.zeros((n, n)))
    world = TWorld.even_zones(n, 3, device="cpu").replace(
        loss=torch.from_numpy(rng.uniform(0, 0.3, (3, 3)).astype(np.float32)))
    world = world.block_zones(2, 0)
    return TF.FaultPlan.uniform(3.0, device="cpu").with_link_world(world)


@pytest.mark.parametrize("pattern", ["every", "none", "ragged"])
@pytest.mark.parametrize("kind", ["block-matrix", "zone-world"])
@pytest.mark.parametrize("shape", ["NxN", "NxNxk"])
def test_link_pass_where_matches_full_draw(pattern, kind, shape):
    n, k = 20, 8
    plan = _plans(kind, n)
    col = torch.arange(n, dtype=torch.int32)
    if shape == "NxN":
        src, dst = col[None, :], col[:, None]
    else:
        obs = TR.observer_matrix(n, k, "cpu")
        src, dst = obs[None, :, :], col[:, None, None]
    full_shape = torch.broadcast_shapes(src.shape, dst.shape)
    rng = np.random.default_rng(len(pattern))
    send = {"every": np.ones(full_shape, bool), "none": np.zeros(full_shape, bool),
            "ragged": rng.random(full_shape) < 0.3}[pattern]
    send = torch.from_numpy(send)
    key = prng.PRNGKey(17)
    want = TF.link_pass(key, plan, src, dst) & send
    got, n_sent = TF.link_pass_where(key, plan, src, dst, send)
    assert n_sent == int(send.sum())
    assert torch.equal(got, want)
    # Stacked: B universes, each with its key, plan and send pattern.
    if kind == "block-matrix":
        b = 3
        plans = TE.stack_universes(_plans(kind, n).with_loss(5.0 * u) for u in range(b))
        keys = prng.KeyTable(np.stack([prng.PRNGKey(17 + u) for u in range(b)])).root
        sends = torch.from_numpy(rng.random((b,) + tuple(full_shape)) < 0.3)
        got, n_sent = TF.link_pass_where(keys, plans, src[None], dst[None], sends)
        for u in range(b):
            one = TE.index_universe(plans, u)
            want = TF.link_pass(prng.PRNGKey(17 + u), one, src, dst) & sends[u]
            assert torch.equal(got[u], want), u


def test_draws_at_counters_match_full_draw():
    key = prng.PRNGKey(4)
    counters = torch.tensor([0, 1, 7, 99, 4095, 12345], dtype=torch.int64)
    full = prng.uniform(key, (12346,), "cpu")
    assert torch.equal(prng.uniform_at(key, counters), full[counters])
    keys = prng.KeyTable(np.stack([prng.PRNGKey(s) for s in (4, 5, 6)])).root
    fullb = prng.uniform(keys, (12346,), "cpu")
    uni = torch.tensor([0, 2, 1, 1, 0, 2])
    assert torch.equal(prng.uniform_at(keys, counters, uni), fullb[uni, counters])
    with pytest.raises(ValueError):
        TF.link_pass_where(key, TF.FaultPlan.uniform(1.0, device="cpu"),
                           torch.zeros((1,), dtype=torch.int32),
                           torch.zeros((1,), dtype=torch.int32),
                           torch.zeros((1,), dtype=torch.bool).expand(1 << 16, 1 << 16))


# -------------------------------------------------------------- scenarios
def test_clean_run_certifies_with_zero_view_changes():
    rp = rapid_chaos_params(N)
    jtr, _, ttr = check_pair("clean60", rp, clean_schedule, 60)
    summary = TI.certify_rapid_traces(tparams(rp), ttr)
    assert summary == JI.certify_rapid_traces(rp, jtr)
    assert summary["view_changes"] == 0 and summary["alarms_raised"] == 0
    assert float(ttr["convergence"][-1]) == 1.0
    # The SWIM accounting plane (C1-C6) holds on Rapid traces too.
    TI.certify_traces(TSimParams(**dataclasses.asdict(chaos_params(N))), ttr)


def test_zero_event_schedule_matches_fixed_plan():
    rp = rapid_chaos_params(N)
    _, _, fixed = check_pair("fixed40", rp, JPlan.clean, 40)
    _, _, sched = check_pair("zero40", rp, clean_schedule, 40)
    for k in set(fixed) - SCHED_ONLY:
        assert np.array_equal(fixed[k], sched[k]), k


def test_kill_restart_view_cycle():
    rp = rapid_chaos_params(N)

    def plan(n):
        return clean_schedule(n, lambda b: b.kill(10, 3).restart(40, 3))

    jtr, tst, ttr = check_pair("killrestart100", rp, plan, 100)
    summary = TI.certify_rapid_traces(tparams(rp), ttr)
    assert summary == JI.certify_rapid_traces(rp, jtr)
    assert summary["max_view_id"] >= 2 and summary["cut_detected"] > 0
    assert np.all(ttr["view_id"][-1] == ttr["view_id"][-1][0])
    assert bool(tst.alive[3]) and int(tst.epoch[3]) == 1


def test_same_tick_kill_restart_bounce():
    rp = rapid_chaos_params(N)

    def plan(n):
        return clean_schedule(n, lambda b: b.kill(9, 5).restart(9, 5))

    _, tst, ttr = check_pair("bounce60", rp, plan, 60)
    TI.certify_rapid_traces(tparams(rp), ttr)
    assert bool(tst.alive[5]) and int(tst.epoch[5]) == 1


def test_flap_only_rapid_silent():
    rp = rapid_chaos_params(N)
    _, _, ttr = check_pair("flap70", rp, flap_schedule, 70)
    summary = TI.certify_rapid_traces(tparams(rp), ttr)
    assert summary["view_changes"] == 0 and summary["alarms_raised"] == 0


@pytest.mark.parametrize("knobs", [(1.0, 8), (3.0, 8), (1.0, 5), (1.5, 7)],
                         ids=["identity", "suspicion_mult-3", "fanout_cap-below-H", "mixed"])
def test_knobs_match_reference(knobs):
    rp = rapid_chaos_params(N)

    def plan(n):
        return clean_schedule(n, lambda b: b.kill(10, 3))

    _, _, ttr = check_pair(f"knobs{knobs}", rp, plan, 80, knobs=knobs)
    if knobs == (1.0, 8):
        _, _, base = check_pair("knobs-none", rp, plan, 80)
        for k in ttr:
            assert np.array_equal(ttr[k], base[k]), k
    if knobs == (1.0, 5):
        assert int(ttr["cut_detected"].sum()) == 0 and int(ttr["view_changes"].sum()) == 0


@pytest.mark.parametrize("n,seed", [(N, 0), (N, 3), (N, 7), (40, 7), (48, 3)])
def test_chaos_schedules_match_reference(n, seed):
    rp = rapid_chaos_params(n)
    check_pair(f"chaos{n}-{seed}", rp, lambda m: sample_schedule(seed, m), 100, seed=seed)


def test_ensemble_matches_reference_and_solo():
    """The ensemble twin against the reference's vmapped one (3 sampled
    schedules), universe 0 against the port's solo run, and the batched
    certifier's verdicts against the reference's."""
    rp = rapid_chaos_params(N)
    seeds, ticks = (0, 1, 2), 60

    def compute():
        states = JR.init_ensemble_rapid(rp, [0] * len(seeds))
        plans = j_stack([sample_schedule(s, N) for s in seeds])
        st, tr = JR.run_ensemble_rapid_ticks(rp, states, plans, ticks)
        return ref_leaves(st), {k: np.asarray(v) for k, v in jax.device_get(tr).items()}

    jleaves, jtr = shared_result("test_torch_rapid.ensemble", compute)
    states = TR.init_ensemble_rapid(tparams(rp), [0] * len(seeds), device="cpu")
    plans = TE.stack_universes(port_schedule(sample_schedule(s, N)) for s in seeds)
    tst, ttr = TR.run_ensemble_rapid_ticks(tparams(rp), states, plans, ticks)
    assert_same_state(jleaves, tst, "ensemble")
    assert_same_traces(jtr, ttr, "ensemble")
    _, solo = TR.run_rapid_ticks(tparams(rp), TR.init_rapid_full_view(tparams(rp), device="cpu"),
                                 port_schedule(sample_schedule(seeds[0], N)), ticks)
    for k in set(solo) - SCHED_ONLY:
        assert torch.equal(solo[k], ttr[k][0]), k
    want = JI.certify_rapid_population(rp, jtr)
    got = TI.certify_rapid_population(tparams(rp), host(ttr))
    assert np.array_equal(got["ok"], want["ok"]) and got["summaries"] == want["summaries"]
    assert bool(np.all(got["ok"]))


def test_unported_ensemble_states_raise():
    rp = tparams(rapid_chaos_params(N))
    plans = TE.stack_universes([TF.FaultPlan.uniform(device="cpu")] * 2)
    for kw, what in (({"trace_capacity": 8}, "flight-recorder"), ({"n_live": 8}, "elastic")):
        st = TE.stack_universes([TR.init_rapid_full_view(rp, device="cpu", **kw)] * 2)
        with pytest.raises(NotImplementedError, match=what):
            TR.run_ensemble_rapid_ticks(rp, st, plans, 1)


# ------------------------------------------------ certifier negatives
def _doctored(n=8, ticks=40):
    return {
        "view_id": np.zeros((ticks, n), np.int32),
        "view_digest": np.full((ticks, n), 123, np.int32),
        "view_size": np.full((ticks, n), n, np.int32),
        "alive_mask": np.ones((ticks, n), bool),
        "view_changes": np.zeros(ticks, np.int32),
        "alarms_raised": np.zeros(ticks, np.int32),
        "cut_detected": np.zeros(ticks, np.int32),
        "pings": np.zeros(ticks, np.int32),
        "acks": np.zeros(ticks, np.int32),
    }


def _tamper(tr, which):
    n = tr["view_digest"].shape[1]
    if which == "R1":
        tr["view_digest"][20, 3] = 456
    elif which == "R2":
        tr["view_id"][10, 4] = 1
    elif which == "R3":
        tr["view_digest"][15, n // 2:] = 456
        tr["view_size"][15, :] = n // 2
    else:
        tr["view_changes"][5] = 1


@pytest.mark.parametrize("which,expected", [
    ("R1", "R1-agreement"), ("R2", "R2-monotone"), ("R3", "R3-split-brain"),
    ("R4", "R4-stability"),
])
def test_certifier_catches_tampered_traces(which, expected):
    """tests/test_rapid.py's four tampers: the port's copy raises the same
    invariant with the same message as the reference."""
    rp = rapid_chaos_params(8)
    tr = _doctored()
    assert TI.certify_rapid_traces(tparams(rp), tr) == JI.certify_rapid_traces(rp, tr)
    _tamper(tr, which)
    with pytest.raises(JI.InvariantViolation) as je:
        JI.certify_rapid_traces(rp, tr)
    with pytest.raises(TI.InvariantViolation) as te:
        TI.certify_rapid_traces(tparams(rp), tr)
    assert te.value.invariant == je.value.invariant == expected
    assert str(te.value) == str(je.value)
    assert TI.RAPID_REQUIRED_KEYS == JI.RAPID_REQUIRED_KEYS


# ----------------------------------- zone loss on Rapid's shapes (Queue C)
def _once_twice(p, q):
    a, b = np.float32(1) - p, np.float32(1) - q
    once = (-(a.astype(np.float64)) * np.float64(b) + 1.0).astype(np.float32)
    return once, (np.float32(1) - a * b).astype(np.float32)


def _knife_edge_loss(u):
    """A zone loss q and a link loss p whose composition ``1 - (1-p)(1-q)``
    rounds differently once (a fused multiply-add) and twice, with ``u``
    equal to the smaller value: the link passes under one rounding and
    drops under the other."""
    for q in np.linspace(0.05, 0.6, 400).astype(np.float32):
        target = 1 - (1 - float(u)) / (1 - float(q))
        if not 0 < target < 1:
            continue
        bits = np.arange(-4000, 4000) + int(np.array(np.float32(target)).view(np.int32))
        ps = bits.astype(np.int32).view(np.float32)
        once, twice = _once_twice(ps, q)
        hit = np.flatnonzero((once != twice) & (np.minimum(once, twice) == u))
        if hit.size:
            return q, ps[hit[0]]
    raise AssertionError(f"no knife edge for u={u}")


def _knife_edge_case(shape):
    """``(tick, pair, u, init, events)``: the tick whose draw decides the
    chosen cell, the directed member pair the cell's message rides, the
    cell's uniform (from the reference's own keys), and the scenario."""
    n, k = N, 8
    obs = np.asarray(JR.observer_matrix(n, k))
    count = 16 if shape == "handshake" else 6
    key = jax.random.PRNGKey(0)

    def keys_at(t):  # the reference's split chain up to tick t
        rng = key
        for _ in range(t - 1):
            rng = jax.random.split(rng, count)[0]
        return jax.random.split(rng, count)

    if shape in ("probe", "ack"):
        s, j = 5, 2
        ks = keys_at(2)
        u = np.asarray(jax.random.uniform(ks[1 if shape == "probe" else 2], (n, k)))[s, j]
        pair = (int(obs[s, j]), s) if shape == "probe" else (s, int(obs[s, j]))
        return 2, pair, u, {}, None
    if shape == "handshake":
        m = 6
        u = np.asarray(jax.random.uniform(keys_at(1)[11], (n,)))[m]
        return 1, (m, m + 1), u, {"fallback": True}, ("join", 1, m)
    if shape == "sync-broadcast":
        r, c = 3, 11
        u = np.asarray(jax.random.uniform(keys_at(5)[5], (n, n)))[r, c]
        return 5, (c, r), u, {}, None
    v, j, r = 9, 3, 2  # victim 9 killed at tick 1; its edges alarm at tick 8
    u = np.asarray(jax.random.uniform(keys_at(8)[3], (n, n, k)))[r, v, j]
    return 8, (int(obs[v, j]), r), u, {}, ("kill", 1, v)


@pytest.mark.parametrize("shape", ["probe", "ack", "handshake", "sync-broadcast", "alarm"])
def test_zone_loss_on_rapid_shapes_matches_in_tick(shape):
    """Rapid's own edge shapes under a lossy zone world at k = 8 ([N, k]
    probe and ack legs, [N] handshake legs, the [N, N] broadcasts and the
    [N, N, k] alarm broadcast), inside the reference's compiled tick: the
    link loss of one pair is set so that the cell's draw lands exactly on
    the smaller of the one- and two-rounding compositions, so that cell
    passes under one rounding and drops under the other, and both engines
    must agree on every leaf and metric."""
    tick, (src, dst), u, init, event = _knife_edge_case(shape)
    q, p = _knife_edge_loss(u)
    once, twice = _once_twice(p, q)
    assert once != twice and min(once, twice) == u
    zone = (np.arange(N) >= N // 2).astype(np.int32)
    zl = np.zeros((2, 2), np.float32)
    zl[zone[src], zone[dst]] = q
    loss = np.zeros((N, N), np.float32)
    loss[src, dst] = p

    def plan(n):
        world = JWorld.from_zones(jnp.asarray(zone), n_zones=2).replace(loss=jnp.asarray(zl))
        b = JBuilder(n).add_segment(0, JPlan.clean(n).replace(loss=jnp.asarray(loss)),
                                    link_world=world)
        if event is not None:
            getattr(b, event[0])(event[1], event[2])
        return b.build()

    rp = rapid_chaos_params(N)
    _, _, ttr = check_pair(f"knife-{shape}", rp, plan, tick, **init)
    sent = {"probe": "pings", "ack": "acks", "handshake": "join_requests",
            "sync-broadcast": "msgs_sync", "alarm": "msgs_gossip"}[shape]
    assert int(ttr[sent][tick - 1]) > 0, "the chosen cell's message was not sent"


def test_convergence_sum_at_n24_matches_reference():
    """``convergence`` at n=24 under a chaos schedule, where XLA:CPU's loop
    vectorizer reorders the reference's live-viewer sum inside the fused
    Rapid tick (sim/tick.py::xla_cpu_fused_sum_f32)."""
    rp = rapid_chaos_params(24)
    jleaves, jtr = ref_run("conv24", rp, lambda n: sample_schedule(7, n), 40, seed=7)
    _, ttr = port_run(rp, lambda n: sample_schedule(7, n), 40, seed=7)
    assert np.array_equal(jtr["convergence"].view(np.uint8),
                          ttr["convergence"].numpy().view(np.uint8))


@pytest.mark.parametrize("n", [12, 16, 20, 24, 33, 40, 48, 64])
def test_convergence_sum_order_across_sizes(n):
    """Every leaf and trace, ``convergence`` included, over three chaos
    schedules at sizes on every side of the vectorizer's thresholds: in
    order below 16 terms, one 8-lane accumulator with a tree of lanes and
    an in-order tail from 16 to 32, windows of 32 above."""
    rp = rapid_chaos_params(n)
    for seed in (0, 3, 7):
        check_pair(f"chaos{n}-{seed}", rp, lambda m: sample_schedule(seed, m), 100, seed=seed)
