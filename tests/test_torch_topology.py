"""The port's geo worlds, plan builders and composed edge lookups against the
JAX package, on the CPU.

Every LinkWorld and FaultPlan builder, the composed ``edge_*`` lookups, the
Erlang tail of the FD deadline draw (``p_miss`` as float32 bits, over the
means and deadlines the engines produce) and the per-zone gauges are fed the
same seeded numpy inputs on both sides and must be equal: arrays bit for
bit, errors with the reference's messages. Tolerance: none.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from scalecube_cluster_tpu.sim import faults as JF
from scalecube_cluster_tpu.sim import topology as JT
from scalecube_cluster_tpu_torch.sim import faults as TF
from scalecube_cluster_tpu_torch.sim import topology as TT
from scalecube_cluster_tpu_torch.testing import one_cpu_thread

one_cpu_thread()


def same(a, b, what=""):
    a, b = np.asarray(a), b.cpu().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype, b.dtype, a.shape, b.shape)
    if a.dtype == np.float32:
        assert np.array_equal(a.view(np.int32), b.view(np.int32)), what
    else:
        assert np.array_equal(a, b), what


def same_world(jw, tw, what=""):
    for f in ("zone", "latency", "loss", "block", "bw_class"):
        same(getattr(jw, f), getattr(tw, f), f"{what}.{f}")


def world_pair(n, z, build):
    """The same builder chain on both packages' worlds."""
    return build(JT.LinkWorld.even_zones(n, z), JT), build(
        TT.LinkWorld.even_zones(n, z, device="cpu"), TT
    )


WORLDS = {
    "brownout": lambda w, m: w.with_zone_latency(0, 1, 400.0).with_zone_loss(0, 1, 0.05),
    "oneway": lambda w, m: w.block_zones(0, [1, 2]).with_zone_latency([1, 2], 0, 60.0),
    "classes": lambda w, m: w.with_zone_class(0, 1, m.BW_WAN).with_zone_class(
        1, 2, m.BW_METRO, symmetric=False),
    "symmetric_block": lambda w, m: w.block_zones(1, 2, symmetric=True),
    "flat": lambda w, m: w,
}


@pytest.mark.parametrize("name", sorted(WORLDS))
def test_world_builders_match_jax(name):
    jw, tw = world_pair(40, 3, WORLDS[name])
    same_world(jw, tw, name)
    same(jw.any_faults(), tw.any_faults(), "any_faults")
    assert jw.n_zones == tw.n_zones == 3
    for z in range(3):
        assert np.array_equal(jw.zone_members(z), tw.zone_members(z))


def test_world_constructors_and_errors_match_jax():
    same_world(JT.LinkWorld.flat(10, 2), TT.LinkWorld.flat(10, 2, device="cpu"), "flat")
    zone = np.array([2, 0, 1, 1, 0], np.int32)
    same_world(JT.LinkWorld.from_zones(zone), TT.LinkWorld.from_zones(zone, device="cpu"))
    for bad, kw in (([0, 3], {"n_zones": 2}), ([-1, 0], {})):
        with pytest.raises(ValueError) as je:
            JT.LinkWorld.from_zones(bad, **kw)
        with pytest.raises(ValueError) as te:
            TT.LinkWorld.from_zones(bad, device="cpu", **kw)
        assert str(je.value) == str(te.value)
    for mod, w in ((JT, JT.LinkWorld.flat(4, 2)), (TT, TT.LinkWorld.flat(4, 2, device="cpu"))):
        with pytest.raises(ValueError, match="unknown bandwidth class 7"):
            w.with_zone_class(0, 1, 7)


def test_stack_and_segment_match_jax():
    n = 24
    jw, tw = world_pair(n, 2, WORLDS["brownout"])
    js = JT.stack_segment_worlds([None, jw, None], n)
    ts = TT.stack_segment_worlds([None, tw, None], n)
    same_world(js, ts, "stack")
    for k in range(3):
        same_world(JT.world_segment(js, k), TT.world_segment(ts, k), f"segment {k}")
    assert JT.stack_segment_worlds([None], n) is None and TT.stack_segment_worlds([None], n) is None
    assert TT.world_segment(None, 0) is None
    other = TT.LinkWorld.even_zones(n, 3, device="cpu")
    for mod, worlds in (
        (JT, [jw, JT.LinkWorld.even_zones(n, 3)]), (TT, [tw, other]),
    ):
        with pytest.raises(ValueError, match="same zone assignment"):
            mod.stack_segment_worlds(worlds, n)
        with pytest.raises(ValueError, match=r"link_world.zone must be \[25\]"):
            mod.stack_segment_worlds(worlds[:1], n + 1)


def plan_pair(n, build, world=None):
    """The same builder chain on both packages' plans over ``n`` members."""
    jp, tp = build(JF.FaultPlan, n), build(TF.FaultPlan, n, "cpu")
    if world is not None:
        jw, tw = world_pair(n, 3, WORLDS[world])
        jp, tp = jp.with_link_world(jw), tp.with_link_world(tw)
    return jp, tp


PLANS = {
    "uniform": lambda P, n, *d: P.uniform(7.0, 30.0, *d),
    "dense": lambda P, n, *d: P.clean(n, *d).with_loss(3.0).with_mean_delay(12.5)
    .block_outbound(2, 5).block_outbound(np.array([1, 3]), np.array([4, 0])),
    "partition": lambda P, n, *d: P.clean(n, *d).partition(range(10), range(10, n)),
    "oneway": lambda P, n, *d: P.clean(n, *d).with_loss(5.0).partition_oneway([1, 2, 3], [7, 8]),
}


@pytest.mark.parametrize("world", [None, "brownout", "oneway", "classes"])
@pytest.mark.parametrize("name", sorted(PLANS))
def test_plans_and_edge_lookups_match_jax(name, world):
    """Every builder, then ``edge_blocked`` / ``edge_loss`` /
    ``edge_mean_delay`` / ``plan_any_faults`` over seeded edges, with and
    without a world (loss composes in one rounding whenever a world is
    attached, zone loss 0 included)."""
    n = 40
    jp, tp = plan_pair(n, PLANS[name], world)
    for f in ("block", "loss", "mean_delay"):
        same(getattr(jp, f), getattr(tp, f), f)
    # The engines' edge sets: [N] (probe, ack, gossip, SYNC) and
    # [N, relays] (the ping-req legs, 2 relays in the tests, 3 in presets).
    rng = np.random.default_rng(3)
    col = np.arange(n, dtype=np.int32)
    for src, dst in ((col, rng.integers(0, n, n)), (col[:, None], rng.integers(0, n, (n, 2))),
                     (rng.integers(0, n, (n, 3)), col[:, None])):
        src, dst = np.asarray(src, np.int32), np.asarray(dst, np.int32)
        for fn in ("edge_blocked", "edge_loss", "edge_mean_delay"):
            want = jax.jit(getattr(JF, fn))(jp, jnp.asarray(src), jnp.asarray(dst))
            same(want, getattr(TF, fn)(tp, torch.from_numpy(src), torch.from_numpy(dst)), fn)
    same(JF.plan_any_faults(jp), TF.plan_any_faults(tp), "plan_any_faults")
    assert TF.plan_delay_free(tp) == (not bool(np.any(
        np.asarray(jp.mean_delay) != 0) or (world and np.any(np.asarray(
            jp.link_world.latency) != 0))))


def test_plan_builder_errors_match_jax():
    for build in (lambda P, *d: P.uniform(5.0, 0.0, *d).block_outbound(0, 1),
                  lambda P, *d: P.uniform(5.0, 0.0, *d).partition([0], [1]),
                  lambda P, *d: P.uniform(5.0, 0.0, *d).partition_oneway([0], [1])):
        with pytest.raises(ValueError) as je:
            build(JF.FaultPlan)
        with pytest.raises(ValueError) as te:
            build(TF.FaultPlan, "cpu")
        assert str(je.value) == str(te.value)


_VECTOR_LOOP = (
    "XLA:CPU emits a vector loop for this fusion that rounds 1 - (1-p)(1-q) "
    "twice on its body and once in its scalar tail; which fusions get one, "
    "and its width, follow the host's vector unit and XLA's loop emitter, "
    "which the port does not see (ROADMAP Queue C)"
)
_LEG_TAIL = (
    "on x86-64 with AVX-512, where this map was made, XLA:CPU's vector loop "
    "for a dense plan's [N, 2] legs covers 16 cells an iteration and its "
    "scalar tail rounds 1 - (1-p)(1-q) once on the cells past the last whole "
    "iteration; the port rounds every [N, 2] cell twice, as the loop body "
    "does, since that width follows the host's vector unit (ROADMAP Queue C)"
)

#: Edge shape classes of ``edge_loss`` with a world: (plan, outer, inner,
#: layout of src/dst). The engines' sets ([N]; the relay legs [N, 3], and
#: a dense plan's two-relay legs [N, 2] at n % 8 == 0) round as the
#: reference does; the legs' scalar tail at n % 8 != 0 and the wider inner
#: dimensions, which no engine produces, are held as strict xfails.
EDGE_CLASSES = {
    "flat-uniform": ("uniform", 40, None, "flat"),
    "flat-dense": ("dense", 120, None, "flat"),
    "relays3-uniform": ("uniform", 40, 3, "row"),
    "relays3-dense": ("dense", 30, 3, "col"),
    "legs2-uniform": ("uniform", 40, 2, "row"),
    "legs2-dense": ("dense", 40, 2, "row"),
    "legs2-dense-tail-30": ("dense", 30, 2, "row"),
    "legs2-dense-tail-33": ("dense", 33, 2, "col"),
    "legs2-dense-tail-100": ("dense", 100, 2, "both"),
    "inner5-uniform": ("uniform", 40, 5, "row"),
    "inner4-uniform": ("uniform", 40, 4, "row"),
    "inner6-uniform": ("uniform", 40, 6, "col"),
    "inner8-uniform": ("uniform", 40, 8, "row"),
    "inner4-uniform-tail": ("uniform", 30, 4, "bcast"),
    "inner4-dense": ("dense", 40, 4, "row"),
    "inner8-dense": ("dense", 40, 8, "col"),
}
_XFAIL_EDGE = {
    **dict.fromkeys(("legs2-dense-tail-30", "legs2-dense-tail-33", "legs2-dense-tail-100"),
                    _LEG_TAIL),
    **dict.fromkeys(("inner4-uniform", "inner6-uniform", "inner8-uniform",
                     "inner4-uniform-tail", "inner4-dense", "inner8-dense"), _VECTOR_LOOP),
}


def _edge_class_case(name):
    kind, outer, inner, layout = EDGE_CLASSES[name]
    rng = np.random.default_rng(11)
    n = 40
    loss = rng.uniform(0.0, 0.3, (n, n)).astype(np.float32)
    zone_loss = rng.uniform(0.0, 0.3, (3, 3)).astype(np.float32)
    plans = []
    for F, T_, d in ((JF, JT, {}), (TF, TT, {"device": "cpu"})):
        if kind == "uniform":
            plan = F.FaultPlan.uniform(3.0, **d)
        else:
            plan = F.FaultPlan.clean(n, **d).with_loss(3.0)
            arr = jnp.asarray(loss) if F is JF else torch.from_numpy(loss)
            plan = plan.replace(loss=arr)
        world = T_.LinkWorld.even_zones(n, 3, **d)
        zl = jnp.asarray(zone_loss) if F is JF else torch.from_numpy(zone_loss)
        plans.append(plan.with_link_world(world.replace(loss=zl)))
    shapes = {
        "flat": ((outer,), (outer,)),
        "row": ((outer, 1), (outer, inner)),
        "col": ((outer, inner), (outer, 1)),
        "both": ((outer, inner), (outer, inner)),
        "bcast": ((outer, inner), (1, inner)),
    }[layout]
    src = rng.integers(0, n, shapes[0]).astype(np.int32)
    dst = rng.integers(0, n, shapes[1]).astype(np.int32)
    return plans, src, dst


@pytest.mark.parametrize("name", [
    pytest.param(k, marks=pytest.mark.xfail(strict=True, reason=_XFAIL_EDGE[k]))
    if k in _XFAIL_EDGE else k
    for k in EDGE_CLASSES
])
def test_edge_loss_rounding_by_shape(name):
    """``edge_loss`` with a world, per edge shape class, against the
    reference under ``jax.jit``; each case holds cells where one and two
    roundings of the composition differ."""
    (jp, tp), src, dst = _edge_class_case(name)
    want = np.asarray(jax.jit(JF.edge_loss)(jp, jnp.asarray(src), jnp.asarray(dst)))
    p = np.asarray(JF._edge_lookup(jp.loss, jnp.asarray(src), jnp.asarray(dst)))
    z = np.asarray(jp.link_world.zone)
    q = np.asarray(jp.link_world.loss)[z[src], z[dst]]
    a, b = np.float32(1) - p, np.float32(1) - q
    once = (-(a.astype(np.float64)) * b.astype(np.float64) + 1.0).astype(np.float32)
    assert np.any(once != np.float32(1) - a * b), "no cell tells the roundings apart"
    same(want, TF.edge_loss(tp, torch.from_numpy(src), torch.from_numpy(dst)), name)


def test_xla_exp_matches_xla_cpu():
    """``xla_exp_f32`` against ``jnp.exp`` on XLA:CPU over the float32
    range, the underflow edge (flushed) and the FD tail's arguments."""
    rng = np.random.default_rng(0)
    x = np.concatenate([
        rng.uniform(-90.0, 89.0, 200_000), rng.uniform(-3.0, 0.0, 100_000),
        rng.uniform(-88.0, -86.5, 20_000), [0.0, -0.0, 88.8, -87.8, 100.0, -100.0],
    ]).astype(np.float32)
    same(jax.jit(jnp.exp)(x), TF.xla_exp_f32(torch.from_numpy(x)), "exp")


@pytest.mark.parametrize("world", [False, True], ids=["flat", "world"])
@pytest.mark.parametrize("k,deadline", [(2, 200.0), (2, 100.0), (4, 1000.0), (4, 333.0)])
def test_erlang_tail_bits_match_jax(k, deadline, world):
    """``round_trip_in_time_from``'s miss probability as float32 bits:
    20,000 paths of k legs over 64 members whose link means span 0-800 ms
    (LAN deadlines; with a world, a 400 ms cross-zone latency on top). u is
    set to each path's reference ``p_miss`` and to its float32 neighbour
    below (where that is a normal float32, as every engine draw is), so
    the outcomes agree only where the bits do."""
    n, m = 64, 20_000
    rng = np.random.default_rng(k)
    delay = (rng.uniform(0, 800, (n, n)) * (rng.uniform(size=(n, n)) < 0.8)).astype(np.float32)
    jplan = JF.FaultPlan.clean(n).replace(mean_delay=jnp.asarray(delay))
    tplan = TF.FaultPlan.clean(n, device="cpu").replace(
        mean_delay=torch.from_numpy(delay), delay_free=None)
    if world:
        jw, tw = world_pair(n, 2, WORLDS["brownout"])
        jplan, tplan = jplan.with_link_world(jw), tplan.with_link_world(tw)
    hops = rng.integers(0, n, (k + 1, m)).astype(np.int32)
    legs = [(hops[i], hops[i + 1]) for i in range(k)]
    jlegs = [(jnp.asarray(a), jnp.asarray(b)) for a, b in legs]
    tlegs = [(torch.from_numpy(a), torch.from_numpy(b)) for a, b in legs]
    run = jax.jit(lambda u, p: JF.round_trip_in_time_from(u, p, jlegs, deadline))
    p_ref = np.asarray(jax.jit(lambda p: _p_miss(JF, p, jlegs, deadline))(jplan))
    assert np.count_nonzero(p_ref) > m // 2 and np.unique(p_ref).size > m // 4
    below = np.nextafter(p_ref, np.float32(-1)).astype(np.float32)
    # Engine draws are never subnormal (XLA:CPU reads those as 0).
    below = np.where(below >= np.finfo(np.float32).tiny, below, p_ref)
    for u in (p_ref, below, rng.uniform(size=m).astype(np.float32)):
        same(run(u, jplan), TF.round_trip_in_time_from(torch.from_numpy(u), tplan, tlegs,
                                                       deadline))


def _p_miss(F, plan, legs, deadline):
    """The reference's ``p_miss`` (the body of round_trip_in_time_from)."""
    k = len(legs)
    theta = sum(F.edge_mean_delay(plan, s, d) for s, d in legs) / k
    has = theta > 0
    x = deadline / jnp.where(has, theta, 1.0)
    term = acc = jnp.ones_like(x)
    for i in range(1, k):
        term = term * x / i
        acc = acc + term
    return jnp.where(has, jnp.exp(-x) * acc, 0.0)


def _zone_inputs(n, z, seed):
    rng = np.random.default_rng(seed)
    keys = rng.integers(-1, 1 << 30, (n, n)).astype(np.int32)
    # Mostly correct-ALIVE records at epoch 0, so the sums are large.
    view = np.where(rng.uniform(size=(n, n)) < 0.9, 0, keys).astype(np.int32)
    alive = rng.uniform(size=n) < 0.97
    epoch = (rng.uniform(size=n) < 0.02).astype(np.int32)
    zone = np.sort(rng.integers(0, z, n)).astype(np.int32)
    return view, alive, epoch, zone


@pytest.mark.parametrize("n,z", [(10240, 2), (300, 3), (64, 5)])
def test_zone_tick_metrics_match_jax(n, z):
    """The per-zone gauges; at n=10240 with two zones a zone's pair count
    passes 2**24, where the float32 fold's order decides the value."""
    view, alive, epoch, zone = _zone_inputs(n, z, n)
    jw = JT.LinkWorld.from_zones(zone, n_zones=z)
    tw = TT.LinkWorld.from_zones(zone, n_zones=z, device="cpu")
    want = jax.jit(JT.zone_tick_metrics)(jw, jnp.asarray(view), jnp.asarray(alive),
                                         jnp.asarray(epoch))
    got = TT.zone_tick_metrics(tw, torch.from_numpy(view), torch.from_numpy(alive),
                               torch.from_numpy(epoch))
    assert set(want) == set(got)
    for key in want:
        same(want[key], got[key], key)
    if n == 10240:
        pairs = np.bincount(zone[alive], minlength=z).astype(np.int64)
        assert (pairs * (pairs - 1)).max() > 1 << 24


@pytest.mark.parametrize("n", [30, 33])
def test_dense_tick_zone_world_leg_tail_matches_jax(n):
    """The dense engine's tick at n % 8 != 0 (the unstructured fan-out) with
    a 3-zone world over a dense loss plan, where its FD relay legs are
    ``[N, 2]`` edge sets with a scalar tail in XLA:CPU's vector loop: three
    12-tick chunks against the reference's tick under ``jax.jit``, every
    state leaf and every metric (float32 as bits) equal after each."""
    import dataclasses

    from scalecube_cluster_tpu.sim import run as JR
    from scalecube_cluster_tpu.sim import state as JS
    from scalecube_cluster_tpu_torch.sim import run as TR
    from scalecube_cluster_tpu_torch.sim import state as TS
    from scalecube_cluster_tpu_torch.sim.convert import dense_state_to_numpy
    from scalecube_cluster_tpu_torch.sim.params import SimParams
    from tests.test_sim import small_params

    jp = small_params(n, suspicion_ticks=12)
    assert jp.ping_req_members == 2
    tp = SimParams(**dataclasses.asdict(jp))
    rng = np.random.default_rng(n)
    loss = rng.uniform(0.0, 0.3, (n, n)).astype(np.float32)
    zone_loss = rng.uniform(0.0, 0.3, (3, 3)).astype(np.float32)
    jplan = JF.FaultPlan.clean(n).replace(loss=jnp.asarray(loss)).with_link_world(
        JT.LinkWorld.even_zones(n, 3).replace(loss=jnp.asarray(zone_loss)))
    tplan = TF.FaultPlan.clean(n, device="cpu").replace(loss=torch.from_numpy(loss)).with_link_world(
        TT.LinkWorld.even_zones(n, 3, device="cpu").replace(loss=torch.from_numpy(zone_loss)))
    js = JS.kill(JS.init_full_view(n, user_gossip_slots=2, seed=5), 3)
    ts = TS.kill(TS.init_full_view(n, user_gossip_slots=2, seed=5, device="cpu"), 3)
    for c in range(3):
        js, jtr = JR.run_chunked(jp, js, jplan, JS.seeds_mask(n, [0]), 12, chunk=12)
        ts, ttr = TR.run_chunked(tp, ts, tplan, TS.seeds_mask(n, [0], device="cpu"), 12,
                                 chunk=12)
        got = dense_state_to_numpy(ts)
        for f in dataclasses.fields(js):
            same(getattr(js, f.name), torch.from_numpy(np.asarray(got[f.name])), (c, f.name))
        assert set(jtr) == set(ttr)
        for k in jtr:
            same(jtr[k], torch.from_numpy(np.asarray(ttr[k])), (c, k))
    assert int(np.asarray(jtr["fault_lost"]).sum()) > 0
