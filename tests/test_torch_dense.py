"""The port's dense engine against the JAX package, whole trajectories.

Both engines start from the same seed (or the same mid-run state, carried
across by ``sim/convert.py``) and run the same chunks on the CPU: the JAX
side with its fused Pallas tick core in interpret mode when
``pallas_delivery`` is set, the port with the plain version of its kernel.
After EVERY chunk every state leaf (``rng`` included) and every collected
metric (key set and values, float32 as bit patterns) must be bit-equal.
Tolerance: none.

The scenarios: the kill trajectory at n=128 and n=256 with
``pallas_delivery`` on and off, in both collect modes; a cold join from
``init_seeded`` (the joining slow path); leave, update_metadata, restart
and inject_gossip between chunks; tracked user gossip and tracked gossip
under the delay model; a mid-run start; a run that ends inside a chunk;
``run_until``; and the unstructured fan-out of an n that is not a multiple
of 8.
"""

import dataclasses

import numpy as np
import pytest
import torch

from scalecube_cluster_tpu.sim import run as J
from scalecube_cluster_tpu.sim import state as JS
from scalecube_cluster_tpu.sim.faults import FaultPlan as JPlan
from scalecube_cluster_tpu_torch.ops import tick_core as tc
from scalecube_cluster_tpu_torch.sim import run as T
from scalecube_cluster_tpu_torch.sim import state as TS
from scalecube_cluster_tpu_torch.sim.convert import (
    dense_state_from_numpy,
    dense_state_to_numpy,
)
from scalecube_cluster_tpu_torch.sim.faults import FaultPlan as TPlan
from scalecube_cluster_tpu_torch.sim.params import SimParams as TSimParams
from scalecube_cluster_tpu_torch.sim.tick import sim_tick
from tests.test_sim import small_params
from scalecube_cluster_tpu_torch.testing import one_cpu_thread, shared_result

one_cpu_thread()

CHUNK = 12


def jax_state_dict(state):
    return {f.name: np.asarray(getattr(state, f.name)) for f in dataclasses.fields(state)}


def assert_same_state(jd, ts, where):
    b = dense_state_to_numpy(ts)
    assert set(jd) == set(b), (where, set(jd) ^ set(b))
    for k in jd:
        assert jd[k].dtype == b[k].dtype, (where, k, jd[k].dtype, b[k].dtype)
        assert np.array_equal(jd[k], b[k]), (where, k)
    assert ts.t_host == int(jd["tick"]), where


def assert_same_traces(jtr, ttr, where):
    assert set(jtr) == set(ttr), (where, set(jtr) ^ set(ttr))
    for k in jtr:
        a, b = np.asarray(jtr[k]), np.asarray(ttr[k])
        assert a.dtype == b.dtype and a.shape == b.shape, (where, k, a.dtype, b.dtype)
        if a.dtype == np.float32:
            assert np.array_equal(a.view(np.int32), b.view(np.int32)), (where, k)
        else:
            assert np.array_equal(a, b), (where, k)


def params(n, pallas=True, **kw):
    """The JAX and port params of one scenario (fast cadences: FD every 2
    ticks, SYNC every 10, suspicion 12, so verdicts land inside a test)."""
    jp = dataclasses.replace(small_params(n, suspicion_ticks=12, **kw), pallas_delivery=pallas)
    return jp, TSimParams(**dataclasses.asdict(jp))


def plans(loss=10.0, delay=0.0):
    return JPlan.uniform(loss, delay), TPlan.uniform(loss, delay, device="cpu")


#: Host ops applied between chunks, on both engines alike.
CHURN = (
    lambda s, m: m.leave(s, 9),
    lambda s, m: m.update_metadata(s, 11),
    lambda s, m: m.restart(s, 3),
    lambda s, m: m.inject_gossip(m.kill(s, 9), 20, 1),
)

_JAX_RUNS = {}


def jax_run(name, jp, make_state, seeds, chunks, collect=True, between=()):
    """A JAX trajectory in ``CHUNK``-tick chunks, cached per module: the
    initial state dict and (state dict, traces) after each chunk, with
    ``between[c]`` applied after chunk c."""
    if name not in _JAX_RUNS:
        def compute():
            js = make_state(JS)
            snaps = [(jax_state_dict(js), None)]
            jplan = JPlan.uniform(10.0)
            jseeds = JS.seeds_mask(jp.n, seeds)
            for c in range(chunks):
                js, jtr = J.run_chunked(jp, js, jplan, jseeds, CHUNK, chunk=CHUNK,
                                        collect=collect)
                snaps.append((jax_state_dict(js), {k: np.asarray(v) for k, v in jtr.items()}))
                if c < len(between):
                    js = between[c](js, JS)
            return snaps

        _JAX_RUNS[name] = shared_result(f"test_torch_dense.jax_run.{name!r}", compute)
    return _JAX_RUNS[name]


def follow(tp, ts, snaps, seeds, collect=True, between=()):
    """Run the port chunk by chunk beside a cached JAX trajectory."""
    tplan = TPlan.uniform(10.0, device="cpu")
    tseeds = TS.seeds_mask(tp.n, seeds, device="cpu")
    assert_same_state(snaps[0][0], ts, "start")
    for c, (jd, jtr) in enumerate(snaps[1:]):
        ts, ttr = T.run_chunked(tp, ts, tplan, tseeds, CHUNK, chunk=CHUNK, collect=collect)
        assert_same_state(jd, ts, f"chunk {c}")
        if collect:
            assert_same_traces(jtr, ttr, f"chunk {c}")
        if c < len(between):
            ts = between[c](ts, TS)
    return ts


def killed(n):
    return lambda m: m.kill(
        m.init_full_view(n, user_gossip_slots=2, seed=11, **({"device": "cpu"} if m is TS else {})),
        3,
    )


@pytest.mark.parametrize("pallas", [True, False], ids=["fused", "xla"])
@pytest.mark.parametrize("n", [128, 256])
def test_kill_trajectory_matches_jax(n, pallas):
    """init_full_view + kill(3), 10% loss, 36 ticks: FD rounds, SYNC ticks
    10/20/30, suspicions and DEAD verdicts; the fused core on the port
    counts no launch on the CPU."""
    jp, tp = params(n, pallas)
    snaps = jax_run(("kill", n, pallas), jp, killed(n), [0, 1], 3)
    before = tc.tick_core.launches
    follow(tp, killed(n)(TS), snaps, [0, 1])
    assert tc.tick_core.launches == before
    traces = [tr for _, tr in snaps[1:]]
    assert sum(int(tr["verdicts_dead"].sum()) for tr in traces) > 0
    assert sum(int(tr["msgs_sync"].sum()) for tr in traces) > 0


def test_collect_false_matches_jax():
    """collect=False on both sides: the same states, traces of the tick
    counter only."""
    n = 256
    jp, tp = params(n, True)
    snaps = jax_run(("kill-nocollect", n), jp, killed(n), [0, 1], 3, collect=False)
    tplan = TPlan.uniform(10.0, device="cpu")
    ts = killed(n)(TS)
    for c, (jd, jtr) in enumerate(snaps[1:]):
        ts, ttr = T.run_chunked(tp, ts, tplan, TS.seeds_mask(n, [0, 1], device="cpu"),
                                CHUNK, chunk=CHUNK, collect=False)
        assert_same_state(jd, ts, f"chunk {c}")
        assert_same_traces(jtr, ttr, f"chunk {c}")
    # The JAX state does not depend on collect.
    collected = jax_run(("kill", n, True), jp, killed(n), [0, 1], 3)
    assert_same_state(collected[-1][0], ts, "collect=True state")


def test_cold_join_matches_jax():
    """init_seeded: every node knows only itself and joins through seed 0;
    the joining slow path runs until every table fills."""
    n = 128
    jp, tp = params(n, True)

    def seeded(m):
        return m.init_seeded(n, [0], user_gossip_slots=2, seed=5,
                             **({"device": "cpu"} if m is TS else {}))

    snaps = jax_run(("seeded", n), jp, seeded, [0], 3)
    follow(tp, seeded(TS), snaps, [0])
    assert int(snaps[-1][0]["known_cnt"].min()) > 0


def test_host_ops_between_chunks_match_jax():
    """leave, update_metadata, restart (a rejoin through the slow path),
    kill and inject_gossip between chunks."""
    n = 128
    jp, tp = params(n, True)
    snaps = jax_run(("churn", n), jp, killed(n), [0, 1], 5, between=CHURN)
    follow(tp, killed(n)(TS), snaps, [0, 1], between=CHURN)
    assert sum(int(tr["gossip_infections"].sum()) for _, tr in snaps[1:]) > 0


@pytest.mark.parametrize("delay", [False, True], ids=["tracked", "tracked-delay"])
def test_tracked_user_gossip_matches_jax(delay):
    """Exact [N, N, G] infected sets, and under the delay model the
    in-flight ledger, with gossip injected at two nodes."""
    n = 128
    jp, tp = params(n, False, track_user_infected=True, gossip_delay_model=delay)

    def state(m):
        dev = {"device": "cpu"} if m is TS else {}
        s = m.init_full_view(n, user_gossip_slots=2, seed=2, track_infected=True,
                             delay_model=delay, **dev)
        return m.inject_gossip(m.inject_gossip(m.kill(s, 3), 0, 0), 40, 1)

    jplan, tplan = plans(10.0, 150.0 if delay else 0.0)
    js, ts = state(JS), state(TS)
    jseeds, tseeds = JS.seeds_mask(n, [0]), TS.seeds_mask(n, [0], device="cpu")
    sent = 0
    for c in range(3):
        js, jtr = J.run_ticks(jp, js, jplan, jseeds, CHUNK)
        ts, ttr = T.run_ticks(tp, ts, tplan, tseeds, CHUNK)
        assert_same_state(jax_state_dict(js), ts, f"chunk {c}")
        assert_same_traces(jtr, {k: v.numpy() for k, v in ttr.items()}, f"chunk {c}")
        sent += int(np.asarray(jtr["msgs_user"]).sum())
        if c == 0:
            assert int(np.asarray(js.uinf).sum()) > 0
            assert not delay or int(np.asarray(js.uflight).sum()) > 0
    assert sent > 0


def test_mid_run_start_matches_jax():
    """A JAX state taken at tick 12 (countdowns armed, a non-trivial key)
    carried into the port by sim/convert.py continues bit-identically."""
    n = 256
    jp, tp = params(n, True)
    snaps = jax_run(("kill", n, True), jp, killed(n), [0, 1], 3)
    ts = dense_state_from_numpy(snaps[1][0], device="cpu")
    assert ts.t_host == CHUNK
    follow(tp, ts, snaps[1:], [0, 1])


def test_partial_chunk_and_run_until_match_jax():
    """run_chunked over 30 ticks in 12-tick chunks (traces trimmed to 30,
    the state at tick 36) and run_until a convergence predicate."""
    n = 128
    jp, tp = params(n, True)
    jplan, tplan = plans()
    jseeds, tseeds = JS.seeds_mask(n, [0, 1]), TS.seeds_mask(n, [0, 1], device="cpu")
    js, jtr = J.run_chunked(jp, killed(n)(JS), jplan, jseeds, 30, chunk=CHUNK)
    ts, ttr = T.run_chunked(tp, killed(n)(TS), tplan, tseeds, 30, chunk=CHUNK)
    assert ts.t_host == 36 and len(ttr["tick"]) == 30
    assert_same_state(jax_state_dict(js), ts, "run_chunked")
    assert_same_traces(jtr, ttr, "run_chunked")

    def converged(m):
        return float(m["convergence"]) == 1.0 and int(m["n_suspected"]) == 0

    js, jticks, jok = J.run_until(jp, js, jplan, jseeds, converged, 96, chunk=CHUNK)
    ts, tticks, tok = T.run_until(tp, ts, tplan, tseeds, converged, 96, chunk=CHUNK)
    assert (jticks, jok) == (tticks, tok)
    assert_same_state(jax_state_dict(js), ts, "run_until")


def _window_sum(terms):
    """A float32 sum in XLA:CPU's tree order, written in numpy: zero-pad to
    windows of 32 terms (half the padding in front, the odd zero at the
    end), sum each window in order, repeat over the window sums until 32
    or fewer are left, sum those in order."""
    a = np.asarray(terms, np.float32)
    while a.size > 32:
        pad = -a.size % 32
        a = np.pad(a, (pad // 2, pad - pad // 2)).reshape(-1, 32)
        acc = np.zeros(a.shape[0], np.float32)
        for i in range(32):
            acc = (acc + a[:, i]).astype(np.float32)
        a = acc
    total = np.float32(0)
    for x in a:
        total = np.float32(total + x)
    return total


@pytest.mark.parametrize("n", [10240, 32768, 33, 100, 1025, 3001])
def test_convergence_sum_matches_xla_at_bench_sizes(n):
    """The dense ``convergence`` metric's float32 sum at the bench's n=10240
    (and n=32768), with no [N, N] state: seeded per-viewer match counts and
    an alive mask give the float32 terms ``viewer_conv * alive``; the
    port's sum (sim/tick.py::xla_cpu_sum_f32) equals the reference's
    ``jnp.sum`` of the same terms on XLA:CPU, eager and under jit, bit for
    bit, for 40 seeds. (The exactly rounded sum the port took before
    differed from XLA's from seed 0 on at both sizes.) The lengths that are
    not a multiple of 32 check the padding: XLA pads each level with half
    the zeros in front and the odd one at the end."""
    import jax
    import jax.numpy as jnp

    from scalecube_cluster_tpu_torch.sim.tick import xla_cpu_sum_f32

    jitted = jax.jit(lambda vc, alive: jnp.sum(vc * alive))
    for seed in range(40):
        rng = np.random.default_rng(seed)
        counts = rng.integers(n // 2, n + 1, n)
        alive = rng.random(n) < 0.95
        viewer_conv = counts.astype(np.float32) / np.float32(n)
        terms = viewer_conv * alive
        want = np.asarray(jnp.sum(jnp.asarray(viewer_conv) * jnp.asarray(alive)))
        assert want.view(np.int32) == np.asarray(
            jitted(jnp.asarray(viewer_conv), jnp.asarray(alive))).view(np.int32)
        got = xla_cpu_sum_f32(torch.from_numpy(terms)).numpy()
        assert got.dtype == want.dtype and got.view(np.int32) == want.view(np.int32), seed
        assert _window_sum(terms).view(np.int32) == want.view(np.int32), seed


@pytest.mark.parametrize("n", [100, 10240, 32768])
def test_viewer_means_match_xla(n):
    """The per-viewer means behind ``convergence``: the port's row means
    (sim/tick.py::xla_row_means_f32) equal the reference's
    ``jnp.mean(match, axis=1)`` under jit bit for bit, on 16 seeded rows of
    n columns (XLA multiplies by the float32 reciprocal of n, which is not
    the quotient when n is not a power of two)."""
    import jax
    import jax.numpy as jnp

    from scalecube_cluster_tpu_torch.sim.tick import xla_row_means_f32

    rng = np.random.default_rng(n)
    match = rng.random((16, n)) < rng.uniform(0.5, 1.0, (16, 1))
    want = np.asarray(jax.jit(lambda m: jnp.mean(m, axis=1))(jnp.asarray(match)))
    got = xla_row_means_f32(torch.from_numpy(match)).numpy()
    assert got.dtype == want.dtype and np.array_equal(got.view(np.int32), want.view(np.int32))


def test_unstructured_fanout_trajectory_matches_jax():
    """n=100 (not a multiple of 8): the unstructured fan-out and the
    unfused core, tick by tick. Every leaf and every metric is bit-equal,
    ``convergence`` too: its 100-term sum is padded as XLA:CPU pads it."""
    n = 100
    jp, tp = params(n, True)
    jplan, tplan = plans()
    js, ts = killed(n)(JS), killed(n)(TS)
    jseeds, tseeds = JS.seeds_mask(n, [0, 1]), TS.seeds_mask(n, [0, 1], device="cpu")
    for t in range(24):
        js, jtr = J.run_ticks(jp, js, jplan, jseeds, 1)
        ts, ttr = T.run_ticks(tp, ts, tplan, tseeds, 1)
        jd = jax_state_dict(js)
        assert_same_state(jd, ts, f"tick {t + 1}")
        assert_same_traces(jtr, {k: v.numpy() for k, v in ttr.items()}, f"tick {t + 1}")


def test_unported_options_raise():
    """Knobs with the fused core raise as the reference's do, a plan that is
    neither a FaultPlan nor a FaultSchedule is refused, and a tracked run
    needs a tracked state."""
    n = 64
    _, tp = params(n, True)
    st = TS.init_full_view(n, device="cpu")
    seeds = TS.seeds_mask(n, [0], device="cpu")
    plan = TPlan.uniform(0.0, device="cpu")
    with pytest.raises(ValueError, match="knobs require the XLA tick core"):
        sim_tick(tp, st, plan, seeds, knobs=object())
    with pytest.raises(TypeError, match="FaultPlan"):
        T.run_ticks(tp, st, object(), seeds, 1)
    tracked = dataclasses.replace(tp, track_user_infected=True)
    with pytest.raises(ValueError, match="track_infected"):
        sim_tick(tracked, st, plan, seeds)
    assert torch.equal(st.view, torch.zeros((n, n), dtype=torch.int32))
