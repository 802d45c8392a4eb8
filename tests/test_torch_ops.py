"""The port's ops and per-tick helpers against the JAX package, on the CPU.

Each test makes its inputs from a numpy seed, runs the JAX function and the
port's counterpart, and requires bit equality of every output (float32
outputs compared as bit patterns). Tolerance: none (exact).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scalecube_cluster_tpu import cluster_math as j_math
from scalecube_cluster_tpu.cluster_api.config import ClusterConfig as JConfig
from scalecube_cluster_tpu.ops import delivery as j_delivery
from scalecube_cluster_tpu.ops import merge as j_merge
from scalecube_cluster_tpu.ops import select as j_select
from scalecube_cluster_tpu.ops.select import probe_cursor_targets as j_probe
from scalecube_cluster_tpu.sim import faults as j_faults
from scalecube_cluster_tpu.sim import state as j_state
from scalecube_cluster_tpu.sim import usergossip as j_ug
from scalecube_cluster_tpu.sim.params import SimParams as JSimParams
from scalecube_cluster_tpu.sim.sparse import SparseParams as JSparseParams
from scalecube_cluster_tpu_torch import cluster_math as t_math
from scalecube_cluster_tpu_torch.cluster_api.config import ClusterConfig as TConfig
from scalecube_cluster_tpu_torch.ops import delivery as t_delivery
from scalecube_cluster_tpu_torch.ops import merge as t_merge
from scalecube_cluster_tpu_torch.ops import select as t_select
from scalecube_cluster_tpu_torch.ops.select import probe_cursor_targets as t_probe
from scalecube_cluster_tpu_torch.sim import faults as t_faults
from scalecube_cluster_tpu_torch.sim import state as t_state
from scalecube_cluster_tpu_torch.sim import usergossip as t_ug
from scalecube_cluster_tpu_torch.sim.convert import dense_state_from_numpy, dense_state_to_numpy
from scalecube_cluster_tpu_torch.sim.params import SimParams as TSimParams
from scalecube_cluster_tpu_torch.sim.sparse import SparseParams as TSparseParams
from scalecube_cluster_tpu_torch.testing import one_cpu_thread

one_cpu_thread()


def _eq(jax_out, torch_out):
    a = np.asarray(jax_out)
    b = torch_out.numpy() if torch.is_tensor(torch_out) else np.asarray(torch_out)
    if a.dtype == np.float32:
        return b.dtype == np.float32 and np.array_equal(a.view(np.int32), b.view(np.int32))
    return a.shape == b.shape and np.array_equal(a, b.astype(a.dtype))


def _keys(rng, shape):
    """Record keys over every status, a few epochs and incarnations, and
    UNKNOWN."""
    status = rng.integers(0, 3, shape)
    inc = rng.integers(0, 4, shape)
    epoch = rng.integers(0, 3, shape)
    key = (epoch << 22) | np.where(status == 2, 1 << 21, 0) | (inc << 1)
    key = key | np.where(status == 1, 1, 0)
    return np.where(rng.random(shape) < 0.25, -1, key).astype(np.int32)


def test_merge_lattice_matches_jax():
    """Key encoding/decoding, the status predicates, overrides_same_epoch
    and merge_views agree cell for cell."""
    rng = np.random.default_rng(0)
    shape = (64, 96)
    local, best_any, best_alive = (_keys(rng, shape) for _ in range(3))
    best_alive = np.where(
        np.asarray(j_merge.is_alive_key(best_alive)), best_alive, -1
    ).astype(np.int32)
    jl, ja, jv = (jnp.asarray(x) for x in (local, best_any, best_alive))
    tl, ta, tv = (torch.from_numpy(x) for x in (local, best_any, best_alive))
    for name in ("decode_status", "decode_incarnation", "decode_epoch",
                 "is_alive_key", "is_suspect_key"):
        assert _eq(getattr(j_merge, name)(jl), getattr(t_merge, name)(tl)), name
    assert _eq(j_merge.overrides_same_epoch(ja, jl), t_merge.overrides_same_epoch(ta, tl))
    jm, jc = j_merge.merge_views(jl, ja, jv)
    tm, tc = t_merge.merge_views(tl, ta, tv)
    assert _eq(jm, tm) and _eq(jc, tc)
    status = rng.integers(0, 4, shape).astype(np.int32)
    inc = rng.integers(-3, 1 << 21, shape).astype(np.int32)
    epoch = rng.integers(-1, 600, shape).astype(np.int32)
    assert _eq(
        j_merge.encode_key(jnp.asarray(status), jnp.asarray(inc), jnp.asarray(epoch)),
        t_merge.encode_key(*(torch.from_numpy(x) for x in (status, inc, epoch))),
    )


@pytest.mark.parametrize("n", [32, 100, 1024, 4096])
def test_probe_cursor_targets_match_jax(n):
    """The shuffled round-robin cursor (fold_in of the fixed raw key, gcd
    stride choice, uint32 affine map) over rounds inside and across wraps."""
    for fd_round in (0, 1, 5, n - 1, n, 3 * n + 2):
        want = j_probe(jnp.asarray(fd_round, jnp.int32), n)
        assert _eq(want, t_probe(fd_round, n, "cpu")), (n, fd_round)


@pytest.mark.parametrize("n,k,group", [(64, 3, 8), (256, 3, 32), (1024, 4, 32), (200, 2, 8)])
def test_structured_fanout_matches_jax(n, k, group):
    """The structured draw, its expansion, the closed-form forward
    permutation and permuted delivery."""
    rng = np.random.default_rng(n + k)
    for seed in range(3):
        key = np.asarray(jnp.asarray([0, seed * 7919 + 1], jnp.uint32))
        jinv, jg, jr = j_delivery.fanout_permutations_structured(jnp.asarray(key), n, k, group=group)
        tinv, tg, tr = t_delivery.fanout_permutations_structured(key, n, k, "cpu", group=group)
        assert _eq(jg, tg) and _eq(jr, tr) and _eq(jinv, tinv)
        assert _eq(
            j_delivery.perm_from_structured(jg, jr, n, group=group),
            t_delivery.perm_from_structured(tg, tr, n, group=group),
        )
        rows = _keys(rng, (n, 24))
        edge = rng.random((k, n)) < 0.8
        assert _eq(
            j_delivery.permuted_delivery(jnp.asarray(rows), jinv, jnp.asarray(edge)),
            t_delivery.permuted_delivery(torch.from_numpy(rows), tinv, torch.from_numpy(edge)),
        )


def _plans(n, rng):
    dense_block = rng.random((n, n)) < 0.1
    dense_loss = rng.random((n, n)).astype(np.float32) * 0.3
    dense_delay = (rng.random((n, n)) * 400).astype(np.float32)
    dense_delay[rng.random((n, n)) < 0.5] = 0.0
    j_plans = [
        j_faults.FaultPlan.uniform(5.0),
        j_faults.FaultPlan.uniform(10.0, 250.0),
        j_faults.FaultPlan(
            block=jnp.asarray(dense_block), loss=jnp.asarray(dense_loss),
            mean_delay=jnp.asarray(dense_delay),
        ),
    ]
    t_plans = [
        t_faults.FaultPlan.uniform(5.0, device="cpu"),
        t_faults.FaultPlan.uniform(10.0, 250.0, device="cpu"),
        t_faults.FaultPlan(
            block=torch.from_numpy(dense_block), loss=torch.from_numpy(dense_loss),
            mean_delay=torch.from_numpy(dense_delay),
        ),
    ]
    return zip(j_plans, t_plans)


def test_link_and_round_trip_draws_match_jax():
    """link_pass_from, edge_blocked and round_trip_in_time_from (2- and
    4-leg Erlang tails) over compact and dense plans, with and without
    delay."""
    n, nrel = 48, 3
    rng = np.random.default_rng(3)
    src = rng.integers(0, n, n).astype(np.int32)
    dst = rng.integers(0, n, n).astype(np.int32)
    rel = rng.integers(0, n, (n, nrel)).astype(np.int32)
    u = rng.random(n).astype(np.float32)
    u2 = rng.random((n, nrel)).astype(np.float32)
    js, jd, jr = (jnp.asarray(x) for x in (src, dst, rel))
    ts, td, tr = (torch.from_numpy(x) for x in (src, dst, rel))
    for jp, tp in _plans(n, rng):
        assert _eq(j_faults.edge_blocked(jp, js, jd), t_faults.edge_blocked(tp, ts, td))
        assert _eq(
            j_faults.link_pass_from(jnp.asarray(u), jp, js, jd),
            t_faults.link_pass_from(torch.from_numpy(u), tp, ts, td),
        )
        assert _eq(
            j_faults.round_trip_in_time_from(jnp.asarray(u), jp, [(js, jd), (jd, js)], 500),
            t_faults.round_trip_in_time_from(torch.from_numpy(u), tp, [(ts, td), (td, ts)], 500),
        )
        jlegs = [(js[:, None], jr), (jr, jd[:, None]), (jd[:, None], jr), (jr, js[:, None])]
        tlegs = [(ts[:, None], tr), (tr, td[:, None]), (td[:, None], tr), (tr, ts[:, None])]
        assert _eq(
            j_faults.round_trip_in_time_from(jnp.asarray(u2), jp, jlegs, 500),
            t_faults.round_trip_in_time_from(torch.from_numpy(u2), tp, tlegs, 500),
        )


@pytest.mark.parametrize("tracked", [False, True], ids=["untracked", "tracked"])
def test_user_gossip_matches_jax(tracked):
    """Several periods of the user-gossip lifecycle (dedup, aging, sweep;
    the last-k-senders ring when tracked) along structured fan-outs."""
    n, g, k, f = 64, 3, 4, 3
    rng = np.random.default_rng(11)
    useen = rng.random((n, g)) < 0.2
    uage = rng.integers(0, 30, (n, g)).astype(np.int32)
    uinf = np.where(rng.random((n, g, k)) < 0.5, rng.integers(0, n, (n, g, k)), -1).astype(np.int32)
    uptr = rng.integers(0, 9, (n, g)).astype(np.int32)
    alive = rng.random(n) < 0.9
    jstate = [jnp.asarray(x) for x in (useen, uage, uinf, uptr)]
    tstate = [torch.from_numpy(x) for x in (useen, uage, uinf, uptr)]
    for step in range(6):
        key = np.array([1, step], np.uint32)
        jinv, jg, jr = j_delivery.fanout_permutations_structured(jnp.asarray(key), n, f, group=32)
        tinv, tg, tr = t_delivery.fanout_permutations_structured(key, n, f, "cpu", group=32)
        edge = rng.random((f, n)) < 0.85
        je, te = jnp.asarray(edge), torch.from_numpy(edge)
        ja, ta = jnp.asarray(alive), torch.from_numpy(alive)
        if tracked:
            jout = j_ug.user_gossip_step_tracked(
                *jstate, jinv, je, ja, 4, 12,
                perm=j_delivery.perm_from_structured(jg, jr, n, group=32),
            )
            tout = t_ug.user_gossip_step_tracked(
                *tstate, tinv, te, ta, 4, 12,
                perm=t_delivery.perm_from_structured(tg, tr, n, group=32),
            )
            jstate, tstate = list(jout[:4]), list(tout[:4])
        else:
            jout = j_ug.user_gossip_step(jstate[0], jstate[1], jinv, je, ja, 4, 12)
            tout = t_ug.user_gossip_step(tstate[0], tstate[1], tinv, te, ta, 4, 12)
            jstate[:2], tstate[:2] = list(jout[:2]), list(tout[:2])
        for a, b in zip(jout, tout):
            assert _eq(a, b), step


@pytest.mark.parametrize("preset", ["default_lan", "default_wan", "default_local"])
def test_sim_params_match_jax(preset):
    """SimParams.from_cluster_config agrees field for field (asdict) across
    the presets and cluster sizes; cluster_math and SparseParams.for_n too."""
    for n in (8, 31, 256, 1000, 32768, 100000):
        jp = JSimParams.from_cluster_config(n, getattr(JConfig, preset)())
        tp = TSimParams.from_cluster_config(n, getattr(TConfig, preset)())
        assert dataclasses.asdict(jp) == dataclasses.asdict(tp), (preset, n)
        assert j_math.suspicion_timeout(5, n, 1000) == t_math.suspicion_timeout(5, n, 1000)
    for kw in ({}, {"slot_budget": 512, "in_scan_writeback": False},
               {"churn_rate": 0.001, "writeback_period": 48}, {"burst": 100}):
        jsp = JSparseParams.for_n(4096, **kw)
        tsp = TSparseParams.for_n(4096, **kw)
        for field in ("slot_budget", "alloc_cap", "writeback_period",
                      "in_scan_writeback", "sync_window"):
            assert getattr(jsp, field) == getattr(tsp, field), (kw, field)
        assert dataclasses.asdict(jsp.base) == dataclasses.asdict(tsp.base)


def _candidate_masks(rng, rows, n):
    """Masks whose rows hold 0, 1, 2, 3 and then many candidates."""
    mask = rng.random((rows, n)) < rng.choice([0.02, 0.3, 0.9], (rows, 1))
    for r, count in enumerate((0, 1, 2, 3)):
        mask[r] = False
        mask[r, rng.choice(n, count, replace=False)] = True
    return mask


def test_topk_tie_order_matches_lax_top_k():
    """The port's ranking breaks ties as ``lax.top_k`` does, on orders with
    heavy ties: equal values lower index first, masked (-inf) cells after
    every candidate, lower index first."""
    rng = np.random.default_rng(21)
    for n, k in ((17, 3), (64, 1), (200, 3), (1000, 4)):
        order = rng.integers(0, 4, (40, n))
        mask = _candidate_masks(rng, 40, n)
        score = jnp.where(jnp.asarray(mask), jnp.asarray(order, jnp.float32), -jnp.inf)
        _, want = jax.lax.top_k(score, k)
        got, valid = t_select.topk_by_order(torch.from_numpy(order), torch.from_numpy(mask), k)
        assert _eq(want, got), (n, k)
        assert _eq(np.take_along_axis(mask, np.asarray(want), axis=1), valid)


@pytest.mark.parametrize("n,k", [(8, 3), (96, 1), (256, 3), (300, 2), (1024, 3)])
def test_masked_random_topk_and_choice_match_jax(n, k):
    """Gumbel top-k and choice: valid flags equal everywhere and the picks
    equal (the valid ones are what the engine reads), on rows with 0, 1, 2,
    3 and many candidates."""
    rng = np.random.default_rng(n * 10 + k)
    for seed in range(3):
        key = np.array([seed, 977 * n + k], np.uint32)
        mask = _candidate_masks(rng, 64, n)
        jidx, jvalid = j_select.masked_random_topk(jnp.asarray(key), jnp.asarray(mask), k)
        tidx, tvalid = t_select.masked_random_topk(key, torch.from_numpy(mask), k)
        assert _eq(jvalid, tvalid)
        assert np.array_equal(np.asarray(jidx)[np.asarray(jvalid)], tidx.numpy()[tvalid.numpy()])
        assert _eq(jidx, tidx)
        jc, jcv = j_select.masked_random_choice(jnp.asarray(key), jnp.asarray(mask))
        tc, tcv = t_select.masked_random_choice(key, torch.from_numpy(mask))
        assert _eq(jcv, tcv) and _eq(jc, tc)


@pytest.mark.parametrize("n,k", [(100, 3), (37, 2), (8, 4)])
def test_unstructured_fanout_matches_jax(n, k):
    """fanout_permutations (the fan-out of n % 8 != 0) and its inverse."""
    for seed in range(3):
        key = np.array([3, seed], np.uint32)
        jperm, jinv = j_delivery.fanout_permutations(jnp.asarray(key), n, k)
        tperm, tinv = t_delivery.fanout_permutations(key, n, k, "cpu")
        assert _eq(jperm, tperm) and _eq(jinv, tinv)


def test_two_channel_delivery_and_deliver_rows_max_match_jax():
    """permuted_delivery_two_channel (alive-key second channel) and the
    segment-max SYNC delivery, with dropped edges and receivers that get
    nothing or several rows."""
    rng = np.random.default_rng(5)
    n, m, f = 96, 40, 3
    rows = _keys(rng, (n, m))
    key = np.array([0, 44], np.uint32)
    jinv, _, _ = j_delivery.fanout_permutations_structured(jnp.asarray(key), n, f)
    tinv, _, _ = t_delivery.fanout_permutations_structured(key, n, f, "cpu")
    edge = rng.random((f, n)) < 0.8
    want = j_delivery.permuted_delivery_two_channel(
        jnp.asarray(rows), j_merge.is_alive_key, jinv, jnp.asarray(edge)
    )
    got = t_delivery.permuted_delivery_two_channel(
        torch.from_numpy(rows), t_merge.is_alive_key, tinv, torch.from_numpy(edge)
    )
    assert _eq(want[0], got[0]) and _eq(want[1], got[1])
    for cols in (1, 2):
        dst = rng.integers(0, n // 3, (n, cols)).astype(np.int32)
        ok = rng.random((n, cols)) < 0.7
        assert _eq(
            j_delivery.deliver_rows_max(jnp.asarray(rows), jnp.asarray(dst), jnp.asarray(ok), n),
            t_delivery.deliver_rows_max(torch.from_numpy(rows), torch.from_numpy(dst),
                                        torch.from_numpy(ok), n),
        )


def test_keyed_fault_draws_match_jax():
    """link_pass, round_trip_in_time (2 and 4 legs) and
    link_delay_within_tick draw their uniforms from a key as jax does, over
    compact and dense plans with and without delay."""
    n, nrel = 48, 3
    rng = np.random.default_rng(8)
    src = rng.integers(0, n, n).astype(np.int32)
    dst = rng.integers(0, n, n).astype(np.int32)
    rel = rng.integers(0, n, (n, nrel)).astype(np.int32)
    js, jd, jr = (jnp.asarray(x) for x in (src, dst, rel))
    ts, td, tr = (torch.from_numpy(x) for x in (src, dst, rel))
    col = np.arange(n, dtype=np.int32)
    jc, tc = jnp.asarray(col), torch.from_numpy(col)
    for i, (jp, tp) in enumerate(_plans(n, rng)):
        key = np.array([i, 77], np.uint32)
        jk = jnp.asarray(key)
        assert _eq(j_faults.link_pass(jk, jp, js, jd), t_faults.link_pass(key, tp, ts, td))
        assert _eq(j_faults.link_pass(jk, jp, js[:, None], jr),
                   t_faults.link_pass(key, tp, ts[:, None], tr))
        assert _eq(
            j_faults.round_trip_in_time(jk, jp, [(js, jd), (jd, js)], 500),
            t_faults.round_trip_in_time(key, tp, [(ts, td), (td, ts)], 500),
        )
        jlegs = [(js[:, None], jr), (jr, jd[:, None]), (jd[:, None], jr), (jr, js[:, None])]
        tlegs = [(ts[:, None], tr), (tr, td[:, None]), (td[:, None], tr), (tr, ts[:, None])]
        assert _eq(j_faults.round_trip_in_time(jk, jp, jlegs, 500),
                   t_faults.round_trip_in_time(key, tp, tlegs, 500))
        assert _eq(j_faults.link_delay_within_tick(jk, jp, js, jd, 200),
                   t_faults.link_delay_within_tick(key, tp, ts, td, 200))
        assert _eq(
            j_faults.link_delay_within_tick(jk, jp, jc[None, :], jc[:, None], 200),
            t_faults.link_delay_within_tick(key, tp, tc[None, :], tc[:, None], 200),
        )


def _jax_dense_dict(state):
    return {f.name: np.asarray(getattr(state, f.name)) for f in dataclasses.fields(state)}


def _same_dense(jstate, tstate, where):
    a, b = _jax_dense_dict(jstate), dense_state_to_numpy(tstate)
    assert set(a) == set(b), where
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), (where, k)


@pytest.mark.parametrize("tracked", [False, True], ids=["untracked", "tracked-delay"])
def test_dense_host_ops_match_jax(tracked):
    """init_full_view, init_seeded and seeds_mask, then every host op of
    sim/state.py (kill, leave, restart, update_metadata before and after a
    leave, inject_gossip) on a mid-run state carried across by
    sim/convert.py: every leaf equal, the input state left as it was."""
    from scalecube_cluster_tpu.sim import run_ticks as j_run_ticks
    from tests.test_sim import small_params

    n = 64
    kw = dict(user_gossip_slots=3, seed=4, track_infected=tracked, delay_model=tracked)
    _same_dense(j_state.init_full_view(n, **kw), t_state.init_full_view(n, device="cpu", **kw),
                "init_full_view")
    _same_dense(j_state.init_seeded(n, [0, 5], **kw),
                t_state.init_seeded(n, [0, 5], device="cpu", **kw), "init_seeded")
    assert _eq(j_state.seeds_mask(n, [0, 5, 9]), t_state.seeds_mask(n, [0, 5, 9], device="cpu"))
    jp = small_params(n, track_user_infected=tracked, gossip_delay_model=tracked)
    js = j_state.inject_gossip(j_state.init_full_view(n, **kw), 2, 1)
    js, _ = j_run_ticks(jp, j_state.kill(js, 3), j_faults.FaultPlan.uniform(10.0, 120.0),
                        j_state.seeds_mask(n, [0]), 8)
    ts = dense_state_from_numpy(_jax_dense_dict(js), device="cpu")
    _same_dense(js, ts, "carried")
    steps = [
        ("kill", lambda s, m: m.kill(s, 7)),
        ("leave", lambda s, m: m.leave(s, 9)),
        ("metadata-after-leave", lambda s, m: m.update_metadata(s, 9)),
        ("metadata", lambda s, m: m.update_metadata(s, 11)),
        ("restart", lambda s, m: m.restart(s, 3)),
        ("restart-again", lambda s, m: m.restart(s, 3)),
        ("inject", lambda s, m: m.inject_gossip(s, 12, 2)),
    ]
    for name, op in steps:
        before = dense_state_to_numpy(ts)
        js, ts_new = op(js, j_state), op(ts, t_state)
        after = dense_state_to_numpy(ts)
        assert all(np.array_equal(before[k], after[k]) for k in before), name
        ts = ts_new
        _same_dense(js, ts, name)
    exhausted = ts.replace(epoch=torch.full_like(ts.epoch, t_merge.EPOCH_MAX))
    with pytest.raises(ValueError, match="restart epochs"):
        t_state.restart(exhausted, 1)
