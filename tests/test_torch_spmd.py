"""The port's explicit-SPMD sparse engine (``scalecube_cluster_tpu_torch/
parallel/``) against the reference's (``scalecube_cluster_tpu.parallel``),
on the CPU.

The reference runs under ``shard_map`` on the 8 virtual CPU devices of
tests/conftest.py (a non-donating jit, fed numpy-built states); the port
runs all ``d`` shards in one process, its kernel route through the plain
shard-mode core, and once as two gloo ranks. Same seeds, plans, schedules
and knobs: every state leaf and every trace key must be equal, bit for bit
(tolerance: none). Also: the bucket routing, the plain shard-mode core
against ``sparse_core_pallas`` in interpret mode, the exchange payload
model, the tampered-capacity overflow, the ensemble twin, the refusals,
and a two-zone world through both sharded engines (ROADMAP Queue C).
"""

import dataclasses
import multiprocessing
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scalecube_cluster_tpu.ops import delivery as JD
from scalecube_cluster_tpu.ops.pallas_sparse import sparse_core_pallas
from scalecube_cluster_tpu.parallel import mesh as JM
from scalecube_cluster_tpu.parallel import spmd as JS
from scalecube_cluster_tpu.sim import FaultPlan as JPlan
from scalecube_cluster_tpu.sim import ScheduleBuilder as JBuilder
from scalecube_cluster_tpu.sim.ensemble import stack_universes as j_stack
from scalecube_cluster_tpu.sim.knobs import make_knobs as j_knobs
from scalecube_cluster_tpu.sim.sparse import init_sparse_full_view as j_init
from scalecube_cluster_tpu.sim.sparse import kill_sparse as j_kill
from scalecube_cluster_tpu.sim.topology import LinkWorld as JWorld
from scalecube_cluster_tpu.testlib.certify import certify_params
from scalecube_cluster_tpu_torch.ops import delivery as TD
from scalecube_cluster_tpu_torch.ops.sparse_core import sparse_core, sparse_core_reference
from scalecube_cluster_tpu_torch.parallel import mesh as TM
from scalecube_cluster_tpu_torch.parallel import spmd as TS
from scalecube_cluster_tpu_torch.sim import sparse as T
from scalecube_cluster_tpu_torch.sim.convert import sparse_state_to_numpy
from scalecube_cluster_tpu_torch.sim.ensemble import stack_universes as t_stack
from scalecube_cluster_tpu_torch.sim.faults import FaultPlan as TPlan
from scalecube_cluster_tpu_torch.sim.knobs import make_knobs as t_knobs
from scalecube_cluster_tpu_torch.testing import (
    CORE_OPERANDS,
    one_cpu_thread,
    shard_core_args,
    shard_operands,
    shared_result,
    stacked_shard_operands,
)
from tests import torch_spmd_ranks as ranks
from tests.test_torch_rapid import port_schedule
from tests.test_torch_sparse import jax_state_dict, port_params

one_cpu_thread()

N, S, TICKS = 256, 128, 30
CORE_OUTS = ("slab2", "age2", "susp2", "self_rumor", "aggr")


# ------------------------------------------------------------- harness
def _jparams(pallas=False, name=None):
    """certify_params at S=128; the zone timeline probes two relays (the
    ``[nl, 2]`` relay legs of Queue C's shapes)."""
    jp = dataclasses.replace(certify_params(N), slot_budget=S, pallas_core=pallas)
    if name == "zone":
        jp = dataclasses.replace(jp, base=dataclasses.replace(jp.base, ping_req_members=2))
    return jp


def _np_state(state):
    """A reference state as numpy leaves (the engine donates a state that a
    jit produced; numpy inputs are race-free, testlib/certify.py)."""
    return jax.tree.map(np.asarray, state)


def _jax_spmd():
    return jax.jit(JS.scan_sparse_ticks_spmd, static_argnums=(0, 1, 2, 5),
                   static_argnames=("collect",))


def _timeline(name, n=N):
    """(reference plan, port plan, kill up front, knob point) of a timeline:
    clean with member 7 killed; scheduled kills, a restart and a lossy,
    delayed middle segment; knobbed (suspicion x1.5, fan-out cap 2)."""
    if name == "scheduled":
        js = (
            JBuilder(n).add_segment(0, JPlan.uniform())
            .add_segment(12, JPlan.uniform(loss_percent=20.0, mean_delay_ms=40.0))
            .add_segment(24, JPlan.uniform())
            .kill(3, 7).kill(5, n // 2 + 3).restart(21, 7).build()
        )
        return js, port_schedule(js), None, None
    if name == "zone":
        world = JWorld.even_zones(n, 2).with_zone_loss(0, 1, 0.25)
        js = (
            JBuilder(n).add_segment(0, JPlan.clean(n).with_loss(3.0), link_world=world)
            .kill(2, 9).kill(4, n - 5).build()
        )
        return js, port_schedule(js), None, None
    knobs = (1.5, 2) if name == "knobbed" else None
    return JPlan.uniform(), TPlan.uniform(device="cpu"), 7, knobs


def _ref_run(route, name, d, ticks=TICKS, bucket_groups=None):
    """The reference trajectory (state leaves, traces), computed once per
    test run."""
    def compute():
        jp = _jparams(route == "kernel", name)
        jplan, _, killed, knobs = _timeline(name)
        st = j_init(N, S, seed=3)
        if killed is not None:
            st = j_kill(st, killed)
        jk = None if knobs is None else j_knobs(jp.base, *knobs)
        mesh = JM.make_mesh(jax.devices()[:d])
        out, tr = _jax_spmd()(jp, JS.ShardConfig(d=d, bucket_groups=bucket_groups), mesh,
                              _np_state(st), jplan, ticks, collect=True, knobs=jk)
        return jax_state_dict(out), {k: np.asarray(v) for k, v in tr.items()}

    return shared_result(f"test_torch_spmd.ref.{route}.{name}.{d}.{ticks}.{bucket_groups}",
                         compute)


def _port_run(route, name, d, ticks=TICKS, bucket_groups=None, mesh=None):
    tp = port_params(_jparams(route == "kernel", name))
    _, tplan, killed, knobs = _timeline(name)
    st = T.init_sparse_full_view(N, S, seed=3, device="cpu")
    if killed is not None:
        st = T.kill_sparse(st, killed)
    tk = None if knobs is None else t_knobs(tp.base, *knobs, device="cpu")
    return TS.run_sparse_ticks_spmd(tp, TS.ShardConfig(d=d, bucket_groups=bucket_groups),
                                    mesh or TM.make_mesh(d), st, tplan, ticks,
                                    collect=True, knobs=tk)


def assert_same(jd: dict, jtr: dict, ts, ttr: dict, where: str):
    b = sparse_state_to_numpy(ts)
    assert set(jd) == set(b), (where, set(jd) ^ set(b))
    for k in jd:
        assert jd[k].dtype == b[k].dtype, (where, k, jd[k].dtype, b[k].dtype)
        assert np.array_equal(jd[k], b[k]), (where, k)
    assert ts.t_host == int(jd["tick"]), where
    assert set(jtr) == set(ttr), (where, set(jtr) ^ set(ttr))
    for k in jtr:
        a, c = jtr[k], ttr[k].numpy()
        assert a.dtype == c.dtype and a.shape == c.shape, (where, k, a.dtype, c.dtype)
        assert np.array_equal(a.view(np.uint8), c.view(np.uint8)), (where, k)


# ------------------------------------------------------------ routing
@pytest.mark.parametrize("d", [1, 2, 4, 8])
def test_shard_group_routing_matches_jax(d):
    rng = np.random.default_rng(d)
    ginv = np.stack([rng.permutation(64) for _ in range(3)]).astype(np.int32)
    jdest, jrank = JD.shard_group_routing(jnp.asarray(ginv), d)
    tdest, trank = TD.shard_group_routing(torch.from_numpy(ginv), d)
    assert tdest.dtype == torch.int32 and trank.dtype == torch.int32
    assert np.array_equal(np.asarray(jdest), tdest.numpy())
    assert np.array_equal(np.asarray(jrank), trank.numpy())
    with pytest.raises(ValueError):
        TD.shard_group_routing(torch.from_numpy(ginv), 3)


# -------------------------------------------------- shard-mode core
CONSTS = dict(spread=48, susp_ticks=400, age_stale=120, sweep=98)


@pytest.mark.parametrize("tile_edges", [False, True])
def test_shard_core_plain_matches_pallas_interpret(tile_edges):
    """The plain shard-mode core (row_base, caller-built windows) against the reference kernel in interpret mode with the same
    mode, on every output, with random window ages and own lanes; the
    wrapper on CPU tensors is the plain core."""
    ops = shard_operands(128, 128 if not tile_edges else 256, seed=3, row_base=512,
                         n_total=2048, tile_edges=tile_edges)
    jout = sparse_core_pallas(
        *(jnp.asarray(ops[k]) for k in CORE_OPERANDS), **CONSTS,
        fold=frozenset({"countdown", "wb_mask", "view_rows"}), interpret=True,
        row_base=jnp.int32(ops["row_base"]), slab_windows=jnp.asarray(ops["slab_windows"]),
        age_windows=jnp.asarray(ops["age_windows"]),
    )
    args, kw = shard_core_args(ops)
    tout = sparse_core_reference(*args, **CONSTS, **kw)
    wout = sparse_core(*args, **CONSTS, **kw)
    for name, a, b, c in zip(CORE_OUTS, jout, tout, wout):
        assert np.array_equal(np.asarray(a), b.numpy()), name
        assert torch.equal(b, c), name
    assert int((tout[3] >= 0).sum()) > 0, "no own lane received a self rumor"


def test_shard_core_batched_equals_per_shard():
    """Four shards stacked in one call (``row_base`` per shard) equal one
    call per shard."""
    ops = stacked_shard_operands(4, 64, 128, seed=5)
    args, kw = shard_core_args(ops)
    got = sparse_core(*args, **CONSTS, **kw)
    for z in range(4):
        one_args, one_kw = shard_core_args({k: v[z] for k, v in ops.items()})
        one = sparse_core(*one_args, **CONSTS, **one_kw)
        for name, a, b in zip(CORE_OUTS, got, one):
            assert torch.equal(a[z], b), (z, name)


def test_shard_core_refusals_match_jax():
    """One window array alone, and windows of the wrong shape (an extra
    leading axis, a narrower lane axis, rows not a multiple of 32) raise in
    both packages. (The reference also refuses its 'points' fold with
    windows; the port has no such option: windows switch the point
    updates off.)"""
    ops = shard_operands(64, 128)
    swin, awin = ops["slab_windows"], ops["age_windows"]
    jargs = tuple(jnp.asarray(ops[k]) for k in CORE_OPERANDS)
    targs = tuple(torch.from_numpy(ops[k]) for k in CORE_OPERANDS)
    fold = frozenset({"countdown"})
    bad = [(swin[None], awin[None]), (swin, None), (swin[:, :64], awin[:, :64]),
           (swin[:100], awin[:100])]
    for sw, aw in bad:
        with pytest.raises(ValueError):
            sparse_core_pallas(*jargs, **CONSTS, fold=fold, interpret=True,
                               row_base=jnp.int32(0), slab_windows=jnp.asarray(sw),
                               age_windows=None if aw is None else jnp.asarray(aw))
        with pytest.raises(ValueError):
            sparse_core(*targs, **CONSTS, row_base=0, slab_windows=torch.from_numpy(sw),
                        age_windows=None if aw is None else torch.from_numpy(aw))


# --------------------------------------------------------- the engine
@pytest.mark.parametrize("name", ["clean", "scheduled", "knobbed"])
@pytest.mark.parametrize("route", ["xla", "kernel"])
def test_spmd_matches_jax(route, name):
    """n=256 over d=4 shards, 30 ticks: every leaf and trace key equal to
    the reference's explicit-SPMD engine, for the XLA core and the kernel
    route (pallas_core=True; the wb_mask carry included)."""
    jd, jtr = _ref_run(route, name, 4)
    out, tr = _port_run(route, name, 4)
    assert_same(jd, jtr, out, tr, f"{route}-{name}")
    assert not tr["exchange_overflow"].any()
    assert int(tr["n_active_slots"].max()) > 0
    if name != "knobbed":
        assert int(tr["verdicts_dead"].sum()) > 0, "no DEAD verdict in the horizon"
    if route == "kernel":
        assert bool(out.wb_valid) == (name != "knobbed")


@pytest.mark.parametrize("name", ["clean", "scheduled", "knobbed"])
def test_spmd_kernel_route_equals_single_device_engine(name):
    """The sharded kernel route at d=2 equals the port's single-device run
    of the same timeline on every leaf and trace key: the kernel route
    there, and, knobbed, the XLA chain (the single-device tick refuses
    knobs with the kernel; the sharded one keeps it)."""
    jp = _jparams(True)
    single_p = port_params(dataclasses.replace(jp, pallas_core=name != "knobbed"))
    _, tplan, killed, knobs = _timeline(name)
    st = T.init_sparse_full_view(N, S, seed=3, device="cpu")
    if killed is not None:
        st = T.kill_sparse(st, killed)
    tk = None if knobs is None else t_knobs(single_p.base, *knobs, device="cpu")
    single, s_tr = T.run_sparse_ticks(single_p, st, tplan, TICKS, knobs=tk)
    out, o_tr = _port_run("kernel", name, 2)
    a, b = sparse_state_to_numpy(single), sparse_state_to_numpy(out)
    assert set(a) == set(b)
    for k in a:
        assert np.array_equal(a[k], b[k]), k
    assert set(s_tr) == set(o_tr)
    for k in s_tr:
        assert torch.equal(s_tr[k], o_tr[k]), k


def test_zone_world_matches_jax():
    """Queue C's zone loss composition under the sharded engines: a
    two-zone world (25% cross-zone loss over a dense 3% plan, two relays a
    probe) with two kills, XLA core, d=4: the shards' [nl] and [nl, 2]
    edge sets compose the loss as the reference's shards do, on every leaf
    and trace key."""
    jd, jtr = _ref_run("xla", "zone", 4)
    out, tr = _port_run("xla", "zone", 4)
    assert_same(jd, jtr, out, tr, "zone")
    assert int(tr["fault_lost"].sum()) > 0


def test_exchange_payload_model_matches_jax():
    for n, d, s, bucket in ((256, 4, 128, None), (1024, 8, 256, None), (512, 2, 128, 3),
                            (32768, 8, 512, None)):
        jp = dataclasses.replace(certify_params(n), slot_budget=s)
        jcfg, tcfg = JS.ShardConfig(d, bucket), TS.ShardConfig(d, bucket)
        assert TS.exchange_payload_bytes_per_tick(port_params(jp), tcfg) == (
            JS.exchange_payload_bytes_per_tick(jp, jcfg))
        assert TS._bucket_cap(port_params(jp), tcfg) == JS._bucket_cap(jp, jcfg)
    assert TS.exchange_rounds_per_tick() == JS.exchange_rounds_per_tick() == 3


def test_exchange_overflow_only_at_tampered_capacity():
    """bucket_groups=1 drops blocks: the overflow counter counts them, and
    the dropped trajectory still equals the reference's; the default
    capacity never drops (test_spmd_matches_jax)."""
    jd, jtr = _ref_run("xla", "clean", 4, bucket_groups=1)
    out, tr = _port_run("xla", "clean", 4, bucket_groups=1)
    assert_same(jd, jtr, out, tr, "bucket_groups=1")
    assert int(tr["exchange_overflow"].sum()) > 0


def test_validate_refusals_match_jax():
    """Every configuration the reference's _validate refuses, the port
    refuses with the same message: the kernel route at n % 32 != 0 and at
    an untileable S, in_scan_writeback=False, n not a multiple of d·group,
    a zero bucket capacity."""
    cases = [
        (dict(n=264), dict(pallas_core=True), 1, None),
        (dict(), dict(pallas_core=True, slot_budget=200), 4, None),
        (dict(), dict(pallas_core=True, slot_budget=4096), 4, None),
        (dict(), dict(in_scan_writeback=False), 4, None),
        (dict(n=96), dict(), 4, None),
        (dict(), dict(), 4, 0),
    ]
    for base_kw, kw, d, bucket in cases:
        jp = dataclasses.replace(certify_params(base_kw.get("n", N)), slot_budget=S)
        jp = dataclasses.replace(jp, **kw)
        with pytest.raises(ValueError) as jerr:
            JS._validate(jp, JS.ShardConfig(d, bucket))
        with pytest.raises(ValueError) as terr:
            TS._validate(port_params(jp), TS.ShardConfig(d, bucket))
        assert str(jerr.value) == str(terr.value)
    jp = _jparams()
    TS._validate(port_params(jp), TS.ShardConfig(4))
    with pytest.raises(ValueError, match="members"):
        TS.run_sparse_ticks_spmd(port_params(jp), TS.ShardConfig(4), TM.make_mesh(2),
                                 T.init_sparse_full_view(N, S, device="cpu"),
                                 TPlan.uniform(device="cpu"), 1)
    elastic = T.init_sparse_full_view(N // 2, S, n_alloc=N, device="cpu")
    with pytest.raises(ValueError, match="elastic"):
        TS.run_sparse_ticks_spmd(port_params(jp), TS.ShardConfig(4), TM.make_mesh(4),
                                 elastic, TPlan.uniform(device="cpu"), 1)


# ------------------------------------------------------ ensemble twin
def test_ensemble_twin_matches_jax():
    """B=2 universes x d=2 shards, different seeds and plans per universe,
    20 ticks, XLA core: every stacked leaf and trace equal to the
    reference's universes x members twin."""
    n, d, b, ticks = N, 2, 2, 20
    seeds = [3, 9]

    def compute():
        jp = _jparams()
        plans = j_stack([JPlan.uniform(), JPlan.uniform(loss_percent=15.0, mean_delay_ms=25.0)])
        states = _np_state(j_stack([j_init(n, S, seed=s) for s in seeds]))
        out, tr = JS.run_ensemble_sparse_ticks_spmd(
            jp, JS.ShardConfig(d), JM.make_universe_member_mesh((b, d)), states, plans, ticks)
        return jax_state_dict(out), {k: np.asarray(v) for k, v in tr.items()}

    jd, jtr = shared_result("test_torch_spmd.ensemble", compute)
    tp = port_params(_jparams())
    plans = t_stack([TPlan.uniform(device="cpu"),
                     TPlan.uniform(15.0, 25.0, device="cpu")])
    states = t_stack([T.init_sparse_full_view(n, S, seed=s, device="cpu") for s in seeds])
    out, tr = TS.run_ensemble_sparse_ticks_spmd(
        tp, TS.ShardConfig(d), TM.make_universe_member_mesh((b, d)), states, plans, ticks)
    b_leaves = sparse_state_to_numpy(out)
    for k in jd:
        assert np.array_equal(jd[k], b_leaves[k]), k
    assert np.array_equal(np.asarray(out.t_host), jd["tick"])
    assert set(jtr) == set(tr)
    for k in jtr:
        assert np.array_equal(jtr[k].view(np.uint8), tr[k].numpy().view(np.uint8)), k


def test_ensemble_kernel_route_one_launch_equals_solo_runs():
    """The kernel route batches every universe's shards into one core call
    a tick; each universe equals its own sharded run."""
    n, d, ticks = N, 2, 12
    tp = port_params(_jparams(True))
    plans = [TPlan.uniform(device="cpu"), TPlan.uniform(10.0, device="cpu")]
    seeds = [3, 9]
    states = t_stack([T.kill_sparse(T.init_sparse_full_view(n, S, seed=s, device="cpu"), 7)
                      for s in seeds])
    calls = []
    real = TS.sparse_core

    def counting(*a, **kw):
        calls.append(a[0].shape[0])
        return real(*a, **kw)

    TS.sparse_core = counting
    try:
        out, tr = TS.run_ensemble_sparse_ticks_spmd(
            tp, TS.ShardConfig(d), TM.make_universe_member_mesh((2, d)), states,
            t_stack(plans), ticks)
    finally:
        TS.sparse_core = real
    assert calls == [2 * d] * ticks
    leaves = sparse_state_to_numpy(out)
    for u, (seed, plan) in enumerate(zip(seeds, plans)):
        solo, s_tr = TS.run_sparse_ticks_spmd(
            tp, TS.ShardConfig(d), TM.make_mesh(d),
            T.kill_sparse(T.init_sparse_full_view(n, S, seed=seed, device="cpu"), 7), plan, ticks)
        one = sparse_state_to_numpy(solo)
        for k in one:
            assert np.array_equal(leaves[k][u], one[k]), (u, k)
        for k in s_tr:
            assert torch.equal(tr[k][u], s_tr[k]), (u, k)


# --------------------------------------------------------- gloo ranks
def test_gloo_ranks_match_stacked(tmp_path):
    """The same engine as two gloo ranks (one shard each,
    tests/torch_spmd_ranks.py) equals the stacked d=2 run, and both equal
    the reference's d=2 run of the same schedule: n=256, 10 ticks of a
    scheduled timeline, kernel route. Each rank has 240 s."""
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    out_path = tmp_path / "rank0.npz"
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=ranks.gloo_rank, args=(r, port, str(out_path), 10))
             for r in range(2)]
    for proc in procs:
        proc.start()
    for proc in procs:
        proc.join(timeout=240)
    stuck = [proc for proc in procs if proc.is_alive()]
    for proc in stuck:
        proc.terminate()
    assert not stuck, "a gloo rank did not finish within 240 s"
    assert all(proc.exitcode == 0 for proc in procs), [proc.exitcode for proc in procs]
    got = np.load(out_path)
    out, tr = ranks.scheduled_run(TM.make_mesh(2), 10)
    for k, v in sparse_state_to_numpy(out).items():
        assert np.array_equal(got[f"s_{k}"], v), k
    for k, v in tr.items():
        assert np.array_equal(got[f"t_{k}"], v.numpy()), k
    assert int(tr["kills_fired"].sum()) == 2

    jp = _jparams(True)
    assert port_params(jp) == ranks.scheduled_params()

    def compute():
        js = (
            JBuilder(N).add_segment(0, JPlan.uniform())
            .add_segment(4, JPlan.uniform(loss_percent=20.0, mean_delay_ms=40.0))
            .kill(2, 7).kill(3, N // 2 + 3).restart(8, 7).build()
        )
        mesh = JM.make_mesh(jax.devices()[:2])
        jout, jtr = _jax_spmd()(jp, JS.ShardConfig(d=2), mesh, _np_state(j_init(N, S, seed=3)),
                                js, 10, collect=True)
        return jax_state_dict(jout), {k: np.asarray(v) for k, v in jtr.items()}

    jd, jtr = shared_result("test_torch_spmd.ref.gloo_schedule", compute)
    assert_same(jd, jtr, out, tr, "gloo schedule")
