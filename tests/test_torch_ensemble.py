"""The port's ensemble engine (``scalecube_cluster_tpu_torch/sim/ensemble.py``)
against the reference's vmapped ensemble (``scalecube_cluster_tpu.sim.
ensemble``), on the CPU.

The same seeds, schedules and knobs go through both packages; every state
leaf of every universe and every ``[B, T]`` trace key must be equal. Cases:
the dense engine (fixed plans and sampled schedules, a knob grid, the
fused route with one universe joining while the others do not, the
chunked runner), the sparse engine (the XLA chain under schedules, the
kernel route with all four folds as the JAX tests run the Pallas kernel on
the CPU), a fresh universe put into a stack that has run, the batched
convergence and ``sparse_summary``, the structure checks of
``stack_universes``, and the aten operations of one batched tick, which do
not grow with B. Tolerance: none (exact).
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from scalecube_cluster_tpu.sim import ensemble as JE
from scalecube_cluster_tpu.sim.faults import FaultPlan as JPlan
from scalecube_cluster_tpu.sim.monitor import sparse_summary as j_sparse_summary
from scalecube_cluster_tpu.sim.sparse import SparseParams as JSP
from scalecube_cluster_tpu.sim.sparse import init_sparse_full_view as j_init_sparse
from scalecube_cluster_tpu.sim.state import init_full_view as j_init_dense
from scalecube_cluster_tpu.sim.state import seeds_mask as j_seeds
from scalecube_cluster_tpu.testlib.chaos import sample_schedule
from scalecube_cluster_tpu_torch.sim import ensemble as TE
from scalecube_cluster_tpu_torch.sim import run as TR
from scalecube_cluster_tpu_torch.sim import state as TS
from scalecube_cluster_tpu_torch.sim.convert import (
    dense_state_from_numpy,
    dense_state_to_numpy,
    sparse_state_from_numpy,
    sparse_state_to_numpy,
)
from scalecube_cluster_tpu_torch.sim.faults import FaultPlan as TPlan
from scalecube_cluster_tpu_torch.sim.monitor import sparse_summary as t_sparse_summary
from scalecube_cluster_tpu_torch.sim.params import SimParams as TSimParams
from scalecube_cluster_tpu_torch.sim.schedule import FaultSchedule as TSched
from scalecube_cluster_tpu_torch.sim.sparse import init_sparse_full_view as t_init_sparse
from scalecube_cluster_tpu_torch.testing import one_cpu_thread, shared_result
from tests.test_sim import small_params
from tests.test_torch_sparse import port_params

one_cpu_thread()

N = 16
SEEDS = (0, 1, 2)


def tparams(jp):
    return TSimParams(**dataclasses.asdict(jp))


def port_schedule(js) -> TSched:
    """The port's stacked (or single) schedule of a reference one, field by
    field (no zone world)."""
    fields = {}
    for f in dataclasses.fields(TSched):
        v = getattr(js, f.name)
        fields[f.name] = None if v is None else torch.from_numpy(np.array(v))
    return TSched(**fields)


def leaves(state) -> dict:
    """A stacked reference state as numpy arrays (None fields dropped)."""
    return {
        f.name: np.asarray(getattr(state, f.name))
        for f in dataclasses.fields(state)
        if getattr(state, f.name) is not None
    }


def port_leaves(state) -> dict:
    flat = (sparse_state_to_numpy if hasattr(state, "slab") else dense_state_to_numpy)(state)
    flat["t_host"] = np.asarray(state.t_host)
    return flat


def assert_same_state(jd: dict, ts, where=""):
    b = port_leaves(ts)
    t_host = b.pop("t_host")
    assert set(jd) == set(b), (where, set(jd) ^ set(b))
    for k in jd:
        assert jd[k].dtype == b[k].dtype, (where, k, jd[k].dtype, b[k].dtype)
        assert np.array_equal(jd[k], b[k]), (where, k)
    assert np.array_equal(t_host, jd["tick"]), where


def assert_same_traces(jt: dict, tt: dict, where=""):
    assert set(jt) == set(tt), (where, set(jt) ^ set(tt))
    for k in jt:
        a = np.asarray(jt[k])
        b = tt[k].numpy() if isinstance(tt[k], torch.Tensor) else np.asarray(tt[k])
        assert a.dtype == b.dtype and a.shape == b.shape, (where, k, a.dtype, b.dtype, a.shape)
        assert np.array_equal(a.view(np.uint8), b.view(np.uint8)), (where, k)


def np_traces(traces: dict) -> dict:
    return {k: np.asarray(v) for k, v in traces.items()}


# ------------------------------------------------------------------ dense
def _dense_plans(kind, n, seeds, device=None):
    if kind == "scheduled":
        scheds = [sample_schedule(s, n) for s in seeds]
        return JE.stack_universes(scheds), port_schedule(JE.stack_universes(scheds))
    loss = [5.0 + 5 * i for i in range(len(seeds))]
    jp = JE.stack_universes(JPlan.uniform(x, 2.0 * i) for i, x in enumerate(loss))
    tp = TE.stack_universes(
        TPlan.uniform(x, 2.0 * i, device="cpu") for i, x in enumerate(loss)
    )
    return jp, tp


def _jax_dense(kind, ticks):
    def compute():
        p = small_params(N)
        jplans, _ = _dense_plans(kind, N, SEEDS)
        st = JE.init_ensemble_dense(N, SEEDS, user_gossip_slots=2)
        fin, tr = JE.run_ensemble_ticks(p, st, jplans, j_seeds(N, [0]), ticks)
        return leaves(fin), np_traces(tr)

    return shared_result(f"ensemble-dense-{kind}-{ticks}", compute)


@pytest.mark.parametrize("kind", ["scheduled", "fixed"])
def test_dense_ensemble_matches_jax(kind):
    """B=3 dense universes at n=16 (own seeds; sampled schedules, or fixed
    uniform plans with loss and delay per universe): every trace key and
    every final leaf of every universe equal the reference's."""
    ticks = 40
    jfin, jtr = _jax_dense(kind, ticks)
    _, tplans = _dense_plans(kind, N, SEEDS)
    st = TE.init_ensemble_dense(N, SEEDS, user_gossip_slots=2, device="cpu")
    fin, tr = TE.run_ensemble_ticks(
        tparams(small_params(N)), st, tplans, TS.seeds_mask(N, [0], device="cpu"), ticks
    )
    assert_same_traces(jtr, tr, kind)
    assert_same_state(jfin, fin, kind)
    assert all(v.shape[:2] == (len(SEEDS), ticks) for v in tr.values())


@pytest.mark.parametrize("grid", ["identity", "lattice"])
def test_dense_knob_grid_matches_jax(grid):
    """Identity knobs equal no knobs; a 2 x 2 lattice of suspicion
    multipliers and fan-out caps equals the reference's, universe by
    universe (XLA core)."""
    ticks = 30
    p = small_params(N)
    mults, caps = ((1.0,), (None,)) if grid == "identity" else ((1.0, 2.5), (None, 1))
    b = len(mults) * len(caps)
    seeds = tuple(range(b)) if grid == "lattice" else (0,)

    def compute():
        jk = JE.knob_grid(p, mults, caps)
        st = JE.init_ensemble_dense(N, seeds, user_gossip_slots=2)
        plans = JE.stack_universes(JPlan.uniform(10.0) for _ in seeds)
        fin, tr = JE.run_ensemble_ticks(p, st, plans, j_seeds(N, [0]), ticks, knobs=jk)
        return leaves(fin), np_traces(tr)

    jfin, jtr = shared_result(f"ensemble-dense-knobs-{grid}", compute)
    tp = tparams(p)
    plans = TE.stack_universes(TPlan.uniform(10.0, device="cpu") for _ in seeds)
    sm = TS.seeds_mask(N, [0], device="cpu")
    st = TE.init_ensemble_dense(N, seeds, user_gossip_slots=2, device="cpu")
    fin, tr = TE.run_ensemble_ticks(tp, st, plans, sm, ticks,
                                    knobs=TE.knob_grid(tp, mults, caps, device="cpu"))
    assert_same_traces(jtr, tr, grid)
    assert_same_state(jfin, fin, grid)
    if grid == "identity":
        st = TE.init_ensemble_dense(N, seeds, user_gossip_slots=2, device="cpu")
        _, plain = TE.run_ensemble_ticks(tp, st, plans, sm, ticks)
        assert_same_traces(jtr, plain, "no knobs")


def _joining_schedules(n, build):
    """Universe 1 restarts member 5 at tick 6 (its fresh row knows only
    itself: a joiner); universes 0 and 2 hold the same event shape with the
    restart past the run, so only universe 1 joins."""
    return [build(n, 6 if u == 1 else 500) for u in range(3)]


def _jax_sched(n, tick):
    from scalecube_cluster_tpu.sim.schedule import ScheduleBuilder

    return ScheduleBuilder(n).add_segment(1, JPlan.uniform(5.0)).kill(2, 5).restart(tick, 5).build()


def _port_sched(n, tick):
    from scalecube_cluster_tpu_torch.sim.schedule import ScheduleBuilder

    return (ScheduleBuilder(n).add_segment(1, TPlan.uniform(5.0, device="cpu"))
            .kill(2, 5).restart(tick, 5).build())


def test_dense_one_universe_joining_matches_jax():
    """The fused route (n=128, ``pallas_delivery``): at tick 6 universe 1
    has a joiner and the others do not. The port reads one "anyone
    joining?" for the batch and takes the slow core for all; the reference
    selects per universe. Both equal, and universes 0 and 2 equal their
    single runs, which take the fused core at that tick."""
    n, ticks = 128, 12
    p = dataclasses.replace(small_params(n, suspicion_ticks=12), pallas_delivery=True)

    def compute():
        st = JE.init_ensemble_dense(n, SEEDS, user_gossip_slots=2)
        plans = JE.stack_universes(_joining_schedules(n, _jax_sched))
        fin, tr = JE.run_ensemble_ticks(p, st, plans, j_seeds(n, [0]), ticks)
        return leaves(fin), np_traces(tr)

    jfin, jtr = shared_result("ensemble-dense-joining", compute)
    tp = tparams(p)
    sm = TS.seeds_mask(n, [0], device="cpu")
    scheds = _joining_schedules(n, _port_sched)
    st = TE.init_ensemble_dense(n, SEEDS, user_gossip_slots=2, device="cpu")
    fin, tr = TE.run_ensemble_ticks(tp, st, TE.stack_universes(scheds), sm, ticks)
    assert_same_traces(jtr, tr, "joining")
    assert_same_state(jfin, fin, "joining")
    for u in (0, 2):
        one = TS.init_full_view(n, 2, seed=SEEDS[u], device="cpu")
        one, tr1 = TR.run_ticks(tp, one, scheds[u], sm, ticks)
        for k, v in tr1.items():
            assert torch.equal(tr[k][u], v), (u, k)
        assert torch.equal(fin.view[u], one.view), u


def test_dense_chunked_matches_jax():
    """``run_ensemble_chunked``: 25 ticks in chunks of 10 trim the traces to
    [B, 25] and leave the states at the chunk boundary (tick 30)."""
    p = small_params(N)

    def compute():
        st = JE.init_ensemble_dense(N, SEEDS, user_gossip_slots=2)
        plans = JE.stack_universes(JPlan.uniform(8.0) for _ in SEEDS)
        fin, tr = JE.run_ensemble_chunked(p, st, plans, j_seeds(N, [0]), 25, chunk=10)
        return leaves(fin), np_traces(tr)

    jfin, jtr = shared_result("ensemble-dense-chunked", compute)
    st = TE.init_ensemble_dense(N, SEEDS, user_gossip_slots=2, device="cpu")
    plans = TE.stack_universes(TPlan.uniform(8.0, device="cpu") for _ in SEEDS)
    fin, tr = TE.run_ensemble_chunked(tparams(p), st, plans,
                                      TS.seeds_mask(N, [0], device="cpu"), 25, chunk=10)
    assert_same_traces(jtr, tr, "chunked")
    assert_same_state(jfin, fin, "chunked")
    assert list(fin.t_host) == [30, 30, 30]


# ----------------------------------------------------------------- sparse
def _sparse_jp(n, **kw):
    return JSP(base=small_params(n), slot_budget=64, alloc_cap=16, **kw)


def _jax_sparse_scheduled(ticks):
    def compute():
        jp = _sparse_jp(N)
        st = JE.init_ensemble_sparse(N, SEEDS, slot_budget=64, user_gossip_slots=2)
        plans = JE.stack_universes(sample_schedule(s, N) for s in SEEDS)
        fin, tr = JE.run_ensemble_sparse_ticks(jp, st, plans, ticks)
        conv = np.asarray(JE.ensemble_sparse_convergence(fin))
        return leaves(fin), np_traces(tr), conv

    return shared_result(f"ensemble-sparse-scheduled-{ticks}", compute)


def test_sparse_ensemble_scheduled_matches_jax():
    """B=3 sparse universes at n=16, S=64 on the XLA chain (in-tick
    write-back) under sampled schedules: every trace, leaf and the batched
    convergence equal the reference's."""
    ticks = 60
    jfin, jtr, jconv = _jax_sparse_scheduled(ticks)
    tp = port_params(_sparse_jp(N))
    st = TE.init_ensemble_sparse(N, SEEDS, slot_budget=64, user_gossip_slots=2, device="cpu")
    plans = port_schedule(JE.stack_universes(sample_schedule(s, N) for s in SEEDS))
    fin, tr = TE.run_ensemble_sparse_ticks(tp, st, plans, ticks)
    assert_same_traces(jtr, tr, "sparse scheduled")
    assert_same_state(jfin, fin, "sparse scheduled")
    conv = TE.ensemble_sparse_convergence(fin).numpy()
    assert np.array_equal(conv.view(np.int32), jconv.view(np.int32))
    for u in range(len(SEEDS)):
        one = TE.sparse_convergence_device(TE.index_universe(fin, u))
        assert float(one) == float(jconv[u])


def test_sparse_kernel_route_matches_jax():
    """The kernel route at n=64, S=128, B=2 with all four folds and
    host-boundary write-backs (``run_ensemble_sparse_chunked``, 48 ticks in
    chunks of 12): the reference vmaps its Pallas kernel (interpret mode on
    the CPU), the port runs the batched plain core."""
    n, seeds, ticks = 64, (3, 5), 48
    jp = JSP(base=small_params(n), slot_budget=128, alloc_cap=16, in_scan_writeback=False,
             pallas_core=True)

    def compute():
        st = JE.init_ensemble_sparse(n, seeds, slot_budget=128, user_gossip_slots=2)
        plans = JE.stack_universes(sample_schedule(s, n) for s in seeds)
        fin, tr = JE.run_ensemble_sparse_chunked(jp, st, plans, ticks, chunk=12)
        return leaves(fin), np_traces(tr)

    jfin, jtr = shared_result("ensemble-sparse-kernel", compute)
    tp = port_params(jp)
    assert TE.ensemble_sparse_tick.__module__.endswith("ensemble_tick")
    from scalecube_cluster_tpu_torch.sim.sparse import sparse_route

    assert sparse_route(tp)
    st = TE.init_ensemble_sparse(n, seeds, slot_budget=128, user_gossip_slots=2, device="cpu")
    plans = port_schedule(JE.stack_universes(sample_schedule(s, n) for s in seeds))
    fin, tr = TE.run_ensemble_sparse_chunked(tp, st, plans, ticks, chunk=12)
    assert_same_traces(jtr, tr, "kernel route")
    assert_same_state(jfin, fin, "kernel route")


@pytest.mark.parametrize("engine", ["dense", "sparse"])
def test_set_universe_into_running_stack_matches_jax(engine):
    """A stack runs 7 ticks, a fresh state goes into universe 1
    (``set_universe``), and the stack steps 20 more ticks: universe 1 is a
    tick-0 universe beside two at tick 7, each on its own cadence."""
    p = small_params(N)
    jp = _sparse_jp(N)

    def jax_init(seeds):
        if engine == "dense":
            return JE.init_ensemble_dense(N, seeds, user_gossip_slots=2)
        return JE.init_ensemble_sparse(N, seeds, slot_budget=64, user_gossip_slots=2)

    def jax_run(st, plans, ticks):
        if engine == "dense":
            return JE.run_ensemble_ticks(p, st, plans, j_seeds(N, [0]), ticks)
        return JE.run_ensemble_sparse_ticks(jp, st, plans, ticks)

    def compute():
        plans = JE.stack_universes(JPlan.uniform(10.0) for _ in SEEDS)
        st, _ = jax_run(jax_init(SEEDS), plans, 7)
        fresh = (j_init_dense(N, 2, seed=9) if engine == "dense"
                 else j_init_sparse(N, slot_budget=64, seed=9, user_gossip_slots=2))
        st = JE.set_universe(st, 1, fresh)
        fin, tr = jax_run(st, plans, 20)
        return leaves(fin), np_traces(tr)

    jfin, jtr = shared_result(f"ensemble-set-universe-{engine}", compute)
    plans = TE.stack_universes(TPlan.uniform(10.0, device="cpu") for _ in SEEDS)
    sm = TS.seeds_mask(N, [0], device="cpu")
    tp = tparams(p) if engine == "dense" else port_params(jp)

    def port_run(st, ticks):
        if engine == "dense":
            return TE.run_ensemble_ticks(tp, st, plans, sm, ticks)
        return TE.run_ensemble_sparse_ticks(tp, st, plans, ticks)

    if engine == "dense":
        st = TE.init_ensemble_dense(N, SEEDS, user_gossip_slots=2, device="cpu")
        fresh = TS.init_full_view(N, 2, seed=9, device="cpu")
    else:
        st = TE.init_ensemble_sparse(N, SEEDS, slot_budget=64, user_gossip_slots=2,
                                     device="cpu")
        fresh = t_init_sparse(N, slot_budget=64, seed=9, user_gossip_slots=2, device="cpu")
    st, _ = port_run(st, 7)
    st = TE.set_universe(st, 1, fresh)
    assert list(st.t_host) == [7, 0, 7]
    fin, tr = port_run(st, 20)
    assert_same_traces(jtr, tr, engine)
    assert_same_state(jfin, fin, engine)


def test_port_resumes_reference_ensemble_state():
    """Stacked conversion both ways: the reference's ``init_ensemble_*``
    states, run 10 ticks there, become the port's (every leaf, ``rng
    [B, 2]``, per-universe ``t_host``) and step on equal to the reference."""
    p = small_params(N)
    jp = _sparse_jp(N)

    def compute():
        d_plans = JE.stack_universes(JPlan.uniform(10.0) for _ in SEEDS)
        dense0, _ = JE.run_ensemble_ticks(p, JE.init_ensemble_dense(N, SEEDS, user_gossip_slots=2),
                                          d_plans, j_seeds(N, [0]), 10)
        dense1, dtr = JE.run_ensemble_ticks(p, dense0, d_plans, j_seeds(N, [0]), 10)
        sp0, _ = JE.run_ensemble_sparse_ticks(
            jp, JE.init_ensemble_sparse(N, SEEDS, slot_budget=64, user_gossip_slots=2),
            d_plans, 10)
        sp0 = leaves(sp0)
        sp1, str_ = JE.run_ensemble_sparse_ticks(
            jp, JE.init_ensemble_sparse(N, SEEDS, slot_budget=64, user_gossip_slots=2),
            d_plans, 20)
        return (leaves(dense0), leaves(dense1), np_traces(dtr), sp0, leaves(sp1))

    d0, d1, dtr, s0, s1 = shared_result("ensemble-resume", compute)
    plans = TE.stack_universes(TPlan.uniform(10.0, device="cpu") for _ in SEEDS)
    ts = dense_state_from_numpy(d0, device="cpu")
    assert list(ts.t_host) == [10, 10, 10] and ts.rng.shape == (3, 2)
    assert_same_state(d0, ts, "dense converted")
    ts, tr = TE.run_ensemble_ticks(tparams(p), ts, plans, TS.seeds_mask(N, [0], device="cpu"), 10)
    assert_same_traces(dtr, tr, "dense resumed")
    assert_same_state(d1, ts, "dense resumed")
    ss = sparse_state_from_numpy(s0, device="cpu")
    assert_same_state(s0, ss, "sparse converted")
    ss, _ = TE.run_ensemble_sparse_ticks(port_params(jp), ss, plans, 10)
    assert_same_state(s1, ss, "sparse resumed")


def test_batched_sparse_summary_matches_jax():
    """``sparse_summary`` on a stacked port state equals the reference's
    batched call on the same stacked state: a ``[B]`` vector per value."""
    jfin, jtr, _ = _jax_sparse_scheduled(60)
    ts = sparse_state_from_numpy(jfin, device="cpu")

    def jax_summary():
        from scalecube_cluster_tpu.sim.sparse import SparseState as JState
        import jax.numpy as jnp

        st = JState(**{k: jnp.asarray(v) for k, v in jfin.items()})
        return j_sparse_summary(st, traces=jtr)

    want = shared_result("ensemble-sparse-summary", jax_summary)
    got = t_sparse_summary(ts, traces=jtr)
    assert set(want) == set(got)
    for k in want:
        assert np.array_equal(np.asarray(want[k]), np.asarray(got[k])), k


# ------------------------------------------------------------ structure
def test_stack_universes_refuses_mismatched_structures():
    """Different shapes, dtypes, dataclass types and None patterns refuse;
    index/set round-trip a universe."""
    a = t_init_sparse(16, slot_budget=64, seed=0, device="cpu")
    with pytest.raises(ValueError, match="structure"):
        TE.stack_universes([a, t_init_sparse(16, slot_budget=128, seed=1, device="cpu")])
    with pytest.raises(ValueError, match="structure"):
        TE.stack_universes([a, t_init_sparse(16, slot_budget=64, record_latency=True,
                                             device="cpu")])
    with pytest.raises(ValueError, match="structure"):
        TE.stack_universes([a, TS.init_full_view(16, device="cpu")])
    with pytest.raises(ValueError, match="structure"):
        TE.stack_universes([TPlan.uniform(5.0, device="cpu"), TPlan.clean(16, device="cpu")])
    with pytest.raises(ValueError, match="at least one"):
        TE.stack_universes([])
    st = TE.stack_universes([a, t_init_sparse(16, slot_budget=64, seed=1, device="cpu")])
    assert TE.ensemble_size(st) == 2 and st.rng.shape == (2, 2)
    one = TE.index_universe(st, 1)
    assert one.t_host == 0 and np.array_equal(one.rng, st.rng[1])
    with pytest.raises(ValueError, match="structure"):
        TE.set_universe(st, 0, TS.init_full_view(16, device="cpu"))
    back = TE.set_universe(st, 0, one)
    assert np.array_equal(back.rng[0], st.rng[1])


def test_unported_ensemble_options_raise():
    """Traced states and the in-scan write-back of the chunked runner
    raise, naming what is missing, as do unstacked plans; an elastic stack
    steps (the batched tick's join lane), each universe reporting its
    ``n_live``."""
    p = port_params(_sparse_jp(16))
    plans = TE.stack_universes(TPlan.uniform(5.0, device="cpu") for _ in range(2))
    traced = TE.init_ensemble_sparse(16, range(2), slot_budget=64, trace_capacity=256,
                                     device="cpu")
    with pytest.raises(NotImplementedError, match="A9"):
        TE.run_ensemble_sparse_ticks(p, traced, plans, 1)
    elastic = TE.init_ensemble_sparse(8, range(2), slot_budget=64, n_alloc=16, device="cpu")
    elastic, tr = TE.run_ensemble_sparse_ticks(p, elastic, plans, 1)
    assert tr["n_live"].tolist() == [[8], [8]] and elastic.t_host.tolist() == [1, 1]
    with pytest.raises(ValueError, match="in_scan_writeback"):
        TE.run_ensemble_sparse_chunked(p, TE.init_ensemble_sparse(16, range(2), slot_budget=64,
                                                                  device="cpu"), plans, 4)
    with pytest.raises(ValueError, match="stacked"):
        TE.run_ensemble_sparse_ticks(p, TE.init_ensemble_sparse(16, range(2), slot_budget=64,
                                                                device="cpu"),
                                     TPlan.uniform(5.0, device="cpu"), 1)


# ------------------------------------------------------------- launches
class _OpCount(TorchDispatchMode):
    """Counts the aten operations that do work (views excluded)."""

    def __init__(self):
        super().__init__()
        self.count = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not func.is_view:
            self.count += 1
        return func(*args, **(kwargs or {}))


def _tick_ops(engine, b, n=64):
    from scalecube_cluster_tpu_torch.sim.sparse import SparseParams

    plans = TE.stack_universes(TPlan.uniform(5.0, device="cpu") for _ in range(b))
    if engine == "sparse":
        p = SparseParams.for_n(n, slot_budget=128, in_scan_writeback=False, pallas_core=True)
        st = TE.init_ensemble_sparse(n, range(b), slot_budget=128, device="cpu")
        st, _ = TE.run_ensemble_sparse_ticks(p, st, plans, 4, collect=False)

        def run():
            TE.run_ensemble_sparse_ticks(p, st, plans, 1, collect=False)
    else:
        p = TSimParams.from_cluster_config(n)
        sm = TS.seeds_mask(n, [0, 1], device="cpu")
        st = TE.init_ensemble_dense(n, range(b), device="cpu")
        st, _ = TE.run_ensemble_ticks(p, st, plans, sm, 4, collect=False)

        def run():
            TE.run_ensemble_ticks(p, st, plans, sm, 1, collect=False)
    with _OpCount() as counter:
        run()
    return counter.count


@pytest.mark.parametrize("engine", ["sparse", "dense"])
def test_ensemble_tick_ops_do_not_grow_with_b(engine):
    """One batched tick (tick 5, an FD tick of the LAN preset) does the same
    aten operations at B = 2, 4 and 16, and at most one more than at B = 1
    (the tick's keys upload as one tensor at every B; a sliced slot table
    is contiguous only at B = 1)."""
    counts = {b: _tick_ops(engine, b) for b in (1, 2, 4, 16)}
    assert counts[2] == counts[4] == counts[16], counts
    assert counts[2] <= counts[1] + 1, counts


@pytest.mark.parametrize("core", ["sparse_core", "tick_core"])
def test_batched_core_wrappers_equal_per_universe_calls(core):
    """On CPU tensors each fused core's wrapper takes a leading universe
    axis and equals one call per universe (its plain version); operands
    whose universe axes disagree are refused."""
    from scalecube_cluster_tpu_torch.ops.sparse_core import sparse_core
    from scalecube_cluster_tpu_torch.ops.tick_core import tick_core
    from scalecube_cluster_tpu_torch.testing import random_operands, random_tick_operands

    if core == "sparse_core":
        fn = sparse_core
        sets = [random_operands(64, 128, 3, seed=80 + u) for u in range(3)]
        consts = dict(spread=48, susp_ticks=400, age_stale=120, sweep=98)
    else:
        fn = tick_core
        sets = [random_tick_operands(64, 3, seed=90 + u, susp_ticks=350) for u in range(3)]
        consts = dict(spread=42, sweep=86, susp_ticks=350, age_stale=120)
    args = [torch.from_numpy(np.stack([o[k] for o in sets])) for k in sets[0]]
    got = fn(*args, **consts)
    for u in range(3):
        for g, w in zip(got, fn(*(a[u] for a in args), **consts)):
            assert torch.equal(g[u], w), u
    args[-1] = args[-1][:2]
    with pytest.raises(ValueError, match="expected"):
        fn(*args, **consts)
