"""The port's chaos harness (``scalecube_cluster_tpu_torch/testlib/chaos.py``)
against the reference's (``scalecube_cluster_tpu.testlib.chaos``), on the
CPU.

The same seeds go through both packages: the sampled schedules' digests and
metadata, the flat trials on every engine, the ensemble rows (against the
reference's ensemble and the port's own loop trials, one batched tick a
tick with no tick-group split), the SWIM-vs-Rapid race, the geo trials of
every variant on the SWIM engines and Rapid's fallback trim, a grow trial,
and the certifiers on tampered traces. Every result dict must be equal key
for key and value for value, apart from the grow trial's wall-clock
``promotion_wall_ms``. Tolerance: none (exact).
"""

import numpy as np
import pytest

from scalecube_cluster_tpu.testlib import chaos as J
from scalecube_cluster_tpu.testlib import invariants as JI
from scalecube_cluster_tpu_torch.sim import ensemble as TE
from scalecube_cluster_tpu_torch.sim import rapid as TR
from scalecube_cluster_tpu_torch.testlib import chaos as T
from scalecube_cluster_tpu_torch.testlib import invariants as TI
from scalecube_cluster_tpu_torch.testing import one_cpu_thread, shared_result
from tests.test_chaos import _clean_traces

one_cpu_thread()

N = 24
SEEDS = (0, 1, 2)
GEO_N = 16
#: Seeds whose geo draw is each variant (seed 0 brownout3, 1 oneway,
#: 2 split2; test_schedule_digests_match_reference pins the draw).
GEO_SEEDS = {"brownout3": 0, "oneway": 1, "split2": 2}


#: The trials that several tests read (and the chaos CLI's tests in
#: tests/test_torch_experiments.py), each run once per test run through
#: testing.py::shared_result, as each package defines them.
SHARED = ("chaos_trial", "chaos_ensemble", "geo_trial", "grow_trial")
_PORT = {name: getattr(T, name) for name in SHARED}
_REF = {name: getattr(J, name) for name in SHARED}


def _key(side, name, args):
    norm = [tuple(int(x) for x in a) if isinstance(a, (list, tuple, range)) else a
            for a in args]
    return f"{side}-{name}-{norm!r}"


def port_run(name, *args):
    """The port's ``name(*args)`` on the CPU, once per test run."""
    return shared_result(_key("port", name, args), lambda: _PORT[name](*args, device="cpu"))


def ref_run(name, *args):
    """The reference's ``name(*args)``, once per test run."""
    return shared_result(_key("ref", name, args), lambda: _REF[name](*args))


def share_trials(monkeypatch):
    """Route both packages' trials through :func:`port_run` and
    :func:`ref_run` for the rest of the test: the soaks, races, matrices
    and command lines that call them read the runs the trial tests made."""
    for name in SHARED:
        def port(*args, device, _name=name):
            assert device == "cpu"
            return port_run(_name, *args)

        monkeypatch.setattr(T, name, port)
        monkeypatch.setattr(J, name, lambda *args, _name=name: ref_run(_name, *args))


def port_trial(engine, seed):
    return port_run("chaos_trial", seed, N, engine)


@pytest.mark.parametrize("seed", range(8))
def test_schedule_digests_match_reference(seed):
    """One seed draws the same flat and geo schedules in both packages:
    the digests (which hash every plan matrix, flap mask, event and zone
    world) and the drawn windows."""
    js, jm = J.sample_schedule(seed, N, with_meta=True)
    ts, tm = T.sample_schedule(seed, N, with_meta=True, device="cpu")
    assert ts.digest() == js.digest() and tm == jm
    jg, jgm = J.sample_geo_schedule(seed, GEO_N, with_meta=True)
    tg, tgm = T.sample_geo_schedule(seed, GEO_N, with_meta=True, device="cpu")
    assert tg.digest() == jg.digest() and tgm == jgm
    if seed in GEO_SEEDS.values():
        assert GEO_SEEDS[tgm["variant"]] == seed


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("engine", T.ALL_ENGINES)
def test_chaos_trial_matches_reference(engine, seed):
    want = ref_run("chaos_trial", seed, N, engine)
    got = port_trial(engine, seed)
    assert got == want
    assert got["ok"], got


_FALLBACK_KEYS = ("fallback_rounds", "fallback_commits", "join_requests", "join_confirms")

#: The batched tick each engine's ensemble steps through, by module.
_BATCHED_TICK = {
    "dense": (TE, "ensemble_sim_tick"),
    "sparse": (TE, "ensemble_sparse_tick"),
    "rapid": (TR, "_tick"),
    "rapid_fb": (TR, "_tick"),
}


@pytest.mark.parametrize("engine", T.ALL_ENGINES)
def test_chaos_ensemble_matches_reference_and_loop(engine, monkeypatch):
    """The seed matrix as one ensemble: the reference's rows, the port's
    own loop trials, and one batched tick a tick (every universe in one
    tick group)."""
    module, name = _BATCHED_TICK[engine]
    calls = []
    tick = getattr(module, name)

    def counted(*args, **kw):
        calls.append(1)
        return tick(*args, **kw)

    monkeypatch.setattr(module, name, counted)
    got = T.chaos_ensemble(SEEDS, N, engine, device="cpu")
    monkeypatch.undo()
    assert len(calls) == T.trial_ticks(T.chaos_params(N))
    assert got == ref_run("chaos_ensemble", SEEDS, N, engine)
    # The bare Rapid trim's ensemble reads back no fallback gauges, so its
    # rows lack the loop trial's four fallback counters (the reference's
    # rows do too).
    extra = set(_FALLBACK_KEYS) if engine == "rapid" else set()
    loop = [port_trial(engine, s) for s in SEEDS]
    assert got == [{k: v for k, v in r.items() if k not in extra} for r in loop]


def test_chaos_race_matches_reference(monkeypatch):
    """The race over the seed matrix: its two ensembles per package are the
    ensemble test's (the reference's read from it)."""
    share_trials(monkeypatch)
    got = T.chaos_race(SEEDS, N, device="cpu")
    assert got == J.chaos_race(SEEDS, N)
    assert all(r["ok"] for r in got)


@pytest.mark.parametrize("variant", sorted(GEO_SEEDS))
@pytest.mark.parametrize("engine", T.GEO_ENGINES)
def test_geo_trial_matches_reference(engine, variant):
    seed = GEO_SEEDS[variant]
    got = port_run("geo_trial", seed, GEO_N, engine)
    assert got == ref_run("geo_trial", seed, GEO_N, engine)
    assert got["ok"] and got["variant"] == variant, got


def test_grow_trial_matches_reference():
    """Joins racing kill/restart pairs across one mid-brownout promotion
    (16 -> 32 rows): the row, the ledger and the live x live heal."""
    got = port_run("grow_trial", 0, 16, 1)
    want = ref_run("grow_trial", 0, 16, 1)
    assert len(got.pop("promotion_wall_ms")) == len(want.pop("promotion_wall_ms")) == 1
    assert got == want
    assert got["ok"] and got["promotions"] == 1, got


def _caught(module, params, traces):
    with pytest.raises(module.InvariantViolation) as e:
        module.certify_traces(params, traces)
    return e.value.invariant, str(e.value)


@pytest.mark.parametrize(
    "tamper, invariant",
    [
        (lambda t: t["link_delivered"].__setitem__(20, 9), "C1-conservation"),
        (
            lambda t: (
                t["fault_blocked"].__setitem__(20, 1),
                t["link_attempts"].__setitem__(20, 11),
            ),
            "C2-clean-tick",
        ),
        (lambda t: t["verdicts_dead"].__setitem__(30, 1), "C3-false-dead"),
        (lambda t: t["epoch_max"].__setitem__(10, 1), "C4-epoch-monotone"),
        (
            lambda t: t["epoch_max"].__setitem__(slice(10, None), 1),
            "C4-epoch-source",
        ),
        (
            lambda t: t["inc_max"].__setitem__(slice(0, 10), 2),
            "C5-incarnation-monotone",
        ),
        (
            lambda t: t["suspicions_raised"].__setitem__(5, 1),
            "C3-false-suspicion",
        ),
        (
            lambda t: (
                t["plan_dirty"].__setitem__(40, True),
                t["suspicions_raised"].__setitem__(5, 1),
            ),
            "C6-suspicion-cause",
        ),
    ],
)
def test_tampered_traces_caught_as_reference(tamper, invariant):
    """Each doctored trace set fails the port's certifier under the
    reference's invariant name and message."""
    traces = _clean_traces()
    assert TI.certify_traces(T.chaos_params(N), traces) == JI.certify_traces(
        J.chaos_params(N), traces
    )
    tamper(traces)
    got = _caught(TI, T.chaos_params(N), traces)
    assert got == _caught(JI, J.chaos_params(N), traces)
    assert got[0] == invariant


def test_tampered_real_run_caught_as_reference():
    """The port's real scheduled run certifies as the reference's does;
    zeroing its blocked bucket breaks C1 in both certifiers alike."""
    params = T.chaos_params(N)
    schedule = T.sample_schedule(0, N, device="cpu")  # a blocking variant
    _, traces, conv = T.run_scheduled("dense", params, schedule, T.trial_ticks(params))
    traces = {k: np.array(v) for k, v in traces.items()}
    summary = TI.certify_traces(params, traces)
    TI.certify_heal(params, summary, conv)
    assert summary == JI.certify_traces(J.chaos_params(N), traces)
    assert summary["fault_blocked"] > 0
    traces["fault_blocked"][:] = 0
    got = _caught(TI, params, traces)
    assert got == _caught(JI, J.chaos_params(N), traces)
    assert got[0] == "C1-conservation"
