"""The port's population report (``scalecube_cluster_tpu_torch/obs/ensemble.py``)
and its certifier copy (``testlib/invariants.py``) against the reference's
``scalecube_cluster_tpu.obs.ensemble`` and ``testlib.invariants``, on the
CPU: the same ``[B, T]`` traces give equal ``first_tick_where``,
``masked_quantiles``, ``population_stats`` (every key, dtype and bit),
``ensemble_report`` rows and certifier verdicts, including a population
with exactly one tampered universe. Tolerance: none (exact).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scalecube_cluster_tpu.obs import ensemble as JO
from scalecube_cluster_tpu.sim import ensemble as JE
from scalecube_cluster_tpu.sim.state import seeds_mask as j_seeds
from scalecube_cluster_tpu.testlib import invariants as JI
from scalecube_cluster_tpu.testlib.chaos import sample_schedule
from scalecube_cluster_tpu_torch.obs import ensemble as TO
from scalecube_cluster_tpu_torch.sim.params import SimParams as TSimParams
from scalecube_cluster_tpu_torch.testlib import invariants as TI
from scalecube_cluster_tpu_torch.testing import one_cpu_thread, shared_result
from tests.test_sim import small_params

one_cpu_thread()

N = 16
SEEDS = (0, 1, 2, 3)


def _tparams(jp):
    return TSimParams(**dataclasses.asdict(jp))


def _random_traces(seed, b=7, t=50, z=3):
    """Synthetic [B, T] traces: convergence that dips and recovers (one
    universe never recovers), sparse counters, zone gauges."""
    rng = np.random.default_rng(seed)
    conv = np.where(rng.random((b, t)) < 0.7, 1.0, rng.random((b, t))).astype(np.float32)
    conv[:, -3:] = 1.0
    conv[2, -1] = 0.5
    tr = {"convergence": conv}
    for k in TO.ENVELOPE_KEYS:
        tr[k] = (rng.integers(0, 4, (b, t)) * (rng.random((b, t)) < 0.3)).astype(np.int32)
    tr["verdicts_dead"][4] = 0  # a universe with no verdict: -1 first tick
    tr["zone_intra_conv"] = rng.random((b, t, z)).astype(np.float32)
    tr["zone_false_dead"] = rng.integers(0, 4, (b, t, z)).astype(np.int32)
    tr["zone_intra_suspects"] = rng.integers(0, 4, (b, t, z)).astype(np.int32)
    return tr


def _same(a, b, where):
    a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (where, a.dtype, b.dtype, a.shape, b.shape)
    assert np.array_equal(a.view(np.uint8), b.view(np.uint8)), where


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_first_tick_and_quantiles_match_jax(seed):
    rng = np.random.default_rng(seed)
    mask = rng.random((9, 40)) < 0.05
    mask[3] = False
    _same(JO.first_tick_where(jnp.asarray(mask)), TO.first_tick_where(torch.from_numpy(mask)),
          "first_tick_where")
    x = rng.integers(-1, 60, 11).astype(np.int32)
    for valid in (x >= 0, np.zeros(11, bool), np.ones(11, bool)):
        _same(JO.masked_quantiles(jnp.asarray(x), jnp.asarray(valid)),
              TO.masked_quantiles(torch.from_numpy(x), torch.from_numpy(valid)),
              ("masked_quantiles", valid.sum()))


@pytest.mark.parametrize("seed", [0, 1])
def test_population_stats_match_jax(seed):
    """Every statistic (convergence times and CDF, latency quantiles,
    totals and envelopes, per-tick envelopes, per-zone envelopes) equal in
    dtype, shape and bits."""
    tr = _random_traces(seed)
    want = JO.population_stats({k: jnp.asarray(v) for k, v in tr.items()})
    got = TO.population_stats({k: torch.from_numpy(v) for k, v in tr.items()})
    assert set(want) == set(got)
    for k in want:
        _same(want[k], got[k].numpy(), k)


def _reference_run():
    """A reference dense ensemble (B=4, n=16, sampled schedules, 90 ticks)
    and its report rows and certification."""

    def compute():
        p = small_params(N)
        st = JE.init_ensemble_dense(N, SEEDS, user_gossip_slots=2)
        plans = JE.stack_universes(sample_schedule(s, N) for s in SEEDS)
        _, tr = JE.run_ensemble_ticks(p, st, plans, j_seeds(N, [0]), 90)
        tr = {k: np.asarray(v) for k, v in tr.items()}
        rep = JO.ensemble_report(p, tr, meta={"scenario": "chaos"})
        return tr, rep["rows"], rep["certification"]

    return shared_result("obs-ensemble-reference-run", compute)


def test_ensemble_report_rows_match_jax():
    """One ``ensemble_population`` row and B ``ensemble_universe`` rows,
    equal to the reference's, key for key, from numpy and from tensors."""
    tr, rows, cert = _reference_run()
    tp = _tparams(small_params(N))
    got = TO.ensemble_report(tp, tr, meta={"scenario": "chaos"})
    assert got["rows"] == rows
    assert [r["kind"] for r in rows] == ["ensemble_population"] + ["ensemble_universe"] * 4
    assert np.array_equal(got["certification"]["ok"], cert["ok"])
    as_tensors = TO.ensemble_report(tp, {k: torch.from_numpy(v) for k, v in tr.items()},
                                    meta={"scenario": "chaos"})
    assert as_tensors["rows"] == rows


def test_certify_population_flags_one_tampered_universe():
    """Tampering universe 2's ``link_delivered`` at one tick breaks C1 there
    and only there, in both certifiers, with the same verdict; the report
    counts one failure."""
    tr, _, _ = _reference_run()
    bad = {k: v.copy() for k, v in tr.items()}
    bad["link_delivered"][2, 17] += 1
    jp = small_params(N)
    want = JI.certify_population(jp, bad)
    got = TI.certify_population(_tparams(jp), bad)
    assert list(got["ok"]) == [True, True, False, True]
    assert np.array_equal(got["ok"], want["ok"])
    assert got["violations"] == want["violations"]
    assert got["summaries"] == want["summaries"]
    assert got["violations"][2]["invariant"] == "C1-conservation"
    rep = TO.ensemble_report(_tparams(jp), bad)
    assert rep["rows"][0]["failures"] == 1 and rep["rows"][3]["violation"] == "C1-conservation"
    assert rep["rows"] == JO.ensemble_report(jp, bad)["rows"]
