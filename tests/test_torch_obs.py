"""The port's copies in ``scalecube_cluster_tpu_torch/obs/`` against the JAX
package's originals, on the same inputs: the counter schema and the
counter block, detection latencies and histograms, the rolling SLO
tracker, export rows, JSONL lines and Prometheus text, the recorder's
event kinds, the ring decode and the Chrome trace, and the profiler scope.
Every copied constant table (``SHARED_COUNTERS``, the ``TK_*`` kinds,
``DEAD_VIA_*``, ``SCHEMA_VERSION``) equals the original. Tolerance: none.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from scalecube_cluster_tpu.obs import counters as JCnt
from scalecube_cluster_tpu.obs import export as JExp
from scalecube_cluster_tpu.obs import latency as JLat
from scalecube_cluster_tpu.obs import slo as JSlo
from scalecube_cluster_tpu.obs import trace as JTrace
from scalecube_cluster_tpu_torch.obs import counters as TCnt
from scalecube_cluster_tpu_torch.obs import export as TExp
from scalecube_cluster_tpu_torch.obs import latency as TLat
from scalecube_cluster_tpu_torch.obs import profiling as TProf
from scalecube_cluster_tpu_torch.obs import slo as TSlo
from scalecube_cluster_tpu_torch.obs import trace as TTrace
from scalecube_cluster_tpu_torch.testing import one_cpu_thread

one_cpu_thread()


def _constants(mod, prefixes):
    return {k: v for k, v in vars(mod).items() if k.startswith(prefixes)}


@pytest.mark.parametrize("table", ["counters", "trace", "export"])
def test_constant_tables_equal_the_originals(table):
    if table == "counters":
        assert TCnt.SHARED_COUNTERS == JCnt.SHARED_COUNTERS
        assert TCnt.SIM_ONLY_COUNTERS == JCnt.SIM_ONLY_COUNTERS
    elif table == "trace":
        got = _constants(TTrace, ("TK_", "DEAD_VIA_"))
        assert got == _constants(JTrace, ("TK_", "DEAD_VIA_")) and len(got) == 21
    else:
        assert TExp.SCHEMA_VERSION == JExp.SCHEMA_VERSION
        assert TExp._RESERVED == JExp._RESERVED


def test_protocol_counters_match():
    blocks = []
    for mod in (TCnt, JCnt):
        c = mod.ProtocolCounters()
        c.inc("pings", 3)
        c.inc("acks")
        c.sent("membership/sync")
        c.sent("membership/sync")
        with pytest.raises(KeyError):
            c.inc("no_such_counter")
        snaps = [c.snapshot(), {"pings": 2, "fault_lost": 1}]
        blocks.append((c.snapshot(), c.sent_by_qualifier(), mod.sum_counters(snaps),
                       mod.diff_counters(snaps[0], snaps[1])))
    assert blocks[0] == blocks[1]


def _latency_state(seed, n=64):
    rng = np.random.default_rng(seed)
    fs = np.where(rng.random(n) < 0.6, rng.integers(0, 90, n), -1).astype(np.int32)
    fd = np.where(fs >= 0, fs + rng.integers(0, 40, n), -1).astype(np.int32)
    kills = np.where(rng.random(n) < 0.5, rng.integers(0, 60, n), -1)
    return fs, fd, kills


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_latency_and_slo_match(seed):
    """Numpy and tensor recorders, kill ticks as an array and as a dict;
    histograms, percentile summaries and the SLO tracker's two views."""
    fs, fd, kills = _latency_state(seed)
    jst = SimpleNamespace(lat_first_suspect=fs, lat_first_dead=fd)
    tst = SimpleNamespace(lat_first_suspect=torch.from_numpy(fs),
                          lat_first_dead=torch.from_numpy(fd))
    as_dict = {int(i): int(t) for i, t in enumerate(kills) if t >= 0}
    for kt in (kills, as_dict):
        a, b = TLat.detection_latencies(tst, kt), JLat.detection_latencies(jst, kt)
        assert a.keys() == b.keys()
        for k in a:
            assert np.array_equal(a[k], b[k]), k
        for arr in (a["suspect_latency"], a["dead_latency"], np.zeros(0, np.int64)):
            assert TLat.latency_histogram(arr) == JLat.latency_histogram(arr)
            assert TLat.percentile_summary(arr) == JLat.percentile_summary(arr)
    rng = np.random.default_rng(seed)
    trackers = [TSlo.RollingSLOTracker(window=5), JSlo.RollingSLOTracker(window=5)]
    for _ in range(12):
        rec = (float(rng.random() * 40), int(rng.integers(1, 30)), float(rng.random()),
               int(rng.integers(0, 3)))
        for t in trackers:
            t.record(*rec)
    assert trackers[0].session() == trackers[1].session()
    assert trackers[0].rolling() == trackers[1].rolling()
    with pytest.raises(ValueError):
        TSlo.RollingSLOTracker(window=0)


def test_export_rows_match(tmp_path):
    """Rows, their JSONL lines and files, Prometheus text; the metadata's
    keys in the original's order, commit and platform as given, the census
    stamps equal, the jax fields ``unknown``."""
    payload = {"value": 1234.5, "n": 64, "engine": "sparse", "flag": True,
               "series": [1, 2], "nan": float("nan"), "count": 7}
    tm = TExp.run_metadata(n=64, slot_budget=128, seed=3, platform="gpu", commit="abc1234")
    jm = JExp.run_metadata(n=64, slot_budget=128, seed=3, platform="gpu", commit="abc1234")
    assert list(tm) == list(jm)
    for k in ("commit", "platform", "n", "slot_budget", "seed", "lint_schema",
              "census_digest", "collective_digest"):
        assert tm.get(k) == jm.get(k), k
    assert tm["jax_version"] == tm["jaxlib_version"] == "unknown"
    rows = [TExp.make_row("bench", payload, tm), TExp.make_row("bench_tracer", {"x": 2})]
    jrows = [JExp.make_row("bench", payload, tm), JExp.make_row("bench_tracer", {"x": 2})]
    assert [TExp.jsonl_line(r) for r in rows] == [JExp.jsonl_line(r) for r in jrows]
    assert TExp.prometheus_text(rows) == JExp.prometheus_text(jrows)
    assert TExp.prometheus_text([]) == JExp.prometheus_text([])
    for bad in ({"schema": 2}, {"kind": "x"}):
        with pytest.raises(ValueError):
            TExp.make_row("bench", bad)
    TExp.append_jsonl(str(tmp_path / "t.jsonl"), rows)
    JExp.append_jsonl(str(tmp_path / "j.jsonl"), jrows)
    TExp.write_prometheus(str(tmp_path / "t.prom"), rows)
    JExp.write_prometheus(str(tmp_path / "j.prom"), jrows)
    for ext in ("jsonl", "prom"):
        assert (tmp_path / f"t.{ext}").read_text() == (tmp_path / f"j.{ext}").read_text()


def test_run_metadata_stays_off_the_card():
    """Without an argument ``platform`` comes from the imported torch, and
    ``device_kind`` stays ``unknown`` while CUDA is not initialised."""
    meta = TExp.run_metadata(commit="x")
    assert meta["platform"] == ("gpu" if torch.cuda.is_available() else "cpu")
    if not torch.cuda.is_initialized():
        assert meta["device_kind"] == "unknown"


def test_ring_decode_and_chrome_trace_match():
    """The same ring arrays (numpy, and tensors for the port) decode to the
    same events; their Chrome trace, with launch spans carrying ring
    occupancy and message spans, is the same object."""
    rng = np.random.default_rng(4)
    cap, cursor = 64, 40
    fields = {
        "ev_kind": rng.integers(1, 19, cap), "ev_tick": rng.integers(0, 30, cap),
        "ev_actor": rng.integers(-1, 16, cap), "ev_subject": rng.integers(-1, 16, cap),
        "ev_cause": rng.integers(-1, 40, cap), "ev_aux": rng.integers(0, 3, cap),
    }
    fields = {k: v.astype(np.int32) for k, v in fields.items()}
    jring = SimpleNamespace(cursor=np.int32(cursor), overflow=np.int32(5), capacity=cap,
                            **fields)
    tring = SimpleNamespace(cursor=torch.tensor(cursor), overflow=torch.tensor(5),
                            capacity=cap, **{k: torch.from_numpy(v) for k, v in fields.items()})
    jev = JTrace.ring_events(jring)
    assert TTrace.ring_events(tring) == jev and len(jev) == cursor
    kinds = {JTrace.TK_PROBE_SENT, JTrace.TK_VERDICT_DEAD, JTrace.TK_SUSPECT_START}
    assert TTrace.ring_events(tring, kinds) == [e for e in jev if e["kind"] in kinds]
    assert TTrace.ring_overflow(tring) == JTrace.ring_overflow(jring) == 5
    assert TTrace.trace_occupancy(tring) == JTrace.trace_occupancy(jring)
    spans = [{"t0": 10.0, "t1": 10.25, "batch": 0, "base_tick": 0, "batch_ticks": 8,
              "n_events": 4, "ring_occupancy": JTrace.trace_occupancy(jring)}]
    msgs = [{"correlation_id": "c1", "qualifier": "q", "t0": 9.5, "t1": 9.75, "ok": True}]
    assert TTrace.chrome_trace(jev, spans, msgs, tick_us=500.0) == JTrace.chrome_trace(
        jev, spans, msgs, tick_us=500.0)
    assert TTrace.chrome_trace() == JTrace.chrome_trace()


def test_trace_scope():
    """A profiler scope when torch is imported (it is, here); it records
    under ``torch.profiler`` on the CPU."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with TProf.trace_scope("chunk_dispatch"):
            torch.ones(4).sum()
    assert any(e.name == "chunk_dispatch" for e in prof.events())


def test_telemetry_rung_matches_reference(tmp_path):
    """``bench.py --telemetry`` at n=256: the port's rows (the run's counter
    totals and the first-suspect / first-dead histograms) and its
    Prometheus snapshot equal the reference's, wall-clock and build keys
    aside."""
    import json

    import bench as jbench
    from scalecube_cluster_tpu_torch.bench import telemetry
    from scalecube_cluster_tpu_torch.testlib.serving import row_values

    jout, tout = str(tmp_path / "j.jsonl"), str(tmp_path / "t.jsonl")
    jbench._telemetry(256, out=jout)
    res = telemetry(256, tout, device="cpu")
    jrows = [json.loads(line) for line in open(jout)]
    trows = [json.loads(line) for line in open(tout)]
    assert trows == [json.loads(json.dumps(r)) for r in res["rows"]]
    assert [r["kind"] for r in jrows] == [r["kind"] for r in trows] == [
        "counters", "latency_histogram", "latency_histogram"]
    for a, b in zip(jrows, trows):
        assert row_values(a) == row_values(b), a["kind"]
    assert trows[0]["n_ticks"] == 240 and trows[0]["verdicts_dead"] > 0
    prom = open(tout + ".prom").read()
    assert prom == TExp.prometheus_text(trows)
