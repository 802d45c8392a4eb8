"""Checkpoints that cross packages: the port's ``sim/checkpoint.py`` against
the JAX package's.

An archive written by either package loads in the other, and written
again by the loader it is the same archive: identical key sets, every
array equal with its dtype, and the params JSON equal byte for byte. Each
direction runs for the dense engine, the sparse engine (plain and with the
cold lane packed) and an in-memory ``BytesIO`` archive; the loaded state
equals the writer's leaf for leaf, and params that go JAX → port → JAX
come back equal. A port run resumed from a JAX mid-run packed checkpoint
equals, over 12 ticks, the JAX run continued from its in-memory state
(not from the JAX package's own packed load). Tolerance: none.
"""

import dataclasses
import io

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from scalecube_cluster_tpu.sim import checkpoint as JC
from scalecube_cluster_tpu.sim import run as JR
from scalecube_cluster_tpu.sim import sparse as J
from scalecube_cluster_tpu.sim import state as JS
from scalecube_cluster_tpu.sim.faults import FaultPlan as JPlan
from scalecube_cluster_tpu_torch.sim import checkpoint as TC
from scalecube_cluster_tpu_torch.sim import run as TR
from scalecube_cluster_tpu_torch.sim import sparse as T
from scalecube_cluster_tpu_torch.sim import state as TS
from scalecube_cluster_tpu_torch.sim.convert import dense_state_to_numpy
from scalecube_cluster_tpu_torch.sim.faults import FaultPlan as TPlan
from scalecube_cluster_tpu_torch.sim.params import SimParams as TSimParams
from tests.test_sim import small_params
from tests.test_torch_sparse import (
    assert_same_state,
    assert_same_traces,
    jax_state_dict,
    port_params,
)
from tests.test_sparse import sparse_params
from scalecube_cluster_tpu_torch.testing import one_cpu_thread, shared_result
from tests.test_torch_dense import jax_state_dict as dense_dict

one_cpu_thread()

N, S = 64, 128


def read_archive(target):
    if hasattr(target, "seek"):
        target.seek(0)
    with np.load(target) as data:
        return {k: np.array(data[k]) for k in data.files}


def assert_same_archive(a, b):
    assert set(a) == set(b), set(a) ^ set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


def _dense_jax():
    jp = small_params(N, suspicion_ticks=12)

    def compute():
        js = JS.kill(JS.init_full_view(N), 5)
        js, _ = JR.run_ticks(jp, js, JPlan.uniform(10.0), JS.seeds_mask(N, [0, 1]), 9,
                             collect=False)
        return dense_dict(js)

    d = shared_result("test_torch_checkpoint._dense_jax", compute)
    return JS.SimState(**{k: jnp.asarray(v) for k, v in d.items()}), jp


def _dense_port():
    tp = TSimParams(**dataclasses.asdict(small_params(N, suspicion_ticks=12)))
    ts = TS.kill(TS.init_full_view(N, device="cpu"), 5)
    ts, _ = TR.run_ticks(tp, ts, TPlan.uniform(10.0, device="cpu"),
                         TS.seeds_mask(N, [0, 1], device="cpu"), 9, collect=False)
    return ts, tp


def _sparse_jax():
    jp = dataclasses.replace(sparse_params(N, suspicion_ticks=12), slot_budget=S,
                             in_scan_writeback=False)

    def compute():
        js = J.kill_sparse(J.init_sparse_full_view(N, S, record_latency=True), 5)
        js, _ = J.run_sparse_chunked(jp, js, JPlan.uniform(10.0), 18, chunk=9)
        return jax_state_dict(js)

    d = shared_result("test_torch_checkpoint._sparse_jax", compute)
    js = J.SparseState(**{k: jnp.asarray(v) for k, v in d.items()})
    # Switches the port carries unread, set away from their defaults.
    return js, dataclasses.replace(
        jp, pallas_core=True, pallas_fold=frozenset({"countdown", "wb_mask"})
    )


def _sparse_port():
    tp = port_params(sparse_params(N, suspicion_ticks=12))
    tp = dataclasses.replace(tp, slot_budget=S, in_scan_writeback=False)
    ts = T.kill_sparse(T.init_sparse_full_view(N, S, record_latency=True, device="cpu"), 5)
    ts, _ = T.run_sparse_chunked(tp, ts, TPlan.uniform(10.0, device="cpu"), 18, chunk=9)
    return ts, tp


#: kind → (engine, pack_cold, in memory)
KINDS = {
    "dense": ("dense", False, False),
    "sparse": ("sparse", False, False),
    "sparse-packed": ("sparse", True, False),
    "sparse-packed-bytesio": ("sparse", True, True),
}


def _target(tmp_path, name, in_memory):
    return io.BytesIO() if in_memory else tmp_path / name


@pytest.mark.parametrize("kind", list(KINDS))
def test_jax_archive_loads_in_port_and_back(kind, tmp_path):
    """JAX writes, the port loads and writes again: the same archive; the
    port's state equals the JAX state; JAX loads the port's archive to
    equal params and leaves."""
    engine, packed, in_memory = KINDS[kind]
    a, b = _target(tmp_path, "a", in_memory), _target(tmp_path, "b.npz", in_memory)
    if engine == "dense":
        js, jp = _dense_jax()
        JC.save_checkpoint(a, js, jp)
        ts, tp = TC.load_checkpoint(a, device="cpu")
        TC.save_checkpoint(b, ts, tp)
        back_s, back_p = JC.load_checkpoint(b)
        jd, td = jax_state_dict(js), dense_state_to_numpy(ts)
        assert set(jd) == set(td) and all(np.array_equal(jd[k], td[k]) for k in jd)
        assert ts.t_host == int(jd["tick"])
        a_read = read_archive(tmp_path / "a.npz")
    else:
        js, jp = _sparse_jax()
        JC.save_sparse_checkpoint(a, js, jp, pack_cold=packed)
        if in_memory:
            a.seek(0)
        ts, tp = TC.load_sparse_checkpoint(a, device="cpu")
        TC.save_sparse_checkpoint(b, ts, tp, pack_cold=packed)
        if in_memory:
            b.seek(0)
        back_s, back_p = JC.load_sparse_checkpoint(b)
        assert_same_state(js, ts, kind)
        assert tp.pallas_fold == jp.pallas_fold and tp.pallas_core
        a_read = read_archive(a if in_memory else tmp_path / "a.npz")
    assert ts.device == torch.device("cpu")
    assert_same_archive(a_read, read_archive(b))
    assert back_p == jp
    assert_same_archive(jax_state_dict(js), jax_state_dict(back_s))


@pytest.mark.parametrize("kind", list(KINDS))
def test_port_archive_loads_in_jax_and_back(kind, tmp_path):
    """The port writes, JAX loads and writes again: the same archive; the
    JAX state equals the port's; the port loads JAX's archive to equal
    params and leaves."""
    engine, packed, in_memory = KINDS[kind]
    a, b = _target(tmp_path, "a.npz", in_memory), _target(tmp_path, "b.npz", in_memory)
    if engine == "dense":
        ts, tp = _dense_port()
        TC.save_checkpoint(a, ts, tp)
        js, jp = JC.load_checkpoint(a)
        JC.save_checkpoint(b, js, jp)
        back_s, back_p = TC.load_checkpoint(b, device="cpu")
        jd, td = jax_state_dict(js), dense_state_to_numpy(ts)
        assert set(jd) == set(td) and all(np.array_equal(jd[k], td[k]) for k in jd)
        assert dense_state_to_numpy(back_s).keys() == td.keys()
        assert all(np.array_equal(dense_state_to_numpy(back_s)[k], td[k]) for k in td)
    else:
        ts, tp = _sparse_port()
        TC.save_sparse_checkpoint(a, ts, tp, pack_cold=packed)
        if in_memory:
            a.seek(0)
        js, jp = JC.load_sparse_checkpoint(a)
        JC.save_sparse_checkpoint(b, js, jp, pack_cold=packed)
        if in_memory:
            b.seek(0)
        back_s, back_p = TC.load_sparse_checkpoint(b, device="cpu")
        assert_same_state(js, ts, kind)
        assert_same_state(js, back_s, kind)
        assert jp.pallas_fold == tp.pallas_fold and jp.pallas_core == tp.pallas_core
    assert_same_archive(read_archive(a), read_archive(b))
    assert back_p == tp


def test_pack_cold_refuses_out_of_range_countdowns(tmp_path):
    """A countdown above COLD_SUSP_MAX cannot be packed: both packages raise
    the same error, and nothing is written."""
    ts, tp = _sparse_port()
    ts.susp[3, 4] = 400
    with pytest.raises(ValueError, match="pack_cold needs susp <= 127"):
        TC.save_sparse_checkpoint(tmp_path / "x", ts, tp, pack_cold=True)
    assert not (tmp_path / "x.npz").exists()
    js, jp = _sparse_jax()
    js = js.replace(susp=js.susp.at[3, 4].set(400))
    with pytest.raises(ValueError, match="pack_cold needs susp <= 127"):
        JC.save_sparse_checkpoint(tmp_path / "y", js, jp, pack_cold=True)


def test_elastic_archive_is_refused(tmp_path):
    """An archive holding ``live_mask`` (an elastic state), which the port
    refused before elastic states were ported, now loads with its
    ``live_mask`` and, written again by the port, is the same archive."""
    js, jp = _sparse_jax()
    live = np.arange(N) < N - 8
    js = js.replace(live_mask=jnp.asarray(live))
    JC.save_sparse_checkpoint(tmp_path / "e", js, jp)
    ts, tp = TC.load_sparse_checkpoint(tmp_path / "e", device="cpu")
    assert np.array_equal(ts.live_mask.numpy(), live)
    TC.save_sparse_checkpoint(tmp_path / "p", ts, tp)
    assert_same_archive(read_archive(tmp_path / "e.npz"), read_archive(tmp_path / "p.npz"))


@pytest.mark.parametrize(
    "fold, match",
    [({"countdown", "swept"}, "unknown pallas_fold pieces"),
     ({"wb_mask"}, "require 'countdown'"),
     ({"points", "view_rows"}, "require 'countdown'")],
)
def test_sparse_params_refuse_the_folds_jax_refuses(fold, match):
    """The fold the port's params carry as metadata is held to the
    reference's rules: both packages refuse the same folds."""
    jp = sparse_params(N)
    with pytest.raises(ValueError, match=match):
        dataclasses.replace(jp, pallas_fold=frozenset(fold))
    with pytest.raises(ValueError, match=match):
        dataclasses.replace(port_params(jp), pallas_fold=frozenset(fold))


def test_dense_archive_is_not_sparse(tmp_path):
    """Each loader refuses the other engine's archive, as the reference's do."""
    ts, tp = _dense_port()
    TC.save_checkpoint(tmp_path / "d", ts, tp)
    with pytest.raises(ValueError, match="not a sparse-engine checkpoint"):
        TC.load_sparse_checkpoint(tmp_path / "d", device="cpu")
    ss, sp = _sparse_port()
    TC.save_sparse_checkpoint(tmp_path / "s", ss, sp)
    with pytest.raises(ValueError, match="use load_sparse_checkpoint"):
        TC.load_checkpoint(tmp_path / "s", device="cpu")


def test_port_resumes_jax_packed_checkpoint():
    """JAX runs 24 ticks (its fused core with the whole fold, as the port
    runs; a kill, FD every 2, suspicion 12, 10% loss) and writes a packed archive to memory; the port loads it and runs 12 more
    ticks, chunk by chunk, against the JAX run continued from its
    in-memory state: every leaf and every counter equal."""
    n, s = 256, 128
    jp = dataclasses.replace(sparse_params(n, suspicion_ticks=12), slot_budget=s,
                             in_scan_writeback=False, pallas_core=True)
    js = J.kill_sparse(J.init_sparse_full_view(n, s, record_latency=True), 5)
    # 6-tick chunks throughout: the reference compiles one scan for the run.
    js, _ = J.run_sparse_chunked(jp, js, JPlan.uniform(10.0), 24, chunk=6)
    buf = io.BytesIO()
    JC.save_sparse_checkpoint(buf, js, jp, pack_cold=True)
    buf.seek(0)
    ts, tp = TC.load_sparse_checkpoint(buf, device="cpu")
    assert ts.t_host == 24 and int(ts.susp.max()) > 0
    tplan = TPlan.uniform(10.0, device="cpu")
    for c in range(2):
        js, jtr = J.run_sparse_chunked(jp, js, JPlan.uniform(10.0), 6, chunk=6, collect=True)
        ts, ttr = T.run_sparse_chunked(tp, ts, tplan, 6, chunk=6, collect=True)
        assert_same_state(js, ts, f"resumed chunk {c}")
        assert_same_traces(jtr, ttr, f"resumed chunk {c}")
