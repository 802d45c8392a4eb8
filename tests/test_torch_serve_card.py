"""Card twins of the serving parity tests: each scenario of
``testlib/serving.py`` through a ServeBridge on the card against the same
session on the CPU — every state leaf, every launch's traces, the export
rows (wall-clock readings aside), the live row and the counters equal; the
fused-core sessions launch ``csrc/sparse_core.cu`` on every tick, and each
replay equals its offline FaultSchedule run on the card. Tests marked
``cuda`` need a card and skip without one; this file imports no jax, so it
runs on a machine without it, as ``python -m pytest --noconftest -m cuda
tests/test_torch_serve_card.py``.
"""

import numpy as np
import pytest
import torch

from scalecube_cluster_tpu_torch.ops.sparse_core import sparse_core
from scalecube_cluster_tpu_torch.testing import one_cpu_thread
from scalecube_cluster_tpu_torch.testlib import serving as SV

one_cpu_thread()

REPLAYS = ("clean", "kill-restart", "gossip", "knobbed", "elastic", "elastic-ticked", "rapid")


def _same(a: dict, b: dict, where):
    assert set(a) == set(b), (where, sorted(set(a) ^ set(b)))
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, (where, k)
        bits = [np.ascontiguousarray(v).reshape(-1).view(np.uint8) for v in (x, y)]
        assert np.array_equal(*bits), (where, k)


@pytest.mark.cuda
@pytest.mark.parametrize("name", REPLAYS)
def test_serve_card_matches_cpu(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    sc = SV.scenario(name)
    launches0 = sparse_core.launches
    card = SV.serve_replay(name, "cuda")
    launched = sparse_core.launches - launches0
    cpu = SV.serve_replay(name, "cpu")
    _same(card["state"], cpu["state"], (name, "state"))
    assert len(card["traces"]) == len(cpu["traces"])
    for i, (a, b) in enumerate(zip(card["traces"], cpu["traces"])):
        _same(a, b, (name, "launch", i))
    assert [SV.row_values(r) for r in card["rows"]] == [SV.row_values(r) for r in cpu["rows"]]
    assert SV.row_values(card["live"]) == SV.row_values(cpu["live"])
    assert card["counters"] == cpu["counters"]
    ticks = sum(len(t["tick"]) for t in card["traces"])
    assert launched == (ticks if sc.get("pallas_core") else 0), (name, launched, ticks)
    if sc["fired"] is not None:
        off = SV.offline_run(name, "cuda")
        _same(off["state"], card["state"], (name, "offline"))
