"""Card twins of the fleet parity tests: each scenario of
``testlib/fleet.py`` at the card's sizes through a FleetBridge on the card
against the same session on the CPU — every universe of every pool, every
round's traces, the export rows (wall-clock readings aside), the counters
and the placements equal — and each checked tenant equal to its solo replay
on the card. The kernel-route pools launch ``csrc/sparse_core.cu`` once per
tick group a tick, as many times as the CPU run calls the core. Tests
marked ``cuda`` need a card and skip without one; this file imports no
jax, so it runs on a machine without it, as ``python -m pytest
--noconftest -m cuda tests/test_torch_fleet_card.py``.
"""

import numpy as np
import pytest
import torch

from scalecube_cluster_tpu_torch.ops.sparse_core import sparse_core
from scalecube_cluster_tpu_torch.sim import ensemble_tick as ET
from scalecube_cluster_tpu_torch.testing import one_cpu_thread
from scalecube_cluster_tpu_torch.testlib import fleet as FL

one_cpu_thread()

#: The scenarios at the card's sizes: the kernel route at n=1024, S=256 and
#: B=4 (with an eviction and a tenant placed at tick 0), the elastic pool on
#: the kernel route with its promotion to 2048 rows, Rapid at n=64, B=4.
CARD_SIZES = {
    "kernel": {"n": 1024, "s": 256, "fleet_size": 4},
    "sparse": {"n": 256, "s": 128, "pallas_core": True, "in_scan_writeback": False},
    "elastic": {"n": 1024, "s": 256, "pallas_core": True, "in_scan_writeback": False},
    "rapid": {"n": 64, "fleet_size": 4},
}


def _same(a: dict, b: dict, where):
    assert set(a) == set(b), (where, sorted(set(a) ^ set(b)))
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, (where, k)
        bits = [np.ascontiguousarray(v).reshape(-1).view(np.uint8) for v in (x, y)]
        assert np.array_equal(*bits), (where, k)


def _cpu_core_calls(name, sizes, monkeypatch) -> tuple[dict, int]:
    """The CPU run and the number of core calls it routes to the kernel."""
    calls = [0]
    core = ET.sparse_core

    def counted(*a, **kw):
        calls[0] += 1
        return core(*a, **kw)

    monkeypatch.setattr(ET, "sparse_core", counted)
    cpu = FL.fleet_replay(name, "cpu", **sizes)
    monkeypatch.setattr(ET, "sparse_core", core)
    return cpu, calls[0]


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CARD_SIZES))
def test_fleet_card_matches_cpu(name, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    sizes = CARD_SIZES[name]
    cpu, calls = _cpu_core_calls(name, sizes, monkeypatch)
    launches0 = sparse_core.launches
    card = FL.fleet_replay(name, "cuda", **sizes)
    launched = sparse_core.launches - launches0
    assert card["placement"] == cpu["placement"] and card["ledger"] == cpu["ledger"]
    for n in cpu["pools"]:
        for b, (x, y) in enumerate(zip(card["pools"][n], cpu["pools"][n])):
            _same(x, y, (name, n, b))
    for i, (x, y) in enumerate(zip(card["traces"], cpu["traces"])):
        for j, (a, c) in enumerate(zip(x, y)):
            _same(a, c, (name, i, j))
    assert [FL.fleet_row_values(r) for r in card["rows"]] == [
        FL.fleet_row_values(r) for r in cpu["rows"]]
    assert card["counters"] == cpu["counters"]
    assert launched == calls
    if sizes.get("pallas_core", FL.FLEET_SCENARIOS[name].get("pallas_core")):
        assert launched > 0


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CARD_SIZES))
def test_fleet_card_tenants_equal_solo(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    sizes = CARD_SIZES[name]
    card = FL.fleet_replay(name, "cuda", **sizes)
    for tid in FL.FLEET_SCENARIOS[name]["solo"]:
        _same(FL.solo_replay(name, tid, "cuda", **sizes), FL.universe_of(card, tid),
              (name, tid))
