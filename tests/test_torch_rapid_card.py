"""Card twins of the Rapid tests: the port's Rapid engine on the card
against the same runs on the CPU — a solo run with the fallback, the
flight recorder and a protocol join through the split-vote schedule, and a
B=2 ensemble with the fallback. Every state leaf, fallback leaf, ring field
and trace equal. Tests marked ``cuda`` need a card and skip without one;
this file imports no jax, so it runs on a machine without it, as
``python -m pytest --noconftest -m cuda tests/test_torch_rapid_card.py``.
"""

import numpy as np
import pytest
import torch

from scalecube_cluster_tpu_torch.sim import ensemble as TE
from scalecube_cluster_tpu_torch.sim import rapid as TR
from scalecube_cluster_tpu_torch.sim.convert import rapid_state_to_numpy
from scalecube_cluster_tpu_torch.sim.faults import FaultPlan
from scalecube_cluster_tpu_torch.sim.schedule import ScheduleBuilder
from scalecube_cluster_tpu_torch.testing import one_cpu_thread

one_cpu_thread()

N, TICKS, CHUNK = 16, 60, 20


def _split_vote(device):
    """tests/test_rapid_fallback.py::_split_vote_schedule(with_join=True)."""
    blk = torch.zeros((N, N), dtype=torch.bool, device=device)
    blk[9:16, 1:8] = True
    return (
        ScheduleBuilder(N)
        .add_segment(1, FaultPlan.clean(N, device=device))
        .add_segment(15, FaultPlan.uniform(device=device).replace(block=blk))
        .add_segment(17, FaultPlan.clean(N, device=device))
        .kill(10, 0).kill(10, 8).join(40, 8)
        .build()
    )


def _flat(state) -> dict:
    flat = rapid_state_to_numpy(state)
    for sub in ("fb", "trace"):
        for k, v in flat.pop(sub, {}).items():
            flat[f"{sub}.{k}"] = v
    return flat


def _run(device, ensemble: bool):
    params = TR.RapidParams(n=N)
    if ensemble:
        st = TR.init_ensemble_rapid(params, [7, 11], fallback=True, device=device)
        plan = TE.stack_universes([_split_vote(device), _split_vote(device)])
        run = TR.run_ensemble_rapid_ticks
    else:
        st = TR.init_rapid_full_view(params, seed=7, trace_capacity=4096, fallback=True,
                                     device=device)
        plan = _split_vote(device)
        run = TR.run_rapid_ticks
    out = []
    for _ in range(TICKS // CHUNK):
        st, tr = run(params, st, plan, CHUNK)
        out.append((_flat(st), {k: v.cpu().numpy() for k, v in tr.items()}))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("ensemble", [False, True], ids=["solo", "ensemble-B2"])
def test_rapid_card_matches_cpu(ensemble):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    card = _run("cuda", ensemble)
    cpu = _run("cpu", ensemble)
    for c, ((a, ta), (b, tb)) in enumerate(zip(card, cpu)):
        assert set(a) == set(b) and set(ta) == set(tb), c
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), (c, k)
        for k in ta:
            assert np.array_equal(ta[k].view(np.uint8), tb[k].view(np.uint8)), (c, k)
    # The split vote commits through the classic rounds and re-admits 8.
    fb_commits = sum(int(t["fallback_commits"].sum()) for _, t in card)
    assert fb_commits > 0
