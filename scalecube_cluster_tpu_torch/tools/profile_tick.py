"""Where a dense tick's time goes on the card
(port of scalecube_cluster_tpu/tools/profile_tick.py).

Each piece runs ``iters`` iterations fed back into themselves (the
piece's output is its next input), once to warm up and then ``calls``
times, timed with CUDA events (with the host clock when the caller asks
for the CPU); the best call is reported per iteration.
The pieces and their names are the JAX tool's: the full tick with the
fused core on and off (``pallas_delivery``), the pre-mask, the fused
delivery-merge kernel (``ops/delivery_merge.py``), the plain delivery +
merge, an approximate post-chain, the FD selection and an elementwise
copy-add, on the JAX tool's state: ``init_full_view(n)``, a dense 5%-loss
plan, seeds [0, 1], key 0.

Run on a CUDA card: ``python -m scalecube_cluster_tpu_torch.tools.profile_tick [n]``
(default n=10240) prints one line per piece.
"""

from __future__ import annotations

import dataclasses
import sys
import time

import torch

from scalecube_cluster_tpu_torch import prng
from scalecube_cluster_tpu_torch.ops.delivery import (
    fanout_permutations_structured,
    permuted_delivery_two_channel,
)
from scalecube_cluster_tpu_torch.ops.delivery_merge import delivery_merge
from scalecube_cluster_tpu_torch.ops.merge import is_alive_key, merge_views
from scalecube_cluster_tpu_torch.ops.select import masked_random_choice, masked_random_topk
from scalecube_cluster_tpu_torch.sim.faults import FaultPlan
from scalecube_cluster_tpu_torch.sim.params import SimParams
from scalecube_cluster_tpu_torch.sim.run import run_ticks
from scalecube_cluster_tpu_torch.sim.state import init_full_view, seeds_mask

ITERS = 20
CALLS = 5


def _elapsed_ms(run, carry, device):
    """``run(carry)`` and its time in ms: CUDA events on the card, the
    host clock on the CPU."""
    if device == "cpu":
        t0 = time.perf_counter()
        carry = run(carry)
        return carry, (time.perf_counter() - t0) * 1e3
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    carry = run(carry)
    stop.record()
    torch.cuda.synchronize()
    return carry, start.elapsed_time(stop)


def timed(name, fn, init, iters, calls, out, device="cuda"):
    """Best of ``calls`` runs of ``iters`` fed-back iterations of ``fn``
    after one warm-up run, in ms per iteration; printed and stored in
    ``out[name]``."""

    def run(carry):
        for _ in range(iters):
            carry = fn(carry)
        return carry

    carry, _ = _elapsed_ms(run, init, device)
    best = float("inf")
    for _ in range(calls):
        carry, ms = _elapsed_ms(run, carry, device)
        best = min(best, ms)
    out[name] = best / iters
    print(f"{name:44s} {best / iters:10.4f} ms/iter", flush=True)


def main(n: int = 10240, iters: int = ITERS, calls: int = CALLS, device="cuda") -> dict:
    """Time every piece at ``n`` members on ``device``; returns ``{piece:
    ms/iter}``."""
    dev = str(device)
    if dev == "cpu":
        print("device: cpu", file=sys.stderr)
    elif not torch.cuda.is_available():
        raise RuntimeError("profile_tick: no CUDA device; the profile needs the card")
    else:
        print("device:", torch.cuda.get_device_name(0), file=sys.stderr)
    params = SimParams.from_cluster_config(n)
    state = init_full_view(n, device=dev)
    plan = dataclasses.replace(
        FaultPlan.clean(n, device=dev),
        loss=torch.full((n, n), 5.0 / 100.0, dtype=torch.float32, device=dev),
    )
    seeds = seeds_mask(n, [0, 1], device=dev)
    key = prng.PRNGKey(0)
    out: dict = {}

    for pal in (True, False):
        p = dataclasses.replace(params, pallas_delivery=pal)
        timed(
            f"full tick (pallas={pal})",
            lambda s, p=p: run_ticks(p, s, plan, seeds, 1, collect=False)[0],
            state, iters, calls, out, dev,
        )

    view = state.view
    age = state.rumor_age
    inv, ginv, rots = fanout_permutations_structured(key, n, params.gossip_fanout, dev)
    edge_ok = torch.ones((params.gossip_fanout, n), dtype=torch.bool, device=dev)
    alive = state.alive
    rows = torch.where(age < params.periods_to_spread, view, -1)
    diag = torch.eye(n, dtype=torch.bool, device=dev)

    timed(
        "pre-mask: fd where + age0 + rows",
        lambda v: torch.where(
            torch.where(age < 90, 0, age) < params.periods_to_spread, v, -1
        ),
        view, iters, calls, out, dev,
    )
    timed(
        "pallas delivery+merge kernel",
        lambda v: delivery_merge(rows, v, ginv, rots, edge_ok, alive)[0],
        view, iters, calls, out, dev,
    )

    def plain_dm(v):
        ba, bal = permuted_delivery_two_channel(rows, is_alive_key, inv, edge_ok)
        m, _ = merge_views(v, torch.where(diag, -1, ba), torch.where(diag, -1, bal))
        return m

    timed("XLA delivery+merge", plain_dm, view, iters, calls, out, dev)

    def post(v):
        armed = torch.zeros((n, n), dtype=torch.bool, device=dev)
        rearm = v != view
        left0 = torch.zeros((n, n), dtype=torch.int32, device=dev)
        expired = armed & ~rearm & (left0 == 0) & ((v & (1 << 21)) == 0)
        v2 = torch.where(expired, v | 4, v)
        ra = torch.where(rearm, 0, torch.clamp_max(age, 110) + 1)
        tomb = ~diag & ((v2 & (1 << 21)) != 0) & (ra > 38)
        return torch.where(tomb, -1, v2) + ra.to(torch.int32) * 0

    timed("post-chain (approx)", post, view, iters, calls, out, dev)

    def fd_select(v):
        cand = (v >= 0) & ~diag
        tgt, _ = masked_random_choice(key, cand)
        ridx, _ = masked_random_topk(key, cand, params.ping_req_members)
        return v + tgt[:, None] * 0 + ridx.sum() * 0

    timed("fd selection (choice+topk) [per fd tick]", fd_select, view, iters, calls, out, dev)
    timed("elementwise copy-add", lambda v: v + 1, view, iters, calls, out, dev)
    return out


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 10240)
