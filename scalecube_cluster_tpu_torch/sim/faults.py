"""Network-fault plan — NetworkEmulator in tensor form
(port of scalecube_cluster_tpu/sim/faults.py, flat worlds only).

Per directed link i→j (NetworkEmulator.java:25-411):

- ``block[i, j]``      — hard block of link i→j,
- ``loss[i, j]``       — probability a message on i→j is dropped,
- ``mean_delay[i, j]`` — mean of the exponential per-message delay in ms.

A ``[1, 1]`` matrix is the compact "same setting on every link" layout
(lookups clamp indices into range). The FD probe is the only deadline-bearing
exchange; it draws ONE in-time sample per probe path from the Erlang tail of
the summed leg delays (:func:`round_trip_in_time_from`). The reference's
zone overlay (``link_world``) is not ported: every plan here is a flat world.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from scalecube_cluster_tpu_torch import prng


@dataclass
class FaultPlan:
    """Per-directed-link fault settings over an N-member cluster."""

    block: torch.Tensor  # [N, N] (or [1, 1]) bool
    loss: torch.Tensor  # [N, N] (or [1, 1]) float32 in [0, 1)
    mean_delay: torch.Tensor  # [N, N] (or [1, 1]) float32 ms (0 = no delay)

    @classmethod
    def clean(cls, n: int, device="cuda") -> "FaultPlan":
        """No faults, dense per-link form."""
        return cls(
            block=torch.zeros((n, n), dtype=torch.bool, device=device),
            loss=torch.zeros((n, n), dtype=torch.float32, device=device),
            mean_delay=torch.zeros((n, n), dtype=torch.float32, device=device),
        )

    @classmethod
    def uniform(
        cls, loss_percent: float = 0.0, mean_delay_ms: float = 0.0, device="cuda"
    ) -> "FaultPlan":
        """Compact whole-cluster plan: the same loss/delay on every link, no
        blocks. O(1) memory — the benchmark form."""
        return cls(
            block=torch.zeros((1, 1), dtype=torch.bool, device=device),
            loss=torch.full(
                (1, 1), loss_percent / 100.0, dtype=torch.float32, device=device
            ),
            mean_delay=torch.full(
                (1, 1), mean_delay_ms, dtype=torch.float32, device=device
            ),
        )


def _edge_lookup(mat: torch.Tensor, src: torch.Tensor, dst: torch.Tensor):
    """``mat[src, dst]`` honoring the compact [1, 1] layout."""
    s = torch.clamp_max(src, mat.shape[0] - 1).long()
    d = torch.clamp_max(dst, mat.shape[1] - 1).long()
    return mat[s, d]


def edge_blocked(plan: FaultPlan, src, dst) -> torch.Tensor:
    """Per-edge hard-block predicate."""
    return _edge_lookup(plan.block, src, dst)


def edge_loss(plan: FaultPlan, src, dst) -> torch.Tensor:
    """Per-edge drop probability."""
    return _edge_lookup(plan.loss, src, dst)


def edge_mean_delay(plan: FaultPlan, src, dst) -> torch.Tensor:
    """Per-edge mean exponential delay (ms)."""
    return _edge_lookup(plan.mean_delay, src, dst)


def link_pass_from(u: torch.Tensor, plan: FaultPlan, src, dst) -> torch.Tensor:
    """A message passes iff its link is unblocked and the caller's uniform
    draw ``u`` survives the loss (OutboundSettings.evaluateLoss)."""
    return ~edge_blocked(plan, src, dst) & (u >= edge_loss(plan, src, dst))


def link_pass(key, plan: FaultPlan, src, dst) -> torch.Tensor:
    """Sample delivery for directed links ``src → dst`` (broadcast index
    tensors): one uniform per edge from ``key``, then :func:`link_pass_from`."""
    shape = torch.broadcast_shapes(src.shape, dst.shape)
    return link_pass_from(prng.uniform(key, tuple(shape), src.device), plan, src, dst)


def link_delay_within_tick(key, plan: FaultPlan, src, dst, tick_ms) -> torch.Tensor:
    """Sample "an exponential link delay elapses within one tick" per edge:
    ``P = 1 - exp(-tick_ms / mean)``, always True on a delay-free link.
    Memoryless, so re-drawing it each tick for a message still in flight
    bins the arrival to tick granularity exactly (the dense engine's
    delayed user gossip)."""
    mean = edge_mean_delay(plan, src, dst)
    p = torch.where(
        mean > 0, 1.0 - torch.exp(-tick_ms / torch.clamp_min(mean, 1e-9)), 1.0
    )
    return prng.uniform(key, tuple(mean.shape), mean.device) < p


def round_trip_in_time(key, plan: FaultPlan, legs, deadline_ms) -> torch.Tensor:
    """:func:`round_trip_in_time_from` with one uniform per probe path
    drawn from ``key`` at the legs' broadcast shape."""
    shape = torch.broadcast_shapes(
        *(torch.broadcast_shapes(s.shape, d.shape) for s, d in legs)
    )
    u = prng.uniform(key, tuple(shape), legs[0][0].device)
    return round_trip_in_time_from(u, plan, legs, deadline_ms)


def round_trip_in_time_from(u: torch.Tensor, plan: FaultPlan, legs, deadline_ms):
    """One in-time draw per probe path: the summed exponential delays of
    ``legs`` (``(src, dst)`` pairs) must beat ``deadline_ms``. Erlang(k)
    with the mean of the leg means:

        P(miss) = e^(-x) * sum_{i<k} x^i / i!,   x = deadline / theta.
    """
    k = len(legs)
    mean_total = sum(edge_mean_delay(plan, s, d) for s, d in legs)
    theta = mean_total / k
    has_delay = theta > 0
    x = deadline_ms / torch.where(has_delay, theta, 1.0)
    term = torch.ones_like(x)
    acc = torch.ones_like(x)
    for i in range(1, k):
        term = term * x / i
        acc = acc + term
    p_miss = torch.where(has_delay, torch.exp(-x) * acc, 0.0)
    return u >= p_miss
