"""Per-run protocol knobs: scalars passed as data instead of static params
(port of scalecube_cluster_tpu/sim/knobs.py).

Identity knobs reproduce the knob-free tick bit for bit:

- ``suspicion_mult`` (f32, identity 1.0) scales ``suspicion_ticks`` wherever
  a tick arms a suspicion countdown;
- ``fanout_cap`` (i32, identity ``gossip_fanout``) masks gossip fan-out
  channels ``c >= cap`` out of existence: a capped channel delivers,
  attempts and counts nothing.

Knobs run on the unfused tick paths only: the fused cores (CUDA kernels
here, Pallas kernels in the reference) take the suspicion timeout as a
constant, so the ticks refuse knobs with ``pallas_delivery`` (dense) or
``pallas_core`` (sparse).
"""

from __future__ import annotations

import dataclasses

import torch

from scalecube_cluster_tpu_torch.sim.params import SimParams

#: Countdowns are int16: a scaled timeout must stay representable.
_SUSP_MAX = (1 << 15) - 1


@dataclasses.dataclass(frozen=True)
class Knobs:
    """Per-run protocol scalars (see the module docstring)."""

    suspicion_mult: torch.Tensor  # f32 scalar
    fanout_cap: torch.Tensor  # i32 scalar


def make_knobs(
    params: SimParams,
    suspicion_mult: float = 1.0,
    fanout_cap: int | None = None,
    device="cuda",
) -> Knobs:
    """One run's knob point; the defaults are the identity."""
    cap = params.gossip_fanout if fanout_cap is None else fanout_cap
    if not isinstance(cap, torch.Tensor):
        cap = int(cap)
        if not 0 <= cap <= params.gossip_fanout:
            raise ValueError(
                f"fanout_cap {cap} outside [0, {params.gossip_fanout}] — the "
                "static params.gossip_fanout is the lattice maximum"
            )
    return Knobs(
        suspicion_mult=torch.as_tensor(suspicion_mult, dtype=torch.float32).to(device),
        fanout_cap=torch.as_tensor(cap, dtype=torch.int32).to(device),
    )


def suspicion_fill(suspicion_ticks: int, knobs: Knobs | None):
    """The countdown armed on a fresh SUSPECT record: the constant without
    knobs, else ``round(ticks * mult)`` clipped to [1, 32767] (a 0-d int32
    tensor; ``[B]`` for an ensemble's stacked knobs)."""
    if knobs is None:
        return suspicion_ticks
    scaled = torch.round(suspicion_ticks * knobs.suspicion_mult).to(torch.int32)
    return torch.clamp(scaled, 1, _SUSP_MAX)


def edge_live(gossip_fanout: int, knobs: Knobs | None):
    """``[fanout]`` bool mask of live gossip channels (None without knobs);
    ``[B, fanout]`` for an ensemble's stacked knobs."""
    if knobs is None:
        return None
    dev = knobs.fanout_cap.device
    chans = torch.arange(gossip_fanout, dtype=torch.int32, device=dev)
    return chans < knobs.fanout_cap[..., None]
