"""Introspection over an engine state — the array engine's JMX equivalent
(port of scalecube_cluster_tpu/sim/monitor.py).

The reference exposes per-node MBeans: cluster-level member/metadata views
(ClusterImpl.java:434-469) and membership internals — incarnation, alive and
suspected member lists (MembershipProtocolImpl.java:720-791). This module is
that surface over the batched sim: answers come from the state tensors,
either for one node (``node_view``) or the whole cluster
(``cluster_summary`` for the dense engine, ``sparse_summary`` for the
sparse one). Each reduces on the state's device and reads back to the host
only at its end.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from scalecube_cluster_tpu_torch.cluster_api.member import MemberStatus
from scalecube_cluster_tpu_torch.ops.merge import (
    decode_epoch,
    decode_incarnation,
    decode_status,
)
from scalecube_cluster_tpu_torch.sim.state import SimState


@dataclass(frozen=True)
class NodeView:
    """One node's membership introspection (MembershipMonitorMBean analog)."""

    node: int
    incarnation: int
    epoch: int
    alive_members: list[int]  # slots this node sees ALIVE
    suspected_members: list[int]  # slots this node sees SUSPECT
    dead_members: list[int]  # un-expired DEAD tombstones
    unknown_members: list[int]  # not (or no longer) in the table


def node_view(state: SimState, node: int) -> NodeView:
    """Snapshot node ``node``'s table of a dense state (host transfer; not
    for hot loops)."""
    row = decode_status(state.view[node]).cpu().numpy()
    sets: dict[int, list[int]] = {s: [] for s in range(4)}
    for j, status in enumerate(row.tolist()):
        if j != node:
            sets[int(status)].append(j)
    return NodeView(
        node=node,
        incarnation=int(state.inc_self[node]),
        epoch=int(state.epoch[node]),
        alive_members=sets[int(MemberStatus.ALIVE)],
        suspected_members=sets[int(MemberStatus.SUSPECT)],
        dead_members=sets[int(MemberStatus.DEAD)],
        unknown_members=sets[int(MemberStatus.UNKNOWN)],
    )


def cluster_summary(state: SimState) -> dict:
    """Whole-cluster aggregates of a dense state (the metrics dict's
    host-side sibling)."""
    status = decode_status(state.view).cpu().numpy()
    alive = state.alive.cpu().numpy()
    inc = decode_incarnation(state.view).cpu().numpy()
    epoch = decode_epoch(state.view).cpu().numpy()
    live_rows = status[alive]
    return {
        "tick": int(state.tick),
        "n": int(alive.size),
        "n_alive_processes": int(alive.sum()),
        "viewed_alive_mean": float((live_rows == int(MemberStatus.ALIVE)).mean())
        if live_rows.size
        else 0.0,
        "viewed_suspect_total": int((live_rows == int(MemberStatus.SUSPECT)).sum()),
        "viewed_dead_total": int((live_rows == int(MemberStatus.DEAD)).sum()),
        "max_incarnation": int(inc.max()),
        "max_epoch": int(epoch.max()),
    }


def _sparse_summary_device(state) -> dict:
    """Device-side reductions behind :func:`sparse_summary`, over the last
    axes, so a state with a leading universe axis reduces per universe."""
    status = decode_status(state.slab)
    active = state.slot_subj >= 0
    counting = state.alive[..., :, None] & active[..., None, :]
    summary = {
        "tick": state.tick,
        "n_alive_processes": state.alive.sum(dim=-1),
        "active_slots": active.sum(dim=-1),
        "viewed_suspect_total": (counting & (status == int(MemberStatus.SUSPECT))).sum(dim=(-2, -1)),
        "viewed_dead_total": (counting & (status == int(MemberStatus.DEAD))).sum(dim=(-2, -1)),
        "max_incarnation": state.inc_self.amax(dim=-1),
        "max_epoch": state.epoch.amax(dim=-1),
    }
    if getattr(state, "wb_pinned", None) is not None:
        # The carried write-back pin mask's health: active slots it holds
        # back, and whether it is trusted now (0 after host ops).
        summary["wb_pinned_slots"] = (state.wb_pinned & active).sum(dim=-1)
        summary["wb_mask_valid"] = state.wb_valid.to(torch.int32)
    return summary


def sparse_summary(state, traces=None) -> dict:
    """Whole-cluster aggregates of a sparse state — the working-set twin of
    :func:`cluster_summary`, plus slot-table health.

    Reduces on the state's device and reads back only the scalars, in one
    transfer. A state whose leaves carry a leading universe axis (detected
    off ``alive.ndim == 2``) gives an ``[B]`` numpy vector per value.

    With the run's collected ``traces`` it adds the fault accounting
    totals (``fault_blocked_total`` / ``fault_lost_total`` /
    ``link_attempts_total`` / ``link_delivered_total``) over the traced
    window (per universe, summed over ticks, when batched).
    """
    batched = state.alive.ndim == 2
    summary = _sparse_summary_device(state)
    keys = list(summary)
    pulled = torch.stack(
        [summary[k].to(torch.int64).reshape(-1) for k in keys]
    ).cpu().numpy()
    if batched:
        out: dict = {k: pulled[i] for i, k in enumerate(keys)}
    else:
        out = {k: int(pulled[i, 0]) for i, k in enumerate(keys)}
    out["n"] = int(state.alive.shape[-1])
    out["slot_budget"] = int(state.slot_subj.shape[-1])
    if traces is not None:
        for key in ("link_attempts", "link_delivered", "fault_blocked", "fault_lost"):
            if key in traces:
                value = traces[key]
                arr = np.asarray(value.cpu() if hasattr(value, "cpu") else value)
                if batched:
                    out[f"{key}_total"] = arr.sum(axis=tuple(range(1, arr.ndim)))
                else:
                    out[f"{key}_total"] = int(arr.sum())
    return out


def user_gossip_swept(state, node: int, slot: int) -> bool:
    """Host-side ``spread()`` completion signal: has ``node`` swept
    user-gossip ``slot``? (origin-local, as the reference's future is;
    poll :func:`user_gossip_slot_free` before reusing the slot)."""
    return not bool(state.useen[node, slot])


def user_gossip_slot_free(state, slot: int) -> bool:
    """True when no node still holds user-gossip ``slot`` — the safe point
    to inject a new rumor into it."""
    return not bool(state.useen[:, slot].any())
