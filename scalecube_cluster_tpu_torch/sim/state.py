"""The dense engine's state and its host-side mutation helpers
(port of scalecube_cluster_tpu/sim/state.py).

One ``SimState`` holds the soft state of N SWIM nodes as tensors:

- ``view[i, j]``        — node i's record about j as a priority key
                          (ops/merge.py);
- ``rumor_age[i, j]``   — periods since that record changed (int8,
                          saturating at :data:`AGE_STALE`);
- ``suspect_left[i, j]``— suspicion countdown in ticks (int16, 0 = none);
- ``rows[i, j]``        — DERIVED young payload,
                          ``where(rumor_age < periods_to_spread, view, -1)``;
- ``known_cnt[i]``      — DERIVED count of known non-DEAD non-self records
                          (0 means i is joining);
- ``inc_self``, ``epoch``, ``alive`` — per member;
- ``useen``/``uage`` [N, G] user gossip, and ``uinf``/``uflight`` the
  [N, N, G] infected sets and in-flight ledger when tracked ([N, 1, G]
  stubs otherwise).

``rng`` is the raw threefry key (``uint32[2]`` numpy array, derived on the
host) and ``t_host`` mirrors the device ``tick`` leaf for the cadence
branches. The host ops return a new state and leave their input as it was,
as the reference's do.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from scalecube_cluster_tpu_torch import prng
from scalecube_cluster_tpu_torch.cluster_api.member import MemberStatus
from scalecube_cluster_tpu_torch.ops import merge as merge_ops

#: Saturation value of the int8 rumor ages: "long stale", past every spread
#: and sweep deadline (SimParams asserts sweep < AGE_STALE).
AGE_STALE = 120

_I32 = torch.int32


@dataclass
class SimState:
    """Complete state of an N-member simulated cluster (tensors over members)."""

    view: torch.Tensor  # [N, N] int32 priority keys
    rumor_age: torch.Tensor  # [N, N] int8, saturates at AGE_STALE
    suspect_left: torch.Tensor  # [N, N] int16 countdown, 0 = no timer
    rows: torch.Tensor  # [N, N] int32 derived young payload
    known_cnt: torch.Tensor  # [N] int32 derived candidate counts
    inc_self: torch.Tensor  # [N] int32
    epoch: torch.Tensor  # [N] int32
    alive: torch.Tensor  # [N] bool
    useen: torch.Tensor  # [N, G] bool
    uage: torch.Tensor  # [N, G] int32
    uinf: torch.Tensor  # [N, N, G] bool (or [N, 1, G] stub when untracked)
    uflight: torch.Tensor  # [N, N, G] bool (or [N, 1, G] stub)
    tick: torch.Tensor  # [] int32
    rng: np.ndarray  # uint32[2]
    t_host: int = 0

    def replace(self, **changes) -> "SimState":
        return dataclasses.replace(self, **changes)

    @property
    def device(self) -> torch.device:
        return self.view.device


def _blank(n, slots, seed, track_infected, delay_model, device) -> SimState:
    def full(shape, value, dtype):
        return torch.full(shape, value, dtype=dtype, device=device)

    return SimState(
        view=full((n, n), merge_ops.UNKNOWN_KEY, _I32),
        rumor_age=full((n, n), AGE_STALE, torch.int8),
        suspect_left=full((n, n), 0, torch.int16),
        rows=full((n, n), merge_ops.UNKNOWN_KEY, _I32),
        known_cnt=full((n,), 0, _I32),
        inc_self=full((n,), 0, _I32),
        epoch=full((n,), 0, _I32),
        alive=full((n,), True, torch.bool),
        useen=full((n, slots), False, torch.bool),
        uage=full((n, slots), 0, _I32),
        uinf=full((n, n if track_infected else 1, slots), False, torch.bool),
        uflight=full(
            (n, n if (track_infected and delay_model) else 1, slots), False, torch.bool
        ),
        tick=full((), 0, _I32),
        rng=prng.PRNGKey(seed),
    )


def init_full_view(
    n: int,
    user_gossip_slots: int = 4,
    seed: int = 0,
    track_infected: bool = False,
    delay_model: bool = False,
    device="cuda",
) -> SimState:
    """Post-join steady state: everyone knows everyone ALIVE at incarnation
    0, nothing young. ``track_infected`` sizes ``uinf`` (for
    ``SimParams.track_user_infected``), ``delay_model`` also ``uflight``
    (for ``SimParams.gossip_delay_model``)."""
    state = _blank(n, user_gossip_slots, seed, track_infected, delay_model, device)
    return state.replace(
        view=torch.zeros((n, n), dtype=_I32, device=device),  # ALIVE@inc0, epoch 0
        known_cnt=torch.full((n,), n - 1, dtype=_I32, device=device),
    )


def init_seeded(
    n: int,
    seeds,
    user_gossip_slots: int = 4,
    seed: int = 0,
    track_infected: bool = False,
    delay_model: bool = False,
    device="cuda",
) -> SimState:
    """Cold join: node i knows only itself, as a young record (start0,
    MembershipProtocolImpl.java:222-257). ``seeds`` are addresses, not table
    entries: the tick's SYNC always counts them as partners (pass
    :func:`seeds_mask` to the runner)."""
    state = _blank(n, user_gossip_slots, seed, track_infected, delay_model, device)
    diag = torch.eye(n, dtype=torch.bool, device=device)
    self_key = 0  # ALIVE at incarnation 0, epoch 0
    view = torch.where(diag, self_key, merge_ops.UNKNOWN_KEY).to(_I32)
    return state.replace(
        view=view,
        rumor_age=torch.where(diag, 0, state.rumor_age).to(torch.int8),
        rows=view.clone(),
    )


def seeds_mask(n: int, seeds, device="cuda") -> torch.Tensor:
    """Bool [N] mask of seed member slots (MembershipConfig.seed_members)."""
    mask = torch.zeros((n,), dtype=torch.bool, device=device)
    mask[torch.as_tensor(list(seeds), dtype=torch.long, device=device)] = True
    return mask


def _set(t: torch.Tensor, index, value) -> torch.Tensor:
    """A copy of ``t`` with ``t[index] = value`` (the reference's ``.at[].set``)."""
    out = t.clone()
    out[index] = value
    return out


def kill(state: SimState, idx) -> SimState:
    """Hard-stop process ``idx`` (no leave gossip: the crash case)."""
    return state.replace(alive=_set(state.alive, idx, False))


def _own_key(status: int, inc: int, epoch: int) -> int:
    key = merge_ops.encode_key(
        torch.tensor(status), torch.tensor(inc), torch.tensor(epoch)
    )
    return int(key)


def leave(state: SimState, idx: int) -> SimState:
    """Graceful shutdown, phase 1: announce self-DEAD at inc+1
    (leaveCluster, MembershipProtocolImpl.java:203-212). The process stays
    up so the leave rumor spreads; the tick treats a DEAD own record as
    "voluntarily left" and does not refute it. :func:`kill` it later."""
    inc = int(state.inc_self[idx]) + 1
    dead_key = _own_key(int(MemberStatus.DEAD), inc, int(state.epoch[idx]))
    return state.replace(
        inc_self=_set(state.inc_self, idx, inc),
        view=_set(state.view, (idx, idx), dead_key),
        rumor_age=_set(state.rumor_age, (idx, idx), 0),
        rows=_set(state.rows, (idx, idx), dead_key),
    )


def restart(state: SimState, idx: int) -> SimState:
    """Restart process ``idx`` as a brand-new identity in the same slot: the
    epoch bumps (read on the host), the table empties to the young own
    record, and the node rejoins through the seed SYNC."""
    epoch = int(state.epoch[idx])
    if epoch >= merge_ops.EPOCH_MAX:
        raise ValueError(
            f"slot {idx} exhausted its {merge_ops.EPOCH_MAX} restart epochs"
        )
    self_key = _own_key(int(MemberStatus.ALIVE), 0, epoch + 1)
    n = state.view.shape[0]
    uinf = _set(state.uinf, idx, False)
    if state.uinf.shape[1] == n:
        # Tracked: nobody knows the new identity holds anything either.
        uinf[:, idx] = False
    rumor_age = _set(state.rumor_age, idx, AGE_STALE)
    rumor_age[idx, idx] = 0
    view = _set(state.view, idx, merge_ops.UNKNOWN_KEY)
    view[idx, idx] = self_key
    rows = _set(state.rows, idx, merge_ops.UNKNOWN_KEY)
    rows[idx, idx] = self_key
    return state.replace(
        alive=_set(state.alive, idx, True),
        epoch=_set(state.epoch, idx, epoch + 1),
        inc_self=_set(state.inc_self, idx, 0),
        view=view,
        rumor_age=rumor_age,
        suspect_left=_set(state.suspect_left, idx, 0),
        rows=rows,
        known_cnt=_set(state.known_cnt, idx, 0),
        useen=_set(state.useen, idx, False),
        uinf=uinf,
        # Copies in flight TO the old process are lost; those it sent fly on.
        uflight=_set(state.uflight, idx, False),
    )


def update_metadata(state: SimState, idx: int) -> SimState:
    """Announce a metadata change at ``idx``: inc+1 on the own record with a
    fresh rumor age (updateIncarnation, MembershipProtocolImpl.java:184-196).
    A node that announced a leave keeps its leave record."""
    own = int(state.view[idx, idx])
    if own & merge_ops.DEAD_BIT:
        return state
    inc = int(state.inc_self[idx]) + 1
    key = _own_key(int(MemberStatus.ALIVE), inc, int(state.epoch[idx]))
    return state.replace(
        inc_self=_set(state.inc_self, idx, inc),
        view=_set(state.view, (idx, idx), key),
        rumor_age=_set(state.rumor_age, (idx, idx), 0),
        rows=_set(state.rows, (idx, idx), key),
    )


def inject_gossip(state: SimState, node_idx: int, slot: int) -> SimState:
    """``cluster.spreadGossip``: enqueue user payload ``slot`` at
    ``node_idx`` (GossipProtocolImpl.spread, :124-128, 163-169)."""
    return state.replace(
        useen=_set(state.useen, (node_idx, slot), True),
        uage=_set(state.uage, (node_idx, slot), 0),
    )
