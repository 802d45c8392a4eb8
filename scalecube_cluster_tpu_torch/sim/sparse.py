"""Sparse (compact-rumor) SWIM engine on a bounded working set
(port of scalecube_cluster_tpu/sim/sparse.py: fault plans and schedules,
knobs, the host ops, elastic membership and the causal flight recorder).

Representation (as in the reference):

- ``view_T [N_subj, N_viewer] int32`` — the full membership tables,
  subject-major; stale for subjects loaded in the slab.
- slot table: ``slot_subj [S]`` (subject of slot, -1 free) and
  ``subj_slot [N]`` (slot of subject, -1 inactive).
- the working set, viewer-major: ``slab [N, S] int32`` record keys,
  ``age [N, S] int8`` rumor ages, ``susp [N, S] int16`` countdowns.
- per-member vectors ``inc_self``, ``epoch``, ``alive`` and the [N, G]
  user-gossip arrays.

Per tick: scheduled events (:func:`apply_events_sparse`), FD probe decision
and SYNC exchange (each on its cadence), slot grant and slab load, the
[N, S] core, the window-SYNC apply, self-refutation and user gossip.

The core takes the reference's route: the fused kernel
(ops/sparse_core.py — csrc/sparse_core.cu on the card, its plain version on
the CPU) exactly when ``params.pallas_core``, n % 32 == 0, S % 128 == 0
and S < 4096; otherwise the XLA chain, which is the plain version itself
(:func:`~scalecube_cluster_tpu_torch.ops.sparse_core.sparse_core_reference`,
with the 8-row fan-out group when n % 32 != 0) on whichever device the
state is on. ``pallas_fold`` decides, as in the reference, which per-slot
aggregates of the kernel the tick consumes (the carried write-back pin mask
``wb_pinned``/``wb_valid`` and the latency recorder's flags); the protocol
state is the same on every route.

Control flow differs from the reference only in form, never in result:

- the FD / SYNC cadence conds become Python branches on ``t_host``, a host
  mirror of the device tick counter (the cadence is a function of the tick
  alone, so no per-tick device read is needed); the device ``tick`` leaf
  still advances;
- the data-dependent conds (the grant load, the write-back pin-mask carry)
  become unconditional masked updates with identical results;
- ``scatter(mode="drop")`` routes dropped entries to a pad element, and
  ``flatnonzero(size=, fill_value=)`` compacts by cumsum; nothing inside a
  tick synchronises with the device. :func:`writeback_free`, which runs at
  chunk boundaries, reads the freed-slot list back to the host once.

Elastic membership (``init_sparse_full_view(..., n_alloc=)``) allocates
capacity rows that a scheduled join activates in the tick (the 4-tuple
events of :func:`apply_events_sparse`); ``live_mask`` marks the rows whose
identity has ever been live. The flight recorder
(``init_sparse_full_view(..., trace_capacity=)``, obs/tracer.py) records
the tick's causal events on the XLA chain; the kernel route refuses it, as
the reference's does. Without either, the state and the tick are what they
are with neither field present.

A tick consumes the state it is given: the slab load and the write-back
update the input tensors in place, the way the reference's runners donate
their input state; so does the flight recorder's ring.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from scalecube_cluster_tpu_torch import prng
from scalecube_cluster_tpu_torch.cluster_api.member import MemberStatus
from scalecube_cluster_tpu_torch.obs.counters import SHARED_COUNTERS
from scalecube_cluster_tpu_torch.obs.trace import DEAD_VIA_EXPIRY, DEAD_VIA_GOSSIP
from scalecube_cluster_tpu_torch.obs.tracer import (
    SHARDED_RING_ERROR,
    ShardTraceRing,
    TK_GOSSIP_EDGE,
    TK_JOIN_EV,
    TK_KILL,
    TK_PROBE_MISSED,
    TK_PROBE_SENT,
    TK_RESTART,
    TK_SUSPECT_START,
    TK_SYNC_ACCEPT,
    TK_VERDICT_ALIVE,
    TK_VERDICT_DEAD,
    TraceRing,
    init_shard_trace_rings,
    init_trace_ring,
    trace_emit,
    trace_host_event,
    trace_reset_members,
)
from scalecube_cluster_tpu_torch.ops.delivery import (
    GROUP,
    fanout_permutations_structured,
    perm_from_structured,
)
from scalecube_cluster_tpu_torch.ops.merge import (
    DEAD_BIT,
    EPOCH_MAX,
    UNKNOWN_KEY,
    decode_epoch,
    decode_incarnation,
    decode_status,
    encode_key,
    is_alive_key,
    is_dead_key,
    is_suspect_key,
    overrides_same_epoch,
)
from scalecube_cluster_tpu_torch.ops.select import probe_cursor_targets
from scalecube_cluster_tpu_torch.ops.sparse_core import (
    AGGR_DEAD_BIT,
    AGGR_HOLD_BIT,
    AGGR_SUSPECT_BIT,
    SLOT_BITS,
    SPARSE_GROUP,
    sparse_core,
    sparse_core_reference,
)
from scalecube_cluster_tpu_torch.ops.sparse_persistent import FOLD_PIECES
from scalecube_cluster_tpu_torch.sim.faults import (
    FaultPlan,
    edge_blocked,
    link_pass_from,
    round_trip_in_time_from,
)
from scalecube_cluster_tpu_torch.sim.knobs import Knobs, edge_live, suspicion_fill
from scalecube_cluster_tpu_torch.sim.params import SimParams
from scalecube_cluster_tpu_torch.sim.run import (
    ScheduleTraces,
    check_plan,
    scheduled_inputs,
    stack_ticks,
)
from scalecube_cluster_tpu_torch.sim.state import AGE_STALE
from scalecube_cluster_tpu_torch.sim.topology import ZONE_ROW_BLOCK, zone_pair_counts
from scalecube_cluster_tpu_torch.sim.tick import _acct_add, _acct_zero, _link_acct
from scalecube_cluster_tpu_torch.sim.usergossip import (
    user_gossip_step,
    user_gossip_step_tracked,
)

_ALIVE = int(MemberStatus.ALIVE)
_SUSPECT = int(MemberStatus.SUSPECT)
_DEAD = int(MemberStatus.DEAD)

_I32 = torch.int32


def sync_accept(learned, mine):
    """Merge-lattice accept test for SYNC-learned records: same-epoch
    records fight by key; unknown / newer-epoch identities may only be
    introduced by an ALIVE record (ops/merge.py::merge_views)."""
    known = learned >= 0
    same = (mine >= 0) & known & (decode_epoch(mine) == decode_epoch(learned))
    intro = (
        known
        & is_alive_key(learned)
        & ((mine < 0) | (decode_epoch(learned) > decode_epoch(mine)))
    )
    return (same & overrides_same_epoch(learned, mine)) | (~same & intro)


def slot_lifetime_ticks(base: SimParams, writeback_period: int = 1) -> int:
    """Worst-case ticks a churn-driven slot stays pinned: suspicion, then
    the tombstone's sweep, then the wait for the next write-back."""
    return base.suspicion_ticks + base.periods_to_sweep + writeback_period


def slot_budget_for(
    base: SimParams,
    n: int,
    churn_rate: float,
    writeback_period: int = 1,
    margin: float = 1.5,
) -> int:
    """Slot budget that keeps ``slot_overflow == 0`` under sustained churn
    (Little's law on the slab, plus a 64-slot non-churn floor)."""
    demand = churn_rate * n * slot_lifetime_ticks(base, writeback_period)
    return int(np.ceil(margin * demand)) + 64


@dataclass(frozen=True)
class SparseParams:
    """Static constants: the protocol constants + working-set bounds.

    ``pallas_core`` routes the [N, S] core to the fused kernel where the
    reference's own gate allows it (module docstring); ``pallas_fold``
    names the kernel aggregates the tick consumes, and a fold the reference
    refuses is refused here too. The main path sets ``pallas_core=True``
    with the whole fold."""

    base: SimParams
    #: Max simultaneously active subjects (the slab width S).
    slot_budget: int = 2048
    #: Max subject activations per tick.
    alloc_cap: int = 64
    #: Write-back cadence in ticks when ``in_scan_writeback`` is on.
    writeback_period: int = 1
    #: False: the tick never touches ``view_T``; frees happen between
    #: chunks in :func:`writeback_free` (the big-n driver).
    in_scan_writeback: bool = True
    #: Run the [N, S] core as the fused kernel (where n and S allow it).
    pallas_core: bool = False
    #: Kernel aggregates the tick consumes: 'wb_mask' carries the write-back
    #: pin mask tick to tick, 'view_rows' feeds the latency recorder;
    #: 'countdown' and 'points' move work into the kernel in the reference
    #: and change no value.
    pallas_fold: frozenset = frozenset({"countdown", "points", "wb_mask", "view_rows"})
    #: Bounded-window table SYNC width (0 disables).
    sync_window: int = 64

    def __post_init__(self):
        # A checkpoint's JSON carries the fold as a list: freeze it again.
        fold = frozenset(self.pallas_fold)
        unknown = fold - set(FOLD_PIECES)
        if unknown:
            raise ValueError(f"unknown pallas_fold pieces {sorted(unknown)}; valid: {FOLD_PIECES}")
        if ("wb_mask" in fold or "view_rows" in fold) and "countdown" not in fold:
            raise ValueError(
                "pallas_fold: 'wb_mask'/'view_rows' aggregate the swept arrays, "
                "so they require 'countdown'"
            )
        object.__setattr__(self, "pallas_fold", fold)

    @classmethod
    def for_n(
        cls,
        n: int,
        slot_budget: int = 2048,
        alloc_cap: int = 64,
        writeback_period: int = 1,
        in_scan_writeback: bool = True,
        pallas_core: bool = False,
        pallas_fold=frozenset({"countdown", "points", "wb_mask", "view_rows"}),
        sync_window: int = 64,
        churn_rate: float = 0.0,
        burst: int = 0,
        **kw,
    ):
        """Params for an ``n``-member cluster from a ClusterConfig preset
        (``kw`` goes to :meth:`SimParams.from_cluster_config`); churn-aware
        sizing as in the reference."""
        base = SimParams.from_cluster_config(n, **kw)
        if churn_rate > 0.0:
            slot_budget = max(
                slot_budget,
                slot_budget_for(base, n, churn_rate, writeback_period),
            )
            alloc_cap = max(alloc_cap, int(np.ceil(churn_rate * n)) + sync_window)
        if burst > 0:
            alloc_cap = max(alloc_cap, burst + sync_window)
        return cls(
            base=base,
            slot_budget=slot_budget,
            alloc_cap=alloc_cap,
            writeback_period=writeback_period,
            in_scan_writeback=in_scan_writeback,
            pallas_core=pallas_core,
            pallas_fold=frozenset(pallas_fold),
            sync_window=sync_window,
        )


@dataclass
class SparseState:
    """Working-set state of an N-member sparse-engine cluster.

    ``rng`` is the raw threefry key (``uint32[2]`` numpy array, derived on
    the host); ``t_host`` mirrors the device ``tick`` leaf for the cadence
    branches."""

    view_T: torch.Tensor  # [N_subj, N_view] int32, subject-major
    slot_subj: torch.Tensor  # [S] int32, -1 free
    subj_slot: torch.Tensor  # [N] int32, -1 inactive
    slab: torch.Tensor  # [N_view, S] int32
    age: torch.Tensor  # [N_view, S] int8
    susp: torch.Tensor  # [N_view, S] int16
    inc_self: torch.Tensor  # [N] int32
    epoch: torch.Tensor  # [N] int32
    alive: torch.Tensor  # [N] bool
    useen: torch.Tensor  # [N, G] bool
    uage: torch.Tensor  # [N, G] int32
    uinf_ids: torch.Tensor  # [N, G, k] int32, -1 empty
    uptr: torch.Tensor  # [N, G] int32
    tick: torch.Tensor  # [] int32
    rng: np.ndarray  # uint32[2]
    t_host: int = 0
    lat_first_suspect: torch.Tensor | None = None  # [N] int32
    lat_first_dead: torch.Tensor | None = None  # [N] int32
    wb_pinned: torch.Tensor | None = None  # [S] bool
    wb_valid: torch.Tensor | None = None  # [] bool
    #: Causal flight recorder (obs/tracer.py), None when not armed; the
    #: explicit-SPMD engine's per-shard recorder is a ShardTraceRing.
    trace: TraceRing | ShardTraceRing | None = None
    #: Elastic membership: True for rows whose identity has ever been live,
    #: False for capacity rows; None on a fixed-shape cluster.
    live_mask: torch.Tensor | None = None  # [N] bool

    def replace(self, **changes) -> "SparseState":
        return dataclasses.replace(self, **changes)

    @property
    def device(self) -> torch.device:
        return self.slab.device


def init_sparse_full_view(
    n: int,
    slot_budget: int = 2048,
    seed: int = 0,
    user_gossip_slots: int = 4,
    infected_k: int = 16,
    record_latency: bool = False,
    trace_capacity: int = 0,
    trace_shards: int = 0,
    n_alloc: int | None = None,
    device="cuda",
) -> SparseState:
    """Post-join steady state, nothing active: every member knows every
    member ALIVE at incarnation 0. ``infected_k`` sizes the user-gossip
    last-k-senders ring (0 selects the untracked lifecycle);
    ``record_latency`` attaches the first-suspect / first-dead recorder.

    ``trace_capacity > 0`` attaches the causal flight recorder's ring,
    sized for that many events over the whole run; with ``trace_shards >
    0`` it is the sharded recorder instead, ``trace_shards`` per-shard
    rings of ``trace_capacity`` events each (obs/tracer.py::
    ShardTraceRing), which only the explicit-SPMD engine takes
    (parallel/spmd.py; ``trace_shards`` must equal its shard count).

    ``n_alloc`` (elastic membership): allocate ``n_alloc >= n`` member rows
    with only the first ``n`` live; the rest are capacity rows (dead,
    UNKNOWN along both view axes) that a scheduled join activates. ``None``
    or ``n_alloc == n`` is the fixed-shape state (``live_mask`` None). The
    caller's ``SparseParams`` must be built for ``n_alloc``."""
    S = slot_budget

    def full(shape, value, dtype):
        return torch.full(shape, value, dtype=dtype, device=device)

    if n_alloc is None or n_alloc == n:
        na = n
        live = None
        view_T = torch.zeros((na, na), dtype=_I32, device=device)  # ALIVE@inc0
        alive = full((na,), True, torch.bool)
    else:
        if n_alloc < n:
            raise ValueError(f"n_alloc={n_alloc} < n_live={n}")
        if n_alloc % GROUP != 0:
            raise ValueError(
                f"n_alloc={n_alloc} must be a multiple of {GROUP} "
                "(structured fan-out group)"
            )
        na = n_alloc
        live = torch.arange(na, device=device) < n
        # Live members know each other ALIVE@inc0; capacity rows are UNKNOWN
        # along both axes.
        view_T = torch.where(live[:, None] & live[None, :], 0, UNKNOWN_KEY).to(_I32)
        alive = live.clone()
    return SparseState(
        view_T=view_T,
        slot_subj=full((S,), -1, _I32),
        subj_slot=full((na,), -1, _I32),
        slab=full((na, S), UNKNOWN_KEY, _I32),
        age=full((na, S), AGE_STALE, torch.int8),
        susp=full((na, S), 0, torch.int16),
        inc_self=full((na,), 0, _I32),
        epoch=full((na,), 0, _I32),
        alive=alive,
        useen=full((na, user_gossip_slots), False, torch.bool),
        uage=full((na, user_gossip_slots), 0, _I32),
        uinf_ids=full((na, user_gossip_slots, infected_k), -1, _I32),
        uptr=full((na, user_gossip_slots), 0, _I32),
        tick=full((), 0, _I32),
        rng=prng.PRNGKey(seed),
        t_host=0,
        lat_first_suspect=full((na,), -1, _I32) if record_latency else None,
        lat_first_dead=full((na,), -1, _I32) if record_latency else None,
        wb_pinned=full((S,), False, torch.bool),
        wb_valid=full((), False, torch.bool),
        trace=(
            init_shard_trace_rings(na, trace_capacity, trace_shards, device)
            if trace_capacity and trace_shards
            else init_trace_ring(na, trace_capacity, device) if trace_capacity
            else None
        ),
        live_mask=live,
    )


def _invalidate_wb(state: SparseState) -> SparseState:
    """Mark the carried write-back pin mask stale (a host op touched
    slab/age/susp/alive or the slot tables)."""
    if state.wb_valid is None:
        return state
    return state.replace(wb_valid=torch.zeros_like(state.wb_valid))


def inject_gossip_sparse(state: SparseState, node_idx: int, slot: int) -> SparseState:
    """``cluster.spreadGossip``: enqueue user payload ``slot`` at
    ``node_idx`` (GossipProtocolImpl.spread, :124-128, 163-169)."""
    useen = state.useen.clone()
    uage = state.uage.clone()
    useen[node_idx, slot] = True
    uage[node_idx, slot] = 0
    return state.replace(useen=useen, uage=uage)


def kill_sparse(state: SparseState, idx) -> SparseState:
    """Hard-stop process ``idx`` (an index or an index array). A traced
    state records a KILL per member, stamped at the next tick to execute
    (the in-tick scheduled kill's convention)."""
    alive = state.alive.clone()
    alive[_members(idx, alive)] = False
    state = _invalidate_wb(state).replace(alive=alive)
    if state.trace is not None:
        ring = _host_ring(state)
        for j in np.asarray(idx).ravel().tolist():
            ring = trace_host_event(ring, TK_KILL, state.t_host + 1, -1, int(j))
        state = state.replace(trace=ring)
    return state


def _host_ring(state: SparseState) -> TraceRing:
    """The ring a host op records into; a sharded recorder takes events
    from the sharded engine's schedule only."""
    if isinstance(state.trace, ShardTraceRing):
        raise ValueError(
            "host ops do not record into a sharded flight recorder "
            "(ShardTraceRing): schedule the event (ScheduleBuilder) for the "
            "explicit-SPMD engine instead"
        )
    return state.trace


def _members(idx, like: torch.Tensor) -> torch.Tensor:
    """A member index or index list as an int64 tensor on ``like``'s device."""
    return torch.as_tensor(np.asarray(idx, np.int64)).to(like.device)


def _activate_on_host(state: SparseState, subject: int) -> tuple[SparseState, int]:
    """Host-side slot allocation for the control-plane ops: load
    ``subject``'s column into the first free slot unless it is already
    active. Returns ``(state, slot)``; the slab planes are written in
    place."""
    state = _invalidate_wb(state)
    cur = int(state.subj_slot[subject])
    if cur >= 0:
        return state, cur
    free = torch.nonzero(state.slot_subj < 0).flatten()
    if free.numel() == 0:
        raise RuntimeError("slot budget exhausted for host op")
    s = int(free[0])
    slot_subj, subj_slot = state.slot_subj.clone(), state.subj_slot.clone()
    slot_subj[s] = subject
    subj_slot[subject] = s
    state.slab[:, s] = state.view_T[subject, :]
    state.age[:, s] = AGE_STALE
    state.susp[:, s] = 0
    return state.replace(slot_subj=slot_subj, subj_slot=subj_slot), s


def leave_sparse(state: SparseState, idx: int) -> SparseState:
    """Graceful leave: self-DEAD at inc+1 rides normal gossip (dense twin:
    sim/state.py::leave). Consumes ``state`` (slab planes in place)."""
    state, s = _activate_on_host(state, idx)
    inc_self = state.inc_self.clone()
    inc_self[idx] += 1
    inc = inc_self[idx]
    state.slab[idx, s] = encode_key(torch.full_like(inc, _DEAD), inc, state.epoch[idx])
    state.age[idx, s] = 0
    return state.replace(inc_self=inc_self)


def update_metadata_sparse(state: SparseState, idx: int) -> SparseState:
    """Announce a metadata change at ``idx``: incarnation bump and a fresh
    young own record (updateIncarnation, ClusterImpl.java:365-369); a
    voluntary leaver keeps its tombstone. Consumes ``state``."""
    state, s = _activate_on_host(state, idx)
    if int(state.slab[idx, s]) & DEAD_BIT:
        return state
    inc_self = state.inc_self.clone()
    inc_self[idx] += 1
    inc = inc_self[idx]
    state.slab[idx, s] = encode_key(torch.full_like(inc, _ALIVE), inc, state.epoch[idx])
    state.age[idx, s] = 0
    return state.replace(inc_self=inc_self)


def restart_sparse(state: SparseState, idx: int) -> SparseState:
    """Restart ``idx`` as a new identity (epoch bump) with a seed-loaded
    table: the one-member :func:`restart_many_sparse`."""
    return restart_many_sparse(state, [idx])


def restart_many_sparse(state: SparseState, idxs) -> SparseState:
    """Restart every member of ``idxs`` as a fresh identity in one pass over
    the big arrays: epoch + 1, incarnation 0, the first live member's table
    copied into its view column and slab row, its user gossip cleared and
    it scrubbed from every suppression ring, then a slot for each (host
    bookkeeping on the [S]/[N] tables) and its new self record announced
    young. Raises on duplicate indices, an exhausted epoch budget or a full
    slot table. Consumes ``state``: ``view_T`` and the slab planes are
    updated in place."""
    idx_list = [int(i) for i in np.asarray(idxs).ravel()]
    if not idx_list:
        return state
    ring = _host_ring(state) if state.trace is not None else None
    state = _invalidate_wb(state)
    if len(set(idx_list)) != len(idx_list):
        raise ValueError("duplicate indices in restart_many_sparse")
    dev = state.device
    ii = torch.tensor(idx_list, dtype=torch.int64, device=dev)
    epochs = state.epoch[ii]
    if int(epochs.max()) >= EPOCH_MAX:
        raise ValueError(f"a slot in {idx_list} exhausted its {EPOCH_MAX} restart epochs")
    seed_viewer = int(torch.argmax(state.alive.to(torch.uint8)))
    new_epochs = epochs + 1
    zeros = torch.zeros((len(idx_list),), dtype=_I32, device=dev)
    self_keys = encode_key(zeros + _ALIVE, zeros, new_epochs)

    # 1. Identity resets, one pass over each array.
    alive, epoch, inc_self = state.alive.clone(), state.epoch.clone(), state.inc_self.clone()
    alive[ii] = True
    epoch[ii] = new_epochs
    inc_self[ii] = 0
    state.view_T[:, ii] = state.view_T[:, seed_viewer].clone()[:, None]
    state.slab[ii, :] = state.slab[seed_viewer, :].clone()[None, :]
    state.age[ii, :] = AGE_STALE
    state.susp[ii, :] = 0
    useen, uptr = state.useen.clone(), state.uptr.clone()
    useen[ii, :] = False
    uptr[ii] = 0
    uinf_ids = torch.where(torch.isin(state.uinf_ids, ii.to(_I32)), -1, state.uinf_ids)
    uinf_ids[ii] = -1
    state = state.replace(
        alive=alive, epoch=epoch, inc_self=inc_self, useen=useen, uptr=uptr,
        uinf_ids=uinf_ids,
    )
    if state.lat_first_suspect is not None:
        lat_s, lat_d = state.lat_first_suspect.clone(), state.lat_first_dead.clone()
        lat_s[ii] = -1
        lat_d[ii] = -1
        state = state.replace(lat_first_suspect=lat_s, lat_first_dead=lat_d)
    if ring is not None:
        for j in idx_list:
            ring = trace_host_event(ring, TK_RESTART, state.t_host + 1, -1, j)
        fresh = torch.zeros_like(state.alive)
        fresh[ii] = True
        state = state.replace(trace=trace_reset_members(ring, fresh))

    # 2. Slot allocation on the host: already-active subjects keep their
    # slot, the others take the free slots in order.
    subj_slot = state.subj_slot.cpu().numpy().copy()
    slot_subj = state.slot_subj.cpu().numpy().copy()
    slots = np.empty(len(idx_list), np.int64)
    need_load = []
    free_iter = iter(np.flatnonzero(slot_subj < 0).tolist())
    for k, j in enumerate(idx_list):
        if subj_slot[j] >= 0:
            slots[k] = subj_slot[j]
        else:
            s = next(free_iter, None)
            if s is None:
                raise RuntimeError("slot budget exhausted for host op")
            slots[k] = s
            subj_slot[j] = s
            slot_subj[s] = j
            need_load.append(k)
    sl = torch.from_numpy(slots).to(dev)
    state = state.replace(
        slot_subj=torch.from_numpy(slot_subj).to(dev),
        subj_slot=torch.from_numpy(subj_slot).to(dev),
    )
    if need_load:
        nl = torch.tensor(need_load, dtype=torch.int64, device=dev)
        state.slab[:, sl[nl]] = state.view_T[ii[nl], :].T
        state.age[:, sl[nl]] = AGE_STALE
        state.susp[:, sl[nl]] = 0

    # 3. Announce the new identities (ALIVE at the new epoch, young).
    state.slab[ii, sl] = self_keys
    state.age[ii, sl] = 0
    return state


def apply_events_sparse(state: SparseState, kill_mask, restart_mask, gossip_mask=None,
                        join_mask=None) -> SparseState:
    """Scheduled kill/restart (and, with ``gossip_mask [N, G]``, user-gossip
    injections; with ``join_mask [N]``, elastic joins) applied before the
    tick body. Kill is :func:`kill_sparse`. Restart is the reference's fast
    restart with persistence: the node keeps its table, comes back at
    epoch + 1 (clamped at EPOCH_MAX) and incarnation 0 with a cold working
    row (no young record, no armed timer) and no user-gossip state, and
    announces itself through the tick's slot path. A join activates a
    capacity row as a new identity the same way (epoch 0 → 1) and sets its
    ``live_mask`` bit. A traced state records the events (kills, restarts,
    joins, then injected gossip with ``aux`` 1) before anything the tick
    body emits. Consumes no RNG; masks with no event leave the state as it
    was."""
    n = state.alive.shape[0]
    fresh = restart_mask if join_mask is None else restart_mask | join_mask
    any_ev = (kill_mask | fresh).any()
    if gossip_mask is not None:
        any_ev = any_ev | gossip_mask.any()
    st = _reset_event_rows(state, kill_mask, fresh, fresh)
    if join_mask is not None and st.live_mask is not None:
        st = st.replace(live_mask=st.live_mask | join_mask)
    if gossip_mask is not None:
        st = st.replace(
            useen=st.useen | gossip_mask, uage=torch.where(gossip_mask, 0, st.uage)
        )
    if st.wb_valid is not None:
        st = st.replace(wb_valid=st.wb_valid & ~any_ev)
    if st.trace is not None:
        t_ev = st.t_host + 1  # the tick about to execute
        col_ev = torch.arange(n, dtype=_I32, device=st.device)
        ring = st.trace
        ring, _ = trace_emit(ring, TK_KILL, kill_mask, t_ev, -1, col_ev)
        ring, _ = trace_emit(ring, TK_RESTART, restart_mask, t_ev, -1, col_ev)
        if join_mask is not None:
            # Scheduled joins carry the joiner's origin register (-1), read
            # before the reset below clears the fresh identities.
            ring, _ = trace_emit(ring, TK_JOIN_EV, join_mask, t_ev, -1, col_ev,
                                 cause=ring.origin)
        ring = trace_reset_members(ring, fresh)
        if gossip_mask is not None:
            g = gossip_mask.shape[1]
            ring, _ = trace_emit(
                ring, TK_GOSSIP_EDGE, gossip_mask, t_ev, -1,
                torch.arange(g, dtype=_I32, device=st.device)[None, :], aux=1,
            )
        st = st.replace(trace=ring)
    return st


def _reset_event_rows(state: SparseState, kill, fresh, fresh_all) -> SparseState:
    """The row resets of a tick's events, on the caller's rows (all ``[n]``,
    or a shard caller's ``[dl, nl]``): killed rows go down; fresh
    (restarted or joining) rows come up with a bumped epoch, incarnation 0,
    stale unarmed cells, no user gossip and no recorded latencies, and
    leave every suppression ring (``fresh_all``: the ``[n]`` mask by global
    id)."""
    n = fresh_all.shape[0]
    uinf_ids = state.uinf_ids
    if uinf_ids.shape[-1] > 0:
        hit = (uinf_ids >= 0) & fresh_all[torch.clamp(uinf_ids, 0, n - 1).long()]
        uinf_ids = torch.where(hit, -1, uinf_ids)
        uinf_ids = torch.where(fresh[..., None, None], -1, uinf_ids)
    rows = fresh[..., None]
    st = state.replace(
        alive=(state.alive & ~kill) | fresh,
        epoch=torch.where(fresh, torch.clamp_max(state.epoch + 1, EPOCH_MAX), state.epoch),
        inc_self=torch.where(fresh, 0, state.inc_self),
        # Python scalars keep the planes' int8 / int16 dtypes and, unlike a
        # CPU tensor operand, need no host-to-device copy.
        age=torch.where(rows, AGE_STALE, state.age),
        susp=torch.where(rows, 0, state.susp),
        useen=torch.where(rows, False, state.useen),
        uptr=torch.where(rows, 0, state.uptr),
        uinf_ids=uinf_ids,
    )
    if st.lat_first_suspect is not None:
        st = st.replace(
            lat_first_suspect=torch.where(fresh, -1, st.lat_first_suspect),
            lat_first_dead=torch.where(fresh, -1, st.lat_first_dead),
        )
    return st


def _put_drop(vec: torch.Tensor, idx: torch.Tensor, vals) -> torch.Tensor:
    """``vec.at[idx].set(vals, mode="drop")`` for ``idx`` in [0, len(vec)]
    where ``len(vec)`` means dropped; kept indices must be distinct."""
    pad = torch.cat([vec, vec.new_zeros(1)])
    pad.scatter_(0, idx.long(), vals.to(vec.dtype))
    return pad[:-1]


def _max_drop(vec: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """``vec.at[idx].max(vals, mode="drop")`` for ``idx`` in [0, len(vec)]
    where ``len(vec)`` means dropped."""
    pad = torch.cat([vec, vec.new_zeros(1)])
    pad.scatter_reduce_(0, idx.long(), vals.to(vec.dtype), "amax", include_self=True)
    return pad[:-1]


def _or_drop(vec: torch.Tensor, idx: torch.Tensor, flags: torch.Tensor) -> torch.Tensor:
    """``vec.at[idx].max(flags, mode="drop")`` on a bool vector."""
    pad = torch.cat([vec, vec.new_zeros(1)]).to(_I32)
    pad.scatter_reduce_(0, idx.long(), flags.to(_I32), "amax", include_self=True)
    return pad[:-1].bool()


def _first_true(mask: torch.Tensor, size: int, fill: int) -> torch.Tensor:
    """``flatnonzero(mask, size=size, fill_value=fill)`` without a sync."""
    rank = torch.cumsum(mask.to(_I32), 0, dtype=_I32) - 1
    dst = torch.where(mask & (rank < size), rank, size)
    out = torch.full((size + 1,), fill, dtype=_I32, device=mask.device)
    out.scatter_(0, dst.long(), torch.arange(mask.shape[0], dtype=_I32, device=mask.device))
    return out[:size]


def _column_writer(cols: torch.Tensor, route: torch.Tensor, width: int):
    """Prepare ``x.at[..., route].set(v, mode="drop")`` on an [..., width]
    array as a deterministic in-place column write.

    ``route[k]`` is entry k's column (``width`` = dropped; kept columns are
    distinct) and ``cols[k]`` is a column in range that equals ``route[k]``
    for every kept entry. Every entry writes column ``cols[k]`` with the
    value the column finally holds (the writing entry's value, else the
    column's own), so duplicate targets all write the same value.
    Returns ``write(x, vals)``.
    """
    src = torch.full((width + 1,), -1, dtype=torch.int64, device=cols.device)
    src.scatter_(0, route.long(), torch.arange(route.shape[0], device=cols.device))
    k = src[cols.long()]
    has = (k >= 0)[None, :]
    kk = torch.clamp_min(k, 0)
    cl = cols.long()

    def write(x: torch.Tensor, vals: torch.Tensor) -> None:
        x[..., cl] = torch.where(has, vals[..., kk].to(x.dtype), x[..., cl])

    return write


def _free_plan(params: SparseParams, state: SparseState):
    """THE slot free rule, shared by the in-tick and host-boundary
    write-backs. A slot stays pinned while any LIVE viewer still has a
    young copy, an armed suspicion, or a DEAD tombstone not yet past the
    sweep deadline (a subject's own row keeps its tombstone). Under
    ``pallas_core`` with the 'wb_mask' fold the kernel carries this mask
    tick to tick (``wb_pinned``); when ``wb_valid`` is False the rule is
    recomputed — both are evaluated and selected, the form of the
    reference's cond. Returns ``freeing [S] bool`` (``[B, S]`` for an
    ensemble's stacked state)."""
    p = params.base
    col = torch.arange(p.n, dtype=_I32, device=state.device)
    active = state.slot_subj >= 0
    pinned = _holding(p, state, col[:, None] == state.slot_subj[..., None, :]).any(dim=-2)
    if state.wb_pinned is not None and params.pallas_core and "wb_mask" in params.pallas_fold:
        pinned = torch.where(state.wb_valid[..., None], state.wb_pinned, pinned)
    return active & ~pinned


def _holding(p: SimParams, state: SparseState, own_row) -> torch.Tensor:
    """The cells that pin their slot: at a live viewer, a young copy, an
    armed suspicion, or a DEAD tombstone not yet past the sweep deadline
    (``own_row``: the subject's own row, which keeps its tombstone)."""
    stale_done = state.age.to(_I32) > p.periods_to_sweep
    holding = (
        (state.age < p.periods_to_spread)
        | (state.susp > 0)
        | (is_dead_key(state.slab) & ~stale_done & ~own_row)
    )
    return holding & state.alive[..., None]


def _swept_columns(p: SimParams, cols, ages, own_row) -> torch.Tensor:
    """Freed slab columns as they go back into ``view_T``: tombstones past
    the sweep deadline demoted to UNKNOWN, except in the subject's own
    row."""
    demote = is_dead_key(cols) & (ages.to(_I32) > p.periods_to_sweep) & ~own_row
    return torch.where(demote, UNKNOWN_KEY, cols)


def _write_back(params: SparseParams, state: SparseState, freeing: torch.Tensor):
    """Scatter the freed slots' columns into ``view_T`` rows IN PLACE (with
    tombstones past the sweep deadline demoted to UNKNOWN) and clear the
    slot tables. Reads the freed-slot list back to the host once."""
    p = params.base
    idx = torch.nonzero(freeing).flatten()
    slot_subj, subj_slot = state.slot_subj, state.subj_slot
    if idx.numel():
        subj = slot_subj[idx].long()
        cols = state.slab[:, idx]
        col = torch.arange(p.n, dtype=_I32, device=state.device)
        own_row = col[:, None] == slot_subj[idx][None, :]
        state.view_T.index_put_((subj,), _swept_columns(p, cols, state.age[:, idx], own_row).T)
        subj_slot = subj_slot.clone()
        subj_slot[subj] = -1
        slot_subj = torch.where(freeing, -1, slot_subj)
    return slot_subj, subj_slot


@dataclass(frozen=True)
class ShardRows:
    """The viewer rows one caller of :func:`_fd_decide` / :func:`_sync_fire`
    owns, in the explicit-SPMD engine (parallel/spmd.py): ``lrow`` their
    local slab rows (what ``record_of`` takes), ``col`` their global member
    ids, ``cut`` the slice of a full ``[n, ...]`` draw to those rows (every
    draw is made at the full shape, so each shard sees the single-device
    bits), and the all-gathered ``[n]`` member scalars."""

    lrow: torch.Tensor
    col: torch.Tensor
    cut: object
    alive_all: torch.Tensor
    epoch_all: torch.Tensor


def _own_rows(n: int, alive, epoch, shard: ShardRows | None) -> ShardRows:
    """The single-device caller's rows: all of them, identity cut."""
    if shard is not None:
        return shard
    col = torch.arange(n, dtype=_I32, device=alive.device)
    return ShardRows(col, col, lambda a: a, alive, epoch)


def _fd_decide(p, plan, t, k_tgt, k_ping, k_relay, record_of, alive, epoch, collect,
               trace=False, shard: ShardRows | None = None):
    """The FD probe decision for the caller's viewers (the reference's
    shared body: every viewer with the identity cut, or one shard's rows
    through ``shard``). Returns ``(tgt, fd_key, fire, msgs)`` plus, under
    ``collect``, ``(pings, ping_reqs, acks)`` and the 4 accounting sums,
    and under ``trace`` the recorder's ``(probing, missed, gone)`` masks;
    the sums are over the caller's rows."""
    n = p.n
    dev = alive.device
    rows = _own_rows(n, alive, epoch, shard)
    lrow, col, cut = rows.lrow, rows.col, rows.cut
    alive_all, epoch_all = rows.alive_all, rows.epoch_all
    rr_tgt = cut(probe_cursor_targets(t // p.fd_period_ticks, n, dev))
    rr_key = record_of(lrow, rr_tgt)
    rr_valid = (rr_tgt != col) & (rr_key >= 0) & ((rr_key & DEAD_BIT) == 0)
    rand_tgt = cut(prng.randint(k_tgt, (n,), 0, n, dev))
    tgt = torch.where(rr_valid, rr_tgt, rand_tgt)
    tgt_l = tgt.long()
    vkey = record_of(lrow, tgt)
    valid = (tgt != col) & (vkey >= 0) & ((vkey & DEAD_BIT) == 0)
    probing = alive & valid
    pk1, pk2, pk3 = prng.split(k_ping, 3)
    fwd_ok = link_pass_from(cut(prng.uniform(pk1, (n,), dev)), plan, col, tgt)
    ack_ok = link_pass_from(cut(prng.uniform(pk2, (n,), dev)), plan, tgt, col)
    rt_ok = round_trip_in_time_from(
        cut(prng.uniform(pk3, (n,), dev)), plan, [(col, tgt), (tgt, col)],
        p.ping_timeout_ms,
    )
    direct = probing & alive_all[tgt_l] & fwd_ok & ack_ok & rt_ok

    kr, rk1, rk2, rk3, rk4, rk5 = prng.split(k_relay, 6)
    nrel = p.ping_req_members
    ridx = cut(prng.randint(kr, (n, nrel), 0, n, dev))
    colc, tgtc = col[..., None], tgt[..., None]
    rkey = record_of(lrow[:, None], ridx)
    rvalid = (ridx != colc) & (ridx != tgtc) & (rkey >= 0) & ((rkey & DEAD_BIT) == 0)
    leg_or = link_pass_from(cut(prng.uniform(rk1, (n, nrel), dev)), plan, colc, ridx)
    leg_rt = link_pass_from(cut(prng.uniform(rk2, (n, nrel), dev)), plan, ridx, tgtc)
    leg_tr = link_pass_from(cut(prng.uniform(rk3, (n, nrel), dev)), plan, tgtc, ridx)
    leg_ro = link_pass_from(cut(prng.uniform(rk4, (n, nrel), dev)), plan, ridx, colc)
    path_ok = round_trip_in_time_from(
        cut(prng.uniform(rk5, (n, nrel), dev)), plan,
        [(colc, ridx), (ridx, tgtc), (tgtc, ridx), (ridx, colc)],
        p.ping_req_timeout_ms,
    )
    alive_r = alive_all[ridx.long()]
    alive_t = alive_all[tgt_l][..., None]
    relay = rvalid & alive_r & alive_t & leg_or & leg_rt & leg_tr & leg_ro & path_ok
    reached = direct | (probing & relay.any(dim=-1))
    gone = reached & (epoch_all[tgt_l] != decode_epoch(vkey))
    fd_key = encode_key(
        torch.where(gone, _DEAD, _SUSPECT), decode_incarnation(vkey), decode_epoch(vkey)
    )
    fire = ((probing & ~reached) | gone) & overrides_same_epoch(fd_key, vkey)
    n_pings = probing.sum(dtype=_I32)
    req_att = (probing & ~direct)[..., None] & rvalid
    n_ping_reqs = req_att.sum(dtype=_I32)
    out = (tgt, fd_key, fire, n_pings + n_ping_reqs)
    if collect:
        ack_att = probing & fwd_ok & alive_all[tgt_l]
        att2 = req_att & leg_or & alive_r
        att3 = att2 & leg_rt & alive_t
        att4 = att3 & leg_tr
        acct = _acct_add(
            _link_acct(probing, edge_blocked(plan, col, tgt), fwd_ok),
            _link_acct(ack_att, edge_blocked(plan, tgt, col), ack_ok),
            _link_acct(req_att, edge_blocked(plan, colc, ridx), leg_or),
            _link_acct(att2, edge_blocked(plan, ridx, tgtc), leg_rt),
            _link_acct(att3, edge_blocked(plan, tgtc, ridx), leg_tr),
            _link_acct(att4, edge_blocked(plan, ridx, colc), leg_ro),
        )
        out = out + (n_pings, n_ping_reqs, reached.sum(dtype=_I32)) + acct
    if trace:
        out = out + (probing, probing & ~reached, gone)
    return out


def _rows_shape(n) -> tuple:
    """The viewer-row shape: ``(n,)``, or a shard caller's ``(dl, nl)``."""
    return tuple(n) if isinstance(n, tuple) else (n,)


def _fd_zeros(n, collect, dev, trace=False):
    shape = _rows_shape(n)
    zero = torch.zeros((), dtype=_I32, device=dev)
    out = (
        torch.zeros(shape, dtype=_I32, device=dev),
        torch.zeros(shape, dtype=_I32, device=dev),
        torch.zeros(shape, dtype=torch.bool, device=dev),
        zero,
    )
    if collect:
        out = out + (zero, zero, zero) + _acct_zero(dev)
    if trace:
        none = torch.zeros(shape, dtype=torch.bool, device=dev)
        out = out + (none, none, none)
    return out


def _sync_fire(p, plan, k_ssel, k_slink, record_of, alive, W, wsubj, collect,
               shard: ShardRows | None = None, partner_records=None):
    """The own-record + bounded-window SYNC decision for the caller's
    viewers. Returns ``(partner, learned_key, accept, msgs, learned_w,
    accept_w, self_win)`` plus, under ``collect``, the 4 accounting sums.
    ``partner_records(prt_full, prt)`` is the one remote read (the
    partners' own records and their window records): direct reads here,
    the SYNC reply exchange in the explicit-SPMD engine (with ``shard``)."""
    n = p.n
    dev = alive.device
    rows = _own_rows(n, alive, None, shard)
    lrow, col, cut = rows.lrow, rows.col, rows.cut
    prt_full = prng.randint(k_ssel, (n,), 0, n, dev)
    prt = cut(prt_full)
    s_pass = link_pass_from(cut(prng.uniform(k_slink, (n,), dev)), plan, col, prt)
    ok = alive & rows.alive_all[prt.long()] & (prt != col) & s_pass
    if partner_records is None:
        learned_key = record_of(prt, prt)
        learned_w = record_of(prt[:, None], wsubj[None, :]) if W > 0 else None
    else:
        learned_key, learned_w = partner_records(prt_full, prt)
    accept = ok & sync_accept(learned_key, record_of(lrow, prt))
    if W > 0:
        mine_w = record_of(lrow[:, None], wsubj[None, :])
        self_cell = wsubj == col[..., None]
        accept_w = ok[..., None] & ~self_cell & sync_accept(learned_w, mine_w)
        self_win = torch.where(
            self_cell & ok[..., None] & (learned_w >= 0), learned_w, UNKNOWN_KEY
        ).amax(dim=-1)
    else:
        learned_w, accept_w, self_win = _window_zeros(prt.shape, W, dev)
    out = (prt, learned_key, accept, ok.sum(dtype=_I32) * 2, learned_w, accept_w, self_win)
    if collect:
        att_f = alive & (prt != col)
        acct_f = _link_acct(att_f, edge_blocked(plan, col, prt), s_pass)
        n_rev = ok.sum(dtype=_I32)
        out = out + (acct_f[0] + n_rev, acct_f[1] + n_rev, acct_f[2], acct_f[3])
    return out


def _window_zeros(n, W, dev):
    shape = _rows_shape(n)
    return (
        torch.full(shape + (W,), UNKNOWN_KEY, dtype=_I32, device=dev),
        torch.zeros(shape + (W,), dtype=torch.bool, device=dev),
        torch.full(shape, UNKNOWN_KEY, dtype=_I32, device=dev),
    )


def _sync_zeros(n, W, collect, dev):
    shape = _rows_shape(n)
    out = (
        torch.zeros(shape, dtype=_I32, device=dev),
        torch.zeros(shape, dtype=_I32, device=dev),
        torch.zeros(shape, dtype=torch.bool, device=dev),
        torch.zeros((), dtype=_I32, device=dev),
    ) + _window_zeros(n, W, dev)
    if collect:
        out = out + _acct_zero(dev)
    return out


# The tick's steps after the exchanges, shared with the explicit-SPMD engine
# (parallel/spmd.py). Each works on the caller's viewer rows: ``[n]`` here,
# a shard caller's ``[dl, nl]`` there, with ``[rows..., S]`` slab planes and
# global member ids in ``col``. The [N, S] planes are updated in place.
def _grant_slots(req, slot_subj, subj_slot, cap, fresh_m=None, join_m=None):
    """Step 3's grant: the ``[n]`` slot requests (plus ``fresh_m``'s own
    announcements; under a join mask those outrank the rest) of subjects
    without a slot get the first free slots, up to ``cap``. Returns
    ``(slot_subj, subj_slot, free_slots, tgt_slots, new_subjects,
    n_granted, slot_overflow)``."""
    n, S = req.shape[0], slot_subj.shape[0]
    if fresh_m is not None:
        req = req | fresh_m
    req = req & (subj_slot < 0)
    if join_m is not None:
        # Elastic runs: fresh activations (join/restart) outrank the
        # organic FD/SYNC/sweep requests, so a join never loses its
        # announcing slot to a coincident sweep.
        fresh_req = req & fresh_m
        rank_fresh = torch.cumsum(fresh_req.to(_I32), 0, dtype=_I32) - 1
        rank_rest = (
            torch.cumsum((req & ~fresh_m).to(_I32), 0, dtype=_I32) - 1
            + fresh_req.sum(dtype=_I32)
        )
        req_rank = torch.where(fresh_req, rank_fresh, rank_rest)
    else:
        req_rank = torch.cumsum(req.to(_I32), 0, dtype=_I32) - 1
    free = slot_subj < 0
    free_slots = _first_true(free, cap, S - 1)
    n_free = free.sum(dtype=_I32)
    granted = req & (req_rank < cap) & (req_rank < n_free)
    new_subjects = _first_true(granted, cap, 0)
    n_granted = granted.sum(dtype=_I32)
    grant_valid = torch.arange(cap, dtype=_I32, device=req.device) < torch.minimum(
        n_granted, n_free
    )
    slot_overflow = req.sum(dtype=_I32) - n_granted
    tgt_slots = torch.where(grant_valid, free_slots, S)
    slot_subj = _put_drop(slot_subj, tgt_slots, new_subjects)
    subj_slot = _put_drop(subj_slot, torch.where(grant_valid, new_subjects, n), free_slots)
    return slot_subj, subj_slot, free_slots, tgt_slots, new_subjects, n_granted, slot_overflow


def _load_granted(slab, age, susp, cols, free_slots, tgt_slots):
    """Load the granted subjects' view columns ``cols [rows..., cap]`` into
    their slab slots in place, stale and unarmed."""
    load = _column_writer(free_slots, tgt_slots, slab.shape[-1])
    load(slab, cols)
    load(age, torch.full(cols.shape, AGE_STALE, dtype=torch.int8, device=cols.device))
    load(susp, torch.zeros(cols.shape, dtype=torch.int16, device=cols.device))


def _own_cells(own_slot):
    """Each row's own-subject column (0 where it has no slot), as the
    ``[rows..., 1]`` index of a gather or scatter along the slot axis."""
    return torch.clamp_min(own_slot, 0).long()[..., None]


def _announce_fresh(slab, age, fresh, own_slot, epoch):
    """A restarted (or joining) member's bumped-epoch ALIVE key, young, in
    its own cell (part of the event, not a tick verdict); in place."""
    fire = fresh & (own_slot >= 0)
    cell = _own_cells(own_slot)
    key = encode_key(torch.full_like(epoch, _ALIVE), torch.zeros_like(epoch), epoch)
    slab.scatter_(-1, cell, torch.where(fire, key, slab.gather(-1, cell)[..., 0])[..., None])
    age.scatter_(-1, cell, torch.where(fire, 0, age.gather(-1, cell)[..., 0])
                 .to(torch.int8)[..., None])


def _aggr_flags(aggr):
    """The core's per-slot aggregate ``[..., S]`` as ``[S]`` flags, OR-ed
    over any leading (shard) axes: ``(pin, seen_suspect, seen_dead)``."""
    flags = [((aggr >> bit) & 1).bool() for bit in (AGGR_HOLD_BIT, AGGR_SUSPECT_BIT,
                                                     AGGR_DEAD_BIT)]
    if aggr.dim() > 1:
        flags = [x.reshape(-1, aggr.shape[-1]).any(dim=0) for x in flags]
    return tuple(flags)


def _window_sync_apply(slab2, age, susp, subj_slot, wsubj, win_key, win_accept, alive,
                       susp_fill, pin, seen_s, seen_d):
    """Step 6.5: the accepted window SYNC learnings ``win_key [rows..., W]``
    of active subjects, written in place where they still win over the
    post-core cell (young, armed if suspect). Returns the ``[S]`` pin and
    seen-suspect / seen-dead flags with the applied slots OR-ed in."""
    S = slab2.shape[-1]
    wslot = subj_slot[wsubj.long()]
    safe = torch.clamp_min(wslot, 0).long()
    route = torch.where(wslot >= 0, wslot, S)
    cur = slab2[..., safe]
    app = win_accept & (wslot >= 0) & alive[..., None] & sync_accept(win_key, cur)
    new = torch.where(app, win_key, cur)
    new_age = torch.where(app, 0, age[..., safe])
    new_susp = torch.where(app, torch.where(is_suspect_key(new), susp_fill, 0),
                           susp[..., safe].to(_I32))
    put = _column_writer(safe, route, S)
    put(slab2, new)
    put(age, new_age)
    put(susp, new_susp)
    # Applied cells become young at a live viewer (their slot holds); the
    # learned key may be the slot's first suspect/dead record.
    app = app.reshape(-1, app.shape[-1])
    learned = win_key.reshape(app.shape)
    pin = _or_drop(pin, route, app.any(dim=0))
    seen_s = _or_drop(seen_s, route, (app & is_suspect_key(learned)).any(dim=0))
    seen_d = _or_drop(seen_d, route, (app & is_dead_key(learned)).any(dim=0))
    return pin, seen_s, seen_d


def _threatened(alive, rumor, epoch, inc_self):
    """A live member's rumor ``rumor`` (UNKNOWN < 0 = none) is a SUSPECT or
    DEAD record of its current identity (epoch, incarnation or newer)."""
    status = decode_status(rumor)
    return (
        alive
        & (rumor >= 0)
        & (decode_epoch(rumor) == epoch)
        & (decode_incarnation(rumor) >= inc_self)
        & ((status == _SUSPECT) | (status == _DEAD))
    )


def _self_refute(slab2, age, self_rumor, own_slot, alive, inc_self, epoch, pin):
    """Step 7: a live member that heard a SUSPECT/DEAD rumor of its current
    identity bumps its incarnation and writes the refuting ALIVE key, young,
    into its own cell (in place). Returns ``(inc_self, pin)``."""
    S = slab2.shape[-1]
    has_own = own_slot >= 0
    cell = _own_cells(own_slot)
    own_cur = slab2.gather(-1, cell)[..., 0]
    # Where there is no own slot the threat is off (has_own) whatever the
    # stand-in key says.
    threat = (
        _threatened(alive, self_rumor, epoch, inc_self)
        & ((own_cur & DEAD_BIT) == 0)
        & has_own
    )
    inc_self = torch.where(threat, decode_incarnation(self_rumor) + 1, inc_self)
    own_new = encode_key(torch.zeros_like(inc_self), inc_self, epoch)
    slab2.scatter_(-1, cell, torch.where(threat, own_new, own_cur)[..., None])
    age.scatter_(-1, cell, torch.where(threat, 0, age.gather(-1, cell)[..., 0])
                 .to(torch.int8)[..., None])
    pin = _or_drop(pin, torch.where(threat, own_slot, S).flatten(), threat.flatten())
    return inc_self, pin


def _seen_in_slab(slab2, alive):
    """Step 9's per-slot flags from the final slab: some live viewer holds
    a SUSPECT (DEAD) record of the slot's subject."""
    live = alive[..., None]
    s = slab2.shape[-1]
    return ((is_suspect_key(slab2) & live).reshape(-1, s).any(dim=0),
            (is_dead_key(slab2) & live).reshape(-1, s).any(dim=0))


def _record_latency(lat_s, lat_d, seen_s, seen_d, own_slot, t):
    """Step 9: a member whose slot is seen SUSPECT (DEAD) by a live viewer
    anywhere gets tick ``t`` as its first-suspect (first-dead) tick, once."""
    has_own = own_slot >= 0
    cell = torch.clamp_min(own_slot, 0).long()
    lat_s = torch.where(has_own & seen_s[cell] & (lat_s < 0), t, lat_s)
    lat_d = torch.where(has_own & seen_d[cell] & (lat_d < 0), t, lat_d)
    return lat_s, lat_d


def _emit_tick(ring, t, n, col, fd_tgt, fd_fire, fd_trace, sy_accept, sy_subj, alive, active,
               slot_subj, slab0, slab2, expired, new_seen, useen, sync_aux=0):
    """Step 9.5, the causal flight recorder: the tick's events of the rows
    ``col [r]`` into ``ring``. Emission order within the tick is the causal
    order (probes, misses, suspicions, SYNC, verdicts, infections), so every
    ``cause`` points strictly backwards in the ring. ``fd_trace`` is
    :func:`_fd_decide`'s ``(probing, missed, gone)``; ``slab0`` the
    post-load snapshot the verdicts are taken against; ``sync_aux`` the SYNC
    accepts' ``aux``. Returns the ring."""
    probing, missed, gone = fd_trace
    ring, sent_pos = trace_emit(ring, TK_PROBE_SENT, probing, t, col, fd_tgt)
    ring, miss_pos = trace_emit(ring, TK_PROBE_MISSED, missed, t, col, fd_tgt, cause=sent_pos)
    # Latest recorded miss per subject (the largest position wins).
    ring = ring.replace(
        last_miss=_max_drop(ring.last_miss, torch.where(miss_pos >= 0, fd_tgt, n), miss_pos)
    )
    # A fired SUSPECT verdict is caused by this row's missed round.
    ring, susp_pos = trace_emit(ring, TK_SUSPECT_START, fd_fire & ~gone, t, col, fd_tgt,
                                cause=miss_pos)
    # The verdict episode's origin per subject: the suspicion that started
    # the countdown, or the probe that found a newer epoch.
    origin = _max_drop(ring.origin, torch.where(susp_pos >= 0, fd_tgt, n), susp_pos)
    gone_fire = fd_fire & gone & (sent_pos >= 0)
    origin = _max_drop(origin, torch.where(gone_fire, fd_tgt, n), sent_pos)
    ring = ring.replace(origin=origin)
    ring, _ = trace_emit(ring, TK_SYNC_ACCEPT, sy_accept, t, col, sy_subj, aux=sync_aux)
    # Per-viewer verdict transitions, post-load snapshot vs final slab.
    live = alive[:, None] & active[None, :]
    subj_row = slot_subj[None, :]
    cause_row = ring.origin[torch.clamp(slot_subj, 0, n - 1).long()][None, :]
    ring, _ = trace_emit(
        ring, TK_VERDICT_DEAD, is_dead_key(slab2) & ~is_dead_key(slab0) & live,
        t, col[:, None], subj_row, cause=cause_row,
        aux=torch.where(expired, DEAD_VIA_EXPIRY, DEAD_VIA_GOSSIP),
    )
    ring, _ = trace_emit(
        ring, TK_VERDICT_ALIVE,
        is_alive_key(slab2) & ~is_alive_key(slab0) & (slab0 >= 0) & live,
        t, col[:, None], subj_row, cause=cause_row,
    )
    # User-gossip infection edges (injected ones were recorded with the
    # events, where they are still visible).
    ring, _ = trace_emit(
        ring, TK_GOSSIP_EDGE, new_seen & ~useen, t, col[:, None],
        torch.arange(useen.shape[-1], dtype=_I32, device=useen.device)[None, :],
    )
    return ring


def _count(mask: torch.Tensor) -> torch.Tensor:
    return mask.sum(dtype=_I32)


def _view_partials(slab0, slab2, alive, active, new_seen, useen, win_accept) -> dict:
    """The tick's counters that are sums over the caller's viewer rows (a
    shard's partial sums in the explicit-SPMD engine)."""
    viewer_live = alive[..., None] & active
    is_susp2 = is_suspect_key(slab2)
    return {
        "n_suspected": _count(is_susp2 & viewer_live),
        "suspicions_raised": _count(is_susp2 & ~is_suspect_key(slab0) & viewer_live),
        "verdicts_dead": _count(is_dead_key(slab2) & ~is_dead_key(slab0) & viewer_live),
        "verdicts_alive": _count(
            is_alive_key(slab2) & ~is_alive_key(slab0) & (slab0 >= 0) & viewer_live
        ),
        "gossip_infections": _count(new_seen & ~useen),
        "coverage_num": (new_seen & alive[..., None]).reshape(-1, useen.shape[-1])
        .sum(dim=0, dtype=_I32),
        "n_alive": _count(alive),
        "sync_window_accepts": _count(win_accept),
    }


def _link_partials(fd_out, sy_out, g_acct) -> dict:
    """The message and link counters of the tick's FD, SYNC and gossip
    channels (``fd_out`` / ``sy_out`` as :func:`_fd_decide` /
    :func:`_sync_fire` return them under ``collect``)."""
    acct = _acct_add(fd_out[7:11], g_acct, sy_out[7:11])
    return {
        "msgs_fd": fd_out[3], "msgs_sync": sy_out[3],
        "pings": fd_out[4], "ping_reqs": fd_out[5], "acks": fd_out[6],
        "link_attempts": acct[0], "link_delivered": acct[1],
        "fault_blocked": acct[2], "fault_lost": acct[3],
    }


def _tick_metrics(tick, parts: dict, *, n_active_slots, slot_overflow, slot_activations,
                  slot_frees, inc_max, epoch_max, **extra) -> dict:
    """The tick's metrics row in the reference's order from the counter
    totals ``parts`` (:func:`_view_partials`, :func:`_link_partials`,
    ``msgs_gossip``, ``msgs_user``), the slot gauges and the engine's own
    ``extra`` counters; the shared schema's other slots are zero."""
    metrics = {
        "tick": tick,
        "n_active_slots": n_active_slots,
        "slot_overflow": slot_overflow,
        "n_suspected": parts["n_suspected"],
        "msgs_fd": parts["msgs_fd"],
        "msgs_sync": parts["msgs_sync"],
        "msgs_gossip": parts["msgs_gossip"],
        "msgs_user": parts["msgs_user"],
        "gossip_coverage": parts["coverage_num"] / torch.clamp_min(parts["n_alive"], 1),
        "pings": parts["pings"],
        "ping_reqs": parts["ping_reqs"],
        "acks": parts["acks"],
        "suspicions_raised": parts["suspicions_raised"],
        "verdicts_dead": parts["verdicts_dead"],
        "verdicts_alive": parts["verdicts_alive"],
        "gossip_infections": parts["gossip_infections"],
        "slot_activations": slot_activations,
        "slot_frees": slot_frees,
        "sync_window_accepts": parts["sync_window_accepts"],
        "link_attempts": parts["link_attempts"],
        "link_delivered": parts["link_delivered"],
        "fault_blocked": parts["fault_blocked"],
        "fault_lost": parts["fault_lost"],
        "inc_max": inc_max,
        "epoch_max": epoch_max,
        **extra,
    }
    zero = torch.zeros((), dtype=_I32, device=tick.device)
    # The schema's slots of other engines and of the serving / fleet planes:
    # constant zero on an offline SWIM tick.
    for key in SHARED_COUNTERS:
        metrics.setdefault(key, zero)
    return metrics


def sparse_route(params: SparseParams) -> bool:
    """True where the [N, S] core is the fused kernel: the reference's gate
    (sim/sparse.py:1435), ``pallas_core``, n % 32 == 0, S % 128 == 0 and
    S < 4096."""
    n, s = params.base.n, params.slot_budget
    return (
        params.pallas_core and n % SPARSE_GROUP == 0 and s % 128 == 0 and s < 1 << SLOT_BITS
    )


def sparse_tick(
    params: SparseParams,
    state: SparseState,
    plan: FaultPlan,
    collect: bool = True,
    events=None,
    knobs: Knobs | None = None,
):
    """One gossip period on the working set. Returns ``(state, metrics)``;
    under ``collect=False`` the metrics are ``{"tick": t}`` only. Consumes
    ``state`` (see the module docstring).

    ``events`` is None, ``(kill_mask, restart_mask[, gossip_mask])`` or
    the elastic 4-tuple ``(kill_mask, restart_mask, gossip_mask or None,
    join_mask)`` (:func:`apply_events_sparse`, before the tick body; a
    restarted or joining node requests its own slot and announces its new
    identity there; under a join mask those requests outrank the others).
    ``knobs`` (sim/knobs.py) need ``pallas_core=False``; identity knobs
    equal ``knobs=None``. A traced state needs the XLA chain (the kernel
    route raises ``ValueError``); with ``collect`` its metrics add
    ``trace_overflow``."""
    p = params.base
    n, S = p.n, params.slot_budget
    f = p.gossip_fanout
    if n % GROUP != 0:
        raise ValueError("sparse engine needs n % 8 == 0 (structured fan-out)")
    if knobs is not None and params.pallas_core:
        raise ValueError(
            "knobs require the XLA tick core: sparse_core_pallas bakes the "
            "suspicion timeout as a kernel constant (set pallas_core=False)"
        )
    if isinstance(state.trace, ShardTraceRing):
        raise ValueError(SHARDED_RING_ERROR)
    if not isinstance(plan, FaultPlan):
        raise TypeError(
            f"sparse_tick takes one tick's FaultPlan (got {type(plan).__name__}); "
            "run a FaultSchedule through run_sparse_ticks / run_sparse_chunked"
        )
    fresh_m = join_m = None
    if events is not None:
        gossip_m = events[2] if len(events) > 2 else None
        join_m = events[3] if len(events) > 3 else None
        state = apply_events_sparse(state, events[0], events[1], gossip_m, join_m)
        # Restarts and joins both announce fresh identities in step 3.
        fresh_m = events[1] if join_m is None else events[1] | join_m
    dev = state.device
    # The reference's core route: the fused kernel where its gate holds,
    # else the XLA chain (the plain core, 8-row groups when n % 32 != 0).
    group = SPARSE_GROUP if n % SPARSE_GROUP == 0 else GROUP
    use_kernel = sparse_route(params)
    tracing = state.trace is not None
    if tracing and use_kernel:
        raise ValueError(
            "flight-recorder tracing requires the XLA tick core: the fused "
            "kernel does not expose the per-cell expiry mask the verdict "
            "events need (set pallas_core=False or drop the trace ring)"
        )
    fold = params.pallas_fold if use_kernel else frozenset()
    t = state.t_host + 1
    rng_next, k_tgt, k_ping, k_relay, k_gsel, k_glink, k_ssel, k_slink = (
        prng.split(state.rng, 8)
    )
    col = torch.arange(n, dtype=_I32, device=dev)
    srange = torch.arange(S, dtype=_I32, device=dev)
    alive = state.alive
    do_fd = t % p.fd_period_ticks == 0
    do_sync = t % p.sync_period_ticks == 0
    subj_slot0, slab_in, view_T = state.subj_slot, state.slab, state.view_T

    def record_of(viewer, subject):
        """view[viewer, subject] through the slab indirection."""
        s = subj_slot0[subject.long()]
        v, sl = viewer.long(), subject.long()
        from_slab = slab_in[v, torch.clamp_min(s, 0).long()]
        return torch.where(s >= 0, from_slab, view_T[sl, v])

    # ------------------------------------------------------------- 1. FD
    if do_fd:
        fd_out = _fd_decide(
            p, plan, t, k_tgt, k_ping, k_relay, record_of, alive, state.epoch,
            collect, trace=tracing,
        )
    else:
        fd_out = _fd_zeros(n, collect, dev, trace=tracing)
    fd_tgt, fd_key, fd_fire, msgs_fd = fd_out[:4]

    # --------------------------------------------- 2. own-record SYNC
    W = min(params.sync_window, n)
    nblocks = (n + W - 1) // W if W else 1
    sync_round = t // p.sync_period_ticks
    wsubj = ((sync_round % nblocks) * W + torch.arange(W, dtype=_I32, device=dev)) % n
    if do_sync:
        sy_out = _sync_fire(
            p, plan, k_ssel, k_slink, record_of, alive, W, wsubj, collect
        )
    else:
        sy_out = _sync_zeros(n, W, collect, dev)
    sy_subj, sy_key, sy_accept, msgs_sync, win_key, win_accept, self_win = sy_out[:7]

    # -------------------------------------- 3. slot free + allocation
    if params.in_scan_writeback:
        if t % params.writeback_period == 0:
            freeing = _free_plan(params, state)
            slot_subj, subj_slot = _write_back(params, state, freeing)
        else:
            freeing = torch.zeros((S,), dtype=torch.bool, device=dev)
            slot_subj, subj_slot = state.slot_subj, state.subj_slot
    else:
        slot_subj, subj_slot = state.slot_subj, state.subj_slot
        freeing = None

    req = torch.zeros((n,), dtype=_I32, device=dev)
    if do_fd:
        req.scatter_reduce_(0, fd_tgt.long(), fd_fire.to(_I32), "amax")
    if do_sync:
        req.scatter_reduce_(0, sy_subj.long(), sy_accept.to(_I32), "amax")
        if W > 0:
            req.scatter_reduce_(0, wsubj.long(), win_accept.any(dim=0).to(_I32), "amax")
    req = req.bool()
    if do_sync and W > 0:
        req = req | _threatened(alive, self_win, state.epoch, state.inc_self)
    # A restarted (or joining) node also requests its own subject's slot,
    # and announces its new identity there.
    slot_subj, subj_slot, free_slots, tgt_slots, new_subjects, n_granted, slot_overflow = (
        _grant_slots(req, slot_subj, subj_slot, params.alloc_cap, fresh_m, join_m)
    )
    slab, age, susp = state.slab, state.age, state.susp
    _load_granted(slab, age, susp, view_T[new_subjects.long()].T, free_slots, tgt_slots)
    active = slot_subj >= 0
    if fresh_m is not None:
        _announce_fresh(slab, age, fresh_m, subj_slot, state.epoch)

    # ------------------------ 4. FD verdict / SYNC learning point lanes
    slab0, age_pre = slab, age
    fd_slot = subj_slot[fd_tgt.long()]
    fd_slot = torch.where(fd_fire & (fd_slot >= 0), fd_slot, -1)
    sy_slot = subj_slot[sy_subj.long()]
    sy_slot = torch.where(sy_accept & (sy_slot >= 0), sy_slot, -1)

    # ------------------------------------------ 5. gossip delivery core
    inv_perm, ginv, rots = fanout_permutations_structured(k_gsel, n, f, dev, group=group)
    lks = prng.split(k_glink, f)
    gpass = [
        link_pass_from(prng.uniform(lks[c], (n,), dev), plan, inv_perm[c], col)
        for c in range(f)
    ]
    edge_ok = torch.stack([alive[inv_perm[c].long()] & gpass[c] for c in range(f)])
    # Knobs: the fan-out cap folds into edge_ok once (delivery, user
    # gossip and accounting see one masked world).
    elive = edge_live(f, knobs)
    if elive is not None:
        edge_ok = edge_ok & elive[:, None]
    susp_fill = suspicion_fill(p.suspicion_ticks, knobs)
    core_args = (slab, age, susp, slot_subj, ginv, rots, edge_ok, alive,
                 fd_slot, sy_slot, fd_key, sy_key)
    consts = dict(spread=p.periods_to_spread, susp_ticks=susp_fill,
                  age_stale=AGE_STALE, sweep=p.periods_to_sweep)
    if use_kernel:
        slab2, age, susp, self_rumor, aggr = sparse_core(*core_args, **consts)
    else:
        slab2, age, susp, self_rumor, aggr, *expired = sparse_core_reference(
            *core_args, **consts, group=group, expiry=tracing
        )
    # Per-slot aggregates (what the 'wb_mask' / 'view_rows' folds consume),
    # plus the corrections of the post-core steps below.
    pin, seen_s, seen_d = _aggr_flags(aggr)

    # ---------------------------------- 6.5 window SYNC application
    if do_sync and W > 0:
        pin, seen_s, seen_d = _window_sync_apply(
            slab2, age, susp, subj_slot, wsubj, win_key, win_accept, alive, susp_fill,
            pin, seen_s, seen_d)

    # ---------------------------------------------- 7. self-refutation
    inc_self, pin = _self_refute(slab2, age, torch.maximum(self_rumor, self_win), subj_slot,
                                 alive, state.inc_self, state.epoch, pin)

    # --------------------------------------------------- 8. user gossip
    if state.uinf_ids.shape[2] > 0:
        new_seen, uage, uinf_ids, uptr, msgs_user = user_gossip_step_tracked(
            state.useen, state.uage, state.uinf_ids, state.uptr, inv_perm,
            edge_ok, alive, p.periods_to_spread, p.periods_to_sweep,
            perm=perm_from_structured(ginv, rots, n, group=group), edge_live=elive,
        )
    else:
        new_seen, uage, msgs_user = user_gossip_step(
            state.useen, state.uage, inv_perm, edge_ok, alive,
            p.periods_to_spread, p.periods_to_sweep, edge_live=elive,
        )
        uinf_ids, uptr = state.uinf_ids, state.uptr

    # ------------------------------ 9. verdict-latency recorder
    tick = state.tick + 1
    lat_s, lat_d = state.lat_first_suspect, state.lat_first_dead
    if lat_s is not None:
        if "view_rows" not in fold:
            seen_s, seen_d = _seen_in_slab(slab2, alive)
        lat_s, lat_d = _record_latency(lat_s, lat_d, seen_s, seen_d, subj_slot, tick)

    # ------------------------------ 9.5 causal flight recorder
    ring = state.trace
    if ring is not None:
        ring = _emit_tick(ring, t, n, col, fd_tgt, fd_fire, fd_out[-3:], sy_accept, sy_subj,
                          alive, active, slot_subj, slab0, slab2, expired[0], new_seen,
                          state.useen)

    # The pin mask is carried only under the 'wb_mask' fold; else it is
    # flagged stale and the next free decision recomputes it.
    carry = state.wb_pinned is not None and "wb_mask" in fold
    new_state = state.replace(
        slot_subj=slot_subj,
        subj_slot=subj_slot,
        slab=slab2,
        age=age,
        susp=susp,
        inc_self=inc_self,
        useen=new_seen,
        uage=uage,
        uinf_ids=uinf_ids,
        uptr=uptr,
        tick=tick,
        rng=rng_next,
        t_host=t,
        lat_first_suspect=lat_s,
        lat_first_dead=lat_d,
        wb_pinned=pin if carry else state.wb_pinned,
        wb_valid=None if state.wb_valid is None else torch.full_like(state.wb_valid, carry),
        trace=ring,
    )
    if not collect:
        return new_state, {"tick": tick}

    # The post-point sender view, rebuilt for the counters only.
    cell_fd = srange[None, :] == fd_slot[:, None]
    cell_sy = srange[None, :] == sy_slot[:, None]
    slab_send = torch.where(
        cell_sy, sy_key[:, None], torch.where(cell_fd, fd_key[:, None], slab0)
    )
    age_send = torch.where(cell_sy | cell_fd, 0, age_pre.to(_I32))
    sender_active = (
        (age_send < p.periods_to_spread) & active[None, :] & (slab_send >= 0)
    ).any(dim=1)
    g_att = []
    g_acct = _acct_zero(dev)
    for c in range(f):
        src = inv_perm[c].long()
        att = sender_active[src] & alive[src] & (inv_perm[c] != col)
        if elive is not None:
            att = att & elive[c]
        g_att.append(att)
        g_acct = _acct_add(
            g_acct, _link_acct(att, edge_blocked(plan, inv_perm[c], col), gpass[c])
        )
    parts = {
        **_view_partials(slab0, slab2, alive, active, new_seen, state.useen, win_accept),
        **_link_partials(fd_out, sy_out, g_acct),
        "msgs_gossip": sum(_count(m) for m in g_att),
        "msgs_user": msgs_user,
    }
    zero = torch.zeros((), dtype=_I32, device=dev)
    metrics = _tick_metrics(
        tick, parts, n_active_slots=_count(active), slot_overflow=slot_overflow,
        slot_activations=n_granted, slot_frees=_count(freeing) if freeing is not None else zero,
        inc_max=inc_self.max(), epoch_max=state.epoch.max(),
        # Elastic membership: the tick's join activations and the
        # live-member gauge (zero on a fixed-shape cluster).
        joins_admitted=_count(join_m) if join_m is not None else zero,
        n_live=_count(new_state.live_mask) if new_state.live_mask is not None else zero,
    )
    if ring is not None:
        # Lossless ring accounting: events the bounded ring could not hold.
        metrics["trace_overflow"] = ring.overflow
    return new_state, metrics


def run_sparse_ticks(
    params: SparseParams,
    state: SparseState,
    plan,
    n_ticks: int,
    collect: bool = True,
    knobs: Knobs | None = None,
):
    """Run ``n_ticks`` ticks. Returns ``(state, traces)``: per-key device
    tensors stacked along a leading tick axis. ``plan`` is a
    :class:`FaultPlan` or a :class:`FaultSchedule` resolved per global tick
    (sim/schedule.py); scheduled collected traces add ``plan_dirty``,
    ``kills_fired``, ``restarts_fired`` and, with a world, the ``zone_*``
    gauges. With ``params.in_scan_writeback=False`` it never frees slots —
    use :func:`run_sparse_chunked` or call :func:`writeback_free` between
    runs. An elastic state (``live_mask``) fires the schedule's joins too
    and its collected traces add ``joins_fired``. Consumes ``state``."""
    scheduled = check_plan(plan)
    # Elastic states fire the schedule's join lane too.
    elastic = state.live_mask is not None
    extra = ScheduleTraces(plan, joins=elastic) if scheduled and collect else None
    per_tick = []
    for _ in range(n_ticks):
        plan_t, events = plan, None
        if scheduled:
            plan_t, events = scheduled_inputs(
                plan, state.t_host + 1, params.base.n, state.device, extra, joins=elastic
            )
        state, metrics = sparse_tick(
            params, state, plan_t, collect=collect, events=events, knobs=knobs
        )
        if extra is not None:
            extra.add_view(lambda w: _zone_counts(w, state))
        per_tick.append(metrics)
    if not per_tick:
        return state, {}
    traces = stack_ticks(per_tick)
    if extra is not None:
        traces = extra.finish(traces, state.device)
    return state, traces


def _zone_counts(world, state: SparseState) -> torch.Tensor:
    """The zone gauges' per-viewer counts of :func:`effective_view`, built
    in blocks of viewer rows so no [N, N] view is materialised."""
    n = state.alive.shape[0]
    s = state.subj_slot
    loaded = (s >= 0)[None, :]
    safe = torch.clamp_min(s, 0).long()
    parts = []
    for r0 in range(0, n, ZONE_ROW_BLOCK):
        r1 = min(n, r0 + ZONE_ROW_BLOCK)
        rows = torch.where(loaded, state.slab[r0:r1][:, safe], state.view_T[:, r0:r1].T)
        parts.append(zone_pair_counts(world, rows, state.alive, state.epoch, row0=r0))
    return torch.cat(parts, dim=1)


def writeback_free(params: SparseParams, state: SparseState) -> SparseState:
    """Free done slots and write their columns back to ``view_T`` — the
    host-boundary twin of the in-tick write-back (same pin rule, same
    tombstone demotion). ``view_T`` is updated IN PLACE, row by freed row:
    the [N, N] table is never copied, which is what lets 32k members run on
    one card. Reads the freed-slot list back to the host (one sync)."""
    freeing = _free_plan(params, state)
    slot_subj, subj_slot = _write_back(params, state, freeing)
    return _invalidate_wb(state).replace(slot_subj=slot_subj, subj_slot=subj_slot)


def run_sparse_chunked(
    params: SparseParams,
    state: SparseState,
    plan,
    n_ticks: int,
    chunk: int = 48,
    collect: bool = True,
    knobs: Knobs | None = None,
):
    """Run in chunks with host-boundary slot frees between them (the big-n
    driver; requires ``in_scan_writeback=False``). Returns ``(state,
    traces)`` with traces as numpy arrays, leading axis ``n_ticks``;
    ``{}`` under ``collect=False``. A :class:`FaultSchedule` is keyed by
    global ticks, so chunk boundaries never re-phase it."""
    if params.in_scan_writeback:
        raise ValueError("use in_scan_writeback=False with the chunked runner")
    whole, tail = divmod(n_ticks, chunk)
    pieces = []
    for length in [chunk] * whole + ([tail] if tail else []):
        state, tr = run_sparse_ticks(params, state, plan, length, collect=collect, knobs=knobs)
        state = writeback_free(params, state)
        if collect:
            pieces.append({k: v.cpu().numpy() for k, v in tr.items()})
    if not pieces:
        return state, {}
    return state, {
        k: np.concatenate([pc[k] for pc in pieces], axis=0) for k in pieces[0]
    }


def effective_view(state: SparseState) -> torch.Tensor:
    """The logical [N_viewer, N_subject] view (slab overlaying view_T) —
    introspection helper, O(N²); small n only."""
    s = state.subj_slot
    return torch.where(
        (s >= 0)[None, :], state.slab[:, torch.clamp_min(s, 0).long()], state.view_T.T
    )
