"""Explicit-SPMD sparse engine: the tick written per member shard, with
every cross-shard interaction an explicit collective (port of
scalecube_cluster_tpu/parallel/spmd.py).

Each of ``d`` shards owns its ``[N/d, S]`` slab / age / suspicion block,
its viewer columns of ``view_T`` and its member vectors (parallel/mesh.py).
Three exchanges a tick, as in the reference:

- **member scalars**: one all-gather each of the ``[N/d]`` ``alive`` and
  ``epoch`` vectors;
- **SYNC replies**: each shard answers every requester whose partner it
  owns with a ``[d, N/d, 1+W]`` reply buffer, slotted by the requester's
  row, exchanged in one all-to-all;
- **gossip fan-out rows**: whole sender-group blocks packed into
  per-(channel, destination shard) buckets of ``bucket_groups`` groups
  (default ``N/(d·group)``, the lossless maximum,
  ops/delivery.py::shard_group_routing), exchanged in one all-to-all.
  Blocks past a smaller capacity are dropped and counted in
  ``exchange_overflow``.

The shard-local tick is written once over a leading shard axis of local
size ``dl`` and runs two ways (:class:`Collectives`):

- ``dl = d`` in one process on one device, the torch form of the
  reference's ``d`` devices under ``shard_map``: the all-gather is a
  reshape of ``[d, nl]`` to ``[N]``, each all-to-all a swap of the first
  two axes of ``[d_src, d_dst, ...]`` (a view), the sums and maxima over
  shards are already taken over the local axis;
- ``dl = 1`` per ``torch.distributed`` rank: ``all_gather_single``,
  ``all_to_all_single`` and ``all_reduce`` (SUM, MAX).

Every draw is made at the full ``[N]`` shape and sliced to the shard's
rows (the reference's presample/slice rule), merges are integer maxima and
boolean ORs, and every counter is an integer partial sum, so the engine is
bit-equal to the reference's ``run_sparse_ticks_spmd`` and to the
single-device engine.

The tick's ``[N/d, S]`` core runs per shard: the plain core
(ops/sparse_core.py::sparse_core_reference, the XLA chain), or, with
``pallas_core=True``, the fused kernel's shard mode (csrc/sparse_core.cu),
launched once a tick for all shards (and all universes of the ensemble
twin): the receiver assembles its senders' un-rotated blocks from the
bucket exchange into ``[f·nl, S]`` windows with an identity routing table,
and ``row_base`` keeps own-lane detection on global ids. The FD / SYNC
point updates are applied before the exchange (the windows carry
post-point rows), and the core applies none to windows. Knobbed runs keep
the kernel: it arms countdowns with a sentinel that is then replaced by the
run's suspicion fill (the reference drops the countdown folds there; the
values agree). The steps after the exchanges are the single-device tick's
own (sim/sparse.py), over the shards' rows.

Cadence and the data-dependent conds are host branches, as in the
single-device engine: every rank takes the same branch, so the collectives
stay matched. The SYNC reply exchange runs on SYNC ticks only (its result
is unused on the others).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from scalecube_cluster_tpu_torch import prng
from scalecube_cluster_tpu_torch.obs.tracer import (
    ShardTraceRing,
    TK_KILL,
    TK_RESTART,
    shard_local_ring,
    shard_rewrap_ring,
    trace_emit,
    trace_reset_members,
)
from scalecube_cluster_tpu_torch.ops.delivery import (
    GROUP,
    shard_group_routing,
    structured_fanout_draw,
)
from scalecube_cluster_tpu_torch.ops.merge import UNKNOWN_KEY
from scalecube_cluster_tpu_torch.ops.sparse_core import (
    SPARSE_GROUP,
    sparse_core,
    sparse_core_reference,
)
from scalecube_cluster_tpu_torch.parallel.mesh import (
    AXIS,
    UNIVERSE_AXIS,
    Mesh,
    all_gather_single,
    shard_sparse_state,
    wire_dtype,
    unshard_sparse_state,
)
from scalecube_cluster_tpu_torch.sim.ensemble import index_universe
from scalecube_cluster_tpu_torch.sim.faults import edge_blocked, link_pass_from
from scalecube_cluster_tpu_torch.sim.knobs import Knobs, edge_live, suspicion_fill
from scalecube_cluster_tpu_torch.sim.run import check_plan
from scalecube_cluster_tpu_torch.sim.schedule import host_events_at, plan_at, plan_dirty_at
from scalecube_cluster_tpu_torch.sim.sparse import (
    ShardRows,
    SparseParams,
    SparseState,
    _aggr_flags,
    _announce_fresh,
    _count,
    _emit_tick,
    _fd_decide,
    _fd_zeros,
    _grant_slots,
    _holding,
    _link_partials,
    _load_granted,
    _record_latency,
    _reset_event_rows,
    _seen_in_slab,
    _self_refute,
    _swept_columns,
    _sync_fire,
    _sync_zeros,
    _threatened,
    _tick_metrics,
    _view_partials,
    _window_sync_apply,
)
from scalecube_cluster_tpu_torch.sim.state import AGE_STALE
from scalecube_cluster_tpu_torch.sim.tick import _acct_add, _acct_zero, _link_acct
from scalecube_cluster_tpu_torch.sim.usergossip import ring_record, user_gossip_finish

_I32 = torch.int32
#: The countdown the kernel arms in a knobbed run, replaced by the run's
#: suspicion fill after the launch (countdowns are never negative).
_FILL_SENTINEL = -1


@dataclass(frozen=True)
class ShardConfig:
    """Static layout of the explicit-SPMD engine.

    ``d``             — member shards (the mesh's ``members`` size).
    ``bucket_groups`` — per-(channel, destination shard) gossip bucket
                        capacity in sender groups; None selects the
                        lossless maximum ``N / (d · group)``. Smaller
                        values bound the exchange and drop overflowing
                        blocks (counted in ``exchange_overflow``): a
                        measurement knob and the negative test's hook.
    """

    d: int
    bucket_groups: int | None = None


def _sparse_group(n: int) -> int:
    """The tick's sender-group size (sparse_tick's choice)."""
    return SPARSE_GROUP if n % SPARSE_GROUP == 0 else GROUP


def _validate(params: SparseParams, cfg: ShardConfig) -> None:
    """The reference's refusals (spmd.py:155-189)."""
    n = params.base.n
    group = _sparse_group(n)
    if params.pallas_core:
        if group != SPARSE_GROUP:
            raise ValueError(
                f"pallas_core under explicit SPMD needs n={n} to be a "
                f"multiple of {SPARSE_GROUP} (the fused kernel's 32-row "
                "sender groups; smaller n falls back to group-8 fan-out, "
                "which the int8 age windows cannot tile — set "
                "pallas_core=False)"
            )
        if params.slot_budget % 128 != 0 or params.slot_budget >= 4096:
            raise ValueError(
                "pallas_core under explicit SPMD needs a kernel-tileable "
                "slot budget (S % 128 == 0 and S < 4096), got "
                f"S={params.slot_budget} — set pallas_core=False or "
                "resize slot_budget"
            )
    if not params.in_scan_writeback:
        raise ValueError(
            "explicit-SPMD needs in_scan_writeback=True (the host-boundary "
            "free path re-shards between chunks)"
        )
    if n % (cfg.d * group) != 0:
        raise ValueError(
            f"n={n} must divide into d={cfg.d} shards of whole "
            f"group-{group} sender blocks (n % (d*group) == 0)"
        )
    if _bucket_cap(params, cfg) < 1:
        raise ValueError(f"bucket_groups={cfg.bucket_groups} must be >= 1")


def _bucket_cap(params: SparseParams, cfg: ShardConfig) -> int:
    ngl = (params.base.n // _sparse_group(params.base.n)) // cfg.d
    return ngl if cfg.bucket_groups is None else cfg.bucket_groups


def exchange_rounds_per_tick() -> int:
    """Cross-shard exchange rounds in one tick: the member-scalar
    all-gather, the SYNC reply all-to-all and the gossip bucket all-to-all
    (the counter sums ride beside them)."""
    return 3


def exchange_payload_bytes_per_tick(params: SparseParams, cfg: ShardConfig) -> dict:
    """Per-shard operand bytes of the three exchanges in one tick, from the
    buffer shapes the tick builds: all-gather ``alive [nl]`` bool + ``epoch
    [nl]`` int32; SYNC replies ``[d, nl, 1+W]`` int32; gossip buckets
    ``[d, f·cap, group, S+G]`` int32."""
    _validate(params, cfg)
    p = params.base
    n, d = p.n, cfg.d
    nl = n // d
    group = _sparse_group(n)
    cap_b = _bucket_cap(params, cfg)
    w = min(params.sync_window, n)
    gather = nl * 1 + nl * 4
    sync = d * nl * (1 + w) * 4
    gossip = d * p.gossip_fanout * cap_b * group * (params.slot_budget + p.user_gossip_slots) * 4
    return {
        "all_gather_bytes": gather,
        "sync_all_to_all_bytes": sync,
        "gossip_all_to_all_bytes": gossip,
        "total_bytes": gather + sync + gossip,
    }


class Collectives:
    """The tick's cross-shard operations over the ``dl`` shards a process
    runs (leading axis of every local array): all ``d`` of them in one
    process (``group`` None), or one per ``torch.distributed`` rank."""

    def __init__(self, mesh: Mesh):
        self.d = mesh.d
        self.local = mesh.local
        self.first = mesh.first
        self.group = mesh.group

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """``[dl, nl, ...]`` shard rows → the full ``[N, ...]`` on every
        shard (the all-gather)."""
        if self.group is not None:
            import torch.distributed as dist

            wire = wire_dtype(x.contiguous())
            out = torch.empty((self.d,) + tuple(wire.shape[1:]), dtype=wire.dtype,
                              device=wire.device)
            all_gather_single(dist)(out, wire, group=self.group)
            x = out.to(x.dtype)
        return x.reshape((-1,) + tuple(x.shape[2:]))

    def swap(self, x: torch.Tensor) -> torch.Tensor:
        """``[dl, d, ...]`` (this shard's block for each destination) →
        ``[dl, d, ...]`` (each source's block for this shard): the
        all-to-all. A view of ``x`` when every shard is local."""
        if self.group is None:
            return x.transpose(0, 1)
        import torch.distributed as dist

        out = torch.empty_like(x[0])
        dist.all_to_all_single(out, x[0].contiguous(), group=self.group)
        return out[None]

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """Integer partial sums over this process's shards → totals."""
        return self._reduce(x, "SUM")

    def max(self, x: torch.Tensor) -> torch.Tensor:
        return self._reduce(x, "MAX")

    def _reduce(self, x: torch.Tensor, op: str) -> torch.Tensor:
        if self.group is None:
            return x
        import torch.distributed as dist

        y = x.clone()
        dist.all_reduce(y, op=getattr(dist.ReduceOp, op), group=self.group)
        return y


def _apply_events_local(st, kill_mask, restart_mask, cut, col, rings):
    """sim/sparse.py::apply_events_sparse on the shards' rows: row-indexed
    leaves take their slices of the ``[N]`` masks, the suppression-ring
    scrub reads the full restart mask with global ids. Each shard's ring
    records the kills and restarts of its own members (the union over
    shards is the single-device emission); the causal registers reset on
    the full restart mask."""
    km, rm = cut(kill_mask), cut(restart_mask)
    st = _reset_event_rows(st, km, rm, restart_mask)
    if st.wb_valid is not None:
        st = st.replace(wb_valid=torch.zeros_like(st.wb_valid))
    if rings is not None:
        t_ev = st.t_host + 1
        out = []
        for i, ring in enumerate(rings):
            ring, _ = trace_emit(ring, TK_KILL, km[i], t_ev, -1, col[i])
            ring, _ = trace_emit(ring, TK_RESTART, rm[i], t_ev, -1, col[i])
            out.append(trace_reset_members(ring, restart_mask))
        rings = out
    return st, rings


def _free_plan_spmd(params, state, col, coll):
    """sim/sparse.py::_free_plan with the any-over-viewers pin reduced
    across shards. Returns the replicated ``freeing [S]``. A valid carried
    pin mask (replicated) stands in for the recompute; the cross-process
    sum of identical copies keeps it (``d·v > 0`` iff ``v``)."""
    p = params.base
    active = state.slot_subj >= 0
    hold_part = _holding(p, state, col[..., None] == state.slot_subj).flatten(0, 1).any(dim=0)
    if state.wb_pinned is not None and params.pallas_core and "wb_mask" in params.pallas_fold:
        hold_part = torch.where(state.wb_valid, state.wb_pinned, hold_part)
    pinned = coll.sum(hold_part.to(_I32)) > 0
    return active & ~pinned


def _write_back_spmd(params, state, freeing, col):
    """Scatter the freed slots' shard columns into the shards' ``view_T``
    rows IN PLACE (tombstones past the sweep deadline demoted to UNKNOWN,
    a subject's own row keeping its tombstone) and clear the slot tables.
    Reads the freed-slot list back to the host once, as the single-device
    write-back does."""
    p = params.base
    idx = torch.nonzero(freeing).flatten()
    slot_subj, subj_slot = state.slot_subj, state.subj_slot
    if idx.numel():
        subj = slot_subj[idx]
        cols = _swept_columns(p, state.slab[..., idx], state.age[..., idx], col[..., None] == subj)
        state.view_T[:, subj.long(), :] = cols.transpose(1, 2)
        subj_slot = subj_slot.clone()
        subj_slot[subj.long()] = -1
        slot_subj = torch.where(freeing, -1, slot_subj)
    return slot_subj, subj_slot


def _tick_spmd(params, cfg, coll, state, plan, collect=True, events=None, knobs=None):
    """One gossip period on this process's shards — sparse_tick around the
    three exchanges. A generator: on the kernel route it yields the core's
    ``(args, kwargs)`` once and takes the kernel's outputs back (so the
    ensemble twin can launch every universe's shards at once); it returns
    ``(state, metrics)``, the metrics totals over all shards. Consumes
    ``state`` (the slab load and the write-back update its leaves in
    place)."""
    p = params.base
    n, S = p.n, params.slot_budget
    d, dl, first = cfg.d, coll.local, coll.first
    nl = n // d
    group = _sparse_group(n)
    ngl = nl // group
    cap_b = _bucket_cap(params, cfg)
    f = p.gossip_fanout
    dev = state.device
    qa = torch.arange(dl, device=dev)
    q = qa + first  # global shard ids
    lo = (q * nl).to(_I32)
    lrow = torch.arange(nl, dtype=_I32, device=dev)
    col = lo[:, None] + lrow  # [dl, nl] global member ids of my rows

    def cut(a):
        return a.reshape((d, nl) + tuple(a.shape[1:]))[first : first + dl]

    # Per-shard flight recorder: each shard's ring row runs the
    # single-device emission code on its own rows (views of the stack).
    tracing = state.trace is not None
    rings = [shard_local_ring(state.trace, i) for i in range(dl)] if tracing else None

    restart_m = None
    if events is not None:
        state, rings = _apply_events_local(state, events[0], events[1], cut, col, rings)
        restart_m = events[1]
    t = state.t_host + 1
    rng_next, k_tgt, k_ping, k_relay, k_gsel, k_glink, k_ssel, k_slink = prng.split(state.rng, 8)
    srange = torch.arange(S, dtype=_I32, device=dev)
    alive = state.alive  # [dl, nl]

    # Exchange 1/3 — member scalars: the probe / ack answering channel.
    alive_all = coll.gather(alive)
    epoch_all = coll.gather(state.epoch)
    do_fd = t % p.fd_period_ticks == 0
    do_sync = t % p.sync_period_ticks == 0
    subj_slot0, slab_in, view_T_in = state.subj_slot, state.slab, state.view_T

    # FD and SYNC decide on the shards' rows flattened to [dl·nl]: the
    # draws and the edge lookups then have the reference's per-shard
    # ranks ([nl] and [nl, k]), on which XLA:CPU's loss composition
    # depends (sim/faults.py::edge_loss, ROADMAP Queue C).
    nf = dl * nl
    frow = torch.arange(nf, dtype=_I32, device=dev)  # local row q·nl + r

    def record_of(rows, subject):
        """My rows' records of ``subject`` (global ids) through the slab
        indirection; ``rows`` are flat local rows, broadcast against it."""
        subject = subject.long()
        qi, v = (rows // nl).long(), (rows % nl).long()
        s = subj_slot0[subject]
        from_slab = slab_in[qi, v, torch.clamp_min(s, 0).long()]
        return torch.where(s >= 0, from_slab, view_T_in[qi, subject, v])

    def cut_flat(a):
        return cut(a).reshape((nf,) + tuple(a.shape[1:]))

    def unflat(out):
        return tuple(x.reshape((dl, nl) + tuple(x.shape[1:])) if x.dim() and x.shape[0] == nf
                     else x for x in out)

    rows = ShardRows(frow, col.reshape(nf), cut_flat, alive_all, epoch_all)

    # ------------------------------------------------------------- 1. FD
    if do_fd:
        fd_out = unflat(_fd_decide(p, plan, t, k_tgt, k_ping, k_relay, record_of,
                                   alive.reshape(nf), state.epoch.reshape(nf), collect,
                                   trace=tracing, shard=rows))
    else:
        fd_out = _fd_zeros((dl, nl), collect, dev, trace=tracing)
    fd_tgt, fd_key, fd_fire, msgs_fd = fd_out[:4]

    # ------------------------------------------------ 2. own-record SYNC
    W = min(params.sync_window, n)
    nblocks = (n + W - 1) // W if W else 1
    sync_round = t // p.sync_period_ticks
    wsubj = ((sync_round % nblocks) * W + torch.arange(W, dtype=_I32, device=dev)) % n

    def partner_records(prt_full, prt):
        # Exchange 2/3 — the SYNC replies: each shard answers every
        # requester whose partner is one of its rows, slotted by the
        # requester's row (a shard hosts exactly nl requesters, so the
        # capacity is structural).
        rep = record_of(frow, col.reshape(nf))[..., None]
        if W > 0:
            rep = torch.cat([rep, record_of(frow[:, None], wsubj[None, :])], dim=-1)
        rep = rep.reshape(dl, nl, -1)
        pr = prt_full.reshape(d, nl)  # requesters grouped by their shard
        mine = (pr // nl) == q[:, None, None]  # [dl, d, nl]
        idx = torch.where(mine, pr - lo[:, None, None], 0).long()
        send = torch.where(mine[..., None], rep[qa[:, None, None], idx], UNKNOWN_KEY)
        recv = coll.swap(send)  # [dl, d_src, nl, 1+W]
        got = recv[qa[:, None], (prt.reshape(dl, nl) // nl).long(), lrow.long()].reshape(nf, -1)
        return got[:, 0], got[:, 1:]

    if do_sync:
        sy_out = unflat(_sync_fire(p, plan, k_ssel, k_slink, record_of, alive.reshape(nf), W,
                                   wsubj, collect, shard=rows, partner_records=partner_records))
    else:
        sy_out = _sync_zeros((dl, nl), W, collect, dev)
    sy_subj, sy_key, sy_accept, msgs_sync, win_key, win_accept, self_win = sy_out[:7]

    # ----------------------------------------- 3. slot free + allocation
    if t % params.writeback_period == 0:
        freeing = _free_plan_spmd(params, state, col, coll)
        slot_subj, subj_slot = _write_back_spmd(params, state, freeing, col)
    else:
        freeing = torch.zeros((S,), dtype=torch.bool, device=dev)
        slot_subj, subj_slot = state.slot_subj, state.subj_slot
    view_T = state.view_T

    # Activation requests: local scatters into an [N] partial, OR-ed
    # across shards; the grant ranking then runs replicated.
    req = torch.zeros((n,), dtype=_I32, device=dev)
    if do_fd:
        req.scatter_reduce_(0, fd_tgt.flatten().long(), fd_fire.flatten().to(_I32), "amax")
    if do_sync:
        req.scatter_reduce_(0, sy_subj.flatten().long(), sy_accept.flatten().to(_I32), "amax")
        if W > 0:
            req.scatter_reduce_(0, wsubj.long(), win_accept.flatten(0, 1).any(dim=0).to(_I32),
                                "amax")
            self_threat_pre = _threatened(alive, self_win, state.epoch, state.inc_self)
            req.scatter_reduce_(0, col.flatten().long(), self_threat_pre.flatten().to(_I32),
                                "amax")
    req = coll.sum(req) > 0
    slot_subj, subj_slot, free_slots, tgt_slots, new_subjects, n_granted, slot_overflow = (
        _grant_slots(req, slot_subj, subj_slot, params.alloc_cap, restart_m)
    )
    # Load the granted subjects' columns (my viewer columns) in place.
    slab, age, susp = state.slab, state.age, state.susp
    _load_granted(slab, age, susp, view_T[:, new_subjects.long(), :].transpose(1, 2),
                  free_slots, tgt_slots)
    active = slot_subj >= 0
    own_slot = subj_slot[col.long()]
    if restart_m is not None:
        _announce_fresh(slab, age, cut(restart_m), own_slot, state.epoch)

    # ------------------------------ 4. FD verdicts + SYNC learnings
    slab0 = slab
    fd_slot = subj_slot[fd_tgt.long()]
    fd_slot = torch.where(fd_fire & (fd_slot >= 0), fd_slot, -1)
    sy_slot = subj_slot[sy_subj.long()]
    sy_slot = torch.where(sy_accept & (sy_slot >= 0), sy_slot, -1)
    if do_fd or do_sync:
        cell_fd = srange == fd_slot[..., None]
        cell_sy = srange == sy_slot[..., None]
        slab = torch.where(cell_sy, sy_key[..., None], torch.where(cell_fd, fd_key[..., None], slab))
        age = torch.where(cell_sy | cell_fd, 0, age).to(torch.int8)

    # ------------------------------------------------- 5. gossip delivery
    # Replicated routing tables (full-shape draws), then exchange 3/3:
    # whole sender-group blocks in per-(channel, destination) buckets.
    ginv, rots = structured_fanout_draw(k_gsel, n, f, dev, group)
    lks = prng.split(k_glink, f)
    u_full = [prng.uniform(lks[c], (n,), dev) for c in range(f)]
    elive = edge_live(f, knobs)
    susp_fill = suspicion_fill(p.suspicion_ticks, knobs)
    susp_in, age_in = susp, age
    dest, rank = shard_group_routing(ginv, d)  # [f, d, ngl]
    dest_l, rank_l = dest[:, first : first + dl], rank[:, first : first + dl]

    young = age < p.periods_to_spread
    rows_send = torch.where(young & active, slab, UNKNOWN_KEY)
    G = state.useen.shape[-1]
    tracked = state.uinf_ids.shape[-1] > 0
    urows = state.useen & (state.uage < p.periods_to_spread)
    gfwd = torch.argsort(ginv.long(), dim=1)
    bg = (col // group).long()
    rcv_c, ug_send_c = [], []
    msgs_user = torch.zeros((G,), dtype=_I32, device=dev)
    for c in range(f):
        g_r = gfwd[c][bg]  # receiver group of my rows
        rcv = (group * g_r + (col - rots[c][g_r]) % group).to(_I32)
        rcv_c.append(rcv)
        sends = alive & (rcv != col)
        if tracked:
            known = (state.uinf_ids == rcv[..., None, None]).any(dim=-1)
            s_c = urows & ~known & sends[..., None]
            if elive is not None:
                s_c = s_c & elive[c]
            ug_send_c.append(s_c)
            msgs_user = msgs_user + s_c.flatten(0, 1).sum(dim=0, dtype=_I32)
        else:
            # The receiver applies the delivery mask; messages count
            # sender-side (a bijection: the single-device sum).
            ug_send_c.append(urows)
            m_c = urows & sends[..., None]
            if elive is not None:
                m_c = m_c & elive[c]
            msgs_user = msgs_user + m_c.flatten(0, 1).sum(dim=0, dtype=_I32)

    # Pack: [dl, d (+1 pad), f·cap, group, S+G]; a block past the bucket
    # capacity goes to the pad row, which is never sent.
    buf = torch.full((dl, d + 1, f * cap_b, group, S + G), UNKNOWN_KEY, dtype=_I32, device=dev)
    overflow_part = torch.zeros((), dtype=_I32, device=dev)
    for c in range(f):
        payload = torch.cat([rows_send, ug_send_c[c].to(_I32)], dim=-1).reshape(
            dl, ngl, group, S + G)
        keep = rank_l[c] < cap_b
        dst = torch.where(keep, dest_l[c], d).long()
        slot = (c * cap_b + torch.clamp_max(rank_l[c], cap_b - 1)).long()
        buf[qa[:, None], dst, slot] = payload
        overflow_part = overflow_part + (~keep).sum(dtype=_I32)
    recv = coll.swap(buf[:, :d])  # [dl, d_src, f·cap, group, S+G]

    # Receiver side: find each expected sender block through the same
    # tables (rank < cap iff it was sent); window rows stay sender-indexed.
    rg = q[:, None] * ngl + torch.arange(ngl, device=dev)  # my receiver groups
    rotv_b = (lrow // group).long()
    got_u = torch.zeros((dl, nl, G), dtype=torch.bool, device=dev)
    uinf_ids, uptr = state.uinf_ids, state.uptr
    edge_ok_c, win_c = [], []
    for c in range(f):
        sg = ginv[c][rg].long()  # sender group feeding each receiver group
        sshard = sg // ngl
        srank = rank[c][sshard, sg % ngl]
        blk = recv[qa[:, None], sshard, (c * cap_b + torch.clamp_max(srank, cap_b - 1)).long()]
        blk = torch.where((srank < cap_b)[..., None, None], blk, UNKNOWN_KEY)
        stag = blk.reshape(dl, nl, S + G)
        rot = rots[c][rg][:, rotv_b]  # per-row rotation of my receiver groups
        within = (col + rot) % group
        r_idx = (rotv_b * group + within).long()
        ug_flags = stag[qa[:, None], r_idx, S:] > 0
        sid = (group * sg[:, rotv_b] + within).to(_I32)  # global sender ids
        e_ok = alive_all[sid.long()] & link_pass_from(cut(u_full[c]), plan, sid, col)
        if elive is not None:
            e_ok = e_ok & elive[c]
        edge_ok_c.append(e_ok)
        win_c.append(stag[..., :S])
        if tracked:
            arrived = ug_flags & e_ok[..., None] & alive[..., None]
            got_u = got_u | arrived
            uinf_ids, uptr = ring_record(uinf_ids, uptr, arrived, sid)
        else:
            got_u = got_u | (ug_flags & e_ok[..., None])

    # The shard core: one [nl, S] problem per shard, sender rows from the
    # windows (identity routing: channel c, receiver group j → window
    # block c·ngl + j; all-young ages: the young mask was applied
    # sender-side), row_base = the shard's first member.
    use_kernel = params.pallas_core
    kfold = frozenset(params.pallas_fold) - {"points"} if use_kernel else frozenset()
    if knobs is not None:
        kfold = kfold - {"countdown", "wb_mask", "view_rows"}
    need_wb, need_rows = "wb_mask" in kfold, "view_rows" in kfold
    slab_win = torch.cat(win_c, dim=1)
    ident = (torch.arange(f, dtype=_I32, device=dev)[:, None] * ngl
             + torch.arange(ngl, dtype=_I32, device=dev))
    core_args = (
        slab, age, susp_in, slot_subj.expand(dl, S), ident.expand(dl, f, ngl),
        rots[:, rg].transpose(0, 1), torch.stack(edge_ok_c, dim=1), alive,
        fd_slot, sy_slot, fd_key, sy_key,
    )
    core_kw = dict(spread=p.periods_to_spread, susp_ticks=susp_fill, age_stale=AGE_STALE,
                   sweep=p.periods_to_sweep, row_base=lo,
                   slab_windows=slab_win, age_windows=torch.zeros_like(slab_win, dtype=torch.int8))
    expired = None
    if use_kernel:
        if knobs is not None:
            core_kw["susp_ticks"] = _FILL_SENTINEL
        slab2, age2, susp2, self_rumor, aggr = yield (
            tuple(a.contiguous() for a in core_args), core_kw)
        if knobs is not None:
            susp2 = torch.where(susp2 == _FILL_SENTINEL, susp_fill, susp2).to(torch.int16)
    else:
        slab2, age2, susp2, self_rumor, aggr, *expired = sparse_core_reference(
            *core_args, **core_kw, group=group, expiry=tracing)
    age = age2

    pin, seen_s, seen_d = _aggr_flags(aggr)

    # ----------------------------------- 6.5 window SYNC application
    if do_sync and W > 0:
        pin, seen_s, seen_d = _window_sync_apply(
            slab2, age, susp2, subj_slot, wsubj, win_key, win_accept, alive, susp_fill,
            pin, seen_s, seen_d)

    # ---------------------------------------------- 7. self-refutation
    inc_self, pin = _self_refute(slab2, age, torch.maximum(self_rumor, self_win), own_slot,
                                 alive, state.inc_self, state.epoch, pin)

    # --------------------------------------------------- 8. user gossip
    if tracked:
        new_seen, uage, swept = user_gossip_finish(state.useen, state.uage, got_u,
                                                   p.periods_to_sweep)
        uinf_ids = torch.where(swept[..., None], -1, uinf_ids)
        uptr = torch.where(swept, 0, uptr)
    else:
        new_seen, uage, _ = user_gossip_finish(state.useen, state.uage, got_u & alive[..., None],
                                               p.periods_to_sweep)

    # ------------------------------ 9. verdict-latency recorder
    lat_s, lat_d = state.lat_first_suspect, state.lat_first_dead
    if lat_s is not None:
        if not need_rows:
            seen_s, seen_d = _seen_in_slab(slab2, alive)
        # Member-centric: my member's slot carries the event iff any live
        # viewer anywhere saw it.
        seen = coll.sum(torch.stack([seen_s, seen_d]).to(_I32)) > 0
        lat_s, lat_d = _record_latency(lat_s, lat_d, seen[0], seen[1], own_slot, t)

    # ------------------------------ 9.5 causal flight recorder
    # The single-device emission on each shard's rows: global ids as
    # actors and subjects, shard-local ring positions. A SYNC accept
    # records the partner's shard in ``aux``; a verdict whose suspicion was
    # recorded on another shard has cause -1 here (merge_shard_rings
    # relinks it).
    trace = state.trace
    if tracing:
        fd_trace = fd_out[-3:]
        trace = shard_rewrap_ring(state.trace, [
            _emit_tick(ring, t, n, col[i], fd_tgt[i], fd_fire[i], tuple(x[i] for x in fd_trace),
                       sy_accept[i], sy_subj[i], alive[i], active, slot_subj, slab0[i],
                       slab2[i], expired[0][i], new_seen[i], state.useen[i],
                       sync_aux=sy_subj[i] // nl)
            for i, ring in enumerate(rings)
        ])

    wb_pinned, wb_valid = state.wb_pinned, state.wb_valid
    if wb_pinned is not None:
        if need_wb:
            # Replicated carry: the next free decision reads it with no
            # exchange.
            wb_pinned = coll.sum(pin.to(_I32)) > 0
            wb_valid = torch.ones_like(wb_valid)
        else:
            wb_valid = torch.zeros_like(wb_valid)

    tick = state.tick + 1
    new_state = state.replace(
        view_T=view_T, slot_subj=slot_subj, subj_slot=subj_slot, slab=slab2, age=age,
        susp=susp2, inc_self=inc_self, useen=new_seen, uage=uage, uinf_ids=uinf_ids,
        uptr=uptr, tick=tick, rng=rng_next, t_host=t, lat_first_suspect=lat_s,
        lat_first_dead=lat_d, wb_pinned=wb_pinned, wb_valid=wb_valid, trace=trace,
    )
    if not collect:
        return new_state, {"tick": tick}

    # Counters: integer partial sums over my rows, totalled across shards.
    sender_active = (
        (age_in < p.periods_to_spread) & active & (slab >= 0)
    ).any(dim=-1)
    g_att_c = []
    g_acct = _acct_zero(dev)
    for c in range(f):
        att = sender_active & alive & (rcv_c[c] != col)
        if elive is not None:
            att = att & elive[c]
        g_att_c.append(att)
        # Sender-side attribution of the draws the receiver consumed.
        g_pass = link_pass_from(u_full[c][rcv_c[c].long()], plan, col, rcv_c[c])
        g_acct = _acct_add(g_acct, _link_acct(att, edge_blocked(plan, col, rcv_c[c]), g_pass))
    parts = {
        **_view_partials(slab0, slab2, alive, active, new_seen, state.useen, win_accept),
        **_link_partials(fd_out, sy_out, g_acct),
        "msgs_gossip": sum(_count(m) for m in g_att_c),
        "msgs_user": msgs_user,
        "exchange_overflow": overflow_part,
    }
    if tracing:
        parts["trace_overflow"] = trace.overflow.sum(dtype=_I32)
    summed = _sum_dict(coll, parts)
    metrics = _tick_metrics(
        tick, summed, n_active_slots=_count(active), slot_overflow=slot_overflow,
        slot_activations=n_granted, slot_frees=_count(freeing),
        inc_max=coll.max(inc_self.max()), epoch_max=coll.max(state.epoch.max()),
        # The one counter the bucketed exchange owns (0 at the default
        # capacity).
        exchange_overflow=summed["exchange_overflow"],
    )
    if tracing:
        metrics["trace_overflow"] = summed["trace_overflow"]
    return new_state, metrics


def _sum_dict(coll: Collectives, parts: dict) -> dict:
    """:meth:`Collectives.sum` of every partial at once (one all-reduce
    over a packed int32 vector on a distributed mesh)."""
    if coll.group is None:
        return parts
    flat = torch.cat([v.reshape(-1).to(_I32) for v in parts.values()])
    flat = coll.sum(flat)
    out, at = {}, 0
    for k, v in parts.items():
        out[k] = flat[at : at + v.numel()].reshape(v.shape)
        at += v.numel()
    return out


def _launch_cores(reqs: list) -> list:
    """The shard core for every universe that asked (``(args, kwargs)``
    each, shards on the leading axis): one :func:`sparse_core` call over
    all of them (``grid.z`` = universes x shards on the card). Returns each
    universe's outputs."""
    if len(reqs) == 1:
        args, kw = reqs[0]
        return [sparse_core(*args, **kw)]
    sizes = [r[0][0].shape[0] for r in reqs]
    args = tuple(torch.cat([r[0][j] for r in reqs]) for j in range(len(reqs[0][0])))
    kw = dict(reqs[0][1])
    for name in ("row_base", "slab_windows", "age_windows"):
        kw[name] = torch.cat([r[1][name] for r in reqs])
    outs = sparse_core(*args, **kw)
    parts = [torch.split(o, sizes) for o in outs]
    return [tuple(part[i] for part in parts) for i in range(len(reqs))]


def _step_all(gens: list) -> list:
    """Run every universe's :func:`_tick_spmd` generator to its end, the
    kernel-route ones through one shared core launch."""
    results, asked = [None] * len(gens), []
    for i, g in enumerate(gens):
        try:
            asked.append((i, next(g)))
        except StopIteration as stop:
            results[i] = stop.value
    if asked:
        for (i, _), out in zip(asked, _launch_cores([req for _, req in asked])):
            try:
                gens[i].send(out)
            except StopIteration as stop:
                results[i] = stop.value
    return results


def _scan_ticks(params, cfg, coll, states: list, plans: list, n_ticks, collect, knobs: list):
    """The ticks of every universe's local state in step (the reference's
    ``_scan_body``, vmapped over universes for the ensemble twin). A
    :class:`FaultSchedule` is resolved per global tick on the host; its
    collected traces add ``plan_dirty``, ``kills_fired`` and
    ``restarts_fired``. Returns the states and each universe's traces
    (device tensors with a leading tick axis)."""
    n = params.base.n
    scheduled = [check_plan(pl) for pl in plans]
    per_tick = [[] for _ in states]
    sched_rows = [[] for _ in states]
    for _ in range(n_ticks):
        gens = []
        for b, st in enumerate(states):
            plan_t, events = plans[b], None
            if scheduled[b]:
                t = st.t_host + 1
                plan_t = plan_at(plans[b], t)
                ev = host_events_at(plans[b], t, n)
                if ev is not None:
                    events = tuple(torch.from_numpy(m).to(st.device) for m in ev)
                if collect:
                    sched_rows[b].append((plan_dirty_at(plans[b], t),
                                          0 if ev is None else int(ev[0].sum()),
                                          0 if ev is None else int(ev[1].sum())))
            gens.append(_tick_spmd(params, cfg, coll, st, plan_t, collect, events, knobs[b]))
        for b, (st, metrics) in enumerate(_step_all(gens)):
            states[b] = st
            per_tick[b].append(metrics)
    traces = []
    for b, st in enumerate(states):
        if not per_tick[b]:
            traces.append({})
            continue
        tr = {k: torch.stack([m[k] for m in per_tick[b]]) for k in per_tick[b][0]}
        if scheduled[b] and collect:
            dirty, kills, restarts = zip(*sched_rows[b])
            tr["plan_dirty"] = torch.tensor(dirty, dtype=torch.bool, device=st.device)
            tr["kills_fired"] = torch.tensor(kills, dtype=_I32, device=st.device)
            tr["restarts_fired"] = torch.tensor(restarts, dtype=_I32, device=st.device)
        traces.append(tr)
    return states, traces


def _check_run(params, cfg, mesh: Mesh, state) -> None:
    if mesh.d != cfg.d:
        raise ValueError(f"mesh needs a '{AXIS}' axis of size d={cfg.d}; got {mesh.shape}")
    _validate(params, cfg)
    if state.trace is None:
        return
    if not isinstance(state.trace, ShardTraceRing):
        raise ValueError(
            "the explicit-SPMD engine needs the SHARDED flight recorder "
            "(a single TraceRing's append cursor is a global sequence "
            "that per-shard emission would fork) — init the state with "
            f"init_sparse_full_view(..., trace_shards={cfg.d})"
        )
    if state.trace.shards != cfg.d:
        raise ValueError(
            f"ShardTraceRing carries {state.trace.shards} per-shard rings but "
            f"the engine runs d={cfg.d} shards — init with trace_shards={cfg.d}"
        )
    if params.pallas_core:
        raise ValueError(
            "flight-recorder tracing requires the XLA tick core: the fused "
            "kernel does not expose the per-cell expiry mask the verdict "
            "events need (set pallas_core=False or drop the trace rings)"
        )


def run_sparse_ticks_spmd(
    params: SparseParams,
    cfg: ShardConfig,
    mesh: Mesh,
    state: SparseState,
    plan,
    n_ticks: int,
    collect: bool = True,
    knobs: Knobs | None = None,
):
    """Run ``n_ticks`` ticks of the explicit-SPMD engine: the sharded twin
    of sim/sparse.py::run_sparse_ticks (same signature plus ``cfg`` and
    ``mesh``). ``state`` is the global state (every rank of a distributed
    mesh passes the same one); the result is the global state on every
    rank, and the traces are the totals over shards. ``plan`` is a
    ``FaultPlan`` or a ``FaultSchedule`` (compact or full
    ``[N, N]`` matrices: edge lookups take any pair). Consumes ``state``:
    with every shard in this process the sharded leaves are views of it
    and the tick updates ``view_T`` and the slab in place. (The
    reference's unjitted driver ``scan_sparse_ticks_spmd`` and its jit
    wrapper are this one function.) Raises
    ``ValueError`` where the reference's engine does (:func:`_validate`,
    the recorder's checks)."""
    _check_run(params, cfg, mesh, state)
    coll = Collectives(mesh)
    (local,), (traces,) = _scan_ticks(params, cfg, coll, [shard_sparse_state(state, mesh)],
                                      [plan], n_ticks, collect, [knobs])
    return unshard_sparse_state(local, mesh), traces


def _universe(local, b: int):
    """Universe ``b`` of a stacked local state: views of its leaves."""
    out = {}
    for fld in dataclasses.fields(local):
        x = getattr(local, fld.name)
        if fld.name == "t_host":
            x = int(np.asarray(x)[b])
        elif x is not None:
            x = x[b]
        out[fld.name] = x
    return dataclasses.replace(local, **out)


def _restack(universes: list, like):
    out = {}
    for fld in dataclasses.fields(like):
        vals = [getattr(u, fld.name) for u in universes]
        if vals[0] is None:
            out[fld.name] = None
        elif fld.name == "t_host":
            out[fld.name] = np.asarray(vals, dtype=np.int64)
        elif isinstance(vals[0], np.ndarray):
            out[fld.name] = np.stack(vals)
        else:
            out[fld.name] = torch.stack(vals)
    return dataclasses.replace(like, **out)


def run_ensemble_sparse_ticks_spmd(
    params: SparseParams,
    cfg: ShardConfig,
    mesh: Mesh,
    states: SparseState,
    plans,
    n_ticks: int,
    collect: bool = True,
    knobs: Knobs | None = None,
):
    """The ensemble twin (a ``universes x members`` mesh,
    parallel/mesh.py::make_universe_member_mesh): ``B`` stacked universes
    (sim/ensemble.py::stack_universes), each run as the explicit-SPMD
    engine over ``d`` member shards, leaves ``[B, d, nl, ...]``; the
    exchanges stay inside a universe and the kernel route launches every
    universe's shards at once. ``plans`` and ``knobs`` are stacked like the
    states; ``B`` must be a multiple of the mesh's universes. Returns the
    stacked states and ``[B, T]`` traces. Trace rings are refused, as in
    the reference."""
    if mesh.d != cfg.d:
        raise ValueError(f"mesh '{AXIS}' axis is {mesh.d}, cfg.d is {cfg.d}")
    _validate(params, cfg)
    if states.trace is not None:
        raise ValueError(
            "the ensemble SPMD twin does not carry the flight recorder "
            "(states.trace must be None) — trace single-universe runs via "
            "run_sparse_ticks_spmd with init_sparse_full_view(trace_shards=d)"
        )
    b_count = int(states.alive.shape[0])
    if b_count % mesh.universes:
        raise ValueError(f"B={b_count} universes do not divide over the "
                         f"'{UNIVERSE_AXIS}' axis of {mesh.universes}")
    local = shard_sparse_state(states, mesh)
    unis = [_universe(local, b) for b in range(b_count)]
    plan_b = [index_universe(plans, b) for b in range(b_count)]
    knob_b = [None if knobs is None else index_universe(knobs, b) for b in range(b_count)]
    unis, traces = _scan_ticks(params, cfg, Collectives(mesh), unis, plan_b, n_ticks, collect,
                               knob_b)
    out = unshard_sparse_state(_restack(unis, local), mesh)
    if not traces[0]:
        return out, {}
    return out, {k: torch.stack([tr[k] for tr in traces]) for k in traces[0]}
