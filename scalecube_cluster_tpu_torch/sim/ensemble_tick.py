"""One tick of B universes at once: the dense and sparse ticks over a
leading universe axis (the port of ``jax.vmap`` over the reference's scan
bodies, sim/ensemble.py).

Every state leaf, plan matrix, knob and metric carries the universe axis
first; universe b of a batched tick is bit-identical to the single tick
(sim/tick.py, sim/sparse.py) on universe b's operands. The work of a tick
is the single tick's sequence of tensor operations, each over all B
universes, so the launches a tick does not grow with B:

- every key of the tick is derived on the host for all universes
  (prng.KeyTable) and uploaded as one tensor; each draw reads a view;
- index operations gather within each universe (``_take``, ``_take2``,
  ops/delivery.py::take_rows) and scatters write within it;
- the fused cores take the universe as a grid axis: one launch of
  csrc/sparse_core.cu or csrc/tick_core.cu for the whole batch.

The cadence branches (FD round, SYNC round, write-back) follow the host
tick, which a batched tick shares across its universes: the runners in
sim/ensemble.py step universes whose tick differs (a fresh state put into
a stack that has run) as separate groups. The dense tick's one data-
dependent branch, "somebody joining", is read once for the whole batch:
when one universe needs the slow core, all take it, and the slow core on
a universe with nobody joining and no SYNC due equals the fast one
(tests/test_torch_ensemble.py pins this).

This module keeps its own batched tick beside the single ticks rather than
running the single tick as a batch of one: the single ticks' index
operations (``x[idx]``) would become gathers over a universe axis and so
change the main paths' launch counts, and the flight recorder, which
ensembles do not take yet (ROADMAP A14), lives only in the single sparse
tick. The batched sparse tick takes the single tick's event lanes: kill,
restart, user-gossip injection and the elastic join (the fleet's tenants,
serve/fleet.py).
"""

from __future__ import annotations

import torch

from scalecube_cluster_tpu_torch import prng
from scalecube_cluster_tpu_torch.cluster_api.member import MemberStatus
from scalecube_cluster_tpu_torch.obs.counters import SHARED_COUNTERS
from scalecube_cluster_tpu_torch.ops.delivery import (
    GROUP,
    deliver_rows_max,
    fanout_permutations,
    fanout_permutations_structured,
    perm_from_structured,
    permuted_delivery_two_channel,
    take_rows,
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
    merge_views,
    overrides_same_epoch,
)
from scalecube_cluster_tpu_torch.ops.select import (
    masked_random_choice,
    masked_random_topk,
    probe_cursor_targets,
)
from scalecube_cluster_tpu_torch.ops.sparse_core import (
    AGGR_DEAD_BIT,
    AGGR_HOLD_BIT,
    AGGR_SUSPECT_BIT,
    SPARSE_GROUP,
    sparse_core,
    sparse_core_reference,
)
from scalecube_cluster_tpu_torch.ops.tick_core import tick_core
from scalecube_cluster_tpu_torch.sim.faults import (
    FaultPlan,
    edge_blocked,
    link_pass_from,
    round_trip_in_time_from,
)
from scalecube_cluster_tpu_torch.sim.knobs import Knobs, edge_live, suspicion_fill
from scalecube_cluster_tpu_torch.sim.sparse import _free_plan as free_plan
from scalecube_cluster_tpu_torch.sim.sparse import sparse_route, sync_accept
from scalecube_cluster_tpu_torch.sim.state import AGE_STALE
from scalecube_cluster_tpu_torch.sim.tick import _acct_add, xla_cpu_sum_f32, xla_row_means_f32
from scalecube_cluster_tpu_torch.sim.usergossip import (
    user_gossip_step,
    user_gossip_step_tracked,
)

_ALIVE = int(MemberStatus.ALIVE)
_SUSPECT = int(MemberStatus.SUSPECT)
_DEAD = int(MemberStatus.DEAD)

_I32 = torch.int32


# ------------------------------------------------------------ batched ops
def _cnt(mask: torch.Tensor) -> torch.Tensor:
    """Per-universe count of a ``[B, ...]`` bool mask, ``[B]`` int32."""
    return mask.flatten(1).sum(dim=1, dtype=_I32)


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[b, idx[b]]`` for ``x [B, L]`` and ``idx`` with a leading axis
    of B or 1; shape ``[B, *idx.shape[1:]]``."""
    b = x.shape[0]
    shape = (b,) + tuple(idx.shape[1:])
    flat = idx.long().expand(shape).reshape(b, -1)
    return torch.gather(x, 1, flat).view(shape)


def _take2(x: torch.Tensor, i: torch.Tensor, j: torch.Tensor) -> torch.Tensor:
    """``x[b, i, j]`` for ``x [B, R, C]`` and broadcast index tensors with
    a leading axis of B or 1."""
    b, c = x.shape[0], x.shape[2]
    i, j = torch.broadcast_tensors(i.long(), j.long())
    shape = (b,) + tuple(i.shape[1:])
    flat = (i * c + j).expand(shape).reshape(b, -1)
    return torch.gather(x.reshape(b, -1), 1, flat).view(shape)


def _pad_scatter(vec: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor, reduce=None):
    """``vec.at[b, idx].set/max(vals, mode="drop")`` for ``idx`` in
    [0, L] where L (= ``vec.shape[1]``) means dropped."""
    pad = torch.cat([vec, vec.new_zeros((vec.shape[0], 1))], dim=1)
    if reduce is None:
        pad.scatter_(1, idx.long(), vals.to(vec.dtype))
    else:
        pad.scatter_reduce_(1, idx.long(), vals.to(vec.dtype), reduce, include_self=True)
    return pad[:, :-1]


def _or_drop(vec: torch.Tensor, idx: torch.Tensor, flags: torch.Tensor) -> torch.Tensor:
    return _pad_scatter(vec.to(_I32), idx, flags.to(_I32), "amax").bool()


def _first_true(mask: torch.Tensor, size: int, fill: int) -> torch.Tensor:
    """Per universe, ``flatnonzero(mask, size=size, fill_value=fill)``."""
    b, n = mask.shape
    rank = torch.cumsum(mask.to(_I32), 1, dtype=_I32) - 1
    dst = torch.where(mask & (rank < size), rank, size)
    out = torch.full((b, size + 1), fill, dtype=_I32, device=mask.device)
    src = torch.arange(n, dtype=_I32, device=mask.device).expand(b, n)
    out.scatter_(1, dst.long(), src)
    return out[:, :size]


def _column_writer(cols: torch.Tensor, route: torch.Tensor, width: int):
    """sim/sparse.py::_column_writer per universe: ``x.at[b, :, route].set(
    v, mode="drop")`` on ``[B, N, width]`` arrays, every entry writing
    column ``cols[b, k]`` with the value the column finally holds."""
    b, k = cols.shape
    src = torch.full((b, width + 1), -1, dtype=torch.int64, device=cols.device)
    src.scatter_(1, route.long(), torch.arange(k, device=cols.device).expand(b, k))
    hit = torch.gather(src, 1, cols.long())
    has = (hit >= 0)[:, None, :]
    kk = torch.clamp_min(hit, 0)[:, None, :]
    cl = cols.long()[:, None, :]

    def write(x: torch.Tensor, vals: torch.Tensor) -> None:
        ix = cl.expand(b, x.shape[1], k)
        cur = torch.gather(x, 2, ix)
        new = torch.gather(vals, 2, kk.expand(b, x.shape[1], k)).to(x.dtype)
        x.scatter_(2, ix, torch.where(has, new, cur))

    return write


def _set_cells(x: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor) -> None:
    """``x[b, i, cols[b, i]] = vals[b, i]`` in place (one cell per row)."""
    x.scatter_(2, cols.long()[..., None], vals.to(x.dtype)[..., None])


def _cells(x: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """``x[b, i, cols[b, i]]``."""
    return torch.gather(x, 2, cols.long()[..., None])[..., 0]


def _link_acct(att, blk, passed):
    """sim/tick.py::_link_acct per universe: ``[B]`` int32 counts."""
    return (
        _cnt(att),
        _cnt(att & passed),
        _cnt(att & blk),
        _cnt(att & ~blk & ~passed),
    )


def _acct_zero(b: int, device):
    return tuple(torch.zeros((b,), dtype=_I32, device=device) for _ in range(4))


def _draw_shape(*shapes) -> tuple:
    """The per-universe shape of a draw over broadcast index tensors."""
    return tuple(torch.broadcast_shapes(*shapes)[1:])


def _link_pass(key, plan: FaultPlan, src, dst) -> torch.Tensor:
    u = prng.uniform(key, _draw_shape(src.shape, dst.shape), src.device)
    return link_pass_from(u, plan, src, dst)


def _round_trip(key, plan: FaultPlan, legs, deadline_ms) -> torch.Tensor:
    shape = _draw_shape(*(s.shape for leg in legs for s in leg))
    u = prng.uniform(key, shape, legs[0][0].device)
    return round_trip_in_time_from(u, plan, legs, deadline_ms)


def _fill3(fill):
    """A suspicion fill (int, or the knobs' ``[B]``) broadcast over
    ``[B, N, *]`` cells."""
    return fill[:, None, None] if isinstance(fill, torch.Tensor) else fill


def _shared_tick(state) -> int:
    ts = {int(t) for t in state.t_host}
    if len(ts) != 1:
        raise ValueError(
            f"a batched tick needs one host tick across its universes, got {sorted(ts)}; "
            "the sim/ensemble.py runners step such a stack in groups"
        )
    return ts.pop()


def _shuffle_keys(key, n: int) -> None:
    for _ in range(prng._shuffle_rounds(n)):
        key, _ = prng.split(key)


def _fanout_keys(k_gsel, n: int, f: int, structured: bool, group: int) -> None:
    if structured:
        ks = prng.split(k_gsel, f + 1)
        for c in range(f):
            _shuffle_keys(ks[c], n // group)
        prng.split(ks[f])
    else:
        for k in prng.split(k_gsel, f):
            _shuffle_keys(k, n)


def _tick_keys(rng, device, n: int, f: int, structured: bool, group: int, sparse: bool):
    """Every key a tick draws from, derived on the host and uploaded once.
    Returns the root's eight children (sim/tick.py / sim/sparse.py order)."""
    table = prng.KeyTable(rng)
    keys = prng.split(table.root, 8)
    _, k_tgt, k_ping, k_relay, k_gsel, k_glink, k_ssel, k_slink = keys
    prng.split(k_ping, 3)
    relay = prng.split(k_relay, 6)
    _fanout_keys(k_gsel, n, f, structured, group)
    prng.split(k_glink, f)
    if sparse:
        prng.split(k_tgt)
        prng.split(relay[0])
        prng.split(k_ssel)
    else:
        prng.split(k_slink)
    table.upload(device)
    return keys


# ---------------------------------------------------------- dense tick
def _dense_fd(params, state, plan, keys, cand, view0, fd_round, collect):
    """sim/tick.py::_fd_vectors per universe; ``extras`` is ``[B, 7]``."""
    n = params.n
    b = view0.shape[0]
    dev = view0.device
    k_tgt, k_ping, k_relay = keys
    col = torch.arange(n, dtype=_I32, device=dev)[None, :]
    alive = state.alive

    rr_tgt = probe_cursor_targets(fd_round, n, dev)
    rr_valid = torch.gather(cand, 2, rr_tgt.long()[None, :, None].expand(b, n, 1))[..., 0]
    rand_tgt, rand_valid = masked_random_choice(k_tgt, cand)
    tgt = torch.where(rr_valid, rr_tgt, rand_tgt)
    tgt_valid = rr_valid | rand_valid
    vkey = _cells(view0, tgt)
    v_inc = decode_incarnation(vkey)
    v_epoch = decode_epoch(vkey)

    probing = alive & tgt_valid
    pk1, pk2, pk3 = prng.split(k_ping, 3)
    fwd_ok = _link_pass(pk1, plan, col, tgt)
    ack_ok = _link_pass(pk2, plan, tgt, col)
    rt_ok = _round_trip(pk3, plan, [(col, tgt), (tgt, col)], params.ping_timeout_ms)
    alive_t = _take(alive, tgt)
    direct_reach = probing & alive_t & fwd_ok & ack_ok & rt_ok

    relay_cand = cand & (col[:, None, :] != tgt[..., None])
    kr1, rk1, rk2, rk3, rk4, rk5 = prng.split(k_relay, 6)
    ridx, rvalid = masked_random_topk(kr1, relay_cand, params.ping_req_members)
    del relay_cand
    colc, tgtc = col[..., None], tgt[..., None]
    leg_or = _link_pass(rk1, plan, colc, ridx)
    leg_rt = _link_pass(rk2, plan, ridx, tgtc)
    leg_tr = _link_pass(rk3, plan, tgtc, ridx)
    leg_ro = _link_pass(rk4, plan, ridx, colc)
    path_ok = _round_trip(
        rk5, plan, [(colc, ridx), (ridx, tgtc), (tgtc, ridx), (ridx, colc)],
        params.ping_req_timeout_ms,
    )
    alive_r = _take(alive, ridx)
    relay_reach = (
        rvalid & alive_r & alive_t[..., None] & leg_or & leg_rt & leg_tr & leg_ro & path_ok
    )
    reached = direct_reach | (probing & relay_reach.any(dim=-1))

    gone = reached & (_take(state.epoch, tgt) != v_epoch)
    fd_fire = (probing & ~reached) | gone
    fd_key = encode_key(torch.where(gone, _DEAD, _SUSPECT), v_inc, v_epoch)
    accept = (vkey >= 0) & overrides_same_epoch(fd_key, vkey)
    fire = fd_fire & accept
    req_att = (probing & ~direct_reach)[..., None] & rvalid
    msgs = _cnt(probing) + _cnt(req_att)
    if not collect:
        return tgt, fd_key, fire, msgs, None

    ack_att = probing & fwd_ok & alive_t
    att2 = req_att & leg_or & alive_r
    att3 = att2 & leg_rt & alive_t[..., None]
    att4 = att3 & leg_tr
    acct = _acct_add(
        _link_acct(probing, edge_blocked(plan, col, tgt), fwd_ok),
        _link_acct(ack_att, edge_blocked(plan, tgt, col), ack_ok),
        _link_acct(req_att, edge_blocked(plan, colc, ridx), leg_or),
        _link_acct(att2, edge_blocked(plan, ridx, tgtc), leg_rt),
        _link_acct(att3, edge_blocked(plan, tgtc, ridx), leg_tr),
        _link_acct(att4, edge_blocked(plan, ridx, colc), leg_ro),
    )
    extras = torch.stack([_cnt(probing), _cnt(req_att), _cnt(reached), *acct], dim=1)
    return tgt, fd_key, fire, msgs, extras


def _dense_core_xla(params, state, plan, seeds, keys, fd_tgtm, fd_key, inv_perm, edge_ok,
                    joining, do_sync_tick, with_sync, collect, susp_fill):
    """sim/tick.py::_core_xla per universe (``sync_acct`` is ``[B, 4]``)."""
    n = params.n
    view0, alive = state.view, state.alive
    b = view0.shape[0]
    dev = view0.device
    k_ssel, k_slink = keys
    col = torch.arange(n, dtype=_I32, device=dev)
    diag = col[None, :] == col[:, None]
    fd_mask = col == fd_tgtm[..., None]
    view1 = torch.where(fd_mask, fd_key[..., None], view0)
    rows = torch.where(fd_mask, fd_key[..., None], state.rows)

    best_any, best_alive = permuted_delivery_two_channel(rows, is_alive_key, inv_perm, edge_ok)
    self_rumor = torch.diagonal(best_any, dim1=-2, dim2=-1).clone()
    best_any = torch.where(diag, UNKNOWN_KEY, best_any)
    best_alive = torch.where(diag, UNKNOWN_KEY, best_alive)
    merged, _ = merge_views(view1, best_any, best_alive)
    merged = torch.where(alive[..., None], merged, view1)
    del rows, best_any, best_alive

    if with_sync:
        col1 = col[None, :]
        s_cand = (((view1 >= 0) & ((view1 & DEAD_BIT) == 0)) | seeds) & ~diag
        prt, p_valid = masked_random_choice(k_ssel, s_cand)
        del s_cand
        do_sync = (do_sync_tick | joining) & alive
        sk1, sk2 = prng.split(k_slink)
        s_pass_fwd = _link_pass(sk1, plan, col1, prt)
        s_pass_rev = _link_pass(sk2, plan, prt, col1)
        s_fwd = do_sync & p_valid & _take(alive, prt) & s_pass_fwd
        s_rev = s_fwd & s_pass_rev
        if collect:
            s_att = do_sync & p_valid
            sync_acct = _acct_add(
                _link_acct(s_att, edge_blocked(plan, col1, prt), s_pass_fwd),
                _link_acct(s_fwd, edge_blocked(plan, prt, col1), s_pass_rev),
            )
        else:
            sync_acct = _acct_zero(b, dev)
        best_any_s = deliver_rows_max(view1, prt[..., None], s_fwd[..., None], n)
        full_alive_rows = torch.where(is_alive_key(view1), view1, UNKNOWN_KEY)
        best_alive_s = deliver_rows_max(full_alive_rows, prt[..., None], s_fwd[..., None], n)
        del full_alive_rows
        reply = take_rows(view1, prt)
        best_any_s = torch.maximum(
            best_any_s, torch.where(s_rev[..., None], reply, UNKNOWN_KEY)
        )
        best_alive_s = torch.maximum(
            best_alive_s,
            torch.where(s_rev[..., None] & is_alive_key(reply), reply, UNKNOWN_KEY),
        )
        del reply
        self_rumor = torch.maximum(self_rumor, torch.diagonal(best_any_s, dim1=-2, dim2=-1))
        best_any_s = torch.where(diag, UNKNOWN_KEY, best_any_s)
        best_alive_s = torch.where(diag, UNKNOWN_KEY, best_alive_s)
        out, _ = merge_views(merged, best_any_s, best_alive_s)
        merged = torch.where(alive[..., None], out, merged)
        del out, best_any_s, best_alive_s
        msgs_sync = _cnt(s_fwd) + _cnt(s_rev)
    else:
        msgs_sync = torch.zeros((b,), dtype=_I32, device=dev)
        sync_acct = _acct_zero(b, dev)

    alive_row = alive[..., None]
    age0 = torch.where(fd_mask, 0, state.rumor_age)
    armed = state.suspect_left > 0
    rearm = merged != view0
    left0 = torch.clamp_min(state.suspect_left.to(_I32) - 1, 0)
    expired = (
        alive_row & armed & ~rearm & (left0 == 0)
        & ((merged & DEAD_BIT) == 0) & ((merged & 1) != 0) & (merged >= 0)
    )
    view2 = torch.where(expired, (merged | DEAD_BIT) & ~1, merged)
    changed = (view2 != view0) & alive_row
    rumor_age = torch.where(
        changed, 0, torch.clamp_max(age0, AGE_STALE - 1) + 1
    ).to(torch.int8)
    tomb = (
        ~diag & ((view2 & DEAD_BIT) != 0) & (view2 >= 0)
        & (rumor_age > params.periods_to_sweep) & alive_row
    )
    view2 = torch.where(tomb, UNKNOWN_KEY, view2)
    is_susp = ((view2 & 1) != 0) & ((view2 & DEAD_BIT) == 0) & (view2 >= 0)
    suspect_left = torch.where(
        is_susp, torch.where(rearm | ~armed, _fill3(susp_fill), left0), 0
    ).to(torch.int16)
    suspect_left = torch.where(alive_row, suspect_left, state.suspect_left)
    rows_next = torch.where(rumor_age < params.periods_to_spread, view2, UNKNOWN_KEY)
    known_cnt = ((view2 >= 0) & ((view2 & DEAD_BIT) == 0) & ~diag).sum(dim=-1, dtype=_I32)
    return (
        view2, rumor_age, suspect_left, rows_next, known_cnt, self_rumor,
        msgs_sync, torch.stack(sync_acct, dim=1),
    )


def ensemble_sim_tick(params, state, plan: FaultPlan, seeds, collect: bool = True,
                      knobs: Knobs | None = None):
    """sim/tick.py::sim_tick over B universes sharing one host tick:
    ``state`` and ``plan`` stacked (sim/ensemble.py), ``seeds`` the shared
    ``[N]`` seed mask, ``knobs`` stacked or None. Returns ``(state,
    metrics)`` with ``[B]``-leading metrics. Scheduled events are applied
    by the runner before the tick."""
    n = params.n
    if knobs is not None and params.pallas_delivery:
        raise ValueError(
            "knobs require the XLA tick core: tick_core_pallas bakes the "
            "suspicion timeout as a kernel constant (set pallas_delivery=False)"
        )
    if params.track_user_infected or params.gossip_delay_model:
        raise NotImplementedError(
            "tracked user gossip (track_user_infected / gossip_delay_model) is "
            "not ported to ensembles yet (ROADMAP A11 follow-up)"
        )
    dev = state.device
    b = state.alive.shape[0]
    f = params.gossip_fanout
    t = _shared_tick(state) + 1
    structured = n % GROUP == 0
    rng_next, k_tgt, k_ping, k_relay, k_gsel, k_glink, k_ssel, k_slink = _tick_keys(
        state.rng, dev, n, f, structured, GROUP, sparse=False
    )
    view0, alive = state.view, state.alive
    col = torch.arange(n, dtype=_I32, device=dev)
    col1 = col[None, :]
    do_fd = t % params.fd_period_ticks == 0
    do_sync_tick = t % params.sync_period_ticks == 0
    joining = (state.known_cnt == 0) & alive

    if do_fd:
        cand = (view0 >= 0) & ((view0 & DEAD_BIT) == 0) & (col[None, :] != col[:, None])
        fd_tgt, fd_key, fd_fire, msgs_fd, fd_extras = _dense_fd(
            params, state, plan, (k_tgt, k_ping, k_relay), cand, view0,
            t // params.fd_period_ticks, collect,
        )
        del cand
    else:
        fd_tgt = torch.zeros((b, n), dtype=_I32, device=dev)
        fd_key = torch.zeros((b, n), dtype=_I32, device=dev)
        fd_fire = torch.zeros((b, n), dtype=torch.bool, device=dev)
        msgs_fd = torch.zeros((b,), dtype=_I32, device=dev)
        fd_extras = torch.zeros((b, 7), dtype=_I32, device=dev) if collect else None
    fd_tgtm = torch.where(fd_fire, fd_tgt, -1)

    if structured:
        inv_perm, ginv, rots = fanout_permutations_structured(k_gsel, n, f, dev)
    else:
        _, inv_perm = fanout_permutations(k_gsel, n, f, dev)
        ginv = rots = None
    lks = prng.split(k_glink, f)
    gpass = [_link_pass(lks[c], plan, inv_perm[:, c], col1) for c in range(f)]
    edge_ok = torch.stack(
        [_take(alive, inv_perm[:, c]) & gpass[c] for c in range(f)], dim=1
    )
    elive = edge_live(f, knobs)
    if elive is not None:
        edge_ok = edge_ok & elive[..., None]
    susp_fill = suspicion_fill(params.suspicion_ticks, knobs)

    # One read for the batch: any universe joining sends all to the slow core.
    need_slow = do_sync_tick or bool(joining.any())
    use_fused = params.pallas_delivery and structured and n % 128 == 0
    if not need_slow and use_fused:
        view2, rumor_age, suspect_left, rows_next, self_rumor, known_cnt = tick_core(
            state.rows, view0, state.rumor_age, state.suspect_left, ginv, rots,
            edge_ok, alive, fd_tgtm, fd_key,
            spread=params.periods_to_spread, sweep=params.periods_to_sweep,
            susp_ticks=params.suspicion_ticks, age_stale=AGE_STALE,
        )
        msgs_sync = torch.zeros((b,), dtype=_I32, device=dev)
        sync_acct = torch.zeros((b, 4), dtype=_I32, device=dev)
    else:
        (view2, rumor_age, suspect_left, rows_next, known_cnt, self_rumor,
         msgs_sync, sync_acct) = _dense_core_xla(
            params, state, plan, seeds, (k_ssel, k_slink), fd_tgtm, fd_key,
            inv_perm, edge_ok, joining, do_sync_tick, need_slow, collect, susp_fill,
        )

    own_key = torch.diagonal(view2, dim1=-2, dim2=-1).clone()
    r_status = decode_status(self_rumor)
    threat = (
        alive
        & ((own_key & DEAD_BIT) == 0)
        & (self_rumor >= 0)
        & (decode_epoch(self_rumor) == state.epoch)
        & ((r_status == _SUSPECT) | (r_status == _DEAD))
        & (decode_incarnation(self_rumor) >= state.inc_self)
    )
    inc_self = torch.where(threat, decode_incarnation(self_rumor) + 1, state.inc_self)
    own_new = encode_key(torch.full_like(inc_self, _ALIVE), inc_self, state.epoch)
    torch.diagonal(view2, dim1=-2, dim2=-1).copy_(torch.where(threat, own_new, own_key))
    age_diag = torch.diagonal(rumor_age, dim1=-2, dim2=-1)
    age_diag.copy_(torch.where(threat, 0, age_diag))
    rows_diag = torch.diagonal(rows_next, dim1=-2, dim2=-1)
    rows_diag.copy_(torch.where(threat, own_new, rows_diag))

    nonself = inv_perm != col
    new_seen, uage, msgs_user = user_gossip_step(
        state.useen, state.uage, inv_perm, edge_ok, alive,
        params.periods_to_spread, params.periods_to_sweep, edge_live=elive,
    )

    tick = state.tick + 1
    new_state = state.replace(
        view=view2, rumor_age=rumor_age, suspect_left=suspect_left, rows=rows_next,
        known_cnt=known_cnt, inc_self=inc_self, useen=new_seen, uage=uage,
        tick=tick, rng=rng_next.words.copy(), t_host=state.t_host + 1,
    )
    if not collect:
        return new_state, {"tick": tick}

    diag = col[None, :] == col[:, None]
    is_susp2 = ((view2 & 1) != 0) & ((view2 & DEAD_BIT) == 0) & (view2 >= 0)
    status2 = decode_status(view2)
    n_alive = _cnt(alive)
    subj_alive = alive[:, None, :]
    truth_alive = subj_alive & (decode_epoch(view2) == state.epoch[:, None, :])
    ok_alive = truth_alive & (status2 == _ALIVE)
    ok_dead = ~subj_alive & ((status2 == _DEAD) | (view2 < 0))
    match = torch.where(subj_alive, ok_alive, ok_dead) | diag
    viewer_conv = xla_row_means_f32(match)
    conv_sum = xla_cpu_sum_f32(viewer_conv * alive)
    convergence = conv_sum / torch.clamp_min(n_alive, 1)
    sender_active = (state.rows >= 0).any(dim=-1) | (fd_tgtm >= 0)
    g_att_c = []
    for c in range(f):
        src = inv_perm[:, c]
        att = _take(sender_active, src) & _take(alive, src) & nonself[:, c]
        if elive is not None:
            att = att & elive[:, c, None]
        g_att_c.append(att)
    msgs_gossip = sum(_cnt(m) for m in g_att_c)
    g_acct = _acct_zero(b, dev)
    for c in range(f):
        g_blk = edge_blocked(plan, inv_perm[:, c], col1)
        g_acct = _acct_add(g_acct, _link_acct(g_att_c[c], g_blk, gpass[c]))
    acct = _acct_add(
        tuple(fd_extras[:, 3 + k] for k in range(4)), g_acct,
        tuple(sync_acct[:, k] for k in range(4)),
    )
    is_susp0 = ((view0 & 1) != 0) & ((view0 & DEAD_BIT) == 0) & (view0 >= 0)
    was_dead = ((view0 & DEAD_BIT) != 0) & (view0 >= 0)
    now_dead = ((view2 & DEAD_BIT) != 0) & (view2 >= 0)
    viewer_live = alive[..., None]
    metrics = {
        "tick": tick,
        "convergence": convergence,
        "n_alive": n_alive,
        "n_suspected": _cnt(is_susp2 & viewer_live),
        "msgs_gossip": msgs_gossip,
        "msgs_user": msgs_user,
        "msgs_fd": msgs_fd,
        "msgs_sync": msgs_sync,
        "gossip_coverage": (new_seen & alive[..., None]).sum(dim=1, dtype=_I32)
        / torch.clamp_min(n_alive, 1)[:, None],
        "suspicions_raised": _cnt(is_susp2 & ~is_susp0 & viewer_live),
        "verdicts_dead": _cnt(now_dead & ~was_dead & viewer_live),
        "verdicts_alive": _cnt(
            is_alive_key(view2) & ~is_alive_key(view0) & (view0 >= 0) & viewer_live
        ),
        "gossip_infections": _cnt(new_seen & ~state.useen),
        "pings": fd_extras[:, 0],
        "ping_reqs": fd_extras[:, 1],
        "acks": fd_extras[:, 2],
        "link_attempts": acct[0],
        "link_delivered": acct[1],
        "fault_blocked": acct[2],
        "fault_lost": acct[3],
        "inc_max": inc_self.amax(dim=1),
        "epoch_max": state.epoch.amax(dim=1),
    }
    zero = torch.zeros((b,), dtype=_I32, device=dev)
    for key in SHARED_COUNTERS:
        metrics.setdefault(key, zero)
    return new_state, metrics


# --------------------------------------------------------- sparse tick
def apply_events_sparse(state, kill_mask, restart_mask, gossip_mask=None, join_mask=None):
    """sim/sparse.py::apply_events_sparse per universe: ``[B, N]`` kill and
    restart masks, with ``gossip_mask [B, N, G]`` the user-gossip
    injections and with ``join_mask [B, N]`` the elastic joins (a join
    activates a capacity row like a restart and sets its ``live_mask``
    bit). Consumes no RNG. The flight recorder stays with the single tick
    (sim/ensemble.py refuses traced stacks)."""
    n = state.alive.shape[1]
    fresh = restart_mask if join_mask is None else restart_mask | join_mask
    any_ev = (kill_mask | fresh).any(dim=1)
    if gossip_mask is not None:
        any_ev = any_ev | gossip_mask.flatten(1).any(dim=1)
    new_epoch = torch.where(fresh, torch.clamp_max(state.epoch + 1, EPOCH_MAX), state.epoch)
    uinf_ids = state.uinf_ids
    if uinf_ids.shape[-1] > 0:
        hit = (uinf_ids >= 0) & _take(fresh, torch.clamp(uinf_ids, 0, n - 1))
        uinf_ids = torch.where(hit, -1, uinf_ids)
        uinf_ids = torch.where(fresh[..., None, None], -1, uinf_ids)
    st = state.replace(
        alive=(state.alive & ~kill_mask) | fresh,
        epoch=new_epoch,
        inc_self=torch.where(fresh, 0, state.inc_self),
        # Python scalars keep the int8 / int16 planes' dtypes and, unlike a
        # CPU tensor operand, need no host-to-device copy.
        age=torch.where(fresh[..., None], AGE_STALE, state.age),
        susp=torch.where(fresh[..., None], 0, state.susp),
        useen=torch.where(fresh[..., None], False, state.useen),
        uptr=torch.where(fresh[..., None], 0, state.uptr),
        uinf_ids=uinf_ids,
    )
    if join_mask is not None and st.live_mask is not None:
        st = st.replace(live_mask=st.live_mask | join_mask)
    if gossip_mask is not None:
        st = st.replace(
            useen=st.useen | gossip_mask, uage=torch.where(gossip_mask, 0, st.uage)
        )
    if st.lat_first_suspect is not None:
        st = st.replace(
            lat_first_suspect=torch.where(fresh, -1, st.lat_first_suspect),
            lat_first_dead=torch.where(fresh, -1, st.lat_first_dead),
        )
    if st.wb_valid is not None:
        st = st.replace(wb_valid=st.wb_valid & ~any_ev)
    return st


def write_back(params, state, freeing: torch.Tensor):
    """sim/sparse.py::_write_back per universe: the freed slots' columns go
    into their universe's ``view_T`` rows IN PLACE. Reads the ``[B, S]``
    mask back to the host once."""
    p = params.base
    bi, si = torch.nonzero(freeing, as_tuple=True)
    slot_subj, subj_slot = state.slot_subj, state.subj_slot
    if bi.numel():
        subj = slot_subj[bi, si].long()
        cols = state.slab[bi, :, si]  # [K, N]
        col = torch.arange(p.n, dtype=_I32, device=state.device)
        demote = (
            is_dead_key(cols)
            & (state.age[bi, :, si].to(_I32) > p.periods_to_sweep)
            & (col[None, :] != slot_subj[bi, si][:, None])
        )
        state.view_T.index_put_((bi, subj), torch.where(demote, UNKNOWN_KEY, cols))
        subj_slot = subj_slot.clone()
        subj_slot[bi, subj] = -1
        slot_subj = torch.where(freeing, -1, slot_subj)
    return slot_subj, subj_slot


def _sparse_fd(p, plan, t, keys, record_of, alive, epoch, collect):
    """sim/sparse.py::_fd_decide per universe."""
    n = p.n
    dev = alive.device
    k_tgt, k_ping, k_relay = keys
    col = torch.arange(n, dtype=_I32, device=dev)[None, :]
    rr_tgt = probe_cursor_targets(t // p.fd_period_ticks, n, dev)[None, :]
    rr_key = record_of(col, rr_tgt)
    rr_valid = (rr_tgt != col) & (rr_key >= 0) & ((rr_key & DEAD_BIT) == 0)
    rand_tgt = prng.randint(k_tgt, (n,), 0, n, dev)
    tgt = torch.where(rr_valid, rr_tgt, rand_tgt)
    vkey = record_of(col, tgt)
    valid = (tgt != col) & (vkey >= 0) & ((vkey & DEAD_BIT) == 0)
    probing = alive & valid
    pk1, pk2, pk3 = prng.split(k_ping, 3)
    fwd_ok = link_pass_from(prng.uniform(pk1, (n,), dev), plan, col, tgt)
    ack_ok = link_pass_from(prng.uniform(pk2, (n,), dev), plan, tgt, col)
    rt_ok = round_trip_in_time_from(
        prng.uniform(pk3, (n,), dev), plan, [(col, tgt), (tgt, col)], p.ping_timeout_ms,
    )
    alive_t1 = _take(alive, tgt)
    direct = probing & alive_t1 & fwd_ok & ack_ok & rt_ok

    kr, rk1, rk2, rk3, rk4, rk5 = prng.split(k_relay, 6)
    nrel = p.ping_req_members
    ridx = prng.randint(kr, (n, nrel), 0, n, dev)
    colc, tgtc = col[..., None], tgt[..., None]
    rkey = record_of(colc, ridx)
    rvalid = (ridx != colc) & (ridx != tgtc) & (rkey >= 0) & ((rkey & DEAD_BIT) == 0)
    leg_or = link_pass_from(prng.uniform(rk1, (n, nrel), dev), plan, colc, ridx)
    leg_rt = link_pass_from(prng.uniform(rk2, (n, nrel), dev), plan, ridx, tgtc)
    leg_tr = link_pass_from(prng.uniform(rk3, (n, nrel), dev), plan, tgtc, ridx)
    leg_ro = link_pass_from(prng.uniform(rk4, (n, nrel), dev), plan, ridx, colc)
    path_ok = round_trip_in_time_from(
        prng.uniform(rk5, (n, nrel), dev), plan,
        [(colc, ridx), (ridx, tgtc), (tgtc, ridx), (ridx, colc)],
        p.ping_req_timeout_ms,
    )
    alive_r = _take(alive, ridx)
    alive_t = alive_t1[..., None]
    relay = rvalid & alive_r & alive_t & leg_or & leg_rt & leg_tr & leg_ro & path_ok
    reached = direct | (probing & relay.any(dim=-1))
    gone = reached & (_take(epoch, tgt) != decode_epoch(vkey))
    fd_key = encode_key(
        torch.where(gone, _DEAD, _SUSPECT), decode_incarnation(vkey), decode_epoch(vkey)
    )
    fire = ((probing & ~reached) | gone) & overrides_same_epoch(fd_key, vkey)
    n_pings = _cnt(probing)
    req_att = (probing & ~direct)[..., None] & rvalid
    n_ping_reqs = _cnt(req_att)
    out = (tgt, fd_key, fire, n_pings + n_ping_reqs)
    if collect:
        ack_att = probing & fwd_ok & alive_t1
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
        out = out + (n_pings, n_ping_reqs, _cnt(reached)) + acct
    return out


def _sparse_fd_zeros(b, n, collect, dev):
    zero = torch.zeros((b,), dtype=_I32, device=dev)
    out = (
        torch.zeros((b, n), dtype=_I32, device=dev),
        torch.zeros((b, n), dtype=_I32, device=dev),
        torch.zeros((b, n), dtype=torch.bool, device=dev),
        zero,
    )
    if collect:
        out = out + (zero, zero, zero) + _acct_zero(b, dev)
    return out


def _window_zeros(b, n, w, dev):
    return (
        torch.full((b, n, w), UNKNOWN_KEY, dtype=_I32, device=dev),
        torch.zeros((b, n, w), dtype=torch.bool, device=dev),
        torch.full((b, n), UNKNOWN_KEY, dtype=_I32, device=dev),
    )


def _sparse_sync(p, plan, k_ssel, k_slink, record_of, alive, w, wsubj, collect):
    """sim/sparse.py::_sync_fire per universe."""
    n = p.n
    b = alive.shape[0]
    dev = alive.device
    col = torch.arange(n, dtype=_I32, device=dev)[None, :]
    prt = prng.randint(k_ssel, (n,), 0, n, dev)
    s_pass = link_pass_from(prng.uniform(k_slink, (n,), dev), plan, col, prt)
    ok = alive & _take(alive, prt) & (prt != col) & s_pass
    learned_key = record_of(prt, prt)
    accept = ok & sync_accept(learned_key, record_of(col, prt))
    if w > 0:
        ws = wsubj[None, None, :]
        learned_w = record_of(prt[..., None], ws)
        mine_w = record_of(col[..., None], ws)
        self_cell = ws == col[..., None]
        accept_w = ok[..., None] & ~self_cell & sync_accept(learned_w, mine_w)
        self_win = torch.where(
            self_cell & ok[..., None] & (learned_w >= 0), learned_w, UNKNOWN_KEY
        ).amax(dim=-1)
    else:
        learned_w, accept_w, self_win = _window_zeros(b, n, w, dev)
    out = (prt, learned_key, accept, _cnt(ok) * 2, learned_w, accept_w, self_win)
    if collect:
        att_f = alive & (prt != col)
        acct_f = _link_acct(att_f, edge_blocked(plan, col, prt), s_pass)
        n_rev = _cnt(ok)
        out = out + (acct_f[0] + n_rev, acct_f[1] + n_rev, acct_f[2], acct_f[3])
    return out


def _sparse_sync_zeros(b, n, w, collect, dev):
    out = (
        torch.zeros((b, n), dtype=_I32, device=dev),
        torch.zeros((b, n), dtype=_I32, device=dev),
        torch.zeros((b, n), dtype=torch.bool, device=dev),
        torch.zeros((b,), dtype=_I32, device=dev),
    ) + _window_zeros(b, n, w, dev)
    if collect:
        out = out + _acct_zero(b, dev)
    return out


def ensemble_sparse_tick(params, state, plan: FaultPlan, collect: bool = True,
                         events=None, knobs: Knobs | None = None):
    """sim/sparse.py::sparse_tick over B universes sharing one host tick.
    ``events`` is None, ``(kill [B, N], restart [B, N][, gossip [B, N, G]])``
    or the elastic 4-tuple ``(kill, restart, gossip or None, join [B, N])``,
    the lanes of the single tick (:func:`apply_events_sparse`). Consumes
    ``state``: the slab load and write-back update its stacked tensors in
    place. Returns ``(state, metrics)`` with ``[B]``-leading metrics."""
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
    fresh_m = join_m = None
    if events is not None:
        gossip_m = events[2] if len(events) > 2 else None
        join_m = events[3] if len(events) > 3 else None
        state = apply_events_sparse(state, events[0], events[1], gossip_m, join_m)
        fresh_m = events[1] if join_m is None else events[1] | join_m
    dev = state.device
    b = state.alive.shape[0]
    group = SPARSE_GROUP if n % SPARSE_GROUP == 0 else GROUP
    use_kernel = sparse_route(params)
    fold = params.pallas_fold if use_kernel else frozenset()
    t = _shared_tick(state) + 1
    rng_next, k_tgt, k_ping, k_relay, k_gsel, k_glink, k_ssel, k_slink = _tick_keys(
        state.rng, dev, n, f, True, group, sparse=True
    )
    col = torch.arange(n, dtype=_I32, device=dev)
    col1 = col[None, :]
    srange = torch.arange(S, dtype=_I32, device=dev)
    alive = state.alive
    do_fd = t % p.fd_period_ticks == 0
    do_sync = t % p.sync_period_ticks == 0
    subj_slot0, slab_in, view_T = state.subj_slot, state.slab, state.view_T

    def record_of(viewer, subject):
        """view[b, viewer, subject] through the slab indirection."""
        s = _take(subj_slot0, subject)
        from_slab = _take2(slab_in, viewer, torch.clamp_min(s, 0))
        return torch.where(s >= 0, from_slab, _take2(view_T, subject, viewer))

    # ------------------------------------------------------------- 1. FD
    if do_fd:
        fd_out = _sparse_fd(
            p, plan, t, (k_tgt, k_ping, k_relay), record_of, alive, state.epoch, collect
        )
    else:
        fd_out = _sparse_fd_zeros(b, n, collect, dev)
    fd_tgt, fd_key, fd_fire, msgs_fd = fd_out[:4]

    # --------------------------------------------- 2. own-record SYNC
    W = min(params.sync_window, n)
    nblocks = (n + W - 1) // W if W else 1
    sync_round = t // p.sync_period_ticks
    wsubj = ((sync_round % nblocks) * W + torch.arange(W, dtype=_I32, device=dev)) % n
    if do_sync:
        sy_out = _sparse_sync(p, plan, k_ssel, k_slink, record_of, alive, W, wsubj, collect)
    else:
        sy_out = _sparse_sync_zeros(b, n, W, collect, dev)
    sy_subj, sy_key, sy_accept, msgs_sync, win_key, win_accept, self_win = sy_out[:7]

    # -------------------------------------- 3. slot free + allocation
    freeing = None
    slot_subj, subj_slot = state.slot_subj, state.subj_slot
    if params.in_scan_writeback:
        if t % params.writeback_period == 0:
            freeing = free_plan(params, state)
            slot_subj, subj_slot = write_back(params, state, freeing)
        else:
            freeing = torch.zeros((b, S), dtype=torch.bool, device=dev)

    req = torch.zeros((b, n), dtype=_I32, device=dev)
    if do_fd:
        req.scatter_reduce_(1, fd_tgt.long(), fd_fire.to(_I32), "amax")
    if do_sync:
        req.scatter_reduce_(1, sy_subj.long(), sy_accept.to(_I32), "amax")
        if W > 0:
            req.scatter_reduce_(
                1, wsubj.long().expand(b, W), win_accept.any(dim=1).to(_I32), "amax"
            )
    req = req.bool()
    if do_sync and W > 0:
        st_w = decode_status(self_win)
        req = req | (
            alive
            & (self_win >= 0)
            & (decode_epoch(self_win) == state.epoch)
            & (decode_incarnation(self_win) >= state.inc_self)
            & ((st_w == _SUSPECT) | (st_w == _DEAD))
        )
    if fresh_m is not None:
        req = req | fresh_m
    req = req & (subj_slot < 0)
    cap = params.alloc_cap
    if join_m is not None:
        # Elastic: fresh activations outrank the organic requests.
        fresh_req = req & fresh_m
        rank_fresh = torch.cumsum(fresh_req.to(_I32), 1, dtype=_I32) - 1
        rank_rest = (
            torch.cumsum((req & ~fresh_m).to(_I32), 1, dtype=_I32) - 1
            + _cnt(fresh_req)[:, None]
        )
        req_rank = torch.where(fresh_req, rank_fresh, rank_rest)
    else:
        req_rank = torch.cumsum(req.to(_I32), 1, dtype=_I32) - 1
    free = slot_subj < 0
    free_slots = _first_true(free, cap, S - 1)
    n_free = _cnt(free)
    granted = req & (req_rank < cap) & (req_rank < n_free[:, None])
    new_subjects = _first_true(granted, cap, 0)
    n_granted = _cnt(granted)
    grant_valid = torch.arange(cap, dtype=_I32, device=dev) < torch.minimum(
        n_granted, n_free
    )[:, None]
    slot_overflow = _cnt(req) - n_granted
    tgt_slots = torch.where(grant_valid, free_slots, S)
    slot_subj = _pad_scatter(slot_subj, tgt_slots, new_subjects).contiguous()
    subj_slot = _pad_scatter(subj_slot, torch.where(grant_valid, new_subjects, n), free_slots)

    slab, age, susp = state.slab, state.age, state.susp
    load = _column_writer(free_slots, tgt_slots, S)
    load(slab, take_rows(view_T, new_subjects).transpose(1, 2))
    load(age, torch.full((b, n, cap), AGE_STALE, dtype=torch.int8, device=dev))
    load(susp, torch.zeros((b, n, cap), dtype=torch.int16, device=dev))
    active = slot_subj >= 0
    if fresh_m is not None:
        r_fire = fresh_m & (subj_slot >= 0)
        r_safe = torch.where(r_fire, subj_slot, 0)
        r_key = encode_key(
            torch.full_like(state.epoch, _ALIVE), torch.zeros_like(state.epoch), state.epoch
        )
        _set_cells(slab, r_safe, torch.where(r_fire, r_key, _cells(slab, r_safe)))
        _set_cells(age, r_safe, torch.where(r_fire, 0, _cells(age, r_safe)))

    # ------------------------ 4. FD verdict / SYNC learning point lanes
    slab0, age_pre = slab, age
    fd_slot = _take(subj_slot, fd_tgt)
    fd_slot = torch.where(fd_fire & (fd_slot >= 0), fd_slot, -1)
    sy_slot = _take(subj_slot, sy_subj)
    sy_slot = torch.where(sy_accept & (sy_slot >= 0), sy_slot, -1)

    # ------------------------------------------ 5. gossip delivery core
    inv_perm, ginv, rots = fanout_permutations_structured(k_gsel, n, f, dev, group=group)
    lks = prng.split(k_glink, f)
    gpass = [
        link_pass_from(prng.uniform(lks[c], (n,), dev), plan, inv_perm[:, c], col1)
        for c in range(f)
    ]
    edge_ok = torch.stack(
        [_take(alive, inv_perm[:, c]) & gpass[c] for c in range(f)], dim=1
    )
    elive = edge_live(f, knobs)
    if elive is not None:
        edge_ok = edge_ok & elive[..., None]
    susp_fill = suspicion_fill(p.suspicion_ticks, knobs)
    core_args = (slab, age, susp, slot_subj, ginv, rots, edge_ok, alive,
                 fd_slot, sy_slot, fd_key, sy_key)
    consts = dict(spread=p.periods_to_spread, susp_ticks=_fill3(susp_fill),
                  age_stale=AGE_STALE, sweep=p.periods_to_sweep)
    if use_kernel:
        slab2, age, susp, self_rumor, aggr = sparse_core(*core_args, **consts)
    else:
        slab2, age, susp, self_rumor, aggr = sparse_core_reference(
            *core_args, **consts, group=group
        )
    pin_k = ((aggr >> AGGR_HOLD_BIT) & 1).bool()
    seen_s = ((aggr >> AGGR_SUSPECT_BIT) & 1).bool()
    seen_d = ((aggr >> AGGR_DEAD_BIT) & 1).bool()
    pin_extra = torch.zeros((b, S), dtype=torch.bool, device=dev)

    # ---------------------------------- 6.5 window SYNC application
    if do_sync and W > 0:
        wslot = _take(subj_slot, wsubj[None, :])
        safe = torch.clamp_min(wslot, 0)
        route = torch.where(wslot >= 0, wslot, S)
        ix = safe.long()[:, None, :].expand(b, n, W)
        cur = torch.gather(slab2, 2, ix)
        app = (
            win_accept
            & (wslot >= 0)[:, None, :]
            & alive[..., None]
            & sync_accept(win_key, cur)
        )
        new = torch.where(app, win_key, cur)
        new_age = torch.where(app, 0, torch.gather(age, 2, ix))
        new_susp = torch.where(
            app,
            torch.where(is_suspect_key(new), _fill3(susp_fill), 0),
            torch.gather(susp, 2, ix).to(_I32),
        )
        put = _column_writer(safe, route, S)
        put(slab2, new)
        put(age, new_age)
        put(susp, new_susp)
        pin_extra = _or_drop(pin_extra, route, app.any(dim=1))
        seen_s = _or_drop(seen_s, route, (app & is_suspect_key(win_key)).any(dim=1))
        seen_d = _or_drop(seen_d, route, (app & is_dead_key(win_key)).any(dim=1))

    # ---------------------------------------------- 7. self-refutation
    self_rumor = torch.maximum(self_rumor, self_win)
    r_status = decode_status(self_rumor)
    own_slot = subj_slot
    has_own = own_slot >= 0
    own_safe = torch.clamp_min(own_slot, 0)
    own_cur = _cells(slab2, own_safe)
    own_key = torch.where(
        has_own, own_cur,
        encode_key(torch.zeros_like(state.inc_self), state.inc_self, state.epoch),
    )
    threat = (
        alive
        & ((own_key & DEAD_BIT) == 0)
        & (self_rumor >= 0)
        & (decode_epoch(self_rumor) == state.epoch)
        & ((r_status == _SUSPECT) | (r_status == _DEAD))
        & (decode_incarnation(self_rumor) >= state.inc_self)
        & has_own
    )
    inc_self = torch.where(threat, decode_incarnation(self_rumor) + 1, state.inc_self)
    own_new = encode_key(torch.zeros_like(inc_self), inc_self, state.epoch)
    _set_cells(slab2, own_safe, torch.where(threat, own_new, own_cur))
    _set_cells(age, own_safe, torch.where(threat, 0, _cells(age, own_safe)))
    pin_extra = _or_drop(pin_extra, torch.where(threat, own_slot, S), threat)

    # --------------------------------------------------- 8. user gossip
    if state.uinf_ids.shape[-1] > 0:
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
            seen_s = (is_suspect_key(slab2) & alive[..., None]).any(dim=1)
            seen_d = (is_dead_key(slab2) & alive[..., None]).any(dim=1)
        subj_safe = torch.clamp(slot_subj, 0, n - 1)
        first_s = seen_s & active & (_take(lat_s, subj_safe) < 0)
        first_d = seen_d & active & (_take(lat_d, subj_safe) < 0)
        t_vec = tick[:, None].expand(b, S)
        lat_s = _pad_scatter(lat_s, torch.where(first_s, slot_subj, n), t_vec)
        lat_d = _pad_scatter(lat_d, torch.where(first_d, slot_subj, n), t_vec)

    carry = state.wb_pinned is not None and "wb_mask" in fold
    new_state = state.replace(
        slot_subj=slot_subj, subj_slot=subj_slot, slab=slab2, age=age, susp=susp,
        inc_self=inc_self, useen=new_seen, uage=uage, uinf_ids=uinf_ids, uptr=uptr,
        tick=tick, rng=rng_next.words.copy(), t_host=state.t_host + 1,
        lat_first_suspect=lat_s, lat_first_dead=lat_d,
        wb_pinned=pin_k | pin_extra if carry else state.wb_pinned,
        wb_valid=None if state.wb_valid is None else torch.full_like(state.wb_valid, carry),
    )
    if not collect:
        return new_state, {"tick": tick}

    cell_fd = srange == fd_slot[..., None]
    cell_sy = srange == sy_slot[..., None]
    slab_send = torch.where(
        cell_sy, sy_key[..., None], torch.where(cell_fd, fd_key[..., None], slab0)
    )
    age_send = torch.where(cell_sy | cell_fd, 0, age_pre.to(_I32))
    sender_active = (
        (age_send < p.periods_to_spread) & active[:, None, :] & (slab_send >= 0)
    ).any(dim=-1)
    fd_pings, fd_ping_reqs, fd_acks = fd_out[4:7]
    g_att = []
    g_acct = _acct_zero(b, dev)
    for c in range(f):
        src = inv_perm[:, c]
        att = _take(sender_active, src) & _take(alive, src) & (src != col1)
        if elive is not None:
            att = att & elive[:, c, None]
        g_att.append(att)
        g_acct = _acct_add(
            g_acct, _link_acct(att, edge_blocked(plan, src, col1), gpass[c])
        )
    acct = _acct_add(fd_out[7:11], g_acct, sy_out[7:11])
    viewer_live = alive[..., None] & active[:, None, :]
    is_susp2 = is_suspect_key(slab2)
    was_dead = is_dead_key(slab0)
    now_dead = is_dead_key(slab2)
    zero = torch.zeros((b,), dtype=_I32, device=dev)
    n_alive = _cnt(alive)
    metrics = {
        "tick": tick,
        "n_active_slots": _cnt(active),
        "slot_overflow": slot_overflow,
        "n_suspected": _cnt(is_susp2 & viewer_live),
        "msgs_fd": msgs_fd,
        "msgs_sync": msgs_sync,
        "msgs_gossip": sum(_cnt(m) for m in g_att),
        "msgs_user": msgs_user,
        "gossip_coverage": (new_seen & alive[..., None]).sum(dim=1, dtype=_I32)
        / torch.clamp_min(n_alive, 1)[:, None],
        "pings": fd_pings,
        "ping_reqs": fd_ping_reqs,
        "acks": fd_acks,
        "suspicions_raised": _cnt(is_susp2 & ~is_suspect_key(slab0) & viewer_live),
        "verdicts_dead": _cnt(now_dead & ~was_dead & viewer_live),
        "verdicts_alive": _cnt(
            is_alive_key(slab2) & ~is_alive_key(slab0) & (slab0 >= 0) & viewer_live
        ),
        "gossip_infections": _cnt(new_seen & ~state.useen),
        "slot_activations": n_granted,
        "slot_frees": _cnt(freeing) if freeing is not None else zero,
        "sync_window_accepts": _cnt(win_accept),
        "link_attempts": acct[0],
        "link_delivered": acct[1],
        "fault_blocked": acct[2],
        "fault_lost": acct[3],
        "inc_max": inc_self.amax(dim=1),
        "epoch_max": state.epoch.amax(dim=1),
        "joins_admitted": _cnt(join_m) if join_m is not None else zero,
        "n_live": _cnt(new_state.live_mask) if new_state.live_mask is not None else zero,
    }
    for key in SHARED_COUNTERS:
        metrics.setdefault(key, zero)
    return new_state, metrics
