"""``sim_tick`` — one gossip period of the dense N-member engine
(port of scalecube_cluster_tpu/sim/tick.py).

Per tick, as in the reference: the FD probe round on its cadence
(:func:`_fd_vectors`), the structured gossip fan-out and its link draws,
the tick core, self-refutation, user gossip (untracked, tracked, or tracked
with the per-link delay model) and, under ``collect``, the metrics.

The tick core runs one of the reference's two paths:

- **fast** (no SYNC due, nobody joining): the fused kernel
  (ops/tick_core.py — csrc/tick_core.cu on the card, its plain version on
  the CPU) when ``params.pallas_delivery`` and n % 128 == 0, the
  reference's own gate; else :func:`_core_xla` without SYNC;
- **slow** (a SYNC tick, or a live node that knows nobody): :func:`_core_xla`
  with the full-table SYNC exchange.

Control flow differs from the reference only in form, never in result:

- the FD and SYNC cadence conds are Python branches on ``t_host``, a host
  mirror of the device tick (they depend on the tick alone);
- "nobody joining" depends on the data: the tick reads one bool back from
  the card just before the core (a plain read, which waits for the work
  queued before it). A SYNC tick skips it.

The tick does not modify the state it is given; the fused path's outputs
are new tensors and the diagonal writes of self-refutation go into them.
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
    permuted_delivery_two_channel,
)
from scalecube_cluster_tpu_torch.ops.merge import (
    DEAD_BIT,
    UNKNOWN_KEY,
    decode_epoch,
    decode_incarnation,
    decode_status,
    encode_key,
    is_alive_key,
    merge_views,
    overrides_same_epoch,
)
from scalecube_cluster_tpu_torch.ops.select import (
    masked_random_choice,
    masked_random_topk,
    probe_cursor_targets,
)
from scalecube_cluster_tpu_torch.ops.tick_core import tick_core
from scalecube_cluster_tpu_torch.sim.faults import (
    FaultPlan,
    edge_blocked,
    link_delay_within_tick,
    link_pass,
    round_trip_in_time,
)
from scalecube_cluster_tpu_torch.sim.knobs import Knobs, edge_live, suspicion_fill
from scalecube_cluster_tpu_torch.sim.params import SimParams
from scalecube_cluster_tpu_torch.sim.state import AGE_STALE, SimState
from scalecube_cluster_tpu_torch.sim.usergossip import AGE_CAP, user_gossip_step

_ALIVE = int(MemberStatus.ALIVE)
_SUSPECT = int(MemberStatus.SUSPECT)
_DEAD = int(MemberStatus.DEAD)

_I32 = torch.int32


def _link_acct(att, blk, passed):
    """Split one message channel: ``att`` messages are sent; each is
    delivered, blocked, or lost to the loss draw. Returns int32
    ``(attempts, delivered, blocked, lost)``."""
    return (
        att.sum(dtype=torch.int32),
        (att & passed).sum(dtype=torch.int32),
        (att & blk).sum(dtype=torch.int32),
        (att & ~blk & ~passed).sum(dtype=torch.int32),
    )


def _acct_add(*accts):
    return tuple(sum(parts) for parts in zip(*accts))


def _acct_zero(device):
    return tuple(torch.zeros((), dtype=torch.int32, device=device) for _ in range(4))


def _count(mask: torch.Tensor) -> torch.Tensor:
    return mask.sum(dtype=_I32)


#: Window of XLA:CPU's tree reduction: a float32 sum of more terms is taken
#: as sums of windows of this many terms, each in order, then over the
#: window sums the same way (its TreeReductionRewriter).
XLA_REDUCE_WINDOW = 32


def xla_row_means_f32(match: torch.Tensor) -> torch.Tensor:
    """The float32 row means of the boolean ``[R, M]`` ``match`` as the
    reference's ``jnp.mean(match, axis=1)`` gives them: XLA turns the
    division by the constant M into a product with M's float32 reciprocal
    (tests/test_torch_dense.py)."""
    m = torch.tensor(float(match.shape[-1]), dtype=torch.float32, device=match.device)
    return match.sum(dim=-1, dtype=torch.float32) * torch.reciprocal(m)


def xla_cpu_sum_f32(x: torch.Tensor) -> torch.Tensor:
    """The float32 sum of the 1-D ``x`` in XLA:CPU's order: zero-padded to
    whole windows of :data:`XLA_REDUCE_WINDOW` (half the padding in front,
    the odd zero at the end, as XLA's reduce-window pads), each window
    summed in order, repeated over the window sums until one window is
    left, which is summed in order. Only float32 adds, each rounded as IEEE
    demands, so the value is the same on every device. It equals the
    reference's ``jnp.sum`` on XLA:CPU at every length
    (tests/test_torch_dense.py). A leading axis (an ensemble's universes)
    sums each row the same way."""
    w = XLA_REDUCE_WINDOW
    lead = tuple(x.shape[:-1])
    while x.shape[-1] > w:
        pad = -x.shape[-1] % w
        x = torch.nn.functional.pad(x, (pad // 2, pad - pad // 2)).view(lead + (-1, w))
        acc = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
        for i in range(w):
            acc = acc + x[..., i]
        x = acc
    total = torch.zeros(lead, dtype=x.dtype, device=x.device)
    for i in range(x.shape[-1]):
        total = total + x[..., i]
    return total


#: Lanes of the float32 accumulator XLA:CPU's loop vectorizer gives a
#: reassociable sum inside a fused tick, and the shortest known trip count
#: it vectorizes (LLVM's minimum: shorter loops stay scalar).
XLA_VEC_LANES = 8
XLA_VEC_MIN_TRIP = 16


def xla_cpu_fused_sum_f32(x: torch.Tensor) -> torch.Tensor:
    """The float32 sum of the 1-D ``x`` as XLA:CPU emits it inside a fused
    tick that vectorizes the reduction (the reference's Rapid tick): more
    than :data:`XLA_REDUCE_WINDOW` terms are split into windows first
    (:func:`xla_cpu_sum_f32`); fewer than :data:`XLA_VEC_MIN_TRIP` are
    summed in order; in between, one :data:`XLA_VEC_LANES`-lane accumulator
    adds the vector body (the first ``n // 8 * 8`` terms, 8 at a time), its
    lanes are reduced as a tree (halves added lane by lane), and the scalar
    tail is added in order. Held against the reference at n = 12 to 64 over
    three chaos schedules (tests/test_torch_rapid.py). A leading axis sums
    each row the same way."""
    n, lanes = x.shape[-1], XLA_VEC_LANES
    if n > XLA_REDUCE_WINDOW or n < XLA_VEC_MIN_TRIP:
        return xla_cpu_sum_f32(x)
    body = n // lanes * lanes
    acc = torch.zeros(tuple(x.shape[:-1]) + (lanes,), dtype=x.dtype, device=x.device)
    for b in range(0, body, lanes):
        acc = acc + x[..., b : b + lanes]
    while acc.shape[-1] > 1:
        half = acc.shape[-1] // 2
        acc = acc[..., :half] + acc[..., half:]
    total = acc[..., 0]
    for i in range(body, n):
        total = total + x[..., i]
    return total

def _fd_vectors(params: SimParams, state: SimState, plan, keys, cand, view0, fd_round, collect):
    """One FD round as per-row vectors: ``(tgt, fd_key, fire, msgs, extras)``.

    Target: the shuffled round-robin cursor, or an i.i.d. Gumbel pick among
    the row's candidates when the cursor slot is not one; direct ping and
    ack with a round-trip deadline draw; k relays by Gumbel top-k for the
    indirect probe, four legs and one deadline draw; DEST_GONE on an epoch
    mismatch. ``extras`` ([7] int32: pings, ping_reqs, acks and the 4
    accounting sums) is None without ``collect``."""
    n = params.n
    dev = view0.device
    k_tgt, k_ping, k_relay = keys
    col = torch.arange(n, dtype=_I32, device=dev)
    alive = state.alive

    rr_tgt = probe_cursor_targets(fd_round, n, dev)
    rr_valid = torch.gather(cand, 1, rr_tgt[:, None].long())[:, 0]
    rand_tgt, rand_valid = masked_random_choice(k_tgt, cand)
    tgt = torch.where(rr_valid, rr_tgt, rand_tgt)
    tgt_l = tgt.long()
    tgt_valid = rr_valid | rand_valid
    vkey = torch.gather(view0, 1, tgt_l[:, None])[:, 0]
    v_inc = decode_incarnation(vkey)
    v_epoch = decode_epoch(vkey)

    probing = alive & tgt_valid
    pk1, pk2, pk3 = prng.split(k_ping, 3)
    fwd_ok = link_pass(pk1, plan, col, tgt)
    ack_ok = link_pass(pk2, plan, tgt, col)
    rt_ok = round_trip_in_time(pk3, plan, [(col, tgt), (tgt, col)], params.ping_timeout_ms)
    alive_t = alive[tgt_l]
    direct_reach = probing & alive_t & fwd_ok & ack_ok & rt_ok

    relay_cand = cand & (col[None, :] != tgt[:, None])
    kr1, rk1, rk2, rk3, rk4, rk5 = prng.split(k_relay, 6)
    ridx, rvalid = masked_random_topk(kr1, relay_cand, params.ping_req_members)
    del relay_cand
    colc, tgtc = col[:, None], tgt[:, None]
    leg_or = link_pass(rk1, plan, colc, ridx)  # origin -> relay
    leg_rt = link_pass(rk2, plan, ridx, tgtc)  # relay -> target
    leg_tr = link_pass(rk3, plan, tgtc, ridx)  # target -> relay
    leg_ro = link_pass(rk4, plan, ridx, colc)  # relay -> origin
    path_ok = round_trip_in_time(
        rk5, plan, [(colc, ridx), (ridx, tgtc), (tgtc, ridx), (ridx, colc)],
        params.ping_req_timeout_ms,
    )
    alive_r = alive[ridx.long()]
    relay_reach = (
        rvalid & alive_r & alive_t[:, None] & leg_or & leg_rt & leg_tr & leg_ro & path_ok
    )
    reached = direct_reach | (probing & relay_reach.any(dim=1))

    gone = reached & (state.epoch[tgt_l] != v_epoch)
    fd_fire = (probing & ~reached) | gone
    fd_key = encode_key(torch.where(gone, _DEAD, _SUSPECT), v_inc, v_epoch)
    accept = (vkey >= 0) & overrides_same_epoch(fd_key, vkey)
    fire = fd_fire & accept
    req_att = (probing & ~direct_reach)[:, None] & rvalid
    msgs = _count(probing) + _count(req_att)
    if not collect:
        return tgt, fd_key, fire, msgs, None

    ack_att = probing & fwd_ok & alive_t
    att2 = req_att & leg_or & alive_r
    att3 = att2 & leg_rt & alive_t[:, None]
    att4 = att3 & leg_tr
    acct = _acct_add(
        _link_acct(probing, edge_blocked(plan, col, tgt), fwd_ok),
        _link_acct(ack_att, edge_blocked(plan, tgt, col), ack_ok),
        _link_acct(req_att, edge_blocked(plan, colc, ridx), leg_or),
        _link_acct(att2, edge_blocked(plan, ridx, tgtc), leg_rt),
        _link_acct(att3, edge_blocked(plan, tgtc, ridx), leg_tr),
        _link_acct(att4, edge_blocked(plan, ridx, colc), leg_ro),
    )
    extras = torch.stack([_count(probing), _count(req_att), _count(reached), *acct])
    return tgt, fd_key, fire, msgs, extras


def _fd_skip(n, collect, dev):
    return (
        torch.zeros((n,), dtype=_I32, device=dev),
        torch.zeros((n,), dtype=_I32, device=dev),
        torch.zeros((n,), dtype=torch.bool, device=dev),
        torch.zeros((), dtype=_I32, device=dev),
        torch.zeros((7,), dtype=_I32, device=dev) if collect else None,
    )


def _core_xla(params, state, plan, seeds, keys, fd_tgtm, fd_key, inv_perm, edge_ok,
              joining, do_sync_tick, with_sync, collect, susp_fill):
    """The unfused core (the reference's XLA chain); ``with_sync`` folds
    the SYNC exchange in; ``susp_fill`` is the countdown a fresh suspicion
    arms (sim/knobs.py). Returns ``(view2, rumor_age, suspect_left,
    rows_next, known_cnt, self_rumor, msgs_sync, sync_acct [4])``."""
    n = params.n
    view0, alive = state.view, state.alive
    dev = view0.device
    k_ssel, k_slink = keys
    col = torch.arange(n, dtype=_I32, device=dev)
    diag = col[None, :] == col[:, None]
    fd_mask = col[None, :] == fd_tgtm[:, None]
    view1 = torch.where(fd_mask, fd_key[:, None], view0)
    # The young payload plus this tick's fired verdicts (age 0).
    rows = torch.where(fd_mask, fd_key[:, None], state.rows)

    best_any, best_alive = permuted_delivery_two_channel(rows, is_alive_key, inv_perm, edge_ok)
    self_rumor = torch.diagonal(best_any).clone()
    best_any = torch.where(diag, UNKNOWN_KEY, best_any)
    best_alive = torch.where(diag, UNKNOWN_KEY, best_alive)
    merged, _ = merge_views(view1, best_any, best_alive)
    merged = torch.where(alive[:, None], merged, view1)
    del rows, best_any, best_alive

    if with_sync:
        s_cand = (((view1 >= 0) & ((view1 & DEAD_BIT) == 0)) | seeds[None, :]) & ~diag
        prt, p_valid = masked_random_choice(k_ssel, s_cand)
        del s_cand
        prt_l = prt.long()
        do_sync = (do_sync_tick | joining) & alive
        sk1, sk2 = prng.split(k_slink)
        s_pass_fwd = link_pass(sk1, plan, col, prt)
        s_pass_rev = link_pass(sk2, plan, prt, col)
        s_fwd = do_sync & p_valid & alive[prt_l] & s_pass_fwd
        s_rev = s_fwd & s_pass_rev
        if collect:
            s_att = do_sync & p_valid
            sync_acct = _acct_add(
                _link_acct(s_att, edge_blocked(plan, col, prt), s_pass_fwd),
                _link_acct(s_fwd, edge_blocked(plan, prt, col), s_pass_rev),
            )
        else:
            sync_acct = _acct_zero(dev)
        best_any_s = deliver_rows_max(view1, prt[:, None], s_fwd[:, None], n)
        full_alive_rows = torch.where(is_alive_key(view1), view1, UNKNOWN_KEY)
        best_alive_s = deliver_rows_max(full_alive_rows, prt[:, None], s_fwd[:, None], n)
        del full_alive_rows
        reply = view1[prt_l]  # SYNC_ACK: the partner's full table
        best_any_s = torch.maximum(
            best_any_s, torch.where(s_rev[:, None], reply, UNKNOWN_KEY)
        )
        best_alive_s = torch.maximum(
            best_alive_s,
            torch.where(s_rev[:, None] & is_alive_key(reply), reply, UNKNOWN_KEY),
        )
        del reply
        self_rumor = torch.maximum(self_rumor, torch.diagonal(best_any_s))
        best_any_s = torch.where(diag, UNKNOWN_KEY, best_any_s)
        best_alive_s = torch.where(diag, UNKNOWN_KEY, best_alive_s)
        out, _ = merge_views(merged, best_any_s, best_alive_s)
        merged = torch.where(alive[:, None], out, merged)
        del out, best_any_s, best_alive_s
        msgs_sync = _count(s_fwd) + _count(s_rev)
    else:
        msgs_sync = torch.zeros((), dtype=_I32, device=dev)
        sync_acct = _acct_zero(dev)

    # Suspicion sweep + aging + tombstones.
    age0 = torch.where(fd_mask, 0, state.rumor_age)
    armed = state.suspect_left > 0
    rearm = merged != view0
    left0 = torch.clamp_min(state.suspect_left.to(_I32) - 1, 0)
    expired = (
        alive[:, None] & armed & ~rearm & (left0 == 0)
        & ((merged & DEAD_BIT) == 0) & ((merged & 1) != 0) & (merged >= 0)
    )
    view2 = torch.where(expired, (merged | DEAD_BIT) & ~1, merged)
    changed = (view2 != view0) & alive[:, None]
    rumor_age = torch.where(
        changed, 0, torch.clamp_max(age0, AGE_STALE - 1) + 1
    ).to(torch.int8)
    tomb = (
        ~diag & ((view2 & DEAD_BIT) != 0) & (view2 >= 0)
        & (rumor_age > params.periods_to_sweep) & alive[:, None]
    )
    view2 = torch.where(tomb, UNKNOWN_KEY, view2)
    is_susp = ((view2 & 1) != 0) & ((view2 & DEAD_BIT) == 0) & (view2 >= 0)
    suspect_left = torch.where(
        is_susp, torch.where(rearm | ~armed, susp_fill, left0), 0
    ).to(torch.int16)
    suspect_left = torch.where(alive[:, None], suspect_left, state.suspect_left)
    rows_next = torch.where(rumor_age < params.periods_to_spread, view2, UNKNOWN_KEY)
    known_cnt = ((view2 >= 0) & ((view2 & DEAD_BIT) == 0) & ~diag).sum(dim=1, dtype=_I32)
    return (
        view2, rumor_age, suspect_left, rows_next, known_cnt, self_rumor,
        msgs_sync, torch.stack(sync_acct),
    )


def _user_gossip_tracked(params, state, plan, k_glink, inv_perm, edge_ok, nonself, elive):
    """Tracked user gossip with exact [N, N, G] infected sets and, under
    ``gossip_delay_model``, the in-flight ledger (test scale only: the
    [f, N, N] one-hots); ``elive`` is the knobs' channel mask or None.
    Returns ``(new_seen, uage, uinf, uflight, msgs_user)``."""
    n, f = params.n, params.gossip_fanout
    dev = state.device
    col = torch.arange(n, dtype=_I32, device=dev)
    alive = state.alive
    urows = state.useen & (state.uage < params.periods_to_spread)
    sent_cols = []
    for c in range(f):
        s = inv_perm[c].long()
        known = state.uinf[s, col.long()]  # [N, G]: sender s knows receiver j has g
        sent_c = urows[s] & ~known & (alive[s] & nonself[c])[:, None]
        if elive is not None:
            sent_c = sent_c & elive[c]
        sent_cols.append(sent_c)
    got = torch.zeros_like(urows)
    uinf_new = state.uinf
    uflight = state.uflight
    onehots = col[None, :] == inv_perm[:, :, None]  # [f, N(recv), N(sender)]
    if params.gossip_delay_model:
        dkeys = prng.split(prng.fold_in(k_glink, 7), f + 1)
        # In-flight copies redraw first, against the ledger before this tick.
        dlv = link_delay_within_tick(dkeys[-1], plan, col[None, :], col[:, None], params.tick_ms)
        delivered = uflight & dlv[:, :, None]
        got = got | delivered.any(dim=1)
        uinf_new = uinf_new | delivered
        uflight = uflight & ~delivered
        for c in range(f):
            in_transit = sent_cols[c] & edge_ok[c][:, None]
            dnow = link_delay_within_tick(dkeys[c], plan, inv_perm[c], col, params.tick_ms)
            arrived = in_transit & dnow[:, None]
            got = got | arrived
            uinf_new = uinf_new | (onehots[c][:, :, None] & arrived[:, None, :])
            uflight = uflight | (
                onehots[c][:, :, None] & (in_transit & ~dnow[:, None])[:, None, :]
            )
    else:
        for c in range(f):
            arrived = sent_cols[c] & edge_ok[c][:, None]
            got = got | arrived
            uinf_new = uinf_new | (onehots[c][:, :, None] & arrived[:, None, :])
    msgs_user = sum(s.sum(dim=0, dtype=_I32) for s in sent_cols)
    new_seen = state.useen | (got & alive[:, None])
    first_seen = new_seen & ~state.useen
    uage = torch.where(first_seen, 0, torch.clamp_max(state.uage + 1, AGE_CAP))
    swept = new_seen & (uage > params.periods_to_sweep)
    new_seen = new_seen & ~swept
    uinf_new = uinf_new & ~swept[:, None, :]
    uflight = uflight & ~swept[:, None, :]
    return new_seen, uage, uinf_new, uflight, msgs_user


def sim_tick(
    params: SimParams,
    state: SimState,
    plan: FaultPlan,
    seeds: torch.Tensor,
    collect: bool = True,
    knobs: Knobs | None = None,
):
    """Advance the cluster one gossip period. Returns ``(new_state,
    metrics)``; under ``collect=False`` the metrics are ``{"tick": t}``.

    ``seeds`` is the ``[N]`` bool seed mask (always eligible SYNC partners).
    ``plan`` is this tick's :class:`FaultPlan` (sim/run.py resolves a
    schedule per tick). ``knobs`` (sim/knobs.py) need
    ``pallas_delivery=False``; identity knobs equal ``knobs=None``."""
    n = params.n
    if knobs is not None and params.pallas_delivery:
        raise ValueError(
            "knobs require the XLA tick core: tick_core_pallas bakes the "
            "suspicion timeout as a kernel constant (set pallas_delivery=False)"
        )
    if not isinstance(plan, FaultPlan):
        raise TypeError(
            f"sim_tick takes one tick's FaultPlan (got {type(plan).__name__}); "
            "run a FaultSchedule through sim/run.py"
        )
    if params.track_user_infected and state.uinf.shape[1] != n:
        raise ValueError(
            "track_user_infected needs state built with track_infected=True "
            f"(uinf is {tuple(state.uinf.shape)}, want ({n}, {n}, G))"
        )
    if params.gossip_delay_model and not params.track_user_infected:
        raise ValueError("gossip_delay_model needs track_user_infected=True")
    if params.gossip_delay_model and state.uflight.shape[1] != n:
        raise ValueError(
            "gossip_delay_model needs state built with delay_model=True "
            f"(uflight is {tuple(state.uflight.shape)}, want ({n}, {n}, G))"
        )
    dev = state.device
    t = state.t_host + 1
    rng_next, k_tgt, k_ping, k_relay, k_gsel, k_glink, k_ssel, k_slink = prng.split(
        state.rng, 8
    )
    view0, alive = state.view, state.alive
    col = torch.arange(n, dtype=_I32, device=dev)
    f = params.gossip_fanout
    do_fd = t % params.fd_period_ticks == 0
    do_sync_tick = t % params.sync_period_ticks == 0
    joining = (state.known_cnt == 0) & alive

    # ------------------------------------------------------------- 1. FD
    if do_fd:
        cand = (view0 >= 0) & ((view0 & DEAD_BIT) == 0) & (col[None, :] != col[:, None])
        fd_tgt, fd_key, fd_fire, msgs_fd, fd_extras = _fd_vectors(
            params, state, plan, (k_tgt, k_ping, k_relay), cand, view0,
            t // params.fd_period_ticks, collect,
        )
        del cand
    else:
        fd_tgt, fd_key, fd_fire, msgs_fd, fd_extras = _fd_skip(n, collect, dev)
    fd_tgtm = torch.where(fd_fire, fd_tgt, -1)

    # ----------------------------------------------- gossip fan-out edges
    structured = n % GROUP == 0
    if structured:
        inv_perm, ginv, rots = fanout_permutations_structured(k_gsel, n, f, dev)
    else:
        _, inv_perm = fanout_permutations(k_gsel, n, f, dev)
        ginv = rots = None
    lks = prng.split(k_glink, f)
    gpass = [link_pass(lks[c], plan, inv_perm[c], col) for c in range(f)]
    edge_ok = torch.stack([alive[inv_perm[c].long()] & gpass[c] for c in range(f)])
    # Knobs: the fan-out cap folds into edge_ok once, so delivery, user
    # gossip and the accounting see the same masked world.
    elive = edge_live(f, knobs)
    if elive is not None:
        edge_ok = edge_ok & elive[:, None]
    susp_fill = suspicion_fill(params.suspicion_ticks, knobs)

    # ------------------------------------------------------ 2+4. tick core
    need_slow = do_sync_tick or bool(joining.any())
    use_fused = params.pallas_delivery and structured and n % 128 == 0 and n == view0.shape[1]
    if not need_slow and use_fused:
        view2, rumor_age, suspect_left, rows_next, self_rumor, known_cnt = tick_core(
            state.rows, view0, state.rumor_age, state.suspect_left, ginv, rots,
            edge_ok, alive, fd_tgtm, fd_key,
            spread=params.periods_to_spread, sweep=params.periods_to_sweep,
            susp_ticks=params.suspicion_ticks, age_stale=AGE_STALE,
        )
        msgs_sync = torch.zeros((), dtype=_I32, device=dev)
        sync_acct = torch.zeros((4,), dtype=_I32, device=dev)
    else:
        (view2, rumor_age, suspect_left, rows_next, known_cnt, self_rumor,
         msgs_sync, sync_acct) = _core_xla(
            params, state, plan, seeds, (k_ssel, k_slink), fd_tgtm, fd_key,
            inv_perm, edge_ok, joining, do_sync_tick, need_slow, collect, susp_fill,
        )

    # --------------------------------------------------- 5. self-refutation
    own_key = torch.diagonal(view2).clone()
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
    torch.diagonal(view2).copy_(torch.where(threat, own_new, own_key))
    age_diag = torch.diagonal(rumor_age)
    age_diag.copy_(torch.where(threat, 0, age_diag))
    rows_diag = torch.diagonal(rows_next)
    rows_diag.copy_(torch.where(threat, own_new, rows_diag))

    # ----------------------------------------------------- 6. user gossip
    nonself = inv_perm != col[None, :]
    if params.track_user_infected:
        new_seen, uage, uinf_new, uflight, msgs_user = _user_gossip_tracked(
            params, state, plan, k_glink, inv_perm, edge_ok, nonself, elive
        )
    else:
        new_seen, uage, msgs_user = user_gossip_step(
            state.useen, state.uage, inv_perm, edge_ok, alive,
            params.periods_to_spread, params.periods_to_sweep, edge_live=elive,
        )
        uinf_new, uflight = state.uinf, state.uflight

    tick = state.tick + 1
    new_state = state.replace(
        view=view2,
        rumor_age=rumor_age,
        suspect_left=suspect_left,
        rows=rows_next,
        known_cnt=known_cnt,
        inc_self=inc_self,
        useen=new_seen,
        uage=uage,
        uinf=uinf_new,
        uflight=uflight,
        tick=tick,
        rng=rng_next,
        t_host=t,
    )
    if not collect:
        return new_state, {"tick": tick}

    # ------------------------------------------------------------- metrics
    diag = col[None, :] == col[:, None]
    is_susp2 = ((view2 & 1) != 0) & ((view2 & DEAD_BIT) == 0) & (view2 >= 0)
    status2 = decode_status(view2)
    n_alive = _count(alive)
    truth_alive = alive[None, :] & (decode_epoch(view2) == state.epoch[None, :])
    ok_alive = truth_alive & (status2 == _ALIVE)
    ok_dead = ~alive[None, :] & ((status2 == _DEAD) | (view2 < 0))
    match = torch.where(alive[None, :], ok_alive, ok_dead) | diag
    viewer_conv = xla_row_means_f32(match)
    # The float32 sum in XLA:CPU's order, the same value on every device.
    conv_sum = xla_cpu_sum_f32(viewer_conv * alive)
    convergence = conv_sum / torch.clamp_min(n_alive, 1)
    # A membership message exists when the sender has something young to
    # say: its payload row, or a verdict fired this tick.
    sender_active = (state.rows >= 0).any(dim=1) | (fd_tgtm >= 0)
    g_att_c = [
        sender_active[inv_perm[c].long()] & alive[inv_perm[c].long()] & nonself[c]
        for c in range(f)
    ]
    if elive is not None:
        g_att_c = [m & elive[c] for c, m in enumerate(g_att_c)]
    msgs_gossip = sum(_count(m) for m in g_att_c)
    g_acct = _acct_zero(dev)
    for c in range(f):
        g_blk = edge_blocked(plan, inv_perm[c], col)
        g_acct = _acct_add(g_acct, _link_acct(g_att_c[c], g_blk, gpass[c]))
    acct = _acct_add(
        tuple(fd_extras[3 + k] for k in range(4)), g_acct, tuple(sync_acct)
    )
    is_susp0 = ((view0 & 1) != 0) & ((view0 & DEAD_BIT) == 0) & (view0 >= 0)
    was_dead = ((view0 & DEAD_BIT) != 0) & (view0 >= 0)
    now_dead = ((view2 & DEAD_BIT) != 0) & (view2 >= 0)
    viewer_live = alive[:, None]
    metrics = {
        "tick": tick,
        "convergence": convergence,
        "n_alive": n_alive,
        "n_suspected": _count(is_susp2 & viewer_live),
        "msgs_gossip": msgs_gossip,
        "msgs_user": msgs_user,
        "msgs_fd": msgs_fd,
        "msgs_sync": msgs_sync,
        "gossip_coverage": (new_seen & alive[:, None]).sum(dim=0, dtype=_I32)
        / torch.clamp_min(n_alive, 1),
        "suspicions_raised": _count(is_susp2 & ~is_susp0 & viewer_live),
        "verdicts_dead": _count(now_dead & ~was_dead & viewer_live),
        "verdicts_alive": _count(
            is_alive_key(view2) & ~is_alive_key(view0) & (view0 >= 0) & viewer_live
        ),
        "gossip_infections": _count(new_seen & ~state.useen),
        "pings": fd_extras[0],
        "ping_reqs": fd_extras[1],
        "acks": fd_extras[2],
        "link_attempts": acct[0],
        "link_delivered": acct[1],
        "fault_blocked": acct[2],
        "fault_lost": acct[3],
        "inc_max": inc_self.max(),
        "epoch_max": state.epoch.max(),
    }
    # The schema's slots of other engines and of the serving / elastic /
    # fleet planes: constant zero on a SWIM tick.
    zero = torch.zeros((), dtype=_I32, device=dev)
    for key in SHARED_COUNTERS:
        metrics.setdefault(key, zero)
    return new_state, metrics

