"""Rapid-style consistent membership, the second protocol engine
(port of scalecube_cluster_tpu/sim/rapid.py).

"Stable and Consistent Membership at Scale with Rapid" (arXiv:1803.03620):
every member keeps an ``[N, N]`` view bitmap, and views change only
through batched view changes committed by a quorum.

1. **k-ring observers** — subject ``s`` is probed by its ring successors
   ``(s+1..s+k) mod n`` (:func:`observer_matrix`); each observer keeps a
   per-edge consecutive-miss counter (``edge_fail``) and, for non-members,
   a consecutive-success counter (``edge_join``).
2. **L/H watermark cut detection** — an edge alarms after L consecutive
   misses (the flap filter); alarms are broadcast and tallied per subject;
   a subject with H or more alarming observers is a stable cut candidate,
   one with 1..H-1 holds the detector unstable.
3. **vote once per configuration, ¾ fast-path quorum** — a member whose
   detector is stable locks its cut as its vote; a receiver commits when
   ``ceil(3/4 · view size)`` members of its exact configuration (view id
   and digest) delivered bit-identical votes.
4. **classic fallback (``fallback=True``)** — a rotating single-decree
   Paxos round in 3-tick phases (prepare/promise, accept/accepted,
   decide) for votes that sit uncommitted, and a seed-routed join
   handshake whose certificates gate admission.

Laggards catch up through a view-sync broadcast every
``sync_period_ticks``. The state, the metrics (the ``SHARED_COUNTERS``
schema plus the consistency-plane traces ``view_id`` / ``view_digest`` /
``view_size`` / ``alive_mask``) and the flight recorder's events are the
reference's, bit for bit (tests/test_torch_rapid.py).

**One tick for one universe or many.** The tick (:func:`_tick`) runs over
a leading universe axis: a solo run is a batch of one, and the ensemble
twin (:func:`run_ensemble_rapid_ticks`) steps B universes in one tick of
the same launches. Every key of a tick is derived on the host
(``prng.KeyTable``), and the phase branches (FD round, SYNC round, the
fallback's three phases) follow the host tick, as the SWIM ticks' cadence
branches do. A branch whose masks are all False on this tick in the
reference is skipped: the probe round off FD ticks, the view sync off SYNC
ticks, each fallback phase off its tick, so no draw is made there.

**No [N, N, N] temporaries, no full [N, N, k] draw.** Every broadcast is
read only through ``send & pass``, so it draws only where a message is
sent (``sim/faults.py::link_pass_where``, one host read a draw, for its
size): the alarm broadcast is drawn over the alarming edges times the
receivers, never over ``[N, N, k]``; the proposal, fallback and join
broadcasts over their senders' columns. Rows that hold the same vote are
grouped by exact ids (:func:`vote_groups`, ``torch.unique`` over the
packed rows), and the quorum and plurality counts are sums over those
groups (:func:`count_same`, a float64 product of 0/1 operands: exact).

Rapid has no Pallas kernel, so this module launches none. Traced or
elastic states inside an ensemble raise, as the SWIM ensembles do
(sim/ensemble.py).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from scalecube_cluster_tpu_torch import prng
from scalecube_cluster_tpu_torch.obs.tracer import (
    TK_ALARM,
    TK_FB_ACCEPT,
    TK_FB_PREPARE,
    TK_JOIN_ACK,
    TK_JOIN_CONFIRM,
    TK_JOIN_EV,
    TK_JOIN_REQ,
    TK_KILL,
    TK_RESTART,
    TK_VIEW_COMMIT,
    TK_VOTE,
    TraceRing,
    init_trace_ring,
    pad_trace_ring,
    trace_emit,
    trace_reset_members,
)
from scalecube_cluster_tpu_torch.ops import merge as merge_ops
from scalecube_cluster_tpu_torch.sim.ensemble import (
    _check_states,
    _Inputs,
    _stack_built,
    _stack_traces,
    _step,
    ensemble_size,
)
from scalecube_cluster_tpu_torch.sim.ensemble_tick import (
    _acct_zero,
    _cnt,
    _link_acct,
    _shared_tick,
    _take,
    _take2,
)
from scalecube_cluster_tpu_torch.sim.faults import (
    FaultPlan,
    edge_blocked,
    edge_blocked_at,
    link_pass_at,
    link_pass_from,
    link_pass_where,
)
from scalecube_cluster_tpu_torch.sim.knobs import _SUSP_MAX, Knobs
from scalecube_cluster_tpu_torch.sim.run import check_plan
from scalecube_cluster_tpu_torch.sim.schedule import (
    FaultSchedule,
    host_events_at,
    plan_at,
    plan_dirty_at,
)
from scalecube_cluster_tpu_torch.sim.tick import _acct_add, xla_cpu_sum_f32, xla_row_means_f32

_I32 = torch.int32
_M32 = 0xFFFFFFFF


@dataclass(frozen=True)
class RapidParams:
    """Static protocol constants of an ``n``-member Rapid cluster."""

    n: int
    #: Observers per subject: the ring successors (s+1..s+k) mod n.
    k: int = 8
    #: L: consecutive failed probes of an in-view subject before the edge
    #: alarms (and consecutive successful probes of a non-member before a
    #: join alarm).
    low_watermark: int = 4
    #: H: alarming observers that make a subject a stable cut candidate.
    high_watermark: int = 6
    #: Probe cadence in ticks.
    fd_period_ticks: int = 2
    #: View-sync broadcast cadence in ticks.
    sync_period_ticks: int = 5
    #: Fast-path commit threshold, ``ceil(quorum_num / quorum_den · view
    #: size)`` identical votes; must exceed 1/2.
    quorum_num: int = 3
    quorum_den: int = 4
    #: Ticks a locked vote may sit uncommitted before its holder arms the
    #: classic fallback (inert without a FallbackState).
    fallback_delay_ticks: int = 6

    def __post_init__(self):
        if not 1 <= self.k < self.n:
            raise ValueError(f"need 1 <= k < n, got k={self.k} n={self.n}")
        if not 1 <= self.high_watermark <= self.k:
            raise ValueError(
                f"need 1 <= high_watermark <= k, got H={self.high_watermark}"
                f" k={self.k}"
            )
        if self.low_watermark < 1:
            raise ValueError("low_watermark must be >= 1")
        if not 0 < self.quorum_num <= self.quorum_den:
            raise ValueError("quorum must be a fraction in (0, 1]")
        if 2 * self.quorum_num <= self.quorum_den:
            raise ValueError(
                "quorum must exceed 1/2 (single-majority safety, R3)"
            )
        if self.fd_period_ticks < 1 or self.sync_period_ticks < 1:
            raise ValueError("periods must be >= 1 tick")
        if self.fallback_delay_ticks < 1:
            raise ValueError("fallback_delay_ticks must be >= 1")


@dataclass
class FallbackState:
    """The classic fallback and join-handshake plane (``fallback=True``
    states only). Paxos half: ``promised``, the latest acceptance
    (``acc_*``), the coordinator's staged proposal (``prop_*``,
    ``prop_ready``) and decide flag (``decided``), and ``wait``, the ticks
    a locked vote has sat uncommitted. Join half: the handshake phase (0
    idle, 1 requesting, 2 confirming, 3 certified), the seed candidate, the
    failed attempts, the seed's digest, and the certificates ``join_ok[m,
    j]`` (m knows j completed a handshake)."""

    wait: torch.Tensor  # [N] int32
    promised: torch.Tensor  # [N] int32
    acc_rank: torch.Tensor  # [N] int32 (-1 = none)
    acc_rm: torch.Tensor  # [N, N] bool
    acc_add: torch.Tensor  # [N, N] bool
    prop_rm: torch.Tensor  # [N, N] bool
    prop_add: torch.Tensor  # [N, N] bool
    prop_ready: torch.Tensor  # [N] bool
    decided: torch.Tensor  # [N] bool
    join_phase: torch.Tensor  # [N] int32
    join_seed: torch.Tensor  # [N] int32
    join_tries: torch.Tensor  # [N] int32
    join_digest: torch.Tensor  # [N] int32
    join_ok: torch.Tensor  # [N, N] bool

    def replace(self, **changes) -> "FallbackState":
        return dataclasses.replace(self, **changes)


def init_fallback_state(n: int, device="cuda") -> FallbackState:
    """Quiescent fallback plane: nothing armed, every joiner idle with its
    ring successor as the first seed candidate."""
    col = torch.arange(n, dtype=_I32, device=device)

    def zeros(shape, dtype=_I32):
        return torch.zeros(shape, dtype=dtype, device=device)

    return FallbackState(
        wait=zeros((n,)),
        promised=zeros((n,)),
        acc_rank=torch.full((n,), -1, dtype=_I32, device=device),
        acc_rm=zeros((n, n), torch.bool),
        acc_add=zeros((n, n), torch.bool),
        prop_rm=zeros((n, n), torch.bool),
        prop_add=zeros((n, n), torch.bool),
        prop_ready=zeros((n,), torch.bool),
        decided=zeros((n,), torch.bool),
        join_phase=zeros((n,)),
        join_seed=(col + 1) % n,
        join_tries=zeros((n,)),
        join_digest=zeros((n,)),
        join_ok=zeros((n, n), torch.bool),
    )


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c`` modulo 2**32 for uint32 values held in int64, in 16-bit
    halves so no product leaves int64."""
    return ((x & 0xFFFF) * c + ((((x >> 16) * c) & 0xFFFF) << 16)) & _M32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """Splitmix-style uint32 avalanche of the coordinator rotation, as an
    int64 tensor of uint32 values."""
    x = x.long() & _M32
    x = _mul32(x, 0x9E3779B9)
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    return x ^ (x >> 13)


@dataclass
class RapidState:
    """Complete state of an N-member Rapid cluster (tensors over members).

    ``rng`` is the raw threefry key (``uint32[2]``; ``[B, 2]`` stacked) and
    ``t_host`` mirrors ``tick`` on the host (``int64[B]`` stacked)."""

    member_mask: torch.Tensor  # [N, N] bool: row m = m's view
    view_id: torch.Tensor  # [N] int32
    edge_fail: torch.Tensor  # [N, k] int32 consecutive misses per edge
    edge_join: torch.Tensor  # [N, k] int32 consecutive successes of a non-member
    vote_rm: torch.Tensor  # [N, N] bool locked removal batch
    vote_add: torch.Tensor  # [N, N] bool locked addition batch
    voted: torch.Tensor  # [N] bool
    epoch: torch.Tensor  # [N] int32 restart generation
    alive: torch.Tensor  # [N] bool ground truth
    tick: torch.Tensor  # [] int32
    rng: np.ndarray
    t_host: int = 0
    #: The flight recorder's ring (obs/tracer.py); None keeps the tick
    #: without it.
    trace: TraceRing | None = None
    #: The fallback and join plane; None is the bare fast path.
    fb: FallbackState | None = None
    #: Elastic membership: True for rows that have ever been live.
    live_mask: torch.Tensor | None = None  # [N] bool

    def replace(self, **changes) -> "RapidState":
        return dataclasses.replace(self, **changes)

    @property
    def device(self) -> torch.device:
        return self.alive.device


def observer_matrix(n: int, k: int, device="cuda") -> torch.Tensor:
    """``[N, k]`` int32: the observers of subject ``s`` are its ring
    successors ``(s + 1 + j) % n``."""
    s = torch.arange(n, dtype=torch.int64, device=device)[:, None]
    j = torch.arange(k, dtype=torch.int64, device=device)[None, :]
    return ((s + 1 + j) % n).to(_I32)


def _digest_weights(n: int) -> np.ndarray:
    """Per-subject pseudo-random uint32 weights of the membership digest."""
    x = np.arange(1, n + 1, dtype=np.uint64)
    x = (x * np.uint64(0x9E3779B97F4A7C15)) & np.uint64(0xFFFFFFFFFFFFFFFF)
    x ^= x >> np.uint64(31)
    x = (x * np.uint64(0xBF58476D1CE4E5B9)) & np.uint64(0xFFFFFFFFFFFFFFFF)
    x ^= x >> np.uint64(27)
    return (x & np.uint64(0xFFFFFFFF)).astype(np.uint32)


def _weights(n: int, device) -> torch.Tensor:
    return torch.from_numpy(_digest_weights(n).astype(np.int64)).to(device)


def view_digest(member_mask: torch.Tensor, weights: torch.Tensor | None = None) -> torch.Tensor:
    """``[...]`` int32 digest of each view bitmap: the wrapping uint32 sum
    of the members' weights, its bits read as int32. Summed in int64 (no
    row of weights reaches 2**63) and masked to 32 bits. ``weights`` (the
    :func:`_digest_weights` as int64 on the mask's device) saves their
    upload."""
    if weights is None:
        weights = _weights(member_mask.shape[-1], member_mask.device)
    d = torch.where(member_mask, weights, 0).sum(dim=-1) & _M32
    return torch.where(d >= 1 << 31, d - (1 << 32), d).to(_I32)


def rapid_low_watermark(params: RapidParams, knobs: Knobs | None):
    """The effective L watermark: the constant without knobs, else
    ``round(L · suspicion_mult)`` (half to even, as both frameworks round)
    clipped to [1, 32767]."""
    if knobs is None:
        return params.low_watermark
    scaled = torch.round(params.low_watermark * knobs.suspicion_mult).to(_I32)
    return torch.clamp(scaled, 1, _SUSP_MAX)


def init_rapid_full_view(
    params: RapidParams,
    seed: int = 0,
    trace_capacity: int = 0,
    fallback: bool = False,
    n_live: int | None = None,
    device="cuda",
) -> RapidState:
    """Post-bootstrap steady state: every member holds configuration 0, the
    full membership. ``trace_capacity > 0`` attaches the flight recorder's
    ring, ``fallback=True`` the fallback plane. ``n_live`` starts only the
    first ``n_live`` rows live (configuration 0 is that cohort; the other
    rows are dead singleton capacity that scheduled joins activate)."""
    n = params.n
    if n_live is None or n_live == n:
        live = None
        mm = torch.ones((n, n), dtype=torch.bool, device=device)
        alive = torch.ones((n,), dtype=torch.bool, device=device)
    else:
        if not 0 < n_live < n:
            raise ValueError(f"n_live={n_live} outside (0, {n})")
        live = torch.arange(n, device=device) < n_live
        eye = torch.eye(n, dtype=torch.bool, device=device)
        mm = (live[:, None] & live[None, :]) | eye
        alive = live
    zeros = torch.zeros((n,), dtype=_I32, device=device)
    return RapidState(
        member_mask=mm,
        view_id=zeros,
        edge_fail=torch.zeros((n, params.k), dtype=_I32, device=device),
        edge_join=torch.zeros((n, params.k), dtype=_I32, device=device),
        vote_rm=torch.zeros((n, n), dtype=torch.bool, device=device),
        vote_add=torch.zeros((n, n), dtype=torch.bool, device=device),
        voted=torch.zeros((n,), dtype=torch.bool, device=device),
        epoch=zeros.clone(),
        alive=alive,
        tick=torch.zeros((), dtype=_I32, device=device),
        rng=prng.PRNGKey(seed),
        trace=init_trace_ring(n, trace_capacity, device=device) if trace_capacity else None,
        fb=init_fallback_state(n, device=device) if fallback else None,
        live_mask=None if live is None else live.clone(),
    )


def promote_rapid_state(
    params: RapidParams, state: RapidState, n_new: int
) -> tuple[RapidParams, RapidState]:
    """Embed an ``n_old``-row state into an ``n_new``-row allocation,
    verbatim on the old rows; the new rows are dead singletons outside
    every view. The per-edge counters re-arm at 0 (the observer ring is a
    function of n), the ring's log carries and its registers pad. Returns
    ``(params_new, state_new)``."""
    n_old = params.n
    if n_new <= n_old:
        raise ValueError(f"promotion must grow: n_new={n_new} <= n={n_old}")
    dev = state.device

    def grow1(x, fill):
        out = torch.full((n_new,), fill, dtype=x.dtype, device=dev)
        out[:n_old] = x
        return out

    def grow2(x, fill):
        out = torch.full((n_new, n_new), fill, dtype=x.dtype, device=dev)
        out[:n_old, :n_old] = x
        return out

    live_old = (
        state.live_mask
        if state.live_mask is not None
        else torch.ones((n_old,), dtype=torch.bool, device=dev)
    )
    fb = state.fb
    if fb is not None:
        fb0 = init_fallback_state(n_new, device=dev)
        fb0.join_seed[:n_old] = fb.join_seed
        fb = fb0.replace(
            wait=grow1(fb.wait, 0),
            promised=grow1(fb.promised, 0),
            acc_rank=grow1(fb.acc_rank, -1),
            acc_rm=grow2(fb.acc_rm, False),
            acc_add=grow2(fb.acc_add, False),
            prop_rm=grow2(fb.prop_rm, False),
            prop_add=grow2(fb.prop_add, False),
            prop_ready=grow1(fb.prop_ready, False),
            decided=grow1(fb.decided, False),
            join_phase=grow1(fb.join_phase, 0),
            join_tries=grow1(fb.join_tries, 0),
            join_digest=grow1(fb.join_digest, 0),
            join_ok=grow2(fb.join_ok, False),
        )
    eye = torch.eye(n_new, dtype=torch.bool, device=dev)
    state_new = RapidState(
        member_mask=grow2(state.member_mask, False) | eye,
        view_id=grow1(state.view_id, 0),
        edge_fail=torch.zeros((n_new, params.k), dtype=_I32, device=dev),
        edge_join=torch.zeros((n_new, params.k), dtype=_I32, device=dev),
        vote_rm=grow2(state.vote_rm, False),
        vote_add=grow2(state.vote_add, False),
        voted=grow1(state.voted, False),
        epoch=grow1(state.epoch, 0),
        alive=grow1(state.alive, False),
        tick=state.tick.clone(),
        rng=np.array(state.rng, dtype=np.uint32),
        t_host=state.t_host,
        trace=pad_trace_ring(state.trace, n_new) if state.trace is not None else None,
        fb=fb,
        live_mask=grow1(live_old, False),
    )
    return dataclasses.replace(params, n=n_new), state_new


# ------------------------------------------------------------ batch of one
def _map_tensors(record, fn):
    """``record`` with ``fn`` applied to every tensor leaf (a FallbackState
    recursed into; the trace ring left as it is)."""
    fields = {}
    for f in dataclasses.fields(record):
        v = getattr(record, f.name)
        if isinstance(v, torch.Tensor):
            v = fn(v)
        elif isinstance(v, FallbackState):
            v = _map_tensors(v, fn)
        fields[f.name] = v
    return type(record)(**fields)


def _lift(state: RapidState) -> RapidState:
    """A solo state as a batch of one universe (views, no copies)."""
    lifted = _map_tensors(state, lambda x: x[None])
    return lifted.replace(
        rng=np.asarray(state.rng, dtype=np.uint32).reshape(1, 2),
        t_host=np.array([state.t_host], dtype=np.int64),
    )


def _lower(state: RapidState) -> RapidState:
    lowered = _map_tensors(state, lambda x: x[0])
    return lowered.replace(rng=state.rng[0].copy(), t_host=int(state.t_host[0]))


# --------------------------------------------------------------- events
def apply_events_rapid(
    params: RapidParams,
    state: RapidState,
    kill_mask: torch.Tensor,
    restart_mask: torch.Tensor,
    join_mask: torch.Tensor | None = None,
) -> RapidState:
    """Scripted kill / restart / join at the top of a tick, consuming no
    RNG. A restart is a fresh identity (epoch bump, view reset to the
    bootstrap configuration 0, every per-edge counter it owns or that is
    about it cleared). ``join_mask`` (join-aware callers; None is the
    legacy form) mints an identity like a restart; with the fallback plane
    it starts from the singleton view {self} and arms the handshake, as
    restarts do there. Takes ``[N]`` masks, or ``[B, N]`` on a stacked
    state. The reference's ``lax.cond`` is a host ``if``: one host read of
    whether any event fires (the runners know it already and skip it)."""
    fired = kill_mask | restart_mask
    if join_mask is not None:
        fired = fired | join_mask
    if not bool(fired.any()):
        return state
    return _apply_events(params, state, kill_mask, restart_mask, join_mask)


def _apply_events(params, st, kill_mask, restart_mask, join_mask):
    n = params.n
    dev = st.device
    obs = observer_matrix(n, params.k, dev).long()
    eye = torch.eye(n, dtype=torch.bool, device=dev)
    fresh = restart_mask if join_mask is None else restart_mask | join_mask
    new_epoch = torch.where(
        fresh, torch.clamp_max(st.epoch + 1, merge_ops.EPOCH_MAX), st.epoch
    )
    row = fresh[..., :, None]
    if st.live_mask is None:
        boot = torch.ones((n,), dtype=torch.bool, device=dev)
    else:
        boot = st.live_mask | fresh
    boot = boot[..., None, :]
    if join_mask is not None and st.fb is not None:
        mm = torch.where(restart_mask[..., :, None], boot, st.member_mask)
        mm = torch.where(join_mask[..., :, None], eye, mm)
    else:
        mm = torch.where(row, boot, st.member_mask)
    reset_edges = fresh[..., obs] | fresh[..., :, None]
    out = st.replace(
        alive=(st.alive & ~kill_mask) | fresh,
        epoch=new_epoch,
        member_mask=mm | eye,
        view_id=torch.where(fresh, 0, st.view_id),
        edge_fail=torch.where(reset_edges, 0, st.edge_fail),
        edge_join=torch.where(reset_edges, 0, st.edge_join),
        vote_rm=torch.where(row, False, st.vote_rm),
        vote_add=torch.where(row, False, st.vote_add),
        voted=st.voted & ~fresh,
    )
    if st.live_mask is not None:
        out = out.replace(live_mask=st.live_mask | fresh)
    fb = st.fb
    if fb is not None:
        touched = kill_mask | fresh
        first_seed = (torch.arange(n, dtype=_I32, device=dev) + 1) % n
        out = out.replace(fb=fb.replace(
            wait=torch.where(fresh, 0, fb.wait),
            promised=torch.where(fresh, 0, fb.promised),
            acc_rank=torch.where(fresh, -1, fb.acc_rank),
            acc_rm=torch.where(row, False, fb.acc_rm),
            acc_add=torch.where(row, False, fb.acc_add),
            prop_rm=torch.where(row, False, fb.prop_rm),
            prop_add=torch.where(row, False, fb.prop_add),
            prop_ready=fb.prop_ready & ~fresh,
            decided=fb.decided & ~fresh,
            join_phase=torch.where(fresh, 1, torch.where(kill_mask, 0, fb.join_phase)),
            join_seed=torch.where(fresh, first_seed, fb.join_seed),
            join_tries=torch.where(fresh, 0, fb.join_tries),
            join_digest=torch.where(fresh, 0, fb.join_digest),
            join_ok=torch.where(touched[..., None, :], False, fb.join_ok),
        ))
    if st.trace is not None:
        # Control-plane events land before anything this tick emits.
        t_ev = int(np.asarray(st.t_host).reshape(-1)[0]) + 1
        col = torch.arange(n, dtype=_I32, device=dev)
        ring, _ = trace_emit(st.trace, TK_KILL, kill_mask.reshape(-1), t_ev, -1, col)
        ring, _ = trace_emit(ring, TK_RESTART, restart_mask.reshape(-1), t_ev, -1, col)
        if join_mask is not None:
            ring, _ = trace_emit(ring, TK_JOIN_EV, join_mask.reshape(-1), t_ev, -1, col)
        out = out.replace(trace=trace_reset_members(ring, fresh.reshape(-1)))
    return out


# ------------------------------------------------------------ vote groups
def vote_groups(vote_rm: torch.Tensor, vote_add: torch.Tensor):
    """Exact equality classes of the vote rows ``vote_rm[b, m] ‖
    vote_add[b, m]`` (``[B, N, N]`` each): returns ``(gid, g)``, ``gid``
    ``[B, N]`` int64 with ``gid[b, m] == gid[b, m2]`` iff the two rows are
    bit-equal, the ids of a universe dense in ``[0, g)``. The rows are
    packed into int64 words and grouped by ``torch.unique(dim=0)`` (one
    host read), never compared pairwise."""
    b, n, _ = vote_rm.shape
    bits = torch.cat([vote_rm, vote_add], dim=2).to(torch.uint8)
    bits = torch.nn.functional.pad(bits, (0, -bits.shape[2] % 64))
    shifts = torch.arange(8, dtype=torch.uint8, device=bits.device)
    packed = (bits.view(b, n, -1, 8) << shifts).sum(dim=3, dtype=torch.uint8)
    words = packed.view(torch.int64)  # [B, N, W]
    universe = torch.arange(b, device=bits.device).repeat_interleave(n)[:, None]
    rows = torch.cat([universe, words.reshape(b * n, -1)], dim=1)
    _, inverse = torch.unique(rows, dim=0, return_inverse=True)
    inverse = inverse.view(b, n)
    gid = inverse - inverse.min(dim=1, keepdim=True).values
    return gid, int(gid.max()) + 1


def count_same(recv: torch.Tensor, gid: torch.Tensor, g: int, members=None):
    """``cnt[b, r, m] = Σ_{m2} recv[b, r, m2] · [gid[b, m2] == gid[b, m]]``
    (over ``members[b, m2]`` only, when given), as int32: the reference's
    ``recv @ same`` with ``same`` the pairwise row equality, computed as a
    product with the ``[B, N, g]`` group one-hots. The operands are 0/1
    and the sums at most N, so the float64 product is exact."""
    onehot = gid[:, :, None] == torch.arange(g, device=gid.device)
    if members is not None:
        onehot = onehot & members[:, :, None]
    per_group = torch.bmm(recv.to(torch.float64), onehot.to(torch.float64)).to(_I32)
    return torch.gather(per_group, 2, gid[:, None, :].expand(-1, recv.shape[1], -1))


def _rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[b, idx[b, i], :]`` for ``x [B, N, C]`` and ``idx [B, N]``."""
    return torch.gather(x, 1, idx.long()[:, :, None].expand(-1, -1, x.shape[2]))


def _diag(x: torch.Tensor) -> torch.Tensor:
    return torch.diagonal(x, dim1=1, dim2=2)


def _first_true(mask: torch.Tensor) -> torch.Tensor:
    """``argmax`` of a bool ``[B, N, N]`` over its last axis (the first
    True; 0 where none)."""
    return mask.to(torch.uint8).argmax(dim=2)


# --------------------------------------------------------------- the tick
class _Consts:
    """A run's constants on its device: member ids, the observer ring, the
    identity and the digest weights (made once a run, not once a tick)."""

    def __init__(self, n: int, k: int, device):
        self.col = torch.arange(n, dtype=_I32, device=device)
        self.obs = observer_matrix(n, k, device).long()
        self.eye = torch.eye(n, dtype=torch.bool, device=device)
        self.weights = _weights(n, device)


def _tick_keys(rng: np.ndarray, count: int, device, stacked: bool):
    """The tick's ``count`` keys from the stacked ``uint32[B, 2]`` keys:
    for a solo run (one universe, a plan that is not stacked), raw keys
    (their words are Python ints in the draws: nothing to upload); for an
    ensemble, :class:`prng.KeyBatch` es whose schedules go to the device in
    one upload."""
    if not stacked:
        return list(prng.split(rng[0], count))
    table = prng.KeyTable(rng)
    keys = prng.split(table.root, count)
    table.upload(device)
    return keys


def _key_words(key) -> np.ndarray:
    return key[None].copy() if isinstance(key, np.ndarray) else key.words.copy()


def _uniform(key, shape, device) -> torch.Tensor:
    """``[B, *shape]`` uniforms of a tick key (:func:`_tick_keys`)."""
    if isinstance(key, np.ndarray):
        return prng.uniform(key, shape, device)[None]
    return prng.uniform(key, shape, device)


def _pass_where(key, plan, src, dst, send):
    """:func:`~..faults.link_pass_where` of a tick key over ``[B, ...]``
    sends (``src``/``dst`` with a leading axis of 1 or B)."""
    if isinstance(key, np.ndarray):
        passed, n_sent = link_pass_where(key, plan, src[0], dst[0], send[0])
        return passed[None], n_sent
    return link_pass_where(key, plan, src, dst, send)


def _alarm_broadcast(params, plan, key, alarmed, join_alarm, alive, obs, col):
    """The alarm broadcast over the alarming edges only: observer
    ``obs[s, j]`` tells every receiver about its alarmed edge (s, j). The
    reference draws one uniform per (receiver, subject, slot) of ``[N, N,
    k]``; here the draw is at the flat counters ``r·N·k + s·k + j`` of the
    alarming edges' cells (one host read, the edge list). Returns
    ``(tally_rm, tally_add, acct, msgs)``: the per-receiver, per-subject
    counts of delivered remove and join alarms and the per-universe
    accounting; None when no edge alarms (nothing is sent or tallied)."""
    n, k = params.n, params.k
    b = alive.shape[0]
    dev = alive.device
    any_alarm = (alarmed | join_alarm).reshape(b, n * k)
    edges = any_alarm.nonzero()
    if edges.shape[0] == 0:
        return None
    eb, ecell = edges[:, 0], edges[:, 1]
    esrc = obs.reshape(-1)[ecell]  # the alarming observer
    recv = col.long()[None, :]  # [1, N] receivers
    send = recv != esrc[:, None]  # [E, N]
    counters = recv * (n * k) + ecell[:, None]
    universe = eb[:, None]
    src, dst = esrc[:, None].expand(-1, n), recv.expand(esrc.shape[0], -1)
    passed = link_pass_at(key, plan, counters, src, dst, universe) & send
    blocked = edge_blocked_at(plan, src, dst, universe)
    per_edge = (
        send.sum(dim=1, dtype=_I32),
        passed.sum(dim=1, dtype=_I32),
        (send & blocked).sum(dim=1, dtype=_I32),
        (send & ~blocked & ~passed).sum(dim=1, dtype=_I32),
    )

    def per_universe(x):
        return torch.zeros((b,), dtype=_I32, device=dev).index_add_(0, eb, x)

    acct = tuple(per_universe(x) for x in per_edge)
    heard = (passed | ~send) & alive[eb]  # [E, N]: receivers that hold the alarm
    is_rm = alarmed.reshape(b, n * k)[eb, ecell][:, None]
    column = eb * n + torch.div(ecell, k, rounding_mode="floor")  # (universe, subject)

    def tally(mask):  # [B, receiver, subject]: each edge adds into its subject's column
        out = torch.zeros((n, b * n), dtype=_I32, device=dev)
        out.index_add_(1, column, mask.to(_I32).T)
        return out.view(n, b, n).permute(1, 0, 2)

    return tally(heard & is_rm), tally(heard & ~is_rm), acct, acct[0]


def _tick(params: RapidParams, st: RapidState, plan: FaultPlan, collect: bool,
          knobs: Knobs | None, consts: "_Consts | None" = None):
    """One Rapid round over a stacked state (leading universe axis B, one
    shared host tick): probe → alarm broadcast → tally → watermark cut →
    vote lock → proposal broadcast and fast-path quorum → (fallback
    phases) → view sync. Returns ``(state, metrics)`` with ``[B]``-leading
    metrics. Events are applied by the caller first."""
    n, k = params.n, params.k
    dev = st.device
    b = st.alive.shape[0]
    t = _shared_tick(st) + 1
    fb = st.fb
    keys = _tick_keys(st.rng, 6 if fb is None else 16, dev, plan.block.dim() == 3)
    if fb is None:
        rng_next, k_probe, k_ack, k_alarm, k_prop, k_sync = keys
    else:
        (rng_next, k_probe, k_ack, k_alarm, k_prop, k_sync,
         k_prep_s, k_prep_r, k_acc_s, k_acc_r, k_dec,
         k_jreq, k_jack, k_jcon, k_jcack, k_jbc) = keys
    consts = consts or _Consts(n, k, dev)
    col, obs, eye = consts.col, consts.obs, consts.eye
    obs1, subj1 = obs[None], col.long()[None, :, None]  # [1, N, k], [1, N, 1]
    alive = st.alive
    mm = st.member_mask
    low = rapid_low_watermark(params, knobs)
    if isinstance(low, torch.Tensor):
        low = low.reshape(-1, 1, 1)
    memo = {}

    def digest():  # [B, N] configuration digests, made when first read
        if "dg" not in memo:
            memo["dg"] = view_digest(mm, consts.weights)
        return memo["dg"]

    def same_cfg():  # [B, N, N]: the two members hold one configuration
        dg = digest()
        return (st.view_id[:, :, None] == st.view_id[:, None, :]) & (
            dg[:, :, None] == dg[:, None, :])

    view_size = mm.sum(dim=2, dtype=_I32)
    zero = torch.zeros((b,), dtype=_I32, device=dev)

    # ---- 1. k-ring probe round (fd cadence) -----------------------------
    in_view = _take2(mm, obs1, subj1)  # [B, N, k]: the observer holds the subject
    alive_obs = _take(alive, obs1)
    if t % params.fd_period_ticks == 0:
        probe_active = alive_obs
        ping_blk = edge_blocked(plan, obs1, subj1)
        ping_pass = link_pass_from(_uniform(k_probe, (n, k), dev), plan, obs1, subj1)
        ack_active = probe_active & ping_pass & alive[:, :, None]
        ack_blk = edge_blocked(plan, subj1, obs1)
        ack_pass = link_pass_from(_uniform(k_ack, (n, k), dev), plan, subj1, obs1)
        probe_ok = ack_active & ack_pass
        acct = _acct_add(
            _link_acct(probe_active, ping_blk, ping_pass),
            _link_acct(ack_active, ack_blk, ack_pass),
        )
        pings = _cnt(probe_active)
        acks = _cnt(probe_ok)
        msgs_fd = pings + _cnt(ack_active)
        edge_fail = torch.where(
            probe_active & in_view,
            torch.where(probe_ok, 0, st.edge_fail + 1),
            torch.where(in_view, st.edge_fail, 0),
        )
        edge_join = torch.where(
            probe_active & ~in_view,
            torch.where(probe_ok, st.edge_join + 1, 0),
            torch.where(~in_view, st.edge_join, 0),
        )
    else:
        acct = _acct_zero(b, dev)
        pings = acks = msgs_fd = zero
        edge_fail = torch.where(in_view, st.edge_fail, 0)
        edge_join = torch.where(~in_view, st.edge_join, 0)
    alarmed = in_view & alive_obs & (edge_fail >= low)
    join_alarm = ~in_view & alive_obs & (edge_join >= low)
    if knobs is not None:
        # Knobs.fanout_cap caps the alarm fan-out: only observer slots
        # j < cap raise and broadcast alarms (cap >= k is the identity).
        slot_ok = torch.arange(k, dtype=_I32, device=dev) < knobs.fanout_cap.reshape(-1, 1, 1)
        alarmed = alarmed & slot_ok
        join_alarm = join_alarm & slot_ok
    crossed_rm = alarmed & (st.edge_fail < low)  # edges crossing L on this tick
    crossed_join = join_alarm & (st.edge_join < low)
    alarm_new = crossed_rm | crossed_join
    alarms_raised = _cnt(crossed_rm) + _cnt(crossed_join)

    src_p = col[None, None, :]  # [1, 1, N] sender columns
    dst_p = col[None, :, None]  # [1, N, 1] receiver rows
    others = ~eye

    def blk_p():  # [B or 1, N, N] hard blocks of every member pair, made when first read
        if "blk" not in memo:
            memo["blk"] = edge_blocked(plan, src_p, dst_p)
        return memo["blk"]

    is_p0, is_p1, is_p2 = t % 3 == 0, t % 3 == 1, t % 3 == 2
    rank = t // 3 + 1
    if fb is not None:
        # ---- join handshake: request -> ack -> confirm -> confirm-ack ----
        seed = torch.clamp(fb.join_seed, 0, n - 1)
        col1 = col[None, :]
        ph1 = (fb.join_phase == 1) & alive
        ph2 = (fb.join_phase == 2) & alive
        if bool((ph1 | ph2).any()):  # one host read: the legs draw only while one is open
            alive_seed = _take(alive, seed)
            req_pass = link_pass_from(_uniform(k_jreq, (n,), dev), plan, col1, seed)
            acct = _acct_add(acct, _link_acct(ph1, edge_blocked(plan, col1, seed), req_pass))
            req_ok = ph1 & req_pass & alive_seed
            ack_pass = link_pass_from(_uniform(k_jack, (n,), dev), plan, seed, col1)
            acct = _acct_add(acct, _link_acct(req_ok, edge_blocked(plan, seed, col1), ack_pass))
            ack_ok = req_ok & ack_pass
            con_pass = link_pass_from(_uniform(k_jcon, (n,), dev), plan, col1, seed)
            acct = _acct_add(acct, _link_acct(ph2, edge_blocked(plan, col1, seed), con_pass))
            con_ok = ph2 & con_pass & alive_seed
            cack_pass = link_pass_from(_uniform(k_jcack, (n,), dev), plan, seed, col1)
            acct = _acct_add(acct, _link_acct(con_ok, edge_blocked(plan, seed, col1), cack_pass))
            cack_ok = con_ok & cack_pass
            # Seed-side certificate latch (one cell per column: no collisions).
            flat = (seed.long() * n + col1.long())
            join_ok_l = fb.join_ok.reshape(b, n * n).clone()
            latched_prev = torch.gather(join_ok_l, 1, flat)
            new_latch = con_ok & ~latched_prev
            join_ok_l.scatter_(1, flat, latched_prev | con_ok)
            join_ok_l = join_ok_l.view(b, n, n)
            # Any failed leg rotates the seed candidate and re-enters phase 1.
            fail = (ph1 & ~ack_ok) | (ph2 & ~cack_ok)
            tries_j = torch.where(fail, fb.join_tries + 1, fb.join_tries)
            next_seed = (col1 + 1 + tries_j % (n - 1)) % n
            join_seed_j = torch.where(fail, next_seed, seed)
            join_phase_j = torch.where(
                ack_ok, 2,
                torch.where(cack_ok, 3, torch.where(ph2 & ~cack_ok, 1, fb.join_phase)),
            )
            join_digest_j = torch.where(ack_ok, _take(digest(), seed), fb.join_digest)
        else:
            req_ok = ack_ok = con_ok = new_latch = torch.zeros_like(ph1)
            join_ok_l = fb.join_ok
            tries_j, join_seed_j = fb.join_tries, seed
            join_phase_j, join_digest_j = fb.join_phase, fb.join_digest
        # Certificate gossip: every holder re-broadcasts its rows each tick.
        has_cert = join_ok_l.any(dim=2) & alive
        holders = has_cert.any(dim=0).nonzero()[:, 0]  # one host read
        sent_jb = zero
        join_ok_now = join_ok_l
        if holders.numel():
            send_jb = has_cert[:, None, :] & others
            pass_jb, _ = _pass_where(k_jbc, plan, src_p, dst_p, send_jb)
            acct = _acct_add(acct, _link_acct(send_jb, blk_p(), pass_jb))
            sent_jb = _cnt(send_jb)
            got_jb = (pass_jb | (has_cert[:, None, :] & eye)) & alive[:, :, None]
            # Only the holders' columns reach: an exact 0/1 float64 product.
            reach = torch.bmm(
                got_jb[:, :, holders].to(torch.float64),
                join_ok_l[:, holders, :].to(torch.float64),
            )
            join_ok_now = join_ok_l | (reach > 0)
        join_requests = _cnt(ph1)
        join_confirms = _cnt(new_latch)

        # ---- classic fallback, phase 0 (prepare/promise) -----------------
        armed = alive & st.voted & (fb.wait >= params.fallback_delay_ticks)
        cand = (((_mix32(st.view_id) + rank) & _M32) % n).to(_I32)
        coord_now = armed & (cand == col1) & is_p0
        promised_p0 = fb.promised
        prop_rm_new, prop_add_new = fb.prop_rm, fb.prop_add
        got_maj = torch.zeros_like(coord_now)
        fb_msgs = sent_jb + _cnt(ph1) + _cnt(req_ok) + _cnt(ph2) + _cnt(con_ok)

        def cfg_coord():  # receivers that honour this sender as their coordinator
            return alive[:, :, None] & same_cfg() & (cand[:, :, None] == src_p)

        if is_p0:
            send_prep = coord_now[:, None, :] & others
            pass_pp, n_prep = _pass_where(k_prep_s, plan, src_p, dst_p, send_prep)
        if is_p0 and n_prep:  # without a coordinator nothing is heard, granted or picked
            acct = _acct_add(acct, _link_acct(send_prep, blk_p(), pass_pp))
            heard_prep = (pass_pp | (coord_now[:, None, :] & eye)) & cfg_coord()
            grant = heard_prep.any(dim=2) & (rank > fb.promised)
            promised_p0 = torch.where(grant, rank, fb.promised)
            # Promise replies carry each acceptor's latest acceptance; a
            # locked fast-path vote is the rank-0 accept.
            asked = grant[:, None, :] & heard_prep.transpose(1, 2)
            send_rep = asked & others
            pass_rp, _ = _pass_where(k_prep_r, plan, src_p, dst_p, send_rep)
            acct = _acct_add(acct, _link_acct(send_rep, blk_p(), pass_rp))
            prom = (pass_rp | (asked & eye)) & alive[:, :, None]
            got_maj = coord_now & (prom.sum(dim=2, dtype=_I32) >= view_size // 2 + 1)
            fb_msgs = fb_msgs + _cnt(send_prep) + _cnt(send_rep)
            # Value pick: the highest-rank classic acceptance, else the
            # strict plurality among reported rank-0 votes.
            eff_rank = torch.where(
                fb.acc_rank >= 1, fb.acc_rank, torch.where(st.voted, 0, -1)
            )[:, None, :]
            best_rank = torch.where(prom, eff_rank, -2).max(dim=2).values
            rank_col = (n - 1 - col)[None, None, :]
            cls_score = torch.where(
                prom & (eff_rank == best_rank[:, :, None]) & (best_rank[:, :, None] >= 1),
                rank_col, -1,
            )
            p0set = prom & (eff_rank == 0)
            gid_v, g_v = vote_groups(st.vote_rm, st.vote_add)
            support = count_same(p0set, gid_v, g_v)
            z_score = torch.where(p0set, support * (n + 1) + rank_col, -1)
            a_star = torch.where(best_rank >= 1, cls_score.argmax(dim=2), z_score.argmax(dim=2))
            classic = (fb.acc_rank >= 1)[:, :, None]
            eff_rm = torch.where(classic, fb.acc_rm, st.vote_rm)
            eff_add = torch.where(classic, fb.acc_add, st.vote_add)
            prop_rm_new = torch.where(coord_now[:, :, None], _rows(eff_rm, a_star), fb.prop_rm)
            prop_add_new = torch.where(coord_now[:, :, None], _rows(eff_add, a_star), fb.prop_add)
        fallback_rounds = _cnt(coord_now)

    # ---- 2-3. alarm broadcast, tally, H/L stability filter ---------------
    alarm = _alarm_broadcast(params, plan, k_alarm, alarmed, join_alarm, alive, obs, col)
    if alarm is None:  # no tally: no detector is stable or unstable
        msgs_gossip = zero
        newly_voting = torch.zeros_like(alive)
        vote_rm, vote_add = st.vote_rm, st.vote_add
    else:
        tally_rm, tally_add, acct_a, msgs_gossip = alarm
        acct = _acct_add(acct, acct_a)
        h = params.high_watermark
        stable_rm = (tally_rm >= h) & mm
        stable_add = (tally_add >= h) & ~mm
        if fb is not None:
            # Admission is handshake-gated: a join certificate must be held.
            stable_add = stable_add & join_ok_now
        unstable = ((tally_rm >= 1) & (tally_rm < h) & mm) | (
            (tally_add >= 1) & (tally_add < h) & ~mm
        )
        del alarm, tally_rm, tally_add
        newly_voting = (
            alive & ~st.voted & (stable_rm | stable_add).any(dim=2) & ~unstable.any(dim=2)
        )
        if fb is not None:
            # Vote freeze: a member that granted a promise locks no new vote.
            newly_voting = newly_voting & (promised_p0 == 0)
        vote_rm = torch.where(newly_voting[:, :, None], stable_rm, st.vote_rm)
        vote_add = torch.where(newly_voting[:, :, None], stable_add, st.vote_add)
        del stable_rm, stable_add, unstable
    voted = st.voted | newly_voting
    cut_detected = _cnt(newly_voting)
    proposing = alive & voted

    # ---- 4. vote broadcast + fast-path quorum ---------------------------
    msgs_sync = zero
    if bool(proposing.any()):  # one host read: without a vote nothing is sent
        send_p = proposing[:, None, :] & others
        pass_p, _ = _pass_where(k_prop, plan, src_p, dst_p, send_p)
        acct = _acct_add(acct, _link_acct(send_p, blk_p(), pass_p))
        msgs_sync = _cnt(send_p)
        del send_p
        recv_p = (pass_p | (proposing[:, None, :] & eye)) & alive[:, :, None] & same_cfg()
        gid, g = vote_groups(vote_rm, vote_add)
        cnt = torch.where(proposing[:, None, :], count_same(recv_p, gid, g, proposing), 0)
        thr = (params.quorum_num * view_size + params.quorum_den - 1) // params.quorum_den
        valid = recv_p & (cnt >= thr[:, :, None])
        any_valid = valid.any(dim=2)
        score = torch.where(valid, cnt * (n + 1) + (n - 1 - col)[None, None, :], -1)
        winner = score.argmax(dim=2)
        del recv_p, cnt, valid, score
        batch_rm = _rows(vote_rm, winner) & any_valid[:, :, None]
        batch_add = _rows(vote_add, winner) & any_valid[:, :, None]
        # A member never applies a batch evicting itself.
        commit = alive & any_valid & ~_diag(batch_rm)
        batch_rm = batch_rm & commit[:, :, None]
        batch_add = batch_add & commit[:, :, None]
        del pass_p
    else:
        winner = torch.zeros((b, n), dtype=torch.int64, device=dev)
        commit = torch.zeros((b, n), dtype=torch.bool, device=dev)
        batch_rm = batch_add = None
    if fb is not None:
        # ---- classic fallback, phase 1 (accept/accepted) -----------------
        promised_p1 = promised_p0
        acc_rank_new, acc_rm_new, acc_add_new = fb.acc_rank, fb.acc_rm, fb.acc_add
        decided_now = torch.zeros_like(alive)
        if is_p1:
            acc_now = fb.prop_ready & alive
            send_acc = acc_now[:, None, :] & others
            pass_ac, n_acc = _pass_where(k_acc_s, plan, src_p, dst_p, send_acc)
        if is_p1 and n_acc:  # no staged proposal: nothing is accepted
            acct = _acct_add(acct, _link_acct(send_acc, blk_p(), pass_ac))
            heard_acc = (pass_ac | (acc_now[:, None, :] & eye)) & cfg_coord()
            acc_ok = heard_acc.any(dim=2) & (rank >= promised_p0)
            a_src = _first_true(heard_acc)
            promised_p1 = torch.where(acc_ok, torch.clamp_min(promised_p0, rank), promised_p0)
            acc_rank_new = torch.where(acc_ok, rank, fb.acc_rank)
            acc_rm_new = torch.where(acc_ok[:, :, None], _rows(prop_rm_new, a_src), fb.acc_rm)
            acc_add_new = torch.where(acc_ok[:, :, None], _rows(prop_add_new, a_src), fb.acc_add)
            asked = acc_ok[:, None, :] & heard_acc.transpose(1, 2)
            send_ar = asked & others
            pass_ar, _ = _pass_where(k_acc_r, plan, src_p, dst_p, send_ar)
            acct = _acct_add(acct, _link_acct(send_ar, blk_p(), pass_ar))
            acc_votes = (pass_ar | (asked & eye)) & alive[:, :, None]
            decided_now = acc_now & (
                acc_votes.sum(dim=2, dtype=_I32) >= view_size // 2 + 1
            )
            fb_msgs = fb_msgs + _cnt(send_acc) + _cnt(send_ar)
        if is_p1:
            decided_next = decided_now
        elif is_p2:
            decided_next = torch.zeros_like(fb.decided)
        else:
            decided_next = fb.decided
        if is_p0:
            prop_ready_next = got_maj
        elif is_p2:
            prop_ready_next = torch.zeros_like(fb.prop_ready)
        else:
            prop_ready_next = fb.prop_ready

        # ---- classic fallback, phase 2 (decide) + commit merge -----------
        fb_commit = torch.zeros_like(alive)
        d_src = torch.zeros((b, n), dtype=torch.int64, device=dev)
        if is_p2:
            dec_now = fb.decided & alive
            send_dec = dec_now[:, None, :] & others
            pass_dc, n_dec = _pass_where(k_dec, plan, src_p, dst_p, send_dec)
        if is_p2 and n_dec:  # no decree: nothing commits through the classic path
            acct = _acct_add(acct, _link_acct(send_dec, blk_p(), pass_dc))
            heard_dec = (pass_dc | (dec_now[:, None, :] & eye)) & cfg_coord()
            d_src = _first_true(heard_dec)
            evicts_self = _take2(prop_rm_new, d_src, col[None, :])
            fb_commit = heard_dec.any(dim=2) & ~evicts_self & ~commit
            commit = commit | fb_commit
            fb_rm = _rows(prop_rm_new, d_src) & fb_commit[:, :, None]
            fb_add = _rows(prop_add_new, d_src) & fb_commit[:, :, None]
            batch_rm = fb_rm if batch_rm is None else batch_rm | fb_rm
            batch_add = fb_add if batch_add is None else batch_add | fb_add
            fb_msgs = fb_msgs + _cnt(send_dec)
        fallback_commits = _cnt(fb_commit)
        msgs_sync = msgs_sync + fb_msgs
    view_changes = _cnt(commit)
    if batch_rm is None:
        verdicts_dead = verdicts_alive = zero
        mm2 = mm | eye
    else:
        verdicts_dead = _cnt(batch_rm)
        verdicts_alive = _cnt(batch_add)
        mm2 = ((mm & ~batch_rm) | batch_add) | eye
        del batch_rm, batch_add
    vid2 = st.view_id + commit.to(_I32)

    # ---- 5. view sync: laggards adopt the highest configuration ---------
    # Off SYNC ticks nobody sends, every member's best sender is itself and
    # nothing is adopted (view ids stay far below 2**31 / (n + 1), where
    # the reference's int32 score would wrap).
    mm3, vid3 = mm2, vid2
    adopt = torch.zeros_like(alive)
    if t % params.sync_period_ticks == 0:
        send_s = alive[:, None, :] & others
        pass_s, _ = _pass_where(k_sync, plan, src_p, dst_p, send_s)
        acct = _acct_add(acct, _link_acct(send_s, blk_p(), pass_s))
        msgs_sync = msgs_sync + _cnt(send_s)
        avail = (pass_s | eye) & alive[:, None, :]
        del send_s, pass_s
        sync_score = torch.where(
            avail, vid2[:, None, :] * (n + 1) + (n - 1 - col)[None, None, :], -1
        )
        best = sync_score.argmax(dim=2)
        del avail, sync_score
        cand_mask = _rows(mm2, best)
        includes_self = _diag(cand_mask)
        ahead = _take(vid2, best) > vid2
        adopt = alive & ahead & includes_self
        mm3 = torch.where(adopt[:, :, None], cand_mask, mm2) | eye
        vid3 = torch.where(adopt, _take(vid2, best), vid2)
        del cand_mask
        if fb is not None:
            # Evicted behind its back: the road back is the join handshake,
            # toward the best sync sender, unless one is already open.
            trigger = alive & ahead & ~includes_self & (join_phase_j == 0)
            join_phase_j = torch.where(trigger, 1, join_phase_j)
            join_seed_j = torch.where(trigger, best.to(_I32), join_seed_j)
            tries_j = torch.where(trigger, 0, tries_j)

    # ---- causal flight recorder (solo states only) -----------------------
    ring = st.trace
    if ring is not None:
        ring, _ = trace_emit(
            ring, TK_ALARM, alarm_new[0], t, obs, subj1[0].expand(n, k),
            aux=join_alarm[0].to(_I32),
        )
        ring, vote_pos = trace_emit(
            ring, TK_VOTE, newly_voting[0], t, col, col,
            aux=vote_rm[0].sum(dim=1, dtype=_I32),
        )
        if fb is None:
            ring, _ = trace_emit(
                ring, TK_VIEW_COMMIT, commit[0], t, col, winner[0].to(_I32), aux=vid2[0]
            )
        else:
            # origin[m]: m's latest vote (or the join ack it echoes);
            # last_miss[c]: coordinator c's prepare, then its accept.
            ring = ring.replace(origin=torch.where(newly_voting[0], vote_pos, ring.origin))
            ring, prep_pos = trace_emit(
                ring, TK_FB_PREPARE, coord_now[0], t, col, col, cause=ring.origin, aux=rank
            )
            ring = ring.replace(last_miss=torch.where(coord_now[0], prep_pos, ring.last_miss))
            ring, accp_pos = trace_emit(
                ring, TK_FB_ACCEPT, decided_now[0], t, col, col, cause=ring.last_miss, aux=rank
            )
            ring = ring.replace(
                last_miss=torch.where(decided_now[0], accp_pos, ring.last_miss)
            )
            fbc, dsrc = fb_commit[0], d_src[0]
            ring, _ = trace_emit(
                ring, TK_VIEW_COMMIT, commit[0], t, col,
                torch.where(fbc, dsrc, winner[0]).to(_I32),
                cause=torch.where(fbc, ring.last_miss[dsrc], -1),
                aux=vid2[0],
            )
            ring, req_pos = trace_emit(
                ring, TK_JOIN_REQ, ph1[0], t, col, seed[0], aux=fb.join_tries[0]
            )
            ring, ack_pos = trace_emit(
                ring, TK_JOIN_ACK, ack_ok[0], t, seed[0], col, cause=req_pos,
                aux=torch.where(ack_ok[0], _take(digest(), seed)[0], 0),
            )
            ring = ring.replace(origin=torch.where(ack_ok[0], ack_pos, ring.origin))
            ring, _ = trace_emit(
                ring, TK_JOIN_CONFIRM, new_latch[0], t, seed[0], col, cause=ring.origin
            )

    # Every view change (commit or adoption) starts a fresh configuration.
    view_changed = commit | adopt
    vc3 = view_changed[:, :, None]
    fb_next = None
    if fb is not None:
        fb_next = FallbackState(
            wait=torch.where(alive & voted & ~view_changed, fb.wait + 1, 0),
            promised=torch.where(view_changed, 0, promised_p1),
            acc_rank=torch.where(view_changed, -1, acc_rank_new),
            acc_rm=torch.where(vc3, False, acc_rm_new),
            acc_add=torch.where(vc3, False, acc_add_new),
            prop_rm=torch.where(vc3, False, prop_rm_new),
            prop_add=torch.where(vc3, False, prop_add_new),
            prop_ready=prop_ready_next & ~view_changed,
            decided=decided_next & ~view_changed,
            join_phase=torch.where(view_changed, 0, join_phase_j),
            join_seed=join_seed_j,
            join_tries=torch.where(view_changed, 0, tries_j),
            join_digest=join_digest_j,
            join_ok=join_ok_now & ~mm3,
        )
    tick = torch.full((b,), t, dtype=_I32, device=dev)
    new_state = st.replace(
        fb=fb_next,
        member_mask=mm3,
        view_id=vid3,
        edge_fail=edge_fail,
        edge_join=edge_join,
        vote_rm=torch.where(vc3, False, vote_rm),
        vote_add=torch.where(vc3, False, vote_add),
        voted=voted & ~view_changed,
        tick=tick,
        rng=_key_words(rng_next),
        t_host=np.full((b,), t, dtype=np.int64),
        trace=ring,
    )
    if not collect:
        return new_state, {"tick": tick}

    # ---- metrics (SHARED_COUNTERS schema + consistency-plane traces) ----
    n_alive = _cnt(alive)
    # The reference's float32 row means and live-viewer sum, in XLA:CPU's
    # steps as the dense engine takes them (ROADMAP Queue C: inside the
    # fused Rapid tick the host's vector loop may reassociate that sum).
    viewer_conv = xla_row_means_f32((mm3 == alive[:, None, :]) | eye)
    convergence = xla_cpu_sum_f32(viewer_conv * alive) / torch.clamp_min(n_alive, 1)
    metrics = {
        "tick": tick,
        "convergence": convergence,
        "n_alive": n_alive,
        "view_changes": view_changes,
        "alarms_raised": alarms_raised,
        "cut_detected": cut_detected,
        "pings": pings,
        "ping_reqs": zero,
        "acks": acks,
        "suspicions_raised": zero,
        "verdicts_dead": verdicts_dead,
        "verdicts_alive": verdicts_alive,
        "gossip_infections": zero,
        "msgs_fd": msgs_fd,
        "msgs_sync": msgs_sync,
        "msgs_gossip": msgs_gossip,
        "link_attempts": acct[0],
        "link_delivered": acct[1],
        "fault_blocked": acct[2],
        "fault_lost": acct[3],
        "exchange_overflow": zero,
        "ingest_overflow": zero,
        "ingest_rejected": zero,
        "ingest_backpressure": zero,
        "serve_batches": zero,
        "fallback_rounds": fallback_rounds if fb is not None else zero,
        "fallback_commits": fallback_commits if fb is not None else zero,
        "join_requests": join_requests if fb is not None else zero,
        "join_confirms": join_confirms if fb is not None else zero,
        "inc_max": zero,
        "epoch_max": st.epoch.max(dim=1).values,
        "joins_admitted": zero,
        "joins_deferred": zero,
        "promotions": zero,
        "n_live": _cnt(st.live_mask) if st.live_mask is not None else zero,
        "tenants_active": zero,
        "tenants_deferred": zero,
        "tenant_evictions": zero,
        "fleet_launches": zero,
        "view_id": vid3,
        "view_digest": view_digest(mm3, consts.weights),
        "view_size": mm3.sum(dim=2, dtype=_I32),
        "alive_mask": alive,
    }
    if ring is not None:
        metrics["trace_overflow"] = ring.overflow[None]
    return new_state, metrics


def rapid_tick(params: RapidParams, state: RapidState, plan: FaultPlan,
               collect: bool = True, knobs: Knobs | None = None):
    """One Rapid round of a solo state (the tick of a batch of one).
    Returns ``(state, metrics)``; consumes ``state``'s trace ring."""
    new_state, metrics = _tick(params, _lift(state), plan, collect, knobs)
    return _lower(new_state), {k: v[0] for k, v in metrics.items()}


# ---------------------------------------------------------------- runners
def run_rapid_ticks(
    params: RapidParams,
    state: RapidState,
    plan: FaultPlan | FaultSchedule,
    n_ticks: int,
    collect: bool = True,
    knobs: Knobs | None = None,
):
    """Run ``n_ticks`` Rapid rounds; returns ``(final_state, traces)``,
    every trace a device tensor with a leading tick axis. ``plan`` is a
    fixed :class:`FaultPlan` or a :class:`FaultSchedule`: a scheduled run
    applies the tick's events first (the join lane too when the state
    carries ``fb`` or ``live_mask``) and adds ``plan_dirty`` /
    ``kills_fired`` / ``restarts_fired`` (/ ``joins_fired``)."""
    scheduled = check_plan(plan)
    joins = state.fb is not None or state.live_mask is not None
    record = scheduled and collect
    gauges = {"plan_dirty": [], "kills_fired": [], "restarts_fired": []}
    if joins:
        gauges["joins_fired"] = []
    dev = state.device
    st = _lift(state)
    consts = _Consts(params.n, params.k, dev)
    per_tick = []
    for _ in range(n_ticks):
        plan_t = plan
        if scheduled:
            t = int(st.t_host[0]) + 1
            plan_t = plan_at(plan, t)
            ev = host_events_at(plan, t, params.n, joins=joins)
            if ev is not None:
                masks = [torch.from_numpy(m).to(dev)[None] for m in ev]
                st = _apply_events(params, st, masks[0], masks[1], masks[2] if joins else None)
            if record:
                gauges["plan_dirty"].append(plan_dirty_at(plan, t))
                for key, m in zip(("kills_fired", "restarts_fired", "joins_fired"),
                                  ev if ev is not None else [None] * 3):
                    if key in gauges:
                        gauges[key].append(0 if m is None else int(m.sum()))
        st, metrics = _tick(params, st, plan_t, collect, knobs, consts)
        per_tick.append(metrics)
    state = _lower(st)
    if not per_tick:
        return state, {}
    traces = {k: torch.stack([m[k][0] for m in per_tick]) for k in per_tick[0]}
    if record:
        for key, vals in gauges.items():
            dtype = torch.bool if key == "plan_dirty" else _I32
            traces[key] = torch.tensor(vals, dtype=dtype, device=dev)
    return state, traces


#: The reference's unjitted scan body; here it is the same loop.
scan_rapid_ticks = run_rapid_ticks


def init_ensemble_rapid(params: RapidParams, init_seeds, fallback: bool = False,
                        device="cuda") -> RapidState:
    """Stacked :func:`init_rapid_full_view` states, one per RNG seed."""
    seeds = [int(s) for s in init_seeds]
    return _stack_built(
        lambda i: init_rapid_full_view(params, seed=seeds[i], fallback=fallback, device=device),
        len(seeds),
    )


def run_ensemble_rapid_ticks(
    params: RapidParams,
    states: RapidState,
    plans: FaultPlan | FaultSchedule,
    n_ticks: int,
    collect: bool = True,
    knobs: Knobs | None = None,
):
    """B Rapid universes, one batched tick a tick (the reference's vmap):
    ``states`` / ``plans`` / ``knobs`` stacked (sim/ensemble.py). Universe
    b is bit-identical to the same solo run. Returns ``(states, traces)``
    with every trace ``[B, n_ticks, ...]``."""
    _check_states(states)
    b = ensemble_size(states)
    inputs = _Inputs(plans, b, params.n, states.device, collect, joins=states.fb is not None)
    consts = _Consts(params.n, params.k, states.device)

    def tick(st, plan, events, kn):
        if events is not None:
            st = _apply_events(params, st, events[0], events[1],
                               events[2] if len(events) == 3 else None)
        return _tick(params, st, plan, collect, kn, consts)

    per_tick = []
    for _ in range(n_ticks):
        plan, events = inputs.at(np.asarray(states.t_host) + 1)
        states, metrics = _step(tick, states, plan, events, knobs, collect)
        per_tick.append(metrics)
    if not per_tick:
        return states, {}
    return states, inputs.finish(_stack_traces(per_tick))
