"""Network-fault plan — NetworkEmulator in tensor form
(port of scalecube_cluster_tpu/sim/faults.py).

Per directed link i→j (NetworkEmulator.java:25-411):

- ``block[i, j]``      — hard block of link i→j,
- ``loss[i, j]``       — probability a message on i→j is dropped,
- ``mean_delay[i, j]`` — mean of the exponential per-message delay in ms.

A ``[1, 1]`` matrix is the compact "same setting on every link" layout
(lookups clamp indices into range). ``link_world`` (sim/topology.py)
overlays a zone-level topology that every edge lookup composes with. The FD
probe is the only deadline-bearing exchange; it draws ONE in-time sample per
probe path from the Erlang tail of the summed leg delays
(:func:`round_trip_in_time_from`). :func:`link_pass_where` and
:func:`link_pass_at` give :func:`link_pass`'s bits at the cells that send
only (Rapid's broadcasts, sim/rapid.py).

Float parity with the reference: XLA:CPU evaluates ``exp`` with the Cephes
polynomial in fused multiply-adds, contracts ``a * b + c`` into one
rounding, and divides exactly; torch's ``exp`` and ``scalar / tensor``
(a reciprocal, then a product) differ in the last bit. Wherever a delay or
a zone loss can reach a comparison, this module computes in XLA:CPU's steps
(:func:`fma_f32`, :func:`xla_exp_f32`): each is a fixed sequence of
correctly rounded elementwise operations, so the card and the CPU give the
same bits.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field

import torch

from scalecube_cluster_tpu_torch import prng
from scalecube_cluster_tpu_torch.sim.topology import LinkWorld


@dataclass
class FaultPlan:
    """Per-directed-link fault settings over an N-member cluster.

    ``delay_free`` is a host-side hint, not part of the plan's value: True
    when no link (and no zone pair of the world) has a delay, None when not
    known yet (:func:`plan_delay_free` reads the device once and caches)."""

    block: torch.Tensor  # [N, N] (or [1, 1]) bool
    loss: torch.Tensor  # [N, N] (or [1, 1]) float32 in [0, 1)
    mean_delay: torch.Tensor  # [N, N] (or [1, 1]) float32 ms (0 = no delay)
    link_world: LinkWorld | None = None
    delay_free: bool | None = field(default=None, compare=False, repr=False)

    def replace(self, **changes) -> "FaultPlan":
        return dataclasses.replace(self, **changes)

    @classmethod
    def clean(cls, n: int, device="cuda") -> "FaultPlan":
        """No faults, dense per-link form."""
        return cls(
            block=torch.zeros((n, n), dtype=torch.bool, device=device),
            loss=torch.zeros((n, n), dtype=torch.float32, device=device),
            mean_delay=torch.zeros((n, n), dtype=torch.float32, device=device),
            delay_free=True,
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
            delay_free=float(torch.tensor(mean_delay_ms, dtype=torch.float32)) == 0.0,
        )

    def with_loss(self, percent: float) -> "FaultPlan":
        """Uniform loss on every link (setDefaultOutboundSettings)."""
        return self.replace(loss=torch.full_like(self.loss, percent / 100.0))

    def with_mean_delay(self, mean_delay_ms: float) -> "FaultPlan":
        """Uniform exponential delay on every link."""
        return self.replace(
            mean_delay=torch.full_like(self.mean_delay, mean_delay_ms), delay_free=None
        )

    def _dense_block(self, what: str) -> torch.Tensor:
        if self.block.shape[0] == 1:
            raise ValueError(f"{what} need a dense plan (FaultPlan.clean(n))")
        return self.block.clone()

    def block_outbound(self, src, dst) -> "FaultPlan":
        """Block link(s) src→dst (blockOutbound, NetworkEmulator.java:87-110)."""
        block = self._dense_block("per-link blocks")
        block[_index(src, block), _index(dst, block)] = True
        return self.replace(block=block)

    def partition(self, group_a, group_b) -> "FaultPlan":
        """Symmetric partition between two member groups."""
        block = self._dense_block("partitions")
        a, b = _index(group_a, block), _index(group_b, block)
        block[a[:, None], b[None, :]] = True
        block[b[:, None], a[None, :]] = True
        return self.replace(block=block)

    def partition_oneway(self, group_a, group_b) -> "FaultPlan":
        """One-way partition: block a→b links only (B still reaches A)."""
        block = self._dense_block("partitions")
        block[_index(group_a, block)[:, None], _index(group_b, block)[None, :]] = True
        return self.replace(block=block)

    def with_link_world(self, world: LinkWorld | None) -> "FaultPlan":
        """Attach (or drop, with ``None``) a zone overlay (sim/topology.py)."""
        return self.replace(link_world=world, delay_free=None)


def _index(idx, like: torch.Tensor) -> torch.Tensor:
    """A member index or index list as an int64 tensor on ``like``'s device
    (int32 ids wrap as the reference's do)."""
    t = torch.as_tensor(idx)
    return t.to(torch.int32).to(device=like.device, dtype=torch.int64)


def plan_delay_free(plan: FaultPlan) -> bool:
    """True when no link of ``plan`` has a delay (so every FD path's miss
    probability is 0). Cached on the plan: one device read per plan."""
    if plan.delay_free is None:
        free = not bool((plan.mean_delay != 0).any())
        if free and plan.link_world is not None:
            free = not bool((plan.link_world.latency != 0).any())
        plan.delay_free = free
    return plan.delay_free


def fma_f32(a: torch.Tensor, b, c) -> torch.Tensor:
    """``a * b + c`` in float32 with one rounding (a fused multiply-add),
    from correctly rounded float64 steps: the product of two float32 is
    exact in float64, the sum is rounded to odd (its lost part recovered by
    TwoSum), and rounding that to float32 is then the single rounding."""
    p = a.double() * _f64(b, a.device)
    c64 = _f64(c, a.device)
    s = p + c64
    bv = s - p
    err = (p - (s - bv)) + (c64 - bv)
    bits = s.view(torch.int64)
    odd = torch.where((err > 0) == (s > 0), bits + 1, bits - 1)
    s = torch.where((err != 0) & ((bits & 1) == 0), odd.view(torch.float64), s)
    return s.float()


def _f64(v, device) -> torch.Tensor:
    """A float32 operand (tensor or constant, constants rounded to float32
    first) widened to float64."""
    return torch.as_tensor(v, dtype=torch.float32, device=device).double()


#: XLA:CPU's float32 ``exp``: Cephes's range reduction and polynomial.
_LOG2E = 1.44269504088896341
_EXP_C1 = -0.693359375
_EXP_C2 = 2.12194440e-4
_EXP_POLY = (1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3, 4.1665795894e-2,
             1.6666665459e-1, 5.0000001201e-1)
_F32_MIN_NORMAL = 2.0 ** -126


def xla_exp_f32(x: torch.Tensor) -> torch.Tensor:
    """``exp(x)`` in float32 bit for bit as XLA:CPU computes it: clamp to
    [-87.8, 88.8], n = floor(x log2(e) + 1/2) clamped to [-127, 127],
    r = x - n ln 2 in two fused steps, a degree-5 polynomial in fused
    multiply-adds, then the product with 2^n; results under the smallest
    normal flush to 0 (XLA:CPU runs with denormals off)."""
    x = torch.clamp(x, -87.8, 88.8)
    n = torch.clamp(torch.floor(fma_f32(x, _LOG2E, 0.5)), -127.0, 127.0)
    r = fma_f32(n, _EXP_C1, x)
    r = fma_f32(n, _EXP_C2, r)
    z = fma_f32(r, _EXP_POLY[0], _EXP_POLY[1])
    for coef in _EXP_POLY[2:]:
        z = fma_f32(z, r, coef)
    z = fma_f32(z, r * r, r) + 1.0
    pow2 = ((n.to(torch.int32) + 127) << 23).view(torch.float32)
    out = z * pow2
    return torch.where(out.abs() < _F32_MIN_NORMAL, torch.zeros_like(out), out)


def _edge_lookup(mat: torch.Tensor, src: torch.Tensor, dst: torch.Tensor):
    """``mat[src, dst]`` honoring the compact [1, 1] layout. A stacked plan
    (``[B, M, M]``, sim/ensemble.py) takes index tensors with a leading
    universe axis (of B or 1) and looks each universe up in its own
    matrix."""
    if mat.dim() == 3:
        return _edge_lookup_stacked(mat, src, dst)
    s = torch.clamp_max(src, mat.shape[0] - 1).long()
    d = torch.clamp_max(dst, mat.shape[1] - 1).long()
    return mat[s, d]


def _edge_lookup_stacked(mat: torch.Tensor, src: torch.Tensor, dst: torch.Tensor):
    b, m = mat.shape[0], mat.shape[1]
    nd = max(src.dim(), dst.dim())
    if m == 1:
        return mat.reshape((b,) + (1,) * (nd - 1))
    s, d = torch.broadcast_tensors(src.long(), dst.long())
    shape = (b,) + tuple(s.shape[1:])
    flat = (s * m + d).expand(shape).reshape(b, -1)
    return torch.gather(mat.reshape(b, m * m), 1, flat).view(shape)


def _zone_pair(world: LinkWorld, mat: torch.Tensor, src, dst) -> torch.Tensor:
    """``mat[zone[src], zone[dst]]`` for broadcast index tensors."""
    return mat[world.zone[src.long()].long(), world.zone[dst.long()].long()]


def edge_blocked(plan: FaultPlan, src, dst) -> torch.Tensor:
    """Per-edge hard-block predicate: the link matrix OR'd with the zone
    overlay's one-way block when a world is attached."""
    blocked = _edge_lookup(plan.block, src, dst)
    if plan.link_world is not None:
        blocked = blocked | _zone_pair(plan.link_world, plan.link_world.block, src, dst)
    return blocked


def edge_loss(plan: FaultPlan, src, dst) -> torch.Tensor:
    """Per-edge drop probability: with a world, the plan's loss composed
    with the zone pair's as independent drops, ``1 - (1-p)(1-q)`` (also
    where q is 0). XLA:CPU fuses the product and the subtraction into one
    rounding on the engines' edge sets ([N], and the relay legs [N, 3]),
    except on a dense plan's two-relay legs ([N, 2]), which its vector
    loop rounds twice; both are reproduced. Where that loop leaves a scalar
    tail, and on the other inner widths it vectorises, the rounding
    follows the host's vector unit and differs (tests/test_torch_topology.py,
    ROADMAP Queue C)."""
    loss = _edge_lookup(plan.loss, src, dst)
    w = plan.link_world
    if w is not None:
        if plan.loss.dim() == 3:
            raise NotImplementedError(
                "zone worlds inside an ensemble are not ported yet (ROADMAP A11 "
                "follow-up): stack plans without link_world"
            )
        q = _zone_pair(w, w.loss, src, dst)
        if plan.loss.shape[0] > 1 and loss.dim() == 2 and loss.shape[-1] == 2:
            loss = 1.0 - (1.0 - loss) * (1.0 - q)
        else:
            loss = fma_f32(loss - 1.0, 1.0 - q, 1.0)
    return loss


def edge_mean_delay(plan: FaultPlan, src, dst) -> torch.Tensor:
    """Per-edge mean exponential delay (ms): plan delay plus the zone
    pair's latency."""
    mean = _edge_lookup(plan.mean_delay, src, dst)
    if plan.link_world is not None:
        mean = mean + _zone_pair(plan.link_world, plan.link_world.latency, src, dst)
    return mean


def link_pass_from(u: torch.Tensor, plan: FaultPlan, src, dst) -> torch.Tensor:
    """A message passes iff its link is unblocked and the caller's uniform
    draw ``u`` survives the loss (OutboundSettings.evaluateLoss)."""
    return ~edge_blocked(plan, src, dst) & (u >= edge_loss(plan, src, dst))


def link_pass(key, plan: FaultPlan, src, dst) -> torch.Tensor:
    """Sample delivery for directed links ``src → dst`` (broadcast index
    tensors): one uniform per edge from ``key``, then :func:`link_pass_from`."""
    shape = torch.broadcast_shapes(src.shape, dst.shape)
    return link_pass_from(prng.uniform(key, tuple(shape), src.device), plan, src, dst)


def _at_cells(x: torch.Tensor, shape, cell: torch.Tensor, universe) -> torch.Tensor:
    """``broadcast_to(x, shape).reshape(-1)[cell]`` without the broadcast;
    with ``universe``, ``x`` broadcasts to ``[B or 1, *shape]`` and each
    cell is read in its universe."""
    lead = 0 if universe is None else 1
    x = x.reshape((1,) * (lead + len(shape) - x.dim()) + tuple(x.shape))
    lin = torch.zeros_like(cell)
    rem = cell
    stride = 1
    for dim in reversed(range(len(shape))):
        coord = rem % shape[dim]
        rem = rem // shape[dim]
        if x.shape[lead + dim] != 1:
            lin = lin + coord * stride
            stride *= x.shape[lead + dim]
    if lead and x.shape[0] != 1:
        lin = lin + universe * stride
    return x.contiguous().reshape(-1)[lin]


def _stacked_cells(mat: torch.Tensor, universe, src, dst) -> torch.Tensor:
    """``mat[universe, src, dst]`` on a stacked ``[B, M, M]`` plan matrix
    (``[B, 1, 1]`` compact)."""
    m = mat.shape[1]
    if m == 1:
        return mat.reshape(-1)[universe]
    s = torch.clamp_max(src, m - 1).long()
    d = torch.clamp_max(dst, m - 1).long()
    return mat.reshape(-1)[(universe * m + s) * m + d]


def link_pass_at(key, plan: FaultPlan, counters: torch.Tensor, src, dst,
                 universe: torch.Tensor | None = None) -> torch.Tensor:
    """:func:`link_pass` at chosen cells of a draw: ``counters`` are the
    cells' flat indices in the draw's shape (int64), ``src``/``dst`` their
    endpoints (shaped like ``counters``). With a :class:`prng.KeyBatch`,
    ``universe`` gives each cell's universe, whose key and (stacked) plan
    it takes."""
    u = prng.uniform_at(key, counters, universe)
    if plan.block.dim() == 3:
        return ~edge_blocked_at(plan, src, dst, universe) & (
            u >= _stacked_cells(plan.loss, universe, src, dst)
        )
    return link_pass_from(u, plan, src, dst)


def edge_blocked_at(plan: FaultPlan, src, dst, universe=None) -> torch.Tensor:
    """:func:`edge_blocked` at cells whose universe is ``universe`` (the
    stacked plan's matrix of each; unused on a plan that is not stacked)."""
    if plan.block.dim() == 3:
        return _stacked_cells(plan.block, universe, src, dst)
    return edge_blocked(plan, src, dst)


def link_pass_where(key, plan: FaultPlan, src, dst, send: torch.Tensor):
    """``link_pass(key, plan, src, dst) & send``, drawing only the cells
    where ``send`` is True. Threefry's partitionable counters give a cell
    the bits of its flat index whatever else is drawn, so every sent cell
    gets the full draw's bits; the other cells are False. A
    :class:`prng.KeyBatch` takes ``send`` with a leading universe axis and
    ``src``/``dst`` with one of B or 1.

    Returns ``(passed, n_sent)``: finding the sent cells is the one host
    read, and ``n_sent`` (a Python int) is what it read. When at least half
    the cells send, the whole shape is drawn instead of gathered (fewer
    bytes). A universe's draw is limited to 2**32 cells (one counter word):
    Rapid's alarm broadcast, n·n·k cells, stays below it for n < 23,170 at
    k = 8."""
    batched = isinstance(key, prng.KeyBatch)
    shape = tuple(send.shape[1:]) if batched else tuple(send.shape)
    numel = math.prod(shape)
    if numel >= 1 << 32:
        raise ValueError("draws of 2**32 elements or more need a high counter word")
    lead = send.shape[0] if batched else 1
    idx = send.reshape(lead, numel).nonzero()
    n_sent = int(idx.shape[0])
    if n_sent == 0:
        return torch.zeros_like(send), 0
    if 2 * n_sent >= lead * numel:
        del idx
        u = prng.uniform(key, shape, send.device)
        return link_pass_from(u, plan, src, dst) & send, n_sent
    universe = idx[:, 0] if batched else None
    cell = idx[:, 1]
    ok = link_pass_at(
        key, plan, cell, _at_cells(src, shape, cell, universe),
        _at_cells(dst, shape, cell, universe), universe,
    )
    out = torch.zeros((lead * numel,), dtype=torch.bool, device=send.device)
    out[idx[:, 0] * numel + cell] = ok
    return out.view(send.shape), n_sent


def link_delay_within_tick(key, plan: FaultPlan, src, dst, tick_ms) -> torch.Tensor:
    """Sample "an exponential link delay elapses within one tick" per edge:
    ``P = 1 - exp(-tick_ms / mean)``, always True on a delay-free link.
    Memoryless, so re-drawing it each tick for a message still in flight
    bins the arrival to tick granularity exactly (the dense engine's
    delayed user gossip)."""
    mean = edge_mean_delay(plan, src, dst)
    ratio = torch.full_like(mean, -tick_ms) / torch.clamp_min(mean, 1e-9)
    p = torch.where(mean > 0, 1.0 - xla_exp_f32(ratio), 1.0)
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

        P(miss) = e^(-x) * sum_{i<k} x^i / i!,   x = deadline / theta,

    in XLA:CPU's steps: an exact division, the term ``x^i / i!`` as a
    product with the float32 reciprocal of i and its add fused. On a
    delay-free plan P(miss) is 0 whatever the bits of the exponential, and
    the plain torch steps are taken (fewer launches)."""
    k = len(legs)
    mean_total = sum(edge_mean_delay(plan, s, d) for s, d in legs)
    theta = mean_total / k
    has_delay = theta > 0
    if plan_delay_free(plan):
        x = deadline_ms / torch.where(has_delay, theta, 1.0)
        term = torch.ones_like(x)
        acc = torch.ones_like(x)
        for i in range(1, k):
            term = term * x / i
            acc = acc + term
        p_miss = torch.where(has_delay, torch.exp(-x) * acc, 0.0)
        return u >= p_miss
    x = torch.full_like(theta, deadline_ms) / torch.where(has_delay, theta, 1.0)
    term = torch.ones_like(x)
    acc = torch.ones_like(x)
    for i in range(1, k):
        prod = term * x
        acc = fma_f32(prod, 1.0 / i, acc)
        term = prod * torch.tensor(1.0 / i, dtype=torch.float32)
    p_miss = torch.where(has_delay, xla_exp_f32(-x) * acc, 0.0)
    return u >= p_miss


def plan_any_faults(plan: FaultPlan) -> torch.Tensor:
    """Scalar bool: could this fixed plan disturb any edge? Latency counts
    as a fault (the whole-plan twin of a schedule's ``seg_dirty``)."""
    dirty = plan.block.any() | (plan.loss > 0).any() | (plan.mean_delay > 0).any()
    if plan.link_world is not None:
        dirty = dirty | plan.link_world.any_faults()
    return dirty
