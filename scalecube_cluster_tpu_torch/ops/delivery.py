"""Structured fan-out and permutation delivery
(port of scalecube_cluster_tpu/ops/delivery.py).

The sim's "network": one tick's gossip sends are ``f`` permutation edges
per member, drawn block-structured so every receiver group reads one
aligned sender window. Per channel c, receiver j's sender is::

    inv[c, j] = group * ginv[c, j // group] + (j + rots[c, j // group]) % group

a bijection per channel (in- and out-degree exactly f). The group is 32
rows when n % 32 == 0, else 8 — it decides which edges are sampled, so the
port keeps the reference's choice.

Every function but :func:`shard_group_routing` (the sharded engine's
bucket routing, one universe's tables) also takes an ensemble's operands
(sim/ensemble.py): a
leading universe axis on the key (a :class:`~..prng.KeyBatch`), the
compact form (``[B, k, n/group]``), the permutations (``[B, k, n]``), the
rows and the edge bits; :func:`take_rows` is the batched row gather.
"""

from __future__ import annotations

import torch

from scalecube_cluster_tpu_torch import prng

#: Row-group size of the structured fan-out when n % 32 != 0.
GROUP = 8


def structured_fanout_draw(key, n: int, k: int, device, group: int = GROUP):
    """``(ginv [k, n/group], rots [k, n/group])`` int32: one group
    permutation per channel plus a per-(channel, receiver-group) rotation."""
    ng = n // group
    if ng * group != n:
        raise ValueError(f"n={n} not a multiple of group={group}")
    ks = prng.split(key, k + 1)
    lead = 1 if isinstance(key, prng.KeyBatch) else 0
    ginv = torch.stack([prng.permutation(ks[c], ng, device) for c in range(k)], dim=lead)
    rots = prng.randint(ks[k], (k, ng), 0, group, device)
    return ginv, rots


def shard_group_routing(ginv: torch.Tensor, d: int):
    """Per-destination-shard bucket routing of the structured fan-out (the
    explicit-SPMD engine's gossip exchange, parallel/spmd.py).

    With ``d`` equal shards each owning ``ngl = ng/d`` contiguous sender
    groups, sender group ``s`` on channel ``c`` sends its whole block to
    receiver group ``gfwd[c, s]``, so to exactly one destination shard.
    Returns ``(dest, rank)``, both ``[k, d, ngl]`` int32: the destination
    shard of shard q's j-th local group on channel c, and its arrival slot
    among shard q's channel-c groups bound there (0-based, in group
    order). ``gfwd[c]`` is a permutation, so a destination receives
    exactly ``ngl`` groups per channel and a bucket of ``ngl`` never
    overflows. ``ginv`` rows are permutations, so the argsort has no ties
    to break."""
    k, ng = ginv.shape
    ngl = ng // d
    if ngl * d != ng:
        raise ValueError(f"{ng} sender groups not divisible by d={d} shards")
    gfwd = torch.argsort(ginv.long(), dim=1).to(torch.int32)
    dest = (gfwd // ngl).reshape(k, d, ngl)
    onehot = dest[..., None] == torch.arange(d, dtype=torch.int32, device=ginv.device)
    csum = torch.cumsum(onehot.to(torch.int32), dim=2, dtype=torch.int32)
    rank = torch.gather(csum, 3, dest[..., None].long())[..., 0] - 1
    return dest, rank


def take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[idx]`` along the member axis: ``x [N, ...]`` with ``idx [...]``,
    or, batched, ``x [B, N, ...]`` with ``idx [B, M]`` (each universe's
    rows from its own ``x``)."""
    if idx.dim() == 1:
        return x[idx.long()]
    b, m = idx.shape
    tail = tuple(x.shape[2:])
    ix = idx.long().reshape((b, m) + (1,) * len(tail)).expand((b, m) + tail)
    return torch.gather(x, 1, ix)


def inv_from_structured(ginv, rots, n: int, group: int = GROUP) -> torch.Tensor:
    """Expand the compact structured form to full ``[k, n]`` sender indices."""
    j = torch.arange(n, dtype=torch.int32, device=ginv.device)
    g = j // group
    return (group * ginv[..., g] + (j + rots[..., g]) % group).to(torch.int32)


def fanout_permutations_structured(key, n: int, k: int, device, group: int = GROUP):
    """``(inv [k, n], ginv, rots)`` — :func:`structured_fanout_draw` plus its
    expansion."""
    ginv, rots = structured_fanout_draw(key, n, k, device, group)
    return inv_from_structured(ginv, rots, n, group), ginv, rots


def perm_from_structured(ginv, rots, n: int, group: int = GROUP) -> torch.Tensor:
    """Forward permutation ``perm[c, i]`` = sender i's c-th receiver, the
    inverse of :func:`inv_from_structured` in closed form (only the
    [k, n/group] group permutation is inverted)."""
    gfwd = torch.argsort(ginv, dim=-1)
    i = torch.arange(n, dtype=torch.int64, device=ginv.device)
    g = gfwd[..., i // group]  # [k, n] receiver group of sender i
    rot = torch.gather(rots.to(torch.int64), -1, g)
    return (group * g + (i - rot) % group).to(torch.int32)


def fanout_permutations(key, n: int, k: int, device):
    """``k`` independent random permutations, the unstructured fan-out of
    an n that is not a multiple of :data:`GROUP`: returns ``(perm, inv)``,
    both ``[k, n]`` int32, sender i's c-th target is ``perm[c, i]`` and
    ``inv[c, perm[c, i]] == i``."""
    ks = prng.split(key, k)
    lead = 1 if isinstance(key, prng.KeyBatch) else 0
    perm = torch.stack([prng.permutation(ks[c], n, device) for c in range(k)], dim=lead)
    return perm, torch.argsort(perm, dim=-1).to(torch.int32)


def permuted_delivery(rows, inv_perm, edge_ok) -> torch.Tensor:
    """Receiver-side gathered delivery: ``[n, M]`` per-receiver max over the
    f senders whose edge delivers, -1 where nothing arrived."""
    out = torch.full_like(rows, -1)
    for c in range(inv_perm.shape[-2]):
        ok = edge_ok[..., c, :, None]
        contrib = torch.where(ok, take_rows(rows, inv_perm[..., c, :]), -1)
        out = torch.maximum(out, contrib)
    return out


def permuted_delivery_two_channel(rows, channel2_mask, inv_perm, edge_ok):
    """:func:`permuted_delivery` producing two maxes from one gather pass:
    over every delivered record and over those passing ``channel2_mask``
    (a callable on the gathered contributions). Returns ``(best_all,
    best_ch2)``, both ``[n, M]``, -1 where empty."""
    best_all = torch.full_like(rows, -1)
    best_ch2 = torch.full_like(rows, -1)
    for c in range(inv_perm.shape[-2]):
        ok = edge_ok[..., c, :, None]
        contrib = torch.where(ok, take_rows(rows, inv_perm[..., c, :]), -1)
        best_all = torch.maximum(best_all, contrib)
        best_ch2 = torch.maximum(best_ch2, torch.where(channel2_mask(contrib), contrib, -1))
    return best_all, best_ch2


def deliver_rows_max(rows, dst, edge_ok, n: int) -> torch.Tensor:
    """Sender i pushes its payload row to ``dst[i, c]`` on every edge c
    whose ``edge_ok[i, c]`` holds; each receiver keeps the elementwise max
    of what it received, -1 where nothing arrived. The reference's
    ``segment_max`` with dropped edges routed to a pad segment ``n``: an
    empty segment holds the dtype's minimum, and the max with -1 follows."""
    m = rows.shape[-1]
    lead = tuple(rows.shape[:-2])
    safe_dst = torch.where(edge_ok, dst, n).long()
    best = torch.full(lead + (n, m), -1, dtype=rows.dtype, device=rows.device)
    lowest = torch.iinfo(rows.dtype).min
    for c in range(dst.shape[-1]):
        seg = torch.full(lead + (n + 1, m), lowest, dtype=rows.dtype, device=rows.device)
        idx = safe_dst[..., c, None].expand(lead + (rows.shape[-2], m))
        seg.scatter_reduce_(-2, idx, rows, "amax")
        best = torch.maximum(best, seg[..., :n, :])
    return best
