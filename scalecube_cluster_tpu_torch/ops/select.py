"""Random peer selection: batched Gumbel top-k and the shuffled round-robin
probe cursor (port of scalecube_cluster_tpu/ops/select.py).

Relay, gossip and SYNC-partner selection draw "up to k distinct members
from a per-node candidate set" as Gumbel noise over all N slots, invalid
candidates masked to -inf, then top-k (FailureDetectorImpl.selectPingReqMembers,
:351-363; MembershipProtocolImpl.selectSyncAddress, :416-427). The port
ranks by :func:`prng.gumbel_order` (the Gumbel draw's mantissa bits) with
the index as the tie-break, which is the reference's ``top_k`` order
exactly: equal values go lower index first, and -inf cells rank below
every candidate, lower index first too.

The reference's shuffled probe list (selectPingMember,
FailureDetectorImpl.java:340-349) guarantees each member is pinged within n
FD periods. Node i's target in FD round r is the affine permutation

    tgt_i(r) = (a_i(w) * (r mod n) + b_i(w)) mod n,   w = r // n

with ``a_i`` (a stride coprime to n, < 2048) and ``b_i`` re-drawn each wrap
from a per-wrap fold of a fixed key.
"""

from __future__ import annotations

import numpy as np
import torch

from scalecube_cluster_tpu_torch import prng

#: Stride bound keeping ``a * c`` < 2^31 for n < 2^20.
_MAX_STRIDE = 2048

#: Root key of the cursor's per-wrap parameters (raw threefry key data);
#: fixed so the schedule is a pure function of (n, fd_round).
_PROBE_CURSOR_KEY_DATA = np.array([0, 0x5CA1EC], dtype=np.uint32)

#: Low bits of a top-k score that hold the (reversed) column index.
_INDEX_BITS = 20


def masked_random_topk(key, mask: torch.Tensor, k: int):
    """Sample up to ``k`` distinct True positions per row of ``mask``
    (``[..., N]`` bool). Returns ``(idx int32, valid bool)``, both
    ``[..., k]``; surplus picks of a row with fewer than ``k`` candidates
    have ``valid=False``."""
    # A KeyBatch draws its own leading universe axis.
    shape = tuple(mask.shape[1:] if isinstance(key, prng.KeyBatch) else mask.shape)
    return topk_by_order(prng.gumbel_order(key, shape, mask.device), mask, k)


def topk_by_order(order: torch.Tensor, mask: torch.Tensor, k: int):
    """``lax.top_k(where(mask, order, -inf), k)``'s indices for int64
    ``order`` values in [0, 2^43): larger first, equal values lower index
    first, masked cells after every candidate, lower index first. Returns
    ``(idx int32, mask at idx)``."""
    n = mask.shape[-1]
    if n > 1 << _INDEX_BITS:
        raise ValueError(f"top-k supports rows of <= 2^{_INDEX_BITS}, got {n}")
    col = torch.arange(n, dtype=torch.int64, device=mask.device)
    score = torch.where(
        mask, (order << _INDEX_BITS) | ((1 << _INDEX_BITS) - 1 - col), -1 - col
    )
    idx = torch.topk(score, k, dim=-1).indices
    return idx.to(torch.int32), torch.gather(mask, -1, idx)


def masked_random_choice(key, mask: torch.Tensor):
    """Sample one True position per row of ``mask``; ``(idx, valid)`` with
    shapes ``mask.shape[:-1]``."""
    idx, valid = masked_random_topk(key, mask, 1)
    return idx[..., 0], valid[..., 0]


def probe_cursor_targets(fd_round: int, n: int, device) -> torch.Tensor:
    """``[n]`` int32 PING targets of every node for FD round ``fd_round``
    (a host int: the cadence is a function of the tick alone)."""
    if n >= 1 << 20:
        raise ValueError(f"probe cursor supports n < 2^20, got {n}")
    w = fd_round // n
    c = fd_round % n
    ka, kb = prng.split(prng.fold_in(_PROBE_CURSOR_KEY_DATA, w))
    hi = min(_MAX_STRIDE, n) if n > 1 else 2
    cands = prng.randint(ka, (8, n), 1, hi, device)
    ok = torch.gcd(cands, torch.full_like(cands, n)) == 1
    first = torch.argmax(ok.to(torch.int32), dim=0)
    a = torch.gather(cands, 0, first[None, :])[0]
    a = torch.where(ok.any(dim=0), a, 1).to(torch.int64)
    b = prng.randint(kb, (n,), 0, n, device).to(torch.int64)
    return ((a * c + b) % n).to(torch.int32)
