"""User-gossip (spreadGossip) lifecycle
(port of scalecube_cluster_tpu/sim/usergossip.py).

One gossip period: young copies fan out along the tick's permutation
edges, receivers dedup (exactly-once first-seen accounting, onGossipReq
GossipProtocolImpl.java:171-183), and slots sweep after
``periods_to_sweep`` (sweepGossips, :281-304). The tracked variant keeps a
last-k-senders ring per (holder, slot) as the bounded form of the
reference's infected set (GossipState.java:17-38).

Both steps also take an ensemble's operands (sim/ensemble.py): every
array with a leading universe axis, ``edge_live`` as ``[B, f]``.
"""

from __future__ import annotations

import torch

from scalecube_cluster_tpu_torch.ops.delivery import permuted_delivery, take_rows

#: Saturation for the [N, G] user-gossip ages (int32; far past any sweep).
AGE_CAP = 1 << 20


def user_gossip_finish(useen, uage, got, sweep):
    """Fold this period's arrivals ``got`` into the seen set, age everything
    (arrivals restart at 0) and sweep copies past the deadline. Returns
    ``(new_seen_swept, new_age, swept)``."""
    new_seen = useen | got
    first_seen = new_seen & ~useen
    new_age = torch.where(first_seen, 0, torch.clamp_max(uage + 1, AGE_CAP))
    swept = new_seen & (new_age > sweep)
    return new_seen & ~swept, new_age, swept


def ring_record(uinf_ids, uptr, arrived, sid):
    """Push sender ``sid [N]`` into the last-k ring of every (receiver, slot)
    cell where ``arrived [N, G]``. Returns the advanced ``(uinf_ids, uptr)``."""
    k = uinf_ids.shape[-1]
    kr = torch.arange(k, dtype=torch.int32, device=uinf_ids.device)
    pos = torch.remainder(uptr, k)
    cell = (kr == pos[..., None]) & arrived[..., None]
    uinf_ids = torch.where(cell, sid[..., None, None], uinf_ids)
    return uinf_ids, uptr + arrived.to(torch.int32)


def user_gossip_step(useen, uage, inv_perm, edge_ok, alive, spread, sweep, edge_live=None):
    """Untracked period. Returns ``(new_seen, new_age, msgs_user [G])`` —
    sender-side message counts (loss does not unsend). ``edge_live`` (the
    ``[f]`` bool fan-out cap of sim/knobs.py) takes capped channels out of
    the count; the caller has already folded it into ``edge_ok``."""
    n = useen.shape[-2]
    col = torch.arange(n, dtype=torch.int32, device=useen.device)
    nonself = inv_perm != col
    urows = useen & (uage < spread)
    got = permuted_delivery(urows.to(torch.int32), inv_perm, edge_ok) > 0
    msgs_user = torch.zeros(
        useen.shape[:-2] + useen.shape[-1:], dtype=torch.int32, device=useen.device
    )
    for c in range(inv_perm.shape[-2]):
        src = inv_perm[..., c, :].long()
        sent = take_rows(urows, src) & (take_rows(alive, src) & nonself[..., c, :])[..., None]
        if edge_live is not None:
            sent = sent & _channel(edge_live, c)
        msgs_user = msgs_user + sent.sum(dim=-2, dtype=torch.int32)
    seen, new_age, _ = user_gossip_finish(useen, uage, got & alive[..., None], sweep)
    return seen, new_age, msgs_user


def user_gossip_step_tracked(
    useen, uage, uinf_ids, uptr, inv_perm, edge_ok, alive, spread, sweep, perm,
    edge_live=None,
):
    """Tracked period with last-k-senders suppression: sender i skips slot g
    toward target ``perm[c, i]`` when its ring already names that target.
    ``perm`` is the forward fan-out (ops/delivery.py::perm_from_structured);
    ``edge_live`` as in :func:`user_gossip_step` (a capped channel sends
    nothing).

    Returns ``(new_seen, new_age, uinf_ids, uptr, msgs_user [G])``.
    """
    n = useen.shape[-2]
    f = inv_perm.shape[-2]
    col = torch.arange(n, dtype=torch.int32, device=useen.device)
    urows = useen & (uage < spread)
    sent_s = []
    msgs_user = torch.zeros(
        useen.shape[:-2] + useen.shape[-1:], dtype=torch.int32, device=useen.device
    )
    for c in range(f):
        tgt = perm[..., c, :]
        known = (uinf_ids == tgt[..., None, None]).any(dim=-1)
        s_c = urows & ~known & (alive & (tgt != col))[..., None]
        if edge_live is not None:
            s_c = s_c & _channel(edge_live, c)
        sent_s.append(s_c)
        msgs_user = msgs_user + s_c.sum(dim=-2, dtype=torch.int32)
    got = torch.zeros_like(urows)
    for c in range(f):
        src = inv_perm[..., c, :]
        arrived = take_rows(sent_s[c], src) & edge_ok[..., c, :, None] & alive[..., None]
        got = got | arrived
        uinf_ids, uptr = ring_record(uinf_ids, uptr, arrived, src)
    seen, new_age, swept = user_gossip_finish(useen, uage, got, sweep)
    uinf_ids = torch.where(swept[..., None], -1, uinf_ids)
    uptr = torch.where(swept, 0, uptr)
    return seen, new_age, uinf_ids, uptr, msgs_user


def _channel(edge_live: torch.Tensor, c: int) -> torch.Tensor:
    """Channel ``c``'s live bit: a 0-d tensor of a ``[f]`` mask, ``[B, 1, 1]``
    of an ensemble's ``[B, f]``."""
    if edge_live.dim() == 1:
        return edge_live[c]
    return edge_live[:, c, None, None]
