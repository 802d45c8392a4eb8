"""Id generation.

Reference: member ids are random UUID-derived hex strings (Member.java:48-50);
correlation ids are ``<memberId>-<counter>`` with the counter seeded from wall
time (CorrelationIdGenerator.java:6-17).
"""

from __future__ import annotations

import itertools
import secrets
import time


def generate_id(bits: int = 64) -> str:
    """Random hex id for a cluster member (Member.generateId analog)."""
    return secrets.token_hex(bits // 8)


class CorrelationIdGenerator:
    """Monotonic correlation-id source, unique per member and per process run.

    ``epoch`` seeds the counter. The reference seeds from wall time
    (CorrelationIdGenerator.java:6-17) and that remains the default here,
    but deterministic harnesses inject an explicit epoch instead —
    ``Cluster.start`` derives one from its ``seed``-driven rng, so two runs
    with the same seed mint identical correlation ids.
    """

    def __init__(self, member_id: str, epoch: int | None = None):
        self._member_id = member_id
        if epoch is None:
            epoch = int(time.time() * 1000)  # tpulint: disable=R3 -- reference-parity default; deterministic callers inject `epoch` (Cluster.start derives it from its seed)
        self._counter = itertools.count(epoch)

    def next_cid(self) -> str:
        return f"{self._member_id}-{next(self._counter)}"
