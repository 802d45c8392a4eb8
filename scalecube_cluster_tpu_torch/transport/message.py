"""Message envelope.

Reference: transport-api/Message.java:12-242 — an immutable envelope of
``headers`` (string map with well-known keys ``q`` = qualifier and ``cid`` =
correlation id), an opaque ``data`` payload, and the logical ``sender``
address (stamped by the cluster's sender-aware transport decorator,
ClusterImpl.java:471-514).
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from types import MappingProxyType
from typing import Any, Mapping

from scalecube_cluster_tpu_torch.utils.address import Address

HEADER_QUALIFIER = "q"
HEADER_CORRELATION_ID = "cid"


@dataclass(frozen=True)
class Message:
    """Immutable message envelope (Message.java:12-242)."""

    headers: Mapping[str, str] = field(default_factory=dict)
    data: Any = None
    sender: Address | None = None

    def __post_init__(self) -> None:
        # Freeze the header map so shared instances can't be mutated through
        # it. Note: Message is NOT hashable (headers proxy + opaque data);
        # key by correlation_id / gossip id instead.
        object.__setattr__(self, "headers", MappingProxyType(dict(self.headers)))

    # -- factories (Message.Builder analogs, Message.java:190-241)

    @classmethod
    def create(
        cls,
        qualifier: str | None = None,
        data: Any = None,
        correlation_id: str | None = None,
        sender: Address | None = None,
        headers: Mapping[str, str] | None = None,
    ) -> "Message":
        hdrs = dict(headers or {})
        if qualifier is not None:
            hdrs[HEADER_QUALIFIER] = qualifier
        if correlation_id is not None:
            hdrs[HEADER_CORRELATION_ID] = correlation_id
        return cls(headers=hdrs, data=data, sender=sender)

    @classmethod
    def from_data(cls, data: Any) -> "Message":
        return cls.create(data=data)

    def with_data(self, data: Any) -> "Message":
        return replace(self, data=data)

    def with_sender(self, sender: Address) -> "Message":
        return replace(self, sender=sender)

    def with_qualifier(self, qualifier: str) -> "Message":
        return Message.create(
            qualifier=qualifier,
            data=self.data,
            correlation_id=self.correlation_id,
            sender=self.sender,
            headers={k: v for k, v in self.headers.items() if k != HEADER_QUALIFIER},
        )

    def with_correlation_id(self, cid: str) -> "Message":
        return Message.create(
            qualifier=self.qualifier,
            data=self.data,
            correlation_id=cid,
            sender=self.sender,
            headers={
                k: v for k, v in self.headers.items() if k != HEADER_CORRELATION_ID
            },
        )

    # -- accessors (Message.java:140-183)

    @property
    def qualifier(self) -> str | None:
        return self.headers.get(HEADER_QUALIFIER)

    @property
    def correlation_id(self) -> str | None:
        return self.headers.get(HEADER_CORRELATION_ID)

    def header(self, name: str) -> str | None:
        return self.headers.get(name)

    def __str__(self) -> str:
        return (
            f"Message(q={self.qualifier}, cid={self.correlation_id}, "
            f"data={type(self.data).__name__}, sender={self.sender})"
        )
