"""Message codecs.

Reference: transport-api/MessageCodec.java:8-27 (SPI discovered via
ServiceLoader) and cluster-testlib's JacksonMessageCodec.java:10-33 with
default-typing so arbitrary ``Object`` payloads round-trip.

Here the SPI is a small ABC plus a **data-type registry** standing in for
Jackson default typing: protocol payload dataclasses register under a stable
tag and are encoded as ``{"@type": tag, ...fields}``. Plain JSON values pass
through untagged. The registry makes the wire format explicit and
reviewable instead of pickling arbitrary classes.
"""

from __future__ import annotations

import dataclasses
import json
from abc import ABC, abstractmethod
from enum import Enum
from typing import Any, Callable, Type, TypeVar

from scalecube_cluster_tpu_torch.transport.message import Message
from scalecube_cluster_tpu_torch.utils.address import Address

_TYPE_KEY = "@type"

_TAG_TO_TYPE: dict[str, type] = {}
_TYPE_TO_TAG: dict[type, str] = {}
_TAG_TO_ENUM: dict[str, type] = {}
_ENUM_TO_TAG: dict[type, str] = {}

T = TypeVar("T")


def register_data_type(tag: str) -> Callable[[Type[T]], Type[T]]:
    """Class decorator registering a dataclass payload for wire round-trips."""

    def deco(cls: Type[T]) -> Type[T]:
        if not dataclasses.is_dataclass(cls):
            raise TypeError(f"{cls!r} must be a dataclass to be wire-registered")
        existing = _TAG_TO_TYPE.get(tag)
        if existing is not None and existing is not cls:
            raise ValueError(f"tag {tag!r} already registered to {existing!r}")
        _TAG_TO_TYPE[tag] = cls
        _TYPE_TO_TAG[cls] = tag
        return cls

    return deco


def register_enum_type(tag: str) -> Callable[[Type[T]], Type[T]]:
    """Class decorator registering an Enum so its members round-trip as the
    enum (tagged on the wire), anywhere they appear — as dataclass fields,
    inside containers, or in raw user payloads. Unregistered enums raise a
    loud TypeError at serialize time rather than decoding corrupted."""

    def deco(cls: Type[T]) -> Type[T]:
        if not (isinstance(cls, type) and issubclass(cls, Enum)):
            raise TypeError(f"{cls!r} must be an Enum to be wire-registered")
        existing = _TAG_TO_ENUM.get(tag)
        if existing is not None and existing is not cls:
            raise ValueError(f"tag {tag!r} already registered to {existing!r}")
        _TAG_TO_ENUM[tag] = cls
        _ENUM_TO_TAG[cls] = tag
        return cls

    return deco


def _encode(obj: Any) -> Any:
    """Recursively convert payloads to JSON-compatible structures."""
    if isinstance(obj, Enum):  # before int: IntEnum is an int subclass
        tag = _ENUM_TO_TAG.get(type(obj))
        if tag is None:
            raise TypeError(
                f"not wire-serializable: unregistered enum {type(obj).__name__}"
            )
        return {_TYPE_KEY: "enum", "e": tag, "v": obj.value}
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    if isinstance(obj, Address):
        return {_TYPE_KEY: "address", "value": str(obj)}
    if isinstance(obj, Message):
        # Messages nest inside protocol payloads (gossip envelopes carry the
        # user's message, GossipRequest.java:8-37 analog).
        return {
            _TYPE_KEY: "message",
            "headers": dict(obj.headers),
            "data": _encode(obj.data),
            "sender": str(obj.sender) if obj.sender else None,
        }
    if isinstance(obj, tuple):
        # Tagged so tuples round-trip as tuples (frozen dataclass fields
        # must stay hashable after a wire hop).
        return {_TYPE_KEY: "tuple", "items": [_encode(v) for v in obj]}
    if isinstance(obj, list):
        return [_encode(v) for v in obj]
    if isinstance(obj, dict):
        if any(not isinstance(k, str) for k in obj):
            raise TypeError("not wire-serializable: dict with non-str keys")
        return {k: _encode(v) for k, v in obj.items()}
    tag = _TYPE_TO_TAG.get(type(obj))
    if tag is not None:
        out: dict[str, Any] = {_TYPE_KEY: tag}
        for f in dataclasses.fields(obj):
            out[f.name] = _encode(getattr(obj, f.name))
        return out
    raise TypeError(f"not wire-serializable: {type(obj).__name__}")


def _decode(obj: Any) -> Any:
    if isinstance(obj, list):
        return [_decode(v) for v in obj]
    if isinstance(obj, dict):
        tag = obj.get(_TYPE_KEY)
        if tag is None:
            return {k: _decode(v) for k, v in obj.items()}
        if tag == "address":
            return Address.from_string(obj["value"])
        if tag == "tuple":
            return tuple(_decode(v) for v in obj["items"])
        if tag == "enum":
            enum_cls = _TAG_TO_ENUM.get(obj["e"])
            if enum_cls is None:
                raise ValueError(f"unknown wire enum tag: {obj['e']!r}")
            return enum_cls(obj["v"])
        if tag == "message":
            sender = obj.get("sender")
            return Message(
                headers=obj.get("headers") or {},
                data=_decode(obj.get("data")),
                sender=Address.from_string(sender) if sender else None,
            )
        cls = _TAG_TO_TYPE.get(tag)
        if cls is None:
            raise ValueError(f"unknown wire type tag: {tag!r}")
        kwargs = {
            k: _decode(v) for k, v in obj.items() if k != _TYPE_KEY
        }
        return cls(**kwargs)
    return obj


class MessageCodec(ABC):
    """Serialize/deserialize SPI (MessageCodec.java:8-27)."""

    @abstractmethod
    def serialize(self, message: Message) -> bytes: ...

    @abstractmethod
    def deserialize(self, payload: bytes) -> Message: ...


class JsonMessageCodec(MessageCodec):
    """JSON wire codec with registry-based payload typing.

    The equivalent of cluster-testlib's JacksonMessageCodec (default codec in
    all reference tests); used as this framework's default production codec.
    """

    def serialize(self, message: Message) -> bytes:
        doc = {
            "headers": dict(message.headers),
            "data": _encode(message.data),
            "sender": str(message.sender) if message.sender else None,
        }
        return json.dumps(doc, separators=(",", ":")).encode("utf-8")

    def deserialize(self, payload: bytes) -> Message:
        doc = json.loads(payload.decode("utf-8"))
        sender = doc.get("sender")
        return Message(
            headers=doc.get("headers") or {},
            data=_decode(doc.get("data")),
            sender=Address.from_string(sender) if sender else None,
        )


DEFAULT_CODEC = JsonMessageCodec()
