"""Address value type.

Equivalent of ``io.scalecube.net.Address`` from scalecube-commons (used
throughout the reference, e.g. Transport.java:19, Member.java:3): an immutable
host:port pair with parse/format helpers and local-ip discovery
(ClusterImpl.java:278 uses ``Address.getLocalIpAddress``).
"""

from __future__ import annotations

import re
import socket
from dataclasses import dataclass

_ADDRESS_RE = re.compile(r"^(?P<host>\[[^\]]+\]|[^:]+):(?P<port>\d+)$")


@dataclass(frozen=True, order=True)
class Address:
    """Immutable network address (host, port)."""

    host: str
    port: int

    def __post_init__(self) -> None:
        if not self.host:
            raise ValueError("host must be non-empty")
        if not (0 <= self.port <= 65535):
            raise ValueError(f"port out of range: {self.port}")

    @classmethod
    def create(cls, host: str, port: int) -> "Address":
        return cls(host, port)

    @classmethod
    def from_string(cls, value: str) -> "Address":
        """Parse ``"host:port"`` (IPv6 hosts in brackets)."""
        m = _ADDRESS_RE.match(value)
        if not m:
            raise ValueError(f"cannot parse address: {value!r}")
        host = m.group("host").strip("[]")
        return cls(host, int(m.group("port")))

    @staticmethod
    def local_ip_address() -> str:
        """Best-effort non-loopback local IP (Address.getLocalIpAddress analog)."""
        try:
            with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
                # No packets are sent for a UDP connect; this only picks a route.
                s.connect(("10.255.255.255", 1))
                return s.getsockname()[0]
        except OSError:
            return "127.0.0.1"

    def __str__(self) -> str:
        return f"{self.host}:{self.port}"
