"""Configuration beans with LAN / WAN / LOCAL presets
(port of scalecube_cluster_tpu/cluster_api/config.py).

Reference: ClusterConfig.java:21-296, MembershipConfig.java:10-184,
FailureDetectorConfig.java:5-133, GossipConfig.java:5-127. Copied are the
fields :meth:`SimParams.from_cluster_config` reads, with their presets;
durations are milliseconds:

| param                       | LAN (default) | WAN   | LOCAL |
|-----------------------------|---------------|-------|-------|
| ping_interval / ping_timeout| 1000 / 500    | 5000/3000 | 1000/200 |
| ping_req_members            | 3             | 3     | 1     |
| gossip interval/fanout/mult | 200 / 3 / 3   | 200/4/3 | 100/3/2 |
| sync_interval               | 30000         | 60000 | 15000 |
| suspicion_mult              | 5             | 6     | 3     |

``TransportConfig`` (TransportConfig.java:5-159) is copied whole, with
its ``with_`` helper, for the serving plane's wire transport
(transport/tcp.py, serve/load.py). The fluent withers of the other beans
and the host-runtime fields (seed addresses, metadata, timeouts, aliases)
stay with the unported host runtime.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any


@dataclass(frozen=True)
class FailureDetectorConfig:
    """SWIM probe settings (FailureDetectorConfig.java:5-133)."""

    ping_interval: int = 1000
    ping_timeout: int = 500
    ping_req_members: int = 3

    @classmethod
    def default_lan(cls) -> "FailureDetectorConfig":
        return cls()

    @classmethod
    def default_wan(cls) -> "FailureDetectorConfig":
        return cls(ping_interval=5000, ping_timeout=3000, ping_req_members=3)

    @classmethod
    def default_local(cls) -> "FailureDetectorConfig":
        return cls(ping_interval=1000, ping_timeout=200, ping_req_members=1)


@dataclass(frozen=True)
class GossipConfig:
    """Infection-dissemination settings (GossipConfig.java:5-127)."""

    gossip_interval: int = 200
    gossip_fanout: int = 3
    gossip_repeat_mult: int = 3

    @classmethod
    def default_lan(cls) -> "GossipConfig":
        return cls()

    @classmethod
    def default_wan(cls) -> "GossipConfig":
        return cls(gossip_interval=200, gossip_fanout=4, gossip_repeat_mult=3)

    @classmethod
    def default_local(cls) -> "GossipConfig":
        return cls(gossip_interval=100, gossip_fanout=3, gossip_repeat_mult=2)


@dataclass(frozen=True)
class MembershipConfig:
    """SYNC anti-entropy + suspicion settings (MembershipConfig.java:10-184)."""

    sync_interval: int = 30_000
    suspicion_mult: int = 5

    @classmethod
    def default_lan(cls) -> "MembershipConfig":
        return cls()

    @classmethod
    def default_wan(cls) -> "MembershipConfig":
        return cls(sync_interval=60_000, suspicion_mult=6)

    @classmethod
    def default_local(cls) -> "MembershipConfig":
        return cls(sync_interval=15_000, suspicion_mult=3)


@dataclass(frozen=True)
class ClusterConfig:
    """The protocol sub-configs of ClusterConfig.java:21-296."""

    failure_detector_config: FailureDetectorConfig = field(
        default_factory=FailureDetectorConfig
    )
    gossip_config: GossipConfig = field(default_factory=GossipConfig)
    membership_config: MembershipConfig = field(default_factory=MembershipConfig)

    @classmethod
    def default_lan(cls) -> "ClusterConfig":
        return cls()

    @classmethod
    def default_wan(cls) -> "ClusterConfig":
        return cls(
            failure_detector_config=FailureDetectorConfig.default_wan(),
            gossip_config=GossipConfig.default_wan(),
            membership_config=MembershipConfig.default_wan(),
        )

    @classmethod
    def default_local(cls) -> "ClusterConfig":
        return cls(
            failure_detector_config=FailureDetectorConfig.default_local(),
            gossip_config=GossipConfig.default_local(),
            membership_config=MembershipConfig.default_local(),
        )


@dataclass(frozen=True)
class TransportConfig:
    """Wire transport settings (TransportConfig.java:5-159)."""

    host: str | None = None
    port: int = 0  # 0 = ephemeral
    connect_timeout: int = 3_000
    max_frame_length: int = 2 * 1024 * 1024
    #: Dotted path or registered name of the MessageCodec (None = default JSON).
    message_codec: str | None = None
    #: Reconnect backoff for redials to a destination whose last dial FAILED
    #: (the reference evicts broken connections and redials on next send,
    #: TransportImpl.java:299-322; the backoff bounds the dial storm a dead
    #: peer would otherwise draw from every FD/gossip period): delay doubles
    #: from min to max per consecutive failure, with ±``jitter`` fractional
    #: randomization so a cohort of senders doesn't redial in lockstep.
    #: A successful connect resets the sequence. min=0 disables backoff.
    reconnect_backoff_min_ms: int = 50
    reconnect_backoff_max_ms: int = 2_000
    reconnect_backoff_jitter: float = 0.2
    #: Grace window ``stop()`` gives accepted-connection handlers to finish
    #: dispatching frames already received (a peer that wrote then closed —
    #: the serving bridge's live ingestion relies on this: shutting the
    #: listener down must DRAIN in-flight events, not cancel them mid-frame).
    #: Handlers still running at expiry are cancelled as before; 0 restores
    #: the old cancel-immediately behavior.
    stop_drain_ms: int = 250
    #: Idle/read deadline for ACCEPTED connections (0 = disabled, the
    #: default: cluster peers legitimately idle between protocol periods).
    #: When set, an accepted connection that delivers no bytes for this
    #: long is closed and counted (``accept_idle_timeouts``) — the
    #: slow-loris guard: a hostile client writing a frame header one byte a
    #: minute can no longer pin a handler (and its memory) until ``stop()``.
    #: Serving listeners under untrusted traffic should set this
    #: (serve/load.py defaults it on for the load harness).
    accept_idle_timeout_ms: int = 0
    #: Cap on concurrently ACCEPTED connections (0 = unlimited). Accepts
    #: over the cap are closed immediately and counted (``accept_shed``) —
    #: bounded handler/buffer memory under a connection flood, chosen shed
    #: over OOM.
    max_accepted_connections: int = 0

    def with_(self, **changes: Any) -> "TransportConfig":
        return dataclasses.replace(self, **changes)

    @classmethod
    def default_lan(cls) -> "TransportConfig":
        return cls()

    @classmethod
    def default_wan(cls) -> "TransportConfig":
        return cls(connect_timeout=10_000)

    @classmethod
    def default_local(cls) -> "TransportConfig":
        return cls(connect_timeout=1_000)
