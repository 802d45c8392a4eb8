"""Transport SPI.

Reference: transport-api/Transport.java:11-72 — the contract every backend
implements: ``address()``, fire-and-forget ``send``, correlation-id-matched
``requestResponse``, a multicast inbound ``listen()`` stream, and ``stop()``.

Two backends ship in this framework, exactly mirroring the reference's
transport-api / transport-netty split:

- ``transport.tcp.TcpTransport`` — asyncio TCP with 4-byte length framing
  (the reactor-netty equivalent, TransportImpl.java:45-398);
- the sim engine's in-array delivery (``sim/``), where N co-hosted nodes'
  messages are batched into one adjacency per tick (SURVEY.md §2.11).

``request_response`` is implemented here once, as send + filter-listen on the
correlation id — byte-for-byte the reference's strategy
(TransportImpl.java:228-252) — so decorators such as the NetworkEmulator get
correct request/response fault semantics by only wrapping ``send``/``listen``.
"""

from __future__ import annotations

import asyncio
import time
from abc import ABC, abstractmethod

from scalecube_cluster_tpu_torch.obs.trace import record_message_span
from scalecube_cluster_tpu_torch.transport.message import Message
from scalecube_cluster_tpu_torch.utils.address import Address
from scalecube_cluster_tpu_torch.utils.streams import Multicast, Stream


class TransportStoppedError(ConnectionError):
    """Raised when using a transport after ``stop()``."""


class MessageStream(Stream[Message]):
    """One subscription to a transport's inbound stream.

    Async-iterable; terminates cleanly when the transport stops (reference:
    ``listen()`` completes on stop, TransportTest.java:242-265). An exception
    raised by one subscriber must never affect other subscribers
    (TransportTest.java:268-313), which queue-per-subscriber gives for free.
    """


class Transport(ABC):
    """Abstract transport (Transport.java:11-72)."""

    @property
    @abstractmethod
    def address(self) -> Address:
        """The address this transport is listening on."""

    @abstractmethod
    async def send(self, to: Address, message: Message) -> None:
        """Fire-and-forget send; raises on connect/write failure."""

    @abstractmethod
    def listen(self) -> MessageStream:
        """Subscribe to all inbound messages (multicast)."""

    @abstractmethod
    async def stop(self) -> None:
        """Close server + connections; completes all listen() streams."""

    async def request_response(
        self, to: Address, request: Message, timeout: float | None = None
    ) -> Message:
        """Send ``request`` and await the first inbound message with the same
        correlation id (TransportImpl.java:228-252).

        ``timeout`` is seconds (None = wait forever); raises
        ``asyncio.TimeoutError`` on expiry and propagates send failures.
        """
        cid = request.correlation_id
        if not cid:
            raise ValueError("request_response requires a correlation id")
        stream = self.listen()
        # Flight-recorder message span, keyed by the existing correlation id
        # (obs/trace.py) — a no-op unless a trace session armed the recorder.
        t0 = time.monotonic()
        ok = False
        try:
            await self.send(to, request)

            async def first_match() -> Message:
                async for msg in stream:
                    if msg.correlation_id == cid:
                        return msg
                raise TransportStoppedError("transport stopped awaiting response")

            response = await asyncio.wait_for(first_match(), timeout)
            ok = True
            return response
        finally:
            stream.close()
            record_message_span(
                cid, request.qualifier, t0, time.monotonic(), ok=ok
            )


class _ListenMixin:
    """Shared multicast-subscriber bookkeeping for concrete transports."""

    def __init__(self) -> None:
        self._inbound: Multicast[Message] = Multicast(stream_cls=MessageStream)

    def listen(self) -> MessageStream:
        return self._inbound.subscribe()  # type: ignore[return-value]

    def _dispatch(self, message: Message) -> None:
        self._inbound.publish(message)

    def _complete_streams(self) -> None:
        self._inbound.complete()
