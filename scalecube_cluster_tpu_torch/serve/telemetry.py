"""Live telemetry plane for a serving session.

Two read-only publishers over one :class:`~scalecube_cluster_tpu_torch.serve.bridge.ServeBridge`,
both serving the SAME ``kind="serve_live"`` row (``ServeBridge.live_metrics``
— rolling-window SLO percentiles, events/s, backpressure, queue depth, and
per-shard flight-recorder occupancy when the state carries one):

- :class:`MetricsResponder` — answers ``serve/metrics`` request/response
  polls on the session's EXISTING transport. An operator (or another node)
  sends ``Message.create(qualifier="serve/metrics", correlation_id=...)``
  through ``Transport.request_response`` and gets the live row back as
  ``Message.data`` — no side channel, no new port, and the poll itself is
  recorded as a message span by the flight recorder like any other RPC
  (transport/api.py).
- :class:`PrometheusEndpoint` — a minimal HTTP/1.0 scrape target rendering
  the same row through obs/export.py::prometheus_text, so a stock
  Prometheus scraper can watch a session without speaking the framed
  transport protocol.

Both are pull-based by design: metrics cost nothing until someone asks, and
the numbers always reflect launch-close state (the bridge records SLO
samples synchronously in ``_finish_launch``), never a stale push.
"""

from __future__ import annotations

import asyncio
import logging

from scalecube_cluster_tpu_torch.obs.export import prometheus_text
from scalecube_cluster_tpu_torch.transport.message import Message

logger = logging.getLogger(__name__)

#: Qualifier the live-metrics poll rides under (the telemetry twin of
#: serve/ingest.py::SERVE_QUALIFIER).
METRICS_QUALIFIER = "serve/metrics"


class MetricsResponder:
    """Answer ``serve/metrics`` polls on a bridge's transport.

    ``start()`` subscribes to the transport's inbound multicast and spawns
    the responder task; every inbound message with the metrics qualifier
    (and a sender to reply to) gets the bridge's CURRENT ``live_metrics``
    row back under the request's correlation id — exactly the shape
    ``Transport.request_response`` awaits. Non-metrics traffic is ignored,
    so the responder coexists with the serve-event pump on one transport.
    """

    def __init__(self, bridge, transport, qualifier: str = METRICS_QUALIFIER):
        self.bridge = bridge
        self.transport = transport
        self.qualifier = qualifier
        self.polls_served = 0
        self._task: asyncio.Task | None = None
        self._stream = None

    def start(self) -> None:
        if self._task is not None:
            raise RuntimeError("MetricsResponder already started")
        self._stream = self.transport.listen()
        self._task = asyncio.ensure_future(self._serve())

    async def _serve(self) -> None:
        try:
            async for msg in self._stream:
                if msg.qualifier != self.qualifier or msg.sender is None:
                    continue
                reply = Message.create(
                    qualifier=self.qualifier,
                    data=self.bridge.live_metrics(),
                    correlation_id=msg.correlation_id,
                )
                try:
                    await self.transport.send(msg.sender, reply)
                except ConnectionError:
                    # The poller vanished between ask and answer; metrics are
                    # best-effort reads, never worth failing the session.
                    logger.debug("metrics reply to %s failed", msg.sender)
                    continue
                self.polls_served += 1
        except asyncio.CancelledError:
            pass
        finally:
            self._stream.close()

    async def stop(self) -> None:
        if self._task is None:
            return
        self._task.cancel()
        try:
            await self._task
        except asyncio.CancelledError:
            pass
        self._task = None


class PrometheusEndpoint:
    """Minimal HTTP scrape target for the live row.

    ``await start()`` binds (``port=0`` picks a free port, read it back
    from ``.port``); every GET — the path is ignored, a scrape target has
    one document — returns ``text/plain; version=0.0.4`` gauges rendered by
    obs/export.py::prometheus_text from the bridge's live row at request
    time. Connection-per-scrape (``Connection: close``), which is how
    Prometheus polls anyway.
    """

    def __init__(
        self,
        bridge,
        host: str = "127.0.0.1",
        port: int = 0,
        prefix: str = "scalecube",
    ):
        self.bridge = bridge
        self.host = host
        self.port = port
        self.prefix = prefix
        self.scrapes_served = 0
        self._server: asyncio.AbstractServer | None = None

    async def start(self) -> None:
        if self._server is not None:
            raise RuntimeError("PrometheusEndpoint already started")
        self._server = await asyncio.start_server(
            self._handle, self.host, self.port
        )
        self.port = self._server.sockets[0].getsockname()[1]

    async def _handle(self, reader, writer) -> None:
        try:
            # Drain the request head (request line + headers, CRLF-tolerant);
            # body-less GETs are all a scraper sends.
            while True:
                line = await reader.readline()
                if not line or line in (b"\r\n", b"\n"):
                    break
            body = prometheus_text(
                [self.bridge.live_metrics()], prefix=self.prefix
            ).encode()
            head = (
                b"HTTP/1.0 200 OK\r\n"
                b"Content-Type: text/plain; version=0.0.4; charset=utf-8\r\n"
                b"Content-Length: " + str(len(body)).encode() + b"\r\n"
                b"Connection: close\r\n\r\n"
            )
            writer.write(head + body)
            await writer.drain()
            self.scrapes_served += 1
        except (ConnectionError, asyncio.CancelledError):
            pass
        finally:
            writer.close()

    async def stop(self) -> None:
        if self._server is None:
            return
        self._server.close()
        await self._server.wait_closed()
        self._server = None
