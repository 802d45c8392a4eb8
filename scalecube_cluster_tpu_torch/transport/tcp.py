"""Asyncio TCP transport — the reactor-netty equivalent.

Reference: transport-netty/TransportImpl.java:45-398. Matches its observable
semantics:

- 4-byte big-endian length-prefixed frames with a max-frame guard
  (LengthFieldPrepender/LengthFieldBasedFrameDecoder, TransportImpl.java:383-397);
- one lazily-created cached outbound connection per destination, evicted on
  disconnect or connect error (TransportImpl.java:56, 299-322) — which also
  yields the reference's per-connection FIFO ordering
  (TransportSendOrderTest.java:41-207); stale cache entries (failed or
  cancelled dial futures, closing writers) are also evicted at lookup, and
  redials to a failing destination apply bounded exponential backoff with
  jitter (TransportConfig.reconnect_backoff_*);
- flush (drain) per message send (TransportImpl.java:280);
- a single multicast inbound stream fed by all accepted connections
  (TransportImpl.java:53-54), completed on ``stop()``;
- send to an unresolvable/unreachable destination fails the returned
  awaitable (TransportTest.java:43-85).

Frame assembly runs through the native framing module (native/framing.c — the
Netty-pipeline-stage equivalent), transparently falling back to its pure
Python twin when the toolchain can't build it; both are asserted equivalent
by tests/test_native_framing.py.
"""

from __future__ import annotations

import asyncio
import contextlib
import logging
import random
import time

from scalecube_cluster_tpu_torch.cluster_api.config import TransportConfig
from scalecube_cluster_tpu_torch.native import load_framing
from scalecube_cluster_tpu_torch.transport.api import (
    Transport,
    TransportStoppedError,
    _ListenMixin,
)
from scalecube_cluster_tpu_torch.transport.codec import DEFAULT_CODEC, MessageCodec
from scalecube_cluster_tpu_torch.transport.message import Message
from scalecube_cluster_tpu_torch.utils.address import Address

logger = logging.getLogger(__name__)

_READ_CHUNK = 64 * 1024

#: Size bound on the per-destination dial-failure book (backoff state). A
#: long-lived node dialing a churning peer population would otherwise grow
#: the dict one entry per dead destination forever; past this many tracked
#: destinations the stalest entry is evicted (losing only its backoff
#: position — the next dial to it starts the backoff ladder over).
_DIAL_FAILURES_MAX = 1024

#: Age factor after which a dial-failure entry is pruned outright: once a
#: destination has not been dialed for this many max-backoff periods, its
#: failure streak carries no useful pacing information any more.
_DIAL_FAILURE_TTL_BACKOFFS = 32


class _Connection:
    """One cached outbound TCP connection (TransportImpl.getOrConnect analog)."""

    def __init__(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        self.reader = reader
        self.writer = writer
        self.reader_task: asyncio.Task | None = None

    def close(self) -> None:
        if self.reader_task is not None:
            self.reader_task.cancel()
        with contextlib.suppress(Exception):
            self.writer.close()


class TcpTransport(_ListenMixin, Transport):
    """TCP transport bound to one listen socket (TransportImpl.java:45-398)."""

    def __init__(self, config: TransportConfig, codec: MessageCodec | None = None):
        _ListenMixin.__init__(self)
        self._config = config
        self._codec = codec or DEFAULT_CODEC
        self._encode, self._accumulator_cls, _ = load_framing(build=True)
        self._server: asyncio.AbstractServer | None = None
        self._address: Address | None = None
        # Address -> future resolving to an established _Connection; a future
        # (not the connection) is cached so concurrent senders share one dial
        # (TransportImpl.java:299-322).
        self._connections: dict[Address, asyncio.Future[_Connection]] = {}
        # Consecutive failed-dial count per destination; drives the bounded
        # reconnect backoff and resets on a successful connect. Bounded in
        # size and age (_note_dial_failure) — churning peer populations must
        # not leak one entry per dead destination forever.
        self._dial_failures: dict[Address, int] = {}
        self._dial_failure_ts: dict[Address, float] = {}
        self._jitter_rng = random.Random()  # tpulint: disable=R3 -- backoff jitter exists to DECORRELATE redialing senders; tests pin the envelope, not values
        self._accepted: set[asyncio.Task] = set()
        self._accepted_writers: set[asyncio.StreamWriter] = set()
        self._stopped = False
        # Backpressure gate over EVERY read loop: cleared by pause_reading()
        # (serve/ingest.py's defer-policy pump), set by resume_reading() and
        # stop(). While cleared no socket is read, so kernel receive buffers
        # fill and the peers' TCP windows close — flow control to producers.
        self._read_gate = asyncio.Event()
        self._read_gate.set()
        # -- wire accounting (wire_stats(); serve/load.py exports these) --
        self.backpressure_pauses = 0  # pause_reading() transitions taken
        self.accept_shed = 0  # accepts closed over max_accepted_connections
        self.accept_idle_timeouts = 0  # accepted conns closed for idleness
        self.decode_failures = 0  # well-framed but undecodable payloads
        self.frames_oversized = 0  # streams poisoned by an oversized header

    # -- lifecycle -----------------------------------------------------------

    @classmethod
    async def bind(
        cls, config: TransportConfig | None = None, codec: MessageCodec | None = None
    ) -> "TcpTransport":
        """Bind a listen socket (TransportImpl.bind, :160-183). Port 0 picks an
        ephemeral port, reported via ``transport.address``."""
        self = cls(config or TransportConfig(), codec)
        host = self._config.host or "127.0.0.1"
        self._server = await asyncio.start_server(
            self._on_accept, host=host, port=self._config.port
        )
        port = self._server.sockets[0].getsockname()[1]
        self._address = Address(host, port)
        logger.debug("transport bound on %s", self._address)
        return self

    @property
    def address(self) -> Address:
        if self._address is None:
            raise TransportStoppedError("transport is not bound")
        return self._address

    async def stop(self) -> None:
        """Close the server and all connections; completes listen() streams
        (TransportImpl.java:196-215).

        Accepted-connection handlers are DRAINED, not cancelled: frames a
        peer already delivered (in the StreamReader buffers or the kernel
        socket buffer after the flush iterations below) are still decoded
        and dispatched before their stream completes — the serving bridge's
        live ingestion (serve/ingest.py::TcpEventSource) counts on shutdown
        never dropping traffic that made it onto the wire. Handlers that
        outlive ``TransportConfig.stop_drain_ms`` (a peer holding its
        connection open and idle) are cancelled as before, which also keeps
        Python 3.12's Server.wait_closed() — it blocks until every handler
        completes — from deadlocking stop().
        """
        if self._stopped:
            return
        self._stopped = True
        # A backpressure pause must never deadlock shutdown: reopen the gate
        # so the drain below can actually read out the in-flight frames.
        self._read_gate.set()
        if self._server is not None:
            self._server.close()
        for fut in list(self._connections.values()):
            if fut.done() and not fut.cancelled() and fut.exception() is None:
                fut.result().close()
            else:
                fut.cancel()
        self._connections.clear()
        if self._accepted:
            # Two loop iterations: each polls the selector, so socket data
            # already in the kernel buffer lands in the StreamReader buffers
            # (and peer-close EOFs propagate) before we close anything.
            await asyncio.sleep(0)
            await asyncio.sleep(0)
            # EOF the accepted connections: buffered frames stay readable,
            # so each handler's read loop drains them and exits cleanly.
            for writer in list(self._accepted_writers):
                with contextlib.suppress(Exception):
                    writer.close()
            grace = max(self._config.stop_drain_ms, 0) / 1000.0
            pending = list(self._accepted)
            if grace > 0 and pending:
                _, pending = await asyncio.wait(pending, timeout=grace)
            for task in pending:
                task.cancel()
            await asyncio.sleep(0)  # let cancelled stragglers unwind
        if self._server is not None:
            with contextlib.suppress(Exception):
                await self._server.wait_closed()
        self._complete_streams()

    # -- backpressure --------------------------------------------------------

    def pause_reading(self) -> None:
        """Stop reading EVERY connection (ingestion backpressure).

        Kernel receive buffers fill, the peers' TCP windows close, and
        producers block in their own writes — per-connection flow control
        with no frames dropped. Idempotent; the pause also freezes the
        accept-idle clock (a paused server must not time out the clients it
        chose to stop reading).
        """
        if self._read_gate.is_set():
            self._read_gate.clear()
            self.backpressure_pauses += 1

    def resume_reading(self) -> None:
        """Reopen the read gate (idempotent); paused read loops continue."""
        self._read_gate.set()

    def wire_stats(self) -> dict:
        """Hostile-traffic / pressure accounting for export rows
        (serve/load.py stamps these into the ``kind="load"`` row)."""
        return {
            "backpressure_pauses": self.backpressure_pauses,
            "accept_shed": self.accept_shed,
            "accept_idle_timeouts": self.accept_idle_timeouts,
            "decode_failures": self.decode_failures,
            "frames_oversized": self.frames_oversized,
        }

    # -- outbound ------------------------------------------------------------

    async def send(self, to: Address, message: Message) -> None:
        if self._stopped:
            raise TransportStoppedError("transport is stopped")
        # Serialize + frame-length check before dialing so an oversized
        # message neither wastes a dial nor masks its ValueError behind a
        # connect error when the peer is unreachable.
        payload = self._codec.serialize(message)
        frame = self._encode(payload, self._config.max_frame_length)
        conn = await self._get_or_connect(to)
        try:
            conn.writer.write(frame)
            await conn.writer.drain()  # flush per send (TransportImpl.java:280)
        except (ConnectionError, OSError):
            self._evict(to)
            raise

    def _backoff_delay(self, attempt: int) -> float:
        """Seconds to wait before dial ``attempt`` (0 = first try, no wait):
        exponential from ``reconnect_backoff_min_ms`` capped at
        ``reconnect_backoff_max_ms``, with ±jitter randomization."""
        if attempt <= 0 or self._config.reconnect_backoff_min_ms <= 0:
            return 0.0
        # Cap the exponent before shifting so huge failure streaks don't
        # build a bignum only for min() to discard it.
        exp = min(attempt - 1, 16)
        delay_ms = min(
            self._config.reconnect_backoff_min_ms * (1 << exp),
            self._config.reconnect_backoff_max_ms,
        )
        spread = self._config.reconnect_backoff_jitter
        if spread > 0:
            delay_ms *= 1.0 + self._jitter_rng.uniform(-spread, spread)
        return delay_ms / 1000.0

    def _dial_failure_ttl_s(self) -> float:
        """Age past which a dial-failure entry is pure leak (module consts)."""
        slowest_ms = max(
            self._config.reconnect_backoff_max_ms,
            self._config.reconnect_backoff_min_ms,
            1,
        )
        return slowest_ms / 1000.0 * _DIAL_FAILURE_TTL_BACKOFFS

    def _note_dial_failure(self, to: Address) -> None:
        """Count one failed dial and prune the failure book (age + size).

        The regression this guards (tests/test_transport.py): a long-lived
        node dialing a churning peer set used to accrete one entry per dead
        destination forever — entries now expire once stale (TTL) and the
        book is hard-capped, evicting stalest-first.
        """
        now = time.monotonic()
        self._dial_failures[to] = self._dial_failures.get(to, 0) + 1
        self._dial_failure_ts[to] = now
        ttl = self._dial_failure_ttl_s()
        for addr in [a for a, t in self._dial_failure_ts.items() if now - t > ttl]:
            self._dial_failures.pop(addr, None)
            self._dial_failure_ts.pop(addr, None)
        while len(self._dial_failures) > _DIAL_FAILURES_MAX:
            stalest = min(self._dial_failure_ts, key=self._dial_failure_ts.get)
            self._dial_failures.pop(stalest, None)
            self._dial_failure_ts.pop(stalest, None)

    async def _get_or_connect(self, to: Address) -> _Connection:
        fut = self._connections.get(to)
        if fut is not None and fut.done():
            # A cached entry can go stale without a send noticing: the dial
            # future failed or was cancelled, or the peer closed the socket
            # and the writer is already shutting down while the reader task
            # hasn't run its eviction yet. Writing to any of these would
            # fail (or silently buffer into a closing writer) — evict and
            # redial instead (TransportImpl.java:299-322's disconnect
            # eviction, applied at lookup time too).
            stale = (
                fut.cancelled()
                or fut.exception() is not None
                or fut.result().writer.is_closing()
            )
            if stale:
                self._evict(to)
                fut = None
        if fut is None:
            fut = asyncio.get_running_loop().create_future()
            self._connections[to] = fut
            try:
                await asyncio.sleep(
                    self._backoff_delay(self._dial_failures.get(to, 0))
                )
                reader, writer = await asyncio.wait_for(
                    asyncio.open_connection(to.host, to.port),
                    timeout=self._config.connect_timeout / 1000.0,
                )
                self._dial_failures.pop(to, None)
                self._dial_failure_ts.pop(to, None)
                conn = _Connection(reader, writer)
                if fut.cancelled() or self._stopped:
                    # stop() cancelled the cached future while we dialed.
                    conn.close()
                    raise TransportStoppedError("transport is stopped")
                # Responses may ride back on the outbound socket too; feed
                # them into the same inbound stream.
                conn.reader_task = asyncio.create_task(
                    self._read_loop(reader, evict=to)
                )
                fut.set_result(conn)
            except BaseException as exc:
                if not isinstance(exc, asyncio.CancelledError):
                    self._note_dial_failure(to)
                self._evict(to)
                if not fut.done():
                    if isinstance(exc, asyncio.CancelledError):
                        # The dialing sender was cancelled; fail waiters with
                        # a connect error rather than poisoning them with a
                        # CancelledError they didn't cause (shield() doesn't
                        # protect against the shared future itself failing
                        # with cancellation).
                        fut.set_exception(
                            ConnectionError(f"connect to {to} aborted")
                        )
                    else:
                        fut.set_exception(exc)
                    # The exception is re-raised below for this caller;
                    # mark it retrieved so no 'never retrieved' warning fires.
                    fut.exception()
                raise
        return await asyncio.shield(fut)

    def _evict(self, to: Address) -> None:
        fut = self._connections.pop(to, None)
        if fut is not None and fut.done() and not fut.cancelled():
            if fut.exception() is None:
                fut.result().close()

    # -- inbound -------------------------------------------------------------

    async def _on_accept(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        cap = self._config.max_accepted_connections
        if cap and len(self._accepted_writers) >= cap:
            # Accept-shed: over the cap the connection is closed before a
            # handler (and its read buffers) exists — bounded memory under a
            # connection flood, and the shed is counted, never silent.
            self.accept_shed += 1
            logger.warning(
                "shedding accepted connection over cap %d", cap
            )
            with contextlib.suppress(Exception):
                writer.close()
            return
        task = asyncio.current_task()
        assert task is not None
        self._accepted.add(task)
        self._accepted_writers.add(writer)
        idle_ms = self._config.accept_idle_timeout_ms
        try:
            await self._read_loop(
                reader, idle_timeout_s=idle_ms / 1000.0 if idle_ms > 0 else None
            )
        finally:
            self._accepted.discard(task)
            self._accepted_writers.discard(writer)
            with contextlib.suppress(Exception):
                writer.close()

    async def _read_loop(
        self,
        reader: asyncio.StreamReader,
        evict: Address | None = None,
        idle_timeout_s: float | None = None,
    ) -> None:
        """Frame-decode loop: chunked reads through the native accumulator
        (LengthFieldBasedFrameDecoder stage, TransportImpl.java:383-397).

        ``idle_timeout_s`` (accepted connections, when configured) bounds
        the wait for EACH chunk — the slow-loris guard: a client trickling
        a frame header byte-by-byte re-arms the deadline per byte but can
        never pin the handler indefinitely without paying wire traffic, and
        a silent one is closed at the first expiry. The backpressure gate
        is awaited first and does not consume idle budget: a paused server
        chose not to read; that must not count against the client.
        """
        accum = self._accumulator_cls(self._config.max_frame_length)
        try:
            while True:
                if not self._read_gate.is_set():
                    await self._read_gate.wait()
                try:
                    if idle_timeout_s is not None:
                        chunk = await asyncio.wait_for(
                            reader.read(_READ_CHUNK), idle_timeout_s
                        )
                    else:
                        chunk = await reader.read(_READ_CHUNK)
                except (asyncio.TimeoutError, TimeoutError):
                    self.accept_idle_timeouts += 1
                    logger.warning(
                        "closing idle accepted connection after %.0f ms",
                        idle_timeout_s * 1000.0,
                    )
                    break
                if not chunk:
                    break
                # Re-check the gate after the read returns: a read that was
                # already parked when pause_reading() ran still completes
                # with its chunk — holding it here (instead of dispatching)
                # keeps a pause strict, so paused ingestion stops growing
                # the subscriber queues, not just the socket reads.
                if not self._read_gate.is_set():
                    await self._read_gate.wait()
                # Frames parsed ahead of an oversized header are still
                # dispatched (the accumulator's Netty-decode-loop contract);
                # the poisoned stream then closes.
                frames = accum.feed(chunk)
                for payload in frames:
                    try:
                        message = self._codec.deserialize(payload)
                    except Exception as exc:
                        # One line, no traceback: a malformed-frame flood
                        # must cost accounting (decode_failures), not a
                        # stack trace per frame in the operator's log.
                        self.decode_failures += 1
                        logger.warning(
                            "undecodable frame (%s: %s); closing connection",
                            type(exc).__name__,
                            exc,
                        )
                        return
                    self._dispatch(message)
                if accum.poisoned():
                    self.frames_oversized += 1
                    logger.warning(
                        "dropping oversized frame of %d bytes", accum.poisoned()
                    )
                    break
        except (ConnectionError, asyncio.CancelledError):
            pass
        finally:
            if evict is not None:
                self._evict(evict)
