"""Generic async multicast streams.

The host backend's analog of the reference's Reactor processors
(``DirectProcessor``/``Sinks``, e.g. TransportImpl.java:53-54,
MembershipProtocolImpl.java:92-93): a fan-out publisher where each subscriber
owns an unbounded queue, so one slow or crashing subscriber never affects the
others (TransportTest.java:268-313 pins that semantic for transports).
"""

from __future__ import annotations

import asyncio
import contextlib
import logging
from typing import AsyncIterator, Callable, Generic, TypeVar

logger = logging.getLogger(__name__)

T = TypeVar("T")


class Stream(Generic[T]):
    """One subscription; async-iterable, terminates cleanly on ``close()``."""

    _CLOSED = object()

    def __init__(self, on_close: Callable[["Stream[T]"], None] | None = None):
        self._queue: asyncio.Queue = asyncio.Queue()
        self._on_close = on_close
        self._closed = False

    def _publish(self, item: T) -> None:
        if not self._closed:
            self._queue.put_nowait(item)

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            self._queue.put_nowait(self._CLOSED)
            if self._on_close is not None:
                self._on_close(self)

    def __aiter__(self) -> AsyncIterator[T]:
        return self

    async def __anext__(self) -> T:
        item = await self._queue.get()
        if item is self._CLOSED:
            raise StopAsyncIteration
        return item


def filtered(
    source: Stream[T],
    predicate: Callable[[T], bool],
    stream_cls: type = Stream,
) -> Stream[T]:
    """Derive a stream passing only items for which ``predicate`` is true.

    Closing either end closes both; the pump task is strongly referenced on
    the returned stream (the event loop holds tasks weakly, and a swallowed
    pump failure must be logged, not dropped at GC time).
    """
    out: Stream[T] = stream_cls(on_close=lambda s: source.close())

    async def pump() -> None:
        try:
            async for item in source:
                if predicate(item):
                    out._publish(item)
        except Exception:
            logger.exception("stream filter pump failed")
        finally:
            out.close()

    out._pump_task = asyncio.ensure_future(pump())
    return out


class Multicast(Generic[T]):
    """Fan-out publisher: every subscriber gets every item published after
    it subscribed. ``stream_cls`` lets callers hand out a ``Stream`` subclass
    (e.g. the transport SPI's ``MessageStream``)."""

    def __init__(self, stream_cls: type = Stream) -> None:
        self._stream_cls = stream_cls
        self._streams: set[Stream[T]] = set()

    def subscribe(self) -> Stream[T]:
        stream: Stream[T] = self._stream_cls(on_close=self._streams.discard)
        self._streams.add(stream)
        return stream

    def publish(self, item: T) -> None:
        for stream in list(self._streams):
            stream._publish(item)

    def complete(self) -> None:
        for stream in list(self._streams):
            with contextlib.suppress(Exception):
                stream.close()
