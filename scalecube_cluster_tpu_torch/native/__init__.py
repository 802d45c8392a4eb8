"""Native runtime components with pure-Python fallbacks.

The compute path of this framework is PyTorch and CUDA (sim/, ops/); the runtime
around it follows the reference's shape, where the wire hot path is Netty's
native-backed frame pipeline (TransportImpl.java:383-397). ``framing.c`` is
that component for the asyncio backend. Both implementations expose:

  encode(payload: bytes, max_frame: int) -> bytes
  FrameAccumulator(max_frame).feed(chunk) -> list[bytes]   # raises ValueError
                                                           # on oversized frames

Loading policy (keeps import side-effect-free): importing this package never
compiles anything. ``load_framing()`` loads an already-built extension if one
exists, otherwise returns the pure-Python twins; ``build_native()`` compiles
the extension explicitly (transport/tcp.py calls it lazily once per process
and falls through to Python on any toolchain failure). The two
implementations are asserted byte-for-byte equivalent across chunk
boundaries and error cases by tests/test_torch_transport.py. The
extension builds into ``build/native/`` at the repository root, never
inside the package.
"""

from __future__ import annotations

import importlib.util
import logging
import os
import struct
import subprocess
import sysconfig
from pathlib import Path

logger = logging.getLogger(__name__)

_LEN = struct.Struct(">I")
_native_mod = None
_native_attempted = False


def py_encode(payload: bytes, max_frame: int) -> bytes:
    """Pure-Python twin of _framing.encode."""
    if len(payload) > max_frame:
        raise ValueError(
            f"frame of {len(payload)} bytes exceeds max_frame {max_frame}"
        )
    return _LEN.pack(len(payload)) + payload


class PyFrameAccumulator:
    """Pure-Python twin of _framing.FrameAccumulator.

    Oversized-frame contract (matches Netty's decode loop, where frames
    decoded earlier in the same read are fired through the pipeline before
    TooLongFrameException closes the channel): ``feed`` RETURNS every whole
    frame parsed before the oversized header and marks the accumulator
    poisoned; the caller checks :meth:`poisoned` (or the next ``feed``
    raises).
    """

    def __init__(self, max_frame: int = 2 * 1024 * 1024):
        if max_frame <= 0:
            raise ValueError("max_frame must be positive")
        self._max = max_frame
        self._buf = bytearray()
        self._poisoned = 0

    def feed(self, chunk: bytes) -> list[bytes]:
        if self._poisoned:
            raise ValueError(
                f"frame of {self._poisoned} bytes exceeds max_frame {self._max}"
            )
        self._buf += chunk
        frames: list[bytes] = []
        pos = 0
        buf = self._buf
        while len(buf) - pos >= 4:
            (flen,) = _LEN.unpack_from(buf, pos)
            if flen > self._max:
                self._poisoned = flen
                break
            if len(buf) - pos - 4 < flen:
                break
            frames.append(bytes(buf[pos + 4 : pos + 4 + flen]))
            pos += 4 + flen
        del buf[:pos]
        return frames

    def poisoned(self) -> int:
        """Oversized frame length that poisoned the stream (0 = healthy)."""
        return self._poisoned

    def pending(self) -> int:
        return len(self._buf)


def _so_path() -> Path:
    return Path(__file__).resolve().parents[2] / "build" / "native" / "_framing.so"


def _load_so(so_path: Path):
    spec = importlib.util.spec_from_file_location("_framing", so_path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def build_native():
    """Compile framing.c (if stale) and load it. Raises on toolchain failure.

    Kept out of import time on purpose: callers opt
    in, and a compile/loader bug surfaces as this function's exception rather
    than being swallowed by a package import.
    """
    src = Path(__file__).with_name("framing.c")
    so_path = _so_path()
    so_path.parent.mkdir(parents=True, exist_ok=True)
    if not so_path.exists() or so_path.stat().st_mtime < src.stat().st_mtime:
        include = sysconfig.get_paths()["include"]
        # Built under a private name and renamed into place, so a process
        # that loads the extension never sees a half-written file.
        part = so_path.with_name(f"_framing.{os.getpid()}.part")
        subprocess.run(
            ["cc", "-O2", "-shared", "-fPIC", f"-I{include}", str(src),
             "-o", str(part)],
            check=True,
            capture_output=True,
        )
        os.replace(part, so_path)
    return _load_so(so_path)


def load_framing(build: bool = False):
    """Return ``(encode, FrameAccumulator, is_native)``.

    Uses the native extension when it is already built (or ``build=True``
    and the toolchain can build it); otherwise the pure-Python twins. Only a
    *failed build attempt* is cached — a ``build=False`` miss stays
    retryable, so a later ``build=True`` caller (TcpTransport) still gets to
    compile the extension.
    """
    global _native_mod, _native_attempted
    if _native_mod is None and not _native_attempted:
        try:
            if _so_path().exists():
                _native_mod = _load_so(_so_path())
            elif build:
                _native_attempted = True
                _native_mod = build_native()
        except (subprocess.CalledProcessError, OSError, ImportError) as exc:
            logger.info("native framing unavailable (%s); using Python", exc)
    if _native_mod is not None:
        return _native_mod.encode, _native_mod.FrameAccumulator, True
    return py_encode, PyFrameAccumulator, False
