"""Lazy ``nvcc`` builds of the port's CUDA sources (``csrc/*.cu``).

Each source has a plain C interface and is compiled for ``sm_90a`` into a
shared library under ``build/torch_kernels/`` at the repository root, named
by a digest of the source, the headers of ``csrc/`` (``*.cuh``) and the
flags, then loaded with ``ctypes``.
Nothing is built or loaded when a module is imported: a kernel wrapper
calls :meth:`CudaLibrary.load` when a CUDA tensor first reaches it, and
:func:`compile_all` builds several sources at once (one ``nvcc`` process
each, all started together).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas=-v",
)


def nvcc_path() -> str | None:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    return default if os.path.exists(default) else None


class CudaLibrary:
    """One ``csrc/<name>.cu`` source and its loaded library.

    ``declare(lib)`` sets the ``argtypes``/``restype`` of the library's
    functions once it is loaded. ``loads`` counts the shared objects this
    process has loaded for it (1 after first use: one build serves every
    call)."""

    def __init__(self, name: str, declare):
        self.name = name
        self.source = _CSRC / f"{name}.cu"
        self._declare = declare
        self._lib = None
        self._lock = threading.Lock()
        self.loads = 0
        #: The compiler's report of this process's build (``-Xptxas=-v``:
        #: registers, shared memory and spills per kernel); empty when the
        #: shared object was already built.
        self.build_log = ""

    def target(self) -> Path:
        # Every header of csrc/ joins the digest, so a source is rebuilt
        # when a header it may include changes.
        headers = b"".join(p.read_bytes() for p in sorted(_CSRC.glob("*.cuh")))
        digest = hashlib.sha256(
            self.source.read_bytes() + headers + " ".join(NVCC_FLAGS).encode()
        ).hexdigest()[:12]
        return BUILD_DIR / f"lib{self.name}_{digest}.so"

    def load(self) -> ctypes.CDLL:
        """The loaded library, compiled first if needed. Raises
        ``RuntimeError`` when nvcc is missing or fails."""
        with self._lock:
            if self._lib is None:
                compile_all([self])
                lib = ctypes.CDLL(str(self.target()))
                self._declare(lib)
                self._lib = lib
                self.loads += 1
            return self._lib


def compile_all(libraries) -> None:
    """Compile every library whose shared object is missing, one ``nvcc``
    per source, all running at once. Raises ``RuntimeError`` naming the
    first source that fails, with the compiler's output."""
    nvcc = nvcc_path()
    if nvcc is None:
        names = ", ".join(lib.name for lib in libraries)
        raise RuntimeError(f"{names}: nvcc not found; the CUDA kernel cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running = []
    for lib in libraries:
        so = lib.target()
        if so.exists():
            continue
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(lib.source)]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True
        )
        running.append((lib, proc, tmp, so))
    failed = None
    for lib, proc, tmp, so in running:
        out, err = proc.communicate()
        if proc.returncode != 0:
            failed = failed or f"{lib.name}: nvcc failed ({proc.returncode}):\n{out}\n{err}"
        else:
            lib.build_log = err
            os.replace(tmp, so)
    if failed:
        raise RuntimeError(failed)
