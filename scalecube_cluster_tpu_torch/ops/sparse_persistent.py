"""Persistent k-tick sparse core: the hand-written cooperative CUDA kernel,
its plain PyTorch version, and the wrapper that picks between them by
device.

Port of scalecube_cluster_tpu/ops/pallas_sparse.py::
sparse_core_pallas_persistent and its jitted entry
``run_sparse_core_persistent``: ONE launch steps ``k <= k_max`` plain
sparse ticks (no FD/SYNC points) over the [N, S] working set, with the
cold per-cell state (age, suspicion countdown) packed into one int16 lane
(:func:`pack_cold`) and the state ping-ponging between two buffer pairs.
It returns the final state plus the LAST tick's self-rumor and per-slot
aggregate, the latter masked to the bits the fold asks for (``wb_mask`` →
bit 0, ``view_rows`` → bits 1 and 2).

- :func:`sparse_core_persistent_reference` is the plain version: ``k``
  steps of :func:`~scalecube_cluster_tpu_torch.ops.sparse_core.
  sparse_core_reference` with no points, the cold lane packed and unpacked
  between ticks as the kernel streams it.
- :func:`sparse_core_persistent` is the wrapper: on CPU tensors it runs the
  reference; on CUDA tensors it launches ``csrc/sparse_persistent.cu``
  (one cooperative launch, every tick inside; the kernel packs the cold
  lane in its first tick and unpacks it in its last) and adds one to
  ``sparse_core_persistent.launches``, or raises. ``k`` is a kernel
  argument and every table is sized by ``k_max``, so one build serves
  every k.
"""

from __future__ import annotations

import ctypes

import torch

from scalecube_cluster_tpu_torch.ops.cuda_build import CudaLibrary
from scalecube_cluster_tpu_torch.ops.sparse_core import (
    AGGR_DEAD_BIT,
    AGGR_HOLD_BIT,
    AGGR_SUSPECT_BIT,
    SPARSE_GROUP,
    check_offsets,
    sparse_core_reference,
)

#: The reference's largest fan-out: its packed flags word carries edge
#: channel c in bit c and the receiver's liveness in this bit. The kernel
#: reads the edge bits and liveness as they are, and keeps the limit.
ALIVE_BIT = 7
#: Max suspicion countdown representable in the packed cold lane (7 bits:
#: the int16 must stay non-negative with age in the low byte).
COLD_SUSP_MAX = 127
#: The reference's residual-fold pieces.
FOLD_PIECES = ("countdown", "points", "wb_mask", "view_rows")
#: Lanes of one work item's tile (``kTile`` in csrc/sparse_persistent.cu,
#: which owns the grid: a tick's items are n/32 row blocks by lane tiles,
#: the blocks fastest, so the band ``(slab, cold)[:, tile]``, 25 MB at
#: n=32768, stays in L2 across the f reads of each sender cell). The
#: tile-edge test operands sit on its boundaries.
TILE_LANES = 128


def pack_cold(age, susp):
    """Pack int8 age + int16 countdown (0..:data:`COLD_SUSP_MAX`) into one
    int16 lane, ``age | susp << 8``: the kernel's cold working set (2 B a
    cell instead of 3) and the checkpoint form of
    ``save_sparse_checkpoint(pack_cold=True)``. Taken in int16, which
    keeps the same low 16 bits as the reference's int32 arithmetic."""
    return (age.to(torch.int16) & 0xFF) | (susp << 8)


def unpack_cold(cold):
    """Inverse of :func:`pack_cold` → ``(age int8, susp int16)``."""
    return (cold & 0xFF).to(torch.int8), cold >> 8


def _aggr_mask(fold) -> int:
    mask = 0
    if "wb_mask" in fold:
        mask |= 1 << AGGR_HOLD_BIT
    if "view_rows" in fold:
        mask |= (1 << AGGR_SUSPECT_BIT) | (1 << AGGR_DEAD_BIT)
    return mask


def sparse_core_persistent_reference(
    slab, age, susp, slot_subj, ginv, rots, edge_ok, alive, k,
    *, spread, susp_ticks, age_stale, sweep=0, k_max=8,
    fold=frozenset({"countdown"}),
):
    """Plain PyTorch version of the persistent core; same signature and
    outputs as :func:`sparse_core_persistent`: ``(slab i32, age i8, susp
    i16 [N, S], self_rumor [N] i32, aggr [S] i32)``.

    Each tick reads the age as the cold lane's low byte, unsigned (as the
    kernel does), and the countdown as its high byte."""
    n = slab.shape[0]
    neg = torch.full((n,), -1, dtype=torch.int32, device=slab.device)
    cold = pack_cold(age, susp)
    consts = dict(spread=spread, susp_ticks=susp_ticks, age_stale=age_stale, sweep=sweep)
    for t in range(k):
        c32 = cold.to(torch.int32)
        slab, age2, susp2, self_rumor, aggr = sparse_core_reference(
            slab, c32 & 0xFF, c32 >> 8, slot_subj, ginv[t], rots[t], edge_ok[t],
            alive, neg, neg, neg, neg, **consts,
        )
        cold = pack_cold(age2, susp2)
    age_f, susp_f = unpack_cold(cold)
    return slab, age_f, susp_f, self_rumor, aggr & _aggr_mask(fold)


def _check_operands(slab, age, susp, slot_subj, ginv, rots, edge_ok, alive, k,
                    *, susp_ticks, k_max, fold):
    """The reference's refusals, with its key words, then the port's dtype,
    shape, device, contiguity and alignment checks. Returns ``int(k)``."""
    n, s = slab.shape
    if ginv.dim() != 3 or ginv.shape[0] != k_max:
        raise ValueError(f"ginv must be [k_max={k_max}, f, n/32], got {tuple(ginv.shape)}")
    f = ginv.shape[1]
    if n % SPARSE_GROUP != 0:
        raise ValueError(f"n={n} not a multiple of {SPARSE_GROUP}")
    if s % 128 != 0:
        raise ValueError(f"S={s} not a multiple of 128")
    check_offsets(n, s)
    fold = frozenset(fold)
    unknown = fold - set(FOLD_PIECES)
    if unknown:
        raise ValueError(f"unknown fold pieces {sorted(unknown)}")
    if "countdown" not in fold:
        raise ValueError("the persistent kernel sweeps in-kernel: 'countdown' must fold")
    if "points" in fold:
        raise ValueError(
            "the persistent kernel steps plain ticks only ('points' is a "
            "protocol-tick fold — run those through sparse_core)"
        )
    if susp_ticks > COLD_SUSP_MAX:
        raise ValueError(
            f"susp_ticks={susp_ticks} > {COLD_SUSP_MAX} overflows the packed int16 cold lane"
        )
    k = int(k)
    if not 1 <= k <= k_max:
        raise ValueError(f"k={k} must be in [1, k_max={k_max}]")
    if f < 1:
        raise ValueError("gossip fanout must be at least 1")
    if f > ALIVE_BIT:
        # The reference's pack_flags refusal: channel c rides bit c, so a
        # fan-out above ALIVE_BIT would alias an edge bit onto the alive bit.
        raise ValueError(f"gossip fanout {f} > ALIVE_BIT ({ALIVE_BIT})")
    expect = {
        "slab": (slab, torch.int32, (n, s)),
        "age": (age, torch.int8, (n, s)),
        "susp": (susp, torch.int16, (n, s)),
        "slot_subj": (slot_subj, torch.int32, (s,)),
        "ginv": (ginv, torch.int32, (k_max, f, n // SPARSE_GROUP)),
        "rots": (rots, torch.int32, (k_max, f, n // SPARSE_GROUP)),
        "edge_ok": (edge_ok, torch.bool, (k_max, f, n)),
        "alive": (alive, torch.bool, (n,)),
    }
    for name, (t, dtype, shape) in expect.items():
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(
                f"{name}: expected {dtype} {shape}, got {t.dtype} {tuple(t.shape)}"
            )
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != slab.device:
            raise ValueError(f"{name} is on {t.device}, slab on {slab.device}")
    for name, t in (("slab", slab), ("age", age), ("susp", susp)):
        # The kernel moves 4 lanes of these planes in one access.
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")
    return k


def _declare(lib: ctypes.CDLL) -> None:
    lib.sparse_persistent_launch.argtypes = (
        [ctypes.c_void_p] * 16 + [ctypes.c_int] * 9
        + [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
    )
    lib.sparse_persistent_launch.restype = ctypes.c_int
    lib.sparse_persistent_error_string.argtypes = [ctypes.c_int]
    lib.sparse_persistent_error_string.restype = ctypes.c_char_p


#: ``csrc/sparse_persistent.cu``, compiled for sm_90a and loaded at first use.
LIBRARY = CudaLibrary("sparse_persistent", _declare)


def sparse_core_persistent(
    slab, age, susp, slot_subj, ginv, rots, edge_ok, alive, k,
    *, spread, susp_ticks, age_stale, sweep=0, k_max=8,
    fold=frozenset({"countdown"}),
):
    """``k`` plain sparse ticks in one launch (see the module docstring);
    the signature of the reference's ``sparse_core_pallas_persistent``.

    ``ginv``/``rots`` are ``[k_max, f, N/32]`` and ``edge_ok`` ``[k_max,
    f, N]``: tick t uses row t. ``k`` is a host integer in [1, k_max].
    ``fold`` must hold ``countdown`` and not ``points``; ``wb_mask`` and
    ``view_rows`` choose the aggregate's bits. Raises ``ValueError`` on
    every input the reference refuses (with its key words) and on a wrong
    dtype, shape, device or contiguity, or a ``slab``, ``age`` or ``susp``
    plane that does not start on a 16-byte boundary.

    CPU tensors run :func:`sparse_core_persistent_reference`. CUDA tensors
    launch the cooperative kernel on the current stream and count the
    launch in ``sparse_core_persistent.launches``; the kernel reads the
    caller's planes, edge bits and liveness as they are and writes the
    final slab and the unpacked age and countdown planes, so the wrapper
    launches nothing else. A missing kernel or a refused launch raises.
    """
    args = (slab, age, susp, slot_subj, ginv, rots, edge_ok, alive)
    k = _check_operands(*args, k, susp_ticks=susp_ticks, k_max=k_max, fold=fold)
    consts = dict(spread=spread, susp_ticks=susp_ticks, age_stale=age_stale,
                  sweep=sweep, k_max=k_max, fold=fold)
    if slab.device.type == "cpu":
        return sparse_core_persistent_reference(*args, k, **consts)
    if slab.device.type != "cuda":
        raise ValueError(f"sparse_core_persistent: unsupported device {slab.device}")
    lib = LIBRARY.load()
    n, s = slab.shape
    slab_a, slab_b = torch.empty_like(slab), torch.empty_like(slab)
    cold_a, cold_b = torch.empty_like(susp), torch.empty_like(susp)
    age_f, susp_f = torch.empty_like(age), torch.empty_like(susp)
    self_rumor = torch.empty((n,), dtype=torch.int32, device=slab.device)
    aggr = torch.empty((s,), dtype=torch.int32, device=slab.device)
    grid = ctypes.c_int(0)
    stream = torch.cuda.current_stream(slab.device).cuda_stream
    ptrs = (slab, age, susp, slot_subj, ginv, rots, edge_ok, alive, slab_a, cold_a, slab_b,
            cold_b, age_f, susp_f, self_rumor, aggr)
    err = lib.sparse_persistent_launch(
        *(t.data_ptr() for t in ptrs),
        n, s, ginv.shape[1], k, spread, susp_ticks, age_stale, sweep,
        _aggr_mask(frozenset(fold)), stream, ctypes.byref(grid),
    )
    if err != 0:
        msg = lib.sparse_persistent_error_string(err).decode()
        raise RuntimeError(f"sparse_core_persistent: kernel launch failed: {msg} ({err})")
    sparse_core_persistent.launches += 1
    sparse_core_persistent.grid = grid.value
    slab_f = slab_a if k % 2 == 1 else slab_b
    return slab_f, age_f, susp_f, self_rumor, aggr


sparse_core_persistent.launches = 0
#: CTAs of the last cooperative launch (occupancy x SM count, at most one
#: per work item).
sparse_core_persistent.grid = 0

#: The reference's name for the entry point.
run_sparse_core_persistent = sparse_core_persistent
