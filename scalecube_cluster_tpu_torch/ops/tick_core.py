"""Fused dense tick core: the hand-written CUDA kernel, its plain PyTorch
version, and the wrapper that picks between them by device.

Port of scalecube_cluster_tpu/ops/pallas_tick.py::tick_core_pallas (body
``_tick_kernel_factory``). One pass over the [N, N] tables does the whole
dense tick core of a tick without SYNC: the FD verdict applied to each
SENDER row before delivery and to each receiver row, structured fan-out
delivery (8-row sender groups), the self-rumor diagonal, the merge
lattice, the dead-receiver freeze, the suspicion countdown and DEAD
transition, aging with int8 saturation, tombstone demotion, the next
tick's young payload ``rows_next`` and the FD candidate count
``known_cnt``.

- :func:`tick_core_reference` is the plain version, written from the
  Pallas kernel's formulas.
- :func:`tick_core` is the wrapper: on CPU tensors it runs the reference;
  on CUDA tensors it launches ``csrc/tick_core.cu`` and adds one to
  ``tick_core.launches``, or raises. It never falls back.

Both take an ensemble's operands too (sim/ensemble.py): a leading universe
axis B on every operand (``[B, N, N]`` tables, ``[B, f, N/8]`` fan-out,
``[B, f, N]`` edges, ``[B, N]`` vectors) and on the outputs; the kernel
takes the universe as the grid's third axis, one launch for the batch.
"""

from __future__ import annotations

import ctypes

import torch

from scalecube_cluster_tpu_torch.ops.cuda_build import CudaLibrary
from scalecube_cluster_tpu_torch.ops.delivery import GROUP, inv_from_structured, take_rows
from scalecube_cluster_tpu_torch.ops.merge import DEAD_BIT, is_alive_key, merge_views

#: Channels the kernel's per-CTA shared-memory tables hold (``kMaxFanout``
#: in csrc/tick_core.cu).
MAX_FANOUT = 8
#: Columns of one CTA's tile (``kTile`` in csrc/tick_core.cu, which owns
#: the grid: n/8 receiver groups by column tiles, the groups fastest, so
#: ``rows[:, tile]``, 10.5 MB at n=10240, stays in L2 across the f reads of
#: each sender cell). The tile-edge test operands sit on its boundaries.
TILE_COLS = 256
#: The kernel's offsets are 32-bit: n * n must stay below this.
MAX_CELLS = 1 << 31


def check_offsets(n: int) -> None:
    """Raise ``ValueError`` for n * n >= 2**31, past the kernel's 32-bit
    offsets."""
    if n * n >= MAX_CELLS:
        raise ValueError(f"n={n}: n*n >= 2**31 exceeds the kernel's 32-bit offsets")


def tick_core_reference(
    rows, view0, age, susp, ginv, rots, edge_ok, alive, fd_tgt, fd_key,
    *, spread, sweep, susp_ticks, age_stale,
):
    """Plain PyTorch version of the fused core; same signature and outputs
    as :func:`tick_core`: ``(view2 i32, age2 i8, susp2 i16, rows_next i32
    [N, N], self_rumor i32 [N], known_cnt i32 [N])``, all before
    self-refutation.

    ``rows`` is the young payload, ``fd_tgt`` the fired probe target per
    row (-1 = none) and ``fd_key`` its verdict key: the verdict joins the
    sender's payload and the receiver's own record at that column, and
    makes the cell young."""
    n = view0.shape[-1]
    col = torch.arange(n, dtype=torch.int32, device=view0.device)
    cellm = col == fd_tgt[..., None]
    payload = torch.where(cellm, fd_key[..., None], rows)
    inv = inv_from_structured(ginv, rots, n, GROUP)
    best_any = torch.full_like(rows, -1)
    best_alive = torch.full_like(rows, -1)
    for c in range(ginv.shape[-2]):
        contrib = torch.where(edge_ok[..., c, :, None], take_rows(payload, inv[..., c, :]), -1)
        best_any = torch.maximum(best_any, contrib)
        best_alive = torch.maximum(
            best_alive, torch.where(is_alive_key(contrib), contrib, -1)
        )
    diag = col[None, :] == col[:, None]
    self_rumor = torch.diagonal(best_any, dim1=-2, dim2=-1).clone()
    best_any = torch.where(diag, -1, best_any)
    best_alive = torch.where(diag, -1, best_alive)

    view1 = torch.where(cellm, fd_key[..., None], view0)
    age0 = torch.where(cellm, 0, age.to(torch.int32))
    alive_row = alive[..., None]
    merged, _ = merge_views(view1, best_any, best_alive)
    merged = torch.where(alive_row, merged, view1)

    s_loc = susp.to(torch.int32)
    armed = s_loc > 0
    # The fd cell always changed (an accepted verdict raises the key), so
    # `| cellm` compares against view0 while holding only view1.
    rearm = (merged != view1) | cellm
    left0 = torch.clamp_min(s_loc - 1, 0)
    expired = (
        alive_row
        & armed
        & ~rearm
        & (left0 == 0)
        & ((merged & DEAD_BIT) == 0)
        & ((merged & 1) != 0)
        & (merged >= 0)
    )
    view2 = torch.where(expired, (merged | DEAD_BIT) & ~1, merged)
    changed = ((view2 != view1) | cellm) & alive_row
    age2 = torch.where(changed, 0, torch.clamp_max(age0, age_stale - 1) + 1)
    tomb = ~diag & ((view2 & DEAD_BIT) != 0) & (view2 >= 0) & (age2 > sweep) & alive_row
    view2 = torch.where(tomb, -1, view2)
    is_susp = ((view2 & 1) != 0) & ((view2 & DEAD_BIT) == 0) & (view2 >= 0)
    susp2 = torch.where(is_susp, torch.where(rearm | ~armed, susp_ticks, left0), 0)
    susp2 = torch.where(alive_row, susp2, s_loc)
    rows_next = torch.where(age2 < spread, view2, -1)
    known_cnt = ((view2 >= 0) & ((view2 & DEAD_BIT) == 0) & ~diag).sum(
        dim=-1, dtype=torch.int32
    )
    return (
        view2.to(torch.int32),
        age2.to(torch.int8),
        susp2.to(torch.int16),
        rows_next.to(torch.int32),
        self_rumor.to(torch.int32),
        known_cnt,
    )


def _check_operands(rows, view0, age, susp, ginv, rots, edge_ok, alive, fd_tgt, fd_key):
    lead = tuple(view0.shape[:-2])
    n = view0.shape[-1]
    f = ginv.shape[-2]
    if len(lead) > 1:
        raise ValueError(f"view0: expected [N, N] or [B, N, N], got {tuple(view0.shape)}")
    if n == 0 or n % GROUP != 0:
        raise ValueError(f"n={n} is not a positive multiple of {GROUP}")
    if not 1 <= f <= MAX_FANOUT:
        raise ValueError(f"gossip fanout {f} outside 1..{MAX_FANOUT}")
    expect = {
        "rows": (rows, torch.int32, (n, n)),
        "view0": (view0, torch.int32, (n, n)),
        "age": (age, torch.int8, (n, n)),
        "susp": (susp, torch.int16, (n, n)),
        "ginv": (ginv, torch.int32, (f, n // GROUP)),
        "rots": (rots, torch.int32, (f, n // GROUP)),
        "edge_ok": (edge_ok, torch.bool, (f, n)),
        "alive": (alive, torch.bool, (n,)),
        "fd_tgt": (fd_tgt, torch.int32, (n,)),
        "fd_key": (fd_key, torch.int32, (n,)),
    }
    for name, (t, dtype, shape) in expect.items():
        shape = lead + shape
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(
                f"{name}: expected {dtype} {shape}, got {t.dtype} {tuple(t.shape)}"
            )
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != view0.device:
            raise ValueError(f"{name} is on {t.device}, view0 on {view0.device}")


def _declare(lib: ctypes.CDLL) -> None:
    lib.tick_core_launch.argtypes = [ctypes.c_void_p] * 16 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p
    ]
    lib.tick_core_launch.restype = ctypes.c_int
    lib.tick_core_error_string.argtypes = [ctypes.c_int]
    lib.tick_core_error_string.restype = ctypes.c_char_p


#: ``csrc/tick_core.cu``, compiled for sm_90a and loaded at first use.
LIBRARY = CudaLibrary("tick_core", _declare)


def tick_core(
    rows, view0, age, susp, ginv, rots, edge_ok, alive, fd_tgt, fd_key,
    *, spread, sweep, susp_ticks, age_stale,
):
    """The fused dense tick core (see the module docstring); the signature
    of the reference's ``tick_core_pallas``.

    CPU tensors run :func:`tick_core_reference`. CUDA tensors launch the
    kernel on the current stream and count the launch in
    ``tick_core.launches``; a missing kernel or a refused launch raises.
    Raises ``ValueError`` on a wrong dtype, shape, device or contiguity,
    on n % 8 != 0, on more than :data:`MAX_FANOUT` channels and, for CUDA
    tensors, on n * n >= 2**31 (:func:`check_offsets`, per universe). Index
    operands must be in range, as the fan-out draw and the FD round make
    them (``fd_tgt`` in [-1, n), ``ginv`` a group permutation)."""
    args = (rows, view0, age, susp, ginv, rots, edge_ok, alive, fd_tgt, fd_key)
    _check_operands(*args)
    consts = dict(spread=spread, sweep=sweep, susp_ticks=susp_ticks, age_stale=age_stale)
    if view0.device.type == "cpu":
        return tick_core_reference(*args, **consts)
    if view0.device.type != "cuda":
        raise ValueError(f"tick_core: unsupported device {view0.device}")
    lead = tuple(view0.shape[:-2])
    n = view0.shape[-1]
    check_offsets(n)
    lib = LIBRARY.load()
    view2 = torch.empty_like(view0)
    age2 = torch.empty_like(age)
    susp2 = torch.empty_like(susp)
    rows_next = torch.empty_like(rows)
    self_rumor = torch.empty(lead + (n,), dtype=torch.int32, device=view0.device)
    # The launcher zeroes known_cnt on the stream (the CTAs add into it).
    known_cnt = torch.empty(lead + (n,), dtype=torch.int32, device=view0.device)
    stream = torch.cuda.current_stream(view0.device).cuda_stream
    err = lib.tick_core_launch(
        *(t.data_ptr() for t in args),
        view2.data_ptr(), age2.data_ptr(), susp2.data_ptr(), rows_next.data_ptr(),
        self_rumor.data_ptr(), known_cnt.data_ptr(),
        n, ginv.shape[-2], lead[0] if lead else 1, spread, sweep, susp_ticks, age_stale,
        stream,
    )
    if err != 0:
        msg = lib.tick_core_error_string(err).decode()
        raise RuntimeError(f"tick_core: kernel launch failed: {msg} ({err})")
    tick_core.launches += 1
    return view2, age2, susp2, rows_next, self_rumor, known_cnt


tick_core.launches = 0
