"""Fused sparse tick core: the hand-written CUDA kernel, its plain PyTorch
version, and the wrapper that picks between them by device.

Port of scalecube_cluster_tpu/ops/pallas_sparse.py::sparse_core_pallas with
the full residual fold (``countdown``, ``points``, ``wb_mask``,
``view_rows``) and its shard mode. One pass over the [N, S] working set:
structured fan-out delivery of young records, FD/SYNC point updates on the
sender windows and the local block, self-rumor extraction, the merge
lattice, the dead-row freeze, the suspicion countdown / DEAD transition /
aging, and the per-slot OR aggregate (:data:`AGGR_HOLD_BIT`,
:data:`AGGR_SUSPECT_BIT`, :data:`AGGR_DEAD_BIT`).

- :func:`sparse_core_reference` is the plain version, written from the
  JAX engine's XLA-chain formulas (sim/sparse.py step 4 point where-pass,
  step 5 delivery + merge, step 6 sweep, and ``_free_plan``'s pin rule).
- :func:`sparse_core` is the wrapper: on CPU tensors it runs the reference;
  on CUDA tensors it launches ``csrc/sparse_core.cu`` and adds one to
  ``sparse_core.launches``, or raises — it never falls back.

Shard mode (the explicit-SPMD engine, parallel/spmd.py): the block is one
shard's ``[nl, S]`` rows, ``row_base`` gives the global member id of its
row 0 (own-lane detection works on global ids), and the sender rows come
from caller-built windows ``slab_windows`` / ``age_windows`` (``[W, S]``
int32 / int8, W a multiple of 32; ``ginv`` then indexes their 32-row
blocks) instead of the block itself. Window rows are not rows of the
block, so the point lanes do not reach them: with windows the point
updates are not applied (the caller applied them before building the
windows, as the reference's shard mode requires; the lanes still mark the
receiver's own point cells for the countdown).

Both take an ensemble's operands too (sim/ensemble.py): every per-universe
operand with a leading universe axis B (``slab [B, N, S]``, ``slot_subj
[B, S]``, ``ginv [B, f, N/32]``, ``edge_ok [B, f, N]``, the [B, N] point
lanes and keys) and outputs to match; the kernel takes the universe as the
grid's third axis, one launch for the whole batch, the vmap of the
reference's ``pallas_call``.

The CUDA source is compiled with ``nvcc`` for ``sm_90a`` at first use into
``build/torch_kernels/`` under the repository root and bound with
``ctypes``; nothing is built or imported when this module is imported.
"""

from __future__ import annotations

import ctypes

import torch

from scalecube_cluster_tpu_torch.ops.cuda_build import CudaLibrary
from scalecube_cluster_tpu_torch.ops.delivery import inv_from_structured, take_rows
from scalecube_cluster_tpu_torch.ops.merge import (
    DEAD_BIT,
    is_alive_key,
    is_dead_key,
    is_suspect_key,
    merge_views,
)

#: Sender-group / receiver-block size of the kernel's fan-out.
SPARSE_GROUP = 32
#: Slot indices must fit the reference's 12-bit packed point lanes.
SLOT_BITS = 12
#: Channels the kernel's per-CTA shared-memory tables hold (``kMaxFanout``
#: in csrc/sparse_core.cu).
MAX_FANOUT = 8
#: Lanes of one CTA's tile (``kTile`` in csrc/sparse_core.cu, which owns
#: the grid: n/32 row blocks by lane tiles, the blocks fastest, so the band
#: ``(slab, age)[:, tile]``, 21 MB at n=32768, stays in L2 across the f
#: reads of each sender cell). The tile-edge test operands sit on its
#: boundaries.
TILE_LANES = 128
#: The kernel's offsets are 32-bit: n * S must stay below this.
MAX_CELLS = 1 << 31
#: Bits of the per-slot aggregate output.
AGGR_HOLD_BIT = 0
AGGR_SUSPECT_BIT = 1
AGGR_DEAD_BIT = 2


def sparse_core_reference(
    slab, age, susp, slot_subj, ginv, rots, edge_ok, alive,
    fd_slot, sy_slot, fd_key, sy_key, *, spread, susp_ticks, age_stale, sweep,
    group=SPARSE_GROUP, expiry=False, row_base=None, slab_windows=None, age_windows=None,
):
    """Plain PyTorch version of the fused core; same signature and outputs
    as :func:`sparse_core`: ``(slab2 i32, age2 i8, susp2 i16 [N, S],
    self_rumor [N] i32, aggr [S] i32)``.

    It is also the sparse tick's XLA chain (any n % 8 == 0, any S) where the
    kernel is not taken: ``group`` is the fan-out's row group (8 when
    n % 32 != 0) and ``susp_ticks`` may be the knobs' 0-d tensor.

    ``slab``/``age`` are the post-load, PRE-point working set: a viewer's
    FD/SYNC point update (``fd_slot``/``sy_slot`` lanes, -1 = none, keys in
    ``fd_key``/``sy_key``) applies to its own row both as a receiver and as
    a sender, SYNC winning a same-cell collision, and makes the cell young.

    ``expiry=True`` appends the [N, S] bool mask of cells whose suspicion
    countdown expired into DEAD this tick (the flight recorder's
    ``DEAD_VIA_EXPIRY``), which the kernel does not expose.

    ``row_base`` (an int, or ``[B]`` int32 for a batch) and the windows are
    the shard mode of the module docstring: with windows, ``slab``/``age``
    are taken as given and the lanes only mark the point cells.
    """
    n, s = slab.shape[-2:]
    lanes = torch.arange(s, dtype=torch.int32, device=slab.device)
    rows = torch.arange(n, dtype=torch.int32, device=slab.device)
    cell_fd = lanes == fd_slot[..., None]
    cell_sy = lanes == sy_slot[..., None]
    point = cell_fd | cell_sy
    active = (slot_subj >= 0)[..., None, :]
    if slab_windows is None:
        local = torch.where(
            cell_sy, sy_key[..., None], torch.where(cell_fd, fd_key[..., None], slab)
        )
        age0 = torch.where(point, 0, age.to(torch.int32))
        src, src_age = local, age0
    else:
        local, age0 = slab, age.to(torch.int32)
        src, src_age = slab_windows, age_windows.to(torch.int32)
    payload = torch.where((src_age < spread) & active, src, -1)
    inv = inv_from_structured(ginv, rots, n, group)
    if row_base is not None:
        rows = rows + (row_base[..., None] if isinstance(row_base, torch.Tensor) else row_base)
    best_any = torch.full_like(slab, -1)
    best_alive = torch.full_like(slab, -1)
    for c in range(ginv.shape[-2]):
        contrib = torch.where(edge_ok[..., c, :, None], take_rows(payload, inv[..., c, :]), -1)
        best_any = torch.maximum(best_any, contrib)
        best_alive = torch.maximum(
            best_alive, torch.where(is_alive_key(contrib), contrib, -1)
        )
    own = slot_subj[..., None, :] == rows[..., :, None]
    self_rumor = torch.where(own, best_any, -1).amax(dim=-1)
    best_any = torch.where(own, -1, best_any)
    best_alive = torch.where(own, -1, best_alive)

    alive_row = alive[..., None]
    merged, _ = merge_views(local, best_any, best_alive)
    merged = torch.where(active & alive_row, merged, local)

    s_loc = susp.to(torch.int32)
    armed = s_loc > 0
    rearm = (merged != local) | point
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
    slab2 = torch.where(expired, (merged | DEAD_BIT) & ~1, merged)
    changed = ((slab2 != local) | point) & alive_row & active
    age2 = torch.where(changed, 0, torch.clamp_max(age0, age_stale - 1) + 1)
    susp_rec = is_suspect_key(slab2)
    susp2 = torch.where(
        susp_rec & active, torch.where(rearm | ~armed, susp_ticks, left0), 0
    )
    susp2 = torch.where(alive_row, susp2, s_loc)

    dead2 = is_dead_key(slab2)
    holding = (age2 < spread) | (susp2 > 0) | (dead2 & ~(age2 > sweep) & ~own)
    aggr = (
        ((holding & alive_row).any(dim=-2).to(torch.int32) << AGGR_HOLD_BIT)
        | ((susp_rec & alive_row).any(dim=-2).to(torch.int32) << AGGR_SUSPECT_BIT)
        | ((dead2 & alive_row).any(dim=-2).to(torch.int32) << AGGR_DEAD_BIT)
    )
    out = (
        slab2.to(torch.int32),
        age2.to(torch.int8),
        susp2.to(torch.int16),
        self_rumor.to(torch.int32),
        aggr,
    )
    return out + (expired,) if expiry else out


def check_offsets(n: int, s: int) -> None:
    """Raise ``ValueError`` for n * S >= 2**31, past the kernel's 32-bit
    offsets."""
    if n * s >= MAX_CELLS:
        raise ValueError(f"n*S = {n}*{s} >= 2**31 exceeds the kernel's 32-bit offsets")


def _check_operands(slab, age, susp, slot_subj, ginv, rots, edge_ok, alive,
                    fd_slot, sy_slot, fd_key, sy_key):
    lead = tuple(slab.shape[:-2])
    n, s = slab.shape[-2:]
    f = ginv.shape[-2]
    if len(lead) > 1:
        raise ValueError(f"slab: expected [N, S] or [B, N, S], got {tuple(slab.shape)}")
    if n % SPARSE_GROUP != 0:
        raise ValueError(f"n={n} is not a multiple of {SPARSE_GROUP}")
    if s >= 1 << SLOT_BITS:
        raise ValueError(f"S={s} must be < {1 << SLOT_BITS}")
    if not 1 <= f <= MAX_FANOUT:
        raise ValueError(f"gossip fanout {f} outside 1..{MAX_FANOUT}")
    expect = {
        "slab": (slab, torch.int32, (n, s)),
        "age": (age, torch.int8, (n, s)),
        "susp": (susp, torch.int16, (n, s)),
        "slot_subj": (slot_subj, torch.int32, (s,)),
        "ginv": (ginv, torch.int32, (f, n // SPARSE_GROUP)),
        "rots": (rots, torch.int32, (f, n // SPARSE_GROUP)),
        "edge_ok": (edge_ok, torch.bool, (f, n)),
        "alive": (alive, torch.bool, (n,)),
        "fd_slot": (fd_slot, torch.int32, (n,)),
        "sy_slot": (sy_slot, torch.int32, (n,)),
        "fd_key": (fd_key, torch.int32, (n,)),
        "sy_key": (sy_key, torch.int32, (n,)),
    }
    for name, (t, dtype, shape) in expect.items():
        shape = lead + shape
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(
                f"{name}: expected {dtype} {shape}, got {t.dtype} {tuple(t.shape)}"
            )
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != slab.device:
            raise ValueError(f"{name} is on {t.device}, slab on {slab.device}")


def _check_shard_mode(slab, row_base, slab_windows, age_windows):
    """The shard mode's operand checks (the reference's window refusals,
    pallas_sparse.py:377-396); returns ``row_base`` as ``[B]`` int32 on the
    slab's device (None without one)."""
    lead = tuple(slab.shape[:-2])
    s = slab.shape[-1]
    if (slab_windows is None) != (age_windows is None):
        raise ValueError("slab_windows and age_windows must be given together")
    if slab_windows is not None:
        if (
            tuple(slab_windows.shape[:-2]) != lead
            or slab_windows.shape[-1] != s
            or slab_windows.shape[-2] % SPARSE_GROUP != 0
            or tuple(age_windows.shape) != tuple(slab_windows.shape)
        ):
            raise ValueError(
                f"sender windows must be [32m, {s}] pairs, got "
                f"{tuple(slab_windows.shape)} / {tuple(age_windows.shape)}"
            )
        for name, t, dtype in (("slab_windows", slab_windows, torch.int32),
                               ("age_windows", age_windows, torch.int8)):
            if t.dtype != dtype or not t.is_contiguous() or t.device != slab.device:
                raise ValueError(f"{name}: expected contiguous {dtype} on {slab.device}")
    if row_base is None:
        return None
    if not isinstance(row_base, torch.Tensor):
        return torch.full(lead, int(row_base), dtype=torch.int32, device=slab.device)
    if row_base.dtype != torch.int32 or tuple(row_base.shape) != lead:
        raise ValueError(
            f"row_base: expected an int or int32 {lead}, got {row_base.dtype} "
            f"{tuple(row_base.shape)}"
        )
    return row_base.to(slab.device).contiguous()


def _declare(lib: ctypes.CDLL) -> None:
    lib.sparse_core_launch.argtypes = [ctypes.c_void_p] * 20 + [ctypes.c_int] * 9 + [
        ctypes.c_void_p
    ]
    lib.sparse_core_launch.restype = ctypes.c_int
    lib.sparse_core_error_string.argtypes = [ctypes.c_int]
    lib.sparse_core_error_string.restype = ctypes.c_char_p


#: ``csrc/sparse_core.cu``, compiled for sm_90a and loaded at first use.
LIBRARY = CudaLibrary("sparse_core", _declare)


def sparse_core(
    slab, age, susp, slot_subj, ginv, rots, edge_ok, alive,
    fd_slot, sy_slot, fd_key, sy_key, *, spread, susp_ticks, age_stale, sweep,
    row_base=None, slab_windows=None, age_windows=None,
):
    """The fused sparse tick core (see the module docstring; ``row_base``
    and the windows are its shard mode).

    CPU tensors run :func:`sparse_core_reference`. CUDA tensors launch the
    CUDA kernel on the current stream and count the launch in
    ``sparse_core.launches``; a missing kernel or a refused launch raises.
    Raises ``ValueError`` on a wrong dtype, shape, device or contiguity,
    on n % 32 != 0, on S >= 4096, on windows of another shape than
    ``[.., 32m, S]`` and, for CUDA tensors, on
    n * S >= 2**31 or a window array of 2**31 cells or more
    (:func:`check_offsets`, per universe: a batch's universes are reached
    through 64-bit offsets). The kernel reads window block ``ginv[c, j]``
    without a bounds check: its entries must lie below W / 32.
    """
    args = (slab, age, susp, slot_subj, ginv, rots, edge_ok, alive,
            fd_slot, sy_slot, fd_key, sy_key)
    _check_operands(*args)
    base = _check_shard_mode(slab, row_base, slab_windows, age_windows)
    consts = dict(spread=spread, susp_ticks=susp_ticks, age_stale=age_stale,
                  sweep=sweep)
    if slab.device.type == "cpu":
        return sparse_core_reference(*args, **consts, row_base=base,
                                     slab_windows=slab_windows, age_windows=age_windows)
    if slab.device.type != "cuda":
        raise ValueError(f"sparse_core: unsupported device {slab.device}")
    lead = tuple(slab.shape[:-2])
    n, s = slab.shape[-2:]
    check_offsets(n, s)
    win_slab, win_age, win_rows = slab, age, n
    if slab_windows is not None:
        win_slab, win_age, win_rows = slab_windows, age_windows, slab_windows.shape[-2]
        check_offsets(win_rows, s)
    lib = LIBRARY.load()
    slab2 = torch.empty_like(slab)
    age2 = torch.empty_like(age)
    susp2 = torch.empty_like(susp)
    # The launcher fills self_rumor with -1 and zeroes aggr on the stream.
    self_rumor = torch.empty(lead + (n,), dtype=torch.int32, device=slab.device)
    aggr = torch.empty(lead + (s,), dtype=torch.int32, device=slab.device)
    stream = torch.cuda.current_stream(slab.device).cuda_stream
    err = lib.sparse_core_launch(
        *(t.data_ptr() for t in args),
        win_slab.data_ptr(), win_age.data_ptr(), base.data_ptr() if base is not None else None,
        slab2.data_ptr(), age2.data_ptr(), susp2.data_ptr(),
        self_rumor.data_ptr(), aggr.data_ptr(),
        n, s, ginv.shape[-2], lead[0] if lead else 1, win_rows,
        spread, susp_ticks, age_stale, sweep, stream,
    )
    if err != 0:
        msg = lib.sparse_core_error_string(err).decode()
        raise RuntimeError(f"sparse_core: kernel launch failed: {msg} ({err})")
    sparse_core.launches += 1
    return slab2, age2, susp2, self_rumor, aggr


sparse_core.launches = 0

