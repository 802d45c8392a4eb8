"""Fused gossip delivery + membership merge over the dense tables: the
hand-written CUDA kernel, its plain PyTorch version, and the wrapper that
picks between them by device.

Port of scalecube_cluster_tpu/ops/pallas_tick.py::delivery_merge_pallas:
the stage-A two-channel permutation delivery of the young payload
``rows``, the merge lattice against each receiver's table, the raw
``best_any`` diagonal (the self-rumor, taken before the diagonal is
excluded) and the dead-receiver freeze.

- :func:`delivery_merge_reference` is the plain version, written from the
  reference's XLA formula.
- :func:`delivery_merge` is the wrapper: on CPU tensors it runs the
  reference; on CUDA tensors it launches ``csrc/delivery_merge.cu`` and
  adds one to ``delivery_merge.launches``, or raises. The reference's
  m % 128 fallback is a TPU lane rule: the kernel takes any n % 8 == 0
  below the 32-bit offset limit (n * n < 2**31).
"""

from __future__ import annotations

import ctypes

import torch

from scalecube_cluster_tpu_torch.ops.cuda_build import CudaLibrary
from scalecube_cluster_tpu_torch.ops.delivery import (
    GROUP,
    inv_from_structured,
    permuted_delivery_two_channel,
)
from scalecube_cluster_tpu_torch.ops.merge import is_alive_key, merge_views
from scalecube_cluster_tpu_torch.ops.tick_core import check_offsets

#: Channels the kernel's per-CTA shared-memory tables hold (``kMaxFanout``
#: in csrc/delivery_merge.cu).
MAX_FANOUT = 8
#: Columns of one CTA's tile (``kTile`` in csrc/delivery_merge.cu, which
#: owns the grid: n/8 receiver groups by column tiles, the groups fastest,
#: so ``rows[:, tile]``, 10.5 MB at n=10240, stays in L2 across the f reads
#: of each sender cell). The tile-edge test operands sit on its boundaries.
TILE_COLS = 256


def delivery_merge_reference(rows, local_view, ginv, rots, edge_ok, alive):
    """Plain PyTorch version; same signature and outputs as
    :func:`delivery_merge`: ``(merged [N, N] i32, self_rumor [N] i32)``."""
    n = rows.shape[0]
    inv = inv_from_structured(ginv, rots, n, GROUP)
    best_any, best_alive = permuted_delivery_two_channel(rows, is_alive_key, inv, edge_ok)
    self_rumor = torch.diagonal(best_any).clone()
    diag = torch.eye(n, dtype=torch.bool, device=rows.device)
    merged, _ = merge_views(
        local_view,
        torch.where(diag, -1, best_any),
        torch.where(diag, -1, best_alive),
    )
    return torch.where(alive[:, None], merged, local_view), self_rumor


def _check_operands(rows, local_view, ginv, rots, edge_ok, alive):
    n = rows.shape[0]
    f = ginv.shape[0]
    if n == 0 or n % GROUP != 0:
        raise ValueError(f"n={n} is not a positive multiple of {GROUP}")
    if not 1 <= f <= MAX_FANOUT:
        raise ValueError(f"gossip fanout {f} outside 1..{MAX_FANOUT}")
    check_offsets(n)
    expect = {
        "rows": (rows, torch.int32, (n, n)),
        "local_view": (local_view, torch.int32, (n, n)),
        "ginv": (ginv, torch.int32, (f, n // GROUP)),
        "rots": (rots, torch.int32, (f, n // GROUP)),
        "edge_ok": (edge_ok, torch.bool, (f, n)),
        "alive": (alive, torch.bool, (n,)),
    }
    for name, (t, dtype, shape) in expect.items():
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(
                f"{name}: expected {dtype} {shape}, got {t.dtype} {tuple(t.shape)}"
            )
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != rows.device:
            raise ValueError(f"{name} is on {t.device}, rows on {rows.device}")


def _declare(lib: ctypes.CDLL) -> None:
    lib.delivery_merge_launch.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 2 + [
        ctypes.c_void_p
    ]
    lib.delivery_merge_launch.restype = ctypes.c_int
    lib.delivery_merge_error_string.argtypes = [ctypes.c_int]
    lib.delivery_merge_error_string.restype = ctypes.c_char_p


#: ``csrc/delivery_merge.cu``, compiled for sm_90a and loaded at first use.
LIBRARY = CudaLibrary("delivery_merge", _declare)


def delivery_merge(rows, local_view, ginv, rots, edge_ok, alive):
    """Fused delivery + merge (see the module docstring); the signature of
    the reference's ``delivery_merge_pallas`` without ``interpret``.

    ``rows`` is the young payload and ``local_view`` each receiver's table,
    both ``[N, N]`` int32; ``ginv``/``rots`` the structured fan-out ``[f,
    N/8]``; ``edge_ok [f, N]`` and ``alive [N]`` bool. Returns ``(merged,
    self_rumor)``. Raises ``ValueError`` on a wrong dtype, shape, device or
    contiguity, on n % 8 != 0, on n * n >= 2**31 and on more than
    :data:`MAX_FANOUT` channels.

    CPU tensors run :func:`delivery_merge_reference`. CUDA tensors launch
    the kernel on the current stream and count the launch in
    ``delivery_merge.launches``; a missing kernel or a refused launch
    raises."""
    args = (rows, local_view, ginv, rots, edge_ok, alive)
    _check_operands(*args)
    if rows.device.type == "cpu":
        return delivery_merge_reference(*args)
    if rows.device.type != "cuda":
        raise ValueError(f"delivery_merge: unsupported device {rows.device}")
    lib = LIBRARY.load()
    n = rows.shape[0]
    merged = torch.empty_like(local_view)
    self_rumor = torch.empty((n,), dtype=torch.int32, device=rows.device)
    stream = torch.cuda.current_stream(rows.device).cuda_stream
    err = lib.delivery_merge_launch(
        *(t.data_ptr() for t in args), merged.data_ptr(), self_rumor.data_ptr(),
        n, ginv.shape[0], stream,
    )
    if err != 0:
        msg = lib.delivery_merge_error_string(err).decode()
        raise RuntimeError(f"delivery_merge: kernel launch failed: {msg} ({err})")
    delivery_merge.launches += 1
    return merged, self_rumor


delivery_merge.launches = 0
