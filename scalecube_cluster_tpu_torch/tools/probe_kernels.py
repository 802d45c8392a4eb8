"""Card feature probes (port of scalecube_cluster_tpu/tools/probe_mosaic.py).

The JAX tool probes what the TPU compiler lowers before a kernel design
commits to it. Its counterpart here probes the card features the port's
kernels rely on, one small CUDA kernel each (``csrc/probes.cu``), held
against a plain PyTorch version written from the probe's ``expect``
expression, at the probe's own shapes:

  p_smallint   int8 / int16 loads, stores and converts (ages, countdowns);
  p_window2d   a 2D row window staged in shared memory by ``cp.async``;
  p_accum      the row sums of an int32 [n, m], one warp a row reducing in
               registers (no zero fill, no atomics);
  p_fdmask     ``where(col == tgt[row], key[row], v)``, four cells a thread;
  p_roll       the row roll of an 8-row window.

Each wrapper runs its plain version on CPU tensors; on CUDA tensors it
launches its kernel and adds one to its ``launches``, or raises. p_accum
and p_fdmask take any [n, m] as well (rows off 16-byte alignment by a
scalar path; p_fdmask refuses n * m >= 2**31) and check their operands
on every device; :data:`RAGGED_SHAPES` and :data:`WIDE_SHAPE` are the
shapes they are held and timed at besides the probe's own.

Run on a CUDA card: ``python -m scalecube_cluster_tpu_torch.tools.probe_kernels``
prints PASS or FAIL per probe and exits non-zero on any FAIL (2 when there
is no card: the probes are of the card).
"""

from __future__ import annotations

import ctypes
import sys
import traceback

import numpy as np
import torch

from scalecube_cluster_tpu_torch.ops.cuda_build import CudaLibrary

#: The probes' shapes (tools/probe_mosaic.py).
SMALLINT_SHAPE = (64, 256)
WINDOW_ROWS, WINDOW_M, WINDOW_MC, WINDOW_IDX, WINDOW_OUT_ROWS = 64, 512, 256, (3, 1), 32
ACCUM_SHAPE = (32, 512)
FDMASK_SHAPE = (64, 256)
#: Shapes p_accum and p_fdmask are also held at: ragged row counts, rows
#: of 1 and 4 columns, widths off a multiple of 4 (the scalar path).
RAGGED_SHAPES = ((33, 500), (1, 4), (96, 1028), (7, 501), (3, 2))
#: The dense main path's width, where the two are timed against their bound.
WIDE_SHAPE = (10240, 10240)
#: p_fdmask indexes cells in 32 bits.
MAX_CELLS = 1 << 31
ROLL_SHAPE, ROLL_SHIFT = (8, 256), 3


def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    for name, argtypes in {
        "probe_smallint": [p] * 6 + [i, p],
        "probe_window2d": [p] * 3 + [i] * 4 + [p],
        "probe_accum": [p] * 2 + [i] * 2 + [p],
        "probe_fdmask": [p] * 4 + [i] * 2 + [p],
        "probe_roll": [p] * 2 + [i] * 3 + [p],
        "probe_noop": [p],
    }.items():
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = ctypes.c_int
    lib.probes_error_string.argtypes = [ctypes.c_int]
    lib.probes_error_string.restype = ctypes.c_char_p


#: ``csrc/probes.cu``, compiled for sm_90a and loaded at first use.
LIBRARY = CudaLibrary("probes", _declare)


def _launch(wrapper, symbol, inputs, outputs, ints):
    """Launch ``symbol`` on the inputs' card: tensors as pointers, then the
    integer arguments and the current stream; count it on ``wrapper``."""
    dev = inputs[0].device
    if dev.type != "cuda":
        raise ValueError(f"{wrapper.__name__}: unsupported device {dev}")
    for t in inputs:
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"{wrapper.__name__}: operands must be contiguous on {dev}")
    lib = LIBRARY.load()
    err = getattr(lib, symbol)(
        *(t.data_ptr() for t in (*inputs, *outputs)), *ints,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        msg = lib.probes_error_string(err).decode()
        raise RuntimeError(f"{wrapper.__name__}: kernel launch failed: {msg} ({err})")
    wrapper.launches += 1
    return outputs


def smallint_reference(a8, a16, v):
    young = a8.to(torch.int32) < 7
    o8 = torch.where(young, 0, torch.clamp_max(a8, 119) + 1).to(torch.int8)
    o16 = torch.where(young, 150, torch.clamp_min(a16.to(torch.int32) - 1, 0)).to(torch.int16)
    return o8, o16, torch.where(young, v, -1)


def smallint(a8, a16, v):
    """p_smallint: ``(o8, o16, ov)``, the age / countdown / payload pass."""
    if a8.device.type == "cpu":
        return smallint_reference(a8, a16, v)
    outs = (torch.empty_like(a8), torch.empty_like(a16), torch.empty_like(v))
    return _launch(smallint, "probe_smallint", (a8, a16, v), outs, (a8.numel(),))


def window2d_reference(rows, idx):
    tiles = [
        rows[8 * g: 8 * g + 8, j * WINDOW_MC: (j + 1) * WINDOW_MC].repeat(WINDOW_OUT_ROWS // 8, 1)
        for j, g in enumerate(idx.tolist())
    ]
    return torch.cat(tiles, dim=1)


def window2d(rows, idx):
    """p_window2d: for column tile j, the 8-row window at block ``idx[j]``
    repeated over the 32 output rows."""
    if rows.device.type == "cpu":
        return window2d_reference(rows, idx)
    out = torch.empty((WINDOW_OUT_ROWS, rows.shape[1]), dtype=torch.int32, device=rows.device)
    ints = (idx.numel(), rows.shape[1], WINDOW_MC, WINDOW_OUT_ROWS)
    return _launch(window2d, "probe_window2d", (rows, idx), (out,), ints)[0]


def _check_int32(wrapper, **planes):
    """Raise ``ValueError`` unless each named operand is int32 of its rank
    (``name=(tensor, rank)``)."""
    for name, (t, rank) in planes.items():
        if t.dtype != torch.int32 or t.dim() != rank:
            raise ValueError(f"{wrapper.__name__}: {name} must be int32 of rank {rank}, "
                             f"got {t.dtype} of rank {t.dim()}")


def accum_reference(x):
    return x.sum(dim=1, dtype=torch.int32)


def accum(x):
    """p_accum: the row sums of an int32 [n, m] ``x``, wrapping as int32."""
    _check_int32(accum, x=(x, 2))
    if x.device.type == "cpu":
        return accum_reference(x)
    acc = torch.empty((x.shape[0],), dtype=torch.int32, device=x.device)
    return _launch(accum, "probe_accum", (x,), (acc,), tuple(x.shape))[0]


def fdmask_reference(fdt, fdk, v):
    cols = torch.arange(v.shape[1], device=v.device)[None, :]
    return torch.where(cols == fdt[:, None], fdk[:, None], v)


def fdmask(fdt, fdk, v):
    """p_fdmask: row r's key ``fdk[r]`` at its target column ``fdt[r]`` (-1:
    none), ``v`` elsewhere; int32 [n] targets and keys, int32 [n, m] ``v``."""
    _check_int32(fdmask, fdt=(fdt, 1), fdk=(fdk, 1), v=(v, 2))
    if fdt.shape[0] != v.shape[0] or fdk.shape[0] != v.shape[0]:
        raise ValueError(f"fdmask: fdt {tuple(fdt.shape)} and fdk {tuple(fdk.shape)} "
                         f"must have one entry per row of v {tuple(v.shape)}")
    if v.numel() >= MAX_CELLS:
        raise ValueError(f"fdmask: v has {v.numel()} cells; the kernel takes fewer than 2**31")
    if v.device.type == "cpu":
        return fdmask_reference(fdt, fdk, v)
    out = torch.empty_like(v)
    return _launch(fdmask, "probe_fdmask", (fdt, fdk, v), (out,), tuple(v.shape))[0]


def noop(device="cuda"):
    """Launch the empty kernel on ``device``'s current stream: its device
    time is the launch floor the probes are read against. Not a probe, and
    no path launches it."""
    lib = LIBRARY.load()
    err = lib.probe_noop(torch.cuda.current_stream(torch.device(device)).cuda_stream)
    if err != 0:
        raise RuntimeError(f"noop: kernel launch failed: {lib.probes_error_string(err).decode()}")


def roll_reference(x):
    return torch.roll(x, ROLL_SHIFT, dims=0)


def roll(x):
    """p_roll: ``x`` rolled by :data:`ROLL_SHIFT` rows."""
    if x.device.type == "cpu":
        return roll_reference(x)
    out = torch.empty_like(x)
    return _launch(roll, "probe_roll", (x,), (out,), (*x.shape, ROLL_SHIFT))[0]


for _wrapper in (smallint, window2d, accum, fdmask, roll):
    _wrapper.launches = 0


def accum_operands(rng, shape, low=-(1 << 31), high=1 << 31):
    """p_accum's operand at ``shape``, drawn from ``rng`` in [low, high):
    by default all of int32, so the row sums wrap."""
    return (rng.integers(low, high, shape, dtype=np.int64).astype(np.int32),)


def fdmask_operands(rng, shape):
    """p_fdmask's operands at ``shape``: targets in [-1, m), keys, values."""
    n, m = shape
    return (
        rng.integers(-1, m, n).astype(np.int32),
        rng.integers(0, 1 << 20, n).astype(np.int32),
        rng.integers(-1, 1 << 20, (n, m)).astype(np.int32),
    )


def probe_inputs(seed: int = 0) -> dict:
    """Each probe's operands as numpy arrays, from one seed, at the probe's
    shapes and value ranges."""
    rng = np.random.default_rng(seed)
    n, m = SMALLINT_SHAPE
    return {
        "p_smallint": (
            rng.integers(0, 120, (n, m)).astype(np.int8),
            rng.integers(0, 400, (n, m)).astype(np.int16),
            rng.integers(-1, 1 << 20, (n, m)).astype(np.int32),
        ),
        "p_window2d": (
            np.arange(WINDOW_ROWS * WINDOW_M, dtype=np.int32).reshape(WINDOW_ROWS, WINDOW_M),
            np.asarray(WINDOW_IDX, np.int32),
        ),
        "p_accum": accum_operands(rng, ACCUM_SHAPE, 0, 5),
        "p_fdmask": fdmask_operands(rng, FDMASK_SHAPE),
        "p_roll": (np.arange(ROLL_SHAPE[0] * ROLL_SHAPE[1], dtype=np.int32).reshape(ROLL_SHAPE),),
    }


def shaped_inputs(name: str, shape, seed: int = 0) -> tuple:
    """p_accum's or p_fdmask's operands at any ``shape`` (numpy, seeded)."""
    rng = np.random.default_rng(seed)
    return {"p_accum": accum_operands, "p_fdmask": fdmask_operands}[name](rng, shape)


#: name → (the probe_mosaic.py title, wrapper, plain version, its pallas_call line).
PROBES = {
    "p_smallint": ("int8/int16 blocked io + elementwise", smallint, smallint_reference, 64),
    "p_window2d": ("2D-sliced window DMA from ANY ref", window2d, window2d_reference, 116),
    "p_accum": ("revisited accumulator output over inner grid dim", accum, accum_reference, 152),
    "p_fdmask": ("SMEM dynamic scalar loads + fd cell mask", fdmask, fdmask_reference, 180),
    "p_roll": ("roll on rotated window (existing kernel dep)", roll, roll_reference, 203),
}


def _as_tuple(out):
    return out if isinstance(out, tuple) else (out,)


def run_probes(device="cuda", seed: int = 0) -> list:
    """Run every probe's wrapper and plain version on the same operands on
    ``device``. Returns one dict per probe: ``name``, ``title``, ``ok``,
    ``max_abs_err`` (None when it raised) and ``error``."""
    results = []
    for name, ops in probe_inputs(seed).items():
        title, wrapper, reference, _ = PROBES[name]
        args = [torch.from_numpy(a).to(device) for a in ops]
        row = {"name": name, "title": title, "ok": False, "max_abs_err": None, "error": None}
        try:
            got = _as_tuple(wrapper(*args))
            want = _as_tuple(reference(*args))
            if device != "cpu":
                torch.cuda.synchronize()
            same = all(g.dtype == w.dtype and g.shape == w.shape for g, w in zip(got, want))
            err = max(int((g.long() - w.long()).abs().max()) for g, w in zip(got, want))
            row.update(ok=same and err == 0, max_abs_err=err)
        except Exception:  # noqa: BLE001 -- reported as FAIL, like the JAX tool
            row["error"] = traceback.format_exc(limit=3)
        results.append(row)
    return results


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_kernels: no CUDA device; the probes are of the card", file=sys.stderr)
        return 2
    print("device:", torch.cuda.get_device_name(0), file=sys.stderr)
    results = run_probes("cuda")
    for row in results:
        print(f"{'PASS' if row['ok'] else 'FAIL'} {row['title']}")
        if row["error"]:
            print(row["error"], file=sys.stderr)
    return 0 if all(row["ok"] for row in results) else 1


if __name__ == "__main__":
    sys.exit(main())
