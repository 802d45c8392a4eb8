"""Card feature probes (port of scalecube_cluster_tpu/tools/probe_mosaic.py).

The JAX tool probes what the TPU compiler lowers before a kernel design
commits to it. Its counterpart here probes the card features the port's
kernels rely on, one small CUDA kernel each (``csrc/probes.cu``), held
against a plain PyTorch version written from the probe's ``expect``
expression, at the probe's own shapes:

  p_smallint   int8 / int16 loads, stores and converts (ages, countdowns),
               4 cells a thread, the payload read only where it is kept;
  p_window2d   an 8-row window per 256-column tile, picked by an index and
               repeated down the output rows, one column vector a thread;
  p_accum      the row sums of an int32 [n, m], one warp a row reducing in
               registers (no zero fill, no atomics);
  p_fdmask     ``where(col == tgt[row], key[row], v)``, four cells a thread;
  p_roll       the row roll of an 8-row window.

Each wrapper runs its plain version on CPU tensors; on CUDA tensors it
launches its kernel and adds one to its ``launches``, or raises. Every
wrapper checks its operands on every device, before any read, and takes
shapes beyond the probe's own (planes off 16-byte alignment by a scalar
path; p_fdmask and p_roll refuse n * m >= 2**31): :data:`RAGGED_SHAPES`
(and, for p_window2d, :data:`WINDOW_SHAPES`) and :data:`WIDE_SHAPE` are
the shapes they are held and timed at besides the probe's.

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
#: Shapes p_smallint, p_accum, p_fdmask and p_roll are also held at:
#: ragged row counts, rows of 1 and 4 columns, widths off a multiple of 4
#: (the scalar path of p_accum and p_fdmask), cell counts off a multiple of
#: 4 (p_smallint's last thread).
RAGGED_SHAPES = ((33, 500), (1, 4), (96, 1028), (7, 501), (3, 2))
#: p_window2d's: (rows of ``rows``, column tiles, output rows).
WINDOW_SHAPES = ((8, 1, 8), (24, 3, 40), (64, 2, 32), (40, 5, 8), (16, 1, 40), (64, 4, 32))
#: The dense main path's width, where the probes are timed against their
#: bound (p_window2d: 40 tiles of ``rows`` [10240, 10240], 10240 output rows).
WIDE_SHAPE = (10240, 10240)
#: p_fdmask and p_roll index cells in 32 bits.
MAX_CELLS = 1 << 31
ROLL_SHAPE, ROLL_SHIFT = (8, 256), 3


def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    for name, argtypes in {
        "probe_smallint": [p] * 6 + [ctypes.c_int64, p],
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


def _check_planes(wrapper, **planes):
    """Raise ``ValueError`` unless each named operand has its dtype and
    rank (``name=(tensor, dtype, rank)``)."""
    for name, (t, dtype, rank) in planes.items():
        if t.dtype != dtype or t.dim() != rank:
            raise ValueError(f"{wrapper.__name__}: {name} must be "
                             f"{str(dtype).removeprefix('torch.')} of rank {rank}, "
                             f"got {t.dtype} of rank {t.dim()}")


def smallint_reference(a8, a16, v):
    young = a8.to(torch.int32) < 7
    o8 = torch.where(young, 0, torch.clamp_max(a8, 119) + 1).to(torch.int8)
    o16 = torch.where(young, 150, torch.clamp_min(a16.to(torch.int32) - 1, 0)).to(torch.int16)
    return o8, o16, torch.where(young, v, -1)


def smallint(a8, a16, v):
    """p_smallint: ``(o8, o16, ov)``, the age / countdown / payload pass
    over int8 ages ``a8``, int16 countdowns ``a16`` and int32 payloads
    ``v`` of one [n, m] shape."""
    _check_planes(smallint, a8=(a8, torch.int8, 2), a16=(a16, torch.int16, 2),
                  v=(v, torch.int32, 2))
    if a16.shape != a8.shape or v.shape != a8.shape:
        raise ValueError(f"smallint: a8 {tuple(a8.shape)}, a16 {tuple(a16.shape)} and "
                         f"v {tuple(v.shape)} must have one shape")
    if a8.device.type == "cpu":
        return smallint_reference(a8, a16, v)
    outs = (torch.empty_like(a8), torch.empty_like(a16), torch.empty_like(v))
    return _launch(smallint, "probe_smallint", (a8, a16, v), outs, (a8.numel(),))


def window2d_reference(rows, idx, out_rows=WINDOW_OUT_ROWS):
    tiles = [
        rows[8 * g: 8 * g + 8, j * WINDOW_MC: (j + 1) * WINDOW_MC].repeat(out_rows // 8, 1)
        for j, g in enumerate(idx.tolist())
    ]
    return torch.cat(tiles, dim=1)


def window2d(rows, idx, out_rows=WINDOW_OUT_ROWS):
    """p_window2d: for column tile j (256 columns), the 8-row window of
    int32 ``rows`` at block ``idx[j]`` repeated down ``out_rows`` output
    rows. ``rows`` has one tile per entry of ``idx`` and a multiple of 8
    rows, ``out_rows`` is a positive multiple of 8, and every ``idx`` value
    must lie in ``[0, rows.shape[0] // 8)``: that one is not checked, since
    checking it would read the device."""
    _check_planes(window2d, rows=(rows, torch.int32, 2), idx=(idx, torch.int32, 1))
    n, m = rows.shape
    if idx.numel() * WINDOW_MC != m:
        raise ValueError(f"window2d: rows has {m} columns; idx's {idx.numel()} tiles "
                         f"cover {idx.numel() * WINDOW_MC}")
    if n % 8 != 0:
        raise ValueError(f"window2d: rows has {n} rows, not a multiple of 8")
    if out_rows <= 0 or out_rows % 8 != 0:
        raise ValueError(f"window2d: out_rows {out_rows} is not a positive multiple of 8")
    if rows.device.type == "cpu":
        return window2d_reference(rows, idx, out_rows)
    out = torch.empty((out_rows, m), dtype=torch.int32, device=rows.device)
    ints = (idx.numel(), m, WINDOW_MC, out_rows)
    return _launch(window2d, "probe_window2d", (rows, idx), (out,), ints)[0]


def accum_reference(x):
    return x.sum(dim=1, dtype=torch.int32)


def accum(x):
    """p_accum: the row sums of an int32 [n, m] ``x``, wrapping as int32."""
    _check_planes(accum, x=(x, torch.int32, 2))
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
    _check_planes(fdmask, fdt=(fdt, torch.int32, 1), fdk=(fdk, torch.int32, 1),
                  v=(v, torch.int32, 2))
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
    """p_roll: an int32 [n, m] ``x`` rolled by :data:`ROLL_SHIFT` rows."""
    _check_planes(roll, x=(x, torch.int32, 2))
    if x.numel() >= MAX_CELLS:
        raise ValueError(f"roll: x has {x.numel()} cells; the kernel takes fewer than 2**31")
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


def smallint_operands(rng, shape):
    """p_smallint's operands at ``shape``: ages in [0, 120), countdowns in
    [0, 400), payloads in [-1, 2**20)."""
    return (
        rng.integers(0, 120, shape).astype(np.int8),
        rng.integers(0, 400, shape).astype(np.int16),
        rng.integers(-1, 1 << 20, shape).astype(np.int32),
    )


def window2d_operands(rng, shape):
    """p_window2d's operands for ``rows`` of ``shape`` [n, m]: ``rows`` over
    all of int32, and one window block in [0, n // 8) per 256-column tile."""
    n, m = shape
    return (rng.integers(-(1 << 31), 1 << 31, shape, dtype=np.int32),
            rng.integers(0, n // 8, m // WINDOW_MC).astype(np.int32))


def probe_inputs(seed: int = 0) -> dict:
    """Each probe's operands as numpy arrays, from one seed, at the probe's
    shapes and value ranges."""
    rng = np.random.default_rng(seed)
    return {
        "p_smallint": smallint_operands(rng, SMALLINT_SHAPE),
        "p_window2d": (
            np.arange(WINDOW_ROWS * WINDOW_M, dtype=np.int32).reshape(WINDOW_ROWS, WINDOW_M),
            np.asarray(WINDOW_IDX, np.int32),
        ),
        "p_accum": accum_operands(rng, ACCUM_SHAPE, 0, 5),
        "p_fdmask": fdmask_operands(rng, FDMASK_SHAPE),
        "p_roll": (np.arange(ROLL_SHAPE[0] * ROLL_SHAPE[1], dtype=np.int32).reshape(ROLL_SHAPE),),
    }


def shaped_inputs(name: str, shape, seed: int = 0) -> tuple:
    """Probe ``name``'s operands at any ``shape`` (numpy, seeded; for
    p_window2d the shape of ``rows``, a multiple of 256 columns wide):
    p_accum's and p_roll's over all of int32."""
    rng = np.random.default_rng(seed)
    draw = {"p_smallint": smallint_operands, "p_window2d": window2d_operands,
            "p_accum": accum_operands, "p_fdmask": fdmask_operands, "p_roll": accum_operands}
    return draw[name](rng, shape)


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
