"""The card probes' plain versions against the ``expect`` expressions of
the JAX package's ``tools/probe_mosaic.py``, on the same seeded numpy
operands (tolerance: none), at the probes' shapes and at ragged ones
(p_window2d: several tile counts and output row counts). The wrappers run
the plain version on CPU tensors and launch nothing; their operand checks
run on every device. The
tests marked ``cuda`` need a card and skip without one; on a machine with
PyTorch alone run them as ``python -m pytest --noconftest -m cuda
tests/test_torch_probes.py``.
"""

import numpy as np
import pytest
import torch

from scalecube_cluster_tpu_torch.testing import misaligned
from scalecube_cluster_tpu_torch.tools import core_timing
from scalecube_cluster_tpu_torch.tools import probe_kernels as pk
from scalecube_cluster_tpu_torch.testing import one_cpu_thread

one_cpu_thread()


def _expect(name, ops, out_rows=pk.WINDOW_OUT_ROWS):
    """Each probe's ``expect`` expression, as probe_mosaic.py writes it
    (p_window2d's window tiled down ``out_rows`` rows, the probe's 32 by
    default)."""
    import jax.numpy as jnp

    if name == "p_smallint":
        a8, a16, v = (jnp.asarray(a) for a in ops)
        young = a8.astype(jnp.int32) < 7
        return (
            jnp.where(young, 0, jnp.minimum(a8, 119) + 1).astype(jnp.int8),
            jnp.where(young, 150, jnp.maximum(a16.astype(jnp.int32) - 1, 0)).astype(jnp.int16),
            jnp.where(young, v, -1),
        )
    if name == "p_window2d":
        rows, idx = (jnp.asarray(a) for a in ops)
        mc = pk.WINDOW_MC
        return (jnp.concatenate(
            [jnp.tile(rows[g * 8: g * 8 + 8, j * mc: (j + 1) * mc], (out_rows // 8, 1))
             for j, g in enumerate(np.asarray(idx).tolist())], axis=1),)
    if name == "p_accum":
        return (jnp.sum(jnp.asarray(ops[0]), axis=1),)
    if name == "p_fdmask":
        fdt, fdk, v = (jnp.asarray(a) for a in ops)
        cols = jnp.arange(v.shape[1])[None, :]
        return (jnp.where(cols == fdt[:, None], fdk[:, None], v),)
    if name == "p_roll":
        return (jnp.roll(jnp.asarray(ops[0]), 3, axis=0),)
    raise KeyError(name)


@pytest.mark.parametrize("name", list(pk.PROBES))
@pytest.mark.parametrize("seed", [0, 1])
def test_plain_probe_matches_expect(name, seed):
    ops = pk.probe_inputs(seed)[name]
    _, wrapper, _, _ = pk.PROBES[name]
    before = wrapper.launches
    got = wrapper(*(torch.from_numpy(a) for a in ops))
    got = got if isinstance(got, tuple) else (got,)
    assert wrapper.launches == before
    want = _expect(name, ops)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype and np.array_equal(g.numpy(), w), name


def test_run_probes_on_cpu_passes():
    """run_probes holds each wrapper against its plain version; on the CPU
    both are the plain version, so every probe passes and none launches."""
    before = [w.launches for _, w, _, _ in pk.PROBES.values()]
    results = pk.run_probes("cpu")
    assert [r["name"] for r in results] == list(pk.PROBES)
    assert all(r["ok"] and r["max_abs_err"] == 0 for r in results), results
    assert [w.launches for _, w, _, _ in pk.PROBES.values()] == before


@pytest.mark.cuda
def test_probes_pass_on_card():
    """On the card: every probe kernel equals its plain version, one launch each."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    before = {name: w.launches for name, (_, w, _, _) in pk.PROBES.items()}
    results = pk.run_probes("cuda")
    assert all(r["ok"] for r in results), results
    for name, (_, w, _, _) in pk.PROBES.items():
        assert w.launches == before[name] + 1, name


RAGGED_PROBES = ["p_smallint", "p_accum", "p_fdmask", "p_roll"]


@pytest.mark.parametrize("shape", pk.RAGGED_SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("name", RAGGED_PROBES)
def test_plain_matches_expect_at_ragged_shapes(name, shape):
    """p_smallint (cell counts off a multiple of 4 among them), p_accum
    (row sums over all of int32, so they wrap), p_fdmask and p_roll at
    ragged shapes, widths off a multiple of 4 among them."""
    ops = pk.shaped_inputs(name, shape, seed=7)
    _, wrapper, _, _ = pk.PROBES[name]
    before = wrapper.launches
    got = wrapper(*(torch.from_numpy(a) for a in ops))
    got = got if isinstance(got, tuple) else (got,)
    assert wrapper.launches == before
    want = _expect(name, ops)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype and np.array_equal(g.numpy(), w), name


def _window_shape_id(shape):
    n, tiles, out_rows = shape
    return f"{n}rows-{tiles}tiles-out{out_rows}"


@pytest.mark.parametrize("shape", pk.WINDOW_SHAPES, ids=_window_shape_id)
def test_plain_window2d_matches_expect(shape):
    """p_window2d at 1 to 5 column tiles and 8, 32 and 40 output rows, on
    ``rows`` over all of int32 with drawn window blocks."""
    n, tiles, out_rows = shape
    ops = pk.shaped_inputs("p_window2d", (n, tiles * pk.WINDOW_MC), seed=7)
    before = pk.window2d.launches
    got = pk.window2d(*(torch.from_numpy(a) for a in ops), out_rows=out_rows)
    assert pk.window2d.launches == before
    assert got.shape == (out_rows, tiles * pk.WINDOW_MC)
    (want,) = _expect("p_window2d", ops, out_rows)
    want = np.asarray(want)
    assert got.numpy().dtype == want.dtype and np.array_equal(got.numpy(), want)


def _int32(*shape):
    return torch.zeros(shape, dtype=torch.int32)


def _smallint(shape=(4, 8), a8=torch.int8, a16=torch.int16, v=torch.int32, v_shape=None):
    return pk.smallint(torch.zeros(shape, dtype=a8), torch.zeros(shape, dtype=a16),
                       torch.zeros(v_shape or shape, dtype=v))


@pytest.mark.parametrize("call, match", [
    (lambda: pk.accum(_int32(4, 8).to(torch.int64)), "x must be int32 of rank 2"),
    (lambda: pk.accum(_int32(8)), "x must be int32 of rank 2"),
    (lambda: pk.fdmask(_int32(4), _int32(4), _int32(4, 8).to(torch.int16)),
     "v must be int32 of rank 2"),
    (lambda: pk.fdmask(_int32(4, 1), _int32(4), _int32(4, 8)), "fdt must be int32 of rank 1"),
    (lambda: pk.fdmask(_int32(4), _int32(4).float(), _int32(4, 8)),
     "fdk must be int32 of rank 1"),
    (lambda: pk.fdmask(_int32(3), _int32(4), _int32(4, 8)), "one entry per row"),
    (lambda: pk.fdmask(_int32(4), _int32(5), _int32(4, 8)), "one entry per row"),
    # 2**31 cells as a broadcast view: the limit is checked before any read.
    (lambda: pk.fdmask(_int32(1 << 16), _int32(1 << 16),
                       _int32(1, 1).expand(1 << 16, 1 << 15)), "fewer than 2"),
    (lambda: _smallint(a8=torch.uint8), "a8 must be int8 of rank 2"),
    (lambda: _smallint(a16=torch.int32), "a16 must be int16 of rank 2"),
    (lambda: _smallint(v=torch.int64), "v must be int32 of rank 2"),
    (lambda: _smallint(shape=(32,)), "a8 must be int8 of rank 2"),
    (lambda: _smallint(v_shape=(4, 9)), "must have one shape"),
    (lambda: pk.smallint(torch.zeros(4, 8, dtype=torch.int8), torch.zeros(8, 4, dtype=torch.int16),
                         _int32(4, 8)), "must have one shape"),
    # The shapes that left columns of the output unwritten: idx short of
    # rows' tiles, and rows wider than a whole number of tiles.
    (lambda: pk.window2d(_int32(64, 512), _int32(1)), "idx's 1 tiles cover 256"),
    (lambda: pk.window2d(_int32(64, 300), _int32(1)), "idx's 1 tiles cover 256"),
    (lambda: pk.window2d(_int32(64, 256), _int32(2)), "idx's 2 tiles cover 512"),
    (lambda: pk.window2d(_int32(60, 256), _int32(1)), "not a multiple of 8"),
    (lambda: pk.window2d(_int32(64, 256), _int32(1), out_rows=12), "out_rows 12"),
    (lambda: pk.window2d(_int32(64, 256), _int32(1), out_rows=0), "out_rows 0"),
    (lambda: pk.window2d(_int32(64, 256).to(torch.int16), _int32(1)),
     "rows must be int32 of rank 2"),
    (lambda: pk.window2d(_int32(64, 256), _int32(1, 1)), "idx must be int32 of rank 1"),
    (lambda: pk.roll(_int32(8, 256).to(torch.int64)), "x must be int32 of rank 2"),
    (lambda: pk.roll(_int32(256)), "x must be int32 of rank 2"),
    (lambda: pk.roll(_int32(1, 1).expand(1 << 16, 1 << 15)), "fewer than 2"),
], ids=["accum-dtype", "accum-rank", "fdmask-v-dtype", "fdmask-fdt-rank", "fdmask-fdk-dtype",
        "fdmask-short-fdt", "fdmask-long-fdk", "fdmask-cells", "smallint-a8-dtype",
        "smallint-a16-dtype", "smallint-v-dtype", "smallint-rank", "smallint-v-shape",
        "smallint-a16-shape", "window2d-short-idx", "window2d-ragged-width",
        "window2d-long-idx", "window2d-rows", "window2d-out-rows", "window2d-no-out-rows",
        "window2d-dtype", "window2d-idx-rank", "roll-dtype", "roll-rank", "roll-cells"])
def test_wrappers_check_operands(call, match):
    """The wrappers' operand checks need no card: they run on CPU tensors
    before the plain version, as on CUDA ones before a launch."""
    with pytest.raises(ValueError, match=match):
        call()


@pytest.mark.parametrize("name", list(core_timing.PROBE_SHAPES))
def test_core_timing_draws_the_probes_operands(name):
    """core_timing.py draws the probes' operands itself (so that an older
    tree's probes are timed on them); they are shaped_inputs'."""
    shape = core_timing.PROBE_SHAPES[name][0]
    for got, want in zip(core_timing.probe_operands(name, shape),
                         pk.shaped_inputs(name, shape, seed=7)):
        assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "off-alignment"])
@pytest.mark.parametrize("shape", [None, *pk.RAGGED_SHAPES, pk.WIDE_SHAPE],
                         ids=lambda s: "probe" if s is None else f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("name", RAGGED_PROBES)
def test_kernel_matches_plain_on_card(name, shape, aligned):
    """On the card: p_smallint's, p_accum's, p_fdmask's and p_roll's
    kernels equal their plain versions at the probe's shape, the ragged
    shapes and the dense main path's width, with the last operand on and
    off 16-byte alignment (the scalar path); one launch a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    ops = pk.probe_inputs(0)[name] if shape is None else pk.shaped_inputs(name, shape, seed=7)
    args = [torch.from_numpy(a).cuda() for a in ops]
    if not aligned:
        args[-1] = misaligned(args[-1])
    _, wrapper, reference, _ = pk.PROBES[name]
    before = wrapper.launches
    got = wrapper(*args)
    assert wrapper.launches == before + 1
    want = reference(*args)
    torch.cuda.synchronize()
    got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w), (name, shape, aligned)


@pytest.mark.cuda
@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "off-alignment"])
@pytest.mark.parametrize("shape", [*pk.WINDOW_SHAPES, (10240, 40, 10240)], ids=_window_shape_id)
def test_window2d_kernel_matches_plain_on_card(shape, aligned):
    """On the card: p_window2d's kernel equals its plain version at 1 to 5
    tiles, 8 to 40 output rows and the dense main path's width (40 tiles,
    10240 output rows), with ``rows`` on and off 16-byte alignment (the
    4-byte path); one launch a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    n, tiles, out_rows = shape
    ops = pk.shaped_inputs("p_window2d", (n, tiles * pk.WINDOW_MC), seed=7)
    rows, idx = (torch.from_numpy(a).cuda() for a in ops)
    if not aligned:
        rows = misaligned(rows)
    before = pk.window2d.launches
    got = pk.window2d(rows, idx, out_rows=out_rows)
    assert pk.window2d.launches == before + 1
    want = pk.window2d_reference(rows, idx, out_rows)
    torch.cuda.synchronize()
    assert torch.equal(got, want), (shape, aligned)


@pytest.mark.cuda
def test_noop_launches_on_card():
    """The launch floor's empty kernel builds and runs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    pk.noop()
    torch.cuda.synchronize()
