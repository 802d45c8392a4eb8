"""The port's ``prng`` module against ``jax.random`` (threefry2x32,
``jax_threefry_partitionable=True``, x64 off).

Every test draws the same keys through jax and through the port on the CPU
and requires bit equality: keys as ``uint32`` words, integer draws as
values, float32 draws as their bit patterns. Tolerance: none (exact).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scalecube_cluster_tpu_torch import prng
from scalecube_cluster_tpu_torch.testing import one_cpu_thread

one_cpu_thread()

SEEDS = (0, 1, 7, 12345, 2**31 - 1)
#: Shapes the engine draws, plus sizes that are not powers of 2.
SHAPES = ((1,), (7,), (1000,), (1024,), (33, 3), (8, 100), (3, 32))
#: The fixed raw key of the probe cursor (ops/select.py).
RAW_CURSOR_KEY = np.array([0, 0x5CA1EC], dtype=np.uint32)


def _keys():
    """Seeded keys plus split / fold_in descendants and the raw cursor key."""
    out = [np.asarray(jax.random.PRNGKey(s)) for s in SEEDS]
    out.append(RAW_CURSOR_KEY)
    rng = np.random.default_rng(0)
    out += [rng.integers(0, 2**32, 2, dtype=np.uint64).astype(np.uint32) for _ in range(4)]
    return out


def test_prngkey_split_and_fold_in_match_jax():
    """PRNGKey, split (2, 3, 8 ways) and fold_in reproduce jax's key words."""
    for s in SEEDS:
        assert np.array_equal(np.asarray(jax.random.PRNGKey(s)), prng.PRNGKey(s))
    for key in _keys():
        jk = jnp.asarray(key)
        for num in (2, 3, 6, 8):
            assert np.array_equal(
                np.asarray(jax.random.split(jk, num)), prng.split(key, num)
            ), (key, num)
        for data in (0, 1, 5, 1000, 2**31 + 3):
            want = np.asarray(jax.random.fold_in(jk, np.uint32(data)))
            assert np.array_equal(want, prng.fold_in(key, data)), (key, data)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_bits_and_uniform_match_jax(shape):
    """32-bit draws and float32 uniforms are bit-identical."""
    for key in _keys():
        jk = jnp.asarray(key)
        want_bits = np.asarray(jax.random.bits(jk, shape)).astype(np.int64)
        assert np.array_equal(want_bits, prng.random_bits(key, shape, "cpu").numpy())
        want = np.asarray(jax.random.uniform(jk, shape))
        got = prng.uniform(key, shape, "cpu").numpy()
        assert got.dtype == np.float32
        assert np.array_equal(want.view(np.int32), got.view(np.int32))


@pytest.mark.parametrize(
    "lo,hi", [(0, 7), (0, 32), (1, 2048), (0, 1000), (0, 32768), (5, 3), (0, 2**31 - 1)]
)
def test_randint_matches_jax(lo, hi):
    """int32 randint (two draws reduced over the span in wrapping uint32),
    including an empty span and the full int32 span."""
    for key in _keys():
        jk = jnp.asarray(key)
        for shape in ((1,), (1000,), (8, 33), (3, 32)):
            want = np.asarray(jax.random.randint(jk, shape, lo, hi, jnp.int32))
            got = prng.randint(key, shape, lo, hi, "cpu")
            assert got.dtype == torch.int32
            assert np.array_equal(want, got.numpy()), (key, shape, lo, hi)


@pytest.mark.parametrize("n", [1, 2, 5, 32, 100, 1000, 1024, 1626, 2000, 4096])
def test_permutation_matches_jax(n):
    """Sort-based shuffles (1 round below n=1626, 2 from there) with stable
    ties, for n that is and is not a power of 2."""
    for key in _keys():
        want = np.asarray(jax.random.permutation(jnp.asarray(key), n))
        got = prng.permutation(key, n, "cpu")
        assert np.array_equal(want, got.numpy()), (key, n)


def _xla_gumbel_of_mantissa():
    """jax's "low"-mode Gumbel transform, ``-log(-log(max(tiny, m·2⁻²³)))``,
    evaluated by XLA on every one of the 2²³ mantissas ``m``."""
    tiny = np.finfo(np.float32).tiny
    m = np.arange(1 << 23, dtype=np.uint32)
    fbits = (m | np.uint32(0x3F800000)).view(np.float32)

    @jax.jit
    def transform(fb):
        floats = fb - jnp.float32(1.0)
        lo, hi = jnp.float32(tiny), jnp.float32(1.0)
        return -jnp.log(-jnp.log(jnp.maximum(lo, floats * (hi - lo) + lo)))

    return np.asarray(transform(jnp.asarray(fbits)))


def test_gumbel_order_ranks_as_jax_gumbel():
    """The port ranks Gumbel draws by their mantissa bits. That is jax's
    ranking exactly: XLA's map from mantissa to Gumbel value is strictly
    increasing over all 2²³ mantissas (checked here, exhaustively), every
    jax.random.gumbel value is that map at its draw's mantissa, and the
    port's mantissas are jax's bits."""
    table = _xla_gumbel_of_mantissa()
    assert np.all(np.diff(table) > 0)
    for key in _keys()[:4]:
        jk = jnp.asarray(key)
        shape = (64, 300)
        mant = (np.asarray(jax.random.bits(jk, shape)) >> 9).astype(np.int64)
        got = prng.gumbel_order(key, shape, "cpu").numpy()
        assert np.array_equal(got, mant)
        want = np.asarray(jax.random.gumbel(jk, shape, jnp.float32))
        assert np.array_equal(want.view(np.int32), table[mant].view(np.int32))
        assert np.array_equal(np.argsort(got, axis=None, kind="stable"),
                              np.argsort(want, axis=None, kind="stable"))
