"""The card probes' plain versions against the ``expect`` expressions of
the JAX package's ``tools/probe_mosaic.py``, on the same seeded numpy
operands (tolerance: none). The wrappers run the plain version on CPU
tensors and launch nothing. The test marked ``cuda`` needs a card and
skips without one; on a machine with PyTorch alone run it as ``python -m
pytest --noconftest -m cuda tests/test_torch_probes.py``.
"""

import numpy as np
import pytest
import torch

from scalecube_cluster_tpu_torch.tools import probe_kernels as pk


def _expect(name, ops):
    """Each probe's ``expect`` expression, as probe_mosaic.py writes it."""
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
            [jnp.tile(rows[g * 8: g * 8 + 8, j * mc: (j + 1) * mc], (4, 1))
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
