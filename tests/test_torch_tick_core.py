"""The port's fused dense tick core against the JAX package's Pallas kernel.

``tick_core_reference`` (the plain PyTorch version, which the wrapper runs
on CPU tensors) is held against
``scalecube_cluster_tpu.ops.pallas_tick.tick_core_pallas`` run in Pallas
interpret mode on the CPU, as the JAX package's own tests run it, on seeded
operands at n=128 and n=256 with FD verdicts, dead receivers, and ages and
countdowns at saturation. All six outputs must be bit-equal (tolerance:
none). The tests marked ``cuda`` need a card and skip without one; on a
machine with PyTorch alone they run as
``python -m pytest --noconftest -m cuda tests/test_torch_tick_core.py``.
"""

import numpy as np
import pytest
import torch

from scalecube_cluster_tpu_torch.ops import cuda_build
from scalecube_cluster_tpu_torch.ops import tick_core as tc
from scalecube_cluster_tpu_torch.testing import (
    misaligned,
    random_tick_operands,
    tile_edge_tick_operands,
)
from scalecube_cluster_tpu_torch.testing import one_cpu_thread

one_cpu_thread()

CONSTS = dict(spread=6, sweep=14, susp_ticks=20, age_stale=120)
OUTPUTS = ("view2", "age2", "susp2", "rows_next", "self_rumor", "known_cnt")


def _torch_ops(ops, device="cpu"):
    return {k: torch.from_numpy(v).to(device) for k, v in ops.items()}


@pytest.mark.parametrize("n,seed", [(128, 0), (128, 1), (256, 2), (256, 3)])
def test_reference_matches_pallas_interpret(n, seed):
    """Seeded operands (every status and epoch case, FD cells on and off
    the diagonal, dead rows, lost edges, saturated ages and countdowns):
    the port's core == the Pallas kernel, bit for bit."""
    jnp = pytest.importorskip("jax.numpy")
    from scalecube_cluster_tpu.ops.pallas_tick import tick_core_pallas

    ops = random_tick_operands(n, 3, seed=seed, susp_ticks=CONSTS["susp_ticks"])
    want = tick_core_pallas(
        *(jnp.asarray(v) for v in ops.values()), interpret=True, **CONSTS
    )
    got = tc.tick_core(*_torch_ops(ops).values(), **CONSTS)
    for name, a, b in zip(OUTPUTS, want, got):
        a = np.asarray(a)
        assert a.dtype == b.numpy().dtype, name
        assert np.array_equal(a, b.numpy()), name
    # The operands reach the saturating and expiring branches.
    assert (ops["age"] == 120).any() and (ops["susp"] == 1).any()
    assert (ops["fd_tgt"] >= 0).any() and not ops["alive"].all()


def test_cpu_wrapper_runs_the_reference_without_counting():
    """On CPU tensors the wrapper is the plain version and launches nothing."""
    ops = _torch_ops(random_tick_operands(64, 2, seed=5))
    before = tc.tick_core.launches
    got = tc.tick_core(*ops.values(), **CONSTS)
    want = tc.tick_core_reference(*ops.values(), **CONSTS)
    assert tc.tick_core.launches == before
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize(
    "field,bad",
    [
        ("rows", lambda t: t.to(torch.int64)),
        ("age", lambda t: t.to(torch.int16)),
        ("susp", lambda t: t[:, :-1]),
        ("edge_ok", lambda t: t.to(torch.int8)),
        ("view0", lambda t: t.t().contiguous().t()),
        ("rots", lambda t: t[:, :-1]),
        ("fd_tgt", lambda t: t.to(torch.int64)),
    ],
    ids=["rows-dtype", "age-dtype", "susp-shape", "edge-dtype", "view-strides",
         "rots-shape", "fd-dtype"],
)
def test_wrapper_rejects_malformed_operands(field, bad):
    """Wrong dtype, shape or contiguity raises before any work."""
    ops = _torch_ops(random_tick_operands(64, 3, seed=1))
    ops[field] = bad(ops[field])
    with pytest.raises(ValueError):
        tc.tick_core(*ops.values(), **CONSTS)


def test_wrapper_rejects_unsupported_geometry():
    """n % 8 != 0 and more than MAX_FANOUT channels are refused (the 8-row
    fan-out groups and the kernel's per-CTA channel tables)."""
    ops = _torch_ops(random_tick_operands(64, 3))
    cut = {k: v for k, v in ops.items()}
    for k in ("rows", "view0", "age", "susp"):
        cut[k] = ops[k][:60, :60].contiguous()
    for k in ("alive", "fd_tgt", "fd_key"):
        cut[k] = ops[k][:60].contiguous()
    cut["edge_ok"] = ops["edge_ok"][:, :60].contiguous()
    with pytest.raises(ValueError, match="multiple of 8"):
        tc.tick_core(*cut.values(), **CONSTS)
    many = _torch_ops(random_tick_operands(64, tc.MAX_FANOUT + 1))
    with pytest.raises(ValueError, match="fanout"):
        tc.tick_core(*many.values(), **CONSTS)


@pytest.mark.parametrize(
    "n,refused",
    [(10240, False), (46336, False), (46344, True)],
    ids=["main-path", "last-n-below-2**31", "n*n-past-2**31"],
)
def test_offset_limit(n, refused):
    """The kernel's offsets are 32-bit: n*n >= 2**31 raises, the largest n
    below it (a multiple of 8) does not."""
    if refused:
        with pytest.raises(ValueError, match="32-bit"):
            tc.check_offsets(n)
    else:
        tc.check_offsets(n)


def test_tile_edge_operands_put_fd_targets_on_tile_boundaries():
    """The tile-edge operands' FD targets sit on both sides of each tile
    boundary, for the card tests and chip_smoke.py."""
    ops = tile_edge_tick_operands(1032, seed=1)
    assert {0, 255, 256, 511, 512, 767, 768, 1023, 1024, 1031} <= set(ops["fd_tgt"].tolist())


@pytest.mark.cuda
@pytest.mark.parametrize(
    "n,f,edges,misalign",
    [(256, 3, False, False), (1024, 3, False, False), (512, 4, False, False),
     (264, 3, True, False), (1032, 3, True, False), (264, 2, True, True)],
    ids=["256-3", "1024-3", "512-4", "264-3-edges", "1032-3-edges", "264-2-misaligned"],
)
def test_cuda_kernel_matches_reference_on_card(n, f, edges, misalign):
    """On the card: the CUDA kernel equals the plain version bit for bit and
    counts exactly one launch; at n = 264 and 1032 with FD targets beside
    every tile boundary (the diagonal crosses every tile), and with planes
    off 16-byte alignment."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    draw = tile_edge_tick_operands if edges else random_tick_operands
    ops = _torch_ops(draw(n, f, seed=4), "cuda")
    if misalign:
        for k in ("rows", "view0", "age", "susp"):
            ops[k] = misaligned(ops[k])
    before = tc.tick_core.launches
    got = tc.tick_core(*ops.values(), **CONSTS)
    want = tc.tick_core_reference(*ops.values(), **CONSTS)
    torch.cuda.synchronize()
    assert tc.tick_core.launches == before + 1
    for name, a, b in zip(OUTPUTS, got, want):
        assert torch.equal(a, b), name


@pytest.mark.cuda
def test_cuda_wrapper_raises_when_kernel_is_absent(monkeypatch):
    """A CUDA tensor never falls back to the plain version: with no nvcc and
    no loaded library the wrapper raises and counts nothing."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    monkeypatch.setattr(tc.LIBRARY, "_lib", None)
    monkeypatch.setattr(cuda_build, "nvcc_path", lambda: None)
    ops = _torch_ops(random_tick_operands(64, 3), "cuda")
    before = tc.tick_core.launches
    with pytest.raises(RuntimeError, match="nvcc"):
        tc.tick_core(*ops.values(), **CONSTS)
    assert tc.tick_core.launches == before
