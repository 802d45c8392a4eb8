"""The port's fused delivery + merge against the JAX package's.

``delivery_merge_reference`` (the plain PyTorch version, reached through
the wrapper on CPU tensors) is held against
``scalecube_cluster_tpu.ops.pallas_tick.delivery_merge_pallas``: at n=128
through the Pallas kernel in interpret mode, at n=96 (not a multiple of
128) through the reference's own XLA fallback. Inputs come from numpy
seeds (``testing.random_tick_operands``: keys of every status over a few
epochs, UNKNOWN cells, dead receivers, lost edges). Both outputs must be
bit-equal (tolerance: none). The tests marked ``cuda`` need a card and
skip without one; on a machine with PyTorch alone run them as ``python -m
pytest --noconftest -m cuda tests/test_torch_delivery_merge.py``.
"""

import numpy as np
import pytest
import torch

from scalecube_cluster_tpu_torch.ops import delivery_merge as dm
from scalecube_cluster_tpu_torch.testing import (
    misaligned,
    random_tick_operands,
    tile_edge_merge_operands,
)
from scalecube_cluster_tpu_torch.testing import one_cpu_thread

one_cpu_thread()

FIELDS = ("rows", "view0", "ginv", "rots", "edge_ok", "alive")


def merge_operands(n, seed, f=3):
    """The delivery-merge operands of a seeded tick operand set: the young
    payload, the receiver tables, the fan-out, the edge bits, liveness."""
    ops = random_tick_operands(n, f, seed=seed)
    return [ops[k] for k in FIELDS]


@pytest.mark.parametrize("n,seed", [(128, 0), (128, 1), (96, 2)], ids=["128-0", "128-1", "96"])
def test_reference_matches_jax(n, seed):
    """n=128 runs the Pallas kernel (interpret mode), n=96 the reference's
    XLA fallback: merged table and self-rumor equal, bit for bit."""
    import jax.numpy as jnp

    from scalecube_cluster_tpu.ops.pallas_tick import delivery_merge_pallas

    ops = merge_operands(n, seed)
    want = delivery_merge_pallas(*(jnp.asarray(v) for v in ops), interpret=True)
    before = dm.delivery_merge.launches
    got = dm.delivery_merge(*(torch.from_numpy(v) for v in ops))
    assert dm.delivery_merge.launches == before
    for name, a, b in zip(("merged", "self_rumor"), want, got):
        a = np.asarray(a)
        assert a.dtype == b.numpy().dtype, name
        assert np.array_equal(a, b.numpy()), name
    # The self-rumor is the raw diagonal, taken before exclusion: some
    # receivers did hear a rumor about themselves.
    assert (got[1] >= 0).any()


@pytest.mark.parametrize("f", [2, dm.MAX_FANOUT])
def test_reference_matches_jax_at_other_fanouts(f):
    """The fan-outs of the kernel's general channel loop, 2 and the largest
    it takes, 8, at n=128 through the Pallas kernel (interpret mode): both
    outputs bit-equal."""
    import jax.numpy as jnp

    from scalecube_cluster_tpu.ops.pallas_tick import delivery_merge_pallas

    ops = merge_operands(128, 10 + f, f=f)
    want = delivery_merge_pallas(*(jnp.asarray(v) for v in ops), interpret=True)
    got = dm.delivery_merge(*(torch.from_numpy(v) for v in ops))
    for name, a, b in zip(("merged", "self_rumor"), want, got):
        assert np.array_equal(np.asarray(a), b.numpy()), (f, name)


def test_wrapper_rejects_malformed_operands():
    """Wrong dtype, shape, contiguity, n % 8 or fan-out raises."""
    ops = [torch.from_numpy(v) for v in merge_operands(64, 3)]
    bad = [
        (0, ops[0].to(torch.int64)),
        (1, ops[1][:, :-8].contiguous()),
        (4, ops[4].to(torch.int8)),
        (1, ops[1].t()),
    ]
    for i, t in bad:
        args = list(ops)
        args[i] = t
        with pytest.raises(ValueError):
            dm.delivery_merge(*args)
    cut = [torch.from_numpy(v) for v in merge_operands(64, 3)]
    cut[0], cut[1] = cut[0][:60, :60].contiguous(), cut[1][:60, :60].contiguous()
    with pytest.raises(ValueError, match="multiple of 8"):
        dm.delivery_merge(*cut)
    many = [torch.from_numpy(v) for v in merge_operands(64, 3, f=dm.MAX_FANOUT + 1)]
    with pytest.raises(ValueError, match="fanout"):
        dm.delivery_merge(*many)


def test_profile_tick_runs_every_piece_on_cpu():
    """The profile tool's path at a small size, on the CPU the caller asks
    for: every piece of the JAX tool, under its name; the delivery-merge
    piece goes through the wrapper (which launches nothing on the CPU)."""
    from scalecube_cluster_tpu_torch.tools import profile_tick

    before = dm.delivery_merge.launches
    out = profile_tick.main(64, iters=2, calls=1, device="cpu")
    assert list(out) == [
        "full tick (pallas=True)", "full tick (pallas=False)",
        "pre-mask: fd where + age0 + rows", "pallas delivery+merge kernel",
        "XLA delivery+merge", "post-chain (approx)",
        "fd selection (choice+topk) [per fd tick]", "elementwise copy-add",
    ]
    assert all(ms >= 0.0 for ms in out.values())
    assert dm.delivery_merge.launches == before


@pytest.mark.cuda
def test_cuda_kernel_matches_reference_on_card():
    """On the card: the kernel equals the plain version bit for bit at
    n=256 and at n=96 (no lane rule), one launch each."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for n, seed in ((256, 4), (96, 5)):
        ops = [torch.from_numpy(v).cuda() for v in merge_operands(n, seed)]
        before = dm.delivery_merge.launches
        got = dm.delivery_merge(*ops)
        want = dm.delivery_merge_reference(*ops)
        torch.cuda.synchronize()
        assert dm.delivery_merge.launches == before + 1
        for name, a, b in zip(("merged", "self_rumor"), got, want):
            assert torch.equal(a, b), (n, name)


def test_tile_edge_operands_put_fresh_records_on_tile_boundaries():
    """The tile-edge operands change merges on both sides of each column
    tile boundary: at every such column some live receiver takes the
    injected newer-epoch record; the diagonal crosses both tiles."""
    ops = tile_edge_merge_operands(264, seed=1)
    assert dm.TILE_COLS == 256
    merged, _ = dm.delivery_merge(*(torch.from_numpy(ops[k]) for k in FIELDS))
    view0 = torch.from_numpy(ops["view0"])
    for j in (0, 255, 256, 263):
        took = (merged[:, j] >> 22 == 3) & (view0[:, j] >> 22 != 3)
        assert took.any(), j


def test_reference_matches_jax_at_tile_edges():
    """n=264 on the tile-edge operands, through the reference's XLA
    fallback (264 is not a multiple of 128): both outputs bit-equal."""
    import jax.numpy as jnp

    from scalecube_cluster_tpu.ops.pallas_tick import delivery_merge_pallas

    ops = tile_edge_merge_operands(264, seed=2)
    want = delivery_merge_pallas(*(jnp.asarray(ops[k]) for k in FIELDS), interpret=True)
    got = dm.delivery_merge(*(torch.from_numpy(ops[k]) for k in FIELDS))
    for name, a, b in zip(("merged", "self_rumor"), want, got):
        assert np.array_equal(np.asarray(a), b.numpy()), name


@pytest.mark.parametrize(
    "n,refused",
    [(10240, False), (46336, False), (46344, True)],
    ids=["main-path", "last-n-below-2**31", "n*n-past-2**31"],
)
def test_offset_limit(n, refused):
    """The kernel's offsets are 32-bit: n*n >= 2**31 raises before any
    work; the largest n below it (a multiple of 8) passes every check and
    is refused only for its (memoryless) device."""
    meta = dict(device="meta")
    ops = [
        torch.empty((n, n), dtype=torch.int32, **meta),
        torch.empty((n, n), dtype=torch.int32, **meta),
        torch.empty((3, n // 8), dtype=torch.int32, **meta),
        torch.empty((3, n // 8), dtype=torch.int32, **meta),
        torch.empty((3, n), dtype=torch.bool, **meta),
        torch.empty((n,), dtype=torch.bool, **meta),
    ]
    with pytest.raises(ValueError, match="32-bit" if refused else "unsupported device"):
        dm.delivery_merge(*ops)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "n,f,misalign",
    [(264, 3, False), (1032, 3, False), (264, 2, True), (264, 2, False),
     (1032, dm.MAX_FANOUT, False)],
    ids=["264-3-edges", "1032-3-edges", "264-2-edges-misaligned", "264-2-edges",
         "1032-8-edges"],
)
def test_cuda_kernel_matches_reference_at_tile_edges(n, f, misalign):
    """On the card: the kernel equals the plain version bit for bit at n =
    264 and 1032 (a partial last tile, fresh records beside every tile
    boundary, the diagonal crossing every tile), with rows and local off
    16-byte alignment, and at the fan-outs of the general channel loop, 2
    and the largest, 8; one launch each."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    ops = tile_edge_merge_operands(n, f, seed=6)
    args = [torch.from_numpy(ops[k]).cuda() for k in FIELDS]
    if misalign:
        args[0], args[1] = misaligned(args[0]), misaligned(args[1])
    before = dm.delivery_merge.launches
    got = dm.delivery_merge(*args)
    want = dm.delivery_merge_reference(*args)
    torch.cuda.synchronize()
    assert dm.delivery_merge.launches == before + 1
    for name, a, b in zip(("merged", "self_rumor"), got, want):
        assert torch.equal(a, b), (n, name)
