"""The port's fused delivery + merge against the JAX package's.

``delivery_merge_reference`` (the plain PyTorch version, reached through
the wrapper on CPU tensors) is held against
``scalecube_cluster_tpu.ops.pallas_tick.delivery_merge_pallas``: at n=128
through the Pallas kernel in interpret mode, at n=96 (not a multiple of
128) through the reference's own XLA fallback. Inputs come from numpy
seeds (``testing.random_tick_operands``: keys of every status over a few
epochs, UNKNOWN cells, dead receivers, lost edges). Both outputs must be
bit-equal (tolerance: none). The test marked ``cuda`` needs a card and
skips without one; on a machine with PyTorch alone run it as ``python -m
pytest --noconftest -m cuda tests/test_torch_delivery_merge.py``.
"""

import numpy as np
import pytest
import torch

from scalecube_cluster_tpu_torch.ops import delivery_merge as dm
from scalecube_cluster_tpu_torch.testing import random_tick_operands

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
