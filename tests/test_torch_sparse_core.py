"""The port's fused sparse core against the JAX package's Pallas kernel.

``sparse_core_reference`` (the plain PyTorch version) is held against
``scalecube_cluster_tpu.ops.pallas_sparse.sparse_core_pallas`` with the full
fold, run in Pallas interpret mode on the CPU as the JAX package's own tests
run it, on seeded random operands. All five outputs must be bit-equal
(tolerance: none). The wrapper's validation runs here. The tests marked
``cuda`` need a card and skip without one; jax is imported only by the
Pallas comparison, so on a machine with PyTorch alone the card tests run
as ``python -m pytest --noconftest -m cuda tests/test_torch_sparse_core.py``.
"""

import numpy as np
import pytest
import torch

from scalecube_cluster_tpu_torch.ops import cuda_build
from scalecube_cluster_tpu_torch.ops import sparse_core as sc
from scalecube_cluster_tpu_torch.testing import misaligned, random_operands, tile_edge_operands
from scalecube_cluster_tpu_torch.testing import one_cpu_thread

one_cpu_thread()

FOLD = frozenset({"countdown", "points", "wb_mask", "view_rows"})
CONSTS = dict(spread=6, susp_ticks=20, age_stale=120, sweep=14)
OUTPUTS = ("slab2", "age2", "susp2", "self_rumor", "aggr")


@pytest.mark.parametrize("s,seed", [(128, 0), (128, 1), (512, 2)])
def test_reference_matches_pallas_interpret(s, seed):
    """Randomized operands at n=256 (every point / collision / dead-row /
    own-column / inactive-lane case): reference == Pallas, bit for bit."""
    jnp = pytest.importorskip("jax.numpy")
    from scalecube_cluster_tpu.ops.pallas_sparse import sparse_core_pallas

    ops = random_operands(256, s, 3, seed=seed)
    want = sparse_core_pallas(
        *(jnp.asarray(v) for v in ops.values()), fold=FOLD, interpret=True, **CONSTS
    )
    got = sc.sparse_core(*(torch.from_numpy(v) for v in ops.values()), **CONSTS)
    for name, a, b in zip(OUTPUTS, want, got):
        a = np.asarray(a)
        assert a.dtype == b.numpy().dtype, name
        assert np.array_equal(a, b.numpy()), name


def test_cpu_wrapper_runs_the_reference_without_counting():
    """On CPU tensors the wrapper is the plain version and launches nothing."""
    ops = {k: torch.from_numpy(v) for k, v in random_operands(64, 96, 2, seed=5).items()}
    before = sc.sparse_core.launches
    got = sc.sparse_core(*ops.values(), **CONSTS)
    want = sc.sparse_core_reference(*ops.values(), **CONSTS)
    assert sc.sparse_core.launches == before
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize(
    "field,bad",
    [
        ("slab", lambda t: t.to(torch.int64)),
        ("age", lambda t: t.to(torch.int16)),
        ("susp", lambda t: t[:, :-1]),
        ("edge_ok", lambda t: t.to(torch.int8)),
        ("slab", lambda t: t.t().contiguous().t()),
        ("ginv", lambda t: t[:, :-1]),
    ],
    ids=["slab-dtype", "age-dtype", "susp-shape", "edge-dtype", "slab-strides", "ginv-shape"],
)
def test_wrapper_rejects_malformed_operands(field, bad):
    """Wrong dtype, shape or contiguity raises before any work."""
    ops = {k: torch.from_numpy(v) for k, v in random_operands(64, 96, 3, seed=1).items()}
    ops[field] = bad(ops[field])
    with pytest.raises(ValueError):
        sc.sparse_core(*ops.values(), **CONSTS)


def test_wrapper_rejects_unsupported_geometry():
    """n % 32 != 0, S >= 4096 and more than MAX_FANOUT channels are refused
    (the fan-out block, the 12-bit slot lanes and the kernel's per-CTA
    channel tables)."""
    ops = {k: torch.from_numpy(v) for k, v in random_operands(64, 64, 3).items()}
    cut = {k: (v[:48] if v.dim() and v.shape[0] == 64 else v) for k, v in ops.items()}
    cut["edge_ok"] = ops["edge_ok"][:, :48].contiguous()
    with pytest.raises(ValueError, match="multiple of 32"):
        sc.sparse_core(*cut.values(), **CONSTS)
    wide = {k: torch.from_numpy(v) for k, v in random_operands(32, 4096, 3).items()}
    with pytest.raises(ValueError, match="4096"):
        sc.sparse_core(*wide.values(), **CONSTS)
    f = sc.MAX_FANOUT + 1
    many = {k: torch.from_numpy(v) for k, v in random_operands(64, 64, f).items()}
    with pytest.raises(ValueError, match="fanout"):
        sc.sparse_core(*many.values(), **CONSTS)


@pytest.mark.parametrize(
    "n,s,refused",
    [(32768, 512, False), (524256, 4096, False), (524288, 4096, True)],
    ids=["main-path", "last-n-below-2**31", "n*S-at-2**31"],
)
def test_offset_limit(n, s, refused):
    """The kernel's offsets are 32-bit: n*S >= 2**31 raises, the largest n
    below it (a multiple of 32) does not."""
    if refused:
        with pytest.raises(ValueError, match="32-bit"):
            sc.check_offsets(n, s)
    else:
        sc.check_offsets(n, s)


def test_tile_edge_operands_reach_the_edges():
    """The tile-edge operands put point lanes on both sides of each lane
    tile boundary and leave the second tile without an active lane."""
    ops = tile_edge_operands(1024, 260, seed=1)
    assert sc.TILE_LANES == 128
    for name in ("fd_slot", "sy_slot"):
        assert {0, 127, 128, 255, 256, 259} <= set(ops[name].tolist())
    assert (ops["slot_subj"][128:256] < 0).all() and (ops["slot_subj"] >= 0).any()


@pytest.mark.cuda
@pytest.mark.parametrize(
    "n,s,edges,misalign",
    [(1024, 256, False, False), (1024, 100, True, False), (1024, 260, True, False),
     (1024, 101, True, False), (512, 128, False, True)],
    ids=["S256", "S100-edges", "S260-edges", "S101-unaligned-rows", "S128-misaligned"],
)
def test_cuda_kernel_matches_reference_on_card(n, s, edges, misalign):
    """On the card: the CUDA kernel equals the plain version bit for bit and
    counts exactly one launch; at S = 100 and 260 with point lanes beside
    every tile boundary and one tile with no active lane, at S = 101 (rows
    off 16-byte alignment) and with misaligned planes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    draw = tile_edge_operands if edges else random_operands
    ops = {k: torch.from_numpy(v).cuda() for k, v in draw(n, s, 3, seed=4).items()}
    if misalign:
        for k in ("slab", "age", "susp"):
            ops[k] = misaligned(ops[k])
    before = sc.sparse_core.launches
    got = sc.sparse_core(*ops.values(), **CONSTS)
    want = sc.sparse_core_reference(*ops.values(), **CONSTS)
    torch.cuda.synchronize()
    assert sc.sparse_core.launches == before + 1
    for name, a, b in zip(OUTPUTS, got, want):
        assert torch.equal(a, b), name


@pytest.mark.cuda
def test_cuda_wrapper_raises_when_kernel_is_absent(monkeypatch):
    """A CUDA tensor never falls back to the plain version: with no nvcc and
    no built library the wrapper raises and counts nothing."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    monkeypatch.setattr(sc.LIBRARY, "_lib", None)
    monkeypatch.setattr(cuda_build, "nvcc_path", lambda: None)
    ops = {k: torch.from_numpy(v).cuda() for k, v in random_operands(64, 128, 3).items()}
    before = sc.sparse_core.launches
    with pytest.raises(RuntimeError, match="nvcc"):
        sc.sparse_core(*ops.values(), **CONSTS)
    assert sc.sparse_core.launches == before
