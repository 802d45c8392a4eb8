"""The port's persistent k-tick sparse core against the JAX package's.

``sparse_core_persistent_reference`` (the plain PyTorch version, reached
through the wrapper on CPU tensors) is held against
``scalecube_cluster_tpu.ops.pallas_sparse.run_sparse_core_persistent`` in
Pallas interpret mode on the CPU, as the JAX package's own tests run it,
on the seeded operands of its tests (numpy ``default_rng``). All five
outputs must be bit-equal (tolerance: none). The JAX side keeps k traced,
so each fold builds one executable that serves every k. The tests marked
``cuda`` need a card and skip without one; on a machine with PyTorch
alone run them as ``python -m pytest --noconftest -m cuda
tests/test_torch_sparse_persistent.py``.
"""

import numpy as np
import pytest
import torch

from scalecube_cluster_tpu_torch.ops import sparse_persistent as sp
from scalecube_cluster_tpu_torch.testing import (
    misaligned,
    persistent_operands,
    tile_edge_persistent_operands,
)
from scalecube_cluster_tpu_torch.testing import one_cpu_thread

one_cpu_thread()

KW = dict(spread=6, susp_ticks=20, age_stale=120, sweep=6)
OUTPUTS = ("slab", "age", "susp", "self_rumor", "aggr")
FOLDS = {
    "countdown": frozenset({"countdown"}),
    "wb_mask": frozenset({"countdown", "wb_mask"}),
    "view_rows": frozenset({"countdown", "wb_mask", "view_rows"}),
}


@pytest.mark.parametrize("fold", list(FOLDS), ids=list(FOLDS))
def test_reference_matches_pallas_interpret(fold):
    """n=128, S=256, f=3, k_max=5, k in {1, 2, 3, 5}: the plain persistent
    core equals the Pallas kernel on all five outputs, bit for bit."""
    import jax.numpy as jnp

    from scalecube_cluster_tpu.ops.pallas_sparse import run_sparse_core_persistent

    k_max = 5
    ops = persistent_operands(128, 256, k_max=k_max)
    jargs = [jnp.asarray(v) for v in ops.values()]
    targs = [torch.from_numpy(v) for v in ops.values()]
    before = sp.sparse_core_persistent.launches
    for k in (1, 2, 3, 5):
        want = run_sparse_core_persistent(
            *jargs, jnp.int32(k), k_max=k_max, fold=FOLDS[fold], interpret=True, **KW
        )
        got = sp.run_sparse_core_persistent(*targs, k, k_max=k_max, fold=FOLDS[fold], **KW)
        for name, a, b in zip(OUTPUTS, want, got):
            a = np.asarray(a)
            assert a.dtype == b.numpy().dtype, (k, name)
            assert np.array_equal(a, b.numpy()), (k, name)
    # CPU tensors run the plain version: nothing is launched.
    assert sp.sparse_core_persistent.launches == before


def test_pack_flags_matches_jax():
    """The kernel reads the edge bits and liveness as they are, where the
    JAX kernel packs them into one word a row per tick (``pack_flags``:
    channel c in bit c, liveness in bit ALIVE_BIT). At f = 5 and at f = 7,
    the widest that word holds, over a leading tick axis (k = 2 and k_max):
    the plain persistent core equals the Pallas kernel on all five outputs,
    bit for bit."""
    import jax.numpy as jnp

    from scalecube_cluster_tpu.ops.pallas_sparse import run_sparse_core_persistent

    k_max = 4
    for f in (5, sp.ALIVE_BIT):
        ops = persistent_operands(64, 256, f=f, k_max=k_max, seed=f)
        jargs = [jnp.asarray(v) for v in ops.values()]
        targs = [torch.from_numpy(v) for v in ops.values()]
        for k in (2, k_max):
            want = run_sparse_core_persistent(
                *jargs, jnp.int32(k), k_max=k_max, fold=FOLDS["view_rows"], interpret=True, **KW
            )
            got = sp.run_sparse_core_persistent(
                *targs, k, k_max=k_max, fold=FOLDS["view_rows"], **KW
            )
            for name, a, b in zip(OUTPUTS, want, got):
                assert np.array_equal(np.asarray(a), b.numpy()), (f, k, name)


def test_cold_packing_matches_jax_exhaustively():
    """pack_cold / unpack_cold equal the JAX versions over every age 0..120
    and every countdown 0..COLD_SUSP_MAX, and round-trip exactly."""
    import jax.numpy as jnp

    from scalecube_cluster_tpu.ops import pallas_sparse as J

    assert sp.COLD_SUSP_MAX == J.COLD_SUSP_MAX
    age, susp = np.meshgrid(
        np.arange(121, dtype=np.int8), np.arange(sp.COLD_SUSP_MAX + 1, dtype=np.int16),
        indexing="ij",
    )
    want = np.asarray(J.pack_cold(jnp.asarray(age), jnp.asarray(susp)))
    got = sp.pack_cold(torch.from_numpy(age), torch.from_numpy(susp)).numpy()
    assert want.dtype == got.dtype and np.array_equal(want, got)
    ja, js = J.unpack_cold(jnp.asarray(want))
    ta, ts = sp.unpack_cold(torch.from_numpy(got))
    for a, b, orig in ((ja, ta, age), (js, ts, susp)):
        a = np.asarray(a)
        assert a.dtype == b.numpy().dtype
        assert np.array_equal(a, b.numpy()) and np.array_equal(b.numpy(), orig)


def test_cold_lane_matches_jax_bit_for_bit_outside_the_range():
    """Outside the packable range too (countdowns up to 400, negative int8
    ages, every int16 lane value), packing and unpacking keep the
    reference's bits."""
    import jax.numpy as jnp

    from scalecube_cluster_tpu.ops import pallas_sparse as J

    age, susp = np.meshgrid(np.arange(-128, 128, dtype=np.int8),
                            np.arange(0, 401, dtype=np.int16), indexing="ij")
    want = np.asarray(J.pack_cold(jnp.asarray(age), jnp.asarray(susp)))
    got = sp.pack_cold(torch.from_numpy(age), torch.from_numpy(susp)).numpy()
    assert np.array_equal(want, got)
    lanes = np.arange(-(1 << 15), 1 << 15, dtype=np.int32).astype(np.int16)
    for a, b in zip(J.unpack_cold(jnp.asarray(lanes)), sp.unpack_cold(torch.from_numpy(lanes))):
        a = np.asarray(a)
        assert a.dtype == b.numpy().dtype and np.array_equal(a, b.numpy())


def _refusal_cases():
    ops = {k: torch.from_numpy(v) for k, v in persistent_operands(64, 256, k_max=5).items()}
    base = dict(ops, k=2, susp_ticks=20, fold=frozenset({"countdown"}), k_max=5)
    cut_n = {k: (v[..., :48] if k == "edge_ok" else v[:48] if k in (
        "slab", "age", "susp", "alive") else v) for k, v in ops.items()}
    cut_n["ginv"] = ops["ginv"][..., :1].contiguous()
    cut_n["rots"] = ops["rots"][..., :1].contiguous()
    cut_s = {k: (v[:, :192].contiguous() if k in ("slab", "age", "susp") else v)
             for k, v in ops.items()}
    cut_s["slot_subj"] = ops["slot_subj"][:192].contiguous()
    wide = {k: torch.from_numpy(v)
            for k, v in persistent_operands(64, 256, f=sp.ALIVE_BIT + 1, k_max=5).items()}
    return {
        "fanout-above-alive-bit": (dict(base, **wide), "ALIVE_BIT"),
        "ginv-rank": (dict(base, ginv=ops["ginv"][0]), "k_max"),
        "ginv-depth": (dict(base, k_max=4), "k_max"),
        "n-mod-32": (dict(base, **cut_n), "multiple of 32"),
        "S-mod-128": (dict(base, **cut_s), "multiple of 128"),
        "unknown-fold": (dict(base, fold=frozenset({"countdown", "bogus"})), "unknown fold"),
        "no-countdown": (dict(base, fold=frozenset()), "countdown"),
        "points": (dict(base, fold=frozenset({"countdown", "points"})), "points"),
        "susp-ticks": (dict(base, susp_ticks=sp.COLD_SUSP_MAX + 1), "packed int16 cold lane"),
        "k-zero": (dict(base, k=0), "k=0"),
        "k-above": (dict(base, k=6), "k=6"),
    }


@pytest.mark.parametrize("case", list(_refusal_cases()))
def test_refusals_match_jax(case):
    """Every input the JAX function refuses raises ValueError in both, with
    the same key words (tests/test_sparse.py::
    test_persistent_kernel_validation_and_cold_packing and the
    reference's remaining checks)."""
    import jax.numpy as jnp

    from scalecube_cluster_tpu.ops.pallas_sparse import sparse_core_pallas_persistent

    kw, match = _refusal_cases()[case]
    kw = dict(kw)
    names = ("slab", "age", "susp", "slot_subj", "ginv", "rots", "edge_ok", "alive", "k")
    targs = [kw.pop(name) for name in names]
    consts = dict(spread=6, age_stale=120, sweep=6, **kw)
    jargs = [jnp.asarray(a.numpy()) if isinstance(a, torch.Tensor) else a for a in targs]
    with pytest.raises(ValueError, match=match):
        sparse_core_pallas_persistent(*jargs, interpret=True, **consts)
    with pytest.raises(ValueError, match=match):
        sp.sparse_core_persistent(*targs, **consts)


def test_wrapper_rejects_malformed_operands():
    """Wrong dtype or contiguity raises before any work."""
    ops = {k: torch.from_numpy(v) for k, v in persistent_operands(64, 128, k_max=5).items()}
    for field, bad in (("age", ops["age"].to(torch.int16)),
                       ("slab", ops["slab"].t().contiguous().t()),
                       ("edge_ok", ops["edge_ok"].to(torch.int8))):
        args = dict(ops, **{field: bad})
        with pytest.raises(ValueError):
            sp.sparse_core_persistent(*args.values(), 2, k_max=5, **KW)


def test_operands_and_rung_width_match_jax():
    """The seeded operand set is the JAX tests' (and k-sweep rung's) own,
    value for value, and the port's rung width rule is the JAX bench's."""
    import bench
    from tests.test_sparse import _persistent_inputs

    from scalecube_cluster_tpu_torch.bench import rung_slot_budget

    want = _persistent_inputs(n=128, s=256, k_max=5, seed=0)
    got = persistent_operands(128, 256, k_max=5, seed=0)
    assert list(want) == list(got)
    for name in want:
        a = np.asarray(want[name])
        assert a.dtype == got[name].dtype and np.array_equal(a, got[name]), name
    for n in (1024, 4096, 32768, 40960, 49152, 65536):
        assert rung_slot_budget(n) == bench._rung_slot_budget(n), n


@pytest.mark.cuda
def test_cuda_kernel_matches_reference_on_card():
    """On the card: one cooperative launch per call equals the plain
    version bit for bit at every k of one build, n=1024, S=256."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    ops = [torch.from_numpy(v).cuda() for v in persistent_operands(1024, 256, k_max=5).values()]
    fold = FOLDS["view_rows"]
    for k in (1, 2, 5):
        before = sp.sparse_core_persistent.launches
        got = sp.sparse_core_persistent(*ops, k, k_max=5, fold=fold, **KW)
        want = sp.sparse_core_persistent_reference(*ops, k, k_max=5, fold=fold, **KW)
        torch.cuda.synchronize()
        assert sp.sparse_core_persistent.launches == before + 1
        for name, a, b in zip(OUTPUTS, got, want):
            assert torch.equal(a, b), (k, name)
    assert sp.LIBRARY.loads == 1


def test_tile_edge_operands_reach_the_edges():
    """The tile-edge operands make the lanes beside each lane-tile boundary
    active on distinct subjects, leave the second tile idle, and put a
    quarter of the ages and countdowns outside the packable range."""
    ops = tile_edge_persistent_operands(1024, 384, k_max=3, seed=1)
    subj = ops["slot_subj"]
    assert sp.TILE_LANES == 128
    assert (subj[[0, 127, 256, 383]] >= 0).all()
    assert (subj[128:256] < 0).all()
    active = subj[subj >= 0]
    assert np.unique(active).size == active.size
    assert (ops["age"] < 0).mean() > 0.05
    assert ((ops["susp"] > sp.COLD_SUSP_MAX) | (ops["susp"] < 0)).mean() > 0.15


def test_reference_matches_pallas_interpret_at_tile_edges():
    """n=64, S=384, k_max=3, k in {1, 3} on the tile-edge operands (an idle
    middle tile, ages and countdowns outside the packable range): the plain
    persistent core equals the Pallas kernel on all five outputs."""
    import jax.numpy as jnp

    from scalecube_cluster_tpu.ops.pallas_sparse import run_sparse_core_persistent

    ops = tile_edge_persistent_operands(64, 384, k_max=3, seed=2)
    jargs = [jnp.asarray(v) for v in ops.values()]
    targs = [torch.from_numpy(v) for v in ops.values()]
    for k in (1, 3):
        want = run_sparse_core_persistent(
            *jargs, jnp.int32(k), k_max=3, fold=FOLDS["view_rows"], interpret=True, **KW
        )
        got = sp.run_sparse_core_persistent(*targs, k, k_max=3, fold=FOLDS["view_rows"], **KW)
        for name, a, b in zip(OUTPUTS, want, got):
            assert np.array_equal(np.asarray(a), b.numpy()), (k, name)


def _meta_operands(n, s, k_max=2, f=3):
    """Operands of the right dtypes and shapes that hold no memory."""
    meta = dict(device="meta")
    nb = n // 32
    return [
        torch.empty((n, s), dtype=torch.int32, **meta),
        torch.empty((n, s), dtype=torch.int8, **meta),
        torch.empty((n, s), dtype=torch.int16, **meta),
        torch.empty((s,), dtype=torch.int32, **meta),
        torch.empty((k_max, f, nb), dtype=torch.int32, **meta),
        torch.empty((k_max, f, nb), dtype=torch.int32, **meta),
        torch.empty((k_max, f, n), dtype=torch.bool, **meta),
        torch.empty((n,), dtype=torch.bool, **meta),
    ]


@pytest.mark.parametrize(
    "n,refused",
    [(32768, False), (4194272, False), (4194304, True)],
    ids=["main-path", "last-n-below-2**31", "n*S-past-2**31"],
)
def test_offset_limit(n, refused):
    """The kernel's offsets are 32-bit: at S=512, n*S >= 2**31 raises before
    any work; the largest n below it (a multiple of 32) passes every check
    and is refused only for its (memoryless) device."""
    match = "32-bit" if refused else "unsupported device"
    with pytest.raises(ValueError, match=match):
        sp.sparse_core_persistent(*_meta_operands(n, 512), 1, k_max=2, **KW)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "n,s,f,k_max",
    [(1024, 128, 3, 4), (1024, 384, 3, 4), (512, 256, 2, 3), (512, 256, sp.ALIVE_BIT, 3)],
    ids=["S128-edges", "S384-edges", "S256-edges-f2", "S256-edges-f7"],
)
def test_cuda_kernel_matches_reference_at_tile_edges(n, s, f, k_max):
    """On the card, at k = 1, 2 and k_max: the kernel equals the plain
    version bit for bit on the tile-edge operands (lanes beside every
    128-lane boundary active, an idle second tile, ages and countdowns
    outside the packable range that the first tick packs), at S = 128 and
    384, and with the fan-outs of the general channel loop, 2 and the
    largest, 7."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    ops = [torch.from_numpy(v).cuda()
           for v in tile_edge_persistent_operands(n, s, f, k_max=k_max, seed=5).values()]
    fold = FOLDS["view_rows"]
    for k in (1, 2, k_max):
        before = sp.sparse_core_persistent.launches
        got = sp.sparse_core_persistent(*ops, k, k_max=k_max, fold=fold, **KW)
        want = sp.sparse_core_persistent_reference(*ops, k, k_max=k_max, fold=fold, **KW)
        torch.cuda.synchronize()
        assert sp.sparse_core_persistent.launches == before + 1
        for name, a, b in zip(OUTPUTS, got, want):
            assert torch.equal(a, b), (k, name)


@pytest.mark.cuda
def test_cuda_wrapper_packs_nothing_itself(monkeypatch):
    """On the card the kernel packs the cold lane in its first tick and
    unpacks it in its last: the wrapper never calls pack_cold or
    unpack_cold, and the caller's planes are left as they were."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")

    def refuse(*_):
        raise AssertionError("the wrapper packed or unpacked the cold lane")

    monkeypatch.setattr(sp, "pack_cold", refuse)
    monkeypatch.setattr(sp, "unpack_cold", refuse)
    ops = [torch.from_numpy(v).cuda() for v in persistent_operands(256, 256, k_max=3).values()]
    before = [t.clone() for t in ops]
    for k in (1, 2, 3):
        sp.sparse_core_persistent(*ops, k, k_max=3, **KW)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(ops, before))


@pytest.mark.parametrize("plane", ["slab", "age", "susp"])
def test_wrapper_refuses_planes_off_alignment(plane):
    """The kernel moves 4 lanes of the caller's planes in one access: a
    slab, age or susp plane that starts off a 16-byte boundary raises
    before any work, on every device."""
    ops = {k: torch.from_numpy(v) for k, v in persistent_operands(64, 128, k_max=2).items()}
    ops[plane] = misaligned(ops[plane])
    with pytest.raises(ValueError, match=f"{plane} must start on a 16-byte boundary"):
        sp.sparse_core_persistent(*ops.values(), 1, k_max=2, **KW)


@pytest.mark.parametrize("dtype", [torch.int32, torch.int16, torch.int8])
def test_misaligned_copy_is_equal_and_off_alignment(dtype):
    """The test helper behind every misaligned-plane case: an equal,
    contiguous copy whose data starts off 16-byte alignment."""
    t = torch.arange(96, dtype=torch.int32).to(dtype).view(3, 32)
    m = misaligned(t)
    assert m.is_contiguous() and torch.equal(m, t)
    assert m.data_ptr() % 16 != 0
