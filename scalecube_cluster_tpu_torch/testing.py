"""Seeded operands for holding the kernels against their plain versions:
shared by the parity tests, ``chip_smoke.py`` and the persistent core's
k-sweep bench (which prices the kernel on the same operand set, as the JAX
package's rung does); and :func:`misaligned`, for the kernels' paths that
take planes off 16-byte alignment. Nothing on the engines' paths imports
this module."""

from __future__ import annotations

import fcntl
import hashlib
import os
import pickle
import tempfile
from pathlib import Path

import numpy as np
import torch

from scalecube_cluster_tpu_torch.ops import delivery_merge, sparse_persistent
from scalecube_cluster_tpu_torch.ops.delivery import GROUP
from scalecube_cluster_tpu_torch.ops.merge import DEAD_BIT
from scalecube_cluster_tpu_torch.ops.sparse_core import SPARSE_GROUP, TILE_LANES
from scalecube_cluster_tpu_torch.ops.tick_core import TILE_COLS


def _random_keys(rng, shape) -> np.ndarray:
    """Record keys of every status over a few epochs and incarnations, a
    quarter UNKNOWN."""
    status = rng.integers(0, 3, shape)
    inc = rng.integers(0, 4, shape)
    epoch = rng.integers(0, 3, shape)
    key = (epoch << 22) | np.where(status == 2, DEAD_BIT, 0) | (inc << 1)
    key = key | np.where(status == 1, 1, 0)
    return np.where(rng.random(shape) < 0.25, -1, key).astype(np.int32)


def random_tick_operands(n: int, f: int = 3, seed: int = 0, susp_ticks: int = 20) -> dict:
    """A seeded numpy operand set for ``ops.tick_core.tick_core`` that
    reaches every case of the dense core: records of every status over a
    few epochs (overrides, epoch introductions, sticky DEAD, tombstones),
    UNKNOWN cells, payload rows that are young, stale or differ from the
    view, ages at 0, at the int8 saturation (119, 120) and past the sweep,
    countdowns at 0, 1, 2 and at ``susp_ticks``, fired FD verdicts on
    about a third of the rows (some on the diagonal), dead receivers and
    lost edges."""
    rng = np.random.default_rng(seed)
    ng = n // GROUP
    view0 = _random_keys(rng, (n, n))
    rows = np.where(rng.random((n, n)) < 0.5, view0, -1)
    rows = np.where(rng.random((n, n)) < 0.1, _random_keys(rng, (n, n)), rows).astype(np.int32)
    age = np.where(rng.random((n, n)) < 0.3, rng.choice([0, 1, 119, 120], (n, n)),
                   rng.integers(0, 121, (n, n))).astype(np.int8)
    susp = np.where(rng.random((n, n)) < 0.5, rng.choice([0, 1, 2, susp_ticks], (n, n)),
                    rng.integers(0, 3 * susp_ticks, (n, n))).astype(np.int16)
    fd_tgt = np.where(rng.random(n) < 0.35, rng.integers(0, n, n), -1).astype(np.int32)
    diag_hit = rng.random(n) < 0.02
    fd_tgt[diag_hit] = np.flatnonzero(diag_hit)
    return {
        "rows": rows,
        "view0": view0,
        "age": age,
        "susp": susp,
        "ginv": np.stack([rng.permutation(ng) for _ in range(f)]).astype(np.int32),
        "rots": rng.integers(0, GROUP, (f, ng)).astype(np.int32),
        "edge_ok": rng.random((f, n)) < 0.85,
        "alive": rng.random(n) < 0.9,
        "fd_tgt": fd_tgt,
        "fd_key": _random_keys(rng, (n,)),
    }


def random_operands(n: int, s: int, f: int = 3, seed: int = 0) -> dict:
    """A seeded numpy operand set for ``ops.sparse_core.sparse_core`` that
    reaches every case of the core: records of every status over a few
    epochs and incarnations (so same-epoch overrides, epoch introductions
    and sticky DEAD all occur), UNKNOWN cells, young and stale ages,
    countdowns about to expire, inactive lanes, own columns (subjects that
    are receivers), dead receiver rows, lost edges, FD and SYNC point lanes
    on both sides of delivery and same-cell FD/SYNC collisions."""
    rng = np.random.default_rng(seed)
    nb = n // SPARSE_GROUP

    def keys(shape):
        return _random_keys(rng, shape)

    subj = np.full(s, -1, np.int32)
    k_active = min(n, (3 * s) // 4)
    subj[:k_active] = rng.choice(n, size=k_active, replace=False)
    rng.shuffle(subj)
    fd_slot = np.where(rng.random(n) < 0.3, rng.integers(0, s, n), -1).astype(np.int32)
    sy_slot = np.where(rng.random(n) < 0.3, rng.integers(0, s, n), -1).astype(np.int32)
    collide = rng.random(n) < 0.05
    sy_slot[collide] = np.where(fd_slot[collide] >= 0, fd_slot[collide], 0)
    susp = np.where(rng.random((n, s)) < 0.5, rng.integers(0, 3, (n, s)),
                    rng.integers(0, 500, (n, s)))
    return {
        "slab": keys((n, s)),
        "age": rng.integers(0, 121, (n, s)).astype(np.int8),
        "susp": susp.astype(np.int16),
        "slot_subj": subj,
        "ginv": np.stack([rng.permutation(nb) for _ in range(f)]).astype(np.int32),
        "rots": rng.integers(0, SPARSE_GROUP, (f, nb)).astype(np.int32),
        "edge_ok": rng.random((f, n)) < 0.9,
        "alive": rng.random(n) < 0.9,
        "fd_slot": fd_slot,
        "sy_slot": sy_slot,
        "fd_key": keys((n,)),
        "sy_key": keys((n,)),
    }


def _tile_edges(width: int, tile: int) -> np.ndarray:
    """Columns on both sides of every tile boundary of ``width``, and the
    first and last."""
    cuts = np.arange(tile, width, tile)
    return np.unique(np.concatenate([[0, width - 1], cuts - 1, cuts]))


def tile_edge_tick_operands(n: int, f: int = 3, seed: int = 0, susp_ticks: int = 20) -> dict:
    """:func:`random_tick_operands` with half the rows' FD targets on the
    columns beside a boundary of the kernel's column tiles (``TILE_COLS``)
    and on columns 0 and n - 1, for holding the tiled dense kernel at its
    tile edges; the diagonal crosses every tile by itself."""
    ops = random_tick_operands(n, f, seed=seed, susp_ticks=susp_ticks)
    rng = np.random.default_rng(seed + 1)
    edges = _tile_edges(n, TILE_COLS)
    hit = rng.random(n) < 0.5
    ops["fd_tgt"][hit] = rng.choice(edges, int(hit.sum())).astype(np.int32)
    return ops


def tile_edge_operands(n: int, s: int, f: int = 3, seed: int = 0) -> dict:
    """:func:`random_operands` with a third of the rows' FD and SYNC point
    lanes beside a boundary of the kernel's lane tiles (``TILE_LANES``) and
    on lanes 0 and S - 1, and every lane of the second tile, where there is
    one, inactive (its slots empty), for holding the tiled sparse kernel at
    its tile edges."""
    ops = random_operands(n, s, f, seed=seed)
    rng = np.random.default_rng(seed + 1)
    edges = _tile_edges(s, TILE_LANES)
    for name in ("fd_slot", "sy_slot"):
        hit = rng.random(n) < 1 / 3
        ops[name][hit] = rng.choice(edges, int(hit.sum())).astype(np.int32)
    ops["slot_subj"][TILE_LANES : 2 * TILE_LANES] = -1
    return ops


def shard_operands(nl: int, s: int, f: int = 3, seed: int = 0, row_base: int = 512,
                   n_total: int | None = None, tile_edges: bool = False) -> dict:
    """A seeded numpy operand set for the sparse core's shard mode
    (``ops.sparse_core.sparse_core`` with ``row_base`` and sender
    windows): :func:`random_operands` (or, with
    ``tile_edges``, :func:`tile_edge_operands`) for one shard's ``nl`` rows,
    whose members are ``row_base .. row_base + nl - 1`` of ``n_total``
    (default ``row_base + nl``), the active lanes on distinct global
    subjects with every fifth on a member of the block (own lanes; with
    ``tile_edges`` also the block's first and last members and the member
    before it on lanes beside the tile boundaries);
    ``slab_windows`` / ``age_windows`` of ``f·nl`` random sender rows at
    ages 0..120, and the routing ``ginv`` a random permutation of the
    window blocks (each block feeds one receiver block on one channel, as
    under the engine's identity routing ``c·ngl + j``)."""
    make = tile_edge_operands if tile_edges else random_operands
    ops = make(nl, s, f, seed=seed)
    rng = np.random.default_rng(seed + 7)
    n_total = row_base + nl if n_total is None else n_total
    w = f * nl
    lanes = np.flatnonzero(ops["slot_subj"] >= 0)
    own = lanes[::5]
    block = row_base + rng.choice(nl, min(own.size, nl), replace=False)
    others = np.setdiff1d(np.arange(n_total), block)
    subj = np.full(s, -1, np.int32)
    subj[lanes] = rng.choice(others, lanes.size, replace=False)
    subj[own[: block.size]] = block
    if tile_edges:
        # The block's first and last members, and the member just before
        # it, on active lanes beside the tile boundaries (kept distinct).
        special = [row_base, row_base + nl - 1] + ([row_base - 1] if row_base else [])
        edges = [e for e in _tile_edges(s, TILE_LANES) if subj[e] >= 0]
        for lane, sid in zip(edges, special):
            hit = np.flatnonzero(subj == sid)
            if hit.size:
                subj[hit[0]] = subj[lane]
            subj[lane] = sid
    ops["slot_subj"] = subj.astype(np.int32)
    ops["ginv"] = rng.permutation(w // SPARSE_GROUP).reshape(f, nl // SPARSE_GROUP).astype(
        np.int32)
    ops["slab_windows"] = _random_keys(rng, (w, s))
    ops["age_windows"] = rng.integers(0, 121, (w, s)).astype(np.int8)
    ops["row_base"] = np.int32(row_base)
    return ops


def stacked_shard_operands(shards: int, nl: int, s: int, f: int = 3, seed: int = 0,
                           tile_edges: bool = False) -> dict:
    """:func:`shard_operands` of ``shards`` shards of one cluster (shard z
    holds members ``z·nl ..``), stacked on a leading axis as one launch
    takes them (``row_base`` ``[shards]`` int32)."""
    parts = [shard_operands(nl, s, f, seed=seed + z, row_base=z * nl, n_total=shards * nl,
                            tile_edges=tile_edges) for z in range(shards)]
    return {k: np.stack([p[k] for p in parts]) for k in parts[0]}


#: The sparse core's positional operands, in order.
CORE_OPERANDS = ("slab", "age", "susp", "slot_subj", "ginv", "rots", "edge_ok", "alive",
                 "fd_slot", "sy_slot", "fd_key", "sy_key")


def shard_core_args(ops: dict, device="cpu") -> tuple[tuple, dict]:
    """``(positional operands, shard-mode keywords)`` of a
    :func:`shard_operands` or :func:`stacked_shard_operands` set as tensors
    on ``device``, as ``ops.sparse_core.sparse_core`` takes them."""
    args = tuple(torch.from_numpy(np.asarray(ops[k])).to(device) for k in CORE_OPERANDS)
    rb = ops["row_base"]
    kw = dict(row_base=int(rb) if np.ndim(rb) == 0 else torch.from_numpy(rb).to(device),
              slab_windows=torch.from_numpy(ops["slab_windows"]).to(device),
              age_windows=torch.from_numpy(ops["age_windows"]).to(device))
    return args, kw


def persistent_operands(n: int, s: int, f: int = 3, k_max: int = 8, seed: int = 0) -> dict:
    """A seeded numpy operand set for ``ops.sparse_persistent.
    sparse_core_persistent``, drawn exactly as the JAX package's
    ``tests/test_sparse.py::_persistent_inputs`` and
    ``bench.py::_measure_persistent_ksweep`` draw theirs (the same values
    from the same seed): a slab of random keys and UNKNOWNs, ages 0..119,
    countdowns 0..20, half the slots active, ``k_max`` ticks of random
    window blocks, rotations and 80% edges, 90% live rows."""
    rng = np.random.default_rng(seed)
    nb = n // SPARSE_GROUP
    slab = rng.integers(-1, 1 << 20, (n, s)).astype(np.int32)
    age = rng.integers(0, 120, (n, s)).astype(np.int8)
    susp = rng.integers(0, 21, (n, s)).astype(np.int16)
    subj = np.full(s, -1, np.int32)
    k_active = min(n, s // 2)
    subj[:k_active] = rng.choice(n, size=k_active, replace=False)
    rng.shuffle(subj)
    return {
        "slab": slab,
        "age": age,
        "susp": susp,
        "slot_subj": subj,
        "ginv": rng.integers(0, nb, (k_max, f, nb)).astype(np.int32),
        "rots": rng.integers(0, SPARSE_GROUP, (k_max, f, nb)).astype(np.int32),
        "edge_ok": rng.random((k_max, f, n)) < 0.8,
        "alive": rng.random(n) < 0.9,
    }


def tile_edge_merge_operands(n: int, f: int = 3, seed: int = 0) -> dict:
    """:func:`random_tick_operands` whose payload ``rows`` carries, on the
    columns beside every boundary of the delivery-merge kernel's column
    tiles (``delivery_merge.TILE_COLS``) and on columns 0 and n - 1, young
    ALIVE records of an epoch newer than any in the views: every live
    receiver that an edge reaches takes them in its merge there, so the
    merge changes cells on both sides of each boundary. The diagonal
    crosses every tile by itself."""
    ops = random_tick_operands(n, f, seed=seed)
    rng = np.random.default_rng(seed + 1)
    edges = _tile_edges(n, delivery_merge.TILE_COLS)
    fresh = (3 << 22) | (rng.integers(0, 4, (n, edges.size)) << 1)
    ops["rows"][:, edges] = fresh.astype(np.int32)
    return ops


def tile_edge_persistent_operands(n: int, s: int, f: int = 3, k_max: int = 8,
                                  seed: int = 0) -> dict:
    """:func:`persistent_operands` with the lanes beside every boundary of
    the persistent kernel's lane tiles (``sparse_persistent.TILE_LANES``)
    and lanes 0 and S - 1 active while free subjects last (each on a
    subject no other lane holds, so each is one receiver's own lane), every
    lane of the second tile, where there is one, inactive, and a quarter of
    the cells' ages and countdowns outside the packable range (any int8
    age, countdowns of -600..599), which the kernel packs in its first tick
    as ``pack_cold`` does."""
    ops = persistent_operands(n, s, f, k_max, seed=seed)
    rng = np.random.default_rng(seed + 1)
    tile = sparse_persistent.TILE_LANES
    subj = ops["slot_subj"]
    edges = _tile_edges(s, tile)
    free = np.setdiff1d(np.arange(n), subj[subj >= 0])
    idle = edges[subj[edges] < 0][: free.size]
    subj[idle] = rng.choice(free, idle.size, replace=False)
    subj[tile : 2 * tile] = -1
    wide = rng.random((n, s)) < 0.25
    ops["age"] = np.where(wide, rng.integers(-128, 128, (n, s)), ops["age"]).astype(np.int8)
    ops["susp"] = np.where(wide, rng.integers(-600, 600, (n, s)), ops["susp"]).astype(np.int16)
    return ops


def one_cpu_thread() -> None:
    """Run this process's CPU tensor work on one intra-op thread. The parity
    tests run in several worker processes side by side, and torch would
    otherwise give each of them a pool of one thread per core, whose
    spinning threads crowd out the other workers' JAX references."""
    torch.set_num_threads(1)


def shared_result(key: str, compute):
    """``compute()`` once per test run across the run's worker processes.

    The parity tests hold the port against reference trajectories that
    take tens of seconds each; a run spread over several workers
    (pytest-xdist, which names the run in ``PYTEST_XDIST_TESTRUNUID``)
    would otherwise compute one in every worker that runs a test of it.
    The first worker to ask takes an exclusive ``flock`` on the key's lock
    file, computes and pickles the result into the run's directory under
    the temporary directory; the others block on the lock and read the
    file. The kernel drops the lock when its holder exits, so a worker that
    dies computing leaves nothing to wait for: the next one computes. Outside
    such a run, this is ``compute()``. The result must be picklable (numpy
    arrays, dicts, lists)."""
    run = os.environ.get("PYTEST_XDIST_TESTRUNUID")
    if not run:
        return compute()
    root = Path(tempfile.gettempdir()) / f"scalecube-torch-refs-{run}"
    root.mkdir(exist_ok=True)
    name = hashlib.sha1(key.encode()).hexdigest()
    done = root / f"{name}.pkl"
    with open(root / f"{name}.lock", "a") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if done.exists():
            with open(done, "rb") as fh:
                return pickle.load(fh)
        value = compute()
        part = root / f"{name}.{os.getpid()}.part"
        with open(part, "wb") as fh:
            pickle.dump(value, fh)
        os.replace(part, done)
        return value


def misaligned(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``t`` that starts one element past an aligned
    address, on ``t``'s device: the fused cores and delivery-merge take such
    planes one lane at a time, the p_accum and p_fdmask probes by a scalar
    path; the persistent core's wrapper refuses them."""
    buf = torch.empty(t.numel() + 16, dtype=t.dtype, device=t.device)
    out = buf[1 : 1 + t.numel()].view(t.shape)
    out.copy_(t)
    return out
