"""Shard layout of the sparse state for the explicit-SPMD engine
(port of the parts of scalecube_cluster_tpu/parallel/mesh.py that engine
uses: ``AXIS``, ``UNIVERSE_AXIS``, ``make_mesh``,
``make_universe_member_mesh``, ``sparse_state_pspecs`` and
``shard_sparse_state``).

A :class:`Mesh` names ``d`` member shards and which of them this process
runs:

- all ``d`` in one process on one device (:func:`make_mesh`): the shards
  are a leading axis of every sharded leaf, the torch form of ``d``
  devices under ``shard_map``;
- one shard per ``torch.distributed`` rank (:func:`make_dist_mesh`).

The layout is data (:data:`SPARSE_LAYOUT`, the torch form of the
reference's ``sparse_state_pspecs``): for each leaf of
:class:`~scalecube_cluster_tpu_torch.sim.sparse.SparseState`, the axis that
holds members (the slab rows, ``view_T``'s viewer columns, the ``[N]``
vectors), or None for the replicated leaves (the slot tables, the tick,
the key, the write-back pin mask). :func:`shard_sparse_state` moves that
axis in front as ``[d, nl]`` and keeps this process's shards;
:func:`unshard_sparse_state` joins them back. With every shard in one
process both are views: nothing is copied, and a tick that updates the
sharded leaves in place updates the global state. The per-shard flight
recorder (obs/tracer.py::ShardTraceRing) already has its shard axis in
front. An ensemble's stacked state (sim/ensemble.py) keeps its universe
axis first: ``[B, d, nl, ...]``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from scalecube_cluster_tpu_torch.obs.tracer import RING_FIELDS

AXIS = "members"
#: The ensemble twin's leading axis (universes are data parallel).
UNIVERSE_AXIS = "universes"

#: Member axis of each sharded leaf of a SparseState (one universe); the
#: leaves not named here are replicated on every shard.
SPARSE_LAYOUT = {
    "view_T": 1,  # [N_subj, N_viewer]: the viewer columns
    "slab": 0,
    "age": 0,
    "susp": 0,
    "inc_self": 0,
    "epoch": 0,
    "alive": 0,
    "useen": 0,
    "uage": 0,
    "uinf_ids": 0,
    "uptr": 0,
    "lat_first_suspect": 0,
    "lat_first_dead": 0,
}


@dataclass(frozen=True)
class Mesh:
    """``d`` member shards and the ones this process runs: all of them
    (``group`` None) or the one of its ``torch.distributed`` rank.
    ``universes`` is the ensemble twin's batch size (1 for one run)."""

    d: int
    universes: int = 1
    group: object | None = None
    rank: int = 0

    @property
    def local(self) -> int:
        """Shards this process runs."""
        return self.d if self.group is None else 1

    @property
    def first(self) -> int:
        """Global index of this process's first shard."""
        return self.rank * self.local

    @property
    def shape(self) -> dict:
        return {UNIVERSE_AXIS: self.universes, AXIS: self.d} if self.universes > 1 else {
            AXIS: self.d}


def make_mesh(d: int) -> Mesh:
    """``d`` member shards, all run by this process (on the device its
    state lies on)."""
    if d < 1:
        raise ValueError(f"a mesh needs d >= 1 shards, got {d}")
    return Mesh(d=d)


def make_universe_member_mesh(shape: tuple[int, int]) -> Mesh:
    """The ensemble twin's ``universes x members`` mesh: ``B`` universes of
    ``d`` member shards, all in this process."""
    b, d = shape
    if b < 1 or d < 1:
        raise ValueError(f"mesh shape {shape} must be positive")
    return Mesh(d=d, universes=b)


def make_dist_mesh(group=None) -> Mesh:
    """One member shard per rank of ``group`` (the default process group
    when None; ``torch.distributed`` must be initialised). A NCCL group
    takes one card per rank; a gloo group runs on the CPU."""
    import torch.distributed as dist

    group = dist.group.WORLD if group is None else group
    return Mesh(d=dist.get_world_size(group), group=group, rank=dist.get_rank(group))


def _to_shards(x: torch.Tensor, axis: int, d: int, lead: int) -> torch.Tensor:
    """Member axis ``axis`` (counted after ``lead`` batch axes) as
    ``[.., d, .., nl, ..]`` with the shard axis right after the batch axes:
    a view."""
    a = lead + axis
    n = x.shape[a]
    return x.unflatten(a, (d, n // d)).movedim(a, lead)


def _from_shards(x: torch.Tensor, axis: int, lead: int) -> torch.Tensor:
    """The inverse of :func:`_to_shards` (a view where the strides allow)."""
    a = lead + axis
    y = x.movedim(lead, a)
    return y.flatten(a, a + 1)


def _universe_axes(state) -> int:
    """1 for an ensemble's stacked state (its key is ``uint32[B, 2]``),
    else 0."""
    return 1 if np.ndim(state.rng) == 2 else 0


def _state_fields(state):
    return [f.name for f in dataclasses.fields(state)]


def check_shardable(state, d: int) -> None:
    """Refuse what the sharded engine does not take: elastic states, and a
    member count that ``d`` does not divide."""
    if state.live_mask is not None:
        raise ValueError(
            "the explicit-SPMD engine runs fixed-shape states: elastic capacity "
            "rows (live_mask) are not sharded"
        )
    n = state.alive.shape[-1]
    if n % d:
        raise ValueError(f"n={n} members do not divide into d={d} shards")


def shard_sparse_state(state, mesh: Mesh):
    """The process's part of ``state`` in the sharded layout: every
    :data:`SPARSE_LAYOUT` leaf as ``[.., dl, .., nl, ..]`` (``dl`` =
    ``mesh.local``), the replicated leaves as they are, a ShardTraceRing's
    rows of those shards. Views when the process runs every shard; copies of
    its own rows otherwise."""
    check_shardable(state, mesh.d)
    lead = _universe_axes(state)
    lo, hi = mesh.first, mesh.first + mesh.local
    out = {}
    for name in _state_fields(state):
        x = getattr(state, name)
        if name in SPARSE_LAYOUT and x is not None:
            x = _to_shards(x, SPARSE_LAYOUT[name], mesh.d, lead)
            if mesh.local != mesh.d:
                x = x.narrow(lead, lo, mesh.local).contiguous()
        elif name == "trace" and x is not None and mesh.local != mesh.d:
            x = x.replace(**{f: getattr(x, f)[lo:hi].contiguous() for f in RING_FIELDS})
        out[name] = x
    return dataclasses.replace(state, **out)


def unshard_sparse_state(local, mesh: Mesh):
    """:func:`shard_sparse_state` in reverse: the global state, its sharded
    leaves joined (all-gathered over the ranks of a distributed mesh)."""
    lead = _universe_axes(local)
    out = {}
    for name in _state_fields(local):
        x = getattr(local, name)
        if name in SPARSE_LAYOUT and x is not None:
            if mesh.local != mesh.d:
                x = _gather_shards(x, lead, mesh)
            x = _from_shards(x, SPARSE_LAYOUT[name], lead)
        elif name == "trace" and x is not None and mesh.local != mesh.d:
            x = x.replace(**{f: _gather_shards(getattr(x, f), 0, mesh) for f in RING_FIELDS})
        out[name] = x
    return dataclasses.replace(local, **out)


def wire_dtype(x: torch.Tensor) -> torch.Tensor:
    """``x`` in a dtype every backend moves: gloo refuses bool and the
    8- and 16-bit integers, which travel as int32."""
    if x.dtype in (torch.bool, torch.int8, torch.uint8, torch.int16):
        return x.to(torch.int32)
    return x


def all_gather_single(dist):
    """``dist.all_gather_single``, or ``all_gather_into_tensor`` on a
    torch that predates it (the same call)."""
    return getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


def _gather_shards(x: torch.Tensor, axis: int, mesh: Mesh) -> torch.Tensor:
    """All ranks' ``[.., 1, ..]`` shard slices (at ``axis``) joined into
    ``[.., d, ..]`` on every rank."""
    import torch.distributed as dist

    wire = wire_dtype(x.movedim(axis, 0).contiguous())
    out = torch.empty((mesh.d * wire.shape[0],) + tuple(wire.shape[1:]), dtype=wire.dtype,
                      device=wire.device)
    all_gather_single(dist)(out, wire, group=mesh.group)
    return out.to(x.dtype).movedim(0, axis)
