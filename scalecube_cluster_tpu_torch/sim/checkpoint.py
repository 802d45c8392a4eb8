"""Checkpoint / resume of the engines' states
(port of scalecube_cluster_tpu/sim/checkpoint.py).

One ``.npz`` per snapshot holds every tensor leaf (``rng`` as its raw
``uint32[2]`` key) plus the params dataclass as JSON, under the same keys
and in the same JSON as the JAX package writes, so a checkpoint written
by either package loads in the other. ``path`` may be a file path
(``.npz`` is appended when it has no suffix) or a file object such as
``io.BytesIO``. Loaders put the state on ``device`` (``cuda`` unless the
caller asks for the CPU), take the host tick mirror from the ``tick``
leaf, and copy every array, so the state shares no memory with the
archive. Archives must hold every field the current packages write (the
reference also rebuilds fields that snapshots of its earlier versions
lack; the port does not). Elastic states keep their ``live_mask``; the
flight recorder's ring is left out of archives, as the reference leaves it
out (export it with obs/trace.py).

:func:`promote_sparse_state` grows an elastic (or fixed-shape) sparse state
to a larger allocation, bit-exact on the old rows.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np
import torch

from scalecube_cluster_tpu_torch.obs.tracer import pad_trace_ring
from scalecube_cluster_tpu_torch.ops import sparse_persistent as cold_lane
from scalecube_cluster_tpu_torch.ops.delivery import GROUP
from scalecube_cluster_tpu_torch.ops.merge import UNKNOWN_KEY
from scalecube_cluster_tpu_torch.sim.convert import (
    dense_state_from_numpy,
    dense_state_to_numpy,
    sparse_state_from_numpy,
    sparse_state_to_numpy,
)
from scalecube_cluster_tpu_torch.sim.params import SimParams
from scalecube_cluster_tpu_torch.sim.sparse import SparseParams, SparseState
from scalecube_cluster_tpu_torch.sim.state import AGE_STALE, SimState

_PARAMS = "__params__"
_SPARSE_MAGIC = "__sparse_params__"
_COLD_PACKED = "__cold_packed__"


def _is_fileobj(path) -> bool:
    return hasattr(path, "read") or hasattr(path, "write")


def _normalize(path: str | Path) -> Path:
    """np.savez appends '.npz' to suffix-less paths; keep load symmetric."""
    path = Path(path)
    return path if path.suffix == ".npz" else path.with_name(path.name + ".npz")


def _target(path):
    """A file object as it is; a path normalized, its directory made."""
    if _is_fileobj(path):
        return path
    path = _normalize(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    return path


def _json_blob(obj) -> np.ndarray:
    return np.frombuffer(json.dumps(obj).encode(), dtype=np.uint8)


def _read(path) -> dict:
    """Every array of the archive, copied out of it."""
    with np.load(path if _is_fileobj(path) else _normalize(path)) as data:
        return {name: np.array(data[name]) for name in data.files}


def save_checkpoint(path, state: SimState, params: SimParams) -> None:
    """Write a dense-engine ``state`` and its protocol constants."""
    arrays = dense_state_to_numpy(state)
    arrays[_PARAMS] = _json_blob(dataclasses.asdict(params))
    np.savez(_target(path), **arrays)


def load_checkpoint(path, device="cuda") -> tuple[SimState, SimParams]:
    """Load a dense-engine snapshot onto ``device``."""
    data = _read(path)
    if _SPARSE_MAGIC in data:
        raise ValueError(f"{path} is a sparse-engine checkpoint; use load_sparse_checkpoint")
    params = SimParams(**json.loads(bytes(data[_PARAMS]).decode()))
    return dense_state_from_numpy(data, device=device), params


def save_sparse_checkpoint(path, state: SparseState, params: SparseParams, *,
                           pack_cold: bool = False) -> None:
    """Write a sparse-engine snapshot; the params JSON nests the base
    ``SimParams`` and carries the fold as a sorted list.

    ``pack_cold=True`` stores ``age`` and ``susp`` as one int16 lane
    (ops/sparse_persistent.py::pack_cold), 2 bytes a cell instead of 3.
    Exact only while every countdown fits the packed field: out-of-range
    values raise ``ValueError`` here rather than truncate."""
    arrays = sparse_state_to_numpy(state)
    arrays.pop("trace", None)
    if pack_cold:
        age, susp = arrays.pop("age"), arrays.pop("susp")
        if int(susp.max(initial=0)) > cold_lane.COLD_SUSP_MAX or int(age.max(initial=0)) > AGE_STALE:
            raise ValueError(
                f"pack_cold needs susp <= {cold_lane.COLD_SUSP_MAX} and age <= "
                f"{AGE_STALE} (got susp max {int(susp.max(initial=0))}, age "
                f"max {int(age.max(initial=0))}); save unpacked instead"
            )
        packed = cold_lane.pack_cold(torch.from_numpy(age), torch.from_numpy(susp))
        arrays[_COLD_PACKED] = packed.numpy()
    blob = dataclasses.asdict(params)
    blob["pallas_fold"] = sorted(blob["pallas_fold"])
    arrays[_SPARSE_MAGIC] = _json_blob(blob)
    np.savez(_target(path), **arrays)


def load_sparse_checkpoint(path, device="cuda") -> tuple[SparseState, SparseParams]:
    """Load a sparse-engine snapshot onto ``device`` → ``(SparseState,
    SparseParams)``."""
    data = _read(path)
    if _SPARSE_MAGIC not in data:
        raise ValueError(f"{path} is not a sparse-engine checkpoint")
    raw = json.loads(bytes(data.pop(_SPARSE_MAGIC)).decode())
    params = SparseParams(base=SimParams(**raw.pop("base")), **raw)
    if _COLD_PACKED in data:
        age, susp = cold_lane.unpack_cold(torch.from_numpy(data.pop(_COLD_PACKED)))
        data["age"], data["susp"] = age.numpy(), susp.numpy()
    return sparse_state_from_numpy(data, device=device), params


def promote_sparse_state(params: SparseParams, state: SparseState, n_alloc_new: int):
    """Geometry promotion (elastic membership): embed an ``n_old``-row
    sparse state into a fresh ``n_alloc_new``-row allocation, bit-exact on
    the old rows — every view cell, slab cell, counter plane, the slot
    tables, tick and rng carry verbatim into the ``[:n_old]`` corner.

    The new capacity rows are the init-time masked form: UNKNOWN along both
    view axes, dead, stale/zero working planes, ``live_mask`` False (a
    fixed-shape state gets a ``live_mask`` with its old rows True).
    ``slot_subj`` keeps its budget and ``subj_slot`` pads -1, so in-flight
    countdowns and tombstone ages survive. ``wb_valid`` drops to False (the
    carried pin mask belongs to the old viewer axis). A traced state's
    event log carries verbatim; its causal registers pad empty. Protocol
    constants carry unchanged (``dataclasses.replace(base, n=...)``).

    Returns ``(params_new, state_new)``; ``state_new`` shares no memory with
    ``state`` except the ring's event log and the [S] slot table.
    """
    n_old = params.base.n
    if n_alloc_new <= n_old:
        raise ValueError(f"promotion must grow: n_alloc_new={n_alloc_new} <= n={n_old}")
    if n_alloc_new % GROUP != 0:
        raise ValueError(
            f"n_alloc_new={n_alloc_new} must be a multiple of {GROUP} (delivery group width)"
        )
    dev = state.device
    grow_by = n_alloc_new - n_old

    def grow_rows(x, fill):
        pad = torch.full((grow_by,) + tuple(x.shape[1:]), fill, dtype=x.dtype, device=dev)
        return torch.cat([x, pad])

    view_T = torch.full((n_alloc_new, n_alloc_new), UNKNOWN_KEY, dtype=torch.int32, device=dev)
    view_T[:n_old, :n_old] = state.view_T
    live_old = (
        state.live_mask if state.live_mask is not None
        else torch.ones((n_old,), dtype=torch.bool, device=dev)
    )
    state_new = state.replace(
        view_T=view_T,
        subj_slot=grow_rows(state.subj_slot, -1),
        slab=grow_rows(state.slab, UNKNOWN_KEY),
        age=grow_rows(state.age, AGE_STALE),
        susp=grow_rows(state.susp, 0),
        inc_self=grow_rows(state.inc_self, 0),
        epoch=grow_rows(state.epoch, 0),
        alive=grow_rows(state.alive, False),
        useen=grow_rows(state.useen, False),
        uage=grow_rows(state.uage, 0),
        uinf_ids=grow_rows(state.uinf_ids, -1),
        uptr=grow_rows(state.uptr, 0),
        lat_first_suspect=(
            None if state.lat_first_suspect is None else grow_rows(state.lat_first_suspect, -1)
        ),
        lat_first_dead=(
            None if state.lat_first_dead is None else grow_rows(state.lat_first_dead, -1)
        ),
        wb_valid=None if state.wb_valid is None else torch.zeros_like(state.wb_valid),
        trace=None if state.trace is None else pad_trace_ring(state.trace, n_alloc_new),
        live_mask=grow_rows(live_old, False),
    )
    params_new = dataclasses.replace(
        params, base=dataclasses.replace(params.base, n=n_alloc_new)
    )
    return params_new, state_new
