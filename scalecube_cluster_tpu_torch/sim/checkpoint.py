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
lack; the port does not).

Not ported yet: elastic archives (with ``live_mask``) raise
``NotImplementedError``, and ``promote_sparse_state`` waits for the elastic
state and the trace ring.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np
import torch

from scalecube_cluster_tpu_torch.ops import sparse_persistent as cold_lane
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
    SparseParams)``. Raises ``NotImplementedError`` on an elastic archive
    (one holding ``live_mask``)."""
    data = _read(path)
    if _SPARSE_MAGIC not in data:
        raise ValueError(f"{path} is not a sparse-engine checkpoint")
    if "live_mask" in data:
        raise NotImplementedError(
            "elastic sparse checkpoints (live_mask) are not ported yet"
        )
    raw = json.loads(bytes(data.pop(_SPARSE_MAGIC)).decode())
    params = SparseParams(base=SimParams(**raw.pop("base")), **raw)
    if _COLD_PACKED in data:
        age, susp = cold_lane.unpack_cold(torch.from_numpy(data.pop(_COLD_PACKED)))
        data["age"], data["susp"] = age.numpy(), susp.numpy()
    return sparse_state_from_numpy(data, device=device), params
