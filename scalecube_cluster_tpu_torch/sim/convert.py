"""Carry an engine state across packages (the port's counterpart of
loading weights): a ``SparseState`` or ``SimState`` of the JAX package,
given as a dict of numpy arrays keyed by field name (``rng`` included, as
its ``uint32[2]`` raw key), becomes this package's state on ``device``,
and back.

A sparse state's flight-recorder ring travels as ``d["trace"]``: any
object or dict holding the ring's fields (the reference's ``TraceRing``,
or the dict :func:`sparse_state_to_numpy` writes). The sharded recorder is
not carried.

A stacked ensemble state (sim/ensemble.py) converts the same way: every
array with a leading universe axis, ``rng`` as ``uint32[B, 2]`` and the
host tick mirror per universe.

A Rapid state (sim/rapid.py) carries its fallback plane as ``d["fb"]``
(an object or dict of the ``FallbackState`` fields) and its ring as
``d["trace"]``, both optional.
"""

from __future__ import annotations

import numpy as np
import torch

from scalecube_cluster_tpu_torch.obs.tracer import ring_from_fields, ring_to_numpy
from scalecube_cluster_tpu_torch.sim.rapid import FallbackState, RapidState
from scalecube_cluster_tpu_torch.sim.sparse import SparseState
from scalecube_cluster_tpu_torch.sim.state import SimState

#: The dense state's tensor leaves and their dtypes.
_DENSE_LEAVES = {
    "view": torch.int32,
    "rumor_age": torch.int8,
    "suspect_left": torch.int16,
    "rows": torch.int32,
    "known_cnt": torch.int32,
    "inc_self": torch.int32,
    "epoch": torch.int32,
    "alive": torch.bool,
    "useen": torch.bool,
    "uage": torch.int32,
    "uinf": torch.bool,
    "uflight": torch.bool,
    "tick": torch.int32,
}


def _to_device(d: dict, name: str, dtype, device) -> torch.Tensor:
    # A copy: the caller's arrays never share memory with the state.
    host = torch.from_numpy(np.array(d[name], copy=True))
    return host.to(device=device, dtype=dtype).contiguous()


def _rng(d: dict) -> np.ndarray:
    rng = np.asarray(d["rng"], dtype=np.uint32)
    return (rng if rng.ndim == 2 else rng.reshape(2)).copy()


def _t_host(d: dict):
    """The host tick mirror: an int, or ``int64[B]`` for a stacked state."""
    tick = np.asarray(d["tick"])
    return tick.astype(np.int64).copy() if tick.ndim else int(tick)


def dense_state_from_numpy(d: dict, device="cuda") -> SimState:
    """Build this package's dense state from a dict of numpy arrays."""
    fields = {name: _to_device(d, name, dt, device) for name, dt in _DENSE_LEAVES.items()}
    return SimState(rng=_rng(d), t_host=_t_host(d), **fields)


def dense_state_to_numpy(state: SimState) -> dict:
    """The inverse of :func:`dense_state_from_numpy`: copies, in the
    reference's dtypes."""
    out = {name: np.array(getattr(state, name).cpu()) for name in _DENSE_LEAVES}
    out["rng"] = np.asarray(state.rng, dtype=np.uint32).copy()
    return out

#: Tensor leaves and their dtypes; ``rng`` and the host tick mirror are
#: handled apart.
_LEAVES = {
    "view_T": torch.int32,
    "slot_subj": torch.int32,
    "subj_slot": torch.int32,
    "slab": torch.int32,
    "age": torch.int8,
    "susp": torch.int16,
    "inc_self": torch.int32,
    "epoch": torch.int32,
    "alive": torch.bool,
    "useen": torch.bool,
    "uage": torch.int32,
    "uinf_ids": torch.int32,
    "uptr": torch.int32,
    "tick": torch.int32,
}
_OPTIONAL = {
    "lat_first_suspect": torch.int32,
    "lat_first_dead": torch.int32,
    "wb_pinned": torch.bool,
    "wb_valid": torch.bool,
    "live_mask": torch.bool,
}


def sparse_state_from_numpy(d: dict, device="cuda") -> SparseState:
    """Build this package's state from a dict of numpy arrays (``trace``,
    when present, an object or dict of the ring's fields)."""
    ring = d.get("trace")
    if ring is not None:
        cursor = ring["cursor"] if isinstance(ring, dict) else ring.cursor
        if len(np.shape(cursor)) != 0:
            raise ValueError("a sharded trace ring is not supported by the port")

    # Copies: the engine updates view_T and slab in place, which must not
    # reach the caller's arrays.
    fields = {name: _to_device(d, name, dt, device) for name, dt in _LEAVES.items()}
    fields.update(
        {name: _to_device(d, name, dt, device) if d.get(name) is not None else None
         for name, dt in _OPTIONAL.items()}
    )
    fields["trace"] = None if ring is None else ring_from_fields(ring, device=device)
    return SparseState(rng=_rng(d), t_host=_t_host(d), **fields)


def sparse_state_to_numpy(state: SparseState) -> dict:
    """The inverse of :func:`sparse_state_from_numpy`: a dict of numpy
    arrays in the reference's dtypes (optional leaves only when present;
    the ring as ``out["trace"]``, a dict of its fields). The arrays are
    copies: the engine updates ``view_T`` and ``slab`` in place, and a CPU
    tensor's ``.numpy()`` would share that memory."""
    out = {name: np.array(getattr(state, name).cpu()) for name in _LEAVES}
    for name in _OPTIONAL:
        value = getattr(state, name)
        if value is not None:
            out[name] = np.array(value.cpu())
    if state.trace is not None:
        out["trace"] = ring_to_numpy(state.trace)
    out["rng"] = np.asarray(state.rng, dtype=np.uint32).copy()
    return out


#: The Rapid state's and its fallback plane's tensor leaves.
_RAPID_LEAVES = {
    "member_mask": torch.bool,
    "view_id": torch.int32,
    "edge_fail": torch.int32,
    "edge_join": torch.int32,
    "vote_rm": torch.bool,
    "vote_add": torch.bool,
    "voted": torch.bool,
    "epoch": torch.int32,
    "alive": torch.bool,
    "tick": torch.int32,
}
_FALLBACK_LEAVES = {
    "wait": torch.int32,
    "promised": torch.int32,
    "acc_rank": torch.int32,
    "acc_rm": torch.bool,
    "acc_add": torch.bool,
    "prop_rm": torch.bool,
    "prop_add": torch.bool,
    "prop_ready": torch.bool,
    "decided": torch.bool,
    "join_phase": torch.int32,
    "join_seed": torch.int32,
    "join_tries": torch.int32,
    "join_digest": torch.int32,
    "join_ok": torch.bool,
}


def _fields(obj) -> dict:
    if isinstance(obj, dict):
        return obj
    return {name: getattr(obj, name) for name in _FALLBACK_LEAVES}


def rapid_state_from_numpy(d: dict, device="cuda") -> RapidState:
    """Build this package's Rapid state from a dict of numpy arrays
    (``fb`` and ``trace`` objects or dicts of their fields, when present;
    ``live_mask`` when present)."""
    fields = {name: _to_device(d, name, dt, device) for name, dt in _RAPID_LEAVES.items()}
    fb = d.get("fb")
    if fb is not None:
        fb = _fields(fb)
        fb = FallbackState(**{
            name: _to_device(fb, name, dt, device) for name, dt in _FALLBACK_LEAVES.items()
        })
    ring = d.get("trace")
    live = d.get("live_mask")
    return RapidState(
        rng=_rng(d), t_host=_t_host(d), **fields,
        trace=None if ring is None else ring_from_fields(ring, device=device),
        fb=fb,
        live_mask=None if live is None else _to_device(d, "live_mask", torch.bool, device),
    )


def rapid_state_to_numpy(state: RapidState) -> dict:
    """The inverse of :func:`rapid_state_from_numpy`: copies in the
    reference's dtypes, ``fb`` and ``trace`` as dicts of their fields and
    ``live_mask`` only when present."""
    out = {name: np.array(getattr(state, name).cpu()) for name in _RAPID_LEAVES}
    if state.fb is not None:
        out["fb"] = {name: np.array(getattr(state.fb, name).cpu()) for name in _FALLBACK_LEAVES}
    if state.trace is not None:
        out["trace"] = ring_to_numpy(state.trace)
    if state.live_mask is not None:
        out["live_mask"] = np.array(state.live_mask.cpu())
    out["rng"] = np.asarray(state.rng, dtype=np.uint32).copy()
    return out
