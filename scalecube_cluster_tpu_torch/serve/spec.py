"""EngineSpec: the engine-agnostic contract the serving bridge drives (port
of scalecube_cluster_tpu/serve/spec.py).

The per-engine facts live in one frozen :class:`EngineSpec` record, so
:class:`~scalecube_cluster_tpu_torch.serve.bridge.ServeBridge` drives any
registered engine behind one launch/collect protocol:

- ``runner`` / ``fleet_runner`` — the solo and fleet batch entries
  (serve/engine.py), the same ``(params, state, plan, batch, collect,
  knobs)`` call shape across engines; ``fleet_writeback`` frees a stacked
  fleet state's slots between launches (sim/ensemble.py).
- ``masks`` — the event-mask function the runner consumes (serve/events.py).
- ``init`` — fresh-state constructor, ``init(n, **kw)`` (``device=`` goes
  through ``kw``).
- ``shardings`` / ``place()`` — placement of the state on a device mesh;
  the ``sparse-gspmd`` spec is registered under its name but its
  placement raises until the port's multi-device engine.
- ``counter_keys`` — the schema the session's counter rollup runs on.

Registered specs, as in the reference: ``sparse``, ``sparse-elastic``,
``sparse-gspmd``, ``rapid`` and ``rapid-fallback``.
``resolve_engine_spec`` infers the spec from a state's type and shape when
the caller names none.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

from scalecube_cluster_tpu_torch.obs.counters import SHARED_COUNTERS
from scalecube_cluster_tpu_torch.serve.engine import (
    run_fleet_rapid_serve_batch,
    run_fleet_serve_batch,
    run_fleet_serve_batch_elastic,
    run_rapid_serve_batch,
    run_serve_batch,
    run_serve_batch_elastic,
)
from scalecube_cluster_tpu_torch.serve.events import (
    event_masks,
    event_masks_elastic,
    event_masks_rapid,
)

#: Why the mesh placement is refused: the sharded engine is not ported.
MESH_ERROR = (
    "mesh placement of a serving state needs the port's multi-device engine "
    "(ROADMAP A15), which is not ported"
)


def _sparse_init(n: int, **kw):
    from scalecube_cluster_tpu_torch.sim.sparse import init_sparse_full_view

    return init_sparse_full_view(n, **kw)


def _rapid_init(n: int, *, fallback: bool = False, **kw):
    from scalecube_cluster_tpu_torch.sim.rapid import RapidParams, init_rapid_full_view

    return init_rapid_full_view(RapidParams(n=n), fallback=fallback, **kw)


def _sparse_writeback(params, state):
    from scalecube_cluster_tpu_torch.sim.sparse import writeback_free

    return writeback_free(params, state)


def _sparse_fleet_writeback(params, states):
    from scalecube_cluster_tpu_torch.sim.ensemble import ensemble_writeback_free

    return ensemble_writeback_free(params, states)


def _sparse_shardings(state, mesh):
    raise NotImplementedError(MESH_ERROR)


@dataclass(frozen=True)
class EngineSpec:
    """Everything a serving bridge needs to know about one engine."""

    name: str
    #: serve/ingest.py protocol plane ("swim" accepts gossip and may alias
    #: joins; "rapid" rejects gossip, joins ride to the handshake).
    batcher_engine: str
    #: True when the runner consumes the 4-tuple (EV_JOIN) events — wire
    #: joins are wire-rate ADMISSION, and the bridge wires its capacity-row
    #: allocator and the join conservation ledger.
    elastic: bool
    #: True when the runner consumes the state argument (rebind the result).
    donates: bool
    runner: Callable  #: solo batch entry (serve/engine.py)
    fleet_runner: Callable | None  #: the fleet entry (None: no fleet)
    masks: Callable  #: event-mask function (serve/events.py)
    init: Callable  #: fresh-state constructor, ``init(n, **kw)``
    n_of: Callable  #: params -> member count n
    g_slots_of: Callable  #: state -> user-gossip plane width G (1: none)
    meta_of: Callable  #: params -> run_metadata(**kwargs) dict
    #: params -> default ``init`` kwargs that must agree with the params'
    #: geometry (the sparse slot_budget).
    init_kw_of: Callable | None = None
    #: Host-boundary slot free between launches (sparse big-n mode,
    #: ``params.in_scan_writeback=False``); None — nothing to free.
    writeback: Callable | None = None
    fleet_writeback: Callable | None = None
    #: ``shardings(state, mesh)`` for mesh placement; None — the engine
    #: ships no sharding layout.
    shardings: Callable | None = None
    #: True when the engine supports the checkpoint-based geometry
    #: promotion (sim/checkpoint.py::promote_sparse_state).
    promotable: bool = False
    counter_keys: tuple[str, ...] = field(default=SHARED_COUNTERS)

    def needs_writeback(self, params) -> bool:
        """Host-boundary writeback is due between launches iff the engine
        has one and the params chose the big-n boundary mode."""
        return self.writeback is not None and not getattr(
            params, "in_scan_writeback", True
        )

    def place(self, state, mesh):
        """Put ``state`` onto ``mesh`` under this engine's sharding layout."""
        if self.shardings is None:
            raise RuntimeError(f"engine {self.name!r} ships no sharding layout")
        return self.shardings(state, mesh)


def _sparse_spec(name: str, elastic: bool, shardings=None) -> EngineSpec:
    return EngineSpec(
        name=name,
        batcher_engine="swim",
        elastic=elastic,
        donates=True,
        runner=run_serve_batch_elastic if elastic else run_serve_batch,
        fleet_runner=run_fleet_serve_batch_elastic if elastic else run_fleet_serve_batch,
        masks=event_masks_elastic if elastic else event_masks,
        init=_sparse_init,
        n_of=lambda params: params.base.n,
        g_slots_of=lambda state: int(state.useen.shape[1]),
        meta_of=lambda params: {
            "n": params.base.n,
            "slot_budget": params.slot_budget,
        },
        init_kw_of=lambda params: {"slot_budget": params.slot_budget},
        writeback=_sparse_writeback,
        fleet_writeback=_sparse_fleet_writeback,
        shardings=shardings,
        promotable=True,
    )


def _rapid_spec(name: str, fallback: bool) -> EngineSpec:
    init = (
        (lambda n, **kw: _rapid_init(n, fallback=True, **kw))
        if fallback
        else _rapid_init
    )
    return EngineSpec(
        name=name,
        batcher_engine="rapid",
        elastic=False,
        donates=False,
        runner=run_rapid_serve_batch,
        fleet_runner=run_fleet_rapid_serve_batch,
        masks=event_masks_rapid,
        init=init,
        n_of=lambda params: params.n,
        # Rapid carries no user-gossip plane; the batcher rejects gossip
        # events outright (engine="rapid"), so the width is never consulted.
        g_slots_of=lambda state: 1,
        meta_of=lambda params: {"n": params.n},
        promotable=False,
    )


#: The engine registry, keyed by the ``engine=`` names the bridge accepts.
ENGINE_SPECS: dict[str, EngineSpec] = {}


def register_engine_spec(spec: EngineSpec) -> EngineSpec:
    if spec.name in ENGINE_SPECS:
        raise ValueError(f"engine spec {spec.name!r} already registered")
    ENGINE_SPECS[spec.name] = spec
    return spec


register_engine_spec(_sparse_spec("sparse", elastic=False))
register_engine_spec(_sparse_spec("sparse-elastic", elastic=True))
register_engine_spec(
    _sparse_spec("sparse-gspmd", elastic=False, shardings=_sparse_shardings)
)
register_engine_spec(_rapid_spec("rapid", fallback=False))
register_engine_spec(_rapid_spec("rapid-fallback", fallback=True))


def resolve_engine_spec(engine, state=None) -> EngineSpec:
    """Resolve an ``engine=`` argument to a spec: a spec (returned as is),
    a registry name, or None — inferred from the state: a RapidState serves
    on the rapid plane (the fallback flavor when the plane is armed), a
    sparse state with a ``live_mask`` is elastic, anything else is the
    fixed-shape sparse session."""
    if isinstance(engine, EngineSpec):
        return engine
    if engine is not None:
        try:
            return ENGINE_SPECS[engine]
        except KeyError:
            raise ValueError(
                f"unknown engine {engine!r}; registered: {sorted(ENGINE_SPECS)}"
            ) from None
    if state is None:
        raise ValueError("resolve_engine_spec needs an engine name or a state")
    from scalecube_cluster_tpu_torch.sim.rapid import RapidState

    if isinstance(state, RapidState):
        return ENGINE_SPECS["rapid-fallback" if state.fb is not None else "rapid"]
    if getattr(state, "live_mask", None) is not None:
        return ENGINE_SPECS["sparse-elastic"]
    return ENGINE_SPECS["sparse"]
