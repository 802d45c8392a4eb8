"""Sharded execution of the sparse engine (port of
scalecube_cluster_tpu/parallel/, its explicit-SPMD half).

``spmd.run_sparse_ticks_spmd`` runs the sparse engine as ``d`` member
shards with three explicit exchanges a tick, all shards in one process on
one device (``mesh.make_mesh``) or one per ``torch.distributed`` rank
(``mesh.make_dist_mesh``); ``run_ensemble_sparse_ticks_spmd`` is its
``universes x members`` twin. The GSPMD placement path of the reference
(``state_shardings``, ``shard_state``, ``shard_plan``, the 2D mesh) is not
ported.
"""

from scalecube_cluster_tpu_torch.parallel.mesh import (
    AXIS,
    UNIVERSE_AXIS,
    Mesh,
    make_dist_mesh,
    make_mesh,
    make_universe_member_mesh,
    shard_sparse_state,
    unshard_sparse_state,
)
from scalecube_cluster_tpu_torch.parallel.spmd import (
    ShardConfig,
    exchange_payload_bytes_per_tick,
    exchange_rounds_per_tick,
    run_ensemble_sparse_ticks_spmd,
    run_sparse_ticks_spmd,
)

__all__ = [
    "AXIS",
    "UNIVERSE_AXIS",
    "Mesh",
    "ShardConfig",
    "exchange_payload_bytes_per_tick",
    "exchange_rounds_per_tick",
    "make_dist_mesh",
    "make_mesh",
    "make_universe_member_mesh",
    "run_ensemble_sparse_ticks_spmd",
    "run_sparse_ticks_spmd",
    "shard_sparse_state",
    "unshard_sparse_state",
]
