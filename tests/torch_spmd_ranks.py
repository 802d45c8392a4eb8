"""One rank of the port's explicit-SPMD engine over a gloo process group,
for tests/test_torch_spmd.py::test_gloo_ranks_match_stacked (a spawned
process imports this module alone: no JAX, only the port).

``scheduled_run(mesh, ticks)`` is the shared scenario: n=256, S=128, the
kernel route (the plain shard-mode core on the CPU), compressed cadences,
kills, a restart and a lossy, delayed middle segment.
"""

import dataclasses

import numpy as np
import torch

from scalecube_cluster_tpu_torch.parallel import mesh as TM
from scalecube_cluster_tpu_torch.parallel import spmd as TS
from scalecube_cluster_tpu_torch.sim import sparse as T
from scalecube_cluster_tpu_torch.sim.convert import sparse_state_to_numpy
from scalecube_cluster_tpu_torch.sim.faults import FaultPlan
from scalecube_cluster_tpu_torch.sim.params import SimParams
from scalecube_cluster_tpu_torch.sim.schedule import ScheduleBuilder

N, S = 256, 128


def scheduled_params() -> T.SparseParams:
    """The reference's testlib/certify.py::certify_params at S=128, kernel
    route."""
    base = dataclasses.replace(SimParams.from_cluster_config(N), fd_period_ticks=5,
                               sync_period_ticks=30, suspicion_ticks=20)
    return dataclasses.replace(T.SparseParams.for_n(N), base=base, slot_budget=S,
                               pallas_core=True)


def scheduled_run(mesh, ticks: int = 10):
    params = scheduled_params()
    sched = (
        ScheduleBuilder(N).add_segment(0, FaultPlan.uniform(device="cpu"))
        .add_segment(4, FaultPlan.uniform(20.0, 40.0, device="cpu"))
        .kill(2, 7).kill(3, N // 2 + 3).restart(8, 7).build()
    )
    state = T.init_sparse_full_view(N, S, seed=3, device="cpu")
    return TS.run_sparse_ticks_spmd(params, TS.ShardConfig(d=mesh.d), mesh, state, sched, ticks)


def gloo_rank(rank: int, port: int, out_path: str, ticks: int) -> None:
    """Join a two-rank gloo group on localhost:``port``, run the scenario
    on one shard, and (rank 0) save the global state and traces."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=2,
                            rank=rank)
    try:
        out, tr = scheduled_run(TM.make_dist_mesh(), ticks)
        if rank == 0:
            np.savez(out_path, **{f"s_{k}": v for k, v in sparse_state_to_numpy(out).items()},
                     **{f"t_{k}": v.numpy() for k, v in tr.items()})
    finally:
        dist.destroy_process_group()
