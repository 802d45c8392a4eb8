"""Test support of the port (twin of scalecube_cluster_tpu/testlib/): the
SWIM, Rapid, zone and promotion invariant certifiers (``invariants``), the
seeded chaos harness (``chaos``), the no-donation runner names
(``donation``), and the seeded serving and fleet replays (``serving``,
``fleet``). The reference's host-backend fixtures and network emulator are
not ported yet."""

from scalecube_cluster_tpu_torch.testlib.chaos import (
    chaos_ensemble,
    chaos_race,
    chaos_soak,
    chaos_trial,
    geo_chaos_matrix,
    geo_trial,
    grow_matrix,
    grow_trial,
    sample_geo_schedule,
    sample_schedule,
)
from scalecube_cluster_tpu_torch.testlib.donation import (
    nodonate,
    run_ensemble_sparse_ticks_nodonate,
    run_sparse_ticks_nodonate,
)
from scalecube_cluster_tpu_torch.testlib.invariants import (
    InvariantViolation,
    certify_heal,
    certify_population,
    certify_promotion,
    certify_traces,
    certify_zone_traces,
    heal_bound,
    z1_recover_bound,
    zone_heal_bound,
)

__all__ = [
    "InvariantViolation",
    "certify_heal",
    "certify_population",
    "certify_promotion",
    "certify_traces",
    "certify_zone_traces",
    "chaos_ensemble",
    "chaos_race",
    "chaos_soak",
    "chaos_trial",
    "geo_chaos_matrix",
    "geo_trial",
    "grow_matrix",
    "grow_trial",
    "heal_bound",
    "nodonate",
    "run_ensemble_sparse_ticks_nodonate",
    "run_sparse_ticks_nodonate",
    "sample_geo_schedule",
    "sample_schedule",
    "z1_recover_bound",
    "zone_heal_bound",
]
