"""Public cluster API data model — the parts the sim engines read
(reference: scalecube_cluster_tpu/cluster_api/)."""

from scalecube_cluster_tpu_torch.cluster_api.config import (  # noqa: F401
    ClusterConfig,
    FailureDetectorConfig,
    GossipConfig,
    MembershipConfig,
    TransportConfig,
)
from scalecube_cluster_tpu_torch.cluster_api.member import MemberStatus  # noqa: F401
