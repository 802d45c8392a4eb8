"""Utility value types and helpers (reference: io.scalecube:scalecube-commons)."""

from scalecube_cluster_tpu_torch.utils.address import Address
from scalecube_cluster_tpu_torch.utils.ids import CorrelationIdGenerator, generate_id

__all__ = ["Address", "CorrelationIdGenerator", "generate_id"]
