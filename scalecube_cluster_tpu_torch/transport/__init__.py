"""Transport SPI + backends (reference: transport-parent/)."""

from scalecube_cluster_tpu_torch.transport.api import (
    MessageStream,
    Transport,
    TransportStoppedError,
)
from scalecube_cluster_tpu_torch.transport.codec import (
    DEFAULT_CODEC,
    JsonMessageCodec,
    MessageCodec,
    register_data_type,
)
from scalecube_cluster_tpu_torch.transport.message import (
    HEADER_CORRELATION_ID,
    HEADER_QUALIFIER,
    Message,
)
from scalecube_cluster_tpu_torch.transport.tcp import TcpTransport

__all__ = [
    "DEFAULT_CODEC",
    "HEADER_CORRELATION_ID",
    "HEADER_QUALIFIER",
    "JsonMessageCodec",
    "Message",
    "MessageCodec",
    "MessageStream",
    "TcpTransport",
    "Transport",
    "TransportStoppedError",
    "register_data_type",
]
