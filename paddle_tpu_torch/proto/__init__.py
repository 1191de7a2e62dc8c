"""Wire schemas — counterpart of ``paddle_tpu/proto``.

``model_config.proto`` is a copy of the reference's schema;
``model_config_pb2`` builds its messages, with the binary and text codecs,
from that file at import (the port does not use ``google.protobuf``).
"""

from paddle_tpu_torch.proto import model_config_pb2  # noqa: F401
