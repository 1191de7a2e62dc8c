"""paddle_tpu_torch.v2 — the port of ``paddle_tpu/v2``.  Only the network
helpers (``networks``) are ported; the rest of the v2 facade is not yet."""

from paddle_tpu_torch.v2 import networks

__all__ = ["networks"]
