"""Fused GRU sequence op — the inference half of
``paddle_tpu/ops/rnn_fused.py::gru_sequence_fused``.

The forward runs the ``gru_forward`` kernel (the plain version on the
CPU).  The backward, with its residual outputs ``z``/``h_prev`` and the
reverse-loop kernel, comes with the training slice as a
``torch.autograd.Function``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from paddle_tpu_torch.ops.kernels.gru import gru_forward

__all__ = ["gru_sequence_fused"]


def gru_sequence_fused(xp: torch.Tensor, mask: torch.Tensor, w_h: torch.Tensor,
                       h0: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """GRU over a padded batch given its input projection xp [B, T, 3H]
    -> (h_seq [B, T, H], h_final [B, H]), float32."""
    return gru_forward(xp, mask, w_h, h0)
