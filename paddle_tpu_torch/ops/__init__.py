"""paddle_tpu_torch.ops — the op tier of the port, under the reference's
names (``paddle_tpu/ops``).  Plain PyTorch functions on tensors; the hand-
written kernels live in ``ops/kernels`` and are reached through
``gru_layer`` (forward and backward), ``LinearReadout`` and
``sequence_softmax_ce_readout``."""

from paddle_tpu_torch.ops.numerics import (acc_dtype, bwd_einsum, bwd_mm,
                                           compute_dtype,
                                           compute_dtype_scope, dot_dtype,
                                           mxu_cast, residual_dtype)
from paddle_tpu_torch.ops.matmul import linear, matmul
from paddle_tpu_torch.ops.activations import ACTIVATIONS, get_activation
from paddle_tpu_torch.ops.embedding import embedding_lookup
from paddle_tpu_torch.ops.sequence import mask_from_lengths
from paddle_tpu_torch.ops.attention import additive_attention_scores, attend
from paddle_tpu_torch.ops.rnn import (bigru_layer, gru_layer, gru_step,
                                      scan_rnn)
from paddle_tpu_torch.ops.rnn_fused import gru_sequence_fused
from paddle_tpu_torch.ops.attention_decoder import attention_gru_decoder
from paddle_tpu_torch.ops.losses import (masked_token_mean,
                                         sequence_softmax_ce_readout)
from paddle_tpu_torch.ops.decode import (NEG, LinearReadout, beam_decode,
                                         beam_gather, decode_step,
                                         finalize_slots, greedy_decode,
                                         init_slot_carry, release_slot,
                                         write_slot)

__all__ = [
    "acc_dtype", "compute_dtype", "compute_dtype_scope", "dot_dtype",
    "mxu_cast", "bwd_mm", "bwd_einsum", "residual_dtype", "linear", "matmul",
    "ACTIVATIONS", "get_activation",
    "embedding_lookup", "mask_from_lengths", "additive_attention_scores",
    "attend", "bigru_layer", "gru_layer", "gru_step", "scan_rnn",
    "gru_sequence_fused", "attention_gru_decoder", "masked_token_mean",
    "sequence_softmax_ce_readout", "NEG", "LinearReadout", "beam_decode",
    "beam_gather", "decode_step", "finalize_slots", "greedy_decode",
    "init_slot_carry", "release_slot", "write_slot",
]
