"""paddle_tpu_torch.ops — the op tier of the port, under the reference's
names (``paddle_tpu/ops``).  Plain PyTorch functions on tensors; the hand-
written kernels live in ``ops/kernels`` and are reached through
``gru_layer``, ``bigru_layer`` and ``lstm_layer`` (forward and backward),
``LinearReadout``, ``LogitsReadout``, ``attention_gru_decoder`` and
``sequence_softmax_ce_readout``.  The image tier (``conv.py``: conv,
pooling, batch norm, LRN, resize, maxout), ``misc.py`` (with the sampling
layers' draws), the sequence ops, the CRF (``crf.py``), the sparse products
(``sparse.py``), CTC (``ctc.py``) and the cost family run PyTorch's own
ops, as the reference runs XLA's outside any Pallas kernel."""

from paddle_tpu_torch.ops.numerics import (acc_dtype, bwd_einsum, bwd_mm,
                                           compute_dtype,
                                           compute_dtype_scope, dot_dtype,
                                           mxu_cast, residual_dtype)
from paddle_tpu_torch.ops.matmul import linear, matmul
from paddle_tpu_torch.ops.activations import (ACTIVATIONS, get_activation,
                                              sequence_softmax, softmax)
from paddle_tpu_torch.ops.conv import (avg_pool2d, batch_norm,
                                       bilinear_interp, cmr_norm, conv2d,
                                       conv2d_transpose, global_avg_pool,
                                       max_pool2d, maxout)
from paddle_tpu_torch.ops.misc import (batch_transpose, categorical,
                                       col_sum, cos_sim, dropout,
                                       interpolation, max_id, outer_prod,
                                       power_op, row_max, row_sum, scaling,
                                       slope_intercept, sum_cost,
                                       tensor_bilinear, top_k,
                                       uniform_classes)
from paddle_tpu_torch.ops.embedding import embedding_lookup, one_hot
from paddle_tpu_torch.ops.sparse import (CscMatrix, CsrMatrix, csr_matmul,
                                         matmul_dense_csc,
                                         selective_columns_matmul,
                                         sparse_gather_matmul,
                                         sparse_to_dense)
from paddle_tpu_torch.ops.sequence import (context_projection,
                                           context_projection_trainable,
                                           mask_from_lengths, seq_concat,
                                           seq_expand, seq_first, seq_last,
                                           seq_pool_avg, seq_pool_max,
                                           seq_pool_sqrt, seq_pool_sum,
                                           seq_reverse, seq_slice_window,
                                           PACK_KEYS, segment_expand,
                                           segment_first, segment_last,
                                           segment_pool, segment_starts,
                                           segment_valid)
from paddle_tpu_torch.ops.attention import (additive_attention_scores, attend,
                                            dot_product_attention)
from paddle_tpu_torch.ops.crf import crf_decode, crf_log_likelihood, crf_nll
from paddle_tpu_torch.ops.ctc import ctc_loss
from paddle_tpu_torch.ops.rnn import (bigru_layer, gru_layer, gru_step,
                                      lstm_layer, lstm_step, scan_rnn)
from paddle_tpu_torch.ops.rnn_fused import (bigru_sequence_fused,
                                            gru_sequence_fused,
                                            lstm_sequence_fused)
from paddle_tpu_torch.ops.attention_decoder import attention_gru_decoder
from paddle_tpu_torch.ops.losses import (binary_cross_entropy, cross_entropy,
                                         huber, masked_token_mean, mse,
                                         multi_binary_label_cross_entropy,
                                         rank_cost, sequence_cross_entropy,
                                         sequence_softmax_ce_readout,
                                         smooth_l1, soft_cross_entropy)
from paddle_tpu_torch.ops.decode import (NEG, LinearReadout, LogitsReadout,
                                         beam_decode, beam_gather, decode_step,
                                         extract_slot, finalize_slots,
                                         greedy_decode, init_slot_carry,
                                         release_slot, restore_slot,
                                         spec_verify_step, write_slot)
from paddle_tpu_torch.ops.speculative import (AdversarialProposer,
                                              CallableDraftProposer,
                                              DraftProposer, NGramProposer)

__all__ = [
    "acc_dtype", "compute_dtype", "compute_dtype_scope", "dot_dtype",
    "mxu_cast", "bwd_mm", "bwd_einsum", "residual_dtype", "linear", "matmul",
    "ACTIVATIONS", "get_activation", "softmax", "sequence_softmax",
    "conv2d", "conv2d_transpose", "max_pool2d", "avg_pool2d", "batch_norm",
    "cmr_norm", "bilinear_interp", "maxout", "global_avg_pool",
    "row_sum", "row_max", "col_sum", "top_k", "max_id",
    "batch_transpose", "cos_sim", "interpolation", "outer_prod",
    "tensor_bilinear", "sum_cost", "scaling", "slope_intercept", "power_op",
    "dropout", "uniform_classes", "categorical",
    "embedding_lookup", "one_hot", "sparse_gather_matmul", "sparse_to_dense",
    "selective_columns_matmul", "CsrMatrix", "CscMatrix", "csr_matmul",
    "matmul_dense_csc", "mask_from_lengths", "seq_first",
    "seq_last", "seq_pool_sum", "seq_pool_avg", "seq_pool_sqrt",
    "seq_pool_max", "seq_expand", "seq_reverse", "seq_concat",
    "context_projection", "context_projection_trainable",
    "seq_slice_window", "PACK_KEYS", "segment_valid", "segment_starts",
    "segment_pool", "segment_last", "segment_first", "segment_expand",
    "additive_attention_scores", "attend",
    "dot_product_attention", "crf_log_likelihood", "crf_nll", "crf_decode", "ctc_loss",
    "bigru_layer", "gru_layer", "gru_step", "lstm_layer",
    "lstm_step", "scan_rnn", "gru_sequence_fused", "bigru_sequence_fused",
    "lstm_sequence_fused",
    "attention_gru_decoder", "cross_entropy", "soft_cross_entropy",
    "binary_cross_entropy", "multi_binary_label_cross_entropy", "mse",
    "huber", "smooth_l1", "rank_cost", "masked_token_mean",
    "sequence_cross_entropy", "sequence_softmax_ce_readout", "NEG",
    "LinearReadout", "LogitsReadout", "beam_decode", "beam_gather",
    "decode_step", "finalize_slots", "greedy_decode", "init_slot_carry",
    "release_slot", "write_slot", "spec_verify_step", "extract_slot",
    "restore_slot", "DraftProposer", "NGramProposer",
    "CallableDraftProposer", "AdversarialProposer",
]
