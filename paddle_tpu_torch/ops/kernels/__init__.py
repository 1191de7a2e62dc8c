"""The port's hand-written Hopper kernels, one module each, with their plain
PyTorch versions and launch counters.

==================  ==========================  ==============================
kernel              CUDA source                 replaces (paddle_tpu)
==================  ==========================  ==============================
gru_forward         csrc/gru_forward.cu         ops/pallas_kernels.py
                                                ::_gru_pallas_raw (K3, with
                                                and without residuals)
gru_backward        csrc/gru_backward.cu        ::_gru_bwd_pallas_raw (K4)
ce_readout_fwd      csrc/ce_readout_fwd.cu      ::ce_readout_fwd_pallas (K1)
ce_readout_bwd      csrc/ce_readout_bwd.cu      ::ce_readout_bwd_pallas (K2)
topk_lse_readout    csrc/topk_lse_readout.cu    ::topk_lse_readout_pallas (K7)
topk_lse_logits     csrc/topk_lse_logits.cu     ::topk_lse_logits_pallas (K8)
attn_dec_fwd        csrc/attn_dec_fwd.cu        ::attn_dec_fwd_pallas (K5)
attn_dec_bwd        csrc/attn_dec_bwd.cu        ::attn_dec_bwd_pallas (K6)
lstm_forward        csrc/lstm_forward.cu        ::_lstm_pallas_raw (K9, with
                                                and without residuals)
lstm_backward       csrc/lstm_backward.cu       ::_lstm_bwd_pallas_raw (K10)
bigru_forward       csrc/bigru_forward.cu       ::_gru_pallas_raw with
                                                batch_split (K11, with and
                                                without residuals)
bigru_backward      csrc/bigru_backward.cu      ::_gru_bwd_pallas_raw with
                                                batch_split (K11 reverse)
logsumexp_rows      csrc/logsumexp_rows.cu      ::logsumexp_rows_pallas (K12)
==================  ==========================  ==============================

K3/K4 and K11 share their step kernels, K3 and K11's forward one
persistent kernel and K4 and K11's reverse another
(``csrc/gru_common.cuh``).

Each wrapper runs its plain version for a CPU tensor and launches its kernel
(or raises) for a CUDA tensor, and counts its launches
(``launch_counts()``).
"""

from paddle_tpu_torch.ops.kernels.attention_decoder import (
    attn_dec_bwd, attn_dec_bwd_plain, attn_dec_fwd, attn_dec_fwd_plain)
from paddle_tpu_torch.ops.kernels.bigru import (bigru_backward,
                                                bigru_backward_plain,
                                                bigru_forward,
                                                bigru_forward_plain)
from paddle_tpu_torch.ops.kernels.build import (LIBRARIES, build_all,
                                                launch_counts,
                                                reset_launch_counts)
from paddle_tpu_torch.ops.kernels.ce_readout import (ce_readout_bwd,
                                                     ce_readout_bwd_plain,
                                                     ce_readout_fwd,
                                                     ce_readout_fwd_plain)
from paddle_tpu_torch.ops.kernels.gru import (gru_backward,
                                              gru_backward_plain,
                                              gru_forward, gru_forward_plain)
from paddle_tpu_torch.ops.kernels.logsumexp import (logsumexp_rows,
                                                    logsumexp_rows_plain)
from paddle_tpu_torch.ops.kernels.lstm import (lstm_backward,
                                               lstm_backward_plain,
                                               lstm_forward,
                                               lstm_forward_plain)
from paddle_tpu_torch.ops.kernels.topk_logits import (topk_lse_logits,
                                                      topk_lse_logits_plain)
from paddle_tpu_torch.ops.kernels.topk_readout import (
    stable_topk, topk_lse_readout, topk_lse_readout_plain)

__all__ = ["LIBRARIES", "build_all", "launch_counts", "reset_launch_counts",
           "gru_forward", "gru_forward_plain", "gru_backward",
           "gru_backward_plain", "ce_readout_fwd", "ce_readout_fwd_plain",
           "ce_readout_bwd", "ce_readout_bwd_plain", "topk_lse_readout",
           "topk_lse_readout_plain", "stable_topk", "topk_lse_logits",
           "topk_lse_logits_plain", "attn_dec_fwd",
           "attn_dec_fwd_plain", "attn_dec_bwd", "attn_dec_bwd_plain",
           "lstm_forward", "lstm_forward_plain", "lstm_backward",
           "lstm_backward_plain", "bigru_forward", "bigru_forward_plain",
           "bigru_backward", "bigru_backward_plain", "logsumexp_rows",
           "logsumexp_rows_plain"]
