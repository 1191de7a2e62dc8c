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
==================  ==========================  ==============================

Each wrapper runs its plain version for a CPU tensor and launches its kernel
(or raises) for a CUDA tensor, and counts its launches
(``launch_counts()``).
"""

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
from paddle_tpu_torch.ops.kernels.topk_readout import (
    stable_topk, topk_lse_readout, topk_lse_readout_plain)

__all__ = ["LIBRARIES", "build_all", "launch_counts", "reset_launch_counts",
           "gru_forward", "gru_forward_plain", "gru_backward",
           "gru_backward_plain", "ce_readout_fwd", "ce_readout_fwd_plain",
           "ce_readout_bwd", "ce_readout_bwd_plain", "topk_lse_readout",
           "topk_lse_readout_plain", "stable_topk"]
