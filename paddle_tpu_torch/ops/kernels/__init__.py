"""The port's hand-written Hopper kernels, one module each, with their plain
PyTorch versions and launch counters.

==================  ==========================  ==============================
kernel              CUDA source                 replaces (paddle_tpu)
==================  ==========================  ==============================
gru_forward         csrc/gru_forward.cu         ops/pallas_kernels.py
                                                ::_gru_pallas_raw (K3)
topk_lse_readout    csrc/topk_lse_readout.cu    ops/pallas_kernels.py
                                                ::topk_lse_readout_pallas (K7)
==================  ==========================  ==============================

Each wrapper runs its plain version for a CPU tensor and launches its kernel
(or raises) for a CUDA tensor, and counts its launches
(``launch_counts()``).
"""

from paddle_tpu_torch.ops.kernels.build import (LIBRARIES, build_all,
                                                launch_counts,
                                                reset_launch_counts)
from paddle_tpu_torch.ops.kernels.gru import gru_forward, gru_forward_plain
from paddle_tpu_torch.ops.kernels.topk_readout import (
    stable_topk, topk_lse_readout, topk_lse_readout_plain)

__all__ = ["LIBRARIES", "build_all", "launch_counts", "reset_launch_counts",
           "gru_forward", "gru_forward_plain", "topk_lse_readout",
           "topk_lse_readout_plain", "stable_topk"]
