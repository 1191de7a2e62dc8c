"""The port's settings: only the flags the ported slice reads.

Counterpart of ``paddle_tpu/utils/flags.py`` for this slice.  The port reads
its own settings, never the JAX package's flags or its environment
variables.  ``PADDLE_TPU_TORCH_COMPUTE_DTYPE`` overrides the compute dtype
at import (the reference's ``PADDLE_TPU_COMPUTE_DTYPE`` analogue).

No flag chooses a plain version: on the card a kernel always runs, and on
the CPU its plain PyTorch version runs.  ``fused_bigru`` (the reference's
``use_pallas_bigru``, off by default as there) chooses between two kernel
paths for a bidirectional GRU layer: two one-direction loops (K3/K4) or one
loop over both directions (K11).  The reference's other conditions for its
fused path (``use_pallas_rnn``, the TPU backend, ``H % 128``, ``2B % 8``,
the VMEM cap) are TPU rules and are not ported: the port's kernel takes
any B and H.  ``max_gen_length`` is not here:
no module of either package reads it (the reference defines it for its
CLI surface, which a later slice ports).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

__all__ = ["FLAGS", "Flags"]


@dataclass
class Flags:
    #: matmul operand dtype (``float32`` or ``bfloat16``); accumulation is
    #: always float32
    compute_dtype: str = "bfloat16"
    #: beam/greedy decode stops its token loop once every beam emitted EOS
    decode_early_exit: bool = True
    #: default beam width of the slot backend (the reference's default)
    beam_size: int = 3
    #: a bidirectional GRU layer runs both directions in one time loop
    #: (K11, ``ops/rnn_fused.py::bigru_sequence_fused``) instead of two
    fused_bigru: bool = False


FLAGS = Flags(
    compute_dtype=os.environ.get("PADDLE_TPU_TORCH_COMPUTE_DTYPE",
                                 "bfloat16"))
