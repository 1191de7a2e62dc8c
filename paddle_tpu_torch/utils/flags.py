"""The port's settings: only the flags the ported slice reads.

Counterpart of ``paddle_tpu/utils/flags.py`` for this slice.  The port reads
its own settings, never the JAX package's flags or its environment
variables.  ``PADDLE_TPU_TORCH_COMPUTE_DTYPE`` overrides the compute dtype
at import (the reference's ``PADDLE_TPU_COMPUTE_DTYPE`` analogue).

There is no ``use_pallas_*`` flag: on the card a kernel always runs, and
on the CPU its plain PyTorch version runs.  ``max_gen_length`` is not here:
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


FLAGS = Flags(
    compute_dtype=os.environ.get("PADDLE_TPU_TORCH_COMPUTE_DTYPE",
                                 "bfloat16"))
