"""Device resolution for the port's entry points.

Entry points (``Seq2SeqAttention``, ``params_from_jax``) run on ``cuda``
unless the caller asks for another device.  Without a card they raise: a
run that asked for the GPU never drops quietly to the CPU.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device"]


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` -> ``cuda``.  Raises if a CUDA device is asked for and none
    is present.  On CUDA, float32 matmuls and convolutions are pinned to
    full float32 (no TF32), so that a float32 compute policy means float32
    on the card as it does in the reference.

    ``torch.backends.cudnn.deterministic`` is left as PyTorch sets it
    (off): the image models' convolutions and pools train bit for bit the
    same from one initialisation without it on an H100, and resume so
    from a checkpoint (``chip_probe.py vision``, ``chip_smoke.py``'s
    vision phase), which the trainer's bit-for-bit resume relies on."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is present; pass device='cpu' to run the "
                "plain PyTorch versions of the kernels")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev
