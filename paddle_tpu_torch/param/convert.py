"""Parameters carried across from the JAX package.

Every model of the port keeps the reference's parameter names and layouts
(``[in, out]`` matrices, the reference's gate orders; the nn DSL's
``_{layer}.w0``-style names), so one function serves them all: a JAX
parameter dict, as numpy arrays, becomes the port's float32 tensors.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Union

import numpy as np
import torch

from paddle_tpu_torch.device import resolve_device

__all__ = ["params_from_jax"]


def params_from_jax(np_params: Mapping[str, np.ndarray],
                    device: Optional[Union[str, torch.device]] = None
                    ) -> Dict[str, torch.Tensor]:
    """The JAX package's parameter dict (``{k: np.asarray(v)}`` of a
    model's or a ``Topology``'s ``init``) as the port's float32 tensors on
    ``device`` (default ``cuda``), with the same names and layouts."""
    dev = resolve_device(device)
    return {k: torch.from_numpy(np.array(v, np.float32)).to(dev)
            for k, v in np_params.items()}
