"""Checkpoint save/load — counterpart of ``paddle_tpu/trainer/checkpoint.py``:
the trainer tier's import surface over ``resilience/checkpoint_io.py``
(per-pass ``save_dir/pass-%05d`` directories, the reference's
paddle/trainer/ParamUtil.cpp:50-96 layout, written atomically with a CRC
manifest)."""

from __future__ import annotations

from paddle_tpu_torch.resilience.checkpoint_io import (latest_pass,
                                                       latest_valid_pass,
                                                       load_checkpoint,
                                                       load_pytree, npz_safe,
                                                       read_manifest,
                                                       save_checkpoint,
                                                       save_pytree,
                                                       validate_checkpoint)

__all__ = ["save_pytree", "load_pytree", "save_checkpoint", "load_checkpoint",
           "latest_pass", "latest_valid_pass", "validate_checkpoint",
           "read_manifest", "npz_safe"]
