"""``paddle_tpu_torch.trainer`` — the training loop (the reference's
``paddle_tpu/trainer``): ``SGDTrainer`` on one device, its events, the
checkpoint surface and ``check_gradients``."""

from paddle_tpu_torch.trainer import events
from paddle_tpu_torch.trainer.checkgrad import check_gradients
from paddle_tpu_torch.trainer.checkpoint import (latest_pass,
                                                 latest_valid_pass,
                                                 load_checkpoint, load_pytree,
                                                 read_manifest,
                                                 save_checkpoint, save_pytree,
                                                 validate_checkpoint)
from paddle_tpu_torch.trainer.trainer import SGDTrainer

__all__ = ["SGDTrainer", "events", "check_gradients", "save_checkpoint",
           "load_checkpoint", "save_pytree", "load_pytree", "latest_pass",
           "latest_valid_pass", "validate_checkpoint", "read_manifest"]
