"""Models of the port (the reference's ``paddle_tpu/models``)."""

from paddle_tpu_torch.models.seq2seq import Seq2SeqAttention, params_from_jax

__all__ = ["Seq2SeqAttention", "params_from_jax"]
