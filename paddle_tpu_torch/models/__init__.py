"""Models of the port (the reference's ``paddle_tpu/models``)."""

from paddle_tpu_torch.models.seq2seq import Seq2SeqAttention
from paddle_tpu_torch.models.text import lstm_benchmark_net
from paddle_tpu_torch.param.convert import params_from_jax

__all__ = ["Seq2SeqAttention", "lstm_benchmark_net", "params_from_jax"]
