"""Models of the port (the reference's ``paddle_tpu/models``)."""

from paddle_tpu_torch.models.image_bench import alexnet, googlenet
from paddle_tpu_torch.models.recommender import (ML_SCHEMA,
                                                 movielens_feature_net,
                                                 movielens_net)
from paddle_tpu_torch.models.seq2seq import Seq2SeqAttention
from paddle_tpu_torch.models.text import (convolution_net,
                                          lstm_benchmark_net,
                                          stacked_lstm_net,
                                          stacked_lstm_pp_net)
from paddle_tpu_torch.models.vision import (lenet5, resnet_cifar, smallnet,
                                            vgg_cifar)
from paddle_tpu_torch.param.convert import params_from_jax

__all__ = ["Seq2SeqAttention", "stacked_lstm_net", "stacked_lstm_pp_net",
           "convolution_net", "lstm_benchmark_net", "params_from_jax",
           "lenet5", "smallnet", "resnet_cifar", "vgg_cifar", "alexnet",
           "googlenet", "movielens_net", "movielens_feature_net",
           "ML_SCHEMA"]
