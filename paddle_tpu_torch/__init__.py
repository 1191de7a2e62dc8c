"""paddle_tpu_torch — the PyTorch/CUDA port of ``paddle_tpu`` for NVIDIA Hopper.

The JAX package ``paddle_tpu`` stays the reference; this package is its
counterpart on an H100, ported slice by slice (ROADMAP.md).  Its entry points:

    models.Seq2SeqAttention       encoder + attention-GRU decoder, beam
                                  search, the teacher-forced ``loss``
    models.resnet_cifar, ...      the image models (LeNet-5, SmallNet,
                                  ResNet, VGG, AlexNet, GoogLeNet)
    nn.Topology                   the layer DSL's graph
    trainer.SGDTrainer            the training loop: events, the
                                  bad-step guard, checkpoints, resume
    param                         the optimizers and schedules
    serving.InferenceServer       the served entry point over
    serving.SlotScheduler         continuous batching over the slot table
    config                        model config serialization and deploy
                                  bundles (merge_model, load_inference_model)

and the command line ``python -m paddle_tpu_torch --job=train|test|
checkgrad|time --config=CONF.py [--device=cpu]`` with its ``data`` and
``serve`` subcommands.

Every Pallas kernel on that path is a hand-written CUDA kernel under
``csrc/`` (built at first use, see ``ops/kernels/build.py``).  Entry points
run on ``cuda`` unless the caller passes ``device="cpu"``; on the CPU each
kernel wrapper runs its plain PyTorch version, which is how the tests run.

The package imports torch and numpy only — never jax, never ``paddle_tpu``,
never ``google.protobuf`` or ``ml_dtypes``.
"""

from paddle_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
