"""paddle_tpu_torch — the PyTorch/CUDA port of ``paddle_tpu`` for NVIDIA Hopper.

The JAX package ``paddle_tpu`` stays the reference; this package is its
counterpart on an H100, ported slice by slice (ROADMAP.md): seq2seq
generation served through the slot table, and the flagship's training step:

    models.Seq2SeqAttention       encoder + attention-GRU decoder, beam
                                  search, the teacher-forced ``loss``
    param.Adam                    the optimizer of the training step
    serving.Seq2SeqSlotBackend    the flagship behind the slot protocol
    serving.SlotScheduler         continuous batching over the slot table

Every Pallas kernel on that path is a hand-written CUDA kernel under
``csrc/`` (built at first use, see ``ops/kernels/build.py``).  Entry points
run on ``cuda`` unless the caller passes ``device="cpu"``; on the CPU each
kernel wrapper runs its plain PyTorch version, which is how the tests run.

The package imports torch and numpy only — never jax, never ``paddle_tpu``.
"""

from paddle_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
