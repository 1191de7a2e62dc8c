#!/usr/bin/env python3
"""Opt-in measurements of the PyTorch/H100 port beside ``chip_smoke.py``.

    python3 chip_probe.py [chunks] [profile]      (both when none is named)

Needs one CUDA card and the checkout beside it.  It checks nothing that
``chip_smoke.py`` does not; it measures what the smoke run leaves out to
stay short:

chunks   the chunk sizes of the batch-invariant products (``ops/matmul.py``:
         ``ROW_CHUNK``, ``VECTOR_ROW_CHUNK``, ``BATCH_CHUNK``) against one
         cuBLAS call a product (``unchunked``, what the products did before
         they were chunked).  For each setting, the full-width serve path
         (96 requests through 64 slots, beam 3, bf16) and training steps
         (B=384, S=T=32, bf16, Adam), the settings run in order and then in
         reverse so that each has two samples from one process;
profile  one training step at that batch under ``torch.profiler`` (CUDA
         activity only): the device's kernel time against the step's host
         time (the device's busy share) and the kernels with the most
         device time.

Prints one line per measurement and the card line first.
"""

from __future__ import annotations

import sys
import time

import chip_smoke as smoke

#: product chunk settings: (ROW_CHUNK, VECTOR_ROW_CHUNK, BATCH_CHUNK), or
#: None for one cuBLAS call a product
SETTINGS = {
    "unchunked": None,
    "r1024/v1024/b64": (1024, 1024, 64),
    "r1024/v6144/b64": (1024, 6144, 64),
    "r384/v6144/b64": (384, 6144, 64),
    "r384/v6144/b192": (384, 6144, 192),
    "r192/v6144/b192": (192, 6144, 192),
}
TRAIN_TIMED = 3


def _apply(setting, M, default_chunked):
    """Set the product chunking of ``ops/matmul.py`` (module globals, read
    at each call)."""
    if setting is None:
        M._chunked = lambda fn, a, chunk, *rest: fn(a, *rest)
        return
    M._chunked = default_chunked
    M.ROW_CHUNK, M.VECTOR_ROW_CHUNK, M.BATCH_CHUNK = setting


def _train_setup(dev):
    import numpy as np
    import torch

    from paddle_tpu_torch.models import Seq2SeqAttention
    from paddle_tpu_torch.param import Adam

    model = Seq2SeqAttention(device=dev)
    params = {k: v.requires_grad_()
              for k, v in model.init(seed=smoke.SEED).items()}
    batch = smoke.train_batch(np.random.RandomState(smoke.SEED), model,
                              smoke.TRAIN_B, smoke.TRAIN_S, smoke.TRAIN_T,
                              mixed=False)
    opt = Adam(learning_rate=1e-3)
    state = opt.init_state(params)

    def step():
        loss = model.loss(params, batch)
        grads = torch.autograd.grad(loss, list(params.values()))
        opt.update(params, dict(zip(params, grads)), state)
        return loss

    return model, step


def _step_seconds(step) -> float:
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step().item()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def probe_chunks(dev):
    import numpy as np
    import torch

    import importlib

    from paddle_tpu_torch.models import Seq2SeqAttention
    from paddle_tpu_torch.serving import Seq2SeqSlotBackend, SlotScheduler

    # the module (the package's ``matmul`` attribute is the function)
    M = importlib.import_module("paddle_tpu_torch.ops.matmul")

    default_chunked = M._chunked
    defaults = (M.ROW_CHUNK, M.VECTOR_ROW_CHUNK, M.BATCH_CHUNK)
    model = Seq2SeqAttention(device=dev)
    params = model.init(seed=smoke.SEED)
    _, train_step = _train_setup(dev)
    _step_seconds(train_step)                       # first step: warm-up
    serve_s = {name: [] for name in SETTINGS}
    train_ms = {name: [] for name in SETTINGS}
    order = list(SETTINGS) + list(reversed(SETTINGS))

    def serve_seconds(name):
        reqs, _ = smoke.make_requests(np.random.default_rng(smoke.SEED),
                                      model.src_vocab)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        backend = Seq2SeqSlotBackend(model, params, src_len=smoke.SRC_LEN,
                                     beam_size=smoke.BEAM,
                                     max_len=smoke.MAX_LEN)
        results, _ = smoke.serve(SlotScheduler(backend, slots=smoke.SLOTS),
                                 reqs)
        torch.cuda.synchronize()
        if len(results) != smoke.N_REQUESTS:
            smoke.fail("chunks", f"{name}: {len(results)} requests answered")
        return time.perf_counter() - t0

    serve_seconds("warm-up")
    for name in order:
        _apply(SETTINGS[name], M, default_chunked)
        serve_s[name].append(serve_seconds(name))
        secs = sorted(_step_seconds(train_step) for _ in range(TRAIN_TIMED))
        train_ms[name].append(secs[len(secs) // 2] * 1e3)
    M._chunked = default_chunked
    M.ROW_CHUNK, M.VECTOR_ROW_CHUNK, M.BATCH_CHUNK = defaults
    print(f"chunks: module defaults r{defaults[0]}/v{defaults[1]}/"
          f"b{defaults[2]}; each setting in order, then in reverse; serve = "
          f"{smoke.N_REQUESTS} requests through {smoke.SLOTS} slots (host s, "
          f"card synchronised); train = median of {TRAIN_TIMED} steps at "
          f"B={smoke.TRAIN_B} S=T={smoke.TRAIN_T} bf16 Adam", flush=True)
    for name in SETTINGS:
        print(f"chunks: {name}: serve s {[round(x, 4) for x in serve_s[name]]}"
              f", train step ms {[round(x, 2) for x in train_ms[name]]}",
              flush=True)


def probe_profile(dev):
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    _, step = _train_setup(dev)
    warm = [_step_seconds(step) for _ in range(3)]
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        step().item()
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t1
    events = prof.key_averages()
    probe_s = time.perf_counter() - t0
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and not e.is_user_annotation]
    if not kernels:
        smoke.fail("profile", "the profiler recorded no device time")
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    print(f"profile: one training step at B={smoke.TRAIN_B} S=T="
          f"{smoke.TRAIN_T} bf16 under torch.profiler (CUDA activity): "
          f"host {step_s * 1e3:.2f} ms (unprofiled steps "
          f"{[round(x * 1e3, 2) for x in warm]} ms), device kernel time "
          f"{device_ms:.2f} ms = {device_ms / (step_s * 1e3):.1%} of the "
          f"profiled step (the device's busy share); profiler set-up and "
          f"read-out {probe_s - step_s:.2f} s", flush=True)
    for e in top:
        print(f"profile:   {e.self_device_time_total / 1e3:9.3f} ms "
              f"x{e.count:<5d} {e.key[:90]}", flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: chip_probe.py runs on the card only",
              file=sys.stderr)
        return 2
    from paddle_tpu_torch.ops import kernels as K

    wanted = sys.argv[1:] or ["chunks", "profile"]
    unknown = set(wanted) - {"chunks", "profile"}
    if unknown:
        print(f"unknown probe(s) {sorted(unknown)}", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    print(f"card: {smoke.card_line()}", flush=True)
    K.build_all()
    if "chunks" in wanted:
        probe_chunks(dev)
    if "profile" in wanted:
        probe_profile(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
