#!/usr/bin/env python3
"""Opt-in measurements of the PyTorch/H100 port beside ``chip_smoke.py``.

    python3 chip_probe.py [chunks] [profile] [textclf] [dslgen] [k8plans]
                          [k8variants] [variants] [vision] [text] [sparse]
                          [seqdata] [frontdoor] [dataio] [delivery]
                          [parallel] [build]
                          (all if none named)

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
         activity only), in the default and the ``fused_bigru``
         configuration: the device's kernel time against the step's host
         time (the device's busy share) and the kernels with the most
         device time;
textclf  the same for one training step of the text-classification path
         (``lstm_benchmark_net`` through ``nn.Topology``, B=64, T=100,
         bf16, Adam) at each of its widths (H=256, H=1280);
dslgen   the same for one generation call of ``chip_smoke.py``'s dslgen
         phase (the demo/seqToseq net's ``beam_search`` layer, 64 sources,
         beam 3, 32 steps, bf16), K8's kernels listed wherever they rank;
k8plans  K8 (top-k + logsumexp over logits) at the DSL generation's
         readout (N = 192, V = 30000, k = 3, f32 and bf16) under every plan
         of 1, 2, 4 or 8 blocks a row and chunks of 8 to 64 KB, at the
         committed 256 threads a block and in edited copies of its source
         built for 128 and 512: the device time of one call replayed from a
         CUDA graph (L2 flushed) and of 20 calls back to back in one graph
         (L2 warm), in turns (forward, then backward), and whether ids and
         values equal the plain version's; the measurement ``_k8_plan``
         was chosen by;
k8variants where K8 spends its time at that readout: edited copies of
         its source, each with a piece of its top-k or logsumexp work
         switched off at compile time (results wrong by design), timed in
         turns with the copy as committed, twice;
variants where the persistent K3 (the GRU forward loop: K3r at B=384
         and K3 at B=64, T=32, H=512, bf16; K11r at 2x384 on the same
         kernel), K4 (the GRU reverse loop, B=384, T=32, H=512) and K5
         (the decoder forward, T=32, B=384, S=32, D=A=512, bf16) spend
         their time: edited copies of their sources, each with one phase
         switched off at compile time (their results are wrong by
         design), built into ``paddle_tpu_torch/_build/variants`` and
         timed in turns with the copy as committed, twice;
vision   the image tier (``chip_smoke.py``'s vision rows, bf16,
         Momentum): resnet20_b256's step with ``torch.backends.cudnn.
         deterministic`` off and on, in turns (off, on, on, off), 6 steps
         each from one initialisation, with whether two runs from it give
         the same losses bit for bit (and for each other row, two runs of
         3 steps); then one profiled step of each row
         (device busy share, the kernels with the most device time);
text     the text tier (``chip_smoke.py``'s text parts, bf16,
         ``SGDTrainer(cost, Adam).train_batch`` on the part's first batch):
         one profiled step of seqtoseq_group, sentiment
         (``stacked_lstm_net``), bidi_lstm and srl (``db_lstm``), each
         after three unprofiled ones (device busy share, the kernels with
         the most device time);
sparse   the sparse and sampled-cost tier (``chip_smoke.py``'s sparse
         parts at their widths, bf16, ``SGDTrainer(...).train_batch`` on
         the part's first batch): one profiled step of the recommender
         (``movielens_feature_net``, ``movielens_net(sparse_grad=True)``),
         the sparse LR, word2vec with hsigmoid and with NCE, and the CTC
         net, each after three unprofiled ones (device busy share, the
         kernels with the most device time);
seqdata  the seqdata phase (``chip_smoke.py`` phase 15, bf16,
         ``SGDTrainer(Adam(1e-3)).train_batch``): one profiled step of the
         packing A/B's bucketed and packed arms and of the nested net,
         each after three unprofiled ones (device busy share, the kernels
         with the most device time);
frontdoor ``chip_smoke.py``'s phase 18 (the seqToseq demo copy and the
         v2 seqToseq script at the WMT14 widths) alone, then one profiled
         training step of each and one profiled ``paddle.infer`` of the v2
         generator (device busy share, the kernels with the most device
         time);
dataio   ``chip_smoke.py``'s phase 19 (the provider-fed textclf training
         over a real-format aclImdb tarball, the seqToseq demo over a
         real-format wmt14.tgz) alone, then one profiled
         ``SGDTrainer.train_batch`` of lstm_b64h256 (bf16) on the
         provider's first batch (device busy share, the kernels with the
         most device time), and the feeder's host ms a batch of 64 imdb
         rows (max_len 100) through the native pad core and through the
         Python loop, in turns (native, loop, loop, native);
delivery ``chip_smoke.py``'s phase 20 (train, scrub and publish; hot
         reload under closed-loop load; the warm boot from the publish
         dir's compile cache in fresh processes; the fleet, its tenants, a
         killed canary and the router) alone;
parallel ``chip_smoke.py``'s phase 21 (data parallelism and the pserver
         tier in launched worlds of ranks on this card: the command line
         at lstm_b64h256 on 2 gloo ranks, bf16 and f32; the flagship's
         data-parallel step; a world of 1 under NCCL; movielens with its
         tables on ``model=2``) alone;
build    cold builds of the kernel libraries into a scratch directory:
         each source alone, one ``nvcc`` at a time, then all at once as
         ``build_all`` starts them (the smoke run's build time).

Prints one line per measurement and the card line first.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
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


def _textclf_setup(dev, hidden: int):
    """One ``bench.py::_topology_step``-style step of ``chip_smoke.py``'s
    textclf phase at width ``hidden``."""
    import torch

    from paddle_tpu_torch.param import Adam

    topo, cost = smoke.textclf_net(hidden, dev)
    params, state = topo.init(smoke.SEED)
    params = {k: v.requires_grad_() for k, v in params.items()}
    feed = smoke.textclf_feed(smoke.TEXTCLF_B, smoke.TEXTCLF_T, smoke.SEED)
    opt = Adam(learning_rate=1e-3)
    opt_state = opt.init_state(params)

    def step():
        outs, _ = topo.apply(params, state, feed, train=True)
        loss = outs[cost.name].value
        grads = torch.autograd.grad(loss, list(params.values()))
        opt.update(params, dict(zip(params, grads)), opt_state)
        return loss

    return step


def _profile_step(label: str, step, top_n: int = 8, keep: str = "") -> None:
    """Three unprofiled steps, then one under ``torch.profiler`` (CUDA
    activity): device kernel time against the step's host time; the
    ``top_n`` kernels with the most device time, and besides them every
    kernel whose name holds ``keep`` (where given)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

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
    ranked = sorted(kernels, key=lambda e: -e.self_device_time_total)
    top = ranked[:top_n] + [e for e in ranked[top_n:]
                            if keep and keep in e.key]
    print(f"profile: {label} under torch.profiler (CUDA activity): "
          f"host {step_s * 1e3:.2f} ms (unprofiled steps "
          f"{[round(x * 1e3, 2) for x in warm]} ms), device kernel time "
          f"{device_ms:.2f} ms = {device_ms / (step_s * 1e3):.1%} of the "
          f"profiled step (the device's busy share); "
          f"{sum(e.count for e in kernels)} kernels; profiler set-up and "
          f"read-out {probe_s - step_s:.2f} s", flush=True)
    for e in top:
        print(f"profile:   {e.self_device_time_total / 1e3:9.3f} ms "
              f"x{e.count:<5d} {e.key[:90]}", flush=True)


def probe_profile(dev):
    _, step = _train_setup(dev)
    for config in ("default", "fused_bigru"):
        with smoke.train_config(config):
            _profile_step(f"one training step at B={smoke.TRAIN_B} S=T="
                          f"{smoke.TRAIN_T} bf16, {config}", step, top_n=20)


def probe_textclf(dev):
    for hidden in smoke.TEXTCLF_HIDDEN:
        _profile_step(f"one textclf training step lstm_b{smoke.TEXTCLF_B}"
                      f"h{hidden} (T={smoke.TEXTCLF_T}, bf16)",
                      _textclf_setup(dev, hidden), top_n=12)


def _vision_setup(dev, row):
    """One direct-loop step of ``chip_smoke.py``'s vision ``row`` from
    ``Topology.init(SEED)``: -> step (returns the loss)."""
    import torch

    import paddle_tpu_torch.nn as nn
    from paddle_tpu_torch.param import Momentum

    _, model, kwargs, B, side, classes, lr, _ = row
    cost, logits = smoke.vision_net(model, kwargs)
    topo = nn.Topology([cost, logits], device=dev)
    params, state = topo.init(smoke.SEED)
    params = {k: v.requires_grad_() for k, v in params.items()}
    feed = smoke.vision_feed(B, side, classes, smoke.SEED, dev)
    opt = Momentum(learning_rate=lr)
    ost = opt.init_state(params)
    carry = {"state": state}

    def step():
        outs, carry["state"] = topo.apply(params, carry["state"], feed,
                                          train=True)
        loss = outs[cost.name].value
        grads = torch.autograd.grad(loss, list(params.values()))
        opt.update(params, dict(zip(params, grads)), ost)
        return loss

    return step


def probe_vision(dev):
    import torch

    row = smoke.VISION_ROWS[0]
    keep = torch.backends.cudnn.deterministic
    runs = {False: [], True: []}
    for det in (False, True, True, False):
        torch.backends.cudnn.deterministic = det
        step = _vision_setup(dev, row)
        secs, losses = [], []
        for _ in range(smoke.TRAIN_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(step().item())
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        rest = sorted(secs[1:])
        runs[det].append(losses)
        print(f"vision: {row[0]} cudnn.deterministic={det}: median of steps "
              f"2-{smoke.TRAIN_STEPS} {rest[len(rest) // 2] * 1e3:.3f} "
              f"ms/step (min {rest[0] * 1e3:.3f}, max {rest[-1] * 1e3:.3f}),"
              f" losses {losses}", flush=True)
        del step
        torch.cuda.empty_cache()
    for det, (a, b) in runs.items():
        print(f"vision: cudnn.deterministic={det}: two runs from one "
              f"initialisation {'bit for bit' if a == b else 'DIFFER'} "
              f"(max rel diff "
              f"{max(abs(x - y) / abs(y) for x, y in zip(a, b)):.3e})",
              flush=True)
    torch.backends.cudnn.deterministic = keep
    for row in smoke.VISION_ROWS[1:]:
        twice = []
        for _ in range(2):
            step = _vision_setup(dev, row)
            twice.append([step().item() for _ in range(3)])
            del step
        print(f"vision: {row[0]} cudnn.deterministic={keep}: two runs of 3 "
              f"steps from one initialisation "
              f"{'bit for bit' if twice[0] == twice[1] else 'DIFFER'} "
              f"({twice[0]} / {twice[1]})", flush=True)
        torch.cuda.empty_cache()
    for row in smoke.VISION_ROWS:
        _profile_step(f"one {row[0]} training step (bf16, Momentum, "
                      f"cudnn.deterministic={keep})",
                      _vision_setup(dev, row), top_n=20 if row is
                      smoke.VISION_ROWS[0] else 10)
        torch.cuda.empty_cache()


def probe_dslgen(dev):
    import torch

    import paddle_tpu_torch.nn as nn
    from paddle_tpu_torch.ops.numerics import compute_dtype_scope

    topo = nn.Topology(smoke.dslgen_net(), device=dev)
    params, _ = topo.init(smoke.SEED)
    feed = smoke.dslgen_feed(smoke.DSLGEN_B, smoke.SEED)

    def step():
        with compute_dtype_scope("bfloat16"), torch.no_grad():
            outs, _ = topo.apply(params, {}, feed)
        return outs["gen"].state["scores"][0, 0]

    _profile_step(f"one DSL generation call ({smoke.DSLGEN_B} sources, beam "
                  f"{smoke.BEAM}, max_length {smoke.MAX_LEN}, bf16)", step,
                  top_n=12, keep="topk")


#: the K8 plans ``k8plans`` times: blocks a row and bytes of a staged
#: chunk; and the block widths of edited copies it times them at besides
#: the committed 256 threads
K8_CLUSTERS, K8_CHUNKS = (1, 2, 4, 8), (8192, 16384, 32768, 65536)
K8_WIDTHS = {128: ("K8_T128",), 512: ("K8_T512",)}


def _stream_ms(fn, calls: int = 20) -> float:
    """Device time a call of ``calls`` calls captured back to back in one
    CUDA graph and replayed, L2 not flushed (a decode step's logits were
    just written, and 23 MB stay in the 50 MB L2)."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    graph.replay()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / calls


def probe_k8plans(dev):
    import torch

    from paddle_tpu_torch.ops.kernels import build as B
    from paddle_tpu_torch.ops.kernels import topk_logits as TL

    built = _build_variants(B, (("topk_lse_logits", "topk_lse_logits.cu",
                                 K8_WIDTHS),))
    lib = TL.TOPK_LSE_LOGITS
    committed = lib._lib
    builds = {TL._THREADS: None, **{t: built[("topk_lse_logits", t)]
                                    for t in K8_WIDTHS}}
    N, V, k = smoke.DSLGEN_B * smoke.BEAM, smoke.DSLGEN_VOCAB, smoke.BEAM
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=dev)
    g = torch.Generator().manual_seed(smoke.SEED + 7)
    x32 = torch.randn(N, V, generator=g).to(dev)
    for dt in (torch.float32, torch.bfloat16):
        x = x32.to(dt)
        pv, pi, pl = TL.topk_lse_logits_plain(x, k)
        runs = [(t, p) for t in builds for p in dict.fromkeys(
            TL._plan_for(V, dt, c, b) for c in K8_CLUSTERS
            for b in K8_CHUNKS)]
        times = {r: [] for r in runs}
        checks = {}
        for order in (runs, runs[::-1]):
            for t, p in order:
                if builds[t] is None:
                    lib._lib = committed
                else:
                    _load_as(lib, builds[t])
                kv, ki, kl = TL._launch(x, k, p)
                torch.cuda.synchronize()
                checks[(t, p)] = (torch.equal(kv, pv) and torch.equal(ki, pi),
                                  (kl - pl).abs().max().item())
                times[(t, p)].append((
                    smoke.graph_ms(lambda: TL._launch(x, k, p), flush),
                    _stream_ms(lambda: TL._launch(x, k, p))))
        lib._lib = committed
        chosen = (TL._THREADS, TL._k8_plan(V, dt))
        for t, p in runs:
            same, err = checks[(t, p)]
            (g1, s1), (g2, s2) = times[(t, p)]
            print(f"k8plans: {str(dt)[6:]} N={N} V={V} k={k} C="
                  f"{p.clusters} T={t} S={p.slice} CH={p.chunk}: "
                  f"device ms (one call, L2 flushed) {g1:.5f} / {g2:.5f}, "
                  f"(20 calls back to back) {s1:.5f} / {s2:.5f}"
                  f"{' (_k8_plan)' if (t, p) == chosen else ''}; ids and "
                  f"values identical {same}, lse max abs err {err:.2e}",
                  flush=True)


#: the edits of ``variants``: each puts one phase of the persistent K3 or
#: K4 (``csrc/gru_common.cuh``) or K5 (``csrc/attn_dec_fwd.cu``) under a
#: compile-time switch that is 0 in the copy as committed
VARIANT_EDITS = {
    "gru_common.cuh": [
        ("      pk::warp_product(hb_d,",
         "      if (!NO_PRODUCTS) pk::warp_product(hb_d,"),
        ("      pk::warp_product(rhb_d,",
         "      if (!NO_PRODUCTS) pk::warp_product(rhb_d,"),
        ("    pk::grid_sync(bar, target);         // round(r h) of step t",
         "    if (!NO_BARRIER) pk::grid_sync(bar, target);  //"),
        ("    if (t + 1 < T) pk::grid_sync(bar, target);  // round(h) of",
         "    if (t + 1 < T && !NO_BARRIER) pk::grid_sync(bar, target);  //"),
        ("k3::store2(", "if (!NO_STORES) k3::store2("),
        ("for (int q4 = 0; q4 < k4::KS / 4; ++q4) {",
         "for (int q4 = 0; q4 < (NO_FMA ? 0 : k4::KS / 4); ++q4) {"),
        ("pk::grid_sync(bar, target);         // d_z[t] complete",
         "if (!NO_BARRIER) pk::grid_sync(bar, target);"),
        ("pk::grid_sync(bar, target);  // d_zc of step t - 1 complete",
         "if (!NO_BARRIER) pk::grid_sync(bar, target);"),
        ("          epi(rbase + r0 + r, c0 + c, v, pv[u]);",
         "          if (!NO_EPILOGUE) epi(rbase + r0 + r, c0 + c, v, pv[u]);"),
    ],
    "attn_dec_fwd.cu": [
        ("      pk::warp_product(sb,", "      if (!NO_PRODUCTS) pk::warp_product(sb,"),
        ("      pk::warp_product(ctx_t,",
         "      if (!NO_PRODUCTS) pk::warp_product(ctx_t,"),
        ("      pk::warp_product(rsb,", "      if (!NO_PRODUCTS) pk::warp_product(rsb,"),
        ("for (int k0 = 0; blockIdx.x + k0 * gridDim.x < B;",
         "for (int k0 = 0; blockIdx.x + k0 * gridDim.x < (NO_ATTENTION ? 0 : B);"),
        ("for (int p0 = warp; p0 < nr * S;",
         "for (int p0 = warp; p0 < (NO_SCORES ? 0 : nr * S);"),
        ("for (int it = threadIdx.x; it < nr * H4;",
         "for (int it = threadIdx.x; it < (NO_CONTEXT ? 0 : nr * H4);"),
        ("    pk::grid_sync(bar, target);         // q complete",
         "    if (!NO_BARRIER) pk::grid_sync(bar, target);"),
        ("    pk::grid_sync(bar, target);         // ctx[t] complete",
         "    if (!NO_BARRIER) pk::grid_sync(bar, target);"),
        ("    pk::grid_sync(bar, target);         // round(r s) complete",
         "    if (!NO_BARRIER) pk::grid_sync(bar, target);"),
        ("    if (t + 1 < T) pk::grid_sync(bar, target);",
         "    if (t + 1 < T && !NO_BARRIER) pk::grid_sync(bar, target);"),
    ],
}
VARIANT_EDITS["topk_lse_logits.cu"] = [
    ("constexpr int THREADS = 256;",
     "constexpr int THREADS = K8_T128 ? 128 : K8_T512 ? 512 : 256;"),
    ("k8::warp_kth_largest(lmax, k, lane, wmax, thr);",
     "k8::warp_kth_largest(lmax, ONE_THETA ? 1 : k, lane, wmax, thr);"),
    ("        t[e] = e < n ? k8::ex2(", "        t[e] = e < n && !NO_LSE ? k8::ex2("),
    ("    if (lmax >= thr) {",
     "    if (NO_RESCAN) {\n      if (lmax >= thr) {\n        tv[0] = lmax;\n"
     "        ti[0] = g0 + tid;\n      }\n    } else if (lmax >= thr) {"),
    ("  for (int q = 0; q < k; ++q) {\n    float bv = tv[0];",
     "  if (NO_ROUNDS && lane == 0) {\n#pragma unroll\n"
     "    for (int q = 0; q < KB; ++q)\n      if (q < k) {\n"
     "        w_v[warp * KB + q] = tv[q];\n        w_i[warp * KB + q] = ti[q];\n"
     "      }\n  }\n  for (int q = 0; q < (NO_ROUNDS ? 0 : k); ++q) {\n"
     "    float bv = tv[0];"),
    ("    for (int q = 0; q < k; ++q) {\n      k8::warp_next<PB>",
     "    if (NO_ROUNDS && lane < k) {\n      ov = cv[0];\n      oi = ci[0];\n"
     "    }\n    for (int q = 0; q < (NO_ROUNDS ? 0 : k); ++q) {\n"
     "      k8::warp_next<PB>"),
]
VARIANT_SWITCHES = ("NO_FMA", "NO_BARRIER", "NO_EPILOGUE", "NO_PRODUCTS",
                    "NO_ATTENTION", "NO_SCORES", "NO_CONTEXT", "NO_STORES",
                    "ONE_THETA", "NO_LSE", "NO_RESCAN", "NO_ROUNDS",
                    "K8_T128", "K8_T512")
K3_VARIANTS = {"as committed": (), "no products": ("NO_PRODUCTS",),
               "no barriers": ("NO_BARRIER",),
               "no epilogue stores": ("NO_STORES",),
               "no products, no barriers": ("NO_PRODUCTS", "NO_BARRIER")}
K4_VARIANTS = {"as committed": (), "no FMA loop": ("NO_FMA",),
               "no barriers": ("NO_BARRIER",),
               "no epilogues": ("NO_EPILOGUE",),
               "no FMA loop, no barriers": ("NO_FMA", "NO_BARRIER")}
#: K8's top-k machinery: the threshold's k rounds, the lanes' rescan, the
#: warp's and the block's k selection rounds (a warp's lists taken as they
#: are, the block's first candidates), and the lse's 2^x terms
K8_VARIANTS = {"as committed": (), "no lse terms": ("NO_LSE",),
               "no rescan": ("NO_RESCAN",),
               "no warp and block rounds": ("NO_ROUNDS",),
               "no top-k work": ("ONE_THETA", "NO_RESCAN", "NO_ROUNDS")}
K5_VARIANTS = {"as committed": (), "no products": ("NO_PRODUCTS",),
               "no attention": ("NO_ATTENTION",), "no scores": ("NO_SCORES",),
               "no context": ("NO_CONTEXT",), "no barriers": ("NO_BARRIER",),
               "no products, no attention": ("NO_PRODUCTS", "NO_ATTENTION")}


#: the libraries ``variants`` builds edited copies of: (library, source,
#: variants)
VARIANT_BUILDS = (("gru_forward", "gru_forward.cu", K3_VARIANTS),
                  ("bigru_forward", "bigru_forward.cu", K3_VARIANTS),
                  ("gru_backward", "gru_backward.cu", K4_VARIANTS),
                  ("attn_dec_fwd", "attn_dec_fwd.cu", K5_VARIANTS),
                  ("topk_lse_logits", "topk_lse_logits.cu", K8_VARIANTS))


def _build_variants(B, builds):
    """Edited copies of csrc/ built for ``builds`` with each variant's
    switches (one nvcc each, all at once) -> {(library, variant): path of
    the .so}."""
    out = os.path.join(B.BUILD_DIR, "variants")
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(B.CSRC_DIR, out)
    for name, edits in VARIANT_EDITS.items():
        path = os.path.join(out, name)
        with open(path) as f:
            text = f.read()
        for old, new in edits:
            if old not in text:
                smoke.fail("variants", f"{name} no longer holds {old!r}")
            text = text.replace(old, new)
        with open(path, "w") as f:
            f.write(text)
    jobs = {}
    for lib, source, variants in builds:
        for i, (tag, on) in enumerate(variants.items()):
            so = os.path.join(out, f"{lib}-{i}.so")
            flags = [f"-D{s}={int(s in on)}" for s in VARIANT_SWITCHES]
            cmd = [B._nvcc(), *B.NVCC_FLAGS, *flags, "-I", out, "-o", so,
                   os.path.join(out, source)]
            jobs[(lib, tag)] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), so)
    built = {}
    for key, (proc, so) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            smoke.fail("variants", f"nvcc {key}: {log[-2000:]}")
        built[key] = so
    return built


def _load_as(lib, so):
    """Load ``so`` with ``lib``'s exported functions and swap it in."""
    cdll = ctypes.CDLL(so)
    for fn, argtypes in lib.functions.items():
        f = getattr(cdll, fn)
        f.argtypes = list(argtypes)
        f.restype = ctypes.c_int
    cdll.ptt_error_string.argtypes = [ctypes.c_int]
    cdll.ptt_error_string.restype = ctypes.c_char_p
    lib._lib = cdll


def probe_variants(dev):
    import torch

    from paddle_tpu_torch.ops.kernels import attention_decoder as AD
    from paddle_tpu_torch.ops.kernels import bigru as BG
    from paddle_tpu_torch.ops.kernels import build as B
    from paddle_tpu_torch.ops.kernels import gru as G
    from paddle_tpu_torch.ops.numerics import compute_dtype_scope

    built = _build_variants(B, VARIANT_BUILDS[:4])
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=dev)
    xp, mask, w_h, d_out, d_hfin = smoke._train_gru_inputs(dev)
    with compute_dtype_scope("bfloat16"):
        _, _, z, hp = G.gru_forward(xp, mask, w_h, residuals=True)
    k4_args = (d_out, mask.t().contiguous(), z, hp, w_h.t().contiguous(),
               d_hfin)
    x64, m64 = xp[:64].contiguous(), mask[:64].contiguous()
    xb, mb, w2 = smoke._bigru_inputs(dev, smoke.TRAIN_B)[:3]
    x = smoke._attn_dec_inputs(dev)
    bf = torch.bfloat16
    k5_args = [x["xp_y"], x["m"], x["s0"], x["enc"].to(bf),
               x["enc_proj"].to(bf), x["src_mask"], x["att_w"].to(bf),
               x["att_v"].to(bf), x["wx_c"].to(bf), x["wh"].to(bf)]
    runs = (("gru_forward", "K3r B=384 T=32 H=512 bf16", K3_VARIANTS,
             lambda: G._launch_fwd(xp, mask, w_h, None, True, "persistent")),
            ("gru_forward", "K3 B=64 T=32 H=512 bf16", K3_VARIANTS,
             lambda: G._launch_fwd(x64, m64, w_h, None, False,
                                   "persistent")),
            ("bigru_forward", "K11r B=2x384 T=32 H=512 bf16", K3_VARIANTS,
             lambda: BG._launch_fwd(xb, mb, w2, True, smoke.TRAIN_B,
                                    "persistent")),
            ("gru_backward", "K4 B=384 T=32 H=512", K4_VARIANTS,
             lambda: G._launch_bwd(*k4_args, "persistent")),
            ("attn_dec_fwd", "K5 T=32 B=384 S=32 D=A=512 bf16", K5_VARIANTS,
             lambda: AD._launch_fwd(*k5_args, "persistent")))
    for lib_name, label, variants, call in runs:
        lib = B.LIBRARIES[lib_name]
        committed = lib._lib
        times = {tag: [] for tag in variants}
        with compute_dtype_scope("bfloat16"):
            for _ in range(2):
                for tag in variants:
                    _load_as(lib, built[(lib_name, tag)])
                    times[tag].append(smoke.time_ms(call, flush))
        lib._lib = committed
        print(f"variants: {label}, persistent kernel, ms (two turns): "
              + "; ".join(f"{tag} {a:.4f} / {b:.4f}"
                          for tag, (a, b) in times.items()), flush=True)


def probe_k8variants(dev):
    import torch

    from paddle_tpu_torch.ops.kernels import build as B
    from paddle_tpu_torch.ops.kernels import topk_logits as TL

    built = _build_variants(B, VARIANT_BUILDS[4:])
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=dev)
    N, V, k = smoke.DSLGEN_B * smoke.BEAM, smoke.DSLGEN_VOCAB, smoke.BEAM
    g = torch.Generator().manual_seed(smoke.SEED + 7)
    x32 = torch.randn(N, V, generator=g).to(dev)
    lib = TL.TOPK_LSE_LOGITS
    committed = lib._lib
    for dt in (torch.float32, torch.bfloat16):
        x = x32.to(dt)
        plan = TL._k8_plan(V, dt)
        times = {tag: [] for tag in K8_VARIANTS}
        for order in (list(K8_VARIANTS), list(K8_VARIANTS)[::-1]):
            for tag in order:
                _load_as(lib, built[("topk_lse_logits", tag)])
                times[tag].append((
                    smoke.graph_ms(lambda: TL._launch(x, k, plan), flush),
                    _stream_ms(lambda: TL._launch(x, k, plan))))
        lib._lib = committed
        print(f"k8variants: {str(dt)[6:]} N={N} V={V} k={k} plan "
              f"{tuple(plan)}, device ms (one call, L2 flushed; 20 calls back to back), "
              f"two turns: " + "; ".join(
                  f"{tag} {a:.5f} / {c:.5f}, {b:.5f} / {d:.5f}"
                  for tag, ((a, b), (c, d)) in times.items()), flush=True)


def probe_build(dev):
    from paddle_tpu_torch.ops.kernels import build as B

    out = os.path.join(B.BUILD_DIR, "cold")

    def nvcc(lib):
        return subprocess.Popen(
            [B._nvcc(), *B.NVCC_FLAGS, "-o",
             os.path.join(out, f"{lib.name}.so"), lib.source],
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)

    def seconds(libs):
        shutil.rmtree(out, ignore_errors=True)
        os.makedirs(out)
        t0 = time.perf_counter()
        procs = [nvcc(lib) for lib in libs]
        if any(p.wait() for p in procs):
            smoke.fail("build", "nvcc failed")
        return time.perf_counter() - t0

    alone = {name: seconds([lib]) for name, lib in B.LIBRARIES.items()}
    together = seconds(list(B.LIBRARIES.values()))
    shutil.rmtree(out, ignore_errors=True)
    print(f"build: all at once {together:.2f} s; each alone "
          + ", ".join(f"{n} {t:.2f} s" for n, t in
                      sorted(alone.items(), key=lambda x: -x[1])),
          flush=True)


def probe_text(dev):
    import torch

    from paddle_tpu_torch.param import Adam
    from paddle_tpu_torch.trainer import SGDTrainer

    for part in ("seqtoseq_group", "sentiment", "bidi_lstm", "srl"):
        cost, _ = smoke.text_cost(part)
        feed = smoke.text_feeds(part)[0][0]
        tr = SGDTrainer(cost, Adam(learning_rate=smoke.TEXT_LR),
                        seed=smoke.SEED, device=dev)
        _profile_step(f"one text step, {part} (SGDTrainer.train_batch, "
                      f"bf16)", lambda: tr.train_batch(feed), top_n=10)
        del tr
        torch.cuda.empty_cache()


def probe_sparse(dev):
    import torch

    from paddle_tpu_torch.trainer import SGDTrainer

    for part, B in (("movielens_features", smoke.REC_B),
                    ("movielens_sparse_grad", smoke.REC_B),
                    ("sparse_lr", smoke.LR_B),
                    ("word2vec_hsigmoid", smoke.W2V_B),
                    ("word2vec_nce", smoke.W2V_B), ("ctc", smoke.CTC_B)):
        cost, opt = smoke.sparse_cost(part)
        feed = smoke.sparse_feeds(part, B, 1)[0][0]
        tr = SGDTrainer(cost, opt, seed=smoke.SEED, device=dev)
        _profile_step(f"one sparse step, {part} (SGDTrainer.train_batch, "
                      f"B={B}, bf16)", lambda: tr.train_batch(feed),
                      top_n=10)
        del tr
        torch.cuda.empty_cache()


def probe_seqdata(dev):
    """One profiled step of each of ``chip_smoke.py``'s seqdata training
    parts: the packing A/B's bucketed and packed arms and the nested
    net."""
    import torch

    import paddle_tpu_torch.nn as nn
    from paddle_tpu_torch.data import DataFeeder
    from paddle_tpu_torch.datapipe import PackedDataFeeder, pack_samples
    from paddle_tpu_torch.models import lstm_benchmark_net
    from paddle_tpu_torch.param import Adam
    from paddle_tpu_torch.trainer import SGDTrainer

    types = {"words": "ids_seq", "label": "int"}
    samples = smoke.pack_samples_ab()
    rows = pack_samples(samples, max_len=smoke.PACK_MAX_LEN,
                        max_segments=smoke.PACK_SEGMENTS)[:smoke.PACK_B]
    feeds = {"bucketed": DataFeeder(types, max_len=smoke.PACK_MAX_LEN)(
                 samples[:smoke.PACK_B]),
             "packed": PackedDataFeeder(
                 types, max_segments=smoke.PACK_SEGMENTS)(rows)}
    for arm, feed in feeds.items():
        nn.reset_naming()
        cost, _ = lstm_benchmark_net(smoke.PACK_VOCAB,
                                     emb_dim=smoke.PACK_EMB,
                                     hid_dim=smoke.PACK_HID, num_layers=2)
        tr = SGDTrainer(cost, Adam(learning_rate=1e-3), seed=smoke.SEED,
                        device=dev)
        _profile_step(f"one seqdata step, {arm} arm (lstm_b"
                      f"{smoke.PACK_B}h{smoke.PACK_HID}, rows of "
                      f"{feed['words'][0].shape[1]} tokens, bf16)",
                      lambda: tr.train_batch(feed), top_n=10)
        del tr
        torch.cuda.empty_cache()
    feed = smoke.seqdata_nested_feeds(smoke.NEST_B, 1)[0]
    nn.reset_naming()
    cost, _ = smoke.nested_nets().hier_lstm_net(
        nn, smoke.NEST_VOCAB, smoke.NEST_EMB, smoke.NEST_HID)
    tr = SGDTrainer(cost, Adam(learning_rate=1e-3), seed=smoke.SEED,
                    device=dev)
    _profile_step(f"one seqdata step, nested (B={smoke.NEST_B}, To="
                  f"{smoke.NEST_TO}, Ti={smoke.NEST_TI}, bf16)",
                  lambda: tr.train_batch(feed), top_n=10)


def probe_frontdoor(dev):
    """``chip_smoke.py``'s phase 18 alone, then one profiled training step
    of the seqToseq demo copy (its card shape: B=64, the first batch's
    S/T, V=30000, 512-d, bf16, Adam), one of the v2 seqToseq script
    (``SGDTrainer.train_batch``, which ``paddle.trainer.SGD`` drives, on
    its first wmt14 batch of 64) and one ``paddle.infer`` of its generator
    (8 sources, beam 3, max_length 32), each after three unprofiled ones."""
    import numpy as np
    import torch

    import paddle_tpu_torch.nn as nn
    import paddle_tpu_torch.v2 as paddle
    from paddle_tpu_torch.data import DataFeeder
    from paddle_tpu_torch.demo.seqToseq import train as demo
    from paddle_tpu_torch.models import Seq2SeqAttention
    from paddle_tpu_torch.ops import kernels as K
    from paddle_tpu_torch.param import Adam
    from paddle_tpu_torch.trainer import SGDTrainer
    from paddle_tpu_torch.utils.flags import FLAGS

    smoke.frontdoor_path(K, dev, smoke.card_line())
    d = smoke.FRONTDOOR_DEMO
    m = Seq2SeqAttention(src_vocab=d["dict"], trg_vocab=d["dict"],
                         emb_dim=d["emb"], enc_dim=d["hid"],
                         dec_dim=d["hid"], att_dim=d["hid"], device=dev)
    params = {k: v.requires_grad_() for k, v in m.init(seed=0).items()}
    opt = Adam(learning_rate=1e-3)
    state = opt.init_state(params)
    batch = demo.make_batches(d["dict"], d["batch"], d["batch"])[0]

    def demo_step():
        loss = m.loss(params, batch)
        grads = torch.autograd.grad(loss, list(params.values()))
        opt.update(params, dict(zip(params, grads)), state)
        return loss

    _profile_step(f"one demo seqToseq training step (B={d['batch']}, S="
                  f"{batch['src_ids'].shape[1]}, T="
                  f"{batch['trg_in'].shape[1]}, bf16)", demo_step, top_n=10)
    del m, params, state
    torch.cuda.empty_cache()

    if os.path.join(smoke.ROOT, "tests") not in sys.path:
        sys.path.insert(0, os.path.join(smoke.ROOT, "tests"))
    from torch_v2_seqtoseq import (FEEDING, v2_seqtoseq_generator,
                                   v2_seqtoseq_reader, v2_seqtoseq_trainer,
                                   v2_test_sources)

    keep = FLAGS.device
    V, B = smoke.FRONTDOOR_V2["V"], smoke.FRONTDOOR_V2_B
    try:
        paddle.init([f"--device={dev.type}"])
        nn.reset_naming()
        cost = v2_seqtoseq_trainer(paddle, **smoke.FRONTDOOR_V2)
        tr = SGDTrainer(cost, Adam(learning_rate=smoke.FRONTDOOR_V2_LR),
                        seed=smoke.SEED, device=dev)
        rows = next(iter(v2_seqtoseq_reader(paddle, V, B, B)()))
        feed = DataFeeder({k: "ids_seq" for k in FEEDING}, FEEDING)(rows)
        _profile_step(f"one v2 seqToseq training step (B={B}, "
                      f"recurrent_group decoder, bf16)",
                      lambda: tr.train_batch(feed), top_n=10)
        del tr
        torch.cuda.empty_cache()
        nn.reset_naming()
        gen = v2_seqtoseq_generator(paddle, beam=smoke.FRONTDOOR_V2_BEAM,
                                    max_len=smoke.FRONTDOOR_V2_MAX_LEN,
                                    **smoke.FRONTDOOR_V2)
        gparams = paddle.parameters.create(gen, seed=smoke.SEED)
        src = v2_test_sources(paddle, V, smoke.FRONTDOOR_V2_SOURCES)

        def infer():
            prob = paddle.infer(output_layer=gen, parameters=gparams,
                                input=src, field="prob")
            return torch.from_numpy(np.asarray(prob[0, 0]))

        _profile_step(f"one paddle.infer of the v2 generator "
                      f"({len(src)} sources, beam {smoke.FRONTDOOR_V2_BEAM}, "
                      f"max_length {smoke.FRONTDOOR_V2_MAX_LEN}, bf16)",
                      infer, top_n=10, keep="topk")
    finally:
        FLAGS.device = keep


def probe_dataio(dev):
    """``chip_smoke.py``'s phase 19 alone, one profiled provider-fed
    training step, and the feeder's native pad against its Python loop."""
    import shutil
    import statistics
    import tempfile

    import torch

    import paddle_tpu_torch.data as data
    import paddle_tpu_torch.nn as nn
    from paddle_tpu_torch.data import native
    from paddle_tpu_torch.models import lstm_benchmark_net
    from paddle_tpu_torch.ops import kernels as K
    from paddle_tpu_torch.ops.numerics import compute_dtype_scope
    from paddle_tpu_torch.param import Adam
    from paddle_tpu_torch.trainer import SGDTrainer

    smoke.dataio_path(K, dev, smoke.card_line())
    B, T, V = smoke.TEXTCLF_B, smoke.TEXTCLF_T, smoke.TEXTCLF_VOCAB
    home = tempfile.mkdtemp(prefix="dataio_probe_")
    try:
        smoke.dataio_write_imdb(home)
        with smoke.data_home(home), compute_dtype_scope("bfloat16"):
            make, _ = smoke.dataio_imdb_provider(V, smoke.SEED)
            dp = make(["train"])
            rows = next(iter(data.batch(dp.reader(), B)()))
            feeder = dp.feeder(max_len=T, buckets=(T,))
            nn.reset_naming()
            cost = lstm_benchmark_net(V, emb_dim=smoke.TEXTCLF_EMB,
                                      hid_dim=256,
                                      num_layers=smoke.TEXTCLF_LAYERS)[0]
            tr = SGDTrainer(cost, Adam(learning_rate=1e-3), seed=smoke.SEED,
                            device=dev)
            feed = feeder(rows)
            _profile_step(f"one provider-fed lstm_b{B}h256 training step "
                          f"(SGDTrainer.train_batch, T={T}, bf16)",
                          lambda: tr.train_batch(feed), top_n=10)
            del tr
            torch.cuda.empty_cache()

        def feeder_ms(reps: int = 50) -> float:
            f = dp.feeder(max_len=T, buckets=(T,))
            times = []
            for _ in range(reps):
                t0 = time.perf_counter()
                f(rows)
                times.append(time.perf_counter() - t0)
            return statistics.median(times) * 1e3

        load = native._load
        out = {}
        for arm in ("native", "loop", "loop", "native"):
            native._load = load if arm == "native" else (lambda: None)
            try:
                out.setdefault(arm, []).append(feeder_ms())
            finally:
                native._load = load
        print(f"dataio: feeder host ms a batch of {B} imdb rows (max_len "
              f"{T}, median of 50 calls), in turns: native pad "
              f"{[round(x, 4) for x in out['native']]}, Python loop "
              f"{[round(x, 4) for x in out['loop']]}; card "
              f"{smoke.card_line()}", flush=True)
    finally:
        shutil.rmtree(home, ignore_errors=True)


def probe_delivery(dev):
    """``chip_smoke.py``'s phase 20 alone."""
    from paddle_tpu_torch.ops import kernels as K

    smoke.delivery_path(K, dev, smoke.card_line())


def probe_parallel(dev):
    """``chip_smoke.py``'s phase 21 alone."""
    from paddle_tpu_torch.ops import kernels as K

    smoke.parallel_path(K, dev, smoke.card_line())


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: chip_probe.py runs on the card only",
              file=sys.stderr)
        return 2
    from paddle_tpu_torch.ops import kernels as K

    probes = {"chunks": probe_chunks, "profile": probe_profile,
              "textclf": probe_textclf, "dslgen": probe_dslgen,
              "k8plans": probe_k8plans, "k8variants": probe_k8variants,
              "variants": probe_variants, "vision": probe_vision,
              "text": probe_text, "sparse": probe_sparse,
              "seqdata": probe_seqdata, "frontdoor": probe_frontdoor,
              "dataio": probe_dataio, "delivery": probe_delivery,
              "parallel": probe_parallel, "build": probe_build}
    wanted = sys.argv[1:] or list(probes)
    unknown = set(wanted) - set(probes)
    if unknown:
        print(f"unknown probe(s) {sorted(unknown)}", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    print(f"card: {smoke.card_line()}", flush=True)
    K.build_all()
    for name, probe in probes.items():
        if name in wanted:
            probe(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
