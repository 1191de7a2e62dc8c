#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/H100 port (``paddle_tpu_torch``).

    python3 chip_smoke.py

Needs one CUDA card; without one (or run outside a checkout of the repo) it
exits non-zero and prints no result.  Phases, each printing its own lines:

1. card     the card's name and power limit, as nvidia-smi prints them;
2. build    every CUDA kernel from ``paddle_tpu_torch/csrc`` (one nvcc per
            source, all started together), with the build seconds;
3. kernels  each kernel against its plain PyTorch version on the card at the
            shapes of the path that runs it (serving: K3, K7; training: K3
            with residuals, K4, K1, K2), with its time (CUDA events, L2
            flushed before each call), the plain version's time, the least
            time the card could take (bound) and, where one exists, a
            PyTorch call sequence computing the same function
            (``library_ms``);
4. products the batch-invariant products (``ops/matmul.py``) timed against
            one cuBLAS call at the training and the serving shape;
5. serve    the serving path: the full-width WMT14 ``Seq2SeqAttention``
            (30k/30k vocab, 512-d, random weights from a numpy seed, bf16
            compute) behind ``SlotScheduler`` with 64 slots, answering 96
            requests with beam-3 output; 3 requests are held against a solo
            beam search on the card (ids and scores identical), 2 against
            the port on the CPU (plain versions, f32);
6. train    the training path: the same model at ``bench.py``'s batch
            (B=384, S=32, T=32, bf16 compute) taking 6 ``Adam`` steps
            (``loss`` -> ``torch.autograd.grad`` -> ``update``), with each
            step's loss, the median step time, words/s and MFU; then the
            full-width model at B=8 in f32, its loss and 19 gradients on the
            card held against the CPU;
7. a ``{"kernels": [...]}`` line, then the card line again, and last
   ``{"ok": true, "device": {...}}``.

Launch counters are zeroed just before each path (serve, train) is driven
and read just after; a kernel of the path that was not launched fails the
run.  ``chip_probe.py`` measures what this run leaves out to stay short (the
products' chunk sizes end to end, a profiled training step).

Any failure exits non-zero.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))

#: NVIDIA H100 SXM data sheet: HBM3 bandwidth and dense peak rates (at the
#: full 700 W power limit; the card line states the limit of this card)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}

SEED = 0
SLOTS, BEAM, SRC_LEN, MAX_LEN, N_REQUESTS = 64, 3, 32, 32, 96
#: the training batch of bench.py:253-265 and its step count here
TRAIN_B, TRAIN_S, TRAIN_T, TRAIN_STEPS = 384, 32, 32, 6
#: kernels launched by each path
SERVE_KERNELS = ("gru_forward", "topk_lse_readout")
TRAIN_KERNELS = ("gru_forward", "gru_backward", "ce_readout_fwd",
                 "ce_readout_bwd")

#: kernel-vs-plain tolerances (max abs difference) and why
TOL = {
    # f32: the same f32 math summed in another order, over 32 dependent
    # steps (h is in (-1, 1))
    "gru_forward/float32": 1e-5,
    # bf16: a last-bit difference in the f32 carry can flip the bf16
    # rounding of one operand (2^-8 relative), which the recurrence carries
    "gru_forward/bfloat16": 5e-3,
    # exact bf16 products, f32 sums of 512 terms in another order
    "topk_lse_readout": 1e-4,
    # K1 statistics (lse, per_tok ~ 10): exact bf16 products, f32 sums of
    # 512 terms and of 30000 exps in another order
    "ce_readout_fwd": 1e-4,
    # K2, relative to the largest gradient entry: f32 sums over 30000
    # (d_states) or 12288 (d_w, d_b) terms in another order, and a last-bit
    # difference in d_l can round its bf16 operand the other way
    "ce_readout_bwd": 1e-3,
    # K3 with residuals: h as gru_forward/bfloat16; z and h_prev to the
    # same plus one bf16 ulp (their bf16 rounding may go either way)
    "gru_forward_residuals": 5e-3,
    # K4 from the same residuals, relative to the largest entry: f32
    # products with w_t summed in another order over 32 reverse steps
    "gru_backward": 1e-4,
}


def fail(phase: str, msg: str) -> None:
    print(f"FAIL [{phase}] {msg}", flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, flush, reps: int = 20) -> float:
    """Median time of one call on the card (CUDA events), with the 50 MB L2
    flushed before each call, as a decode step finds it."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def bound_ms(nbytes: float, ops: float, dtype: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# phases 3 and 4: kernels against their plain versions; product timing
# ---------------------------------------------------------------------------


def check_gru(K, flush, dev):
    import torch

    from paddle_tpu_torch.ops.numerics import compute_dtype_scope

    B, T, H = 64, 32, 512                 # one full prefill, WMT14 widths
    g = torch.Generator().manual_seed(SEED)
    xp = (0.5 * torch.randn(B, T, 3 * H, generator=g)).to(dev)
    lens = torch.randint(8, T + 1, (B,), generator=g)
    lens[0] = T
    mask = (torch.arange(T)[None] < lens[:, None]).float().to(dev)
    w_h = ((2.0 / (H + 3 * H)) ** 0.5
           * torch.randn(H, 3 * H, generator=g)).to(dev)
    errs = {}
    for cd in ("float32", "bfloat16"):
        with compute_dtype_scope(cd):
            hk, fk = K.gru_forward(xp, mask, w_h)
            hp, fp = K.gru_forward_plain(xp, mask, w_h)
            torch.cuda.synchronize()
            err = max((hk - hp).abs().max().item(),
                      (fk - fp).abs().max().item())
            if not (torch.isfinite(hk).all() and err <= TOL[f"gru_forward/{cd}"]):
                fail("kernels", f"gru_forward {cd}: max abs err {err} > "
                     f"{TOL[f'gru_forward/{cd}']}")
            if not torch.equal(hk[mask == 0], torch.zeros_like(hk[mask == 0])):
                fail("kernels", f"gru_forward {cd}: padded steps not zero")
            errs[cd] = err
    with compute_dtype_scope("bfloat16"):                  # the working type
        ms = time_ms(lambda: K.gru_forward(xp, mask, w_h), flush)
        plain_ms = time_ms(lambda: K.gru_forward_plain(xp, mask, w_h), flush)
    nbytes = (T * B * 3 * H * 4 + T * B * 4 + H * 3 * H * 2 + T * B * H * 4
              + B * H * 4)
    bms, by = bound_ms(nbytes, 2.0 * T * B * H * 3 * H, "bfloat16")
    print(f"kernels: gru_forward B={B} T={T} H={H} max_abs_err f32="
          f"{errs['float32']:.3e} (tol {TOL['gru_forward/float32']}) bf16="
          f"{errs['bfloat16']:.3e} (tol {TOL['gru_forward/bfloat16']}) "
          f"ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={bms:.5f} ({by})",
          flush=True)
    return {"name": "gru_forward", "route": "cuda",
            "source": "paddle_tpu_torch/csrc/gru_forward.cu",
            "replaces": "paddle_tpu/ops/pallas_kernels.py:308",
            "launches": 0, "max_abs_err": errs["bfloat16"], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "library_ms": None}


def check_topk(K, flush, dev):
    import torch

    N, D, V = SLOTS * BEAM, 512, 30000     # one decode step of the table
    g = torch.Generator().manual_seed(SEED + 1)
    s = torch.tanh(torch.randn(N, D, generator=g)).to(dev).bfloat16()
    w = ((2.0 / (D + V)) ** 0.5
         * torch.randn(D, V, generator=g)).to(dev).bfloat16()
    b = (0.01 * torch.randn(V, generator=g)).to(dev)
    tol = TOL["topk_lse_readout"]
    worst = 0.0
    for k in (BEAM, 1):                    # beam search, greedy
        kv, ki, kl = K.topk_lse_readout(s, w, b, k)
        pv, pi, pl = K.topk_lse_readout_plain(s, w, b, k)
        torch.cuda.synchronize()
        err = max((kv - pv).abs().max().item(), (kl - pl).abs().max().item())
        if not err <= tol:
            fail("kernels", f"topk_lse_readout k={k}: max abs err {err} > "
                 f"{tol}")
        # ids exact wherever the plain top-(k+1) values are further apart
        # than the tolerance (elsewhere a tie within rounding may flip)
        pv1, _ = K.topk_lse_readout_plain(s, w, b, k + 1)[:2]
        gaps = (pv1[:, :-1] - pv1[:, 1:]).min(dim=1).values
        decisive = gaps > tol
        bad = (ki != pi).any(dim=1) & decisive
        if bad.any():
            fail("kernels", f"topk_lse_readout k={k}: ids differ on "
                 f"{int(bad.sum())} decisive rows")
        if int(ki.max()) >= V or int(ki.min()) < 0:
            fail("kernels", f"topk_lse_readout k={k}: id out of vocab")
        worst = max(worst, err)
        same = int((ki == pi).all(dim=1).sum())
        print(f"kernels: topk_lse_readout N={N} D={D} V={V} k={k} "
              f"max_abs_err={err:.3e} (tol {tol}) ids identical on "
              f"{same}/{N} rows, on all {int(decisive.sum())} rows whose "
              f"top-{k + 1} gaps exceed tol", flush=True)
    ms = time_ms(lambda: K.topk_lse_readout(s, w, b, BEAM), flush)
    plain_ms = time_ms(lambda: K.topk_lse_readout_plain(s, w, b, BEAM), flush)
    b16 = b.bfloat16()

    def library():
        logits = torch.addmm(b16, s, w)
        return torch.topk(logits, BEAM), torch.logsumexp(logits.float(), -1)

    library_ms = time_ms(library, flush)
    nbytes = N * D * 2 + D * V * 2 + V * 4 + N * BEAM * (4 + 8) + N * 4
    bms, by = bound_ms(nbytes, 2.0 * N * D * V, "bfloat16")
    print(f"kernels: topk_lse_readout k={BEAM} ms={ms:.4f} plain_ms="
          f"{plain_ms:.4f} library_ms={library_ms:.4f} bound_ms={bms:.5f} "
          f"({by})", flush=True)
    return {"name": "topk_lse_readout", "route": "cuda",
            "source": "paddle_tpu_torch/csrc/topk_lse_readout.cu",
            "replaces": "paddle_tpu/ops/pallas_kernels.py:1279",
            "launches": 0, "max_abs_err": worst, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "library_ms": library_ms}


def _kernel_row(name, source, replaces, err, ms, plain_ms, bms, by,
                library_ms):
    return {"name": name, "route": "cuda",
            "source": f"paddle_tpu_torch/csrc/{source}",
            "replaces": f"paddle_tpu/ops/pallas_kernels.py:{replaces}",
            "launches": 0, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "library_ms": library_ms}


def _max_err(got, want) -> float:
    return (got.float() - want.float()).abs().max().item()


def _within_bf16_ulp(got, want, atol: float = 0.0) -> bool:
    """Each entry within ``atol`` plus one bf16 rounding step (relative
    2^-7) of the other."""
    g, w = got.float(), want.float()
    return bool(((g - w).abs() <= atol + 2.0 ** -7 * w.abs()).all())


def _train_gru_inputs(dev):
    """The encoder's GRU at the training shape: B=384, T=32, H=512, mixed
    lengths (masked steps), bf16 policy."""
    import torch

    B, T, H = TRAIN_B, TRAIN_T, 512
    g = torch.Generator().manual_seed(SEED + 2)
    xp = (0.5 * torch.randn(B, T, 3 * H, generator=g)).to(dev)
    lens = torch.randint(4, T + 1, (B,), generator=g)
    lens[0] = T
    mask = (torch.arange(T)[None] < lens[:, None]).float().to(dev)
    w_h = ((2.0 / (H + 3 * H)) ** 0.5
           * torch.randn(H, 3 * H, generator=g)).to(dev)
    d_out = torch.randn(T, B, H, generator=g).to(dev)
    d_hfin = torch.randn(B, H, generator=g).to(dev)
    return xp, mask, w_h, d_out, d_hfin


def check_gru_train(K, flush, dev):
    """K3 with residuals and K4 at the training shape."""
    import torch

    from paddle_tpu_torch.ops.numerics import compute_dtype_scope

    xp, mask, w_h, d_out, d_hfin = _train_gru_inputs(dev)
    B, T, H3 = xp.shape
    H = H3 // 3
    rows = []
    with compute_dtype_scope("bfloat16"):
        hk, fk, zk, pk = K.gru_forward(xp, mask, w_h, residuals=True)
        hp, fp, zp, pp = K.gru_forward_plain(xp, mask, w_h, residuals=True)
        torch.cuda.synchronize()
        err = max(_max_err(hk, hp), _max_err(fk, fp))
        tol = TOL["gru_forward_residuals"]
        if not (err <= tol and _within_bf16_ulp(zk, zp, tol)
                and _within_bf16_ulp(pk, pp, tol)) \
                or zk.dtype != torch.bfloat16:
            fail("kernels", f"gru_forward residuals: h err {err} (tol {tol})"
                 f", z/h_prev beyond tol + one bf16 ulp or not bf16 "
                 f"({zk.dtype})")
        ms = time_ms(lambda: K.gru_forward(xp, mask, w_h, residuals=True),
                     flush)
        plain_ms = time_ms(lambda: K.gru_forward_plain(
            xp, mask, w_h, residuals=True), flush, reps=5)
        nbytes = (T * B * H3 * 4 + T * B * 4 + H * H3 * 2 + T * B * H * 4
                  + B * H * 4 + T * B * H3 * 2 + T * B * H * 2)
        bms, by = bound_ms(nbytes, 2.0 * T * B * H * H3, "bfloat16")
        print(f"kernels: gru_forward residuals=True B={B} T={T} H={H} bf16 "
              f"h max_abs_err={err:.3e} (tol {tol}), z and h_prev within "
              f"tol + one bf16 ulp; ms={ms:.4f} plain_ms={plain_ms:.4f} "
              f"bound_ms={bms:.5f} ({by})", flush=True)
        rows.append(_kernel_row("gru_forward_residuals", "gru_forward.cu",
                                "308", err, ms, plain_ms, bms, by, None))

        m_tb = mask.t().contiguous()
        w_t = w_h.t().contiguous()
        dk, d0k = K.gru_backward(d_out, m_tb, zk, pk, w_t, d_hfin)
        dp, d0p = K.gru_backward_plain(d_out, m_tb, zk, pk, w_t, d_hfin)
        torch.cuda.synchronize()
        err = max(_max_err(dk, dp), _max_err(d0k, d0p))
        scale = max(dp.abs().max().item(), d0p.abs().max().item())
        tol = TOL["gru_backward"]
        if not (torch.isfinite(dk).all() and err <= tol * scale):
            fail("kernels", f"gru_backward: max abs err {err} > {tol} x "
                 f"{scale}")
        ms = time_ms(lambda: K.gru_backward(d_out, m_tb, zk, pk, w_t,
                                            d_hfin), flush)
        plain_ms = time_ms(lambda: K.gru_backward_plain(
            d_out, m_tb, zk, pk, w_t, d_hfin), flush, reps=5)
    nbytes = (T * B * H * 4 + T * B * 4 + T * B * H3 * 2 + T * B * H * 2
              + H3 * H * 4 + B * H * 4 + T * B * H3 * 4 + B * H * 4)
    bms, by = bound_ms(nbytes, 2.0 * T * B * H3 * H, "float32")
    print(f"kernels: gru_backward B={B} T={T} H={H} bf16 residuals "
          f"max_abs_err={err:.3e} (tol {tol} x max {scale:.3e}); "
          f"ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={bms:.5f} ({by}, "
          f"f32 products)", flush=True)
    rows.append(_kernel_row("gru_backward", "gru_backward.cu", "590", err,
                            ms, plain_ms, bms, by, None))
    return rows


def check_ce(K, flush, dev):
    """K1 and K2 at the training readout: N = B*T = 12288, D = 512,
    V = 30000, bf16 operands, 1/12 of the rows masked."""
    import torch

    N, D, V = TRAIN_B * TRAIN_T, 512, 30000
    g = torch.Generator().manual_seed(SEED + 3)
    s = torch.tanh(torch.randn(N, D, generator=g)).to(dev).bfloat16()
    w = ((2.0 / (D + V)) ** 0.5
         * torch.randn(D, V, generator=g)).to(dev).bfloat16()
    b = (0.01 * torch.randn(V, generator=g)).to(dev)
    lab = torch.randint(0, V, (N,), generator=g).to(dev)
    mask = (torch.rand(N, generator=g) > 1 / 12).float().to(dev)
    scale = mask / mask.sum()

    pk, lk, logk = K.ce_readout_fwd(s, w, b, lab)
    pp, lp, logp = K.ce_readout_fwd_plain(s, w, b, lab)
    torch.cuda.synchronize()
    err = max(_max_err(pk, pp), _max_err(lk, lp))
    tol = TOL["ce_readout_fwd"]
    if not (err <= tol and _within_bf16_ulp(logk, logp, 1e-6)):
        fail("kernels", f"ce_readout_fwd: max abs err {err} (tol {tol}) or "
             f"logits beyond one bf16 ulp")
    del logp
    ms = time_ms(lambda: K.ce_readout_fwd(s, w, b, lab), flush, reps=10)
    plain_ms = time_ms(lambda: K.ce_readout_fwd_plain(s, w, b, lab), flush,
                       reps=10)
    b16 = b.bfloat16()
    rows_ix = torch.arange(N, device=dev)

    def library_fwd():
        logits = torch.addmm(b16, s, w)
        lse = torch.logsumexp(logits.float(), -1)
        return lse - logits[rows_ix, lab].float(), lse, logits

    library_ms = time_ms(library_fwd, flush, reps=10)
    nbytes = N * D * 2 + D * V * 2 + V * 4 + N * 8 + N * 8 + N * V * 2
    bms, by = bound_ms(nbytes, 2.0 * N * D * V, "bfloat16")
    print(f"kernels: ce_readout_fwd N={N} D={D} V={V} bf16 "
          f"max_abs_err={err:.3e} (tol {tol}), logits within one bf16 ulp; "
          f"ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms={library_ms:.4f} "
          f"bound_ms={bms:.5f} ({by})", flush=True)
    rows = [_kernel_row("ce_readout_fwd", "ce_readout_fwd.cu", "1029", err,
                        ms, plain_ms, bms, by, library_ms)]

    gk = K.ce_readout_bwd(logk, s, w, lab, lk, scale)
    gp = K.ce_readout_bwd_plain(logk, s, w, lab, lk, scale)
    torch.cuda.synchronize()
    tol = TOL["ce_readout_bwd"]
    err, worst = 0.0, 0.0
    for a, c in zip(gk, gp):
        e = _max_err(a, c)
        err = max(err, e)
        worst = max(worst, e / c.abs().max().item())
    if not worst <= tol:
        fail("kernels", f"ce_readout_bwd: max err / max |g| {worst} > {tol}")
    del gp
    ms = time_ms(lambda: K.ce_readout_bwd(logk, s, w, lab, lk, scale), flush,
                 reps=10)
    plain_ms = time_ms(lambda: K.ce_readout_bwd_plain(
        logk, s, w, lab, lk, scale), flush, reps=10)

    def library_bwd():
        p = torch.softmax(logk.float(), -1)
        p[rows_ix, lab] -= 1.0
        p *= scale[:, None]
        dl = p.bfloat16()
        return dl @ w.t(), s.t() @ dl, p.sum(0)

    library_ms = time_ms(library_bwd, flush, reps=10)
    nbytes = (N * V * 2 + N * D * 2 + D * V * 2 + N * 12 + N * D * 4
              + D * V * 4 + V * 4)
    bms, by = bound_ms(nbytes, 4.0 * N * D * V, "bfloat16")
    print(f"kernels: ce_readout_bwd N={N} D={D} V={V} bf16 "
          f"max_abs_err={err:.3e} (max err / max |g| {worst:.3e}, tol {tol})"
          f"; ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms="
          f"{library_ms:.4f} bound_ms={bms:.5f} ({by})", flush=True)
    rows.append(_kernel_row("ce_readout_bwd", "ce_readout_bwd.cu", "1101",
                            err, ms, plain_ms, bms, by, library_ms))
    return rows


def check_products(flush, dev):
    """What batch invariance costs: ``linear`` (fixed ``ROW_CHUNK``-row
    cuBLAS calls) against one ``torch.matmul`` at the training rows
    (B*T = 12288) and at the serving table's rows (192), [*, 1536] x
    [1536, 1536] in f32."""
    import torch

    from paddle_tpu_torch.ops.matmul import ROW_CHUNK, linear
    from paddle_tpu_torch.ops.numerics import compute_dtype_scope

    g = torch.Generator().manual_seed(SEED + 4)
    w = (0.03 * torch.randn(1536, 1536, generator=g)).to(dev)
    parts = []
    with compute_dtype_scope("bfloat16"):
        for rows in (TRAIN_B * TRAIN_T, SLOTS * BEAM):
            x = torch.randn(rows, 1536, generator=g).to(dev)
            xb, wb = x.bfloat16().float(), w.bfloat16().float()
            chunked = time_ms(lambda: linear(x, w), flush)
            single = time_ms(lambda: torch.matmul(xb, wb), flush)
            parts.append(f"{rows} rows: chunked {chunked:.4f} ms, one call "
                         f"{single:.4f} ms")
    print(f"products: linear [*, 1536] x [1536, 1536] f32 on bf16-rounded "
          f"operands, {ROW_CHUNK}-row chunks: {'; '.join(parts)}", flush=True)


# ---------------------------------------------------------------------------
# phase 5: the serving path
# ---------------------------------------------------------------------------


def make_requests(rng, vocab):
    import numpy as np

    from paddle_tpu_torch.serving import (Request, ServingFuture,
                                          canonicalize_feed)

    reqs, feeds = [], []
    for _ in range(N_REQUESTS):
        n = int(rng.integers(8, SRC_LEN + 1))
        feed = {"src": (rng.integers(3, vocab, (1, n)), np.asarray([n]))}
        canon, rows, sig = canonicalize_feed(feed)
        reqs.append(Request(feed=canon, rows=rows, signature=sig,
                            future=ServingFuture(), deadline=None,
                            t_submit=time.monotonic()))
        feeds.append(feed)
    return reqs, feeds


def serve(sched, reqs):
    """Admit same-signature groups as slots free up, step, harvest."""
    results = {}
    pending = list(reqs)
    prefills = 0
    while pending or sched.occupied():
        for req, out, steps in sched.harvest():
            results[id(req)] = (out, steps)
        free = sched.free_count()
        while pending and free:
            sig = pending[0].signature
            group = [r for r in pending if r.signature == sig][:free]
            sched.admit(group)
            prefills += 1
            taken = {id(r) for r in group}
            pending = [r for r in pending if id(r) not in taken]
            free = sched.free_count()
        if sched.occupied():
            sched.step()
    return results, prefills


#: card-vs-CPU search tolerance (abs, on a beam score of about -330 from
#: 32 steps, f32 on both sides): sums in another order.  A state mixed up
#: between slots moves a score by far more (log-probs vary by ~0.1).  The
#: slot-vs-solo check on the card is exact: ids and scores bit for bit.
TOL_SEARCH = 1e-3


def rescore(model, params, ids, lens, hyp) -> float:
    """Teacher-forced log-prob of one hypothesis ([max_len] token ids) —
    the score beam search reports for it, recomputed on ``model``'s
    device: readout lse from the kernel (plain version on the CPU), the
    token's logit by a plain product."""
    import torch

    from paddle_tpu_torch.models.seq2seq import BOS, EOS
    from paddle_tpu_torch.ops.decode import LinearReadout
    from paddle_tpu_torch.ops.matmul import linear
    from paddle_tpu_torch.ops.sequence import mask_from_lengths

    dev = model.device
    src = torch.as_tensor(ids, device=dev).long()
    mask = mask_from_lengths(torch.as_tensor(lens, device=dev), src.shape[1])
    with torch.no_grad():
        enc, proj, s0 = model.encode(params, src, mask)
        step = model._decode_step_fn(params, enc, proj, mask)
        readout = LinearReadout(params["out_w"], params["out_b"])
        state, y, total = {"s": s0}, BOS, 0.0
        for tok in (int(t) for t in hyp):
            r_in, state = step(torch.tensor([y], device=dev), state)
            lse = readout(r_in, 1)[2]
            logit = linear(r_in, params["out_w"][:, tok:tok + 1],
                           params["out_b"][tok:tok + 1])
            total += float(logit[0, 0] - lse[0])
            if tok == EOS:
                break
            y = tok
    return total


def padded_source(feed):
    import numpy as np

    ids, lens = feed["src"]
    full = np.full((1, SRC_LEN), 1, np.int64)            # EOS pad
    full[:, :ids.shape[1]] = ids
    return full, np.asarray(lens)


def serve_path(K, dev):
    import numpy as np
    import torch

    from paddle_tpu_torch.models import Seq2SeqAttention
    from paddle_tpu_torch.ops.numerics import compute_dtype_scope
    from paddle_tpu_torch.serving import Seq2SeqSlotBackend, SlotScheduler

    model = Seq2SeqAttention(device=dev)                  # 30k/30k, 512-d
    t0 = time.perf_counter()
    params = model.init(seed=SEED)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    reqs, feeds = make_requests(np.random.default_rng(SEED), model.src_vocab)

    K.reset_launch_counts()
    t0 = time.perf_counter()
    backend = Seq2SeqSlotBackend(model, params, src_len=SRC_LEN,
                                 beam_size=BEAM, max_len=MAX_LEN)
    sched = SlotScheduler(backend, slots=SLOTS)
    results, prefills = serve(sched, reqs)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = K.launch_counts()

    if len(results) != N_REQUESTS:
        fail("serve", f"{len(results)}/{N_REQUESTS} requests answered")
    if sched.recycled != N_REQUESTS or sched.occupied() != 0:
        fail("serve", f"slots recycled {sched.recycled}, occupied "
             f"{sched.occupied()}")
    for name in SERVE_KERNELS:
        if launches[name] <= 0:
            fail("serve", f"kernel {name} was not launched on the serve path")
    tokens = 0
    for req in reqs:
        out, steps = results[id(req)]
        t, s = out["tokens"], out["scores"]
        if t.shape != (1, BEAM, MAX_LEN) or not np.isfinite(s).all() \
                or t.min() < 0 or t.max() >= model.trg_vocab \
                or not (np.diff(s[0]) <= 0).all():
            fail("serve", f"malformed result: tokens {t.shape}, scores {s}")
        tokens += steps
    print(f"serve: {N_REQUESTS} requests through {SLOTS} slots (beam "
          f"{BEAM}, src_len {SRC_LEN}, max_len {MAX_LEN}, bf16 compute): "
          f"{elapsed:.3f} s, {N_REQUESTS / elapsed:.2f} requests/s, "
          f"{tokens / elapsed:.1f} tokens/s ({tokens} decode steps), "
          f"{sched.steps_run} table steps, {prefills} prefills, recycled "
          f"{sched.recycled}, launches {launches}, param init "
          f"{t_init:.2f} s", flush=True)

    # 3 requests against a solo beam search on the card (bf16, the served
    # policy): ids and scores identical; 2 against the port on the CPU
    # (plain versions, f32): ids identical, scores within TOL_SEARCH
    checks = [("solo", i, model, params, "bfloat16")
              for i in (0, N_REQUESTS // 2, N_REQUESTS - 1)]
    cpu_model = Seq2SeqAttention(device="cpu")
    cpu_params = {k: v.cpu() for k, v in params.items()}
    checks += [("cpu", i, cpu_model, cpu_params, "float32") for i in (1, 2)]
    for kind, i, ref_model, ref_params, cd in checks:
        ids, lens = padded_source(feeds[i])
        with compute_dtype_scope(cd):
            if kind == "solo":
                out = results[id(reqs[i])][0]
                got_t, got_s = out["tokens"], out["scores"]
            else:
                gt, gs = model.beam_search(params, ids, lens,
                                           beam_size=BEAM, max_len=MAX_LEN)
                got_t, got_s = gt.cpu().numpy(), gs.cpu().numpy()
            rt, rs = ref_model.beam_search(ref_params, ids, lens,
                                           beam_size=BEAM, max_len=MAX_LEN)
            rescored = rescore(ref_model, ref_params, ids, lens,
                               got_t[0, 0])
        rt, rs = rt.cpu().numpy(), rs.cpu().numpy()
        same_ids = np.array_equal(rt, got_t)
        same_scores = np.array_equal(rs, got_s)
        d_best = abs(float(rs[0, 0]) - float(got_s[0, 0]))
        d_rescore = abs(rescored - float(got_s[0, 0]))
        print(f"serve: {kind} check of request {i} ({cd}): ids "
              f"{'identical' if same_ids else 'DIFFER'}, scores "
              f"{'identical' if same_scores else 'differ'}, best score "
              f"diff {d_best:.3e}, rescored best hypothesis diff "
              f"{d_rescore:.3e}", flush=True)
        if not same_ids:
            fail("serve", f"{kind} check of request {i}: ids differ")
        if kind == "solo" and not same_scores:
            fail("serve", f"solo check of request {i}: scores differ from "
                 f"the solo decode")
        if kind == "cpu" and (d_best > TOL_SEARCH or d_rescore > TOL_SEARCH):
            fail("serve", f"cpu check of request {i} beyond tol "
                 f"{TOL_SEARCH}")
    return launches


# ---------------------------------------------------------------------------
# phase 6: the training path
# ---------------------------------------------------------------------------


def train_batch(rng, model, B, S, T, mixed: bool):
    """bench.py:253-265's batch (full lengths), or with mixed lengths."""
    import numpy as np

    core = rng.randint(3, model.trg_vocab, (B, T - 1))
    src_len = np.full((B,), S)
    trg_len = np.full((B,), T)
    if mixed:
        src_len = rng.randint(1, S + 1, (B,))
        trg_len = rng.randint(1, T + 1, (B,))
        src_len[0], trg_len[0] = S, T
    return {"src_ids": rng.randint(3, model.src_vocab, (B, S)),
            "src_len": src_len,
            "trg_in": np.concatenate([np.zeros((B, 1), np.int64), core], 1),
            "trg_next": np.concatenate([core, np.ones((B, 1), np.int64)], 1),
            "trg_len": trg_len}


def analytic_flops(m, B, S, T) -> float:
    """bench.py:281-297: 3x the forward matmul FLOPs (the standard
    convention), E=H=D=A=512, V=30000."""
    E, Hd, Dd, A, V = m.emb_dim, m.enc_dim, m.dec_dim, m.att_dim, m.trg_vocab
    fwd = (2 * B * S * E * 3 * Hd * 2 + 2 * B * S * Hd * 3 * Hd * 2
           + B * S * 2 * Hd * A * 2
           + T * (B * Dd * A * 2 + B * S * A * 2 + B * S * 2 * Hd * 2
                  + B * (E + 2 * Hd) * 3 * Dd * 2 + B * Dd * 3 * Dd * 2)
           + B * T * Dd * V * 2)
    return 3.0 * fwd


def train_path(K, dev):
    """6 Adam steps of the full-width flagship at B=384, S=T=32, bf16."""
    import numpy as np
    import torch

    from paddle_tpu_torch.models import Seq2SeqAttention
    from paddle_tpu_torch.param import Adam

    model = Seq2SeqAttention(device=dev)
    params = {k: v.requires_grad_() for k, v in model.init(seed=SEED).items()}
    batch = train_batch(np.random.RandomState(SEED), model, TRAIN_B,
                        TRAIN_S, TRAIN_T, mixed=False)
    opt = Adam(learning_rate=1e-3)
    state = opt.init_state(params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)

    def step():
        loss = model.loss(params, batch)
        grads = torch.autograd.grad(loss, list(params.values()))
        opt.update(params, dict(zip(params, grads)), state)
        return loss

    K.reset_launch_counts()
    losses, secs = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        losses.append(step().item())                # synchronises
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    launches = K.launch_counts()

    if not all(np.isfinite(losses)):
        fail("train", f"loss not finite: {losses}")
    if not losses[-1] < losses[0]:
        fail("train", f"loss did not fall: {losses}")
    if int(state["step"]) != TRAIN_STEPS:
        fail("train", f"optimizer step counter {int(state['step'])} after "
             f"{TRAIN_STEPS} updates")
    for name in TRAIN_KERNELS:
        if launches[name] <= 0:
            fail("train", f"kernel {name} was not launched on the train path")
    steady = sorted(secs[1:])
    sec = steady[len(steady) // 2]
    flops = analytic_flops(model, TRAIN_B, TRAIN_S, TRAIN_T)
    print(f"train: losses {[round(x, 6) for x in losses]}", flush=True)
    print(f"train: B={TRAIN_B} S={TRAIN_S} T={TRAIN_T} bf16 Adam, "
          f"{TRAIN_STEPS} steps: first step {secs[0]:.3f} s, median of the "
          f"rest {sec * 1e3:.2f} ms/step ({[round(x * 1e3, 2) for x in secs]}"
          f" ms), {TRAIN_B * TRAIN_T / sec:.1f} words/s, MFU "
          f"{flops / sec / PEAK_OPS_PER_S['bfloat16']:.4%} of 989 TFLOP/s "
          f"({flops:.4e} FLOP/step), peak memory "
          f"{torch.cuda.max_memory_allocated(dev) / 2 ** 30:.2f} GiB, "
          f"launches {launches}", flush=True)
    return launches


#: card-vs-CPU training check (f32 on both sides): the loss relative, each
#: gradient's max |diff| against its largest entry (sums over 256 rows, a
#: 30k vocab and 32 recurrent steps taken in another order)
TOL_TRAIN_LOSS, TOL_TRAIN_GRAD = 1e-5, 1e-3


def train_cpu_check(dev):
    """The full-width model at B=8 (mixed lengths) in f32: loss and all 19
    gradients on the card (kernels) against the CPU (plain versions), same
    parameters."""
    import numpy as np
    import torch

    from paddle_tpu_torch.models import Seq2SeqAttention
    from paddle_tpu_torch.ops.numerics import compute_dtype_scope

    card = Seq2SeqAttention(device=dev)
    cpu = Seq2SeqAttention(device="cpu")
    params = cpu.init(seed=SEED + 1)
    # embeddings and att_v scaled up from their init (0.01, 0.05): at init
    # the attention's gradients (att_dec_w ~1e-12) are float32 noise of
    # their many cancelling terms and no ratio to them means anything
    for k, f in (("src_emb", 50.0), ("trg_emb", 50.0), ("att_v", 20.0)):
        params[k] = params[k] * f
    batch = train_batch(np.random.RandomState(SEED + 1), cpu, 8, TRAIN_S,
                        TRAIN_T, mixed=True)
    out = {}
    with compute_dtype_scope("float32"):
        for name, model, dv in (("card", card, dev), ("cpu", cpu, "cpu")):
            p = {k: v.to(dv).requires_grad_() for k, v in params.items()}
            loss = model.loss(p, batch)
            grads = torch.autograd.grad(loss, list(p.values()))
            out[name] = (loss.item(), [g.cpu() for g in grads])
    d_loss = abs(out["card"][0] - out["cpu"][0]) / abs(out["cpu"][0])
    worst, worst_name = 0.0, ""
    for name, a, c in zip(params, out["card"][1], out["cpu"][1]):
        rel = (a - c).abs().max().item() / c.abs().max().item()
        if rel > worst:
            worst, worst_name = rel, name
    print(f"train: card vs CPU at B=8, full width, f32: loss "
          f"{out['card'][0]:.7f} vs {out['cpu'][0]:.7f} (rel diff "
          f"{d_loss:.3e}, tol {TOL_TRAIN_LOSS}); 19 gradients, worst max "
          f"|diff| / max |g| {worst:.3e} ({worst_name}, tol "
          f"{TOL_TRAIN_GRAD})", flush=True)
    if not (d_loss <= TOL_TRAIN_LOSS and worst <= TOL_TRAIN_GRAD):
        fail("train", "card and CPU disagree beyond tolerance")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py runs on the card only",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        from paddle_tpu_torch.ops import kernels as K
    except ImportError as e:
        print(f"paddle_tpu_torch not found beside chip_smoke.py: {e}",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    phase = "card"
    try:
        card = card_line()
        print(f"card: {card}", flush=True)
        phase = "build"
        t0 = time.perf_counter()
        secs = K.build_all()
        print(f"build: {time.perf_counter() - t0:.2f} s "
              f"({', '.join(f'{n} {s:.2f} s' for n, s in secs.items())})",
              flush=True)
        phase = "kernels"
        flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=dev)
        rows = [check_gru(K, flush, dev), check_topk(K, flush, dev)]
        rows += check_gru_train(K, flush, dev)
        rows += check_ce(K, flush, dev)
        phase = "products"
        check_products(flush, dev)
        del flush
        torch.cuda.empty_cache()
        phase = "serve"
        serve_launches = serve_path(K, dev)
        phase = "train"
        train_launches = train_path(K, dev)
        train_cpu_check(dev)
    except SystemExit:
        raise
    except Exception:  # noqa: BLE001 — report the phase and fail
        traceback.print_exc()
        fail(phase, "raised")
    # each row's launches come from the path that runs it: K3 inference and
    # K7 from serving; K3 with residuals, K4, K1 and K2 from training
    for row in rows:
        if row["name"] in ("gru_forward", "topk_lse_readout"):
            row["launches"] = serve_launches[row["name"]]
        elif row["name"] == "gru_forward_residuals":
            row["launches"] = train_launches["gru_forward"]
        else:
            row["launches"] = train_launches[row["name"]]
    print(json.dumps({"kernels": rows}), flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
