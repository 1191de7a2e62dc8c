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
            with residuals, K4, K1, K2, K5, K6; the flagship's optional
            paths: K11, the fused bidirectional encoder, without and with
            residuals and its reverse, also held bit for bit against one
            K3/K4 call per direction; K3, K3r, K4, K11 (both loops) and
            K5 (under bf16) must take their persistent kernels, are also
            held and timed on their steps kernels, and K3r's, K4's and
            K5's rows at B = 37 are held bit for bit against B = 384;
            K3 and K11 under f32 take their steps kernels; K12, the row
            logsumexp, with -inf rows and a ragged vocabulary; K1 and K2
            must take their TMA + wgmma kernels at the training shape, and
            are also held and timed on their WMMA kernels there; K7 must
            take its TMA + wgmma pass 1 at the serve shape and at a solo
            decode's N = 3, whose rows are bit-equal to the N = 192
            call's, and is also timed on its SIMT pass 1 there and held on
            it at V = 30001; K7 greedy at the spec phase's wide verify
            (N = 320), each 64-row block bit-equal to an N = 64 call, both
            on wgmma, both timed; K6 with its device time by kernel; text
            classification: K9 without and with residuals and K10, at
            both widths, which must take their persistent kernels under
            bf16 and are also held and timed on their per-step kernels
            (K10 also at B = 37); DSL generation: K8, one launch with
            each row split over a thread block cluster, ids and values
            identical to its plain version, rows at N = 37 bit-equal to
            N = 192's, also timed from a CUDA graph and by its host time),
            with registers, spills and shared bytes of the redesigned
            kernels, with its time (CUDA events,
            L2 flushed before each call), the plain version's time, the
            least time the card could take (bound) and, where one exists, a
            PyTorch call sequence computing the same function
            (``library_ms``; for K9/K10 cuDNN's LSTM as a yardstick, which
            the port never calls);
4. products the batch-invariant products (``ops/matmul.py``) timed against
            one cuBLAS call at the training and the serving shape;
5. serve    the serving path: the full-width WMT14 ``Seq2SeqAttention``
            (30k/30k vocab, 512-d, random weights from a numpy seed, bf16
            compute) behind ``SlotScheduler`` with 64 slots, answering 96
            requests with beam-3 output; 3 requests are held against a solo
            beam search on the card (ids and scores identical), 2 against
            the port on the CPU (plain versions, f32); then the same 96
            requests with ``fused_bigru`` on (K11 at every prefill, no K3):
            ids and scores identical to the first run; every K3 and K11
            launch on its persistent kernel;
6. server   the served entry point: ``InferenceServer(mode="generation")``
            over ``Seq2SeqSlotBackend`` (the serve phase's model, 64 slots),
            in three parts: the serve phase's 96 requests submitted at
            once, each answer identical to the direct scheduler run's,
            requests/s and tokens/s beside serve's, cold start and peak
            memory; 192 requests with Poisson arrivals at half the closed
            batch's requests/s (fixed seed, 1000 ms deadline), latency
            p50/p90/p99 and the counts of completed, shed, expired and
            evicted requests and the mean slot occupancy; one request
            whose deadline ends mid-decode beside 8 ordinary ones (it fails
            ``DeadlineExceeded`` and its slots recycle; the 8 answer as
            their solo decodes).  K3 (persistent) and K7 (wgmma) must
            launch in each part, only from the server's worker thread, and
            no other kernel may launch; the device memory the phase leaves
            allocated once its servers are closed and dropped is printed
            (the worker thread's cuBLAS workspace, which PyTorch keeps past
            the thread's end), then released, and nothing else may remain;
7. spec     speculative decoding, the prefix cache and host paging on the
            same model behind ``Seq2SeqSlotBackend(beam_size=1)``, 64
            slots, 192 single-row requests over 16 distinct sources (the
            template/session traffic they are for), in three arms: plain;
            full (spec_k 4, the prefix cache, the host page pool, a forced
            page-out every 3 cycles); server (the same requests submitted
            at once to ``InferenceServer(mode="generation")`` with those
            settings, whose own page-out fires as the queue outruns the
            table).  The full arm's tokens and scores equal the plain
            arm's bit for bit, the server's the full arm's, each source's
            answer its solo greedy decode; the cache hits and K3 launches
            fall by exactly the prefills it saved; pages out = pages in >
            0; drafts are accepted; K7 launches once a table step on its
            wgmma pass 1, at 64 rows on a plain step and 320 on a wide
            one (the kernels phase holds the N = 320 call's rows bit for
            bit against N = 64 calls and times both); requests/s,
            tokens/s, tokens a table step, acceptance, cache hits and the
            bytes parked print beside the card's name and power limit;
8. train    the training path: the same model at ``bench.py``'s batch
            (B=384, S=32, T=32, bf16 compute) taking 6 ``Adam`` steps
            (``loss`` -> ``torch.autograd.grad`` -> ``update``) in each of
            three configurations, in turns and twice: default, fused_bigru
            (K11 twice a step, no K3r/K4) and lse_readout (K12 once a step,
            no K1/K2), with each one's losses, median step time, words/s
            and MFU (step-1 loss of fused_bigru equal to the default's, of
            lse_readout within 1e-3; every K3r, K4, K11 (both loops) and
            K5 launch on its persistent kernel); then the full-width model
            at B=8 in f32, its loss and 19 gradients on the card held
            against the CPU, with both switches off and with both on;
9. textclf  the text-classification path: ``lstm_benchmark_net`` (vocab
            30000, embedding 128, 2 LSTM layers, max-pool, fc to 2 classes)
            through ``nn.Topology`` at ``bench.py``'s rows lstm_b64h256 and
            lstm_b64h1280 (B=64, T=100, bf16 compute), 6 ``Adam`` steps each
            (``apply`` -> ``torch.autograd.grad`` -> ``update``) with the
            losses, median step time, samples/s and MFU; one inference pass
            (``apply(train=False)`` under ``torch.no_grad()``) at each
            width; K9 and K10 launches all on their persistent kernels;
            then the net at H=256, B=4 in f32, its loss and 15 gradients on
            the card held against the CPU;
10. dslgen  generation through the nn DSL's ``beam_search`` layer: the
            reference's demo/seqToseq composition (bidirectional
            ``grumemory`` encoder; ``simple_attention`` + ``mixed`` +
            ``gru_unit`` + a logits ``fc`` per step) at the WMT14 widths
            (30k/30k vocab, 512-d, bf16 compute), 64 sources of 8-32
            tokens, beam 3, ``max_length`` 32, through ``Topology.apply``:
            time, sentences/s, decode steps/s, peak memory, launches (K3
            twice a call, both persistent, K8 once a decode step); the
            layer held against ``SequenceGenerator`` over a hand-written
            step (identical ids), and the net at B=2 in f32 on the card
            against the CPU;
11. trainer  the trainer and its command line on the textclf net at
            lstm_b64h256 (bf16): ``SGDTrainer(cost, Adam(1e-3),
            seed=SEED).train_batch`` six times on textclf's feed, with
            the bad-step guard on, giving the textclf phase's six losses
            bit for bit; ``python -m paddle_tpu_torch --job=train`` on
            ``tests/torch_textclf_conf.py`` for two passes of 3 batches
            (losses finite and falling, both checkpoints valid), resumed
            from pass 0 with ``--start_pass=1`` (pass 1's losses bit for
            bit or within ``TOL_TRAINER_RESUME``), ``--job=test`` from the
            last checkpoint (K9, no K10), ``--job=checkgrad`` under f32,
            and ``--job=time`` over 20 batches beside textclf's direct
            median; every K9r/K10 launch ``persistent``;
12. vision   the image tier (PR 18): ``bench.py``'s image rows through
            ``nn.Topology`` at bf16, random weights from ``SEED`` and
            seeded numpy feeds (``rand(B, H, W, 3)``), ``Momentum``
            steps of the direct loop (``apply`` -> ``torch.autograd.grad``
            -> ``update`` -> the new batch-norm state): resnet20_b256 (6
            steps), smallnet_b64 (6), alexnet_b128 (227x227, 1000
            classes, dropout and LRN; 3) and googlenet_b128 (224x224,
            ``fused_reduce``; 3), each with its losses, median step time
            of steps 2-N (min, max), images/s, MFU from the built graph's
            conv and fc shapes, peak memory and the card line;
            resnet20_b256 again through ``SGDTrainer.train_batch`` (its
            losses against the direct loop's, bit for bit or within
            ``TOL_VISION_RESUME``; every running stat moved) and one
            inference pass (``train=False`` under ``torch.no_grad()``);
            ``python -m paddle_tpu_torch`` on ``tests/torch_resnet_conf.py``
            (``--job=train`` 2 passes of 3 batches, ``--start_pass=1``
            from pass 0 against pass 1, ``--job=time`` over 20 batches);
            resnet at depth 8 (B=4) and AlexNet at 67x67 (B=2, one
            dropout mask on both sides) at f32 on the card against the
            CPU (loss, every gradient, the new running stats).  No
            hand-written kernel lies on this path: every launch count
            stays 0 through the phase;
13. text     the text tier (PR 19), bf16, random weights from ``SEED``,
            seeded feeds, ``SGDTrainer(cost, Adam(2e-3)).train_batch`` x 4
            in each part, with its losses, median step of steps 2-4,
            samples/s, real tokens/s, peak memory, launches and the card
            line: (a) seqtoseq_group, the demo/seqToseq composition trained
            through ``recurrent_group`` (``tests/torch_seqtoseq_net.py::
            seqtoseq_trainer``) at the dslgen widths (30k vocabularies,
            512-d), B=64, S=T=32: K3r and K4 twice a step, all
            persistent, no K5/K6; one ``SGDTrainer.test`` batch (K3
            twice); the loss and every gradient at B=2, f32, card vs CPU;
            (b) sentiment, ``stacked_lstm_net`` (emb 128, hid 512, 3 relu
            LSTMs, vocab 5000) and ``convolution_net`` at their defaults on
            synthetic sentiment through ``DataFeeder(max_len=128)``, B=32:
            no kernel launches (relu LSTMs take the plain scan); (c)
            bidi_lstm, ``networks.bidirectional_lstm`` -> max pool -> fc at
            lstm_b64h256's shape (vocab 30000, emb 128, hid 256, B=64,
            T=100): K9r and K10 twice a step, all persistent, and one
            inference pass (K9 twice); (d) srl, ``db_lstm_net``
            (``tests/torch_text_nets.py``) at the SRL demo's defaults
            (vocab 800, 19 labels, hidden 128, depth 8) on synthetic
            ``conll05_features``, B=16, with ``crf_cost`` (no kernel), one
            ``crf_decoding`` pass and its tags on the card against the
            CPU's (f32, identical);
14. sparse   the sparse and sampled-cost tier, bf16, random
            weights from ``SEED``, ``SGDTrainer(...).train_batch`` x 4 in
            each part, with its losses, median step of steps 2-4,
            samples/s, peak memory, launches and the card line: (a)
            recommender, ``movielens_feature_net`` at its defaults on
            ``movielens_features`` (categories ``sparse_ids``, the title
            ``ids_seq``) and ``movielens_net(sparse_grad=True)``, B=128,
            Adam(1e-3), every untouched ``user_emb``/``movie_emb`` row and
            its Adam slots equal to their values before each step, bit for
            bit; (b) sparse_lr, the quick_start LR over a sparse bag of
            words at VOCAB 1000 on synthetic imdb, B=32, the same check on
            ``lr_w``; (c) word2vec, the demo's n-gram net (emb 32, hid 64,
            5-gram, vocabulary 2000), B=128, AdaGrad(0.1), with
            ``hsigmoid_cost`` (2047 nodes) and with ``nce_cost`` (10 noise
            classes): no kernel in (a)-(c); (d) ctc, the golden ctc net at
            lstm_b64h256's shape (B=64, T=100, 128-d frames, 29 outputs,
            input lengths 60-100, labels 10-40): K9r and K10 once a step,
            all persistent, and one ``SGDTrainer.test`` batch (K9 once);
            then (a), (c) and (d) at B=4, f32, loss and every gradient on
            the card against the CPU;
15. a ``{"server_launches": {...}}`` line (each part of the server
   phase: every kernel library's launches, by kernel variant and by
   thread), a ``{"kernels": [...]}`` line (each kernel's launches on its
   path's run, also by kernel variant: ``launches_by_path``; the K9,
   K9r and K10 rows at b64h256 also by trainer part:
   ``trainer_launches``; the K3, K3r, K4, K9, K9r and K10 rows also by
   text part: ``text_launches``; the K9, K9r and K10 rows at b64h256 also
   by sparse part: ``sparse_launches``), then the card line again, and last
   ``{"ok": true, "device": {...}}``.

Launch counters are zeroed just before each path (serve and its fused
re-run, each part of the server phase, each arm of the spec phase, each
training configuration, each textclf run, dslgen, each part of the
trainer phase, the vision phase, each part of the text and sparse
phases) is driven
and read just after; a kernel of the path
that was not launched fails the run.  ``chip_probe.py`` measures what this
run leaves out to stay short (the products' chunk sizes end to end,
profiled training steps).

Any failure exits non-zero.
"""

from __future__ import annotations

import contextlib
import json
import math
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
#: the server phase: queue bound, default deadline, open-loop requests, the
#: longest wait for one answer, and part 3's deadline in table steps
SERVER_MAX_QUEUE, SERVER_DEADLINE_MS, SERVER_OPEN_N = 192, 1000.0, 192
SERVER_WAIT_S, SERVER_DEADLINE_STEPS = 120.0, 6
#: the spec phase: greedy (beam 1) decode of SPEC_REQUESTS single-row
#: requests over SPEC_SOURCES distinct sources (template/session traffic),
#: spec_k, the prefix cache and host page pool sizes (the cache holds every
#: distinct prefill, ~0.2 MiB each), and a forced page-out every
#: SPEC_PAGE_EVERY cycles in the full arm
SPEC_K, SPEC_REQUESTS, SPEC_SOURCES = 4, 192, 16
SPEC_CACHE_MB, SPEC_POOL_MB, SPEC_PAGE_EVERY = 64.0, 256.0, 3
SPEC_SERVER_QUEUE = 256
#: the training batch of bench.py:253-265 and its step count here
TRAIN_B, TRAIN_S, TRAIN_T, TRAIN_STEPS = 384, 32, 32, 6
#: kernels launched by each path
SERVE_KERNELS = ("gru_forward", "topk_lse_readout")
TRAIN_KERNELS = ("gru_forward", "gru_backward", "ce_readout_fwd",
                 "ce_readout_bwd", "attn_dec_fwd", "attn_dec_bwd")
#: the text-classification rows of bench.py:2028-2034 driven here
#: (lstm_b64h256, lstm_b64h1280): bench.py:391-403's net and feed
TEXTCLF_VOCAB, TEXTCLF_EMB, TEXTCLF_LAYERS = 30000, 128, 2
TEXTCLF_B, TEXTCLF_T, TEXTCLF_HIDDEN = 64, 100, (256, 1280)
TEXTCLF_KERNELS = ("lstm_forward", "lstm_backward")
#: the flagship's two optional paths (the reference's use_pallas_bigru and
#: _USE_PALLAS_LSE_READOUT, off by default): the fused bidirectional
#: encoder (K11) and the logsumexp readout (K12), and the kernels each one
#: replaces on the training step
FUSED_BIGRU_KERNELS = ("bigru_forward", "bigru_backward")
#: the training kernels whose every launch must take the persistent kernel
PERSISTENT_TRAIN_KERNELS = ("gru_forward", "gru_backward", "bigru_forward",
                            "bigru_backward", "attn_dec_fwd")
LSE_READOUT_KERNELS = ("logsumexp_rows",)
TRAIN_CONFIGS = ("default", "fused_bigru", "lse_readout")
#: the LSE readout's step-1 loss against K1's (rel): the bf16 logits are
#: rounded once and then reduced, where K1 reduces the float32 logits
TOL_LSE_LOSS = 1e-3
#: DSL generation: the demo/seqToseq net at the flagship's WMT14 widths
#: (paddle_tpu/models/seq2seq.py:40-45), 64 sources, beam BEAM, MAX_LEN
DSLGEN_VOCAB, DSLGEN_WIDTH, DSLGEN_B = 30000, 512, 64
DSLGEN_KERNELS = ("gru_forward", "topk_lse_logits")

#: the trainer phase: the command line's config (``lstm_benchmark_net`` at
#: lstm_b64h256), its batches a pass in the train run, the batches of
#: ``--job=time``, and the kernel rows that report its launches
TRAINER_CONF = os.path.join(ROOT, "tests", "torch_textclf_conf.py")
TRAINER_PASS_BATCHES, TRAINER_TIME_BATCHES = 3, 20
TRAINER_ROWS = ("lstm_forward", "lstm_forward_residuals_b64h256",
                "lstm_backward_b64h256")
#: the run resumed from pass 0 against the uninterrupted run's pass-1
#: losses (rel), where they are not bit-equal: bf16 products of the same
#: values, so only a different reduction order could move them
TOL_TRAINER_RESUME = 1e-4

#: the vision phase: bench.py's image rows resnet20_b256 (bench.py:428-459),
#: smallnet_b64 (:462-507), alexnet_b128 (:551-560) and googlenet_b128
#: (:563-583, fused_reduce at B >= 128), each (row, model, its arguments,
#: B, image side, classes, Momentum's learning rate, steps)
VISION_ROWS = (
    ("resnet20_b256", "resnet_cifar", {"depth": 20}, 256, 32, 10, 0.1, 6),
    ("smallnet_b64", "smallnet", {}, 64, 32, 10, 0.1, 6),
    ("alexnet_b128", "alexnet", {"num_classes": 1000}, 128, 227, 1000,
     0.01, 3),
    ("googlenet_b128", "googlenet", {"num_classes": 1000,
                                     "fused_reduce": True}, 128, 224, 1000,
     0.01, 3),
)
#: the vision phase's command line: its config, batches a pass in the
#: train run, batches of ``--job=time``
VISION_CONF = os.path.join(ROOT, "tests", "torch_resnet_conf.py")
VISION_PASS_BATCHES, VISION_TIME_BATCHES = 3, 20
#: SGDTrainer against the direct loop, and the resumed pass 1 against the
#: uninterrupted one (rel): bit for bit where every kernel is
#: deterministic; otherwise only a different reduction order can move them
TOL_VISION_RESUME = 1e-4
#: card vs CPU on the image nets, f32 both sides: the loss and each new
#: running stat (rel), each gradient's max |diff| against its largest entry
#: (f32 sums of up to k*k*Cin terms in another order, cuDNN's algorithms
#: against the CPU's, through batch norms over few samples)
TOL_VISION_LOSS, TOL_VISION_GRAD = 1e-5, 1e-3

#: the text phase (PR 19): each part's batches and steps; (a) the
#: demo/seqToseq group trained at the dslgen widths, B=64, S=T=32; (b)
#: stacked_lstm_net and convolution_net at their defaults (vocab 5000) on
#: synthetic sentiment, DataFeeder(max_len=128), B=32; (c)
#: bidirectional_lstm at lstm_b64h256's shape (vocab 30000, emb 128, hid
#: 256, B=64, T=100); (d) db_lstm at the SRL demo's defaults
#: (demo/semantic_role_labeling/train.py:39-41, :93-99: vocab 800, 19
#: labels, hidden 128, depth 8) on synthetic conll05_features,
#: DataFeeder(max_len=48), B=16
TEXT_STEPS, TEXT_LR = 4, 2e-3
TEXT_B, TEXT_S = 64, 32
SENTIMENT_VOCAB, SENTIMENT_B, SENTIMENT_MAX_LEN = 5000, 32, 128
BIDI_VOCAB, BIDI_EMB, BIDI_HID, BIDI_B, BIDI_T = 30000, 128, 256, 64, 100
SRL_VOCAB, SRL_LABELS, SRL_HIDDEN, SRL_DEPTH = 800, 19, 128, 8
SRL_B, SRL_MAX_LEN = 16, 48
#: card vs CPU on the seqToseq group at f32: the loss (rel) and each
#: gradient's max |diff| against its largest entry (f32 sums of 30000-
#: and 512-term products in another order over 32 group steps)
TOL_TEXT_LOSS, TOL_TEXT_GRAD = 1e-5, 1e-3

#: the sparse phase, each part SPARSE_STEPS steps: (a)
#: movielens_feature_net at its defaults (emb 32, fusion 200, ML_SCHEMA's
#: 6040 users, 3952 movies, 5175 title words) and movielens_net(
#: sparse_grad=True) (emb 64, hid 64), B=128, Adam(1e-3) as
#: demo/recommendation/train.py trains them; (b) the quick_start sparse LR
#: at VOCAB 1000 (demo/quick_start/train.py:19, :126: Adam(2e-3)), B=32;
#: (c) the word2vec n-gram net at the demo's widths (emb 32, hid 64,
#: 5-gram; demo/word2vec/train.py:39-44) over imikolov's default
#: vocabulary of 2000 (hsigmoid: 2047 nodes; NCE: 10 noise classes a
#: row), B=128, AdaGrad(0.1); (d) the golden ctc net at lstm_b64h256's
#: shape: B=64, T=100, 128-d frames, an LSTM of 256, 29 outputs (28
#: labels and the last-index blank), input lengths 60-100, label lengths
#: 10-40
SPARSE_STEPS, SPARSE_CHECK_B = 4, 4
REC_B, REC_LR = 128, 1e-3
LR_VOCAB, LR_B, LR_LR = 1000, 32, 2e-3
W2V_VOCAB, W2V_EMB, W2V_HID, W2V_NGRAM, W2V_B, W2V_LR = (2000, 32, 64, 5,
                                                         128, 0.1)
CTC_B, CTC_T, CTC_IN, CTC_HID, CTC_CLASSES = 64, 100, 128, 256, 29
CTC_IN_LEN, CTC_LAB_LEN = (60, 100), (10, 40)
#: card vs CPU on the sparse parts at f32: the loss (rel) and each
#: gradient's max |diff| against its largest entry (f32 sums in another
#: order: the LSTM over 100 steps, cuBLAS against the CPU's GEMM)
TOL_SPARSE_LOSS, TOL_SPARSE_GRAD = 1e-5, 1e-3

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
    # K8's lse (max abs; ~10.8 here): f32 sums of 30000 terms in another
    # order (per lane, warp, block, then across the cluster), each term
    # 2^(x log2 e) from the card's ex2 (relative error about 2^-22)
    "topk_lse_logits": 1e-5,
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
    # K5 states, probs, s_prev (max abs; |s| < 2.5): f32, sums of up to
    # 1024 terms in another order, carried over 32 steps
    "attn_dec_fwd/float32": 2e-5,
    # bf16: a last-bit difference in a float32 sum (q, a score, a context
    # entry) can round its bf16 operand the other way (2^-8 relative),
    # which moves the softmax and the recurrence carries over 32 steps;
    # ctx to the same plus one bf16 ulp
    "attn_dec_fwd/bfloat16": 2e-2,
    # K6 from the same residuals, relative to each output's largest entry:
    # f32 products summed in another order over 32 reverse steps
    "attn_dec_bwd/float32": 1e-5,
    # bf16 enc / enc_proj: as f32, and a last-bit difference in d_ctx or q
    # can round its bf16 operand the other way
    "attn_dec_bwd/bfloat16": 1e-3,
    # K9 inference, f32 (max abs; |h| < 1, |c| a few units): the same f32
    # math summed in another order, carried over 100 dependent steps
    "lstm_forward/float32": 1e-5,
    # bf16: a last-bit difference in the f32 carry can flip the bf16
    # rounding of one product operand (2^-8 relative), which the recurrence
    # carries over 100 steps
    "lstm_forward/bfloat16": 5e-3,
    # K9 with residuals at H = 256 under bf16: h and c as
    # lstm_forward/bfloat16; z, h_prev and c_prev, stored in bf16, to the
    # same plus one bf16 ulp (their rounding may go either way)
    "lstm_forward_residuals_b64h256": 5e-3,
    # at H = 1280 the residuals are f32: z, h_prev and c_prev differ only
    # as h and c do (a bf16 product operand rounded the other way), so no
    # ulp allowance
    "lstm_forward_residuals_b64h1280": 5e-3,
    # K10 from K9's residuals, relative to each output's largest entry:
    # f32 products with w_t summed in another order over 100 reverse steps
    # (bf16 residuals at H = 256, widened exactly on both sides)
    "lstm_backward_b64h256": 1e-4,
    # the same at H = 1280 with f32 residuals, 5120-term sums
    "lstm_backward_b64h1280": 1e-4,
    # K11 against its plain version (two one-direction step loops): as K3
    # (gru_forward/*, gru_forward_residuals) and K4 (gru_backward); K11
    # against K3/K4 themselves is held bit for bit
    # K12 (max abs; lse ~ 10-13 here): f32 sums of 30000 exps in another
    # order (each lane ~940 in sequence, then a 32-way tree) against the
    # plain two-pass sum
    "logsumexp_rows": 2e-5,
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


def graph_ms(fn, flush, reps: int = 20) -> float:
    """Median device time of one call captured in a CUDA graph and replayed
    (CUDA events around the replay, L2 flushed before each): the kernels'
    time without the host's, which ``time_ms`` includes wherever the host
    enqueues a call more slowly than the card runs it.  Not for cuBLAS
    calls: capturing one leaves a cuBLAS workspace allocated for the
    capture stream, which every later phase's peak memory would count."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return time_ms(graph.replay, flush, reps)


def bound_ms(nbytes: float, ops: float, dtype: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# phases 3 and 4: kernels against their plain versions; product timing
# ---------------------------------------------------------------------------


def check_gru(K, flush, dev):
    """K3 (inference) at a full serve prefill: against its plain version
    under f32 (its steps kernels) and bf16 (its persistent kernel, also
    held and timed on its steps kernels)."""
    import torch

    from paddle_tpu_torch.ops.kernels.gru import (GRU_FORWARD, _device_sms,
                                                  _gru_fwd_plan,
                                                  gru_fwd_kernel_info)
    from paddle_tpu_torch.ops.kernels.gru import _launch_fwd as \
        _gru_launch_fwd
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
            want_path = "persistent" if cd == "bfloat16" else "steps"
            before = _paths(GRU_FORWARD)
            hk, fk = K.gru_forward(xp, mask, w_h)
            took = _paths_since(GRU_FORWARD, before)
            if took != {want_path: 1}:
                fail("kernels", f"gru_forward {cd} took {took}, not "
                     f"{want_path}")
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
        hs, fs = _gru_launch_fwd(xp, mask, w_h, None, False, "steps")
        err_s = max(_max_err(hs, hp), _max_err(fs, fp))
        if not err_s <= TOL["gru_forward/bfloat16"]:
            fail("kernels", f"gru_forward steps kernels bf16: max abs err "
                 f"{err_s}")
        ms = time_ms(lambda: K.gru_forward(xp, mask, w_h), flush)
        steps_ms = time_ms(lambda: _gru_launch_fwd(xp, mask, w_h, None,
                                                   False, "steps"), flush)
        plain_ms = time_ms(lambda: K.gru_forward_plain(xp, mask, w_h), flush)
    nbytes = (T * B * 3 * H * 4 + T * B * 4 + H * 3 * H * 2 + T * B * H * 4
              + B * H * 4)
    bms, by = bound_ms(nbytes, 2.0 * T * B * H * 3 * H, "bfloat16")
    sms = _device_sms(dev)
    info = gru_fwd_kernel_info(B, H, sms)
    print(f"kernels: gru_forward B={B} T={T} H={H} max_abs_err f32="
          f"{errs['float32']:.3e} (tol {TOL['gru_forward/float32']}, steps "
          f"kernels) bf16={errs['bfloat16']:.3e} (tol "
          f"{TOL['gru_forward/bfloat16']}, path=persistent "
          f"{_gru_fwd_plan(B, H, sms)}; steps kernels {err_s:.3e}; "
          f"{_info_text(info)}) ms={ms:.4f} (share of bound {bms / ms:.3f})"
          f" steps_ms={steps_ms:.4f} plain_ms={plain_ms:.4f} "
          f"bound_ms={bms:.5f} ({by})", flush=True)
    return dict(_kernel_row("gru_forward", "gru_forward.cu", "308",
                            errs["bfloat16"], ms, plain_ms, bms, by, None),
                **_persistent_fields(ms, steps_ms, bms, info))


def _info_text(info) -> str:
    return ("registers / spilled bytes a thread / shared bytes a block: "
            + ", ".join(f"{k} {r}/{l}/{m}" for k, (r, l, m) in info.items()))


def _host_ms(fn, reps: int = 200) -> float:
    """Host time of one call that only enqueues work (mean of ``reps``,
    card synchronised before and after, not inside)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / reps * 1e3


def _topk_against_plain(K, s, w, b, k, tol, what):
    """K7 on (s, w, b) against its plain version: values and lse within
    tol, ids equal wherever the plain top-(k+1) values are further apart
    than tol (elsewhere a tie within rounding may flip) and in the vocab.
    -> (max abs err, rows with identical ids, decisive rows, results)."""
    import torch

    V = w.shape[1]
    kv, ki, kl = K.topk_lse_readout(s, w, b, k)
    pv, pi, pl = K.topk_lse_readout_plain(s, w, b, k)
    torch.cuda.synchronize()
    err = max((kv - pv).abs().max().item(), (kl - pl).abs().max().item())
    if not err <= tol:
        fail("kernels", f"topk_lse_readout {what} k={k}: max abs err {err} "
             f"> {tol}")
    logits = torch.matmul(s.float(), w.float()) + b
    pv1 = torch.sort(logits, dim=1, descending=True).values[:, :k + 1]
    del logits
    gaps = (pv1[:, :-1] - pv1[:, 1:]).min(dim=1).values
    decisive = gaps > tol
    bad = (ki != pi).any(dim=1) & decisive
    if bad.any():
        fail("kernels", f"topk_lse_readout {what} k={k}: ids differ on "
             f"{int(bad.sum())} decisive rows")
    if int(ki.max()) >= V or int(ki.min()) < 0:
        fail("kernels", f"topk_lse_readout {what} k={k}: id out of vocab")
    same = int((ki == pi).all(dim=1).sum())
    return err, same, int(decisive.sum()), (kv, ki, kl)


def check_topk(K, flush, dev):
    """K7 at the serve readout (N = 64 slots x 3 beams, D = 512,
    V = 30000, bf16) and at a solo decode (N = 3), k in {1, 3, 16}: the
    wrapper must take the TMA + wgmma pass 1 at both, hold the plain
    version, and give the N = 3 call's rows bit for bit as the same rows of
    the N = 192 call (rows 0-2 and 96-98, another place in the tile); the
    SIMT pass 1 (the path for shapes TMA cannot take) held at V = 30001 and
    timed beside the wgmma path at the serve shape."""
    import torch

    from paddle_tpu_torch.ops.kernels.topk_readout import (TOPK_LSE_READOUT,
                                                           _launch,
                                                           topk_kernel_info)

    N, D, V = SLOTS * BEAM, 512, 30000     # one decode step of the table
    info = topk_kernel_info(D)
    print("kernels: topk_lse_readout pass 1 registers / spilled bytes a "
          "thread / shared bytes a block: " + ", ".join(
              f"{k} {r}/{l}/{m}" for k, (r, l, m) in info.items()),
          flush=True)
    g = torch.Generator().manual_seed(SEED + 1)
    s = torch.tanh(torch.randn(N, D, generator=g)).to(dev).bfloat16()
    w = ((2.0 / (D + V)) ** 0.5
         * torch.randn(D, V + 1, generator=g)).to(dev).bfloat16()
    b = (0.01 * torch.randn(V + 1, generator=g)).to(dev)
    w_r, b_r = w, b                        # V + 1 = 30001: SIMT
    w, b = w[:, :V].contiguous(), b[:V].contiguous()
    tol = TOL["topk_lse_readout"]
    worst = 0.0
    for k in (BEAM, 1, 16):                # beam search, greedy, the most
        before = _paths(TOPK_LSE_READOUT)
        err, same, dec, (kv, ki, kl) = _topk_against_plain(
            K, s, w, b, k, tol, f"N={N}")
        for rows in (slice(0, 3), slice(96, 99)):
            sv, si, sl = K.topk_lse_readout(s[rows].contiguous(), w, b, k)
            if not (torch.equal(sv, kv[rows]) and torch.equal(si, ki[rows])
                    and torch.equal(sl, kl[rows])):
                fail("kernels", f"topk_lse_readout k={k}: an N=3 call's "
                     f"rows differ from rows {rows.start}-{rows.stop - 1} "
                     f"of the N={N} call")
        err3 = _topk_against_plain(K, s[:3].contiguous(), w, b, k, tol,
                                   "N=3")[0]
        took = _paths_since(TOPK_LSE_READOUT, before)
        if took != {"wgmma": 4}:
            fail("kernels", f"topk_lse_readout k={k} took {took}, not the "
                 f"wgmma path")
        before = _paths(TOPK_LSE_READOUT)
        err_r, same_r, dec_r, _ = _topk_against_plain(
            K, s, w_r, b_r, k, tol, f"V={V + 1}")
        took = _paths_since(TOPK_LSE_READOUT, before)
        if took != {"simt": 1}:
            fail("kernels", f"topk_lse_readout V={V + 1} took {took}, not "
                 f"the simt path")
        worst = max(worst, err, err3)
        print(f"kernels: topk_lse_readout N={N} D={D} V={V} k={k} bf16 "
              f"path=wgmma max_abs_err={err:.3e} (N=3 {err3:.3e}; tol "
              f"{tol}) ids identical on {same}/{N} rows, on all {dec} rows "
              f"whose top-{k + 1} gaps exceed tol; N=3 rows bit-equal to "
              f"rows 0-2 and 96-98 of N={N}; path=simt at V={V + 1}: "
              f"max_abs_err={err_r:.3e}, ids identical on {same_r}/{N}, on "
              f"all {dec_r} decisive rows", flush=True)
    ms = time_ms(lambda: K.topk_lse_readout(s, w, b, BEAM), flush)
    simt_ms = time_ms(lambda: _launch(s, w, b, BEAM, "simt"), flush)
    dev_ms = graph_ms(lambda: _launch(s, w, b, BEAM, "wgmma"), flush)
    simt_dev_ms = graph_ms(lambda: _launch(s, w, b, BEAM, "simt"), flush)
    plain_ms = time_ms(lambda: K.topk_lse_readout_plain(s, w, b, BEAM), flush)
    host_ms = _host_ms(lambda: K.topk_lse_readout(s, w, b, BEAM))
    b16 = b.bfloat16()

    def library():
        logits = torch.addmm(b16, s, w)
        return torch.topk(logits, BEAM), torch.logsumexp(logits.float(), -1)

    library_ms = time_ms(library, flush)
    nbytes = N * D * 2 + D * V * 2 + V * 4 + N * BEAM * (4 + 8) + N * 4
    bms, by = bound_ms(nbytes, 2.0 * N * D * V, "bfloat16")
    print(f"kernels: topk_lse_readout k={BEAM} path=wgmma ms={ms:.4f} (share "
          f"of bound {bms / ms:.3f}) simt_ms={simt_ms:.4f} plain_ms="
          f"{plain_ms:.4f} library_ms={library_ms:.4f} (addmm + topk + "
          f"logsumexp) bound_ms={bms:.5f} ({by}); the wrapper's host time "
          f"{host_ms:.4f} ms a call; device time (one call replayed from a "
          f"CUDA graph) wgmma {dev_ms:.4f} simt {simt_dev_ms:.4f} ms",
          flush=True)
    row = _kernel_row("topk_lse_readout", "topk_lse_readout.cu", "1279",
                      worst, ms, plain_ms, bms, by, library_ms)
    row.update(simt_ms=simt_ms, wrapper_host_ms=host_ms, device_ms=dev_ms,
               simt_device_ms=simt_dev_ms)
    return row


def check_topk_wide(K, flush, dev, card):
    """K7 at the speculative wide verify: greedy (k = 1) over (SPEC_K + 1)
    x SLOTS = 320 rows, where the plain table step reads SLOTS = 64.
    Greedy verification is bit-identical only if a row's (vals, idx, lse)
    do not depend on N: every 64-row block of the N = 320 call equals an
    N = 64 call on those rows bit for bit, both take the wgmma pass 1, and
    the N = 320 call holds the plain version.  Returns the K7 row's spec
    fields: each N's time and bound."""
    import torch

    from paddle_tpu_torch.ops.kernels.topk_readout import TOPK_LSE_READOUT

    n_wide, D, V = (SPEC_K + 1) * SLOTS, 512, 30000
    g = torch.Generator().manual_seed(SEED + 3)
    s = torch.tanh(torch.randn(n_wide, D, generator=g)).to(dev).bfloat16()
    w = ((2.0 / (D + V)) ** 0.5
         * torch.randn(D, V, generator=g)).to(dev).bfloat16()
    b = (0.01 * torch.randn(V, generator=g)).to(dev)
    tol = TOL["topk_lse_readout"]
    before = _paths(TOPK_LSE_READOUT)
    err, same, dec, (kv, ki, kl) = _topk_against_plain(
        K, s, w, b, 1, tol, f"N={n_wide}")
    for r0 in range(0, n_wide, SLOTS):
        rows = slice(r0, r0 + SLOTS)
        sv, si, sl = K.topk_lse_readout(s[rows].contiguous(), w, b, 1)
        if not (torch.equal(sv, kv[rows]) and torch.equal(si, ki[rows])
                and torch.equal(sl, kl[rows])):
            fail("kernels", f"topk_lse_readout k=1: an N={SLOTS} call's rows "
                 f"differ from rows {r0}-{r0 + SLOTS - 1} of the "
                 f"N={n_wide} call")
    took = _paths_since(TOPK_LSE_READOUT, before)
    if took != {"wgmma": 1 + n_wide // SLOTS}:
        fail("kernels", f"topk_lse_readout at N={n_wide} and N={SLOTS} took "
             f"{took}, not the wgmma path")
    out = {}
    for n in (SLOTS, n_wide):
        sn = s[:n].contiguous()
        ms = time_ms(lambda: K.topk_lse_readout(sn, w, b, 1), flush)
        plain_ms = time_ms(lambda: K.topk_lse_readout_plain(sn, w, b, 1),
                           flush)
        nbytes = n * D * 2 + D * V * 2 + V * 4 + n * (4 + 8) + n * 4
        bms, by = bound_ms(nbytes, 2.0 * n * D * V, "bfloat16")
        out[n] = (ms, plain_ms, bms, by)
        print(f"kernels: topk_lse_readout N={n} D={D} V={V} k=1 bf16 "
              f"path=wgmma ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms="
              f"{bms:.5f} ({by}; share of bound {bms / ms:.3f}) [{card}]",
              flush=True)
    print(f"kernels: topk_lse_readout k=1 N={n_wide} (the wide verify) "
          f"max_abs_err={err:.3e} (tol {tol}), ids identical on "
          f"{same}/{n_wide} rows, on all {dec} decisive rows; each "
          f"{SLOTS}-row block bit-equal to an N={SLOTS} call; both on "
          f"wgmma; N={n_wide} takes {out[n_wide][0] / out[SLOTS][0]:.2f}x "
          f"the N={SLOTS} time [{card}]", flush=True)
    return {"wide_rows": n_wide, "wide_max_abs_err": err,
            "ms_n320": out[n_wide][0], "plain_ms_n320": out[n_wide][1],
            "bound_ms_n320": out[n_wide][2], "bound_by_n320": out[n_wide][3],
            "ms_n64": out[SLOTS][0], "plain_ms_n64": out[SLOTS][1],
            "bound_ms_n64": out[SLOTS][2], "bound_by_n64": out[SLOTS][3]}


def check_topk_logits(K, flush, dev):
    """K8 at the DSL generation's decode step: N = 64 sources x 3 beams,
    V = 30000, k = 3, on f32 logits (the step's ``fc`` output) and on bf16
    ones, with an integer-valued tie row, a row of ties, a row with -inf
    entries and an all -inf row: ids and values identical, lse within tol;
    an N = 37 call's rows bit-equal to the same rows of the N = 192 call
    (rows 0-36 and 96-132).  Timed as the wrapper (``ms``), as one call
    replayed from a CUDA graph (``device_ms``) and as the wrapper's host
    time a call."""
    import torch

    from paddle_tpu_torch.ops.kernels.topk_logits import (
        _THREADS, TOPK_LSE_LOGITS, _k8_plan, _launch, topk_logits_kernel_info)

    N, V, k = DSLGEN_B * BEAM, DSLGEN_VOCAB, BEAM
    g = torch.Generator().manual_seed(SEED + 7)
    logits = torch.randn(N, V, generator=g)
    logits[0] = torch.randint(-2, 3, (V,), generator=g).float()
    logits[1] = 0.0
    logits[2, ::3] = -float("inf")
    logits[3] = -float("inf")
    logits = logits.to(dev)
    tol = TOL["topk_lse_logits"]
    worst = 0.0
    plans = {}
    for dt in (torch.float32, torch.bfloat16):
        x = logits.to(dt)
        before = TOPK_LSE_LOGITS.launches
        kv, ki, kl = K.topk_lse_logits(x, k)
        if TOPK_LSE_LOGITS.launches != before + 1:
            fail("kernels", f"topk_lse_logits {dt}: a call counted "
                 f"{TOPK_LSE_LOGITS.launches - before} launches")
        pv, pi, pl = K.topk_lse_logits_plain(x, k)
        torch.cuda.synchronize()
        err = (kl - pl).abs().max().item()
        if not (torch.equal(ki, pi) and torch.equal(kv, pv) and err <= tol):
            fail("kernels", f"topk_lse_logits {dt}: ids or values differ "
                 f"from the plain version, or lse err {err} > {tol}")
        for rows in (slice(0, 37), slice(96, 133)):
            part = K.topk_lse_logits(x[rows].contiguous(), k)
            if not all(torch.equal(a, b[rows])
                       for a, b in zip(part, (kv, ki, kl))):
                fail("kernels", f"topk_lse_logits {dt}: an N=37 call's rows "
                     f"differ from rows {rows.start}-{rows.stop - 1} of the "
                     f"N={N} call")
        worst = max(worst, err)
        plan = _k8_plan(V, dt)
        plans[str(dt)[6:]] = dict(plan._asdict(), threads=_THREADS)
        print(f"kernels: topk_lse_logits N={N} V={V} k={k} {str(dt)[6:]} "
              f"logits (tie, -inf and all -inf rows): ids and values "
              f"identical, lse max_abs_err={err:.3e} (tol {tol}); N=37 rows "
              f"bit-equal to rows 0-36 and 96-132 of N={N}; plan "
              f"{plan.clusters} blocks (one cluster) x {_THREADS} "
              f"threads a row, slice {plan.slice}, chunk {plan.chunk}; "
              f"registers / spilled bytes / static shared bytes "
              f"{'/'.join(map(str, topk_logits_kernel_info(dt, k)))}",
              flush=True)
    x = torch.randn(N, V, generator=g).to(dev)
    xb = x.bfloat16()
    plan32, plan16 = _k8_plan(V, x.dtype), _k8_plan(V, xb.dtype)
    ms = time_ms(lambda: K.topk_lse_logits(x, k), flush)
    dev_ms = graph_ms(lambda: _launch(x, k, plan32), flush)
    bf16_ms = time_ms(lambda: K.topk_lse_logits(xb, k), flush)
    bf16_dev_ms = graph_ms(lambda: _launch(xb, k, plan16), flush)
    host_ms = _host_ms(lambda: K.topk_lse_logits(x, k))
    plain_ms = time_ms(lambda: K.topk_lse_logits_plain(x, k), flush)
    library_ms = time_ms(lambda: (torch.topk(x, k),
                                  torch.logsumexp(x, -1)), flush)
    nbytes = N * V * 4 + N * k * (4 + 8) + N * 4
    bms, by = bound_ms(nbytes, 3.0 * N * V, "float32")
    bms16, _ = bound_ms(N * V * 2 + N * k * (4 + 8) + N * 4, 3.0 * N * V,
                        "float32")
    print(f"kernels: topk_lse_logits f32 k={k} ms={ms:.4f} (share of bound "
          f"{bms / ms:.3f}) device_ms={dev_ms:.5f} (one call replayed from a "
          f"CUDA graph; share of bound {bms / dev_ms:.3f}) the wrapper's "
          f"host time {host_ms:.4f} ms a call; plain_ms={plain_ms:.4f} "
          f"library_ms={library_ms:.4f} (topk + logsumexp) bound_ms="
          f"{bms:.5f} ({by}); bf16 ms={bf16_ms:.4f} device_ms="
          f"{bf16_dev_ms:.5f} bound_ms={bms16:.5f}", flush=True)
    row = _kernel_row("topk_lse_logits", "topk_lse_logits.cu", "1346",
                      worst, ms, plain_ms, bms, by, library_ms)
    row.update(device_ms=dev_ms, wrapper_host_ms=host_ms,
               share_of_bound=bms / ms, device_share_of_bound=bms / dev_ms,
               bf16_ms=bf16_ms, bf16_device_ms=bf16_dev_ms,
               bf16_bound_ms=bms16, plan=plans)
    return row


def _kernel_row(name, source, replaces, err, ms, plain_ms, bms, by,
                library_ms):
    return {"name": name, "route": "cuda",
            "source": f"paddle_tpu_torch/csrc/{source}",
            "replaces": f"paddle_tpu/ops/pallas_kernels.py:{replaces}",
            "launches": 0, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "library_ms": library_ms}


def _persistent_fields(ms, steps_ms, bms, info) -> dict:
    """The ``kernels`` line's extra keys of a kernel with a persistent and a
    steps path: the path its timed call took (the caller fails the run
    unless it is the persistent one), the steps kernels' time in the same
    run, each path's share of the bound, and [registers a thread, spilled
    bytes a thread, shared bytes a block] of each kernel."""
    return {"path": "persistent", "steps_ms": steps_ms,
            "share_of_bound": bms / ms,
            "steps_share_of_bound": bms / steps_ms,
            "kernel_info": {k: list(v) for k, v in info.items()}}


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


#: K4's second batch: not a multiple of the persistent kernel's 16-row
#: tile or the steps kernels' 32-row block
GRU_RAGGED_B = 37


def check_gru_train(K, flush, dev):
    """K3 with residuals and K4 at the training shape.  Each must take its
    persistent kernel; each is also held and timed on its steps kernels,
    and its first 37 rows are held bit for bit against a 37-row call."""
    import torch

    from paddle_tpu_torch.ops.kernels.gru import (GRU_BACKWARD, GRU_FORWARD,
                                                  _device_sms, _gru_bwd_plan,
                                                  _gru_fwd_plan,
                                                  gru_bwd_kernel_info,
                                                  gru_fwd_kernel_info)
    from paddle_tpu_torch.ops.kernels.gru import _launch_bwd as \
        _gru_launch_bwd
    from paddle_tpu_torch.ops.kernels.gru import _launch_fwd as \
        _gru_launch_fwd
    from paddle_tpu_torch.ops.numerics import compute_dtype_scope

    sms = _device_sms(dev)

    xp, mask, w_h, d_out, d_hfin = _train_gru_inputs(dev)
    B, T, H3 = xp.shape
    H = H3 // 3
    rows = []
    with compute_dtype_scope("bfloat16"):
        before = _paths(GRU_FORWARD)
        hk, fk, zk, pk = K.gru_forward(xp, mask, w_h, residuals=True)
        took = _paths_since(GRU_FORWARD, before)
        if took != {"persistent": 1}:
            fail("kernels", f"gru_forward residuals took {took}, not the "
                 f"persistent kernel")
        hp, fp, zp, pp = K.gru_forward_plain(xp, mask, w_h, residuals=True)
        steps = _gru_launch_fwd(xp, mask, w_h, None, True, "steps")
        torch.cuda.synchronize()
        tol = TOL["gru_forward_residuals"]
        errs = {}
        for what, (h_, f_, z_, p_) in (("persistent", (hk, fk, zk, pk)),
                                       ("steps", steps)):
            errs[what] = max(_max_err(h_, hp), _max_err(f_, fp))
            if not (errs[what] <= tol and _within_bf16_ulp(z_, zp, tol)
                    and _within_bf16_ulp(p_, pp, tol)) \
                    or z_.dtype != torch.bfloat16:
                fail("kernels", f"gru_forward residuals ({what} kernels): "
                     f"h err {errs[what]} (tol {tol}), z/h_prev beyond tol "
                     f"+ one bf16 ulp or not bf16 ({z_.dtype})")
        err, err_s = errs["persistent"], errs["steps"]
        # rows do not depend on B: the first GRU_RAGGED_B rows alone
        n = GRU_RAGGED_B
        sub = K.gru_forward(xp[:n].contiguous(), mask[:n].contiguous(), w_h,
                            residuals=True)
        if not all(torch.equal(a, b) for a, b in (
                (sub[0], hk[:n]), (sub[1], fk[:n]), (sub[2], zk[:, :n]),
                (sub[3], pk[:, :n]))):
            fail("kernels", f"gru_forward residuals rows 0..{n - 1} differ "
                 f"between B={B} and B={n}")
        ms = time_ms(lambda: K.gru_forward(xp, mask, w_h, residuals=True),
                     flush)
        steps_ms = time_ms(lambda: _gru_launch_fwd(xp, mask, w_h, None, True,
                                                   "steps"), flush)
        plain_ms = time_ms(lambda: K.gru_forward_plain(
            xp, mask, w_h, residuals=True), flush, reps=5)
        nbytes = (T * B * H3 * 4 + T * B * 4 + H * H3 * 2 + T * B * H * 4
                  + B * H * 4 + T * B * H3 * 2 + T * B * H * 2)
        bms, by = bound_ms(nbytes, 2.0 * T * B * H * H3, "bfloat16")
        k3_info = gru_fwd_kernel_info(B, H, sms)
        print(f"kernels: gru_forward residuals=True B={B} T={T} H={H} bf16 "
              f"path=persistent ({_gru_fwd_plan(B, H, sms)}; "
              f"{_info_text(k3_info)}) h max_abs_err={err:.3e} (steps "
              f"kernels {err_s:.3e}; tol {tol}), z and h_prev within tol + "
              f"one bf16 ulp, rows bit-equal at B={n}; ms={ms:.4f} (share "
              f"of bound {bms / ms:.3f}) steps_ms={steps_ms:.4f} plain_ms="
              f"{plain_ms:.4f} bound_ms={bms:.5f} ({by})", flush=True)
        rows.append(dict(_kernel_row("gru_forward_residuals",
                                     "gru_forward.cu", "308", err, ms,
                                     plain_ms, bms, by, None),
                         **_persistent_fields(ms, steps_ms, bms, k3_info)))

        m_tb = mask.t().contiguous()
        w_t = w_h.t().contiguous()
        bargs = [d_out, m_tb, zk, pk, w_t, d_hfin]
        before = _paths(GRU_BACKWARD)
        dk, d0k = K.gru_backward(*bargs)
        took = _paths_since(GRU_BACKWARD, before)
        if took != {"persistent": 1}:
            fail("kernels", f"gru_backward took {took}, not the persistent "
                 f"kernel")
        dp, d0p = K.gru_backward_plain(*bargs)
        ds, d0s = _gru_launch_bwd(*bargs, "steps")
        torch.cuda.synchronize()
        err = max(_max_err(dk, dp), _max_err(d0k, d0p))
        err_s = max(_max_err(ds, dp), _max_err(d0s, d0p))
        scale = max(dp.abs().max().item(), d0p.abs().max().item())
        tol = TOL["gru_backward"]
        if not (torch.isfinite(dk).all() and err <= tol * scale
                and err_s <= tol * scale):
            fail("kernels", f"gru_backward: max abs err {err} (steps kernel "
                 f"{err_s}) > {tol} x {scale}")
        # rows do not depend on B: the first GRU_RAGGED_B rows alone
        n = GRU_RAGGED_B
        sub = K.gru_backward(d_out[:, :n].contiguous(),
                             m_tb[:, :n].contiguous(),
                             zk[:, :n].contiguous(), pk[:, :n].contiguous(),
                             w_t, d_hfin[:n].contiguous())
        if not (torch.equal(sub[0], dk[:, :n]) and torch.equal(sub[1],
                                                               d0k[:n])):
            fail("kernels", f"gru_backward rows 0..{n - 1} differ between "
                 f"B={B} and B={n}")
        ms = time_ms(lambda: K.gru_backward(*bargs), flush)
        steps_ms = time_ms(lambda: _gru_launch_bwd(*bargs, "steps"), flush)
        plain_ms = time_ms(lambda: K.gru_backward_plain(*bargs), flush,
                           reps=5)
    nbytes = (T * B * H * 4 + T * B * 4 + T * B * H3 * 2 + T * B * H * 2
              + H3 * H * 4 + B * H * 4 + T * B * H3 * 4 + B * H * 4)
    bms, by = bound_ms(nbytes, 2.0 * T * B * H3 * H, "float32")
    k4_info = gru_bwd_kernel_info(H)
    print(f"kernels: gru_backward B={B} T={T} H={H} bf16 residuals "
          f"path=persistent ({_gru_bwd_plan(B, H, sms)}; "
          f"{_info_text(k4_info)}) "
          f"max_abs_err={err:.3e} (steps kernel {err_s:.3e}; tol {tol} x "
          f"max {scale:.3e}), rows bit-equal at B={n}; ms={ms:.4f} (share "
          f"of bound {bms / ms:.3f}) steps_ms={steps_ms:.4f} (share "
          f"{bms / steps_ms:.3f}) plain_ms={plain_ms:.4f} bound_ms="
          f"{bms:.5f} ({by}, f32 products)", flush=True)
    rows.append(dict(_kernel_row("gru_backward", "gru_backward.cu", "590",
                                 err, ms, plain_ms, bms, by, None),
                     **_persistent_fields(ms, steps_ms, bms, k4_info)))
    return rows


def _bigru_inputs(dev, B):
    """The flagship encoder's two directions as K11's stacked batch: B rows
    a direction (2B rows), T=32, H=512, mixed lengths; the backward half
    flipped in time, as ``bigru_layer`` stacks it."""
    import torch

    T, H = TRAIN_T, 512
    g = torch.Generator().manual_seed(SEED + 8 + B)
    lens = torch.randint(4, T + 1, (B,), generator=g)
    lens[0] = T
    mask = (torch.arange(T)[None] < lens[:, None]).float()
    xp_fw = 0.5 * torch.randn(B, T, 3 * H, generator=g)
    xp_bw = 0.5 * torch.randn(B, T, 3 * H, generator=g)
    w = [(2.0 / (H + 3 * H)) ** 0.5 * torch.randn(H, 3 * H, generator=g)
         for _ in range(2)]
    xp_tb = torch.cat([xp_fw, xp_bw.flip(1)]).transpose(0, 1).contiguous()
    m_tb = torch.cat([mask, mask.flip(1)]).t().contiguous()
    d_out = torch.randn(T, 2 * B, H, generator=g)
    d_hfin = torch.randn(2 * B, H, generator=g)
    w2 = torch.cat(w)
    w_t = torch.cat([w[0].t(), w[1].t()], 1).contiguous()
    return [t.to(dev) for t in (xp_tb, m_tb, w2, w_t, d_out, d_hfin)]


def check_bigru(K, flush, dev):
    """K11 (inference and residual variants, and the reverse loop) at the
    flagship encoder's training shape (B=384 a direction), in f32 and
    bf16: against its plain version, and bit for bit against K3/K4 called
    once per direction on the same rows; timed beside that two-call pair,
    the residual variant and the reverse at the training shape, the
    inference variant at the serving prefill's (B=64 a direction, as
    K3's row)."""
    import torch

    from paddle_tpu_torch.ops.kernels.bigru import (BIGRU_BACKWARD,
                                                    BIGRU_FORWARD)
    from paddle_tpu_torch.ops.kernels.bigru import _launch_bwd as \
        _bigru_launch_bwd
    from paddle_tpu_torch.ops.kernels.bigru import _launch_fwd as \
        _bigru_launch_fwd
    from paddle_tpu_torch.ops.kernels.gru import (_device_sms,
                                                  gru_bwd_kernel_info,
                                                  gru_fwd_kernel_info)
    from paddle_tpu_torch.ops.numerics import compute_dtype_scope

    xp, m, w2, w_t, d_out, d_hfin = _bigru_inputs(dev, TRAIN_B)
    T, B2, H3 = xp.shape
    B, H = B2 // 2, H3 // 3
    halves = ((slice(0, B), w2[:H], w_t[:, :H].contiguous()),
              (slice(B, None), w2[H:], w_t[:, H:].contiguous()))
    errs = {}
    for cd in ("float32", "bfloat16"):
        with compute_dtype_scope(cd):
            before = _paths(BIGRU_FORWARD)
            inf = K.bigru_forward(xp, m, w2, residuals=False, batch_split=B)
            res = K.bigru_forward(xp, m, w2, residuals=True, batch_split=B)
            took = _paths_since(BIGRU_FORWARD, before)
            want_path = "persistent" if cd == "bfloat16" else "steps"
            if took != {want_path: 2}:
                fail("kernels", f"bigru_forward {cd} took {took}, not "
                     f"{want_path}")
            before = _paths(BIGRU_BACKWARD)
            bwd = K.bigru_backward(d_out, m, res[2], res[3], w_t, d_hfin,
                                   batch_split=B)
            took = _paths_since(BIGRU_BACKWARD, before)
            if took != {"persistent": 1}:
                fail("kernels", f"bigru_backward {cd} took {took}, not the "
                     f"persistent kernel")
            p_inf = K.bigru_forward_plain(xp, m, w2, residuals=False,
                                          batch_split=B)
            p_res = K.bigru_forward_plain(xp, m, w2, residuals=True,
                                          batch_split=B)
            p_bwd = K.bigru_backward_plain(d_out, m, res[2], res[3], w_t,
                                           d_hfin, batch_split=B)
            torch.cuda.synchronize()
            e_inf = max(_max_err(a, c) for a, c in zip(inf, p_inf))
            e_res = max(_max_err(a, c) for a, c in zip(res[:2], p_res[:2]))
            e_bwd = max(_max_err(a, c) for a, c in zip(bwd, p_bwd))
            scale = max(c.abs().max().item() for c in p_bwd)
            tol_f = TOL[f"gru_forward/{cd}"]
            tol_r = TOL["gru_forward_residuals"]
            tol_b = TOL["gru_backward"]
            if not (e_inf <= tol_f and e_res <= tol_r
                    and all(_within_bf16_ulp(a, c, tol_r)
                            for a, c in zip(res[2:], p_res[2:]))
                    and e_bwd <= tol_b * scale):
                fail("kernels", f"bigru {cd}: against the plain version "
                     f"inference {e_inf} (tol {tol_f}), residuals {e_res} "
                     f"(tol {tol_r}), reverse {e_bwd} (tol {tol_b} x "
                     f"{scale})")
            # bit for bit against one K3 / K3r / K4 call per direction
            for rows, w, wt in halves:
                x_b, m_b = xp[:, rows].transpose(0, 1), m[:, rows].t()
                one = K.gru_forward(x_b, m_b, w)
                one_r = K.gru_forward(x_b, m_b, w, residuals=True)
                one_b = K.gru_backward(d_out[:, rows], m[:, rows],
                                       res[2][:, rows], res[3][:, rows], wt,
                                       d_hfin[rows])
                same = (torch.equal(inf[0][:, rows], one[0].transpose(0, 1))
                        and torch.equal(inf[1][rows], one[1])
                        and torch.equal(res[0][:, rows],
                                        one_r[0].transpose(0, 1))
                        and torch.equal(res[1][rows], one_r[1])
                        and torch.equal(res[2][:, rows], one_r[2])
                        and torch.equal(res[3][:, rows], one_r[3])
                        and torch.equal(bwd[0][:, rows], one_b[0])
                        and torch.equal(bwd[1][rows], one_b[1]))
                if not same:
                    fail("kernels", f"bigru {cd}: rows {rows} differ from "
                         f"K3/K4 called on them alone")
            errs[cd] = (e_inf, e_res, e_bwd, scale)
            print(f"kernels: bigru_forward/backward B=2x{B} T={T} H={H} {cd}"
                  f": vs plain inference max_abs_err={e_inf:.3e} (tol "
                  f"{tol_f}), residuals h {e_res:.3e} (tol {tol_r}) z and "
                  f"h_prev within tol + one bf16 ulp, reverse "
                  f"{e_bwd:.3e} (tol {tol_b} x max {scale:.3e}); h_seq, "
                  f"h_fin, z, h_prev, d_z, d_h0 bit-identical to one K3/K3r/"
                  f"K4 call per direction", flush=True)
    rows = []
    # the inference variant at the serving prefill: 64 requests a direction
    xs, ms_, w2s = _bigru_inputs(dev, SLOTS)[:3]
    Bs = SLOTS
    for cd in ("float32", "bfloat16"):
        with compute_dtype_scope(cd):
            before = _paths(BIGRU_FORWARD)
            got = K.bigru_forward(xs, ms_, w2s, residuals=False,
                                  batch_split=Bs)
            took = _paths_since(BIGRU_FORWARD, before)
            want_path = "persistent" if cd == "bfloat16" else "steps"
            if took != {want_path: 1}:
                fail("kernels", f"bigru_forward B=2x{Bs} {cd} took {took}, "
                     f"not {want_path}")
            want = K.bigru_forward_plain(xs, ms_, w2s, residuals=False,
                                         batch_split=Bs)
            err = max(_max_err(a, c) for a, c in zip(got, want))
            same = all(
                torch.equal(got[0][:, r], one[0].transpose(0, 1))
                and torch.equal(got[1][r], one[1])
                for r, w in ((slice(0, Bs), w2s[:H]),
                             (slice(Bs, None), w2s[H:]))
                for one in [K.gru_forward(xs[:, r].transpose(0, 1),
                                          ms_[:, r].t(), w)])
            if not (err <= TOL[f"gru_forward/{cd}"] and same):
                fail("kernels", f"bigru_forward B=2x{Bs} {cd}: max abs err "
                     f"{err}, or rows differ from one K3 call per "
                     f"direction")
        errs[f"serve/{cd}"] = err
    with compute_dtype_scope("bfloat16"):              # the working type
        _, _, zk, pk = K.bigru_forward(xp, m, w2, residuals=True,
                                       batch_split=B)

        def pair(x, mask, w2_, residuals):
            for r, w in ((slice(0, x.shape[1] // 2), w2_[:H]),
                         (slice(x.shape[1] // 2, None), w2_[H:])):
                K.gru_forward(x[:, r].transpose(0, 1), mask[:, r].t(), w,
                              residuals=residuals)

        def pair_bwd():
            for r, _, wt in halves:
                K.gru_backward(d_out[:, r], m[:, r], zk[:, r], pk[:, r], wt,
                               d_hfin[r])

        res_b = 2 if zk.dtype == torch.bfloat16 else 4
        for residuals, (x, mask, w2_) in ((False, (xs, ms_, w2s)),
                                          (True, (xp, m, w2))):
            b2 = x.shape[1]
            ms = time_ms(lambda: K.bigru_forward(
                x, mask, w2_, residuals=residuals, batch_split=b2 // 2),
                flush)
            plain_ms = time_ms(lambda: K.bigru_forward_plain(
                x, mask, w2_, residuals=residuals, batch_split=b2 // 2),
                flush, reps=5)
            pair_ms = time_ms(lambda: pair(x, mask, w2_, residuals), flush)
            steps_ms = time_ms(lambda: _bigru_launch_fwd(
                x, mask, w2_, residuals, b2 // 2, "steps"), flush)
            steps_out = _bigru_launch_fwd(x, mask, w2_, residuals, b2 // 2,
                                          "steps")
            e_steps = max(_max_err(a, c) for a, c in zip(
                steps_out[:2], K.bigru_forward_plain(
                    x, mask, w2_, residuals=residuals,
                    batch_split=b2 // 2)[:2]))
            if not e_steps <= TOL["gru_forward/bfloat16"]:
                fail("kernels", f"bigru_forward steps kernels: max abs err "
                     f"{e_steps}")
            nbytes = (T * b2 * H3 * 4 + T * b2 * 4 + 2 * H * H3 * 2
                      + T * b2 * H * 4 + b2 * H * 4
                      + (T * b2 * (H3 + H) * res_b if residuals else 0))
            bms, by = bound_ms(nbytes, 2.0 * T * b2 * H * H3, "bfloat16")
            name = "bigru_forward" + ("_residuals" if residuals else "")
            e, e32 = ((errs["bfloat16"][1], errs["float32"][1]) if residuals
                      else (errs["serve/bfloat16"], errs["serve/float32"]))
            info = gru_fwd_kernel_info(b2 // 2, H, _device_sms(dev), 2)
            print(f"kernels: {name} B=2x{b2 // 2} T={T} H={H} bf16 "
                  f"path=persistent ({_info_text(info)}) "
                  f"max_abs_err={e:.3e} (f32 {e32:.3e}; steps kernels "
                  f"{e_steps:.3e}), rows bit-identical to one "
                  f"K3{'r' if residuals else ''} call per direction; "
                  f"ms={ms:.4f} (share of bound {bms / ms:.3f}) steps_ms="
                  f"{steps_ms:.4f} plain_ms={plain_ms:.4f} two "
                  f"K3{'r' if residuals else ''} calls {pair_ms:.4f} ms "
                  f"bound_ms={bms:.5f} ({by})", flush=True)
            rows.append(dict(_kernel_row(name, "bigru_forward.cu", "308", e,
                                         ms, plain_ms, bms, by, None),
                             **_persistent_fields(ms, steps_ms, bms, info)))
        bargs = (d_out, m, zk, pk, w_t, d_hfin)
        steps = _bigru_launch_bwd(*bargs, B, "steps")
        e_steps = max(_max_err(a, c) for a, c in zip(
            steps, K.bigru_backward_plain(*bargs, batch_split=B)))
        torch.cuda.synchronize()
        ms = time_ms(lambda: K.bigru_backward(*bargs, batch_split=B), flush)
        steps_ms = time_ms(lambda: _bigru_launch_bwd(*bargs, B, "steps"),
                           flush)
        plain_ms = time_ms(lambda: K.bigru_backward_plain(
            *bargs, batch_split=B), flush, reps=5)
        pair_ms = time_ms(pair_bwd, flush)
    nbytes = (T * B2 * H * 4 + T * B2 * 4 + T * B2 * (H3 + H) * res_b
              + H3 * 2 * H * 4 + B2 * H * 4 + T * B2 * H3 * 4 + B2 * H * 4)
    bms, by = bound_ms(nbytes, 2.0 * T * B2 * H3 * H, "float32")
    if not e_steps <= TOL["gru_backward"] * errs["bfloat16"][3]:
        fail("kernels", f"bigru_backward steps kernel: max abs err "
             f"{e_steps}")
    print(f"kernels: bigru_backward B=2x{B} T={T} H={H} bf16 residuals "
          f"path=persistent (steps kernel max_abs_err {e_steps:.3e}) "
          f"ms={ms:.4f} (share of bound {bms / ms:.3f}) steps_ms="
          f"{steps_ms:.4f} (share {bms / steps_ms:.3f}) plain_ms="
          f"{plain_ms:.4f} two K4 calls (one per direction, persistent) "
          f"{pair_ms:.4f} ms bound_ms={bms:.5f} ({by}, f32 products)",
          flush=True)
    rows.append(dict(_kernel_row("bigru_backward", "bigru_backward.cu",
                                 "590", errs["bfloat16"][2], ms, plain_ms,
                                 bms, by, None),
                     **_persistent_fields(ms, steps_ms, bms,
                                          gru_bwd_kernel_info(H))))
    return rows


def check_lse(K, flush, dev):
    """K12 at the training readout's logits: N = B*T = 12288, V = 30000, in
    bf16 (the compute dtype's logits) and f32, with a row holding -inf
    entries and an all -inf row (nan, the reference's answer); then a
    ragged V whose bf16 rows are not 16-byte aligned."""
    import torch

    N, V = TRAIN_B * TRAIN_T, 30000
    g = torch.Generator().manual_seed(SEED + 9)
    tol = TOL["logsumexp_rows"]
    worst = 0.0
    for n, v in ((N, V), (N, V + 1)):
        logits = 3.0 * torch.randn(n, v, generator=g)
        logits[1, ::3] = -float("inf")
        logits[2] = -float("inf")
        logits = logits.to(dev)
        keep = torch.arange(n, device=dev) != 2
        for dt in (torch.bfloat16, torch.float32):
            x = logits.to(dt)
            got = K.logsumexp_rows(x)
            want = K.logsumexp_rows_plain(x)
            torch.cuda.synchronize()
            err = _max_err(got[keep], want[keep])
            if not (err <= tol and bool(torch.isnan(got[2]))
                    and bool(torch.isfinite(got[keep]).all())):
                fail("kernels", f"logsumexp_rows N={n} V={v} {dt}: max abs "
                     f"err {err} (tol {tol}), or the all -inf row not nan")
            worst = max(worst, err)
            print(f"kernels: logsumexp_rows N={n} V={v} {str(dt)[6:]} "
                  f"(-inf entries, an all -inf row -> nan): max_abs_err="
                  f"{err:.3e} (tol {tol})", flush=True)
        del logits, x
    x = (3.0 * torch.randn(N, V, generator=g)).to(dev).bfloat16()
    ms = time_ms(lambda: K.logsumexp_rows(x), flush)
    plain_ms = time_ms(lambda: K.logsumexp_rows_plain(x), flush, reps=10)
    library_ms = time_ms(lambda: torch.logsumexp(x.float(), -1), flush)
    nbytes = N * V * 2 + N * 4
    bms, by = bound_ms(nbytes, 3.0 * N * V, "float32")
    print(f"kernels: logsumexp_rows N={N} V={V} bf16 ms={ms:.4f} "
          f"plain_ms={plain_ms:.4f} library_ms={library_ms:.4f} "
          f"(torch.logsumexp(x.float(), -1)) bound_ms={bms:.5f} ({by})",
          flush=True)
    return _kernel_row("logsumexp_rows", "logsumexp_rows.cu", "648", worst,
                       ms, plain_ms, bms, by, library_ms)


def _ce_wmma_direct(fwd: bool, *args):
    """The WMMA kernels (the path for bf16 shapes TMA cannot take) launched
    at the training shape through their C entry points, to hold and time
    them beside the wgmma path; not counted as launches."""
    import torch

    from paddle_tpu_torch.ops.kernels.ce_readout import (CE_READOUT_BWD,
                                                         CE_READOUT_FWD)

    stream = torch.cuda.current_stream().cuda_stream
    if fwd:
        s, w, b, lab = args
        N, V = s.shape[0], w.shape[1]
        out = (torch.empty(N, device=s.device),
               torch.empty(N, device=s.device),
               torch.empty(N, V, dtype=s.dtype, device=s.device))
        lab32 = lab.to(torch.int32)
        CE_READOUT_FWD.call("ce_readout_fwd_bf16", s.data_ptr(), w.data_ptr(),
                            b.data_ptr(), lab32.data_ptr(),
                            *(t.data_ptr() for t in out), N, s.shape[1], V,
                            stream)
        return out
    logits, s, w, lab, lse, scale = args
    N, V, D = logits.shape[0], logits.shape[1], s.shape[1]
    out = (torch.empty(N, D, device=s.device),
           torch.empty(D, V, device=s.device), torch.empty(V, device=s.device))
    lab32 = lab.to(torch.int32)
    CE_READOUT_BWD.call("ce_readout_bwd_bf16", logits.data_ptr(), s.data_ptr(),
                        w.data_ptr(), lab32.data_ptr(), lse.data_ptr(),
                        scale.data_ptr(), *(t.data_ptr() for t in out), N, D,
                        V, stream)
    return out


def _all_persistent(phase: str, label: str, launches, names) -> None:
    """Fail unless every launch of each kernel ``names`` in ``launches``
    took its persistent kernel."""
    for name in names:
        n = launches[name]
        if n and launches.by_path[name] != {"persistent": n}:
            fail(phase, f"{label}: {name} launches by path "
                 f"{launches.by_path[name]}, not all persistent")


def _paths(lib) -> dict:
    return dict(lib.launches_by_path)


def _paths_since(lib, before: dict) -> dict:
    """The launches by path since ``before`` (paths that moved only)."""
    return {k: v - before.get(k, 0) for k, v in _paths(lib).items()
            if v != before.get(k, 0)}


def check_ce(K, flush, dev):
    """K1 and K2 at the training readout: N = B*T = 12288, D = 512,
    V = 30000, bf16 operands, 1/12 of the rows masked.  The wrappers must
    take the TMA + wgmma kernels here; the WMMA kernels (the path for
    shapes TMA cannot take) are held and timed beside them."""
    import torch

    from paddle_tpu_torch.ops.kernels.ce_readout import (CE_READOUT_BWD,
                                                         CE_READOUT_FWD,
                                                         ce_kernel_info)

    N, D, V = TRAIN_B * TRAIN_T, 512, 30000
    info = ce_kernel_info(D)
    print("kernels: ce_readout registers / spilled bytes a thread / shared "
          "bytes a block: " + ", ".join(
              f"{k} {r}/{l}/{m}" for k, (r, l, m) in info.items()),
          flush=True)
    g = torch.Generator().manual_seed(SEED + 3)
    s = torch.tanh(torch.randn(N, D, generator=g)).to(dev).bfloat16()
    w = ((2.0 / (D + V)) ** 0.5
         * torch.randn(D, V, generator=g)).to(dev).bfloat16()
    b = (0.01 * torch.randn(V, generator=g)).to(dev)
    lab = torch.randint(0, V, (N,), generator=g).to(dev)
    mask = (torch.rand(N, generator=g) > 1 / 12).float().to(dev)
    scale = mask / mask.sum()

    before = _paths(CE_READOUT_FWD)
    pk, lk, logk = K.ce_readout_fwd(s, w, b, lab)
    took = _paths_since(CE_READOUT_FWD, before)
    if took != {"wgmma": 1}:
        fail("kernels", f"ce_readout_fwd at the training shape took {took}, "
             f"not the wgmma path")
    pp, lp, logp = K.ce_readout_fwd_plain(s, w, b, lab)
    pw, lw, logw = _ce_wmma_direct(True, s, w, b, lab)
    torch.cuda.synchronize()
    err = max(_max_err(pk, pp), _max_err(lk, lp))
    err_w = max(_max_err(pw, pp), _max_err(lw, lp))
    tol = TOL["ce_readout_fwd"]
    if not (err <= tol and _within_bf16_ulp(logk, logp, 1e-6)):
        fail("kernels", f"ce_readout_fwd: max abs err {err} (tol {tol}) or "
             f"logits beyond one bf16 ulp")
    if not (err_w <= tol and _within_bf16_ulp(logw, logp, 1e-6)):
        fail("kernels", f"ce_readout_fwd (wmma): max abs err {err_w} (tol "
             f"{tol}) or logits beyond one bf16 ulp")
    del logp, logw
    ms = time_ms(lambda: K.ce_readout_fwd(s, w, b, lab), flush, reps=10)
    wmma_ms = time_ms(lambda: _ce_wmma_direct(True, s, w, b, lab), flush,
                      reps=10)
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
    print(f"kernels: ce_readout_fwd N={N} D={D} V={V} bf16 path=wgmma "
          f"max_abs_err={err:.3e} (wmma {err_w:.3e}; tol {tol}), logits "
          f"within one bf16 ulp; ms={ms:.4f} (share of bound "
          f"{bms / ms:.3f}) wmma_ms={wmma_ms:.4f} plain_ms={plain_ms:.4f} "
          f"library_ms={library_ms:.4f} bound_ms={bms:.5f} ({by})",
          flush=True)
    rows = [_kernel_row("ce_readout_fwd", "ce_readout_fwd.cu", "1029", err,
                        ms, plain_ms, bms, by, library_ms)]

    before = _paths(CE_READOUT_BWD)
    gk = K.ce_readout_bwd(logk, s, w, lab, lk, scale)
    took = _paths_since(CE_READOUT_BWD, before)
    if took != {"wgmma": 1}:
        fail("kernels", f"ce_readout_bwd at the training shape took {took}, "
             f"not the wgmma path")
    gw = _ce_wmma_direct(False, logk, s, w, lab, lk, scale)
    gp = K.ce_readout_bwd_plain(logk, s, w, lab, lk, scale)
    torch.cuda.synchronize()
    tol = TOL["ce_readout_bwd"]
    err, worst, worst_w = 0.0, 0.0, 0.0
    for a, c, d in zip(gk, gp, gw):
        e = _max_err(a, c)
        err = max(err, e)
        worst = max(worst, e / c.abs().max().item())
        worst_w = max(worst_w, _max_err(d, c) / c.abs().max().item())
    if not worst <= tol:
        fail("kernels", f"ce_readout_bwd: max err / max |g| {worst} > {tol}")
    if not worst_w <= tol:
        fail("kernels", f"ce_readout_bwd (wmma): max err / max |g| {worst_w}"
             f" > {tol}")
    del gp, gw
    ms = time_ms(lambda: K.ce_readout_bwd(logk, s, w, lab, lk, scale), flush,
                 reps=10)
    wmma_ms = time_ms(lambda: _ce_wmma_direct(False, logk, s, w, lab, lk,
                                              scale), flush, reps=10)
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
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    K.ce_readout_bwd(logk, s, w, lab, lk, scale)
    torch.cuda.synchronize()
    extra = (torch.cuda.max_memory_allocated(dev) - base) / 2 ** 20
    print(f"kernels: ce_readout_bwd N={N} D={D} V={V} bf16 path=wgmma "
          f"max_abs_err={err:.3e} (max err / max |g| {worst:.3e}, wmma "
          f"{worst_w:.3e}; tol {tol}); ms={ms:.4f} (share of bound "
          f"{bms / ms:.3f}) wmma_ms={wmma_ms:.4f} plain_ms={plain_ms:.4f} "
          f"library_ms={library_ms:.4f} bound_ms={bms:.5f} ({by}); "
          f"outputs + scratch {extra:.1f} MiB", flush=True)
    rows.append(_kernel_row("ce_readout_bwd", "ce_readout_bwd.cu", "1101",
                            err, ms, plain_ms, bms, by, library_ms))
    return rows


def _kernel_split(fn) -> dict:
    """Device ms by kernel of one call of ``fn`` after a warm-up call
    (``torch.profiler``, CUDA activity): hand-written kernels by their
    name, everything else (the wrapper's PyTorch ops) as ``other``."""
    import re

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    split = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or e.is_user_annotation:
            continue
        m = re.search(r"::(\w+_kernel)\b", e.key)
        name = m.group(1) if m else "other"
        split[name] = split.get(name, 0.0) + e.self_device_time_total / 1e3
    return split


def _attn_dec_inputs(dev):
    """The training decoder's K5 inputs: T=32, B=384, S=32, D=A=512,
    2H=1024, mixed source and target lengths, float32 (cast per policy)."""
    import torch

    T, B, S, D, A, H2 = TRAIN_T, TRAIN_B, TRAIN_S, 512, 512, 1024
    g = torch.Generator().manual_seed(SEED + 5)

    def rnd(*shape, scale=1.0):
        return (scale * torch.randn(*shape, generator=g)).to(dev)

    trg_len = torch.randint(1, T + 1, (B,), generator=g)
    src_len = torch.randint(1, S + 1, (B,), generator=g)
    trg_len[0], src_len[0] = T, S
    return dict(
        xp_y=rnd(T, B, 3 * D, scale=0.5),
        m=(torch.arange(T)[:, None] < trg_len[None]).float().to(dev),
        s0=rnd(B, D, scale=0.5), enc=rnd(B, S, H2), enc_proj=rnd(B, S, A),
        src_mask=(torch.arange(S)[None] < src_len[:, None]).float().to(dev),
        att_w=rnd(D, A, scale=D ** -0.5), att_v=rnd(A, scale=2 * A ** -0.5),
        wx_c=rnd(H2, 3 * D, scale=H2 ** -0.5),
        wh=rnd(D, 3 * D, scale=D ** -0.5), d_out=rnd(T, B, D))


#: K5's second batch, as K4's: rows 0..36 alone against the 384-row call
ATTN_RAGGED_B = 37


def check_attn_dec(K, flush, dev):
    """K5 and K6 at the training decoder's shape, each held against its
    plain version under the f32 and the bf16 policy; K6 takes K5's
    residuals and the gates recomputed from them.  K5 must take its
    persistent kernel under bf16 and its steps kernels under f32; under
    bf16 it is also held and timed on the steps kernels, and its first 37
    rows are held bit for bit against a 37-row call."""
    import torch

    from paddle_tpu_torch.ops.attention_decoder import recompute_gates
    from paddle_tpu_torch.ops.kernels.attention_decoder import (
        ATTN_DEC_FWD, _attn_dec_fwd_plan, _device_sms,
        attn_dec_fwd_kernel_info)
    from paddle_tpu_torch.ops.kernels.attention_decoder import _launch_fwd \
        as _attn_launch_fwd
    from paddle_tpu_torch.ops.numerics import compute_dtype_scope

    x = _attn_dec_inputs(dev)
    T, B, D3 = x["xp_y"].shape
    D = D3 // 3
    S, H2, A = x["enc"].shape[1], x["enc"].shape[2], x["enc_proj"].shape[2]
    errs, timed = {}, {}
    for cd in ("float32", "bfloat16"):
        dt = getattr(torch, cd)
        with compute_dtype_scope(cd):
            fa = [x["xp_y"], x["m"], x["s0"], x["enc"].to(dt),
                  x["enc_proj"].to(dt), x["src_mask"], x["att_w"].to(dt),
                  x["att_v"].to(dt), x["wx_c"].to(dt), x["wh"].to(dt)]
            before = _paths(ATTN_DEC_FWD)
            got = K.attn_dec_fwd(*fa)
            took = _paths_since(ATTN_DEC_FWD, before)
            want_path = "persistent" if cd == "bfloat16" else "steps"
            if took != {want_path: 1}:
                fail("kernels", f"attn_dec_fwd {cd} took {took}, not the "
                     f"{want_path} kernel")
            want = K.attn_dec_fwd_plain(*fa)
            torch.cuda.synchronize()
            tol = TOL[f"attn_dec_fwd/{cd}"]

            def fwd_ok(out):
                err = max(_max_err(out[i], want[i]) for i in (0, 1, 3))
                ctx_ok = _within_bf16_ulp(out[2], want[2], tol) \
                    if cd == "bfloat16" else _max_err(out[2], want[2]) <= tol
                return err <= tol and ctx_ok and out[2].dtype == dt, err

            ok, err = fwd_ok(got)
            if not ok:
                fail("kernels", f"attn_dec_fwd {cd}: states/probs/s_prev "
                     f"max abs err {err} (tol {tol}) or ctx beyond it")
            errs[f"fwd/{cd}"] = max(err, _max_err(got[2], want[2]))
            if cd == "bfloat16":
                steps = _attn_launch_fwd(*fa, "steps")
                ok, err_s = fwd_ok(steps)
                if not ok:
                    fail("kernels", f"attn_dec_fwd steps kernels bf16: max "
                         f"abs err {err_s} (tol {tol}) or ctx beyond it")
                errs["fwd/steps"] = max(err_s, _max_err(steps[2], want[2]))
                n = ATTN_RAGGED_B
                sub = [a[:, :n] if i < 2 else a[:n] if i < 6 else a
                       for i, a in enumerate(fa)]
                small = K.attn_dec_fwd(*[a.contiguous() for a in sub])
                if not all(torch.equal(a, b[:, :n])
                           for a, b in zip(small, got)):
                    fail("kernels", f"attn_dec_fwd rows 0..{n - 1} differ "
                         f"between B={B} and B={n}")
            gates = recompute_gates(x["xp_y"], got[2], got[3], x["wx_c"],
                                    x["wh"], x["att_w"])
            ba = [x["d_out"], x["m"], got[3], *gates, fa[3], fa[4],
                  x["src_mask"], x["att_w"], x["att_v"], x["wh"], x["wx_c"]]
            gk = K.attn_dec_bwd(*ba)
            gp = K.attn_dec_bwd_plain(*ba)
            torch.cuda.synchronize()
            tol = TOL[f"attn_dec_bwd/{cd}"]
            worst = max(_max_err(a, c) / c.abs().max().item()
                        for a, c in zip(gk, gp))
            if not worst <= tol:
                fail("kernels", f"attn_dec_bwd {cd}: max err / max |g| "
                     f"{worst} > {tol}")
            errs[f"bwd/{cd}"] = worst
            if cd == "bfloat16":                         # the working type
                timed = {
                    "fwd": time_ms(lambda: K.attn_dec_fwd(*fa), flush),
                    "fwd_steps": time_ms(lambda: _attn_launch_fwd(
                        *fa, "steps"), flush),
                    "fwd_plain": time_ms(lambda: K.attn_dec_fwd_plain(*fa),
                                         flush, reps=5),
                    "bwd": time_ms(lambda: K.attn_dec_bwd(*ba), flush),
                    "bwd_plain": time_ms(lambda: K.attn_dec_bwd_plain(*ba),
                                         flush, reps=5)}
                split = _kernel_split(lambda: K.attn_dec_bwd(*ba))
    TB = T * B
    weights_fwd = D * A + A + H2 * D3 + D * D3
    nbytes = (TB * D3 * 4 + TB * 4 + B * D * 4 + B * S * (H2 + A) * 2
              + B * S * 4 + weights_fwd * 2
              + TB * D * 4 + TB * S * 4 + TB * H2 * 2 + TB * D * 4)
    ops = 2.0 * TB * (D * A + D * 2 * D + H2 * D3 + D * D) \
        + 2.0 * TB * S * (A + H2)
    f_bms, f_by = bound_ms(nbytes, ops, "bfloat16")
    nbytes = (5 * TB * D * 4 + TB * 4 + TB * A * 4 + B * S * (H2 + A) * 2
              + B * S * 4 + A * 4 + (D * A + D * D3 + H2 * D3) * 4
              + TB * D3 * 4 + TB * A * 4 + B * S * A * 4 + A * 4 + B * D * 4)
    ops = 2.0 * TB * (D * D + 2 * D * D + D3 * H2 + A * D) \
        + 2.0 * TB * S * (H2 + A)
    b_bms, b_by = bound_ms(nbytes, ops, "float32")
    k5_info = attn_dec_fwd_kernel_info(S, D, A, H2)
    info = ", ".join(f"{k} {r}/{l}/{m}" for k, (r, l, m) in k5_info.items())
    plan = _attn_dec_fwd_plan(B, S, D, A, H2, _device_sms(dev))
    print(f"kernels: attn_dec_fwd T={T} B={B} S={S} D=A={D} 2H={H2} "
          f"path=persistent under bf16 ({plan}; registers / spilled bytes "
          f"a thread / shared "
          f"bytes a block: {info}) max_abs_err f32="
          f"{errs['fwd/float32']:.3e} (steps kernels, tol "
          f"{TOL['attn_dec_fwd/float32']}) bf16={errs['fwd/bfloat16']:.3e} "
          f"(steps kernels {errs['fwd/steps']:.3e}; tol "
          f"{TOL['attn_dec_fwd/bfloat16']}, ctx + one bf16 ulp), rows "
          f"bit-equal at B={ATTN_RAGGED_B}; ms={timed['fwd']:.4f} (share of "
          f"bound {f_bms / timed['fwd']:.3f}) steps_ms="
          f"{timed['fwd_steps']:.4f} (share "
          f"{f_bms / timed['fwd_steps']:.3f}) plain_ms="
          f"{timed['fwd_plain']:.4f} bound_ms={f_bms:.5f} ({f_by})",
          flush=True)
    print(f"kernels: attn_dec_bwd from K5's residuals, max err / max |g| "
          f"f32={errs['bwd/float32']:.3e} (tol "
          f"{TOL['attn_dec_bwd/float32']}) bf16={errs['bwd/bfloat16']:.3e} "
          f"(tol {TOL['attn_dec_bwd/bfloat16']}); ms={timed['bwd']:.4f} "
          f"(share of bound {b_bms / timed['bwd']:.3f}) "
          f"plain_ms={timed['bwd_plain']:.4f} bound_ms={b_bms:.5f} ({b_by}, "
          f"f32 products)", flush=True)
    device_ms = sum(split.values())
    print(f"kernels: attn_dec_bwd device ms by kernel (one profiled call, "
          f"torch.profiler): "
          f"{', '.join(f'{k} {v:.4f}' for k, v in sorted(split.items()))}; "
          f"device {device_ms:.4f} of {timed['bwd']:.4f} ms (events): "
          f"{1 - device_ms / timed['bwd']:.1%} of the call is launch gaps "
          f"and the wrapper's host time", flush=True)
    return [dict(_kernel_row("attn_dec_fwd", "attn_dec_fwd.cu", "750",
                             errs["fwd/bfloat16"], timed["fwd"],
                             timed["fwd_plain"], f_bms, f_by, None),
                 **_persistent_fields(timed["fwd"], timed["fwd_steps"],
                                      f_bms, k5_info)),
            dict(_kernel_row("attn_dec_bwd", "attn_dec_bwd.cu", "894",
                             errs["bwd/bfloat16"], timed["bwd"],
                             timed["bwd_plain"], b_bms, b_by, None),
                 split_ms=split, device_ms=device_ms)]


def _lstm_inputs(H, dev):
    """A text-classification LSTM layer's K9 inputs at b64, T=100 and the
    given width: ``bench.py:401``'s lengths (T/2 to T, one full row),
    peepholes nonzero, and cotangents for K10."""
    import torch

    B, T = TEXTCLF_B, TEXTCLF_T
    g = torch.Generator().manual_seed(SEED + 6)
    lens = torch.randint(T // 2, T + 1, (B,), generator=g)
    lens[0] = T
    return dict(
        xp=(0.5 * torch.randn(B, T, 4 * H, generator=g)).to(dev),
        mask=(torch.arange(T)[None] < lens[:, None]).float().to(dev),
        w_h=((2.0 / (5 * H)) ** 0.5
             * torch.randn(H, 4 * H, generator=g)).to(dev),
        peeps=[(0.1 * torch.randn(H, generator=g)).to(dev) for _ in range(3)],
        d_out=torch.randn(T, B, H, generator=g).to(dev),
        d_hfin=torch.randn(B, H, generator=g).to(dev),
        d_cfin=torch.randn(B, H, generator=g).to(dev), lens=lens)


def _cudnn_lstm(x, lens, w_h):
    """cuDNN's LSTM (``torch.nn.LSTM``, one layer) at the shape of a K9
    call, as a yardstick only: w_h's gate blocks reordered from the
    reference's [i, f, o, g] to cuDNN's [i, f, g, o], no peepholes (cuDNN
    has none), the sequences packed by length.  -> (module, packed x)."""
    import warnings

    import torch

    # PyTorch compacts the bf16 weights at each call (a 4H x 2H copy, 1 MB
    # at H = 256, 26 MB at H = 1280) and warns each time
    warnings.filterwarnings("ignore", message="RNN module weights are not")
    H = w_h.shape[0]
    lstm = torch.nn.LSTM(x.shape[-1], H, batch_first=True).to(
        x.device, x.dtype)
    lstm.flatten_parameters()
    i, f, o, g = w_h.t().chunk(4, 0)
    with torch.no_grad():
        lstm.weight_hh_l0.copy_(torch.cat([i, f, g, o], 0))
        lstm.bias_ih_l0.zero_()
        lstm.bias_hh_l0.zero_()
    packed = torch.nn.utils.rnn.pack_padded_sequence(
        x, lens, batch_first=True, enforce_sorted=False)
    return lstm, packed


#: K10's second batch: not a multiple of the persistent kernel's 64-row
#: block, its 4-row thread tile or the step kernel's 8-row block
LSTM_RAGGED_B = 37


def _lstm_bwd_ragged(K, H, rd, peeps, dev) -> float:
    """K10 at B = LSTM_RAGGED_B, T = TEXTCLF_T, width H, residuals of type
    rd (random, as K9 would leave them), lengths from T/2 to T, nonzero
    peepholes: max err / max |g| against the plain version."""
    import torch

    B, T = LSTM_RAGGED_B, TEXTCLF_T
    g = torch.Generator().manual_seed(SEED + 8)
    lens = torch.randint(T // 2, T + 1, (B,), generator=g)
    m_tb = (torch.arange(T)[:, None] < lens[None]).float().to(dev)
    args = [torch.randn(T, B, H, generator=g).to(dev), m_tb,
            torch.randn(T, B, 4 * H, generator=g).to(dev).to(rd),
            torch.randn(T, B, H, generator=g).to(dev).to(rd),
            ((2.0 / (5 * H)) ** 0.5
             * torch.randn(4 * H, H, generator=g)).to(dev), *peeps,
            torch.randn(B, H, generator=g).to(dev),
            torch.randn(B, H, generator=g).to(dev)]
    gk = K.lstm_backward(*args)
    gp = K.lstm_backward_plain(*args)
    torch.cuda.synchronize()
    return max(_max_err(a, c) / c.abs().max().item() for a, c in zip(gk, gp))


def check_lstm(K, flush, dev):
    """K9 (inference and with residuals, at b64h256 and b64h1280) and K10
    (from K9's residuals at both widths) against their plain versions,
    bf16 policy (inference also under f32, on K9's per-step kernel).  K9
    and K10 must take their persistent kernels under bf16; each is also
    held and timed on its per-step kernel.  Yardsticks: cuDNN's
    LSTM forward for K9, its forward + backward for K10, beside the port's
    ``lstm_layer`` forward + backward (input projection, K9r, K10, d_w_h,
    d_x) at the same shape."""
    import torch

    from paddle_tpu_torch.ops import lstm_layer
    from paddle_tpu_torch.ops.kernels.lstm import (LSTM_BACKWARD,
                                                   LSTM_FORWARD, _device_sms,
                                                   _launch_bwd, _launch_fwd,
                                                   _lstm_bwd_plan,
                                                   _lstm_fwd_plan,
                                                   lstm_bwd_kernel_info,
                                                   lstm_fwd_kernel_info)
    from paddle_tpu_torch.ops.numerics import compute_dtype_scope

    B, T = TEXTCLF_B, TEXTCLF_T
    sms = _device_sms(dev)
    rows = []

    def fwd_info(H):
        return ", ".join(f"{k} {r}/{l}/{m}" for k, (r, l, m)
                         in lstm_fwd_kernel_info(H, sms).items())

    for H in TEXTCLF_HIDDEN:
        x = _lstm_inputs(H, dev)
        xp, mask, w_h, peeps = x["xp"], x["mask"], x["w_h"], x["peeps"]
        n_real = float(mask.sum())
        lib_x = torch.randn(B, T, H, device=dev, dtype=torch.bfloat16)
        lstm, packed = _cudnn_lstm(lib_x, x["lens"], w_h.bfloat16())
        # the inference variant (its own row at each width)
        errs = {}
        for cd in ("float32", "bfloat16"):
            with compute_dtype_scope(cd):
                before = _paths(LSTM_FORWARD)
                got = K.lstm_forward(xp, mask, w_h, *peeps)
                took = _paths_since(LSTM_FORWARD, before)
                want = K.lstm_forward_plain(xp, mask, w_h, *peeps)
                torch.cuda.synchronize()
            want_path = "persistent" if cd == "bfloat16" else "steps"
            if took != {want_path: 1}:
                fail("kernels", f"lstm_forward {cd} H={H} took {took}, not "
                     f"the {want_path} kernel")
            err = max(_max_err(a, b) for a, b in zip(got, want))
            tol = TOL[f"lstm_forward/{cd}"]
            if not (torch.isfinite(got[0]).all() and err <= tol):
                fail("kernels", f"lstm_forward {cd} H={H}: max abs err "
                     f"{err} > {tol}")
            if not torch.equal(got[0][mask == 0],
                               torch.zeros_like(got[0][mask == 0])):
                fail("kernels", f"lstm_forward {cd} H={H}: padded steps "
                     f"not zero")
            errs[cd] = err
        with compute_dtype_scope("bfloat16"):
            steps = _launch_fwd(xp, mask, w_h, *peeps, None, None, False,
                                "steps")
            torch.cuda.synchronize()
            errs["steps"] = max(_max_err(a, b) for a, b in zip(steps, want))
            if not errs["steps"] <= TOL["lstm_forward/bfloat16"]:
                fail("kernels", f"lstm_forward steps kernel H={H}: max abs "
                     f"err {errs['steps']}")
            ms = time_ms(lambda: K.lstm_forward(xp, mask, w_h, *peeps),
                         flush)
            steps_ms = time_ms(lambda: _launch_fwd(
                xp, mask, w_h, *peeps, None, None, False, "steps"), flush)
            plain_ms = time_ms(lambda: K.lstm_forward_plain(
                xp, mask, w_h, *peeps), flush, reps=3)
        with torch.no_grad():
            lib_ms = time_ms(lambda: lstm(packed), flush)
        nbytes = (T * B * 4 * H * 4 + T * B * 4 + H * 4 * H * 2
                  + 3 * H * 4 + T * B * H * 4 + 2 * B * H * 4)
        bms, by = bound_ms(nbytes, 2.0 * n_real * H * 4 * H, "bfloat16")
        print(f"kernels: lstm_forward B={B} T={T} H={H} path=persistent "
              f"({_lstm_fwd_plan(B, H, sms)}; registers / spilled bytes a "
              f"thread / shared bytes a block: {fwd_info(H)}) max_abs_err "
              f"f32={errs['float32']:.3e} (steps kernel, tol "
              f"{TOL['lstm_forward/float32']}) bf16={errs['bfloat16']:.3e} "
              f"(steps kernel {errs['steps']:.3e}; tol "
              f"{TOL['lstm_forward/bfloat16']}); ms={ms:.4f} (share of bound "
              f"{bms / ms:.3f}) steps_ms={steps_ms:.4f} plain_ms="
              f"{plain_ms:.4f} library_ms={lib_ms:.4f} (cuDNN LSTM forward, "
              f"input projection included, no peepholes) bound_ms={bms:.5f} "
              f"({by})", flush=True)
        row = _kernel_row("lstm_forward" if H == 256
                          else f"lstm_forward_b{B}h{H}", "lstm_forward.cu",
                          "126", errs["bfloat16"], ms, plain_ms, bms, by,
                          lib_ms)
        row["steps_ms"] = steps_ms
        row["library_covers"] = ("cuDNN LSTM forward, bf16, packed by "
                                 "length: input projection + loop, no "
                                 "peepholes")
        rows.append(row)

        with compute_dtype_scope("bfloat16"):
            before = _paths(LSTM_FORWARD)
            got = K.lstm_forward(xp, mask, w_h, *peeps, residuals=True)
            took = _paths_since(LSTM_FORWARD, before)
            if took != {"persistent": 1}:
                fail("kernels", f"lstm_forward residuals H={H} took {took}, "
                     f"not the persistent kernel")
            want = K.lstm_forward_plain(xp, mask, w_h, *peeps,
                                        residuals=True)
            steps = _launch_fwd(xp, mask, w_h, *peeps, None, None, True,
                                "steps")
            torch.cuda.synchronize()
            rd = got[3].dtype
            tol = TOL[f"lstm_forward_residuals_b{B}h{H}"]
            err = max(_max_err(a, b) for a, b in zip(got[:3], want[:3]))
            err_s = max(_max_err(a, b) for a, b in zip(steps[:3], want[:3]))
            if not err_s <= tol:
                fail("kernels", f"lstm_forward residuals steps kernel H={H}: "
                     f"h/c err {err_s} (tol {tol})")
            if rd == torch.bfloat16:
                res_ok = all(_within_bf16_ulp(a, b, tol)
                             for a, b in zip(got[3:], want[3:]))
            else:
                res_ok = all(_max_err(a, b) <= tol
                             for a, b in zip(got[3:], want[3:]))
            want_rd = torch.bfloat16 if H <= 512 else torch.float32
            if not (err <= tol and res_ok and rd == want_rd):
                fail("kernels", f"lstm_forward residuals H={H}: h/c err "
                     f"{err} (tol {tol}), residuals beyond tol (+ one bf16 "
                     f"ulp) or not {want_rd} ({rd})")
            ms = time_ms(lambda: K.lstm_forward(xp, mask, w_h, *peeps,
                                                residuals=True), flush)
            steps_ms = time_ms(lambda: _launch_fwd(
                xp, mask, w_h, *peeps, None, None, True, "steps"), flush)
            plain_ms = time_ms(lambda: K.lstm_forward_plain(
                xp, mask, w_h, *peeps, residuals=True), flush, reps=3)
            lib_w = [p.requires_grad_() for p in lstm.parameters()]
            lib_fwd_ms = time_ms(lambda: lstm(packed), flush)
            rs = 2 if rd == torch.bfloat16 else 4
            nbytes = (T * B * 4 * H * 4 + T * B * 4 + H * 4 * H * 2
                      + 3 * H * 4 + T * B * H * 4 + 2 * B * H * 4
                      + T * B * 4 * H * rs + 2 * T * B * H * rs)
            bms, by = bound_ms(nbytes, 2.0 * n_real * H * 4 * H, "bfloat16")
            print(f"kernels: lstm_forward residuals=True B={B} T={T} H={H} "
                  f"bf16, {str(rd)[6:]} residuals, path=persistent: h/c "
                  f"max_abs_err={err:.3e} (steps kernel {err_s:.3e}; tol "
                  f"{tol}), z/h_prev/c_prev within tol"
                  f"{' + one bf16 ulp' if rs == 2 else ''}; ms={ms:.4f} "
                  f"(share of bound {bms / ms:.3f}) steps_ms={steps_ms:.4f} "
                  f"plain_ms={plain_ms:.4f} library_ms={lib_fwd_ms:.4f} "
                  f"(cuDNN LSTM training forward) bound_ms={bms:.5f} ({by})",
                  flush=True)
            row = _kernel_row(f"lstm_forward_residuals_b{B}h{H}",
                              "lstm_forward.cu", "126", err, ms, plain_ms,
                              bms, by, lib_fwd_ms)
            row["steps_ms"] = steps_ms
            row["library_covers"] = ("cuDNN LSTM training forward, bf16, "
                                     "packed by length: input projection + "
                                     "loop + its reserve, no peepholes")
            rows.append(row)

            m_tb = mask.t().contiguous()
            w_t = w_h.t().contiguous()
            bargs = [x["d_out"], m_tb, got[3], got[5], w_t, *peeps,
                     x["d_hfin"], x["d_cfin"]]
            before = _paths(LSTM_BACKWARD)
            gk = K.lstm_backward(*bargs)
            took = _paths_since(LSTM_BACKWARD, before)
            if took != {"persistent": 1}:
                fail("kernels", f"lstm_backward H={H} took {took}, not the "
                     f"persistent kernel")
            gp = K.lstm_backward_plain(*bargs)
            gs = _launch_bwd(*bargs, True, "steps")
            torch.cuda.synchronize()
            tol = TOL[f"lstm_backward_b{B}h{H}"]
            err = max(_max_err(a, c) for a, c in zip(gk, gp))
            worst = max(_max_err(a, c) / c.abs().max().item()
                        for a, c in zip(gk, gp))
            worst_s = max(_max_err(a, c) / c.abs().max().item()
                          for a, c in zip(gs, gp))
            if not (all(torch.isfinite(a).all() for a in gk)
                    and worst <= tol and worst_s <= tol):
                fail("kernels", f"lstm_backward H={H}: max err / max |g| "
                     f"{worst} (steps kernel {worst_s}) > {tol}")
            worst_r = _lstm_bwd_ragged(K, H, rd, peeps, dev)
            if not worst_r <= tol:
                fail("kernels", f"lstm_backward H={H} B={LSTM_RAGGED_B}: "
                     f"max err / max |g| {worst_r} > {tol}")
            ms = time_ms(lambda: K.lstm_backward(*bargs), flush)
            steps_ms = time_ms(lambda: _launch_bwd(*bargs, True, "steps"),
                               flush)
            plain_ms = time_ms(lambda: K.lstm_backward_plain(*bargs), flush,
                               reps=3)
            ct = torch.randn(int(packed.data.shape[0]), H, device=dev,
                             dtype=torch.bfloat16)
            lib_in = lib_x.clone().requires_grad_()

            def library_fwd_bwd():
                out, _ = lstm(torch.nn.utils.rnn.pack_padded_sequence(
                    lib_in, x["lens"], batch_first=True,
                    enforce_sorted=False))
                return torch.autograd.grad(out.data, [lib_in, *lib_w], ct)

            lib_ms = time_ms(library_fwd_bwd, flush)
            layer_in = [lib_x.float().requires_grad_(),
                        (H ** -0.5 * torch.randn(H, 4 * H, device=dev)
                         ).requires_grad_(), w_h.clone().requires_grad_(),
                        torch.zeros(4 * H, device=dev).requires_grad_(),
                        *(p.clone().requires_grad_() for p in peeps)]
            d_seq = x["d_out"].transpose(0, 1)

            def port_fwd_bwd():
                h_seq, _ = lstm_layer(layer_in[0], mask, *layer_in[1:4],
                                      peep_i=layer_in[4], peep_f=layer_in[5],
                                      peep_o=layer_in[6])
                return torch.autograd.grad(h_seq, layer_in, d_seq)

            layer_ms = time_ms(port_fwd_bwd, flush)
        nbytes = (T * B * H * 4 + T * B * 4 + T * B * 4 * H * rs
                  + T * B * H * rs + 4 * H * H * 4 + 3 * H * 4 + 2 * B * H * 4
                  + T * B * 4 * H * 4 + T * B * H * 4 + 2 * B * H * 4)
        bms, by = bound_ms(nbytes, 2.0 * n_real * 4 * H * H, "float32")
        info = ", ".join(f"{k} {r}/{l}/{m}" for k, (r, l, m)
                         in lstm_bwd_kernel_info(H, sms).items())
        print(f"kernels: lstm_backward B={B} T={T} H={H} {str(rd)[6:]} "
              f"residuals path=persistent ({_lstm_bwd_plan(B, H, sms)}; "
              f"registers / spilled bytes a thread / shared bytes a block: "
              f"{info}) max_abs_err={err:.3e} (max err / max |g| "
              f"{worst:.3e}, steps kernel {worst_s:.3e}, B={LSTM_RAGGED_B} "
              f"{worst_r:.3e}; tol {tol}); ms={ms:.4f} (share of bound "
              f"{bms / ms:.3f}) steps_ms={steps_ms:.4f} plain_ms="
              f"{plain_ms:.4f} "
              f"library_ms={lib_ms:.4f} (cuDNN LSTM forward + backward, "
              f"against the port's lstm_layer forward + backward "
              f"{layer_ms:.4f} ms) bound_ms={bms:.5f} ({by}, f32 products)",
              flush=True)
        row = _kernel_row(f"lstm_backward_b{B}h{H}", "lstm_backward.cu",
                          "479", err, ms, plain_ms, bms, by, lib_ms)
        row["steps_ms"] = steps_ms
        row["library_covers"] = (
            f"cuDNN LSTM forward + backward, bf16, packed by length; the "
            f"port's lstm_layer forward + backward (projection, K9r, K10, "
            f"d_w_h, d_x) takes {layer_ms:.4f} ms at this shape")
        rows.append(row)
        del lstm, packed, lib_w, got, want, gk, gp
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


def _tensor_bytes(tree) -> int:
    """Bytes of the tensors in a nest of dicts, lists and tuples."""
    if isinstance(tree, dict):
        return sum(_tensor_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_tensor_bytes(v) for v in tree)
    return tree.numel() * tree.element_size()


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
    # the bf16 readout of the slot table (N = 192) and of every solo check
    # takes K7's TMA + wgmma pass 1
    k7_paths = launches.by_path["topk_lse_readout"]
    if set(k7_paths) != {"wgmma"}:
        fail("serve", f"topk_lse_readout launches by path {k7_paths}, not "
             f"all wgmma")
    # every prefill's K3 (B = 1 .. 64 rows) takes the persistent kernel
    _all_persistent("serve", "default", launches, ("gru_forward",))
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
          f"{t_init:.2f} s; parameters {_tensor_bytes(params)} bytes, slot "
          f"table {_tensor_bytes(sched.carry)} bytes on the card",
          flush=True)

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
    fused_launches = serve_fused(K, model, params, reqs, results)
    served = {"model": model, "params": params, "reqs": reqs,
              "feeds": feeds, "results": results, "elapsed": elapsed,
              "tokens": tokens}
    return launches, fused_launches, served


def serve_fused(K, model, params, reqs_off, results_off):
    """The same 96 requests again with ``fused_bigru`` on: every prefill's
    encoder runs K11's inference variant in place of two K3 calls, and
    every answer's ids and scores are those of the default run, bit for
    bit (K11's rows are K3's)."""
    import numpy as np
    import torch

    from paddle_tpu_torch.serving import Seq2SeqSlotBackend, SlotScheduler

    reqs, _ = make_requests(np.random.default_rng(SEED), model.src_vocab)
    with train_config("fused_bigru"):
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
        fail("serve", f"fused_bigru: {len(results)}/{N_REQUESTS} answered")
    if not (launches["bigru_forward"] > 0 and launches["gru_forward"] == 0
            and launches["topk_lse_readout"] > 0):
        fail("serve", f"fused_bigru: launches {launches}")
    _all_persistent("serve", "fused_bigru", launches, ("bigru_forward",))
    differ = [i for i, (a, b) in enumerate(zip(reqs_off, reqs))
              if not (np.array_equal(results_off[id(a)][0]["tokens"],
                                     results[id(b)][0]["tokens"])
                      and np.array_equal(results_off[id(a)][0]["scores"],
                                         results[id(b)][0]["scores"]))]
    print(f"serve: fused_bigru: {N_REQUESTS} requests, {elapsed:.3f} s, "
          f"{N_REQUESTS / elapsed:.2f} requests/s, {prefills} prefills, ids "
          f"and scores identical to the default run on "
          f"{N_REQUESTS - len(differ)}/{N_REQUESTS}, launches {launches}",
          flush=True)
    if differ:
        fail("serve", f"fused_bigru: requests {differ} differ from the "
             f"default run")
    return launches


# ---------------------------------------------------------------------------
# phase 6: the served entry point, InferenceServer over the slot table
# ---------------------------------------------------------------------------


def _server_launches(K, part: str):
    """This part's launches; fail unless K3 and K7 launched, only from the
    server's worker thread, K3 on its persistent kernel and K7 on its
    TMA + wgmma pass 1, and no other kernel launched."""
    launches = K.launch_counts()
    other = {n: c for n, c in launches.items()
             if c and n not in SERVE_KERNELS}
    if other:
        fail("server", f"{part}: kernels {other} launched, the server path "
             f"runs {SERVE_KERNELS} only")
    for name in SERVE_KERNELS:
        if launches[name] <= 0:
            fail("server", f"{part}: kernel {name} was not launched")
        threads = launches.by_thread[name]
        if not all(t.startswith("serving-worker-") for t in threads):
            fail("server", f"{part}: {name} launches by thread {threads}, "
                 f"not all from the server's worker")
    _all_persistent("server", part, launches, ("gru_forward",))
    k7 = launches.by_path["topk_lse_readout"]
    if set(k7) != {"wgmma"}:
        fail("server", f"{part}: topk_lse_readout launches by path {k7}, "
             f"not all wgmma")
    return launches


def _launch_text(launches) -> str:
    return ", ".join(f"{n} {launches[n]} {launches.by_path[n]} "
                     f"{launches.by_thread[n]}" for n in SERVE_KERNELS)


def _gen_server(backend, **kw):
    from paddle_tpu_torch.serving import InferenceServer

    kw.setdefault("default_deadline_ms", SERVER_DEADLINE_MS)
    kw.setdefault("max_queue", SERVER_MAX_QUEUE)
    return InferenceServer(backend, mode="generation", slots=SLOTS,
                           batch_delay_ms=0.0, **kw)


def _resolve_all(futs, part: str):
    """Every future resolves, to a result or a typed error; returns the
    errors by index (None for a result)."""
    from paddle_tpu_torch.serving import ServingError

    errs = {}
    for i, f in futs.items():
        try:
            errs[i] = f.error(SERVER_WAIT_S)
        except TimeoutError:
            fail("server", f"{part}: request {i} unresolved after "
                 f"{SERVER_WAIT_S} s")
        if errs[i] is not None and not isinstance(errs[i], ServingError):
            fail("server", f"{part}: request {i} failed untyped: "
                 f"{type(errs[i]).__name__}: {errs[i]}")
    return errs


def server_closed_batch(K, backend, served):
    """Part 1: the serve phase's 96 requests submitted at once; each answer
    identical to the direct scheduler run's."""
    import numpy as np
    import torch

    reqs, feeds, results = served["reqs"], served["feeds"], served["results"]
    torch.cuda.reset_peak_memory_stats()
    srv = _gen_server(backend)
    with srv:
        srv.start(warmup_feed=feeds[0])
        K.reset_launch_counts()
        t0 = time.perf_counter()
        futs = {i: srv.submit(f) for i, f in enumerate(feeds)}
        errs = _resolve_all(futs, "closed batch")
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        launches = _server_launches(K, "closed batch")
        hz = srv.healthz()
    differ = [i for i, e in errs.items() if e is not None
              or not np.array_equal(futs[i].result(0)["tokens"],
                                    results[id(reqs[i])][0]["tokens"])
              or not np.array_equal(futs[i].result(0)["scores"],
                                    results[id(reqs[i])][0]["scores"])]
    rps, serve_rps = N_REQUESTS / elapsed, N_REQUESTS / served["elapsed"]
    tokens = served["tokens"]   # identical answers: the same decode steps
    print(f"server: closed batch: {N_REQUESTS} requests submitted at once "
          f"to InferenceServer(generation, {SLOTS} slots, max_queue "
          f"{SERVER_MAX_QUEUE}): {elapsed:.3f} s from the first submit to "
          f"the last answer, {rps:.2f} requests/s, {tokens / elapsed:.1f} "
          f"tokens/s; the direct scheduler run (serve) "
          f"{served['elapsed']:.3f} s, {serve_rps:.2f} requests/s, "
          f"{tokens / served['elapsed']:.1f} tokens/s; server/direct "
          f"{rps / serve_rps:.3f}; {hz['slots']['steps']} table steps, "
          f"mean request steps {hz['mean_request_steps']}, mean slot "
          f"occupancy {hz['mean_slot_occupancy']}, cold_start_s "
          f"{srv.cold_start_s:.3f} (warmup_compiles "
          f"{hz['cold_start']['warmup_compiles']}), peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; ids and "
          f"scores identical to the direct run on "
          f"{N_REQUESTS - len(differ)}/{N_REQUESTS}; launches "
          f"{_launch_text(launches)}", flush=True)
    if differ:
        fail("server", f"closed batch: requests {differ} differ from the "
             f"direct scheduler run (or failed)")
    if hz["counters"]["completed"] != N_REQUESTS:
        fail("server", f"closed batch: counters {hz['counters']}")
    return launches, rps, elapsed / max(1, hz["slots"]["steps"])


def server_open_loop(K, backend, vocab, rate):
    """Part 2: SERVER_OPEN_N requests with Poisson arrivals at ``rate``
    requests/s (arrival times from a fixed numpy seed), each with the
    default deadline; latency percentiles from ``metrics.percentile_ms``."""
    import numpy as np
    import torch

    from paddle_tpu_torch.serving import (CircuitOpenError,
                                          DeadlineExceeded, ShedError)

    rng = np.random.default_rng(SEED + 7)
    arrivals = np.cumsum(rng.exponential(1.0 / rate, SERVER_OPEN_N))
    feeds = []
    for _ in range(SERVER_OPEN_N):
        n = int(rng.integers(8, SRC_LEN + 1))
        feeds.append({"src": (rng.integers(3, vocab, (1, n)),
                              np.asarray([n]))})
    srv = _gen_server(backend)
    rejected = {}
    with srv:
        srv.start(warmup_feed=feeds[0])
        K.reset_launch_counts()
        futs = {}
        t0 = time.perf_counter()
        for i, (t_i, feed) in enumerate(zip(arrivals, feeds)):
            wait = t0 + t_i - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            try:
                futs[i] = srv.submit(feed)
            except (ShedError, DeadlineExceeded, CircuitOpenError) as e:
                rejected[i] = type(e).__name__
        errs = _resolve_all(futs, "open loop")
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        launches = _server_launches(K, "open loop")
        hz = srv.healthz()
        pct = {p: srv.metrics.percentile_ms(p) for p in (50, 90, 99)}
    completed = sum(e is None for e in errs.values())
    expired = sum(isinstance(e, DeadlineExceeded) for e in errs.values())
    other = {type(e).__name__ for e in errs.values()
             if e is not None and not isinstance(e, DeadlineExceeded)}
    c = hz["counters"]
    print(f"server: open loop: {SERVER_OPEN_N} requests, Poisson arrivals "
          f"at {rate:.2f} requests/s (half the closed batch's), deadline "
          f"{SERVER_DEADLINE_MS:.0f} ms, {elapsed:.3f} s: latency p50 "
          f"{pct[50]:.2f} ms, p90 {pct[90]:.2f} ms, p99 {pct[99]:.2f} ms "
          f"(completed requests, metrics.percentile_ms); completed "
          f"{completed}, shed {c['shed']}, rejected at submit "
          f"{len(rejected)} {sorted(set(rejected.values()))}, deadline "
          f"expired {expired} (counter {c['deadline_expired']}), evicted "
          f"{c['slot_evicted']} slots, other errors {sorted(other)}; mean "
          f"slot occupancy {hz['mean_slot_occupancy']}, mean request steps "
          f"{hz['mean_request_steps']}, {hz['slots']['steps']} table steps; "
          f"launches {_launch_text(launches)}", flush=True)
    if completed == 0 or other:
        fail("server", f"open loop: {completed} completed, other errors "
             f"{other}")
    return launches


def server_deadline(K, backend, served, step_s):
    """Part 3: one request whose decode (MAX_LEN steps in the serve run)
    outlasts its deadline, SERVER_DEADLINE_STEPS times ``step_s`` (the
    closed batch's seconds a table step, prefills included), admitted
    beside 8 ordinary ones: it fails ``DeadlineExceeded`` and its slots
    are recycled; the 8 answer as their solo decodes do."""
    import numpy as np
    import torch

    from paddle_tpu_torch.serving import DeadlineExceeded

    model, params = served["model"], served["params"]
    reqs, feeds, results = served["reqs"], served["feeds"], served["results"]
    full = [i for i, r in enumerate(reqs)
            if results[id(r)][1] == MAX_LEN]
    if len(full) < 9:
        fail("server", f"deadline: {len(full)} requests decode {MAX_LEN} "
             f"steps, 9 needed")
    long_i, ordinary = full[0], full[1:9]
    deadline_ms = 1e3 * SERVER_DEADLINE_STEPS * step_s
    srv = _gen_server(backend, default_deadline_ms=60000.0)
    with srv:
        srv.start(warmup=False)
        K.reset_launch_counts()
        f_long = srv.submit(feeds[long_i], deadline_ms=deadline_ms)
        futs = {i: srv.submit(feeds[i]) for i in ordinary}
        err = _resolve_all({long_i: f_long}, "deadline")[long_i]
        errs = _resolve_all(futs, "deadline")
        torch.cuda.synchronize()
        launches = _server_launches(K, "deadline")
        hz = srv.healthz()
    differ = []
    for i in ordinary:
        ids, lens = padded_source(feeds[i])
        st, ss = model.beam_search(params, ids, lens, beam_size=BEAM,
                                   max_len=MAX_LEN)
        if errs[i] is not None or not (
                np.array_equal(futs[i].result(0)["tokens"], st.cpu().numpy())
                and np.array_equal(futs[i].result(0)["scores"],
                                   ss.cpu().numpy())):
            differ.append(i)
    evicted = hz["counters"]["slot_evicted"]
    print(f"server: deadline: request {long_i} ({MAX_LEN} decode steps, "
          f"~{1e3 * step_s * MAX_LEN:.1f} ms) with a {deadline_ms:.2f} ms "
          f"deadline beside 8 ordinary ones: {type(err).__name__}: {err}; "
          f"slots evicted {evicted}, recycled {hz['slots']['recycled']}, "
          f"occupied {hz['slots']['occupied']}; the 8 ordinary ids and "
          f"scores identical to their solo decode on {8 - len(differ)}/8; "
          f"launches {_launch_text(launches)}", flush=True)
    if not (isinstance(err, DeadlineExceeded)
            and "mid-generation" in str(err)):
        fail("server", f"deadline: the long request ended with {err!r}, "
             f"not an eviction")
    if evicted != 1 or hz["slots"]["occupied"] != 0 \
            or hz["slots"]["recycled"] != 9:
        fail("server", f"deadline: slots {hz['slots']}, evicted {evicted}")
    if differ:
        fail("server", f"deadline: requests {differ} differ from their "
             f"solo decode (or failed)")
    return launches


def server_path(K, dev, served):
    """The served entry point at full width: ``InferenceServer`` in
    generation mode over ``Seq2SeqSlotBackend`` (the serve phase's model,
    parameters and requests), in three parts; returns each part's
    launches.  Then the device memory the phase left allocated: the
    servers' worker threads ran cuBLAS on a handle of their own, and
    PyTorch keeps a cuBLAS workspace for each handle and stream past the
    thread's end.  That is printed and freed (every handle's workspace,
    the main thread's too, which its next product makes anew); anything
    else left fails the phase."""
    import torch

    from paddle_tpu_torch.serving import Seq2SeqSlotBackend

    torch.cuda.synchronize(dev)
    before = torch.cuda.memory_allocated(dev)
    backend = Seq2SeqSlotBackend(served["model"], served["params"],
                                 src_len=SRC_LEN, beam_size=BEAM,
                                 max_len=MAX_LEN)
    launches = {}
    launches["closed batch"], rps, step_s = server_closed_batch(
        K, backend, served)
    launches["open loop"] = server_open_loop(
        K, backend, served["model"].src_vocab, rps / 2)
    launches["deadline"] = server_deadline(K, backend, served, step_s)
    del backend
    torch.cuda.synchronize(dev)
    left = torch.cuda.memory_allocated(dev) - before
    torch._C._cuda_clearCublasWorkspaces()
    cleared = torch.cuda.memory_allocated(dev) - before
    print(f"server: device memory left allocated by the phase, its servers "
          f"closed and dropped: {left} bytes; after freeing the cuBLAS "
          f"workspaces (every handle's, the main thread's included): "
          f"{cleared} bytes", flush=True)
    if cleared > 0:
        fail("server", f"{cleared} bytes of device memory left allocated "
             f"beyond the cuBLAS workspaces")
    return launches


# ---------------------------------------------------------------------------
# phase 7: speculative decoding, the prefix cache and host paging
# ---------------------------------------------------------------------------


def spec_requests(vocab):
    """SPEC_REQUESTS single-row feeds over SPEC_SOURCES distinct sources of
    8..SRC_LEN tokens, each source SPEC_REQUESTS / SPEC_SOURCES times, in a
    fixed seeded order; and each request's source index."""
    import numpy as np

    rng = np.random.default_rng(SEED + 11)
    sources = []
    for _ in range(SPEC_SOURCES):
        n = int(rng.integers(8, SRC_LEN + 1))
        sources.append((rng.integers(3, vocab, (1, n)), np.asarray([n])))
    order = rng.permutation(np.repeat(np.arange(SPEC_SOURCES),
                                      SPEC_REQUESTS // SPEC_SOURCES))
    return [{"src": sources[i]} for i in order], [int(i) for i in order]


def spec_drive(sched, feeds, hook=None):
    """The continuous loop of the reference's spec test: page in, harvest,
    admit one request at a time as slots free up, step.  Returns per
    request (outputs, steps) and the seconds it took, ended by a
    synchronize."""
    import torch

    from paddle_tpu_torch.serving import (Request, ServingFuture,
                                          canonicalize_feed)

    reqs = []
    for f in feeds:
        canon, rows, sig = canonicalize_feed(f)
        reqs.append(Request(feed=canon, rows=rows, signature=sig,
                            future=ServingFuture(), deadline=None,
                            t_submit=time.monotonic()))
    out, pending, cycle = {}, list(reqs), 0
    t0 = time.perf_counter()
    while (pending or sched.occupied()
           or (sched.pager is not None and len(sched.pager))):
        if hook is not None:
            hook(sched, cycle)
        cycle += 1
        if sched.pager is not None:
            sched.page_in()
        for req, res, steps in sched.harvest():
            out[id(req)] = (res, steps)
        while pending and sched.free_count():
            sched.admit([pending.pop(0)])
        if sched.occupied():
            sched.step()
    torch.cuda.synchronize()
    return [out[id(r)] for r in reqs], time.perf_counter() - t0


def _same_answers(a, b) -> list:
    """Indexes whose tokens or scores differ between two lists of
    outputs."""
    import numpy as np

    return [i for i, (x, y) in enumerate(zip(a, b))
            if not (np.array_equal(x["tokens"], y["tokens"])
                    and np.array_equal(x["scores"], y["scores"]))]


def spec_solo_check(backend, feeds, src_of, full, card):
    """Each distinct source's answer against its solo ``greedy_decode`` on
    the card: ids identical (scores then within TOL_SEARCH; they are
    printed identical or not), or — a near tie of the random-init logits —
    both hypotheses rescored within TOL_SEARCH of each other's scores."""
    import numpy as np

    from paddle_tpu_torch.ops.decode import greedy_decode
    from paddle_tpu_torch.serving import canonicalize_feed

    model, params = backend.model, backend.params
    identical = same_ids = 0
    for src in range(SPEC_SOURCES):
        i = src_of.index(src)
        canon = canonicalize_feed(feeds[i])[0]
        st, ss = greedy_decode(backend.step_fn, backend.readout,
                               backend.prefill(canon), batch_size=1,
                               vocab_size=backend.vocab_size,
                               max_len=backend.max_len, bos=backend.bos,
                               eos=backend.eos)
        solo_t, solo_s = st.cpu().numpy()[0], float(ss.cpu().numpy()[0])
        got_t = full[i]["tokens"][0, 0]
        got_s = float(full[i]["scores"][0, 0])
        if np.array_equal(got_t, solo_t):
            same_ids += 1
            identical += got_s == solo_s
            if abs(got_s - solo_s) > TOL_SEARCH:
                fail("spec", f"source {src}: ids identical to the solo "
                     f"greedy decode, scores {got_s} vs {solo_s}")
            continue
        ids, lens = padded_source(feeds[i])
        r_got = rescore(model, params, ids, lens, got_t)
        r_solo = rescore(model, params, ids, lens, solo_t)
        d = max(abs(got_s - solo_s), abs(r_got - got_s),
                abs(r_solo - solo_s))
        print(f"spec: source {src}: ids differ from the solo greedy decode "
              f"(near tie?): scores {got_s} vs {solo_s}, rescored {r_got} "
              f"and {r_solo}", flush=True)
        if d > TOL_SEARCH:
            fail("spec", f"source {src}: served and solo greedy decodes "
                 f"disagree beyond a near tie ({d:.3e} > {TOL_SEARCH})")
    print(f"spec: solo check, {SPEC_SOURCES} distinct sources against "
          f"their solo greedy decode on the card: ids identical on "
          f"{same_ids}/{SPEC_SOURCES}, ids and scores identical on "
          f"{identical}/{SPEC_SOURCES} [{card}]", flush=True)


def spec_path(K, dev, served, card):
    """The spec phase: the serve phase's model (30k/30k, 512-d, weights
    from SEED) behind ``Seq2SeqSlotBackend(beam_size=1)`` with SLOTS slots,
    SPEC_REQUESTS requests over SPEC_SOURCES sources, in three arms: plain
    (no speculation, cache or pager); full (spec_k = SPEC_K, the prefix
    cache, the page pool, a forced page-out every SPEC_PAGE_EVERY cycles);
    server (the same requests submitted at once to
    ``InferenceServer(mode="generation")`` with the same settings, whose
    own page-out fires as the queue outruns the table).  Fails unless the
    full arm's tokens and scores equal the plain arm's bit for bit, the
    server's equal the full arm's, each source's answer its solo greedy
    decode, the cache hit and cut K3's launches by exactly the prefills it
    saved, pages out = pages in > 0, drafts were accepted, and every K7
    launch (N = SLOTS at a plain step, (SPEC_K + 1) x SLOTS at a wide one)
    took the wgmma pass 1.  Returns the full arm's launches and its wide
    steps."""
    import numpy as np
    import torch

    from paddle_tpu_torch.serving import Seq2SeqSlotBackend, SlotScheduler

    backend = Seq2SeqSlotBackend(served["model"], served["params"],
                                 src_len=SRC_LEN, beam_size=1,
                                 max_len=MAX_LEN)
    feeds, src_of = spec_requests(served["model"].src_vocab)
    arms = {}

    # each arm's counts start after its table is built (the table's state
    # template is one prefill of its own)
    plain = SlotScheduler(backend, slots=SLOTS)
    K.reset_launch_counts()
    res, secs = spec_drive(plain, feeds)
    arms["plain"] = (plain, res, secs, K.launch_counts())

    parked = {"peak_bytes": 0, "records": 0, "forced": 0}

    def page_out(sched, cycle):
        if cycle % SPEC_PAGE_EVERY == SPEC_PAGE_EVERY - 1 \
                and sched.page_out_victim():
            parked["forced"] += 1
            parked["peak_bytes"] = max(parked["peak_bytes"],
                                       sched.pager.bytes_used())
            parked["records"] = max(parked["records"], len(sched.pager))

    backend.fingerprint()           # hashed once, outside the timed arm
    full = SlotScheduler(backend, slots=SLOTS, spec_k=SPEC_K,
                         prefix_cache_mb=SPEC_CACHE_MB,
                         page_pool_mb=SPEC_POOL_MB)
    K.reset_launch_counts()
    res, secs = spec_drive(full, feeds, hook=page_out)
    arms["full"] = (full, res, secs, K.launch_counts())

    srv = _gen_server(backend, spec_k=SPEC_K, prefix_cache_mb=SPEC_CACHE_MB,
                      slot_page_pool_mb=SPEC_POOL_MB,
                      max_queue=SPEC_SERVER_QUEUE,
                      default_deadline_ms=60000.0)
    with srv:
        srv.start(warmup_feed=feeds[0])
        K.reset_launch_counts()
        t0 = time.perf_counter()
        futs = {i: srv.submit(f) for i, f in enumerate(feeds)}
        errs = _resolve_all(futs, "spec server")
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = K.launch_counts()
        hz = srv.healthz()
        sched = srv._scheduler
    failed = [(i, e) for i, e in errs.items() if e is not None]
    if failed:
        fail("spec", f"server arm: {len(failed)} requests failed: "
             f"{failed[:4]}")
    res = [(futs[i].result(0), None) for i in range(len(feeds))]
    arms["server"] = (sched, res, secs, launches)

    tokens = sum(st for _, st in arms["plain"][1])
    for name, (sc, res, secs, la) in arms.items():
        line = (f"spec: {name}: {len(feeds)} requests over {SPEC_SOURCES} "
                f"sources, {SLOTS} slots, beam 1, max_len {MAX_LEN}, bf16: "
                f"{secs:.3f} s, {len(feeds) / secs:.2f} requests/s, "
                f"{tokens / secs:.1f} tokens/s ({tokens} tokens), "
                f"{sc.steps_run} table steps, {tokens / sc.steps_run:.2f} "
                f"tokens a table step")
        if sc.spec_k:
            line += (f", {sc.spec_steps} wide steps, acceptance "
                     f"{sc.spec_accepted}/{sc.spec_drafted} = "
                     f"{sc.spec_accepted / max(1, sc.spec_drafted):.4f}")
        if sc.prefix_cache is not None:
            line += f", prefix cache {sc.prefix_cache.stats()}"
        if sc.pager is not None:
            line += f", pager {sc.pager.stats()}"
        line += (f"; launches {_launch_text(la)} [{card}]")
        print(line, flush=True)
    print(f"spec: full arm: {parked['forced']} forced page-outs, peak "
          f"{parked['peak_bytes']} bytes parked in the pager in "
          f"{parked['records']} record(s) "
          f"({parked['peak_bytes'] // max(1, parked['records'])} bytes a "
          f"record); server arm: pages out {hz['counters']['slots_paged_out']}"
          f", in {hz['counters']['slots_paged_in']}, prefix cache hits "
          f"{hz['counters']['prefix_cache_hits']}, misses "
          f"{hz['counters']['prefix_cache_misses']}, spec drafts "
          f"{hz['counters']['spec_draft_tokens_total']}, accepted "
          f"{hz['counters']['spec_accepted_tokens_total']}, emitted "
          f"{hz['counters'].get('spec_emitted_tokens_total')} [{card}]",
          flush=True)

    plain_res = [r for r, _ in arms["plain"][1]]
    full_res = [r for r, _ in arms["full"][1]]
    server_res = [r for r, _ in arms["server"][1]]
    for r in plain_res:
        t, sc_ = r["tokens"], r["scores"]
        if t.shape != (1, 1, MAX_LEN) or not np.isfinite(sc_).all():
            fail("spec", f"malformed result: tokens {t.shape}, scores {sc_}")
    differ = _same_answers(plain_res, full_res)
    print(f"spec: full arm vs plain arm: tokens and scores identical on "
          f"{len(feeds) - len(differ)}/{len(feeds)}; server arm vs full "
          f"arm: {len(feeds) - len(_same_answers(full_res, server_res))}"
          f"/{len(feeds)}", flush=True)
    if differ:
        fail("spec", f"full arm: requests {differ[:8]} differ from the plain "
             f"arm")
    differ = _same_answers(full_res, server_res)
    if differ:
        fail("spec", f"server arm: requests {differ[:8]} differ from the "
             f"full arm")
    spec_solo_check(backend, feeds, src_of, full_res, card)

    full, la_full = arms["full"][0], arms["full"][3]
    la_plain = arms["plain"][3]
    hits = full.prefix_cache.hits
    per_prefill = la_plain["gru_forward"] / len(feeds)
    if not (hits > 0 and per_prefill == int(per_prefill)
            and la_plain["gru_forward"] - la_full["gru_forward"]
            == int(per_prefill) * hits):
        fail("spec", f"prefix cache: {hits} hits, K3 launches plain "
             f"{la_plain['gru_forward']}, full {la_full['gru_forward']}")
    st = full.pager.stats()
    if not st["paged_out"] == st["paged_in"] > 0:
        fail("spec", f"full arm pager {st}")
    c = hz["counters"]
    if not c["slots_paged_out"] == c["slots_paged_in"] > 0:
        fail("spec", f"server arm pages out {c['slots_paged_out']}, in "
             f"{c['slots_paged_in']}")
    if not (full.spec_accepted > 0 and full.spec_steps > 0
            and c["spec_accepted_tokens_total"] > 0):
        fail("spec", f"no draft accepted: full {full.spec_accepted} of "
             f"{full.spec_drafted}, server {c['spec_accepted_tokens_total']}")
    for name, (sc, _, _, la) in arms.items():
        for kernel in SERVE_KERNELS:
            if la[kernel] <= 0:
                fail("spec", f"{name} arm: kernel {kernel} not launched")
        other = {n: v for n, v in la.items() if v and n not in SERVE_KERNELS}
        if other:
            fail("spec", f"{name} arm: kernels {other} launched")
        # K7 once a table step: at N = SLOTS on a plain step, at
        # (SPEC_K + 1) x SLOTS on a wide one, every launch on wgmma
        if la.by_path["topk_lse_readout"] != {"wgmma": sc.steps_run}:
            fail("spec", f"{name} arm: topk_lse_readout launches "
                 f"{la.by_path['topk_lse_readout']} for {sc.steps_run} "
                 f"table steps ({getattr(sc, 'spec_steps', 0)} wide), not "
                 f"one wgmma launch each")
        _all_persistent("spec", name, la, ("gru_forward",))
    if not all(t.startswith("serving-worker-") for t in
               arms["server"][3].by_thread["topk_lse_readout"]):
        fail("spec", f"server arm: K7 launched by "
             f"{arms['server'][3].by_thread['topk_lse_readout']}")
    return la_full, full.spec_steps


# ---------------------------------------------------------------------------
# phase 8: the training path
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


@contextlib.contextmanager
def train_config(config: str):
    """The flagship's two switches for one configuration: ``default`` (both
    off, the reference's default), ``fused_bigru`` (K11 in place of the two
    K3r/K4 calls), ``lse_readout`` (K12 in place of K1/K2) or ``both``."""
    from paddle_tpu_torch.ops import losses
    from paddle_tpu_torch.utils.flags import FLAGS

    old = FLAGS.fused_bigru, losses._USE_LSE_READOUT
    FLAGS.fused_bigru = config in ("fused_bigru", "both")
    losses._USE_LSE_READOUT = config in ("lse_readout", "both")
    try:
        yield
    finally:
        FLAGS.fused_bigru, losses._USE_LSE_READOUT = old


def train_path(K, dev, config: str = "default"):
    """6 Adam steps of the full-width flagship at B=384, S=T=32, bf16, in
    one configuration, from the same initial parameters and batch.
    Returns the launches, the losses and each step's seconds."""
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

    with train_config(config):
        K.reset_launch_counts()
        losses, secs = [], []
        for _ in range(TRAIN_STEPS):
            t0 = time.perf_counter()
            losses.append(step().item())                # synchronises
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        launches = K.launch_counts()
        ce_paths = [dict(K.LIBRARIES[n].launches_by_path)
                    for n in ("ce_readout_fwd", "ce_readout_bwd")]

    if not all(np.isfinite(losses)):
        fail("train", f"{config}: loss not finite: {losses}")
    if not losses[-1] < losses[0]:
        fail("train", f"{config}: loss did not fall: {losses}")
    if int(state["step"]) != TRAIN_STEPS:
        fail("train", f"{config}: optimizer step counter "
             f"{int(state['step'])} after {TRAIN_STEPS} updates")
    # each configuration launches exactly its kernels: K11 twice a step in
    # place of K3r/K4, K12 once a step in place of K1/K2
    want = dict.fromkeys(TRAIN_KERNELS, None)
    want.update(dict.fromkeys(FUSED_BIGRU_KERNELS + LSE_READOUT_KERNELS, 0))
    if config == "fused_bigru":
        want.update(gru_forward=0, gru_backward=0, bigru_forward=TRAIN_STEPS,
                    bigru_backward=TRAIN_STEPS)
    if config == "lse_readout":
        want.update(ce_readout_fwd=0, ce_readout_bwd=0,
                    logsumexp_rows=TRAIN_STEPS)
    for name, n in want.items():
        if (launches[name] <= 0) if n is None else (launches[name] != n):
            fail("train", f"{config}: kernel {name} launched "
                 f"{launches[name]} times in {TRAIN_STEPS} steps (want "
                 f"{'some' if n is None else n})")
    # K3r, K4, K11 (both loops) and K5 at the training shape take their
    # persistent kernels, every launch
    _all_persistent("train", config, launches, PERSISTENT_TRAIN_KERNELS)
    # K1 and K2 at the training shape take the TMA + wgmma kernels
    want_paths = {} if config == "lse_readout" else {"wgmma": TRAIN_STEPS}
    if any(p != want_paths for p in ce_paths):
        fail("train", f"{config}: K1 / K2 launches by path {ce_paths} (want "
             f"{want_paths})")
    return {"launches": launches, "losses": losses, "secs": secs,
            "peak_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30,
            "flops": analytic_flops(model, TRAIN_B, TRAIN_S, TRAIN_T)}


def train_ab(K, dev):
    """The three training configurations in one process, in turns
    (default, fused_bigru, lse_readout, then the reverse order), 6 steps
    each from the same parameters: each one's losses, median step time of
    steps 2-6 over both turns, words/s, MFU and launches.  Step 1's loss
    with the fused encoder equals the default's exactly (K11's rows are
    K3's bit for bit); with the LSE readout it is within TOL_LSE_LOSS.
    Returns each configuration's launches (first turn)."""
    runs = {c: [] for c in TRAIN_CONFIGS}
    for order in (TRAIN_CONFIGS, TRAIN_CONFIGS[::-1]):
        for config in order:
            runs[config].append(train_path(K, dev, config))
    ref = [r["losses"][0] for r in runs["default"]]
    for config in TRAIN_CONFIGS:
        first = [r["losses"][0] for r in runs[config]]
        rel = max(abs(a - b) / abs(b) for a, b in zip(first, ref))
        steady = sorted(x for r in runs[config] for x in r["secs"][1:])
        sec = steady[len(steady) // 2]
        flops = runs[config][0]["flops"]
        all_ms = [round(x * 1e3, 2) for r in runs[config] for x in r["secs"]]
        print(f"train: {config}: losses "
              f"{[round(x, 6) for x in runs[config][0]['losses']]}",
              flush=True)
        print(f"train: {config}: B={TRAIN_B} S={TRAIN_S} T={TRAIN_T} bf16 "
              f"Adam, 2 x {TRAIN_STEPS} steps: first steps "
              f"{[round(r['secs'][0], 3) for r in runs[config]]} s, median "
              f"of the rest {sec * 1e3:.2f} ms/step ({all_ms} ms), "
              f"{TRAIN_B * TRAIN_T / sec:.1f} words/s, MFU "
              f"{flops / sec / PEAK_OPS_PER_S['bfloat16']:.4%} of 989 "
              f"TFLOP/s ({flops:.4e} FLOP/step), peak memory "
              f"{max(r['peak_gib'] for r in runs[config]):.2f} GiB, step-1 "
              f"loss rel diff to default {rel:.3e}, launches "
              f"{runs[config][0]['launches']}", flush=True)
        if config == "fused_bigru" and first != ref:
            fail("train", f"fused_bigru step-1 loss {first} differs from the "
                 f"default's {ref}")
        if config == "lse_readout" and not rel <= TOL_LSE_LOSS:
            fail("train", f"lse_readout step-1 loss {first} beyond "
                 f"{TOL_LSE_LOSS} of the default's {ref}")
    return {c: runs[c][0]["launches"] for c in TRAIN_CONFIGS}


#: card-vs-CPU training check (f32 on both sides): the loss relative, each
#: gradient's max |diff| against its largest entry (sums over 256 rows, a
#: 30k vocab and 32 recurrent steps taken in another order)
TOL_TRAIN_LOSS, TOL_TRAIN_GRAD = 1e-5, 1e-3


def train_cpu_check(K, dev, config: str = "default"):
    """The full-width model at B=8 (mixed lengths) in f32, in one training
    configuration: loss and all 19 gradients on the card (kernels) against
    the CPU (plain versions), same parameters."""
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
    with compute_dtype_scope("float32"), train_config(config):
        K.reset_launch_counts()
        for name, model, dv in (("card", card, dev), ("cpu", cpu, "cpu")):
            p = {k: v.to(dv).requires_grad_() for k, v in params.items()}
            loss = model.loss(p, batch)
            grads = torch.autograd.grad(loss, list(p.values()))
            out[name] = (loss.item(), [g.cpu() for g in grads])
        launches = K.launch_counts()
    optional = FUSED_BIGRU_KERNELS + LSE_READOUT_KERNELS
    ran, idle = ((optional, ("gru_forward", "gru_backward", "ce_readout_fwd",
                             "ce_readout_bwd"))
                 if config == "both" else (TRAIN_KERNELS, optional))
    if not (all(launches[k] > 0 for k in ran)
            and all(launches[k] == 0 for k in idle)):
        fail("train", f"{config} card vs CPU: launches {launches}")
    d_loss = abs(out["card"][0] - out["cpu"][0]) / abs(out["cpu"][0])
    worst, worst_name = 0.0, ""
    for name, a, c in zip(params, out["card"][1], out["cpu"][1]):
        rel = (a - c).abs().max().item() / c.abs().max().item()
        if rel > worst:
            worst, worst_name = rel, name
    print(f"train: {config}: card vs CPU at B=8, full width, f32: loss "
          f"{out['card'][0]:.7f} vs {out['cpu'][0]:.7f} (rel diff "
          f"{d_loss:.3e}, tol {TOL_TRAIN_LOSS}); 19 gradients, worst max "
          f"|diff| / max |g| {worst:.3e} ({worst_name}, tol "
          f"{TOL_TRAIN_GRAD})", flush=True)
    if not (d_loss <= TOL_TRAIN_LOSS and worst <= TOL_TRAIN_GRAD):
        fail("train", f"{config}: card and CPU disagree beyond tolerance")


# ---------------------------------------------------------------------------
# phase 9: the text-classification path
# ---------------------------------------------------------------------------


def textclf_net(hidden: int, dev):
    """``lstm_benchmark_net`` at the reference bench's widths through the
    port's ``nn.Topology`` -> (topology, cost layer)."""
    import paddle_tpu_torch.nn as nn
    from paddle_tpu_torch.models import lstm_benchmark_net

    nn.reset_naming()
    cost, _ = lstm_benchmark_net(TEXTCLF_VOCAB, emb_dim=TEXTCLF_EMB,
                                 hid_dim=hidden, num_layers=TEXTCLF_LAYERS)
    return nn.Topology(cost, device=dev), cost


def textclf_feed(B: int, T: int, seed: int):
    """``bench.py:398-403``'s feed from a numpy ``RandomState(seed)``."""
    import numpy as np

    rng = np.random.RandomState(seed)
    return {"words": (rng.randint(3, TEXTCLF_VOCAB, (B, T)).astype(np.int32),
                      rng.randint(T // 2, T + 1, B).astype(np.int32)),
            "label": rng.randint(0, 2, (B, 1))}


def textclf_flops(B: int, T: int, hidden: int) -> float:
    """``bench.py:410-414``: 3x the analytic forward FLOPs."""
    E, H, L = TEXTCLF_EMB, hidden, TEXTCLF_LAYERS
    fwd = (B * T * E * 4 * H * 2 + B * T * H * 4 * H * 2
           + (L - 1) * (B * T * H * 4 * H * 2 * 2) + B * H * 2 * 2)
    return 3.0 * fwd


def textclf_train(K, dev, hidden: int):
    """6 Adam steps of ``lstm_benchmark_net`` at B=64, T=100, bf16, the
    way ``bench.py::_topology_step`` drives it: ``apply`` ->
    ``torch.autograd.grad`` -> ``update``.  -> (launches, topology,
    params, state, feed, losses, median step seconds)."""
    import numpy as np
    import torch

    from paddle_tpu_torch.param import Adam

    B, T = TEXTCLF_B, TEXTCLF_T
    topo, cost = textclf_net(hidden, dev)
    params, state = topo.init(SEED)
    params = {k: v.requires_grad_() for k, v in params.items()}
    feed = textclf_feed(B, T, SEED)
    opt = Adam(learning_rate=1e-3)
    opt_state = opt.init_state(params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)

    def step():
        outs, _ = topo.apply(params, state, feed, train=True)
        loss = outs[cost.name].value
        grads = torch.autograd.grad(loss, list(params.values()))
        opt.update(params, dict(zip(params, grads)), opt_state)
        return loss

    K.reset_launch_counts()
    losses, secs = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        losses.append(step().item())                # synchronises
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    launches = K.launch_counts()

    tag = f"b{B}h{hidden}"
    if not all(np.isfinite(losses)):
        fail("textclf", f"{tag}: loss not finite: {losses}")
    if not losses[-1] < losses[0]:
        fail("textclf", f"{tag}: loss did not fall: {losses}")
    if int(opt_state["step"]) != TRAIN_STEPS:
        fail("textclf", f"{tag}: optimizer step counter "
             f"{int(opt_state['step'])} after {TRAIN_STEPS} updates")
    for name in TEXTCLF_KERNELS:
        if launches[name] <= 0:
            fail("textclf", f"{tag}: kernel {name} was not launched on the "
                 f"training path")
    # K9 and K10 at b64 take their persistent kernels at both widths
    for name in TEXTCLF_KERNELS:
        if launches.by_path[name] != {"persistent": launches[name]}:
            fail("textclf", f"{tag}: {name} launches by path "
                 f"{launches.by_path[name]}, not all persistent")
    steady = sorted(secs[1:])
    sec = steady[len(steady) // 2]
    flops = textclf_flops(B, T, hidden)
    print(f"textclf: lstm_{tag} losses {[round(x, 6) for x in losses]}",
          flush=True)
    print(f"textclf: lstm_{tag} (T={T}, vocab {TEXTCLF_VOCAB}, "
          f"{TEXTCLF_LAYERS} LSTM layers, bf16) Adam, {TRAIN_STEPS} steps: "
          f"first step {secs[0]:.3f} s, median of the rest "
          f"{sec * 1e3:.2f} ms/step ({[round(x * 1e3, 2) for x in secs]} ms)"
          f", {B / sec:.1f} samples/s, MFU "
          f"{flops / sec / PEAK_OPS_PER_S['bfloat16']:.4%} of 989 TFLOP/s "
          f"({flops:.4e} FLOP/step), peak memory "
          f"{torch.cuda.max_memory_allocated(dev) / 2 ** 30:.2f} GiB, "
          f"launches {launches}", flush=True)
    return launches, topo, params, state, feed, losses, sec


def textclf_infer(K, topo, params, state, feed, hidden: int):
    """One forward-only pass (``apply(train=False)`` under
    ``torch.no_grad()``): the logits, through K9's inference variant on
    its persistent kernel."""
    import torch

    K.reset_launch_counts()
    t0 = time.perf_counter()
    with torch.no_grad():
        outs, _ = topo.apply(params, state, feed, train=False)
        logits = outs["logits"].value
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    launches = K.launch_counts()
    B = TEXTCLF_B
    if tuple(logits.shape) != (B, 2) or not torch.isfinite(logits).all():
        fail("textclf", f"inference logits malformed: {tuple(logits.shape)}")
    if (launches["lstm_forward"] <= 0 or launches["lstm_backward"] != 0
            or launches.by_path["lstm_forward"] != {
                "persistent": launches["lstm_forward"]}):
        fail("textclf", f"inference launches {launches} (by path "
             f"{launches.by_path['lstm_forward']}): want lstm_forward, all "
             f"persistent, and no lstm_backward")
    print(f"textclf: inference b{B}h{hidden} apply(train=False): "
          f"{sec * 1e3:.2f} ms ({B / sec:.1f} samples/s, first call), "
          f"logits {tuple(logits.shape)}, launches {launches}", flush=True)
    return launches


#: card-vs-CPU text-classification check (f32 on both sides): the loss
#: relative, each gradient's max |diff| against its largest entry (f32
#: sums over 100 recurrent steps and a 30k x 128 table taken in another
#: order)
TOL_TEXTCLF_LOSS, TOL_TEXTCLF_GRAD = 1e-5, 1e-3


def textclf_cpu_check(dev):
    """The net at full width (H=256) with B=4, mixed lengths, f32: loss and
    all 15 gradients on the card (K9r, K10) against the CPU (their plain
    versions), same parameters, peepholes and biases nonzero."""
    import numpy as np
    import torch

    from paddle_tpu_torch.ops.numerics import compute_dtype_scope

    B, T = 4, TEXTCLF_T
    card, cost = textclf_net(256, dev)
    cpu, _ = textclf_net(256, "cpu")
    params, _ = cpu.init(SEED + 1)
    rng = np.random.RandomState(SEED + 1)
    for k, v in params.items():
        if ".check_" in k or k.endswith(".wbias"):
            params[k] = torch.from_numpy(
                (0.3 * rng.randn(*v.shape)).astype(np.float32))
    # the embedding init (0.01) leaves the LSTMs near their linear regime
    params["_emb.w0"] = params["_emb.w0"] * 50.0
    feed = textclf_feed(B, T, SEED + 1)
    feed["words"][1][:2] = (T, 1)
    out = {}
    with compute_dtype_scope("float32"):
        for name, topo, dv in (("card", card, dev), ("cpu", cpu, "cpu")):
            p = {k: v.to(dv).requires_grad_() for k, v in params.items()}
            outs, _ = topo.apply(p, {}, feed, train=True)
            loss = outs[cost.name].value
            grads = torch.autograd.grad(loss, list(p.values()))
            out[name] = (loss.item(), [g.cpu() for g in grads])
    d_loss = abs(out["card"][0] - out["cpu"][0]) / abs(out["cpu"][0])
    worst, worst_name = 0.0, ""
    for name, a, c in zip(params, out["card"][1], out["cpu"][1]):
        rel = (a - c).abs().max().item() / c.abs().max().item()
        if rel > worst:
            worst, worst_name = rel, name
    n = len(out["card"][1])
    print(f"textclf: card vs CPU at H=256, B={B}, T={T}, f32: loss "
          f"{out['card'][0]:.7f} vs {out['cpu'][0]:.7f} (rel diff "
          f"{d_loss:.3e}, tol {TOL_TEXTCLF_LOSS}); {n} gradients, worst max "
          f"|diff| / max |g| {worst:.3e} ({worst_name}, tol "
          f"{TOL_TEXTCLF_GRAD})", flush=True)
    if n != 15 or not (d_loss <= TOL_TEXTCLF_LOSS
                       and worst <= TOL_TEXTCLF_GRAD):
        fail("textclf", "card and CPU disagree beyond tolerance")


# ---------------------------------------------------------------------------
# phase 10: generation through the nn DSL's beam_search layer
# ---------------------------------------------------------------------------


def dslgen_net():
    """The reference's demo/seqToseq generation net
    (``tests/torch_seqtoseq_net.py``) with the port's DSL at the WMT14
    widths (E = H = D = A = 512, 30k vocabularies): -> the ``beam_search``
    layer."""
    import paddle_tpu_torch.nn as nn
    import paddle_tpu_torch.v2.networks as networks

    if os.path.join(ROOT, "tests") not in sys.path:
        sys.path.insert(0, os.path.join(ROOT, "tests"))
    from torch_seqtoseq_net import seqtoseq_generator

    W = DSLGEN_WIDTH
    nn.reset_naming()
    return seqtoseq_generator(nn, networks, V=DSLGEN_VOCAB, E=W, H=W, D=W,
                              A=W, beam=BEAM, max_len=MAX_LEN)


def dslgen_feed(B: int, seed: int):
    """``make_requests``' recipe as one batch: B sources of 8-32 tokens,
    padded to SRC_LEN."""
    import numpy as np

    rng = np.random.default_rng(seed)
    lens = rng.integers(8, SRC_LEN + 1, B)
    ids = np.ones((B, SRC_LEN), np.int64)
    for i, n in enumerate(lens):
        ids[i, :n] = rng.integers(3, DSLGEN_VOCAB, n)
    return {"src": (ids, lens)}


def dslgen_step(outs, K: int, rows=slice(None)):
    """The ``beam_search`` layer's step written by hand as a function of
    (params, tokens, mems), over the encoder outputs in ``outs`` (the
    ``enc`` and ``enc_proj`` layers' Acts) of the sources ``rows``, tiled
    per beam."""
    import paddle_tpu_torch.ops as O

    enc, mask, proj = (x[rows].repeat_interleave(K, 0) for x in (
        outs["enc"].value, outs["enc"].mask, outs["enc_proj"].value))

    def step(p, tokens, mems):
        s = mems["s"]
        e = O.embedding_lookup(p["_trg_emb.w0"], tokens)
        scores = O.additive_attention_scores(proj, s, p["_att.w0"],
                                             p["_att.v"])
        ctx, _ = O.attend(scores, enc, mask)
        xp = O.linear(e, p["_dec_in.w0"]) + O.linear(ctx, p["_dec_in.w1"])
        h = O.gru_step(xp + p["_dec_in.wbias"], s, p["_dec_gru.w0"])
        return O.linear(h, p["_readout.w0"], p["_readout.wbias"]), {"s": h}

    return step


def dslgen_path(K, dev):
    """The main run (bf16): 64 sources through ``Topology.apply`` on the
    ``beam_search`` layer, then the layer against ``SequenceGenerator``
    over ``dslgen_step`` with the same parameters.  The encoder alone and
    the hand-written decode are timed too: the layer's time less theirs is
    what walking the step net costs the host."""
    import torch

    import paddle_tpu_torch.nn as nn
    from paddle_tpu_torch.ops.numerics import compute_dtype_scope

    B = DSLGEN_B
    topo = nn.Topology(dslgen_net(), device=dev)
    t0 = time.perf_counter()
    params, _ = topo.init(SEED)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    feed = dslgen_feed(B, SEED)
    with compute_dtype_scope("bfloat16"), torch.no_grad():
        topo.apply(params, {}, dslgen_feed(B, SEED + 1))      # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        K.reset_launch_counts()
        t0 = time.perf_counter()
        outs, _ = topo.apply(params, {}, feed, train=False)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        launches = K.launch_counts()
        peak = torch.cuda.max_memory_allocated(dev)
        gen = outs["gen"]
        toks, scores = gen.value, gen.state["scores"]
        t0 = time.perf_counter()
        topo.apply(params, {}, feed, outputs=["enc_proj", "boot"])
        torch.cuda.synchronize()
        t_enc = time.perf_counter() - t0
        step = dslgen_step(outs, BEAM)
        t0 = time.perf_counter()
        m_toks, m_scores = nn.SequenceGenerator(
            step, vocab_size=DSLGEN_VOCAB).generate(
                params, {"s": outs["boot"].value}, batch_size=B,
                beam_size=BEAM, max_len=MAX_LEN)
        torch.cuda.synchronize()
        t_hand = time.perf_counter() - t0
    steps = launches["topk_lse_logits"]
    if tuple(toks.shape) != (B, BEAM, MAX_LEN) or toks.dtype != torch.int64 \
            or int(toks.min()) < 0 or int(toks.max()) >= DSLGEN_VOCAB \
            or not torch.isfinite(scores).all() \
            or not bool((scores[:, :-1] >= scores[:, 1:]).all()):
        fail("dslgen", f"malformed result: tokens {tuple(toks.shape)} "
             f"{toks.dtype}, scores finite and best-first?")
    if launches["gru_forward"] != 2 or not 1 <= steps <= MAX_LEN:
        fail("dslgen", f"launches {launches}: want gru_forward 2 and "
             f"topk_lse_logits once a decode step")
    for name in DSLGEN_KERNELS:
        if launches[name] <= 0:
            fail("dslgen", f"kernel {name} was not launched on the path")
    _all_persistent("dslgen", "beam_search layer", launches, ("gru_forward",))
    print(f"dslgen: beam_search layer, {B} sources (8-{SRC_LEN} tokens), "
          f"beam {BEAM}, max_length {MAX_LEN}, bf16 compute: "
          f"{sec * 1e3:.2f} ms, {B / sec:.2f} sentences/s, {steps} decode "
          f"steps ({steps / sec:.1f} steps/s, {steps * B * BEAM / sec:.1f} "
          f"beam rows/s), peak memory {peak / 2 ** 30:.2f} GiB, launches "
          f"{launches}, param init {t_init:.2f} s", flush=True)
    walk = sec - t_enc - t_hand
    print(f"dslgen: encoder alone {t_enc * 1e3:.2f} ms, decode over the "
          f"hand-written step {t_hand * 1e3:.2f} ms: walking the step net "
          f"costs {walk * 1e3:.2f} ms "
          f"({walk / max(steps, 1) * 1e3:.3f} ms a step)",
          flush=True)
    same_ids = torch.equal(toks, m_toks)
    same_scores = torch.equal(scores, m_scores)
    print(f"dslgen: layer vs SequenceGenerator over the hand-written step, "
          f"same parameters: ids {'identical' if same_ids else 'DIFFER'}, "
          f"scores {'identical' if same_scores else 'differ'}", flush=True)
    if not same_ids:
        fail("dslgen", "the beam_search layer and SequenceGenerator differ")
    return launches, {k: v.cpu() for k, v in params.items()}


#: card-vs-CPU DSL generation (f32 on both sides, abs on a beam score of
#: about -330 from 32 steps): sums in another order, as TOL_SEARCH
TOL_DSLGEN = 1e-3


def dsl_rescore(step, params, s0, hyp) -> float:
    """Teacher-forced log-prob of one hypothesis under ``step`` from state
    ``s0`` [1, D]: the score beam search reports for it."""
    import torch

    state, y, total = {"s": s0}, 0, 0.0
    dev = s0.device
    for tok in (int(t) for t in hyp):
        logits, state = step(params, torch.tensor([y], device=dev), state)
        total += float(torch.log_softmax(logits.float(), -1)[0, tok])
        if tok == 1:
            break
        y = tok
    return total


def dslgen_cpu_check(dev, params):
    """The net at full width with B=2 in f32, on the card (kernels) and on
    the CPU (plain versions), same parameters: per source, ids identical
    and scores within TOL_DSLGEN, or (a near tie of the nearly flat
    random-init logits) each side's best hypothesis rescored on the other
    within TOL_DSLGEN of its own score."""
    import torch

    import paddle_tpu_torch.nn as nn
    from paddle_tpu_torch.ops.numerics import compute_dtype_scope

    gen = dslgen_net()
    feed = dslgen_feed(2, SEED + 2)
    res = {}
    with compute_dtype_scope("float32"), torch.no_grad():
        for name, dv in (("card", dev), ("cpu", "cpu")):
            p = {k: v.to(dv) for k, v in params.items()}
            outs, _ = nn.Topology(gen, device=dv).apply(p, {}, feed)
            res[name] = (outs, p)
        for b in range(2):
            ct, cs = (res["card"][0]["gen"].value[b].cpu(),
                      res["card"][0]["gen"].state["scores"][b].cpu())
            pt, ps = (res["cpu"][0]["gen"].value[b],
                      res["cpu"][0]["gen"].state["scores"][b])
            d_best = abs(float(cs[0]) - float(ps[0]))
            if torch.equal(ct, pt):
                d = (cs - ps).abs().max().item()
                print(f"dslgen: card vs CPU, source {b}, f32: ids identical,"
                      f" scores max diff {d:.3e} (tol {TOL_DSLGEN})",
                      flush=True)
                if d > TOL_DSLGEN:
                    fail("dslgen", f"source {b}: scores beyond tol")
                continue
            on_cpu, on_card = (
                dsl_rescore(dslgen_step(outs, 1, slice(b, b + 1)), p,
                            outs["boot"].value[b:b + 1], hyp)
                for (outs, p), hyp in ((res["cpu"], ct[0]),
                                       (res["card"], pt[0])))
            d1, d2 = abs(on_cpu - float(cs[0])), abs(on_card - float(ps[0]))
            print(f"dslgen: card vs CPU, source {b}, f32: ids differ (near "
                  f"tie); best scores differ by {d_best:.3e}, card's best "
                  f"rescored on the CPU {d1:.3e}, CPU's on the card "
                  f"{d2:.3e} (tol {TOL_DSLGEN})", flush=True)
            if max(d_best, d1, d2) > TOL_DSLGEN:
                fail("dslgen", f"source {b}: card and CPU disagree beyond "
                     f"a near tie")


# ---------------------------------------------------------------------------
# phase 11: the trainer and its command line
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def recorded_losses():
    """Every ``SGDTrainer.train_batch`` loss, as a float, while inside: how
    this script reads the command line's per-batch losses."""
    from paddle_tpu_torch.trainer import SGDTrainer

    losses = []
    step = SGDTrainer.train_batch

    def recording(self, feed):
        loss = step(self, feed)
        losses.append(loss.item())
        return loss

    SGDTrainer.train_batch = recording
    try:
        yield losses
    finally:
        SGDTrainer.train_batch = step


@contextlib.contextmanager
def cli_run(n_samples: int, var: str = "TORCH_TEXTCLF_N"):
    """The command line's config at ``n_samples`` a pass (its environment
    variable ``var``); the port's flags (which the command line sets) and
    the environment restored after."""
    from paddle_tpu_torch.utils.flags import FLAGS

    keep, old = FLAGS.as_dict(), os.environ.get(var)
    os.environ[var] = str(n_samples)
    try:
        yield
    finally:
        for k, v in keep.items():
            setattr(FLAGS, k, v)
        if old is None:
            os.environ.pop(var)
        else:
            os.environ[var] = old


def cli(argv, conf: str = TRAINER_CONF, phase: str = "trainer"):
    """``main(argv)`` of ``python -m paddle_tpu_torch`` on ``conf`` -> what
    it printed; fails unless it returns 0."""
    import io

    from paddle_tpu_torch.__main__ import main

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main([f"--config={conf}", "--log_period=0", *argv])
    if rc != 0:
        fail(phase, f"{argv}: exit code {rc}")
    return out.getvalue()


def trainer_path(K, dev, card, direct_losses, direct_sec):
    """``SGDTrainer`` and ``python -m paddle_tpu_torch`` on
    ``lstm_benchmark_net`` at lstm_b64h256 (bf16): the textclf phase's six
    losses from ``train_batch`` bit for bit; ``--job=train`` for two
    passes, then resumed from pass 0 with ``--start_pass=1``;
    ``--job=test``, ``--job=checkgrad`` (f32) and ``--job=time``.  ->
    {part: launches}."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from paddle_tpu_torch.param import Adam
    from paddle_tpu_torch.resilience import validate_checkpoint
    from paddle_tpu_torch.resilience.checkpoint_io import pass_dir
    from paddle_tpu_torch.trainer import SGDTrainer

    launches = {}
    # 1. the direct loop's losses, through the guarded trainer step
    _, cost = textclf_net(256, dev)
    tr = SGDTrainer(cost, Adam(learning_rate=1e-3), seed=SEED, device=dev)
    feed = textclf_feed(TEXTCLF_B, TEXTCLF_T, SEED)
    K.reset_launch_counts()
    losses = [tr.train_batch(feed).item() for _ in range(TRAIN_STEPS)]
    launches["train_batch"] = got = K.launch_counts()
    print(f"trainer: SGDTrainer(Adam(1e-3), seed={SEED}, guard "
          f"{tr.guard_nonfinite}).train_batch x {TRAIN_STEPS} at b64h256: "
          f"losses {losses}; the textclf phase's direct loop "
          f"{direct_losses}: {'bit for bit' if losses == direct_losses else 'DIFFERENT'}"
          f"; launches {got}", flush=True)
    if not tr.guard_nonfinite or losses != direct_losses:
        fail("trainer", "train_batch's losses differ from the direct loop's")
    if int(tr.opt_state["step"]) != TRAIN_STEPS or tr.bad_steps_total:
        fail("trainer", f"step counter {int(tr.opt_state['step'])}, bad "
             f"steps {tr.bad_steps_total}")
    for name in TEXTCLF_KERNELS:
        if got[name] != 2 * TRAIN_STEPS:
            fail("trainer", f"{name}: {got[name]} launches, want "
                 f"{2 * TRAIN_STEPS} (2 LSTM layers a step)")
    _all_persistent("trainer", "train_batch", got, TEXTCLF_KERNELS)
    del tr
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp:
        full, part = os.path.join(tmp, "full"), os.path.join(tmp, "part")
        n = TEXTCLF_B * TRAINER_PASS_BATCHES
        # 2. two passes through the command line
        K.reset_launch_counts()
        with cli_run(n), recorded_losses() as run:
            t0 = time.perf_counter()
            cli(["--job=train", f"--save_dir={full}", "--num_passes=2"])
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
        launches["cli_train"] = got = K.launch_counts()
        per = TRAINER_PASS_BATCHES
        print(f"trainer: --job=train, 2 passes of {per} batches (B="
              f"{TEXTCLF_B}, T={TEXTCLF_T}, bf16, a test pass after each): "
              f"{sec:.2f} s, losses {run}, launches {got}", flush=True)
        if len(run) != 2 * per or not all(np.isfinite(run)) or not (
                run[-1] < run[0]):
            fail("trainer", f"--job=train losses {run}: want {2 * per} "
                 f"finite, falling")
        for p in (0, 1):
            why = validate_checkpoint(pass_dir(full, p))
            if why is not None:
                fail("trainer", f"pass {p} checkpoint: {why}")
        if got["lstm_backward"] != 2 * 2 * per or got["lstm_forward"] <= \
                got["lstm_backward"]:
            fail("trainer", f"--job=train launches {got}: want "
                 f"{4 * per} lstm_backward and K9 beyond them (test passes)")
        _all_persistent("trainer", "--job=train", got, TEXTCLF_KERNELS)

        # 3. resumed from pass 0: pass 1 again
        shutil.copytree(pass_dir(full, 0), pass_dir(part, 0))
        K.reset_launch_counts()
        with cli_run(n), recorded_losses() as resumed:
            cli(["--job=train", f"--save_dir={part}", "--num_passes=2",
                 "--start_pass=1"])
        launches["cli_resume"] = got = K.launch_counts()
        want = run[per:]
        rel = max(abs(a - b) / abs(b) for a, b in zip(resumed, want))
        same = resumed == want
        print(f"trainer: --start_pass=1 from the pass-0 checkpoint: pass-1 "
              f"losses {resumed} vs the uninterrupted run's {want}: "
              f"{'bit for bit' if same else f'max rel diff {rel:.3e} (tol {TOL_TRAINER_RESUME})'}"
              f", launches {got}", flush=True)
        if len(resumed) != per or rel > TOL_TRAINER_RESUME:
            fail("trainer", "the resumed pass 1 differs from the "
                 "uninterrupted run's")
        _all_persistent("trainer", "--start_pass=1", got, TEXTCLF_KERNELS)

        # 4. the test job from the last checkpoint: K9, no K10
        K.reset_launch_counts()
        with cli_run(n):
            out = cli(["--job=test", f"--save_dir={full}"])
        launches["cli_test"] = got = K.launch_counts()
        result = out.strip().splitlines()[-1]
        print(f"trainer: --job=test from pass 1: {result}, launches {got}",
              flush=True)
        if (got["lstm_forward"] <= 0 or got["lstm_backward"] != 0
                or "cost" not in result):
            fail("trainer", "--job=test must launch K9 and no K10")
        _all_persistent("trainer", "--job=test", got, TEXTCLF_KERNELS)

        # 5. finite differences against autograd, under f32
        K.reset_launch_counts()
        with cli_run(n):
            out = cli(["--job=checkgrad", "--compute_dtype=float32"])
        launches["cli_checkgrad"] = got = K.launch_counts()
        print(f"trainer: --job=checkgrad (f32): {out.strip()}, launches "
              f"{got}", flush=True)
        if "checkgrad OK (15 parameters" not in out:
            fail("trainer", "--job=checkgrad did not pass")

    # 6. the time job beside the direct loop
    K.reset_launch_counts()
    with cli_run(TEXTCLF_B * TRAINER_TIME_BATCHES):
        out = cli(["--job=time", f"--time_batches={TRAINER_TIME_BATCHES}"])
    launches["cli_time"] = got = K.launch_counts()
    ms = float(out.split(" ms/batch")[0].split()[-1])
    print(f"trainer: --job=time: {ms:.2f} ms/batch over "
          f"{TRAINER_TIME_BATCHES} batches (B={TEXTCLF_B}, T={TEXTCLF_T}, "
          f"bf16, synthetic imdb, guarded Adam step); the textclf phase's "
          f"direct loop median {direct_sec * 1e3:.2f} ms/step "
          f"[{card}]; launches {got}", flush=True)
    _all_persistent("trainer", "--job=time", got, TEXTCLF_KERNELS)
    if got["lstm_backward"] != 2 * (TRAINER_TIME_BATCHES + 1):
        fail("trainer", f"--job=time launches {got}: want "
             f"{2 * (TRAINER_TIME_BATCHES + 1)} lstm_backward")
    return launches


# ---------------------------------------------------------------------------
# phase 12: the image tier
# ---------------------------------------------------------------------------


def vision_net(model: str, kwargs: dict):
    """One of the port's image models -> (cost, logits)."""
    import paddle_tpu_torch.models as models
    import paddle_tpu_torch.nn as nn

    nn.reset_naming()
    return getattr(models, model)(**kwargs)


def vision_flops(topo, B: int) -> float:
    """Analytic FLOPs of one training step from the built graph's shapes:
    2*B*Ho*Wo*k*k*(Cin/g)*Cout per conv and 2*B*in*out per fc weight, the
    forward three times over (forward, and the two products of the
    backward); pooling, batch norm and the elementwise ops not counted."""
    fwd = 0.0
    for layer in topo.layers:
        if layer.layer_type == "conv":
            kh, kw, cin_g, cout = layer.param_specs[0].shape
            ho, wo = layer.meta["hw"]
            fwd += 2.0 * B * ho * wo * kh * kw * cin_g * cout
        elif layer.layer_type == "fc":
            for spec in layer.param_specs:
                if len(spec.shape) == 2:
                    fwd += 2.0 * B * spec.shape[0] * spec.shape[1]
    return 3.0 * fwd


def vision_feed(B: int, side: int, classes: int, seed: int, dev):
    """``bench.py``'s image feed from a numpy ``RandomState(seed)``:
    pixels ``rand(B, side, side, 3)``, labels in [0, classes); on ``dev``
    once, before any step."""
    import numpy as np
    import torch

    rng = np.random.RandomState(seed)
    pixel = rng.rand(B, side, side, 3).astype(np.float32)
    label = rng.randint(0, classes, (B, 1))
    return {"pixel": torch.from_numpy(pixel).to(dev),
            "label": torch.from_numpy(label).to(dev)}


def vision_train(K, dev, card, row):
    """``row`` of ``VISION_ROWS``: ``Momentum`` steps of the direct loop
    (``apply`` -> ``torch.autograd.grad`` -> ``update`` -> the new
    batch-norm state), bf16 compute.  -> (losses, median step seconds,
    topology, cost, logits, the initial state, the final state)."""
    import numpy as np
    import torch

    import paddle_tpu_torch.nn as nn
    from paddle_tpu_torch.param import Momentum

    tag, model, kwargs, B, side, classes, lr, steps = row
    cost, logits = vision_net(model, kwargs)
    topo = nn.Topology([cost, logits], device=dev)
    params, state0 = topo.init(SEED)
    params = {k: v.requires_grad_() for k, v in params.items()}
    state = dict(state0)
    opt = Momentum(learning_rate=lr)
    ost = opt.init_state(params)
    feed = vision_feed(B, side, classes, SEED, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    losses, secs = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        outs, state = topo.apply(params, state, feed, train=True)
        loss = outs[cost.name].value
        grads = torch.autograd.grad(loss, list(params.values()))
        opt.update(params, dict(zip(params, grads)), ost)
        losses.append(loss.item())                    # synchronises
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated(dev)
    if not all(np.isfinite(losses)):
        fail("vision", f"{tag}: loss not finite: {losses}")
    if int(ost["step"]) != steps:
        fail("vision", f"{tag}: optimizer step counter {int(ost['step'])} "
             f"after {steps} updates")
    rest = sorted(secs[1:])
    sec = rest[len(rest) // 2]
    flops = vision_flops(topo, B)
    print(f"vision: {tag} ({model}, B={B}, {side}x{side}x3, {classes} "
          f"classes, bf16, Momentum({lr})) losses "
          f"{[round(x, 6) for x in losses]}", flush=True)
    print(f"vision: {tag} {steps} steps: first {secs[0]:.3f} s, median of "
          f"steps 2-{steps} {sec * 1e3:.2f} ms/step (min "
          f"{rest[0] * 1e3:.2f}, max {rest[-1] * 1e3:.2f}), "
          f"{B / sec:.1f} images/s, MFU "
          f"{flops / sec / PEAK_OPS_PER_S['bfloat16']:.4%} of 989 TFLOP/s "
          f"({flops:.4e} FLOP/step: 3 x (2 B Ho Wo k^2 Cin/g Cout per "
          f"conv + 2 B in out per fc)), peak memory {peak / 2 ** 30:.2f} "
          f"GiB [{card}]", flush=True)
    return losses, sec, topo, cost, logits, state0, state, params, feed


def vision_trainer_check(dev, cost, direct_losses, state0, row):
    """``SGDTrainer(cost, Momentum(lr), seed=SEED).train_batch`` on the
    direct loop's feed, as many steps: its losses against the direct
    loop's (bit for bit, or within ``TOL_VISION_RESUME``), and its
    batch-norm running stats moved from their initial values."""
    import torch

    from paddle_tpu_torch.param import Momentum
    from paddle_tpu_torch.trainer import SGDTrainer

    tag, _, _, B, side, classes, lr, steps = row
    tr = SGDTrainer(cost, Momentum(learning_rate=lr), seed=SEED, device=dev)
    feed = vision_feed(B, side, classes, SEED, dev)
    losses = [tr.train_batch(feed).item() for _ in range(steps)]
    same = losses == direct_losses
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, direct_losses))
    moved = [k for k, v in tr.state.items()
             if not torch.equal(v, state0[k])]
    print(f"vision: {tag} SGDTrainer(Momentum({lr}), seed={SEED})"
          f".train_batch x {steps}: losses {losses}; the direct loop's "
          f"{direct_losses}: "
          f"{'bit for bit' if same else f'max rel diff {rel:.3e} (tol {TOL_VISION_RESUME})'}"
          f"; running stats moved: {len(moved)} of {len(tr.state)}; "
          f"cudnn.deterministic {torch.backends.cudnn.deterministic}",
          flush=True)
    if rel > TOL_VISION_RESUME:
        fail("vision", f"{tag}: SGDTrainer's losses differ from the direct "
             f"loop's")
    if not tr.state or len(moved) != len(tr.state):
        fail("vision", f"{tag}: batch-norm running stats did not all move")
    if int(tr.opt_state["step"]) != steps or tr.bad_steps_total:
        fail("vision", f"{tag}: step counter {int(tr.opt_state['step'])}, "
             f"bad steps {tr.bad_steps_total}")


def vision_infer(dev, card, topo, params, state, logits, row):
    """One forward pass of the trained net (``apply(train=False)`` under
    ``torch.no_grad()``, the running stats normalising)."""
    import torch

    tag, _, _, B, side, classes, _, _ = row
    feed = vision_feed(B, side, classes, SEED + 1, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        outs, new_state = topo.apply(params, state, feed, train=False)
        out = outs[logits.name].value
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    print(f"vision: {tag} inference apply(train=False): {sec * 1e3:.2f} ms "
          f"(first call), {B / sec:.1f} images/s, logits "
          f"{tuple(out.shape)} [{card}]", flush=True)
    if tuple(out.shape) != (B, classes) or not torch.isfinite(out).all():
        fail("vision", f"{tag}: inference logits malformed")
    if any(new_state[k] is not v for k, v in state.items()):
        fail("vision", f"{tag}: inference moved the running stats")


def vision_cli(card, direct_sec):
    """``python -m paddle_tpu_torch`` on ``tests/torch_resnet_conf.py``
    (resnet20_b256, synthetic cifar10, Momentum(0.1), bf16):
    ``--job=train`` for 2 passes of ``VISION_PASS_BATCHES`` batches,
    resumed from pass 0 with ``--start_pass=1`` (pass 1's losses against
    the uninterrupted run's), ``--job=time`` over ``VISION_TIME_BATCHES``
    batches beside the direct loop's median step."""
    import shutil
    import tempfile

    import numpy as np

    from paddle_tpu_torch.resilience import validate_checkpoint
    from paddle_tpu_torch.resilience.checkpoint_io import pass_dir

    B, var = int(os.environ.get("TORCH_RESNET_BATCH", 256)), "TORCH_RESNET_N"
    with tempfile.TemporaryDirectory() as tmp:
        full, part = os.path.join(tmp, "full"), os.path.join(tmp, "part")
        n = B * VISION_PASS_BATCHES
        with cli_run(n, var), recorded_losses() as run:
            t0 = time.perf_counter()
            cli(["--job=train", f"--save_dir={full}", "--num_passes=2"],
                VISION_CONF, "vision")
            sec = time.perf_counter() - t0
        per = VISION_PASS_BATCHES
        print(f"vision: --job=train on {os.path.basename(VISION_CONF)}, 2 "
              f"passes of {per} batches (B={B}, a test pass after each): "
              f"{sec:.2f} s, losses {run}", flush=True)
        if len(run) != 2 * per or not all(np.isfinite(run)):
            fail("vision", f"--job=train losses {run}: want {2 * per} "
                 f"finite")
        for p in (0, 1):
            why = validate_checkpoint(pass_dir(full, p))
            if why is not None:
                fail("vision", f"pass {p} checkpoint: {why}")
        shutil.copytree(pass_dir(full, 0), pass_dir(part, 0))
        with cli_run(n, var), recorded_losses() as resumed:
            cli(["--job=train", f"--save_dir={part}", "--num_passes=2",
                 "--start_pass=1"], VISION_CONF, "vision")
        want = run[per:]
        rel = max(abs(a - b) / abs(b) for a, b in zip(resumed, want))
        same = resumed == want
        print(f"vision: --start_pass=1 from the pass-0 checkpoint: pass-1 "
              f"losses {resumed} vs the uninterrupted run's {want}: "
              f"{'bit for bit' if same else f'max rel diff {rel:.3e} (tol {TOL_VISION_RESUME})'}",
              flush=True)
        if len(resumed) != per or rel > TOL_VISION_RESUME:
            fail("vision", "the resumed pass 1 differs from the "
                 "uninterrupted run's")
    with cli_run(B * VISION_TIME_BATCHES, var):
        out = cli(["--job=time", f"--time_batches={VISION_TIME_BATCHES}"],
                  VISION_CONF, "vision")
    ms = float(out.split(" ms/batch")[0].split()[-1])
    print(f"vision: --job=time: {ms:.2f} ms/batch over "
          f"{VISION_TIME_BATCHES} batches (resnet20_b256, bf16, synthetic "
          f"cifar10, guarded Momentum step); the direct loop's median "
          f"{direct_sec * 1e3:.2f} ms/step [{card}]", flush=True)


@contextlib.contextmanager
def shared_dropout():
    """The port's ``dropout`` on one numpy mask keyed by the activation's
    shape, on whichever device the activation is: so the card and the CPU
    drop the same units (their generators draw different numbers)."""
    import zlib

    import numpy as np
    import torch

    import paddle_tpu_torch.ops as O

    def dropout(gen, x, rate, *, train):
        if not train or rate <= 0.0:
            return x
        rs = np.random.RandomState(zlib.crc32(repr(tuple(x.shape)).encode()))
        keep = torch.from_numpy(rs.rand(*x.shape) >= rate).to(x.device)
        return torch.where(keep, x / (1.0 - rate),
                           torch.zeros((), dtype=x.dtype, device=x.device))

    real = O.dropout
    O.dropout = dropout
    try:
        yield
    finally:
        O.dropout = real


def vision_cpu_check(dev):
    """resnet_cifar at depth 8 (B=4) and AlexNet at 67x67 (B=2, dropout
    masks shared), f32: the loss, every gradient and the new running stats
    on the card against the CPU, from the same parameters."""
    import numpy as np
    import torch

    import paddle_tpu_torch.nn as nn
    from paddle_tpu_torch.ops.numerics import compute_dtype_scope

    cases = (("resnet_cifar", {"depth": 8}, 4, 32, 10),
             ("alexnet", {"num_classes": 10, "height": 67, "width": 67}, 2,
              67, 10))
    for model, kwargs, B, side, classes in cases:
        cost, _ = vision_net(model, kwargs)
        card, cpu = (nn.Topology(cost, device=d) for d in (dev, "cpu"))
        params, state = cpu.init(SEED + 1)
        feed = vision_feed(B, side, classes, SEED + 1, "cpu")
        out = {}
        with compute_dtype_scope("float32"), shared_dropout():
            for name, topo, dv in (("card", card, dev), ("cpu", cpu, "cpu")):
                p = {k: v.to(dv).requires_grad_() for k, v in params.items()}
                s = {k: v.to(dv) for k, v in state.items()}
                f = {k: v.to(dv) for k, v in feed.items()}
                outs, ns = topo.apply(p, s, f, train=True, rng=SEED)
                loss = outs[cost.name].value
                grads = torch.autograd.grad(loss, list(p.values()))
                out[name] = (loss.item(), [g.cpu() for g in grads],
                             {k: v.cpu() for k, v in ns.items()})
        d_loss = abs(out["card"][0] - out["cpu"][0]) / abs(out["cpu"][0])
        worst, worst_name = 0.0, ""
        for name, a, c in zip(params, out["card"][1], out["cpu"][1]):
            rel = (a - c).abs().max().item() / max(c.abs().max().item(),
                                                   1e-30)
            if rel > worst:
                worst, worst_name = rel, name
        d_state = max([(out["card"][2][k] - v).abs().max().item()
                       / max(v.abs().max().item(), 1e-30)
                       for k, v in out["cpu"][2].items()] or [0.0])
        print(f"vision: card vs CPU, {model} {kwargs} B={B}, f32: loss "
              f"{out['card'][0]:.7f} vs {out['cpu'][0]:.7f} (rel diff "
              f"{d_loss:.3e}, tol {TOL_VISION_LOSS}); {len(params)} "
              f"gradients, worst max |diff| / max |g| {worst:.3e} "
              f"({worst_name}, tol {TOL_VISION_GRAD}); {len(state)} "
              f"running stats, worst {d_state:.3e} (tol "
              f"{TOL_VISION_LOSS})", flush=True)
        if not (np.isfinite(out["card"][0]) and d_loss <= TOL_VISION_LOSS
                and worst <= TOL_VISION_GRAD
                and d_state <= TOL_VISION_LOSS):
            fail("vision", f"{model}: card and CPU disagree beyond "
                 f"tolerance")


def vision_path(K, dev, card):
    """The image tier on the card: ``VISION_ROWS`` through the direct
    loop, resnet20_b256 again through ``SGDTrainer`` and in one inference
    pass, the command line on ``tests/torch_resnet_conf.py``, and the card
    against the CPU.  No hand-written kernel lies on this path: every
    launch count must stay 0.  -> the launches."""
    import torch

    K.reset_launch_counts()
    direct_sec = None
    for row in VISION_ROWS:
        (losses, sec, topo, cost, logits, state0, state, params,
         _) = vision_train(K, dev, card, row)
        if row[0] == "resnet20_b256":
            direct_sec = sec
            vision_trainer_check(dev, cost, losses, state0, row)
            vision_infer(dev, card, topo, params, state, logits, row)
        del topo, params, state
        torch.cuda.empty_cache()
    vision_cli(card, direct_sec)
    vision_cpu_check(dev)
    launches = K.launch_counts()
    print(f"vision: hand-written kernel launches during the phase: "
          f"{dict(launches)} (none: the image tier runs PyTorch's own ops)",
          flush=True)
    if any(launches.values()):
        fail("vision", "a hand-written kernel launched on the image path")
    return launches


# ---------------------------------------------------------------------------
# phase 13: the text tier
# ---------------------------------------------------------------------------


def _launched(launches) -> dict:
    """The kernels that launched, each with its launches by path."""
    return {n: launches.by_path[n] for n, c in launches.items() if c}


def text_nets():
    """The package-agnostic builders of ``tests/``: (seqtoseq_trainer,
    seqtoseq_feed, db_lstm_net, SRL_SLOTS)."""
    if os.path.join(ROOT, "tests") not in sys.path:
        sys.path.insert(0, os.path.join(ROOT, "tests"))
    from torch_seqtoseq_net import seqtoseq_feed, seqtoseq_trainer
    from torch_text_nets import SRL_SLOTS, db_lstm_net

    return seqtoseq_trainer, seqtoseq_feed, db_lstm_net, SRL_SLOTS


def text_feeds(part: str):
    """TEXT_STEPS seeded batches of ``part``'s feed (numpy, as a user's
    reader gives them) and the real tokens of each."""
    import numpy as np

    import paddle_tpu_torch.data as data

    _, seqtoseq_feed, _, slots = text_nets()
    if part == "seqtoseq_group":
        feeds = [seqtoseq_feed(np.random.RandomState(SEED + i), TEXT_B,
                               DSLGEN_VOCAB, TEXT_S, TEXT_S)
                 for i in range(TEXT_STEPS)]
        return feeds, [int(f["trg_in"][1].sum()) for f in feeds]
    if part == "bidi_lstm":
        feeds = [textclf_feed(BIDI_B, BIDI_T, SEED + i)
                 for i in range(TEXT_STEPS)]
        return feeds, [int(f["words"][1].sum()) for f in feeds]
    if part in ("sentiment", "convolution"):
        feeder = data.DataFeeder({"words": "ids_seq", "label": "int"},
                                 max_len=SENTIMENT_MAX_LEN)
        reader = data.datasets.sentiment(
            "train", vocab_size=SENTIMENT_VOCAB,
            n=SENTIMENT_B * TEXT_STEPS)
        key = "words"
    else:
        feeder = data.DataFeeder({k: "ids_seq" for k in slots},
                                 max_len=SRL_MAX_LEN)
        reader = data.datasets.conll05_features(
            "train", vocab_size=SRL_VOCAB, n_labels=SRL_LABELS,
            n=SRL_B * TEXT_STEPS)
        key = "word_data"
    feeds = [feeder(b) for b in data.batch(
        reader, SRL_B if part == "srl" else SENTIMENT_B)()]
    return feeds, [int(np.asarray(f[key][1]).sum()) for f in feeds]


def text_cost(part: str):
    """``part``'s net with the port's DSL at its widths -> (cost, the
    layer an inference pass reads)."""
    import paddle_tpu_torch.models as models
    import paddle_tpu_torch.nn as nn
    import paddle_tpu_torch.v2.networks as networks

    seqtoseq_trainer, _, db_lstm_net, _ = text_nets()
    nn.reset_naming()
    if part == "seqtoseq_group":
        W = DSLGEN_WIDTH
        cost = seqtoseq_trainer(nn, networks, V=DSLGEN_VOCAB, E=W, H=W,
                                D=W, A=W)
        return cost, cost
    if part == "sentiment":
        cost, logits = models.stacked_lstm_net(SENTIMENT_VOCAB)
        return cost, logits
    if part == "convolution":
        cost, logits = models.convolution_net(SENTIMENT_VOCAB)
        return cost, logits
    if part == "bidi_lstm":
        words = nn.data("words", size=BIDI_VOCAB, is_seq=True,
                        dtype="int32")
        emb = nn.embedding(words, BIDI_EMB, name="emb")
        bi = networks.bidirectional_lstm(emb, BIDI_HID, name="bi")
        logits = nn.fc(nn.pooling(bi, pooling_type="max", name="pool"), 2,
                       act="linear", name="logits")
        label = nn.data("label", size=1, dtype="int32")
        return nn.classification_cost(logits, label, name="cost"), logits
    return db_lstm_net(nn, SRL_VOCAB, SRL_LABELS, hidden_dim=SRL_HIDDEN,
                       depth=SRL_DEPTH)


def text_train(K, dev, card, part: str, want: dict):
    """TEXT_STEPS ``SGDTrainer(cost, Adam(TEXT_LR), seed=SEED)
    .train_batch`` steps of ``part`` at bf16 on seeded batches: losses,
    the median step of steps 2-N, samples/s, real tokens/s, peak memory.
    ``want`` maps each kernel that must launch to its launches a step (all
    ``persistent``); every other count must stay 0.  -> (trainer, the
    inference layer, losses, median step seconds, launches)."""
    import numpy as np
    import torch

    from paddle_tpu_torch.param import Adam
    from paddle_tpu_torch.trainer import SGDTrainer

    cost, out = text_cost(part)
    feeds, tokens = text_feeds(part)
    tr = SGDTrainer(cost, Adam(learning_rate=TEXT_LR), seed=SEED, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    K.reset_launch_counts()
    losses, secs = [], []
    for feed in feeds:
        t0 = time.perf_counter()
        losses.append(tr.train_batch(feed).item())     # synchronises
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    launches = K.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    steps = len(feeds)
    rest = sorted(secs[1:])
    sec = rest[len(rest) // 2]
    B, T = np.asarray(next(iter(feeds[0].values()))[0]).shape[:2]
    print(f"text: {part} losses {[round(x, 6) for x in losses]}",
          flush=True)
    print(f"text: {part} SGDTrainer(Adam({TEXT_LR})) x {steps}, B={B}, "
          f"bf16: first step {secs[0]:.3f} s, median of steps 2-{steps} "
          f"{sec * 1e3:.2f} ms/step (min {rest[0] * 1e3:.2f}, max "
          f"{rest[-1] * 1e3:.2f}), {B / sec:.1f} samples/s, "
          f"{B * T / sec:.1f} words/s (B x T={T}), "
          f"{np.mean(tokens[1:]) / sec:.1f} real tokens/s, peak memory "
          f"{peak / 2 ** 30:.2f} GiB, launches "
          f"{_launched(launches)} [{card}]", flush=True)
    if not all(np.isfinite(losses)):
        fail("text", f"{part}: loss not finite: {losses}")
    if int(tr.opt_state["step"]) != steps or tr.bad_steps_total:
        fail("text", f"{part}: step counter {int(tr.opt_state['step'])}, "
             f"bad steps {tr.bad_steps_total}")
    _launch_check("text", part, launches,
                  {k: n * steps for k, n in want.items()})
    return tr, out, losses, sec, launches


def _launch_check(phase: str, part: str, launches, want: dict) -> None:
    """Fail unless each kernel of ``want`` launched exactly its count, all
    ``persistent``, and no other kernel launched."""
    got = {k: n for k, n in launches.items() if n}
    if got != want:
        fail(phase, f"{part}: launches {got}, want {want}")
    _all_persistent(phase, part, launches, want)


def text_infer(K, card, tr, out, feed, part: str, want: dict):
    """One inference pass of the trained net (``Topology([out]).apply(
    train=False)`` under ``torch.no_grad()``, the trainer's parameters),
    bf16: its time and launches (``want``, as ``text_train``'s).  -> (the
    output's value, launches)."""
    import torch

    import paddle_tpu_torch.nn as nn

    topo = nn.Topology(out, device=tr.device)
    torch.cuda.synchronize()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    with torch.no_grad():
        value = topo.apply(tr.params, tr.state, feed,
                           train=False)[0][out.name].value
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    launches = K.launch_counts()
    B = value.shape[0]
    print(f"text: {part} inference apply(train=False), B={B}, bf16: "
          f"{sec * 1e3:.2f} ms (first call), {B / sec:.1f} samples/s, "
          f"{out.name} {tuple(value.shape)} {value.dtype}, launches "
          f"{_launched(launches)} [{card}]", flush=True)
    _launch_check("text", f"{part} inference", launches, want)
    return value, launches


def text_cpu_check(dev, part: str, B: int):
    """``part``'s net at full width with B rows of its first batch, f32:
    the loss and every gradient on the card against the CPU from the same
    parameters (every all-zero one set to seeded normals)."""
    import numpy as np
    import torch

    import paddle_tpu_torch.nn as nn
    from paddle_tpu_torch.ops.numerics import compute_dtype_scope

    cost, _ = text_cost(part)
    feed = {k: tuple(a[:B] for a in v) if isinstance(v, tuple) else v[:B]
            for k, v in text_feeds(part)[0][0].items()}
    card, cpu = (nn.Topology(cost, device=d) for d in (dev, "cpu"))
    params, _ = cpu.init(SEED + 1)
    rng = np.random.RandomState(SEED + 1)
    params = {k: v if v.abs().max() > 0 else torch.from_numpy(
        (0.3 * rng.randn(*v.shape)).astype(np.float32))
        for k, v in params.items()}
    out = {}
    with compute_dtype_scope("float32"):
        for name, topo, dv in (("card", card, dev), ("cpu", cpu, "cpu")):
            p = {k: v.to(dv).requires_grad_() for k, v in params.items()}
            loss = topo.apply(p, {}, feed, train=True)[0][cost.name].value
            grads = torch.autograd.grad(loss, list(p.values()))
            out[name] = (loss.item(), [g.cpu() for g in grads])
    d_loss = abs(out["card"][0] - out["cpu"][0]) / abs(out["cpu"][0])
    worst, worst_name = 0.0, ""
    for name, a, c in zip(params, out["card"][1], out["cpu"][1]):
        rel = (a - c).abs().max().item() / max(c.abs().max().item(), 1e-30)
        if rel > worst:
            worst, worst_name = rel, name
    print(f"text: {part} card vs CPU, B={B}, f32: loss "
          f"{out['card'][0]:.7f} vs {out['cpu'][0]:.7f} (rel diff "
          f"{d_loss:.3e}, tol {TOL_TEXT_LOSS}); {len(params)} gradients, "
          f"worst max |diff| / max |g| {worst:.3e} ({worst_name}, tol "
          f"{TOL_TEXT_GRAD})", flush=True)
    if not (np.isfinite(out["cpu"][0]) and d_loss <= TOL_TEXT_LOSS
            and worst <= TOL_TEXT_GRAD):
        fail("text", f"{part}: card and CPU disagree beyond tolerance")


def text_decode_check(tr, decoded, feed):
    """The trained SRL net's Viterbi tags on the card against the CPU's,
    same weights, f32 on both sides: identical."""
    import torch

    import paddle_tpu_torch.nn as nn
    from paddle_tpu_torch.ops.numerics import compute_dtype_scope

    tags = {}
    with compute_dtype_scope("float32"), torch.no_grad():
        for dv in (tr.device, "cpu"):
            p = {k: v.detach().to(dv) for k, v in tr.params.items()}
            tags[str(dv)] = nn.Topology(decoded, device=dv).apply(
                p, {}, feed, train=False)[0][decoded.name].value.cpu()
    got, want = tags[str(tr.device)], tags["cpu"]
    same = torch.equal(got, want)
    print(f"text: srl crf_decoding card vs CPU, f32, trained weights: tags "
          f"{tuple(got.shape)} {'identical' if same else 'DIFFER'} "
          f"({int((got != want).sum())} of {got.numel()} differ; "
          f"{len(torch.unique(want))} distinct tags)", flush=True)
    if not same:
        fail("text", "srl: crf_decoding tags differ between card and CPU")


def text_path(K, dev, card):
    """The text tier (PR 19), each part's launch counters zeroed before it
    and read after it: (a) the seqToseq group trained through
    ``recurrent_group`` at the WMT14 widths (K3r, K4 twice a step), one
    ``SGDTrainer.test`` pass (K3 twice), and its loss and gradients at
    B=2, f32, card vs CPU; (b) ``stacked_lstm_net`` and
    ``convolution_net`` at their defaults on synthetic sentiment (no
    kernel: relu LSTMs); (c) ``networks.bidirectional_lstm`` at
    lstm_b64h256's shape (K9r, K10 twice a step) and one inference pass
    (K9 twice); (d) ``db_lstm_net`` at the SRL demo's defaults on
    synthetic conll05_features with ``crf_cost`` (no kernel) and one
    ``crf_decoding`` pass, its tags on the card against the CPU's.  ->
    {part: launches}."""
    import torch

    parts = {}
    tr, out, _, _, parts["seqtoseq_group"] = text_train(
        K, dev, card, "seqtoseq_group",
        {"gru_forward": 2, "gru_backward": 2})
    feeds, _ = text_feeds("seqtoseq_group")
    K.reset_launch_counts()
    t0 = time.perf_counter()
    res = tr.test(lambda: iter(feeds[:1]))
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    parts["seqtoseq_group_test"] = K.launch_counts()
    print(f"text: seqtoseq_group SGDTrainer.test, one batch: "
          f"{sec * 1e3:.2f} ms, cost {res['cost']:.6f}, launches "
          f"{_launched(parts['seqtoseq_group_test'])} [{card}]",
          flush=True)
    _launch_check("text", "seqtoseq_group test",
                  parts["seqtoseq_group_test"], {"gru_forward": 2})
    del tr, out
    torch.cuda.empty_cache()
    text_cpu_check(dev, "seqtoseq_group", 2)
    torch.cuda.empty_cache()
    for part in ("sentiment", "convolution"):
        tr, *_, parts[part] = text_train(K, dev, card, part, {})
        del tr
    tr, out, *_, parts["bidi_lstm"] = text_train(
        K, dev, card, "bidi_lstm", {"lstm_forward": 2, "lstm_backward": 2})
    _, parts["bidi_lstm_infer"] = text_infer(
        K, card, tr, out, text_feeds("bidi_lstm")[0][0], "bidi_lstm",
        {"lstm_forward": 2})
    del tr, out
    torch.cuda.empty_cache()
    tr, decoded, *_, parts["srl"] = text_train(K, dev, card, "srl", {})
    feed = text_feeds("srl")[0][0]
    tags, parts["srl_decode"] = text_infer(K, card, tr, decoded, feed,
                                           "srl crf_decoding", {})
    if tags.dtype != torch.int32 or int(tags.max()) >= SRL_LABELS:
        fail("text", f"srl: malformed tags {tags.dtype}, max "
             f"{int(tags.max())}")
    text_decode_check(tr, decoded, feed)
    del tr
    torch.cuda.empty_cache()
    return parts


#: the kernels line's rows that the text phase's parts launch, by part
TEXT_ROWS = {
    "gru_forward": ("seqtoseq_group_test",),
    "gru_forward_residuals": ("seqtoseq_group",),
    "gru_backward": ("seqtoseq_group",),
    "lstm_forward": ("bidi_lstm_infer",),
    "lstm_forward_residuals_b64h256": ("bidi_lstm",),
    "lstm_backward_b64h256": ("bidi_lstm",),
}


# ---------------------------------------------------------------------------
# phase 14: the sparse and sampled-cost tier
# ---------------------------------------------------------------------------


def sparse_nets():
    """``tests/torch_sparse_nets.py``, the demos' nets for either DSL."""
    if os.path.join(ROOT, "tests") not in sys.path:
        sys.path.insert(0, os.path.join(ROOT, "tests"))
    import torch_sparse_nets

    return torch_sparse_nets


def sparse_feeds(part: str, B: int, steps: int = SPARSE_STEPS):
    """``steps`` batches of ``part``'s feed (numpy, through ``DataFeeder``
    as the demos feed them, or seeded for ctc) and, for the ``sparse_grad``
    parts, each batch's table rows: {table: ids the batch looks up}."""
    import numpy as np

    import paddle_tpu_torch.data as data

    N = sparse_nets()
    if part == "ctc":
        rs = np.random.RandomState(SEED)
        feeds = []
        for _ in range(steps):
            in_len = rs.randint(CTC_IN_LEN[0], CTC_IN_LEN[1] + 1, B)
            lab_len = rs.randint(CTC_LAB_LEN[0], CTC_LAB_LEN[1] + 1, B)
            feeds.append({
                "feats": (rs.randn(B, CTC_T, CTC_IN).astype(np.float32),
                          in_len.astype(np.int32)),
                "labels": (rs.randint(0, CTC_CLASSES - 1,
                                      (B, CTC_LAB_LEN[1])).astype(np.int32),
                           lab_len.astype(np.int32))})
        return feeds, [{} for _ in feeds]
    n = B * steps
    if part == "movielens_features":
        feeder = data.DataFeeder(N.MOVIELENS_FEATURE_TYPES)
        reader = data.datasets.movielens_features("train", n=n)
    elif part == "movielens_sparse_grad":
        feeder = data.DataFeeder({"user_id": "int", "movie_id": "int",
                                  "score": "dense"})
        reader = data.map_readers(lambda r: (r[0], r[1], [r[2]]),
                                  data.datasets.movielens("train", n=n))
    elif part == "sparse_lr":
        feeder = data.DataFeeder({"words": "sparse_ids", "label": "int"})
        reader = data.datasets.imdb("train", vocab_size=LR_VOCAB, n=n)
    else:
        feeder = data.DataFeeder(N.ngram_feeder_types(W2V_NGRAM))
        reader = data.datasets.imikolov("train", vocab_size=W2V_VOCAB,
                                        ngram=W2V_NGRAM, n=n)
    feeds = [feeder(b) for b in data.batch(reader, B)()]
    rows = []
    for f in feeds:
        if part == "movielens_sparse_grad":
            rows.append({"_user_emb.w0": np.unique(f["user_id"]),
                         "_movie_emb.w0": np.unique(f["movie_id"])})
        elif part == "sparse_lr":
            ids, nnz = f["words"]
            rows.append({"lr_w": np.unique(np.concatenate(
                [r[:k] for r, k in zip(ids, nnz)]))})
        else:
            rows.append({})
    return feeds, rows


def sparse_cost(part: str):
    """``part``'s net with the port's DSL at its widths -> (cost, its
    optimizer)."""
    import paddle_tpu_torch.models as models
    import paddle_tpu_torch.nn as nn
    from paddle_tpu_torch.param import AdaGrad, Adam

    N = sparse_nets()
    nn.reset_naming()
    if part == "movielens_features":
        return models.movielens_feature_net()[0], Adam(learning_rate=REC_LR)
    if part == "movielens_sparse_grad":
        return (models.movielens_net(sparse_grad=True)[0],
                Adam(learning_rate=REC_LR))
    if part == "sparse_lr":
        return N.sparse_lr_net(nn, LR_VOCAB)[0], Adam(learning_rate=LR_LR)
    if part == "ctc":
        return (N.ctc_net(nn, CTC_IN, CTC_HID, CTC_CLASSES)[0],
                Adam(learning_rate=TEXT_LR))
    return (N.ngram_net(nn, W2V_VOCAB, W2V_EMB, W2V_HID, W2V_NGRAM,
                        part.split("_")[1]), AdaGrad(learning_rate=W2V_LR))


def _untouched_rows_check(tr, part: str, table: str, rows, before):
    """The rows of ``table`` the batch did not look up equal their values
    and slots before the step, bit for bit -> the untouched count."""
    import torch

    from paddle_tpu_torch.param.optimizers import slot_leaves

    untouched = torch.ones(tr.params[table].shape[0], dtype=torch.bool,
                           device=tr.device)
    untouched[torch.as_tensor(rows, device=tr.device).long()] = False
    now = [tr.params[table].detach()] + slot_leaves(
        tr.opt_state["slots"][table])
    for new, old in zip(now, before):
        if not torch.equal(new[untouched], old[untouched]):
            fail("sparse", f"{part}: an untouched row of {table} or of its "
                 f"slots changed")
    if torch.equal(now[0][~untouched], before[0][~untouched]):
        fail("sparse", f"{part}: no looked-up row of {table} moved")
    return int(untouched.sum())


def sparse_train(K, dev, card, part: str, B: int, want: dict):
    """SPARSE_STEPS ``SGDTrainer.train_batch`` steps of ``part`` at bf16:
    losses, the median step of steps 2-N, samples/s, peak memory; for a
    ``sparse_grad`` part each step's untouched-row check (outside the
    timed step).  ``want`` maps each kernel that must launch to its
    launches a step (all ``persistent``); every other count must stay 0.
    -> (trainer, launches)."""
    import numpy as np
    import torch

    from paddle_tpu_torch.param.optimizers import slot_leaves
    from paddle_tpu_torch.trainer import SGDTrainer

    cost, opt = sparse_cost(part)
    feeds, rows = sparse_feeds(part, B)
    tr = SGDTrainer(cost, opt, seed=SEED, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    losses, secs, untouched = [], [], {}
    K.reset_launch_counts()
    for feed, touched in zip(feeds, rows):
        before = {t: [v.detach().clone() for v in [tr.params[t]]
                      + slot_leaves(tr.opt_state["slots"][t])]
                  for t in touched}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(tr.train_batch(feed).item())     # synchronises
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        for t, ids in touched.items():
            untouched.setdefault(t, []).append(
                _untouched_rows_check(tr, part, t, ids, before[t]))
    launches = K.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    steps = len(feeds)
    rest = sorted(secs[1:])
    sec = rest[len(rest) // 2]
    print(f"sparse: {part} losses {[round(x, 6) for x in losses]}",
          flush=True)
    print(f"sparse: {part} SGDTrainer({type(tr.optimizer).__name__}("
          f"{tr.optimizer.learning_rate})) x {steps}, B={B}, bf16: first "
          f"step {secs[0]:.3f} s, median of steps 2-{steps} "
          f"{sec * 1e3:.2f} ms/step (min {rest[0] * 1e3:.2f}, max "
          f"{rest[-1] * 1e3:.2f}), {B / sec:.1f} samples/s, peak memory "
          f"{peak / 2 ** 30:.2f} GiB, launches {_launched(launches)} "
          f"[{card}]", flush=True)
    for t, counts in untouched.items():
        print(f"sparse: {part} {t}: its untouched rows held bit for bit "
              f"(value and {type(tr.optimizer).__name__} slots) after "
              f"every step: {counts} of {tr.params[t].shape[0]} rows",
              flush=True)
    if not all(np.isfinite(losses)):
        fail("sparse", f"{part}: loss not finite: {losses}")
    if int(tr.opt_state["step"]) != steps or tr.bad_steps_total:
        fail("sparse", f"{part}: step counter "
             f"{int(tr.opt_state['step'])}, bad steps {tr.bad_steps_total}")
    _launch_check("sparse", part, launches,
                  {k: n * steps for k, n in want.items()})
    return tr, launches


@contextlib.contextmanager
def cpu_noise_draws():
    """The port's ``uniform_classes`` drawn by the CPU generator and moved
    to the device: so NCE draws the same noise classes on the card as on
    the CPU (their generators draw different numbers)."""
    import paddle_tpu_torch.ops as O

    real = O.uniform_classes
    O.uniform_classes = lambda gen, shape, C, device: real(
        gen, shape, C, "cpu").to(device)
    try:
        yield
    finally:
        O.uniform_classes = real


def sparse_cpu_check(dev, part: str, B: int):
    """``part``'s net at full width with B rows of its first batch, f32:
    the loss and every gradient on the card against the CPU from the same
    parameters (every all-zero one set to seeded normals), NCE's noise
    drawn on the CPU for both."""
    import numpy as np
    import torch

    import paddle_tpu_torch.nn as nn
    from paddle_tpu_torch.ops.numerics import compute_dtype_scope

    cost, _ = sparse_cost(part)
    feed = {k: tuple(a[:B] for a in v) if isinstance(v, tuple) else v[:B]
            for k, v in sparse_feeds(part, B, 1)[0][0].items()}
    card, cpu = (nn.Topology(cost, device=d) for d in (dev, "cpu"))
    params, _ = cpu.init(SEED + 1)
    rng = np.random.RandomState(SEED + 1)
    params = {k: v if v.abs().max() > 0 else torch.from_numpy(
        (0.3 * rng.randn(*v.shape)).astype(np.float32))
        for k, v in params.items()}
    out = {}
    with compute_dtype_scope("float32"), cpu_noise_draws():
        for name, topo, dv in (("card", card, dev), ("cpu", cpu, "cpu")):
            p = {k: v.to(dv).requires_grad_() for k, v in params.items()}
            loss = topo.apply(p, {}, feed, train=True,
                              rng=SEED)[0][cost.name].value
            grads = torch.autograd.grad(loss, list(p.values()))
            out[name] = (loss.item(), [g.cpu() for g in grads])
    d_loss = abs(out["card"][0] - out["cpu"][0]) / abs(out["cpu"][0])
    worst, worst_name = 0.0, ""
    for name, a, c in zip(params, out["card"][1], out["cpu"][1]):
        rel = (a - c).abs().max().item() / max(c.abs().max().item(), 1e-30)
        if rel > worst:
            worst, worst_name = rel, name
    print(f"sparse: {part} card vs CPU, B={B}, f32: loss "
          f"{out['card'][0]:.7f} vs {out['cpu'][0]:.7f} (rel diff "
          f"{d_loss:.3e}, tol {TOL_SPARSE_LOSS}); {len(params)} gradients, "
          f"worst max |diff| / max |g| {worst:.3e} ({worst_name}, tol "
          f"{TOL_SPARSE_GRAD})", flush=True)
    if not (np.isfinite(out["cpu"][0]) and d_loss <= TOL_SPARSE_LOSS
            and worst <= TOL_SPARSE_GRAD):
        fail("sparse", f"{part}: card and CPU disagree beyond tolerance")


def sparse_path(K, dev, card):
    """The sparse and sampled-cost tier, each part's launch
    counters zeroed before it and read after it: (a) recommender,
    ``movielens_feature_net`` at its defaults on ``movielens_features``
    (sparse-binary categories), then ``movielens_net(sparse_grad=True)``
    with its untouched rows held; (b) sparse_lr, the quick_start demo's LR
    over a sparse bag of words, its ``lr_w`` rows held likewise; (c)
    word2vec, the n-gram net with ``hsigmoid_cost`` and with
    ``nce_cost``: no kernel in (a)-(c); (d) ctc, the golden ctc net at
    lstm_b64h256's shape (K9r and K10 once a step, persistent) and one
    ``SGDTrainer.test`` batch (K9 once).  Then (a), (c) and (d) at
    B=SPARSE_CHECK_B, f32, card vs CPU.  -> {part: launches}."""
    import torch

    parts = {}
    for part, B in (("movielens_features", REC_B),
                    ("movielens_sparse_grad", REC_B),
                    ("sparse_lr", LR_B), ("word2vec_hsigmoid", W2V_B),
                    ("word2vec_nce", W2V_B)):
        tr, parts[part] = sparse_train(K, dev, card, part, B, {})
        del tr
        torch.cuda.empty_cache()
    tr, parts["ctc"] = sparse_train(K, dev, card, "ctc", CTC_B,
                                    {"lstm_forward": 1, "lstm_backward": 1})
    feeds, _ = sparse_feeds("ctc", CTC_B, 1)
    K.reset_launch_counts()
    t0 = time.perf_counter()
    res = tr.test(lambda: iter(feeds))
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    parts["ctc_test"] = K.launch_counts()
    print(f"sparse: ctc SGDTrainer.test, one batch: {sec * 1e3:.2f} ms, "
          f"cost {res['cost']:.6f}, launches "
          f"{_launched(parts['ctc_test'])} [{card}]", flush=True)
    if not math.isfinite(res["cost"]):
        fail("sparse", f"ctc: test cost {res['cost']}")
    _launch_check("sparse", "ctc test", parts["ctc_test"],
                  {"lstm_forward": 1})
    del tr
    torch.cuda.empty_cache()
    for part in ("movielens_features", "movielens_sparse_grad",
                 "word2vec_hsigmoid", "word2vec_nce", "ctc"):
        sparse_cpu_check(dev, part, SPARSE_CHECK_B)
    torch.cuda.empty_cache()
    return parts


#: the kernels line's rows that the sparse phase's ctc part launches
SPARSE_ROWS = {
    "lstm_forward": ("ctc_test",),
    "lstm_forward_residuals_b64h256": ("ctc",),
    "lstm_backward_b64h256": ("ctc",),
}


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
        k7_wide = check_topk_wide(K, flush, dev, card)
        rows += check_gru_train(K, flush, dev)
        rows += check_bigru(K, flush, dev)
        rows += check_ce(K, flush, dev)
        rows.append(check_lse(K, flush, dev))
        rows += check_attn_dec(K, flush, dev)
        rows += check_lstm(K, flush, dev)
        rows.append(check_topk_logits(K, flush, dev))
        phase = "products"
        check_products(flush, dev)
        del flush
        torch.cuda.empty_cache()
        phase = "serve"
        serve_launches, serve_fused_launches, served = serve_path(K, dev)
        phase = "server"
        server_launches = server_path(K, dev, served)
        phase = "spec"
        spec_launches, spec_wide_steps = spec_path(K, dev, served, card)
        del served
        torch.cuda.empty_cache()
        phase = "train"
        train_launches = train_ab(K, dev)
        train_cpu_check(K, dev)
        train_cpu_check(K, dev, "both")
        torch.cuda.empty_cache()
        phase = "textclf"
        textclf, infer_launches, textclf_run = {}, {}, {}
        for hidden in TEXTCLF_HIDDEN:
            (launches, topo, params, state, feed,
             *textclf_run[hidden]) = textclf_train(K, dev, hidden)
            textclf[hidden] = launches
            infer_launches[hidden] = textclf_infer(K, topo, params, state,
                                                   feed, hidden)
            del topo, params, state
            torch.cuda.empty_cache()
        textclf_cpu_check(dev)
        torch.cuda.empty_cache()
        phase = "dslgen"
        dslgen_launches, dslgen_params = dslgen_path(K, dev)
        dslgen_cpu_check(dev, dslgen_params)
        del dslgen_params
        torch.cuda.empty_cache()
        phase = "trainer"
        trainer_launches = trainer_path(K, dev, card, *textclf_run[256])
        torch.cuda.empty_cache()
        phase = "vision"
        vision_path(K, dev, card)
        torch.cuda.empty_cache()
        phase = "text"
        text_launches = text_path(K, dev, card)
        torch.cuda.empty_cache()
        phase = "sparse"
        sparse_launches = sparse_path(K, dev, card)
    except SystemExit:
        raise
    except Exception:  # noqa: BLE001 — report the phase and fail
        traceback.print_exc()
        fail(phase, "raised")
    # each row's launches come from the path that runs it: K3 inference and
    # K7 from serving; K3 with residuals, K4, K1, K2, K5 and K6 from
    # training (default configuration); K11 inference from serving with
    # fused_bigru, K11 with residuals and its reverse from training with
    # fused_bigru; K12 from training with the LSE readout; K9 inference
    # from the textclf inference pass at its width, K9 with residuals and
    # K10 from the textclf training run at the row's width; K8 from the DSL
    # generation run
    for row in rows:
        name = row["name"]
        if name == "bigru_forward":
            src, key = serve_fused_launches, name
        elif name in ("bigru_forward_residuals", "bigru_backward"):
            src, key = (train_launches["fused_bigru"],
                        name.replace("_residuals", ""))
        elif name == "logsumexp_rows":
            src, key = train_launches["lse_readout"], name
        elif name == "topk_lse_logits":
            src, key = dslgen_launches, name
        elif name in ("gru_forward", "topk_lse_readout"):
            src, key = serve_launches, name
        elif name == "gru_forward_residuals":
            src, key = train_launches["default"], "gru_forward"
        elif name == "lstm_forward":
            src, key = infer_launches[256], "lstm_forward"
        elif name == f"lstm_forward_b{TEXTCLF_B}h1280":
            src, key = infer_launches[1280], "lstm_forward"
        elif name.startswith("lstm_"):
            kernel, width = name.rsplit("_", 1)
            hidden = int(width.split("h")[1])
            src, key = textclf[hidden], (
                "lstm_forward" if kernel.startswith("lstm_forward")
                else "lstm_backward")
        else:
            src, key = train_launches["default"], name
        row["launches"] = src[key]
        row["launches_by_path"] = src.by_path[key]
        if name in TRAINER_ROWS:
            # the trainer phase's launches of the same library, each part
            # counted on its own (K9 and K9r share lstm_forward's count)
            row["trainer_launches"] = {
                part: counts[key] for part, counts in
                trainer_launches.items()}
            row["trainer_launches_by_path"] = {
                part: counts.by_path[key] for part, counts in
                trainer_launches.items()}
        if name in TEXT_ROWS:
            # the text phase's parts that launch this row's kernel
            row["text_launches"] = {
                part: text_launches[part][key] for part in TEXT_ROWS[name]}
            row["text_launches_by_path"] = {
                part: text_launches[part].by_path[key]
                for part in TEXT_ROWS[name]}
        if name in SPARSE_ROWS:
            # the sparse phase's ctc part launches this row's kernel
            row["sparse_launches"] = {
                part: sparse_launches[part][key]
                for part in SPARSE_ROWS[name]}
            row["sparse_launches_by_path"] = {
                part: sparse_launches[part].by_path[key]
                for part in SPARSE_ROWS[name]}
        if name == "topk_lse_readout":
            # the spec phase's full arm: one launch a table step, its wide
            # steps at N = 320
            row.update(k7_wide, spec_launches=spec_launches[name],
                       spec_launches_by_path=spec_launches.by_path[name],
                       spec_launches_n320=spec_wide_steps)
    # the server phase's launches as counted, by kernel library
    print(json.dumps({"server_launches": {
        part: {n: {"launches": c, "by_path": counts.by_path[n],
                   "by_thread": counts.by_thread[n]}
               for n, c in counts.items()}
        for part, counts in server_launches.items()}}), flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
