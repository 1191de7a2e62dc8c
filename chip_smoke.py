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
15. seqdata  nested and packed sequences and the sharded data pipeline,
            bf16 unless f32 is named, random weights from ``SEED``: (a)
            packing, ``bench.py:1479-1555``'s A/B at its shape:
            ``lstm_benchmark_net`` at lstm_b64h256's widths trained by
            ``SGDTrainer(Adam(1e-3)).train_batch`` x 4 on 64 rows of
            4096 pad-heavy samples (lengths clip(exp(24) + 4, 4, 128)),
            bucketed (``DataFeeder(max_len=128)``; K9r and K10 twice a
            step, all persistent) and packed (``pack_samples`` into rows
            of 128 tokens and 16 segments, ``PackedDataFeeder``; the reset
            LSTMs take the plain scan, no K9/K10), each with its losses,
            median step, samples/s, pad waste, busy share (one profiled
            step), peak memory and launches, then the packed/bucketed
            ratio; at f32 and the reference test's shape (8 samples, rows
            of 16 tokens, 4 segments) the packed loss and every gradient
            against the unpacked run (K9/K10's f32 path) on the card and
            against the CPU; (b) nested, a two-level LSTM classifier
            (``tests/torch_nested_nets.py::hier_lstm_net``, vocab 30000,
            emb 128, hid 256) over B=64 documents of 8 sentences of at
            most 16 tokens from the synthetic imdb stream, 4 steps (K9r
            and K10 once an outer step, persistent), one test batch (K9
            once an outer step), the nested group equal to the flat RNN
            at H=256, D=128 (f32) and the net at B=4 card vs CPU (f32);
            (c) datapipe: ``python -m paddle_tpu_torch data pack`` of the
            textclf config into 8 shards and ``data verify``, then
            ``SGDTrainer.train(ShardSource(...), num_passes=2)`` at
            lstm_b64h256 uninterrupted, preempted at pass 1 batch 2 and
            resumed with ``resume="auto"``: losses and parameters bit for
            bit, no batch replayed, exactly the remaining batches' records
            read; (d) ``--job=train --data_pack`` through the command
            line (finite losses, packing logged, no K10);
16. mixed    mixed precision, rematerialisation and the batch prefetcher:
            (a) ``bench.py:755-780``'s flagship step (B=384, S=T=32, 6
            Adam steps) without and with ``--amp`` in one process (ms a
            step each, K1-K6 launches by path), the --amp losses against
            the CPU's run of the same steps within ``TOL_MIXED_LOSS``; (b)
            ``lstm_benchmark_net`` at lstm_b64h256 through
            ``SGDTrainer(amp=True)`` beside the same steps without, then a
            batch whose gradient overflows (an inf injected into one
            gradient, the loss finite): skipped with parameters and slots
            held bit for bit, the scale halved, ``bad_steps_streak`` 0;
            then a clean batch trains; then ``--job=train --amp``; (c)
            bench row lstm_b512h256r: B=512 with ``remat=True`` beside
            ``remat=False`` (losses, ``torch.cuda.max_memory_allocated``,
            ms a step; K9r and K10 on their steps kernels, K9r twice a step
            under remat); the kernels phase holds K9r and K10 at that shape
            against their plain versions (its rows ``*_b512h256``); (d)
            ``--job=train --prefetch_depth=2`` against ``=0`` in turns
            (losses bit for bit, ms a step);
17. deploy   deploy bundles: ``lstm_benchmark_net`` at lstm_b64h256 (bf16)
            trained 3 ``SGDTrainer`` steps (K9r, K10), its inference graph
            ``Topology(logits)`` merged to an f32, a bf16 and an int8
            bundle (merge seconds, ``params.npz`` bytes, each gate's
            ``max_abs_err``; ``model.pb`` identical across the three); a
            truncated member named by ``BundleCorruptError``; ``python -m
            paddle_tpu_torch serve --serve_bundle=<f32> --serve_smoke=64``
            and ``serve --serve_continuous --serve_smoke=16`` in fresh
            processes (exit 0, seconds to the ready line, healthz; their
            launches after the ready line: K9 twice a batch, persistent,
            and nothing else; K3 and K7 and nothing else); each
            bundle loaded with no model code (every parameter on the card)
            and served by a bucket-mode ``InferenceServer`` (max_batch 8,
            warmup primes per bucket): a zero-row request replied empty
            with no launch, then 64 requests of 1-4 rows, lengths 20-100,
            submitted at once (requests/s, p50/p99 submit-to-answer ms), K9
            twice a batch, all persistent, only from the worker thread,
            nothing else; each reply equal to solo ``infer`` bit for bit;
            the f32 bundle's requests a second time under
            ``torch.profiler`` (busy share, K9's device ms a launch and a
            batch at the served shapes); each quantized bundle's loaded
            parameters within half a quantization step of the trained
            ones, and its served logits within the gate's tolerance of the
            f32 bundle's (printed beside their ``max_abs_err``); the f32
            bundle equal to the trained ``Topology.apply``; each bundle's
            served logits against the same bundle on the CPU within
            ``TOL_DEPLOY_CPU``;
18. frontdoor the user's entry points at the WMT14 widths (V=30000,
            E=H=D=A=512, bf16 policy): (a) the seqToseq demo copy through
            its ``main(argv)`` (``python -m paddle_tpu_torch.demo.seqToseq.
            train --batch-size 64 --dict-size 30000 --emb-dim 512 --hid-dim
            512 --n 256 --generate --beam-size 3``): 4 Adam steps (K3r and
            K4 twice, K5, K6, K1 and K2 once a step: persistent, wgmma)
            and beam 3 over 4 sources (K3 twice, K7 once a decode step,
            wgmma), nothing else launched; ms a step, target words/s;
            its first 2 steps and their generation on the card against the
            CPU at f32 (costs within ``TOL_TRAIN_LOSS``; ids identical or a
            near tie rescored within ``TOL_SEARCH``); the demo at ``--n
            128`` in a fresh process (exit 0, its cost lines); (b) the v2
            seqToseq script (``tests/torch_v2_seqtoseq.py``):
            ``paddle.init(["--device=cuda"])``, ``parameters.create``,
            ``trainer.SGD`` with Adam over 3 wmt14 batches of 64 (K3r and
            K4 twice a step, nothing else), ``save_parameter_to_tar``, the
            tar read back by ``from_tar`` in a fresh process on the CPU
            (every array bit for bit), the generator (beam 3, max_length
            32) from the tar through ``paddle.infer(field=['prob', 'id'])``
            on 8 sources (K3 twice, K8 once a decode step), a zero-row
            ``infer`` (empty shapes, no launch); the first step's cost and
            the generation on the card against the CPU at f32; (c) a
            ``{"frontdoor_launches": {...}}`` line by part, kernel and
            path, and the phase's seconds;
19. dataio   the data front door from files in the real on-disk formats,
            written by the phase into its own data home
            (``$PADDLE_TPU_DATA_HOME``; every other phase reads an empty
            one): ``native_available()`` (the C++ pad core, built with
            ``g++`` in the build phase; the compiler's version printed);
            (a) an ``aclImdb_v1.tar.gz`` (2048 train and 512 test reviews of
            50-300 words over 40000 distinct ones, seeded) read by the real
            branch of ``datasets.imdb(vocab_size=30000)`` through a
            PyDataProvider2 ``@provider`` (``integer_value_sequence(30000)``,
            ``integer_value(2)``, should_shuffle, pool 512,
            ``CACHE_PASS_IN_MEM``, ``random.Random(SEED)``) and its
            ``feeder(max_len=100)`` (native pad) into ``SGDTrainer(Adam(
            1e-3))`` on ``lstm_benchmark_net`` at lstm_b64h256 (bf16), 2
            passes (the second replays the cache) and a test pass: K9r and
            K10 twice a step, K9 twice a test batch, all persistent,
            nothing else; ms a step, samples/s, host seconds in the reader
            and provider and in the feeder against the steps', pad waste;
            the first 2 steps card vs CPU at f32 on the same shuffled
            batches (costs within ``TOL_TRAIN_LOSS``); (b) a ``wmt14.tgz``
            (30000-line src/trg dictionaries, 2048 train and 256 test pairs
            of 10-60 words, 8 a split with a side past 80 tokens): its rows
            through ``formats.iter_wmt14`` equal to the written pairs
            (ids, ``<s>``/``<e>`` framing, ``<unk>``, the long pairs
            dropped), then the seqToseq demo copy's ``main`` at phase 18's
            arguments over it (K1-K7 exactly as phase 18, nothing else;
            its first batch the written pairs); (c) a ``{"dataio_launches":
            {...}}`` line by part, kernel and path, and the phase's
            seconds;
20. delivery continuous delivery at lstm_b64h256 (bf16), every step
            journaled (``--obs_journal``): (a) ``SGDTrainer.train`` 2
            passes with ``--save_dir``, ``--scrub_every_s`` and
            ``--publish_every=1`` (versions 1 and 2, each primed into the
            publish dir's compile cache; K9r and K10 twice a step, K9 twice
            a bucket of each publish's warm step, nothing else), a pass
            not yet verified refused as ``pass_not_verified``, an int8
            publish through its gate; (b) a bucket-mode ``InferenceServer``
            booted from v1 (``load_published``, the publish dir's cache),
            8 closed-loop client threads over 192 requests (1-4 rows,
            lengths 20-100) while the ``HotSwapManager`` swaps in v2 and
            v3 (published during the load): zero dropped, failed or
            stranded, each reply bit-equal to the solo ``infer`` of the
            version that answered it, K9 twice a batch from the worker
            (persistent) and twice a bucket of each warm step, requests/s
            and p50/p99 with and without reloads, each swap's ms and the
            publish's seconds; a ``corrupt_publish`` v4 skipped, a
            NaN-poisoned v5 rolled back within probation; (c) ``serve
            --serve_watch --serve_smoke`` in fresh processes from a copy of
            the package with an empty ``_build/``: warm from the publish
            dir's cache (zero ``nvcc`` runs, each loaded library's smoke
            call passed), cold, and with the cache's entry corrupted (a
            logged miss and a rebuild), served rows equal to the in-process
            v3 rows, ready seconds side by side; (d) a ``ModelFleet`` over
            the f32 and int8 bundles with two tenants (``tenant_flood`` and
            ``poison_tenant`` leave the other's replies bit-equal with zero
            errors), a 10% canary killed by ``kill_canary(mode="nan")``
            rolled back with zero drops, a ``FleetRouter`` failing over a
            drained server, ``serve --serve_fleet --serve_smoke=16`` in a
            fresh process; (e) a ``{"delivery_launches": {...}}`` line and
            the phase's seconds;
21. parallel data parallelism and the pserver tier over
            ``torch.distributed``, in worlds of ranks started by the port's
            launcher (``parallel.launch_local``), both ranks of a world on
            this one card (so the times are not a scaling result): (a)
            ``python -m paddle_tpu_torch --job=train --config=tests/
            torch_textclf_conf.py --mesh_shape=2`` on 2 gloo ranks at
            lstm_b64h256 (global batch 64, 32 a rank, 6 steps), bf16 and
            f32: the ranks' final parameters bit-equal, the f32 world's
            losses and rank 0's checkpoint against the same command in this
            process at rtol 1e-5 (losses) and rtol 1e-4 / atol 1e-6
            (parameters), the bf16 world's largest relative errors
            printed, K9r and K10 twice a step on each rank (persistent
            under bf16); (b) the flagship through
            ``make_parallel_train_step`` at B=384, S=T=32 (192 rows a
            rank, 3 Adam steps, bf16) against the one-process step on rank
            0, K1-K6 launches by rank; (c) a world of 1 under NCCL:
            ``SGDTrainer(mesh=MeshConfig.of(data=1))`` bit-equal to
            ``SGDTrainer`` without a mesh (lstm_b64h256, 3 steps); (d)
            ``movielens_net(sparse_grad=True)`` at ML-1M's schema (6040
            users, 3952 movies, emb 64, hid 64), B=128, Adam, f32, on
            ``model=2`` over gloo: the gathered tables and slots against
            the one-process masked path on rank 0 (losses rtol 1e-6,
            tables and slots rtol 1e-6 / atol 1e-7), dirty rows exactly
            the touched rows; per rank the step ms, the gradient
            all-reduce and the lookup/push ms and bytes; any rank that
            exits non-zero or outlives its world's limit fails the phase;
22. a ``{"server_launches": {...}}`` line (each part of the server
   phase: every kernel library's launches, by kernel variant and by
   thread), a ``{"kernels": [...]}`` line (each kernel's launches on its
   path's run, also by kernel variant: ``launches_by_path``; the K9,
   K9r and K10 rows at b64h256 also by trainer part:
   ``trainer_launches``; the K3, K3r, K4, K9, K9r and K10 rows also by
   text part: ``text_launches``; the K9, K9r and K10 rows at b64h256 also
   by sparse part: ``sparse_launches``, and by seqdata part:
   ``seqdata_launches``; the rows phase 16 reaches also by its part:
   ``mixed_launches``, phase 17's: ``deploy_launches``, phase 18's:
   ``frontdoor_launches``, phase 19's: ``dataio_launches``, and phase
   20's: ``delivery_launches``, phase 21's, by part and rank:
   ``parallel_launches``), then
   the card line again, and last
   ``{"ok": true, "device": {...}}``.

Launch counters are zeroed just before each path (serve and its fused
re-run, each part of the server phase, each arm of the spec phase, each
training configuration, each textclf run, dslgen, each part of the
trainer phase, the vision phase, each part of the text, sparse,
seqdata, mixed, deploy, frontdoor, dataio and delivery phases, and each
rank of phase 21, whose counters start at 0 in a fresh process) is driven
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


# ---------------------------------------------------------------------------
# phase 15: nested and packed sequences and the sharded data pipeline
# ---------------------------------------------------------------------------

#: (a) bench.py:1479-1555's packing A/B: lstm_benchmark_net at
#: lstm_b64h256's widths (vocab 30000, emb 128, 2 LSTMs of 256), 4096
#: samples of clip(int(exponential(24) + 4), 4, 128) tokens from
#: RandomState(0), B=64 rows, packed rows of at most 128 tokens and 16
#: segments, 4 Adam(1e-3) steps an arm on its one feed
PACK_VOCAB, PACK_B, PACK_EMB, PACK_HID = 30000, 64, 128, 256
PACK_MAX_LEN, PACK_SEGMENTS, PACK_SAMPLES, SEQDATA_STEPS = 128, 16, 4096, 4
#: the f32 packed checks at tests/test_datapipe.py:489-530's shape: 8
#: samples of 2-8 tokens (vocab 40), rows of 16 tokens and 4 segments,
#: lstm_benchmark_net(emb 8, hid 16, 2 layers)
PACK_CHECK_VOCAB = 40
#: packed (the plain scan) against unpacked (K9/K10's f32 path) on the
#: card, and the packed card run against the CPU's: the loss (rel) and
#: each gradient's max |diff| against its largest entry; the same f32
#: math summed in another order (K9/K10's per-step products and the
#: scan's cuBLAS calls) over at most 16 steps
TOL_PACK_LOSS, TOL_PACK_GRAD = 1e-5, 1e-4
#: (b) the nested net: hier_lstm_net at vocab 30000, emb 128, hid 256,
#: B=64 documents of at most 8 sentences of at most 16 tokens cut from the
#: synthetic imdb stream (To = 8, Ti = 16)
NEST_VOCAB, NEST_EMB, NEST_HID, NEST_B, NEST_TO, NEST_TI = (30000, 128, 256,
                                                            64, 8, 16)
#: test_nested_equals_flat_rnn at H=256, D=128, B=64, To=8, Ti=16 (f32):
#: each outer output against the flat RNN's state at the end of its
#: sub-sequence (max abs; |h| < 1; the same products, in other calls,
#: over up to 128 dependent tanh steps)
TOL_NESTED_FLAT = 1e-5
#: (c) the shard set: the config's synthetic imdb samples, 8 shards, 4
#: batches of 64 a pass
SHARD_PASS_BATCHES, SHARD_COUNT = 4, 8


def _busy(step):
    """One ``step()`` under ``torch.profiler`` (CUDA activity) -> (device
    kernel ms, host ms, kernels)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        host = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and not e.is_user_annotation]
    return (sum(e.self_device_time_total for e in kernels) / 1e3,
            host * 1e3, sum(e.count for e in kernels))


def pack_samples_ab():
    """bench.py's pad-heavy samples."""
    import numpy as np

    rs = np.random.RandomState(0)
    lengths = np.clip((rs.exponential(24, PACK_SAMPLES) + 4).astype(int), 4,
                      PACK_MAX_LEN)
    return [(rs.randint(3, PACK_VOCAB, L).tolist(), int(rs.randint(0, 2)))
            for L in lengths]


def seqdata_arm(K, dev, card, arm: str, cost, feed, n_samples: int,
                waste: float, want: dict):
    """SEQDATA_STEPS ``SGDTrainer(cost, Adam(1e-3), seed=SEED).train_batch``
    steps on ``feed`` at bf16, then one profiled step: losses, median of
    steps 2-N, samples/s, pad waste, busy share, peak memory and launches
    (``want``: each kernel's launches a step, all persistent; no other).
    -> (launches, median step seconds)."""
    import numpy as np
    import torch

    from paddle_tpu_torch.param import Adam
    from paddle_tpu_torch.trainer import SGDTrainer

    tr = SGDTrainer(cost, Adam(learning_rate=1e-3), seed=SEED, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    K.reset_launch_counts()
    losses, secs = [], []
    for _ in range(SEQDATA_STEPS):
        t0 = time.perf_counter()
        losses.append(tr.train_batch(feed).item())     # synchronises
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    launches = K.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    dev_ms, host_ms, n_kernels = _busy(lambda: tr.train_batch(feed).item())
    rest = sorted(secs[1:])
    sec = rest[len(rest) // 2]
    print(f"seqdata: {arm} losses {[round(x, 6) for x in losses]}",
          flush=True)
    print(f"seqdata: {arm} SGDTrainer(Adam(1e-3)) x {SEQDATA_STEPS}, "
          f"{PACK_B} rows of {feed['words'][0].shape[1]} tokens, bf16: "
          f"first step {secs[0]:.3f} s, median of steps 2-{SEQDATA_STEPS} "
          f"{sec * 1e3:.2f} ms/step (min {rest[0] * 1e3:.2f}, max "
          f"{rest[-1] * 1e3:.2f}), {n_samples} samples a batch, "
          f"{n_samples / sec:.1f} samples/s, pad waste {waste:.4f}, busy "
          f"share {dev_ms / host_ms:.1%} (device kernel time "
          f"{dev_ms:.2f} ms of a {host_ms:.2f} ms profiled step, "
          f"{n_kernels} kernels), peak memory {peak / 2 ** 30:.2f} GiB, "
          f"launches {_launched(launches)} [{card}]", flush=True)
    if not all(np.isfinite(losses)):
        fail("seqdata", f"{arm}: loss not finite: {losses}")
    _launch_check("seqdata", arm, launches,
                  {k: n * SEQDATA_STEPS for k, n in want.items()})
    return launches, sec, tr


def _grads_against(dev, cost, params, feeds, what: str, tol_loss: float,
                   tol_grad: float):
    """The loss and every gradient of ``cost`` at f32 for each (label,
    device, feed) of ``feeds`` from the same parameters; each held against
    the first."""
    import numpy as np
    import torch

    import paddle_tpu_torch.nn as nn
    from paddle_tpu_torch.ops.numerics import compute_dtype_scope

    out = []
    with compute_dtype_scope("float32"):
        for label, dv, feed in feeds:
            topo = nn.Topology(cost, device=dv)
            p = {k: v.to(dv).requires_grad_() for k, v in params.items()}
            loss = topo.apply(p, {}, feed, train=True)[0][cost.name].value
            grads = torch.autograd.grad(loss, list(p.values()))
            out.append((label, loss.item(), [g.cpu() for g in grads]))
    (l0, loss0, g0), ok = out[0], True
    for label, loss, g in out[1:]:
        d_loss = abs(loss - loss0) / abs(loss0)
        worst, worst_name = 0.0, ""
        for name, a, c in zip(params, g, g0):
            rel = (a - c).abs().max().item() / max(c.abs().max().item(),
                                                   1e-30)
            if rel > worst:
                worst, worst_name = rel, name
        print(f"seqdata: {what}: {label} vs {l0}, f32: loss {loss:.7f} vs "
              f"{loss0:.7f} (rel diff {d_loss:.3e}, tol {tol_loss}); "
              f"{len(params)} gradients, worst max |diff| / max |g| "
              f"{worst:.3e} ({worst_name}, tol {tol_grad})", flush=True)
        ok &= (np.isfinite(loss0) and d_loss <= tol_loss
               and worst <= tol_grad)
    if not ok:
        fail("seqdata", f"{what}: disagreement beyond tolerance")


def seqdata_packing(K, dev, card):
    """(a) bench.py's packing A/B at its shape, then the f32 packed checks
    on the card.  -> {part: launches}."""
    import numpy as np
    import torch

    import paddle_tpu_torch.nn as nn
    from paddle_tpu_torch.data import DataFeeder
    from paddle_tpu_torch.datapipe import PackedDataFeeder, pack_samples
    from paddle_tpu_torch.models import lstm_benchmark_net

    types = {"words": "ids_seq", "label": "int"}
    samples = pack_samples_ab()
    parts, secs, rates = {}, {}, {}
    feeder = DataFeeder(types, max_len=PACK_MAX_LEN)
    rows = pack_samples(samples, max_len=PACK_MAX_LEN,
                        max_segments=PACK_SEGMENTS)[:PACK_B]
    pfeeder = PackedDataFeeder(types, max_segments=PACK_SEGMENTS)
    arms = {"bucketed": (feeder(samples[:PACK_B]), PACK_B, feeder,
                         {"lstm_forward": 2, "lstm_backward": 2}),
            "packed": (pfeeder(rows), sum(len(r[0]) for r in rows), pfeeder,
                       {})}
    for arm, (feed, n, fd, want) in arms.items():
        nn.reset_naming()
        cost, _ = lstm_benchmark_net(PACK_VOCAB, emb_dim=PACK_EMB,
                                     hid_dim=PACK_HID, num_layers=2)
        parts[arm], secs[arm], tr = seqdata_arm(
            K, dev, card, arm, cost, feed, n, fd.pad_waste, want)
        rates[arm] = n / secs[arm]
        del tr
        torch.cuda.empty_cache()
    print(f"seqdata: packing A/B (lstm_b{PACK_B}h{PACK_HID}, lengths ~ "
          f"exp(24) + 4 <= {PACK_MAX_LEN}, {PACK_SEGMENTS} segments a row): "
          f"packed {rates['packed']:.1f} samples/s "
          f"({arms['packed'][1]} samples a batch, pad waste "
          f"{pfeeder.pad_waste:.4f}) vs bucketed {rates['bucketed']:.1f} "
          f"(pad waste {feeder.pad_waste:.4f}): packed/bucketed "
          f"{rates['packed'] / rates['bucketed']:.3f}x [{card}]",
          flush=True)

    # f32 at the reference test's shape: packed (the scan) against the
    # unpacked oracle (K9/K10's f32 path) on the card, and against the CPU
    rs = np.random.RandomState(1)
    small = [(rs.randint(1, PACK_CHECK_VOCAB, rs.randint(2, 9)).tolist(),
              int(rs.randint(0, 2))) for _ in range(8)]
    nn.reset_naming()
    cost, _ = lstm_benchmark_net(PACK_CHECK_VOCAB, emb_dim=8, hid_dim=16,
                                 num_layers=2)
    params, _ = nn.Topology(cost, device="cpu").init(SEED + 1)
    rng = np.random.RandomState(SEED + 1)
    params = {k: v if v.abs().max() > 0 else torch.from_numpy(
        (0.3 * rng.randn(*v.shape)).astype(np.float32))
        for k, v in params.items()}
    feed_u = DataFeeder(types)(small)
    feed_p = PackedDataFeeder(types, max_segments=4)(
        pack_samples(small, max_len=16, max_segments=4))
    K.reset_launch_counts()
    _grads_against(dev, cost, params,
                   [("unpacked on the card", dev, feed_u),
                    ("packed on the card", dev, feed_p)],
                   "packed vs unpacked lstm_benchmark_net", TOL_PACK_LOSS,
                   TOL_PACK_GRAD)
    got = K.launch_counts()
    if got["lstm_forward"] != 2 or got["lstm_backward"] != 2:
        fail("seqdata", f"f32 packed check launches {dict(got)}: want K9r "
             f"and K10 twice (the unpacked side) and none packed")
    _grads_against(dev, cost, params,
                   [("packed on the CPU", "cpu", feed_p),
                    ("packed on the card", dev, feed_p)],
                   "packed lstm_benchmark_net card vs CPU", TOL_PACK_LOSS,
                   TOL_PACK_GRAD)
    return parts


def nested_nets():
    """``tests/torch_nested_nets.py``, the package-agnostic nested builders
    the CPU and card tests share."""
    if os.path.join(ROOT, "tests") not in sys.path:
        sys.path.insert(0, os.path.join(ROOT, "tests"))
    import torch_nested_nets

    return torch_nested_nets


def seqdata_nested_feeds(B: int, steps: int):
    """``steps`` batches of B documents cut from the synthetic imdb stream,
    fed as nested ids."""
    import paddle_tpu_torch.data as data

    nested_samples = nested_nets().nested_samples
    feeder = data.DataFeeder({"words": "ids_nested", "label": "int"})
    flat = list(data.datasets.imdb("train", vocab_size=NEST_VOCAB,
                                   n=B * steps)())
    docs = nested_samples(flat, NEST_TO, NEST_TI)
    return [feeder(docs[i:i + B]) for i in range(0, len(docs), B)]


def seqdata_nested(K, dev, card):
    """(b) the two-level LSTM classifier: 4 steps (K9r and K10 once an
    outer step), one test batch (K9 once an outer step); the nested-equals-
    flat check at full width and the net at B=4 card vs CPU, f32.  ->
    {part: launches}."""
    import numpy as np
    import torch

    import paddle_tpu_torch.nn as nn
    from paddle_tpu_torch.ops.numerics import compute_dtype_scope
    from paddle_tpu_torch.param import Adam
    from paddle_tpu_torch.trainer import SGDTrainer

    flat_rnn_inputs = nested_nets().flat_rnn_inputs
    hier_lstm_net = nested_nets().hier_lstm_net
    feeds = seqdata_nested_feeds(NEST_B, SEQDATA_STEPS)
    To, Ti = feeds[0]["words"][0].shape[1:]
    if (To, Ti) != (NEST_TO, NEST_TI):
        fail("seqdata", f"nested feed is To={To}, Ti={Ti}")
    nn.reset_naming()
    cost, _ = hier_lstm_net(nn, NEST_VOCAB, NEST_EMB, NEST_HID)
    parts = {}
    tr = SGDTrainer(cost, Adam(learning_rate=1e-3), seed=SEED, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    K.reset_launch_counts()
    losses, secs = [], []
    for feed in feeds:
        t0 = time.perf_counter()
        losses.append(tr.train_batch(feed).item())
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    parts["nested"] = launches = K.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    dev_ms, host_ms, n_kernels = _busy(
        lambda: tr.train_batch(feeds[0]).item())
    rest = sorted(secs[1:])
    sec = rest[len(rest) // 2]
    tokens = np.mean([int(f["words"][2].sum()) for f in feeds[1:]])
    print(f"seqdata: nested losses {[round(x, 6) for x in losses]}",
          flush=True)
    print(f"seqdata: nested hier_lstm_net (vocab {NEST_VOCAB}, emb "
          f"{NEST_EMB}, hid {NEST_HID}) SGDTrainer(Adam(1e-3)) x "
          f"{SEQDATA_STEPS}, B={NEST_B} documents, To={To} x Ti={Ti}, bf16: "
          f"first step {secs[0]:.3f} s, median of steps 2-{SEQDATA_STEPS} "
          f"{sec * 1e3:.2f} ms/step (min {rest[0] * 1e3:.2f}, max "
          f"{rest[-1] * 1e3:.2f}), {NEST_B / sec:.1f} samples/s, "
          f"{tokens / sec:.1f} real tokens/s, busy share "
          f"{dev_ms / host_ms:.1%} (device kernel time {dev_ms:.2f} ms of a "
          f"{host_ms:.2f} ms profiled step, {n_kernels} kernels), peak "
          f"memory {peak / 2 ** 30:.2f} GiB, launches "
          f"{_launched(launches)} [{card}]", flush=True)
    if not all(np.isfinite(losses)):
        fail("seqdata", f"nested: loss not finite: {losses}")
    _launch_check("seqdata", "nested", launches,
                  {"lstm_forward": To * SEQDATA_STEPS,
                   "lstm_backward": To * SEQDATA_STEPS})
    K.reset_launch_counts()
    res = tr.test(lambda: iter(feeds[:1]))
    parts["nested_test"] = got = K.launch_counts()
    print(f"seqdata: nested SGDTrainer.test, one batch: cost "
          f"{res['cost']:.6f}, launches {_launched(got)}", flush=True)
    if not math.isfinite(res["cost"]):
        fail("seqdata", f"nested test cost {res['cost']}")
    _launch_check("seqdata", "nested test", got, {"lstm_forward": To})
    del tr
    torch.cuda.empty_cache()

    # test_nested_equals_flat_rnn at full width, f32
    H, D = NEST_HID, NEST_EMB
    vals, outer, sub, flat, flat_len = flat_rnn_inputs(
        np.random.RandomState(SEED), NEST_B, NEST_TO, NEST_TI, D,
        empty_frame=False)

    def nested_net():
        x = nn.data("x", size=D, is_seq=True, nested=True)

        def outer_step(frame, outer_mem):
            def inner_step(tok, inner_mem):
                s = nn.fc([tok, inner_mem], H, act="tanh", name="cell",
                          bias_attr=False)
                return [s, s]

            states = nn.recurrent_group(
                inner_step, [frame], [nn.Memory("im", H, boot=outer_mem)],
                name="inner")
            last = nn.last_seq(states, name="last")
            return [last, last]

        return nn.recurrent_group(outer_step, [x], [nn.Memory("om", H)],
                                  name="outer")

    def flat_net():
        x = nn.data("x", size=D, is_seq=True)

        def step(tok, mem):
            s = nn.fc([tok, mem], H, act="tanh", name="cell",
                      bias_attr=False)
            return [s, s]

        return nn.recurrent_group(step, [x], [nn.Memory("m", H)],
                                  name="flat")

    with compute_dtype_scope("float32"), torch.no_grad():
        nn.reset_naming()
        n_out = nested_net()
        topo = nn.Topology(n_out, device=dev)
        params, _ = topo.init(SEED)
        got = topo.apply(params, {}, {"x": (vals, outer, sub)})[0][
            n_out.name].value.cpu().numpy()
        nn.reset_naming()
        f_out = flat_net()
        want = nn.Topology(f_out, device=dev).apply(
            params, {}, {"x": (flat, flat_len)})[0][f_out.name].value
        want = want.cpu().numpy()
    worst = 0.0
    for b in range(NEST_B):
        for j, t in enumerate(np.cumsum(sub[b, :outer[b]])):
            worst = max(worst, float(np.abs(got[b, j] - want[b, t - 1])
                                     .max()))
    print(f"seqdata: nested == flat RNN (H={H}, D={D}, B={NEST_B}, To="
          f"{NEST_TO}, Ti={NEST_TI}, f32, on the card): each outer output "
          f"against the flat state at its sub-sequence's end, max |diff| "
          f"{worst:.3e} (tol {TOL_NESTED_FLAT})", flush=True)
    if worst > TOL_NESTED_FLAT:
        fail("seqdata", "nested group differs from the flat RNN")

    # the hierarchical net at B=4, f32, card vs CPU
    nn.reset_naming()
    cost, _ = hier_lstm_net(nn, NEST_VOCAB, NEST_EMB, NEST_HID)
    params, _ = nn.Topology(cost, device="cpu").init(SEED + 2)
    rng = np.random.RandomState(SEED + 2)
    params = {k: v if v.abs().max() > 0 else torch.from_numpy(
        (0.3 * rng.randn(*v.shape)).astype(np.float32))
        for k, v in params.items()}
    feed = {k: tuple(a[:4] for a in v) if isinstance(v, tuple) else v[:4]
            for k, v in feeds[0].items()}
    _grads_against(dev, cost, params, [("the CPU", "cpu", feed),
                                       ("the card", dev, feed)],
                   "hier_lstm_net at B=4", TOL_PACK_LOSS, TOL_PACK_GRAD)
    return parts


def seqdata_datapipe(K, dev, card):
    """(c) ``data pack`` of the textclf config into 8 shards and ``data
    verify``; then ``SGDTrainer.train(ShardSource(...), num_passes=2)``
    at lstm_b64h256 uninterrupted, preempted at pass 1 batch 2, and
    resumed with ``resume="auto"``: bit for bit, zero replay, exactly the
    remaining batches' records read.  -> {part: launches}."""
    import io
    import tempfile

    import torch

    import paddle_tpu_torch.data as data
    from paddle_tpu_torch.__main__ import main
    from paddle_tpu_torch.datapipe import ShardSource
    from paddle_tpu_torch.obs import get_registry
    from paddle_tpu_torch.param import Adam
    from paddle_tpu_torch.resilience import PreemptionHandler, chaos
    from paddle_tpu_torch.trainer import SGDTrainer, events as ev
    from paddle_tpu_torch.utils.flags import FLAGS

    parts = {}
    n = TEXTCLF_B * SHARD_PASS_BATCHES
    feeder = data.DataFeeder({"words": "ids_seq", "label": "int"},
                             buckets=(TEXTCLF_T,), max_len=TEXTCLF_T)
    reads = get_registry().counter("data_shard_records_total",
                                   "records decoded from shard files")
    with tempfile.TemporaryDirectory() as tmp, cli_run(n):
        root = os.path.join(tmp, "imdb")
        for argv in (["pack", root, "--config", TRAINER_CONF, "--shards",
                      str(SHARD_COUNT)], ["verify", root]):
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                rc = main(["data", *argv])
            print(f"seqdata: python -m paddle_tpu_torch data "
                  f"{' '.join(argv[:1])}: exit {rc}: "
                  f"{out.getvalue().strip()}", flush=True)
            if rc != 0:
                fail("seqdata", f"data {argv[0]} exited {rc}")

        def run(tag, save_dir, **kw):
            losses = {}

            def rec(e):
                if isinstance(e, ev.EndIteration):
                    losses[(e.pass_id, e.batch_id)] = float(e.cost)

            handler = kw.pop("handler", None)
            FLAGS.save_dir, FLAGS.log_period = save_dir, 0
            _, cost = textclf_net(256, dev)
            tr = SGDTrainer(cost, Adam(learning_rate=1e-3), seed=SEED,
                            device=dev)
            K.reset_launch_counts()
            before = reads.value
            t0 = time.perf_counter()
            tr.train(ShardSource(root, batch_size=TEXTCLF_B, seed=3),
                     num_passes=2, feeder=feeder,
                     event_handler=handler(rec) if handler else rec, **kw)
            torch.cuda.synchronize()
            parts[tag] = K.launch_counts()
            print(f"seqdata: ShardSource {tag}: {time.perf_counter() - t0:.2f}"
                  f" s, {len(losses)} steps, {int(reads.value - before)} records "
                  f"read, replayed batches {tr.resume_replayed_batches}, "
                  f"launches {_launched(parts[tag])}", flush=True)
            return tr, losses, reads.value - before

        keep = FLAGS.as_dict()
        try:
            ref, ref_losses, _ = run("uninterrupted", "")
            ck = os.path.join(tmp, "ck")
            h = PreemptionHandler()
            tr1, part1, _ = run(
                "preempted", ck, preemption=h, resume="auto",
                handler=lambda rec: chaos.preempt_at(h, batch=2, pass_id=1,
                                                     inner=rec))
            tr2, part2, n_read = run("resumed", ck, resume="auto")
        finally:
            for k, v in keep.items():
                setattr(FLAGS, k, v)
    got = {**part1, **part2}
    same_losses = got == ref_losses
    same_params = all(torch.equal(tr2.params[k], ref.params[k])
                      for k in ref.params)
    remaining = SHARD_PASS_BATCHES - 3
    print(f"seqdata: cursor resume (preempted at pass 1 batch 2, next "
          f"batch 3): losses {'bit for bit' if same_losses else 'DIFFER'}"
          f", parameters {'bit for bit' if same_params else 'DIFFER'}, "
          f"replayed batches {tr2.resume_replayed_batches}, records read "
          f"on resume {int(n_read)} (want {remaining * TEXTCLF_B}) [{card}]",
          flush=True)
    if not (tr1.preempted and same_losses and same_params
            and tr2.resume_replayed_batches == 0
            and n_read == remaining * TEXTCLF_B):
        fail("seqdata", "the cursor resume is not bit for bit with zero "
             "replay")
    for tag in ("uninterrupted", "preempted", "resumed"):
        _all_persistent("seqdata", tag, parts[tag], TEXTCLF_KERNELS)
    return parts


def seqdata_cli(K, dev, card):
    """(d) ``python -m paddle_tpu_torch --job=train --data_pack`` on the
    textclf config, one pass of 3 source batches: finite losses, the log
    saying packing is on, no K9/K10 on the training steps."""
    import logging

    import numpy as np

    from paddle_tpu_torch.utils.log import logger

    lines = []
    handler = logging.Handler()
    handler.emit = lambda r: lines.append(r.getMessage())
    logger.addHandler(handler)
    K.reset_launch_counts()
    try:
        with cli_run(TEXTCLF_B * 3), recorded_losses() as losses:
            t0 = time.perf_counter()
            cli(["--job=train", "--data_pack", "--num_passes=1"],
                phase="seqdata")
            sec = time.perf_counter() - t0
    finally:
        logger.removeHandler(handler)
    got = K.launch_counts()
    on = [m for m in lines if "sequence packing enabled" in m]
    print(f"seqdata: --job=train --data_pack, one pass: {sec:.2f} s, "
          f"losses {losses}, log {on[:1]}, launches {_launched(got)} "
          f"[{card}]", flush=True)
    if not losses or not all(np.isfinite(losses)) or not on:
        fail("seqdata", "--data_pack: losses not finite or packing not "
             "logged")
    if got["lstm_backward"]:
        fail("seqdata", f"--data_pack launched K10: {dict(got)}")
    return {"data_pack": got}


def seqdata_path(K, dev, card):
    """Nested and packed sequences and the sharded data pipeline, each
    part's launch counters zeroed before it and read after it: (a) the
    packing A/B, (b) the nested net, (c) the datapipe cursor resume, (d)
    ``--data_pack`` through the command line.  -> {part: launches}."""
    import torch

    parts = seqdata_packing(K, dev, card)
    torch.cuda.empty_cache()
    parts.update(seqdata_nested(K, dev, card))
    torch.cuda.empty_cache()
    parts.update(seqdata_datapipe(K, dev, card))
    torch.cuda.empty_cache()
    parts.update(seqdata_cli(K, dev, card))
    return parts


#: the kernels line's rows that the seqdata phase's parts launch
SEQDATA_ROWS = {
    "lstm_forward": ("nested_test",),
    "lstm_forward_residuals_b64h256": ("bucketed", "packed", "nested",
                                       "resumed"),
    "lstm_backward_b64h256": ("bucketed", "packed", "nested", "resumed"),
}


# ---------------------------------------------------------------------------
# phase 16: mixed precision, rematerialisation and the batch prefetcher
# ---------------------------------------------------------------------------

#: (b) the LSTM arm of the reference bench's amp A/B (bench.py:733-830):
#: lstm_benchmark_net at lstm_b64h256 through SGDTrainer(amp=True); (c)
#: bench row lstm_b512h256r (bench.py:2033-2034, :202-233): B=512 with
#: remat, beside the same step without; (d) --prefetch_depth=2 against 0
#: through the command line at lstm_b64h256, MIXED_PREFETCH_BATCHES a pass
REMAT_B, MIXED_PREFETCH_BATCHES = 512, 20
#: (a) the flagship's 6 --amp losses on the card against the CPU's, same
#: initial parameters and batch (rel): the bf16 activations' float32 sums
#: run in another order there, so some round the other way by one bf16
#: ulp (2^-8 relative), and the loss is an f32 mean over 12288 tokens of
#: statistics of those activations; later steps also carry Adam updates
#: whose near-zero gradients may differ in sign
TOL_MIXED_LOSS = 2e-3
#: (c) remat against the plain step (rel), where not bit for bit: only a
#: step that is not run-to-run deterministic could move them, and then by
#: f32 sums taken in another order
TOL_REMAT_LOSS = 1e-5
MIXED_ROWS = ("lstm_forward_residuals_b512h256", "lstm_backward_b512h256")


@contextlib.contextmanager
def amp_policy(on: bool):
    """``FLAGS.amp`` set for a block and restored after."""
    from paddle_tpu_torch.utils.flags import FLAGS

    old = FLAGS.amp
    FLAGS.amp = on
    try:
        yield
    finally:
        FLAGS.amp = old


def mixed_flagship(K, dev, card):
    """(a) ``bench.py:755-780``'s ``seq2seq_step``: 6 Adam steps of the
    full-width flagship at B=384, S=T=32, without and with --amp (no loss
    scaling, as the reference's A/B), from the same parameters and batch
    in one process; the --amp steps again on the CPU (the plain versions)
    from the same start.  -> the --amp run's launches."""
    import numpy as np
    import torch

    from paddle_tpu_torch.models import Seq2SeqAttention
    from paddle_tpu_torch.param import Adam

    def run(model, start, batch, amp: bool, where):
        params = {k: v.to(where).clone().requires_grad_()
                  for k, v in start.items()}
        opt = Adam(learning_rate=1e-3)
        state = opt.init_state(params)
        losses, secs = [], []
        with amp_policy(amp):
            for _ in range(TRAIN_STEPS):
                t0 = time.perf_counter()
                loss = model.loss(params, batch)
                grads = torch.autograd.grad(loss, list(params.values()))
                opt.update(params, dict(zip(params, grads)), state)
                losses.append(loss.item())
                if where != "cpu":
                    torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
        return losses, secs

    model = Seq2SeqAttention(device=dev)
    start = {k: v.detach() for k, v in model.init(seed=SEED).items()}
    batch = train_batch(np.random.RandomState(SEED), model, TRAIN_B,
                        TRAIN_S, TRAIN_T, mixed=False)
    res = {}
    for amp in (False, True):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        K.reset_launch_counts()
        losses, secs = run(model, start, batch, amp, dev)
        launches = K.launch_counts()
        rest = sorted(secs[1:])
        res[amp] = (losses, rest[len(rest) // 2], launches,
                    torch.cuda.max_memory_allocated(dev))
    t0 = time.perf_counter()
    cpu_losses, _ = run(Seq2SeqAttention(device="cpu"),
                        {k: v.cpu() for k, v in start.items()}, batch, True,
                        "cpu")
    cpu_sec = time.perf_counter() - t0
    losses, sec, launches, peak = res[True]
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, cpu_losses)]
    flops = analytic_flops(model, TRAIN_B, TRAIN_S, TRAIN_T)
    print(f"mixed: (a) flagship --amp losses {losses}; the CPU's "
          f"{cpu_losses} ({cpu_sec:.1f} s on the host's CPU), rel diffs "
          f"{[f'{r:.2e}' for r in rel]} (tol {TOL_MIXED_LOSS}) [{card}]",
          flush=True)
    print(f"mixed: (a) flagship B={TRAIN_B} S={TRAIN_S} T={TRAIN_T} Adam, "
          f"median of steps 2-{TRAIN_STEPS}: --amp {sec * 1e3:.2f} ms/step "
          f"({TRAIN_B * TRAIN_T / sec:.1f} words/s, MFU "
          f"{flops / sec / PEAK_OPS_PER_S['bfloat16']:.4%}, peak memory "
          f"{peak / 2 ** 30:.2f} GiB) vs without {res[False][1] * 1e3:.2f} "
          f"ms/step (peak {res[False][3] / 2 ** 30:.2f} GiB): "
          f"{res[False][1] / sec:.3f}x; --amp launches by path "
          f"{_launched(launches)} [{card}]", flush=True)
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        fail("mixed", f"(a) --amp losses {losses}: want finite, falling")
    if not max(rel) <= TOL_MIXED_LOSS:
        fail("mixed", f"(a) --amp losses beyond {TOL_MIXED_LOSS} of the "
             f"CPU's")
    for name in TRAIN_KERNELS:
        if launches[name] <= 0:
            fail("mixed", f"(a) {name} was not launched in the --amp "
                 f"steps")
    _all_persistent("mixed", "(a) --amp", launches,
                    PERSISTENT_TRAIN_KERNELS)
    for name in ("ce_readout_fwd", "ce_readout_bwd"):
        if launches.by_path[name] != {"wgmma": TRAIN_STEPS}:
            fail("mixed", f"(a) {name} by path {launches.by_path[name]}, "
                 f"want wgmma")
    return launches


def _state_snapshot(tr):
    """Every parameter, slot and the step counter of a trainer, cloned."""
    from paddle_tpu_torch.param.optimizers import slot_leaves

    return [v.detach().clone() for k in sorted(tr.params)
            for v in (tr.params[k], *slot_leaves(tr.opt_state["slots"][k]))
            ] + [tr.opt_state["step"].clone()]


def mixed_lstm(K, dev, card):
    """(b) ``lstm_benchmark_net`` at lstm_b64h256 through
    ``SGDTrainer(amp=True)`` (the default loss-scale state): 6 steps
    beside the same steps without --amp; then one batch whose gradient
    overflows (an inf injected into one gradient, the loss finite): the
    step is skipped with parameters, slots and the step counter held bit
    for bit, the scale halves and ``bad_steps_streak`` stays 0; then a
    clean batch trains.  Then ``--job=train --amp`` through the command
    line.  -> {part: launches}."""
    import tempfile

    import numpy as np
    import torch

    from paddle_tpu_torch.param import Adam
    from paddle_tpu_torch.trainer import SGDTrainer

    feeds = [textclf_feed(TEXTCLF_B, TEXTCLF_T, SEED + i)
             for i in range(TRAIN_STEPS + 2)]
    parts, res = {}, {}
    for amp in (False, True):
        with amp_policy(amp):
            _, cost = textclf_net(256, dev)
            tr = SGDTrainer(cost, Adam(learning_rate=1e-3), seed=SEED,
                            device=dev)
            K.reset_launch_counts()
            losses, secs = [], []
            for f in feeds[:TRAIN_STEPS]:
                t0 = time.perf_counter()
                losses.append(tr.train_batch(f).item())
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
            launches = K.launch_counts()
            rest = sorted(secs[1:])
            res[amp] = (losses, rest[len(rest) // 2])
            if amp:
                parts["amp_train_batch"] = launches
                amp_tr = tr
            else:
                del tr
    losses, sec = res[True]
    tr = amp_tr
    scale0 = float(tr.opt_state["amp"]["scale"])
    print(f"mixed: (b) lstm_b{TEXTCLF_B}h256 SGDTrainer(amp=True) losses "
          f"{losses}, loss scale {scale0:g} after {TRAIN_STEPS} steps "
          f"(good steps {int(tr.opt_state['amp']['good_steps'])}); median "
          f"of steps 2-{TRAIN_STEPS}: --amp {sec * 1e3:.2f} ms/step vs "
          f"without {res[False][1] * 1e3:.2f} ms/step (losses "
          f"{res[False][0]}); launches {_launched(parts['amp_train_batch'])}"
          f" [{card}]", flush=True)
    if not all(np.isfinite(losses)) or tr.amp_overflows_total:
        fail("mixed", f"(b) --amp losses {losses}, overflows "
             f"{tr.amp_overflows_total}")
    _launch_check("mixed", "(b) --amp", parts["amp_train_batch"],
                  {k: 2 * TRAIN_STEPS for k in TEXTCLF_KERNELS})
    # the planted overflow
    before = _state_snapshot(tr)
    with amp_policy(True):
        hook = tr.params["_logits.wbias"].register_hook(
            lambda g: g + float("inf"))
        loss = tr.train_batch(feeds[TRAIN_STEPS]).item()
        hook.remove()
        held = all(torch.equal(a, b) for a, b in
                   zip(before, _state_snapshot(tr)))
        scale1 = float(tr.opt_state["amp"]["scale"])
        ok = (np.isfinite(loss) and held and scale1 == scale0 / 2
              and int(tr._last_extras["amp_overflow"]) == 1
              and int(tr._last_extras["bad_step"]) == 0
              and tr.bad_steps_streak == 0 and tr.amp_overflows_total == 1)
        print(f"mixed: (b) planted overflow (inf in d _logits.wbias): loss "
              f"{loss} (finite), step skipped with {len(before)} parameter/"
              f"slot/step tensors held bit for bit: {held}, scale "
              f"{scale0:g} -> {scale1:g}, amp_overflow "
              f"{int(tr._last_extras['amp_overflow'])}, bad_step "
              f"{int(tr._last_extras['bad_step'])}, bad_steps_streak "
              f"{tr.bad_steps_streak}", flush=True)
        if not ok:
            fail("mixed", "(b) the planted overflow was not skipped as the "
                 "reference skips it")
        loss = tr.train_batch(feeds[TRAIN_STEPS + 1]).item()
        moved = not all(torch.equal(a, b) for a, b in
                        zip(before, _state_snapshot(tr)))
        print(f"mixed: (b) the next clean batch: loss {loss}, amp_overflow "
              f"{int(tr._last_extras['amp_overflow'])}, parameters moved: "
              f"{moved}", flush=True)
        if not (moved and int(tr._last_extras["amp_overflow"]) == 0):
            fail("mixed", "(b) the clean batch after the overflow did not "
                 "train")
    del tr, amp_tr
    torch.cuda.empty_cache()
    # the command line
    per = TRAINER_PASS_BATCHES
    with tempfile.TemporaryDirectory() as tmp:
        K.reset_launch_counts()
        with cli_run(TEXTCLF_B * per), recorded_losses() as run:
            t0 = time.perf_counter()
            cli(["--job=train", "--amp", f"--save_dir={tmp}",
                 "--num_passes=1"], phase="mixed")
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        parts["amp_cli"] = got = K.launch_counts()
        opt = np.load(os.path.join(tmp, "pass-00000", "opt_state.npz"))
        scale = float(opt["['amp']['scale']"])
        good = int(opt["['amp']['good_steps']"])
    print(f"mixed: (b) --job=train --amp, 1 pass of {per} batches (B="
          f"{TEXTCLF_B}, T={TEXTCLF_T}, a test pass after it): {secs:.2f} s,"
          f" losses {run}, checkpointed loss scale {scale:g} and good steps "
          f"{good}, launches {_launched(got)} [{card}]", flush=True)
    if not (len(run) == per and all(np.isfinite(run)) and good == per
            and scale == 65536.0):
        fail("mixed", "(b) --job=train --amp: losses or scale state wrong")
    _all_persistent("mixed", "(b) --job=train --amp", got, TEXTCLF_KERNELS)
    if got["lstm_backward"] != 2 * per:
        fail("mixed", f"(b) --job=train --amp launches {got}")
    return parts


def mixed_remat(K, dev, card):
    """(c) bench row lstm_b512h256r: ``lstm_benchmark_net`` at B=512,
    H=256, T=100 (bf16) through ``SGDTrainer(remat=True)``, beside the
    same 6 steps with ``remat=False``: losses, peak memory, ms a step, K9r
    and K10 launches by path (B=512 is past the persistent plans, so both
    take their steps kernels; under remat K9r runs twice a step).
    -> {part: launches}."""
    import numpy as np
    import torch

    from paddle_tpu_torch.param import Adam
    from paddle_tpu_torch.trainer import SGDTrainer

    feed = textclf_feed(REMAT_B, TEXTCLF_T, SEED)
    res, parts = {}, {}
    for remat in (False, True):
        _, cost = textclf_net(256, dev)
        tr = SGDTrainer(cost, Adam(learning_rate=1e-3), seed=SEED,
                        device=dev, remat=remat)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        K.reset_launch_counts()
        losses, secs = [], []
        for _ in range(TRAIN_STEPS):
            t0 = time.perf_counter()
            losses.append(tr.train_batch(feed).item())
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        launches = K.launch_counts()
        peak = torch.cuda.max_memory_allocated(dev)
        rest = sorted(secs[1:])
        res[remat] = (losses, rest[len(rest) // 2], peak)
        parts["remat" if remat else "plain"] = launches
        want = {"lstm_forward": (4 if remat else 2) * TRAIN_STEPS,
                "lstm_backward": 2 * TRAIN_STEPS}
        print(f"mixed: (c) lstm_b{REMAT_B}h256{'r' if remat else ''} "
              f"(T={TEXTCLF_T}, bf16, Adam) remat={remat}: losses {losses}, "
              f"median of steps 2-{TRAIN_STEPS} {res[remat][1] * 1e3:.2f} "
              f"ms/step ({REMAT_B / res[remat][1]:.1f} samples/s), peak "
              f"memory {peak / 2 ** 30:.3f} GiB "
              f"(torch.cuda.max_memory_allocated), launches "
              f"{_launched(launches)} [{card}]", flush=True)
        got = {k: n for k, n in launches.items() if n}
        if got != want or any(launches.by_path[k] != {"steps": n}
                              for k, n in want.items()):
            fail("mixed", f"(c) remat={remat}: launches {got} by path "
                 f"{_launched(launches)}, want {want} on the steps kernels")
        if not all(np.isfinite(losses)):
            fail("mixed", f"(c) remat={remat}: losses {losses}")
        del tr
    same = res[True][0] == res[False][0]
    rel = max(abs(a - b) / abs(b) for a, b in zip(res[True][0],
                                                 res[False][0]))
    verdict = ("bit for bit" if same else
               f"max rel diff {rel:.3e} (tol {TOL_REMAT_LOSS})")
    print(f"mixed: (c) remat vs plain: losses {verdict}; peak memory {res[True][2] / res[False][2]:.3f}x, step time "
          f"{res[True][1] / res[False][1]:.3f}x [{card}]", flush=True)
    if not rel <= TOL_REMAT_LOSS:
        fail("mixed", "(c) remat's losses differ from the plain step's")
    return parts


def mixed_prefetch(K, dev, card):
    """(d) ``--job=train`` at lstm_b64h256 with ``--prefetch_depth=2``
    against ``--prefetch_depth=0``, in turns (0, 2, 2, 0), one pass of
    MIXED_PREFETCH_BATCHES batches each: the losses bit for bit, and ms a
    step as the loop's cadence (the median interval between consecutive
    steps' losses, so the feeding it waits for counts).  -> {part:
    launches}."""
    import numpy as np
    import torch

    from paddle_tpu_torch.trainer import SGDTrainer

    step = SGDTrainer.train_batch
    runs = {0: [], 2: []}
    parts = {}
    for depth in (0, 2, 2, 0):
        stamps, losses = [], []

        def timed(self, feed):
            loss = step(self, feed)
            losses.append(loss.item())
            stamps.append(time.perf_counter())
            return loss

        SGDTrainer.train_batch = timed
        try:
            K.reset_launch_counts()
            with cli_run(TEXTCLF_B * MIXED_PREFETCH_BATCHES):
                cli(["--job=train", "--num_passes=1",
                     f"--prefetch_depth={depth}"], phase="mixed")
            launches = K.launch_counts()
        finally:
            SGDTrainer.train_batch = step
        gaps = sorted(np.diff(stamps))
        runs[depth].append((losses, gaps[len(gaps) // 2]))
        parts.setdefault(f"prefetch_{depth}", launches)
        _all_persistent("mixed", f"(d) depth {depth}", launches,
                        TEXTCLF_KERNELS)
        if launches["lstm_backward"] != 2 * MIXED_PREFETCH_BATCHES:
            fail("mixed", f"(d) depth {depth}: launches {launches}")
    same = all(r[0] == runs[0][0][0] for d in runs for r in runs[d])
    ms = {d: [round(float(r[1]) * 1e3, 3) for r in runs[d]] for d in runs}
    print(f"mixed: (d) --prefetch_depth=2 vs 0, --job=train at "
          f"lstm_b{TEXTCLF_B}h256, {MIXED_PREFETCH_BATCHES} batches a run: "
          f"losses {'bit for bit' if same else 'DIFFERENT'} "
          f"({runs[2][0][0][:3]}...); ms a step (median interval between "
          f"steps) depth 0 {ms[0]}, depth 2 {ms[2]} [{card}]", flush=True)
    if not same:
        fail("mixed", "(d) --prefetch_depth=2's losses differ from 0's")
    torch.cuda.synchronize()
    return parts


def mixed_path(K, dev, card):
    """Phase 16: arms (a)-(d).  -> {part: launches}."""
    import torch

    parts = {"amp_flagship": mixed_flagship(K, dev, card)}
    torch.cuda.empty_cache()
    parts.update(mixed_lstm(K, dev, card))
    torch.cuda.empty_cache()
    parts.update(mixed_remat(K, dev, card))
    torch.cuda.empty_cache()
    parts.update(mixed_prefetch(K, dev, card))
    return parts


#: the kernels line's rows that phase 16's parts launch
MIXED_PART_ROWS = {
    "gru_forward_residuals": ("amp_flagship",),
    "gru_backward": ("amp_flagship",),
    "ce_readout_fwd": ("amp_flagship",),
    "ce_readout_bwd": ("amp_flagship",),
    "attn_dec_fwd": ("amp_flagship",),
    "attn_dec_bwd": ("amp_flagship",),
    "lstm_forward_residuals_b64h256": ("amp_train_batch", "amp_cli",
                                       "prefetch_0", "prefetch_2"),
    "lstm_backward_b64h256": ("amp_train_batch", "amp_cli", "prefetch_0",
                              "prefetch_2"),
    "lstm_forward_residuals_b512h256": ("plain", "remat"),
    "lstm_backward_b512h256": ("plain", "remat"),
}


def check_lstm_b512(K, flush, dev):
    """K9r and K10 at bench row lstm_b512h256r's shape (B=512, T=100,
    H=256, bf16 policy, bf16 residuals): past the persistent plans (B <=
    256), so both take their steps kernels; each against its plain
    version, timed beside cuDNN's LSTM training forward (and forward +
    backward) at the same shape."""
    import torch

    from paddle_tpu_torch.ops.kernels.lstm import LSTM_BACKWARD, LSTM_FORWARD
    from paddle_tpu_torch.ops.numerics import compute_dtype_scope

    B, T, H = REMAT_B, TEXTCLF_T, 256
    g = torch.Generator().manual_seed(SEED + 16)
    lens = torch.randint(T // 2, T + 1, (B,), generator=g)
    lens[0] = T
    xp = (0.5 * torch.randn(B, T, 4 * H, generator=g)).to(dev)
    mask = (torch.arange(T)[None] < lens[:, None]).float().to(dev)
    w_h = ((2.0 / (5 * H)) ** 0.5 * torch.randn(H, 4 * H, generator=g)
           ).to(dev)
    peeps = [(0.1 * torch.randn(H, generator=g)).to(dev) for _ in range(3)]
    n_real = float(mask.sum())
    lib_x = torch.randn(B, T, H, device=dev, dtype=torch.bfloat16)
    lstm, packed = _cudnn_lstm(lib_x, lens, w_h.bfloat16())
    rows = []
    with compute_dtype_scope("bfloat16"):
        before = _paths(LSTM_FORWARD)
        got = K.lstm_forward(xp, mask, w_h, *peeps, residuals=True)
        took = _paths_since(LSTM_FORWARD, before)
        want = K.lstm_forward_plain(xp, mask, w_h, *peeps, residuals=True)
        torch.cuda.synchronize()
        tol = TOL["lstm_forward_residuals_b64h256"]
        err = max(_max_err(a, b) for a, b in zip(got[:3], want[:3]))
        res_ok = all(_within_bf16_ulp(a, b, tol)
                     for a, b in zip(got[3:], want[3:]))
        if took != {"steps": 1} or not (err <= tol and res_ok):
            fail("kernels", f"lstm_forward residuals B={B}: took {took}, "
                 f"h/c err {err} (tol {tol}), residuals within tol + one "
                 f"bf16 ulp: {res_ok}")
        ms = time_ms(lambda: K.lstm_forward(xp, mask, w_h, *peeps,
                                            residuals=True), flush)
        plain_ms = time_ms(lambda: K.lstm_forward_plain(
            xp, mask, w_h, *peeps, residuals=True), flush, reps=3)
        lib_w = [p.requires_grad_() for p in lstm.parameters()]
        lib_ms = time_ms(lambda: lstm(packed), flush)
        nbytes = (T * B * 4 * H * 4 + T * B * 4 + H * 4 * H * 2 + 3 * H * 4
                  + T * B * H * 4 + 2 * B * H * 4 + T * B * 4 * H * 2
                  + 2 * T * B * H * 2)
        bms, by = bound_ms(nbytes, 2.0 * n_real * H * 4 * H, "bfloat16")
        print(f"kernels: lstm_forward residuals=True B={B} T={T} H={H} "
              f"bf16, bf16 residuals, path=steps: h/c max_abs_err="
              f"{err:.3e} (tol {tol}), z/h_prev/c_prev within tol + one "
              f"bf16 ulp; ms={ms:.4f} (share of bound {bms / ms:.3f}) "
              f"plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} (cuDNN LSTM "
              f"training forward) bound_ms={bms:.5f} ({by})", flush=True)
        row = _kernel_row(f"lstm_forward_residuals_b{B}h{H}",
                          "lstm_forward.cu", "126", err, ms, plain_ms, bms,
                          by, lib_ms)
        row.update(path="steps", share_of_bound=bms / ms,
                   library_covers="cuDNN LSTM training forward, bf16, packed "
                   "by length: input projection + loop + its reserve, no "
                   "peepholes")
        rows.append(row)

        d_out = torch.randn(T, B, H, generator=g).to(dev)
        d_fin = [torch.randn(B, H, generator=g).to(dev) for _ in range(2)]
        bargs = [d_out, mask.t().contiguous(), got[3], got[5],
                 w_h.t().contiguous(), *peeps, *d_fin]
        before = _paths(LSTM_BACKWARD)
        gk = K.lstm_backward(*bargs)
        took = _paths_since(LSTM_BACKWARD, before)
        gp = K.lstm_backward_plain(*bargs)
        torch.cuda.synchronize()
        tol = TOL["lstm_backward_b64h256"]
        err = max(_max_err(a, c) for a, c in zip(gk, gp))
        worst = max(_max_err(a, c) / c.abs().max().item()
                    for a, c in zip(gk, gp))
        if took != {"steps": 1} or not worst <= tol:
            fail("kernels", f"lstm_backward B={B}: took {took}, max err / "
                 f"max |g| {worst} (tol {tol})")
        ms = time_ms(lambda: K.lstm_backward(*bargs), flush)
        plain_ms = time_ms(lambda: K.lstm_backward_plain(*bargs), flush,
                           reps=3)
        ct = torch.randn(int(packed.data.shape[0]), H, device=dev,
                         dtype=torch.bfloat16)
        lib_in = lib_x.clone().requires_grad_()

        def library_fwd_bwd():
            out, _ = lstm(torch.nn.utils.rnn.pack_padded_sequence(
                lib_in, lens, batch_first=True, enforce_sorted=False))
            return torch.autograd.grad(out.data, [lib_in, *lib_w], ct)

        lib_ms = time_ms(library_fwd_bwd, flush)
    nbytes = (T * B * H * 4 + T * B * 4 + T * B * 4 * H * 2 + T * B * H * 2
              + 4 * H * H * 4 + 3 * H * 4 + 2 * B * H * 4
              + T * B * 4 * H * 4 + T * B * H * 4 + 2 * B * H * 4)
    bms, by = bound_ms(nbytes, 2.0 * n_real * 4 * H * H, "float32")
    print(f"kernels: lstm_backward B={B} T={T} H={H} bf16 residuals "
          f"path=steps max_abs_err={err:.3e} (max err / max |g| "
          f"{worst:.3e}; tol {tol}); ms={ms:.4f} (share of bound "
          f"{bms / ms:.3f}) plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} "
          f"(cuDNN LSTM forward + backward) bound_ms={bms:.5f} ({by}, f32 "
          f"products)", flush=True)
    row = _kernel_row(f"lstm_backward_b{B}h{H}", "lstm_backward.cu", "479",
                      err, ms, plain_ms, bms, by, lib_ms)
    row.update(path="steps", share_of_bound=bms / ms,
               library_covers="cuDNN LSTM forward + backward, bf16, packed "
               "by length")
    rows.append(row)
    del lstm, packed, lib_w, got, want, gk, gp
    return rows


# ---------------------------------------------------------------------------
# phase 17: deploy bundles served through InferenceServer and `serve`
# ---------------------------------------------------------------------------

#: the deploy phase: training steps before the merge (B=64, T=100), the
#: served traffic (DEPLOY_REQUESTS requests of 1-4 rows, lengths
#: DEPLOY_LEN), the server's row bound, the CLI smokes' request counts and
#: the card-vs-CPU tolerance (max |diff| / max |CPU|, bf16 policy)
DEPLOY_TRAIN_STEPS, DEPLOY_REQUESTS, DEPLOY_MAX_BATCH = 3, 64, 8
DEPLOY_LEN, DEPLOY_ROWS = (20, 100), (1, 4)
DEPLOY_SMOKE, DEPLOY_CONTINUOUS_SMOKE = 64, 16
DEPLOY_QUANT_TOL, TOL_DEPLOY_CPU = 0.05, 2e-3
DEPLOY_MODES = ("f32", "bf16", "int8")
#: the kernels line's rows that phase 17's parts launch
DEPLOY_PART_ROWS = {
    "lstm_forward": tuple(f"serve_{m}" for m in DEPLOY_MODES),
    f"lstm_forward_residuals_b{TEXTCLF_B}h256": ("train",),
    f"lstm_backward_b{TEXTCLF_B}h256": ("train",),
}


def deploy_requests(seed: int):
    """DEPLOY_REQUESTS feeds of 1-4 rows, lengths drawn from DEPLOY_LEN,
    each padded to its own longest row only."""
    import numpy as np

    rng = np.random.RandomState(seed)
    reqs = []
    for _ in range(DEPLOY_REQUESTS):
        rows = rng.randint(DEPLOY_ROWS[0], DEPLOY_ROWS[1] + 1)
        lens = rng.randint(DEPLOY_LEN[0], DEPLOY_LEN[1] + 1,
                           rows).astype(np.int32)
        ids = rng.randint(3, TEXTCLF_VOCAB, (rows, int(lens.max())))
        reqs.append({"words": (ids.astype(np.int32), lens)})
    return reqs


def deploy_serve(K, model, reqs, mode: str, profiled: bool = False):
    """The requests through a bucket-mode ``InferenceServer`` over
    ``model``, all submitted at once after a warmup that primes every batch
    bucket at each length bucket the traffic reaches; then one zero-row
    request.  With ``profiled``, the same requests a second time through
    the same server under ``torch.profiler`` (CUDA activity, every thread's
    kernels): its batches, wall ms, device kernel ms and K9's device ms and
    kernels go into the stats as ``profile``; its launches are not the
    path's.  -> (replies, launches, stats)."""
    import threading

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.serving import InferenceServer

    warm = [{"words": (np.full((1, t), 3, np.int32),
                       np.asarray([t], np.int32))}
            for t in (DEPLOY_LEN[0], 64, DEPLOY_LEN[1])]
    srv = InferenceServer(model, max_batch=DEPLOY_MAX_BATCH,
                          batch_delay_ms=2.0, max_queue=2 * DEPLOY_REQUESTS,
                          default_deadline_ms=0.0)
    try:
        srv.start(warmup_feed=warm)
        primes = srv.metrics.count("warmup_compiles")
        torch.cuda.synchronize()
        # the zero-row request first, alone: replied inline from the primed
        # shapes, no launch
        K.reset_launch_counts()
        empty = srv.submit({"words": (np.zeros((0, DEPLOY_LEN[1]), np.int32),
                                      np.zeros((0,), np.int32))}).result(30)
        zero_launches = {n: c for n, c in K.launch_counts().items() if c}
        if empty["logits"].shape != (0, 2) or zero_launches:
            fail("deploy", f"{mode}: zero-row reply {empty['logits'].shape},"
                 f" launches {zero_launches}")
        done = [None] * len(reqs)
        K.reset_launch_counts()
        t0 = time.perf_counter()
        futs = [srv.submit(f) for f in reqs]

        def wait(i):
            futs[i].result(120)
            done[i] = time.perf_counter()

        waiters = [threading.Thread(target=wait, args=(i,))
                   for i in range(len(futs))]
        for w in waiters:
            w.start()
        for w in waiters:
            w.join(180)
        wall = time.perf_counter() - t0
        launches = K.launch_counts()
        replies = [f.result(0) for f in futs]
        hz = srv.healthz()
        prof_stats = None
        if profiled:
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                t1 = time.perf_counter()
                for f in [srv.submit(f) for f in reqs]:
                    f.result(120)
                torch.cuda.synchronize()
                prof_wall = time.perf_counter() - t1
            kernels = [e for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA
                       and not e.is_user_annotation]
            k9 = [e for e in kernels if "lstm_fwd_persistent_kernel" in e.key]
            prof_stats = {
                "batches": (srv.healthz()["counters"]["batches"]
                            - hz["counters"]["batches"]),
                "wall_ms": prof_wall * 1e3,
                "device_ms": sum(e.self_device_time_total
                                 for e in kernels) / 1e3,
                "kernels": sum(e.count for e in kernels),
                "k9_ms": sum(e.self_device_time_total for e in k9) / 1e3,
                "k9_kernels": sum(e.count for e in k9)}
    finally:
        srv.close()
    lat = sorted((d - t0) * 1e3 for d in done)
    stats = {"primes": primes, "batches": hz["counters"]["batches"],
             "completed": hz["counters"]["completed"],
             "rps": len(reqs) / wall, "wall_s": wall,
             "p50_ms": lat[len(lat) // 2],
             "p99_ms": lat[min(len(lat) - 1, int(0.99 * len(lat)))],
             "profile": prof_stats}
    return replies, launches, stats


def deploy_dequant_ratio(model, trained, mode: str) -> float:
    """The loaded bundle's parameters (dequantized on load) against the
    trained float32 ones they were merged from: the largest
    ``|loaded - trained| / half a quantization step``, the step computed
    here from the trained values (int8 for arrays of ndim >= 2 and size >=
    256 in the int8 mode: the channel's max |w| / 127 over the last axis;
    bfloat16 otherwise: half an ulp is at most 2**-8 |w|).  At most 1 when
    every parameter is what its stored code means."""
    import numpy as np

    worst = 0.0
    for name, p in model.params.items():
        w = trained[name].detach().cpu().numpy().astype(np.float64)
        got = p.detach().cpu().numpy().astype(np.float64)
        if mode == "int8" and w.ndim >= 2 and w.size >= 256:
            scale = np.abs(w).max(axis=tuple(range(w.ndim - 1)),
                               keepdims=True) / 127.0
            half = 0.5 * scale + 2.0 ** -22 * np.abs(w)
        else:
            half = 2.0 ** -8 * np.abs(w)
        err = np.abs(got - w)
        worst = max(worst, float((err / np.maximum(half, 1e-30)).max()))
    return worst


def deploy_check_launches(launches, batches: int, mode: str) -> None:
    """K9 twice a served batch (one a layer), all persistent, only from
    the worker thread; nothing else."""
    want = {"lstm_forward": 2 * batches}
    got = {n: c for n, c in launches.items() if c}
    threads = launches.by_thread.get("lstm_forward", {})
    if (got != want or launches.by_path["lstm_forward"]
            != {"persistent": 2 * batches}
            or not all(t.startswith("serving-worker-") for t in threads)):
        fail("deploy", f"{mode}: launches {got} by path "
             f"{launches.by_path.get('lstm_forward')} by thread {threads}, "
             f"want {want} persistent from the worker")


def deploy_cli(args, dev, what: str):
    """``python -m paddle_tpu_torch serve ...`` in a fresh process: its
    exit code, its JSON lines and the wall seconds to its ready line."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch", "serve",
         f"--device={dev.type}", *args], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    first, ready_s = "", None
    try:
        while ready_s is None:
            line = proc.stdout.readline()
            if not line:
                break
            first += line
            if line.startswith('{"ready"'):
                ready_s = time.perf_counter() - t0
        rest, err = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    lines = [json.loads(l) for l in (first + rest).splitlines()
             if l.startswith("{")]
    if (proc.returncode != 0 or ready_s is None or len(lines) < 2
            or not lines[0].get("ready")):
        fail("deploy", f"{what}: exit {proc.returncode}, stdout "
             f"{(first + rest)[-1500:]!r}, stderr {err[-3000:]!r}")
    return lines, ready_s


def deploy_path(K, dev, card):
    """Phase 17: train ``lstm_benchmark_net`` at lstm_b64h256 through
    ``SGDTrainer`` (DEPLOY_TRAIN_STEPS steps), merge its inference graph
    (``Topology(logits)``) to an f32, a bf16 and an int8 bundle, load each
    with no model code and serve it in bucket mode; the ``serve`` command
    line on the f32 bundle and its continuous smoke, each in a fresh
    process.  -> {part: launches}."""
    import shutil
    import tempfile
    import zipfile

    import numpy as np
    import torch

    import paddle_tpu_torch.nn as nn
    from paddle_tpu_torch.config import (BundleCorruptError,
                                         load_inference_model, merge_model)
    from paddle_tpu_torch.models import lstm_benchmark_net
    from paddle_tpu_torch.param import Adam
    from paddle_tpu_torch.trainer import SGDTrainer

    parts = {}
    nn.reset_naming()
    cost, logits = lstm_benchmark_net(TEXTCLF_VOCAB, emb_dim=TEXTCLF_EMB,
                                      hid_dim=256,
                                      num_layers=TEXTCLF_LAYERS)
    tr = SGDTrainer(cost, Adam(learning_rate=1e-3), seed=SEED, device=dev)
    K.reset_launch_counts()
    losses = [tr.train_batch(textclf_feed(TEXTCLF_B, TEXTCLF_T, SEED + i))
              .item() for i in range(DEPLOY_TRAIN_STEPS)]
    parts["train"] = K.launch_counts()
    _launch_check("deploy", "train", parts["train"],
                  {k: 2 * DEPLOY_TRAIN_STEPS for k in TEXTCLF_KERNELS})
    n_params = sum(p.numel() for p in tr.params.values())
    topo = nn.Topology(logits, device=dev)
    root = tempfile.mkdtemp(prefix="deploy-")
    paths, merge_s, npz_bytes, pb_bytes, quant = {}, {}, {}, {}, {}
    for mode in DEPLOY_MODES:
        t0 = time.perf_counter()
        paths[mode] = merge_model(
            os.path.join(root, f"{mode}.ptz"), topo, tr.params, tr.state,
            name="textclf", quantize=None if mode == "f32" else mode,
            quantize_tol=DEPLOY_QUANT_TOL)
        merge_s[mode] = time.perf_counter() - t0
        with zipfile.ZipFile(paths[mode]) as z:
            info = {i.filename: i for i in z.infolist()}
            pb_bytes[mode] = z.read("model.pb")
            quant[mode] = json.loads(z.read("manifest.json")).get(
                "quantize") or {}
        npz_bytes[mode] = info["params.npz"].file_size
    print(f"deploy: lstm_b{TEXTCLF_B}h256 trained {DEPLOY_TRAIN_STEPS} "
          f"SGDTrainer steps (losses {losses}; {n_params} parameters); "
          f"merge s {{{', '.join(f'{m}: {s:.3f}' for m, s in merge_s.items())}}}"
          f"; params.npz bytes (deflated npz) {npz_bytes}; max_abs_err vs "
          f"quantize_tol {DEPLOY_QUANT_TOL}: "
          f"{ {m: q.get('max_abs_err') for m, q in quant.items() if q} } "
          f"[{card}]", flush=True)
    if len(set(pb_bytes.values())) != 1:
        fail("deploy", "model.pb differs between the f32, bf16 and int8 "
             "bundles")
    for mode in DEPLOY_MODES[1:]:
        q = quant[mode]
        if q.get("mode") != mode or not 0 < q["max_abs_err"] <= q["tol"]:
            fail("deploy", f"{mode}: manifest quantize block {q}")

    # a member truncated in a copy of the f32 bundle is named
    bad = os.path.join(root, "truncated.ptz")
    with zipfile.ZipFile(paths["f32"]) as src, \
            zipfile.ZipFile(bad, "w", zipfile.ZIP_DEFLATED) as dst:
        for i in src.infolist():
            data = src.read(i.filename)
            dst.writestr(i.filename, data[: len(data) // 2]
                         if i.filename == "params.npz" else data)
    try:
        load_inference_model(bad, device=dev)
        fail("deploy", "a truncated params.npz loaded")
    except BundleCorruptError as e:
        if e.member != "params.npz":
            fail("deploy", f"truncated bundle names member {e.member!r}")

    # the serve command line on the f32 bundle, then its continuous smoke
    lines, ready_s = deploy_cli(
        [f"--serve_bundle={paths['f32']}", f"--serve_smoke={DEPLOY_SMOKE}",
         f"--serve_max_batch={DEPLOY_MAX_BATCH}",
         "--serve_deadline_ms=60000"], dev, "serve --serve_smoke")
    hz = lines[-1]
    print(f"deploy: serve --serve_smoke={DEPLOY_SMOKE} exit 0, "
          f"{ready_s:.2f} s to its ready line; healthz "
          f"{json.dumps(hz['counters'])}; launches after its ready line "
          f"{json.dumps(hz['launches'])} [{card}]", flush=True)
    if hz["counters"]["completed"] != DEPLOY_SMOKE or hz["counters"]["shed"]:
        fail("deploy", f"serve --serve_smoke: counters {hz['counters']}")
    k9 = 2 * hz["counters"]["batches"]
    if (not k9 or hz["launches"]["by_kernel"] != {"lstm_forward": k9}
            or hz["launches"]["by_path"]
            != {"lstm_forward": {"persistent": k9}}):
        fail("deploy", f"serve --serve_smoke: launches {hz['launches']}, "
             f"want K9 {k9} persistent (2 a batch) and nothing else")
    clines, cready_s = deploy_cli(
        ["--serve_continuous", f"--serve_smoke={DEPLOY_CONTINUOUS_SMOKE}",
         "--serve_deadline_ms=60000"], dev, "serve --serve_continuous")
    chz = clines[-1]
    print(f"deploy: serve --serve_continuous --serve_smoke="
          f"{DEPLOY_CONTINUOUS_SMOKE} exit 0, {cready_s:.2f} s to its ready "
          f"line; completed {chz['counters']['completed']}, slots "
          f"{chz.get('slots')}; launches after its ready line "
          f"{json.dumps(chz['launches'])} [{card}]", flush=True)
    if chz["counters"]["completed"] != DEPLOY_CONTINUOUS_SMOKE:
        fail("deploy", f"continuous smoke counters {chz['counters']}")
    if set(chz["launches"]["by_kernel"]) != {"gru_forward",
                                             "topk_lse_readout"}:
        fail("deploy", f"continuous smoke launches {chz['launches']}, want "
             f"K3 (prefill) and K7 (decode) and nothing else")

    # each bundle loaded with no model code and served in bucket mode
    reqs = deploy_requests(SEED)
    served, models = {}, {}
    for mode in DEPLOY_MODES:
        t0 = time.perf_counter()
        # the default device is the card's (a CPU rehearsal names the CPU)
        model = models[mode] = load_inference_model(
            paths[mode], device=None if dev.type == "cuda" else dev)
        load_s = time.perf_counter() - t0
        if model.device.type != "cuda" or any(
                p.device.type != "cuda" for p in model.params.values()):
            fail("deploy", f"{mode}: parameters not on the card")
        replies, launches, st = deploy_serve(K, model, reqs, mode,
                                             profiled=mode == "f32")
        parts[f"serve_{mode}"] = launches
        deploy_check_launches(launches, st["batches"], mode)
        if st["completed"] != len(reqs) + 1:  # the zero-row one too
            fail("deploy", f"{mode}: {st['completed']} completed")
        solo = [model.infer(f)["logits"] for f in reqs]
        diff = [i for i, (a, b) in enumerate(zip(replies, solo))
                if not np.array_equal(a["logits"], b)]
        served[mode] = [r["logits"] for r in replies]
        print(f"deploy: {mode} bundle loaded in {load_s:.3f} s, warmup "
              f"primes {st['primes']}; {len(reqs)} requests "
              f"({sum(r['words'][1].size for r in reqs)} rows) at once in "
              f"{st['batches']} batches: {st['rps']:.1f} requests/s, "
              f"submit-to-answer p50 {st['p50_ms']:.2f} ms p99 "
              f"{st['p99_ms']:.2f} ms; K9 launches by path "
              f"{launches.by_path['lstm_forward']} by thread "
              f"{launches.by_thread['lstm_forward']}; replies unequal to "
              f"solo infer: {diff} [{card}]", flush=True)
        if diff:
            fail("deploy", f"{mode}: served rows {diff} differ from solo "
                 f"infer bit for bit")
        pr = st["profile"]
        if pr is not None:
            # K9's device time at the served shapes beside the host's
            print(f"deploy: {mode} the same {len(reqs)} requests again under "
                  f"torch.profiler: {pr['batches']} batches in "
                  f"{pr['wall_ms']:.3f} ms wall, device kernels "
                  f"{pr['device_ms']:.3f} ms ({pr['kernels']} kernels; busy "
                  f"share {pr['device_ms'] / pr['wall_ms']:.4f}); K9 "
                  f"{pr['k9_kernels']} kernels, {pr['k9_ms']:.3f} ms "
                  f"({pr['k9_ms'] / max(pr['k9_kernels'], 1):.4f} ms a "
                  f"launch, {pr['k9_ms'] / max(pr['batches'], 1):.4f} ms a "
                  f"batch); wall a batch "
                  f"{pr['wall_ms'] / max(pr['batches'], 1):.3f} ms "
                  f"[{card}]", flush=True)
            if not pr["batches"] or pr["k9_kernels"] != 2 * pr["batches"]:
                fail("deploy", f"{mode}: the profiled pass shows "
                     f"{pr['k9_kernels']} K9 kernels for {pr['batches']} "
                     f"batches, want 2 a batch")
    trained = dict(tr.params)
    for mode in DEPLOY_MODES[1:]:
        # the stored codes mean the trained weights: every loaded parameter
        # within half a quantization step of the value it was merged from
        ratio = deploy_dequant_ratio(models[mode], trained, mode)
        # the gate's contract is its tolerance: the manifest's max_abs_err
        # is the largest error over its 6-row synthetic sweep, which a
        # largest error over the served rows may pass (printed as a ratio)
        err = max(float(np.abs(a - b).max())
                  for a, b in zip(served[mode], served["f32"]))
        q = quant[mode]
        print(f"deploy: {mode} loaded parameters vs the trained f32 ones: "
              f"largest |diff| / half a quantization step {ratio:.6f} "
              f"(limit 1); served logits vs the f32 bundle's on the same "
              f"rows: max abs {err:.3e}; the manifest's max_abs_err "
              f"{q['max_abs_err']:.3e} (ratio "
              f"{err / q['max_abs_err']:.2f}), quantize_tol {q['tol']} "
              f"[{card}]", flush=True)
        if not ratio <= 1.0:
            fail("deploy", f"{mode}: a loaded parameter is {ratio:.4f} half "
                 f"quantization steps from the trained value")
        if not err <= q["tol"]:
            fail("deploy", f"{mode}: served logits {err:.3e} from the f32 "
                 f"bundle's, past the gate's tolerance {q['tol']}")

    # the bundle against the training process, and the card against the CPU
    f32 = models["f32"]
    with torch.no_grad():
        for f in reqs[:4]:
            want, _ = tr.topology.apply(tr.params, tr.state, f, train=False,
                                        outputs=[logits.name])
            w = want[logits.name].value.float().cpu().numpy()
            if not np.array_equal(f32.infer(f)["logits"], w):
                fail("deploy", "the f32 bundle's infer differs from the "
                     "trained Topology.apply")
    # each bundle loaded on the CPU (plain versions, the same dequantized
    # parameters) against its served replies on the card
    worst = {}
    for mode in DEPLOY_MODES:
        cpu = load_inference_model(paths[mode], device="cpu")
        worst[mode] = 0.0
        for f, a in zip(reqs[:2], served[mode]):
            c = cpu.infer(f)["logits"]
            worst[mode] = max(worst[mode],
                              float(np.abs(a - c).max() / np.abs(c).max()))
    print(f"deploy: f32 bundle infer equals the trained Topology.apply on "
          f"4 requests; served on the card vs the same bundle on the CPU, "
          f"2 requests: max |diff| / max |CPU| "
          f"{ {m: f'{w:.3e}' for m, w in worst.items()} } "
          f"(tol {TOL_DEPLOY_CPU}) [{card}]", flush=True)
    if not all(w <= TOL_DEPLOY_CPU for w in worst.values()):
        fail("deploy", f"card and CPU disagree beyond tolerance: {worst}")
    del tr, models, f32, cpu, topo, trained
    shutil.rmtree(root, ignore_errors=True)
    torch.cuda.synchronize()
    return parts


# ---------------------------------------------------------------------------
# phase 18: the user's entry points: the seqToseq demo copy and a paddle.v2
# script at the WMT14 widths
# ---------------------------------------------------------------------------

#: the demo copy's card run (``python -m paddle_tpu_torch.demo.seqToseq.
#: train`` arguments): 4 Adam steps at B=64 over the wmt14 stream, V=30000,
#: E=H=512, then beam 3 to 20 tokens on the first batch's first 4 sources;
#: its card-vs-CPU run and its fresh process take the first FRONTDOOR_CHECK_N
#: rows (2 steps)
FRONTDOOR_DEMO = {"batch": 64, "dict": 30000, "emb": 512, "hid": 512,
                  "n": 256, "beam": 3}
FRONTDOOR_CHECK_N = 128
#: the demo's beam search length (``demo/seqToseq/train.py``'s max_len)
FRONTDOOR_DEMO_MAX_LEN = 20
#: the v2 script: widths, batch, wmt14 rows (3 steps), Adam's rate; its
#: generator's beam, max_length (the reference demo's 250 cut to 32 to
#: bound the phase's time) and the test sources it generates for
FRONTDOOR_V2 = {"V": 30000, "E": 512, "H": 512, "D": 512, "A": 512}
FRONTDOOR_V2_B, FRONTDOOR_V2_N, FRONTDOOR_V2_LR = 64, 192, 5e-4
FRONTDOOR_V2_BEAM, FRONTDOOR_V2_MAX_LEN = 3, 32
FRONTDOOR_V2_SOURCES = 8
#: the kernels line's rows that phase 18's parts launch, and their library
FRONTDOOR_ROWS = {
    "gru_forward": ("gru_forward", ("demo_generate", "v2_infer")),
    "gru_forward_residuals": ("gru_forward", ("demo_train", "v2_train")),
    "gru_backward": ("gru_backward", ("demo_train", "v2_train")),
    "attn_dec_fwd": ("attn_dec_fwd", ("demo_train",)),
    "attn_dec_bwd": ("attn_dec_bwd", ("demo_train",)),
    "ce_readout_fwd": ("ce_readout_fwd", ("demo_train",)),
    "ce_readout_bwd": ("ce_readout_bwd", ("demo_train",)),
    "topk_lse_readout": ("topk_lse_readout", ("demo_generate",)),
    "topk_lse_logits": ("topk_lse_logits", ("v2_infer",)),
}


def _launch_delta(after, before):
    """``after - before`` of two ``launch_counts()``, by library and by
    kernel variant."""
    from paddle_tpu_torch.ops.kernels.build import LaunchCounts

    by_path = {}
    for name, paths in after.by_path.items():
        old = before.by_path.get(name, {})
        by_path[name] = {p: n - old.get(p, 0) for p, n in paths.items()
                         if n - old.get(p, 0)}
    return LaunchCounts({k: after[k] - before[k] for k in after}, by_path,
                        {k: {} for k in after})


def _only(phase: str, part: str, launches, want: dict) -> None:
    """Each library of ``want`` launched exactly its count there (a
    ``(lo, hi)`` pair: within it) and no other library at all."""
    for name, n in launches.items():
        w = want.get(name, 0)
        ok = (w[0] <= n <= w[1]) if isinstance(w, tuple) else n == w
        if not ok:
            fail(phase, f"{part}: {name} launched {n} times (want {w}); "
                 f"launches {dict(launches)}")


@contextlib.contextmanager
def _generation_marks(marks: dict):
    """``Seq2SeqAttention.beam_search`` wrapped to record the launch counts
    at its start and end, so the demo's ``main`` splits into its training
    and its generation."""
    from paddle_tpu_torch.models.seq2seq import Seq2SeqAttention
    from paddle_tpu_torch.ops import kernels as K

    orig = Seq2SeqAttention.beam_search

    def marked(self, *args, **kw):
        marks["before"] = K.launch_counts()
        t0 = time.perf_counter()
        out = orig(self, *args, **kw)
        if self.device.type == "cuda":
            import torch

            torch.cuda.synchronize()
        marks["sec"] = time.perf_counter() - t0
        marks["after"] = K.launch_counts()
        return out

    Seq2SeqAttention.beam_search = marked
    try:
        yield
    finally:
        Seq2SeqAttention.beam_search = orig


def _demo_args(n: int, where: str):
    d = FRONTDOOR_DEMO
    return ["--passes", "1", "--batch-size", str(d["batch"]), "--dict-size",
            str(d["dict"]), "--emb-dim", str(d["emb"]), "--hid-dim",
            str(d["hid"]), "--n", str(n), "--beam-size", str(d["beam"]),
            "--generate", "--device", where]


def _search_agree(phase: str, what: str, card, cpu, rescore_on) -> None:
    """Card vs CPU generation (``card``/``cpu``: (ids [B, K, L], scores
    [B, K])): per source, ids identical and scores within TOL_SEARCH, or
    (a near tie of nearly flat random-init logits) each side's best
    hypothesis rescored on the other (``rescore_on(side, b, hyp)``) within
    TOL_SEARCH of its own score."""
    import numpy as np

    (c_ids, c_sc), (p_ids, p_sc) = card, cpu
    for b in range(len(c_ids)):
        d_best = abs(float(c_sc[b][0]) - float(p_sc[b][0]))
        if np.array_equal(c_ids[b], p_ids[b]):
            d = float(np.abs(np.asarray(c_sc[b], np.float64)
                             - np.asarray(p_sc[b], np.float64)).max())
            print(f"{phase}: {what}: card vs CPU, source {b}, f32: ids "
                  f"identical, scores max diff {d:.3e} (tol {TOL_SEARCH})",
                  flush=True)
            if d > TOL_SEARCH:
                fail(phase, f"{what}: source {b}: scores beyond tolerance")
            continue
        d1 = abs(rescore_on("cpu", b, c_ids[b][0]) - float(c_sc[b][0]))
        d2 = abs(rescore_on("card", b, p_ids[b][0]) - float(p_sc[b][0]))
        print(f"{phase}: {what}: card vs CPU, source {b}, f32: ids differ "
              f"(near tie); best scores differ by {d_best:.3e}, card's best "
              f"rescored on the CPU {d1:.3e}, CPU's on the card {d2:.3e} "
              f"(tol {TOL_SEARCH})", flush=True)
        if max(d_best, d1, d2) > TOL_SEARCH:
            fail(phase, f"{what}: source {b}: card and CPU disagree beyond "
                 f"a near tie")


def demo_checks(phase: str, what: str, res, printed: str, marks: dict,
                total, steps: int):
    """What the seqToseq demo copy's ``main`` at the card arguments must
    show: ``steps`` finite costs and its printed lines, a well-formed beam
    3 generation, exactly K3r/K4 twice and K5/K6/K1/K2 once a step
    (persistent, wgmma), then K3 twice and K7 once a decode step (wgmma),
    nothing after.  -> (training launches, generation launches)."""
    import numpy as np

    train = marks["before"]
    gen = _launch_delta(marks["after"], marks["before"])
    losses = res["losses"]
    if (len(losses) != steps or not np.isfinite(losses).all()
            or "cost" not in printed or "target words/s" not in printed):
        fail(phase, f"{what}: losses {losses}, printed {printed!r}")
    toks, scores = res["tokens"], res["scores"]
    if (toks.shape != (4, FRONTDOOR_DEMO["beam"], FRONTDOOR_DEMO_MAX_LEN)
            or not np.isfinite(scores).all()
            or not (scores[:, :-1] >= scores[:, 1:]).all()):
        fail(phase, f"{what}: malformed generation {toks.shape}")
    _only(phase, f"{what} training", train, {
        "gru_forward": 2 * steps, "gru_backward": 2 * steps,
        "attn_dec_fwd": steps, "attn_dec_bwd": steps,
        "ce_readout_fwd": steps, "ce_readout_bwd": steps})
    _only(phase, f"{what} generation", gen, {
        "gru_forward": 2, "topk_lse_readout": (1, FRONTDOOR_DEMO_MAX_LEN)})
    if dict(_launch_delta(total, marks["after"])) != dict.fromkeys(total, 0):
        fail(phase, f"{what}: launches after its generation")
    _all_persistent(phase, f"{what} training", train,
                    ("gru_forward", "gru_backward", "attn_dec_fwd"))
    _all_persistent(phase, f"{what} generation", gen, ("gru_forward",))
    for name in ("ce_readout_fwd", "ce_readout_bwd"):
        if train.by_path[name] != {"wgmma": steps}:
            fail(phase, f"{what}: {name} by path {train.by_path[name]}")
    if set(gen.by_path["topk_lse_readout"]) != {"wgmma"}:
        fail(phase, f"{what}: K7 by path "
             f"{gen.by_path['topk_lse_readout']}")
    return train, gen


def frontdoor_demo(K, dev, card):
    """(a) The seqToseq demo copy through its ``main(argv)`` at the card
    arguments (bf16 policy), its launches split at the generation; its
    first 2 steps and its generation on the card against the CPU (f32);
    then ``python -m paddle_tpu_torch.demo.seqToseq.train`` in a fresh
    process.  Returns the parts' launches."""
    import io
    import statistics

    import torch

    from paddle_tpu_torch.demo.seqToseq import train as demo
    from paddle_tpu_torch.ops.numerics import compute_dtype_scope

    d = FRONTDOOR_DEMO
    steps = d["n"] // d["batch"]
    marks, out = {}, io.StringIO()
    with _generation_marks(marks), contextlib.redirect_stdout(out), \
            compute_dtype_scope("bfloat16"):
        K.reset_launch_counts()
        t0 = time.perf_counter()
        res = demo.main(_demo_args(d["n"], dev.type))
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        total = K.launch_counts()
    printed = out.getvalue()
    train, gen = demo_checks("frontdoor", "demo", res, printed, marks, total,
                             steps)
    losses, step_s = res["losses"], res["step_s"]
    words = res["words"]
    later = sum(int(b["trg_len"].sum()) for b in res["batches"][1:])
    print(f"frontdoor: demo seqToseq (python -m paddle_tpu_torch.demo."
          f"seqToseq.train {' '.join(_demo_args(d['n'], dev.type))}), bf16 "
          f"policy: {steps} steps at B={d['batch']}, costs "
          f"{[round(x, 4) for x in losses]}, median "
          f"{statistics.median(step_s) * 1e3:.2f} ms a step (first "
          f"{step_s[0] * 1e3:.2f} ms), {words / sum(step_s):.0f} target "
          f"words/s over the {steps} steps ({words} words), "
          f"{later / sum(step_s[1:]):.0f} over steps 2-{steps}; "
          f"generation of 4 sources at beam "
          f"{d['beam']} {marks['sec'] * 1e3:.2f} ms "
          f"({gen['topk_lse_readout']} decode steps), main() {sec:.2f} s; "
          f"card {card}", flush=True)
    del res
    torch.cuda.empty_cache()

    # the first 2 steps and the generation after them, card vs CPU, f32
    runs = {}
    with compute_dtype_scope("float32"):
        with contextlib.redirect_stdout(io.StringIO()):
            for side, where in (("card", dev.type), ("cpu", "cpu")):
                runs[side] = demo.main(_demo_args(FRONTDOOR_CHECK_N, where))
        c, p = runs["card"], runs["cpu"]
        d_loss = max(abs(a - b) / abs(b)
                     for a, b in zip(c["losses"], p["losses"]))
        print(f"frontdoor: demo, first {len(c['losses'])} steps card vs "
              f"CPU, f32: costs {c['losses']} vs {p['losses']} (max rel "
              f"diff {d_loss:.3e}, tol {TOL_TRAIN_LOSS})", flush=True)
        if len(c["losses"]) != 2 or d_loss > TOL_TRAIN_LOSS:
            fail("frontdoor", "demo: card and CPU costs disagree")
        b0 = c["batches"][0]

        def rescore_on(side, b, hyp):
            r = runs[side]
            return rescore(r["model"], r["params"], b0["src_ids"][b:b + 1],
                           b0["src_len"][b:b + 1], hyp)

        _search_agree("frontdoor", "demo --generate",
                      (c["tokens"], c["scores"]), (p["tokens"], p["scores"]),
                      rescore_on)
    del runs, c, p
    torch.cuda.empty_cache()

    # the demo as a user starts it
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.demo.seqToseq.train",
         *_demo_args(FRONTDOOR_CHECK_N, dev.type)], cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True,
        text=True, timeout=600)
    lines = [l for l in proc.stdout.splitlines() if " cost " in l]
    if proc.returncode != 0 or not lines:
        fail("frontdoor", f"demo in a fresh process: exit "
             f"{proc.returncode}, stdout {proc.stdout[-1500:]!r}, stderr "
             f"{proc.stderr[-3000:]!r}")
    print(f"frontdoor: python -m paddle_tpu_torch.demo.seqToseq.train --n "
          f"{FRONTDOOR_CHECK_N} in a fresh process: exit 0 in "
          f"{time.perf_counter() - t0:.2f} s, {lines}", flush=True)
    return {"demo_train": train, "demo_generate": gen}


def frontdoor_v2(K, dev, card):
    """(b) The v2 seqToseq script (``tests/torch_v2_seqtoseq.py``) through
    ``paddle.init`` / ``parameters.create`` / ``trainer.SGD`` /
    ``save_parameter_to_tar`` / ``infer`` at the WMT14 widths (bf16
    policy); the tar read back in a fresh process on the CPU; the first
    step's cost and the generation on the card against the CPU (f32); a
    zero-row ``infer``.  Returns the parts' launches."""
    import hashlib
    import io
    import shutil
    import statistics
    import tempfile

    import numpy as np
    import torch

    import paddle_tpu_torch.nn as nn
    import paddle_tpu_torch.v2 as paddle
    from paddle_tpu_torch.data import DataFeeder
    from paddle_tpu_torch.ops.numerics import compute_dtype_scope
    from paddle_tpu_torch.utils.flags import FLAGS

    if os.path.join(ROOT, "tests") not in sys.path:
        sys.path.insert(0, os.path.join(ROOT, "tests"))
    from torch_v2_seqtoseq import (FEEDING, v2_seqtoseq_generator,
                                   v2_seqtoseq_reader, v2_seqtoseq_trainer,
                                   v2_test_sources)

    V, B = FRONTDOOR_V2["V"], FRONTDOOR_V2_B
    steps = FRONTDOOR_V2_N // B
    beam, max_len = FRONTDOOR_V2_BEAM, FRONTDOOR_V2_MAX_LEN
    keep = FLAGS.device
    tmp = tempfile.mkdtemp(prefix="frontdoor_")
    try:
        with compute_dtype_scope("bfloat16"):
            assert paddle.init([f"--device={dev.type}"]) == []
            nn.reset_naming()
            cost = v2_seqtoseq_trainer(paddle, **FRONTDOOR_V2)
            t0 = time.perf_counter()
            params = paddle.parameters.create(cost, seed=SEED)
            t_create = time.perf_counter() - t0
            trainer = paddle.trainer.SGD(
                cost=cost, parameters=params,
                update_equation=paddle.optimizer.Adam(
                    learning_rate=FRONTDOOR_V2_LR))
            costs, step_s, mark = [], [], {}

            def handler(e):
                if isinstance(e, paddle.event.BeginIteration):
                    torch.cuda.synchronize()
                    mark["t"] = time.perf_counter()
                elif isinstance(e, paddle.event.EndIteration):
                    torch.cuda.synchronize()
                    step_s.append(time.perf_counter() - mark["t"])
                    costs.append(e.cost)

            K.reset_launch_counts()
            trainer.train(v2_seqtoseq_reader(paddle, V, FRONTDOOR_V2_N, B),
                          num_passes=1, event_handler=handler,
                          feeding=FEEDING)
            torch.cuda.synchronize()
            train = K.launch_counts()
        if len(costs) != steps or not np.isfinite(costs).all():
            fail("frontdoor", f"v2: costs {costs}")
        _only("frontdoor", "v2 training", train,
              {"gru_forward": 2 * steps, "gru_backward": 2 * steps})
        _all_persistent("frontdoor", "v2 training", train,
                        ("gru_forward", "gru_backward"))
        tar = os.path.join(tmp, "v2_seqtoseq.tar")
        t0 = time.perf_counter()
        with open(tar, "wb") as f:
            trainer.save_parameter_to_tar(f)
        t_tar = time.perf_counter() - t0
        digests = {k: [str(params[k].dtype), list(params[k].shape),
                       hashlib.sha256(np.ascontiguousarray(
                           params[k]).tobytes()).hexdigest()]
                   for k in params.names()}
        print(f"frontdoor: v2 seqToseq script (paddle.layer + "
              f"paddle.networks, recurrent_group decoder), bf16 policy: "
              f"parameters.create {t_create:.2f} s, {steps} Adam steps at "
              f"B={B} through trainer.SGD, costs "
              f"{[round(x, 4) for x in costs]}, median "
              f"{statistics.median(step_s) * 1e3:.2f} ms a step (first "
              f"{step_s[0] * 1e3:.2f} ms), save_parameter_to_tar "
              f"{t_tar:.2f} s ({os.path.getsize(tar)} bytes); card {card}",
              flush=True)
        del trainer
        torch.cuda.empty_cache()

        # the tar in a fresh process, on the CPU
        code = "\n".join([
            "import hashlib, json, sys",
            "import numpy as np",
            f"sys.path.insert(0, {os.path.join(ROOT, 'tests')!r})",
            "import paddle_tpu_torch.v2 as paddle",
            "from torch_v2_seqtoseq import v2_seqtoseq_trainer",
            "paddle.init(['--device=cpu'])",
            f"p = paddle.parameters.create(v2_seqtoseq_trainer(paddle, "
            f"**{FRONTDOOR_V2!r}))",
            f"p.from_tar(open({tar!r}, 'rb'))",
            "print(json.dumps({k: [str(p[k].dtype), list(p[k].shape), "
            "hashlib.sha256(np.ascontiguousarray(p[k]).tobytes())"
            ".hexdigest()] for k in p.names()}))"])
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                              env=dict(os.environ, PYTHONPATH=ROOT),
                              capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            fail("frontdoor", f"v2: the tar in a fresh process: exit "
                 f"{proc.returncode}, stderr {proc.stderr[-3000:]!r}")
        back = json.loads(proc.stdout.strip().splitlines()[-1])
        same = back == digests
        print(f"frontdoor: v2: the tar read back by parameters.from_tar in a "
              f"fresh process with --device=cpu "
              f"({time.perf_counter() - t0:.2f} s): {len(back)} arrays, "
              f"{'bit for bit the card' + chr(39) + 's' if same else 'DIFFER'}",
              flush=True)
        if not same:
            fail("frontdoor", "v2: the tar's arrays differ from the card's")

        # the generator from the tar, through paddle.infer
        nn.reset_naming()
        gen = v2_seqtoseq_generator(paddle, beam=beam, max_len=max_len,
                                    **FRONTDOOR_V2)
        gparams = paddle.parameters.create(gen)
        with open(tar, "rb") as f:
            gparams.from_tar(f)
        rows = v2_test_sources(paddle, V, FRONTDOOR_V2_SOURCES)
        with compute_dtype_scope("bfloat16"):
            paddle.infer(output_layer=gen, parameters=gparams,
                         input=rows[:2], field="id")           # warm-up
            torch.cuda.synchronize()
            K.reset_launch_counts()
            t0 = time.perf_counter()
            prob, ids = paddle.infer(output_layer=gen, parameters=gparams,
                                     input=rows, field=["prob", "id"])
            infer_s = time.perf_counter() - t0
            infer = K.launch_counts()
            K.reset_launch_counts()
            empty = paddle.infer(output_layer=gen, parameters=gparams,
                                 input=[], field=["prob", "id"])
            empty_launches = K.launch_counts()
        n = FRONTDOOR_V2_SOURCES
        if (ids.shape != (n, beam, max_len) or ids.dtype != np.int32
                or prob.shape != (n, beam) or not np.isfinite(prob).all()
                or not (prob[:, :-1] >= prob[:, 1:]).all()
                or ids.min() < 0 or ids.max() >= V):
            fail("frontdoor", f"v2: malformed infer: ids {ids.shape} "
                 f"{ids.dtype}, prob {prob.shape}")
        _only("frontdoor", "v2 infer", infer,
              {"gru_forward": 2, "topk_lse_logits": (1, max_len)})
        _all_persistent("frontdoor", "v2 infer", infer, ("gru_forward",))
        if any(empty_launches.values()) or [a.shape for a in empty] != [
                (0, beam), (0, beam, max_len)]:
            fail("frontdoor", f"v2: infer(input=[]): shapes "
                 f"{[a.shape for a in empty]}, launches "
                 f"{dict(empty_launches)}")
        print(f"frontdoor: v2: paddle.infer(field=['prob', 'id']) over the "
              f"beam_search layer (beam {beam}, max_length {max_len}, cut "
              f"from the reference demo's 250 to bound the phase's time), "
              f"{n} sources: {infer_s * 1e3:.2f} ms, "
              f"{infer['topk_lse_logits']} decode steps; infer(input=[]) -> "
              f"shapes {[a.shape for a in empty]}, no launch; card {card}",
              flush=True)

        # card vs CPU, f32: the first step's cost and the generation
        first = {}
        with compute_dtype_scope("float32"):
            for side, where in (("card", dev.type), ("cpu", "cpu")):
                paddle.init([f"--device={where}"])
                nn.reset_naming()
                c = v2_seqtoseq_trainer(paddle, **FRONTDOOR_V2)
                p = paddle.parameters.create(c, seed=SEED)
                if side == "cpu":
                    # the step's cost is its forward: no backward here
                    topo = nn.Topology(c, device="cpu")
                    rows1 = next(iter(v2_seqtoseq_reader(paddle, V, B, B)()))
                    kinds = {l.name: "ids_seq" for l in topo.data_layers}
                    feed = DataFeeder(kinds, FEEDING)(rows1)
                    with torch.no_grad():
                        outs, _ = topo.apply(
                            {k: torch.from_numpy(v) for k, v in
                             p.params.items()}, {}, feed, train=True)
                    first["cpu"] = outs[c.name].value.item()
                else:
                    got = []
                    paddle.trainer.SGD(
                        cost=c, parameters=p,
                        update_equation=paddle.optimizer.Adam(
                            learning_rate=FRONTDOOR_V2_LR)).train(
                        v2_seqtoseq_reader(paddle, V, B, B),
                        event_handler=lambda e: got.append(e.cost) if
                        isinstance(e, paddle.event.EndIteration) else None,
                        feeding=FEEDING)
                    first["card"] = got[0]
                del p
                torch.cuda.empty_cache()
            d = abs(first["card"] - first["cpu"]) / abs(first["cpu"])
            print(f"frontdoor: v2: first step's cost card vs CPU, f32: "
                  f"{first['card']:.7f} vs {first['cpu']:.7f} (rel diff "
                  f"{d:.3e}, tol {TOL_TRAIN_LOSS})", flush=True)
            if d > TOL_TRAIN_LOSS:
                fail("frontdoor", "v2: card and CPU first costs disagree")
            gens, outs_of = {}, {}
            src = DataFeeder({"source_language_word": "ids_seq"})(rows)
            for side, where in (("card", dev.type), ("cpu", "cpu")):
                paddle.init([f"--device={where}"])
                gens[side] = paddle.infer(output_layer=gen,
                                          parameters=gparams, input=rows,
                                          field=["id", "prob"])
                pt = {k: torch.from_numpy(v).to(where)
                      for k, v in gparams.params.items()}
                with torch.no_grad():
                    outs, _ = nn.Topology(gen, device=where).apply(
                        pt, {}, src, outputs=["enc", "enc_proj", "boot"])
                outs_of[side] = (outs, pt)

            def rescore_on(side, b, hyp):
                outs, pt = outs_of[side]
                with torch.no_grad():
                    return dsl_rescore(dslgen_step(outs, 1, slice(b, b + 1)),
                                       pt, outs["boot"].value[b:b + 1], hyp)

            _search_agree("frontdoor", "v2 infer", gens["card"], gens["cpu"],
                          rescore_on)
    finally:
        FLAGS.device = keep
        shutil.rmtree(tmp, ignore_errors=True)
    return {"v2_train": train, "v2_infer": infer}


def frontdoor_path(K, dev, card):
    """Phase 18: (a) the seqToseq demo copy, (b) the v2 script, (c) their
    launches by kernel and path, on their own line."""
    import torch

    t0 = time.perf_counter()
    launches = frontdoor_demo(K, dev, card)
    torch.cuda.empty_cache()
    launches.update(frontdoor_v2(K, dev, card))
    torch.cuda.empty_cache()
    print(json.dumps({"frontdoor_launches": {
        part: {n: {"launches": c, "by_path": counts.by_path[n]}
               for n, c in counts.items() if c}
        for part, counts in launches.items()}}), flush=True)
    print(f"frontdoor: phase seconds {time.perf_counter() - t0:.2f}; card "
          f"{card}", flush=True)
    return launches


# ---------------------------------------------------------------------------
# phase 19: the data front door — PyDataProvider2's @provider over a real-
# format aclImdb tarball into lstm_benchmark_net, and the seqToseq demo copy
# over a real-format wmt14.tgz, both read from files this phase writes
# ---------------------------------------------------------------------------

#: part (a): the aclImdb_v1.tar.gz written (reviews a split, words a review,
#: the distinct words drawn from), the provider's shuffle pool, passes, and
#: the steps held card vs CPU; bench.py:382-425's lstm_b64h256 shape
DATAIO_IMDB_N = {"train": 2048, "test": 512}
DATAIO_IMDB_LEN, DATAIO_IMDB_WORDS = (50, 300), 40000
DATAIO_POOL, DATAIO_PASSES, DATAIO_CHECK_STEPS = 512, 2, 2
#: part (b): the wmt14.tgz written (pairs a split, words a side, pairs a
#: split with a side of 81-90 words, which the parser drops, and words of
#: each side outside its dictionary, which map to <unk>)
DATAIO_WMT_N = {"train": 2048, "test": 256}
DATAIO_WMT_LEN, DATAIO_WMT_LONG, DATAIO_WMT_OOV = (10, 60), 8, 500
#: the kernels line's rows that phase 19's parts launch, and their library
DATAIO_ROWS = {
    "lstm_forward": ("lstm_forward", ("imdb_test",)),
    f"lstm_forward_residuals_b{TEXTCLF_B}h256": ("lstm_forward",
                                                 ("imdb_train",)),
    f"lstm_backward_b{TEXTCLF_B}h256": ("lstm_backward", ("imdb_train",)),
    "gru_forward": ("gru_forward", ("wmt14_generate",)),
    "gru_forward_residuals": ("gru_forward", ("wmt14_train",)),
    "gru_backward": ("gru_backward", ("wmt14_train",)),
    "attn_dec_fwd": ("attn_dec_fwd", ("wmt14_train",)),
    "attn_dec_bwd": ("attn_dec_bwd", ("wmt14_train",)),
    "ce_readout_fwd": ("ce_readout_fwd", ("wmt14_train",)),
    "ce_readout_bwd": ("ce_readout_bwd", ("wmt14_train",)),
    "topk_lse_readout": ("topk_lse_readout", ("wmt14_generate",)),
}


@contextlib.contextmanager
def data_home(path: str):
    """``$PADDLE_TPU_DATA_HOME`` set to ``path`` inside the block."""
    old = os.environ.get("PADDLE_TPU_DATA_HOME")
    os.environ["PADDLE_TPU_DATA_HOME"] = path
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("PADDLE_TPU_DATA_HOME", None)
        else:
            os.environ["PADDLE_TPU_DATA_HOME"] = old


def _tar_add(tf, name: str, payload: bytes) -> None:
    import io
    import tarfile

    info = tarfile.TarInfo(name)
    info.size = len(payload)
    tf.addfile(info, io.BytesIO(payload))


def dataio_write_imdb(home: str) -> dict:
    """``home/imdb/aclImdb_v1.tar.gz`` in aclImdb's layout
    (aclImdb/<split>/<pos|neg>/<id>_<stars>.txt), reviews of
    DATAIO_IMDB_LEN words from DATAIO_IMDB_WORDS distinct ones, drawn from
    ``RandomState(SEED)``; each class draws a tenth of its words from its
    own 500.  -> the distinct words of the train split, by split the
    reviews written."""
    import tarfile

    import numpy as np

    rng = np.random.RandomState(SEED)
    words = np.array([f"w{i:05d}" for i in range(DATAIO_IMDB_WORDS)])
    seen, written = set(), {}
    os.makedirs(os.path.join(home, "imdb"))
    with tarfile.open(os.path.join(home, "imdb", "aclImdb_v1.tar.gz"),
                      "w:gz") as tf:
        for split, n in DATAIO_IMDB_N.items():
            written[split] = n
            for i in range(n):
                pos = i % 2
                L = rng.randint(DATAIO_IMDB_LEN[0], DATAIO_IMDB_LEN[1] + 1)
                ids = rng.randint(0, DATAIO_IMDB_WORDS, L)
                own = rng.rand(L) < 0.1
                ids[own] = rng.randint(0, 500, int(own.sum())) + 500 * pos
                toks = words[ids]
                if split == "train":
                    seen.update(toks.tolist())
                text = (toks[0].upper() + " " + " ".join(toks[1:]) + ".\n")
                sense = "pos" if pos else "neg"
                _tar_add(tf, f"aclImdb/{split}/{sense}/{i}_{7 if pos else 2}"
                         f".txt", text.encode())
    return {"distinct": len(seen), "written": written}


def dataio_imdb_provider(V: int, seed: int):
    """The PyDataProvider2 ``@provider`` over ``datasets.imdb`` (its real
    branch when the data home holds the tarball): dict slots named as
    ``lstm_benchmark_net``'s data layers, a shuffle pool, the pass cache,
    ``random.Random(seed)``; each file name is a split.  -> (the provider
    factory, the list its generator appends each split it reads to)."""
    import random

    from paddle_tpu_torch.data import datasets
    from paddle_tpu_torch.data.provider import (CacheType, integer_value,
                                                integer_value_sequence,
                                                provider)

    reads = []

    @provider(input_types={"words": integer_value_sequence(V),
                           "label": integer_value(2)},
              pool_size=DATAIO_POOL, cache=CacheType.CACHE_PASS_IN_MEM,
              rng=random.Random(seed))
    def imdb_rows(settings, split):
        reads.append(split)
        for ids, label in datasets.imdb(split, vocab_size=V)():
            yield {"words": ids, "label": label}

    return imdb_rows, reads


class _Timed:
    """Host seconds spent inside a reader's ``next`` and a feeder's
    calls."""

    def __init__(self):
        self.reader_s = self.feeder_s = 0.0
        self.feeder_last = 0.0

    def reader(self, creator):
        def read():
            it = iter(creator())
            while True:
                t0 = time.perf_counter()
                row = next(it, None)
                self.reader_s += time.perf_counter() - t0
                if row is None:
                    return
                yield row
        return read

    def feeder(self, feeder):
        def feed(rows):
            t0 = time.perf_counter()
            out = feeder(rows)
            self.feeder_last = time.perf_counter() - t0
            self.feeder_s += self.feeder_last
            return out
        return feed


def dataio_imdb(K, dev, card, home: str):
    """(a) ``lstm_benchmark_net`` at lstm_b64h256 (bf16) through
    ``SGDTrainer(Adam(1e-3)).train`` for DATAIO_PASSES passes fed by the
    provider (its second pass replays the cache) through its ``feeder()``
    with the native pad (max_len T), then a test pass; its first
    DATAIO_CHECK_STEPS steps card vs CPU at f32 on the same shuffled
    order.  -> the parts' launches."""
    import statistics

    import numpy as np
    import torch

    import paddle_tpu_torch.data as data
    import paddle_tpu_torch.nn as nn
    from paddle_tpu_torch.models import lstm_benchmark_net
    from paddle_tpu_torch.ops.numerics import compute_dtype_scope
    from paddle_tpu_torch.param import Adam
    from paddle_tpu_torch.trainer import SGDTrainer
    from paddle_tpu_torch.trainer import events as ev

    V, B, T, H = TEXTCLF_VOCAB, TEXTCLF_B, TEXTCLF_T, 256
    t0 = time.perf_counter()
    wrote = dataio_write_imdb(home)
    write_s = time.perf_counter() - t0

    def net():
        nn.reset_naming()
        return lstm_benchmark_net(V, emb_dim=TEXTCLF_EMB, hid_dim=H,
                                  num_layers=TEXTCLF_LAYERS)[0]

    def feeder_of(dp):
        return dp.feeder(max_len=T, buckets=(T,))

    with data_home(home), compute_dtype_scope("bfloat16"):
        make, reads = dataio_imdb_provider(V, SEED)
        t0 = time.perf_counter()
        dp = make(["train"])
        tdp = make(["test"], is_train=False)
        make_s = time.perf_counter() - t0
        timed, feeder = _Timed(), feeder_of(dp)
        tr = SGDTrainer(net(), Adam(learning_rate=1e-3), seed=SEED,
                        device=dev)
        losses, step_s, mark = [], [], {}

        def handler(e):
            if isinstance(e, ev.BeginIteration):
                if dev.type == "cuda":
                    torch.cuda.synchronize()
                mark["t"] = time.perf_counter()
            elif isinstance(e, ev.EndIteration):
                if dev.type == "cuda":
                    torch.cuda.synchronize()
                step_s.append(time.perf_counter() - mark["t"]
                              - timed.feeder_last)
                losses.append(e.cost)

        K.reset_launch_counts()
        t0 = time.perf_counter()
        tr.train(timed.reader(data.batch(dp.reader(), B)),
                 num_passes=DATAIO_PASSES, event_handler=handler,
                 feeder=timed.feeder(feeder))
        if dev.type == "cuda":
            torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        train = K.launch_counts()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        result = tr.test(data.batch(tdp.reader(), B),
                         feeder=feeder_of(tdp))
        test_s = time.perf_counter() - t0
        test = K.launch_counts()
    steps = sum(DATAIO_IMDB_N["train"] // B for _ in range(DATAIO_PASSES))
    n_test = DATAIO_IMDB_N["test"] // B
    if (len(losses) != steps or not np.isfinite(losses).all()
            or not np.isfinite(result["cost"])):
        fail("dataio", f"imdb: {len(losses)} costs (want {steps}), test "
             f"{result}")
    if reads != ["train", "test"]:
        fail("dataio", f"imdb: the provider read {reads}: the second pass "
             f"must replay the cache")
    if wrote["distinct"] < V:
        fail("dataio", f"imdb: {wrote['distinct']} distinct train words, "
             f"fewer than the {V} the dictionary takes")
    L = TEXTCLF_LAYERS
    _only("dataio", "imdb training", train, {
        "lstm_forward": L * steps, "lstm_backward": L * steps})
    _only("dataio", "imdb test pass", test, {"lstm_forward": L * n_test})
    _all_persistent("dataio", "imdb training", train,
                    ("lstm_forward", "lstm_backward"))
    _all_persistent("dataio", "imdb test pass", test, ("lstm_forward",))
    med = statistics.median(step_s)
    print(f"dataio: imdb (a): aclImdb_v1.tar.gz written in {write_s:.2f} s "
          f"({wrote['written']} reviews of {DATAIO_IMDB_LEN[0]}-"
          f"{DATAIO_IMDB_LEN[1]} words, {wrote['distinct']} distinct train "
          f"words), @provider(integer_value_sequence({V}), integer_value(2),"
          f" should_shuffle, pool_size={DATAIO_POOL}, CACHE_PASS_IN_MEM) "
          f"-> feeder(max_len={T}, native pad) -> SGDTrainer(Adam(1e-3)) "
          f"on lstm_benchmark_net({V}, emb {TEXTCLF_EMB}, hid {H}, "
          f"{L} layers), bf16, B={B}: {DATAIO_PASSES} passes, {steps} "
          f"steps, costs first {[round(x, 4) for x in losses[:3]]} last "
          f"{[round(x, 4) for x in losses[-3:]]}, median "
          f"{med * 1e3:.2f} ms a step (min {min(step_s) * 1e3:.2f}, max "
          f"{max(step_s) * 1e3:.2f}), {B / med:.1f} samples/s; host s: "
          f"provider set-up {make_s:.3f}, reader+provider {timed.reader_s:.3f}"
          f", feeder {timed.feeder_s:.3f}, steps {sum(step_s):.3f} of "
          f"train() {train_s:.3f}; pad waste {feeder.pad_waste:.4f} "
          f"({feeder.tokens_real} of {feeder.tokens_padded} tokens real); "
          f"test pass {n_test} batches {test_s * 1e3:.2f} ms, cost "
          f"{result['cost']:.4f}; card {card}", flush=True)
    del tr
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # the first steps card vs CPU at f32, each from a provider seeded the
    # same (the same shuffled order)
    got, batches = {}, {}
    with data_home(home), compute_dtype_scope("float32"):
        for side, where in (("card", dev.type), ("cpu", "cpu")):
            make, _ = dataio_imdb_provider(V, SEED)
            sdp = make(["train"])
            seen, costs = [], []
            sfeed = feeder_of(sdp)

            def keep(rows, seen=seen, sfeed=sfeed):
                feed = sfeed(rows)
                seen.append(feed["words"][0].copy())
                return feed

            tr = SGDTrainer(net(), Adam(learning_rate=1e-3), seed=SEED,
                            device=where)
            tr.train(data.firstn(data.batch(sdp.reader(), B),
                                 DATAIO_CHECK_STEPS), feeder=keep,
                     event_handler=lambda e, costs=costs: costs.append(
                         e.cost) if isinstance(e, ev.EndIteration) else None)
            got[side], batches[side] = costs, seen
            del tr
    same = all(np.array_equal(a, b)
               for a, b in zip(batches["card"], batches["cpu"]))
    d = max(abs(a - b) / abs(b) for a, b in zip(got["card"], got["cpu"]))
    print(f"dataio: imdb (a): first {DATAIO_CHECK_STEPS} steps card vs CPU,"
          f" f32, the same shuffled batches ({'identical' if same else 'DIFFER'}"
          f"): costs {got['card']} vs {got['cpu']} (max rel diff {d:.3e}, tol "
          f"{TOL_TRAIN_LOSS})", flush=True)
    if (not same or len(got["card"]) != DATAIO_CHECK_STEPS
            or d > TOL_TRAIN_LOSS):
        fail("dataio", "imdb: card and CPU costs disagree")
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return {"imdb_train": train, "imdb_test": test}


def dataio_write_wmt14(home: str, V: int) -> dict:
    """``home/wmt14/wmt14.tgz``: src.dict and trg.dict of ``V`` lines each
    (<s>, <e>, <unk>, then the words), train/train and test/test of
    tab-separated pairs of DATAIO_WMT_LEN words drawn from
    ``RandomState(SEED + 1)`` (DATAIO_WMT_OOV words of each side outside its
    dictionary), DATAIO_WMT_LONG pairs a split with a side of 81-90 words.
    -> by split the rows the parser must give: (src ids framed by <s> and
    <e>, [<s>] + target ids, target ids + [<e>]), long pairs left out."""
    import tarfile

    import numpy as np

    rng = np.random.RandomState(SEED + 1)
    vocab = {side: [f"{side}{i:05d}" for i in range(V - 3)]
             for side in ("s", "t")}
    pool = {side: np.array(vocab[side] + [f"{side}oov{i}" for i in
                                          range(DATAIO_WMT_OOV)])
            for side in ("s", "t")}
    ids = {side: {w: i + 3 for i, w in enumerate(vocab[side])}
           for side in ("s", "t")}
    want = {}
    os.makedirs(os.path.join(home, "wmt14"))
    with tarfile.open(os.path.join(home, "wmt14", "wmt14.tgz"), "w:gz") as tf:
        for side, name in (("s", "src"), ("t", "trg")):
            _tar_add(tf, f"wmt14/{name}.dict", ("\n".join(
                ["<s>", "<e>", "<unk>"] + vocab[side]) + "\n").encode())
        for split, n in DATAIO_WMT_N.items():
            long_at = set(rng.choice(n, DATAIO_WMT_LONG, replace=False))
            lines, rows = [], []
            for i in range(n):
                sides = {}
                for j, side in enumerate(("s", "t")):
                    lo, hi = DATAIO_WMT_LEN
                    if i in long_at and j == i % 2:
                        lo, hi = 81, 90
                    sides[side] = pool[side][rng.randint(
                        0, len(pool[side]), rng.randint(lo, hi + 1))]
                lines.append(" ".join(sides["s"]) + "\t"
                             + " ".join(sides["t"]))
                if i in long_at:
                    continue
                src = [0] + [ids["s"].get(w, 2) for w in sides["s"]] + [1]
                trg = [ids["t"].get(w, 2) for w in sides["t"]]
                rows.append((src, [0] + trg, trg + [1]))
            want[split] = rows
            member = "train/train" if split == "train" else "test/test"
            _tar_add(tf, f"wmt14/{member}",
                     ("\n".join(lines) + "\n").encode())
    return want


def dataio_wmt14(K, dev, card, home: str):
    """(b) the seqToseq demo copy's ``main`` at phase 18's arguments over
    the wmt14.tgz written here: the rows parsed against what was written,
    the real branch through ``formats.iter_wmt14``, then K1-K7 exactly as
    phase 18.  -> the parts' launches."""
    import io
    import statistics

    import numpy as np
    import torch

    from paddle_tpu_torch.data import datasets, formats
    from paddle_tpu_torch.demo.seqToseq import train as demo
    from paddle_tpu_torch.ops.numerics import compute_dtype_scope

    d = FRONTDOOR_DEMO
    t0 = time.perf_counter()
    want = dataio_write_wmt14(home, d["dict"])
    write_s = time.perf_counter() - t0
    parsed, reads, read_s = {}, [], []
    orig_iter, orig_make = formats.iter_wmt14, demo.make_batches

    def counted_iter(*a, **kw):
        reads.append(a[1])
        return orig_iter(*a, **kw)

    def timed_make(*a, **kw):
        t = time.perf_counter()
        out = orig_make(*a, **kw)
        read_s.append(time.perf_counter() - t)
        return out

    formats.iter_wmt14, demo.make_batches = counted_iter, timed_make
    try:
        with data_home(home):
            t0 = time.perf_counter()
            for split in ("train", "test"):
                parsed[split] = list(datasets.wmt14(
                    split, dict_size=d["dict"])())
            parse_s = time.perf_counter() - t0
            for split in ("train", "test"):
                if parsed[split] != want[split]:
                    bad = next((i for i, (a, b) in enumerate(zip(
                        parsed[split], want[split])) if a != b), None)
                    fail("dataio", f"wmt14 {split}: {len(parsed[split])} "
                         f"rows parsed, {len(want[split])} written; first "
                         f"difference at row {bad}")
            reads.clear()
            steps = d["n"] // d["batch"]
            marks, out = {}, io.StringIO()
            with _generation_marks(marks), \
                    contextlib.redirect_stdout(out), \
                    compute_dtype_scope("bfloat16"):
                K.reset_launch_counts()
                t0 = time.perf_counter()
                res = demo.main(_demo_args(d["n"], dev.type))
                if dev.type == "cuda":
                    torch.cuda.synchronize()
                sec = time.perf_counter() - t0
                total = K.launch_counts()
    finally:
        formats.iter_wmt14, demo.make_batches = orig_iter, orig_make
    if reads != ["train/train"]:
        fail("dataio", f"wmt14: the demo read {reads} through "
             f"formats.iter_wmt14, not train/train once")
    train, gen = demo_checks("dataio", "wmt14 demo", res, out.getvalue(),
                             marks, total, steps)
    rows = want["train"][:d["n"]]
    first = res["batches"][0]
    for j, (src, trg_in, _) in enumerate(rows[:d["batch"]]):
        S, T = first["src_ids"].shape[1], first["trg_in"].shape[1]
        if (first["src_ids"][j, :first["src_len"][j]].tolist() != src[:S]
                or first["trg_in"][j, :first["trg_len"][j]].tolist()
                != trg_in[:T]):
            fail("dataio", f"wmt14: the demo's first batch row {j} is not "
                 f"the written pair")
    real = sum(int(b["src_len"].sum() + b["trg_len"].sum())
               for b in res["batches"])
    padded = sum(b["src_ids"].size + b["trg_in"].size
                 for b in res["batches"])
    step_s, words = res["step_s"], res["words"]
    n_long = sum(DATAIO_WMT_N.values()) - len(want["train"]) - len(
        want["test"])
    print(f"dataio: wmt14 (b): wmt14.tgz written in {write_s:.2f} s (dicts "
          f"of {d['dict']} lines, {DATAIO_WMT_N} pairs of "
          f"{DATAIO_WMT_LEN[0]}-{DATAIO_WMT_LEN[1]} words, {n_long} with a "
          f"side past 80 tokens), parsed through formats.iter_wmt14 in "
          f"{parse_s:.2f} s: {len(parsed['train'])} + {len(parsed['test'])} "
          f"rows equal to the written pairs (<s>/<e> framing, <unk> for "
          f"out-of-dictionary words, the long pairs dropped); the demo "
          f"(python -m paddle_tpu_torch.demo.seqToseq.train "
          f"{' '.join(_demo_args(d['n'], dev.type))}), bf16 policy: "
          f"{steps} steps, costs {[round(x, 4) for x in res['losses']]}, "
          f"median {statistics.median(step_s) * 1e3:.2f} ms a step (first "
          f"{step_s[0] * 1e3:.2f}), {words / sum(step_s):.0f} target "
          f"words/s ({words} words); host s: reader (make_batches: tgz "
          f"read, parse, pad) {read_s[0]:.3f}, steps {sum(step_s):.3f}, "
          f"main() {sec:.2f}; pad waste {1 - real / padded:.4f} ({real} of "
          f"{padded} tokens real, source clipped at 32); generation "
          f"{marks['sec'] * 1e3:.2f} ms ({gen['topk_lse_readout']} decode "
          f"steps); card {card}", flush=True)
    if not np.isfinite(res["scores"]).all():
        fail("dataio", "wmt14: generation scores not finite")
    del res
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return {"wmt14_train": train, "wmt14_generate": gen}


def dataio_path(K, dev, card):
    """Phase 19: ``native_available()``, (a) the provider-fed textclf
    training over a real-format aclImdb tarball, (b) the seqToseq demo over
    a real-format wmt14.tgz, (c) their launches on their own line."""
    import shutil
    import tempfile

    from paddle_tpu_torch.data import native

    t0 = time.perf_counter()
    ok = native.native_available()
    print(f"dataio: native_available() {ok} ({native.library_path()}); "
          f"{_gxx()}", flush=True)
    if not ok:
        fail("dataio", f"the native data core did not load: "
             f"{native.build_error()}")
    home = tempfile.mkdtemp(prefix="dataio_home_")
    try:
        launches = dataio_imdb(K, dev, card, home)
        launches.update(dataio_wmt14(K, dev, card, home))
    finally:
        shutil.rmtree(home, ignore_errors=True)
    print(json.dumps({"dataio_launches": {
        part: {n: {"launches": c, "by_path": counts.by_path[n]}
               for n, c in counts.items() if c}
        for part, counts in launches.items()}}), flush=True)
    print(f"dataio: phase seconds {time.perf_counter() - t0:.2f}; card "
          f"{card}", flush=True)
    return launches


# ---------------------------------------------------------------------------
# phase 20: continuous delivery — train, scrub and publish, hot reload under
# load, a warm boot from the publish dir's compile cache, the fleet
# ---------------------------------------------------------------------------

#: part (a): batches a pass of the trainer's 2 passes (B=64, T=100); the
#: serving bucket bound; part (b): the pool of distinct requests (1-4 rows,
#: lengths 20-100), closed-loop client threads (each sends at least
#: DELIVERY_POOL / DELIVERY_CLIENTS and keeps going until the reloads are
#: done), the probation window in requests; part (c): the CLI smoke's
#: request count; part (d): the victim tenant's requests, the canary's
#: share and the requests it is given; the card-vs-CPU tolerance
DELIVERY_PASS_BATCHES, DELIVERY_MAX_BATCH = 3, 8
DELIVERY_POOL, DELIVERY_CLIENTS, DELIVERY_PROBATION = 192, 8, 16
DELIVERY_SMOKE, DELIVERY_FLEET_SMOKE = 8, 16
DELIVERY_VICTIM, DELIVERY_CANARY_PCT, DELIVERY_CANARY_N = 24, 10.0, 200
TOL_DELIVERY_CPU = 2e-3
#: the kernels line's rows that phase 20's parts launch, and their library
DELIVERY_ROWS = {
    "lstm_forward": ("lstm_forward", ("reload", "fleet")),
    f"lstm_forward_residuals_b{TEXTCLF_B}h256": ("lstm_forward", ("train",)),
    f"lstm_backward_b{TEXTCLF_B}h256": ("lstm_backward", ("train",)),
}


@contextlib.contextmanager
def flags_set(**values):
    """``FLAGS`` fields set inside the block, restored after it."""
    from paddle_tpu_torch.utils.flags import FLAGS

    old = {k: getattr(FLAGS, k) for k in values}
    for k, v in values.items():
        setattr(FLAGS, k, v)
    try:
        yield
    finally:
        for k, v in old.items():
            setattr(FLAGS, k, v)


def _pct(xs, q: float) -> float:
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(q * len(xs)))] if xs else float("nan")


def delivery_train(K, dev, card, root):
    """Part (a): ``lstm_benchmark_net`` at lstm_b64h256 (bf16) trained 2
    passes by ``SGDTrainer.train`` with ``--save_dir``, ``--scrub_every_s``
    and ``--publish_every=1`` (versions 1 and 2, each primed into the
    publish dir's compile cache); one more step saved as pass 2 and a
    NaN-poisoned copy as pass 3 for part (b); a pass the scrubber has not
    verified refused typed; an int8 and an f32 bundle of the inference
    graph published into a fleet root for part (d).  -> (trainer, logits
    layer, paths, launches)."""
    import json as _json
    import zipfile

    import torch

    import paddle_tpu_torch.nn as nn
    from paddle_tpu_torch.models import lstm_benchmark_net
    from paddle_tpu_torch.param import Adam
    from paddle_tpu_torch.publish import (PublishRefused, latest_version,
                                          model_publish_dir,
                                          publish_from_checkpoints,
                                          read_version_manifest,
                                          version_dir)
    from paddle_tpu_torch.resilience.integrity import scrub_paths
    from paddle_tpu_torch.trainer import SGDTrainer

    save, pub = os.path.join(root, "ckpt"), os.path.join(root, "pub")
    fleet_root = os.path.join(root, "fleet")
    nn.reset_naming()
    cost, logits = lstm_benchmark_net(TEXTCLF_VOCAB, emb_dim=TEXTCLF_EMB,
                                      hid_dim=256,
                                      num_layers=TEXTCLF_LAYERS)
    tr = SGDTrainer(cost, Adam(learning_rate=1e-3), seed=SEED, device=dev)
    feeds = [textclf_feed(TEXTCLF_B, TEXTCLF_T, SEED + 100 + i)
             for i in range(DELIVERY_PASS_BATCHES)]
    K.reset_launch_counts()
    t0 = time.perf_counter()
    with flags_set(save_dir=save, publish_dir=pub, publish_every=1,
                   scrub_every_s=3600.0, saving_period=1):
        tr.train(lambda: iter(feeds), num_passes=2)
    train_s = time.perf_counter() - t0
    launches = K.launch_counts()
    steps = 2 * DELIVERY_PASS_BATCHES
    # K9r and K10 twice a step; each publish's warm step runs K9 (twice a
    # batch bucket: 1, 2, 4, 8) on the inference path of the new bundle
    warm = 2 * 4 * 2
    _launch_check("delivery", "train", launches,
                  {"lstm_forward": 2 * steps + warm,
                   "lstm_backward": 2 * steps})
    manifests = [read_version_manifest(version_dir(pub, v)) for v in (1, 2)]
    with open(os.path.join(save, "scrub.json")) as f:
        tip = _json.load(f)["latest_verified_pass"]
    print(f"delivery: lstm_b{TEXTCLF_B}h256 SGDTrainer.train 2 passes of "
          f"{DELIVERY_PASS_BATCHES} steps with --publish_every=1 and the "
          f"scrubber in {train_s:.2f} s; versions {latest_version(pub)} "
          f"from passes {[m['pass_id'] for m in manifests]}, scrub tip "
          f"{tip}; launches {dict((n, c) for n, c in launches.items() if c)}"
          f" by path {_launched(launches)} [{card}]", flush=True)
    if (latest_version(pub) != 2 or [m["pass_id"] for m in manifests]
            != [0, 1] or tip != 1):
        fail("delivery", f"publish_every: versions {latest_version(pub)}, "
             f"manifests {manifests}, scrub tip {tip}")
    # the checkpoints part (b) publishes: one more step (pass 2, v3) and a
    # NaN-poisoned copy of it (pass 3)
    tr.train_batch(textclf_feed(TEXTCLF_B, TEXTCLF_T, SEED + 200))
    tr.save(save, 2)
    good = tr.params
    tr.params = {k: torch.full_like(v, float("nan")) for k, v in good.items()}
    tr.save(save, 3)
    tr.params = good
    with open(os.path.join(save, "scrub.json"), "w") as f:
        _json.dump({"latest_verified_pass": 1, "passes": {}}, f)
    refused = None
    try:
        publish_from_checkpoints(pub, tr.topology, save, pass_id=2,
                                 device=dev)
        fail("delivery", "an unverified pass was published")
    except PublishRefused as e:
        refused = e.reason
        if e.reason != "pass_not_verified":
            fail("delivery", f"unverified pass refused as {e.reason!r}")
    report = scrub_paths([save], quarantine=True)
    infer_topo = nn.Topology(logits, device=dev)
    t0 = time.perf_counter()
    times = {}
    q8 = publish_from_checkpoints(model_publish_dir(fleet_root,
                                                    "textclf_int8"),
                                  infer_topo, save, pass_id=1,
                                  quantize="int8", device=dev,
                                  timings=times)
    int8_s = time.perf_counter() - t0
    f32 = publish_from_checkpoints(model_publish_dir(fleet_root, "textclf"),
                                   infer_topo, save, pass_id=1, device=dev)
    with zipfile.ZipFile(os.path.join(q8, "model.ptz")) as z:
        gate = _json.loads(z.read("manifest.json"))["quantize"]
    print(f"delivery: pass 2 before its scrub refused as {refused!r}; scrub "
          f"checked {report.checked}, tip {report.latest_verified}; int8 "
          f"publish of the inference graph in {int8_s:.2f} s (merge "
          f"{times['merge_s']:.2f}, load {times['load_s']:.2f}, warm "
          f"{times['warm_s']:.2f}), gate max_abs_err {gate['max_abs_err']} "
          f"<= tol {gate['tol']} [{card}]", flush=True)
    if report.latest_verified.get(save) != 3 or not (
            0 < gate["max_abs_err"] <= gate["tol"]):
        fail("delivery", f"scrub {report.latest_verified}, int8 gate {gate}")
    return tr, logits, {"save": save, "pub": pub, "fleet": fleet_root,
                        "f32": f32, "int8": q8}, launches


def _closed_loop(srv, pool, stop=None):
    """DELIVERY_CLIENTS threads, each sending its share of ``pool`` in turn
    (client c takes requests c, c + n, ...) closed loop, and going on round
    its share until ``stop`` is set.  -> (records (client, index, submit,
    reply time, reply or exception), wall seconds)."""
    import threading

    records, lock = [], threading.Lock()

    def client(c):
        mine = list(range(c, len(pool), DELIVERY_CLIENTS))
        k = 0
        while k < len(mine) or (stop is not None and not stop.is_set()):
            i = mine[k % len(mine)]
            t0 = time.perf_counter()
            try:
                out = srv.submit(pool[i]).result(120)
            except Exception as e:  # noqa: BLE001 — counted as a failure
                out = e
            with lock:
                records.append((c, i, t0, time.perf_counter(), out))
            k += 1

    threads = [threading.Thread(target=client, args=(c,),
                                name=f"delivery-client-{c}", daemon=True)
               for c in range(DELIVERY_CLIENTS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    return threads, records, t0


def delivery_reload(K, dev, card, tr, logits, paths):
    """Part (b): a bucket-mode ``InferenceServer`` booted from v1 through
    ``load_published`` with the publish dir's compile cache; closed-loop
    clients over DELIVERY_POOL requests while the ``HotSwapManager`` swaps
    in v2 and then v3, published from pass 2 during the load; every reply
    bit-equal to one version's solo ``infer``, versions moving forward per
    client, nothing dropped, failed or stranded; the same requests again
    without reloads; then a corrupt v4 skipped and a NaN-poisoned v5
    rolled back within probation.  -> launches of the loaded window."""
    import threading

    import numpy as np

    from paddle_tpu_torch.config import load_inference_model
    from paddle_tpu_torch.publish import (publish_cache_dir,
                                          publish_from_checkpoints,
                                          version_dir)
    from paddle_tpu_torch.resilience import chaos
    from paddle_tpu_torch.serving import (InferenceFailed, InferenceServer,
                                          HotSwapManager, load_published)

    pub, save = paths["pub"], paths["save"]
    pool = deploy_requests(SEED + 300)[:DELIVERY_POOL]
    while len(pool) < DELIVERY_POOL:
        pool += deploy_requests(SEED + 301 + len(pool))
    pool = pool[:DELIVERY_POOL]
    name = logits.name
    dev_arg = None if dev.type == "cuda" else dev
    model, info, v = load_published(pub, max_version=1, device=dev_arg)
    warm = [{"words": (np.full((1, t), 3, np.int32),
                       np.asarray([t], np.int32))}
            for t in (DEPLOY_LEN[0], 64, DEPLOY_LEN[1])]
    srv = InferenceServer(model, outputs=[name],
                          max_batch=DELIVERY_MAX_BATCH, batch_delay_ms=2.0,
                          max_queue=4 * DELIVERY_POOL,
                          default_deadline_ms=0.0)
    t0 = time.perf_counter()
    srv.start(warmup_feed=warm, compile_cache=publish_cache_dir(pub))
    boot_s = time.perf_counter() - t0
    mgr = HotSwapManager(srv, pub, probation_requests=DELIVERY_PROBATION)
    mgr.attach_current(v, info)
    stop = threading.Event()
    try:
        hz0 = srv.healthz()
        K.reset_launch_counts()
        threads, records, t_start = _closed_loop(srv, pool, stop)
        swaps, times = [], {}

        def settle(version):
            deadline = time.perf_counter() + 120
            while time.perf_counter() < deadline:
                act = mgr.poll()
                if act and act["action"] == "swapped":
                    swaps.append(act)
                if mgr.current_version == version and not mgr.in_probation:
                    return
                time.sleep(0.002)
            fail("delivery", f"v{version} not committed (at "
                 f"v{mgr.current_version}, rejected {mgr.rejected})")

        settle(2)
        t_publish = time.perf_counter()
        publish_from_checkpoints(pub, tr.topology, save, pass_id=2,
                                 device=dev, timings=times)
        publish_s = time.perf_counter() - t_publish
        settle(3)
        stop.set()
        for t in threads:
            t.join(300)
        wall = time.perf_counter() - t_start
        launches = K.launch_counts()
        hz1 = srv.healthz()
        # each version's solo replies on the pool
        solo = {}
        for ver in (1, 2, 3):
            m = load_inference_model(
                os.path.join(version_dir(pub, ver), "model.ptz"),
                device=dev_arg)
            solo[ver] = [m.infer(f, outputs=[name])[name] for f in pool]
            del m
        errors = [r for r in records if isinstance(r[4], Exception)]
        answered, unmatched, backwards = {}, [], 0
        last = {}
        for c, i, ts, te, out in sorted(records, key=lambda r: r[2]):
            if isinstance(out, Exception):
                continue
            ks = [ver for ver in (1, 2, 3)
                  if np.array_equal(out[name], solo[ver][i])]
            if len(ks) != 1:
                unmatched.append((c, i, ks))
                continue
            answered[ks[0]] = answered.get(ks[0], 0) + 1
            backwards += ks[0] < last.get(c, 0)
            last[c] = ks[0]
        lat = [(te - ts) * 1e3 for _, _, ts, te, _ in records]
        batches = hz1["counters"]["batches"] - hz0["counters"]["batches"]
        threads_by = launches.by_thread.get("lstm_forward", {})
        worker = sum(n for t, n in threads_by.items()
                     if t.startswith("serving-worker-"))
        primes = sum(a["prime"]["compiled"] + a["prime"]["hits"]
                     for a in swaps)
        others = sum(n for t, n in threads_by.items()
                     if not t.startswith("serving-worker-"))
        print(f"delivery: reload under load: {len(records)} requests from "
              f"{DELIVERY_CLIENTS} closed-loop clients over a pool of "
              f"{len(pool)} (1-4 rows, lengths {DEPLOY_LEN}) in "
              f"{wall:.3f} s: {len(records) / wall:.1f} requests/s, p50 "
              f"{_pct(lat, 0.5):.2f} ms p99 {_pct(lat, 0.99):.2f} ms; boot "
              f"from v1 {boot_s:.2f} s (cache hits "
              f"{hz0['cold_start']['compile_cache_hits']}, misses "
              f"{hz0['cold_start']['compile_cache_misses']}); swaps "
              f"{[(a['version'], round(a['swap_s'] * 1e3, 2)) for a in swaps]}"
              f" (version, ms: load + warm + swap); v3 published during the "
              f"load in {publish_s:.2f} s (merge {times['merge_s']:.2f}, "
              f"gate reload {times['load_s']:.2f}, warm "
              f"{times['warm_s']:.2f}); answers by version {answered}; "
              f"errors {len(errors)}; unmatched {len(unmatched)}; "
              f"backwards {backwards}; K9 launches by path "
              f"{launches.by_path.get('lstm_forward')} by thread "
              f"{threads_by} ({batches} batches) [{card}]", flush=True)
        if (errors or unmatched or backwards or len(records) < DELIVERY_POOL
                or sorted(answered) != [1, 2, 3] or len(swaps) != 2
                or hz1["counters"]["shed"]
                or hz1["counters"]["compile_cache_misses"]
                != hz0["counters"]["compile_cache_misses"]):
            fail("delivery", f"reload under load: errors {errors[:3]}, "
                 f"unmatched {unmatched[:5]}, answered {answered}, swaps "
                 f"{swaps}, counters {hz1['counters']}")
        if dev.type == "cuda" and (
                launches.by_path.get("lstm_forward")
                != {"persistent": launches["lstm_forward"]}
                or launches["lstm_backward"] or worker != 2 * batches
                or others != 2 * (4 + primes)):
            fail("delivery", f"reload launches {dict(launches)} by path "
                 f"{launches.by_path} by thread {threads_by}, want K9 "
                 f"{2 * batches} from the worker (2 a batch) and "
                 f"{2 * (4 + primes)} warm-step launches, all persistent")
        # the same requests again, no reload in flight
        h0 = srv.healthz()["counters"]["batches"]
        threads, quiet, t_q = _closed_loop(srv, pool)
        for t in threads:
            t.join(300)
        wall_q = time.perf_counter() - t_q
        lat_q = [(te - ts) * 1e3 for _, _, ts, te, _ in quiet]
        bad_q = [r for r in quiet if isinstance(r[4], Exception)
                 or not np.array_equal(r[4][name], solo[3][r[1]])]
        print(f"delivery: the same {len(quiet)} requests without reloads "
              f"(v3): {len(quiet) / wall_q:.1f} requests/s, p50 "
              f"{_pct(lat_q, 0.5):.2f} ms p99 {_pct(lat_q, 0.99):.2f} ms, "
              f"{srv.healthz()['counters']['batches'] - h0} batches; "
              f"replies unequal to v3's solo infer {len(bad_q)} [{card}]",
              flush=True)
        if bad_q:
            fail("delivery", f"{len(bad_q)} replies without reloads differ "
                 f"from v3's solo infer")
        # a corrupt v4 is skipped; v3 keeps serving
        publish_from_checkpoints(pub, tr.topology, save, pass_id=2,
                                 device=dev)
        chaos.corrupt_publish(pub)
        act = mgr.poll()
        out = srv.submit(pool[0]).result(60)[name]
        ok4 = (act is None and 4 in mgr.rejected and mgr.current_version == 3
               and np.array_equal(out, solo[3][0]))
        # a NaN-poisoned v5 (pass 3) rolls back within probation
        publish_from_checkpoints(pub, tr.topology, save, pass_id=3,
                                 device=dev)
        act5 = mgr.poll()
        failed, rolled = 0, None
        for i in range(DELIVERY_PROBATION):
            err = srv.submit(pool[i]).error(60)
            failed += isinstance(err, InferenceFailed)
            rolled = mgr.tick()
            if rolled is not None:
                break
        out = srv.submit(pool[1]).result(60)[name]
        print(f"delivery: corrupt v4 skipped {ok4} ({mgr.rejected.get(4)!r})"
              f"; NaN v5 {act5 and act5['action']}, {failed} typed failures "
              f"before {rolled}; v3 serving again and equal to its solo "
              f"infer {np.array_equal(out, solo[3][1])} [{card}]",
              flush=True)
        if not ok4 or not rolled or rolled["signal"] != \
                "error_rate_regression" or rolled["rolled_back_to"] != 3 \
                or not np.array_equal(out, solo[3][1]):
            fail("delivery", f"corrupt v4 {ok4}, NaN v5 {act5} -> "
                 f"{rolled}")
        # the served bundle on the card against the same bundle on the CPU
        cpu = load_inference_model(
            os.path.join(version_dir(pub, 3), "model.ptz"), device="cpu")
        worst = max(float(np.abs(solo[3][i] - cpu.infer(
            pool[i], outputs=[name])[name]).max() / np.abs(cpu.infer(
                pool[i], outputs=[name])[name]).max()) for i in range(2))
        print(f"delivery: v3 served on the card vs the same bundle on the "
              f"CPU, 2 requests: max |diff| / max |CPU| {worst:.3e} (tol "
              f"{TOL_DELIVERY_CPU}) [{card}]", flush=True)
        if not worst <= TOL_DELIVERY_CPU:
            fail("delivery", f"card and CPU disagree: {worst}")
        return launches
    finally:
        stop.set()      # a failed check must not leave clients looping
        srv.close()


def _package_copy(dest: str) -> str:
    """A copy of the port's package with no ``_build/`` (what a fresh
    checkout holds); -> the directory to run it from."""
    import shutil

    shutil.copytree(os.path.join(ROOT, "paddle_tpu_torch"),
                    os.path.join(dest, "paddle_tpu_torch"),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    return dest


def _serve_child(args, cwd: str, what: str, min_lines: int = 2):
    """``python -m paddle_tpu_torch serve ...`` from ``cwd`` in a fresh
    process -> (JSON lines, seconds to the first line starting
    ``{"ready"``, stderr)."""
    env = dict(os.environ, PYTHONPATH=cwd)
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-m", "paddle_tpu_torch",
                             "serve", *args], cwd=cwd, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    first, ready_s = "", None
    try:
        while ready_s is None:
            line = proc.stdout.readline()
            if not line:
                break
            first += line
            if line.startswith('{"ready"'):
                ready_s = time.perf_counter() - t0
        rest, err = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    lines = [json.loads(l) for l in (first + rest).splitlines()
             if l.startswith("{")]
    if proc.returncode != 0 or ready_s is None or len(lines) < min_lines:
        fail("delivery", f"{what}: exit {proc.returncode}, stdout "
             f"{(first + rest)[-1500:]!r}, stderr {err[-3000:]!r}")
        return lines, ready_s, err
    return lines, ready_s, err


def delivery_warm_boot(K, dev, card, paths, root):
    """Part (c): v1-v3 and the shared cache copied into a fresh publish
    dir; ``serve --serve_watch --serve_smoke`` in fresh processes from a
    copy of the package with an empty ``_build/``: warm (the cache: zero
    ``nvcc`` runs, each loaded library's smoke call passed), cold (no
    cache) and with the cache's K9 entry corrupted (a logged miss and a
    rebuild); the served rows equal v3's in-process rows each time."""
    import shutil

    import numpy as np

    from paddle_tpu_torch.config import load_inference_model
    from paddle_tpu_torch.publish import version_dir
    from paddle_tpu_torch.resilience import chaos
    from paddle_tpu_torch.serving.feeds import example_feed

    pub3 = os.path.join(root, "pub3")
    os.makedirs(pub3)
    for v in (1, 2, 3):
        shutil.copytree(version_dir(paths["pub"], v), version_dir(pub3, v))
    shutil.copytree(os.path.join(paths["pub"], "ccache"),
                    os.path.join(pub3, "ccache"))
    broken = os.path.join(root, "ccache-broken")
    shutil.copytree(os.path.join(pub3, "ccache"), broken)
    m = load_inference_model(os.path.join(version_dir(pub3, 3), "model.ptz"),
                             device=None if dev.type == "cuda" else dev)
    want = m.infer(example_feed(m.topology))
    del m
    base = [f"--device={dev.type}", "--serve_watch",
            f"--serve_smoke={DELIVERY_SMOKE}", f"--publish_dir={pub3}",
            "--serve_deadline_ms=60000",
            f"--serve_max_batch={DELIVERY_MAX_BATCH}"]
    runs = {}
    for what, cache in (("warm", os.path.join(pub3, "ccache")),
                        ("cold", ""), ("corrupt", broken)):
        cwd = _package_copy(os.path.join(root, f"copy-{what}"))
        if what == "corrupt":
            chaos.corrupt_compile_cache(broken)
        lines, ready_s, err = _serve_child(
            base + [f"--compile_cache_dir={cache}"], cwd, what)
        if not lines:
            continue
        last = lines[-1]
        libs = last.get("compile_cache", {}).get("libraries", {})
        rows_equal = all(
            np.array_equal(np.asarray(last["smoke_outputs"][k], v.dtype), v)
            for k, v in want.items()) if last.get("smoke_outputs") else False
        runs[what] = {"ready_s": ready_s, "libs": libs,
                      "rows_equal": rows_equal,
                      "logged_miss": "CRC mismatch" in err,
                      "launches": last.get("launches"),
                      "completed": last["counters"]["completed"],
                      "version": (last.get("model") or {}).get("version")}
    for what, r in runs.items():
        nvcc = sum(v["builds"] for n, v in r["libs"].items()
                   if n != "dataio")
        print(f"delivery: serve --serve_watch --serve_smoke="
              f"{DELIVERY_SMOKE} {what} boot from a package copy with an "
              f"empty _build: ready in {r['ready_s']:.2f} s; nvcc runs "
              f"{nvcc}; libraries {json.dumps(r['libs'])}; served v"
              f"{r['version']}, {r['completed']} completed, rows equal to "
              f"the in-process v3 rows {r['rows_equal']}; logged cache miss "
              f"{r['logged_miss']}; launches after the ready line "
              f"{json.dumps(r['launches'])} [{card}]", flush=True)
    if set(runs) != {"warm", "cold", "corrupt"}:
        return
    warm_libs, cold_libs = runs["warm"]["libs"], runs["cold"]["libs"]
    bad_smoke = [n for n, v in warm_libs.items()
                 if v["origin"] == "cache" and not v["smoke"]]
    problems = []
    if not all(r["rows_equal"] and r["version"] == 3
               for r in runs.values()):
        problems.append("a boot's rows or version differ")
    if dev.type == "cuda":
        if (sum(v["builds"] for v in warm_libs.values())
                or warm_libs.get("lstm_forward", {}).get("origin")
                != "cache" or bad_smoke):
            problems.append(f"warm boot libraries {warm_libs}")
        if cold_libs.get("lstm_forward", {}).get("builds") != 1:
            problems.append(f"cold boot libraries {cold_libs}")
        c = runs["corrupt"]
        if not c["logged_miss"] or c["libs"].get(
                "lstm_forward", {}).get("builds") != 1:
            problems.append(f"corrupt entry: logged {c['logged_miss']}, "
                            f"libraries {c['libs']}")
        k9 = (runs["warm"]["launches"] or {}).get("by_path", {}).get(
            "lstm_forward")
        if not k9 or set(k9) != {"persistent"}:
            problems.append(f"warm boot launches {runs['warm']['launches']}")
    if problems:
        fail("delivery", f"warm boot: {problems}")


def delivery_fleet(K, dev, card, paths, logits):
    """Part (d): a ``ModelFleet`` over the f32 and int8 bundles of the fleet
    root with two tenants; ``tenant_flood`` and ``poison_tenant`` on one
    leave the other's replies bit-equal to its solo run with zero errors;
    a 10% canary (v2 of the f32 model, from pass 2) killed with
    ``kill_canary(mode="nan")`` rolls back with zero dropped requests and
    the incumbent never failing; a ``FleetRouter`` over this fleet and a
    second one fails a tenant over when its home is drained; ``serve
    --serve_fleet --serve_smoke`` in a fresh process.  -> launches."""
    import numpy as np

    from paddle_tpu_torch.publish import (model_publish_dir,
                                          publish_cache_dir,
                                          publish_from_checkpoints)
    from paddle_tpu_torch.resilience import chaos
    from paddle_tpu_torch.serving import (FleetRouter, InferenceFailed,
                                          ModelFleet, TenantSpec,
                                          canary_arm, load_published,
                                          rendezvous_rank)
    import paddle_tpu_torch.nn as nn

    name = logits.name
    dev_arg = None if dev.type == "cuda" else dev
    opts = dict(outputs=[name], max_batch=DELIVERY_MAX_BATCH,
                batch_delay_ms=1.0, max_queue=256, default_deadline_ms=0.0)
    tenants = [TenantSpec("gold", weight=3.0, rate=1e6, burst=1e6),
               TenantSpec("free", weight=1.0, rate=2.0, burst=4.0)]
    root = paths["fleet"]
    pool = deploy_requests(SEED + 400)[:DELIVERY_VICTIM]
    K.reset_launch_counts()
    fleet = ModelFleet(tenants=tenants, probation_requests=10_000,
                       min_probation_samples=2)
    other = ModelFleet(tenants=tenants)
    try:
        for m in ("textclf", "textclf_int8"):
            fleet.load_published_model(root, m, device=dev_arg,
                                       server_opts=opts)
        other.load_published_model(root, "textclf_int8", device=dev_arg,
                                   server_opts=opts)

        def victim():
            return [fleet.infer(f, model="textclf", tenant="gold",
                                request_key=f"v{i}", timeout=60)[name]
                    for i, f in enumerate(pool)]

        solo = victim()
        restore = chaos.poison_tenant(fleet, "free")
        try:
            flood = chaos.tenant_flood(fleet, pool[0], tenant="free",
                                       model="textclf_int8")
            chaos_out = victim()
        finally:
            restore()
        same = all(np.array_equal(a, b) for a, b in zip(solo, chaos_out))
        hz = fleet.healthz()
        print(f"delivery: fleet over the f32 and int8 bundles, tenants gold "
              f"and free: flood of free {flood}; gold's {len(pool)} "
              f"replies bit-equal to its solo run {same}; gold "
              f"quota_rejected {hz['tenants']['gold']['quota_rejected']}, "
              f"textclf inference_failed "
              f"{hz['models']['textclf@v1']['inference_failed']} [{card}]",
              flush=True)
        if (not same or flood["quota_rejected"] == 0
                or hz["tenants"]["gold"]["quota_rejected"]
                or hz["models"]["textclf@v1"]["inference_failed"]):
            fail("delivery", f"fleet isolation: same {same}, flood {flood}"
                 f", healthz {hz['tenants']}")
        # a 10% canary of v2 (pass 2), killed
        mdir = model_publish_dir(root, "textclf")
        publish_from_checkpoints(mdir, nn.Topology(logits, device=dev),
                                 paths["save"], pass_id=2, device=dev)
        model2, info2, v2 = load_published(mdir, device=dev_arg)
        fleet.add_model("textclf", model2, version=v2, role="canary",
                        percent=DELIVERY_CANARY_PCT, info=info2,
                        compile_cache=publish_cache_dir(mdir),
                        server_opts=opts)
        chaos.kill_canary(fleet, "textclf", mode="nan")
        futs, arms = [], []
        for i in range(DELIVERY_CANARY_N):
            f = pool[i % len(pool)]
            arms.append(canary_arm("textclf", f"k{i}", DELIVERY_CANARY_PCT))
            futs.append(fleet.submit(f, model="textclf", tenant="gold",
                                     request_key=f"k{i}"))
            if fleet.route("textclf")["candidate"] is None:
                break
        # every future resolves: a reply, or on the canary's arm a typed
        # error (its NaN replies, or ServerClosed for the stragglers of the
        # retired canary, reaped once its queue drains)
        drops, inc_fail, can_errors = 0, 0, {}
        for f, arm in zip(futs, arms):
            try:
                err = f.error(60)
            except TimeoutError:
                drops += 1
                continue
            if err is None:
                continue
            if arm:
                kind = type(err).__name__
                can_errors[kind] = can_errors.get(kind, 0) + 1
            else:
                inc_fail += 1
        can_fail = can_errors.get(InferenceFailed.__name__, 0)
        fleet.tick()
        route = fleet.route("textclf")
        print(f"delivery: {DELIVERY_CANARY_PCT}% canary v{v2} killed (nan): "
              f"{len(futs)} requests, {sum(arms)} on the canary's arm, its "
              f"typed errors {can_errors}; incumbent failures {inc_fail}, "
              f"dropped {drops}; route after "
              f"{ {k: route[k] for k in ('incumbent', 'candidate')} } "
              f"[{card}]", flush=True)
        if drops or inc_fail or route["candidate"] is not None or \
                route["incumbent"] != 1 or not can_fail:
            fail("delivery", f"canary rollback: drops {drops}, incumbent "
                 f"failures {inc_fail}, route {route}")
        # the router: a drained home fails over down the rendezvous order
        router = FleetRouter({"a": fleet, "b": other}, probe_budget=1,
                             failover=True)
        home = router.server_for("gold")
        first = router.submit(pool[0], tenant="gold",
                              model="textclf_int8").result(60)[name]
        drained = fleet if home == "a" else other
        drained.entry("textclf_int8", 1).server.close()
        if drained is fleet:
            drained.entry("textclf", 1).server.close()
        router.probe()
        moved = router.server_for("gold")
        again = router.submit(pool[0], tenant="gold",
                              model="textclf_int8").result(60)[name]
        print(f"delivery: FleetRouter home of gold {home}, after its drain "
              f"{moved} (rendezvous order "
              f"{rendezvous_rank('gold', ['a', 'b'])}); replies equal "
              f"{np.array_equal(first, again)}; members "
              f"{ {n: m['state'] for n, m in router.members().items()} } "
              f"[{card}]", flush=True)
        if moved == home or not np.array_equal(first, again):
            fail("delivery", f"router failover: {home} -> {moved}")
        launches = K.launch_counts()
    finally:
        fleet.close()
        other.close()
    lines, ready_s, _ = _serve_child(
        [f"--device={dev.type}", "--serve_fleet",
         f"--serve_smoke={DELIVERY_FLEET_SMOKE}",
         "--serve_deadline_ms=60000"], ROOT, "serve --serve_fleet",
        min_lines=1)
    if lines:
        hz = lines[-1]
        print(f"delivery: serve --serve_fleet --serve_smoke="
              f"{DELIVERY_FLEET_SMOKE} exit 0 in a fresh process: models "
              f"{sorted(hz['models'])}, tenants "
              f"{ {t: (v['admitted'], v['quota_rejected']) for t, v in hz['tenants'].items()} }"
              f" (admitted, quota_rejected) [{card}]", flush=True)
    threads = launches.by_thread.get("lstm_forward", {})
    if dev.type == "cuda" and (
            not launches["lstm_forward"]
            or launches.by_path["lstm_forward"]
            != {"persistent": launches["lstm_forward"]}
            or not all(t.startswith("serving-worker-") or t == "MainThread"
                       for t in threads)):
        fail("delivery", f"fleet launches {launches.by_path} by thread "
             f"{threads}")
    return launches


def delivery_path(K, dev, card):
    """Phase 20: (a) train, scrub and publish; (b) hot reload under load;
    (c) a warm boot from the publish dir's compile cache in fresh
    processes; (d) the fleet, its tenants, a killed canary and the router;
    then the phase's launches on their own line.  -> {part: launches}."""
    import shutil
    import tempfile

    import torch

    from paddle_tpu_torch.obs.journal import (close_journal,
                                              merge_journals)
    from paddle_tpu_torch.publish import freshness_from_journal

    t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="delivery-")
    parts = {}
    try:
        with flags_set(obs_journal=os.path.join(root, "journal")):
            tr, logits, paths, parts["train"] = delivery_train(K, dev, card,
                                                               root)
            parts["reload"] = delivery_reload(K, dev, card, tr, logits,
                                              paths)
            del tr
            if dev.type == "cuda":
                torch.cuda.empty_cache()
            delivery_warm_boot(K, dev, card, paths, root)
            parts["fleet"] = delivery_fleet(K, dev, card, paths, logits)
        close_journal()
        events, torn = merge_journals([os.path.join(root, "journal")])
        kinds = {}
        for r in events:
            kinds[r["kind"]] = kinds.get(r["kind"], 0) + 1
        # the served publish dir's chain (the fleet root's versions and
        # the fleet's records carry their own numbers)
        chain = [r for r in events if "model" not in r and (
            r["kind"] != "publish_commit"
            or r.get("dir", "").startswith(paths["pub"] + os.sep))]
        fresh = [(r["version"], r["freshness_s"], r["rolled_back"])
                 for r in freshness_from_journal(chain)]
        print(f"delivery: journal records by kind {kinds} (torn {torn}); "
              f"freshness (version, train commit to serving ready s, "
              f"rolled back) {fresh}", flush=True)
        for k in ("publish_commit", "publish_refused", "reload_commit",
                  "probation_passed", "publish_skipped_corrupt",
                  "publish_rollback", "fleet_rollout"):
            if not kinds.get(k):
                fail("delivery", f"no {k} record in the journal")
    finally:
        close_journal()
        shutil.rmtree(root, ignore_errors=True)
    print(json.dumps({"delivery_launches": {
        part: {n: {"launches": c, "by_path": counts.by_path[n]}
               for n, c in counts.items() if c}
        for part, counts in parts.items()}}), flush=True)
    print(f"delivery: phase seconds {time.perf_counter() - t0:.2f}; card "
          f"{card}", flush=True)
    return parts


# ---------------------------------------------------------------------------
# phase 21: data parallelism and the pserver tier over torch.distributed
# ---------------------------------------------------------------------------

#: (a) 6 steps of 64 rows (32 a rank) and one test batch a pass
PARALLEL_TEXTCLF_N, PARALLEL_TEXTCLF_TEST_N = 6 * 64, 64
PARALLEL_TEXTCLF_STEPS = 6
PARALLEL_FLAGSHIP_STEPS = 3
#: (d): ML-1M's schema (paddle_tpu/data/datasets.py:240), the model's
#: widths, the batch and the steps
PARALLEL_ML = {"n_users": 6040, "n_movies": 3952, "emb": 64, "hid": 64,
               "B": 128, "steps": 4}
PARALLEL_NCCL_STEPS = 3
#: each world's time limit: past it the launcher kills the whole gang
PARALLEL_WORLD_S = 420.0
#: (a) f32 and (d): tests/test_parallel.py:62-66 and tests/
#: test_pserver.py:248-269's tolerances
TOL_PAR_LOSS, TOL_PAR_RTOL, TOL_PAR_ATOL = 1e-5, 1e-4, 1e-6
TOL_PS_LOSS, TOL_PS_RTOL, TOL_PS_ATOL = 1e-6, 1e-6, 1e-7
#: (b) bf16: each Adam step's loss (relative), and the first step's
#: gradient, each array's largest |diff| over its largest entry (the
#: parameters after Adam are printed only: Adam's update of a gradient
#: near zero is its sign, which any change of summation order may flip)
TOL_PAR_FLAGSHIP_LOSS, TOL_PAR_FLAGSHIP_GRAD = 1e-3, 2 ** -6
PARALLEL_ROWS = {
    f"lstm_forward_residuals_b{TEXTCLF_B}h256": (
        "lstm_forward", ("textclf_bf16_r0", "textclf_bf16_r1",
                         "textclf_f32_r0", "textclf_f32_r1", "nccl1_r0")),
    f"lstm_backward_b{TEXTCLF_B}h256": (
        "lstm_backward", ("textclf_bf16_r0", "textclf_bf16_r1",
                          "textclf_f32_r0", "textclf_f32_r1", "nccl1_r0")),
    **{name: (name.replace("_residuals", ""), ("flagship_r0", "flagship_r1"))
       for name in ("gru_forward_residuals", "gru_backward", "attn_dec_fwd",
                    "attn_dec_bwd", "ce_readout_fwd", "ce_readout_bwd")},
}


def _rank_lines(d: str, n: int, part: str):
    """Each rank's JSON lines on its standard output (the launcher's
    ``rank-<i>.out``)."""
    out = []
    for r in range(n):
        with open(os.path.join(d, "logs", f"rank-{r}.out")) as f:
            lines = [json.loads(x) for x in f.read().splitlines()
                     if x.startswith("{")]
        if not lines:
            fail("parallel", f"{part}: rank {r} printed no result")
        out.append(lines)
    return out


def _world(part: str, n: int, script: str, args, d: str,
           backend, env=None):
    """Start ``n`` ranks with the port's launcher (a file rendezvous under
    ``d``), join them under ``PARALLEL_WORLD_S`` -> each rank's JSON
    lines.  A rank that exits non-zero, or a world past its limit, fails
    the phase with every rank's stderr tail."""
    from paddle_tpu_torch.parallel import GangTimeout, launch_local

    os.makedirs(d, exist_ok=True)
    env = {"PYTHONPATH": ROOT + os.pathsep + os.environ.get("PYTHONPATH",
                                                           ""),
           **(env or {})}
    t0 = time.perf_counter()
    launcher = launch_local(n, script, args, env=env,
                            coordinator=f"file://{d}/rendezvous",
                            backend=backend, log_dir=os.path.join(d, "logs"),
                            cwd=ROOT)
    try:
        codes = launcher.join(PARALLEL_WORLD_S)
    except GangTimeout as e:
        fail("parallel", f"{part}: {e}")
    if any(codes):
        fail("parallel", f"{part}: rank exit codes {codes}\n"
             + launcher.stderr_tails())
    print(f"parallel: {part}: {n} rank(s) over "
          f"{backend or 'the default backend'} in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    return _rank_lines(d, n, part)


def _counts(launches: dict):
    """A rank's printed launches as ``LaunchCounts``."""
    from paddle_tpu_torch.ops.kernels.build import LaunchCounts

    lib = launches.get("by_library", {})
    return LaunchCounts(dict(lib), {k: dict(v) for k, v in
                                    launches.get("by_path", {}).items()}, {})


def _comm_text(comm: dict, tags) -> str:
    parts = []
    for tag in tags:
        c = comm.get(tag)
        if c:
            parts.append(f"{tag} {c['calls']} calls, "
                         f"{c['ms'] / c['calls']:.3f} ms and "
                         f"{c['bytes'] / c['calls']:.0f} bytes a call "
                         f"(host staging {c['staged_ms'] / c['calls']:.3f} ms)")
    return "; ".join(parts) or "none"


def _max_errs(got: dict, want: dict):
    """-> (largest |diff| - (atol + rtol |want|) margin inputs): per array
    the largest |diff|, its largest |diff| over its largest |entry|."""
    import numpy as np

    out = {}
    for k, w in want.items():
        g = np.asarray(got[k], np.float64)
        w = np.asarray(w, np.float64)
        diff = np.abs(g - w)
        out[k] = (float(diff.max()), float(diff.max() / max(np.abs(w).max(),
                                                            1e-30)),
                  bool(np.all(diff <= TOL_PAR_ATOL + TOL_PAR_RTOL
                              * np.abs(w))))
    return out


def parallel_textclf(K, dev, card, root):
    """Part (a): the command line on 2 gloo ranks of one card, bf16 and
    f32, each against the same command in this process."""
    import numpy as np

    from paddle_tpu_torch.resilience.checkpoint_io import pass_dir

    env = {"TORCH_TEXTCLF_N": str(PARALLEL_TEXTCLF_N),
           "TORCH_TEXTCLF_TEST_N": str(PARALLEL_TEXTCLF_TEST_N)}
    launches = {}
    for dtype, tag in (("bfloat16", "bf16"), ("float32", "f32")):
        d = os.path.join(root, f"textclf-{tag}")
        flags = ["--job=train", f"--config={TRAINER_CONF}", "--num_passes=1",
                 "--log_period=0", f"--compute_dtype={dtype}"]
        lines = _world(f"(a) textclf {tag}", 2, "-m",
                       ["paddle_tpu_torch", *flags, "--mesh_shape=2",
                        f"--save_dir={d}/ck"], d, "gloo", env)
        last = [x[-1] for x in lines]
        with cli_run(PARALLEL_TEXTCLF_N), \
                cli_run(PARALLEL_TEXTCLF_TEST_N, "TORCH_TEXTCLF_TEST_N"), \
                recorded_losses() as one_losses:
            cli(["--job=train", "--num_passes=1", f"--save_dir={d}/one",
                 f"--compute_dtype={dtype}"], phase="parallel")
        with np.load(os.path.join(pass_dir(f"{d}/ck", 0), "params.npz")) as z:
            got = {k: z[k] for k in z.files}
        with np.load(os.path.join(pass_dir(f"{d}/one", 0),
                                  "params.npz")) as z:
            want = {k: z[k] for k in z.files}
        errs = _max_errs(got, want)
        loss_rel = max(abs(a - b) / abs(b) for a, b in
                       zip(last[0]["losses"], one_losses))
        worst = max(errs.items(), key=lambda kv: kv[1][1])
        for r, x in enumerate(last):
            launches[f"textclf_{tag}_r{r}"] = _counts(x["launches"])
            comm = _comm_text(x["comm"], ("grad_allreduce",
                                          "loss_norm_allreduce"))
            print(f"parallel: (a) textclf {tag} rank {r}: losses "
                  f"{[round(v, 5) for v in x['losses']]}; step ms median "
                  f"{float(np.median(x['step_ms'][1:])):.2f} (steps 2-"
                  f"{len(x['step_ms'])}); gradient all-reduce: {comm}; "
                  f"launches {json.dumps(x['launches'])} [{card}]",
                  flush=True)
        print(f"parallel: (a) textclf {tag} against one process: losses "
              f"{[round(v, 5) for v in one_losses]}, largest relative loss "
              f"error {loss_rel:.3e}; largest parameter error {worst[0]} "
              f"|diff| {worst[1][0]:.3e} ({worst[1][1]:.3e} of its largest "
              f"entry); ranks' parameters bit-equal "
              f"{last[0]['params_sha256'] == last[1]['params_sha256']}",
              flush=True)
        problems = []
        if last[0]["params_sha256"] != last[1]["params_sha256"]:
            problems.append("the ranks' parameters differ")
        if last[0]["losses"] != last[1]["losses"]:
            problems.append("the ranks' losses differ")
        if len(one_losses) != PARALLEL_TEXTCLF_STEPS or len(
                last[0]["losses"]) != PARALLEL_TEXTCLF_STEPS:
            problems.append(f"steps {len(one_losses)} / "
                            f"{len(last[0]['losses'])}")
        want_launch = {"lstm_forward": 2 * PARALLEL_TEXTCLF_STEPS,
                       "lstm_backward": 2 * PARALLEL_TEXTCLF_STEPS}
        for x in last:
            if x["launches"]["by_library"] != want_launch:
                problems.append(f"rank {x['rank']} launches "
                                f"{x['launches']['by_library']}")
            if tag == "bf16" and any(
                    set(x["launches"]["by_path"].get(k, {})) !=
                    {"persistent"} for k in want_launch):
                problems.append(f"rank {x['rank']} launches by path "
                                f"{x['launches']['by_path']}")
        if tag == "f32":
            if loss_rel > TOL_PAR_LOSS:
                problems.append(f"loss relative error {loss_rel:.3e}")
            bad = [k for k, e in errs.items() if not e[2]]
            if bad:
                problems.append(f"parameters past rtol {TOL_PAR_RTOL} / "
                                f"atol {TOL_PAR_ATOL}: "
                                f"{ {k: errs[k][:2] for k in bad} }")
        if problems:
            fail("parallel", f"(a) textclf {tag}: {problems}")
    return launches


def parallel_flagship_ml(K, dev, card, root):
    """Parts (b) and (d) in one world of 2 gloo ranks (this script's
    ``--parallel-rank flagship_ml``)."""
    d = os.path.join(root, "flagship-ml")
    lines = _world("(b) flagship and (d) movielens", 2,
                   os.path.abspath(__file__),
                   ["--parallel-rank", "flagship_ml", d], d, "gloo")
    launches = {}
    for part in ("flagship", "movielens"):
        rows = [next(x for x in ls if x.get("part") == part) for ls in lines]
        for x in rows:
            r = x["rank"]
            if part == "flagship":
                launches[f"flagship_r{r}"] = _counts(x["launches"])
            tags = (("grad_allreduce", "loss_norm_allreduce")
                    if part == "flagship" else
                    ("lookup_ids", "lookup_rows", "lookup_gather",
                     "pserver_segments", "push_ids", "push_rows"))
            print(f"parallel: ({'b' if part == 'flagship' else 'd'}) {part} "
                  f"rank {r}: losses {[round(v, 5) for v in x['losses']]}; "
                  f"step ms {[round(v, 2) for v in x['step_ms']]}; "
                  f"{_comm_text(x['comm'], tags)}; launches "
                  f"{json.dumps(x['launches'])} [{card}]", flush=True)
        ref = rows[0]["check"]
        print(f"parallel: ({'b' if part == 'flagship' else 'd'}) {part} "
              f"against one process on rank 0: {json.dumps(ref)}",
              flush=True)
        problems = list(ref["problems"])
        if rows[0]["digest"] != rows[1]["digest"]:
            problems.append("the ranks' parameters differ")
        if part == "flagship":
            steps = PARALLEL_FLAGSHIP_STEPS
            for x in rows:
                lib = x["launches"]["by_library"]
                want = {"gru_forward": 2 * steps, "gru_backward": 2 * steps,
                        "attn_dec_fwd": steps, "attn_dec_bwd": steps,
                        "ce_readout_fwd": steps, "ce_readout_bwd": steps}
                if lib != want:
                    problems.append(f"rank {x['rank']} launches {lib}")
                paths = x["launches"]["by_path"]
                if any(set(paths.get(k, {})) != {"persistent"}
                       for k in PERSISTENT_TRAIN_KERNELS if k in want) or \
                        any(paths.get(k) != {"wgmma": steps}
                            for k in ("ce_readout_fwd", "ce_readout_bwd")):
                    problems.append(f"rank {x['rank']} paths {paths}")
        if problems:
            fail("parallel", f"{part}: {problems}")
    return launches


def parallel_nccl1(K, dev, card, root):
    """Part (c): a world of one rank under NCCL."""
    d = os.path.join(root, "nccl1")
    (lines,) = _world("(c) world of 1", 1, os.path.abspath(__file__),
                      ["--parallel-rank", "nccl1", d], d, None)
    x = next(v for v in lines if v.get("part") == "nccl1")
    print(f"parallel: (c) world of 1 over {x['backend']}: "
          f"SGDTrainer(mesh=MeshConfig.of(data=1)) losses "
          f"{[round(v, 5) for v in x['losses']]}, bit-equal to no mesh "
          f"{x['equal']}; launches {json.dumps(x['launches'])} [{card}]",
          flush=True)
    if x["backend"] != "nccl" or not x["equal"]:
        fail("parallel", f"(c) world of 1: backend {x['backend']}, equal "
             f"{x['equal']}")
    return {"nccl1_r0": _counts(x["launches"])}


def parallel_path(K, dev, card):
    """Phase 21: parts (a)-(d) -> launches by part and rank."""
    import shutil
    import tempfile

    t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="chip_smoke_parallel_")
    try:
        launches = parallel_textclf(K, dev, card, root)
        launches.update(parallel_flagship_ml(K, dev, card, root))
        launches.update(parallel_nccl1(K, dev, card, root))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"parallel: the ranks of each world share this one card ({card}): "
          f"their times are not a scaling result; the phase "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    return launches


# -- the ranks of phase 21 (``chip_smoke.py --parallel-rank PART DIR``) --------


def _emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def _rank_flagship(K, dev):
    """(b): ``make_parallel_train_step`` on this rank's 192 rows; rank 0
    then runs the one-process step on all 384 rows from the same start."""
    import numpy as np
    import torch

    from paddle_tpu_torch.__main__ import params_digest
    from paddle_tpu_torch.models import Seq2SeqAttention
    from paddle_tpu_torch.param import Adam
    from paddle_tpu_torch.parallel import (MeshConfig, comm_stats,
                                           data_parallel_grads,
                                           make_parallel_train_step,
                                           reset_comm_stats, shard_batch)

    mesh = MeshConfig.of(data=2).build()
    model = Seq2SeqAttention(device=dev)
    init = model.init(seed=SEED)
    batch = train_batch(np.random.RandomState(SEED), model, TRAIN_B,
                        TRAIN_S, TRAIN_T, mixed=False)
    opt = Adam(learning_rate=1e-3)
    local = shard_batch(mesh, batch)
    # the first step's global gradient, as the step computes it (each
    # rank's loss weighted by its target tokens: the model's loss_weight)
    _, grad_dp = data_parallel_grads(model.loss, init, local, mesh)
    params = {k: v.clone() for k, v in init.items()}
    state = opt.init_state(params)
    step = make_parallel_train_step(model.loss, opt, mesh)
    torch.cuda.synchronize()
    K.reset_launch_counts()
    reset_comm_stats()
    losses, ms = [], []
    for _ in range(PARALLEL_FLAGSHIP_STEPS):
        t0 = time.perf_counter()
        loss, params, state = step(params, state, local)
        losses.append(loss.item())
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    counts = K.launch_counts()
    out = {"part": "flagship", "rank": mesh.rank, "losses": losses,
           "step_ms": ms, "digest": params_digest(params),
           "comm": comm_stats(),
           "launches": {"by_library": {k: v for k, v in counts.items() if v},
                        "by_path": {k: v for k, v in counts.by_path.items()
                                    if v}}}
    if mesh.rank == 0:
        def rel(a, b):
            return {k: float((a[k].float() - b[k].float()).abs().max()
                             / b[k].float().abs().max().clamp(min=1e-30))
                    for k in b}

        ref = {k: v.clone() for k, v in init.items()}
        rstate = opt.init_state(ref)
        ref_losses, grad_ref = [], None
        for _ in range(PARALLEL_FLAGSHIP_STEPS):
            leaves = {k: v.detach().requires_grad_() for k, v in ref.items()}
            loss = model.loss(leaves, batch)
            grads = dict(zip(leaves, torch.autograd.grad(
                loss, list(leaves.values()))))
            if grad_ref is None:
                grad_ref = {k: g.clone() for k, g in grads.items()}
            opt.update(ref, grads, rstate)
            ref_losses.append(loss.item())
        loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses,
                                                           ref_losses))
        g_rel, p_rel = rel(grad_dp, grad_ref), rel(params, ref)
        g_worst, p_worst = max(g_rel, key=g_rel.get), max(p_rel,
                                                          key=p_rel.get)
        problems = []
        if loss_rel > TOL_PAR_FLAGSHIP_LOSS:
            problems.append(f"loss relative error {loss_rel:.3e}")
        if g_rel[g_worst] > TOL_PAR_FLAGSHIP_GRAD:
            problems.append(f"gradient {g_worst}: |diff| "
                            f"{g_rel[g_worst]:.3e} of its largest entry")
        out["check"] = {"one_process_losses": ref_losses,
                        "loss_rel_err": loss_rel,
                        "worst_grad": [g_worst, g_rel[g_worst]],
                        "worst_param_after_adam": [p_worst,
                                                   p_rel[p_worst]],
                        "problems": problems}
    del init, params, state, model, grad_dp
    torch.cuda.empty_cache()
    _emit(out)


def _ml_feeds():
    import numpy as np

    from paddle_tpu_torch.data import datasets

    B, steps = PARALLEL_ML["B"], PARALLEL_ML["steps"]
    rows = list(datasets.movielens("train", n_users=PARALLEL_ML["n_users"],
                                   n_movies=PARALLEL_ML["n_movies"],
                                   n=B * steps)())
    feeds = []
    for i in range(steps):
        u, m, r = (np.asarray(c) for c in zip(*rows[i * B:(i + 1) * B]))
        feeds.append({"user_id": u.astype(np.int32).reshape(B, 1),
                      "movie_id": m.astype(np.int32).reshape(B, 1),
                      "score": r.astype(np.float32).reshape(B, 1)})
    return feeds


def _rank_movielens(K, dev):
    """(d): ``movielens_net(sparse_grad=True)`` on ``model=2``; rank 0 then
    runs the one-process masked path from the same tables."""
    import numpy as np
    import torch

    import paddle_tpu_torch.nn as nn
    from paddle_tpu_torch.__main__ import params_digest
    from paddle_tpu_torch.models.recommender import movielens_net
    from paddle_tpu_torch.ops import compute_dtype_scope
    from paddle_tpu_torch.param import Adam
    from paddle_tpu_torch.param.optimizers import slot_leaves
    from paddle_tpu_torch.parallel import (MeshConfig, comm_stats,
                                           reset_comm_stats)
    from paddle_tpu_torch.trainer import SGDTrainer

    ml = PARALLEL_ML

    def cost():
        nn.reset_naming()
        return movielens_net(ml["n_users"], ml["n_movies"],
                             emb_dim=ml["emb"], hid_dim=ml["hid"],
                             sparse_grad=True)[0]

    feeds = _ml_feeds()
    with compute_dtype_scope("float32"):
        mesh = MeshConfig.of(model=2).build()
        tr = SGDTrainer(cost(), Adam(learning_rate=1e-3), seed=SEED,
                        mesh=mesh)
        start = tr.pserver.full_state()
        dense0 = {k: v.detach().clone() for k, v in tr.params.items()}
        torch.cuda.synchronize()
        K.reset_launch_counts()
        reset_comm_stats()
        losses, ms = [], []
        for f in feeds:
            t0 = time.perf_counter()
            losses.append(tr.train_batch(f).item())
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        comm = comm_stats()
        counts = K.launch_counts()
        full = tr.pserver.full_state()
        out = {"part": "movielens", "rank": mesh.rank, "losses": losses,
               "step_ms": ms, "digest": params_digest(tr.params),
               "comm": comm,
               "launches": {"by_library": {k: v for k, v in counts.items()
                                           if v},
                            "by_path": {k: v for k, v in
                                        counts.by_path.items() if v}}}
        if mesh.rank == 0:
            one = SGDTrainer(cost(), Adam(learning_rate=1e-3), seed=SEED,
                             device=dev)
            problems = []
            with torch.no_grad():
                for k, v in one.params.items():
                    if k in start["tables"]:
                        v.copy_(start["tables"][k][:v.shape[0]])
                    elif not torch.equal(v, dense0[k]):
                        problems.append(f"{k}: the one-process start "
                                        f"differs")
                        v.copy_(dense0[k])
            ref_losses = [one.train_batch(f).item() for f in feeds]
            loss_rel = max(abs(a - b) / abs(b) for a, b in
                           zip(losses, ref_losses))
            if loss_rel > TOL_PS_LOSS:
                problems.append(f"loss relative error {loss_rel:.3e}")
            worst = {}
            fed = {"_user_emb.w0": set(), "_movie_emb.w0": set()}
            for f in feeds:
                fed["_user_emb.w0"] |= set(f["user_id"].ravel().tolist())
                fed["_movie_emb.w0"] |= set(f["movie_id"].ravel().tolist())
            for name in start["tables"]:
                v = one.params[name].shape[0]
                pairs = [("table", full["tables"][name][:v],
                          one.params[name])]
                for i, (a, b) in enumerate(zip(
                        slot_leaves(full["slots"][name]),
                        slot_leaves(one.opt_state["slots"][name]))):
                    pairs.append((f"slot{i}", a[:v], b))
                for what, a, b in pairs:
                    diff = (a.double() - b.double()).abs()
                    ok = bool((diff <= TOL_PS_ATOL + TOL_PS_RTOL
                               * b.double().abs()).all())
                    worst[f"{name}.{what}"] = float(diff.max())
                    if not ok:
                        problems.append(f"{name}.{what}: |diff| "
                                        f"{float(diff.max()):.3e}")
                touched = slot_leaves(one.opt_state["slots"][name])[0].ne(
                    0).any(dim=1)
                dirty = full["dirty"][name][:v]
                if not torch.equal(dirty.cpu(), touched.cpu()):
                    problems.append(f"{name}: dirty rows "
                                    f"{int(dirty.sum())} != touched "
                                    f"{int(touched.sum())}")
                if not set(torch.nonzero(dirty).reshape(-1).tolist()) <= \
                        fed[name]:
                    problems.append(f"{name}: a dirty row was not fed")
            out["check"] = {"one_process_losses": ref_losses,
                            "loss_rel_err": loss_rel,
                            "largest_abs_diff": worst,
                            "dirty_rows": {k: int(t.sum()) for k, t in
                                           full["dirty"].items()},
                            "fed_rows": {k: len(v) for k, v in fed.items()},
                            "problems": problems}
    _emit(out)


def _rank_nccl1(K, dev):
    """(c): ``SGDTrainer(mesh=MeshConfig.of(data=1))`` under NCCL and
    ``SGDTrainer`` without a mesh on the same feeds, in one process."""
    import torch

    import paddle_tpu_torch.nn as nn
    from paddle_tpu_torch.__main__ import params_digest
    from paddle_tpu_torch.models import lstm_benchmark_net
    from paddle_tpu_torch.param import Adam
    from paddle_tpu_torch.parallel import MeshConfig
    from paddle_tpu_torch.parallel import distributed as D
    from paddle_tpu_torch.trainer import SGDTrainer

    def cost():
        nn.reset_naming()
        return lstm_benchmark_net(TEXTCLF_VOCAB, emb_dim=TEXTCLF_EMB,
                                  hid_dim=256,
                                  num_layers=TEXTCLF_LAYERS)[0]

    feeds = [textclf_feed(TEXTCLF_B, TEXTCLF_T, SEED + i)
             for i in range(PARALLEL_NCCL_STEPS)]
    plain = SGDTrainer(cost(), Adam(learning_rate=1e-3), seed=SEED,
                       device=dev)
    a = [plain.train_batch(f).item() for f in feeds]
    mesh = MeshConfig.of(data=1).build()
    meshed = SGDTrainer(cost(), Adam(learning_rate=1e-3), seed=SEED,
                        mesh=mesh)
    torch.cuda.synchronize()
    K.reset_launch_counts()
    b = [meshed.train_batch(f).item() for f in feeds]
    counts = K.launch_counts()
    equal = a == b and params_digest(plain.params) == params_digest(
        meshed.params)
    _emit({"part": "nccl1", "rank": mesh.rank, "backend": D.backend(),
           "losses": b, "equal": equal,
           "launches": {"by_library": {k: v for k, v in counts.items()
                                       if v},
                        "by_path": {k: v for k, v in counts.by_path.items()
                                    if v}}})


def parallel_rank(part: str, d: str) -> int:
    """One rank of a phase-21 world (the launcher's environment wires
    it)."""
    sys.path.insert(0, ROOT)
    from paddle_tpu_torch.ops import kernels as K
    from paddle_tpu_torch.parallel import distributed as D

    D.initialize_distributed()
    dev = D.rank_device()
    if part == "flagship_ml":
        _rank_flagship(K, dev)
        _rank_movielens(K, dev)
    elif part == "nccl1":
        _rank_nccl1(K, dev)
    else:
        raise ValueError(part)
    D.shutdown_distributed()
    return 0


def _gxx() -> str:
    """The host C++ compiler the native data core is built with."""
    try:
        out = subprocess.run(["g++", "--version"], capture_output=True,
                             text=True, timeout=60)
        return "g++: " + (out.stdout.splitlines() or ["?"])[0]
    except OSError as e:
        return f"g++: not found ({e})"


def main() -> int:
    if sys.argv[1:2] == ["--parallel-rank"]:
        return parallel_rank(sys.argv[2], sys.argv[3])
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
    # every phase but dataio reads an empty data home: a populated
    # ~/.cache/paddle_tpu would otherwise swap their synthetic streams for
    # real files (child processes inherit it)
    import atexit
    import shutil
    import tempfile

    empty_home = tempfile.mkdtemp(prefix="chip_smoke_data_home_")
    atexit.register(shutil.rmtree, empty_home, True)
    os.environ["PADDLE_TPU_DATA_HOME"] = empty_home
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
        from paddle_tpu_torch.data import native

        t0 = time.perf_counter()
        if not native.native_available():
            fail("build", f"native data core: {native.build_error()}")
        print(f"build: native data core {time.perf_counter() - t0:.2f} s "
              f"({os.path.basename(native.library_path())}; {_gxx()})",
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
        rows += check_lstm_b512(K, flush, dev)
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
        torch.cuda.empty_cache()
        phase = "seqdata"
        seqdata_launches = seqdata_path(K, dev, card)
        torch.cuda.empty_cache()
        phase = "mixed"
        mixed_launches = mixed_path(K, dev, card)
        torch.cuda.empty_cache()
        phase = "deploy"
        deploy_launches = deploy_path(K, dev, card)
        torch.cuda.empty_cache()
        phase = "frontdoor"
        frontdoor_launches = frontdoor_path(K, dev, card)
        torch.cuda.empty_cache()
        phase = "dataio"
        dataio_launches = dataio_path(K, dev, card)
        torch.cuda.empty_cache()
        phase = "delivery"
        delivery_launches = delivery_path(K, dev, card)
        torch.cuda.empty_cache()
        phase = "parallel"
        parallel_launches = parallel_path(K, dev, card)
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
        elif name in MIXED_ROWS:
            # bench row lstm_b512h256r: phase 16's remat run
            src, key = mixed_launches["remat"], (
                "lstm_forward" if name.startswith("lstm_forward")
                else "lstm_backward")
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
        if name in SEQDATA_ROWS:
            # the seqdata phase's parts that reach this row's kernel (the
            # packed arm's count is 0: a reset LSTM takes the scan)
            row["seqdata_launches"] = {
                part: seqdata_launches[part][key]
                for part in SEQDATA_ROWS[name]}
            row["seqdata_launches_by_path"] = {
                part: seqdata_launches[part].by_path[key]
                for part in SEQDATA_ROWS[name]}
        if name in MIXED_PART_ROWS:
            # phase 16's parts that launch this row's kernel (K9r twice a
            # step under remat: the backward's recompute)
            lib = ("lstm_forward" if name.startswith("lstm_forward")
                   else "lstm_backward" if name.startswith("lstm_backward")
                   else name.replace("_residuals", ""))
            row["mixed_launches"] = {
                part: mixed_launches[part][lib]
                for part in MIXED_PART_ROWS[name]}
            row["mixed_launches_by_path"] = {
                part: mixed_launches[part].by_path[lib]
                for part in MIXED_PART_ROWS[name]}
        if name in DEPLOY_PART_ROWS:
            # phase 17's parts: the training steps that make the bundle's
            # weights, and each bundle served in bucket mode
            lib = ("lstm_forward" if name.startswith("lstm_forward")
                   else "lstm_backward")
            row["deploy_launches"] = {
                part: deploy_launches[part][lib]
                for part in DEPLOY_PART_ROWS[name]}
            row["deploy_launches_by_path"] = {
                part: deploy_launches[part].by_path[lib]
                for part in DEPLOY_PART_ROWS[name]}
        if name in FRONTDOOR_ROWS:
            # phase 18's parts: the demo copy's training and generation,
            # the v2 script's training and infer
            lib, parts = FRONTDOOR_ROWS[name]
            row["frontdoor_launches"] = {
                part: frontdoor_launches[part][lib] for part in parts}
            row["frontdoor_launches_by_path"] = {
                part: frontdoor_launches[part].by_path[lib]
                for part in parts}
        if name in DATAIO_ROWS:
            # phase 19's parts: the provider-fed textclf training and its
            # test pass, the demo's training and generation over wmt14.tgz
            lib, parts = DATAIO_ROWS[name]
            row["dataio_launches"] = {
                part: dataio_launches[part][lib] for part in parts}
            row["dataio_launches_by_path"] = {
                part: dataio_launches[part].by_path[lib] for part in parts}
        if name in DELIVERY_ROWS:
            # phase 20's parts: the trainer's passes (with each publish's
            # warm step), serving across the hot swaps, the fleet
            lib, parts = DELIVERY_ROWS[name]
            row["delivery_launches"] = {
                part: delivery_launches[part][lib] for part in parts}
            row["delivery_launches_by_path"] = {
                part: delivery_launches[part].by_path[lib] for part in parts}
        if name in PARALLEL_ROWS:
            # phase 21's ranks: the launched command line (bf16, f32), the
            # flagship's data-parallel step, the world of 1 under NCCL
            lib, parts = PARALLEL_ROWS[name]
            row["parallel_launches"] = {
                part: parallel_launches[part].get(lib, 0) for part in parts}
            row["parallel_launches_by_path"] = {
                part: parallel_launches[part].by_path.get(lib, {})
                for part in parts}
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
