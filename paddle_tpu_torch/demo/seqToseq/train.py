"""WMT14 attention NMT — the port's copy of ``demo/seqToseq/train.py`` (the
reference's flagship: bidirectional GRU encoder + Bahdanau-attention
decoder + beam-search generation, demo/seqToseq/api_train_v2.py:90-189).

    python -m paddle_tpu_torch.demo.seqToseq.train --passes 1 --generate
    python -m paddle_tpu_torch.demo.seqToseq.train --device cpu ...

A step is ``Seq2SeqAttention.loss`` -> ``torch.autograd.grad`` -> the
port's ``Adam``; on the card it runs the GRU kernels (K3 with residuals,
K4), the attention decoder's (K5, K6) and the CE readout's (K1, K2).
``--generate`` beam-searches the first batch's first 4 sources (K3, K7).
``main`` returns what it ran: the losses, each step's seconds, the target
words, the tokens and scores generated, the model and its parameters.
"""

import argparse
import time

import numpy as np
import torch

import paddle_tpu_torch.data as data
import paddle_tpu_torch.models as models
from paddle_tpu_torch.param.optimizers import Adam


def make_batches(dict_size, n, batch_size, max_src=32, max_trg=33):
    """Bucket-pad wmt14 rows (the real files under the data home when
    present, else the synthetic stream) into fixed-shape batches."""
    reader = data.datasets.wmt14("train", dict_size=dict_size, n=n)
    rows = list(reader())
    batches = []
    for i in range(0, len(rows) - batch_size + 1, batch_size):
        chunk = rows[i : i + batch_size]
        S = min(max(len(r[0]) for r in chunk), max_src)
        T = min(max(len(r[1]) for r in chunk), max_trg)
        b = {
            "src_ids": np.zeros((batch_size, S), np.int32),
            "src_len": np.zeros((batch_size,), np.int32),
            "trg_in": np.zeros((batch_size, T), np.int32),
            "trg_next": np.zeros((batch_size, T), np.int32),
            "trg_len": np.zeros((batch_size,), np.int32),
        }
        for j, (src, trg, trg_next) in enumerate(chunk):
            src, trg, trg_next = src[:S], trg[:T], trg_next[:T]
            b["src_ids"][j, : len(src)] = src
            b["src_len"][j] = len(src)
            b["trg_in"][j, : len(trg)] = trg
            b["trg_next"][j, : len(trg_next)] = trg_next
            b["trg_len"][j] = len(trg)
        batches.append(b)
    return batches


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--passes", type=int, default=1)
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--dict-size", type=int, default=1000)
    ap.add_argument("--emb-dim", type=int, default=64)
    ap.add_argument("--hid-dim", type=int, default=64)
    ap.add_argument("--n", type=int, default=256)
    ap.add_argument("--beam-size", type=int, default=3)
    ap.add_argument("--generate", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    m = models.Seq2SeqAttention(
        src_vocab=args.dict_size, trg_vocab=args.dict_size,
        emb_dim=args.emb_dim, enc_dim=args.hid_dim, dec_dim=args.hid_dim,
        att_dim=args.hid_dim, device=args.device)
    params = {k: v.requires_grad_() for k, v in m.init(seed=0).items()}
    opt = Adam(learning_rate=1e-3)
    opt_state = opt.init_state(params)
    on_card = m.device.type == "cuda"

    def step(batch):
        loss = m.loss(params, batch)
        grads = torch.autograd.grad(loss, list(params.values()))
        opt.update(params, dict(zip(params, grads)), opt_state)
        return loss

    batches = make_batches(args.dict_size, args.n, args.batch_size)
    words = sum(int(b["trg_len"].sum()) for b in batches)
    losses, step_s = [], []
    for pass_id in range(args.passes):
        t0 = time.time()
        for i, b in enumerate(batches):
            t1 = time.perf_counter()
            loss = step(b).item()                       # synchronises
            if on_card:
                torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t1)
            losses.append(loss)
            if i % 4 == 0:
                print(f"pass {pass_id} batch {i} cost {loss:.4f}")
        wps = words / (time.time() - t0)
        print(f"== pass {pass_id} done, {wps:.0f} target words/s ==")

    toks = scores = None
    if args.generate:
        b = batches[0]
        toks, scores = m.beam_search(
            params, b["src_ids"][:4], b["src_len"][:4],
            beam_size=args.beam_size, max_len=20)
        toks, scores = toks.cpu().numpy(), scores.float().cpu().numpy()
        for i in range(4):
            src = b["src_ids"][i, : b["src_len"][i]].tolist()
            print(f"src : {src}")
            for k in range(args.beam_size):
                seq = toks[i, k].tolist()
                seq = seq[: seq.index(1) + 1] if 1 in seq else seq
                print(f"  beam{k} ({scores[i, k]:.2f}): {seq}")
    return {"losses": losses, "step_s": step_s, "words": words,
            "batches": batches, "tokens": toks, "scores": scores,
            "model": m, "params": params}


if __name__ == "__main__":
    main()
