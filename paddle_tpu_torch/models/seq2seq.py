"""Attention seq2seq (WMT14 NMT) — the flagship model.

Counterpart of ``paddle_tpu/models/seq2seq.py``: a 512-d bidirectional GRU
encoder, a Bahdanau-attention GRU decoder and a 30k-vocab readout, with
the teacher-forced training loss (``loss``: the fused-backward decoder of
``ops/attention_decoder.py`` and the fused readout + CE of
``ops/losses.py``) and beam-search and greedy generation through the
decode engine (``ops/decode.py``).  A training step is
``loss`` -> ``torch.autograd.grad`` over the params -> an optimizer's
``update`` (``param/optimizers.py``), as the reference's bench drives it.

Parameters are a dict of float32 tensors in the reference's layout and
under its keys (``[in, out]`` matrices, GRU gate order ``[r, u, c]``), so
``params_from_jax`` carries a JAX parameter dict across unchanged.

Special token ids follow the reference: <s>=0, <e>=1, <unk>=2.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Union

import numpy as np
import torch

import paddle_tpu_torch.ops as O
from paddle_tpu_torch.device import resolve_device
from paddle_tpu_torch.param.convert import params_from_jax

__all__ = ["Seq2SeqAttention", "params_from_jax", "BOS", "EOS", "UNK"]

BOS, EOS, UNK = 0, 1, 2

Params = Dict[str, torch.Tensor]


class Seq2SeqAttention:
    """Configuration + functions over a params dict, as in the reference.
    ``device`` (default ``cuda``) is where ``init`` puts the parameters;
    without a card, leaving it unset raises."""

    def __init__(self, src_vocab: int = 30000, trg_vocab: int = 30000,
                 emb_dim: int = 512, enc_dim: int = 512, dec_dim: int = 512,
                 att_dim: int = 512, *,
                 device: Optional[Union[str, torch.device]] = None):
        self.src_vocab, self.trg_vocab = int(src_vocab), int(trg_vocab)
        self.emb_dim, self.enc_dim = int(emb_dim), int(enc_dim)
        self.dec_dim, self.att_dim = int(dec_dim), int(att_dim)
        self.device = resolve_device(device)

    # ------------------------------------------------------------------

    def init(self, seed: int = 0) -> Params:
        """Random float32 parameters from a numpy seed, with the reference's
        shapes and scales (the values differ from ``jax.random``'s)."""
        E, H, D, A = self.emb_dim, self.enc_dim, self.dec_dim, self.att_dim
        gen = np.random.default_rng(seed)

        def nrm(shape, scale=None):
            scale = scale or (2.0 / (shape[0] + shape[-1])) ** 0.5
            a = gen.standard_normal(shape, dtype=np.float32)
            a *= np.float32(scale)
            return a

        def zeros(n):
            return np.zeros((n,), np.float32)

        p = {
            "src_emb": nrm((self.src_vocab, E), 0.01),
            "trg_emb": nrm((self.trg_vocab, E), 0.01),
            "enc_fw_wx": nrm((E, 3 * H)),
            "enc_fw_wh": nrm((H, 3 * H)),
            "enc_fw_b": zeros(3 * H),
            "enc_bw_wx": nrm((E, 3 * H)),
            "enc_bw_wh": nrm((H, 3 * H)),
            "enc_bw_b": zeros(3 * H),
            "boot_w": nrm((H, D)),
            "boot_b": zeros(D),
            "enc_proj_w": nrm((2 * H, A)),
            "enc_proj_b": zeros(A),
            "att_dec_w": nrm((D, A)),
            "att_v": nrm((A,), 0.05),
            "dec_wx": nrm((E + 2 * H, 3 * D)),
            "dec_wh": nrm((D, 3 * D)),
            "dec_b": zeros(3 * D),
            "out_w": nrm((D, self.trg_vocab)),
            "out_b": zeros(self.trg_vocab),
        }
        return {k: torch.from_numpy(v).to(self.device) for k, v in p.items()}

    # ------------------------------------------------------------------

    def encode(self, params: Params, src_ids: torch.Tensor,
               src_mask: torch.Tensor):
        """[B, S] ids -> (enc [B, S, 2H], enc_proj [B, S, A], s0 [B, D]).
        enc/enc_proj come back in the compute dtype: every decode step
        re-reads them."""
        emb = O.embedding_lookup(params["src_emb"], src_ids)
        emb = emb * src_mask[..., None].to(emb.dtype)
        h_fw, h_bw, h_bw_fin = O.bigru_layer(
            emb, src_mask, params["enc_fw_wx"], params["enc_fw_wh"],
            params["enc_fw_b"], params["enc_bw_wx"], params["enc_bw_wh"],
            params["enc_bw_b"])
        enc = torch.cat([h_fw, h_bw], dim=-1)
        enc_proj = O.linear(enc, params["enc_proj_w"], params["enc_proj_b"])
        s0 = torch.tanh(O.linear(h_bw_fin, params["boot_w"],
                                 params["boot_b"]))
        enc, enc_proj = O.mxu_cast(enc, enc_proj)
        return enc, enc_proj, s0

    def _dec_step(self, params: Params, y_emb, s, enc, enc_proj, src_mask):
        """One decoder step: attention with the current state, GRU advance.
        Returns (s_new [.., D], ctx [.., 2H])."""
        scores = O.additive_attention_scores(enc_proj, s, params["att_dec_w"],
                                             params["att_v"])
        ctx, _ = O.attend(scores, enc, src_mask)
        x = torch.cat([y_emb, ctx], dim=-1)
        xp = O.linear(x, params["dec_wx"], params["dec_b"])
        s_new = O.gru_step(xp, s, params["dec_wh"])
        return s_new, ctx

    # ------------------------------------------------------------------

    def loss(self, params: Params, batch: Mapping) -> torch.Tensor:
        """Teacher-forced token CE (scalar, float32).  batch: src_ids
        [B, S], src_len [B], trg_in [B, T] (starts with <s>), trg_next
        [B, T] (ends with <e>), trg_len [B]; arrays or tensors."""
        dev = self.device
        src_ids, src_len, trg_in, trg_next, trg_len = (
            torch.as_tensor(batch[k], device=dev).long()
            for k in ("src_ids", "src_len", "trg_in", "trg_next",
                      "trg_len"))
        S, T = src_ids.shape[1], trg_in.shape[1]
        src_mask = O.mask_from_lengths(src_len, S)
        trg_mask = O.mask_from_lengths(trg_len, T)
        enc, enc_proj, s0 = self.encode(params, src_ids, src_mask)
        y_emb = O.embedding_lookup(params["trg_emb"], trg_in)   # [B, T, E]
        states = O.attention_gru_decoder(
            y_emb, s0, enc, enc_proj, src_mask, trg_mask,
            params["att_dec_w"], params["att_v"], params["dec_wx"],
            params["dec_b"], params["dec_wh"])                  # [B, T, D]
        return O.sequence_softmax_ce_readout(
            states, params["out_w"], params["out_b"], trg_next, trg_mask)

    # ------------------------------------------------------------------

    def _decode_step_fn(self, params: Params, enc, enc_proj, src_mask):
        """Engine step protocol: embed the previous token, advance the
        attention-GRU cell, hand the pre-readout states to the engine."""

        def step_fn(tokens, state):
            y_emb = O.embedding_lookup(params["trg_emb"], tokens)
            s_new, _ = self._dec_step(params, y_emb, state["s"], enc,
                                      enc_proj, src_mask)
            return s_new, {"s": s_new}

        return step_fn

    def _prepare(self, src_ids, src_len):
        src_ids = torch.as_tensor(src_ids, device=self.device).long()
        src_len = torch.as_tensor(src_len, device=self.device).long()
        return src_ids, src_len

    @torch.no_grad()
    def greedy_decode(self, params: Params, src_ids, src_len, *,
                      max_len: int = 50, early_exit: Optional[bool] = None):
        """Argmax decode -> (tokens [B, max_len], scores [B]);
        token-identical to ``beam_search(beam_size=1)``."""
        src_ids, src_len = self._prepare(src_ids, src_len)
        B, S = src_ids.shape
        src_mask = O.mask_from_lengths(src_len, S)
        enc, enc_proj, s0 = self.encode(params, src_ids, src_mask)
        return O.greedy_decode(
            self._decode_step_fn(params, enc, enc_proj, src_mask),
            O.LinearReadout(params["out_w"], params["out_b"]), {"s": s0},
            batch_size=B, vocab_size=self.trg_vocab, max_len=max_len,
            bos=BOS, eos=EOS, early_exit=early_exit)

    @torch.no_grad()
    def beam_search(self, params: Params, src_ids, src_len, *,
                    beam_size: int = 3, max_len: int = 50,
                    length_penalty: float = 0.0,
                    early_exit: Optional[bool] = None):
        """Batched beam search -> (tokens [B, K, max_len], scores [B, K])
        sorted best-first."""
        src_ids, src_len = self._prepare(src_ids, src_len)
        B, S = src_ids.shape
        K = beam_size
        src_mask = O.mask_from_lengths(src_len, S)
        enc, enc_proj, s0 = self.encode(params, src_ids, src_mask)

        def tile(x):
            return x.repeat_interleave(K, dim=0)

        step_fn = self._decode_step_fn(params, tile(enc), tile(enc_proj),
                                       tile(src_mask))
        return O.beam_decode(
            step_fn, O.LinearReadout(params["out_w"], params["out_b"]),
            {"s": s0}, batch_size=B, beam_size=K,
            vocab_size=self.trg_vocab, max_len=max_len, bos=BOS, eos=EOS,
            length_penalty=length_penalty, early_exit=early_exit)
