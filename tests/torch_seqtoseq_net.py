"""The reference's demo/seqToseq compositions, written once for either
package's layer DSL: the generation net (``seqtoseq_generator``) and the
training net through ``recurrent_group`` (``seqtoseq_trainer``), with the
reversal task's feed (``seqtoseq_feed``).  ``tests/test_torch_recurrent.py``
and ``tests/test_torch_group_train.py`` build them with both packages,
``tests/test_torch_cuda.py`` with the port's on the card and on the CPU,
and ``chip_smoke.py`` with the port's at the WMT14 widths.  Imports neither
jax nor torch."""

import numpy as np


def _encoder(nn, src, E, H, D, A):
    """Bidirectional ``grumemory`` encoder, ``enc_proj`` and the decoder's
    ``boot`` from the reverse GRU's first step -> (enc, enc_proj, boot)."""
    emb = nn.embedding(src, E, name="src_emb")
    fw = nn.grumemory(emb, H, name="enc_fw")
    bw = nn.grumemory(emb, H, reverse=True, name="enc_bw")
    enc = nn.concat([fw, bw], name="enc")
    enc_proj = nn.fc(enc, A, act="linear", bias_attr=False, name="enc_proj")
    s0 = nn.fc(nn.first_seq(bw), D, act="tanh", name="boot")
    return enc, enc_proj, s0


def _decoder_step(nn, net, e, enc_s, encp_s, s_mem, V, D):
    """One decoder frame: ``simple_attention`` + ``mixed`` + ``gru_unit`` +
    a logits ``fc`` -> [logits, new state]."""
    ctx = net.simple_attention(enc_s, encp_s, s_mem, name="att")
    m = nn.mixed(3 * D, input=[nn.full_matrix_projection(e),
                               nn.full_matrix_projection(ctx)],
                 bias_attr=True, name="dec_in")
    h = net.gru_unit(m, s_mem, size=D, gru_bias_attr=False, name="dec_gru")
    return [nn.fc(h, V, act="linear", name="readout"), h]


def seqtoseq_generator(nn, net, V=40, E=16, H=16, D=16, A=8, beam=3,
                       max_len=8):
    """The reference's demo/seqToseq generation composition
    (``tests/test_convergence.py:179-244``) with either package's DSL:
    bidirectional ``grumemory`` encoder, ``enc_proj`` and a ``boot`` from
    the reverse GRU's first step; the step net is ``simple_attention`` +
    ``mixed`` + ``gru_unit`` + a logits ``fc``, generated by
    ``beam_search``."""
    src = nn.data("src", size=V, is_seq=True, dtype="int32")
    enc, enc_proj, s0 = _encoder(nn, src, E, H, D, A)

    def gen_step(prev_tok, enc_s, encp_s, s_mem):
        e = nn.embedding(prev_tok, E, name="trg_emb")
        return _decoder_step(nn, net, e, enc_s, encp_s, s_mem, V, D)

    return nn.beam_search(
        gen_step, input=[nn.GeneratedInput(size=V, bos_id=0, eos_id=1),
                         nn.StaticInput(enc), nn.StaticInput(enc_proj)],
        memories=[nn.Memory("s", D, boot=s0)], beam_size=beam,
        max_length=max_len, name="gen")


def seqtoseq_trainer(nn, net, V=40, E=16, H=16, D=16, A=8):
    """The reference's demo/seqToseq training composition
    (``tests/test_convergence.py:179-218``): the same encoder and step net
    as ``seqtoseq_generator`` (so trained parameters drop into it by name),
    the step run over the embedded target by ``recurrent_group`` ``dec``
    and a token ``classification_cost`` ``cost`` -> the cost layer."""
    src = nn.data("src", size=V, is_seq=True, dtype="int32")
    trg = nn.data("trg_in", size=V, is_seq=True, dtype="int32")
    lab = nn.data("trg_lab", size=V, is_seq=True, dtype="int32")
    enc, enc_proj, s0 = _encoder(nn, src, E, H, D, A)
    y_emb = nn.embedding(trg, E, name="trg_emb")

    def step(y_t, enc_s, encp_s, s_mem):
        return _decoder_step(nn, net, y_t, enc_s, encp_s, s_mem, V, D)

    dec = nn.recurrent_group(
        step, input=[y_emb, nn.StaticInput(enc), nn.StaticInput(enc_proj)],
        memories=[nn.Memory("s", D, boot=s0)], name="dec")
    return nn.classification_cost(dec, lab, name="cost")


def seqtoseq_feed(rng, B, V, S, T=None):
    """The reversal task of ``tests/test_convergence.py:164-177`` for
    ``seqtoseq_trainer``: sources of 3..S-1 symbols (ids 3..V-1), the
    target the reversed source after ``<s>`` (0), labels ending in
    ``<e>`` (1) -> a feed dict of (ids, lengths) pairs."""
    T = T or S + 1
    lens = rng.randint(3, S, B)
    src = np.zeros((B, S), np.int32)
    trg_in = np.zeros((B, T), np.int32)
    trg_lab = np.ones((B, T), np.int32)
    for i, L in enumerate(lens):
        seq = rng.randint(3, V, L)
        src[i, :L] = seq
        rev = seq[::-1]
        trg_in[i, 1:L + 1] = rev
        trg_lab[i, :L] = rev
        trg_lab[i, L] = 1
    tl = np.minimum(lens + 1, T).astype(np.int32)
    return {"src": (src, lens.astype(np.int32)), "trg_in": (trg_in, tl),
            "trg_lab": (trg_lab, tl)}
