"""The reference's demo/seqToseq generation composition, written once for
either package's layer DSL: ``tests/test_torch_recurrent.py`` builds it
with both, ``tests/test_torch_cuda.py`` with the port's on the card and on
the CPU, and ``chip_smoke.py`` with the port's at the WMT14 widths.
Imports neither jax nor torch."""


def seqtoseq_generator(nn, net, V=40, E=16, H=16, D=16, A=8, beam=3,
                       max_len=8):
    """The reference's demo/seqToseq generation composition
    (``tests/test_convergence.py:179-244``) with either package's DSL:
    bidirectional ``grumemory`` encoder, ``enc_proj`` and a ``boot`` from
    the reverse GRU's first step; the step net is ``simple_attention`` +
    ``mixed`` + ``gru_unit`` + a logits ``fc``, generated by
    ``beam_search``."""
    src = nn.data("src", size=V, is_seq=True, dtype="int32")
    emb = nn.embedding(src, E, name="src_emb")
    fw = nn.grumemory(emb, H, name="enc_fw")
    bw = nn.grumemory(emb, H, reverse=True, name="enc_bw")
    enc = nn.concat([fw, bw], name="enc")
    enc_proj = nn.fc(enc, A, act="linear", bias_attr=False, name="enc_proj")
    s0 = nn.fc(nn.first_seq(bw), D, act="tanh", name="boot")

    def gen_step(prev_tok, enc_s, encp_s, s_mem):
        e = nn.embedding(prev_tok, E, name="trg_emb")
        ctx = net.simple_attention(enc_s, encp_s, s_mem, name="att")
        m = nn.mixed(3 * D, input=[nn.full_matrix_projection(e),
                                   nn.full_matrix_projection(ctx)],
                     bias_attr=True, name="dec_in")
        h = net.gru_unit(m, s_mem, size=D, gru_bias_attr=False,
                         name="dec_gru")
        return [nn.fc(h, V, act="linear", name="readout"), h]

    return nn.beam_search(
        gen_step, input=[nn.GeneratedInput(size=V, bos_id=0, eos_id=1),
                         nn.StaticInput(enc), nn.StaticInput(enc_proj)],
        memories=[nn.Memory("s", D, boot=s0)], beam_size=beam,
        max_length=max_len, name="gen")
