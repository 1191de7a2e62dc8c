"""The reference's demo/seqToseq v2 script (api_train_v2.py), written once
for either package's ``paddle.v2`` facade: the training net through
``paddle.layer.recurrent_group`` (``v2_seqtoseq_trainer``), the generation
net over a ``beam_search`` layer with the same parameter names
(``v2_seqtoseq_generator``), and the wmt14 reader and feeding the script
trains on (``v2_seqtoseq_reader``).  The composition is
``tests/torch_seqtoseq_net.py``'s: a bidirectional ``grumemory`` encoder,
``enc_proj`` and a ``boot`` from the reverse GRU's first step; the
decoder frame is ``simple_attention`` + ``mixed`` + ``gru_unit`` + a
logits readout.  ``tests/test_torch_v2.py`` builds it with both packages,
``tests/test_torch_cuda.py`` and ``chip_smoke.py`` with the port's at the
WMT14 widths.  Imports neither jax nor torch."""

#: the data layers, in the order of the wmt14 stream's fields
FEEDING = {"source_language_word": 0, "target_language_word": 1,
           "target_language_next_word": 2}


def _encoder(paddle, V, E, H, D, A):
    """-> (enc, enc_proj, boot)."""
    src = paddle.layer.data(
        name="source_language_word",
        type=paddle.data_type.integer_value_sequence(V))
    emb = paddle.layer.embedding(input=src, size=E, name="src_emb")
    fw = paddle.layer.grumemory(input=emb, size=H, name="enc_fw")
    bw = paddle.layer.grumemory(input=emb, size=H, reverse=True,
                                name="enc_bw")
    enc = paddle.layer.concat(input=[fw, bw], name="enc")
    enc_proj = paddle.layer.fc(input=enc, size=A,
                               act=paddle.activation.Linear(),
                               bias_attr=False, name="enc_proj")
    boot = paddle.layer.fc(input=paddle.layer.first_seq(input=bw), size=D,
                           act=paddle.activation.Tanh(), name="boot")
    return enc, enc_proj, boot


def _decoder_frame(paddle, e, enc_s, encp_s, s_mem, V, D):
    """One decoder frame -> [logits, new state]."""
    ctx = paddle.networks.simple_attention(
        encoded_sequence=enc_s, encoded_proj=encp_s, decoder_state=s_mem,
        name="att")
    m = paddle.layer.mixed(
        size=3 * D, input=[paddle.layer.full_matrix_projection(input=e),
                           paddle.layer.full_matrix_projection(input=ctx)],
        bias_attr=True, name="dec_in")
    h = paddle.networks.gru_unit(input=m, out_mem=s_mem, size=D,
                                 gru_bias_attr=False, name="dec_gru")
    logits = paddle.layer.fc(input=h, size=V,
                             act=paddle.activation.Linear(),
                             name="readout")
    return [logits, h]


def v2_seqtoseq_trainer(paddle, V=40, E=16, H=16, D=16, A=8):
    """The training net -> its ``classification_cost`` layer ``cost``."""
    enc, enc_proj, boot = _encoder(paddle, V, E, H, D, A)
    trg = paddle.layer.data(
        name="target_language_word",
        type=paddle.data_type.integer_value_sequence(V))
    lab = paddle.layer.data(
        name="target_language_next_word",
        type=paddle.data_type.integer_value_sequence(V))
    y_emb = paddle.layer.embedding(input=trg, size=E, name="trg_emb")

    def step(y_t, enc_s, encp_s, s_mem):
        return _decoder_frame(paddle, y_t, enc_s, encp_s, s_mem, V, D)

    dec = paddle.layer.recurrent_group(
        step, input=[y_emb, paddle.layer.StaticInput(enc),
                     paddle.layer.StaticInput(enc_proj)],
        memories=[paddle.layer.memory("s", D, boot=boot)], name="dec")
    return paddle.layer.classification_cost(input=dec, label=lab,
                                            name="cost")


def v2_seqtoseq_generator(paddle, V=40, E=16, H=16, D=16, A=8, beam=3,
                          max_len=8):
    """The generation net, a ``beam_search`` layer ``gen`` over the
    trainer's parameters (<s> = 0, <e> = 1)."""
    enc, enc_proj, boot = _encoder(paddle, V, E, H, D, A)

    def gen_step(prev_tok, enc_s, encp_s, s_mem):
        e = paddle.layer.embedding(input=prev_tok, size=E, name="trg_emb")
        return _decoder_frame(paddle, e, enc_s, encp_s, s_mem, V, D)

    return paddle.layer.beam_search(
        gen_step,
        input=[paddle.layer.GeneratedInput(size=V, bos_id=0, eos_id=1),
               paddle.layer.StaticInput(enc),
               paddle.layer.StaticInput(enc_proj)],
        memories=[paddle.layer.memory("s", D, boot=boot)],
        beam_size=beam, max_length=max_len, name="gen")


def v2_seqtoseq_reader(paddle, V, n, batch):
    """``paddle.batch`` over ``paddle.dataset.wmt14.train``: n // batch
    batches of (src, trg, trg_next) rows."""
    return paddle.batch(paddle.dataset.wmt14.train(dict_size=V, n=n), batch)


def v2_test_sources(paddle, V, n):
    """The first n sources of wmt14's test split, as one-field rows."""
    return [(src,) for src, _, _ in paddle.dataset.wmt14.test(
        dict_size=V, n=n)()]
