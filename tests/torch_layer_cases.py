"""The layer cases of ``tests/test_layer_grad_sweep.py`` that the port can
build, written once for either package's layer DSL: each ``case_<name>(nn,
rng)`` builds a minimal net around one layer (with an upstream fc or conv
where the layer has no parameters, so the check reaches its backward) and
returns (output layer, feed).  The reference's cases are copied as they
are; the cases after them (``case_get_output`` onwards) are this port's
own, for layers and options the reference sweep does not reach.
``tests/test_torch_layer_sweep.py`` builds each with both packages.
Imports neither jax nor torch."""

import numpy as np

B, D, T, V = 3, 6, 5, 12
IMG_H, IMG_W, IMG_C = 6, 6, 3


def _dense(nn, rng, name="x", size=D):
    return nn.data(name, size=size), {name: rng.randn(B, size).astype(np.float32)}


def _seq(nn, rng, name="xs", size=D, t=T):
    lay = nn.data(name, size=size, is_seq=True)
    lengths = rng.randint(2, t + 1, B).astype(np.int32)
    vals = rng.randn(B, t, size).astype(np.float32)
    return lay, {name: (vals, lengths)}


def _ids(nn, rng, name="ids", t=T, vocab=V):
    lay = nn.data(name, size=0, is_seq=True, dtype="int32")
    lengths = rng.randint(2, t + 1, B).astype(np.int32)
    return lay, {name: (rng.randint(0, vocab, (B, t)).astype(np.int32), lengths)}


def _img(nn, rng, name="img"):
    lay = nn.data(name, size=IMG_C, height=IMG_H, width=IMG_W)
    return lay, {name: rng.randn(B, IMG_H, IMG_W, IMG_C).astype(np.float32)}


def _pre_fc(nn, lay, size=D, name="pre"):
    """fc in front so param-less layers still get their VJP exercised."""
    return nn.fc(lay, size, act="tanh", name=name, bias_attr=False)


def _pre_conv(nn, img, name="prec"):
    return nn.img_conv(img, filter_size=3, num_filters=IMG_C, padding="SAME",
                       act="tanh", name=name)


# each builder: (nn, rng) -> (output LayerOutput, feed dict)

def case_fc(nn, rng):
    x, feed = _dense(nn, rng)
    return nn.fc(x, 4, act="tanh"), feed


def case_fc_seq(nn, rng):
    xs, feed = _seq(nn, rng)
    return nn.fc(xs, 4, act="tanh"), feed


def case_embedding(nn, rng):
    ids, feed = _ids(nn, rng)
    return nn.embedding(ids, 4, vocab_size=V), feed


def case_addto(nn, rng):
    x, feed = _dense(nn, rng)
    h = _pre_fc(nn, x)
    return nn.addto([h, h], act="tanh", bias_attr=True), feed


def case_concat(nn, rng):
    x, feed = _dense(nn, rng)
    return nn.concat([_pre_fc(nn, x, name="p1"), _pre_fc(nn, x, name="p2")]), feed


def case_dropout(nn, rng):
    x, feed = _dense(nn, rng)
    return nn.dropout(_pre_fc(nn, x), 0.5), feed  # eval mode: identity


def case_error_clip(nn, rng):
    # a large threshold: clipping inactive (the clip itself is held in
    # tests/test_torch_text.py)
    x, feed = _dense(nn, rng)
    return nn.error_clip(_pre_fc(nn, x), 1e6), feed


def case_mixed(nn, rng):
    # full_matrix + identity + bias + nonlinearity in one mixed layer
    x, feed = _dense(nn, rng)
    return nn.mixed(size=D, act="tanh", bias_attr=True, input=[
        nn.full_matrix_projection(x),
        nn.identity_projection(x),
    ]), feed


def case_mixed_trans_table(nn, rng):
    ids_flat = nn.data("id1", size=V, dtype="int32")
    x, fx = _dense(nn, rng)
    feed = {**fx, "id1": rng.randint(0, V, (B, 1)).astype(np.int32)}
    return nn.mixed(size=4, input=[
        nn.trans_full_matrix_projection(x, size=4),
        nn.table_projection(ids_flat),
    ]), feed


def case_mixed_identity_offset(nn, rng):
    x, feed = _dense(nn, rng)
    h = _pre_fc(nn, x)
    return nn.mixed(size=3, input=[nn.identity_projection(h, offset=2, size=3)]), feed


def case_mixed_dotmul_scaling(nn, rng):
    x, feed = _dense(nn, rng)
    h = _pre_fc(nn, x)
    return nn.mixed(size=D, input=[
        nn.dotmul_projection(h),
        nn.scaling_projection(h),
        nn.dotmul_operator(a=h, b=h, scale=0.5),
    ]), feed


def case_mixed_context(nn, rng):
    xs, feed = _seq(nn, rng)
    proj = nn.context_projection_input(
        _pre_fc(nn, xs), context_len=3,
        padding_attr=nn.ParamAttr(init="normal", initial_std=0.1))
    return nn.pooling(nn.mixed(input=[proj]), pooling_type="sum"), feed


def case_mixed_conv(nn, rng):
    img, feed = _img(nn, rng)
    return nn.mixed(input=[
        nn.conv_projection(img, filter_size=3, num_filters=2, padding=1),
        nn.conv_projection(img, filter_size=5, num_filters=2, padding=2),
    ]), feed


def case_mixed_conv_operator(nn, rng):
    img, fi = _img(nn, rng)
    fsz = 3 * 3 * IMG_C * 2
    flt = nn.data("flt", size=fsz)
    feed = {**fi, "flt": rng.randn(B, fsz).astype(np.float32)}
    return nn.mixed(input=[
        nn.conv_operator(img=img, filter=_pre_fc(nn, flt, fsz, "pf"),
                         filter_size=3, num_filters=2, padding=1),
    ]), feed


def case_tensor(nn, rng):
    a, fa = _dense(nn, rng, "a", 4)
    b, fb = _dense(nn, rng, "b", 3)
    return nn.tensor(a, b, 5), {**fa, **fb}


def case_scaling(nn, rng):
    w, fw = _dense(nn, rng, "w", 1)
    x, fx = _dense(nn, rng, "x")
    return nn.scaling(w, _pre_fc(nn, x)), {**fw, **fx}


def case_power(nn, rng):
    w, fw = _dense(nn, rng, "w", 1)
    x, fx = _dense(nn, rng, "x")
    fx["x"] = np.abs(fx["x"]) + 0.5  # positive base keeps x**w finite
    return nn.power(_pre_fc(nn, w, 1, "pw"), x), {**fw, **fx}


def case_slope_intercept(nn, rng):
    x, feed = _dense(nn, rng)
    return nn.slope_intercept(_pre_fc(nn, x), slope=2.0, intercept=0.5), feed


def case_sum_to_one_norm(nn, rng):
    x, feed = _dense(nn, rng)
    feed["x"] = np.abs(feed["x"]) + 0.1
    return nn.sum_to_one_norm(_pre_fc(nn, x)), feed


def case_interpolation(nn, rng):
    w, fw = _dense(nn, rng, "w", 1)
    a, fa = _dense(nn, rng, "a")
    b, fb = _dense(nn, rng, "b")
    return nn.interpolation(w, a, b), {**fw, **fa, **fb}


def case_outer_prod(nn, rng):
    a, fa = _dense(nn, rng, "a", 3)
    b, fb = _dense(nn, rng, "b", 4)
    return nn.outer_prod(_pre_fc(nn, a, 3, "pa"), _pre_fc(nn, b, 4, "pb")), {**fa, **fb}


def case_cos_sim(nn, rng):
    a, fa = _dense(nn, rng, "a")
    b, fb = _dense(nn, rng, "b")
    return nn.cos_sim(a, b), {**fa, **fb}


# ---- sequence layers -------------------------------------------------------

def case_pooling(nn, rng):
    xs, feed = _seq(nn, rng)
    return nn.pooling(_pre_fc(nn, xs), pooling_type="avg"), feed


def case_last_seq(nn, rng):
    xs, feed = _seq(nn, rng)
    return nn.last_seq(_pre_fc(nn, xs)), feed


def case_first_seq(nn, rng):
    xs, feed = _seq(nn, rng)
    return nn.first_seq(_pre_fc(nn, xs)), feed


def case_expand(nn, rng):
    x, fx = _dense(nn, rng, "v", D)
    xs, fs = _seq(nn, rng)
    return nn.expand(_pre_fc(nn, x, D, "pv"), xs), {**fx, **fs}


def case_seq_reverse(nn, rng):
    xs, feed = _seq(nn, rng)
    return nn.pooling(nn.seq_reverse(_pre_fc(nn, xs)), pooling_type="sum"), feed


def case_seq_concat(nn, rng):
    a, fa = _seq(nn, rng, "a")
    b, fb = _seq(nn, rng, "b")
    return nn.pooling(nn.seq_concat(_pre_fc(nn, a, D, "pa"), b), pooling_type="sum"), {**fa, **fb}


def case_context_projection(nn, rng):
    xs, feed = _seq(nn, rng)
    return nn.pooling(nn.context_projection(_pre_fc(nn, xs), context_len=3),
                      pooling_type="sum"), feed


def case_lstmemory(nn, rng):
    xs, feed = _seq(nn, rng)
    return nn.pooling(nn.lstmemory(xs, 4), pooling_type="sum"), feed


def case_grumemory(nn, rng):
    xs, feed = _seq(nn, rng)
    return nn.pooling(nn.grumemory(xs, 4), pooling_type="sum"), feed


def case_bidirectional_rnn(nn, rng):
    xs, feed = _seq(nn, rng)
    return nn.pooling(nn.bidirectional_rnn(xs, 4), pooling_type="sum"), feed


def case_recurrent_group(nn, rng):
    xs, feed = _seq(nn, rng)

    def step(x_t, mem):
        s = nn.fc([x_t, mem], 4, act="tanh", name="cell", bias_attr=False)
        return [s, s]

    return nn.pooling(nn.recurrent_group(step, [xs], [nn.Memory("m", 4)]),
                      pooling_type="sum"), feed


# ---- image layers ----------------------------------------------------------

def case_img_conv(nn, rng):
    img, feed = _img(nn, rng)
    return nn.img_conv(img, filter_size=3, num_filters=4, act="tanh"), feed


def case_img_conv_transpose(nn, rng):
    img, feed = _img(nn, rng)
    return nn.img_conv_transpose(img, filter_size=3, num_filters=2, stride=2), feed


def case_img_pool(nn, rng):
    img, feed = _img(nn, rng)
    return nn.img_pool(_pre_conv(nn, img), pool_size=2), feed


def case_img_cmrnorm(nn, rng):
    img, feed = _img(nn, rng)
    return nn.img_cmrnorm(_pre_conv(nn, img), size=3), feed


def case_batch_norm(nn, rng):
    img, feed = _img(nn, rng)
    return nn.batch_norm(_pre_conv(nn, img), act="relu"), feed


def case_maxout(nn, rng):
    img, feed = _img(nn, rng)
    c = nn.img_conv(img, filter_size=3, num_filters=4, padding="SAME",
                    act="linear", name="prec")
    return nn.maxout(c, groups=2), feed


def case_slice_channels(nn, rng):
    img, feed = _img(nn, rng)
    c = nn.img_conv(img, filter_size=3, num_filters=6, padding="SAME",
                    act="linear", name="prec")
    return nn.slice_channels(c, 1, 4), feed


def case_bilinear_interp(nn, rng):
    img, feed = _img(nn, rng)
    return nn.bilinear_interp(_pre_conv(nn, img), out_h=4, out_w=8), feed


# ---- cost layers ------------------------------------------------------------

def _label_int(nn, rng, n=4, name="lab"):
    return (nn.data(name, size=n, dtype="int32"),
            {name: rng.randint(0, n, (B,)).astype(np.int32)})


def case_classification_cost(nn, rng):
    x, feed = _dense(nn, rng)
    lab, fl = _label_int(nn, rng)
    return nn.classification_cost(nn.fc(x, 4, act="softmax"), lab), {**feed, **fl}


def case_cross_entropy_cost(nn, rng):
    x, feed = _dense(nn, rng)
    lab, fl = _label_int(nn, rng)
    return nn.cross_entropy_cost(nn.fc(x, 4, act="softmax"), lab), {**feed, **fl}


def case_cross_entropy_with_selfnorm(nn, rng):
    x, feed = _dense(nn, rng)
    lab, fl = _label_int(nn, rng)
    return nn.cross_entropy_with_selfnorm(nn.fc(x, 4, act="softmax"), lab), {**feed, **fl}


def case_soft_cross_entropy_cost(nn, rng):
    x, feed = _dense(nn, rng)
    lab = nn.data("lab", size=4)
    p = np.abs(rng.rand(B, 4)).astype(np.float32)
    feed["lab"] = p / p.sum(1, keepdims=True)
    return nn.soft_cross_entropy_cost(nn.fc(x, 4, act="softmax"), lab), feed


def case_mse_cost(nn, rng):
    x, feed = _dense(nn, rng)
    lab = nn.data("lab", size=4)
    feed["lab"] = rng.randn(B, 4).astype(np.float32)
    return nn.mse_cost(nn.fc(x, 4), lab), feed


def case_huber_cost(nn, rng):
    x, feed = _dense(nn, rng)
    lab = nn.data("lab", size=1)
    feed["lab"] = rng.randn(B, 1).astype(np.float32)
    return nn.huber_cost(nn.fc(x, 1), lab), feed


def case_smooth_l1_cost(nn, rng):
    x, feed = _dense(nn, rng)
    lab = nn.data("lab", size=4)
    feed["lab"] = rng.randn(B, 4).astype(np.float32)
    return nn.smooth_l1_cost(nn.fc(x, 4), lab), feed


def case_multi_binary_label_cross_entropy(nn, rng):
    x, feed = _dense(nn, rng)
    lab = nn.data("lab", size=4)
    feed["lab"] = (rng.rand(B, 4) > 0.5).astype(np.float32)
    return nn.multi_binary_label_cross_entropy(nn.fc(x, 4), lab), feed


def case_sum_cost(nn, rng):
    x, feed = _dense(nn, rng)
    return nn.sum_cost(nn.fc(x, 4)), feed


def case_rank_cost(nn, rng):
    l, fl = _dense(nn, rng, "l")
    r, fr = _dense(nn, rng, "r")
    lab = nn.data("lab", size=1)
    feed = {**fl, **fr, "lab": (rng.rand(B, 1) > 0.5).astype(np.float32)}
    return nn.rank_cost(nn.fc(l, 1, name="fl"), nn.fc(r, 1, name="fr"), lab), feed


def case_crf_cost(nn, rng):
    xs, feed = _seq(nn, rng)
    lab = nn.data("lab", size=4, is_seq=True, dtype="int32")
    lengths = feed["xs"][1]
    feed["lab"] = (rng.randint(0, 4, (B, T)).astype(np.int32), lengths)
    return nn.crf_cost(nn.fc(xs, 4, name="emit", bias_attr=False), lab), feed


def case_lstm_step(nn, rng):
    # single-frame cell: pre-summed [B,4H] gates + explicit c state
    x, fx = _dense(nn, rng, "x", 8)  # 4H, H=2
    c = nn.data("c", size=2)
    fx["c"] = rng.randn(B, 2).astype(np.float32) * 0.5
    return nn.lstm_step(x, c, 2), fx


def case_gru_step(nn, rng):
    x, fx = _dense(nn, rng, "x", 6)  # 3H, H=2
    h = nn.data("h", size=2)
    fx["h"] = rng.randn(B, 2).astype(np.float32) * 0.5
    return nn.gru_step(x, h, 2), fx


def case_cos_vm(nn, rng):
    v, fv = _dense(nn, rng, "v", 4)
    m, fm = _dense(nn, rng, "m", 12)
    return nn.cos_vm(_pre_fc(nn, v, 4, "pv"), m), {**fv, **fm}


def case_linear_comb(nn, rng):
    w, fw = _dense(nn, rng, "w", 3)
    m, fm = _dense(nn, rng, "m", 12)
    return nn.linear_comb(_pre_fc(nn, w, 3, "pw"), m, 4), {**fw, **fm}


def case_convex_comb(nn, rng):
    w, fw = _dense(nn, rng, "w", 3)
    m, fm = _dense(nn, rng, "m", 12)
    return nn.convex_comb(_pre_fc(nn, w, 3, "pw"), m, 4), {**fw, **fm}


def case_conv_shift(nn, rng):
    a, fa = _dense(nn, rng, "a", 8)
    b, fb = _dense(nn, rng, "b", 3)
    return nn.conv_shift(_pre_fc(nn, a, 8, "pa"), b), {**fa, **fb}


def case_multiplex(nn, rng):
    idx = nn.data("idx", size=1, dtype="int32")
    a, fa = _dense(nn, rng, "a", 4)
    b, fb = _dense(nn, rng, "b", 4)
    feed = {**fa, **fb, "idx": rng.randint(0, 2, (B, 1)).astype(np.int32)}
    return nn.multiplex(idx, [_pre_fc(nn, a, 4, "pa"),
                              _pre_fc(nn, b, 4, "pb")]), feed


def case_prelu(nn, rng):
    x, feed = _dense(nn, rng)
    return nn.prelu(_pre_fc(nn, x)), feed


def case_data_norm(nn, rng):
    x, feed = _dense(nn, rng)
    return nn.data_norm(x), feed


def case_resize(nn, rng):
    x, feed = _dense(nn, rng)
    return nn.resize(_pre_fc(nn, x), 3), feed


def case_trans(nn, rng):
    # the reference sweep's case of this name, as it is (it reaches
    # seq_concat); the transposes themselves are case_trans_image and
    # case_trans_square below
    a, fa = _seq(nn, rng, "a")
    b, fb = _seq(nn, rng, "b")
    return nn.pooling(nn.seq_concat(_pre_fc(nn, a, D, "pa"), b),
                      pooling_type="sum"), {**fa, **fb}


def case_seq_reshape(nn, rng):
    xs = nn.data("xs", size=4, is_seq=True)
    vals = rng.randn(B, 4, 4).astype(np.float32)
    lengths = np.full((B,), 4, np.int32)  # full rows: reshape is exact
    return nn.pooling(nn.seq_reshape(_pre_fc(nn, xs, 4, "pre"), 8),
                      pooling_type="sum"), {"xs": (vals, lengths)}


def case_sub_seq(nn, rng):
    xs, feed = _seq(nn, rng)
    off = nn.data("off", size=1, dtype="int32")
    sz = nn.data("sz", size=1, dtype="int32")
    feed["off"] = np.zeros((B, 1), np.int32)
    feed["sz"] = np.full((B, 1), 2, np.int32)
    return nn.pooling(nn.sub_seq(_pre_fc(nn, xs), off, sz),
                      pooling_type="sum"), feed


def case_featmap_expand(nn, rng):
    xs, feed = _seq(nn, rng)
    return nn.featmap_expand(_pre_fc(nn, xs), num_filters=2), feed


def case_pad(nn, rng):
    img, feed = _img(nn, rng)
    return nn.pad(_pre_conv(nn, img), pad_h=(1, 1), pad_w=(0, 1)), feed


def case_rotate(nn, rng):
    img, feed = _img(nn, rng)
    return nn.rotate(_pre_conv(nn, img)), feed


def case_block_expand(nn, rng):
    img, feed = _img(nn, rng)
    return nn.pooling(nn.block_expand(_pre_conv(nn, img), block_x=2,
                                      block_y=2, stride_x=2, stride_y=2),
                      pooling_type="sum"), feed


def case_spp(nn, rng):
    img, feed = _img(nn, rng)
    return nn.spp(_pre_conv(nn, img), pyramid_height=2), feed


def case_priorbox(nn, rng):
    img, feed = _img(nn, rng)
    feat = nn.img_pool(_pre_conv(nn, img), pool_size=2)
    return nn.priorbox(feat, img, min_size=[4], max_size=[8]), feed


def case_mdlstmemory(nn, rng):
    img, feed = _img(nn, rng)
    return nn.mdlstmemory(img, 3), feed


def case_lambda_cost(nn, rng):
    s = nn.data("s", size=1, is_seq=True)
    l = nn.data("l", size=1, is_seq=True)
    lens = np.full((B,), 4, np.int32)
    feed = {"s": (rng.randn(B, 4, 1).astype(np.float32), lens),
            "l": (np.abs(rng.randn(B, 4, 1)).astype(np.float32), lens)}
    return nn.lambda_cost(nn.fc(s, 1, name="fs", bias_attr=False), l,
                          NDCG_num=3), feed


def case_ctc_cost(nn, rng):
    xs, feed = _seq(nn, rng, t=8)
    lab = nn.data("lab", size=4, is_seq=True, dtype="int32")
    feed["lab"] = (rng.randint(1, 4, (B, 3)).astype(np.int32),
                   np.full((B,), 2, np.int32))
    feed["xs"] = (feed["xs"][0], np.full((B,), 8, np.int32))
    return nn.ctc_cost(nn.fc(xs, 5, act="linear", name="emit"), lab), feed


def case_warp_ctc(nn, rng):
    # warp-ctc conventions: blank=0, labels in [1, C)
    xs, feed = _seq(nn, rng, t=8)
    lab = nn.data("wlab", size=4, is_seq=True, dtype="int32")
    feed["wlab"] = (rng.randint(1, 4, (B, 3)).astype(np.int32),
                    np.full((B,), 2, np.int32))
    feed["xs"] = (feed["xs"][0], np.full((B,), 8, np.int32))
    return nn.warp_ctc(nn.fc(xs, 5, act="linear", name="wemit"), lab), feed


def case_nce_cost(nn, rng):
    x, feed = _dense(nn, rng)
    lab, fl = _label_int(nn, rng, n=V)
    fl["lab"] = fl["lab"][:, None]
    return nn.nce_cost(x, lab, num_classes=V, num_neg_samples=4), \
        {**feed, **fl}


def case_hsigmoid_cost(nn, rng):
    x, feed = _dense(nn, rng)
    lab, fl = _label_int(nn, rng, n=8)
    fl["lab"] = fl["lab"][:, None]
    return nn.hsigmoid_cost(x, lab, num_classes=8), {**feed, **fl}


def case_selective_fc(nn, rng):
    x, fx = _dense(nn, rng)
    sel = nn.data("sel", size=4)
    fx["sel"] = (rng.rand(B, 4) > 0.3).astype(np.float32)
    return nn.selective_fc(x, sel, 4, act="linear"), fx


def case_cross_channel_norm(nn, rng):
    img, feed = _img(nn, rng)
    return nn.cross_channel_norm(_pre_conv(nn, img)), feed


def case_print_value(nn, rng):
    # identity dataflow; the upstream fc's gradients pass through it
    x, feed = _dense(nn, rng)
    return nn.print_value(_pre_fc(nn, x)), feed


# ---- forward-only layers (no useful gradient) ------------------------------

def case_sampling_id(nn, rng):
    x, feed = _dense(nn, rng)
    return nn.sampling_id(nn.fc(x, 4, act="softmax")), feed


def case_eos_id(nn, rng):
    ids, feed = _ids(nn, rng)
    return nn.eos_id(ids, eos_id=1), feed


def case_eos_trim(nn, rng):
    ids, feed = _ids(nn, rng)
    return nn.eos_trim(ids, eos_id=1), feed


def case_maxid(nn, rng):
    x, feed = _dense(nn, rng)
    return nn.maxid(nn.fc(x, 4, act="softmax")), feed


def case_crf_decoding(nn, rng):
    xs, feed = _seq(nn, rng)
    cost_lab = nn.data("lab", size=4, is_seq=True, dtype="int32")
    lengths = feed["xs"][1]
    feed["lab"] = (rng.randint(0, 4, (B, T)).astype(np.int32), lengths)
    emit = nn.fc(xs, 4, name="emit", bias_attr=False)
    nn.crf_cost(emit, cost_lab, name="crf", param_attr=nn.ParamAttr(name="crf_w"))
    return nn.crf_decoding(emit, share_with="crf_w"), feed


# ---- cases of the port's own -------------------------------------------------

def case_get_output(nn, rng):
    ids, feed = _ids(nn, rng)
    lstm = nn.lstmemory(nn.embedding(ids, 4, vocab_size=V), 4, name="l")
    # the first of the LSTM's aux outputs in sorted order, as the reference
    # sweep picks it
    return nn.get_output(lstm, "final_c"), feed


# ``nn.recurrent`` is the recurrent-group module in both packages (it
# shadows the layer of that name), so the Elman layer is reached through
# ``nn.layers``

def case_recurrent(nn, rng):
    xs, feed = _seq(nn, rng)
    return nn.pooling(nn.layers.recurrent(_pre_fc(nn, xs)),
                      pooling_type="sum"), feed


def case_recurrent_reverse_relu(nn, rng):
    xs, feed = _seq(nn, rng)
    return nn.pooling(nn.layers.recurrent(xs, act="relu", reverse=True),
                      pooling_type="sum"), feed


def case_bidirectional_rnn_gru(nn, rng):
    xs, feed = _seq(nn, rng)
    return nn.pooling(nn.bidirectional_rnn(xs, 4, cell="gru"),
                      pooling_type="sum"), feed


def case_fc_sequence_softmax(nn, rng):
    xs, feed = _seq(nn, rng)
    return nn.fc(xs, 1, act="sequence_softmax"), feed


def case_context_projection_ahead(nn, rng):
    xs, feed = _seq(nn, rng)
    return nn.pooling(nn.context_projection(_pre_fc(nn, xs), context_len=2,
                                            context_start=1),
                      pooling_type="sum"), feed


def case_mixed_context_begin_pad(nn, rng):
    xs, feed = _seq(nn, rng)
    proj = nn.context_projection_input(
        _pre_fc(nn, xs), context_len=3, context_start=-2,
        padding_attr=nn.ParamAttr(init="normal", initial_std=0.1))
    return nn.pooling(nn.mixed(input=[proj]), pooling_type="sum"), feed


def case_mixed_context_end_pad(nn, rng):
    xs, feed = _seq(nn, rng)
    proj = nn.context_projection_input(
        _pre_fc(nn, xs), context_len=4, context_start=0,
        padding_attr=nn.ParamAttr(init="normal", initial_std=0.1))
    return nn.pooling(nn.mixed(input=[proj]), pooling_type="sum"), feed


def case_mixed_conv_trans(nn, rng):
    img, feed = _img(nn, rng)
    return nn.mixed(input=[
        nn.conv_projection(img, filter_size=3, num_filters=IMG_C, stride=2,
                           padding=1, trans=True),
    ]), feed


def case_mixed_conv_grouped(nn, rng):
    img = nn.data("img", size=4, height=IMG_H, width=IMG_W)
    feed = {"img": rng.randn(B, IMG_H, IMG_W, 4).astype(np.float32)}
    return nn.mixed(input=[
        nn.conv_projection(img, filter_size=3, num_filters=4, stride=2,
                           padding=1, groups=2),
    ]), feed


def case_mixed_conv_operator_trans(nn, rng):
    img, fi = _img(nn, rng)
    fsz = 3 * 3 * IMG_C * IMG_C
    flt = nn.data("flt", size=fsz)
    feed = {**fi, "flt": rng.randn(B, fsz).astype(np.float32)}
    return nn.mixed(input=[
        nn.conv_operator(img=img, filter=_pre_fc(nn, flt, fsz, "pf"),
                         filter_size=3, num_filters=IMG_C, stride=2,
                         padding=1, trans=True),
    ]), feed


def case_crf_decoding_shared(nn, rng):
    xs, feed = _seq(nn, rng)
    emit = nn.fc(xs, 4, name="emit", bias_attr=False)
    lab = nn.data("lab", size=4, is_seq=True, dtype="int32")
    nn.crf_cost(emit, lab, name="crf")
    return nn.crf_decoding(emit, share_with="crf"), feed


def case_trans_image(nn, rng):
    img, feed = _img(nn, rng)
    c = nn.img_conv(img, filter_size=3, num_filters=2, padding="SAME",
                    act="tanh", name="prec")
    return nn.pad(nn.trans(c), pad_w=(1, 0)), feed


def case_trans_square(nn, rng):
    x, feed = _dense(nn, rng)
    return nn.trans(_pre_fc(nn, x, 9)), feed


def case_prelu_channel_shared(nn, rng):
    xs, feed = _seq(nn, rng)
    return nn.pooling(nn.prelu(_pre_fc(nn, xs), channel_shared=True),
                      pooling_type="sum"), feed


def case_data_norm_min_max(nn, rng):
    x, feed = _dense(nn, rng)
    return nn.data_norm(_pre_fc(nn, x), strategy="min-max"), feed


def case_data_norm_decimal_scaling(nn, rng):
    x, feed = _dense(nn, rng)
    return nn.data_norm(_pre_fc(nn, x), strategy="decimal-scaling"), feed


def case_spp_avg(nn, rng):
    img, feed = _img(nn, rng)
    return nn.spp(_pre_conv(nn, img), pyramid_height=3,
                  pool_type="avg"), feed


def case_sub_seq_clipped(nn, rng):
    # offsets past the row's end: positions clip to T - 1
    xs, feed = _seq(nn, rng)
    off = nn.data("off", size=1, dtype="int32")
    sz = nn.data("sz", size=1, dtype="int32")
    feed["off"] = np.array([[0], [2], [4]], np.int32)
    feed["sz"] = np.array([[5], [3], [2]], np.int32)
    return nn.pooling(nn.sub_seq(_pre_fc(nn, xs), off, sz),
                      pooling_type="sum"), feed


def case_seq_reshape_ragged(nn, rng):
    # lengths scaled by D / reshape through float32 and truncated
    xs = nn.data("xs", size=6, is_seq=True)
    feed = {"xs": (rng.randn(B, 4, 6).astype(np.float32),
                   np.array([4, 3, 1], np.int32))}
    return nn.pooling(nn.seq_reshape(_pre_fc(nn, xs, 6, "pre"), 4),
                      pooling_type="sum"), feed


def case_ctc_cost_norm_by_times(nn, rng):
    xs, feed = _seq(nn, rng, t=8)
    lab = nn.data("lab", size=4, is_seq=True, dtype="int32")
    feed["lab"] = (rng.randint(0, 4, (B, 3)).astype(np.int32),
                   np.array([3, 1, 0], np.int32))
    feed["xs"] = (feed["xs"][0], np.array([8, 5, 3], np.int32))
    return nn.ctc_cost(nn.fc(xs, 5, act="linear", name="emit"), lab,
                       norm_by_times=True), feed


def case_hsigmoid_cost_ragged_tree(nn, rng):
    # 30 classes: depth 5, 31 internal nodes, some leaves unused
    x, feed = _dense(nn, rng)
    lab, fl = _label_int(nn, rng, n=30)
    fl["lab"] = fl["lab"][:, None]
    return nn.hsigmoid_cost(_pre_fc(nn, x), lab, num_classes=30), \
        {**feed, **fl}


def case_selective_fc_ids(nn, rng):
    x, fx = _dense(nn, rng)
    sel = nn.data("sel", size=3, dtype="int32")
    fx["sel"] = rng.randint(0, 7, (B, 3)).astype(np.int32)
    return nn.selective_fc(x, sel, 7, act="tanh", select_mode="ids"), fx


def case_selective_fc_two_inputs(nn, rng):
    a, fa = _dense(nn, rng, "a", 5)
    b, fb = _dense(nn, rng, "b", 3)
    sel = nn.data("sel", size=4)
    feed = {**fa, **fb, "sel": (rng.rand(B, 4) > 0.5).astype(np.float32)}
    return nn.selective_fc([a, b], sel, 4, act="sigmoid"), feed


def case_mdlstmemory_relu(nn, rng):
    img, feed = _img(nn, rng)
    return nn.mdlstmemory(_pre_conv(nn, img), 2, act="relu",
                          bias_attr=False), feed


#: cases whose output has no useful gradient (argmax, sampled ids, EOS
#: flags, Viterbi tags, the prior boxes' constant)
FORWARD_ONLY = {"maxid", "sampling_id", "eos_id", "eos_trim", "priorbox",
                "crf_decoding", "crf_decoding_shared"}


def collect_cases():
    return {name[len("case_"):]: fn for name, fn in globals().items()
            if name.startswith("case_")}


CASES = collect_cases()
