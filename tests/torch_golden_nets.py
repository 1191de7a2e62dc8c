"""The 23 canonical nets of ``tests/golden_nets.py``, written once for
either package's layer DSL: each builder takes the package's ``nn`` and
``v2.networks`` modules and a ``device`` (the port's ``Topology`` runs on
``cuda`` unless told otherwise; the JAX package's takes none) and returns
(Topology, feed_fn) with the reference's feed (``_cls_feed``).
``tests/test_torch_golden_nets.py`` builds them with both packages.
Imports neither jax nor torch."""

import numpy as np


def _topology(nn, cost, device):
    if device is None:
        return nn.Topology(cost)
    return nn.Topology(cost, device=device)


def _cls_feed(names_shapes, n_cls=3, B=2):
    def feed(rng):
        out = {}
        for name, spec in names_shapes.items():
            kind = spec[0]
            if kind == "dense":
                out[name] = rng.rand(B, *spec[1]).astype(np.float32)
            elif kind == "ids_seq":
                T, V = spec[1]
                out[name] = (rng.randint(0, V, (B, T)).astype(np.int32),
                             np.array([T, max(T - 2, 1)], np.int32)[:B])
            elif kind == "seq":
                T, D = spec[1]
                out[name] = (rng.randn(B, T, D).astype(np.float32),
                             np.array([T, max(T - 2, 1)], np.int32)[:B])
            elif kind == "int":
                out[name] = rng.randint(0, spec[1], (B, 1)).astype(np.int32)
            elif kind == "label":
                out[name] = rng.randint(0, n_cls, (B, 1)).astype(np.int32)
            elif kind == "labels_seq":
                T, C = spec[1]
                out[name] = (rng.randint(0, C, (B, T)).astype(np.int32),
                             np.array([T, max(T - 2, 1)], np.int32)[:B])
        return out

    return feed


def fc_dropout_net(nn, networks, device=None):
    x = nn.data("x", size=12)
    h1 = nn.fc(x, 16, act="relu", name="h1")
    h1d = nn.dropout(h1, 0.3, name="h1_drop")
    h2 = nn.fc([x, h1d], 8, act="tanh", name="h2")
    out = nn.fc(h2, 3, act="softmax", name="out")
    lbl = nn.data("label", size=3, dtype="int32")
    cost = nn.classification_cost(input=out, label=lbl, name="cost")
    return _topology(nn, cost, device), _cls_feed({"x": ("dense", (12,)),
                                         "label": ("label",)})


def lstm_textclf_net(nn, networks, device=None):
    words = nn.data("words", size=0, is_seq=True, dtype="int32")
    emb = nn.embedding(words, 12, vocab_size=40, name="emb")
    lstm = nn.lstmemory(emb, 10, name="lstm")
    pooled = nn.pooling(lstm, pooling_type="max", name="pooled")
    out = nn.fc(pooled, 3, act="softmax", name="out")
    lbl = nn.data("label", size=3, dtype="int32")
    cost = nn.classification_cost(input=out, label=lbl, name="cost")
    return _topology(nn, cost, device), _cls_feed({"words": ("ids_seq", (6, 40)),
                                         "label": ("label",)})


def gru_crf_tagger_net(nn, networks, device=None):
    words = nn.data("words", size=0, is_seq=True, dtype="int32")
    emb = nn.embedding(words, 10, vocab_size=30, name="emb")
    gru = nn.grumemory(emb, 8, reverse=True, name="gru")
    feat = nn.fc(gru, 5, act="linear", name="feat")
    labels = nn.data("labels", size=5, is_seq=True, dtype="int32")
    cost = nn.crf_cost(feat, labels, name="cost")
    return _topology(nn, cost, device), _cls_feed({"words": ("ids_seq", (6, 30)),
                                         "labels": ("labels_seq", (6, 5))})


def bidi_lstm_net(nn, networks, device=None):
    words = nn.data("words", size=0, is_seq=True, dtype="int32")
    emb = nn.embedding(words, 8, vocab_size=25, name="emb")
    bi = networks.bidirectional_lstm(emb, 6, name="bi")
    last = nn.last_seq(bi, name="last")
    out = nn.fc(last, 2, act="softmax", name="out")
    lbl = nn.data("label", size=2, dtype="int32")
    cost = nn.classification_cost(input=out, label=lbl, name="cost")
    return _topology(nn, cost, device), _cls_feed({"words": ("ids_seq", (5, 25)),
                                         "label": ("label",)}, n_cls=2)


def text_conv_net(nn, networks, device=None):
    words = nn.data("words", size=0, is_seq=True, dtype="int32")
    emb = nn.embedding(words, 8, vocab_size=30, name="emb")
    conv = networks.sequence_conv_pool(emb, context_len=3, hidden_size=12,
                                       name="tconv")
    out = nn.fc(conv, 2, act="softmax", name="out")
    lbl = nn.data("label", size=2, dtype="int32")
    cost = nn.classification_cost(input=out, label=lbl, name="cost")
    return _topology(nn, cost, device), _cls_feed({"words": ("ids_seq", (7, 30)),
                                         "label": ("label",)}, n_cls=2)


def mixed_projections_net(nn, networks, device=None):
    a = nn.data("a", size=8)
    b = nn.data("b", size=6)
    ids = nn.data("ids", size=20, dtype="int32")
    m = nn.mixed(6, input=[
        nn.full_matrix_projection(a),
        nn.trans_full_matrix_projection(b, size=6),
        nn.identity_projection(a, offset=2, size=6),
        nn.table_projection(ids, size=6),
        nn.dotmul_projection(b),
        nn.scaling_projection(b),
    ], act="tanh", bias_attr=True, name="m")
    out = nn.fc(m, 2, act="softmax", name="out")
    lbl = nn.data("label", size=2, dtype="int32")
    cost = nn.classification_cost(input=out, label=lbl, name="cost")
    return _topology(nn, cost, device), _cls_feed({"a": ("dense", (8,)),
                                         "b": ("dense", (6,)),
                                         "ids": ("int", 20),
                                         "label": ("label",)}, n_cls=2)


def mixed_context_net(nn, networks, device=None):
    seq = nn.data("seq", size=5, is_seq=True)
    m = nn.mixed(15, input=[
        nn.context_projection_input(seq, context_len=3),
    ], name="ctx_m")
    fc = nn.fc(m, 4, act="tanh", name="fc")
    pooled = nn.pooling(fc, pooling_type="avg", name="pooled")
    tgt = nn.data("tgt", size=4)
    cost = nn.mse_cost(pooled, tgt, name="cost")
    return _topology(nn, cost, device), _cls_feed({"seq": ("seq", (6, 5)),
                                         "tgt": ("dense", (4,))})


def mixed_conv_net(nn, networks, device=None):
    img = nn.data("img", size=2, height=8, width=8)
    m = nn.mixed(input=[
        nn.conv_projection(img, filter_size=3, num_filters=4, padding=1),
    ], act="relu", name="conv_m")
    pool = nn.img_pool(m, pool_size=2, stride=2, name="pool")
    out = nn.fc(pool, 2, act="softmax", name="out")
    lbl = nn.data("label", size=2, dtype="int32")
    cost = nn.classification_cost(input=out, label=lbl, name="cost")
    return _topology(nn, cost, device), _cls_feed({"img": ("dense", (8, 8, 2)),
                                         "label": ("label",)}, n_cls=2)


def recommender_net(nn, networks, device=None):
    uid = nn.data("uid", size=30, dtype="int32")
    mid = nn.data("mid", size=40, dtype="int32")
    ue = nn.embedding(uid, 8, name="ue")
    me = nn.embedding(mid, 8, name="me")
    uf = nn.fc(ue, 10, act="tanh", name="uf")
    mf = nn.fc(me, 10, act="tanh", name="mf")
    sim = nn.cos_sim(uf, mf, scale=5.0, name="sim")
    score = nn.data("score", size=1)
    cost = nn.mse_cost(sim, score, name="cost")
    return _topology(nn, cost, device), _cls_feed({"uid": ("int", 30),
                                         "mid": ("int", 40),
                                         "score": ("dense", (1,))})


def ctc_net(nn, networks, device=None):
    feats = nn.data("feats", size=6, is_seq=True)
    lstm = nn.lstmemory(feats, 8, name="lstm")
    logits = nn.fc(lstm, 7, act="linear", name="logits")  # 6 labels + blank
    labels = nn.data("labels", size=6, is_seq=True, dtype="int32")
    cost = nn.ctc_cost(logits, labels, name="cost")
    return _topology(nn, cost, device), _cls_feed({
        "feats": ("seq", (8, 6)),
        "labels": ("labels_seq", (3, 5)),
    })


def nce_net(nn, networks, device=None):
    words = nn.data("words", size=0, is_seq=True, dtype="int32")
    emb = nn.embedding(words, 10, vocab_size=50, name="emb")
    hid = nn.pooling(emb, pooling_type="avg", name="hid")
    lbl = nn.data("label", size=50, dtype="int32")
    cost = nn.nce_cost(hid, lbl, num_classes=50, num_neg_samples=5,
                       name="cost")
    return _topology(nn, cost, device), _cls_feed({"words": ("ids_seq", (4, 50)),
                                         "label": ("label",)}, n_cls=50)


def hsigmoid_net(nn, networks, device=None):
    x = nn.data("x", size=12)
    hid = nn.fc(x, 10, act="tanh", name="hid")
    lbl = nn.data("label", size=30, dtype="int32")
    cost = nn.hsigmoid_cost(hid, lbl, num_classes=30, name="cost")
    return _topology(nn, cost, device), _cls_feed({"x": ("dense", (12,)),
                                         "label": ("label",)}, n_cls=30)


def image_misc_net(nn, networks, device=None):
    img = nn.data("img", size=3, height=12, width=12)
    conv = nn.img_conv(img, filter_size=3, num_filters=8, padding=1,
                       name="conv")
    norm = nn.img_cmrnorm(conv, size=5, name="norm")
    mo = nn.maxout(norm, groups=2, name="mo")
    pool = nn.img_pool(mo, pool_size=2, stride=2, name="pool")
    out = nn.fc(pool, 4, act="softmax", name="out")
    lbl = nn.data("label", size=4, dtype="int32")
    cost = nn.classification_cost(input=out, label=lbl, name="cost")
    return _topology(nn, cost, device), _cls_feed({"img": ("dense", (12, 12, 3)),
                                         "label": ("label",)}, n_cls=4)


def fused_inception_net(nn, networks, device=None):
    """Fused-reduce inception block: merged 1x1 conv + slice_channels —
    locks the new slice layer's serialization."""
    img = nn.data("img", size=8, height=8, width=8)
    red = nn.img_conv(img, filter_size=1, num_filters=8, padding=0,
                      name="red")
    b1 = nn.slice_channels(red, 0, 3, name="s1")
    b3 = nn.img_conv(nn.slice_channels(red, 3, 8, name="s3"),
                     filter_size=3, num_filters=6, padding=1, name="c3")
    cat = nn.concat([b1, b3], name="cat")
    out = nn.fc(cat, 4, act="softmax", name="out")
    lbl = nn.data("label", size=4, dtype="int32")
    cost = nn.classification_cost(input=out, label=lbl, name="cost")
    return _topology(nn, cost, device), _cls_feed({"img": ("dense", (8, 8, 8)),
                                         "label": ("label",)}, n_cls=4)


def resnet_block_net(nn, networks, device=None):
    img = nn.data("img", size=4, height=8, width=8)
    c1 = nn.img_conv(img, filter_size=3, num_filters=4, padding=1,
                     act="linear", name="c1")
    b1 = nn.batch_norm(c1, act="relu", name="b1")
    c2 = nn.img_conv(b1, filter_size=3, num_filters=4, padding=1,
                     act="linear", name="c2")
    b2 = nn.batch_norm(c2, act="linear", name="b2")
    res = nn.addto([b2, img], act="relu", name="res")
    out = nn.fc(res, 3, act="softmax", name="out")
    lbl = nn.data("label", size=3, dtype="int32")
    cost = nn.classification_cost(input=out, label=lbl, name="cost")
    return _topology(nn, cost, device), _cls_feed({"img": ("dense", (8, 8, 4)),
                                         "label": ("label",)})


def lstm_group_net(nn, networks, device=None):
    x = nn.data("x", size=5, is_seq=True)
    proj = nn.fc(x, 16, act="linear", bias_attr=False, name="proj")  # 4H
    grp = networks.lstmemory_group(proj, 4, name="lg")
    last = nn.last_seq(grp, name="last")
    tgt = nn.data("tgt", size=4)
    cost = nn.mse_cost(last, tgt, name="cost")
    return _topology(nn, cost, device), _cls_feed({"x": ("seq", (5, 5)),
                                         "tgt": ("dense", (4,))})


def gru_group_net(nn, networks, device=None):
    x = nn.data("x", size=4, is_seq=True)
    proj = nn.fc(x, 9, act="linear", bias_attr=False, name="proj")  # 3H
    grp = networks.gru_group(proj, 3, reverse=True, name="gg")
    first = nn.first_seq(grp, name="first")
    tgt = nn.data("tgt", size=3)
    cost = nn.mse_cost(first, tgt, name="cost")
    return _topology(nn, cost, device), _cls_feed({"x": ("seq", (5, 4)),
                                         "tgt": ("dense", (3,))})


def simple_gru2_net(nn, networks, device=None):
    x = nn.data("x", size=6, is_seq=True)
    g = networks.simple_gru2(x, 5, name="sg")
    pooled = nn.pooling(g, pooling_type="max", name="pooled")
    out = nn.fc(pooled, 2, act="softmax", name="out")
    lbl = nn.data("label", size=2, dtype="int32")
    cost = nn.classification_cost(input=out, label=lbl, name="cost")
    return _topology(nn, cost, device), _cls_feed({"x": ("seq", (5, 6)),
                                         "label": ("label",)}, n_cls=2)


def db_lstm_style_net(nn, networks, device=None):
    w = nn.data("w", size=0, is_seq=True, dtype="int32")
    c = nn.data("c", size=0, is_seq=True, dtype="int32")
    shared = nn.ParamAttr(name="emb")
    e1 = nn.embedding(w, 6, vocab_size=20, param_attr=shared, name="e1")
    e2 = nn.embedding(c, 6, vocab_size=20, param_attr=shared, name="e2")
    hidden = nn.mixed(16, input=[nn.full_matrix_projection(e1),
                                 nn.full_matrix_projection(e2)],
                      bias_attr=True, name="hidden")
    lstm = nn.lstmemory(hidden, projected_input=True, act="relu",
                        state_act="sigmoid", name="lstm")
    feat = nn.mixed(5, input=[nn.full_matrix_projection(hidden),
                              nn.full_matrix_projection(lstm)],
                    bias_attr=True, name="feat")
    labels = nn.data("labels", size=5, is_seq=True, dtype="int32")
    cost = nn.crf_cost(feat, labels, name="cost")
    return _topology(nn, cost, device), _cls_feed({"w": ("ids_seq", (6, 20)),
                                         "c": ("ids_seq", (6, 20)),
                                         "labels": ("labels_seq", (6, 5))})


def seq_ops_net(nn, networks, device=None):
    x = nn.data("x", size=4, is_seq=True)
    y = nn.data("y", size=4, is_seq=True)
    rev = nn.seq_reverse(x, name="rev")
    cat = nn.seq_concat(rev, y, name="cat")
    first = nn.first_seq(cat, name="first")
    expanded = nn.expand(first, cat, name="expanded")
    pooled = nn.pooling(expanded, pooling_type="sum", name="pooled")
    tgt = nn.data("tgt", size=4)
    cost = nn.mse_cost(pooled, tgt, name="cost")
    return _topology(nn, cost, device), _cls_feed({"x": ("seq", (4, 4)),
                                         "y": ("seq", (4, 4)),
                                         "tgt": ("dense", (4,))})


def selective_fc_net(nn, networks, device=None):
    x = nn.data("x", size=8)
    sel = nn.data("sel", size=20)  # dense 0/1 selection (mask mode)
    out = nn.selective_fc(x, sel, size=20, act="linear", name="sfc")
    tgt = nn.data("label", size=20, dtype="int32")
    cost = nn.classification_cost(input=out, label=tgt, name="cost")

    def feed(rng):
        return {
            "x": rng.rand(2, 8).astype(np.float32),
            "sel": (rng.rand(2, 20) > 0.5).astype(np.float32),
            "label": rng.randint(0, 20, (2, 1)).astype(np.int32),
        }

    return _topology(nn, cost, device), feed


def vgg_block_net(nn, networks, device=None):
    img = nn.data("img", size=3, height=8, width=8)
    blk = networks.img_conv_group(img, [4, 4], conv_batchnorm=True,
                                  conv_batchnorm_drop_rate=[0.3, 0],
                                  pool_size=2, pool_stride=2, name="blk")
    out = nn.fc(blk, 3, act="softmax", name="out")
    lbl = nn.data("label", size=3, dtype="int32")
    cost = nn.classification_cost(input=out, label=lbl, name="cost")
    return _topology(nn, cost, device), _cls_feed({"img": ("dense", (8, 8, 3)),
                                         "label": ("label",)})


def rank_cost_net(nn, networks, device=None):
    a = nn.data("a", size=6)
    b = nn.data("b", size=6)
    sa = nn.fc(a, 1, act="linear", name="sa")
    sb = nn.fc(b, 1, act="linear", name="sb")
    lbl = nn.data("label", size=1)
    cost = nn.rank_cost(sa, sb, lbl, name="cost")

    def feed(rng):
        return {"a": rng.rand(2, 6).astype(np.float32),
                "b": rng.rand(2, 6).astype(np.float32),
                "label": rng.randint(0, 2, (2, 1)).astype(np.float32)}

    return _topology(nn, cost, device), feed


#: name -> builder; the golden file is tests/golden/<name>.protostr
GOLDEN_NETS = {
    "fc_dropout": fc_dropout_net,
    "lstm_textclf": lstm_textclf_net,
    "gru_crf_tagger": gru_crf_tagger_net,
    "bidi_lstm": bidi_lstm_net,
    "text_conv": text_conv_net,
    "mixed_projections": mixed_projections_net,
    "mixed_context": mixed_context_net,
    "mixed_conv": mixed_conv_net,
    "recommender": recommender_net,
    "ctc": ctc_net,
    "nce": nce_net,
    "hsigmoid": hsigmoid_net,
    "image_misc": image_misc_net,
    "fused_inception": fused_inception_net,
    "resnet_block": resnet_block_net,
    "lstm_group": lstm_group_net,
    "gru_group": gru_group_net,
    "simple_gru2": simple_gru2_net,
    "db_lstm_style": db_lstm_style_net,
    "seq_ops": seq_ops_net,
    "selective_fc": selective_fc_net,
    "vgg_block": vgg_block_net,
    "rank_cost": rank_cost_net,
}
