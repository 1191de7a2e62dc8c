"""Nets of the repo's demos over sparse inputs and sampled costs, written
once for either package's layer DSL (each builder takes the package's
``nn``); the demos stay as they are.  ``tests/test_torch_sparse.py``,
``tests/test_torch_recommender.py``, ``tests/test_torch_cuda.py`` and
``chip_smoke.py`` build them.  Imports neither jax nor torch."""


def sparse_lr_net(nn, vocab):
    """``demo/quick_start/train.py:30-38``: logistic regression straight
    over a sparse-binary bag of words, its weight a ``sparse_grad`` table
    ``lr_w``.  -> (cost, the softmax output)."""
    words = nn.data("words", size=vocab, sparse="binary")
    out = nn.fc(words, 2, act="softmax", name="out",
                param_attr=nn.ParamAttr(name="lr_w", sparse_grad=True))
    lbl = nn.data("label", size=2, dtype="int32")
    return nn.classification_cost(input=out, label=lbl), out


def ngram_net(nn, vocab, emb_dim, hid_dim, ngram, output):
    """``demo/word2vec/train.py:16-30``: the n-gram LM, ``ngram - 1``
    context words ``w{i}`` through one shared embedding ``word_emb``,
    concatenated, a tanh ``hidden`` fc, then ``hsigmoid_cost`` over the
    vocabulary (``output="hsigmoid"``), ``nce_cost`` with 10 noise
    classes a row (``"nce"``) or a softmax fc and classification cost
    (``"softmax"``); the label is ``next_word``.  -> the cost."""
    ctx_layers = []
    emb_attr = nn.ParamAttr(name="word_emb")
    for i in range(ngram - 1):
        w = nn.data(f"w{i}", size=vocab, dtype="int32")
        ctx_layers.append(nn.embedding(w, emb_dim, param_attr=emb_attr))
    merged = nn.concat(ctx_layers, name="context")
    h = nn.fc(merged, hid_dim, act="tanh", name="hidden")
    nxt = nn.data("next_word", size=vocab, dtype="int32")
    if output == "hsigmoid":
        return nn.hsigmoid_cost(h, nxt, num_classes=vocab, name="cost")
    if output == "nce":
        return nn.nce_cost(h, nxt, num_classes=vocab, num_neg_samples=10,
                           name="cost")
    out = nn.fc(h, vocab, act="softmax", name="out")
    return nn.classification_cost(input=out, label=nxt, name="cost")


def ngram_feeder_types(ngram):
    """The word2vec demo's ``DataFeeder`` slot kinds."""
    spec = {f"w{i}": "int" for i in range(ngram - 1)}
    spec["next_word"] = "int"
    return spec


#: the recommendation demo's slot kinds for ``movielens_feature_net``
#: (demo/recommendation/train.py)
MOVIELENS_FEATURE_TYPES = {
    "user_id": "int", "gender_id": "int", "age_id": "int", "job_id": "int",
    "movie_id": "int", "category_id": "sparse_ids",
    "movie_title": "ids_seq", "score": "dense"}


def ctc_net(nn, in_dim, hidden, classes):
    """The golden ``ctc`` net's structure (``tests/torch_golden_nets.py``):
    frames -> ``lstmemory`` -> a linear fc to ``classes`` outputs (the last
    one the blank) -> ``ctc_cost``.  -> (cost, the logits layer)."""
    feats = nn.data("feats", size=in_dim, is_seq=True)
    lstm = nn.lstmemory(feats, hidden, name="lstm")
    logits = nn.fc(lstm, classes, act="linear", name="logits")
    labels = nn.data("labels", size=classes - 1, is_seq=True, dtype="int32")
    return nn.ctc_cost(logits, labels, name="cost"), logits
