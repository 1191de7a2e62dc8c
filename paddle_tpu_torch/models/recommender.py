"""The MovieLens recommender — counterpart of
``paddle_tpu/models/recommender.py`` (the reference's demo/recommendation).

``movielens_feature_net`` is the reference's full feature network: a user
tower (id, gender, age and job embeddings fused by an fc) and a movie tower
(id embedding, an fc over the sparse-binary categories, a conv-pool over
the title's words), the rating regressed from ``cos_sim(user, movie) * 5``.
``movielens_net`` is the minimal two-tower net; with ``sparse_grad=True``
its id tables take the row-sparse update (``SGDTrainer``'s
``sparse_rows``).
"""

from __future__ import annotations

import paddle_tpu_torch.nn as nn
import paddle_tpu_torch.v2.networks as networks
from paddle_tpu_torch.data.datasets import ML_SCHEMA

__all__ = ["movielens_net", "movielens_feature_net", "ML_SCHEMA"]


def movielens_net(n_users: int = ML_SCHEMA["n_users"],
                  n_movies: int = ML_SCHEMA["n_movies"], *,
                  emb_dim: int = 64, hid_dim: int = 64,
                  sparse_grad: bool = False):
    """Two embedding towers -> fc -> a linear rating, mse cost.  Feeds
    ``user_id``/``movie_id`` int [B, 1], ``score`` [B, 1].  -> (cost,
    prediction)."""
    uid = nn.data("user_id", size=n_users, dtype="int32")
    mid = nn.data("movie_id", size=n_movies, dtype="int32")
    rating = nn.data("score", size=1)
    u_emb = nn.embedding(uid, emb_dim, name="user_emb",
                         sparse_grad=sparse_grad)
    m_emb = nn.embedding(mid, emb_dim, name="movie_emb",
                         sparse_grad=sparse_grad)
    u_fc = nn.fc(u_emb, hid_dim, act="relu", name="user_fc")
    m_fc = nn.fc(m_emb, hid_dim, act="relu", name="movie_fc")
    both = nn.concat([u_fc, m_fc], name="towers")
    h = nn.fc(both, hid_dim, act="relu", name="merge_fc")
    pred = nn.fc(h, 1, act="linear", name="prediction")
    cost = nn.mse_cost(pred, rating, name="cost")
    return cost, pred


def movielens_feature_net(*, n_users=ML_SCHEMA["n_users"],
                          n_movies=ML_SCHEMA["n_movies"],
                          n_genders=ML_SCHEMA["n_genders"],
                          n_ages=ML_SCHEMA["n_ages"],
                          n_jobs=ML_SCHEMA["n_jobs"],
                          n_categories=ML_SCHEMA["n_categories"],
                          title_dict=ML_SCHEMA["title_dict"],
                          emb_dim=32, fusion_dim=200):
    """The reference MovieLens network.  Feeds: ``user_id``,
    ``gender_id``, ``age_id``, ``job_id``, ``movie_id`` int [B, 1];
    ``category_id`` sparse binary (ids [B, N], nnz [B]); ``movie_title``
    an id sequence (ids [B, T], lengths [B]); ``score`` [B, 1].  -> (cost,
    inference)."""
    uid = nn.data("user_id", size=n_users, dtype="int32")
    usr_emb = nn.embedding(uid, emb_dim, name="usr_emb")
    gender = nn.data("gender_id", size=n_genders, dtype="int32")
    gender_emb = nn.embedding(gender, emb_dim // 2, name="usr_gender_emb")
    age = nn.data("age_id", size=n_ages, dtype="int32")
    age_emb = nn.embedding(age, emb_dim // 2, name="usr_age_emb")
    job = nn.data("job_id", size=n_jobs, dtype="int32")
    job_emb = nn.embedding(job, emb_dim // 2, name="usr_job_emb")
    usr_feat = nn.fc([usr_emb, gender_emb, age_emb, job_emb], fusion_dim,
                     act="tanh", name="usr_fusion")

    mid = nn.data("movie_id", size=n_movies, dtype="int32")
    mov_emb = nn.embedding(mid, emb_dim, name="mov_emb")
    categories = nn.data("category_id", size=n_categories, sparse="binary")
    cat_hidden = nn.fc(categories, emb_dim, act="relu", name="mov_cat_fc")
    title = nn.data("movie_title", size=title_dict, dtype="int32",
                    is_seq=True)
    title_emb = nn.embedding(title, emb_dim, name="mov_title_emb")
    title_conv = networks.sequence_conv_pool(title_emb, context_len=3,
                                             hidden_size=emb_dim,
                                             name="mov_title_conv")
    mov_feat = nn.fc([mov_emb, cat_hidden, title_conv], fusion_dim,
                     act="tanh", name="mov_fusion")

    inference = nn.cos_sim(usr_feat, mov_feat, scale=5.0, name="inference")
    score = nn.data("score", size=1)
    cost = nn.mse_cost(inference, score, name="cost")
    return cost, inference
