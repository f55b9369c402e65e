# ported from paddle_tpu/models/recommender.py
"""Recommender system: the book's two-tower movielens model (reference:
python/paddle/fluid/tests/book/test_recommender_system.py): user features
(id/gender/age/job) and movie features (id/categories/title) embed into two
200-d towers; scaled cosine similarity regresses the 1-5 rating with
square_error_cost.
"""

from __future__ import annotations

from .. import layers

__all__ = ["usr_combined_features", "mov_combined_features", "inference_program"]


def usr_combined_features(uid, gender_id, age_id, job_id, usr_dict_size=100,
                          gender_dict_size=2, age_dict_size=7,
                          job_dict_size=21, is_sparse=False):
    usr_emb = layers.embedding(uid, size=[usr_dict_size, 32], dtype="float32",
                               param_attr=layers.ParamAttr(name="user_table"),
                               is_sparse=is_sparse)
    usr_fc = layers.fc(layers.reshape(usr_emb, [0, 32]), size=32)
    g_emb = layers.embedding(gender_id, size=[gender_dict_size, 16],
                             dtype="float32",
                             param_attr=layers.ParamAttr(name="gender_table"),
                             is_sparse=is_sparse)
    g_fc = layers.fc(layers.reshape(g_emb, [0, 16]), size=16)
    a_emb = layers.embedding(age_id, size=[age_dict_size, 16], dtype="float32",
                             param_attr=layers.ParamAttr(name="age_table"),
                             is_sparse=is_sparse)
    a_fc = layers.fc(layers.reshape(a_emb, [0, 16]), size=16)
    j_emb = layers.embedding(job_id, size=[job_dict_size, 16], dtype="float32",
                             param_attr=layers.ParamAttr(name="job_table"),
                             is_sparse=is_sparse)
    j_fc = layers.fc(layers.reshape(j_emb, [0, 16]), size=16)
    concat = layers.concat([usr_fc, g_fc, a_fc, j_fc], axis=1)
    return layers.fc(concat, size=200, act="tanh")


def mov_combined_features(mov_id, category_ids, title_ids, mov_dict_size=200,
                          category_dict_size=18, title_dict_size=500,
                          is_sparse=False):
    """category_ids/title_ids: [batch, T] int64 padded multi-hot sequences
    (the padded+Length replacement for the reference's LoD inputs)."""
    mov_emb = layers.embedding(mov_id, size=[mov_dict_size, 32],
                               dtype="float32",
                               param_attr=layers.ParamAttr(name="movie_table"),
                               is_sparse=is_sparse)
    mov_fc = layers.fc(layers.reshape(mov_emb, [0, 32]), size=32)
    cat_emb = layers.embedding(category_ids, size=[category_dict_size, 32],
                               dtype="float32", is_sparse=is_sparse)
    cat_hidden = layers.sequence_pool(cat_emb, pool_type="sum")
    title_emb = layers.embedding(title_ids, size=[title_dict_size, 32],
                                 dtype="float32", is_sparse=is_sparse)
    title_hidden = layers.sequence_pool(title_emb, pool_type="sum")
    concat = layers.concat([mov_fc, cat_hidden, title_hidden], axis=1)
    return layers.fc(concat, size=200, act="tanh")


def inference_program(usr_features, mov_features, rating):
    """Scaled cosine similarity → square error vs the [batch,1] rating."""
    sim = layers.cos_sim(usr_features, mov_features)
    scale_infer = layers.scale(sim, scale=5.0)
    cost = layers.square_error_cost(scale_infer, rating)
    return scale_infer, layers.mean(cost)
