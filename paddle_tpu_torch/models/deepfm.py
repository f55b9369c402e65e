# ported from paddle_tpu/models/deepfm.py
"""DeepFM CTR model (reference workload: tests/unittests/dist_ctr.py +
dist_fleet_ctr-style DeepFM; sparse path via lookup_table/SelectedRows).

Sparse features are dense int id tensors here (one slot per column); the
embedding grads are XLA scatter-adds instead of SelectedRows rows, and the
distributed story is a sharded embedding table over the mesh
(paddle_tpu/parallel) instead of a parameter server.

In the port, ``is_sparse=True`` trains the tables through rows-only
gradients and the row kernels K4a/K4b (ops/kernels/sparse_adam.py);
``sharding_axis`` waits for the port of ``parallel/``.
"""

from __future__ import annotations

from .. import initializer as init_mod
from .. import layers
from ..layers import tensor as tl


def deepfm(
    sparse_ids,
    dense_feat,
    label,
    sparse_feature_dim=int(1e5),
    embedding_size=10,
    num_fields=26,
    layer_sizes=(400, 400, 400),
    is_test=False,
    is_sparse=True,
    sharding_axis=None,
):
    """sparse_ids: [batch, num_fields] int64 (global hashed ids);
    dense_feat: [batch, dense_dim] float32; label: [batch, 1] int64.
    Returns (predict_probs, avg_loss, auc_var).

    ``sharding_axis`` raises ``NotImplementedError`` in the port. In the
    JAX package, ``sharding_axis`` (e.g. ``"model"``) row-shards both embedding tables
    (and their Adam moments) over that mesh axis via
    ``parallel.sharded_embedding`` — the V=1e8 capacity path: ~V/n rows per
    device, table initialized shard-by-shard, optimizer updates shard-local
    rows-only. Run the program through ``CompiledProgram.with_mesh`` with a
    mesh carrying the axis.
    """
    init = layers.ParamAttr(
        name="sparse_emb",
        initializer=init_mod.TruncatedNormal(0.0, 1.0 / (embedding_size ** 0.5)),
    )
    w1_attr = layers.ParamAttr(
        name="sparse_w1",
        initializer=init_mod.TruncatedNormal(0.0, 1e-4))
    # [b, f, e] factor embeddings + [b, f, 1] first-order weights
    # is_sparse=True: SelectedRows-equivalent rows-only gradients + lazy
    # optimizer updates (reference dist_ctr.py uses is_sparse=True too) —
    # the step cost must stay independent of sparse_feature_dim
    if sharding_axis:
        raise NotImplementedError(
            "deepfm(sharding_axis=...) needs parallel.sharded_embedding, "
            "which paddle_tpu_torch does not port yet")
    emb = layers.embedding(sparse_ids,
                           size=[sparse_feature_dim, embedding_size],
                           param_attr=init, is_sparse=is_sparse)
    w1 = layers.embedding(sparse_ids, size=[sparse_feature_dim, 1],
                          param_attr=w1_attr, is_sparse=is_sparse)

    # FM first order
    first_order = layers.reduce_sum(w1, dim=1)  # [b, 1]

    # FM second order: 0.5 * ((sum e)^2 - sum e^2)
    sum_emb = layers.reduce_sum(emb, dim=1)  # [b, e]
    sum_sq = layers.square(sum_emb)
    sq_emb = layers.square(emb)
    sq_sum = layers.reduce_sum(sq_emb, dim=1)
    second_order = tl.scale(
        layers.reduce_sum(layers.elementwise_sub(sum_sq, sq_sum), dim=1, keep_dim=True),
        scale=0.5,
    )  # [b, 1]

    # Deep part
    deep = layers.reshape(emb, [-1, num_fields * embedding_size])
    if dense_feat is not None:
        deep = tl.concat([deep, dense_feat], axis=1)
    for i, size in enumerate(layer_sizes):
        deep = layers.fc(deep, size=size, act="relu",
                         param_attr=layers.ParamAttr(
                             initializer=init_mod.Normal(0.0, 1.0 / (size ** 0.5))),
                         name="deep_fc_%d" % i)
    deep_out = layers.fc(deep, size=1, name="deep_out")

    logit = layers.elementwise_add(
        layers.elementwise_add(first_order, second_order), deep_out)
    # two-class softmax head (reference ctr models fetch class probs for AUC)
    two_logits = tl.concat([tl.zeros_like(logit), logit], axis=1)
    predict = layers.softmax(two_logits)
    loss = layers.mean(layers.softmax_with_cross_entropy(two_logits, label))
    auc_var, _ = layers.auc(predict, label)
    return predict, loss, auc_var
