# ported from paddle_tpu/models/word2vec.py
"""word2vec N-gram language model (reference:
python/paddle/fluid/tests/book/test_word2vec.py __network__): four context
words share one embedding table ('shared_w'), concat → sigmoid fc → softmax
fc → cross_entropy against the next word.
"""

from __future__ import annotations

from .. import layers

__all__ = ["word2vec_ngram"]


def word2vec_ngram(first, second, third, forth, next_word, dict_size,
                   embed_size=32, hidden_size=256, is_sparse=False):
    """Each word input: [batch, 1] int64. Returns (avg_cost, predict_word)."""
    embeds = []
    for w in (first, second, third, forth):
        embeds.append(layers.embedding(
            w, size=[dict_size, embed_size], dtype="float32",
            is_sparse=is_sparse,
            param_attr=layers.ParamAttr(name="shared_w")))
    concat = layers.concat([layers.reshape(e, [0, embed_size]) for e in embeds],
                           axis=1)
    hidden = layers.fc(concat, size=hidden_size, act="sigmoid")
    predict_word = layers.fc(hidden, size=dict_size, act="softmax")
    cost = layers.cross_entropy(predict_word, next_word)
    return layers.mean(cost), predict_word
