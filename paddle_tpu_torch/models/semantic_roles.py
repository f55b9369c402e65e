# ported from paddle_tpu/models/semantic_roles.py
"""Label semantic roles: the book's deep bidirectional LSTM + linear-chain
CRF tagger (reference: python/paddle/fluid/tests/book/
test_label_semantic_roles.py db_lstm + crf head).

8 feature streams (word, 5 context windows, predicate, region mark) embed,
sum through fcs into a stacked alternating-direction LSTM chain; the CRF
trains on the summed emission and ``crf_decoding`` reuses the same 'crfw'
transition parameter at inference.
"""

from __future__ import annotations

from .. import layers

__all__ = ["db_lstm", "srl_train_net", "srl_decode"]


def db_lstm(word, predicate, ctx_n2, ctx_n1, ctx_0, ctx_p1, ctx_p2, mark,
            length=None, word_dict_len=100, pred_dict_len=50, mark_dict_len=2,
            label_dict_len=10, word_dim=16, mark_dim=5, hidden_dim=32,
            depth=4):
    """Inputs: [batch, T] int64 token streams. Returns emission [B, T, L]."""
    pred_emb = layers.embedding(
        predicate, size=[pred_dict_len, word_dim], dtype="float32",
        param_attr=layers.ParamAttr(name="vemb"))
    mark_emb = layers.embedding(mark, size=[mark_dict_len, mark_dim],
                                dtype="float32")
    word_input = [word, ctx_n2, ctx_n1, ctx_0, ctx_p1, ctx_p2]
    emb_layers = [
        layers.embedding(x, size=[word_dict_len, word_dim], dtype="float32",
                         param_attr=layers.ParamAttr(name="word_emb",
                                                     trainable=True))
        for x in word_input
    ]
    emb_layers += [pred_emb, mark_emb]

    hidden_0 = layers.sums([
        layers.fc(emb, size=hidden_dim * 4, num_flatten_dims=2)
        for emb in emb_layers
    ])
    lstm_0, _ = layers.dynamic_lstm(
        hidden_0, size=hidden_dim * 4, length=length,
        candidate_activation="relu", gate_activation="sigmoid",
        cell_activation="sigmoid")

    input_tmp = [hidden_0, lstm_0]
    for i in range(1, depth):
        mix_hidden = layers.sums([
            layers.fc(input_tmp[0], size=hidden_dim * 4, num_flatten_dims=2),
            layers.fc(input_tmp[1], size=hidden_dim * 4, num_flatten_dims=2),
        ])
        lstm, _ = layers.dynamic_lstm(
            mix_hidden, size=hidden_dim * 4, length=length,
            candidate_activation="relu", gate_activation="sigmoid",
            cell_activation="sigmoid", is_reverse=(i % 2) == 1)
        input_tmp = [mix_hidden, lstm]

    feature_out = layers.sums([
        layers.fc(input_tmp[0], size=label_dict_len, num_flatten_dims=2, act="tanh"),
        layers.fc(input_tmp[1], size=label_dict_len, num_flatten_dims=2, act="tanh"),
    ])
    return feature_out


def srl_train_net(feature_out, target, length=None):
    """CRF training head: returns avg negative log-likelihood cost."""
    crf_cost = layers.linear_chain_crf(
        feature_out, target,
        param_attr=layers.ParamAttr(name="crfw"), length=length)
    return layers.mean(crf_cost)


def srl_decode(feature_out, length=None):
    """Viterbi decode with the trained 'crfw' transitions (inference)."""
    return layers.crf_decoding(
        feature_out, param_attr=layers.ParamAttr(name="crfw"), length=length)
