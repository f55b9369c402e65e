# ported from paddle_tpu/models/stacked_lstm.py
"""Stacked dynamic LSTM sentiment model (reference: the book's
stacked_lstm_net, python/paddle/fluid/tests/book/test_understand_sentiment.py
— embedding → N stacked fc+dynamic_lstm layers with alternating direction →
max pools → fc softmax. The similarly-named
benchmark/fluid/models/stacked_dynamic_lstm.py is, despite its name, a
single hand-rolled DynamicRNN LSTM with 'last' pooling — covered by the
DynamicRNN tests)."""

from __future__ import annotations

from .. import layers
from ..layers import rnn as rnn_layers
from ..layers import sequence as seq_layers
from ..layers import tensor as tensor_layers


def stacked_lstm_net(words, length, label, dict_dim: int, emb_dim: int = 512,
                     hid_dim: int = 512, stacked_num: int = 3,
                     class_num: int = 2):
    """words [B, T] int64 + length [B], label [B, 1] → (avg_loss, acc).

    Padded+Length replaces the reference's LoD input; the lstm stack
    alternates direction per layer like the reference."""
    if hid_dim % 4 != 0:
        raise ValueError("hid_dim is the Fluid 4H projection size and must be "
                         "divisible by 4, got %d" % hid_dim)
    emb = layers.embedding(words, size=[dict_dim, emb_dim])
    # Fluid contract: dynamic_lstm's ``size`` is 4·hidden and its input is
    # the 4H x-projection (same convention as the reference benchmark model)
    fc1 = layers.fc(emb, size=hid_dim, num_flatten_dims=2)
    lstm1, _ = rnn_layers.dynamic_lstm(fc1, size=hid_dim, length=length)

    inputs = [fc1, lstm1]
    for i in range(2, stacked_num + 1):
        fc = layers.fc(tensor_layers.concat(inputs, axis=2), size=hid_dim,
                       num_flatten_dims=2)
        lstm, _ = rnn_layers.dynamic_lstm(fc, size=hid_dim, length=length,
                                          is_reverse=(i % 2) == 0)
        inputs = [fc, lstm]

    fc_last = seq_layers.sequence_pool(inputs[0], "max", length=length)
    lstm_last = seq_layers.sequence_pool(inputs[1], "max", length=length)
    pred = layers.fc(tensor_layers.concat([fc_last, lstm_last], axis=1),
                     size=class_num, act="softmax")
    loss = layers.mean(layers.cross_entropy(pred, label))
    acc = layers.accuracy(pred, label)
    return loss, acc
