# ported from paddle_tpu/models/machine_translation.py
"""Attention seq2seq machine translation (reference:
benchmark/fluid/models/machine_translation.py + the book's
test_machine_translation.py): GRU encoder + dot-product-attention
DynamicRNN decoder over padded+Length batches."""

from __future__ import annotations

from .. import layers


def seq_to_seq_net(src, src_len, trg, trg_len, labels, dict_size: int,
                   embedding_dim: int = 512, encoder_size: int = 512,
                   decoder_size: int = 512):
    """src/trg [B, T] int64 with lengths, labels [B, Tt, 1] →
    (masked avg loss, decoder logits [B, Tt, V])."""
    src_emb = layers.embedding(src, size=[dict_size, embedding_dim])
    enc_proj = layers.fc(src_emb, size=3 * encoder_size, num_flatten_dims=2)
    enc_out = layers.dynamic_gru(enc_proj, size=encoder_size, length=src_len)

    ts = int(src.shape[1])
    # padded encoder rows are zero vectors (masked scan), but zero scores
    # would still win softmax mass — mask them to -1e9 before normalizing
    src_mask = layers.sequence.sequence_mask(src_len, maxlen=ts, dtype="float32")
    neg_bias = layers.scale(src_mask, scale=1e9, bias=-1e9)  # 0 valid, -1e9 pad

    trg_emb = layers.embedding(trg, size=[dict_size, embedding_dim])
    drnn = layers.DynamicRNN()
    with drnn.block():
        y_t = drnn.step_input(trg_emb, length=trg_len)
        enc = drnn.static_input(enc_out)
        att_bias = drnn.static_input(neg_bias)
        prev = drnn.memory(shape=[decoder_size], value=0.0)
        query = layers.fc(prev, size=encoder_size, bias_attr=False)
        scores = layers.matmul(enc, layers.unsqueeze(query, axes=[2]))
        att = layers.softmax(layers.elementwise_add(
            layers.squeeze(scores, axes=[2]), att_bias))
        ctx_vec = layers.squeeze(
            layers.matmul(layers.unsqueeze(att, axes=[1]), enc), axes=[1])
        gates = layers.fc([y_t, ctx_vec], size=3 * decoder_size)
        h_t, _, _ = layers.gru_unit(gates, prev, size=3 * decoder_size)
        drnn.update_memory(prev, h_t)
        drnn.output(h_t)
    dec_out = drnn()
    logits = layers.fc(dec_out, size=dict_size, num_flatten_dims=2)
    ce = layers.softmax_with_cross_entropy(logits, labels)
    tt = int(trg.shape[1])
    mask = layers.unsqueeze(
        layers.sequence.sequence_mask(trg_len, maxlen=tt, dtype="float32"),
        axes=[2])
    loss = layers.elementwise_div(
        layers.reduce_sum(layers.elementwise_mul(ce, mask)),
        layers.reduce_sum(mask))
    return loss, logits
