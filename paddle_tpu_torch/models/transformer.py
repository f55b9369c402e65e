# ported from paddle_tpu/models/transformer.py
"""Transformer encoder-decoder + BERT encoder (reference workloads:
Transformer-base WMT en-de in tests/unittests/dist_transformer.py;
BERT-base in inference/tests/api/analyzer_bert_tester.cc).

Pre-norm residual blocks over the fused attention layer; positional info via
learned embeddings (BERT) / sinusoid table (translation model). All shapes
static; padding is expressed through additive attention bias computed from
the input mask — the segment-ids/packing path replaces Fluid LoD.
"""

from __future__ import annotations

import numpy as np

from .. import initializer as init_mod
from .. import layers
from ..layers import attention as attn_layers
from ..layers import tensor as tl


def _ffn(x, d_inner, d_model, dropout_rate, is_test, name=None, act="relu"):
    h = layers.fc(x, size=d_inner, num_flatten_dims=2, act=act, name=name and name + "_fc1")
    if dropout_rate:
        h = layers.dropout(h, dropout_rate, is_test=is_test,
                           dropout_implementation="upscale_in_train")
    return layers.fc(h, size=d_model, num_flatten_dims=2, name=name and name + "_fc2")


def _pre_norm(x):
    return layers.layer_norm(x, begin_norm_axis=2)


def _residual(x, y, dropout_rate, is_test):
    if dropout_rate:
        y = layers.dropout(y, dropout_rate, is_test=is_test,
                           dropout_implementation="upscale_in_train")
    return layers.elementwise_add(x, y)


def encoder_layer(x, attn_bias, n_head, d_key, d_value, d_model, d_inner,
                  dropout_rate=0.1, is_test=False, name=None, seg_ids=None,
                  ffn_act="relu", inner_dropout=None, post_norm=False,
                  attn_dropout=None, causal=False):
    """One encoder block.

    ``post_norm=False`` is the pre-norm arrangement of the translation
    Transformer (dist_transformer.py); ``post_norm=True`` is the original
    BERT arrangement (LN after each residual add). ``inner_dropout`` is the
    relu_dropout INSIDE the FFN — present in the translation model, absent
    in BERT (whose FFN is gelu with dropout only on sublayer outputs).
    Defaults preserve the translation model; BERT passes gelu/0/True.
    """
    if inner_dropout is None:
        inner_dropout = dropout_rate
    if attn_dropout is None:
        # dropout on the attention probabilities; pass 0 to follow the
        # modern long-context recipes that drop attention-probs dropout
        # entirely.
        attn_dropout = dropout_rate
    att = attn_layers.multi_head_attention(
        x if post_norm else _pre_norm(x), None, None, attn_bias, d_key,
        d_value, d_model, n_head,
        dropout_rate=attn_dropout, causal=causal, is_test=is_test, name=name,
        segment_ids_q=seg_ids, segment_ids_kv=seg_ids)
    x = _residual(x, att, dropout_rate, is_test)
    if post_norm:
        x = _pre_norm(x)
    ff = _ffn(x if post_norm else _pre_norm(x), d_inner, d_model,
              inner_dropout, is_test, name=name, act=ffn_act)
    x = _residual(x, ff, dropout_rate, is_test)
    if post_norm:
        x = _pre_norm(x)
    return x


def decoder_layer(x, enc_out, self_bias, cross_bias, n_head, d_key, d_value,
                  d_model, d_inner, dropout_rate=0.1, is_test=False, name=None,
                  trg_seg=None, src_seg=None):
    att = attn_layers.multi_head_attention(
        _pre_norm(x), None, None, self_bias, d_key, d_value, d_model, n_head,
        dropout_rate=dropout_rate, causal=True, is_test=is_test,
        name=name and name + "_self", segment_ids_q=trg_seg, segment_ids_kv=trg_seg)
    x = _residual(x, att, dropout_rate, is_test)
    cross = attn_layers.multi_head_attention(
        _pre_norm(x), enc_out, enc_out, cross_bias, d_key, d_value, d_model,
        n_head, dropout_rate=dropout_rate, is_test=is_test,
        name=name and name + "_cross", segment_ids_q=trg_seg, segment_ids_kv=src_seg)
    x = _residual(x, cross, dropout_rate, is_test)
    ff = _ffn(_pre_norm(x), d_inner, d_model, dropout_rate, is_test, name=name)
    return _residual(x, ff, dropout_rate, is_test)


def _position_encoding_table(max_len, d_model):
    pos = np.arange(max_len)[:, None]
    dim = np.arange(d_model)[None, :]
    angle = pos / np.power(10000, 2 * (dim // 2) / d_model)
    table = np.zeros((max_len, d_model), dtype="float32")
    table[:, 0::2] = np.sin(angle[:, 0::2])
    table[:, 1::2] = np.cos(angle[:, 1::2])
    return table


def _padding_bias_from_mask(mask, n_head):
    """mask: [batch, seq] 1.0 for real tokens → additive bias [b, h, 1→q, k]."""
    neg = tl.scale(mask, scale=1e9, bias=-1e9)  # 0→-1e9, 1→0
    bias = layers.unsqueeze(neg, axes=[1, 2])  # [b,1,1,k]
    return layers.expand(bias, [1, n_head, 1, 1])


def embed_inputs(ids, vocab_size, d_model, max_len, name, pos_ids=None,
                 dropout_rate=0.1, is_test=False, scale_embedding=True):
    emb = layers.embedding(ids, size=[vocab_size, d_model],
                           param_attr=layers.ParamAttr(
                               name=name + "_emb",
                               initializer=init_mod.Normal(0.0, d_model ** -0.5)))
    if scale_embedding:
        emb = tl.scale(emb, scale=d_model ** 0.5)
    pos_table = _position_encoding_table(max_len, d_model)
    if pos_ids is None:
        seq_len = ids.shape[1]
        pos = tl.assign(pos_table[:seq_len])
        out = layers.elementwise_add(emb, pos, axis=1)
    else:
        pos_param = layers.ParamAttr(name=name + "_pos_emb",
                                     initializer=init_mod.NumpyArrayInitializer(pos_table))
        pos_emb = layers.embedding(pos_ids, size=[max_len, d_model], param_attr=pos_param)
        out = layers.elementwise_add(emb, pos_emb)
    if dropout_rate:
        out = layers.dropout(out, dropout_rate, is_test=is_test,
                             dropout_implementation="upscale_in_train")
    return out


def transformer(
    src_ids,
    trg_ids,
    trg_labels,
    src_mask,
    trg_mask,
    src_vocab_size,
    trg_vocab_size,
    max_length=256,
    n_layer=6,
    n_head=8,
    d_model=512,
    d_inner=2048,
    dropout_rate=0.1,
    label_smooth_eps=0.1,
    is_test=False,
    weight_sharing=False,
):
    """Transformer-base seq2seq with teacher forcing (training graph).

    src_ids/trg_ids: [batch, seq] int64; trg_labels: [batch, seq, 1] int64
    (next-token targets); masks: [batch, seq] float 1.0 on real tokens.
    """
    d_key = d_value = d_model // n_head

    enc_in = embed_inputs(src_ids, src_vocab_size, d_model, max_length, "src",
                          dropout_rate=dropout_rate, is_test=is_test)
    src_seg = tl.cast(src_mask, "int32")
    trg_seg = tl.cast(trg_mask, "int32")
    x = enc_in
    for i in range(n_layer):
        x = encoder_layer(x, None, n_head, d_key, d_value, d_model, d_inner,
                          dropout_rate, is_test, name="enc_%d" % i, seg_ids=src_seg)
    enc_out = _pre_norm(x)

    dec_in = embed_inputs(trg_ids, trg_vocab_size, d_model, max_length, "trg",
                          dropout_rate=dropout_rate, is_test=is_test)
    y = dec_in
    for i in range(n_layer):
        y = decoder_layer(y, enc_out, None, None, n_head, d_key,
                          d_value, d_model, d_inner, dropout_rate, is_test,
                          name="dec_%d" % i, trg_seg=trg_seg, src_seg=src_seg)
    dec_out = _pre_norm(y)

    logits = layers.fc(dec_out, size=trg_vocab_size, num_flatten_dims=2,
                       name="predict")
    # label smoothing fused into the single log_softmax pass — the [B, S, V]
    # logits array is the HBM-bandwidth hot spot, traverse it once.
    per_tok = layers.softmax_with_cross_entropy(
        logits, trg_labels,
        label_smoothing=(label_smooth_eps or 0.0) if not is_test else 0.0)
    # mask out padding positions; normalize by token count
    masked = layers.elementwise_mul(per_tok, layers.unsqueeze(trg_mask, axes=[2]))
    token_count = layers.reduce_sum(trg_mask)
    loss = layers.elementwise_div(layers.reduce_sum(masked), token_count)
    return logits, loss


def transformer_base(src_ids, trg_ids, trg_labels, src_mask, trg_mask,
                     src_vocab_size=30000, trg_vocab_size=30000, **kw):
    return transformer(src_ids, trg_ids, trg_labels, src_mask, trg_mask,
                       src_vocab_size, trg_vocab_size,
                       n_layer=6, n_head=8, d_model=512, d_inner=2048, **kw)


# -- BERT ---------------------------------------------------------------------


def bert_encoder(
    input_ids,
    pos_ids,
    sent_ids,
    input_mask,
    vocab_size=30522,
    max_position=512,
    type_vocab_size=2,
    n_layer=12,
    n_head=12,
    d_model=768,
    d_inner=3072,
    dropout_rate=0.1,
    is_test=False,
):
    """BERT-base encoder producing sequence + pooled outputs."""
    emb = layers.embedding(input_ids, size=[vocab_size, d_model],
                           param_attr=layers.ParamAttr(
                               name="word_embedding",
                               initializer=init_mod.Normal(0.0, 0.02)))
    pos_emb = layers.embedding(pos_ids, size=[max_position, d_model],
                               param_attr=layers.ParamAttr(
                                   name="pos_embedding",
                                   initializer=init_mod.Normal(0.0, 0.02)))
    sent_emb = layers.embedding(sent_ids, size=[type_vocab_size, d_model],
                                param_attr=layers.ParamAttr(
                                    name="sent_embedding",
                                    initializer=init_mod.Normal(0.0, 0.02)))
    emb = layers.elementwise_add(layers.elementwise_add(emb, pos_emb), sent_emb)
    emb = layers.layer_norm(emb, begin_norm_axis=2)
    if dropout_rate:
        emb = layers.dropout(emb, dropout_rate, is_test=is_test,
                             dropout_implementation="upscale_in_train")

    seg = tl.cast(input_mask, "int32")
    d_key = d_value = d_model // n_head
    x = emb
    for i in range(n_layer):
        # BERT arrangement: post-norm blocks, gelu FFN, no relu_dropout
        x = encoder_layer(x, None, n_head, d_key, d_value, d_model, d_inner,
                          dropout_rate, is_test, name="bert_l%d" % i,
                          seg_ids=seg, inner_dropout=0, post_norm=True,
                          # tanh-approx gelu: the erf form rematerializes as
                          # a 135-instruction polynomial inside both fc
                          # dw-grad fusions (~0.25 ms/layer/step more than
                          # the 18-instruction tanh form on the VPU)
                          ffn_act={"type": "gelu", "approximate": True})
    seq_out = x
    first_tok = layers.slice(seq_out, axes=[1], starts=[0], ends=[1])
    pooled = layers.fc(layers.squeeze(first_tok, axes=[1]), size=d_model,
                       act="tanh", name="pooled_fc")
    return seq_out, pooled


def bert_pretrain(
    input_ids, pos_ids, sent_ids, input_mask, mask_positions, mask_labels,
    nsp_labels, vocab_size=30522, d_model=768, **kw
):
    """Masked-LM + next-sentence-prediction pretraining loss.

    mask_positions: [batch, n_mask] int64 flat positions into [b*s];
    mask_labels: [batch*n_mask, 1]; nsp_labels: [batch, 1].
    """
    seq_out, pooled = bert_encoder(input_ids, pos_ids, sent_ids, input_mask,
                                   vocab_size=vocab_size, d_model=d_model, **kw)
    flat = layers.reshape(seq_out, [-1, d_model])
    picked = layers.gather(flat, layers.reshape(mask_positions, [-1, 1]))
    mlm_h = layers.fc(picked, size=d_model,
                      act={"type": "gelu", "approximate": True},
                      name="mlm_transform")
    mlm_h = layers.layer_norm(mlm_h, begin_norm_axis=1)
    mlm_logits = layers.fc(mlm_h, size=vocab_size, name="mlm_out")
    mlm_loss = layers.mean(layers.softmax_with_cross_entropy(mlm_logits, mask_labels))
    nsp_logits = layers.fc(pooled, size=2, name="nsp_out")
    nsp_loss = layers.mean(layers.softmax_with_cross_entropy(nsp_logits, nsp_labels))
    total = layers.elementwise_add(mlm_loss, nsp_loss)
    return total, mlm_loss, nsp_loss


def causal_lm(token_ids, labels, vocab_size=32000, max_length=2048,
              n_layer=12, n_head=16, d_model=1024, d_inner=4096,
              dropout_rate=0.1, is_test=False):
    """Decoder-only causal LM over the encoder blocks (pre-norm, gelu FFN,
    causal attention). Attention-probs dropout is 0 (the modern
    long-context recipe) — the long-context training configuration
    (residual/embedding dropout stay on). From
    ``FLAGS_flash_attention_min_seq`` tokens up its attention runs through
    the flash-attention kernels (``ops/kernels/flash_attention.py``).
    Returns (logits, mean token cross-entropy loss)."""
    x = embed_inputs(token_ids, vocab_size, d_model, max_length, "lm",
                     dropout_rate=dropout_rate, is_test=is_test)
    d_key = d_value = d_model // n_head
    for i in range(n_layer):
        x = encoder_layer(x, None, n_head, d_key, d_value, d_model, d_inner,
                          dropout_rate, is_test, name="lm_l%d" % i,
                          ffn_act={"type": "gelu", "approximate": True},
                          inner_dropout=0, attn_dropout=0, causal=True)
    x = _pre_norm(x)
    logits = layers.fc(x, size=vocab_size, num_flatten_dims=2, name="lm_head")
    loss = layers.mean(layers.softmax_with_cross_entropy(logits, labels))
    return logits, loss
