# ported from paddle_tpu/layers/attention.py
"""Attention layers.

Fluid composes attention from primitives in model scripts (reference:
tests/unittests/dist_transformer.py multi_head_attention); here it is a
first-class layer backed by the fused ``scaled_dot_product_attention`` op,
or, under ``FLAGS_unfused_attention``, that primitive composition, which
the default pass pipeline rewrites back onto the fused op.
"""

from __future__ import annotations

from typing import Optional

from .layer_helper import LayerHelper
from . import nn, tensor

__all__ = ["scaled_dot_product_attention", "multi_head_attention"]


def _segment_bias(seg_q, seg_kv):
    """[b, sq]/[b, sk] segment ids -> additive [b, 1, sq, sk] bias: 0 where
    ids match, -1e9 where they don't (the primitive-composition equivalent
    of the fused op's segment mask)."""
    from . import control_flow as cf

    sq = nn.unsqueeze(nn.unsqueeze(seg_q, axes=[1]), axes=[3])    # [b,1,sq,1]
    skv = nn.unsqueeze(nn.unsqueeze(seg_kv, axes=[1]), axes=[2])  # [b,1,1,sk]
    mask = tensor.cast(cf.equal(sq, skv), "float32")
    return tensor.scale(mask, scale=1e9, bias=-1e9)


def scaled_dot_product_attention(q, k, v, bias=None, causal=False, sm_scale=1.0,
                                 dropout_rate=0.0, is_test=False, name=None,
                                 segment_ids_q=None, segment_ids_kv=None,
                                 unfused=None):
    """q/k/v: [batch, heads, seq, head_dim].

    ``unfused`` (default: ``FLAGS_unfused_attention``) emits the
    reference-style primitive composition — ``matmul(Q, K^T, alpha) ->
    [+bias] -> softmax -> [dropout] -> matmul(probs, V)`` — instead of the
    fused op. The default pass pipeline's ``flash_attention_rewrite``
    (``PADDLE_TPU_OPT_LEVEL >= 1``) fuses the composition back onto the
    ``scaled_dot_product_attention`` op when the executor first runs it,
    so the emitted graph stays inspectable and the fused kernels still run.
    Segment ids are lowered to an additive-bias composition (CSE merges
    identical chains across layers); CAUSAL attention always uses the
    fused op (the primitive pattern cannot express the mask losslessly).
    """
    if unfused is None:
        from ..flags import get_flag

        unfused = get_flag("unfused_attention")
    if unfused and not causal:
        if segment_ids_q is not None:
            seg_bias = _segment_bias(
                segment_ids_q,
                segment_ids_kv if segment_ids_kv is not None else segment_ids_q)
            bias = seg_bias if bias is None \
                else nn.elementwise_add(bias, seg_bias)
        scores = nn.matmul(q, k, transpose_y=True, alpha=float(sm_scale),
                           name=name and name + "_qk")
        if bias is not None:
            scores = nn.elementwise_add(scores, bias)
        probs = nn.softmax(scores)
        if dropout_rate:
            probs = nn.dropout(probs, dropout_rate, is_test=is_test,
                               dropout_implementation="upscale_in_train")
        return nn.matmul(probs, v, name=name and name + "_pv")
    helper = LayerHelper("sdpa", name=name)
    out = helper.create_variable_for_type_inference(q.dtype)
    inputs = {"Q": q, "K": k, "V": v}
    if bias is not None:
        inputs["Bias"] = bias
    if segment_ids_q is not None:
        inputs["SegmentIdsQ"] = segment_ids_q
        inputs["SegmentIdsKV"] = segment_ids_kv if segment_ids_kv is not None else segment_ids_q
    helper.append_op(
        "scaled_dot_product_attention",
        inputs=inputs,
        outputs={"Out": out},
        attrs={"causal": causal, "sm_scale": float(sm_scale),
               "dropout_rate": float(dropout_rate), "is_test": is_test},
    )
    return out


def multi_head_attention(
    queries,
    keys,
    values,
    attn_bias,
    d_key: int,
    d_value: int,
    d_model: int,
    n_head: int,
    dropout_rate: float = 0.0,
    causal: bool = False,
    is_test: bool = False,
    param_initializer=None,
    name: Optional[str] = None,
    segment_ids_q=None,
    segment_ids_kv=None,
):
    """reference: dist_transformer.py multi_head_attention — q/k/v projections,
    split heads, fused attention, combine heads, output projection.
    Inputs are [batch, seq, d_model]."""
    self_attn = keys is None and values is None
    keys = queries if keys is None else keys
    values = keys if values is None else values

    def _proj(x, size, nm):
        return nn.fc(x, size=size, num_flatten_dims=2, bias_attr=False,
                     param_attr=param_initializer, name=nm)

    if (self_attn and queries.shape is not None
            and queries.shape[-1] is not None):
        # fused QKV, as in the JAX package: one [D, 3·D'] matmul instead of
        # three, so the input activation is read once, with ONE merged
        # parameter (parameter names and shapes match the JAX package's).
        # Checkpoints that stored q/k/v separately can be migrated by
        # concatenating the three weights along axis 1.
        d_in = int(queries.shape[-1])
        sizes = (d_key * n_head, d_key * n_head, d_value * n_head)
        helper = LayerHelper("fc", param_attr=param_initializer,
                             name=name and name + "_qkv")
        wqkv = helper.create_parameter(param_initializer,
                                       shape=[d_in, sum(sizes)],
                                       dtype=queries.dtype)
        qkv = helper.create_variable_for_type_inference(queries.dtype)
        helper.append_op("mul", inputs={"X": queries, "Y": wqkv},
                         outputs={"Out": qkv},
                         attrs={"x_num_col_dims": 2, "y_num_col_dims": 1})
        q, k, v = nn.split(qkv, list(sizes), dim=2)
    else:
        q = _proj(queries, d_key * n_head, name and name + "_q")
        k = _proj(keys, d_key * n_head, name and name + "_k")
        v = _proj(values, d_value * n_head, name and name + "_v")

    def _split_heads(x, d):
        x = tensor.reshape(x, [0, 0, n_head, d])
        return tensor.transpose(x, [0, 2, 1, 3])

    q = _split_heads(q, d_key)
    k = _split_heads(k, d_key)
    v = _split_heads(v, d_value)

    ctx = scaled_dot_product_attention(
        q, k, v, bias=attn_bias, causal=causal, sm_scale=d_key ** -0.5,
        dropout_rate=dropout_rate, is_test=is_test, name=name,
        segment_ids_q=segment_ids_q, segment_ids_kv=segment_ids_kv,
    )
    ctx = tensor.transpose(ctx, [0, 2, 1, 3])
    ctx = tensor.reshape(ctx, [0, 0, n_head * d_value])
    return _proj(ctx, d_model, name and name + "_out")
