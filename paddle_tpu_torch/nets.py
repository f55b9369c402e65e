# ported from paddle_tpu/nets.py
"""Composite network helpers (reference: python/paddle/fluid/nets.py —
simple_img_conv_pool:28, img_conv_group:135, sequence_conv_pool:248,
glu:305, scaled_dot_product_attention:340). Pure compositions of layers;
the attention helper rides the port's fused attention op."""

from __future__ import annotations

from . import layers

__all__ = [
    "simple_img_conv_pool",
    "img_conv_group",
    "sequence_conv_pool",
    "glu",
    "scaled_dot_product_attention",
]


def simple_img_conv_pool(input, num_filters, filter_size, pool_size,
                         pool_stride, pool_padding=0, pool_type="max",
                         global_pooling=False, conv_stride=1, conv_padding=0,
                         conv_dilation=1, conv_groups=1, param_attr=None,
                         bias_attr=None, act=None, use_cudnn=True):
    conv_out = layers.conv2d(input, num_filters=num_filters,
                             filter_size=filter_size, stride=conv_stride,
                             padding=conv_padding, dilation=conv_dilation,
                             groups=conv_groups, param_attr=param_attr,
                             bias_attr=bias_attr, act=act, use_cudnn=use_cudnn)
    return layers.pool2d(conv_out, pool_size=pool_size, pool_type=pool_type,
                         pool_stride=pool_stride, pool_padding=pool_padding,
                         global_pooling=global_pooling)


def img_conv_group(input, conv_num_filter, pool_size, conv_padding=1,
                   conv_filter_size=3, conv_act=None, param_attr=None,
                   conv_with_batchnorm=False, conv_batchnorm_drop_rate=0.0,
                   pool_stride=1, pool_type="max", use_cudnn=True):
    """VGG-style conv(+BN+dropout)* then pool (reference: nets.py:135)."""
    tmp = input
    assert isinstance(conv_num_filter, (list, tuple))

    def _expand(v):
        return v if isinstance(v, (list, tuple)) else [v] * len(conv_num_filter)

    padding = _expand(conv_padding)
    fsize = _expand(conv_filter_size)
    pattr = _expand(param_attr)
    with_bn = _expand(conv_with_batchnorm)
    drop = _expand(conv_batchnorm_drop_rate)

    for i, nf in enumerate(conv_num_filter):
        local_act = None if with_bn[i] else conv_act
        tmp = layers.conv2d(tmp, num_filters=nf, filter_size=fsize[i],
                            padding=padding[i], param_attr=pattr[i],
                            act=local_act, use_cudnn=use_cudnn)
        if with_bn[i]:
            tmp = layers.batch_norm(tmp, act=conv_act)
            if abs(drop[i]) > 1e-5:
                tmp = layers.dropout(tmp, dropout_prob=drop[i])
    return layers.pool2d(tmp, pool_size=pool_size, pool_type=pool_type,
                         pool_stride=pool_stride)


def sequence_conv_pool(input, num_filters, filter_size, param_attr=None,
                       act="sigmoid", pool_type="max", length=None):
    """Context-window conv over time + sequence pool (reference: nets.py:248);
    takes the padded+Length convention's length vector."""
    from .layers import sequence as seq_layers
    from .layers.layer_helper import LayerHelper

    helper = LayerHelper("sequence_conv")
    d = int(input.shape[-1])
    filt = helper.create_parameter(param_attr, shape=[filter_size * d, num_filters],
                                   dtype=input.dtype)
    out = helper.create_variable_for_type_inference(input.dtype)
    inputs = {"X": input, "Filter": filt}
    if length is not None:
        inputs["Length"] = length
    helper.append_op("sequence_conv", inputs=inputs, outputs={"Out": out},
                     attrs={"contextLength": filter_size,
                            "contextStart": -(filter_size // 2)})
    if act:
        out = getattr(layers, act)(out)
    return seq_layers.sequence_pool(out, pool_type, length=length)


def glu(input, dim=-1):
    """Gated linear unit: split in half on ``dim``, a ⊙ σ(b)
    (reference: nets.py:305)."""
    a, b = layers.split(input, num_or_sections=2, dim=dim)
    return layers.elementwise_mul(a, layers.sigmoid(b))


def scaled_dot_product_attention(queries, keys, values, num_heads=1,
                                 dropout_rate=0.0):
    """Multi-head attention over [B, T, D] (reference: nets.py:340) — the
    port's fused attention op (the flash kernels from
    ``FLAGS_flash_attention_min_seq`` tokens up)."""
    from .layers.attention import multi_head_attention

    d_model = int(queries.shape[-1])
    if d_model % num_heads != 0:
        raise ValueError(
            "hidden size %d is not divisible by num_heads %d (reference "
            "nets.py raises here too)" % (d_model, num_heads))
    d_key = d_model // num_heads
    if keys is queries and values is queries:
        # self-attention: hand None through so the layer takes its fused
        # single-matmul QKV projection path
        keys = values = None
    return multi_head_attention(
        queries, keys, values, attn_bias=None, d_key=d_key, d_value=d_key,
        d_model=d_model, n_head=num_heads, dropout_rate=dropout_rate)
