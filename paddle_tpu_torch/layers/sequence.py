# ported from paddle_tpu/layers/sequence.py
"""Sequence layers over padded batches + lengths (reference:
layers/sequence_* wrappers in python/paddle/fluid/layers/nn.py).

See ops/sequence_ops.py for the LoD→padded+Length representation note.
Every layer takes an optional ``length`` Variable [B]; omitted means "all
rows full length".
"""

from __future__ import annotations

from .layer_helper import LayerHelper

__all__ = [
    "sequence_mask",
    "sequence_pool",
    "sequence_softmax",
    "sequence_reverse",
    "sequence_expand",
    "sequence_expand_as",
    "sequence_concat",
    "sequence_pad",
    "sequence_unpad",
    "sequence_erase",
    "sequence_enumerate",
    "sequence_slice",
    "sequence_scatter",
    "sequence_first_step",
    "sequence_last_step",
    "im2sequence",
    "row_conv",
    "sequence_conv",
    "sequence_reshape",
]


def _seq_op(op_type, inputs, attrs=None, dtype=None, out_slot="Out", extra_outs=()):
    helper = LayerHelper(op_type)
    ref = next(iter(inputs.values()))
    out = helper.create_variable_for_type_inference(dtype or ref.dtype)
    outputs = {out_slot: out}
    extras = []
    for slot in extra_outs:
        v = helper.create_variable_for_type_inference("int32", stop_gradient=True)
        outputs[slot] = v
        extras.append(v)
    helper.append_op(op_type, inputs=inputs, outputs=outputs, attrs=attrs or {})
    return (out, *extras) if extras else out


def sequence_mask(x, maxlen=None, dtype="int64", name=None):
    return _seq_op("sequence_mask", {"X": x},
                   {"maxlen": maxlen or -1, "out_dtype": dtype},
                   dtype=dtype, out_slot="Y")


def sequence_pool(input, pool_type, length=None, is_test=False, pad_value=0.0):
    inputs = {"X": input}
    if length is not None:
        inputs["Length"] = length
    return _seq_op("sequence_pool", inputs, {"pooltype": pool_type})


def sequence_first_step(input, length=None):
    return sequence_pool(input, "first", length)


def sequence_last_step(input, length=None):
    return sequence_pool(input, "last", length)


def sequence_softmax(input, length=None, use_cudnn=False, name=None):
    inputs = {"X": input}
    if length is not None:
        inputs["Length"] = length
    return _seq_op("sequence_softmax", inputs)


def sequence_reverse(x, length=None, name=None):
    inputs = {"X": x}
    if length is not None:
        inputs["Length"] = length
    return _seq_op("sequence_reverse", inputs, out_slot="Y")


def sequence_expand(x, y, ref_level=-1, name=None):
    return _seq_op("sequence_expand", {"X": x, "Y": y}, {"ref_level": ref_level})


def sequence_expand_as(x, y, name=None):
    return _seq_op("sequence_expand_as", {"X": x, "Y": y})


def sequence_concat(input, length=None, name=None):
    inputs = {"X": list(input)}
    if length is not None:
        inputs["Length"] = list(length)
        return _seq_op("sequence_concat", inputs, extra_outs=("LengthOut",))
    return _seq_op("sequence_concat", inputs)


def sequence_pad(x, pad_value, maxlen=None, length=None, name=None):
    inputs = {"X": x, "PadValue": pad_value}
    if length is not None:
        inputs["Length"] = length
    return _seq_op("sequence_pad", inputs, {"padded_length": maxlen or -1},
                   extra_outs=("Length",))


def sequence_unpad(x, length, name=None):
    return _seq_op("sequence_unpad", {"X": x, "Length": length})


def sequence_erase(x, tokens, name=None):
    return _seq_op("sequence_erase", {"X": x}, {"tokens": list(tokens)},
                   extra_outs=("Length",))


def sequence_enumerate(input, win_size, pad_value=0, name=None):
    return _seq_op("sequence_enumerate", {"X": input},
                   {"win_size": win_size, "pad_value": pad_value})


def sequence_slice(input, offset, length, out_maxlen=None, name=None):
    return _seq_op("sequence_slice",
                   {"X": input, "Offset": offset, "Length": length},
                   {"out_maxlen": out_maxlen or 0})


def sequence_scatter(input, index, updates, name=None):
    return _seq_op("sequence_scatter",
                   {"X": input, "Ids": index, "Updates": updates})


def im2sequence(input, filter_size=1, stride=1, padding=0, name=None):
    fs = filter_size if isinstance(filter_size, (list, tuple)) else [filter_size] * 2
    st = stride if isinstance(stride, (list, tuple)) else [stride] * 2
    return _seq_op("im2sequence", {"X": input}, {"kernels": list(fs), "strides": list(st)})


def row_conv(input, future_context_size, param_attr=None, act=None, name=None):
    helper = LayerHelper("row_conv", name=name)
    d = input.shape[-1]
    w = helper.create_parameter(param_attr, shape=[future_context_size + 1, d],
                                dtype=input.dtype)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("row_conv", inputs={"X": input, "Filter": w}, outputs={"Out": out})
    return helper.append_activation(out) if act else out


def sequence_conv(input, num_filters, filter_size=3, filter_stride=1,
                  padding=None, bias_attr=None, param_attr=None, act=None,
                  length=None, name=None):
    """Convolution over the time axis with a context window (reference:
    nn.py sequence_conv, operators/sequence_conv_op.cc). ``length`` is the
    padded+Length convention's per-row length var."""
    if filter_stride != 1:
        raise NotImplementedError("sequence_conv: only filter_stride=1 "
                                  "(matching the reference kernel)")
    helper = LayerHelper("sequence_conv", bias_attr=bias_attr, act=act,
                         name=name)
    filter_shape = [filter_size * input.shape[2], num_filters]
    w = helper.create_parameter(param_attr, shape=filter_shape,
                                dtype=input.dtype)
    pre_bias = helper.create_variable_for_type_inference(input.dtype)
    inputs = {"X": input, "Filter": w}
    if length is not None:
        inputs["Length"] = length
    helper.append_op(
        "sequence_conv", inputs=inputs, outputs={"Out": pre_bias},
        attrs={"contextLength": filter_size,
               "contextStart": -(filter_size // 2), "contextStride": 1})
    if bias_attr is False:
        pre_act = pre_bias
    else:
        from .layer_helper import ParamAttr

        bias = helper.create_parameter(ParamAttr.to_attr(bias_attr),
                                       shape=[num_filters],
                                       dtype=input.dtype, is_bias=True)
        pre_act = helper.create_variable_for_type_inference(input.dtype)
        helper.append_op("elementwise_add", inputs={"X": pre_bias, "Y": bias},
                         outputs={"Out": pre_act}, attrs={"axis": -1})
    return helper.append_activation(pre_act)


def sequence_reshape(input, new_dim, length=None):
    """Re-chunk the feature dim: [B, T, D] -> [B, T*D/new_dim, new_dim]
    (reference: nn.py sequence_reshape). Returns (out, new_length) when
    ``length`` is given, else out."""
    inputs = {"X": input}
    if length is not None:
        inputs["Length"] = length
        return _seq_op("sequence_reshape", inputs, {"new_dim": new_dim},
                       extra_outs=("OutLength",))
    return _seq_op("sequence_reshape", inputs, {"new_dim": new_dim})
