# ported from paddle_tpu/layers/nn.py
"""Neural-net layers (reference: python/paddle/fluid/layers/nn.py — 155 defs).

Each layer appends symbolic ops to the default main program via LayerHelper,
exactly Fluid's construction model (``nn.py:195`` fc et al.). The port's
Executor runs the ops that are registered in ``paddle_tpu_torch/ops``; a
layer whose op is not ported yet still builds, and running it raises the
registry's ``NotImplementedError``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

from ..core.framework import Variable
from .layer_helper import LayerHelper, ParamAttr

__all__ = [
    "fc",
    "embedding",
    "conv2d",
    "conv3d",
    "conv2d_transpose",
    "pool2d",
    "pool3d",
    "batch_norm",
    "layer_norm",
    "group_norm",
    "instance_norm",
    "data_norm",
    "lrn",
    "dropout",
    "softmax",
    "log_softmax",
    "cross_entropy",
    "softmax_with_cross_entropy",
    "sigmoid_cross_entropy_with_logits",
    "square_error_cost",
    "smooth_l1",
    "huber_loss",
    "log_loss",
    "matmul",
    "mul",
    "reduce_sum",
    "reduce_mean",
    "reduce_max",
    "reduce_min",
    "reduce_prod",
    "mean",
    "relu",
    "gelu",
    "tanh",
    "sigmoid",
    "leaky_relu",
    "prelu",
    "elu",
    "relu6",
    "swish",
    "maxout",
    "hard_sigmoid",
    "soft_relu",
    "brelu",
    "pow",
    "stanh",
    "l2_normalize",
    "clip",
    "clip_by_norm",
    "one_hot",
    "topk",
    "argsort",
    "argmax",
    "argmin",
    "accuracy",
    "auc",
    "pad",
    "pad2d",
    "image_resize",
    "resize_bilinear",
    "resize_nearest",
    "pixel_shuffle",
    "flatten",
    "unsqueeze",
    "squeeze",
    "stack",
    "unstack",
    "expand",
    "gather",
    "gather_nd",
    "scatter",
    "slice",
    "strided_slice",
    "shape",
    "where",
    "cos_sim",
    "dot",
    "elementwise_add",
    "elementwise_sub",
    "elementwise_mul",
    "elementwise_div",
    "elementwise_max",
    "elementwise_min",
    "elementwise_pow",
    "elementwise_mod",
    "uniform_random",
    "gaussian_random",
    "uniform_random_batch_size_like",
    "gaussian_random_batch_size_like",
    "bilinear_tensor_product",
    "split",
    "multiplex",
    "label_smooth",
    "mean_iou",
    "space_to_depth",
    "shuffle_channel",
    "autoincreased_step_counter",
]


def _single_op_layer(helper_name, op_type, x, attrs=None, x_slot="X", out_slot="Out", name=None, dtype=None):
    helper = LayerHelper(helper_name, name=name)
    out = helper.create_variable_for_type_inference(dtype or x.dtype)
    helper.append_op(op_type, inputs={x_slot: x}, outputs={out_slot: out}, attrs=attrs or {})
    return out


def fc(
    input,
    size: int,
    num_flatten_dims: int = 1,
    param_attr=None,
    bias_attr=None,
    act: Optional[str] = None,
    is_test: bool = False,
    name: Optional[str] = None,
):
    """Fully-connected layer (reference: layers/nn.py:195).

    Multiple inputs each get their own weight; results are summed (mul ops +
    sum op, like Fluid), then bias + activation.
    """
    helper = LayerHelper("fc", input=input, param_attr=param_attr, bias_attr=bias_attr, act=act, name=name)
    inputs = input if isinstance(input, (list, tuple)) else [input]
    param_attrs = param_attr if isinstance(param_attr, (list, tuple)) else [param_attr] * len(inputs)
    mul_results = []
    for inp, pattr in zip(inputs, param_attrs):
        input_shape = inp.shape
        if input_shape is None:
            raise ValueError(
                "fc: input %r has unknown shape (shape inference failed on the "
                "producing op %r) — check the upstream layer geometry"
                % (inp.name, inp.op.type if inp.op else None)
            )
        import numpy as _np

        in_features = int(_np.prod([d for d in input_shape[num_flatten_dims:]]))
        w = helper.create_parameter(pattr, shape=[in_features, size], dtype=inp.dtype)
        tmp = helper.create_variable_for_type_inference(inp.dtype)
        helper.append_op(
            "mul",
            inputs={"X": inp, "Y": w},
            outputs={"Out": tmp},
            attrs={"x_num_col_dims": num_flatten_dims, "y_num_col_dims": 1},
        )
        mul_results.append(tmp)
    if len(mul_results) == 1:
        pre_bias = mul_results[0]
    else:
        pre_bias = helper.create_variable_for_type_inference(inputs[0].dtype)
        helper.append_op("sum", inputs={"X": mul_results}, outputs={"Out": pre_bias})
    if bias_attr is False:
        pre_act = pre_bias
    else:
        pre_act = helper.append_bias_op(pre_bias, dim_start=num_flatten_dims)
    return helper.append_activation(pre_act)


def embedding(
    input,
    size: Sequence[int],
    is_sparse: bool = False,
    is_distributed: bool = False,
    padding_idx: Optional[int] = None,
    param_attr=None,
    dtype="float32",
    name=None,
):
    """Embedding lookup (reference: layers/nn.py embedding). ``is_sparse=True``
    enables the SelectedRows-equivalent (ids, rows) gradient path — the table
    gradient stays O(N·D) and row-wise optimizer updates apply lazily (see
    core/sparse.py, ops/nn_ops.py lookup_table_op)."""
    helper = LayerHelper("embedding", name=name)
    w = helper.create_parameter(param_attr, shape=list(size), dtype=dtype)
    if is_sparse:
        w.is_sparse_param = True
    out = helper.create_variable_for_type_inference(dtype)
    padding_idx = -1 if padding_idx is None else (padding_idx if padding_idx >= 0 else size[0] + padding_idx)
    helper.append_op(
        "lookup_table",
        inputs={"W": w, "Ids": input},
        outputs={"Out": out},
        attrs={"padding_idx": padding_idx, "is_sparse": is_sparse, "is_distributed": is_distributed},
    )
    return out


def conv2d(
    input,
    num_filters: int,
    filter_size,
    stride=1,
    padding=0,
    dilation=1,
    groups: int = 1,
    param_attr=None,
    bias_attr=None,
    use_cudnn: bool = True,
    act: Optional[str] = None,
    name: Optional[str] = None,
    data_format: str = "NCHW",
):
    """2-D convolution, OIHW weights (reference: layers/nn.py conv2d).

    data_format NHWC runs channels-last — the TPU-native layout (channels on
    the 128-lane minor dim); weights stay OIHW so checkpoints are portable.
    """
    helper = LayerHelper("conv2d", bias_attr=bias_attr, act=act, name=name)
    num_channels = input.shape[-1] if data_format == "NHWC" else input.shape[1]
    filter_size = _pair(filter_size)
    stride = _pair(stride)
    padding = _pair(padding)
    dilation = _pair(dilation)
    groups = groups or 1
    filter_shape = [num_filters, num_channels // groups] + list(filter_size)

    import math as _math

    std = (2.0 / (filter_size[0] * filter_size[1] * num_channels)) ** 0.5
    from .. import initializer as init_mod

    w = helper.create_parameter(
        param_attr,
        shape=filter_shape,
        dtype=input.dtype,
        default_initializer=init_mod.Normal(0.0, std),
    )
    pre_bias = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        "conv2d",
        inputs={"Input": input, "Filter": w},
        outputs={"Output": pre_bias},
        attrs={
            "strides": list(stride),
            "paddings": list(padding),
            "dilations": list(dilation),
            "groups": groups,
            "use_cudnn": use_cudnn,
            "data_format": data_format,
        },
    )
    if bias_attr is False:
        pre_act = pre_bias
    else:
        bias = helper.create_parameter(
            ParamAttr.to_attr(bias_attr), shape=[num_filters], dtype=input.dtype, is_bias=True
        )
        pre_act = helper.create_variable_for_type_inference(input.dtype)
        helper.append_op(
            "elementwise_add",
            inputs={"X": pre_bias, "Y": bias},
            outputs={"Out": pre_act},
            attrs={"axis": 3 if data_format == "NHWC" else 1},
        )
    return helper.append_activation(pre_act)


def conv3d(input, num_filters, filter_size, stride=1, padding=0, dilation=1, groups=1,
           param_attr=None, bias_attr=None, use_cudnn=True, act=None, name=None):
    helper = LayerHelper("conv3d", bias_attr=bias_attr, act=act, name=name)
    num_channels = input.shape[1]
    fs = _triple(filter_size)
    filter_shape = [num_filters, num_channels // (groups or 1)] + list(fs)
    w = helper.create_parameter(param_attr, shape=filter_shape, dtype=input.dtype)
    pre_bias = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        "conv3d",
        inputs={"Input": input, "Filter": w},
        outputs={"Output": pre_bias},
        attrs={
            "strides": list(_triple(stride)),
            "paddings": list(_triple(padding)),
            "dilations": list(_triple(dilation)),
            "groups": groups or 1,
        },
    )
    if bias_attr is False:
        pre_act = pre_bias
    else:
        bias = helper.create_parameter(ParamAttr.to_attr(bias_attr), shape=[num_filters], dtype=input.dtype, is_bias=True)
        pre_act = helper.create_variable_for_type_inference(input.dtype)
        helper.append_op("elementwise_add", inputs={"X": pre_bias, "Y": bias}, outputs={"Out": pre_act}, attrs={"axis": 1})
    return helper.append_activation(pre_act)


def conv2d_transpose(input, num_filters, output_size=None, filter_size=None, padding=0,
                     stride=1, dilation=1, groups=1, param_attr=None, bias_attr=None,
                     use_cudnn=True, act=None, name=None):
    helper = LayerHelper("conv2d_transpose", bias_attr=bias_attr, act=act, name=name)
    num_channels = input.shape[1]
    stride = _pair(stride)
    padding = _pair(padding)
    dilation = _pair(dilation)
    if filter_size is None:
        if output_size is None:
            raise ValueError("filter_size or output_size required")
        output_size = _pair(output_size)
        h_in, w_in = input.shape[2], input.shape[3]
        filter_size = [
            (output_size[0] - (h_in - 1) * stride[0] + 2 * padding[0] - 1) // dilation[0] + 1,
            (output_size[1] - (w_in - 1) * stride[1] + 2 * padding[1] - 1) // dilation[1] + 1,
        ]
    else:
        filter_size = list(_pair(filter_size))
    filter_shape = [num_channels, num_filters // (groups or 1)] + filter_size
    w = helper.create_parameter(param_attr, shape=filter_shape, dtype=input.dtype)
    pre_bias = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        "conv2d_transpose",
        inputs={"Input": input, "Filter": w},
        outputs={"Output": pre_bias},
        attrs={
            "strides": list(stride),
            "paddings": list(padding),
            "dilations": list(dilation),
            "groups": groups or 1,
        },
    )
    if bias_attr is False:
        pre_act = pre_bias
    else:
        bias = helper.create_parameter(ParamAttr.to_attr(bias_attr), shape=[num_filters], dtype=input.dtype, is_bias=True)
        pre_act = helper.create_variable_for_type_inference(input.dtype)
        helper.append_op("elementwise_add", inputs={"X": pre_bias, "Y": bias}, outputs={"Out": pre_act}, attrs={"axis": 1})
    return helper.append_activation(pre_act)


def pool2d(input, pool_size=-1, pool_type="max", pool_stride=1, pool_padding=0,
           global_pooling=False, use_cudnn=True, ceil_mode=False, exclusive=True,
           name=None, data_format="NCHW"):
    helper = LayerHelper("pool2d", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        "pool2d",
        inputs={"X": input},
        outputs={"Out": out},
        attrs={
            "pooling_type": pool_type,
            "ksize": list(_pair(pool_size)),
            "strides": list(_pair(pool_stride)),
            "paddings": list(_pair(pool_padding)),
            "global_pooling": global_pooling,
            "ceil_mode": ceil_mode,
            "exclusive": exclusive,
            "data_format": data_format,
        },
    )
    return out


def pool3d(input, pool_size=-1, pool_type="max", pool_stride=1, pool_padding=0,
           global_pooling=False, use_cudnn=True, ceil_mode=False, exclusive=True, name=None):
    helper = LayerHelper("pool3d", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        "pool3d",
        inputs={"X": input},
        outputs={"Out": out},
        attrs={
            "pooling_type": pool_type,
            "ksize": list(_triple(pool_size)),
            "strides": list(_triple(pool_stride)),
            "paddings": list(_triple(pool_padding)),
            "global_pooling": global_pooling,
            "ceil_mode": ceil_mode,
            "exclusive": exclusive,
        },
    )
    return out


def batch_norm(
    input,
    act: Optional[str] = None,
    is_test: bool = False,
    momentum: float = 0.9,
    epsilon: float = 1e-5,
    param_attr=None,
    bias_attr=None,
    data_layout: str = "NCHW",
    name: Optional[str] = None,
    moving_mean_name: Optional[str] = None,
    moving_variance_name: Optional[str] = None,
    use_global_stats: bool = False,
):
    """Batch normalization (reference: layers/nn.py batch_norm)."""
    from ..core import unique_name
    from .. import initializer as init_mod

    helper = LayerHelper("batch_norm", act=act, name=name)
    dtype = input.dtype
    channels = input.shape[1] if data_layout == "NCHW" else input.shape[-1]
    scale = helper.create_parameter(
        param_attr, shape=[channels], dtype=dtype, default_initializer=init_mod.Constant(1.0)
    )
    bias = helper.create_parameter(ParamAttr.to_attr(bias_attr), shape=[channels], dtype=dtype, is_bias=True)
    mean_name = moving_mean_name or unique_name.generate(helper.name + ".mean")
    var_name = moving_variance_name or unique_name.generate(helper.name + ".var")
    mean = helper.create_or_get_global_variable([channels], dtype, mean_name, initializer=init_mod.Constant(0.0))
    variance = helper.create_or_get_global_variable([channels], dtype, var_name, initializer=init_mod.Constant(1.0))

    out = helper.create_variable_for_type_inference(dtype)
    saved_mean = helper.create_variable_for_type_inference(dtype, stop_gradient=True)
    saved_var = helper.create_variable_for_type_inference(dtype, stop_gradient=True)
    helper.append_op(
        "batch_norm",
        inputs={"X": input, "Scale": scale, "Bias": bias, "Mean": mean, "Variance": variance},
        outputs={
            "Y": out,
            "MeanOut": mean,
            "VarianceOut": variance,
            "SavedMean": saved_mean,
            "SavedVariance": saved_var,
        },
        attrs={
            "momentum": momentum,
            "epsilon": epsilon,
            "is_test": is_test,
            "data_layout": data_layout,
            "use_global_stats": use_global_stats,
        },
    )
    return helper.append_activation(out)


def layer_norm(
    input,
    scale: bool = True,
    shift: bool = True,
    begin_norm_axis: int = 1,
    epsilon: float = 1e-5,
    param_attr=None,
    bias_attr=None,
    act: Optional[str] = None,
    name: Optional[str] = None,
):
    """Layer normalization (reference: layers/nn.py layer_norm)."""
    from .. import initializer as init_mod
    import numpy as _np

    helper = LayerHelper("layer_norm", act=act, name=name)
    dtype = input.dtype
    norm_shape = [int(_np.prod(input.shape[begin_norm_axis:]))]
    inputs = {"X": input}
    if scale:
        s = helper.create_parameter(param_attr, shape=norm_shape, dtype=dtype, default_initializer=init_mod.Constant(1.0))
        inputs["Scale"] = s
    if shift:
        b = helper.create_parameter(ParamAttr.to_attr(bias_attr), shape=norm_shape, dtype=dtype, is_bias=True)
        inputs["Bias"] = b
    out = helper.create_variable_for_type_inference(dtype)
    mean_out = helper.create_variable_for_type_inference(dtype, stop_gradient=True)
    var_out = helper.create_variable_for_type_inference(dtype, stop_gradient=True)
    helper.append_op(
        "layer_norm",
        inputs=inputs,
        outputs={"Y": out, "Mean": mean_out, "Variance": var_out},
        attrs={"begin_norm_axis": begin_norm_axis, "epsilon": epsilon},
    )
    return helper.append_activation(out)


def group_norm(input, groups, epsilon=1e-5, param_attr=None, bias_attr=None,
               act=None, data_layout="NCHW", name=None):
    from .. import initializer as init_mod

    helper = LayerHelper("group_norm", act=act, name=name)
    channels = input.shape[1]
    inputs = {"X": input}
    if param_attr is not False:
        inputs["Scale"] = helper.create_parameter(param_attr, shape=[channels], dtype=input.dtype,
                                                  default_initializer=init_mod.Constant(1.0))
    if bias_attr is not False:
        inputs["Bias"] = helper.create_parameter(ParamAttr.to_attr(bias_attr), shape=[channels],
                                                 dtype=input.dtype, is_bias=True)
    out = helper.create_variable_for_type_inference(input.dtype)
    mean_out = helper.create_variable_for_type_inference(input.dtype, stop_gradient=True)
    var_out = helper.create_variable_for_type_inference(input.dtype, stop_gradient=True)
    helper.append_op("group_norm", inputs=inputs,
                     outputs={"Y": out, "Mean": mean_out, "Variance": var_out},
                     attrs={"groups": groups, "epsilon": epsilon})
    return helper.append_activation(out)


def instance_norm(input, epsilon=1e-5, param_attr=None, bias_attr=None, name=None):
    from .. import initializer as init_mod

    helper = LayerHelper("instance_norm", name=name)
    channels = input.shape[1]
    scale = helper.create_parameter(param_attr, shape=[channels], dtype=input.dtype,
                                    default_initializer=init_mod.Constant(1.0))
    bias = helper.create_parameter(ParamAttr.to_attr(bias_attr), shape=[channels], dtype=input.dtype, is_bias=True)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("instance_norm", inputs={"X": input, "Scale": scale, "Bias": bias},
                     outputs={"Y": out}, attrs={"epsilon": epsilon})
    return out


def data_norm(input, act=None, epsilon=1e-5, param_attr=None, name=None):
    raise NotImplementedError("data_norm layer: use batch_norm; op exists for parity")


def lrn(input, n=5, k=1.0, alpha=1e-4, beta=0.75, name=None):
    helper = LayerHelper("lrn", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    mid = helper.create_variable_for_type_inference(input.dtype, stop_gradient=True)
    helper.append_op("lrn", inputs={"X": input}, outputs={"Out": out, "MidOut": mid},
                     attrs={"n": n, "k": k, "alpha": alpha, "beta": beta})
    return out


def dropout(x, dropout_prob, is_test=False, seed=None, name=None,
            dropout_implementation="downgrade_in_infer"):
    helper = LayerHelper("dropout", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    mask = helper.create_variable_for_type_inference(x.dtype, stop_gradient=True)
    helper.append_op(
        "dropout",
        inputs={"X": x},
        outputs={"Out": out, "Mask": mask},
        attrs={
            "dropout_prob": dropout_prob,
            "is_test": is_test,
            "seed": seed or 0,
            "dropout_implementation": dropout_implementation,
        },
    )
    return out


def softmax(input, use_cudnn=False, name=None, axis=-1):
    return _single_op_layer("softmax", "softmax", input, {"axis": axis}, name=name)


def log_softmax(input, axis=-1, name=None):
    return _single_op_layer("log_softmax", "log_softmax", input, {"axis": axis}, name=name)


def cross_entropy(input, label, soft_label=False, ignore_index=-100):
    helper = LayerHelper("cross_entropy")
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        "cross_entropy",
        inputs={"X": input, "Label": label},
        outputs={"Y": out},
        attrs={"soft_label": soft_label, "ignore_index": ignore_index},
    )
    return out


def softmax_with_cross_entropy(logits, label, soft_label=False, ignore_index=-100,
                               numeric_stable_mode=True, return_softmax=False, axis=-1,
                               label_smoothing=0.0):
    """``label_smoothing`` is a TPU-native fusion extension: smoothing folds
    into the single log_softmax pass instead of a second full-vocab traversal
    (the reference composes label_smooth + softmax_with_cross_entropy ops)."""
    helper = LayerHelper("softmax_with_cross_entropy")
    loss = helper.create_variable_for_type_inference(logits.dtype)
    # the Softmax slot is only declared when the caller asks for it — the
    # exp(log_p) pass over the [N, V] logits (2GB at the bench shapes) must
    # not ride along in every training step
    outputs = {"Loss": loss}
    if return_softmax:
        softmax_out = helper.create_variable_for_type_inference(logits.dtype)
        outputs["Softmax"] = softmax_out
    helper.append_op(
        "softmax_with_cross_entropy",
        inputs={"Logits": logits, "Label": label},
        outputs=outputs,
        attrs={"soft_label": soft_label, "ignore_index": ignore_index,
               "label_smoothing": float(label_smoothing)},
    )
    if return_softmax:
        return loss, softmax_out
    return loss


def sigmoid_cross_entropy_with_logits(x, label, ignore_index=-100, normalize=False, name=None):
    helper = LayerHelper("sigmoid_cross_entropy_with_logits", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(
        "sigmoid_cross_entropy_with_logits",
        inputs={"X": x, "Label": label},
        outputs={"Out": out},
        attrs={"ignore_index": ignore_index, "normalize": normalize},
    )
    return out


def square_error_cost(input, label):
    """(input-label)^2 (reference: layers/nn.py square_error_cost)."""
    helper = LayerHelper("square_error_cost")
    diff = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("elementwise_sub", inputs={"X": input, "Y": label}, outputs={"Out": diff})
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("square", inputs={"X": diff}, outputs={"Out": out})
    return out


def smooth_l1(x, y, inside_weight=None, outside_weight=None, sigma=None):
    helper = LayerHelper("smooth_l1")
    diff = helper.create_variable_for_type_inference(x.dtype)
    out = helper.create_variable_for_type_inference(x.dtype)
    inputs = {"X": x, "Y": y}
    if inside_weight is not None:
        inputs["InsideWeight"] = inside_weight
    if outside_weight is not None:
        inputs["OutsideWeight"] = outside_weight
    helper.append_op("smooth_l1_loss", inputs=inputs, outputs={"Diff": diff, "Out": out},
                     attrs={"sigma": sigma or 1.0})
    return out


def huber_loss(input, label, delta):
    helper = LayerHelper("huber_loss")
    residual = helper.create_variable_for_type_inference(input.dtype)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("huber_loss", inputs={"X": input, "Y": label},
                     outputs={"Residual": residual, "Out": out}, attrs={"delta": delta})
    return out


def log_loss(input, label, epsilon=1e-4, name=None):
    helper = LayerHelper("log_loss", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("log_loss", inputs={"Predicted": input, "Labels": label},
                     outputs={"Loss": out}, attrs={"epsilon": epsilon})
    return out


def matmul(x, y, transpose_x=False, transpose_y=False, alpha=1.0, name=None):
    helper = LayerHelper("matmul", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(
        "matmul",
        inputs={"X": x, "Y": y},
        outputs={"Out": out},
        attrs={"transpose_X": transpose_x, "transpose_Y": transpose_y, "alpha": float(alpha)},
    )
    return out


def mul(x, y, x_num_col_dims=1, y_num_col_dims=1, name=None):
    helper = LayerHelper("mul", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(
        "mul",
        inputs={"X": x, "Y": y},
        outputs={"Out": out},
        attrs={"x_num_col_dims": x_num_col_dims, "y_num_col_dims": y_num_col_dims},
    )
    return out


def _reduce_layer(op_type, input, dim, keep_dim, name):
    if dim is None:
        attrs = {"dim": [0], "keep_dim": keep_dim, "reduce_all": True}
    else:
        dim = dim if isinstance(dim, (list, tuple)) else [dim]
        attrs = {"dim": list(dim), "keep_dim": keep_dim, "reduce_all": False}
    return _single_op_layer(op_type, op_type, input, attrs, name=name)


def reduce_sum(input, dim=None, keep_dim=False, name=None):
    return _reduce_layer("reduce_sum", input, dim, keep_dim, name)


def reduce_mean(input, dim=None, keep_dim=False, name=None):
    return _reduce_layer("reduce_mean", input, dim, keep_dim, name)


def reduce_max(input, dim=None, keep_dim=False, name=None):
    return _reduce_layer("reduce_max", input, dim, keep_dim, name)


def reduce_min(input, dim=None, keep_dim=False, name=None):
    return _reduce_layer("reduce_min", input, dim, keep_dim, name)


def reduce_prod(input, dim=None, keep_dim=False, name=None):
    return _reduce_layer("reduce_prod", input, dim, keep_dim, name)


def mean(x, name=None):
    return _single_op_layer("mean", "mean", x, name=name)


# -- activations as layers ----------------------------------------------------


def _act(op_type, x, attrs=None, name=None):
    return _single_op_layer(op_type, op_type, x, attrs, name=name)


def relu(x, name=None):
    return _act("relu", x, name=name)


def gelu(x, approximate=False, name=None):
    return _act("gelu", x, {"approximate": approximate}, name=name)


def tanh(x, name=None):
    return _act("tanh", x, name=name)


def sigmoid(x, name=None):
    return _act("sigmoid", x, name=name)


def leaky_relu(x, alpha=0.02, name=None):
    return _act("leaky_relu", x, {"alpha": alpha}, name=name)


def elu(x, alpha=1.0, name=None):
    return _act("elu", x, {"alpha": alpha}, name=name)


def relu6(x, threshold=6.0, name=None):
    return _act("relu6", x, {"threshold": threshold}, name=name)


def swish(x, beta=1.0, name=None):
    return _act("swish", x, {"beta": beta}, name=name)


def hard_sigmoid(x, slope=0.2, offset=0.5, name=None):
    return _act("hard_sigmoid", x, {"slope": slope, "offset": offset}, name=name)


def soft_relu(x, threshold=40.0, name=None):
    return _act("soft_relu", x, {"threshold": threshold}, name=name)


def brelu(x, t_min=0.0, t_max=24.0, name=None):
    return _act("brelu", x, {"t_min": t_min, "t_max": t_max}, name=name)


def pow(x, factor=1.0, name=None):
    return _act("pow", x, {"factor": factor}, name=name)


def stanh(x, scale_a=0.67, scale_b=1.7159, name=None):
    return _act("stanh", x, {"scale_a": scale_a, "scale_b": scale_b}, name=name)


# Auto-generated unary layers (the role of layer_function_generator.py /
# ops.py in the reference — one python wrapper per registered activation op).
_GENERATED_UNARY = [
    "square", "sqrt", "rsqrt", "exp", "log", "log1p", "abs", "ceil", "floor",
    "cos", "sin", "round", "reciprocal", "softplus", "softsign", "logsigmoid",
    "tanh_shrink", "soft_shrink", "hard_shrink", "thresholded_relu", "selu",
    "erf", "sign",
]


def _make_unary_layer(op_type):
    def _layer(x, name=None):
        return _act(op_type, x, name=name)

    _layer.__name__ = op_type
    _layer.__doc__ = "Elementwise %s (auto-generated wrapper over the %s op)." % (op_type, op_type)
    return _layer


for _op_name in _GENERATED_UNARY:
    if _op_name not in globals():
        globals()[_op_name] = _make_unary_layer(_op_name)
__all__ += [n for n in _GENERATED_UNARY if n not in __all__]


def prelu(x, mode="all", param_attr=None, name=None):
    from .. import initializer as init_mod

    helper = LayerHelper("prelu", name=name)
    alpha_shape = [1] if mode == "all" else ([x.shape[1]] if mode == "channel" else list(x.shape[1:]))
    alpha = helper.create_parameter(param_attr, shape=alpha_shape, dtype=x.dtype,
                                    default_initializer=init_mod.Constant(0.25))
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("prelu", inputs={"X": x, "Alpha": alpha}, outputs={"Out": out}, attrs={"mode": mode})
    return out


def maxout(x, groups, name=None):
    return _act("maxout", x, {"groups": groups}, name=name)


def l2_normalize(x, axis, epsilon=1e-12, name=None):
    helper = LayerHelper("l2_normalize", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    norm = helper.create_variable_for_type_inference(x.dtype, stop_gradient=True)
    helper.append_op("norm", inputs={"X": x}, outputs={"Out": out, "Norm": norm},
                     attrs={"axis": axis, "epsilon": epsilon})
    return out


def clip(x, min, max, name=None):
    return _single_op_layer("clip", "clip", x, {"min": min, "max": max}, name=name)


def clip_by_norm(x, max_norm, name=None):
    return _single_op_layer("clip_by_norm", "clip_by_norm", x, {"max_norm": max_norm}, name=name)


def one_hot(input, depth):
    helper = LayerHelper("one_hot")
    out = helper.create_variable_for_type_inference("float32")
    helper.append_op("one_hot", inputs={"X": input}, outputs={"Out": out}, attrs={"depth": depth})
    return out


def topk(input, k, name=None):
    helper = LayerHelper("top_k", name=name)
    values = helper.create_variable_for_type_inference(input.dtype)
    indices = helper.create_variable_for_type_inference("int64", stop_gradient=True)
    helper.append_op("top_k", inputs={"X": input}, outputs={"Out": values, "Indices": indices}, attrs={"k": k})
    return values, indices


def argsort(input, axis=-1, name=None):
    helper = LayerHelper("argsort", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    ids = helper.create_variable_for_type_inference("int64", stop_gradient=True)
    helper.append_op("argsort", inputs={"X": input}, outputs={"Out": out, "Indices": ids}, attrs={"axis": axis})
    return out, ids


def argmax(x, axis=0, name=None):
    return _single_op_layer("arg_max", "arg_max", x, {"axis": axis}, dtype="int64", name=name)


def argmin(x, axis=0, name=None):
    return _single_op_layer("arg_min", "arg_min", x, {"axis": axis}, dtype="int64", name=name)


def accuracy(input, label, k=1, correct=None, total=None):
    """Reference: layers/metric_op.py accuracy — top-k then accuracy op."""
    helper = LayerHelper("accuracy")
    values, indices = topk(input, k)
    acc_out = helper.create_variable_for_type_inference("float32")
    correct = correct or helper.create_variable_for_type_inference("int32", stop_gradient=True)
    total = total or helper.create_variable_for_type_inference("int32", stop_gradient=True)
    helper.append_op(
        "accuracy",
        inputs={"Out": values, "Indices": indices, "Label": label},
        outputs={"Accuracy": acc_out, "Correct": correct, "Total": total},
    )
    return acc_out


def auc(input, label, curve="ROC", num_thresholds=4095, topk=1, slide_steps=1):
    """Streaming AUC (reference: layers/metric_op.py auc)."""
    from .. import initializer as init_mod
    from ..core import unique_name

    helper = LayerHelper("auc")
    stat_pos = helper.create_or_get_global_variable(
        [1, num_thresholds + 1], "float32", unique_name.generate("auc_stat_pos"),
        initializer=init_mod.Constant(0.0))
    stat_neg = helper.create_or_get_global_variable(
        [1, num_thresholds + 1], "float32", unique_name.generate("auc_stat_neg"),
        initializer=init_mod.Constant(0.0))
    auc_out = helper.create_variable_for_type_inference("float32")
    helper.append_op(
        "auc",
        inputs={"Predict": input, "Label": label, "StatPos": stat_pos, "StatNeg": stat_neg},
        outputs={"AUC": auc_out, "StatPosOut": stat_pos, "StatNegOut": stat_neg},
        attrs={"curve": curve, "num_thresholds": num_thresholds},
    )
    return auc_out, [stat_pos, stat_neg]


def pad(x, paddings, pad_value=0.0, name=None):
    return _single_op_layer("pad", "pad", x, {"paddings": paddings, "pad_value": pad_value}, name=name)


def pad2d(input, paddings=[0, 0, 0, 0], mode="constant", pad_value=0.0, data_format="NCHW", name=None):
    return _single_op_layer("pad2d", "pad2d", input,
                            {"paddings": list(paddings), "mode": mode, "pad_value": pad_value,
                             "data_format": data_format}, name=name)


def image_resize(input, out_shape=None, scale=None, name=None, resample="BILINEAR",
                 actual_shape=None, align_corners=True, align_mode=1):
    op = "bilinear_interp" if resample.upper() == "BILINEAR" else "nearest_interp"
    # Fluid's interpolation rules (the JAX package's layer drops both
    # attrs, and its op centres at half pixels)
    attrs = {"scale": scale or 0.0, "align_corners": bool(align_corners),
             "align_mode": int(align_mode)}
    if out_shape is not None:
        attrs["out_h"], attrs["out_w"] = int(out_shape[0]), int(out_shape[1])
    helper = LayerHelper(op, name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(op, inputs={"X": input}, outputs={"Out": out}, attrs=attrs)
    return out


def resize_bilinear(input, out_shape=None, scale=None, name=None, **kw):
    return image_resize(input, out_shape, scale, name, "BILINEAR", **kw)


def resize_nearest(input, out_shape=None, scale=None, name=None, **kw):
    return image_resize(input, out_shape, scale, name, "NEAREST", **kw)


def pixel_shuffle(x, upscale_factor):
    helper = LayerHelper("pixel_shuffle")
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("pixel_shuffle", inputs={"X": x}, outputs={"Out": out},
                     attrs={"upscale_factor": upscale_factor})
    return out


def flatten(x, axis=1, name=None):
    helper = LayerHelper("flatten", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("flatten", inputs={"X": x}, outputs={"Out": out}, attrs={"axis": axis})
    return out


def unsqueeze(input, axes, name=None):
    return _single_op_layer("unsqueeze", "unsqueeze", input, {"axes": list(axes)}, name=name)


def squeeze(input, axes, name=None):
    return _single_op_layer("squeeze", "squeeze", input, {"axes": list(axes)}, name=name)


def stack(x, axis=0):
    helper = LayerHelper("stack")
    x = x if isinstance(x, (list, tuple)) else [x]
    out = helper.create_variable_for_type_inference(x[0].dtype)
    helper.append_op("stack", inputs={"X": list(x)}, outputs={"Y": out}, attrs={"axis": axis})
    return out


def unstack(x, axis=0, num=None):
    helper = LayerHelper("unstack")
    num = num or x.shape[axis]
    outs = [helper.create_variable_for_type_inference(x.dtype) for _ in range(num)]
    helper.append_op("unstack", inputs={"X": x}, outputs={"Y": outs}, attrs={"axis": axis, "num": num})
    return outs


def expand(x, expand_times, name=None):
    return _single_op_layer("expand", "expand", x, {"expand_times": list(expand_times)}, name=name)


def gather(input, index):
    helper = LayerHelper("gather")
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("gather", inputs={"X": input, "Index": index}, outputs={"Out": out})
    return out


def gather_nd(input, index, name=None):
    helper = LayerHelper("gather_nd", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("gather_nd", inputs={"X": input, "Index": index}, outputs={"Out": out})
    return out


def scatter(input, index, updates, overwrite=True, name=None):
    helper = LayerHelper("scatter", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("scatter", inputs={"X": input, "Ids": index, "Updates": updates},
                     outputs={"Out": out}, attrs={"overwrite": overwrite})
    return out


def slice(input, axes, starts, ends):
    helper = LayerHelper("slice")
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("slice", inputs={"Input": input}, outputs={"Out": out},
                     attrs={"axes": list(axes), "starts": list(starts), "ends": list(ends)})
    return out


def strided_slice(input, axes, starts, ends, strides):
    helper = LayerHelper("strided_slice")
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("strided_slice", inputs={"Input": input}, outputs={"Out": out},
                     attrs={"axes": list(axes), "starts": list(starts), "ends": list(ends),
                            "strides": list(strides)})
    return out


def shape(input):
    helper = LayerHelper("shape")
    out = helper.create_variable_for_type_inference("int32", stop_gradient=True)
    helper.append_op("shape", inputs={"Input": input}, outputs={"Out": out})
    return out


def where(condition, x=None, y=None):
    if x is None or y is None:
        # Fluid's one-arg where(condition) returns a data-dependent-length
        # index tensor — impossible under XLA's static shapes. Use
        # layers.argsort/topk over a mask, or the ternary form.
        raise NotImplementedError(
            "where(condition) with data-dependent output length is not "
            "supported under XLA static shapes; use where(cond, x, y)."
        )
    helper = LayerHelper("where")
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("where", inputs={"Condition": condition, "X": x, "Y": y}, outputs={"Out": out})
    return out


def cos_sim(X, Y):
    helper = LayerHelper("cos_sim")
    out = helper.create_variable_for_type_inference(X.dtype)
    xnorm = helper.create_variable_for_type_inference(X.dtype, stop_gradient=True)
    ynorm = helper.create_variable_for_type_inference(X.dtype, stop_gradient=True)
    helper.append_op("cos_sim", inputs={"X": X, "Y": Y},
                     outputs={"Out": out, "XNorm": xnorm, "YNorm": ynorm})
    return out


def dot(x, y, name=None):
    helper = LayerHelper("dot", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("dot", inputs={"X": x, "Y": y}, outputs={"Out": out})
    return out


def _elementwise_layer(op_type, x, y, axis=-1, act=None, name=None):
    helper = LayerHelper(op_type, act=act, name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(op_type, inputs={"X": x, "Y": y}, outputs={"Out": out}, attrs={"axis": axis})
    return helper.append_activation(out)


def elementwise_add(x, y, axis=-1, act=None, name=None):
    return _elementwise_layer("elementwise_add", x, y, axis, act, name)


def elementwise_sub(x, y, axis=-1, act=None, name=None):
    return _elementwise_layer("elementwise_sub", x, y, axis, act, name)


def elementwise_mul(x, y, axis=-1, act=None, name=None):
    return _elementwise_layer("elementwise_mul", x, y, axis, act, name)


def elementwise_div(x, y, axis=-1, act=None, name=None):
    return _elementwise_layer("elementwise_div", x, y, axis, act, name)


def elementwise_max(x, y, axis=-1, act=None, name=None):
    return _elementwise_layer("elementwise_max", x, y, axis, act, name)


def elementwise_min(x, y, axis=-1, act=None, name=None):
    return _elementwise_layer("elementwise_min", x, y, axis, act, name)


def elementwise_pow(x, y, axis=-1, act=None, name=None):
    return _elementwise_layer("elementwise_pow", x, y, axis, act, name)


def elementwise_mod(x, y, axis=-1, act=None, name=None):
    return _elementwise_layer("elementwise_mod", x, y, axis, act, name)


def uniform_random(shape, dtype="float32", min=-1.0, max=1.0, seed=0):
    helper = LayerHelper("uniform_random")
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op("uniform_random", outputs={"Out": out},
                     attrs={"shape": list(shape), "dtype": dtype, "min": min, "max": max, "seed": seed})
    return out


def gaussian_random(shape, mean=0.0, std=1.0, seed=0, dtype="float32"):
    helper = LayerHelper("gaussian_random")
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op("gaussian_random", outputs={"Out": out},
                     attrs={"shape": list(shape), "dtype": dtype, "mean": mean, "std": std, "seed": seed})
    return out


def uniform_random_batch_size_like(input, shape, dtype="float32", input_dim_idx=0,
                                   output_dim_idx=0, min=-1.0, max=1.0, seed=0):
    helper = LayerHelper("uniform_random_batch_size_like")
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op("uniform_random_batch_size_like", inputs={"Input": input}, outputs={"Out": out},
                     attrs={"shape": list(shape), "dtype": dtype, "input_dim_idx": input_dim_idx,
                            "output_dim_idx": output_dim_idx, "min": min, "max": max, "seed": seed})
    return out


def gaussian_random_batch_size_like(input, shape, input_dim_idx=0, output_dim_idx=0,
                                    mean=0.0, std=1.0, seed=0, dtype="float32"):
    helper = LayerHelper("gaussian_random_batch_size_like")
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op("gaussian_random_batch_size_like", inputs={"Input": input}, outputs={"Out": out},
                     attrs={"shape": list(shape), "dtype": dtype, "input_dim_idx": input_dim_idx,
                            "output_dim_idx": output_dim_idx, "mean": mean, "std": std, "seed": seed})
    return out


def bilinear_tensor_product(x, y, size, act=None, name=None, param_attr=None, bias_attr=None):
    helper = LayerHelper("bilinear_tensor_product", act=act, name=name)
    w = helper.create_parameter(param_attr, shape=[size, x.shape[1], y.shape[1]], dtype=x.dtype)
    out = helper.create_variable_for_type_inference(x.dtype)
    inputs = {"X": x, "Y": y, "Weight": w}
    if bias_attr is not False:
        bias = helper.create_parameter(ParamAttr.to_attr(bias_attr), shape=[1, size], dtype=x.dtype, is_bias=True)
        inputs["Bias"] = bias
    helper.append_op("bilinear_tensor_product", inputs=inputs, outputs={"Out": out})
    return helper.append_activation(out)


def split(input, num_or_sections, dim=-1, name=None):
    helper = LayerHelper("split", name=name)
    dim = dim if dim >= 0 else dim + len(input.shape)
    if isinstance(num_or_sections, int):
        num = num_or_sections
        sections = []
    else:
        num = 0
        sections = list(num_or_sections)
    n_out = num if num else len(sections)
    outs = [helper.create_variable_for_type_inference(input.dtype) for _ in range(n_out)]
    helper.append_op("split", inputs={"X": input}, outputs={"Out": outs},
                     attrs={"num": num, "sections": sections, "axis": dim})
    return outs


def multiplex(inputs, index):
    helper = LayerHelper("multiplex")
    out = helper.create_variable_for_type_inference(inputs[0].dtype)
    helper.append_op("multiplex", inputs={"X": list(inputs), "Ids": index}, outputs={"Out": out})
    return out


def label_smooth(label, prior_dist=None, epsilon=0.1, dtype="float32", name=None):
    helper = LayerHelper("label_smooth", name=name)
    out = helper.create_variable_for_type_inference(dtype)
    inputs = {"X": label}
    if prior_dist is not None:
        inputs["PriorDist"] = prior_dist
    helper.append_op("label_smooth", inputs=inputs, outputs={"Out": out},
                     attrs={"epsilon": float(epsilon)})
    return out


def mean_iou(input, label, num_classes):
    helper = LayerHelper("mean_iou")
    out = helper.create_variable_for_type_inference("float32")
    helper.append_op("mean_iou", inputs={"Predictions": input, "Labels": label},
                     outputs={"OutMeanIou": out}, attrs={"num_classes": num_classes})
    return out


def space_to_depth(x, blocksize, name=None):
    return _single_op_layer("space_to_depth", "space_to_depth", x, {"blocksize": blocksize}, name=name)


def shuffle_channel(x, group, name=None):
    return _single_op_layer("shuffle_channel", "shuffle_channel", x, {"group": group}, name=name)


def autoincreased_step_counter(counter_name=None, begin=1, step=1):
    """Global step counter (reference: layers/nn.py
    autoincreased_step_counter): an int64 [1] persistable starting at
    ``begin - 1``. As in Fluid, the ``increment`` is appended only when the
    counter is created, so every schedule built on one counter reads the
    same step and the counter advances once a step. (The JAX package
    appends one on every call: two schedules on one counter advance it
    twice a step.)"""
    from .. import initializer as init_mod

    helper = LayerHelper("global_step_counter")
    name = counter_name or "@STEP_COUNTER@"
    is_new = not helper.main_program.global_block.has_var(name)
    counter = helper.create_or_get_global_variable(
        [1], "int64", name, initializer=init_mod.Constant(begin - 1))
    if is_new:
        helper.append_op("increment", inputs={"X": counter},
                         outputs={"Out": counter},
                         attrs={"step": float(step)})
    counter.stop_gradient = True
    return counter


def _pair(x):
    return tuple(x) if isinstance(x, (list, tuple)) else (x, x)


def _triple(x):
    return tuple(x) if isinstance(x, (list, tuple)) else (x, x, x)


# -- structured-loss tail (ops/loss_ops.py) -----------------------------------


def warpctc(input, label, blank=0, norm_by_times=False,
            input_length=None, label_length=None):
    """CTC loss (reference: layers/nn.py warpctc → operators/warpctc_op.cc).
    input [B, T, C] raw logits + input_length [B]; label [B, L] +
    label_length [B] — padded+Length replacing the reference's LoD packing."""
    helper = LayerHelper("warpctc")
    loss = helper.create_variable_for_type_inference(input.dtype)
    inputs = {"Logits": input, "Label": label}
    if input_length is not None:
        inputs["LogitsLength"] = input_length
    if label_length is not None:
        inputs["LabelLength"] = label_length
    helper.append_op("warpctc", inputs=inputs, outputs={"Loss": loss},
                     attrs={"blank": int(blank), "norm_by_times": norm_by_times})
    return loss


def ctc_greedy_decoder(input, blank, input_length=None, name=None):
    """Greedy CTC decode (reference: layers/nn.py ctc_greedy_decoder =
    argmax + ctc_align). input [B, T, C] probs/logits → (decoded [B, T]
    padded -1, length [B])."""
    helper = LayerHelper("ctc_greedy_decoder", name=name)
    ids = argmax(input, axis=-1)
    out = helper.create_variable_for_type_inference("int32")
    out_len = helper.create_variable_for_type_inference("int32")
    inputs = {"Input": ids}
    if input_length is not None:
        inputs["Length"] = input_length
    helper.append_op("ctc_align", inputs=inputs,
                     outputs={"Output": out, "OutputLength": out_len},
                     attrs={"blank": int(blank)})
    return out, out_len


def linear_chain_crf(input, label, param_attr=None, length=None):
    """reference: layers/nn.py linear_chain_crf. input [B, T, D] emissions +
    length [B]; creates the [D+2, D] transition parameter."""
    helper = LayerHelper("linear_chain_crf", param_attr=param_attr)
    size = int(input.shape[-1])
    transition = helper.create_parameter(
        attr=helper.kwargs.get("param_attr"), shape=[size + 2, size], dtype=input.dtype)
    ll = helper.create_variable_for_type_inference(input.dtype)
    alpha = helper.create_variable_for_type_inference(input.dtype)
    e_exps = helper.create_variable_for_type_inference(input.dtype)
    t_exps = helper.create_variable_for_type_inference(input.dtype)
    inputs = {"Emission": input, "Transition": transition, "Label": label}
    if length is not None:
        inputs["Length"] = length
    helper.append_op("linear_chain_crf", inputs=inputs,
                     outputs={"LogLikelihood": ll, "Alpha": alpha,
                              "EmissionExps": e_exps, "TransitionExps": t_exps})
    return ll


def crf_decoding(input, param_attr, label=None, length=None):
    """Viterbi decode with the trained transition param (reference:
    layers/nn.py crf_decoding)."""
    helper = LayerHelper("crf_decoding")
    transition = helper.main_program.global_block.var(param_attr.name)
    path = helper.create_variable_for_type_inference("int64")
    inputs = {"Emission": input, "Transition": transition, "Label": label}
    if length is not None:
        inputs["Length"] = length
    helper.append_op("crf_decoding", inputs=inputs,
                     outputs={"ViterbiPath": path})
    return path


def nce(input, label, num_total_classes, sample_weight=None, param_attr=None,
        bias_attr=None, num_neg_samples=None, name=None, sampler="uniform",
        custom_dist=None, seed=0, is_sparse=False):
    """reference: layers/nn.py nce → operators/nce_op.cc."""
    helper = LayerHelper("nce", param_attr=param_attr, bias_attr=bias_attr, name=name)
    dim = int(input.shape[-1])
    w = helper.create_parameter(attr=helper.kwargs.get("param_attr"),
                                shape=[num_total_classes, dim], dtype=input.dtype)
    inputs = {"Input": input, "Weight": w, "Label": label}
    if helper.kwargs.get("bias_attr") is not False:
        b = helper.create_parameter(attr=helper.kwargs.get("bias_attr"),
                                    shape=[num_total_classes], dtype=input.dtype,
                                    is_bias=True)
        inputs["Bias"] = b
    cost = helper.create_variable_for_type_inference(input.dtype)
    s_logits = helper.create_variable_for_type_inference(input.dtype)
    s_labels = helper.create_variable_for_type_inference("int32")
    helper.append_op(
        "nce", inputs=inputs,
        outputs={"Cost": cost, "SampleLogits": s_logits, "SampleLabels": s_labels},
        attrs={"num_total_classes": int(num_total_classes),
               "num_neg_samples": int(num_neg_samples or 10), "seed": seed})
    return cost


def hsigmoid(input, label, num_classes, param_attr=None, bias_attr=None,
             name=None, path_table=None, path_code=None, is_custom=False,
             is_sparse=False):
    """reference: layers/nn.py hsigmoid → hierarchical_sigmoid_op.cc
    (default complete binary tree; custom trees via path_table unsupported —
    raise rather than silently mis-train)."""
    if is_custom or path_table is not None or path_code is not None:
        raise NotImplementedError("custom-tree hsigmoid (path_table/path_code) "
                                  "is not implemented")
    helper = LayerHelper("hierarchical_sigmoid", param_attr=param_attr,
                         bias_attr=bias_attr, name=name)
    dim = int(input.shape[-1])
    w = helper.create_parameter(attr=helper.kwargs.get("param_attr"),
                                shape=[num_classes - 1, dim], dtype=input.dtype)
    inputs = {"X": input, "W": w, "Label": label}
    if helper.kwargs.get("bias_attr") is not False:
        b = helper.create_parameter(attr=helper.kwargs.get("bias_attr"),
                                    shape=[num_classes - 1], dtype=input.dtype,
                                    is_bias=True)
        inputs["Bias"] = b
    out = helper.create_variable_for_type_inference(input.dtype)
    pre_out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("hierarchical_sigmoid", inputs=inputs,
                     outputs={"Out": out, "PreOut": pre_out},
                     attrs={"num_classes": int(num_classes)})
    return out


def sample_logits(logits, label, num_samples, uniq=True,
                  remove_accidental_hits=True, use_customized_samples=False,
                  customized_samples=None, customized_probabilities=None,
                  seed=0):
    """Sampled-softmax helper (reference: operators/sample_logits_op.cc)."""
    helper = LayerHelper("sample_logits")
    samples = helper.create_variable_for_type_inference("int32")
    probs = helper.create_variable_for_type_inference(logits.dtype)
    s_logits = helper.create_variable_for_type_inference(logits.dtype)
    s_labels = helper.create_variable_for_type_inference("int64")
    inputs = {"Logits": logits, "Labels": label}
    if use_customized_samples:
        inputs["CustomizedSamples"] = customized_samples
        inputs["CustomizedProbabilities"] = customized_probabilities
    helper.append_op(
        "sample_logits", inputs=inputs,
        outputs={"Samples": samples, "Probabilities": probs,
                 "SampledLogits": s_logits, "SampledLabels": s_labels},
        attrs={"num_samples": int(num_samples), "uniq": uniq,
               "remove_accidental_hits": remove_accidental_hits, "seed": seed})
    return s_logits, s_labels


__all__ += ["warpctc", "ctc_greedy_decoder", "linear_chain_crf", "crf_decoding",
            "nce", "hsigmoid", "sample_logits"]


# -- metrics / vision tail / host ops -----------------------------------------


def edit_distance(input, label, normalized=True, ignored_tokens=None,
                  input_length=None, label_length=None):
    """Levenshtein distance (reference: layers/nn.py edit_distance).
    input [B, Lh] int + input_length, label [B, Lr] + label_length."""
    helper = LayerHelper("edit_distance")
    out = helper.create_variable_for_type_inference("float32")
    seq_num = helper.create_variable_for_type_inference("int64")
    inputs = {"Hyps": input, "Refs": label}
    if input_length is not None:
        inputs["HypsLength"] = input_length
    if label_length is not None:
        inputs["RefsLength"] = label_length
    helper.append_op("edit_distance", inputs=inputs,
                     outputs={"Out": out, "SequenceNum": seq_num},
                     attrs={"normalized": normalized})
    return out, seq_num


def chunk_eval(input, label, chunk_scheme, num_chunk_types,
               excluded_chunk_types=None, seq_length=None):
    """Chunk detection P/R/F1 (reference: layers/nn.py chunk_eval)."""
    helper = LayerHelper("chunk_eval")
    precision = helper.create_variable_for_type_inference("float32")
    recall = helper.create_variable_for_type_inference("float32")
    f1 = helper.create_variable_for_type_inference("float32")
    n_inf = helper.create_variable_for_type_inference("int64")
    n_lab = helper.create_variable_for_type_inference("int64")
    n_cor = helper.create_variable_for_type_inference("int64")
    inputs = {"Inference": input, "Label": label}
    if seq_length is not None:
        inputs["Length"] = seq_length
    helper.append_op(
        "chunk_eval", inputs=inputs,
        outputs={"Precision": precision, "Recall": recall, "F1-Score": f1,
                 "NumInferChunks": n_inf, "NumLabelChunks": n_lab,
                 "NumCorrectChunks": n_cor},
        attrs={"num_chunk_types": num_chunk_types, "chunk_scheme": chunk_scheme,
               "excluded_chunk_types": excluded_chunk_types or []})
    return precision, recall, f1, n_inf, n_lab, n_cor


def grid_sampler(x, grid, name=None):
    """Bilinear grid sampling (reference: operators/grid_sampler_op.cc)."""
    helper = LayerHelper("grid_sampler", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("grid_sampler", inputs={"X": x, "Grid": grid},
                     outputs={"Output": out})
    return out


def spp(input, pyramid_height=1, pool_type="max", name=None):
    """Spatial pyramid pooling (reference: operators/spp_op.cc)."""
    helper = LayerHelper("spp", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("spp", inputs={"X": input}, outputs={"Out": out},
                     attrs={"pyramid_height": pyramid_height,
                            "pooling_type": pool_type})
    return out


def unpool(x, indices, ksize, strides=None, unpooled_size=None, name=None):
    """Max unpooling via recorded indices (reference: operators/unpool_op.cc)."""
    helper = LayerHelper("unpool", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("unpool", inputs={"X": x, "Indices": indices},
                     outputs={"Out": out},
                     attrs={"ksize": list(ksize),
                            "strides": list(strides or ksize),
                            "unpooled_size": list(unpooled_size) if unpooled_size else None})
    return out


def max_pool2d_with_index(x, ksize, strides=None, paddings=None, name=None):
    helper = LayerHelper("max_pool2d_with_index", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    mask = helper.create_variable_for_type_inference("int32")
    helper.append_op("max_pool2d_with_index", inputs={"X": x},
                     outputs={"Out": out, "Mask": mask},
                     attrs={"ksize": list(ksize), "strides": list(strides or ksize),
                            "paddings": list(paddings or [0, 0])})
    return out, mask


def psroi_pool(input, rois, output_channels, spatial_scale, pooled_height,
               pooled_width, batch_id=None, name=None):
    helper = LayerHelper("psroi_pool", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("psroi_pool",
                     inputs={"X": input, "ROIs": rois, "BatchId": batch_id},
                     outputs={"Out": out},
                     attrs={"output_channels": output_channels,
                            "spatial_scale": float(spatial_scale),
                            "pooled_height": pooled_height,
                            "pooled_width": pooled_width})
    return out


def Print(input, first_n=-1, message=None, summarize=-1, print_tensor_name=True,
          print_tensor_type=True, print_tensor_shape=True, print_tensor_lod=True,
          print_phase="both"):
    """Tensor tap-out (reference: layers/control_flow.py Print → print_op.cc)."""
    helper = LayerHelper("print")
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("print", inputs={"In": input}, outputs={"Out": out},
                     attrs={"message": message or "", "first_n": first_n,
                            "summarize": summarize})
    return out


def py_func(func, x, out, backward_func=None, skip_vars_in_backward_input=None):
    """Host-python op (reference: layers/nn.py py_func → py_func_op.cc).
    ``out`` must be pre-created variables with known shape/dtype."""
    from ..ops.misc_ops import register_py_func

    helper = LayerHelper("py_func")
    xs = x if isinstance(x, (list, tuple)) else [x]
    outs = out if isinstance(out, (list, tuple)) else [out]
    fwd_id = register_py_func(func)
    bwd_id = register_py_func(backward_func) if backward_func else -1
    helper.append_op("py_func", inputs={"X": list(xs)}, outputs={"Out": list(outs)},
                     attrs={"forward_callable_id": fwd_id,
                            "backward_callable_id": bwd_id})
    return out


__all__ += ["edit_distance", "chunk_eval", "grid_sampler", "spp", "unpool",
            "max_pool2d_with_index", "psroi_pool", "Print", "py_func"]


# -- round-3 layer-surface parity sweep (VERDICT item 4) ----------------------


def adaptive_pool2d(input, pool_size, pool_type="max", require_index=False,
                    name=None):
    """Adaptive pooling to a fixed output size (reference: nn.py
    adaptive_pool2d → pool2d op with adaptive=True)."""
    if require_index:
        raise NotImplementedError(
            "adaptive_pool2d(require_index=True): argmax-index output is not "
            "implemented; use max_pool2d_with_index for indices")
    helper = LayerHelper("pool2d", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        "pool2d", inputs={"X": input}, outputs={"Out": out},
        attrs={"pooling_type": pool_type, "ksize": list(_pair(pool_size)),
               "adaptive": True})
    return out


def adaptive_pool3d(input, pool_size, pool_type="max", require_index=False,
                    name=None):
    """3-D adaptive pooling (reference: nn.py adaptive_pool3d)."""
    if require_index:
        raise NotImplementedError(
            "adaptive_pool3d(require_index=True): argmax-index output is not "
            "implemented; use max_pool2d_with_index for indices")
    helper = LayerHelper("pool3d", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        "pool3d", inputs={"X": input}, outputs={"Out": out},
        attrs={"pooling_type": pool_type, "ksize": list(_triple(pool_size)),
               "adaptive": True})
    return out


def conv3d_transpose(input, num_filters, output_size=None, filter_size=None,
                     padding=0, stride=1, dilation=1, groups=1,
                     param_attr=None, bias_attr=None, use_cudnn=True,
                     act=None, name=None):
    """3-D transposed convolution (reference: nn.py conv3d_transpose)."""
    helper = LayerHelper("conv3d_transpose", bias_attr=bias_attr, act=act,
                         name=name)
    num_channels = input.shape[1]
    stride = _triple(stride)
    padding = _triple(padding)
    dilation = _triple(dilation)
    if filter_size is None:
        if output_size is None:
            raise ValueError("filter_size or output_size required")
        output_size = _triple(output_size)
        filter_size = [
            (output_size[i] - (input.shape[2 + i] - 1) * stride[i]
             + 2 * padding[i] - 1) // dilation[i] + 1
            for i in range(3)
        ]
    else:
        filter_size = list(_triple(filter_size))
    filter_shape = [num_channels, num_filters // (groups or 1)] + filter_size
    w = helper.create_parameter(param_attr, shape=filter_shape,
                                dtype=input.dtype)
    pre_bias = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        "conv3d_transpose",
        inputs={"Input": input, "Filter": w},
        outputs={"Output": pre_bias},
        attrs={"strides": list(stride), "paddings": list(padding),
               "dilations": list(dilation), "groups": groups or 1},
    )
    if bias_attr is False:
        pre_act = pre_bias
    else:
        bias = helper.create_parameter(ParamAttr.to_attr(bias_attr),
                                       shape=[num_filters],
                                       dtype=input.dtype, is_bias=True)
        pre_act = helper.create_variable_for_type_inference(input.dtype)
        helper.append_op("elementwise_add", inputs={"X": pre_bias, "Y": bias},
                         outputs={"Out": pre_act}, attrs={"axis": 1})
    return helper.append_activation(pre_act)


def spectral_norm(weight, dim=0, power_iters=1, eps=1e-12, name=None):
    """Spectral weight normalization (reference: nn.py spectral_norm,
    operators/spectral_norm_op.cc). The power-iteration vectors U/V live as
    persistent non-trainable parameters; the op writes their updated values
    back (UOut/VOut wired onto the same vars), so the iteration state
    advances across steps like the reference's in-place buffers."""
    from .. import initializer as init_mod

    helper = LayerHelper("spectral_norm", name=name)
    h = weight.shape[dim]
    w = 1
    for i, s in enumerate(weight.shape):
        if i != dim:
            w *= s
    u = helper.create_parameter(
        ParamAttr(trainable=False, initializer=init_mod.Normal(0.0, 1.0)),
        shape=[h], dtype=weight.dtype)
    v = helper.create_parameter(
        ParamAttr(trainable=False, initializer=init_mod.Normal(0.0, 1.0)),
        shape=[w], dtype=weight.dtype)
    out = helper.create_variable_for_type_inference(weight.dtype)
    helper.append_op(
        "spectral_norm",
        inputs={"Weight": weight, "U": u, "V": v},
        outputs={"Out": out, "UOut": u, "VOut": v},
        attrs={"dim": dim, "power_iters": power_iters, "eps": eps},
    )
    return out


def dice_loss(input, label, epsilon=0.00001):
    """Dice loss for segmentation (reference: nn.py dice_loss — a pure
    layer composition, mirrored here)."""
    label = one_hot(label, depth=input.shape[-1])
    reduce_dim = list(range(1, len(input.shape)))
    inse = reduce_sum(elementwise_mul(input, label), dim=reduce_dim)
    denom = reduce_sum(input, dim=reduce_dim) + reduce_sum(label, dim=reduce_dim)
    dice_score = 1 - inse * 2 / (denom + epsilon)
    return reduce_mean(dice_score)


def image_resize_short(input, out_short_len, resample="BILINEAR"):
    """Resize so the short image edge equals ``out_short_len`` (reference:
    nn.py image_resize_short — static-shape composition over image_resize)."""
    in_shape = input.shape
    if len(in_shape) != 4:
        raise ValueError(
            "The rank of input must be 4 (num_batches, channels, in_h, in_w).")
    hw = list(in_shape[2:4])
    short_idx = hw.index(min(hw))
    long_idx = 1 - short_idx
    out_shape = list(hw)
    out_shape[short_idx] = out_short_len
    out_shape[long_idx] = int(
        float(out_shape[long_idx]) * (float(out_short_len) / float(hw[short_idx]))
        + 0.5)
    return image_resize(input=input, out_shape=out_shape, resample=resample)


def sampled_softmax_with_cross_entropy(logits, label, num_samples, num_true=1,
                                       remove_accidental_hits=True,
                                       use_customized_samples=False,
                                       customized_samples=None,
                                       customized_probabilities=None, seed=0):
    """Sampled-softmax cross entropy (reference: nn.py
    sampled_softmax_with_cross_entropy — composes the sample_logits op with
    soft-label softmax_with_cross_entropy)."""
    if num_true != 1:
        raise NotImplementedError(
            "sampled_softmax_with_cross_entropy: num_true>1 (the reference's "
            "one_hot(depth=num_samples+1) construction is only consistent "
            "for a single true label)")
    helper = LayerHelper("sample_logits")
    samples = helper.create_variable_for_type_inference("int64",
                                                        stop_gradient=True)
    probabilities = helper.create_variable_for_type_inference(logits.dtype,
                                                              stop_gradient=True)
    sampled_logits = helper.create_variable_for_type_inference(logits.dtype)
    sampled_label = helper.create_variable_for_type_inference("int64",
                                                              stop_gradient=True)
    inputs = {"Logits": logits, "Labels": label}
    if customized_samples is not None:
        inputs["CustomizedSamples"] = customized_samples
    if customized_probabilities is not None:
        inputs["CustomizedProbabilities"] = customized_probabilities
    helper.append_op(
        "sample_logits",
        inputs=inputs,
        outputs={"Samples": samples, "Probabilities": probabilities,
                 "SampledLogits": sampled_logits,
                 "SampledLabels": sampled_label},
        attrs={"use_customized_samples": use_customized_samples, "uniq": True,
               "remove_accidental_hits": remove_accidental_hits,
               "num_samples": num_samples, "seed": seed},
    )
    soft = one_hot(sampled_label, depth=num_true + num_samples)
    loss = softmax_with_cross_entropy(sampled_logits, soft, soft_label=True)
    return loss / num_true


def hash(input, hash_size, num_hash=1, name=None):
    """Row-wise integer hashing into [0, hash_size) (reference: nn.py hash,
    operators/hash_op.cc)."""
    helper = LayerHelper("hash", name=name)
    out = helper.create_variable_for_type_inference("int64", stop_gradient=True)
    helper.append_op("hash", inputs={"X": input}, outputs={"Out": out},
                     attrs={"num_hash": num_hash, "mod_by": hash_size})
    return out


def merge_selected_rows(x, name=None):
    """Sum duplicate rows of a SelectedRows value (reference: nn.py
    merge_selected_rows)."""
    helper = LayerHelper("merge_selected_rows", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("merge_selected_rows", inputs={"X": x},
                     outputs={"Out": out})
    return out


def get_tensor_from_selected_rows(x, name=None):
    """Densify a SelectedRows' value block (reference: nn.py
    get_tensor_from_selected_rows)."""
    helper = LayerHelper("get_tensor_from_selected_rows", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("get_tensor_from_selected_rows", inputs={"X": x},
                     outputs={"Out": out})
    return out


def tree_conv(nodes_vector, edge_set, output_size, num_filters=1, max_depth=2,
              act="tanh", param_attr=None, bias_attr=None, name=None):
    """Tree-based convolution (reference: nn.py tree_conv, TBCNN)."""
    helper = LayerHelper("tree_conv", bias_attr=bias_attr, act=act, name=name)
    feature_size = nodes_vector.shape[2]
    w = helper.create_parameter(
        param_attr, shape=[feature_size, 3, output_size, num_filters],
        dtype=nodes_vector.dtype)
    pre_bias = helper.create_variable_for_type_inference(nodes_vector.dtype)
    helper.append_op(
        "tree_conv",
        inputs={"NodesVector": nodes_vector, "EdgeSet": edge_set, "Filter": w},
        outputs={"Out": pre_bias},
        attrs={"max_depth": max_depth},
    )
    if bias_attr is False:
        pre_act = pre_bias
    else:
        bias = helper.create_parameter(
            ParamAttr.to_attr(bias_attr), shape=[num_filters],
            dtype=nodes_vector.dtype, is_bias=True)
        pre_act = helper.create_variable_for_type_inference(nodes_vector.dtype)
        helper.append_op("elementwise_add", inputs={"X": pre_bias, "Y": bias},
                         outputs={"Out": pre_act}, attrs={"axis": -1})
    return helper.append_activation(pre_act)


__all__ += ["adaptive_pool2d", "adaptive_pool3d", "conv3d_transpose",
            "spectral_norm", "dice_loss", "image_resize_short",
            "sampled_softmax_with_cross_entropy", "hash",
            "merge_selected_rows", "get_tensor_from_selected_rows",
            "tree_conv"]
