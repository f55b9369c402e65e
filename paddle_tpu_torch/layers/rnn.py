# ported from paddle_tpu/layers/rnn.py
"""Recurrent layers: dynamic_lstm / dynamic_lstmp / dynamic_gru / lstm /
lstm_unit / gru_unit.

Reference API surface: ``python/paddle/fluid/layers/nn.py`` (dynamic_lstm,
dynamic_lstmp, dynamic_gru, gru_unit, lstm_unit, lstm). Fluid consumes
LoD-packed sequences; here, as in the JAX package, the contract is a padded
batch-major tensor ``[B, T, ...]`` plus an optional per-row ``length``
Variable. The ops loop over the padded T, one ``addmm`` and the gate
arithmetic a step — see ops/rnn_ops.py.

As in the reference, dynamic_lstm/dynamic_gru expect the INPUT projection to
be done by a preceding ``fc`` (input size 4*hidden / 3*hidden): that keeps
the big [D, 4H] matmul outside the loop, one product over all timesteps.
Parameters are created under the JAX package's names and in its order,
so weights cross between the packages by name.
"""

from __future__ import annotations

from .layer_helper import LayerHelper, ParamAttr

__all__ = ["dynamic_lstm", "dynamic_lstmp", "dynamic_gru", "lstm",
           "lstm_unit", "gru_unit"]


def dynamic_lstm(input, size, length=None, h_0=None, c_0=None,
                 param_attr=None, bias_attr=None, use_peepholes=True,
                 is_reverse=False, gate_activation="sigmoid",
                 cell_activation="tanh", candidate_activation="tanh",
                 dtype="float32", name=None):
    """reference: layers/nn.py dynamic_lstm (operators/lstm_op.cc).

    input: [B, T, 4*hidden] (x-projection from an fc); returns
    (hidden [B,T,H], cell [B,T,H]). ``size`` is 4*hidden for Fluid parity.
    """
    assert size % 4 == 0, "size must be 4*hidden"
    hidden = size // 4
    helper = LayerHelper("dynamic_lstm", name=name)
    weight = helper.create_parameter(param_attr, shape=[hidden, 4 * hidden],
                                     dtype=dtype)
    bias_size = [1, 7 * hidden if use_peepholes else 4 * hidden]
    bias = helper.create_parameter(bias_attr, shape=bias_size, dtype=dtype,
                                   is_bias=True)
    h = helper.create_variable_for_type_inference(dtype)
    c = helper.create_variable_for_type_inference(dtype)
    inputs = {"Input": input, "Weight": weight, "Bias": bias}
    if length is not None:
        inputs["Length"] = length
    if h_0 is not None:
        inputs["H0"] = h_0
    if c_0 is not None:
        inputs["C0"] = c_0
    helper.append_op(
        "dynamic_lstm", inputs=inputs, outputs={"Hidden": h, "Cell": c},
        attrs={"use_peepholes": use_peepholes, "is_reverse": is_reverse,
               "gate_activation": gate_activation,
               "cell_activation": cell_activation,
               "candidate_activation": candidate_activation})
    return h, c


def dynamic_lstmp(input, size, proj_size, length=None, param_attr=None,
                  bias_attr=None, is_reverse=False, gate_activation="sigmoid",
                  cell_activation="tanh", candidate_activation="tanh",
                  proj_activation="tanh", dtype="float32", name=None):
    """reference: layers/nn.py dynamic_lstmp (operators/lstmp_op.cc).
    Returns (projection [B,T,P], cell [B,T,H])."""
    assert size % 4 == 0
    hidden = size // 4
    helper = LayerHelper("dynamic_lstmp", name=name)
    weight = helper.create_parameter(param_attr, shape=[proj_size, 4 * hidden],
                                     dtype=dtype)
    proj_weight = helper.create_parameter(
        ParamAttr(name=(name or helper.name) + "_proj_w"),
        shape=[hidden, proj_size], dtype=dtype)
    bias = helper.create_parameter(bias_attr, shape=[1, 4 * hidden],
                                   dtype=dtype, is_bias=True)
    proj = helper.create_variable_for_type_inference(dtype)
    cell = helper.create_variable_for_type_inference(dtype)
    inputs = {"Input": input, "Weight": weight, "ProjWeight": proj_weight,
              "Bias": bias}
    if length is not None:
        inputs["Length"] = length
    helper.append_op(
        "dynamic_lstmp", inputs=inputs,
        outputs={"Projection": proj, "Cell": cell},
        attrs={"is_reverse": is_reverse, "gate_activation": gate_activation,
               "cell_activation": cell_activation,
               "candidate_activation": candidate_activation,
               "proj_activation": proj_activation})
    return proj, cell


def dynamic_gru(input, size, length=None, h_0=None, param_attr=None,
                bias_attr=None, is_reverse=False, gate_activation="sigmoid",
                candidate_activation="tanh", origin_mode=False,
                dtype="float32", name=None):
    """reference: layers/nn.py dynamic_gru (operators/gru_op.cc).

    input: [B, T, 3*size]; returns hidden [B, T, size].
    """
    helper = LayerHelper("dynamic_gru", name=name)
    weight = helper.create_parameter(param_attr, shape=[size, 3 * size],
                                     dtype=dtype)
    bias = helper.create_parameter(bias_attr, shape=[1, 3 * size], dtype=dtype,
                                   is_bias=True)
    h = helper.create_variable_for_type_inference(dtype)
    inputs = {"Input": input, "Weight": weight, "Bias": bias}
    if length is not None:
        inputs["Length"] = length
    if h_0 is not None:
        inputs["H0"] = h_0
    helper.append_op(
        "dynamic_gru", inputs=inputs, outputs={"Hidden": h},
        attrs={"is_reverse": is_reverse, "origin_mode": origin_mode,
               "gate_activation": gate_activation,
               "candidate_activation": candidate_activation})
    return h


def lstm(input, init_h=None, init_c=None, max_len=None, hidden_size=None,
         num_layers=1, length=None, dropout_prob=0.0, is_bidirec=False,
         dtype="float32", name=None):
    """Stacked (optionally bidirectional) LSTM over raw features — the
    cudnn_lstm analog (reference: layers/nn.py lstm,
    operators/cudnn_lstm_op.cu.cc). input: [B, T, D].

    Returns (out [B,T,H*dirs], last_h [L*dirs,B,H], last_c [L*dirs,B,H]).
    """
    assert hidden_size, "hidden_size is required"
    helper = LayerHelper("lstm", name=name)
    dirs = 2 if is_bidirec else 1
    in_dim = input.shape[-1]
    wx, wh, bs = [], [], []
    for layer in range(num_layers):
        d_in = in_dim if layer == 0 else hidden_size * dirs
        for d in range(dirs):
            sfx = "_l%d%s" % (layer, "_rev" if d else "")
            wx.append(helper.create_parameter(
                ParamAttr(name=helper.name + "_wx" + sfx),
                shape=[d_in, 4 * hidden_size], dtype=dtype))
            wh.append(helper.create_parameter(
                ParamAttr(name=helper.name + "_wh" + sfx),
                shape=[hidden_size, 4 * hidden_size], dtype=dtype))
            bs.append(helper.create_parameter(
                ParamAttr(name=helper.name + "_b" + sfx),
                shape=[4 * hidden_size], dtype=dtype, is_bias=True))
    out = helper.create_variable_for_type_inference(dtype)
    last_h = helper.create_variable_for_type_inference(dtype)
    last_c = helper.create_variable_for_type_inference(dtype)
    inputs = {"Input": input, "WeightX": wx, "WeightH": wh, "Bias": bs}
    if init_h is not None:
        inputs["InitH"] = init_h
    if init_c is not None:
        inputs["InitC"] = init_c
    if length is not None:
        inputs["Length"] = length
    helper.append_op(
        "lstm", inputs=inputs,
        outputs={"Out": out, "LastH": last_h, "LastC": last_c},
        attrs={"num_layers": num_layers, "is_bidirec": is_bidirec,
               "dropout_prob": dropout_prob})
    return out, last_h, last_c


def lstm_unit(x_t, hidden_t_prev, cell_t_prev, forget_bias=0.0,
              param_attr=None, bias_attr=None, name=None):
    """One LSTM step (reference: layers/nn.py lstm_unit,
    operators/lstm_unit_op.cc): projects [x_t, h_prev] to 4H gates with an
    fc, then applies the cell. Returns (hidden [B,H], cell [B,H])."""
    from . import nn as nn_layers

    helper = LayerHelper("lstm_unit", name=name)
    size = cell_t_prev.shape[-1] * 4
    gates = nn_layers.fc([x_t, hidden_t_prev], size=size,
                         param_attr=param_attr, bias_attr=bias_attr)
    h = helper.create_variable_for_type_inference(x_t.dtype)
    c = helper.create_variable_for_type_inference(x_t.dtype)
    helper.append_op(
        "lstm_unit", inputs={"X": gates, "C_prev": cell_t_prev},
        outputs={"H": h, "C": c}, attrs={"forget_bias": float(forget_bias)})
    return h, c


def gru_unit(input, hidden, size, param_attr=None, bias_attr=None,
             activation="tanh", gate_activation="sigmoid", origin_mode=False,
             dtype="float32", name=None):
    """One GRU step (reference: layers/nn.py gru_unit,
    operators/gru_unit_op.cc). input: [B, 3*hidden] x-projection; ``size`` is
    3*hidden for Fluid parity. Returns (hidden [B,H], gate placeholder,
    reset_hidden placeholder) — Fluid returns a 3-tuple."""
    assert size % 3 == 0
    hidden_dim = size // 3
    helper = LayerHelper("gru_unit", name=name)
    weight = helper.create_parameter(param_attr, shape=[hidden_dim, 3 * hidden_dim],
                                     dtype=dtype)
    bias = helper.create_parameter(bias_attr, shape=[1, 3 * hidden_dim],
                                   dtype=dtype, is_bias=True)
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        "gru_unit",
        inputs={"Input": input, "HiddenPrev": hidden, "Weight": weight,
                "Bias": bias},
        outputs={"Hidden": out},
        attrs={"origin_mode": origin_mode,
               "gate_activation": gate_activation,
               "candidate_activation": activation})
    return out, None, None
