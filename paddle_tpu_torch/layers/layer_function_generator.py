# ported from paddle_tpu/layers/layer_function_generator.py
"""Auto-generated layer wrappers.

Reference: ``python/paddle/fluid/layers/layer_function_generator.py`` +
``layers/ops.py`` — Fluid code-generates ``fluid.layers.*`` functions from
the C++ OpProtos. The registry has no protos (one impl per op,
``core/registry.py``), so the slot mapping each wrapper needs is declared
here in ``_SPECS`` and ``generate_layer_fn`` makes the function:
reference-matching signature (``__signature__``), LayerHelper output-var
creation, one ``append_op``. None of these ops is ported yet.
"""

from __future__ import annotations

import inspect

from .layer_helper import LayerHelper

__all__ = [
    "generate_layer_fn",
    "bpr_loss",
    "rank_loss",
    "margin_rank_loss",
    "teacher_student_sigmoid_loss",
    "similarity_focus",
    "add_position_encoding",
    "pad_constant_like",
    "random_crop",
    "logical_xor",
    "affine_channel",
    "lod_reset",
    "sampling_id",
    "crop",
    "affine_grid",
    "lod_reset",
]

_REQ = inspect.Parameter.empty  # sentinel: parameter has no default


# Each row: (python param, kind, op slot/attr name[, default]).
# kind: "in" required input, "in_opt" optional input, "attr" attribute.
_SPECS = {
    "bpr_loss": dict(
        params=[("input", "in", "X"), ("label", "in", "Label")],
        out="Y", name_arg=True,
        doc="Bayesian Personalized Ranking loss (operators/bpr_loss_op.cc)."),
    "rank_loss": dict(
        params=[("label", "in", "Label"), ("left", "in", "Left"),
                ("right", "in", "Right")],
        name_arg=True,
        doc="RankNet pairwise loss (operators/rank_loss_op.cc)."),
    "margin_rank_loss": dict(
        params=[("label", "in", "Label"), ("left", "in", "X1"),
                ("right", "in", "X2"), ("margin", "attr", "margin", 0.1)],
        name_arg=True,
        doc="Margin ranking loss (operators/margin_rank_loss_op.cc)."),
    "teacher_student_sigmoid_loss": dict(
        params=[("input", "in", "X"), ("label", "in", "Label"),
                ("soft_max_up_bound", "attr", "soft_max_up_bound", 15.0),
                ("soft_max_lower_bound", "attr", "soft_max_lower_bound", -15.0)],
        out="Y",
        doc="CTR distillation loss (operators/teacher_student_sigmoid_loss_op.cc)."),
    "similarity_focus": dict(
        params=[("input", "in", "X"), ("axis", "attr", "axis"),
                ("indexes", "attr", "indexes")],
        name_arg=True,
        doc="Similarity-focus mask (operators/similarity_focus_op.cc)."),
    "add_position_encoding": dict(
        params=[("input", "in", "X"), ("alpha", "attr", "alpha"),
                ("beta", "attr", "beta")],
        name_arg=True,
        doc="Sinusoidal position encoding mix-in "
            "(operators/add_position_encoding_op.cc)."),
    "pad_constant_like": dict(
        params=[("x", "in", "X"), ("y", "in", "Y"),
                ("pad_value", "attr", "pad_value", 0.0)],
        name_arg=True,
        doc="Pad Y to X's shape with a constant (operators/pad_constant_like_op.cc)."),
    "random_crop": dict(
        params=[("x", "in", "X"), ("shape", "attr", "shape"),
                ("seed", "attr", "seed", 0)],
        doc="Random spatial crop to `shape` (operators/random_crop_op.cc)."),
    "logical_xor": dict(
        params=[("x", "in", "X"), ("y", "in", "Y")],
        dtype="bool", name_arg=True, allow_out=True,
        doc="Elementwise logical xor (operators/controlflow/logical_op.cc)."),
    "affine_channel": dict(
        params=[("x", "in", "X"), ("scale", "in_opt", "Scale"),
                ("bias", "in_opt", "Bias"),
                ("data_layout", "attr", "data_layout", "NCHW")],
        name_arg=True,
        doc="Per-channel affine transform (operators/affine_channel_op.cc)."),
    "sampling_id": dict(
        params=[("x", "in", "X"), ("min", "attr", "min", 0.0),
                ("max", "attr", "max", 1.0), ("seed", "attr", "seed", 0),
                ("dtype", "py", None, "float32")],
        dtype="int64",
        doc="Sample one column index per probability row "
            "(operators/sampling_id_op.cc)."),
}


def generate_layer_fn(name: str, spec: dict):
    """Build a ``fluid.layers``-style wrapper for a registered op from a slot
    spec (the TPU-native analog of the reference's OpProto template codegen)."""
    op_type = spec.get("op", name)
    out_slot = spec.get("out", "Out")
    out_dtype = spec.get("dtype")
    extra_outs = spec.get("extra_outs", ())

    sig_params = []
    for row in spec["params"]:
        pname, kind = row[0], row[1]
        default = row[3] if len(row) > 3 else (
            None if kind == "in_opt" else _REQ)
        sig_params.append(inspect.Parameter(
            pname, inspect.Parameter.POSITIONAL_OR_KEYWORD, default=default))
    if spec.get("allow_out"):
        sig_params.append(inspect.Parameter(
            "out", inspect.Parameter.POSITIONAL_OR_KEYWORD, default=None))
    if spec.get("name_arg"):
        sig_params.append(inspect.Parameter(
            "name", inspect.Parameter.POSITIONAL_OR_KEYWORD, default=None))
    sig = inspect.Signature(sig_params)

    def layer(*args, **kwargs):
        bound = sig.bind(*args, **kwargs)
        bound.apply_defaults()
        vals = bound.arguments
        inputs, attrs = {}, {}
        for row in spec["params"]:
            pname, kind, slot = row[0], row[1], row[2]
            v = vals[pname]
            if kind in ("in", "in_opt"):
                if v is None:
                    if kind == "in":
                        raise ValueError("%s(): %r is required" % (name, pname))
                    continue
                inputs[slot] = v
            elif kind == "attr" and v is not None:
                attrs[slot] = v
        helper = LayerHelper(op_type, name=vals.get("name"))
        ref_in = next(iter(inputs.values()))
        out = vals.get("out") or helper.create_variable_for_type_inference(
            out_dtype or ref_in.dtype)
        outputs = {out_slot: out}
        for slot, dt in extra_outs:
            outputs[slot] = helper.create_variable_for_type_inference(
                dt or ref_in.dtype, stop_gradient=True)
        helper.append_op(op_type, inputs=inputs, outputs=outputs, attrs=attrs)
        if name == "sampling_id" and vals.get("dtype") not in (None, "int64"):
            from .tensor import cast

            return cast(out, vals["dtype"])
        return out

    layer.__name__ = layer.__qualname__ = name
    layer.__signature__ = sig
    layer.__doc__ = "%s\n\nAuto-generated wrapper for the %r op (reference: " \
        "layers auto-generation via layer_function_generator.py)." % (
            spec.get("doc", ""), op_type)
    return layer


for _n, _s in _SPECS.items():
    globals()[_n] = generate_layer_fn(_n, _s)


# -- wrappers with input-vs-attr routing (can't be table-generated) -----------


def lod_reset(x, y=None, target_lod=None):
    """Replace the sequence-length descriptor (reference: nn.py lod_reset,
    operators/lod_reset_op.cc). Under the padded+Length convention the data
    passes through and the new per-row lengths come back explicitly:
    returns ``(out, new_length)`` — downstream sequence layers take the
    length var via their ``length=`` argument."""
    if y is None and target_lod is None:
        raise ValueError("lod_reset(): provide y or target_lod")
    helper = LayerHelper("lod_reset")
    out = helper.create_variable_for_type_inference(x.dtype)
    out_len = helper.create_variable_for_type_inference("int32",
                                                        stop_gradient=True)
    inputs = {"X": x}
    if y is not None:
        inputs["Y"] = y
    helper.append_op("lod_reset", inputs=inputs,
                     outputs={"Out": out, "OutLength": out_len},
                     attrs={"target_lod": target_lod} if target_lod else {})
    return out, out_len


def crop(x, shape=None, offsets=None, name=None):
    """Crop x to `shape` at `offsets` (reference: nn.py crop, crop_op.cc).

    Static lists only: a Variable shape would be data-dependent under XLA.
    """
    from ..core.framework import Variable

    if isinstance(shape, Variable) or isinstance(offsets, Variable):
        raise TypeError(
            "crop(): Variable shape/offsets are data-dependent shapes, which "
            "XLA cannot compile; pass Python lists")
    if shape is None:
        raise ValueError("crop(): shape is required")
    if offsets is None:
        offsets = [0] * len(shape)
    helper = LayerHelper("crop", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("crop", inputs={"X": x}, outputs={"Out": out},
                     attrs={"shape": list(shape), "offsets": list(offsets)})
    return out


def affine_grid(theta, out_shape, name=None):
    """Affine sampling grid for STNs (reference: nn.py affine_grid,
    operators/affine_grid_op.cc). ``out_shape`` may be a Variable (wired to
    the OutputShape input) or a static list (attr)."""
    from ..core.framework import Variable

    helper = LayerHelper("affine_grid", name=name)
    out = helper.create_variable_for_type_inference(theta.dtype)
    inputs = {"Theta": theta}
    attrs = {}
    if isinstance(out_shape, Variable):
        inputs["OutputShape"] = out_shape
    else:
        attrs["output_shape"] = [int(s) for s in out_shape]
    helper.append_op("affine_grid", inputs=inputs, outputs={"Output": out},
                     attrs=attrs)
    return out
