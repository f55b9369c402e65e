# ported from paddle_tpu/contrib/quantize/quantize_transpiler.py
"""QuantizeTranspiler — QAT Program rewrite (reference:
python/paddle/fluid/contrib/quantize/quantize_transpiler.py:81, ops in
operators/fake_quantize_op.cc).

Same three phases as the reference:
- ``training_transpile``: insert fake quant/dequant pairs before every
  quantizable op (conv2d/depthwise_conv2d/mul/matmul) and rewire inputs.
  Only the forward needs rewriting here — the executor differentiates the
  rewritten forward with ``torch.autograd``, the straight-through
  estimator baked into the quant ops (ops/quantize_ops.py), so the
  reference's backward rename pass has no equivalent.
- ``freeze_program``: for inference — weights stored on the int grid in the
  scope, activation quants switch to their frozen scales, dequants fold
  into one post-op ``fake_dequantize_max_abs``.
- ``convert_to_int8``: rewrite frozen weights as int8 tensors in the scope.

The scope holds torch tensors on the executor's device: ``freeze_program``
puts each weight on the int grid in torch on that device (its abs-max read
on the host once, as the JAX package reads it with numpy), and
``convert_to_int8`` stores int8 tensors on the same device.
"""

from __future__ import annotations

import torch

from ...core.framework import Parameter, default_main_program, default_startup_program, program_guard
from ...core.scope import global_scope

__all__ = ["QuantizeTranspiler"]

_QUANTIZABLE_OP_TYPES = ("conv2d", "depthwise_conv2d", "mul", "matmul")
_FAKE_QUANT_TYPES = ("fake_quantize_abs_max", "fake_quantize_range_abs_max",
                     "fake_quantize_moving_average_abs_max")
_FAKE_DEQUANT_TYPES = ("fake_dequantize_max_abs",)


def _quant_name(name):
    return name + ".quantized"


def _dequant_name(name):
    return name + ".dequantized"


def _scale_name(name):
    return name + ".scale"


def _original_var_name(name):
    for suf in (".quantized.dequantized", ".quantized", ".dequantized", ".scale"):
        if name.endswith(suf):
            return name[: -len(suf)]
    return name


class QuantizeTranspiler:
    """reference: quantize_transpiler.py:81."""

    def __init__(self, weight_bits: int = 8, activation_bits: int = 8,
                 activation_quantize_type: str = "abs_max",
                 weight_quantize_type: str = "abs_max",
                 window_size: int = 10000, moving_rate: float = 0.9):
        valid = ("abs_max", "range_abs_max", "moving_average_abs_max")
        if activation_quantize_type not in valid:
            raise ValueError("Unknown activation_quantize_type %r (want one of %s)"
                             % (activation_quantize_type, valid))
        if weight_quantize_type not in ("abs_max", "range_abs_max"):
            raise ValueError("Unknown weight_quantize_type %r" % weight_quantize_type)
        self.weight_bits = weight_bits
        self.activation_bits = activation_bits
        self.activation_quantize_type = activation_quantize_type
        self.weight_quantize_type = weight_quantize_type
        self.window_size = window_size
        self.moving_rate = moving_rate
        self._step_var = None

    # -- phase 1: training ----------------------------------------------------
    def training_transpile(self, program=None, startup_program=None):
        program = program or default_main_program()
        startup_program = startup_program or default_startup_program()
        params = {p.name for b in program.blocks for p in b.vars.values()
                  if isinstance(p, Parameter)}
        with program_guard(program, startup_program):
            if self.activation_quantize_type == "range_abs_max":
                from ...layers import tensor as tensor_layers

                self._step_var = tensor_layers.create_global_var(
                    shape=[1], value=0, dtype="int64", persistable=True,
                    name="@quant_step@")
                # one increment per step
                program.global_block.append_op(
                    "increment", inputs={"X": self._step_var},
                    outputs={"Out": self._step_var}, attrs={"step": 1.0})
            for block in program.blocks:
                dequanted = {}
                for op in list(block.ops):
                    if op.type in _QUANTIZABLE_OP_TYPES:
                        self._transpile_forward(block, op, params, dequanted,
                                                startup_program)
        return program

    def _transpile_forward(self, block, op, params, dequanted, startup):
        for name in list(op.input_arg_names):
            if name in dequanted:
                op._rename_input(name, dequanted[name])
                continue
            var = block.var(name)
            is_w = name in params
            bits = self.weight_bits if is_w else self.activation_bits
            qtype = self.weight_quantize_type if is_w else self.activation_quantize_type
            idx = block.ops.index(op)
            qvar, svar = self._insert_quant_op(block, idx, var, bits, qtype, startup)
            dqvar = self._insert_dequant_op(block, block.ops.index(op), qvar, svar, bits)
            dequanted[name] = dqvar.name
            op._rename_input(name, dqvar.name)

    def _insert_quant_op(self, block, idx, var, bits, qtype, startup):
        qvar = block.create_var(name=_quant_name(var.name), dtype=var.dtype,
                                shape=var.shape)
        svar = block.create_var(name=_scale_name(var.name), dtype=var.dtype,
                                shape=[1], persistable=qtype != "abs_max")
        if qtype == "abs_max":
            block.insert_op(idx, "fake_quantize_abs_max",
                            inputs={"X": var}, outputs={"Out": qvar, "OutScale": svar},
                            attrs={"bit_length": bits})
            return qvar, svar
        # stateful variants need startup-initialized scale state
        self._init_state(startup, svar.name, [1], 0.001)
        if qtype == "range_abs_max":
            wvar = block.create_var(name=var.name + ".scales_window",
                                    dtype=var.dtype, shape=[self.window_size],
                                    persistable=True)
            self._init_state(startup, wvar.name, [self.window_size], 0.0)
            block.insert_op(
                idx, "fake_quantize_range_abs_max",
                inputs={"X": var, "InScale": svar, "Iter": self._step_var,
                        "OutScales": wvar},
                outputs={"Out": qvar, "OutScale": svar, "OutScales": wvar},
                attrs={"bit_length": bits, "window_size": self.window_size})
        else:  # moving_average_abs_max
            avar = block.create_var(name=var.name + ".quant_accum", dtype=var.dtype,
                                    shape=[1], persistable=True)
            tvar = block.create_var(name=var.name + ".quant_state", dtype=var.dtype,
                                    shape=[1], persistable=True)
            self._init_state(startup, avar.name, [1], 0.0)
            self._init_state(startup, tvar.name, [1], 0.0)
            block.insert_op(
                idx, "fake_quantize_moving_average_abs_max",
                inputs={"X": var, "InScale": svar, "InAccum": avar, "InState": tvar},
                outputs={"Out": qvar, "OutScale": svar, "OutAccum": avar,
                         "OutState": tvar},
                attrs={"bit_length": bits, "moving_rate": self.moving_rate})
        return qvar, svar

    def _init_state(self, startup, name, shape, value):
        blk = startup.global_block
        if not blk.has_var(name):
            blk.create_var(name=name, shape=shape, dtype="float32", persistable=True)
        blk.append_op("fill_constant", outputs={"Out": name},
                      attrs={"shape": list(shape), "dtype": "float32",
                             "value": float(value)})

    def _insert_dequant_op(self, block, idx, qvar, svar, bits):
        base = _original_var_name(qvar.name)
        dqvar = block.create_var(name=_dequant_name(qvar.name), dtype=qvar.dtype,
                                 shape=qvar.shape)
        block.insert_op(idx, "fake_dequantize_max_abs",
                        inputs={"X": qvar, "Scale": svar},
                        outputs={"Out": dqvar},
                        attrs={"max_range": float((1 << (bits - 1)) - 1)})
        return dqvar

    # -- phase 2: freeze ------------------------------------------------------
    def freeze_program(self, program=None, place=None, scope=None):
        """reference: quantize_transpiler.py:218 — rewires the trained
        program for int-grid inference."""
        program = program or default_main_program()
        scope = scope or global_scope()
        persistable = {v.name for b in program.blocks for v in b.vars.values()
                       if v.persistable or isinstance(v, Parameter)}
        pr = float((1 << (self.weight_bits - 1)) - 1)
        ar = float((1 << (self.activation_bits - 1)) - 1)

        for block in program.blocks:
            in_rename, out_rename, scale_map = {}, {}, {}

            def remove(op):
                i = block.ops.index(op)
                out = op.outputs["Out"][0]
                src = op.inputs["X"][0]
                in_rename[out] = in_rename.get(src, src)
                block.remove_op(i)

            for op in list(block.ops):
                for name in list(op.input_arg_names):
                    if name in out_rename:
                        op._rename_input(name, out_rename[name])
                if op.type in _FAKE_QUANT_TYPES:
                    x_name = op.inputs["X"][0]
                    if x_name in persistable:
                        w = torch.as_tensor(scope.find_var(x_name))
                        scale_v = float(torch.amax(torch.abs(w)))
                        scale_map[x_name] = scale_v
                        remove(op)
                        q = torch.round(torch.clamp(
                            w / max(scale_v, 1e-8), -1, 1) * pr)
                        scope.set_var(x_name, q.to(w.dtype))
                    else:
                        op.attrs["is_test"] = True
                        scale_map[x_name] = op.outputs["OutScale"][0]
                elif op.type in _FAKE_DEQUANT_TYPES:
                    remove(op)
                elif op.type in _QUANTIZABLE_OP_TYPES:
                    max_range, scale_var = None, None
                    for name in list(op.input_arg_names):
                        if name in in_rename:
                            op._rename_input(name, in_rename[name])
                            name = in_rename[name]
                        orig = _original_var_name(name)
                        sv = scale_map.get(orig)
                        if isinstance(sv, float):
                            max_range = pr * ar / sv
                        elif sv is not None:
                            scale_var = sv
                    if max_range is None or scale_var is None:
                        continue  # op wasn't quantized
                    out_name = op.output_arg_names[0]
                    out_var = block.var(out_name)
                    dq = block.create_var(name=_dequant_name(out_name),
                                          dtype=out_var.dtype, shape=out_var.shape)
                    block.insert_op(block.ops.index(op) + 1,
                                    "fake_dequantize_max_abs",
                                    inputs={"X": out_var, "Scale": scale_var},
                                    outputs={"Out": dq},
                                    attrs={"max_range": float(max_range)})
                    out_rename[out_name] = dq.name
        return program

    # -- phase 3: int8 storage ------------------------------------------------
    def convert_to_int8(self, program=None, place=None, scope=None):
        """Store frozen int-grid weights as int8 tensors in the scope, on
        the device each weight lies on (reference:
        quantize_transpiler.py:348). Returns the converted names."""
        program = program or default_main_program()
        scope = scope or global_scope()
        converted = []
        for block in program.blocks:
            for op in block.ops:
                if op.type not in _QUANTIZABLE_OP_TYPES:
                    continue
                for name in op.input_arg_names:
                    orig = _original_var_name(name)
                    v = scope.find_var(orig)
                    if v is None or orig in converted:
                        continue
                    t = torch.as_tensor(v)
                    if t.is_floating_point() and bool(torch.all(
                            torch.abs(t - torch.round(t)) < 1e-6)) and float(
                            torch.amax(torch.abs(t))) <= 127:
                        scope.set_var(orig, t.to(torch.int8))
                        converted.append(orig)
        return converted
