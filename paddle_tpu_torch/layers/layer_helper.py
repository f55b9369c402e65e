# ported from paddle_tpu/layers/layer_helper.py
"""LayerHelper: parameter creation + op-append glue.

Reference: ``python/paddle/fluid/layer_helper.py:42`` and
``layer_helper_base.py:252``. Creates Parameters in BOTH the startup program
(with the init op) and the main program (as input), mirroring Fluid's
two-program convention.
"""

from __future__ import annotations

from typing import Optional

from ..core import framework, unique_name
from ..core.framework import Parameter, Variable, default_main_program, default_startup_program
from .. import initializer as init_mod

__all__ = ["LayerHelper", "ParamAttr"]


class ParamAttr:
    """Reference: python/paddle/fluid/param_attr.py."""

    def __init__(
        self,
        name: Optional[str] = None,
        initializer=None,
        learning_rate: float = 1.0,
        regularizer=None,
        trainable: bool = True,
        gradient_clip=None,
        do_model_average: bool = False,
    ):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.gradient_clip = gradient_clip
        self.do_model_average = do_model_average

    @staticmethod
    def to_attr(arg) -> "ParamAttr":
        if arg is None:
            return ParamAttr()
        if isinstance(arg, ParamAttr):
            return arg
        if isinstance(arg, str):
            return ParamAttr(name=arg)
        if isinstance(arg, init_mod.Initializer):
            return ParamAttr(initializer=arg)
        if isinstance(arg, bool):
            return ParamAttr() if arg else ParamAttr(trainable=False)
        raise TypeError("cannot interpret %r as ParamAttr" % (arg,))


class WeightNormParamAttr(ParamAttr):
    """Weight-normalization reparameterization w = g·v/‖v‖ (reference:
    param_attr.py:178). ``dim`` selects the slice axis whose magnitudes
    ``g`` are learned independently (None → one global magnitude)."""

    def __init__(self, dim=None, name=None, initializer=None,
                 learning_rate=1.0, regularizer=None, trainable=True,
                 gradient_clip=None, do_model_average=False):
        super().__init__(name=name, initializer=initializer,
                         learning_rate=learning_rate, regularizer=regularizer,
                         trainable=trainable, gradient_clip=gradient_clip,
                         do_model_average=do_model_average)
        self.dim = dim


class LayerHelper:
    def __init__(self, layer_type: str, **kwargs):
        self.kwargs = kwargs
        self.layer_type = layer_type
        name = kwargs.get("name")
        self.name = name if name is not None else unique_name.generate(layer_type)

    @property
    def main_program(self):
        return default_main_program()

    @property
    def startup_program(self):
        return default_startup_program()

    def append_op(self, *args, **kwargs):
        return self.main_program.current_block().append_op(*args, **kwargs)

    def create_variable_for_type_inference(self, dtype, stop_gradient=False) -> Variable:
        return self.main_program.current_block().create_var(
            name=unique_name.generate(".".join([self.name, "tmp"])),
            dtype=dtype,
            stop_gradient=stop_gradient,
        )

    # Fluid-compatible alias
    create_tmp_variable = create_variable_for_type_inference

    def create_parameter(
        self,
        attr,
        shape,
        dtype,
        is_bias: bool = False,
        default_initializer=None,
    ) -> Parameter:
        attr = ParamAttr.to_attr(attr)
        if attr.name is None:
            attr.name = unique_name.generate(".".join([self.name, "b" if is_bias else "w"]))
        if isinstance(attr, WeightNormParamAttr):
            return self._create_weight_normalized(
                attr, shape, dtype, default_initializer)
        if default_initializer is None:
            if is_bias:
                default_initializer = init_mod._global_bias_initializer()
            else:
                default_initializer = init_mod._global_weight_initializer()
        initializer = attr.initializer or default_initializer

        startup_block = self.startup_program.global_block
        sp = startup_block.create_parameter(
            name=attr.name,
            shape=shape,
            dtype=dtype,
            trainable=attr.trainable,
            regularizer=attr.regularizer,
            gradient_clip_attr=attr.gradient_clip,
        )
        initializer(sp, startup_block)
        main_block = self.main_program.global_block
        param = main_block.create_parameter(
            name=attr.name,
            shape=shape,
            dtype=dtype,
            trainable=attr.trainable,
            regularizer=attr.regularizer,
            gradient_clip_attr=attr.gradient_clip,
        )
        param.optimize_attr = {"learning_rate": attr.learning_rate}
        return param

    def _create_weight_normalized(self, attr, shape, dtype,
                                  default_initializer):
        """Weight normalization (reference: param_attr.py WeightNormParamAttr
        + layer_helper.py __weight_normalize): w = g · v/‖v‖ with direction
        ``v`` and per-slice magnitude ``g`` as the trainable parameters.
        ``g`` is initialized to ‖v‖ in the startup program so training
        starts at w == v, matching the reference."""
        dim = attr.dim
        base = ParamAttr(name=attr.name + ".w_v", initializer=attr.initializer,
                         learning_rate=attr.learning_rate,
                         regularizer=attr.regularizer,
                         trainable=attr.trainable,
                         gradient_clip=attr.gradient_clip)
        v = self.create_parameter(base, shape, dtype,
                                  default_initializer=default_initializer)
        g_shape = [shape[dim]] if dim is not None else [1]
        reduce_axes = ([a for a in range(len(shape)) if a != dim]
                       if dim is not None else list(range(len(shape))))
        bshape = [1] * len(shape)
        if dim is not None:
            bshape[dim] = shape[dim]

        def norm_ops(block, v_var, out_name_hint):
            sq = block.create_var(name=unique_name.generate(out_name_hint + ".sq"),
                                  shape=list(shape), dtype=dtype)
            block.append_op("square", inputs={"X": v_var}, outputs={"Out": sq},
                            attrs={})
            ssum = block.create_var(name=unique_name.generate(out_name_hint + ".ss"),
                                    shape=g_shape, dtype=dtype)
            block.append_op("reduce_sum", inputs={"X": sq},
                            outputs={"Out": ssum},
                            attrs={"dim": reduce_axes, "keep_dim": False,
                                   "reduce_all": dim is None})
            nrm = block.create_var(name=unique_name.generate(out_name_hint + ".n"),
                                   shape=g_shape, dtype=dtype)
            block.append_op("sqrt", inputs={"X": ssum}, outputs={"Out": nrm},
                            attrs={})
            return nrm

        # startup: g := ||v|| (so the initial effective weight equals v)
        startup_block = self.startup_program.global_block
        sg = startup_block.create_parameter(
            name=attr.name + ".w_g", shape=g_shape, dtype=dtype,
            trainable=attr.trainable)
        s_norm = norm_ops(startup_block, startup_block.var(v.name), attr.name)
        startup_block.append_op("assign", inputs={"X": s_norm},
                                outputs={"Out": sg}, attrs={})
        main_block = self.main_program.global_block
        g = main_block.create_parameter(name=attr.name + ".w_g", shape=g_shape,
                                        dtype=dtype, trainable=attr.trainable)
        g.optimize_attr = {"learning_rate": attr.learning_rate}

        # main: w = v * (g / ||v||), broadcast over the kept dim
        m_norm = norm_ops(main_block, v, attr.name + ".m")
        scale = main_block.create_var(
            name=unique_name.generate(attr.name + ".scale"), shape=g_shape,
            dtype=dtype)
        main_block.append_op("elementwise_div", inputs={"X": g, "Y": m_norm},
                             outputs={"Out": scale}, attrs={"axis": -1})
        scale_r = main_block.create_var(
            name=unique_name.generate(attr.name + ".scale_r"),
            shape=bshape, dtype=dtype)
        main_block.append_op("reshape", inputs={"X": scale},
                             outputs={"Out": scale_r},
                             attrs={"shape": bshape})
        w = main_block.create_var(name=unique_name.generate(attr.name),
                                  shape=list(shape), dtype=dtype)
        main_block.append_op("elementwise_mul", inputs={"X": v, "Y": scale_r},
                             outputs={"Out": w}, attrs={"axis": -1})
        return w

    def create_global_variable(self, shape, dtype, name=None, persistable=False, stop_gradient=True):
        return self.main_program.global_block.create_var(
            name=name or unique_name.generate(".".join([self.name, "global"])),
            shape=shape,
            dtype=dtype,
            persistable=persistable,
            stop_gradient=stop_gradient,
        )

    def create_or_get_global_variable(self, shape, dtype, name, persistable=True, initializer=None):
        """Persistent state var (e.g. BN running stats) with startup init."""
        main_block = self.main_program.global_block
        if main_block.has_var(name):
            return main_block.var(name)
        var = main_block.create_var(
            name=name, shape=shape, dtype=dtype, persistable=persistable, stop_gradient=True
        )
        startup_block = self.startup_program.global_block
        sv = startup_block.create_var(
            name=name, shape=shape, dtype=dtype, persistable=persistable, stop_gradient=True
        )
        (initializer or init_mod.Constant(0.0))(sv, startup_block)
        return var

    def input(self, name="input"):
        inputs = self.kwargs.get(name)
        if isinstance(inputs, (list, tuple)):
            if len(inputs) != 1:
                raise ValueError("expected one input for %s" % self.layer_type)
            return inputs[0]
        return inputs

    def input_dtype(self, name="input"):
        return self.input(name).dtype

    def append_bias_op(self, input_var, dim_start=1, dim_end=None):
        if input_var.shape is None:
            raise ValueError(
                "shape inference failed for %r (produced by op %r) — the layer "
                "geometry is likely invalid (e.g. spatial dims shrank to zero)"
                % (input_var.name, input_var.op.type if input_var.op else None)
            )
        size = list(input_var.shape[dim_start:dim_end])
        bias_attr = ParamAttr.to_attr(self.kwargs.get("bias_attr"))
        if not bias_attr.trainable and bias_attr.name is None and self.kwargs.get("bias_attr") is False:
            return input_var
        b = self.create_parameter(bias_attr, shape=size, dtype=input_var.dtype, is_bias=True)
        out = self.create_variable_for_type_inference(input_var.dtype)
        self.append_op(
            "elementwise_add",
            inputs={"X": input_var, "Y": b},
            outputs={"Out": out},
            attrs={"axis": dim_start},
        )
        return out

    def append_activation(self, input_var):
        act = self.kwargs.get("act")
        if act is None:
            return input_var
        if isinstance(act, str):
            act = {"type": act}
        act = dict(act)
        act_type = act.pop("type")
        out = self.create_variable_for_type_inference(input_var.dtype)
        self.append_op(act_type, inputs={"X": input_var}, outputs={"Out": out}, attrs=act)
        return out
