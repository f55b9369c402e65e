# ported from paddle_tpu/optimizer.py
"""Optimizers (reference: python/paddle/fluid/optimizer.py:44-1484).

Same structure as Fluid: ``minimize`` = ``backward`` (append_backward) +
``apply_gradients`` (regularization + clip + per-param optimize ops appended
to the program after the backward marker). The optimize ops are torch
updates (paddle_tpu_torch/ops/optimizer_ops.py) that the Executor runs
after the backward under ``torch.no_grad()``.

Every optimizer, ``ModelAverage``, the clips of :mod:`.clip` and the
schedules of ``layers.learning_rate_scheduler`` build ops the port
registers. In imperative (dygraph) mode ``minimize`` runs the same
update ops eagerly (``_imperative_minimize``) through
``imperative.EagerBlock``, over accumulators that are tensors on the
tracer's device (``_EagerSlot``), updated in place; an optimizer used
once in either mode refuses the other. Left out against the JAX package
until the monitor is ported: the ``PADDLE_TPU_GRAD_NORM`` probe.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from . import initializer as init_mod
from .backward import append_backward
from .clip import append_gradient_clip_ops, error_clip_callback
from .core import unique_name
from .core.framework import Parameter, Program, Variable, default_main_program, default_startup_program
from .layers.layer_helper import LayerHelper
from .regularizer import append_regularization_ops

__all__ = [
    "SGD",
    "Momentum",
    "Adagrad",
    "Adam",
    "Adamax",
    "AdamW",
    "DecayedAdagrad",
    "Adadelta",
    "RMSProp",
    "Ftrl",
    "Lamb",
    "LarsMomentum",
    "ProximalGD",
    "ProximalAdagrad",
    "SGDOptimizer",
    "MomentumOptimizer",
    "AdagradOptimizer",
    "AdamOptimizer",
    "AdamaxOptimizer",
    "DecayedAdagradOptimizer",
    "AdadeltaOptimizer",
    "RMSPropOptimizer",
    "FtrlOptimizer",
    "LambOptimizer",
    "LarsMomentumOptimizer",
    "ProximalGDOptimizer",
    "ProximalAdagradOptimizer",
    "ModelAverage",
    "Optimizer",
]


class _EagerSlot:
    """Mutable tensor holder for imperative-mode accumulators/LR (duck-typed
    like VarBase for EagerBlock's in-place output writes)."""

    __slots__ = ("value",)

    def __init__(self, value):
        self.value = value


class Optimizer:
    """Base optimizer (reference: optimizer.py:44)."""

    def __init__(self, learning_rate, regularization=None, name=None):
        self.regularization = regularization
        self._name = name
        self._learning_rate = learning_rate
        self._learning_rate_var: Optional[Variable] = None
        # accumulators: {acc_name: {param_name: var}}
        self._accumulators: Dict[str, Dict[str, Variable]] = {}
        self.helper: Optional[LayerHelper] = None
        self.type = getattr(self, "type", "optimizer")

    # -- learning rate --------------------------------------------------------
    def _create_global_learning_rate(self):
        if isinstance(self._learning_rate, Variable):
            self._learning_rate_var = self._learning_rate
            main = default_main_program()
            if main._lr_var_name is None:
                main._lr_var_name = self._learning_rate.name
            return
        if self._learning_rate_var is None:
            from .layers import tensor as tensor_layers

            self._learning_rate_var = tensor_layers.create_global_var(
                shape=[1],
                value=float(self._learning_rate),
                dtype="float32",
                persistable=True,
                name=unique_name.generate("learning_rate"),
            )
            default_main_program()._lr_var_name = self._learning_rate_var.name

    def _global_learning_rate(self) -> Variable:
        return self._learning_rate_var

    @property
    def learning_rate(self):
        return self._learning_rate

    # -- accumulators ---------------------------------------------------------
    def _add_accumulator(self, name: str, param: Parameter, dtype=None, fill_value=0.0, shape=None):
        if name in self._accumulators and param.name in self._accumulators[name]:
            return self._accumulators[name][param.name]
        if getattr(self, "_imperative", False):
            from .core.dtypes import to_torch_dtype

            shape = tuple(shape if shape is not None else param.shape)
            slot = _EagerSlot(torch.full(shape, float(fill_value),
                                         dtype=to_torch_dtype(dtype or "float32"),
                                         device=param.value.device))
            self._accumulators.setdefault(name, {})[param.name] = slot
            return slot
        acc_name = unique_name.generate("%s_%s_%s" % (param.name, self.type, name))
        shape = list(shape if shape is not None else param.shape)
        dtype = dtype or "float32"
        helper = self.helper
        var = helper.create_or_get_global_variable(
            shape, dtype, acc_name, persistable=True,
            initializer=init_mod.Constant(float(fill_value)))
        # marks the var as per-param optimizer state so BuildStrategy's
        # ReduceStrategy.Reduce (ZeRO-1) can shard it over the data axis
        var.is_optimizer_state = True
        # a sharded parameter's same-shape accumulators (Adam moments on a
        # row-sharded embedding table) inherit its mesh layout: each device
        # holds V/n rows of param AND moments, and the startup twin carries
        # the annotation too so its fill_constant materializes shard-by-shard
        spec = getattr(param, "sharding", None)
        if spec is not None and list(shape) == list(param.shape):
            var.sharding = tuple(spec)
            sb = helper.startup_program.global_block
            if sb.has_var(acc_name):
                sb.var(acc_name).sharding = tuple(spec)
        self._accumulators.setdefault(name, {})[param.name] = var
        return var

    def _get_accumulator(self, name: str, param: Parameter) -> Variable:
        return self._accumulators[name][param.name]

    def _create_accumulators(self, block, parameters):
        pass

    def _finish_update(self, block, parameters_and_grads):
        pass

    def _append_optimize_op(self, block, param_and_grad):
        raise NotImplementedError

    # -- the Fluid pipeline ---------------------------------------------------
    def backward(self, loss, startup_program=None, parameter_list=None, no_grad_set=None,
                 callbacks=None):
        return append_backward(loss, parameter_list, no_grad_set, callbacks or [error_clip_callback])

    def apply_gradients(self, params_grads: List[Tuple[Parameter, Variable]]):
        """reference: optimizer.py:318 — clip, regularize, then optimize ops."""
        params_grads = sorted(params_grads, key=lambda pg: pg[0].name)
        params_grads = append_gradient_clip_ops(params_grads)
        params_grads = append_regularization_ops(params_grads, self.regularization)
        return self._create_optimization_pass(params_grads)

    def _create_optimization_pass(self, parameters_and_grads):
        """reference: optimizer.py:198."""
        program = default_main_program()
        block = program.global_block
        self.helper = LayerHelper(self.__class__.__name__)
        self._create_global_learning_rate()
        self._create_accumulators(block, [p for p, g in parameters_and_grads if g is not None])
        optimize_ops = []
        for param_and_grad in parameters_and_grads:
            if param_and_grad[1] is None:
                continue
            if param_and_grad[0].trainable:
                optimize_ops.append(self._append_optimize_op(block, param_and_grad))
        self._finish_update(block, parameters_and_grads)
        return optimize_ops

    def minimize(self, loss, startup_program=None, parameter_list=None, no_grad_set=None):
        """reference: optimizer.py:357. Ops are appended to the *loss's*
        program, not whatever default program is active at call time.

        In imperative (dygraph) mode the same per-optimizer update ops run
        eagerly instead (reference: optimizer.py minimize under
        _in_imperative_mode)."""
        from .imperative import base as _imp

        if _imp.enabled():
            return self._imperative_minimize(loss, parameter_list, no_grad_set)
        if getattr(self, "_imperative", False):
            raise RuntimeError(
                "This optimizer instance was used in imperative mode; its "
                "accumulators are eager tensors and cannot drive a static "
                "program. Create a fresh optimizer per mode.")
        from .core.framework import program_guard

        with program_guard(loss.block.program, startup_program):
            params_grads = self.backward(loss, startup_program, parameter_list, no_grad_set)
            optimize_ops = self.apply_gradients(params_grads)
        return optimize_ops, params_grads

    def _imperative_minimize(self, loss, parameter_list=None, no_grad_set=None):
        """Dygraph optimize step: run `_append_optimize_op` with an
        EagerBlock so every subclass's update math is reused unchanged.
        Accumulators are tensors on the parameters' device; the ParamOut
        writes go in place into the VarBase tensors. Gradient *clipping* is
        not wired in dygraph (the reference's 1.x dygraph had the same
        gap)."""
        from .imperative.tracer import EagerBlock, current_tracer
        from .regularizer import L1DecayRegularizer, L2DecayRegularizer

        if isinstance(self._learning_rate, Variable):
            raise NotImplementedError(
                "LR-scheduler Variables are a static-graph feature; use a "
                "float learning rate (optionally updated between steps) in "
                "imperative mode.")
        self._imperative = True
        no_grad = {getattr(v, "name", v) for v in (no_grad_set or ())}
        params = parameter_list if parameter_list is not None else current_tracer().parameters()
        params = sorted((p for p in params
                         if p.trainable and p._grad is not None and p.name not in no_grad),
                        key=lambda p: p.name)
        block = EagerBlock()
        self._create_accumulators(block, params)
        params_grads, ops = [], []
        for p in params:
            g = p._grad
            reg = getattr(p, "regularizer", None) or self.regularization
            if reg is not None:
                pv = p.value.detach()
                if isinstance(reg, L2DecayRegularizer):
                    g = g + reg._coeff * pv
                elif isinstance(reg, L1DecayRegularizer):
                    g = g + reg._coeff * torch.sign(pv)
                else:
                    raise NotImplementedError("unsupported regularizer in dygraph: %r" % reg)
            params_grads.append((p, g))
            ops.append(self._append_optimize_op(block, (p, g)))
        self._finish_update(block, params_grads)
        return ops, params_grads

    def _lr_input(self, param=None):
        if getattr(self, "_imperative", False):
            plr = 1.0 if param is None else getattr(
                param, "optimize_attr", {"learning_rate": 1.0}).get("learning_rate", 1.0)
            dev = param.value.device if param is not None else "cpu"
            return _EagerSlot(torch.full((1,), float(self._learning_rate) * float(plr),
                                         dtype=torch.float32, device=dev))
        lr = self._global_learning_rate()
        plr = 1.0
        if param is not None:
            plr = getattr(param, "optimize_attr", {"learning_rate": 1.0}).get("learning_rate", 1.0)
        if plr == 1.0:
            return lr
        from .layers import tensor as tensor_layers

        return tensor_layers.scale(lr, scale=float(plr))


class SGDOptimizer(Optimizer):
    type = "sgd"

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        return block.append_op(
            "sgd",
            inputs={"Param": p, "Grad": g, "LearningRate": self._lr_input(p)},
            outputs={"ParamOut": p},
        )


class MomentumOptimizer(Optimizer):
    type = "momentum"

    def __init__(self, learning_rate, momentum, use_nesterov=False, **kw):
        super().__init__(learning_rate, **kw)
        self._momentum = momentum
        self._use_nesterov = use_nesterov

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("velocity", p, dtype=p.dtype)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        velocity = self._get_accumulator("velocity", p)
        return block.append_op(
            "momentum",
            inputs={"Param": p, "Grad": g, "Velocity": velocity, "LearningRate": self._lr_input(p)},
            outputs={"ParamOut": p, "VelocityOut": velocity},
            attrs={"mu": self._momentum, "use_nesterov": self._use_nesterov},
        )


class LarsMomentumOptimizer(MomentumOptimizer):
    type = "lars_momentum"

    def __init__(self, learning_rate, momentum, lars_coeff=0.001, lars_weight_decay=0.0005, **kw):
        super().__init__(learning_rate, momentum, **kw)
        self._lars_coeff = lars_coeff
        self._lars_weight_decay = lars_weight_decay

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        velocity = self._get_accumulator("velocity", p)
        return block.append_op(
            "lars_momentum",
            inputs={"Param": p, "Grad": g, "Velocity": velocity, "LearningRate": self._lr_input(p)},
            outputs={"ParamOut": p, "VelocityOut": velocity},
            attrs={"mu": self._momentum, "lars_coeff": self._lars_coeff,
                   "lars_weight_decay": self._lars_weight_decay},
        )


class AdagradOptimizer(Optimizer):
    type = "adagrad"

    def __init__(self, learning_rate, epsilon=1e-6, initial_accumulator_value=0.0, **kw):
        super().__init__(learning_rate, **kw)
        self._epsilon = epsilon
        self._initial = initial_accumulator_value

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment", p, fill_value=self._initial)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        moment = self._get_accumulator("moment", p)
        return block.append_op(
            "adagrad",
            inputs={"Param": p, "Grad": g, "Moment": moment, "LearningRate": self._lr_input(p)},
            outputs={"ParamOut": p, "MomentOut": moment},
            attrs={"epsilon": self._epsilon},
        )


class AdamOptimizer(Optimizer):
    type = "adam"

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999, epsilon=1e-8, lazy_mode=False, **kw):
        super().__init__(learning_rate, **kw)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment1", p)
            self._add_accumulator("moment2", p)
        if not parameters:
            return
        if getattr(self, "_imperative", False):
            for p in parameters:
                self._add_accumulator("beta1_pow_acc", p,
                                      fill_value=self._beta1, shape=[1])
                self._add_accumulator("beta2_pow_acc", p,
                                      fill_value=self._beta2, shape=[1])
            return
        # ONE shared beta-pow pair for the whole parameter set, as in the
        # JAX package (optax keeps a single step count the same way). The
        # reference's per-param [1] scalars are always numerically
        # identical. The single bump happens once in _finish_update, after
        # every param op has read the step-t value.
        p0 = parameters[0]
        b1 = self._add_accumulator("beta1_pow_acc", p0,
                                   fill_value=self._beta1, shape=[1])
        b2 = self._add_accumulator("beta2_pow_acc", p0,
                                   fill_value=self._beta2, shape=[1])
        for p in parameters[1:]:
            self._accumulators["beta1_pow_acc"][p.name] = b1
            self._accumulators["beta2_pow_acc"][p.name] = b2

    def _finish_update(self, block, parameters_and_grads):
        if getattr(self, "_imperative", False):
            return
        pows = self._accumulators.get("beta1_pow_acc")
        if not pows:
            return
        for acc_name, beta in (("beta1_pow_acc", self._beta1),
                               ("beta2_pow_acc", self._beta2)):
            accs = {v.name: v for v in self._accumulators[acc_name].values()}
            for var in accs.values():  # one shared var normally
                block.append_op("scale", inputs={"X": var},
                                outputs={"Out": var},
                                attrs={"scale": beta, "bias": 0.0})

    def _extra_attrs(self):
        """Attrs beyond plain Adam's (AdamW/Lamb decay)."""
        return {}

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        m1 = self._get_accumulator("moment1", p)
        m2 = self._get_accumulator("moment2", p)
        b1p = self._get_accumulator("beta1_pow_acc", p)
        b2p = self._get_accumulator("beta2_pow_acc", p)
        attrs = {"beta1": self._beta1, "beta2": self._beta2, "epsilon": self._epsilon}
        attrs.update(self._extra_attrs())
        if getattr(self, "_imperative", False):
            outputs = {"ParamOut": p, "Moment1Out": m1, "Moment2Out": m2,
                       "Beta1PowOut": b1p, "Beta2PowOut": b2p}
        else:
            # pows are SHARED read-only here; _finish_update bumps them once
            outputs = {"ParamOut": p, "Moment1Out": m1, "Moment2Out": m2}
        return block.append_op(
            self.type,
            inputs={"Param": p, "Grad": g, "Moment1": m1, "Moment2": m2,
                    "Beta1Pow": b1p, "Beta2Pow": b2p, "LearningRate": self._lr_input(p)},
            outputs=outputs,
            attrs=attrs,
        )


class AdamWOptimizer(AdamOptimizer):
    type = "adamw"

    def __init__(self, learning_rate=0.001, weight_decay=0.01, **kw):
        super().__init__(learning_rate, **kw)
        self._weight_decay = weight_decay

    def _extra_attrs(self):
        return {"weight_decay": self._weight_decay}


class AdamaxOptimizer(Optimizer):
    type = "adamax"

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999, epsilon=1e-8, **kw):
        super().__init__(learning_rate, **kw)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment", p)
            self._add_accumulator("inf_norm", p)
            self._add_accumulator("beta1_pow_acc", p, fill_value=self._beta1, shape=[1])

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        return block.append_op(
            "adamax",
            inputs={"Param": p, "Grad": g,
                    "Moment": self._get_accumulator("moment", p),
                    "InfNorm": self._get_accumulator("inf_norm", p),
                    "Beta1Pow": self._get_accumulator("beta1_pow_acc", p),
                    "LearningRate": self._lr_input(p)},
            outputs={"ParamOut": p,
                     "MomentOut": self._get_accumulator("moment", p),
                     "InfNormOut": self._get_accumulator("inf_norm", p),
                     "Beta1PowOut": self._get_accumulator("beta1_pow_acc", p)},
            attrs={"beta1": self._beta1, "beta2": self._beta2, "epsilon": self._epsilon},
        )


class DecayedAdagradOptimizer(Optimizer):
    type = "decayed_adagrad"

    def __init__(self, learning_rate, decay=0.95, epsilon=1e-6, **kw):
        super().__init__(learning_rate, **kw)
        self._decay, self._epsilon = decay, epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        moment = self._get_accumulator("moment", p)
        return block.append_op(
            "decayed_adagrad",
            inputs={"Param": p, "Grad": g, "Moment": moment, "LearningRate": self._lr_input(p)},
            outputs={"ParamOut": p, "MomentOut": moment},
            attrs={"decay": self._decay, "epsilon": self._epsilon},
        )


class AdadeltaOptimizer(Optimizer):
    type = "adadelta"

    def __init__(self, learning_rate, epsilon=1e-6, rho=0.95, **kw):
        super().__init__(learning_rate, **kw)
        self._epsilon, self._rho = epsilon, rho

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("avg_squared_grad", p)
            self._add_accumulator("avg_squared_update", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        return block.append_op(
            "adadelta",
            inputs={"Param": p, "Grad": g,
                    "AvgSquaredGrad": self._get_accumulator("avg_squared_grad", p),
                    "AvgSquaredUpdate": self._get_accumulator("avg_squared_update", p),
                    "LearningRate": self._lr_input(p)},
            outputs={"ParamOut": p,
                     "AvgSquaredGradOut": self._get_accumulator("avg_squared_grad", p),
                     "AvgSquaredUpdateOut": self._get_accumulator("avg_squared_update", p)},
            attrs={"epsilon": self._epsilon, "rho": self._rho},
        )


class RMSPropOptimizer(Optimizer):
    type = "rmsprop"

    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0, centered=False, **kw):
        super().__init__(learning_rate, **kw)
        self._rho, self._epsilon, self._momentum, self._centered = rho, epsilon, momentum, centered

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("mean_square", p)
            self._add_accumulator("momentum", p)
            if self._centered:
                self._add_accumulator("mean_grad", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        inputs = {"Param": p, "Grad": g,
                  "MeanSquare": self._get_accumulator("mean_square", p),
                  "Moment": self._get_accumulator("momentum", p),
                  "LearningRate": self._lr_input(p)}
        outputs = {"ParamOut": p,
                   "MeanSquareOut": self._get_accumulator("mean_square", p),
                   "MomentOut": self._get_accumulator("momentum", p)}
        if self._centered:
            inputs["MeanGrad"] = self._get_accumulator("mean_grad", p)
            outputs["MeanGradOut"] = self._get_accumulator("mean_grad", p)
        return block.append_op(
            "rmsprop", inputs=inputs, outputs=outputs,
            attrs={"decay": self._rho, "epsilon": self._epsilon,
                   "momentum": self._momentum, "centered": self._centered},
        )


class FtrlOptimizer(Optimizer):
    type = "ftrl"

    def __init__(self, learning_rate, l1=0.0, l2=0.0, lr_power=-0.5, **kw):
        super().__init__(learning_rate, **kw)
        self._l1, self._l2, self._lr_power = l1, l2, lr_power

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("squared", p)
            self._add_accumulator("linear", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        return block.append_op(
            "ftrl",
            inputs={"Param": p, "Grad": g,
                    "SquaredAccumulator": self._get_accumulator("squared", p),
                    "LinearAccumulator": self._get_accumulator("linear", p),
                    "LearningRate": self._lr_input(p)},
            outputs={"ParamOut": p,
                     "SquaredAccumOut": self._get_accumulator("squared", p),
                     "LinearAccumOut": self._get_accumulator("linear", p)},
            attrs={"l1": self._l1, "l2": self._l2, "lr_power": self._lr_power},
        )


class ProximalGDOptimizer(Optimizer):
    """Proximal gradient descent with L1/L2 shrinkage (reference op:
    operators/optimizers/proximal_gd_op.cc; the reference's v1.3 Python
    layer never exposed it — this class completes the surface the same way
    the C++ op intended)."""

    type = "proximal_gd"

    def __init__(self, learning_rate, l1_regularization_strength=0.0,
                 l2_regularization_strength=0.0, **kw):
        super().__init__(learning_rate, **kw)
        self._l1 = l1_regularization_strength
        self._l2 = l2_regularization_strength

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        return block.append_op(
            "proximal_gd",
            inputs={"Param": p, "Grad": g, "LearningRate": self._lr_input(p)},
            outputs={"ParamOut": p},
            attrs={"l1": self._l1, "l2": self._l2},
        )


class ProximalAdagradOptimizer(Optimizer):
    """reference op: operators/optimizers/proximal_adagrad_op.cc."""

    type = "proximal_adagrad"

    def __init__(self, learning_rate, initial_accumulator_value=0.1,
                 l1_regularization_strength=0.0,
                 l2_regularization_strength=0.0, **kw):
        super().__init__(learning_rate, **kw)
        self._initial = initial_accumulator_value
        self._l1 = l1_regularization_strength
        self._l2 = l2_regularization_strength

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment", p, fill_value=self._initial)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        moment = self._get_accumulator("moment", p)
        return block.append_op(
            "proximal_adagrad",
            inputs={"Param": p, "Grad": g, "Moment": moment,
                    "LearningRate": self._lr_input(p)},
            outputs={"ParamOut": p, "MomentOut": moment},
            attrs={"l1": self._l1, "l2": self._l2},
        )


class LambOptimizer(AdamOptimizer):
    type = "lamb"

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01, beta1=0.9, beta2=0.999,
                 epsilon=1e-6, **kw):
        super().__init__(learning_rate, beta1=beta1, beta2=beta2, epsilon=epsilon, **kw)
        self._weight_decay = lamb_weight_decay

    def _extra_attrs(self):
        return {"weight_decay": self._weight_decay}


class ModelAverage(Optimizer):
    """Averaged-weights evaluation (reference: optimizer.py ModelAverage +
    operators/average_accumulates_op.cc): appends running-sum accumulate ops
    after the optimize ops; ``apply()`` temporarily swaps params for their
    window average, ``restore()`` (or leaving the context) swaps back."""

    type = "model_average"

    def __init__(self, average_window_rate, min_average_window=10000,
                 max_average_window=10000, **kw):
        super().__init__(0.0, **kw)
        self.average_window = float(average_window_rate)
        self.min_average_window = int(min_average_window)
        self.max_average_window = int(max_average_window)
        self.params_grads = []
        self._backup = {}
        main = default_main_program()
        self.helper = LayerHelper(self.__class__.__name__)
        for param in main.global_block.all_parameters():
            if not param.trainable:
                continue
            self._append_average_accumulate_op(param)
            self.params_grads.append(param)

    def _append_average_accumulate_op(self, param):
        block = default_main_program().global_block
        sum1 = self._add_accumulator("sum_1", param)
        sum2 = self._add_accumulator("sum_2", param)
        sum3 = self._add_accumulator("sum_3", param)
        n_acc = self._add_accumulator("num_accumulates", param, dtype="int64", shape=[1])
        old_n = self._add_accumulator("old_num_accumulates", param, dtype="int64", shape=[1])
        n_upd = self._add_accumulator("num_updates", param, dtype="int64", shape=[1])
        block.append_op(
            "average_accumulates",
            inputs={"Param": param, "InSum1": sum1, "InSum2": sum2,
                    "InSum3": sum3, "InNumAccumulates": n_acc,
                    "InOldNumAccumulates": old_n, "InNumUpdates": n_upd},
            outputs={"OutSum1": sum1, "OutSum2": sum2, "OutSum3": sum3,
                     "OutNumAccumulates": n_acc, "OutOldNumAccumulates": old_n,
                     "OutNumUpdates": n_upd},
            attrs={"average_window": self.average_window,
                   "max_average_window": self.max_average_window,
                   "min_average_window": self.min_average_window})

    def _averaged(self, scope, param):
        """The window average of ``param`` as a tensor on the scope's
        device: (sum_1 + sum_2 + sum_3) / max(num_accumulates +
        old_num_accumulates, 1) in float64, cast to the parameter's dtype."""
        acc = lambda name: scope.find_var(
            self._accumulators[name][param.name].name).double()
        total = acc("sum_1") + acc("sum_2") + acc("sum_3")
        n = (acc("num_accumulates") + acc("old_num_accumulates")).reshape(())
        return (total / torch.clamp(n, min=1.0)).to(
            scope.find_var(param.name).dtype)

    def apply(self, executor=None, need_restore=True):
        """Context manager: params ← window average (reference:
        optimizer.py ModelAverage.apply), on the scope's device. The
        parameters are kept as copies until :meth:`restore`: a captured
        step that runs meanwhile writes the average into its own static
        tensors."""
        import contextlib

        from .core.scope import global_scope

        @contextlib.contextmanager
        def _ctx():
            scope = global_scope()
            self._backup = {}
            with torch.no_grad():
                for p in self.params_grads:
                    self._backup[p.name] = scope.find_var(p.name).clone()
                    scope.set_var(p.name, self._averaged(scope, p))
            try:
                yield
            finally:
                if need_restore:
                    self.restore(executor)

        return _ctx()

    def restore(self, executor=None):
        from .core.scope import global_scope

        scope = global_scope()
        for name, val in self._backup.items():
            scope.set_var(name, val)
        self._backup = {}


# Fluid-style short aliases
SGD = SGDOptimizer
Momentum = MomentumOptimizer
Adagrad = AdagradOptimizer
Adam = AdamOptimizer
AdamW = AdamWOptimizer
Adamax = AdamaxOptimizer
DecayedAdagrad = DecayedAdagradOptimizer
Adadelta = AdadeltaOptimizer
RMSProp = RMSPropOptimizer
Ftrl = FtrlOptimizer
Lamb = LambOptimizer
LarsMomentum = LarsMomentumOptimizer
ProximalGD = ProximalGDOptimizer
ProximalAdagrad = ProximalAdagradOptimizer
