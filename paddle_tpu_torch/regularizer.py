# ported from paddle_tpu/regularizer.py
"""Weight-decay regularizers (reference: python/paddle/fluid/regularizer.py).

Appended as ops after the backward marker: grad = grad + coeff-term(param),
exactly Fluid's append_regularization_ops.
"""

from __future__ import annotations

__all__ = ["L1Decay", "L2Decay", "L1DecayRegularizer", "L2DecayRegularizer",
           "append_regularization_ops"]


class WeightDecayRegularizer:
    def append_regularization_op(self, param, grad, block):
        raise NotImplementedError


class L2DecayRegularizer(WeightDecayRegularizer):
    def __init__(self, regularization_coeff=0.0):
        self._coeff = regularization_coeff

    def append_regularization_op(self, param, grad, block):
        from .layers.layer_helper import LayerHelper

        helper = LayerHelper("l2_decay")
        decay = helper.create_variable_for_type_inference(param.dtype)
        block.append_op("scale", inputs={"X": param}, outputs={"Out": decay},
                        attrs={"scale": float(self._coeff)})
        block.append_op("sum", inputs={"X": [grad, decay]}, outputs={"Out": grad})
        return grad


class L1DecayRegularizer(WeightDecayRegularizer):
    def __init__(self, regularization_coeff=0.0):
        self._coeff = regularization_coeff

    def append_regularization_op(self, param, grad, block):
        from .layers.layer_helper import LayerHelper

        helper = LayerHelper("l1_decay")
        sign = helper.create_variable_for_type_inference(param.dtype)
        block.append_op("sign", inputs={"X": param}, outputs={"Out": sign})
        decay = helper.create_variable_for_type_inference(param.dtype)
        block.append_op("scale", inputs={"X": sign}, outputs={"Out": decay},
                        attrs={"scale": float(self._coeff)})
        block.append_op("sum", inputs={"X": [grad, decay]}, outputs={"Out": grad})
        return grad


def append_regularization_ops(parameters_and_grads, regularization=None):
    """reference: regularizer.py append_regularization_ops — per-param
    regularizer wins over the optimizer-level one."""
    params_and_grads = []
    for param, grad in parameters_and_grads:
        if grad is None:
            params_and_grads.append((param, grad))
            continue
        regularizer = getattr(param, "regularizer", None) or regularization
        if regularizer is not None and getattr(param, "is_sparse_param",
                                               False):
            raise NotImplementedError(
                "weight decay of the is_sparse table %r is not ported: its "
                "gradient is a SparseGrad (ids, rows); use is_sparse=False "
                "or regularize the other parameters" % param.name)
        if regularizer is not None:
            block = grad.block
            grad = regularizer.append_regularization_op(param, grad, block) or grad
        params_and_grads.append((param, grad))
    return params_and_grads


L1Decay = L1DecayRegularizer
L2Decay = L2DecayRegularizer
