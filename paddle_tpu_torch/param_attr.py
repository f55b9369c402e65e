# ported from paddle_tpu/param_attr.py
"""``fluid.param_attr`` module alias (reference:
python/paddle/fluid/param_attr.py) — the classes live with LayerHelper."""

from .layers.layer_helper import ParamAttr, WeightNormParamAttr  # noqa: F401

__all__ = ["ParamAttr", "WeightNormParamAttr"]
