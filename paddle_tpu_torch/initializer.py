# ported from paddle_tpu/initializer.py
"""Parameter initializers (reference: python/paddle/fluid/initializer.py).

Each initializer appends an init op to the *startup program* block holding the
parameter — same two-program structure as Fluid (default_startup_program runs
once, default_main_program runs per step).
"""

from __future__ import annotations

import contextlib
import math

import numpy as np

from .core import framework

__all__ = [
    "Constant",
    "Uniform",
    "Normal",
    "TruncatedNormal",
    "Xavier",
    "MSRA",
    "Bilinear",
    "NumpyArrayInitializer",
    "ConstantInitializer",
    "UniformInitializer",
    "NormalInitializer",
    "XavierInitializer",
    "MSRAInitializer",
]


class Initializer:
    def __call__(self, var, block):
        raise NotImplementedError

    @staticmethod
    def _fan_in_fan_out(var):
        shape = var.shape
        if len(shape) < 2:
            return (shape[0] if shape else 1,) * 2
        receptive = int(np.prod(shape[2:])) if len(shape) > 2 else 1
        fan_in = shape[1] * receptive if len(shape) > 2 else shape[0]
        fan_out = shape[0] * receptive if len(shape) > 2 else shape[1]
        return fan_in, fan_out


class ConstantInitializer(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def __call__(self, var, block):
        return block.append_op(
            "fill_constant",
            outputs={"Out": var},
            attrs={"shape": list(var.shape), "dtype": var.dtype, "value": float(self.value)},
        )


class UniformInitializer(Initializer):
    def __init__(self, low=-1.0, high=1.0, seed=0):
        self.low, self.high, self.seed = low, high, seed

    def __call__(self, var, block):
        return block.append_op(
            "uniform_random",
            outputs={"Out": var},
            attrs={
                "shape": list(var.shape),
                "dtype": var.dtype,
                "min": float(self.low),
                "max": float(self.high),
                "seed": self.seed,
            },
        )


class NormalInitializer(Initializer):
    def __init__(self, loc=0.0, scale=1.0, seed=0):
        self.loc, self.scale, self.seed = loc, scale, seed

    def __call__(self, var, block):
        return block.append_op(
            "gaussian_random",
            outputs={"Out": var},
            attrs={
                "shape": list(var.shape),
                "dtype": var.dtype,
                "mean": float(self.loc),
                "std": float(self.scale),
                "seed": self.seed,
            },
        )


class TruncatedNormalInitializer(Initializer):
    def __init__(self, loc=0.0, scale=1.0, seed=0):
        self.loc, self.scale, self.seed = loc, scale, seed

    def __call__(self, var, block):
        return block.append_op(
            "truncated_gaussian_random",
            outputs={"Out": var},
            attrs={
                "shape": list(var.shape),
                "dtype": var.dtype,
                "mean": float(self.loc),
                "std": float(self.scale),
                "seed": self.seed,
            },
        )


class XavierInitializer(Initializer):
    """Glorot init (reference: initializer.py XavierInitializer)."""

    def __init__(self, uniform=True, fan_in=None, fan_out=None, seed=0):
        self.uniform, self.fan_in, self.fan_out, self.seed = uniform, fan_in, fan_out, seed

    def __call__(self, var, block):
        fi, fo = self._fan_in_fan_out(var)
        fan_in = self.fan_in if self.fan_in is not None else fi
        fan_out = self.fan_out if self.fan_out is not None else fo
        if self.uniform:
            limit = math.sqrt(6.0 / (fan_in + fan_out))
            return UniformInitializer(-limit, limit, self.seed)(var, block)
        std = math.sqrt(2.0 / (fan_in + fan_out))
        return NormalInitializer(0.0, std, self.seed)(var, block)


class MSRAInitializer(Initializer):
    """He/Kaiming init (reference: initializer.py MSRAInitializer)."""

    def __init__(self, uniform=True, fan_in=None, seed=0):
        self.uniform, self.fan_in, self.seed = uniform, fan_in, seed

    def __call__(self, var, block):
        fi, _ = self._fan_in_fan_out(var)
        fan_in = self.fan_in if self.fan_in is not None else fi
        if self.uniform:
            limit = math.sqrt(6.0 / fan_in)
            return UniformInitializer(-limit, limit, self.seed)(var, block)
        std = math.sqrt(2.0 / fan_in)
        return NormalInitializer(0.0, std, self.seed)(var, block)


class BilinearInitializer(Initializer):
    """For conv_transpose upsampling weights."""

    def __call__(self, var, block):
        shape = var.shape
        f = math.ceil(shape[3] / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        weight = np.zeros(shape, dtype="float32")
        size = int(np.prod(shape))
        vals = np.zeros(size)
        for i in range(size):
            x = i % shape[3]
            y = (i // shape[3]) % shape[2]
            vals[i] = (1 - abs(x / f - c)) * (1 - abs(y / f - c))
        weight = vals.reshape(shape)
        return NumpyArrayInitializer(weight)(var, block)


class NumpyArrayInitializer(Initializer):
    def __init__(self, value):
        self.value = np.asarray(value)

    def __call__(self, var, block):
        return block.append_op(
            "assign_value",
            outputs={"Out": var},
            attrs={
                "shape": list(self.value.shape),
                "dtype": var.dtype,
                "values": self.value.reshape(-1).tolist(),
            },
        )


# Fluid-style aliases
Constant = ConstantInitializer
Uniform = UniformInitializer
Normal = NormalInitializer
TruncatedNormal = TruncatedNormalInitializer
Xavier = XavierInitializer
MSRA = MSRAInitializer
Bilinear = BilinearInitializer


def _global_weight_initializer():
    return XavierInitializer()


def _global_bias_initializer():
    return ConstantInitializer(0.0)


_force_init_on_cpu_flag = False


def force_init_on_cpu():
    """reference: initializer.py force_init_on_cpu — query the init-on-cpu
    flag. Initializers run in the startup program on the executor's
    device; the flag is tracked for API parity only."""
    return _force_init_on_cpu_flag


@contextlib.contextmanager
def init_on_cpu():
    """reference: initializer.py init_on_cpu context. The executor's place
    decides where initialization runs, so this only toggles the queryable
    flag."""
    global _force_init_on_cpu_flag
    prev, _force_init_on_cpu_flag = _force_init_on_cpu_flag, True
    try:
        yield
    finally:
        _force_init_on_cpu_flag = prev


__all__ += ["force_init_on_cpu", "init_on_cpu"]
