# ported from paddle_tpu/core/dtypes.py
"""Dtype canonicalization.

Fluid uses a ``VarType`` proto enum (reference: framework.proto:105); here,
as in the JAX package, dtypes are canonical numpy-style strings, and
:func:`to_torch_dtype` maps a name to the torch dtype a tensor is made in.
The names map one to one: a var declared ``int64`` is an int64 tensor (the
JAX package canonicalises it to int32 with x64 off; tests compare values,
not dtypes).
"""

from __future__ import annotations

import numpy as np
import torch

_ALIASES = {
    "float": "float32",
    "double": "float64",
    "half": "float16",
    "bf16": "bfloat16",
    "int": "int32",
    "long": "int64",
    "bool": "bool",
    "uint8": "uint8",
    "int8": "int8",
    "int16": "int16",
    "int32": "int32",
    "int64": "int64",
    "float16": "float16",
    "bfloat16": "bfloat16",
    "float32": "float32",
    "float64": "float64",
}


def convert_dtype(dtype) -> str:
    """Normalize any dtype spec (string, numpy or torch dtype) to a
    canonical string."""
    if dtype is None:
        return "float32"
    if isinstance(dtype, str):
        if dtype in _ALIASES:
            return _ALIASES[dtype]
        return np.dtype(dtype).name
    if isinstance(dtype, torch.dtype):
        return str(dtype).replace("torch.", "")
    if getattr(dtype, "name", None) == "bfloat16":
        return "bfloat16"
    return np.dtype(dtype).name


def to_torch_dtype(dtype) -> torch.dtype:
    """The torch dtype of a dtype spec."""
    return getattr(torch, convert_dtype(dtype))


def is_float_dtype(dtype) -> bool:
    return convert_dtype(dtype) in ("float16", "bfloat16", "float32", "float64")
