# ported from paddle_tpu/core/serialization.py
"""Program serialization.

Fluid serializes the graph as a protobuf ``ProgramDesc``
(``framework/framework.proto:184``). The Program here is pure Python; it
serializes to a stable JSON desc (human-readable, versioned), the same
desc as the JAX package's, key for key, so either package reads a desc
the other wrote. The desc carries no AMP mode: a program loaded from it
runs in float32 until ``amp.enable`` is called on it.
"""

from __future__ import annotations

import json
from typing import Any, Dict

from .framework import Block, Operator, Parameter, Program, Variable

FORMAT_VERSION = 1


def program_to_desc(program: Program) -> Dict[str, Any]:
    blocks = []
    for blk in program.blocks:
        vars_ = []
        for v in blk.vars.values():
            vars_.append(
                {
                    "name": v.name,
                    "shape": list(v.shape) if v.shape is not None else None,
                    "dtype": v.dtype,
                    "persistable": v.persistable,
                    "stop_gradient": v.stop_gradient,
                    "is_data": v.is_data,
                    "trainable": v.trainable,
                    "is_parameter": isinstance(v, Parameter),
                }
            )
        ops = []
        for op in blk.ops:
            ops.append(
                {
                    "type": op.type,
                    "inputs": op.inputs,
                    "outputs": op.outputs,
                    "attrs": op.attrs,
                }
            )
        blocks.append({"idx": blk.idx, "parent_idx": blk.parent_idx, "vars": vars_, "ops": ops})
    return {
        "format_version": FORMAT_VERSION,
        "random_seed": program._seed,
        "backward_info": program._backward_info,
        "lr_var_name": program._lr_var_name,
        "blocks": blocks,
    }


def desc_to_program(desc: Dict[str, Any]) -> Program:
    if desc.get("format_version") != FORMAT_VERSION:
        raise ValueError("unsupported program format version: %r" % desc.get("format_version"))
    program = Program()
    program._seed = desc.get("random_seed", 0)
    program._backward_info = desc.get("backward_info")
    program._lr_var_name = desc.get("lr_var_name")
    program.blocks = []
    for bdesc in desc["blocks"]:
        blk = Block(program, bdesc["idx"], bdesc["parent_idx"])
        for vdesc in bdesc["vars"]:
            cls = Parameter if vdesc.get("is_parameter") else Variable
            v = cls(
                blk,
                name=vdesc["name"],
                shape=vdesc["shape"],
                dtype=vdesc["dtype"],
                persistable=vdesc["persistable"],
                stop_gradient=vdesc["stop_gradient"],
            )
            v.is_data = vdesc.get("is_data", False)
            v.trainable = vdesc.get("trainable", True)
            blk.vars[v.name] = v
        for odesc in bdesc["ops"]:
            op = Operator(blk, odesc["type"], attrs=odesc["attrs"])
            op.inputs = {k: list(v) for k, v in odesc["inputs"].items()}
            op.outputs = {k: list(v) for k, v in odesc["outputs"].items()}
            blk.ops.append(op)
        program.blocks.append(blk)
    program._version += 1
    return program


def dumps(program: Program) -> str:
    return json.dumps(program_to_desc(program))


def loads(s: str) -> Program:
    return desc_to_program(json.loads(s))
