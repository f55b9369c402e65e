# ported from paddle_tpu/io.py
"""Model IO (reference: python/paddle/fluid/io.py:92-1015).

Fluid builds tiny save/load programs of ``save``/``load_combine`` ops
(``operators/save_op.cc``, ``load_combine_op.cc:143``) that serialize
LoDTensors. Here, as in the JAX package, the scope's tensors are written
as numpy files (one ``.npy`` per var, or one combined ``.npz``) beside an
``__index__.json``, and the inference artifact is the pruned Program's
JSON desc (``__model__``) plus its params. The files are the JAX
package's, name for name and key for key, so a model saved by either
package loads in the other.

Two things differ from the JAX package, both because the scope holds
torch tensors on a device:

* :func:`save_vars` copies each tensor to the host and raises on a dtype
  that numpy cannot hold (bfloat16) instead of converting it;
* :func:`load_vars` puts each array on the executor's device (the card for
  ``Executor()``, the CPU for ``Executor(CPUPlace())``), where the JAX
  package ignores ``executor``.

:func:`state_from_numpy` carries the JAX package's in-memory state into a
port scope: the JAX package initialises weights with threefry, which torch
cannot redraw, so a run that must start from the same weights copies them
(``np.asarray(jax_scope.find_var(name))`` for each). Both packages build
programs with the same layer functions and the same name generator, so
their var names match one for one.

Left out against the JAX package: the rotating checkpoints and preemption
resume (``CheckpointConfig``, ``save_checkpoint``, ``load_checkpoint``).
"""

from __future__ import annotations

import glob
import json
import os
import re
from typing import List, Mapping, Optional, Sequence

import numpy as np
import torch

from .core import serialization
from .core.dtypes import to_torch_dtype
from .core.framework import Parameter, Program, Variable, default_main_program
from .core.place import resolve_device
from .core.scope import Scope, global_scope

__all__ = [
    "save_vars",
    "save_params",
    "save_persistables",
    "load_vars",
    "load_params",
    "load_persistables",
    "prune_program",
    "save_inference_model",
    "load_inference_model",
    "state_from_numpy",
]

_COMBINED_DEFAULT = "__params__"
_MODEL_FILENAME = "__model__"


def _target_vars(main_program: Optional[Program], predicate) -> List[Variable]:
    program = main_program or default_main_program()
    out = []
    seen = set()
    for v in program.list_vars():
        if v.name in seen:
            continue
        if predicate(v):
            out.append(v)
            seen.add(v.name)
    return out


def _is_persistable(v: Variable) -> bool:
    return v.persistable and not v.is_data


def _is_parameter(v: Variable) -> bool:
    return isinstance(v, Parameter)


def _host_copy(name: str, val) -> np.ndarray:
    """A host copy of a scope value. A copy, not a view: the sparse
    optimizer kernels update their tables in place, so a view of a CPU
    tensor would change under the saved array."""
    if isinstance(val, torch.Tensor):
        if val.dtype == torch.bfloat16:
            raise TypeError(
                "save_vars: %r is bfloat16, which numpy cannot hold; cast it "
                "to float32 in the program before saving" % name)
        return val.detach().cpu().numpy().copy()
    return np.array(val, copy=True)


def save_vars(executor, dirname, main_program=None, vars=None, predicate=None, filename=None):
    """reference: io.py:92 — saves to one .npy per var, or a combined .npz."""
    scope = global_scope()
    if vars is None:
        vars = _target_vars(main_program, predicate or _is_persistable)
    os.makedirs(dirname, exist_ok=True)
    arrays = {}
    for v in vars:
        name = v.name if isinstance(v, Variable) else str(v)
        val = scope.find_var(name)
        if val is None:
            raise RuntimeError("save_vars: %r not found in scope (run startup first)" % name)
        arrays[name] = _host_copy(name, val)
    if filename is None:
        for name, arr in arrays.items():
            np.save(os.path.join(dirname, name.replace("/", "__") + ".npy"), arr)
        index = {"vars": sorted(arrays), "combined": None}
    else:
        np.savez(os.path.join(dirname, filename + ".npz"), **arrays)
        index = {"vars": sorted(arrays), "combined": filename}
    with open(os.path.join(dirname, "__index__.json"), "w") as f:
        json.dump(index, f)


def save_params(executor, dirname, main_program=None, filename=None):
    """reference: io.py save_params — trainable Parameters only."""
    save_vars(executor, dirname, main_program, predicate=_is_parameter, filename=filename)


def save_persistables(executor, dirname, main_program=None, filename=None):
    """reference: io.py:441 — all persistables (params + optimizer state +
    BN stats + counters), sufficient for exact training resume."""
    save_vars(executor, dirname, main_program, predicate=_is_persistable, filename=filename)


def load_vars(executor, dirname, main_program=None, vars=None, predicate=None, filename=None):
    """reference: io.py load_vars. Each array goes into the global scope as
    a tensor on ``executor.place`` (the card when ``executor`` is None)."""
    scope = global_scope()
    device = resolve_device(getattr(executor, "place", None))
    with open(os.path.join(dirname, "__index__.json")) as f:
        index = json.load(f)
    if vars is not None:
        wanted = [v.name if isinstance(v, Variable) else str(v) for v in vars]
    elif predicate is not None or main_program is not None:
        wanted = [v.name for v in _target_vars(main_program, predicate or _is_persistable)]
    else:
        wanted = index["vars"]
    if index.get("combined"):
        data = np.load(os.path.join(dirname, index["combined"] + ".npz"))
        store = {n: data[n] for n in data.files}
    else:
        store = None

    def _lookup(name):
        if store is not None:
            return store.get(name)
        path = os.path.join(dirname, name.replace("/", "__") + ".npy")
        return np.load(path) if os.path.exists(path) else None

    missing = []
    for name in wanted:
        arr = _lookup(name)
        if arr is None and "_qkv" in name:
            # attention stores ONE merged qkv projection; checkpoints of
            # earlier builds hold three separate q/k/v weights (and adam
            # moments) — concat them on load. [d_in, d'] x3 -> [d_in, 3d'].
            parts = [_lookup(name.replace("_qkv", s, 1))
                     for s in ("_q", "_k", "_v")]
            if all(p is not None for p in parts):
                arr = np.concatenate(parts, axis=1)
        if arr is None:
            # Adam keeps ONE shared beta-pow pair (earlier builds kept
            # per-param scalars). Either way, every pow var of the same beta
            # is numerically identical — fill a missing one from any
            # checkpointed sibling.
            m = re.search(r"_(adam\w*)_(beta[12]_pow_acc)", name)
            if m is not None:
                pat = "_%s_%s" % (m.group(1), m.group(2))
                if store is not None:
                    cands = [store[k] for k in store if pat in k]
                else:
                    cands = [np.load(h) for h in glob.glob(os.path.join(
                        dirname, "*%s*.npy" % pat.replace("/", "__")))]
                if cands:
                    # refuse ambiguity: with several Adam instances at
                    # different step counts the siblings differ — silently
                    # picking one would skew bias correction on resume
                    if any(not np.array_equal(c, cands[0]) for c in cands[1:]):
                        raise RuntimeError(
                            "load_vars: cannot migrate %r — checkpoint holds "
                            "multiple distinct %s values (several Adam "
                            "instances?); rename or load explicitly"
                            % (name, pat))
                    arr = cands[0]
        if arr is None:
            missing.append(name)
            continue
        scope.set_var(name, torch.tensor(arr, device=device))
    if missing:
        raise RuntimeError("load_vars: missing from checkpoint: %s" % missing)
    (main_program if main_program is not None
     else default_main_program())._version += 1


def load_params(executor, dirname, main_program=None, filename=None):
    load_vars(executor, dirname, main_program, predicate=_is_parameter, filename=filename)


def load_persistables(executor, dirname, main_program=None, filename=None):
    """reference: io.py:658."""
    load_vars(executor, dirname, main_program, predicate=_is_persistable, filename=filename)


# -- program pruning ----------------------------------------------------------


def prune_program(program: Program, feed_names: Sequence[str], target_names: Sequence[str]) -> Program:
    """Reverse-reachability prune of block 0 to the feed→target subgraph
    (reference: framework/prune.cc via Program._prune)."""
    pruned = program.clone(for_test=True)
    block = pruned.global_block
    needed = set(target_names)
    kept = []
    for op in reversed(block.ops):
        if any(o in needed for o in op.output_arg_names):
            kept.append(op)
            needed.update(op.input_arg_names)
    kept.reverse()
    block.ops = kept
    referenced = set(feed_names) | set(target_names)
    for op in kept:
        referenced.update(op.input_arg_names)
        referenced.update(op.output_arg_names)
    block.vars = {n: v for n, v in block.vars.items() if n in referenced}
    pruned._version += 1
    return pruned


def save_inference_model(
    dirname,
    feeded_var_names: Sequence[str],
    target_vars: Sequence[Variable],
    executor,
    main_program: Optional[Program] = None,
    model_filename: Optional[str] = None,
    params_filename: Optional[str] = None,
    export_for_deployment: bool = True,
):
    """reference: io.py:863 — prunes to the inference subgraph, embeds
    feed/fetch names, and saves the params the subgraph needs."""
    program = main_program or default_main_program()
    target_names = [v.name if isinstance(v, Variable) else str(v) for v in target_vars]
    pruned = prune_program(program, feeded_var_names, target_names)
    desc = serialization.program_to_desc(pruned)
    desc["feed_names"] = list(feeded_var_names)
    desc["fetch_names"] = target_names
    os.makedirs(dirname, exist_ok=True)
    with open(os.path.join(dirname, model_filename or _MODEL_FILENAME), "w") as f:
        json.dump(desc, f)
    needed_params = [
        v for v in pruned.global_block.vars.values() if v.persistable and not v.is_data
    ]
    save_vars(executor, dirname, vars=needed_params, filename=params_filename or _COMBINED_DEFAULT)
    return target_names


def load_inference_model(dirname, executor, model_filename=None, params_filename=None):
    """reference: io.py:1015 — returns (program, feed_names, fetch_names);
    the params go into the global scope on ``executor.place``."""
    with open(os.path.join(dirname, model_filename or _MODEL_FILENAME)) as f:
        desc = json.load(f)
    program = serialization.desc_to_program(desc)
    load_vars(executor, dirname, vars=None, filename=params_filename or _COMBINED_DEFAULT)
    return program, desc.get("feed_names", []), desc.get("fetch_names", [])


# -- the JAX package's state, in memory ---------------------------------------


def state_from_numpy(program, arrays: Mapping[str, np.ndarray],
                     scope: Optional[Scope] = None, place=None) -> Scope:
    """Set every persistable var of ``program`` in ``scope`` (the global
    scope by default) from ``arrays``, as a tensor on ``place`` (the card
    by default) in the var's declared dtype. Raises ``KeyError`` when a
    persistable var has no array and ``ValueError`` when an array's shape
    is not the var's. Arrays for other names are not read. Returns the
    scope."""
    dev = resolve_device(place)
    scope = global_scope() if scope is None else scope
    persistables = {v.name: v for v in program.list_vars() if v.persistable}
    missing = sorted(n for n in persistables if n not in arrays)
    if missing:
        raise KeyError("no array for persistable vars %s" % missing)
    for name, var in sorted(persistables.items()):
        arr = np.asarray(arrays[name])
        if var.shape is not None and tuple(arr.shape) != tuple(var.shape):
            raise ValueError("%s: array shape %s, var shape %s"
                             % (name, tuple(arr.shape), tuple(var.shape)))
        if arr.dtype.name == "bfloat16":  # ml_dtypes: torch cannot read it
            arr = arr.astype(np.float32)
        scope.set_var(name, torch.tensor(arr).to(
            device=dev, dtype=to_torch_dtype(var.dtype)))
    return scope
