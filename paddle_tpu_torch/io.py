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

The rotating checkpoints (:func:`save_checkpoint`, :func:`load_checkpoint`,
:func:`clean_checkpoint`, :class:`CheckpointConfig`) follow the JAX
package's line for line: ``checkpoint_<serial>/`` directories of
``save_persistables`` files, ``trainer_args.json`` and a ``_SUCCESS``
mark, staged per trainer and process, fsync'd, published by one
``os.replace``, rotated by trainer 0 only, with the fault site
``io.save_checkpoint``. A checkpoint written by either package loads in
the other.

A bit-equal resume needs one more thing from the caller: the executor
seeds each random op from (seed, step, op), and the step counts on the
program (``program._tpu_step_counter``), not in the scope, so after
:func:`load_checkpoint` set ``main._tpu_step_counter =
trainer_args["step"]`` (the step the checkpoint was saved after), as the
JAX package's supervisor does. :func:`load_checkpoint` does not set it,
as the JAX package's does not.
"""

from __future__ import annotations

import glob
import json
import os
import re
import shutil
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
    "CheckpointConfig",
    "save_checkpoint",
    "load_checkpoint",
    "clean_checkpoint",
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


# -- rotating checkpoints + preemption resume ---------------------------------
# (reference: contrib/trainer.py CheckpointConfig:100 + the Trainer's
# _save_checkpoint/_load_checkpoint)

_CKPT_PREFIX = "checkpoint_"
_SUCCESS_MARK = "_SUCCESS"


class CheckpointConfig:
    """reference: contrib/trainer.py:100."""

    def __init__(self, checkpoint_dir=None, max_num_checkpoints=3,
                 epoch_interval=1, step_interval=10):
        self.checkpoint_dir = checkpoint_dir or os.getcwd()
        self.max_num_checkpoints = max_num_checkpoints
        self.epoch_interval = epoch_interval
        self.step_interval = step_interval


def _fsync_path(path):
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _fsync_tree(dirpath):
    """fsync every file under ``dirpath`` and the directories themselves:
    without it a host crash between the write and the ``os.replace``
    publish can leave a _SUCCESS-marked checkpoint whose tensor payloads
    were still unflushed page cache. Best-effort on filesystems without
    fsync semantics."""
    try:
        for root, dirs, files in os.walk(dirpath):
            for name in files:
                _fsync_path(os.path.join(root, name))
            for name in dirs:
                _fsync_path(os.path.join(root, name))
        _fsync_path(dirpath)
    except OSError:
        pass


def _checkpoint_serials(checkpoint_dir):
    if not os.path.isdir(checkpoint_dir):
        return []
    serials = []
    for name in os.listdir(checkpoint_dir):
        if name.startswith(_CKPT_PREFIX):
            try:
                serials.append(int(name[len(_CKPT_PREFIX):]))
            except ValueError:
                continue
    return sorted(serials)


def save_checkpoint(executor, checkpoint_dir, main_program=None,
                    trainer_id=0, trainer_args=None, max_num_checkpoints=3):
    """Write a new serial-numbered checkpoint of all persistables of the
    global scope, durably and atomically: the param files, trainer_args
    and the _SUCCESS mark land in a staging dir, everything is fsync'd
    (files and directories), then one ``os.replace`` publishes the
    serial. Only ``trainer_id == 0`` rotates, so concurrent savers cannot
    delete each other's serials. ``trainer_args`` (e.g. {'step': 123,
    'epoch': 4}) are stored for the resume. Returns the serial."""
    serials = _checkpoint_serials(checkpoint_dir)
    serial = (serials[-1] + 1) if serials else 0
    final = os.path.join(checkpoint_dir, _CKPT_PREFIX + str(serial))
    # per trainer and process: two trainers racing to one serial stage into
    # different dirs, so neither removes the other's half-written payload
    tmp = "%s.tmp.%d.%d" % (final, trainer_id, os.getpid())
    if os.path.isdir(tmp):
        shutil.rmtree(tmp)
    save_persistables(executor, tmp, main_program)
    # chaos drills: a fault here leaves an unpublished staging dir, the
    # torn write load_checkpoint must skip
    from .reliability import faults as _faults

    _faults.fire("io.save_checkpoint")
    with open(os.path.join(tmp, "trainer_args.json"), "w") as f:
        json.dump({"trainer_id": trainer_id, **(trainer_args or {})}, f)
    with open(os.path.join(tmp, _SUCCESS_MARK), "w") as f:
        f.write("ok")
        f.flush()
        os.fsync(f.fileno())
    _fsync_tree(tmp)
    try:
        os.replace(tmp, final)
    except OSError:
        # lost the publish race: a peer published this serial (the same
        # state: savers hold replicas); its checkpoint serves the resume
        shutil.rmtree(tmp, ignore_errors=True)
        if not os.path.isfile(os.path.join(final, _SUCCESS_MARK)):
            raise
        return serial
    # publish barrier: the rename itself must survive a crash
    try:
        _fsync_path(checkpoint_dir)
    except OSError:
        pass
    if trainer_id == 0:
        serials.append(serial)
        for old in (serials[:-max_num_checkpoints]
                    if max_num_checkpoints > 0 else []):
            shutil.rmtree(
                os.path.join(checkpoint_dir, _CKPT_PREFIX + str(old)),
                ignore_errors=True)
    return serial


def load_checkpoint(executor, checkpoint_dir, main_program=None, serial=None):
    """Restore the latest complete checkpoint (or ``serial``) into the
    global scope, on ``executor.place``; returns the stored trainer_args
    dict, or None when no valid checkpoint exists (train from scratch).

    A serial without _SUCCESS (preempted mid-save) is skipped. One that is
    _SUCCESS-marked but unreadable (a truncated tensor file) is logged and
    skipped for the serial before it, whose full ``load_persistables``
    overwrites any var the failed one set; when every marked serial fails
    this raises.

    The step counter is the caller's to set (module docstring):
    ``main._tpu_step_counter = trainer_args["step"]``."""
    from .log import vlog

    serials = _checkpoint_serials(checkpoint_dir)
    candidates = [serial] if serial is not None else list(reversed(serials))
    last_exc = None
    for s in candidates:
        d = os.path.join(checkpoint_dir, _CKPT_PREFIX + str(s))
        if not os.path.isfile(os.path.join(d, _SUCCESS_MARK)):
            continue  # partial write (preempted mid-save)
        try:
            load_persistables(executor, d, main_program)
        except Exception as e:
            last_exc = e
            vlog(0, "load_checkpoint: serial %d is _SUCCESS-marked but "
                    "unreadable (%s: %s); falling back to the previous "
                    "serial", s, type(e).__name__, e)
            continue
        try:
            with open(os.path.join(d, "trainer_args.json")) as f:
                return json.load(f)
        except FileNotFoundError:
            return {}
    if last_exc is not None:
        raise RuntimeError(
            "load_checkpoint: no readable checkpoint in %r (all "
            "_SUCCESS-marked serials failed to restore; last error: %s: %s)"
            % (checkpoint_dir, type(last_exc).__name__, last_exc)
        ) from last_exc
    return None


def clean_checkpoint(checkpoint_dir, delete_dir=False):
    """reference: io.py clean_checkpoint."""
    for s in _checkpoint_serials(checkpoint_dir):
        shutil.rmtree(os.path.join(checkpoint_dir, _CKPT_PREFIX + str(s)),
                      ignore_errors=True)
    if delete_dir and os.path.isdir(checkpoint_dir):
        try:
            os.rmdir(checkpoint_dir)
        except OSError:
            pass
