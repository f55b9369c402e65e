# ported from paddle_tpu/core/framework.py
"""Program/Block/Operator/Variable: the symbolic graph.

Fluid's ProgramDesc stack (reference:
``python/paddle/fluid/framework.py:242-3152``). Fluid builds a protobuf
``ProgramDesc`` that a C++ executor interprets op-by-op
(``paddle/fluid/framework/executor.cc:433``). Here, as in the JAX package,
the Program is a light, pure-Python symbolic graph; the port's Executor
interprets it op by op with torch (``paddle_tpu_torch/executor.py``).

The user-facing construction API (``program_guard``, ``Block.append_op``,
``Variable``, two global default programs) mirrors Fluid so that
reference-style training scripts port with minimal changes.
"""

from __future__ import annotations

import contextlib
import copy
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from . import unique_name
from .dtypes import convert_dtype

__all__ = [
    "Variable",
    "Parameter",
    "Operator",
    "Block",
    "Program",
    "default_main_program",
    "default_startup_program",
    "program_guard",
    "switch_main_program",
    "switch_startup_program",
    "name_scope",
    "grad_var_name",
    "in_test_mode",
]

GRAD_VAR_SUFFIX = "@GRAD"


def grad_var_name(name: str) -> str:
    """Gradient variable naming convention (reference: framework.py GRAD_VAR_SUFFIX)."""
    return name + GRAD_VAR_SUFFIX


class Variable:
    """A symbolic tensor in a Block.

    Mirrors Fluid's ``Variable`` (``framework.py:242``): a named node with
    static shape/dtype metadata. ``-1`` in ``shape`` marks a dynamic (batch)
    dimension; the Executor specializes it per feed shape (program-cache
    keyed on actual shapes, like Fluid's executor cache).
    """

    def __init__(
        self,
        block: "Block",
        name: Optional[str] = None,
        shape: Optional[Sequence[int]] = None,
        dtype: Any = "float32",
        persistable: bool = False,
        stop_gradient: bool = False,
        is_data: bool = False,
        initializer: Any = None,
        trainable: bool = True,
    ):
        self.block = block
        if name is None:
            name = unique_name.generate("_generated_var")
        self.name = name
        # None = unknown (filled by abstract-eval shape inference on append_op)
        self.shape = tuple(shape) if shape is not None else None
        self.dtype = convert_dtype(dtype)
        self.persistable = persistable
        self.stop_gradient = stop_gradient
        self.is_data = is_data
        self.initializer = initializer
        self.trainable = trainable
        # The op that produced this var during construction (for debugging).
        self.op: Optional[Operator] = None

    # -- ergonomic sugar mirroring fluid's math_op_patch.py ------------------
    def _binary_op(self, other, op_name, reverse=False):
        from ..layers import math_op_patch

        return math_op_patch.binary_op(self, other, op_name, reverse)

    def __add__(self, other):
        return self._binary_op(other, "elementwise_add")

    def __radd__(self, other):
        return self._binary_op(other, "elementwise_add", reverse=True)

    def __sub__(self, other):
        return self._binary_op(other, "elementwise_sub")

    def __rsub__(self, other):
        return self._binary_op(other, "elementwise_sub", reverse=True)

    def __mul__(self, other):
        return self._binary_op(other, "elementwise_mul")

    def __rmul__(self, other):
        return self._binary_op(other, "elementwise_mul", reverse=True)

    def __truediv__(self, other):
        return self._binary_op(other, "elementwise_div")

    def __rtruediv__(self, other):
        return self._binary_op(other, "elementwise_div", reverse=True)

    def __pow__(self, other):
        return self._binary_op(other, "elementwise_pow")

    def __neg__(self):
        from ..layers import tensor as tensor_layers

        return tensor_layers.scale(self, scale=-1.0)

    def __repr__(self):
        return "Variable(name=%s, shape=%s, dtype=%s%s)" % (
            self.name,
            self.shape,
            self.dtype,
            ", persistable" if self.persistable else "",
        )

    __str__ = __repr__


class Parameter(Variable):
    """A trainable persistable Variable (reference: framework.py:2917)."""

    def __init__(self, block, name=None, shape=None, dtype="float32", **kwargs):
        kwargs.setdefault("persistable", True)
        trainable = kwargs.pop("trainable", True)
        self.regularizer = kwargs.pop("regularizer", None)
        self.gradient_clip_attr = kwargs.pop("gradient_clip_attr", None)
        self.do_model_average = kwargs.pop("do_model_average", False)
        super().__init__(block, name=name, shape=shape, dtype=dtype, **kwargs)
        self.trainable = trainable


class Operator:
    """A symbolic op node (reference: framework.py:571).

    ``inputs``/``outputs`` map slot names to lists of variable names; ``attrs``
    is a plain dict. The actual computation lives in the op registry
    (``paddle_tpu_torch/core/registry.py``) as one torch function per op
    type — the Fluid equivalent of the ``OpKernelType``-keyed kernel map
    (``framework/op_registry.h:197``).
    """

    def __init__(
        self,
        block: "Block",
        type: str,
        inputs: Optional[Dict[str, Any]] = None,
        outputs: Optional[Dict[str, Any]] = None,
        attrs: Optional[Dict[str, Any]] = None,
    ):
        self.block = block
        self.type = type
        self.inputs: Dict[str, List[str]] = {}
        self.outputs: Dict[str, List[str]] = {}
        self.attrs: Dict[str, Any] = dict(attrs or {})

        def _canon(slot_map, store):
            for slot, vars_ in (slot_map or {}).items():
                if vars_ is None:
                    continue
                if isinstance(vars_, (Variable, str)):
                    vars_ = [vars_]
                names = []
                for v in vars_:
                    names.append(v.name if isinstance(v, Variable) else str(v))
                store[slot] = names

        _canon(inputs, self.inputs)
        _canon(outputs, self.outputs)

    def input(self, slot: str) -> List[str]:
        return self.inputs.get(slot, [])

    def output(self, slot: str) -> List[str]:
        return self.outputs.get(slot, [])

    @property
    def input_arg_names(self):
        return [n for ns in self.inputs.values() for n in ns]

    @property
    def output_arg_names(self):
        return [n for ns in self.outputs.values() for n in ns]

    def attr(self, name: str, default=None):
        return self.attrs.get(name, default)

    def _rename_input(self, old: str, new: str):
        """Replace every occurrence of input var ``old`` with ``new``
        (reference: framework.py Operator._rename_input; used by Program
        rewrite passes like the quantize transpiler)."""
        for slot, names in self.inputs.items():
            self.inputs[slot] = [new if n == old else n for n in names]
        self.block.program._version += 1

    def _rename_output(self, old: str, new: str):
        for slot, names in self.outputs.items():
            self.outputs[slot] = [new if n == old else n for n in names]
        self.block.program._version += 1

    def __repr__(self):
        ins = {k: v for k, v in self.inputs.items()}
        outs = {k: v for k, v in self.outputs.items()}
        return "{%s} = %s(%s) attrs=%s" % (outs, self.type, ins, self.attrs)


class Block:
    """An ordered list of ops plus a var symbol table (reference: framework.py:1020)."""

    def __init__(self, program: "Program", idx: int, parent_idx: int = -1):
        self.program = program
        self.idx = idx
        self.parent_idx = parent_idx
        self.vars: Dict[str, Variable] = {}
        self.ops: List[Operator] = []

    @property
    def parent_block(self) -> Optional["Block"]:
        if self.parent_idx < 0:
            return None
        return self.program.blocks[self.parent_idx]

    def create_var(self, **kwargs) -> Variable:
        var = Variable(self, **kwargs)
        self.vars[var.name] = var
        return var

    def create_parameter(self, **kwargs) -> Parameter:
        param = Parameter(self, **kwargs)
        self.vars[param.name] = param
        return param

    def var(self, name: str) -> Variable:
        v = self._find_var_recursive(name)
        if v is None:
            raise ValueError("Variable %r not found in block %d" % (name, self.idx))
        return v

    def has_var(self, name: str) -> bool:
        return self._find_var_recursive(name) is not None

    def _find_var_recursive(self, name: str) -> Optional[Variable]:
        blk: Optional[Block] = self
        while blk is not None:
            if name in blk.vars:
                return blk.vars[name]
            blk = blk.parent_block
        return None

    def append_op(self, type: str, inputs=None, outputs=None, attrs=None) -> Operator:
        op = Operator(self, type, inputs=inputs, outputs=outputs, attrs=attrs)
        self.ops.append(op)
        for slot in op.outputs.values():
            for name in slot:
                if name in self.vars:
                    self.vars[name].op = op
        self.program._version += 1
        # calc_gradient sets its output shapes itself; abstractly executing it
        # would eval_shape-retrace the whole forward prefix per call.
        if type not in ("backward_marker", "calc_gradient"):
            from .shape_inference import infer_op_shapes

            infer_op_shapes(op, self)
        return op

    def prepend_op(self, type: str, inputs=None, outputs=None, attrs=None) -> Operator:
        op = Operator(self, type, inputs=inputs, outputs=outputs, attrs=attrs)
        self.ops.insert(0, op)
        self.program._version += 1
        return op

    def insert_op(self, index: int, type: str, inputs=None, outputs=None,
                  attrs=None) -> Operator:
        """Insert an op at position ``index`` (reference: block._insert_op —
        the primitive Program-rewrite passes build on)."""
        op = Operator(self, type, inputs=inputs, outputs=outputs, attrs=attrs)
        self.ops.insert(index, op)
        for slot in op.outputs.values():
            for name in slot:
                if name in self.vars:
                    self.vars[name].op = op
        self.program._version += 1
        from .shape_inference import infer_op_shapes

        infer_op_shapes(op, self)
        return op

    def remove_op(self, index: int):
        del self.ops[index]
        self.program._version += 1

    def all_parameters(self) -> List[Parameter]:
        return [v for v in self.vars.values() if isinstance(v, Parameter)]

    def __repr__(self):
        lines = ["Block(idx=%d, parent=%d)" % (self.idx, self.parent_idx)]
        for v in self.vars.values():
            lines.append("  " + repr(v))
        for op in self.ops:
            lines.append("  " + repr(op))
        return "\n".join(lines)


class Program:
    """The model+training-loop graph (reference: framework.py:2284).

    Unlike Fluid there is no protobuf serialization of the graph itself;
    state crosses as arrays (``paddle_tpu_torch/io.py``).
    """

    def __init__(self):
        self.blocks: List[Block] = [Block(self, 0)]
        self.current_block_idx = 0
        self._version = 0  # bumped on mutation; executor cache key component
        self._seed = 0
        # Filled by append_backward: {'loss': name, 'param_to_grad': {p: g}}
        self._backward_info: Optional[Dict[str, Any]] = None
        # Optimization metadata (lr scheduler var names etc.)
        self._lr_var_name: Optional[str] = None
        # PyReaders bound to this program's data vars (layers.io.py_reader);
        # the Executor drains one batch per run. Not carried by clone().
        self._py_readers: List[Any] = []

    # -- block management -----------------------------------------------------
    @property
    def global_block(self) -> Block:
        return self.blocks[0]

    def current_block(self) -> Block:
        return self.blocks[self.current_block_idx]

    def _create_block(self, parent_idx: Optional[int] = None) -> Block:
        parent = self.current_block_idx if parent_idx is None else parent_idx
        blk = Block(self, len(self.blocks), parent)
        self.blocks.append(blk)
        self.current_block_idx = blk.idx
        return blk

    def _rollback(self):
        self.current_block_idx = self.current_block().parent_idx

    @property
    def random_seed(self):
        return self._seed

    @random_seed.setter
    def random_seed(self, seed):
        self._seed = int(seed)
        # seed is baked into compiled steps — invalidate cached specializations
        self._version += 1

    def all_parameters(self) -> List[Parameter]:
        params = []
        for blk in self.blocks:
            params.extend(blk.all_parameters())
        return params

    def list_vars(self):
        for blk in self.blocks:
            for v in blk.vars.values():
                yield v

    def clone(self, for_test: bool = False) -> "Program":
        """Structural copy (reference: Program.clone framework.py:2669).

        ``for_test=True`` flips ``is_test`` attrs (dropout/batch_norm switch to
        inference behavior) and prunes backward/optimize ops.
        """
        p = Program()
        p._seed = self._seed
        p.blocks = []
        for blk in self.blocks:
            nb = Block(p, blk.idx, blk.parent_idx)
            for name, v in blk.vars.items():
                nv = copy.copy(v)
                nv.block = nb
                nb.vars[name] = nv
            for op in blk.ops:
                if for_test and op.type == "backward_marker":
                    # Everything from the marker on (grad clip, regularizer,
                    # optimizer ops) reads @GRAD vars — drop it all.
                    break
                no = Operator(nb, op.type, attrs=copy.deepcopy(op.attrs))
                no.inputs = copy.deepcopy(op.inputs)
                no.outputs = copy.deepcopy(op.outputs)
                if for_test and "is_test" in no.attrs:
                    no.attrs["is_test"] = True
                nb.ops.append(no)
            p.blocks.append(nb)
        if not for_test:
            p._backward_info = copy.deepcopy(self._backward_info)
            p._lr_var_name = self._lr_var_name
        # AMP mode survives cloning — an inference clone of an amp-decorated
        # program must still run its forward in the low-precision dtype.
        p._amp_dtype = getattr(self, "_amp_dtype", None)
        p._version = self._version
        return p

    def to_string(self) -> str:
        return "\n".join(repr(b) for b in self.blocks)

    __str__ = to_string
    __repr__ = to_string


# Op types considered "optimize ops" for clone(for_test=True) pruning.
OPTIMIZER_OP_TYPES = (
    "sgd",
    "momentum",
    "adam",
    "adamw",
    "adamax",
    "adagrad",
    "adadelta",
    "decayed_adagrad",
    "rmsprop",
    "ftrl",
    "lars_momentum",
    "lamb",
)


# -- global default programs (reference: framework.py:3001,3019) --------------
_main_program = Program()
_startup_program = Program()


def default_main_program() -> Program:
    return _main_program


def default_startup_program() -> Program:
    return _startup_program


def switch_main_program(program: Program) -> Program:
    global _main_program
    prev, _main_program = _main_program, program
    return prev


def switch_startup_program(program: Program) -> Program:
    global _startup_program
    prev, _startup_program = _startup_program, program
    return prev


@contextlib.contextmanager
def program_guard(main_program: Program, startup_program: Optional[Program] = None):
    """Scoped redirection of the default programs (reference: framework.py:3069)."""
    prev_main = switch_main_program(main_program)
    prev_startup = None
    if startup_program is not None:
        prev_startup = switch_startup_program(startup_program)
    try:
        yield
    finally:
        switch_main_program(prev_main)
        if prev_startup is not None:
            switch_startup_program(prev_startup)


_name_scope_stack: List[str] = []


@contextlib.contextmanager
def name_scope(prefix: str):
    """Cosmetic op-name scoping; maps onto jax.named_scope at trace time."""
    _name_scope_stack.append(prefix)
    try:
        yield
    finally:
        _name_scope_stack.pop()


def current_name_scope() -> str:
    return "/".join(_name_scope_stack)


_test_mode = False


@contextlib.contextmanager
def test_mode():
    global _test_mode
    prev, _test_mode = _test_mode, True
    try:
        yield
    finally:
        _test_mode = prev


def in_test_mode() -> bool:
    return _test_mode
