# ported from paddle_tpu/layers/control_flow.py
"""Control-flow layers: of the JAX package's module the comparisons
(``less_than`` ... ``not_equal``), the logical layers (``logical_xor`` is a generated wrapper,
:mod:`.layer_function_generator`), ``increment``,
which the learning-rate schedules and the unfused attention's segment-id
lowering (:func:`.attention._segment_bias`) read, and ``DynamicRNN``.
``While``, ``cond``, ``StaticRNN``, ``IfElse`` and ``Switch`` are not
ported yet (ROADMAP Queue 1 item 5)."""

from __future__ import annotations

import contextlib
from typing import List, Optional, Tuple

from ..core import unique_name
from ..core.framework import Variable, default_main_program
from . import tensor as tl
from .layer_helper import LayerHelper

__all__ = ["DynamicRNN", "less_than", "less_equal", "greater_than",
           "greater_equal", "equal", "not_equal", "logical_and",
           "logical_or", "logical_not", "increment"]


def _cmp_layer(op_type, x, y, cond=None):
    helper = LayerHelper(op_type)
    if cond is None:
        cond = helper.create_variable_for_type_inference("bool")
    helper.append_op(op_type, inputs={"X": x, "Y": y}, outputs={"Out": cond})
    return cond


def less_than(x, y, cond=None, force_cpu=None):
    return _cmp_layer("less_than", x, y, cond)


def less_equal(x, y, cond=None):
    return _cmp_layer("less_equal", x, y, cond)


def greater_than(x, y, cond=None):
    return _cmp_layer("greater_than", x, y, cond)


def greater_equal(x, y, cond=None):
    return _cmp_layer("greater_equal", x, y, cond)


def equal(x, y, cond=None):
    return _cmp_layer("equal", x, y, cond)


def not_equal(x, y, cond=None):
    return _cmp_layer("not_equal", x, y, cond)


def logical_and(x, y, out=None):
    return _cmp_layer("logical_and", x, y, out)


def logical_or(x, y, out=None):
    return _cmp_layer("logical_or", x, y, out)


def logical_not(x, out=None):
    helper = LayerHelper("logical_not")
    if out is None:
        out = helper.create_variable_for_type_inference("bool")
    helper.append_op("logical_not", inputs={"X": x}, outputs={"Out": out})
    return out


increment = tl.increment


class DynamicRNN:
    """Variable-length RNN over padded batch-major inputs
    (reference: control_flow.py:1394).

    Fluid's DynamicRNN sorts sequences by length (lod_rank_table), converts
    LoD tensors to step arrays (lod_tensor_to_array) and SHRINKS the live
    batch as shorter sequences finish (shrink_rnn_memory). As in the JAX
    package the full padded batch runs every step and is masked instead:
    carried memories freeze and step outputs are zeroed for rows where
    t ≥ length — identical results at constant shapes (see
    ops/rnn_ops.py dynamic_rnn_op, one run of the block a timestep).

        drnn = fluid.layers.DynamicRNN()
        with drnn.block():
            word = drnn.step_input(sentence, length=sent_len)  # [B,T,D] → [B,D]
            prev = drnn.memory(shape=[H], value=0.0)           # [B,H] zeros
            h = fluid.layers.fc([word, prev], size=H, act='tanh')
            drnn.update_memory(prev, h)
            drnn.output(h)
        out = drnn()                                           # [B,T,H]
    """

    def __init__(self, name: Optional[str] = None):
        self.helper = LayerHelper("dynamic_rnn", name=name)
        self._sub_block = None
        self._parent_block = None
        self._step_inputs: List[Tuple[str, str]] = []
        self._static_inputs: List[Tuple[str, str]] = []
        self._memories: List[list] = []
        self._mem_inits_deferred: List[Tuple[str, list, float, str]] = []
        self._step_outputs: List[Variable] = []
        self._outputs: List[Variable] = []
        self._final_states: List[Variable] = []
        self._length: Optional[Variable] = None
        self._max_len = None
        self._in_block = False

    @contextlib.contextmanager
    def block(self):
        program = default_main_program()
        self._parent_block = program.current_block()
        self._sub_block = program._create_block()
        self._in_block = True
        try:
            yield
        except BaseException:
            self._in_block = False
            program._rollback()
            raise  # don't mask the user's error with a _complete() one
        else:
            self._in_block = False
            program._rollback()
            self._complete()

    def step_input(self, x: Variable, length: Optional[Variable] = None) -> Variable:
        """x: padded [B, T, ...]; returns the per-step view [B, ...]."""
        if x.shape is None or len(x.shape) < 2:
            raise ValueError("DynamicRNN.step_input needs a [B, T, ...] Variable")
        if self._max_len is None:
            self._max_len = x.shape[1]
        if length is not None:
            self._length = length
        inner = self._sub_block.create_var(
            name=unique_name.generate("drnn_step_in"),
            dtype=x.dtype, shape=(x.shape[0],) + tuple(x.shape[2:]))
        self._step_inputs.append((x.name, inner.name))
        return inner

    def static_input(self, x: Variable) -> Variable:
        """Non-sequence input visible whole at every step (reference:
        DynamicRNN.static_input — there it is rank-sorted; here it is simply
        closed over, batch order never changes)."""
        inner = self._sub_block.create_var(
            name=unique_name.generate("drnn_static_in"),
            dtype=x.dtype, shape=x.shape)
        self._static_inputs.append((x.name, inner.name))
        return inner

    def memory(self, init: Optional[Variable] = None, shape=None, value=0.0,
               need_reorder: bool = False, dtype="float32") -> Variable:
        if not self._in_block:
            raise ValueError("DynamicRNN.memory must be called inside block()")
        if init is not None:
            prev = self._sub_block.create_var(
                name=unique_name.generate("drnn_mem_prev"),
                dtype=init.dtype, shape=init.shape)
            self._memories.append([prev.name, None, init.name])
            return prev
        if shape is None:
            raise ValueError("memory needs init= or shape=")
        prev = self._sub_block.create_var(
            name=unique_name.generate("drnn_mem_prev"), dtype=dtype,
            shape=tuple([-1] + list(shape)))
        self._memories.append([prev.name, None, None])
        self._mem_inits_deferred.append((prev.name, list(shape), value, dtype))
        return prev

    def update_memory(self, prev: Variable, new: Variable):
        for m in self._memories:
            if m[0] == prev.name:
                m[1] = new.name
                return
        raise ValueError("update_memory: %r is not a memory of this RNN" % prev.name)

    def output(self, *outputs: Variable):
        self._step_outputs.extend(outputs)

    step_output = output

    def _complete(self):
        if not self._step_inputs:
            raise ValueError("DynamicRNN needs at least one step_input")
        for m in self._memories:
            if m[1] is None:
                raise ValueError("memory %r was never update_memory'd" % m[0])
        # deferred zero-valued memories: batch-sized like the first step input
        first_outer = self._parent_block._find_var_recursive(self._step_inputs[0][0])
        for prev_name, shape, value, dtype in self._mem_inits_deferred:
            init = tl.fill_constant_batch_size_like(
                first_outer, [-1] + shape, dtype, value, input_dim_idx=0,
                output_dim_idx=0)
            for m in self._memories:
                if m[0] == prev_name:
                    m[2] = init.name
        outer_outs = []
        for o in self._step_outputs:
            shape = (-1, self._max_len) + tuple((o.shape or ())[1:])
            outer = self._parent_block.create_var(
                name=unique_name.generate("drnn_out"), dtype=o.dtype, shape=shape)
            outer_outs.append(outer)
        finals = []
        for prev_name, _, init_name in self._memories:
            init_var = self._parent_block._find_var_recursive(init_name)
            fs = self._parent_block.create_var(
                name=unique_name.generate("drnn_final"), dtype=init_var.dtype,
                shape=init_var.shape)
            finals.append(fs)
        self._outputs = outer_outs
        self._final_states = finals
        inputs = {
            "X": [outer for outer, _ in self._step_inputs],
            "Boot": [m[2] for m in self._memories],
            "Static": [outer for outer, _ in self._static_inputs],
        }
        if self._length is not None:
            inputs["Length"] = self._length
        self._parent_block.append_op(
            "dynamic_rnn",
            inputs=inputs,
            outputs={"Out": outer_outs, "FinalStates": finals},
            attrs={
                "sub_block": self._sub_block.idx,
                "step_inputs": [list(p) for p in self._step_inputs],
                "static_inputs": [list(p) for p in self._static_inputs],
                "memories": [list(m) for m in self._memories],
                "step_outputs": [o.name for o in self._step_outputs],
            },
        )

    def __call__(self):
        if len(self._outputs) == 1:
            return self._outputs[0]
        return tuple(self._outputs)

    @property
    def final_states(self):
        return self._final_states
