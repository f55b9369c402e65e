# ported from paddle_tpu/layers/control_flow.py
"""Control-flow layers (reference: python/paddle/fluid/layers/control_flow.py):
the comparisons (``less_than`` ... ``not_equal``), the logical layers
(``logical_xor`` is a generated wrapper, :mod:`.layer_function_generator`),
``increment``, ``While``, ``cond``, ``StaticRNN``, ``DynamicRNN``,
``IfElse``, ``Switch`` and ``is_empty``.

Sub-blocks hold the body ops, exactly Fluid's representation; the ops
run them through the interpreter (``ops/control_flow_ops.py``,
``ops/rnn_ops.py``'s ``dynamic_rnn``). Under ``CompiledProgram`` and
``run_steps`` all of them capture: ``cond``/``Switch`` select both
branches' outputs on the device, and a ``While`` of a forward program
replays its body as a graph once an iteration, its condition read on the
host (``executor._CapturedStep``).
"""

from __future__ import annotations

import contextlib
from typing import Callable, List, Optional, Tuple

from ..core import unique_name
from ..core.framework import Variable, default_main_program
from . import tensor as tl
from .layer_helper import LayerHelper

__all__ = ["While", "cond", "StaticRNN", "DynamicRNN", "less_than",
           "less_equal", "greater_than", "greater_equal", "equal", "not_equal",
           "logical_and", "logical_or", "logical_not", "increment", "is_empty",
           "IfElse", "Switch"]


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


class While:
    """Fluid-style while loop (reference: control_flow.py:504).

        i = fluid.layers.fill_constant([1], 'int64', 0)
        n = fluid.layers.fill_constant([1], 'int64', 10)
        s = fluid.layers.fill_constant([1], 'float32', 0.0)
        cond = fluid.layers.less_than(i, n)
        w = fluid.layers.While(cond)
        with w.block():
            layers.assign(s + 1.0, s)
            layers.increment(i, in_place=True)
            fluid.layers.less_than(i, n, cond=cond)  # update condition

    Loop-carried vars are detected automatically: any pre-existing var
    re-assigned inside the body (Fluid's scope-mutation contract, made
    functional as the loop's carry).
    """

    def __init__(self, cond: Variable, is_test: bool = False, name: Optional[str] = None):
        if cond.dtype != "bool":
            raise TypeError("While condition must be a bool Variable")
        self.cond_var = cond
        self.helper = LayerHelper("while", name=name)

    @contextlib.contextmanager
    def block(self):
        program = default_main_program()
        parent_block = program.current_block()
        sub = program._create_block()
        try:
            yield
        finally:
            program._rollback()
        # carry set: vars written in the body that already existed outside
        carry = []
        for op in sub.ops:
            for name in op.output_arg_names:
                if name not in sub.vars and name not in carry:
                    carry.append(name)
        if self.cond_var.name not in carry:
            raise ValueError(
                "While body never updates the condition %r — infinite loop"
                % self.cond_var.name)
        parent_block.append_op(
            "while",
            inputs={"Condition": self.cond_var},
            outputs={"Out": carry},
            attrs={"sub_block": sub.idx, "carry_vars": carry},
        )


def cond(pred: Variable, true_fn: Callable, false_fn: Optional[Callable] = None):
    """Functional two-branch conditional (the ``conditional_block`` op:
    ``Executor.run`` reads the predicate on the host and runs the selected
    branch; the captured step runs both and selects on the device).

    Returns the true_fn/false_fn result (a Variable or tuple of Variables;
    both branches must return matching shapes/dtypes, as the JAX package's
    ``lax.cond`` requires).
    """
    program = default_main_program()
    parent_block = program.current_block()
    LayerHelper("cond")  # advances unique_name's "cond" key as the JAX layer does

    def build(fn):
        blk = program._create_block()
        try:
            res = fn()
        finally:
            program._rollback()
        if res is None:
            res = ()
        res_t = res if isinstance(res, (list, tuple)) else (res,)
        return blk, tuple(res_t), not isinstance(res, (list, tuple))

    true_blk, true_outs, single = build(true_fn)
    if false_fn is None:
        raise ValueError("cond requires false_fn returning the same structure "
                         "(XLA needs both branches)")
    false_blk, false_outs, _ = build(false_fn)
    if len(true_outs) != len(false_outs):
        raise ValueError("cond branches return different arities: %d vs %d"
                         % (len(true_outs), len(false_outs)))

    out_vars = []
    for tv, fv in zip(true_outs, false_outs):
        out = parent_block.create_var(
            name=unique_name.generate("cond_out"), dtype=tv.dtype, shape=tv.shape)
        # bind each branch's result to the shared output name
        true_blk.append_op("assign", inputs={"X": tv}, outputs={"Out": out})
        false_blk.append_op("assign", inputs={"X": fv}, outputs={"Out": out})
        out_vars.append(out)

    parent_block.append_op(
        "conditional_block",
        inputs={"Cond": pred},
        outputs={"Out": [v.name for v in out_vars]},
        attrs={"true_block": true_blk.idx, "false_block": false_blk.idx},
    )
    if single and out_vars:
        return out_vars[0]
    return tuple(out_vars)


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


class StaticRNN:
    """Static (unrolled-shape) RNN over time-major inputs
    (reference: control_flow.py:278): the ``recurrent`` op, a loop over the
    static T that trains through autograd and captures.

        rnn = fluid.layers.StaticRNN()
        with rnn.step():
            w = rnn.step_input(x_tm)           # x_tm: [T, B, D]
            prev = rnn.memory(init=h0)         # h0:   [B, H]
            h = fluid.layers.fc([w, prev], size=H, act='tanh')
            rnn.update_memory(prev, h)
            rnn.step_output(h)
        outs = rnn()                           # [T, B, H]
    """

    def __init__(self, name: Optional[str] = None):
        self.helper = LayerHelper("static_rnn", name=name)
        self._sub_block = None
        self._parent_block = None
        self._step_inputs: List[Tuple[str, str]] = []
        self._memories: List[Tuple[str, str, str]] = []
        self._mem_updates = {}
        self._step_outputs: List[Variable] = []
        self._outputs: List[Variable] = []
        self._final_states: List[Variable] = []
        self._seq_len = None

    @contextlib.contextmanager
    def step(self):
        program = default_main_program()
        self._parent_block = program.current_block()
        self._sub_block = program._create_block()
        try:
            yield
        except BaseException:
            program._rollback()
            raise  # don't mask the user's error with a _complete() one
        else:
            program._rollback()
            self._complete()

    def step_input(self, x: Variable) -> Variable:
        if x.shape is None or len(x.shape) < 1:
            raise ValueError("step_input needs a [T, ...] shaped Variable")
        if self._seq_len is None:
            self._seq_len = x.shape[0]
        inner = self._sub_block.create_var(
            name=unique_name.generate("rnn_step_in"),
            dtype=x.dtype, shape=x.shape[1:])
        self._step_inputs.append((x.name, inner.name))
        return inner

    def memory(self, init: Optional[Variable] = None, shape=None, value=0.0,
               batch_ref: Optional[Variable] = None, dtype="float32") -> Variable:
        if init is None:
            if batch_ref is None or shape is None:
                raise ValueError("memory needs init=Variable, or shape+batch_ref")
            init = tl.fill_constant_batch_size_like(
                batch_ref, [d if d != -1 else 1 for d in shape], dtype, value)
        prev = self._sub_block.create_var(
            name=unique_name.generate("rnn_mem_prev"),
            dtype=init.dtype, shape=init.shape)
        self._memories.append([prev.name, None, init.name])
        return prev

    def update_memory(self, prev: Variable, new: Variable):
        for m in self._memories:
            if m[0] == prev.name:
                m[1] = new.name
                return
        raise ValueError("update_memory: %r is not a memory of this RNN" % prev.name)

    def step_output(self, o: Variable):
        self._step_outputs.append(o)

    output = step_output

    def _complete(self):
        for m in self._memories:
            if m[1] is None:
                raise ValueError("memory %r was never update_memory'd" % m[0])
        outer_outs = []
        for o in self._step_outputs:
            shape = (self._seq_len,) + tuple(o.shape or ())
            outer = self._parent_block.create_var(
                name=unique_name.generate("rnn_out"), dtype=o.dtype, shape=shape)
            outer_outs.append(outer)
        finals = []
        for prev_name, _, init_name in self._memories:
            init_var = self._parent_block.var(init_name)
            fs = self._parent_block.create_var(
                name=unique_name.generate("rnn_final"), dtype=init_var.dtype,
                shape=init_var.shape)
            finals.append(fs)
        self._outputs = outer_outs
        self._final_states = finals
        self._parent_block.append_op(
            "recurrent",
            inputs={
                "X": [outer for outer, _ in self._step_inputs],
                "Boot": [init for _, _, init in self._memories],
            },
            outputs={"Out": outer_outs, "FinalStates": finals},
            attrs={
                "sub_block": self._sub_block.idx,
                "step_inputs": [list(p) for p in self._step_inputs],
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


class IfElse:
    """Per-row two-branch routing (reference: control_flow.py:1264).

    The reference physically splits rows by the bool mask
    (split_lod_tensor), runs each branch on its subset, and merges
    (merge_lod_tensor) — data-dependent shapes. As in the JAX package both
    branches run over the full batch and the mask blends the rows:
    identical row-wise results at static shapes, no sub-block, so a
    program with an IfElse captures. Same API:

        ie = fluid.layers.IfElse(cond)         # cond: [N, 1] bool
        with ie.true_block():
            ie.output(f(ie.input(x)))
        with ie.false_block():
            ie.output(g(ie.input(x)))
        out, = ie()
    """

    OUT, IN_TRUE, IN_FALSE = 0, 1, 2

    def __init__(self, cond: Variable, name: Optional[str] = None):
        if not isinstance(cond, Variable):
            raise TypeError("cond must be a Variable")
        self.helper = LayerHelper("ifelse", name=name)
        self.cond = cond
        self.status = IfElse.OUT
        self.output_table = ([], [])  # (false_outs, true_outs)

    def input(self, x: Variable) -> Variable:
        if self.status == IfElse.OUT:
            raise ValueError("IfElse.input() must be called inside a block")
        return x  # both branches see the full rows; the mask blends later

    @contextlib.contextmanager
    def _block(self, is_true: bool):
        if self.status != IfElse.OUT:
            raise ValueError("cannot nest IfElse blocks")
        self.status = IfElse.IN_TRUE if is_true else IfElse.IN_FALSE
        try:
            yield
        finally:
            self.status = IfElse.OUT

    def true_block(self):
        return self._block(True)

    def false_block(self):
        return self._block(False)

    def output(self, *outs):
        if self.status == IfElse.OUT:
            raise ValueError("output() can only be invoked inside a block")
        table = self.output_table[1 if self.status == IfElse.IN_TRUE else 0]
        table.extend(outs)

    def __call__(self):
        if self.status != IfElse.OUT:
            raise ValueError("IfElse() must be called outside the blocks")
        false_outs, true_outs = self.output_table
        if not false_outs and not true_outs:
            raise ValueError("invoke true_block/false_block before __call__")
        if not false_outs or not true_outs:
            return list(true_outs or false_outs)
        if len(false_outs) != len(true_outs):
            raise ValueError("branches produced different output counts")
        from .nn import elementwise_add, elementwise_mul

        res = []
        for fv, tv in zip(false_outs, true_outs):
            mask = tl.cast(self.cond, tv.dtype)  # [N, 1]
            keep = tl.scale(mask, scale=-1.0, bias=1.0)
            res.append(elementwise_add(elementwise_mul(tv, mask),
                                       elementwise_mul(fv, keep)))
        return res


class Switch:
    """First-matching-case execution (reference: control_flow.py Switch —
    the LR-schedule workhorse). Each case body is captured into a sub-block
    and executed under ``conditional_block`` with an effective condition
    ``case_cond AND NOT any_earlier_match``; vars it writes carry out, the
    false branch keeps their previous values.

        with fluid.layers.Switch() as switch:
            with switch.case(step < warmup):
                fluid.layers.assign(lr_warm, lr)
            with switch.default():
                fluid.layers.assign(lr_base, lr)
    """

    def __init__(self, name: Optional[str] = None):
        self.helper = LayerHelper("switch", name=name)
        self._inside = False
        self._matched: Optional[Variable] = None  # running "already taken"

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    @contextlib.contextmanager
    def _case(self, condition: Optional[Variable]):
        if self._inside:
            raise ValueError("cannot nest Switch cases")
        self._inside = True
        program = default_main_program()
        parent = program.current_block()
        sub = program._create_block()
        try:
            yield
        finally:
            program._rollback()
            self._inside = False
        written = []
        for op in sub.ops:
            for n in op.output_arg_names:
                if n not in sub.vars and n not in written:
                    written.append(n)
        if self._matched is None:
            self._matched = tl.fill_constant([1], "bool", False)
        if condition is None:  # default: runs iff nothing matched yet
            eff = logical_not(self._matched)
            new_matched = None
        else:
            eff = logical_and(condition, logical_not(self._matched))
            new_matched = logical_or(self._matched, condition)
        # identity false-branch: carry vars keep their previous values
        false_blk = program._create_block()
        program._rollback()
        for n in written:
            false_blk.append_op("assign", inputs={"X": n}, outputs={"Out": n})
        parent.append_op(
            "conditional_block",
            inputs={"Cond": eff},
            outputs={"Out": written},
            attrs={"true_block": sub.idx, "false_block": false_blk.idx},
        )
        if new_matched is not None:
            self._matched = new_matched

    def case(self, condition: Variable):
        return self._case(condition)

    def default(self):
        return self._case(None)


def is_empty(x, cond=None):
    """True iff x has zero elements (reference: control_flow.py is_empty →
    operators/is_empty_op.cc)."""
    helper = LayerHelper("is_empty")
    out = cond if cond is not None else helper.create_variable_for_type_inference("bool")
    helper.append_op("is_empty", inputs={"X": x}, outputs={"Out": out})
    return out
