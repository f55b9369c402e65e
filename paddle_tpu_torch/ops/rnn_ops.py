# ported from paddle_tpu/ops/rnn_ops.py
"""Recurrent ops: dynamic_lstm / dynamic_lstmp / dynamic_gru / lstm /
gru_unit / lstm_unit / dynamic_rnn (and the aliases ``gru`` and
``lstmp``).

Reference: ``operators/lstm_op.cc``, ``operators/gru_op.cc``,
``operators/lstm_unit_op.cc``, ``operators/gru_unit_op.cc``,
``operators/cudnn_lstm_op.cu.cc`` and ``operators/math/lstm_compute.cc`` /
``gru_compute.cc``.

The JAX package runs each recurrence as one ``lax.scan`` over a padded
batch with a ``Length`` vector; here it is a Python loop over the static
padded T (never over ``length.max()``: that would read the device on the
host every step, which a captured step cannot hold), each step a
``torch.addmm`` and the gate arithmetic. :func:`_masked_loop` keeps
``_masked_scan``'s semantics: past a row's length its carries keep their
value and its outputs are 0 (``torch.where`` on the row mask, equal to the
JAX package's ``m*nc + (1-m)*c`` for finite values). ``is_reverse`` flips
the whole padded T with the mask, as the JAX op does; the carry then holds
its initial value through the flipped padding.

Gate layouts (the JAX package's): the LSTM's 4H projection is
[i, f, c̃, o] with the peepholes in ``Bias[4H:7H]`` as (W_ic, W_fc, W_oc);
the GRU's 3H is [u, r, c̃] with the candidate ``(r ⊙ h_prev) @ W_c``;
``origin_mode`` swaps the blend. cuDNN's RNNs are not used: their GRU
applies the reset after the product, they offer none of these
activation choices, and their variable lengths live on the host.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.registry import OpContext, register_op
from .sequence_ops import _mask
from .tensor_ops import keep_mask

_ACT = {
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "relu": torch.relu,
    "identity": lambda x: x,
    "hard_sigmoid": F.hardsigmoid,   # relu6(x + 3) / 6, as jax.nn's
    "softsign": F.softsign,
}


def _act(name, default):
    return _ACT[name or default]


def _time_major(x, length, is_reverse):
    """(x [T, B, ...] contiguous, row mask [T, B, 1] bool, or None without
    Length), flipped over the whole padded T for ``is_reverse``."""
    mask = None
    if length is not None:
        mask = _mask(length.reshape(-1), x.shape[1], x.device)
        if is_reverse:
            mask = torch.flip(mask, dims=[1])
        mask = mask.transpose(0, 1)[..., None]
    if is_reverse:
        x = torch.flip(x, dims=[1])
    return x.transpose(0, 1).contiguous(), mask


def _masked_loop(step, inits, xs_tm, mask_tm):
    """Run ``step(carries, x_t) -> new carries`` over time-major ``xs_tm``;
    a masked row keeps its carries. Returns (final carries, [per step
    carries, stacked [B, T, ...]]), the stacked outputs 0 where masked."""
    carries = tuple(inits)
    outs = [[] for _ in carries]
    # unbind, not xs_tm[t]: the gradient of one unbind is one stack, where
    # each indexing would add a zero-filled [T, B, ...] gradient a step
    for t, x_t in enumerate(xs_tm.unbind(0)):
        new = step(carries, x_t)
        for o, n in zip(outs, new):
            o.append(n)
        if mask_tm is None:
            carries = new
        else:
            carries = tuple(torch.where(mask_tm[t], n, c)
                            for n, c in zip(new, carries))
    stacked = []
    for o in outs:
        s = torch.stack(o, dim=1)
        if mask_tm is not None:
            s = torch.where(mask_tm.transpose(0, 1), s, torch.zeros_like(s))
        stacked.append(s)
    return carries, stacked


def _flip_back(ys, is_reverse):
    return [torch.flip(y, dims=[1]) for y in ys] if is_reverse else ys


def _lstm_step(w, hidden, gate_act, cell_act, cand_act, peep=None):
    """The LSTM cell over gates [i, f, c̃, o]: ``peep`` (W_ic, W_fc, W_oc)
    adds the peepholes."""

    def step(carries, x_t):
        h_prev, c_prev = carries
        gates = torch.addmm(x_t, h_prev, w)
        gi, gf, gc, go = gates.split(hidden, dim=1)
        if peep is not None:
            gi = torch.addcmul(gi, c_prev, peep[0])
            gf = torch.addcmul(gf, c_prev, peep[1])
        c = gate_act(gf) * c_prev + gate_act(gi) * cand_act(gc)
        if peep is not None:
            go = torch.addcmul(go, c, peep[2])
        h = gate_act(go) * cell_act(c)
        return h, c

    return step


@register_op("dynamic_lstm")
def dynamic_lstm_op(ctx: OpContext):
    """Input [B,T,4H] (the x-projection of a preceding fc), Weight [H,4H]
    recurrent weights, Bias [1,4H] (or [1,7H] with peepholes: the W_ic,
    W_fc, W_oc diagonals follow). Outputs Hidden/Cell [B,T,H].
    Reference: operators/lstm_op.cc, math/lstm_compute.cc."""
    x = ctx.input("Input")
    w = ctx.input("Weight")
    bias = ctx.input("Bias")
    h0 = ctx.input("H0")
    c0 = ctx.input("C0")
    hidden = w.shape[0]
    use_peepholes = bool(ctx.attr("use_peepholes", False))
    is_reverse = bool(ctx.attr("is_reverse", False))
    peep = None
    if bias is not None:
        b = bias.reshape(-1)
        x = x + b[:4 * hidden]
        if use_peepholes:
            peep = b[4 * hidden:7 * hidden].split(hidden)
    xs_tm, mask_tm = _time_major(x, ctx.input("Length"), is_reverse)
    batch = x.shape[0]
    h_init = h0 if h0 is not None else x.new_zeros((batch, hidden))
    c_init = c0 if c0 is not None else x.new_zeros((batch, hidden))
    step = _lstm_step(w, hidden, _act(ctx.attr("gate_activation"), "sigmoid"),
                      _act(ctx.attr("cell_activation"), "tanh"),
                      _act(ctx.attr("candidate_activation"), "tanh"), peep)
    _, (hs, cs) = _masked_loop(step, (h_init, c_init), xs_tm, mask_tm)
    hs, cs = _flip_back([hs, cs], is_reverse)
    ctx.set_output("Hidden", hs)
    ctx.set_output("Cell", cs)


@register_op("dynamic_lstmp")
def dynamic_lstmp_op(ctx: OpContext):
    """LSTM with a recurrent projection layer (reference: lstmp_op.cc):
    Weight [P,4H] over the projected state r = proj_act(h @ ProjWeight),
    ProjWeight [H,P]. Outputs Projection [B,T,P] and Cell [B,T,H]."""
    x = ctx.input("Input")
    w = ctx.input("Weight")
    w_proj = ctx.input("ProjWeight")
    bias = ctx.input("Bias")
    hidden, proj = w_proj.shape
    is_reverse = bool(ctx.attr("is_reverse", False))
    gate_act = _act(ctx.attr("gate_activation"), "sigmoid")
    cell_act = _act(ctx.attr("cell_activation"), "tanh")
    cand_act = _act(ctx.attr("candidate_activation"), "tanh")
    proj_act = _act(ctx.attr("proj_activation"), "tanh")
    if bias is not None:
        x = x + bias.reshape(-1)[:4 * hidden]
    xs_tm, mask_tm = _time_major(x, ctx.input("Length"), is_reverse)
    batch = x.shape[0]

    def step(carries, x_t):
        r_prev, c_prev = carries
        gi, gf, gc, go = torch.addmm(x_t, r_prev, w).split(hidden, dim=1)
        c = gate_act(gf) * c_prev + gate_act(gi) * cand_act(gc)
        h = gate_act(go) * cell_act(c)
        return proj_act(h @ w_proj), c

    _, (rs, cs) = _masked_loop(
        step, (x.new_zeros((batch, proj)), x.new_zeros((batch, hidden))),
        xs_tm, mask_tm)
    rs, cs = _flip_back([rs, cs], is_reverse)
    ctx.set_output("Projection", rs)
    ctx.set_output("Cell", cs)


def _gru_step(w, hidden, gate_act, cand_act, origin_mode):
    w_ur = w[:, :2 * hidden]  # [H, 2H] update + reset
    w_c = w[:, 2 * hidden:]   # [H, H] candidate

    def step(carries, x_t):
        (h_prev,) = carries
        ur = gate_act(torch.addmm(x_t[:, :2 * hidden], h_prev, w_ur))
        u, r = ur.split(hidden, dim=1)
        c = cand_act(torch.addmm(x_t[:, 2 * hidden:], r * h_prev, w_c))
        if origin_mode:
            h = (1.0 - u) * c + u * h_prev
        else:
            h = u * c + (1.0 - u) * h_prev
        return (h,)

    return step


@register_op("dynamic_gru")
def dynamic_gru_op(ctx: OpContext):
    """Input [B,T,3H] (x-projection precomputed), Weight [H,3H] split
    [u|r|c̃], Bias [1,3H]. Output Hidden [B,T,H].
    Reference: operators/gru_op.cc, math/gru_compute.cc."""
    x = ctx.input("Input")
    w = ctx.input("Weight")
    bias = ctx.input("Bias")
    h0 = ctx.input("H0")
    hidden = w.shape[0]
    is_reverse = bool(ctx.attr("is_reverse", False))
    if bias is not None:
        x = x + bias.reshape(-1)
    xs_tm, mask_tm = _time_major(x, ctx.input("Length"), is_reverse)
    h_init = h0 if h0 is not None else x.new_zeros((x.shape[0], hidden))
    step = _gru_step(w, hidden, _act(ctx.attr("gate_activation"), "sigmoid"),
                     _act(ctx.attr("candidate_activation"), "tanh"),
                     bool(ctx.attr("origin_mode", False)))
    _, (hs,) = _masked_loop(step, (h_init,), xs_tm, mask_tm)
    ctx.set_output("Hidden", _flip_back([hs], is_reverse)[0])


@register_op("lstm")
def lstm_op(ctx: OpContext):
    """Stacked (optionally bidirectional) LSTM over raw features — the
    cudnn_lstm analog (reference: operators/cudnn_lstm_op.cu.cc). Inputs:
    Input [B,T,D], InitH/InitC [L*dirs,B,H], WeightX (per layer*dir,
    [D_l,4H]), WeightH ([H,4H]), Bias ([4H]). Outputs Out [B,T,H*dirs],
    LastH/LastC [L*dirs,B,H]. Between layers (training only) dropout with
    ``dropout_prob`` draws one mask a layer from the op's generator, so
    the masks are not the JAX package's bits."""
    x = ctx.input("Input")
    init_h = ctx.input("InitH")
    init_c = ctx.input("InitC")
    length = ctx.input("Length")
    wx_list = ctx.inputs("WeightX")
    wh_list = ctx.inputs("WeightH")
    b_list = ctx.inputs("Bias")
    num_layers = int(ctx.attr("num_layers", 1))
    dirs = 2 if ctx.attr("is_bidirec", False) else 1
    dropout_prob = float(ctx.attr("dropout_prob", 0.0) or 0.0)
    hidden = wh_list[0].shape[0]
    batch = x.shape[0]
    step_acts = (torch.sigmoid, torch.tanh, torch.tanh)

    out = x
    last_hs, last_cs = [], []
    for layer in range(num_layers):
        layer_outs = []
        for d in range(dirs):
            idx = layer * dirs + d
            h0 = init_h[idx] if init_h is not None \
                else x.new_zeros((batch, hidden))
            c0 = init_c[idx] if init_c is not None \
                else x.new_zeros((batch, hidden))
            xs_tm, mask_tm = _time_major(
                torch.matmul(out, wx_list[idx]) + b_list[idx], length, d == 1)
            (h_last, c_last), (hs, _) = _masked_loop(
                _lstm_step(wh_list[idx], hidden, *step_acts), (h0, c0),
                xs_tm, mask_tm)
            layer_outs.append(_flip_back([hs], d == 1)[0])
            last_hs.append(h_last)
            last_cs.append(c_last)
        out = torch.cat(layer_outs, dim=-1) if dirs > 1 else layer_outs[0]
        if dropout_prob and not ctx.is_test and layer < num_layers - 1:
            keep = keep_mask(out.shape, dropout_prob, ctx.rng(), out.device)
            out = torch.where(keep, out / (1.0 - dropout_prob),
                              torch.zeros_like(out))
    if length is not None:
        m = _mask(length.reshape(-1), x.shape[1], x.device)[:, :, None]
        out = torch.where(m, out, torch.zeros_like(out))
    ctx.set_output("Out", out)
    ctx.set_output("LastH", torch.stack(last_hs))
    ctx.set_output("LastC", torch.stack(last_cs))


@register_op("gru_unit")
def gru_unit_op(ctx: OpContext):
    """One GRU step (reference: operators/gru_unit_op.cc): Input [B,3H]
    (x-projection), HiddenPrev [B,H], Weight [H,3H], Bias [1,3H]."""
    x = ctx.input("Input")
    w = ctx.input("Weight")
    bias = ctx.input("Bias")
    if bias is not None:
        x = x + bias.reshape(-1)
    step = _gru_step(w, w.shape[0],
                     _act(ctx.attr("gate_activation"), "sigmoid"),
                     _act(ctx.attr("candidate_activation"), "tanh"),
                     bool(ctx.attr("origin_mode", False)))
    (h,) = step((ctx.input("HiddenPrev"),), x)
    ctx.set_output("Hidden", h)


@register_op("lstm_unit")
def lstm_unit_op(ctx: OpContext):
    """One LSTM step on pre-projected gates (reference:
    operators/lstm_unit_op.cc): X [B,4H] = [i|f|c̃|o], C_prev [B,H];
    forget_bias added to f before the sigmoid."""
    x = ctx.input("X")
    c_prev = ctx.input("C_prev")
    forget_bias = float(ctx.attr("forget_bias", 0.0) or 0.0)
    gi, gf, gc, go = x.chunk(4, dim=1)
    c = torch.sigmoid(gf + forget_bias) * c_prev \
        + torch.sigmoid(gi) * torch.tanh(gc)
    ctx.set_output("C", c)
    ctx.set_output("H", torch.sigmoid(go) * torch.tanh(c))


@register_op("dynamic_rnn")
def dynamic_rnn_op(ctx: OpContext):
    """DynamicRNN (reference: the LoD-bucketed DynamicRNN,
    layers/control_flow.py:1394, with lod_rank_table/shrink_rnn_memory).

    Fluid sorts the sequences by length and shrinks the batch as they end;
    here, as in the JAX package, the whole padded batch runs every step
    and a row past its length keeps its memories and outputs 0: the same
    results at a constant shape. The sub-block runs once a timestep
    through the interpreter (offset ``10_000 * block.idx``) with the step's
    trace (see :mod:`..core.interpreter` on its generators), seeing the
    outer env, each static input whole, each step input's slice and the
    memories.

    attrs: sub_block, step_inputs [(outer,inner)], static_inputs
    [(outer,inner)], memories [(prev,updated,init_outer)], step_outputs;
    inputs: X (outer step inputs, batch-major [B,T,...]), Length [B],
    Boot (memory inits); outputs Out (stacked [B,T,...]), FinalStates.
    """
    from ..core.interpreter import run_block_ops

    block = ctx.trace.program.blocks[ctx.attr("sub_block")]
    step_inputs = ctx.attr("step_inputs")
    static_inputs = ctx.attr("static_inputs", []) or []
    memories = ctx.attr("memories")
    step_outputs = ctx.attr("step_outputs")
    env = ctx.env
    length = ctx.input("Length")

    first = env[step_inputs[0][0]]
    maxlen = first.shape[1]
    mask = None if length is None else \
        _mask(length.reshape(-1), maxlen, first.device)
    statics = {inner: env[outer] for outer, inner in static_inputs}
    carry = {prev: env[init_name] for prev, _, init_name in memories}
    ys = [[] for _ in step_outputs]
    steps = {inner: env[outer].unbind(1) for outer, inner in step_inputs}
    for t in range(maxlen):
        local = dict(env)
        local.update(statics)
        local.update({inner: xs[t] for inner, xs in steps.items()})
        local.update(carry)
        run_block_ops(block.ops, local, ctx.trace, offset=10_000 * block.idx)
        m_t = None if mask is None else mask[:, t]
        new = {}
        for prev, updated, _ in memories:
            val = local[updated].to(carry[prev].dtype)
            new[prev] = val if m_t is None else torch.where(
                m_t.reshape((-1,) + (1,) * (val.dim() - 1)), val, carry[prev])
        carry = new
        for y, n in zip(ys, step_outputs):
            y.append(local[n])
    for n, y in zip(ctx.output_names("Out"), ys):
        out = torch.stack(y, dim=1)
        if mask is not None:
            m = mask.reshape(mask.shape + (1,) * (out.dim() - 2))
            out = torch.where(m, out, torch.zeros_like(out))
        env[n] = out
    for (prev, _, _), name in zip(memories, ctx.output_names("FinalStates")):
        env[name] = carry[prev]


# Reference op-name aliases: the reference's layers emit op types "gru" /
# "lstmp" (gru_op.cc, lstmp_op.cc) for what is registered here as
# dynamic_gru / dynamic_lstmp — the same math over padded+Length batches.
@register_op("gru")
def gru_alias_op(ctx: OpContext):
    dynamic_gru_op(ctx)


@register_op("lstmp")
def lstmp_alias_op(ctx: OpContext):
    dynamic_lstmp_op(ctx)
