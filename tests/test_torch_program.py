"""The port builds the same Fluid program as the JAX package.

A 2-layer Transformer (d_model 32, 2 heads, d_inner 64, seq 16, vocab 64)
with ``Adam.minimize`` is built once by each package, the way
``__graft_entry__._build_transformer`` builds it with
``import paddle_tpu as fluid``. The op type sequence, every op's attrs and
input/output var names, the parameter names and shapes, and the startup
program's ops must be identical: the port's framework, layers, backward
and optimizer are copies, and its shape inference (ops run on ``meta``
tensors) must give every var the JAX package's shape.
"""

import importlib

import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu.models import transformer as jtfm
from paddle_tpu_torch.models import transformer as ttfm

SMALL = dict(n_layer=2, d_model=32, n_head=2, d_inner=64, seq=16, vocab=64)


def build_transformer(fluid, tfm, n_layer, d_model, n_head, d_inner, seq,
                      vocab, dropout=0.0, label_smooth_eps=0.1, lr=1e-2):
    """``__graft_entry__._build_transformer`` for either package; returns
    (main, startup, loss)."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 7
    with fluid.program_guard(main, startup):
        with fluid.unique_name.guard():
            src = fluid.layers.data("src", shape=[seq], dtype="int64")
            trg = fluid.layers.data("trg", shape=[seq], dtype="int64")
            lbl = fluid.layers.data("lbl", shape=[seq, 1], dtype="int64")
            smask = fluid.layers.data("smask", shape=[seq], dtype="float32")
            tmask = fluid.layers.data("tmask", shape=[seq], dtype="float32")
            _, loss = tfm.transformer(
                src, trg, lbl, smask, tmask,
                src_vocab_size=vocab, trg_vocab_size=vocab, max_length=seq,
                n_layer=n_layer, n_head=n_head, d_model=d_model,
                d_inner=d_inner, dropout_rate=dropout,
                label_smooth_eps=label_smooth_eps, is_test=False)
            fluid.optimizer.Adam(learning_rate=lr).minimize(loss)
    return main, startup, loss


def ops_of(program):
    return [(op.type, op.inputs, op.outputs, op.attrs)
            for op in program.global_block.ops]


def test_transformer_program_structure_matches():
    jm, js, jloss = build_transformer(jfluid, jtfm, dropout=0.1, **SMALL)
    tm, ts, tloss = build_transformer(tfluid, ttfm, dropout=0.1, **SMALL)
    assert tloss.name == jloss.name
    jops, tops = ops_of(jm), ops_of(tm)
    assert [o[0] for o in tops] == [o[0] for o in jops]
    for j, t in zip(jops, tops):
        assert t == j, (t[0], j[0])
    assert {p.name: p.shape for p in tm.all_parameters()} == \
        {p.name: p.shape for p in jm.all_parameters()}
    assert len(tm.all_parameters()) == 60
    assert ops_of(ts) == ops_of(js)
    assert {op.type for op in ts.global_block.ops} == {
        "fill_constant", "uniform_random", "gaussian_random"}
    assert tm._backward_info == jm._backward_info
    # every var the JAX package's shape inference sized, the port's did too
    jvars = {v.name: v.shape for v in jm.list_vars()}
    tvars = {v.name: v.shape for v in tm.list_vars()}
    assert tvars == jvars


# names the JAX package exports at its top level, with the port's module
# that defines each
TOP_LEVEL = [("flags", "flags"), ("get_flag", "flags"), ("set_flag", "flags"),
             ("append_backward", "backward"), ("gradients", "backward"),
             ("calc_gradient", "backward"), ("Variable", "core.framework"),
             ("name_scope", "core.framework"), ("test_mode", "core.framework"),
             ("WeightNormParamAttr", "layers.layer_helper"),
             ("TPUPlace", "core.place")]


@pytest.mark.parametrize("name,module", TOP_LEVEL)
def test_top_level_names_of_the_reference(name, module):
    """A Fluid script written for the JAX package finds the name on
    ``import paddle_tpu_torch as fluid``: the object its module defines,
    listed in ``__all__``."""
    assert hasattr(jfluid, name)
    defined = getattr(importlib.import_module("paddle_tpu_torch." + module),
                      name)
    assert getattr(tfluid, name) is defined and name in tfluid.__all__


def test_tpu_place_names_the_card_and_flags_read_and_set():
    """``fluid.TPUPlace(0)`` is the first card, as ``fluid.CUDAPlace(0)`` is
    in the JAX package; building the place touches no device."""
    assert tfluid.TPUPlace is tfluid.CUDAPlace
    assert tfluid.TPUPlace(0) == torch.device("cuda", 0)
    n = tfluid.get_flag("flash_attention_min_seq")
    assert isinstance(n, int) and n == tfluid.flags.flash_attention_min_seq
    tfluid.set_flag("flash_attention_min_seq", n + 1)
    try:
        assert tfluid.flags.flash_attention_min_seq == n + 1
    finally:
        tfluid.set_flag("flash_attention_min_seq", n)
