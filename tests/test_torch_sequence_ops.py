"""The port's sequence ops match the JAX package's.

All 18 ops over padded [B, T, ...] tensors and a ``Length`` [B] (the 15
of ``sequence_ops.py`` and ``sequence_conv``, ``sequence_reshape`` and
``lod_reset``) run through each package's registered implementation on
the same ``RandomState`` inputs, and their gradients against one random
cotangent through each package's autodiff (``jax.vjp``,
``torch.autograd.grad``): float outputs and gradients to 1e-5, integer
outputs identical in value (the JAX package runs with 64-bit types off,
so its int64 is int32; the port keeps a declared int64). The lengths hold
a full row, a row of length 1 and a row of length 0; ``max`` pooling is
also held on ties, where both packages split the gradient evenly.

``check_seq`` here serves the RNN and CRF test files.
"""

import numpy as np
import pytest

from test_torch_dense_reduce_math import _flat, _is_float, _np, \
    run_jax, run_port

TOL = (1e-5, 1e-5)
B, T, D = 4, 6, 5
LENGTHS = np.array([6, 1, 0, 3], np.int64)


def check_seq(op_type, attrs, inputs, outs, tol=TOL, diff=None):
    """Runs ``op_type`` through both packages; float outputs and the
    gradients of the float inputs (or ``diff``) to ``tol``, the rest equal
    in value and kind. Returns (port outputs, JAX outputs)."""
    flat = _flat(inputs)
    if diff is None:
        diff = [n for n, v in flat.items() if _is_float(v)]
    want, want_g, cots = run_jax(op_type, attrs, inputs, outs, diff)
    got, got_g = run_port(op_type, attrs, inputs, outs, diff, cots)
    assert set(got) == set(want), (sorted(got), sorted(want))
    for n in want:
        w, g = _np(want[n]), _np(got[n])
        assert g.shape == w.shape, (n, g.shape, w.shape)
        if _is_float(w):
            assert g.dtype == w.dtype, (n, g.dtype, w.dtype)
            np.testing.assert_allclose(g, w, rtol=tol[0], atol=tol[1],
                                       err_msg=n)
        else:
            assert g.dtype.kind == w.dtype.kind, (n, g.dtype, w.dtype)
            np.testing.assert_array_equal(g, w, err_msg=n)
    assert set(got_g) == set(want_g)
    for n in want_g:
        np.testing.assert_allclose(_np(got_g[n]), _np(want_g[n]),
                                   rtol=tol[0], atol=tol[1],
                                   err_msg="grad " + n)
    return got, want


def randn(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("dtype", ["int64", "float32", "bool"])
def test_sequence_mask(dtype):
    got, _ = check_seq("sequence_mask", {"maxlen": T, "out_dtype": dtype},
                       {"X": LENGTHS}, {"Y": 1})
    assert got["Y"].numpy().sum() == LENGTHS.sum()


def test_sequence_mask_needs_a_static_maxlen():
    with pytest.raises(ValueError, match="static maxlen"):
        run_port("sequence_mask", {"maxlen": -1}, {"X": LENGTHS}, {"Y": 1},
                 [], {})


POOLS = ("sum", "average", "sqrt", "max", "last", "first")


@pytest.mark.parametrize("with_length", [True, False])
@pytest.mark.parametrize("pooltype", POOLS)
def test_sequence_pool(pooltype, with_length):
    inputs = {"X": randn(B, T, D)}
    if with_length:
        inputs["Length"] = LENGTHS
    got, _ = check_seq("sequence_pool", {"pooltype": pooltype}, inputs,
                       {"Out": 1})
    if pooltype == "max" and with_length:
        # a row of length 0 pools to the fill, as in the JAX package
        assert np.all(got["Out"].detach().numpy()[2] == np.float32(-3.4e38))


@pytest.mark.parametrize("with_length", [True, False])
def test_sequence_pool_max_splits_the_gradient_among_ties(with_length):
    x = np.random.RandomState(3).randint(0, 3, (B, T, D)).astype(np.float32)
    inputs = {"X": x}
    if with_length:
        inputs["Length"] = LENGTHS
    check_seq("sequence_pool", {"pooltype": "max"}, inputs, {"Out": 1})


def test_sequence_pool_over_more_dims():
    check_seq("sequence_pool", {"pooltype": "average"},
              {"X": randn(B, T, 2, 3), "Length": LENGTHS}, {"Out": 1})


@pytest.mark.parametrize("with_length", [True, False])
@pytest.mark.parametrize("op_type,out", [("sequence_softmax", "Out"),
                                         ("sequence_reverse", "Y")])
def test_softmax_and_reverse(op_type, out, with_length):
    x = randn(B, T) if op_type == "sequence_softmax" else randn(B, T, D)
    inputs = {"X": x}
    if with_length:
        inputs["Length"] = LENGTHS
    check_seq(op_type, {}, inputs, {out: 1})


@pytest.mark.parametrize("op_type", ["sequence_expand", "sequence_expand_as"])
def test_expand(op_type):
    check_seq(op_type, {"ref_level": -1} if op_type == "sequence_expand"
              else {}, {"X": randn(B, D), "Y": randn(B, T, D, seed=1)},
              {"Out": 1})


@pytest.mark.parametrize("with_length", [True, False])
def test_sequence_concat(with_length):
    xs = [randn(B, T, D), randn(B, 3, D, seed=1)]
    inputs = {"X": xs}
    outs = {"Out": 1}
    if with_length:
        inputs["Length"] = [LENGTHS, np.array([3, 0, 2, 1], np.int64)]
        outs["LengthOut"] = 1
    got, _ = check_seq("sequence_concat", {}, inputs, outs)
    if with_length:
        np.testing.assert_array_equal(got["LengthOut"].numpy(),
                                      [9, 1, 2, 4])


@pytest.mark.parametrize("padded_length", [-1, 4, 8])
@pytest.mark.parametrize("with_length", [True, False])
def test_sequence_pad(padded_length, with_length):
    inputs = {"X": randn(B, T, D),
              "PadValue": np.array([0.5], np.float32)}
    if with_length:
        inputs["Length"] = LENGTHS
    check_seq("sequence_pad", {"padded_length": padded_length}, inputs,
              {"Out": 1, "Length": 1})


def test_sequence_unpad():
    check_seq("sequence_unpad", {}, {"X": randn(B, T, D), "Length": LENGTHS},
              {"Out": 1})


def test_sequence_erase():
    x = np.random.RandomState(2).randint(0, 7, (B, T)).astype(np.int64)
    x[1] = 2  # a row erased whole
    got, _ = check_seq("sequence_erase", {"tokens": [2, 5]}, {"X": x},
                       {"Out": 1, "Length": 1})
    assert got["Length"].numpy()[1] == 0


@pytest.mark.parametrize("win,pad", [(1, 0), (3, 0), (4, -1)])
def test_sequence_enumerate(win, pad):
    x = np.random.RandomState(2).randint(0, 9, (B, T)).astype(np.int64)
    check_seq("sequence_enumerate", {"win_size": win, "pad_value": pad},
              {"X": x}, {"Out": 1})


@pytest.mark.parametrize("out_maxlen", [0, 4])
def test_sequence_slice(out_maxlen):
    check_seq("sequence_slice", {"out_maxlen": out_maxlen},
              {"X": randn(B, T, D), "Offset": np.array([0, 2, 5, 1], np.int64),
               "Length": np.array([4, 2, 0, 3], np.int64)}, {"Out": 1})


def test_sequence_scatter_adds_repeated_ids():
    ids = np.array([[0, 2, 2], [5, 5, 5], [1, 0, 3], [4, 4, 0]], np.int64)
    check_seq("sequence_scatter", {},
              {"X": randn(B, T), "Ids": ids, "Updates": randn(B, 3, seed=1)},
              {"Out": 1})


@pytest.mark.parametrize("kernels,strides", [([2, 3], [2, 1]),
                                              ([3, 3], [1, 1])])
def test_im2sequence(kernels, strides):
    check_seq("im2sequence", {"kernels": kernels, "strides": strides},
              {"X": randn(2, 3, 6, 5)}, {"Out": 1})


@pytest.mark.parametrize("future", [0, 2, 7])
def test_row_conv(future):
    check_seq("row_conv", {}, {"X": randn(B, T, D),
                               "Filter": randn(future + 1, D, seed=1)},
              {"Out": 1})


@pytest.mark.parametrize("ctx_len,ctx_start", [(3, -1), (4, 0), (2, -2)])
@pytest.mark.parametrize("with_length", [True, False])
def test_sequence_conv(ctx_len, ctx_start, with_length):
    inputs = {"X": randn(B, T, D), "Filter": randn(ctx_len * D, 7, seed=1)}
    if with_length:
        inputs["Length"] = LENGTHS
    check_seq("sequence_conv", {"contextLength": ctx_len,
                                "contextStart": ctx_start}, inputs,
              {"Out": 1})


@pytest.mark.parametrize("new_dim", [2, 8])
def test_sequence_reshape(new_dim):
    check_seq("sequence_reshape", {"new_dim": new_dim},
              {"X": randn(B, T, 4), "Length": LENGTHS},
              {"Out": 1, "OutLength": 1})


def test_lod_reset_takes_the_lengths_of_y_or_target_lod():
    check_seq("lod_reset", {}, {"X": randn(B, T, D), "Y": LENGTHS},
              {"Out": 1, "OutLength": 1})
    got, _ = check_seq("lod_reset", {"target_lod": [0, 2, 5, 5, 6]},
                       {"X": randn(B, T, D)}, {"Out": 1, "OutLength": 1})
    np.testing.assert_array_equal(got["OutLength"].numpy(), [2, 3, 0, 1])


# the op names of the sequence and RNN slice: sequence_ops.py's 15, three
# of extra_ops.py, rnn_ops.py's 9 and the CRF pair of loss_ops.py
SLICE_OPS = {
    "sequence_mask", "sequence_pool", "sequence_softmax", "sequence_reverse",
    "sequence_expand", "sequence_concat", "sequence_pad", "sequence_unpad",
    "sequence_erase", "sequence_enumerate", "sequence_slice",
    "sequence_scatter", "sequence_expand_as", "im2sequence", "row_conv",
    "sequence_conv", "sequence_reshape", "lod_reset",
    "dynamic_lstm", "dynamic_lstmp", "dynamic_gru", "lstm", "gru_unit",
    "lstm_unit", "dynamic_rnn", "gru", "lstmp",
    "linear_chain_crf", "crf_decoding",
}


def test_the_slice_registers_ops_of_the_jax_package():
    from paddle_tpu.core.registry import registered_ops as jax_ops
    from paddle_tpu_torch.core.registry import registered_ops as port_ops

    assert len(SLICE_OPS) == 29
    assert SLICE_OPS <= set(port_ops())
    assert set(port_ops()) <= set(jax_ops())
