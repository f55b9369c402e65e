"""The port's reduce ops and the dense math ops match the JAX package's.

Each op runs through each package's registered implementation on the
same ``RandomState`` inputs, and its gradient against one random
cotangent a float output through each package's autodiff (``jax.vjp``,
``torch.autograd.grad``): elementwise outputs to 1e-6 relative,
reductions and norms to 1e-5, gradients to 1e-5 (each with as much
absolute slack near 0); integer and bool outputs exactly, dtype
included. bf16 inputs (the dtype an op sees under ``amp.decorate``)
give the JAX package's dtype and agree to 2e-2.

The harness here (``check_op``) serves the other dense-op test files.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu  # noqa: F401  (registers the JAX package's ops)
import paddle_tpu_torch  # noqa: F401
from paddle_tpu.core import registry as jreg
from paddle_tpu_torch.core import registry as treg

ELEMENTWISE = (1e-6, 1e-6)
REDUCTION = (1e-5, 1e-5)
GRAD = (1e-5, 1e-5)
BF16 = (2e-2, 2e-2)


def _in_names(inputs):
    return {s: ["%s%d" % (s, i) for i in range(len(v))]
            if isinstance(v, list) else [s] for s, v in inputs.items()}


def _flat(inputs):
    out = {}
    for s, v in inputs.items():
        if isinstance(v, list):
            out.update(("%s%d" % (s, i), a) for i, a in enumerate(v))
        else:
            out[s] = v
    return out


def _out_names(outs):
    """{slot: count} -> {slot: [names]}"""
    return {s: [s] if n == 1 else ["%s%d" % (s, i) for i in range(n)]
            for s, n in outs.items()}


def fake_op(op_type, attrs, inputs, outs):
    return types.SimpleNamespace(
        type=op_type, attrs=dict(attrs), block=None,
        inputs=_in_names(inputs), outputs=_out_names(outs))


def _is_float(a):
    return np.issubdtype(np.asarray(a).dtype, np.floating) \
        or np.asarray(a).dtype == jnp.bfloat16


def _jnp(a):
    return jnp.asarray(a)


def _torch(a):
    a = np.asarray(a)
    if a.dtype == jnp.bfloat16:
        return torch.tensor(a.astype(np.float32)).to(torch.bfloat16)
    return torch.tensor(a)


def _np(t):
    if isinstance(t, torch.Tensor):
        t = t.detach()
        return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()
    t = np.asarray(t)
    return t.astype(np.float32) if t.dtype == jnp.bfloat16 else t


def _dtype_name(t):
    if isinstance(t, torch.Tensor):
        return str(t.dtype).replace("torch.", "")
    return str(np.asarray(t).dtype)


def run_jax(op_type, attrs, inputs, outs, diff, cot_seed=1):
    """({out name: array}, {input name: grad}, cotangents) of the JAX
    package's op; the gradient of the float outputs against random
    cotangents, taken for the input names in ``diff``."""
    flat = _flat(inputs)
    out_names = [n for ns in _out_names(outs).values() for n in ns]
    trace = types.SimpleNamespace(is_test=False)

    def run(env):
        jreg.get_op_impl(op_type)(jreg.OpContext(
            fake_op(op_type, attrs, inputs, outs), env, trace))
        return env

    env = run({n: _jnp(v) for n, v in flat.items()})
    got = {n: env[n] for n in out_names if n in env}
    fouts = [n for n in got if _is_float(got[n])]
    rng = np.random.RandomState(cot_seed)
    cots = {n: np.asarray(rng.randn(*np.shape(got[n])), np.float32)
            for n in fouts}
    grads = {}
    if diff and fouts:
        def f(*vals):
            e = {n: _jnp(v) for n, v in flat.items()}
            e.update(zip(diff, vals))
            e = run(e)
            return [e[n] for n in fouts]

        _, vjp = jax.vjp(f, *[_jnp(flat[n]) for n in diff])
        gs = vjp([jnp.asarray(cots[n]).astype(got[n].dtype) for n in fouts])
        grads = dict(zip(diff, gs))
    return got, grads, cots


def run_port(op_type, attrs, inputs, outs, diff, cots, trace=None):
    """The port's op on ``inputs``; ``trace`` (by default one on the CPU
    with no generator) is the context the op sees."""
    flat = _flat(inputs)
    out_names = [n for ns in _out_names(outs).values() for n in ns]
    env = {n: _torch(v) for n, v in flat.items()}
    for n in diff:
        env[n].requires_grad_(True)
    leaves = [env[n] for n in diff]
    if trace is None:
        trace = types.SimpleNamespace(is_test=False, program=None,
                                      device=torch.device("cpu"))
    treg.get_op_impl(op_type)(treg.OpContext(
        fake_op(op_type, attrs, inputs, outs), env, trace))
    got = {n: env[n] for n in out_names if n in env}
    grads = {}
    fouts = [n for n in cots if got[n].requires_grad]
    if diff and fouts:
        gs = torch.autograd.grad(
            [got[n] for n in fouts], leaves,
            [_torch(cots[n]).to(got[n].dtype) for n in fouts],
            allow_unused=True)
        grads = {n: torch.zeros_like(env[n]) if g is None else g
                 for n, g in zip(diff, gs)}
    return got, grads


def check_op(op_type, attrs, inputs, outs, tol=ELEMENTWISE, grad_tol=GRAD,
             diff=None):
    """Runs ``op_type`` through both packages and compares every output
    (float ones to ``tol``, others exactly, dtypes equal) and, for the
    float inputs (or ``diff``), every gradient to ``grad_tol``."""
    flat = _flat(inputs)
    if diff is None:
        diff = [n for n, v in flat.items() if _is_float(v)]
    want, want_g, cots = run_jax(op_type, attrs, inputs, outs, diff)
    got, got_g = run_port(op_type, attrs, inputs, outs, diff, cots)
    assert set(got) == set(want), (sorted(got), sorted(want))
    for n in want:
        w, g = want[n], got[n]
        assert _dtype_name(g) == _dtype_name(w), (n, _dtype_name(g),
                                                  _dtype_name(w))
        assert tuple(g.shape) == tuple(np.shape(w)), (n, g.shape,
                                                      np.shape(w))
        if _is_float(w):
            np.testing.assert_allclose(_np(g), _np(w), rtol=tol[0],
                                       atol=tol[1], err_msg=n)
        else:
            np.testing.assert_array_equal(_np(g), _np(w), err_msg=n)
    for n in want_g:
        np.testing.assert_allclose(_np(got_g[n]), _np(want_g[n]),
                                   rtol=grad_tol[0], atol=grad_tol[1],
                                   err_msg="grad " + n)
    return got, want


def randn(*shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


SHAPE = (4, 6, 5)

# -- reduce ops ---------------------------------------------------------------

REDUCE_ATTRS = {
    "dim1": {"dim": [1]},
    "dim02_keep": {"dim": [0, 2], "keep_dim": True},
    "neg": {"dim": [-1]},
    "all": {"reduce_all": True},
}
REDUCE_OPS = ("reduce_sum", "reduce_mean", "reduce_max", "reduce_min",
              "reduce_prod", "logsumexp")


@pytest.mark.parametrize("attrs", sorted(REDUCE_ATTRS))
@pytest.mark.parametrize("op_type", REDUCE_OPS)
def test_reduce_matches_jax(op_type, attrs):
    x = randn(*SHAPE)
    if op_type == "reduce_prod":
        x = 0.5 + np.abs(x) / 4  # keep the product inside float32
    check_op(op_type, REDUCE_ATTRS[attrs], {"X": x}, {"Out": 1},
             tol=REDUCTION)


@pytest.mark.parametrize("op_type", ("reduce_max", "reduce_min"))
def test_reduce_extremes_split_the_gradient_among_ties(op_type):
    # few distinct values: every row has tied maxima and minima
    x = np.random.RandomState(3).randint(0, 3, SHAPE).astype(np.float32)
    for attrs in REDUCE_ATTRS.values():
        check_op(op_type, attrs, {"X": x}, {"Out": 1}, tol=REDUCTION)


def test_reduce_prod_gradient_through_a_zero():
    x = 0.5 + np.abs(randn(*SHAPE)) / 4
    x[1, 2, 3] = 0.0
    x[2, 4, :2] = 0.0
    check_op("reduce_prod", {"dim": [2]}, {"X": x}, {"Out": 1},
             tol=REDUCTION)


@pytest.mark.parametrize("attrs", sorted(REDUCE_ATTRS))
@pytest.mark.parametrize("op_type", ("reduce_all", "reduce_any"))
def test_reduce_bool_matches_jax(op_type, attrs):
    x = np.random.RandomState(4).rand(*SHAPE) > 0.3
    check_op(op_type, REDUCE_ATTRS[attrs], {"X": x}, {"Out": 1})


@pytest.mark.parametrize("op_type", ("reduce_mean", "reduce_sum",
                                     "logsumexp", "reduce_max"))
def test_reduce_bf16_matches_jax(op_type):
    x = randn(*SHAPE).astype(jnp.bfloat16)
    check_op(op_type, {"dim": [2]}, {"X": x}, {"Out": 1}, tol=BF16,
             grad_tol=BF16)


# -- math ops -----------------------------------------------------------------


def _away_from_integers(q):
    """q with every value within 0.05 of an integer moved 0.2 off it."""
    return np.where(np.abs(q - np.round(q)) < 0.05, q + 0.2, q)


def mod_inputs(seed=0):
    rng = np.random.RandomState(seed)
    y = (rng.rand(*SHAPE) + 0.5) * np.where(rng.rand(*SHAPE) < 0.5, -1, 1)
    q = _away_from_integers(rng.randn(*SHAPE) * 4)
    return {"X": (q * y).astype(np.float32), "Y": y.astype(np.float32)}


@pytest.mark.parametrize("op_type", ("elementwise_mod",
                                     "elementwise_floordiv"))
def test_mod_floordiv_float_match_jax(op_type):
    check_op(op_type, {}, mod_inputs(), {"Out": 1}, tol=(1e-5, 1e-5))


@pytest.mark.parametrize("op_type", ("elementwise_mod",
                                     "elementwise_floordiv"))
def test_mod_floordiv_int_match_jax_python_signs(op_type):
    rng = np.random.RandomState(1)
    x = rng.randint(-20, 20, SHAPE).astype(np.int32)
    y = rng.randint(1, 6, SHAPE) * np.where(rng.rand(*SHAPE) < 0.5, -1, 1)
    check_op(op_type, {}, {"X": x, "Y": y.astype(np.int32)}, {"Out": 1})


def test_mod_broadcasts_along_axis():
    inp = mod_inputs()
    inp["Y"] = np.abs(inp["Y"][0, :, 0]) + 0.5
    check_op("elementwise_mod", {"axis": 1}, inp, {"Out": 1},
             tol=(1e-5, 1e-5))


CUMSUM = {
    "default": {},
    "axis0": {"axis": 0},
    "exclusive": {"axis": 1, "exclusive": True},
    "reverse": {"axis": 2, "reverse": True},
    "exclusive_reverse": {"axis": 1, "exclusive": True, "reverse": True},
}


@pytest.mark.parametrize("attrs", sorted(CUMSUM))
def test_cumsum_matches_jax(attrs):
    check_op("cumsum", CUMSUM[attrs], {"X": randn(*SHAPE)}, {"Out": 1},
             tol=REDUCTION)


def test_cumsum_int_exact():
    x = np.random.RandomState(2).randint(-9, 9, SHAPE).astype(np.int32)
    check_op("cumsum", {"axis": 1, "exclusive": True, "reverse": True},
             {"X": x}, {"Out": 1})


MATH_CASES = {
    "norm": ({"axis": 1, "epsilon": 1e-10}, lambda: {"X": randn(*SHAPE)},
             {"Out": 1, "Norm": 1}, REDUCTION),
    "norm_last": ({}, lambda: {"X": randn(*SHAPE)}, {"Out": 1, "Norm": 1},
                  REDUCTION),
    "l1_norm": ({}, lambda: {"X": randn(*SHAPE)}, {"Out": 1}, REDUCTION),
    "squared_l2_distance": ({}, lambda: {"X": randn(4, 6, 5),
                                         "Y": randn(4, 6, 5, seed=1)},
                            {"Out": 1, "sub_result": 1}, REDUCTION),
    "squared_l2_distance_bcast": ({}, lambda: {"X": randn(4, 7),
                                               "Y": randn(1, 7, seed=1)},
                                  {"Out": 1, "sub_result": 1}, REDUCTION),
    "cos_sim": ({}, lambda: {"X": randn(4, 7), "Y": randn(4, 7, seed=1)},
                {"Out": 1, "XNorm": 1, "YNorm": 1}, REDUCTION),
    "minus": ({}, lambda: {"X": randn(*SHAPE), "Y": randn(*SHAPE, seed=1)},
              {"Out": 1}, ELEMENTWISE),
    "bilinear_tensor_product": (
        {}, lambda: {"X": randn(4, 3), "Y": randn(4, 5, seed=1),
                     "Weight": randn(6, 3, 5, seed=2),
                     "Bias": randn(1, 6, seed=3)}, {"Out": 1}, REDUCTION),
    "bilinear_tensor_product_nobias": (
        {}, lambda: {"X": randn(4, 3), "Y": randn(4, 5, seed=1),
                     "Weight": randn(6, 3, 5, seed=2)}, {"Out": 1},
        REDUCTION),
    "dot": ({}, lambda: {"X": randn(4, 7), "Y": randn(4, 7, seed=1)},
            {"Out": 1}, REDUCTION),
}


@pytest.mark.parametrize("case", sorted(MATH_CASES))
def test_math_op_matches_jax(case):
    attrs, inputs, outs, tol = MATH_CASES[case]
    op_type = case.replace("_last", "").replace("_bcast", "").replace(
        "_nobias", "")
    check_op(op_type, attrs, inputs(), outs, tol=tol)


def test_l1_norm_gradient_at_zero_is_jax_subgradient():
    x = np.array([[-1.0, 0.0, 2.0], [0.0, 0.0, -3.0]], np.float32)
    got, _ = check_op("l1_norm", {}, {"X": x}, {"Out": 1})


def special_values(kind):
    x = randn(*SHAPE)
    if kind == "nan":
        x[1, 2, 3] = np.nan
    elif kind == "inf":
        x[0, 0, 0] = np.inf
    elif kind == "neg_inf":
        x[3, 5, 4] = -np.inf
    return x


@pytest.mark.parametrize("kind", ("finite", "nan", "inf", "neg_inf"))
@pytest.mark.parametrize("op_type", ("isfinite", "has_inf", "has_nan"))
def test_finiteness_checks_match_jax(op_type, kind):
    got, _ = check_op(op_type, {}, {"X": special_values(kind)}, {"Out": 1},
                      diff=[])
    out = got["Out"]
    assert out.dtype == torch.bool and out.dim() == 0
