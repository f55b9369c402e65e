"""The port's linear-chain CRF matches the JAX package's and a brute force.

``linear_chain_crf`` (the cost -(gold path score - log Z) over a [D+2, D]
transition: start row, stop row, then D x D) and ``crf_decoding``
(Viterbi, int32 paths, 0 at the padding; with ``Label`` the mismatch
mask) run through each package's registered implementation on the same
``RandomState`` inputs: outputs and the gradients of the cost with
respect to the emission and the transition to 1e-5, paths identical.
Both are also held to a float64 enumeration of every path at T <= 4,
D <= 3 (the cost and its gradients to 1e-5, the best path identical),
and Viterbi ties go to the first index in both packages.
"""

import itertools

import numpy as np
import pytest
import torch

from test_torch_dense_reduce_math import run_port
from test_torch_sequence_ops import check_seq

CRF_OUTS = {"LogLikelihood": 1, "Alpha": 1, "EmissionExps": 1,
            "TransitionExps": 1}


def crf_inputs(b, t, d, lengths, seed=0, label=True):
    rng = np.random.RandomState(seed)
    inputs = {"Emission": rng.randn(b, t, d).astype(np.float32),
              "Transition": (rng.randn(d + 2, d) * 0.5).astype(np.float32),
              "Length": np.asarray(lengths, np.int64)}
    if label:
        inputs["Label"] = rng.randint(0, d, (b, t)).astype(np.int64)
    return inputs


CASES = {
    "mixed": (4, 6, 5, [6, 1, 0, 3]),
    "full": (3, 5, 4, [5, 5, 5]),
    "srl_labels": (2, 7, 59, [7, 4]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_linear_chain_crf_matches_jax(case):
    b, t, d, lengths = CASES[case]
    check_seq("linear_chain_crf", {}, crf_inputs(b, t, d, lengths),
              CRF_OUTS)


def test_linear_chain_crf_label_with_a_trailing_dim():
    inputs = crf_inputs(3, 4, 3, [4, 2, 1])
    inputs["Label"] = inputs["Label"][..., None]
    check_seq("linear_chain_crf", {}, inputs, CRF_OUTS)


def test_linear_chain_crf_without_length():
    inputs = crf_inputs(3, 4, 3, [4, 4, 4])
    del inputs["Length"]
    check_seq("linear_chain_crf", {}, inputs, CRF_OUTS)


def brute_force(em, trans, label, length):
    """float64 (cost, best path) of one row by enumerating every path of
    its length (a row of length 0 scores as one of length 1); ``em`` and
    ``trans`` are float64 tensors, so the cost carries their gradients."""
    start, stop, tr = trans[0], trans[1], trans[2:]
    n = max(int(length), 1)
    d = em.shape[1]

    def score(path):
        s = start[path[0]] + em[0, path[0]]
        for k in range(1, n):
            s = s + tr[path[k - 1], path[k]] + em[k, path[k]]
        return s + stop[path[n - 1]]

    paths = list(itertools.product(range(d), repeat=n))
    scores = torch.stack([score(p) for p in paths])
    gold = score([int(v) for v in label[:n]])
    return torch.logsumexp(scores, 0) - gold, paths[int(scores.argmax())]


@pytest.mark.parametrize("t,d", [(1, 3), (3, 2), (4, 3)])
def test_crf_against_every_path(t, d):
    """Cost, its gradients and the Viterbi path of the float32 op against
    a float64 enumeration of every path."""
    lengths = [t, max(t - 1, 0), 1, 0]
    inputs = crf_inputs(4, t, d, lengths, seed=t * 10 + d)
    got, grads = run_port("linear_chain_crf", {}, inputs, CRF_OUTS,
                          ["Emission", "Transition"],
                          {"LogLikelihood": np.ones((4, 1), np.float32)})
    path, _ = run_port("crf_decoding", {},
                       {k: v for k, v in inputs.items() if k != "Label"},
                       {"ViterbiPath": 1}, [], {})
    cost = got["LogLikelihood"].detach().numpy()[:, 0]
    path = path["ViterbiPath"].numpy()
    em = torch.tensor(inputs["Emission"], dtype=torch.float64,
                      requires_grad=True)
    trans = torch.tensor(inputs["Transition"], dtype=torch.float64,
                         requires_grad=True)
    total = 0.0
    for i in range(4):
        want, best = brute_force(em[i], trans, inputs["Label"][i],
                                 lengths[i])
        total = total + want
        np.testing.assert_allclose(cost[i], float(want.detach()), rtol=1e-5,
                                   atol=1e-5)
        n = lengths[i]
        np.testing.assert_array_equal(path[i, :n], best[:n])
        assert not path[i, n:].any()
    g_em, g_tr = torch.autograd.grad(total, [em, trans])
    np.testing.assert_allclose(grads["Emission"].numpy(), g_em.numpy(),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(grads["Transition"].numpy(), g_tr.numpy(),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", sorted(CASES))
def test_crf_decoding_matches_jax(case):
    b, t, d, lengths = CASES[case]
    inputs = crf_inputs(b, t, d, lengths, seed=1, label=False)
    got, _ = check_seq("crf_decoding", {}, inputs, {"ViterbiPath": 1})
    path = got["ViterbiPath"]
    assert path.dtype == torch.int32
    assert int(path.min()) >= 0 and int(path.max()) < d


def test_crf_decoding_mismatch_mode():
    inputs = crf_inputs(4, 6, 5, [6, 1, 0, 3], seed=2)
    got, _ = check_seq("crf_decoding", {}, inputs, {"ViterbiPath": 1})
    plain = {k: v for k, v in inputs.items() if k != "Label"}
    path, _ = check_seq("crf_decoding", {}, plain, {"ViterbiPath": 1})
    mask = np.arange(6)[None] < inputs["Length"][:, None]
    want = ((path["ViterbiPath"].numpy() != inputs["Label"]) & mask)
    np.testing.assert_array_equal(got["ViterbiPath"].numpy(),
                                  want.astype(np.int32))


def test_crf_decoding_ties_go_to_the_first_index():
    """Equal emissions and transitions: every candidate ties, so the
    path is all 0 in both packages."""
    inputs = {"Emission": np.zeros((2, 5, 4), np.float32),
              "Transition": np.zeros((6, 4), np.float32),
              "Length": np.array([5, 3], np.int64)}
    got, _ = check_seq("crf_decoding", {}, inputs, {"ViterbiPath": 1})
    assert not got["ViterbiPath"].numpy().any()
    inputs["Transition"][2:, 1] = 1.0   # every step prefers label 1
    inputs["Transition"][2:, 3] = 1.0   # ... tied with label 3
    got, _ = check_seq("crf_decoding", {}, inputs, {"ViterbiPath": 1})
    np.testing.assert_array_equal(got["ViterbiPath"].numpy()[0, 1:], 1)
