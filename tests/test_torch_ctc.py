"""The port's CTC ops match the JAX package's and PyTorch's CTC.

``warpctc`` (log-softmax over C, then the alpha recursion over padded
[B, T, C] with ``LogitsLength`` and ``LabelLength``) runs through both
packages' registries on the same ``RandomState`` inputs, forward and
gradient, to 1e-5, with and without ``norm_by_times``; the same loss and
its gradient in the raw logits match ``torch.nn.functional.ctc_loss`` on
the CPU to 1e-5. ``ctc_align`` (the greedy decode's collapse) and
``edit_distance`` give identical outputs, dtypes included, and every
distance equals a host Levenshtein of the pair
(``chip_smoke.levenshtein``, the card's check).
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import chip_smoke
from test_torch_dense_reduce_math import check_op, run_port

CTC_TOL = (1e-5, 1e-5)


def ctc_inputs(b=5, t=14, c=7, l=5, blank=0, seed=0):
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, c, (b, l))
    labels[labels == blank] = (blank + 1) % c       # no blank in a label
    labels[1, 1] = labels[1, 0]                     # a repeated label
    logit_len = np.array([t, t - 3, 6, t, 2 * l + 1][:b], np.int64)
    label_len = np.array([l, 3, 1, 0, l][:b], np.int64)
    return {"Logits": rng.randn(b, t, c).astype(np.float32) * 2,
            "Label": labels.astype(np.int64),
            "LogitsLength": logit_len, "LabelLength": label_len}


@pytest.mark.parametrize("norm_by_times", (False, True))
@pytest.mark.parametrize("blank", (0, 6))
def test_warpctc_matches_jax(norm_by_times, blank):
    inputs = ctc_inputs(blank=blank)
    check_op("warpctc", {"blank": blank, "norm_by_times": norm_by_times},
             inputs, {"Loss": 1}, tol=CTC_TOL, grad_tol=CTC_TOL,
             diff=["Logits"])


@pytest.mark.parametrize("blank", (0, 6))
def test_warpctc_matches_torch_ctc_loss(blank):
    inputs = ctc_inputs(blank=blank, seed=1)
    # F.ctc_loss needs every row long enough for its label
    inputs["LabelLength"] = np.array([5, 3, 1, 1, 5], np.int64)
    got, grads = run_port("warpctc", {"blank": blank}, inputs, {"Loss": 1},
                          ["Logits"], {"Loss": np.ones((5, 1), np.float32)})
    x = torch.tensor(inputs["Logits"], requires_grad=True)
    want = F.ctc_loss(torch.log_softmax(x, -1).transpose(0, 1),
                      torch.tensor(inputs["Label"]),
                      torch.tensor(inputs["LogitsLength"]),
                      torch.tensor(inputs["LabelLength"]), blank=blank,
                      reduction="none")
    want_g, = torch.autograd.grad(want.sum(), x)
    np.testing.assert_allclose(got["Loss"].detach().numpy()[:, 0],
                               want.detach().numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(grads["Logits"].numpy(), want_g.numpy(),
                               rtol=1e-5, atol=1e-5)


def test_warpctc_gradient_is_the_same_every_run():
    inputs = ctc_inputs(seed=2)
    cot = {"Loss": np.ones((5, 1), np.float32)}
    a = run_port("warpctc", {"blank": 0}, inputs, {"Loss": 1}, ["Logits"],
                 cot)[1]["Logits"]
    b = run_port("warpctc", {"blank": 0}, inputs, {"Loss": 1}, ["Logits"],
                 cot)[1]["Logits"]
    assert torch.equal(a, b)


def greedy_ids(b=6, t=16, c=5, seed=3):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, c, (b, t))
    ids[0] = 0                                      # all blanks
    ids[1, :] = 2                                   # one repeated id
    return ids


@pytest.mark.parametrize("blank", (0, 4))
@pytest.mark.parametrize("with_length", (False, True))
def test_ctc_align_matches_jax(blank, with_length):
    inputs = {"Input": greedy_ids().astype(np.int64)}
    if with_length:
        inputs["Length"] = np.array([16, 9, 0, 5, 16, 1], np.int64)
    got, _ = check_op("ctc_align", {"blank": blank}, inputs,
                      {"Output": 1, "OutputLength": 1})
    out = got["Output"].numpy()
    n = got["OutputLength"].numpy()
    # the collapse by hand
    lens = inputs.get("Length", np.full(6, 16))
    for row, ln, o, k in zip(inputs["Input"], lens, out, n):
        keep, prev = [], -1
        for v in row[:ln]:
            if v != blank and v != prev:
                keep.append(v)
            prev = v
        assert list(o[:k]) == keep and (o[k:] == -1).all()


@pytest.mark.parametrize("normalized", (False, True))
def test_edit_distance_matches_jax_and_host(normalized):
    rng = np.random.RandomState(4)
    b, lh, lr = 7, 9, 6
    hyps = rng.randint(0, 4, (b, lh)).astype(np.int64)
    refs = rng.randint(0, 4, (b, lr)).astype(np.int64)
    hl = np.array([9, 0, 3, 9, 5, 1, 7], np.int64)
    rl = np.array([6, 4, 0, 6, 2, 1, 6], np.int64)
    inputs = {"Hyps": hyps, "Refs": refs, "HypsLength": hl,
              "RefsLength": rl}
    got, want = check_op("edit_distance", {"normalized": normalized},
                         inputs, {"Out": 1, "SequenceNum": 1})
    np.testing.assert_array_equal(got["Out"].numpy(),
                                  np.asarray(want["Out"]))
    host = np.array([chip_smoke.levenshtein(h[:m], r[:n])
                     for h, r, m, n in zip(hyps, refs, hl, rl)], np.float32)
    if normalized:
        host = host / np.maximum(rl, 1).astype(np.float32)
    np.testing.assert_array_equal(got["Out"].numpy()[:, 0], host)


def test_edit_distance_without_lengths_uses_the_full_rows():
    rng = np.random.RandomState(5)
    inputs = {"Hyps": rng.randint(0, 3, (4, 5)).astype(np.int64),
              "Refs": rng.randint(0, 3, (4, 8)).astype(np.int64)}
    got, _ = check_op("edit_distance", {}, inputs,
                      {"Out": 1, "SequenceNum": 1})
    host = [chip_smoke.levenshtein(h, r)
            for h, r in zip(inputs["Hyps"], inputs["Refs"])]
    np.testing.assert_array_equal(got["Out"].numpy()[:, 0], host)
