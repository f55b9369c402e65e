"""The port's metric ops match the JAX package's.

``chunk_eval`` under the IOB, IOE, IOBES and plain schemes (with and
without ``Length`` and ``excluded_chunk_types``), ``precision_recall``
(weights, carried states) and ``positive_negative_pair`` (weights, ties,
accumulators) run through both registries (``check_op``) on the same
``RandomState`` inputs: float outputs to 1e-5, integer outputs
identical, dtypes included. ``chunk_eval``'s counts also equal a host
walk of each row by Fluid's ``GetSegments`` rules
(``chip_smoke.host_chunks``), the recount the card's SRL leg uses.
"""

import numpy as np
import pytest

import chip_smoke
from test_torch_dense_reduce_math import check_op

TOL = (1e-5, 1e-5)
CHUNK_OUTS = {"Precision": 1, "Recall": 1, "F1-Score": 1,
              "NumInferChunks": 1, "NumLabelChunks": 1,
              "NumCorrectChunks": 1}


def chunk_labels(scheme, nct, b=6, t=15, seed=0):
    ntag = chip_smoke.CHUNK_SCHEMES[scheme][0]
    rng = np.random.RandomState(seed)
    # one label past the tagged ones is Outside
    hi = ntag * nct + 1
    lab = rng.randint(0, hi, (b, t))
    inf = lab.copy()
    flip = rng.rand(b, t) < 0.3
    inf[flip] = rng.randint(0, hi, flip.sum())
    return inf.astype(np.int64), lab.astype(np.int64)


@pytest.mark.parametrize("scheme", ("IOB", "IOE", "IOBES", "plain"))
@pytest.mark.parametrize("variant", ("full", "length", "excluded"))
def test_chunk_eval_matches_jax_and_the_host_walk(scheme, variant):
    nct = 3
    inf, lab = chunk_labels(scheme, nct, seed=len(scheme))
    inputs = {"Inference": inf, "Label": lab}
    lengths = np.full(inf.shape[0], inf.shape[1])
    attrs = {"num_chunk_types": nct, "chunk_scheme": scheme}
    excluded = ()
    if variant == "length":
        lengths = np.array([15, 0, 1, 7, 11, 15], np.int64)
        inputs["Length"] = lengths
    elif variant == "excluded":
        excluded = (1,)
        attrs["excluded_chunk_types"] = list(excluded)
    got, _ = check_op("chunk_eval", attrs, inputs, CHUNK_OUTS, tol=TOL)
    counts = [int(got[n].numpy()[0]) for n in
              ("NumInferChunks", "NumLabelChunks", "NumCorrectChunks")]
    want = chip_smoke.host_chunk_counts(inf, lab, lengths, nct, scheme,
                                        excluded)
    assert counts == list(want)
    assert counts[2] > 0 and counts[0] > counts[2]


def test_chunk_eval_srl_labels_with_a_trailing_axis():
    # the SRL tagger's shape: 59 labels, IOB over 29 types, O = 58
    rng = np.random.RandomState(7)
    lab = rng.randint(0, 59, (4, 20, 1)).astype(np.int64)
    inf = np.where(rng.rand(4, 20, 1) < 0.2, 58, lab).astype(np.int64)
    lengths = np.array([20, 3, 17, 9], np.int64)
    got, _ = check_op("chunk_eval", {"num_chunk_types": 29,
                                     "chunk_scheme": "IOB"},
                      {"Inference": inf, "Label": lab, "Length": lengths},
                      CHUNK_OUTS, tol=TOL)
    counts = [int(got[n].numpy()[0]) for n in
              ("NumInferChunks", "NumLabelChunks", "NumCorrectChunks")]
    assert counts == list(chip_smoke.host_chunk_counts(
        inf[..., 0], lab[..., 0], lengths, 29))


@pytest.mark.parametrize("weights", (False, True))
@pytest.mark.parametrize("states", (False, True))
def test_precision_recall_matches_jax(weights, states):
    rng = np.random.RandomState(1)
    c, b = 5, 40
    inputs = {"Indices": rng.randint(0, c, (b, 1)).astype(np.int64),
              "Labels": rng.randint(0, c, (b, 1)).astype(np.int64)}
    if weights:
        inputs["Weights"] = rng.rand(b, 1).astype(np.float32)
    if states:
        inputs["StatesInfo"] = rng.randint(0, 9, (c, 4)).astype(np.float32)
    check_op("precision_recall", {"class_number": c}, inputs,
             {"BatchMetrics": 1, "AccumMetrics": 1, "AccumStatesInfo": 1},
             tol=TOL, diff=[])


@pytest.mark.parametrize("weight", (False, True))
@pytest.mark.parametrize("accumulate", (False, True))
def test_positive_negative_pair_matches_jax(weight, accumulate):
    rng = np.random.RandomState(2)
    n = 30
    score = rng.randint(0, 4, (n, 2)).astype(np.float32)  # ties
    inputs = {"Score": score,
              "Label": rng.randint(0, 3, (n, 1)).astype(np.float32),
              "QueryID": rng.randint(0, 4, (n, 1)).astype(np.int64)}
    if weight:
        inputs["Weight"] = rng.rand(n, 1).astype(np.float32)
    if accumulate:
        for name in ("PositivePair", "NegativePair", "NeutralPair"):
            inputs["Accumulate" + name] = rng.rand(1).astype(np.float32)
    got, _ = check_op("positive_negative_pair", {"column": 1}, inputs,
                      {"PositivePair": 1, "NegativePair": 1,
                       "NeutralPair": 1}, tol=TOL, diff=[])
    assert float(got["NeutralPair"]) > 0
