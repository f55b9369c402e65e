"""The port trains and decodes the CRNN-CTC text recogniser as the JAX
package does.

``chip_smoke.build_crnn_ctc`` (``crnn_ctc_model.py``'s ``ctc_train_net``:
conv groups with batch norm and max pools, ``im2sequence``, two GRUs,
``warpctc(norm_by_times)``, Momentum with L2; its ``for_test`` clone's
``ctc_greedy_decoder`` and ``edit_distance``) built by both packages at
test width (1 x 16 x 64 images, filters 8, 8, 16, 16, GRUs of 16, 10
classes + the blank, batch 4), the JAX startup state carried into the
port by ``io.state_from_numpy``: 3 Momentum steps with losses to 1e-5
and every persistable 1e-5 norm-wise (the conv biases, which feed batch
norms and so have a zero gradient in exact arithmetic, and their momentum
velocities by size below 1e-7; the moving means, ~1e-9 in the deeper
groups, to 1e-12 absolute), then the decode on the trained weights with
identical ids, lengths and distances, each distance a host Levenshtein
of its pair (``chip_smoke.levenshtein``).
"""

import numpy as np

import chip_smoke
import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid

CFG = dict(image=(1, 16, 64), filters=(8, 8, 16, 16), rnn_hidden=16,
           num_classes=10, min_label=2, max_label=5)
BATCH, STEPS = 4, 3


def norm_err(got, want):
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


def run(fluid, start=None):
    main, startup, loss, extra = chip_smoke.build_crnn_ctc(fluid, **CFG)
    test, logits, decoded, decoded_len, dist, seq_num = extra
    exe = fluid.Executor(fluid.CPUPlace())
    if start is None:
        scope = fluid.Scope()
        with fluid.scope_guard(scope):
            exe.run(startup)
        start = {n: np.asarray(v) for n, v in scope.vars.items()}
    else:
        scope = fluid.io.state_from_numpy(main, start, fluid.Scope(),
                                          fluid.CPUPlace())
    feed = chip_smoke.crnn_feed(CFG, BATCH)
    with fluid.scope_guard(scope):
        losses = [float(np.asarray(exe.run(main, feed=feed,
                                           fetch_list=[loss])[0]))
                  for _ in range(STEPS)]
        decode = [np.asarray(v) for v in exe.run(
            test, feed=chip_smoke.crnn_feed(CFG, BATCH, seed=1),
            fetch_list=[decoded, decoded_len, dist, seq_num])]
    state = {n: np.asarray(scope.find_var(n)) for n in start}
    return start, losses, decode, state


def test_crnn_ctc_trains_and_decodes_as_jax_does():
    start, want_l, want_d, want_s = run(jfluid)
    _, got_l, got_d, got_s = run(tfluid, start)
    np.testing.assert_allclose(got_l, want_l, rtol=1e-5)
    assert np.isfinite(got_l).all() and got_l[-1] < got_l[0]
    for n, w in want_s.items():
        if not np.issubdtype(w.dtype, np.floating):
            continue
        if n.startswith("conv2d_") and ".b_0" in n:
            # a bias feeding a batch norm: 0 gradient in exact arithmetic
            assert np.abs(got_s[n]).max() < 1e-7 > np.abs(w).max(), n
        elif n.endswith(".mean_0"):
            # the published batch-norm scales (std 0.01) shrink each group's
            # activations, so the deeper moving means are ~1e-9: their
            # relative digits are cancellation noise
            np.testing.assert_allclose(got_s[n], w, rtol=1e-5, atol=1e-12,
                                       err_msg=n)
        else:
            assert norm_err(got_s[n], w) <= 1e-5, n
    ids, n, dist, seq_num = got_d
    for g, w in zip(got_d, want_d):
        np.testing.assert_array_equal(g, w)
    feed = chip_smoke.crnn_feed(CFG, BATCH, seed=1)
    for r in range(BATCH):
        row = list(ids[r, :n[r]])
        assert all(0 <= v < CFG["num_classes"] for v in row)
        assert (ids[r, n[r]:] == -1).all()
        assert dist[r, 0] == chip_smoke.levenshtein(
            row, list(feed["label"][r, :feed["label_length"][r]]))
    assert int(seq_num[0]) == BATCH
