"""The port's beam search matches the JAX package's.

On the CPU, each program built by both packages from the same feeds and,
where it has parameters, the JAX startup state carried by
``io.state_from_numpy``:

* ``beam_search``, one step over [B, K, V]: finished beams (they keep
  ``end_id`` and their score), ``is_accumulated``, and exact ties (the
  usual start scores ``[0, -1e9, ...]`` tie every unborn beam's
  candidates, and a row of equal log-probs ties them all): ids and
  parents identical, scores 1e-6; ``SelectedIds`` in ``PreIds``' dtype,
  ``ParentIdx`` int32 whatever the layer declares;
* ``beam_search_decode``'s backtrack over arrays written for fewer steps
  than their capacity (``end_id`` past the count);
* the JAX package's ``While`` GRU-LM decode (``tests/test_beam_search.py``)
  from one set of weights: ids identical, scores 1e-5;
* ``chip_smoke.build_nmt_decode``, the NMT model's decoder under
  ``While`` (dict 50, widths 8, beam 3, ``max_len`` 6): ids identical,
  scores 1e-5, each score the sum of its path's log-probs rescored by the
  teacher-forced StaticRNN (``build_nmt_rescore``), and the loop's
  early exit when every beam has ended;
* the layer's refusals (``ids``, no ``parents``) are the JAX layer's.
"""

import numpy as np
import pytest

import chip_smoke
import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid

B, K, V = 2, 3, 7


def run(fluid, build, feed, start=None, edit=None):
    """(fetched arrays, the startup state) of one run of ``build``'s
    program; the port starts from ``start``, the JAX package from its
    startup with ``edit`` ({name: array}) set into its scope."""
    main, startup, fetch = build(fluid)
    exe = fluid.Executor(fluid.CPUPlace())
    if start is None:
        scope = fluid.Scope()
        with fluid.scope_guard(scope):
            exe.run(startup)
        for n, v in (edit or {}).items():
            scope.set_var(n, v)
    else:
        scope = fluid.io.state_from_numpy(main, start, fluid.Scope(),
                                          fluid.CPUPlace())
    state = {n: np.asarray(v) for n, v in scope.vars.items()}
    with fluid.scope_guard(scope):
        out = [np.asarray(v) for v in exe.run(main, feed=feed,
                                              fetch_list=fetch)]
    return out, state


def both(build, feed):
    want, start = run(jfluid, build, feed)
    got, _ = run(tfluid, build, feed, start=start)
    return got, want


def beam_step(is_accumulated=False):
    def build(fluid):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup), fluid.unique_name.guard():
            pre_ids = fluid.layers.data("pre_ids", [B, K], "int64",
                                        append_batch_size=False)
            pre_scores = fluid.layers.data("pre_scores", [B, K], "float32",
                                           append_batch_size=False)
            logp = fluid.layers.data("logp", [B, K, V], "float32",
                                     append_batch_size=False)
            sid, ssc, par = fluid.layers.beam_search(
                pre_ids, pre_scores, None, logp, beam_size=K, end_id=0,
                is_accumulated=is_accumulated)
        return main, startup, [sid, ssc, par]
    return build


def step_feed(case):
    rng = np.random.RandomState(0)
    logp = np.log(rng.dirichlet(np.ones(V), size=(B, K))).astype("float32")
    pre_scores = rng.randn(B, K).astype("float32")
    pre_ids = np.array([[1, 2, 0], [4, 0, 5]], "int64")  # some finished
    if case == "start":  # every beam but the first unborn
        pre_ids[:] = 3
        pre_scores[:] = [0.0, -1e9, -1e9]
    elif case == "ties":  # row 1: every candidate of every beam equal
        logp[1] = -2.0
        pre_scores[1] = 0.5
        pre_ids[1] = 3
    return {"pre_ids": pre_ids, "pre_scores": pre_scores, "logp": logp}


def np_beam_step(pre_ids, pre_scores, logp, end_id, accumulated):
    """``tests/test_beam_search.py``'s numpy step, with a stable sort (the
    lower index first among equal scores, as ``jax.lax.top_k``)."""
    total = logp.copy() if accumulated else pre_scores[..., None] + logp
    for b in range(B):
        for k in range(K):
            if pre_ids[b, k] == end_id:
                total[b, k, :] = -1e9
                total[b, k, end_id] = pre_scores[b, k]
    flat = total.reshape(B, K * V)
    idx = np.argsort(-flat, axis=1, kind="stable")[:, :K]
    return idx % V, np.take_along_axis(flat, idx, axis=1), idx // V


@pytest.mark.parametrize("case", ["finished", "start", "ties"])
@pytest.mark.parametrize("accumulated", [False, True])
def test_beam_search_step_is_the_jax_ops(case, accumulated):
    feed = step_feed(case)
    (sid, ssc, par), (w_sid, w_ssc, w_par) = both(beam_step(accumulated),
                                                  feed)
    np.testing.assert_array_equal(sid, w_sid)
    np.testing.assert_array_equal(par, w_par)
    np.testing.assert_allclose(ssc, w_ssc, rtol=1e-6, atol=1e-6)
    assert sid.dtype == np.int64 and par.dtype == np.int32
    assert ssc.dtype == np.float32
    want = np_beam_step(feed["pre_ids"], feed["pre_scores"], feed["logp"],
                        0, accumulated)
    np.testing.assert_array_equal(sid, want[0])
    np.testing.assert_array_equal(par, want[2])
    if case == "ties":  # all K·V candidates of row 1 tie: the first K win
        np.testing.assert_array_equal(sid[1], [0, 1, 2])
        np.testing.assert_array_equal(par[1], [0, 0, 0])


CAP, STEPS = 6, 4


def build_decode(fluid):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        ids = fluid.layers.data("ids", [STEPS, B, K], "int64",
                                append_batch_size=False)
        parents = fluid.layers.data("parents", [STEPS, B, K], "int64",
                                    append_batch_size=False)
        scores = fluid.layers.data("scores", [B, K], "float32",
                                   append_batch_size=False)
        ids_arr = par_arr = None
        for t in range(STEPS):
            i = fluid.layers.fill_constant([1], "int64", t)
            row = fluid.layers.squeeze(fluid.layers.slice(
                ids, axes=[0], starts=[t], ends=[t + 1]), axes=[0])
            par = fluid.layers.squeeze(fluid.layers.slice(
                parents, axes=[0], starts=[t], ends=[t + 1]), axes=[0])
            ids_arr = fluid.layers.array_write(row, i, array=ids_arr,
                                               capacity=CAP)
            par_arr = fluid.layers.array_write(par, i, array=par_arr,
                                               capacity=CAP)
        sent_ids, sent_scores = fluid.layers.beam_search_decode(
            ids_arr, scores, beam_size=K, end_id=9, parents=par_arr)
    return main, startup, [sent_ids, sent_scores]


def test_beam_search_decode_backtracks_as_the_jax_op():
    rng = np.random.RandomState(1)
    feed = {"ids": rng.randint(2, 9, (STEPS, B, K)).astype("int64"),
            "parents": rng.randint(0, K, (STEPS, B, K)).astype("int64"),
            "scores": rng.randn(B, K).astype("float32")}
    (sent, scores), (w_sent, w_scores) = both(build_decode, feed)
    np.testing.assert_array_equal(sent, w_sent)
    np.testing.assert_array_equal(scores, w_scores)
    assert sent.shape == (B, K, CAP) and (sent[:, :, STEPS:] == 9).all()
    cur = np.tile(np.arange(K), (B, 1))
    for t in range(STEPS - 1, -1, -1):
        rows = np.arange(B)[:, None]
        np.testing.assert_array_equal(sent[:, :, t], feed["ids"][t][rows,
                                                                   cur])
        cur = feed["parents"][t][rows, cur]


def build_gru_lm_decode(fluid):
    """``tests/test_beam_search.py``'s ``While`` + ``beam_search`` +
    TensorArrays decode of a tiny GRU LM, its parameters made inside the
    loop's block."""
    Bb, Kk, Vv, E, H, max_len = 2, 3, 11, 6, 8, 5
    bos, eos = 1, 0
    L = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 9
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        pre_ids = L.assign(np.full((Bb, Kk), bos, "int64"))
        pre_scores = L.assign(
            np.tile(np.array([0.0] + [-1e9] * (Kk - 1), "float32"), (Bb, 1)))
        state = L.assign(np.zeros((Bb * Kk, H), "float32"))
        offset = L.assign((np.arange(Bb)[:, None] * Kk).astype("int64"))
        i = L.fill_constant([1], "int64", 0)
        n = L.fill_constant([1], "int64", max_len)
        zero = L.fill_constant([1], "int64", 0)
        ids_arr = L.array_write(L.assign(np.zeros((Bb, Kk), "int64")), zero,
                                capacity=max_len)
        par_arr = L.array_write(L.assign(np.zeros((Bb, Kk), "int64")), zero,
                                capacity=max_len)
        cond = L.less_than(i, n)
        w = L.While(cond)
        with w.block():
            emb = L.embedding(pre_ids, size=[Vv, E],
                              param_attr=fluid.ParamAttr(name="emb_w"))
            gates = L.fc(L.reshape(emb, [Bb * Kk, E]), size=3 * H,
                         param_attr=fluid.ParamAttr(name="in_w"),
                         bias_attr=fluid.ParamAttr(name="in_b"))
            h, _, _ = L.gru_unit(
                gates, state, size=3 * H,
                param_attr=fluid.ParamAttr(name="gru_w"),
                bias_attr=fluid.ParamAttr(
                    name="gru_b", initializer=fluid.initializer.Constant(0.0)))
            logits = L.fc(h, size=Vv, param_attr=fluid.ParamAttr(name="out_w"),
                          bias_attr=fluid.ParamAttr(name="out_b"))
            logp = L.reshape(L.log_softmax(logits), [Bb, Kk, Vv])
            sid, ssc, par = L.beam_search(pre_ids, pre_scores, None, logp,
                                          beam_size=Kk, end_id=eos)
            flat_par = L.reshape(L.elementwise_add(par, offset), [Bb * Kk, 1])
            L.array_write(sid, i, array=ids_arr)
            L.array_write(par, i, array=par_arr)
            L.assign(sid, pre_ids)
            L.assign(ssc, pre_scores)
            L.assign(L.gather(h, flat_par), state)
            L.increment(i, in_place=True)
            L.less_than(i, n, cond=cond)
        sent_ids, sent_scores = L.beam_search_decode(
            ids_arr, pre_scores, beam_size=Kk, end_id=eos, parents=par_arr)
    return main, startup, [sent_ids, sent_scores]


def test_while_gru_lm_decode_is_the_jax_packages():
    (ids, scores), (w_ids, w_scores) = both(build_gru_lm_decode, {})
    np.testing.assert_array_equal(ids, w_ids)
    np.testing.assert_allclose(scores, w_scores, rtol=1e-5, atol=1e-5)
    assert ids.shape == (2, 3, 5)
    assert (np.diff(scores, axis=1) <= 0).all()


NMT_CFG = dict(dict_size=50, embedding_dim=8, encoder_size=8,
               decoder_size=8, batch=3, src_t=7, beam=3, max_len=6, bos=0,
               eos=1)


def nmt_both(cfg, seed=0, edit=None):
    def build(fluid):
        main, startup, sent_ids, sent_scores, steps = \
            chip_smoke.build_nmt_decode(fluid, cfg)
        return main, startup, [sent_ids, sent_scores, steps]

    feed = chip_smoke.nmt_decode_feed(cfg, seed)
    want, start = run(jfluid, build, feed, edit=edit)
    got, _ = run(tfluid, build, feed, start=start)
    return got, want, start, feed


def rescored(cfg, start, feed, sent_ids, steps):
    """The teacher-forced StaticRNN's log-probs along each path, on the
    port from the decode's weights."""
    main, picked = chip_smoke.build_nmt_rescore(tfluid, cfg, steps)
    scope = tfluid.io.state_from_numpy(main, start, tfluid.Scope(),
                                       tfluid.CPUPlace())
    out, = tfluid.Executor(tfluid.CPUPlace()).run(
        main, feed=dict(feed, **chip_smoke.nmt_rescore_feed(
            cfg, sent_ids, steps)), fetch_list=[picked], scope=scope)
    return chip_smoke.path_scores(cfg, sent_ids, np.asarray(out))


def test_nmt_beam_decode_is_the_jax_packages():
    got, want, start, feed = nmt_both(NMT_CFG)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5, atol=1e-5)
    ids, scores, steps = got
    assert int(steps[0]) == NMT_CFG["max_len"]
    assert ids.shape == (3, 3, 6) and ids.min() >= 0 and ids.max() < 50
    assert (np.diff(scores, axis=1) <= 0).all()
    np.testing.assert_allclose(
        rescored(NMT_CFG, start, feed, ids, int(steps[0])), scores,
        rtol=1e-5, atol=1e-5)


def test_nmt_beam_decode_stops_when_every_beam_has_ended():
    """With the output bias of ``eos`` at +50, the first step's best beam
    ends, the next step's two live beams end on ``eos`` behind it, and the
    loop stops after 2 of its 9 steps, in both packages; the ids past the
    count are ``eos``."""
    cfg = dict(NMT_CFG, max_len=9)
    main, startup = chip_smoke.build_nmt_decode(tfluid, cfg)[:2]
    scope = tfluid.Scope()
    tfluid.Executor(tfluid.CPUPlace()).run(startup, scope=scope)
    bias = scope.as_numpy("dec_out_b").copy()
    bias.reshape(-1)[cfg["eos"]] = 50.0
    got, want, start, _ = nmt_both(cfg, edit={"dec_out_b": bias})
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5, atol=1e-5)
    assert int(got[2][0]) == int(want[2][0]) == 2
    assert (got[0][:, :, 1:] == cfg["eos"]).all()


def layer_refusal(fluid, case):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.fill_constant([B, K], "int64", 0)
        s = fluid.layers.fill_constant([B, K], "float32", 0.0)
        try:
            if case == "ids":
                fluid.layers.beam_search(x, s, x, s, beam_size=K, end_id=0)
            else:
                fluid.layers.beam_search_decode(x, s)
        except ValueError as e:
            return str(e)
    return None


@pytest.mark.parametrize("case,words", [("ids", "pass ids=None"),
                                        ("parents", "needs the parents")])
def test_layer_refusals_are_the_jax_layers(case, words):
    assert words in layer_refusal(jfluid, case)
    assert words in layer_refusal(tfluid, case)
