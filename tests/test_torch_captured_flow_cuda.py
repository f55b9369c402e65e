"""Control flow, the prefill and ``Executor.prepare`` captured, on the card.

* the NMT beam decoder under ``While`` at test width through
  ``CompiledProgram``: three graphs (the ops before the loop, its body,
  the ops after it), no step eager, ids and scores equal to
  ``Executor.run``'s bit for bit;
* the ``Switch`` schedule through ``CompiledProgram``: one graph, the
  rates 0.1, 0.01 and 0.001;
* a dropout in each branch of a ``cond`` and one inside a ``while``
  body, replayed from graphs, draw what ``Executor.run`` draws, bit for
  bit;
* after a capture that fails, an eager random draw on the card still
  works (the default generator's capture mode ended);
* ``prepare`` and then 3 steps give the bits of 3 steps, with dropout
  on, and ``memory_report`` gives the six keys;
* the serving engine's prefill and prefix-hit resume graphs give the
  eager engine's streams, greedy and sampled.

Every test carries the ``cuda`` marker and skips without a GPU. The file
imports neither ``jax`` nor ``paddle_tpu``:

    python -m pytest tests/test_torch_captured_flow_cuda.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import torch

import chip_smoke
import paddle_tpu_torch as fluid

pytestmark = pytest.mark.cuda

NMT_CFG = dict(dict_size=50, embedding_dim=8, encoder_size=8,
               decoder_size=8, batch=3, src_t=7, beam=3, max_len=6, bos=0,
               eos=1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", torch.cuda.current_device())


def test_while_decode_is_three_graphs_equal_to_run(cuda):
    main, startup, ids, scores, steps = chip_smoke.build_nmt_decode(
        fluid, NMT_CFG)
    fetch = [ids, scores, steps]
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CUDAPlace(0))
    exe.run(startup, scope=scope)
    feed = chip_smoke.nmt_decode_feed(NMT_CFG)
    want = exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
    compiled = fluid.CompiledProgram(main)
    for _ in range(4):
        got = exe.run(compiled, feed=feed, fetch_list=fetch, scope=scope)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    cap, = exe._captured.values()
    assert exe.host_op_steps == 0 and cap.graphs == 3
    assert [e[0] for e in cap.replays] == ["ops", "loop", "ops"]
    exe.close()


def test_switch_is_one_graph(cuda):
    main, startup, lr = chip_smoke.build_switch(fluid)
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CUDAPlace(0))
    exe.run(startup, scope=scope)
    compiled = fluid.CompiledProgram(main)
    rates = [float(exe.run(compiled, feed={"step": np.asarray([s],
                                                               "float32")},
                           fetch_list=[lr], scope=scope)[0][0])
             for s in (5.0, 15.0, 25.0, 12.0)]
    np.testing.assert_allclose(rates, [0.1, 0.01, 0.001, 0.01], rtol=1e-6)
    cap, = exe._captured.values()
    assert exe.host_op_steps == 0 and cap.graphs == 1
    exe.close()


def dropout_flow_program():
    """``cond(flag, dropout(x), dropout(2x))`` and three iterations of
    ``acc += dropout(x)``."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 11
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        L = fluid.layers
        x = L.data("x", shape=[8, 256], append_batch_size=False)
        flag = L.data("flag", shape=[1], dtype="bool",
                      append_batch_size=False)
        picked = L.cond(flag, lambda: L.dropout(x, 0.5),
                        lambda: L.dropout(L.scale(x, scale=2.0), 0.5))
        i = L.fill_constant([1], "int64", 0)
        n = L.fill_constant([1], "int64", 3)
        acc = L.fill_constant([8, 256], "float32", 0.0)
        cond = L.less_than(i, n)
        loop = L.While(cond)
        with loop.block():
            L.assign(L.elementwise_add(acc, L.dropout(x, 0.5)), acc)
            L.increment(i, in_place=True)
            L.less_than(i, n, cond=cond)
    return main, [picked, acc]


def test_dropout_in_captured_control_flow_draws_as_eagerly(cuda):
    main, fetch = dropout_flow_program()
    rng = np.random.RandomState(1)
    feeds = [{"x": rng.rand(8, 256).astype("float32") + 0.5,
              "flag": np.asarray([k % 2 == 0])} for k in range(5)]
    rows = {}
    for mode in ("run", "compiled"):
        exe = fluid.Executor(fluid.CUDAPlace(0))
        scope = fluid.Scope()
        main._tpu_step_counter = 0
        prog = main if mode == "run" else fluid.CompiledProgram(main)
        rows[mode] = [exe.run(prog, feed=f, fetch_list=fetch, scope=scope)
                      for f in feeds]
        if mode == "compiled":
            # the ops before the loop and its body; nothing after it
            cap, = exe._captured.values()
            assert exe.host_op_steps == 0 and cap.graphs == 2
        exe.close()
    for e, c in zip(rows["run"], rows["compiled"]):
        for a, b in zip(e, c):
            np.testing.assert_array_equal(a, b)
    assert 0.2 < float((rows["run"][0][0] == 0).mean()) < 0.8


def test_random_draws_work_after_a_failed_capture(cuda):
    """A reshape whose shape comes from a tensor reads it on the host:
    its capture fails; then the default generator draws eagerly."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data("x", shape=[6], dtype="float32")
        shape = fluid.layers.data("shape", shape=[2], dtype="int32",
                                  append_batch_size=False)
        y = fluid.layers.reshape(x, shape=[-1, 6])
        main.global_block.ops[-1].inputs["Shape"] = [shape.name]
        loss = fluid.layers.mean(y)
    feed = {"x": np.ones((4, 6), "float32"),
            "shape": np.array([2, 12], "int32")}
    exe = fluid.Executor(fluid.CUDAPlace(0))
    with pytest.raises(RuntimeError, match="reshape2"):
        exe.run_steps(main, [feed] * 3, fetch_list=[loss],
                      scope=fluid.Scope())
    exe.close()
    assert torch.randn(4, device=cuda).isfinite().all()


def dropout_program():
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 17
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        L = fluid.layers
        x = L.data("x", shape=[64])
        y = L.data("y", shape=[1], dtype="int64")
        h = L.dropout(L.fc(x, size=128, act="relu"), 0.3)
        loss = L.mean(L.softmax_with_cross_entropy(L.fc(h, size=10), y))
        fluid.optimizer.Adam(1e-3).minimize(loss)
    return main, startup, loss


def test_prepare_then_steps_equal_steps(cuda):
    main, startup, loss = dropout_program()
    init = fluid.Scope()
    fluid.Executor(fluid.CUDAPlace(0)).run(startup, scope=init)
    rng = np.random.RandomState(0)
    feeds = [{"x": rng.randn(32, 64).astype("float32"),
              "y": rng.randint(0, 10, (32, 1)).astype("int64")}
             for _ in range(3)]
    got = {}
    for prepared in (False, True):
        scope = fluid.Scope()
        for n, v in init.vars.items():
            scope.set_var(n, v.clone())
        exe = fluid.Executor(fluid.CUDAPlace(0))
        main._tpu_step_counter = 0
        if prepared:
            rep = exe.memory_report(
                main, {n: (v.shape, v.dtype) for n, v in feeds[0].items()},
                [loss], scope)
            assert set(rep) == {"argument_bytes", "output_bytes",
                                "temp_bytes", "alias_bytes",
                                "generated_code_bytes", "peak_hbm_bytes"}
            assert rep["peak_hbm_bytes"] > rep["argument_bytes"] > 0
        rows = exe.run_steps(main, feeds, steps=3, fetch_list=[loss],
                             scope=scope)
        got[prepared] = ([r[0].tobytes() for r in rows],
                         {n: scope.find_var(n).cpu() for n in init.vars})
        exe.close()
    assert got[True][0] == got[False][0]
    for n, v in got[False][1].items():
        assert torch.equal(got[True][1][n], v), n


def test_prompt_graphs_give_the_eager_streams(cuda):
    from paddle_tpu_torch import serving
    from paddle_tpu_torch.models import decoder_lm

    cfg = decoder_lm.DecoderConfig(vocab_size=512, n_layer=2, d_model=64,
                                   n_head=4, max_seq=128)
    model = decoder_lm.DecoderLM(cfg, seed=3, device=cuda)
    sys_prompt = list(range(1, 34))  # 33 tokens: 2 pages of 16 cached
    streams = {}
    for graphs in (False, True):
        eng = serving.ServingEngine(model, serving.ServingConfig(
            slots=2, page_size=16, max_seq=128, prompt_buckets=(16, 32, 64),
            prefix_cache_pages=8, cuda_graphs=graphs), device=cuda)
        eng.warmup()
        reqs = [eng.submit(sys_prompt + [40 + i] * (1 + 7 * i), 6,
                           **(dict(temperature=1.0, top_k=40, seed=7 + i)
                              if i % 2 else {}))
                for i in range(4)]
        eng.run()
        assert all(r.state == "finished" for r in reqs)
        assert eng.resumes > 0 and eng.page_accounting_ok()
        info = eng.graph_info()
        assert all(info["%s/%d/sampled" % (k, b)]["captured"] == graphs
                   for k in ("prefill", "resume") for b in (16, 32, 64))
        streams[graphs] = [r.tokens_out for r in reqs]
        eng.close()
    assert streams[True] == streams[False]
