"""Control flow, the tensor arrays and beam search on the card.

* ``recurrent`` (the PTB LM's StaticRNN at test size, dropout 0): one
  training step on the card against the CPU from one start, the loss, the
  last states and every gradient 1e-5 norm-wise;
* the tensor-array ops and ``beam_search`` (at [4, 3, 1000] with finished
  beams and ties) on the card against the CPU, integer outputs identical;
* with dropout on, the StaticRNN LM's captured steps (``run_steps``: a
  CUDA graph) equal its eager steps bit for bit, masks included;
* the array ops, ``beam_search`` and ``beam_search_decode`` read nothing
  on the host (``torch.cuda.set_sync_debug_mode("error")``), so a
  captured step can hold them;
* writes at and past the capacity and reads past it leave the CUDA
  context usable (no device assert).

Every test carries the ``cuda`` marker and skips without a GPU. The file
imports neither ``jax`` nor ``paddle_tpu``:

    python -m pytest tests/test_torch_control_flow_cuda.py -m cuda --noconftest -q
"""

import types

import numpy as np
import pytest
import torch

import chip_smoke
import paddle_tpu_torch as fluid
from paddle_tpu_torch.core.registry import OpContext, get_op_impl
from paddle_tpu_torch.ops.beam_search_ops import EMPTY_ARRAY

pytestmark = pytest.mark.cuda

LM = dict(hidden_size=32, vocab_size=200, num_layers=2, num_steps=8,
          init_scale=0.1, dropout=0.0, batch_size=4)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", torch.cuda.current_device())


def call(op_type, attrs, env, inputs, outputs, dev):
    """The registered op over ``env`` ({name: value}); inputs and outputs
    are {slot: name}. Returns the env."""
    op = types.SimpleNamespace(
        type=op_type, attrs=dict(attrs), block=None,
        inputs={s: [n] for s, n in inputs.items()},
        outputs={s: [n] for s, n in outputs.items()})
    trace = types.SimpleNamespace(is_test=False, device=dev, program=None)
    get_op_impl(op_type)(OpContext(op, env, trace))
    return env


def array_ops(dev, x, cap=4):
    """Writes at 0, 2, the capacity, past it and at -1; reads at 1, past
    the capacity and at -2; the length and both stackings."""
    env = {"x": x.to(dev), "arr": EMPTY_ARRAY}
    out = {}
    for k, i in enumerate((0, 2, cap, cap + 5, -1)):
        env["i"] = torch.full((1,), i, dtype=torch.int64, device=dev)
        env["xk"] = env["x"] * (k + 1)
        call("write_to_array", {"capacity": cap}, env,
             {"X": "xk", "I": "i", "Array": "arr"}, {"Out": "arr"}, dev)
        call("lod_array_length", {}, env, {"Array": "arr"}, {"Out": "n"},
             dev)
        out["n%d" % k] = env["n"]
    for i in (1, cap + 3, -2):
        env["i"] = torch.full((1,), i, dtype=torch.int64, device=dev)
        call("read_from_array", {}, env, {"Array": "arr", "I": "i"},
             {"Out": "r"}, dev)
        out["r%d" % i] = env["r"]
    call("array_to_tensor", {}, env, {"Array": "arr"},
         {"Out": "t", "OutIndex": "ti"}, dev)
    call("tensor_array_to_tensor", {"axis": 1}, env, {"X": "arr"},
         {"Out": "c", "OutIndex": "ci"}, dev)
    out.update(t=env["t"], ti=env["ti"], c=env["c"], ci=env["ci"])
    return out


def beam_inputs(dev, b=4, k=3, v=1000, seed=0):
    rng = np.random.RandomState(seed)
    logp = torch.log_softmax(torch.as_tensor(rng.randn(b, k, v)
                                             .astype(np.float32)), -1)
    logp[1] = -3.0  # a row of exact ties
    pre_ids = torch.as_tensor(rng.randint(0, 5, (b, k)))
    pre_ids[0] = torch.tensor([0, 2, 0])  # finished beams (end_id 0)
    pre_scores = torch.as_tensor(rng.randn(b, k).astype(np.float32))
    pre_scores[2] = torch.tensor([0.0, -1e9, -1e9])  # the start's ties
    return {"pre_ids": pre_ids.to(dev), "pre_scores": pre_scores.to(dev),
            "logp": logp.to(dev)}


def beam_ops(dev, inputs, steps=5):
    """``beam_search`` ``steps`` times, ids and parents written to arrays,
    then ``beam_search_decode``."""
    env = dict(inputs, ids_arr=EMPTY_ARRAY, par_arr=EMPTY_ARRAY)
    outs = []
    for t in range(steps):
        env["i"] = torch.full((1,), t, dtype=torch.int64, device=dev)
        call("beam_search", {"end_id": 0}, env,
             {"PreIds": "pre_ids", "PreScores": "pre_scores",
              "Scores": "logp"},
             {"SelectedIds": "pre_ids", "SelectedScores": "pre_scores",
              "ParentIdx": "par"}, dev)
        outs.append((env["pre_ids"], env["pre_scores"], env["par"]))
        call("write_to_array", {"capacity": steps + 2}, env,
             {"X": "pre_ids", "I": "i", "Array": "ids_arr"},
             {"Out": "ids_arr"}, dev)
        call("write_to_array", {"capacity": steps + 2}, env,
             {"X": "par", "I": "i", "Array": "par_arr"},
             {"Out": "par_arr"}, dev)
    call("beam_search_decode", {"end_id": 0}, env,
         {"Ids": "ids_arr", "Parents": "par_arr", "Scores": "pre_scores"},
         {"SentenceIds": "sent", "SentenceScores": "ss"}, dev)
    return outs, env["sent"], env["ss"]


def test_array_ops_card_equal_cpu_and_context_survives(cuda):
    x = torch.randn(3, 5)
    card = array_ops(cuda, x)
    torch.cuda.synchronize()  # a device assert would surface here
    cpu = array_ops(torch.device("cpu"), x)
    for n, want in cpu.items():
        got = card[n].cpu()
        assert got.dtype == want.dtype, n
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert [int(card["n%d" % k]) for k in range(5)] == [1, 3, 4, 4, 4]
    # the context is still usable
    assert float(torch.ones(4, device=cuda).sum()) == 4.0


def test_beam_search_and_decode_card_equal_cpu(cuda):
    inputs = beam_inputs(torch.device("cpu"))
    cpu_steps, cpu_sent, cpu_ss = beam_ops(torch.device("cpu"), inputs)
    card_steps, card_sent, card_ss = beam_ops(
        cuda, {n: t.to(cuda) for n, t in inputs.items()})
    for (ci, cs, cp), (gi, gs, gp) in zip(cpu_steps, card_steps):
        torch.testing.assert_close(gi.cpu(), ci, rtol=0, atol=0)
        torch.testing.assert_close(gp.cpu(), cp, rtol=0, atol=0)
        torch.testing.assert_close(gs.cpu(), cs, rtol=1e-6, atol=1e-5)
        assert gp.dtype == torch.int32 and gi.dtype == torch.int64
    torch.testing.assert_close(card_sent.cpu(), cpu_sent, rtol=0, atol=0)


def test_array_and_beam_ops_do_not_sync(cuda):
    x = torch.randn(3, 5, device=cuda)
    inputs = beam_inputs(cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        array_ops(cuda, x)
        beam_ops(cuda, inputs)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


def lm_step(place, arrays, cfg):
    main, startup, loss, last_h, last_c = chip_smoke.build_ptb_lm(fluid,
                                                                  **cfg)
    scope = fluid.io.state_from_numpy(main, arrays, fluid.Scope(), place)
    grads = sorted(main._backward_info["param_to_grad"].values())
    out = fluid.Executor(place).run(
        main, feed=chip_smoke.ptb_feed(cfg), fetch_list=[loss, last_h,
                                                        last_c] + grads,
        scope=scope, return_numpy=False)
    return [torch.as_tensor(o).cpu() for o in out]


def lm_start(cfg):
    main, startup = chip_smoke.build_ptb_lm(fluid, **cfg)[:2]
    scope = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=scope)
    return {n: scope.as_numpy(n) for n in scope.vars}


def test_static_rnn_step_card_equal_cpu(cuda):
    arrays = lm_start(LM)
    cpu = lm_step(fluid.CPUPlace(), arrays, LM)
    card = lm_step(fluid.CUDAPlace(0), arrays, LM)
    assert len(card) == len(cpu) > 3
    for g, w in zip(card, cpu):
        assert torch.linalg.norm(g - w) <= 1e-5 * max(
            float(torch.linalg.norm(w)), 1.0)


def test_static_rnn_lm_captured_equal_eager_with_dropout(cuda):
    cfg = dict(LM, dropout=0.5)
    arrays = lm_start(cfg)

    def run(captured):
        main, startup, loss, last_h, last_c = chip_smoke.build_ptb_lm(
            fluid, **cfg)
        place = fluid.CUDAPlace(0)
        scope = fluid.io.state_from_numpy(main, arrays, fluid.Scope(),
                                          place)
        exe = fluid.Executor(place)
        feed = chip_smoke.ptb_feed(cfg)
        rows = []
        for _ in range(5):  # 2 warm-ups, the capture, 2 replays
            if captured:
                row = exe.run_steps(main, [feed], steps=1,
                                    fetch_list=[loss, last_h, last_c],
                                    scope=scope)[0]
            else:
                row = exe.run(main, feed=feed,
                              fetch_list=[loss, last_h, last_c],
                              scope=scope)
            rows.append(row)
            feed = dict(feed, init_hidden=row[1], init_cell=row[2])
        state = {n: scope.as_numpy(n) for n in arrays}
        exe.close()
        return rows, state

    eager, eager_state = run(False)
    captured, captured_state = run(True)
    for e, c in zip(eager, captured):
        for a, b in zip(e, c):
            np.testing.assert_array_equal(a, b)
    for n in arrays:
        np.testing.assert_array_equal(eager_state[n], captured_state[n])
    assert float(eager[-1][0]) < float(eager[0][0])


def test_while_decode_card_equal_cpu(cuda):
    """The NMT decoder under ``While`` at test width: the same ids and
    scores on the card as on the CPU."""
    cfg = dict(dict_size=300, embedding_dim=16, encoder_size=16,
               decoder_size=16, batch=4, src_t=9, beam=3, max_len=7, bos=0,
               eos=1)
    main, startup, sent_ids, sent_scores, steps = \
        chip_smoke.build_nmt_decode(fluid, cfg)
    init = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=init)
    arrays = {n: init.as_numpy(n) for n in init.vars}
    feed = chip_smoke.nmt_decode_feed(cfg)
    out = []
    for place in (fluid.CPUPlace(), fluid.CUDAPlace(0)):
        scope = fluid.io.state_from_numpy(main, arrays, fluid.Scope(), place)
        out.append(fluid.Executor(place).run(
            main, feed=feed, fetch_list=[sent_ids, sent_scores, steps],
            scope=scope))
    (ci, cs, cn), (gi, gs, gn) = out
    np.testing.assert_array_equal(gi, ci)
    np.testing.assert_allclose(gs, cs, rtol=1e-5, atol=1e-5)
    assert int(gn[0]) == int(cn[0])
