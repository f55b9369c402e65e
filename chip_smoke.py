"""Chip smoke of the PyTorch/CUDA port (``paddle_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It builds every CUDA kernel from ``paddle_tpu_torch/csrc`` with ``nvcc``
(one process per source, all at once) and holds each kernel against its
plain PyTorch version on the card at its main path's shapes, timing each
by CUDA events (``ms``) and by CUPTI (``device_ms``) beside an empty
launch timed like them (``launch_floor_ms``). Then it drives the ported
paths through the entry points a user calls:

* serving: a GPT-2-small-width ``DecoderLM`` (seeded random weights)
  through ``ServingEngine.submit``/``run``, its decode dispatch replayed
  from a CUDA graph with K3 inside (K3 counted in a replay by CUPTI) and
  its prefill from one graph a prompt bucket, and eagerly, in turns;
  decode attention must go through K3, the streams must match the eager
  dispatches bit for bit, the gather path and the no-cache reference,
  and no page may leak; then sampled requests (threefry bits card =
  CPU), speculation, the prefix cache (its resumes captured a bucket,
  against an eager engine), drain, deadlines and a fault plan's
  retry/fail ladder;
* training: the Transformer-base program of
  ``__graft_entry__._build_transformer``, built with
  ``import paddle_tpu_torch as fluid`` and trained through
  ``Executor.run`` on one fixed batch of 64 x 256 tokens, in float32 and
  under ``fluid.amp.decorate``; every step must launch K2a and K2b once,
  the losses must be finite and fall, and at batch 2 with dropout 0 the
  card's losses must match the CPU's;
* long-context training: the causal LM of ``bench.py``'s
  ``bench_longseq_train`` (12 layers, d_model 1024, 16 heads, vocab 32000,
  batch 8 x 2048 tokens, Adam) at full width and depth, once in float32
  and once under ``fluid.amp.decorate`` (bfloat16); every step must launch
  K1a, K1b and K1c once a layer and K2a, K2b once, the losses must be
  finite and fall, and at batch 1 x 256 tokens, 2 layers, dropout 0 the
  card's losses must match the CPU's, in float32 and under AMP;
* CTR training: DeepFM as ``bench.py``'s ``bench_deepfm`` builds and feeds
  it (V = 1e6, 26 fields, embedding 10, 13 dense features, deep layers
  400-400-400, batch 1024) with ``is_sparse`` tables, once under Adam and
  once under SGD; every Adam step must launch K4a twice (one a table) and
  K2a, K2b once, every SGD step K4b twice, the losses must be finite and
  fall; at V = 5e7 the same under Adam and SGD, and the sparse step must
  allocate no [V, D] gradient; at V = 1e4, batch 64 the card's losses and
  state must match the CPU's;
* vision training: ResNet-50 as ``bench.py``'s ``bench_resnet50`` builds
  and feeds it (batch 64 x 3 x 224 x 224, 1000 classes, Momentum(0.1,
  0.9)) at full width and depth, in float32 and under AMP; every step
  must launch K2a and K2b once, the losses be finite and the first step
  descend; the card must match the CPU at test size (the stem's max pool
  on ties, ResNet-18 in float32 and under AMP, ResNet-50 at 64 x 64); the
  MNIST MLP and LeNet-5 must train to an accuracy above 0.9 through K2 at
  [64, 10];
* BERT: pretraining as ``bench.py``'s ``bench_bert`` builds and feeds it
  (BERT-base, 133,510,460 weights, batch 32 x 128, 20 masked positions,
  Adam(1e-4)) in float32 and under AMP, K2a and K2b once a step at each
  of the MLM's [640, 30522] and the NSP's [32, 2], counted by shape, the
  losses finite and falling; its encoder weights through
  ``io.save_params``/``io.load_params`` into ``bench_bert_infer``'s
  program (batch 64 x 256) run in float32 and under ``fluid.amp.enable``;
  that program through ``io.save_inference_model`` into an
  ``inference.Predictor`` on the card at batch 64 and 48 (bucketed to 64,
  the default, and exact), every run a captured step, equal to the
  ``Executor``'s float32 run; ``Executor.prepare`` and ``memory_report``
  on the AMP pretraining step (``prepare_memory``: prepared steps equal
  unprepared ones bit for bit); and at 2 layers, batch 8, dropout 0 the
  card's losses must match the CPU's, in float32 and under AMP.

The vision and word2vec zoo: ``vgg_train`` trains VGG-16 with batch norm
(``paddle_tpu/models/vgg.py``) at 64 x 3 x 224 x 224, 1000 classes, under
Adam(1e-3), float32 and AMP; ``se_resnext_train`` SE-ResNeXt-50 (32 x 4d,
squeeze-excitation gates) at the same size under Momentum(0.1, 0.9) with
L2Decay(1e-4), float32 and AMP, plus its captured AMP leg and the
grouped convolutions timed alone; both run 2 warm-up and 4 timed steps
(6 timed steps as elsewhere do not fit the smoke's time), K2a/K2b once a
step at [64, 1000] counted by shape, losses finite, VGG's falling,
SE-ResNeXt's first step descending, its weight decay's ``sum`` once a
parameter a step. ``lars_train`` runs ResNet-50 under
``LarsMomentumOptimizer`` in turns with Momentum (one ``lars_momentum`` a
parameter a step, no host sync). ``word2vec_train`` trains the book's
N-gram model (V = 2073, batch 100, SGD(0.001)) at
``PADDLE_TPU_OPT_LEVEL`` 1, where K2a/K2b run once a step at [100, 2073],
and at level 0, where they do not; card vs CPU losses within 1e-5.
``conv_family`` holds ``conv2d_transpose`` (DCGAN's generator widths),
``depthwise_conv2d_transpose``, ``conv3d``/``pool3d`` (C3D's conv2 and
pool2) and ``conv3d_transpose`` on the card, forward and gradients, to
the same op in float64 on the CPU (float32 1e-4, bf16 1e-2), with their
times. ``zoo_parity`` holds VGG-16 and SE-ResNeXt at test size to the
CPU (first loss 1e-4, AMP 2e-2).

Eight programs also run as a captured step (``Executor.run_steps``: two
eager warm-up steps, one CUDA graph capture, then replays), each at its
phase's full width, on its phase's program and state: ``bert_captured``
(float32 and AMP), ``transformer_captured`` (AMP, driven by
``bench.py``'s ``_timeit_pipeline`` calls), ``resnet_captured`` (AMP),
``ctr_captured`` (Adam and SGD), ``longctx_captured`` (AMP),
``se_resnext_captured`` (AMP), ``unfused_captured`` and
``flash_dropout_captured`` (AMP, below). Each
runs six steps (eight for the Transformer) eagerly and the same steps
captured from the same start state; the losses must agree within 1e-6
relative at every step and the state within 1e-6 norm-wise (AMP 1e-3),
the replays number the steps less the warm-ups, one replay must launch
the graph once and each hand-written kernel of the program at its count
a step (K2, K1 and K4 inside the graph, counted by name under
torch.profiler), and an eager step must sync the host nowhere (the sync
debug mode). Then eager and captured blocks of steps run in turns: step
ms, host ms, launches a step, busy share and peak memory of each.

The pass pipeline and gradient accumulation: ``unfused_train`` builds
``bench.py``'s ``bench_transformer`` program as the bench does (attention
from primitives under ``FLAGS_unfused_attention``, AMP, 64 x 256);
``flash_attention_rewrite`` must match all 12 non-causal sites, the op
types after the pipeline equal the fused-built program's but for the
segment-bias chain, K2 launch once a step eagerly and in one replay, and
at dropout 0 on a padded batch the losses and state equal the fused-built
program's (1e-6; the AMP state 1e-3), limits that reject a rewrite with a
planted fault; it is timed eager and captured in turns with the
fused-built program.
``unfused_flash`` runs the same program at 8 x 2048, where all 18 sites
a step launch K1a-c. ``flash_dropout_captured`` captures two causal
layers at full long-context width with attention dropout 0.1 on the
flash route (the seed drawn on the card) and holds the replays to the
eager steps; its forward on one batch twice must differ (new masks).
``accum_train`` runs ``CompiledProgram`` with 4 microbatches a step and
holds it to the full batch in float32 (losses 1e-5, gradients 1e-3,
state 1e-4) and, under AMP at a global batch of 256, the captured
accumulated step (one graph) to eager ones, with peak memory beside a
batch-64 step's.
The MNIST MLP in the book's form (softmax, ``cross_entropy``) must reach
K2 at level 1 only. Every phase reports the op counts of its programs at
``PADDLE_TPU_OPT_LEVEL`` 0 and 1 (``pipeline_ops``).

The training tail: ``bert_recipe_train`` trains BERT-base under AMP with
Devlin et al.'s recipes, AdamW(0.01, epsilon 1e-6) and LAMB(0.01), the
global-norm clip at 1.0 and a linear warm-up then linear decay (2 and 8
steps, cut from 10,000 and the run's length), eager and captured: the
rate equal to Fluid's closed form at every step (1e-6), the counter the
steps run, the rate-0 first step leaving every parameter as it was,
LAMB's first moving step lowering the dropout-0 loss, K2 once a step at
each BERT shape, captured = eager (1e-3); then eager and captured steps
in turns with the bench's Adam(1e-4) program, and the optimizer tail's
device ms by group (each group's ops replayed alone as a CUDA graph)
beside its byte bound. ``transformer_noam_train`` does the same for
``bench_transformer`` under ``noam_decay(512, 8000) * 2.0`` with
Adam(0.9, 0.997, 1e-9), in turns with its constant-rate Adam program.
``optimizer_parity`` holds every optimizer class, ModelAverage, the three
clips and the eight schedules on BERT at 2 layers, card against CPU
(losses 1e-5, state 1e-5 norm-wise, rates 1e-6) and captured against
eager (1e-6). ``ctr_parity`` runs DeepFM's ``is_sparse`` tables under
Adagrad, Momentum, ProximalGD and ProximalAdagrad too (their rows-only
branches), and ``ctr_train`` Adagrad at V = 1e6, whose step must stay
below one [V, D] tensor above the state.

The dense op remainder: ``dist_transformer_train`` trains
``bench_transformer`` under the noam recipe with Fluid's
``dist_transformer.py`` loss (``label_smooth(one_hot(label))``, a
soft-label cross-entropy: no K2) eager and captured, in turns with the
fused loss (K2), and at dropout 0 holds the two forms to each other (AMP
1e-3, float32 1e-5). ``dense_ops`` runs every op of the slice forward and
backward on the card against the same call on the CPU (1e-5 float32,
1e-2 bf16 norm-wise, integer and bool outputs equal), at the shapes of
the models that use them, with ``fluid.gradients`` through a double grad
and ``WeightNormParamAttr``. ``lookup_determinism`` checks that the dense
lookup's table gradient gives the same bits on every run and stream; the
recipe legs (``scheduled_leg``) hold two eager runs from one start
bit-equal and captured against eager tensor by tensor.

The input pipeline (``input_pipeline``): ``ctr_stream`` trains DeepFM at
full width (V = 1e6, batch 1024, Adam 1e-3) as ``bench.py``'s
``bench_deepfm_stream`` does, from ``write_ctr_shards`` (16 x 1024
records, 4 shards) through ``CTRMultiSlotReader``, its ``prefetch(4)`` and
a ``DevicePrefetcher(capacity=2)`` (pinned staging, a side stream) into
``run_steps`` (4 warm-up steps with the capture while the prefetcher
copies, then 12 timed at ``fetch_every=4``); every batch that reaches the
captured step must equal the shard's batch byte for byte, the losses a
list-fed ``run_steps`` of the same batches (bit for bit when two list-fed
runs agree, else within their spread), K4a 2 and K2a/K2b 1 each in one
replay and 32/16/16 in a profiled stream-fed run (CUPTI); the parse, the
H2D copies (CUDA events, ``h2d_ms``) and the captured step on a fixed
batch are timed apart, with the busy share of a stream-fed run. ``ctr_stream_resume`` stops the
reader after 5 batches, resumes a new one from its ``state_dict`` (byte
for byte the uninterrupted pass) and quarantines a planted corrupt line.
``py_reader_train`` trains the MNIST MLP from
``fluid.reader.batch(fluid.dataset.mnist.train(), 64)`` through
``fluid.layers.py_reader`` (128 steps; ``exe.run`` to ``EOFException``,
then ``run_steps(feed_iter=None)`` for two epochs), equal to feed-dict
runs bit for bit. ``async_executor`` trains DeepFM at full width through
``fluid.AsyncExecutor(thread_num=1)`` from a ``DataFeedDesc`` (equal to
``Executor.run`` on the same batches; card = CPU 1e-5 over 2 batches).
``selected_rows_ops`` holds ``merge_selected_rows`` and
``get_tensor_from_selected_rows`` on a 26,624-id gradient to the CPU.

The sequence and RNN families (``sequence_models``): the book's four
sequence models at full width, each built with
``import paddle_tpu_torch as fluid`` and run in float32 from seeded ids
and drawn lengths (no IMDB, conll05, MovieLens or WMT data):
``stacked_lstm_train`` (``test_understand_sentiment.py``'s
``stacked_lstm_net``, batch 128 x 256, Adagrad(0.002); K2a/K2b once a
step at [128, 2]), ``srl_train`` (``db_lstm`` at depth 8 with the CRF,
batch 10 x 64, SGD under ``exponential_decay``; then ``srl_decode`` on
the ``for_test`` clone), ``recommender_train`` (the two towers at
MovieLens-1M's dictionaries, ``is_sparse`` tables under SGD(0.2), batch
256: K4b once a table a step, at D = 32 and 16, and held to its plain
version at each table) and ``nmt_train``
(``seq_to_seq_net`` at 512 wide, dict 30,000, batch 32 x 50, Adam(1e-3):
K2a/K2b once a step at [1600, 30000]). Each runs eager steps and
captured steps (``run_steps``) from one start in turns, 2 warm-ups, the
capture step and 4 timed steps each, losses within 1e-6 at every step
and the state 1e-6 norm-wise, losses finite and falling, no host sync in
an eager step, with kernels a step, the host's launch calls, busy share,
capture seconds and peak memory, and its hand-written kernels counted in
one replay. ``sequence_ops``
holds every op of the slice on the card against the CPU at its models'
shapes, forward and backward (1e-5; the recurrent ops 1e-4), and
``dynamic_rnn`` through the NMT program.

Control flow, tensor arrays and beam search (``control_flow``):
``ptb_lm_train`` trains PaddleNLP's StaticRNN language model
(``lm_model(rnn_model="static")`` at its medium configuration: hidden
650, 2 layers, 35 steps, vocabulary 10,000, batch 20, dropout 0.5;
GradientClipByGlobalNorm(5.0), SGD(1.0); seeded ids) eagerly and
captured from one start in turns, the last states fed to the next step,
K2a/K2b once a step at [700, 10000]; ``nmt_beam_decode`` decodes the NMT
model by beam search under ``While`` (batch 32 x 50 source tokens, beam
3, ``max_len`` 250, dict 30,000, widths 512; random weights) eagerly
through ``Executor.run`` and captured through ``CompiledProgram`` (the
loop body one graph replayed once an iteration), captured = eager bit
for bit, each score held to its path's log-probs rescored by a
teacher-forced StaticRNN; ``control_flow_ops`` holds the slice's 11 ops
on the card against the CPU.

The op remainder (``op_remainder``): ``ocr_ctc_train`` trains the CRNN-CTC
text recogniser of PaddlePaddle/models' ``ocr_recognition``
(``crnn_ctc_model.py``: grey 1 x 48 x 384 lines, four conv groups of 16,
32, 64 and 128 filters, im2sequence to 48 frames, two GRUs of 200, 96
classes with blank 95, ``warpctc(norm_by_times)``, Momentum(1e-3, 0.9)
with L2 4e-4; batch 32, seeded images and 4-20 character labels) eagerly
and captured in turns, captured = eager, two eager runs from one start
bit-equal; ``ocr_ctc_eval`` decodes the ``for_test`` clone greedily
(``ctc_greedy_decoder``) and scores it (``edit_distance``,
``fluid.metrics.EditDistance``): ids equal to a host greedy decode of the
same logits, each distance a host Levenshtein exactly. ``srl_decode``
scores its paths with ``chunk_eval`` (IOB, 29 types) into a
``ChunkEvaluator``, counts equal to a host recount. ``word2vec_heads``
trains the book's word2vec with ``hsigmoid`` and with ``nce`` (5
negatives) in place of the softmax, K4b on the shared sparse table,
captured = eager bit for bit. ``extra_ops`` holds every op of the
slice card = CPU (1e-5, integer outputs and ``hash`` identical) and the
random draws by their law; ``host_ops_compiled`` runs the ``Switch``
schedule and the NMT ``While`` decoder through ``CompiledProgram``,
captured (no step counted eager), and a ``py_func`` + ``Print`` program,
each step of it counted in ``Executor.host_op_steps``, all equal to
``Executor.run``.

The model's lifecycle: ``checkpoint_resume`` (after ``bert_train``)
trains BERT-base under AMP at 32 x 128 with dropout 0.1 from a record
file (``recordio`` → ``reader.batch`` → ``ParallelExecutor.run``,
captured), 6 steps uninterrupted against 3, ``save_checkpoint``, a fresh
program's ``load_checkpoint`` with the step counter set, and 3 more:
losses and state bit for bit, K2 launching in every run, a reload into
the first scope replaying its graph bit for bit, and a save under
``io.save_checkpoint@2=fatal`` leaving a torn serial that the load skips;
it reports the checkpoint's bytes, save and load seconds and the fsync's
share. ``qat_resnet50`` (after ``resnet_parity``) trains ResNet-50 at
64 x 224 quantization-aware (``QuantizeTranspiler``, moving-average
activations), captured = eager bit for bit, timed against the captured
float32 step; freezes it and holds every fake-quant op of the frozen
program card = CPU on the card's own inputs bit for bit
(``card_cpu_op_trace``), reporting the logits' end-to-end difference;
stores the weights int8 on the card; and calibrates the float32
inference program (``Calibrator``, ``abs_max`` and ``KL``, 2 batches of
8), counting top-1 agreement. ``export_bert`` (after ``bert_predictor``)
exports BERT-base with ``torch.export`` and a symbolic batch, runs the
artifact at 48 and 64 against the Predictor (1e-5), and shows that an
export of the causal LM at S = 2048 raises naming K1a. ``op_harness``
(last) runs the port's ``OpTest`` on the card against the CPU for the 7
fake-quant ops and a handful of dense ops.

Detection and dygraph (``detection``, last): ``ssd_train`` trains SSD300
on VGG-16 (``ssd_pascal.py``'s net: 300 x 300, 21 classes, conv4_3 L2
normalised with a learned scale, fc6 dilated, the extra layers to 1 x 1,
8,732 priors; batch 32, Momentum 1e-3 + L2 5e-4, seeded images and 1-8
boxes an image) eagerly and captured in turns, captured = eager bit for
bit, K2 twice a step at [279,424, 21]; ``ssd_detect`` runs its
``for_test`` program with ``detection_output`` captured and holds the
detections to the CPU's on the same ``loc``/``conf``, then
``detection_map`` as a host op; ``two_stage_ops`` runs Detectron's C4
op chain (63,000 anchors, ``generate_proposals`` at pre-NMS 6,000 eager
and captured, the RPN and RoI samplers, mask targets, ``roi_align``)
card = CPU; ``yolov3_loss`` YOLOv3's three heads at 608 card = CPU and
captured; ``dygraph_resnet50`` Fluid's dygraph ResNet-50 at 32 x 224,
one SGD step = the static one, ``jit_train`` (one CUDA graph) = eager
bit for bit; ``detection_op_harness`` the 20 ops card = CPU.

Diagnostics, not run by default: ``python3 chip_smoke.py
--recipe-bisect [--deterministic] lamb adamw adam`` checksums every op's
outputs and gradients over two eager runs of BERT-base's recipe step from
one start, a side-stream run and a captured run, and names the first
that part (``recipe_bisect``).

Each phase prints one JSON line; any failed check exits non-zero. The line
before the last holds every kernel's numbers, the last line the device.

It imports neither ``jax`` nor ``paddle_tpu``, and exits non-zero without
a CUDA device.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch

H100_BYTES_PER_S = 3.35e12    # HBM3, H100 SXM data sheet
H100_F32_FLOP_PER_S = 67e12   # float32 outside the tensor cores
PCIE5_BYTES_PER_S = 64e9      # the H100 SXM's host link, PCIe 5.0 x16, one way
SPIN_CYCLES = 1_000_000       # ~0.5 ms at the H100's 1.98 GHz boost clock
PROFILE_WARMUP_S = 0.02       # step_profile's warm-up: CUPTI's buffer request took up to 9 ms

# Transformer-base as bench.py's bench_transformer trains it
TRAIN = dict(n_layer=6, d_model=512, n_head=8, d_inner=2048, seq=256,
             vocab=30000)
TRAIN_BATCH = 64

# the causal LM as bench.py's bench_longseq_train trains it
LONGCTX = dict(vocab_size=32000, n_layer=12, n_head=16, d_model=1024,
               d_inner=4096)
LONGCTX_BATCH, LONGCTX_SEQ = 8, 2048
H100_BF16_FLOP_PER_S = 989e12  # dense bf16 on the tensor cores

# DeepFM as bench.py's bench_deepfm trains it
CTR = dict(sparse_feature_dim=1_000_000, embedding_size=10, num_fields=26,
           layer_sizes=(400, 400, 400))
CTR_BATCH, CTR_DENSE = 1024, 13
CTR_BIG_V = 50_000_000  # the largest V of bench.py's sweep one card holds

# ResNet-50 as bench.py's bench_resnet50 trains it; the MNIST models at the
# batch of tests/test_mnist_mlp.py; the loss shapes K2 meets on their paths
RESNET_BATCH, RESNET_IMAGE, RESNET_CLASSES = 64, 224, 1000
MNIST_BATCH, MNIST_DIM, MNIST_CLASSES = 64, 784, 10
# the ResNet step's kernels by kind, for its profile (first match wins)
RESNET_GROUPS = {
    "conv_cudnn": r"cudnn|xmma|dgrad|wgrad|fprop|conv|implicit",
    "copy_cast": r"copy",
    "reduce": r"reduce_kernel",
    "elementwise": r"elementwise|functor",
    "gemm": r"gemm|cutlass",
    "softmax_xent": r"xent_"}
VISION_XENT = ((RESNET_BATCH, RESNET_CLASSES, torch.float32),
               (RESNET_BATCH, RESNET_CLASSES, torch.bfloat16),
               (MNIST_BATCH, MNIST_CLASSES, torch.float32))

# BERT-base pretraining as bench.py's bench_bert trains it (batch x seq
# tokens, n_mask masked positions a sequence) and inference as its
# bench_bert_infer runs it; K2's two loss shapes on that path: the MLM
# loss [batch * n_mask, vocab] and the NSP loss [batch, 2], float32 and
# under AMP bfloat16
BERT_BATCH, BERT_SEQ, BERT_MASK, BERT_VOCAB = 32, 128, 20, 30522
BERT_INFER_BATCH, BERT_INFER_SEQ = 64, 256
BERT_FEEDS = ["ids", "pos", "sent", "mask", "chain"]
# the card's name and power limit as nvidia-smi prints them (set by main),
# repeated in the lines of the zoo's legs
SMI = [None]
# the book's word2vec N-gram model (tests/book/test_word2vec.py): its
# dictionary, widths and batch; K2 meets its loss at [100, 2073]
W2V = dict(dict_size=2073, embed_size=32, hidden_size=256)
W2V_BATCH = 100
# warm-up and timed steps of the zoo's vision legs: 2 + 6 as in
# resnet_train do not fit the smoke's time, so 2 + 4
ZOO_WARM, ZOO_TIMED = 2, 4
BERT_XENT = tuple((n, v, dt) for n, v in ((BERT_BATCH * BERT_MASK, BERT_VOCAB),
                                          (BERT_BATCH, 2))
                  for dt in (torch.float32, torch.bfloat16))


def check(ok, msg):
    if not ok:
        raise RuntimeError("chip_smoke check failed: " + msg)


def emit(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def rel_err(got, want):
    """Largest |got - want| / |want| (|want| floored at 1e-6)."""
    return float(((got.float() - want).abs()
                  / want.abs().clamp_min(1e-6)).max())


def scaled_err(got, want, rtol, floor=1e-6, scale=None):
    """Largest |got - want| / (rtol·|want| + floor·scale); at most 1
    passes. ``scale`` is max |want| of each row unless given. Relative per
    element, so a term far below a row's largest value cannot hide; the
    floor covers only elements that cancel to about 0."""
    if scale is None:
        scale = want.abs().amax(dim=-1, keepdim=True)
    floor = (floor * scale).clamp_min(1e-30)
    return float(((got.float() - want).abs()
                  / (rtol * want.abs() + floor)).max())


def flash_err(got, want, rtol, floor):
    """``scaled_err`` of a [B,H,S,D] flash output whose row floor is at
    least 1e-3 of its head's largest |want|. A row that sees one position
    (causal row 0, the first row of a segment) has dp = di, so ds and dq
    are 0 in exact arithmetic and a rounding residue in any finite one, at
    3e-8 to 1e-7 of the head's scale: another summation order, even a
    float64 one, moves it by all of itself. Every other row keeps its own
    floor."""
    row = want.abs().amax(dim=-1, keepdim=True)
    head = row.amax(dim=-2, keepdim=True)
    return scaled_err(got, want, rtol, floor, torch.maximum(row, 1e-3 * head))


def l2_flusher(dev):
    """A function that evicts the 50 MB L2 by reading a 256 MB buffer. A
    read leaves the L2 holding clean lines, so the timed launch after it
    pays no write-back. (Zeroing a buffer instead leaves dirty lines whose
    write-back lands in the next launch's time: a few microseconds, nothing
    for a millisecond kernel, much of a microsecond one's.)"""
    buf = torch.ones(64 * 2 ** 20, dtype=torch.float32, device=dev)
    return buf.sum


def cuda_ms(fn, reps=30, flush=None):
    """Median device time of ``fn()`` in ms over ``reps`` launches, each
    timed by CUDA events, with ``flush()`` (an L2 eviction) run before each
    launch outside the timed span. A spin of ~0.5 ms on the card follows the
    flush, so the host has enqueued the timed launch before the card
    reaches it: the span holds the launch, not the host's Python around it
    (which a microsecond kernel would otherwise measure)."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush()
        torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def device_ms(fn, kernel, reps=30, flush=None, sessions=6):
    """Median device duration in ms of the kernel whose name matches the
    regular expression ``kernel`` (case ignored) over ``reps`` calls of
    ``fn()``, each after ``flush()`` and the spin as in ``cuda_ms``: the
    CUPTI activity records of torch.profiler, so the kernel's own time on
    the card, with neither launch latency nor event cost. Each call must
    launch that kernel once. The profiler sometimes drops records of a
    microsecond kernel, and a session that lost some read up to 20 % low,
    so only a session with all ``reps`` records counts: one that lost any
    is run again, up to ``sessions`` in all, and if none is whole the
    result is None (null in the JSON lines), with the shortfall on
    stderr."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    pat = re.compile(kernel, re.I)
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    counts = []
    for _ in range(sessions):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                if flush is not None:
                    flush()
                torch.cuda._sleep(SPIN_CYCLES)
                fn()
            torch.cuda.synchronize()
        durs = [e.time_range.elapsed_us() for e in prof.events()
                if e.device_type == DeviceType.CUDA and pat.search(e.name)]
        check(len(durs) <= reps, "device_ms: %d kernels named like %r in %d "
              "calls" % (len(durs), kernel, reps))
        if len(durs) == reps:
            return float(np.median(durs)) / 1e3
        counts.append(len(durs))
    print("device_ms: no whole session of %r: %s records of %d in %d "
          "sessions" % (kernel, counts, reps, sessions), file=sys.stderr,
          flush=True)
    return None


def launch_floor_ms(flush):
    """``cuda_ms`` of the smallest launch (``torch.cuda._sleep(0)``, one
    thread that returns at once), timed exactly as the kernels are: what
    launch latency and the two events cost a kernel that does nothing."""
    return cuda_ms(lambda: torch.cuda._sleep(0), flush=flush)


# chunk sizes of K3 held against the plain version and timed (the source's
# is paged_attention.CHUNK_ROWS)
CHUNK_SIZES = (32, 64, 128, 256)
K3_DESIGN = "context split in chunks, one block a (chunk, head, slot), " \
    "16-byte loads, partials merged in chunk order in the same launch"


def kernel_phase(dev):
    """K3 against its plain version at the serving shapes: B=16 slots,
    H=12, D=64, page_size 16, 64 pages a slot, pages scrambled over the
    pool, ragged ctx_len from 1 to 1024; two launches on the same inputs
    bit-equal; a tail case (one slot at ctx 1024, fifteen at 1); then the
    times beside bound, plain version and library call, and the kernel at
    other chunk sizes."""
    from paddle_tpu_torch.ops.kernels import paged_attention as pa

    rng = np.random.RandomState(0)
    b, h, d, ps, pps = 16, 12, 64, 16, 64
    num_pages = b * pps
    sm = 1.0 / d ** 0.5
    perm = rng.permutation(num_pages)
    pt_np = np.stack([perm[i::b] for i in range(b)]).astype(np.int32)
    ctx_np = np.concatenate([[1, 7, 16, 33, 500, 1024],
                             rng.randint(1, pps * ps + 1, b - 6)]
                            ).astype(np.int32)
    pt = torch.as_tensor(pt_np, device=dev)
    ctx = torch.as_tensor(ctx_np, device=dev)
    live = np.zeros(num_pages * ps, bool)
    for s in range(b):
        rows = (pt_np[s].repeat(ps) * ps + np.tile(np.arange(ps), pps))
        live[rows[:ctx_np[s]]] = True
    live_t = torch.as_tensor(live, device=dev)

    def randn(*shape):
        return torch.as_tensor(rng.randn(*shape).astype(np.float32),
                               device=dev)

    q32 = randn(b, h, d)
    k32 = randn(num_pages * ps, h, d)
    v32 = randn(num_pages * ps, h, d)
    k_bad, v_bad = k32.clone(), v32.clone()
    k_bad[~live_t] = 1e4 * randn(int((~live).sum()), h, d)
    v_bad[~live_t] = -1e4

    def kern(q, k, v, ctx_=ctx):
        return pa.paged_decode_attention(q, k, v, pt, ctx_, page_size=ps,
                                         sm_scale=sm)

    errs = {}
    for dt, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        q, k, v = (t.to(dt) for t in (q32, k32, v32))
        got = kern(q, k, v)
        torch.cuda.synchronize()
        want = pa.gather_reference(q.float(), k.float(), v.float(), pt, ctx,
                                   ps, sm_scale=sm)
        err = float((got.float() - want).abs().max())
        check(torch.allclose(got.float(), want, atol=tol, rtol=tol),
              "kernel vs plain (%s) max_abs_err %g > %g" % (dt, err, tol))
        poisoned = kern(q, k_bad.to(dt), v_bad.to(dt))
        check(torch.equal(poisoned, got),
              "garbage beyond ctx_len moved the kernel output (%s)" % dt)
        check(torch.equal(kern(q, k, v), got),
              "two launches on the same inputs differ (%s)" % dt)
        errs[str(dt).replace("torch.", "")] = err
    # the tail: one slot walks 1024 rows, the other fifteen one each
    tail_np = np.asarray([pps * ps] + [1] * (b - 1), np.int32)
    tail = torch.as_tensor(tail_np, device=dev)
    tail_errs = {}
    for dt, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        q, k, v = (t.to(dt) for t in (q32, k32, v32))
        got = kern(q, k, v, tail)
        torch.cuda.synchronize()
        want = pa.gather_reference(q.float(), k.float(), v.float(), pt, tail,
                                   ps, sm_scale=sm)
        err = float((got.float() - want).abs().max())
        check(torch.allclose(got.float(), want, atol=tol, rtol=tol),
              "tail case (%s) max_abs_err %g > %g" % (dt, err, tol))
        tail_errs[str(dt).replace("torch.", "")] = err
    # every chunk size timed below is held against the plain version too
    want32 = pa.gather_reference(q32, k32, v32, pt, ctx, ps, sm_scale=sm)
    for rows_ in CHUNK_SIZES:
        got = pa._launch(q32, k32, v32, pt, ctx, ps, sm, rows_)
        torch.cuda.synchronize()
        check(torch.allclose(got, want32, atol=1e-5, rtol=1e-5),
              "chunks of %d rows: max_abs_err %g" % (
                  rows_, float((got - want32).abs().max())))

    flush = l2_flusher(dev)
    rows = (pt.long() * ps)[:, :, None] + torch.arange(ps, device=dev)
    rows = rows.reshape(b, -1)
    kg, vg = k32[rows].transpose(1, 2), v32[rows].transpose(1, 2)
    mask = (torch.arange(pps * ps, device=dev)[None, :]
            < ctx[:, None])[:, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    ms = cuda_ms(lambda: kern(q32, k32, v32), flush=flush)
    dev_ms = device_ms(lambda: kern(q32, k32, v32), r"paged_attn_kernel",
                       flush=flush)
    tail_dev_ms = device_ms(lambda: kern(q32, k32, v32, tail),
                            r"paged_attn_kernel", flush=flush)
    # after a flush that writes (zeroing 256 MB), for comparison
    dirty = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)
    ms_dirty = cuda_ms(lambda: kern(q32, k32, v32), flush=dirty.zero_)
    del dirty
    plain_ms = cuda_ms(lambda: pa.gather_reference(q32, k32, v32, pt, ctx,
                                                   ps, sm_scale=sm),
                       flush=flush)
    library_ms = cuda_ms(lambda: sdpa(q32[:, :, None], kg, vg,
                                      attn_mask=mask, scale=sm),
                         flush=flush)
    chunk_ms = {rows_: cuda_ms(lambda: pa._launch(q32, k32, v32, pt, ctx, ps,
                                                  sm, rows_), flush=flush)
                for rows_ in CHUNK_SIZES}
    tail_chunk_ms = {rows_: cuda_ms(lambda: pa._launch(
        q32, k32, v32, pt, tail, ps, sm, rows_), flush=flush)
        for rows_ in CHUNK_SIZES}
    tail_plain_ms = cuda_ms(lambda: pa.gather_reference(
        q32, k32, v32, pt, tail, ps, sm_scale=sm), flush=flush)

    # least work: each live K/V row read once, q read once, out written once,
    # the page-table entries of live pages and ctx_len read once
    def bound(ctx_np_):
        live_rows = int(ctx_np_.sum())
        live_pages = int((-(-ctx_np_ // ps)).sum())
        nbytes = 4 * (2 * live_rows * h * d + 2 * b * h * d) \
            + 4 * (live_pages + b)
        t_bytes = nbytes / H100_BYTES_PER_S * 1e3
        t_ops = 4 * live_rows * h * d / H100_F32_FLOP_PER_S * 1e3
        return nbytes, max(t_bytes, t_ops), \
            "bytes" if t_bytes >= t_ops else "operations"

    nbytes, bound_ms, bound_by = bound(ctx_np)
    tail_bound_ms = bound(tail_np)[1]
    row = {"name": "paged_decode_attention", "route": "cuda",
           "source": "paddle_tpu_torch/csrc/paged_attention.cu",
           "replaces": "paddle_tpu/ops/pallas_kernels/paged_attention.py:198",
           "launches": None, "max_abs_err": errs["float32"], "ms": ms,
           "device_ms": dev_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
           "bound_by": bound_by, "library_ms": library_ms,
           "ms_after_write_flush": ms_dirty,
           "design": K3_DESIGN, "chunk_rows": pa.CHUNK_ROWS,
           "ms_by_chunk_rows": chunk_ms,
           "tail": {"ctx_len": "1024 and fifteen of 1",
                    "ms": tail_chunk_ms[pa.CHUNK_ROWS],
                    "device_ms": tail_dev_ms, "plain_ms": tail_plain_ms, "bound_ms": tail_bound_ms,
                    "max_abs_err": tail_errs,
                    "ms_by_chunk_rows": tail_chunk_ms}}
    emit("kernel_vs_plain", kernel="paged_decode_attention",
         shape={"B": b, "H": h, "D": d, "page_size": ps,
                "pages_per_slot": pps, "ctx_len": ctx_np.tolist()},
         max_abs_err=errs, tol={"float32": 1e-5, "bfloat16": 2e-2},
         poisoned_bit_identical=True, two_launches_bit_equal=True, ms=ms,
         device_ms=dev_ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
         live_bytes=nbytes, ms_after_write_flush=ms_dirty,
         chunk_rows=pa.CHUNK_ROWS, ms_by_chunk_rows=chunk_ms,
         tail=row["tail"])
    del flush
    return row


def make_stream(vocab):
    """24 greedy requests: prompts of 16..900 tokens, 16..64 new tokens."""
    rng = np.random.RandomState(0)
    out = []
    for _ in range(24):
        n = int(rng.randint(16, 901))
        m = int(rng.randint(16, 65))
        out.append((rng.randint(0, vocab, n).tolist(), min(m, 1024 - n)))
    return out


def serve(model, stream, collect_logits=False, graphs=False, fuse=1, kw=None,
          warm=True, hook=None, **cfg):
    """Serve ``stream`` on a fresh engine (``graphs``: the prefill, resume,
    decode and verify dispatches replayed from CUDA graphs; ``kw(i)``:
    request i's extra submit arguments; ``hook(engine)`` before anything
    runs), after ``warmup()`` unless ``warm`` is False; returns (engine,
    requests, seconds of ``run()``)."""
    from paddle_tpu_torch import serving

    eng = serving.ServingEngine(model, serving.ServingConfig(
        slots=16, page_size=16, max_seq=1024, decode_fuse=fuse,
        collect_logits=collect_logits, cuda_graphs=graphs, **cfg))
    if hook is not None:
        hook(eng)
    if warm:
        eng.warmup()
    reqs = [eng.submit(p, m, **(kw(i) if kw else {}))
            for i, (p, m) in enumerate(stream)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.run()
    torch.cuda.synchronize()
    return eng, reqs, time.perf_counter() - t0


def serve_metrics(eng, reqs, secs):
    """The serve's end-to-end numbers; ``prompt_ms``: the median ms of a
    prefill (and of a resume) by prompt bucket, its token's read included,
    and ``prompt_pool_bytes``: the prompt graphs' memory pool."""
    ttft = sorted(r.ttft_s * 1e3 for r in reqs)
    n = max(1, eng.dispatches)
    return {"tokens": sum(len(r.tokens_out) for r in reqs),
            "seconds": secs,
            "tokens_per_s": sum(len(r.tokens_out) for r in reqs) / secs,
            "ttft_p50_ms": float(np.percentile(ttft, 50)),
            "ttft_p99_ms": float(np.percentile(ttft, 99)),
            "prompt_ms": {"%s/%d" % k: [len(v), float(np.median(v))]
                          for k, v in sorted(eng.prompt_ms.items())},
            "prompt_pool_bytes": eng.stats()["prompt_pool_bytes"],
            "decode_dispatch_ms_mean": eng.dispatch_s / n * 1e3,
            "decode_dispatch_host_ms_mean": eng.dispatch_host_s / n * 1e3,
            "decode_dispatches": eng.dispatches,
            "decode_steps": eng.decode_steps, "prefills": eng.prefills,
            "resumes": eng.resumes}


def first_divergence(a, b):
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return i
    return None if len(a) == len(b) else min(len(a), len(b))


def near_tie(logits_row, tol=1e-4):
    top2 = np.sort(np.asarray(logits_row, np.float64))[-2:]
    return float(top2[1] - top2[0]) <= tol


def perturbed_scores(row, req, t):
    """The scores the sampler takes the argmax of for token ``t`` of the
    sampled request ``req`` (its logits ``row``): the logits over the
    temperature, top-k masked, plus the Gumbel draw keyed (seed, position
    of the consumed token), computed on the CPU."""
    from paddle_tpu_torch.core import threefry
    from paddle_tpu_torch.ops.attention_ops import neg_inf_value

    x = torch.as_tensor(np.asarray(row, np.float32))[None]
    scaled = x / max(req.temperature, 1e-6)
    v = x.shape[-1]
    k = min(max(req.top_k if req.top_k > 0 else v, 1), v)
    kth = torch.sort(scaled, descending=True).values[:, k - 1:k]
    masked = torch.where(scaled >= kth, scaled, neg_inf_value(torch.float32))
    key = threefry.fold_in(threefry.prng_key(req.seed),
                           req.prompt_len - 1 + t)
    return (masked + threefry.gumbel(key, v))[0].numpy()


def tie_divergences(got, want, logits_of, what):
    """Requests of ``got`` whose stream parts from ``want``'s; each must
    part at a near tie: the top two logits (greedy) or perturbed scores
    (sampled) of ``want``'s engine within 1e-4 (``logits_of(i)``: request
    i's collected rows there). Returns [(request, token)]."""
    ties = []
    for i, (a, g) in enumerate(zip(got, want)):
        pos = first_divergence(a.tokens_out, g.tokens_out)
        if pos is None:
            continue
        row = logits_of(i)[pos]
        scores = (perturbed_scores(row, g, pos) if g.temperature > 0
                  else row)
        check(np.isfinite(row).all() and near_tie(scores),
              "%s: request %d diverges at token %d without a top-2 tie"
              % (what, i, pos))
        ties.append((i, pos))
    return ties


def sampled_kw(i):
    """The sampled mix of the stream: every third request greedy (8 of
    24), the rest at temperature 1.0 and top-k 40 (the GPT-2 paper's
    samples), seed 1000 + i."""
    if i % 3 == 0:
        return {}
    return {"temperature": 1.0, "top_k": 40, "seed": 1000 + i}


def serve_phase(kernel_row):
    from paddle_tpu_torch.flags import set_flag
    from paddle_tpu_torch.models import decoder_lm
    from paddle_tpu_torch.monitor import metrics
    from paddle_tpu_torch.ops.kernels import paged_attention as pa
    from paddle_tpu_torch.serving import FINISHED

    metrics.enable()
    # GPT-2 small (openai-community/gpt2 config.json), seeded random weights
    cfg = decoder_lm.DecoderConfig(vocab_size=50257, n_layer=12, d_model=768,
                                   n_head=12, max_seq=1024)
    t0 = time.perf_counter()
    model = decoder_lm.DecoderLM(cfg, seed=0)
    stream = make_stream(cfg.vocab_size)
    serve(model, stream[:2], warm=False)  # the process's first use
    emit("model", config=repr(cfg),
         params=sum(p.numel() for p in model.parameters()),
         setup_s=time.perf_counter() - t0)

    set_flag("paged_attention_kernel", "auto")
    # the main path: the engine as a user gets it, its decode dispatch a
    # CUDA graph with K3 inside; K3's wrapper counts the launches it makes
    # on the host (the warm-ups' and the captures'), CUPTI the replays'
    pa.LAUNCHES = 0
    eng_c, reqs_c, secs_c = serve(model, stream, graphs=True)
    launches = pa.LAUNCHES
    check(launches > 0, "the captured serve launched no K3")
    check(all(r.state == FINISHED for r in reqs_c),
          "not every request finished (captured)")
    check(eng_c.page_accounting_ok(), "page accounting broken (captured)")
    check(eng_c.decode_kernel_info() == ("paged", "cuda"),
          "decode kernel not armed: %r" % (eng_c.decode_kernel_info(),))
    torch.cuda.synchronize()
    check(pa.counters_at_zero(), "K3 arrival counters not at 0 after the "
          "replays")
    per_replay, replay_k = replay_counts(eng_c, cfg.n_layer)
    kernel_row["launches"] = launches
    kernel_row["launches_per_replay"] = per_replay
    kernel_row["replays"] = sum(d["replays"]
                                for d in eng_c.graph_info().values())

    # the eager yardstick: every K3 launch counted on the host
    pa.LAUNCHES = 0
    eng, reqs, secs = serve(model, stream)
    eager_launches = pa.LAUNCHES
    check(all(r.state == FINISHED for r in reqs),
          "not every request finished")
    check(eng.page_accounting_ok(), "page accounting broken")
    check(eager_launches == cfg.n_layer * eng.decode_steps,
          "eager kernel launches %d != n_layer %d x decode steps %d"
          % (eager_launches, cfg.n_layer, eng.decode_steps))
    check([r.tokens_out for r in reqs_c] == [r.tokens_out for r in reqs],
          "captured and eager streams differ")
    emit("serve_kernel", launches=eager_launches,
         **serve_metrics(eng, reqs, secs), stats=eng.stats())

    # the gather path, timed with the same config as the kernel serve; its
    # logits for the tie rule come from a second, untimed gather serve
    set_flag("paged_attention_kernel", "off")
    n0 = pa.LAUNCHES
    eng_g, reqs_g, secs_g = serve(model, stream)
    gather = serve_metrics(eng_g, reqs_g, secs_g)
    eng_l, reqs_l, _ = serve(model, stream, collect_logits=True)
    set_flag("paged_attention_kernel", "auto")
    check(pa.LAUNCHES == n0, "the gather run launched the kernel")
    check(eng_g.page_accounting_ok(), "page accounting broken (gather)")
    check([g.tokens_out for g in reqs_g] == [g.tokens_out for g in reqs_l],
          "collecting logits changed the gather streams")
    ties = tie_divergences(reqs, reqs_l,
                           lambda i: eng_l.captured_logits(reqs_l[i]),
                           "kernel vs gather")
    emit("serve_gather", **gather,
         diverged_at_ties=[{"request": i, "token": t} for i, t in ties])
    del eng_l, reqs_l

    # the engine's greedy stream against the O(S^2) no-cache reference, on
    # the two shortest requests
    short = sorted(range(len(stream)), key=lambda i: len(stream[i][0]))[:2]
    for i in short:
        prompt, m = stream[i]
        toks, logits = decoder_lm.reference_decode(model.params, cfg,
                                                   prompt, m)
        check(all(np.isfinite(x).all() for x in logits),
              "reference logits not finite")
        pos = first_divergence(reqs[i].tokens_out, toks)
        if pos is not None:
            check(near_tie(logits[pos]),
                  "request %d: engine and no-cache reference diverge at "
                  "token %d without a top-2 tie" % (i, pos))
    emit("reference", requests=short, agree=True)
    secs = {"main_eager_gather_reference": time.perf_counter() - t0}

    def leg(fn, *args, **kw):
        t = time.perf_counter()
        fn(*args, **kw)
        name = fn.__name__ + ("_captured" if kw.get("graphs") else "")
        secs[name] = time.perf_counter() - t

    leg(serve_captured_phase, model, cfg, stream, reqs_c, eng_c, secs_c,
        replay_k, launches)
    del eng_c, eng
    leg(profile_phase, model, stream, graphs=False)
    leg(profile_phase, model, stream, graphs=True)
    leg(serve_sampled_phase, model, stream, reqs_c)
    leg(serve_speculative_phase, model, stream)
    leg(serve_prefix_phase, model, cfg)
    leg(serve_lifecycle_phase, model, stream)
    emit("serve_leg_seconds", **secs)


def replay_counts(eng, n_layer, fuse=1):
    """K3 launches inside one replay of ``eng``'s greedy decode graph at
    ``fuse`` (idle engine: every slot inactive, so the replay changes no
    state), counted by CUPTI; returns (K3 a replay, replay_profile's
    result)."""
    d = eng._dispatches[("decode", fuse, False)]
    prof, counts, tries = replay_profile(
        d.graph.replay, {"K3": (r"paged_attn", n_layer * fuse)})
    check(counts["K3"] == n_layer * fuse,
          "K3 ran %d times in one replay at fuse %d, want n_layer x fuse = "
          "%d (tries %s)" % (counts["K3"], fuse, n_layer * fuse, tries))
    return counts["K3"], (prof, tries)


SERVE_TURNS = 2  # eager and captured serves a fuse width, in turns


def serve_captured_phase(model, cfg, stream, reqs_c, eng_c, secs_c,
                         replay_k, launches):
    """The 24-request stream eager and captured in turns (``SERVE_TURNS``
    each) at decode_fuse 1 and 4, each after ``warmup()`` (which captures
    every prompt bucket's prefill graph on the captured engines); captured
    streams bit-identical to eager, collected logits within 1e-6; K3
    n_layer x fuse times in one replay (CUPTI); TTFT p50 and p99,
    tokens/s, prefill ms by bucket, host ms and kernels a dispatch,
    capture seconds, graphs and their pools (the prompt graphs' one pool
    apart)."""
    from paddle_tpu_torch.serving import FINISHED

    want = [r.tokens_out for r in reqs_c]
    legs = {}
    for fuse in (1, 4):
        runs = {"eager": [], "captured": []}
        for turn in range(SERVE_TURNS):
            for mode in ("eager", "captured"):
                eng, reqs, secs = serve(model, stream, fuse=fuse,
                                        graphs=mode == "captured")
                check(all(r.state == FINISHED for r in reqs)
                      and eng.page_accounting_ok(),
                      "%s fuse %d: unfinished requests or page accounting"
                      % (mode, fuse))
                check([r.tokens_out for r in reqs] == want,
                      "%s fuse %d stream differs from the captured fuse 1 "
                      "stream" % (mode, fuse))
                m = serve_metrics(eng, reqs, secs)
                if mode == "captured":
                    info = eng.graph_info()
                    m["graphs"] = sum(d["captured"] for d in info.values())
                    m["capture_s"] = sum(d["capture_s"]
                                         for d in info.values())
                    m["graph_pool_bytes"] = sum(d["pool_bytes"]
                                                for d in info.values())
                    if turn == 0:
                        k3, (prof, tries) = replay_counts(eng, cfg.n_layer,
                                                          fuse)
                        m.update(k3_per_replay=k3,
                                 kernels_per_dispatch=sum(prof[2].values()),
                                 replay_device_ms=prof[1],
                                 replay_wall_ms=prof[0],
                                 replay_profiles=tries)
                runs[mode].append(m)
                eng.close()
        legs[fuse] = runs

    def mean(rows, key):
        return float(np.mean([r[key] for r in rows]))

    # captured logits against eager ones, fuse 1 (collected on the host)
    eng_e, reqs_e, _ = serve(model, stream, collect_logits=True)
    eng_l, reqs_l, _ = serve(model, stream, collect_logits=True, graphs=True)
    check([r.tokens_out for r in reqs_l] == want,
          "collecting logits changed the captured stream")
    err = max(float(np.abs(np.stack(eng_l.captured_logits(a))
                           - np.stack(eng_e.captured_logits(b))).max())
              for a, b in zip(reqs_l, reqs_e))
    check(err <= 1e-6, "captured logits %g from eager ones (1e-6)" % err)
    del eng_e, eng_l
    summary = {}
    for fuse, runs in legs.items():
        for mode, rows in runs.items():
            row = summary["fuse%d_%s" % (fuse, mode)] = {
                k: mean(rows, k) for k in (
                    "tokens_per_s", "ttft_p50_ms", "ttft_p99_ms",
                    "decode_dispatch_ms_mean",
                    "decode_dispatch_host_ms_mean", "prompt_pool_bytes")}
            row["prefill_ms_by_bucket"] = {
                b: float(np.mean([r["prompt_ms"][b][1] for r in rows]))
                for b in rows[0]["prompt_ms"]}
    emit("serve_captured", nvidia_smi=SMI[0], turns=SERVE_TURNS,
         main_path={"k3_host_launches": launches,
                    "k3_per_replay": replay_k[0], "seconds": secs_c,
                    "graphs": eng_c.graph_info()},
         logits_max_abs_vs_eager=err, summary=summary,
         runs={str(f): r for f, r in legs.items()})


def profile_phase(model, stream, graphs=False):
    """Where the serve time goes: the kernel-path serve once more under
    torch.profiler (eager, or with the dispatches replayed from graphs),
    recording the card's activity (CUPTI's kernels, copies and runtime
    calls, not the torch ops) and summing the profiler's raw events
    (``kineto_results``); device busy share = the CUDA events' time summed
    / wall time of the run (the profiler's own host cost is in the wall
    time), and the largest kernels by device time. (Recording the torch
    ops too and averaging them with ``key_averages()`` took the two runs
    77 s together on an H100 80GB HBM3 at 700 W.)"""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch import serving

    eng = serving.ServingEngine(model, serving.ServingConfig(
        slots=16, page_size=16, max_seq=1024, cuda_graphs=graphs))
    eng.warmup()
    reqs = [eng.submit(p, m) for p, m in stream]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.run()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    check(all(r.tokens_out for r in reqs), "profiled serve emitted nothing")
    kern = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            item = kern.setdefault(e.name(), [0, 0])
            item[0] += 1
            item[1] += e.duration_ns()
    busy_ms = sum(ns for _, ns in kern.values()) / 1e6
    top = sorted(kern.items(), key=lambda kv: -kv[1][1])[:8]
    emit("serve_profile_captured" if graphs else "serve_profile",
         wall_ms=secs * 1e3, device_busy_ms=busy_ms,
         device_busy_share=busy_ms / (secs * 1e3) if busy_ms else None,
         kernels_launched=sum(c for c, _ in kern.values()),
         decode_dispatches=eng.dispatches,
         top=[{"name": name[:80], "count": c, "device_ms": ns / 1e6}
              for name, (c, ns) in top])
    eng.close()


def serve_sampled_phase(model, stream, reqs_greedy):
    """The stream's sampled mix (``sampled_kw``): threefry's bits on the
    card equal the CPU's for a [16, 50257] draw; the greedy requests equal
    the greedy-only run; the sampled streams are the same at fuse 1 and 4
    and captured = eager; kernel and gather streams part only at near ties
    of the perturbed scores; the sampler's device ms a step from one
    profiled replay of the sampled and the greedy graph."""
    from paddle_tpu_torch.core import threefry
    from paddle_tpu_torch.flags import set_flag
    from paddle_tpu_torch.serving import FINISHED

    seeds = torch.arange(1000, 1016, dtype=torch.int32)
    pos = torch.arange(16, dtype=torch.int32) * 61
    want_bits = threefry.random_bits(
        threefry.fold_in(threefry.prng_key(seeds), pos), 50257)
    got_bits = threefry.random_bits(threefry.fold_in(
        threefry.prng_key(seeds.cuda()), pos.cuda()), 50257)
    check(torch.equal(got_bits.cpu(), want_bits),
          "threefry bits on the card differ from the CPU's")
    g_err = float((threefry.gumbel(threefry.fold_in(threefry.prng_key(
        seeds.cuda()), pos.cuda()), 50257).cpu() - threefry.gumbel(
        threefry.fold_in(threefry.prng_key(seeds), pos), 50257)).abs().max())

    eng_c, reqs_c, secs_c = serve(model, stream, graphs=True, kw=sampled_kw,
                                  collect_logits=True)
    check(all(r.state == FINISHED for r in reqs_c)
          and eng_c.page_accounting_ok(), "sampled serve broken")
    toks = [r.tokens_out for r in reqs_c]
    greedy_idx = [i for i in range(len(stream)) if not sampled_kw(i)]
    check(all(toks[i] == reqs_greedy[i].tokens_out for i in greedy_idx),
          "greedy requests moved when sampled ones shared their batch")
    check(any(toks[i] != reqs_greedy[i].tokens_out
              for i in range(len(stream)) if sampled_kw(i)),
          "no sampled request left the greedy stream")
    runs = {}
    for name, fuse, graphs in (("fuse1_eager", 1, False),
                               ("fuse1_captured", 1, True),
                               ("fuse4_captured", 4, True)):
        eng, reqs, secs = serve(model, stream, graphs=graphs, fuse=fuse,
                                kw=sampled_kw)
        check([r.tokens_out for r in reqs] == toks,
              "sampled %s stream differs from the captured fuse 1 one"
              % name)
        runs[name] = serve_metrics(eng, reqs, secs)
        if name == "fuse1_captured":
            # the sampler a step: the sampled graph's replay less the
            # greedy graph's, one profiled replay each, taken again while
            # CUPTI lost records (K3 short of n_layer)
            k3 = {"K3": (r"paged_attn", model.cfg.n_layer)}
            prof_s, got_s, tries_s = replay_profile(
                eng._dispatches[("decode", 1, True)].graph.replay, k3)
            prof_g, got_g, tries_g = replay_profile(
                eng._dispatches[("decode", 1, False)].graph.replay, k3)
            check(got_s == got_g == {"K3": model.cfg.n_layer},
                  "sampled / greedy replay: K3 %s / %s, want %d (tries %s, "
                  "%s)" % (got_s, got_g, model.cfg.n_layer, tries_s,
                           tries_g))
            runs[name].update(
                sampled_replay_device_ms=prof_s[1],
                greedy_replay_device_ms=prof_g[1],
                sampler_device_ms_per_step=prof_s[1] - prof_g[1],
                sampled_kernels_per_dispatch=sum(prof_s[2].values()),
                greedy_kernels_per_dispatch=sum(prof_g[2].values()))
        eng.close()
    set_flag("paged_attention_kernel", "off")
    eng_g, reqs_g, _ = serve(model, stream, kw=sampled_kw,
                             collect_logits=True)
    set_flag("paged_attention_kernel", "auto")
    ties = tie_divergences(reqs_c, reqs_g,
                           lambda i: eng_g.captured_logits(reqs_g[i]),
                           "sampled kernel vs gather")
    emit("serve_sampled", nvidia_smi=SMI[0], requests=len(stream),
         greedy_requests=len(greedy_idx), temperature=1.0, top_k=40,
         threefry_bits_equal=True, gumbel_card_vs_cpu_max_abs=g_err,
         runs=runs,
         diverged_at_ties=[{"request": i, "token": t} for i, t in ties])
    SAMPLED_REF[0] = (reqs_c, eng_c)


SAMPLED_REF = [None]  # the sampled mix's captured requests and engine


def serve_speculative_phase(model, stream):
    """speculation=4, greedy and the sampled mix, captured: streams equal
    plain decode (parting only at near ties of plain decode's own scores,
    reported), the accept rate, dispatches against plain, tokens/s."""
    from paddle_tpu_torch.serving import FINISHED
    from paddle_tpu_torch.serving import metrics as sm

    reqs_s, eng_s = SAMPLED_REF[0]
    eng_p, reqs_p, _ = serve(model, stream, graphs=True, collect_logits=True)
    out = {}
    for name, kw, ref_reqs, ref_eng in (
            ("greedy", None, reqs_p, eng_p),
            ("sampled", sampled_kw, reqs_s, eng_s)):
        eng_r, reqs_r, secs_r = serve(model, stream, graphs=True, kw=kw)
        p0, a0 = sm.SPEC_PROPOSED.value, sm.SPEC_ACCEPTED.value
        eng, reqs, secs = serve(model, stream, graphs=True, kw=kw,
                                speculation=4)
        proposed = sm.SPEC_PROPOSED.value - p0
        accepted = sm.SPEC_ACCEPTED.value - a0
        check(all(r.state == FINISHED for r in reqs)
              and eng.page_accounting_ok(), "speculative serve broken")
        check([r.tokens_out for r in reqs_r]
              == [r.tokens_out for r in ref_reqs],
              "plain %s stream moved between runs" % name)
        ties = tie_divergences(
            reqs, ref_reqs, lambda i: ref_eng.captured_logits(ref_reqs[i]),
            "speculative %s vs plain" % name)
        out[name] = {
            "identical": not ties,
            "diverged_at_ties": [{"request": i, "token": t}
                                 for i, t in ties],
            "proposed": proposed, "accepted": accepted,
            "accept_rate": accepted / max(1.0, proposed),
            "dispatches": eng.dispatches, "plain_dispatches": eng_r.dispatches,
            "tokens_per_s": serve_metrics(eng, reqs, secs)["tokens_per_s"],
            "plain_tokens_per_s":
                serve_metrics(eng_r, reqs_r, secs_r)["tokens_per_s"],
            "graphs": eng.graph_info()}
        check(proposed > 0, "the drafter proposed nothing (%s)" % name)
        eng.close()
        eng_r.close()
    emit("serve_speculative", nvidia_smi=SMI[0], speculation=4, **out)
    SAMPLED_REF[0] = None


PREFIX_SYS = 512  # the shared system prompt's tokens (32 pages of 16)


def prefix_stream(vocab):
    """48 chat requests behind one 512-token system prompt: each its own
    16-128-token suffix and 16-64 new tokens; a primer first, the system
    prompt and one token, that leaves the system prompt's 32 pages in the
    prefix cache when it finishes."""
    rng = np.random.RandomState(1)
    sys_prompt = rng.randint(0, vocab, PREFIX_SYS).tolist()
    out = [(sys_prompt + [int(rng.randint(vocab))], 1)]
    for _ in range(48):
        suffix = rng.randint(0, vocab, int(rng.randint(16, 129))).tolist()
        out.append((sys_prompt + suffix, int(rng.randint(16, 65))))
    return out


def serve_prefix_phase(model, cfg):
    """``serve_prefix``: the chat stream on an engine with
    prefix_cache_pages=64 against a cold engine (no prefix cache), both
    captured (prefills and resumes too, one graph a prompt bucket): hits
    and resumes > 0, fewer prefills, streams equal to the cold engine's
    (parting only at near ties, reported), page accounting after drain();
    TTFT p50 of hits against misses; the same prefix serve eager
    (``cuda_graphs=False``): its streams equal the captured one's, TTFT
    p50 and p99, tokens/s, prefill and resume ms by bucket each way."""
    from paddle_tpu_torch.serving import FINISHED

    stream = prefix_stream(cfg.vocab_size)
    eng_c, reqs_c, secs_c = serve(model, stream, graphs=True,
                                  collect_logits=True)
    cold = serve_metrics(eng_c, reqs_c, secs_c)
    admit_ms, hit_ids = {}, set()

    def record(eng):
        """Time each admission's prefill or resume (each ends in a host
        read of its first token) and note which requests hit."""
        prefill, resume = eng._prefill, eng._prefill_from_prefix

        def timed_prefill(req, slot, bucket):
            t = time.perf_counter()
            out = prefill(req, slot, bucket)
            admit_ms[req.id] = (time.perf_counter() - t) * 1e3
            return out

        def noted_resume(req, slot, entry):
            hit_ids.add(req.id)
            return resume(req, slot, entry)

        eng._prefill, eng._prefill_from_prefix = timed_prefill, noted_resume

    eng, reqs, secs = serve(model, stream, graphs=True,
                            prefix_cache_pages=64, hook=record)
    check(all(r.state == FINISHED for r in reqs) and eng.page_accounting_ok(),
          "prefix serve broken")
    warm = serve_metrics(eng, reqs, secs)
    hits = eng.resumes
    check(hits > 0 and warm["prefills"] < cold["prefills"],
          "prefix cache: %d resumes, %d prefills against %d cold"
          % (hits, warm["prefills"], cold["prefills"]))
    ties = tie_divergences(reqs, reqs_c,
                           lambda i: eng_c.captured_logits(reqs_c[i]),
                           "prefix hit vs cold")
    stats = eng.stats()["prefix_cache"]
    eng_e, reqs_e, secs_e = serve(model, stream, prefix_cache_pages=64)
    check([r.tokens_out for r in reqs_e] == [r.tokens_out for r in reqs]
          and eng_e.resumes == hits,
          "prefix serve: eager streams differ from captured ones")
    warm_eager = serve_metrics(eng_e, reqs_e, secs_e)
    del eng_e, reqs_e
    summary = eng.drain(timeout_s=60.0)
    check(eng.page_accounting_ok() and eng.pool.num_used == 0,
          "pages left after drain with a prefix cache")
    hit = [r for r in reqs[1:] if r.id in hit_ids]
    miss = [r for r in reqs[1:] if r.id not in hit_ids]

    def p50(xs):
        return float(np.percentile(xs, 50)) if xs else None
    emit("serve_prefix", nvidia_smi=SMI[0], requests=len(stream),
         system_prompt_tokens=PREFIX_SYS, prefix_cache_pages=64,
         resumes=hits, prefills=warm["prefills"],
         cold_prefills=cold["prefills"], prefix_cache=stats,
         identical=not ties,
         diverged_at_ties=[{"request": i, "token": t} for i, t in ties],
         ttft_p50_hit_ms=p50([r.ttft_s * 1e3 for r in hit]),
         ttft_p50_miss_ms=p50([r.ttft_s * 1e3 for r in miss]),
         admission_ms_p50_hit=p50([admit_ms[r.id] for r in hit]),
         admission_ms_p50_miss=p50([admit_ms[r.id] for r in miss]),
         hits=len(hit), misses=len(miss), warm=warm, warm_eager=warm_eager,
         cold=cold, drain=summary)


def serve_lifecycle_phase(model, stream):
    """``serve_lifecycle``: drain() partway through the stream (queued
    requests REJECTED, in-flight ones finish), a deadline that times 4
    requests out, and a FaultPlan at serving.decode that fires transient
    twice, then fatal once: 2 retries, the batch FAILED, the engine
    serving on, page accounting intact."""
    from paddle_tpu_torch import serving
    from paddle_tpu_torch.reliability import faults
    from paddle_tpu_torch.serving import metrics as sm

    def engine():
        eng = serving.ServingEngine(model, serving.ServingConfig(
            slots=16, page_size=16, max_seq=1024))
        eng.warmup(buckets=(8, 16))
        return eng

    eng = engine()
    reqs = [eng.submit(p, m) for p, m in stream]
    eng.step()
    summary = eng.drain(timeout_s=120.0)
    states = [r.state for r in reqs]
    check(summary == {"finished": 16, "timed_out": 0, "failed": 0,
                      "rejected": 8}
          and states.count("finished") == 16
          and states.count("rejected") == 8
          and eng.pool.num_used == 0 and eng.page_accounting_ok(),
          "drain: summary %s, states %s" % (summary, states))
    short = [(p[:16], 8) for p, _ in stream[:8]]
    eng = engine()
    reqs = [eng.submit(p, m, deadline_s=0.0 if i % 2 else None)
            for i, (p, m) in enumerate(short)]
    eng.run()
    states = [r.state for r in reqs]
    check(states.count("timeout") == 4 and states.count("finished") == 4
          and eng.pool.num_used == 0 and eng.page_accounting_ok(),
          "deadlines: states %s" % states)
    eng = engine()
    r0, f0 = sm.RETRIES.value, sm.FAULTS.value
    plan = faults.FaultPlan.parse(
        "serving.decode@2=transient:2;serving.decode@4=fatal")
    with plan:
        reqs = [eng.submit(p, m) for p, m in short]
        eng.run()
    health = eng.health()
    after = [eng.submit(p, m) for p, m in short[:4]]
    eng.run()
    states = [r.state for r in reqs]
    check(sm.RETRIES.value - r0 == 2 and sm.FAULTS.value - f0 == 1
          and states.count("failed") == 8 and plan.fired == 3
          and health["status"] == "degraded"
          and all(r.state == "finished" for r in after)
          and eng.health()["status"] == "ok"
          and eng.pool.num_used == 0 and eng.page_accounting_ok(),
          "fault ladder: retries %s, states %s, health %s"
          % (sm.RETRIES.value - r0, states, health))
    emit("serve_lifecycle", drain=summary, deadline_timeouts=4,
         retries=2, failed=8, fault_plan=repr(plan.specs),
         health_after_fault=health, health_after=eng.health())


def xent_kernel_phase(dev):
    """K2a/K2b against their plain versions at the Transformer-base loss
    shape: N = 64 x 256 rows, V = 30000, label smoothing 0.1, a few rows
    labelled -100 (then, by ``xent_shape_check``, at the vision shapes,
    BERT's MLM [640, 30522] and NSP [32, 2] shapes, float32 and bf16,
    word2vec's [100, 2073] and the PTB LM's [700, 10000]). The loss to 1e-5 relative in both dtypes (bf16 logits
    upcast exactly, so the plain version in float32 sees the same inputs);
    dlogits to 1e-6 absolute in float32, and in bf16 each element to
    2e-2·|want| + 1e-6·(max |want| of its row), a bound that a missing
    eps/V term (~|g|·3e-6 here) breaks."""
    from paddle_tpu_torch.ops.kernels import softmax_xent as sx

    n, v, eps = TRAIN_BATCH * TRAIN["seq"], TRAIN["vocab"], 0.1
    rng = np.random.RandomState(0)
    x32 = torch.as_tensor((rng.randn(n, v) * 2).astype(np.float32),
                          device=dev)
    lab_np = rng.randint(0, v, n).astype(np.int64)
    lab_np[rng.choice(n, 16, replace=False)] = -100
    lab = torch.as_tensor(lab_np, device=dev)
    # an O(1) upstream gradient, so the absolute dlogits tolerance means
    # something (the training step's is 1/N, which would hide errors)
    g = torch.as_tensor(rng.randn(n, 1).astype(np.float32), device=dev)

    errs = {}
    keep = (lab != -100)[:, None]
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt).replace("torch.", "")
        x = x32.to(dt)
        loss, lse = sx.softmax_xent_fwd(x, lab, eps)
        dx = sx.softmax_xent_bwd(x, lab, lse, g, eps)
        torch.cuda.synchronize()
        # bf16 -> float32 is exact, so both sides see the same inputs
        want_loss, want_lse = sx.softmax_xent_reference(x.float(), lab, eps)
        want_dx = sx.softmax_xent_reference_bwd(x.float(), lab, want_lse, g,
                                                eps)
        e_loss = float((loss - want_loss).abs().max())
        e_rel = rel_err(loss, want_loss)
        e_dx = float((dx.float() - want_dx).abs().max())
        check(e_rel <= 1e-5, "K2a %s loss rel err %g > 1e-5" % (name, e_rel))
        if dt == torch.float32:
            check(e_dx <= 1e-6, "K2b f32 dlogits abs err %g > 1e-6" % e_dx)
            e_scaled = None
        else:
            e_scaled = scaled_err(dx, want_dx, 2e-2)
            check(e_scaled <= 1, "K2b bf16 dlogits err %g of its bound "
                  "(2e-2 |want| + 1e-6 row max)" % e_scaled)
            # planted faults: the same checks reject a loss without the
            # (eps/V)·Σx term and dlogits without the eps/V term
            no_sum = torch.where(keep, want_loss + (eps / v) * x.float().sum(
                dim=-1, keepdim=True), 0.0)
            check(rel_err(no_sum, want_loss) > 1e-5,
                  "the loss check passes a loss without its (eps/V)·Σx term")
            no_eps = torch.where(keep, want_dx + g * (eps / v), 0.0).to(dt)
            check(scaled_err(no_eps, want_dx, 2e-2) > 1,
                  "the bf16 dlogits check passes dlogits without eps/V")
            del no_sum, no_eps
        check(bool(dx.dtype == dt), "dlogits dtype %s != %s" % (dx.dtype, dt))
        check(not loss[lab == -100].any() and not dx[lab == -100].any(),
              "rows labelled -100 not zeroed")
        errs[name] = {"loss_abs": e_loss, "loss_rel": e_rel,
                      "dlogits_abs": e_dx, "dlogits_scaled": e_scaled}
        del loss, lse, dx, want_loss, want_lse, want_dx

    flush = l2_flusher(dev)
    F = torch.nn.functional
    loss, lse = sx.softmax_xent_fwd(x32, lab, eps)
    fwd_ms = cuda_ms(lambda: sx.softmax_xent_fwd(x32, lab, eps), flush=flush)
    fwd_dev = device_ms(lambda: sx.softmax_xent_fwd(x32, lab, eps),
                        r"xent_fwd_kernel", flush=flush)
    fwd_plain = cuda_ms(lambda: sx.softmax_xent_reference(x32, lab, eps),
                        flush=flush)
    fwd_lib = cuda_ms(lambda: F.cross_entropy(
        x32, lab, reduction="none", label_smoothing=eps), flush=flush)
    bwd_ms = cuda_ms(lambda: sx.softmax_xent_bwd(x32, lab, lse, g, eps),
                     flush=flush)
    bwd_dev = device_ms(lambda: sx.softmax_xent_bwd(x32, lab, lse, g, eps),
                        r"xent_bwd_kernel", flush=flush)
    bwd_plain = cuda_ms(lambda: sx.softmax_xent_reference_bwd(
        x32, lab, lse, g, eps), flush=flush)
    xr = x32.detach().requires_grad_(True)
    lib_loss = F.cross_entropy(xr, lab, reduction="none",
                               label_smoothing=eps)
    g1 = g.reshape(-1)
    bwd_lib = cuda_ms(lambda: torch.autograd.grad(
        lib_loss, [xr], g1, retain_graph=True), flush=flush)
    vision = {vision_key(n_, v_, dt): xent_shape_check(
        dev, flush, n_, v_, dt, seed=2 + i, kernel="softmax_xent_vision")
        for i, (n_, v_, dt) in enumerate(VISION_XENT)}
    bert = {vision_key(n_, v_, dt): xent_shape_check(
        dev, flush, n_, v_, dt, seed=8 + i, kernel="softmax_xent_bert")
        for i, (n_, v_, dt) in enumerate(BERT_XENT)}
    word2vec = {vision_key(W2V_BATCH, W2V["dict_size"], torch.float32):
                xent_shape_check(dev, flush, W2V_BATCH, W2V["dict_size"],
                                 torch.float32, seed=12,
                                 kernel="softmax_xent_word2vec")}
    ptb_n = PTB["batch_size"] * PTB["num_steps"]
    ptb = {vision_key(ptb_n, PTB["vocab_size"], torch.float32):
           xent_shape_check(dev, flush, ptb_n, PTB["vocab_size"],
                            torch.float32, seed=13,
                            kernel="softmax_xent_ptb")}
    del xr, lib_loss, flush

    def row(name, fn_line, ms, dev, plain, lib, nbytes, flops, err):
        t_bytes = nbytes / H100_BYTES_PER_S * 1e3
        t_ops = flops / H100_F32_FLOP_PER_S * 1e3
        return {"name": name, "route": "cuda",
                "source": "paddle_tpu_torch/csrc/softmax_xent.cu",
                "replaces": "paddle_tpu/ops/pallas_kernels/softmax_xent.py:"
                            + fn_line,
                "launches": None, "max_abs_err": err, "ms": ms,
                "device_ms": dev, "plain_ms": plain,
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "library_ms": lib}

    # least work, float32: K2a reads the logits and labels once and writes
    # loss and lse; K2b reads logits, labels, lse and g once and writes
    # dlogits. Operations: K2a an exp, a max, 2 adds and a compare per
    # element; K2b an exp, a sub, a compare, a sub and a mul.
    nv = n * v
    rows = [row("softmax_xent_fwd", "164", fwd_ms, fwd_dev, fwd_plain,
                fwd_lib, 4 * nv + 8 * n + 8 * n, 5 * nv,
                errs["float32"]["loss_abs"]),
            row("softmax_xent_bwd", "208", bwd_ms, bwd_dev, bwd_plain, bwd_lib,
                8 * nv + 8 * n + 8 * n, 5 * nv,
                errs["float32"]["dlogits_abs"])]
    emit("kernel_vs_plain", kernel="softmax_xent",
         shape={"N": n, "V": v, "smooth": eps, "ignored_rows": 16},
         max_err=errs, tol={"float32": {"loss_rel": 1e-5, "dlogits_abs": 1e-6},
                            "bfloat16": {"loss_rel": 1e-5,
                                         "dlogits_scaled": 1.0}},
         fwd={"ms": fwd_ms, "device_ms": fwd_dev, "plain_ms": fwd_plain,
              "library_ms": fwd_lib, "bound_ms": rows[0]["bound_ms"]},
         bwd={"ms": bwd_ms, "device_ms": bwd_dev, "plain_ms": bwd_plain,
              "library_ms": bwd_lib,
              "bound_ms": rows[1]["bound_ms"]})
    for row, key in zip(rows, ("fwd", "bwd")):
        for field, shapes in (("vision_shapes", vision),
                              ("bert_shapes", bert),
                              ("word2vec_shapes", word2vec),
                              ("ptb_shapes", ptb)):
            row[field] = {
                name: {"launches": None, "max_err": c["max_err"],
                       **{k[len(key) + 1:]: val for k, val in c.items()
                          if k.startswith(key + "_")}}
                for name, c in shapes.items()}
    del x32, lab, g, loss, lse
    torch.cuda.empty_cache()
    return rows


def vision_key(n, v, dtype):
    """The name of a K2 vision or BERT shape in the kernels line:
    "64x1000_float32"."""
    return "%dx%d_%s" % (n, v, str(dtype).replace("torch.", ""))


def build_transformer(fluid, n_layer, d_model, n_head, d_inner, seq, vocab,
                      train, dropout=None, amp=False):
    """``__graft_entry__._build_transformer``, for the port's package;
    ``amp`` decorates the optimizer as ``bench_transformer`` does with
    ``use_amp=True``."""
    from paddle_tpu_torch.models import transformer as tfm

    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 7
    with fluid.program_guard(main, startup):
        with fluid.unique_name.guard():
            src = fluid.layers.data("src", shape=[seq], dtype="int64")
            trg = fluid.layers.data("trg", shape=[seq], dtype="int64")
            lbl = fluid.layers.data("lbl", shape=[seq, 1], dtype="int64")
            smask = fluid.layers.data("smask", shape=[seq], dtype="float32")
            tmask = fluid.layers.data("tmask", shape=[seq], dtype="float32")
            logits, loss = tfm.transformer(
                src, trg, lbl, smask, tmask,
                src_vocab_size=vocab, trg_vocab_size=vocab, max_length=seq,
                n_layer=n_layer, n_head=n_head, d_model=d_model,
                d_inner=d_inner,
                dropout_rate=(0.1 if train else 0.0) if dropout is None
                else dropout,
                label_smooth_eps=0.1, is_test=not train)
            if train:
                opt = fluid.optimizer.Adam(learning_rate=1e-4)
                if amp:
                    opt = fluid.amp.decorate(opt)
                opt.minimize(loss)
    return main, startup, loss, logits


def train_feed(batch, seed=0):
    """The fixed batch of bench.py's bench_transformer (another batch of
    the same shapes for another ``seed``)."""
    seq, vocab = TRAIN["seq"], TRAIN["vocab"]
    rng = np.random.RandomState(seed)
    return {
        "src": rng.randint(2, vocab, (batch, seq)).astype("int64"),
        "trg": rng.randint(2, vocab, (batch, seq)).astype("int64"),
        "lbl": rng.randint(2, vocab, (batch, seq, 1)).astype("int64"),
        "smask": np.ones((batch, seq), "float32"),
        "tmask": np.ones((batch, seq), "float32"),
    }


def train_steps(exe, main, loss, feed, scope, n):
    """n training steps; returns (losses, seconds of each step). A step
    ends with its loss on the host, so its time is the device's too."""
    losses, secs = [], []
    for _ in range(n):
        t0 = time.perf_counter()
        lv, = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        secs.append(time.perf_counter() - t0)
        losses.append(float(lv))
    return losses, secs


def train_phase(xent_rows, amp=False):
    """Transformer-base at full width through the port's Fluid API, in
    float32 or under ``fluid.amp.decorate`` (bfloat16) as
    ``bench_transformer`` runs it with ``use_amp=True``: 2 warm-up steps,
    then 6 timed steps on one fixed batch."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.ops.kernels import softmax_xent as sx

    mode = "bfloat16_amp" if amp else "float32"
    t0 = time.perf_counter()
    main, startup, loss, _ = build_transformer(fluid, train=True, amp=amp,
                                               **TRAIN)
    build_s = time.perf_counter() - t0
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CUDAPlace(0))
    exe.run(startup, scope=scope)
    torch.cuda.synchronize()
    params = main.all_parameters()
    n_weights = sum(int(np.prod(p.shape)) for p in params)
    ops = [op.type for op in main.global_block.ops]
    emit("train_model", mode=mode, config=TRAIN, batch=TRAIN_BATCH,
         params=len(params), weights=n_weights, ops=len(ops),
         op_types=len(set(ops)), adam_ops=ops.count("adam"),
         build_s=build_s, setup_s=time.perf_counter() - t0)
    feed = train_feed(TRAIN_BATCH)
    warm, _ = train_steps(exe, main, loss, feed, scope, 2)
    torch.cuda.reset_peak_memory_stats()
    sx.LAUNCHES_FWD = sx.LAUNCHES_BWD = 0
    losses, secs = train_steps(exe, main, loss, feed, scope, 6)
    fwd, bwd = sx.LAUNCHES_FWD, sx.LAUNCHES_BWD
    peak = torch.cuda.max_memory_allocated()
    all_losses = warm + losses
    check(bool(np.isfinite(all_losses).all()), "non-finite training loss")
    check(all_losses[-1] < all_losses[0],
          "loss did not fall: %r" % all_losses)
    check(fwd == len(losses) and bwd == len(losses),
          "K2 launches fwd %d bwd %d over %d steps (%s)"
          % (fwd, bwd, len(losses), mode))
    masters = {str(scope.find_var(p.name).dtype) for p in params}
    check(masters == {"torch.float32"}, "parameters not float32: %r" % masters)
    key = "launches_amp" if amp else "launches"
    xent_rows[0][key], xent_rows[1][key] = fwd, bwd
    step_ms = float(np.median(secs)) * 1e3
    emit("train", mode=mode, steps=len(losses), step_ms_median=step_ms,
         step_ms=[s * 1e3 for s in secs],
         target_tokens_per_s=TRAIN_BATCH * TRAIN["seq"] / (step_ms / 1e3),
         peak_memory_bytes=peak, losses=all_losses,
         k2_launches={"fwd": fwd, "bwd": bwd})
    train_profile_phase(exe, main, loss, feed, scope,
                        phase="train_profile" + ("_amp" if amp else ""))
    if amp:
        counts = captured_leg(
            "transformer_captured", main, loss, scope,
            [train_feed(TRAIN_BATCH, seed=i) for i in range(8)], amp,
            {k: (pat, 1) for k, pat in K2_NAMES.items()},
            pipeline_batch=TRAIN_BATCH)
        for row, kern in zip(xent_rows, K2_NAMES):
            row.setdefault("captured_launches_a_step", {})[
                "transformer_amp"] = counts[kern]
    del scope, exe
    torch.cuda.empty_cache()


def train_profile_phase(exe, main, loss, feed, scope,
                        phase="train_profile", groups=None):
    """Where a training step's time goes: ``profile_step`` of one step
    (returns its busy share and ``by_group``)."""
    return profile_step(lambda: train_steps(exe, main, loss, feed, scope, 1)[1][0],
                 phase, groups)


def profile_step(step, phase, groups=None):
    """One ``step()`` (it returns its wall seconds) under torch.profiler,
    recording the card's activity (CUPTI's kernels, copies and runtime
    calls, not the torch ops) and summing the profiler's raw events
    (``kineto_results``); device busy share = the CUDA events' time summed
    / wall time of the step (the profiler's host cost is in the wall
    time); ``host_syncs`` counts the runtime calls that block the host,
    ``host_top`` the host's largest runtime calls. ``groups`` ({name:
    regular expression}) sums the kernels by the first pattern their name
    matches, the rest under "other"."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        secs = [step()]
    kern, host = {}, {}
    for e in prof.profiler.kineto_results.events():
        item = (kern if e.device_type() == DeviceType.CUDA
                else host).setdefault(e.name(), [0, 0])
        item[0] += 1
        item[1] += e.duration_ns()
    busy_ms = sum(ns for _, ns in kern.values()) / 1e6
    top = sorted(kern.items(), key=lambda kv: -kv[1][1])[:10]
    by_group = None
    if groups:
        by_group = {g: {"device_ms": 0.0, "count": 0}
                    for g in list(groups) + ["other"]}
        for name, (c, ns) in kern.items():
            g = next((g for g, pat in groups.items()
                      if re.search(pat, name, re.I)), "other")
            by_group[g]["device_ms"] += ns / 1e6
            by_group[g]["count"] += c
    host_top = sorted(host.items(), key=lambda kv: -kv[1][1])[:8]
    share = busy_ms / (secs[0] * 1e3) if busy_ms else None
    emit(phase, wall_ms=secs[0] * 1e3, device_busy_ms=busy_ms,
         device_busy_share=share,
         kernels_launched=sum(c for c, _ in kern.values()),
         by_group=by_group,
         host_syncs={name: c for name, (c, _) in host.items()
                     if "Synchronize" in name},
         top=[{"name": name[:80], "count": c, "device_ms": ns / 1e6}
              for name, (c, ns) in top],
         host_top=[{"name": name[:60], "count": c, "self_cpu_ms": ns / 1e6}
                   for name, (c, ns) in host_top])
    return share, by_group


def train_parity_phase():
    """The training program at full width, batch 2, dropout 0: two steps
    on the card and two on the CPU (the plain versions) from the same
    startup state, carried by io.state_from_numpy. TF32 is off, so both
    run float32 products; the losses must agree to 1e-4 relative."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.ops.kernels import softmax_xent as sx

    main, startup, loss, _ = build_transformer(fluid, train=True, dropout=0.0,
                                               **TRAIN)
    feed = train_feed(2)
    card = fluid.Scope()
    exe = fluid.Executor(fluid.CUDAPlace(0))
    exe.run(startup, scope=card)
    arrays = {n: card.as_numpy(n) for n in card.vars}
    f0, b0 = sx.LAUNCHES_FWD, sx.LAUNCHES_BWD
    card_losses, _ = train_steps(exe, main, loss, feed, card, 2)
    check((sx.LAUNCHES_FWD - f0, sx.LAUNCHES_BWD - b0) == (2, 2),
          "the card run launched K2a %d and K2b %d times over 2 steps"
          % (sx.LAUNCHES_FWD - f0, sx.LAUNCHES_BWD - b0))
    cpu = fluid.io.state_from_numpy(main, arrays, fluid.Scope(),
                                    fluid.CPUPlace())
    t0 = time.perf_counter()
    cpu_losses, _ = train_steps(fluid.Executor(fluid.CPUPlace()), main, loss,
                                feed, cpu, 2)
    check((sx.LAUNCHES_FWD - f0, sx.LAUNCHES_BWD - b0) == (2, 2),
          "the CPU run launched a kernel")
    rel = [abs(a - b) / abs(b) for a, b in zip(card_losses, cpu_losses)]
    check(bool(np.isfinite(card_losses + cpu_losses).all())
          and max(rel) <= 1e-4,
          "card %r vs CPU %r losses (rel %r > 1e-4)"
          % (card_losses, cpu_losses, rel))
    emit("train_parity", batch=2, dropout=0.0, card_losses=card_losses,
         cpu_losses=cpu_losses, rel_err=rel, tol=1e-4,
         cpu_s=time.perf_counter() - t0)
    del card, cpu
    torch.cuda.empty_cache()


# float32: another summation order over up to 2048 terms. bfloat16: outputs
# are rounded to bf16 (4e-3 relative), and p and ds are rounded before their
# products against a running row maximum in the kernel, the final one in the
# plain version; elements that cancel are held to a share of their row's
# largest value.
FLASH_TOL = {"float32": (1e-4, 1e-5), "bfloat16": (2e-2, 1e-2)}
# what each float32 kernel is built from (csrc/flash_attention.cu)
F32_DESIGN = {"fwd": "fma f32, 4x8 register tiles, cp.async ring",
              "dkv": "fma f32, 4x8 register tiles, cp.async ring, lean",
              "dq": "fma f32, 4x8 register tiles, cp.async ring"}


def flash_inputs(dev, dt, b, h, sq, sk, d, seed, bias=False, seg=False,
                 ab_dtype=None):
    """q, k, v, do as the attention op receives them: q, k, v are the head
    views of one fused [B,S,3·H·D] projection (when Sq == Sk), do a
    transposed [B,S,H,D] tensor; a bias broadcast over heads, of dtype
    ``ab_dtype`` (q's by default); sorted segment ids shared by q and
    kv."""
    from paddle_tpu_torch.ops.kernels import flash_attention as fa

    gen = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(dt)

    if sq == sk:
        q, k, v = (t.reshape(b, sq, h, d).transpose(1, 2) for t in
                   randn(b, sq, 3 * h * d).split(h * d, dim=2))
    else:
        q = randn(b, sq, h, d).transpose(1, 2)
        k, v = (randn(b, sk, h, d).transpose(1, 2) for _ in range(2))
    do = randn(b, sq, h, d).transpose(1, 2)
    ab = None
    if bias:
        ab = torch.randn(b, 1, sq, sk, generator=gen, device=dev).to(
            ab_dtype or dt).expand(b, h, sq, sk)
    ids = None
    if seg:
        base = torch.randint(0, 3, (b, max(sq, sk)), generator=gen,
                             device=dev).sort(dim=-1).values
        ids = fa.SegmentIds(base[:, :sq], base[:, :sk])
    return q, k, v, do, ab, ids


def flash_check(name, dt, q, k, v, do, ab, ids, causal, sm, rate, seed):
    """K1a, K1b, K1c against their plain versions on the same tensors;
    returns the largest absolute error of each output. The backward
    kernels get the plain forward's lse and di, so each is held alone."""
    from paddle_tpu_torch.ops.kernels import flash_attention as fa

    dname = str(dt).replace("torch.", "")
    rtol, floor = FLASH_TOL[dname]
    o, lse = fa.flash_fwd(q, k, v, ab, ids, causal, sm, rate, seed)
    torch.cuda.synchronize()
    want_o, want_lse = fa.flash_fwd_reference(q, k, v, ab, ids, causal, sm,
                                              rate, seed)
    di = (want_o.float() * do.float()).sum(-1)
    args = (q, k, v, ab, ids, want_lse, do, di, causal, sm, rate, seed)
    dk, dv = fa.flash_bwd_dkv(*args)
    dq, dab = fa.flash_bwd_dq(*args)
    torch.cuda.synchronize()
    want_dk, want_dv = fa.flash_bwd_dkv_reference(*args)
    want_dq, want_dab = fa.flash_bwd_dq_reference(*args)
    live = torch.isfinite(want_lse)  # a row that sees nothing has +inf
    check(torch.equal(torch.isfinite(lse), live),
          "%s %s: other dead rows than the plain version" % (name, dname))
    e_lse = float((lse[live] - want_lse[live]).abs().max())
    check(e_lse <= 2e-5 + 1e-5 * float(want_lse[live].abs().max()),
          "%s %s lse abs err %g" % (name, dname, e_lse))
    errs = {"lse": e_lse}
    pairs = [("o", o, want_o), ("dk", dk, want_dk), ("dv", dv, want_dv),
             ("dq", dq, want_dq)]
    if ab is not None:
        pairs.append(("dab", dab, want_dab))
    for out, got, want in pairs:
        want_dt = ab.dtype if out == "dab" else dt  # dab in the bias's dtype
        check(got.dtype == want_dt, "%s %s dtype %s" % (name, out, got.dtype))
        e = flash_err(got, want.float(), rtol, floor)
        check(e <= 1, "%s %s %s err %g of its bound (%g |want| + %g row max)"
              % (name, dname, out, e, rtol, floor))
        errs[out] = float((got.float() - want.float()).abs().max())
    return errs


def flash_planted_faults(dev):
    """The check must reject a causal mask off by one, a ds without its
    − di, and dk, dv whose loop over the q tiles stops one tile early, in
    both dtypes' tolerances (the bfloat16 one is the looser)."""
    from paddle_tpu_torch.ops.kernels import flash_attention as fa

    b, h, s, d = 2, 4, 256, 64
    sm = d ** -0.5
    q, k, v, do, _, _ = flash_inputs(dev, torch.float32, b, h, s, s, d, 5)
    want_o, lse = fa.flash_fwd_reference(q, k, v, None, None, True, sm)
    di = (want_o * do).sum(-1)
    want_dq, _ = fa.flash_bwd_dq_reference(q, k, v, None, None, lse, do, di,
                                           True, sm)
    # every row sees one position too many
    late = torch.ones(s, s, device=dev).tril(diagonal=1).log()
    bad_o, _ = fa.flash_fwd_reference(q, k, v, late.expand(b, h, s, s), None,
                                      False, sm)
    # ds = p·dp, the row term left out
    bad_dq, _ = fa.flash_bwd_dq_reference(q, k, v, None, None, lse, do,
                                          torch.zeros_like(di), True, sm)
    want_dk, want_dv = fa.flash_bwd_dkv_reference(q, k, v, None, None, lse,
                                                  do, di, True, sm)
    # the last 64 q rows left out of dk and dv
    n = s - 64
    bad_dk, bad_dv = fa.flash_bwd_dkv_reference(
        q[:, :, :n], k, v, None, None, lse[:, :, :n], do[:, :, :n],
        di[:, :, :n], True, sm)
    for rtol, floor in FLASH_TOL.values():
        check(flash_err(bad_o, want_o, rtol, floor) > 1,
              "the flash check passes a causal mask off by one")
        check(flash_err(bad_dq, want_dq, rtol, floor) > 1,
              "the flash check passes a ds without its - di")
        check(flash_err(bad_dk, want_dk, rtol, floor) > 1
              and flash_err(bad_dv, want_dv, rtol, floor) > 1,
              "the flash check passes dk, dv without the last q tile")


def flash_crossover(dev):
    """Forward + backward of ``sdpa`` through the kernels and composed, at
    B·S = 16384 tokens, 16 heads of 64, causal: where the kernels overtake
    the composed path on this card."""
    from paddle_tpu_torch.flags import set_flag
    from paddle_tpu_torch.ops import attention_ops as ao

    flush = l2_flusher(dev)
    h, d = LONGCTX["n_head"], LONGCTX["d_model"] // LONGCTX["n_head"]
    rows = []
    for s in (512, 1024, 2048, 4096):
        b = LONGCTX_BATCH * LONGCTX_SEQ // s
        for dt in (torch.float32, torch.bfloat16):
            q, k, v, do, _, _ = flash_inputs(dev, dt, b, h, s, s, d, s)
            q, k, v = (t.detach().requires_grad_(True) for t in (q, k, v))

            def fwd_bwd():
                o = ao.sdpa(q, k, v, causal=True, sm_scale=d ** -0.5)
                torch.autograd.grad(o, [q, k, v], do)

            ms = {}
            for route, min_seq in (("flash", 1), ("composed", 1 << 30)):
                set_flag("flash_attention_min_seq", min_seq)
                ms[route] = cuda_ms(fwd_bwd, reps=10, flush=flush)
            rows.append({"S": s, "B": b,
                         "dtype": str(dt).replace("torch.", ""),
                         "flash_ms": ms["flash"],
                         "composed_ms": ms["composed"]})
            del q, k, v, do
            torch.cuda.empty_cache()
    set_flag("flash_attention_min_seq", 2048)
    emit("flash_crossover", heads=h, head_dim=d, causal=True,
         fwd_plus_bwd=rows)


def flash_sass_hmma():
    """Tensor-core instructions (HMMA, and Hopper's HGMMA) in each kernel of
    the built flash library, from ``cuobjdump -sass`` (the toolkit's,
    beside nvcc): every instantiation of the bfloat16 forward, dK/dV and dQ
    kernels (one a head width and bias type: bfloat16 or none, float32)
    must hold HMMA; the float32 kernels (FFMA tiles) must hold
    neither. Returns ({kernel and its mangled template arguments: HMMA
    count}, {the same: HGMMA count})."""
    import re
    from pathlib import Path

    from paddle_tpu_torch.ops.kernels import _build

    tool = Path(_build.nvcc_path()).parent / "cuobjdump"
    check(tool.exists(), "no cuobjdump beside nvcc at %s" % tool)
    lib = _build._lib_path(_build.SRC_DIR / "flash_attention.cu")
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            counts[name] = [0, 0]
        elif name is not None:
            counts[name][0] += bool(re.search(r"\bHMMA\b", line))
            counts[name][1] += bool(re.search(r"\bHGMMA\b", line))
    hmma, hgmma = {}, {}
    for full, (n, ng) in counts.items():
        m = re.search(r"\d(flash_\w+?_kernel)I", full)  # <length><name>I
        if m:
            hmma[full[m.start(1):]] = n
            hgmma[full[m.start(1):]] = ng
    for kern in ("flash_fwd_bf16_kernel", "flash_dkv_bf16_kernel",
                 "flash_dq_bf16_kernel"):
        mine = {k: n for k, n in hmma.items() if k.startswith(kern + "I")}
        check(len(mine) == 6 and all(mine.values()),
              "%s: HMMA counts %r (want one instantiation a head width and "
              "bias type, each on the tensor cores)" % (kern, mine))
    for kern in ("flash_fwd_kernel", "flash_dkv_kernel", "flash_dq_kernel"):
        mine = {k: (n, hgmma[k]) for k, n in hmma.items()
                if k.startswith(kern + "I")}
        check(len(mine) == 3 and not any(any(c) for c in mine.values()),
              "%s: (HMMA, HGMMA) counts %r (want full float32 on FFMA at "
              "each head width)" % (kern, mine))
    return hmma, hgmma


def flash_kernel_phase(dev):
    """K1a/K1b/K1c against their plain versions: at the long-context
    training shape [8,16,2048,64], causal, in float32 and bfloat16, and at
    small shapes that cover bias, segment ids, ragged Sq != Sk, dropout and
    head widths 32 and 128, and a float32 bias under bfloat16 q, k, v; the
    dropout mask bit for bit in both dtypes; HMMA in the SASS of the three
    bfloat16 kernels, neither HMMA nor HGMMA in the float32 ones; a float32
    q view off 16 bytes, which K1a, K1b and K1c take as an aligned copy. Then
    their times beside bound, plain version and library call."""
    from paddle_tpu_torch.ops.kernels import flash_attention as fa

    b, s = LONGCTX_BATCH, LONGCTX_SEQ
    h, d = LONGCTX["n_head"], LONGCTX["d_model"] // LONGCTX["n_head"]
    sm = d ** -0.5
    flash_planted_faults(dev)

    small = [  # b, h, sq, sk, d, causal, bias, seg, rate
        (2, 4, 200, 200, 64, False, True, True, 0.0),
        (2, 4, 200, 200, 64, True, True, True, 0.0),
        (1, 4, 70, 333, 32, False, True, False, 0.0),
        (1, 4, 333, 70, 128, False, False, True, 0.0),
        (2, 4, 192, 192, 64, True, False, False, 0.1),
        (1, 2, 130, 130, 128, True, False, False, 0.1),
        (1, 2, 100, 130, 32, False, False, False, 0.1),
    ]
    small_errs = []
    for i, (b_, h_, sq, sk, d_, causal, bias, seg, rate) in enumerate(small):
        for dt in (torch.float32, torch.bfloat16):
            x = flash_inputs(dev, dt, b_, h_, sq, sk, d_, 100 + i, bias, seg)
            errs = flash_check("flash small %d" % i, dt, *x, causal,
                               d_ ** -0.5, rate, 77 + i)
            small_errs.append({"case": small[i],
                               "dtype": str(dt).replace("torch.", ""),
                               "max_abs_err": errs})
    # a float32 bias under bfloat16 q, k, v: all three kernels read it as
    # float32, and K1c returns dab in float32
    f32_bias = [  # b, h, sq, sk, d, causal, seg
        (2, 4, 200, 200, 64, True, True),
        (1, 2, 70, 333, 32, False, False),
    ]
    for i, (b_, h_, sq, sk, d_, causal, seg) in enumerate(f32_bias):
        x = flash_inputs(dev, torch.bfloat16, b_, h_, sq, sk, d_, 200 + i,
                         True, seg, ab_dtype=torch.float32)
        errs = flash_check("flash float32 bias %d" % i, torch.bfloat16, *x,
                           causal, d_ ** -0.5, 0.0, 0)
        small_errs.append({"case": f32_bias[i], "dtype": "bfloat16",
                           "bias_dtype": "float32", "max_abs_err": errs})
    # the dropout mask itself: with v = identity columns the output is the
    # dropped probabilities, 0 exactly where the plain mask drops
    n = 128
    keep = fa.dropout_keep_mask(
        0.1, -12345, torch.arange(2, device=dev)[:, None, None, None],
        torch.arange(2, device=dev)[None, :, None, None], 0, 0, (n, n), dev)
    for dt in (torch.float32, torch.bfloat16):
        q, k, _, _, _, _ = flash_inputs(dev, dt, 2, 2, n, n, n, 9)
        eye = torch.eye(n, device=dev, dtype=dt).expand(2, 2, n, n)
        o, _ = fa.flash_fwd(q, k, eye.contiguous(), None, None, False, 0.05,
                            0.1, -12345)
        check(torch.equal(o != 0, keep), "the kernel's dropout mask differs "
              "from the plain version's (%s)" % dt)
    hmma, hgmma = flash_sass_hmma()
    # a float32 q view one element off 16 bytes: the kernels get an aligned
    # copy (on the card)
    x = list(flash_inputs(dev, torch.float32, 1, 2, 96, 96, 64, 300))
    flat = torch.empty(x[0].numel() + 1, device=dev)
    x[0] = flat[1:].view(x[0].shape).copy_(x[0])
    check(not fa._cp_async_ok(x[0]), "the unaligned q view is aligned")
    errs = flash_check("flash unaligned q", torch.float32, *x, True,
                       64 ** -0.5, 0.0, 0)
    small_errs.append({"case": (1, 2, 96, 96, 64, True, False, False, 0.0),
                       "dtype": "float32", "q_view": "off 16 bytes",
                       "max_abs_err": errs})

    path_errs = {}
    for dt in (torch.float32, torch.bfloat16):
        x = flash_inputs(dev, dt, b, h, s, s, d, 0)
        path_errs[str(dt).replace("torch.", "")] = flash_check(
            "flash path", dt, *x, True, sm, 0.0, 0)
        del x
        torch.cuda.empty_cache()

    # times: L2 flushed before each launch, median of 30
    flush = l2_flusher(dev)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    times = {}
    for dt in (torch.float32, torch.bfloat16):
        q, k, v, do, _, _ = flash_inputs(dev, dt, b, h, s, s, d, 0)
        o, lse = fa.flash_fwd(q, k, v, None, None, True, sm)
        di = (o.float() * do.float()).sum(-1)
        args = (q, k, v, None, None, lse, do, di, True, sm)
        t = {"fwd": cuda_ms(lambda: fa.flash_fwd(q, k, v, None, None, True,
                                                 sm), flush=flush),
             "dkv": cuda_ms(lambda: fa.flash_bwd_dkv(*args), flush=flush),
             "dq": cuda_ms(lambda: fa.flash_bwd_dq(*args), flush=flush),
             "di": cuda_ms(lambda: (o.float() * do.float()).sum(-1),
                           flush=flush),
             "library_fwd": cuda_ms(lambda: sdpa(q, k, v, is_causal=True,
                                                 scale=sm), flush=flush)}
        qr, kr, vr = (x.detach().requires_grad_(True) for x in (q, k, v))
        lib_o = sdpa(qr, kr, vr, is_causal=True, scale=sm)
        t["library_bwd"] = cuda_ms(lambda: torch.autograd.grad(
            lib_o, [qr, kr, vr], do, retain_graph=True), flush=flush)
        del qr, kr, vr, lib_o
        suffix = "_kernel" if dt == torch.float32 else "_bf16_kernel"
        t["device_fwd"] = device_ms(lambda: fa.flash_fwd(
            q, k, v, None, None, True, sm), "flash_fwd" + suffix, flush=flush)
        t["device_dkv"] = device_ms(lambda: fa.flash_bwd_dkv(*args),
                                    "flash_dkv" + suffix, flush=flush)
        t["device_dq"] = device_ms(lambda: fa.flash_bwd_dq(*args),
                                   "flash_dq" + suffix, flush=flush)
        if dt == torch.float32:
            t["plain_fwd"] = cuda_ms(lambda: fa.flash_fwd_reference(
                q, k, v, None, None, True, sm), reps=5, flush=flush)
            t["plain_dkv"] = cuda_ms(lambda: fa.flash_bwd_dkv_reference(
                *args), reps=5, flush=flush)
            t["plain_dq"] = cuda_ms(lambda: fa.flash_bwd_dq_reference(
                *args), reps=5, flush=flush)
        times[str(dt).replace("torch.", "")] = t
        del q, k, v, do, o, lse, di, args
        torch.cuda.empty_cache()
    del flush

    # least work, causal: S(S+1)/2 visible scores a head, two flops a
    # multiply-add; K1a does 2 products of width D per score, K1b 4, K1c 3.
    # Bytes: each input read once, each output written once.
    visible = b * h * s * (s + 1) // 2
    qkv_o = b * h * s * d       # elements of one of q, k, v, o, do, ...
    stats = b * h * s * 4       # lse or di, float32
    work = {"fwd": (2 * 2 * d * visible, 4 * qkv_o, stats),
            "dkv": (4 * 2 * d * visible, 6 * qkv_o, 2 * stats),
            "dq": (3 * 2 * d * visible, 5 * qkv_o, 2 * stats)}

    def bound(kern, itemsize, peak):
        flops, elems, extra = work[kern]
        t_bytes = (elems * itemsize + extra) / H100_BYTES_PER_S * 1e3
        t_ops = flops / peak * 1e3
        return max(t_bytes, t_ops), \
            "bytes" if t_bytes >= t_ops else "operations"

    rows = []
    f32, bf16 = times["float32"], times["bfloat16"]
    for kern, name, line, out in (
            ("fwd", "flash_attention_fwd", "682", "o"),
            ("dkv", "flash_attention_bwd_dkv", "1061", "dk"),
            ("dq", "flash_attention_bwd_dq", "1428", "dq")):
        bound_ms, by = bound(kern, 4, H100_F32_FLOP_PER_S)
        bf16_bound_ms = bound(kern, 2, H100_BF16_FLOP_PER_S)[0]
        lib = "library_fwd" if kern == "fwd" else "library_bwd"
        rows.append({
            "name": name, "route": "cuda",
            "source": "paddle_tpu_torch/csrc/flash_attention.cu",
            "replaces": "paddle_tpu/ops/pallas_kernels/flash_attention.py:"
                        + line,
            "launches": None, "max_abs_err": path_errs["float32"][out],
            "ms": f32[kern], "device_ms": f32["device_" + kern],
            "plain_ms": f32["plain_" + kern],
            "bound_ms": bound_ms, "bound_by": by, "library_ms": f32[lib],
            # the library's backward is one call for dq, dk and dv together
            "library_call": "scaled_dot_product_attention(is_causal=True)"
                            + ("" if kern == "fwd" else " backward, whole"),
            "bf16_ms": bf16[kern], "bf16_device_ms": bf16["device_" + kern],
            "bf16_bound_ms": bf16_bound_ms,
            "bf16_bound_share": bf16_bound_ms / bf16[kern],
            "bf16_library_ms": bf16[lib],
            "bound_share": bound_ms / f32[kern],
            "bf16_max_abs_err": path_errs["bfloat16"][out],
            "design": F32_DESIGN[kern], "bf16_design": "mma.sync bf16"})
    emit("kernel_vs_plain", kernel="flash_attention",
         shape={"B": b, "H": h, "S": s, "D": d, "causal": True},
         tol={k_: {"rtol": r, "row_floor": f}
              for k_, (r, f) in FLASH_TOL.items()},
         max_abs_err=path_errs, small_shapes=small_errs,
         planted_faults_rejected=True,
         dropout_mask_bit_equal=["float32", "bfloat16"], sass_hmma=hmma,
         sass_hgmma=hgmma,
         ms=times, gflop={k_: w[0] / 1e9 for k_, w in work.items()})
    flash_crossover(dev)
    return rows


def build_causal_lm(fluid, seq, amp, dropout=0.1, n_layer=None):
    """``bench.py``'s ``bench_longseq_train`` program, for the port's
    package; ``amp`` decorates the optimizer as the bench does."""
    from paddle_tpu_torch.models import transformer as tfm

    cfg = dict(LONGCTX, n_layer=n_layer or LONGCTX["n_layer"])
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 7
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        ids = fluid.layers.data("ids", shape=[seq], dtype="int64")
        lbl = fluid.layers.data("lbl", shape=[seq, 1], dtype="int64")
        _, loss = tfm.causal_lm(ids, lbl, max_length=seq,
                                dropout_rate=dropout, **cfg)
        opt = fluid.optimizer.Adam(learning_rate=1e-4)
        if amp:
            opt = fluid.amp.decorate(opt)
        opt.minimize(loss)
    return main, startup, loss


def longctx_feed(batch, seq, seed=0):
    rng = np.random.RandomState(seed)
    vocab = LONGCTX["vocab_size"]
    return {"ids": rng.randint(0, vocab, (batch, seq)).astype("int64"),
            "lbl": rng.randint(0, vocab, (batch, seq, 1)).astype("int64")}


def flash_launches():
    from paddle_tpu_torch.ops.kernels import flash_attention as fa

    return fa.LAUNCHES_FWD, fa.LAUNCHES_DKV, fa.LAUNCHES_DQ


def longctx_train_phase(flash_rows, amp):
    """The causal LM at full width and depth, batch 8 x 2048 tokens, in
    float32 (TF32 off) or under ``fluid.amp.decorate``, on one fixed batch:
    warm-up steps until two in a row agree within 10 % (at least 2, at most
    6; their times on a line of their own), then 6 timed steps, their
    median the step time."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddle_tpu_torch.ops.kernels import softmax_xent as sx

    mode = "bfloat16_amp" if amp else "float32"
    t0 = time.perf_counter()
    main, startup, loss = build_causal_lm(fluid, LONGCTX_SEQ, amp)
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CUDAPlace(0))
    exe.run(startup, scope=scope)
    torch.cuda.synchronize()
    n_weights = sum(int(np.prod(p.shape)) for p in main.all_parameters())
    feed = longctx_feed(LONGCTX_BATCH, LONGCTX_SEQ)
    torch.cuda.reset_peak_memory_stats()
    warm, warm_secs = train_steps(exe, main, loss, feed, scope, 2)
    while (len(warm) < 6 and abs(warm_secs[-1] - warm_secs[-2])
           > 0.1 * min(warm_secs[-2:])):
        lv, sec = train_steps(exe, main, loss, feed, scope, 1)
        warm += lv
        warm_secs += sec
    emit("longctx_warmup", mode=mode, step_ms=[x * 1e3 for x in warm_secs])
    fa.LAUNCHES_FWD = fa.LAUNCHES_DKV = fa.LAUNCHES_DQ = 0
    sx.LAUNCHES_FWD = sx.LAUNCHES_BWD = 0
    losses, secs = train_steps(exe, main, loss, feed, scope, 6)
    k1 = flash_launches()
    k2 = (sx.LAUNCHES_FWD, sx.LAUNCHES_BWD)
    peak = torch.cuda.max_memory_allocated()
    all_losses = warm + losses
    check(bool(np.isfinite(all_losses).all()),
          "non-finite long-context loss (%s): %r" % (mode, all_losses))
    check(all_losses[-1] < all_losses[0],
          "long-context loss did not fall (%s): %r" % (mode, all_losses))
    want = LONGCTX["n_layer"] * len(losses)
    check(k1 == (want, want, want),
          "K1 launches %r over %d steps of %d layers (%s)"
          % (k1, len(losses), LONGCTX["n_layer"], mode))
    check(k2 == (len(losses), len(losses)),
          "K2 launches %r over %d steps (%s)" % (k2, len(losses), mode))
    masters = {str(scope.find_var(p.name).dtype)
               for p in main.all_parameters()}
    check(masters == {"torch.float32"}, "parameters not float32: %r" % masters)
    for row, n in zip(flash_rows, k1):
        row["launches_amp" if amp else "launches"] = n
    step_ms = float(np.median(secs)) * 1e3
    emit("longctx_train", mode=mode, config=LONGCTX, batch=LONGCTX_BATCH,
         seq=LONGCTX_SEQ, weights=n_weights, steps=len(losses),
         step_ms_median=step_ms, step_ms=[x * 1e3 for x in secs],
         tokens_per_s=LONGCTX_BATCH * LONGCTX_SEQ / (step_ms / 1e3),
         peak_memory_bytes=peak, losses=all_losses,
         k1_launches=dict(zip(("fwd", "dkv", "dq"), k1)),
         k2_launches=dict(zip(("fwd", "bwd"), k2)),
         setup_s=time.perf_counter() - t0 - sum(secs))
    train_profile_phase(exe, main, loss, feed, scope,
                        phase="longctx_profile_" + mode)
    if amp:
        per_step = {k: (pat, LONGCTX["n_layer"])
                    for k, pat in K1_NAMES.items()}
        per_step.update({k: (pat, 1) for k, pat in K2_NAMES.items()})
        counts = captured_leg(
            "longctx_captured", main, loss, scope,
            [longctx_feed(LONGCTX_BATCH, LONGCTX_SEQ, seed=i)
             for i in range(CAPTURED_STEPS)], amp, per_step)
        for row, kern in zip(flash_rows, K1_NAMES):
            row.setdefault("captured_launches_a_step", {})[
                "longctx_amp"] = counts[kern]
    del scope, exe
    torch.cuda.empty_cache()


def longctx_parity_phase():
    """The causal LM at full width, 2 layers, batch 1 x 256 tokens, dropout
    0, with the flash route taken from 128 tokens: two steps on the card
    (the kernels) and two on the CPU (their plain versions) from the same
    startup state, in float32 (TF32 off; losses to 1e-4 relative) and
    under AMP (the bfloat16 kernels, the tensor-core K1a/K1c among them;
    losses to 2e-2 relative, the CPU tests' bound for bfloat16 AMP)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.flags import set_flag

    set_flag("flash_attention_min_seq", 128)
    for amp, tol in ((False, 1e-4), (True, 2e-2)):
        main, startup, loss = build_causal_lm(fluid, 256, amp=amp,
                                              dropout=0.0, n_layer=2)
        feed = longctx_feed(1, 256)
        card = fluid.Scope()
        exe = fluid.Executor(fluid.CUDAPlace(0))
        exe.run(startup, scope=card)
        arrays = {n: card.as_numpy(n) for n in card.vars}
        n0 = flash_launches()
        card_losses, _ = train_steps(exe, main, loss, feed, card, 2)
        n1 = flash_launches()
        check(tuple(a - b for a, b in zip(n1, n0)) == (4, 4, 4),
              "the card run launched K1a/K1b/K1c %r -> %r over 2 steps of 2 "
              "layers (amp %s)" % (n0, n1, amp))
        cpu = fluid.io.state_from_numpy(main, arrays, fluid.Scope(),
                                        fluid.CPUPlace())
        cpu_losses, _ = train_steps(fluid.Executor(fluid.CPUPlace()), main,
                                    loss, feed, cpu, 2)
        check(flash_launches() == n1, "the CPU run launched a flash kernel")
        rel = [abs(a - b) / abs(b) for a, b in zip(card_losses, cpu_losses)]
        check(bool(np.isfinite(card_losses + cpu_losses).all())
              and max(rel) <= tol,
              "long-context card %r vs CPU %r losses (rel %r > %g, amp %s)"
              % (card_losses, cpu_losses, rel, tol, amp))
        emit("longctx_parity", mode="bfloat16_amp" if amp else "float32",
             batch=1, seq=256, n_layer=2, dropout=0.0,
             card_losses=card_losses, cpu_losses=cpu_losses, rel_err=rel,
             tol=tol, k1_launches_card=4)
        del card, cpu
    set_flag("flash_attention_min_seq", 2048)
    torch.cuda.empty_cache()


def ctr_feed(batch=None, vocab=None, seed=0):
    """The fixed batch of bench.py's bench_deepfm (batch 1024, V = 1e6 by
    default): RandomState(0) draws the ids, then the dense features, then
    the labels (RandomState(seed) another batch)."""
    batch = batch or CTR_BATCH
    vocab = vocab or CTR["sparse_feature_dim"]
    num_fields = CTR["num_fields"]
    rng = np.random.RandomState(seed)
    return {"ids": rng.randint(0, vocab, (batch, num_fields)).astype("int64"),
            "dense": rng.rand(batch, CTR_DENSE).astype("float32"),
            "label": rng.randint(0, 2, (batch, 1)).astype("int64")}


# the optimizers DeepFM's is_sparse tables train under: Adam (K4a) and SGD
# (K4b), and from PR 15 the rows-only branches of the other four
CTR_OPTIMIZERS = {
    "adam": lambda fluid: fluid.optimizer.Adam(learning_rate=1e-3),
    "sgd": lambda fluid: fluid.optimizer.SGD(learning_rate=1e-3),
    "adagrad": lambda fluid: fluid.optimizer.Adagrad(learning_rate=1e-3),
    "momentum": lambda fluid: fluid.optimizer.Momentum(1e-3, 0.9),
    "proximal_gd": lambda fluid: fluid.optimizer.ProximalGD(
        1e-3, l1_regularization_strength=1e-4),
    "proximal_adagrad": lambda fluid: fluid.optimizer.ProximalAdagrad(
        1e-3, l1_regularization_strength=1e-4),
}


def build_deepfm(fluid, vocab, opt="adam", is_sparse=True):
    """``bench.py``'s ``bench_deepfm`` program, for the port's package, at
    full width; ``opt`` names one of ``CTR_OPTIMIZERS`` ("adam" is the
    bench's Adam(1e-3))."""
    from paddle_tpu_torch.models import deepfm

    cfg = dict(CTR, sparse_feature_dim=vocab)
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        ids = fluid.layers.data("ids", shape=[cfg["num_fields"]],
                                dtype="int64")
        dense = fluid.layers.data("dense", shape=[CTR_DENSE])
        label = fluid.layers.data("label", shape=[1], dtype="int64")
        _, loss, auc = deepfm.deepfm(ids, dense, label, is_sparse=is_sparse,
                                     **cfg)
        CTR_OPTIMIZERS[opt](fluid).minimize(loss)
    return main, startup, loss, auc


def sparse_err(got, want, old):
    """Largest |got - want| / max(|want|, |old|): relative to the larger of
    an element's values after and before the update (the plain version
    stores m + (m_new - m) where the kernel stores m_new, one rounding
    apart, which a value that cancels to near 0 would blow up)."""
    scale = torch.maximum(want.abs(), old.abs()).clamp_min(1e-30)
    return float(((got - want).abs() / scale).max())


def row_sectors(ids, row_bytes):
    """The 32-byte sectors that the rows at ``ids`` span in a table of
    ``row_bytes``-wide rows."""
    start = ids * row_bytes
    return int(((start + row_bytes - 1) // 32 - start // 32 + 1).sum())


def untouched_bit_equal(got, old, touched):
    """Whether every row of a [V, D] table that no id names (``touched``
    False) holds the same bits in ``got`` as in ``old``, -0.0 and NaN
    included; one [V] mask at a time, so a 2 GB table needs no copy."""
    moved = (got.view(torch.int32) != old.view(torch.int32)).any(dim=1)
    return not bool((moved & ~touched).any())


# planted faults: K4a's source with one change each, built beside it
SPARSE_FAULTS = {
    "writes_pad_rows": ("return id >= 0 && id < vocab ? id : -1;",
                        "return id >= 0 && id < vocab ? id : vocab - 1;"),
    "no_one_minus_beta1": ("__fmul_rn(omb1, g)", "g"),
}
# the profiler's names of K4a's and K4b's kernels (and of the parent's)
K4A_KERNEL, K4B_KERNEL = r"sparse_?adam", r"sparse_?sgd"
K4_DESIGN = "D = 10: 8 lanes a row, float2 a lane, the id loaded by lane 0 " \
    "and shuffled; D = 1: one thread a row; every load of a row before " \
    "any arithmetic, no division; table loads as inline PTX: 32 registers, " \
    "so the 832 blocks of the [V, 10] step run in one wave"


def build_sparse_faults():
    """{fault: K4a entry point} of the planted-fault variants, built with
    the kernels' own nvcc flags, one process each, in parallel."""
    import ctypes

    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.ops.kernels import sparse_adam as sa

    src = (_build.SRC_DIR / "sparse_adam.cu").read_text()
    jobs = {}
    for name, (old, new) in SPARSE_FAULTS.items():
        check(src.count(old) == 1, "planted fault %s: its pattern is not in "
              "sparse_adam.cu once" % name)
        cu = _build.BUILD_DIR / ("sparse_adam_fault_%s.cu" % name)
        cu.write_text(src.replace(old, new))
        so = cu.with_suffix(".so")
        jobs[name] = (subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True), so)
    fns = {}
    for name, (proc, so) in jobs.items():
        out, err = proc.communicate()
        check(proc.returncode == 0, "planted fault %s did not build: %s%s"
              % (name, out, err))
        fns[name] = sa.bind(ctypes.CDLL(str(so)))[0]
    return fns


def xent_shape_check(dev, flush, n, v, dtype=torch.float32, seed=1,
                     kernel="softmax_xent_ctr"):
    """K2a/K2b at one loss shape [n, v] without smoothing (DeepFM's
    [1024, 2]; the vision shapes [64, 1000] and [64, 10]): the loss to 1e-5
    relative against the plain version on the same values (bf16 upcasts
    exactly), dlogits to 1e-6 absolute in float32 and in bf16 each element
    to 2e-2·|want| + 1e-6·(max |want| of its row); times beside the byte
    bound, the plain version and ``F.cross_entropy``. K2b's plain version
    runs on K2a's own lse, as K2b does (its inputs are the same), and that
    lse is held to the plain one at 1e-6 relative: at few classes and many
    rows (SSD's [279,424, 21]) a dlogit reaches |g| ~ 5, and the last bit
    of an lse summed in another order moves it by more than 1e-6 (the
    difference from the plain backward on the plain lse is reported as
    ``dlogits_abs_plain_lse``)."""
    from paddle_tpu_torch.ops.kernels import softmax_xent as sx

    F = torch.nn.functional
    rng = np.random.RandomState(seed)
    x = torch.as_tensor((rng.randn(n, v) * 2).astype(np.float32),
                        device=dev).to(dtype)
    lab = torch.as_tensor(rng.randint(0, v, n).astype(np.int64), device=dev)
    g = torch.as_tensor(rng.randn(n, 1).astype(np.float32), device=dev)
    loss, lse = sx.softmax_xent_fwd(x, lab)
    dx = sx.softmax_xent_bwd(x, lab, lse, g)
    torch.cuda.synchronize()
    want_loss, want_lse = sx.softmax_xent_reference(x.float(), lab)
    want_dx = sx.softmax_xent_reference_bwd(x.float(), lab, want_lse, g)
    e_loss = rel_err(loss, want_loss)
    e_dx = float((dx.float() - want_dx).abs().max())
    shape = "[%d, %d] %s" % (n, v, str(dtype).replace("torch.", ""))
    check(e_loss <= 1e-5, "K2a %s loss rel err %g > 1e-5" % (shape, e_loss))
    e_lse = rel_err(lse, want_lse)
    check(e_lse <= 1e-6, "K2a %s lse rel err %g > 1e-6" % (shape, e_lse))
    extra_err = {"lse_rel": e_lse, "dlogits_abs_plain_lse": e_dx}
    want_dx = sx.softmax_xent_reference_bwd(x.float(), lab, lse, g)
    e_dx = float((dx.float() - want_dx).abs().max())
    check(dx.dtype == dtype, "K2b %s dlogits dtype %s" % (shape, dx.dtype))
    if dtype == torch.float32:
        tol = {"loss_rel": 1e-5, "dlogits_abs": 1e-6}
        check(e_dx <= 1e-6, "K2b %s dlogits abs err %g > 1e-6"
              % (shape, e_dx))
        e_scaled = None
    else:
        tol = {"loss_rel": 1e-5, "dlogits_scaled": 1.0}
        e_scaled = scaled_err(dx, want_dx, 2e-2)
        check(e_scaled <= 1, "K2b %s dlogits err %g of its bound"
              % (shape, e_scaled))
    xr = x.detach().requires_grad_(True)
    lib_loss = F.cross_entropy(xr, lab, reduction="none")
    times = {
        "fwd_ms": cuda_ms(lambda: sx.softmax_xent_fwd(x, lab), flush=flush),
        "fwd_device_ms": device_ms(lambda: sx.softmax_xent_fwd(x, lab),
                                   r"xent_fwd_kernel", flush=flush),
        "fwd_plain_ms": cuda_ms(lambda: sx.softmax_xent_reference(x, lab),
                                flush=flush),
        "fwd_library_ms": cuda_ms(lambda: F.cross_entropy(
            x, lab, reduction="none"), flush=flush),
        "bwd_ms": cuda_ms(lambda: sx.softmax_xent_bwd(x, lab, lse, g),
                          flush=flush),
        "bwd_device_ms": device_ms(lambda: sx.softmax_xent_bwd(
            x, lab, lse, g), r"xent_bwd_kernel", flush=flush),
        "bwd_plain_ms": cuda_ms(lambda: sx.softmax_xent_reference_bwd(
            x, lab, lse, g), flush=flush),
        "bwd_library_ms": cuda_ms(lambda: torch.autograd.grad(
            lib_loss, [xr], g.reshape(-1), retain_graph=True), flush=flush)}
    # least bytes: K2a reads the logits and labels and writes loss and lse;
    # K2b reads logits, labels, lse and g and writes dlogits
    nv, elem = n * v, x.element_size()
    times["fwd_bound_ms"] = (elem * nv + 16 * n) / H100_BYTES_PER_S * 1e3
    times["bwd_bound_ms"] = (2 * elem * nv + 16 * n) / H100_BYTES_PER_S * 1e3
    max_err = {"loss_rel": e_loss, "dlogits_abs": e_dx, **extra_err}
    if e_scaled is not None:
        max_err["dlogits_scaled"] = e_scaled
    emit("kernel_vs_plain", kernel=kernel,
         shape={"N": n, "V": v, "smooth": 0.0,
                "dtype": str(dtype).replace("torch.", "")},
         max_err=max_err, tol=tol, **times)
    return dict(times, max_err=max_err)


def sparse_inputs(dev, vocab, d, ids=None):
    """(merged ids, merged rows, (p, m, v), lr_t, lr) of one [vocab, d]
    table: ``ids`` (by default bench_deepfm's batch at that V) merged on the
    card with random gradient rows, random tables (seeded by d), lr_t of
    Adam(1e-3)'s first step, lr·sqrt(1-β2)/(1-β1), and SGD's lr 1e-3, all
    on the card."""
    from paddle_tpu_torch.core.sparse import merge_rows

    if ids is None:
        ids = torch.as_tensor(ctr_feed(vocab=vocab)["ids"].reshape(-1),
                              device=dev)
    gen = torch.Generator(device=dev).manual_seed(d)
    rows = torch.randn(ids.shape[0], d, generator=gen, device=dev)
    uniq, merged = merge_rows(ids, rows, vocab)
    olds = (torch.randn(vocab, d, generator=gen, device=dev) * d ** -0.5,
            torch.randn(vocab, d, generator=gen, device=dev) * 1e-2,
            torch.rand(vocab, d, generator=gen, device=dev) * 1e-4)
    lr_t = torch.tensor([1e-3 * (1 - 0.999) ** 0.5 / (1 - 0.9)], device=dev)
    return uniq, merged, olds, lr_t, torch.tensor([1e-3], device=dev)


def sparse_table_case(dev, vocab, d, ids, faults, flush):
    """K4a/K4b on one [vocab, d] table: the ids merged on the card with
    their padding tail, random gradient rows and tables. Checks: p, m, v
    to 1e-6 of the larger of each element's values after and before; K4b
    bit-equal; every row no id names bit-equal, row V-1 included (only
    padding ids clamp to it); at V = 1e6 the same on table, id and row
    views one element off their alignment, which take the scalar
    instantiation; at d = 10 the planted faults (a kernel that writes
    padding rows, one without the (1-β1) term) must fail. Then the times
    (events and CUPTI) beside bound, plain version and library call."""
    from paddle_tpu_torch.ops.kernels import sparse_adam as sa

    n = ids.shape[0]
    uniq, merged, olds, lr_t, lr = sparse_inputs(dev, vocab, d, ids)
    n_u = int((uniq < vocab).sum())
    valid = uniq[:n_u]
    touched = torch.zeros(vocab, dtype=torch.bool, device=dev)
    touched[valid] = True
    check(n_u < n and bool((uniq[n_u:] == vocab).all()),
          "no padding tail in the merged ids")
    want = sa.sparse_adam_rows_reference(*(t.clone() for t in olds), uniq,
                                         merged, lr_t)
    want_sgd = sa.sparse_sgd_rows_reference(olds[0].clone(), uniq, merged,
                                            lr)
    tag = "K4 [%d, %d]" % (vocab, d)

    def held(got, got_sgd, what):
        errs = {}
        for name, g_, w_, o_ in zip(("p", "m", "v", "p_sgd"),
                                    (*got, got_sgd), (*want, want_sgd),
                                    (*olds, olds[0])):
            e = sparse_err(g_, w_, o_)
            check(e <= 1e-6, "%s%s %s err %g > 1e-6 of max(|after|, "
                  "|before|)" % (tag, what, name, e))
            check(untouched_bit_equal(g_, o_, touched),
                  "%s%s %s: a row no id names moved" % (tag, what, name))
            errs[name] = {"rel": e, "abs": float((g_ - w_).abs().max())}
        check(torch.equal(got_sgd.view(torch.int32),
                          want_sgd.view(torch.int32)),
              "%s%s: K4b is not bit-equal to its plain version" % (tag, what))
        return errs

    a0, s0 = sa.LAUNCHES_ADAM, sa.LAUNCHES_SGD
    got = sa.sparse_adam_rows(*(t.clone() for t in olds), uniq, merged, lr_t)
    got_sgd = sa.sparse_sgd_rows(olds[0].clone(), uniq, merged, lr)
    torch.cuda.synchronize()
    check((sa.LAUNCHES_ADAM - a0, sa.LAUNCHES_SGD - s0) == (1, 1),
          "K4a/K4b launch counters did not move")
    errs = held(got, got_sgd, "")
    width = sa.load_width(got, merged)
    unaligned = None
    if vocab == CTR["sparse_feature_dim"]:
        # views one element off: tables, ids and rows on 4 bytes only

        def off(t):
            flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=dev)
            return flat[1:].view(t.shape).copy_(t)

        views = [off(t) for t in olds]
        u_ids, u_rows = off(uniq), off(merged)
        check(sa.load_width(views, u_rows) == 1,
              "%s: the views one element off are aligned" % tag)
        sa.sparse_adam_rows(*views, u_ids, u_rows, lr_t)
        u_sgd = sa.sparse_sgd_rows(off(olds[0]), u_ids, u_rows, lr)
        torch.cuda.synchronize()
        unaligned = held(views, u_sgd, " (views off alignment)")
        del views, u_ids, u_rows, u_sgd
    faults_rejected = None
    if d == CTR["embedding_size"]:
        args = (uniq, merged, lr_t, n, d, vocab,
                *sa.adam_constants(0.9, 0.999, 1e-8), width)
        bad = [t.clone() for t in olds]
        sa.launch(faults["writes_pad_rows"], dev, *bad, *args)
        torch.cuda.synchronize()
        check(not all(untouched_bit_equal(b, o, touched)
                      for b, o in zip(bad, olds)),
              "the untouched-rows check passes a kernel that writes "
              "padding rows")
        bad = [t.clone() for t in olds]
        sa.launch(faults["no_one_minus_beta1"], dev, *bad, *args)
        torch.cuda.synchronize()
        check(sparse_err(bad[1], want[1], olds[1]) > 1e-6,
              "the check passes a kernel without the (1-β1) term")
        del bad
        faults_rejected = True
    del want, want_sgd, got_sgd
    torch.cuda.empty_cache()

    # times: tables updated in place on every launch, L2 flushed
    p, m, v = got

    def adam():
        sa.sparse_adam_rows(p, m, v, uniq, merged, lr_t)

    def sgd():
        sa.sparse_sgd_rows(p, uniq, merged, lr)

    t = {"ms": cuda_ms(adam, flush=flush),
         "device_ms": device_ms(adam, K4A_KERNEL, flush=flush),
         "plain_ms": cuda_ms(lambda: sa.sparse_adam_rows_reference(
             p, m, v, uniq, merged, lr_t), flush=flush),
         "sgd_ms": cuda_ms(sgd, flush=flush),
         "sgd_device_ms": device_ms(sgd, K4B_KERNEL, flush=flush),
         "sgd_plain_ms": cuda_ms(lambda: sa.sparse_sgd_rows_reference(
             p, uniq, merged, lr), flush=flush)}
    if vocab == CTR["sparse_feature_dim"]:
        dirty = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)
        t["ms_after_write_flush"] = cuda_ms(adam, flush=dirty.zero_)
        del dirty
    # library yardsticks: torch.optim.SparseAdam on the coalesced sparse
    # gradient, index_add_ with alpha = -lr
    del m, v, got
    param = torch.nn.Parameter(p)
    grad = torch.sparse_coo_tensor(valid[None], merged[:n_u], (vocab, d),
                                   check_invariants=False).coalesce()
    opt = torch.optim.SparseAdam([param], lr=1e-3)

    def lib_adam():
        param.grad = grad
        opt.step()

    t["library_ms"] = cuda_ms(lib_adam, flush=flush)
    del param, grad, opt
    torch.cuda.empty_cache()
    t["sgd_library_ms"] = cuda_ms(lambda: p.index_add_(
        0, valid, merged[:n_u], alpha=-1e-3), flush=flush)
    t["sgd_library_device_ms"] = device_ms(lambda: p.index_add_(
        0, valid, merged[:n_u], alpha=-1e-3), r"indexFunc", flush=flush)
    # least work: the ids read once (8 B each) and, per touched element,
    # K4a reads p, m, v, g and writes p, m, v (28 B, ~11 flops), K4b
    # reads p, g and writes p (12 B, 2 flops). The sector count is what
    # the card moves for rows that lie at random: whole 32-byte sectors
    # of p, m, v, the contiguous gradient rows and ids as they are.
    elems = n_u * d
    sectors = row_sectors(valid, 4 * d)
    work = {"adam": (28 * elems + 8 * n, 11 * elems,
                     6 * 32 * sectors + 4 * elems + 8 * n),
            "sgd": (12 * elems + 8 * n, 2 * elems,
                    2 * 32 * sectors + 4 * elems + 8 * n)}
    for k, (nbytes, flops, sbytes) in work.items():
        t_bytes = nbytes / H100_BYTES_PER_S * 1e3
        t_ops = flops / H100_F32_FLOP_PER_S * 1e3
        pre = "" if k == "adam" else "sgd_"
        t[pre + "bound_ms"] = max(t_bytes, t_ops)
        t[pre + "bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        t[pre + "bytes"] = nbytes
        t[pre + "sector_bytes"] = sbytes
        t[pre + "bound_sectors_ms"] = sbytes / H100_BYTES_PER_S * 1e3
    emit("kernel_vs_plain", kernel="sparse_rows",
         shape={"V": vocab, "D": d, "N": n, "distinct_ids": n_u,
                "row_v_minus_1_named": bool(touched[vocab - 1])},
         vector_width=width, max_err=errs,
         unaligned_views_max_err=unaligned,
         tol="1e-6 of max(|after|, |before|); K4b and untouched rows "
         "bit-equal", planted_faults_rejected=faults_rejected, **t)
    del p, olds, touched, uniq, merged
    torch.cuda.empty_cache()
    return dict(t, errs=errs, distinct_ids=n_u)


def sparse_kernel_phase(dev):
    """K4a/K4b against their plain versions at the CTR path's shapes
    (``sparse_table_case``): tables [V, 10] and [V, 1] at V = 1e6 and at
    V = 5e7 (2 GB a [V, 10] table), the ids of bench_deepfm's batch at
    that V (1024 x 26 draws from RandomState(0)); the launch floor; then
    K2a/K2b at [1024, 2]."""
    faults = build_sparse_faults()
    flush = l2_flusher(dev)
    floor = launch_floor_ms(flush)
    emit("launch_floor", ms=floor, launch="torch.cuda._sleep(0)")
    out = {}
    for vocab in (CTR["sparse_feature_dim"], CTR_BIG_V):
        ids = torch.as_tensor(ctr_feed(vocab=vocab)["ids"].reshape(-1),
                              device=dev)
        for table, d in (("emb", CTR["embedding_size"]), ("w1", 1)):
            out[vocab, table] = sparse_table_case(dev, vocab, d, ids, faults,
                                                  flush)
    k2 = xent_shape_check(dev, flush, CTR_BATCH, 2)
    del flush
    torch.cuda.empty_cache()

    def row(name, line, pre, err_key):
        v1, big = CTR["sparse_feature_dim"], CTR_BIG_V
        emb = out[v1, "emb"]
        keys = ("ms", "device_ms", "plain_ms", "bound_ms", "library_ms",
                "library_device_ms", "bound_sectors_ms")

        def times(case):
            return {k: case.get(pre + k) for k in keys}

        return {"name": name, "route": "cuda",
                "source": "paddle_tpu_torch/csrc/sparse_adam.cu",
                "replaces": "paddle_tpu/ops/pallas_kernels/sparse_adam.py:"
                            + line,
                "launches": None,
                "max_abs_err": max(c["errs"][k]["abs"] for c in out.values()
                                   for k in err_key),
                "ms": emb[pre + "ms"], "device_ms": emb[pre + "device_ms"],
                "plain_ms": emb[pre + "plain_ms"],
                "bound_ms": emb[pre + "bound_ms"],
                "bound_by": emb[pre + "bound_by"],
                "library_ms": emb[pre + "library_ms"],
                "library_device_ms": emb.get(pre + "library_device_ms"),
                "library_call": "torch.optim.SparseAdam.step()" if pre == ""
                else "Tensor.index_add_(alpha=-lr)",
                "shape": "[1e6, 10] table, N = %d ids"
                         % (CTR_BATCH * CTR["num_fields"]),
                "design": K4_DESIGN, "launch_floor_ms": floor,
                "bound_sectors_ms": emb[pre + "bound_sectors_ms"],
                **({"ms_after_write_flush": emb["ms_after_write_flush"]}
                   if pre == "" else {}),
                "w1_table": times(out[v1, "w1"]),
                "v5e7": {"emb_table": times(out[big, "emb"]),
                         "w1_table": times(out[big, "w1"])}}

    return [row("sparse_adam_rows", "235", "", ("p", "m", "v")),
            row("sparse_sgd_rows", "301", "sgd_", ("p_sgd",))], k2


def state_bytes(scope):
    return sum(t.numel() * t.element_size() for t in scope.vars.values()
               if isinstance(t, torch.Tensor))


def ctr_run(fluid, vocab, opt="adam", is_sparse=True, warm=2, timed=6,
            profile=None, leg=False):
    """DeepFM at full width through ``Executor.run``: ``warm`` steps, then
    the launch counters set to 0 and ``timed`` steps on one fixed batch, each
    ending with its loss and AUC on the host. Returns the phase's numbers."""
    from paddle_tpu_torch.ops.kernels import softmax_xent as sx
    from paddle_tpu_torch.ops.kernels import sparse_adam as sa

    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    main, startup, loss, auc = build_deepfm(fluid, vocab, opt, is_sparse)
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CUDAPlace(0))
    exe.run(startup, scope=scope)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    feed = ctr_feed(vocab=vocab)
    held = state_bytes(scope)
    losses, aucs, secs = [], [], []
    for i in range(warm + timed):
        if i == warm:
            torch.cuda.reset_peak_memory_stats()
            sa.LAUNCHES_ADAM = sa.LAUNCHES_SGD = 0
            sx.LAUNCHES_FWD = sx.LAUNCHES_BWD = 0
        t1 = time.perf_counter()
        lv, av = exe.run(main, feed=feed, fetch_list=[loss, auc], scope=scope)
        secs.append(time.perf_counter() - t1)
        losses.append(float(lv))
        aucs.append(float(av))
    launches = {"k4a": sa.LAUNCHES_ADAM, "k4b": sa.LAUNCHES_SGD,
                "k2a": sx.LAUNCHES_FWD, "k2b": sx.LAUNCHES_BWD}
    peak = torch.cuda.max_memory_allocated()
    step_ms = float(np.median(secs[warm:])) * 1e3
    res = {"vocab": vocab, "optimizer": opt, "is_sparse": is_sparse,
           "batch": CTR_BATCH, "steps": timed, "step_ms_median": step_ms,
           "step_ms": [x * 1e3 for x in secs[warm:]],
           "examples_per_s": CTR_BATCH / (step_ms / 1e3),
           "peak_memory_bytes": peak, "state_bytes": held,
           "baseline_bytes": base, "peak_minus_state_bytes": peak - held - base,
           "losses": losses, "auc": aucs[-1], "launches": launches,
           "setup_s": setup_s}
    check(bool(np.isfinite(losses).all()), "non-finite DeepFM loss: %r"
          % losses)
    if profile:
        train_profile_phase(exe, main, loss, feed, scope, phase=profile)
    if leg:
        k4 = "K4a" if opt == "adam" else "K4b"
        per_step = {k4: (K4A_KERNEL if opt == "adam" else K4B_KERNEL, 2)}
        per_step.update({k: (pat, 1) for k, pat in K2_NAMES.items()})
        res["captured_launches_a_step"] = captured_leg(
            "ctr_captured", main, loss, scope,
            [ctr_feed(vocab=vocab, seed=i) for i in range(CAPTURED_STEPS)],
            False, per_step)
    del scope, exe
    torch.cuda.empty_cache()
    return res


def ctr_train_phase(k4_rows, xent_rows, k2_ctr):
    """DeepFM at full width (V = 1e6, batch 1024, float32, TF32 off): Adam
    and SGD runs of 2 warm-up and 6 timed steps, the Adam one profiled;
    then the V = 5e7 sparse Adam and SGD steps, which must launch K4a or
    K4b twice a step and allocate no [V, D] gradient, and, as a finding,
    the dense (is_sparse=False) step at both V."""
    import paddle_tpu_torch as fluid

    vocab = CTR["sparse_feature_dim"]
    adam = ctr_run(fluid, vocab, "adam", profile="ctr_profile", leg=True)
    steps = adam["steps"]
    check(adam["losses"][-1] < adam["losses"][0],
          "DeepFM Adam loss did not fall: %r" % adam["losses"])
    check(adam["launches"] == {"k4a": 2 * steps, "k4b": 0, "k2a": steps,
                               "k2b": steps},
          "DeepFM Adam launches %r over %d steps (want K4a 2, K2a/K2b 1 a "
          "step)" % (adam["launches"], steps))
    emit("ctr_train", config=CTR, **adam)
    sgd = ctr_run(fluid, vocab, "sgd", leg=True)
    check(sgd["losses"][-1] < sgd["losses"][0],
          "DeepFM SGD loss did not fall: %r" % sgd["losses"])
    check(sgd["launches"] == {"k4a": 0, "k4b": 2 * steps, "k2a": steps,
                              "k2b": steps},
          "DeepFM SGD launches %r over %d steps (want K4b 2 a step)"
          % (sgd["launches"], steps))
    emit("ctr_train", config=CTR, **sgd)
    # the rows-only Adagrad branch (torch calls, no hand-written kernel):
    # its step allocates no [V, D] gradient, so the peak stays below one
    # [V, D] float32 tensor above the state
    ada = ctr_run(fluid, vocab, "adagrad")
    dense_bytes = vocab * CTR["embedding_size"] * 4
    check(ada["launches"] == {"k4a": 0, "k4b": 0, "k2a": steps,
                              "k2b": steps},
          "DeepFM Adagrad launches %r over %d steps" % (ada["launches"],
                                                        steps))
    check(ada["peak_minus_state_bytes"] < dense_bytes,
          "DeepFM Adagrad step at V = %d: peak %d B is %d B above the "
          "state's %d B, more than one [V, D] tensor (%d B)"
          % (vocab, ada["peak_memory_bytes"], ada["peak_minus_state_bytes"],
             ada["state_bytes"], dense_bytes))
    emit("ctr_train", config=CTR, one_dense_table_bytes=dense_bytes,
         step_ms_adam=adam["step_ms_median"], **ada)
    k4_rows[0]["launches"] = adam["launches"]["k4a"]
    k4_rows[1]["launches"] = sgd["launches"]["k4b"]
    k4_rows[0]["captured_launches_a_step"] = {
        "ctr_adam": adam["captured_launches_a_step"]["K4a"]}
    k4_rows[1]["captured_launches_a_step"] = {
        "ctr_sgd": sgd["captured_launches_a_step"]["K4b"]}
    for row, key, n in zip(xent_rows, ("fwd", "bwd"),
                           (adam["launches"]["k2a"], adam["launches"]["k2b"])):
        row["ctr_shape"] = {"N": CTR_BATCH, "V": 2, "launches": n,
                            **{k.replace(key + "_", ""): v
                               for k, v in k2_ctr.items()
                               if k.startswith(key + "_")}}

    big = ctr_run(fluid, CTR_BIG_V, "adam")
    big_sgd = ctr_run(fluid, CTR_BIG_V, "sgd")
    for run, k4 in ((big, "k4a"), (big_sgd, "k4b")):
        check(run["losses"][-1] < run["losses"][0],
              "V = 5e7 %s loss did not fall: %r" % (run["optimizer"],
                                                    run["losses"]))
        check(run["launches"] == {"k4a": 0, "k4b": 0, "k2a": steps,
                                  "k2b": steps, k4: 2 * steps},
              "V = 5e7 %s launches %r over %d steps"
              % (run["optimizer"], run["launches"], steps))
        check(run["peak_minus_state_bytes"] < 1e9,
              "V = 5e7 sparse %s step: peak %d B is %d B above the state's "
              "%d B (a [V, D] gradient?)"
              % (run["optimizer"], run["peak_memory_bytes"],
                 run["peak_minus_state_bytes"], run["state_bytes"]))
        emit("ctr_train", config=dict(CTR, sparse_feature_dim=CTR_BIG_V),
             step_ms_at_1e6=(adam if k4 == "k4a" else sgd)["step_ms_median"],
             **run)
    k4_rows[0]["launches_v5e7"] = big["launches"]["k4a"]
    k4_rows[1]["launches_v5e7"] = big_sgd["launches"]["k4b"]
    for v in (vocab, CTR_BIG_V):
        dense = ctr_run(fluid, v, "adam", is_sparse=False, timed=4)
        emit("ctr_train_dense", config=dict(CTR, sparse_feature_dim=v),
             sparse_step_ms=(adam if v == vocab else big)["step_ms_median"],
             **dense)


CTR_PARITY_OPTIMIZERS = ("adam", "adagrad", "momentum", "proximal_gd",
                         "proximal_adagrad")


def ctr_parity_phase():
    """DeepFM at full width but V = 1e4, batch 64, for each of
    ``CTR_PARITY_OPTIMIZERS`` (every one at a rate of 1e-3): four steps on
    the card (K4a under Adam, the rows-only branches of the others) and
    four on the CPU (their plain versions) from one CPU startup. Losses to
    1e-5 relative; every parameter to 1e-5 absolute and relative, the other
    state (Adam's moments span many decades) to 1e-5 relative plus 1e-5 of
    its largest |value|; the AUC histograms, whose bucket is floor(4096·p),
    as counts: the same totals, each cumulative count within 2 (a
    probability the devices round to either side of a bucket edge moves
    one count to the next bucket)."""
    for opt in CTR_PARITY_OPTIMIZERS:
        ctr_parity_run(opt)


def ctr_parity_run(opt):
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.ops.kernels import sparse_adam as sa

    vocab, batch = 10_000, 64
    main, startup, loss, _ = build_deepfm(fluid, vocab, opt)
    init = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=init)
    arrays = {n: init.as_numpy(n) for n in init.vars}
    feed = ctr_feed(batch, vocab)
    card = fluid.io.state_from_numpy(main, arrays, fluid.Scope(),
                                     fluid.CUDAPlace(0))
    k4 = 8 if opt == "adam" else 0
    a0 = sa.LAUNCHES_ADAM
    card_losses, _ = train_steps(fluid.Executor(fluid.CUDAPlace(0)), main,
                                 loss, feed, card, 4)
    check(sa.LAUNCHES_ADAM - a0 == k4,
          "the card run (%s) launched K4a %d times over 4 steps, want %d"
          % (opt, sa.LAUNCHES_ADAM - a0, k4))
    cpu = fluid.io.state_from_numpy(main, arrays, fluid.Scope(),
                                    fluid.CPUPlace())
    cpu_losses, _ = train_steps(fluid.Executor(fluid.CPUPlace()), main, loss,
                                feed, cpu, 4)
    check(sa.LAUNCHES_ADAM - a0 == k4, "the CPU run launched K4a")
    rel = [abs(a - b) / abs(b) for a, b in zip(card_losses, cpu_losses)]
    check(bool(np.isfinite(card_losses + cpu_losses).all())
          and max(rel) <= 1e-5,
          "DeepFM (%s) card %r vs CPU %r losses (rel %r > 1e-5)"
          % (opt, card_losses, cpu_losses, rel))
    params = {p.name for p in main.all_parameters()}
    worst, hist, bad = {}, {}, []
    for n in sorted(arrays):
        a, b = card.as_numpy(n), cpu.as_numpy(n)
        if n.startswith("auc_stat"):
            hist[n] = int(np.abs(np.cumsum(a) - np.cumsum(b)).max())
            if a.sum() != b.sum() or hist[n] > 2:
                bad.append(n)
            continue
        # a parameter within 1e-5 absolute (+ 1e-5 relative): 1 % of an
        # Adam step (lr 1e-3), which moves a weight by up to lr whatever the
        # size of its gradient, so a gradient that cancels to near 0 moves
        # it by another share of lr on each device (Adagrad's first step
        # moves it by lr too). Other state (moments, accumulators, beta
        # pows) within 1e-5 relative + 1e-5 of its largest |value|.
        atol = 1e-5 if n in params else 1e-5 * float(np.abs(b).max())
        err = float((np.abs(a - b) / np.maximum(
            1e-5 * np.abs(b) + atol, 1e-30)).max())
        worst[n] = err
        if err > 1:
            bad.append(n)
    top = max(worst, key=worst.get)
    tables = [n for n in params if arrays[n].shape[0] == vocab]
    moved = {n: int((card.as_numpy(n) != arrays[n]).any(axis=1).sum())
             for n in tables}
    emit("ctr_parity", optimizer=opt, vocab=vocab, batch=batch,
         card_losses=card_losses, cpu_losses=cpu_losses, rel_err=rel,
         tol=1e-5, k4a_launches_card=k4, persistables=len(arrays),
         worst_state=top, worst_state_of_bound=worst[top],
         state_of_bound={n: e for n, e in worst.items() if e > 0.01},
         auc_cumulative_moved=hist, table_rows_moved=moved)
    check(not bad, "card vs CPU state (%s) beyond its bound: %s"
          % (opt, {n: worst.get(n, hist.get(n)) for n in bad}))
    n_ids = len(np.unique(feed["ids"]))
    check(all(0 < m <= n_ids for m in moved.values()),
          "DeepFM (%s): table rows moved %r, the batch names %d ids"
          % (opt, moved, n_ids))
    del card, cpu
    torch.cuda.empty_cache()


def build_resnet(fluid, amp, depth=50, image=RESNET_IMAGE,
                 classes=RESNET_CLASSES, dataset="imagenet", lr=0.1,
                 lars=False):
    """``bench.py``'s ``bench_resnet50`` program for the port's package
    (Momentum(0.1, 0.9); ``amp`` decorates the optimizer as the bench
    does), or at another depth, size and learning rate; ``lars`` trains
    it under ``LarsMomentumOptimizer(lr, 0.9)`` instead."""
    from paddle_tpu_torch.models import resnet as rn

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        img = fluid.layers.data("img", shape=[3, image, image])
        label = fluid.layers.data("label", shape=[1], dtype="int64")
        _, loss, acc = rn.resnet(img, label, depth=depth, class_num=classes,
                                 dataset=dataset)
        opt = (fluid.optimizer.LarsMomentumOptimizer if lars
               else fluid.optimizer.Momentum)(lr, 0.9)
        if amp:
            opt = fluid.amp.decorate(opt)
        opt.minimize(loss)
    return main, startup, loss, acc


def resnet_feed(batch, image=RESNET_IMAGE, classes=RESNET_CLASSES, seed=0):
    """The fixed batch of bench.py's bench_resnet50: RandomState(0) draws
    the images (randn), then the labels (RandomState(seed) another
    batch)."""
    rng = np.random.RandomState(seed)
    return {"img": rng.randn(batch, 3, image, image).astype("float32"),
            "label": rng.randint(0, classes, (batch, 1)).astype("int64")}


def forward_flops(main, batch):
    """FLOPs of a program's forward convolutions and products, from their
    vars' shapes: 2·N·C_out·H_out·W_out·(C_in/g)·k_h·k_w a conv2d (the
    filter is [C_out, C_in/g, k_h, k_w]), 2·N·K·M a mul."""
    blk = main.global_block
    total = 0
    for op in blk.ops:
        if op.type == "backward_marker":
            break
        if op.type == "conv2d":
            co, ci, kh, kw = blk.var(op.inputs["Filter"][0]).shape
            out = blk.var(op.outputs["Output"][0]).shape
            h, w = out[1:3] if op.attrs.get("data_format") == "NHWC" \
                else out[2:]
            total += 2 * batch * co * h * w * ci * kh * kw
        elif op.type == "mul":
            k, m = blk.var(op.inputs["Y"][0]).shape
            total += 2 * batch * k * m
    return total


def resnet_train_phase(xent_rows, amp):
    """ResNet-50 at full width and depth as bench_resnet50 trains it
    (batch 64 x 3 x 224 x 224, 1000 classes, Momentum(0.1, 0.9)), in
    float32 (TF32 off) or under ``fluid.amp.decorate``, on the bench's
    fixed batch with cuDNN's algorithm search on: 2 warm-up steps, then 6
    timed ones, their median the step time. Each step must launch K2a and
    K2b once, every loss be finite, and the first step descend. (The
    bench's lr overshoots one fixed batch: the loss climbs past its start
    for several steps after the first, in the JAX package too, which
    ``tests/test_torch_resnet.py`` pins on the CPU.)"""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.ops.kernels import softmax_xent as sx

    mode = "bfloat16_amp" if amp else "float32"
    prev = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = True
    t0 = time.perf_counter()
    main, startup, loss, _ = build_resnet(fluid, amp)
    build_s = time.perf_counter() - t0
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CUDAPlace(0))
    exe.run(startup, scope=scope)
    torch.cuda.synchronize()
    params = main.all_parameters()
    ops = [op.type for op in main.global_block.ops]
    flop = 3 * forward_flops(main, RESNET_BATCH)
    bound_ms = flop / (H100_BF16_FLOP_PER_S if amp
                       else H100_F32_FLOP_PER_S) * 1e3
    feed = resnet_feed(RESNET_BATCH)
    warm, warm_secs = train_steps(exe, main, loss, feed, scope, 2)
    torch.cuda.reset_peak_memory_stats()
    sx.LAUNCHES_FWD = sx.LAUNCHES_BWD = 0
    losses, secs = train_steps(exe, main, loss, feed, scope, 6)
    k2 = (sx.LAUNCHES_FWD, sx.LAUNCHES_BWD)
    peak = torch.cuda.max_memory_allocated()
    all_losses = warm + losses
    state = {str(scope.find_var(v.name).dtype) for v in main.list_vars()
             if v.persistable and v.dtype == "float32"}
    step_ms = float(np.median(secs)) * 1e3
    emit("resnet_train", mode=mode, depth=50, batch=RESNET_BATCH,
         image=RESNET_IMAGE, classes=RESNET_CLASSES, optimizer="Momentum",
         lr=0.1, momentum=0.9, params=len(params),
         weights=sum(int(np.prod(p.shape)) for p in params), ops=len(ops),
         conv2d=ops.count("conv2d"), batch_norm=ops.count("batch_norm"),
         cudnn_benchmark=torch.backends.cudnn.benchmark,
         tf32=torch.backends.cudnn.allow_tf32, build_s=build_s,
         warm_ms=[x * 1e3 for x in warm_secs], steps=len(losses),
         step_ms_median=step_ms, step_ms=[x * 1e3 for x in secs],
         images_per_s=RESNET_BATCH / (step_ms / 1e3),
         peak_memory_bytes=peak, train_flop=flop,
         compute_bound_ms=bound_ms, compute_bound_share=bound_ms / step_ms,
         losses=all_losses, k2_launches={"fwd": k2[0], "bwd": k2[1]})
    check(bool(np.isfinite(all_losses).all()),
          "non-finite ResNet-50 loss (%s): %r" % (mode, all_losses))
    check(all_losses[1] < all_losses[0],
          "ResNet-50's first step did not descend (%s): %r"
          % (mode, all_losses))
    check(k2 == (len(losses), len(losses)),
          "K2 launches %r over %d ResNet-50 steps (%s)"
          % (k2, len(losses), mode))
    check(state == {"torch.float32"},
          "parameters or moving statistics not float32: %r" % state)
    key = vision_key(RESNET_BATCH, RESNET_CLASSES,
                     torch.bfloat16 if amp else torch.float32)
    for row, n in zip(xent_rows, k2):
        row["vision_shapes"][key]["launches"] = n
    train_profile_phase(exe, main, loss, feed, scope,
                        phase="resnet_profile_" + mode, groups=RESNET_GROUPS)
    if amp:
        counts = captured_leg(
            "resnet_captured", main, loss, scope,
            [resnet_feed(RESNET_BATCH, seed=i)
             for i in range(CAPTURED_STEPS)], amp,
            {k: (pat, 1) for k, pat in K2_NAMES.items()})
        for row, kern in zip(xent_rows, K2_NAMES):
            row.setdefault("captured_launches_a_step", {})[
                "resnet_amp"] = counts[kern]
    torch.backends.cudnn.benchmark = prev
    del scope, exe
    torch.cuda.empty_cache()


def norm_err(got, want, base=0.0):
    """||got - want|| / ||want - base||, in float64."""
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(np.asarray(got, np.float64) - want)
                 / max(np.linalg.norm(want - base), 1e-30))


def maxpool_tie_check(dev, dtype):
    """ResNet-50's stem pool (3 x 3, stride 2, padding 1) on a post-ReLU
    [64, 64, 112, 112] activation with a 16 x 16 patch of zeros in every
    plane: do the card and the CPU pick the same element of a window that
    ties? The port's pool2d op is ``F.max_pool2d``; its indices say where
    the backward routes each window's gradient."""
    F = torch.nn.functional
    rng = np.random.RandomState(5)
    x = torch.relu(torch.as_tensor(rng.randn(RESNET_BATCH, 64, 112, 112)
                                   .astype(np.float32))).to(dtype)
    x[..., :16, :16] = 0
    g = torch.as_tensor(rng.randn(RESNET_BATCH, 64, 56, 56)
                        .astype(np.float32)).to(dtype)
    outs = []
    for d in (dev, torch.device("cpu")):
        xd = x.to(d).requires_grad_(True)
        out, idx = F.max_pool2d(xd, 3, 2, 1, return_indices=True)
        dx, = torch.autograd.grad(F.max_pool2d(xd, 3, 2, 1), [xd], g.to(d))
        outs.append((out.detach().cpu(), idx.cpu(), dx.cpu()))
    (out_c, idx_c, dx_c), (out_h, idx_h, dx_h) = outs
    # windows whose maximum appears more than once (the first 4 images)
    win = F.unfold(x[:4].float().reshape(-1, 1, 112, 112), 3, padding=1,
                   stride=2)
    win = torch.where(F.unfold(torch.ones(1, 1, 112, 112), 3, padding=1,
                               stride=2).bool(), win, -1.0)
    tied = int(((win == win.amax(dim=1, keepdim=True)).sum(dim=1) > 1).sum())
    return {"dtype": str(dtype).replace("torch.", ""),
            "tied_windows_first_4_images": tied,
            "windows_first_4_images": int(win.shape[0] * win.shape[2]),
            "same_output": bool(torch.equal(out_c, out_h)),
            "same_indices": bool(torch.equal(idx_c, idx_h)),
            "grad_max_abs_diff": float((dx_c.float() - dx_h.float()).abs()
                                       .max())}


def resnet_parity_phase():
    """The card against the CPU on one program at test size, cuDNN's
    algorithms deterministic, TF32 off, from one CPU startup carried by
    ``io.state_from_numpy``:

    * the stem's max pool on a tie-laden activation (``maxpool_tie_check``)
      in float32 and bfloat16: the same outputs and indices, so the same
      element takes each window's gradient;
    * ``resnet_cifar10`` (depth 18: basic blocks, 3 x 3 stem) at 32 x 32,
      batch 8, 10 classes, Momentum(1e-3, 0.9), 3 steps. float32: losses
      to 1e-4 relative; moving statistics (norm-wise per variable) to 5e-4;
      each parameter's update over the 3 steps and each velocity norm-wise
      to 5e-2 (the CPU tests' port-vs-JAX bounds: batch-norm bias
      gradients are sums that cancel to near 0). AMP: losses, moving
      statistics and all parameters together to 2e-2;
    * ResNet-50 (bottleneck blocks, 7 x 7 stem, max pool) at 64 x 64,
      batch 8: the first step's loss to 1e-4."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.ops.kernels import softmax_xent as sx

    prev = torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    dev = torch.device("cuda", torch.cuda.current_device())
    pools = [maxpool_tie_check(dev, dt)
             for dt in (torch.float32, torch.bfloat16)]
    for p in pools:
        check(p["same_output"] and p["same_indices"],
              "max pool card vs CPU differ on ties: %r" % p)
    emit("resnet_parity_maxpool", shape=[RESNET_BATCH, 64, 112, 112],
         ksize=3, stride=2, padding=1, results=pools)

    def both(main, startup, loss, feed, steps):
        init = fluid.Scope()
        fluid.Executor(fluid.CPUPlace()).run(startup, scope=init)
        arrays = {n: init.as_numpy(n) for n in init.vars}
        card = fluid.io.state_from_numpy(main, arrays, fluid.Scope(),
                                         fluid.CUDAPlace(0))
        f0, b0 = sx.LAUNCHES_FWD, sx.LAUNCHES_BWD
        card_losses, _ = train_steps(fluid.Executor(fluid.CUDAPlace(0)), main,
                                     loss, feed, card, steps)
        n = (sx.LAUNCHES_FWD - f0, sx.LAUNCHES_BWD - b0)
        check(n == (steps, steps), "the card run launched K2 %r times over "
              "%d steps" % (n, steps))
        cpu = fluid.io.state_from_numpy(main, arrays, fluid.Scope(),
                                        fluid.CPUPlace())
        cpu_losses, _ = train_steps(fluid.Executor(fluid.CPUPlace()), main,
                                    loss, feed, cpu, steps)
        check((sx.LAUNCHES_FWD - f0, sx.LAUNCHES_BWD - b0) == n,
              "the CPU run launched K2")
        rel = [abs(a - b) / abs(b) for a, b in zip(card_losses, cpu_losses)]
        check(bool(np.isfinite(card_losses + cpu_losses).all()),
              "non-finite parity loss: %r %r" % (card_losses, cpu_losses))
        return arrays, card, cpu, card_losses, cpu_losses, rel

    feed = resnet_feed(8, 32, 10)
    for amp in (False, True):
        mode = "bfloat16_amp" if amp else "float32"
        main, startup, loss, _ = build_resnet(fluid, amp, depth=18, image=32,
                                              classes=10, dataset="cifar10",
                                              lr=1e-3)
        arrays, card, cpu, cl, hl, rel = both(main, startup, loss, feed, 3)
        params = {p.name for p in main.all_parameters()}
        errs = {"stat": 0.0, "update": 0.0, "velocity": 0.0}
        got_p, want_p = [], []
        for v in main.list_vars():
            if not v.persistable or v.name.startswith("learning_rate"):
                continue
            a, b = card.as_numpy(v.name), cpu.as_numpy(v.name)
            if v.name in params:
                kind, base = "update", arrays[v.name]
                got_p.append(a.ravel())
                want_p.append(b.ravel())
            else:
                kind = "velocity" if "_velocity" in v.name else "stat"
                base = 0.0
            errs[kind] = max(errs[kind], norm_err(a, b, base))
        errs["params_together"] = norm_err(np.concatenate(got_p),
                                           np.concatenate(want_p))
        tol = ({"loss_rel": 2e-2, "stat": 2e-2, "params_together": 2e-2}
               if amp else {"loss_rel": 1e-4, "stat": 5e-4, "update": 5e-2,
                            "velocity": 5e-2})
        emit("resnet_parity", mode=mode, model="resnet_cifar10 depth 18",
             image=32, batch=8, classes=10, lr=1e-3, steps=3,
             card_losses=cl, cpu_losses=hl, rel_err=rel, state_err=errs,
             tol=tol, cudnn_deterministic=True)
        check(max(rel) <= tol["loss_rel"], "ResNet-18 card %r vs CPU %r "
              "losses (rel %r, %s)" % (cl, hl, rel, mode))
        bad = {k: e for k, e in errs.items() if e > tol.get(k, np.inf)}
        check(not bad, "ResNet-18 card vs CPU state beyond its bound (%s): "
              "%r" % (mode, bad))
        del card, cpu

    main, startup, loss, _ = build_resnet(fluid, False, image=64, classes=10)
    _, card, cpu, cl, hl, rel = both(main, startup, loss,
                                     resnet_feed(8, 64, 10), 1)
    emit("resnet_parity", mode="float32", model="resnet50", image=64, batch=8,
         classes=10, steps=1, card_losses=cl, cpu_losses=hl, rel_err=rel,
         tol={"loss_rel": 1e-4})
    check(rel[0] <= 1e-4, "ResNet-50 first loss card %r vs CPU %r" % (cl, hl))
    del card, cpu
    torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic = prev
    torch.cuda.empty_cache()


def mnist_data(n=512):
    """The synthetic separable clusters of tests/test_mnist_mlp.py at
    MNIST's 784 pixels: RandomState(0) draws 10 centres (x3), then the
    labels, then the noise (x0.5)."""
    rng = np.random.RandomState(0)
    centers = rng.randn(MNIST_CLASSES, MNIST_DIM).astype("float32") * 3.0
    ys = rng.randint(0, MNIST_CLASSES, size=n)
    xs = centers[ys] + rng.randn(n, MNIST_DIM).astype("float32") * 0.5
    return xs.astype("float32"), ys.reshape(n, 1).astype("int64")


# (model, optimizer, learning rate): SGD at test_mnist_mlp.py's rate for the
# MLP; its Momentum rate (0.05, for 64 features) took the MLP to NaN on
# 784 pixels of standard deviation 3 on the card, so a tenth of it;
# LeNet-5's convolutions see the same pixels and take a hundredth
MNIST_RUNS = (("mlp", "momentum", 0.005), ("mlp", "sgd", 0.1),
              ("lenet5", "momentum", 5e-4), ("lenet5", "sgd", 1e-3))


def mnist_train_phase(xent_rows, epochs=4):
    """``models.mnist.mlp`` (784-200-200-10) and ``lenet5`` (1 x 28 x 28)
    on the card under Momentum and SGD, batch 64, ``epochs`` epochs over
    512 cluster examples. Each step must launch K2a and K2b once at
    [64, 10], the mean loss of the last epoch lie below the first loss,
    and the mean accuracy of the last epoch exceed 0.9."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import mnist
    from paddle_tpu_torch.ops.kernels import softmax_xent as sx

    xs, ys = mnist_data()
    per_epoch = len(xs) // MNIST_BATCH
    launches = [0, 0]
    for model, opt, lr in MNIST_RUNS:
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup), fluid.unique_name.guard():
            img = fluid.layers.data(
                "img", shape=[MNIST_DIM] if model == "mlp" else [1, 28, 28])
            label = fluid.layers.data("label", shape=[1], dtype="int64")
            _, loss, acc = getattr(mnist, model)(img, label)
            (fluid.optimizer.SGD(lr) if opt == "sgd"
             else fluid.optimizer.Momentum(lr, 0.9)).minimize(loss)
        scope = fluid.Scope()
        exe = fluid.Executor(fluid.CUDAPlace(0))
        exe.run(startup, scope=scope)
        images = xs if model == "mlp" else xs.reshape(-1, 1, 28, 28)
        sx.LAUNCHES_FWD = sx.LAUNCHES_BWD = 0
        losses, accs, secs = [], [], []
        for _ in range(epochs):
            for i in range(0, len(xs), MNIST_BATCH):
                t0 = time.perf_counter()
                lv, av = exe.run(main, feed={
                    "img": images[i:i + MNIST_BATCH],
                    "label": ys[i:i + MNIST_BATCH]},
                    fetch_list=[loss, acc], scope=scope)
                secs.append(time.perf_counter() - t0)
                losses.append(float(lv))
                accs.append(float(av))
        k2 = (sx.LAUNCHES_FWD, sx.LAUNCHES_BWD)
        last_loss = float(np.mean(losses[-per_epoch:]))
        last_acc = float(np.mean(accs[-per_epoch:]))
        step_ms = float(np.median(secs[per_epoch:])) * 1e3
        emit("mnist_train", model=model, optimizer=opt, lr=lr,
             batch=MNIST_BATCH, epochs=epochs, steps=len(losses),
             first_loss=losses[0], last_epoch_loss=last_loss,
             last_epoch_accuracy=last_acc, step_ms_median=step_ms,
             images_per_s=MNIST_BATCH / (step_ms / 1e3),
             k2_launches={"fwd": k2[0], "bwd": k2[1]})
        check(k2 == (len(losses), len(losses)), "%s/%s K2 launches %r over "
              "%d steps" % (model, opt, k2, len(losses)))
        check(bool(np.isfinite(losses).all()) and last_loss < losses[0],
              "%s/%s loss did not fall: first %g, last epoch %g"
              % (model, opt, losses[0], last_loss))
        check(last_acc > 0.9, "%s/%s last-epoch accuracy %g <= 0.9"
              % (model, opt, last_acc))
        launches = [a + b for a, b in zip(launches, k2)]
        del scope, exe
    key = vision_key(MNIST_BATCH, MNIST_CLASSES, torch.float32)
    for row, n in zip(xent_rows, launches):
        row["vision_shapes"][key]["launches"] = n
    book = {}
    for level in ("1", "0"):
        book[level] = mnist_book_form(xs, ys, level, epochs)
    for i, row in enumerate(xent_rows):
        row["vision_shapes"][key]["launches_book_form"] = {
            "level_" + lv: b["k2_launches"][i] for lv, b in book.items()}


def mnist_book_form(xs, ys, level, epochs, lr=0.1):
    """The MNIST MLP as Fluid's book writes it
    (``tests/book/test_recognize_digits.py``): ``prediction = fc(size=10,
    act="softmax")``, ``mean(cross_entropy(prediction, label))`` and
    ``accuracy(prediction, label)``, SGD, at ``PADDLE_TPU_OPT_LEVEL``
    ``level``. At 1 ``softmax_xent_fuse_pass`` fuses the loss on the
    logits (the softmax stays for ``accuracy``), so K2a and K2b launch once
    a step at [64, 10]; at 0 they never launch. Either must train to an
    accuracy above 0.9."""
    import os

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.ops.kernels import softmax_xent as sx

    prev = os.environ.get("PADDLE_TPU_OPT_LEVEL")
    os.environ["PADDLE_TPU_OPT_LEVEL"] = level
    try:
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup), fluid.unique_name.guard():
            img = fluid.layers.data("img", shape=[MNIST_DIM])
            label = fluid.layers.data("label", shape=[1], dtype="int64")
            h = img
            for size in (200, 200):
                h = fluid.layers.fc(h, size=size, act="relu")
            prediction = fluid.layers.fc(h, size=MNIST_CLASSES,
                                         act="softmax")
            loss = fluid.layers.mean(
                fluid.layers.cross_entropy(prediction, label))
            acc = fluid.layers.accuracy(prediction, label)
            fluid.optimizer.SGD(lr).minimize(loss)
        scope = fluid.Scope()
        exe = fluid.Executor(fluid.CUDAPlace(0))
        exe.run(startup, scope=scope)
        opt = exe._maybe_optimize(main, (loss.name, acc.name), scope)
        sx.LAUNCHES_FWD = sx.LAUNCHES_BWD = 0
        losses, accs = [], []
        for _ in range(epochs):
            for i in range(0, len(xs), MNIST_BATCH):
                lv, av = exe.run(main, feed={
                    "img": xs[i:i + MNIST_BATCH],
                    "label": ys[i:i + MNIST_BATCH]},
                    fetch_list=[loss, acc], scope=scope)
                losses.append(float(lv))
                accs.append(float(av))
        k2 = (sx.LAUNCHES_FWD, sx.LAUNCHES_BWD)
    finally:
        if prev is None:
            os.environ.pop("PADDLE_TPU_OPT_LEVEL", None)
        else:
            os.environ["PADDLE_TPU_OPT_LEVEL"] = prev
    per_epoch = len(xs) // MNIST_BATCH
    last_acc = float(np.mean(accs[-per_epoch:]))
    want = len(losses) if level == "1" else 0
    ops = [op.type for op in opt.global_block.ops]
    check(k2 == (want, want), "mnist book form at level %s: K2 launches %r "
          "over %d steps, want %d" % (level, k2, len(losses), want))
    check(bool(np.isfinite(losses).all()) and last_acc > 0.9,
          "mnist book form at level %s: last-epoch accuracy %g"
          % (level, last_acc))
    out = {"level": level, "steps": len(losses), "first_loss": losses[0],
           "last_epoch_loss": float(np.mean(losses[-per_epoch:])),
           "last_epoch_accuracy": last_acc, "k2_launches": list(k2),
           "ops_level0": len(main.global_block.ops), "ops_run": len(ops),
           "softmax_ops": ops.count("softmax"),
           "fused_loss_ops": ops.count("softmax_with_cross_entropy")}
    emit("mnist_book_form", **out)
    del scope, exe
    return out


def bert_train_flop(batch, seq=BERT_SEQ, n_mask=BERT_MASK, vocab=BERT_VOCAB,
                    n_layer=12, d=768, di=3072):
    """A pretraining step's FLOPs as ``bench.py:617``
    ``_bert_train_flops_per_example`` counts them (the forward's products,
    times 3), for ``batch`` sequences."""
    enc = n_layer * (8 * seq * d * d + 4 * seq * seq * d + 4 * seq * d * di)
    heads = n_mask * (2 * d * d + 2 * d * vocab)
    return 3 * (enc + heads) * batch


def bert_fwd_flop(batch, seq=BERT_INFER_SEQ, n_layer=12, d=768, di=3072):
    """An encoder forward's FLOPs as ``bench.py:865``
    ``_bert_fwd_flops_per_example`` counts them, for ``batch`` sequences."""
    return n_layer * (8 * seq * d * d + 4 * seq * seq * d
                      + 4 * seq * d * di) * batch


def build_bert(fluid, amp, n_layer=None, dropout=None, optimizer=None):
    """``bench.py``'s ``bench_bert`` program for the port's package:
    ``BERT_BASE_CONFIG`` (or ``n_layer`` layers of it), MLM + NSP losses,
    Adam(1e-4) (or ``optimizer(fluid)``, called inside the program guard
    after the losses), decorated by ``fluid.amp.decorate`` when ``amp``;
    dropout 0.1 unless given."""
    from paddle_tpu_torch.models import bert

    cfg = dict(bert.BERT_BASE_CONFIG)
    if n_layer is not None:
        cfg["n_layer"] = n_layer
    if dropout is not None:
        cfg["dropout_rate"] = dropout
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        ids = fluid.layers.data("ids", shape=[BERT_SEQ], dtype="int64")
        pos = fluid.layers.data("pos", shape=[BERT_SEQ], dtype="int64")
        sent = fluid.layers.data("sent", shape=[BERT_SEQ], dtype="int64")
        mask = fluid.layers.data("mask", shape=[BERT_SEQ], dtype="float32")
        mpos = fluid.layers.data("mpos", shape=[BERT_MASK], dtype="int64")
        mlbl = fluid.layers.data("mlbl", shape=[1], dtype="int64")
        nsp = fluid.layers.data("nsp", shape=[1], dtype="int64")
        loss, _, _ = bert.bert_pretrain(ids, pos, sent, mask, mpos, mlbl, nsp,
                                        **cfg)
        opt = fluid.optimizer.Adam(learning_rate=1e-4) if optimizer is None \
            else optimizer(fluid)
        if amp:
            opt = fluid.amp.decorate(opt)
        opt.minimize(loss)
    return main, startup, loss


def bert_feed(batch, dev=None, seed=0):
    """The fixed batch of bench.py's bench_bert: RandomState(0) draws the
    masked positions (flat indices into [batch * seq]; a row may repeat
    one), then the ids, the MLM labels and the NSP labels (RandomState(seed)
    another batch). On ``dev`` as tensors, as the bench places its feed on
    the device once."""
    rng = np.random.RandomState(seed)
    mpos = (np.arange(batch)[:, None] * BERT_SEQ
            + rng.randint(0, BERT_SEQ, (batch, BERT_MASK))).astype("int64")
    feed = {
        "ids": rng.randint(0, BERT_VOCAB, (batch, BERT_SEQ)).astype("int64"),
        "pos": np.tile(np.arange(BERT_SEQ), (batch, 1)).astype("int64"),
        "sent": np.zeros((batch, BERT_SEQ), "int64"),
        "mask": np.ones((batch, BERT_SEQ), "float32"),
        "mpos": mpos,
        "mlbl": rng.randint(0, BERT_VOCAB,
                            (batch * BERT_MASK, 1)).astype("int64"),
        "nsp": rng.randint(0, 2, (batch, 1)).astype("int64"),
    }
    if dev is None:
        return feed
    return {k: torch.as_tensor(v, device=dev) for k, v in feed.items()}


def bert_train_phase(xent_rows, amp, ckpt_dir=None):
    """BERT-base pretraining at full width and depth as bench_bert trains
    it (batch 32 x 128, 20 masked positions, dropout 0.1, Adam(1e-4)), in
    float32 (TF32 off) or under ``fluid.amp.decorate``: 2 warm-up steps,
    then 6 timed steps on the bench's fixed batch, their median the step
    time. Each step must launch K2a and K2b once at each of the MLM loss's
    [640, 30522] and the NSP loss's [32, 2], in the leg's dtype (counted
    by shape at the launch), every loss be finite and the last below the
    first, the master weights stay float32. With ``ckpt_dir`` the
    parameters are saved there by ``io.save_params``."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.ops.kernels import softmax_xent as sx

    mode = "bfloat16_amp" if amp else "float32"
    t0 = time.perf_counter()
    main, startup, loss = build_bert(fluid, amp)
    build_s = time.perf_counter() - t0
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CUDAPlace(0))
    exe.run(startup, scope=scope)
    torch.cuda.synchronize()
    params = main.all_parameters()
    n_weights = sum(int(np.prod(p.shape)) for p in params)
    check(n_weights == 133_510_460, "BERT-base has %d weights" % n_weights)
    ops = [op.type for op in main.global_block.ops]
    feed = bert_feed(BERT_BATCH, exe.place)
    warm, warm_secs = train_steps(exe, main, loss, feed, scope, 2)
    torch.cuda.reset_peak_memory_stats()
    sx.LAUNCHES_FWD = sx.LAUNCHES_BWD = 0
    sx.LAUNCHES_BY_SHAPE.clear()
    losses, secs = train_steps(exe, main, loss, feed, scope, 6)
    k2 = (sx.LAUNCHES_FWD, sx.LAUNCHES_BWD)
    by_shape = dict(sx.LAUNCHES_BY_SHAPE)
    peak = torch.cuda.max_memory_allocated()
    all_losses = warm + losses
    masters = {str(scope.find_var(p.name).dtype) for p in params}
    # each step's two softmax_with_cross_entropy ops, the MLM loss and the
    # NSP loss, in the leg's dtype: one launch of each kernel a step at each
    dt = torch.bfloat16 if amp else torch.float32
    shapes = ((BERT_BATCH * BERT_MASK, BERT_VOCAB), (BERT_BATCH, 2))
    want = {(kern, rows, vocab, dt): len(losses)
            for kern in ("K2a", "K2b") for rows, vocab in shapes}
    flop = bert_train_flop(BERT_BATCH)
    bound_ms = flop / (H100_BF16_FLOP_PER_S if amp
                       else H100_F32_FLOP_PER_S) * 1e3
    step_ms = float(np.median(secs)) * 1e3
    emit("bert_train", mode=mode, config="BERT_BASE_CONFIG",
         batch=BERT_BATCH, seq=BERT_SEQ, n_mask=BERT_MASK, dropout=0.1,
         optimizer="Adam", lr=1e-4, params=len(params), weights=n_weights,
         ops=len(ops), op_types=len(set(ops)), build_s=build_s,
         warm_ms=[x * 1e3 for x in warm_secs], steps=len(losses),
         step_ms_median=step_ms, step_ms=[x * 1e3 for x in secs],
         sequences_per_s=BERT_BATCH / (step_ms / 1e3),
         tokens_per_s=BERT_BATCH * BERT_SEQ / (step_ms / 1e3),
         peak_memory_bytes=peak, train_flop=flop, compute_bound_ms=bound_ms,
         compute_bound_share=bound_ms / step_ms, losses=all_losses,
         k2_launches={"fwd": k2[0], "bwd": k2[1]},
         k2_launches_by_shape={"%s_%s" % (kern, vision_key(rows, vocab, d)): n
                               for (kern, rows, vocab, d), n
                               in sorted(by_shape.items(), key=str)})
    check(bool(np.isfinite(all_losses).all()),
          "non-finite BERT loss (%s): %r" % (mode, all_losses))
    check(all_losses[-1] < all_losses[0],
          "BERT loss did not fall (%s): %r" % (mode, all_losses))
    check(k2 == (2 * len(losses), 2 * len(losses)),
          "K2 launches %r over %d BERT steps (%s), want 2 a step"
          % (k2, len(losses), mode))
    check(by_shape == want,
          "K2 launches by (kernel, N, V, dtype) %r over %d BERT steps (%s), "
          "want %r" % (by_shape, len(losses), mode, want))
    check(masters == {"torch.float32"}, "parameters not float32: %r" % masters)
    for row, kern in zip(xent_rows, ("K2a", "K2b")):
        for rows, vocab in shapes:
            row["bert_shapes"][vision_key(rows, vocab, dt)]["launches"] = \
                by_shape.get((kern, rows, vocab, dt), 0)
    train_profile_phase(exe, main, loss, feed, scope,
                        phase="bert_profile_" + mode)
    if ckpt_dir is not None:
        with fluid.scope_guard(scope):
            fluid.io.save_params(exe, ckpt_dir, main_program=main)
    counts = captured_leg(
        "bert_captured", main, loss, scope,
        [bert_feed(BERT_BATCH, seed=i) for i in range(CAPTURED_STEPS)], amp,
        {k: (pat, 2) for k, pat in K2_NAMES.items()})
    for row, kern in zip(xent_rows, K2_NAMES):
        row.setdefault("captured_launches_a_step", {})[
            "bert_" + mode] = counts[kern]
    if amp:
        prepare_memory_leg(main, loss, scope)
    del scope, exe
    torch.cuda.empty_cache()


PREPARE_STEPS = 3


def prepare_memory_leg(main, loss, scope):
    """``prepare_memory``: ``Executor.prepare`` and ``memory_report`` on
    the BERT-base AMP training step (``bert_train``'s program, from copies
    of its scope after its steps). ``run_steps`` of ``PREPARE_STEPS`` new
    batches from one copy (its first two steps the captured step's eager
    warm-ups), and from another copy ``memory_report`` with abstract
    ``(shape, dtype)`` feeds (which prepares the step: warm-ups on copies
    of the state and zero feeds, then the capture), then the same steps,
    every one a replay: losses and state bit for bit, the step counters
    equal, no warm-up left. Reports the prepare's seconds, the report and
    its ``peak_hbm_bytes`` beside ``torch.cuda.max_memory_allocated()``
    over the prepared steps, as a ratio."""
    import paddle_tpu_torch as fluid

    t_leg = time.perf_counter()
    dev = fluid.CUDAPlace(0)
    feeds = [bert_feed(BERT_BATCH, seed=10 + i) for i in range(PREPARE_STEPS)]
    abstract = {n: (v.shape, v.dtype) for n, v in feeds[0].items()}
    step0 = getattr(main, "_tpu_step_counter", 0)
    runs = {}
    for prepared in (False, True):
        sc = clone_scope(fluid, scope)
        exe = fluid.Executor(dev)
        main._tpu_step_counter = step0
        report, prepare_s = None, 0.0
        if prepared:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            report = exe.memory_report(main, abstract, [loss], sc)
            torch.cuda.synchronize()
            prepare_s = time.perf_counter() - t0
            cap, = exe._captured.values()
            check(cap.warm_left == 0 and cap.graph is not None
                  and main._tpu_step_counter == step0,
                  "prepare_memory: prepare left %d warm-ups, graph %s, the "
                  "step counter at %d (from %d)" % (
                      cap.warm_left, cap.graph is not None,
                      main._tpu_step_counter, step0))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        rows = exe.run_steps(main, feeds, steps=PREPARE_STEPS,
                             fetch_list=[loss], scope=sc)
        torch.cuda.synchronize()
        runs[prepared] = {
            "losses": [float(np.asarray(r[0]).reshape(-1)[0]) for r in rows],
            "scope": sc, "steps_s": time.perf_counter() - t0,
            "counter": main._tpu_step_counter,
            "peak": torch.cuda.max_memory_allocated(),
            "report": report, "prepare_s": prepare_s}
        exe.close()
    plain, prep = runs[False], runs[True]
    _, state_err, state_equal = state_norm_err(prep["scope"], plain["scope"])
    check(prep["losses"] == plain["losses"] and state_equal
          and prep["counter"] == plain["counter"] == step0 + PREPARE_STEPS,
          "prepare_memory: prepared steps %r against %r (state %.3g, equal "
          "%s), step counters %d and %d" % (
              prep["losses"], plain["losses"], state_err, state_equal,
              prep["counter"], plain["counter"]))
    report = prep["report"]
    check(set(report) == {"argument_bytes", "output_bytes", "temp_bytes",
                          "alias_bytes", "generated_code_bytes",
                          "peak_hbm_bytes"}
          and report["peak_hbm_bytes"] > 0,
          "prepare_memory: memory_report %r" % report)
    emit("prepare_memory", nvidia_smi=SMI[0], program="bert_train "
         "(BERT-base, AMP)", steps=PREPARE_STEPS, losses=prep["losses"],
         bit_equal=True, prepare_s=prep["prepare_s"],
         steps_s={"plain": plain["steps_s"], "prepared": prep["steps_s"]},
         memory_report=report,
         max_memory_allocated_prepared=prep["peak"],
         max_memory_allocated_plain=plain["peak"],
         peak_hbm_over_max_allocated=report["peak_hbm_bytes"] / prep["peak"],
         leg_s=time.perf_counter() - t_leg)
    del runs, plain, prep
    torch.cuda.empty_cache()


def build_bert_infer(fluid):
    """``bench.py``'s ``bench_bert_infer`` program: ``bert_base`` at
    ``is_test``, dropout 0, its ids coupled to the previous step's pooled
    output by a zero (the bench's ``chain``), the pooled output fetched in
    float32. Returns (main, startup, pooled_f32)."""
    from paddle_tpu_torch.models import bert

    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        ids = fluid.layers.data("ids", shape=[BERT_INFER_SEQ], dtype="int64")
        pos = fluid.layers.data("pos", shape=[BERT_INFER_SEQ], dtype="int64")
        sent = fluid.layers.data("sent", shape=[BERT_INFER_SEQ],
                                 dtype="int64")
        mask = fluid.layers.data("mask", shape=[BERT_INFER_SEQ],
                                 dtype="float32")
        chain = fluid.layers.data("chain", shape=[768])
        zero = fluid.layers.cast(
            fluid.layers.scale(fluid.layers.reduce_sum(chain), scale=0.0),
            "int64")
        ids2 = fluid.layers.elementwise_add(ids, zero)
        _, pooled = bert.bert_base(ids2, pos, sent, mask, dropout_rate=0.0,
                                   is_test=True)
        pooled_f32 = fluid.layers.cast(pooled, "float32")
    return main, startup, pooled_f32


def bert_infer_feed(batch):
    """The bench's inference feed: RandomState(0) draws the ids; the chain
    starts at zeros."""
    rng = np.random.RandomState(0)
    return {
        "ids": rng.randint(0, BERT_VOCAB,
                           (batch, BERT_INFER_SEQ)).astype("int64"),
        "pos": np.tile(np.arange(BERT_INFER_SEQ), (batch, 1)).astype("int64"),
        "sent": np.zeros((batch, BERT_INFER_SEQ), "int64"),
        "mask": np.ones((batch, BERT_INFER_SEQ), "float32"),
        "chain": np.zeros((batch, 768), "float32"),
    }


def infer_steps(exe, main, out, feed, scope, n, carry):
    """n inference steps as bench_bert_infer runs them: each feeds the
    previous step's pooled output (``carry[0]``) as the chain; a step ends
    with the card synchronised. Returns (seconds of each step, the last
    output)."""
    secs = []
    for _ in range(n):
        f = dict(feed, chain=carry[0])
        t0 = time.perf_counter()
        carry[0], = exe.run(main, feed=f, fetch_list=[out], scope=scope,
                            return_numpy=False)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    return secs, carry[0]


def bert_infer_phase(ckpt_dir):
    """bench_bert_infer's program at full width and depth (batch 64 x 256),
    its weights the ``bert_train`` leg's encoder, loaded by
    ``io.load_params`` from what that leg saved: float32 (TF32 off), then
    under ``fluid.amp.enable`` as the bench runs it; 2 warm-up steps and 6
    timed ones each, their median the step time, and one profiled step.
    Returns what ``bert_predictor_phase`` needs: the program, its scope and
    executor, the fetch and the float32 output of the bench's feed."""
    import paddle_tpu_torch as fluid

    t0 = time.perf_counter()
    main, startup, out = build_bert_infer(fluid)
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CUDAPlace(0))
    exe.run(startup, scope=scope)
    params = main.all_parameters()
    with fluid.scope_guard(scope):
        fluid.io.load_params(exe, ckpt_dir, main_program=main)
    saved = np.load(ckpt_dir + "/word_embedding.npy")
    check(np.array_equal(scope.as_numpy("word_embedding"), saved)
          and all(scope.find_var(p.name).device.type == "cuda"
                  for p in params),
          "load_params did not put the trained weights on the card")
    setup_s = time.perf_counter() - t0
    feed_np = bert_infer_feed(BERT_INFER_BATCH)
    feed = {k: torch.as_tensor(v, device=exe.place)
            for k, v in feed_np.items()}
    flop = bert_fwd_flop(BERT_INFER_BATCH)
    want = None
    for amp in (False, True):
        mode = "bfloat16_amp" if amp else "float32"
        if amp:
            fluid.amp.enable(main, "bfloat16")
        carry = [feed["chain"]]
        warm, warm_out = infer_steps(exe, main, out, feed, scope, 2, carry)
        warm_out = warm_out.cpu().numpy()
        if want is None:
            want = warm_out
        torch.cuda.reset_peak_memory_stats()
        secs, last = infer_steps(exe, main, out, feed, scope, 6, carry)
        peak = torch.cuda.max_memory_allocated()
        last = last.cpu().numpy()
        bound_ms = flop / (H100_BF16_FLOP_PER_S if amp
                           else H100_F32_FLOP_PER_S) * 1e3
        step_ms = float(np.median(secs)) * 1e3
        emit("bert_infer", mode=mode, config="BERT_BASE_CONFIG",
             batch=BERT_INFER_BATCH, seq=BERT_INFER_SEQ, params=len(params),
             loaded_from="bert_train (io.save_params / io.load_params)",
             setup_s=setup_s, warm_ms=[x * 1e3 for x in warm],
             steps=len(secs), step_ms_median=step_ms,
             step_ms=[x * 1e3 for x in secs],
             sequences_per_s=BERT_INFER_BATCH / (step_ms / 1e3),
             tokens_per_s=BERT_INFER_BATCH * BERT_INFER_SEQ / (step_ms / 1e3),
             peak_memory_bytes=peak, fwd_flop=flop,
             compute_bound_ms=bound_ms, compute_bound_share=bound_ms / step_ms,
             out_dtype=str(last.dtype),
             chained_steps_bit_equal=bool(np.array_equal(warm_out, last)),
             max_abs_diff_to_float32=float(np.abs(last - want).max()))
        check(bool(np.isfinite(last).all()) and last.shape == (
            BERT_INFER_BATCH, 768), "BERT inference output (%s): shape %s"
            % (mode, last.shape))
        carry = [feed["chain"]]
        profile_step(lambda: infer_steps(exe, main, out, feed, scope, 1,
                                         carry)[0][0],
                     "bert_infer_profile_" + mode)
    fluid.amp.disable(main)
    return {"main": main, "scope": scope, "exe": exe, "out": out,
            "feed": feed_np, "want": want}


def bert_predictor_phase(infer, runs=3):
    """The Fluid inference entry point on the card: ``save_inference_model``
    of ``bert_infer``'s program (feeds ids, pos, sent, mask, chain; target
    the float32 pooled output), ``inference.create_predictor`` of an
    ``AnalysisConfig`` of that directory (the card by default), once as
    configured by default (batch bucketing, as in the JAX package) and
    once with ``switch_batch_bucketing(False)``. Every run is the captured
    step (``CompiledProgram``: one CUDA graph a feed shape). Each runs at
    batch 64 and at 48 (the bucketing one pads 48 to 64, the shape whose
    graph it already holds, and slices back), its warm-ups and capture
    (``executor.WARMUP_STEPS`` + 1 runs) untimed, then ``runs`` timed
    runs:

    * the outputs equal the ``Executor``'s float32 run of the same program
      on the rows it ran bit for bit: the exact batch, or the 64 rows a
      bucketed run pads to (no padding row leaks into a real one);
    * against the ``Executor``'s run at the exact batch they agree to 1e-5
      relative, norm-wise: at 48 rows cuBLAS takes other kernels than at
      64, so each product sums in another order;
    * a run staged through the input handles equals a positional one bit
      for bit.

    The saved desc carries no AMP mode, so the loaded model runs in
    float32. Returns each run's output and median ms by
    "<batch>_<bucketed|exact>", for ``export_bert``."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import inference
    from paddle_tpu_torch.executor import WARMUP_STEPS

    main, scope, exe, out = (infer[k] for k in ("main", "scope", "exe", "out"))
    feed = infer["feed"]
    preds = {}
    with tempfile.TemporaryDirectory() as model_dir:
        t0 = time.perf_counter()
        with fluid.scope_guard(scope):
            fluid.io.save_inference_model(model_dir, BERT_FEEDS, [out], exe,
                                          main_program=main)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        preds[True] = inference.create_predictor(
            inference.AnalysisConfig(model_dir))
        load_s = time.perf_counter() - t0
        config = inference.AnalysisConfig(model_dir)
        config.switch_batch_bucketing(False)
        preds[False] = inference.create_predictor(config)
    check(preds[True].config.batch_bucketing(),
          "the default AnalysisConfig does not bucket batches")
    check(all(p._exe.place.type == "cuda" for p in preds.values()),
          "the Predictor is not on the card")
    amp_dtype = getattr(preds[False]._program, "_amp_dtype", None)
    check(amp_dtype is None, "the loaded program carries AMP %r" % amp_dtype)
    res, outs = {}, {}
    for batch in (BERT_INFER_BATCH, 48):
        f = {k: v[:batch] for k, v in feed.items()}
        args = [f[n] for n in BERT_FEEDS]
        exact = infer["want"] if batch == BERT_INFER_BATCH else exe.run(
            main, feed=f, fetch_list=[out], scope=scope)[0]
        for bucketing, pred in preds.items():
            ran = BERT_INFER_BATCH if bucketing else batch
            ran_rows = infer["want"][:batch] if bucketing else exact
            for _ in range(WARMUP_STEPS + 1):
                pred.run(args)
            secs = []
            for _ in range(runs):
                t0 = time.perf_counter()
                got, = pred.run(args)
                secs.append(time.perf_counter() - t0)
            for n in BERT_FEEDS:
                pred.get_input_handle(n).copy_from_cpu(f[n])
            pred.run()
            staged = pred.get_output_handle(out.name).copy_to_cpu()
            rel = float(np.linalg.norm((got - exact).astype(np.float64))
                        / np.linalg.norm(exact.astype(np.float64)))
            key = "%d_%s" % (batch, "bucketed" if bucketing else "exact")
            outs[key] = got
            r = res[key] = {
                "batch_run": ran, "shape": list(got.shape),
                "run_ms_median": float(np.median(secs)) * 1e3,
                "run_ms": [x * 1e3 for x in secs],
                "bit_equal_to_executor_rows_run": bool(np.array_equal(
                    got, ran_rows)),
                "normwise_rel_err_to_executor_exact_batch": rel,
                "max_abs_diff_to_executor_exact_batch":
                    float(np.abs(got - exact).max()),
                "elementwise_err_of_1e-5_rel_1e-6_row": scaled_err(
                    torch.as_tensor(got), torch.as_tensor(exact), 1e-5),
                "handles_bit_equal": bool(np.array_equal(staged, got)),
                "captured_steps": len(pred._exe._captured),
                "graphs": sum(c.graph is not None
                              for c in pred._exe._captured.values())}
            check(got.shape == (batch, 768)
                  and r["bit_equal_to_executor_rows_run"],
                  "Predictor at batch %d (bucketing %s) != the Executor's "
                  "rows: %r" % (batch, bucketing, r))
            check(rel <= 1e-5, "Predictor at batch %d (bucketing %s) vs the "
                  "Executor at that batch: norm-wise %g > 1e-5"
                  % (batch, bucketing, rel))
            check(r["handles_bit_equal"], "Predictor handle run != "
                  "positional run at batch %d (bucketing %s)"
                  % (batch, bucketing))
            check(r["graphs"] == r["captured_steps"]
                  == (1 if bucketing or batch == BERT_INFER_BATCH else 2)
                  and pred._exe.host_op_steps == 0,
                  "Predictor at batch %d (bucketing %s): %d graphs of %d "
                  "captured steps" % (batch, bucketing, r["graphs"],
                                      r["captured_steps"]))
    emit("bert_predictor", model="bench_bert_infer program (BERT-base, "
         "loaded weights)", feeds=BERT_FEEDS, save_s=save_s, load_s=load_s,
         nvidia_smi=SMI[0], runs_captured=True,
         device=str(preds[False]._exe.place), amp=amp_dtype,
         runs_in="float32 (the desc carries no AMP mode)",
         tol={"executor_rows_run": "bit equal",
              "executor_exact_batch": "1e-5 norm-wise"}, batches=res)
    del preds
    torch.cuda.empty_cache()
    return {k: {"out": outs[k], "run_ms_median": r["run_ms_median"]}
            for k, r in res.items()}


def bert_parity_phase():
    """bench_bert's program at full width, 2 layers, dropout 0, batch 8:
    three steps on the card (K2a/K2b twice a step) and three on the CPU
    (their plain versions) from one CPU startup carried by
    ``io.state_from_numpy``, in float32 (TF32 off; losses to 1e-4
    relative) and under AMP (2e-2)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.ops.kernels import softmax_xent as sx

    feed = bert_feed(8)
    for amp, tol in ((False, 1e-4), (True, 2e-2)):
        main, startup, loss = build_bert(fluid, amp, n_layer=2, dropout=0.0)
        init = fluid.Scope()
        fluid.Executor(fluid.CPUPlace()).run(startup, scope=init)
        arrays = {n: init.as_numpy(n) for n in init.vars}
        card = fluid.io.state_from_numpy(main, arrays, fluid.Scope(),
                                         fluid.CUDAPlace(0))
        f0, b0 = sx.LAUNCHES_FWD, sx.LAUNCHES_BWD
        card_losses, _ = train_steps(fluid.Executor(fluid.CUDAPlace(0)), main,
                                     loss, feed, card, 3)
        n = (sx.LAUNCHES_FWD - f0, sx.LAUNCHES_BWD - b0)
        check(n == (6, 6), "the card run launched K2 %r times over 3 BERT "
              "steps, want 6" % (n,))
        cpu = fluid.io.state_from_numpy(main, arrays, fluid.Scope(),
                                        fluid.CPUPlace())
        t0 = time.perf_counter()
        cpu_losses, _ = train_steps(fluid.Executor(fluid.CPUPlace()), main,
                                    loss, feed, cpu, 3)
        check((sx.LAUNCHES_FWD - f0, sx.LAUNCHES_BWD - b0) == n,
              "the CPU run launched K2")
        rel = [abs(a - b) / abs(b) for a, b in zip(card_losses, cpu_losses)]
        emit("bert_parity", mode="bfloat16_amp" if amp else "float32",
             n_layer=2, batch=8, seq=BERT_SEQ, n_mask=BERT_MASK, dropout=0.0,
             steps=3, card_losses=card_losses, cpu_losses=cpu_losses,
             rel_err=rel, tol=tol, cpu_s=time.perf_counter() - t0)
        check(bool(np.isfinite(card_losses + cpu_losses).all())
              and max(rel) <= tol,
              "BERT card %r vs CPU %r losses (rel %r > %g, amp %s)"
              % (card_losses, cpu_losses, rel, tol, amp))
        del card, cpu
    torch.cuda.empty_cache()


# -- the captured legs --------------------------------------------------------
# Each leg holds the captured step (``Executor.run_steps``: warm-up steps,
# one CUDA graph capture, replays) against eager ``run()`` steps from one
# start state on one list of feeds, then times both in turns in this call.
CAPTURED_STEPS = 6   # steps each leg runs eagerly and captured
CAPTURED_TURNS = 2   # rounds of (an eager block, a captured block)
CAPTURED_BLOCK = 3   # steps a timed block: one run_steps chunk
# the hand-written kernels by the name the profiler records
K2_NAMES = {"K2a": r"xent_fwd", "K2b": r"xent_bwd"}
K1_NAMES = {"K1a": r"flash_fwd", "K1b": r"flash_dkv", "K1c": r"flash_dq"}


def timeit_pipeline(exe, prog, feed, fetch_list, batch, skip=5, iters=20,
                    epochs=3, fetch_every=8):
    """The body of ``bench.py``'s ``_timeit_pipeline`` with its calls
    unchanged (``run_steps(..., fetch_every=8, return_numpy=False)``, the
    last handle resolved by ``np.asarray``); returns its numbers instead of
    setting ``_timeit.last``."""

    def rep(n):
        return (feed for _ in range(n))

    warm = max(iters, skip)
    hs = exe.run_steps(prog, rep(warm), steps=warm, fetch_list=fetch_list,
                       fetch_every=fetch_every, return_numpy=False)
    np.asarray(hs[-1][0])
    times, dispatch_times, n_dispatches = [], [], 0
    for _ in range(max(1, epochs)):
        t0 = time.time()
        hs = exe.run_steps(prog, rep(iters), steps=iters,
                           fetch_list=fetch_list, fetch_every=fetch_every,
                           return_numpy=False)
        dispatch_times.append(time.time() - t0)
        out = np.asarray(hs[-1][0])  # sync: resolves the whole chain
        assert np.isfinite(out).all()
        times.append(time.time() - t0)
        n_dispatches = len(hs)
    dt = sorted(times)[len(times) // 2]
    return {"epoch_sec": times, "eps_median": batch * iters / dt,
            "fetch_every": fetch_every, "dispatches_per_epoch": n_dispatches,
            "host_dispatch_ms_per_step":
                sorted(dispatch_times)[len(dispatch_times) // 2] / iters
                * 1e3,
            "synced_step_ms": dt / iters * 1e3}


# the runtime calls by which the host puts work on the card
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaGraphLaunch", "cudaMemcpyAsync",
                "cudaMemsetAsync")


def step_profile(step, cpu_ops=True, warmup=None):
    """``step()`` once under torch.profiler: (wall ms, device busy ms,
    kernels run {name: count}, cudaGraphLaunch calls, the host's launch
    calls (``LAUNCH_CALLS``), the host's eight largest items by self CPU
    ms). Copies and memsets are not kernels and are left out of the
    kernels. ``cpu_ops=False`` records CUPTI's kernels and runtime calls
    only, not the torch ops (the host's items are then runtime calls),
    and sums the profiler's raw events (``kineto_results``) instead of
    its ``key_averages()``: a step of tens of thousands of torch calls
    takes tens of seconds to profile and average the other way.
    ``warmup()`` runs in the session's warm-up cycle, whose records are
    discarded (by default a spin kernel)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    torch.cuda.synchronize()
    activities = [ProfilerActivity.CUDA]
    if cpu_ops:
        activities.insert(0, ProfilerActivity.CPU)
    # a warm-up cycle, its records discarded: a session's first records
    # can be lost (the first ~55 kernels of a graph's first replay in the
    # session, or all of a short graph's), so the cycle asks CUPTI for its
    # buffer and replays a graph once before the step runs
    with profile(activities=activities, schedule=schedule(
            wait=0, warmup=1, active=1, repeat=1)) as prof:
        if warmup is None:
            torch.cuda._sleep(1000)
        else:
            warmup()
        torch.cuda.synchronize()
        time.sleep(PROFILE_WARMUP_S)
        prof.step()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        prof.step()
    if not cpu_ops:
        return (wall * 1e3,) + raw_event_sums(
            prof.profiler.kineto_results.events())
    avgs = prof.key_averages()
    kern = [e for e in avgs if e.device_type == DeviceType.CUDA
            and not e.key.startswith(("Memcpy", "Memset"))]
    host = sorted((e for e in avgs if e.device_type == DeviceType.CPU),
                  key=lambda e: -e.self_cpu_time_total)[:8]
    return (wall * 1e3, sum(e.self_device_time_total for e in kern) / 1e3,
            {e.key: e.count for e in kern},
            sum(e.count for e in avgs if e.key == "cudaGraphLaunch"),
            sum(e.count for e in avgs if e.key in LAUNCH_CALLS),
            {e.key[:60]: [e.count, e.self_cpu_time_total / 1e3]
             for e in host})


def raw_event_sums(events):
    """``step_profile``'s sums from the profiler's raw events: (device
    busy ms, kernels {name: count}, cudaGraphLaunch calls, the host's
    launch calls, the host's eight largest runtime calls by their ms)."""
    from torch.autograd import DeviceType

    kern, host = {}, {}
    busy_ns = 0
    for e in events:
        name = e.name()
        if e.device_type() == DeviceType.CUDA:
            if not name.startswith(("Memcpy", "Memset")):
                kern[name] = kern.get(name, 0) + 1
                busy_ns += e.duration_ns()
        else:
            item = host.setdefault(name[:60], [0, 0.0])
            item[0] += 1
            item[1] += e.duration_ns() / 1e6
    top = dict(sorted(host.items(), key=lambda kv: -kv[1][1])[:8])
    return (busy_ns / 1e6, kern, host.get("cudaGraphLaunch", [0])[0],
            sum(host[k][0] for k in LAUNCH_CALLS if k in host), top)


# in a whole smoke run the first profile of ``ctr_stream``'s replay has
# come back with 251-257 of its 309 kernel records in every run, and once
# all of 3 tries did
REPLAY_PROFILE_TRIES = 6


def replay_profile(replay, per_step, cpu_ops=True):
    """``step_profile`` of ``replay()`` (one CUDA graph replay) with each
    kernel of ``per_step`` ({name: (profiler name pattern, launches a
    step)}) counted in it by name. A replay runs every kernel its graph
    holds, so its counts cannot vary between replays; a profile whose
    counts differ from ``per_step`` is taken again, up to
    ``REPLAY_PROFILE_TRIES`` times, because CUPTI has been seen to drop
    the kernel records of a whole replay (an H100 run whose profiled
    replay held no kernel of the graph, while its losses matched the
    eager ones; and runs whose profile kept only part of a replay's
    kernels). Each session's warm-up cycle replays the graph once.
    Returns ``step_profile``'s tuple of the first matching
    profile (else the last), its counts, and each try's counts and
    kernels recorded."""
    want = {name: c for name, (_, c) in per_step.items()}
    tries = []
    for _ in range(REPLAY_PROFILE_TRIES):
        prof = step_profile(replay, cpu_ops, warmup=replay)
        kern = prof[2]
        counts = {name: sum(c for k, c in kern.items()
                            if re.search(pat, k, re.I))
                  for name, (pat, _) in per_step.items()}
        tries.append({"counts": counts, "kernels": sum(kern.values()),
                      "graph_launches": prof[3]})
        if counts == want:
            break
    return prof, counts, tries


def host_syncs(step):
    """The synchronizing CUDA calls of ``step()``, as the sync debug mode
    reports them (one warning each)."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            step()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return [str(w.message)[:120] for w in caught
            if "called a synchronizing" in str(w.message)]


def captured_leg(leg, main, loss, scope, feeds, amp, per_step,
                 pipeline_batch=None):
    """The captured leg of a phase, on its program and its scope after its
    eager steps: ``len(feeds)`` eager ``run()`` steps on the scope, then
    the same steps from the same start state and step index through
    ``run_steps`` on a copy (``WARMUP_STEPS`` eager warm-ups, one capture,
    replays). Losses within 1e-6 relative at every step and the state
    within 1e-6 norm-wise afterwards (AMP 1e-3), bit-equality reported;
    one capture and ``len(feeds) - WARMUP_STEPS`` replays; in one replay
    under the profiler one ``cudaGraphLaunch`` and each kernel of
    ``per_step`` ({name: (profiler name pattern, launches a step)}) at
    its count; no host sync in an eager step. Then eager and captured
    blocks of ``CAPTURED_BLOCK`` steps in turns on the card's copy of the
    first feed: step ms (block wall / steps, synced at the block's end)
    and host ms (until the block is dispatched); launches a step (kernels
    run, and the host's launch calls), busy share and peak memory of
    each. The profiles record the card's activity alone
    (``step_profile(cpu_ops=False)``): averaging the torch ops too took
    ~4.5 s a Transformer-base step on an H100 80GB HBM3 at 700 W, and its
    device times summed to more than the step's wall.
    With ``pipeline_batch`` the captured steps are driven by
    ``_timeit_pipeline``'s calls. Returns the launches a replay by kernel
    name."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.executor import WARMUP_STEPS
    from paddle_tpu_torch.monitor import metrics

    t_leg = time.perf_counter()
    dev = fluid.CUDAPlace(0)
    n = len(feeds)
    scope_c = clone_scope(fluid, scope)
    step0 = getattr(main, "_tpu_step_counter", 0)
    exe = fluid.Executor(dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    eager = [float(exe.run(main, feed=f, fetch_list=[loss], scope=scope)[0])
             for f in feeds]
    peak_e = torch.cuda.max_memory_allocated()
    main._tpu_step_counter = step0
    exe_c = fluid.Executor(dev)
    caps0, reps0 = metrics.CAPTURES.value, metrics.REPLAYS.value
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    if pipeline_batch:
        hs = exe_c.run_steps(main, iter(feeds), steps=n, fetch_list=[loss],
                             fetch_every=8, scope=scope_c,
                             return_numpy=False)
        got = [float(x) for h in hs for x in np.atleast_1d(np.asarray(h[0]))]
    else:
        got = [float(r[0]) for r in exe_c.run_steps(
            main, feeds, fetch_list=[loss], fetch_every=n, scope=scope_c)]
    run_steps_s = time.perf_counter() - t0
    peak_c = torch.cuda.max_memory_allocated()
    captures = metrics.CAPTURES.value - caps0
    replays = metrics.REPLAYS.value - reps0
    tol = 1e-3 if amp else 1e-6
    loss_err = loss_rel_err(got, eager)
    _, state_err, state_equal = state_norm_err(scope_c, scope)
    for k, v in scope.vars.items():
        if isinstance(v, torch.Tensor) and not v.is_floating_point():
            check(torch.equal(scope_c.find_var(k), v),
                  "%s: state %s differs" % (leg, k))
    check(len(got) == n and loss_err <= tol,
          "%s: captured losses %r against eager %r (largest relative "
          "difference %.3g, tolerance %g)" % (leg, got, eager, loss_err, tol))
    check(state_err <= tol, "%s: state after the captured steps %.3g from "
          "the eager one norm-wise (tolerance %g)" % (leg, state_err, tol))
    check((captures, replays) == (1, n - WARMUP_STEPS),
          "%s: %d captures and %d replays in %d steps, want 1 and %d"
          % (leg, captures, replays, n, n - WARMUP_STEPS))

    dfeed = {k: torch.as_tensor(v, device=dev) for k, v in feeds[0].items()}
    syncs = host_syncs(lambda: exe.run(main, feed=dfeed, fetch_list=[loss],
                                       scope=scope, return_numpy=False))
    check(not syncs, "%s: an eager step syncs the host: %s" % (leg, syncs))

    def eager_step():
        exe.run(main, feed=dfeed, fetch_list=[loss], scope=scope,
                return_numpy=False)

    def captured_steps(k):
        return exe_c.run_steps(main, (dfeed for _ in range(k)), steps=k,
                               fetch_list=[loss], fetch_every=k,
                               scope=scope_c, return_numpy=False)

    wall_e, busy_e, kern_e, _, calls_e, _ = step_profile(eager_step,
                                                         cpu_ops=False)
    want = {name: c for name, (_, c) in per_step.items()}
    pats = "|".join(pat for pat, _ in per_step.values())

    (wall_c, busy_c, kern_c, graph_launches, calls_c, host_c), counts, \
        tries = replay_profile(lambda: captured_steps(1), per_step,
                               cpu_ops=False)
    host_block = step_profile(lambda: captured_steps(CAPTURED_BLOCK),
                              cpu_ops=False)[-1]
    block_syncs = host_syncs(lambda: captured_steps(CAPTURED_BLOCK))
    check(graph_launches == 1, "%s: %d cudaGraphLaunch in one replay"
          % (leg, graph_launches))
    check(counts == want, "%s: kernels in one replay %r, want %r a step; "
          "by name in the replay %r, in an eager step %r; each profile "
          "taken %r" % (leg, counts, want,
                        {k: c for k, c in kern_c.items()
                         if re.search(pats, k, re.I)},
                        {k: c for k, c in kern_e.items()
                         if re.search(pats, k, re.I)}, tries))

    times = {"eager": [], "captured": []}
    hosts = {"eager": [], "captured": []}
    for _ in range(CAPTURED_TURNS):
        for mode in ("eager", "captured"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if mode == "eager":
                for _ in range(CAPTURED_BLOCK):
                    eager_step()
            else:
                captured_steps(CAPTURED_BLOCK)
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            hosts[mode].append((t1 - t0) / CAPTURED_BLOCK * 1e3)
            times[mode].append((t2 - t0) / CAPTURED_BLOCK * 1e3)
    pipeline = None
    if pipeline_batch:
        # as the bench runs it: the program's state in the global scope
        with fluid.scope_guard(scope_c):
            pipeline = timeit_pipeline(exe_c, main, dfeed, [loss],
                                       pipeline_batch, iters=8, epochs=2)
    emit(leg, mode="bfloat16_amp" if amp else "float32", steps=n,
         warmup_steps=WARMUP_STEPS, captures=captures, replays=replays,
         losses_eager=eager, losses_captured=got,
         loss_max_rel_diff=loss_err, state_max_norm_diff=state_err,
         bit_equal=bool(got == eager and state_equal), tolerance=tol,
         step_ms_eager=float(np.median(times["eager"])),
         step_ms_captured=float(np.median(times["captured"])),
         step_ms_turns=times, host_ms_eager=float(np.median(hosts["eager"])),
         host_ms_captured=float(np.median(hosts["captured"])),
         busy_share_eager=busy_e / wall_e, busy_share_captured=busy_c / wall_c,
         device_share_of_step_eager=busy_e / np.median(times["eager"]),
         device_share_of_step_captured=busy_c
         / np.median(times["captured"]),
         device_busy_ms_eager=busy_e, device_busy_ms_captured=busy_c,
         launches_eager=sum(kern_e.values()),
         launches_captured=sum(kern_c.values()), graph_launches=graph_launches,
         host_launch_calls_eager=calls_e, host_launch_calls_captured=calls_c,
         kernels_a_replay=counts, replay_profiles=tries,
         capture_s=metrics.CAPTURE_MS.value / 1e3, run_steps_s=run_steps_s,
         peak_memory_eager=peak_e, peak_memory_captured=peak_c,
         eager_host_syncs=len(syncs), captured_block_host_syncs=block_syncs,
         host_top_captured_step=host_c, host_top_captured_block=host_block,
         pipeline=pipeline,
         phase_seconds=time.perf_counter() - t_leg)
    exe_c.close()
    del scope_c, exe_c, exe
    torch.cuda.empty_cache()
    return counts


# -- slice 13: the pass pipeline and gradient accumulation ---------------------

# the non-causal attention sites of Transformer-base that
# flash_attention_rewrite turns back into the fused op: 6 encoder
# self-attentions and 6 decoder cross-attentions
UNFUSED_SITES = 2 * TRAIN["n_layer"]
# what the rewritten program keeps beside the fused-built one: the segment
# ids lowered to an additive bias (layers/attention.py _segment_bias), one
# chain for the encoder's (src, src) and one for the cross (trg, src)
# attentions once CSE merged the layers' copies
SEGMENT_BIAS_OPS = {"unsqueeze": 5, "equal": 2, "cast": 2, "scale": 2}
ACCUM = 4          # microbatches of the accumulated step
FLASH_DROPOUT_LAYERS = 2
OPT_LOG = []       # one entry a pass-pipeline run (record_pipeline)


def record_pipeline():
    """Record, for every program the default pass pipeline optimizes, its
    op count at level 0 (the source) and level 1 (the clone) and the op
    types the pipeline removed and added, in ``OPT_LOG``. It wraps
    ``passes.pipeline.optimize_program`` and changes nothing it returns."""
    from collections import Counter

    from paddle_tpu_torch.passes import pipeline

    inner = pipeline.optimize_program

    def optimize_program(program, fetch_names=None, scope=None, level=None):
        out = inner(program, fetch_names, scope, level)
        src = Counter(op.type for op in program.global_block.ops)
        opt = Counter(op.type for op in out.global_block.ops)
        OPT_LOG.append({"ops_level0": sum(src.values()),
                        "ops_level1": sum(opt.values()),
                        "removed": dict(src - opt), "added": dict(opt - src)})
        return out

    pipeline.optimize_program = optimize_program


def op_types(program):
    from collections import Counter

    return Counter(op.type for op in program.global_block.ops)


def bench_feed(batch, seq, seed=0):
    """``bench_transformer``'s feed at another sequence length (``seed``
    another batch of the same shapes)."""
    vocab = TRAIN["vocab"]
    rng = np.random.RandomState(seed)
    return {
        "src": rng.randint(2, vocab, (batch, seq)).astype("int64"),
        "trg": rng.randint(2, vocab, (batch, seq)).astype("int64"),
        "lbl": rng.randint(2, vocab, (batch, seq, 1)).astype("int64"),
        "smask": np.ones((batch, seq), "float32"),
        "tmask": np.ones((batch, seq), "float32"),
    }


def build_bench_transformer(fluid, seq=None, dropout=0.1, amp=True,
                            optimizer=None, one_hot_loss=False):
    """``bench.py:247-275`` ``bench_transformer``'s program for the port's
    package, built as the bench builds it: ``set_flag("unfused_attention",
    True)`` around ``transformer_base`` (vocab 30000, ``max_length`` the
    sequence length), Adam(1e-4) (or ``optimizer(fluid)``),
    ``amp.decorate`` with ``amp``; with ``one_hot_loss`` the loss is
    ``dist_transformer.py``'s (``one_hot`` -> ``label_smooth`` -> soft-label
    cross-entropy), not the fused one."""
    from paddle_tpu_torch.models import transformer as tfm

    seq, vocab = seq or TRAIN["seq"], TRAIN["vocab"]
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 7
    prev = fluid.get_flag("unfused_attention")
    fluid.set_flag("unfused_attention", True)
    try:
        with fluid.program_guard(main, startup), fluid.unique_name.guard():
            src = fluid.layers.data("src", shape=[seq], dtype="int64")
            trg = fluid.layers.data("trg", shape=[seq], dtype="int64")
            lbl = fluid.layers.data("lbl", shape=[seq, 1], dtype="int64")
            smask = fluid.layers.data("smask", shape=[seq], dtype="float32")
            tmask = fluid.layers.data("tmask", shape=[seq], dtype="float32")
            _, loss = tfm.transformer_base(
                src, trg, lbl, smask, tmask, src_vocab_size=vocab,
                trg_vocab_size=vocab, max_length=seq, dropout_rate=dropout,
                one_hot_loss=one_hot_loss)
            opt = fluid.optimizer.Adam(learning_rate=1e-4) \
                if optimizer is None else optimizer(fluid)
            if amp:
                opt = fluid.amp.decorate(opt)
            opt.minimize(loss)
    finally:
        fluid.set_flag("unfused_attention", prev)
    return main, startup, loss


def clone_scope(fluid, scope):
    out = fluid.Scope()
    for k, v in scope.vars.items():
        out.set_var(k, v.clone() if isinstance(v, torch.Tensor) else v)
    return out


def state_norm_err(a, b):
    """The norm-wise difference of the float tensors of scope a from scope
    b's (b's moved to a's device): (over the whole state, the largest of
    one tensor's), and whether every tensor is bit-equal."""
    err, equal, d2, n2 = 0.0, True, 0.0, 0.0
    for k, v in a.vars.items():
        if not isinstance(v, torch.Tensor):
            continue
        w = b.find_var(k).to(v.device)
        equal = equal and torch.equal(v, w)
        if v.is_floating_point():
            d = float((v.double() - w.double()).norm())
            n = float(w.double().norm())
            d2, n2 = d2 + d * d, n2 + n * n
            err = max(err, d / max(n, 1e-30))
    return (d2 / max(n2, 1e-60)) ** 0.5, err, equal


def most_different(a, b, n=4):
    """The ``n`` float tensors of scope a furthest from scope b's,
    norm-wise: [(relative difference, name)], largest first."""
    diffs = []
    for k, v in a.vars.items():
        if isinstance(v, torch.Tensor) and v.is_floating_point():
            w = b.find_var(k).to(v.device).double()
            diffs.append((float((v.double() - w).norm())
                          / max(float(w.norm()), 1e-30), k))
    return sorted(diffs, reverse=True)[:n]


def loss_rel_err(got, want):
    return max(abs(g - w) / max(abs(w), 1e-6) for g, w in zip(got, want))


def time_in_turns(legs, turns=CAPTURED_TURNS, block=CAPTURED_BLOCK):
    """Blocks of ``block`` steps of each leg ({name: step(k)}) in turns,
    ``turns`` rounds; returns {name: median ms a step}, the host waiting
    for each block's end."""
    times = {name: [] for name in legs}
    for _ in range(turns):
        for name, run in legs.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run(block)
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) / block * 1e3)
    return {name: float(np.median(t)) for name, t in times.items()}, times


def eager_accumulated(exe, main, scope, feed, loss, accum):
    """One eager accumulated step of ``main`` (the body its captured step
    holds), on the pass pipeline's clone, with its step index from the
    source program; returns the loss tensor (on the card)."""
    step = exe._next_step_index(main)
    prog = exe._maybe_optimize(main, (loss.name,), scope)
    feeds = {n: exe._feed_tensor(prog.global_block, n, v)
             for n, v in feed.items()}
    env = exe._eager_step(prog, exe._plan(prog), scope, feeds, (loss.name,),
                          step, accum)
    return env[loss.name]


def norm_diff(got, want):
    """||got - want|| / ||want|| over lists of tensors taken as one."""
    d2 = sum(float((g.double() - w.double()).norm()) ** 2
             for g, w in zip(got, want))
    n2 = sum(float(w.double().norm()) ** 2 for w in want)
    return (d2 / max(n2, 1e-60)) ** 0.5


def unfused_train_phase(xent_rows):
    """``bench_transformer``'s program as ``bench.py`` builds it (attention
    from primitives under ``FLAGS_unfused_attention``, AMP, batch 64 x 256,
    vocab 30000): ``flash_attention_rewrite`` must match every non-causal
    site (``UNFUSED_SITES``), the pipeline's op types must equal the
    fused-built program's but for the segment-bias chain
    (``SEGMENT_BIAS_OPS``), K2a/K2b must launch once a step eagerly and
    inside one replay (``captured_leg``), and at dropout 0 three steps must
    give the fused-built program's losses from the same state within 1e-6
    relative and its state within ``PARITY_TOL`` on a padded batch
    (``dropout0_parity``; under AMP the rewritten sites read a float32
    bias and compute in float32, as in the JAX package, where the
    fused-built program stays in bf16), and the same limits must reject
    each of ``PLANTED_REWRITES``. Step ms eager
    and captured in turns with the fused-built (``train`` phase's) AMP
    program; op counts at level 0 and 1; peak memory."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core.pass_framework import get_pass
    from paddle_tpu_torch.ops.kernels import softmax_xent as sx

    t_phase = time.perf_counter()
    dev = fluid.CUDAPlace(0)
    main, startup, loss = build_bench_transformer(fluid)
    fused, _, floss, _ = build_transformer(fluid, train=True, amp=True,
                                           **TRAIN)
    rewrite = get_pass("flash_attention_rewrite")
    rewrite.set_attr("fetch_names", (loss.name,))
    rewrite.apply(main.clone())
    rewrites = rewrite.attr("rewrites_matched")
    check(rewrites == UNFUSED_SITES, "flash_attention_rewrite matched %s of "
          "the %d non-causal sites" % (rewrites, UNFUSED_SITES))
    scope = fluid.Scope()
    exe = fluid.Executor(dev)
    exe.run(startup, scope=scope)
    fscope = clone_scope(fluid, scope)
    opt = exe._maybe_optimize(main, (loss.name,), scope)
    fopt = exe._maybe_optimize(fused, (floss.name,), fscope)
    extra = dict(op_types(opt) - op_types(fopt))
    missing = dict(op_types(fopt) - op_types(opt))
    check(extra == SEGMENT_BIAS_OPS and not missing,
          "op types after the pipeline beside the fused-built program's: "
          "%r more, %r fewer" % (extra, missing))
    ops = {"unfused": {"level0": len(main.global_block.ops),
                       "level1": len(opt.global_block.ops)},
           "fused_built": {"level0": len(fused.global_block.ops),
                           "level1": len(fopt.global_block.ops)}}
    feed = train_feed(TRAIN_BATCH)
    warm, _ = train_steps(exe, main, loss, feed, scope, 2)
    torch.cuda.reset_peak_memory_stats()
    sx.LAUNCHES_FWD = sx.LAUNCHES_BWD = 0
    losses, secs = train_steps(exe, main, loss, feed, scope, 3)
    k2 = (sx.LAUNCHES_FWD, sx.LAUNCHES_BWD)
    peak = torch.cuda.max_memory_allocated()
    check(bool(np.isfinite(warm + losses).all()),
          "unfused_train: non-finite loss %r" % (warm + losses))
    check(k2 == (3, 3), "unfused_train: K2 launches %r over 3 steps" % (k2,))
    for row, n in zip(xent_rows, k2):
        row["launches_unfused_train"] = n
    counts = captured_leg(
        "unfused_captured", main, loss, scope,
        [train_feed(TRAIN_BATCH, seed=i) for i in range(CAPTURED_STEPS)],
        True, {k: (pat, 1) for k, pat in K2_NAMES.items()})
    for row, kern in zip(xent_rows, K2_NAMES):
        row.setdefault("captured_launches_a_step", {})[
            "unfused_amp"] = counts[kern]

    # in turns with the fused-built AMP program, eager and captured
    dfeed = {k: torch.as_tensor(v, device=dev) for k, v in feed.items()}
    exe_u, exe_f = fluid.Executor(dev), fluid.Executor(dev)

    def eager(prog, lv, sc):
        def run(k):
            for _ in range(k):
                exe.run(prog, feed=dfeed, fetch_list=[lv], scope=sc,
                        return_numpy=False)
        return run

    def captured(ex, prog, lv, sc):
        def run(k):
            ex.run_steps(prog, (dfeed for _ in range(k)), steps=k,
                         fetch_list=[lv], fetch_every=k, scope=sc,
                         return_numpy=False)
        return run

    ucap, fcap = clone_scope(fluid, scope), clone_scope(fluid, fscope)
    for ex, prog, lv, sc in ((exe_u, main, loss, ucap),
                             (exe_f, fused, floss, fcap)):
        captured(ex, prog, lv, sc)(3)  # warm-ups and the capture
    medians, turns = time_in_turns({
        "unfused_eager": eager(main, loss, scope),
        "fused_eager": eager(fused, floss, fscope),
        "unfused_captured": captured(exe_u, main, loss, ucap),
        "fused_captured": captured(exe_f, fused, floss, fcap)})
    exe_u.close()
    exe_f.close()
    del ucap, fcap, fscope, scope, exe, exe_u, exe_f
    torch.cuda.empty_cache()

    # dropout 0: the rewritten program against the fused-built one
    parity = {("bfloat16_amp" if amp else "float32"):
              dropout0_parity(fluid, padded_feed(TRAIN_BATCH), amp)
              for amp in (False, True)}
    def within(p):
        return (p["max_rel_diff"] <= p["tolerance"]["losses"]
                and p["state_norm_diff"] <= p["tolerance"]["state"])

    for mode, p in parity.items():
        check(within(p),
              "unfused vs fused-built at dropout 0 (%s): losses %r against "
              "%r (%.3g), state after 3 steps %.3g norm-wise (tolerances "
              "%r)" % (mode, p["losses_unfused"], p["losses_fused_built"],
                       p["max_rel_diff"], p["state_norm_diff"],
                       p["tolerance"]))
    # the same limits reject a rewrite with a planted fault
    planted = {}
    for amp in (False, True):
        for fault in PLANTED_REWRITES:
            p = dropout0_parity(fluid, padded_feed(TRAIN_BATCH), amp, fault)
            mode = "bfloat16_amp" if amp else "float32"
            planted["%s_%s" % (mode, fault)] = {
                k: p[k] for k in ("max_rel_diff", "state_norm_diff")}
            check(not within(p), "unfused_train: the dropout-0 parity "
                  "limits pass a rewrite with %s (%s): %r" % (fault, mode, p))
    emit("unfused_train", batch=TRAIN_BATCH, seq=TRAIN["seq"],
         rewrites_matched=rewrites, op_types_beside_fused_built=extra,
         op_counts=ops, losses=warm + losses,
         step_ms_first_eager=[s * 1e3 for s in secs],
         k2_launches={"fwd": k2[0], "bwd": k2[1]}, peak_memory_bytes=peak,
         step_ms_in_turns=medians, step_ms_turns=turns,
         dropout0_parity=parity, dropout0_planted_faults_rejected=planted,
         phase_seconds=time.perf_counter() - t_phase)


# dropout-0 parity of the rewritten program with the fused-built one: the
# losses (under AMP the fetched loss is bfloat16, resolution 0.0625 at 10.3)
# and the state after 3 steps, which under AMP tells the float32 attention
# of the rewritten sites from the fused-built program's bf16 one. The AMP
# state limit lies between what the sound rewrite reads and what a planted
# fault of the rewrite (PLANTED_REWRITES) reads; PERF.md has the readings.
PARITY_TOL = {False: {"losses": 1e-6, "state": 1e-6},
              True: {"losses": 1e-6, "state": 1e-3}}
PLANTED_REWRITES = {
    "sm_scale_dropped": lambda plan: dict(plan, sm_scale=1.0),
    "bias_dropped": lambda plan: dict(plan, bias=None),
}


def padded_feed(batch, seed=0):
    """``train_feed`` with padding: row i keeps its first ``seq - p_i``
    tokens of source and target (p_i drawn in [0, seq / 2)), so the
    rewritten sites' segment bias masks something."""
    feed = train_feed(batch, seed)
    seq = TRAIN["seq"]
    pad = np.random.RandomState(seed + 1).randint(0, seq // 2, batch)
    keep = (np.arange(seq)[None, :] < (seq - pad)[:, None]).astype("float32")
    feed["smask"], feed["tmask"] = keep, keep.copy()
    return feed


def dropout0_parity(fluid, feed, amp, planted=None):
    """``bench_transformer``'s program (rewritten by the pipeline) and the
    fused-built one at dropout 0, from one start state, 3 steps on
    ``feed``: their losses, largest relative loss difference, the state's
    norm-wise difference after the steps, and ``PARITY_TOL[amp]``. With
    ``planted`` (a key of ``PLANTED_REWRITES``) each rewritten site gets
    that fault."""
    from paddle_tpu_torch.passes import fuse_patterns as fp

    dev = fluid.CUDAPlace(0)
    um, us, ul = build_bench_transformer(fluid, dropout=0.0, amp=amp)
    fm, _, fl, _ = build_transformer(fluid, train=True, dropout=0.0,
                                     amp=amp, **TRAIN)
    sc_u = fluid.Scope()
    ex = fluid.Executor(dev)
    ex.run(us, scope=sc_u)
    sc_f = clone_scope(fluid, sc_u)
    rewrite = fp.FlashAttentionRewritePass._rewrite
    if planted is not None:
        fault = PLANTED_REWRITES[planted]
        fp.FlashAttentionRewritePass._rewrite = \
            lambda self, block, plan: rewrite(self, block, fault(plan))
    try:
        # the pipeline runs (and rewrites) at the program's first step
        got, _ = train_steps(ex, um, ul, feed, sc_u, 3)
    finally:
        fp.FlashAttentionRewritePass._rewrite = rewrite
    want, _ = train_steps(ex, fm, fl, feed, sc_f, 3)
    state, state_var, equal = state_norm_err(sc_u, sc_f)
    out = {"losses_unfused": got, "losses_fused_built": want,
           "max_rel_diff": loss_rel_err(got, want), "state_norm_diff": state,
           "largest_var_norm_diff": state_var, "tolerance": PARITY_TOL[amp],
           "bit_equal": bool(got == want and equal)}
    del sc_u, sc_f, ex
    torch.cuda.empty_cache()
    return out


def unfused_flash_phase(flash_rows):
    """``bench_transformer``'s program at sequence 2048, batch 8 (16,384
    tokens a step, as ``longctx_train``), dropout 0, AMP: every site
    reaches ``FLAGS_flash_attention_min_seq``, so the 12 rewritten sites
    take K1a-c with their [B, 1, S, S] segment bias (a stride-0 view over
    the heads, no [B, H, S, S] copy) and the 6 causal decoder sites with
    their segment ids: 18 launches of each a step, counted by the
    wrappers. Losses finite and falling; peak memory."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.ops.kernels import flash_attention as fa

    t_phase = time.perf_counter()
    seq, batch = LONGCTX_SEQ, LONGCTX_BATCH
    main, startup, loss = build_bench_transformer(fluid, seq=seq,
                                                  dropout=0.0)
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CUDAPlace(0))
    exe.run(startup, scope=scope)
    feed = bench_feed(batch, seq)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    warm, _ = train_steps(exe, main, loss, feed, scope, 2)
    fa.LAUNCHES_FWD = fa.LAUNCHES_DKV = fa.LAUNCHES_DQ = 0
    losses, secs = train_steps(exe, main, loss, feed, scope, 3)
    k1 = flash_launches()
    peak = torch.cuda.max_memory_allocated()
    dfeed = {k: torch.as_tensor(v, device=torch.device("cuda"))
             for k, v in feed.items()}
    syncs = host_syncs(lambda: exe.run(main, feed=dfeed, fetch_list=[loss],
                                       scope=scope, return_numpy=False))
    check(not syncs, "unfused_flash: an eager step syncs the host: %s"
          % syncs)
    sites = UNFUSED_SITES + TRAIN["n_layer"]
    want = sites * len(losses)
    all_losses = warm + losses
    check(k1 == (want, want, want), "unfused_flash: K1 launches %r over %d "
          "steps of %d sites" % (k1, len(losses), sites))
    check(bool(np.isfinite(all_losses).all())
          and all_losses[-1] < all_losses[0],
          "unfused_flash: losses %r not finite and falling" % all_losses)
    for row, n in zip(flash_rows, k1):
        row["launches_unfused_flash"] = n
    step_ms = float(np.median(secs)) * 1e3
    emit("unfused_flash", batch=batch, seq=seq, sites_a_step=sites,
         k1_launches=dict(zip(("fwd", "dkv", "dq"), k1)), losses=all_losses,
         step_ms_median=step_ms, step_ms=[s * 1e3 for s in secs],
         tokens_per_s=batch * seq / (step_ms / 1e3),
         segment_bias_bytes_a_chain=batch * seq * seq * 4,
         peak_memory_bytes=peak, eager_host_syncs=len(syncs),
         phase_seconds=time.perf_counter() - t_phase)
    del scope, exe
    torch.cuda.empty_cache()


def build_flash_dropout(fluid, train=True, n_layer=FLASH_DROPOUT_LAYERS):
    """Causal encoder layers at the full ``LONGCTX`` width (d_model 1024,
    16 heads, d_inner 4096, vocab 32000) with attention-probs dropout 0.1
    and no other dropout, so at S = 2048 their attention takes the flash
    route with the kernels' own mask; AMP and Adam with ``train``, else
    the forward alone (the same parameter names). Returns (main, startup,
    loss, the last layer's output)."""
    from paddle_tpu_torch.models import transformer as tfm

    seq, d = LONGCTX_SEQ, LONGCTX["d_model"]
    dk = d // LONGCTX["n_head"]
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 7
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        ids = fluid.layers.data("ids", shape=[seq], dtype="int64")
        lbl = fluid.layers.data("lbl", shape=[seq, 1], dtype="int64")
        x = tfm.embed_inputs(ids, LONGCTX["vocab_size"], d, seq, "lm",
                             dropout_rate=0.0)
        for i in range(n_layer):
            x = tfm.encoder_layer(
                x, None, LONGCTX["n_head"], dk, dk, d, LONGCTX["d_inner"],
                dropout_rate=0.0, name="lm_l%d" % i,
                ffn_act={"type": "gelu", "approximate": True},
                inner_dropout=0, attn_dropout=0.1, causal=True)
        out = x
        logits = fluid.layers.fc(tfm._pre_norm(x), size=LONGCTX["vocab_size"],
                                 num_flatten_dims=2, name="lm_head")
        loss = fluid.layers.mean(
            fluid.layers.softmax_with_cross_entropy(logits, lbl))
        if train:
            fluid.amp.decorate(
                fluid.optimizer.Adam(learning_rate=1e-4)).minimize(loss)
    return main, startup, loss, out


def flash_dropout_captured_phase(flash_rows):
    """The repair of the flash route's dropout seed: ``build_flash_dropout``
    (2 causal layers at full ``LONGCTX`` width, batch 8 x 2048, AMP) run
    eagerly and captured from one start (``captured_leg``: losses within
    1e-3 (AMP) at every step, bit-equality reported, K1a-c once a layer and
    K2 once inside one replay, no host sync in an eager step). Then its
    forward run twice on one batch with the same parameters: the outputs
    must differ (each step draws its own mask, on the card)."""
    import paddle_tpu_torch as fluid

    t_phase = time.perf_counter()
    dev = fluid.CUDAPlace(0)
    main, startup, loss, _ = build_flash_dropout(fluid)
    scope = fluid.Scope()
    exe = fluid.Executor(dev)
    exe.run(startup, scope=scope)
    feeds = [longctx_feed(LONGCTX_BATCH, LONGCTX_SEQ, seed=i)
             for i in range(CAPTURED_STEPS)]
    per_step = {k: (pat, FLASH_DROPOUT_LAYERS) for k, pat in K1_NAMES.items()}
    per_step.update({k: (pat, 1) for k, pat in K2_NAMES.items()})
    counts = captured_leg("flash_dropout_captured", main, loss, scope, feeds,
                          True, per_step)
    for row, kern in zip(flash_rows, K1_NAMES):
        row.setdefault("captured_launches_a_step", {})[
            "flash_dropout_amp"] = counts[kern]
    fwd, _, _, out = build_flash_dropout(fluid, train=False)
    dfeed = {k: torch.as_tensor(v, device=dev) for k, v in feeds[0].items()}
    a = exe.run(fwd, feed=dfeed, fetch_list=[out], scope=scope,
                return_numpy=False)[0].clone()
    b = exe.run(fwd, feed=dfeed, fetch_list=[out], scope=scope,
                return_numpy=False)[0]
    differ = float((a.float() - b.float()).abs().max())
    check(bool(torch.isfinite(a).all()) and differ > 0,
          "flash_dropout: two steps of the forward on one batch gave the "
          "same output (largest difference %g): the mask did not change"
          % differ)
    emit("flash_dropout_masks", layers=FLASH_DROPOUT_LAYERS,
         batch=LONGCTX_BATCH, seq=LONGCTX_SEQ, attn_dropout=0.1,
         output_max_abs_diff_between_steps=differ,
         phase_seconds=time.perf_counter() - t_phase)
    del scope, exe
    torch.cuda.empty_cache()


def accum_train_phase(xent_rows):
    """Gradient accumulation on the card, Transformer-base (``TRAIN``),
    through ``Executor.run`` of a ``CompiledProgram`` with
    ``BuildStrategy.gradient_accumulation_steps = ACCUM``: (a) float32,
    dropout 0, batch 64: 3 accumulated steps (two eager warm-ups, then one
    captured) against 3 plain ``run()`` steps from one start: losses within
    1e-5 relative, the first step's gradients (every parameter's, as one
    vector) within 1e-3 norm-wise of the full batch's and within 1e-6 of
    the mean of the gradients each microbatch gives alone (a plain step at
    batch 16 from the start state), the state after 3 steps within 1e-4
    norm-wise of the full batch's. A microbatch's forward takes other GEMM
    kernels than the full batch's, so the accumulated gradients differ from
    the full batch's by more than the sums' order would (1.27e-4 measured,
    the state 1.94e-5; PERF.md); (b) AMP (dropout 0.1) at a global batch
    of ``ACCUM`` x 64: peak memory against a batch-64 step's, step ms eager
    (the captured step's body run eagerly, ``eager_accumulated``) and
    captured in turns; (c) the captured accumulated steps (``run_steps``,
    one graph for all microbatches) against eager ones from one start,
    each run as the first step of a new ``Executor``, which runs it as an
    eager warm-up: losses within 1e-3 relative (AMP) and the state,
    bit-equality reported; one capture. K2a/K2b launch once a
    microbatch."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.executor import WARMUP_STEPS
    from paddle_tpu_torch.monitor import metrics
    from paddle_tpu_torch.ops.kernels import softmax_xent as sx

    t_phase = time.perf_counter()
    dev = fluid.CUDAPlace(0)
    exe = fluid.Executor(dev)

    def accumulated(main, loss):
        bs = fluid.BuildStrategy()
        bs.gradient_accumulation_steps = ACCUM
        return fluid.CompiledProgram(main).with_data_parallel(
            loss_name=loss.name, build_strategy=bs)

    # (a) accumulation against the full batch
    main, startup, loss, _ = build_transformer(fluid, train=True, dropout=0.0,
                                               amp=False, **TRAIN)
    plain = fluid.Scope()
    exe.run(startup, scope=plain)
    start = clone_scope(fluid, plain)
    acc = clone_scope(fluid, plain)
    feeds = [train_feed(TRAIN_BATCH, seed=i) for i in range(3)]
    grads = sorted(main._backward_info["param_to_grad"].values())
    first = exe.run(main, feed=feeds[0], fetch_list=[loss] + grads,
                    scope=plain, return_numpy=False)
    want = [float(first[0])] + [
        float(exe.run(main, feed=f, fetch_list=[loss], scope=plain)[0])
        for f in feeds[1:]]
    prog = accumulated(main, loss)
    exe_a = fluid.Executor(dev)
    caps0 = metrics.CAPTURES.value
    sx.LAUNCHES_FWD = sx.LAUNCHES_BWD = 0
    outs = [exe_a.run(prog, feed=f, fetch_list=[loss] + grads, scope=acc,
                      return_numpy=False) for f in feeds]
    k2 = (sx.LAUNCHES_FWD, sx.LAUNCHES_BWD)
    captures_a = metrics.CAPTURES.value - caps0
    got = [float(o[0]) for o in outs]
    first_acc = outs[0][1:]
    del outs
    exe_a.close()
    # each microbatch alone, a plain step from the start state: the mean of
    # their gradients, summed in the accumulation's order, is what the
    # accumulated step must hold
    m = TRAIN_BATCH // ACCUM
    mean = None
    for i in range(ACCUM):
        sub = {k: v[i * m:(i + 1) * m] for k, v in feeds[0].items()}
        g = exe.run(main, feed=sub, fetch_list=grads,
                    scope=clone_scope(fluid, start), return_numpy=False)
        mean = g if mean is None else [a + b for a, b in zip(mean, g)]
    mean = [a / ACCUM for a in mean]
    grad_micro = norm_diff(first_acc, mean)
    micro_equal = all(torch.equal(a, b) for a, b in zip(first_acc, mean))
    err_a = loss_rel_err(got, want)
    grad_a = norm_diff(first_acc, first[1:])
    state_a, state_a_var, _ = state_norm_err(acc, plain)
    tol_a = {"losses": 1e-5, "gradients_from_full_batch": 1e-3,
             "gradients_from_microbatch_mean": 1e-6, "state": 1e-4}
    check(err_a <= tol_a["losses"]
          and grad_a <= tol_a["gradients_from_full_batch"]
          and grad_micro <= tol_a["gradients_from_microbatch_mean"]
          and state_a <= tol_a["state"],
          "accumulation %d against the full batch: losses %r against %r "
          "(%.3g); gradients %.3g norm-wise from the full batch's, %.3g "
          "from the mean of the microbatches' own; state after 3 steps "
          "%.3g (tolerances %r)" % (ACCUM, got, want, err_a, grad_a,
                                    grad_micro, state_a, tol_a))
    check(captures_a == 1, "accumulation %d: %d captures in %d steps of "
          "run(CompiledProgram)" % (ACCUM, captures_a, len(feeds)))
    del first, first_acc, mean, start
    check(k2 == (ACCUM * len(feeds),) * 2,
          "accumulated steps launched K2 %r over %d steps of %d microbatches"
          % (k2, len(feeds), ACCUM))
    for row, n in zip(xent_rows, k2):
        row["launches_accum"] = n
    del plain, acc, exe_a
    torch.cuda.empty_cache()

    # (b) and (c): AMP at a global batch of ACCUM x 64
    main, startup, loss, _ = build_transformer(fluid, train=True, amp=True,
                                               **TRAIN)
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    small = train_feed(TRAIN_BATCH)
    train_steps(exe, main, loss, small, scope, 2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    train_steps(exe, main, loss, small, scope, 1)
    peak_64 = torch.cuda.max_memory_allocated()
    big = [train_feed(ACCUM * TRAIN_BATCH, seed=i)
           for i in range(CAPTURED_STEPS)]
    cap = clone_scope(fluid, scope)
    step0 = getattr(main, "_tpu_step_counter", 0)
    prog = accumulated(main, loss)
    torch.cuda.reset_peak_memory_stats()
    eager = [float(fluid.Executor(dev).run(prog, feed=f, fetch_list=[loss],
                                           scope=scope)[0])
             for f in big]
    peak_accum_eager = torch.cuda.max_memory_allocated()
    main._tpu_step_counter = step0
    exe_c = fluid.Executor(dev)
    caps0, reps0 = metrics.CAPTURES.value, metrics.REPLAYS.value
    torch.cuda.reset_peak_memory_stats()
    captured = [float(r[0]) for r in exe_c.run_steps(
        prog, big, fetch_list=[loss], fetch_every=len(big), scope=cap)]
    peak_accum_captured = torch.cuda.max_memory_allocated()
    captures = metrics.CAPTURES.value - caps0
    replays = metrics.REPLAYS.value - reps0
    err_c = loss_rel_err(captured, eager)
    _, state_c, equal_c = state_norm_err(cap, scope)
    check(err_c <= 1e-3 and state_c <= 1e-3,
          "captured accumulated steps: losses %r vs eager %r (%.3g), state "
          "%.3g norm-wise (tolerance 1e-3)" % (captured, eager, err_c,
                                               state_c))
    check((captures, replays) == (1, len(big) - WARMUP_STEPS),
          "accumulated step: %d captures and %d replays" % (captures,
                                                           replays))
    dfeed = {k: torch.as_tensor(v, device=dev) for k, v in big[0].items()}
    syncs = host_syncs(
        lambda: eager_accumulated(exe, main, scope, dfeed, loss, ACCUM))
    check(not syncs, "accum_train: an eager accumulated step syncs the "
          "host: %s" % syncs)

    def eager_run(k):
        for _ in range(k):
            eager_accumulated(exe, main, scope, dfeed, loss, ACCUM)

    def captured_run(k):
        exe_c.run_steps(prog, (dfeed for _ in range(k)), steps=k,
                        fetch_list=[loss], fetch_every=k, scope=cap,
                        return_numpy=False)

    medians, turns = time_in_turns({"eager": eager_run,
                                    "captured": captured_run})
    emit("accum_train", accumulation_steps=ACCUM,
         full_batch_check={"mode": "float32", "batch": TRAIN_BATCH,
                           "losses_accum": got, "losses_plain": want,
                           "max_rel_diff": err_a,
                           "grad_norm_diff_from_microbatch_mean":
                               grad_micro,
                           "grads_bit_equal_to_microbatch_mean":
                               micro_equal,
                           "grad_norm_diff_from_full_batch": grad_a,
                           "state_norm_diff_after_3_steps": state_a,
                           "largest_var_norm_diff": state_a_var,
                           "captures": captures_a, "tolerance": tol_a},
         global_batch=ACCUM * TRAIN_BATCH, mode="bfloat16_amp",
         losses_eager=eager, losses_captured=captured,
         loss_max_rel_diff=err_c, state_max_norm_diff=state_c,
         bit_equal=bool(captured == eager and equal_c), tolerance=1e-3,
         captures=captures, replays=replays,
         peak_memory_batch64_step=peak_64,
         peak_memory_accum_eager=peak_accum_eager,
         peak_memory_accum_captured=peak_accum_captured,
         step_ms_eager=medians["eager"], step_ms_captured=medians["captured"],
         step_ms_turns=turns,
         tokens_per_s_captured=ACCUM * TRAIN_BATCH * TRAIN["seq"]
         / (medians["captured"] / 1e3),
         k2_launches_float32={"fwd": k2[0], "bwd": k2[1]},
         eager_host_syncs=len(syncs),
         phase_seconds=time.perf_counter() - t_phase)
    exe_c.close()
    del scope, cap, exe, exe_c
    torch.cuda.empty_cache()


# -- the zoo: VGG-16, SE-ResNeXt-50, LARS, word2vec, the conv family ---------


class OpCalls:
    """Counts the calls of some of the port's registered op implementations
    while active (each wrapped in the registry, restored on exit)."""

    def __init__(self, *types):
        self.counts = dict.fromkeys(types, 0)

    def __enter__(self):
        from paddle_tpu_torch.core import registry

        self._saved = {t: registry._OP_REGISTRY[t] for t in self.counts}
        for t, impl in self._saved.items():
            def counted(ctx, t=t, impl=impl):
                self.counts[t] += 1
                impl(ctx)
            registry._OP_REGISTRY[t] = counted
        return self

    def __exit__(self, *exc):
        from paddle_tpu_torch.core import registry

        registry._OP_REGISTRY.update(self._saved)


def zero_dropout(main):
    """Dropout off, for a card-vs-CPU comparison (the two devices draw
    different masks)."""
    for op in main.global_block.ops:
        if op.type == "dropout":
            op.attrs["dropout_prob"] = 0.0


def build_vgg(fluid, amp, image=RESNET_IMAGE, classes=RESNET_CLASSES):
    """``paddle_tpu/models/vgg.py``'s VGG-16 with batch norm under
    ``Adam(1e-3)``, the optimizer of Paddle's benchmark ``vgg.py``."""
    from paddle_tpu_torch.models import vgg

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        img = fluid.layers.data("img", shape=[3, image, image])
        label = fluid.layers.data("label", shape=[1], dtype="int64")
        loss, _ = vgg.vgg16(img, label, class_num=classes)
        opt = fluid.optimizer.Adam(1e-3)
        if amp:
            opt = fluid.amp.decorate(opt)
        opt.minimize(loss)
    return main, startup, loss


def build_se_resnext(fluid, amp, image=RESNET_IMAGE, classes=RESNET_CLASSES,
                     layers_cfg=(3, 4, 6, 3), cardinality=32,
                     base_filters=(128, 256, 512, 1024), lr=0.1):
    """``se_resnext()`` as it builds by default (SE-ResNeXt-50, 32 x 4d)
    under the published recipe's Momentum(lr, 0.9) with L2Decay(1e-4), at
    a constant rate (the port has no learning-rate scheduler)."""
    from paddle_tpu_torch.models import se_resnext

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        img = fluid.layers.data("img", shape=[3, image, image])
        label = fluid.layers.data("label", shape=[1], dtype="int64")
        loss, _ = se_resnext.se_resnext(
            img, label, class_num=classes, layers_cfg=layers_cfg,
            cardinality=cardinality, base_filters=base_filters)
        opt = fluid.optimizer.Momentum(
            lr, 0.9, regularization=fluid.regularizer.L2Decay(1e-4))
        if amp:
            opt = fluid.amp.decorate(opt)
        opt.minimize(loss)
    return main, startup, loss


def k2_by_shape(xent_rows, leg, n, v, dt, steps):
    """Check K2a and K2b at one launch a step at [n, v] in ``dt`` and none
    elsewhere since ``LAUNCHES_BY_SHAPE`` was cleared; record each count in
    the kernel rows under ``leg``. Returns the counts by shape."""
    from paddle_tpu_torch.ops.kernels import softmax_xent as sx

    by_shape = dict(sx.LAUNCHES_BY_SHAPE)
    want = {(kern, n, v, dt): steps for kern in ("K2a", "K2b")}
    check(by_shape == want, "%s: K2 launches by (kernel, N, V, dtype) %r "
          "over %d steps, want %r" % (leg, by_shape, steps, want))
    field = "word2vec_shapes" if (n, v) == (W2V_BATCH, W2V["dict_size"]) \
        else "vision_shapes"
    for row, kern in zip(xent_rows, ("K2a", "K2b")):
        row[field][vision_key(n, v, dt)].setdefault("launches_by_leg", {})[
            leg] = by_shape.get((kern, n, v, dt), 0)
    return {"%s_%s" % (k, vision_key(n_, v_, d)): c
            for (k, n_, v_, d), c in sorted(by_shape.items(), key=str)}


def grouped_conv_ms(main, batch, dtype):
    """Each grouped conv2d shape of ``main`` (groups > 1) at ``batch``,
    forward and both gradients timed by CUDA events on its own, times the
    number of such convs a step: (ms a step, [per shape])."""
    F = torch.nn.functional
    blk = main.global_block
    shapes = {}
    for op in blk.ops:
        if op.type == "backward_marker":
            break
        if op.type == "conv2d" and op.attrs.get("groups", 1) > 1:
            key = (tuple(blk.var(op.inputs["Input"][0]).shape[1:]),
                   tuple(blk.var(op.inputs["Filter"][0]).shape),
                   tuple(op.attrs["strides"]), tuple(op.attrs["paddings"]),
                   op.attrs["groups"])
            shapes[key] = shapes.get(key, 0) + 1
    dev = torch.device("cuda", torch.cuda.current_device())
    flush = l2_flusher(dev)
    total, rows = 0.0, []
    for (xs, ws, st, pd, g), count in shapes.items():
        x = torch.randn((batch,) + xs, device=dev, dtype=dtype,
                        requires_grad=True)
        w = torch.randn(ws, device=dev, dtype=dtype, requires_grad=True)
        dy = torch.randn_like(F.conv2d(x, w, None, st, pd, 1, g))

        def fwd_bwd():
            y = F.conv2d(x, w, None, st, pd, 1, g)
            torch.autograd.grad(y, [x, w], dy)

        ms = cuda_ms(fwd_bwd, reps=10, flush=flush)
        total += count * ms
        rows.append({"input": list(xs), "filter": list(ws), "stride": st[0],
                     "groups": g, "count": count, "fwd_bwd_ms": ms})
        del x, w, dy
    del flush
    torch.cuda.empty_cache()
    return total, rows


def conv_device_ms_by_kind(step):
    """One ``step()`` under torch.profiler with the ops' input shapes: the
    device ms of the kernels each convolution and its backward launch
    (``aten::convolution``, ``aten::convolution_backward``), summed by
    kind: "grouped" where the filter's input channels are fewer than the
    input's (groups > 1), else "dense"."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        step()
    kinds = {k: {"device_ms": 0.0, "count": 0} for k in ("grouped", "dense")}
    for e in prof.key_averages(group_by_input_shape=True):
        if e.key == "aten::convolution":
            x, w = e.input_shapes[0], e.input_shapes[1]
        elif e.key == "aten::convolution_backward":
            x, w = e.input_shapes[1], e.input_shapes[2]
        else:
            continue
        kind = kinds["grouped" if x[1] != w[1] else "dense"]
        kind["device_ms"] += e.device_time_total / 1e3
        kind["count"] += e.count
    return kinds


def zoo_train(leg, build, amp, xent_rows, **extra):
    """One vision leg of the zoo at full width: the program ``build(fluid,
    amp)`` on 64 x 3 x 224 x 224 images (``resnet_feed``), cuDNN's
    algorithm search on, ``ZOO_WARM`` warm-up and ``ZOO_TIMED`` timed
    steps (their median the step time), K2a/K2b once a step at [64, 1000]
    in the leg's dtype (counted by shape), every loss finite and the
    parameters float32; one step profiled. Returns (exe, scope, main,
    loss, feed, losses, fields of its line)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.ops.kernels import softmax_xent as sx

    mode = "bfloat16_amp" if amp else "float32"
    t0 = time.perf_counter()
    main, startup, loss = build(fluid, amp)
    build_s = time.perf_counter() - t0
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CUDAPlace(0))
    exe.run(startup, scope=scope)
    torch.cuda.synchronize()
    params = main.all_parameters()
    ops = [op.type for op in main.global_block.ops]
    flop = 3 * forward_flops(main, RESNET_BATCH)
    bound_ms = flop / (H100_BF16_FLOP_PER_S if amp
                       else H100_F32_FLOP_PER_S) * 1e3
    feed = resnet_feed(RESNET_BATCH)
    warm, warm_secs = train_steps(exe, main, loss, feed, scope, ZOO_WARM)
    torch.cuda.reset_peak_memory_stats()
    sx.LAUNCHES_BY_SHAPE.clear()
    with OpCalls("sum") as calls:
        losses, secs = train_steps(exe, main, loss, feed, scope, ZOO_TIMED)
    peak = torch.cuda.max_memory_allocated()
    dt = torch.bfloat16 if amp else torch.float32
    by_shape = k2_by_shape(xent_rows, leg + "_" + mode, RESNET_BATCH,
                           RESNET_CLASSES, dt, ZOO_TIMED)
    all_losses = warm + losses
    masters = {str(scope.find_var(p.name).dtype) for p in params}
    check(bool(np.isfinite(all_losses).all()),
          "non-finite %s loss (%s): %r" % (leg, mode, all_losses))
    check(masters == {"torch.float32"}, "%s parameters not float32: %r"
          % (leg, masters))
    busy, by_group = train_profile_phase(
        exe, main, loss, feed, scope, phase=leg + "_profile_" + mode,
        groups=RESNET_GROUPS)
    step_ms = float(np.median(secs)) * 1e3
    fields = dict(
        mode=mode, batch=RESNET_BATCH, image=RESNET_IMAGE,
        classes=RESNET_CLASSES, params=len(params),
        weights=sum(int(np.prod(p.shape)) for p in params), ops=len(ops),
        conv2d=ops.count("conv2d"), batch_norm=ops.count("batch_norm"),
        cudnn_benchmark=torch.backends.cudnn.benchmark, build_s=build_s,
        warm_ms=[x * 1e3 for x in warm_secs], steps=len(all_losses),
        timed_steps=len(losses), step_ms_median=step_ms,
        step_ms=[x * 1e3 for x in secs],
        images_per_s=RESNET_BATCH / (step_ms / 1e3),
        peak_memory_bytes=peak, device_busy_share=busy,
        conv_device_ms=by_group["conv_cudnn"]["device_ms"],
        train_flop=flop, compute_bound_ms=bound_ms,
        compute_bound_share=bound_ms / step_ms, losses=all_losses,
        k2_launches_by_shape=by_shape, sum_calls=calls.counts["sum"],
        nvidia_smi=SMI[0], **extra)
    return exe, scope, main, loss, feed, all_losses, fields


def vgg_train_phase(xent_rows, amp):
    """VGG-16 with batch norm (``paddle_tpu/models/vgg.py``: five conv
    groups, dropout 0.5 and a 2-D batch norm after the first fc) at 64 x 3
    x 224 x 224, 1000 classes, Adam(1e-3), in float32 or under
    ``fluid.amp.decorate``: K2 once a step at [64, 1000], the last of the
    six losses below the first (``tests/test_models.py``'s
    ``test_vgg16_tiny_step`` rule)."""
    prev = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = True
    exe, scope, main, loss, feed, losses, fields = zoo_train(
        "vgg", build_vgg, amp, xent_rows, optimizer="Adam", lr=1e-3)
    emit("vgg_train", **fields)
    check(losses[-1] < losses[0], "VGG-16 loss did not fall (%s): %r"
          % (fields["mode"], losses))
    torch.backends.cudnn.benchmark = prev
    del scope, exe
    torch.cuda.empty_cache()


def se_resnext_train_phase(xent_rows, amp):
    """SE-ResNeXt-50 as ``se_resnext()`` builds it by default
    (``layers_cfg`` (3, 4, 6, 3), cardinality 32, base filters 128-1024)
    at 64 x 3 x 224 x 224, 1000 classes, Momentum(0.1, 0.9) with
    L2Decay(1e-4) at a constant rate, in float32 or under AMP: K2 once a
    step at [64, 1000], the weight decay's ``sum`` once a parameter a
    step, every loss finite and the first step descending (the
    ``resnet_train`` rule). The grouped convolutions are timed alone at
    their shapes in the leg's dtype (forward and both gradients, times
    their count) and in one profiled step (the device ms their ops
    launch, ``conv_device_ms_by_kind``). Under AMP also the captured leg
    (``captured_leg``)."""
    dt = torch.bfloat16 if amp else torch.float32
    prev = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = True
    exe, scope, main, loss, feed, losses, fields = zoo_train(
        "se_resnext", build_se_resnext, amp, xent_rows,
        optimizer="Momentum+L2Decay(1e-4)", lr=0.1, momentum=0.9)
    n_params = len(main.all_parameters())
    by_kind = conv_device_ms_by_kind(
        lambda: train_steps(exe, main, loss, feed, scope, 1))
    grouped_ms, grouped = grouped_conv_ms(main, RESNET_BATCH, dt)
    emit("se_resnext_train", conv_device_ms_by_kind=by_kind,
         grouped_conv_ms_a_step=grouped_ms, grouped_convs=grouped, **fields)
    check(losses[1] < losses[0], "SE-ResNeXt-50's first step did not "
          "descend (%s): %r" % (fields["mode"], losses))
    check(fields["sum_calls"] == n_params * ZOO_TIMED,
          "SE-ResNeXt-50: %d sum calls over %d steps, want one a parameter "
          "(%d) a step" % (fields["sum_calls"], ZOO_TIMED, n_params))
    if amp:
        counts = captured_leg(
            "se_resnext_captured", main, loss, scope,
            [resnet_feed(RESNET_BATCH, seed=i)
             for i in range(CAPTURED_STEPS)], amp,
            {k: (pat, 1) for k, pat in K2_NAMES.items()})
        for row, kern in zip(xent_rows, K2_NAMES):
            row.setdefault("captured_launches_a_step", {})[
                "se_resnext_amp"] = counts[kern]
    torch.backends.cudnn.benchmark = prev
    del scope, exe
    torch.cuda.empty_cache()


def lars_train_phase():
    """ResNet-50 as ``build_resnet`` builds it for ``resnet_train`` (64 x
    224, float32), once under LarsMomentumOptimizer(0.1, 0.9) (coefficient
    0.001, decay 0.0005) and once under Momentum(0.1, 0.9): 2 warm-up
    steps each, then 3 turns of 2 steps of each, the median the step time.
    One ``lars_momentum`` a parameter a step; losses finite; an eager LARS
    step on feeds already on the card syncs the host nowhere (the norms
    and the choice stay on the card, so the step captures)."""
    import paddle_tpu_torch as fluid

    prev = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = True
    legs = {}
    for name, lars in (("lars", True), ("momentum", False)):
        main, startup, loss, _ = build_resnet(fluid, False, lars=lars)
        scope = fluid.Scope()
        exe = fluid.Executor(fluid.CUDAPlace(0))
        exe.run(startup, scope=scope)
        legs[name] = [exe, main, loss, scope, []]
    feed = resnet_feed(RESNET_BATCH)
    dfeed = {k: torch.as_tensor(v, device="cuda") for k, v in feed.items()}
    losses = {}
    for name, (exe, main, loss, scope, _) in legs.items():
        losses[name] = train_steps(exe, main, loss, feed, scope, 2)[0]
    n_params = len(legs["lars"][1].all_parameters())
    with OpCalls("lars_momentum") as calls:
        for _ in range(3):
            for name, (exe, main, loss, scope, secs) in legs.items():
                ls, ss = train_steps(exe, main, loss, dfeed, scope, 2)
                losses[name] += ls
                secs += ss
    exe, main, loss, scope, _ = legs["lars"]
    syncs = host_syncs(lambda: exe.run(main, feed=dfeed, fetch_list=[loss],
                                       scope=scope, return_numpy=False))
    step = {name: float(np.median(leg[4])) * 1e3
            for name, leg in legs.items()}
    emit("lars_train", model="resnet50", batch=RESNET_BATCH,
         image=RESNET_IMAGE, mode="float32", lr=0.1, momentum=0.9,
         lars_coeff=0.001, lars_weight_decay=0.0005,
         step_ms_median=step, step_ms={n: [x * 1e3 for x in leg[4]]
                                       for n, leg in legs.items()},
         images_per_s={n: RESNET_BATCH / (ms / 1e3)
                       for n, ms in step.items()},
         lars_over_momentum_ms=step["lars"] - step["momentum"],
         lars_momentum_calls=calls.counts["lars_momentum"],
         params=n_params, losses=losses, eager_host_syncs=syncs,
         nvidia_smi=SMI[0])
    for name, ls in losses.items():
        check(bool(np.isfinite(ls).all()),
              "non-finite ResNet-50 %s loss: %r" % (name, ls))
    check(calls.counts["lars_momentum"] == n_params * 6,
          "%d lars_momentum calls in 6 steps, want one a parameter (%d) a "
          "step" % (calls.counts["lars_momentum"], n_params))
    check(not syncs, "an eager LARS step syncs the host: %s" % syncs)
    torch.backends.cudnn.benchmark = prev
    del legs, exe, scope
    torch.cuda.empty_cache()


def build_word2vec(fluid):
    """The book's N-gram model (``tests/book/test_word2vec.py``) at its
    widths under SGD(0.001)."""
    from paddle_tpu_torch.models import word2vec

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        words = [fluid.layers.data(n, shape=[1], dtype="int64")
                 for n in ("firstw", "secondw", "thirdw", "forthw", "nextw")]
        loss, _ = word2vec.word2vec_ngram(*words, **W2V)
        fluid.optimizer.SGD(0.001).minimize(loss)
    return main, startup, loss


def ngram_feed(seed=0):
    """Synthetic 5-grams whose fifth word is (w0 + w1) mod V
    (``tests/test_models.py``), batch 100."""
    rng = np.random.RandomState(seed)
    v = W2V["dict_size"]
    ctx = rng.randint(0, v, (W2V_BATCH, 4)).astype("int64")
    feed = {n: ctx[:, j:j + 1]
            for j, n in enumerate(("firstw", "secondw", "thirdw", "forthw"))}
    feed["nextw"] = ((ctx[:, 0] + ctx[:, 1]) % v).reshape(-1, 1)
    return feed


def word2vec_train_phase(xent_rows, steps=10):
    """The book's word2vec (V = 2073, embedding 32, hidden 256, batch 100,
    SGD(0.001)) on the card from a CPU startup carried by
    ``io.state_from_numpy``, ``steps`` steps at ``PADDLE_TPU_OPT_LEVEL`` 1,
    where the fuse pass turns ``softmax`` + ``cross_entropy`` into K2a/K2b
    (once a step each at [100, 2073]), and at level 0 (no K2); the losses
    fall at both, and the level-1 card run matches the CPU's within 1e-5
    relative at every step. Words a second: predicted words (one an
    example) over the median step."""
    import os

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.ops.kernels import softmax_xent as sx

    main, startup, loss = build_word2vec(fluid)
    init = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=init)
    arrays = {n: init.as_numpy(n) for n in init.vars}
    feed = ngram_feed()
    prev = os.environ.get("PADDLE_TPU_OPT_LEVEL")
    out = {}
    try:
        for level in (1, 0):
            os.environ["PADDLE_TPU_OPT_LEVEL"] = str(level)
            scope = fluid.io.state_from_numpy(main, arrays, fluid.Scope(),
                                              fluid.CUDAPlace(0))
            exe = fluid.Executor(fluid.CUDAPlace(0))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            sx.LAUNCHES_BY_SHAPE.clear()
            losses, secs = train_steps(exe, main, loss, feed, scope, steps)
            by_shape = dict(sx.LAUNCHES_BY_SHAPE)
            if level:
                k2_by_shape(xent_rows, "word2vec", W2V_BATCH,
                            W2V["dict_size"], torch.float32, steps)
            else:
                check(not by_shape, "word2vec at level 0 launched K2: %r"
                      % by_shape)
            peak = torch.cuda.max_memory_allocated()
            busy, _ = train_profile_phase(
                exe, main, loss, feed, scope,
                phase="word2vec_profile_level%d" % level)
            step_ms = float(np.median(secs[1:])) * 1e3
            out[level] = dict(
                losses=losses, step_ms_median=step_ms,
                step_ms=[x * 1e3 for x in secs],
                words_per_s=W2V_BATCH / (step_ms / 1e3),
                peak_memory_bytes=peak, device_busy_share=busy,
                k2_launches_by_shape={"%s_%s" % (k, vision_key(n, v, d)): c
                                      for (k, n, v, d), c
                                      in sorted(by_shape.items(), key=str)})
            check(bool(np.isfinite(losses).all()) and losses[-1] < losses[0],
                  "word2vec losses at level %d: %r" % (level, losses))
        os.environ["PADDLE_TPU_OPT_LEVEL"] = "1"
        cpu = fluid.io.state_from_numpy(main, arrays, fluid.Scope(),
                                        fluid.CPUPlace())
        cpu_losses, _ = train_steps(fluid.Executor(fluid.CPUPlace()), main,
                                    loss, feed, cpu, steps)
    finally:
        if prev is None:
            os.environ.pop("PADDLE_TPU_OPT_LEVEL", None)
        else:
            os.environ["PADDLE_TPU_OPT_LEVEL"] = prev
    rel = max(abs(a - b) / abs(b) for a, b in zip(out[1]["losses"],
                                                  cpu_losses))
    emit("word2vec_train", config=W2V, batch=W2V_BATCH, optimizer="SGD",
         lr=0.001, steps=steps, level1=out[1], level0=out[0],
         cpu_losses=cpu_losses, card_vs_cpu_max_rel=rel, tol=1e-5,
         nvidia_smi=SMI[0])
    check(rel <= 1e-5, "word2vec card %r vs CPU %r losses (rel %g)"
          % (out[1]["losses"], cpu_losses, rel))
    torch.cuda.empty_cache()


def run_op(op_type, attrs, inputs, out_slot, cot=None):
    """The port's registered op on ``inputs`` ({slot: tensor}); with a
    cotangent ``cot``, also the gradients of every input. Returns (out,
    {slot: grad})."""
    from types import SimpleNamespace

    from paddle_tpu_torch.core.registry import OpContext, get_op_impl

    names = sorted(inputs)
    op = SimpleNamespace(type=op_type, attrs=dict(attrs), block=None,
                         inputs={k: [k] for k in names},
                         outputs={out_slot: ["out"]})
    env = dict(inputs)
    with torch.set_grad_enabled(cot is not None):
        get_op_impl(op_type)(OpContext(op, env, None))
    out = env["out"]
    if cot is None:
        return out, {}
    grads = torch.autograd.grad(out, [inputs[n] for n in names], cot)
    return out, dict(zip(names, grads))


# DCGAN's generator transposes: (C_in, C_out, input size)
DCGAN = [(1024, 512, 4), (512, 256, 7), (256, 128, 13)]
# the 3-D cases' batch: 4 clips (at 8 their float64 CPU references took
# most of the phase's time)
C3D_BATCH = 4


def conv_family_cases():
    """The new convolution and pooling ops at their sources' widths:
    DCGAN's generator transposes (Radford et al. 2015: 1024 -> 512 -> 256
    -> 128 channels, 5 x 5, stride 2 from 4 x 4, batch 64; padding 2, so
    4 -> 7 -> 13 -> 25 without an output size), a depthwise transpose
    [64, 256, 32, 32] (groups 256, 4 x 4, stride 2), C3D's conv2/pool2
    (Tran et al. 2015: [C3D_BATCH, 64, 16, 56, 56] -> 128 channels, 3^3,
    pad 1; pool 2^3) and a 3-D transpose [C3D_BATCH, 128, 8, 28, 28] ->
    64, 2^3, stride 2. Yields (name, op, input shape, filter shape, attrs,
    slot)."""
    t2 = {"strides": [2, 2], "paddings": [2, 2], "dilations": [1, 1],
          "groups": 1}
    for ci, co, hw in DCGAN:
        yield ("dcgan_%d_%d" % (ci, co), "conv2d_transpose",
               (64, ci, hw, hw), (ci, co, 5, 5), t2, "Output")
    yield ("depthwise_transpose", "depthwise_conv2d_transpose",
           (64, 256, 32, 32), (256, 1, 4, 4),
           {"strides": [2, 2], "paddings": [1, 1], "dilations": [1, 1],
            "groups": 256}, "Output")
    yield ("c3d_conv2", "conv3d", (C3D_BATCH, 64, 16, 56, 56),
           (128, 64, 3, 3, 3),
           {"strides": [1] * 3, "paddings": [1] * 3, "dilations": [1] * 3,
            "groups": 1}, "Output")
    for ptype in ("max", "avg"):
        yield ("c3d_pool2_" + ptype, "pool3d", (C3D_BATCH, 128, 16, 56, 56),
               None,
               {"pooling_type": ptype, "ksize": [2] * 3, "strides": [2] * 3,
                "paddings": [0] * 3}, "Out")
    yield ("conv3d_transpose", "conv3d_transpose",
           (C3D_BATCH, 128, 8, 28, 28), (128, 64, 2, 2, 2),
           {"strides": [2] * 3, "paddings": [0] * 3, "dilations": [1] * 3,
            "groups": 1}, "Output")


def conv_flop(op_type, x_shape, w_shape, out_shape):
    """Forward FLOP: 2 a multiply-add. A conv: every output element sums
    C_in/g·k... products; a transpose: every input element scatters into
    C_out/g·k... outputs (its filter is [C_in, C_out/g, k...])."""
    if w_shape is None:
        return 0
    if "transpose" in op_type:
        return 2 * int(np.prod(x_shape)) * int(np.prod(w_shape[1:]))
    return 2 * int(np.prod(out_shape)) * int(np.prod(w_shape[1:]))


def conv_family_phase():
    """Each case of ``conv_family_cases`` through the port's op: forward
    and both gradients (input and filter; pooling the input) on the card
    in float32 against the same op on the CPU in float64, to 1e-4
    norm-wise, and in bf16 against the same float64, to 1e-2. The inputs
    and the cotangent are drawn as bf16 values, so the float32 and bf16
    runs read the same numbers and one CPU run serves both. Times by CUDA
    events (forward, forward + gradients), each with its bound: FLOP over
    67 TFLOP/s (float32) or 989 (bf16) for a conv, bytes (input read,
    output written) over 3.35 TB/s for a pool."""
    prev = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = True
    dev = torch.device("cuda", torch.cuda.current_device())
    flush = l2_flusher(dev)
    for seed, (name, op, xs, ws, attrs, slot) in enumerate(
            conv_family_cases()):
        rng = np.random.RandomState(seed)

        def bf16_values(a):
            return torch.tensor(a).to(torch.bfloat16).double()

        ref_in = {("Input" if ws is not None else "X"):
                  bf16_values(rng.randn(*xs))}
        if ws is not None:
            ref_in["Filter"] = bf16_values(rng.randn(*ws)
                                           / np.sqrt(np.prod(ws[1:])))
        for v in ref_in.values():
            v.requires_grad_(True)
        # the output's shape from a float32 run on the card: the float64
        # reference runs once, with the cotangent
        shape = run_op(op, attrs, {k: v.detach().to(dev, torch.float32)
                                   for k, v in ref_in.items()}, slot)[0].shape
        cot = bf16_values(np.random.RandomState(99).randn(*shape))
        want, want_g = run_op(op, attrs, ref_in, slot, cot)
        want = want.detach().numpy()
        want_g = {k: g.numpy() for k, g in want_g.items()}
        row = {"name": name, "op": op, "input": list(xs),
               "filter": None if ws is None else list(ws), "attrs": attrs}
        for dt, tol in ((torch.float32, 1e-4), (torch.bfloat16, 1e-2)):
            key = str(dt).replace("torch.", "")
            ins = {k: v.detach().to(dev, dt).requires_grad_(True)
                   for k, v in ref_in.items()}
            dcot = cot.to(dev, dt)
            out, grads = run_op(op, attrs, ins, slot, dcot)
            errs = {"out": norm_err(out.detach().double().cpu().numpy(),
                                    want)}
            for k, g in grads.items():
                errs["d" + k] = norm_err(g.double().cpu().numpy(),
                                         want_g[k])
            check(max(errs.values()) <= tol, "%s %s: card vs CPU float64 "
                  "%r (tolerance %g)" % (name, key, errs, tol))

            def fwd(ins=ins):
                run_op(op, attrs, ins, slot)

            def fwd_bwd(ins=ins, dcot=dcot):
                run_op(op, attrs, ins, slot, dcot)

            flop = conv_flop(op, xs, ws, tuple(out.shape))
            nbytes = (int(np.prod(xs)) + out.numel()) * out.element_size()
            peak = H100_BF16_FLOP_PER_S if dt == torch.bfloat16 \
                else H100_F32_FLOP_PER_S
            bound = max(flop / peak, nbytes / H100_BYTES_PER_S) * 1e3
            fms = cuda_ms(fwd, reps=10, flush=flush)
            row[key] = {"output": list(out.shape), "max_err": errs,
                        "tol": tol, "fwd_ms": fms,
                        "fwd_bwd_ms": cuda_ms(fwd_bwd, reps=10, flush=flush),
                        "fwd_flop": flop, "fwd_bound_ms": bound,
                        "fwd_bound_share": bound / fms}
            del ins, out, grads, dcot
        emit("conv_family", nvidia_smi=SMI[0], **row)
        del ref_in, want, want_g, cot
    torch.backends.cudnn.benchmark = prev
    del flush
    torch.cuda.empty_cache()


def zoo_parity_phase():
    """VGG-16 at 3 x 32 x 32 (batch 4, 10 classes) and SE-ResNeXt at
    ``layers_cfg=(1, 1)``, cardinality 8, base (32, 64) (the CPU tests'
    sizes), dropout 0, one step on the card and on the CPU from one CPU
    startup carried by ``io.state_from_numpy``, cuDNN deterministic, TF32
    off: the first losses within 1e-4 relative in float32 and 2e-2 under
    AMP."""
    import paddle_tpu_torch as fluid

    prev = torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    feed = resnet_feed(4, 32, 10)
    builds = {
        "vgg16": lambda amp: build_vgg(fluid, amp, image=32, classes=10),
        "se_resnext": lambda amp: build_se_resnext(
            fluid, amp, image=32, classes=10, layers_cfg=(1, 1),
            cardinality=8, base_filters=(32, 64), lr=0.01)}
    for model, build in builds.items():
        for amp in (False, True):
            main, startup, loss = build(amp)
            zero_dropout(main)
            init = fluid.Scope()
            fluid.Executor(fluid.CPUPlace()).run(startup, scope=init)
            arrays = {n: init.as_numpy(n) for n in init.vars}
            got = {}
            for dev in ("card", "cpu"):
                place = fluid.CUDAPlace(0) if dev == "card" \
                    else fluid.CPUPlace()
                scope = fluid.io.state_from_numpy(main, arrays,
                                                  fluid.Scope(), place)
                got[dev] = train_steps(fluid.Executor(place), main, loss,
                                       feed, scope, 1)[0][0]
            rel = abs(got["card"] - got["cpu"]) / abs(got["cpu"])
            tol = 2e-2 if amp else 1e-4
            emit("zoo_parity", model=model,
                 mode="bfloat16_amp" if amp else "float32", image=32,
                 batch=4, card_loss=got["card"], cpu_loss=got["cpu"],
                 rel_err=rel, tol=tol)
            check(rel <= tol, "%s first loss card %r vs CPU %r (rel %g)"
                  % (model, got["card"], got["cpu"], rel))
    torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic = prev
    torch.cuda.empty_cache()


# -- slice 15: the optimizer family, gradient clipping, lr schedules --------

LR_COUNTER = "@LR_DECAY_COUNTER@"
# Devlin et al.'s BERT recipe (google-research/bert optimization.py): peak
# rate 1e-4, linear warm-up over 10,000 steps, then linear decay to 0. The
# one cut: warm-up and decay scaled to the smoke's steps (2 and 8), so that
# both branches of the schedule run
RECIPE_PEAK, RECIPE_WARMUP, RECIPE_DECAY = 1e-4, 2, 8
# Fluid's Transformer (PaddlePaddle/models neural_machine_translation/
# transformer/config.py): noam_decay(d_model, 8000) * 2.0, Adam(0.9, 0.997,
# 1e-9)
NOAM_D_MODEL, NOAM_WARMUP, NOAM_SCALE = 512, 8000, 2.0
# the ops after the backward marker (the optimizer tail), by group
TAIL_GROUPS = {"squared_l2_norm": "clip", "sum": "clip", "sqrt": "clip",
               "fill_constant": "clip", "elementwise_max": "clip",
               "elementwise_div": "clip", "elementwise_mul": "clip",
               "adam": "update", "adamw": "update", "lamb": "update",
               "scale": "update"}
# tensors of the parameters' size each group must move at the least: the
# update reads p, g, m, v and writes p, m, v; the clip reads g for its norm,
# then reads and writes it scaled. LAMB's trust ratio needs the update's
# norm before p is written, so one pass holds the update or a second one
# recomputes it (p, m, v read again): 10 tensors
TAIL_PASSES = {"update": 7, "clip": 3, "lamb_two_pass": 10}


class Recipe:
    """An optimizer factory for the builders that keeps the rate it
    schedules (``lr``): "adamw" / "lamb" Devlin's recipe (the global-norm
    clip at 1.0, ``linear_lr_warmup(polynomial_decay(...))``, weight decay
    0.01), "noam" Fluid's Transformer recipe."""

    def __init__(self, name):
        self.name, self.lr = name, None

    def __call__(self, fluid):
        layers = fluid.layers
        if self.name == "noam":
            self.lr = layers.noam_decay(NOAM_D_MODEL, NOAM_WARMUP) \
                * NOAM_SCALE
            return fluid.optimizer.Adam(self.lr, beta1=0.9, beta2=0.997,
                                        epsilon=1e-9)
        self.lr = layers.linear_lr_warmup(
            layers.polynomial_decay(RECIPE_PEAK, RECIPE_DECAY, 0.0, 1.0),
            RECIPE_WARMUP, 0.0, RECIPE_PEAK)
        fluid.clip.set_gradient_clip(
            fluid.clip.GradientClipByGlobalNorm(1.0))
        if self.name == "adamw":
            return fluid.optimizer.AdamW(self.lr, weight_decay=0.01,
                                         epsilon=1e-6)
        return fluid.optimizer.Lamb(self.lr, lamb_weight_decay=0.01)


def recipe_rate(step):
    """Devlin's rate at counter value ``step`` (0 at the first step), as
    Fluid computes the nested schedule (one increment a step)."""
    if step < RECIPE_WARMUP:
        return RECIPE_PEAK * step / RECIPE_WARMUP
    return RECIPE_PEAK * (1.0 - min(step, RECIPE_DECAY) / RECIPE_DECAY)


def noam_rate(step):
    """The Transformer recipe's rate at counter value ``step`` (1 first)."""
    return NOAM_SCALE * NOAM_D_MODEL ** -0.5 * min(
        step ** -0.5, step * NOAM_WARMUP ** -1.5)


def rate_err(got, want):
    """The largest relative difference of fetched rates from the host's
    closed form; a rate of 0 must come out exactly 0."""
    return max((abs(g - w) / abs(w)) if w else (0.0 if g == 0 else np.inf)
               for g, w in zip(got, want))


def tail_device_ms(exe, main, fetch, scope, feed, reps=20):
    """Device time of the optimizer tail by group (``TAIL_GROUPS``): the
    inputs the ops after the backward marker read in one eager step, then
    each group's ops (a contiguous run of them) captured alone into a CUDA
    graph and replayed ``reps`` times between CUDA events, so its kernels
    run back to back with no host gap between launches; CUPTI's busy ms
    and kernel count of one replay beside it."""
    import paddle_tpu_torch.executor as ex
    from paddle_tpu_torch.serving.captured import gc_paused

    names = fetch_names(fetch)
    opt = exe._maybe_optimize(main, names, scope)
    ops = opt.global_block.ops
    marker = next(i for i, op in enumerate(ops)
                  if op.type == "backward_marker")
    seen = {}
    inner = ex.run_block_ops

    def spy(ops_, env, trace, offset=0):
        if offset == marker + 1 and not seen:
            seen.update(env=dict(env), trace=trace)
        return inner(ops_, env, trace, offset)

    ex.run_block_ops = spy
    try:
        exe.run(main, feed=feed, fetch_list=fetch, scope=scope,
                return_numpy=False)
    finally:
        ex.run_block_ops = inner
    post = ops[marker + 1:]
    segs = []
    for i, op in enumerate(post):
        g = TAIL_GROUPS.get(op.type, "other")
        if segs and segs[-1][0] == g:
            segs[-1][1].append(i)
        else:
            segs.append((g, [i]))
    env, out = seen["env"], {}
    side = torch.cuda.Stream()
    for g, idxs in segs:
        seg = [post[i] for i in idxs]
        offset = marker + 1 + idxs[0]
        nxt = dict(env)
        with torch.no_grad():
            inner(seg, nxt, seen["trace"], offset)
        graph = torch.cuda.CUDAGraph()
        side.wait_stream(torch.cuda.current_stream())
        with torch.no_grad(), gc_paused(), torch.cuda.graph(graph,
                                                            stream=side):
            inner(seg, dict(env), seen["trace"], offset)
        torch.cuda.current_stream().wait_stream(side)
        graph.replay()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0.record()
        for _ in range(reps):
            graph.replay()
        t1.record()
        torch.cuda.synchronize()
        _, busy, kern, _, _, _ = step_profile(graph.replay)
        row = out.setdefault(g, {"ms": 0.0, "device_ms": 0.0, "ops": 0,
                                 "kernels": 0})
        row["ms"] += t0.elapsed_time(t1) / reps
        row["device_ms"] += busy
        row["ops"] += len(seg)
        row["kernels"] += sum(kern.values())
        graph.reset()
        del graph
        env = nxt
    del seen, env
    torch.cuda.empty_cache()
    return out


def eval_loss(fluid, exe, test_main, loss, scope, feed):
    """The loss of ``feed`` at dropout 0 (``test_main``, the program's
    ``clone(for_test=True)``) on a copy of ``scope``: the clone keeps the
    schedule's ``increment``, which must not move the leg's counter. K2's
    launch counters are left as they were."""
    from paddle_tpu_torch.ops.kernels import softmax_xent as sx

    saved = (sx.LAUNCHES_FWD, sx.LAUNCHES_BWD, dict(sx.LAUNCHES_BY_SHAPE))
    copy = clone_scope(fluid, scope)
    out = float(exe.run(test_main, feed=feed, fetch_list=[loss],
                        scope=copy)[0])
    del copy
    sx.LAUNCHES_FWD, sx.LAUNCHES_BWD = saved[:2]
    sx.LAUNCHES_BY_SHAPE.clear()
    sx.LAUNCHES_BY_SHAPE.update(saved[2])
    return out


def bits_checksum(t):
    """Two int64 sums over a tensor's bits (its words, and its words
    weighted by position modulo a prime): equal for bit-equal tensors,
    unequal for almost any other pair. Integer sums do not depend on their
    order, so the checksum itself is reproducible."""
    t = t.detach().contiguous().reshape(-1)
    if t.numel() == 0:
        return torch.zeros(2, dtype=torch.int64, device=t.device)
    word = {1: torch.uint8, 2: torch.int16, 4: torch.int32,
            8: torch.int64}[t.element_size()]
    w = t.view(word).to(torch.int64)
    pos = torch.arange(1, w.numel() + 1, device=t.device) % 1_000_003
    return torch.stack([w.sum(), (w * pos).sum()])


class OpTrace:
    """While installed, every op the executor runs records the checksum
    (``bits_checksum``) of each tensor it writes, keyed by (step, op index,
    op type, var), and each forward output that carries a gradient records
    the checksum of the gradient that reaches it (a tensor hook: it runs in
    the backward, and inside a CUDA graph capture it is captured with the
    step). ``result()`` reads them on the host."""

    def __init__(self):
        self.step, self.fwd, self.grads = 0, {}, {}

    def __enter__(self):
        import paddle_tpu_torch.executor as ex
        from paddle_tpu_torch.core.interpreter import SKIP_OPS
        from paddle_tpu_torch.core.registry import OpContext, get_op_impl

        self.inner = ex.run_block_ops

        def traced(ops, env, trace, offset=0):
            for i, op in enumerate(ops):
                if op.type in SKIP_OPS:
                    continue
                trace.current_op_idx = offset + i
                get_op_impl(op.type)(OpContext(op, env, trace))
                for n in op.output_arg_names:
                    v = env.get(n)
                    if not isinstance(v, torch.Tensor):
                        continue
                    key = (self.step, offset + i, op.type, n)
                    self.fwd[key] = bits_checksum(v)
                    if v.requires_grad and torch.is_grad_enabled():
                        v.register_hook(
                            lambda g, key=key: self.grads.__setitem__(
                                key, bits_checksum(g)))

        ex.run_block_ops = traced
        return self

    def __exit__(self, *exc):
        import paddle_tpu_torch.executor as ex

        ex.run_block_ops = self.inner

    def result(self):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        return ({k: tuple(v.tolist()) for k, v in self.fwd.items()},
                {k: tuple(v.tolist()) for k, v in self.grads.items()})


def first_parting(a, b, ops, n=6):
    """Where two ``OpTrace`` results part: the first forward outputs (in
    program order) and the first gradients (in backward order: the
    gradient of a later op's output first) whose bits differ, each with
    the types of the ops that read the var (a gradient that differs while
    its consumers' output gradients agree was made by their backward)."""
    fa, ga = a
    fb, gb = b
    fwd = [k for k in fa if k in fb and fa[k] != fb[k]]
    order = sorted((k for k in ga if k in gb),
                   key=lambda k: (k[0], -k[1]))
    grad = [k for k in order if ga[k] != gb[k]]

    def readers(k):
        return sorted({op.type for op in ops[k[1] + 1:]
                       if k[3] in op.input_arg_names})

    return {"forward_differing": len(fwd), "forward_compared": len(
        [k for k in fa if k in fb]),
        "forward_first": [list(k) + [readers(k)] for k in fwd[:n]],
        "grads_differing": len(grad), "grads_compared": len(order),
        "grads_first": [list(k) + [readers(k)] for k in grad[:n]]}


def recipe_bisect(name, steps=CAPTURED_STEPS, deterministic=False):
    """Where the recipe step parts run to run on the card (BERT-base AMP,
    the bench's batch, ``Recipe(name)``, or the bench's constant Adam for
    "adam"): two eager runs of ``steps`` steps from one start with every
    op's outputs and gradients checksummed (``OpTrace``), compared step by
    step; an eager run inside ``torch.cuda.stream(side)`` and the captured
    run (``run_steps`` one step a call: two warm-ups on the executor's
    side stream, the capture, replays), each against the first; three
    untraced eager reruns' whole states; one eager step's kernels counted
    twice. ``deterministic``: the same under
    ``torch.use_deterministic_algorithms(True, warn_only=True)`` (the
    process must have ``CUBLAS_WORKSPACE_CONFIG`` set before CUDA
    starts), with the ops torch flags as nondeterministic."""
    import warnings

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.executor import WARMUP_STEPS

    t0 = time.perf_counter()
    dev = fluid.CUDAPlace(0)
    recipe = Recipe(name) if name != "adam" else None
    main, startup, loss = build_bert(fluid, True, optimizer=recipe)
    lr = recipe.lr if recipe else main.global_block.var(main._lr_var_name)
    fetch = [loss, lr]
    start = fluid.Scope()
    fluid.Executor(dev).run(startup, scope=start)
    feed = bert_feed(BERT_BATCH)
    exe0 = fluid.Executor(dev)
    ops = exe0._maybe_optimize(main, fetch_names(fetch), start) \
        .global_block.ops
    caught = []
    if deterministic:
        torch.use_deterministic_algorithms(True, warn_only=True)

    def run(mode, traced=True):
        scope = clone_scope(fluid, start)
        main._tpu_step_counter = 0
        exe = fluid.Executor(dev)
        tr = OpTrace()
        losses = []
        side = torch.cuda.Stream()
        with warnings.catch_warnings(record=True) as w, \
                (tr if traced else contextlib.nullcontext()):
            warnings.simplefilter("always")
            for i in range(steps):
                tr.step = i
                if mode == "captured":
                    out = exe.run_steps(main, [feed], fetch_list=fetch,
                                        scope=scope)[0]
                    if traced and i == WARMUP_STEPS:
                        # the graph's own checksum tensors, which each
                        # replay writes anew
                        live = [{k[1:]: v for k, v in d.items()
                                 if k[0] == i} for d in (tr.fwd, tr.grads)]
                    if traced and i >= WARMUP_STEPS:
                        for d, lv in zip((tr.fwd, tr.grads), live):
                            d.update({(i,) + k: v.clone()
                                      for k, v in lv.items()})
                elif mode == "side":
                    side.wait_stream(torch.cuda.current_stream())
                    with torch.cuda.stream(side):
                        out = exe.run(main, feed=feed, fetch_list=fetch,
                                      scope=scope)
                    torch.cuda.current_stream().wait_stream(side)
                else:
                    out = exe.run(main, feed=feed, fetch_list=fetch,
                                  scope=scope)
                losses.append(float(np.ravel(out[0])[0]))
            res = tr.result() if traced else None
        caught.extend(str(x.message)[:200] for x in w)
        exe.close()
        return scope, losses, res

    e1, l1, r1 = run("eager")
    e2, l2, r2 = run("eager")
    out = {"recipe": name, "deterministic": deterministic,
           "eager_vs_eager": dict(first_parting(r1, r2, ops),
                                  losses_equal=l1 == l2,
                                  state=state_norm_err(e2, e1),
                                  most_different=most_different(e2, e1))}
    del e2, r2
    s, ls, rs = run("side")
    out["side_stream_vs_eager"] = dict(
        first_parting(r1, rs, ops), losses_equal=ls == l1,
        state=state_norm_err(s, e1), most_different=most_different(s, e1))
    del s, rs
    c, lc, rc = run("captured")
    out["captured_vs_eager"] = dict(
        first_parting(r1, rc, ops), losses_equal=lc == l1,
        state=state_norm_err(c, e1), most_different=most_different(c, e1))
    del c, rc, r1
    u = [run("eager", traced=False) for _ in range(3)]
    out["untraced_reruns"] = [dict(losses_equal=x[1] == u[0][1],
                                   state=state_norm_err(x[0], u[0][0]),
                                   most_different=most_different(x[0],
                                                                 u[0][0]))
                              for x in u[1:]]
    out["traced_vs_untraced_state"] = state_norm_err(u[0][0], e1)
    scope = u[0][0]
    del u

    def one_step():
        exe0.run(main, feed=feed, fetch_list=fetch, scope=scope,
                 return_numpy=False)

    one_step()
    counts = [step_profile(one_step)[2] for _ in range(2)]
    out["eager_kernels"] = [sum(c.values()) for c in counts]
    out["eager_kernels_differing"] = {
        k: [counts[0].get(k, 0), counts[1].get(k, 0)]
        for k in set(counts[0]) | set(counts[1])
        if counts[0].get(k, 0) != counts[1].get(k, 0)}
    if deterministic:
        torch.use_deterministic_algorithms(False)
        out["nondeterministic_alerts"] = sorted(
            {m for m in caught if "deterministic" in m})
    exe0.close()
    out["seconds"] = time.perf_counter() - t0
    emit("recipe_bisect", **out)
    return out


def fetch_names(fetch):
    return tuple(v if isinstance(v, str) else v.name for v in fetch)


def scheduled_leg(leg, main, loss, lr, scope, feeds, rate_fn, begin,
                  per_step, tail=True):
    """One program's recipe eager, then captured, from one start state on
    ``feeds``: each eager ``run()`` and each step of ``run_steps`` (two
    warm-ups, one capture, replays) fetches the loss, the scheduled rate
    ``lr`` and, when ``rate_fn`` is given, the step counter. The rates
    must equal ``rate_fn`` of the counter on the host (1e-6 relative; a
    constant rate must stay what it was), the counter run ``begin``,
    ``begin + 1``, ..., the captured losses and each tensor of the state
    equal the eager ones norm-wise (1e-3, the AMP tolerance: every leg
    runs under AMP; bit-equality reported), the same eager steps rerun
    from the start bit-equal, one capture and
    ``len(feeds) - 2`` replays, no host sync in an eager step, and each
    kernel of ``per_step`` at its count in one replay (the profiles as
    ``captured_leg``'s); with ``tail``, the optimizer tail's device ms
    (``tail_device_ms``). Returns the leg's
    numbers and its ``eager_step`` / ``captured_steps(k)`` for the timing
    in turns (the executors stay open: close them with ``close``)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.executor import WARMUP_STEPS
    from paddle_tpu_torch.monitor import metrics
    from paddle_tpu_torch.ops.kernels import softmax_xent as sx

    t_leg = time.perf_counter()
    dev = fluid.CUDAPlace(0)
    n = len(feeds)
    fetch = [loss, lr] + ([LR_COUNTER] if rate_fn else [])
    scope_c = clone_scope(fluid, scope)
    scope_r = clone_scope(fluid, scope)
    step0 = getattr(main, "_tpu_step_counter", 0)
    exe = fluid.Executor(dev)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    sx.LAUNCHES_BY_SHAPE.clear()
    f0, b0 = sx.LAUNCHES_FWD, sx.LAUNCHES_BWD
    eager, secs, eval_losses = [], [], []
    test_main = main.clone(for_test=True)
    params = [p.name for p in main.all_parameters()]
    first_rate0_kept = None
    for i, f in enumerate(feeds):
        if rate_fn and i < 3:
            # the dropout-0 loss of the first feed before each of the first
            # steps: the start, after the rate-0 step, after the first step
            # that moves the weights
            eval_losses.append(eval_loss(fluid, exe, test_main, loss, scope,
                                         feeds[0]))
        t0 = time.perf_counter()
        eager.append([float(np.ravel(v)[0]) for v in exe.run(
            main, feed=f, fetch_list=fetch, scope=scope)])
        secs.append(time.perf_counter() - t0)
        if i == 0 and rate_fn and rate_fn(begin) == 0:
            first_rate0_kept = all(torch.equal(scope.find_var(n),
                                               scope_c.find_var(n))
                                   for n in params)
    peak_e = torch.cuda.max_memory_allocated()
    k2 = {"fwd": sx.LAUNCHES_FWD - f0, "bwd": sx.LAUNCHES_BWD - b0}
    k2_by_shape = {"%s_%s" % (k, vision_key(r, v, d)): c for (k, r, v, d), c
                   in sorted(sx.LAUNCHES_BY_SHAPE.items(), key=str)}
    by_shape = dict(sx.LAUNCHES_BY_SHAPE)
    main._tpu_step_counter = step0
    exe_c = fluid.Executor(dev)
    caps0, reps0 = metrics.CAPTURES.value, metrics.REPLAYS.value
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rows = exe_c.run_steps(main, feeds, fetch_list=fetch, fetch_every=n,
                           scope=scope_c)
    run_steps_s = time.perf_counter() - t0
    peak_c = torch.cuda.max_memory_allocated()
    got = [[float(np.ravel(v)[0]) for v in r] for r in rows]
    captures = metrics.CAPTURES.value - caps0
    replays = metrics.REPLAYS.value - reps0
    losses_e, rates_e = [r[0] for r in eager], [r[1] for r in eager]
    losses_c, rates_c = [r[0] for r in got], [r[1] for r in got]
    if rate_fn:
        counters_e = [int(r[2]) for r in eager]
        counters_c = [int(r[2]) for r in got]
        want_rates = [rate_fn(c) for c in counters_e]
        check(counters_e == counters_c == list(range(begin, begin + n)),
              "%s: counter eager %r, captured %r, want %d..%d"
              % (leg, counters_e, counters_c, begin, begin + n - 1))
    else:
        counters_e = counters_c = None
        want_rates = [rates_e[0]] * n
    err_e, err_c = rate_err(rates_e, want_rates), rate_err(rates_c,
                                                           want_rates)
    check(err_e <= 1e-6 and err_c <= 1e-6,
          "%s: rates eager %r, captured %r against the closed form %r "
          "(relative %.3g / %.3g > 1e-6)"
          % (leg, rates_e, rates_c, want_rates, err_e, err_c))
    tol = 1e-3
    # the same eager steps again from the same start: how far two eager
    # runs of the step part on the card
    main._tpu_step_counter = step0
    rerun = [float(exe.run(main, feed=f, fetch_list=[loss],
                           scope=scope_r)[0]) for f in feeds]
    rerun_whole, rerun_worst, rerun_equal = state_norm_err(scope_r, scope)
    del scope_r
    loss_err = loss_rel_err(losses_c, losses_e)
    whole_err, state_err, state_equal = state_norm_err(scope_c, scope)
    differing = most_different(scope_c, scope)
    check(bool(np.isfinite(losses_e + losses_c).all()),
          "%s: non-finite loss: %r / %r" % (leg, losses_e, losses_c))
    # each tensor of the state norm-wise. The step's gradients used to
    # part between two eager runs and between streams (a 4,096-fold
    # repeated embedding row summed by F.embedding's backward, which
    # LAMB's trust ratio spread to 1.5 % in a second moment); the port's
    # lookup gradient now takes torch's deterministic path, so two eager
    # runs of the leg from one start must be bit-equal, and captured
    # against eager is held tensor by tensor
    check(loss_err <= tol and state_err <= tol,
          "%s: captured losses %r against eager %r (%.3g), the most "
          "different tensor %.3g norm-wise (tolerance %g): %r"
          % (leg, losses_c, losses_e, loss_err, state_err, tol, differing))
    check(rerun == losses_e and rerun_equal,
          "%s: two eager runs from one start parted: losses %r / %r, state "
          "%.3g whole, %.3g in one tensor" % (leg, rerun, losses_e,
                                              rerun_whole, rerun_worst))
    check((captures, replays) == (1, n - WARMUP_STEPS),
          "%s: %d captures and %d replays in %d steps" % (leg, captures,
                                                          replays, n))
    dfeed = {k: torch.as_tensor(v, device=dev) for k, v in feeds[0].items()}

    def eager_step():
        exe.run(main, feed=dfeed, fetch_list=fetch, scope=scope,
                return_numpy=False)

    def captured_steps(k):
        return exe_c.run_steps(main, (dfeed for _ in range(k)), steps=k,
                               fetch_list=fetch, fetch_every=k,
                               scope=scope_c, return_numpy=False)

    syncs = host_syncs(eager_step)
    check(not syncs, "%s: an eager step syncs the host: %s" % (leg, syncs))
    wall_e, busy_e, kern_e, _, calls_e, _ = step_profile(eager_step,
                                                         cpu_ops=False)
    (wall_c, busy_c, kern_c, graph_launches, calls_c, _), counts, tries = \
        replay_profile(lambda: captured_steps(1), per_step, cpu_ops=False)
    want = {name: c for name, (_, c) in per_step.items()}
    check(graph_launches == 1 and counts == want,
          "%s: %d graph launches, kernels in one replay %r, want %r; each "
          "profile taken %r" % (leg, graph_launches, counts, want, tries))
    tail = tail_device_ms(exe, main, fetch, scope, dfeed) if tail else None

    def close():
        exe.close()
        exe_c.close()

    return {"release_graphs": exe_c.close,
        "numbers": dict(
            steps=n, warmup_steps=WARMUP_STEPS, captures=captures,
            replays=replays, losses_eager=losses_e, losses_captured=losses_c,
            rates_eager=rates_e, rates_captured=rates_c,
            rates_closed_form=want_rates, rate_rel_err=max(err_e, err_c),
            counters=counters_e, loss_max_rel_diff=loss_err,
            state_max_norm_diff=state_err, state_whole_norm_diff=whole_err,
            state_most_different=differing,
            eager_rerun_losses_equal=rerun == losses_e,
            eager_rerun_state_whole_norm_diff=rerun_whole,
            eager_rerun_state_max_norm_diff=rerun_worst,
            eager_rerun_bit_equal=bool(rerun_equal and rerun == losses_e),
            bit_equal=bool(losses_c == losses_e and state_equal),
            tolerance=tol, eager_step_ms=[x * 1e3 for x in secs],
            rate0_step_kept_params=first_rate0_kept,
            eval_losses_dropout0=eval_losses,
            k2_launches_eager=k2, k2_launches_by_shape=k2_by_shape,
            kernels_a_replay=counts, replay_profiles=tries,
            launches_eager=sum(kern_e.values()),
            launches_captured=sum(kern_c.values()),
            host_launch_calls_eager=calls_e,
            host_launch_calls_captured=calls_c,
            busy_share_eager=busy_e / wall_e,
            busy_share_captured=busy_c / wall_c,
            device_busy_ms_eager=busy_e, device_busy_ms_captured=busy_c,
            eager_host_syncs=len(syncs), run_steps_s=run_steps_s,
            peak_memory_eager=peak_e, peak_memory_captured=peak_c,
            memory_at_leg_start=base, tail=tail,
            leg_seconds=time.perf_counter() - t_leg),
        "by_shape": by_shape, "eager_step": eager_step,
        "captured_steps": captured_steps, "close": close,
        "scopes": (scope, scope_c)}


def turns_of(runs):
    """``time_in_turns`` over the eager and captured steps of ``runs``
    ({leg: scheduled_leg result}); returns (medians, all blocks)."""
    legs = {}
    for name, run in runs.items():
        legs[name + "_eager"] = (
            lambda k, step=run["eager_step"]: [step() for _ in range(k)])
        legs[name + "_captured"] = run["captured_steps"]
    return time_in_turns(legs)


def bert_recipe_train_phase(xent_rows):
    """BERT-base pretraining at full width and depth (``bench_bert``: 32 x
    128, 20 masked, dropout 0.1) under AMP, with Devlin et al.'s recipe:
    ``AdamW(weight_decay=0.01, epsilon=1e-6)`` (leg a) or
    ``Lamb(lamb_weight_decay=0.01)`` (leg b), the global-norm clip at 1.0
    and ``linear_lr_warmup(polynomial_decay(1e-4, 8, 0, 1), 2, 0, 1e-4)``
    (warm-up and decay cut from 10,000 steps to the smoke's), each
    ``scheduled_leg`` on the bench's fixed batch: K2a/K2b once a step at
    [640, 30522] and [32, 2] (by shape), the rates Fluid's closed form,
    the counter the steps run, captured = eager. Then the captured and
    eager steps of both legs and of ``bench_bert``'s Adam(1e-4) program in
    turns: step ms, sequences/s, busy share, peak memory, and the device
    ms of the optimizer tail by group beside its byte bound."""
    import paddle_tpu_torch as fluid

    t_phase = time.perf_counter()
    dev = fluid.CUDAPlace(0)
    dt = torch.bfloat16
    shapes = ((BERT_BATCH * BERT_MASK, BERT_VOCAB), (BERT_BATCH, 2))
    per_step = {k: (pat, 2) for k, pat in K2_NAMES.items()}
    feed = bert_feed(BERT_BATCH)
    runs, weights = {}, None
    for name in ("adamw", "lamb", "adam"):
        recipe = Recipe(name) if name != "adam" else None
        main, startup, loss = build_bert(fluid, True, optimizer=recipe)
        lr = recipe.lr if recipe else main.global_block.var(
            main._lr_var_name)
        if weights is None:
            weights = sum(int(np.prod(p.shape))
                          for p in main.all_parameters())
        types_ = [op.type for op in main.global_block.ops]
        scope = fluid.Scope()
        fluid.Executor(dev).run(startup, scope=scope)
        run = scheduled_leg(
            "bert_recipe_" + name, main, loss, lr, scope,
            [feed] * CAPTURED_STEPS, recipe_rate if recipe else None, 0,
            per_step)
        want = {(kern, r, v, dt): CAPTURED_STEPS
                for kern in ("K2a", "K2b") for r, v in shapes}
        check(run["by_shape"] == want,
              "bert_recipe_%s: K2 launches by shape %r, want %r"
              % (name, run["by_shape"], want))
        nums = run["numbers"]
        nums["ops"] = {t: types_.count(t) for t in (
            "increment", "squared_l2_norm", "adamw", "lamb", "adam")}
        if recipe:
            # the first step's rate is 0 (Fluid's warm-up from 0): it must
            # leave every parameter as it was. The next step is the first
            # that moves the weights: under LAMB (each layer moved by ~5e-5
            # of its norm) it must lower the dropout-0 loss of the batch;
            # under AdamW at this cut warm-up (the peak rate at step 2) it
            # raises it, as the bench's Adam(1e-4) does at its first step:
            # reported, not checked
            evals = nums["eval_losses_dropout0"]
            nums["first_moving_step_descends"] = evals[2] < evals[1]
            check(nums["rate0_step_kept_params"] is True,
                  "bert_recipe_%s: the rate-0 step moved a parameter" % name)
            check(name != "lamb" or nums["first_moving_step_descends"],
                  "bert_recipe_lamb: the first step that moves the weights "
                  "did not lower the dropout-0 loss: %r" % evals)
            for row, kern in zip(xent_rows, ("K2a", "K2b")):
                for r, v in shapes:
                    row["bert_shapes"][vision_key(r, v, dt)].setdefault(
                        "launches_by_leg", {})["bert_recipe_" + name] = \
                        run["by_shape"].get((kern, r, v, dt), 0)
        runs[name] = run
    medians, blocks = turns_of(runs)
    n_bytes = weights * 4
    bound_ms = {g: n_bytes * k / H100_BYTES_PER_S * 1e3
                for g, k in TAIL_PASSES.items()}
    for name, run in runs.items():
        nums = run["numbers"]
        step_c = medians[name + "_captured"]
        emit("bert_recipe_train", leg=name, mode="bfloat16_amp",
             config="BERT_BASE_CONFIG", batch=BERT_BATCH, seq=BERT_SEQ,
             n_mask=BERT_MASK, dropout=0.1, weights=weights,
             recipe={"adamw": "AdamW(0.01, eps 1e-6) + global norm 1.0",
                     "lamb": "Lamb(0.01) + global norm 1.0",
                     "adam": "Adam(1e-4), constant"}[name],
             warmup_steps_schedule=RECIPE_WARMUP if name != "adam" else None,
             decay_steps_schedule=RECIPE_DECAY if name != "adam" else None,
             reduced="warm-up 10,000 -> 2 steps, decay -> 8 steps"
             if name != "adam" else None,
             step_ms_eager=medians[name + "_eager"], step_ms_captured=step_c,
             sequences_per_s_captured=BERT_BATCH / (step_c / 1e3),
             sequences_per_s_eager=BERT_BATCH
             / (medians[name + "_eager"] / 1e3),
             step_ms_turns={m: blocks[name + "_" + m]
                            for m in ("eager", "captured")},
             tail_bound_ms=bound_ms, tail_bytes_one_tensor=n_bytes,
             nvidia_smi=SMI[0], **nums)
        run["close"]()
    del runs
    torch.cuda.empty_cache()
    emit("bert_recipe_phase", seconds=time.perf_counter() - t_phase)


def transformer_noam_train_phase(xent_rows):
    """``bench_transformer`` (6+6 layers, d_model 512, 64 x 256, vocab
    30000, label smoothing 0.1, dropout 0.1) under AMP with Fluid's
    Transformer recipe, ``noam_decay(512, 8000) * 2.0`` and Adam(0.9,
    0.997, 1e-9), as ``scheduled_leg`` on the bench's fixed batch: K2a/K2b
    once a step, the rate the closed form, the counter 1, 2, ...,
    captured = eager; then eager and captured steps in turns with the
    bench's constant-rate Adam(1e-4) program: step ms of both and the eager
    launch delta."""
    import paddle_tpu_torch as fluid

    t_phase = time.perf_counter()
    dev = fluid.CUDAPlace(0)
    per_step = {k: (pat, 1) for k, pat in K2_NAMES.items()}
    feed = train_feed(TRAIN_BATCH)
    runs = {}
    for name in ("noam", "adam"):
        recipe = Recipe(name) if name == "noam" else None
        main, startup, loss = build_bench_transformer(fluid, optimizer=recipe)
        lr = recipe.lr if recipe else main.global_block.var(
            main._lr_var_name)
        scope = fluid.Scope()
        fluid.Executor(dev).run(startup, scope=scope)
        run = scheduled_leg("transformer_" + name, main, loss, lr, scope,
                            [feed] * CAPTURED_STEPS,
                            noam_rate if recipe else None, 1, per_step)
        nums = run["numbers"]
        check(nums["k2_launches_eager"] == {"fwd": CAPTURED_STEPS,
                                            "bwd": CAPTURED_STEPS},
              "transformer_%s: K2 launches %r over %d steps"
              % (name, nums["k2_launches_eager"], CAPTURED_STEPS))
        runs[name] = run
    medians, blocks = turns_of(runs)
    delta = runs["noam"]["numbers"]["launches_eager"] - \
        runs["adam"]["numbers"]["launches_eager"]
    for name, run in runs.items():
        emit("transformer_noam_train", leg=name, mode="bfloat16_amp",
             config=TRAIN, batch=TRAIN_BATCH,
             recipe="noam_decay(512, 8000) * 2.0, Adam(0.9, 0.997, 1e-9)"
             if name == "noam" else "Adam(1e-4), constant",
             step_ms_eager=medians[name + "_eager"],
             step_ms_captured=medians[name + "_captured"],
             step_ms_turns={m: blocks[name + "_" + m]
                            for m in ("eager", "captured")},
             eager_launch_delta_noam_minus_adam=delta,
             nvidia_smi=SMI[0], **run["numbers"])
        run["close"]()
    for row, kern in zip(xent_rows, ("K2a", "K2b")):
        row.setdefault("launches_by_leg", {})["transformer_noam"] = \
            runs["noam"]["numbers"]["k2_launches_eager"][
                "fwd" if kern == "K2a" else "bwd"]
    del runs
    torch.cuda.empty_cache()
    emit("transformer_noam_phase", seconds=time.perf_counter() - t_phase)


# -- the dense op remainder and dist_transformer.py's loss --------------------


def kernel_device_ms(step):
    """``step()`` once under torch.profiler: {kernel name: [launches,
    device ms]} (copies and memsets left out)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    return {e.key: [e.count, e.self_device_time_total / 1e3]
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and not e.key.startswith(("Memcpy", "Memset"))}


# kernel kinds of the loss's ops, by name (the first pattern that matches)
LOSS_KINDS = (("one_hot (compare, cast)", r"CompareEq|compare|eq_kernel"),
              ("log_softmax", r"softmax|SoftMax"),
              ("reduce", r"reduce|Reduce"),
              ("copy/cast", r"copy|Copy|cast"),
              ("elementwise", r"elementwise|vectorized|unrolled|Functor"))


def loss_kernels(one_hot_replay, fused_replay, top=12):
    """Where the one-hot form's extra device time goes: each kernel's
    device ms in one replay of the one-hot form's step less its ms in one
    replay of the fused form's, by kind (``LOSS_KINDS``) and the largest
    by name."""
    a = kernel_device_ms(one_hot_replay)
    b = kernel_device_ms(fused_replay)
    delta = {k: a.get(k, [0, 0.0])[1] - b.get(k, [0, 0.0])[1]
             for k in set(a) | set(b)}
    kinds = {}
    for k, d in delta.items():
        kind = next((n for n, pat in LOSS_KINDS if re.search(pat, k)),
                    "other")
        kinds[kind] = kinds.get(kind, 0.0) + d
    largest = sorted(delta.items(), key=lambda kv: -abs(kv[1]))[:top]
    return {"device_ms_one_hot": sum(v[1] for v in a.values()),
            "device_ms_fused": sum(v[1] for v in b.values()),
            "delta_ms_by_kind": kinds,
            "delta_ms_largest": [[k[:90], d, a.get(k, [0])[0],
                                  b.get(k, [0])[0]] for k, d in largest]}


def dist_parity(fluid, amp):
    """``bench_transformer`` at dropout 0 with ``dist_transformer.py``'s
    loss and with the fused one, from one start state, one step on one
    padded batch: the loss and the whole state after the step must agree
    (1e-3 relative under AMP, 1e-5 in float32)."""
    dev = fluid.CUDAPlace(0)
    feed = padded_feed(TRAIN_BATCH, seed=3)
    om, ostart, ol = build_bench_transformer(fluid, dropout=0.0, amp=amp,
                                             one_hot_loss=True)
    fm, _, fl = build_bench_transformer(fluid, dropout=0.0, amp=amp)
    sc_o = fluid.Scope()
    ex = fluid.Executor(dev)
    ex.run(ostart, scope=sc_o)
    sc_f = clone_scope(fluid, sc_o)
    lo = float(ex.run(om, feed=feed, fetch_list=[ol], scope=sc_o)[0])
    lf = float(ex.run(fm, feed=feed, fetch_list=[fl], scope=sc_f)[0])
    whole, worst, equal = state_norm_err(sc_o, sc_f)
    tol = 1e-3 if amp else 1e-5
    out = {"loss_one_hot": lo, "loss_fused": lf,
           "loss_rel_diff": abs(lo - lf) / abs(lf),
           "state_whole_norm_diff": whole, "state_max_norm_diff": worst,
           "most_different": most_different(sc_o, sc_f, 3),
           "bit_equal": bool(lo == lf and equal), "tolerance": tol}
    check(np.isfinite([lo, lf]).all() and out["loss_rel_diff"] <= tol
          and whole <= tol,
          "dist_transformer parity (%s): one-hot form against fused %r"
          % ("amp" if amp else "float32", out))
    ex.close()
    del sc_o, sc_f
    torch.cuda.empty_cache()
    return out


def dist_transformer_train_phase(xent_rows):
    """``bench_transformer`` (6+6 layers, d_model 512, 64 x 256, vocab
    30000, dropout 0.1, AMP) under Fluid's Transformer recipe
    (``noam_decay(512, 8000) * 2.0``, Adam(0.9, 0.997, 1e-9)) with the loss
    of Fluid's ``dist_transformer.py``: ``label_smooth(one_hot(label),
    0.1)``, a soft-label ``softmax_with_cross_entropy``, ``reduce_sum(cost
    * weights) / reduce_sum(weights)``; as ``scheduled_leg`` (rates,
    counter, captured = eager, eager reruns bit-equal), in turns with the
    fused form (K2 at epsilon 0.1). K2 must not launch in the one-hot
    form and launch once a step each way in the fused one. Reports step
    ms eager and captured, tokens/s, busy share, peak memory over the
    leg's start and the device ms the one-hot form adds by kind (one
    profiled replay of each). At dropout 0 on one state and one padded
    batch the two forms must agree (``dist_parity``, AMP and float32)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.executor import WARMUP_STEPS

    t_phase = time.perf_counter()
    dev = fluid.CUDAPlace(0)
    feed = train_feed(TRAIN_BATCH)
    tokens = TRAIN_BATCH * TRAIN["seq"]
    runs = {}
    for name, one_hot in (("one_hot", True), ("fused", False)):
        recipe = Recipe("noam")
        main, startup, loss = build_bench_transformer(
            fluid, optimizer=recipe, one_hot_loss=one_hot)
        types_ = [op.type for op in main.global_block.ops]
        scope = fluid.Scope()
        fluid.Executor(dev).run(startup, scope=scope)
        per_step = {k: (pat, 0 if one_hot else 1)
                    for k, pat in K2_NAMES.items()}
        run = scheduled_leg("dist_transformer_" + name, main, loss,
                            recipe.lr, scope, [feed] * CAPTURED_STEPS,
                            noam_rate, 1, per_step, tail=False)
        nums = run["numbers"]
        want = 0 if one_hot else CAPTURED_STEPS
        check(nums["k2_launches_eager"] == {"fwd": want, "bwd": want},
              "dist_transformer_%s: K2 launches %r over %d steps"
              % (name, nums["k2_launches_eager"], CAPTURED_STEPS))
        nums["loss_ops"] = {t: types_.count(t) for t in (
            "one_hot", "label_smooth", "softmax_with_cross_entropy",
            "reduce_sum")}
        check(nums["loss_ops"]["one_hot"] == (1 if one_hot else 0),
              "dist_transformer_%s: loss ops %r" % (name, nums["loss_ops"]))
        # both legs' graphs and an eager one-hot step do not fit the card
        # together (~46 GB of graph pools): each graph is dropped after
        # its leg and captured again for the captured turns
        run["release_graphs"]()
        torch.cuda.empty_cache()
        runs[name] = run
    medians, blocks = time_in_turns({
        name + "_eager": (lambda k, step=run["eager_step"]:
                          [step() for _ in range(k)])
        for name, run in runs.items()})
    for run in runs.values():
        run["captured_steps"](WARMUP_STEPS + 1)
    m_c, b_c = time_in_turns({name + "_captured": run["captured_steps"]
                              for name, run in runs.items()})
    medians.update(m_c)
    blocks.update(b_c)
    kernels = loss_kernels(lambda: runs["one_hot"]["captured_steps"](1),
                           lambda: runs["fused"]["captured_steps"](1))
    for run in runs.values():
        run["close"]()
    parity = {"amp": dist_parity(fluid, True),
              "float32": dist_parity(fluid, False)}
    for name, run in runs.items():
        nums = run["numbers"]
        step_c = medians[name + "_captured"]
        emit("dist_transformer_train", leg=name, mode="bfloat16_amp",
             config=TRAIN, batch=TRAIN_BATCH,
             loss_form="label_smooth(one_hot) + soft-label xent"
             if name == "one_hot" else "fused label smoothing (K2)",
             recipe="noam_decay(512, 8000) * 2.0, Adam(0.9, 0.997, 1e-9)",
             step_ms_eager=medians[name + "_eager"], step_ms_captured=step_c,
             tokens_per_s_captured=tokens / (step_c / 1e3),
             tokens_per_s_eager=tokens / (medians[name + "_eager"] / 1e3),
             step_ms_turns={m: blocks[name + "_" + m]
                            for m in ("eager", "captured")},
             peak_gb_over_start_eager=(nums["peak_memory_eager"]
                                       - nums["memory_at_leg_start"]) / 1e9,
             peak_gb_over_start_captured=(nums["peak_memory_captured"]
                                          - nums["memory_at_leg_start"])
             / 1e9, nvidia_smi=SMI[0], **nums)
    emit("dist_transformer_loss", kernels_one_hot_minus_fused=kernels,
         dropout0_parity=parity, nvidia_smi=SMI[0])
    for row, kern in zip(xent_rows, ("K2a", "K2b")):
        launches = row.setdefault("launches_by_leg", {})
        for name, run in runs.items():
            launches["dist_transformer_" + name] = \
                run["numbers"]["k2_launches_eager"][
                    "fwd" if kern == "K2a" else "bwd"]
    del runs
    torch.cuda.empty_cache()
    emit("dist_transformer_phase", seconds=time.perf_counter() - t_phase)


def _grad_embedding(ids, rows, v):
    """``F.embedding``'s own backward."""
    return torch.ops.aten.embedding_dense_backward(rows, ids, v, -1, False)


def lookup_determinism(dev, reps=5):
    """The dense lookup's table gradient on the card, run ``reps`` times
    on the default stream and on a side stream, bf16, at BERT's shapes
    (the sentence table: 4,096 lookups of one id; the position table: 512
    ids 32 times each; the word table: 4,096 ids of 30,522) and the
    Transformer's (16,384 ids of 30,000; and with 30 % of them the padding
    id 0): whether every run gives the same bits, the host syncs of one
    call, and its ms, for the port's table gradient
    (``core.sparse.segment_sum``, the backward of ``nn_ops._Lookup``,
    which must give the same bits) and
    for ``F.embedding``'s own backward (the library's, which parts on the
    sentence table)."""
    from paddle_tpu_torch.core.sparse import segment_sum

    cases = {"bert_sent": (2, BERT_BATCH * BERT_SEQ, 768, "one"),
             "bert_pos": (512, BERT_BATCH * BERT_SEQ, 768, "tiled"),
             "bert_word": (BERT_VOCAB, BERT_BATCH * BERT_SEQ, 768, "random"),
             "transformer_word": (TRAIN["vocab"], TRAIN_BATCH * TRAIN["seq"],
                                  TRAIN["d_model"], "random"),
             "transformer_padded": (TRAIN["vocab"],
                                    TRAIN_BATCH * TRAIN["seq"],
                                    TRAIN["d_model"], "padded")}
    out = {}
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    side = torch.cuda.Stream()
    for case, (v, n, d, kind) in cases.items():
        if kind == "one":
            ids = torch.zeros(n, dtype=torch.long, device=dev)
        elif kind == "tiled":
            ids = torch.arange(n, device=dev) % BERT_SEQ
        else:
            ids = torch.randint(0, v, (n,), generator=gen, device=dev)
            if kind == "padded":
                pad = torch.rand(n, generator=gen, device=dev) < 0.3
                ids = torch.where(pad, 0, ids)
        g = torch.randn(n, d, generator=gen, device=dev).bfloat16()
        fns = {"F.embedding": _grad_embedding, "port": segment_sum}
        for name, fn in fns.items():
            def grad(fn=fn):
                return fn(ids, g, v)

            first = grad()
            same_default = all(torch.equal(grad(), first)
                               for _ in range(reps))
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                on_side = [grad() for _ in range(reps)]
            torch.cuda.current_stream().wait_stream(side)
            want = _grad_embedding(ids, g.float(), v)
            out["%s_%s" % (case, name)] = {
                "bit_equal_default_stream": same_default,
                "bit_equal_side_stream": all(torch.equal(x, first)
                                             for x in on_side),
                "host_syncs": len(host_syncs(grad)),
                "norm_err_vs_float32": float((first.float() - want).norm()
                                             / want.norm()),
                "ms": cuda_ms(grad, reps=10)}
    emit("lookup_determinism", nvidia_smi=SMI[0], **out)
    check(all(v["bit_equal_default_stream"] and v["bit_equal_side_stream"]
              and v["host_syncs"] == 0
              for k, v in out.items() if k.endswith("_port")),
          "the port's lookup gradient parted between runs or synced the "
          "host: %r" % out)
    return out


def registered_op(op_type, attrs, inputs, outs, dev, cot_seed=1):
    """The port's registered op on ``inputs`` ({slot: tensor or [tensors]},
    copied to ``dev``; the float ones take gradients) with a trace on
    ``dev``; returns ({out name: tensor}, {input name: gradient}) for the
    float outputs against cotangents drawn on the CPU from
    ``cot_seed``."""
    from types import SimpleNamespace

    from paddle_tpu_torch.core.registry import OpContext, get_op_impl

    names, env = {}, {}
    for slot, v in inputs.items():
        vs = v if isinstance(v, list) else [v]
        names[slot] = [slot] if not isinstance(v, list) else [
            "%s%d" % (slot, i) for i in range(len(v))]
        for n, t in zip(names[slot], vs):
            t = t.to(dev)
            env[n] = t.requires_grad_(True) if t.is_floating_point() else t
    leaves = {n: t for n, t in env.items() if t.requires_grad}
    out_names = {s: [s] if k == 1 else ["%s%d" % (s, i) for i in range(k)]
                 for s, k in outs.items()}
    op = SimpleNamespace(type=op_type, attrs=dict(attrs), block=None,
                         inputs=names, outputs=out_names)
    trace = SimpleNamespace(is_test=False, device=dev, program=None)
    get_op_impl(op_type)(OpContext(op, env, trace))
    got = {n: env[n] for ns in out_names.values() for n in ns if n in env}
    fl = [n for n, t in got.items() if t.requires_grad]
    grads = {}
    if fl and leaves:
        g = torch.Generator().manual_seed(cot_seed)

        def cot(shape):
            # a [16384, 30000] draw on the host takes seconds: past 2^27
            # elements one random row, repeated
            if int(np.prod(shape)) <= 1 << 27:
                return torch.randn(shape, generator=g)
            return torch.randn(shape[-1], generator=g).expand(shape)

        cots = [cot(got[n].shape).to(dtype=got[n].dtype, device=dev)
                for n in fl]
        gs = torch.autograd.grad([got[n] for n in fl], list(leaves.values()),
                                 cots, allow_unused=True)
        grads = {n: x for n, x in zip(leaves, gs) if x is not None}
    return ({n: t.detach() for n, t in got.items()},
            {n: t.detach() for n, t in grads.items()})


def card_cpu_err(card, cpu):
    """Largest norm-wise relative difference of the float tensors of
    ``card`` from ``cpu`` ({name: tensor}), and whether every other one
    is equal (dtype and shape included)."""
    err, exact = 0.0, True
    for n, want in cpu.items():
        got = card[n]
        if got.dtype != want.dtype or got.shape != want.shape:
            return float("inf"), False
        want = want.to(got.device)
        if want.is_floating_point():
            d = float((got.double() - want.double()).norm())
            err = max(err, d / max(float(want.double().norm()), 1e-30))
        else:
            exact = exact and torch.equal(got, want)
    return err, exact


def dense_op_cases():
    """(name, op type, attrs, inputs (a thunk of CPU tensors), outputs,
    dtypes) of every op of the dense slice: at the shapes of the models
    that use them where the slice names one (group/instance norm and
    pad2d at ResNet-50's [64, 256, 56, 56], bilinear 56 -> 112 at batch
    16, the reductions and cumsum at [64, 256, 512], log_softmax at
    BERT's [640, 30522], one_hot and label_smooth at the Transformer's
    [16384, 30000]), else at small ones."""
    g = torch.Generator().manual_seed(0)

    def rn(*shape):
        return torch.randn(shape, generator=g)

    def ri(hi, *shape):
        return torch.randint(0, hi, shape, generator=g)

    big = (64, 256, 56, 56)
    red = (64, 256, 512)
    n_tok, v = TRAIN_BATCH * TRAIN["seq"], TRAIN["vocab"]
    both = (torch.float32, torch.bfloat16)
    f32 = (torch.float32,)
    cases = [
        ("group_norm", "group_norm", {"groups": 32}, lambda: {
            "X": rn(*big), "Scale": rn(256), "Bias": rn(256)},
         {"Y": 1, "Mean": 1, "Variance": 1}, both),
        ("instance_norm", "instance_norm", {}, lambda: {
            "X": rn(*big), "Scale": rn(256), "Bias": rn(256)}, {"Y": 1},
         both),
        ("pad2d_reflect", "pad2d", {"paddings": [1, 1, 2, 2],
                                    "mode": "reflect"},
         lambda: {"X": rn(*big)}, {"Out": 1}, both),
        ("pad2d_constant_nhwc", "pad2d", {
            "paddings": [1, 0, 0, 1], "pad_value": 0.5,
            "data_format": "NHWC"}, lambda: {"X": rn(8, 56, 56, 256)},
         {"Out": 1}, f32),
        ("pad2d_edge", "pad2d", {"paddings": [0, 2, 1, 0], "mode": "edge"},
         lambda: {"X": rn(8, 256, 56, 56)}, {"Out": 1}, f32),
        ("bilinear_interp", "bilinear_interp", {
            "out_h": 112, "out_w": 112, "align_corners": False,
            "align_mode": 0}, lambda: {"X": rn(16, 256, 56, 56)},
         {"Out": 1}, both),
        ("nearest_interp", "nearest_interp", {"out_h": 112, "out_w": 112},
         lambda: {"X": rn(16, 256, 56, 56)}, {"Out": 1}, f32),
        ("log_softmax", "log_softmax", {}, lambda: {"X": rn(640, 30522)},
         {"Out": 1}, both),
        ("one_hot", "one_hot", {"depth": v},
         lambda: {"X": ri(v, n_tok, 1)}, {"Out": 1}, f32),
        ("label_smooth", "label_smooth", {"epsilon": 0.1}, lambda: {
            "X": (ri(v, n_tok, 1) == torch.arange(v)).float()},
         {"Out": 1}, f32),
        ("cumsum", "cumsum", {"axis": 2, "exclusive": True,
                              "reverse": True}, lambda: {"X": rn(*red)},
         {"Out": 1}, f32),
    ]
    for op in ("reduce_sum", "reduce_mean", "reduce_max", "reduce_min",
               "logsumexp"):
        cases.append((op, op, {"dim": [2]}, lambda: {"X": rn(*red)},
                      {"Out": 1}, f32))
    cases += [
        ("reduce_prod", "reduce_prod", {"dim": [1]},
         lambda: {"X": 1 + rn(*red) / 64}, {"Out": 1}, f32),
        ("reduce_all", "reduce_all", {"dim": [2]},
         lambda: {"X": rn(*red) > -3}, {"Out": 1}, f32),
        ("reduce_any", "reduce_any", {"dim": [2]},
         lambda: {"X": rn(*red) > 3}, {"Out": 1}, f32),
    ]
    small = {
        "flatten2": ({"axis": 2}, lambda: {"X": rn(4, 6, 5)},
                     {"Out": 1, "XShape": 1}),
        "flatten": ({"axis": 1}, lambda: {"X": rn(4, 6, 5)}, {"Out": 1}),
        "stack": ({"axis": 1}, lambda: {"X": [rn(4, 5) for _ in range(3)]},
                  {"Y": 1}),
        "unstack": ({"axis": 1}, lambda: {"X": rn(4, 3, 5)}, {"Y": 3}),
        "strided_slice": ({"axes": [1, 2], "starts": [-1, 4],
                           "ends": [0, -6], "strides": [-2, -1]},
                          lambda: {"Input": rn(4, 6, 5)}, {"Out": 1}),
        "gather_nd": ({}, lambda: {"X": rn(4, 6, 5), "Index": torch.stack(
            [ri(4, 7), ri(6, 7)], -1)}, {"Out": 1}),
        "scatter": ({"overwrite": True}, lambda: {
            "X": rn(64, 32), "Ids": torch.tensor([3, 0, 3, 6, 3, 0]),
            "Updates": rn(6, 32)}, {"Out": 1}),
        "expand": ({"expand_times": [2, 1, 3]}, lambda: {"X": rn(4, 6, 5)},
                   {"Out": 1}),
        "expand_as": ({}, lambda: {"X": rn(4, 1, 5),
                                   "target_tensor": rn(4, 6, 10)},
                      {"Out": 1}),
        "tile": ({"repeat_times": [3, 2]}, lambda: {"X": rn(4, 6, 5)},
                 {"Out": 1}),
        "pad": ({"paddings": [0, 1, 2, 0, 1, 1], "pad_value": 0.5},
                lambda: {"X": rn(4, 6, 5)}, {"Out": 1}),
        "pad_constant_like": ({"pad_value": 2.0}, lambda: {
            "X": rn(5, 7, 4), "Y": rn(3, 7, 2)}, {"Out": 1}),
        "crop": ({"offsets": [1, 2, 0], "shape": [2, 3, 5]},
                 lambda: {"X": rn(4, 6, 5)}, {"Out": 1}),
        "reverse": ({"axis": [0, 2]}, lambda: {"X": rn(4, 6, 5)},
                    {"Out": 1}),
        "shape": ({}, lambda: {"Input": rn(4, 6, 5)}, {"Out": 1}),
        "argsort": ({"axis": -1}, lambda: {"X": ri(3, 64, 50).float()},
                    {"Out": 1, "Indices": 1}),
        "arg_max": ({"axis": -1}, lambda: {"X": ri(2, 64, 50).float()},
                    {"Out": 1}),
        "arg_min": ({"axis": 0}, lambda: {"X": ri(2, 64, 50).float()},
                    {"Out": 1}),
        "multiplex": ({}, lambda: {"X": [rn(6, 5) for _ in range(3)],
                                   "Ids": ri(3, 6, 1)}, {"Out": 1}),
        "is_empty": ({}, lambda: {"X": rn(0, 5)}, {"Out": 1}),
        "fill_constant_batch_size_like": (
            {"shape": [-1, 3], "value": 2.5, "input_dim_idx": 0,
             "output_dim_idx": 0}, lambda: {"Input": rn(7, 2)}, {"Out": 1}),
        "assign": ({}, lambda: {"X": rn(4, 6)}, {"Out": 1}),
        "range": ({}, lambda: {"Start": torch.tensor([0.5]),
                               "End": torch.tensor([7.0]),
                               "Step": torch.tensor([1.5])}, {"Out": 1}),
        "linspace": ({}, lambda: {"Start": torch.tensor([-1.0]),
                                  "Stop": torch.tensor([2.0]),
                                  "Num": torch.tensor([7])}, {"Out": 1}),
        "shuffle_channel": ({"group": 4}, lambda: {"X": rn(2, 8, 6, 6)},
                            {"Out": 1}),
        "pixel_shuffle": ({"upscale_factor": 2},
                          lambda: {"X": rn(2, 8, 6, 6)}, {"Out": 1}),
        "space_to_depth": ({"blocksize": 3}, lambda: {"X": rn(2, 8, 6, 6)},
                           {"Out": 1}),
        "elementwise_mod": ({}, lambda: {"X": ri(40, 64, 8) - 20,
                                         "Y": ri(5, 64, 8) + 1}, {"Out": 1}),
        "elementwise_floordiv": ({}, lambda: {"X": ri(40, 64, 8) - 20,
                                              "Y": ri(5, 64, 8) + 1},
                                 {"Out": 1}),
        "norm": ({"axis": 1}, lambda: {"X": rn(8, 64)},
                 {"Out": 1, "Norm": 1}),
        "l1_norm": ({}, lambda: {"X": rn(8, 64)}, {"Out": 1}),
        "squared_l2_distance": ({}, lambda: {"X": rn(8, 64),
                                             "Y": rn(8, 64)},
                                {"Out": 1, "sub_result": 1}),
        "cos_sim": ({}, lambda: {"X": rn(8, 64), "Y": rn(8, 64)},
                    {"Out": 1, "XNorm": 1, "YNorm": 1}),
        "minus": ({}, lambda: {"X": rn(8, 64), "Y": rn(8, 64)}, {"Out": 1}),
        "bilinear_tensor_product": ({}, lambda: {
            "X": rn(8, 16), "Y": rn(8, 24), "Weight": rn(32, 16, 24),
            "Bias": rn(1, 32)}, {"Out": 1}),
        "dot": ({}, lambda: {"X": rn(8, 64), "Y": rn(8, 64)}, {"Out": 1}),
        "isfinite": ({}, lambda: {"X": rn(8, 64)}, {"Out": 1}),
        "has_inf": ({}, lambda: {"X": rn(8, 64) / 0}, {"Out": 1}),
        "has_nan": ({}, lambda: {"X": rn(8, 64)}, {"Out": 1}),
        "sigmoid_cross_entropy_with_logits": (
            {"ignore_index": -1, "normalize": True}, lambda: {
                "X": rn(64, 10), "Label": ri(3, 64, 10).float() - 1},
            {"Out": 1}),
        "log_loss": ({}, lambda: {"Predicted": torch.rand(64, 1,
                                                          generator=g),
                                  "Labels": ri(2, 64, 1).float()},
                     {"Loss": 1}),
        "huber_loss": ({"delta": 0.8}, lambda: {"X": rn(64, 1),
                                                "Y": rn(64, 1)},
                       {"Out": 1, "Residual": 1}),
        "smooth_l1_loss": ({"sigma": 1.5}, lambda: {"X": rn(64, 4),
                                                    "Y": rn(64, 4)},
                           {"Out": 1, "Diff": 1}),
        "hinge_loss": ({}, lambda: {"Logits": rn(64, 1),
                                    "Labels": ri(2, 64, 1).float()},
                       {"Loss": 1}),
        "rank_loss": ({}, lambda: {"Label": ri(2, 64, 1).float(),
                                   "Left": rn(64, 1), "Right": rn(64, 1)},
                      {"Out": 1}),
        "bpr_loss": ({}, lambda: {"X": rn(64, 9), "Label": ri(9, 64, 1)},
                     {"Y": 1}),
        "margin_rank_loss": ({"margin": 0.1}, lambda: {
            "Label": ri(2, 64, 1).float() * 2 - 1, "X1": rn(64, 1),
            "X2": rn(64, 1)}, {"Out": 1, "Activated": 1}),
        "lrn": ({"n": 5, "alpha": 1e-2}, lambda: {"X": rn(8, 64, 14, 14)},
                {"Out": 1, "MidOut": 1}),
        "data_norm": ({}, lambda: {
            "X": rn(64, 16), "BatchSize": torch.full((16,), 10.0),
            "BatchSum": rn(16) * 10,
            "BatchSquareSum": 20 + rn(16).abs() * 10},
            {"Y": 1, "Means": 1, "Scales": 1}),
        "affine_channel": ({}, lambda: {"X": rn(8, 64, 14, 14),
                                        "Scale": rn(64), "Bias": rn(64)},
                           {"Out": 1}),
        "mean_iou": ({"num_classes": 21}, lambda: {
            "Predictions": ri(21, 4, 64, 64),
            "Labels": ri(21, 4, 64, 64)}, {"OutMeanIou": 1}),
    }
    for op, (attrs, inputs, outs) in small.items():
        cases.append((op, op, attrs, inputs, outs, f32))
    return cases


def load_case(tmp):
    """``load`` of a ``.npy`` written as ``io.save_vars`` writes one."""
    path = tmp + "/dense_load.npy"
    np.save(path, np.random.RandomState(0).randn(64, 32).astype("float32"))
    return ("load", "load", {"file_path": path}, lambda: {}, {"Out": 1},
            (torch.float32,))


RANDOM_OPS = {
    "uniform_random_batch_size_like": (
        {"shape": [-1, 1000], "min": -2.0, "max": 4.0}, 1.0, 6 / 12 ** 0.5),
    "gaussian_random_batch_size_like": (
        {"shape": [-1, 1000], "mean": 1.5, "std": 0.5}, 1.5, 0.5),
    "randint": ({"shape": [1000, 1000], "low": -3, "high": 7}, 1.5,
                (100 - 1) ** 0.5 / 12 ** 0.5),
}


def random_op_check(dev):
    """The random ops on the card: shape, dtype, range and mean within 4
    sigma (their draws are the card generator's, not the CPU's), and the
    same bits from the same seed."""
    from types import SimpleNamespace

    from paddle_tpu_torch.core.registry import OpContext, get_op_impl
    from paddle_tpu_torch.executor import TraceContext

    out = {}
    for op_type, (attrs, mean, std) in RANDOM_OPS.items():
        draws = []
        for _ in range(2):
            env = {"Input": torch.zeros(1000, 3, device=dev)}
            op = SimpleNamespace(
                type=op_type, attrs=dict(attrs), block=None,
                inputs={} if op_type == "randint" else {"Input": ["Input"]},
                outputs={"Out": ["Out"]})
            trace = TraceContext(SimpleNamespace(random_seed=5), False, dev,
                                 0)
            get_op_impl(op_type)(OpContext(op, env, trace))
            draws.append(env["Out"])
        x = draws[0].double()
        lo, hi = attrs.get("min", attrs.get("low", -np.inf)), \
            attrs.get("max", attrs.get("high", np.inf))
        ok = (tuple(x.shape) == (1000, 1000)
              and abs(float(x.mean()) - mean) < 4 * std / 1000
              and float(x.min()) >= lo and float(x.max()) <= hi
              and torch.equal(draws[0], draws[1]))
        out[op_type] = {"ok": bool(ok), "mean": float(x.mean()),
                        "dtype": str(draws[0].dtype)}
    check(all(v["ok"] for v in out.values()),
          "dense_ops: random ops on the card %r" % out)
    return out


def gradients_card_vs_cpu():
    """``fluid.gradients`` through a double grad (a WGAN-GP penalty
    ||dD/dx||^2 on a 3-layer MLP at width 1024, trained 3 Adam steps) and
    ``WeightNormParamAttr`` on an ``fc`` under a ``reduce_mean`` loss (3
    SGD steps), each from one start state on the card and on the CPU:
    fetches within 1e-5 norm-wise."""
    import paddle_tpu_torch as fluid

    def penalty(width=1024):
        x = fluid.layers.data("x", shape=[width])
        h = x
        for i in range(2):
            h = fluid.layers.fc(h, size=width, act="tanh", name="d%d" % i)
        d = fluid.layers.fc(h, size=1, name="d_out")
        (gx,) = fluid.gradients(fluid.layers.reduce_sum(d), x)
        pen = fluid.layers.reduce_mean(fluid.layers.reduce_sum(
            fluid.layers.square(gx), dim=[1]))
        loss = fluid.layers.elementwise_add(fluid.layers.reduce_mean(d),
                                            fluid.layers.scale(pen, 10.0))
        fluid.optimizer.Adam(1e-4).minimize(loss)
        return [loss, pen, gx], {"x": np.random.RandomState(0).randn(
            64, width).astype("float32")}

    def weight_norm():
        x = fluid.layers.data("x", shape=[256])
        out = fluid.layers.fc(x, size=512, act="relu", param_attr=(
            fluid.WeightNormParamAttr(dim=1, name="wn")))
        loss = fluid.layers.reduce_mean(fluid.layers.square(
            fluid.layers.fc(out, size=1)))
        fluid.optimizer.SGD(0.05).minimize(loss)
        return [loss], {"x": np.random.RandomState(1).randn(
            64, 256).astype("float32")}

    out = {}
    for name, build in (("gradient_penalty", penalty),
                        ("weight_norm_fc", weight_norm)):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup), fluid.unique_name.guard():
            fetch, feed = build()
        rows = {}
        cpu_scope = fluid.Scope()
        fluid.Executor(fluid.CPUPlace()).run(startup, scope=cpu_scope)
        card_scope = fluid.Scope()
        for k, v in cpu_scope.vars.items():
            card_scope.set_var(k, v.cuda() if isinstance(v, torch.Tensor)
                               else v)
        for key, place, scope in (("cpu", fluid.CPUPlace(), cpu_scope),
                                  ("card", fluid.CUDAPlace(0), card_scope)):
            exe = fluid.Executor(place)
            main._tpu_step_counter = 0
            rows[key] = [[torch.as_tensor(np.asarray(v)) for v in
                          exe.run(main, feed=feed, fetch_list=fetch,
                                  scope=scope)] for _ in range(3)]
        cpu_rows, card_rows = rows["cpu"], rows["card"]
        err = max(card_cpu_err({i: t for i, t in enumerate(c)},
                               {i: t for i, t in enumerate(w)})[0]
                  for c, w in zip(card_rows, cpu_rows))
        out[name] = {"max_norm_diff": err,
                     "losses_card": [float(r[0]) for r in card_rows],
                     "losses_cpu": [float(r[0]) for r in cpu_rows]}
        check(err <= 1e-5, "dense_ops %s: card against CPU %r"
              % (name, out[name]))
    return out


def dense_ops_phase():
    """Every op of the dense slice forward and backward on the card
    against the same call on CPU tensors (``dense_op_cases``): float
    outputs and gradients within 1e-5 norm-wise in float32 and 1e-2 in
    bf16, integer and bool outputs equal; the random ops by their
    moments (``random_op_check``); ``fluid.gradients`` and
    ``WeightNormParamAttr`` card = CPU (``gradients_card_vs_cpu``)."""
    t_phase = time.perf_counter()
    dev = torch.device("cuda", torch.cuda.current_device())
    rows, ops = {}, set()
    with tempfile.TemporaryDirectory() as tmp:
        for name, op_type, attrs, inputs, outs, dtypes in \
                dense_op_cases() + [load_case(tmp)]:
            base = inputs()
            for dt in dtypes:
                tol = 1e-5 if dt == torch.float32 else 1e-2
                inp = {k: ([t.to(dt) for t in v] if isinstance(v, list)
                           else v.to(dt) if v.is_floating_point() else v)
                       for k, v in base.items()}
                t0 = time.perf_counter()
                cpu_out, cpu_g = registered_op(op_type, attrs, inp, outs,
                                               torch.device("cpu"))
                card_out, card_g = registered_op(op_type, attrs, inp, outs,
                                                 dev)
                torch.cuda.synchronize()
                e_out, exact = card_cpu_err(card_out, cpu_out)
                e_grad, _ = card_cpu_err(card_g, cpu_g)
                key = "%s_%s" % (name, str(dt).replace("torch.", ""))
                rows[key] = {"out_err": e_out, "grad_err": e_grad,
                             "exact": exact, "grads": len(cpu_g),
                             "shape": list(next(iter(cpu_out.values()))
                                           .shape),
                             "s": time.perf_counter() - t0}
                check(e_out <= tol and e_grad <= tol and exact
                      and set(card_g) == set(cpu_g),
                      "dense_ops %s: card against CPU %r (tolerance %g)"
                      % (key, rows[key], tol))
                ops.add(op_type)
                del cpu_out, cpu_g, card_out, card_g, inp
            del base
            torch.cuda.empty_cache()
    random_ops = random_op_check(dev)
    ops |= set(random_ops)
    grads = gradients_card_vs_cpu()
    ops |= {"calc_gradient", "assign"}
    emit("dense_ops", cases=rows, random_ops=random_ops, gradients=grads,
         ops_held=len(ops - {"reduce_sum"}),
         seconds=time.perf_counter() - t_phase)
    held = ops - {"reduce_sum"}
    check(len(held) == DENSE_OPS, "dense_ops: %d of the slice's %d ops "
          "held: %s" % (len(held), DENSE_OPS, sorted(held)))


# the op names the dense slice registers
DENSE_OPS = 72


# optimizer_parity: each optimizer class, the clips and the schedules on
# BERT at 2 layers (float32, dropout 0, batch PARITY_BATCH)
# the rates keep every run descending: the adaptive updates move each
# weight by about their rate (Adagrad, FTRL, Adamax, Adam) or a few times
# it (RMSProp and DecayedAdagrad at decay 0.95: 1/sqrt(0.05) = 4.5; Adadelta
# by sqrt(epsilon)), and a step much past 1e-4 sends this BERT's loss up
# (it doubles within 3 steps at 1e-3), where card and CPU drift apart
PARITY_OPTIMIZERS = {
    "SGD": lambda O: O.SGD(1e-2),
    "Momentum": lambda O: O.Momentum(1e-3, 0.9),
    "Momentum_nesterov": lambda O: O.Momentum(1e-3, 0.9, use_nesterov=True),
    "LarsMomentum": lambda O: O.LarsMomentum(1e-1, 0.9),
    "Adagrad": lambda O: O.Adagrad(1e-4),
    "Adam": lambda O: O.Adam(1e-4),
    "AdamW": lambda O: O.AdamW(1e-4, weight_decay=0.01),
    "Adamax": lambda O: O.Adamax(1e-4),
    "DecayedAdagrad": lambda O: O.DecayedAdagrad(2e-5),
    "Adadelta": lambda O: O.Adadelta(1.0, epsilon=1e-9),
    "RMSProp": lambda O: O.RMSProp(2e-5),
    "RMSProp_centered": lambda O: O.RMSProp(2e-5, momentum=0.9,
                                            centered=True),
    # FTRL's first step from a dense start is lr·sign(g) with no epsilon,
    # so a gradient that cancels to rounding noise moves its weight by ±lr
    # on either device (the state 1.3e-5 apart norm-wise at lr 1e-4); with
    # l1 or l2 above 0 such a gradient also decides whether the weight is
    # zeroed or shrunk (2.7e-4 apart at l1 = l2 = 1e-4)
    "Ftrl": lambda O: O.Ftrl(1e-5),
    "ProximalGD": lambda O: O.ProximalGD(
        1e-2, l1_regularization_strength=1e-4,
        l2_regularization_strength=1e-4),
    "ProximalAdagrad": lambda O: O.ProximalAdagrad(
        1e-4, l1_regularization_strength=1e-4,
        l2_regularization_strength=1e-4),
    "Lamb": lambda O: O.Lamb(1e-3, lamb_weight_decay=0.01),
}
PARITY_CLIPS = {
    "clip_by_value": lambda C: C.GradientClipByValue(1e-3),
    "clip_by_norm": lambda C: C.GradientClipByNorm(0.1),
    "clip_by_global_norm": lambda C: C.GradientClipByGlobalNorm(1.0),
}
PARITY_SCHEDULES = {
    "noam_decay": lambda L: L.noam_decay(768, 2),
    "exponential_decay": lambda L: L.exponential_decay(1e-2, 2, 0.5,
                                                       staircase=True),
    "natural_exp_decay": lambda L: L.natural_exp_decay(1e-2, 2, 0.5),
    "inverse_time_decay": lambda L: L.inverse_time_decay(1e-2, 2, 0.5),
    "polynomial_decay": lambda L: L.polynomial_decay(1e-2, 3, 1e-3),
    "piecewise_decay": lambda L: L.piecewise_decay([1], [1e-2, 5e-3]),
    "cosine_decay": lambda L: L.cosine_decay(1e-2, 1, 3),
    "linear_lr_warmup": lambda L: L.linear_lr_warmup(1e-2, 2, 0.0, 1e-2),
}
PARITY_STEPS = 3
# the batch of optimizer_parity: 4, not bert_parity's 8, halves its CPU
# reference's time (88 of the phase's 116 s at 8 on the H100's host)
PARITY_BATCH = 4


def parity_config(name):
    """(optimizer factory for ``build_bert``, whether a ModelAverage
    follows, {"lr": the scheduled rate} once built) of one configuration:
    an optimizer class alone, a clip under SGD(0.1), a schedule under SGD,
    or Momentum(1e-2, 0.9) with ModelAverage(0.15, windows 2..3)."""
    average = name == "ModelAverage"
    state = {}

    def make(fluid):
        O = fluid.optimizer
        if name in PARITY_OPTIMIZERS:
            return PARITY_OPTIMIZERS[name](O)
        if name in PARITY_CLIPS:
            fluid.clip.set_gradient_clip(PARITY_CLIPS[name](fluid.clip))
            return O.SGD(0.1)
        if name in PARITY_SCHEDULES:
            state["lr"] = PARITY_SCHEDULES[name](fluid.layers)
            return O.SGD(state["lr"])
        return O.Momentum(1e-2, 0.9)

    return make, average, state


def optimizer_parity_phase():
    """BERT at full width, 2 layers, batch ``PARITY_BATCH``, dropout 0,
    float32, 3 steps under each of the 16 optimizer
    configurations (``PARITY_OPTIMIZERS``: the 14 classes, Momentum with
    and without Nesterov, RMSProp centered and not, ProximalGD and
    ProximalAdagrad with l1 > 0), ModelAverage, the three clips and the
    eight schedules, from one startup state: on the card, and on the CPU
    (losses 1e-5 relative, the state 1e-5 norm-wise over all its float
    tensors, the fetched rates 1e-6; the worst single tensor reported: a
    bias of 2 values whose gradient cancels over the batch keeps fewer
    digits on either device); the same 3 steps captured on the card
    (``run_steps``: two warm-ups, one capture, one replay) against the
    card's eager steps (every tensor 1e-6, bit-equality reported);
    ``ModelAverage.apply()`` on the card equal to the float64 average of
    the card's own sums (1e-6 of each tensor's largest value) and to the
    CPU's averages (1e-6 norm-wise), ``restore()`` back to the trained
    parameters bit for bit."""
    import paddle_tpu_torch as fluid

    t_phase = time.perf_counter()
    feed = bert_feed(PARITY_BATCH)
    names_all = (list(PARITY_OPTIMIZERS) + ["ModelAverage"]
                 + list(PARITY_CLIPS) + list(PARITY_SCHEDULES))
    results, secs = {}, {"build": 0.0, "card": 0.0, "captured": 0.0,
                         "cpu": 0.0, "compare": 0.0}
    for name in names_all:
        t = time.perf_counter()
        make, average, state = parity_config(name)
        main, startup, loss = build_bert(fluid, False, n_layer=2,
                                         dropout=0.0, optimizer=make)
        if average:
            # after the update ops, as a user script appends it
            with fluid.program_guard(main, startup):
                ma = fluid.optimizer.ModelAverage(
                    0.15, min_average_window=2, max_average_window=3)
        fetch = [loss] + ([state["lr"]] if "lr" in state else [])
        card = fluid.Scope()
        fluid.Executor(fluid.CUDAPlace(0)).run(startup, scope=card)
        start = clone_scope(fluid, card)
        cap = clone_scope(fluid, card)
        cpu = fluid.Scope()
        for n, v in card.vars.items():
            cpu.set_var(n, v.cpu())
        names = sorted(card.vars)
        secs["build"] += time.perf_counter() - t
        t = time.perf_counter()
        exe = fluid.Executor(fluid.CUDAPlace(0))
        card_rows = [[float(np.ravel(v)[0]) for v in exe.run(
            main, feed=feed, fetch_list=fetch, scope=card)]
            for _ in range(PARITY_STEPS)]
        secs["card"] += time.perf_counter() - t
        t = time.perf_counter()
        main._tpu_step_counter = 0
        exe_c = fluid.Executor(fluid.CUDAPlace(0))
        cap_rows = [[float(np.ravel(v)[0]) for v in r] for r in
                    exe_c.run_steps(main, [feed] * PARITY_STEPS,
                                    fetch_list=fetch,
                                    fetch_every=PARITY_STEPS, scope=cap)]
        exe_c.close()
        secs["captured"] += time.perf_counter() - t
        t = time.perf_counter()
        main._tpu_step_counter = 0
        cpu_exe = fluid.Executor(fluid.CPUPlace())
        cpu_rows = [[float(np.ravel(v)[0]) for v in cpu_exe.run(
            main, feed=feed, fetch_list=fetch, scope=cpu)]
            for _ in range(PARITY_STEPS)]
        secs["cpu"] += time.perf_counter() - t
        t = time.perf_counter()
        card_l, cpu_l = [r[0] for r in card_rows], [r[0] for r in cpu_rows]
        cap_l = [r[0] for r in cap_rows]
        loss_err = loss_rel_err(card_l, cpu_l)
        cap_err = loss_rel_err(cap_l, card_l)
        state_err, worst, _ = state_norm_err(card, cpu)
        _, cap_worst, cap_equal = state_norm_err(cap, card)
        moved = sum(not torch.equal(card.find_var(n), start.find_var(n))
                    for n in names)
        res = {"losses_card": card_l, "losses_cpu": cpu_l,
               "losses_captured": cap_l, "loss_rel_err": loss_err,
               "state_rel_err": state_err, "worst_tensor_rel_err": worst,
               "worst_tensor": most_different(card, cpu, 1)[0][1],
               "captured_loss_rel_err": cap_err,
               "captured_worst_tensor_rel_err": cap_worst,
               "captured_bit_equal": bool(cap_equal and cap_l == card_l),
               "persistables_moved": moved, "persistables": len(names)}
        check(bool(np.isfinite(card_l + cpu_l).all()) and loss_err <= 1e-5
              and state_err <= 1e-5,
              "optimizer_parity %s: card %r vs CPU %r losses (%.3g), state "
              "%.3g norm-wise (1e-5)" % (name, card_l, cpu_l, loss_err,
                                         state_err))
        check(cap_err <= 1e-6 and cap_worst <= 1e-6,
              "optimizer_parity %s: captured %r vs eager %r (%.3g), state "
              "%.3g (1e-6)" % (name, cap_l, card_l, cap_err, cap_worst))
        if "lr" in state:
            rates = ([r[1] for r in card_rows], [r[1] for r in cpu_rows],
                     [r[1] for r in cap_rows])
            res["rates"] = rates[0]
            r_err = max(rate_err(rates[0], rates[1]),
                        rate_err(rates[2], rates[1]))
            check(r_err <= 1e-6 and len(set(rates[1])) > 1,
                  "optimizer_parity %s: rates card %r, CPU %r, captured %r"
                  % (name, *rates))
        if average:
            params = [p.name for p in main.all_parameters()]
            trained = {n: card.find_var(n).clone() for n in params}
            with fluid.scope_guard(cpu), ma.apply():
                cpu_avg = {n: cpu.find_var(n).clone() for n in params}
            with fluid.scope_guard(card):
                with ma.apply():
                    card_avg = {n: card.find_var(n).clone() for n in params}
                restored = all(torch.equal(card.find_var(n), trained[n])
                               for n in params)
            on_card = all(t.is_cuda for t in card_avg.values())
            own = 0.0
            for n in params:
                acc = ma._accumulators
                total = sum(card.find_var(acc[k][n].name).double()
                            for k in ("sum_1", "sum_2", "sum_3"))
                cnt = sum(float(card.find_var(acc[k][n].name)[0])
                          for k in ("num_accumulates",
                                    "old_num_accumulates"))
                want = total / max(cnt, 1.0)
                own = max(own, float((card_avg[n].double() - want).abs().max()
                                     / max(float(want.abs().max()), 1e-30)))
            d2 = sum(float((card_avg[n].double() - cpu_avg[n].to(
                card_avg[n].device).double()).norm()) ** 2 for n in params)
            n2 = sum(float(cpu_avg[n].double().norm()) ** 2 for n in params)
            avg_err = (d2 / n2) ** 0.5
            res.update(average_vs_own_sums=own, average_vs_cpu=avg_err,
                       average_on_card=on_card, restored_bit_equal=restored)
            check(on_card and own <= 1e-6 and avg_err <= 1e-6 and restored,
                  "optimizer_parity ModelAverage: on the card %s, averages "
                  "%.3g from its own sums, %.3g from the CPU's norm-wise "
                  "(1e-6), restored %s" % (on_card, own, avg_err, restored))
        secs["compare"] += time.perf_counter() - t
        results[name] = res
        exe.close()
        del card, cap, cpu, start
    torch.cuda.empty_cache()
    emit("optimizer_parity", n_layer=2, batch=PARITY_BATCH, seq=BERT_SEQ,
         dropout=0.0, steps=PARITY_STEPS, configurations=len(results),
         seconds_by_part=secs, seconds=time.perf_counter() - t_phase,
         results=results)


# -- slice 18: the input pipeline -----------------------------------------------

STREAM_SHARDS = 4                 # bench_deepfm_stream's shard set
STREAM_BATCHES = 16               # 16 x 1024 records: every batch full
STREAM_WARM, STREAM_TIMED = 4, 12
STREAM_FETCH_EVERY = 4
RESUME_AFTER = 5                  # batches read before the reader is stopped
PY_READER_STEPS = 128             # the synthetic MNIST train set at batch 64
ASYNC_FILES, ASYNC_LINES = 4, 1024


def stream_shards(tmp, seed=0):
    """``bench_deepfm_stream``'s shards: 16 x 1024 MultiSlot CTR records at
    full width in 4 files; returns (paths, seconds)."""
    from paddle_tpu_torch.data import write_ctr_shards

    t0 = time.perf_counter()
    paths = write_ctr_shards(tmp, STREAM_BATCHES * CTR_BATCH,
                             n_shards=STREAM_SHARDS,
                             num_fields=CTR["num_fields"],
                             dense_dim=CTR_DENSE,
                             vocab=CTR["sparse_feature_dim"], seed=seed)
    return paths, time.perf_counter() - t0


def ctr_reader(paths, **kw):
    from paddle_tpu_torch.data import CTRMultiSlotReader

    return CTRMultiSlotReader(paths, batch_size=CTR_BATCH, epochs=1,
                              num_fields=CTR["num_fields"],
                              dense_dim=CTR_DENSE,
                              vocab=CTR["sparse_feature_dim"], **kw)


def same_bytes(got, want):
    """Whether tensor ``got`` holds ``want``'s bytes (numpy), dtype and
    shape included."""
    g = got.detach().cpu().numpy()
    return g.dtype == want.dtype and g.shape == want.shape \
        and g.tobytes() == want.tobytes()


@contextlib.contextmanager
def static_feed_copies(seen):
    """While active, every ``_CapturedStep.step`` appends a device copy of
    the batch it ran: its static feeds after a fill (a replay), the feed
    tensors it was handed in an eager warm-up. Nothing is read back until
    the caller compares."""
    from paddle_tpu_torch import executor as ex

    orig = ex._CapturedStep.step

    def step(self, feed, i):
        outs = orig(self, feed, i)
        if self.state is not None:
            seen.append({n: t.clone() for n, t in self.feeds.items()})
        else:
            seen.append({n: torch.as_tensor(v, device=self.exe.place).clone()
                         for n, v in feed.items()})
        return outs

    ex._CapturedStep.step = step
    try:
        yield seen
    finally:
        ex._CapturedStep.step = orig


def losses_of(rows):
    return [float(np.asarray(r[0])) for r in rows]


def spread_check(leg, got, runs):
    """``got`` against the reference runs: bit for bit when the runs are
    bit-equal, else within their spread (the largest relative difference
    between two of them) of one of them. Returns (bit_equal_runs, spread,
    err)."""
    def err(a, b):
        return float(max(abs(x - y) / max(abs(y), 1e-30)
                         for x, y in zip(a, b)))

    bit_runs = all(r == runs[0] for r in runs[1:])
    spread = max((err(a, b) for a in runs for b in runs if a is not b),
                 default=0.0)
    e = min(err(got, r) for r in runs)
    if bit_runs:
        check(got == runs[0], "%s: losses %r differ from the reference "
              "runs' %r, which agree bit for bit" % (leg, got, runs[0]))
    else:
        check(e <= spread, "%s: losses %.3g from the nearest reference run, "
              "beyond the %.3g the reference runs part by" % (leg, e, spread))
    return bit_runs, spread, e


def h2d_ms(batch, dev):
    """Device ms of one batch's host-to-device copies from pinned memory
    on a side stream, by ``cuda_ms`` (the copies queued behind a spin, so
    the events hold the copies and not the host's enqueues)."""
    host = {k: torch.from_numpy(v).pin_memory() for k, v in batch.items()}
    dst = {k: torch.empty(h.shape, dtype=h.dtype, device=dev)
           for k, h in host.items()}

    def copies():
        for k, h in host.items():
            dst[k].copy_(h, non_blocking=True)

    with torch.cuda.stream(torch.cuda.Stream(dev)):
        return cuda_ms(copies)


def ctr_stream_phase(k4_rows, xent_rows):
    """``bench.py``'s ``bench_deepfm_stream`` on the port: DeepFM at full
    width (V = 1e6, 26 fields, batch 1024, Adam 1e-3, ``is_sparse``)
    trained by ``run_steps`` from ``write_ctr_shards`` (16 x 1024 records,
    4 shards) through ``CTRMultiSlotReader``, its ``prefetch(4)`` and a
    ``DevicePrefetcher(capacity=2)``: 4 warm-up steps (2 eager, the capture,
    a replay), then 12 timed at ``fetch_every=4``. The parse (the reader
    alone), the H2D copy (a prefetcher alone, device time on its stream)
    and the captured step (one fixed batch) are timed apart. Checks: every
    batch reaching the step equals the shard's batch byte for byte; the
    losses equal ``run_steps`` over the same 16 numpy batches from the same
    start (two list-fed runs set the tolerance: bits, or their spread);
    K4a 2 and K2a/K2b 1 each in one replay (CUPTI); 16 x 1024 records read,
    none corrupt; the losses finite and the AUC in (0, 1)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.monitor import metrics
    from paddle_tpu_torch.ops.kernels import softmax_xent as sx
    from paddle_tpu_torch.ops.kernels import sparse_adam as sa
    from paddle_tpu_torch.reader import DevicePrefetcher

    metrics.enable()
    dev = fluid.CUDAPlace(0)
    with tempfile.TemporaryDirectory() as tmp:
        paths, gen_s = stream_shards(tmp)
        shard_bytes = sum(os.path.getsize(p) for p in paths)
        # the parse alone: the reference batches
        reader = ctr_reader(paths)
        t0 = time.perf_counter()
        ref = list(reader)
        parse_s = time.perf_counter() - t0
        check(len(ref) == STREAM_BATCHES and reader.records_read
              == STREAM_BATCHES * CTR_BATCH and reader.records_corrupt == 0,
              "ctr_stream: the reader gave %d batches, %d records, %d "
              "corrupt" % (len(ref), reader.records_read,
                           reader.records_corrupt))
        batch_bytes = sum(v.nbytes for v in ref[0].values())
        # the H2D copy alone: a prefetcher over the parsed batches
        copy_hist = metrics.histogram("prefetcher/copy_ms")
        dispatch_hist = metrics.histogram("prefetcher/h2d_ms")
        copy_hist.reset()
        dispatch_hist.reset()
        with DevicePrefetcher(iter(ref), capacity=2) as pf:
            got = list(pf)
        torch.cuda.synchronize()
        check(len(got) == STREAM_BATCHES
              and copy_hist.count == STREAM_BATCHES,
              "ctr_stream: the prefetcher gave %d batches, timed %d copies"
              % (len(got), copy_hist.count))
        check(all(same_bytes(g[n], r[n]) for g, r in zip(got, ref)
                  for n in r), "ctr_stream: a prefetched batch differs from "
              "the parsed one")
        h2d = {"device_ms_a_batch": h2d_ms(ref[0], dev),
               "event_ms_a_batch_in_prefetcher":
                   copy_hist.sum / max(1, copy_hist.count),
               "dispatch_ms_mean":
                   dispatch_hist.sum / max(1, dispatch_hist.count),
               "batch_bytes": batch_bytes,
               "bound_ms": batch_bytes / PCIE5_BYTES_PER_S * 1e3}
        del got

        main, startup, loss, auc = build_deepfm(
            fluid, CTR["sparse_feature_dim"])
        start = fluid.Scope()
        fluid.Executor(dev).run(startup, scope=start)
        step0 = getattr(main, "_tpu_step_counter", 0)

        def from_start():
            main._tpu_step_counter = step0
            return fluid.Executor(dev), clone_scope(fluid, start)

        fetch = [loss, auc]
        listed = []
        for _ in range(2):
            exe, scope = from_start()
            listed.append(losses_of(exe.run_steps(
                main, ref, fetch_list=fetch, fetch_every=STREAM_FETCH_EVERY,
                scope=scope)))
            exe.close()

        def stream_run(hook=None):
            """The chain, 4 warm-up then 12 timed steps; returns (losses,
            aucs, seconds of the timed steps, records read, corrupt,
            executor, scope)."""
            exe, scope = from_start()
            rd = ctr_reader(paths)
            pf = DevicePrefetcher(rd.prefetch(4), capacity=2).start()
            try:
                rows = exe.run_steps(main, pf, steps=STREAM_WARM,
                                     fetch_list=fetch,
                                     fetch_every=STREAM_FETCH_EVERY,
                                     scope=scope)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                rows += exe.run_steps(main, pf, steps=STREAM_TIMED,
                                      fetch_list=fetch,
                                      fetch_every=STREAM_FETCH_EVERY,
                                      scope=scope)
                secs = time.perf_counter() - t0
                left = list(pf)
            finally:
                pf.stop()
            check(not left, "ctr_stream: %d batches left after 16 steps"
                  % len(left))
            return (losses_of(rows), [float(np.asarray(r[1])) for r in rows],
                    secs, rd.records_read, rd.records_corrupt, exe, scope)

        seen = []
        caps0, reps0 = metrics.CAPTURES.value, metrics.REPLAYS.value
        sa.LAUNCHES_ADAM = sx.LAUNCHES_FWD = sx.LAUNCHES_BWD = 0
        with static_feed_copies(seen):
            checked = stream_run()
        host_launches = {"k4a": sa.LAUNCHES_ADAM, "k2a": sx.LAUNCHES_FWD,
                         "k2b": sx.LAUNCHES_BWD}
        captures = metrics.CAPTURES.value - caps0
        replays = metrics.REPLAYS.value - reps0
        checked[5].close()
        check(len(seen) == STREAM_BATCHES, "ctr_stream: %d steps ran, want "
              "%d" % (len(seen), STREAM_BATCHES))
        differ = [i for i, (s, r) in enumerate(zip(seen, ref))
                  if set(s) != set(r)
                  or not all(same_bytes(s[n], r[n]) for n in r)]
        check(not differ, "ctr_stream: the batches of steps %s reached the "
              "step unlike the shard's batches" % differ)
        del seen
        check((captures, replays) == (1, STREAM_BATCHES - 2),
              "ctr_stream: %d captures and %d replays in 16 steps"
              % (captures, replays))
        bit_runs, spread, err = spread_check("ctr_stream", checked[0], listed)
        check(checked[3] == STREAM_BATCHES * CTR_BATCH and checked[4] == 0,
              "ctr_stream: %d records read, %d corrupt" % checked[3:5])
        check(bool(np.isfinite(checked[0]).all()) and 0 < checked[1][-1] < 1,
              "ctr_stream: losses %r, AUC %r" % (checked[0], checked[1][-1]))

        timed_run = stream_run()
        losses, aucs, secs, _, _, exe, scope = timed_run
        bit_timed, _, err_timed = spread_check("ctr_stream (timed run)",
                                               losses, listed)
        per_step = {"K4a": (K4A_KERNEL, 2)}
        per_step.update({k: (pat, 1) for k, pat in K2_NAMES.items()})
        dfeed = {k: torch.as_tensor(v, device=dev) for k, v in ref[0].items()}

        def captured_steps(k, fetch_every=STREAM_FETCH_EVERY):
            return exe.run_steps(main, (dfeed for _ in range(k)), steps=k,
                                 fetch_list=[loss], fetch_every=fetch_every,
                                 scope=scope, return_numpy=False)

        # the fixed batch's captured step: warm-ups and its capture first
        captured_steps(STREAM_TIMED)
        (_, _, kern, graph_launches, _, _), counts, tries = replay_profile(
            lambda: captured_steps(1), per_step)
        check(graph_launches == 1 and counts == {"K4a": 2, "K2a": 1,
                                                 "K2b": 1},
              "ctr_stream: one replay ran %r (%d graph launches); profiles "
              "%r" % (counts, graph_launches, tries))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hs = captured_steps(STREAM_TIMED)
        np.asarray(hs[-1][0])
        step_ms = (time.perf_counter() - t0) / STREAM_TIMED * 1e3

        def cold_stream():
            """A fresh reader's 16 batches through the captured step."""
            rd = ctr_reader(paths)
            exe.run_steps(main, DevicePrefetcher(rd.prefetch(4), capacity=2),
                          fetch_list=[loss], fetch_every=STREAM_FETCH_EVERY,
                          scope=scope)

        t0 = time.perf_counter()
        cold_stream()
        torch.cuda.synchronize()
        cold_s = time.perf_counter() - t0
        # CUPTI can drop a run's kernel records (replay_profile): retaken
        want_stream = {k: c * STREAM_BATCHES for k, (_, c) in per_step.items()}
        stream_tries = []
        for _ in range(REPLAY_PROFILE_TRIES):
            wall, busy, kern_s, graphs, _, host = step_profile(
                cold_stream, warmup=lambda: captured_steps(1))
            stream_counts = {name: sum(c for k, c in kern_s.items()
                                       if re.search(pat, k, re.I))
                             for name, (pat, _) in per_step.items()}
            stream_tries.append({"counts": stream_counts, "graphs": graphs})
            if graphs == STREAM_BATCHES and stream_counts == want_stream:
                break
        check(graphs == STREAM_BATCHES and stream_counts == want_stream,
              "ctr_stream: the profiled stream-fed run launched %d graphs "
              "and ran %r; each profile %r" % (graphs, stream_counts,
                                               stream_tries))
        exe.close()
        del exe, scope, start
        torch.cuda.empty_cache()
    eps = STREAM_TIMED * CTR_BATCH / secs
    k4_rows[0]["launches_ctr_stream_replay"] = counts["K4a"]
    for row, k in zip(xent_rows, ("K2a", "K2b")):
        row["launches_ctr_stream_replay"] = counts[k]
    emit("ctr_stream", nvidia_smi=SMI[0], config=CTR, batch=CTR_BATCH,
         shards=STREAM_SHARDS, records=STREAM_BATCHES * CTR_BATCH,
         shard_bytes=shard_bytes, shard_generation_s=gen_s,
         records_read=checked[3], records_corrupt=checked[4],
         parse_ms_a_batch=parse_s / STREAM_BATCHES * 1e3,
         parse_records_per_s=STREAM_BATCHES * CTR_BATCH / parse_s,
         h2d=h2d, captured_step_ms_fixed_batch=step_ms,
         examples_per_s=eps, stream_step_ms=secs / STREAM_TIMED * 1e3,
         examples_per_s_cold_reader=STREAM_BATCHES * CTR_BATCH / cold_s,
         cold_reader_s=cold_s,
         timed_steps=STREAM_TIMED, warmup_steps=STREAM_WARM,
         fetch_every=STREAM_FETCH_EVERY,
         busy_share_stream_run=busy / wall, device_busy_ms_stream_run=busy,
         wall_ms_stream_run=wall, graph_launches_stream_run=graphs,
         kernels_stream_run=stream_counts, stream_profiles=stream_tries,
         host_top_stream_run=host,
         captures=captures, replays=replays, host_launches=host_launches,
         kernels_a_replay=counts, replay_profiles=tries,
         losses_stream=checked[0], losses_stream_timed=losses,
         losses_listed=listed, listed_bit_equal=bit_runs,
         listed_spread=spread, stream_err=err, timed_err=err_timed,
         stream_bit_equal=checked[0] == listed[0],
         timed_bit_equal=bit_timed and losses == listed[0],
         auc=checked[1][-1], batches_byte_equal=True)


def planted_corrupt(paths, tmp, shard=1, line=7):
    """Copies of ``paths`` in ``tmp`` with one line of one shard made
    corrupt (its first field's id set to V, out of range); returns (paths,
    the record id)."""
    import shutil

    out = []
    for i, p in enumerate(paths):
        q = os.path.join(tmp, os.path.basename(p))
        shutil.copyfile(p, q)
        if i == shard:
            lines = open(q).read().split("\n")
            toks = lines[line].split()
            toks[2 + CTR_DENSE + 2] = str(CTR["sparse_feature_dim"])
            lines[line] = " ".join(toks)
            open(q, "w").write("\n".join(lines))
        out.append(q)
    return out, "%s#%d" % (os.path.basename(paths[shard]), line)


def rows_of(batches):
    return {n: np.concatenate([b[n] for b in batches]) for n in batches[0]}


def ctr_stream_resume_phase():
    """The checkpointable reader on ``ctr_stream``'s shards (host-side):
    stopped after 5 batches of a ``prefetch(4)``, its ``state_dict`` through
    JSON into a new reader, which finishes the epoch; the batches
    concatenated equal an uninterrupted pass byte for byte. With one line
    planted corrupt, that record lands in the quarantine JSONL with its id,
    and the batches hold every other record in order and never it (a
    resumed pass too)."""
    with tempfile.TemporaryDirectory() as tmp:
        paths, _ = stream_shards(os.path.join(tmp, "clean"))
        whole = list(ctr_reader(paths))
        t0 = time.perf_counter()
        first = ctr_reader(paths).prefetch(4)
        part = [next(first) for _ in range(RESUME_AFTER)]
        state = json.dumps(first.state_dict())
        first.stop()
        second = ctr_reader(paths)
        second.load_state_dict(json.loads(state))
        part += list(second)
        resume_s = time.perf_counter() - t0
        check(len(part) == len(whole) and all(
            a[n].tobytes() == b[n].tobytes() for a, b in zip(part, whole)
            for n in b), "ctr_stream_resume: the resumed pass differs from "
              "the uninterrupted one")

        bad_paths, bad_id = planted_corrupt(paths, tmp)
        qpath = os.path.join(tmp, "quarantine.jsonl")
        rd = ctr_reader(bad_paths, quarantine_path=qpath).prefetch(4)
        corrupt_part = [next(rd) for _ in range(RESUME_AFTER)]
        state = json.dumps(rd.state_dict())
        rd.stop()
        rd2 = ctr_reader(bad_paths, quarantine_path=qpath)
        rd2.load_state_dict(json.loads(state))
        corrupt_part += list(rd2)
        quarantined = [json.loads(x) for x in open(qpath)]
        check([q["id"] for q in quarantined] == [bad_id],
              "ctr_stream_resume: quarantine holds %r, want [%r]"
              % (quarantined, bad_id))
        shard = [os.path.basename(p) for p in paths].index(
            bad_id.split("#")[0])
        drop = shard * (STREAM_BATCHES * CTR_BATCH // STREAM_SHARDS) \
            + int(bad_id.split("#")[1])
        want = {n: np.delete(v, drop, axis=0)
                for n, v in rows_of(whole).items()}
        got = rows_of(corrupt_part)
        n_got = len(got["ids"])
        check(n_got == (STREAM_BATCHES * CTR_BATCH - 1) // CTR_BATCH
              * CTR_BATCH and all(got[n].tobytes() == want[n][:n_got]
                                  .tobytes() for n in want),
              "ctr_stream_resume: with the corrupt record the batches are "
              "not the other records in order")
        check(rd2.records_corrupt == 1, "ctr_stream_resume: %d corrupt"
              % rd2.records_corrupt)
    emit("ctr_stream_resume", batches=len(part), resumed_after=RESUME_AFTER,
         state=json.loads(state), byte_equal=True, resume_s=resume_s,
         quarantined=quarantined, corrupt_pass_records=n_got)


def py_reader_program(fluid, capacity=8):
    """The book's MNIST MLP (784-200-200-10, SGD 0.1) fed by a
    ``py_reader``; returns (main, startup, reader, loss, acc)."""
    from paddle_tpu_torch.models import mnist

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        reader = fluid.layers.py_reader(
            capacity=capacity, shapes=[[-1, MNIST_DIM], [-1, 1]],
            dtypes=["float32", "int64"], use_double_buffer=True)
        img, label = fluid.layers.read_file(reader)
        _, loss, acc = mnist.mlp(img, label)
        fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    reader.decorate_paddle_reader(
        fluid.reader.batch(fluid.dataset.mnist.train(), MNIST_BATCH))
    return main, startup, reader, loss, acc


def py_reader_train_phase(xent_rows):
    """The book's MNIST MLP trained from ``fluid.reader.batch(
    fluid.dataset.mnist.train(), 64)`` through ``fluid.layers.py_reader(
    capacity=8, use_double_buffer=True)`` (the card's prefetcher): one
    epoch of 128 steps drained by ``exe.run`` until ``EOFException``, one
    by ``run_steps(feed_iter=None)``, then ``reset()`` and a second
    captured epoch. Each against feed-dict runs of the same batches from
    the same start: eager = eager and captured = captured, bit for bit.
    K2a/K2b once a step (host counters in the eager epoch, CUPTI in a
    replay); ``fluid.metrics.Accuracy`` over the fetched accuracies equal
    to their weighted mean by hand; both epochs' examples/s."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.ops.kernels import softmax_xent as sx

    dev = fluid.CUDAPlace(0)
    main, startup, reader, loss, acc = py_reader_program(fluid)
    names = reader.var_names
    batches = []
    for b in fluid.reader.batch(fluid.dataset.mnist.train(), MNIST_BATCH)():
        xs, ys = zip(*b)
        batches.append({names[0]: np.stack(xs), names[1]: np.stack(ys)})
    check(len(batches) == PY_READER_STEPS, "py_reader_train: %d batches"
          % len(batches))
    # the source alone: the synthetic examples, batched and stacked
    t0 = time.perf_counter()
    for b in fluid.reader.batch(fluid.dataset.mnist.train(), MNIST_BATCH)():
        [np.stack(s) for s in zip(*b)]
    source_s = time.perf_counter() - t0
    start = fluid.Scope()
    fluid.Executor(dev).run(startup, scope=start)
    step0 = getattr(main, "_tpu_step_counter", 0)

    def from_start():
        main._tpu_step_counter = step0
        return fluid.Executor(dev), clone_scope(fluid, start)

    # eager: the reader drained by exe.run
    exe, scope = from_start()
    sx.LAUNCHES_FWD = sx.LAUNCHES_BWD = 0
    reader.start()
    eager, accs = [], []
    t0 = time.perf_counter()
    try:
        while True:
            lv, av = exe.run(main, fetch_list=[loss, acc], scope=scope)
            eager.append(float(lv))
            accs.append(float(av))
    except fluid.EOFException:
        reader.reset()
    reader_s = time.perf_counter() - t0
    launches = (sx.LAUNCHES_FWD, sx.LAUNCHES_BWD)
    check(launches == (PY_READER_STEPS, PY_READER_STEPS),
          "py_reader_train: K2a/K2b launched %r times in %d steps"
          % (launches, PY_READER_STEPS))
    exe, scope = from_start()
    t0 = time.perf_counter()
    fed = [float(exe.run(main, feed=f, fetch_list=[loss], scope=scope)[0])
           for f in batches]
    feed_s = time.perf_counter() - t0
    check(eager == fed, "py_reader_train: reader-fed eager losses differ "
          "from the feed-dict ones")
    metric = fluid.metrics.Accuracy()
    for a in accs:
        metric.update(a, MNIST_BATCH)
    by_hand = sum(a * MNIST_BATCH for a in accs) / (MNIST_BATCH * len(accs))
    check(abs(metric.eval() - by_hand) <= 1e-12,
          "py_reader_train: Accuracy %r, by hand %r" % (metric.eval(),
                                                        by_hand))

    # captured: run_steps drains the reader, two epochs
    exe_c, scope_c = from_start()
    captured = []
    t0 = time.perf_counter()
    for _ in range(2):
        reader.start()
        captured.append(losses_of(exe_c.run_steps(
            main, None, fetch_list=[loss], fetch_every=8, scope=scope_c)))
        reader.reset()
    captured_s = time.perf_counter() - t0
    exe_l, scope_l = from_start()
    listed = [losses_of(exe_l.run_steps(main, batches, fetch_list=[loss],
                                        fetch_every=8, scope=scope_l))
              for _ in range(2)]
    check(captured == listed, "py_reader_train: reader-fed captured losses "
          "differ from the feed-dict captured ones")
    dfeed = {k: torch.as_tensor(v, device=dev) for k, v in batches[0].items()}
    per_step = {k: (pat, 1) for k, pat in K2_NAMES.items()}
    (_, _, _, graph_launches, _, _), counts, tries = replay_profile(
        lambda: exe_c.run_steps(main, iter([dfeed]), steps=1,
                                fetch_list=[loss], scope=scope_c,
                                return_numpy=False), per_step)
    check(counts == {"K2a": 1, "K2b": 1}, "py_reader_train: one replay ran "
          "%r; profiles %r" % (counts, tries))
    for ex in (exe, exe_c, exe_l):
        ex.close()
    for row, k in zip(xent_rows, ("K2a", "K2b")):
        row["launches_py_reader_eager"] = launches[0 if k == "K2a" else 1]
        row["launches_py_reader_replay"] = counts[k]
    n = PY_READER_STEPS * MNIST_BATCH
    emit("py_reader_train", nvidia_smi=SMI[0], steps=PY_READER_STEPS,
         batch=MNIST_BATCH, losses_eager=eager[::16],
         losses_captured_epochs=[c[::16] for c in captured],
         eager_equal_feed_dict=True, captured_equal_feed_dict=True,
         accuracy=metric.eval(), k2_launches_eager=launches,
         kernels_a_replay=counts, replay_profiles=tries,
         examples_per_s_source_alone=n / source_s,
         examples_per_s_reader_eager=n / reader_s,
         examples_per_s_feed_dict_eager=n / feed_s,
         examples_per_s_reader_captured=2 * n / captured_s)


def async_files(tmp):
    """``ASYNC_FILES`` MultiSlot files of ``ASYNC_LINES`` lines in the
    three-slot DeepFM layout (26 sparse ids, 13 dense floats, a dense
    label), written from one RandomState(0), and the ``DataFeedDesc``
    proto text beside them; returns (files, proto path)."""
    rng = np.random.RandomState(0)
    files = []
    for i in range(ASYNC_FILES):
        path = os.path.join(tmp, "part-%03d" % i)
        with open(path, "w") as f:
            for _ in range(ASYNC_LINES):
                ids = rng.randint(0, CTR["sparse_feature_dim"],
                                  CTR["num_fields"])
                dense = rng.rand(CTR_DENSE)
                f.write("%d %s %d %s 1 %d\n" % (
                    len(ids), " ".join(map(str, ids)), CTR_DENSE,
                    " ".join("%.6f" % v for v in dense), rng.randint(0, 2)))
        files.append(path)
    proto = os.path.join(tmp, "data_feed.proto")
    with open(proto, "w") as f:
        f.write('name: "MultiSlotDataFeed"\nbatch_size: %d\n'
                'multi_slot_desc {\n'
                '  slots { name: "ids" type: "uint64" is_dense: false '
                'is_used: true }\n'
                '  slots { name: "dense" type: "float" is_dense: true '
                'is_used: true dense_dim: %d }\n'
                '  slots { name: "label" type: "uint64" is_dense: true '
                'is_used: true }\n}\n' % (CTR_BATCH, CTR_DENSE))
    return files, proto


def async_executor_phase():
    """DeepFM at full width trained through ``fluid.AsyncExecutor(
    thread_num=1)`` from a ``DataFeedDesc`` (batch 1024; slots ``ids``
    uint64 sparse, 26 a line, padded to [1024, 26] beside an unread
    ``ids_length``; ``dense`` float, 13; ``label`` uint64, 1) over 4 files
    of 1024 lines. Its losses against the same batches through
    ``Executor.run`` on the card from the same start (bit for bit where
    two such passes agree, else within their spread); K4a twice a step
    (host counter); the card against the CPU over the first 2 batches
    (1e-5 relative)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.async_executor import (_batch_to_feed,
                                                 _parse_multislot_line)
    from paddle_tpu_torch.ops.kernels import sparse_adam as sa

    dev = fluid.CUDAPlace(0)
    with tempfile.TemporaryDirectory() as tmp:
        files, proto = async_files(tmp)
        desc = fluid.DataFeedDesc(proto)
        feeds = []
        for fn in files:
            lines = [_parse_multislot_line(line.strip(), desc.slots)
                     for line in open(fn) if line.strip()]
            feeds.append(_batch_to_feed(lines, desc.slots))
        check([tuple(f["ids"].shape) for f in feeds]
              == [(CTR_BATCH, CTR["num_fields"])] * ASYNC_FILES,
              "async_executor: ids batches %r" % [f["ids"].shape
                                                  for f in feeds])
        main, startup, loss, _ = build_deepfm(fluid,
                                              CTR["sparse_feature_dim"])
        start = fluid.Scope()
        fluid.Executor(dev).run(startup, scope=start)
        step0 = getattr(main, "_tpu_step_counter", 0)
        runs = []
        for _ in range(2):
            main._tpu_step_counter = step0
            scope = clone_scope(fluid, start)
            exe = fluid.Executor(dev)
            runs.append([float(exe.run(main, feed=f, fetch_list=[loss],
                                       scope=scope)[0]) for f in feeds])
        main._tpu_step_counter = step0
        scope = clone_scope(fluid, start)
        sa.LAUNCHES_ADAM = 0
        t0 = time.perf_counter()
        with fluid.scope_guard(scope):
            out = fluid.AsyncExecutor(dev).run(
                main, desc, files, thread_num=1, fetch=[loss.name])
        async_s = time.perf_counter() - t0
        k4a = sa.LAUNCHES_ADAM
        got = [float(np.asarray(r[0])) for r in out]
        check(len(got) == ASYNC_FILES, "async_executor: %d batches" % len(got))
        bit_runs, spread, err = spread_check("async_executor", got, runs)
        check(k4a == 2 * ASYNC_FILES, "async_executor: K4a launched %d "
              "times in %d steps" % (k4a, ASYNC_FILES))
        main._tpu_step_counter = step0
        cpu_scope = fluid.Scope()
        for k, v in start.vars.items():
            cpu_scope.set_var(k, v.cpu() if isinstance(v, torch.Tensor)
                              else v)
        cpu = [float(fluid.Executor(fluid.CPUPlace()).run(
            main, feed=f, fetch_list=[loss], scope=cpu_scope)[0])
            for f in feeds[:2]]
        cpu_err = max(abs(a - b) / abs(b) for a, b in zip(got, cpu))
        check(cpu_err <= 1e-5, "async_executor: card losses %r against the "
              "CPU's %r" % (got[:2], cpu))
    emit("async_executor", nvidia_smi=SMI[0], batches=ASYNC_FILES,
         batch=CTR_BATCH, losses=got, losses_executor=runs,
         executor_bit_equal=bit_runs, executor_spread=spread, err=err,
         bit_equal=got == runs[0], k4a_launches=k4a, card_cpu_err=cpu_err,
         seconds=async_s, examples_per_s=ASYNC_FILES * CTR_BATCH / async_s)


def selected_rows_ops_phase():
    """``merge_selected_rows`` and ``get_tensor_from_selected_rows`` on the
    card against the CPU for a DeepFM-sized embedding gradient: the ids of
    ``ctr_feed``'s batch (26,624 ids of V = 1e6, with duplicates) and
    seeded [26624, 10] rows. ``index_add_`` sums duplicates in atomic order
    on the card, so the merged rows are held to 1e-6, the ids exactly."""
    from types import SimpleNamespace

    from paddle_tpu_torch.core.registry import OpContext, get_op_impl
    from paddle_tpu_torch.core.sparse import SparseGrad

    ids = torch.as_tensor(ctr_feed()["ids"].reshape(-1))
    rows = torch.randn(ids.numel(), CTR["embedding_size"],
                       generator=torch.Generator().manual_seed(0))
    out = {}
    for dev in ("cuda", "cpu"):
        env = {"X": SparseGrad(ids.to(dev), rows.to(dev))}
        trace = SimpleNamespace(is_test=False, device=torch.device(dev),
                                program=None)
        for op_type, src, dst in (("merge_selected_rows", "X", "M"),
                                  ("get_tensor_from_selected_rows", "M",
                                   "T")):
            op = SimpleNamespace(type=op_type, attrs={}, block=None,
                                 inputs={"X": [src]}, outputs={"Out": [dst]})
            get_op_impl(op_type)(OpContext(op, env, trace))
        out[dev] = (env["M"].ids.cpu(), env["T"].cpu())
    uniq = int((out["cpu"][0] != 2**31 - 1).sum())
    check(torch.equal(out["cuda"][0], out["cpu"][0]),
          "selected_rows_ops: merged ids differ card vs CPU")
    err = float((out["cuda"][1] - out["cpu"][1]).abs().max())
    check(err <= 1e-6, "selected_rows_ops: merged rows %.3g from the CPU's"
          % err)
    emit("selected_rows_ops", ids=ids.numel(), distinct=uniq,
         duplicates=ids.numel() - uniq, max_abs_err=err, ids_equal=True)


def input_pipeline_phase(k4_rows, xent_rows):
    """Slice 18's legs, each timed: ``ctr_stream``, ``ctr_stream_resume``,
    ``py_reader_train``, ``async_executor``, ``selected_rows_ops``."""
    secs = {}
    for name, fn, args in (
            ("ctr_stream", ctr_stream_phase, (k4_rows, xent_rows)),
            ("ctr_stream_resume", ctr_stream_resume_phase, ()),
            ("py_reader_train", py_reader_train_phase, (xent_rows,)),
            ("async_executor", async_executor_phase, ()),
            ("selected_rows_ops", selected_rows_ops_phase, ())):
        t0 = time.perf_counter()
        fn(*args)
        secs[name] = time.perf_counter() - t0
    emit("input_pipeline_seconds", **secs)


# -- the sequence and RNN families: the book's sequence models ---------------

# test_understand_sentiment.py's stacked_lstm_net: emb 128, hid_dim 512
# (Fluid's 4H: LSTM hidden 128), 3 stacked layers, 2 classes; dict_dim at
# imdb.word_dict()'s scale (it sizes only the table); Adagrad(0.002)
SENTIMENT = dict(dict_dim=5150, emb_dim=128, hid_dim=512, stacked_num=3,
                 class_num=2)
SENT_BATCH, SENT_T, SENT_MIN = 128, 256, 16
# test_label_semantic_roles.py at conll05's dictionaries (word 44,068,
# predicate 3,162, 59 labels): word_dim 32, mark_dim 5, depth 8, hidden
# 512 in the book's sense (db_lstm sizes its fcs hidden_dim * 4)
SRL = dict(word_dict_len=44068, pred_dict_len=3162, mark_dict_len=2,
           label_dict_len=59, word_dim=32, mark_dim=5, hidden_dim=128,
           depth=8)
SRL_BATCH, SRL_T, SRL_MIN = 10, 64, 8
SRL_CHUNK_TYPES = (SRL["label_dict_len"] - 1 + 1) // 2   # 29
SRL_EVAL_BATCHES = 3   # srl_decode's ChunkEvaluator batches
SRL_NAMES = ("word", "predicate", "ctx_n2", "ctx_n1", "ctx_0", "ctx_p1",
             "ctx_p2", "mark")
# test_recommender_system.py at MovieLens-1M's dictionaries
MOVIELENS = dict(usr_dict_size=6041, gender_dict_size=2, age_dict_size=7,
                 job_dict_size=21, mov_dict_size=3953, category_dict_size=18,
                 title_dict_size=5175)
REC_BATCH, REC_CATEGORIES, REC_TITLE = 256, 6, 15
REC_NAMES = ("user_id", "gender_id", "age_id", "job_id", "movie_id",
             "category_id", "movie_title")
# benchmark/fluid/models/machine_translation.py's widths, batch 32
# (fluid_benchmark.py's default), Adam(1e-3)
NMT = dict(dict_size=30000, embedding_dim=512, encoder_size=512,
           decoder_size=512)
NMT_BATCH, NMT_T, NMT_MIN = 32, 50, 10
SEQ_WARMUP, SEQ_TIMED = 2, 4   # a leg's eager and captured steps
# the steps of a leg that add to a kernel's host count: its eager steps
# (warm-ups, the capture step's twin, the timed ones), then the captured
# run's eager warm-ups and its capture (a replay launches on the card
# alone)
SEQ_HOST_STEPS = 2 * SEQ_WARMUP + 2 + SEQ_TIMED


def seq_lengths(rng, batch, t, low):
    return rng.randint(low, t + 1, batch).astype("int64")


def build_sentiment(fluid):
    from paddle_tpu_torch.models import stacked_lstm

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        words = fluid.layers.data("words", shape=[SENT_T], dtype="int64")
        length = fluid.layers.data("length", shape=[], dtype="int64")
        label = fluid.layers.data("label", shape=[1], dtype="int64")
        loss, _ = stacked_lstm.stacked_lstm_net(words, length, label,
                                                **SENTIMENT)
        fluid.optimizer.Adagrad(0.002).minimize(loss)
    return main, startup, loss, None


def sentiment_feed(seed=0):
    rng = np.random.RandomState(seed)
    return {"words": rng.randint(0, SENTIMENT["dict_dim"],
                                 (SENT_BATCH, SENT_T)).astype("int64"),
            "length": seq_lengths(rng, SENT_BATCH, SENT_T, SENT_MIN),
            "label": rng.randint(0, 2, (SENT_BATCH, 1)).astype("int64")}


def build_srl(fluid):
    from paddle_tpu_torch.models import semantic_roles as srl

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        feats = [fluid.layers.data(n, shape=[SRL_T], dtype="int64")
                 for n in SRL_NAMES]
        target = fluid.layers.data("target", shape=[SRL_T], dtype="int64")
        length = fluid.layers.data("length", shape=[], dtype="int64")
        feature_out = srl.db_lstm(*feats, length=length, **SRL)
        cost = srl.srl_train_net(feature_out, target, length=length)
        test = main.clone(for_test=True)
        with fluid.program_guard(test):
            path = srl.srl_decode(feature_out, length=length)
            # label_semantic_roles's ChunkEvaluator: IOB over
            # ceil((L - 1) / 2) chunk types
            chunks = fluid.layers.chunk_eval(
                path, target, chunk_scheme="IOB",
                num_chunk_types=SRL_CHUNK_TYPES, seq_length=length)[3:]
        lr = fluid.layers.exponential_decay(0.01, 100000, 0.5,
                                            staircase=True)
        fluid.optimizer.SGD(lr).minimize(cost)
    return main, startup, cost, (test, path, chunks)


def srl_feed(seed=0):
    rng = np.random.RandomState(seed)
    words = rng.randint(0, SRL["word_dict_len"], (SRL_BATCH, SRL_T))
    feed = {"word": words}
    for k, n in enumerate(("ctx_n2", "ctx_n1", "ctx_0", "ctx_p1", "ctx_p2")):
        # each context stream repeats the row's word at the predicate's
        # offset, as conll05's reader builds them
        feed[n] = np.repeat(words[:, k:k + 1], SRL_T, axis=1)
    feed["predicate"] = np.repeat(
        rng.randint(0, SRL["pred_dict_len"], (SRL_BATCH, 1)), SRL_T, axis=1)
    feed["mark"] = rng.randint(0, 2, (SRL_BATCH, SRL_T))
    feed["target"] = rng.randint(0, SRL["label_dict_len"],
                                 (SRL_BATCH, SRL_T))
    feed = {k: v.astype("int64") for k, v in feed.items()}
    feed["length"] = seq_lengths(rng, SRL_BATCH, SRL_T, SRL_MIN)
    return feed


def build_recommender(fluid):
    from paddle_tpu_torch.models import recommender as rec

    main, startup = fluid.Program(), fluid.Program()
    widths = {"category_id": REC_CATEGORIES, "movie_title": REC_TITLE}
    d = MOVIELENS
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        ids = {n: fluid.layers.data(n, shape=[widths.get(n, 1)],
                                    dtype="int64") for n in REC_NAMES}
        score = fluid.layers.data("score", shape=[1], dtype="float32")
        usr = rec.usr_combined_features(
            ids["user_id"], ids["gender_id"], ids["age_id"], ids["job_id"],
            usr_dict_size=d["usr_dict_size"],
            gender_dict_size=d["gender_dict_size"],
            age_dict_size=d["age_dict_size"],
            job_dict_size=d["job_dict_size"], is_sparse=True)
        mov = rec.mov_combined_features(
            ids["movie_id"], ids["category_id"], ids["movie_title"],
            mov_dict_size=d["mov_dict_size"],
            category_dict_size=d["category_dict_size"],
            title_dict_size=d["title_dict_size"], is_sparse=True)
        _, cost = rec.inference_program(usr, mov, score)
        fluid.optimizer.SGD(0.2).minimize(cost)
    return main, startup, cost, None


def recommender_feed(seed=0):
    rng = np.random.RandomState(seed)
    d = MOVIELENS
    highs = {"user_id": d["usr_dict_size"], "gender_id": 2, "age_id": 7,
             "job_id": 21, "movie_id": d["mov_dict_size"]}
    feed = {n: rng.randint(0, h, (REC_BATCH, 1)).astype("int64")
            for n, h in highs.items()}
    # 1-3 genres and 1-15 title words a movie, padded with id 0
    for n, t, hi, most in (("category_id", REC_CATEGORIES, 18, 3),
                           ("movie_title", REC_TITLE, d["title_dict_size"],
                            REC_TITLE)):
        ids = rng.randint(1, hi, (REC_BATCH, t))
        ids[np.arange(t)[None] >= rng.randint(1, most + 1, REC_BATCH)[:, None]] = 0
        feed[n] = ids.astype("int64")
    feed["score"] = rng.randint(1, 6, (REC_BATCH, 1)).astype("float32")
    return feed


def build_nmt(fluid, dict_size=None):
    from paddle_tpu_torch.models import machine_translation as mt

    cfg = dict(NMT, dict_size=dict_size or NMT["dict_size"])
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        src = fluid.layers.data("src", shape=[NMT_T], dtype="int64")
        src_len = fluid.layers.data("src_len", shape=[], dtype="int64")
        trg = fluid.layers.data("trg", shape=[NMT_T], dtype="int64")
        trg_len = fluid.layers.data("trg_len", shape=[], dtype="int64")
        labels = fluid.layers.data("labels", shape=[NMT_T, 1], dtype="int64")
        loss, _ = mt.seq_to_seq_net(src, src_len, trg, trg_len, labels,
                                    **cfg)
        fluid.optimizer.Adam(1e-3).minimize(loss)
    return main, startup, loss, None


def nmt_feed(seed=0, dict_size=None):
    rng = np.random.RandomState(seed)
    v = dict_size or NMT["dict_size"]
    feed = {"src": rng.randint(2, v, (NMT_BATCH, NMT_T)).astype("int64"),
            "src_len": seq_lengths(rng, NMT_BATCH, NMT_T, NMT_MIN),
            "trg": rng.randint(2, v, (NMT_BATCH, NMT_T)).astype("int64"),
            "trg_len": seq_lengths(rng, NMT_BATCH, NMT_T, NMT_MIN)}
    feed["labels"] = np.roll(feed["trg"], -1, axis=1)[..., None]
    return feed


def seq_leg(leg, build, feed, per_step, tokens, batch, decode=None):
    """One training leg of ``sequence_models``: the program built as the
    book's script builds it, its startup run on the card, then eager steps
    (``Executor.run``) and captured steps (``run_steps``, one step a call:
    2 eager warm-ups, the capture, replays) from the same start in turns,
    each step synced and timed: 2 warm-ups, the capture step, 4 timed
    steps each. Losses within 1e-6 relative at every step and the state
    1e-6 norm-wise afterwards; the losses finite and falling; no host
    sync in an eager step; one profiled step each way (kernels, the
    host's launch calls, busy share) and one replay counted by kernel
    name (``per_step``: {name: (pattern, launches a step)}). The
    hand-written kernels' host counts (``kernel_counters``) are set to 0
    before the first step and read after the eager and captured steps.
    ``decode(exe, extra, device feed, feed, scope)``, given, runs on the
    eager run's trained state (``extra`` is what ``build`` returned last)
    and goes into the line as ``decode``. Returns (line, those counts,
    counts in a replay)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.monitor import metrics

    t_leg = time.perf_counter()
    dev = fluid.CUDAPlace(0)
    main, startup, loss, extra = build(fluid)
    scope = fluid.Scope()
    exe = fluid.Executor(dev)
    exe.run(startup, scope=scope)
    scope_c = clone_scope(fluid, scope)
    exe_c = fluid.Executor(dev)
    dfeed = {k: torch.as_tensor(v, device=dev) for k, v in feed.items()}
    step0 = getattr(main, "_tpu_step_counter", 0)

    def eager_step():
        return exe.run(main, feed=dfeed, fetch_list=[loss], scope=scope,
                       return_numpy=False)[0]

    def captured_steps(k):
        return exe_c.run_steps(main, (dfeed for _ in range(k)), steps=k,
                               fetch_list=[loss], fetch_every=k,
                               scope=scope_c, return_numpy=False)

    runs = {"eager": eager_step, "captured": lambda: captured_steps(1)[0][0]}
    losses = {"eager": [], "captured": []}
    times = {"eager": [], "captured": []}
    n = SEQ_WARMUP + 1 + SEQ_TIMED
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernel_counters(reset=True)
    caps0, reps0 = metrics.CAPTURES.value, metrics.REPLAYS.value
    t_turns = time.perf_counter()
    for i in range(n):
        for mode, run in runs.items():
            # both runs see the same step index (it seeds random ops)
            main._tpu_step_counter = step0 + i
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = run()
            torch.cuda.synchronize()
            if i > SEQ_WARMUP:
                times[mode].append((time.perf_counter() - t0) * 1e3)
            losses[mode].append(float(torch.as_tensor(out).reshape(-1)[0]))
    launches = kernel_counters()
    peak = torch.cuda.max_memory_allocated()
    capture_s = metrics.CAPTURE_MS.value / 1e3
    captures = metrics.CAPTURES.value - caps0
    replays = metrics.REPLAYS.value - reps0
    eager, got = losses["eager"], losses["captured"]
    loss_err = loss_rel_err(got, eager)
    _, state_err, state_equal = state_norm_err(scope_c, scope)
    check(bool(np.isfinite(eager).all()) and eager[-1] < eager[SEQ_WARMUP]
          and eager[-1] < eager[0],
          "%s: eager losses %r not finite and falling" % (leg, eager))
    check(loss_err <= 1e-6 and state_err <= 1e-6,
          "%s: captured losses %r against eager %r (%.3g), state %.3g "
          "norm-wise (tolerance 1e-6)" % (leg, got, eager, loss_err,
                                          state_err))
    check((captures, replays) == (1, n - SEQ_WARMUP),
          "%s: %d captures and %d replays" % (leg, captures, replays))
    stages = {"setup_s": t_turns - t_leg,
              "turns_s": time.perf_counter() - t_turns}
    t0 = time.perf_counter()
    syncs = host_syncs(eager_step)
    check(not syncs, "%s: an eager step syncs the host: %s" % (leg, syncs))
    stages["host_syncs_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    wall_e, busy_e, kern_e, _, calls_e, host_e = step_profile(
        eager_step, cpu_ops=False)
    stages["profile_eager_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    (wall_c, busy_c, kern_c, graph_launches, calls_c, _), counts, tries = \
        replay_profile(lambda: captured_steps(1), per_step, cpu_ops=False)
    stages["profile_replay_s"] = time.perf_counter() - t0
    want = {k: c for k, (_, c) in per_step.items()}
    check(graph_launches == 1 and counts == want,
          "%s: %d graph launches, kernels in one replay %r, want %r; "
          "tries %r" % (leg, graph_launches, counts, want, tries))
    ms_e = float(np.median(times["eager"]))
    ms_c = float(np.median(times["captured"]))
    line = dict(
        batch=batch, tokens=tokens, steps=n, warmup_steps=SEQ_WARMUP,
        losses_eager=eager, losses_captured=got, loss_max_rel_diff=loss_err,
        state_max_norm_diff=state_err,
        bit_equal=bool(got == eager and state_equal),
        step_ms_eager=ms_e, step_ms_captured=ms_c, step_ms_turns=times,
        sequences_per_s_eager=batch / ms_e * 1e3,
        sequences_per_s_captured=batch / ms_c * 1e3,
        tokens_per_s_eager=tokens / ms_e * 1e3,
        tokens_per_s_captured=tokens / ms_c * 1e3,
        kernels_a_step_eager=sum(kern_e.values()),
        kernels_a_replay=sum(kern_c.values()),
        host_launch_calls_eager=calls_e, host_launch_calls_captured=calls_c,
        busy_share_eager=busy_e / wall_e, busy_share_captured=busy_c / wall_c,
        device_busy_ms_eager=busy_e, device_busy_ms_captured=busy_c,
        device_share_of_step_eager=busy_e / ms_e,
        device_share_of_step_captured=busy_c / ms_c,
        kernels_by_name_a_replay=counts, replay_profiles=tries,
        host_launches=launches, capture_s=capture_s,
        captures=captures, replays=replays, peak_memory=peak,
        eager_host_syncs=len(syncs), runtime_top_eager=host_e,
        params=len(main.all_parameters()),
        weights=sum(int(np.prod(p.shape)) for p in main.all_parameters()),
        nvidia_smi=SMI[0])
    if decode is not None:
        t0 = time.perf_counter()
        line["decode"] = decode(exe, extra, dfeed, feed, scope)
        stages["decode_s"] = time.perf_counter() - t0
    exe_c.close()
    line["stages"] = stages
    line["leg_s"] = time.perf_counter() - t_leg
    del scope, scope_c, exe, exe_c
    torch.cuda.empty_cache()
    return line, launches, counts


def srl_decode_leg(exe, extra, dfeed, feed, scope):
    """``srl_decode`` on the ``for_test`` clone with the trained 'crfw':
    ms a batch (median of 4 after one warm-up), every path in [0, L) and 0
    at the padding; then ``chunk_eval`` (IOB, 29 chunk types) on
    ``SRL_EVAL_BATCHES`` batches into a ``fluid.metrics.ChunkEvaluator``,
    each batch's counts equal to a host recount of its decoded paths
    (``host_chunk_counts``)."""
    import paddle_tpu_torch as fluid

    test, path, chunks = extra
    secs = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = exe.run(test, feed=dfeed, fetch_list=[path], scope=scope,
                      return_numpy=False)[0]
        torch.cuda.synchronize()
        secs.append((time.perf_counter() - t0) * 1e3)
    got = out.cpu().numpy()
    pad = np.arange(SRL_T)[None] >= feed["length"][:, None]
    check(got.shape == (SRL_BATCH, SRL_T) and got.min() >= 0
          and got.max() < SRL["label_dict_len"] and not got[pad].any(),
          "srl_decode: paths out of [0, %d) or not 0 at the padding"
          % SRL["label_dict_len"])
    evaluator = fluid.metrics.ChunkEvaluator()
    counts = []
    for seed in range(SRL_EVAL_BATCHES):
        f = srl_feed(seed)
        paths, *n = exe.run(test, feed=f, fetch_list=[path] + list(chunks),
                            scope=scope)
        n = [int(np.asarray(c).reshape(-1)[0]) for c in n]
        want = host_chunk_counts(paths, f["target"], f["length"],
                                 SRL_CHUNK_TYPES)
        check(n == [int(c) for c in want],
              "srl_decode: chunk_eval counts %r, the host's recount %r"
              % (n, list(want)))
        evaluator.update(*n)
        counts.append(n)
    p, r, f1 = evaluator.eval()
    return {"ms_a_batch": float(np.median(secs[1:])), "ms": secs,
            "dtype": str(out.dtype), "labels_used": int(len(np.unique(
                got[~pad]))),
            "chunk_eval": {"scheme": "IOB",
                           "num_chunk_types": SRL_CHUNK_TYPES,
                           "counts_infer_label_correct": counts,
                           "equal_to_host_recount": True,
                           "precision": p, "recall": r, "f1": f1}}


# tag types and the begin, inside, end, single tags of each scheme
# (chunk_eval_op.h; -1 where a scheme has no such tag)
CHUNK_SCHEMES = {"IOB": (2, 0, 1, -1, -1), "IOE": (2, -1, 0, 1, -1),
                 "IOBES": (4, 0, 1, 2, 3), "plain": (1, -1, -1, -1, -1)}


def host_chunks(labels, length, num_chunk_types, scheme="IOB"):
    """The chunks of one label row as Fluid's ``GetSegments`` walks it on
    the host (chunk_eval_op.h): a set of (begin, end, type)."""
    ntag, t_b, t_i, t_e, t_s = CHUNK_SCHEMES[scheme]
    other = num_chunk_types

    def ends(pt, pty, t, ty):
        if pty == other:
            return False
        if ty == other or ty != pty:
            return True
        if pt in (t_b, t_i):
            return t in (t_b, t_s)
        return pt in (t_e, t_s)

    def begins(pt, pty, t, ty):
        if pty == other:
            return ty != other
        if ty == other:
            return False
        if ty != pty or t in (t_b, t_s):
            return True
        return t in (t_i, t_e) and pt in (t_e, t_s)

    out, start, inside, tag, typ = set(), 0, False, -1, other
    for i in range(int(length)):
        ptag, ptyp = tag, typ
        tag, typ = int(labels[i]) % ntag, int(labels[i]) // ntag
        if inside and ends(ptag, ptyp, tag, typ):
            out.add((start, i - 1, ptyp))
            inside = False
        if begins(ptag, ptyp, tag, typ):
            start, inside = i, True
    if inside:
        out.add((start, int(length) - 1, typ))
    return out


def host_chunk_counts(inference, label, lengths, num_chunk_types,
                      scheme="IOB", excluded=()):
    """(inferred, labelled, correct) chunk counts of a batch by
    :func:`host_chunks`, the ``excluded`` types left out."""
    counts = np.zeros(3, np.int64)
    for inf, lab, n in zip(inference, label, lengths):
        a = {c for c in host_chunks(inf, n, num_chunk_types, scheme)
             if c[2] not in excluded}
        b = {c for c in host_chunks(lab, n, num_chunk_types, scheme)
             if c[2] not in excluded}
        counts += (len(a), len(b), len(a & b))
    return counts


def kernel_counters(reset=False):
    """The host launch counts of K2a/K2b (by shape) and K4b; with
    ``reset`` set to 0."""
    from paddle_tpu_torch.ops.kernels import softmax_xent as sx
    from paddle_tpu_torch.ops.kernels import sparse_adam as sa

    if reset:
        sx.LAUNCHES_FWD = sx.LAUNCHES_BWD = sa.LAUNCHES_SGD = 0
        sa.LAUNCHES_ADAM = 0
        sx.LAUNCHES_BY_SHAPE.clear()
        return None
    return {"K2a": sx.LAUNCHES_FWD, "K2b": sx.LAUNCHES_BWD,
            "K4a": sa.LAUNCHES_ADAM, "K4b": sa.LAUNCHES_SGD,
            "K2_by_shape": {"%s_%s" % (k, vision_key(n, v, d)): c
                            for (k, n, v, d), c
                            in sorted(sx.LAUNCHES_BY_SHAPE.items(), key=str)}}


@contextlib.contextmanager
def k4b_widths(seen):
    """Record the [V, D] of each table K4b's wrapper updates."""
    from paddle_tpu_torch.ops.kernels import sparse_adam as sa

    orig = sa.sparse_sgd_rows

    def spy(param, ids, rows, lr):
        seen.append(list(param.shape))
        return orig(param, ids, rows, lr)

    sa.sparse_sgd_rows = spy
    try:
        yield
    finally:
        sa.sparse_sgd_rows = orig


def k4b_recommender_check(dev, feed):
    """K4b against its plain version at each of the recommender's seven
    ``is_sparse`` tables ([V, 32] and [V, 16] at MovieLens-1M's V) with
    the rows its batch merges (``merge_rows`` of the feed's ids and
    random gradient rows), SGD(0.2): the tables to 1e-6 absolute; times
    by CUDA events after an L2 flush beside the plain version,
    ``index_add_(alpha=-lr)`` and the byte bound (ids, merged rows and
    the touched table rows read once, those rows written once)."""
    from paddle_tpu_torch.core.sparse import merge_rows
    from paddle_tpu_torch.ops.kernels import sparse_adam as sa

    d = MOVIELENS
    tables = {"user_id": (d["usr_dict_size"], 32),
              "gender_id": (d["gender_dict_size"], 16),
              "age_id": (d["age_dict_size"], 16),
              "job_id": (d["job_dict_size"], 16),
              "movie_id": (d["mov_dict_size"], 32),
              "category_id": (d["category_dict_size"], 32),
              "movie_title": (d["title_dict_size"], 32)}
    flush = l2_flusher(dev)
    g = torch.Generator(device=dev).manual_seed(0)
    out = {}
    for name, (v, width) in tables.items():
        ids = torch.as_tensor(feed[name].reshape(-1), device=dev)
        rows = torch.randn((ids.numel(), width), generator=g, device=dev)
        table = torch.randn((v, width), generator=g, device=dev)
        uniq, merged = merge_rows(ids, rows, v)
        lr = torch.full((1,), 0.2, device=dev)
        got = sa.sparse_sgd_rows(table.clone(), uniq, merged, lr)
        want = sa.sparse_sgd_rows_reference(table.clone(), uniq, merged, lr)
        err = float((got - want).abs().max())
        check(err <= 1e-6, "K4b at the recommender's %s table [%d, %d]: "
              "max abs err %g" % (name, v, width, err))
        n = int((uniq < v).sum())
        nbytes = n * (8 + 3 * 4 * width)
        idx = uniq.clamp(max=v - 1)
        out["%dx%d" % (v, width)] = {
            "table": name, "ids": ids.numel(), "rows": n,
            "max_abs_err": err,
            "ms": cuda_ms(lambda: sa.sparse_sgd_rows(table, uniq, merged,
                                                     lr), flush=flush),
            "plain_ms": cuda_ms(lambda: sa.sparse_sgd_rows_reference(
                table, uniq, merged, lr), flush=flush),
            "library_ms": cuda_ms(lambda: table.index_add_(
                0, idx, merged, alpha=-0.2), flush=flush),
            "bound_ms": nbytes / H100_BYTES_PER_S * 1e3}
    del flush
    emit("kernel_vs_plain", kernel="sparse_sgd_rows_recommender",
         tables=out, tol={"abs": 1e-6})
    return out


SEQ_USERS = {
    "stacked_lstm_train": "sentiment and text-classification teams on "
                          "Fluid 1.x",
    "srl_train": "NLP taggers (SRL, NER) built on linear_chain_crf",
    "recommender_train": "the book's MovieLens recommender and two-tower "
                         "retrieval",
    "nmt_train": "Fluid's seq2seq NMT benchmark",
}


def sequence_train_legs(xent_rows, k4_rows):
    """The four training legs of ``sequence_models``."""
    steps = SEQ_HOST_STEPS
    secs = {}
    k2 = {k: (pat, 1) for k, pat in K2_NAMES.items()}

    t0 = time.perf_counter()
    feed = sentiment_feed()
    line, launches, _ = seq_leg(
        "stacked_lstm_train", build_sentiment, feed, k2,
        int(feed["length"].sum()), SENT_BATCH)
    want = {"K2a_%s" % vision_key(SENT_BATCH, 2, torch.float32): steps,
            "K2b_%s" % vision_key(SENT_BATCH, 2, torch.float32): steps}
    check(launches["K2_by_shape"] == want and launches["K4b"] == 0,
          "stacked_lstm_train: launches %r, want K2 %r" % (launches, want))
    for row, kern in zip(xent_rows, ("K2a", "K2b")):
        row["sequence_shapes"][vision_key(SENT_BATCH, 2, torch.float32)][
            "launches"] = launches[kern]
    emit("stacked_lstm_train", config=SENTIMENT, padded_t=SENT_T,
         lengths=[SENT_MIN, SENT_T], optimizer="Adagrad(0.002)",
         reduced=["reviews cut at 256 tokens", "seeded ids and lengths "
                  "(no IMDB data)"], users=SEQ_USERS["stacked_lstm_train"],
         **line)
    secs["stacked_lstm_train"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    feed = srl_feed()
    line, launches, _ = seq_leg(
        "srl_train", build_srl, feed, {}, int(feed["length"].sum()),
        SRL_BATCH, decode=srl_decode_leg)
    check(launches["K2a"] == launches["K4b"] == 0,
          "srl_train: launches %r" % launches)
    emit("srl_train", config=SRL, padded_t=SRL_T, lengths=[SRL_MIN, SRL_T],
         optimizer="SGD(exponential_decay(0.01, 100000, 0.5, "
                   "staircase=True))",
         reduced=["sentences cut at 64 tokens", "seeded ids, labels and "
                  "lengths (no conll05 data)", "the word table trainable, "
                  "as in the JAX model"], users=SEQ_USERS["srl_train"],
         **line)
    secs["srl_train"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    feed = recommender_feed()
    widths = []
    with k4b_widths(widths):
        line, launches, counts = seq_leg(
            "recommender_train", build_recommender, feed,
            {"K4b": (K4B_KERNEL, 7)}, REC_BATCH, REC_BATCH)
    tables = sorted({tuple(w) for w in widths})
    check(launches["K4b"] == 7 * steps and launches["K2a"] == 0
          and sorted({w[1] for w in tables}) == [16, 32],
          "recommender_train: launches %r, K4b tables %r" % (launches,
                                                              tables))
    k4_rows[1]["recommender"] = {
        "launches": launches["K4b"], "host_steps": steps,
        "captured_launches_a_step": counts["K4b"],
        "tables": k4b_recommender_check(
            torch.device("cuda", torch.cuda.current_device()), feed)}
    emit("recommender_train", config=MOVIELENS, padded={
        "category_id": REC_CATEGORIES, "movie_title": REC_TITLE},
         optimizer="SGD(0.2)", is_sparse=True, k4b_tables=tables,
         reduced=["seeded ids and ratings (no MovieLens data)"],
         users=SEQ_USERS["recommender_train"], **line)
    secs["recommender_train"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    feed = nmt_feed()
    line, launches, counts = seq_leg(
        "nmt_train", build_nmt, feed, k2, int(feed["trg_len"].sum()),
        NMT_BATCH)
    shape = vision_key(NMT_BATCH * NMT_T, NMT["dict_size"], torch.float32)
    want = {"K2a_" + shape: steps, "K2b_" + shape: steps}
    check(launches["K2_by_shape"] == want,
          "nmt_train: K2 launches %r, want %r" % (launches, want))
    for row, kern in zip(xent_rows, ("K2a", "K2b")):
        row["sequence_shapes"][shape].update(
            launches=launches[kern], captured_launches_a_step=counts[kern])
    emit("nmt_train", config=NMT, padded_t=NMT_T, lengths=[NMT_MIN, NMT_T],
         optimizer="Adam(1e-3)",
         source_tokens=int(feed["src_len"].sum()),
         reduced=["sentences cut at 50 tokens", "seeded ids and lengths "
                  "(no WMT data)"], users=SEQ_USERS["nmt_train"], **line)
    secs["nmt_train"] = time.perf_counter() - t0
    return secs


def sequence_op_cases():
    """(name, op type, attrs, inputs (a thunk of CPU tensors), outputs,
    tolerance) of every op of the slice but ``dynamic_rnn`` at the shapes
    of the models that use it: the stacked LSTM's [128, 256] batch
    (H 128, fc 512), the SRL tagger's [10, 64] (59 labels), the
    recommender's pools, the NMT's [32, 50] (H 512); a recurrent op no
    model runs at the SRL tagger's shapes, any other at the stacked
    LSTM's."""
    g = torch.Generator().manual_seed(0)

    def rn(*shape, scale=1.0):
        return torch.randn(shape, generator=g) * scale

    def ri(hi, *shape):
        return torch.randint(0, hi, shape, generator=g)

    def lens(b, t, low):
        return torch.randint(low, t + 1, (b,), generator=g)

    b, t, h = SENT_BATCH, SENT_T, SENTIMENT["hid_dim"] // 4
    sl = lens(b, t, SENT_MIN)
    sb, st, sh, nl = SRL_BATCH, SRL_T, SRL["hidden_dim"], \
        SRL["label_dict_len"]
    srl_l = lens(sb, st, SRL_MIN)
    nb, nt, nh = NMT_BATCH, NMT_T, NMT["decoder_size"]
    nmt_l = lens(nb, nt, NMT_MIN)
    rec = 1e-4
    seq = 1e-5
    return [
        ("dynamic_lstm_sentiment", "dynamic_lstm",
         {"use_peepholes": True, "is_reverse": False},
         lambda: {"Input": rn(b, t, 4 * h), "Weight": rn(h, 4 * h, scale=0.1),
                  "Bias": rn(1, 7 * h), "Length": sl},
         {"Hidden": 1, "Cell": 1}, rec),
        ("dynamic_lstm_sentiment_reverse", "dynamic_lstm",
         {"use_peepholes": True, "is_reverse": True},
         lambda: {"Input": rn(b, t, 4 * h), "Weight": rn(h, 4 * h, scale=0.1),
                  "Bias": rn(1, 7 * h), "Length": sl},
         {"Hidden": 1, "Cell": 1}, rec),
        ("dynamic_lstm_srl", "dynamic_lstm",
         {"use_peepholes": True, "is_reverse": True,
          "candidate_activation": "relu", "cell_activation": "sigmoid"},
         lambda: {"Input": rn(sb, st, 4 * sh),
                  "Weight": rn(sh, 4 * sh, scale=0.1),
                  "Bias": rn(1, 7 * sh), "Length": srl_l},
         {"Hidden": 1, "Cell": 1}, rec),
        ("dynamic_lstmp", "dynamic_lstmp", {"is_reverse": False},
         lambda: {"Input": rn(sb, st, 4 * sh),
                  "Weight": rn(64, 4 * sh, scale=0.1),
                  "ProjWeight": rn(sh, 64, scale=0.1), "Bias": rn(1, 4 * sh),
                  "Length": srl_l}, {"Projection": 1, "Cell": 1}, rec),
        ("lstmp", "lstmp", {"is_reverse": True},
         lambda: {"Input": rn(sb, st, 4 * sh),
                  "Weight": rn(64, 4 * sh, scale=0.1),
                  "ProjWeight": rn(sh, 64, scale=0.1), "Bias": rn(1, 4 * sh),
                  "Length": srl_l}, {"Projection": 1, "Cell": 1}, rec),
        ("dynamic_gru_nmt", "dynamic_gru", {"is_reverse": False},
         lambda: {"Input": rn(nb, nt, 3 * nh),
                  "Weight": rn(nh, 3 * nh, scale=0.05),
                  "Bias": rn(1, 3 * nh), "Length": nmt_l},
         {"Hidden": 1}, rec),
        ("gru", "gru", {"is_reverse": True, "origin_mode": True},
         lambda: {"Input": rn(nb, nt, 3 * nh),
                  "Weight": rn(nh, 3 * nh, scale=0.05),
                  "Bias": rn(1, 3 * nh), "H0": rn(nb, nh), "Length": nmt_l},
         {"Hidden": 1}, rec),
        ("gru_unit_nmt", "gru_unit", {},
         lambda: {"Input": rn(nb, 3 * nh), "HiddenPrev": rn(nb, nh),
                  "Weight": rn(nh, 3 * nh, scale=0.05),
                  "Bias": rn(1, 3 * nh)}, {"Hidden": 1}, seq),
        ("lstm", "lstm", {"num_layers": 2, "is_bidirec": True,
                          "dropout_prob": 0.0},
         lambda: {"Input": rn(sb, st, sh),
                  "WeightX": [rn(sh, 4 * sh, scale=0.1) for _ in range(2)]
                  + [rn(2 * sh, 4 * sh, scale=0.1) for _ in range(2)],
                  "WeightH": [rn(sh, 4 * sh, scale=0.1) for _ in range(4)],
                  "Bias": [rn(4 * sh) for _ in range(4)], "Length": srl_l},
         {"Out": 1, "LastH": 1, "LastC": 1}, rec),
        ("lstm_unit", "lstm_unit", {"forget_bias": 1.0},
         lambda: {"X": rn(b, 4 * h), "C_prev": rn(b, h)},
         {"H": 1, "C": 1}, seq),
        ("linear_chain_crf_srl", "linear_chain_crf", {},
         lambda: {"Emission": rn(sb, st, nl), "Transition": rn(nl + 2, nl),
                  "Label": ri(nl, sb, st), "Length": srl_l},
         {"LogLikelihood": 1}, seq),
        ("crf_decoding_srl", "crf_decoding", {},
         lambda: {"Emission": rn(sb, st, nl), "Transition": rn(nl + 2, nl),
                  "Length": srl_l}, {"ViterbiPath": 1}, seq),
        ("crf_decoding_mismatch", "crf_decoding", {},
         lambda: {"Emission": rn(sb, st, nl), "Transition": rn(nl + 2, nl),
                  "Label": ri(nl, sb, st), "Length": srl_l},
         {"ViterbiPath": 1}, seq),
        ("sequence_pool_max_fc", "sequence_pool", {"pooltype": "max"},
         lambda: {"X": rn(b, t, 4 * h), "Length": sl}, {"Out": 1}, seq),
        ("sequence_pool_max_lstm", "sequence_pool", {"pooltype": "max"},
         lambda: {"X": rn(b, t, h), "Length": sl}, {"Out": 1}, seq),
        ("sequence_pool_sum_categories", "sequence_pool", {"pooltype": "sum"},
         lambda: {"X": rn(REC_BATCH, REC_CATEGORIES, 32)}, {"Out": 1}, seq),
        ("sequence_pool_sum_titles", "sequence_pool", {"pooltype": "sum"},
         lambda: {"X": rn(REC_BATCH, REC_TITLE, 32)}, {"Out": 1}, seq),
        ("sequence_pool_average", "sequence_pool", {"pooltype": "average"},
         lambda: {"X": rn(b, t, h), "Length": sl}, {"Out": 1}, seq),
        ("sequence_pool_last", "sequence_pool", {"pooltype": "last"},
         lambda: {"X": rn(b, t, h), "Length": sl}, {"Out": 1}, seq),
        ("sequence_mask_nmt", "sequence_mask",
         {"maxlen": nt, "out_dtype": "float32"}, lambda: {"X": nmt_l},
         {"Y": 1}, seq),
        ("sequence_softmax", "sequence_softmax", {},
         lambda: {"X": rn(b, t), "Length": sl}, {"Out": 1}, seq),
        ("sequence_reverse", "sequence_reverse", {},
         lambda: {"X": rn(b, t, h), "Length": sl}, {"Y": 1}, seq),
        ("sequence_expand", "sequence_expand", {},
         lambda: {"X": rn(b, h), "Y": rn(b, t, h)}, {"Out": 1}, seq),
        ("sequence_expand_as", "sequence_expand_as", {},
         lambda: {"X": rn(b, h), "Y": rn(b, t, h)}, {"Out": 1}, seq),
        ("sequence_concat", "sequence_concat", {},
         lambda: {"X": [rn(b, t, h), rn(b, 64, h)],
                  "Length": [sl, lens(b, 64, 0)]},
         {"Out": 1, "LengthOut": 1}, seq),
        ("sequence_pad", "sequence_pad", {"padded_length": t + 16},
         lambda: {"X": rn(b, t, h), "PadValue": rn(1), "Length": sl},
         {"Out": 1, "Length": 1}, seq),
        ("sequence_unpad", "sequence_unpad", {},
         lambda: {"X": rn(b, t, h), "Length": sl}, {"Out": 1}, seq),
        ("sequence_erase", "sequence_erase", {"tokens": [0, 1, 2]},
         lambda: {"X": ri(8, b, t)}, {"Out": 1, "Length": 1}, seq),
        ("sequence_enumerate", "sequence_enumerate",
         {"win_size": 3, "pad_value": 0},
         lambda: {"X": ri(SENTIMENT["dict_dim"], b, t)}, {"Out": 1}, seq),
        ("sequence_slice", "sequence_slice", {"out_maxlen": 64},
         lambda: {"X": rn(b, t, h), "Offset": ri(128, b),
                  "Length": ri(65, b)}, {"Out": 1}, seq),
        ("sequence_scatter", "sequence_scatter", {},
         lambda: {"X": rn(b, t), "Ids": ri(t, b, 16),
                  "Updates": rn(b, 16)}, {"Out": 1}, seq),
        ("im2sequence", "im2sequence", {"kernels": [3, 3], "strides": [1, 1]},
         lambda: {"X": rn(16, 3, 32, 32)}, {"Out": 1}, seq),
        ("row_conv", "row_conv", {},
         lambda: {"X": rn(b, t, h), "Filter": rn(3, h)}, {"Out": 1}, seq),
        ("sequence_conv", "sequence_conv",
         {"contextLength": 3, "contextStart": -1},
         lambda: {"X": rn(b, t, h), "Filter": rn(3 * h, h, scale=0.1),
                  "Length": sl}, {"Out": 1}, seq),
        ("sequence_reshape", "sequence_reshape", {"new_dim": 2 * h},
         lambda: {"X": rn(b, t, h), "Length": sl},
         {"Out": 1, "OutLength": 1}, seq),
        ("lod_reset", "lod_reset", {},
         lambda: {"X": rn(b, t, h), "Y": sl}, {"Out": 1, "OutLength": 1},
         seq),
    ]


def dynamic_rnn_card_vs_cpu():
    """``dynamic_rnn`` at the NMT decoder's full shapes (batch 32, T 50,
    512 wide; the vocabulary cut to 1,000, which sizes only the tables
    and the logits outside the op): one step's loss and every parameter
    gradient on the card against the CPU, from one start."""
    import paddle_tpu_torch as fluid

    v = 1000
    main, startup, loss, _ = build_nmt(fluid, dict_size=v)
    init = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=init)
    arrays = {n: init.as_numpy(n) for n in init.vars}
    feed = nmt_feed(dict_size=v)
    names = sorted(p.name for p in main.all_parameters())
    grads = [main._backward_info["param_to_grad"][n] for n in names]
    out = []
    for place in (fluid.CPUPlace(), fluid.CUDAPlace(0)):
        scope = fluid.io.state_from_numpy(main, arrays, fluid.Scope(), place)
        main._tpu_step_counter = 0
        got = fluid.Executor(place).run(main, feed=feed,
                                        fetch_list=[loss] + grads,
                                        scope=scope, return_numpy=False)
        out.append([torch.as_tensor(g).cpu() for g in got])
    cpu, card = out
    loss_err = abs(float(card[0]) - float(cpu[0])) / abs(float(cpu[0]))
    grad_err = norm_diff(card[1:], cpu[1:])
    return {"loss_rel": loss_err, "grads_norm_wise": grad_err,
            "params": len(names),
            "ops_in_block": len(main.blocks[1].ops)}


# gradients that sum millions of zero-mean cotangents into a few values,
# held to a tolerance for that sum: the pad value's of ``sequence_pad``
# sums 2.26 M; the card's float32 sum lands 3.1e-5 from the float64 one,
# and it parts from the CPU's float32 sum by 5.4e-5
SUMMED_GRADS = {("sequence_pad", "PadValue"): 1e-4}


def float64(inputs):
    """``inputs`` ({slot: tensor or [tensors]}) with the float ones in
    float64."""
    def cast(t):
        return t.double() if t.is_floating_point() else t

    return {k: [cast(t) for t in v] if isinstance(v, list) else cast(v)
            for k, v in inputs.items()}


def sequence_ops_leg():
    """Every op of the slice on the card in float32 against the same call
    on the CPU in float64, forward and backward (``sequence_op_cases``;
    ``dynamic_rnn`` through the NMT program, float32 on both): float
    outputs and gradients within 1e-5 norm-wise, the recurrent ops within
    1e-4 (the worst printed), the gradients of ``SUMMED_GRADS`` within
    theirs, integer outputs equal."""
    t_leg = time.perf_counter()
    dev = torch.device("cuda", torch.cuda.current_device())
    rows, ops = {}, set()
    for name, op_type, attrs, inputs, outs, tol in sequence_op_cases():
        t0 = time.perf_counter()
        inp = inputs()
        cpu_out, cpu_g = (
            {n: t.float() if t.is_floating_point() else t
             for n, t in d.items()}
            for d in registered_op(op_type, attrs, float64(inp), outs,
                                   torch.device("cpu")))
        card_out, card_g = registered_op(op_type, attrs, inp, outs, dev)
        torch.cuda.synchronize()
        e_out, exact = card_cpu_err(card_out, cpu_out)
        summed = {n: SUMMED_GRADS[name, n] for n in cpu_g
                  if (name, n) in SUMMED_GRADS}
        e_grad, _ = card_cpu_err({n: g for n, g in card_g.items()
                                  if n not in summed},
                                 {n: g for n, g in cpu_g.items()
                                  if n not in summed})
        e_summed = {n: card_cpu_err({n: card_g[n]}, {n: cpu_g[n]})[0]
                    for n in summed}
        rows[name] = {"op": op_type, "out_err": e_out, "grad_err": e_grad,
                      "exact": exact, "grads": len(cpu_g), "tol": tol,
                      "summed_grads": {n: [e_summed[n], summed[n]]
                                       for n in summed},
                      "s": time.perf_counter() - t0}
        check(e_out <= tol and e_grad <= tol and exact
              and all(e_summed[n] <= summed[n] for n in summed)
              and set(card_g) == set(cpu_g),
              "sequence_ops %s: card against CPU %r" % (name, rows[name]))
        ops.add(op_type)
        del cpu_out, cpu_g, card_out, card_g, inp
    drnn = dynamic_rnn_card_vs_cpu()
    check(drnn["loss_rel"] <= 1e-5 and drnn["grads_norm_wise"] <= 1e-4,
          "sequence_ops dynamic_rnn: card against CPU %r" % drnn)
    ops.add("dynamic_rnn")
    recurrent = {n: max(r["out_err"], r["grad_err"]) for n, r in rows.items()
                 if r["tol"] == 1e-4}
    worst = max(recurrent, key=recurrent.get)
    emit("sequence_ops", cases=rows, dynamic_rnn=drnn, ops_held=len(ops),
         worst_recurrent={"case": worst, "err": recurrent[worst]},
         seconds=time.perf_counter() - t_leg)
    check(len(ops) == SEQUENCE_OPS, "sequence_ops: %d of the slice's %d "
          "ops held: %s" % (len(ops), SEQUENCE_OPS, sorted(ops)))
    torch.cuda.empty_cache()


# the op names the sequence slice registers
SEQUENCE_OPS = 29


def sequence_models_phase(xent_rows, k4_rows):
    """The sequence slice's legs: the four book models at full width
    (``sequence_train_legs``) and ``sequence_ops``; K2 also held to its
    plain version at the NMT's [1600, 30000] and the sentiment net's
    [128, 2]."""
    dev = torch.device("cuda", torch.cuda.current_device())
    t0 = time.perf_counter()
    flush = l2_flusher(dev)
    shapes = {}
    for i, (n, v) in enumerate(((NMT_BATCH * NMT_T, NMT["dict_size"]),
                                (SENT_BATCH, 2))):
        shapes[vision_key(n, v, torch.float32)] = xent_shape_check(
            dev, flush, n, v, torch.float32, seed=20 + i,
            kernel="softmax_xent_sequence")
    del flush
    for row, key in zip(xent_rows, ("fwd", "bwd")):
        row["sequence_shapes"] = {
            name: {"launches": None, "max_err": c["max_err"],
                   **{k[len(key) + 1:]: val for k, val in c.items()
                      if k.startswith(key + "_")}}
            for name, c in shapes.items()}
    secs = {"k2_shapes": time.perf_counter() - t0}
    secs.update(sequence_train_legs(xent_rows, k4_rows))
    t0 = time.perf_counter()
    sequence_ops_leg()
    secs["sequence_ops"] = time.perf_counter() - t0
    emit("sequence_models_seconds", **secs)


# PaddleNLP's language_model (lm_model, rnn_model="static") at its medium
# configuration (Zaremba et al. 2014): hidden 650, 2 layers, 35 steps,
# vocabulary 10,000, batch 20, init_scale 0.05, dropout 0.5; its
# recipe GradientClipByGlobalNorm(5.0) and SGD(1.0)
PTB = dict(hidden_size=650, vocab_size=10000, num_layers=2, num_steps=35,
           init_scale=0.05, dropout=0.5, batch_size=20)
# the generation settings of Fluid's benchmark/fluid/models/
# machine_translation.py: its widths, beam 3, max_length 250, <s> = 0,
# <e> = 1; batch 32 x 50 source tokens as nmt_train
NMT_DECODE = dict(dict_size=NMT["dict_size"], embedding_dim=512,
                  encoder_size=512, decoder_size=512, batch=NMT_BATCH,
                  src_t=NMT_T, beam=3, max_len=250, bos=0, eos=1)


def _lstm_rnn(fluid, x_tm, hiddens, cells, weights, biases, dropout):
    """``lm_model``'s ``padding_rnn``: a StaticRNN over time-major
    ``x_tm`` of one LSTM cell a layer, ``matmul(concat([x, h]), W) + b``
    split into i, j, f, o, with ``dropout`` (upscale_in_train) after each
    layer. Returns its outputs: each layer's h and c, then the last
    layer's dropped-out h, each [T, B, H]."""
    L = fluid.layers
    rnn = L.StaticRNN()
    with rnn.step():
        inp = rnn.step_input(x_tm)
        for k in range(len(weights)):
            pre_hidden = rnn.memory(init=hiddens[k])
            pre_cell = rnn.memory(init=cells[k])
            gate = L.elementwise_add(
                L.matmul(L.concat([inp, pre_hidden], 1), weights[k]),
                biases[k])
            i_g, j_g, f_g, o_g = L.split(gate, num_or_sections=4, dim=-1)
            c = pre_cell * L.sigmoid(f_g) + L.sigmoid(i_g) * L.tanh(j_g)
            m = L.tanh(c) * L.sigmoid(o_g)
            rnn.update_memory(pre_hidden, m)
            rnn.update_memory(pre_cell, c)
            rnn.step_output(m)
            rnn.step_output(c)
            inp = m
            if dropout:
                inp = L.dropout(inp, dropout_prob=dropout,
                                dropout_implementation="upscale_in_train")
        rnn.step_output(inp)
    return rnn()


def build_ptb_rnn(fluid, cfg, dtype):
    """The StaticRNN of ``build_ptb_lm`` alone, in ``dtype``, at
    ``cfg``'s widths, dropout 0: data ``x_tm`` [T, B, H] and each layer's
    ``h_k``/``c_k`` [B, H], weights ``w_k``/``b_k`` as parameters. Returns
    (main, its ``recurrent`` op)."""
    L = fluid.layers
    t, b, h = cfg["num_steps"], cfg["batch_size"], cfg["hidden_size"]
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x_tm = L.data("x_tm", shape=[t, b, h], dtype=dtype,
                      append_batch_size=False)
        hiddens, cells, weights, biases = [], [], [], []
        for k in range(cfg["num_layers"]):
            hiddens.append(L.data("h_%d" % k, shape=[b, h], dtype=dtype,
                                  append_batch_size=False))
            cells.append(L.data("c_%d" % k, shape=[b, h], dtype=dtype,
                                append_batch_size=False))
            weights.append(L.create_parameter([2 * h, 4 * h], dtype=dtype,
                                              name="w_%d" % k))
            biases.append(L.create_parameter([4 * h], dtype=dtype,
                                             name="b_%d" % k))
        _lstm_rnn(fluid, x_tm, hiddens, cells, weights, biases, 0.0)
    op = [o for o in main.global_block.ops if o.type == "recurrent"][0]
    return main, op


def build_ptb_lm(fluid, hidden_size, vocab_size, num_layers, num_steps,
                 init_scale, dropout, batch_size):
    """PaddleNLP's ``lm_model(rnn_model="static")`` program: an embedding,
    time-major, a StaticRNN of ``num_layers`` LSTM cells written from
    ``matmul``/``split``/``sigmoid``/``tanh`` with ``dropout``
    (upscale_in_train) between the layers, the softmax projection and
    ``softmax_with_cross_entropy``, the loss summed over the steps and
    averaged over the batch; GradientClipByGlobalNorm(5.0), SGD(1.0).
    Returns (main, startup, loss, last_hidden, last_cell)."""
    L = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 1

    def uniform():
        return fluid.initializer.UniformInitializer(low=-init_scale,
                                                    high=init_scale)

    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = L.data("x", shape=[batch_size, num_steps, 1], dtype="int64",
                   append_batch_size=False)
        y = L.data("y", shape=[batch_size * num_steps, 1], dtype="int64",
                   append_batch_size=False)
        init_hidden = L.data("init_hidden", append_batch_size=False,
                             shape=[num_layers, batch_size, hidden_size])
        init_cell = L.data("init_cell", append_batch_size=False,
                           shape=[num_layers, batch_size, hidden_size])
        x_emb = L.embedding(x, size=[vocab_size, hidden_size],
                            param_attr=fluid.ParamAttr(
                                name="embedding_para",
                                initializer=uniform()))
        x_emb = L.reshape(x_emb, shape=[-1, num_steps, hidden_size])
        if dropout:
            x_emb = L.dropout(x_emb, dropout_prob=dropout,
                              dropout_implementation="upscale_in_train")
        weights, biases, hiddens, cells = [], [], [], []
        for i in range(num_layers):
            weights.append(L.create_parameter(
                [hidden_size * 2, hidden_size * 4], dtype="float32",
                name="fc_weight1_%d" % i, default_initializer=uniform()))
            biases.append(L.create_parameter(
                [hidden_size * 4], dtype="float32", name="fc_bias1_%d" % i,
                default_initializer=fluid.initializer.Constant(0.0)))
            for src, out in ((init_hidden, hiddens), (init_cell, cells)):
                pre = L.slice(src, axes=[0], starts=[i], ends=[i + 1])
                out.append(L.reshape(pre, shape=[-1, hidden_size]))
        outs = _lstm_rnn(fluid, L.transpose(x_emb, perm=[1, 0, 2]), hiddens,
                         cells, weights, biases, dropout)
        lasts = {"h": [], "c": []}
        for i in range(num_layers):
            for key, o in (("h", outs[2 * i]), ("c", outs[2 * i + 1])):
                lasts[key].append(L.slice(o, axes=[0], starts=[num_steps - 1],
                                          ends=[num_steps]))
        last_hidden = L.concat(lasts["h"], 0)
        last_cell = L.concat(lasts["c"], 0)
        rnn_out = L.transpose(outs[-1], perm=[1, 0, 2])
        softmax_w = L.create_parameter(
            [hidden_size, vocab_size], dtype="float32",
            name="softmax_weight", default_initializer=uniform())
        softmax_b = L.create_parameter(
            [vocab_size], dtype="float32", name="softmax_bias",
            default_initializer=uniform())
        proj = L.elementwise_add(L.matmul(rnn_out, softmax_w), softmax_b)
        proj = L.reshape(proj, shape=[-1, vocab_size])
        loss = L.softmax_with_cross_entropy(logits=proj, label=y)
        loss = L.reduce_sum(L.reduce_mean(
            L.reshape(loss, shape=[-1, num_steps]), dim=[0]))
        fluid.clip.set_gradient_clip(
            fluid.clip.GradientClipByGlobalNorm(clip_norm=5.0))
        fluid.optimizer.SGD(learning_rate=1.0).minimize(loss)
    return main, startup, loss, last_hidden, last_cell


def ptb_feed(cfg, seed=0):
    """One batch of a seeded token stream, as PaddleNLP's reader cuts PTB:
    x the ids, y the next ids; the states zeros (the first batch)."""
    rng = np.random.RandomState(seed)
    b, t, v = cfg["batch_size"], cfg["num_steps"], cfg["vocab_size"]
    data = rng.randint(0, v, (b, t + 1)).astype("int64")
    zeros = np.zeros((cfg["num_layers"], b, cfg["hidden_size"]), "float32")
    return {"x": data[:, :t, None], "y": data[:, 1:].reshape(-1, 1),
            "init_hidden": zeros, "init_cell": zeros.copy()}


def _nmt_encoder(fluid, src, src_len, cfg):
    """``seq_to_seq_net``'s encoder with named parameters: the source
    embedding, its 3H projection and the GRU with ``length``; the -1e9
    bias over the source padding. Both expanded to B·K rows."""
    L, P = fluid.layers, fluid.ParamAttr
    b, t, k = cfg["batch"], cfg["src_t"], cfg["beam"]
    h = cfg["encoder_size"]
    emb = L.embedding(src, size=[cfg["dict_size"], cfg["embedding_dim"]],
                      param_attr=P(name="src_emb_w"))
    proj = L.fc(emb, size=3 * h, num_flatten_dims=2,
                param_attr=P(name="enc_proj_w"), bias_attr=P(name="enc_proj_b"))
    enc = L.dynamic_gru(proj, size=h, length=src_len,
                        param_attr=P(name="enc_gru_w"),
                        bias_attr=P(name="enc_gru_b"))
    mask = L.sequence.sequence_mask(src_len, maxlen=t, dtype="float32")
    bias = L.scale(mask, scale=1e9, bias=-1e9)  # 0 valid, -1e9 pad
    enc = L.reshape(L.expand(L.unsqueeze(enc, axes=[1]), [1, k, 1, 1]),
                    [b * k, t, h])
    bias = L.reshape(L.expand(L.unsqueeze(bias, axes=[1]), [1, k, 1]),
                     [b * k, t])
    return enc, bias


def _nmt_cell(fluid, y_emb, prev, enc, att_bias, cfg):
    """The decoder step of ``seq_to_seq_net``'s DynamicRNN block with
    named parameters: the query fc, dot attention over the encoder rows,
    ``fc([y_t, ctx])`` to 3H and ``gru_unit``; then the vocabulary fc and
    ``log_softmax``. Returns (h, log-probs [B·K, V])."""
    L, P = fluid.layers, fluid.ParamAttr
    hd = cfg["decoder_size"]
    query = L.fc(prev, size=cfg["encoder_size"], bias_attr=False,
                 param_attr=P(name="dec_query_w"))
    scores = L.matmul(enc, L.unsqueeze(query, axes=[2]))
    att = L.softmax(L.elementwise_add(L.squeeze(scores, axes=[2]), att_bias))
    ctx = L.squeeze(L.matmul(L.unsqueeze(att, axes=[1]), enc), axes=[1])
    gates = L.fc([y_emb, ctx], size=3 * hd,
                 param_attr=[P(name="dec_gates_wy"), P(name="dec_gates_wc")],
                 bias_attr=P(name="dec_gates_b"))
    h, _, _ = L.gru_unit(gates, prev, size=3 * hd,
                         param_attr=P(name="dec_gru_w"),
                         bias_attr=P(name="dec_gru_b"))
    logits = L.fc(h, size=cfg["dict_size"], param_attr=P(name="dec_out_w"),
                  bias_attr=P(name="dec_out_b"))
    return h, L.log_softmax(logits)


def _nmt_sources(fluid, cfg):
    L = fluid.layers
    src = L.data("src", shape=[cfg["batch"], cfg["src_t"]], dtype="int64",
                 append_batch_size=False)
    src_len = L.data("src_len", shape=[cfg["batch"]], dtype="int64",
                     append_batch_size=False)
    return src, src_len


def build_nmt_decode(fluid, cfg):
    """The NMT model's beam-search decoder under ``While``: the encoder
    (``_nmt_encoder``), then a loop while ``i < max_len`` and not every
    beam has ended (``reduce_all(equal(ids, eos))``, negated) of the
    decoder step (``_nmt_cell``), ``beam_search`` over [B, K, V], the
    state gathered by parent, and ids and parents written to tensor
    arrays of capacity ``max_len``; then ``beam_search_decode``. Returns
    (main, startup, sentence ids [B, K, max_len], sentence scores [B, K],
    steps run)."""
    L = fluid.layers
    b, k, hd = cfg["batch"], cfg["beam"], cfg["decoder_size"]
    v = cfg["dict_size"]
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 2
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        src, src_len = _nmt_sources(fluid, cfg)
        enc, att_bias = _nmt_encoder(fluid, src, src_len, cfg)
        pre_ids = L.fill_constant([b, k], "int64", cfg["bos"])
        pre_scores = L.assign(np.tile(np.array(
            [0.0] + [-1e9] * (k - 1), "float32"), (b, 1)))
        state = L.fill_constant([b * k, hd], "float32", 0.0)
        offset = L.assign((np.arange(b)[:, None] * k).astype("int64"))
        eos = L.fill_constant([1], "int64", cfg["eos"])
        i = L.fill_constant([1], "int64", 0)
        n = L.fill_constant([1], "int64", cfg["max_len"])
        ids_arr = L.array_write(L.fill_constant([b, k], "int64", 0), i,
                                capacity=cfg["max_len"])
        par_arr = L.array_write(L.fill_constant([b, k], "int64", 0), i,
                                capacity=cfg["max_len"])
        cond = L.less_than(i, n)
        loop = L.While(cond)
        with loop.block():
            y_emb = L.reshape(L.embedding(
                pre_ids, size=[v, cfg["embedding_dim"]],
                param_attr=fluid.ParamAttr(name="trg_emb_w")),
                [b * k, cfg["embedding_dim"]])
            h, logp = _nmt_cell(fluid, y_emb, state, enc, att_bias, cfg)
            sel_ids, sel_scores, parent = L.beam_search(
                pre_ids, pre_scores, None, L.reshape(logp, [b, k, v]),
                beam_size=k, end_id=cfg["eos"])
            rows = L.reshape(L.elementwise_add(parent, offset), [b * k, 1])
            L.array_write(sel_ids, i, array=ids_arr)
            L.array_write(parent, i, array=par_arr)
            L.assign(sel_ids, pre_ids)
            L.assign(sel_scores, pre_scores)
            L.assign(L.gather(h, rows), state)
            L.increment(i, in_place=True)
            helper = L.LayerHelper("reduce_all")
            ended = helper.create_variable_for_type_inference("bool")
            helper.append_op("reduce_all", inputs={"X": L.equal(sel_ids, eos)},
                             outputs={"Out": ended},
                             attrs={"dim": [0], "keep_dim": False,
                                    "reduce_all": True})
            L.logical_and(L.less_than(i, n), L.logical_not(ended), out=cond)
        sent_ids, sent_scores = L.beam_search_decode(
            ids_arr, pre_scores, beam_size=k, end_id=cfg["eos"],
            parents=par_arr)
    return main, startup, sent_ids, sent_scores, i


def build_nmt_rescore(fluid, cfg, steps):
    """The teacher-forced rerun of ``build_nmt_decode``'s step over given
    paths, sharing its parameters by name: a StaticRNN over ``steps``
    time-major tokens ``tf_in`` [steps, B·K] (``bos``, then each path's
    tokens but its last) and ``tf_tok`` [steps, B·K, 1] (the path's
    tokens), the log-prob of each token. Returns (main, log-probs
    [steps, B·K])."""
    L = fluid.layers
    b, k, hd = cfg["batch"], cfg["beam"], cfg["decoder_size"]
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        src, src_len = _nmt_sources(fluid, cfg)
        enc, att_bias = _nmt_encoder(fluid, src, src_len, cfg)
        tf_in = L.data("tf_in", shape=[steps, b * k], dtype="int64",
                       append_batch_size=False)
        tf_tok = L.data("tf_tok", shape=[steps, b * k, 1], dtype="int64",
                        append_batch_size=False)
        emb = L.embedding(tf_in, size=[cfg["dict_size"],
                                       cfg["embedding_dim"]],
                          param_attr=fluid.ParamAttr(name="trg_emb_w"))
        h0 = L.fill_constant([b * k, hd], "float32", 0.0)
        rnn = L.StaticRNN()
        with rnn.step():
            y_emb = rnn.step_input(emb)
            tok = rnn.step_input(tf_tok)
            prev = rnn.memory(init=h0)
            h, logp = _nmt_cell(fluid, y_emb, prev, enc, att_bias, cfg)
            rnn.update_memory(prev, h)
            rnn.step_output(L.reduce_sum(L.elementwise_mul(
                logp, L.one_hot(tok, cfg["dict_size"])), dim=[1]))
        picked = rnn()
    return main, picked


def nmt_decode_feed(cfg, seed=0):
    rng = np.random.RandomState(seed)
    return {"src": rng.randint(2, cfg["dict_size"], (cfg["batch"],
                                                     cfg["src_t"])
                               ).astype("int64"),
            "src_len": seq_lengths(rng, cfg["batch"], cfg["src_t"],
                                   min(NMT_MIN, cfg["src_t"]))}


def nmt_rescore_feed(cfg, sent_ids, steps):
    """``build_nmt_rescore``'s feeds for the decoded ``sent_ids`` [B, K,
    T]: each path's first ``steps`` tokens, time-major over B·K rows."""
    paths = np.asarray(sent_ids)[:, :, :steps].reshape(-1, steps).T
    tf_in = np.concatenate([np.full((1, paths.shape[1]), cfg["bos"]),
                            paths[:-1]], axis=0)
    return {"tf_in": tf_in.astype("int64"),
            "tf_tok": paths[..., None].astype("int64")}


def path_scores(cfg, sent_ids, picked):
    """Each path's score from the rescored log-probs [steps, B·K]: the sum
    up to and including its first ``eos`` (a finished beam adds nothing
    after it), as [B, K]."""
    b, k = cfg["batch"], cfg["beam"]
    paths = np.asarray(sent_ids)[:, :, :picked.shape[0]].reshape(b * k, -1)
    ended = np.cumsum(paths == cfg["eos"], axis=1)
    live = (ended == 0) | ((ended == 1) & (paths == cfg["eos"]))
    return (np.asarray(picked, np.float64).T * live).sum(1).reshape(b, k)


CF_USERS = {
    "ptb_lm_train": "the word-level LSTM language models of the PaddleNLP "
                    "model zoo and their StaticRNN users",
    "nmt_beam_decode": "Fluid's seq2seq NMT benchmark in generation mode "
                       "and the book's beam-search decoders",
}
PTB_WARMUP, PTB_TIMED = 2, 4   # ptb_lm_train's eager and captured steps
# the steps that add to K2's host count: the eager steps (warm-ups, the
# capture step's twin, the timed ones), the captured run's eager warm-ups
# and its capture
PTB_HOST_STEPS = 2 * PTB_WARMUP + 2 + PTB_TIMED
NMT_DECODE_BATCHES = 2         # eager: one warm-up and 1 timed
NMT_CAPTURED_BATCHES = 3       # captured, after Executor.prepare: 3 timed
NMT_DECODE_CHECK_LEN = 16      # the card-against-CPU decode's max_len


def ptb_lm_train_leg(xent_rows):
    """StaticRNN training at full width: ``build_ptb_lm`` at ``PTB``,
    eager steps (``Executor.run``) and captured steps (``run_steps``, one
    step a call) from one start in turns, each synced and timed: 2
    warm-ups, the capture step, 4 timed each; each step fed the last
    hidden and cell states its mode fetched the step before. Losses
    within 1e-6 relative at every step and the state 1e-6 norm-wise with
    the dropout on, the losses finite and falling, no host sync in an
    eager step, K2a/K2b at [700, 10000] by host count and once each in
    one replay (CUPTI); kernels a step eager and a replay, the host's
    launch calls, busy share, capture s, peak memory."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.monitor import metrics

    t_leg = time.perf_counter()
    dev = fluid.CUDAPlace(0)
    main, startup, loss, last_h, last_c = build_ptb_lm(fluid, **PTB)
    scope = fluid.Scope()
    exe = fluid.Executor(dev)
    exe.run(startup, scope=scope)
    scope_c = clone_scope(fluid, scope)
    exe_c = fluid.Executor(dev)
    feed = {k: torch.as_tensor(v, device=dev)
            for k, v in ptb_feed(PTB).items()}
    fetch = [loss, last_h, last_c]
    feeds = {"eager": dict(feed), "captured": dict(feed)}
    step0 = getattr(main, "_tpu_step_counter", 0)

    def eager_step():
        out = exe.run(main, feed=feeds["eager"], fetch_list=fetch,
                      scope=scope, return_numpy=False)
        feeds["eager"].update(init_hidden=out[1], init_cell=out[2])
        return out[0]

    def captured_step():
        out = exe_c.run_steps(main, [feeds["captured"]], steps=1,
                              fetch_list=fetch, scope=scope_c,
                              return_numpy=False)[0]
        feeds["captured"].update(init_hidden=out[1], init_cell=out[2])
        return out[0]

    runs = {"eager": eager_step, "captured": captured_step}
    losses = {"eager": [], "captured": []}
    times = {"eager": [], "captured": []}
    n = PTB_WARMUP + 1 + PTB_TIMED
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernel_counters(reset=True)
    caps0, reps0 = metrics.CAPTURES.value, metrics.REPLAYS.value
    t_turns = time.perf_counter()
    for i in range(n):
        for mode, run in runs.items():
            main._tpu_step_counter = step0 + i  # the same dropout masks
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = run()
            torch.cuda.synchronize()
            if i > PTB_WARMUP:
                times[mode].append((time.perf_counter() - t0) * 1e3)
            losses[mode].append(float(torch.as_tensor(out).reshape(-1)[0]))
    launches = kernel_counters()
    peak = torch.cuda.max_memory_allocated()
    capture_s = metrics.CAPTURE_MS.value / 1e3
    captures = metrics.CAPTURES.value - caps0
    replays = metrics.REPLAYS.value - reps0
    eager, got = losses["eager"], losses["captured"]
    loss_err = loss_rel_err(got, eager)
    _, state_err, state_equal = state_norm_err(scope_c, scope)
    states_err = max(norm_diff([feeds["captured"][k]], [feeds["eager"][k]])
                     for k in ("init_hidden", "init_cell"))
    check(bool(np.isfinite(eager).all()) and eager[-1] < eager[PTB_WARMUP]
          and eager[-1] < eager[0],
          "ptb_lm_train: eager losses %r not finite and falling" % eager)
    check(loss_err <= 1e-6 and state_err <= 1e-6 and states_err <= 1e-6,
          "ptb_lm_train: captured losses %r against eager %r (%.3g), state "
          "%.3g, last states %.3g norm-wise (tolerance 1e-6)"
          % (got, eager, loss_err, state_err, states_err))
    check((captures, replays) == (1, n - PTB_WARMUP),
          "ptb_lm_train: %d captures and %d replays" % (captures, replays))
    shape = vision_key(PTB["batch_size"] * PTB["num_steps"],
                       PTB["vocab_size"], torch.float32)
    want = {"K2a_" + shape: PTB_HOST_STEPS, "K2b_" + shape: PTB_HOST_STEPS}
    check(launches["K2_by_shape"] == want,
          "ptb_lm_train: K2 launches %r, want %r" % (launches, want))
    stages = {"setup_s": t_turns - t_leg,
              "turns_s": time.perf_counter() - t_turns}
    syncs = host_syncs(eager_step)
    check(not syncs, "ptb_lm_train: an eager step syncs the host: %s"
          % syncs)
    t0 = time.perf_counter()
    wall_e, busy_e, kern_e, _, calls_e, host_e = step_profile(
        eager_step, cpu_ops=False)
    per_step = {k: (pat, 1) for k, pat in K2_NAMES.items()}
    (wall_c, busy_c, kern_c, graph_launches, calls_c, _), counts, tries = \
        replay_profile(captured_step, per_step, cpu_ops=False)
    stages["profiles_s"] = time.perf_counter() - t0
    check(graph_launches == 1 and counts == {"K2a": 1, "K2b": 1},
          "ptb_lm_train: %d graph launches, K2 in one replay %r; tries %r"
          % (graph_launches, counts, tries))
    for row, kern in zip(xent_rows, ("K2a", "K2b")):
        row["ptb_shapes"][shape].update(
            launches=launches[kern], captured_launches_a_step=counts[kern])
    ms_e = float(np.median(times["eager"]))
    ms_c = float(np.median(times["captured"]))
    tokens = PTB["batch_size"] * PTB["num_steps"]
    exe_c.close()
    emit("ptb_lm_train", config=PTB, optimizer="SGD(1.0)",
         clip="GradientClipByGlobalNorm(5.0)", tokens=tokens, steps=n,
         warmup_steps=PTB_WARMUP, losses_eager=eager, losses_captured=got,
         loss_max_rel_diff=loss_err, state_max_norm_diff=state_err,
         last_states_norm_diff=states_err,
         bit_equal=bool(got == eager and state_equal),
         step_ms_eager=ms_e, step_ms_captured=ms_c, step_ms_turns=times,
         tokens_per_s_eager=tokens / ms_e * 1e3,
         tokens_per_s_captured=tokens / ms_c * 1e3,
         kernels_a_step_eager=sum(kern_e.values()),
         kernels_a_replay=sum(kern_c.values()),
         host_launch_calls_eager=calls_e, host_launch_calls_captured=calls_c,
         busy_share_eager=busy_e / wall_e, busy_share_captured=busy_c / wall_c,
         device_busy_ms_eager=busy_e, device_busy_ms_captured=busy_c,
         kernels_by_name_a_replay=counts, replay_profiles=tries,
         host_launches=launches, capture_s=capture_s, captures=captures,
         replays=replays, peak_memory=peak, eager_host_syncs=len(syncs),
         runtime_top_eager=host_e,
         weights=sum(int(np.prod(p.shape)) for p in main.all_parameters()),
         reduced=["seeded ids (no PTB data): one batch, its states carried"],
         users=CF_USERS["ptb_lm_train"], stages=stages,
         leg_s=time.perf_counter() - t_leg, nvidia_smi=SMI[0])
    del scope, scope_c, exe, exe_c, feeds
    torch.cuda.empty_cache()


def nmt_beam_decode_leg():
    """The NMT model's beam-search decoder under ``While`` at full width
    (``build_nmt_decode`` at ``NMT_DECODE``) in two modes from one scope:
    eagerly through ``Executor.run`` (the loop's condition read on the
    host, every op launched from Python; 1 warm-up batch and 1 timed), and
    captured through ``CompiledProgram`` (``Executor.prepare`` first: its
    warm-ups on copies, then the graphs of the ops before the loop, of the
    loop body and of the ops after it, one replay of the body an
    iteration after a host read of the condition; ``NMT_CAPTURED_BATCHES``
    timed), and ``run_steps`` once. For each mode: ms a batch, decode
    steps, ms a decode step, generated tokens/s (B·K·steps), and from one
    profiled batch (CUPTI) kernels and the host's launch calls a decode
    step and the busy share, host syncs a batch (the sync debug mode),
    capture seconds and graphs. Checks: the captured ids and scores equal
    the eager ones bit for bit (and ``run_steps``' too); every id in
    [0, V), each row's K scores descending, and each score the sum of its
    path's log-probs rescored on the card by a teacher-forced StaticRNN
    of the same cell (``build_nmt_rescore``), to 1e-4 relative; the
    captured step stays captured (``host_op_steps`` 0, 3 graphs)."""
    import paddle_tpu_torch as fluid

    t_leg = time.perf_counter()
    cfg = NMT_DECODE
    dev = fluid.CUDAPlace(0)
    main, startup, sent_ids, sent_scores, steps = build_nmt_decode(fluid,
                                                                   cfg)
    fetch = [sent_ids, sent_scores, steps]
    scope = fluid.Scope()
    exe = fluid.Executor(dev)
    exe.run(startup, scope=scope)
    feed = {k: torch.as_tensor(v, device=dev)
            for k, v in nmt_decode_feed(cfg).items()}
    exe_c = fluid.Executor(dev)
    compiled = fluid.CompiledProgram(main)
    runs = {
        "eager": lambda: exe.run(main, feed=feed, fetch_list=fetch,
                                 scope=scope, return_numpy=False),
        "captured": lambda: exe_c.run(compiled, feed=feed, fetch_list=fetch,
                                      scope=scope, return_numpy=False)}
    stages, modes, outs = {}, {}, {}
    t0 = time.perf_counter()
    cap = exe_c.prepare(compiled, feed, fetch, scope)
    stages["prepare_s"] = time.perf_counter() - t0
    for mode, n_batches in (("eager", NMT_DECODE_BATCHES),
                            ("captured", NMT_CAPTURED_BATCHES)):
        secs = []
        t0 = time.perf_counter()
        for _ in range(n_batches):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            out = runs[mode]()
            torch.cuda.synchronize()
            secs.append((time.perf_counter() - t1) * 1e3)
        stages[mode + "_batches_s"] = time.perf_counter() - t0
        outs[mode] = [o.cpu().numpy() for o in out]
        n_steps = int(outs[mode][2].reshape(-1)[0])
        t0 = time.perf_counter()
        wall, busy, kern, graph_launches, calls, host_top = step_profile(
            runs[mode], cpu_ops=False)
        syncs = host_syncs(runs[mode])
        stages[mode + "_profile_s"] = time.perf_counter() - t0
        timed = secs[1:] if mode == "eager" else secs
        ms = float(np.median(timed))
        b, k = cfg["batch"], cfg["beam"]
        modes[mode] = {
            "steps_run": n_steps, "ms_a_batch": ms, "ms": secs,
            "ms_a_decode_step": ms / n_steps,
            "generated_tokens_per_s": b * k * n_steps / ms * 1e3,
            "kernels_a_decode_step": sum(kern.values()) / n_steps,
            "host_launch_calls_a_decode_step": calls / n_steps,
            "graph_launches_a_batch": graph_launches,
            "busy_share": busy / wall, "device_busy_ms": busy,
            "profiled_wall_ms": wall, "host_syncs_a_batch": len(syncs),
            "runtime_top": host_top,
            "capture_s": cap.capture_s if mode == "captured" else 0.0,
            "graphs": cap.graphs if mode == "captured" else 0,
            "graph_pool_bytes": cap.pool_bytes if mode == "captured" else 0}
    (ids, scores, _), (c_ids, c_scores, c_steps) = outs["eager"], \
        outs["captured"]
    t0 = time.perf_counter()
    (r_ids, r_scores, r_steps), = exe_c.run_steps(main, [feed], steps=1,
                                                  fetch_list=fetch,
                                                  scope=scope)
    stages["run_steps_s"] = time.perf_counter() - t0
    check(np.array_equal(c_ids, ids) and np.array_equal(c_scores, scores)
          and np.array_equal(r_ids, ids) and np.array_equal(r_scores, scores)
          and int(c_steps[0]) == int(r_steps[0]) == modes["eager"][
              "steps_run"],
          "nmt_beam_decode: captured ids and scores differ from eager ones")
    check(exe_c.host_op_steps == 0 and cap.graphs == 3
          and cap.host_op is None,
          "nmt_beam_decode: the captured step ran eagerly (%d steps) or "
          "has %d graphs" % (exe_c.host_op_steps, cap.graphs))
    n_steps = modes["eager"]["steps_run"]
    t0 = time.perf_counter()
    rmain, picked = build_nmt_rescore(fluid, cfg, n_steps)
    got = exe.run(rmain, feed=dict(feed, **{
        k: torch.as_tensor(v, device=dev)
        for k, v in nmt_rescore_feed(cfg, ids, n_steps).items()}),
        fetch_list=[picked], scope=scope)[0]
    path = path_scores(cfg, ids, got)
    score_err = float(np.max(np.abs(path - scores)
                             / np.maximum(np.abs(scores), 1.0)))
    stages["rescore_s"] = time.perf_counter() - t0
    b, k, v = cfg["batch"], cfg["beam"], cfg["dict_size"]
    check(ids.shape == (b, k, cfg["max_len"]) and ids.min() >= 0
          and ids.max() < v, "nmt_beam_decode: ids %s in [%d, %d]"
          % (ids.shape, ids.min(), ids.max()))
    check(bool((np.diff(scores, axis=1) <= 0).all()),
          "nmt_beam_decode: a row's scores not descending: %r" % scores[:2])
    check(score_err <= 1e-4, "nmt_beam_decode: scores against their paths' "
          "rescored log-probs %.3g (tolerance 1e-4)" % score_err)
    emit("nmt_beam_decode", config=cfg, modes=modes,
         captured_bit_equal_to_eager=True,
         speedup_a_decode_step=modes["eager"]["ms_a_decode_step"]
         / modes["captured"]["ms_a_decode_step"],
         rescored_max_rel_diff=score_err,
         scores_best_beam=scores[:4, 0].tolist(),
         finished_beams=int((ids == cfg["eos"]).any(2).sum()),
         reduced=["random weights from the startup program (no beam ends "
                  "early, so every batch runs all 250 steps)",
                  "seeded source ids and lengths (no WMT data)"],
         users=CF_USERS["nmt_beam_decode"], stages=stages,
         leg_s=time.perf_counter() - t_leg, nvidia_smi=SMI[0])
    exe_c.close()
    del scope, exe, exe_c
    torch.cuda.empty_cache()


def cf_step(fluid, build, place, dtype, arrays, feed):
    """One run of ``build(fluid, dtype)``'s program on ``place`` from
    ``arrays`` (cast to ``dtype``): its fetches and the gradient of every
    parameter, as CPU tensors."""
    main, _, fetch = build(fluid, dtype)
    grads = sorted(main._backward_info["param_to_grad"].values())
    cast = {n: a.astype(dtype) if a.dtype.kind == "f" else a
            for n, a in arrays.items()}
    scope = fluid.io.state_from_numpy(main, cast, fluid.Scope(), place)
    feed = {n: a.astype(dtype) if a.dtype.kind == "f" else a
            for n, a in feed.items()}
    out = fluid.Executor(place).run(main, feed=feed, fetch_list=fetch + grads,
                                    scope=scope, return_numpy=False)
    return {n: torch.as_tensor(o).cpu() for n, o in
            zip([getattr(f, "name", f) for f in fetch] + grads, out)}


def build_ifelse_train(fluid, dtype):
    """An ``IfElse`` that routes rows by label: an fc, then x2 or tanh."""
    L = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = L.data("x", shape=[64], dtype=dtype)
        label = L.data("label", shape=[1], dtype="int64")
        h = L.fc(x, size=256)
        ie = L.IfElse(L.less_than(label, L.fill_constant([1], "int64", 5)))
        with ie.true_block():
            ie.output(L.scale(ie.input(h), scale=2.0))
        with ie.false_block():
            ie.output(L.tanh(ie.input(h)))
        out, = ie()
        loss = L.mean(out * out)
        fluid.optimizer.SGD(0.1).minimize(loss)
    return main, startup, [loss, out]


def build_array_train(fluid, dtype):
    """Rows of an fc written to a tensor array (one past its capacity),
    read, stacked and concatenated back into the loss."""
    L = fluid.layers
    main, startup = fluid.Program(), fluid.Program()

    def idx(i):
        return L.fill_constant([1], "int64", i)

    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = L.data("x", shape=[64], dtype=dtype)
        h = L.fc(x, size=256)
        arr = L.array_write(h, idx(0), capacity=3)
        arr = L.array_write(L.tanh(h), idx(1), array=arr)
        arr = L.array_write(h * 3.0, idx(7), array=arr)  # dropped
        stacked, count = L.array_to_tensor(arr)
        cat, cat_index = L.tensor_array_to_tensor(arr, axis=1)
        r = L.array_read(arr, idx(1))
        n = L.array_length(arr)
        loss = L.elementwise_add(L.mean(r * L.array_read(arr, idx(0))),
                                 L.mean(cat * cat))
        loss = L.elementwise_add(loss, L.mean(stacked))
        fluid.optimizer.SGD(0.1).minimize(loss)
    return main, startup, [loss, stacked, count, cat, cat_index, r, n]


def build_cond_train(fluid, dtype):
    """``cond`` on a fed flag: x2 or -x of an fc."""
    L = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = L.data("x", shape=[64], dtype=dtype)
        flag = L.data("flag", shape=[], dtype="bool",
                      append_batch_size=False)
        h = L.fc(x, size=256)
        out = L.cond(flag, lambda: L.scale(h, scale=2.0),
                     lambda: L.scale(h, scale=-1.0))
        loss = L.mean(out * out)
        fluid.optimizer.SGD(0.1).minimize(loss)
    return main, startup, [loss, out]


def cf_program_case(fluid, build, feed, seed):
    """``build``'s program one step on the card (float32) and the CPU
    (float64) from one start: (card, CPU) fetches and gradients."""
    startup = build(fluid, "float32")[1]
    startup.random_seed = seed
    scope = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=scope)
    arrays = {n: scope.as_numpy(n) for n in scope.vars}
    card = cf_step(fluid, build, fluid.CUDAPlace(0), "float32", arrays, feed)
    cpu = cf_step(fluid, build, fluid.CPUPlace(), "float64", arrays, feed)
    return card, {n: t.float() if t.dtype == torch.float64 else t
                  for n, t in cpu.items()}


def recurrent_card_vs_cpu(dev):
    """``recurrent`` at the LM's full shapes (``build_ptb_rnn`` at
    ``PTB``: T 35, B 20, H 650, 2 layers): its outputs and final states,
    and the gradients of every input and weight against seeded
    cotangents, on the card in float32 against the CPU in float64."""
    from types import SimpleNamespace

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core.registry import OpContext, get_op_impl

    rng = np.random.RandomState(30)
    t, b, h = PTB["num_steps"], PTB["batch_size"], PTB["hidden_size"]
    shapes = {"x_tm": (t, b, h)}
    for k in range(PTB["num_layers"]):
        shapes.update({"h_%d" % k: (b, h), "c_%d" % k: (b, h),
                       "w_%d" % k: (2 * h, 4 * h), "b_%d" % k: (4 * h,)})
    values = {n: rng.uniform(-0.5, 0.5, s) * (0.1 if n[0] == "w" else 1.0)
              for n, s in shapes.items()}
    outs = {}
    for device, dtype in ((torch.device("cpu"), "float64"), (dev, "float32")):
        main, op = build_ptb_rnn(fluid, PTB, dtype)
        env = {n: torch.as_tensor(a.astype(dtype)).to(device)
               .requires_grad_(True) for n, a in values.items()}
        leaves = dict(env)
        trace = SimpleNamespace(program=main, is_test=False, device=device,
                                current_op_idx=0)
        get_op_impl("recurrent")(OpContext(op, env, trace))
        names = op.output_arg_names
        got = [env[n] for n in names]
        g = torch.Generator().manual_seed(31)
        cots = [torch.randn(tuple(x.shape), generator=g, dtype=torch.float64)
                .to(device=device, dtype=x.dtype) for x in got]
        grads = torch.autograd.grad(got, list(leaves.values()), cots)
        res = {n: x.detach().cpu() for n, x in zip(names, got)}
        res.update({n + "@GRAD": x.cpu() for n, x in zip(leaves, grads)})
        outs[dtype] = res
    errs = {}
    for n, want in outs["float64"].items():
        got = outs["float32"][n].double()
        errs[n] = float((got - want).norm() / max(float(want.norm()), 1e-30))
    return errs


def cf_ops_card_vs_cpu(dev):
    """The op-level cases: the tensor-array edges (writes at and past the
    capacity, reads past the count and the capacity) and ``beam_search``
    at [32, 3, 30000] for 4 steps into arrays, then ``beam_search_decode``
    over a capacity of 250: card against CPU, integer outputs identical
    (``beam_search`` in float32 on both: its adds are exact IEEE float32
    on either device, so the ranking is the same; float64 would move near
    ties), and no device assert."""
    import types

    from paddle_tpu_torch.core.registry import OpContext, get_op_impl
    from paddle_tpu_torch.ops.beam_search_ops import EMPTY_ARRAY

    def call(op_type, attrs, env, inputs, outputs, device):
        op = types.SimpleNamespace(
            type=op_type, attrs=dict(attrs), block=None,
            inputs={s: [n] for s, n in inputs.items()},
            outputs={s: [n] for s, n in outputs.items()})
        trace = types.SimpleNamespace(is_test=False, device=device,
                                      program=None)
        get_op_impl(op_type)(OpContext(op, env, trace))

    def run(device):
        x = torch.as_tensor(np.random.RandomState(32).randn(20, 650)
                            .astype(np.float32)).to(device)
        env, out = {"arr": EMPTY_ARRAY}, {}
        for k, i in enumerate((0, 2, 4, 9, -1)):
            env.update(i=torch.full((1,), i, dtype=torch.int64,
                                    device=device), x=x * (k + 1))
            call("write_to_array", {"capacity": 4}, env,
                 {"X": "x", "I": "i", "Array": "arr"}, {"Out": "arr"},
                 device)
            call("lod_array_length", {}, env, {"Array": "arr"},
                 {"Out": "n%d" % k}, device)
            out["n%d" % k] = env["n%d" % k]
        for i in (1, 3, 7, -2):
            env["i"] = torch.full((1,), i, dtype=torch.int64, device=device)
            call("read_from_array", {}, env, {"Array": "arr", "I": "i"},
                 {"Out": "r"}, device)
            out["r%d" % i] = env["r"]
        call("array_to_tensor", {}, env, {"Array": "arr"},
             {"Out": "t", "OutIndex": "ti"}, device)
        call("tensor_array_to_tensor", {"axis": 0}, env, {"X": "arr"},
             {"Out": "c", "OutIndex": "ci"}, device)
        out.update({n: env[n] for n in ("t", "ti", "c", "ci")})
        rng = np.random.RandomState(33)
        b, k, v = NMT_DECODE["batch"], NMT_DECODE["beam"], NMT["dict_size"]
        env = {"pre_ids": torch.full((b, k), 3, dtype=torch.int64,
                                     device=device),
               "pre_scores": torch.as_tensor(np.tile(
                   [0.0, -1e9, -1e9], (b, 1)).astype(np.float32)).to(device),
               "ids": EMPTY_ARRAY, "par": EMPTY_ARRAY}
        for t in range(4):
            # the same float32 log-probs on both devices
            logp = torch.log_softmax(torch.as_tensor(
                rng.randn(b, k, v).astype(np.float32)), -1)
            logp[:, :, 1] += 5.0 * (t == 2)  # end_id wins at step 2
            env.update(logp=logp.to(device), i=torch.full(
                (1,), t, dtype=torch.int64, device=device))
            call("beam_search", {"end_id": 1}, env,
                 {"PreIds": "pre_ids", "PreScores": "pre_scores",
                  "Scores": "logp"},
                 {"SelectedIds": "pre_ids", "SelectedScores": "pre_scores",
                  "ParentIdx": "p"}, device)
            out.update({"ids%d" % t: env["pre_ids"],
                        "scores%d" % t: env["pre_scores"],
                        "parents%d" % t: env["p"]})
            for arr, src in (("ids", "pre_ids"), ("par", "p")):
                call("write_to_array", {"capacity": 250}, env,
                     {"X": src, "I": "i", "Array": arr}, {"Out": arr},
                     device)
        call("beam_search_decode", {"end_id": 1}, env,
             {"Ids": "ids", "Parents": "par", "Scores": "pre_scores"},
             {"SentenceIds": "sent", "SentenceScores": "ss"}, device)
        out.update(sent=env["sent"], ss=env["ss"])
        return {n: t.cpu() for n, t in out.items()}

    card = run(dev)
    torch.cuda.synchronize()  # a device assert would surface here
    return card_cpu_err(card, run(torch.device("cpu"))), card


def nmt_decode_card_vs_cpu():
    """``build_nmt_decode`` at full width with ``max_len``
    ``NMT_DECODE_CHECK_LEN`` on the card and the CPU from one start. At
    the startup's weights the 30,000 log-probs of a row are nearly equal,
    so a row's K beams end one or two float32 ulps apart (1.5e-5 at a
    score of 165): the card's and the CPU's log-probs part by an ulp, and
    a beam may take the other of two tied candidates. So the K scores of
    every row must agree to 1e-5, and each of the card's paths, rescored
    on the CPU by the teacher-forced StaticRNN (``build_nmt_rescore``),
    must score what the card reported, to 1e-5; the rows whose ids are
    identical are counted. A second run on the card, its feeds there,
    counts the host syncs of a batch: the condition's read, once an
    iteration and once more, and nothing else. Returns that line."""
    import paddle_tpu_torch as fluid

    cfg = dict(NMT_DECODE, max_len=NMT_DECODE_CHECK_LEN)
    main, startup, sent_ids, sent_scores, steps = build_nmt_decode(fluid,
                                                                   cfg)
    init = fluid.Scope()
    cpu = fluid.Executor(fluid.CPUPlace())
    cpu.run(startup, scope=init)
    arrays = {n: init.as_numpy(n) for n in init.vars}
    feed = nmt_decode_feed(cfg)
    out = []
    for place in (fluid.CPUPlace(), fluid.CUDAPlace(0)):
        scope = fluid.io.state_from_numpy(main, arrays, fluid.Scope(), place)
        exe = fluid.Executor(place)
        out.append(exe.run(main, feed=feed, scope=scope,
                           fetch_list=[sent_ids, sent_scores, steps]))
    dfeed = {k: torch.as_tensor(v, device=scope.find_var("dec_out_w").device)
             for k, v in feed.items()}
    syncs = host_syncs(lambda: exe.run(
        main, feed=dfeed, fetch_list=[sent_ids, sent_scores, steps],
        scope=scope, return_numpy=False))
    (ci, cs, cn), (gi, gs, gn) = out
    n = int(gn[0])
    rmain, picked = build_nmt_rescore(fluid, cfg, n)
    rescored = cpu.run(rmain, feed=dict(feed, **nmt_rescore_feed(cfg, gi, n)),
                       fetch_list=[picked], scope=init)[0]
    same = (gi == ci).all(axis=(1, 2))
    return {"rows_identical": int(same.sum()), "rows": len(same),
            "scores_err": float(np.max(np.abs(gs - cs)
                                       / np.maximum(np.abs(cs), 1.0))),
            "card_paths_rescored_on_cpu_err": float(np.max(np.abs(
                path_scores(cfg, gi, rescored) - gs)
                / np.maximum(np.abs(gs), 1.0))),
            "smallest_gap_between_beams": float(np.min(-np.diff(cs, axis=1))),
            "steps": [n, int(cn[0])], "host_syncs_a_batch": len(syncs),
            "tol": 1e-5}


# the op names the control-flow slice registers
CONTROL_FLOW_OPS = 11


def control_flow_ops_leg():
    """Every op of the slice on the card against the CPU: ``recurrent`` at
    the LM's full shapes (float32 against float64, forward and backward,
    1e-4, the worst printed); the six array ops through a training
    program (``build_array_train``: forward and backward, 1e-5 norm-wise,
    integer outputs equal) and at their edges (op level, identical);
    ``IfElse`` and ``cond`` (``conditional_block``) through training
    programs (1e-5); ``beam_search`` at [32, 3, 30000] and
    ``beam_search_decode`` over a capacity of 250 (identical); ``while``
    through ``build_nmt_decode`` at full width and ``max_len`` 16 (scores
    1e-5, the card's paths rescored on the CPU 1e-5, the rows of
    identical ids counted: ``nmt_decode_card_vs_cpu``)."""
    import paddle_tpu_torch as fluid

    t_leg = time.perf_counter()
    dev = torch.device("cuda", torch.cuda.current_device())
    rows, ops = {}, set()
    t0 = time.perf_counter()
    rec = recurrent_card_vs_cpu(dev)
    worst = max(rec, key=rec.get)
    rows["recurrent"] = {"worst": [worst, rec[worst]], "tensors": len(rec),
                         "tol": 1e-4, "s": time.perf_counter() - t0}
    check(rec[worst] <= 1e-4, "control_flow_ops recurrent: card against "
          "CPU %r" % rec)
    ops.add("recurrent")
    rng = np.random.RandomState(34)
    x = rng.randn(32, 64)
    label = rng.randint(0, 10, (32, 1)).astype("int64")
    for name, build, feed, held in (
            ("arrays", build_array_train, {"x": x},
             ("create_array", "write_to_array", "read_from_array",
              "lod_array_length", "array_to_tensor",
              "tensor_array_to_tensor")),
            ("ifelse", build_ifelse_train, {"x": x, "label": label}, ()),
            ("cond_true", build_cond_train, {"x": x, "flag": np.array(True)},
             ("conditional_block",)),
            ("cond_false", build_cond_train,
             {"x": x, "flag": np.array(False)}, ())):
        t0 = time.perf_counter()
        card, cpu = cf_program_case(fluid, build, feed, seed=35)
        err, exact = card_cpu_err(card, cpu)
        rows[name] = {"err": err, "exact": exact, "tensors": len(cpu),
                      "tol": 1e-5, "s": time.perf_counter() - t0}
        check(err <= 1e-5 and exact and len(cpu) > 2,
              "control_flow_ops %s: card against CPU %r" % (name,
                                                             rows[name]))
        ops.update(held)
    t0 = time.perf_counter()
    (err, exact), card = cf_ops_card_vs_cpu(dev)
    rows["array_edges_and_beam_search"] = {
        "err": err, "exact": exact, "lengths": [
            int(card["n%d" % k][0]) for k in range(5)],
        "finished_after": int((card["ids3"] == 1).sum()),
        "s": time.perf_counter() - t0}
    check(exact and err <= 1e-5 and rows["array_edges_and_beam_search"][
        "lengths"] == [1, 3, 4, 4, 4],
          "control_flow_ops array edges and beam search: card against CPU "
          "%r" % rows["array_edges_and_beam_search"])
    ops.update(("beam_search", "beam_search_decode"))
    t0 = time.perf_counter()
    dec = rows["while_nmt_decode"] = nmt_decode_card_vs_cpu()
    dec["s"] = time.perf_counter() - t0
    check(dec["scores_err"] <= 1e-5
          and dec["card_paths_rescored_on_cpu_err"] <= 1e-5
          and dec["steps"] == [NMT_DECODE_CHECK_LEN] * 2
          and dec["host_syncs_a_batch"] == NMT_DECODE_CHECK_LEN + 1,
          "control_flow_ops while (nmt decode at max_len %d): %r"
          % (NMT_DECODE_CHECK_LEN, dec))
    ops.add("while")
    emit("control_flow_ops", cases=rows, ops_held=len(ops),
         worst_recurrent={"tensor": worst, "err": rec[worst]},
         seconds=time.perf_counter() - t_leg)
    check(len(ops) == CONTROL_FLOW_OPS, "control_flow_ops: %d of the "
          "slice's %d ops held: %s" % (len(ops), CONTROL_FLOW_OPS,
                                       sorted(ops)))
    torch.cuda.empty_cache()


def control_flow_phase(xent_rows):
    """The control-flow slice's legs: ``ptb_lm_train`` (StaticRNN
    training, eager and captured), ``nmt_beam_decode`` (While, tensor
    arrays and beam search, eager) and ``control_flow_ops`` (card against
    CPU)."""
    secs = {}
    for name, leg, args in (("ptb_lm_train", ptb_lm_train_leg, (xent_rows,)),
                            ("nmt_beam_decode", nmt_beam_decode_leg, ()),
                            ("control_flow_ops", control_flow_ops_leg, ())):
        t0 = time.perf_counter()
        leg(*args)
        secs[name] = time.perf_counter() - t0
    emit("control_flow_seconds", **secs)


# -- the op remainder: CTC, the sampled heads, the host ops -------------------

# PaddlePaddle/models fluid/ocr_recognition crnn_ctc_model.py at its
# published widths: grey 1 x 48 x 384 text lines, four groups of two 3 x 3
# convs (16, 32, 64, 128 filters, batch norm + ReLU each) with a 2 x 2 max
# pool after the first three, im2sequence over the 6-high map (48 frames of
# 768), two fc of 600 into a forward and a reverse GRU of 200 (candidate
# ReLU), fc to 95 characters + the blank (95); warpctc(norm_by_times),
# Momentum(1e-3, 0.9) with L2 4e-4; batch 32, labels of 4-20 characters
CRNN = dict(image=(1, 48, 384), filters=(16, 32, 64, 128), rnn_hidden=200,
            num_classes=95, min_label=4, max_label=20)
CRNN_BATCH = 32
CRNN_L2, CRNN_LR, CRNN_MOMENTUM = 4e-4, 1e-3, 0.9
CRNN_EVAL_BATCHES = 4      # ocr_ctc_eval: one warm-up and 3 timed
# word2vec_heads: the book's N-gram model with the softmax fc replaced;
# nce draws 5 negatives a word
W2V_NCE_NEGATIVES = 5
# SGD rates a head: each loss falls within a leg's 7 steps on one batch
# (nce's through the noise of its fresh negatives each step)
W2V_HEADS_LR = {"hsigmoid": 0.1, "nce": 0.2}
# each leg's users, for its line
OP_REMAINDER_USERS = {
    "ocr_ctc_train": "text-line recognisers (CRNN-CTC, the Fluid model "
                     "zoo's ocr_recognition)",
    "word2vec_heads": "embedding and language-model trainers over large "
                      "vocabularies, where a sampled or tree head replaces "
                      "the full softmax",
}


def _crnn_attr(fluid, std, lr=1.0):
    """crnn_ctc_model.py's parameter attributes: a normal initializer,
    L2 decay, a learning-rate scale (one object a parameter)."""
    return fluid.ParamAttr(initializer=fluid.initializer.Normal(0.0, std),
                           regularizer=fluid.regularizer.L2Decay(CRNN_L2),
                           learning_rate=lr)


def crnn_encoder(fluid, images, filters, rnn_hidden, num_classes):
    """crnn_ctc_model.py's ``encoder_net``: ``ocr_convs`` (the first
    group's convs initialised at std 0.0005, the rest 0.01), im2sequence
    over the map's whole height, the two GRUs, the output fc [B, T, C+1]
    (one weight an input, as Fluid's ``fc`` over a list makes them)."""
    L = fluid.layers
    tmp = images
    for g, ch in enumerate(filters):
        for _ in range(2):
            tmp = L.conv2d(tmp, num_filters=ch, filter_size=3, padding=1,
                           param_attr=_crnn_attr(fluid, 0.0005 if g == 0
                                                 else 0.01))
            tmp = L.batch_norm(tmp, act="relu",
                               param_attr=_crnn_attr(fluid, 0.01),
                               bias_attr=_crnn_attr(fluid, 0.0))
        if g < len(filters) - 1:
            tmp = L.pool2d(tmp, pool_size=2, pool_type="max", pool_stride=2,
                           ceil_mode=True)
    seq = L.im2sequence(tmp, filter_size=[tmp.shape[2], 1], stride=[1, 1])
    grus = []
    for reverse in (False, True):
        fc = L.fc(seq, rnn_hidden * 3, num_flatten_dims=2,
                  param_attr=_crnn_attr(fluid, 0.02),
                  bias_attr=_crnn_attr(fluid, 0.02))
        grus.append(L.dynamic_gru(
            fc, rnn_hidden, is_reverse=reverse,
            param_attr=_crnn_attr(fluid, 0.02),
            bias_attr=_crnn_attr(fluid, 0.02, lr=2.0),
            candidate_activation="relu"))
    return L.fc(grus, num_classes + 1, num_flatten_dims=2,
                param_attr=[_crnn_attr(fluid, 0.02) for _ in grus],
                bias_attr=_crnn_attr(fluid, 0.0))


def build_crnn_ctc(fluid, image, filters, rnn_hidden, num_classes,
                   max_label, **_):
    """crnn_ctc_model.py's ``ctc_train_net`` over padded labels
    ([B, max_label] + ``label_length``): the summed CTC loss (blank =
    ``num_classes``, ``norm_by_times``) under Momentum with L2, and on its
    ``for_test`` clone the greedy decode and the edit distance to the
    label. Returns (main, startup, loss, (test program, logits, decoded
    ids, decoded lengths, distances, sequence count))."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 4
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        L = fluid.layers
        pixel = L.data("pixel", shape=list(image), dtype="float32")
        label = L.data("label", shape=[max_label], dtype="int64")
        label_len = L.data("label_length", shape=[], dtype="int64")
        logits = crnn_encoder(fluid, pixel, filters, rnn_hidden, num_classes)
        cost = L.warpctc(logits, label, blank=num_classes, norm_by_times=True,
                         label_length=label_len)
        loss = L.reduce_sum(cost)
        decoded, decoded_len = L.ctc_greedy_decoder(logits, blank=num_classes)
        dist, seq_num = L.edit_distance(decoded, label, normalized=False,
                                        input_length=decoded_len,
                                        label_length=label_len)
        test = main.clone(for_test=True)
        fluid.optimizer.Momentum(CRNN_LR, CRNN_MOMENTUM).minimize(loss)
    return main, startup, loss, (test, logits, decoded, decoded_len, dist,
                                 seq_num)


def crnn_feed(cfg, batch, seed=0):
    """Seeded grey text-line images (the reader's ``pixel - 127.5`` range)
    and label strings of ``min_label``-``max_label`` characters in
    [0, num_classes), padded with 0."""
    rng = np.random.RandomState(seed)
    c, h, w = cfg["image"]
    lens = rng.randint(cfg["min_label"], cfg["max_label"] + 1, batch)
    label = rng.randint(0, cfg["num_classes"], (batch, cfg["max_label"]))
    label[np.arange(cfg["max_label"])[None] >= lens[:, None]] = 0
    return {"pixel": rng.uniform(-127.5, 127.5, (batch, c, h, w)).astype(
                "float32"),
            "label": label.astype("int64"),
            "label_length": lens.astype("int64")}


def levenshtein(a, b):
    """The edit distance of two id lists, on the host."""
    d = list(range(len(b) + 1))
    for i, x in enumerate(a, 1):
        prev, d[0] = d[0], i
        for j, y in enumerate(b, 1):
            prev, d[j] = d[j], min(d[j] + 1, d[j - 1] + 1, prev + (x != y))
    return d[-1]


def greedy_collapse(logits, blank):
    """Host CTC greedy decode of [B, T, C] logits: each row's argmax path,
    repeats merged, blanks dropped."""
    out = []
    for row in np.argmax(logits, axis=-1):
        keep, prev = [], -1
        for v in row:
            if v != blank and v != prev:
                keep.append(int(v))
            prev = v
        out.append(keep)
    return out


def ocr_ctc_eval(exe, extra, dfeed, feed, scope):
    """``ocr_ctc_eval``: the ``for_test`` clone on the trained weights,
    ``CRNN_EVAL_BATCHES`` seeded batches (the first a warm-up): ms a
    batch; every decoded id in [0, num_classes) with -1 past its length,
    no blank and no repeat left, the ids equal to a host greedy decode of
    the same logits, each distance equal to a host Levenshtein of the
    pair exactly; the distances into ``fluid.metrics.EditDistance``."""
    import paddle_tpu_torch as fluid

    test, logits, decoded, decoded_len, dist, seq_num = extra
    cfg, batch = CRNN, CRNN_BATCH
    blank = cfg["num_classes"]
    metric = fluid.metrics.EditDistance()
    secs, rows = [], 0
    for i in range(CRNN_EVAL_BATCHES):
        f = feed if i == 0 else crnn_feed(cfg, batch, seed=100 + i)
        df = dfeed if i == 0 else {k: torch.as_tensor(v, device=exe.place)
                                   for k, v in f.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = exe.run(test, feed=df, fetch_list=[logits, decoded,
                                                  decoded_len, dist, seq_num],
                       scope=scope, return_numpy=False)
        torch.cuda.synchronize()
        secs.append((time.perf_counter() - t0) * 1e3)
        lg, ids, n, d, sn = (o.cpu().numpy() for o in outs)
        host = greedy_collapse(lg, blank)
        for r in range(batch):
            got = list(ids[r, :n[r]])
            check(got == host[r] and (ids[r, n[r]:] == -1).all()
                  and all(0 <= v < blank for v in got)
                  and all(a != b for a, b in zip(got, got[1:])),
                  "ocr_ctc_eval: row %d decoded %r (length %d), the host's "
                  "greedy decode %r" % (r, list(ids[r]), n[r], host[r]))
            want = levenshtein(got, list(f["label"][r, :f["label_length"][r]]))
            check(float(d[r, 0]) == want,
                  "ocr_ctc_eval: row %d distance %r, host Levenshtein %d"
                  % (r, float(d[r, 0]), want))
        metric.update(d, sn)
        rows += batch
    avg, err_rate = metric.eval()
    return {"ms_a_batch": float(np.median(secs[1:])), "ms": secs,
            "rows_checked": rows, "decoded_equal_to_host_greedy": True,
            "distances_equal_to_host_levenshtein": True,
            "avg_edit_distance": float(np.asarray(avg).item()),
            "avg_instance_error": float(np.asarray(err_rate).item()),
            "mean_decoded_length": float(n.mean()),
            "nvidia_smi": SMI[0]}


def eager_runs_bit_equal(build, feed, steps=3):
    """Two eager runs of ``steps`` steps of ``build(fluid)``'s program on
    the card from one start (the startup run once, its state cloned):
    their losses and every state tensor bit-equal."""
    import paddle_tpu_torch as fluid

    main, startup, loss, _ = build(fluid)
    start = fluid.Scope()
    fluid.Executor(fluid.CUDAPlace(0)).run(startup, scope=start)
    feed = {k: torch.as_tensor(v, device=fluid.CUDAPlace(0))
            for k, v in feed.items()}
    runs = []
    for _ in range(2):
        scope = clone_scope(fluid, start)
        exe = fluid.Executor(fluid.CUDAPlace(0))
        main._tpu_step_counter = 0
        losses = [exe.run(main, feed=feed, fetch_list=[loss], scope=scope,
                          return_numpy=False)[0].clone()
                  for _ in range(steps)]
        runs.append((torch.stack(losses), scope))
    (la, sa), (lb, sb) = runs
    _, state_err, state_equal = state_norm_err(sa, sb)
    return {"steps": steps, "losses_bit_equal": bool(torch.equal(la, lb)),
            "state_bit_equal": bool(state_equal),
            "state_max_norm_diff": state_err}


def ocr_ctc_train_leg():
    """``ocr_ctc_train`` (``seq_leg``: eager and captured steps in turns,
    2 warm-ups, the capture step and 4 timed each; captured = eager 1e-6,
    losses falling, no host sync in an eager step, profiles), its
    ``ocr_ctc_eval`` on the eager run's weights, and two eager runs from
    one start bit-equal; ``ocr_ctc_eval`` also at the startup weights.
    The path reaches no hand-written kernel: CTC, the GRUs and the
    convolutions are torch and cuDNN calls. The leg runs with cuDNN's
    deterministic algorithms, as a user who wants repeatable runs sets
    it: left to its default, cuDNN's backward parts the conv weights and
    biases between two runs from one start on the H100 (82 state tensors
    after 4 steps, the losses still equal), and captured from eager."""
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        _ocr_ctc_train()
    finally:
        torch.backends.cudnn.deterministic = prev


def _ocr_ctc_train():
    cfg = CRNN
    feed = crnn_feed(cfg, CRNN_BATCH)
    frames = CRNN_BATCH * cfg["image"][2] // 8
    line, launches, _ = seq_leg(
        "ocr_ctc_train", lambda fluid: build_crnn_ctc(fluid, **cfg), feed,
        {}, frames, CRNN_BATCH, decode=ocr_ctc_eval)
    check(launches["K2a"] == launches["K4a"] == launches["K4b"] == 0,
          "ocr_ctc_train: launches %r" % launches)
    t0 = time.perf_counter()
    bits = eager_runs_bit_equal(lambda fluid: build_crnn_ctc(fluid, **cfg),
                                feed)
    check(bits["losses_bit_equal"] and bits["state_bit_equal"],
          "ocr_ctc_train: two eager runs from one start part: %r" % bits)
    bits["s"] = time.perf_counter() - t0
    emit("ocr_ctc_train", config=cfg,
         optimizer="Momentum(%g, %g) + L2Decay(%g)" % (
             CRNN_LR, CRNN_MOMENTUM, CRNN_L2),
         frames_a_step=frames, label_chars=int(feed["label_length"].sum()),
         images_per_s_eager=line["sequences_per_s_eager"],
         images_per_s_captured=line["sequences_per_s_captured"],
         eager_runs=bits, cudnn_deterministic=True,
         reduced=["seeded images and labels (no OCR dataset in the "
                  "repository)"],
         users=OP_REMAINDER_USERS["ocr_ctc_train"], **line)
    # the decode also at the startup weights, whose paths are not yet all
    # blanks
    import paddle_tpu_torch as fluid

    main, startup, _, extra = build_crnn_ctc(fluid, **cfg)
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CUDAPlace(0))
    exe.run(startup, scope=scope)
    dfeed = {k: torch.as_tensor(v, device=exe.place) for k, v in feed.items()}
    at_start = ocr_ctc_eval(exe, extra, dfeed, feed, scope)
    emit("ocr_ctc_eval", batch=CRNN_BATCH, trained=line["decode"],
         at_startup_weights=at_start)


def build_word2vec_head(fluid, head):
    """The book's N-gram word2vec (``tests/book/test_word2vec.py``) at its
    widths (V = 2073, embedding 32, hidden 256, batch 100) with the
    softmax fc replaced by ``hsigmoid`` or by ``nce`` (5 uniform
    negatives), under SGD. The four context words are one lookup of
    [B, 4] ids in the shared ``is_sparse`` table (both packages refuse a
    sparse table looked up twice), so its rows-only gradient goes through
    K4b once a step."""
    v = W2V["dict_size"]
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 6
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        L = fluid.layers
        words = [L.data(n, shape=[1], dtype="int64")
                 for n in ("firstw", "secondw", "thirdw", "forthw")]
        nextw = L.data("nextw", shape=[1], dtype="int64")
        emb = L.embedding(L.concat(words, axis=1),
                          size=[v, W2V["embed_size"]], is_sparse=True,
                          param_attr=fluid.ParamAttr(name="shared_w"))
        hidden = L.fc(L.reshape(emb, [-1, 4 * W2V["embed_size"]]),
                      size=W2V["hidden_size"], act="sigmoid")
        if head == "hsigmoid":
            cost = L.hsigmoid(hidden, nextw, num_classes=v)
        else:
            cost = L.nce(hidden, nextw, num_total_classes=v,
                         num_neg_samples=W2V_NCE_NEGATIVES)
        loss = L.mean(cost)
        fluid.optimizer.SGD(W2V_HEADS_LR[head]).minimize(loss)
    return main, startup, loss, None


def word2vec_heads_leg(k4_rows):
    """``word2vec_heads``: ``seq_leg`` of each head (eager and captured in
    turns, captured = eager bit for bit, losses and state: ``nce``'s
    negatives come from the op's generator, reseeded each step, and the
    shared table's duplicate ids are summed by ``merge_rows`` in one order
    on every run), K4b once a step on the shared table by host count and
    in one replay."""
    feed = ngram_feed()
    out = {}
    for head in ("hsigmoid", "nce"):
        line, launches, counts = seq_leg(
            "word2vec_%s" % head,
            lambda fluid, h=head: build_word2vec_head(fluid, h), feed,
            {"K4b": (K4B_KERNEL, 1)}, W2V_BATCH, W2V_BATCH)
        check(launches["K4b"] == SEQ_HOST_STEPS and launches["K2a"] == 0,
              "word2vec_heads %s: launches %r" % (head, launches))
        check(line["bit_equal"], "word2vec_heads %s: captured %r, eager "
              "%r, state %.3g norm-wise: not bit-equal"
              % (head, line["losses_captured"], line["losses_eager"],
                 line["state_max_norm_diff"]))
        line["words_per_s_eager"] = line.pop("sequences_per_s_eager")
        line["words_per_s_captured"] = line.pop("sequences_per_s_captured")
        out[head] = line
        k4_rows[1].setdefault("word2vec_heads", {})[head] = {
            "launches": launches["K4b"], "host_steps": SEQ_HOST_STEPS,
            "captured_launches_a_step": counts["K4b"]}
    emit("word2vec_heads", config=W2V, batch=W2V_BATCH,
         optimizer={h: "SGD(%g)" % lr for h, lr in W2V_HEADS_LR.items()},
         nce_negatives=W2V_NCE_NEGATIVES,
         users=OP_REMAINDER_USERS["word2vec_heads"], **out)


def op_remainder_cases():
    """(name, op type, attrs, inputs (a thunk of CPU tensors), outputs) of
    every op of the slice held card = CPU, at its path's shapes where a
    path runs it: CTC at the CRNN's [32, 48, 96] with 20-character
    labels, chunk_eval at the SRL tagger's [10, 64] over 29 types, the
    heads at word2vec's [100, 256] over 2073 classes; the rest at small
    model-like shapes. The random ops are held in their test mode (nce's
    class-0 negatives, random_crop's centre) or, for ``sample_logits``,
    on samples the card drew."""
    g = torch.Generator().manual_seed(21)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=g) * scale

    def ints(hi, *shape, lo=0):
        return torch.randint(lo, hi, shape, generator=g)

    b, t, c = CRNN_BATCH, CRNN["image"][2] // 8, CRNN["num_classes"] + 1
    ml = CRNN["max_label"]

    def ctc():
        lab_len = ints(ml + 1, b, lo=CRNN["min_label"])
        return {"Logits": randn(b, t, c, scale=2.0),
                "Label": ints(c - 1, b, ml), "LabelLength": lab_len,
                "LogitsLength": torch.full((b,), t)}

    def greedy():
        return {"Input": ints(c, b, t), "Length": ints(t + 1, b, lo=1)}

    def edit():
        return {"Hyps": ints(c - 1, b, t), "Refs": ints(c - 1, b, ml),
                "HypsLength": ints(t + 1, b), "RefsLength": ints(ml + 1, b)}

    def chunks():
        lab = ints(SRL["label_dict_len"], SRL_BATCH, SRL_T)
        inf = torch.where(torch.rand(lab.shape, generator=g) < 0.3,
                          ints(SRL["label_dict_len"], SRL_BATCH, SRL_T), lab)
        return {"Inference": inf, "Label": lab,
                "Length": ints(SRL_T + 1, SRL_BATCH, lo=SRL_MIN)}

    v, hd = W2V["dict_size"], W2V["hidden_size"]

    def head(with_bias=True):
        d = {"X": randn(W2V_BATCH, hd), "W": randn(v - 1, hd, scale=0.05),
             "Label": ints(v, W2V_BATCH, 1)}
        if with_bias:
            d["Bias"] = randn(v - 1, scale=0.05)
        return d

    def nce():
        return {"Input": randn(W2V_BATCH, hd), "Weight": randn(v, hd,
                                                               scale=0.05),
                "Bias": randn(v, scale=0.05), "Label": ints(v, W2V_BATCH, 1)}

    def unpool():
        # each window's recorded position, as max_pool2d_with_index makes it
        n, ch, oh, ow = 16, 64, 28, 28
        dy, dx = ints(2, n, ch, oh, ow), ints(2, n, ch, oh, ow)
        rows = torch.arange(oh)[:, None] * 2 + dy
        cols = torch.arange(ow)[None, :] * 2 + dx
        return {"X": randn(n, ch, oh, ow), "Indices": (rows * 2 * ow + cols)
                .to(torch.int32)}

    edges = torch.zeros(8, 12, 2, dtype=torch.long)
    for i in range(11):
        edges[:, i] = torch.tensor([i // 2 + 1, i + 2])
    return [
        ("warpctc", "warpctc", {"blank": c - 1, "norm_by_times": True}, ctc,
         {"Loss": 1}),
        ("ctc_align", "ctc_align", {"blank": c - 1}, greedy,
         {"Output": 1, "OutputLength": 1}),
        ("edit_distance", "edit_distance", {"normalized": False}, edit,
         {"Out": 1, "SequenceNum": 1}),
        ("chunk_eval", "chunk_eval", {"num_chunk_types": SRL_CHUNK_TYPES,
                                      "chunk_scheme": "IOB"}, chunks,
         {"Precision": 1, "Recall": 1, "F1-Score": 1, "NumInferChunks": 1,
          "NumLabelChunks": 1, "NumCorrectChunks": 1}),
        ("hierarchical_sigmoid", "hierarchical_sigmoid", {"num_classes": v},
         head, {"Out": 1, "PreOut": 1}),
        ("nce_test_mode", "nce", {"num_neg_samples": W2V_NCE_NEGATIVES,
                                  "num_total_classes": v, "is_test": True},
         nce, {"Cost": 1, "SampleLogits": 1, "SampleLabels": 1}),
        ("precision_recall", "precision_recall", {"class_number": 10},
         lambda: {"Indices": ints(10, 256, 1), "Labels": ints(10, 256, 1),
                  "Weights": torch.rand(256, 1, generator=g),
                  "StatesInfo": ints(9, 10, 4).float()},
         {"BatchMetrics": 1, "AccumMetrics": 1, "AccumStatesInfo": 1}),
        ("positive_negative_pair", "positive_negative_pair", {"column": 0},
         lambda: {"Score": ints(8, 512, 1).float(),
                  "Label": ints(3, 512, 1).float(),
                  "QueryID": ints(16, 512, 1),
                  "Weight": torch.rand(512, 1, generator=g)},
         {"PositivePair": 1, "NegativePair": 1, "NeutralPair": 1}),
        ("spp", "spp", {"pyramid_height": 3, "pooling_type": "max"},
         lambda: {"X": randn(16, 256, 13, 13)}, {"Out": 1}),
        ("max_pool2d_with_index", "max_pool2d_with_index",
         {"ksize": [3, 3], "strides": [2, 2], "paddings": [1, 1]},
         lambda: {"X": randn(8, 64, 56, 56)}, {"Out": 1, "Mask": 1}),
        ("unpool", "unpool", {"ksize": [2, 2], "strides": [2, 2]},
         unpool, {"Out": 1}),
        ("grid_sampler", "grid_sampler", {},
         lambda: {"X": randn(8, 32, 28, 28),
                  "Grid": torch.rand(8, 28, 28, 2, generator=g) * 2.4 - 1.2},
         {"Output": 1}),
        ("psroi_pool", "psroi_pool",
         {"output_channels": 10, "pooled_height": 3, "pooled_width": 3,
          "spatial_scale": 0.0625},
         lambda: {"X": randn(2, 90, 38, 50),
                  "ROIs": torch.cat([torch.rand(16, 2, generator=g) * 400,
                                     torch.rand(16, 2, generator=g) * 200
                                     + 400], dim=1),
                  "BatchId": ints(2, 16)}, {"Out": 1}),
        ("add_position_encoding", "add_position_encoding",
         {"alpha": 1.0, "beta": 1.0}, lambda: {"X": randn(64, 256, 512)},
         {"Out": 1}),
        ("affine_grid", "affine_grid", {"output_shape": [32, 1, 48, 384]},
         lambda: {"Theta": randn(32, 2, 3)}, {"Output": 1}),
        ("modified_huber_loss", "modified_huber_loss", {},
         lambda: {"X": randn(1024, 1) * 2, "Y": ints(2, 1024, 1).float()},
         {"IntermediateVal": 1, "Out": 1}),
        ("teacher_student_sigmoid_loss", "teacher_student_sigmoid_loss", {},
         lambda: {"X": randn(1024, 1),
                  "Label": torch.rand(1024, 1, generator=g) * 4 - 2},
         {"Y": 1}),
        ("random_crop_test_mode", "random_crop",
         {"shape": [3, 224, 224], "is_test": True},
         lambda: {"X": randn(16, 3, 256, 256)}, {"Out": 1}),
        ("spectral_norm", "spectral_norm", {"dim": 0, "power_iters": 2},
         lambda: {"Weight": randn(64, 64, 3, 3), "U": randn(64),
                  "V": randn(576)}, {"Out": 1, "UOut": 1, "VOut": 1}),
        ("conv_shift", "conv_shift", {},
         lambda: {"X": randn(32, 128), "Y": randn(32, 3)}, {"Out": 1}),
        ("similarity_focus", "similarity_focus",
         {"axis": 1, "indexes": [0, 3]},
         lambda: {"X": randn(16, 8, 32, 32)}, {"Out": 1}),
        ("fused_embedding_seq_pool", "fused_embedding_seq_pool", {},
         lambda: {"W": randn(10000, 64), "Ids": ints(10000, 256, 20, 1),
                  "Length": ints(21, 256, lo=1)}, {"Out": 1}),
        ("max_pool3d_with_index", "max_pool3d_with_index",
         {"ksize": [2, 2, 2], "strides": [2, 2, 2]},
         lambda: {"X": randn(8, 64, 8, 28, 28)}, {"Out": 1, "Mask": 1}),
        ("fill", "fill", {"shape": [4, 8], "dtype": "float32",
                          "value": [float(i) for i in range(32)]},
         lambda: {}, {"Out": 1}),
        ("tree_conv", "tree_conv", {"max_depth": 3},
         lambda: {"NodesVector": randn(8, 13, 64), "EdgeSet": edges,
                  "Filter": randn(64, 3, 32, 4)}, {"Out": 1}),
        ("hash", "hash", {"num_hash": 4, "mod_by": 1000003},
         lambda: {"X": ints(2 ** 31 - 1, 4096, 2, lo=-2 ** 31)}, {"Out": 1}),
    ]


def random_heads_on_card(dev):
    """The slice's random draws on the card: ``nce``'s negatives uniform
    in [0, V), ``sample_logits``'s log-uniform, ``sampling_id`` by its
    rows' law, ``random_crop``'s offsets in range, each the same bits from
    the same seed; ``sample_logits`` on the card's own samples (given as
    ``CustomizedSamples``) = the CPU's."""
    from types import SimpleNamespace

    from paddle_tpu_torch.core.registry import OpContext, get_op_impl
    from paddle_tpu_torch.executor import TraceContext

    def run(op_type, attrs, inputs, outs):
        draws = []
        for _ in range(2):
            env = {k: v.to(dev) for k, v in inputs.items()}
            op = SimpleNamespace(type=op_type, attrs=dict(attrs), block=None,
                                 inputs={k: [k] for k in inputs},
                                 outputs={k: [k] for k in outs})
            trace = TraceContext(SimpleNamespace(random_seed=5), False, dev,
                                 0)
            get_op_impl(op_type)(OpContext(op, env, trace))
            draws.append({k: env[k] for k in outs})
        same = all(torch.equal(draws[0][k], draws[1][k]) for k in outs)
        return {k: v.cpu() for k, v in draws[0].items()}, same

    g = torch.Generator().manual_seed(22)
    v, n = W2V["dict_size"], 20000
    out = {}
    got, same = run("nce", {"num_neg_samples": W2V_NCE_NEGATIVES,
                            "num_total_classes": v},
                    {"Input": torch.randn(n, 8, generator=g),
                     "Weight": torch.randn(v, 8, generator=g),
                     "Label": torch.randint(0, v, (n, 1), generator=g)},
                    ("SampleLabels",))
    neg = got["SampleLabels"][:, 1:].double()
    mean_sigma = ((v ** 2 - 1) / 12 / neg.numel()) ** 0.5
    out["nce"] = {"ok": bool(same and neg.min() >= 0 and neg.max() < v and
                             abs(float(neg.mean()) - (v - 1) / 2)
                             < 5 * mean_sigma),
                  "mean": float(neg.mean())}
    logits = torch.randn(4000, v, generator=g)
    labels = torch.randint(0, v, (4000, 1), generator=g)
    got, same = run("sample_logits", {"num_samples": 20},
                    {"Logits": logits, "Labels": labels},
                    ("Samples", "Probabilities", "SampledLogits"))
    neg = got["Samples"][:, 1:].long().reshape(-1)
    # the share of draws below k under the log-uniform law
    k = 10
    want = np.log(k + 1.0) / np.log(v + 1.0)
    share = float((neg < k).double().mean())
    env = {"Logits": logits, "Labels": labels,
           "CustomizedSamples": got["Samples"].long(),
           "CustomizedProbabilities": got["Probabilities"]}
    op = SimpleNamespace(type="sample_logits", attrs={"num_samples": 20},
                         block=None, inputs={k_: [k_] for k_ in env},
                         outputs={"SampledLogits": ["SampledLogits"]})
    get_op_impl("sample_logits")(OpContext(op, env, SimpleNamespace(
        is_test=False, device=torch.device("cpu"), program=None)))
    # the accidental hits (pushed down by 1e20) must match; the rest to 1e-5
    want_l, got_l = env["SampledLogits"].double(), got["SampledLogits"].double()
    hit = want_l < -1e19
    err = float((got_l - want_l)[~hit].norm() / want_l[~hit].norm())
    same = same and torch.equal(hit, got_l < -1e19)
    out["sample_logits"] = {
        "ok": bool(same and neg.min() >= 0 and neg.max() < v
                   and abs(share - want) < 5 * (want * (1 - want)
                                                / neg.numel()) ** 0.5
                   and err <= 1e-5),
        "share_below_10": share, "want": want, "card_vs_cpu_err": err,
        "accidental_hits": int(hit.sum())}
    probs = torch.tensor([[0.1, 0.6, 0.0, 0.3]]).expand(n, 4)
    got, same = run("sampling_id", {}, {"X": probs}, ("Out",))
    freq = np.bincount(got["Out"].numpy(), minlength=4) / n
    out["sampling_id"] = {
        "ok": bool(same and got["Out"].dtype == torch.int32
                   and freq[2] == 0 and np.abs(freq - probs[0].numpy()).max()
                   < 5 * (0.25 / n) ** 0.5),
        "freq": freq.tolist()}
    x = torch.arange(16 * 3 * 20 * 20, dtype=torch.float32).reshape(
        16, 3, 20, 20)
    got, same = run("random_crop", {"shape": [3, 12, 12]}, {"X": x},
                    ("Out",))
    o = got["Out"][0, 0]
    i0, j0 = divmod(int(o[0, 0]), 20)
    out["random_crop"] = {
        "ok": bool(same and 0 <= i0 <= 8 and 0 <= j0 <= 8
                   and torch.equal(got["Out"], x[:, :, i0:i0 + 12,
                                                 j0:j0 + 12])),
        "offset": [i0, j0]}
    check(all(r["ok"] for r in out.values()),
          "extra_ops: random draws on the card %r" % out)
    return out


# the op names this slice registers (ROADMAP Queue 1 item 1)
OP_REMAINDER_OPS = 31


def extra_ops_leg(dev=None):
    """``extra_ops``: every op of the slice forward and backward on the
    card against the same call on the CPU (``op_remainder_cases``, float32
    1e-5 norm-wise, integer outputs and ``hash`` identical), the random
    draws on the card (``random_heads_on_card``), and the host ops
    ``print``, ``py_func`` and ``delete_var`` in ``host_ops_compiled``."""
    t_leg = time.perf_counter()
    dev = dev or torch.device("cuda", torch.cuda.current_device())
    rows, ops = {}, set()
    for name, op_type, attrs, inputs, outs in op_remainder_cases():
        inp = inputs()
        t0 = time.perf_counter()
        cpu_out, cpu_g = registered_op(op_type, attrs, inp, outs,
                                       torch.device("cpu"))
        card_out, card_g = registered_op(op_type, attrs, inp, outs, dev)
        torch.cuda.synchronize()
        e_out, exact = card_cpu_err(card_out, cpu_out)
        e_grad, _ = card_cpu_err(card_g, cpu_g)
        rows[name] = {"out_err": e_out, "grad_err": e_grad, "exact": exact,
                      "grads": len(cpu_g),
                      "shape": list(next(iter(cpu_out.values())).shape),
                      "s": time.perf_counter() - t0}
        check(e_out <= 1e-5 and e_grad <= 1e-5 and exact
              and set(card_g) == set(cpu_g),
              "extra_ops %s: card against CPU %r (tolerance 1e-5)"
              % (name, rows[name]))
        ops.add(op_type)
    random_ops = random_heads_on_card(dev)
    ops |= set(random_ops)
    emit("extra_ops", cases=rows, random_ops=random_ops,
         seconds=time.perf_counter() - t_leg, tol=1e-5, nvidia_smi=SMI[0])
    return ops


def build_host_py_func(fluid):
    """An fc trained through a host tanh (``layers.py_func`` with a
    backward callable) and tapped by ``layers.Print``, under SGD."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 5
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data("x", shape=[64, 256], append_batch_size=False)
        h = fluid.layers.fc(x, size=128)
        out = main.global_block.create_var(name="host_tanh", shape=[64, 128],
                                           dtype="float32")
        fluid.layers.py_func(np.tanh, h, out, backward_func=lambda a, g: g * (
            1.0 - np.tanh(a) ** 2))
        out = fluid.layers.Print(out, message="host_tanh", first_n=1,
                                 summarize=4)
        loss = fluid.layers.mean(fluid.layers.square(out))
        fluid.optimizer.SGD(0.5).minimize(loss)
    return main, startup, loss


def build_switch(fluid):
    """A ``Switch`` learning-rate schedule: 0.1 below step 10, 0.01
    below 20, 0.001 after (``tests/test_torch_control_flow.py``)."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        L = fluid.layers
        step = L.data("step", shape=[1], dtype="float32",
                      append_batch_size=False)
        lr = L.tensor.create_global_var([1], 0.0, "float32", persistable=True,
                                        name="sw_lr")
        with L.Switch() as switch:
            for bound, rate in ((10.0, 0.1), (20.0, 0.01)):
                with switch.case(L.less_than(
                        step, L.fill_constant([1], "float32", bound))):
                    L.tensor.assign(L.fill_constant([1], "float32", rate),
                                    lr)
            with switch.default():
                L.tensor.assign(L.fill_constant([1], "float32", 0.001), lr)
    return main, startup, lr


def compiled_against_run(fluid, main, startup, feeds, fetch, arrays=None):
    """``Executor.run`` and ``run(CompiledProgram(main))`` over ``feeds``
    from one start on the card: (rows run, rows compiled, the compiled
    executor's ``host_op_steps``, its warnings naming a host op, the
    graphs its captured steps hold)."""
    import warnings

    if arrays is None:
        init = fluid.Scope()
        fluid.Executor(fluid.CUDAPlace(0)).run(startup, scope=init)
        arrays = {n: init.as_numpy(n) for n in init.vars}
    rows, counted, warned, graphs = {}, 0, 0, 0
    for mode in ("run", "compiled"):
        scope = fluid.io.state_from_numpy(main, arrays, fluid.Scope(),
                                          fluid.CUDAPlace(0))
        exe = fluid.Executor(fluid.CUDAPlace(0))
        main._tpu_step_counter = 0
        prog = main if mode == "run" else fluid.CompiledProgram(main)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            rows[mode] = [[np.asarray(v) for v in exe.run(
                prog, feed=f, fetch_list=fetch, scope=scope)] for f in feeds]
        if mode == "compiled":
            counted = exe.host_op_steps
            warned = sum("runs this program eagerly" in str(w.message)
                         for w in caught)
            graphs = sum(c.graphs for c in exe._captured.values())
        exe.close()
    return rows["run"], rows["compiled"], counted, warned, graphs


def host_ops_compiled_leg():
    """``host_ops_compiled``: through ``CompiledProgram`` on the card, the
    Switch schedule (0.1, 0.01, 0.001 at steps 5, 15, 25) and the NMT beam
    decoder under ``While`` (at ``max_len`` ``NMT_DECODE_CHECK_LEN``, three
    batches) are captured: no step eager (``host_op_steps`` 0), no
    warning, the third step a graph replay (one graph for the Switch step,
    three for the decode: the ops before the loop, its body, the ops after
    it); an fc trained through ``py_func`` and ``Print`` still runs
    eagerly, every step counted in ``host_op_steps`` and one warning; each
    equal to ``Executor.run`` from the same start (bit for bit); a
    ``DataFeeder`` on ``CUDAPinnedPlace`` hands out pinned tensors;
    ``delete_var`` drops its inputs."""
    import paddle_tpu_torch as fluid

    t_leg = time.perf_counter()
    out = {}
    main, startup, lr = build_switch(fluid)
    feeds = [{"step": np.asarray([s], "float32")} for s in (5.0, 15.0, 25.0)]
    ran, comp, n, warned, graphs = compiled_against_run(
        fluid, main, startup, feeds, [lr])
    rates = [float(r[0][0]) for r in comp]
    check(np.allclose(rates, [0.1, 0.01, 0.001], rtol=1e-6)
          and all(np.array_equal(a[0], b[0]) for a, b in zip(ran, comp))
          and n == 0 and warned == 0 and graphs == 1,
          "host_ops_compiled switch: rates %r, run %r, host_op_steps %d, "
          "warnings %d, graphs %d" % (rates, ran, n, warned, graphs))
    out["switch"] = {"rates": rates, "host_op_steps": n, "warnings": warned,
                     "graphs": graphs}

    cfg = dict(NMT_DECODE, max_len=NMT_DECODE_CHECK_LEN)
    main, startup, sent_ids, sent_scores, steps = build_nmt_decode(fluid,
                                                                   cfg)
    t0 = time.perf_counter()
    ran, comp, n, warned, graphs = compiled_against_run(
        fluid, main, startup, [nmt_decode_feed(cfg)] * 3,
        [sent_ids, sent_scores, steps])
    same = all(np.array_equal(a, b) for r, c in zip(ran, comp)
               for a, b in zip(r, c))
    check(same and n == 0 and warned == 0 and graphs == 3,
          "host_ops_compiled nmt decode: compiled = run %s, host_op_steps "
          "%d, warnings %d, graphs %d" % (same, n, warned, graphs))
    out["nmt_beam_decode"] = {"max_len": cfg["max_len"],
                              "steps": int(comp[-1][2][0]),
                              "host_op_steps": n, "warnings": warned,
                              "graphs": graphs, "equal_to_run": same,
                              "s": time.perf_counter() - t0}

    main, startup, loss = build_host_py_func(fluid)
    rng = np.random.RandomState(3)
    feeds = [{"x": rng.randn(64, 256).astype("float32")}] * 4
    ran, comp, n, warned, _ = compiled_against_run(fluid, main, startup,
                                                   feeds, [loss])
    losses = [float(r[0]) for r in comp]
    check(all(np.array_equal(a[0], b[0]) for a, b in zip(ran, comp))
          and n == 4 and warned == 1 and losses[-1] < losses[0],
          "host_ops_compiled py_func: run %r, compiled %r, host_op_steps "
          "%d, warnings %d" % ([float(r[0]) for r in ran], losses, n, warned))
    out["py_func"] = {"losses": losses, "host_op_steps": n,
                      "warnings": warned}

    with fluid.program_guard(fluid.Program(), fluid.Program()):
        x = fluid.layers.data("x", shape=[3])
        pinned = fluid.DataFeeder([x], place=fluid.CUDAPinnedPlace()).feed(
            [(np.ones(3, "float32"),)] * 4)
    check(all(v.is_pinned() for v in pinned.values()),
          "host_ops_compiled: DataFeeder(CUDAPinnedPlace) gave unpinned "
          "tensors")
    out["pinned_feeder"] = True

    # delete_var drops its inputs from the step's values on the card
    from types import SimpleNamespace

    from paddle_tpu_torch.core.registry import OpContext, get_op_impl

    env = {"h": torch.ones(3, device=fluid.CUDAPlace(0)),
           "keep": torch.zeros(1)}
    get_op_impl("delete_var")(OpContext(SimpleNamespace(
        type="delete_var", attrs={}, block=None, inputs={"X": ["h"]},
        outputs={}), env, None))
    check(set(env) == {"keep"}, "delete_var left %r" % sorted(env))
    emit("host_ops_compiled", seconds=time.perf_counter() - t_leg, **out)
    return {"while", "conditional_block", "print", "py_func", "delete_var"}


def op_remainder_phase(k4_rows):
    """The op-remainder slice's legs: ``ocr_ctc_train`` (+
    ``ocr_ctc_eval``), ``word2vec_heads``, ``extra_ops`` and
    ``host_ops_compiled``; the slice's ops held by these legs and by
    ``srl_decode``'s ``chunk_eval`` must number ``OP_REMAINDER_OPS``."""
    from paddle_tpu_torch.core.registry import registered_ops

    secs = {}
    t0 = time.perf_counter()
    ocr_ctc_train_leg()
    secs["ocr_ctc_train"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    word2vec_heads_leg(k4_rows)
    secs["word2vec_heads"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ops = extra_ops_leg()
    secs["extra_ops"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ops |= host_ops_compiled_leg()
    secs["host_ops_compiled"] = time.perf_counter() - t0
    held = ops - {"while", "conditional_block"}
    check(len(held) == OP_REMAINDER_OPS and held <= set(registered_ops()),
          "op_remainder: %d of the slice's %d ops held: %s"
          % (len(held), OP_REMAINDER_OPS, sorted(held)))
    emit("op_remainder_seconds", ops_held=len(held),
         registered=len(registered_ops()), **secs)


# -- the model's lifecycle ----------------------------------------------------

# the BERT feed's fields, in the order one example's bytes hold them
BERT_RECORD = (("ids", "int64", (BERT_SEQ,)), ("pos", "int64", (BERT_SEQ,)),
               ("sent", "int64", (BERT_SEQ,)),
               ("mask", "float32", (BERT_SEQ,)),
               ("mpos", "int64", (BERT_MASK,)),
               ("mlbl", "int64", (BERT_MASK, 1)), ("nsp", "int64", (1,)))
RESUME_STEPS = 6       # checkpoint_resume: the uninterrupted run's steps
RESUME_AT = 3          # the step the checkpoint is saved after


def bert_examples(feed):
    """One batch of ``bert_feed`` as per-example raw byte records (each
    field's row in ``BERT_RECORD`` order)."""
    n = feed["ids"].shape[0]
    per = {k: np.asarray(feed[k]).reshape((n,) + shape)
           for k, _, shape in BERT_RECORD}
    return [b"".join(per[k][i].tobytes() for k, _, _ in BERT_RECORD)
            for i in range(n)]


def bert_batch_feed(records):
    """The feed dict of a batch of ``bert_examples`` records."""
    cols = {k: [] for k, _, _ in BERT_RECORD}
    for rec in records:
        off = 0
        for k, dt, shape in BERT_RECORD:
            size = int(np.prod(shape)) * np.dtype(dt).itemsize
            cols[k].append(np.frombuffer(rec, dt, int(np.prod(shape)), off)
                           .reshape(shape))
            off += size
    out = {k: np.stack(v) for k, v in cols.items()}
    out["mlbl"] = out["mlbl"].reshape(-1, 1)
    return out


def checkpoint_resume_phase(xent_rows):
    """``checkpoint_resume``: BERT-base pretraining under AMP at full width
    (batch 32 x 128, dropout 0.1, Adam(1e-4)), fed from a record file:
    ``RESUME_STEPS`` seeded batches written as one record an example by
    ``recordio.write_records`` and read back through ``recordio_reader`` →
    ``reader.batch`` into ``ParallelExecutor(use_cuda=True).run`` (a
    captured step: two eager warm-ups, a capture, replays), each batch
    byte for byte the one written. Run A trains ``RESUME_STEPS`` steps
    uninterrupted. Run B, a fresh program, scope and ParallelExecutor from
    A's start state, trains ``RESUME_AT`` steps and ``save_checkpoint``s
    with ``{"step": RESUME_AT}``; run C, fresh again, ``load_checkpoint``s,
    sets ``main._tpu_step_counter`` from the trainer args and trains the
    rest. B's and C's losses and C's persistables must equal A's bit for
    bit, K2a and K2b launch in every run, and a load into A's scope after
    A's capture (counter set back) must repeat A's last steps bit for bit
    through A's graph (``io.load_vars`` of the checkpoint's files, which
    leaves A's program and its captured step as they are, so the replays
    copy the loaded tensors into the graph's state; ``load_checkpoint``
    bumps the program's version and captures anew). With
    ``io.save_checkpoint@2=fatal`` armed the second
    save raises and leaves an unpublished staging dir, which
    ``load_checkpoint`` skips. Reports the checkpoint's bytes, the save and
    load seconds and the fsync's share of the save."""
    import warnings

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import io as fio
    from paddle_tpu_torch import recordio
    from paddle_tpu_torch.monitor import metrics
    from paddle_tpu_torch.ops.kernels import softmax_xent as sx
    from paddle_tpu_torch.reliability import faults

    t_leg = time.perf_counter()
    dev = fluid.CUDAPlace(0)
    tmp = tempfile.mkdtemp()
    feeds = [bert_feed(BERT_BATCH, seed=100 + i) for i in range(RESUME_STEPS)]
    rio = os.path.join(tmp, "bert.rio")
    t0 = time.perf_counter()
    n_rec = recordio.write_records(
        rio, (r for f in feeds for r in bert_examples(f)))
    write_s = time.perf_counter() - t0
    check(n_rec == RESUME_STEPS * BERT_BATCH,
          "checkpoint_resume: %d records written" % n_rec)

    def batches(skip=0):
        reader = fluid.reader.batch(recordio.recordio_reader(rio), BERT_BATCH)
        for i, recs in enumerate(reader()):
            if i >= skip:
                yield bert_batch_feed(recs)

    for got, want in zip(batches(), feeds):
        check(all(got[k].dtype == want[k].dtype
                  and np.array_equal(got[k], want[k]) for k in want),
              "checkpoint_resume: a batch read back from the record file "
              "differs from the one written")

    def parallel(main, loss, scope):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            return fluid.ParallelExecutor(True, loss_name=loss.name,
                                          main_program=main, scope=scope)

    def train(pe, loss, source, n):
        sx.LAUNCHES_FWD = sx.LAUNCHES_BWD = 0
        losses = []
        for _, f in zip(range(n), source):
            losses.append(float(np.asarray(pe.run([loss], feed=f)[0])
                                .reshape(-1)[0]))
        torch.cuda.synchronize()
        return losses, (sx.LAUNCHES_FWD, sx.LAUNCHES_BWD)

    main_a, startup_a, loss_a = build_bert(fluid, True)
    scope_a = fluid.Scope()
    fluid.Executor(dev).run(startup_a, scope=scope_a)
    start = clone_scope(fluid, scope_a)
    pe_a = parallel(main_a, loss_a, scope_a)
    losses_a, k2_a = train(pe_a, loss_a, batches(), RESUME_STEPS)
    final_a = clone_scope(fluid, scope_a)

    main_b, _, loss_b = build_bert(fluid, True)
    scope_b = clone_scope(fluid, start)
    pe_b = parallel(main_b, loss_b, scope_b)
    losses_b, k2_b = train(pe_b, loss_b, batches(), RESUME_AT)
    ckpt = os.path.join(tmp, "ckpt")
    fsync_s = [0.0]
    fsync_tree = fio._fsync_tree

    def timed_fsync(path):
        t = time.perf_counter()
        fsync_tree(path)
        fsync_s[0] += time.perf_counter() - t

    faults.install(faults.FaultPlan.parse("io.save_checkpoint@2=fatal"))
    fio._fsync_tree = timed_fsync
    try:
        with fluid.scope_guard(scope_b):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            serial = fluid.io.save_checkpoint(
                pe_b._exe, ckpt, main_b, trainer_args={"step": RESUME_AT})
            save_s = time.perf_counter() - t0
            torn = None
            try:
                fluid.io.save_checkpoint(pe_b._exe, ckpt, main_b,
                                         trainer_args={"step": -1})
            except faults.InjectedFault as e:
                torn = str(e)
    finally:
        fio._fsync_tree = fsync_tree
        faults.clear()
    pe_b._exe.close()
    ck0 = os.path.join(ckpt, "checkpoint_%d" % serial)
    ckpt_bytes = sum(os.path.getsize(os.path.join(ck0, f))
                     for f in os.listdir(ck0))
    names = sorted(os.listdir(ckpt))
    check(torn is not None and serial == 0 and len(names) == 2
          and names[0] == "checkpoint_0"
          and names[1].startswith("checkpoint_1.tmp."),
          "checkpoint_resume: the armed second save left %r (raised %r)"
          % (names, torn))
    check(not any(t.dtype == torch.bfloat16 for t in scope_b.vars.values()
                  if isinstance(t, torch.Tensor)),
          "checkpoint_resume: a bfloat16 persistable in the AMP scope")

    main_c, startup_c, loss_c = build_bert(fluid, True)
    scope_c = fluid.Scope()
    exe_c = fluid.Executor(dev)
    exe_c.run(startup_c, scope=scope_c)
    with fluid.scope_guard(scope_c):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        args = fluid.io.load_checkpoint(exe_c, ckpt, main_c)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    check(args == {"trainer_id": 0, "step": RESUME_AT},
          "checkpoint_resume: load_checkpoint gave %r (the torn serial not "
          "skipped?)" % (args,))
    main_c._tpu_step_counter = args["step"]
    pe_c = parallel(main_c, loss_c, scope_c)
    losses_c, k2_c = train(pe_c, loss_c, batches(RESUME_AT),
                           RESUME_STEPS - RESUME_AT)
    _, err_c, equal_c = state_norm_err(scope_c, final_a)
    pe_c._exe.close()

    # A again: the checkpoint's files into the scope whose tensors A's
    # graph holds (io.load_vars of its index: A's program and its captured
    # step stay as they are), the counter back; the next steps replay A's
    # graph, which must first copy the loaded tensors into its state
    cap, = pe_a._exe._captured.values()
    graph_before, caps0 = cap.graph, metrics.CAPTURES.value
    with fluid.scope_guard(scope_a):
        fluid.io.load_vars(pe_a._exe, ck0)
    main_a._tpu_step_counter = args["step"]
    again, k2_again = train(pe_a, loss_a, batches(RESUME_AT),
                            RESUME_STEPS - RESUME_AT)
    _, err_again, equal_again = state_norm_err(scope_a, final_a)
    check(list(pe_a._exe._captured.values()) == [cap]
          and cap.graph is graph_before and graph_before is not None
          and metrics.CAPTURES.value == caps0 and k2_again == (0, 0),
          "checkpoint_resume: the load into A's scope did not replay A's "
          "graph (captured steps %d, captures %d, K2 host launches %r)"
          % (len(pe_a._exe._captured), metrics.CAPTURES.value - caps0,
             k2_again))
    pe_a._exe.close()
    resumed = losses_b + losses_c
    emit("checkpoint_resume", nvidia_smi=SMI[0], program="bench_bert "
         "(BERT-base, AMP, dropout 0.1)", batch=BERT_BATCH, seq=BERT_SEQ,
         steps=RESUME_STEPS, resume_at=RESUME_AT, records=n_rec,
         record_file_bytes=os.path.getsize(rio), record_write_s=write_s,
         losses_uninterrupted=losses_a, losses_resumed=resumed,
         losses_reloaded_into_a=again,
         bit_equal=bool(resumed == losses_a and equal_c),
         reload_into_captured_bit_equal=bool(
             again == losses_a[RESUME_AT:] and equal_again),
         state_normwise_err=err_c, state_normwise_err_reload=err_again,
         k2_host_launches={"a": k2_a, "b": k2_b, "c": k2_c,
                           "a_reloaded": k2_again},
         checkpoint_bytes=ckpt_bytes, save_s=save_s, load_s=load_s,
         fsync_s=fsync_s[0], fsync_share_of_save=fsync_s[0] / save_s,
         torn_serial_skipped=True, fault=torn,
         leg_s=time.perf_counter() - t_leg)
    check(resumed == losses_a and equal_c,
          "checkpoint_resume: resumed losses %r against %r, state "
          "norm-wise %.3g (bit-equal %s)" % (resumed, losses_a, err_c,
                                             equal_c))
    check(again == losses_a[RESUME_AT:] and equal_again,
          "checkpoint_resume: reloaded into A %r against %r, state %.3g"
          % (again, losses_a[RESUME_AT:], err_again))
    # host counts: the two eager warm-ups and the capture, at both shapes
    check(all(min(k) > 0 for k in (k2_a, k2_b, k2_c)),
          "checkpoint_resume: K2 host launches %r / %r / %r"
          % (k2_a, k2_b, k2_c))
    for row, i in zip(xent_rows, (0, 1)):
        row.setdefault("lifecycle_launches", {})["checkpoint_resume"] = \
            k2_a[i] + k2_b[i] + k2_c[i]
    shutil.rmtree(tmp, ignore_errors=True)
    del start, final_a, scope_a, scope_b, scope_c
    torch.cuda.empty_cache()


QAT_STEPS = 4          # qat_resnet50: eager and captured steps
QAT_TURNS = 2          # timed turns of (QAT block, fp32 block)
QAT_CHECK_BATCH = 8    # the frozen program's card-against-CPU batch
CALIB_BATCHES = 2      # calibration batches of QAT_CHECK_BATCH images


def build_resnet_qat(fluid, qat):
    """ResNet-50 as bench_resnet50 builds it (float32, Momentum(0.1,
    0.9)), with its inference clone taken before the optimizer; ``qat``
    transpiles it first (``QuantizeTranspiler``, abs-max weights,
    moving-average activations). Returns (main, startup, test, loss,
    logits, transpiler)."""
    from paddle_tpu_torch.models import resnet as rn

    main, startup = fluid.Program(), fluid.Program()
    t = None
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        img = fluid.layers.data("img", shape=[3, RESNET_IMAGE, RESNET_IMAGE])
        label = fluid.layers.data("label", shape=[1], dtype="int64")
        logits, loss, _ = rn.resnet(img, label, depth=50,
                                    class_num=RESNET_CLASSES)
        if qat:
            t = fluid.contrib.QuantizeTranspiler(
                activation_quantize_type="moving_average_abs_max")
            t.training_transpile(main, startup)
        test = main.clone(for_test=True)
        fluid.optimizer.Momentum(0.1, 0.9).minimize(loss)
    return main, startup, test, loss, logits, t


def card_cpu_op_trace(program, card_scope, cpu_scope, feed, dev, fetch):
    """The forward ``program`` op by op on the card; after each op the
    same op on the CPU, on CPU copies of the inputs the card's op read.
    Also the whole forward on the CPU from ``cpu_scope``. Returns (by op
    type: the ops, how many gave the card's bits on the CPU, the largest
    norm-wise difference of an output, and for the quantizers the elements
    whose level differs between the card's and the CPU's whole forwards;
    {name: (card's, CPU's)} of each ``fetch`` name from the whole
    forwards, as arrays)."""
    from paddle_tpu_torch.core.dtypes import to_torch_dtype
    from paddle_tpu_torch.core.interpreter import run_block_ops
    from paddle_tpu_torch.executor import TraceContext

    block = program.global_block
    cpu = torch.device("cpu")

    def env_of(scope, device):
        env = {v.name: scope.find_var(v.name) for v in program.list_vars()
               if v.persistable and scope.find_var(v.name) is not None}
        for k, a in feed.items():
            env[k] = torch.as_tensor(a).to(
                device=device, dtype=to_torch_dtype(block.var(k).dtype))
        return env

    card, whole_cpu = env_of(card_scope, dev), env_of(cpu_scope, cpu)
    t_card = TraceContext(program, True, dev, 0)
    t_cpu = TraceContext(program, True, cpu, 0)
    by_type = {}
    with torch.no_grad():
        run_block_ops(block.ops, whole_cpu, t_cpu)
        for i, op in enumerate(block.ops):
            ins = {n: card[n] for n in op.input_arg_names if n in card}
            run_block_ops([op], card, t_card, offset=i)
            local = {n: v.cpu() for n, v in ins.items()}
            run_block_ops([op], local, t_cpu, offset=i)
            row = by_type.setdefault(op.type, {
                "ops": 0, "bit_equal": 0, "max_normwise_err": 0.0})
            row["ops"] += 1
            equal = True
            for n in op.output_arg_names:
                if n not in card:  # an output the op leaves unset
                    continue
                got, want = card[n].cpu(), local[n]
                equal = equal and torch.equal(got, want)
                d = float(torch.linalg.vector_norm((got - want).double()))
                w = float(torch.linalg.vector_norm(want.double()))
                row["max_normwise_err"] = max(row["max_normwise_err"],
                                              d / max(w, 1e-30))
            row["bit_equal"] += int(equal)
            if op.type.startswith("fake_quantize"):
                out = op.output("Out")[0]
                row["levels_differing_whole_forward"] = row.get(
                    "levels_differing_whole_forward", 0) + int(
                    (card[out].cpu() != whole_cpu[out]).sum())
                row["elements"] = row.get("elements", 0) + card[out].numel()
    return by_type, {n: (card[n].cpu().numpy(), whole_cpu[n].numpy())
                     for n in fetch}


def qat_resnet50_phase(xent_rows):
    """``qat_resnet50``: ResNet-50 at full width in float32 (batch 64 x 224,
    cuDNN's deterministic algorithms, TF32 off) with quantization-aware
    training (``QuantizeTranspiler.training_transpile``: a fake quant +
    dequant pair on every conv2d and mul input, moving-average activation
    scales as persistable state). ``QAT_STEPS`` eager steps and the same
    steps captured (``run_steps``) from one start must agree bit for bit,
    losses and state, K2a/K2b launching; captured QAT and captured fp32
    steps are timed in turns. ``freeze_program`` then puts the weights on
    the int grid and the activation quantizers on their frozen scales.
    The card = CPU check of the fake-quant ops is op by op
    (``card_cpu_op_trace``): each of the frozen program's fake-quant ops,
    run on the CPU on the inputs its card run read, must give the card's
    bits. The logits of the whole frozen forward on the card against the
    CPU's (same state and feed) are reported with the quantized levels
    that differ between the two forwards: the batch norms part by ulps,
    and a value at a level's edge rounds to another level.
    ``convert_to_int8`` stores every conv and fc weight as int8 on the
    card. Last the ``Calibrator`` (``abs_max`` and ``KL``)
    calibrates the fp32 inference program over ``CALIB_BATCHES`` batches
    and the top-1 labels of a seeded batch are counted against fp32's."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.executor import WARMUP_STEPS
    from paddle_tpu_torch.ops.kernels import softmax_xent as sx

    t_leg = time.perf_counter()
    prev = (torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic)
    torch.backends.cudnn.benchmark = True
    torch.backends.cudnn.deterministic = True
    dev = fluid.CUDAPlace(0)
    main, startup, test, loss, logits, qt = build_resnet_qat(fluid, True)
    n_fake = sum(op.type.startswith("fake_") for op in main.global_block.ops)
    scope = fluid.Scope()
    exe = fluid.Executor(dev)
    exe.run(startup, scope=scope)
    scope_c = clone_scope(fluid, scope)
    feeds = [resnet_feed(RESNET_BATCH, seed=40 + i) for i in range(QAT_STEPS)]
    sx.LAUNCHES_FWD = sx.LAUNCHES_BWD = 0
    eager = [float(exe.run(main, feed=f, fetch_list=[loss], scope=scope)[0])
             for f in feeds]
    k2 = (sx.LAUNCHES_FWD, sx.LAUNCHES_BWD)
    main._tpu_step_counter = 0
    exe_c = fluid.Executor(dev)
    got = [float(r[0]) for r in exe_c.run_steps(
        main, feeds, fetch_list=[loss], fetch_every=QAT_STEPS,
        scope=scope_c)]
    _, state_err, state_equal = state_norm_err(scope_c, scope)
    scales = sorted(n for n in scope.vars if n.endswith(".scale"))
    check(got == eager and state_equal and bool(np.isfinite(eager).all()),
          "qat_resnet50: captured %r against eager %r, state %.3g (bit-"
          "equal %s)" % (got, eager, state_err, state_equal))
    check(k2 == (QAT_STEPS, QAT_STEPS),
          "qat_resnet50: K2 launches %r in %d eager steps" % (k2, QAT_STEPS))

    # captured QAT against captured fp32 steps, in turns
    main_f, startup_f, test_f, loss_f, logits_f, _ = build_resnet_qat(
        fluid, False)
    scope_f = fluid.Scope()
    exe.run(startup_f, scope=scope_f)
    exe_f = fluid.Executor(dev)
    exe_f.run_steps(main_f, feeds, fetch_list=[loss_f], scope=scope_f)
    dfeed = {k: torch.as_tensor(v, device=dev) for k, v in feeds[0].items()}
    times = {"qat": [], "fp32": []}
    legs = {"qat": (exe_c, main, loss, scope_c),
            "fp32": (exe_f, main_f, loss_f, scope_f)}
    for _ in range(QAT_TURNS):
        for name, (e, m, lo, sc) in legs.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            e.run_steps(m, (dfeed for _ in range(CAPTURED_BLOCK)),
                        steps=CAPTURED_BLOCK, fetch_list=[lo],
                        fetch_every=CAPTURED_BLOCK, scope=sc,
                        return_numpy=False)
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) / CAPTURED_BLOCK
                               * 1e3)
    graphs = [c.graph is not None for c in exe_c._captured.values()]
    exe_f.close()

    # freeze: card against CPU on the same state and feed
    frozen_scope = clone_scope(fluid, scope_c)
    exe_c.close()
    qt.freeze_program(test, scope=frozen_scope)
    xfeed = resnet_feed(QAT_CHECK_BATCH, seed=50)
    cpu_scope = fluid.Scope()
    for k, v in frozen_scope.vars.items():
        cpu_scope.set_var(k, v.cpu() if isinstance(v, torch.Tensor) else v)
    t0 = time.perf_counter()
    op_trace, fetched = card_cpu_op_trace(test, frozen_scope, cpu_scope,
                                          xfeed, dev, [logits.name])
    trace_s = time.perf_counter() - t0
    on_card, on_cpu = fetched[logits.name]
    frozen_err = float(np.linalg.norm((on_card - on_cpu).astype(np.float64))
                       / np.linalg.norm(on_cpu.astype(np.float64)))
    frozen_top1 = int((np.argmax(on_card, 1) == np.argmax(on_cpu, 1)).sum())
    emit("qat_resnet50_frozen_ops", nvidia_smi=SMI[0],
         logits_card_vs_cpu=frozen_err, top1_agree=frozen_top1,
         of=QAT_CHECK_BATCH, by_type=op_trace, seconds=trace_s)
    quant_equal = all(r["bit_equal"] == r["ops"] for t, r in op_trace.items()
                      if t.startswith("fake_"))
    check(quant_equal, "qat_resnet50: a fake-quant op of the frozen program "
          "on the card parts from the CPU on the same inputs: %r"
          % {t: r for t, r in op_trace.items() if t.startswith("fake_")})
    w_names = sorted({op.input("Filter")[0] if op.type == "conv2d"
                      else op.input("Y")[0] for op in test.global_block.ops
                      if op.type in ("conv2d", "mul")})
    on_grid = all(bool(torch.equal(frozen_scope.find_var(w),
                                   torch.round(frozen_scope.find_var(w))))
                  for w in w_names)
    converted = qt.convert_to_int8(test, scope=frozen_scope)
    int8_ok = sorted(converted) == w_names and all(
        frozen_scope.find_var(w).dtype == torch.int8
        and frozen_scope.find_var(w).device.type == "cuda" for w in w_names)
    # end to end the logits are reported, not held to 1e-5: the batch
    # norms' and the average pool's outputs part by ulps between the card
    # and the CPU, and a quantizer rounds a value that sits at a level's
    # edge to another level on each (PERF.md §6)
    check(on_grid and bool(np.isfinite(on_card).all()),
          "qat_resnet50: frozen logits on the card %s (weights on the int "
          "grid: %s)" % ("finite" if np.isfinite(on_card).all()
                         else "not finite", on_grid))
    check(int8_ok, "qat_resnet50: convert_to_int8 gave %d of %d weights"
          % (len(converted), len(w_names)))
    del frozen_scope, cpu_scope, scope_c

    # post-training calibration of the fp32 inference program
    calib_feeds = [resnet_feed(QAT_CHECK_BATCH, seed=60 + i)
                   for i in range(CALIB_BATCHES)]
    fp32_out = exe.run(test_f, feed=xfeed, fetch_list=[logits_f],
                       scope=scope_f)[0]
    calib = {}
    for algo in ("abs_max", "KL"):
        sc = clone_scope(fluid, scope_f)
        t0 = time.perf_counter()
        c = fluid.contrib.Calibrator(test_f, exe, scope=sc, algo=algo)
        for f in calib_feeds:
            c.sample_data(f)
        qprog = c.calibrate()
        secs = time.perf_counter() - t0
        q_out = exe.run(qprog, feed=xfeed, fetch_list=[logits_f],
                        scope=sc)[0]
        agree = int((np.argmax(q_out, 1) == np.argmax(fp32_out, 1)).sum())
        calib[algo] = {"seconds": secs, "activations": len(c._act_names),
                       "top1_agree": agree, "of": QAT_CHECK_BATCH,
                       "logits_normwise_diff_to_fp32": float(
                           np.linalg.norm(q_out - fp32_out)
                           / np.linalg.norm(fp32_out))}
        check(bool(np.isfinite(q_out).all()),
              "qat_resnet50: calibrated (%s) logits not finite" % algo)
        del sc
    torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic = prev
    emit("qat_resnet50", nvidia_smi=SMI[0], batch=RESNET_BATCH,
         image=RESNET_IMAGE, fake_quant_ops=n_fake, scale_vars=len(scales),
         steps=QAT_STEPS, warmup_steps=WARMUP_STEPS, losses_eager=eager,
         losses_captured=got, bit_equal=True, k2_launches=k2,
         graphs=sum(graphs),
         step_ms_captured_qat=float(np.median(times["qat"])),
         step_ms_captured_fp32=float(np.median(times["fp32"])),
         step_ms_turns=times,
         qat_over_fp32=float(np.median(times["qat"])
                             / np.median(times["fp32"])),
         frozen_logits_card_vs_cpu=frozen_err,
         frozen_top1_card_vs_cpu=frozen_top1,
         frozen_levels_differing=sum(
             r.get("levels_differing_whole_forward", 0)
             for r in op_trace.values()),
         frozen_quantized_elements=sum(r.get("elements", 0)
                                       for r in op_trace.values()),
         frozen_check_batch=QAT_CHECK_BATCH,
         frozen_trace_s=trace_s, weights_on_int_grid=on_grid,
         int8_weights=len(converted), calibration=calib,
         leg_s=time.perf_counter() - t_leg)
    for row, n in zip(xent_rows, k2):
        row.setdefault("lifecycle_launches", {})["qat_resnet50"] = n
    del scope, scope_f, exe
    torch.cuda.empty_cache()


EXPORT_BATCHES = (48, 64)   # export_bert: the artifact's batches
EXPORT_RUNS = 3             # timed runs a batch


def export_bert_phase(infer, pred):
    """``export_bert``: ``inference.export_program`` of ``bert_infer``'s
    program (BERT-base, 64 x 256 example feed, the loaded weights) with a
    symbolic batch, ``load_program`` of the artifact, and runs at batch 48
    and 64, whose outputs must match the ``Predictor``'s (exact batch) to
    1e-5 norm-wise; the export seconds, the artifact's bytes and the ms a
    run (numpy in, numpy out, as the Predictor is timed) beside the
    Predictor's. BERT at S = 128 and 256 stays on the composed attention
    (``FLAGS_flash_attention_min_seq`` 2048), so no kernel is on its path.
    Then the causal LM at S = 2048 (one layer, the flash route: K1a):
    its export must raise ``ExportRefused`` naming K1a."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import inference
    from paddle_tpu_torch.ops.kernels import _build

    t_leg = time.perf_counter()
    main, scope, out = (infer[k] for k in ("main", "scope", "out"))
    feed = infer["feed"]
    res = {}
    with tempfile.TemporaryDirectory() as d:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = inference.export_program(d, BERT_FEEDS, [out], feed,
                                        program=main, scope=scope)
        export_s = time.perf_counter() - t0
        size = os.path.getsize(path)
        t0 = time.perf_counter()
        loaded = inference.load_program(d)
        load_s = time.perf_counter() - t0
    check(loaded.device.type == "cuda",
          "export_bert: the artifact's weights are on %s" % loaded.device)
    for batch in EXPORT_BATCHES:
        f = {k: v[:batch] for k, v in feed.items()}
        loaded.run(f)
        secs = []
        for _ in range(EXPORT_RUNS):
            t0 = time.perf_counter()
            got, = loaded.run(f)
            secs.append(time.perf_counter() - t0)
        want = pred["%d_exact" % batch]["out"]
        rel = float(np.linalg.norm((got - want).astype(np.float64))
                    / np.linalg.norm(want.astype(np.float64)))
        res[batch] = {"run_ms_median": float(np.median(secs)) * 1e3,
                      "run_ms": [x * 1e3 for x in secs],
                      "predictor_run_ms_median":
                          pred["%d_exact" % batch]["run_ms_median"],
                      "normwise_rel_err_to_predictor": rel,
                      "max_abs_diff_to_predictor":
                          float(np.abs(got - want).max())}
        check(got.shape == (batch, 768) and rel <= 1e-5,
              "export_bert at batch %d: %s, %.3g from the Predictor "
              "norm-wise" % (batch, got.shape, rel))
    del loaded
    # the flash route: the export meets K1a and refuses, naming it
    lm, lm_startup, lm_loss = build_causal_lm(fluid, LONGCTX_SEQ, False,
                                              dropout=0.0, n_layer=1)
    lm_scope = fluid.Scope()
    fluid.Executor(fluid.CUDAPlace(0)).run(lm_startup, scope=lm_scope)
    refused = None
    with tempfile.TemporaryDirectory() as d:
        try:
            inference.export_program(d, ["ids", "lbl"], [lm_loss],
                                     longctx_feed(2, LONGCTX_SEQ),
                                     program=lm, scope=lm_scope)
        except _build.ExportRefused as e:
            refused = str(e)
    check(refused is not None and "K1a (flash_fwd)" in refused,
          "export_bert: the causal LM's export did not refuse K1a: %r"
          % refused)
    emit("export_bert", nvidia_smi=SMI[0], model="bench_bert_infer program "
         "(BERT-base, loaded weights, float32)", symbolic_batch=True,
         example_batch=BERT_INFER_BATCH, export_s=export_s,
         artifact_bytes=size, load_s=load_s, batches=res,
         tol="1e-5 norm-wise", causal_lm_refused=refused,
         leg_s=time.perf_counter() - t_leg)
    del lm_scope
    torch.cuda.empty_cache()


def op_harness_cases():
    """(op, inputs, attrs, output slots) for ``op_harness``: the 7
    fake-quant ops (training and test mode) and a handful of dense ops, at
    small shapes."""
    rng = np.random.RandomState(70)

    def r(*s, scale=1.0):
        return (rng.randn(*s) * scale).astype("float32")

    state = {"InScale": np.asarray([1.5], "float32"),
             "InAccum": np.asarray([2.0], "float32"),
             "InState": np.asarray([1.9], "float32")}
    window = np.zeros(16, "float32")
    window[:4] = [0.5, 3.0, 1.0, 2.0]
    yield ("fake_quantize_abs_max", {"X": r(64, 256, scale=3.0)},
           {"bit_length": 8}, ["Out", "OutScale"])
    yield ("fake_channel_wise_quantize_abs_max", {"X": r(64, 32, 3, 3)},
           {"bit_length": 8}, ["Out", "OutScale"])
    for test in (False, True):
        yield ("fake_quantize_range_abs_max",
               {"X": r(64, 256), "InScale": np.asarray([2.5], "float32"),
                "Iter": np.asarray([21], "int64"), "OutScales": window},
               {"bit_length": 8, "window_size": 16, "is_test": test},
               ["Out"] if test else ["Out", "OutScale", "OutScales"])
        for op in ("fake_quantize_moving_average_abs_max",
                   "fake_quantize_dequantize_moving_average_abs_max"):
            yield (op, dict(state, X=r(32, 64, 7, 7)),
                   {"bit_length": 8, "moving_rate": 0.9, "is_test": test},
                   ["Out"] if test else ["Out", "OutScale", "OutAccum",
                                         "OutState"])
    yield ("fake_dequantize_max_abs",
           {"X": np.round(r(64, 256, scale=40)),
            "Scale": np.asarray([3.0], "float32")}, {"max_range": 127.0},
           ["Out"])
    yield ("fake_channel_wise_dequantize_max_abs",
           {"X": np.round(r(64, 32, 3, 3, scale=40)),
            "Scales": [("s0", np.abs(r(64)) + 0.1),
                       ("s1", np.asarray([2.0], "float32"))]},
           {"quant_bits": [8, 8]}, ["Out"])
    yield ("mul", {"X": r(64, 256), "Y": r(256, 128)}, {}, ["Out"])
    yield ("softmax", {"X": r(64, 1000)}, {}, ["Out"])
    yield ("layer_norm", {"X": r(32, 128, 768), "Scale": r(768),
                          "Bias": r(768)},
           {"begin_norm_axis": 2, "epsilon": 1e-12}, ["Y"])
    yield ("elementwise_add", {"X": r(32, 128, 768), "Y": r(768)},
           {"axis": -1}, ["Out"])
    yield ("gelu", {"X": r(32, 3072)}, {}, ["Out"])
    yield ("relu", {"X": r(64, 256, 14, 14)}, {}, ["Out"])


def op_harness_phase():
    """``op_harness``: the port's per-op harness on the card. For each case
    of ``op_harness_cases`` the op runs on the CPU (``run_op(...,
    place=CPUPlace())``) and ``OpTest.check_output`` holds the card's run
    to it (1e-5 relative and absolute; the quantized grids exactly, which
    the same tolerance demands of integers); ``check_grad`` (autograd
    against central differences, float64) runs on the card for tanh and
    the dequant op."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.testing import OpTest, op_test

    t_leg = time.perf_counter()
    cpu, card = fluid.CPUPlace(), fluid.CUDAPlace(0)
    rows = []
    for op, inputs, attrs, outs in op_harness_cases():
        want = op_test.run_op(op, inputs, outs, attrs, place=cpu)
        case = type("Case", (OpTest,), {
            "op_type": op, "inputs": inputs, "attrs": attrs,
            "outputs": {s: want[s].numpy() for s in outs}})()
        case.check_output(atol=1e-5, rtol=1e-5, place=card)
        got = op_test.run_op(op, inputs, outs, attrs, place=card)
        rows.append({"op": op, "is_test": bool(attrs.get("is_test", False)),
                     "max_abs_diff": max(float((got[s].cpu() - want[s])
                                               .abs().max()) for s in outs)})
    grads = []
    for op, inputs, attrs in (
            ("tanh", {"X": np.random.RandomState(71).randn(3, 4)
                      .astype("float32")}, {}),
            ("fake_dequantize_max_abs",
             {"X": np.random.RandomState(72).randn(3, 3).astype("float32"),
              "Scale": np.asarray([2.0], "float32")},
             {"max_range": 127.0})):
        op_test.check_grad(op, inputs, ["X"], "Out", attrs, place=card)
        grads.append(op)
    emit("op_harness", nvidia_smi=SMI[0], cases=rows, check_grad=grads,
         tol={"rtol": 1e-5, "atol": 1e-5}, leg_s=time.perf_counter() - t_leg)


# -- detection and dygraph ----------------------------------------------------

# SSD300 on VGG-16 (Liu et al., "SSD: Single Shot MultiBox Detector", ECCV
# 2016, and its ssd_pascal.py): the conv widths of VGG-16's five groups,
# fc6/fc7 and the extra layers (1x1 width; the 3x3 after it has twice it)
SSD = dict(image=300, classes=21, max_boxes=50,
           widths=(64, 128, 256, 512, 512, 1024, 256, 128), lr=1e-3)
SSD_BATCH = 32
SSD_PRIORS = 8732     # 38²·4 + 19²·6 + 10²·6 + 5²·6 + 3²·4 + 1²·4
SSD_DETECT_BATCHES = 3   # ssd_detect: timed captured batches
# Detectron's C4 Faster/Mask R-CNN (e2e_faster_rcnn_R-50-C4): two images
# of 800 x 1333, res4 features [1024, 50, 84] at stride 16, 15 anchors a
# cell, Fluid's generate_proposals defaults, 256 RPN and 512 RoI samples
TWO_STAGE = dict(images=2, im_h=800, im_w=1333, c4=(1024, 50, 84),
                 anchor_sizes=(32.0, 64.0, 128.0, 256.0, 512.0),
                 ratios=(0.5, 1.0, 2.0), stride=16.0, pre_nms=6000,
                 post_nms=1000, nms=0.7, min_size=0.1, rpn_batch=256,
                 rpn_fg=0.5, roi_batch=512, roi_fg=0.25, classes=81,
                 pooled=14, mask_res=14, max_gt=20, poly_len=16)
TWO_STAGE_ROI_CHECK = 128   # roi_align's rois held card = CPU
# YOLOv3 at 608 (Redmon & Farhadi 2018): three heads, the nine COCO
# anchors, 80 classes, 50 padded boxes an image
YOLO = dict(batch=8, classes=80, ignore=0.7, max_boxes=50,
            anchors=[10, 13, 16, 30, 33, 23, 30, 61, 62, 45, 59, 119,
                     116, 90, 156, 198, 373, 326],
            heads=((19, 32, [6, 7, 8]), (38, 16, [3, 4, 5]),
                   (76, 8, [0, 1, 2])))
# the dygraph ResNet-50 of Fluid's test_imperative_resnet.py
DY_RESNET = dict(batch=32, image=224, classes=102, lr=0.01, steps=4)
DETECTION_USERS = {
    "ssd_train": "detection teams training single-shot detectors (SSD300 "
                 "on VOC's 21 classes)",
    "ssd_detect": "detection services serving SSD's decoded boxes after "
                  "NMS",
    "two_stage_ops": "Faster/Mask R-CNN trainers (Detectron's C4 "
                     "configurations on COCO)",
    "yolov3_loss": "YOLOv3 trainers at 608 on COCO",
    "dygraph_resnet50": "researchers writing models in dygraph "
                        "(define-by-run) style",
}


def build_ssd300(fluid, image=300, classes=21, max_boxes=50,
                 widths=SSD["widths"], lr=1e-3):
    """SSD300 on VGG-16 built from ``fluid.layers``: conv4_3 (38 x 38) L2
    normalised with a learned scale (20 at start), fc6 a 3x3 conv of
    dilation 6, fc7 1x1, the extra layers down to 1 x 1, ``multi_box_head``
    over the six maps (min sizes 30-264, max 60-315, aspect ratios [2],
    [2, 3] x 3, [2], [2], steps 8-300, variance 0.1/0.2), ``ssd_loss``
    (overlap 0.5, neg:pos 3, ``per_prediction``) averaged over the batch,
    Momentum(lr, 0.9) with L2 5e-4. Pool3 pads 1 to give 38 from 75 (the
    paper's ceil mode; the port's pool2d floors, as Fluid does). The
    ``for_test`` clone, taken before the optimizer, gains
    ``detection_output`` (nms 0.45, top 400, keep 200, score 0.01).
    Returns (main, startup, loss, extra)."""
    c1, c2, c3, c4, c5, c6, e1, e2 = widths
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 24
    L = fluid.layers
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        img = L.data("img", shape=[3, image, image])
        gt_box = L.data("gt_box", shape=[max_boxes, 4])
        gt_label = L.data("gt_label", shape=[max_boxes, 1], dtype="int64")

        def conv(x, c, k=3, s=1, p=1, d=1):
            return L.conv2d(x, c, k, stride=s, padding=p, dilation=d,
                            act="relu")

        x = img
        for c, n, pad in ((c1, 2, 0), (c2, 2, 0), (c3, 3, 1)):
            for _ in range(n):
                x = conv(x, c)
            x = L.pool2d(x, pool_size=2, pool_stride=2, pool_padding=pad)
        for _ in range(3):
            x = conv(x, c4)
        conv4_3 = x
        scale = L.create_parameter(
            [1, c4, 1, 1], "float32",
            default_initializer=fluid.initializer.Constant(20.0))
        norm4_3 = L.elementwise_mul(L.l2_normalize(conv4_3, axis=1), scale)
        x = L.pool2d(conv4_3, pool_size=2, pool_stride=2)
        for _ in range(3):
            x = conv(x, c5)
        x = L.pool2d(x, pool_size=3, pool_stride=1, pool_padding=1)
        fc7 = conv(conv(x, c6, 3, p=6, d=6), c6, 1, p=0)
        c6_2 = conv(conv(fc7, e1, 1, p=0), 2 * e1, 3, s=2, p=1)
        c7_2 = conv(conv(c6_2, e2, 1, p=0), 2 * e2, 3, s=2, p=1)
        c8_2 = conv(conv(c7_2, e2, 1, p=0), 2 * e2, 3, p=0)
        c9_2 = conv(conv(c8_2, e2, 1, p=0), 2 * e2, 3, p=0)
        locs, confs, box, var = L.multi_box_head(
            [norm4_3, fc7, c6_2, c7_2, c8_2, c9_2], img, base_size=image,
            num_classes=classes,
            aspect_ratios=[[2.0], [2.0, 3.0], [2.0, 3.0], [2.0, 3.0], [2.0],
                           [2.0]],
            min_sizes=[30.0, 60.0, 111.0, 162.0, 213.0, 264.0],
            max_sizes=[60.0, 111.0, 162.0, 213.0, 264.0, 315.0],
            steps=[8.0, 16.0, 32.0, 64.0, 100.0, 300.0], flip=True,
            kernel_size=3, pad=1, offset=0.5, variance=[0.1, 0.1, 0.2, 0.2])
        loss = L.reduce_mean(L.ssd_loss(
            locs, confs, gt_box, gt_label, box, var, overlap_threshold=0.5,
            neg_pos_ratio=3.0, neg_overlap=0.5, match_type="per_prediction"))
        test = main.clone(for_test=True)
        tb = test.global_block
        with fluid.program_guard(test, fluid.Program()):
            nmsed, length = L.detection_output(
                tb.var(locs.name), tb.var(confs.name), tb.var(box.name),
                tb.var(var.name), nms_threshold=0.45, nms_top_k=400,
                keep_top_k=200, score_threshold=0.01, return_length=True)
        fluid.optimizer.Momentum(
            lr, 0.9, regularization=fluid.regularizer.L2Decay(5e-4)
        ).minimize(loss)
    return main, startup, loss, dict(
        test=test, nmsed=nmsed, length=length, locs=locs.name,
        confs=confs.name, box=box.name, var=var.name, classes=classes)


def ssd_feed(batch, image=300, max_boxes=50, classes=21, seed=0):
    """Seeded images and 1-8 seeded boxes an image (normalised xyxy, sides
    0.1-0.5, labels 1..classes-1), padded to ``max_boxes`` with zero rows
    (label 0)."""
    rng = np.random.RandomState(seed)
    gt = np.zeros((batch, max_boxes, 4), np.float32)
    lab = np.zeros((batch, max_boxes, 1), np.int64)
    for b in range(batch):
        n = rng.randint(1, 9)
        c = rng.uniform(0.15, 0.85, (n, 2))
        wh = rng.uniform(0.1, 0.5, (n, 2))
        gt[b, :n] = np.clip(np.concatenate([c - wh / 2, c + wh / 2], 1), 0, 1)
        lab[b, :n, 0] = rng.randint(1, classes, n)
    return {"img": rng.randn(batch, 3, image, image).astype(np.float32),
            "gt_box": gt, "gt_label": lab}


def detection_rows_err(got, want, length):
    """Card detections [B, K, 6] against the CPU's on their valid rows:
    (labels equal, largest score and box difference)."""
    labels_equal, err = True, 0.0
    for b, n in enumerate(length):
        g, w = got[b, :n], want[b, :n]
        labels_equal &= bool(np.array_equal(g[:, 0], w[:, 0]))
        if n:
            err = max(err, float(np.abs(g[:, 1:] - w[:, 1:]).max()))
    return labels_equal, err


def ssd_detect_leg(exe, extra, dfeed, feed, scope):
    """``ssd_detect``: the trained SSD's ``for_test`` program with
    ``detection_output`` at batch 32, one eager batch and then captured
    (``run_steps``: 2 warm-ups, the capture, ``SSD_DETECT_BATCHES`` timed
    replays), captured = eager bit for bit; the detections and ``Length``
    held against ``detection_output`` on the CPU on the same ``loc`` and
    ``conf`` tensors (labels and lengths equal, scores and boxes to 1e-5),
    and the last NMS alone held on the card's own decoded boxes and scores;
    then ``detection_map`` over the detections and the feed's boxes, a
    host op: its ``CompiledProgram`` step runs eagerly and is counted."""
    import paddle_tpu_torch as fluid

    t_leg = time.perf_counter()
    dev = exe.place
    test, classes = extra["test"], extra["classes"]
    fetch = [extra["nmsed"], extra["length"], extra["locs"], extra["confs"],
             extra["box"], extra["var"]]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eager = exe.run(test, feed=dfeed, fetch_list=fetch, scope=scope,
                    return_numpy=False)
    torch.cuda.synchronize()
    eager_ms = (time.perf_counter() - t0) * 1e3
    exe_c = fluid.Executor(dev)
    times, outs = [], None
    for i in range(3 + SSD_DETECT_BATCHES):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = exe_c.run_steps(test, (dfeed,), steps=1, fetch_list=fetch,
                               fetch_every=1, scope=scope,
                               return_numpy=False)[0]
        torch.cuda.synchronize()
        if i >= 3:
            times.append((time.perf_counter() - t0) * 1e3)
    captured = [c is not None and c.graph is not None
                for c in exe_c._captured.values()]
    check(any(captured), "ssd_detect: the test program was not captured")
    same = all(torch.equal(eager[k].reshape(-1), outs[k].reshape(-1))
               for k in range(2))
    check(same, "ssd_detect: captured detections part from eager")
    nmsed, length, loc, conf, box, var = [
        t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
        for t in eager]
    check(box.shape == (SSD_PRIORS, 4), "ssd_detect: %s priors, want %d"
          % (box.shape, SSD_PRIORS))
    # the same loc/conf through detection_output on the CPU
    main, start = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, start):
        p = loc.shape[1]
        lv = fluid.layers.data("loc", shape=[p, 4])
        cv = fluid.layers.data("conf", shape=[p, classes])
        pv = fluid.layers.data("prior", shape=[p, 4], append_batch_size=False)
        vv = fluid.layers.data("var", shape=[p, 4], append_batch_size=False)
        out, n_out = fluid.layers.detection_output(
            lv, cv, pv, vv, nms_threshold=0.45, nms_top_k=400, keep_top_k=200,
            score_threshold=0.01, return_length=True)
        dec = fluid.layers.box_coder(pv, vv, lv, code_type="decode_center_size")
        sm = fluid.layers.transpose(fluid.layers.softmax(cv, axis=-1),
                                    perm=[0, 2, 1])
    t0 = time.perf_counter()
    cpu = fluid.Executor(fluid.CPUPlace())
    cpu_out, cpu_len = cpu.run(main, feed={"loc": loc, "conf": conf,
                                           "prior": box, "var": var},
                               fetch_list=[out, n_out], scope=fluid.Scope())
    cpu_s = time.perf_counter() - t0
    lengths_equal = bool(np.array_equal(length, cpu_len))
    labels_equal, err = detection_rows_err(nmsed, cpu_out, length)
    # the last NMS alone on the card's own decoded boxes and scores
    card = fluid.Executor(dev)
    dscope = fluid.Scope()
    cfeed = {"loc": loc, "conf": conf, "prior": box, "var": var}
    dec_card, sm_card = card.run(main, feed=cfeed, fetch_list=[dec, sm],
                                 scope=dscope)
    nms_attrs = {"background_label": 0, "score_threshold": 0.01,
                 "nms_top_k": 400, "nms_threshold": 0.45, "nms_eta": 1.0,
                 "keep_top_k": 200, "normalized": True}
    nms_in = {"BBoxes": torch.as_tensor(dec_card),
              "Scores": torch.as_tensor(sm_card)}
    nms_card, _ = registered_op("multiclass_nms", nms_attrs, nms_in,
                                {"Out": 1, "Length": 1}, dev)
    nms_cpu, _ = registered_op("multiclass_nms", nms_attrs, nms_in,
                               {"Out": 1, "Length": 1}, torch.device("cpu"))
    nms_len_equal = torch.equal(nms_card["Length"].cpu(), nms_cpu["Length"])
    nms_labels, nms_err = detection_rows_err(
        nms_card["Out"].cpu().numpy(), nms_cpu["Out"].numpy(),
        nms_cpu["Length"].numpy())
    check(nms_len_equal and nms_labels and nms_err <= 1e-5,
          "ssd_detect: multiclass_nms on the card's decoded boxes parts from "
          "the CPU (lengths %s, labels %s, err %g)"
          % (nms_len_equal, nms_labels, nms_err))
    check(lengths_equal and labels_equal and err <= 1e-5,
          "ssd_detect: card detections against the CPU's on the same loc "
          "and conf: lengths equal %s, labels equal %s, scores/boxes %g"
          % (lengths_equal, labels_equal, err))
    # detection_map: a host op, eager and counted under CompiledProgram
    gt = np.concatenate([feed["gt_label"].astype(np.float32),
                         feed["gt_box"]], -1)
    mp, ms_ = fluid.Program(), fluid.Program()
    with fluid.program_guard(mp, ms_):
        det_v = fluid.layers.data("det", shape=list(nmsed.shape[1:]))
        len_v = fluid.layers.data("det_len", shape=[], dtype="int32")
        gt_v = fluid.layers.data("gt", shape=list(gt.shape[1:]))
        m_v = fluid.layers.detection_map(det_v, gt_v, class_num=classes,
                                         det_length=len_v)
    exe_m = fluid.Executor(dev)
    mfeed = {"det": nmsed, "det_len": length.astype(np.int32), "gt": gt}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        t0 = time.perf_counter()
        map_c = exe_m.run(fluid.CompiledProgram(mp), feed=mfeed,
                          fetch_list=[m_v])[0]
        map_s = time.perf_counter() - t0
    host_steps = exe_m.host_op_steps
    metric = fluid.metrics.DetectionMAP()
    det_h = nmsed.copy()
    det_h[det_h[..., 0] == 0] = -1.0
    gt_h = gt.copy()
    gt_h[gt_h[..., 0] == 0] = 0.0
    metric.update(det_h, length, gt_h)
    check(host_steps == 1 and float(map_c) == np.float32(metric.eval()),
          "ssd_detect: detection_map %r (host steps %d) against the metric's "
          "%r" % (float(map_c), host_steps, metric.eval()))
    exe_c.close()
    return dict(batch=SSD_BATCH, priors=SSD_PRIORS,
                ms_a_batch_eager=eager_ms,
                ms_a_batch_captured=float(np.median(times)),
                ms_captured=times, captured_equals_eager=True,
                detections_a_batch=int(length.sum()),
                card_vs_cpu={"lengths_equal": lengths_equal,
                             "labels_equal": labels_equal,
                             "max_abs_err": err, "cpu_s": cpu_s},
                nms_on_card_outputs={"lengths_equal": bool(nms_len_equal),
                                     "labels_equal": nms_labels,
                                     "max_abs_err": nms_err},
                detection_map=float(map_c), detection_map_host_steps=host_steps,
                detection_map_s=map_s,
                detection_map_warned=any("detection_map" in str(w.message)
                                         for w in caught),
                users=DETECTION_USERS["ssd_detect"],
                leg_s=time.perf_counter() - t_leg)


def ssd_train_leg(xent_rows):
    """``ssd_train`` (``seq_leg``: eager and captured steps in turns, 2
    warm-ups, the capture and 4 timed each; captured = eager bit for bit,
    losses and every persistable; profiles): SSD300 on VGG-16
    (``build_ssd300``) at batch 32 on seeded images and boxes, K2a twice
    and K2b once a step at [32·8732, 21] (the mining loss and the
    confidence loss; the mining one has no gradient), counted by shape;
    K2 held there against its plain version, timed beside its byte bound
    and ``F.cross_entropy`` (``xent_shape_check``). Then ``ssd_detect`` on
    the eager run's trained state. cuDNN's deterministic algorithms, as in
    ``ocr_ctc_train``."""
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        return _ssd_train(xent_rows)
    finally:
        torch.backends.cudnn.deterministic = prev


def _ssd_train(xent_rows):
    n_rows = SSD_BATCH * SSD_PRIORS
    feed = ssd_feed(SSD_BATCH, SSD["image"], SSD["max_boxes"], SSD["classes"])
    per_step = {"K2a": (r"xent_fwd_kernel", 2), "K2b": (r"xent_bwd_kernel", 1)}
    line, launches, counts = seq_leg(
        "ssd_train", lambda fluid: build_ssd300(fluid, **SSD), feed, per_step,
        SSD_BATCH, SSD_BATCH, decode=ssd_detect_leg)
    key = vision_key(n_rows, SSD["classes"], torch.float32)
    by_shape = launches["K2_by_shape"]
    emit("ssd_train", config=dict(SSD, batch=SSD_BATCH, priors=SSD_PRIORS),
         optimizer="Momentum(%g, 0.9) + L2Decay(5e-4)" % SSD["lr"],
         images_per_s_eager=line["sequences_per_s_eager"],
         images_per_s_captured=line["sequences_per_s_captured"],
         k2_at=key, k2_launches=by_shape, cudnn_deterministic=True,
         reduced=["seeded images and 1-8 seeded boxes an image (no VOC or "
                  "pretrained VGG-16 in the repository)"],
         users=DETECTION_USERS["ssd_train"],
         **{k: v for k, v in line.items() if k != "decode"})
    emit("ssd_detect", nvidia_smi=SMI[0], **line["decode"])
    check(set(by_shape) == {"K2a_" + key, "K2b_" + key}
          and by_shape.get("K2a_" + key) == 2 * by_shape.get("K2b_" + key, 0)
          > 0,
          "ssd_train: K2 launches by shape %r, want K2a twice K2b at %s"
          % (by_shape, key))
    check(line["bit_equal"], "ssd_train: captured losses %r against eager %r "
          "(state %.3g)" % (line["losses_captured"], line["losses_eager"],
                            line["state_max_norm_diff"]))
    import paddle_tpu_torch as fluid

    dev = fluid.CUDAPlace(0)
    flush = l2_flusher(dev)
    k2 = xent_shape_check(dev, flush, n_rows, SSD["classes"], torch.float32,
                          seed=14, kernel="softmax_xent_ssd")
    for row, kern, part in zip(xent_rows, ("K2a", "K2b"), ("fwd", "bwd")):
        row.setdefault("ssd_shapes", {})[key] = {
            "launches_by_leg": {"ssd_train": by_shape.get(kern + "_" + key)},
            "max_err": k2["max_err"],
            **{k[len(part) + 1:]: v for k, v in k2.items()
               if k.startswith(part + "_")}}
    del flush
    torch.cuda.empty_cache()


def two_stage_feed(cfg, seed=0):
    """Seeded C4 features, RPN head outputs and 4-12 gt boxes an image
    (classes 1-80, one polygon of ``poly_len`` vertices each, padded)."""
    rng = np.random.RandomState(seed)
    b, (c, h, w) = cfg["images"], cfg["c4"]
    a = len(cfg["anchor_sizes"]) * len(cfg["ratios"])
    g, lv = cfg["max_gt"], cfg["poly_len"]
    gt = np.zeros((b, g, 4), np.float32)
    cls = np.zeros((b, g), np.int32)
    segms = np.zeros((b, g, lv, 2), np.float32)
    plen = np.zeros((b, g), np.int32)
    for i in range(b):
        n = rng.randint(4, 13)
        ctr = rng.uniform([100, 100], [cfg["im_w"] - 100, cfg["im_h"] - 100],
                          (n, 2))
        rad = rng.uniform(20, 160, (n, 1))
        ang = np.sort(rng.uniform(0, 2 * np.pi, (n, lv)), -1)
        poly = ctr[:, None] + np.stack([np.cos(ang), np.sin(ang)], -1) \
            * rad[..., None] * rng.uniform(0.6, 1.0, (n, lv, 1))
        segms[i, :n] = poly
        plen[i, :n] = rng.randint(6, lv + 1, n)
        gt[i, :n] = np.concatenate([poly.min(1), poly.max(1)], -1)
        cls[i, :n] = rng.randint(1, cfg["classes"], n)
    return {"c4": rng.randn(b, c, h, w).astype(np.float32),
            "rpn_cls": rng.randn(b, a, h, w).astype(np.float32),
            "rpn_bbox": (rng.randn(b, 4 * a, h, w) * 0.1).astype(np.float32),
            "im_info": np.array([[cfg["im_h"], cfg["im_w"], 1.0]] * b,
                                np.float32),
            "gt_boxes": gt, "gt_classes": cls, "gt_segms": segms,
            "gt_poly_len": plen, "is_crowd": np.zeros((b, g), np.int32)}


def build_two_stage(fluid, cfg, proposals_only=False):
    """The Faster/Mask R-CNN target chain as ``fluid.layers`` build it:
    ``anchor_generator`` (variance 1, Detectron's box weights) and
    ``generate_proposals``; unless ``proposals_only``, then
    ``rpn_target_assign``, ``generate_proposal_labels`` and
    ``generate_mask_labels``, all at ``use_random=False``."""
    b, (c, h, w) = cfg["images"], cfg["c4"]
    a = len(cfg["anchor_sizes"]) * len(cfg["ratios"])
    g, lv = cfg["max_gt"], cfg["poly_len"]
    main, startup = fluid.Program(), fluid.Program()
    L = fluid.layers
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        c4 = L.data("c4", shape=[c, h, w])
        cls_v = L.data("rpn_cls", shape=[a, h, w])
        bbox_v = L.data("rpn_bbox", shape=[4 * a, h, w])
        info = L.data("im_info", shape=[3])
        anchors, var = L.anchor_generator(
            c4, anchor_sizes=list(cfg["anchor_sizes"]),
            aspect_ratios=list(cfg["ratios"]), variance=[1.0, 1.0, 1.0, 1.0],
            stride=[cfg["stride"]] * 2)
        rois, probs, length = L.generate_proposals(
            cls_v, bbox_v, info, anchors, var, pre_nms_top_n=cfg["pre_nms"],
            post_nms_top_n=cfg["post_nms"], nms_thresh=cfg["nms"],
            min_size=cfg["min_size"], return_length=True)
        fetch = {"anchors": anchors, "rois": rois, "probs": probs,
                 "length": length}
        if not proposals_only:
            gt_boxes = L.data("gt_boxes", shape=[g, 4])
            gt_classes = L.data("gt_classes", shape=[g], dtype="int32")
            crowd = L.data("is_crowd", shape=[g], dtype="int32")
            segms = L.data("gt_segms", shape=[g, lv, 2])
            plen = L.data("gt_poly_len", shape=[g], dtype="int32")
            sm, tl, tb, iw = L.rpn_target_assign(
                bbox_v, cls_v, anchors, var, gt_boxes, crowd, info,
                rpn_batch_size_per_im=cfg["rpn_batch"],
                rpn_fg_fraction=cfg["rpn_fg"], use_random=False)
            s_rois, labels, tgts, inw, outw, roiw = L.generate_proposal_labels(
                rois, gt_classes, crowd, gt_boxes, info,
                batch_size_per_im=cfg["roi_batch"], fg_fraction=cfg["roi_fg"],
                fg_thresh=0.5, class_nums=cfg["classes"], use_random=False)
            mask, has = L.generate_mask_labels(
                info, gt_classes, crowd, segms, s_rois, labels,
                num_classes=cfg["classes"], resolution=cfg["mask_res"],
                gt_poly_length=plen)
            fetch.update(score_mask=sm, target_label=tl, target_bbox=tb,
                         inside_w=iw, rois_sampled=s_rois, labels=labels,
                         bbox_targets=tgts, bbox_inside_w=inw, roi_w=roiw,
                         mask=mask, has_mask=has)
    return main, startup, fetch


def fetch_all(exe, prog, feed, fetch, scope):
    names = sorted(fetch)
    outs = exe.run(prog, feed=feed, fetch_list=[fetch[n] for n in names],
                   scope=scope, return_numpy=False)
    return dict(zip(names, outs))


def _np_of(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def two_stage_ops_leg():
    """``two_stage_ops``: Detectron's C4 op chain on seeded features
    (``TWO_STAGE``): 63,000 anchors; ``generate_proposals`` at Fluid's
    defaults (pre-NMS 6,000 — 6,000 NMS steps over both images, no host
    read — post 1,000, nms 0.7) eagerly and captured (``run_steps``),
    captured = eager bit for bit, both timed; ``rpn_target_assign`` (256
    an image, fg 0.5), ``generate_proposal_labels`` (512, fg 0.25, 81
    classes) and ``generate_mask_labels`` (14 x 14) at
    ``use_random=False``: every output card = CPU (discrete ones equal,
    floats 1e-5 norm-wise); ``roi_align`` 14 x 14 at 1/16 on the sampled
    rois, forward card = CPU on ``TWO_STAGE_ROI_CHECK`` of them (1e-5),
    its backward run twice on the card bit-equal."""
    import paddle_tpu_torch as fluid

    t_leg = time.perf_counter()
    cfg = TWO_STAGE
    dev = fluid.CUDAPlace(0)
    feed = two_stage_feed(cfg)
    dfeed = {k: torch.as_tensor(v, device=dev) for k, v in feed.items()}
    # generate_proposals eager against captured
    pmain, _, pfetch = build_two_stage(fluid, cfg, proposals_only=True)
    pnames = sorted(pfetch)
    pfeed = {k: dfeed[k] for k in ("c4", "rpn_cls", "rpn_bbox", "im_info")}
    exe = fluid.Executor(dev)
    eager_ms, eager = [], None
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eager = fetch_all(exe, pmain, pfeed, pfetch, fluid.Scope())
        torch.cuda.synchronize()
        eager_ms.append((time.perf_counter() - t0) * 1e3)
    exe_c = fluid.Executor(dev)
    cscope = fluid.Scope()
    cap_ms, outs = [], None
    for i in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = exe_c.run_steps(pmain, (pfeed,), steps=1,
                               fetch_list=[pfetch[n] for n in pnames],
                               fetch_every=1, scope=cscope,
                               return_numpy=False)[0]
        torch.cuda.synchronize()
        cap_ms.append((time.perf_counter() - t0) * 1e3)
    capture_s = [c.capture_s for c in exe_c._captured.values()
                 if getattr(c, "graph", None) is not None]
    check(bool(capture_s), "two_stage_ops: generate_proposals not captured")
    cap_equal = all(torch.equal(eager[n].reshape(-1), outs[k].reshape(-1))
                    for k, n in enumerate(pnames))
    check(cap_equal, "two_stage_ops: captured proposals part from eager")
    (_, busy_e, kern_e, _, calls_e, _) = step_profile(
        lambda: fetch_all(exe, pmain, pfeed, pfetch, fluid.Scope()),
        cpu_ops=False)
    exe_c.close()
    n_anchors = int(np.prod(eager["anchors"].shape[:-1]))
    check(n_anchors == 63000, "two_stage_ops: %d anchors" % n_anchors)
    # the whole chain card against CPU
    main, _, fetch = build_two_stage(fluid, cfg)
    card = fetch_all(exe, main, dfeed, fetch, fluid.Scope())
    t0 = time.perf_counter()
    cpu = fetch_all(fluid.Executor(fluid.CPUPlace()), main, feed, fetch,
                    fluid.Scope())
    cpu_s = time.perf_counter() - t0
    errs = {}
    for n in sorted(fetch):
        g, w = _np_of(card[n]), _np_of(cpu[n])
        if np.issubdtype(w.dtype, np.floating):
            errs[n] = float(np.linalg.norm((g - w).astype(np.float64))
                            / max(np.linalg.norm(w.astype(np.float64)), 1e-30))
        else:
            errs[n] = bool(np.array_equal(g, w))
    bad = {n: e for n, e in errs.items()
           if (e is not True) and not (isinstance(e, float) and e <= 1e-5)}
    check(not bad, "two_stage_ops: card against CPU %r" % bad)
    sm = _np_of(card["score_mask"])
    labels = _np_of(card["labels"])
    # roi_align on the sampled rois: forward card = CPU, backward twice
    rois = card["rois_sampled"].reshape(-1, 4)
    bid = torch.arange(cfg["images"], device=dev, dtype=torch.int32
                       ).repeat_interleave(cfg["roi_batch"])
    attrs = {"pooled_height": cfg["pooled"], "pooled_width": cfg["pooled"],
             "spatial_scale": 1.0 / cfg["stride"], "sampling_ratio": -1}
    x = dfeed["c4"]
    grads, fwd_ms = [], []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, g = registered_op("roi_align", attrs, {
            "X": x.clone(), "ROIs": rois, "BatchId": bid}, {"Out": 1}, dev)
        torch.cuda.synchronize()
        fwd_ms.append((time.perf_counter() - t0) * 1e3)
        grads.append(g["X"])
    bwd_equal = bool(torch.equal(grads[0], grads[1]))
    check(bwd_equal, "two_stage_ops: roi_align's backward parts between runs")
    k = TWO_STAGE_ROI_CHECK
    sub = torch.cat([rois[:k // 2], rois[cfg["roi_batch"]:
                                         cfg["roi_batch"] + k // 2]])
    sub_bid = torch.cat([bid[:k // 2], bid[cfg["roi_batch"]:
                                           cfg["roi_batch"] + k // 2]])
    got, _ = registered_op("roi_align", attrs, {"X": x, "ROIs": sub,
                                                "BatchId": sub_bid},
                           {"Out": 1}, dev)
    want, _ = registered_op("roi_align", attrs, {
        "X": x.cpu(), "ROIs": sub.cpu(), "BatchId": sub_bid.cpu()},
        {"Out": 1}, torch.device("cpu"))
    roi_err = float((got["Out"].cpu() - want["Out"]).norm()
                    / want["Out"].norm())
    check(roi_err <= 1e-5, "two_stage_ops: roi_align card against CPU %g"
          % roi_err)
    emit("two_stage_ops", nvidia_smi=SMI[0], config=cfg, anchors=n_anchors,
         generate_proposals_ms_eager=float(np.median(eager_ms)),
         generate_proposals_ms_captured=float(np.median(cap_ms[3:])),
         generate_proposals_ms_runs={"eager": eager_ms, "run_steps": cap_ms},
         generate_proposals_capture_s=capture_s,
         generate_proposals_kernels_eager=sum(kern_e.values()),
         generate_proposals_device_busy_ms_eager=busy_e,
         generate_proposals_host_launch_calls_eager=calls_e,
         proposals_a_image=_np_of(eager["length"]).tolist(),
         captured_equals_eager=cap_equal, card_vs_cpu=errs, cpu_s=cpu_s,
         rpn_fg=int((sm == 1).sum()), rpn_bg=int((sm == 0).sum()),
         roi_fg=int((labels > 0).sum()), roi_bg=int((labels == 0).sum()),
         roi_align_rois=int(rois.shape[0]),
         roi_align_fwd_bwd_ms=fwd_ms, roi_align_backward_bit_equal=bwd_equal,
         roi_align_card_vs_cpu=roi_err, roi_align_checked_rois=k,
         reduced=["seeded features and RPN outputs (no COCO or trained "
                  "ResNet-50 in the repository)"],
         users=DETECTION_USERS["two_stage_ops"],
         leg_s=time.perf_counter() - t_leg)
    del x, grads, card, cpu, dfeed
    torch.cuda.empty_cache()


def yolo_inputs(cfg, seed=0):
    """Seeded head outputs [N, 255, H, W] for each head and 50 padded gt
    rows an image (4-20 real: cx, cy in [0.05, 0.95], w, h in [0.02,
    0.6]), labels 0-79, padding rows zero with label -1."""
    rng = np.random.RandomState(seed)
    n, nb = cfg["batch"], cfg["max_boxes"]
    xs = [(rng.randn(n, len(m) * (5 + cfg["classes"]), s, s) * 0.5)
          .astype(np.float32) for s, _, m in cfg["heads"]]
    gt = np.zeros((n, nb, 4), np.float32)
    lab = np.full((n, nb), -1, np.int32)
    for i in range(n):
        k = rng.randint(4, 21)
        gt[i, :k, :2] = rng.uniform(0.05, 0.95, (k, 2))
        gt[i, :k, 2:] = rng.uniform(0.02, 0.6, (k, 2))
        lab[i, :k] = rng.randint(0, cfg["classes"], k)
    return xs, gt, lab


def yolo_step(cfg, xs, gt, lab):
    """The three heads' ``yolov3_loss`` summed over images and heads, and
    its gradient to each head's input: (losses [3, N], grads)."""
    from types import SimpleNamespace

    from paddle_tpu_torch.core.registry import OpContext, get_op_impl

    impl = get_op_impl("yolov3_loss")
    losses = []
    for x, (_, down, mask) in zip(xs, cfg["heads"]):
        env = {"X": x, "GTBox": gt, "GTLabel": lab}
        op = SimpleNamespace(
            type="yolov3_loss", block=None,
            inputs={"X": ["X"], "GTBox": ["GTBox"], "GTLabel": ["GTLabel"]},
            outputs={"Loss": ["Loss"]},
            attrs={"anchors": cfg["anchors"], "anchor_mask": mask,
                   "class_num": cfg["classes"], "ignore_thresh": cfg["ignore"],
                   "downsample_ratio": down})
        impl(OpContext(op, env, SimpleNamespace(is_test=False,
                                                device=x.device,
                                                program=None)))
        losses.append(env["Loss"])
    loss = torch.stack(losses)
    grads = torch.autograd.grad(loss.sum(), xs)
    return (loss.detach(),) + tuple(grads)


def graph_of(fn, inputs):
    """``fn(*inputs)`` captured into a CUDA graph on static copies of the
    inputs (one warm-up on a side stream first): (graph, static outputs,
    static inputs)."""
    from paddle_tpu_torch.serving.captured import gc_paused

    static = [t.detach().clone().requires_grad_(t.requires_grad)
              for t in inputs]
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn(*static)
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with gc_paused(), torch.cuda.graph(graph, stream=stream):
        out = fn(*static)
    return graph, out, static


def yolov3_loss_leg():
    """``yolov3_loss``: YOLOv3's three heads at 608 (``YOLO``: [8, 255,
    19/38/76], masks [6,7,8]/[3,4,5]/[0,1,2], 80 classes, ignore 0.7, 50
    padded boxes an image, padding labels -1): forward and the gradient
    to every head input on the card against the CPU (the losses 1e-5
    relative each, the gradients 1e-5 norm-wise), two card runs bit-equal,
    and the step captured in a CUDA graph equal to eager bit for bit."""
    import paddle_tpu_torch as fluid

    t_leg = time.perf_counter()
    cfg = YOLO
    dev = fluid.CUDAPlace(0)
    xs, gt, lab = yolo_inputs(cfg)
    card_x = [torch.as_tensor(x, device=dev).requires_grad_(True) for x in xs]
    card_gt, card_lab = (torch.as_tensor(gt, device=dev),
                         torch.as_tensor(lab, device=dev))
    run = [yolo_step(cfg, card_x, card_gt, card_lab) for _ in range(2)]
    runs_equal = all(torch.equal(a, b) for a, b in zip(*run))
    cpu_x = [torch.as_tensor(x).requires_grad_(True) for x in xs]
    t0 = time.perf_counter()
    cpu = yolo_step(cfg, cpu_x, torch.as_tensor(gt), torch.as_tensor(lab))
    cpu_s = time.perf_counter() - t0
    loss_err = rel_err(run[0][0].cpu(), cpu[0])
    grad_err = max(float((g.cpu() - w).norm() / w.norm())
                   for g, w in zip(run[0][1:], cpu[1:]))
    graph, out, static = graph_of(
        lambda *a: yolo_step(cfg, list(a[:3]), a[3], a[4]),
        card_x + [card_gt, card_lab])
    graph.replay()
    torch.cuda.synchronize()
    cap_equal = all(torch.equal(a, b) for a, b in zip(out, run[0]))
    times_e = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        yolo_step(cfg, card_x, card_gt, card_lab)
        torch.cuda.synchronize()
        times_e.append((time.perf_counter() - t0) * 1e3)
    times_c = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        graph.replay()
        torch.cuda.synchronize()
        times_c.append((time.perf_counter() - t0) * 1e3)
    check(runs_equal and cap_equal and loss_err <= 1e-5 and grad_err <= 1e-5
          and bool(torch.isfinite(run[0][0]).all()),
          "yolov3_loss: runs equal %s, captured = eager %s, loss card vs CPU "
          "%g, gradients %g (1e-5)" % (runs_equal, cap_equal, loss_err,
                                       grad_err))
    emit("yolov3_loss", nvidia_smi=SMI[0], config=cfg,
         gt_boxes=int((lab >= 0).sum()), losses=run[0][0].cpu().tolist(),
         loss_card_vs_cpu=loss_err, grad_card_vs_cpu=grad_err,
         runs_bit_equal=runs_equal, captured_equals_eager=cap_equal,
         ms_eager=float(np.median(times_e)),
         ms_captured=float(np.median(times_c)), cpu_s=cpu_s,
         users=DETECTION_USERS["yolov3_loss"],
         leg_s=time.perf_counter() - t_leg)
    del graph, out, static, run
    torch.cuda.empty_cache()


def dygraph_resnet(imp, class_dim=102):
    """The dygraph ResNet-50 of Fluid's ``test_imperative_resnet.py``,
    built from ``imperative.nn``: ``ConvBNLayer`` (a Conv2D with its bias,
    then BatchNorm), ``BottleneckBlock`` (1x1, 3x3, 1x1 x4, a projection
    when the shape changes), stages of 3/4/6/3 blocks of 64-512 filters,
    global average pooling and an FC of ``class_dim`` with Uniform(±1/√2048)
    weights. The FC gives logits (the test's FC has ``act='softmax'`` and
    its loss ``cross_entropy``): the loss here is
    ``F.softmax_with_cross_entropy``, which reaches K2a/K2b. Returns the
    network and its (conv, bn) pairs in forward order."""
    import math

    import paddle_tpu_torch as fluid

    pairs = []

    class ConvBNLayer(imp.Layer):
        def __init__(self, name_scope, num_channels, num_filters, filter_size,
                     stride=1, act=None):
            super().__init__(name_scope)
            self._conv = imp.Conv2D(self.full_name(), num_channels, num_filters,
                                    filter_size, stride=stride,
                                    padding=(filter_size - 1) // 2)
            self._batch_norm = imp.BatchNorm(self.full_name(), num_filters,
                                             act=act)
            pairs.append((self._conv, self._batch_norm))

        def forward(self, inputs):
            return self._batch_norm(self._conv(inputs))

    class BottleneckBlock(imp.Layer):
        def __init__(self, name_scope, num_channels, num_filters, stride,
                     shortcut=True):
            super().__init__(name_scope)
            self.conv0 = ConvBNLayer(self.full_name(), num_channels,
                                     num_filters, 1, act="relu")
            self.conv1 = ConvBNLayer(self.full_name(), num_filters,
                                     num_filters, 3, stride=stride, act="relu")
            self.conv2 = ConvBNLayer(self.full_name(), num_filters,
                                     num_filters * 4, 1)
            if not shortcut:
                self.short = ConvBNLayer(self.full_name(), num_channels,
                                         num_filters * 4, 1, stride=stride)
            self.shortcut = shortcut
            self._num_channels_out = num_filters * 4

        def forward(self, inputs):
            conv2 = self.conv2(self.conv1(self.conv0(inputs)))
            short = inputs if self.shortcut else self.short(inputs)
            y = imp.dispatch("elementwise_add", {"X": short, "Y": conv2})
            return imp.F.relu(y)

    class ResNet(imp.Layer):
        def __init__(self, name_scope, class_dim):
            super().__init__(name_scope)
            self.conv = ConvBNLayer(self.full_name(), 3, 64, 7, stride=2,
                                    act="relu")
            self.pool2d_max = imp.Pool2D(self.full_name(), pool_size=3,
                                         pool_stride=2, pool_padding=1,
                                         pool_type="max")
            self.blocks = []
            num_channels = 64
            for block, (depth, nf) in enumerate(zip((3, 4, 6, 3),
                                                    (64, 128, 256, 512))):
                shortcut = False
                for i in range(depth):
                    bb = self.add_sublayer("bb_%d_%d" % (block, i),
                                           BottleneckBlock(
                        self.full_name(), num_channels, nf,
                        2 if i == 0 and block != 0 else 1, shortcut))
                    num_channels = bb._num_channels_out
                    self.blocks.append(bb)
                    shortcut = True
            self.pool2d_avg = imp.Pool2D(self.full_name(), pool_size=7,
                                         pool_type="avg", global_pooling=True)
            stdv = 1.0 / math.sqrt(2048 * 1.0)
            self.out = imp.FC(self.full_name(), size=class_dim,
                              param_attr=fluid.ParamAttr(
                                  initializer=fluid.initializer.Uniform(
                                      -stdv, stdv)))

        def forward(self, inputs):
            y = self.pool2d_max(self.conv(inputs))
            for bb in self.blocks:
                y = bb(y)
            return self.out(self.pool2d_avg(y))

    return ResNet("resnet", class_dim), pairs


def static_resnet_state(fluid, main, scope):
    """The static ResNet-50's state in forward order: for each conv2d its
    filter and its batch norm's (scale, bias, mean, variance), then the
    fc's weight and bias."""
    ops = main.global_block.ops
    convs = [op.input("Filter")[0] for op in ops if op.type == "conv2d"]
    bns = [[op.input(s)[0] for s in ("Scale", "Bias", "Mean", "Variance")]
           for op in ops if op.type == "batch_norm"]
    fc_w = [op.input("Y")[0] for op in ops if op.type == "mul"][0]
    fc_b = [n for n in scope.vars if n.startswith("fc_0.b")][0]
    return convs, bns, fc_w, fc_b


def load_static_into_dygraph(net, pairs, convs, bns, fc_w, fc_b, scope,
                             probe):
    """Copies the static ResNet-50's state into the dygraph one (the conv
    biases, absent in the static net, to 0), after one forward of
    ``probe`` builds the lazily-sized FC."""
    net(probe)
    check(len(pairs) == len(convs) == len(bns) == 53,
          "dygraph_resnet50: %d conv+bn pairs against %d convs, %d bns"
          % (len(pairs), len(convs), len(bns)))
    for (conv, bn), w, (s, b, m, v) in zip(pairs, convs, bns):
        conv.weight.value = scope.find_var(w)
        conv.bias.value = torch.zeros_like(conv.bias.value)
        bn.weight.value = scope.find_var(s)
        bn.bias.value = scope.find_var(b)
        bn._mean.value = scope.find_var(m)
        bn._variance.value = scope.find_var(v)
    net.out.weight.value = scope.find_var(fc_w)
    net.out.bias.value = scope.find_var(fc_b)


def dygraph_state(net, pairs):
    """Every parameter and BatchNorm running statistic, cloned."""
    out = [p.value.detach().clone() for p in net.parameters()]
    for _, bn in pairs:
        out += [bn._mean.value.clone(), bn._variance.value.clone()]
    return out


def dygraph_resnet50_leg(xent_rows):
    """``dygraph_resnet50``: ``dygraph_resnet`` at batch 32 x 224, 102
    classes, on the card (``imperative.guard()``), with cuDNN's
    deterministic algorithms. From the port's static ``models.resnet``
    ResNet-50's startup state: one dygraph SGD step equals the static
    program's SGD step (loss and every parameter and running statistic,
    1e-5 norm-wise); then from that same state ``DY_RESNET['steps']``
    eager Momentum steps (``backward``, ``minimize``,
    ``clear_gradients``) against ``jit_train`` (one eager step, then one
    CUDA graph of forward, backward and update, replayed): losses,
    parameters and BatchNorm's running statistics bit-equal. K2a/K2b
    launch in the eager steps at [32, 102], and are held against their
    plain versions at that shape (``xent_shape_check``). Times: an eager
    dygraph step, a ``jit_train`` replay, the static program's captured
    step."""
    prev = (torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic)
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    try:
        _dygraph_resnet50(xent_rows)
    finally:
        (torch.backends.cudnn.benchmark,
         torch.backends.cudnn.deterministic) = prev


def _dygraph_resnet50(xent_rows):
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import imperative as imp
    from paddle_tpu_torch.models import resnet as rn

    t_leg = time.perf_counter()
    cfg = DY_RESNET
    dev = fluid.CUDAPlace(0)
    feed = resnet_feed(cfg["batch"], cfg["image"], cfg["classes"], seed=80)
    # the static program (SGD) and its startup state
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        img = fluid.layers.data("img", shape=[3, cfg["image"], cfg["image"]])
        label = fluid.layers.data("label", shape=[1], dtype="int64")
        _, loss, _ = rn.resnet50(img, label, class_num=cfg["classes"])
        fluid.optimizer.SGD(cfg["lr"]).minimize(loss)
    scope = fluid.Scope()
    exe = fluid.Executor(dev)
    exe.run(startup, scope=scope)
    start = clone_scope(fluid, scope)
    convs, bns, fc_w, fc_b = static_resnet_state(fluid, main, scope)
    dfeed = {k: torch.as_tensor(v, device=dev) for k, v in feed.items()}
    static_loss = float(exe.run(main, feed=dfeed, fetch_list=[loss],
                                scope=scope)[0])

    def loss_of(net):
        def loss_fn(x, y):
            return imp.F.mean(imp.F.softmax_with_cross_entropy(net(x), y))
        return loss_fn

    with imp.guard(seed=5):
        # one SGD step against the static program's
        net, pairs = dygraph_resnet(imp, cfg["classes"])
        load_static_into_dygraph(net, pairs, convs, bns, fc_w, fc_b, start,
                                 imp.to_variable(feed["img"][:2]))
        x = imp.to_variable(feed["img"])
        y = imp.to_variable(feed["label"])
        dl = loss_of(net)(x, y)
        dl.backward()
        fluid.optimizer.SGD(cfg["lr"]).minimize(dl)
        net.clear_gradients()
        sgd_loss_err = abs(float(dl.numpy()) - static_loss) / abs(static_loss)
        sgd_state_err = 0.0
        got = dict([(w, c.weight.value) for (c, _), w in zip(pairs, convs)]
                   + [(fc_w, net.out.weight.value), (fc_b, net.out.bias.value)])
        for (_, bn), names in zip(pairs, bns):
            got.update(zip(names, (bn.weight.value, bn.bias.value,
                                   bn._mean.value, bn._variance.value)))
        for n, t in got.items():
            w = scope.find_var(n)
            sgd_state_err = max(sgd_state_err, float(
                (t.detach().double() - w.double()).norm()
                / max(float(w.double().norm()), 1e-30)))
        del net, pairs, got
        check(sgd_loss_err <= 1e-5 and sgd_state_err <= 1e-5,
              "dygraph_resnet50: the SGD step against the static one: loss "
              "%g, state %g norm-wise (1e-5)" % (sgd_loss_err, sgd_state_err))

        # eager Momentum steps against jit_train, from one state
        runs = {}
        kernel_counters(reset=True)
        for mode in ("eager", "jit_train"):
            net, pairs = dygraph_resnet(imp, cfg["classes"])
            load_static_into_dygraph(net, pairs, convs, bns, fc_w, fc_b, start,
                                 imp.to_variable(feed["img"][:2]))
            opt = fluid.optimizer.Momentum(cfg["lr"], 0.9)
            loss_fn = loss_of(net)
            losses, times = [], []
            step = imp.jit_train(loss_fn, net, opt) if mode == "jit_train" \
                else None
            for i in range(cfg["steps"]):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if step is not None:
                    lv = step(dfeed["img"], dfeed["label"])
                else:
                    lv = loss_fn(imp.to_variable(feed["img"]),
                                 imp.to_variable(feed["label"]))
                    lv.backward()
                    opt.minimize(lv)
                    net.clear_gradients()
                losses.append(lv.value.detach().clone())
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            if mode == "eager":
                k2 = kernel_counters()
            runs[mode] = dict(losses=torch.stack(losses), times=times,
                              state=dygraph_state(net, pairs),
                              captured=getattr(step, "captured", None))
            if step is not None and step.captured:
                graphs = step._jit_state["graphs"]
                replay = next(iter(graphs.values()))[0].replay
                (_, busy_c, kern_c, _, _, _) = step_profile(replay,
                                                            cpu_ops=False)
                t_rep = []
                for _ in range(3):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    replay()
                    torch.cuda.synchronize()
                    t_rep.append((time.perf_counter() - t0) * 1e3)
                runs[mode].update(replay_ms=t_rep, busy_ms=busy_c,
                                  kernels=sum(kern_c.values()))
                del graphs, replay
            elif step is None:
                (_, busy_e, kern_e, _, calls_e, _) = step_profile(
                    lambda: loss_fn(imp.to_variable(feed["img"]),
                                    imp.to_variable(feed["label"])),
                    cpu_ops=False)
            del net, pairs, opt, loss_fn
    e, j = runs["eager"], runs["jit_train"]
    losses_equal = bool(torch.equal(e["losses"], j["losses"]))
    state_equal = len(e["state"]) == len(j["state"]) and all(
        torch.equal(a, b) for a, b in zip(e["state"], j["state"]))
    key = vision_key(cfg["batch"], cfg["classes"], torch.float32)
    check(j["captured"] is True and losses_equal and state_equal,
          "dygraph_resnet50: jit_train (captured %s) against eager: losses "
          "%s / %s, state bit-equal %s" % (j["captured"],
                                           e["losses"].tolist(),
                                           j["losses"].tolist(), state_equal))
    check(k2["K2a"] == k2["K2b"] == cfg["steps"]
          and set(k2["K2_by_shape"]) == {"K2a_" + key, "K2b_" + key},
          "dygraph_resnet50: K2 launches in %d eager steps %r"
          % (cfg["steps"], k2))
    # the static captured step (its SGD program) for the comparison
    exe_s = fluid.Executor(dev)
    static_ms = []
    for i in range(3 + 3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        exe_s.run_steps(main, (dfeed,), steps=1, fetch_list=[loss],
                        scope=scope, return_numpy=False)
        torch.cuda.synchronize()
        if i >= 3:
            static_ms.append((time.perf_counter() - t0) * 1e3)
    exe_s.close()
    # K2a/K2b against their plain versions at the loss shape this leg
    # gives them, [32, 102]
    flush = l2_flusher(dev)
    k2_check = xent_shape_check(dev, flush, cfg["batch"], cfg["classes"],
                                torch.float32, seed=15,
                                kernel="softmax_xent_dygraph")
    del flush
    for row, kern, part in zip(xent_rows, ("K2a", "K2b"), ("fwd", "bwd")):
        row.setdefault("vision_shapes", {})[key] = {
            "launches_by_leg": {"dygraph_resnet50": k2[kern]},
            "max_err": k2_check["max_err"],
            **{k[len(part) + 1:]: v for k, v in k2_check.items()
               if k.startswith(part + "_")}}
    emit("dygraph_resnet50", nvidia_smi=SMI[0], config=cfg,
         sgd_step_vs_static={"loss_rel": sgd_loss_err,
                             "state_norm_rel": sgd_state_err},
         losses_eager=e["losses"].tolist(), losses_jit_train=j["losses"].tolist(),
         bit_equal=True, k2_launches=k2,
         step_ms_eager=float(np.median(e["times"][1:])),
         step_ms_eager_runs=e["times"], step_ms_jit_train_calls=j["times"],
         step_ms_jit_train_replay=float(np.median(j.get("replay_ms", [0]))),
         step_ms_static_captured=float(np.median(static_ms)),
         kernels_a_forward_eager=sum(kern_e.values()),
         host_launch_calls_forward_eager=calls_e,
         kernels_a_jit_train_replay=j.get("kernels"),
         device_busy_ms_replay=j.get("busy_ms"), cudnn_deterministic=True,
         reduced=["seeded images (no flowers data in the repository); the "
                  "loss takes logits (softmax_with_cross_entropy) where the "
                  "test's FC has act='softmax' and cross_entropy"],
         users=DETECTION_USERS["dygraph_resnet50"],
         leg_s=time.perf_counter() - t_leg)
    del scope, start, exe, runs
    torch.cuda.empty_cache()


def detection_harness_cases():
    """(op, inputs, attrs, output slots) of the 20 detection ops at test
    size, seeded, for ``detection_op_harness``."""
    rng = np.random.RandomState(90)

    def boxes(n, lead=(), hi=1.0, min_wh=0.05):
        p = rng.uniform(0, hi, lead + (n, 2, 2))
        a, b = p.min(-2), p.max(-2)
        b = np.maximum(b, a + min_wh * hi)
        return np.concatenate([a, b], -1).astype("float32")

    def r(*s, scale=1.0):
        return (rng.randn(*s) * scale).astype("float32")

    fm = {"Input": np.zeros((1, 8, 5, 6), "float32"),
          "Image": np.zeros((1, 3, 40, 48), "float32")}
    yield ("iou_similarity", {"X": boxes(6, (2,)), "Y": boxes(9)}, {},
           ["Out"])
    yield ("box_coder", {"PriorBox": boxes(9), "TargetBox": boxes(4, (2,))},
           {"code_type": "encode_center_size",
            "variance": [0.1, 0.1, 0.2, 0.2]}, ["OutputBox"])
    yield ("prior_box", fm, {"min_sizes": [8.0], "max_sizes": [16.0],
                             "aspect_ratios": [2.0], "flip": True,
                             "clip": True}, ["Boxes", "Variances"])
    yield ("density_prior_box", fm, {"fixed_sizes": [8.0],
                                     "fixed_ratios": [1.0, 2.0],
                                     "densities": [2]}, ["Boxes", "Variances"])
    yield ("anchor_generator", {"Input": fm["Input"]},
           {"anchor_sizes": [16.0, 32.0], "aspect_ratios": [0.5, 1.0, 2.0],
            "stride": [8.0, 8.0]}, ["Anchors", "Variances"])
    yield ("box_clip", {"Input": r(2, 7, 4, scale=30),
                        "ImInfo": np.float32([[40, 48, 1], [30, 20, 2]])},
           {}, ["Output"])
    dist = (rng.randint(0, 6, (2, 4, 12)) / 5.0).astype("float32")
    yield ("bipartite_match", {"DistMat": dist},
           {"match_type": "per_prediction", "dist_threshold": 0.5},
           ["ColToRowMatchIndices", "ColToRowMatchDist"])
    match = rng.randint(-1, 4, (2, 12)).astype("int32")
    yield ("target_assign", {"X": r(2, 4, 12, 4), "MatchIndices": match,
                             "NegMask": (match < 0).astype("int32")},
           {"mismatch_value": 0.0}, ["Out", "OutWeight"])
    yield ("mine_hard_examples",
           {"ClsLoss": (rng.randint(0, 5, (2, 12)) / 2.0).astype("float32"),
            "MatchIndices": match, "MatchDist": r(2, 12) ** 2},
           {"neg_pos_ratio": 3.0, "neg_dist_threshold": 0.5}, ["NegMask"])
    yield ("multiclass_nms", {"BBoxes": boxes(30, (2,), min_wh=0.1),
                              "Scores": (rng.randint(0, 8, (2, 4, 30)) / 8.0)
                              .astype("float32")},
           {"background_label": 0, "score_threshold": 0.1, "nms_top_k": 12,
            "nms_threshold": 0.5, "nms_eta": 0.8, "keep_top_k": 10},
           ["Out", "Length"])
    x = r(2, 3, 9, 11)
    rois = boxes(5, hi=16.0, min_wh=0.1)
    bid = np.int32([0, 1, 1, 0, 1])
    yield ("roi_align", {"X": x, "ROIs": rois, "BatchId": bid},
           {"pooled_height": 3, "pooled_width": 2, "spatial_scale": 0.5},
           ["Out"])
    yield ("roi_pool", {"X": x, "ROIs": rois, "BatchId": bid},
           {"pooled_height": 2, "pooled_width": 3, "spatial_scale": 0.5},
           ["Out"])
    yield ("roi_perspective_transform",
           {"X": x, "ROIs": np.float32([[1, 1, 9, 2, 10, 8, 2, 7],
                                        [3, 2, 6, 1, 8, 6, -2, 11]]),
            "BatchId": np.int32([0, 1])},
           {"transformed_height": 4, "transformed_width": 5}, ["Out"])
    yield ("polygon_box_transform", {"Input": r(2, 8, 3, 4)}, {}, ["Output"])
    gt = np.concatenate([rng.uniform(0.1, 0.9, (2, 6, 2)),
                         rng.uniform(0.05, 0.5, (2, 6, 2))], -1)
    yield ("yolov3_loss", {"X": r(2, 3 * 8, 5, 6, scale=0.5),
                           "GTBox": gt.astype("float32"),
                           "GTLabel": rng.randint(-1, 3, (2, 6))
                           .astype("int32")},
           {"anchors": [10, 13, 16, 30, 33, 23], "anchor_mask": [0, 1, 2],
            "class_num": 3, "ignore_thresh": 0.5, "downsample_ratio": 8},
           ["Loss"])
    anc = np.stack(np.meshgrid(np.arange(6) * 16.0, np.arange(5) * 16.0),
                   -1).reshape(5, 6, 1, 2)
    anc = np.concatenate([anc, anc + 31.0], -1).repeat(3, 2).astype("float32")
    yield ("generate_proposals",
           {"Scores": r(2, 3, 5, 6), "BboxDeltas": r(2, 12, 5, 6, scale=0.2),
            "ImInfo": np.float32([[80, 96, 1], [70, 90, 1]]),
            "Anchors": anc, "Variances": np.ones_like(anc)},
           {"pre_nms_topN": 40, "post_nms_topN": 12, "nms_thresh": 0.5,
            "min_size": 2.0}, ["RpnRois", "RpnRoiProbs", "Length"])
    gtb = boxes(4, (2,), hi=80.0, min_wh=0.2)
    yield ("rpn_target_assign",
           {"Anchor": anc.reshape(-1, 4), "GtBoxes": gtb,
            "ImInfo": np.float32([[80, 96, 1], [80, 96, 1]])},
           {"rpn_batch_size_per_im": 16, "rpn_fg_fraction": 0.25,
            "rpn_positive_overlap": 0.5, "use_random": False},
           ["ScoreMask", "TargetLabel", "TargetBBox", "BBoxInsideWeight"])
    prop = np.concatenate([gtb + r(2, 4, 4, scale=2.0),
                           boxes(10, (2,), hi=80.0, min_wh=0.1)], 1)
    yield ("generate_proposal_labels",
           {"RpnRois": prop, "GtClasses": np.int32([[1, 2, 3, 1], [2, 2, 1, 3]]),
            "GtBoxes": gtb, "ImInfo": np.float32([[80, 96, 1]] * 2)},
           {"batch_size_per_im": 8, "fg_fraction": 0.25, "class_nums": 4,
            "use_random": False},
           ["Rois", "LabelsInt32", "BboxTargets", "RoiWeights"])
    ang = np.sort(rng.uniform(0, 2 * np.pi, (2, 3, 6)), -1)
    segms = (rng.uniform(10, 30, (2, 3, 1, 2))
             + np.stack([np.cos(ang), np.sin(ang)], -1) * 6).astype("float32")
    yield ("generate_mask_labels",
           {"Rois": boxes(5, (2,), hi=40.0, min_wh=0.2),
            "LabelsInt32": rng.randint(-1, 3, (2, 5)).astype("int32"),
            "GtSegms": segms, "GtPolyLength": np.int32([[6, 5, 4], [3, 6, 2]]),
            "GtClasses": np.int32([[1, 2, 3], [3, 1, 2]])},
           {"num_classes": 4, "resolution": 5},
           ["MaskInt32", "RoiHasMaskInt32"])
    det = np.concatenate([rng.randint(0, 4, (2, 8, 1)),
                          rng.randint(1, 9, (2, 8, 1)) / 9.0,
                          boxes(8, (2,))], -1).astype("float32")
    lab = np.concatenate([rng.randint(0, 4, (2, 5, 1)), boxes(5, (2,))],
                         -1).astype("float32")
    lab[:, :3, 1:] = det[:, :3, 2:]
    lab[:, :3, 0] = det[:, :3, 0]
    yield ("detection_map", {"DetectRes": det, "Label": lab,
                             "DetLength": np.int32([8, 6])},
           {"overlap_threshold": 0.5, "background_label": 0}, ["MAP"])


DETECTION_OPS = 20


def detection_op_harness_leg():
    """``detection_op_harness``: the port's ``OpTest.check_output`` on the
    card for the 20 detection ops of ``detection_harness_cases`` against
    their run on the CPU (1e-5 relative and absolute: integer outputs
    exactly)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.testing import OpTest, op_test

    t_leg = time.perf_counter()
    cpu, card = fluid.CPUPlace(), fluid.CUDAPlace(0)
    rows = []
    for op, inputs, attrs, outs in detection_harness_cases():
        want = op_test.run_op(op, inputs, outs, attrs, place=cpu)
        case = type("Case", (OpTest,), {
            "op_type": op, "inputs": inputs, "attrs": attrs,
            "outputs": {s: want[s].numpy() for s in outs}})()
        case.check_output(atol=1e-5, rtol=1e-5, place=card)
        got = op_test.run_op(op, inputs, outs, attrs, place=card)
        rows.append({"op": op, "max_abs_diff": max(
            float((got[s].cpu().double() - want[s].double()).abs().max())
            for s in outs)})
    check(len({r["op"] for r in rows}) == DETECTION_OPS,
          "detection_op_harness: %d ops" % len(rows))
    emit("detection_op_harness", nvidia_smi=SMI[0], cases=rows,
         tol={"rtol": 1e-5, "atol": 1e-5}, leg_s=time.perf_counter() - t_leg)


def detection_phase(xent_rows):
    """Detection and dygraph: ``ssd_train`` (+ ``ssd_detect``),
    ``two_stage_ops``, ``yolov3_loss``, ``dygraph_resnet50``,
    ``detection_op_harness``; each leg's seconds in
    ``detection_leg_seconds``."""
    secs = {}
    for name, fn, args in (("ssd_train", ssd_train_leg, (xent_rows,)),
                           ("two_stage_ops", two_stage_ops_leg, ()),
                           ("yolov3_loss", yolov3_loss_leg, ()),
                           ("dygraph_resnet50", dygraph_resnet50_leg,
                            (xent_rows,)),
                           ("detection_op_harness", detection_op_harness_leg,
                            ())):
        t0 = time.perf_counter()
        fn(*args)
        secs[name] = time.perf_counter() - t0
    emit("detection_leg_seconds", nvidia_smi=SMI[0], **secs)


def diagnose(args):
    """``--recipe-bisect [--deterministic] NAME...``: ``recipe_bisect`` of
    each recipe ("lamb", "adamw", "adam"; run ``--deterministic`` with
    ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` in the environment). The kernels
    are built first."""
    from paddle_tpu_torch.ops.kernels import _build

    if "--recipe-bisect" not in args:
        print("usage: chip_smoke.py [--recipe-bisect [--deterministic] "
              "lamb|adamw|adam ...]", file=sys.stderr)
        return 2
    _build.build_all()
    for name in [a for a in args if not a.startswith("--")]:
        recipe_bisect(name, deterministic="--deterministic" in args)
    return 0


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "needs a CUDA GPU", file=sys.stderr)
        return 1
    # the port comes from the checkout beside this file; without it the
    # import fails here, before anything is printed
    from paddle_tpu_torch.ops.kernels import _build

    # float32 products stay full float32 on the card (no TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    SMI[0] = smi
    if sys.argv[1:]:
        return diagnose(sys.argv[1:])
    emit("device", nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, device=torch.cuda.get_device_name(0))
    t0 = time.perf_counter()
    secs = _build.build_all()
    emit("build", seconds=time.perf_counter() - t0, kernels=secs)
    dev = torch.device("cuda", torch.cuda.current_device())
    phase_s = {}

    def timed(fn, *args, **kw):
        t = time.perf_counter()
        n_opt = len(OPT_LOG)
        out = fn(*args, **kw)
        name = fn.__name__ + ("_amp" if kw.get("amp") else "")
        phase_s[name] = phase_s.get(name, 0.0) + time.perf_counter() - t
        # op counts at level 0 and 1 of each program the phase ran
        emit("pipeline_ops", of=name, programs=OPT_LOG[n_opt:])
        return out

    record_pipeline()
    row = timed(kernel_phase, dev)
    xent_rows = timed(xent_kernel_phase, dev)
    flash_rows = timed(flash_kernel_phase, dev)
    k4_rows, k2_ctr = timed(sparse_kernel_phase, dev)
    timed(ctr_train_phase, k4_rows, xent_rows, k2_ctr)
    timed(ctr_parity_phase)
    timed(serve_phase, row)
    timed(train_phase, xent_rows)
    timed(train_phase, xent_rows, amp=True)
    timed(train_parity_phase)
    timed(longctx_train_phase, flash_rows, amp=False)
    timed(longctx_train_phase, flash_rows, amp=True)
    timed(longctx_parity_phase)
    timed(resnet_train_phase, xent_rows, amp=False)
    timed(resnet_train_phase, xent_rows, amp=True)
    timed(resnet_parity_phase)
    timed(qat_resnet50_phase, xent_rows)
    timed(mnist_train_phase, xent_rows)
    timed(vgg_train_phase, xent_rows, amp=False)
    timed(vgg_train_phase, xent_rows, amp=True)
    timed(se_resnext_train_phase, xent_rows, amp=False)
    timed(se_resnext_train_phase, xent_rows, amp=True)
    timed(lars_train_phase)
    timed(word2vec_train_phase, xent_rows)
    timed(conv_family_phase)
    timed(zoo_parity_phase)
    timed(unfused_train_phase, xent_rows)
    timed(unfused_flash_phase, flash_rows)
    timed(flash_dropout_captured_phase, flash_rows)
    timed(accum_train_phase, xent_rows)
    timed(transformer_noam_train_phase, xent_rows)
    timed(dist_transformer_train_phase, xent_rows)
    with tempfile.TemporaryDirectory() as ckpt:
        timed(bert_train_phase, xent_rows, amp=True, ckpt_dir=ckpt)
        timed(bert_train_phase, xent_rows, amp=False)
        timed(checkpoint_resume_phase, xent_rows)
        infer = timed(bert_infer_phase, ckpt)
    pred = timed(bert_predictor_phase, infer)
    timed(export_bert_phase, infer, pred)
    del infer, pred
    timed(bert_parity_phase)
    timed(lookup_determinism, dev)
    timed(bert_recipe_train_phase, xent_rows)
    timed(optimizer_parity_phase)
    timed(dense_ops_phase)
    timed(input_pipeline_phase, k4_rows, xent_rows)
    timed(sequence_models_phase, xent_rows, k4_rows)
    timed(control_flow_phase, xent_rows)
    timed(op_remainder_phase, k4_rows)
    timed(op_harness_phase)
    timed(detection_phase, xent_rows)
    # the card again, so the end of a long log still names it
    emit("phase_seconds", nvidia_smi=smi, total=time.perf_counter() - t0,
         **phase_s)
    print(json.dumps({"kernels": [row] + xent_rows + flash_rows + k4_rows}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
