"""paddle_tpu_torch: the PyTorch and CUDA port of ``paddle_tpu``.

The JAX package stays the reference; this package runs the same system on
an NVIDIA GPU, slice by slice. It imports ``torch`` and ``numpy``, never
``jax`` and nothing of ``paddle_tpu``. Entry points run on the card unless
the caller asks for the CPU (``device="cpu"``, ``CPUPlace()``), and raise
when asked for the card on a machine without one.

Ported so far:

* the serving path — :mod:`.models.decoder_lm`, the paged KV cache and the
  continuous-batching engine (:mod:`.serving`), whose decode attention runs
  through a hand-written CUDA kernel (:mod:`.ops.kernels.paged_attention`);
* Fluid's static-graph training surface — ``Program``, :mod:`.layers`,
  :mod:`.optimizer` and :class:`Executor` — for the Transformer, whose
  softmax cross-entropy runs through a hand-written CUDA kernel pair
  (:mod:`.ops.kernels.softmax_xent`), and for the long-context causal LM,
  whose attention runs through three hand-written flash-attention kernels
  (:mod:`.ops.kernels.flash_attention`), in float32 or under
  :mod:`.amp` (bfloat16 forward and backward, float32 master weights);
  CTR training (:mod:`.models.deepfm`), vision training
  (:mod:`.models.resnet`, :mod:`.models.mnist`, :mod:`.models.vgg`,
  :mod:`.models.se_resnext`, with :mod:`.nets`), the word2vec N-gram
  model (:mod:`.models.word2vec`) and BERT pretraining and inference
  (:mod:`.models.bert`);
* the model files of :mod:`.io` (``save_inference_model``,
  ``load_inference_model``, ``save_params``, ...), the JAX package's
  files name for name, and the :mod:`.inference` ``Predictor`` that runs a
  saved model.
* the captured step: :class:`CompiledProgram` and
  ``Executor.run_steps`` warm a program's step up, capture it into a
  CUDA graph and replay it (:mod:`.compiler`, :mod:`.executor`), with
  gradient accumulation (``BuildStrategy.gradient_accumulation_steps``);
* the Program-pass pipeline (:mod:`.passes`, :mod:`.core.pass_framework`,
  ``conv_bn_fuse_pass`` in :mod:`.transpiler`) that the Executor runs on
  every program, which rewrites primitive-built attention
  (``FLAGS_unfused_attention``) and ``softmax`` + ``cross_entropy`` back
  onto the fused ops and their kernels.
* the input pipeline: the reader decorators, ``py_reader`` and the
  side-stream ``DevicePrefetcher`` (:mod:`.reader`), the synthetic
  :mod:`.dataset` readers, :class:`DataFeeder`, the checkpointable and
  MultiSlot CTR readers (:mod:`.data`), :class:`AsyncExecutor` with
  :class:`DataFeedDesc`, and the :mod:`.metrics` accumulators.
* control flow (``layers.While``, ``cond``, ``Switch``, ``IfElse``,
  ``StaticRNN``, ``DynamicRNN``), the tensor arrays and the batched beam
  search (:mod:`.layers.beam_search`, re-exported by
  :mod:`.contrib.decoder`).
* the model's lifecycle: rotating checkpoints (``io.save_checkpoint``,
  ``load_checkpoint``), record files (:mod:`.recordio`, over the port's
  own C++ library in :mod:`.native`), :class:`ParallelExecutor`, the
  transpilers, :mod:`.debugger`, ``inference.export_program``
  (``torch.export``), the per-op harness (:mod:`.testing`) and
  quantization: the fake-quant ops, ``contrib.QuantizeTranspiler``,
  ``contrib.slim`` and the int8 ``contrib.Calibrator``.
* detection (the ops of :mod:`.ops.detection_ops` and the layers of
  :mod:`.layers.detection`: priors, matching, NMS, the RoI ops,
  ``yolov3_loss``, the two-stage samplers, ``detection_map``) and
  dygraph (:mod:`.imperative`: eager ops on torch's autograd, ``jit``
  and ``jit_train`` as CUDA graphs).

A Fluid script runs unchanged with::

    import paddle_tpu_torch as fluid
"""

from . import (  # noqa: F401
    amp,
    contrib,
    data,
    dataset,
    debugger,
    evaluator,
    imperative,
    initializer,
    io,
    layers,
    metrics,
    models,
    nets,
    optimizer,
    passes,
    reader,
    serving,
    transpiler,
)
from .async_executor import AsyncExecutor  # noqa: F401
from .data_feed_desc import DataFeedDesc  # noqa: F401
from .data_feeder import DataFeeder  # noqa: F401
from .backward import append_backward, calc_gradient, gradients  # noqa: F401
from .compiler import (BuildStrategy, CompiledProgram,  # noqa: F401
                       ExecutionStrategy)
from .core import unique_name  # noqa: F401
from .core.pass_framework import (  # noqa: F401
    Pass,
    PassBuilder,
    get_pass,
    register_pass,
    registered_passes,
)
from .core.framework import (  # noqa: F401
    Program,
    Variable,
    default_main_program,
    default_startup_program,
    name_scope,
    program_guard,
    test_mode,
)
from .core.place import CPUPlace, CUDAPinnedPlace, CUDAPlace, TPUPlace  # noqa: F401
from .core.scope import Scope, global_scope, scope_guard  # noqa: F401
from .executor import Executor, FetchHandle  # noqa: F401
from .parallel_executor import ParallelExecutor  # noqa: F401
from .reader.py_reader import EOFException  # noqa: F401
from .flags import flags, get_flag, set_flag  # noqa: F401
from .layers.layer_helper import ParamAttr, WeightNormParamAttr  # noqa: F401

__all__ = ["serving", "models", "CUDAPlace", "CPUPlace", "TPUPlace",
           "CUDAPinnedPlace", "FetchHandle",
           "Program", "Variable", "program_guard", "default_main_program",
           "default_startup_program", "name_scope", "test_mode", "layers", "nets",
           "optimizer", "initializer", "io", "Executor", "Scope",
           "scope_guard", "global_scope", "unique_name", "ParamAttr",
           "WeightNormParamAttr", "amp", "flags", "get_flag", "set_flag",
           "append_backward", "gradients", "calc_gradient",
           "CompiledProgram", "BuildStrategy", "ExecutionStrategy",
           "passes", "transpiler", "Pass", "PassBuilder", "get_pass",
           "register_pass", "registered_passes", "reader", "dataset",
           "metrics", "evaluator", "data", "DataFeeder", "AsyncExecutor",
           "DataFeedDesc", "EOFException", "ParallelExecutor", "contrib",
           "debugger", "imperative"]
