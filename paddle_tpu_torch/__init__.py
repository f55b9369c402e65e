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
  (:mod:`.ops.kernels.softmax_xent`). A Fluid script runs unchanged with::

      import paddle_tpu_torch as fluid
"""

from . import (  # noqa: F401
    initializer,
    io,
    layers,
    models,
    optimizer,
    serving,
)
from .core import unique_name  # noqa: F401
from .core.framework import (  # noqa: F401
    Program,
    default_main_program,
    default_startup_program,
    program_guard,
)
from .core.place import CPUPlace, CUDAPlace  # noqa: F401
from .core.scope import Scope, global_scope, scope_guard  # noqa: F401
from .executor import Executor  # noqa: F401
from .layers.layer_helper import ParamAttr  # noqa: F401

__all__ = ["serving", "models", "CUDAPlace", "CPUPlace", "Program",
           "program_guard", "default_main_program", "default_startup_program",
           "layers", "optimizer", "initializer", "io", "Executor", "Scope",
           "scope_guard", "global_scope", "unique_name", "ParamAttr"]
