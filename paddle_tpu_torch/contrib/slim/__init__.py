# ported from paddle_tpu/contrib/slim/__init__.py
"""Model-compression namespace (reference: contrib/slim/ — quantization,
pruning, distillation behind a Compressor config).

Quantization delegates to the QuantizeTranspiler machinery over Program IR
via registered framework passes; pruning computes numpy masks on host
copies of the scope's values and writes the pruned tensors back on their
device (no mask programs); distillation losses are layer compositions. The Compressor (core/) drives Strategy callbacks per
epoch/batch like the reference CompressPass.
"""

from . import distillation, quantization  # noqa: F401
from .core import CompressPass, Context, Strategy, build_compressor  # noqa: F401
from .graph import Graph, ImitationGraph  # noqa: F401
from .prune import (  # noqa: F401
    MagnitudePruner,
    PruneStrategy,
    Pruner,
    RatioPruner,
    SensitivePruneStrategy,
)
