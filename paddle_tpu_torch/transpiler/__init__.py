# ported from paddle_tpu/transpiler/__init__.py
"""Program transpilers: the inference fusion pass ``conv_bn_fuse_pass``
(:mod:`.fuse_passes`, which importing this package registers),
:class:`InferenceTranspiler`, and the script-compatibility shims
:class:`DistributeTranspiler`, ``memory_optimize`` and ``release_memory``."""

from .distribute_transpiler import DistributeTranspiler, DistributeTranspilerConfig  # noqa: F401
from .fuse_passes import ConvBNFusePass  # noqa: F401
from .memory_optimization import memory_optimize, release_memory  # noqa: F401


class InferenceTranspiler:
    """reference: transpiler/inference_transpiler.py — pre-deploy program
    rewrites. ``transpile`` runs the conv + batch-norm weight fold
    (``conv_bn_fuse_pass``) with the scope's parameter values (the global
    scope by default), in torch on the tensors' device."""

    def transpile(self, program, place=None, scope=None):
        if scope is None:
            from ..core.scope import global_scope

            scope = global_scope()
        from ..core.pass_framework import get_pass

        return get_pass("conv_bn_fuse_pass").set_attr("scope", scope).apply(program)


__all__ = [
    "ConvBNFusePass",
    "DistributeTranspiler",
    "DistributeTranspilerConfig",
    "InferenceTranspiler",
    "memory_optimize",
    "release_memory",
]
