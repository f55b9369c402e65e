# ported from paddle_tpu/transpiler/__init__.py
"""Program transpilers: of the JAX package's module only the inference
fusion pass ``conv_bn_fuse_pass`` (:mod:`.fuse_passes`), which importing
this package registers. The distribute and memory transpilers and
``InferenceTranspiler`` are not ported."""

from .fuse_passes import ConvBNFusePass  # noqa: F401

__all__ = ["ConvBNFusePass"]
