# ported from paddle_tpu/inference/__init__.py
"""The inference entry point: a model saved by
``io.save_inference_model`` (by this package or the JAX package) loads
into a :class:`Predictor`, which runs it on the card unless its
:class:`AnalysisConfig` asks for the CPU. The JAX package's StableHLO
export (``export_stablehlo``/``load_stablehlo``) is not ported: its
artifact is JAX's."""

from .predictor import AnalysisConfig, Predictor, create_predictor  # noqa: F401
