# ported from paddle_tpu/inference/__init__.py
"""The inference entry points: a model saved by
``io.save_inference_model`` (by this package or the JAX package) loads
into a :class:`Predictor`, which runs it on the card unless its
:class:`AnalysisConfig` asks for the CPU; :func:`export_program` writes a
program's feed→fetch function as one ``torch.export`` artifact and
:func:`load_program` runs it. The JAX package's ``export_stablehlo`` and
``load_stablehlo`` are JAX's own (StableHLO); :mod:`.export` is their
counterpart, with the same arguments."""

from .predictor import AnalysisConfig, Predictor, create_predictor  # noqa: F401
from .export import export_program, load_program  # noqa: F401
