"""Models of the port: the serving workload's decoder LM, the
Transformer / BERT / causal-LM program functions and the DeepFM CTR
program function."""

from . import decoder_lm, deepfm, transformer  # noqa: F401
