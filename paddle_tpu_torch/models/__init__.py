"""Models of the port: the serving workload's decoder LM and the
Transformer / BERT / causal-LM program functions."""

from . import decoder_lm, transformer  # noqa: F401
