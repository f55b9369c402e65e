# ported from paddle_tpu/contrib/decoder/__init__.py
"""Seq2seq decoding helpers (reference: contrib/decoder/beam_search_decoder.py).

The reference builds decoding from StateCell/TrainingDecoder/
BeamSearchDecoder classes over LoD beam ops. Here, as in the JAX package,
decoding is the batched beam machinery in
``paddle_tpu_torch.layers.beam_search`` (fixed-capacity TensorArray +
While-loop decode); this namespace re-exports it under the contrib path
for API discovery parity.
"""

from ...layers.beam_search import (  # noqa: F401
    array_length,
    array_read,
    array_to_tensor,
    array_write,
    beam_search,
    beam_search_decode,
    create_array,
)

__all__ = ["beam_search", "beam_search_decode", "create_array", "array_write",
           "array_read", "array_length", "array_to_tensor"]
