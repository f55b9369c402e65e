# ported from paddle_tpu/models/bert.py
"""Named BERT configs over the encoder in models/transformer.py.

Reference workload: BERT-base in
inference/tests/api/analyzer_bert_tester.cc and the BASELINE.json bert
entry. ``bert_base``/``bert_large`` pin the canonical hyperparameters;
``bert_tiny`` is the test-scale config used by the pretrain convergence
test.
"""

from __future__ import annotations

from .transformer import bert_encoder, bert_pretrain

__all__ = ["BERT_BASE_CONFIG", "BERT_LARGE_CONFIG", "bert_base", "bert_large",
           "bert_tiny", "bert_pretrain"]

BERT_BASE_CONFIG = dict(vocab_size=30522, max_position=512, type_vocab_size=2,
                        n_layer=12, n_head=12, d_model=768, d_inner=3072)
BERT_LARGE_CONFIG = dict(vocab_size=30522, max_position=512, type_vocab_size=2,
                         n_layer=24, n_head=16, d_model=1024, d_inner=4096)
BERT_TINY_CONFIG = dict(vocab_size=64, max_position=32, type_vocab_size=2,
                        n_layer=2, n_head=2, d_model=32, d_inner=64)


def bert_base(input_ids, pos_ids, sent_ids, input_mask, **overrides):
    cfg = dict(BERT_BASE_CONFIG, **overrides)
    return bert_encoder(input_ids, pos_ids, sent_ids, input_mask, **cfg)


def bert_large(input_ids, pos_ids, sent_ids, input_mask, **overrides):
    cfg = dict(BERT_LARGE_CONFIG, **overrides)
    return bert_encoder(input_ids, pos_ids, sent_ids, input_mask, **cfg)


def bert_tiny(input_ids, pos_ids, sent_ids, input_mask, **overrides):
    cfg = dict(BERT_TINY_CONFIG, **overrides)
    return bert_encoder(input_ids, pos_ids, sent_ids, input_mask, **cfg)
