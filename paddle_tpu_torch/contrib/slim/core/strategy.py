# ported from paddle_tpu/contrib/slim/core/strategy.py
"""Compression strategy base (reference: contrib/slim/core/strategy.py) —
epoch/batch lifecycle callbacks driven by the Compressor."""

__all__ = ["Strategy"]


class Strategy:
    def __init__(self, start_epoch=0, end_epoch=10):
        self.start_epoch = start_epoch
        self.end_epoch = end_epoch

    def on_compress_begin(self, context):
        pass

    def on_epoch_begin(self, context):
        pass

    def on_epoch_end(self, context):
        pass

    def on_batch_begin(self, context):
        pass

    def on_batch_end(self, context):
        pass

    def on_compress_end(self, context):
        pass
