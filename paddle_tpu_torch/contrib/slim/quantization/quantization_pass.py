# ported from paddle_tpu/contrib/slim/quantization/quantization_pass.py
"""Quantization passes on the Program-pass framework (reference:
contrib/slim/quantization/quantization_pass.py — QuantizationTransformPass,
QuantizationFreezePass, ConvertToInt8Pass over IrGraph).

Our IR is the Program itself, so each pass is a registered
``core.pass_framework.Pass`` applying the corresponding phase of the
QuantizeTranspiler (contrib/quantize/quantize_transpiler.py) — same
rewrites, composable in a PassBuilder pipeline alongside user passes.
"""

from __future__ import annotations

from ....core.pass_framework import Pass, register_pass
from ...quantize.quantize_transpiler import QuantizeTranspiler

__all__ = ["QuantizationTransformPass", "QuantizationFreezePass",
           "ConvertToInt8Pass"]


@register_pass("quantization_transform_pass")
class QuantizationTransformPass(Pass):
    """Insert fake quant/dequant around quantizable ops (QAT training phase)."""

    def __init__(self, scope=None, place=None, weight_bits=8, activation_bits=8,
                 activation_quantize_type="abs_max",
                 weight_quantize_type="abs_max", window_size=10000,
                 moving_rate=0.9):
        super().__init__()
        self._t = QuantizeTranspiler(
            weight_bits=weight_bits, activation_bits=activation_bits,
            activation_quantize_type=activation_quantize_type,
            weight_quantize_type=weight_quantize_type,
            window_size=window_size, moving_rate=moving_rate)
        if scope is not None:
            self.set_attr("scope", scope)
        if place is not None:
            self.set_attr("place", place)

    def apply(self, program, startup_program=None):  # reference signature
        if startup_program is not None:
            # explicit arg wins, but only for THIS apply: a startup program
            # pairs with one main program, so letting it persist would
            # inject a later program's scale initializers into the wrong
            # startup. An attr set via set_attr (the only channel through
            # PassBuilder.apply_all, which calls apply(program) bare) is a
            # deliberate standing pairing and survives.
            had_prior = self.has_attr("startup_program")
            prior = self._attrs.get("startup_program")
            self.set_attr("startup_program", startup_program)
            try:
                return super().apply(program)
            finally:
                if had_prior:
                    self._attrs["startup_program"] = prior
                else:
                    self._attrs.pop("startup_program", None)
        return super().apply(program)

    def apply_impl(self, program):
        startup = (self.attr("startup_program")
                   if self.has_attr("startup_program") else None)
        return self._t.training_transpile(program, startup)


@register_pass("quantization_freeze_pass")
class QuantizationFreezePass(Pass):
    """Fold trained quant scales into inference-time quantize ops."""

    def __init__(self, scope=None, place=None, weight_bits=8, activation_bits=8,
                 weight_quantize_type="abs_max"):
        super().__init__()
        self._t = QuantizeTranspiler(
            weight_bits=weight_bits, activation_bits=activation_bits,
            weight_quantize_type=weight_quantize_type)
        if scope is not None:
            self.set_attr("scope", scope)
        if place is not None:
            self.set_attr("place", place)

    def apply_impl(self, program):
        return self._t.freeze_program(program, self.attr("place"),
                                      self.attr("scope"))


@register_pass("convert_to_int8_pass")
class ConvertToInt8Pass(Pass):
    """Store weights as int8 for the frozen inference program. The program
    is returned unchanged; the converted names are :attr:`converted`. (The
    JAX package's pass returns the name list from ``apply_impl``, which
    ``Pass.apply`` then takes for the program and fails on.)"""

    def __init__(self, scope=None, place=None):
        super().__init__()
        self._t = QuantizeTranspiler()
        self.converted = []
        if scope is not None:
            self.set_attr("scope", scope)
        if place is not None:
            self.set_attr("place", place)

    def apply_impl(self, program):
        self.converted = self._t.convert_to_int8(program, self.attr("place"),
                                                 self.attr("scope"))
        return program
