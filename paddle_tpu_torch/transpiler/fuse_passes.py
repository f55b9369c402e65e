# ported from paddle_tpu/transpiler/fuse_passes.py
"""Inference-time fusion passes on the Program-pass framework.

Reference: ``framework/ir/conv_bn_fuse_pass.cc`` (+ its tester pattern,
``ir/fc_fuse_pass_tester.cc``: build a tiny program, apply, assert fused
node counts). Folding W' = W·γ/√(σ²+ε), b' = β + (b−μ)·γ/√(σ²+ε) removes the
BN op and its four parameter reads entirely: the batch norm's passes over
the activation (~35 torch launches each in the port) leave the step. The
fold runs in torch on the scope's tensors, on their device.

Only valid for inference programs (BN in global-stats mode): the pass
requires the op to run with ``is_test``/``use_global_stats`` semantics.

Folded values land in FRESH scope vars (``<w>.bn_fused``) and the conv is
re-pointed at them; the original parameters are never overwritten. That
makes the pass safe to re-apply from a clone of the original program over
the same scope (the default optimizer pipeline does exactly that per fetch
set) — a re-application recomputes the same fold from the same untouched
inputs instead of compounding it. A second application to an already-fused
program is a structural no-op (no ``batch_norm`` ops remain).
"""

from __future__ import annotations

import torch

from ..core.dtypes import convert_dtype
from ..core.pass_framework import Pass, register_pass

__all__ = ["ConvBNFusePass"]


@register_pass("conv_bn_fuse_pass")
class ConvBNFusePass(Pass):
    """Fold batch_norm into the preceding conv2d's weights.

    Requires attrs:
      - ``scope``: the Scope holding parameter values (weights are folded
        numerically, like the reference InferenceTranspiler).
    Matches: conv2d → [elementwise_add bias] → batch_norm, where each
    intermediate is consumed only by the next op in the chain.
    """

    def apply_impl(self, program):
        scope = self.attr("scope")
        if scope is None:
            raise ValueError(
                "conv_bn_fuse_pass needs set_attr('scope', scope) — weight "
                "folding reads/writes parameter values")
        # shared graph maps (passes/analysis.py): one linear scan each
        # instead of the old per-candidate O(n) rescan (O(n^2) over a deep
        # resnet), rebuilt after each (rare) fuse — and use_counts also sees
        # sub-block/attr readers, so a var a while-body consumes is never
        # mistaken for single-consumer
        from ..passes import analysis as A

        block = program.global_block
        ops = block.ops
        uses = A.use_counts(program)
        prod = A.producer_map(block)

        def _materialize_param(name, value):
            """Materialize a folded value under a NEW deterministic name;
            the original param is left untouched (re-apply safety)."""
            if not block.has_var(name):
                block.create_parameter(
                    name=name, shape=[int(s) for s in value.shape],
                    dtype=convert_dtype(value.dtype), trainable=False,
                    persistable=True)
            scope.set_var(name, value)
            return name

        fused = 0
        replaced = []  # original param names the fuse may have orphaned
        # scope objects the fold derived values from: maybe_optimize checks
        # these by identity on every memo hit, so a checkpoint load or a
        # train-step weight update (new array objects) forces a re-fold
        # instead of silently serving stale fused weights
        fold_sources = getattr(program, "_fold_sources", None) or {}
        i = 0
        while i < len(ops):
            bn = ops[i]
            if bn.type != "batch_norm":
                i += 1
                continue
            if not (bn.attrs.get("is_test") or bn.attrs.get("use_global_stats")):
                i += 1
                continue
            x_name = bn.inputs["X"][0]
            producer = prod.get(x_name)
            if producer is None or uses.get(x_name, 0) != 1:
                i += 1
                continue
            bias_op = None
            if producer.type == "elementwise_add":
                bias_op = producer
                conv_out = bias_op.inputs["X"][0]
                conv = prod.get(conv_out)
                if (conv is None or conv.type != "conv2d"
                        or conv_out not in conv.outputs.get("Output", ())
                        or uses.get(conv_out, 0) != 1):
                    i += 1
                    continue
                # the add must be a per-channel BIAS, not a residual/shortcut
                # or spatial-broadcast add: Y is a 1-D scope-resident var of
                # length C, broadcast on the channel axis (axis=1 for NCHW)
                y_var = block._find_var_recursive(bias_op.inputs["Y"][0])
                w_var = block._find_var_recursive(conv.inputs["Filter"][0])
                out_c = (w_var.shape[0] if w_var is not None
                         and w_var.shape else None)
                if (y_var is None or y_var.shape is None
                        or len(y_var.shape) != 1
                        or y_var.shape[0] != out_c
                        or bias_op.attrs.get("axis", -1) != 1
                        or scope.find_var(bias_op.inputs["Y"][0]) is None):
                    i += 1
                    continue
            elif producer.type == "conv2d":
                conv = producer
            else:
                i += 1
                continue

            w_name = conv.inputs["Filter"][0]
            src_names = (bn.inputs["Scale"][0], bn.inputs["Bias"][0],
                         bn.inputs["Mean"][0], bn.inputs["Variance"][0],
                         w_name)
            vals = [scope.find_var(n) for n in src_names]
            if any(v is None for v in vals):
                # parameters not materialized (e.g. transpile before startup
                # ran) — leave this candidate alone rather than crash
                i += 1
                continue
            fold_sources.update(zip(src_names, vals))
            gamma, beta, mu, var, w = (torch.as_tensor(v) for v in vals)
            eps = float(bn.attrs.get("epsilon", 1e-5))
            inv_std = gamma / torch.sqrt(var + eps)

            w_fused = _materialize_param(
                w_name + ".bn_fused",
                (w * inv_std.reshape(-1, 1, 1, 1)).to(w.dtype))
            conv.inputs["Filter"] = [w_fused]
            replaced.append(w_name)
            replaced.extend(bn.inputs[s][0]
                            for s in ("Scale", "Bias", "Mean", "Variance"))
            bn_y = bn.outputs["Y"][0]
            if bias_op is not None:
                b_name = bias_op.inputs["Y"][0]
                b_obj = scope.find_var(b_name)
                fold_sources[b_name] = b_obj
                b = torch.as_tensor(b_obj)
                b_fused = _materialize_param(
                    b_name + ".bn_fused",
                    (beta + (b - mu) * inv_std).to(b.dtype))
                bias_op.inputs["Y"] = [b_fused]
                bias_op.outputs["Out"] = [bn_y]
                replaced.append(b_name)
            else:
                # conv had no bias: the folded β − μ·γ/√(σ²+ε) becomes one,
                # written straight into the scope (inference programs don't
                # re-run startup).
                b_name = _materialize_param(
                    w_name + ".bn_fold_bias",
                    (beta - mu * inv_std).to(beta.dtype))
                bias_var = block.var(b_name)
                idx = ops.index(bn)
                block.insert_op(
                    idx, "elementwise_add",
                    inputs={"X": conv.outputs["Output"][0], "Y": bias_var},
                    outputs={"Out": bn_y}, attrs={"axis": 1})
            block.remove_op(ops.index(bn))
            fused += 1
            uses = A.use_counts(program)
            prod = A.producer_map(block)

        if fused:
            program._fold_sources = fold_sources
            # demote originals nothing reads anymore: they leave the
            # persistable state set (no doubled conv weights in HBM) and
            # dead-var elimination may then drop them from the symbol table.
            # Scope values are untouched — a re-apply from a fresh clone of
            # the ORIGINAL program still folds from pristine inputs.
            all_uses = A.use_counts(program)
            for name in replaced:
                if all_uses.get(name, 0) == 0:
                    v = block._find_var_recursive(name)
                    if v is not None:
                        v.persistable = False
        self.set_attr("fused_count", fused)
        return program
