# ported from paddle_tpu/passes/fuse_patterns.py
"""Fused-kernel pattern rewrites: primitive compositions onto the fused ops.

(a) ``softmax`` followed by ``cross_entropy`` -> ``softmax_with_cross_entropy``,
whose log-softmax formulation avoids the exp-then-log round trip and which
runs the fused softmax cross-entropy kernels K2a/K2b on the card
(``ops/kernels/softmax_xent.py``); (b) an O(S^2)-materializing attention
composition -> the ``scaled_dot_product_attention`` op, which takes the
flash-attention kernels K1a-c from ``FLAGS_flash_attention_min_seq`` up
(``ops/kernels/flash_attention.py``). Both rewrites run in the default
pipeline, so Fluid-style scripts written against primitives reach the
hand-written kernels without opting in, as in the JAX package.

Matched attention shape (the classic dist_transformer composition)::

    scores = matmul(Q, K, transpose_y=True[, alpha])   # [B,H,Sq,Sk]
    scores = scale(scores, s)                          # optional
    scores = elementwise_add(scores, bias)             # optional
    probs  = softmax(scores, axis=-1)
    probs  = dropout(probs, upscale_in_train)          # optional
    out    = matmul(probs, V)

Every intermediate must have exactly one consumer and not be fetched;
Q/K/V must be rank-4. Causal compositions (masking via tril constants)
are NOT matched — use the fused layer for causal attention.
"""

from __future__ import annotations

from ..core.framework import Operator
from ..core.pass_framework import Pass, register_pass
from . import analysis as A

__all__ = ["SoftmaxXentFusePass", "FlashAttentionRewritePass"]


def _single_consumer(name, uses, protected):
    return uses.get(name, 0) == 1 and name not in protected


@register_pass("softmax_xent_fuse_pass")
class SoftmaxXentFusePass(Pass):
    """``softmax`` + ``cross_entropy`` -> ``softmax_with_cross_entropy``.

    The softmax op is removed only when the loss op was its sole consumer;
    if its probabilities are observed elsewhere (fetched predictions), the
    loss is still fused on the logits and the softmax op stays. Reports
    ``rewrites_matched``.
    """

    def apply_impl(self, program):
        block = program.global_block
        protected = set(self.attr("protected") or ())
        protected |= A.protected_names(program)
        uses = A.use_counts(program)
        prod = A.producer_map(block)

        matched = 0
        i = 0
        while i < len(block.ops):
            xent = block.ops[i]
            if xent.type != "cross_entropy" or A.is_opaque(xent):
                i += 1
                continue
            probs_name = (xent.input("X") or [None])[0]
            label_name = (xent.input("Label") or [None])[0]
            sm = prod.get(probs_name)
            if (sm is None or sm.type != "softmax"
                    or probs_name is None or label_name is None):
                i += 1
                continue
            axis = sm.attr("axis", -1)
            x_var = block._find_var_recursive(sm.input("X")[0])
            ndim = len(x_var.shape) if (x_var is not None
                                        and x_var.shape is not None) else None
            if axis != -1 and (ndim is None or axis != ndim - 1):
                i += 1
                continue

            fused = Operator(
                block, "softmax_with_cross_entropy",
                inputs={"Logits": sm.input("X"), "Label": [label_name]},
                outputs={"Loss": xent.output("Y")},
                attrs={"soft_label": xent.attr("soft_label", False),
                       "ignore_index": xent.attr("ignore_index", -100)})
            block.ops[i] = fused
            # when the loss was the probabilities' only observer the softmax
            # op goes too; otherwise (fetched predictions) it stays and
            # keeps defining the var
            if _single_consumer(probs_name, uses, protected):
                block.ops.remove(sm)
                i -= 1  # the list shifted left past the removed softmax
            program._version += 1
            matched += 1
            # producer/use maps shifted; rebuild (rewrites are rare)
            uses = A.use_counts(program)
            prod = A.producer_map(block)
            i += 1

        if matched:
            A.prune_dead_vars(program, extra_keep=protected)
        self.set_attr("rewrites_matched", matched)
        return program


def _rank4(block, name):
    v = block._find_var_recursive(name)
    return (v is not None and v.shape is not None and len(v.shape) == 4)


@register_pass("flash_attention_rewrite")
class FlashAttentionRewritePass(Pass):
    """Unfused QKV attention composition -> ``scaled_dot_product_attention``
    (the fused layer's op: the flash kernels from
    ``FLAGS_flash_attention_min_seq`` up, with O(S) residuals instead of the
    matmul-materialized [B,H,S,S] probs; composed einsums below).

    Reports ``rewrites_matched``. A consumed ``dropout``'s PRNG slot is
    transplanted onto the fused op so repeated optimizations of the same
    source program stay deterministic.
    """

    def apply_impl(self, program):
        block = program.global_block
        protected = set(self.attr("protected") or ())
        protected |= A.protected_names(program)

        matched = 0
        changed = True
        while changed:
            changed = False
            uses = A.use_counts(program)
            prod = A.producer_map(block)
            for sm in list(block.ops):
                if sm.type != "softmax":
                    continue
                plan = self._match(block, sm, uses, prod, protected)
                if plan is None:
                    continue
                self._rewrite(block, plan)
                program._version += 1
                matched += 1
                changed = True
                break  # maps are stale; rescan

        if matched:
            A.prune_dead_vars(program, extra_keep=protected)
        self.set_attr("rewrites_matched", matched)
        return program

    # -- matching -------------------------------------------------------------
    def _match(self, block, sm, uses, prod, protected):
        if sm.attr("axis", -1) not in (-1, 3):
            return None
        probs_name = sm.output("Out")[0]

        # ---- upstream: [matmul -> scale? -> add-bias?] ----
        cur = sm.input("X")[0]
        sm_scale = 1.0
        bias = None
        removable = [sm]
        add = prod.get(cur)
        if add is not None and add.type == "elementwise_add" \
                and add.attr("axis", -1) in (-1,):
            y = (add.input("Y") or [None])[0]
            if y is not None and _rank4(block, y):
                if not _single_consumer(cur, uses, protected):
                    return None
                bias = y
                removable.append(add)
                cur = add.input("X")[0]
        sc = prod.get(cur)
        if sc is not None and sc.type == "scale":
            if float(sc.attr("bias", 0.0)) == 0.0:
                if not _single_consumer(cur, uses, protected):
                    return None
                sm_scale *= float(sc.attr("scale", 1.0))
                removable.append(sc)
                cur = sc.input("X")[0]
        mm1 = prod.get(cur)
        if (mm1 is None or mm1.type != "matmul"
                or mm1.attr("transpose_X", False)
                or not mm1.attr("transpose_Y", False)
                or not _single_consumer(cur, uses, protected)):
            return None
        sm_scale *= float(mm1.attr("alpha", 1.0))
        q_name, k_name = mm1.input("X")[0], mm1.input("Y")[0]
        if not (_rank4(block, q_name) and _rank4(block, k_name)):
            return None
        removable.append(mm1)

        # ---- downstream: [dropout?] -> matmul(probs, V) ----
        dropout_rate = 0.0
        is_test_attr = None
        rng_slot = None
        cur_out = probs_name
        nxt = self._sole_consumer(block, cur_out, uses, protected)
        drop = None
        if nxt is not None and nxt.type == "dropout":
            if nxt.attr("dropout_implementation") != "upscale_in_train":
                return None
            mask = nxt.output("Mask")
            if mask and uses.get(mask[0], 0):
                return None
            if mask and mask[0] in protected:
                return None
            drop = nxt
            dropout_rate = float(nxt.attr("dropout_prob", 0.0))
            is_test_attr = nxt.attr("is_test")
            rng_slot = nxt.attr("__rng_slot__")
            cur_out = nxt.output("Out")[0]
            nxt = self._sole_consumer(block, cur_out, uses, protected)
        if (nxt is None or nxt.type != "matmul"
                or nxt.attr("transpose_X", False)
                or nxt.attr("transpose_Y", False)
                or float(nxt.attr("alpha", 1.0)) != 1.0
                or (nxt.input("X") or [None])[0] != cur_out):
            return None
        v_name = nxt.input("Y")[0]
        if not _rank4(block, v_name):
            return None
        if drop is not None:
            removable.append(drop)
        mm2 = nxt

        return {
            "q": q_name, "k": k_name, "v": v_name, "bias": bias,
            "sm_scale": sm_scale, "dropout_rate": dropout_rate,
            "is_test": is_test_attr, "rng_slot": rng_slot,
            "out": mm2.output("Out")[0],
            "removable": removable, "mm2": mm2,
        }

    @staticmethod
    def _sole_consumer(block, name, uses, protected):
        if not _single_consumer(name, uses, protected):
            return None
        for op in block.ops:
            if any(name in ns for ns in op.inputs.values()):
                return op
        return None

    # -- rewriting ------------------------------------------------------------
    def _rewrite(self, block, plan):
        inputs = {"Q": [plan["q"]], "K": [plan["k"]], "V": [plan["v"]]}
        if plan["bias"] is not None:
            inputs["Bias"] = [plan["bias"]]
        attrs = {"causal": False, "sm_scale": float(plan["sm_scale"]),
                 "dropout_rate": float(plan["dropout_rate"])}
        if plan["is_test"] is not None:
            attrs["is_test"] = plan["is_test"]
        if plan["rng_slot"] is not None:
            attrs["__rng_slot__"] = plan["rng_slot"]
        fused = Operator(block, "scaled_dot_product_attention",
                         inputs=inputs,
                         outputs={"Out": [plan["out"]]}, attrs=attrs)
        idx = block.ops.index(plan["mm2"])
        block.ops[idx] = fused
        doomed = {id(op) for op in plan["removable"]}
        block.ops[:] = [op for op in block.ops if id(op) not in doomed]
        out_var = block._find_var_recursive(plan["out"])
        if out_var is not None:
            out_var.op = fused
