# ported from paddle_tpu/debugger.py
"""Program inspection tools (reference: python/paddle/fluid/debugger.py,
graphviz.py, net_drawer.py)."""

from __future__ import annotations

from .core.framework import Program

__all__ = ["pprint_program_codes", "draw_block_graphviz"]


def pprint_program_codes(program: Program) -> str:
    """Pretty program listing (reference: debugger.py pprint_program_codes)."""
    lines = []
    for blk in program.blocks:
        lines.append("// block %d (parent %d)" % (blk.idx, blk.parent_idx))
        for v in blk.vars.values():
            mods = []
            if v.persistable:
                mods.append("persistable")
            if v.is_data:
                mods.append("data")
            lines.append("  var %s : %s%s %s" % (
                v.name, v.dtype, list(v.shape) if v.shape is not None else "?",
                " ".join(mods)))
        for op in blk.ops:
            outs = ", ".join("%s=%s" % (k, v) for k, v in op.outputs.items())
            ins = ", ".join("%s=%s" % (k, v) for k, v in op.inputs.items())
            lines.append("  {%s} = %s(%s) [%s]" % (
                outs, op.type, ins,
                ", ".join("%s=%r" % kv for kv in sorted(op.attrs.items()))))
    text = "\n".join(lines)
    print(text)
    return text


def draw_block_graphviz(block, output_path: str = "program.dot", highlights=None):
    """DOT dump of a block's dataflow (reference: graph_viz_pass.cc /
    debugger.draw_block_graphviz)."""
    highlights = set(highlights or [])
    lines = ["digraph G {", "  rankdir=TB;"]
    for v in block.vars.values():
        style = ' style=filled fillcolor="#ffd2d2"' if v.name in highlights else ""
        lines.append('  "%s" [shape=oval%s];' % (v.name, style))
    for i, op in enumerate(block.ops):
        op_id = "op_%d_%s" % (i, op.type)
        lines.append('  "%s" [shape=box label="%s"];' % (op_id, op.type))
        for name in op.input_arg_names:
            lines.append('  "%s" -> "%s";' % (name, op_id))
        for name in op.output_arg_names:
            lines.append('  "%s" -> "%s";' % (op_id, name))
    lines.append("}")
    with open(output_path, "w") as f:
        f.write("\n".join(lines))
    return output_path
