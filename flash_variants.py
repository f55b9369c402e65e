"""A/B of the bfloat16 tensor-core flash kernels (K1a, K1b, K1c) on the card.

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 flash_variants.py

It builds variants of ``paddle_tpu_torch/csrc/flash_attention.cu`` that
differ from it in one design constant each (the rows of the tile a block
owns, the blocks an SM must hold, which caps a thread's registers), all
with ``nvcc`` at once, into the git-ignored
``paddle_tpu_torch/build/variants/``. Each variant's forward, dK/dV and dQ
are held against their plain versions with
``chip_smoke.py``'s check and timed at the long-context training shape
[8, 16, 2048, 64], causal, as ``chip_smoke.py`` times them (L2 flushed,
median of 30), in turns: every variant, then every variant again in the
reverse order. It prints the card's name and power limit, what ptxas
reports for each variant's D = 64 kernels without a bias (registers,
spills), then one JSON line per variant with both rounds' times in ms.
Exits non-zero without a CUDA device or when a variant fails its check.

    python3 flash_variants.py --against DIR [--steps]

times this checkout against another one (``DIR``, say the parent commit
unpacked with ``git archive``) on the same card, in turns: DIR, this, this,
DIR, each in a process of its own started in its checkout, which builds
that checkout's kernels and times its K1a/K1b/K1c at the same shape in
float32 and bfloat16 (one JSON line a turn) and, with ``--steps``, runs its
``chip_smoke.py`` long-context training phases (float32 and AMP).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

import torch

FWD_LAUNCH = ("launch(flash_fwd_bf16_kernel<D, 1, AB>, p, tiles_of(p.sq, 64),"
              "\n                  fwd_bf16_smem(64, D)")
DQ_LAUNCH = ("launch(flash_dq_bf16_kernel<D, 1, AB>, p, tiles_of(p.sq, 64),\n"
             "                dq_bf16_smem(64, D)")
FWD_BLOCKS = "constexpr int fwd_min_blocks(int d) { return d <= 64 ? 4 : 2; }"
DQ_BLOCKS = "constexpr int dq_min_blocks(int d) { return d <= 64 ? 3 : 2; }"
DKV_LAUNCH = ("launch(flash_dkv_bf16_kernel<D, 4, AB>, p, tiles_of(p.sk, 64),"
              "\n                  dkv_bf16_smem(64, D), 128")
DKV_BLOCKS = ("constexpr int dkv_min_blocks(int d) "
              "{ return d <= 64 ? 2 : 1; }")
# a block of 8 warps owns 128 kv rows
DKV_128_ROWS = (DKV_LAUNCH, DKV_LAUNCH.replace("<D, 4, AB>", "<D, 8, AB>")
                .replace("(p.sk, 64)", "(p.sk, 128)")
                .replace("(64, D), 128", "(128, D), 256"))


def rows128(launch):
    return (launch.replace("<D, 1, AB>", "<D, 2, AB>").replace("(p.sq, 64)",
                                                               "(p.sq, 128)")
            .replace("(64, D)", "(128, D)"))


# name: [(text of the source, its replacement)]
VARIANTS = {
    "source": [],
    "fwd_128_rows_2_blocks": [(FWD_LAUNCH, rows128(FWD_LAUNCH)),
                              (FWD_BLOCKS, FWD_BLOCKS.replace("? 4", "? 2"))],
    "fwd_3_blocks": [(FWD_BLOCKS, FWD_BLOCKS.replace("? 4", "? 3"))],
    "fwd_5_blocks": [(FWD_BLOCKS, FWD_BLOCKS.replace("? 4", "? 5"))],
    "dq_128_rows_2_blocks": [(DQ_LAUNCH, rows128(DQ_LAUNCH)),
                             (DQ_BLOCKS, DQ_BLOCKS.replace("? 3", "? 2"))],
    "dq_2_blocks": [(DQ_BLOCKS, DQ_BLOCKS.replace("? 3", "? 2"))],
    "dq_4_blocks": [(DQ_BLOCKS, DQ_BLOCKS.replace("? 3", "? 4"))],
    "dkv_3_blocks": [(DKV_BLOCKS, DKV_BLOCKS.replace("? 2", "? 3"))],
    "dkv_4_blocks": [(DKV_BLOCKS, DKV_BLOCKS.replace("? 2", "? 4"))],
    "dkv_128_rows_1_block": [DKV_128_ROWS,
                             (DKV_BLOCKS, DKV_BLOCKS.replace("? 2", "? 1"))],
    "dkv_128_rows_2_blocks": [DKV_128_ROWS],
}


def build(_build):
    """{variant: (loaded library, ptxas lines of its D = 64 bf16
    kernels)}, every variant compiled at once."""
    src = (_build.SRC_DIR / "flash_attention.cu").read_text()
    out = _build.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name, subs in VARIANTS.items():
        text = src
        for old, new in subs:
            if text.count(old) != 1:
                raise RuntimeError("variant %s: its pattern is not in the "
                                   "source once: %r" % (name, old))
            text = text.replace(old, new)
        cu = out / (name + ".cu")
        cu.write_text(text)
        so = cu.with_suffix(".so")
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-Xptxas", "-v",
               "-o", str(so), str(cu)]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.PIPE, text=True), so)
    libs = {}
    for name, (proc, so) in jobs.items():
        o, e = proc.communicate()
        if proc.returncode:
            raise RuntimeError("variant %s did not build:\n%s%s"
                               % (name, o, e))
        lines = (o + e).splitlines()
        ptxas = []
        for i, line in enumerate(lines):
            # the kernels without a bias (its type bf16), D = 64
            kern = re.search(r"\d(flash_\w+_bf16_kernel)ILi64ELi\d+E13__nv_"
                             r"bfloat16E", line)
            if "Compiling entry" in line and kern:
                used = lines[i + 3].split(":")[-1].strip()
                ptxas.append("%s: %s; %s" % (kern[1], used,
                                             lines[i + 2].strip()))
        libs[name] = (ctypes.CDLL(str(so)), ptxas)
    return libs


def time_checkout(label, steps):
    """K1a/K1b/K1c of the checkout in the working directory at the
    long-context shape, causal, in float32 and bfloat16, timed as
    ``chip_smoke.py`` times them; with ``steps``, that checkout's
    long-context training phases too."""
    sys.path.insert(0, os.getcwd())  # that checkout's port, not this one's
    import chip_smoke as cs
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.ops.kernels import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build_all()
    dev = torch.device("cuda", torch.cuda.current_device())
    b, s = cs.LONGCTX_BATCH, cs.LONGCTX_SEQ
    h, d = cs.LONGCTX["n_head"], cs.LONGCTX["d_model"] // cs.LONGCTX["n_head"]
    sm = d ** -0.5
    flush = cs.l2_flusher(dev)
    ms = {}
    for dt in (torch.float32, torch.bfloat16):
        q, k, v, do, _, _ = cs.flash_inputs(dev, dt, b, h, s, s, d, 0)
        o, lse = fa.flash_fwd(q, k, v, None, None, True, sm)
        di = (o.float() * do.float()).sum(-1)
        args = (q, k, v, None, None, lse, do, di, True, sm)
        ms[str(dt).replace("torch.", "")] = {
            "fwd": cs.cuda_ms(lambda: fa.flash_fwd(q, k, v, None, None, True,
                                                   sm), flush=flush),
            "dkv": cs.cuda_ms(lambda: fa.flash_bwd_dkv(*args), flush=flush),
            "dq": cs.cuda_ms(lambda: fa.flash_bwd_dq(*args), flush=flush)}
        del q, k, v, do, o, lse, di, args
        torch.cuda.empty_cache()
    print(json.dumps({"checkout": label, "root": os.getcwd(), "ms": ms}),
          flush=True)
    if steps:
        rows = [{}, {}, {}]
        cs.longctx_train_phase(rows, amp=False)
        cs.longctx_train_phase(rows, amp=True)
    return 0


def against(other, steps):
    """This checkout and ``other`` in turns: other, this, this, other."""
    here = os.path.dirname(os.path.abspath(__file__))
    for label, root in (("other", other), ("this", here), ("this", here),
                        ("other", other)):
        subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--time-checkout", label]
                       + (["--steps"] if steps else []),
                       cwd=root, check=True)
    return 0


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", metavar="DIR",
                    help="time this checkout against the one in DIR")
    ap.add_argument("--steps", action="store_true",
                    help="with --against: the long-context steps too")
    ap.add_argument("--time-checkout", metavar="LABEL",
                    help=argparse.SUPPRESS)  # one turn of --against
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("flash_variants: torch.cuda.is_available() is False; this "
              "needs a CUDA GPU", file=sys.stderr)
        return 1
    if args.time_checkout:
        return time_checkout(args.time_checkout, args.steps)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    if args.against:
        return against(os.path.abspath(args.against), args.steps)
    import chip_smoke as cs
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.ops.kernels import flash_attention as fa

    libs = build(_build)
    for name, (_, ptxas) in libs.items():
        print(name, "|", " | ".join(ptxas), flush=True)

    dev = torch.device("cuda", torch.cuda.current_device())
    b, s = cs.LONGCTX_BATCH, cs.LONGCTX_SEQ
    h, d = cs.LONGCTX["n_head"], cs.LONGCTX["d_model"] // cs.LONGCTX["n_head"]
    sm = d ** -0.5
    rtol, floor = cs.FLASH_TOL["bfloat16"]
    q, k, v, do, _, _ = cs.flash_inputs(dev, torch.bfloat16, b, h, s, s, d, 0)
    want_o, lse = fa.flash_fwd_reference(q, k, v, None, None, True, sm)
    di = (want_o.float() * do.float()).sum(-1)
    want_dq, _ = fa.flash_bwd_dq_reference(q, k, v, None, None, lse, do, di,
                                           True, sm)
    want_dk, want_dv = fa.flash_bwd_dkv_reference(q, k, v, None, None, lse,
                                                  do, di, True, sm)
    flush = cs.l2_flusher(dev)
    times = {name: [] for name in libs}
    try:
        for name in list(libs) + list(reversed(list(libs))):
            fa._fns = fa.bind(libs[name][0])
            o, _ = fa.flash_fwd(q, k, v, None, None, True, sm)
            dq, _ = fa.flash_bwd_dq(q, k, v, None, None, lse, do, di, True,
                                    sm)
            dk, dv = fa.flash_bwd_dkv(q, k, v, None, None, lse, do, di, True,
                                      sm)
            torch.cuda.synchronize()
            errs = [cs.flash_err(got, want.float(), rtol, floor)
                    for got, want in ((o, want_o), (dq, want_dq),
                                      (dk, want_dk), (dv, want_dv))]
            cs.check(max(errs) <= 1, "variant %s: o, dq, dk, dv err %r of "
                     "the bound" % (name, errs))
            times[name].append({
                "fwd_ms": cs.cuda_ms(lambda: fa.flash_fwd(
                    q, k, v, None, None, True, sm), flush=flush),
                "dq_ms": cs.cuda_ms(lambda: fa.flash_bwd_dq(
                    q, k, v, None, None, lse, do, di, True, sm), flush=flush),
                "dkv_ms": cs.cuda_ms(lambda: fa.flash_bwd_dkv(
                    q, k, v, None, None, lse, do, di, True, sm), flush=flush),
                "fwd_dropout_0.1_ms": cs.cuda_ms(lambda: fa.flash_fwd(
                    q, k, v, None, None, True, sm, 0.1, 5), flush=flush)})
    finally:
        fa._fns = None
    for name, runs in times.items():
        print(json.dumps({"variant": name, "runs": runs}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
