"""A/B of the bfloat16 tensor-core flash kernels (K1a, K1c) on the card.

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 flash_variants.py

It builds variants of ``paddle_tpu_torch/csrc/flash_attention.cu`` that
differ from it in one design constant each (the rows of a q tile, the
blocks an SM must hold, which caps a thread's registers), all with ``nvcc``
at once, into the git-ignored ``paddle_tpu_torch/build/variants/``. Each
variant's forward and dQ are held against their plain versions with
``chip_smoke.py``'s check and timed at the long-context training shape
[8, 16, 2048, 64], causal, as ``chip_smoke.py`` times them (L2 flushed,
median of 30), in turns: every variant, then every variant again in the
reverse order. It prints the card's name and power limit, what ptxas
reports for each variant's D = 64 kernels (registers, spills), then one
JSON line per variant with both rounds' times in ms. Exits non-zero
without a CUDA device or when a variant fails its check.
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys

import torch

FWD_LAUNCH = ("launch(flash_fwd_bf16_kernel<D, 1>, p, tiles_of(p.sq, 64),\n"
              "                  fwd_bf16_smem(64, D)")
DQ_LAUNCH = ("launch(flash_dq_bf16_kernel<D, 1>, p, tiles_of(p.sq, 64),\n"
             "                dq_bf16_smem(64, D)")
FWD_BLOCKS = "constexpr int fwd_min_blocks(int d) { return d <= 64 ? 4 : 2; }"
DQ_BLOCKS = "constexpr int dq_min_blocks(int d) { return d <= 64 ? 3 : 2; }"


def rows128(launch):
    return (launch.replace("<D, 1>", "<D, 2>").replace("(p.sq, 64)",
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
            kern = re.search(r"\d(flash_\w+_bf16_kernel)ILi64E", line)
            if "Compiling entry" in line and kern:
                used = lines[i + 3].split(":")[-1].strip()
                ptxas.append("%s: %s; %s" % (kern[1], used,
                                             lines[i + 2].strip()))
        libs[name] = (ctypes.CDLL(str(so)), ptxas)
    return libs


def main():
    if not torch.cuda.is_available():
        print("flash_variants: torch.cuda.is_available() is False; this "
              "needs a CUDA GPU", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.ops.kernels import flash_attention as fa

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
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
    flush = cs.l2_flusher(dev)
    times = {name: [] for name in libs}
    try:
        for name in list(libs) + list(reversed(list(libs))):
            fa._fns = fa.bind(libs[name][0])
            o, _ = fa.flash_fwd(q, k, v, None, None, True, sm)
            dq, _ = fa.flash_bwd_dq(q, k, v, None, None, lse, do, di, True,
                                    sm)
            torch.cuda.synchronize()
            errs = (cs.flash_err(o, want_o.float(), rtol, floor),
                    cs.flash_err(dq, want_dq.float(), rtol, floor))
            cs.check(max(errs) <= 1, "variant %s: o, dq err %r of the bound"
                     % (name, errs))
            times[name].append({
                "fwd_ms": cs.cuda_ms(lambda: fa.flash_fwd(
                    q, k, v, None, None, True, sm), flush=flush),
                "dq_ms": cs.cuda_ms(lambda: fa.flash_bwd_dq(
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
