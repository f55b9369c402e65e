"""A/B of the flash kernels (K1a, K1b, K1c) on the card, in both dtypes.

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 flash_variants.py

It builds variants of ``paddle_tpu_torch/csrc/flash_attention.cu`` that
differ from it in one design constant each (bfloat16: the rows of the tile
a block owns, the blocks an SM must hold, which caps a thread's registers;
float32 K1a and K1c: the rows of a thread's register tile, the threads of
a block and so the rows of its q tile; float32 K1b: the same for its kv
tile, and the lean layout of one dO stage and one tile for P^T and dS^T,
which halves its shared memory), all with ``nvcc`` at once, into
the git-ignored ``paddle_tpu_torch/build/variants/``. Each variant's
forward, dK/dV and dQ are held against their plain versions with
``chip_smoke.py``'s check and timed at the long-context training shape
[8, 16, 2048, 64], causal, in float32 (keys ``f32_*``) and bfloat16, as
``chip_smoke.py`` times them (L2 flushed, median of 30), in turns: every
variant, then every variant again in the reverse order. It prints the
card's name and power limit, what ptxas reports for each variant's D = 64
kernels (the bfloat16 ones without a bias: registers, spills), then one
JSON line per variant with both rounds' times in ms.
Exits non-zero without a CUDA device or when a variant fails its check.

    python3 flash_variants.py --against DIR [--steps] [--serve]

times this checkout against another one (``DIR``, say the parent commit
unpacked with ``git archive``) on the same card, in turns: DIR, this, this,
DIR, each in a process of its own started in its checkout, which builds
that checkout's kernels and times its K1a/K1b/K1c at the same shape in
float32 and bfloat16 (one JSON line a turn) and, with ``--steps``, runs its
``chip_smoke.py`` long-context training phases (float32 and AMP); with
``--serve``, its ``chip_smoke.py`` K3 phase and serving phases.

    python3 flash_variants.py --sparse [--against DIR [--steps]]

does the same for the row kernels K4a and K4b (``csrc/sparse_adam.cu``):
variants that edit the source's text (``SPARSE_TEXT``: the table loads,
the lanes a D = 10 row takes, one thread a row at D = 10, the group
kernel and several rows a thread at D = 1; ``SPARSE_CONSTS``: the threads
a block), and the source with every
load scalar, each held against
the plain versions at V = 1e6 and timed by CUDA events and by CUPTI
(``chip_smoke.device_ms``) on the tables of the DeepFM step, [V, 10] and
[V, 1] at V = 1e6 and 5e7, in turns; with ``--against``, this checkout and
DIR in turns, and with ``--steps`` their DeepFM steps at V = 1e6 (Adam and
SGD, 20 timed steps each).
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
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


# float32 K1a and K1c: <D, rows a thread owns, threads>; a q tile has
# threads / 8 * rows rows
F32_FWD_LAUNCH = ("launch(flash_fwd_kernel<D, 4, 128>, p, tiles_of(p.sq, 64),"
                  "\n                    fwd_smem(64, D), 128")
F32_DQ_LAUNCH = ("launch(flash_dq_kernel<D, 4, 128>, p, tiles_of(p.sq, 64),"
                 "\n                  dq_smem(64, D), 128")


def f32_tile(launch, rows, threads):
    """``launch`` with ``rows`` q rows a thread (4 x 8 or 8 x 8 scores) on
    ``threads`` threads."""
    br = threads // 8 * rows
    return (launch, launch.replace("<D, 4, 128>", "<D, %d, %d>" % (rows,
                                                                 threads))
            .replace("(p.sq, 64)", "(p.sq, %d)" % br)
            .replace("(64, D), 128", "(%d, D), %d" % (br, threads)))


# float32 K1b: <D, kv rows a thread owns, threads, lean>; a block owns
# threads / 8 * rows kv rows; lean: one dO stage and one tile for P^T, dS^T
F32_DKV_LAUNCH = ("flash_dkv_kernel<D, 4, 128, true>, p,\n"
                  "                      tiles_of(p.sk, 64), "
                  "dkv_smem(64, D, true), 128")


def f32_dkv(rows, threads, lean):
    """The float32 K1b launch (D = 32 and 64) with ``rows`` kv rows a
    thread on ``threads`` threads, ``lean`` or not."""
    bkv = threads // 8 * rows
    return (F32_DKV_LAUNCH,
            "flash_dkv_kernel<D, %d, %d, %s>, p,\n"
            "                      tiles_of(p.sk, %d), "
            "dkv_smem(%d, D, %s), %d"
            % (rows, threads, str(lean).lower(), bkv, bkv,
               str(lean).lower(), threads))


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
    # float32 (the source: 64 q rows, 4 x 8 scores a thread, 128 threads,
    # two blocks an SM by shared memory)
    "f32_fwd_8x8_64_rows_64_threads": [f32_tile(F32_FWD_LAUNCH, 8, 64)],
    "f32_fwd_8x8_128_rows": [f32_tile(F32_FWD_LAUNCH, 8, 128)],
    "f32_fwd_128_rows_256_threads": [f32_tile(F32_FWD_LAUNCH, 4, 256)],
    "f32_dq_8x8_64_rows_64_threads": [f32_tile(F32_DQ_LAUNCH, 8, 64)],
    "f32_dq_8x8_128_rows": [f32_tile(F32_DQ_LAUNCH, 8, 128)],
    "f32_dq_128_rows_256_threads": [f32_tile(F32_DQ_LAUNCH, 4, 256)],
    # float32 K1b (the source: 64 kv rows, 4 x 8 scores a thread, 128
    # threads, lean, 106 KB: two blocks an SM)
    "f32_dkv_2x8_256": [f32_dkv(2, 256, False)],
    "f32_dkv_2x8_256_lean": [f32_dkv(2, 256, True)],
    "f32_dkv_4x8_256_128_rows": [f32_dkv(4, 256, False)],
    "f32_dkv_4x8_128": [f32_dkv(4, 128, False)],
}


def build(_build):
    """{variant: (loaded library, ptxas lines of its D = 64 kernels, the
    bf16 ones without a bias)}, every variant compiled at once."""
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
            # D = 64: the float32 kernels, the bf16 ones without a bias
            # (its type bf16)
            kern = re.search(r"\d(flash_\w+?_kernel)ILi64E", line)
            if kern and "bf16" in kern[1] and "13__nv_bfloat16E" not in line:
                kern = None
            if "Compiling entry" in line and kern:
                used = lines[i + 3].split(":")[-1].strip()
                ptxas.append("%s: %s; %s" % (kern[1], used,
                                             lines[i + 2].strip()))
        libs[name] = (ctypes.CDLL(str(so)), ptxas)
    return libs


# sparse_adam.cu's design constant and the values it is timed at
SPARSE_CONSTS = {"kThreads": (128, 256, 512)}
SPARSE_SHAPES = ((1_000_000, 10), (1_000_000, 1), (50_000_000, 10),
                 (50_000_000, 1))

# Variants that change the source's text: the table loads with an L2
# fetch-size hint (64 or 128 bytes) and as plain C++ loads; the lanes a
# D = 10 row takes (the source: 8, its 5 chunks of float2 rounded up to a
# power of two); the group packed (5 lanes a D = 10 row, 6 rows a warp);
# (a) one thread a row at D = 10; the group kernel (one lane a row) in
# place of the row kernel at D = 1; and a kernel the source does not have,
# (c) R rows a thread at D = 1, their ids read two to a 16-byte load where
# ids and rows lie on 16 bytes.
ASM_LOADS = """    asm volatile("ld.global.v4.f32 {%0, %1, %2, %3}, [%4];"
        : "=f"(dst[0]), "=f"(dst[1]), "=f"(dst[2]), "=f"(dst[3])
        : "l"(src));
  } else if constexpr (VEC == 2) {
    asm volatile("ld.global.v2.f32 {%0, %1}, [%2];"
        : "=f"(dst[0]), "=f"(dst[1])
        : "l"(src));
  } else {
    asm volatile("ld.global.f32 %0, [%1];" : "=f"(dst[0]) : "l"(src));"""
CXX_LOADS = """    const float4 t = *reinterpret_cast<const float4*>(src);
    dst[0] = t.x;
    dst[1] = t.y;
    dst[2] = t.z;
    dst[3] = t.w;
  } else if constexpr (VEC == 2) {
    const float2 t = *reinterpret_cast<const float2*>(src);
    dst[0] = t.x;
    dst[1] = t.y;
  } else {
    dst[0] = *src;"""
LANES = "  const int lanes = a.d / vec;\n"
POW2_INDEX = """  const int lanes = 1 << lanes_log2;
  const long long i =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) >>
      lanes_log2;
  const int lane = threadIdx.x & (lanes - 1);
  long long id = -1;
  if (lane == 0 && i < n) id = __ldg(ids + i);
  id = __shfl_sync(0xffffffffu, id, 0, lanes);  // every lane of the warp
  if (i >= n) return;"""
PACKED_INDEX = """  const int lanes = lanes_log2;  // packed: the lanes themselves
  const int warp_lane = threadIdx.x & 31;
  const int group = warp_lane / lanes;
  const int lane = warp_lane - group * lanes;
  const long long i =
      ((static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) >> 5) *
          (32 / lanes) +
      group;
  const bool mine = group < 32 / lanes && i < n;
  long long id = -1;
  if (mine && lane == 0) id = __ldg(ids + i);
  id = __shfl_sync(0xffffffffu, id, group * lanes & 31);
  if (!mine) return;"""
POW2_GRID = """  int l2 = 0;
  while ((1 << l2) < lanes && l2 < 5) ++l2;
  const unsigned int b = blocks_for(a.n << l2);"""
PACKED_GRID = """  int l2 = lanes < 32 ? lanes : 32;  // packed: the lanes themselves
  const unsigned int b = blocks_for((a.n + 32 / l2 - 1) / (32 / l2) * 32);"""
KERNELS_AT = "unsigned int blocks_for("
DISPATCH_AT = "  if (a.n <= 0) return static_cast<int>(cudaGetLastError());\n"
ROW_D10 = """  if (a.d == 10) {  // (a)
    const unsigned int b = blocks_for(a.n);
    if (vec == 2) {
      sparse_row_kernel<Op, 10, 2>
          <<<b, kThreads, 0, s>>>(op, a.ids, a.rows, a.lr, a.n, a.vocab);
    } else {
      sparse_row_kernel<Op, 10, 1>
          <<<b, kThreads, 0, s>>>(op, a.ids, a.rows, a.lr, a.n, a.vocab);
    }
    return static_cast<int>(cudaGetLastError());
  }
"""
ROW_D1 = """  if (a.d == 1) {
    sparse_row_kernel<Op, 1, 1><<<blocks_for(a.n), kThreads, 0, s>>>(
        op, a.ids, a.rows, a.lr, a.n, a.vocab);
    return static_cast<int>(cudaGetLastError());
  }
"""
D1_KERNEL = """// (c) D = 1: R merged rows a thread (R even). WIDE: ids and rows lie on 16
// bytes, so the R ids come two to a 16-byte load and the R gradients in
// one load.
template <class Op, int R, bool WIDE>
__global__ void __launch_bounds__(kThreads)
    sparse_d1_kernel(Op op, const long long* __restrict__ ids,
                     const float* __restrict__ rows,
                     const float* __restrict__ lr_t, long long n,
                     long long vocab) {
  const float lr = __ldg(lr_t);
  const long long i0 =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) * R;
  if (i0 >= n) return;
  long long row[R];
  float g[R], p[R], m[R], v[R];
  if (WIDE && i0 + R <= n) {
#pragma unroll
    for (int r = 0; r < R; r += 2) {
      const longlong2 t =
          __ldg(reinterpret_cast<const longlong2*>(ids + i0 + r));
      row[r] = t.x;
      row[r + 1] = t.y;
    }
    load_ro<R>(g, rows + i0);
  } else {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const bool in = i0 + r < n;
      row[r] = in ? __ldg(ids + i0 + r) : 0;
      g[r] = in ? __ldg(rows + i0 + r) : 0.0f;
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    row[r] = i0 + r < n ? named_row(row[r], vocab) : -1;
    if (row[r] >= 0) op.template load_at<1>(row[r], p + r, m + r, v + r);
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (row[r] >= 0) {
      op.update(g[r], p[r], m[r], v[r], lr);
      op.template store_at<1>(row[r], p + r, m + r, v + r);
    }
  }
}

"""
D1_ROWS = """  if (a.d == 1) {  // (c)
    const unsigned int b = blocks_for((a.n + R - 1) / R);
    if ((reinterpret_cast<unsigned long long>(a.ids) |
         reinterpret_cast<unsigned long long>(a.rows)) % 16 == 0) {
      sparse_d1_kernel<Op, R, true>
          <<<b, kThreads, 0, s>>>(op, a.ids, a.rows, a.lr, a.n, a.vocab);
    } else {
      sparse_d1_kernel<Op, R, false>
          <<<b, kThreads, 0, s>>>(op, a.ids, a.rows, a.lr, a.n, a.vocab);
    }
    return static_cast<int>(cudaGetLastError());
  }
"""


def with_const(src, const, value):
    """``src`` with ``constexpr int <const> = <value>;``."""
    return re.sub(r"constexpr int %s = \d+;" % const,
                  "constexpr int %s = %d;" % (const, value), src)


def l2_hint(size):
    """The table loads with the L2 fetch-size hint of ``size`` bytes."""
    return lambda src: src.replace(
        ASM_LOADS, ASM_LOADS.replace('"ld.global.', '"ld.global.L2::%dB.'
                                     % size))


def d10_lanes(lanes):
    """A D = 10 row on ``lanes`` lanes (a power of two)."""
    return lambda src: src.replace(
        LANES, "  const int lanes = a.d == 10 ? %d : a.d / vec;\n" % lanes)


def with_kernel(kernel, dispatch):
    """The source with ``kernel`` beside its kernels and ``dispatch`` ahead
    of their launches."""
    return lambda src: src.replace(KERNELS_AT, kernel + KERNELS_AT).replace(
        DISPATCH_AT, DISPATCH_AT + dispatch)


SPARSE_TEXT = {
    "l2_fetch_64B": l2_hint(64),
    "l2_fetch_128B": l2_hint(128),
    "cxx_loads": lambda src: src.replace(ASM_LOADS, CXX_LOADS),
    "packed_lanes_5": lambda src: d10_lanes(5)(src).replace(
        POW2_INDEX, PACKED_INDEX).replace(POW2_GRID, PACKED_GRID),
    **{"d10_lanes_%d" % n: d10_lanes(n) for n in (2, 4, 16)},
    "row_a_d10": with_kernel("", ROW_D10),
    "group_d1": lambda src: src.replace(ROW_D1, ""),
    **{"d1_rows_%d" % r: with_kernel(D1_KERNEL,
                                     D1_ROWS.replace("R", str(r)))
       for r in (2, 4)},
}


def sparse_variants(src):
    """{name: source}: the source, one variant for each other value of each
    design constant, and the SPARSE_TEXT variants."""
    out = {"source": src}
    for pattern in (ASM_LOADS, LANES, POW2_INDEX, POW2_GRID, KERNELS_AT,
                    DISPATCH_AT, ROW_D1):
        if src.count(pattern) != 1:
            raise RuntimeError("%r is not in sparse_adam.cu once" % pattern)
    for name, edit in SPARSE_TEXT.items():
        out[name] = edit(src)
    for const, values in SPARSE_CONSTS.items():
        pat = r"constexpr int %s = \d+;" % const
        if len(re.findall(pat, src)) != 1:
            raise RuntimeError("%s is not in sparse_adam.cu once" % const)
        for v in values:
            text = with_const(src, const, v)
            if text != src:
                out["%s_%d" % (const[1:], v)] = text
    return out


def ptxas_kernels(log):
    """'kernel<op, template values>: registers; spills' for each row
    kernel entry in ``nvcc -Xptxas -v`` output."""
    lines = log.splitlines()
    out = []
    for i, line in enumerate(lines):
        name = re.search(r"Compiling entry function '(\w+)'", line)
        if not name:
            continue
        kern = re.search(r"\d(sparse_\w+?_kernel)I(.*)", name[1])
        if kern is None:
            continue
        op = re.search(r"\d+(Sparse\w+?)E", kern[2])
        args = re.findall(r"L[ib](\d+)E", kern[2])
        regs = re.search(r"Used (\d+) registers", lines[i + 3])
        out.append("%s<%s>: %s registers; %s" % (
            kern[1], ",".join(([op[1]] if op else []) + args),
            regs[1] if regs else "?", lines[i + 2].strip()))
    return out


def build_sources(_build, texts, stem):
    """{name: (loaded library, ptxas lines)} of ``texts`` ({name: source}),
    every one compiled at once with the kernels' nvcc flags."""
    out = _build.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name, text in texts.items():
        cu = out / ("%s_%s.cu" % (stem, name))
        cu.write_text(text)
        so = cu.with_suffix(".so")
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-Xptxas", "-v",
               "-o", str(so), str(cu)]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.PIPE, text=True), so)
    libs = {}
    for name, (proc, so) in jobs.items():
        o, e = proc.communicate()
        if proc.returncode and name == "source":
            raise RuntimeError("the source did not build:\n%s%s" % (o, e))
        if proc.returncode:  # a variant the compiler refuses is reported
            print("variant %s did not build:\n%s%s" % (name, o, e),
                  flush=True)
            continue
        libs[name] = (ctypes.CDLL(str(so)), ptxas_kernels(o + e))
    return libs


def sass_memory_ops(_build, so, kernel):
    """The global loads and stores and the shuffles, in program order, of
    the kernel whose mangled name holds ``kernel`` in library ``so``
    (``cuobjdump -sass``, beside nvcc), as a list of opcodes."""
    tool = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(so)], capture_output=True,
                          text=True, check=True).stdout
    ops, inside = [], False
    for line in sass.splitlines():
        if "Function :" in line:
            inside = kernel in line
        elif inside:
            op = re.search(r"\b((?:LDG|STG|SHFL|LD|ST)\.[\w.]+)", line)
            if op:
                ops.append(op[1])
    return ops


def this_chip_smoke():
    """This checkout's ``chip_smoke`` (its timing and checks), whichever
    checkout ``paddle_tpu_torch`` comes from."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke_here", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def sparse_cases(cs, dev):
    """{(V, D): (merged ids, rows, (p, m, v), lr_t, lr)} at SPARSE_SHAPES."""
    return {(v, d): cs.sparse_inputs(dev, v, d) for v, d in SPARSE_SHAPES}


def time_sparse(cs, sa, cases, flush):
    """{"V,D": {adam/sgd ms and device_ms}} of the loaded K4a/K4b through
    their wrappers; the tables are updated in place on every launch."""
    out = {}
    for (v, d), (uniq, merged, (p, m, v_), lr_t, lr) in cases.items():
        def adam():
            sa.sparse_adam_rows(p, m, v_, uniq, merged, lr_t)

        def sgd():
            sa.sparse_sgd_rows(p, uniq, merged, lr)

        out["%d,%d" % (v, d)] = {
            "adam_ms": cs.cuda_ms(adam, flush=flush),
            "adam_device_ms": cs.device_ms(adam, cs.K4A_KERNEL, flush=flush),
            "sgd_ms": cs.cuda_ms(sgd, flush=flush),
            "sgd_device_ms": cs.device_ms(sgd, cs.K4B_KERNEL, flush=flush)}
    return out


def check_sparse(cs, sa, cases, name):
    """The loaded K4a/K4b against the plain versions at V = 1e6: p, m, v to
    1e-6 of max(|after|, |before|), K4b bit-equal."""
    for (v, d), (uniq, merged, olds, lr_t, lr) in cases.items():
        if v != 1_000_000:
            continue
        got = sa.sparse_adam_rows(*(t.clone() for t in olds), uniq, merged,
                                  lr_t)
        want = sa.sparse_adam_rows_reference(*(t.clone() for t in olds),
                                             uniq, merged, lr_t)
        sgd = sa.sparse_sgd_rows(olds[0].clone(), uniq, merged, lr)
        torch.cuda.synchronize()
        errs = [cs.sparse_err(g, w, o) for g, w, o in zip(got, want, olds)]
        cs.check(max(errs) <= 1e-6 and torch.equal(
            sgd, sa.sparse_sgd_rows_reference(olds[0].clone(), uniq, merged,
                                              lr)),
            "variant %s at [%d, %d]: p, m, v err %r" % (name, v, d, errs))


def sparse_main():
    """The K4 variants, held and timed in turns (see the module's doc)."""
    cs = this_chip_smoke()
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.ops.kernels import sparse_adam as sa

    src = (_build.SRC_DIR / "sparse_adam.cu").read_text()
    libs = build_sources(_build, sparse_variants(src), "sparse_adam")
    for name, (lib, ptxas) in libs.items():
        print(name, "|", " | ".join(ptxas), flush=True)
        # K4a at D = 10 (the group kernel on float2, or the row kernel)
        for kern in ("sparse_group_kernelINS_10SparseAdamELi2E",
                     "sparse_row_kernelINS_10SparseAdamELi10ELi2E"):
            ops = sass_memory_ops(_build, lib._name, kern)
            if ops:
                print(name, "| SASS", kern, ":", " ".join(ops), flush=True)
    dev = torch.device("cuda", torch.cuda.current_device())
    cases = sparse_cases(cs, dev)
    flush = cs.l2_flusher(dev)
    print(json.dumps({"launch_floor_ms": cs.launch_floor_ms(flush)}),
          flush=True)
    # and the source with every row load scalar, as a view off 8 bytes is
    runs = list(libs) + ["source_scalar"]
    times = {name: [] for name in runs}
    width = sa.load_width
    try:
        for turn, order in enumerate((runs, runs[::-1])):
            for name in order:
                sa._fns = sa.bind(libs[name.replace("_scalar", "")][0])
                sa.load_width = ((lambda *_: 1) if name.endswith("_scalar")
                                 else width)
                if turn == 0:
                    check_sparse(cs, sa, cases, name)
                times[name].append(time_sparse(cs, sa, cases, flush))
    finally:
        sa._fns, sa.load_width = None, width
    for name, runs_ in times.items():
        print(json.dumps({"variant": name, "runs": runs_}), flush=True)
    return 0


def time_checkout_sparse(label, steps):
    """K4a/K4b of the checkout in the working directory, timed at
    SPARSE_SHAPES by this checkout's ``chip_smoke`` helpers; with
    ``steps``, that checkout's DeepFM steps at V = 1e6."""
    sys.path.insert(0, os.getcwd())  # that checkout's port, not this one's
    cs = this_chip_smoke()
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.ops.kernels import sparse_adam as sa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build_all()
    dev = torch.device("cuda", torch.cuda.current_device())
    cases = sparse_cases(cs, dev)
    flush = cs.l2_flusher(dev)
    ms = time_sparse(cs, sa, cases, flush)
    del cases, flush
    torch.cuda.empty_cache()
    res = {"checkout": label, "root": os.getcwd(), "sparse": ms}
    if steps:
        import paddle_tpu_torch as fluid

        for opt in ("adam", "sgd"):
            run = cs.ctr_run(fluid, cs.CTR["sparse_feature_dim"], opt,
                             timed=20)
            res["ctr_" + opt] = {k: run[k] for k in (
                "step_ms_median", "step_ms", "launches", "losses")}
    print(json.dumps(res), flush=True)
    return 0


def interleaved_steps(other, pairs=30):
    """DeepFM steps at V = 1e6, Adam then SGD, in one process, alternating
    step by step between this checkout's K4a/K4b and ``other``'s (its
    ``sparse_adam.cu`` built beside this one's, called through its own
    wrapper): the host's noise falls on both alike. Prints the medians."""
    cs = this_chip_smoke()
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.ops.kernels import sparse_adam as sa

    kernels = os.path.join(other, "paddle_tpu_torch", "ops", "kernels")
    spec = importlib.util.spec_from_file_location(
        "other_sparse_adam", os.path.join(kernels, "sparse_adam.py"))
    theirs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(theirs)
    src = open(os.path.join(other, "paddle_tpu_torch", "csrc",
                            "sparse_adam.cu")).read()
    lib = build_sources(_build, {"other": src}, "sparse_adam")["other"][0]
    theirs._fns = theirs.bind(lib)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fns = {"this": (sa.sparse_adam_rows, sa.sparse_sgd_rows),
           "other": (theirs.sparse_adam_rows, theirs.sparse_sgd_rows)}
    res = {}
    try:
        for opt in ("adam", "sgd"):
            main, startup, loss, auc = cs.build_deepfm(
                fluid, cs.CTR["sparse_feature_dim"], opt)
            scope = fluid.Scope()
            exe = fluid.Executor(fluid.CUDAPlace(0))
            exe.run(startup, scope=scope)
            feed = cs.ctr_feed()
            ms = {"this": [], "other": []}
            for k in range(2 * pairs + 4):  # 4 warm-up steps
                label = ("other", "this")[k % 2]
                sa.sparse_adam_rows, sa.sparse_sgd_rows = fns[label]
                t0 = time.perf_counter()
                exe.run(main, feed=feed, fetch_list=[loss, auc], scope=scope)
                if k >= 4:
                    ms[label].append((time.perf_counter() - t0) * 1e3)
            res[opt] = {label: {"step_ms_median": float(np.median(v)),
                                "step_ms": v} for label, v in ms.items()}
            del scope, exe
    finally:
        sa.sparse_adam_rows, sa.sparse_sgd_rows = fns["this"]
    print(json.dumps({"interleaved_steps": res, "pairs": pairs}), flush=True)
    return 0


def time_checkout(label, steps, serve):
    """K1a/K1b/K1c of the checkout in the working directory at the
    long-context shape, causal, in float32 and bfloat16, timed as
    ``chip_smoke.py`` times them; with ``steps``, that checkout's
    long-context training phases too; with ``serve``, its K3 and serving
    phases."""
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
    if serve:
        cs.serve_phase(cs.kernel_phase(dev))
    return 0


def against(other, steps, serve, sparse):
    """This checkout and ``other`` in turns: other, this, this, other."""
    here = os.path.dirname(os.path.abspath(__file__))
    for label, root in (("other", other), ("this", here), ("this", here),
                        ("other", other)):
        subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--time-checkout", label]
                       + (["--steps"] if steps else [])
                       + (["--serve"] if serve else [])
                       + (["--sparse"] if sparse else []),
                       cwd=root, check=True)
    if sparse and steps:
        return interleaved_steps(other)
    return 0


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", metavar="DIR",
                    help="time this checkout against the one in DIR")
    ap.add_argument("--steps", action="store_true",
                    help="with --against: the long-context steps too")
    ap.add_argument("--serve", action="store_true",
                    help="with --against: the K3 and serving phases too")
    ap.add_argument("--sparse", action="store_true",
                    help="the row kernels K4a/K4b instead of the flash "
                    "kernels (with --against --steps: the DeepFM steps)")
    ap.add_argument("--time-checkout", metavar="LABEL",
                    help=argparse.SUPPRESS)  # one turn of --against
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("flash_variants: torch.cuda.is_available() is False; this "
              "needs a CUDA GPU", file=sys.stderr)
        return 1
    if args.time_checkout:
        if args.sparse:
            return time_checkout_sparse(args.time_checkout, args.steps)
        return time_checkout(args.time_checkout, args.steps, args.serve)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    if args.against:
        return against(os.path.abspath(args.against), args.steps,
                       args.serve, args.sparse)
    if args.sparse:
        return sparse_main()
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
    cases = {}  # dtype: (inputs, plain outputs)
    for dt in (torch.float32, torch.bfloat16):
        q, k, v, do, _, _ = cs.flash_inputs(dev, dt, b, h, s, s, d, 0)
        want_o, lse = fa.flash_fwd_reference(q, k, v, None, None, True, sm)
        di = (want_o.float() * do.float()).sum(-1)
        want_dq, _ = fa.flash_bwd_dq_reference(q, k, v, None, None, lse, do,
                                               di, True, sm)
        want_dk, want_dv = fa.flash_bwd_dkv_reference(q, k, v, None, None,
                                                      lse, do, di, True, sm)
        cases[dt] = ((q, k, v, lse, do, di),
                     (want_o, want_dq, want_dk, want_dv))
        torch.cuda.empty_cache()
    flush = cs.l2_flusher(dev)
    times = {name: [] for name in libs}
    try:
        for name in list(libs) + list(reversed(list(libs))):
            fa._fns = fa.bind(libs[name][0])
            run = {}
            for dt, ((q, k, v, lse, do, di), wants) in cases.items():
                rtol, floor = cs.FLASH_TOL[str(dt).replace("torch.", "")]
                o, _ = fa.flash_fwd(q, k, v, None, None, True, sm)
                dq, _ = fa.flash_bwd_dq(q, k, v, None, None, lse, do, di,
                                        True, sm)
                dk, dv = fa.flash_bwd_dkv(q, k, v, None, None, lse, do, di,
                                          True, sm)
                torch.cuda.synchronize()
                errs = [cs.flash_err(got, want.float(), rtol, floor)
                        for got, want in zip((o, dq, dk, dv), wants)]
                cs.check(max(errs) <= 1, "variant %s %s: o, dq, dk, dv err "
                         "%r of the bound" % (name, dt, errs))
                del o, dq, dk, dv
                pre = "f32_" if dt == torch.float32 else ""
                run.update({
                    pre + "fwd_ms": cs.cuda_ms(lambda: fa.flash_fwd(
                        q, k, v, None, None, True, sm), flush=flush),
                    pre + "dq_ms": cs.cuda_ms(lambda: fa.flash_bwd_dq(
                        q, k, v, None, None, lse, do, di, True, sm),
                        flush=flush),
                    pre + "dkv_ms": cs.cuda_ms(lambda: fa.flash_bwd_dkv(
                        q, k, v, None, None, lse, do, di, True, sm),
                        flush=flush),
                    pre + "fwd_dropout_0.1_ms": cs.cuda_ms(
                        lambda: fa.flash_fwd(q, k, v, None, None, True, sm,
                                             0.1, 5), flush=flush)})
            times[name].append(run)
    finally:
        fa._fns = None
    for name, runs in times.items():
        print(json.dumps({"variant": name, "runs": runs}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
