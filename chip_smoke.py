"""Chip smoke of the PyTorch/CUDA port (``paddle_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It builds every CUDA kernel from ``paddle_tpu_torch/csrc`` with ``nvcc``
(one process per source, all at once) and holds each kernel against its
plain PyTorch version on the card at its main path's shapes. Then it
drives both ported paths through the entry points a user calls:

* serving: a GPT-2-small-width ``DecoderLM`` (seeded random weights)
  through ``ServingEngine.submit``/``run``; decode attention must go
  through K3, the streams must match the gather path and the no-cache
  reference, and no page may leak;
* training: the Transformer-base program of
  ``__graft_entry__._build_transformer``, built with
  ``import paddle_tpu_torch as fluid`` and trained through
  ``Executor.run`` on one fixed batch of 64 x 256 tokens; every step must
  launch K2a and K2b once, the losses must be finite and fall, and at
  batch 2 with dropout 0 the card's losses must match the CPU's.

Each phase prints one JSON line; any failed check exits non-zero. The line
before the last holds every kernel's numbers, the last line the device.

It imports neither ``jax`` nor ``paddle_tpu``, and exits non-zero without
a CUDA device.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

H100_BYTES_PER_S = 3.35e12    # HBM3, H100 SXM data sheet
H100_F32_FLOP_PER_S = 67e12   # float32 outside the tensor cores

# Transformer-base as bench.py's bench_transformer trains it
TRAIN = dict(n_layer=6, d_model=512, n_head=8, d_inner=2048, seq=256,
             vocab=30000)
TRAIN_BATCH = 64


def check(ok, msg):
    if not ok:
        raise RuntimeError("chip_smoke check failed: " + msg)


def emit(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def rel_err(got, want):
    """Largest |got - want| / |want| (|want| floored at 1e-6)."""
    return float(((got.float() - want).abs()
                  / want.abs().clamp_min(1e-6)).max())


def scaled_err(got, want, rtol):
    """Largest |got - want| / (rtol·|want| + 1e-6·max |want| of its row);
    at most 1 passes. Relative per element, so a term far below a row's
    largest value cannot hide; the row floor covers only elements that
    cancel to about 0."""
    floor = (1e-6 * want.abs().amax(dim=-1, keepdim=True)).clamp_min(1e-30)
    return float(((got.float() - want).abs()
                  / (rtol * want.abs() + floor)).max())


def cuda_ms(fn, reps=30, flush=None):
    """Median device time of ``fn()`` in ms over ``reps`` launches, each
    timed by CUDA events, with ``flush()`` (an L2 eviction) run before each
    launch outside the timed span."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def kernel_phase(dev):
    """K3 against its plain version at the serving shapes: B=16 slots,
    H=12, D=64, page_size 16, 64 pages a slot, pages scrambled over the
    pool, ragged ctx_len from 1 to 1024."""
    from paddle_tpu_torch.ops.kernels import paged_attention as pa

    rng = np.random.RandomState(0)
    b, h, d, ps, pps = 16, 12, 64, 16, 64
    num_pages = b * pps
    sm = 1.0 / d ** 0.5
    perm = rng.permutation(num_pages)
    pt_np = np.stack([perm[i::b] for i in range(b)]).astype(np.int32)
    ctx_np = np.concatenate([[1, 7, 16, 33, 500, 1024],
                             rng.randint(1, pps * ps + 1, b - 6)]
                            ).astype(np.int32)
    pt = torch.as_tensor(pt_np, device=dev)
    ctx = torch.as_tensor(ctx_np, device=dev)
    live = np.zeros(num_pages * ps, bool)
    for s in range(b):
        rows = (pt_np[s].repeat(ps) * ps + np.tile(np.arange(ps), pps))
        live[rows[:ctx_np[s]]] = True
    live_t = torch.as_tensor(live, device=dev)

    def randn(*shape):
        return torch.as_tensor(rng.randn(*shape).astype(np.float32),
                               device=dev)

    q32 = randn(b, h, d)
    k32 = randn(num_pages * ps, h, d)
    v32 = randn(num_pages * ps, h, d)
    k_bad, v_bad = k32.clone(), v32.clone()
    k_bad[~live_t] = 1e4 * randn(int((~live).sum()), h, d)
    v_bad[~live_t] = -1e4

    def kern(q, k, v):
        return pa.paged_decode_attention(q, k, v, pt, ctx, page_size=ps,
                                         sm_scale=sm)

    errs = {}
    for dt, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        q, k, v = (t.to(dt) for t in (q32, k32, v32))
        got = kern(q, k, v)
        torch.cuda.synchronize()
        want = pa.gather_reference(q.float(), k.float(), v.float(), pt, ctx,
                                   ps, sm_scale=sm)
        err = float((got.float() - want).abs().max())
        check(torch.allclose(got.float(), want, atol=tol, rtol=tol),
              "kernel vs plain (%s) max_abs_err %g > %g" % (dt, err, tol))
        poisoned = kern(q, k_bad.to(dt), v_bad.to(dt))
        check(torch.equal(poisoned, got),
              "garbage beyond ctx_len moved the kernel output (%s)" % dt)
        errs[str(dt).replace("torch.", "")] = err

    scratch = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)
    flush = scratch.zero_  # 256 MB > the 50 MB L2
    rows = (pt.long() * ps)[:, :, None] + torch.arange(ps, device=dev)
    rows = rows.reshape(b, -1)
    kg, vg = k32[rows].transpose(1, 2), v32[rows].transpose(1, 2)
    mask = (torch.arange(pps * ps, device=dev)[None, :]
            < ctx[:, None])[:, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    ms = cuda_ms(lambda: kern(q32, k32, v32), flush=flush)
    plain_ms = cuda_ms(lambda: pa.gather_reference(q32, k32, v32, pt, ctx,
                                                   ps, sm_scale=sm),
                       flush=flush)
    library_ms = cuda_ms(lambda: sdpa(q32[:, :, None], kg, vg,
                                      attn_mask=mask, scale=sm),
                         flush=flush)
    # least work: each live K/V row read once, q read once, out written once,
    # the page-table entries of live pages and ctx_len read once
    live_rows = int(ctx_np.sum())
    live_pages = int((-(-ctx_np // ps)).sum())
    nbytes = 4 * (2 * live_rows * h * d + 2 * b * h * d) \
        + 4 * (live_pages + b)
    flops = 4 * live_rows * h * d
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / H100_F32_FLOP_PER_S * 1e3
    row = {"name": "paged_decode_attention", "route": "cuda",
           "source": "paddle_tpu_torch/csrc/paged_attention.cu",
           "replaces": "paddle_tpu/ops/pallas_kernels/paged_attention.py:121",
           "launches": None, "max_abs_err": errs["float32"], "ms": ms,
           "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "library_ms": library_ms}
    emit("kernel_vs_plain", kernel="paged_decode_attention",
         shape={"B": b, "H": h, "D": d, "page_size": ps,
                "pages_per_slot": pps, "ctx_len": ctx_np.tolist()},
         max_abs_err=errs, tol={"float32": 1e-5, "bfloat16": 2e-2},
         poisoned_bit_identical=True, ms=ms, plain_ms=plain_ms,
         library_ms=library_ms, bound_ms=row["bound_ms"],
         live_bytes=nbytes)
    del scratch
    return row


def make_stream(vocab):
    """24 greedy requests: prompts of 16..900 tokens, 16..64 new tokens."""
    rng = np.random.RandomState(0)
    out = []
    for _ in range(24):
        n = int(rng.randint(16, 901))
        m = int(rng.randint(16, 65))
        out.append((rng.randint(0, vocab, n).tolist(), min(m, 1024 - n)))
    return out


def serve(model, stream, collect_logits=False):
    """Serve ``stream`` on a fresh engine; returns (engine, requests,
    seconds)."""
    from paddle_tpu_torch import serving

    eng = serving.ServingEngine(model, serving.ServingConfig(
        slots=16, page_size=16, max_seq=1024,
        collect_logits=collect_logits))
    reqs = [eng.submit(p, m) for p, m in stream]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.run()
    torch.cuda.synchronize()
    return eng, reqs, time.perf_counter() - t0


def serve_metrics(eng, reqs, secs):
    from paddle_tpu_torch.serving import metrics as sm

    ttft = sorted(r.ttft_s * 1e3 for r in reqs)
    hist = sm.DECODE_STEP_MS
    return {"tokens": sum(len(r.tokens_out) for r in reqs),
            "seconds": secs,
            "tokens_per_s": sum(len(r.tokens_out) for r in reqs) / secs,
            "ttft_p50_ms": float(np.percentile(ttft, 50)),
            "decode_dispatch_ms_mean": hist.sum / max(1, hist.count),
            "decode_dispatches": hist.count,
            "decode_steps": eng.decode_steps, "prefills": eng.prefills}


def first_divergence(a, b):
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return i
    return None if len(a) == len(b) else min(len(a), len(b))


def near_tie(logits_row, tol=1e-4):
    top2 = np.sort(np.asarray(logits_row, np.float64))[-2:]
    return float(top2[1] - top2[0]) <= tol


def serve_phase(kernel_row):
    from paddle_tpu_torch.flags import set_flag
    from paddle_tpu_torch.models import decoder_lm
    from paddle_tpu_torch.monitor import metrics
    from paddle_tpu_torch.ops.kernels import paged_attention as pa
    from paddle_tpu_torch.serving import FINISHED

    metrics.enable()
    # GPT-2 small (openai-community/gpt2 config.json), seeded random weights
    cfg = decoder_lm.DecoderConfig(vocab_size=50257, n_layer=12, d_model=768,
                                   n_head=12, max_seq=1024)
    t0 = time.perf_counter()
    model = decoder_lm.DecoderLM(cfg, seed=0)
    stream = make_stream(cfg.vocab_size)
    serve(model, stream[:2])  # warm-up: cuBLAS handles, allocator
    emit("model", config=repr(cfg),
         params=sum(p.numel() for p in model.parameters()),
         setup_s=time.perf_counter() - t0)

    set_flag("paged_attention_kernel", "auto")
    metrics.reset()
    pa.LAUNCHES = 0
    eng, reqs, secs = serve(model, stream)
    launches = pa.LAUNCHES
    check(all(r.state == FINISHED for r in reqs),
          "not every request finished")
    check(eng.page_accounting_ok(), "page accounting broken")
    check(eng.decode_kernel_info() == ("paged", "cuda"),
          "decode kernel not armed: %r" % (eng.decode_kernel_info(),))
    check(launches > 0 and launches == cfg.n_layer * eng.decode_steps,
          "kernel launches %d != n_layer %d x decode steps %d"
          % (launches, cfg.n_layer, eng.decode_steps))
    kern = serve_metrics(eng, reqs, secs)
    kernel_row["launches"] = launches
    emit("serve_kernel", launches=launches, **kern,
         stats=eng.stats())

    # the gather path, timed with the same config as the kernel serve; its
    # logits for the tie rule come from a second, untimed gather serve
    set_flag("paged_attention_kernel", "off")
    metrics.reset()
    eng_g, reqs_g, secs_g = serve(model, stream)
    gather = serve_metrics(eng_g, reqs_g, secs_g)
    eng_l, reqs_l, _ = serve(model, stream, collect_logits=True)
    set_flag("paged_attention_kernel", "auto")
    check(pa.LAUNCHES == launches, "the gather run launched the kernel")
    check(eng_g.page_accounting_ok(), "page accounting broken (gather)")
    check([g.tokens_out for g in reqs_g] == [g.tokens_out for g in reqs_l],
          "collecting logits changed the gather streams")
    ties = []
    for i, (a, g) in enumerate(zip(reqs, reqs_l)):
        pos = first_divergence(a.tokens_out, g.tokens_out)
        if pos is None:
            continue
        row = eng_l.captured_logits(g)[pos]
        check(np.isfinite(row).all() and near_tie(row),
              "request %d: kernel and gather streams diverge at token %d "
              "without a top-2 tie" % (i, pos))
        ties.append({"request": i, "token": pos})
    emit("serve_gather", **gather, diverged_at_ties=ties)

    # the engine's greedy stream against the O(S^2) no-cache reference, on
    # the two shortest requests
    short = sorted(range(len(stream)), key=lambda i: len(stream[i][0]))[:2]
    for i in short:
        prompt, m = stream[i]
        toks, logits = decoder_lm.reference_decode(model.params, cfg,
                                                   prompt, m)
        check(all(np.isfinite(x).all() for x in logits),
              "reference logits not finite")
        pos = first_divergence(reqs[i].tokens_out, toks)
        if pos is not None:
            check(near_tie(logits[pos]),
                  "request %d: engine and no-cache reference diverge at "
                  "token %d without a top-2 tie" % (i, pos))
    emit("reference", requests=short, agree=True)
    profile_phase(model, stream)


def profile_phase(model, stream):
    """Where the serve time goes: the kernel-path serve once more under
    torch.profiler; device busy share = kernel time summed over the CUDA
    events / wall time of the run (the profiler's own host cost is in the
    wall time), and the largest kernels by device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, _, secs = serve(model, stream)
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kern) / 1e3
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:8]
    emit("serve_profile", wall_ms=secs * 1e3, device_busy_ms=busy_ms,
         device_busy_share=busy_ms / (secs * 1e3) if busy_ms else None,
         kernels_launched=sum(e.count for e in kern),
         top=[{"name": e.key[:80], "count": e.count,
               "device_ms": e.self_device_time_total / 1e3} for e in top])


def xent_kernel_phase(dev):
    """K2a/K2b against their plain versions at the Transformer-base loss
    shape: N = 64 x 256 rows, V = 30000, label smoothing 0.1, a few rows
    labelled -100. The loss to 1e-5 relative in both dtypes (bf16 logits
    upcast exactly, so the plain version in float32 sees the same inputs);
    dlogits to 1e-6 absolute in float32, and in bf16 each element to
    2e-2·|want| + 1e-6·(max |want| of its row), a bound that a missing
    eps/V term (~|g|·3e-6 here) breaks."""
    from paddle_tpu_torch.ops.kernels import softmax_xent as sx

    n, v, eps = TRAIN_BATCH * TRAIN["seq"], TRAIN["vocab"], 0.1
    rng = np.random.RandomState(0)
    x32 = torch.as_tensor((rng.randn(n, v) * 2).astype(np.float32),
                          device=dev)
    lab_np = rng.randint(0, v, n).astype(np.int64)
    lab_np[rng.choice(n, 16, replace=False)] = -100
    lab = torch.as_tensor(lab_np, device=dev)
    # an O(1) upstream gradient, so the absolute dlogits tolerance means
    # something (the training step's is 1/N, which would hide errors)
    g = torch.as_tensor(rng.randn(n, 1).astype(np.float32), device=dev)

    errs = {}
    keep = (lab != -100)[:, None]
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt).replace("torch.", "")
        x = x32.to(dt)
        loss, lse = sx.softmax_xent_fwd(x, lab, eps)
        dx = sx.softmax_xent_bwd(x, lab, lse, g, eps)
        torch.cuda.synchronize()
        # bf16 -> float32 is exact, so both sides see the same inputs
        want_loss, want_lse = sx.softmax_xent_reference(x.float(), lab, eps)
        want_dx = sx.softmax_xent_reference_bwd(x.float(), lab, want_lse, g,
                                                eps)
        e_loss = float((loss - want_loss).abs().max())
        e_rel = rel_err(loss, want_loss)
        e_dx = float((dx.float() - want_dx).abs().max())
        check(e_rel <= 1e-5, "K2a %s loss rel err %g > 1e-5" % (name, e_rel))
        if dt == torch.float32:
            check(e_dx <= 1e-6, "K2b f32 dlogits abs err %g > 1e-6" % e_dx)
            e_scaled = None
        else:
            e_scaled = scaled_err(dx, want_dx, 2e-2)
            check(e_scaled <= 1, "K2b bf16 dlogits err %g of its bound "
                  "(2e-2 |want| + 1e-6 row max)" % e_scaled)
            # planted faults: the same checks reject a loss without the
            # (eps/V)·Σx term and dlogits without the eps/V term
            no_sum = torch.where(keep, want_loss + (eps / v) * x.float().sum(
                dim=-1, keepdim=True), 0.0)
            check(rel_err(no_sum, want_loss) > 1e-5,
                  "the loss check passes a loss without its (eps/V)·Σx term")
            no_eps = torch.where(keep, want_dx + g * (eps / v), 0.0).to(dt)
            check(scaled_err(no_eps, want_dx, 2e-2) > 1,
                  "the bf16 dlogits check passes dlogits without eps/V")
            del no_sum, no_eps
        check(bool(dx.dtype == dt), "dlogits dtype %s != %s" % (dx.dtype, dt))
        check(not loss[lab == -100].any() and not dx[lab == -100].any(),
              "rows labelled -100 not zeroed")
        errs[name] = {"loss_abs": e_loss, "loss_rel": e_rel,
                      "dlogits_abs": e_dx, "dlogits_scaled": e_scaled}
        del loss, lse, dx, want_loss, want_lse, want_dx

    scratch = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)
    flush = scratch.zero_  # 256 MB > the 50 MB L2
    F = torch.nn.functional
    loss, lse = sx.softmax_xent_fwd(x32, lab, eps)
    fwd_ms = cuda_ms(lambda: sx.softmax_xent_fwd(x32, lab, eps), flush=flush)
    fwd_plain = cuda_ms(lambda: sx.softmax_xent_reference(x32, lab, eps),
                        flush=flush)
    fwd_lib = cuda_ms(lambda: F.cross_entropy(
        x32, lab, reduction="none", label_smoothing=eps), flush=flush)
    bwd_ms = cuda_ms(lambda: sx.softmax_xent_bwd(x32, lab, lse, g, eps),
                     flush=flush)
    bwd_plain = cuda_ms(lambda: sx.softmax_xent_reference_bwd(
        x32, lab, lse, g, eps), flush=flush)
    xr = x32.detach().requires_grad_(True)
    lib_loss = F.cross_entropy(xr, lab, reduction="none",
                               label_smoothing=eps)
    g1 = g.reshape(-1)
    bwd_lib = cuda_ms(lambda: torch.autograd.grad(
        lib_loss, [xr], g1, retain_graph=True), flush=flush)
    del xr, lib_loss, scratch

    def row(name, fn_line, ms, plain, lib, nbytes, flops, err):
        t_bytes = nbytes / H100_BYTES_PER_S * 1e3
        t_ops = flops / H100_F32_FLOP_PER_S * 1e3
        return {"name": name, "route": "cuda",
                "source": "paddle_tpu_torch/csrc/softmax_xent.cu",
                "replaces": "paddle_tpu/ops/pallas_kernels/softmax_xent.py:"
                            + fn_line,
                "launches": None, "max_abs_err": err, "ms": ms,
                "plain_ms": plain, "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "library_ms": lib}

    # least work, float32: K2a reads the logits and labels once and writes
    # loss and lse; K2b reads logits, labels, lse and g once and writes
    # dlogits. Operations: K2a an exp, a max, 2 adds and a compare per
    # element; K2b an exp, a sub, a compare, a sub and a mul.
    nv = n * v
    rows = [row("softmax_xent_fwd", "164", fwd_ms, fwd_plain, fwd_lib,
                4 * nv + 8 * n + 8 * n, 5 * nv, errs["float32"]["loss_abs"]),
            row("softmax_xent_bwd", "208", bwd_ms, bwd_plain, bwd_lib,
                8 * nv + 8 * n + 8 * n, 5 * nv,
                errs["float32"]["dlogits_abs"])]
    emit("kernel_vs_plain", kernel="softmax_xent",
         shape={"N": n, "V": v, "smooth": eps, "ignored_rows": 16},
         max_err=errs, tol={"float32": {"loss_rel": 1e-5, "dlogits_abs": 1e-6},
                            "bfloat16": {"loss_rel": 1e-5,
                                         "dlogits_scaled": 1.0}},
         fwd={"ms": fwd_ms, "plain_ms": fwd_plain, "library_ms": fwd_lib,
              "bound_ms": rows[0]["bound_ms"]},
         bwd={"ms": bwd_ms, "plain_ms": bwd_plain, "library_ms": bwd_lib,
              "bound_ms": rows[1]["bound_ms"]})
    del x32, lab, g, loss, lse
    torch.cuda.empty_cache()
    return rows


def build_transformer(fluid, n_layer, d_model, n_head, d_inner, seq, vocab,
                      train, dropout=None):
    """``__graft_entry__._build_transformer``, for the port's package."""
    from paddle_tpu_torch.models import transformer as tfm

    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 7
    with fluid.program_guard(main, startup):
        with fluid.unique_name.guard():
            src = fluid.layers.data("src", shape=[seq], dtype="int64")
            trg = fluid.layers.data("trg", shape=[seq], dtype="int64")
            lbl = fluid.layers.data("lbl", shape=[seq, 1], dtype="int64")
            smask = fluid.layers.data("smask", shape=[seq], dtype="float32")
            tmask = fluid.layers.data("tmask", shape=[seq], dtype="float32")
            logits, loss = tfm.transformer(
                src, trg, lbl, smask, tmask,
                src_vocab_size=vocab, trg_vocab_size=vocab, max_length=seq,
                n_layer=n_layer, n_head=n_head, d_model=d_model,
                d_inner=d_inner,
                dropout_rate=(0.1 if train else 0.0) if dropout is None
                else dropout,
                label_smooth_eps=0.1, is_test=not train)
            if train:
                fluid.optimizer.Adam(learning_rate=1e-4).minimize(loss)
    return main, startup, loss, logits


def train_feed(batch):
    """The fixed batch of bench.py's bench_transformer."""
    seq, vocab = TRAIN["seq"], TRAIN["vocab"]
    rng = np.random.RandomState(0)
    return {
        "src": rng.randint(2, vocab, (batch, seq)).astype("int64"),
        "trg": rng.randint(2, vocab, (batch, seq)).astype("int64"),
        "lbl": rng.randint(2, vocab, (batch, seq, 1)).astype("int64"),
        "smask": np.ones((batch, seq), "float32"),
        "tmask": np.ones((batch, seq), "float32"),
    }


def train_steps(exe, main, loss, feed, scope, n):
    """n training steps; returns (losses, seconds of each step). A step
    ends with its loss on the host, so its time is the device's too."""
    losses, secs = [], []
    for _ in range(n):
        t0 = time.perf_counter()
        lv, = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        secs.append(time.perf_counter() - t0)
        losses.append(float(lv))
    return losses, secs


def train_phase(xent_rows):
    """Transformer-base at full width through the port's Fluid API: 2
    warm-up steps, then 10 timed steps on one fixed batch."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.ops.kernels import softmax_xent as sx

    t0 = time.perf_counter()
    main, startup, loss, _ = build_transformer(fluid, train=True, **TRAIN)
    build_s = time.perf_counter() - t0
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CUDAPlace(0))
    exe.run(startup, scope=scope)
    torch.cuda.synchronize()
    params = main.all_parameters()
    n_weights = sum(int(np.prod(p.shape)) for p in params)
    ops = [op.type for op in main.global_block.ops]
    emit("train_model", config=TRAIN, batch=TRAIN_BATCH,
         params=len(params), weights=n_weights, ops=len(ops),
         op_types=len(set(ops)), adam_ops=ops.count("adam"),
         build_s=build_s, setup_s=time.perf_counter() - t0)
    feed = train_feed(TRAIN_BATCH)
    warm, _ = train_steps(exe, main, loss, feed, scope, 2)
    torch.cuda.reset_peak_memory_stats()
    sx.LAUNCHES_FWD = sx.LAUNCHES_BWD = 0
    losses, secs = train_steps(exe, main, loss, feed, scope, 10)
    fwd, bwd = sx.LAUNCHES_FWD, sx.LAUNCHES_BWD
    peak = torch.cuda.max_memory_allocated()
    all_losses = warm + losses
    check(bool(np.isfinite(all_losses).all()), "non-finite training loss")
    check(all_losses[-1] < all_losses[0],
          "loss did not fall: %r" % all_losses)
    check(fwd == len(losses) and bwd == len(losses),
          "K2 launches fwd %d bwd %d over %d steps" % (fwd, bwd, len(losses)))
    xent_rows[0]["launches"], xent_rows[1]["launches"] = fwd, bwd
    step_ms = float(np.median(secs)) * 1e3
    emit("train", steps=len(losses), step_ms_median=step_ms,
         step_ms=[s * 1e3 for s in secs],
         target_tokens_per_s=TRAIN_BATCH * TRAIN["seq"] / (step_ms / 1e3),
         peak_memory_bytes=peak, losses=all_losses,
         k2_launches={"fwd": fwd, "bwd": bwd})
    train_profile_phase(exe, main, loss, feed, scope)
    del scope, exe
    torch.cuda.empty_cache()


def train_profile_phase(exe, main, loss, feed, scope):
    """Where a training step's time goes: one step under torch.profiler;
    device busy share = kernel time summed over the CUDA events / wall time
    of the step (the profiler's host cost is in the wall time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, secs = train_steps(exe, main, loss, feed, scope, 1)
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kern) / 1e3
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:10]
    emit("train_profile", wall_ms=secs[0] * 1e3, device_busy_ms=busy_ms,
         device_busy_share=busy_ms / (secs[0] * 1e3) if busy_ms else None,
         kernels_launched=sum(e.count for e in kern),
         top=[{"name": e.key[:80], "count": e.count,
               "device_ms": e.self_device_time_total / 1e3} for e in top])


def train_parity_phase():
    """The training program at full width, batch 2, dropout 0: two steps
    on the card and two on the CPU (the plain versions) from the same
    startup state, carried by io.state_from_numpy. TF32 is off, so both
    run float32 products; the losses must agree to 1e-4 relative."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.ops.kernels import softmax_xent as sx

    main, startup, loss, _ = build_transformer(fluid, train=True, dropout=0.0,
                                               **TRAIN)
    feed = train_feed(2)
    card = fluid.Scope()
    exe = fluid.Executor(fluid.CUDAPlace(0))
    exe.run(startup, scope=card)
    arrays = {n: card.as_numpy(n) for n in card.vars}
    f0, b0 = sx.LAUNCHES_FWD, sx.LAUNCHES_BWD
    card_losses, _ = train_steps(exe, main, loss, feed, card, 2)
    check((sx.LAUNCHES_FWD - f0, sx.LAUNCHES_BWD - b0) == (2, 2),
          "the card run launched K2a %d and K2b %d times over 2 steps"
          % (sx.LAUNCHES_FWD - f0, sx.LAUNCHES_BWD - b0))
    cpu = fluid.io.state_from_numpy(main, arrays, fluid.Scope(),
                                    fluid.CPUPlace())
    t0 = time.perf_counter()
    cpu_losses, _ = train_steps(fluid.Executor(fluid.CPUPlace()), main, loss,
                                feed, cpu, 2)
    check((sx.LAUNCHES_FWD - f0, sx.LAUNCHES_BWD - b0) == (2, 2),
          "the CPU run launched a kernel")
    rel = [abs(a - b) / abs(b) for a, b in zip(card_losses, cpu_losses)]
    check(bool(np.isfinite(card_losses + cpu_losses).all())
          and max(rel) <= 1e-4,
          "card %r vs CPU %r losses (rel %r > 1e-4)"
          % (card_losses, cpu_losses, rel))
    emit("train_parity", batch=2, dropout=0.0, card_losses=card_losses,
         cpu_losses=cpu_losses, rel_err=rel, tol=1e-4,
         cpu_s=time.perf_counter() - t0)
    del card, cpu
    torch.cuda.empty_cache()


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "needs a CUDA GPU", file=sys.stderr)
        return 1
    # the port comes from the checkout beside this file; without it the
    # import fails here, before anything is printed
    from paddle_tpu_torch.ops.kernels import _build

    # float32 products stay full float32 on the card (no TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    emit("device", nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, device=torch.cuda.get_device_name(0))
    t0 = time.perf_counter()
    secs = _build.build_all()
    emit("build", seconds=time.perf_counter() - t0, kernels=secs)
    dev = torch.device("cuda", torch.cuda.current_device())
    row = kernel_phase(dev)
    xent_rows = xent_kernel_phase(dev)
    serve_phase(row)
    train_phase(xent_rows)
    train_parity_phase()
    print(json.dumps({"kernels": [row] + xent_rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
