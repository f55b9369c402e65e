"""Chip smoke of the PyTorch/CUDA port (``paddle_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It builds every CUDA kernel from ``paddle_tpu_torch/csrc`` with ``nvcc``
(one process per source, all at once) and holds each kernel against its
plain PyTorch version on the card at its main path's shapes. Then it
drives the ported paths through the entry points a user calls:

* serving: a GPT-2-small-width ``DecoderLM`` (seeded random weights)
  through ``ServingEngine.submit``/``run``; decode attention must go
  through K3, the streams must match the gather path and the no-cache
  reference, and no page may leak;
* training: the Transformer-base program of
  ``__graft_entry__._build_transformer``, built with
  ``import paddle_tpu_torch as fluid`` and trained through
  ``Executor.run`` on one fixed batch of 64 x 256 tokens; every step must
  launch K2a and K2b once, the losses must be finite and fall, and at
  batch 2 with dropout 0 the card's losses must match the CPU's;
* long-context training: the causal LM of ``bench.py``'s
  ``bench_longseq_train`` (12 layers, d_model 1024, 16 heads, vocab 32000,
  batch 8 x 2048 tokens, Adam) at full width and depth, once in float32
  and once under ``fluid.amp.decorate`` (bfloat16); every step must launch
  K1a, K1b and K1c once a layer and K2a, K2b once, the losses must be
  finite and fall, and at batch 1 x 256 tokens, 2 layers, dropout 0 the
  card's losses must match the CPU's, in float32 and under AMP;
* CTR training: DeepFM as ``bench.py``'s ``bench_deepfm`` builds and feeds
  it (V = 1e6, 26 fields, embedding 10, 13 dense features, deep layers
  400-400-400, batch 1024) with ``is_sparse`` tables, once under Adam and
  once under SGD; every Adam step must launch K4a twice (one a table) and
  K2a, K2b once, every SGD step K4b twice, the losses must be finite and
  fall; at V = 5e7 the sparse step must allocate no [V, D] gradient, and at
  V = 1e4, batch 64 the card's losses and state must match the CPU's.

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
SPIN_CYCLES = 1_000_000       # ~0.5 ms at the H100's 1.98 GHz boost clock

# Transformer-base as bench.py's bench_transformer trains it
TRAIN = dict(n_layer=6, d_model=512, n_head=8, d_inner=2048, seq=256,
             vocab=30000)
TRAIN_BATCH = 64

# the causal LM as bench.py's bench_longseq_train trains it
LONGCTX = dict(vocab_size=32000, n_layer=12, n_head=16, d_model=1024,
               d_inner=4096)
LONGCTX_BATCH, LONGCTX_SEQ = 8, 2048
H100_BF16_FLOP_PER_S = 989e12  # dense bf16 on the tensor cores

# DeepFM as bench.py's bench_deepfm trains it
CTR = dict(sparse_feature_dim=1_000_000, embedding_size=10, num_fields=26,
           layer_sizes=(400, 400, 400))
CTR_BATCH, CTR_DENSE = 1024, 13
CTR_BIG_V = 50_000_000  # the largest V of bench.py's sweep one card holds


def check(ok, msg):
    if not ok:
        raise RuntimeError("chip_smoke check failed: " + msg)


def emit(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def rel_err(got, want):
    """Largest |got - want| / |want| (|want| floored at 1e-6)."""
    return float(((got.float() - want).abs()
                  / want.abs().clamp_min(1e-6)).max())


def scaled_err(got, want, rtol, floor=1e-6, scale=None):
    """Largest |got - want| / (rtol·|want| + floor·scale); at most 1
    passes. ``scale`` is max |want| of each row unless given. Relative per
    element, so a term far below a row's largest value cannot hide; the
    floor covers only elements that cancel to about 0."""
    if scale is None:
        scale = want.abs().amax(dim=-1, keepdim=True)
    floor = (floor * scale).clamp_min(1e-30)
    return float(((got.float() - want).abs()
                  / (rtol * want.abs() + floor)).max())


def flash_err(got, want, rtol, floor):
    """``scaled_err`` of a [B,H,S,D] flash output whose row floor is at
    least 1e-3 of its head's largest |want|. A row that sees one position
    (causal row 0, the first row of a segment) has dp = di, so ds and dq
    are 0 in exact arithmetic and a rounding residue in any finite one, at
    3e-8 to 1e-7 of the head's scale: another summation order, even a
    float64 one, moves it by all of itself. Every other row keeps its own
    floor."""
    row = want.abs().amax(dim=-1, keepdim=True)
    head = row.amax(dim=-2, keepdim=True)
    return scaled_err(got, want, rtol, floor, torch.maximum(row, 1e-3 * head))


def l2_flusher(dev):
    """A function that evicts the 50 MB L2 by reading a 256 MB buffer. A
    read leaves the L2 holding clean lines, so the timed launch after it
    pays no write-back. (Zeroing a buffer instead leaves dirty lines whose
    write-back lands in the next launch's time: a few microseconds, nothing
    for a millisecond kernel, much of a microsecond one's.)"""
    buf = torch.ones(64 * 2 ** 20, dtype=torch.float32, device=dev)
    return buf.sum


def cuda_ms(fn, reps=30, flush=None):
    """Median device time of ``fn()`` in ms over ``reps`` launches, each
    timed by CUDA events, with ``flush()`` (an L2 eviction) run before each
    launch outside the timed span. A spin of ~0.5 ms on the card follows the
    flush, so the host has enqueued the timed launch before the card
    reaches it: the span holds the launch, not the host's Python around it
    (which a microsecond kernel would otherwise measure)."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush()
        torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


# chunk sizes of K3 held against the plain version and timed (the source's
# is paged_attention.CHUNK_ROWS)
CHUNK_SIZES = (32, 64, 128, 256)
K3_DESIGN = "context split in chunks, one block a (chunk, head, slot), " \
    "16-byte loads, partials merged in chunk order in the same launch"


def kernel_phase(dev):
    """K3 against its plain version at the serving shapes: B=16 slots,
    H=12, D=64, page_size 16, 64 pages a slot, pages scrambled over the
    pool, ragged ctx_len from 1 to 1024; two launches on the same inputs
    bit-equal; a tail case (one slot at ctx 1024, fifteen at 1); then the
    times beside bound, plain version and library call, and the kernel at
    other chunk sizes."""
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

    def kern(q, k, v, ctx_=ctx):
        return pa.paged_decode_attention(q, k, v, pt, ctx_, page_size=ps,
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
        check(torch.equal(kern(q, k, v), got),
              "two launches on the same inputs differ (%s)" % dt)
        errs[str(dt).replace("torch.", "")] = err
    # the tail: one slot walks 1024 rows, the other fifteen one each
    tail_np = np.asarray([pps * ps] + [1] * (b - 1), np.int32)
    tail = torch.as_tensor(tail_np, device=dev)
    tail_errs = {}
    for dt, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        q, k, v = (t.to(dt) for t in (q32, k32, v32))
        got = kern(q, k, v, tail)
        torch.cuda.synchronize()
        want = pa.gather_reference(q.float(), k.float(), v.float(), pt, tail,
                                   ps, sm_scale=sm)
        err = float((got.float() - want).abs().max())
        check(torch.allclose(got.float(), want, atol=tol, rtol=tol),
              "tail case (%s) max_abs_err %g > %g" % (dt, err, tol))
        tail_errs[str(dt).replace("torch.", "")] = err
    # every chunk size timed below is held against the plain version too
    want32 = pa.gather_reference(q32, k32, v32, pt, ctx, ps, sm_scale=sm)
    for rows_ in CHUNK_SIZES:
        got = pa._launch(q32, k32, v32, pt, ctx, ps, sm, rows_)
        torch.cuda.synchronize()
        check(torch.allclose(got, want32, atol=1e-5, rtol=1e-5),
              "chunks of %d rows: max_abs_err %g" % (
                  rows_, float((got - want32).abs().max())))

    flush = l2_flusher(dev)
    rows = (pt.long() * ps)[:, :, None] + torch.arange(ps, device=dev)
    rows = rows.reshape(b, -1)
    kg, vg = k32[rows].transpose(1, 2), v32[rows].transpose(1, 2)
    mask = (torch.arange(pps * ps, device=dev)[None, :]
            < ctx[:, None])[:, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    ms = cuda_ms(lambda: kern(q32, k32, v32), flush=flush)
    # after a flush that writes (zeroing 256 MB), for comparison
    dirty = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)
    ms_dirty = cuda_ms(lambda: kern(q32, k32, v32), flush=dirty.zero_)
    del dirty
    plain_ms = cuda_ms(lambda: pa.gather_reference(q32, k32, v32, pt, ctx,
                                                   ps, sm_scale=sm),
                       flush=flush)
    library_ms = cuda_ms(lambda: sdpa(q32[:, :, None], kg, vg,
                                      attn_mask=mask, scale=sm),
                         flush=flush)
    chunk_ms = {rows_: cuda_ms(lambda: pa._launch(q32, k32, v32, pt, ctx, ps,
                                                  sm, rows_), flush=flush)
                for rows_ in CHUNK_SIZES}
    tail_chunk_ms = {rows_: cuda_ms(lambda: pa._launch(
        q32, k32, v32, pt, tail, ps, sm, rows_), flush=flush)
        for rows_ in CHUNK_SIZES}
    tail_plain_ms = cuda_ms(lambda: pa.gather_reference(
        q32, k32, v32, pt, tail, ps, sm_scale=sm), flush=flush)

    # least work: each live K/V row read once, q read once, out written once,
    # the page-table entries of live pages and ctx_len read once
    def bound(ctx_np_):
        live_rows = int(ctx_np_.sum())
        live_pages = int((-(-ctx_np_ // ps)).sum())
        nbytes = 4 * (2 * live_rows * h * d + 2 * b * h * d) \
            + 4 * (live_pages + b)
        t_bytes = nbytes / H100_BYTES_PER_S * 1e3
        t_ops = 4 * live_rows * h * d / H100_F32_FLOP_PER_S * 1e3
        return nbytes, max(t_bytes, t_ops), \
            "bytes" if t_bytes >= t_ops else "operations"

    nbytes, bound_ms, bound_by = bound(ctx_np)
    tail_bound_ms = bound(tail_np)[1]
    row = {"name": "paged_decode_attention", "route": "cuda",
           "source": "paddle_tpu_torch/csrc/paged_attention.cu",
           "replaces": "paddle_tpu/ops/pallas_kernels/paged_attention.py:198",
           "launches": None, "max_abs_err": errs["float32"], "ms": ms,
           "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
           "library_ms": library_ms, "ms_after_write_flush": ms_dirty,
           "design": K3_DESIGN, "chunk_rows": pa.CHUNK_ROWS,
           "ms_by_chunk_rows": chunk_ms,
           "tail": {"ctx_len": "1024 and fifteen of 1",
                    "ms": tail_chunk_ms[pa.CHUNK_ROWS],
                    "plain_ms": tail_plain_ms, "bound_ms": tail_bound_ms,
                    "max_abs_err": tail_errs,
                    "ms_by_chunk_rows": tail_chunk_ms}}
    emit("kernel_vs_plain", kernel="paged_decode_attention",
         shape={"B": b, "H": h, "D": d, "page_size": ps,
                "pages_per_slot": pps, "ctx_len": ctx_np.tolist()},
         max_abs_err=errs, tol={"float32": 1e-5, "bfloat16": 2e-2},
         poisoned_bit_identical=True, two_launches_bit_equal=True, ms=ms,
         plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
         live_bytes=nbytes, ms_after_write_flush=ms_dirty,
         chunk_rows=pa.CHUNK_ROWS, ms_by_chunk_rows=chunk_ms,
         tail=row["tail"])
    del flush
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

    flush = l2_flusher(dev)
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
    del xr, lib_loss, flush

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
    warm-up steps, then 6 timed steps on one fixed batch."""
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
    losses, secs = train_steps(exe, main, loss, feed, scope, 6)
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


def train_profile_phase(exe, main, loss, feed, scope,
                        phase="train_profile"):
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
    emit(phase, wall_ms=secs[0] * 1e3, device_busy_ms=busy_ms,
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


# float32: another summation order over up to 2048 terms. bfloat16: outputs
# are rounded to bf16 (4e-3 relative), and p and ds are rounded before their
# products against a running row maximum in the kernel, the final one in the
# plain version; elements that cancel are held to a share of their row's
# largest value.
FLASH_TOL = {"float32": (1e-4, 1e-5), "bfloat16": (2e-2, 1e-2)}
# what each float32 kernel is built from (csrc/flash_attention.cu)
F32_DESIGN = {"fwd": "fma f32, 4x8 register tiles, cp.async ring",
              "dkv": "fma f32, 4x8 register tiles, cp.async ring, lean",
              "dq": "fma f32, 4x8 register tiles, cp.async ring"}


def flash_inputs(dev, dt, b, h, sq, sk, d, seed, bias=False, seg=False,
                 ab_dtype=None):
    """q, k, v, do as the attention op receives them: q, k, v are the head
    views of one fused [B,S,3·H·D] projection (when Sq == Sk), do a
    transposed [B,S,H,D] tensor; a bias broadcast over heads, of dtype
    ``ab_dtype`` (q's by default); sorted segment ids shared by q and
    kv."""
    from paddle_tpu_torch.ops.kernels import flash_attention as fa

    gen = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(dt)

    if sq == sk:
        q, k, v = (t.reshape(b, sq, h, d).transpose(1, 2) for t in
                   randn(b, sq, 3 * h * d).split(h * d, dim=2))
    else:
        q = randn(b, sq, h, d).transpose(1, 2)
        k, v = (randn(b, sk, h, d).transpose(1, 2) for _ in range(2))
    do = randn(b, sq, h, d).transpose(1, 2)
    ab = None
    if bias:
        ab = torch.randn(b, 1, sq, sk, generator=gen, device=dev).to(
            ab_dtype or dt).expand(b, h, sq, sk)
    ids = None
    if seg:
        base = torch.randint(0, 3, (b, max(sq, sk)), generator=gen,
                             device=dev).sort(dim=-1).values
        ids = fa.SegmentIds(base[:, :sq], base[:, :sk])
    return q, k, v, do, ab, ids


def flash_check(name, dt, q, k, v, do, ab, ids, causal, sm, rate, seed):
    """K1a, K1b, K1c against their plain versions on the same tensors;
    returns the largest absolute error of each output. The backward
    kernels get the plain forward's lse and di, so each is held alone."""
    from paddle_tpu_torch.ops.kernels import flash_attention as fa

    dname = str(dt).replace("torch.", "")
    rtol, floor = FLASH_TOL[dname]
    o, lse = fa.flash_fwd(q, k, v, ab, ids, causal, sm, rate, seed)
    torch.cuda.synchronize()
    want_o, want_lse = fa.flash_fwd_reference(q, k, v, ab, ids, causal, sm,
                                              rate, seed)
    di = (want_o.float() * do.float()).sum(-1)
    args = (q, k, v, ab, ids, want_lse, do, di, causal, sm, rate, seed)
    dk, dv = fa.flash_bwd_dkv(*args)
    dq, dab = fa.flash_bwd_dq(*args)
    torch.cuda.synchronize()
    want_dk, want_dv = fa.flash_bwd_dkv_reference(*args)
    want_dq, want_dab = fa.flash_bwd_dq_reference(*args)
    live = torch.isfinite(want_lse)  # a row that sees nothing has +inf
    check(torch.equal(torch.isfinite(lse), live),
          "%s %s: other dead rows than the plain version" % (name, dname))
    e_lse = float((lse[live] - want_lse[live]).abs().max())
    check(e_lse <= 2e-5 + 1e-5 * float(want_lse[live].abs().max()),
          "%s %s lse abs err %g" % (name, dname, e_lse))
    errs = {"lse": e_lse}
    pairs = [("o", o, want_o), ("dk", dk, want_dk), ("dv", dv, want_dv),
             ("dq", dq, want_dq)]
    if ab is not None:
        pairs.append(("dab", dab, want_dab))
    for out, got, want in pairs:
        want_dt = ab.dtype if out == "dab" else dt  # dab in the bias's dtype
        check(got.dtype == want_dt, "%s %s dtype %s" % (name, out, got.dtype))
        e = flash_err(got, want.float(), rtol, floor)
        check(e <= 1, "%s %s %s err %g of its bound (%g |want| + %g row max)"
              % (name, dname, out, e, rtol, floor))
        errs[out] = float((got.float() - want.float()).abs().max())
    return errs


def flash_planted_faults(dev):
    """The check must reject a causal mask off by one, a ds without its
    − di, and dk, dv whose loop over the q tiles stops one tile early, in
    both dtypes' tolerances (the bfloat16 one is the looser)."""
    from paddle_tpu_torch.ops.kernels import flash_attention as fa

    b, h, s, d = 2, 4, 256, 64
    sm = d ** -0.5
    q, k, v, do, _, _ = flash_inputs(dev, torch.float32, b, h, s, s, d, 5)
    want_o, lse = fa.flash_fwd_reference(q, k, v, None, None, True, sm)
    di = (want_o * do).sum(-1)
    want_dq, _ = fa.flash_bwd_dq_reference(q, k, v, None, None, lse, do, di,
                                           True, sm)
    # every row sees one position too many
    late = torch.ones(s, s, device=dev).tril(diagonal=1).log()
    bad_o, _ = fa.flash_fwd_reference(q, k, v, late.expand(b, h, s, s), None,
                                      False, sm)
    # ds = p·dp, the row term left out
    bad_dq, _ = fa.flash_bwd_dq_reference(q, k, v, None, None, lse, do,
                                          torch.zeros_like(di), True, sm)
    want_dk, want_dv = fa.flash_bwd_dkv_reference(q, k, v, None, None, lse,
                                                  do, di, True, sm)
    # the last 64 q rows left out of dk and dv
    n = s - 64
    bad_dk, bad_dv = fa.flash_bwd_dkv_reference(
        q[:, :, :n], k, v, None, None, lse[:, :, :n], do[:, :, :n],
        di[:, :, :n], True, sm)
    for rtol, floor in FLASH_TOL.values():
        check(flash_err(bad_o, want_o, rtol, floor) > 1,
              "the flash check passes a causal mask off by one")
        check(flash_err(bad_dq, want_dq, rtol, floor) > 1,
              "the flash check passes a ds without its - di")
        check(flash_err(bad_dk, want_dk, rtol, floor) > 1
              and flash_err(bad_dv, want_dv, rtol, floor) > 1,
              "the flash check passes dk, dv without the last q tile")


def flash_crossover(dev):
    """Forward + backward of ``sdpa`` through the kernels and composed, at
    B·S = 16384 tokens, 16 heads of 64, causal: where the kernels overtake
    the composed path on this card."""
    from paddle_tpu_torch.flags import set_flag
    from paddle_tpu_torch.ops import attention_ops as ao

    flush = l2_flusher(dev)
    h, d = LONGCTX["n_head"], LONGCTX["d_model"] // LONGCTX["n_head"]
    rows = []
    for s in (512, 1024, 2048, 4096):
        b = LONGCTX_BATCH * LONGCTX_SEQ // s
        for dt in (torch.float32, torch.bfloat16):
            q, k, v, do, _, _ = flash_inputs(dev, dt, b, h, s, s, d, s)
            q, k, v = (t.detach().requires_grad_(True) for t in (q, k, v))

            def fwd_bwd():
                o = ao.sdpa(q, k, v, causal=True, sm_scale=d ** -0.5)
                torch.autograd.grad(o, [q, k, v], do)

            ms = {}
            for route, min_seq in (("flash", 1), ("composed", 1 << 30)):
                set_flag("flash_attention_min_seq", min_seq)
                ms[route] = cuda_ms(fwd_bwd, reps=10, flush=flush)
            rows.append({"S": s, "B": b,
                         "dtype": str(dt).replace("torch.", ""),
                         "flash_ms": ms["flash"],
                         "composed_ms": ms["composed"]})
            del q, k, v, do
            torch.cuda.empty_cache()
    set_flag("flash_attention_min_seq", 2048)
    emit("flash_crossover", heads=h, head_dim=d, causal=True,
         fwd_plus_bwd=rows)


def flash_sass_hmma():
    """Tensor-core instructions (HMMA, and Hopper's HGMMA) in each kernel of
    the built flash library, from ``cuobjdump -sass`` (the toolkit's,
    beside nvcc): every instantiation of the bfloat16 forward, dK/dV and dQ
    kernels (one a head width and bias type: bfloat16 or none, float32)
    must hold HMMA; the float32 kernels (FFMA tiles) must hold
    neither. Returns ({kernel and its mangled template arguments: HMMA
    count}, {the same: HGMMA count})."""
    import re
    from pathlib import Path

    from paddle_tpu_torch.ops.kernels import _build

    tool = Path(_build.nvcc_path()).parent / "cuobjdump"
    check(tool.exists(), "no cuobjdump beside nvcc at %s" % tool)
    lib = _build._lib_path(_build.SRC_DIR / "flash_attention.cu")
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            counts[name] = [0, 0]
        elif name is not None:
            counts[name][0] += bool(re.search(r"\bHMMA\b", line))
            counts[name][1] += bool(re.search(r"\bHGMMA\b", line))
    hmma, hgmma = {}, {}
    for full, (n, ng) in counts.items():
        m = re.search(r"\d(flash_\w+?_kernel)I", full)  # <length><name>I
        if m:
            hmma[full[m.start(1):]] = n
            hgmma[full[m.start(1):]] = ng
    for kern in ("flash_fwd_bf16_kernel", "flash_dkv_bf16_kernel",
                 "flash_dq_bf16_kernel"):
        mine = {k: n for k, n in hmma.items() if k.startswith(kern + "I")}
        check(len(mine) == 6 and all(mine.values()),
              "%s: HMMA counts %r (want one instantiation a head width and "
              "bias type, each on the tensor cores)" % (kern, mine))
    for kern in ("flash_fwd_kernel", "flash_dkv_kernel", "flash_dq_kernel"):
        mine = {k: (n, hgmma[k]) for k, n in hmma.items()
                if k.startswith(kern + "I")}
        check(len(mine) == 3 and not any(any(c) for c in mine.values()),
              "%s: (HMMA, HGMMA) counts %r (want full float32 on FFMA at "
              "each head width)" % (kern, mine))
    return hmma, hgmma


def flash_kernel_phase(dev):
    """K1a/K1b/K1c against their plain versions: at the long-context
    training shape [8,16,2048,64], causal, in float32 and bfloat16, and at
    small shapes that cover bias, segment ids, ragged Sq != Sk, dropout and
    head widths 32 and 128, and a float32 bias under bfloat16 q, k, v; the
    dropout mask bit for bit in both dtypes; HMMA in the SASS of the three
    bfloat16 kernels, neither HMMA nor HGMMA in the float32 ones; a float32
    q view off 16 bytes, which K1a, K1b and K1c take as an aligned copy. Then
    their times beside bound, plain version and library call."""
    from paddle_tpu_torch.ops.kernels import flash_attention as fa

    b, s = LONGCTX_BATCH, LONGCTX_SEQ
    h, d = LONGCTX["n_head"], LONGCTX["d_model"] // LONGCTX["n_head"]
    sm = d ** -0.5
    flash_planted_faults(dev)

    small = [  # b, h, sq, sk, d, causal, bias, seg, rate
        (2, 4, 200, 200, 64, False, True, True, 0.0),
        (2, 4, 200, 200, 64, True, True, True, 0.0),
        (1, 4, 70, 333, 32, False, True, False, 0.0),
        (1, 4, 333, 70, 128, False, False, True, 0.0),
        (2, 4, 192, 192, 64, True, False, False, 0.1),
        (1, 2, 130, 130, 128, True, False, False, 0.1),
        (1, 2, 100, 130, 32, False, False, False, 0.1),
    ]
    small_errs = []
    for i, (b_, h_, sq, sk, d_, causal, bias, seg, rate) in enumerate(small):
        for dt in (torch.float32, torch.bfloat16):
            x = flash_inputs(dev, dt, b_, h_, sq, sk, d_, 100 + i, bias, seg)
            errs = flash_check("flash small %d" % i, dt, *x, causal,
                               d_ ** -0.5, rate, 77 + i)
            small_errs.append({"case": small[i],
                               "dtype": str(dt).replace("torch.", ""),
                               "max_abs_err": errs})
    # a float32 bias under bfloat16 q, k, v: all three kernels read it as
    # float32, and K1c returns dab in float32
    f32_bias = [  # b, h, sq, sk, d, causal, seg
        (2, 4, 200, 200, 64, True, True),
        (1, 2, 70, 333, 32, False, False),
    ]
    for i, (b_, h_, sq, sk, d_, causal, seg) in enumerate(f32_bias):
        x = flash_inputs(dev, torch.bfloat16, b_, h_, sq, sk, d_, 200 + i,
                         True, seg, ab_dtype=torch.float32)
        errs = flash_check("flash float32 bias %d" % i, torch.bfloat16, *x,
                           causal, d_ ** -0.5, 0.0, 0)
        small_errs.append({"case": f32_bias[i], "dtype": "bfloat16",
                           "bias_dtype": "float32", "max_abs_err": errs})
    # the dropout mask itself: with v = identity columns the output is the
    # dropped probabilities, 0 exactly where the plain mask drops
    n = 128
    keep = fa.dropout_keep_mask(
        0.1, -12345, torch.arange(2, device=dev)[:, None, None, None],
        torch.arange(2, device=dev)[None, :, None, None], 0, 0, (n, n), dev)
    for dt in (torch.float32, torch.bfloat16):
        q, k, _, _, _, _ = flash_inputs(dev, dt, 2, 2, n, n, n, 9)
        eye = torch.eye(n, device=dev, dtype=dt).expand(2, 2, n, n)
        o, _ = fa.flash_fwd(q, k, eye.contiguous(), None, None, False, 0.05,
                            0.1, -12345)
        check(torch.equal(o != 0, keep), "the kernel's dropout mask differs "
              "from the plain version's (%s)" % dt)
    hmma, hgmma = flash_sass_hmma()
    # a float32 q view one element off 16 bytes: the kernels get an aligned
    # copy (on the card)
    x = list(flash_inputs(dev, torch.float32, 1, 2, 96, 96, 64, 300))
    flat = torch.empty(x[0].numel() + 1, device=dev)
    x[0] = flat[1:].view(x[0].shape).copy_(x[0])
    check(not fa._cp_async_ok(x[0]), "the unaligned q view is aligned")
    errs = flash_check("flash unaligned q", torch.float32, *x, True,
                       64 ** -0.5, 0.0, 0)
    small_errs.append({"case": (1, 2, 96, 96, 64, True, False, False, 0.0),
                       "dtype": "float32", "q_view": "off 16 bytes",
                       "max_abs_err": errs})

    path_errs = {}
    for dt in (torch.float32, torch.bfloat16):
        x = flash_inputs(dev, dt, b, h, s, s, d, 0)
        path_errs[str(dt).replace("torch.", "")] = flash_check(
            "flash path", dt, *x, True, sm, 0.0, 0)
        del x
        torch.cuda.empty_cache()

    # times: L2 flushed before each launch, median of 30
    flush = l2_flusher(dev)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    times = {}
    for dt in (torch.float32, torch.bfloat16):
        q, k, v, do, _, _ = flash_inputs(dev, dt, b, h, s, s, d, 0)
        o, lse = fa.flash_fwd(q, k, v, None, None, True, sm)
        di = (o.float() * do.float()).sum(-1)
        args = (q, k, v, None, None, lse, do, di, True, sm)
        t = {"fwd": cuda_ms(lambda: fa.flash_fwd(q, k, v, None, None, True,
                                                 sm), flush=flush),
             "dkv": cuda_ms(lambda: fa.flash_bwd_dkv(*args), flush=flush),
             "dq": cuda_ms(lambda: fa.flash_bwd_dq(*args), flush=flush),
             "di": cuda_ms(lambda: (o.float() * do.float()).sum(-1),
                           flush=flush),
             "library_fwd": cuda_ms(lambda: sdpa(q, k, v, is_causal=True,
                                                 scale=sm), flush=flush)}
        qr, kr, vr = (x.detach().requires_grad_(True) for x in (q, k, v))
        lib_o = sdpa(qr, kr, vr, is_causal=True, scale=sm)
        t["library_bwd"] = cuda_ms(lambda: torch.autograd.grad(
            lib_o, [qr, kr, vr], do, retain_graph=True), flush=flush)
        del qr, kr, vr, lib_o
        if dt == torch.float32:
            t["plain_fwd"] = cuda_ms(lambda: fa.flash_fwd_reference(
                q, k, v, None, None, True, sm), reps=5, flush=flush)
            t["plain_dkv"] = cuda_ms(lambda: fa.flash_bwd_dkv_reference(
                *args), reps=5, flush=flush)
            t["plain_dq"] = cuda_ms(lambda: fa.flash_bwd_dq_reference(
                *args), reps=5, flush=flush)
        times[str(dt).replace("torch.", "")] = t
        del q, k, v, do, o, lse, di, args
        torch.cuda.empty_cache()
    del flush

    # least work, causal: S(S+1)/2 visible scores a head, two flops a
    # multiply-add; K1a does 2 products of width D per score, K1b 4, K1c 3.
    # Bytes: each input read once, each output written once.
    visible = b * h * s * (s + 1) // 2
    qkv_o = b * h * s * d       # elements of one of q, k, v, o, do, ...
    stats = b * h * s * 4       # lse or di, float32
    work = {"fwd": (2 * 2 * d * visible, 4 * qkv_o, stats),
            "dkv": (4 * 2 * d * visible, 6 * qkv_o, 2 * stats),
            "dq": (3 * 2 * d * visible, 5 * qkv_o, 2 * stats)}

    def bound(kern, itemsize, peak):
        flops, elems, extra = work[kern]
        t_bytes = (elems * itemsize + extra) / H100_BYTES_PER_S * 1e3
        t_ops = flops / peak * 1e3
        return max(t_bytes, t_ops), \
            "bytes" if t_bytes >= t_ops else "operations"

    rows = []
    f32, bf16 = times["float32"], times["bfloat16"]
    for kern, name, line, out in (
            ("fwd", "flash_attention_fwd", "682", "o"),
            ("dkv", "flash_attention_bwd_dkv", "1061", "dk"),
            ("dq", "flash_attention_bwd_dq", "1428", "dq")):
        bound_ms, by = bound(kern, 4, H100_F32_FLOP_PER_S)
        bf16_bound_ms = bound(kern, 2, H100_BF16_FLOP_PER_S)[0]
        lib = "library_fwd" if kern == "fwd" else "library_bwd"
        rows.append({
            "name": name, "route": "cuda",
            "source": "paddle_tpu_torch/csrc/flash_attention.cu",
            "replaces": "paddle_tpu/ops/pallas_kernels/flash_attention.py:"
                        + line,
            "launches": None, "max_abs_err": path_errs["float32"][out],
            "ms": f32[kern], "plain_ms": f32["plain_" + kern],
            "bound_ms": bound_ms, "bound_by": by, "library_ms": f32[lib],
            # the library's backward is one call for dq, dk and dv together
            "library_call": "scaled_dot_product_attention(is_causal=True)"
                            + ("" if kern == "fwd" else " backward, whole"),
            "bf16_ms": bf16[kern],
            "bf16_bound_ms": bf16_bound_ms,
            "bf16_bound_share": bf16_bound_ms / bf16[kern],
            "bf16_library_ms": bf16[lib],
            "bound_share": bound_ms / f32[kern],
            "bf16_max_abs_err": path_errs["bfloat16"][out],
            "design": F32_DESIGN[kern], "bf16_design": "mma.sync bf16"})
    emit("kernel_vs_plain", kernel="flash_attention",
         shape={"B": b, "H": h, "S": s, "D": d, "causal": True},
         tol={k_: {"rtol": r, "row_floor": f}
              for k_, (r, f) in FLASH_TOL.items()},
         max_abs_err=path_errs, small_shapes=small_errs,
         planted_faults_rejected=True,
         dropout_mask_bit_equal=["float32", "bfloat16"], sass_hmma=hmma,
         sass_hgmma=hgmma,
         ms=times, gflop={k_: w[0] / 1e9 for k_, w in work.items()})
    flash_crossover(dev)
    return rows


def build_causal_lm(fluid, seq, amp, dropout=0.1, n_layer=None):
    """``bench.py``'s ``bench_longseq_train`` program, for the port's
    package; ``amp`` decorates the optimizer as the bench does."""
    from paddle_tpu_torch.models import transformer as tfm

    cfg = dict(LONGCTX, n_layer=n_layer or LONGCTX["n_layer"])
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 7
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        ids = fluid.layers.data("ids", shape=[seq], dtype="int64")
        lbl = fluid.layers.data("lbl", shape=[seq, 1], dtype="int64")
        _, loss = tfm.causal_lm(ids, lbl, max_length=seq,
                                dropout_rate=dropout, **cfg)
        opt = fluid.optimizer.Adam(learning_rate=1e-4)
        if amp:
            opt = fluid.amp.decorate(opt)
        opt.minimize(loss)
    return main, startup, loss


def longctx_feed(batch, seq):
    rng = np.random.RandomState(0)
    vocab = LONGCTX["vocab_size"]
    return {"ids": rng.randint(0, vocab, (batch, seq)).astype("int64"),
            "lbl": rng.randint(0, vocab, (batch, seq, 1)).astype("int64")}


def flash_launches():
    from paddle_tpu_torch.ops.kernels import flash_attention as fa

    return fa.LAUNCHES_FWD, fa.LAUNCHES_DKV, fa.LAUNCHES_DQ


def longctx_train_phase(flash_rows, amp):
    """The causal LM at full width and depth, batch 8 x 2048 tokens, in
    float32 (TF32 off) or under ``fluid.amp.decorate``, on one fixed batch:
    warm-up steps until two in a row agree within 10 % (at least 2, at most
    6; their times on a line of their own), then 6 timed steps, their
    median the step time."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddle_tpu_torch.ops.kernels import softmax_xent as sx

    mode = "bfloat16_amp" if amp else "float32"
    t0 = time.perf_counter()
    main, startup, loss = build_causal_lm(fluid, LONGCTX_SEQ, amp)
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CUDAPlace(0))
    exe.run(startup, scope=scope)
    torch.cuda.synchronize()
    n_weights = sum(int(np.prod(p.shape)) for p in main.all_parameters())
    feed = longctx_feed(LONGCTX_BATCH, LONGCTX_SEQ)
    torch.cuda.reset_peak_memory_stats()
    warm, warm_secs = train_steps(exe, main, loss, feed, scope, 2)
    while (len(warm) < 6 and abs(warm_secs[-1] - warm_secs[-2])
           > 0.1 * min(warm_secs[-2:])):
        lv, sec = train_steps(exe, main, loss, feed, scope, 1)
        warm += lv
        warm_secs += sec
    emit("longctx_warmup", mode=mode, step_ms=[x * 1e3 for x in warm_secs])
    fa.LAUNCHES_FWD = fa.LAUNCHES_DKV = fa.LAUNCHES_DQ = 0
    sx.LAUNCHES_FWD = sx.LAUNCHES_BWD = 0
    losses, secs = train_steps(exe, main, loss, feed, scope, 6)
    k1 = flash_launches()
    k2 = (sx.LAUNCHES_FWD, sx.LAUNCHES_BWD)
    peak = torch.cuda.max_memory_allocated()
    all_losses = warm + losses
    check(bool(np.isfinite(all_losses).all()),
          "non-finite long-context loss (%s): %r" % (mode, all_losses))
    check(all_losses[-1] < all_losses[0],
          "long-context loss did not fall (%s): %r" % (mode, all_losses))
    want = LONGCTX["n_layer"] * len(losses)
    check(k1 == (want, want, want),
          "K1 launches %r over %d steps of %d layers (%s)"
          % (k1, len(losses), LONGCTX["n_layer"], mode))
    check(k2 == (len(losses), len(losses)),
          "K2 launches %r over %d steps (%s)" % (k2, len(losses), mode))
    masters = {str(scope.find_var(p.name).dtype)
               for p in main.all_parameters()}
    check(masters == {"torch.float32"}, "parameters not float32: %r" % masters)
    for row, n in zip(flash_rows, k1):
        row["launches_amp" if amp else "launches"] = n
    step_ms = float(np.median(secs)) * 1e3
    emit("longctx_train", mode=mode, config=LONGCTX, batch=LONGCTX_BATCH,
         seq=LONGCTX_SEQ, weights=n_weights, steps=len(losses),
         step_ms_median=step_ms, step_ms=[x * 1e3 for x in secs],
         tokens_per_s=LONGCTX_BATCH * LONGCTX_SEQ / (step_ms / 1e3),
         peak_memory_bytes=peak, losses=all_losses,
         k1_launches=dict(zip(("fwd", "dkv", "dq"), k1)),
         k2_launches=dict(zip(("fwd", "bwd"), k2)),
         setup_s=time.perf_counter() - t0 - sum(secs))
    train_profile_phase(exe, main, loss, feed, scope,
                        phase="longctx_profile_" + mode)
    del scope, exe
    torch.cuda.empty_cache()


def longctx_parity_phase():
    """The causal LM at full width, 2 layers, batch 1 x 256 tokens, dropout
    0, with the flash route taken from 128 tokens: two steps on the card
    (the kernels) and two on the CPU (their plain versions) from the same
    startup state, in float32 (TF32 off; losses to 1e-4 relative) and
    under AMP (the bfloat16 kernels, the tensor-core K1a/K1c among them;
    losses to 2e-2 relative, the CPU tests' bound for bfloat16 AMP)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.flags import set_flag

    set_flag("flash_attention_min_seq", 128)
    for amp, tol in ((False, 1e-4), (True, 2e-2)):
        main, startup, loss = build_causal_lm(fluid, 256, amp=amp,
                                              dropout=0.0, n_layer=2)
        feed = longctx_feed(1, 256)
        card = fluid.Scope()
        exe = fluid.Executor(fluid.CUDAPlace(0))
        exe.run(startup, scope=card)
        arrays = {n: card.as_numpy(n) for n in card.vars}
        n0 = flash_launches()
        card_losses, _ = train_steps(exe, main, loss, feed, card, 2)
        n1 = flash_launches()
        check(tuple(a - b for a, b in zip(n1, n0)) == (4, 4, 4),
              "the card run launched K1a/K1b/K1c %r -> %r over 2 steps of 2 "
              "layers (amp %s)" % (n0, n1, amp))
        cpu = fluid.io.state_from_numpy(main, arrays, fluid.Scope(),
                                        fluid.CPUPlace())
        cpu_losses, _ = train_steps(fluid.Executor(fluid.CPUPlace()), main,
                                    loss, feed, cpu, 2)
        check(flash_launches() == n1, "the CPU run launched a flash kernel")
        rel = [abs(a - b) / abs(b) for a, b in zip(card_losses, cpu_losses)]
        check(bool(np.isfinite(card_losses + cpu_losses).all())
              and max(rel) <= tol,
              "long-context card %r vs CPU %r losses (rel %r > %g, amp %s)"
              % (card_losses, cpu_losses, rel, tol, amp))
        emit("longctx_parity", mode="bfloat16_amp" if amp else "float32",
             batch=1, seq=256, n_layer=2, dropout=0.0,
             card_losses=card_losses, cpu_losses=cpu_losses, rel_err=rel,
             tol=tol, k1_launches_card=4)
        del card, cpu
    set_flag("flash_attention_min_seq", 2048)
    torch.cuda.empty_cache()


def ctr_feed(batch=None, vocab=None):
    """The fixed batch of bench.py's bench_deepfm (batch 1024, V = 1e6 by
    default): RandomState(0) draws the ids, then the dense features, then
    the labels."""
    batch = batch or CTR_BATCH
    vocab = vocab or CTR["sparse_feature_dim"]
    num_fields = CTR["num_fields"]
    rng = np.random.RandomState(0)
    return {"ids": rng.randint(0, vocab, (batch, num_fields)).astype("int64"),
            "dense": rng.rand(batch, CTR_DENSE).astype("float32"),
            "label": rng.randint(0, 2, (batch, 1)).astype("int64")}


def build_deepfm(fluid, vocab, opt="adam", is_sparse=True):
    """``bench.py``'s ``bench_deepfm`` program, for the port's package, at
    full width; ``opt`` is "adam" (Adam(1e-3), as the bench) or "sgd"."""
    from paddle_tpu_torch.models import deepfm

    cfg = dict(CTR, sparse_feature_dim=vocab)
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        ids = fluid.layers.data("ids", shape=[cfg["num_fields"]],
                                dtype="int64")
        dense = fluid.layers.data("dense", shape=[CTR_DENSE])
        label = fluid.layers.data("label", shape=[1], dtype="int64")
        _, loss, auc = deepfm.deepfm(ids, dense, label, is_sparse=is_sparse,
                                     **cfg)
        (fluid.optimizer.Adam(learning_rate=1e-3) if opt == "adam"
         else fluid.optimizer.SGD(learning_rate=1e-3)).minimize(loss)
    return main, startup, loss, auc


def sparse_err(got, want, old):
    """Largest |got - want| / max(|want|, |old|): relative to the larger of
    an element's values after and before the update (the plain version
    stores m + (m_new - m) where the kernel stores m_new, one rounding
    apart, which a value that cancels to near 0 would blow up)."""
    scale = torch.maximum(want.abs(), old.abs()).clamp_min(1e-30)
    return float(((got - want).abs() / scale).max())


def row_sectors(ids, row_bytes):
    """The 32-byte sectors that the rows at ``ids`` span in a table of
    ``row_bytes``-wide rows."""
    start = ids * row_bytes
    return int(((start + row_bytes - 1) // 32 - start // 32 + 1).sum())


# planted faults: K4a's source with one change each, built beside it
SPARSE_FAULTS = {
    "writes_pad_rows": (
        "  if (id < 0 || id >= vocab) return;  // merge padding: touch "
        "nothing\n  const long long k = id * d + t % d;\n"
        "  const float g = rows[t];",
        "  const long long k = (id >= vocab ? vocab - 1 : id) * d + t % d;\n"
        "  const float g = rows[t];"),
    "no_one_minus_beta1": ("__fmul_rn(one_minus_beta1, g)", "g"),
}


def build_sparse_faults():
    """{fault: K4a entry point} of the planted-fault variants, built with
    the kernels' own nvcc flags, one process each, in parallel."""
    import ctypes

    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.ops.kernels import sparse_adam as sa

    src = (_build.SRC_DIR / "sparse_adam.cu").read_text()
    jobs = {}
    for name, (old, new) in SPARSE_FAULTS.items():
        check(src.count(old) == 1, "planted fault %s: its pattern is not in "
              "sparse_adam.cu once" % name)
        cu = _build.BUILD_DIR / ("sparse_adam_fault_%s.cu" % name)
        cu.write_text(src.replace(old, new))
        so = cu.with_suffix(".so")
        jobs[name] = (subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True), so)
    fns = {}
    for name, (proc, so) in jobs.items():
        out, err = proc.communicate()
        check(proc.returncode == 0, "planted fault %s did not build: %s%s"
              % (name, out, err))
        fns[name] = sa.bind(ctypes.CDLL(str(so)))[0]
    return fns


def ctr_xent_check(dev, flush):
    """K2a/K2b at DeepFM's loss shape [1024, 2] (no smoothing): one 256-
    thread block per two-element row. The loss to 1e-5 relative, dlogits
    to 1e-6 absolute; times beside bound, plain version and library."""
    from paddle_tpu_torch.ops.kernels import softmax_xent as sx

    F = torch.nn.functional
    n, v = CTR_BATCH, 2
    rng = np.random.RandomState(1)
    x = torch.as_tensor((rng.randn(n, v) * 2).astype(np.float32), device=dev)
    lab = torch.as_tensor(rng.randint(0, v, n).astype(np.int64), device=dev)
    g = torch.as_tensor(rng.randn(n, 1).astype(np.float32), device=dev)
    loss, lse = sx.softmax_xent_fwd(x, lab)
    dx = sx.softmax_xent_bwd(x, lab, lse, g)
    torch.cuda.synchronize()
    want_loss, want_lse = sx.softmax_xent_reference(x, lab)
    want_dx = sx.softmax_xent_reference_bwd(x, lab, want_lse, g)
    e_loss, e_dx = rel_err(loss, want_loss), float((dx - want_dx).abs().max())
    check(e_loss <= 1e-5, "K2a [1024, 2] loss rel err %g > 1e-5" % e_loss)
    check(e_dx <= 1e-6, "K2b [1024, 2] dlogits abs err %g > 1e-6" % e_dx)
    xr = x.detach().requires_grad_(True)
    lib_loss = F.cross_entropy(xr, lab, reduction="none")
    times = {
        "fwd_ms": cuda_ms(lambda: sx.softmax_xent_fwd(x, lab), flush=flush),
        "fwd_plain_ms": cuda_ms(lambda: sx.softmax_xent_reference(x, lab),
                                flush=flush),
        "fwd_library_ms": cuda_ms(lambda: F.cross_entropy(
            x, lab, reduction="none"), flush=flush),
        "bwd_ms": cuda_ms(lambda: sx.softmax_xent_bwd(x, lab, lse, g),
                          flush=flush),
        "bwd_plain_ms": cuda_ms(lambda: sx.softmax_xent_reference_bwd(
            x, lab, lse, g), flush=flush),
        "bwd_library_ms": cuda_ms(lambda: torch.autograd.grad(
            lib_loss, [xr], g.reshape(-1), retain_graph=True), flush=flush)}
    nv = n * v
    times["fwd_bound_ms"] = (4 * nv + 16 * n) / H100_BYTES_PER_S * 1e3
    times["bwd_bound_ms"] = (8 * nv + 16 * n) / H100_BYTES_PER_S * 1e3
    emit("kernel_vs_plain", kernel="softmax_xent_ctr",
         shape={"N": n, "V": v, "smooth": 0.0},
         max_err={"loss_rel": e_loss, "dlogits_abs": e_dx},
         tol={"loss_rel": 1e-5, "dlogits_abs": 1e-6}, **times)
    return dict(times, max_err={"loss_rel": e_loss, "dlogits_abs": e_dx})


def sparse_kernel_phase(dev):
    """K4a/K4b against their plain versions at the CTR path's shapes:
    tables [1e6, 10] and [1e6, 1], the ids of bench_deepfm's batch (1024 x
    26 draws from RandomState(0)) merged on the card, with their padding
    tail, and random gradient rows. p, m, v to 1e-6 of the larger of each
    element's values after and before; every row no id names bit-equal,
    row V-1 included (only padding ids clamp to it); planted faults (a
    kernel that writes padding rows, one without the (1-β1) term) must
    fail. Then times beside bound, plain version and library call, and
    K2a/K2b at [1024, 2]."""
    from paddle_tpu_torch.core.sparse import merge_rows
    from paddle_tpu_torch.ops.kernels import sparse_adam as sa

    vocab = CTR["sparse_feature_dim"]
    ids = torch.as_tensor(ctr_feed()["ids"].reshape(-1), device=dev)
    n = ids.shape[0]
    gen = torch.Generator(device=dev).manual_seed(0)
    # lr_t of Adam(1e-3)'s first step: lr·sqrt(1-β2)/(1-β1)
    lr_t = torch.tensor([1e-3 * (1 - 0.999) ** 0.5 / (1 - 0.9)], device=dev)
    lr = torch.tensor([1e-3], device=dev)
    faults = build_sparse_faults()
    flush = l2_flusher(dev)
    out = {}
    for table, d in (("sparse_emb", CTR["embedding_size"]), ("sparse_w1", 1)):
        rows = torch.randn(n, d, generator=gen, device=dev)
        uniq, merged = merge_rows(ids, rows, vocab)
        n_u = int((uniq < vocab).sum())
        valid = uniq[:n_u]
        touched = torch.zeros(vocab, dtype=torch.bool, device=dev)
        touched[valid] = True
        check(n_u < n and bool((uniq[n_u:] == vocab).all()),
              "no padding tail in the merged ids")
        olds = (torch.randn(vocab, d, generator=gen, device=dev) * d ** -0.5,
                torch.randn(vocab, d, generator=gen, device=dev) * 1e-2,
                torch.rand(vocab, d, generator=gen, device=dev) * 1e-4)
        a0, s0 = sa.LAUNCHES_ADAM, sa.LAUNCHES_SGD
        got = sa.sparse_adam_rows(*(t.clone() for t in olds), uniq, merged,
                                  lr_t)
        got_sgd = sa.sparse_sgd_rows(olds[0].clone(), uniq, merged, lr)
        torch.cuda.synchronize()
        check((sa.LAUNCHES_ADAM - a0, sa.LAUNCHES_SGD - s0) == (1, 1),
              "K4a/K4b launch counters did not move")
        want = sa.sparse_adam_rows_reference(*(t.clone() for t in olds),
                                             uniq, merged, lr_t)
        want_sgd = sa.sparse_sgd_rows_reference(olds[0].clone(), uniq, merged,
                                                lr)
        errs = {}
        for name, g_, w_, o_ in zip(("p", "m", "v", "p_sgd"),
                                    (*got, got_sgd), (*want, want_sgd),
                                    (*olds, olds[0])):
            e = sparse_err(g_, w_, o_)
            check(e <= 1e-6, "K4 %s %s err %g > 1e-6 of max(|after|, "
                  "|before|)" % (table, name, e))
            check(torch.equal(g_[~touched], o_[~touched]),
                  "K4 %s %s: a row no id names moved" % (table, name))
            errs[name] = {"rel": e, "abs": float((g_ - w_).abs().max())}
        if table == "sparse_emb":
            args = (uniq, merged, lr_t, n, d, vocab,
                    *sa.adam_constants(0.9, 0.999, 1e-8))
            bad = [t.clone() for t in olds]
            sa.launch(faults["writes_pad_rows"], dev, *bad, *args)
            torch.cuda.synchronize()
            check(not all(torch.equal(b[~touched], o[~touched])
                          for b, o in zip(bad, olds)),
                  "the untouched-rows check passes a kernel that writes "
                  "padding rows")
            bad = [t.clone() for t in olds]
            sa.launch(faults["no_one_minus_beta1"], dev, *bad, *args)
            torch.cuda.synchronize()
            check(sparse_err(bad[1], want[1], olds[1]) > 1e-6,
                  "the check passes a kernel without the (1-β1) term")
        # times: tables updated in place on every launch, L2 flushed
        p, m, v = (t.clone() for t in olds)
        t = {"ms": cuda_ms(lambda: sa.sparse_adam_rows(p, m, v, uniq, merged,
                                                       lr_t), flush=flush),
             "plain_ms": cuda_ms(lambda: sa.sparse_adam_rows_reference(
                 p, m, v, uniq, merged, lr_t), flush=flush),
             "sgd_ms": cuda_ms(lambda: sa.sparse_sgd_rows(p, uniq, merged,
                                                          lr), flush=flush),
             "sgd_plain_ms": cuda_ms(lambda: sa.sparse_sgd_rows_reference(
                 p, uniq, merged, lr), flush=flush)}
        dirty = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)
        t["ms_after_write_flush"] = cuda_ms(lambda: sa.sparse_adam_rows(
            p, m, v, uniq, merged, lr_t), flush=dirty.zero_)
        del dirty
        # library yardsticks: torch.optim.SparseAdam on the coalesced sparse
        # gradient, index_add_ with alpha = -lr
        param = torch.nn.Parameter(olds[0].clone())
        grad = torch.sparse_coo_tensor(valid[None], merged[:n_u],
                                       (vocab, d), check_invariants=False
                                       ).coalesce()
        opt = torch.optim.SparseAdam([param], lr=1e-3)

        def lib_adam():
            param.grad = grad
            opt.step()

        t["library_ms"] = cuda_ms(lib_adam, flush=flush)
        t["sgd_library_ms"] = cuda_ms(lambda: p.index_add_(
            0, valid, merged[:n_u], alpha=-1e-3), flush=flush)
        # least work: the ids read once (8 B each) and, per touched element,
        # K4a reads p, m, v, g and writes p, m, v (28 B, ~11 flops), K4b
        # reads p, g and writes p (12 B, 2 flops). The sector count is what
        # the card moves for rows that lie at random: whole 32-byte sectors
        # of p, m, v, the contiguous gradient rows and ids as they are.
        elems = n_u * d
        sectors = row_sectors(valid, 4 * d)
        work = {"adam": (28 * elems + 8 * n, 11 * elems,
                         6 * 32 * sectors + 4 * elems + 8 * n),
                "sgd": (12 * elems + 8 * n, 2 * elems,
                        2 * 32 * sectors + 4 * elems + 8 * n)}
        for k, (nbytes, flops, sbytes) in work.items():
            t_bytes = nbytes / H100_BYTES_PER_S * 1e3
            t_ops = flops / H100_F32_FLOP_PER_S * 1e3
            pre = "" if k == "adam" else "sgd_"
            t[pre + "bound_ms"] = max(t_bytes, t_ops)
            t[pre + "bound_by"] = "bytes" if t_bytes >= t_ops \
                else "operations"
            t[pre + "bytes"] = nbytes
            t[pre + "sector_bytes"] = sbytes
            t[pre + "bound_sectors_ms"] = sbytes / H100_BYTES_PER_S * 1e3
        emit("kernel_vs_plain", kernel="sparse_rows", table=table,
             shape={"V": vocab, "D": d, "N": n, "distinct_ids": n_u,
                    "row_v_minus_1_named": bool(touched[vocab - 1])},
             max_err=errs, tol="1e-6 of max(|after|, |before|); untouched "
             "rows bit-equal", planted_faults_rejected=table == "sparse_emb",
             **t)
        out[table] = dict(t, errs=errs, distinct_ids=n_u)
        del p, m, v, olds, got, want, param, grad, opt
        torch.cuda.empty_cache()
    k2 = ctr_xent_check(dev, flush)
    del flush
    torch.cuda.empty_cache()

    def row(name, line, pre, err_key):
        emb, w1 = out["sparse_emb"], out["sparse_w1"]
        return {"name": name, "route": "cuda",
                "source": "paddle_tpu_torch/csrc/sparse_adam.cu",
                "replaces": "paddle_tpu/ops/pallas_kernels/sparse_adam.py:"
                            + line,
                "launches": None,
                "max_abs_err": max(emb["errs"][k]["abs"] for k in err_key),
                "ms": emb[pre + "ms"], "plain_ms": emb[pre + "plain_ms"],
                "bound_ms": emb[pre + "bound_ms"],
                "bound_by": emb[pre + "bound_by"],
                "library_ms": emb[pre + "library_ms"],
                "library_call": "torch.optim.SparseAdam.step()" if pre == ""
                else "Tensor.index_add_(alpha=-lr)",
                "shape": "[1e6, 10] table, N = %d ids" % ids.shape[0],
                "bound_sectors_ms": emb[pre + "bound_sectors_ms"],
                **({"ms_after_write_flush": emb["ms_after_write_flush"]}
                   if pre == "" else {}),
                "w1_table": {k: w1[pre + k] for k in (
                    "ms", "plain_ms", "bound_ms", "library_ms",
                    "bound_sectors_ms")}}

    return [row("sparse_adam_rows", "235", "", ("p", "m", "v")),
            row("sparse_sgd_rows", "301", "sgd_", ("p_sgd",))], k2


def state_bytes(scope):
    return sum(t.numel() * t.element_size() for t in scope.vars.values()
               if isinstance(t, torch.Tensor))


def ctr_run(fluid, vocab, opt="adam", is_sparse=True, warm=2, timed=6,
            profile=None):
    """DeepFM at full width through ``Executor.run``: ``warm`` steps, then
    the launch counters set to 0 and ``timed`` steps on one fixed batch, each
    ending with its loss and AUC on the host. Returns the phase's numbers."""
    from paddle_tpu_torch.ops.kernels import softmax_xent as sx
    from paddle_tpu_torch.ops.kernels import sparse_adam as sa

    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    main, startup, loss, auc = build_deepfm(fluid, vocab, opt, is_sparse)
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CUDAPlace(0))
    exe.run(startup, scope=scope)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    feed = ctr_feed(vocab=vocab)
    held = state_bytes(scope)
    losses, aucs, secs = [], [], []
    for i in range(warm + timed):
        if i == warm:
            torch.cuda.reset_peak_memory_stats()
            sa.LAUNCHES_ADAM = sa.LAUNCHES_SGD = 0
            sx.LAUNCHES_FWD = sx.LAUNCHES_BWD = 0
        t1 = time.perf_counter()
        lv, av = exe.run(main, feed=feed, fetch_list=[loss, auc], scope=scope)
        secs.append(time.perf_counter() - t1)
        losses.append(float(lv))
        aucs.append(float(av))
    launches = {"k4a": sa.LAUNCHES_ADAM, "k4b": sa.LAUNCHES_SGD,
                "k2a": sx.LAUNCHES_FWD, "k2b": sx.LAUNCHES_BWD}
    peak = torch.cuda.max_memory_allocated()
    step_ms = float(np.median(secs[warm:])) * 1e3
    res = {"vocab": vocab, "optimizer": opt, "is_sparse": is_sparse,
           "batch": CTR_BATCH, "steps": timed, "step_ms_median": step_ms,
           "step_ms": [x * 1e3 for x in secs[warm:]],
           "examples_per_s": CTR_BATCH / (step_ms / 1e3),
           "peak_memory_bytes": peak, "state_bytes": held,
           "baseline_bytes": base, "peak_minus_state_bytes": peak - held - base,
           "losses": losses, "auc": aucs[-1], "launches": launches,
           "setup_s": setup_s}
    check(bool(np.isfinite(losses).all()), "non-finite DeepFM loss: %r"
          % losses)
    if profile:
        train_profile_phase(exe, main, loss, feed, scope, phase=profile)
    del scope, exe
    torch.cuda.empty_cache()
    return res


def ctr_train_phase(k4_rows, xent_rows, k2_ctr):
    """DeepFM at full width (V = 1e6, batch 1024, float32, TF32 off): Adam
    and SGD runs of 2 warm-up and 6 timed steps, the Adam one profiled;
    then the V = 5e7 sparse Adam step, which must allocate no [V, D]
    gradient, and, as a finding, the dense (is_sparse=False) step at both
    V."""
    import paddle_tpu_torch as fluid

    vocab = CTR["sparse_feature_dim"]
    adam = ctr_run(fluid, vocab, "adam", profile="ctr_profile")
    steps = adam["steps"]
    check(adam["losses"][-1] < adam["losses"][0],
          "DeepFM Adam loss did not fall: %r" % adam["losses"])
    check(adam["launches"] == {"k4a": 2 * steps, "k4b": 0, "k2a": steps,
                               "k2b": steps},
          "DeepFM Adam launches %r over %d steps (want K4a 2, K2a/K2b 1 a "
          "step)" % (adam["launches"], steps))
    emit("ctr_train", config=CTR, **adam)
    sgd = ctr_run(fluid, vocab, "sgd")
    check(sgd["losses"][-1] < sgd["losses"][0],
          "DeepFM SGD loss did not fall: %r" % sgd["losses"])
    check(sgd["launches"] == {"k4a": 0, "k4b": 2 * steps, "k2a": steps,
                              "k2b": steps},
          "DeepFM SGD launches %r over %d steps (want K4b 2 a step)"
          % (sgd["launches"], steps))
    emit("ctr_train", config=CTR, **sgd)
    k4_rows[0]["launches"] = adam["launches"]["k4a"]
    k4_rows[1]["launches"] = sgd["launches"]["k4b"]
    for row, key, n in zip(xent_rows, ("fwd", "bwd"),
                           (adam["launches"]["k2a"], adam["launches"]["k2b"])):
        row["ctr_shape"] = {"N": CTR_BATCH, "V": 2, "launches": n,
                            **{k.replace(key + "_", ""): v
                               for k, v in k2_ctr.items()
                               if k.startswith(key + "_")}}

    big = ctr_run(fluid, CTR_BIG_V, "adam")
    check(big["launches"]["k4a"] == 2 * steps,
          "V = 5e7: K4a launches %r" % big["launches"])
    check(big["peak_minus_state_bytes"] < 1e9,
          "V = 5e7 sparse step: peak %d B is %d B above the state's %d B "
          "(a [V, D] gradient?)" % (big["peak_memory_bytes"],
                                    big["peak_minus_state_bytes"],
                                    big["state_bytes"]))
    emit("ctr_train", config=dict(CTR, sparse_feature_dim=CTR_BIG_V),
         step_ms_at_1e6=adam["step_ms_median"], **big)
    for v in (vocab, CTR_BIG_V):
        dense = ctr_run(fluid, v, "adam", is_sparse=False, timed=4)
        emit("ctr_train_dense", config=dict(CTR, sparse_feature_dim=v),
             sparse_step_ms=(adam if v == vocab else big)["step_ms_median"],
             **dense)


def ctr_parity_phase():
    """DeepFM at full width but V = 1e4, batch 64: four Adam steps on the
    card (K4a, K2) and four on the CPU (their plain versions) from one CPU
    startup. Losses to 1e-5 relative; every parameter to 1e-5 absolute and
    relative, the other state (Adam's moments span many decades) to 1e-5
    relative plus 1e-5 of its largest |value|; the AUC histograms, whose
    bucket is floor(4096·p), as counts: the same totals, each cumulative
    count within 2 (a probability the devices round to either side of a
    bucket edge moves one count to the next bucket)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.ops.kernels import sparse_adam as sa

    vocab, batch = 10_000, 64
    main, startup, loss, _ = build_deepfm(fluid, vocab)
    init = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=init)
    arrays = {n: init.as_numpy(n) for n in init.vars}
    feed = ctr_feed(batch, vocab)
    card = fluid.io.state_from_numpy(main, arrays, fluid.Scope(),
                                     fluid.CUDAPlace(0))
    a0 = sa.LAUNCHES_ADAM
    card_losses, _ = train_steps(fluid.Executor(fluid.CUDAPlace(0)), main,
                                 loss, feed, card, 4)
    check(sa.LAUNCHES_ADAM - a0 == 8,
          "the card run launched K4a %d times over 4 steps"
          % (sa.LAUNCHES_ADAM - a0))
    cpu = fluid.io.state_from_numpy(main, arrays, fluid.Scope(),
                                    fluid.CPUPlace())
    cpu_losses, _ = train_steps(fluid.Executor(fluid.CPUPlace()), main, loss,
                                feed, cpu, 4)
    check(sa.LAUNCHES_ADAM - a0 == 8, "the CPU run launched K4a")
    rel = [abs(a - b) / abs(b) for a, b in zip(card_losses, cpu_losses)]
    check(bool(np.isfinite(card_losses + cpu_losses).all())
          and max(rel) <= 1e-5,
          "DeepFM card %r vs CPU %r losses (rel %r > 1e-5)"
          % (card_losses, cpu_losses, rel))
    params = {p.name for p in main.all_parameters()}
    worst, hist, bad = {}, {}, []
    for n in sorted(arrays):
        a, b = card.as_numpy(n), cpu.as_numpy(n)
        if n.startswith("auc_stat"):
            hist[n] = int(np.abs(np.cumsum(a) - np.cumsum(b)).max())
            if a.sum() != b.sum() or hist[n] > 2:
                bad.append(n)
            continue
        # a parameter within 1e-5 absolute (+ 1e-5 relative): 1 % of an
        # Adam step (lr 1e-3), which moves a weight by up to lr whatever the
        # size of its gradient, so a gradient that cancels to near 0 moves
        # it by another share of lr on each device. Other state (moments,
        # beta pows) within 1e-5 relative + 1e-5 of its largest |value|.
        atol = 1e-5 if n in params else 1e-5 * float(np.abs(b).max())
        err = float((np.abs(a - b) / np.maximum(
            1e-5 * np.abs(b) + atol, 1e-30)).max())
        worst[n] = err
        if err > 1:
            bad.append(n)
    top = max(worst, key=worst.get)
    emit("ctr_parity", vocab=vocab, batch=batch, card_losses=card_losses,
         cpu_losses=cpu_losses, rel_err=rel, tol=1e-5, k4a_launches_card=8,
         persistables=len(arrays), worst_state=top,
         worst_state_of_bound=worst[top],
         state_of_bound={n: e for n, e in worst.items() if e > 0.01},
         auc_cumulative_moved=hist)
    check(not bad, "card vs CPU state beyond its bound: %s"
          % {n: worst.get(n, hist.get(n)) for n in bad})
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
    flash_rows = flash_kernel_phase(dev)
    k4_rows, k2_ctr = sparse_kernel_phase(dev)
    ctr_train_phase(k4_rows, xent_rows, k2_ctr)
    ctr_parity_phase()
    serve_phase(row)
    train_phase(xent_rows)
    train_parity_phase()
    longctx_train_phase(flash_rows, amp=False)
    longctx_train_phase(flash_rows, amp=True)
    longctx_parity_phase()
    print(json.dumps({"kernels": [row] + xent_rows + flash_rows + k4_rows}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
