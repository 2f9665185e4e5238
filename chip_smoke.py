"""Chip smoke test of the PyTorch port on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

Phases (any failure exits non-zero, and no result line is printed):

1. build the hand-written kernels (``deeplearning4j_torch/kernels``);
2. K1, flash-attention forward, against its plain PyTorch version at the
   slice's shape (f32 causal with and without a key mask, bf16), at the
   training shape [16, 8, 128, 32] and at T=2048, d=128; two calls must be
   bitwise equal; timed beside the plain version and SDPA as a yardstick;
3. K2, paged-attention read, against its plain gather version: decode
   (T=1), T=4 and T=5 (the two sides of the decode/chunk route boundary)
   and a 256-token prefill chunk, f32 and int8 pools, Tmax 512 and 2048,
   with a row on a page boundary and a row whose block table is all page 0;
   then chunk-route cases at Tmax 512: T=48 (the serve's second prefill
   round), T=64, a ragged T=100, d=64 and d=128 at T=256, and page size 8;
   then 16-bit queries (``PAGED16_CASES``): bf16 and f16 pools and int8
   pools under a bf16 query at T = 1, 4, 5, 48 and 256, d = 64 and 128,
   page size 8, each against the plain version on f32-widened inputs
   (one rounding of o: one ulp of max|o|) and at its own dtype (looser,
   ``PAGED16_TOL``); two calls must be bitwise equal, and each chunk case
   also runs its other walk (unsplit where the kernel's rule splits the
   walk, four ranges where it does not) within the same tolerance;
4. the slice model (zoo TransformerLM defaults, numpy-seeded weights) on
   the card: ``output()`` against a CPU run of the port's plain path;
5. serving: 16 greedy requests (prompts of 8..300 tokens, 32 new tokens)
   through ``GenerationServer`` with f32 and then int8 KV pages, each held
   token for token against the same server with ``paged_attention="stock"``;
4b. the model zip: the net saved with ``save_model`` (``coefficients.bin``
   byte for byte ``params_flat()``), loaded with ``load_model(...,
   device="cuda")``, its ``output()`` bitwise the in-memory net's and its
   greedy serve token for token phase 5's;
5b. sampling: the phase-5 prompts as one batch of 8 greedy and 8 sampled
   requests (temperature 0.8, top_k 40, a seed each) on the loaded net, f32
   KV, token for token the plain-read server's, repeated by a second serve,
   greedy requests equal to phase 5's;
5c. a bf16 TransformerLM (the same weights cast to bf16) served greedy
   through K2, bf16 and int8 KV, each stream equal to the plain-read bf16
   server's or leaving it only at a position whose own top-2 logit gap is
   within the gap spread of two right reads of the model (``gap_spread``,
   measured in the phase, at most ``NEAR_TIE_CAP``); identical requests and
   divergences reported;
6. K3 and K4, the flash backward (dQ and dK/dV), against their plain
   PyTorch version at the training shape [16, 8, 128, 32] (f32 causal with
   and without a key mask, bf16) and at [2, 8, 2048, 128] causal (f32,
   bf16); two calls must be bitwise equal; timed beside the plain version
   and the backward of SDPA as a yardstick (its device time per call and
   the SDPA backend that ran);
7. training: the full-width model trained with the conf's Adam through
   ``do_step`` on a 16 x 128-token batch, on the card and on the CPU from
   the same weights: first-step gradients and three steps' losses agree,
   each step launches K1, K3 and K4 ``n_blocks`` times, the loss falls over
   20 more steps on the batch, and the step time is reported.

Phases 2, 3 and 6 time each case twice: CUDA events around 50 wrapper
calls (``ms``: the wrapper's host work included, which sets the pace once
a kernel takes a few µs) and the kernel's own device time per launch from
one short ``torch.profiler`` window (``device_ms``; for K2 per wrapper
call, the split chunk walk's merge pass included), with the plain
version's and the yardstick's device time per call beside it.

The main path is phases 4-5 (serving), phases 4b-5c (loading a zip,
sampled and bf16 serving) and phase 7 (training). The launch counters are
zeroed just before each of the three and read just after (phase 6's
comparison launches are not counted); every kernel must have run on the
main path, K2's chunk route and its merge pass included, and each path must
have launched its own kernels. The script
prints the card's name and power limit, one ``{"kernels": [...]}`` line with
each kernel's launches, error, times and bound, and, last, the result line
``{"ok": true, "device": {...}}``. Matmuls run in full f32 (TF32 off).

Options: ``--out DIR`` also writes everything measured to
``DIR/chip_smoke.json``; ``--verbose-build`` prints the kernel build's
compiler lines; ``--profile`` adds, after the main path, one f32 serve, one
phase-5b mixed greedy/sampled serve and five training steps under
``torch.profiler`` (device busy time against the wall clock, kernels by
device time), with their tables in ``DIR/serve_profile.txt``,
``DIR/serve_profile_sampled.txt`` and ``DIR/train_profile.txt`` when
``--out`` is given.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# Published H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s and the
# bf16 tensor cores. "f32" is the least time f32-accurate work can take:
# three TF32 tensor-core products per product (hi·hi + hi·lo + lo·hi, as K1
# runs them) at 495 TFLOP/s, so 165 TFLOP/s, above the CUDA cores' 67.
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS_S = {"f32": 495e12 / 3, "bf16": 989e12}

SLICE = dict(num_labels=256, max_length=128, d_model=256, n_heads=8,
             n_blocks=4, max_cache=512)
SERVER = dict(slots=8, page_size=16, prefill_chunk=256, steps_per_dispatch=4)
# phase-5 prompt lengths: 8..300 tokens, five past prefill_chunk
SERVE_LENS = [8, 300, 270, 257, 12, 64, 129, 31, 200, 16, 99, 280, 45, 150,
              9, 256]
# phase-7 training batch: 16 sequences of max_length tokens
TRAIN_BATCH = 16
TRAIN_STEPS = 20
# phase-6 cases: (name, B, H, T, d, dtype, causal, masked); the first three
# are the training shape
BWD_CASES = [
    ("slice_f32_causal", 16, 8, 128, 32, torch.float32, True, False),
    ("slice_f32_causal_mask", 16, 8, 128, 32, torch.float32, True, True),
    ("slice_bf16_causal", 16, 8, 128, 32, torch.bfloat16, True, False),
    ("long_f32_causal", 2, 8, 2048, 128, torch.float32, True, False),
    ("long_bf16_causal", 2, 8, 2048, 128, torch.bfloat16, True, False),
]
# phase-6 tolerances on max|err| / max|g|. Against the plain backward: f32
# runs each product on the tensor cores as three TF32 products (about 2^-21
# relative per product; one TF32 product would read ~1e-3) and sums each
# tile's dQ/dK/dV in fresh accumulators added by f32 adds, since the tensor
# core's truncating accumulation over the 2048 rows of the long case read
# 2.6e-5 of max|dV| (H100). The kernels measured at most 4.4e-6 at T=2048
# and 2.5e-6 at the training shape; the CPU rehearsal of the design
# (tests/test_torch_flash_backward.py) reads 1.3e-6. bf16: one bf16
# rounding step of the output. Against the SDPA backward, an independent
# implementation (bf16: its own bf16 roundings), looser.
BWD_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
SDPA_TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}
REPORT: dict = {}


def log(msg):
    print(msg, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0].strip()


def time_ms(fn, iters=50, warmup=5):
    """Mean device time of one ``fn()`` from CUDA events around ``iters``
    calls, after ``warmup`` calls (L2 warm)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def dev_us(e):
    """Self device time (µs) of one ``key_averages()`` row."""
    return getattr(e, "self_device_time_total", None) or getattr(
        e, "self_cuda_time_total", 0)


def device_ms(fn, match=None, iters=20, windows=3):
    """Device time of ``fn()`` from a short ``torch.profiler`` window over
    ``iters`` calls (after 3 warm-up calls): with ``match``, the self device
    time of the kernels whose name holds it per launch, else every device
    activity's per call. Device activities are the rows with device time
    and no CPU time. A window that recorded no such activity is taken
    again, up to ``windows`` times. Returns ``(ms, launches per call)``."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    seen = []
    for _ in range(windows):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us = n = 0
        seen = []
        for e in prof.key_averages():
            if dev_us(e) > 0 and e.self_cpu_time_total == 0:
                seen.append(e.key[:60])
                if match is None or match in e.key:
                    us += dev_us(e)
                    n += e.count
        if n > 0:
            return (us / 1e3 / (n if match else iters)), n / iters
    raise AssertionError(f"profiler saw no device activity "
                         f"({match or 'any'}) in {windows} windows; "
                         f"device rows: {seen[:5]}")


def bound_ms(nbytes, flops, kind):
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS_S[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check(ok, what):
    if not ok:
        raise AssertionError(what)


def visible_pairs(B, H, T, causal, mask):
    """(row, key) pairs the attention computes: keys at or before the row
    when causal, and valid in the key mask."""
    if mask is None:
        return B * H * (T * (T + 1) // 2 if causal else T * T)
    valid = (mask != 0).long().cpu()
    per_row = valid.cumsum(1) if causal else valid.sum(1, keepdim=True)
    return H * int(per_row.expand(B, T).sum())


def mask_for(g, B, T, dev):
    """A [B, T] key mask of right padding, row 0 unpadded; key 0 is valid
    in every row, so no causal query row is fully masked."""
    lens = torch.randint(1, T + 1, (B,), generator=g)
    lens[0] = T
    return (torch.arange(T)[None] < lens[:, None]).float().to(dev)


# ----------------------------------------------------------------- phase 2
def phase_flash(dev):
    from deeplearning4j_torch.ops import flash_attention as fa

    F = torch.nn.functional
    g = torch.Generator(device="cpu").manual_seed(1)
    results = {}

    def qkv(B, H, T, d, dtype):
        return [torch.randn(B, H, T, d, generator=g).to(dev, dtype)
                for _ in range(3)]

    cases = [("slice_f32_causal", 8, 8, 128, 32, torch.float32, True, False,
              1e-4),
             ("slice_f32_causal_mask", 8, 8, 128, 32, torch.float32, True,
              True, 1e-4),
             ("slice_f32_full_mask", 8, 8, 128, 32, torch.float32, False,
              True, 1e-4),
             ("slice_bf16_causal", 8, 8, 128, 32, torch.bfloat16, True,
              False, 2e-2),
             # the training step's shape (phase 7)
             ("train_f32_causal", 16, 8, 128, 32, torch.float32, True, False,
              1e-4),
             ("long_f32_causal", 2, 8, 2048, 128, torch.float32, True, False,
              1e-4),
             # at T=2048 a row averages hundreds of keys and |O| is a few
             # hundredths, so bf16 is held tighter than at the slice's shape
             ("long_bf16_causal", 2, 8, 2048, 128, torch.bfloat16, True,
              False, 8e-3)]
    for name, B, H, T, d, dtype, causal, masked, atol in cases:
        q, k, v = qkv(B, H, T, d, dtype)
        m = mask_for(g, B, T, dev) if masked else None
        o, lse = fa.flash_attention_forward(q, k, v, causal=causal, mask=m)
        again = fa.flash_attention_forward(q, k, v, causal=causal, mask=m)
        po, plse = fa.flash_attention_plain(q, k, v, causal=causal, mask=m)
        torch.cuda.synchronize()
        check(torch.equal(o, again[0]) and torch.equal(lse, again[1]),
              f"K1 {name}: two calls differ (not deterministic)")
        err = (o.float() - po.float()).abs().max().item()
        lerr = (lse - plse).abs().max().item()
        check(o.dtype == dtype and torch.isfinite(o.float()).all().item(),
              f"K1 {name}: dtype or non-finite output")
        check(err <= atol and lerr <= max(atol, 1e-4),
              f"K1 {name}: max |O err| {err:.3g}, |lse err| {lerr:.3g} > "
              f"{atol}")
        kernel = lambda: fa.flash_attention_forward(  # noqa: E731
            q, k, v, causal=causal, mask=m)
        plain = lambda: fa.flash_attention_plain(  # noqa: E731
            q, k, v, causal=causal, mask=m)
        ms = time_ms(kernel)
        plain_ms = time_ms(plain, iters=20)
        if m is None:
            sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
                q, k, v, is_causal=causal)
        else:
            keep = (m != 0)[:, None, None, :]
            if causal:
                keep = keep & torch.ones(T, T, dtype=torch.bool,
                                         device=dev).tril()
            sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
                q, k, v, attn_mask=keep)
        sdpa_ms = time_ms(sdpa)
        kdev, _ = device_ms(kernel, "flash_fwd_kernel")
        plain_dev, _ = device_ms(plain, iters=5)
        sdpa_dev, _ = device_ms(sdpa)
        isz = torch.tensor([], dtype=dtype).element_size()
        nbytes = 4 * B * H * T * d * isz + B * H * T * 4 \
            + (B * T * 4 if masked else 0)
        flops = 4 * d * visible_pairs(B, H, T, causal, m)
        bms, by = bound_ms(nbytes, flops,
                           "bf16" if dtype == torch.bfloat16 else "f32")
        results[name] = dict(shape=[B, H, T, d], dtype=str(dtype),
                             causal=causal, masked=masked, max_abs_err=err,
                             lse_err=lerr, deterministic=True, ms=ms,
                             device_ms=kdev, plain_ms=plain_ms,
                             plain_device_ms=plain_dev, library_ms=sdpa_ms,
                             library_device_ms=sdpa_dev, bound_ms=bms,
                             bound_by=by)
        log(f"  K1 {name:22s} err {err:.2e} lse {lerr:.2e} (atol {atol}), "
            f"bitwise repeatable; kernel {ms:.4f} ms (device {kdev:.4f})  "
            f"plain {plain_ms:.4f} ({plain_dev:.4f})  sdpa {sdpa_ms:.4f} "
            f"({sdpa_dev:.4f})  bound {bms:.4f} ms ({by})")
    return results


# ----------------------------------------------------------------- phase 6
def phase_flash_bwd(dev):
    """K3 (dQ) and K4 (dK/dV) against the plain backward on the same
    inputs, K1's own o and lse, and against the SDPA backward. Errors are
    relative to the largest reference gradient. Returns {case:
    measurements}."""
    from deeplearning4j_torch import kernels
    from deeplearning4j_torch.ops import flash_attention as fa

    F = torch.nn.functional
    ext = kernels.load()
    g = torch.Generator(device="cpu").manual_seed(6)
    results = {}

    def rel_errs(got, refs):
        return {n: ((a.float() - b.float()).abs().max()
                    / b.float().abs().max()).item()
                for n, a, b in zip(("dq", "dk", "dv"), got, refs)}

    for name, B, H, T, d, dtype, causal, masked in BWD_CASES:
        tol, sdpa_tol = BWD_TOL[dtype], SDPA_TOL[dtype]
        q, k, v, do = [torch.randn(B, H, T, d, generator=g).to(dev, dtype)
                       for _ in range(4)]
        m = mask_for(g, B, T, dev) if masked else None
        o, lse = fa.flash_attention_forward(q, k, v, causal=causal, mask=m)
        grads = fa.flash_attention_backward(q, k, v, o, lse, do,
                                            causal=causal, mask=m)
        again = fa.flash_attention_backward(q, k, v, o, lse, do,
                                            causal=causal, mask=m)
        plain = fa.flash_attention_backward_plain(q, k, v, o, lse, do,
                                                  causal=causal, mask=m)
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        if m is None:
            out = F.scaled_dot_product_attention(*leaves, is_causal=causal)
        else:
            keep = (m != 0)[:, None, None, :]
            if causal:
                keep = keep & torch.ones(T, T, dtype=torch.bool,
                                         device=dev).tril()
            out = F.scaled_dot_product_attention(*leaves, attn_mask=keep)
        sdpa = torch.autograd.grad(out, leaves, do, retain_graph=True)
        sdpa_backend = type(out.grad_fn).__name__
        torch.cuda.synchronize()
        for gname, got in zip(("dq", "dk", "dv"), grads):
            check(got.dtype == dtype and torch.isfinite(got.float()).all()
                  .item(), f"flash bwd {name}: {gname} dtype or non-finite")
        errs, sdpa_errs = rel_errs(grads, plain), rel_errs(grads, sdpa)
        abs_errs = {n: (a.float() - b.float()).abs().max().item()
                    for n, a, b in zip(("dq", "dk", "dv"), grads, plain)}
        check(max(errs.values()) <= tol,
              f"flash bwd {name}: max|err|/max|g| vs plain {errs} > {tol}")
        check(max(sdpa_errs.values()) <= sdpa_tol,
              f"flash bwd {name}: max|err|/max|g| vs SDPA {sdpa_errs} > "
              f"{sdpa_tol}")
        check(all(torch.equal(a, b) for a, b in zip(grads, again)),
              f"flash bwd {name}: two calls differ (not deterministic)")
        args = (q, k, v, do, lse, fa.attention_delta(o, do), m, causal)
        dq_ms = time_ms(lambda: ext.flash_bwd_dq(*args))
        dkv_ms = time_ms(lambda: ext.flash_bwd_dkv(*args))
        dq_dev, _ = device_ms(lambda: ext.flash_bwd_dq(*args),
                              "flash_bwd_dq_kernel")
        dkv_dev, _ = device_ms(lambda: ext.flash_bwd_dkv(*args),
                               "flash_bwd_dkv_kernel")
        plain_bwd = lambda: fa.flash_attention_backward_plain(  # noqa: E731
            q, k, v, o, lse, do, causal=causal, mask=m)
        sdpa_bwd = lambda: torch.autograd.grad(  # noqa: E731
            out, leaves, do, retain_graph=True)
        plain_ms = time_ms(plain_bwd, iters=20)
        plain_dev, _ = device_ms(plain_bwd, iters=5)
        sdpa_ms = time_ms(sdpa_bwd)
        sdpa_dev, _ = device_ms(sdpa_bwd)
        # bytes: q, k, v, dO in, the kernel's outputs, lse and delta (and
        # the mask); operations: 6d (K3) and 8d (K4) per visible pair
        isz = torch.tensor([], dtype=dtype).element_size()
        tensor = B * H * T * d * isz
        rows = 2 * B * H * T * 4 + (B * T * 4 if masked else 0)
        pairs = visible_pairs(B, H, T, causal, m)
        kind = "bf16" if dtype == torch.bfloat16 else "f32"
        dq_bound, dq_by = bound_ms(5 * tensor + rows, 6 * d * pairs, kind)
        dkv_bound, dkv_by = bound_ms(6 * tensor + rows, 8 * d * pairs, kind)
        results[name] = dict(
            shape=[B, H, T, d], dtype=str(dtype), causal=causal,
            masked=masked, rel_err=errs, max_abs_err=abs_errs,
            tolerance=tol, sdpa_rel_err=sdpa_errs, sdpa_tolerance=sdpa_tol,
            deterministic=True, pairs=pairs,
            dq=dict(ms=dq_ms, device_ms=dq_dev, bound_ms=dq_bound,
                    bound_by=dq_by),
            dkv=dict(ms=dkv_ms, device_ms=dkv_dev, bound_ms=dkv_bound,
                     bound_by=dkv_by),
            plain_ms=plain_ms, plain_device_ms=plain_dev,
            library_ms=sdpa_ms, library_device_ms=sdpa_dev,
            library_backend=sdpa_backend)
        log(f"  K3/K4 {name:22s} rel err vs plain {max(errs.values()):.2e} "
            f"(tol {tol}), vs SDPA {max(sdpa_errs.values()):.2e} (tol "
            f"{sdpa_tol}), bitwise repeatable; dq {dq_ms:.4f} ms (device "
            f"{dq_dev:.4f}, bound {dq_bound:.4f}, {dq_by})  dkv {dkv_ms:.4f} "
            f"ms (device {dkv_dev:.4f}, bound "
            f"{dkv_bound:.4f}, {dkv_by})  plain {plain_ms:.4f} ms (device "
            f"{plain_dev:.4f})  sdpa bwd {sdpa_ms:.4f} ms (device "
            f"{sdpa_dev:.4f}, {sdpa_backend})")
    return results


# ----------------------------------------------------------------- phase 3
def device_ms_beside(fn, plain, match, expect, iters, plain_iters,
                     windows=3):
    """Device time per call of ``fn`` (its kernels whose name holds
    ``match``) and of ``plain`` (every other device activity) from one
    ``torch.profiler`` window over ``iters`` calls of ``fn`` and
    ``plain_iters`` of ``plain``, after warm-up calls. A window that did not
    see ``expect`` matching launches per call is taken again, up to
    ``windows`` times. Returns ``(ms, launches per call, plain ms)``."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
        plain()
    torch.cuda.synchronize()
    for _ in range(windows):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            for _ in range(plain_iters):
                plain()
            torch.cuda.synchronize()
        us = n = other = 0
        for e in prof.key_averages():
            if dev_us(e) > 0 and e.self_cpu_time_total == 0:
                if match in e.key:
                    us += dev_us(e)
                    n += e.count
                else:
                    other += dev_us(e)
        if n > 0 and round(n / iters) == expect:
            break
    check(n > 0, f"profiler saw no device activity ({match}) in {windows} "
                 f"windows")
    return us / 1e3 / iters, n / iters, other / 1e3 / plain_iters


#: phase-3 16-bit tolerances on max|err| / max|o| (``o`` the reference).
#: Against the plain version run on f32-widened copies of the same inputs
#: and rounded to q's dtype (the Pallas kernel's own arithmetic: widen as
#: the pages land, f32 throughout, one rounding of o): one ulp of max|o| in
#: q's dtype, since the two sides may round a value either way of a
#: rounding boundary. Against the plain version at q's dtype (JAX's XLA
#: gather at that dtype: scores, softmax weights and w·V each rounded to
#: 16 bits, int8 pages dequantized in 16 bits), looser: about four times
#: what the plain version at q's dtype reads against its f32-widened run
#: on these cases on the CPU (bf16 up to 0.036 with int8 pools and 0.010
#: with bf16 pools; f16 up to 0.0011).
PAGED16_TOL = {torch.bfloat16: (2.0 ** -7, 2.0 ** -4),
               torch.float16: (2.0 ** -10, 2.0 ** -8)}
DTYPE_TAG = {torch.float32: "f32", torch.bfloat16: "bf16",
             torch.float16: "f16"}


def paged_pool(g, B, H, ps, d, Tmax, quant, dev, dtype=torch.float32):
    """A seeded pool of B·NP + 1 pages (of ``dtype``, or int8 codes with
    scales) and a block table over its pages 1.., row B-1 read from page 0
    only."""
    NP = Tmax // ps
    P = B * NP + 1
    if quant:
        kp = torch.randint(-127, 128, (P, H, ps, d), generator=g,
                           dtype=torch.int8).to(dev)
        vp = torch.randint(-127, 128, (P, H, ps, d), generator=g,
                           dtype=torch.int8).to(dev)
        ks = (torch.rand(P, H, ps, generator=g) * 0.05).to(dev)
        vs = (torch.rand(P, H, ps, generator=g) * 0.05).to(dev)
    else:
        kp = torch.randn(P, H, ps, d, generator=g).to(dev, dtype)
        vp = torch.randn(P, H, ps, d, generator=g).to(dev, dtype)
        ks = vs = None
    bt = (torch.randperm(P - 1, generator=g)[:B * NP] + 1).reshape(
        B, NP).to(torch.int32)
    bt[B - 1] = 0                      # a row read from page 0 only
    return kp, vp, ks, vs, bt.to(dev)


def paged_case(g, T, pool, dev, lean=False, qdtype=torch.float32):
    """One K2 case on ``pool`` with a ``qdtype`` query: against the plain
    version (rows that see no column are checked finite only; a 16-bit
    query against the plain version on f32-widened inputs and at its own
    dtype), two calls bitwise equal, on the chunk route also the other walk
    (unsplit where the rule splits, four ranges where it does not), then
    timed (``lean``: fewer calls). Returns (name, measurements)."""
    from deeplearning4j_torch import kernels
    from deeplearning4j_torch.nn.conf.layers import paged_attention as ppa

    kp, vp, ks, vs, bt = pool
    quant = ks is not None
    B, NP = bt.shape
    _P, H, ps, d = kp.shape
    Tmax = NP * ps
    pos = torch.randint(0, Tmax - T + 1, (B,), generator=g)
    pos[1] = (pos[1] // ps) * ps       # exactly on a page boundary
    pos = pos.to(torch.int32).to(dev)
    key_valid = None
    has_valid = torch.ones(B, H, T, 1, dtype=torch.bool, device=dev)
    if T > 1:
        mask = torch.ones(B, T)
        mask[2, 100:] = 0              # right padding
        mask[B - 1] = 0                # all masked, on page 0
        pos[B - 1] = 0
        mask = mask.to(dev)
        key_valid = ppa._key_valid_plane(mask, pos, T, Tmax).float()
        col = torch.arange(Tmax, device=dev)
        row = torch.arange(T, device=dev)
        vis = (col[None, None] <= pos.long()[:, None, None]
               + row[None, :, None]) & (key_valid[:, None] != 0)
        has_valid = vis.any(-1)[:, None, :, None].expand(B, H, T, 1)
    q = torch.randn(B, H, T, d, generator=g).to(dev, qdtype)
    args = (q, kp, vp, bt, pos)
    kw = dict(key_valid=key_valid, kscales=ks, vscales=vs)
    o = ppa.paged_attention(*args, **kw)
    again = ppa.paged_attention(*args, **kw)
    po = ppa.paged_attention_plain(*args, **kw)
    wide = qdtype != torch.float32
    if wide:
        # the Pallas kernel's arithmetic: every value widened to f32, one
        # rounding of o to q's dtype
        pw = ppa.paged_attention_plain(
            q.float(), kp if quant else kp.float(),
            vp if quant else vp.float(), bt, pos, **kw).to(qdtype)
    torch.cuda.synchronize()

    def err_of(x, ref):
        return torch.where(has_valid, (x.float() - ref.float()).abs(),
                           torch.zeros_like(x, dtype=torch.float32)
                           ).max().item()

    def top(ref):
        return torch.where(has_valid, ref.float().abs(),
                           torch.zeros_like(ref, dtype=torch.float32)
                           ).max().item()

    qtag = "" if qdtype == torch.float32 else DTYPE_TAG[qdtype]
    kvtag = "int8" if quant else DTYPE_TAG[kp.dtype]
    name = (f"{kvtag}{qtag if quant else ''}_T{T}_Tmax{Tmax}"
            + (f"_d{d}" if d != 32 else "") + (f"_ps{ps}" if ps != 16 else ""))
    check(o.dtype == qdtype and torch.isfinite(o.float()).all().item(),
          f"K2 {name}: dtype or non-finite output (garbage page or masked "
          f"row)")
    if wide:
        rtol_w, rtol_n = PAGED16_TOL[qdtype]
        ref = pw
        atol = rtol_w * top(pw)
        native_err = err_of(o, po)
        native_atol = rtol_n * top(po)
        check(native_err <= native_atol,
              f"K2 {name}: max |err| vs the plain version at "
              f"{DTYPE_TAG[qdtype]} {native_err:.3g} > {native_atol:.3g}")
    else:
        ref = po
        atol = 1e-3 if quant else 1e-4
        native_err = native_atol = None
    err = err_of(o, ref)
    check(err <= atol, f"K2 {name}: max |err| {err:.3g} > {atol:.3g}")
    check(torch.equal(o, again),
          f"K2 {name}: two calls differ (not deterministic)")
    # the route paged_attn.cu takes: T <= 4 decode, else chunk
    route = "decode" if T <= ppa.DECODE_MAX_T else "chunk"
    splits, other, smem = 1, None, None
    if route == "chunk":
        ext = kernels.load()
        kind = ppa.pool_kind(kp)
        splits = ext.paged_attn_splits(B, H, T, d, ps, NP, kind)
        smem = ext.paged_chunk_smem(d, kind, NP)
        forced = 1 if splits > 1 else 4
        ow = ext.paged_attn(q, kp, vp, ks, vs, bt, pos, key_valid, forced)
        torch.cuda.synchronize()
        other = dict(splits=forced, max_abs_err=err_of(ow, ref))
        check(torch.isfinite(ow.float()).all().item()
              and other["max_abs_err"] <= atol,
              f"K2 {name} with {forced} split(s): max |err| "
              f"{other['max_abs_err']:.3g} > {atol:.3g} or non-finite")
    kernel = lambda: ppa.paged_attention(*args, **kw)  # noqa: E731
    plain = lambda: ppa.paged_attention_plain(*args, **kw)  # noqa: E731
    ms = time_ms(kernel, iters=20 if lean else 50)
    plain_ms = time_ms(plain, iters=5 if lean else 20)
    # per call: the chunk route's split walk is two launches (walk, merge)
    kdev, per_call, plain_dev = device_ms_beside(
        kernel, plain, "paged_", 2 if splits > 1 else 1,
        iters=10 if lean else 20, plain_iters=3 if lean else 5)
    # bytes this run's data needs: each distinct (page, offset) K/V slot
    # the rows walk, read once (row B-1 walks page 0 over and over: its ps
    # slots count once) at the pool's element size (and int8's two f32
    # scales), the walked block-table entries and plane columns, q and o at
    # q's element size, and pos
    lim = torch.clamp(pos.long() + T, max=Tmax).tolist()
    btc = bt.long().cpu()
    slots = torch.cat([btc[b, torch.arange(n) // ps] * ps
                       + torch.arange(n) % ps for b, n in enumerate(lim)])
    distinct = torch.unique(slots).numel()
    kv_row = d * kp.element_size() + (4 if quant else 0)
    nbytes = 2 * distinct * H * kv_row + 2 * B * H * T * d * q.element_size() \
        + sum(-(-n // ps) for n in lim) * 4 + B * 4 \
        + (sum(lim) * 4 if T > 1 else 0)
    flops = 4 * d * H * sum(sum(min(p + r + 1, Tmax) for r in range(T))
                            for p in pos.tolist())
    bms, by = bound_ms(nbytes, flops,
                       "bf16" if kp.element_size() == 2 else "f32")
    res = dict(B=B, H=H, T=T, d=d, ps=ps, Tmax=Tmax, quant=quant,
               dtype=DTYPE_TAG[qdtype], pool_dtype=kvtag, route=route,
               splits=splits, smem_bytes=smem, max_abs_err=err,
               max_rel_err=err / max(top(ref), 1e-30), tolerance=atol, native_max_abs_err=native_err,
               native_tolerance=native_atol, deterministic=True,
               other_walk=other, ms=ms, device_ms=kdev,
               device_launches_per_call=per_call, plain_ms=plain_ms,
               plain_device_ms=plain_dev, bound_ms=bms, bound_by=by,
               bound_bytes=nbytes, library_ms=None)
    extra = "" if other is None else (
        f" ({splits} split(s); {other['splits']}: err "
        f"{other['max_abs_err']:.2e}; {smem} B smem per CTA)")
    native = "" if native_err is None else (
        f", at {DTYPE_TAG[qdtype]} {native_err:.2e} (atol "
        f"{native_atol:.2e})")
    log(f"  K2 {name:24s} {route:6s} err {err:.2e} (atol {atol:.2e})"
        f"{native}, bitwise repeatable{extra}; kernel {ms:.4f} ms (device "
        f"{kdev:.4f})  plain {plain_ms:.4f} ({plain_dev:.4f})  bound "
        f"{bms:.4f} ms ({by})")
    return name, res


# phase-3 chunk-route cases added with its tensor-core design: (T, d, ps,
# quant) at Tmax 512, beside the decode/chunk boundary and 256-row cases:
# the serve's second-round bucket (48), one full q tile (64), two q tiles
# with a ragged second (100), the wide heads (d = 64, 128) and a page size
# other than 16
PAGED_EXTRA = [(48, 32, 16, False), (48, 32, 16, True), (64, 32, 16, False),
               (100, 32, 16, False), (100, 32, 16, True),
               (256, 64, 16, False), (256, 64, 16, True),
               (256, 128, 16, False), (256, 128, 16, True),
               (100, 32, 8, False)]
# phase-3 16-bit cases: (q dtype, int8 pools, T, d, ps) at Tmax 512:
# both routes (T = 1, 4 decode; 5, 48, 256 chunk) at the slice's d=32 in
# bf16, and f16 and int8-under-bf16 at the same T; d = 64, 128 and ps 8
PAGED16_CASES = (
    [(torch.bfloat16, False, T, 32, 16) for T in (1, 4, 5, 48, 256)]
    + [(torch.float16, False, T, 32, 16) for T in (1, 4, 5, 48, 256)]
    + [(torch.bfloat16, True, T, 32, 16) for T in (1, 4, 5, 48, 256)]
    + [(dt, False, T, d, 16) for dt in (torch.bfloat16, torch.float16)
       for d in (64, 128) for T in (1, 256)]
    + [(torch.bfloat16, True, 256, 128, 16), (torch.bfloat16, False, 100, 32, 8),
       (torch.float16, False, 48, 32, 8)])


def phase_paged(dev):
    g = torch.Generator(device="cpu").manual_seed(2)
    results = {}
    B, H, ps, d = 8, 8, 16, 32
    for Tmax in (512, 2048):
        for quant in (False, True):
            pool = paged_pool(g, B, H, ps, d, Tmax, quant, dev)
            for T in (1, 4, 5, 256):
                name, res = paged_case(g, T, pool, dev)
                results[name] = res
    g = torch.Generator(device="cpu").manual_seed(5)
    for T, d, ps, quant in PAGED_EXTRA:
        pool = paged_pool(g, B, H, ps, d, 512, quant, dev)
        name, res = paged_case(g, T, pool, dev, lean=True)
        results[name] = res
    g = torch.Generator(device="cpu").manual_seed(12)
    for qdtype, quant, T, d, ps in PAGED16_CASES:
        pool = paged_pool(g, B, H, ps, d, 512, quant, dev, dtype=qdtype)
        name, res = paged_case(g, T, pool, dev, lean=True, qdtype=qdtype)
        results[name] = res
    return results


# --------------------------------------------------------------- the model
def numpy_params(net, seed, gain=2.0):
    """Seeded weights drawn with numpy, at a gain that keeps the greedy
    streams varied."""
    rs = np.random.RandomState(seed)
    out = {}
    for v, p in net.params.items():
        out[v] = {}
        for k, t in p.items():
            shp = tuple(t.shape)
            if k.startswith("W"):
                a = rs.randn(*shp) * gain / np.sqrt(shp[0])
            elif k == "gamma":
                a = 1.0 + 0.1 * rs.randn(*shp)
            else:
                a = 0.1 * rs.randn(*shp)
            out[v][k] = a.astype(np.float32)
    return out


def build_nets():
    from deeplearning4j_torch.models.zoo import TransformerLM
    from deeplearning4j_torch.utils.convert import params_from_jax

    net = TransformerLM(**SLICE).init(device="cuda")
    params = numpy_params(net, seed=0)
    params_from_jax(params, net)
    cpu = TransformerLM(**SLICE).init(device="cpu")
    params_from_jax(params, cpu)
    return net, cpu


def phase_model(net, cpu):
    from deeplearning4j_torch import kernels

    rs = np.random.RandomState(3)
    V, T = SLICE["num_labels"], SLICE["max_length"]
    x = np.eye(V, dtype=np.float32)[rs.randint(0, V, (8, T))]
    before = kernels.LAUNCHES["flash_fwd"]
    out = net.output(x)
    torch.cuda.synchronize()
    launches = kernels.LAUNCHES["flash_fwd"] - before
    ref = cpu.output(x)
    err = (out.cpu() - ref).abs().max().item()
    check(out.shape == (8, T, V) and torch.isfinite(out).all().item(),
          "model: output shape or non-finite values")
    check(err <= 1e-4, f"model: output() vs CPU plain path max |err| "
                       f"{err:.3g} > 1e-4")
    check(launches == SLICE["n_blocks"],
          f"model: K1 launched {launches} times in one output(), expected "
          f"{SLICE['n_blocks']}")
    with torch.inference_mode():
        ms = time_ms(lambda: net.output(x), iters=20)
    log(f"  output() [8, {T}, {V}]: max |err| vs CPU {err:.2e}, K1 "
        f"launches {launches}, {ms:.3f} ms")
    return dict(max_abs_err=err, k1_launches=launches, output_ms=ms)


def serve(net, reqs, **kw):
    """Serve ``reqs``, each ``(prompt, max_tokens)`` or ``(prompt,
    max_tokens, sampling options)``, through one ``GenerationServer`` on
    the card. Returns (token lists, wall seconds, stats)."""
    from deeplearning4j_torch.parallel.generation import GenerationServer

    srv = GenerationServer(net, SLICE["num_labels"], device="cuda",
                           **SERVER, **kw)
    try:
        t0 = time.perf_counter()
        futs = [srv.submit(r[0], r[1], **(r[2] if len(r) > 2 else {}))
                for r in reqs]
        outs = [f.result(timeout=600).tolist() for f in futs]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        stats = srv.stats()
    finally:
        srv.close()
    return outs, wall, stats


def serve_requests():
    """The phase-5 requests: seeded prompts of SERVE_LENS tokens, 32 new
    tokens each."""
    rs = np.random.RandomState(4)
    return [(rs.randint(0, SLICE["num_labels"], n), 32) for n in SERVE_LENS]


def first_divergence(got, want):
    return next((j for j, (a, b) in enumerate(zip(got, want)) if a != b),
                None)


def phase_serve(net, card):
    from deeplearning4j_torch import kernels

    reqs = serve_requests()
    serve(net, reqs[:2])                              # warm-up
    results = {}
    for kv in (None, "int8"):
        tag = kv or "f32"
        before = kernels.LAUNCHES["paged_attn"]
        before_chunk = kernels.LAUNCHES["paged_attn_chunk"]
        outs, wall, st = serve(net, reqs, kv_dtype=kv)
        launches = kernels.LAUNCHES["paged_attn"] - before
        chunk = kernels.LAUNCHES["paged_attn_chunk"] - before_chunk
        expect = SLICE["n_blocks"] * (st["prefill_rounds"]
                                      + SERVER["steps_per_dispatch"]
                                      * st["decode_steps"])
        check(launches == expect and launches > 0,
              f"serve {tag}: K2 launched {launches} times, the schedule "
              f"needs {expect}")
        check(chunk == SLICE["n_blocks"] * st["prefill_rounds"],
              f"serve {tag}: K2's chunk route launched {chunk} times for "
              f"{st['prefill_rounds']} prefill rounds")
        ref, ref_wall, _ = serve(net, reqs, kv_dtype=kv,
                                 paged_attention="stock")
        for i, (got, want) in enumerate(zip(outs, ref)):
            if got != want:
                k = first_divergence(got, want)
                gap = top2_gap(net, reqs[i][0], want[:k])
                raise AssertionError(
                    f"serve {tag}: request {i} diverges from the stock "
                    f"server at token {k} ({got[k]} vs {want[k]}); top-2 "
                    f"log-prob gap there {gap:.3g}")
        ntok = sum(len(o) for o in outs)
        check(all(len(o) == 32 for o in outs), f"serve {tag}: short output")
        check(len({t for o in outs for t in o}) > 4,
              f"serve {tag}: degenerate greedy streams")
        results[tag] = dict(requests=len(reqs), tokens=ntok, wall_s=wall,
                            tokens_per_s=ntok / wall, stock_wall_s=ref_wall,
                            stock_tokens_per_s=ntok / ref_wall,
                            k2_launches=launches, k2_chunk_launches=chunk,
                            prefill_rounds=st["prefill_rounds"],
                            decode_steps=st["decode_steps"], streams=outs)
        log(f"  serve {tag}: {len(reqs)} requests, {ntok} tokens in "
            f"{wall:.3f} s = {ntok / wall:.1f} tok/s (stock paged read: "
            f"{ntok / ref_wall:.1f} tok/s); K2 launches {launches} "
            f"({st['prefill_rounds']} prefill rounds, {st['decode_steps']} "
            f"decode dispatches); tokens equal to stock; [{card}]")
    return results


def phase_zip(net, greedy, card):
    """Phase 4b: the full-width net through the port's model zip: saved
    with ``save_model`` (``coefficients.bin`` must be ``params_flat()`` as
    little-endian f32, byte for byte), loaded back with
    ``load_model(..., device="cuda")``, its ``output()`` on the phase-4
    probe bitwise the in-memory net's (same kernels, same parameters), and
    its greedy serve of the phase-5 requests token for token phase 5's
    (``greedy``). Returns (the loaded net, measurements)."""
    import tempfile
    import zipfile

    from deeplearning4j_torch.utils.model_serializer import (load_model,
                                                             save_model)

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "transformer_lm.zip")
        t0 = time.perf_counter()
        save_model(net, path)
        save_s = time.perf_counter() - t0
        with zipfile.ZipFile(path) as zf:
            coeff = zf.read("coefficients.bin")
            entries = sorted(zf.namelist())
        zip_bytes = os.path.getsize(path)
        check(coeff == net.params_flat().astype("<f4").tobytes(),
              "zip: coefficients.bin differs from params_flat() as <f4")
        t0 = time.perf_counter()
        loaded = load_model(path, device="cuda")
        load_s = time.perf_counter() - t0
    check(loaded.device.type == "cuda" and all(
        t.device.type == "cuda" for p in loaded.params.values()
        for t in p.values()), "zip: load_model(device='cuda') left a "
                              "parameter off the card")
    rs = np.random.RandomState(3)
    V, T = SLICE["num_labels"], SLICE["max_length"]
    x = np.eye(V, dtype=np.float32)[rs.randint(0, V, (8, T))]
    out, want = loaded.output(x), uncounted(net.output, x)
    torch.cuda.synchronize()
    err = (out - want).abs().max().item()
    check(torch.equal(out, want), f"zip: the loaded net's output() differs "
                                  f"from the in-memory net's (max |err| "
                                  f"{err:.3g})")
    outs, wall, _ = serve(loaded, serve_requests())
    check(outs == greedy, "zip: the loaded net's greedy serve differs from "
                          "phase 5's tokens")
    ntok = sum(len(o) for o in outs)
    log(f"  zip: {zip_bytes} bytes {entries}; coefficients.bin == "
        f"params_flat() as <f4; saved in {save_s:.3f} s, loaded on the card "
        f"in {load_s:.3f} s; output() bitwise equal; {len(outs)} greedy requests "
        f"equal to phase 5's ({ntok / wall:.1f} tok/s); [{card}]")
    return loaded, dict(zip_bytes=zip_bytes, entries=entries, save_s=save_s,
                        load_s=load_s, output_bitwise=True,
                        serve_tokens_equal=True, tokens_per_s=ntok / wall)


#: phase-5b sampling: the phase-5 prompts, odd ones sampled at this
#: temperature and top_k, each with its own seed
SAMPLED = dict(temperature=0.8, top_k=40)


def sampled_requests():
    """The phase-5 requests, the odd ones sampled (``SAMPLED``, seed
    1000 + i)."""
    return [(p, n, dict(SAMPLED, seed=1000 + i) if i % 2 else {})
            for i, (p, n) in enumerate(serve_requests())]


def phase_sampled(net, greedy, f32_tok_s, card):
    """Phase 5b: the phase-5 prompts as one mixed batch, 8 greedy and 8
    sampled (``SAMPLED``, seeds 1000 + i), f32 KV: the kernel server's
    streams equal the plain-read server's (``paged_attention="xla"``)
    token for token, a second identical serve repeats them, and the greedy
    requests equal phase 5's."""
    reqs = sampled_requests()
    outs, wall, st = serve(net, reqs)
    again, wall2, _ = serve(net, reqs)
    ref, ref_wall, _ = serve(net, reqs, paged_attention="xla")
    for i, (got, want) in enumerate(zip(outs, ref)):
        if got != want:
            k = first_divergence(got, want)
            gap = top2_gap(net, reqs[i][0], want[:k])
            raise AssertionError(
                f"sampled serve: request {i} diverges from the plain-read "
                f"server at token {k} ({got[k]} vs {want[k]}); top-2 "
                f"log-prob gap there {gap:.3g}")
    check(again == outs, "sampled serve: a second identical serve differs")
    check(all(outs[i] == greedy[i] for i in range(0, len(reqs), 2)),
          "sampled serve: a greedy request differs from phase 5's tokens")
    check(any(outs[i] != greedy[i] for i in range(1, len(reqs), 2)),
          "sampled serve: every sampled stream equals its greedy one")
    ntok = sum(len(o) for o in outs)
    log(f"  sampled serve f32: {(len(reqs) + 1) // 2} greedy + "
        f"{len(reqs) // 2} sampled (T={SAMPLED['temperature']}, top_k="
        f"{SAMPLED['top_k']}), {ntok} tokens in {wall:.3f} s = "
        f"{ntok / wall:.1f} tok/s (again {ntok / wall2:.1f}; plain read "
        f"{ntok / ref_wall:.1f}; phase 5 greedy {f32_tok_s:.1f}); equal to "
        f"the plain-read server and repeatable, greedy equal to phase 5; "
        f"[{card}]")
    return dict(requests=len(reqs), tokens=ntok, wall_s=wall,
                tokens_per_s=ntok / wall, again_tokens_per_s=ntok / wall2,
                plain_tokens_per_s=ntok / ref_wall,
                greedy_tokens_per_s=f32_tok_s,
                decode_steps=st["decode_steps"], streams=outs)


#: phase-5c near-tie rule: a bf16 model's greedy stream may leave the
#: plain-read server's only at a position whose own top-2 logit gap is
#: within the spread two right reads of the model give that gap (the
#: spread compares full-sequence reads, so it already holds the drift that
#: earlier positions carry). The spread is measured in the phase: the
#: largest change of the top-2 gap, over every position of the served
#: sequences, between a forward whose attention
#: rounds scores, weights and products to bf16 (``helper="stock"``, the
#: plain read's arithmetic) and one whose attention computes in f32 (K1,
#: as K2 does). A fixed gap of 2^-4 is too tight: on an H100 a stream left
#: the plain read's at a gap of 0.0681, and on the CPU the spread of this
#: model reads 0.125 over 1,327 positions (PERF.md §6). A spread over this
#: cap fails the phase (the plain read itself would be off).
NEAR_TIE_CAP = 2.0 ** -2


def logits_of(net, seq):
    """``[len(seq), V]`` f32 output logits (the output layer's
    preactivations) of one full-sequence forward of ``seq``."""
    V = SLICE["num_labels"]
    dtype = getattr(torch, net.conf.dtype)
    x = torch.from_numpy(np.eye(V, dtype=np.float32)[np.asarray(seq)][None]
                         ).to(net.device, dtype)
    with torch.inference_mode():
        _, _, _, ins = net._forward(net.params, net.state, [x], [None],
                                    collect_loss_inputs=True)
        out = net.conf.vertices["output"].layer.preactivate(
            net.params["output"], ins["output"])
    return out[0].float()


def top2_gap(net, prompt, tokens):
    """The gap between the two largest output logits after ``prompt +
    tokens`` (the top-2 log-prob gap, read before the softmax rounds) from
    a full-sequence forward, to show how close a divergence was."""
    seq = np.concatenate([np.asarray(prompt), np.asarray(tokens, np.int64)])
    top = torch.topk(logits_of(net, seq)[-1], 2).values
    return (top[0] - top[1]).item()


def uncounted(fn, *args):
    """``fn(*args)`` with the kernels' launch counters left as they were:
    the comparison forwards of a check are not the main path's launches."""
    from deeplearning4j_torch import kernels

    before = dict(kernels.LAUNCHES)
    try:
        return fn(*args)
    finally:
        kernels.LAUNCHES.update(before)


def gap_spread(net, seqs):
    """The largest change of the top-2 logit gap over every position of
    ``seqs`` between the bf16-rounding attention (``helper="stock"``) and
    K1's f32 attention, the same two tokens compared."""
    layers = [v.layer for v in net.conf.vertices.values()
              if getattr(getattr(v, "layer", None), "helper", None)]
    spread = 0.0
    for seq in seqs:
        for layer in layers:
            layer.helper = "stock"
        try:
            a = logits_of(net, seq)
        finally:
            for layer in layers:
                layer.helper = "auto"
        b = logits_of(net, seq)
        idx = torch.topk(a, 2, dim=-1).indices
        ga = a.gather(1, idx[:, :1]) - a.gather(1, idx[:, 1:])
        gb = b.gather(1, idx[:, :1]) - b.gather(1, idx[:, 1:])
        spread = max(spread, (ga - gb).abs().max().item())
    return spread


def phase_bf16(params, card):
    """Phase 5c (fault C1): ``TransformerLM(dtype="bfloat16")`` at full
    width, the phase-4 f32 weights cast to bf16, serves the phase-5
    requests greedy through K2 with default knobs, bf16 and int8 KV. Each
    stream equals the plain-read bf16 server's, or leaves it at a position
    where the plain stream's own top-2 logit gap is within the gap spread of
    two right reads of the model (``gap_spread``, measured on the served
    sequences); identical requests and each divergence (position, gap) are
    reported."""
    from deeplearning4j_torch import kernels
    from deeplearning4j_torch.models.zoo import TransformerLM
    from deeplearning4j_torch.utils.convert import params_from_jax

    net = TransformerLM(dtype="bfloat16", **SLICE).init(device="cuda")
    params_from_jax(params, net)
    check(net.params["attn0"]["Wq"].dtype == torch.bfloat16,
          "bf16: the model's weights are not bf16")
    reqs = serve_requests()
    results = {}
    for kv in (None, "int8"):
        tag = "bf16" if kv is None else "int8"
        before = kernels.LAUNCHES["paged_attn"]
        outs, wall, st = serve(net, reqs, kv_dtype=kv)
        launches = kernels.LAUNCHES["paged_attn"] - before
        check(launches == SLICE["n_blocks"] * (
            st["prefill_rounds"] + SERVER["steps_per_dispatch"]
            * st["decode_steps"]),
            f"bf16 serve {tag}: K2 launched {launches} times")
        ref, ref_wall, _ = serve(net, reqs, kv_dtype=kv,
                                 paged_attention="xla")
        check(all(len(o) == 32 for o in outs), f"bf16 serve {tag}: short "
                                               f"output")
        spread = uncounted(gap_spread, net, [
            np.concatenate([p, w]) for (p, _), w in zip(reqs, ref)])
        check(spread <= NEAR_TIE_CAP, f"bf16 serve {tag}: two reads of the "
                                      f"model move the top-2 gap by "
                                      f"{spread:.4f} > {NEAR_TIE_CAP}")
        divergences = []
        for i, (got, want) in enumerate(zip(outs, ref)):
            k = first_divergence(got, want)
            if k is None:
                continue
            gap = uncounted(top2_gap, net, reqs[i][0], want[:k])
            divergences.append(dict(request=i, position=k, gap=gap,
                                    tokens=[got[k], want[k]]))
            check(gap <= spread, f"bf16 serve {tag}: request {i} diverges "
                                 f"at token {k} ({got[k]} vs {want[k]}) at "
                                 f"a top-2 logit gap of {gap:.4f}, over the "
                                 f"spread {spread:.4f}")
        ntok = sum(len(o) for o in outs)
        same = len(reqs) - len(divergences)
        results[tag] = dict(tokens=ntok, wall_s=wall, tokens_per_s=ntok / wall,
                            plain_tokens_per_s=ntok / ref_wall,
                            k2_launches=launches, identical_requests=same,
                            divergences=divergences, gap_spread=spread)
        log(f"  bf16 model, {tag} KV: {len(reqs)} greedy requests served "
            f"through K2 "
            f"({launches} launches), {ntok / wall:.1f} tok/s (plain read "
            f"{ntok / ref_wall:.1f}); {same}/{len(reqs)} identical to the "
            f"plain-read server; gap spread of two reads {spread:.4f}; "
            f"divergences (request, token, top-2 logit gap there): "
            f"{[(d['request'], d['position'], round(d['gap'], 5)) for d in divergences]}; "
            f"[{card}]")
    return results


def profile_serve(net, card, out_dir, reqs=None, tag="f32"):
    """One f32 serve of ``reqs`` (the phase-5 requests; ``tag`` names
    them) under ``torch.profiler``: device busy time against the wall
    clock, and the kernels by device time (table in
    ``out_dir/serve_profile.txt``, or ``serve_profile_{tag}.txt``)."""
    from torch.profiler import ProfilerActivity, profile

    reqs = serve_requests() if reqs is None else reqs
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        outs, wall, st = serve(net, reqs)
    fname = "serve_profile.txt" if tag == "f32" else \
        f"serve_profile_{tag}.txt"
    busy_s, launches, top = profile_table(
        prof, out_dir, fname, f"{card}\nwall {wall:.6f} s\n")
    steps = st["prefill_rounds"] + SERVER["steps_per_dispatch"] \
        * st["decode_steps"]
    # K2's chunk route: its kernels (the walk and, when split, the merge)
    # are the paged kernels other than the decode route's
    chunk = [(dev_us(e), e.count, e.key) for e in prof.key_averages()
             if dev_us(e) > 0 and e.self_cpu_time_total == 0
             and "paged_" in e.key and "paged_decode" not in e.key]
    chunk_ms = sum(us for us, _, _ in chunk) / 1e3
    chunk_calls = SLICE["n_blocks"] * st["prefill_rounds"]
    log(f"  profiled serve {tag}: wall {wall:.4f} s, device busy "
        f"{busy_s:.4f} s (idle share {1 - busy_s / wall:.3f}), {launches} "
        f"kernel launches over {steps} forwards; K2 chunk route "
        f"{chunk_ms:.4f} ms over {chunk_calls} calls; [{card}]")
    for t in top[:6]:
        log(f"    {t['device_ms']:9.3f} ms  x{t['count']:<6d} {t['kernel']}")
    return dict(wall_s=wall, device_busy_s=busy_s,
                idle_share=1 - busy_s / wall, kernel_launches=launches,
                forwards=steps, tokens=sum(len(o) for o in outs), top=top,
                k2_chunk_device_ms=chunk_ms, k2_chunk_calls=chunk_calls,
                k2_chunk_kernels=[dict(kernel=k[:80], device_ms=us / 1e3,
                                       count=c) for us, c, k in chunk])


def train_batch(dev=None):
    """The seeded phase-7 batch: one-hot tokens and next-token labels,
    [16, 128, 256] each (on ``dev`` when given)."""
    rs = np.random.RandomState(7)
    V, T = SLICE["num_labels"], SLICE["max_length"]
    tok = rs.randint(0, V, (TRAIN_BATCH, T + 1))
    eye = np.eye(V, dtype=np.float32)
    x, y = eye[tok[:, :-1]], eye[tok[:, 1:]]
    if dev is None:
        return x, y
    return torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)


def phase_train(net, cpu, card):
    """Adam training of the full-width model through ``do_step``, card
    against the CPU plain path from the same weights."""
    from deeplearning4j_torch import kernels
    from deeplearning4j_torch.optimize.fused_fit import value_and_grad

    x, y = train_batch()
    xd, yd = train_batch(net.device)
    loss_d, g_d = value_and_grad(net, net.params, net.state, [xd], [yd])
    loss_c, g_c = value_and_grad(cpu, cpu.params, cpu.state,
                                 [torch.from_numpy(x)], [torch.from_numpy(y)])
    grad_err = max(((g_d[v][p].cpu() - g_c[v][p]).abs().max()
                    / g_c[v][p].abs().max()).item()
                   for v in g_c for p in g_c[v])
    check(grad_err <= 1e-4, f"train: first-step gradients card vs CPU, "
                            f"worst leaf max|err|/max|g| {grad_err:.3g}")
    before = dict(kernels.LAUNCHES)
    card_losses = [float(net.do_step(xd, yd)[0]) for _ in range(3)]
    per_step = {k: (kernels.LAUNCHES[k] - before[k]) / 3
                for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
    cpu_losses = [float(cpu.do_step(x, y)[0]) for _ in range(3)]
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(card_losses,
                                                        cpu_losses))
    check(loss_err <= 1e-4, f"train: Adam losses card {card_losses} vs CPU "
                            f"{cpu_losses} (rel {loss_err:.3g})")
    check(all(n == SLICE["n_blocks"] for n in per_step.values()),
          f"train: launches per step {per_step}, expected "
          f"{SLICE['n_blocks']} each")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = [net.do_step(xd, yd)[0] for _ in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    losses = [float(l) for l in losses]
    check(all(np.isfinite(losses)) and losses[-1] < 0.9 * losses[0],
          f"train: the loss did not fall over {TRAIN_STEPS} steps: "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}")
    step_ms = wall / TRAIN_STEPS * 1e3
    tokens = TRAIN_BATCH * SLICE["max_length"]
    log(f"  train [{TRAIN_BATCH}, {SLICE['max_length']}] Adam: first-step "
        f"grads vs CPU {grad_err:.2e}, losses vs CPU {loss_err:.2e} "
        f"({card_losses[0]:.4f} -> {card_losses[-1]:.4f}); launches per "
        f"step {per_step}; {TRAIN_STEPS} steps {losses[0]:.4f} -> "
        f"{losses[-1]:.4f}; {step_ms:.3f} ms/step = "
        f"{tokens / step_ms * 1e3:.0f} tokens/s; [{card}]")
    return dict(grad_rel_err=grad_err, loss_rel_err=loss_err,
                first_losses=card_losses, cpu_losses=cpu_losses,
                launches_per_step=per_step, losses=losses,
                step_ms=step_ms, tokens_per_step=tokens,
                tokens_per_s=tokens / step_ms * 1e3)


def profile_table(prof, out_dir, fname, header):
    """Device busy seconds (sum of the device activities' self times; one
    stream, so they do not overlap), the launch count and the kernels by
    device time of one ``torch.profiler`` run; the table goes to
    ``out_dir/fname`` (if ``out_dir``). Device activities are the rows with
    device time and no CPU time: an operator row launched from the
    profiled thread also carries its kernels' device time, and counting
    it too would count that time twice."""
    events = prof.key_averages()
    kernels = sorted(((dev_us(e), e.count, e.key) for e in events
                      if dev_us(e) > 0 and e.self_cpu_time_total == 0),
                     reverse=True)
    busy_s = sum(us for us, _, _ in kernels) / 1e6
    if out_dir:
        key = ("self_device_time_total"
               if hasattr(events[0], "self_device_time_total")
               else "self_cuda_time_total")
        with open(os.path.join(out_dir, fname), "w") as f:
            f.write(header)
            f.write(events.table(sort_by=key, row_limit=40))
    top = [dict(kernel=k[:80], device_ms=us / 1e3, count=c)
           for us, c, k in kernels[:12]]
    return busy_s, sum(c for _, c, _ in kernels), top


def profile_train(net, card, out_dir, steps=5):
    """``steps`` training steps on the phase-7 batch under
    ``torch.profiler``: device busy time against the wall clock and the
    kernels by device time."""
    from torch.profiler import ProfilerActivity, profile

    xd, yd = train_batch(net.device)
    net.do_step(xd, yd)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            net.do_step(xd, yd)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy_s, launches, top = profile_table(
        prof, out_dir, "train_profile.txt",
        f"{card}\n{steps} steps, wall {wall:.6f} s\n")
    log(f"  profiled train: {steps} steps, wall {wall:.4f} s, device busy "
        f"{busy_s:.4f} s (idle share {1 - busy_s / wall:.3f}), "
        f"{launches / steps:.0f} kernel launches per step; [{card}]")
    for t in top[:6]:
        log(f"    {t['device_ms']:9.3f} ms  x{t['count']:<6d} {t['kernel']}")
    return dict(steps=steps, wall_s=wall, device_busy_s=busy_s,
                idle_share=1 - busy_s / wall,
                kernel_launches_per_step=launches / steps, top=top)


def kernel_line(flash, paged, bwd, launches):
    k1 = flash["slice_f32_causal"]
    k2 = paged["f32_T1_Tmax512"]
    k2c = paged["f32_T256_Tmax512"]          # the serve's first prefill round
    k2s = paged["f32_T48_Tmax512"]           # ... and a second, split
    kb16 = paged["bf16_T1_Tmax512"]          # a bf16 model's decode step
    kb16c = paged["bf16_T256_Tmax512"]       # ... and its prefill round
    kb = bwd["slice_f32_causal"]
    slice_bwd = [r for n, r in bwd.items() if n.startswith("slice_f32")]
    line = [
        {"name": "flash_fwd", "route": "cuda",
         "source": "deeplearning4j_torch/kernels/flash_fwd.cu",
         "replaces": "deeplearning4j_tpu/ops/pallas_attention.py:135",
         "launches": launches["flash_fwd"],
         "max_abs_err": max(r["max_abs_err"] for n, r in flash.items()
                            if n.startswith("slice_f32")),
         "ms": k1["ms"], "device_ms": k1["device_ms"],
         "plain_ms": k1["plain_ms"],
         "plain_device_ms": k1["plain_device_ms"],
         "bound_ms": k1["bound_ms"], "bound_by": k1["bound_by"],
         "library_ms": k1["library_ms"],
         "library_device_ms": k1["library_device_ms"]},
        {"name": "paged_attn", "route": "cuda",
         "source": "deeplearning4j_torch/kernels/paged_attn.cu",
         "replaces": ("deeplearning4j_tpu/nn/conf/layers/"
                      "paged_attention.py:226"),
         "launches": launches["paged_attn"],
         "max_abs_err": max(r["max_abs_err"] for n, r in paged.items()
                            if n.startswith("f32_") and "Tmax512" in n),
         "ms": k2["ms"], "device_ms": k2["device_ms"],
         "plain_ms": k2["plain_ms"],
         "plain_device_ms": k2["plain_device_ms"],
         "bound_ms": k2["bound_ms"], "bound_by": k2["bound_by"],
         "library_ms": None, "library_device_ms": None,
         # the chunk route (T > 4), at the serve's T=256 and T=48 rounds
         "chunk_launches": launches["paged_attn_chunk"],
         "chunk_merge_launches": launches["paged_attn_merge"],
         "chunk_max_abs_err": max(r["max_abs_err"] for r in paged.values()
                                  if r["route"] == "chunk"
                                  and r["pool_dtype"] == "f32"),
         "chunk_int8_max_abs_err": max(r["max_abs_err"]
                                       for r in paged.values()
                                       if r["route"] == "chunk"
                                       and r["quant"]
                                       and r["dtype"] == "f32"),
         "chunk_ms": k2c["ms"], "chunk_device_ms": k2c["device_ms"],
         "chunk_plain_ms": k2c["plain_ms"],
         "chunk_plain_device_ms": k2c["plain_device_ms"],
         "chunk_bound_ms": k2c["bound_ms"], "chunk_bound_by": k2c["bound_by"],
         "chunk_T48_device_ms": k2s["device_ms"],
         "chunk_T48_splits": k2s["splits"],
         "chunk_T48_bound_ms": k2s["bound_ms"],
         # bf16 q and pools: decode T=1 and the chunk route at
         # T=256; errors relative to max|o| against the plain version on
         # f32-widened inputs
         "bf16_max_rel_err": max(r["max_rel_err"] for r in paged.values()
                                 if r["dtype"] == "bf16"),
         "bf16_ms": kb16["ms"], "bf16_device_ms": kb16["device_ms"],
         "bf16_plain_ms": kb16["plain_ms"],
         "bf16_bound_ms": kb16["bound_ms"], "bf16_bound_by": kb16["bound_by"],
         "bf16_chunk_ms": kb16c["ms"],
         "bf16_chunk_device_ms": kb16c["device_ms"],
         "bf16_chunk_plain_ms": kb16c["plain_ms"],
         "bf16_chunk_bound_ms": kb16c["bound_ms"],
         "bf16_chunk_bound_by": kb16c["bound_by"]}]
    # the plain time is the whole plain backward, the library time the
    # whole SDPA backward (dq, dk and dv together), for both kernels
    for name, part, grads, line_no in (("flash_bwd_dq", "dq", ("dq",), 289),
                                       ("flash_bwd_dkv", "dkv", ("dk", "dv"),
                                        305)):
        line.append(
            {"name": name, "route": "cuda",
             "source": "deeplearning4j_torch/kernels/flash_bwd.cu",
             "replaces": f"deeplearning4j_tpu/ops/pallas_attention.py:"
                         f"{line_no}",
             "launches": launches[name],
             "max_abs_err": max(r["max_abs_err"][g] for r in slice_bwd
                                for g in grads),
             "ms": kb[part]["ms"], "device_ms": kb[part]["device_ms"],
             "plain_ms": kb["plain_ms"],
             "plain_device_ms": kb["plain_device_ms"],
             "bound_ms": kb[part]["bound_ms"],
             "bound_by": kb[part]["bound_by"],
             "library_ms": kb["library_ms"],
             "library_device_ms": kb["library_device_ms"]})
    return {"kernels": line}


def main() -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="directory for chip_smoke.json and the "
                    "profile tables")
    ap.add_argument("--verbose-build", action="store_true")
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU",
              file=sys.stderr)
        return 2
    from deeplearning4j_torch import kernels

    card = card_line()
    log(card)
    dev = torch.device("cuda")
    REPORT["card"] = card
    REPORT["torch"] = torch.__version__

    log("phase 1: build the kernels")
    t0 = time.perf_counter()
    kernels.load(verbose=args.verbose_build)
    REPORT["build_s"] = time.perf_counter() - t0
    log(f"  built in {REPORT['build_s']:.1f} s")

    log("phase 2: K1 flash forward vs its plain version")
    flash = REPORT["flash_fwd"] = phase_flash(dev)
    log("phase 3: K2 paged attention vs its plain version")
    paged = REPORT["paged_attn"] = phase_paged(dev)

    net, cpu = build_nets()
    kernels.reset_launch_counts()         # the serving path starts here
    log("phase 4: the slice model's output() on the card")
    REPORT["model"] = phase_model(net, cpu)
    log("phase 5: serving, f32 then int8 KV pages")
    REPORT["serve"] = phase_serve(net, card)
    serving = dict(kernels.LAUNCHES)      # ... and ends here
    check(all(serving[k] > 0 for k in ("flash_fwd", "paged_attn",
                                       "paged_attn_chunk",
                                       "paged_attn_merge")),
          f"a kernel of the serving path never launched: {serving}")

    greedy = REPORT["serve"]["f32"]["streams"]
    kernels.reset_launch_counts()         # the zip-and-sample path starts
    log("phase 4b: the model zip at full width, saved and loaded on the "
        "card")
    loaded, REPORT["zip"] = phase_zip(net, greedy, card)
    log("phase 5b: a mixed greedy and sampled serve of the loaded net")
    REPORT["sampled"] = phase_sampled(
        loaded, greedy, REPORT["serve"]["f32"]["tokens_per_s"], card)
    log("phase 5c: a bf16 TransformerLM served through K2")
    REPORT["bf16_serve"] = phase_bf16(numpy_params(net, seed=0), card)
    loading = dict(kernels.LAUNCHES)      # ... and ends here
    check(all(loading[k] > 0 for k in ("flash_fwd", "paged_attn",
                                       "paged_attn_chunk",
                                       "paged_attn_merge")),
          f"a kernel of the zip-and-sample path never launched: {loading}")

    log("phase 6: K3/K4 flash backward vs its plain version")
    bwd = REPORT["flash_bwd"] = phase_flash_bwd(dev)

    kernels.reset_launch_counts()         # the training path starts here
    log("phase 7: training the slice model with Adam on the card")
    REPORT["train"] = phase_train(net, cpu, card)
    training = dict(kernels.LAUNCHES)     # ... and ends here
    check(all(training[k] > 0 for k in ("flash_fwd", "flash_bwd_dq",
                                        "flash_bwd_dkv")),
          f"a kernel of the training path never launched: {training}")
    launches = {k: serving[k] + loading[k] + training[k] for k in serving}
    REPORT["main_path_launches"] = dict(serving=serving, loading=loading,
                                        training=training, total=launches)
    check(all(n > 0 for n in launches.values()),
          f"a kernel of the main path never launched: {launches}")

    if args.out:
        os.makedirs(args.out, exist_ok=True)
    if args.profile:
        log("profile: one f32 serve, one mixed greedy/sampled serve and "
            "five training steps under torch.profiler")
        REPORT["profile"] = profile_serve(net, card, args.out)
        REPORT["sampled_profile"] = profile_serve(
            loaded, card, args.out, sampled_requests(), "sampled")
        REPORT["train_profile"] = profile_train(net, card, args.out)

    line = kernel_line(flash, paged, bwd, launches)
    if args.out:
        with open(os.path.join(args.out, "chip_smoke.json"), "w") as f:
            json.dump(dict(REPORT, kernels=line["kernels"]), f, indent=1)
    log(json.dumps(line))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
