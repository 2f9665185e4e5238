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
   two calls must be bitwise equal;
4. the slice model (zoo TransformerLM defaults, numpy-seeded weights) on
   the card: ``output()`` against a CPU run of the port's plain path;
5. serving: 16 greedy requests (prompts of 8..300 tokens, 32 new tokens)
   through ``GenerationServer`` with f32 and then int8 KV pages, each held
   token for token against the same server with ``paged_attention="stock"``;
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
one short ``torch.profiler`` window (``device_ms``), with the plain
version's and the yardstick's device time per call beside it.

The main path is phases 4-5 (serving) and phase 7 (training). The launch
counters are zeroed just before each of the two and read just after (phase
6's comparison launches are not counted); every kernel must have run on the
main path, and each path must have launched its own kernels. The script
prints the card's name and power limit, one ``{"kernels": [...]}`` line with
each kernel's launches, error, times and bound, and, last, the result line
``{"ok": true, "device": {...}}``. Matmuls run in full f32 (TF32 off).

Options: ``--out DIR`` also writes everything measured to
``DIR/chip_smoke.json``; ``--verbose-build`` prints the kernel build's
compiler lines; ``--profile`` adds, after the main path, one f32 serve and
five training steps under ``torch.profiler`` (device busy time against the
wall clock, kernels by device time), with their tables in
``DIR/serve_profile.txt`` and ``DIR/train_profile.txt`` when ``--out`` is
given.
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
def phase_paged(dev):
    from deeplearning4j_torch.nn.conf.layers import paged_attention as ppa

    g = torch.Generator(device="cpu").manual_seed(2)
    results = {}
    B, H, ps, d = 8, 8, 16, 32
    for Tmax in (512, 2048):
        NP = Tmax // ps
        P = B * NP + 1
        for quant in (False, True):
            if quant:
                kp = torch.randint(-127, 128, (P, H, ps, d), generator=g,
                                   dtype=torch.int8).to(dev)
                vp = torch.randint(-127, 128, (P, H, ps, d), generator=g,
                                   dtype=torch.int8).to(dev)
                ks = (torch.rand(P, H, ps, generator=g) * 0.05).to(dev)
                vs = (torch.rand(P, H, ps, generator=g) * 0.05).to(dev)
            else:
                kp = torch.randn(P, H, ps, d, generator=g).to(dev)
                vp = torch.randn(P, H, ps, d, generator=g).to(dev)
                ks = vs = None
            bt = (torch.randperm(P - 1, generator=g)[:B * NP] + 1).reshape(
                B, NP).to(torch.int32)
            bt[B - 1] = 0                      # a row read from page 0 only
            bt = bt.to(dev)
            for T in (1, 4, 5, 256):
                pos = torch.randint(0, Tmax - T + 1, (B,), generator=g)
                pos[1] = (pos[1] // ps) * ps       # exactly on a page boundary
                pos = pos.to(torch.int32).to(dev)
                key_valid = None
                has_valid = torch.ones(B, H, T, 1, dtype=torch.bool,
                                       device=dev)
                if T > 1:
                    mask = torch.ones(B, T)
                    mask[2, 100:] = 0              # right padding
                    mask[B - 1] = 0                # all masked, on page 0
                    pos[B - 1] = 0
                    mask = mask.to(dev)
                    key_valid = ppa._key_valid_plane(mask, pos, T, Tmax)
                    col = torch.arange(Tmax, device=dev)
                    row = torch.arange(T, device=dev)
                    vis = (col[None, None] <= pos.long()[:, None, None]
                           + row[None, :, None]) & (key_valid[:, None] != 0)
                    has_valid = vis.any(-1)[:, None, :, None].expand(
                        B, H, T, 1)
                q = torch.randn(B, H, T, d, generator=g).to(dev)
                args = (q, kp, vp, bt, pos)
                kw = dict(key_valid=key_valid, kscales=ks, vscales=vs)
                o = ppa.paged_attention(*args, **kw)
                again = ppa.paged_attention(*args, **kw)
                po = ppa.paged_attention_plain(*args, **kw)
                torch.cuda.synchronize()
                check(torch.isfinite(o).all().item(),
                      "K2: non-finite output (garbage page or masked row)")
                diff = torch.where(has_valid, (o - po).abs(),
                                   torch.zeros_like(o))
                err = diff.max().item()
                atol = 1e-3 if quant else 1e-4
                name = (f"{'int8' if quant else 'f32'}_T{T}_Tmax{Tmax}")
                check(err <= atol, f"K2 {name}: max |err| {err:.3g} > "
                                   f"{atol}")
                check(torch.equal(o, again),
                      f"K2 {name}: two calls differ (not deterministic)")
                # the route paged_attn.cu takes: T <= 4 decode, else chunk
                route = "decode" if T <= 4 else "chunk"
                kernel = lambda: ppa.paged_attention(*args, **kw)  # noqa
                plain = lambda: ppa.paged_attention_plain(  # noqa: E731
                    *args, **kw)
                ms = time_ms(kernel)
                plain_ms = time_ms(plain, iters=20)
                kdev, _ = device_ms(kernel, "paged_")
                plain_dev, _ = device_ms(plain, iters=5)
                # bytes this run's data needs: each distinct (page, offset)
                # K/V slot the rows walk, read once (row B-1 walks page 0
                # over and over: its ps slots count once), the walked
                # block-table entries and plane columns, q, o and pos
                lim = torch.clamp(pos.long() + T, max=Tmax).tolist()
                btc = bt.long().cpu()
                slots = torch.cat([btc[b, torch.arange(n) // ps] * ps
                                   + torch.arange(n) % ps
                                   for b, n in enumerate(lim)])
                distinct = torch.unique(slots).numel()
                kv_row = d * (1 if quant else 4) + (4 if quant else 0)
                nbytes = 2 * distinct * H * kv_row + 2 * B * H * T * d * 4 \
                    + sum(-(-n // ps) for n in lim) * 4 + B * 4 \
                    + (sum(lim) * 4 if T > 1 else 0)
                flops = 4 * d * H * sum(
                    sum(min(p + r + 1, Tmax) for r in range(T))
                    for p in pos.tolist())
                bms, by = bound_ms(nbytes, flops, "f32")
                results[name] = dict(B=B, H=H, T=T, d=d, ps=ps, Tmax=Tmax,
                                     quant=quant, route=route,
                                     max_abs_err=err, deterministic=True,
                                     ms=ms, device_ms=kdev,
                                     plain_ms=plain_ms,
                                     plain_device_ms=plain_dev,
                                     bound_ms=bms, bound_by=by,
                                     library_ms=None)
                log(f"  K2 {name:18s} {route:6s} err {err:.2e} (atol "
                    f"{atol}), bitwise repeatable; kernel {ms:.4f} ms "
                    f"(device {kdev:.4f})  plain {plain_ms:.4f} "
                    f"({plain_dev:.4f})  bound {bms:.4f} ms ({by})")
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
    from deeplearning4j_torch.parallel.generation import GenerationServer

    srv = GenerationServer(net, SLICE["num_labels"], device="cuda",
                           **SERVER, **kw)
    try:
        t0 = time.perf_counter()
        futs = [srv.submit(p, n) for p, n in reqs]
        outs = [f.result(timeout=600).tolist() for f in futs]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        stats = srv.stats()
    finally:
        srv.close()
    return outs, wall, stats


def top2_gap(net, prompt, tokens):
    """Log-probability gap between the two best tokens after ``prompt +
    tokens`` (full-sequence forward), to show how close a divergence was."""
    V = SLICE["num_labels"]
    seq = np.concatenate([np.asarray(prompt), np.asarray(tokens, np.int64)])
    x = np.eye(V, dtype=np.float32)[seq][None]
    p = net.output(x)[0, -1].double()
    top = torch.topk(p, 2).values
    return (torch.log(top[0]) - torch.log(top[1])).item()


def phase_serve(net, card):
    from deeplearning4j_torch import kernels

    rs = np.random.RandomState(4)
    reqs = [(rs.randint(0, SLICE["num_labels"], n), 32) for n in SERVE_LENS]
    serve(net, reqs[:2])                              # warm-up
    results = {}
    for kv in (None, "int8"):
        tag = kv or "f32"
        before = kernels.LAUNCHES["paged_attn"]
        outs, wall, st = serve(net, reqs, kv_dtype=kv)
        launches = kernels.LAUNCHES["paged_attn"] - before
        expect = SLICE["n_blocks"] * (st["prefill_rounds"]
                                      + SERVER["steps_per_dispatch"]
                                      * st["decode_steps"])
        check(launches == expect and launches > 0,
              f"serve {tag}: K2 launched {launches} times, the schedule "
              f"needs {expect}")
        ref, ref_wall, _ = serve(net, reqs, kv_dtype=kv,
                                 paged_attention="stock")
        for i, (got, want) in enumerate(zip(outs, ref)):
            if got != want:
                k = next(j for j, (a, b) in enumerate(zip(got, want))
                         if a != b)
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
                            k2_launches=launches,
                            prefill_rounds=st["prefill_rounds"],
                            decode_steps=st["decode_steps"])
        log(f"  serve {tag}: {len(reqs)} requests, {ntok} tokens in "
            f"{wall:.3f} s = {ntok / wall:.1f} tok/s (stock paged read: "
            f"{ntok / ref_wall:.1f} tok/s); K2 launches {launches} "
            f"({st['prefill_rounds']} prefill rounds, {st['decode_steps']} "
            f"decode dispatches); tokens equal to stock; [{card}]")
    return results


def profile_serve(net, card, out_dir):
    """One f32 serve of the phase-5 requests under ``torch.profiler``:
    device busy time against the wall clock, and the kernels by device
    time (table in ``out_dir/serve_profile.txt``)."""
    from torch.profiler import ProfilerActivity, profile

    rs = np.random.RandomState(4)
    reqs = [(rs.randint(0, SLICE["num_labels"], n), 32) for n in SERVE_LENS]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        outs, wall, st = serve(net, reqs)
    busy_s, launches, top = profile_table(
        prof, out_dir, "serve_profile.txt", f"{card}\nwall {wall:.6f} s\n")
    steps = st["prefill_rounds"] + SERVER["steps_per_dispatch"] \
        * st["decode_steps"]
    log(f"  profiled serve f32: wall {wall:.4f} s, device busy "
        f"{busy_s:.4f} s (idle share {1 - busy_s / wall:.3f}), {launches} "
        f"kernel launches over {steps} forwards; [{card}]")
    for t in top[:6]:
        log(f"    {t['device_ms']:9.3f} ms  x{t['count']:<6d} {t['kernel']}")
    return dict(wall_s=wall, device_busy_s=busy_s,
                idle_share=1 - busy_s / wall, kernel_launches=launches,
                forwards=steps, tokens=sum(len(o) for o in outs), top=top)


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
                            if n.startswith("f32") and "Tmax512" in n),
         "ms": k2["ms"], "device_ms": k2["device_ms"],
         "plain_ms": k2["plain_ms"],
         "plain_device_ms": k2["plain_device_ms"],
         "bound_ms": k2["bound_ms"], "bound_by": k2["bound_by"],
         "library_ms": None, "library_device_ms": None}]
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
    check(serving["flash_fwd"] > 0 and serving["paged_attn"] > 0,
          f"a kernel of the serving path never launched: {serving}")

    log("phase 6: K3/K4 flash backward vs its plain version")
    bwd = REPORT["flash_bwd"] = phase_flash_bwd(dev)

    kernels.reset_launch_counts()         # the training path starts here
    log("phase 7: training the slice model with Adam on the card")
    REPORT["train"] = phase_train(net, cpu, card)
    training = dict(kernels.LAUNCHES)     # ... and ends here
    check(all(training[k] > 0 for k in ("flash_fwd", "flash_bwd_dq",
                                        "flash_bwd_dkv")),
          f"a kernel of the training path never launched: {training}")
    launches = {k: serving[k] + training[k] for k in serving}
    REPORT["main_path_launches"] = dict(serving=serving, training=training,
                                        total=launches)
    check(all(n > 0 for n in launches.values()),
          f"a kernel of the main path never launched: {launches}")

    if args.out:
        os.makedirs(args.out, exist_ok=True)
    if args.profile:
        log("profile: one f32 serve and five training steps under "
            "torch.profiler")
        REPORT["profile"] = profile_serve(net, card, args.out)
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
