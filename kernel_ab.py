"""Same-call A/B of the port's K1 (flash forward), K2 (paged read) and
K3/K4 (flash backward, dQ and dK/dV) between two checkouts, on one CUDA
card.

    python3 kernel_ab.py OTHER_DIR [--out DIR] [--sass-only]

OTHER_DIR is a baseline checkout of the repository (for example the parent
commit unpacked with ``git archive``). The script runs, each in its own
process, OTHER_DIR, this checkout, this checkout again and OTHER_DIR again,
so that drift of the card over the call shows as a difference between the
two runs of one tree. Each run builds its own tree's kernels from its own
sources (into that tree's ``kernels/build/``) and reports:

- the device time per launch of K1, K2, K3 and K4 at the shapes the main
  path gives them (and K1, K3 and K4 at [2, 8, 2048, 128], f32 and bf16),
  from one short ``torch.profiler`` window per case, read as
  ``chip_smoke.py`` reads it (its ``device_ms``); K2's per wrapper call,
  which on its split chunk walk is two launches (walk and merge);
- a digest of K1's outputs (o and lse), of K2's outputs per case (both
  routes; f32, int8, bf16, f16 and int8 pools under a bf16 query) and of
  K3's and K4's outputs (dq; dk and dv), so that two trees whose kernels
  should agree bit for bit can be seen to;
- one profiled f32 serve of the ``chip_smoke.py`` phase-5 requests and
  five profiled training steps: wall time, device busy time, idle share
  and the attention kernels' device time, K2's chunk route summed
  (``chip_smoke.profile_serve`` and ``profile_train``).

Before the runs it compiles each tree's ``flash_fwd.cu``, ``flash_bwd.cu``
and ``paged_attn.cu`` (and ``paged_attn_pad.cu`` where the tree has it)
once more with ``nvcc -Xptxas -v -cubin`` (one
``nvcc`` each, all started together, the compile seconds of each kept) and
reads ``cuobjdump -sass``: registers, spills and static shared memory of
each kernel, its counts of ``HMMA`` (tensor-core products), ``LDGSTS``
(``cp.async`` copies) and ``ATOM``/``RED`` (atomics), and a digest of its
instructions (whitespace-normalised); it prints how many of the kernels both trees compile have
equal instructions, and a summary of the padded-width kernels
(``*_pad_kernel``: the head dims other than 8, 16, 32, 64, 128). Each run
also reports the dynamic shared memory per CTA of K1, K3/K4 and K2's
chunk route at every kernel width (``smem``). ``--sass-only`` stops after
the compile report.

The last line of its output is one JSON object with every run;
``--out DIR`` also writes it to ``DIR/kernel_ab.json``. The measurement
code is this checkout's in all four runs; only ``deeplearning4j_torch``
comes from the tree under test.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))

# (name, B, H, T, d, dtype, causal): K1 on the serve's output() and the
# training step, and the long yardstick shape
K1_CASES = [("slice_f32_causal", 8, 8, 128, 32, "float32"),
            ("slice_bf16_causal", 8, 8, 128, 32, "bfloat16"),
            ("train_f32_causal", 16, 8, 128, 32, "float32"),
            ("mid_f32_causal", 2, 8, 1024, 64, "float32"),
            ("long_f32_causal", 2, 8, 2048, 128, "float32"),
            ("long_bf16_causal", 2, 8, 2048, 128, "bfloat16")]
# (name, T, query dtype, int8 pools): K2 at B=8, H=8, d=32, ps=16,
# Tmax=512, as in phase 3: the decode route (T=1) and the chunk route at the
# serve's first (256) and second (48) prefill rounds and at the route
# boundary (5); f32 and int8 pools, then bf16 pools and int8 pools under a
# bf16 query (a tree whose K2 refuses 16-bit queries records them as
# unsupported)
K2_CASES = [("f32_T1_Tmax512", 1, "float32", False),
            ("int8_T1_Tmax512", 1, "float32", True),
            ("f32_T256_Tmax512", 256, "float32", False),
            ("int8_T256_Tmax512", 256, "float32", True),
            ("f32_T5_Tmax512", 5, "float32", False),
            ("f32_T48_Tmax512", 48, "float32", False),
            ("bf16_T1_Tmax512", 1, "bfloat16", False),
            ("bf16_T256_Tmax512", 256, "bfloat16", False),
            ("bf16_T48_Tmax512", 48, "bfloat16", False),
            ("f16_T1_Tmax512", 1, "float16", False),
            ("f16_T256_Tmax512", 256, "float16", False),
            ("int8bf16_T1_Tmax512", 1, "bfloat16", True),
            ("int8bf16_T256_Tmax512", 256, "bfloat16", True)]
# (name, B, H, T, d, dtype): K3 and K4 on the training step, causal, and
# the long yardstick shape
BWD_CASES = [("train_f32_causal", 16, 8, 128, 32, "float32"),
             ("train_bf16_causal", 16, 8, 128, 32, "bfloat16"),
             ("mid_f32_causal", 2, 8, 1024, 64, "float32"),
             ("long_f32_causal", 2, 8, 2048, 128, "float32"),
             ("long_bf16_causal", 2, 8, 2048, 128, "bfloat16")]


def measure(tree: str) -> dict:
    """One run: ``deeplearning4j_torch`` from ``tree``, the measurement
    helpers from this checkout's ``chip_smoke.py``."""
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_ab", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import hashlib

    import torch

    from deeplearning4j_torch import kernels
    from deeplearning4j_torch.nn.conf.layers import paged_attention as ppa
    from deeplearning4j_torch.ops import flash_attention as fa

    cs.check(os.path.abspath(kernels.__file__).startswith(tree + os.sep),
             f"kernels imported from {kernels.__file__}, not {tree}")
    ext = kernels.load()
    dev = torch.device("cuda")
    g = torch.Generator(device="cpu").manual_seed(11)
    out = {"tree": tree, "k1": {}, "k2": {}, "k3": {}, "k4": {}}
    for name, B, H, T, d, dt in K1_CASES:
        dtype = getattr(torch, dt)
        q, k, v = [torch.randn(B, H, T, d, generator=g).to(dev, dtype)
                   for _ in range(3)]
        o, lse = fa.flash_attention_forward(q, k, v, causal=True)
        digest = hashlib.sha256(o.float().cpu().numpy().tobytes()
                                + lse.cpu().numpy().tobytes()).hexdigest()
        ms, n = cs.device_ms(lambda: fa.flash_attention_forward(
            q, k, v, causal=True), "flash_fwd_")
        out["k1"][name] = dict(device_ms=ms, launches_per_call=n,
                               digest=digest[:16])
    B, H, ps, d, Tmax = 8, 8, 16, 32, 512
    NP = Tmax // ps
    P = B * NP + 1
    for name, T, dt, quant in K2_CASES:
        dtype = getattr(torch, dt)
        if quant:
            kp, vp = [torch.randint(-127, 128, (P, H, ps, d), generator=g,
                                    dtype=torch.int8).to(dev)
                      for _ in range(2)]
            ks, vs = [(torch.rand(P, H, ps, generator=g) * 0.05).to(dev)
                      for _ in range(2)]
        else:
            kp, vp = [torch.randn(P, H, ps, d, generator=g).to(dev, dtype)
                      for _ in range(2)]
            ks = vs = None
        bt = (torch.randperm(P - 1, generator=g)[:B * NP] + 1).reshape(
            B, NP).to(torch.int32).to(dev)
        pos = torch.randint(0, Tmax - T + 1, (B,), generator=g).to(
            torch.int32).to(dev)
        q = torch.randn(B, H, T, d, generator=g).to(dev, dtype)
        try:
            o = ppa.paged_attention(q, kp, vp, bt, pos, kscales=ks,
                                    vscales=vs)
        except TypeError:
            out["k2"][name] = dict(unsupported=True)
            continue
        digest = hashlib.sha256(o.float().cpu().numpy().tobytes()
                                ).hexdigest()
        ms, n = cs.device_ms(lambda: ppa.paged_attention(
            q, kp, vp, bt, pos, kscales=ks, vscales=vs), "paged_")
        out["k2"][name] = dict(device_ms=ms * n, launches_per_call=n,
                               digest=digest[:16])
    for name, B, H, T, d, dt in BWD_CASES:
        dtype = getattr(torch, dt)
        q, k, v, do = [torch.randn(B, H, T, d, generator=g).to(dev, dtype)
                       for _ in range(4)]
        o, lse = fa.flash_attention_forward(q, k, v, causal=True)
        args = (q, k, v, do, lse, fa.attention_delta(o, do), None, True)
        for part, kernel in (("k3", "flash_bwd_dq"), ("k4", "flash_bwd_dkv")):
            fn = getattr(ext, kernel)
            res = fn(*args)
            res = res if isinstance(res, (list, tuple)) else [res]
            digest = hashlib.sha256(b"".join(
                r.float().cpu().numpy().tobytes() for r in res)).hexdigest()
            ms, n = cs.device_ms(lambda: fn(*args), kernel)
            out[part][name] = dict(device_ms=ms, launches_per_call=n,
                                   digest=digest[:16])
    out["smem"] = {
        str(w): dict(flash_fwd_f32=ext.flash_fwd_smem(w, 0),
                     flash_fwd_16=ext.flash_fwd_smem(w, 1),
                     flash_bwd_f32=ext.flash_bwd_smem(w, 0),
                     flash_bwd_16=ext.flash_bwd_smem(w, 1),
                     **{f"paged_chunk_{k}": ext.paged_chunk_smem(w, i, 32)
                        for i, k in enumerate(("f32", "int8", "16"))})
        for w in getattr(kernels, "KERNEL_WIDTHS", (8, 16, 32, 64, 128))
    } if hasattr(ext, "flash_fwd_smem") else None
    card = cs.card_line()
    net, _cpu = cs.build_nets()
    rs = cs.np.random.RandomState(4)
    cs.serve(net, [(rs.randint(0, cs.SLICE["num_labels"], n), 32)
                   for n in cs.SERVE_LENS[:2]])         # warm-up
    out["serve"] = cs.profile_serve(net, card, None)
    out["train"] = cs.profile_train(net, card, None)
    out["card"] = card
    return out


SOURCES = ("flash_fwd.cu", "flash_bwd.cu", "paged_attn.cu",
           "paged_attn_pad.cu")


def compile_one(tree: str, src: str, tmp: str):
    """``nvcc -Xptxas -v -cubin`` of one kernel source of ``tree``; returns
    (ptxas report, SASS text)."""
    import time

    path = os.path.join(tree, "deeplearning4j_torch", "kernels", src)
    cubin = os.path.join(tmp, src + ".cubin")
    t0 = time.perf_counter()
    build = subprocess.run(
        ["nvcc", "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
         "-O3", "-Xptxas", "-v", "-cubin", "-o", cubin, path],
        capture_output=True, text=True, timeout=900)
    if build.returncode != 0:
        raise RuntimeError(f"kernel_ab: nvcc failed on {path}:\n"
                           f"{build.stderr[-2000:]}")
    seconds = time.perf_counter() - t0
    sass = subprocess.run(["cuobjdump", "-sass", cubin], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    return build.stderr, sass, seconds


def sass_report(tree: str) -> dict:
    """Registers, spills and static shared memory (``nvcc -Xptxas -v``),
    the ``HMMA``, ``LDGSTS`` and ``ATOM``/``RED`` counts and a digest of the
    instructions (``cuobjdump -sass``) of each kernel in ``tree``'s kernel
    sources, by mangled name, and each source's compile seconds under
    ``"_compile_s"``. The sources compile in parallel."""
    import hashlib
    import re
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    sources = [s for s in SOURCES if os.path.exists(
        os.path.join(tree, "deeplearning4j_torch", "kernels", s))]
    with tempfile.TemporaryDirectory() as tmp:
        with ThreadPoolExecutor(len(sources)) as pool:
            outs = list(pool.map(lambda s: compile_one(tree, s, tmp),
                                 sources))
    report = {}
    compile_s = {}
    for src, (ptxas, sass, seconds) in zip(sources, outs):
        compile_s[src] = seconds
        fn = None
        for line in ptxas.splitlines():
            if "Compiling entry function" in line:
                fn = line.split("'")[1]
                report[fn] = dict(source=src, registers=None, spill_stores=0,
                                  spill_loads=0, smem=0, hmma=0, ldgsts=0,
                                  atom=0, sass=hashlib.sha256())
            elif fn and "Used" in line:
                report[fn]["registers"] = int(
                    re.search(r"Used (\d+) registers", line).group(1))
                smem = re.search(r"(\d+) bytes smem", line)
                report[fn]["smem"] = int(smem.group(1)) if smem else 0
            elif fn and "spill stores" in line:
                nums = re.findall(r"(\d+) bytes spill", line)
                report[fn]["spill_stores"], report[fn]["spill_loads"] = map(
                    int, nums)
        fn = None
        for line in sass.splitlines():
            if "Function :" in line:
                fn = line.split("Function :")[1].strip()
            elif fn in report:
                for key, pat in (("hmma", "HMMA"), ("ldgsts", "LDGSTS"),
                                 ("atom", "ATOM")):
                    report[fn][key] += pat in line
                report[fn]["atom"] += " RED." in line
                # whitespace-normalised: cuobjdump pads each instruction's
                # text to the widest one in the file, so a kernel added to a
                # source moves the columns of every other kernel in it
                report[fn]["sass"].update(" ".join(line.split()).encode())
    for r in report.values():
        r["sass"] = r["sass"].hexdigest()[:16]
    report["_compile_s"] = compile_s
    return report


def main() -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("other", help="baseline checkout to compare against")
    ap.add_argument("--out", help="directory for kernel_ab.json")
    ap.add_argument("--measure", action="store_true",
                    help="(internal) measure the tree OTHER and print JSON")
    ap.add_argument("--sass-only", action="store_true",
                    help="stop after the compile report")
    args = ap.parse_args()
    if args.measure:
        print(json.dumps(measure(args.other)), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device; this script runs on the GPU",
              file=sys.stderr)
        return 2
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(2) as pool:
        reports = list(pool.map(sass_report, (args.other, HERE)))
    compile_s = {label: r.pop("_compile_s") for label, r in
                 zip(("other", "this"), reports)}
    sass = dict(other=reports[0], this=reports[1])
    print(f"compile seconds (nvcc -cubin, all at once): {compile_s}",
          flush=True)
    for fn, r in sass["this"].items():
        was = sass["other"].get(fn)
        note = "new" if was is None else (
            "same instructions" if was["sass"] == r["sass"] else "CHANGED")
        print(f"this: {fn[:70]} regs {r['registers']} spill "
              f"{r['spill_stores']}/{r['spill_loads']} B, smem {r['smem']} "
              f"B, HMMA {r['hmma']}, LDGSTS {r['ldgsts']}, ATOM/RED "
              f"{r['atom']}; {note}", flush=True)
    both = [fn for fn in sass["this"] if fn in sass["other"]]
    same = sum(sass["this"][fn]["sass"] == sass["other"][fn]["sass"]
               for fn in both)
    print(f"kernels in both trees: {len(both)}, equal instructions: {same}; "
          f"only in this tree: {len(sass['this']) - len(both)}; only in the "
          f"other: {len(sass['other']) - len(both)}", flush=True)
    pads = [r for fn, r in sass["this"].items() if "_pad_kernel" in fn]
    if pads:
        spilled = [fn for fn, r in sass["this"].items()
                   if "_pad_kernel" in fn and r["spill_stores"]]
        print(f"padded-width kernels: {len(pads)}, registers "
              f"{min(r['registers'] for r in pads)}-"
              f"{max(r['registers'] for r in pads)}, spilling: "
              f"{len(spilled)} {[fn[:60] for fn in spilled]}", flush=True)
    if args.sass_only:
        line = {"sass": sass, "compile_s": compile_s}
        if args.out:
            os.makedirs(args.out, exist_ok=True)
            with open(os.path.join(args.out, "kernel_ab.json"), "w") as f:
                json.dump(line, f, indent=1)
        print(json.dumps({"kernels_in_both": len(both),
                          "equal_instructions": same}))
        return 0
    runs = []
    for label, tree in (("other", args.other), ("this", HERE),
                        ("this", HERE), ("other", args.other)):
        res = subprocess.run(
            [sys.executable, os.path.abspath(__file__), tree, "--measure"],
            capture_output=True, text=True, timeout=900)
        if res.returncode != 0:
            print(res.stdout[-4000:], res.stderr[-4000:], file=sys.stderr)
            raise SystemExit(f"kernel_ab: the {label} run failed")
        run = json.loads(res.stdout.strip().splitlines()[-1])
        run["label"] = label
        runs.append(run)
        k1 = " ".join(f"{n} {r['device_ms']:.5f}"
                      for n, r in run["k1"].items())
        print(f"{label}: K1 ms/launch {k1}", flush=True)
        print(f"{label}: K1 digests " + " ".join(
            f"{n} {r['digest']}" for n, r in run["k1"].items()), flush=True)
        print(f"{label}: K2 digests " + " ".join(
            f"{n} {r.get('digest', 'unsupported')}"
            for n, r in run["k2"].items()), flush=True)
        for part in ("k3", "k4"):
            print(f"{label}: {part.upper()} digests " + " ".join(
                f"{n} {r['digest']}" for n, r in run[part].items()),
                flush=True)
        for part in ("k2", "k3", "k4"):
            ms = " ".join(f"{n} {r['device_ms']:.5f}"
                          for n, r in run[part].items() if "device_ms" in r)
            per = "call" if part == "k2" else "launch"
            print(f"{label}: {part.upper()} ms/{per} {ms}", flush=True)
        for part in ("serve", "train"):
            r = run[part]
            print(f"{label}: {part} wall {r['wall_s']:.4f} s, device busy "
                  f"{r['device_busy_s']:.4f} s, idle share "
                  f"{r['idle_share']:.3f}", flush=True)
        r = run["serve"]
        print(f"{label}: serve K2 chunk route {r['k2_chunk_device_ms']:.4f} "
              f"ms over {r['k2_chunk_calls']} calls", flush=True)
    for part in ("k1", "k2", "k3", "k4"):
        names = [n for n, r in runs[0][part].items() if "digest" in r]
        differ = [n for n in names
                  if len({run[part][n].get("digest") for run in runs}) != 1]
        print(f"{part.upper()} digests over the four runs: {len(names)} "
              f"cases, differing: {differ or 'none'}", flush=True)
    print(runs[0]["card"])
    line = {"kernel_ab": runs, "sass": sass, "compile_s": compile_s}
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "kernel_ab.json"), "w") as f:
            json.dump(line, f, indent=1)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
