"""Same-call A/B of the port's K1 (flash forward), K2 (paged read) and
K3/K4 (flash backward, dQ and dK/dV) between two checkouts, on one CUDA
card.

    python3 kernel_ab.py OTHER_DIR [--out DIR]

OTHER_DIR is a baseline checkout of the repository (for example the parent
commit unpacked with ``git archive``). The script runs, each in its own
process, OTHER_DIR, this checkout, this checkout again and OTHER_DIR again,
so that drift of the card over the call shows as a difference between the
two runs of one tree. Each run builds its own tree's kernels from its own
sources (into that tree's ``kernels/build/``) and reports:

- the device time per launch of K1, K2, K3 and K4 at the shapes the main
  path gives them (and K1, K3 and K4 at [2, 8, 2048, 128], f32 and bf16),
  from one short ``torch.profiler`` window per case, read as
  ``chip_smoke.py`` reads it (its ``device_ms``);
- a digest of K1's outputs (o and lse) per case, so that two trees whose
  K1 should agree bit for bit can be seen to;
- one profiled f32 serve of the ``chip_smoke.py`` phase-5 requests and
  five profiled training steps: wall time, device busy time, idle share
  and the attention kernels' device time (``chip_smoke.profile_serve`` and
  ``profile_train``).

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
            ("train_f32_causal", 16, 8, 128, 32, "float32"),
            ("long_f32_causal", 2, 8, 2048, 128, "float32"),
            ("long_bf16_causal", 2, 8, 2048, 128, "bfloat16")]
# (name, T, quant): K2 at B=8, H=8, d=32, ps=16, Tmax=512, as in phase 3
K2_CASES = [("f32_T1_Tmax512", 1, False), ("int8_T1_Tmax512", 1, True),
            ("f32_T256_Tmax512", 256, False)]
# (name, B, H, T, d, dtype): K3 and K4 on the training step, causal, and
# the long yardstick shape
BWD_CASES = [("train_f32_causal", 16, 8, 128, 32, "float32"),
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
            q, k, v, causal=True), "flash_fwd_kernel")
        out["k1"][name] = dict(device_ms=ms, launches_per_call=n,
                               digest=digest[:16])
    B, H, ps, d, Tmax = 8, 8, 16, 32, 512
    NP = Tmax // ps
    P = B * NP + 1
    for name, T, quant in K2_CASES:
        if quant:
            kp, vp = [torch.randint(-127, 128, (P, H, ps, d), generator=g,
                                    dtype=torch.int8).to(dev)
                      for _ in range(2)]
            ks, vs = [(torch.rand(P, H, ps, generator=g) * 0.05).to(dev)
                      for _ in range(2)]
        else:
            kp, vp = [torch.randn(P, H, ps, d, generator=g).to(dev)
                      for _ in range(2)]
            ks = vs = None
        bt = (torch.randperm(P - 1, generator=g)[:B * NP] + 1).reshape(
            B, NP).to(torch.int32).to(dev)
        pos = torch.randint(0, Tmax - T + 1, (B,), generator=g).to(
            torch.int32).to(dev)
        q = torch.randn(B, H, T, d, generator=g).to(dev)
        ms, n = cs.device_ms(lambda: ppa.paged_attention(
            q, kp, vp, bt, pos, kscales=ks, vscales=vs), "paged_")
        out["k2"][name] = dict(device_ms=ms, launches_per_call=n)
    for name, B, H, T, d, dt in BWD_CASES:
        dtype = getattr(torch, dt)
        q, k, v, do = [torch.randn(B, H, T, d, generator=g).to(dev, dtype)
                       for _ in range(4)]
        o, lse = fa.flash_attention_forward(q, k, v, causal=True)
        args = (q, k, v, do, lse, fa.attention_delta(o, do), None, True)
        for part, kernel in (("k3", "flash_bwd_dq"), ("k4", "flash_bwd_dkv")):
            fn = getattr(ext, kernel)
            ms, n = cs.device_ms(lambda: fn(*args), kernel)
            out[part][name] = dict(device_ms=ms, launches_per_call=n)
    card = cs.card_line()
    net, _cpu = cs.build_nets()
    rs = cs.np.random.RandomState(4)
    cs.serve(net, [(rs.randint(0, cs.SLICE["num_labels"], n), 32)
                   for n in cs.SERVE_LENS[:2]])         # warm-up
    out["serve"] = cs.profile_serve(net, card, None)
    out["train"] = cs.profile_train(net, card, None)
    out["card"] = card
    return out


def main() -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("other", help="baseline checkout to compare against")
    ap.add_argument("--out", help="directory for kernel_ab.json")
    ap.add_argument("--measure", action="store_true",
                    help="(internal) measure the tree OTHER and print JSON")
    args = ap.parse_args()
    if args.measure:
        print(json.dumps(measure(args.other)), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device; this script runs on the GPU",
              file=sys.stderr)
        return 2
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
        for part in ("k2", "k3", "k4"):
            ms = " ".join(f"{n} {r['device_ms']:.5f}"
                          for n, r in run[part].items())
            print(f"{label}: {part.upper()} ms/launch {ms}", flush=True)
        for part in ("serve", "train"):
            r = run[part]
            print(f"{label}: {part} wall {r['wall_s']:.4f} s, device busy "
                  f"{r['device_busy_s']:.4f} s, idle share "
                  f"{r['idle_share']:.3f}", flush=True)
    print(runs[0]["card"])
    line = {"kernel_ab": runs}
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "kernel_ab.json"), "w") as f:
            json.dump(line, f, indent=1)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
