#!/usr/bin/env python3
"""The port's flash-attention kernels alone, on one CUDA card: build,
compiler report, SASS, correctness and device times, in about a minute.

    python3 scripts/torch_attention_profile.py [--model gpt2-small|llama-1b]
                                               [--out-dir DIR]

For kernel work, where ``chip_smoke.py`` (which also serves and trains)
takes longer. It prints, beside the card's name and power limit:

- the build time and ``ptxas -v`` lines of every kernel (registers, spills,
  and ptxas's notes on serialised wgmma products);
- per kernel function, the count of ``HGMMA`` (wgmma), ``UTMALDG`` (TMA
  load), ``HMMA`` (mma.sync) and ``MUFU.EX2`` instructions in its SASS;
- K1, K2, K4 (dq and delta) and K3 (from K4's delta) against their plain
  versions (``chip_smoke.py``'s bounds)
  over ``chip_smoke.py``'s cases (serving shapes, edge cases: ragged, odd
  lengths, GQA, every head dim, non-causal, in bf16 and f32) and the
  training shape;
- device ms (CUDA-graph replay) of K1 at the model's serving entry shape
  (B=2, T=256) beside SDPA, and of K2, K3, K4 at its training shapes
  beside SDPA's forward and backward (CUDA graphs; GQA through
  ``enable_gqa=True``), with the products' TFLOP/s; at the first training
  shape also the plain versions of K4 and K3, each on its own. GPT-2 small
  (the default): H=12, D=64, training shapes B=32, T=1024 and B=4,
  T=2048. llama-1b: H=32 over Hkv=8, D=64, training shape B=8, T=2048.

With ``--out-dir`` the full compiler logs and SASS are written there.
Exits non-zero if a build fails or a case is outside its bound. Imports
nothing of JAX or ``ray_tpu``.
"""
from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SASS_OPS = ("HGMMA", "UTMALDG", "HMMA", "MUFU.EX2")
# Per model: heads, kv heads, head dim, whether q/k/v are views of one
# fused tensor (GPT-2's qkv projection), and the training shapes (B, T).
MODELS = {
    "gpt2-small": dict(H=12, Hkv=12, D=64, fused=True,
                       train=((32, 1024), (4, 2048))),
    "llama-1b": dict(H=32, Hkv=8, D=64, fused=False, train=((8, 2048),)),
}


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="gpt2-small", choices=sorted(MODELS))
    ap.add_argument("--out-dir", help="directory for the ptxas logs and SASS")
    args = ap.parse_args()
    spec = MODELS[args.model]
    if not torch.cuda.is_available():
        print("torch_attention_profile: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from ray_tpu_torch._private.device import card_info
    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.ops import attention as attn

    if args.out_dir:
        os.makedirs(args.out_dir, exist_ok=True)
    card = card_info()
    print(card)
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    built = _build.build_all()
    print(f"build {time.perf_counter() - t0:.1f} s: {built}", flush=True)
    cuobjdump = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    for name in built:
        lib = _build.lib_path(name)
        with open(lib + ".log") as f:
            log = f.read()
        if args.out_dir:
            with open(os.path.join(args.out_dir, name + ".ptxas.log"), "w") as f:
                f.write(log)
        func = None
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '([^']*)'", line)
            if m:
                func = m.group(1)
            elif func and ("registers" in line or "spill" in line):
                print(f"  ptxas {func}: {line.strip()}")
            elif "Performance Loss" in line:
                print(f"  ptxas note: {line.strip()}")
        sass = subprocess.run([cuobjdump, "-sass", lib], capture_output=True,
                              text=True, check=True).stdout
        if args.out_dir:
            with open(os.path.join(args.out_dir, name + ".sass"), "w") as f:
                f.write(sass)
        counts = cs.sass_counts(lib, cuobjdump, ops=SASS_OPS, sass=sass)
        for func, c in counts.items():
            print(f"  sass {func}: " + ", ".join(f"{k} {v}" for k, v in c.items()))
    sys.stdout.flush()

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    bf16 = torch.bfloat16

    def qkv(B, T, H, Hkv, D, dtype, fused=False):
        if fused:   # the model's layout: views into one [B, T, 3, H, D]
            x = torch.randn(B, T, 3, H, D, device=dev, generator=gen).to(dtype)
            return x[:, :, 0], x[:, :, 1], x[:, :, 2]
        return tuple(torch.randn(B, T, h, D, device=dev, generator=gen).to(dtype)
                     for h in (H, Hkv, Hkv))

    # chip_smoke.py's cases, and the first training shape in bf16.
    cases = cs.CASES + [("train", *spec["train"][0], spec["H"], spec["Hkv"], spec["D"],
                         True, "bfloat16", spec["fused"])]
    bad = 0
    for name, B, T, H, Hkv, D, causal, dn, fused in cases:
        dtype = getattr(torch, dn)
        q, k, v = qkv(B, T, H, Hkv, D, dtype, fused)
        do = torch.randn(B, T, H, D, device=dev, generator=gen).to(dtype)
        with torch.no_grad():
            o1 = attn.flash_attention(q, k, v, causal)
            out, lse = attn._flash_fwd_cuda(q, k, v, causal, with_lse=True)
            dq, dk, dv, delta = attn._flash_bwd_cuda(q, k, v, out, lse, do, causal)
            torch.cuda.synchronize()
            ro, rl = attn.flash_attention_ref(q, k, v, causal, with_lse=True)
            rq, rd = attn.flash_bwd_dq_ref(q, k, v, out, lse, do, causal)
            rk, rv = attn.flash_bwd_dkv_ref(q, k, v, delta, lse, do, causal)
        errs = {"K1": cs.close(o1, ro, cs.TOL[dn]), "out": cs.close(out, ro, cs.TOL[dn]),
                "lse": cs.close(lse, rl, cs.LSE_TOL),
                "delta": cs.close(delta, rd, cs.LSE_TOL),
                "dq": cs.close(dq, rq, cs.GRAD_TOL[dn]),
                "dk": cs.close(dk, rk, cs.GRAD_TOL[dn]),
                "dv": cs.close(dv, rv, cs.GRAD_TOL[dn])}
        n_out = sum(n for _, n in errs.values())
        bad += n_out > 0
        print(f"{'ok ' if n_out == 0 else 'BAD'} {name} {dn} B={B} T={T} H={H} "
              f"Hkv={Hkv} D={D} causal={causal}: max|kernel-plain| "
              + ", ".join(f"{n} {e:.3e}" for n, (e, _) in errs.items()), flush=True)
    print(f"cases outside their bounds: {bad} of {len(cases)}", flush=True)

    H, Hkv, D = spec["H"], spec["Hkv"], spec["D"]
    gqa = Hkv != H

    def sdpa_fn(qt, kt, vt):
        return torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=gqa)

    B, T = 2, 256
    q, k, v = qkv(B, T, H, Hkv, D, bf16)
    with torch.no_grad():
        k1 = cs.graph_ms(lambda: attn.flash_attention(q, k, v, True))
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        sdpa = cs.graph_ms(lambda: sdpa_fn(qt, kt, vt))
    print(f"[{card}] K1 {args.model} B=2 T=256 H={H} Hkv={Hkv}: {k1:.5f} ms; "
          f"sdpa{' (enable_gqa)' if gqa else ''} {sdpa:.5f} ms", flush=True)
    for B, T in spec["train"]:
        q, k, v = qkv(B, T, H, Hkv, D, bf16, fused=spec["fused"])
        do = torch.randn(B, T, H, D, device=dev, generator=gen).to(bf16)
        with torch.no_grad():
            k2 = cs.graph_ms(lambda: attn._flash_fwd_cuda(q, k, v, True, with_lse=True),
                             reps=20)
            out, lse = attn._flash_fwd_cuda(q, k, v, True, with_lse=True)
            q, k, v, out, do, lse = attn._flash_bwd_prepare(q, k, v, out, lse, do)
            dq = torch.empty_like(out)
            dk, dv = torch.empty_like(k), torch.empty_like(v)
            delta = torch.empty((B, H, T), dtype=torch.float32, device=dev)
            k4 = cs.graph_ms(lambda: attn._flash_bwd_dq_launch(
                q, k, v, out, do, lse, dq, delta, True), reps=20)
            k3 = cs.graph_ms(lambda: attn._flash_bwd_dkv_launch(
                q, k, v, do, lse, delta, dk, dv, True), reps=20)
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            sdpa = cs.graph_ms(lambda: sdpa_fn(qt, kt, vt), reps=20)
            plain = ""
            if (B, T) == spec["train"][0]:
                p4 = cs.cuda_ms(lambda: attn.flash_bwd_dq_ref(q, k, v, out, lse, do, True),
                                3, 1)
                p3 = cs.cuda_ms(lambda: attn.flash_bwd_dkv_ref(q, k, v, delta, lse, do,
                                                               True), 3, 1)
                plain = f"; plain K4 {p4:.4f} ms, plain K3 {p3:.4f} ms"
        qg, kg, vg = (x.detach().requires_grad_() for x in (qt, kt, vt))
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):   # the backward runs on this stream
            o_sdpa = sdpa_fn(qg, kg, vg)
        sdpa_bwd = cs.graph_ms(lambda: torch.autograd.grad(
            o_sdpa, (qg, kg, vg), do.transpose(1, 2), retain_graph=True),
            reps=20, stream=side)
        del o_sdpa, qg, kg, vg
        flop = 2.0 * D * T * (T + 1) / 2 * B * H   # one causal [T, T, D] product
        print(f"[{card}] {args.model} B={B} T={T}: K2 {k2:.4f} ms ({2 * flop / k2 / 1e9:.0f} "
              f"TFLOP/s), K3 {k3:.4f} ms ({4 * flop / k3 / 1e9:.0f}), K4 {k4:.4f} "
              f"ms ({3 * flop / k4 / 1e9:.0f}); sdpa forward {sdpa:.4f} ms, "
              f"backward {sdpa_bwd:.4f} ms; K3 + K4 {k3 + k4:.4f} ms "
              f"({(k3 + k4) / sdpa_bwd:.2f}x sdpa's backward){plain}", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
