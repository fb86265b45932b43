#!/usr/bin/env python3
"""Where the port's train step spends its time, on one CUDA card.

    python3 scripts/torch_train_profile.py [--model gpt2-small|llama-1b]
                                           [--remat-policy dots|dots_all|full|none]
                                           [--eager] [--table-out PATH]

A model preset at published widths (random weights and one batch of random
tokens, from seeds): GPT-2 small at B=32, T=1024 (the default), or llama-1b
at B=8, T=2048; bf16 activations over f32 parameters, ``make_train_step``
with flash attention (K2, K3, K4): the compiled step (Inductor, the
default on the card), or with ``--eager`` the eager one (``backend=None``).
After three warm-up steps (the first compiles; its seconds are printed) it
prints, beside the card's name and power limit:

- step ms: the median of five steps on the host clock, each ending in a
  synchronise;
- a ``torch.profiler`` pass over one more step (its hooks slow the host, so
  it runs last): the device's busy time against the step's wall time (the
  rest is the device's idle share), the device time by kernel group
  (attention kernels, matrix products, optimizer, other), and the aten ops
  with the most device time.

With ``--table-out`` the full op table is written to that file. Imports
nothing of JAX or ``ray_tpu``.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import statistics
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Kernel-name fragments of each group, checked in order. Inductor's Triton
# kernels come first: their names hold the ops they fuse ("copy", "mm").
GROUPS = (
    ("fused pointwise (Inductor triton_poi/triton_for)",
     ("triton_poi_", "triton_for_")),
    ("fused reductions (Inductor triton_red/triton_per)",
     ("triton_red_", "triton_per_")),
    ("attention K2 (flash_fwd_lse)", ("flash_fwd_bf16_kernel",)),
    ("attention K3 (flash_bwd_dkv)", ("flash_bwd_dkv",)),
    ("attention K4 (flash_bwd_dq)", ("flash_bwd_dq",)),
    ("matrix products (cuBLAS)", ("gemm", "nvjet", "xmma", "cutlass", "sm90_")),
    ("optimizer (multi-tensor AdamW)", ("multi_tensor_apply",)),
    ("reductions", ("reduce",)),
    ("copies and casts", ("copy", "memcpy", "memset")),
)


def group_of(name: str) -> str:
    low = name.lower()
    for group, keys in GROUPS:
        if any(k.lower() in low for k in keys):
            return group
    return "other elementwise"


# Each preset's training shape (B, T): GPT-2 small at the JAX bench's
# (bench.py:103), llama-1b at chip_smoke.py's.
BATCH = {"gpt2-small": (32, 1024), "llama-1b": (8, 2048)}


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="gpt2-small", choices=sorted(BATCH))
    ap.add_argument("--remat-policy", default="dots",
                    choices=("dots", "dots_all", "full", "none"))
    ap.add_argument("--eager", action="store_true",
                    help="profile the eager step (backend=None)")
    ap.add_argument("--table-out", help="file for the full aten op table")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_train_profile: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    # Inductor's and Triton's compile caches inside the checkout (gitignored)
    for var, sub in (("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ.setdefault(var, os.path.join(REPO, ".compile_cache", sub))
    from torch.profiler import ProfilerActivity, profile

    from ray_tpu_torch._private.device import card_info
    from ray_tpu_torch.models import get_preset
    from ray_tpu_torch.train import (
        OptimizerConfig,
        create_train_state,
        make_train_step,
    )

    card = card_info()
    import triton
    print(f"[{card}] torch {torch.__version__} cuda {torch.version.cuda} "
          f"triton {triton.__version__}", flush=True)
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    B, T = BATCH[args.model]
    remat = dict(remat=False) if args.remat_policy == "none" else dict(
        remat=True, remat_policy=args.remat_policy)
    cfg = dataclasses.replace(get_preset(args.model), attention_impl="flash",
                              **remat)
    opt = OptimizerConfig(learning_rate=1e-3, warmup_steps=2,
                          total_steps=20).build()
    state = create_train_state(cfg, opt, torch.Generator().manual_seed(0), dev)
    step = make_train_step(cfg, opt, backend=None if args.eager else "auto")
    kind = "eager" if args.eager else "compiled"
    gen = torch.Generator(device=dev).manual_seed(0)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, T + 1),
                                     device=dev, generator=gen)}

    warm = []
    for _ in range(3):
        t = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        warm.append(time.perf_counter() - t)
    print(f"[{card}] {kind} step warm-up: {', '.join(f'{x:.2f}' for x in warm)} "
          "s (the first compiles)", flush=True)
    if not args.eager:
        print(torch._dynamo.utils.compile_times(), flush=True)
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(5):
        t = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    step_ms = statistics.median(times)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"[{card}] {kind} train step {args.model} B={B} T={T} remat "
          f"{args.remat_policy}: median {step_ms:.2f} ms over 5 steps "
          f"({', '.join(f'{x:.1f}' for x in times)}), "
          f"{B * T / step_ms * 1e3:.0f} tokens/s, peak memory {peak_gb:.2f} GB, "
          f"loss {float(m['loss']):.4f}", flush=True)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    gpu = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in gpu) / 1e3
    print(f"[{card}] profiled {kind} step: wall {wall_ms:.2f} ms (profiler on), "
          f"{len(gpu)} device events, device busy {busy_ms:.2f} ms, idle "
          f"{100 * (1 - busy_ms / wall_ms):.1f}%; against the unprofiled "
          f"median {step_ms:.2f} ms the device is idle "
          f"{100 * (1 - busy_ms / step_ms):.1f}%", flush=True)
    groups = {}
    for e in gpu:
        g = group_of(e.name)
        n, us = groups.get(g, (0, 0.0))
        groups[g] = (n + 1, us + e.time_range.elapsed_us())
    for g, (n, us) in sorted(groups.items(), key=lambda kv: -kv[1][1]):
        print(f"[{card}]   {g}: {us / 1e3:.2f} ms, {n} launches, "
              f"{100 * us / 1e3 / busy_ms:.1f}% of device time", flush=True)
    avg = prof.key_averages()
    key = ("self_device_time_total"
           if avg and hasattr(avg[0], "self_device_time_total")
           else "self_cuda_time_total")
    print(avg.table(sort_by=key, row_limit=20), flush=True)
    if args.table_out:
        os.makedirs(os.path.dirname(os.path.abspath(args.table_out)),
                    exist_ok=True)
        with open(args.table_out, "w") as f:
            f.write(f"{card}\n")
            f.write(avg.table(sort_by=key, row_limit=200))
    return 0


if __name__ == "__main__":
    sys.exit(main())
