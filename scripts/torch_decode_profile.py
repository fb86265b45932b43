#!/usr/bin/env python3
"""Where the port's decode and prefill forwards spend their time, on one
CUDA card.

    python3 scripts/torch_decode_profile.py [--model gpt2-small|llama-1b]

The model at published widths (random weights from a seed, bf16 over f32
parameters) in a ``DecodeEngine``, which captures its programs as CUDA
graphs when it is built: one decode step over the 8-slot batch cache at
position 300, and batch-1 prefills at the engine's buckets. For each it
prints, beside the card's name and power limit:

- eager ms: ``forward_cached`` called directly on the f32 parameters, as
  the engine ran it before its programs were graphs (CUDA events around
  back-to-back calls; host dispatch and the per-use weight casts
  included);
- eager's device ms: the same eager call captured once in a graph and
  replayed, which removes the host from between its kernels; the gap to
  eager ms is the eager path's device idle share;
- device ms: the engine's own graph replayed (the weights cast once).

Then a ``torch.profiler`` pass over one eager decode step and one replay
of the engine's decode graph (run last, since its hooks slow the host):
device kernels per step, their summed time, and the ops or kernels with
the most device time. The replay's summed kernel time against its device
ms shows how much of a replay is gaps between kernels. Imports nothing of
JAX or ``ray_tpu``.
"""
from __future__ import annotations

import argparse
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MODELS = {
    "gpt2-small": dict(vocab_size=50304, max_seq_len=1024, num_layers=12,
                       num_heads=12, embed_dim=768),
    "llama-1b": dict(model_family="llama", vocab_size=32000,
                     max_seq_len=4096, num_layers=16, num_heads=32,
                     num_kv_heads=8, embed_dim=2048),
}


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    import torch

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


def graph_ms(fn) -> float:
    """Device ms of one ``fn`` call, replayed from a CUDA graph."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return cuda_ms(graph.replay, iters=20)


def profile_step(label: str, fn, card: str, rows: int = 12) -> None:
    """One ``fn`` call under torch.profiler: device events, their summed
    time, and the top entries by device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    gpu = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in gpu)
    print(f"[{card}] {label} under torch.profiler: {len(gpu)} device "
          f"events, {busy_us / 1e3:.3f} ms of device time", flush=True)
    avg = prof.key_averages()
    key = ("self_device_time_total"
           if avg and hasattr(avg[0], "self_device_time_total")
           else "self_cuda_time_total")
    print(avg.table(sort_by=key, row_limit=rows), flush=True)


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--model", choices=sorted(MODELS), default="gpt2-small")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_decode_profile: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from ray_tpu_torch._private.device import card_info
    from ray_tpu_torch.llm import DecodeEngine, LLMConfig
    from ray_tpu_torch.models import module_for

    card = card_info()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(0)
    cfg = LLMConfig(dtype="bfloat16", max_batch_slots=8,
                    prefill_buckets=(64, 128, 256), **MODELS[args.model])
    eng = DecodeEngine(cfg, seed=0, device=dev)
    mod, mcfg = module_for(eng.model_config), eng.model_config

    toks = torch.randint(2, 258, (8, 1), device=dev, generator=gen)
    lens = torch.full((8,), 300, dtype=torch.long, device=dev)
    cache = {k: v.clone() for k, v in eng._cache.items()}

    def eager_decode():
        with torch.no_grad():
            mod.forward_cached(eng.params, toks, cache, lens, mcfg)

    eng._decode(tokens=toks, lens=lens)       # the same inputs in its buffers
    eager = cuda_ms(eager_decode, iters=20)
    eager_device = graph_ms(eager_decode)
    device = cuda_ms(eng._decode.graph.replay, iters=50)
    print(f"[{card}] {args.model} decode step, 8 slots: eager {eager:.3f} ms, "
          f"eager's device {eager_device:.3f} ms (idle "
          f"{100 * (1 - eager_device / eager):.1f}%), device (engine graph "
          f"replay) {device:.3f} ms", flush=True)

    start = torch.zeros(1, dtype=torch.long, device=dev)
    cache1 = mod.init_kv_cache(mcfg, 1, cfg.max_seq_len, device=dev)
    for bucket, prog in eng._prefill.items():
        ptoks = torch.randint(2, 258, (1, bucket), device=dev, generator=gen)

        def eager_prefill():
            with torch.no_grad():
                mod.forward_cached(eng.params, ptoks, cache1, start, mcfg)

        prog(tokens=ptoks, start=start)
        eager = cuda_ms(eager_prefill, iters=10)
        eager_device = graph_ms(eager_prefill)
        device = cuda_ms(prog.graph.replay, iters=20)
        print(f"[{card}] {args.model} prefill T={bucket}: eager {eager:.3f} ms, "
              f"eager's device {eager_device:.3f} ms (idle "
              f"{100 * (1 - eager_device / eager):.1f}%), device (engine "
              f"graph replay) {device:.3f} ms", flush=True)

    # Last: the profiler's hooks would slow the host dispatch timed above.
    profile_step(f"{args.model} eager decode step", eager_decode, card)
    profile_step(f"{args.model} engine decode graph replay",
                 eng._decode.graph.replay, card, rows=20)
    return 0


if __name__ == "__main__":
    sys.exit(main())
