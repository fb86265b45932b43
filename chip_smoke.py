#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``ray_tpu_torch``) on one NVIDIA H100.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. Card and toolchain: the card's name and power limit, torch, CUDA and
   Triton versions (Inductor, which compiles the train and eval steps,
   generates Triton; without it those steps raise); TF32 off; every kernel built from ``ray_tpu_torch/ops/csrc``
   (one ``nvcc`` per source, all started together), with no register
   spills in ptxas's report, and the SASS of every wgmma kernel instance
   (K1/K2's bf16 forward, K3's and K4's bf16 bodies) holding ``HGMMA`` and
   ``UTMALDG`` instructions (``cuobjdump``): the Hopper tensor-core and TMA
   paths. Beside the kernels, ``g++`` builds the runtime core's four native
   libraries (arena store, scheduler, ring, transfer) from
   ``ray_tpu_torch/native/src``; each must load. msgpack, cloudpickle, g++
   and make versions are printed.
2. K1 (the flash-attention forward) against its plain blockwise version on
   the card, over the serving shapes and the edge cases; then K2 (the
   forward with lse), K4 (dQ and delta = rowsum(dO * O)) and K3 (dK, dV
   from K4's delta) against theirs, over the same cases and the training
   shape. The cases include llama-1b's serving and training shapes
   (H=32 over Hkv=8: four query heads per kv head) and llama-8b's head
   shape (D=128, GQA 4).
3. The serving path, part one: the GPT-2-small full-sequence forward
   (B=2, T=256) through K1, in bf16 and f32, against the dense version;
   one forward launches K1 once per layer.
4. The serving path, part two: engines at GPT-2-small width, each
   capturing its programs as CUDA graphs when it is built (decode, one
   prefill per bucket and, with speculation, decode_all). Each program is
   held against ``forward_cached`` called eagerly on the original f32
   parameters, on a clone of the same cache and the same inputs (f32
   within 2e-5 + 2e-5|x|, bf16 within 1e-2 + 1e-2|x|, next tokens equal).
   An f32 engine whose greedy tokens must equal argmax over the full
   forward through K1, re-run per step; the same weights with
   ``speculative_ngram_k=4``, whose greedy tokens must equal the plain
   engine's; then a bf16 engine answering 16 mixed requests and the same
   prompts all greedy: ms per tick at 8 slots, the decode replay's device
   ms, prefill ms per bucket and the memory the engine adds, beside eager
   ``forward_cached`` (host ms, and device ms from a graph of it).
5. The training path: GPT-2 small (L=12) at B=32, T=1024, bf16
   activations over f32 parameters, remat "dots", 12 steps of
   ``make_train_step`` on one seeded batch, compiled (the default on the
   card: the loss and the update as two Inductor programs, K2-K4 inside
   as custom ops, each block one nested compile region that every layer
   reuses): finite losses, the first near ln(V), a falling loss,
   per step L launches each of K2, K3 and K4 and none of K1, two programs
   compiled at step 0 and none after it (steps 1.. run under Dynamo's
   error_on_recompile); then 6 steps of the eager step (``backend=None``)
   on the same state, timed beside it; then two compiled steps under
   remat "full", which re-runs K2 in the backward (2L); then the compiled
   eval step, L K1 launches a call, its loss within 1e-2 of the eager
   eval step's.
6. Training parity on the card: f32, GPT-2-small width at depth 2, B=2,
   T=256, 3 compiled steps through the kernels against 3 eager steps on
   the plain (flash_interpret) path: loss and grad_norm per step, and the
   eval loss after them (compiled through K1, eager plain), within 2e-4
   relative. Then one more step from two copies of the compiled state,
   compiled and eager through the same kernels: every exp_avg and
   exp_avg_sq leaf within 2e-4 and 4e-4 of its largest element, every
   parameter element within the step error that this exp_avg error can
   cause through Adam's m_hat / sqrt(v_hat) (up to 2 lr where the
   gradient is near its rounding noise). Then the
   compiled update (Inductor's program of ``clip_adamw_``) against the
   eager one on copies of the compiled state, at the peak lr with
   clipping on: every parameter, moment and step within a few f32
   roundings (1e-6 of the leaf's largest element plus 1e-5 lr; moments
   1e-5).
7. Kernel numbers: K1 at the serving entry shape and K2-K4 at the training
   shape, then K1 at llama-1b's serving shape and K2-K4 at its training
   shape, beside their bounds, plain versions and
   ``scaled_dot_product_attention`` (forward; backward through autograd,
   both from CUDA graphs; GQA through ``enable_gqa=True``), K3 + K4 against
   SDPA's whole backward; the bf16 matmul chain's rate.
8. Llama serving at llama-1b width (L=16, H=32, KV=8, E=2048, M=5504,
   V=32000; ``LLMConfig(model_family="llama")``): the full forward (B=2,
   T=256) through K1 in bf16 and f32 against the dense version, 16 K1
   launches a forward; graphed f32 and bf16 engines held against eager
   ``forward_cached`` as in phase 4; the f32 engine's greedy tokens equal
   argmax over the full forward through K1; the bf16 engine answers phase
   4's requests, with phase 4's numbers.
9. Llama training: the ``llama-1b`` preset (rope_theta 500000) at its
   published widths, its depth cut from 16 layers to 4 (the time of
   phases 15 and 16), at B=8, T=2048, bf16 over f32 parameters, remat
   "dots", 12 compiled steps with phase 5's checks: finite losses, the
   first within 0.5 of ln(32000), a falling loss, per step L launches
   each of K2, K3 and K4 and none of K1, no recompile; then 6 eager
   steps; ms per step, tokens/s, MFU, peak memory and compile seconds of
   both.
10. Llama training parity: f32, llama-1b width at depth 2, B=2, T=256, 3
    compiled steps through the kernels against the eager plain path, and
    the eval loss after them, within 2e-4; the leaves and the compiled
    update as in phase 6.
11. MoE: a llama of 8 SwiGLU experts, top-2, at llama-1b width and depth
    2, in f32: the graphed engine (dropless routing) against eager
    ``forward_cached``, its greedy tokens equal to argmax over the full
    forward through K1; three compiled, capacity-routed train steps with
    router jitter 0.01 through K2-K4 (the last two at a nonzero lr) give
    finite losses, a positive aux loss, no recompile, and equal three
    eager steps within 2e-4, their leaves and the compiled update as in
    phase 6.
12. The OpenAI surface at GPT-2-small width, f32, on the card:
    ``LLMServer(device="cuda")`` completions (with a logprobs block) and
    chat whose tokens equal argmax over the full forward through K1; a
    stream whose joined deltas equal the completion's text and end in
    ``[DONE]``; ``PDIngress`` over in-process handles on a prefill and a
    decode server, equal to the monolithic engine for a seeded top-p
    request; the batch stage over 16 prompts, each row equal to its prompt
    alone; the requests' tokens/s of 16 concurrent completions.
13. The parallel layer. (a) The ring's per-step body
    (``parallel/ring_attention.py``: ``ring_piece``, ``ring_merge``,
    ``ring_piece_bwd``) at llama-1b's training shape, B=8, T=2048 in 4
    chunks of 512, H=32 over Hkv=8, D=64, bf16, in one process (the
    rotation is an index): every rank's pieces through K2 (causal on the
    diagonal chunk, not causal below it) merged in f32 by lse, and their
    backward through K4 + K3 from the merged out and lse, against K2 and
    K4 + K3 over the whole sequence; then the same with causal=False
    throughout. (b) The mesh path at full width: a world-size-1 NCCL group
    and ``single_device_mesh()``; llama-1b (phase 9's config and batch)
    through ``create_train_state(mesh=)`` and ``make_train_step(config,
    opt, mesh)`` (compiled: on one rank the model does not communicate),
    6 steps: finite, falling, no recompile after step 0, L launches each of
    K2, K3 and K4 a step, the first loss within 2e-3 relative of phase 9's
    compiled step on the same state and batch (the reference's
    sharded-against-unsharded bound), and the mesh eval step (L K1
    launches); then, eagerly, 6 steps each with attention_impl "ring" and
    "ulysses" (seq=1) and one step with pipeline_microbatches=2 (stage=1):
    ms per step, tokens/s and peak memory beside phase 9's.
14. The runtime core (``ray_tpu_torch.init/remote/get/put/wait``) at
    GPT-2-small width: a head and 2 node processes of 4 CPUs, the card
    node 0's ``GPU`` resource with its accelerator label. (a) A task
    pinned to node 1 sees ``CUDA_VISIBLE_DEVICES=""`` and no card; no node
    loaded jax, jaxlib, ray_tpu or torch at spawn. (b) The parameters, put
    once as CPU tensors (~0.5 GB); a ``num_gpus=0.5`` task takes them by
    reference, runs the full forward (B=2, T=256) through K1 in bf16 and
    f32 (L K1 launches a forward) and returns CUDA logits, which land on
    the driver's card equal bit for bit to the driver's own forward. (c) A
    ``num_gpus=0.5, max_concurrency=16`` actor wraps ``LLMServer`` over the
    same reference, capturing its graphs while a task runs forwards on the
    card in another thread of the node; its 16 concurrent greedy
    completions each equal argmax over the full forward through K1. K1's
    count on node 0 is the tasks' forwards, the warm-up calls of the
    actor's prefill programs, and L a replay of them. (d)
    1,000 empty tasks and 1,000 actor calls a second, put + get GB/s of a
    256 MiB f32 CPU tensor and of a 256 MiB bf16 CUDA tensor (staged), the
    actor's tokens/s beside phase 12's, the seconds to spawn a node. (e)
    After ``shutdown()`` (which phase 15 precedes) no node process and no
    new shm segment is left.
15. The trainer on the card, inside phase 14's session:
    ``SPMDTrainer(...).fit()`` trains GPT-2 small (phase 5's preset,
    dtypes, remat, optimizer and shape) through ``default_train_loop`` on
    one worker actor that holds node 0's ``GPU``, under an NCCL world of
    one, 8 steps with a checkpoint every 4; its first attempt fails just
    after step 4's checkpoint and ``FailureConfig(max_failures=1)`` resumes
    it there. The result is at step 8, the steps reported 1-8 once each,
    every loss finite, the first within 2e-3 relative of phase 5's compiled
    step run in the driver on the same seed and batch; K2, K3 and K4 12
    launches each a step run in the worker's process, K1 none; the final
    checkpoint loads in the driver on the card at step 8. A
    ``TorchTrainer`` DDP loop on NCCL, world size 1, on the card gives
    parameters bit-equal to the same loop without the trainer. Printed:
    ms a step and tokens/s beside phase 5's, each attempt's first step
    seconds and Inductor's FX graph cache hits and misses in the worker,
    checkpoint save and load seconds and bytes, the worker's peak memory,
    the phase's seconds.
16. Serve on the card, in a session of its own (head and 2 nodes of 8
    CPUs, the card node 0's ``GPU``, 512 MiB arenas): ``serve_llm`` deploys the
    OpenAI app over phase 12's weights (GPT-2 small, f32, read from a
    ``model_source`` bundle written in phase 12) on one replica with
    ``num_gpus=1`` and ``device="cuda"``; the HTTP proxy answers 16 mixed
    completions at once (phase 12's payloads) and a ``stream: true``
    completion, a ``DeploymentHandle`` one with logprobs. The greedy
    answers, the stream and the handle's tokens equal phase 12's
    in-process ``LLMServer``'s. Then ``build_pd_openai_app`` with a
    prefill and a decode replica at ``num_gpus=0.5`` each on the card:
    its answer equals the monolithic app's, once the first replica's
    engine is gone from node 0's process. K1's count there, set to 0 when
    each app is ready and read after its requests, is L a prefill replay
    of its engines. Printed: tokens/s over HTTP
    beside phase 12's and phase 14's, the seconds from ``serve.run`` to a
    ready replica. After ``serve.shutdown()`` and ``shutdown()`` no node
    process (the replicas, the proxy and the controller are threads in
    them) and no shm segment of the session is left; the phase takes at
    most 150 s.
17. Runtime environments on the card, inside phase 14's session after its
    numbers and before phase 15 (the session's ``RT_RUNTIME_ENV_DIR`` a
    directory of its own, ``PIP_NO_INDEX=1``): GPT-2 small (full width and
    depth, bf16, B=2, T=256) through K1 (a) from a ``num_gpus=1`` task
    with ``env_vars``, ``working_dir``, ``py_modules`` (the helper module)
    and a ``worker_process_setup_hook``, beside a plain task: logits
    bit-equal to the driver's own forward, the env var seen, the cwd the
    working directory, the hook run once; (b) from a ``pip`` task whose
    venv installs the helper from a hand-rolled wheel: it runs in the
    venv's executor child, which sees the card through the node's
    ``CUDA_VISIBLE_DEVICES``; its host logits bit-equal to the driver's,
    K1 counted in the child, exactly L a forward; a second call reuses
    the venv and its child; (c) from an ``ActorPool`` of two
    ``num_gpus=0.5`` actors holding the model, whose ``map`` answers 8
    prompts (B=1, T=256) with argmax in order, equal to the driver's, K1
    read in the actors' process, exactly 8 L. Then the state API
    (``summarize_tasks``/``list_tasks`` show the phase's tasks finished,
    ``list_actors`` the two pooled actors alive, ``memory_summary`` the
    parameters' object) and a ``Queue`` of maxsize 2 carrying the 8
    prompts from a task to the driver in order. Printed: the first pip
    call and the venv build in it, the second call, the env task's ms
    beside the plain task's, the child's forward ms, the pool's prompts/s,
    the phase's seconds (at most 90). After phase 14's ``shutdown()`` no
    executor child runs and no venv build lock is held.

The engines' prefill programs attend through K1 (a new prompt attends to
itself, ``forward_cached(fresh=True)``): K1's wrapper launches it in the
warm-up calls; while a graph is captured it launches nothing and adds to
the capture's record instead, and each replay adds that record
(``ops.attention.recorded``, ``llm.programs.Program``). Launch counts are
set to 0 just before each main path and read just after it: K1's before phase 3 and after phase 4 (GPT-2 serving), before
and after phase 8 (llama serving) and phase 12 (the OpenAI surface, where
K1 runs the full-forward yardstick); K2-K4's before and after the 12 steps
of phase 5 (GPT-2) and of phase 9 (llama); K1's before and after the two
calls of phase 5's compiled eval step; K2-K4's before and after phase 13's
ring body (causal and not) and its mesh train steps, and K1's around its
mesh eval step; phase 14's K1 count lives in node 0's process (its tasks
and its actor are threads there): its first task sets it to 0, the actor
reads it after the completions; phase 15's K2-K4 counts live there too,
set to 0 by a task on node 0 just before ``fit()`` and read by one just
after it; phase 17's K1 counts are each task's own launches read around
its forward, in node 0's process and in the executor child, and the
pool's, set to 0 in the actors' process just before ``map`` and read just
after it; phase 16's K1 count lives in node 0's process of its own
session, where the replicas run: a task there sets it to 0 once each app
is ready and reads it after that app's requests. The engines' programs count
their graph replays; each must replay on its main path. The last lines are the card, the
``kernels`` JSON line and the result line. It imports nothing of JAX and
nothing of ``ray_tpu``.
"""
from __future__ import annotations

import copy
import dataclasses
import gc
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import Future, ThreadPoolExecutor
from types import SimpleNamespace

HERE = os.path.dirname(os.path.abspath(__file__))
DEVICE = "cuda"

# GPT-2 small, the width the port serves (ray_tpu/models/gpt2.py
# GPT2_SMALL); the weights are random, from a seed.
MODEL = dict(vocab_size=50304, max_seq_len=1024, num_layers=12,
             num_heads=12, embed_dim=768)
FORWARD_BATCH = (2, 256)          # __graft_entry__.py:entry's forward
PREFILL_BUCKETS = (64, 128, 256)
# The JAX package's training bench shape (bench.py:103): B=32, T=1024.
TRAIN_BATCH = (32, 1024)
TRAIN_STEPS = 12
# Steps of the eager step (backend=None), timed beside the compiled one.
EAGER_STEPS = 6

# llama-1b (ray_tpu/models/llama.py LLAMA_1B) at published widths: served
# as LLMConfig(model_family="llama") builds it (rope_theta and mlp_dim at
# LlamaConfig's defaults, as in JAX), trained as the preset itself, cut to
# LLAMA_TRAIN_LAYERS of its 16 layers in phases 9 and 13 (their compiles
# take most of their time, and phases 15 and 16 need the room).
LLAMA_ENGINE = dict(model_family="llama", vocab_size=32000, max_seq_len=4096,
                    num_layers=16, num_heads=32, num_kv_heads=8,
                    embed_dim=2048)
LLAMA_TRAIN_BATCH = (8, 2048)
LLAMA_TRAIN_LAYERS = 4

# Published peaks of one H100 SXM (NVIDIA data sheet, dense).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

# K1 against its plain version (same inputs, same arithmetic contract):
# f32 keeps the reference's own 2e-5 (tests/test_attention.py). bf16: each
# side rounds its output to bf16 and P to bf16 before PV, at most 2^-8
# relative each, so 1e-2 absolute and relative.
TOL = {"float32": (2e-5, 2e-5), "bfloat16": (1e-2, 1e-2)}
# lse is f32 arithmetic on the same input values on both sides (bf16 values
# are exact in f32): only the order of the sums differs, so 2e-5 holds for
# both dtypes.
LSE_TOL = (2e-5, 2e-5)
# K3/K4 against their plain versions: f32 keeps the reference's gradient
# bound 2e-4 (tests/test_attention.py:48). bf16: both sides cast P and dS to
# bf16 before their products from f32 values that agree to the summation
# order (a rounding flip is rare), and each rounds its output to bf16 (2^-8
# relative), so K1's 1e-2 absolute and relative holds.
GRAD_TOL = {"float32": (2e-4, 2e-4), "bfloat16": (1e-2, 1e-2)}


# K1-K4 against their plain versions, phase 2: the serving shapes and the
# edge cases (the training shape is added there).
CASES = [
    # name, B, T, H, Hkv, D, causal, dtype, fused
    ("entry", 2, 256, 12, 12, 64, True, "bfloat16", False),
    ("entry", 2, 256, 12, 12, 64, True, "float32", False),
    ("entry-fused-qkv", 2, 256, 12, 12, 64, True, "bfloat16", True),
    # The engines' prefill programs (one prompt a bucket of
    # PREFILL_BUCKETS): GPT-2 small's heads in both dtypes (phases 4, 12,
    # 14 and 16 serve f32), llama-1b's (phase 8) further down.
    ("bucket64", 1, 64, 12, 12, 64, True, "bfloat16", False),
    ("bucket64", 1, 64, 12, 12, 64, True, "float32", False),
    ("bucket128", 1, 128, 12, 12, 64, True, "bfloat16", False),
    ("bucket128", 1, 128, 12, 12, 64, True, "float32", False),
    ("bucket256", 1, 256, 12, 12, 64, True, "bfloat16", False),
    ("bucket256", 1, 256, 12, 12, 64, True, "float32", False),
    ("ragged96", 1, 96, 12, 12, 64, True, "bfloat16", False),
    ("ragged96", 1, 96, 12, 12, 64, True, "float32", False),
    ("ragged1000", 1, 1000, 12, 12, 64, True, "bfloat16", False),
    ("ragged1000", 1, 1000, 12, 12, 64, True, "float32", False),
    ("noncausal", 2, 256, 12, 12, 64, False, "bfloat16", False),
    ("noncausal-ragged", 1, 1000, 4, 4, 64, False, "float32", False),
    ("gqa", 2, 256, 4, 2, 64, True, "bfloat16", False),
    ("gqa-ragged", 1, 100, 4, 2, 64, False, "float32", False),
    ("d16", 1, 200, 4, 4, 16, True, "bfloat16", False),
    ("d16", 1, 200, 4, 4, 16, True, "float32", False),
    ("d32", 1, 200, 4, 4, 32, True, "bfloat16", False),
    ("d32", 1, 200, 4, 4, 32, True, "float32", False),
    ("d128", 1, 200, 4, 4, 128, True, "bfloat16", False),
    ("d128", 1, 200, 4, 4, 128, True, "float32", False),
    # An odd length with GQA: ragged TMA boxes, lse/delta rows of a
    # length that is no multiple of 4.
    ("odd77-gqa", 2, 77, 4, 2, 64, True, "bfloat16", False),
    # The wgmma kernels' other layouts: GQA and V's transposed descriptor at
    # D=128 without the mask, and K3's non-causal walk at the small head dims.
    ("d128-noncausal-gqa", 1, 300, 4, 2, 128, False, "bfloat16", False),
    ("d16-gqa-odd", 1, 77, 4, 2, 16, True, "bfloat16", False),
    ("d32-noncausal", 1, 150, 4, 4, 32, False, "bfloat16", False),
    # A longer causal walk: the tile rings spend most of their time in
    # steady state.
    ("long2048", 4, 2048, 12, 12, 64, True, "bfloat16", True),
    # llama-1b's serving and training shapes: four query heads per kv head
    # (K3 sums dK/dV over all four), and llama-8b's head shape at D=128.
    ("llama1b-serve", 2, 256, 32, 8, 64, True, "bfloat16", False),
    ("llama1b-serve", 2, 256, 32, 8, 64, True, "float32", False),
    ("llama1b-bucket64", 1, 64, 32, 8, 64, True, "bfloat16", False),
    ("llama1b-bucket64", 1, 64, 32, 8, 64, True, "float32", False),
    ("llama1b-bucket128", 1, 128, 32, 8, 64, True, "bfloat16", False),
    ("llama1b-bucket128", 1, 128, 32, 8, 64, True, "float32", False),
    ("llama1b-bucket256", 1, 256, 32, 8, 64, True, "bfloat16", False),
    ("llama1b-bucket256", 1, 256, 32, 8, 64, True, "float32", False),
    ("llama1b-train", 8, 2048, 32, 8, 64, True, "bfloat16", False),
    ("llama8b-d128", 1, 1024, 32, 8, 128, True, "bfloat16", False),
]


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device ms of ``fn`` over ``iters`` back-to-back calls (CUDA
    events around the run, after a warm-up)."""
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


def graph_ms(fn, reps: int = 100, stream=None) -> float:
    """Device ms per call of ``fn``: ``reps`` calls captured in one CUDA
    graph and replayed, so no host work sits between the launches (the
    eager ``cuda_ms`` of a single small kernel measures the host's
    dispatch instead). Warm-up and capture run on ``stream`` (a new side
    stream by default); a backward through autograd runs on its forward's
    stream, so time it with the stream its forward ran on."""
    import torch

    side = stream or torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(reps):
            fn()
    return cuda_ms(graph.replay, iters=5, warmup=1) / reps


# What each attention kernel reads and writes, in [B, T, heads, D] tensors
# of the input dtype ("q" = B*Tq*H rows, "kv" = B*Tk*Hkv rows) and
# [B, H, Tq] f32 rows, and how many [Tq x Tk x D] products it runs.
KERNEL_WORK = {
    "flash_fwd": dict(q=2, kv=2, f32_rows=0, products=2),          # q, o | k, v
    "flash_fwd_lse": dict(q=2, kv=2, f32_rows=1, products=2),      # + lse
    "flash_bwd_dkv": dict(q=2, kv=4, f32_rows=2, products=4),      # q, dO | k, v, dk, dv | lse, delta
    "flash_bwd_dq": dict(q=4, kv=2, f32_rows=2, products=3),       # q, dO, O, dq | k, v | lse, delta
}


def attn_bound_ms(kernel, B, Tq, Tk, H, Hkv, D, causal, dtype_name):
    """Least time for one attention kernel's work: each input read once and
    each output written once over the HBM rate, or its products over the
    tensor (bf16) or FMA (f32) peak, whichever is longer. Products count
    only the (query, key) pairs this call needs: the causal triangle when
    causal. Returns (ms, "bytes" | "operations")."""
    w = KERNEL_WORK[kernel]
    elt = 2 if dtype_name == "bfloat16" else 4
    nbytes = (elt * D * (w["q"] * B * Tq * H + w["kv"] * B * Tk * Hkv)
              + 4 * w["f32_rows"] * B * H * Tq)
    if causal:
        pairs = sum(min(i + 1, Tk) for i in range(Tq))
    else:
        pairs = Tq * Tk
    flops = 2.0 * D * pairs * B * H * w["products"]
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# Kernels built on wgmma and TMA: {symbol: (label, instances)}. Each
# instance's SASS must hold both; the forward has one per head dim with and
# without lse, K3 and K4 one per head dim.
HOPPER_KERNELS = {"flash_fwd_bf16_kernel": ("K1/K2 bf16 forward", 8),
                  "flash_bwd_dkv_bf16_kernel": ("K3 bf16", 4),
                  "flash_bwd_dq_bf16_kernel": ("K4 bf16", 4)}


def sass_counts(lib: str, cuobjdump: str, ops=("HGMMA", "UTMALDG"),
                sass: str | None = None) -> dict:
    """{kernel function: {op: n}}: how many SASS instructions of each of
    ``ops`` each function of one built library holds (``cuobjdump -sass``,
    or the listing given as ``sass``)."""
    if sass is None:
        sass = subprocess.run([cuobjdump, "-sass", lib], capture_output=True,
                              text=True, check=True).stdout
    counts, func = {}, None
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            func = m.group(1)
            counts[func] = dict.fromkeys(ops, 0)
        elif func:
            for op in ops:
                if re.search(r"\b" + re.escape(op) + r"\b", line):
                    counts[func][op] += 1
    return counts


def close(out, ref, tol):
    """(max abs error, number of elements outside atol + rtol * |ref|)."""
    atol, rtol = tol
    err = (out.float() - ref.float()).abs()
    return float(err.max()), int((err > atol + rtol * ref.float().abs()).sum())


def matmul_roof_tflops() -> float:
    """Measured bf16 matmul rate of the card, TFLOP/s: the JAX bench's
    transformer-MLP-shaped chain (bench.py:measure_achievable_tflops, M=32k,
    E=1024, H=4096, 12 pairs of products a call), timed with CUDA events."""
    import torch

    M, E, H, inner = 32 * 1024, 1024, 4096, 12
    x = torch.full((M, E), 1.0 / E, dtype=torch.bfloat16, device="cuda")
    w1 = torch.full((E, H), 1.0 / H, dtype=torch.bfloat16, device="cuda")
    w2 = torch.full((H, E), 1.0 / E, dtype=torch.bfloat16, device="cuda")

    def chain():
        y = x
        for _ in range(inner):
            y = (y @ w1) @ w2
        return y

    ms = cuda_ms(chain, iters=5, warmup=2)
    return 2 * M * E * H * 2 * inner / (ms * 1e-3) / 1e12


def ring_body_fwd(qc, kc, vc, causal):
    """Ring attention's forward for every rank of an n-rank ring in one
    process, from its per-step body (``parallel/ring_attention.py``): query
    chunk i meets key/value chunk (i - step) mod n at each step, the
    rotation an index. qc, kc, vc: the n chunks. Returns (out, lse) over the
    whole sequence: out in q's dtype, lse f32."""
    import torch

    from ray_tpu_torch.parallel import ring_attention as ring

    n, outs, lses = len(qc), [], []
    for i in range(n):
        acc = None
        for step in range(n):
            src = (i - step) % n
            acc = ring.ring_merge(acc, ring.ring_piece(
                qc[i], kc[src], vc[src], i, src, causal))
        outs.append(acc[0].to(qc[i].dtype))
        lses.append(acc[1])
    return torch.cat(outs, 1), torch.cat(lses, 2)


def ring_body_bwd(qc, kc, vc, dc, out, lse, causal):
    """The backward of ``ring_body_fwd`` from the same per-step body, with
    the whole sequence's out and lse: dq summed over its key chunks, dk/dv
    over their query chunks, in f32, then cast to q's dtype."""
    import torch

    from ray_tpu_torch.parallel import ring_attention as ring

    n, f32, tl = len(qc), torch.float32, qc[0].shape[1]
    oc, lc = out.split(tl, 1), lse.split(tl, 2)
    dq = [torch.zeros_like(x, dtype=f32) for x in qc]
    dk = [torch.zeros_like(x, dtype=f32) for x in kc]
    dv = [torch.zeros_like(x, dtype=f32) for x in vc]
    for i in range(n):
        for step in range(n):
            src = (i - step) % n
            g = ring.ring_piece_bwd(qc[i], kc[src], vc[src], oc[i], lc[i],
                                    dc[i], i, src, causal)
            if g is not None:
                dq[i] += g[0]
                dk[src] += g[1]
                dv[src] += g[2]
    return tuple(torch.cat(x, 1).to(qc[0].dtype) for x in (dq, dk, dv))


def lively(model, names):
    """Random weights from the seed with the named block projections (and
    GPT-2's wpe) x3: at the plain init greedy decoding only repeats the
    last prompt token, which a broken cache would reproduce as well."""
    import torch

    with torch.no_grad():
        for n in names:
            model["blocks"][n].mul_(3.0)
        if hasattr(model, "wpe"):
            model["wpe"].mul_(3.0)
    return model


GPT2_LIVELY = ("qkv_w", "proj_w", "fc_w", "out_w")
LLAMA_LIVELY = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def build_native():
    """The runtime core's native libraries, built with g++ from
    ``ray_tpu_torch/native/src`` into ``ray_tpu_torch/native/_build``:
    ``({library: loaded}, compiler output of a failed build or None)``."""
    from ray_tpu_torch import native
    from ray_tpu_torch.native import ring, sched, xfer

    loaded = {"librt_native": native.load_library() is not None,
              "librt_sched": sched._load_library() is not None,
              "librt_ring": ring._load_library() is not None,
              "librt_xfer": xfer._load_library() is not None}
    return loaded, native.build_failure()


def _running(pid):
    try:
        with open(f"/proc/{pid}/status") as f:
            return "zombie" not in f.read()
    except OSError:
        return False


def session_leftovers(pids, port, object_hexes, renv_root=None):
    """What a runtime session left on this machine, looked up by its own
    names only (other sessions on the host are not this one's fault): its
    node processes still running, and the shm segments its names give: the
    arena of its head port, the rings its processes (``pids`` and this one)
    made, and the segments of the objects it stored. With ``renv_root``
    (the session's ``RT_RUNTIME_ENV_DIR``), also the runtime-env executor
    children still running (a process whose command line names a venv
    there) beside the node processes, and the venv build locks some
    process still holds beside the segments."""
    import fcntl

    alive = [pid for pid in pids if _running(pid)]
    rings = tuple(f"rtring_{pid}_" for pid in (*pids, os.getpid()))
    mine = {f"rt_arena_{port}_{os.getuid()}",
            *(f"rt_{h}" for h in object_hexes)}
    segs = sorted(n for n in os.listdir("/dev/shm")
                  if n in mine or n.startswith(rings))
    venvs = os.path.join(renv_root or "", "venvs")
    if renv_root and os.path.isdir(venvs):
        for pid in filter(str.isdigit, os.listdir("/proc")):
            try:
                with open(f"/proc/{pid}/cmdline", "rb") as f:
                    if venvs.encode() in f.read() and _running(pid):
                        alive.append(int(pid))
            except OSError:
                pass
        for name in sorted(os.listdir(venvs)):
            if name.endswith(".lock"):
                with open(os.path.join(venvs, name), "w") as f:
                    try:
                        fcntl.flock(f, fcntl.LOCK_EX | fcntl.LOCK_NB)
                        fcntl.flock(f, fcntl.LOCK_UN)
                    except OSError:
                        segs.append(name)
    return alive, segs


def runtime_phase(card, device, model_kw, text, phase12_tok_s, then=None):
    """Phase 14: the runtime core on the card. Returns its numbers, the
    launches on the path of the node that holds the card (its tasks and its
    actor share one process, so one count covers them: ``node_launches``)
    and, apart, those of the actor's argmax check (``check_launches``).
    ``then(node_id)``, given the id of the card's node, runs in the same
    session before its shutdown; its result is ``out["then"]``."""
    import dataclasses
    import shutil
    import tempfile

    import numpy as np
    import torch

    import ray_tpu_torch as rt
    from ray_tpu_torch._private.config import rt_config
    from ray_tpu_torch.llm import LLMConfig
    from ray_tpu_torch.llm import programs as rt_programs
    from ray_tpu_torch.models import common, gpt2
    from ray_tpu_torch.native import arena as native_arena
    from ray_tpu_torch.util.scheduling_strategies import (
        NodeAffinitySchedulingStrategy as Pin,
    )

    dev = torch.device(device)
    # node processes import the package from this checkout, whatever the
    # working directory
    os.environ["PYTHONPATH"] = os.pathsep.join(
        p for p in (HERE, os.environ.get("PYTHONPATH")) if p)
    st = os.statvfs("/dev/shm")
    want = int(rt_config.arena_bytes)
    arena = native_arena._shm_budget(want)
    log(f"/dev/shm: {st.f_blocks * st.f_frsize / 2**30:.1f} GiB, "
        f"{st.f_bavail * st.f_frsize / 2**30:.1f} GiB free; the arena: "
        f"{arena / 2**30:.2f} GiB of the configured {want / 2**30:.2f} GiB")
    if arena < want:
        log(f"the arena is capped to {arena} bytes to fit /dev/shm "
            "(no _system_config set)")
    # phase 17's venvs and staged packages, under a directory of the
    # session's own; pip installs only the local wheel it is given
    renv_root = tempfile.mkdtemp(prefix="rt_runtime_env_")
    os.environ["RT_RUNTIME_ENV_DIR"] = renv_root
    os.environ["PIP_NO_INDEX"] = "1"
    out = {}
    t0 = time.perf_counter()
    rt.init(num_cpus=4, num_nodes=2)
    out["init_s"] = time.perf_counter() - t0
    cluster = rt._internal_cluster()
    object_hexes = []
    try:
        # (a) the cluster: the card is node 0's GPU resource
        res = rt.cluster_resources()
        nodes = [n for n in rt.nodes() if n["alive"]]
        gpu_nodes = [n for n in nodes if n["resources"].get("GPU")]
        cpu_nodes = [n for n in nodes if not n["resources"].get("GPU")]
        log(f"cluster: resources {res}; node labels "
            f"{[n['labels'] for n in nodes]}")
        check(res.get("GPU") == 1.0 and len(gpu_nodes) == 1
              and len(cpu_nodes) == 1, f"cluster resources {res}")
        label = gpu_nodes[0]["labels"].get("ray_tpu_torch.accelerator_type")
        check(bool(label) and label in torch.cuda.get_device_name(0),
              f"node 0's accelerator label {label!r} does not name the card")

        @rt.remote
        def node_view():
            import os
            import sys

            view = {"cvd": os.environ.get("CUDA_VISIBLE_DEVICES"),
                    "torch_at_spawn": "torch" in sys.modules,
                    "loaded": sorted({m.split(".")[0] for m in sys.modules}
                                     & {"jax", "jaxlib", "ray_tpu"})}
            import torch

            view["cuda"] = torch.cuda.is_available()
            if view["cuda"]:
                # the card's launch counts start here, before the path
                from ray_tpu_torch.ops import attention as attn

                for name in attn.launches:
                    attn.launches[name] = 0
            return view

        views = {}
        for key, n in (("node0", gpu_nodes[0]), ("node1", cpu_nodes[0])):
            views[key] = rt.get(node_view.options(
                scheduling_strategy=Pin(n["node_id"])).remote())
        log(f"node views: {views}")
        check(views["node1"]["cvd"] == "" and not views["node1"]["cuda"],
              f"node 1 (no GPU) sees a card: {views['node1']}")
        check(views["node0"]["cuda"] and views["node0"]["cvd"] not in ("", None),
              f"node 0 sees no card: {views['node0']}")
        check(all(not v["loaded"] and not v["torch_at_spawn"]
                  for v in views.values()),
              f"a node process loaded jax, ray_tpu or torch at spawn: {views}")

        # (b) GPT-2 small's parameters, put once as CPU tensors; a task on
        # the card takes them by reference and returns CUDA logits
        cfg = gpt2.GPT2Config(**model_kw, attention_impl="flash")
        host = gpt2.init_params(cfg, torch.Generator().manual_seed(14), "cpu")
        with torch.no_grad():
            for n in GPT2_LIVELY:
                host["blocks"][n].mul_(3.0)
            host["wpe"].mul_(3.0)
            host["wte"][258:].zero_()   # greedy text stays in the bytes
        tree = {k: ({n: p.detach() for n, p in v.items()}
                    if isinstance(v, dict) else v.detach())
                for k, v in common.param_tree(host).items()}
        nbytes = sum(p.numel() * p.element_size() for p in
                     [*tree["blocks"].values()] + [
                         v for v in tree.values() if not isinstance(v, dict)])
        t0 = time.perf_counter()
        params_ref = rt.put(tree)
        put_s = time.perf_counter() - t0
        object_hexes.append(params_ref.hex())
        log(f"[{card}] put GPT-2 small's parameters: {nbytes / 1e9:.3f} GB "
            f"in {put_s:.3f} s")

        @rt.remote(num_gpus=0.5)
        def forward_task(tree, tokens, cfg, device):
            import dataclasses

            import torch

            from ray_tpu_torch.models import gpt2
            from ray_tpu_torch.ops import attention as attn

            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
            model = gpt2.GPT2(cfg, tree, device=device)
            tokens = tokens.to(device)
            logits, per_forward = {}, []
            with torch.no_grad():
                for dtype in (torch.bfloat16, torch.float32):
                    before = attn.launches["flash_fwd"]
                    logits[str(dtype)], _ = gpt2.forward(
                        model, tokens, dataclasses.replace(cfg, dtype=dtype))
                    if torch.cuda.is_available():
                        torch.cuda.synchronize()
                    per_forward.append(attn.launches["flash_fwd"] - before)
            return logits, per_forward

        B, T = FORWARD_BATCH
        tokens = torch.randint(0, cfg.vocab_size, (B, T),
                               generator=torch.Generator().manual_seed(14))
        t0 = time.perf_counter()
        logits, per_forward = rt.get(forward_task.remote(
            params_ref, tokens, cfg, device))
        task_s = time.perf_counter() - t0
        own_model = gpt2.GPT2(cfg, tree, device=dev)
        with torch.no_grad():
            for dtype in (torch.bfloat16, torch.float32):
                got = logits[str(dtype)]
                own, _ = gpt2.forward(own_model, tokens.to(dev),
                                      dataclasses.replace(cfg, dtype=dtype))
                diff = float((got.to(own.device) - own).abs().max())
                log(f"task forward {dtype} B={B} T={T}: logits on "
                    f"{got.device}, max|task-driver| {diff:.3e}")
                check(got.device == own.device and torch.equal(got, own),
                      f"the task's {dtype} logits ({got.device}) differ from "
                      f"the driver's own forward through K1: {diff:.3e}")
        del own_model, logits, got, own
        log(f"task forward: K1 launches per forward {per_forward}; "
            f"task round trip {task_s:.3f} s")
        check(per_forward == [cfg.num_layers] * 2,
              f"the task launched K1 {per_forward} times a forward, want "
              f"{cfg.num_layers}")

        # (c) an actor serving 16 concurrent greedy completions while a task
        # launches on the card in another thread of the same process
        @rt.remote(num_gpus=0.5)
        def busy_task(tree, cfg, device, stop_path):
            import os
            import time

            import torch

            from ray_tpu_torch.models import gpt2

            model = gpt2.GPT2(cfg, tree, device=device)
            tokens = torch.zeros((2, 256), dtype=torch.long, device=device)
            n, t_end = 0, time.monotonic() + 300
            with torch.no_grad():
                while not os.path.exists(stop_path) and time.monotonic() < t_end:
                    gpt2.forward(model, tokens, cfg)[0].sum().item()
                    n += 1
            return n

        @rt.remote(num_gpus=0.5, max_concurrency=16)
        class Server:
            def __init__(self, cfg_dict, tree, device):
                import torch

                from ray_tpu_torch.llm import LLMConfig, LLMServer
                from ray_tpu_torch.models import gpt2

                torch.backends.cuda.matmul.allow_tf32 = False
                config = LLMConfig.from_dict(cfg_dict)
                self.model = gpt2.GPT2(config.model_config(), tree,
                                       device=device)
                self.srv = LLMServer(cfg_dict, params=self.model,
                                     device=device)
                self.device = device

            def complete(self, payload):
                return self.srv.completions(payload)

            def ping(self):
                return None

            def forward_argmax(self, prompts, n_new):
                """Greedy tokens of each prompt by argmax over the full
                forward through K1, re-run per step (phase 12's
                yardstick), the stop token dropped."""
                import dataclasses

                import torch

                from ray_tpu_torch.models import gpt2

                eng = self.srv.engine
                cfg = dataclasses.replace(eng.model_config,
                                          attention_impl="flash")
                out = []
                with torch.no_grad():
                    for prompt in prompts:
                        seq, expect = eng.tokenizer.encode(prompt), []
                        for _ in range(n_new):
                            logits, _ = gpt2.forward(eng.params, torch.tensor(
                                [seq], device=self.device), cfg)
                            nxt = int(logits[0, -1].argmax())
                            if nxt == eng.tokenizer.eos_id:
                                break
                            expect.append(nxt)
                            seq.append(nxt)
                        out.append(expect)
                return out

            def launches(self):
                from ray_tpu_torch.ops import attention as attn

                return dict(attn.launches)

            def prefill_replays(self):
                return sum(p.replays for p in self.srv.engine._prefill.values())

            def shutdown(self):
                self.srv.engine.shutdown()

        stop_dir = tempfile.mkdtemp(prefix="phase14_")
        stop_path = os.path.join(stop_dir, "stop")
        busy = busy_task.remote(params_ref, cfg, device, stop_path)
        cfg_dict = LLMConfig(dtype="float32", **model_kw, max_batch_slots=8,
                             prefill_buckets=PREFILL_BUCKETS).to_dict()
        t0 = time.perf_counter()
        server = Server.remote(cfg_dict, params_ref, device)
        rt.get(server.ping.remote())
        actor_s = time.perf_counter() - t0
        payloads = [{"prompt": text[i:i + 8 + 12 * i], "max_tokens": 32,
                     "logprobs": 1} for i in range(16)]
        t0 = time.perf_counter()
        answers = rt.get([server.complete.remote(p) for p in payloads])
        serve_s = time.perf_counter() - t0
        with open(stop_path, "w"):
            pass
        busy_forwards = rt.get(busy)
        shutil.rmtree(stop_dir, ignore_errors=True)
        # K1 on the path: the task's two forwards, the busy task's, the
        # actor's engine build (each prefill program attends through K1: the
        # warm-up calls per bucket launch it; the capture records it) and
        # the replays of its prefill programs, which launch what the capture
        # recorded
        L = cfg.num_layers
        out["node_launches"] = rt.get(server.launches.remote())
        path_k1 = out["node_launches"]["flash_fwd"]
        build_k1 = rt_programs._WARMUP * len(PREFILL_BUCKETS) * L
        replays_k1 = L * rt.get(server.prefill_replays.remote())
        log(f"K1 launches on node 0's path: {path_k1} (task 2 x {L}, busy "
            f"task {busy_forwards} x {L}, the actor's engine build "
            f"{build_k1}, its prefill replays {replays_k1})")
        want_k1 = 2 * L + L * busy_forwards + build_k1 + replays_k1
        check(path_k1 == want_k1 and replays_k1 >= L * len(payloads),
              f"node 0 launched K1 {path_k1} times on the path, want "
              f"{want_k1} (prefill replays x {L}: {replays_k1})")
        expect = rt.get(server.forward_argmax.remote(
            [p["prompt"] for p in payloads], 32))
        out["check_launches"] = (rt.get(server.launches.remote())["flash_fwd"]
                                 - path_k1)
        steps = sum(min(len(e) + 1, 32) for e in expect)
        log(f"K1 launches of the actor's argmax check (not the path): "
            f"{out['check_launches']} ({steps} forwards x {L})")
        check(out["check_launches"] == L * steps,
              f"the argmax check launched K1 {out['check_launches']} times, "
              f"want {L * steps}")
        served = sum(a["usage"]["completion_tokens"] for a in answers)
        for i, (a, e) in enumerate(zip(answers, expect)):
            got = a["choices"][0]["logprobs"]["tokens"]
            check(len(got) >= 1 and got == e,
                  f"actor completion {i}: tokens {got} != K1 full-forward "
                  f"argmax {e}")
        out["actor_tok_s"] = served / serve_s
        log(f"[{card}] actor (LLMServer, f32, graphed; built in {actor_s:.2f} "
            f"s while a task ran forwards on the card): 16 concurrent greedy "
            f"completions, {served} tokens in {serve_s:.3f} s = "
            f"{out['actor_tok_s']:.1f} tok/s (phase 12 in-process: "
            f"{phase12_tok_s:.1f} tok/s); the task ran {busy_forwards} "
            "forwards beside them; every completion equals argmax over the "
            "full forward through K1")
        check(busy_forwards > 0, "the busy task ran no forward")
        rt.get(server.shutdown.remote())
        rt.kill(server)
        del params_ref

        # (d) the numbers
        @rt.remote
        def noop():
            return None

        @rt.remote
        class Echo:
            def ping(self):
                return None

        rt.get([noop.remote() for _ in range(100)])   # leases warm
        t0 = time.perf_counter()
        rt.get([noop.remote() for _ in range(1000)])
        out["tasks_per_s"] = 1000 / (time.perf_counter() - t0)
        echo = Echo.remote()
        rt.get([echo.ping.remote() for _ in range(100)])
        t0 = time.perf_counter()
        rt.get([echo.ping.remote() for _ in range(1000)])
        out["actor_calls_per_s"] = 1000 / (time.perf_counter() - t0)
        rt.kill(echo)
        for label, x in (
                ("f32 CPU", torch.randn(64 << 20,
                                        generator=torch.Generator().manual_seed(1))),
                ("bf16 CUDA (staged)", torch.randn(
                    128 << 20, device=dev).to(torch.bfloat16))):
            if x.is_cuda:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            ref = rt.put(x)
            t1 = time.perf_counter()
            object_hexes.append(ref.hex())
            y = rt.get(ref)
            if y.is_cuda:
                torch.cuda.synchronize()
            t2 = time.perf_counter()
            gb = x.numel() * x.element_size() / 1e9
            out[f"put_get_gb_s {label}"] = gb / (t2 - t0)
            log(f"[{card}] put + get of a {gb * 1e3 / 1.048576:.0f} MiB "
                f"{label} tensor: put {t1 - t0:.3f} s, get {t2 - t1:.3f} s, "
                f"{gb / (t2 - t0):.2f} GB/s; back on {y.device}")
            check(y.device == x.device and torch.equal(x, y),
                  f"{label} tensor changed through put/get")
            del ref, x, y
        t0 = time.perf_counter()
        rt._internal_cluster().add_node({"CPU": 1.0}, wait=True)
        out["spawn_s"] = time.perf_counter() - t0
        log(f"[{card}] runtime: init (head + 2 nodes) {out['init_s']:.2f} s; "
            f"a node spawned in {out['spawn_s']:.2f} s; 1,000 empty tasks "
            f"{out['tasks_per_s']:.0f}/s and 1,000 actor calls "
            f"{out['actor_calls_per_s']:.0f}/s (each 1,000 submitted, then "
            "one get)")
        if then is not None:
            out["then"] = then(gpu_nodes[0]["node_id"])
    finally:
        pids = [n.proc.pid for n in (*cluster.nodes, *cluster.warm)]
        port = cluster.gcs_addr[1]
        rt.shutdown()
    # (e) nothing of the session is left
    t_end = time.monotonic() + 15
    while time.monotonic() < t_end and any(
            session_leftovers(pids, port, object_hexes, renv_root)):
        time.sleep(0.2)
    left, segs = session_leftovers(pids, port, object_hexes, renv_root)
    log(f"after shutdown(): of the session's node processes {pids} and "
        f"runtime-env executor children {left} run; of its shm segments "
        f"(arena rt_arena_{port}_{os.getuid()}, rings rtring_<pid>_*, "
        f"{len(object_hexes)} objects) and venv build locks {segs} remain")
    check(not left and not segs, f"shutdown() left node processes or "
          f"executor children {left}, or shm segments or venv locks {segs}")
    shutil.rmtree(renv_root, ignore_errors=True)
    for var in ("RT_RUNTIME_ENV_DIR", "PIP_NO_INDEX"):
        os.environ.pop(var, None)
    return out


# Phase 17: runtime environments, the state API, ActorPool and Queue, in
# phase 14's session before the trainer. The helper that the runtime-env
# tasks run, shipped once as a py_modules package and once installed from
# a hand-rolled wheel into a venv (nothing is downloaded: pip runs with
# PIP_NO_INDEX and the wheel has no dependencies).
RUNTIME_ENV_PHASE_S = 90.0
PHASE17_PROMPTS = 8
PHASE17_HELPER = '''"""GPT-2 small's forward through K1 on the card, for chip_smoke.py's
phase 17."""


def forward(tree, tokens, cfg, device):
    """Logits of ``tokens`` under ``cfg`` (bf16 activations) from the
    parameter tree, the K1 launches of this forward in this process, and
    its milliseconds (synchronized)."""
    import time

    import torch

    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.ops import attention as attn

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = gpt2.GPT2(cfg, tree, device=device)
    tokens = tokens.to(device)
    before = attn.launches["flash_fwd"]
    t0 = time.perf_counter()
    with torch.no_grad():
        logits, _ = gpt2.forward(model, tokens, cfg)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    return logits, attn.launches["flash_fwd"] - before, ms
'''


def phase17_hook():
    """The runtime-env task's worker-process setup hook: counts its runs
    in the process's environment."""
    os.environ["RT_PHASE17_HOOK"] = str(
        int(os.environ.get("RT_PHASE17_HOOK", "0")) + 1)


def write_wheel(directory, name, body, version="0.1"):
    """A pure-Python wheel of one module ``name`` holding ``body``, built
    by hand (a zip with its dist-info)."""
    import zipfile

    whl = os.path.join(directory, f"{name}-{version}-py3-none-any.whl")
    dist = f"{name}-{version}.dist-info"
    with zipfile.ZipFile(whl, "w") as z:
        z.writestr(f"{name}/__init__.py", body)
        z.writestr(f"{dist}/METADATA", "Metadata-Version: 2.1\n"
                   f"Name: {name}\nVersion: {version}\n")
        z.writestr(f"{dist}/WHEEL", "Wheel-Version: 1.0\nGenerator: "
                   "chip_smoke\nRoot-Is-Purelib: true\nTag: py3-none-any\n")
        z.writestr(f"{dist}/RECORD", "")
    return whl


def runtime_env_phase(card, device, model_kw):
    """Phase 17, inside phase 14's session (``RT_RUNTIME_ENV_DIR`` set
    before its ``init``): GPT-2 small at full width and depth in bf16
    through K1 (B=2, T=256) from a task with ``env_vars``, ``working_dir``,
    ``py_modules`` and a setup hook, from a pip-venv task in the executor
    child, and from a 2-actor ``ActorPool``; then the state API,
    ``memory_summary`` and a ``Queue``. Returns its numbers and the K1
    launches of its path."""
    import shutil
    import tempfile

    import torch

    import ray_tpu_torch as rt
    from ray_tpu_torch.models import common, gpt2
    from ray_tpu_torch.util import state
    from ray_tpu_torch.util.actor_pool import ActorPool
    from ray_tpu_torch.util.queue import Queue

    t_phase = time.perf_counter()
    dev = torch.device(device)
    cfg = gpt2.GPT2Config(**model_kw, attention_impl="flash",
                          dtype=torch.bfloat16)
    L = cfg.num_layers
    out, launches = {}, {}
    work = tempfile.mkdtemp(prefix="phase17_")
    helper = os.path.join(work, "rt_phase17_helper")
    wd = os.path.join(work, "wd")
    for d in (helper, wd):
        os.makedirs(d)
    with open(os.path.join(helper, "__init__.py"), "w") as f:
        f.write(PHASE17_HELPER)
    wheel = write_wheel(work, "rt_phase17_wheel", PHASE17_HELPER)
    host = gpt2.init_params(cfg, torch.Generator().manual_seed(17), "cpu")
    with torch.no_grad():
        for n in GPT2_LIVELY:
            host["blocks"][n].mul_(3.0)
        host["wpe"].mul_(3.0)
    tree = {k: ({n: p.detach() for n, p in v.items()}
                if isinstance(v, dict) else v.detach())
            for k, v in common.param_tree(host).items()}
    params_ref = rt.put(tree)
    B, T = FORWARD_BATCH
    tokens = torch.randint(0, cfg.vocab_size, (B, T),
                           generator=torch.Generator().manual_seed(17))
    own_model = gpt2.GPT2(cfg, tree, device=dev)
    with torch.no_grad():
        own, _ = gpt2.forward(own_model, tokens.to(dev), cfg)
    try:
        # (1) a task with env_vars, working_dir, py_modules and a setup
        # hook, beside the same forward in a plain task
        renv = {"env_vars": {"RT_PHASE17": "on"}, "working_dir": wd,
                "py_modules": [helper],
                "worker_process_setup_hook": phase17_hook}

        @rt.remote(num_gpus=1, runtime_env=renv)
        def env_forward(tree, tokens, cfg, device):
            import os

            import rt_phase17_helper

            logits, k1, ms = rt_phase17_helper.forward(tree, tokens, cfg,
                                                       device)
            return (logits, k1, ms, os.environ.get("RT_PHASE17"),
                    os.getcwd(), os.environ.get("RT_PHASE17_HOOK"))

        @rt.remote(num_gpus=1)
        def plain_forward(tree, tokens, cfg, device):
            import time

            import torch

            from ray_tpu_torch.models import gpt2
            from ray_tpu_torch.ops import attention as attn

            model = gpt2.GPT2(cfg, tree, device=device)
            before = attn.launches["flash_fwd"]
            t0 = time.perf_counter()
            with torch.no_grad():
                logits, _ = gpt2.forward(model, tokens.to(device), cfg)
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            return (logits, attn.launches["flash_fwd"] - before,
                    (time.perf_counter() - t0) * 1e3)

        env_s, plain_s, k1_env = [], [], []
        for _ in range(2):
            t0 = time.perf_counter()
            got, k1, _, flag, cwd, hook = rt.get(env_forward.remote(
                params_ref, tokens, cfg, device))
            env_s.append(time.perf_counter() - t0)
            k1_env.append(k1)
            check(got.device == own.device and torch.equal(got, own),
                  f"the runtime-env task's logits ({got.device}) differ from "
                  "the driver's own forward through K1: "
                  f"{float((got.to(own.device) - own).abs().max()):.3e}")
            check(flag == "on" and os.path.realpath(cwd) ==
                  os.path.realpath(wd) and hook == "1",
                  f"the runtime-env task saw RT_PHASE17={flag!r}, cwd {cwd!r} "
                  f"(want {wd!r}), its hook ran {hook!r} times (want 1)")
            t0 = time.perf_counter()
            got, k1, _ = rt.get(plain_forward.remote(params_ref, tokens, cfg,
                                                     device))
            plain_s.append(time.perf_counter() - t0)
            k1_env.append(k1)
            check(torch.equal(got, own), "the plain task's logits differ "
                  "from the driver's own forward")
        check(k1_env == [L] * 4, f"the env and plain tasks launched K1 "
              f"{k1_env} times a forward, want {L}")
        launches["env"] = sum(k1_env)
        out["env_task_ms"], out["plain_task_ms"] = env_s[1] * 1e3, \
            plain_s[1] * 1e3
        log(f"[{card}] phase 17 runtime-env task (env_vars, working_dir, "
            f"py_modules, setup hook): bf16 logits bit-equal to the "
            f"driver's; env var seen, cwd the working_dir, the hook ran "
            f"once; round trip {out['env_task_ms']:.1f} ms warm (first "
            f"{env_s[0] * 1e3:.1f} ms) beside a plain task's "
            f"{out['plain_task_ms']:.1f} ms (first {plain_s[0] * 1e3:.1f} "
            "ms), each building the model from the put parameters")

        # (2) a pip-venv task: the forward in the executor child
        @rt.remote(num_gpus=1, runtime_env={"pip": [wheel]})
        def venv_forward(tree, tokens, cfg, device):
            import os
            import sys

            import torch

            import ray_tpu_torch
            import rt_phase17_wheel

            logits, k1, ms = rt_phase17_wheel.forward(tree, tokens, cfg,
                                                      device)
            host_logits = logits.cpu()
            del logits
            torch.cuda.empty_cache()
            return (host_logits, k1, ms, os.getpid(), sys.executable,
                    ray_tpu_torch.__name__,
                    os.environ.get("CUDA_VISIBLE_DEVICES"))

        calls = []
        for _ in range(2):
            t0 = time.perf_counter()
            res = rt.get(venv_forward.remote(params_ref, tokens, cfg, device))
            calls.append((time.perf_counter() - t0, res))
        own_host = own.cpu()
        k1_child = []
        for s, (got, k1, ms, pid, exe, _, cvd) in calls:
            check(got.device.type == "cpu" and torch.equal(got, own_host),
                  "the pip-venv child's logits differ from the driver's own "
                  f"forward: {float((got - own_host).abs().max()):.3e}")
            check(exe != sys.executable and pid != os.getpid(),
                  f"the pip-venv task ran in {exe} (pid {pid}), not a venv "
                  "child")
            k1_child.append(k1)
        check(k1_child == [L, L], f"the pip-venv child launched K1 "
              f"{k1_child} times a forward, want exactly {L}")
        check(calls[0][1][3] == calls[1][1][3], "the second pip-venv call "
              "did not reuse the cached venv's child")
        launches["venv_child"] = sum(k1_child)
        out["venv_cold_s"], out["venv_warm_s"] = calls[0][0], calls[1][0]
        out["child_forward_ms"] = calls[1][1][2]
        # the build alone, from its files' times: ensure_venv opens the
        # venv's lock file first (venv_root/.<key>.lock, never written)
        # and writes the ready marker last
        venv_dir = os.path.dirname(os.path.dirname(calls[0][1][4]))
        lock = os.path.join(os.path.dirname(venv_dir),
                            f".{os.path.basename(venv_dir)}.lock")
        out["venv_build_s"] = (
            os.path.getmtime(os.path.join(venv_dir, ".rt_ready"))
            - os.path.getmtime(lock))
        log(f"[{card}] phase 17 pip-venv task (executor child {calls[0][1][3]}"
            f" of {calls[0][1][4]}, CUDA_VISIBLE_DEVICES="
            f"{calls[0][1][6]!r}): logits bit-equal to the driver's, K1 "
            f"{k1_child} launches counted in the child; first call "
            f"{out['venv_cold_s']:.2f} s (of it the venv build, python -m "
            f"venv and pip, {out['venv_build_s']:.2f} s), second "
            f"{out['venv_warm_s']:.2f} s; the child's forward "
            f"{out['child_forward_ms']:.2f} ms")

        # (3) an ActorPool of two num_gpus=0.5 actors holding the model
        @rt.remote(num_gpus=0.5)
        class PoolWorker:
            def __init__(self, tree, cfg, device):
                import torch

                from ray_tpu_torch.models import gpt2

                torch.backends.cuda.matmul.allow_tf32 = False
                self.model = gpt2.GPT2(cfg, tree, device=device)
                self.cfg, self.device = cfg, device

            def argmax(self, tokens):
                import torch

                from ray_tpu_torch.models import gpt2

                with torch.no_grad():
                    logits, _ = gpt2.forward(
                        self.model, tokens.to(self.device), self.cfg)
                return logits.argmax(-1).cpu()

            def launches(self, reset=False):
                import os

                from ray_tpu_torch.ops import attention as attn

                n = attn.launches["flash_fwd"]
                if reset:
                    attn.launches["flash_fwd"] = 0
                return os.getpid(), n

        prompts = [torch.randint(0, cfg.vocab_size, (1, T),
                                 generator=torch.Generator().manual_seed(
                                     170 + i))
                   for i in range(PHASE17_PROMPTS)]
        actors = [PoolWorker.remote(params_ref, cfg, device) for _ in range(2)]
        try:
            rt.get([a.launches.remote(True) for a in actors])
            pool = ActorPool(actors)
            t0 = time.perf_counter()
            answers = list(pool.map(lambda a, p: a.argmax.remote(p), prompts))
            pool_s = time.perf_counter() - t0
            counts = dict(rt.get([a.launches.remote() for a in actors]))
            listed = state.list_actors(filters=[("class_name", "=",
                                                 "PoolWorker"),
                                                ("state", "=", "ALIVE")])
        finally:
            for a in actors:
                rt.kill(a)
        with torch.no_grad():
            for i, (p, got) in enumerate(zip(prompts, answers)):
                want = gpt2.forward(own_model, p.to(dev), cfg)[0].argmax(-1)
                check(torch.equal(got, want.cpu()),
                      f"pool answer {i} differs from the driver's argmax")
        launches["pool"] = sum(counts.values())
        check(launches["pool"] == L * PHASE17_PROMPTS,
              f"the pool's actors launched K1 {counts} (by process), want "
              f"{L} x {PHASE17_PROMPTS} in all")
        out["pool_prompts_per_s"] = PHASE17_PROMPTS / pool_s
        log(f"[{card}] phase 17 ActorPool (2 num_gpus=0.5 actors): "
            f"{PHASE17_PROMPTS} prompts (B=1, T={T}) in order and equal to "
            f"the driver's argmax, {out['pool_prompts_per_s']:.1f} prompts/s;"
            f" K1 launches by process {counts}")

        # (4) the state API, memory_summary and a Queue
        names = ("env_forward", "plain_forward", "venv_forward")
        t_end = time.monotonic() + 20
        while True:
            summary = state.summarize_tasks()["cluster"]["summary"]
            finished = {n: summary.get(n, {}).get("state_counts", {}).get(
                "FINISHED", 0) for n in names}
            if all(v == 2 for v in finished.values()) \
                    or time.monotonic() > t_end:
                break
            time.sleep(0.2)
        rows = state.list_tasks(filters=[("state", "=", "FINISHED")],
                                limit=100_000)
        listed_tasks = {n: sum(r.get("name") == n for r in rows)
                        for n in names}
        check(finished == dict.fromkeys(names, 2) and listed_tasks == finished,
              f"the state API shows the phase's tasks finished "
              f"{finished} (list_tasks {listed_tasks}), want 2 each")
        check(len(listed) == 2, f"list_actors shows {len(listed)} pooled "
              "actors alive, want 2")
        mem = state.memory_summary()
        check(any(r["oid"] == params_ref.hex() for r in mem["rows"]),
              "memory_summary does not list the parameters' object")

        @rt.remote(num_cpus=0)
        def produce(q, items):
            for x in items:
                q.put(x, timeout=60)
            return len(items)

        q = Queue(maxsize=2)
        try:
            done = produce.remote(q, prompts)
            carried = [q.get(timeout=60) for _ in prompts]
            check(rt.get(done, timeout=60) == len(prompts) and all(
                torch.equal(a, b) for a, b in zip(carried, prompts)),
                "the Queue did not carry the prompts in order")
        finally:
            q.shutdown()
        log(f"phase 17 state API: summarize_tasks/list_tasks FINISHED "
            f"{finished}, list_actors 2 PoolWorker ALIVE, memory_summary "
            f"lists the parameters' object ({mem['totals']['objects']} "
            f"objects); a Queue of maxsize 2 carried {len(prompts)} prompts "
            "from a task in order")
    finally:
        shutil.rmtree(work, ignore_errors=True)
        del own_model
    out["launches"] = launches
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[{card}] phase 17: {out['phase_s']:.1f} s (limit "
        f"{RUNTIME_ENV_PHASE_S:g}); K1 launches on its path {launches}")
    check(out["phase_s"] <= RUNTIME_ENV_PHASE_S,
          f"phase 17 took {out['phase_s']:.1f} s")
    return out


# Phase 16: Serve on the card, in a session of its own. Its arenas hold
# requests, responses and the PD app's transferred KV state (~75 MB a
# request at GPT-2 small's 1024 positions in f32), never the weights, which
# the replicas read from phase 12's bundle on disk.
SERVE_ARENA_BYTES = 512 << 20
SERVE_PHASE_S = 150.0


def write_bundle(params, path):
    """``params`` (a GPT-2 module or tree of tensors) as a ``model_source``
    bundle: the JAX package's tree of numpy arrays, which the engine loads
    through ``convert.params_from_numpy``."""
    import pickle

    from ray_tpu_torch.models import common

    tree = {k: ({n: p.detach().cpu().numpy() for n, p in v.items()}
                if isinstance(v, dict) else v.detach().cpu().numpy())
            for k, v in common.param_tree(params).items()}
    with open(path, "wb") as f:
        pickle.dump({"params": tree}, f, protocol=pickle.HIGHEST_PROTOCOL)


def http_json(port, path, payload, timeout=300):
    import urllib.request

    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.headers.get("Content-Type", ""), r.read().decode()


def serve_phase(card, device, cfg_dict, ref, phase12_tok_s, phase14_tok_s):
    """Phase 16: ``serve_llm`` deploys the OpenAI app (GPT-2 small, f32, the
    weights of phase 12 from ``ref["model_source"]``) on one replica that
    holds node 0's ``GPU``; requests arrive through the HTTP proxy (16
    mixed completions at once and a stream) and a ``DeploymentHandle``.
    Greedy answers equal phase 12's in-process ``LLMServer``'s (``ref``).
    Then ``build_pd_openai_app``: a prefill and a decode replica at
    ``num_gpus=0.5`` each on the card, whose greedy answer equals the
    monolithic app's. K1 is counted in node 0's process, where the replicas
    run: it is set to 0 there once each app is ready and read after its
    requests, which launch it L times a prefill replay. After
    ``serve.shutdown()`` and ``shutdown()`` no process of the session is
    left."""
    import dataclasses

    import ray_tpu_torch as rt
    from ray_tpu_torch import serve
    from ray_tpu_torch.llm import LLMConfig, build_pd_openai_app, serve_llm
    from ray_tpu_torch.util.scheduling_strategies import (
        NodeAffinitySchedulingStrategy as Pin,
    )

    t_phase = time.perf_counter()
    os.environ["PYTHONPATH"] = os.pathsep.join(
        p for p in (HERE, os.environ.get("PYTHONPATH")) if p)
    saved = os.environ.get("RT_ARENA_BYTES")
    os.environ["RT_ARENA_BYTES"] = str(SERVE_ARENA_BYTES)
    out = {}
    config = LLMConfig.from_dict(dict(cfg_dict, model_source=ref["model_source"]))
    try:
        # each replica, proxy and controller holds a CPU while it lives
        rt.init(num_cpus=8, num_nodes=2)
    finally:
        if saved is None:
            os.environ.pop("RT_ARENA_BYTES", None)
        else:
            os.environ["RT_ARENA_BYTES"] = saved
    cluster = rt._internal_cluster()
    try:
        gpu_nodes = [n["node_id"] for n in rt.nodes()
                     if n["alive"] and n["resources"].get("GPU")]
        check(len(gpu_nodes) == 1, f"GPU nodes {gpu_nodes}")

        @rt.remote
        def card_counts(reset):
            """K1's count in this node's process (set to 0 first when
            ``reset``), the prefill replays of each engine alive there
            (after a collection: none is kept only by a cycle), and the
            device memory allocated there."""
            import gc

            import torch

            from ray_tpu_torch.llm.engine import DecodeEngine
            from ray_tpu_torch.ops import attention as attn

            if reset:
                for name in attn.launches:
                    attn.launches[name] = 0
            gc.collect()
            engines = [o for o in gc.get_objects()
                       if type(o) is DecodeEngine]
            return dict(attn.launches), [
                {"device": str(e.device),
                 "prefill": sum(p.replays for p in e._prefill.values()),
                 "decode": e._decode.replays} for e in engines
            ], torch.cuda.memory_allocated()

        # no CPU: the replicas, the proxy and the controller may hold them all
        on_card = card_counts.options(
            num_cpus=0, scheduling_strategy=Pin(gpu_nodes[0]))
        _, _, mem0 = rt.get(on_card.remote(True), timeout=60)
        L = config.model_config().num_layers

        def ready_counts():
            """Set K1's count in node 0's process to 0 once an app is
            ready; its engines' prefill replays so far."""
            _, engines, _ = rt.get(on_card.remote(True), timeout=60)
            return sum(e["prefill"] for e in engines)

        def served_k1(what, at_ready, n_engines):
            """K1's launches in node 0's process since the app was ready:
            exactly L a prefill replay of its engines since then, which the
            requests caused."""
            counts, engines, mem = rt.get(on_card.remote(False), timeout=60)
            replays = sum(e["prefill"] for e in engines) - at_ready
            log(f"K1 launches in node 0's process (the replicas') on the "
                f"{what}'s requests: {counts['flash_fwd']} ({replays} prefill "
                f"replays x {L}); its engines {engines}, "
                f"{mem / 1e9:.3f} GB allocated")
            check(len(engines) == n_engines and all(
                e["device"].startswith("cuda") for e in engines),
                f"the {what}'s engines in node 0's process: {engines}")
            check(replays > 0 and counts["flash_fwd"] == L * replays,
                  f"the {what}'s requests launched K1 {counts['flash_fwd']} "
                  f"times in the replicas' process, want {L} x {replays} "
                  "prefill replays")
            return counts["flash_fwd"], replays

        # (a) the monolithic app through serve_llm: one replica on the card
        mono = dataclasses.replace(config, deployment_config={
            "ray_actor_options": {"num_gpus": 1}})
        t0 = time.perf_counter()
        handle = serve_llm(mono, device=device)
        out["ready_s"] = time.perf_counter() - t0
        st = serve.status()
        check(st.get("LLMServer", {}).get("running") == 1,
              f"serve_llm's replica is not running: {st}")
        port = serve.start_http_proxy(port=0)
        log(f"[{card}] serve_llm: replica ready {out['ready_s']:.2f} s after "
            f"serve.run; HTTP proxy on port {port}")
        at_ready = ready_counts()

        payloads, answers = ref["mixed"]
        with ThreadPoolExecutor(len(payloads)) as pool:
            t0 = time.perf_counter()
            got = list(pool.map(
                lambda p: json.loads(http_json(port, "/v1/completions", p)[1]),
                payloads))
            http_s = time.perf_counter() - t0
        tokens = sum(a["usage"]["completion_tokens"] for a in got)
        out["http_tok_s"] = tokens / http_s
        greedy = [i for i, p in enumerate(payloads) if "temperature" not in p]
        seeded = [i for i, p in enumerate(payloads) if "seed" in p]
        for i in greedy:
            check(got[i]["choices"] == answers[i]["choices"]
                  and got[i]["usage"] == answers[i]["usage"],
                  f"HTTP greedy completion {i}: {got[i]['choices']} != "
                  f"phase 12's in-process {answers[i]['choices']}")
        same_seeded = sum(got[i]["choices"] == answers[i]["choices"]
                          for i in seeded)
        log(f"[{card}] Serve over HTTP: 16 concurrent completions, {tokens} "
            f"tokens in {http_s:.3f} s = {out['http_tok_s']:.1f} tok/s "
            f"(phase 12 in-process: {phase12_tok_s:.1f} tok/s; phase 14's "
            f"actor: {phase14_tok_s:.1f} tok/s); the {len(greedy)} greedy "
            "ones equal phase 12's in-process answers, the seeded top-k ones "
            f"{same_seeded} of {len(seeded)}")

        payload, streamed = ref["stream"]
        ctype, body = http_json(port, "/v1/completions",
                                dict(payload, stream=True))
        lines = [ln + "\n\n" for ln in body.split("\n\n") if ln]
        joined = "".join(json.loads(ln[len("data: "):])["choices"][0]["text"]
                         for ln in lines[:-1])
        log(f"Serve stream over HTTP ({ctype}): {len(lines) - 1} chunks, "
            f"joined {joined!r}")
        check(ctype.startswith("text/event-stream")
              and lines[-1] == "data: [DONE]\n\n" and joined == streamed,
              f"HTTP stream {joined!r} != phase 12's stream {streamed!r}")

        payload, want, text = ref["single"]
        resp = handle.remote(payload).result(timeout=300)
        mono_tokens = resp["choices"][0]["logprobs"]["tokens"]
        log(f"Serve handle completion {resp['choices'][0]['text']!r}, tokens "
            f"{mono_tokens}")
        check(mono_tokens == want and resp["choices"][0]["text"] == text,
              f"handle completion tokens {mono_tokens} != phase 12's {want}")

        mono_k1, replays = served_k1("monolithic app", at_ready, 1)
        check(replays >= len(payloads) + 2, f"{replays} prefill replays for "
              f"{len(payloads) + 2} requests")

        # (b) the PD app: a prefill and a decode replica on the one card,
        # once the monolithic replica has stopped and let go of its engine
        serve.delete("llm")
        t_end = time.monotonic() + 30
        while True:
            _, engines, mem = rt.get(on_card.remote(False), timeout=60)
            if not engines or time.monotonic() > t_end:
                break
            time.sleep(0.5)
        log(f"after serve.delete('llm'): engines in node 0's process "
            f"{engines}; {mem / 1e9:.3f} GB allocated there (before "
            f"serve_llm: {mem0 / 1e9:.3f} GB)")
        check(not engines, f"the deleted replica's engine lives on: {engines}")
        pd = dataclasses.replace(config, deployment_config={
            "ray_actor_options": {"num_gpus": 0.5}})
        t0 = time.perf_counter()
        try:
            pd_handle = serve.run(build_pd_openai_app(pd, device=device),
                                  name="pd", route_prefix="/pd")
            st = serve.status()
            out["pd_ready_s"] = time.perf_counter() - t0
            check(all(st.get(n, {}).get("running") == 1
                      for n in ("pd_prefill", "pd_decode", "pd_ingress")),
                  f"the PD app's replicas are not running: {st}")
            at_ready = ready_counts()
            split = pd_handle.remote(payload).result(timeout=300)
        except Exception as e:
            raise SmokeFailure(f"the PD app with two num_gpus=0.5 replicas "
                               f"on one card failed: {type(e).__name__}: {e}")
        log(f"[{card}] PD app ready in {out['pd_ready_s']:.2f} s: "
            f"{split['choices'][0]['text']!r}, tokens "
            f"{split['choices'][0]['logprobs']['tokens']}")
        check(split.get("disaggregated") is True
              and split["choices"] == resp["choices"]
              and split["usage"] == resp["usage"],
              f"the PD app's answer {split} != the monolithic app's {resp}")
        pd_k1, _ = served_k1("PD app", at_ready, 2)
        out["launches"] = mono_k1 + pd_k1
    finally:
        pids = [n.proc.pid for n in (*cluster.nodes, *cluster.warm)]
        head_port = cluster.gcs_addr[1]
        try:
            serve.shutdown()
        finally:
            rt.shutdown()
    t_end = time.monotonic() + 15
    while time.monotonic() < t_end and any(
            session_leftovers(pids, head_port, [])):
        time.sleep(0.2)
    left, segs = session_leftovers(pids, head_port, [])
    log(f"after serve.shutdown() and shutdown(): of the session's node "
        f"processes {pids} {left} run; of its shm segments {segs} remain")
    check(not left and not segs, f"Serve's session left node processes "
          f"{left} or shm segments {segs}")
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[{card}] phase 16: {out['phase_s']:.1f} s (limit {SERVE_PHASE_S:g})")
    check(out["phase_s"] <= SERVE_PHASE_S,
          f"phase 16 took {out['phase_s']:.1f} s")
    return out


# Phase 15: GPT-2 small trained by SPMDTrainer's default loop on a worker
# that holds the card: 8 steps, a checkpoint every 4, the first attempt
# failing once after step 4's checkpoint, with phase 5's optimizer.
TRAINER_STEPS = 8
TRAINER_CKPT_EVERY = 4
TRAINER_DATA_SEED = 15
# The optimizer of every training phase.
TRAIN_OPTIMIZER = dict(learning_rate=1e-3, warmup_steps=2, total_steps=20)


def ddp_body(device):
    """A few AdamW steps of a small MLP through ``prepare_model`` on
    seeded data: DDP inside a process group, the model itself outside one.
    Returns the final parameters on the CPU and the model's class name."""
    import torch

    from ray_tpu_torch.train.torch import prepare_model

    torch.manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Linear(512, 1024), torch.nn.GELU(),
                                torch.nn.Linear(1024, 512)).to(device)
    model = prepare_model(model)
    opt = torch.optim.AdamW(model.parameters(), lr=1e-3)
    data = torch.Generator().manual_seed(1)
    for _ in range(5):
        x = torch.randn(64, 512, generator=data).to(device)
        loss = model(x).pow(2).mean()
        opt.zero_grad()
        loss.backward()
        opt.step()
    return [p.detach().cpu() for p in model.parameters()], type(model).__name__


def fail_once_after_checkpoint(config):
    """``default_train_loop`` that raises once, just after the checkpoint of
    step ``config["fail_after"]`` is reported (a marker file guards the
    once), and that adds to the metrics reported with each checkpoint its
    ``save_pytree`` seconds and the worker's process group (backend, world
    size)."""
    import os
    import time

    import torch

    from ray_tpu_torch import train
    from ray_tpu_torch.train import checkpoint as ckpt_mod

    ctx = train.get_context()
    report, save = ctx.report, ckpt_mod.save_pytree
    saves = []

    def timed_save(state, path):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        t = time.perf_counter()
        save(state, path)
        saves.append(time.perf_counter() - t)

    def report_then_fail(metrics, checkpoint=None):
        if checkpoint is not None:
            grouped = torch.distributed.is_initialized()
            metrics = dict(metrics, checkpoint_save_s=saves[-1], group=(
                grouped and torch.distributed.get_backend(),
                grouped and torch.distributed.get_world_size()))
        report(metrics, checkpoint)
        if (checkpoint is not None and metrics["step"] == config["fail_after"]
                and not os.path.exists(config["marker"])):
            open(config["marker"], "w").close()
            raise RuntimeError(f"injected failure after step "
                               f"{metrics['step']}'s checkpoint")

    ctx.report = report_then_fail
    ckpt_mod.save_pytree = timed_save
    try:
        return train.default_train_loop(config)
    finally:
        ckpt_mod.save_pytree = save


def trainer_phase(card, device, node_id, model_kw, batch_shape,
                  reference_loss, phase5):
    """Phase 15, inside phase 14's session: ``SPMDTrainer`` trains GPT-2
    small on a worker actor that holds the card (node ``node_id``, the
    node of the card), under an NCCL world of one, through
    ``fail_once_after_checkpoint`` with ``FailureConfig(max_failures=1)``;
    then a ``TorchTrainer`` DDP loop on the card against the same loop
    without the trainer. ``reference_loss(tokens)`` is the first loss of
    phase 5's compiled step on the seeded state; ``phase5`` its ms a step.
    Returns the numbers and the kernels' launches in the worker's
    process."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    import ray_tpu_torch as rt
    from ray_tpu_torch.models.convert import config_from_kwargs
    from ray_tpu_torch.train import (
        FailureConfig,
        OptimizerConfig,
        RunConfig,
        ScalingConfig,
        SPMDTrainer,
        create_train_state,
        load_pytree,
    )
    from ray_tpu_torch.train.torch import TorchTrainer
    from ray_tpu_torch.util.scheduling_strategies import (
        NodeAffinitySchedulingStrategy as Pin,
    )

    t_phase = time.perf_counter()
    dev = torch.device(device)
    on_gpu = dev.type == "cuda"
    B, T = batch_shape
    model = dict(model_kw, family="gpt2", attention_impl="flash", remat=True,
                 remat_policy="dots")
    kw = dict(model)
    cfg = config_from_kwargs(kw, kw.pop("family"))
    L = cfg.num_layers
    out = {}

    # the driver's reference: the loop's first batch through phase 5's
    # compiled step on the seeded state
    toks = np.random.default_rng(TRAINER_DATA_SEED).integers(
        0, cfg.vocab_size, (B, T + 1), dtype=np.int32)
    ref_loss = reference_loss(torch.from_numpy(toks).to(dev, torch.long))
    gc.collect()
    if on_gpu:
        torch.cuda.empty_cache()

    @rt.remote
    def node_state(reset):
        """The launch counts, peak memory and Inductor's FX graph cache
        counters of this node's process; ``reset`` sets the first two to
        0 first."""
        import torch

        from ray_tpu_torch.ops import attention as attn

        if reset:
            for name in attn.launches:
                attn.launches[name] = 0
            if torch.cuda.is_available():
                torch.cuda.reset_peak_memory_stats()
        counters = torch._dynamo.utils.counters["inductor"]
        return {"launches": dict(attn.launches),
                "peak_gb": (torch.cuda.max_memory_allocated() / 1e9
                            if torch.cuda.is_available() else 0.0),
                "fx_hit": counters["fxgraph_cache_hit"],
                "fx_miss": counters["fxgraph_cache_miss"]}

    on_card = node_state.options(scheduling_strategy=Pin(node_id))
    root = tempfile.mkdtemp(prefix="phase15_")
    try:
        before = rt.get(on_card.remote(True))
        t0 = time.perf_counter()
        result = SPMDTrainer(
            fail_once_after_checkpoint,
            train_loop_config=dict(
                model=model, optimizer=TRAIN_OPTIMIZER,
                num_steps=TRAINER_STEPS, checkpoint_every=TRAINER_CKPT_EVERY,
                batch_size=B, seq_len=T, data_seed=TRAINER_DATA_SEED,
                device=device, fail_after=TRAINER_CKPT_EVERY,
                marker=os.path.join(root, "failed_once")),
            scaling_config=ScalingConfig(num_workers=1, use_gpu=on_gpu),
            run_config=RunConfig(name="gpt2-small", storage_path=root,
                                 failure_config=FailureConfig(max_failures=1)),
        ).fit()
        out["fit_s"] = time.perf_counter() - t0
        after = rt.get(on_card.remote(False))
        out["launches"] = after["launches"]
        history = result.metrics_history
        steps = [m["step"] for m in history]
        losses = [m["loss"] for m in history]
        log(f"[{card}] trainer (SPMDTrainer, GPT-2 small L={L} B={B} T={T} "
            f"bf16/f32 remat dots, 1 GPU worker, NCCL world of 1): steps "
            f"{steps}, losses " + " ".join(f"{x:.4f}" for x in losses)
            + f"; launches in the worker's process {out['launches']}")
        check(result.metrics.get("step") == TRAINER_STEPS,
              f"the trainer's result is at step {result.metrics.get('step')}, "
              f"want {TRAINER_STEPS}")
        check(steps == list(range(1, TRAINER_STEPS + 1)),
              f"reported steps {steps}: the second attempt did not resume "
              f"at step {TRAINER_CKPT_EVERY}")
        check(os.path.exists(os.path.join(root, "failed_once")),
              "the first attempt did not fail")
        groups = [tuple(m["group"]) for m in history if "group" in m]
        log(f"the worker's process group at each checkpoint: {groups}")
        check(groups == [("nccl" if on_gpu else False,
                          1 if on_gpu else False)] * 2,
              f"the worker's process groups {groups}, want NCCL of 1")
        check(all(math.isfinite(x) for x in losses), f"losses {losses}")
        want = {"flash_fwd": 0, "flash_fwd_lse": L * TRAINER_STEPS,
                "flash_bwd_dkv": L * TRAINER_STEPS,
                "flash_bwd_dq": L * TRAINER_STEPS}
        check(out["launches"] == want, f"launches in the worker's process "
              f"{out['launches']}, want {want} ({L} a step, "
              f"{TRAINER_STEPS} steps run)")
        rel = abs(losses[0] - ref_loss) / abs(ref_loss)
        log(f"trainer's first loss {losses[0]:.6f}, phase 5's compiled step "
            f"in the driver on the same seed and batch {ref_loss:.6f}: rel "
            f"{rel:.3e} (bound 2e-3)")
        check(rel <= 2e-3, f"the trainer's first loss {losses[0]} against "
              f"the driver's {ref_loss}: rel {rel:.3e} > 2e-3")

        # the numbers: steps after each attempt's first, which compiles
        first = {m["step"]: B * T / m["tokens_per_sec"] for m in history
                 if m["step"] in (1, TRAINER_CKPT_EVERY + 1)}
        rest = [B * T / m["tokens_per_sec"] * 1e3 for m in history
                if m["step"] not in first]
        out["step_ms"] = float(np.median(rest))
        out["tok_s"] = B * T / out["step_ms"] * 1e3
        out["first_step_s"] = first
        out["peak_gb"] = after["peak_gb"]
        out["fx_cache"] = (after["fx_hit"] - before["fx_hit"],
                           after["fx_miss"] - before["fx_miss"])
        saves = {m["step"]: m["checkpoint_save_s"] for m in history
                 if "checkpoint_save_s" in m}
        ckpt = result.checkpoint.path
        nbytes = sum(os.path.getsize(os.path.join(d, f))
                     for d, _, files in os.walk(ckpt) for f in files)
        opt = OptimizerConfig(**TRAIN_OPTIMIZER).build()
        state = create_train_state(cfg, opt, torch.Generator().manual_seed(0),
                                   dev)
        init = [p.detach().clone() for p in state["params"].parameters()]
        if on_gpu:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = load_pytree(ckpt, target=state)
        if on_gpu:
            torch.cuda.synchronize()
        out["load_s"] = time.perf_counter() - t0
        moved = sum(not torch.equal(a, p) for a, p in
                    zip(init, state["params"].parameters()))
        on_dev = {p.device.type for p in state["params"].parameters()}
        log(f"final checkpoint {os.path.basename(ckpt)}: {nbytes / 1e9:.3f} "
            f"GB; loaded in the driver on {on_dev} in {out['load_s']:.3f} s at "
            f"step {state['step']}; {moved} of {len(init)} parameters moved "
            "from the seeded init")
        check(state["step"] == TRAINER_STEPS and on_dev == {dev.type}
              and moved == len(init),
              f"the final checkpoint loaded at step {state['step']} on "
              f"{on_dev}, {moved} of {len(init)} parameters trained")
        out["ckpt_gb"] = nbytes / 1e9
        out["save_s"] = saves
        del state, init
        gc.collect()
        if on_gpu:
            torch.cuda.empty_cache()
        log(f"[{card}] trainer: {out['step_ms']:.2f} ms a step after each "
            f"attempt's first ({out['tok_s']:.0f} tokens/s; phase 5's "
            f"in-process compiled step {phase5:.2f} ms, "
            f"{B * T / phase5 * 1e3:.0f} tokens/s); first steps (compiling) "
            + ", ".join(f"step {k} {v:.1f} s" for k, v in first.items())
            + f"; Inductor's FX graph cache in the worker's process: "
            f"{out['fx_cache'][0]} hits, {out['fx_cache'][1]} misses "
            f"(on-disk cache of phase 5 {'served' if out['fx_cache'][0] else 'did not serve'} "
            f"the worker); checkpoint save (save_pytree) "
            + ", ".join(f"step {k} {v:.2f} s" for k, v in saves.items())
            + f", load {out['load_s']:.2f} s, {out['ckpt_gb']:.3f} GB; the "
            f"worker's peak memory {out['peak_gb']:.2f} GB; fit "
            f"{out['fit_s']:.1f} s")

        # TorchTrainer: DDP on NCCL, a world of one on the card, against the
        # same loop without the trainer
        def ddp_loop(config):
            import torch.distributed as dist

            from ray_tpu_torch import train

            params, kind = ddp_body(config["device"])
            grouped = dist.is_initialized()
            train.report({"params": [p.numpy() for p in params],
                          "backend": grouped and dist.get_backend(),
                          "world": grouped and dist.get_world_size(),
                          "model": kind})

        t0 = time.perf_counter()
        ddp = TorchTrainer(
            ddp_loop, train_loop_config={"device": device},
            scaling_config=ScalingConfig(num_workers=1, use_gpu=on_gpu),
            run_config=RunConfig(name="ddp", storage_path=root)).fit().metrics
        out["ddp_s"] = time.perf_counter() - t0
        plain, kind = ddp_body(device)
        equal = [np.array_equal(a, b.numpy()) for a, b in zip(ddp["params"], plain)]
        log(f"TorchTrainer on the card: {ddp['model']} on {ddp['backend']} "
            f"world {ddp['world']}, {out['ddp_s']:.1f} s; final parameters "
            f"bit-equal to the loop without the trainer ({kind}): {equal}")
        check(ddp["backend"] == "nccl" and ddp["world"] == 1
              and ddp["model"] == "DistributedDataParallel"
              and len(equal) == len(plain) and all(equal),
              f"TorchTrainer DDP: {ddp['backend']} world {ddp['world']} "
              f"{ddp['model']}, parameters equal {equal}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[{card}] phase 15: {out['phase_s']:.1f} s")
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "ray_tpu_torch")):
        print("chip_smoke: ray_tpu_torch/ is not beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    # Inductor's and Triton's compile caches inside the checkout (gitignored)
    for var, leaf in (("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                      ("TRITON_CACHE_DIR", "triton")):
        os.environ.setdefault(var, os.path.join(HERE, ".compile_cache", leaf))

    import numpy as np
    import torch.nn.functional as F

    from ray_tpu_torch._private.device import card_info
    from ray_tpu_torch.llm import (
        DecodeEngine,
        LLMConfig,
        LLMServer,
        SamplingParams,
    )
    from ray_tpu_torch.llm.batch import _EngineStage
    from ray_tpu_torch.llm.serving_patterns import (
        DecodeServer,
        PDIngress,
        PrefillServer,
    )
    from ray_tpu_torch.models import get_preset, gpt2, llama
    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.ops import attention as attn
    import torch.distributed as dist

    from ray_tpu_torch.parallel.mesh import single_device_mesh
    from ray_tpu_torch.parallel.moe import MoEConfig
    from ray_tpu_torch.train import (
        OptimizerConfig,
        create_train_state,
        make_eval_step,
        make_train_step,
    )
    from ray_tpu_torch.train import step as step_mod

    dev = torch.device(DEVICE)
    t_start = time.perf_counter()

    def phase_done(n):
        log(f"phase {n} done at {time.perf_counter() - t_start:.1f} s")

    # ---------------------------------------------------- 1. card, toolchain
    card = card_info()
    check(torch.cuda.device_count() >= 1, "no CUDA device")
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device {torch.cuda.get_device_name(0)}")
    # the compiled train and eval steps generate their fused kernels with
    # Triton (Inductor); without it they raise, and nothing falls back
    import triton
    log(f"triton {triton.__version__}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # the runtime core's wire and function transport, and its toolchain
    import cloudpickle
    import msgpack

    tools = {t: subprocess.run([t, "--version"], capture_output=True,
                               text=True).stdout.splitlines()[0]
             for t in ("g++", "make")}
    log(f"msgpack {'.'.join(map(str, msgpack.version))}, cloudpickle "
        f"{cloudpickle.__version__}, {tools['g++']}, {tools['make']}")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:   # g++ beside nvcc
        native_fut = pool.submit(build_native)
        built = _build.build_all()
        native_loaded, native_failure = native_fut.result()
    build_s = time.perf_counter() - t0
    log(f"build: {build_s:.2f} s ({', '.join(f'{k} {v:.2f} s' for k, v in built.items())})")
    log(f"native libraries (ray_tpu_torch/native/_build): {native_loaded}")
    check(native_failure is None and all(native_loaded.values()),
          f"a native library did not build or load: {native_loaded}\n"
          f"{native_failure}")
    cuobjdump = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    instances = dict.fromkeys(HOPPER_KERNELS, 0)
    for name in built:
        with open(_build.lib_path(name) + ".log") as f:
            for line in f:
                if "registers" in line or "spill" in line:
                    log(f"  ptxas {name}: {line.strip()}")
                m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
                check(m is None or m.groups() == ("0", "0"),
                      f"ptxas {name}: {line.strip()}")
        for func, ops in sass_counts(_build.lib_path(name), cuobjdump).items():
            for key, (label, _) in HOPPER_KERNELS.items():
                if key in func:
                    instances[key] += 1
                    log(f"  sass {label} {func}: HGMMA {ops['HGMMA']}, "
                        f"UTMALDG {ops['UTMALDG']}")
                    check(ops["HGMMA"] > 0 and ops["UTMALDG"] > 0,
                          f"{func}: no wgmma or no TMA load in its SASS")
    for key, (label, want) in HOPPER_KERNELS.items():
        check(instances[key] == want, f"{label}: {instances[key]} instances of "
              f"{key} in the SASS, want {want}")

    # ------------------------------------------- 2. K1 against plain version
    gen = torch.Generator(device=dev).manual_seed(0)

    def qkv(B, T, H, Hkv, D, dtype, fused=False):
        if fused:   # the model's layout: views into one [B, T, 3, H, D]
            x = torch.randn(B, T, 3, H, D, device=dev, generator=gen).to(dtype)
            return x[:, :, 0], x[:, :, 1], x[:, :, 2]
        return tuple(
            torch.randn(B, T, h, D, device=dev, generator=gen).to(dtype)
            for h in (H, Hkv, Hkv)
        )

    bf16 = torch.bfloat16
    errs = []
    for name, B, T, H, Hkv, D, causal, dname, fused in CASES:
        dtype = getattr(torch, dname)
        q, k, v = qkv(B, T, H, Hkv, D, dtype, fused)
        with torch.no_grad():
            out = attn.flash_attention(q, k, v, causal)
            torch.cuda.synchronize()
            ref = attn.flash_attention_ref(q, k, v, causal)
        atol, rtol = TOL[dname]
        max_err, nbad = close(out, ref, TOL[dname])
        errs.append({"case": name, "dtype": dname, "shape": [B, T, H, Hkv, D],
                     "causal": causal, "max_abs_err": max_err})
        log(f"K1 {name} {dname} B={B} T={T} H={H} Hkv={Hkv} D={D} "
            f"causal={causal}: max|kernel-plain|={max_err:.3e} "
            f"(bound {atol:g} + {rtol:g}|plain|)")
        check(out.shape == q.shape and bool(torch.isfinite(out).all()),
              f"K1 {name}: bad output")
        check(nbad == 0, f"K1 {name} {dname}: {nbad} elements outside the "
              f"bound, max err {max_err:.3e}")

    # K2 against flash_attention_ref(with_lse=True); K4 (dq, delta) against
    # flash_bwd_dq_ref and K3 (dk, dv) against flash_bwd_dkv_ref, each on
    # the inputs its kernel got: the same q, k, v, dO, the kernel's own out
    # and lse, and for K3 K4's delta. delta is an f32 sum over D of the same
    # products in another order, so it keeps LSE_TOL. K1's cases plus the
    # training shape (the model's fused qkv views).
    train_case = ("train", *TRAIN_BATCH[:1], TRAIN_BATCH[1], MODEL["num_heads"],
                  MODEL["num_heads"], MODEL["embed_dim"] // MODEL["num_heads"], True)
    train_errs = {}
    for name, B, T, H, Hkv, D, causal, dname, fused in CASES + [
            (*train_case, "bfloat16", True), (*train_case, "float32", True)]:
        dtype = getattr(torch, dname)
        q, k, v = qkv(B, T, H, Hkv, D, dtype, fused)
        do = torch.randn(B, T, H, D, device=dev, generator=gen).to(dtype)
        with torch.no_grad():
            out, lse = attn._flash_fwd_cuda(q, k, v, causal, with_lse=True)
            dq, dk, dv, delta = attn._flash_bwd_cuda(q, k, v, out, lse, do,
                                                     causal)
            torch.cuda.synchronize()
            ref_out, ref_lse = attn.flash_attention_ref(q, k, v, causal,
                                                        with_lse=True)
            rq, rdelta = attn.flash_bwd_dq_ref(q, k, v, out, lse, do, causal)
            rk, rv = attn.flash_bwd_dkv_ref(q, k, v, delta, lse, do, causal)
        errs_case = {
            "out": close(out, ref_out, TOL[dname]),
            "lse": close(lse, ref_lse, LSE_TOL),
            "delta": close(delta, rdelta, LSE_TOL),
            "dq": close(dq, rq, GRAD_TOL[dname]),
            "dk": close(dk, rk, GRAD_TOL[dname]),
            "dv": close(dv, rv, GRAD_TOL[dname]),
        }
        log(f"K2-K4 {name} {dname} B={B} T={T} H={H} Hkv={Hkv} D={D} "
            f"causal={causal}: max|kernel-plain| "
            + ", ".join(f"{n} {e:.3e}" for n, (e, _) in errs_case.items())
            + f" (bounds out {TOL[dname]}, lse and delta {LSE_TOL}, grads {GRAD_TOL[dname]} "
            "as atol + rtol|plain|)")
        for n, (e, nbad) in errs_case.items():
            check(nbad == 0, f"K2-K4 {name} {dname} {n}: {nbad} elements "
                  f"outside the bound, max err {e:.3e}")
        check(lse.shape == (B, H, T) and delta.shape == (B, H, T) and all(
            bool(torch.isfinite(x).all()) for x in (out, lse, delta, dq, dk, dv)),
            f"K2-K4 {name}: bad output")
        if name in ("train", "llama1b-train") and dtype == bf16:
            train_errs[name] = {n: e for n, (e, _) in errs_case.items()}
    del q, k, v, do, out, lse, delta, dq, dk, dv, ref_out, ref_lse, rq, rdelta, rk, rv
    phase_done(2)

    # ------------------------------------------ shared by both model families
    def full_forward_checks(label, mod, params, cfg_bf16):
        """The full forward (FORWARD_BATCH) through K1 in bf16 and f32
        against the dense version; returns K1's launches per forward."""
        tokens = torch.randint(0, cfg_bf16.vocab_size, FORWARD_BATCH,
                               device=dev, generator=gen)
        with torch.no_grad():
            before = attn.launches["flash_fwd"]
            logits_flash, _ = mod.forward(params, tokens, cfg_bf16)
            torch.cuda.synchronize()
            per_forward = attn.launches["flash_fwd"] - before
            logits_xla, _ = mod.forward(
                params, tokens,
                dataclasses.replace(cfg_bf16, attention_impl="xla"))
            cfg_f32 = dataclasses.replace(cfg_bf16, dtype=torch.float32)
            logits32_flash, _ = mod.forward(params, tokens, cfg_f32)
            logits32_xla, _ = mod.forward(
                params, tokens,
                dataclasses.replace(cfg_f32, attention_impl="xla"))
            torch.cuda.synchronize()
        L = cfg_bf16.num_layers
        check(per_forward == L,
              f"{label}: one forward launched K1 {per_forward} times, want {L}")
        check(tuple(logits_flash.shape) == (*FORWARD_BATCH, cfg_bf16.vocab_size)
              and bool(torch.isfinite(logits_flash).all()), f"{label}: bf16 logits")
        # f32: both paths compute in f32; 1e-4 = five times the reference's
        # per-op 2e-5, for the stacked layers.
        d32 = float((logits32_flash - logits32_xla).abs().max())
        check(torch.allclose(logits32_flash, logits32_xla, atol=1e-4, rtol=1e-4),
              f"{label} f32 forward: flash vs dense max diff {d32:.3e}")
        # bf16: the two paths round at different places (the dense path
        # rounds the scores to bf16 before softmax, the kernel keeps them in
        # f32); the kernel's path must be no further from the f32 forward
        # than the dense path is.
        e_flash = float((logits_flash - logits32_xla).abs().max())
        e_xla = float((logits_xla - logits32_xla).abs().max())
        d16 = float((logits_flash - logits_xla).abs().max())
        log(f"forward {label} B,T={FORWARD_BATCH}: K1 launches/forward "
            f"{per_forward}; f32 max|flash-dense| {d32:.3e}; bf16 "
            f"max|flash-dense| {d16:.3e}; bf16 max|.-f32| flash {e_flash:.3e} "
            f"dense {e_xla:.3e}")
        check(e_flash <= 1.5 * e_xla + 1e-3,
              f"{label}: bf16 forward through K1 is further from f32 "
              f"({e_flash:.3e}) than the dense bf16 path ({e_xla:.3e})")
        return per_forward

    def forward_argmax(mod, eng, prompt, n_new):
        """Greedy tokens by argmax over the full forward through K1, re-run
        per step on ``eng``'s parameters, the stop token dropped."""
        cfg_ref = dataclasses.replace(eng.model_config, attention_impl="flash")
        seq, expect = list(prompt), []
        with torch.no_grad():
            for _ in range(n_new):
                logits, _ = mod.forward(
                    eng.params, torch.tensor([seq], device=dev), cfg_ref)
                nxt = int(logits[0, -1].argmax())
                expect.append(nxt)
                if nxt == eng.tokenizer.eos_id:
                    break
                seq.append(nxt)
        return [t for t in expect if t != eng.tokenizer.eos_id]

    def greedy_matches_forward(label, mod, eng, prompts, n_new):
        """The engine's greedy tokens equal argmax over the full forward
        through K1, re-run per step. Returns the engine's tokens."""
        try:
            futs = [eng.submit(p, SamplingParams(max_new_tokens=n_new))
                    for p in prompts]
            got = [list(f.result(600)) for f in futs]
        finally:
            eng.shutdown()
        for prompt, out in zip(prompts, got):
            expect = forward_argmax(mod, eng, prompt, n_new)
            log(f"{label} greedy {out}")
            check(len(out) >= 1 and out == expect[:len(out)],
                  f"{label} tokens {out} != K1 full-forward argmax {expect}")
        return got

    def build_engine(label, cfg, params):
        """A DecodeEngine on the card (its programs captured as it is
        built), with the seconds and the device memory it adds: allocated
        (caches, the weights cast once, its graphs' outputs) and reserved
        (its graphs' pools too), after dropped engines were released."""
        release()
        torch.cuda.synchronize()
        alloc0, res0 = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
        t = time.perf_counter()
        eng = DecodeEngine(cfg, params=params, device=dev)
        torch.cuda.synchronize()
        built_s = time.perf_counter() - t
        shared = {w.data_ptr() for w in params.parameters()}
        cast_gb = sum(t.numel() * t.element_size() for t in leaves(eng._run_params)
                      if t.data_ptr() not in shared) / 1e9
        cache_gb = sum(t.numel() * t.element_size() for t in
                       [*eng._cache.values(), *eng._slot_cache.values()]) / 1e9
        eng.added_gb = ((torch.cuda.memory_allocated() - alloc0) / 1e9,
                        (torch.cuda.memory_reserved() - res0) / 1e9,
                        cast_gb, cache_gb)
        progs = programs(eng)
        check(all(p.graph is not None for p in progs.values()),
              f"{label}: a program was not captured")
        log(f"{label}: built in {built_s:.2f} s with {len(progs)} captured "
            f"programs ({', '.join(progs)}); adds {eng.added_gb[0]:.3f} GB "
            f"allocated ({cast_gb:.3f} of weights cast once, {cache_gb:.3f} of "
            f"batch and slot caches), {eng.added_gb[1]:.3f} GB reserved")
        return eng

    def leaves(tree):
        for v in tree.values():
            yield from (leaves(v) if isinstance(v, dict) else (v,))

    def programs(eng):
        progs = {"decode": eng._decode}
        if eng._decode_spec is not None:
            progs["decode_all"] = eng._decode_spec
        progs.update({f"prefill{b}": p for b, p in eng._prefill.items()})
        return progs

    def replays(eng):
        return {n: p.replays for n, p in programs(eng).items()}

    def release():
        """Return the device memory of engines dropped (shut down and
        deleted) to the card: their graphs' pools go with them."""
        gc.collect()
        torch.cuda.empty_cache()

    def graph_against_eager(label, mod, eng):
        """Each of the engine's programs (decode, decode_all, every prefill
        bucket) against ``forward_cached`` called eagerly with the original
        f32 parameters, on a clone of the same cache and the same inputs:
        logits and caches within TOL of the dtype, next tokens equal."""
        cfg = eng.model_config
        dname = "float32" if cfg.dtype == torch.float32 else "bfloat16"
        B, S = eng.config.max_batch_slots, eng.config.max_seq_len
        worst = 0.0

        def compare(what, got, ref, got_cache, ref_cache):
            nonlocal worst
            err, nbad = close(got, ref, TOL[dname])
            cerr = max(close(got_cache[k], ref_cache[k], TOL[dname])[1]
                       for k in ref_cache)
            same = bool((got.argmax(-1) == ref.argmax(-1)).all())
            worst = max(worst, err)
            check(nbad == 0 and cerr == 0 and same,
                  f"{label} {what}: graph against eager max err {err:.3e}, "
                  f"{nbad} logits and {cerr} cache entries outside "
                  f"{TOL[dname]}, next tokens equal: {same}")

        with torch.no_grad():
            for c in eng._cache.values():
                c.normal_(generator=gen)
            lens = torch.randint(1, S // 2, (B,), device=dev, generator=gen)
            for name, prog in programs(eng).items():
                if not name.startswith("decode"):
                    continue
                toks = torch.randint(2, 258, tuple(prog.buffers["tokens"].shape),
                                     device=dev, generator=gen)
                ref_cache = {k: v.clone() for k, v in eng._cache.items()}
                got = prog(tokens=toks, lens=lens)
                ref, _ = mod.forward_cached(eng.params, toks, ref_cache, lens, cfg)
                compare(name, got, ref[:, -1] if name == "decode" else ref,
                        eng._cache, ref_cache)
            start = torch.zeros(1, dtype=torch.long, device=dev)
            for b, prog in eng._prefill.items():
                for v in eng._slot_cache.values():
                    v.zero_()
                toks = torch.randint(2, 258, (1, b), device=dev, generator=gen)
                got, got_cache = prog(tokens=toks, start=start)
                ref, ref_cache = mod.forward_cached(
                    eng.params, toks, mod.init_kv_cache(cfg, 1, S, device=dev),
                    start, cfg, fresh=True)
                compare(f"prefill{b}", got, ref, got_cache, ref_cache)
        log(f"{label}: {len(programs(eng))} programs' graphs against eager "
            f"forward_cached on the f32 parameters: max|graph-eager| "
            f"{worst:.3e} (bound {TOL[dname][0]:g} + {TOL[dname][1]:g}|eager|), "
            "next tokens equal")

    text = ("Ray is a framework for scaling Python and AI workloads: tasks, "
            "actors and objects on a cluster, with libraries for training, "
            "tuning, serving and data. This port runs its models on the "
            "card. ") * 3

    def serve_timed(eng, requests):
        """Answer ``requests`` [(prompt ids, SamplingParams)] all at once;
        returns (outputs, seconds, [(active slots, tick seconds)])."""
        ticks = []
        plain_tick = eng._tick_plain_locked

        def timed_tick():
            n = sum(s.active for s in eng._slots)
            t = time.perf_counter()
            busy = plain_tick()
            ticks.append((n, time.perf_counter() - t))
            return busy

        eng._tick_plain_locked = timed_tick
        try:
            t = time.perf_counter()
            futs = [eng.submit(p, sp) for p, sp in requests]
            outs = [list(f.result(600)) for f in futs]
            serve_s = time.perf_counter() - t
        finally:
            eng.shutdown()
            eng._tick_plain_locked = plain_tick
        return outs, serve_s, ticks

    def mixed_requests(eng, mod, label):
        """16 mixed requests (8-200 bytes, 32 new tokens; a third greedy, a
        third top-p, a third seeded top-k) through ``eng``, then the same
        prompts all greedy; then the engine's programs timed (the decode
        replay's device ms, each program call, each prefill bucket) beside
        ``forward_cached`` called eagerly on the f32 parameters (host ms and,
        from a graph of it, device ms), and host sampling. Returns the
        numbers."""
        lengths = np.random.RandomState(0).randint(8, 201, size=16)
        requests = []
        for i, n in enumerate(lengths):
            if i % 3 == 0:
                sp = SamplingParams(max_new_tokens=32)
            elif i % 3 == 1:
                sp = SamplingParams(max_new_tokens=32, temperature=0.8, top_p=0.9)
            else:
                sp = SamplingParams(max_new_tokens=32, temperature=1.0, top_k=50,
                                    seed=i)
            requests.append((eng.tokenizer.encode(text[i:i + int(n)]), sp))
        before = replays(eng)
        tokens0 = eng.stats["tokens_generated"]
        outs, serve_s, ticks = serve_timed(eng, requests)
        produced = eng.stats["tokens_generated"] - tokens0 + len(outs)  # + first tokens
        main = {n: r - before[n] for n, r in replays(eng).items()}
        greedy_outs, greedy_s, greedy_ticks = serve_timed(
            eng, [(p, SamplingParams(max_new_tokens=32)) for p, _ in requests])
        vocab = eng.model_config.vocab_size
        for o in outs + greedy_outs:
            check(len(o) >= 1 and all(0 <= x < vocab for x in o),
                  f"{label}: a request returned nothing or bad ids")
        full = [dt for n, dt in ticks if n == 8]
        full_greedy = [dt for n, dt in greedy_ticks if n == 8]
        check(len(full) > 0 and len(full_greedy) > 0,
              f"{label}: no tick ran with 8 active slots")
        check(all(v > 0 for v in main.values()),
              f"{label}: a program was not replayed on the main path: {main}")
        log(f"{label}: {len(outs)} requests answered, output lengths "
            f"{[len(o) for o in outs]}; program replays {main}")

        cfg = eng.model_config
        S = eng.config.max_seq_len
        with torch.no_grad():
            toks8 = torch.randint(2, 258, (8, 1), device=dev, generator=gen)
            lens8 = torch.full((8,), 300, dtype=torch.long, device=dev)
            cache8 = {k: v.clone() for k, v in eng._cache.items()}

            def eager_decode():
                mod.forward_cached(eng.params, toks8, cache8, lens8, cfg)

            decode = dict(
                replay_ms=cuda_ms(eng._decode.graph.replay, iters=50),
                call_ms=cuda_ms(lambda: eng._decode(tokens=toks8, lens=lens8),
                                iters=50),
                eager_ms=cuda_ms(eager_decode, iters=20),
                eager_device_ms=graph_ms(eager_decode, reps=10))
            del cache8
            prefill = {}
            start = torch.zeros(1, dtype=torch.long, device=dev)
            cache1 = mod.init_kv_cache(cfg, 1, S, device=dev)
            for b, prog in eng._prefill.items():
                toks = torch.randint(2, 258, (1, b), device=dev, generator=gen)
                prefill[b] = dict(
                    replay_ms=cuda_ms(prog.graph.replay, iters=20),
                    call_ms=cuda_ms(lambda: prog(tokens=toks, start=start),
                                    iters=20),
                    eager_ms=cuda_ms(lambda: mod.forward_cached(
                        eng.params, toks, cache1, start, cfg, fresh=True),
                        iters=10))
            del cache1
        row = np.random.RandomState(1).randn(vocab).astype(np.float32)
        sample_ms = {}
        for kind, sp in (("greedy", requests[0][1]), ("top_p", requests[1][1]),
                         ("top_k", requests[2][1])):
            t = time.perf_counter()
            for _ in range(20):
                eng._sample(row, sp, requests[0][0], (), np.random.RandomState(0))
            sample_ms[kind] = (time.perf_counter() - t) / 20 * 1e3
        return dict(produced=produced, serve_s=serve_s,
                    tick8_ms=float(np.median(full)) * 1e3, n_full=len(full),
                    greedy_tick8_ms=float(np.median(full_greedy)) * 1e3,
                    n_full_greedy=len(full_greedy), decode=decode,
                    prefill=prefill, sample_ms=sample_ms,
                    added_gb=eng.added_gb, replays=main)

    def log_serving(label, s):
        d = s["decode"]
        log(f"[{card}] {label} bf16 engine (graphed): {s['produced']} tokens in "
            f"{s['serve_s']:.3f} s = {s['produced'] / s['serve_s']:.1f} tok/s "
            f"over 16 mixed requests; median tick at 8 active slots "
            f"{s['tick8_ms']:.3f} ms ({8e3 / s['tick8_ms']:.1f} tok/s), "
            f"{s['n_full']} such ticks; all greedy {s['greedy_tick8_ms']:.3f} "
            f"ms ({8e3 / s['greedy_tick8_ms']:.1f} tok/s), "
            f"{s['n_full_greedy']} such ticks")
        log(f"[{card}] {label} decode at 8 slots: graph replay {d['replay_ms']:.3f} "
            f"ms device, program call {d['call_ms']:.3f} ms; eager "
            f"forward_cached (f32 parameters) {d['eager_ms']:.3f} ms, its device "
            f"time {d['eager_device_ms']:.3f} ms (idle "
            f"{1 - d['eager_device_ms'] / d['eager_ms']:.1%}); the graphed "
            f"tick's device share {d['replay_ms'] / s['tick8_ms']:.1%} (mixed), "
            f"{d['replay_ms'] / s['greedy_tick8_ms']:.1%} (greedy)")
        log(f"[{card}] {label} prefill ms per bucket (graph replay / program "
            "call / eager forward_cached): " + ", ".join(
                f"{b}: {p['replay_ms']:.3f} / {p['call_ms']:.3f} / "
                f"{p['eager_ms']:.3f}" for b, p in s["prefill"].items()))
        log(f"[{card}] {label} engine adds {s['added_gb'][0]:.3f} GB allocated "
            f"({s['added_gb'][2]:.3f} weights cast once, {s['added_gb'][3]:.3f} "
            f"caches), {s['added_gb'][1]:.3f} GB reserved; host sampling ms per "
            "slot: "
            + ", ".join(f"{k} {v:.3f}" for k, v in s["sample_ms"].items()))

    opt_cfg = OptimizerConfig(**TRAIN_OPTIMIZER)

    graphs = torch._dynamo.utils.counters["stats"]

    def timed_steps(step_fn, state, batch, n):
        """n steps of ``step_fn``: per-step seconds (ending in a
        synchronise), losses, norms and kernel launches. Every step after
        the first runs with Dynamo's error_on_recompile: a compiled step
        that compiles again fails the run."""
        losses, norms, step_s, per_step = [], [], [], []
        for i in range(n):
            before = dict(attn.launches)
            t = time.perf_counter()
            with torch._dynamo.config.patch(error_on_recompile=i > 0):
                state, metrics = step_fn(state, batch)
            losses.append(float(metrics["loss"]))
            norms.append(float(metrics["grad_norm"]))
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t)
            per_step.append({k: attn.launches[k] - before[k] for k in attn.launches})
        return state, dict(losses=losses, norms=norms, step_s=step_s,
                           per_step=per_step)

    def train_steps(label, cfg, B, T):
        """TRAIN_STEPS steps of the compiled make_train_step (the default on
        the card) on one seeded batch, K2-K4's counts set to 0 just before
        and read just after; the checks of phase 5: finite, the first loss
        near ln V, a falling loss, L launches each of K2-K4 a step, no
        program compiled after the first step. Then EAGER_STEPS of the
        eager step (backend=None) on the same state, timed beside it.
        Returns (state, batch, opt, numbers)."""
        L, V = cfg.num_layers, cfg.vocab_size
        opt = opt_cfg.build()
        state = create_train_state(cfg, opt, torch.Generator().manual_seed(0),
                                   dev)
        train_step = make_train_step(cfg, opt)
        batch = {"tokens": torch.randint(0, V, (B, T + 1), device=dev,
                                         generator=gen)}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for name in ("flash_fwd", "flash_fwd_lse", "flash_bwd_dkv", "flash_bwd_dq"):
            attn.launches[name] = 0
        graphs_before = graphs["unique_graphs"]
        state, tr = timed_steps(train_step, state, batch, 1)
        graphs_first = graphs["unique_graphs"] - graphs_before
        state, rest = timed_steps(train_step, state, batch, TRAIN_STEPS - 1)
        recompiled = graphs["unique_graphs"] - graphs_before - graphs_first
        for k in tr:
            tr[k] += rest[k]
        launches = dict(attn.launches)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        losses, norms, per_step = tr["losses"], tr["norms"], tr["per_step"]
        log(f"train {label} B={B} T={T} bf16/f32 remat {cfg.remat_policy}, "
            "compiled: losses " + " ".join(f"{x:.4f}" for x in losses))
        log(f"train {label} grad norms " + " ".join(f"{x:.4f}" for x in norms))
        log(f"train {label} launches per step {per_step[0]} ({TRAIN_STEPS} "
            f"steps: {launches}); programs compiled at step 0: "
            f"{graphs_first}, after it: {recompiled}")
        check(graphs_first == 2 and recompiled == 0,
              f"{label}: {graphs_first} programs compiled at step 0 (want the "
              f"loss and the update), {recompiled} after it (want 0)")
        check(all(math.isfinite(x) for x in losses + norms),
              f"{label}: non-finite loss or norm")
        check(abs(losses[0] - math.log(V)) < 0.5,
              f"{label}: step-0 loss {losses[0]:.4f} not within 0.5 of ln V = "
              f"{math.log(V):.4f}")
        check(losses[-1] < losses[0],
              f"{label}: loss did not fall: {losses[0]} -> {losses[-1]}")
        want = {"flash_fwd": 0, "flash_fwd_lse": L, "flash_bwd_dkv": L,
                "flash_bwd_dq": L}
        for i, counts in enumerate(per_step):
            check(counts == want, f"{label} train step {i} launches {counts}, "
                  f"want {want}")
        # the eager step on the same state, its own peak
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        state, eager = timed_steps(make_train_step(cfg, opt, backend=None),
                                   state, batch, EAGER_STEPS)
        eager["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        log(f"train {label} eager steps: losses "
            + " ".join(f"{x:.4f}" for x in eager["losses"]))
        check(all(math.isfinite(x) for x in eager["losses"] + eager["norms"])
              and all(c == want for c in eager["per_step"]),
              f"{label} eager steps: losses {eager['losses']}, launches "
              f"{eager['per_step']}")
        return state, batch, opt, dict(launches=launches, peak_gb=peak_gb,
                                       losses=losses, step=train_step,
                                       step_s=tr["step_s"], want=want,
                                       eager=eager)

    def check_leaves(label, state, compiled_fn, eager_fn, batch, lr):
        """One more step from two copies of ``state``, one through the
        compiled step, one through the eager step on the same kernels (the
        compiled program is what differs), at ``lr``; then the Adam moments
        and parameters, leaf by leaf: exp_avg within 2e-4 and exp_avg_sq
        within 4e-4 of the leaf's largest element (the gradients' 2e-4,
        squared in v). The update moves a parameter by lr * m_hat /
        (sqrt(v_hat) + eps), so a gradient error dm moves it by about
        1.25 dm / sqrt(v) times lr at step 4 (m's bias correction against
        v's), plus v's share: each element within lr * min(2,
        4 dm / sqrt(v)), dm the exp_avg bound. Where the gradient is near
        its rounding noise (the key bias's is zero in exact arithmetic)
        Adam's normalisation makes that up to 2 lr."""
        def clone(st):
            return dict(st, params=copy.deepcopy(st["params"]), opt_state={
                k: v.clone() if isinstance(v, torch.Tensor) else
                [t.clone() for t in v] for k, v in st["opt_state"].items()})

        got, _ = compiled_fn(clone(state), batch)
        want, _ = eager_fn(clone(state), batch)
        names = [n for n, _ in got["params"].named_parameters()]
        worst = {}

        def note(kind, n, share, err, bound):
            if kind not in worst or share > worst[kind][0]:
                worst[kind] = (share, n, err, bound)

        for i, n in enumerate(names):
            m, v = want["opt_state"]["exp_avg"][i], want["opt_state"]["exp_avg_sq"][i]
            m_bound = 2e-4 * float(m.abs().max())
            for kind, tol in (("exp_avg", 2e-4), ("exp_avg_sq", 4e-4)):
                x, y = got["opt_state"][kind][i], want["opt_state"][kind][i]
                err, bound = float((x - y).abs().max()), tol * float(y.abs().max())
                note(kind, n, err / bound if bound else (0.0 if err == 0 else math.inf),
                     err, bound)
            diff = (got["params"].get_parameter(n).detach()
                    - want["params"].get_parameter(n).detach()).abs()
            bound = lr * torch.clamp(4 * m_bound / v.sqrt(),
                                     max=2.0).nan_to_num(2.0)
            k = int(torch.argmax(diff / bound))
            note("param", n, float(diff.flatten()[k] / bound.flatten()[k]),
                 float(diff.flatten()[k]), float(bound.flatten()[k]))
        log(f"{label} leaves after one more step at lr {lr}, compiled against "
            f"eager, worst per kind (share of bound, leaf, abs diff, bound): "
            f"{worst}")
        check(all(w[0] <= 1.0 for w in worst.values()),
              f"{label} leaves outside their bounds: {worst}")

    def check_update(label, state, opt):
        """The compiled update, the train step's Inductor program of
        ``clip_adamw_`` (built by the step's own ``_program``), against
        ``clip_adamw_`` run eagerly, on two copies of ``state`` after its
        steps: its parameters, moments and step counts, the gradients the
        last step left (times 3, so the clip scales them), at the peak lr.
        The same f32 arithmetic, fused or in multi-tensor kernels: each
        parameter leaf within 1e-6 of its largest element plus 1e-5 lr,
        each moment within 1e-5 of its largest element, the steps equal
        and the norm within 1e-6 relative. A wrong decay or moment term
        moves far more (lr * wd * p is 2e-6 at p = 0.02, 20x this
        bound)."""
        lr = opt.config.learning_rate
        plist = list(state["params"].parameters())
        outs = []
        for fn in (step_mod._program(step_mod.clip_adamw_, "auto"), None):
            args = ([p.detach().clone() for p in plist],
                    [p.grad * 3 for p in plist],
                    [t.clone() for t in state["opt_state"]["exp_avg"]],
                    [t.clone() for t in state["opt_state"]["exp_avg_sq"]],
                    [t.clone() for t in state["opt_state"]["step"]],
                    torch.full((), lr, dtype=torch.float32, device=dev))
            norm = (fn(dev, *args, **opt.hyper) if fn is not None
                    else step_mod.clip_adamw_(*args, **opt.hyper))
            outs.append((float(norm), args[0], args[2], args[3], args[4]))
        (n_c, *leaves_c), (n_e, *leaves_e) = outs
        worst = {}
        for kind, xs, ys in zip(("param", "exp_avg", "exp_avg_sq", "step"),
                                leaves_c, leaves_e):
            for x, y in zip(xs, ys):
                scale = float(y.abs().max())
                bound = {"param": 1e-6 * scale + 1e-5 * lr, "step": 0.0}.get(
                    kind, 1e-5 * scale)
                err = float((x - y).abs().max())
                share = err / bound if bound else (0.0 if err == 0 else math.inf)
                worst[kind] = max(worst.get(kind, 0.0), share)
        log(f"{label} compiled update against eager (lr {lr}, norm {n_c:.6f} "
            f"vs {n_e:.6f}): worst share of bound per kind {worst}")
        check(abs(n_c - n_e) <= 1e-6 * abs(n_e) and all(
            w <= 1.0 for w in worst.values()),
            f"{label} compiled update: norm {n_c} vs {n_e}, {worst}")

    def train_parity(label, par_cfg, V):
        """f32, B=2, T=256, 3 steps of the compiled step through the kernels
        against the eager step on the plain (flash_interpret) path: loss
        and grad_norm within 2e-4 relative; then the compiled eval step
        (K1) against the eager plain one on each side's parameters, within
        the same bound. Then the leaves after one more step by
        check_leaves, and the compiled update by check_update."""
        par, evals, states, fns = {}, {}, {}, {}
        for impl, backend in (("flash", "auto"), ("flash_interpret", None)):
            cfg = dataclasses.replace(par_cfg, attention_impl=impl)
            opt = opt_cfg.build()
            st = create_train_state(cfg, opt, torch.Generator().manual_seed(3), dev)
            fn = make_train_step(cfg, opt, backend=backend)
            toks = torch.randint(0, V, (2, 257), device=dev,
                                 generator=torch.Generator(device=dev).manual_seed(4))
            rows = []
            for _ in range(3):
                st, m = fn(st, {"tokens": toks})
                rows.append((float(m["loss"]), float(m["grad_norm"])))
            fns[impl] = fn
            par[impl], states[impl] = rows, st
            evals[impl] = float(make_eval_step(cfg, backend=backend)(
                st["params"], {"tokens": toks}))
        par_rel = max(abs(a - b) / abs(b)
                      for ka, kb in zip(par["flash"], par["flash_interpret"])
                      for a, b in zip(ka, kb))
        eval_rel = abs(evals["flash"] - evals["flash_interpret"]) / abs(
            evals["flash_interpret"])
        log(f"train parity {label} f32 depth 2 B=2 T=256, (loss, grad_norm) per "
            f"step: compiled through the kernels {par['flash']}, eager plain "
            f"{par['flash_interpret']}; max rel diff {par_rel:.3e} (bound "
            f"2e-4); eval loss after them compiled {evals['flash']:.7f}, eager "
            f"plain {evals['flash_interpret']:.7f}, rel diff {eval_rel:.3e}")
        check(par_rel <= 2e-4 and eval_rel <= 2e-4, f"{label} train parity: "
              f"max rel diff {par_rel:.3e}, eval {eval_rel:.3e} > 2e-4")
        eager_fn = make_train_step(dataclasses.replace(
            par_cfg, attention_impl="flash"), opt, backend=None)
        check_leaves(f"train parity {label}", states["flash"], fns["flash"],
                     eager_fn, {"tokens": toks}, opt.schedule(3))
        check_update(f"train parity {label}", states["flash"], opt)
        del states, fns, opt

    # ------------------------------- 3. main path: GPT-2-small full forward
    attn.launches["flash_fwd"] = 0
    small = gpt2.GPT2Config(**MODEL)
    cfg_bf16 = dataclasses.replace(small, attention_impl="flash")
    model = gpt2.init_params(cfg_bf16, torch.Generator().manual_seed(0), dev)
    full_forward_checks("GPT-2 small", gpt2, model, cfg_bf16)
    del model
    phase_done(3)

    # ------------------------------------------ 4. main path: serving
    engine_kw = dict(MODEL, max_batch_slots=8, prefill_buckets=PREFILL_BUCKETS)
    # f32 engine: its graphs against eager forward_cached, then greedy tokens
    # == argmax of the full forward through K1.
    cfg = LLMConfig(dtype="float32", **engine_kw)
    params = lively(gpt2.init_params(cfg.model_config(),
                                     torch.Generator().manual_seed(1), dev),
                    GPT2_LIVELY)
    eng = build_engine("GPT-2 f32 engine", cfg, params)
    graph_against_eager("GPT-2 f32 engine", gpt2, eng)
    prompts = [eng.tokenizer.encode("The port serves GPT-2 on the card."),
               eng.tokenizer.encode("Flash attention, hand-written for Hopper"),
               eng.tokenizer.encode("la la la la la la la la")]
    plain = greedy_matches_forward("f32 engine", gpt2, eng, prompts, 16)
    del eng
    # The same weights with prompt-lookup speculation (k=4): the decode_all
    # graph verifies the drafts, and the greedy tokens equal the plain
    # engine's.
    eng = build_engine("GPT-2 f32 speculative engine (k=4)", LLMConfig(
        dtype="float32", speculative_ngram_k=4, **engine_kw), params)
    graph_against_eager("GPT-2 f32 speculative engine", gpt2, eng)
    before = replays(eng)
    spec, _, _ = serve_timed(
        eng, [(p, SamplingParams(max_new_tokens=16)) for p in prompts])
    spec_replays = {n: r - before[n] for n, r in replays(eng).items()}
    log(f"speculative engine greedy {spec}; program replays {spec_replays}; "
        f"drafts proposed {eng.stats['spec_proposed']}, accepted "
        f"{eng.stats['spec_accepted']}")
    check(spec == plain, f"speculative engine tokens {spec} != the plain "
          f"engine's {plain}")
    check(spec_replays["decode_all"] > 0, "decode_all was not replayed")
    del eng, params
    # bf16 engine: 16 mixed requests, 32 new tokens each, then all greedy.
    cfg = LLMConfig(dtype="bfloat16", **engine_kw)
    eng = build_engine("GPT-2 bf16 engine", cfg, lively(gpt2.init_params(
        cfg.model_config(), torch.Generator().manual_seed(2), dev),
        GPT2_LIVELY))
    graph_against_eager("GPT-2 bf16 engine", gpt2, eng)
    serving = mixed_requests(eng, gpt2, "GPT-2 bf16 engine")
    main_launches = attn.launches["flash_fwd"]
    del eng
    release()
    phase_done(4)

    # ------------------------------------------- 5. main path: training
    # GPT-2 small at the JAX bench's training shape; random weights and one
    # batch of random tokens, both from seeds.
    L, V = small.num_layers, small.vocab_size
    B, T = TRAIN_BATCH
    train_cfg = dataclasses.replace(small, attention_impl="flash", remat=True,
                                    remat_policy="dots")
    state, batch, opt, gtrain = train_steps("GPT-2 small", train_cfg, B, T)
    train_launches = gtrain["launches"]

    # remat "full" keeps only each block's inputs: the backward re-runs the
    # block, K2 included (JAX's "full" policy does the same). Two compiled
    # steps: the first compiles, the second is timed.
    state, full = timed_steps(make_train_step(
        dataclasses.replace(train_cfg, remat_policy="full"), opt), state, batch, 2)
    full_ms = full["step_s"][1] * 1e3
    log(f"train steps under remat full, compiled: losses {full['losses']}, "
        f"{full['step_s'][0]:.1f} s (compiling), {full_ms:.1f} ms, launches "
        f"{full['per_step']}")
    check(all(c == {**gtrain["want"], "flash_fwd_lse": 2 * L}
              for c in full["per_step"]), f"remat full launches {full['per_step']}")

    # The compiled eval step (no gradient: K1 once a layer), K1's count set
    # to 0 just before its two calls (the first compiles) and read just
    # after; against the eager eval step. bf16: eager rounds every op's
    # output to bf16 (2^-8 relative), the fused program only each kernel's,
    # so the mean loss is held within 1e-2 relative.
    eval_step = make_eval_step(train_cfg)
    attn.launches["flash_fwd"] = 0
    before = dict(attn.launches)
    eval_s = []
    for _ in range(2):
        t = time.perf_counter()
        eval_loss = float(eval_step(state["params"], batch))
        torch.cuda.synchronize()
        eval_s.append(time.perf_counter() - t)
    eval_counts = {n: attn.launches[n] - before[n] for n in attn.launches}
    eval_launches = eval_counts["flash_fwd"]
    eager_eval = float(make_eval_step(train_cfg, backend=None)(state["params"],
                                                               batch))
    log(f"eval step GPT-2 small B={B} T={T}, compiled: loss {eval_loss:.5f} "
        f"(eager {eager_eval:.5f}), {eval_s[0]:.1f} s (compiling), "
        f"{eval_s[1] * 1e3:.1f} ms; launches {eval_counts}")
    check(eval_counts == {"flash_fwd": 2 * L, "flash_fwd_lse": 0,
                          "flash_bwd_dkv": 0, "flash_bwd_dq": 0},
          f"eval launches {eval_counts}")
    check(math.isfinite(eval_loss)
          and abs(eval_loss - eager_eval) <= 1e-2 * abs(eager_eval),
          f"eval loss {eval_loss} against eager {eager_eval}")
    del state, batch, opt, eval_step
    torch.cuda.empty_cache()
    phase_done(5)

    # ------------------------- 6. training parity on the card: kernels vs plain
    train_parity("GPT-2 small", dataclasses.replace(
        small, num_layers=2, dtype=torch.float32), V)
    phase_done(6)

    # ------------------------------------------------------------ 7. numbers
    def time_k1(B, T, H, Hkv, D):
        """K1 (bf16, causal) from a graph and eagerly, the plain and dense
        versions and SDPA, at one shape."""
        q, k, v = qkv(B, T, H, Hkv, D, bf16)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

        def sdpa():
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                  enable_gqa=Hkv != H)

        with torch.no_grad():
            r = dict(
                call_ms=cuda_ms(lambda: attn.flash_attention(q, k, v, True), 200, 10),
                ms=graph_ms(lambda: attn.flash_attention(q, k, v, True)),
                plain_ms=cuda_ms(lambda: attn.flash_attention_ref(q, k, v, True), 10),
                dense_ms=cuda_ms(lambda: attn.attention_xla(q, k, v, causal=True), 50),
                sdpa_call_ms=cuda_ms(sdpa, 200, 10),
                sdpa_ms=graph_ms(sdpa))
            q32, k32, v32 = (x.float() for x in (q, k, v))
            r["f32_ms"] = graph_ms(lambda: attn.flash_attention(q32, k32, v32, True))
        r["bound"] = attn_bound_ms("flash_fwd", B, T, T, H, Hkv, D, True, "bfloat16")
        r["bound_f32"] = attn_bound_ms("flash_fwd", B, T, T, H, Hkv, D, True,
                                       "float32")
        shape = f"B={B} T={T} H={H} Hkv={Hkv} D={D} causal"
        log(f"[{card}] K1 bf16 {shape}: device {r['ms']:.4f} ms (graph replay), "
            f"eager call {r['call_ms']:.4f} ms; sdpa{' (enable_gqa)' if Hkv != H else ''} "
            f"device {r['sdpa_ms']:.4f} ms, eager call {r['sdpa_call_ms']:.4f} ms; "
            f"plain blockwise {r['plain_ms']:.4f} ms; dense {r['dense_ms']:.4f} ms; "
            f"bound {r['bound'][0]:.5f} ms ({r['bound'][1]})")
        log(f"[{card}] K1 f32 same shape: device {r['f32_ms']:.4f} ms; bound "
            f"{r['bound_f32'][0]:.5f} ms ({r['bound_f32'][1]})")
        return r

    def time_k2_k4(B, T, H, Hkv, D, fused):
        """K2-K4 at one layer's call (bf16, causal), each launch replayed
        from a CUDA graph; the plain versions; SDPA forward and its
        backward through autograd, both from CUDA graphs, timed only as a
        yardstick (GQA through enable_gqa=True, no repeated K/V)."""
        q, k, v = qkv(B, T, H, Hkv, D, bf16, fused=fused)
        do = torch.randn(B, T, H, D, device=dev, generator=gen).to(bf16)
        gqa = Hkv != H
        with torch.no_grad():
            k2_ms = graph_ms(lambda: attn._flash_fwd_cuda(q, k, v, True,
                                                          with_lse=True), reps=20)
            out, lse = attn._flash_fwd_cuda(q, k, v, True, with_lse=True)
            q, k, v, out, do, lse = attn._flash_bwd_prepare(q, k, v, out, lse, do)
            dq = torch.empty_like(out)
            dk, dv = torch.empty_like(k), torch.empty_like(v)
            delta = torch.empty((B, H, T), dtype=torch.float32, device=dev)
            k4_ms = graph_ms(lambda: attn._flash_bwd_dq_launch(
                q, k, v, out, do, lse, dq, delta, True), reps=20)
            k3_ms = graph_ms(lambda: attn._flash_bwd_dkv_launch(
                q, k, v, do, lse, delta, dk, dv, True), reps=20)
            plain_fwd_ms = cuda_ms(
                lambda: attn.flash_attention_ref(q, k, v, True, with_lse=True), 3, 1)
            plain_dq_ms = cuda_ms(
                lambda: attn.flash_bwd_dq_ref(q, k, v, out, lse, do, True), 3, 1)
            plain_dkv_ms = cuda_ms(
                lambda: attn.flash_bwd_dkv_ref(q, k, v, delta, lse, do, True), 3, 1)
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            sdpa_fwd_ms = graph_ms(
                lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                       enable_gqa=gqa),
                reps=20)
        qg, kg, vg = (x.detach().requires_grad_() for x in (qt, kt, vt))
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            o_sdpa = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True,
                                                    enable_gqa=gqa)
        do_t = do.transpose(1, 2)
        sdpa_bwd_ms = graph_ms(lambda: torch.autograd.grad(
            o_sdpa, (qg, kg, vg), do_t, retain_graph=True), reps=20, stream=side)
        del o_sdpa, qg, kg, vg
        bounds = {n: attn_bound_ms(n, B, T, T, H, Hkv, D, True, "bfloat16")
                  for n in ("flash_fwd_lse", "flash_bwd_dkv", "flash_bwd_dq")}
        ms = {"flash_fwd_lse": k2_ms, "flash_bwd_dkv": k3_ms, "flash_bwd_dq": k4_ms}
        shape = f"B={B} T={T} H={H} Hkv={Hkv} D={D} causal"
        for n in ms:
            log(f"[{card}] {n} bf16 {shape}: device {ms[n]:.4f} ms (graph "
                f"replay); bound {bounds[n][0]:.5f} ms ({bounds[n][1]}), "
                f"{bounds[n][0] / ms[n]:.1%} of it")
        log(f"[{card}] {shape}: plain blockwise forward with lse "
            f"{plain_fwd_ms:.4f} ms, dq and delta {plain_dq_ms:.4f} ms, dk and "
            f"dv {plain_dkv_ms:.4f} ms; sdpa{' (enable_gqa)' if gqa else ''} "
            f"forward {sdpa_fwd_ms:.4f} ms, backward (dq, dk, dv together) "
            f"{sdpa_bwd_ms:.4f} ms (both graph replay); K3 + K4 (delta "
            f"included) {k3_ms + k4_ms:.4f} ms, "
            f"{(k3_ms + k4_ms) / sdpa_bwd_ms:.2f}x sdpa's backward")
        plain = {"flash_fwd_lse": plain_fwd_ms, "flash_bwd_dkv": plain_dkv_ms,
                 "flash_bwd_dq": plain_dq_ms}
        lib = {"flash_fwd_lse": sdpa_fwd_ms, "flash_bwd_dkv": sdpa_bwd_ms,
               "flash_bwd_dq": sdpa_bwd_ms}
        return ms, plain, lib, bounds

    k1 = time_k1(*FORWARD_BATCH, MODEL["num_heads"], MODEL["num_heads"],
                 MODEL["embed_dim"] // MODEL["num_heads"])
    log(f"[{card}] K1 launches on the main path (phases 3-4): {main_launches}")
    log_serving("GPT-2 small", serving)
    check(main_launches > 0, "K1 was not launched on the main path")
    gpt2_kernels = time_k2_k4(*TRAIN_BATCH, MODEL["num_heads"], MODEL["num_heads"],
                              MODEL["embed_dim"] // MODEL["num_heads"], True)
    lh, lkv = LLAMA_ENGINE["num_heads"], LLAMA_ENGINE["num_kv_heads"]
    ld = LLAMA_ENGINE["embed_dim"] // lh
    k1_llama = time_k1(*FORWARD_BATCH, lh, lkv, ld)
    llama_kernels = time_k2_k4(*LLAMA_TRAIN_BATCH, lh, lkv, ld, False)
    roof = matmul_roof_tflops()

    def log_step(label, cfg, mod, B, T, tr, extra=""):
        """Train-step numbers of the compiled step and of the eager one
        beside it: median of steps 1.. (step 0 compiles, or warms up),
        tokens/s, MFU against the data sheet and the matmul chain, peak
        memory; the compiled step's compile seconds (step 0 less the
        median)."""
        for kind, run in (("compiled", tr), ("eager", tr["eager"])):
            step_ms = float(np.median(run["step_s"][1:])) * 1e3
            tokens_per_s = B * T / (step_ms * 1e-3)
            model_tflops = mod.flops_per_token(cfg) * tokens_per_s / 1e12
            compile_s = run["step_s"][0] - step_ms / 1e3
            log(f"[{card}] train step {label} L={cfg.num_layers} B={B} T={T} "
                f"remat dots, {kind}: "
                f"median {step_ms:.2f} ms over {len(run['step_s']) - 1} steps "
                f"(step 0 {run['step_s'][0] * 1e3:.1f} ms"
                + (f", compiling {compile_s:.1f} s" if kind == "compiled" else "")
                + f"), {tokens_per_s:.0f} tokens/s; model "
                f"{model_tflops:.1f} TFLOP/s (6N per token): MFU "
                f"{model_tflops / (PEAK_FLOPS['bfloat16'] / 1e12):.1%} of the data "
                f"sheet's 989, {model_tflops / roof:.1%} of the measured bf16 matmul "
                f"chain ({roof:.1f} TFLOP/s); peak memory {run['peak_gb']:.2f} GB"
                + (extra if kind == "compiled" else ""))

    log_step("GPT-2 small", train_cfg, gpt2, *TRAIN_BATCH, gtrain,
             f"; remat full step {full_ms:.1f} ms; eval step "
             f"{eval_s[1] * 1e3:.1f} ms")
    phase_done(7)

    # ------------------------------ 8. main path: llama serving, llama-1b
    attn.launches["flash_fwd"] = 0
    llama_kw = dict(LLAMA_ENGINE, max_batch_slots=8,
                    prefill_buckets=PREFILL_BUCKETS)
    cfg = LLMConfig(dtype="float32", **llama_kw)
    lcfg = cfg.model_config()
    l1b = get_preset("llama-1b")
    check(isinstance(lcfg, llama.LlamaConfig)
          and lcfg.num_kv_heads == l1b.num_kv_heads
          and lcfg.hidden_dim == l1b.hidden_dim, f"LLMConfig gave {lcfg}")
    lparams = lively(llama.init_params(lcfg, torch.Generator().manual_seed(1),
                                       dev), LLAMA_LIVELY)
    llama_per_forward = full_forward_checks(
        "llama-1b", llama, lparams,
        dataclasses.replace(lcfg, dtype=torch.bfloat16, attention_impl="flash"))
    eng = build_engine("llama-1b f32 engine", cfg, lparams)
    graph_against_eager("llama-1b f32 engine", llama, eng)
    prompts_l = [eng.tokenizer.encode("The port serves llama on the card."),
                 eng.tokenizer.encode("Grouped-query attention, four to one")]
    greedy_matches_forward("llama-1b f32 engine", llama, eng, prompts_l, 16)
    del eng
    release()
    eng = build_engine("llama-1b bf16 engine",
                       LLMConfig(dtype="bfloat16", **llama_kw), lparams)
    graph_against_eager("llama-1b bf16 engine", llama, eng)
    llama_serving = mixed_requests(eng, llama, "llama-1b bf16 engine")
    llama_k1_launches = attn.launches["flash_fwd"]
    del eng, lparams
    release()
    log(f"[{card}] K1 launches on the llama serving path (phase 8): "
        f"{llama_k1_launches} ({llama_per_forward} a forward)")
    log_serving("llama-1b", llama_serving)
    check(llama_k1_launches > 0, "K1 was not launched on the llama path")
    phase_done(8)

    # ----------------------------- 9. main path: llama training, llama-1b
    check(l1b.rope_theta == 500000.0, "llama-1b preset")
    ltrain_cfg = dataclasses.replace(l1b, num_layers=LLAMA_TRAIN_LAYERS,
                                     attention_impl="flash", remat=True,
                                     remat_policy="dots")
    state, batch, opt, ltrain = train_steps("llama-1b", ltrain_cfg,
                                            *LLAMA_TRAIN_BATCH)
    lbatch = batch
    del state, opt
    torch.cuda.empty_cache()
    log_step("llama-1b", ltrain_cfg, llama, *LLAMA_TRAIN_BATCH, ltrain)
    phase_done(9)

    # ------------------------------------------ 10. llama training parity
    train_parity("llama-1b", dataclasses.replace(
        l1b, num_layers=2, dtype=torch.float32), l1b.vocab_size)
    phase_done(10)

    # ------------------------------------------------------------- 11. MoE
    # Mixtral-style experts at llama-1b width, depth 2, f32: the engine
    # routes dropless (every token to its top-2), the train step through
    # capacity queues.
    moe_kw = dict(llama_kw, num_layers=2, moe_num_experts=8, moe_top_k=2)
    cfg = LLMConfig(dtype="float32", **moe_kw)
    mcfg = cfg.model_config()
    check(mcfg.moe == MoEConfig(num_experts=8, top_k=2, activation="swiglu"),
          f"LLMConfig gave moe {mcfg.moe}")
    eng = build_engine("MoE llama f32 engine", cfg, lively(llama.init_params(
        mcfg, torch.Generator().manual_seed(5), dev), ("wq", "wk", "wv", "wo")))
    check(eng.model_config.moe.dropless, "the engine did not route dropless")
    graph_against_eager("MoE llama f32 engine (dropless)", llama, eng)
    greedy_matches_forward("MoE llama f32 engine (dropless)", llama, eng,
                           prompts_l, 8)
    del eng
    release()
    # Training routes through capacity queues with the router's jitter on:
    # three compiled steps (the noise, drawn outside the program, is a new
    # input each step and compiles nothing; updates 1 and 2 at a nonzero
    # lr) against three eager steps from the same init, within 2e-4
    # relative (f32), then their leaves and the compiled update.
    moe_train = dataclasses.replace(mcfg, attention_impl="flash", moe=(
        dataclasses.replace(mcfg.moe, router_jitter=0.01)))
    toks = torch.randint(0, mcfg.vocab_size, (2, 257), device=dev, generator=gen)
    runs, states, fns = {}, {}, {}
    for backend in ("auto", None):
        opt = opt_cfg.build()
        fns[backend] = make_train_step(moe_train, opt, seed=7, backend=backend)
        states[backend], runs[backend] = timed_steps(
            fns[backend],
            create_train_state(moe_train, opt, torch.Generator().manual_seed(6),
                               dev), {"tokens": toks}, 3)
    check_leaves("MoE llama train steps", states["auto"], fns["auto"],
                 fns[None], {"tokens": toks}, opt.schedule(3))
    check_update("MoE llama train steps", states["auto"], opt)
    state = states["auto"]
    del states, fns, opt
    moe_losses, moe_norms = runs["auto"]["losses"], runs["auto"]["norms"]
    moe_rel = max(abs(a - b) / abs(b) for k in ("losses", "norms")
                  for a, b in zip(runs["auto"][k], runs[None][k]))
    with torch.no_grad():
        _, moe_aux = llama.forward(state["params"], toks[:, :-1], moe_train)
    moe_aux = float(moe_aux)
    log(f"MoE llama train steps (capacity routing, 8 experts, top-2, router "
        f"jitter 0.01), compiled: losses {moe_losses}, grad norms {moe_norms}, "
        f"aux {moe_aux:.6f}, launches {runs['auto']['per_step']}; eager "
        f"losses {runs[None]['losses']}; max rel diff {moe_rel:.3e} (bound "
        "2e-4)")
    check(all(math.isfinite(x) for x in moe_losses + moe_norms)
          and moe_aux > 0.0 and moe_rel <= 2e-4,
          f"MoE train steps: losses {moe_losses}, aux {moe_aux}, rel diff "
          f"{moe_rel:.3e}")
    check(len(runs["auto"]["per_step"]) == 3 and all(
        c["flash_fwd_lse"] == 2 and c["flash_bwd_dq"] == 2
        and c["flash_bwd_dkv"] == 2 for c in runs["auto"]["per_step"]),
          f"MoE launches {runs['auto']['per_step']}")
    del state
    torch.cuda.empty_cache()
    phase_done(11)

    # ------------------------------- 12. main path: the OpenAI surface
    # GPT-2-small width, f32, lively random weights with the rows of wte
    # past the byte tokenizer's 258 ids zeroed: the tied head scores every
    # such id 0, so the generations are bytes and the responses hold text.
    attn.launches["flash_fwd"] = 0
    srv_cfg = LLMConfig(dtype="float32", **engine_kw)
    cfg_dict = srv_cfg.to_dict()
    sparams = lively(gpt2.init_params(srv_cfg.model_config(),
                                      torch.Generator().manual_seed(7), dev),
                     GPT2_LIVELY)
    with torch.no_grad():
        sparams["wte"][258:].zero_()
    srv = LLMServer(cfg_dict, params=sparams, device=dev)
    check(all(p.graph is not None for p in programs(srv.engine).values()),
          "LLMServer's engine runs uncaptured programs")
    tok = srv.engine.tokenizer
    prompt = "The OpenAI surface of the port, on the card: "
    single = {"prompt": prompt, "max_tokens": 16, "logprobs": 2}
    resp = srv.completions(single)
    choice, usage = resp["choices"][0], resp["usage"]
    lp, n = choice["logprobs"], usage["completion_tokens"]
    # what phase 16 serves again through Serve, on the same weights
    serve_ref = {"single": (single, lp["tokens"], choice["text"]),
                 "cfg_dict": cfg_dict}
    expect = forward_argmax(gpt2, srv.engine, tok.encode(prompt), 16)
    log(f"LLMServer completion {choice['text']!r}, tokens {lp['tokens']}")
    check(n >= 1 and lp["tokens"] == expect[:n],
          f"completion tokens {lp['tokens']} != K1 full-forward argmax {expect}")
    check(resp["object"] == "text_completion" and choice["text"] == tok.decode(
        lp["tokens"]) and usage["prompt_tokens"] == len(tok.encode(prompt))
        and usage["total_tokens"] == usage["prompt_tokens"] + n,
        f"completion envelope {resp}")
    check(len(lp["token_logprobs"]) == n and len(lp["top_logprobs"]) == n
          and all(len(d) == 2 for d in lp["top_logprobs"])
          and all(math.isfinite(x) and x <= 0 for x in lp["token_logprobs"]),
          f"logprobs block {lp}")
    messages = [{"role": "system", "content": "Answer in bytes."},
                {"role": "user", "content": "What runs on the card?"}]
    chat = srv.chat_completions({"messages": messages, "max_tokens": 16,
                                 "logprobs": 1})
    chat_tokens = chat["choices"][0]["logprobs"]["tokens"]
    expect = forward_argmax(gpt2, srv.engine,
                            tok.encode(srv._chat_prompt(messages)), 16)
    log(f"LLMServer chat {chat['choices'][0]['message']['content']!r}, "
        f"tokens {chat_tokens}")
    check(len(chat_tokens) >= 1 and chat_tokens == expect[:len(chat_tokens)],
          f"chat tokens {chat_tokens} != K1 full-forward argmax {expect}")
    check(chat["object"] == "chat.completion" and chat["choices"][0][
        "message"]["content"] == tok.decode(chat_tokens), f"chat envelope {chat}")
    payload = {"prompt": prompt, "max_tokens": 24}
    lines = list(srv({"body": json.dumps({**payload, "stream": True}),
                      "path": "/v1/completions"}))
    streamed = "".join(json.loads(line[len("data: "):])["choices"][0]["text"]
                       for line in lines[:-1])
    whole = srv.completions(payload)["choices"][0]["text"]
    log(f"LLMServer stream: {len(lines) - 1} chunks, joined {streamed!r}")
    check(lines[-1] == "data: [DONE]\n\n" and streamed == whole and whole,
          f"stream {streamed!r} != completion {whole!r}")
    serve_ref["stream"] = (payload, streamed)

    # Prefill/decode disaggregation: two more engines on the card, behind
    # in-process handles; a seeded stochastic request equals the
    # monolithic engine's.
    def handle(target):
        def method(name):
            def remote(*args):
                fut = Future()
                fut.set_result(getattr(target, name)(*args))
                return fut
            return SimpleNamespace(remote=remote)
        return SimpleNamespace(prefill=method("prefill"), decode=method("decode"))

    pre = PrefillServer(cfg_dict, params=sparams, device=dev)
    dec = DecodeServer(cfg_dict, params=sparams, device=dev)
    seeded = {"prompt": prompt, "max_tokens": 16, "temperature": 0.8,
              "top_p": 0.9, "seed": 5, "logprobs": 1}
    split = PDIngress(cfg_dict, handle(pre), handle(dec))(seeded)
    mono = srv.completions(seeded)
    log(f"PDIngress seeded top-p {split['choices'][0]['text']!r}, tokens "
        f"{split['choices'][0]['logprobs']['tokens']}")
    check(split["disaggregated"] and split["choices"] == mono["choices"]
          and split["usage"] == mono["usage"],
          f"PDIngress {split} != monolithic {mono}")
    pre.engine.shutdown()
    dec.engine.shutdown()
    del pre, dec
    release()

    # The batch stage over 16 prompts (its own engine, fresh weights from
    # seed 0): continuous batching gives each row what it gives alone.
    stage = _EngineStage(cfg_dict, dict(SamplingParams(max_new_tokens=16).__dict__),
                         "prompt", "out", device=dev)
    rows = [text[7 * i:7 * i + 12 + 5 * i] for i in range(16)]
    t = time.perf_counter()
    out = stage({"prompt": rows, "row": list(range(16))})
    stage_s = time.perf_counter() - t
    stage_eng = stage._engine()
    alone = [tok.decode(stage_eng.generate(tok.encode(r), SamplingParams(
        max_new_tokens=16))) for r in rows]
    log(f"_EngineStage: 16 rows in {stage_s:.3f} s")
    check(out["row"] == list(range(16)) and out["out"] == alone,
          "the batch stage's rows differ from the same prompts alone")
    stage_eng.shutdown()
    _EngineStage._engine_cache.clear()
    del stage, stage_eng
    release()

    # The requests' tokens/s of 16 concurrent completions through
    # LLMServer (phase 4's mix: a third greedy, top-p, seeded top-k).
    payloads = []
    for i, n in enumerate(np.random.RandomState(0).randint(8, 201, size=16)):
        p = {"prompt": text[i:i + int(n)], "max_tokens": 32}
        if i % 3 == 1:
            p.update(temperature=0.8, top_p=0.9)
        elif i % 3 == 2:
            p.update(temperature=1.0, top_k=50, seed=i)
        payloads.append(p)
    with ThreadPoolExecutor(len(payloads)) as pool:
        t = time.perf_counter()
        answers = list(pool.map(srv, payloads))
        concurrent_s = time.perf_counter() - t
    concurrent_tokens = sum(a["usage"]["completion_tokens"] for a in answers)
    check(all(a["usage"]["completion_tokens"] >= 1 for a in answers),
          "a concurrent completion returned nothing")
    serve_ref["mixed"] = (payloads, answers)
    serve_dir = tempfile.mkdtemp(prefix="phase16_")
    serve_ref["model_source"] = os.path.join(serve_dir, "gpt2_small.pkl")
    write_bundle(sparams, serve_ref["model_source"])
    srv.engine.shutdown()
    serving_launches = attn.launches["flash_fwd"]
    del srv, sparams
    release()
    log(f"[{card}] LLMServer (f32, graphed): 16 concurrent completions, "
        f"{concurrent_tokens} tokens in {concurrent_s:.3f} s = "
        f"{concurrent_tokens / concurrent_s:.1f} tok/s")
    log(f"[{card}] K1 launches on the OpenAI surface's path (phase 12, the "
        f"full-forward yardstick): {serving_launches}")
    check(serving_launches > 0, "K1 was not launched on the serving path")
    phase_done(12)

    # ---------------------------------------- 13. the parallel layer
    # (a) The ring's per-step body at llama-1b's training shape, every
    # rank's pieces in one process. Bounds: phase 2's bf16 contract (each
    # side rounds its output to bf16 and P to bf16 before PV: 1e-2 + 1e-2|x|)
    # holds for the ring's out, whose pieces are rounded to bf16 once more
    # before their f32 merge (2^-9 relative each, inside the same bound);
    # lse is f32 on both sides (LSE_TOL). The gradients are the sums of the
    # pieces' bf16 outputs in f32 (dq over key chunks, dk/dv over query
    # chunks), within GRAD_TOL's bf16 bound as K3/K4 against their plain
    # versions.
    RB, RT = LLAMA_TRAIN_BATCH
    RN = 4
    tl = RT // RN
    q, k, v = qkv(RB, RT, lh, lkv, ld, bf16)
    do = torch.randn(RB, RT, lh, ld, device=dev, generator=gen).to(bf16)
    ring_rows = {}
    for causal in (True, False):
        with torch.no_grad():
            ref_out, ref_lse = attn._flash_fwd_cuda(q, k, v, causal,
                                                    with_lse=True)
            ref_dq, ref_dk, ref_dv, _ = attn._flash_bwd_cuda(
                q, k, v, ref_out, ref_lse, do, causal)
        qc, kc, vc, dc = (x.split(tl, 1) for x in (q, k, v, do))

        def ring_fwd():
            return ring_body_fwd(qc, kc, vc, causal)

        def ring_bwd(out, lse):
            return ring_body_bwd(qc, kc, vc, dc, out, lse, causal)

        before = dict(attn.launches)
        with torch.no_grad():
            out, lse = ring_fwd()
            dq, dk, dv = ring_bwd(out, lse)
            torch.cuda.synchronize()
        counts = {n: attn.launches[n] - before[n] for n in attn.launches}
        pieces = RN * (RN + 1) // 2 if causal else RN * RN
        check(counts == {"flash_fwd": 0, "flash_fwd_lse": pieces,
                         "flash_bwd_dq": pieces, "flash_bwd_dkv": pieces},
              f"ring body causal={causal}: launches {counts}, want {pieces} "
              "each of K2, K4 and K3")
        errs_ring = {
            "out": close(out, ref_out, TOL["bfloat16"]),
            "lse": close(lse, ref_lse, LSE_TOL),
            "dq": close(dq, ref_dq, GRAD_TOL["bfloat16"]),
            "dk": close(dk, ref_dk, GRAD_TOL["bfloat16"]),
            "dv": close(dv, ref_dv, GRAD_TOL["bfloat16"]),
        }
        with torch.no_grad():    # device time: each from a CUDA graph
            fwd_ms = graph_ms(ring_fwd, reps=3)
            o_l = ring_fwd()
            bwd_ms = graph_ms(lambda: ring_bwd(*o_l), reps=3)
            whole_fwd = graph_ms(lambda: attn._flash_fwd_cuda(
                q, k, v, causal, with_lse=True), reps=3)
            whole_bwd = graph_ms(lambda: attn._flash_bwd_cuda(
                q, k, v, ref_out, ref_lse, do, causal), reps=3)
        ring_rows[causal] = dict(launches=counts, errs=errs_ring,
                                 fwd_ms=fwd_ms, bwd_ms=bwd_ms)
        log(f"[{card}] ring body B={RB} T={RT} ({RN} chunks of {tl}) H={lh} "
            f"Hkv={lkv} D={ld} bf16 causal={causal}: launches {counts}; "
            "max|ring-whole| " + ", ".join(
                f"{n} {e:.3e}" for n, (e, _) in errs_ring.items())
            + f" (bounds out {TOL['bfloat16']}, lse {LSE_TOL}, grads "
            f"{GRAD_TOL['bfloat16']} as atol + rtol|whole|); device ms (graph "
            f"replay), all ranks' pieces and merges on this card: forward "
            f"{fwd_ms:.4f} (whole-sequence "
            f"K2 {whole_fwd:.4f}), backward {bwd_ms:.4f} (whole-sequence K4 + "
            f"K3 {whole_bwd:.4f})")
        for n, (e, nbad) in errs_ring.items():
            check(nbad == 0, f"ring body causal={causal} {n}: {nbad} "
                  f"elements outside the bound, max err {e:.3e}")
    del q, k, v, do, ref_out, ref_lse, ref_dq, ref_dk, ref_dv, out, lse, dq
    del dk, dv, o_l, qc, kc, vc, dc
    torch.cuda.empty_cache()

    # (b) The mesh path at full width on a world-size-1 NCCL group (its
    # bootstrap on the loopback interface).
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    mesh = single_device_mesh("cuda")
    check(dist.get_backend() == "nccl" and dist.get_world_size() == 1,
          f"mesh group: {dist.get_backend()} of {dist.get_world_size()}")
    L = ltrain_cfg.num_layers
    want_mesh = {"flash_fwd": 0, "flash_fwd_lse": L, "flash_bwd_dkv": L,
                 "flash_bwd_dq": L}
    init = llama.init_params(ltrain_cfg, torch.Generator().manual_seed(0), dev)
    mesh_runs, mesh_launches = {}, dict.fromkeys(attn.launches, 0)
    # the first compiles (the default; the model does not communicate on a
    # mesh of one rank), the others run eagerly (backend=None): each
    # compile would take as long as the first
    for label, impl, steps, pm, backend in (
            ("mesh", "flash", 6, None, "auto"),
            ("mesh ring", "ring", 6, None, None),
            ("mesh ulysses", "ulysses", 6, None, None),
            ("mesh pipeline M=2", "flash", 1, 2, None)):
        cfg = dataclasses.replace(ltrain_cfg, attention_impl=impl)
        opt = opt_cfg.build()
        state = create_train_state(cfg, opt, params=copy.deepcopy(init),
                                   mesh=mesh)
        step = make_train_step(cfg, opt, mesh, pipeline_microbatches=pm,
                               backend=backend)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        state, run = timed_steps(step, state, lbatch, steps)
        run["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        for c in run["per_step"]:
            for n in c:
                mesh_launches[n] += c[n]
        mesh_runs[label] = run
        losses = run["losses"]
        # one step alone is its first (the allocator's growth included)
        step_ms = float(np.median(run["step_s"][1:] or run["step_s"])) * 1e3
        B, T = LLAMA_TRAIN_BATCH
        kind = "compiled" if backend else "eager"
        log(f"[{card}] train step llama-1b L={L} B={B} T={T} remat dots on "
            f"the world-size-1 mesh, {label}, {kind}: losses "
            + " ".join(f"{x:.4f}" for x in losses) + f"; grad norms "
            + " ".join(f"{x:.4f}" for x in run["norms"])
            + f"; {'median' if steps > 1 else 'first step'} {step_ms:.2f} ms "
            f"a step (step 0 {run['step_s'][0]:.1f} s), "
            f"{B * T / step_ms * 1e3:.0f} "
            f"tokens/s, peak memory {run['peak_gb']:.2f} GB; launches per "
            f"step {run['per_step'][0]}")
        check(all(math.isfinite(x) for x in losses + run["norms"]),
              f"{label}: non-finite loss or norm")
        check(steps == 1 or losses[-1] < losses[0],
              f"{label}: loss did not fall: {losses}")
        check(all(c == want_mesh for c in run["per_step"]),
              f"{label} launches {run['per_step']}, want {want_mesh}")
        rel = abs(losses[0] - ltrain["losses"][0]) / abs(ltrain["losses"][0])
        check(rel <= 2e-3, f"{label}: first loss {losses[0]} against phase "
              f"9's {ltrain['losses'][0]}: rel {rel:.3e} > 2e-3")
        log(f"{label}: first loss {losses[0]:.6f}, phase 9's compiled step "
            f"{ltrain['losses'][0]:.6f} on the same state and batch: rel "
            f"{rel:.3e} (bound 2e-3)")
        if label == "mesh":
            before = attn.launches["flash_fwd"]
            eval_loss = float(make_eval_step(cfg, mesh)(state["params"], lbatch))
            mesh_eval_launches = attn.launches["flash_fwd"] - before
            check(math.isfinite(eval_loss) and mesh_eval_launches == L,
                  f"mesh eval step: loss {eval_loss}, {mesh_eval_launches} K1 "
                  f"launches, want {L}")
            log(f"mesh eval step: loss {eval_loss:.4f}, K1 launches "
                f"{mesh_eval_launches}")
        del state, step, opt
        release()
    del init
    dist.destroy_process_group()
    base_ms = float(np.median(ltrain["step_s"][1:])) * 1e3
    log(f"[{card}] llama-1b phase 9 beside the mesh step: compiled "
        f"{base_ms:.2f} ms a step (peak {ltrain['peak_gb']:.2f} GB), eager "
        f"{float(np.median(ltrain['eager']['step_s'][1:])) * 1e3:.2f} ms "
        f"(peak {ltrain['eager']['peak_gb']:.2f} GB)")
    ring_launches = {n: sum(r["launches"][n] for r in ring_rows.values())
                     for n in attn.launches}
    phase_done(13)

    # ------------------------------------------------ 14. the runtime core
    # ----------------------------- 15. the trainer on the card, in its session
    def reference_loss(tokens):
        """Phase 5's compiled step (its programs, no new compile) on the
        seeded state of ``train_cfg``: the first loss."""
        st = create_train_state(train_cfg, opt_cfg.build(),
                                torch.Generator().manual_seed(0), dev)
        _, metrics = gtrain["step"](st, {"tokens": tokens})
        return float(metrics["loss"])

    def runtime_env_then_trainer(node_id):
        phase_done(14)
        release()
        renv = runtime_env_phase(card, DEVICE, MODEL)
        phase_done(17)
        release()
        return renv, trainer_phase(
            card, DEVICE, node_id, MODEL, TRAIN_BATCH, reference_loss,
            float(np.median(gtrain["step_s"][1:])) * 1e3)

    runtime = runtime_phase(card, DEVICE, MODEL, text,
                            concurrent_tokens / concurrent_s,
                            then=runtime_env_then_trainer)
    # the task path's count (the argmax check's launches are apart)
    runtime_launches = runtime["node_launches"]["flash_fwd"]
    check(runtime_launches > 0, "K1 was not launched on the runtime's path")
    renv, trained = runtime["then"]
    renv_launches = sum(renv["launches"].values())
    check(renv_launches > 0, "K1 was not launched on phase 17's path")
    trainer_launches = trained["launches"]
    phase_done(15)

    # ------------------------------------------------ 16. Serve on the card
    release()
    try:
        serving16 = serve_phase(card, DEVICE, serve_ref["cfg_dict"], serve_ref,
                                concurrent_tokens / concurrent_s,
                                runtime["actor_tok_s"])
    finally:
        shutil.rmtree(serve_dir, ignore_errors=True)
    serve_launches = serving16["launches"]
    phase_done(16)

    # ------------------------------------------------------ the kernels line
    def kernel_row(name, line, src, launches, err, ms, plain, bound, lib_ms):
        return {
            "name": name,
            "route": "cuda",
            "source": f"ray_tpu_torch/ops/csrc/{src}",
            "replaces": f"ray_tpu/ops/attention.py:{line}",
            "launches": launches,
            "max_abs_err": err,
            "ms": ms,
            "plain_ms": plain,
            "bound_ms": bound[0],
            "bound_by": bound[1],
            "library_ms": lib_ms,
        }

    def case_err(case):
        return max(e["max_abs_err"] for e in errs
                   if e["case"] == case and e["dtype"] == "bfloat16")

    # The top-level numbers are GPT-2 small's shapes (as before); "llama1b"
    # holds the same keys at llama-1b's shapes; "launches" is the sum of
    # the main paths, "launches_by_path" each.
    row = kernel_row("flash_fwd", 73, "flash_fwd.cu",
                     main_launches + llama_k1_launches + serving_launches
                     + eval_launches + mesh_eval_launches + runtime_launches
                     + renv_launches + serve_launches,
                     case_err("entry"),
                     k1["ms"], k1["plain_ms"], k1["bound"], k1["sdpa_ms"])
    row["launches_by_path"] = {"gpt2": main_launches, "llama": llama_k1_launches,
                               "serving": serving_launches, "eval": eval_launches,
                               "mesh_eval": mesh_eval_launches,
                               "runtime": runtime_launches,
                               "runtime_env": renv_launches,
                               "serve": serve_launches}
    row["llama1b"] = kernel_row(
        "flash_fwd", 73, "flash_fwd.cu", llama_k1_launches,
        case_err("llama1b-serve"), k1_llama["ms"], k1_llama["plain_ms"],
        k1_llama["bound"], k1_llama["sdpa_ms"])
    kernels = [row]
    for name, line, src, errs_of in (
            ("flash_fwd_lse", 174, "flash_fwd.cu", ("out", "lse")),
            ("flash_bwd_dkv", 208, "flash_bwd.cu", ("dk", "dv")),
            ("flash_bwd_dq", 265, "flash_bwd.cu", ("dq", "delta"))):
        for path, tr in (("GPT-2 small", gtrain), ("llama-1b", ltrain)):
            check(tr["launches"][name] > 0, f"{name} was not launched on the "
                  f"{path} training path")
        rows = {}
        for key, (ms, plain, lib, bounds), case, tr in (
                ("gpt2", gpt2_kernels, "train", gtrain),
                ("llama", llama_kernels, "llama1b-train", ltrain)):
            rows[key] = kernel_row(
                name, line, src, tr["launches"][name],
                max(train_errs[case][e] for e in errs_of), ms[name],
                plain[name], bounds[name], lib[name])
        check(ring_launches[name] > 0 and mesh_launches[name] > 0
              and trainer_launches[name] > 0,
              f"{name} was not launched on the ring body, the mesh path or "
              "the trainer's worker")
        row = dict(rows["gpt2"])
        row["launches"] = (rows["gpt2"]["launches"] + rows["llama"]["launches"]
                           + ring_launches[name] + mesh_launches[name]
                           + trainer_launches[name])
        row["launches_by_path"] = {"gpt2": rows["gpt2"]["launches"],
                                   "llama": rows["llama"]["launches"],
                                   "ring": ring_launches[name],
                                   "mesh": mesh_launches[name],
                                   "trainer": trainer_launches[name]}
        row["llama1b"] = rows["llama"]
        kernels.append(row)
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
