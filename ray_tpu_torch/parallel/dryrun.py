"""The multi-rank dry run and the rank launcher.

Counterpart of ``__graft_entry__.py:dryrun_multichip`` (legs 1-3):
``dryrun_multirank(n)`` spawns n gloo ranks on the CPU and runs, on mesh 1
(data x fsdp x tensor x stage, split by twos as the reference's
``_factor_axes`` splits them), one full train step of a tiny GPT-2 with
pipeline microbatches; on mesh 2 (seq x expert), a train step of a tiny MoE
GPT-2 with ring attention; and a dropless MoE cached decode (which, as in
the reference, takes no mesh). Every loss and logit must be finite.

``run_ranks`` is the launcher, which the CPU tests reuse: each rank is a
spawned process that joins a gloo group through a ``FileStore`` in a
temporary directory of its own (no port, so parallel launches never
collide), runs ``fn(rank, *args)`` and hands its result back.
"""
from __future__ import annotations

import dataclasses
import logging
import math
import os
import pickle
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, Dict, List

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _worker(fn: Callable, rank: int, n: int, root: str, args: tuple) -> None:
    torch.set_num_threads(1)
    # DTensor logs a warning per multi-dim reduction of a gradient
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(
        logging.ERROR)
    dist.init_process_group("gloo", rank=rank, world_size=n,
                            store=dist.FileStore(os.path.join(root, "store"), n))
    try:
        result = ("ok", fn(rank, *args))
    except BaseException:
        result = ("error", traceback.format_exc())
    with open(os.path.join(root, f"tmp{rank}"), "wb") as f:
        pickle.dump(result, f)
    os.replace(os.path.join(root, f"tmp{rank}"),
               os.path.join(root, f"rank{rank}"))
    if result[0] == "ok":
        dist.destroy_process_group()


def run_ranks(fn: Callable, n: int, *args, timeout: float = 600.0) -> List[Any]:
    """``fn(rank, *args)`` on n spawned gloo ranks of one default process
    group; the ranks' results in rank order. ``fn`` must be importable by
    name (a module-level function). A rank's exception is raised here with
    its traceback, after every rank is stopped; so is a run past
    ``timeout`` seconds."""
    root = tempfile.mkdtemp(prefix="rt_ranks_")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_worker, args=(fn, r, n, root, args))
             for r in range(n)]
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        results: Dict[int, Any] = {}
        while len(results) < n:
            for r in range(n):
                path = os.path.join(root, f"rank{r}")
                if r not in results and os.path.exists(path):
                    with open(path, "rb") as f:
                        results[r] = pickle.load(f)
                    if results[r][0] == "error":
                        raise RuntimeError(f"rank {r} of {n} failed:\n"
                                           f"{results[r][1]}")
            dead = [r for r, p in enumerate(procs)
                    if r not in results and not p.is_alive()]
            if dead and not os.path.exists(os.path.join(root, f"rank{dead[0]}")):
                raise RuntimeError(f"rank {dead[0]} of {n} exited with code "
                                   f"{procs[dead[0]].exitcode} and no result")
            if time.monotonic() > deadline:
                raise TimeoutError(f"ranks still running after {timeout} s")
            time.sleep(0.05)
        for p in procs:
            p.join(timeout=60)
        return [results[r][1] for r in range(n)]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(root, ignore_errors=True)


def _factor_axes(n: int) -> Dict[str, int]:
    """Split n ranks over (data, fsdp, tensor, stage) greedily by twos."""
    sizes = {"data": 1, "fsdp": 1, "tensor": 1, "stage": 1}
    order = ["tensor", "stage", "fsdp", "data"]
    i = 0
    while n % 2 == 0 and n > 1:
        sizes[order[i % len(order)]] *= 2
        n //= 2
        i += 1
    sizes["data"] *= n  # odd remainder
    return sizes


def _dryrun_rank(rank: int, n: int) -> Dict[str, float]:
    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.parallel.mesh import MeshConfig
    from ray_tpu_torch.parallel.moe import MoEConfig
    from ray_tpu_torch.train.step import (
        OptimizerConfig,
        create_train_state,
        make_train_step,
    )

    # --- mesh 1: dp x fsdp x tp x pp
    sizes = _factor_axes(n)
    mesh = MeshConfig(**sizes).build()
    heads = 2 * sizes["tensor"]
    config = gpt2.GPT2Config(
        vocab_size=512, max_seq_len=64, num_layers=max(2 * sizes["stage"], 2),
        num_heads=heads, embed_dim=heads * 16, dtype=torch.float32,
        attention_impl="xla")
    opt = OptimizerConfig().build()
    state = create_train_state(config, opt, torch.Generator().manual_seed(0),
                               "cpu", mesh=mesh)
    mb = 2 if sizes["stage"] > 1 else None
    step = make_train_step(config, opt, mesh, pipeline_microbatches=mb)
    rows = max(4, 2 * sizes["data"] * sizes["fsdp"] * (mb or 1))
    _, metrics = step(state, {"tokens": torch.zeros((rows, 33),
                                                    dtype=torch.long)})
    loss = float(metrics["loss"])
    if not math.isfinite(loss):
        raise AssertionError(f"dp/fsdp/tp/pp step produced loss={loss}")

    # --- mesh 2: sp (ring attention) x ep (MoE)
    sp = 2 if n % 2 == 0 else 1
    ep = max(n // sp, 1)
    mesh2 = MeshConfig(data=1, seq=sp, expert=ep).build()
    config2 = gpt2.GPT2Config(
        vocab_size=512, max_seq_len=64, num_layers=2, num_heads=4,
        embed_dim=64, dtype=torch.float32, attention_impl="ring",
        moe=MoEConfig(num_experts=max(ep, 2), top_k=2))
    state2 = create_train_state(config2, opt, torch.Generator().manual_seed(1),
                                "cpu", mesh=mesh2)
    _, metrics2 = make_train_step(config2, opt, mesh2)(
        state2, {"tokens": torch.zeros((4, 65), dtype=torch.long)})
    loss2 = float(metrics2["loss"])
    if not math.isfinite(loss2):
        raise AssertionError(f"sp/ep step produced loss={loss2}")

    # --- decode: dropless MoE KV-cache decode (no mesh, as in JAX)
    decode_cfg = dataclasses.replace(
        config2, attention_impl="xla",
        moe=dataclasses.replace(config2.moe, dropless=True))
    dparams = gpt2.init_params(decode_cfg, torch.Generator().manual_seed(2),
                               "cpu")
    cache = gpt2.init_kv_cache(decode_cfg, 2, 16, device="cpu")
    tokens = torch.zeros((2, 1), dtype=torch.long)
    starts = torch.zeros((2,), dtype=torch.long)
    with torch.no_grad():
        gpt2.forward_cached(dparams, tokens, cache, starts, decode_cfg)
        logits, _ = gpt2.forward_cached(dparams, tokens + 1, cache, starts + 1,
                                        decode_cfg)
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("MoE decode produced non-finite logits")
    return {"loss": loss, "loss2": loss2}


def dryrun_multirank(n: int = 4) -> List[Dict[str, float]]:
    """Legs 1-3 of the reference's dry run on n gloo ranks (see the module's
    docstring); returns each rank's losses and raises on a failure."""
    out = run_ranks(_dryrun_rank, n, n)
    sizes = _factor_axes(n)
    print(f"dryrun_multirank({n}) ok: dp{sizes['data']}/fsdp{sizes['fsdp']}/"
          f"tp{sizes['tensor']}/pp{sizes['stage']} loss={out[0]['loss']:.4f}; "
          f"sp/ep loss={out[0]['loss2']:.4f}; moe decode ok")
    return out
