"""The port's side of tests/test_torch_parallel.py and
tests/test_torch_ring.py: the bodies that 4 gloo ranks run
(``ray_tpu_torch.parallel.dryrun.run_ranks``), with the cases' shapes.

A spawned rank imports the module of its body; this one imports no JAX,
so a rank starts in the time torch and the port take to import. The test
of the launcher itself is here too.
"""
import dataclasses
import os
import pickle

import filelock
import numpy as np
import pytest
import torch
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Shard

from ray_tpu_torch.models import convert
from ray_tpu_torch.models import gpt2 as tgpt2
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.ops import attention as attn
from ray_tpu_torch.parallel.dryrun import run_ranks
from ray_tpu_torch.parallel.mesh import MeshConfig
from ray_tpu_torch.parallel.moe import MoEConfig
from ray_tpu_torch.parallel.ring_attention import (
    ring_attention,
    ulysses_attention,
)
from ray_tpu_torch.parallel.mesh import (
    axis_index,
    mesh_shape,
    single_device_mesh,
)
from ray_tpu_torch.parallel.sharding import (
    local_shard,
    reduce_grads,
    replicated,
    shard_batch_spec,
    with_sharding_constraint,
)
from ray_tpu_torch.train.step import (
    OptimizerConfig,
    create_train_state,
    make_train_step,
)

N = 4
TINY = dict(vocab_size=512, max_seq_len=128, num_layers=2, num_heads=2,
            embed_dim=64, attention_impl="xla")
PIPE = dict(TINY, num_layers=4, remat=False)
MOE = dict(num_experts=4, top_k=2)
# capacity queues half the size of the routed load: tokens are dropped
MOE_DROP = dict(MOE, capacity_factor=0.5)
LLAMA = dict(vocab_size=512, max_seq_len=128, num_layers=2, num_heads=4,
             num_kv_heads=2, embed_dim=64, attention_impl="xla")

# name: (mesh axes, family, model kwargs, pipeline microbatches)
TRAIN_CASES = {
    "fsdp2-tensor2": (dict(data=1, fsdp=2, tensor=2), "gpt2", TINY, None),
    "data4": (dict(data=4), "gpt2", TINY, None),
    "expert4": (dict(data=1, expert=4), "gpt2-moe", TINY, None),
    "stage2-expert2": (dict(data=1, stage=2, expert=2), "gpt2-moe", PIPE, 2),
    "llama-data2-tensor2": (dict(data=2, tensor=2), "llama", LLAMA, None),
}
STEPS = 3
# a layout other than DEFAULT_RULES' for the fsdp2-tensor2 mesh
RULES = {"embed": None, "vocab": "fsdp", "heads": None}

GPT2_RING = dict(vocab_size=512, max_seq_len=128, num_layers=2, num_heads=2,
                 embed_dim=64, attention_impl="ring")
LLAMA_SEQ = dict(vocab_size=512, max_seq_len=128, num_layers=2, num_heads=4,
                 num_kv_heads=2, embed_dim=64)
ATTN_CASES = [("ring", True, 4), ("ring", False, 4), ("ring", True, 2),
              ("ulysses", True, 4), ("ulysses", True, 2)]




def torch_cfg(family, kw):
    """The port's f32 config of a case ("gpt2", "gpt2-moe",
    "gpt2-moe-drop" or "llama")."""
    if family == "llama":
        return dataclasses.replace(tllama.LlamaConfig(**kw),
                                   dtype=torch.float32)
    moe = {"gpt2-moe": MoEConfig(**MOE),
           "gpt2-moe-drop": MoEConfig(**MOE_DROP)}.get(family)
    return tgpt2.GPT2Config(**kw, moe=moe, dtype=torch.float32)


def shared_results(tmp_path_factory, name, compute):
    """``compute()``'s result, computed once per test session: pytest-xdist
    hands a module's tests to several workers, and each would otherwise
    spawn its own ranks. The first worker computes under a file lock in
    the session's temporary directory; the others read its result."""
    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent            # shared by the session's workers
    path = root / f"{name}.pkl"
    with filelock.FileLock(str(path) + ".lock"):
        if path.exists():
            with open(path, "rb") as f:
                return pickle.load(f)
        result = compute()
        with open(path, "wb") as f:
            pickle.dump(result, f)
        return result


def _chunk(x, idx, n, dim=1):
    return torch.from_numpy(np.ascontiguousarray(x)).chunk(n, dim)[idx]


def parallel_body(rank, data):
    out = {}
    # the GPipe loop on stage=4: logits, and the gradients of the loss
    mesh = MeshConfig(data=1, stage=N).build()
    cfg = torch_cfg("gpt2", PIPE)
    params = convert.params_from_numpy(data["gpt2-pipe"], cfg, device="cpu")
    with torch.no_grad():
        logits, _ = tgpt2.forward_pipelined(
            params, torch.from_numpy(data["pipe_tokens"]).long(), cfg,
            mesh=mesh, num_microbatches=4)
    out["pipe_logits"] = logits.numpy()
    opt = OptimizerConfig(learning_rate=1e-3).build()
    state = create_train_state(cfg, opt, params=params, mesh=mesh)
    loss = tgpt2.loss_fn(state["params"], {"tokens": data["train_tokens"]},
                         cfg, pipeline_microbatches=4, mesh=mesh)
    loss.backward()
    reduce_grads(state["params"])
    out["pipe_loss"] = float(loss.detach())
    out["pipe_grads"] = {n: p.grad.full_tensor().numpy()
                         for n, p in state["params"].named_parameters()}

    # the MoE forward: expert=4, and the GPipe loop on stage=2 x expert=2
    cfg = torch_cfg("gpt2-moe", TINY)
    mesh = MeshConfig(data=1, expert=N).build()
    toks = torch.from_numpy(data["pipe_tokens"]).long()
    with torch.no_grad():
        state = create_train_state(cfg, opt, params=convert.params_from_numpy(
            data["gpt2-moe"], cfg, device="cpu"), mesh=mesh)
        out["moe_logits"], out["moe_aux"] = (
            x.numpy() for x in tgpt2.forward(state["params"], toks, cfg,
                                             mesh=mesh))
        out["moe_loss"] = float(tgpt2.loss_fn(
            state["params"], {"tokens": data["train_tokens"]}, cfg,
            mesh=mesh))
        cfg = torch_cfg("gpt2-moe", PIPE)
        mesh = MeshConfig(data=1, stage=2, expert=2).build()
        state = create_train_state(cfg, opt, params=convert.params_from_numpy(
            data["gpt2-moe-pipe"], cfg, device="cpu"), mesh=mesh)
        out["moe_pipe_logits"], out["moe_pipe_aux"] = (
            x.numpy() for x in tgpt2.forward_pipelined(
                state["params"], toks, cfg, mesh=mesh, num_microbatches=2))
        out["moe_pipe_loss"] = float(tgpt2.loss_fn(
            state["params"], {"tokens": data["train_tokens"]}, cfg,
            pipeline_microbatches=2, mesh=mesh))
        # the GPipe loop over data=2 x stage=2 with capacity queues that
        # drop tokens: each data rank passes its shard of the batch
        cfg = torch_cfg("gpt2-moe-drop", PIPE)
        mesh = MeshConfig(data=2, stage=2).build()
        spec = shard_batch_spec(mesh)
        state = create_train_state(cfg, opt, params=convert.params_from_numpy(
            data["gpt2-moe-pipe"], cfg, device="cpu"), mesh=mesh)
        out["moe_drop_rank"] = axis_index(mesh, "data")
        out["moe_drop_logits"], out["moe_drop_aux"] = (
            x.numpy() for x in tgpt2.forward_pipelined(
                state["params"], local_shard(toks, spec), cfg, mesh=mesh,
                num_microbatches=2))
        out["moe_drop_loss"] = float(tgpt2.loss_fn(
            state["params"], {"tokens": local_shard(torch.from_numpy(
                data["train_tokens"]).long(), spec)}, cfg,
            pipeline_microbatches=2, mesh=mesh))
        # the same over M=3 microbatches of a batch of 12: each rank's 6
        # rows hold 2 of its own shards and 1 of its peer's, so the
        # exchange moves parts of uneven size
        out["moe_drop3_logits"], out["moe_drop3_aux"] = (
            x.numpy() for x in tgpt2.forward_pipelined(
                state["params"], local_shard(torch.from_numpy(
                    data["pipe12_tokens"]).long(), spec), cfg, mesh=mesh,
                num_microbatches=3))
    # its gradients, through the inverse exchange
    loss = tgpt2.loss_fn(state["params"], {"tokens": local_shard(
        torch.from_numpy(data["train12_tokens"]).long(), spec)}, cfg,
        pipeline_microbatches=3, mesh=mesh)
    loss.backward()
    reduce_grads(state["params"])
    out["moe_drop3_loss"] = float(loss.detach())
    # (the dense MLP's leaves, unused beside the experts, get none)
    out["moe_drop3_grads"] = {
        n: None if p.grad is None else p.grad.full_tensor().numpy()
        for n, p in state["params"].named_parameters()}

    # three train steps on each mesh
    for name, (axes, family, kw, pm) in TRAIN_CASES.items():
        cfg = torch_cfg(family, kw)
        mesh = MeshConfig(**axes).build()
        state = create_train_state(cfg, opt, params=convert.params_from_numpy(
            data[name], cfg, device="cpu"), mesh=mesh)
        step = make_train_step(cfg, opt, mesh, pipeline_microbatches=pm)
        metrics = []
        for _ in range(STEPS):
            state, m = step(state, {"tokens": data["train_tokens"]})
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
        out[name] = metrics

    # the data=4 step compiled (traced by aot_eager: the model does not
    # communicate there), and a model that does, which must run eagerly
    cfg = torch_cfg("gpt2", TINY)
    mesh4 = MeshConfig(data=4).build()
    state = create_train_state(cfg, opt, params=convert.params_from_numpy(
        data["data4"], cfg, device="cpu"), mesh=mesh4)
    step = make_train_step(cfg, opt, mesh4, backend="aot_eager")
    metrics = []
    for _ in range(STEPS):
        state, m = step(state, {"tokens": data["train_tokens"]})
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    out["data4-aot_eager"] = metrics
    mesh = MeshConfig(data=1, stage=2, expert=2).build()
    try:
        make_train_step(torch_cfg("gpt2-moe", PIPE), opt, mesh,
                        pipeline_microbatches=2, backend="aot_eager")
        out["communicating_compile"] = None
    except ValueError as e:
        out["communicating_compile"] = str(e)

    # the mesh's shape, and a plain tensor constrained by the rules (the
    # batch's rows over data=4) or replicated
    out["mesh_shape"] = mesh_shape(mesh)
    x = torch.arange(32.0).reshape(8, 4)
    out["constrained"] = [
        with_sharding_constraint(x, mesh4, ("batch", None)).to_local().numpy(),
        tuple(replicated(mesh4).placements)]

    # rules with the mesh: the step places parameters and moments by them
    # before it runs, as JAX's step constrains its parameters
    cfg = torch_cfg("gpt2", TINY)
    mesh = MeshConfig(data=1, fsdp=2, tensor=2).build()
    state = create_train_state(cfg, opt, params=convert.params_from_numpy(
        data["fsdp2-tensor2"], cfg, device="cpu"), mesh=mesh)
    step = make_train_step(cfg, opt, mesh, rules=RULES)
    metrics = []
    for _ in range(STEPS):
        state, m = step(state, {"tokens": data["train_tokens"]})
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    out["rules"] = metrics
    out["rules_placements"] = {
        n: (tuple(p.placements), tuple(state["opt_state"]["exp_avg"][i].placements))
        for i, (n, p) in enumerate(state["params"].named_parameters())}
    return out



def ring_body(rank, data):
    """Every case on this rank: its chunk of each output and gradient."""
    out = {}
    mesh = MeshConfig(data=1, seq=N).build()
    idx = mesh.get_local_rank("seq")
    for impl, causal, hkv in ATTN_CASES:
        q, k, v, do = data["qkv"][hkv]
        ql, kl, vl = (_chunk(x, idx, N).requires_grad_() for x in (q, k, v))
        fn = ring_attention if impl == "ring" else ulysses_attention
        o = fn(ql, kl, vl, mesh=mesh, causal=causal)
        (o * _chunk(do, idx, N)).sum().backward()
        out[(impl, causal, hkv)] = [t.detach().numpy()
                                    for t in (o, ql.grad, kl.grad, vl.grad)]
    try:
        ulysses_attention(*(torch.zeros(1, 8, 2, 16) for _ in range(3)),
                          mesh=mesh)
        out["ulysses_heads_error"] = None
    except ValueError as e:
        out["ulysses_heads_error"] = str(e)

    # the custom ops on DTensors: batch (B=4) or heads (H=4) sharded over a
    # 1-D mesh of the 4 ranks, forward and backward (DTensor expands each
    # strategy over every mesh dim: 3^6 combinations on the 6-axis mesh)
    flat = init_device_mesh("cpu", (N,), mesh_dim_names=("x",))
    q, k, v, do = data["dtensor_qkv"]
    for dim in (0, 2):
        dts = [DTensor.from_local(_chunk(x, rank, N, dim), flat, [Shard(dim)])
               for x in (q, k, v, do)]
        leaves = [t.detach().requires_grad_() for t in dts[:3]]
        o = attn.flash_attention(*leaves, True)
        (o * dts[3]).sum().backward()
        with torch.no_grad():
            o1 = attn.flash_attention(*dts[:3], True)
        out[("dtensor", dim)] = [t.full_tensor().detach().numpy() for t in
                                 (o, o1, *(x.grad for x in leaves))]

    # models with a sequence sharded over seq=2, batch over data=2
    mesh2 = MeshConfig(data=2, seq=2).build()
    bi, si = mesh2.get_local_rank("data"), mesh2.get_local_rank("seq")
    toks = _chunk(_chunk(data["tokens"], bi, 2, 0), si, 2, 1).long()
    for name, mod, cfg, tree in (
            ("gpt2-ring", tgpt2, tgpt2.GPT2Config(**GPT2_RING), data["gpt2"]),
            ("llama-ring", tllama, tllama.LlamaConfig(
                **LLAMA_SEQ, attention_impl="ring"), data["llama"]),
            ("llama-ulysses", tllama, tllama.LlamaConfig(
                **LLAMA_SEQ, attention_impl="ulysses"), data["llama"])):
        cfg = dataclasses.replace(cfg, dtype=torch.float32)
        params = convert.params_from_numpy(tree, cfg, device="cpu")
        with torch.no_grad():
            logits, _ = mod.forward(params, toks, cfg, mesh=mesh2)
        out[name] = logits.numpy()

    # three train steps of the ring GPT-2 on data=2 x seq=2
    cfg = dataclasses.replace(tgpt2.GPT2Config(**GPT2_RING), dtype=torch.float32)
    opt = OptimizerConfig(learning_rate=1e-3).build()
    state = create_train_state(cfg, opt, params=convert.params_from_numpy(
        data["gpt2"], cfg, device="cpu"), mesh=mesh2)
    step = make_train_step(cfg, opt, mesh2)
    metrics = []
    for _ in range(3):
        state, m = step(state, {"tokens": data["train_tokens"]})
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    out["ring_train"] = metrics
    return out




def _echo_or_fail(rank, fail_rank):
    if rank == fail_rank:
        raise ValueError(f"rank {rank} fails on purpose")
    return rank * 10


def _single(rank):
    mesh = single_device_mesh("cpu")
    return mesh_shape(mesh), mesh.device_type


def test_single_device_mesh_on_one_rank():
    """The world-size-1 mesh: every axis 1, the gloo group's device type."""
    [(shape, device_type)] = run_ranks(_single, 1)
    assert shape == dict.fromkeys(
        ("data", "fsdp", "stage", "tensor", "seq", "expert"), 1)
    assert device_type == "cpu"


def test_run_ranks_raises_a_ranks_error():
    """The launcher raises a rank's exception in the caller with its
    traceback and stops every rank (its results in rank order are what
    the other tests of the parallel layer read)."""
    with pytest.raises(RuntimeError, match="rank 1 of 2 failed"):
        run_ranks(_echo_or_fail, 2, 1, timeout=120)
