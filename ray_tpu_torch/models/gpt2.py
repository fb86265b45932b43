"""GPT-2 in PyTorch: the model the port serves and trains.

Counterpart of ``ray_tpu/models/gpt2.py``: learned positional embeddings,
pre-LN transformer blocks, tanh-GELU MLP (or, with ``moe``, routed experts,
``parallel/moe.py``), weight-tied LM head.
The parameters keep the JAX tree's names and layouts (``qkv_w`` is
[L, E, 3, H, D], ``proj_w`` [L, H, D, E], every block parameter stacked on
a leading L), so a JAX ``init_params`` tree converts one to one
(``models/convert.py``). The layer ``scan`` is a Python loop over the
stacked weights. Activations run in ``config.dtype`` over ``param_dtype``
parameters, each weight cast to the activation dtype where it is used.
Training goes through ``loss_fn`` (vocabulary-chunked cross entropy over
``forward_features``), with each block checkpointed by ``remat_policy``.

With ``mesh=`` the functions are the body of an SPMD program over the
mesh's ranks (``parallel/``): tokens and batch are this rank's shard
(``sharding.shard_batch_spec``: rows over data and fsdp, the sequence over
seq), outputs are that shard's, the loss is the whole batch's on every
rank, and ``params`` are DTensors placed by ``param_axes`` (or plain
tensors, the whole value on every rank), gathered where they are used.
Attention over a sharded sequence is ring or Ulysses attention
(``attention_impl``); ``forward_pipelined`` runs the blocks as a GPipe
loop over the "stage" axis.

The functions take ``params`` as anything indexable by the JAX names: a
``GPT2`` module or a nested dict of tensors.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ray_tpu_torch._private.device import DeviceLike, resolve_device
from ray_tpu_torch.models import common
from ray_tpu_torch.ops.attention import attention
from ray_tpu_torch.ops.xent import chunked_softmax_xent
from ray_tpu_torch.parallel.moe import (
    MoEConfig,
    init_moe_params,
    moe_layer,
    moe_param_axes,
    moe_param_shapes,
)
from ray_tpu_torch.parallel.pipeline import pipeline_apply


BLOCK_PARAMS = (
    "ln1_g", "ln1_b", "qkv_w", "qkv_b", "proj_w", "proj_b",
    "ln2_g", "ln2_b", "fc_w", "fc_b", "out_w", "out_b",
)


@dataclass(frozen=True)
class GPT2Config:
    vocab_size: int = 50304
    max_seq_len: int = 1024
    num_layers: int = 12
    num_heads: int = 12
    embed_dim: int = 768
    mlp_ratio: int = 4
    dtype: torch.dtype = torch.bfloat16        # activation dtype
    param_dtype: torch.dtype = torch.float32
    # auto | xla | flash | flash_interpret | ring | ulysses
    attention_impl: str = "auto"
    # Activation checkpointing of each block in training (forward_features).
    # "dots": keep the outputs of the projections (matrix products with no
    # batch dims) and of the flash forward (out, lse), recompute the
    # elementwise ops; "dots_all": keep batched products too; "full": keep
    # only the block's inputs and re-run the whole block, attention forward
    # included, in the backward.
    remat: bool = True
    remat_policy: str = "dots"
    seq_axis: str = "seq"            # mesh axis for ring/ulysses
    moe: Optional[MoEConfig] = None  # routed experts in place of each MLP

    def __post_init__(self):
        if self.remat_policy not in common.POLICIES:
            raise ValueError(f"unknown remat_policy {self.remat_policy!r}; "
                             f"one of {common.POLICIES}")

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads

    @property
    def mlp_dim(self) -> int:
        return self.embed_dim * self.mlp_ratio


GPT2_SMALL = GPT2Config(num_layers=12, num_heads=12, embed_dim=768)
GPT2_MEDIUM = GPT2Config(num_layers=24, num_heads=16, embed_dim=1024)
GPT2_LARGE = GPT2Config(num_layers=36, num_heads=20, embed_dim=1280)
GPT2_XL = GPT2Config(num_layers=48, num_heads=25, embed_dim=1600)
GPT2_TINY = GPT2Config(  # test size
    vocab_size=512, max_seq_len=128, num_layers=2, num_heads=2, embed_dim=64
)

PRESETS = {
    "gpt2-tiny": GPT2_TINY,
    "gpt2-small": GPT2_SMALL,
    "gpt2-medium": GPT2_MEDIUM,
    "gpt2-large": GPT2_LARGE,
    "gpt2-xl": GPT2_XL,
}


def param_shapes(config: GPT2Config) -> Dict[str, Any]:
    """The parameter tree's shapes, named as in the JAX package."""
    E, H, M, V, L = (config.embed_dim, config.num_heads, config.mlp_dim,
                     config.vocab_size, config.num_layers)
    D = config.head_dim
    return {
        "wte": (V, E),
        "wpe": (config.max_seq_len, E),
        "blocks": {
            "ln1_g": (L, E), "ln1_b": (L, E),
            "qkv_w": (L, E, 3, H, D), "qkv_b": (L, 3, H, D),
            "proj_w": (L, H, D, E), "proj_b": (L, E),
            "ln2_g": (L, E), "ln2_b": (L, E),
            "fc_w": (L, E, M), "fc_b": (L, M),
            "out_w": (L, M, E), "out_b": (L, E),
            **({"moe": moe_param_shapes(E, M, config.moe, L)}
               if config.moe is not None else {}),
        },
        "ln_f_g": (E,),
        "ln_f_b": (E,),
    }


def param_axes(config: GPT2Config) -> Dict[str, Any]:
    """Logical axis names per parameter (see ``sharding.DEFAULT_RULES``),
    the JAX ``param_axes``'s tree."""
    axes = {
        "wte": ("vocab", "embed"),
        "wpe": (None, "embed"),
        "blocks": {
            "ln1_g": ("stage", "norm"),
            "ln1_b": ("stage", "norm"),
            "qkv_w": ("stage", "embed", None, "heads", "head_dim"),
            "qkv_b": ("stage", None, "heads", "head_dim"),
            "proj_w": ("stage", "heads", "head_dim", "embed"),
            "proj_b": ("stage", "norm"),
            "ln2_g": ("stage", "norm"),
            "ln2_b": ("stage", "norm"),
            "fc_w": ("stage", "embed", "mlp"),
            "fc_b": ("stage", "mlp"),
            "out_w": ("stage", "mlp", "embed"),
            "out_b": ("stage", "norm"),
        },
        "ln_f_g": ("norm",),
        "ln_f_b": ("norm",),
    }
    if config.moe is not None:
        axes["blocks"]["moe"] = moe_param_axes(
            num_layers=config.num_layers, config=config.moe)
    return axes


def init_params(config: GPT2Config, generator: Optional[torch.Generator] = None,
                device: DeviceLike = "cuda") -> "GPT2":
    """Fresh parameters: normal(0.02) embeddings and projections,
    residual-scaled output projections (std 0.02 / sqrt(2L)), unit norms,
    zero biases, as the JAX ``init_params``; with ``moe``, expert weights
    as well (the dense MLP's stay, unused, as in JAX). Drawn on the CPU from
    ``generator`` (seed 0 when None), so a seed gives the same weights on
    every device. The JAX and torch generators differ: tests that need the
    same weights in both convert the JAX tree instead."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    pd = config.param_dtype
    std = 0.02
    res_std = std / (2 * config.num_layers) ** 0.5
    shapes = param_shapes(config)

    def normal(shape, s=std):
        return (torch.randn(shape, generator=generator, dtype=torch.float32)
                * s).to(pd)

    b = shapes["blocks"]
    tree = {
        "wte": normal(shapes["wte"]),
        "wpe": normal(shapes["wpe"], 0.01),
        "blocks": {
            "ln1_g": torch.ones(b["ln1_g"], dtype=pd),
            "ln1_b": torch.zeros(b["ln1_b"], dtype=pd),
            "qkv_w": normal(b["qkv_w"]),
            "qkv_b": torch.zeros(b["qkv_b"], dtype=pd),
            "proj_w": normal(b["proj_w"], res_std),
            "proj_b": torch.zeros(b["proj_b"], dtype=pd),
            "ln2_g": torch.ones(b["ln2_g"], dtype=pd),
            "ln2_b": torch.zeros(b["ln2_b"], dtype=pd),
            "fc_w": normal(b["fc_w"]),
            "fc_b": torch.zeros(b["fc_b"], dtype=pd),
            "out_w": normal(b["out_w"], res_std),
            "out_b": torch.zeros(b["out_b"], dtype=pd),
        },
        "ln_f_g": torch.ones(shapes["ln_f_g"], dtype=pd),
        "ln_f_b": torch.zeros(shapes["ln_f_b"], dtype=pd),
    }
    if config.moe is not None:
        tree["blocks"]["moe"] = init_moe_params(
            generator, config.embed_dim, config.mlp_dim, config.moe, pd,
            num_layers=config.num_layers)
    return GPT2(config, tree, device=dev)


class GPT2(nn.Module):
    """The parameter tree as a module. ``model["wte"]`` and
    ``model["blocks"]["qkv_w"]`` index it as the JAX dict is indexed;
    ``model(tokens)`` is ``forward(model, tokens, config)``."""

    def __init__(self, config: GPT2Config, tree: Dict[str, Any],
                 device: DeviceLike = "cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.config = config
        shapes = param_shapes(config)

        def param(x, shape, name):
            if tuple(x.shape) != tuple(shape):
                raise ValueError(
                    f"parameter {name}: shape {tuple(x.shape)}, config wants "
                    f"{tuple(shape)}"
                )
            return nn.Parameter(x.to(dev))

        self.wte = param(tree["wte"], shapes["wte"], "wte")
        self.wpe = param(tree["wpe"], shapes["wpe"], "wpe")
        self.blocks = nn.ParameterDict({
            n: param(tree["blocks"][n], shapes["blocks"][n], f"blocks.{n}")
            for n in BLOCK_PARAMS
        })
        if config.moe is not None:
            self.blocks["moe"] = nn.ParameterDict({
                n: param(tree["blocks"]["moe"][n], shape, f"blocks.moe.{n}")
                for n, shape in shapes["blocks"]["moe"].items()
            })
        self.ln_f_g = param(tree["ln_f_g"], shapes["ln_f_g"], "ln_f_g")
        self.ln_f_b = param(tree["ln_f_b"], shapes["ln_f_b"], "ln_f_b")

    def __getitem__(self, name: str):
        return getattr(self, name)

    def forward(self, tokens: torch.Tensor):
        return forward(self, tokens, self.config)


def _layer_norm(x, g, b, eps=1e-5):
    """f32 layer norm with population variance; g and b stay f32 until the
    final cast to x's dtype."""
    x32 = x.to(torch.float32)
    mean = x32.mean(-1, keepdim=True)
    var = x32.var(-1, keepdim=True, unbiased=False)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return (y * g + b).to(x.dtype)


def _qkv(layer, h):
    """[B, T, E] -> (q, k, v) each [B, T, H, D] (views of one tensor)."""
    qkv = torch.einsum("bte,eshd->btshd", h, layer["qkv_w"].to(h.dtype))
    qkv = qkv + layer["qkv_b"].to(h.dtype)
    return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]


def _attn_residual(layer, x, attn):
    """Output projection + residual add."""
    attn = torch.einsum("bthd,hde->bte", attn, layer["proj_w"].to(x.dtype))
    return x + attn + layer["proj_b"].to(x.dtype)


def _mlp_residual(config: GPT2Config, layer, x, noise=None, mesh=None):
    """ln2 + MLP (or MoE) + residual. Returns (x, aux loss); the aux loss is
    MoE's (0.0 for the dense MLP); ``noise`` is the router's jitter noise."""
    h = _layer_norm(x, layer["ln2_g"], layer["ln2_b"])
    if config.moe is not None:
        h, aux = moe_layer(layer["moe"], h, config.moe, noise=noise, mesh=mesh)
        return x + h, aux
    h = torch.einsum("bte,em->btm", h, layer["fc_w"].to(h.dtype))
    # jax.nn.gelu's default is the tanh approximation
    h = F.gelu(h + layer["fc_b"].to(h.dtype), approximate="tanh")
    h = torch.einsum("btm,me->bte", h, layer["out_w"].to(h.dtype))
    return x + h + layer["out_b"].to(h.dtype), 0.0


def _block(config: GPT2Config, mesh, x, layer, noise=None):
    """One transformer block. x: [B, T, E]; layer: one slice of the stacked
    block parameters; ``noise`` ([B*T, experts] or None) is the MoE
    router's jitter noise, an input, so a re-run under checkpointing adds
    the same noise."""
    h = _layer_norm(x, layer["ln1_g"], layer["ln1_b"])
    q, k, v = _qkv(layer, h)
    attn = common.attention_dispatch(config, q, k, v, mesh)
    x = _attn_residual(layer, x, attn)
    return _mlp_residual(config, layer, x, noise, mesh)


def _layer(params, i: int) -> Dict[str, Any]:
    blocks = params["blocks"]
    layer = {n: blocks[n][i] for n in BLOCK_PARAMS}
    if "moe" in blocks:
        layer["moe"] = {n: w[i] for n, w in blocks["moe"].items()}
    return layer


def _embed(params, tokens: torch.Tensor, config: GPT2Config, mesh):
    T = tokens.shape[1]
    off = common.seq_offset(mesh, T)
    x = params["wte"][tokens].to(config.dtype)
    return x + params["wpe"][off:off + T][None].to(config.dtype)


def _trunk(params, tokens: torch.Tensor, config: GPT2Config,
           router_noise: Optional[torch.Tensor], mesh):
    x = _embed(params, tokens, config, mesh)
    aux = 0.0
    block = common.checkpointed(functools.partial(_block, config, mesh),
                                config.remat, config.remat_policy)
    for i, layer in enumerate(common.layers(params["blocks"],
                                            config.num_layers)):
        noise = None if router_noise is None else router_noise[i]
        x, layer_aux = block(x, layer, noise)
        aux = aux + layer_aux
    x = _layer_norm(x, params["ln_f_g"], params["ln_f_b"])
    return x, aux


def forward_features(params, tokens: torch.Tensor, config: GPT2Config,
                     router_noise: Optional[torch.Tensor] = None, mesh=None):
    """tokens [B, T] int -> (final-trunk features [B, T, E], aux loss).
    Under autograd each block runs under ``config.remat``/``remat_policy``;
    the loss path consumes the features directly (``ops/xent.py``), so the
    [B, T, V] logits never materialise. ``router_noise``
    (``common.router_noise``'s [L, B*T, experts], over the whole batch's
    tokens) feeds the MoE router's jitter."""
    return _trunk(common.mesh_params(params, mesh, False), tokens, config,
                  router_noise, mesh)


def _head(params, x):
    logits = torch.einsum("bte,ve->btv", x, params["wte"].to(x.dtype))
    return logits.to(torch.float32)


def forward(params, tokens: torch.Tensor, config: GPT2Config,
            router_noise: Optional[torch.Tensor] = None, mesh=None):
    """tokens [B, T] int -> (logits [B, T, V] f32, aux loss)."""
    params = common.mesh_params(params, mesh, False)
    x, aux = _trunk(params, tokens, config, router_noise, mesh)
    return _head(params, x), aux


def _pipelined(params, tokens, config: GPT2Config, mesh, num_microbatches):
    x = _embed(params, tokens, config, mesh)
    block = common.checkpointed(functools.partial(_block, config, mesh),
                                config.remat, config.remat_policy)
    collect_aux = config.moe is not None

    def apply_stage(local_blocks, mb):
        aux = 0.0
        n = local_blocks["ln1_g"].shape[0]
        for layer in common.layers(local_blocks, n):
            mb, a = block(mb, layer)
            aux = aux + a
        return (mb, aux) if collect_aux else mb

    res = pipeline_apply(params["blocks"], x, mesh=mesh,
                         apply_stage=apply_stage,
                         num_microbatches=num_microbatches,
                         collect_aux=collect_aux)
    x, aux = res if collect_aux else (res, 0.0)
    x = _layer_norm(x, params["ln_f_g"], params["ln_f_b"])
    return _head(params, x), aux


def forward_pipelined(params, tokens: torch.Tensor, config: GPT2Config,
                      mesh=None, num_microbatches: int = 4):
    """Pipeline-parallel forward: the blocks run under the GPipe microbatch
    loop (``parallel.pipeline.pipeline_apply``) over the "stage" mesh axis,
    each stage its [L/S] slice of the stacked blocks; embedding and head run
    outside the pipe, on every stage. MoE models carry the router's aux loss
    across the microbatch loop. Returns (logits [B, T, V] f32, aux)."""
    return _pipelined(common.mesh_params(params, mesh, True), tokens, config,
                      mesh, num_microbatches)


def init_kv_cache(config: GPT2Config, batch: int, max_len: int, dtype=None,
                  device: DeviceLike = "cuda") -> Dict[str, torch.Tensor]:
    """Static-shape KV cache for incremental decoding: [L, B, S, H, D]."""
    dev = resolve_device(device)
    dtype = dtype or config.dtype
    shape = (config.num_layers, batch, max_len, config.num_heads,
             config.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


def forward_cached(params, tokens: torch.Tensor, cache: Dict[str, torch.Tensor],
                   start: torch.Tensor, config: GPT2Config,
                   fresh: bool = False):
    """Incremental forward: attend over the KV cache, append new K/V.

    tokens [B, T]: a prompt chunk (prefill) or one decode step (T=1);
    start [B] int: absolute position of tokens[:, 0] per sequence. Returns
    (logits [B, T, V] f32, cache). MoE configs route each token through its
    top-k experts; the aux loss is dropped here, as in JAX.

    ``fresh=True`` is the caller's promise that every row starts at
    position 0 (a new prompt's prefill): the keys a query may see are then
    exactly the chunk's own, so the chunk attends causally to itself
    through ``attention(impl="auto")`` (K1 on the card, the dense version
    on the CPU) instead of densely over all S cache slots. The cache is
    written as without it.

    Unlike the JAX function, this one writes the new K/V into ``cache`` IN
    PLACE and returns the same dict: a copy of the whole cache per decode
    step would cost more than the step. Callers that must keep a cache
    unchanged (the engine's prefix cache) clone it first.

    JAX semantics kept on purpose: the write start of each row is clamped
    so the T-row update fits (``dynamic_update_slice``: start' =
    min(start, S - T)), and positions past the table clamp to its last row
    in the ``wpe`` gather; the causal mask uses the unclamped positions.
    """
    B, T = tokens.shape
    S = cache["k"].shape[2]
    dev = tokens.device
    start = start.to(device=dev, dtype=torch.long)
    pos = start[:, None] + torch.arange(T, device=dev)[None, :]       # [B, T]
    wpe = params["wpe"]
    x = params["wte"][tokens].to(config.dtype)
    x = x + wpe[pos.clamp(0, wpe.shape[0] - 1)].to(config.dtype)

    if not fresh:   # the dense path masks the cache's S slots
        key_pos = torch.arange(S, device=dev)[None, None, :]           # [1, 1, S]
        mask = key_pos <= pos[:, :, None]                               # [B, T, S]
    write = start.clamp(0, max(S - T, 0))[:, None] + torch.arange(T, device=dev)
    rows = torch.arange(B, device=dev)[:, None]
    scale = math.sqrt(config.head_dim)

    for i in range(config.num_layers):
        layer = _layer(params, i)
        h = _layer_norm(x, layer["ln1_g"], layer["ln1_b"])
        q, k_new, v_new = _qkv(layer, h)
        ck, cv = cache["k"][i], cache["v"][i]                          # [B, S, H, D]
        ck[rows, write] = k_new.to(ck.dtype)
        cv[rows, write] = v_new.to(cv.dtype)
        if fresh:
            attn = attention(q, k_new.to(ck.dtype), v_new.to(cv.dtype),
                             causal=True, impl="auto")
        else:
            # the attention core differs from _block: queries attend the cache
            scores = torch.einsum("bthd,bshd->bhts", q, ck).to(torch.float32)
            scores = scores / scale
            scores = scores.masked_fill(~mask[:, None, :, :], -1e30)
            probs = torch.softmax(scores, dim=-1).to(q.dtype)
            attn = torch.einsum("bhts,bshd->bthd", probs, cv)
        x = _attn_residual(layer, x, attn)
        x, _ = _mlp_residual(config, layer, x)
    x = _layer_norm(x, params["ln_f_g"], params["ln_f_b"])
    logits = torch.einsum("bte,ve->btv", x, params["wte"].to(x.dtype))
    return logits.to(torch.float32), cache


def loss_fn(params, batch: Dict[str, Any], config: GPT2Config,
            pipeline_microbatches: Optional[int] = None,
            router_noise: Optional[torch.Tensor] = None,
            mesh=None) -> torch.Tensor:
    """Next-token cross entropy plus the MoE aux loss, an f32 scalar. batch:
    {"tokens": [B, T+1]} or {"inputs": [B, T], "targets": [B, T]}, with an
    optional "mask" [B, T] of weights. Tensors or numpy arrays; they move to
    the params' device. ``router_noise`` feeds the MoE router's jitter
    (unpipelined path only, as in JAX). With ``pipeline_microbatches`` the
    blocks run as ``forward_pipelined``'s GPipe loop and the loss is the
    reference's log-softmax over the whole logits."""
    params = common.mesh_params(params, mesh, bool(pipeline_microbatches))
    inputs, targets, mask = common.next_token_batch(batch, params["wte"].device)
    if pipeline_microbatches:
        logits, aux = _pipelined(params, inputs, config, mesh,
                                 pipeline_microbatches)
        mean = common.logits_nll(logits, targets, mask)
    else:
        x, aux = _trunk(params, inputs, config, router_noise, mesh)
        mean = chunked_softmax_xent(x, params["wte"], targets, mask)
    return common.mesh_loss(mean, targets, mask, aux, mesh)


def count_params(params: nn.Module) -> int:
    return sum(p.numel() for p in params.parameters())


def flops_per_token(config: GPT2Config) -> float:
    """~6N FLOPs/token for training (fwd+bwd), N = non-embedding params."""
    L, E, M = config.num_layers, config.embed_dim, config.mlp_dim
    n = L * (4 * E * E + 2 * E * M) + config.vocab_size * E
    return 6.0 * n
