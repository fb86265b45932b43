"""Llama in PyTorch: the port's second model family.

Counterpart of ``ray_tpu/models/llama.py``: RMSNorm, rotary position
embeddings (RoPE, half-split form), SwiGLU MLP (or, with ``moe``,
Mixtral-style routed experts, ``parallel/moe.py``), grouped-query attention
(GQA) and an untied LM head. Same skeleton as ``models/gpt2.py``: the
parameters keep the JAX tree's names and layouts (``wq`` [L, E, H, D],
``wk``/``wv`` [L, E, KV, D], ``wo`` [L, H, D, E], every block parameter
stacked on a leading L), the layer ``scan`` is a Python loop, activations
run in ``config.dtype`` over ``param_dtype`` parameters.

GQA: the blocks feed q with H heads and k/v with KV heads straight into
``ops.attention.attention``. Its kernels and its dense version read kv
head h // (H / KV) for query head h in place, the head mapping of JAX's
``_repeat_kv``, so no repeated K/V is materialised. The decode path
groups the query heads per kv head over the [L, B, S, KV, D] cache.

The functions take ``params`` as anything indexable by the JAX names: a
``Llama`` module or a nested dict of tensors. With ``mesh=`` they are the
SPMD bodies of ``models/gpt2.py``'s contract: this rank's shard of the
batch in and out, the parameters gathered where they are used, RoPE at
the shard's absolute positions; ring and Ulysses attention carry the Hkv
kv heads (``parallel/ring_attention.py``).
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

@dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    max_seq_len: int = 2048
    num_layers: int = 16
    num_heads: int = 16
    num_kv_heads: int = 4            # GQA: kv heads < query heads
    embed_dim: int = 1024
    mlp_dim: Optional[int] = None    # default: 8/3 * E rounded up to 128
    rope_theta: float = 10000.0      # 500000.0 for llama-3-style contexts
    rms_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16        # activation dtype
    param_dtype: torch.dtype = torch.float32
    # auto | xla | flash | flash_interpret | ring | ulysses
    attention_impl: str = "auto"
    # Activation checkpointing of each block in training: "full" keeps only
    # the block's inputs; anything else is "dots" (JAX's _remat_policy),
    # which also keeps the flash forward's (out, lse), so the forward kernel
    # runs once per layer per step.
    remat: bool = True
    remat_policy: str = "dots"
    seq_axis: str = "seq"            # mesh axis for ring/ulysses
    # Mixtral-style MoE in place of the SwiGLU MLP (MoEConfig(activation=
    # "swiglu") for the Mixtral shape).
    moe: Optional[MoEConfig] = None

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads

    @property
    def hidden_dim(self) -> int:
        if self.mlp_dim is not None:
            return self.mlp_dim
        h = int(self.embed_dim * 8 / 3)
        return (h + 127) // 128 * 128

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // self.num_kv_heads


LLAMA_TINY = LlamaConfig(  # test size
    vocab_size=512, max_seq_len=128, num_layers=2, num_heads=4,
    num_kv_heads=2, embed_dim=64,
)
LLAMA_160M = LlamaConfig(
    num_layers=12, num_heads=12, num_kv_heads=4, embed_dim=768,
    vocab_size=32000,
)
LLAMA_1B = LlamaConfig(
    num_layers=16, num_heads=32, num_kv_heads=8, embed_dim=2048,
    max_seq_len=4096, rope_theta=500000.0,
)
LLAMA_8B = LlamaConfig(
    num_layers=32, num_heads=32, num_kv_heads=8, embed_dim=4096,
    mlp_dim=14336, max_seq_len=8192, vocab_size=128256, rope_theta=500000.0,
)

PRESETS = {
    "llama-tiny": LLAMA_TINY,
    "llama-160m": LLAMA_160M,
    "llama-1b": LLAMA_1B,
    "llama-8b": LLAMA_8B,
}


def param_shapes(config: LlamaConfig) -> Dict[str, Any]:
    """The parameter tree's shapes, named as in the JAX package."""
    E, H, KV, M, V, L, D = (
        config.embed_dim, config.num_heads, config.num_kv_heads,
        config.hidden_dim, config.vocab_size, config.num_layers,
        config.head_dim,
    )
    blocks = {
        "attn_norm": (L, E),
        "wq": (L, E, H, D),
        "wk": (L, E, KV, D),
        "wv": (L, E, KV, D),
        "wo": (L, H, D, E),
        "mlp_norm": (L, E),
    }
    if config.moe is not None:
        # routed experts replace the dense FFN (never both)
        blocks["moe"] = moe_param_shapes(E, M, config.moe, L)
    else:
        blocks.update(w_gate=(L, E, M), w_up=(L, E, M), w_down=(L, M, E))
    return {"wte": (V, E), "blocks": blocks, "norm_f": (E,),
            "lm_head": (V, E)}


def param_axes(config: LlamaConfig) -> Dict[str, Any]:
    """Logical axis names per parameter (see ``sharding.DEFAULT_RULES``),
    the JAX ``param_axes``'s tree. kv-head dims use the "kv" axis
    (replicated by default: GQA kv heads often do not divide the tensor
    axis; override the rules to shard them)."""
    axes = {
        "wte": ("vocab", "embed"),
        "blocks": {
            "attn_norm": ("stage", "norm"),
            "wq": ("stage", "embed", "heads", "head_dim"),
            "wk": ("stage", "embed", "kv", "head_dim"),
            "wv": ("stage", "embed", "kv", "head_dim"),
            "wo": ("stage", "heads", "head_dim", "embed"),
            "mlp_norm": ("stage", "norm"),
            "w_gate": ("stage", "embed", "mlp"),
            "w_up": ("stage", "embed", "mlp"),
            "w_down": ("stage", "mlp", "embed"),
        },
        "norm_f": ("norm",),
        "lm_head": ("vocab", "embed"),
    }
    if config.moe is not None:
        for name in ("w_gate", "w_up", "w_down"):
            del axes["blocks"][name]
        axes["blocks"]["moe"] = moe_param_axes(
            num_layers=config.num_layers, config=config.moe)
    return axes


def init_params(config: LlamaConfig,
                generator: Optional[torch.Generator] = None,
                device: DeviceLike = "cuda") -> "Llama":
    """Fresh parameters: normal(0.02) embeddings, projections and head,
    residual-scaled output projections (``wo``, ``w_down``: std
    0.02 / sqrt(2L)), unit norms, as the JAX ``init_params``. Drawn on the
    CPU from ``generator`` (seed 0 when None)."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    pd = config.param_dtype
    std = 0.02
    res_std = std / (2 * config.num_layers) ** 0.5
    shapes = param_shapes(config)
    b = shapes["blocks"]

    def normal(shape, s=std):
        return (torch.randn(shape, generator=generator, dtype=torch.float32)
                * s).to(pd)

    blocks = {
        "attn_norm": torch.ones(b["attn_norm"], dtype=pd),
        "wq": normal(b["wq"]),
        "wk": normal(b["wk"]),
        "wv": normal(b["wv"]),
        "wo": normal(b["wo"], res_std),
        "mlp_norm": torch.ones(b["mlp_norm"], dtype=pd),
    }
    if config.moe is not None:
        blocks["moe"] = init_moe_params(
            generator, config.embed_dim, config.hidden_dim, config.moe, pd,
            num_layers=config.num_layers)
    else:
        blocks["w_gate"] = normal(b["w_gate"])
        blocks["w_up"] = normal(b["w_up"])
        blocks["w_down"] = normal(b["w_down"], res_std)
    tree = {
        "wte": normal(shapes["wte"]),
        "blocks": blocks,
        "norm_f": torch.ones(shapes["norm_f"], dtype=pd),
        "lm_head": normal(shapes["lm_head"]),
    }
    return Llama(config, tree, device=dev)


class Llama(nn.Module):
    """The parameter tree as a module. ``model["blocks"]["wq"]`` and
    ``model["blocks"]["moe"]["router_w"]`` index it as the JAX dict is
    indexed; ``model(tokens)`` is ``forward(model, tokens, config)``."""

    def __init__(self, config: LlamaConfig, tree: Dict[str, Any],
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

        def params(sub, sub_shapes, prefix):
            out = nn.ParameterDict()
            for n, shape in sub_shapes.items():
                if isinstance(shape, dict):
                    out[n] = params(sub[n], shape, f"{prefix}{n}.")
                else:
                    out[n] = param(sub[n], shape, prefix + n)
            return out

        self.wte = param(tree["wte"], shapes["wte"], "wte")
        self.blocks = params(tree["blocks"], shapes["blocks"], "blocks.")
        self.norm_f = param(tree["norm_f"], shapes["norm_f"], "norm_f")
        self.lm_head = param(tree["lm_head"], shapes["lm_head"], "lm_head")

    def __getitem__(self, name: str):
        return getattr(self, name)

    def forward(self, tokens: torch.Tensor):
        return forward(self, tokens, self.config)


def _rms_norm(x, g, eps):
    """f32 RMSNorm: x * rsqrt(mean(x^2) + eps) * g in f32, cast back to x's
    dtype."""
    x32 = x.to(torch.float32)
    scale = torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + eps)
    return (x32 * scale * g).to(x.dtype)


def _rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding, half-split form. x: [B, T, H, D], pos: [B, T]
    absolute positions. The frequencies and angles are f32, as JAX computes
    them; cos and sin are cast to x's dtype before the products, as JAX
    casts them."""
    D = x.shape[-1]
    i = torch.arange(0, D // 2, dtype=torch.float32, device=x.device)
    # a fill, not a host-to-device copy: the engine captures this forward
    # into a CUDA graph, where a synchronising copy is not allowed
    freqs = torch.pow(torch.full((), theta, dtype=torch.float32,
                                 device=x.device), -i / (D // 2))
    angles = pos[..., None].to(torch.float32) * freqs          # [B, T, D/2]
    cos = torch.cos(angles)[:, :, None, :].to(x.dtype)         # [B, T, 1, D/2]
    sin = torch.sin(angles)[:, :, None, :].to(x.dtype)
    x1, x2 = x[..., : D // 2], x[..., D // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)


def _qkv(config: LlamaConfig, layer, x, pos):
    """attn_norm, the q/k/v projections and RoPE: q [B, T, H, D], k/v
    [B, T, KV, D]."""
    h = _rms_norm(x, layer["attn_norm"], config.rms_eps)
    q = torch.einsum("bte,ehd->bthd", h, layer["wq"].to(h.dtype))
    k = torch.einsum("bte,ehd->bthd", h, layer["wk"].to(h.dtype))
    v = torch.einsum("bte,ehd->bthd", h, layer["wv"].to(h.dtype))
    return (_rope(q, pos, config.rope_theta), _rope(k, pos, config.rope_theta),
            v)


def _ffn(config: LlamaConfig, layer, x, noise=None, mesh=None):
    """mlp_norm + SwiGLU MLP (or routed MoE) + residual -> (x, aux loss);
    ``noise`` is the router's jitter noise."""
    h = _rms_norm(x, layer["mlp_norm"], config.rms_eps)
    if config.moe is not None:
        h, aux = moe_layer(layer["moe"], h, config.moe, noise=noise, mesh=mesh)
        return x + h, aux
    gate = torch.einsum("bte,em->btm", h, layer["w_gate"].to(h.dtype))
    up = torch.einsum("bte,em->btm", h, layer["w_up"].to(h.dtype))
    h = F.silu(gate) * up
    h = torch.einsum("btm,me->bte", h, layer["w_down"].to(h.dtype))
    return x + h, 0.0


def _block(config: LlamaConfig, mesh, x, layer, pos, noise=None):
    """One decoder block -> (x, aux). x: [B, T, E], pos: [B, T] absolute;
    ``noise`` ([B*T, experts] or None) is the MoE router's jitter noise."""
    q, k, v = _qkv(config, layer, x, pos)
    attn = common.attention_dispatch(config, q, k, v, mesh)
    x = x + torch.einsum("bthd,hde->bte", attn, layer["wo"].to(x.dtype))
    return _ffn(config, layer, x, noise, mesh)


def _layer(params, i: int) -> Dict[str, Any]:
    blocks = params["blocks"]
    layer = {n: w[i] for n, w in blocks.items() if n != "moe"}
    if "moe" in blocks:
        layer["moe"] = {n: w[i] for n, w in blocks["moe"].items()}
    return layer


def _policy(config: LlamaConfig) -> str:
    """JAX's llama ``_remat_policy``: "full", or else "dots"."""
    return "full" if config.remat_policy == "full" else "dots"


def _positions(tokens: torch.Tensor, mesh) -> torch.Tensor:
    """[B, T] absolute positions of this rank's tokens."""
    B, T = tokens.shape
    off = common.seq_offset(mesh, T)
    return torch.arange(off, off + T, device=tokens.device)[None, :].expand(
        B, T)


def _trunk(params, tokens: torch.Tensor, config: LlamaConfig,
           router_noise: Optional[torch.Tensor], mesh):
    x = params["wte"][tokens].to(config.dtype)
    pos = _positions(tokens, mesh)
    aux = 0.0
    block = common.checkpointed(functools.partial(_block, config, mesh),
                                config.remat, _policy(config))
    for i, layer in enumerate(common.layers(params["blocks"],
                                            config.num_layers)):
        noise = None if router_noise is None else router_noise[i]
        x, layer_aux = block(x, layer, pos, noise)
        aux = aux + layer_aux
    x = _rms_norm(x, params["norm_f"], config.rms_eps)
    return x, aux


def forward_features(params, tokens: torch.Tensor, config: LlamaConfig,
                     router_noise: Optional[torch.Tensor] = None, mesh=None):
    """tokens [B, T] int -> (final-trunk features [B, T, E], aux loss).
    Under autograd each block runs under ``config.remat``; the loss path
    consumes the features directly, so the [B, T, V] logits never
    materialise. ``router_noise`` (``common.router_noise``'s [L, B*T,
    experts], over the whole batch's tokens) feeds the MoE router's
    jitter."""
    return _trunk(common.mesh_params(params, mesh, False), tokens, config,
                  router_noise, mesh)


def _head(params, x):
    logits = torch.einsum("bte,ve->btv", x, params["lm_head"].to(x.dtype))
    return logits.to(torch.float32)


def forward(params, tokens: torch.Tensor, config: LlamaConfig,
            router_noise: Optional[torch.Tensor] = None, mesh=None):
    """tokens [B, T] int -> (logits [B, T, V] f32, MoE aux loss)."""
    params = common.mesh_params(params, mesh, False)
    x, aux = _trunk(params, tokens, config, router_noise, mesh)
    return _head(params, x), aux


def _pipelined(params, tokens, config: LlamaConfig, mesh, num_microbatches):
    x = params["wte"][tokens].to(config.dtype)
    pos = _positions(tokens, mesh)
    block = common.checkpointed(functools.partial(_block, config, mesh),
                                config.remat, _policy(config))
    collect_aux = config.moe is not None

    def apply_stage(local_blocks, mb):
        # microbatches split the batch dim; positions are the same per row
        mb_pos, aux = pos[:mb.shape[0]], 0.0
        n = local_blocks["attn_norm"].shape[0]
        for layer in common.layers(local_blocks, n):
            mb, a = block(mb, layer, mb_pos)
            aux = aux + a
        return (mb, aux) if collect_aux else mb

    res = pipeline_apply(params["blocks"], x, mesh=mesh,
                         apply_stage=apply_stage,
                         num_microbatches=num_microbatches,
                         collect_aux=collect_aux)
    x, aux = res if collect_aux else (res, 0.0)
    x = _rms_norm(x, params["norm_f"], config.rms_eps)
    return _head(params, x), aux


def forward_pipelined(params, tokens: torch.Tensor, config: LlamaConfig,
                      mesh=None, num_microbatches: int = 4):
    """Pipeline-parallel forward over the "stage" mesh axis (the GPipe
    microbatch loop, ``parallel.pipeline.pipeline_apply``); embedding and
    head outside the pipe. MoE models carry the router's aux loss across
    the microbatch loop. Returns (logits [B, T, V] f32, aux)."""
    return _pipelined(common.mesh_params(params, mesh, True), tokens, config,
                      mesh, num_microbatches)


def init_kv_cache(config: LlamaConfig, batch: int, max_len: int, dtype=None,
                  device: DeviceLike = "cuda") -> Dict[str, torch.Tensor]:
    """Static-shape GQA cache: [L, B, S, KV, D], kv heads only."""
    dev = resolve_device(device)
    dtype = dtype or config.dtype
    shape = (config.num_layers, batch, max_len, config.num_kv_heads,
             config.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


def forward_cached(params, tokens: torch.Tensor, cache: Dict[str, torch.Tensor],
                   start: torch.Tensor, config: LlamaConfig,
                   fresh: bool = False):
    """Incremental forward with RoPE at absolute positions; the contract of
    ``gpt2.forward_cached``: tokens [B, T], start [B] (absolute position of
    tokens[:, 0]) -> (logits [B, T, V] f32, cache), the new K/V written into
    ``cache`` IN PLACE at start' = min(start, S - T) (JAX's clamped
    ``dynamic_update_slice``) while RoPE and the causal mask use the true
    positions. MoE configs route each token through its top-k experts; the
    aux loss is dropped here, as in JAX. ``fresh=True``: a new prompt at
    position 0 attends causally to itself through ``attention`` (K1 on the
    card), as in ``gpt2.forward_cached``."""
    B, T = tokens.shape
    S = cache["k"].shape[2]
    KV, g, D = config.num_kv_heads, config.q_per_kv, config.head_dim
    dev = tokens.device
    start = start.to(device=dev, dtype=torch.long)
    pos = start[:, None] + torch.arange(T, device=dev)[None, :]       # [B, T]
    x = params["wte"][tokens].to(config.dtype)

    if not fresh:   # the dense path masks the cache's S slots
        key_pos = torch.arange(S, device=dev)[None, None, :]           # [1, 1, S]
        mask = key_pos <= pos[:, :, None]                               # [B, T, S]
    write = start.clamp(0, max(S - T, 0))[:, None] + torch.arange(T, device=dev)
    rows = torch.arange(B, device=dev)[:, None]
    scale = math.sqrt(D)

    for i in range(config.num_layers):
        layer = _layer(params, i)
        q, k_new, v_new = _qkv(config, layer, x, pos)
        ck, cv = cache["k"][i], cache["v"][i]                          # [B, S, KV, D]
        ck[rows, write] = k_new.to(ck.dtype)
        cv[rows, write] = v_new.to(cv.dtype)
        if fresh:
            attn = attention(q, k_new.to(ck.dtype), v_new.to(cv.dtype),
                             causal=True, impl="auto")
        else:
            # GQA over the cache: query heads grouped per kv head
            qg = q.reshape(B, T, KV, g, D)
            scores = torch.einsum("btkgd,bskd->bkgts", qg, ck).to(torch.float32)
            scores = scores / scale
            scores = scores.masked_fill(~mask[:, None, None, :, :], -1e30)
            probs = torch.softmax(scores, dim=-1).to(q.dtype)
            attn = torch.einsum("bkgts,bskd->btkgd", probs, cv)
            attn = attn.reshape(B, T, config.num_heads, D)
        x = x + torch.einsum("bthd,hde->bte", attn, layer["wo"].to(x.dtype))
        x, _ = _ffn(config, layer, x)
    x = _rms_norm(x, params["norm_f"], config.rms_eps)
    logits = torch.einsum("bte,ve->btv", x, params["lm_head"].to(x.dtype))
    return logits.to(torch.float32), cache


def loss_fn(params, batch: Dict[str, Any], config: LlamaConfig,
            pipeline_microbatches: Optional[int] = None,
            router_noise: Optional[torch.Tensor] = None,
            mesh=None) -> torch.Tensor:
    """Next-token cross entropy over the untied ``lm_head`` plus the MoE aux
    loss; the batch and mesh contract of ``gpt2.loss_fn``. ``router_noise``
    feeds the MoE router's jitter (unpipelined path only, as in JAX)."""
    params = common.mesh_params(params, mesh, bool(pipeline_microbatches))
    inputs, targets, mask = common.next_token_batch(batch, params["wte"].device)
    if pipeline_microbatches:
        logits, aux = _pipelined(params, inputs, config, mesh,
                                 pipeline_microbatches)
        mean = common.logits_nll(logits, targets, mask)
    else:
        x, aux = _trunk(params, inputs, config, router_noise, mesh)
        mean = chunked_softmax_xent(x, params["lm_head"], targets, mask)
    return common.mesh_loss(mean, targets, mask, aux, mesh)


def count_params(params: nn.Module) -> int:
    return sum(p.numel() for p in params.parameters())


def flops_per_token(config: LlamaConfig) -> float:
    """~6N FLOPs/token for training; N = ACTIVE non-embedding params (MoE
    counts only the top_k routed experts per token) plus the head."""
    E, D = config.embed_dim, config.head_dim
    attn = E * config.num_heads * D * 2 + E * config.num_kv_heads * D * 2
    if config.moe is not None:
        per_expert = (
            3 if config.moe.activation == "swiglu" else 2
        ) * E * config.hidden_dim
        mlp = config.moe.top_k * per_expert + E * config.moe.num_experts
    else:
        mlp = 3 * E * config.hidden_dim
    n = config.num_layers * (attn + mlp) + config.vocab_size * E
    return 6.0 * n
