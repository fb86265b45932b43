"""Mixture-of-Experts: top-k routing with capacity or dropless, and the
expert mesh axis.

Counterpart of ``ray_tpu/parallel/moe.py``: ``MoEConfig``,
``init_moe_params``, ``moe_param_axes`` and ``moe_layer`` in the
GShard/Switch formulation. Routing builds a dispatch one-hot [tokens,
experts, capacity] and the dispatch and combine are einsums against it.

On a mesh (``mesh=``) the layer is the same function of the whole batch as
the reference's on its mesh. The expert weights are ``Shard`` over the
"expert" axis, and each rank runs its experts' slice of the dispatch
tensor; the combine's sum over experts becomes a sum over the expert
axis. The capacity queues are positions in the whole batch's token order,
so the layer first gathers the tokens of the batch shards (the data, fsdp
and seq axes) and routes them all, alike on every rank; after the combine
each rank keeps its own tokens' rows. The aux loss is the whole batch's.

Two hazards of the translation, handled here:

- ``jax.nn.one_hot`` of an index out of range (-1 for an unselected
  expert) is a zero row, where a torch one-hot or scatter raises or wraps.
  The dispatch compares the queue position with the slot numbers instead,
  and a position of -1 matches none.
- ``jax.lax.top_k`` breaks ties toward the lower index; ``torch.topk``
  promises no order among ties. Router probabilities that tie exactly may
  pick other experts than JAX does.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ray_tpu_torch.parallel import _collectives
from ray_tpu_torch.parallel.mesh import axis_index
from ray_tpu_torch.parallel.sharding import local_shard, shard_batch_spec

_ACTIVATIONS = ("gelu", "swiglu")


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01
    router_jitter: float = 0.0
    # "gelu" (Switch-style experts) | "swiglu" (Mixtral-style gated experts)
    activation: str = "gelu"
    # Dropless routing: every token reaches its top-k experts, with no
    # capacity queues, so a token's output does not depend on the other
    # tokens of the batch. The decode engine switches it on (prefill and
    # per-step decode must agree with the full forward); training keeps the
    # capacity path.
    dropless: bool = False

    def __post_init__(self):
        if self.activation not in _ACTIVATIONS:
            raise ValueError(
                f"MoEConfig.activation must be 'gelu' or 'swiglu', got "
                f"{self.activation!r}"
            )


def moe_param_shapes(embed_dim: int, mlp_dim: int, config: MoEConfig,
                     num_layers: Optional[int] = None) -> Dict[str, tuple]:
    """Shapes of ``init_moe_params``'s tree, named as in the JAX package."""
    lead = () if num_layers is None else (num_layers,)
    E = config.num_experts
    shapes = {
        "router_w": lead + (embed_dim, E),
        "expert_fc": lead + (E, embed_dim, mlp_dim),
        "expert_out": lead + (E, mlp_dim, embed_dim),
    }
    if config.activation == "swiglu":
        # Mixtral-style gated experts: fc is the "up" projection
        shapes["expert_gate"] = lead + (E, embed_dim, mlp_dim)
    return shapes


def moe_param_axes(num_layers: Optional[int] = None,
                   config: Optional[MoEConfig] = None) -> Dict[str, tuple]:
    """Logical axis names of ``init_moe_params``'s tree (see
    ``sharding.DEFAULT_RULES``)."""
    lead = () if num_layers is None else ("stage",)
    axes = {
        "router_w": lead + ("embed", None),
        "expert_fc": lead + ("expert", "embed", "mlp"),
        "expert_out": lead + ("expert", "mlp", "embed"),
    }
    if config is not None and config.activation == "swiglu":
        axes["expert_gate"] = lead + ("expert", "embed", "mlp")
    return axes


EXPERT_WEIGHTS = ("expert_fc", "expert_out", "expert_gate")


def init_moe_params(generator: torch.Generator, embed_dim: int, mlp_dim: int,
                    config: MoEConfig, param_dtype=torch.float32,
                    num_layers: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """Expert weights, normal(0.02), on the CPU from ``generator``; with
    ``num_layers``, stacked on a leading dim."""
    return {
        name: (torch.randn(shape, generator=generator, dtype=torch.float32)
               * 0.02).to(param_dtype)
        for name, shape in moe_param_shapes(embed_dim, mlp_dim, config,
                                            num_layers).items()
    }


def _top_k_mask(probs: torch.Tensor, k: int) -> torch.Tensor:
    """[T, E] probs -> 0/1 mask of the top-k experts per token."""
    idx = torch.topk(probs, k, dim=-1).indices
    return torch.zeros_like(probs).scatter_(-1, idx, 1.0)


def _experts(params, x_in: torch.Tensor, config: MoEConfig, lhs: str,
             out: str) -> torch.Tensor:
    """The experts' MLP on ``x_in``, whose dims ``lhs`` names ("td" or
    "ecd"), to [``out``..., d]: fc (and gate) product, tanh-GELU or SwiGLU,
    out product."""
    dt = x_in.dtype
    h = torch.einsum(f"{lhs},edm->{out}m", x_in, params["expert_fc"].to(dt))
    if config.activation == "swiglu":
        g = torch.einsum(f"{lhs},edm->{out}m", x_in,
                         params["expert_gate"].to(dt))
        h = F.silu(g) * h
    else:
        h = F.gelu(h, approximate="tanh")   # jax.nn.gelu's default
    return torch.einsum(f"{out}m,emd->{out}d", h, params["expert_out"].to(dt))


# The batch's shards (``sharding.shard_batch_spec``): (mesh axis, tensor
# dim) in gathering order, inner axes first, so the gathered tokens stand
# in the whole batch's order (rows data-major over data x fsdp, then the
# sequence).
_BATCH_AXES = (("seq", 1), ("fsdp", 0), ("data", 0))


def moe_layer(params, x: torch.Tensor, config: MoEConfig, *,
              noise: Optional[torch.Tensor] = None, mesh=None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, T, D] -> (out [B, T, D], aux loss, an f32 scalar).

    The router runs in f32; with ``config.router_jitter`` and ``noise`` (a
    standard normal [tokens, num_experts] f32 tensor on x's device, over
    the whole batch's tokens) the jitter times the noise is added to its
    logits. The noise is drawn by the caller (``models.common.router_noise``),
    so a checkpointed block that re-runs in the backward adds the same
    noise, and a compiled step draws no random numbers inside its graph.

    With ``mesh``, x is this rank's shard of the batch (rows over data and
    fsdp, sequence over seq) and ``params``' expert weights its experts'
    slice (their E dim sharded over "expert"); out is x's shard."""
    if mesh is None:
        return _moe(params, x, config, noise, 0)
    xg = x
    for axis, dim in _BATCH_AXES:
        xg = _collectives.all_gather(xg, mesh, axis, dim)
    e0 = axis_index(mesh, "expert") * params["expert_fc"].shape[0]
    out, aux = _moe(params, xg, config, noise, e0)
    out = _collectives.all_reduce(out, mesh, "expert")
    return local_shard(out, shard_batch_spec(mesh)), aux


def _moe(params, x: torch.Tensor, config: MoEConfig,
         noise: Optional[torch.Tensor], e0: int
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The layer over all of x's tokens, the experts of ``params`` being
    experts [e0, e0 + E_local) of ``config.num_experts``: their share of
    the output (the whole output when they are all the experts) and the aux
    loss."""
    B, T, D = x.shape
    E = config.num_experts
    experts = slice(e0, e0 + params["expert_fc"].shape[0])
    tokens = x.reshape(B * T, D)
    n_tok = B * T
    capacity = max(int(n_tok * config.top_k * config.capacity_factor / E),
                   config.top_k)

    router_logits = torch.einsum("td,de->te", tokens.to(torch.float32),
                                 params["router_w"].to(torch.float32))
    if config.router_jitter and noise is not None:
        router_logits = router_logits + config.router_jitter * noise
    probs = torch.softmax(router_logits, dim=-1)       # [T, E]
    topk_mask = _top_k_mask(probs, config.top_k)      # [T, E] 0/1
    # Load-balancing auxiliary loss (Switch §2.2): mean gate fraction times
    # token fraction per expert, scaled by E.
    me = probs.mean(dim=0)
    ce = topk_mask.mean(dim=0) / config.top_k
    aux = config.aux_loss_weight * E * torch.sum(me * ce)

    if config.dropless:
        # Every expert runs on every token; the combine masks to the top-k.
        gates = probs * topk_mask
        gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
        y = _experts(params, tokens, config, "td", "te")         # [T, E, D]
        out = torch.einsum("te,ted->td", gates[:, experts].to(x.dtype), y)
        return out.reshape(B, T, D), aux

    # Position of each token in its expert's queue (1-based, in token
    # order); tokens past the capacity are dropped.
    pos = torch.cumsum(topk_mask, dim=0) * topk_mask
    keep = (pos > 0) & (pos <= capacity)
    pos = (pos - 1).to(torch.long)                    # -1: not routed here

    gates = probs * topk_mask * keep
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)

    # dispatch [T, E, C]: slot pos of expert e holds token t (no slot when
    # pos is -1 or past the capacity)
    slots = torch.arange(capacity, device=x.device)
    dispatch = ((pos[..., None] == slots) & keep[..., None]).to(x.dtype)
    combine = gates[..., None] * dispatch
    dispatch, combine = dispatch[:, experts], combine[:, experts]

    expert_in = torch.einsum("tec,td->ecd", dispatch, tokens)   # [E, C, D]
    expert_out = _experts(params, expert_in, config, "ecd", "ec")  # [E, C, D]
    out = torch.einsum("tec,ecd->td", combine.to(x.dtype), expert_out)
    return out.reshape(B, T, D), aux
