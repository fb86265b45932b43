"""What the model families share: the block region with its activation
checkpointing, the per-layer slices of the stacked weights, the MoE
router's jitter noise, the loss's batch contract, and the parameters and
the loss on a mesh.

Checkpointing is the analog of ``jax.checkpoint(body, policy=...)`` over a
block: "full" keeps only the block's inputs and re-runs the whole block
(the attention forward included) in the backward; "dots" and "dots_all" are
selective checkpointing that keeps the flash forward's (out, lse) and the
matrix products the policy names, and recomputes the elementwise ops. The
block is a nested compile region, the analog of the reference's
``lax.scan`` over layers: a compiled step traces one layer, not L.
"""
from __future__ import annotations

import functools
import math
from typing import Any, Callable, Dict, Optional

import torch
import torch.distributed as dist
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from ray_tpu_torch.ops.attention import attention
from ray_tpu_torch.parallel import sharding
from ray_tpu_torch.parallel.mesh import axis_index, axis_size
from ray_tpu_torch.parallel.moe import EXPERT_WEIGHTS
from ray_tpu_torch.parallel.ring_attention import (
    ring_attention,
    ulysses_attention,
)

POLICIES = ("dots", "dots_all", "full")

_NO_BATCH_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)
# batched product -> position of its [batch, n, k] operand
_BATCHED_DOTS = {torch.ops.aten.bmm.default: 0, torch.ops.aten.baddbmm.default: 1}


def _policy(policy: str, ctx, func, *args, **kwargs):
    """Selective-checkpoint policy of one block (JAX ``_remat_policy``,
    gpt2.py:159): MUST_SAVE the flash forward's (out, lse), the analog of
    ``save_only_these_names("flash_out", "flash_lse")``, and the matrix
    products that the policy keeps. ``torch.einsum`` lowers a projection to
    ``bmm`` with a batch of 1 and a batched product (the dense attention's)
    to ``bmm`` with a larger batch: "dots" keeps the first kind
    (``dots_with_no_batch_dims_saveable``), "dots_all" both
    (``dots_saveable``)."""
    if func is torch.ops.ray_tpu_torch.flash_fwd_lse.default:
        return CheckpointPolicy.MUST_SAVE
    if func in _NO_BATCH_DOTS or (func in _BATCHED_DOTS and (
            policy == "dots_all" or args[_BATCHED_DOTS[func]].shape[0] == 1)):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def checkpointed(block: Callable, remat: bool, policy: str) -> Callable:
    """``block`` (-> (x, aux loss)) as the region every layer calls: under
    activation checkpointing by ``policy`` when ``remat`` and autograd
    records, and under ``torch.compile`` a nested compile region, which
    Dynamo traces once and every layer reuses, so a compiled step's
    compile does not grow with the depth. Eager, it is a plain call."""
    return _BlockRegion(block, policy if remat and torch.is_grad_enabled()
                        else None)


class _BlockRegion(torch.nn.Module):
    """The region of ``checkpointed``. A module, because a nested compile
    region takes tensors and modules only: ``block`` and the policy ride
    on it. A region returns tensors only, so a dense block's aux loss 0.0
    comes back as an f32 0-dim tensor."""

    def __init__(self, block: Callable, policy: Optional[str]):
        super().__init__()
        self.block, self.policy = block, policy

    @torch.compiler.nested_compile_region
    def forward(self, *args):
        if self.policy is None:
            x, aux = self.block(*args)
        else:
            kw = {"use_reentrant": False}
            if self.policy != "full":
                kw["context_fn"] = functools.partial(
                    create_selective_checkpoint_contexts,
                    functools.partial(_policy, self.policy))
            x, aux = checkpoint(self.block, *args, **kw)
        if not isinstance(aux, torch.Tensor):
            aux = x.new_zeros((), dtype=torch.float32)
        return x, aux


def layers(blocks, num_layers: int):
    """Per-layer dicts of the stacked block parameters ``blocks`` (the MoE
    experts' under "moe"), each leaf unbound once along its leading L: the
    gradient of an unbind is one stack, where a select per layer would
    scatter a whole [L, ...] gradient per layer. Under ``torch.compile``
    each leaf is a copy: Dynamo (torch 2.11) reuses a nested compile
    region's trace only for inputs that are not views, and the views of
    one stacked tensor differ in their storage offsets."""
    def split(w):
        parts = w.unbind(0)
        if torch.compiler.is_compiling():
            parts = [p.clone() for p in parts]
        return parts

    cols = {n: split(w) for n, w in blocks.items() if n != "moe"}
    moe = ({n: split(w) for n, w in blocks["moe"].items()}
           if "moe" in blocks else None)
    out = []
    for i in range(num_layers):
        layer = {n: c[i] for n, c in cols.items()}
        if moe is not None:
            layer["moe"] = {n: c[i] for n, c in moe.items()}
        out.append(layer)
    return out


def router_noise(config, n_tokens: int, seed: int,
                 device) -> Optional[torch.Tensor]:
    """The MoE router's jitter noise of one forward: standard normal
    [num_layers, n_tokens, num_experts] f32 on ``device``, drawn from a
    generator seeded with ``seed``; None unless the config's router
    jitters. JAX splits its key per layer; here layer i's block takes row
    i as an input, so a checkpointed block that re-runs in the backward
    adds the same noise, and the draw stays outside a compiled program
    (Dynamo does not trace a ``torch.Generator``)."""
    moe = config.moe
    if moe is None or not moe.router_jitter:
        return None
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn((config.num_layers, n_tokens, moe.num_experts),
                       generator=gen, device=device, dtype=torch.float32)


def next_token_batch(batch: Dict[str, Any], device):
    """(inputs, targets, mask or None) of a loss batch: {"tokens": [B, T+1]}
    or {"inputs": [B, T], "targets": [B, T]}, with an optional "mask"
    [B, T] of weights. Tensors or numpy arrays, moved to ``device``."""

    def get(name):
        return torch.as_tensor(batch[name], device=device)

    if "tokens" in batch:
        tokens = get("tokens")
        inputs, targets = tokens[:, :-1], tokens[:, 1:]
    else:
        inputs, targets = get("inputs"), get("targets")
    mask = get("mask") if batch.get("mask") is not None else None
    return inputs, targets, mask


def attention_dispatch(config, q, k, v, mesh):
    """A block's attention: the mesh's ring or Ulysses attention over
    ``config.seq_axis`` on top of the one-device dispatcher
    (``ops.attention.attention``). A sequence sharded over the mesh needs
    one of the two."""
    impl = config.attention_impl
    if impl == "ring":
        return ring_attention(q, k, v, mesh=mesh, axis=config.seq_axis,
                              causal=True)
    if impl == "ulysses":
        return ulysses_attention(q, k, v, mesh=mesh, axis=config.seq_axis,
                                 causal=True)
    if axis_size(mesh, config.seq_axis) > 1:
        raise ValueError(
            f"the sequence is sharded over {config.seq_axis!r}: attention "
            f"needs attention_impl 'ring' or 'ulysses', not {impl!r}")
    return attention(q, k, v, causal=True, impl=impl)


def param_tree(params) -> Dict[str, Any]:
    """The parameters as a nested dict by their dotted names (``blocks.qkv_w``
    -> tree["blocks"]["qkv_w"]), the form the models' functions index; a
    dict is returned as it is."""
    if not isinstance(params, torch.nn.Module):
        return params
    tree: Dict[str, Any] = {}
    for name, p in params.named_parameters():
        *path, leaf = name.split(".")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = p
    return tree


def mesh_params(params, mesh, pipelined: bool) -> Dict[str, Any]:
    """The parameter tree in the layout a model computes with on ``mesh``
    (``sharding.compute_view``): every tensor whole, except the stacked
    blocks' layer dim, which stays sharded over "stage" when ``pipelined``,
    and the experts' E dim, which stays sharded over "expert". Without a
    mesh, ``params`` as they are."""
    if mesh is None:
        return params

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        keep = {}
        if path[0] == "blocks":
            if pipelined:
                keep["stage"] = 0
            if path[-2:-1] == ("moe",) and path[-1] in EXPERT_WEIGHTS:
                keep["expert"] = 1
        return sharding.compute_view(node, mesh, keep)

    return walk(param_tree(params), ())


def seq_offset(mesh, t_local: int) -> int:
    """Position of this rank's first token: its sequence chunk's start."""
    return 0 if mesh is None else axis_index(mesh, "seq") * t_local


def logits_nll(logits: torch.Tensor, targets: torch.Tensor,
               mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Masked-mean next-token NLL from whole [B, T, V] logits: the
    reference's loss on its pipelined path (log-softmax, gather, mean)."""
    ll = torch.log_softmax(logits, dim=-1).gather(
        -1, targets.to(torch.long)[..., None])[..., 0]
    if mask is None:
        return -ll.mean()
    mask = mask.to(torch.float32)
    return -(ll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def share_weight(targets: torch.Tensor, mask: Optional[torch.Tensor],
                 mesh) -> torch.Tensor:
    """w, an f32 scalar without a gradient: a rank's NLL mean over its
    shard's weight (``mask``'s sum, or the number of ``targets``) times w is
    its share of the whole batch's NLL (the sum over the whole batch's
    weight, divided by at least 1 as ``chunked_softmax_xent`` divides), the
    shares of all ranks summing to it; the ranks that hold one shard alike
    split it. The mesh spans the default process group."""
    shards = math.prod(axis_size(mesh, a) for a in ("data", "fsdp", "seq"))
    rep = mesh.size() // shards       # ranks that hold the same batch shard
    with torch.no_grad():
        count = (torch.full((), float(targets.numel()), device=targets.device)
                 if mask is None else mask.to(torch.float32).sum())
        total = count.clone()
        dist.all_reduce(total)
        return (torch.clamp(count, min=1.0)
                / (rep * torch.clamp(total / rep, min=1.0)))


def summed(share: torch.Tensor) -> torch.Tensor:
    """The sum of every rank's ``share``, without a gradient."""
    total = share.detach().clone()
    dist.all_reduce(total)
    return total


def mesh_loss(mean, targets, mask, aux, mesh) -> torch.Tensor:
    """The loss, ``mean`` (this rank's NLL over the weight of its
    ``targets``) + ``aux``. Without a mesh, their sum. On a mesh, the whole
    batch's loss on every rank, as a value whose gradient is this rank's
    share of it: its share of the NLL (``share_weight``) and of ``aux``
    (alike on every rank, split evenly). Seeding each rank's backward with
    its share makes the sum of the ranks' gradients the loss's gradient
    (``parallel/_collectives.py``)."""
    if mesh is None:
        return mean + aux
    share = mean * share_weight(targets, mask, mesh) + aux / mesh.size()
    return share + (summed(share) - share).detach()
