"""What the model families share: activation checkpointing of a block,
the MoE router's per-layer seeds and the loss's batch contract.

Checkpointing is the analog of ``jax.checkpoint(body, policy=...)`` over a
block: "full"
keeps only the block's inputs and re-runs the whole block (the attention
forward included) in the backward; "dots" and "dots_all" are selective
checkpointing that keeps the flash forward's (out, lse) and the matrix
products the policy names, and recomputes the elementwise ops.
"""
from __future__ import annotations

import functools
from typing import Any, Callable, Dict, Optional

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
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
    """``block`` under activation checkpointing by ``policy`` when autograd
    records; ``block`` itself with ``remat=False`` or without grad."""
    if not (remat and torch.is_grad_enabled()):
        return block
    kw = {"use_reentrant": False}
    if policy != "full":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts,
            functools.partial(_policy, policy))
    return lambda *args: checkpoint(block, *args, **kw)


def layer_seeds(rng: Optional[torch.Generator], config) -> list:
    """One seed per layer, drawn from ``rng`` (a CPU generator) when the
    config's MoE router jitters, else Nones. JAX splits its key per layer;
    a seed (not a generator) goes into the checkpointed block, so a re-run
    in the backward draws the same noise."""
    moe = config.moe
    if rng is None or moe is None or not moe.router_jitter:
        return [None] * config.num_layers
    return torch.randint(0, 2 ** 62, (config.num_layers,),
                         generator=rng).tolist()


def layer_generator(seed: Optional[int], device) -> Optional[torch.Generator]:
    """A generator on ``device`` seeded with ``seed``, or None."""
    if seed is None:
        return None
    return torch.Generator(device=device).manual_seed(seed)


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
