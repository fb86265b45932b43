"""Vocabulary-chunked softmax cross-entropy.

Counterpart of ``ray_tpu/ops/xent.py:chunked_softmax_xent``. The head
projection, logsumexp and gold-logit gather run per sequence chunk, each
chunk under a non-reentrant ``torch.utils.checkpoint`` (the analog of the
JAX ``jax.checkpoint(body)``): at most one [B, c, V] chunk of logits is alive
at a time, and the backward recomputes each chunk's logits instead of
keeping them. The JAX version is XLA code; so is this one, in torch ops, and
no hand-written kernel is owed for it.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


def _chunk_nll(xc: torch.Tensor, head_w: torch.Tensor, tc: torch.Tensor,
               mc: torch.Tensor) -> torch.Tensor:
    """Masked NLL sum of one chunk. The [B, c, V] logits stay in the
    activation dtype; max and exp-sum are taken in f32; the gold logit is
    gathered from the same logits as the logsumexp, so lse >= gold always."""
    logits = torch.einsum("bce,ve->bcv", xc, head_w.to(xc.dtype))
    m = logits.amax(dim=-1).to(torch.float32)
    expsum = torch.exp(logits.to(torch.float32) - m[..., None]).sum(dim=-1)
    lse = m + torch.log(expsum)
    gold = torch.gather(logits, -1, tc[..., None])[..., 0].to(torch.float32)
    return ((lse - gold) * mc).sum()


def chunked_softmax_xent(
    x: torch.Tensor,
    head_w: torch.Tensor,
    targets: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    chunk: int = 512,
) -> torch.Tensor:
    """Mean next-token NLL without a [B, T, V] intermediate.

    x: [B, T, E] final-trunk features (pre-head). head_w: [V, E] (the tied
    embedding or LM head). targets: [B, T] int ids. mask: optional [B, T]
    weights (0 drops a position). Returns an f32 scalar: the masked NLL sum
    over max(mask sum, 1)."""
    B, T, E = x.shape
    c = min(chunk, T)
    pad = (-T) % c   # pad the tail chunk instead of shrinking the chunk
    targets = targets.to(torch.long)
    if mask is None:
        mask = torch.ones((B, T), dtype=torch.float32, device=x.device)
    mask = mask.to(torch.float32)
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
        targets = F.pad(targets, (0, pad))
        mask = F.pad(mask, (0, pad))             # pad rows weigh zero
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(0, T + pad, c):
        total = total + checkpoint(
            _chunk_nll, x[:, i:i + c], head_w, targets[:, i:i + c],
            mask[:, i:i + c], use_reentrant=False,
        )
    return total / torch.clamp(mask.sum(), min=1.0)
