"""Sequence parallelism: ring attention and Ulysses all-to-all attention.

Counterpart of ``ray_tpu/parallel/ring_attention.py``. The mesh's "seq"
axis holds the sequence in chunks, one per rank, in order. Both functions
take and return this rank's chunk, [B, T/n, heads, D], and are
differentiable.

``ring_attention`` runs its pieces through the flash kernels: each of the n
steps computes the local query chunk against the key/value chunk it holds
with K2 (``ray_tpu_torch::flash_fwd_lse``; causal on the diagonal chunk,
not causal below it, skipped above it, where the reference computes the
piece and masks it to zero), merges the (out, lse) pairs in f32 by their
lse, and passes the key/value chunk to the next rank, the transfer posted
before the step's compute so that it can overlap it. Its backward runs
``ray_tpu_torch::flash_bwd`` (K4, then K3) per step against the global out
and lse, so delta = rowsum(dO * O) and P = exp(s - lse) are the whole
sequence's; dQ accumulates on its rank, and dK/dV travel round the ring
with their chunk and reach home after n hops. The per-step body
(``ring_piece``, ``ring_merge``, ``ring_piece_bwd``) is plain functions of
local tensors and chunk indices; the collectives live in the loop.

GQA: the ring carries the kv heads as they are (Hkv of them) and the
kernels read kv head h // (H / Hkv) for query head h in place; the
reference repeats the kv heads to H before its ring. The values are the
same and the traffic is H / Hkv times smaller.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ray_tpu_torch.ops import attention as attn
from ray_tpu_torch.parallel._collectives import (
    all_to_all,
    axis_group,
    exchange,
    wait,
)
from ray_tpu_torch.parallel.mesh import axis_size

Piece = Optional[Tuple[torch.Tensor, torch.Tensor]]


def _piece_causal(q_chunk: int, kv_chunk: int, causal: bool) -> Optional[bool]:
    """The kernels' causal flag for one piece; None when causality masks
    the whole piece (a key chunk after the query chunk)."""
    if not causal:
        return False
    if kv_chunk > q_chunk:
        return None
    return kv_chunk == q_chunk


def ring_piece(q, k, v, q_chunk: int, kv_chunk: int, causal: bool) -> Piece:
    """(out [B, T, H, D] in q's dtype, lse [B, H, T] f32) of query chunk
    ``q_chunk`` against key/value chunk ``kv_chunk`` (equal chunk lengths),
    through K2 on CUDA tensors and its plain version on CPU ones; None when
    the piece is masked out."""
    flag = _piece_causal(q_chunk, kv_chunk, causal)
    if flag is None:
        return None
    return attn.flash_fwd_lse(q, k, v, flag, attn.DEFAULT_BLOCK_Q,
                              attn.DEFAULT_BLOCK_K, False)


def _rows(w: torch.Tensor) -> torch.Tensor:
    """[B, H, T] -> [B, T, H, 1], to scale [B, T, H, D] rows."""
    return w.permute(0, 2, 1)[..., None]


def ring_merge(acc: Piece, piece: Piece) -> Piece:
    """Merge a piece into the accumulated (out f32, lse f32) by their lse:
    the reference's online-softmax (o, m, l) merge written with lse."""
    if piece is None:
        return acc
    o, lse = piece[0].to(torch.float32), piece[1]
    if acc is None:
        return o, lse
    o_acc, lse_acc = acc
    lse_new = torch.logaddexp(lse_acc, lse)
    return (o_acc * _rows(torch.exp(lse_acc - lse_new))
            + o * _rows(torch.exp(lse - lse_new)), lse_new)


def ring_piece_bwd(q, k, v, out, lse, do, q_chunk: int, kv_chunk: int,
                   causal: bool):
    """(dq, dk, dv) of one piece, through K4 then K3 on CUDA tensors and
    their plain versions on CPU ones, from the whole sequence's ``out``
    and ``lse`` for the local query chunk; None when the piece is masked
    out."""
    flag = _piece_causal(q_chunk, kv_chunk, causal)
    if flag is None:
        return None
    return attn.flash_bwd(q, k, v, out, lse, do, flag, attn.DEFAULT_BLOCK_Q,
                          attn.DEFAULT_BLOCK_K, False)


def _rotate(tensors, group, n: int, me: int, tag: int = 0):
    """Post the sends of ``tensors`` to the next rank of the ring and the
    receives of their likes from the previous one: (requests, received)."""
    recv = [torch.empty_like(t) for t in tensors]
    reqs = exchange([(t, (me + 1) % n) for t in tensors],
                    [(r, (me - 1) % n) for r in recv], group, tag)
    return reqs, recv


def _ring_forward(q, k, v, group, n: int, me: int, causal: bool):
    acc, kv = None, (k, v)
    for step in range(n):
        reqs, nxt = _rotate(kv, group, n, me) if step < n - 1 else ([], None)
        acc = ring_merge(acc, ring_piece(q, *kv, me, (me - step) % n, causal))
        wait(reqs)
        kv = nxt
    out, lse = acc
    return out.to(q.dtype), lse


def _ring_backward(q, k, v, out, lse, do, group, n: int, me: int,
                   causal: bool):
    f32 = torch.float32
    dq = torch.zeros(q.shape, dtype=f32, device=q.device)
    dkv = [torch.zeros(x.shape, dtype=f32, device=x.device) for x in (k, v)]
    kv = (k, v)
    for step in range(n):
        reqs, nxt = _rotate(kv, group, n, me) if step < n - 1 else ([], None)
        grads = ring_piece_bwd(q, *kv, out, lse, do, me, (me - step) % n,
                               causal)
        if grads is not None:
            dq += grads[0]
            dkv[0] += grads[1]
            dkv[1] += grads[2]
        # dK/dV travel with their chunk: after step n - 1 they reach home
        more, dkv = _rotate(dkv, group, n, me, tag=2)
        wait(reqs + more)
        kv = nxt
    return dq.to(q.dtype), dkv[0].to(k.dtype), dkv[1].to(v.dtype)


class _Ring(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, group, n, me, causal):
        out, lse = _ring_forward(q, k, v, group, n, me, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (group, n, me, causal)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        grads = _ring_backward(q, k, v, out, lse, do.contiguous(), *ctx.args)
        return (*grads, None, None, None, None)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   mesh=None, axis: str = "seq",
                   causal: bool = True) -> torch.Tensor:
    """Ring attention over the mesh axis ``axis``. q: [B, T/n, H, D] and
    k/v: [B, T/n, Hkv, D], this rank's chunk of the sequence; returns the
    chunk's output. With one rank on the axis (or no mesh) it is
    ``ops.attention.attention``: the kernels for CUDA tensors, the plain
    version for CPU ones."""
    n = axis_size(mesh, axis)
    if n == 1:
        return attn.attention(q, k, v, causal=causal)
    group, n, me = axis_group(mesh, axis)
    return _Ring.apply(q, k, v, group, n, me, causal)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      mesh=None, axis: str = "seq", causal: bool = True,
                      impl: str = "auto") -> torch.Tensor:
    """Ulysses sequence parallelism: an all-to-all turns the sequence-sharded
    chunk [B, T/n, H, D] into the whole sequence on H/n heads, attention
    runs there (``ops.attention.attention`` with ``impl``: "auto" is the
    kernels for CUDA tensors, K1 without a gradient to record and K2 with
    K4/K3 under autograd, and the dense version for CPU ones), and the
    inverse all-to-all brings the output back; the gradient goes through
    both. GQA: the kv heads are split as they are when n divides them, and
    repeated to H first otherwise."""
    n = axis_size(mesh, axis)
    if n == 1:
        return attn.attention(q, k, v, causal=causal, impl=impl)
    H, Hkv = q.shape[2], k.shape[2]
    if H % n != 0:
        raise ValueError(f"heads {H} not divisible by {axis}={n}")
    if Hkv % n != 0:
        k = k.repeat_interleave(H // Hkv, dim=2)
        v = v.repeat_interleave(H // Hkv, dim=2)

    def swap_in(x):
        return all_to_all(x, mesh, axis, split_dim=2, concat_dim=1)

    o = attn.attention(swap_in(q), swap_in(k), swap_in(v), causal=causal,
                       impl=impl)
    return all_to_all(o, mesh, axis, split_dim=1, concat_dim=2)
