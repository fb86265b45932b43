"""Collectives over one mesh axis, with their gradients.

The port's mesh code is SPMD: every rank runs the same program on its own
shards, and the collectives below are the ones the reference's
``shard_map`` bodies name (``all_gather``, ``psum``, ``all_to_all``,
``ppermute``) or that XLA inserts for it.

Gradients follow one convention. A tensor that every rank of a group holds
alike (replicated) carries, on each rank, a share of its gradient, and the
shares sum to the gradient; a tensor that differs between the ranks (a
shard) carries its whole gradient on its own rank. The train step seeds
each rank's backward with its share of the loss, and the parameters'
gradients are summed over the ranks after the backward
(``sharding.reduce_grads``). Under this convention a collective that
builds a replicated tensor from shards sums in its backward (all_gather's
backward is a sum of the gradients and a slice, all_reduce's is
all_reduce), slicing a replicated tensor has zero-padding as its backward,
an all-to-all's backward is the inverse all-to-all and a point-to-point
hop's is the reverse hop: the transposes JAX uses under ``shard_map`` with
``check_vma=False`` (``psum``'s transpose is ``psum``). It is what makes a
loss that every rank computes alike count once, not once per rank.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ray_tpu_torch.parallel.mesh import axis_index, axis_size


def axis_group(mesh, axis: str):
    """(process group, size, this rank's index) of one mesh axis."""
    return mesh.get_group(axis), axis_size(mesh, axis), axis_index(mesh, axis)


def peer(group, index: int) -> int:
    """Global rank of the group's member at ``index``."""
    return dist.get_global_rank(group, index)


def exchange(sends: Sequence[Tuple[torch.Tensor, int]],
             recvs: Sequence[Tuple[torch.Tensor, int]], group,
             tag: int = 0) -> List:
    """Post point-to-point sends and receives ((tensor, group index) each)
    at once; returns the requests to wait on. The n-th send and the n-th
    receive carry tag ``tag + n``, so messages between one pair that are in
    flight together never cross."""
    ops = [dist.P2POp(dist.isend, t.contiguous(), peer(group, i), group,
                      tag=tag + n) for n, (t, i) in enumerate(sends)]
    ops += [dist.P2POp(dist.irecv, t, peer(group, i), group, tag=tag + n)
            for n, (t, i) in enumerate(recvs)]
    return dist.batch_isend_irecv(ops) if ops else []


def wait(requests) -> None:
    for r in requests:
        r.wait()


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    out = x.contiguous().clone()
    dist.all_reduce(out, group=group)
    return out


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


def all_reduce(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Sum of ``x`` over ``axis`` (``psum``), on every rank of it."""
    if axis_size(mesh, axis) == 1:
        return x
    return _AllReduce.apply(x, mesh.get_group(axis))


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, index, dim):
        ctx.group, ctx.n, ctx.index, ctx.dim = group, n, index, dim
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim)

    @staticmethod
    def backward(ctx, g):
        g = _all_reduce(g, ctx.group).chunk(ctx.n, ctx.dim)[ctx.index]
        return g, None, None, None, None


def all_gather(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """The shards of ``axis`` concatenated along ``dim`` in the axis's order
    (``all_gather(tiled=True)``), on every rank of it."""
    group, n, index = axis_group(mesh, axis)
    if n == 1:
        return x
    return _AllGather.apply(x, group, n, index, dim)


def _all_to_all(x: torch.Tensor, group, n: int, split_dim: int,
                concat_dim: int) -> torch.Tensor:
    send = torch.stack(x.chunk(n, split_dim)).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return torch.cat(recv.unbind(0), concat_dim)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, split_dim, concat_dim):
        ctx.args = (group, n, concat_dim, split_dim)
        return _all_to_all(x, group, n, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, *ctx.args), None, None, None, None


def all_to_all(x: torch.Tensor, mesh, axis: str, split_dim: int,
               concat_dim: int) -> torch.Tensor:
    """``jax.lax.all_to_all(tiled=True)``: ``x`` split into the axis's size
    of chunks along ``split_dim``, chunk j sent to member j, the received
    chunks concatenated along ``concat_dim`` in member order."""
    group, n, _ = axis_group(mesh, axis)
    if n == 1:
        return x
    if x.shape[split_dim] % n:
        raise ValueError(f"dim {split_dim} of {tuple(x.shape)} not divisible "
                         f"by {axis}={n}")
    return _AllToAll.apply(x, group, n, split_dim, concat_dim)


def _all_to_all_rows(x: torch.Tensor, group, send: Sequence[int],
                     recv: Sequence[int]) -> torch.Tensor:
    out = x.new_empty((sum(recv),) + tuple(x.shape[1:]))
    dist.all_to_all_single(out, x.contiguous(), list(recv), list(send),
                           group=group)
    return out


class _AllToAllRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, send, recv):
        ctx.args = (group, recv, send)
        return _all_to_all_rows(x, group, send, recv)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all_rows(g, *ctx.args), None, None, None


def all_to_all_rows(x: torch.Tensor, mesh, axis: str, send: Sequence[int],
                    recv: Sequence[int]) -> torch.Tensor:
    """Rows of ``x`` to the members of ``axis`` in uneven parts: the first
    ``send[0]`` rows to member 0, the next ``send[1]`` to member 1, and so
    on; returns the rows received, ``recv[j]`` of them from member j, in
    member order (``all_to_all_single`` with split sizes). The backward is
    the inverse exchange."""
    group, n, _ = axis_group(mesh, axis)
    if n == 1:
        return x
    return _AllToAllRows.apply(x, group, tuple(send), tuple(recv))


class _Hop(torch.autograd.Function):
    """One step of a pipeline: send ``y`` to the next member and/or receive
    a tensor of ``like``'s shape from the previous one; the backward sends
    the received tensor's gradient back and receives ``y``'s."""

    @staticmethod
    def forward(ctx, anchor, y, group, nxt, prv, like):
        ctx.group, ctx.nxt, ctx.prv = group, nxt, prv
        ctx.y_like = None if y is None else (y.shape, y.dtype, y.device)
        buf = None if prv is None else torch.empty(
            like.shape, dtype=like.dtype, device=like.device)
        wait(exchange([] if nxt is None else [(y, nxt)],
                      [] if prv is None else [(buf, prv)], group))
        return anchor.new_empty(0) if buf is None else buf

    @staticmethod
    def backward(ctx, g):
        gy = None
        if ctx.y_like is not None and ctx.nxt is not None:
            shape, dtype, device = ctx.y_like
            gy = torch.empty(shape, dtype=dtype, device=device)
        wait(exchange([] if ctx.prv is None else [(g, ctx.prv)],
                      [] if gy is None else [(gy, ctx.nxt)], ctx.group))
        return None, gy, None, None, None, None


def hop(y: Optional[torch.Tensor], group, nxt: Optional[int],
        prv: Optional[int], like: torch.Tensor) -> torch.Tensor:
    """Send ``y`` to member ``nxt`` (when not None) and receive from member
    ``prv`` (when not None) a tensor shaped as ``like``. Returns what was
    received, whose gradient goes back to ``prv``; with nothing to receive,
    an empty tensor that the caller must fold into its result (a zero
    sum), so that the backward runs this hop and receives ``y``'s
    gradient from ``nxt``."""
    anchor = like.new_empty(0).requires_grad_()
    return _Hop.apply(anchor, y, group, nxt, prv, like)
