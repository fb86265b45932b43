"""Logical-axis sharding rules as DTensor placements.

Counterpart of ``ray_tpu/parallel/sharding.py``: tensor dims carry logical
names, one rules table maps each name to mesh axes, and the result is one
placement per mesh dim, ``Shard(dim)`` where a dim maps to that axis and
``Replicate()`` elsewhere (the analog of a ``PartitionSpec``). The
parameters and the optimizer state live as DTensors with these placements.

Where the reference lets XLA insert the collectives, the port gathers each
parameter to its compute layout where it is used (``compute_view``: every
dim whole except the stage dim in the pipeline and the expert dim of the
experts) and sums the gradients over the ranks after the backward
(``reduce_grads``): the ZeRO-3 pattern, all-gather on use and
reduce-scatter of the gradients, for the fsdp and tensor axes alike. The
tensor axis therefore shards the parameters and the optimizer state, and
each rank of it computes the whole layer on its batch rows; column- and
row-parallel products over it are not ported.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence, Tuple, Union

import torch
from torch.distributed.tensor import (
    DTensor,
    Partial,
    Placement,
    Replicate,
    Shard,
)

from ray_tpu_torch.parallel.mesh import AXES, axis_index, axis_size

# logical axis -> mesh axis (or tuple of mesh axes, or None = replicated)
Rules = Dict[str, Union[str, Tuple[str, ...], None]]

# Default rules for transformer training. Conventions:
#   batch    -> data (+ fsdp when both shard the batch dimension of activations)
#   embed    -> fsdp for params (ZeRO-3 gather-on-use)
#   mlp/heads/kv -> tensor
#   seq      -> seq axis (context parallelism / ring attention)
#   expert   -> expert
#   stage    -> stage (stacked pipeline bodies)
DEFAULT_RULES: Rules = {
    "batch": ("data", "fsdp"),
    "seq": "seq",
    "embed": "fsdp",
    "mlp": "tensor",
    "heads": "tensor",
    "kv": None,
    "head_dim": None,
    "vocab": "tensor",
    "expert": "expert",
    "stage": "stage",
    "norm": None,
}

Placements = Tuple[Placement, ...]


class NamedSharding(NamedTuple):
    """A mesh and one placement per mesh dim (``AXES`` order)."""
    mesh: object
    placements: Placements


def spec_from_logical(logical_axes: Sequence[Optional[str]],
                      rules: Optional[Rules] = None) -> Placements:
    """One placement per mesh axis (``AXES`` order) for a tensor whose dims
    carry ``logical_axes``. A mesh axis shards at most one dim (the first
    that names it). A dim mapped to several axes is sharded over them in
    the entry's order, the first the major one, as ``P(("data", "fsdp"))``
    shards: DTensor nests the shards of one dim in mesh order, so such an
    entry must list its axes in ``AXES`` order."""
    rules = {**DEFAULT_RULES, **(rules or {})}
    placements = [Replicate() for _ in AXES]
    used = set()
    for dim, name in enumerate(logical_axes):
        mesh_axes = None if name is None else rules.get(name)
        if mesh_axes is None:
            continue
        if isinstance(mesh_axes, str):
            mesh_axes = (mesh_axes,)
        mesh_axes = tuple(a for a in mesh_axes if a not in used)
        if list(mesh_axes) != sorted(mesh_axes, key=AXES.index):
            raise ValueError(
                f"logical axis {name!r} maps to {mesh_axes}: a dim sharded "
                f"over several mesh axes must list them in mesh order {AXES}")
        used.update(mesh_axes)
        for a in mesh_axes:
            placements[AXES.index(a)] = Shard(dim)
    return tuple(placements)


def named_sharding(mesh, logical_axes: Sequence[Optional[str]],
                   rules: Optional[Rules] = None) -> NamedSharding:
    return NamedSharding(mesh, spec_from_logical(logical_axes, rules))


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(a is None or isinstance(a, str)
                                        for a in x)


def tree_shardings(mesh, logical_tree, rules: Optional[Rules] = None):
    """Map a nested dict of logical-axis tuples to one of NamedShardings."""
    if _is_axes(logical_tree):
        return named_sharding(mesh, logical_tree, rules)
    return {k: tree_shardings(mesh, v, rules) for k, v in logical_tree.items()}


def shard_batch_spec(mesh, rules: Optional[Rules] = None) -> NamedSharding:
    """Sharding for (batch, seq) token arrays."""
    return named_sharding(mesh, ("batch", "seq"), rules)


def replicated(mesh) -> NamedSharding:
    return NamedSharding(mesh, tuple(Replicate() for _ in AXES))


def with_sharding_constraint(x: torch.Tensor, mesh, logical_axes,
                             rules: Optional[Rules] = None) -> DTensor:
    """``x`` as a DTensor placed by the rules: a DTensor is redistributed
    (differentiably), a plain tensor is taken as the whole value, held
    alike by every rank."""
    placements = spec_from_logical(logical_axes, rules)
    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, mesh, [Replicate() for _ in AXES],
                               run_check=False)
    return x.redistribute(mesh, placements)


def local_shard(x: torch.Tensor, sharding: NamedSharding) -> torch.Tensor:
    """This rank's shard of ``x`` (the whole value, held alike by every
    rank) under ``sharding``, sliced without communication; the shards of
    one dim nest in mesh order (torch.chunk sizes, as DTensor cuts
    them)."""
    mesh, placements = sharding
    for axis, p in zip(AXES, placements):
        if isinstance(p, Shard) and axis_size(mesh, axis) > 1:
            x = x.chunk(axis_size(mesh, axis), p.dim)[axis_index(mesh, axis)]
    return x


class _ComputeView(torch.autograd.Function):
    """A DTensor gathered to its compute placements, as this rank's plain
    tensor. The backward does no communication: it hands the parameter a
    DTensor gradient that is Partial where the view was whole (each rank
    holds its share), which ``reduce_grads`` sums after the backward."""

    @staticmethod
    def forward(ctx, p, compute, grad_placements):
        ctx.mesh, ctx.grad_placements = p.device_mesh, grad_placements
        with torch.no_grad():
            return p.redistribute(p.device_mesh, compute).to_local()

    @staticmethod
    def backward(ctx, g):
        return (DTensor.from_local(g.contiguous(), ctx.mesh,
                                   ctx.grad_placements, run_check=False),
                None, None)


def compute_view(x: torch.Tensor, mesh,
                 keep: Optional[Dict[str, int]] = None) -> torch.Tensor:
    """The layout the port computes with: ``x`` whole, except that each
    mesh axis of ``keep`` ({axis: dim}) leaves dim sharded over it (this
    rank's slice). A DTensor is gathered (its gradient comes back as a
    Partial DTensor, see ``reduce_grads``); a plain tensor is taken as the
    whole value and sliced."""
    keep = keep or {}
    compute = tuple(Shard(keep[a]) if a in keep else Replicate() for a in AXES)
    if not isinstance(x, DTensor):
        return local_shard(x, NamedSharding(mesh, compute))
    # a dim of one rank holds the whole gradient: nothing to sum there
    grads = tuple(Shard(keep[a]) if a in keep else
                  Partial() if axis_size(mesh, a) > 1 else Replicate()
                  for a in AXES)
    return _ComputeView.apply(x, compute, grads)


def reduce_grads(params) -> None:
    """Sum each DTensor parameter's gradient over the ranks into the
    parameter's own placements (all-reduce where the parameter is
    replicated, reduce-scatter where it is sharded), in ``parameters()``
    order, the same on every rank."""
    for p in params.parameters():
        if isinstance(p.grad, DTensor) and p.grad.placements != p.placements:
            p.grad = p.grad.redistribute(p.device_mesh, p.placements)
