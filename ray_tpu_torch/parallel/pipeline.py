"""Pipeline parallelism: the GPipe microbatch loop over the "stage" axis.

Counterpart of ``ray_tpu/parallel/pipeline.py``. Each rank of the stage
axis holds L/S consecutive layers; activations hop stage -> stage + 1 with
point-to-point sends, in a loop of M + S - 1 steps (fill, steady state,
drain), and the last stage's outputs reach every stage through a masked sum
over the axis. Differentiable end to end: the backward runs the hops in
reverse, and the masked sum's backward sums the stages' shares of the
output's gradient (``_collectives``), so the loss that every stage computes
alike from the broadcast output counts once.

The reference's ``lax.scan`` computes every stage on every step and masks
the bubble steps; here a stage computes and communicates only on its own
steps ([s, s + M)), which gives the same values.

The reference's microbatch i is rows [i B/M, (i+1) B/M) of the whole
batch. A rank of a batch-sharded mesh (data x fsdp) holds its own rows of
the batch, so chunking them gives microbatches of other rows. Layers that
treat each row alone do not see the difference; the MoE layer's capacity
queues rank a microbatch's tokens against each other, so with
``collect_aux`` (the MoE models' loop) each rank first takes its shard of
every one of the reference's microbatches, and gives the output back in
its own rows: one all-to-all each way over each batch axis, with uneven
parts where the microbatches are no multiple of data x fsdp.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from ray_tpu_torch.parallel._collectives import (
    all_reduce,
    all_to_all_rows,
    axis_group,
    hop,
)
from ray_tpu_torch.parallel.mesh import axis_index, axis_size

# The batch-sharding axes, outer first: rows are sharded data-major over
# data x fsdp (``sharding.shard_batch_spec``).
_BATCH_AXES = ("data", "fsdp")


def _layouts(B: int, M: int, G: int):
    """The global rows each of the G batch ranks holds: its own (the batch
    sharded data-major, B/G rows each) and its shard of each of the
    reference's M microbatches (rank h's B/(MG) rows of every microbatch
    of B/M rows), in microbatch order."""
    own = [list(range(g * B // G, (g + 1) * B // G)) for g in range(G)]
    mb, shard = B // M, B // (M * G)
    mine = [[R for R in range(B) if R % mb // shard == h] for h in range(G)]
    return own, mine


def _plan(B: int, M: int, sizes: tuple, me: int, back: bool):
    """How rank ``me`` moves its rows from its own layout to its microbatch
    shards (``back``: the inverse): one uneven all-to-all per batch axis of
    size > 1, each a step (axis, order of the rows to send, rows sent to
    each member, rows received from each member), and the order that puts
    the rows received last into the target layout. The whole exchange is
    simulated on row ids, alike on every rank, so no rank asks another
    what it will receive."""
    F = sizes[1]
    own, mine = _layouts(B, M, sizes[0] * F)
    src, dst = (mine, own) if back else (own, mine)
    home = {R: h for h, rows in enumerate(dst) for R in rows}
    held, steps = [list(rows) for rows in src], []
    for dim, axis in enumerate(_BATCH_AXES):
        n = sizes[dim]
        if n == 1:
            continue

        def member(h, dim=dim):         # the coordinate of rank h on axis
            return divmod(h, F)[dim]

        def at(h, j, dim=dim):          # rank h with coordinate j on axis
            c = list(divmod(h, F))
            c[dim] = j
            return c[0] * F + c[1]

        out = [sorted(rows, key=lambda R: member(home[R])) for rows in held]
        order = sorted(range(len(held[me])),
                       key=lambda i: member(home[held[me][i]]))
        send = [sum(member(home[R]) == j for R in held[me]) for j in range(n)]
        parts = [[[R for R in out[at(h, j)] if member(home[R]) == member(h)]
                  for j in range(n)] for h in range(len(held))]
        steps.append((axis, order, send, [len(p) for p in parts[me]]))
        held = [[R for p in ps for R in p] for ps in parts]
    pos = {R: i for i, R in enumerate(held[me])}
    return steps, [pos[R] for R in dst[me]]


def _regroup(x: torch.Tensor, mesh, M: int, back: bool = False):
    """This rank's rows ``x`` -> its shard of each of the reference's M
    microbatches, in microbatch order (``back``: the inverse). M divides
    this rank's rows (``pipeline_apply`` checks it), so each of the
    reference's microbatches splits evenly over the batch ranks, as the MoE
    layer's gather needs; M itself need not be a multiple of them."""
    sizes = tuple(axis_size(mesh, a) for a in _BATCH_AXES)
    G = sizes[0] * sizes[1]
    if G == 1:
        return x
    me = axis_index(mesh, "data") * sizes[1] + axis_index(mesh, "fsdp")
    steps, final = _plan(x.shape[0] * G, M, sizes, me, back)
    for axis, order, send, recv in steps:
        x = all_to_all_rows(x[order], mesh, axis, send, recv)
    return x[final]


def pipeline_apply(stage_params: Any, x: torch.Tensor, *, mesh,
                   apply_stage: Callable[[Any, torch.Tensor], Any],
                   num_microbatches: int, axis: str = "stage",
                   collect_aux: bool = False):
    """Run ``x`` through S pipeline stages.

    stage_params: this stage's layers (the stage's [L/S] slice of the
    stacked blocks). x: [B, ...] activations, batch first, alike on every
    stage; B % num_microbatches == 0. apply_stage(stage_params, mb) applies
    the stage's layers to a microbatch; with ``collect_aux`` it returns
    (y, aux scalar) and pipeline_apply returns (out, aux), aux the sum over
    stages of each stage's aux, summed over its M microbatches and divided
    by M: the MoE load-balancing loss survives the microbatch loop.

    Schedule: M + S - 1 steps; stage 0 takes microbatch i at step i, stage
    s computes at steps [s, s + M), and the last stage's result for
    microbatch i appears at step i + S - 1. Every stage returns the whole
    output. With one stage (or no mesh) it is apply_stage(stage_params,
    x). With ``collect_aux`` on a batch-sharded mesh, each microbatch is
    this rank's shard of the reference's microbatch of the whole batch
    (module docstring)."""
    S = axis_size(mesh, axis)
    if S == 1:
        return apply_stage(stage_params, x)
    M = num_microbatches
    if x.shape[0] % M != 0:
        raise ValueError(f"batch {x.shape[0]} not divisible by microbatches {M}")
    if collect_aux:
        x = _regroup(x, mesh, M)
    group, S, s = axis_group(mesh, axis)
    mbs = x.chunk(M, 0)
    outs, sinks, recv = [], [], None
    aux_acc = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(M + S - 1):
        y = None
        if s <= i < s + M:
            res = apply_stage(stage_params, mbs[i] if s == 0 else recv)
            y, aux = res if collect_aux else (res, None)
            if collect_aux:
                aux_acc = aux_acc + aux.to(torch.float32)
            if s == S - 1:
                outs.append(y)
        send = s < S - 1 and s <= i < s + M
        get = s > 0 and s - 1 <= i < s - 1 + M
        if send or get:
            got = hop(y if send else None, group, s + 1 if send else None,
                      s - 1 if get else None, like=mbs[0])
            if get:
                recv = got
            else:
                sinks.append(got)
    out = torch.cat(outs) if s == S - 1 else torch.zeros_like(x)
    for t in sinks:   # zero; puts the send-only hops on the backward's path
        out = out + t.sum()
    out = all_reduce(out, mesh, axis)
    if collect_aux:
        return (_regroup(out, mesh, M, back=True),
                all_reduce(aux_acc, mesh, axis) / M)
    return out
