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
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from ray_tpu_torch.parallel._collectives import all_reduce, axis_group, hop
from ray_tpu_torch.parallel.mesh import axis_size


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
    x)."""
    S = axis_size(mesh, axis)
    if S == 1:
        return apply_stage(stage_params, x)
    M = num_microbatches
    if x.shape[0] % M != 0:
        raise ValueError(f"batch {x.shape[0]} not divisible by microbatches {M}")
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
        return out, all_reduce(aux_acc, mesh, axis) / M
    return out
