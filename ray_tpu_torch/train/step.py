"""The train step on one card: state, optimizer, update.

Counterpart of ``ray_tpu/train/step.py`` with ``mesh=None``: forward and
backward through the model's ``loss_fn`` (checkpointed per block by the
config's remat policy), then optax's chain, clip by global norm and AdamW on
a warmup-cosine schedule, over every parameter. A mesh, sharding rules or
pipelining need the parallel layer, which is not ported yet, and raise.

Where JAX returns new arrays (and donates the old ones), the port updates
the parameters and the optimizer state in place and returns the same
objects.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import torch
from torch import nn

from ray_tpu_torch._private.device import DeviceLike
from ray_tpu_torch.models import module_for


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0) -> Callable[[int], float]:
    """optax's ``warmup_cosine_decay_schedule``: linear from ``init_value``
    to ``peak_value`` over ``warmup_steps``, then cosine decay to
    ``end_value`` at ``decay_steps`` (warmup included), as a function of the
    number of updates already made."""
    if decay_steps <= warmup_steps:
        raise ValueError(f"decay_steps {decay_steps} must exceed warmup_steps "
                         f"{warmup_steps}")
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cos_steps = decay_steps - warmup_steps

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = 1.0 - max(count, 0) / warmup_steps
            return (init_value - peak_value) * frac + peak_value
        c = min(count - warmup_steps, cos_steps)
        cosine = 0.5 * (1.0 + math.cos(math.pi * c / cos_steps))
        return peak_value * ((1.0 - alpha) * cosine + alpha)

    return schedule


@dataclass
class OptimizerConfig:
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10000
    weight_decay: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    grad_clip: float = 1.0

    def build(self) -> "ClipAdamW":
        return ClipAdamW(self)


class ClipAdamW:
    """optax.chain(clip_by_global_norm(grad_clip), adamw(schedule, b1, b2,
    eps=1e-8, weight_decay)) with the warmup-cosine schedule from 0 to
    ``learning_rate``, over every parameter of a module.

    ``torch.optim.AdamW`` has optax's arithmetic: bias-corrected moments,
    update m_hat / (sqrt(v_hat) + eps), and decay of the pre-update
    parameter by lr * weight_decay. The learning rate of update n (0-based)
    is schedule(n), so the first update has lr 0, as optax reads its
    schedule at the count of updates already made."""

    def __init__(self, config: OptimizerConfig):
        self.config = config
        self.schedule = warmup_cosine_decay_schedule(
            0.0, config.learning_rate, config.warmup_steps,
            max(config.total_steps, config.warmup_steps + 1))

    def init(self, params: nn.Module) -> torch.optim.AdamW:
        c = self.config
        return torch.optim.AdamW(
            params.parameters(), lr=self.schedule(0), betas=(c.b1, c.b2),
            eps=1e-8, weight_decay=c.weight_decay)

    def update(self, opt_state: torch.optim.AdamW, params: nn.Module,
               count: int) -> torch.Tensor:
        """Update ``count`` (0-based) from the gradients in ``.grad``, in
        place. Returns the global gradient norm before clipping (a 0-dim
        f32 tensor on the parameters' device)."""
        for p in params.parameters():
            if p.grad is None:  # unused (GPT-2's dense MLP beside its
                p.grad = torch.zeros_like(p)  # experts): JAX's zero grads
        grads = [p.grad for p in params.parameters()]
        norm = torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(g) for g in grads]))
        # optax scales by max_norm / norm only when norm >= max_norm (no eps)
        coef = torch.where(norm < self.config.grad_clip,
                           torch.ones_like(norm), self.config.grad_clip / norm)
        for g in grads:
            g.mul_(coef)
        for group in opt_state.param_groups:
            group["lr"] = self.schedule(count)
        opt_state.step()
        return norm


def create_train_state(config, opt: ClipAdamW,
                       generator: Optional[torch.Generator] = None,
                       device: DeviceLike = "cuda",
                       params: Optional[nn.Module] = None) -> Dict[str, Any]:
    """{"params", "opt_state", "step"}. Fresh parameters from ``generator``
    on ``device``, or ``params`` as given (for example a JAX tree converted
    by ``models.convert.params_from_numpy``, on its own device)."""
    if params is None:
        params = module_for(config).init_params(config, generator, device)
    return {"params": params, "opt_state": opt.init(params), "step": 0}


def _no_mesh(mesh, rules) -> None:
    if mesh is not None or rules is not None:
        raise NotImplementedError(
            "a mesh or sharding rules need the parallel layer, which is not "
            "ported yet")


def make_train_step(config, opt: ClipAdamW, mesh=None, rules=None,
                    pipeline_microbatches: Optional[int] = None,
                    seed: int = 0) -> Callable:
    """(state, batch) -> (state, {"loss", "grad_norm", "step"}).

    One forward and backward of ``loss_fn`` (the MoE aux loss included) and
    one optimizer update. ``grad_norm`` is the global norm before clipping.
    The parameters and optimizer state are updated in place (the analog of
    the JAX step's ``donate=True``), and the returned state holds the same
    objects with ``step`` advanced. Loss and norm stay on the device:
    reading them synchronises. A jittered MoE router draws from a generator
    seeded by ``seed`` and the step number (JAX folds the step into its
    key; the two draw different numbers)."""
    _no_mesh(mesh, rules)
    model = module_for(config)
    moe = getattr(config, "moe", None)
    needs_rng = moe is not None and moe.router_jitter > 0

    def step(state, batch):
        params = state["params"]
        params.zero_grad(set_to_none=True)
        rng = (torch.Generator().manual_seed((seed << 32) + state["step"])
               if needs_rng else None)
        loss = model.loss_fn(params, batch, config,
                             pipeline_microbatches=pipeline_microbatches,
                             rng=rng)
        loss.backward()
        grad_norm = opt.update(state["opt_state"], params, state["step"])
        n = state["step"] + 1
        return dict(state, step=n), {"loss": loss.detach(),
                                     "grad_norm": grad_norm, "step": n}

    return step


def make_eval_step(config, mesh=None) -> Callable:
    """(params, batch) -> loss, without gradients."""
    _no_mesh(mesh, None)
    model = module_for(config)

    def eval_step(params, batch):
        with torch.no_grad():
            return model.loss_fn(params, batch, config)

    return eval_step
