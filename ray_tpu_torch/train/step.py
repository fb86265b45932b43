"""The train and eval steps on one card, as compiled programs.

Counterpart of ``ray_tpu/train/step.py`` with ``mesh=None``: forward and
backward through the model's ``loss_fn`` (checkpointed per block by the
config's remat policy), then optax's chain, clip by global norm and AdamW on
a warmup-cosine schedule, over every parameter. A mesh, sharding rules or
pipelining need the parallel layer, which is not ported yet, and raise.

The reference returns ``jax.jit`` programs; the port returns
``torch.compile`` programs, the analog: Dynamo traces the step's Python
into one graph per program, each block one nested compile region that
every layer reuses (``models/common.py``, as the reference scans its
layers), AOTAutograd derives the backward and partitions it under the
remat policy, and Inductor fuses the elementwise, cast and reduction work
into Triton kernels. K1-K4 stay inside as opaque
custom ops (``ops/attention.py``). The train step is two programs, the loss
(its compiled backward run by ``loss.backward()``) and the update; the
eval step is one. ``backend=None`` runs the same functions eagerly, the
analog of ``jax.disable_jit``.

With ``donate=True`` (the reference's default) the step updates the
parameters and the optimizer state in place and returns the same objects;
with ``donate=False`` it leaves them as they were and returns new ones.
"""
from __future__ import annotations

import copy
import math
import types
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import torch
from torch import nn

from ray_tpu_torch._private.device import DeviceLike
from ray_tpu_torch.models import common, module_for


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

    The state is a dict of device f32 tensors: "lr", 0-dim, which the host
    fills with schedule(n) before update n (0-based), so the first update
    has lr 0, as optax reads its schedule at the count of updates already
    made; and per parameter, in ``parameters()`` order, the lists "step",
    "exp_avg" and "exp_avg_sq". The update is ``clip_adamw_``, torch's
    AdamW arithmetic (bias-corrected moments, m_hat / (sqrt(v_hat) + eps),
    decay of the pre-update parameter by lr * weight_decay) after the clip:
    one function of tensors, which the train step compiles as one
    program."""

    def __init__(self, config: OptimizerConfig):
        self.config = config
        self.schedule = warmup_cosine_decay_schedule(
            0.0, config.learning_rate, config.warmup_steps,
            max(config.total_steps, config.warmup_steps + 1))
        c = config
        self.hyper = dict(b1=c.b1, b2=c.b2, eps=1e-8,
                          weight_decay=c.weight_decay, max_norm=c.grad_clip)

    def init(self, params: nn.Module) -> Dict[str, Any]:
        plist = list(params.parameters())
        return {
            "lr": torch.zeros((), dtype=torch.float32, device=plist[0].device),
            "step": [torch.zeros((), dtype=torch.float32, device=p.device)
                     for p in plist],
            "exp_avg": [torch.zeros_like(p) for p in plist],
            "exp_avg_sq": [torch.zeros_like(p) for p in plist],
        }

    def inputs(self, opt_state: Dict[str, Any], params: nn.Module,
               count: int) -> tuple:
        """``clip_adamw_``'s tensors for update ``count`` (0-based), from the
        gradients in ``.grad``: the lr filled from the schedule, and zeros
        for a parameter without a gradient (GPT-2's dense MLP beside its
        experts), as JAX's gradients are."""
        plist = list(params.parameters())
        for p in plist:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        opt_state["lr"].fill_(self.schedule(count))
        return (plist, [p.grad for p in plist], opt_state["exp_avg"],
                opt_state["exp_avg_sq"], opt_state["step"], opt_state["lr"])

    def update(self, opt_state: Dict[str, Any], params: nn.Module,
               count: int) -> torch.Tensor:
        """Update ``count`` in place, eagerly. Returns the global gradient
        norm before clipping (a 0-dim f32 tensor on the parameters'
        device)."""
        return clip_adamw_(*self.inputs(opt_state, params, count), **self.hyper)


def clip_adamw_(params, grads, exp_avgs, exp_avg_sqs, steps, lr, *,
                b1: float, b2: float, eps: float, weight_decay: float,
                max_norm: float) -> torch.Tensor:
    """Clip ``grads`` in place by their global norm, then one AdamW update
    of ``params`` (and its moments and step counts) in place, at ``lr`` (a
    0-dim tensor), in the multi-tensor ops of torch's capturable AdamW.
    Returns the norm before clipping."""
    with torch.no_grad():
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        # optax scales by max_norm / norm only when norm >= max_norm (no eps)
        coef = torch.where(norm < max_norm, torch.ones_like(norm),
                           max_norm / norm)
        torch._foreach_mul_(grads, coef)
        torch._foreach_add_(steps, 1)
        torch._foreach_lerp_(exp_avgs, grads, 1 - b1)
        torch._foreach_mul_(exp_avg_sqs, b2)
        torch._foreach_addcmul_(exp_avg_sqs, grads, grads, 1 - b2)
        # step size lr / (1 - b1^t); denominator sqrt(v) / sqrt(1 - b2^t) + eps
        bc1 = torch._foreach_pow(b1, steps)
        bc2 = torch._foreach_pow(b2, steps)
        torch._foreach_sub_(bc1, 1)
        torch._foreach_sub_(bc2, 1)
        torch._foreach_neg_(bc2)
        torch._foreach_div_(bc1, lr)
        torch._foreach_reciprocal_(bc1)         # -lr / (1 - b1^t)
        torch._foreach_sqrt_(bc2)
        denom = torch._foreach_sqrt(exp_avg_sqs)
        torch._foreach_div_(denom, bc2)
        torch._foreach_add_(denom, eps)
        torch._foreach_div_(denom, bc1)
        torch._foreach_mul_(params, 1 - lr * weight_decay)
        torch._foreach_addcdiv_(params, exp_avgs, denom)
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


def _program(fn: Callable, backend: Optional[str]) -> Callable:
    """``fn`` as one program: call(device, *args, **kwargs). ``backend`` "auto" is
    Inductor when ``device`` is CUDA and ``fn`` itself (eager) on the CPU;
    None is always eager; any other name is that ``torch.compile`` backend.
    A compiled program takes the whole graph (``fullgraph=True``: a graph
    break raises) at static shapes (``dynamic=False``: a new shape is a new
    program, as ``jax.jit`` specialises), and never falls back to eager.

    Each program compiles a copy of ``fn`` with a code object of its own:
    Dynamo keeps its programs on the code object, at most
    ``recompile_limit`` (8) of them, and under ``fullgraph`` raises past
    that. Every step built compiles the same code (``loss_fn`` closes over
    a new config), so on shared code a process that builds nine steps
    would fail; on its own code each program holds only its own shapes'
    entries, as a ``jax.jit`` function does."""
    compiled: Dict[str, Callable] = {}

    def call(device: torch.device, *args, **kwargs):
        name = backend
        if name == "auto":
            name = "inductor" if device.type == "cuda" else None
        if name is None:
            return fn(*args, **kwargs)
        if name not in compiled:
            own = types.FunctionType(fn.__code__.replace(), fn.__globals__,
                                     fn.__name__, fn.__defaults__,
                                     fn.__closure__)
            own.__kwdefaults__ = fn.__kwdefaults__
            # Inductor's buffer reuse and in-place buffers write over
            # tensors that a call of a nested compile region (each block,
            # models/common.py) still needs, the parameters among them:
            # with either on, the gradients come out wrong (torch 2.11 and
            # 2.13). Freed buffers still go back to the caching allocator.
            options = ({"allow_buffer_reuse": False, "inplace_buffers": False}
                       if name == "inductor" else None)
            compiled[name] = torch.compile(own, backend=name, fullgraph=True,
                                           dynamic=False, options=options)
        return compiled[name](*args, **kwargs)

    return call


def _tree(params: nn.Module) -> Dict[str, Any]:
    """The parameters as a nested dict by their dotted names (``blocks.qkv_w``
    -> tree["blocks"]["qkv_w"]), the form the models' functions index. A
    compiled program takes this dict, so a new module of the same shapes
    (``donate=False``) reuses the program."""
    tree: Dict[str, Any] = {}
    for name, p in params.named_parameters():
        *path, leaf = name.split(".")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = p
    return tree


def _device(params: nn.Module) -> torch.device:
    return next(params.parameters()).device


def _loss_batch(batch: Dict[str, Any], device: torch.device) -> Dict[str, Any]:
    """The loss batch on ``device``, outside the compiled program."""
    inputs, targets, mask = common.next_token_batch(batch, device)
    return {"inputs": inputs, "targets": targets, "mask": mask}


def make_train_step(config, opt: ClipAdamW, mesh=None, rules=None,
                    pipeline_microbatches: Optional[int] = None,
                    donate: bool = True, seed: int = 0,
                    backend: Optional[str] = "auto") -> Callable:
    """(state, batch) -> (state, {"loss", "grad_norm", "step"}).

    One forward and backward of ``loss_fn`` (the MoE aux loss included) and
    one optimizer update. ``grad_norm`` is the global norm before clipping.
    Loss and norm stay on the device: reading them synchronises.

    The analog of the reference's ``jax.jit(step_fn, donate_argnums=...)``,
    in torch's usual split into two compiled programs: the loss (forward,
    with AOTAutograd's compiled backward run by ``loss.backward()``) and
    the update (``clip_adamw_``, its learning rate a device tensor the host
    fills, so no step recompiles). Selected by ``backend`` as in
    ``_program``: "auto" compiles with Inductor for CUDA parameters and runs
    eagerly for CPU ones; "aot_eager" traces on the CPU without generating
    code; None is the eager step (the analog of ``jax.disable_jit``).

    ``donate=True`` updates the parameters and optimizer state in place and
    returns the same objects; ``donate=False`` leaves the input state as it
    was and returns new ones. A jittered MoE router takes noise drawn
    outside the program from a generator seeded by ``seed`` and the step
    number (JAX folds the step into its key; the two draw different
    numbers)."""
    _no_mesh(mesh, rules)
    model = module_for(config)

    def loss_fn(tree, batch, noise):
        return model.loss_fn(tree, batch, config,
                             pipeline_microbatches=pipeline_microbatches,
                             router_noise=noise)

    loss_program = _program(loss_fn, backend)
    update_program = _program(clip_adamw_, backend)

    def step(state, batch):
        params, opt_state = state["params"], state["opt_state"]
        if not donate:
            params = copy.deepcopy(params)
            opt_state = {k: (v.clone() if isinstance(v, torch.Tensor)
                             else [t.clone() for t in v])
                         for k, v in opt_state.items()}
        dev = _device(params)
        batch = _loss_batch(batch, dev)
        noise = common.router_noise(config, batch["inputs"].numel(),
                                    (seed << 32) + state["step"], dev)
        params.zero_grad(set_to_none=True)
        loss = loss_program(dev, _tree(params), batch, noise)
        loss.backward()
        grad_norm = update_program(
            dev, *opt.inputs(opt_state, params, state["step"]), **opt.hyper)
        n = state["step"] + 1
        return (dict(state, params=params, opt_state=opt_state, step=n),
                {"loss": loss.detach(), "grad_norm": grad_norm, "step": n})

    return step


def make_eval_step(config, mesh=None,
                   backend: Optional[str] = "auto") -> Callable:
    """(params, batch) -> loss, without gradients: the analog of the
    reference's ``jax.jit(eval_fn)``, compiled as ``make_train_step``'s
    programs are (``backend``). Attention runs K1."""
    _no_mesh(mesh, None)
    model = module_for(config)

    def eval_fn(tree, batch):
        with torch.no_grad():
            return model.loss_fn(tree, batch, config)

    program = _program(eval_fn, backend)

    def eval_step(params, batch):
        dev = _device(params)
        return program(dev, _tree(params), _loss_batch(batch, dev))

    return eval_step
