"""The train and eval steps: compiled programs on one card, and the SPMD
step on a mesh.

Counterpart of ``ray_tpu/train/step.py``: forward and backward through the
model's ``loss_fn`` (checkpointed per block by the config's remat policy),
then optax's chain, clip by global norm and AdamW on a warmup-cosine
schedule, over every parameter.

On a mesh (``parallel/``) the parameters and the AdamW moments are DTensors
placed by ``param_shardings``, each rank takes its shard of the batch
(``shard_batch_spec``), each parameter is gathered to the layout the model
computes with (``common.mesh_params``), the gradients are summed over the
ranks into the parameters' placements (``sharding.reduce_grads``), and the
update runs on each rank's shards with the global norm of the whole
gradients. Where the model itself communicates (a sequence sharded over
"seq", the GPipe loop over "stage" > 1, or MoE over a sharded batch or
"expert" > 1) the step runs eagerly; elsewhere the gathers, the loss's
shares and the reductions run eagerly around the same compiled programs as
without a mesh, on each rank's local tensors.

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

import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, distribute_tensor

from ray_tpu_torch._private.device import DeviceLike
from ray_tpu_torch.models import common, module_for
from ray_tpu_torch.parallel.mesh import axis_size
from ray_tpu_torch.parallel.sharding import (
    local_shard,
    reduce_grads,
    shard_batch_spec,
    tree_shardings,
)


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
                max_norm: float,
                norm: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Clip ``grads`` in place by their global norm, then one AdamW update
    of ``params`` (and its moments and step counts) in place, at ``lr`` (a
    0-dim tensor), in the multi-tensor ops of torch's capturable AdamW.
    Returns the norm before clipping: ``norm`` when given (the mesh step's,
    over the whole tensors of which these are shards), else the norm of
    ``grads``."""
    with torch.no_grad():
        if norm is None:
            norm = torch.linalg.vector_norm(
                torch.stack(torch._foreach_norm(grads)))
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


def param_shardings(mesh, config, rules=None):
    """Each parameter's ``NamedSharding`` on ``mesh`` by the rules, as a
    tree of the parameter tree's shape. ``config`` may be any model
    family's config; dispatch goes through ``models.module_for``."""
    return tree_shardings(mesh, module_for(config).param_axes(config), rules)


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield prefix + k, v


def _set_param(module: nn.Module, name: str, value: torch.Tensor) -> None:
    *path, leaf = name.split(".")
    owner = module.get_submodule(".".join(path)) if path else module
    setattr(owner, leaf, nn.Parameter(value))


def _distribute(params: nn.Module, shardings) -> None:
    """Each parameter as a DTensor placed by ``shardings`` (every rank
    holds the same whole value, as a seeded init or a converted tree
    gives)."""
    for name, sh in _leaves(shardings):
        p = params.get_parameter(name)
        if isinstance(p, DTensor):
            value = p.detach().redistribute(sh.mesh, sh.placements)
        else:
            value = distribute_tensor(p.detach(), sh.mesh, sh.placements)
        _set_param(params, name, value)


def _constrain(params: nn.Module, opt_state, shardings) -> None:
    """The parameters, and their AdamW moments with them, redistributed to
    ``shardings`` where they are placed otherwise (the reference's
    ``with_sharding_constraint`` on the parameters)."""
    index = {n: i for i, (n, _) in enumerate(params.named_parameters())}
    for name, sh in _leaves(shardings):
        p, i = params.get_parameter(name), index[name]
        if tuple(p.placements) == tuple(sh.placements):
            continue
        _set_param(params, name, p.detach().redistribute(sh.mesh,
                                                         sh.placements))
        for kind in ("exp_avg", "exp_avg_sq"):
            opt_state[kind][i] = opt_state[kind][i].redistribute(
                sh.mesh, sh.placements)


def create_train_state(config, opt: ClipAdamW,
                       generator: Optional[torch.Generator] = None,
                       device: DeviceLike = "cuda",
                       params: Optional[nn.Module] = None,
                       mesh=None, rules=None) -> Dict[str, Any]:
    """{"params", "opt_state", "step"}. Fresh parameters from ``generator``
    on ``device``, or ``params`` as given (for example a JAX tree converted
    by ``models.convert.params_from_numpy``, on its own device). With
    ``mesh``, each parameter becomes a DTensor placed by
    ``param_shardings(mesh, config, rules)`` (every rank builds the same
    parameters from the same seed or tree), and each AdamW moment follows
    its parameter's placement."""
    if params is None:
        params = module_for(config).init_params(config, generator, device)
    if mesh is not None:
        _distribute(params, param_shardings(mesh, config, rules))
    return {"params": params, "opt_state": opt.init(params), "step": 0}


def _mesh_programs(config, mesh, pipelined: bool, backend: Optional[str]):
    """(the programs' backend, the mesh the model's loss sees). The model
    calls collectives itself on ``mesh`` for ring or Ulysses attention over
    a sharded sequence, the GPipe loop over several stages, and MoE over a
    sharded batch or several expert ranks: then the programs run eagerly
    ("auto" or None; a program does not trace a collective, and any other
    backend raises) and the loss takes the mesh. Otherwise ``backend`` as
    without a mesh, and the loss takes none: it computes on the local
    tensors that the step gathers for it."""
    def size(axis):
        return axis_size(mesh, axis)

    if mesh is None or not (
            size("seq") > 1 or (pipelined and size("stage") > 1)
            or (getattr(config, "moe", None) is not None and any(
                size(a) > 1 for a in ("data", "fsdp", "seq", "expert")))):
        return backend, None
    if backend not in ("auto", None):
        raise ValueError(f"backend {backend!r}: a model that communicates on "
                         "its mesh runs eagerly; use 'auto' or None")
    return None, mesh


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


def _device(params: nn.Module) -> torch.device:
    return next(params.parameters()).device


def _loss_batch(batch: Dict[str, Any], device: torch.device,
                mesh=None) -> Dict[str, Any]:
    """The loss batch on ``device``, outside the compiled program; on a mesh
    this rank's shard of it (``shard_batch_spec``) from the whole batch
    (tensors, arrays or DTensors), which every rank passes alike."""
    batch = {k: v.full_tensor() if isinstance(v, DTensor) else v
             for k, v in batch.items()}
    inputs, targets, mask = common.next_token_batch(batch, device)
    if mesh is not None:
        spec = shard_batch_spec(mesh)
        inputs, targets = local_shard(inputs, spec), local_shard(targets, spec)
        mask = None if mask is None else local_shard(mask, spec)
    return {"inputs": inputs, "targets": targets, "mask": mask}


def _local(x: torch.Tensor) -> torch.Tensor:
    return x.to_local() if isinstance(x, DTensor) else x


def _mesh_update(update_program, dev, opt: "ClipAdamW", opt_state,
                 params: nn.Module, count: int, mesh) -> torch.Tensor:
    """The AdamW update of a mesh step on each rank's shards: the global
    norm of the whole gradients (each shard's squares counted once over the
    ranks that hold it alike), then ``clip_adamw_``'s program on the local
    shards."""
    plist, grads, *rest = opt.inputs(opt_state, params, count)
    local_grads = [_local(g) for g in grads]
    sq = torch.zeros((), dtype=torch.float32, device=local_grads[0].device)
    for g, lg in zip(grads, local_grads):
        copies = 1
        if isinstance(g, DTensor):
            copies = math.prod(n for n, pl in zip(mesh.shape, g.placements)
                               if isinstance(pl, Replicate))
        sq = sq + lg.to(torch.float32).pow(2).sum() / copies
    dist.all_reduce(sq)
    return update_program(dev, [_local(p) for p in plist], local_grads,
                          *[[_local(t) for t in ts] for ts in rest[:3]],
                          rest[3], **opt.hyper, norm=sq.sqrt())


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
    numbers).

    On ``mesh`` (see the module's docstring) every rank calls the step with
    the same whole batch and takes its shard; ``rules`` place the
    parameters (and their moments) by ``param_shardings(mesh, config,
    rules)`` before the step, as the reference constrains them. The loss
    and ``grad_norm`` are the whole batch's, alike on every rank. Where
    the model communicates on the mesh the step is eager ("auto" or None;
    another backend raises); elsewhere ``backend`` applies to the same
    programs as without a mesh, run on the gathered local tensors."""
    pipelined = bool(pipeline_microbatches)
    backend, in_model = _mesh_programs(config, mesh, pipelined, backend)
    model = module_for(config)
    p_shard = (param_shardings(mesh, config, rules)
               if mesh is not None and rules is not None else None)

    def loss_fn(tree, batch, noise):
        return model.loss_fn(tree, batch, config,
                             pipeline_microbatches=pipeline_microbatches,
                             router_noise=noise, mesh=in_model)

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
        if p_shard is not None:
            _constrain(params, opt_state, p_shard)
        batch = _loss_batch(batch, dev, mesh)
        # the router's noise covers the whole batch's tokens
        n_tokens = batch["inputs"].numel() * math.prod(
            axis_size(mesh, a) for a in ("data", "fsdp", "seq"))
        noise = (None if pipeline_microbatches else common.router_noise(
            config, n_tokens, (seed << 32) + state["step"], dev))
        params.zero_grad(set_to_none=True)
        if mesh is None or in_model is not None:
            # the program takes the parameters as a dict, so a new module of
            # the same shapes (donate=False) reuses it
            loss = loss_program(dev, common.param_tree(params), batch, noise)
            loss.backward()
        else:
            # the local program's loss is this rank's mean; its share of the
            # whole batch's loss seeds the backward (an MoE model here sees
            # the whole batch on every rank, so its aux splits alike)
            local = common.mesh_params(params, mesh, pipelined)
            weight = common.share_weight(batch["targets"], batch["mask"], mesh)
            share = loss_program(dev, local, batch, noise) * weight
            share.backward()
            loss = common.summed(share)
        if mesh is None:
            grad_norm = update_program(
                dev, *opt.inputs(opt_state, params, state["step"]),
                **opt.hyper)
        else:
            reduce_grads(params)
            grad_norm = _mesh_update(update_program, dev, opt, opt_state,
                                     params, state["step"], mesh)
        n = state["step"] + 1
        return (dict(state, params=params, opt_state=opt_state, step=n),
                {"loss": loss.detach(), "grad_norm": grad_norm, "step": n})

    return step


def make_eval_step(config, mesh=None,
                   backend: Optional[str] = "auto") -> Callable:
    """(params, batch) -> loss, without gradients: the analog of the
    reference's ``jax.jit(eval_fn)``, compiled as ``make_train_step``'s
    programs are (``backend``), on a mesh as ``make_train_step``'s.
    Attention runs K1."""
    backend, in_model = _mesh_programs(config, mesh, False, backend)
    model = module_for(config)

    def eval_fn(tree, batch):
        with torch.no_grad():
            return model.loss_fn(tree, batch, config, mesh=in_model)

    program = _program(eval_fn, backend)

    def eval_step(params, batch):
        dev = _device(params)
        batch = _loss_batch(batch, dev, mesh)
        if mesh is None or in_model is not None:
            return program(dev, common.param_tree(params), batch)
        with torch.no_grad():
            local = common.mesh_params(params, mesh, False)
            return common.summed(program(dev, local, batch)
                                 * common.share_weight(batch["targets"],
                                                       batch["mask"], mesh))

    return eval_step
