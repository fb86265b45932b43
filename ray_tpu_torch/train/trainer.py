"""User-facing trainers.

Counterpart of ``ray_tpu/train/trainer.py`` (reference analogs:
``python/ray/train/v2/api/data_parallel_trainer.py``, ``DataParallelTrainer``,
and ``train/v2/jax/jax_trainer.py:20``, ``JaxTrainer``). ``SPMDTrainer`` is
``JaxTrainer``'s counterpart: each worker is one process (on the card with
``ScalingConfig(use_gpu=True)``) in one ``torch.distributed`` process
group, and :func:`default_train_loop`, the counterpart of
``default_jax_train_loop``, trains a model of the zoo from its config
alone through ``train.step``'s compiled step.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

from ray_tpu_torch.train.config import (
    DistributedConfig,
    RunConfig,
    ScalingConfig,
)
from ray_tpu_torch.train.controller import TrainController
from ray_tpu_torch.train.result import Result


class DataParallelTrainer:
    """Runs ``train_loop_per_worker`` on a rank-ordered worker group."""

    def __init__(
        self,
        train_loop_per_worker: Callable,
        *,
        train_loop_config: Optional[Dict[str, Any]] = None,
        scaling_config: Optional[ScalingConfig] = None,
        run_config: Optional[RunConfig] = None,
        backend_config: Optional[DistributedConfig] = None,
        datasets: Optional[Dict[str, Any]] = None,
    ):
        self._train_loop = train_loop_per_worker
        self._train_loop_config = train_loop_config
        self._scaling_config = scaling_config or ScalingConfig()
        self._run_config = run_config or RunConfig()
        self._backend_config = backend_config
        self._datasets = datasets or {}

    def fit(self) -> Result:
        config = self._train_loop_config
        if self._datasets:
            # Dataset sharding (reference: train/_internal/data_config.py):
            # each worker iterates its rank's split via get_dataset_shard.
            config = dict(config or {})
            config["_datasets"] = self._datasets
        controller = TrainController(
            self._train_loop,
            config,
            self._scaling_config,
            self._run_config,
            self._backend_config,
        )
        return controller.run()


class SPMDTrainer(DataParallelTrainer):
    """SPMD trainer (reference: ``jax_trainer.py:20``; ``JaxTrainer`` in the
    JAX package).

    Each worker is one process of one process group
    (``distributed_config``, by default NCCL for workers on a card and gloo
    otherwise), formed when the world has more than one worker or the
    workers hold a card. Without ``train_loop_per_worker`` the workers run
    :func:`default_train_loop`.
    """

    def __init__(
        self,
        train_loop_per_worker: Optional[Callable] = None,
        *,
        train_loop_config: Optional[Dict[str, Any]] = None,
        scaling_config: Optional[ScalingConfig] = None,
        run_config: Optional[RunConfig] = None,
        distributed_config: Optional[DistributedConfig] = None,
        datasets: Optional[Dict[str, Any]] = None,
    ):
        super().__init__(
            train_loop_per_worker or default_train_loop,
            train_loop_config=train_loop_config,
            scaling_config=scaling_config,
            run_config=run_config,
            backend_config=distributed_config or DistributedConfig(),
            datasets=datasets,
        )


def _on_mesh(state: Dict[str, Any], config, opt, mesh) -> Dict[str, Any]:
    """``state`` (whole tensors, alike on every rank) with its parameters
    and AdamW moments as DTensors placed by ``param_shardings``."""
    import torch
    from torch.distributed.tensor import distribute_tensor

    from ray_tpu_torch.train.step import create_train_state

    whole = state["opt_state"]
    out = create_train_state(config, opt, params=state["params"], mesh=mesh)
    moments = out["opt_state"]
    with torch.no_grad():
        for kind in ("exp_avg", "exp_avg_sq"):
            moments[kind] = [distribute_tensor(w, d.device_mesh, d.placements)
                             for w, d in zip(whole[kind], moments[kind])]
        for mine, w in zip(moments["step"], whole["step"]):
            mine.copy_(w)
    out["step"] = state["step"]
    return out


def default_train_loop(config: Dict[str, Any]):
    """Complete training loop of a model of the zoo, driven by config alone.

    config keys, the reference's: ``model`` (a preset name, or the config's
    kwargs with ``family``, "gpt2" or "llama", and dtypes by name),
    ``mesh`` (MeshConfig kwargs), ``optimizer`` (OptimizerConfig kwargs),
    ``num_steps``, ``batch_size``, ``seq_len``, ``checkpoint_every`` (0 =
    only at end), ``data_seed``; and ``device`` (default "cuda", which
    raises without CUDA) and ``backend`` (``make_train_step``'s, default
    "auto": compiled on the card, eager on the CPU).

    Without ``mesh``, or on a world of one worker, the step runs without a
    mesh; otherwise on ``MeshConfig(**mesh).build()`` over the group's
    process group. Parameters come from ``torch.Generator().manual_seed(0)``
    (the JAX package's from ``PRNGKey(0)``: the two draw different
    numbers); the batches from ``np.random.default_rng(data_seed)`` as in
    the reference, the same tokens. Reports ``{loss, step,
    tokens_per_sec}`` each step; rank 0 saves checkpoints
    (``save_pytree``); resumes from ``get_checkpoint()`` after failures.
    """
    import tempfile
    import time

    import numpy as np
    import torch

    from ray_tpu_torch._private.device import resolve_device
    from ray_tpu_torch.models import get_preset
    from ray_tpu_torch.models.convert import config_from_kwargs
    from ray_tpu_torch.parallel.mesh import MeshConfig
    from ray_tpu_torch.train import checkpoint as ckpt_mod
    from ray_tpu_torch.train.context import get_checkpoint, get_context, report
    from ray_tpu_torch.train.step import (
        OptimizerConfig,
        create_train_state,
        make_train_step,
    )

    ctx = get_context()
    model = config.get("model", {})
    if isinstance(model, str):  # zoo preset, e.g. "gpt2-small" / "llama-1b"
        model_cfg = get_preset(model)
    else:
        model = dict(model)
        model_cfg = config_from_kwargs(model, model.pop("family", "gpt2"))
    device = resolve_device(config.get("device", "cuda"))
    mesh = None
    if "mesh" in config and ctx.get_world_size() > 1:
        mesh = MeshConfig(**config["mesh"]).build(device.type)
    opt = OptimizerConfig(**config.get("optimizer", {})).build()
    num_steps = int(config.get("num_steps", 10))
    batch_size = int(config.get("batch_size", 8))
    seq_len = int(config.get("seq_len", model_cfg.max_seq_len))
    ckpt_every = int(config.get("checkpoint_every", 0))

    state = create_train_state(model_cfg, opt,
                               torch.Generator().manual_seed(0), device)
    start_step = 0
    prev = get_checkpoint()
    if prev is not None:
        with prev.as_directory() as d:
            state = ckpt_mod.load_pytree(d, target=state)
        start_step = int(state["step"])
    if mesh is not None:
        state = _on_mesh(state, model_cfg, opt, mesh)

    step_fn = make_train_step(model_cfg, opt, mesh,
                              backend=config.get("backend", "auto"))
    rng = np.random.default_rng(int(config.get("data_seed", 0)))

    def next_batch() -> dict:
        toks = rng.integers(
            0, model_cfg.vocab_size, (batch_size, seq_len + 1), dtype=np.int32
        )
        return {"tokens": torch.from_numpy(toks).to(device, torch.long)}

    def save(state, metrics):
        if ctx.get_world_rank() != 0:
            if mesh is not None:
                ckpt_mod.save_pytree(state, None)   # rank 0's gathers
            return
        with tempfile.TemporaryDirectory(prefix="rt_local_ckpt_") as d:
            ckpt_mod.save_pytree(state, d)
            report(metrics, checkpoint=ckpt_mod.Checkpoint(d))

    t0 = time.monotonic()
    for step in range(start_step, num_steps):
        state, metrics = step_fn(state, next_batch())
        if ctx.should_stop():
            break
        loss = float(metrics["loss"])
        dt = max(time.monotonic() - t0, 1e-9)
        t0 = time.monotonic()
        m = {
            "loss": loss,
            "step": step + 1,
            "tokens_per_sec": batch_size * seq_len / dt,
        }
        is_ckpt_step = ckpt_every and (step + 1) % ckpt_every == 0
        if is_ckpt_step or step + 1 == num_steps:
            save(state, m)
        else:
            report(m)
    return {"final_step": int(state["step"])}


def get_dataset_shard(name: str = "train"):
    """This rank's split of a dataset passed to the trainer (reference:
    ``ray.train.get_dataset_shard``)."""
    from ray_tpu_torch.train.context import get_context

    ctx = get_context()
    ds = (getattr(ctx, "_datasets", None) or {}).get(name)
    if ds is None:
        return None
    rank, world = ctx.get_world_rank(), ctx.get_world_size()
    if hasattr(ds, "split"):  # a dataset that splits itself
        # equal shards: unequal row counts would desync SPMD step loops
        return ds.split(world, equal=True)[rank]
    if isinstance(ds, (list, tuple)):
        return list(ds[rank::world])
    return ds
