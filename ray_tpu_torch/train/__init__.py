"""ray_tpu_torch.train: the train layer of the port.

Counterpart of ``ray_tpu/train/__init__.py`` (reference:
``python/ray/train`` v2 API). The trainers, the controller, the worker
group, checkpoints and the train collectives run over the port's runtime
(``ray_tpu_torch.init/remote/get``); ``step.py`` holds the train and eval
steps. ``SPMDTrainer`` is the counterpart of ``JaxTrainer``, and
``DistributedConfig`` of ``JaxConfig``.

User surface::

    import ray_tpu_torch
    from ray_tpu_torch import train
    from ray_tpu_torch.train import RunConfig, ScalingConfig, SPMDTrainer

    def train_fn(config):
        ctx = train.get_context()          # rank / world_size / ...
        ckpt = train.get_checkpoint()      # resume point after failure
        ...
        train.report({"loss": loss}, checkpoint=train.Checkpoint.from_directory(d))

    result = SPMDTrainer(
        train_fn,
        scaling_config=ScalingConfig(num_workers=1, use_gpu=True),
        run_config=RunConfig(storage_path="/mnt/shared", name="run1"),
    ).fit()
"""
from ray_tpu_torch.train.checkpoint import (
    Checkpoint,
    CheckpointManager,
    load_pytree,
    save_pytree,
)
from ray_tpu_torch.train.config import (
    CheckpointConfig,
    DistributedConfig,
    FailureConfig,
    RunConfig,
    ScalingConfig,
)
from ray_tpu_torch.train.context import get_checkpoint, get_context, report
from ray_tpu_torch.train.controller import TrainController, TrainingFailedError
from ray_tpu_torch.train.result import Result
from ray_tpu_torch.train.step import (
    ClipAdamW,
    OptimizerConfig,
    create_train_state,
    make_eval_step,
    make_train_step,
    param_shardings,
)
from ray_tpu_torch.train.trainer import (
    DataParallelTrainer,
    SPMDTrainer,
    default_train_loop,
    get_dataset_shard,
)

__all__ = [
    "Checkpoint",
    "CheckpointConfig",
    "CheckpointManager",
    "ClipAdamW",
    "DataParallelTrainer",
    "DistributedConfig",
    "FailureConfig",
    "OptimizerConfig",
    "Result",
    "RunConfig",
    "SPMDTrainer",
    "ScalingConfig",
    "TrainController",
    "TrainingFailedError",
    "create_train_state",
    "default_train_loop",
    "get_checkpoint",
    "get_context",
    "get_dataset_shard",
    "load_pytree",
    "make_eval_step",
    "make_train_step",
    "param_shardings",
    "report",
    "save_pytree",
]
