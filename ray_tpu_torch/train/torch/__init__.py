"""TorchTrainer: torch.distributed data-parallel training on the runtime.

Counterpart of ``ray_tpu/train/torch/__init__.py`` (reference analog:
``python/ray/train/torch/``: ``TorchConfig`` → ``_TorchBackend``
(config.py:256: sets MASTER_ADDR/PORT, calls ``dist.init_process_group``)
and ``prepare_model`` / ``prepare_data_loader``
(``train/v2/torch/train_loop_utils.py``: DDP wrap + DistributedSampler)).

Workers that hold a card (``ScalingConfig(use_gpu=True)``) join an NCCL
group, even a world of one, and ``prepare_model`` wraps the model in DDP
on the current card; CPU workers join a gloo group when there are two or
more. The worker group forms the process group, as for every trainer
that has a ``DistributedConfig``; ``TorchConfig`` is the reference's name
for it.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

from ray_tpu_torch.train.config import (
    DistributedConfig,
    RunConfig,
    ScalingConfig,
)
from ray_tpu_torch.train.trainer import DataParallelTrainer


class TorchConfig(DistributedConfig):
    """The reference's ``TorchConfig``: ``backend`` None is "nccl" for
    workers on a card, "gloo" else."""


class TorchTrainer(DataParallelTrainer):
    """DDP trainer (reference: ``ray.train.torch.TorchTrainer``)."""

    def __init__(
        self,
        train_loop_per_worker: Callable,
        *,
        train_loop_config: Optional[Dict[str, Any]] = None,
        scaling_config: Optional[ScalingConfig] = None,
        run_config: Optional[RunConfig] = None,
        torch_config: Optional[DistributedConfig] = None,
        datasets: Optional[Dict[str, Any]] = None,
    ):
        super().__init__(
            train_loop_per_worker,
            train_loop_config=train_loop_config,
            scaling_config=scaling_config,
            run_config=run_config,
            backend_config=torch_config or TorchConfig(),
            datasets=datasets,
        )


def prepare_model(model):
    """Wrap in DDP when distributed (reference: ``train_loop_utils.py
    prepare_model``), on NCCL moved to the current card with
    ``device_ids=[current device]``; pass-through without a process
    group."""
    import torch
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return model
    from torch.nn.parallel import DistributedDataParallel

    if dist.get_backend() == "nccl":
        device = torch.cuda.current_device()
        return DistributedDataParallel(model.to(device), device_ids=[device])
    return DistributedDataParallel(model)


def prepare_data_loader(data_loader):
    """Re-build with a DistributedSampler when distributed (reference:
    ``prepare_data_loader``). Shuffling follows the original loader's
    sampler (a RandomSampler means the user asked for shuffle=True), and
    loader construction kwargs carry over."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return data_loader
    from torch.utils.data import DataLoader, RandomSampler
    from torch.utils.data.distributed import DistributedSampler

    shuffle = isinstance(data_loader.sampler, RandomSampler)
    sampler = DistributedSampler(data_loader.dataset, shuffle=shuffle)
    kwargs = dict(
        batch_size=data_loader.batch_size,
        sampler=sampler,
        num_workers=data_loader.num_workers,
        pin_memory=data_loader.pin_memory,
        worker_init_fn=data_loader.worker_init_fn,
        collate_fn=data_loader.collate_fn,
        drop_last=data_loader.drop_last,
        timeout=data_loader.timeout,
        generator=data_loader.generator,
    )
    if data_loader.num_workers > 0:
        kwargs["persistent_workers"] = data_loader.persistent_workers
        kwargs["prefetch_factor"] = data_loader.prefetch_factor
    return DataLoader(data_loader.dataset, **kwargs)
