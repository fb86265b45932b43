"""Train-layer config dataclasses.

Counterpart of ``ray_tpu/train/config.py`` (reference analogs:
``python/ray/air/config.py`` ScalingConfig, RunConfig, FailureConfig,
CheckpointConfig, and ``python/ray/train/torch/config.py`` TorchConfig for
the process group). ``ScalingConfig.use_gpu`` takes the place of
``use_tpu``: each worker then holds one card, the runtime's ``GPU``
resource. ``DistributedConfig`` is the counterpart of ``JaxConfig``: where
a JAX worker calls ``jax.distributed.initialize``, a worker of the port
joins a ``torch.distributed`` process group. Elasticity bounds live here,
as in the reference.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, Optional


@dataclass
class ScalingConfig:
    """How many train workers to run and what each needs.

    ``num_workers`` is the target world size (one worker per process: a
    process holds at most one rank of a process group). ``use_gpu`` gives
    each worker one card. ``min_workers`` < ``num_workers`` enables elastic
    training: on failure the group may restart smaller.
    """

    num_workers: int = 1
    use_gpu: bool = False
    resources_per_worker: Optional[Dict[str, float]] = None
    placement_strategy: str = "PACK"
    min_workers: Optional[int] = None       # elastic lower bound

    def worker_resources(self) -> Dict[str, float]:
        res = dict(self.resources_per_worker or {})
        res.setdefault("CPU", 1.0)
        if self.use_gpu and "GPU" not in res:
            res["GPU"] = 1.0
        return res

    @property
    def elastic(self) -> bool:
        return self.min_workers is not None and self.min_workers < self.num_workers


@dataclass
class FailureConfig:
    """How many worker-group failures to tolerate before giving up.

    ``max_failures=-1`` retries forever (reference semantics:
    ``air/config.py FailureConfig``).
    """

    max_failures: int = 0


@dataclass
class CheckpointConfig:
    """Top-K checkpoint retention (reference: ``air/config.py
    CheckpointConfig``; manager behavior ``train/v2/_internal/execution/
    checkpoint/checkpoint_manager.py:93``)."""

    num_to_keep: Optional[int] = None
    checkpoint_score_attribute: Optional[str] = None
    checkpoint_score_order: str = "max"  # "max" | "min"

    def __post_init__(self):
        if self.checkpoint_score_order not in ("max", "min"):
            raise ValueError("checkpoint_score_order must be 'max' or 'min'")
        if self.num_to_keep is not None and self.num_to_keep <= 0:
            raise ValueError("num_to_keep must be positive or None")


@dataclass
class RunConfig:
    """Where results/checkpoints go and the failure/checkpoint policies."""

    name: Optional[str] = None
    storage_path: Optional[str] = None
    failure_config: FailureConfig = field(default_factory=FailureConfig)
    checkpoint_config: CheckpointConfig = field(default_factory=CheckpointConfig)

    def resolved_storage_path(self) -> str:
        return os.path.expanduser(
            self.storage_path
            or os.environ.get("RAY_TPU_TORCH_STORAGE_PATH",
                              "~/ray_tpu_torch_results")
        )


@dataclass
class DistributedConfig:
    """Per-worker process-group setup: the counterpart of ``JaxConfig``
    (reference: ``train/v2/jax/config.py:24`` ``_JaxBackend``, and
    ``train/torch/config.py`` ``_TorchBackend``, which sets MASTER_ADDR/PORT
    and calls ``dist.init_process_group``).

    With ``distributed_init``, each worker joins one process group of the
    group's world size (rank = world rank) when the world has more than one
    worker or the workers hold a card, so that a worker on the card always
    runs under NCCL. ``backend`` defaults to "nccl" for workers that hold a
    card and "gloo" otherwise. The rendezvous is ``tcp://master_address:
    master_port``: by default rank 0's address (the one its runtime
    serves on) and a port free there. ``env_vars`` are set in each worker
    before it joins.
    """

    backend: Optional[str] = None
    distributed_init: bool = True
    master_address: Optional[str] = None
    master_port: Optional[int] = None
    env_vars: Dict[str, str] = field(default_factory=dict)
