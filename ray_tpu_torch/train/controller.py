"""Train controller: the control loop over the worker group.

Counterpart of ``ray_tpu/train/controller.py``. Reference analog:
``train/v2/_internal/execution/controller/controller.py:103``
(``_run_control_loop_iteration`` :688, ``run`` :745). As in the JAX
package, the loop runs in the driver process rather than a dedicated
controller actor; the controller-as-actor split can return when jobs
outlive drivers.

Loop shape: scaling decision → start worker group → poll → (aggregate
reports, register rank-0 checkpoints) → on failure consult FailurePolicy +
ScalingPolicy and restart from the latest checkpoint → on completion return
:class:`Result`.
"""
from __future__ import annotations

import os
import time
from typing import Callable, Optional

from ray_tpu_torch.train.checkpoint import CheckpointManager
from ray_tpu_torch.train.config import (
    DistributedConfig,
    RunConfig,
    ScalingConfig,
)
from ray_tpu_torch.train.failure_policy import FailureDecision, FailurePolicy
from ray_tpu_torch.train.result import Result
from ray_tpu_torch.train.scaling_policy import make_scaling_policy
from ray_tpu_torch.train.worker_group import WorkerGroup


class TrainingFailedError(RuntimeError):
    pass


class TrainController:
    def __init__(
        self,
        train_fn: Callable,
        train_loop_config: Optional[dict],
        scaling: ScalingConfig,
        run_config: RunConfig,
        dist_config: Optional[DistributedConfig] = None,
        poll_interval: float = 0.05,
        recovery_timeout: float = 15.0,
    ):
        self._recovery_timeout = recovery_timeout
        self._train_fn = train_fn
        self._train_loop_config = train_loop_config
        self._scaling = scaling
        self._run_config = run_config
        self._dist_config = dist_config
        self._poll_interval = poll_interval

        name = run_config.name or f"train_{int(time.time())}"
        self._run_dir = os.path.join(run_config.resolved_storage_path(), name)
        self._ckpt_manager = CheckpointManager.restore_index(
            run_config.checkpoint_config, self._run_dir
        )
        self._failure_policy = FailurePolicy(run_config.failure_config)
        self._scaling_policy = make_scaling_policy(scaling)
        self._metrics_history: list = []
        self._latest_metrics: dict = {}

    def run(self) -> Result:
        decision = self._scaling_policy.initial_decision()
        world_size = decision.world_size
        attempt = 0
        # World size to revert to if a VOLUNTARY grow restart fails to
        # start (the capacity grow_decision saw raced away): not a training
        # failure, must not consume retries.
        grow_fallback = None
        while True:
            group = WorkerGroup(
                self._scaling,
                self._dist_config,
                os.path.basename(self._run_dir),
                self._run_dir,
            )
            try:
                group.start(
                    world_size,
                    self._train_fn,
                    self._train_loop_config,
                    self._ckpt_manager.latest_checkpoint,
                    attempt=attempt,
                )
            except Exception as e:  # start failed (e.g. resources not yet
                # released after a node death) — treat as a group failure,
                # unless this was a grow attempt: then just fall back.
                group.shutdown()
                if grow_fallback is not None:
                    world_size = grow_fallback
                    grow_fallback = None
                    attempt += 1
                    continue
                error = f"worker group start failed: {e}"
                if (
                    self._failure_policy.make_decision(error)
                    is FailureDecision.RAISE
                ):
                    raise TrainingFailedError(
                        f"training failed after "
                        f"{self._failure_policy.failures - 1} retries: "
                        f"{error}"
                    )
                world_size, attempt = self._await_recovery(error, attempt)
                continue
            grow_fallback = None
            try:
                error = self._monitor(group, world_size)
            except Exception as e:
                error = f"worker group poll failed: {e}"
            group.shutdown()
            if error is None:
                return Result(
                    metrics=self._latest_metrics,
                    checkpoint=self._ckpt_manager.latest_checkpoint,
                    best_checkpoint=self._ckpt_manager.best_checkpoint,
                    path=self._run_dir,
                    metrics_history=self._metrics_history,
                )
            if isinstance(error, tuple) and error[0] == "__grow__":
                # Capacity returned (elastic): resize up from the latest
                # checkpoint. Not a failure — does not consume retries
                # (reference: elastic.py resize decisions).
                grow_fallback = world_size
                world_size = error[1]
                attempt += 1
                continue
            if self._failure_policy.make_decision(error) is FailureDecision.RAISE:
                raise TrainingFailedError(
                    f"training failed after {self._failure_policy.failures - 1} "
                    f"retries: {error}"
                )
            world_size, attempt = self._await_recovery(error, attempt)

    def _await_recovery(self, error, attempt):
        """Wait for leases/health state to settle, then size the restart
        (resources of the failed group release asynchronously)."""
        recovery = None
        deadline = time.monotonic() + self._recovery_timeout
        while time.monotonic() < deadline:
            time.sleep(self._poll_interval * 4)
            recovery = self._scaling_policy.recovery_decision()
            if recovery is not None and recovery.world_size >= 1:
                break
        if recovery is None:
            raise TrainingFailedError(
                f"cannot restart: cluster below min_workers "
                f"({self._scaling.min_workers}); last error: {error}"
            )
        return recovery.world_size, attempt + 1

    def _monitor(self, group: WorkerGroup, world_size: int = 0):
        """Poll until all workers finish. Returns an error string, a
        ("__grow__", n) resize marker, or None."""
        grow_check = getattr(self._scaling_policy, "grow_decision", None)
        next_grow = time.monotonic() + 2.0
        while True:
            statuses = group.poll()
            error = None
            for st in statuses:
                for rep in st.reports:
                    self._ingest_report(rep)
                if st.error:
                    error = st.error
            if error:
                return error
            if all(st.done for st in statuses):
                return None
            # Elastic grow-back: when spare capacity appears mid-run and a
            # checkpoint exists to resume from, restart larger.
            if (
                grow_check is not None
                and time.monotonic() >= next_grow
                and self._ckpt_manager.latest_checkpoint is not None
            ):
                next_grow = time.monotonic() + 2.0
                decision = grow_check(world_size)
                if decision is not None:
                    return ("__grow__", decision.world_size)
            time.sleep(self._poll_interval)

    def _ingest_report(self, rep: dict):
        if rep["rank"] == 0:
            self._latest_metrics = rep["metrics"]
            self._metrics_history.append(rep["metrics"])
        if rep.get("checkpoint_path"):
            self._ckpt_manager.register(rep["checkpoint_path"], rep["metrics"])
