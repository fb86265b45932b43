"""Per-worker train context: ``report`` / ``get_checkpoint`` / ``get_context``.

Counterpart of ``ray_tpu/train/context.py``. Reference analog:
``python/ray/train/v2/api/train_fn_utils.py`` (report :23, get_checkpoint
:149, get_context :137) and the per-worker session plumbing
(``train/v2/_internal/execution/worker_group/thread_runner.py`` — the user
train_fn runs on a thread inside the worker actor; reports flow through a
queue the actor drains on ``poll``).

The context is thread-local: each train-worker actor runs its train_fn on a
dedicated thread, so multiple train workers co-located in one node process
never see each other's context.
"""
from __future__ import annotations

import os
import queue
import shutil
import threading
from typing import Any, Dict, Optional

from ray_tpu_torch.train.checkpoint import Checkpoint

_tls = threading.local()


class TrainContext:
    """Visible to user code inside train_fn."""

    def __init__(
        self,
        world_rank: int,
        world_size: int,
        local_rank: int,
        local_world_size: int,
        node_rank: int,
        experiment_name: str,
        run_dir: str,
        latest_checkpoint: Optional[Checkpoint] = None,
        checkpoint_upload_rank: Optional[int] = 0,
        attempt: int = 0,
        run_nonce: str = "",
    ):
        self._attempt = attempt
        self._run_nonce = run_nonce
        self._world_rank = world_rank
        self._world_size = world_size
        self._local_rank = local_rank
        self._local_world_size = local_world_size
        self._node_rank = node_rank
        self._experiment_name = experiment_name
        self._run_dir = run_dir
        self._latest_checkpoint = latest_checkpoint
        self._checkpoint_upload_rank = checkpoint_upload_rank
        self._report_queue: "queue.Queue[dict]" = queue.Queue()
        self._report_seq = 0
        self.stop_event = threading.Event()

    # -- identity ----------------------------------------------------------
    def get_world_rank(self) -> int:
        return self._world_rank

    def get_world_size(self) -> int:
        return self._world_size

    def get_local_rank(self) -> int:
        return self._local_rank

    def get_local_world_size(self) -> int:
        return self._local_world_size

    def get_node_rank(self) -> int:
        return self._node_rank

    def get_experiment_name(self) -> str:
        return self._experiment_name

    def get_storage_path(self) -> str:
        return self._run_dir

    # -- report plumbing ---------------------------------------------------
    def _persist_checkpoint(self, checkpoint: Checkpoint, step_tag: str) -> str:
        """Copy the worker-local checkpoint dir into run storage.

        Storage is a path every host can see (local disk on one host, a
        shared filesystem across hosts) in place of the reference's fsspec
        upload (``train/_internal/storage.py``).
        """
        import uuid

        dest = os.path.join(self._run_dir, f"checkpoint_{step_tag}")
        if os.path.exists(dest):
            # Tag collision (controller re-run under the same RunConfig.name):
            # never alias to the stale directory — pick a unique one.
            dest = f"{dest}_{uuid.uuid4().hex[:6]}"
        tmp = dest + f".tmp{self._world_rank}"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        shutil.copytree(checkpoint.path, tmp)
        try:
            os.replace(tmp, dest)
        except OSError:
            # Must NOT return dest on failure — that would report a
            # checkpoint that was never persisted and corrupt later resumes.
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        return dest

    def report(self, metrics: Dict[str, Any], checkpoint: Optional[Checkpoint] = None):
        persisted = None
        if checkpoint is not None and (
            self._checkpoint_upload_rank is None
            or self._world_rank == self._checkpoint_upload_rank
        ):
            persisted = self._persist_checkpoint(
                checkpoint, f"{self._attempt:03d}_{self._report_seq:06d}"
            )
        self._report_seq += 1
        self._report_queue.put(
            {
                "metrics": dict(metrics),
                "checkpoint_path": persisted,
                "rank": self._world_rank,
            }
        )

    def get_checkpoint(self) -> Optional[Checkpoint]:
        return self._latest_checkpoint

    def should_stop(self) -> bool:
        """Cooperative early-stop signal (elastic resize / shutdown)."""
        return self.stop_event.is_set()

    def drain_reports(self) -> list:
        out = []
        while True:
            try:
                out.append(self._report_queue.get_nowait())
            except queue.Empty:
                return out


def _set_context(ctx: Optional[TrainContext]):
    _tls.ctx = ctx


def get_context() -> TrainContext:
    ctx = getattr(_tls, "ctx", None)
    if ctx is None:
        raise RuntimeError(
            "ray_tpu_torch.train.get_context() called outside a train_fn"
        )
    return ctx


def report(metrics: Dict[str, Any], checkpoint: Optional[Checkpoint] = None):
    """Report metrics (+ optional checkpoint) from inside train_fn."""
    get_context().report(metrics, checkpoint)


def get_checkpoint() -> Optional[Checkpoint]:
    """Latest persisted checkpoint, for resume-after-failure."""
    return get_context().get_checkpoint()
