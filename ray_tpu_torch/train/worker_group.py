"""Train worker group: N actors each running the user train_fn on a thread.

Counterpart of ``ray_tpu/train/worker_group.py`` (reference analog:
``python/ray/train/v2/_internal/execution/worker_group/worker_group.py:88``,
``_start`` :194, ``poll_status`` :663, and ``thread_runner.py``). Ranks are
assigned by creation order, so rank 0 is the first worker. Where the
reference's workers call ``jax.distributed.initialize``, these join a
``torch.distributed`` process group (``DistributedConfig``; reference:
``train/torch/config.py`` ``_TorchBackend``), and a worker that holds a
card makes it its current CUDA device.

``torch.distributed`` holds one default group per process, and the port
runs a node's actors as threads of one process: a process holds at most
one rank (``acquire_dist_slot``), so the workers of a group that forms a
process group must be spread over nodes.
"""
from __future__ import annotations

import logging
import os
import socket
import threading
import traceback
from dataclasses import dataclass, field
from datetime import timedelta
from typing import Any, Callable, Dict, List, Optional

from ray_tpu_torch.train.checkpoint import Checkpoint
from ray_tpu_torch.train.config import DistributedConfig, ScalingConfig
from ray_tpu_torch.train.context import TrainContext, _set_context

logger = logging.getLogger(__name__)

# how long a worker waits for the rest of its process group to join (and
# the group's collectives for each other)
INIT_TIMEOUT_S = 120.0

_dist_lock = threading.Lock()
_dist_owner: Optional[int] = None


def acquire_dist_slot(rank: int) -> None:
    """Claim this process's one ``torch.distributed`` rank for ``rank``;
    raises if another train worker of this process holds it."""
    global _dist_owner
    with _dist_lock:
        if _dist_owner is not None:
            raise RuntimeError(
                "two train workers share one process, and torch.distributed "
                "holds one rank per process: spread the workers over nodes "
                "(ScalingConfig(placement_strategy='SPREAD'))"
            )
        _dist_owner = rank


def release_dist_slot(rank: int) -> None:
    global _dist_owner
    with _dist_lock:
        if _dist_owner == rank:
            _dist_owner = None


def rendezvous_address(port: Optional[int] = None) -> tuple:
    """(address, port) for a process group's rendezvous at this process:
    the address its runtime serves on (the one the cluster reaches it by)
    and ``port``, or a port free there."""
    from ray_tpu_torch._private.worker import get_global_worker

    host = get_global_worker().addr[0]
    if port is None:
        with socket.socket() as s:
            s.bind((host, 0))
            port = s.getsockname()[1]
    return host, port


def init_process_group(backend: str, address: str, port: int, rank: int,
                       world_size: int) -> None:
    """Join the default process group over ``tcp://address:port``, with
    the usual environment (MASTER_ADDR/PORT, RANK, WORLD_SIZE) set. On a
    loopback address the sockets of gloo and NCCL's bootstrap bind ``lo``
    (interface detection fails in hosts without a routable name)."""
    import torch.distributed as dist

    os.environ.update(MASTER_ADDR=address, MASTER_PORT=str(port),
                      RANK=str(rank), WORLD_SIZE=str(world_size))
    if address.startswith("127."):
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    dist.init_process_group(backend, init_method=f"tcp://{address}:{port}",
                            rank=rank, world_size=world_size,
                            timeout=timedelta(seconds=INIT_TIMEOUT_S))


class TrainWorker:
    """Actor hosting one train_fn run (one rank)."""

    def __init__(self):
        self._ctx: Optional[TrainContext] = None
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[str] = None
        self._done = False
        self._result: Any = None
        self._rank: Optional[int] = None   # the process group's, when joined
        self._device: Optional[int] = None  # the card, on a GPU worker

    def setup(
        self,
        world_rank: int,
        world_size: int,
        local_rank: int,
        local_world_size: int,
        node_rank: int,
        experiment_name: str,
        run_dir: str,
        latest_checkpoint_path: Optional[str],
        env_vars: Dict[str, str],
        distributed: Optional[dict] = None,
        attempt: int = 0,
        run_nonce: str = "",
        use_gpu: bool = False,
    ) -> dict:
        for k, v in env_vars.items():
            os.environ[k] = v
        if use_gpu:
            import torch

            from ray_tpu_torch._private.device import resolve_device

            resolve_device("cuda")
            # of the cards the runtime made visible to this node's process
            self._device = local_rank % torch.cuda.device_count()
            torch.cuda.set_device(self._device)
        if distributed:
            acquire_dist_slot(world_rank)
            try:
                init_process_group(
                    distributed["backend"], distributed["master_address"],
                    distributed["master_port"], world_rank, world_size)
            except BaseException:
                release_dist_slot(world_rank)
                raise
            self._rank = world_rank
        ckpt = (
            Checkpoint(latest_checkpoint_path) if latest_checkpoint_path else None
        )
        self._ctx = TrainContext(
            world_rank=world_rank,
            world_size=world_size,
            local_rank=local_rank,
            local_world_size=local_world_size,
            node_rank=node_rank,
            experiment_name=experiment_name,
            run_dir=run_dir,
            latest_checkpoint=ckpt,
            attempt=attempt,
            run_nonce=run_nonce,
        )
        return {"hostname": socket.gethostname(), "pid": os.getpid()}

    def start(self, train_fn: Callable, train_loop_config: Optional[dict]) -> bool:
        assert self._ctx is not None, "setup() must run before start()"
        ctx = self._ctx
        if train_loop_config and "_datasets" in train_loop_config:
            train_loop_config = dict(train_loop_config)
            ctx._datasets = train_loop_config.pop("_datasets")

        def run():
            _set_context(ctx)
            try:
                if self._device is not None:   # the current card is per thread
                    import torch

                    torch.cuda.set_device(self._device)
                takes_arg = True
                try:
                    import inspect

                    takes_arg = len(inspect.signature(train_fn).parameters) > 0
                except (TypeError, ValueError):
                    pass
                self._result = (
                    train_fn(train_loop_config or {}) if takes_arg else train_fn()
                )
            except BaseException as e:  # noqa: BLE001 — surfaced via poll()
                self._error = (
                    f"{type(e).__name__}: {e}\n{traceback.format_exc()}"
                )
            finally:
                self._done = True
                _set_context(None)

        self._thread = threading.Thread(target=run, name="rt-train-fn", daemon=True)
        self._thread.start()
        return True

    def poll(self) -> dict:
        # Capture done/error BEFORE draining: the train thread enqueues its
        # final report before setting _done (in its finally), so done=True
        # guarantees the drain below includes the last report. The reverse
        # order would let the final report slip between drain and the done
        # read and be lost forever.
        done = self._done
        error = self._error
        reports = self._ctx.drain_reports() if self._ctx else []
        return {"reports": reports, "done": done, "error": error}

    def request_stop(self) -> bool:
        if self._ctx:
            self._ctx.stop_event.set()
        return True

    def _leave_process_group(self, abort: bool = False) -> None:
        """Destroy the process group this worker joined once its train_fn
        has ended (a collective still running would use it), or, with
        ``abort``, abort it under a train_fn that still runs: a collective
        stuck on a rank that failed then ends with an error, and this
        process can join the next group."""
        if self._rank is None:
            return
        running = self._thread is not None and self._thread.is_alive()
        if running and not abort:
            return
        import torch.distributed as dist

        if dist.is_initialized():
            if running:
                dist.group.WORLD.abort()
            dist.destroy_process_group()
        release_dist_slot(self._rank)
        self._rank = None

    def join(self, timeout: float = 10.0) -> dict:
        if self._thread:
            self._thread.join(timeout)
        self._leave_process_group()
        return self.poll()

    def shutdown(self, timeout: float = 5.0) -> bool:
        """Stop the train_fn (cooperatively), wait up to ``timeout`` for it
        to end, and leave the process group, aborting it when the train_fn
        still runs. True when the train_fn ended."""
        self.request_stop()
        self.join(timeout)
        self._leave_process_group(abort=True)
        return not (self._thread and self._thread.is_alive())

    def execute(self, fn: Callable, *args, **kwargs):
        """Run an arbitrary function in the worker process (reference:
        ``WorkerGroup.execute``)."""
        return fn(*args, **kwargs)


@dataclass
class WorkerStatus:
    reports: List[dict] = field(default_factory=list)
    done: bool = False
    error: Optional[str] = None
    dead: bool = False


class WorkerGroup:
    """Creates, polls, and tears down the rank-ordered actor group.

    ``dist_config`` None forms no process group (the reference's default
    ``JaxConfig`` initialises nothing either)."""

    def __init__(
        self,
        scaling: ScalingConfig,
        dist_config: Optional[DistributedConfig],
        experiment_name: str,
        run_dir: str,
    ):
        self._scaling = scaling
        self._dist = dist_config or DistributedConfig(distributed_init=False)
        self._experiment_name = experiment_name
        self._run_dir = run_dir
        self.workers: List[Any] = []  # ActorHandles
        self.world_size = 0

    def start(
        self,
        world_size: int,
        train_fn: Callable,
        train_loop_config: Optional[dict],
        latest_checkpoint: Optional[Checkpoint],
        attempt: int = 0,
    ):
        import ray_tpu_torch

        res = self._scaling.worker_resources()
        spread = self._scaling.placement_strategy in ("SPREAD", "STRICT_SPREAD")
        actor_cls = ray_tpu_torch.remote(TrainWorker)
        opts: Dict[str, Any] = {
            "num_cpus": res.get("CPU", 1.0),
            "resources": {k: v for k, v in res.items() if k != "CPU"},
        }
        if spread:
            opts["scheduling_strategy"] = "SPREAD"
        # Append as we create so a mid-creation failure (e.g. unschedulable)
        # still leaves the partial group reachable for shutdown() to kill —
        # otherwise the created actors pin their resources forever.
        self.workers = []
        self.world_size = world_size
        for _ in range(world_size):
            self.workers.append(actor_cls.options(**opts).remote())

        use_gpu = self._scaling.use_gpu
        distributed = None
        if self._dist.distributed_init and (world_size > 1 or use_gpu):
            # every worker dials rank 0's routable address, not its own
            # loopback (reference: _TorchBackend's MASTER_ADDR)
            host, port = ray_tpu_torch.get(self.workers[0].execute.remote(
                rendezvous_address, self._dist.master_port), timeout=60)
            distributed = {
                "backend": (self._dist.backend
                            or ("nccl" if use_gpu else "gloo")),
                "master_address": self._dist.master_address or host,
                "master_port": port,
            }

        # Per-start nonce: scopes control-plane collectives so a re-run (or
        # elastic restart) can never read a previous group's rendezvous keys.
        import uuid as _uuid

        run_nonce = _uuid.uuid4().hex[:12]
        self._last_nonce = run_nonce
        # Deterministic ranks: worker i = rank i, each its own node slot.
        # The setups run at once: joining a process group waits for every
        # rank.
        setups = [
            w.setup.remote(
                i,
                world_size,
                0,
                1,
                i,
                self._experiment_name,
                self._run_dir,
                latest_checkpoint.path if latest_checkpoint else None,
                dict(self._dist.env_vars),
                distributed,
                attempt,
                run_nonce,
                use_gpu,
            )
            for i, w in enumerate(self.workers)
        ]
        ray_tpu_torch.get(setups, timeout=120 + INIT_TIMEOUT_S)
        ray_tpu_torch.get(
            [w.start.remote(train_fn, train_loop_config) for w in self.workers],
            timeout=120,
        )

    def poll(self, timeout: float = 30.0) -> List[WorkerStatus]:
        import ray_tpu_torch

        statuses: List[WorkerStatus] = []
        for w in self.workers:
            # Any failure to reach a worker — actor death, node death, RPC
            # connection loss — is a worker failure the controller must see,
            # not an exception to propagate.
            try:
                h = ray_tpu_torch.get(w.poll.remote(), timeout=timeout)
                statuses.append(
                    WorkerStatus(h["reports"], h["done"], h["error"], dead=False)
                )
            except Exception as e:  # noqa: BLE001
                statuses.append(
                    WorkerStatus([], True, f"worker unreachable: {e}", dead=True)
                )
        return statuses

    def shutdown(self, graceful_timeout: float = 5.0):
        """Stop every worker, let each leave its process group (so that the
        next group can form one in the same processes), then kill them."""
        import ray_tpu_torch

        stops = []
        for w in self.workers:
            try:
                stops.append(w.shutdown.remote(graceful_timeout))
            except Exception:
                pass
        for ref in stops:
            try:
                ray_tpu_torch.get(ref, timeout=graceful_timeout + 5)
            except Exception as e:  # a dead worker holds no group
                logger.debug("train worker shutdown: %s", e)
        for w in self.workers:
            try:
                ray_tpu_torch.kill(w)
            except Exception:
                pass
        self.workers = []
        self.world_size = 0
        # reclaim this group's control-plane rendezvous keys
        nonce = getattr(self, "_last_nonce", None)
        if nonce:
            try:
                from ray_tpu_torch._private.worker import get_global_worker
                from ray_tpu_torch.train.collective import namespace

                w = get_global_worker()
                w.run_sync(w.gcs.call("kv_del_prefix", {
                    "ns": namespace(self._experiment_name, nonce),
                    "prefix": "",
                }))
            except Exception as e:
                # Cleanup of a finished experiment's rendezvous keys is
                # best-effort, but a dropped delete should be traceable.
                logger.debug("collective namespace cleanup failed: %s", e)
