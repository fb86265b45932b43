"""ray_tpu_torch: the PyTorch/CUDA port of ray_tpu, for NVIDIA Hopper.

A package of its own beside ``ray_tpu``, which stays the reference. It
imports ``torch`` and never ``jax``, nor anything of ``ray_tpu``.

The runtime core (reference: ``python/ray/_private/worker.py`` exports):
    init, shutdown, remote, get, put, wait, kill, cancel, get_actor,
    get_runtime_context, cluster_resources, available_resources, nodes,
    method, exit_actor

Tasks, actors and objects over node processes (one per node, its tasks and
actors as threads), with the card as the ``GPU`` resource
(``@remote(num_gpus=...)``) and torch tensors, CPU or CUDA, as objects.

The models and the layers above them (``DecodeEngine``, ``LLMConfig``, ...)
hand their attention to hand-written CUDA flash-attention kernels:

- ``ray_tpu_torch.ops.attention``: dense and blockwise plain versions, and
  the kernels' wrappers;
- ``ray_tpu_torch.models``: GPT-2, Llama and the conversion of JAX weights;
- ``ray_tpu_torch.parallel``: the mesh, sharding rules, ring and Ulysses
  attention, the pipeline and the Mixture-of-Experts layer;
- ``ray_tpu_torch.llm``: ``LLMConfig``, ``DecodeEngine``, sampling, the
  OpenAI surface;
- ``ray_tpu_torch.train``: the train layer (trainers, controller, worker
  group, checkpoints, train collectives) and the train and eval steps.

Entry points of the models take ``device=`` (default ``"cuda"``) and raise
when CUDA is absent unless the caller asks for ``"cpu"``. The LLM names are
imported on first use: a node process imports this package, and must not
pay the torch import unless its tasks need it.
"""
from __future__ import annotations

import atexit
import inspect
import os
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Union

from ray_tpu_torch import exceptions
from ray_tpu_torch._private import worker as _worker_mod
from ray_tpu_torch._private.gcs import HeadService
from ray_tpu_torch._private.ids import JobID
from ray_tpu_torch._private.node import LocalCluster, spawn_node
from ray_tpu_torch._private.worker import CoreWorker, get_global_worker
from ray_tpu_torch.actor import ActorClass, ActorHandle, exit_actor, method
from ray_tpu_torch.object_ref import ObjectRef
from ray_tpu_torch.remote_function import RemoteFunction
from ray_tpu_torch.runtime_context import get_runtime_context

__version__ = "0.1.0"

# name -> module of the names imported on first use (they import torch)
_LAZY = {name: "ray_tpu_torch.llm" for name in (
    "ByteTokenizer", "DecodeEngine", "GenerationResult", "LLMConfig",
    "SamplingParams")}


def __getattr__(name: str):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(f"module 'ray_tpu_torch' has no attribute {name!r}")
    import importlib

    value = getattr(importlib.import_module(mod), name)
    globals()[name] = value
    return value


__all__ = [
    "init",
    "shutdown",
    "is_initialized",
    "remote",
    "get",
    "put",
    "wait",
    "kill",
    "cancel",
    "get_actor",
    "exit_actor",
    "method",
    "get_runtime_context",
    "cluster_resources",
    "available_resources",
    "nodes",
    "ObjectRef",
    "ActorHandle",
    "exceptions",
    "__version__",
    *_LAZY,
]

_init_lock = threading.Lock()
_cluster: Optional[LocalCluster] = None
_head: Optional[HeadService] = None
# True when THIS process minted/adopted RT_AUTH_TOKEN (cleared on shutdown)
_token_set_by_init = False


def _session_root() -> str:
    """Where sessions keep their logs: the temp dir's ``ray_tpu_torch``
    (never ``ray_tpu``'s, so the two runtimes do not meet)."""
    import tempfile

    return os.path.join(tempfile.gettempdir(), "ray_tpu_torch")


def is_initialized() -> bool:
    return _worker_mod.global_worker is not None


def _prune_old_sessions(keep: int, active: str):
    """Bound <tmp>/ray_tpu_torch growth: session dirs (worker log files) from old
    clusters are removed oldest-first beyond the newest ``keep`` (the
    reference bounds its session dirs the same way — session_latest
    rotation). Best-effort; never blocks startup."""
    import shutil

    def liveness(d: str) -> float:
        """Newest mtime across the session dir and its log files — a LIVE
        cluster keeps appending, so its files stay recent even though the
        dir's own mtime froze at creation."""
        newest = os.path.getmtime(d)
        logs = os.path.join(d, "logs")
        try:
            for f in os.listdir(logs):
                newest = max(newest, os.path.getmtime(os.path.join(logs, f)))
        except OSError:
            pass
        return newest

    try:
        root = _session_root()
        dirs = [
            os.path.join(root, d) for d in os.listdir(root)
            if d.startswith("session_")
        ]
        dirs = [d for d in dirs if os.path.abspath(d) != os.path.abspath(active)]
        dirs.sort(key=liveness)
        cutoff = time.time() - 3600
        for d in dirs[: max(len(dirs) - (keep - 1), 0)]:
            if liveness(d) < cutoff:  # never rmtree a live cluster's logs
                shutil.rmtree(d, ignore_errors=True)
    except OSError:
        pass


def init(
    address: Optional[str] = None,
    *,
    num_cpus: Optional[int] = None,
    num_nodes: int = 1,
    resources: Optional[Dict[str, float]] = None,
    labels: Optional[Dict[str, str]] = None,
    namespace: str = "default",
    ignore_reinit_error: bool = False,
    log_level: str = "WARNING",
    _node_env: Optional[Dict[str, str]] = None,
    _system_config: Optional[Dict[str, Any]] = None,
) -> "ClientContext":
    """Start (or connect to) a cluster.

    - No address: starts a head service in-process plus ``num_nodes`` node
      processes, each with ``num_cpus`` CPUs (default: host cpu count) and any
      extra ``resources`` (e.g. {"GPU": 1}); node 0 also gets the cards
      the GPU manager detects.
    - ``address="host:port"``: connect this driver to an existing head.

    Reference analog: ``ray.init`` (``python/ray/_private/worker.py:1413``).
    """
    global _cluster, _head, _token_set_by_init
    with _init_lock:
        if _worker_mod.global_worker is not None:
            if ignore_reinit_error:
                return ClientContext(_worker_mod.global_worker)
            raise RuntimeError("ray_tpu_torch.init() called twice")
        try:
            return _init_locked(
                address, num_cpus, num_nodes, resources, labels,
                _node_env, _system_config,
            )
        except BaseException:
            # A failed start (node registration timeout, port in use, ...)
            # must not leave half a cluster behind: the NEXT init would
            # die on 'called twice' and every later caller cascades.
            _cleanup_failed_init()
            raise


def _teardown_globals():
    """The ONE teardown path (shutdown() and failed-init cleanup both use
    it — two copies would drift): best-effort, tolerant of half-started
    state in any field."""
    global _cluster, _head, _token_set_by_init
    if _cluster is not None:
        try:
            _cluster.shutdown()
        except Exception:
            pass
        _cluster = None
    w = _worker_mod.global_worker
    if w is not None:
        try:
            w.shutdown()
        except Exception:
            pass
    _worker_mod.global_worker = None
    _head = None
    if _token_set_by_init:
        # A token THIS process minted/adopted dies with the cluster: a
        # later init against a different head must not present it (the
        # rejection is an opaque ConnectionLost). User-provided tokens
        # are left alone.
        os.environ.pop("RT_AUTH_TOKEN", None)
        _token_set_by_init = False


def _cleanup_failed_init():
    _teardown_globals()


def _init_locked(address, num_cpus, num_nodes, resources, labels,
                 _node_env, _system_config):
    global _cluster, _head, _token_set_by_init
    if _system_config:
        # Cluster-wide config overrides (reference: _system_config on
        # the raylet/GCS command line, gcs_server.h:72). Installed here
        # for the driver + in-process head; propagated to spawned
        # nodes as RT_* env vars via _node_env below, and published to
        # the head KV so workers that CONNECT later (remote clusters,
        # head-restart rejoin) apply them at registration.
        from ray_tpu_torch._private.config import rt_config

        rt_config.apply_system_config(_system_config)
        _node_env = dict(
            rt_config.system_config_env(), **(_node_env or {})
        )
        if "memtrack_enabled" in _system_config:
            # The gate resolves at module import (before this apply):
            # re-sync so a driver-side _system_config toggle takes
            # effect in THIS process too, not just in spawned nodes.
            from ray_tpu_torch._private import memtrack

            (memtrack.enable if rt_config.memtrack_enabled
             else memtrack.disable)()
    # Resolve the head address like the reference's RAY_ADDRESS/"auto":
    # env var (set for submitted jobs), then the head's address file.
    if address is None:
        address = os.environ.get("RAY_TPU_TORCH_ADDRESS")
    if address == "auto":
        from ray_tpu_torch._private.head_main import read_address_file

        info = read_address_file()
        if info is None:
            raise ConnectionError(
                "address='auto' but no running head found "
                "(start one with `python -m "
                "ray_tpu_torch._private.head_main`)"
            )
        address = info["address"]
        from ray_tpu_torch._private import auth as _auth

        if _auth.adopt_token(info):
            _token_set_by_init = True
    job_id = JobID.from_random()
    if address is None:
        # Session dir: per-cluster scratch for worker log files (and
        # anything else session-scoped). Spawned nodes learn it via
        # RT_SESSION_DIR (reference: the ray session_latest dir).
        session_dir = os.environ.get("RT_SESSION_DIR")
        if not session_dir:
            session_dir = os.path.join(
                _session_root(),
                f"session_{int(time.time())}_{os.getpid()}",
            )
        os.makedirs(session_dir, exist_ok=True)
        _prune_old_sessions(keep=5, active=session_dir)
        # Cluster auth token (reference: src/ray/rpc/authentication/):
        # minted per cluster; spawned nodes inherit it via the env and
        # every TCP plane requires it as the connection's first
        # message. RT_AUTH_TOKEN= (empty) disables.
        from ray_tpu_torch._private import auth as _auth

        if _auth.ensure_cluster_token():
            _token_set_by_init = True
        _node_env = dict(_node_env or {}, RT_SESSION_DIR=session_dir)
        head = HeadService()
        driver = CoreWorker(
            is_driver=True,
            gcs_addr=("127.0.0.1", 0),  # patched after head start
            job_id=job_id,
            head=head,
        )
        # Globals are assigned BEFORE boot so a mid-boot failure (e.g. the
        # ready-wait timeout) gives the cleanup path something to tear
        # down — otherwise the core-loop thread + head would leak.
        _worker_mod.global_worker = driver
        _head = head
        # Start head + driver service on one core loop.
        ready = threading.Event()
        boot_err: List[BaseException] = []

        def runner():
            import asyncio

            loop = asyncio.new_event_loop()
            asyncio.set_event_loop(loop)
            driver.loop = loop

            async def boot():
                addr = await head.start()
                driver.gcs_addr = addr
                await driver._async_setup()

            try:
                loop.run_until_complete(boot())
            except BaseException as e:  # surface boot failures to caller
                boot_err.append(e)
                ready.set()
                return
            ready.set()
            loop.run_forever()

        t = threading.Thread(target=runner, name="rt-core-loop", daemon=True)
        t.start()
        driver.loop_thread = t
        if not ready.wait(timeout=30):
            raise RuntimeError("head service failed to start")
        if boot_err:
            raise boot_err[0]
        driver._install_ref_hooks()
        driver._start_pusher_shards()
        _cluster = LocalCluster(
            head, driver.gcs_addr, job_id, driver,
            session_dir=session_dir,
        )
        n_cpus = num_cpus if num_cpus is not None else (os.cpu_count() or 1)
        node_res = dict(resources or {})
        node_res["CPU"] = float(n_cpus)
        # Accelerator autodetection (reference: _private/accelerators/):
        # explicit resources always win; detection fills the gaps — and
        # only on ONE simulated node, since all num_nodes processes share
        # this machine's physical cards.
        from ray_tpu_torch._private.accelerators import (
            detect_node_accelerators,
            detect_node_labels,
        )

        accel_res = {
            k: v for k, v in detect_node_accelerators().items()
            if k not in node_res
        }
        accel_labels = detect_node_labels()
        for i in range(num_nodes):
            res_i = dict(node_res)
            labels_i = dict(labels or {})
            if i == 0:
                res_i.update(accel_res)
                labels_i = {**accel_labels, **labels_i}
            _cluster.add_node(
                res_i, labels=labels_i, env=_node_env, wait=False
            )
        # 120s: a node spawn is ~2-4s cold, but a loaded single-core host
        # (CI running a whole suite) can stretch it past the old 30s —
        # and a timeout here used to strand half-initialized state.
        _cluster.wait_for_nodes(num_nodes, timeout=120.0)
        from ray_tpu_torch._private.config import rt_config as _rtc

        if int(_rtc.warm_workers) > 0:
            # Warm worker pool: prefork standby node processes in the
            # background (non-blocking) — add_node consumes one instead
            # of a cold spawn, and the head auto-activates one when
            # demand outgrows schedulable capacity.
            _cluster.start_warm_pool(
                int(_rtc.warm_workers), env=_node_env
            )
    else:
        # Explicit address on the head's own machine: the local
        # address file supplies the token (the `connect with:` hint
        # the head prints must work in a fresh shell). Remote
        # drivers set RT_AUTH_TOKEN themselves.
        if "RT_AUTH_TOKEN" not in os.environ:
            from ray_tpu_torch._private import auth as _auth
            from ray_tpu_torch._private.head_main import read_address_file

            finfo = read_address_file()
            if finfo and finfo.get("address") == address:
                if _auth.adopt_token(finfo):
                    _token_set_by_init = True
        host, port = address.rsplit(":", 1)
        driver = CoreWorker(
            is_driver=True, gcs_addr=(host, int(port)), job_id=job_id
        )
        # assigned before start: a mid-connect failure must be cleanable
        _worker_mod.global_worker = driver
        driver.start_driver()
    if _system_config:
        # Publish to the head KV so later-connecting workers (remote
        # clusters, rejoin after head restart) apply the overrides at
        # registration (_connect_gcs reads __rt/system_config).
        import json as _json

        w = _worker_mod.global_worker
        w.run_sync(w.gcs.call(
            "kv_put", {"ns": "__rt", "key": "system_config"},
            [_json.dumps(_system_config).encode()],
        ))
    atexit.register(shutdown)
    from ray_tpu_torch._private.usage_stats import record_session_start

    record_session_start(extra={"mode": "connect" if address else "local"})
    return ClientContext(driver)


class ClientContext:
    def __init__(self, worker: CoreWorker):
        self.worker = worker
        self.address_info = {
            "gcs_address": worker.gcs_addr,
            "node_id": worker.node_id,
        }

    def __enter__(self):
        return self

    def __exit__(self, *a):
        shutdown()


def shutdown():
    atexit.unregister(shutdown)
    if _worker_mod.global_worker is None and _cluster is None:
        return
    _teardown_globals()


def remote(*args, **kwargs):
    """``@remote`` decorator for functions and classes (reference:
    ``python/ray/_private/worker.py:3479``)."""

    def make(target):
        # through .options(), so an option the port lacks raises here too
        if inspect.isclass(target):
            return ActorClass(target).options(**kwargs)
        return RemoteFunction(target).options(**kwargs)

    if len(args) == 1 and not kwargs and (
        inspect.isfunction(args[0]) or inspect.isclass(args[0])
    ):
        return make(args[0])
    if args:
        raise TypeError("@remote options must be keyword arguments")
    return make


def get(refs, *, timeout: Optional[float] = None):
    w = get_global_worker()
    if isinstance(refs, ObjectRef):
        return w.get(refs, timeout)
    if isinstance(refs, (list, tuple)):
        if not all(isinstance(r, ObjectRef) for r in refs):
            raise TypeError("get() accepts an ObjectRef or a list of ObjectRefs")
        return w.get(list(refs), timeout)
    raise TypeError(f"get() got {type(refs)}")


def put(value: Any) -> ObjectRef:
    return get_global_worker().put(value)


def wait(
    refs: Sequence[ObjectRef],
    *,
    num_returns: int = 1,
    timeout: Optional[float] = None,
    fetch_local: bool = True,
):
    if isinstance(refs, ObjectRef):
        raise TypeError("wait() expects a list of ObjectRefs")
    return get_global_worker().wait(
        list(refs), num_returns=num_returns, timeout=timeout, fetch_local=fetch_local
    )


def kill(actor: ActorHandle, *, no_restart: bool = True):
    get_global_worker().kill_actor(actor._actor_id_hex, no_restart)


def cancel(ref: ObjectRef, *, force: bool = False, recursive: bool = True):
    """Best-effort cancellation of a queued task; a running task is not
    preempted. As in the reference port, a no-op for now."""
    return None


def get_actor(name: str, namespace: str = "default") -> ActorHandle:
    w = get_global_worker()
    h = w.run_sync(w.gcs.call("get_actor", {"name": name, "namespace": namespace}))[0]
    if not h.get("found") or h["actor"]["state"] == "DEAD":
        raise ValueError(f"named actor '{name}' not found in namespace '{namespace}'")
    info = h["actor"]
    return ActorHandle(
        info["actor_id"], tuple(info["addr"]) if info["addr"] else None,
        0, info.get("class_name", "Actor"),
        info.get("method_meta") or {},
    )


def nodes() -> List[dict]:
    w = get_global_worker()
    return w.run_sync(w.gcs.call("get_nodes", {}))[0]["nodes"]


def cluster_resources() -> Dict[str, float]:
    total: Dict[str, float] = {}
    for n in nodes():
        if not n["alive"]:
            continue
        for k, v in n["resources"].items():
            total[k] = total.get(k, 0) + v
    return total


def available_resources() -> Dict[str, float]:
    total: Dict[str, float] = {}
    for n in nodes():
        if not n["alive"]:
            continue
        for k, v in n["available"].items():
            total[k] = total.get(k, 0) + v
    return total


def _internal_cluster() -> Optional[LocalCluster]:
    return _cluster
