"""ray_tpu_torch.serve: model serving with replicas, routing, and autoscaling.

Reference analog: ``python/ray/serve``::

    from ray_tpu_torch import serve

    @serve.deployment(num_replicas=2)
    class Model:
        def __call__(self, request):
            return {"answer": ...}

    handle = serve.run(Model.bind(), name="app", route_prefix="/model")
    handle.remote({"x": 1}).result()

Counterpart of ``ray_tpu/serve/__init__.py``,
over the port's runtime core.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional

import cloudpickle

from ray_tpu_torch.serve.deployment import (
    Application,
    AutoscalingConfig,
    Deployment,
    DeploymentConfig,
    deployment,
)
from ray_tpu_torch.serve.handle import (
    BackPressureError,
    DeploymentHandle,
    DeploymentResponse,
    ReplicaDiedError,
    ServeRetryableError,
)
from ray_tpu_torch.serve.multiplex import get_multiplexed_model_id, multiplexed
from ray_tpu_torch.serve.replica import GangContext, batch, get_gang_context

__all__ = [
    "BackPressureError",
    "ReplicaDiedError",
    "ServeRetryableError",
    "Application",
    "AutoscalingConfig",
    "Deployment",
    "DeploymentHandle",
    "DeploymentResponse",
    "GangContext",
    "batch",
    "get_gang_context",
    "get_multiplexed_model_id",
    "multiplexed",
    "delete",
    "deployment",
    "get_app_handle",
    "get_deployment_handle",
    "run",
    "shutdown",
    "start_http_proxy",
    "start_grpc_proxy",
    "status",
]

_proxy = None
_grpc_proxy = None


def _get_or_start_controller():
    import ray_tpu_torch
    from ray_tpu_torch.serve.controller import CONTROLLER_NAME, ServeController

    actor_cls = ray_tpu_torch.remote(max_concurrency=64)(ServeController)
    return actor_cls.options(
        name=CONTROLLER_NAME, get_if_exists=True
    ).remote()


def _collect_specs(app: Application, specs: Dict[str, dict],
                   order: List[str]):
    """DFS over the composition graph; dependency init args become handles."""
    d = app.deployment
    if d.name in specs:
        return
    init_args = []
    for a in app.args:
        if isinstance(a, Application):
            _collect_specs(a, specs, order)
            init_args.append(DeploymentHandle(a.deployment.name))
        else:
            init_args.append(a)
    init_kwargs = {}
    for k, a in app.kwargs.items():
        if isinstance(a, Application):
            _collect_specs(a, specs, order)
            init_kwargs[k] = DeploymentHandle(a.deployment.name)
        else:
            init_kwargs[k] = a
    cfg = d.config
    asc = None
    if cfg.autoscaling_config is not None:
        a = cfg.autoscaling_config
        asc = {
            "min_replicas": a.min_replicas,
            "max_replicas": a.max_replicas,
            "target_ongoing_requests": a.target_ongoing_requests,
            "upscale_delay_s": a.upscale_delay_s,
            "downscale_delay_s": a.downscale_delay_s,
        }
    specs[d.name] = {
        "name": d.name,
        "serialized_target": cloudpickle.dumps(d.target),
        "init_args": tuple(init_args),
        "init_kwargs": init_kwargs,
        "num_replicas": cfg.num_replicas,
        "max_ongoing": cfg.max_ongoing_requests,
        "max_queued": cfg.max_queued_requests,
        "actor_options": cfg.ray_actor_options,
        "user_config": cfg.user_config,
        "autoscaling": asc,
        "version": cfg.version,
        "gang_size": cfg.gang_size,
        "gang_strategy": cfg.gang_strategy,
    }
    order.append(d.name)


def run(app: Application, *, name: str = "default",
        route_prefix: Optional[str] = "/",
        local_testing_mode: bool = False,
        _blocking_timeout: float = 60.0) -> DeploymentHandle:
    """Deploy an application; returns a handle to its ingress deployment
    (reference: ``serve.run`` ``api.py:869``). ``local_testing_mode=True``
    instantiates the graph in-process without a cluster (reference:
    ``_private/local_testing_mode.py``)."""
    if local_testing_mode:
        from ray_tpu_torch.serve.local_testing import run_local

        return run_local(app)
    import ray_tpu_torch

    controller = _get_or_start_controller()
    specs: Dict[str, dict] = {}
    order: List[str] = []
    _collect_specs(app, specs, order)
    ingress = app.deployment.name
    ray_tpu_torch.get(
        controller.deploy.remote(
            name, [specs[n] for n in order], route_prefix, ingress
        ),
        timeout=_blocking_timeout,
    )
    # block until every deployment has its replicas (jittered poll: many
    # drivers deploying at once must not hammer the controller in lockstep)
    from ray_tpu_torch._private.backoff import Backoff

    poll = Backoff(base=0.05, cap=0.5)
    deadline = time.time() + _blocking_timeout
    while time.time() < deadline:
        st = ray_tpu_torch.get(controller.status.remote(), timeout=30)
        if all(
            st.get(n, {}).get("running", 0) >= min(specs[n]["num_replicas"], 1)
            for n in order
        ):
            break
        poll.sleep()
    return DeploymentHandle(ingress)


def get_deployment_handle(deployment_name: str, app_name: str = "default"
                          ) -> DeploymentHandle:
    return DeploymentHandle(deployment_name)


def get_app_handle(name: str = "default") -> DeploymentHandle:
    import ray_tpu_torch

    controller = _get_or_start_controller()
    routes = ray_tpu_torch.get(controller.get_routes.remote(), timeout=30)
    for _, dep in routes.items():
        return DeploymentHandle(dep)
    raise ValueError(f"app '{name}' has no routed ingress")


def status() -> dict:
    import ray_tpu_torch

    return ray_tpu_torch.get(
        _get_or_start_controller().status.remote(), timeout=30
    )


def delete(name: str):
    import ray_tpu_torch

    ray_tpu_torch.get(
        _get_or_start_controller().delete_app.remote(name), timeout=60
    )


def shutdown():
    global _proxy, _grpc_proxy
    import ray_tpu_torch

    try:
        from ray_tpu_torch.serve.controller import CONTROLLER_NAME

        controller = ray_tpu_torch.get_actor(CONTROLLER_NAME)
        ray_tpu_torch.get(controller.shutdown.remote(), timeout=30)
        ray_tpu_torch.kill(controller)
    except Exception:
        pass
    if _proxy is not None:
        try:
            ray_tpu_torch.get(_proxy.stop.remote(), timeout=10)
            ray_tpu_torch.kill(_proxy)
        except Exception:
            pass
        _proxy = None
    if _grpc_proxy is not None:
        try:
            ray_tpu_torch.get(_grpc_proxy.stop.remote(), timeout=10)
            ray_tpu_torch.kill(_grpc_proxy)
        except Exception:
            pass
        _grpc_proxy = None


def start_http_proxy(host: str = "127.0.0.1", port: int = 0) -> int:
    """Start the HTTP ingress actor; returns the bound port (reference:
    per-node ProxyActor; one proxy here — the head node's)."""
    global _proxy
    import ray_tpu_torch
    from ray_tpu_torch.serve.http_proxy import HTTPProxy

    actor_cls = ray_tpu_torch.remote(max_concurrency=64)(HTTPProxy)
    _proxy = actor_cls.options(name="__serve_proxy", get_if_exists=True).remote(
        host, port
    )
    return ray_tpu_torch.get(_proxy.start.remote(), timeout=30)


def start_grpc_proxy(host: str = "127.0.0.1", port: int = 0) -> int:
    """Start the gRPC ingress actor; returns the bound port (reference:
    the dual-protocol ProxyActor — ``serve/_private/proxy.py:11``; msgpack
    payloads over generic method handlers, see ``grpc_proxy.py``)."""
    global _grpc_proxy
    import ray_tpu_torch
    from ray_tpu_torch.serve.grpc_proxy import GRPCProxy

    actor_cls = ray_tpu_torch.remote(max_concurrency=64)(GRPCProxy)
    _grpc_proxy = actor_cls.options(
        name="__serve_grpc_proxy", get_if_exists=True
    ).remote(host, port)
    return ray_tpu_torch.get(_grpc_proxy.start.remote(), timeout=30)
