"""Local testing mode: run a serve app in-process, no cluster.

Reference analog: ``python/ray/serve/_private/local_testing_mode.py`` —
``serve.run(app, local_testing_mode=True)`` instantiates the deployment
graph directly in the driver process so unit tests exercise user callables
(including composition via handles) without actors, controllers, or HTTP.

Counterpart of ``ray_tpu/serve/local_testing.py``,
over the port's runtime core.
"""
from __future__ import annotations

import inspect
import threading
from typing import Any, Dict


def _run_coro_in_thread(coro):
    """Run a coroutine to completion on its own loop in a fresh thread:
    nested handle calls (async deployment -> async deployment via
    .result()) each get an independent loop, mirroring how distinct
    replicas run on distinct loops in the cluster path."""
    box = {}

    def runner():
        import asyncio

        try:
            box["value"] = asyncio.run(coro)
        except BaseException as e:  # surfaced by the caller
            box["error"] = e

    t = threading.Thread(target=runner, name="rt-serve-local")
    t.start()
    t.join()
    if "error" in box:
        raise box["error"]
    return box["value"]


class LocalResponse:
    """Synchronously-computed stand-in for DeploymentResponse. Exceptions
    surface from .result(), matching the future contract — not at submit."""

    def __init__(self, value: Any = None, error: Exception = None):
        self._value = value
        self._error = error

    def result(self, timeout=None):
        if self._error is not None:
            raise self._error
        return self._value

    @property
    def ref(self):
        raise NotImplementedError(
            "DeploymentResponse.ref needs a cluster object store; "
            "local_testing_mode has none — run against a cluster for "
            "response composition"
        )


class LocalDeploymentHandle:
    """Handle API over an in-process instance."""

    def __init__(self, deployment_name: str, instance: Any,
                 is_function: bool):
        self.deployment_name = deployment_name
        self._instance = instance
        self._is_function = is_function

    def _call(self, method: str, args, kwargs) -> LocalResponse:
        try:
            if self._is_function:
                fn = self._instance
            else:
                fn = getattr(self._instance, method)
            out = fn(*args, **kwargs)
            if inspect.iscoroutine(out):
                out = _run_coro_in_thread(out)
            return LocalResponse(out)
        except Exception as e:
            return LocalResponse(error=e)

    def remote(self, *args, **kwargs) -> LocalResponse:
        return self._call("__call__", args, kwargs)

    def __getattr__(self, item):
        if item.startswith("_"):
            raise AttributeError(item)
        # same caller shape as the cluster handle (reused, not duplicated)
        from ray_tpu_torch.serve.handle import _MethodCaller

        return _MethodCaller(self, item)


def run_local(app) -> LocalDeploymentHandle:
    """Instantiate the app's deployment graph in-process; returns the
    ingress handle. Composition args that are bound Applications become
    local handles, mirroring the cluster path."""
    from ray_tpu_torch.serve.deployment import Application

    cache: Dict[str, LocalDeploymentHandle] = {}

    def build(a: Application) -> LocalDeploymentHandle:
        d = a.deployment
        if d.name in cache:
            return cache[d.name]
        args = [
            build(x) if isinstance(x, Application) else x for x in a.args
        ]
        kwargs = {
            k: build(x) if isinstance(x, Application) else x
            for k, x in a.kwargs.items()
        }
        target = d.target
        is_function = not inspect.isclass(target)
        instance = target if is_function else target(*args, **kwargs)
        if not is_function and d.config.user_config is not None and hasattr(
            instance, "reconfigure"
        ):
            instance.reconfigure(d.config.user_config)
        handle = LocalDeploymentHandle(d.name, instance, is_function)
        cache[d.name] = handle
        return handle

    return build(app)
