"""Deployment declaration and binding.

Reference analogs: ``python/ray/serve/deployment.py`` (Deployment),
``python/ray/serve/api.py:869`` (serve.run), autoscaling config
(``serve/config.py AutoscalingConfig``). ``.bind()`` builds a composition
graph: bound deployments appearing in another deployment's init args are
deployed too and replaced with handles (reference: handle-based model
composition).

Counterpart of ``ray_tpu/serve/deployment.py``,
over the port's runtime core.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple


@dataclass
class AutoscalingConfig:
    min_replicas: int = 1
    max_replicas: int = 4
    target_ongoing_requests: float = 2.0
    upscale_delay_s: float = 0.5
    downscale_delay_s: float = 2.0


@dataclass
class DeploymentConfig:
    num_replicas: int = 1
    max_ongoing_requests: int = 16
    # Handle-side load shedding (reference: Serve max_queued_requests):
    # when this many requests are already in flight across the handle's
    # replicas, further submissions raise BackPressureError (the HTTP
    # proxy maps it to 503) instead of queueing without bound. -1 = off.
    max_queued_requests: int = -1
    ray_actor_options: Dict[str, Any] = field(default_factory=dict)
    user_config: Optional[dict] = None
    autoscaling_config: Optional[AutoscalingConfig] = None
    health_check_period_s: float = 2.0
    version: Optional[str] = None
    gang_size: int = 1  # multi-host replica groups (reference: serve/gang.py)
    gang_strategy: Optional[str] = None  # PACK (default) | STRICT_SPREAD


class Deployment:
    def __init__(self, cls_or_fn, name: str, config: DeploymentConfig):
        self._target = cls_or_fn
        self._name = name
        self._config = config

    @property
    def name(self) -> str:
        return self._name

    @property
    def config(self) -> DeploymentConfig:
        return self._config

    @property
    def target(self):
        return self._target

    def options(self, **kwargs) -> "Deployment":
        import dataclasses

        cfg = dataclasses.replace(self._config)
        name = kwargs.pop("name", self._name)
        for k, v in kwargs.items():
            if not hasattr(cfg, k):
                raise ValueError(f"unknown deployment option '{k}'")
            setattr(cfg, k, v)
        return Deployment(self._target, name, cfg)

    def bind(self, *args, **kwargs) -> "Application":
        return Application(self, args, kwargs)

    def __repr__(self):
        return f"Deployment({self._name})"


class Application:
    """A bound deployment (+ its bound dependencies)."""

    def __init__(self, deployment: Deployment, args: tuple, kwargs: dict):
        self.deployment = deployment
        self.args = args
        self.kwargs = kwargs

    def dependencies(self) -> List["Application"]:
        deps = []

        def scan(v):
            if isinstance(v, Application):
                deps.append(v)
        for a in self.args:
            scan(a)
        for a in self.kwargs.values():
            scan(a)
        return deps


def deployment(cls_or_fn=None, *, name: Optional[str] = None,
               num_replicas: int = 1, max_ongoing_requests: int = 16,
               max_queued_requests: int = -1,
               ray_actor_options: Optional[dict] = None,
               user_config: Optional[dict] = None,
               autoscaling_config: Optional[AutoscalingConfig] = None,
               version: Optional[str] = None,
               gang_size: int = 1,
               gang_strategy: Optional[str] = None,
               health_check_period_s: float = 2.0):
    """``@serve.deployment`` decorator (reference: ``serve/api.py``)."""

    def wrap(target):
        if isinstance(autoscaling_config, dict):
            asc = AutoscalingConfig(**autoscaling_config)
        else:
            asc = autoscaling_config
        cfg = DeploymentConfig(
            num_replicas=num_replicas,
            max_ongoing_requests=max_ongoing_requests,
            max_queued_requests=max_queued_requests,
            ray_actor_options=dict(ray_actor_options or {}),
            user_config=user_config,
            autoscaling_config=asc,
            version=version,
            gang_size=gang_size,
            gang_strategy=gang_strategy,
            health_check_period_s=health_check_period_s,
        )
        return Deployment(target, name or target.__name__, cfg)

    if cls_or_fn is not None:
        return wrap(cls_or_fn)
    return wrap
