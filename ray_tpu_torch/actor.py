"""Actor classes and handles (reference: ``python/ray/actor.py``)."""
from __future__ import annotations

import functools
import os
from typing import Any, Dict, Optional

from ray_tpu_torch._private.worker import get_global_worker
from ray_tpu_torch.remote_function import (
    _LINT_TODO,
    _build_resources,
    _build_strategy,
)

_ACTOR_OPTIONS = {
    "num_cpus",
    "num_gpus",
    "resources",
    "max_restarts",
    "max_task_retries",
    "max_concurrency",
    "concurrency_groups",
    "name",
    "namespace",
    "get_if_exists",
    "lifetime",
    "scheduling_strategy",
    "runtime_env",
    "label_selector",
}


def method(*, concurrency_group: str = None, num_returns: int = None):
    """Decorator tagging an actor method with execution options (reference:
    ``ray.method`` — ``python/ray/actor.py``; concurrency groups:
    ``core_worker/task_execution/concurrency_group_manager.h:38``).

    ``concurrency_group`` routes the method onto the named group's executor
    declared via ``@remote(concurrency_groups={...})``, isolating it from
    other groups' slow calls (e.g. health checks vs. work lanes)."""

    def decorate(fn):
        if concurrency_group is not None:
            fn._rt_concurrency_group = concurrency_group
        if num_returns is not None:
            fn._rt_num_returns = num_returns
        return fn

    return decorate


class ActorMethod:
    def __init__(self, handle: "ActorHandle", method_name: str,
                 num_returns: int = 1,
                 concurrency_group: Optional[str] = None):
        self._handle = handle
        self._method_name = method_name
        self._num_returns = num_returns
        self._concurrency_group = concurrency_group

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Actor method '{self._method_name}' cannot be called directly; "
            f"use .{self._method_name}.remote()."
        )

    def options(self, num_returns: int = None, concurrency_group: str = None,
                **_):
        return ActorMethod(
            self._handle,
            self._method_name,
            # None = keep the declared/@method value, don't reset
            self._num_returns if num_returns is None else num_returns,
            self._concurrency_group if concurrency_group is None
            else concurrency_group,
        )

    def bind(self, *args, **kwargs):
        """Build a DAG node instead of submitting (reference:
        ``dag/class_node.py`` — ``actor.method.bind``)."""
        if self._num_returns != 1:
            raise NotImplementedError(
                "bind() does not support num_returns != 1; return a tuple "
                "and split downstream"
            )
        raise NotImplementedError(
            "bind() needs the DAG layer, which is not ported to "
            "ray_tpu_torch yet (ROADMAP queue 1 item 10)")

    def remote(self, *args, **kwargs):
        worker = get_global_worker()
        refs = worker.submit_actor_task(
            self._handle._actor_id_hex,
            self._method_name,
            args,
            kwargs,
            num_returns=self._num_returns,
            max_task_retries=self._handle._max_task_retries,
            concurrency_group=self._concurrency_group,
        )
        if self._num_returns == 1:
            return refs[0]
        return refs


class ActorHandle:
    def __init__(self, actor_id_hex: str, addr=None, max_task_retries: int = 0,
                 class_name: str = "Actor",
                 method_meta: Optional[Dict[str, int]] = None):
        self._actor_id_hex = actor_id_hex
        self._addr = tuple(addr) if addr else None
        self._max_task_retries = max_task_retries
        self._class_name = class_name
        # method name -> declared num_returns (@method(num_returns=N))
        self._method_meta = method_meta or {}
        if addr is not None:
            try:
                get_global_worker().get_actor_channel(actor_id_hex, addr)
            except Exception:
                pass

    @property
    def _actor_id(self):
        return self._actor_id_hex

    def __getattr__(self, item):
        if item.startswith("_"):
            raise AttributeError(item)
        return ActorMethod(
            self, item, self._method_meta.get(item, 1)
        )

    def __repr__(self):
        return f"ActorHandle({self._class_name}, {self._actor_id_hex[:16]})"

    def __reduce__(self):
        # A handle crossing a process boundary must be resolvable via the
        # head: wait out a still-batching deferred creation (no-op once
        # the create_actor_batch reply landed; never blocks a loop
        # thread — the receiver-side not-found grace covers that window).
        try:
            get_global_worker().ensure_actor_created(self._actor_id_hex)
        except Exception:
            pass
        return (
            ActorHandle,
            (self._actor_id_hex, self._addr, self._max_task_retries,
             self._class_name, self._method_meta),
        )


class ActorClass:
    def __init__(self, cls, options: Optional[Dict[str, Any]] = None):
        self._cls = cls
        self._options = dict(options or {})
        functools.update_wrapper(self, cls, updated=[])
        # Opt-in decoration-time static analysis (RAY_TPU_TORCH_LINT=1); see
        # RemoteFunction.__init__.
        if os.environ.get("RAY_TPU_TORCH_LINT"):
            raise NotImplementedError(_LINT_TODO)

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Actor class '{self._cls.__name__}' cannot be instantiated directly; "
            f"use {self._cls.__name__}.remote()."
        )

    def options(self, **opts) -> "ActorClass":
        bad = set(opts) - _ACTOR_OPTIONS
        if bad:
            raise ValueError(f"unknown actor options: {sorted(bad)}")
        merged = dict(self._options)
        merged.update(opts)
        return ActorClass(self._cls, merged)

    def remote(self, *args, **kwargs) -> ActorHandle:
        worker = get_global_worker()
        opts = self._options
        max_restarts = opts.get("max_restarts", 0)
        cgroups = opts.get("concurrency_groups")
        if cgroups is not None:
            if not isinstance(cgroups, dict) or not all(
                isinstance(k, str) and isinstance(v, int) and v > 0
                for k, v in cgroups.items()
            ):
                raise ValueError(
                    "concurrency_groups must be a dict of "
                    "{group_name: positive max_concurrency}, got "
                    f"{cgroups!r}"
                )
        # Walk the MRO so @method(num_returns=N) on inherited base-class
        # methods is honored too (vars() only sees the leaf class).
        method_meta: Dict[str, int] = {}
        for klass in reversed(type.mro(self._cls)):
            for name, fn in vars(klass).items():
                if callable(fn) and getattr(fn, "_rt_num_returns", None):
                    method_meta[name] = fn._rt_num_returns
        actor_id, addr, existing = worker.create_actor(
            self._cls,
            args,
            kwargs,
            resources=_build_resources(opts),
            strategy=_build_strategy(opts),
            max_restarts=max_restarts,
            max_concurrency=opts.get("max_concurrency", 1),
            concurrency_groups=cgroups,
            method_meta=method_meta,
            name=opts.get("name"),
            namespace=opts.get("namespace", "default"),
            get_if_exists=opts.get("get_if_exists", False),
            runtime_env=opts.get("runtime_env"),
            lifetime=opts.get("lifetime"),
        )
        return ActorHandle(
            actor_id if isinstance(actor_id, str) else actor_id.hex(),
            addr,
            opts.get("max_task_retries", 0),
            self._cls.__name__,
            method_meta,
        )

    @property
    def underlying_class(self):
        return self._cls


def exit_actor():
    """Terminate the current actor from inside one of its methods
    (reference: ``ray.actor.exit_actor``)."""
    raise SystemExit(0)
