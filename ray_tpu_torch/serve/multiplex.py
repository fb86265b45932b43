"""Model multiplexing: many models behind one deployment.

Reference analog: ``python/ray/serve/multiplex.py`` (``_ModelMultiplexWrapper``)
+ ``api.py @serve.multiplexed`` + ``get_multiplexed_model_id``. A deployment
decorates an async ``get_model(model_id)`` loader; each replica keeps an LRU
of up to ``max_num_models_per_replica`` loaded models, and the router prefers
replicas that already hold the requested model (falling back to
power-of-two-choices — the model then loads where the request lands).

Counterpart of ``ray_tpu/serve/multiplex.py``,
over the port's runtime core.
"""
from __future__ import annotations

import asyncio
import contextvars
import inspect
import weakref
from collections import OrderedDict
from typing import Any, Dict, List

_model_id_var: "contextvars.ContextVar[str]" = contextvars.ContextVar(
    "rt_serve_multiplexed_model_id", default=""
)


def get_multiplexed_model_id() -> str:
    """Inside a request: the model id the caller routed with (may be "")."""
    return _model_id_var.get()


def _set_request_model_id(model_id: str):
    _model_id_var.set(model_id or "")


class _ModelCache:
    """LRU of loaded models with per-key load dedup."""

    def __init__(self, loader, max_models: int):
        self._loader = loader
        self._max = max_models
        self._models: "OrderedDict[str, Any]" = OrderedDict()
        self._loading: Dict[str, asyncio.Future] = {}
        self._lock = asyncio.Lock()

    def ids(self) -> List[str]:
        return list(self._models.keys())

    async def get(self, model_id: str):
        async with self._lock:
            if model_id in self._models:
                self._models.move_to_end(model_id)
                return self._models[model_id]
            fut = self._loading.get(model_id)
            if fut is None:
                fut = asyncio.get_running_loop().create_future()
                self._loading[model_id] = fut
                owner = True
            else:
                owner = False
        if not owner:
            return await asyncio.shield(fut)
        try:
            model = self._loader(model_id)
            if inspect.isawaitable(model):
                model = await model
        except Exception as e:
            async with self._lock:
                self._loading.pop(model_id, None)
            fut.set_exception(e)
            raise
        async with self._lock:
            self._models[model_id] = model
            self._models.move_to_end(model_id)
            evicted = []
            while len(self._models) > self._max:
                _, old = self._models.popitem(last=False)
                evicted.append(old)
            self._loading.pop(model_id, None)
        for old in evicted:
            # best-effort unload hook (reference: __del__ on eviction)
            try:
                if hasattr(old, "__serve_multiplex_unload__"):
                    old.__serve_multiplex_unload__()
                del old
            except Exception:
                pass
        fut.set_result(model)
        return model


def multiplexed(fn=None, *, max_num_models_per_replica: int = 3):
    """Decorate an async ``get_model(self, model_id)`` loader
    (reference: ``serve.multiplexed``). The wrapper LRU-caches models
    per replica and dedups concurrent loads of the same id."""

    def wrap(f):
        # owner id(instance) -> cache (0 for free functions). Entries die
        # with their instance (weakref.finalize) so replaced replicas
        # co-hosted in the same worker process don't pin models forever.
        caches: Dict[int, _ModelCache] = {}

        async def wrapper(self_or_id, *args):
            if args:  # method: (self, model_id)
                inst, model_id = self_or_id, args[0]
                owner = id(inst)
                loader = f.__get__(inst)
            else:  # free function: (model_id,)
                inst, owner, model_id = None, 0, self_or_id
                loader = f
            cache = caches.get(owner)
            if cache is None:
                cache = caches[owner] = _ModelCache(
                    loader, max_num_models_per_replica
                )
                if inst is not None:
                    try:
                        weakref.finalize(inst, caches.pop, owner, None)
                    except TypeError:
                        pass  # non-weakrefable instance: cache rides the class
            return await cache.get(model_id)

        wrapper._is_serve_multiplexed = True
        wrapper._rt_caches = caches
        return wrapper

    if fn is not None:
        return wrap(fn)
    return wrap


def instance_model_ids(instance: Any) -> List[str]:
    """Model ids held by THIS deployment instance (the replica's report —
    never other actors co-hosted in the process)."""
    out: List[str] = []
    if getattr(instance, "_is_serve_multiplexed", False):
        cache = getattr(instance, "_rt_caches", {}).get(0)
        if cache is not None:
            out.extend(cache.ids())
        return out
    for name in dir(instance):
        if name.startswith("__"):
            continue
        try:
            attr = getattr(instance, name)
        except Exception:
            continue
        if getattr(attr, "_is_serve_multiplexed", False):
            cache = getattr(attr, "_rt_caches", {}).get(id(instance))
            if cache is not None:
                out.extend(cache.ids())
    return out
