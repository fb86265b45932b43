"""Distributed queue backed by an actor.

Reference analog: ``python/ray/util/queue.py`` — ``Queue`` with
put/get/put_nowait/get_nowait/qsize/empty/full semantics, usable from any
task or actor (the handle pickles).
"""
from __future__ import annotations

import asyncio
import time
from typing import Any, List, Optional


class Empty(Exception):
    pass


class Full(Exception):
    pass


class _QueueActor:
    """Async actor hosting the buffer; awaiting consumers don't block the
    actor (max_concurrency lets puts interleave with blocked gets)."""

    def __init__(self, maxsize: int):
        self._q: "asyncio.Queue" = asyncio.Queue(maxsize)

    async def put(self, item, timeout: Optional[float] = None) -> bool:
        try:
            if timeout is None:
                await self._q.put(item)
            else:
                await asyncio.wait_for(self._q.put(item), timeout)
            return True
        except asyncio.TimeoutError:
            return False

    async def get(self, timeout: Optional[float] = None):
        try:
            if timeout is None:
                return True, await self._q.get()
            return True, await asyncio.wait_for(self._q.get(), timeout)
        except asyncio.TimeoutError:
            return False, None

    async def put_nowait(self, item) -> bool:
        try:
            self._q.put_nowait(item)
            return True
        except asyncio.QueueFull:
            return False

    async def get_nowait(self):
        try:
            return True, self._q.get_nowait()
        except asyncio.QueueEmpty:
            return False, None

    async def qsize(self) -> int:
        return self._q.qsize()

    async def maxsize(self) -> int:
        return self._q.maxsize


class Queue:
    def __init__(self, maxsize: int = 0, *, actor_options: Optional[dict] = None):
        import ray_tpu_torch

        opts = dict(actor_options or {})
        opts.setdefault("max_concurrency", 64)
        # The queue actor is pure coordination; it must not hold a CPU slot
        # (on a 1-CPU cluster the default would starve the producer task).
        opts.setdefault("num_cpus", 0)
        self._actor = ray_tpu_torch.remote(_QueueActor).options(**opts).remote(
            maxsize
        )
        self.maxsize = maxsize

    def put(self, item, block: bool = True, timeout: Optional[float] = None):
        import ray_tpu_torch

        if not block:
            return self.put_nowait(item)
        ok = ray_tpu_torch.get(
            self._actor.put.remote(item, timeout),
            timeout=(timeout + 30) if timeout else None,
        )
        if not ok:
            raise Full("queue put timed out")

    def put_nowait(self, item):
        import ray_tpu_torch

        if not ray_tpu_torch.get(self._actor.put_nowait.remote(item), timeout=30):
            raise Full("queue is full")

    def get(self, block: bool = True, timeout: Optional[float] = None) -> Any:
        import ray_tpu_torch

        if not block:
            return self.get_nowait()
        ok, item = ray_tpu_torch.get(
            self._actor.get.remote(timeout),
            timeout=(timeout + 30) if timeout else None,
        )
        if not ok:
            raise Empty("queue get timed out")
        return item

    def get_nowait(self) -> Any:
        import ray_tpu_torch

        ok, item = ray_tpu_torch.get(self._actor.get_nowait.remote(), timeout=30)
        if not ok:
            raise Empty("queue is empty")
        return item

    def qsize(self) -> int:
        import ray_tpu_torch

        return ray_tpu_torch.get(self._actor.qsize.remote(), timeout=30)

    def empty(self) -> bool:
        return self.qsize() == 0

    def full(self) -> bool:
        return self.maxsize > 0 and self.qsize() >= self.maxsize

    def shutdown(self):
        import ray_tpu_torch

        try:
            ray_tpu_torch.kill(self._actor)
        except Exception:
            pass

    def __reduce__(self):
        return (_rebuild_queue, (self._actor, self.maxsize))


def _rebuild_queue(actor, maxsize):
    q = object.__new__(Queue)
    q._actor = actor
    q.maxsize = maxsize
    return q
