"""ActorPool: fan work over a fixed set of actors.

Reference analog: ``python/ray/util/actor_pool.py`` — ``map``/
``map_unordered``/``submit``/``get_next``/``get_next_unordered``.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Iterable, Iterator, List, Optional


class ActorPool:
    def __init__(self, actors: List[Any]):
        if not actors:
            raise ValueError("ActorPool requires at least one actor")
        self._idle = list(actors)
        # ref id -> (ref, actor, submit index)
        self._in_flight: dict = {}
        self._next_submit = 0
        self._next_return = 0
        self._buffered: dict = {}
        # indices taken out of order (get_next_unordered): the ordered
        # cursor must skip them or it waits forever on a consumed index
        self._consumed: set = set()

    def _advance_cursor(self, idx: int):
        self._consumed.add(idx)
        while self._next_return in self._consumed:
            self._consumed.discard(self._next_return)
            self._next_return += 1

    def submit(self, fn: Callable[[Any, Any], Any], value: Any):
        """fn(actor, value) -> ObjectRef; blocks if no actor is idle."""
        if not self._idle:
            self._wait_one()
        actor = self._idle.pop(0)
        ref = fn(actor, value)
        self._in_flight[ref.id().hex()] = (ref, actor, self._next_submit)
        self._next_submit += 1

    def has_next(self) -> bool:
        return bool(self._in_flight) or bool(self._buffered)

    def has_free(self) -> bool:
        return bool(self._idle)

    def _wait_one(self, timeout: Optional[float] = None):
        import ray_tpu_torch

        refs = [rec[0] for rec in self._in_flight.values()]
        ready, _ = ray_tpu_torch.wait(refs, num_returns=1, timeout=timeout)
        if not ready:
            raise TimeoutError("no actor result ready in time")
        self._settle(ready[0])

    def _settle(self, ref):
        import ray_tpu_torch

        rec = self._in_flight.pop(ref.id().hex())
        _, actor, idx = rec
        self._idle.append(actor)
        self._buffered[idx] = ref

    def get_next(self, timeout: Optional[float] = None) -> Any:
        """Next result in SUBMISSION order."""
        import ray_tpu_torch

        if not self.has_next():
            raise StopIteration("no pending results")
        deadline = (
            time.monotonic() + timeout if timeout is not None else None
        )
        while self._next_return not in self._buffered:
            remaining = None
            if deadline is not None:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError("no actor result ready in time")
            self._wait_one(remaining)
        idx = self._next_return
        ref = self._buffered.pop(idx)
        self._advance_cursor(idx)
        return ray_tpu_torch.get(ref)

    def get_next_unordered(self, timeout: Optional[float] = None) -> Any:
        """Next COMPLETED result, any order."""
        import ray_tpu_torch

        if not self.has_next():
            raise StopIteration("no pending results")
        if not self._buffered:
            self._wait_one(timeout)
        idx = min(self._buffered)
        ref = self._buffered.pop(idx)
        self._advance_cursor(idx)
        return ray_tpu_torch.get(ref)

    def map(self, fn: Callable[[Any, Any], Any],
            values: Iterable[Any]) -> Iterator[Any]:
        for v in values:
            self.submit(fn, v)
        while self.has_next():
            yield self.get_next()

    def map_unordered(self, fn: Callable[[Any, Any], Any],
                      values: Iterable[Any]) -> Iterator[Any]:
        for v in values:
            self.submit(fn, v)
        while self.has_next():
            yield self.get_next_unordered()
