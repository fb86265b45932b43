"""Replica actor: hosts one instance of a deployment's callable.

Reference analog: ``python/ray/serve/_private/replica.py``. Tracks ongoing
requests (the router's and autoscaler's load signal), supports async and
sync callables, ``reconfigure`` (user_config updates without restart), and
dynamic batching via :func:`batch`.

Counterpart of ``ray_tpu/serve/replica.py``,
over the port's runtime core.
"""
from __future__ import annotations

import asyncio
import inspect
import time
from typing import Any, Callable, Dict, List, Optional

from ray_tpu_torch.actor import method as _actor_method


class GangContext:
    """Rank/world view for one member of a gang replica (reference:
    ``serve/gang.py:9 GangContext``)."""

    def __init__(self, rank: int, world_size: int, replica_id: str,
                 pg_id: str):
        self.rank = rank
        self.world_size = world_size
        self.replica_id = replica_id
        self.placement_group_id = pg_id


# Gang members can share one host process (actors are threads there), so the
# context must never be a bare module global: it rides a ContextVar — set in
# the constructing thread around target construction (contextvars are
# per-thread for raw threads, and each actor has its own pool) and set again
# per request in handle_request (copied into executor threads). No lock:
# serializing constructions would deadlock PACK gangs whose constructors
# rendezvous with each other.
import contextvars as _contextvars

_gang_ctx_var: "_contextvars.ContextVar[Optional[GangContext]]" = (
    _contextvars.ContextVar("rt_gang_ctx", default=None)
)


def get_gang_context() -> Optional[GangContext]:
    """Inside a gang replica member: its GangContext (None otherwise)."""
    return _gang_ctx_var.get()


class Replica:
    """Created via ray_tpu_torch.remote with max_concurrency > 1 so requests
    overlap; ``_ongoing`` is the live load metric."""

    def __init__(self, serialized_target, init_args, init_kwargs,
                 user_config=None, gang_ctx: Optional[dict] = None):
        import cloudpickle

        self._gang_ctx = GangContext(**gang_ctx) if gang_ctx else None
        target = cloudpickle.loads(serialized_target)
        self._is_function = not inspect.isclass(target)
        if self._is_function:
            self._instance = target
        else:
            token = _gang_ctx_var.set(self._gang_ctx)
            try:
                self._instance = target(*init_args, **init_kwargs)
            finally:
                _gang_ctx_var.reset(token)
        self._ongoing = 0
        self._total = 0
        # live generator streams: stream_id -> [iter, last_access, model_id]
        self._streams: Dict[str, list] = {}
        self._stream_seq = 0
        # Graceful drain: the controller stopped routing to this replica
        # and is waiting for _ongoing + _streams to reach zero before
        # stopping it (requests already in the mailbox still run — zero
        # dropped requests on scale-down).
        self._draining = False
        if user_config is not None:
            self.reconfigure(user_config)

    @_actor_method(concurrency_group="control")
    def reconfigure(self, user_config) -> bool:
        if hasattr(self._instance, "reconfigure"):
            self._instance.reconfigure(user_config)
        return True

    @_actor_method(concurrency_group="control")
    def health_check(self) -> bool:
        if hasattr(self._instance, "check_health"):
            self._instance.check_health()
        return True

    @_actor_method(concurrency_group="control")
    def queue_len(self) -> int:
        return self._ongoing

    @_actor_method(concurrency_group="control")
    def stats(self) -> dict:
        return {"ongoing": self._ongoing, "total": self._total,
                "streams": len(self._streams),
                "draining": self._draining}

    @_actor_method(concurrency_group="control")
    def drain(self) -> dict:
        """Controller drain probe (reference: replica graceful shutdown —
        ``_private/replica.py`` perform_graceful_shutdown): marks the
        replica draining and reports live load. The control concurrency
        group keeps this answerable while request lanes are saturated."""
        self._draining = True
        return {"ongoing": self._ongoing, "streams": len(self._streams)}

    @_actor_method(concurrency_group="control")
    def prepare_for_shutdown(self) -> bool:
        """The controller's last call before it kills this replica
        (reference: Serve's graceful shutdown calls the instance's
        ``__del__``): the instance lets go of what it holds, such as an
        engine's device memory, while the replica still holds its
        resources."""
        hook = None if self._is_function else getattr(
            self._instance, "__del__", None)
        if hook is not None:
            hook()
        return True

    @_actor_method(concurrency_group="control")
    def multiplexed_ids(self) -> List[str]:
        """Model ids THIS replica's instance holds (router affinity;
        reference: replica-side model-id reporting in ``serve/multiplex.py``)."""
        from ray_tpu_torch.serve.multiplex import instance_model_ids

        return instance_model_ids(self._instance)

    # ------------------------------------------------------------ streaming

    def _register_stream(self, gen, model_id: Optional[str]) -> dict:
        self._stream_seq += 1
        sid = f"s{self._stream_seq}"
        self._streams[sid] = [gen, time.monotonic(), model_id]
        return {"__rt_stream__": sid}

    @_actor_method(concurrency_group="control")
    async def cancel_stream(self, stream_id: str) -> bool:
        """Release an abandoned stream NOW (client disconnected): pop the
        record and close the generator so its finally blocks run and the
        slot frees immediately instead of waiting for the 10-minute idle
        sweep. Idempotent — unknown/finished ids return False. Rides the
        control group: when the request lanes are saturated is exactly
        when freeing a slot matters most, so the cancel must not queue
        behind the wedge it is relieving."""
        rec = self._streams.pop(stream_id, None)
        if rec is None:
            return False
        gen = rec[0]
        # The cancel usually races an in-flight next_chunks pull (a
        # stream spends most of its wall time inside __anext__): closing
        # a RUNNING generator raises "already executing/running" and the
        # user finally blocks would never run. Retry until the current
        # pull yields the frame back (bounded; the idle sweep is the
        # backstop for a generator that never yields again).
        import logging

        log = logging.getLogger(__name__)
        deadline = time.monotonic() + 5.0
        while True:
            try:
                if inspect.isasyncgen(gen):
                    await gen.aclose()
                elif hasattr(gen, "close"):
                    # sync generator: close() runs its finally block; keep
                    # any blocking cleanup off this event loop
                    await asyncio.get_running_loop().run_in_executor(
                        None, gen.close
                    )
                return True
            except (RuntimeError, ValueError) as e:
                if "already" in str(e) and time.monotonic() < deadline:
                    await asyncio.sleep(0.05)
                    continue
                log.debug("stream %s generator close raised: %s",
                          stream_id, e)
                return True
            except Exception as e:
                log.debug("stream %s generator close raised: %s",
                          stream_id, e)
                return True

    async def next_chunks(self, stream_id: str, max_n: int = 16):
        """Pull up to max_n chunks; returns (chunks, done). Abandoned
        streams are swept after 10 minutes idle; pulling a swept (or
        unknown) stream raises instead of faking a clean end."""
        now = time.monotonic()
        for sid in [
            s for s, rec in self._streams.items() if now - rec[1] > 600
        ]:
            self._streams.pop(sid, None)
        rec = self._streams.get(stream_id)
        if rec is None:
            raise ValueError(
                f"stream {stream_id} unknown or expired (streams idle "
                f">600s are swept); chunks may have been lost"
            )
        gen, _, model_id = rec
        rec[1] = now
        # The generator body runs in THIS task (async gen) or an executor
        # thread (sync gen), not the handle_request task that created the
        # stream — restore its request context here.
        if self._gang_ctx is not None:
            _gang_ctx_var.set(self._gang_ctx)
        if model_id is not None:
            from ray_tpu_torch.serve.multiplex import _set_request_model_id

            _set_request_model_id(model_id)
        chunks: List[Any] = []
        try:
            if inspect.isasyncgen(gen):
                while len(chunks) < max_n:
                    try:
                        chunks.append(await gen.__anext__())
                    except StopAsyncIteration:
                        self._streams.pop(stream_id, None)
                        return chunks, True
            else:
                import contextvars

                loop = asyncio.get_running_loop()

                def pull():
                    out = []
                    try:
                        while len(out) < max_n:
                            out.append(next(gen))
                    except StopIteration:
                        return out, True
                    return out, False

                call_ctx = contextvars.copy_context()
                chunks, done = await loop.run_in_executor(
                    None, lambda: call_ctx.run(pull)
                )
                if done:
                    self._streams.pop(stream_id, None)
                return chunks, done
        except Exception:
            self._streams.pop(stream_id, None)
            raise
        return chunks, False

    async def handle_request(self, method: str, args, kwargs,
                             model_id: Optional[str] = None,
                             stream: bool = False):
        if self._gang_ctx is not None:
            _gang_ctx_var.set(self._gang_ctx)
        if model_id is not None:
            from ray_tpu_torch.serve.multiplex import _set_request_model_id

            _set_request_model_id(model_id)
        self._ongoing += 1
        self._total += 1
        try:
            if self._is_function:
                fn = self._instance
            else:
                fn = getattr(self._instance, method)
            if inspect.isasyncgenfunction(fn) or (
                stream and inspect.isgeneratorfunction(fn)
            ):
                return self._register_stream(fn(*args, **kwargs), model_id)
            if inspect.iscoroutinefunction(fn) or (
                hasattr(fn, "_is_serve_batch")
            ):
                out = await fn(*args, **kwargs)
                if stream and inspect.isgenerator(out):
                    return self._register_stream(out, model_id)
                return out
            # Sync callables run on an executor thread: they may block (e.g.
            # a composition handle's .result()) and must not stall this
            # replica's event loop. copy_context carries the GangContext var
            # into the thread (run_in_executor alone would not).
            import contextvars

            loop = asyncio.get_running_loop()
            call_ctx = contextvars.copy_context()
            out = await loop.run_in_executor(
                None, lambda: call_ctx.run(fn, *args, **kwargs)
            )
            if inspect.isawaitable(out):
                out = await out
            if stream and inspect.isgenerator(out):
                return self._register_stream(out, model_id)
            return out
        finally:
            self._ongoing -= 1


class _BatchQueue:
    """Accumulates calls until max_batch_size or batch_wait_timeout_s."""

    def __init__(self, fn, max_batch_size: int, timeout_s: float):
        self._fn = fn
        self._max = max_batch_size
        self._timeout = timeout_s
        self._queue: List[tuple] = []
        self._flush_task: Optional[asyncio.Task] = None

    async def submit(self, item):
        fut = asyncio.get_running_loop().create_future()
        self._queue.append((item, fut))
        if len(self._queue) >= self._max:
            await self._flush()
        elif self._flush_task is None or self._flush_task.done():
            self._flush_task = asyncio.get_running_loop().create_task(
                self._delayed_flush()
            )
        return await fut

    async def _delayed_flush(self):
        await asyncio.sleep(self._timeout)
        await self._flush()

    async def _flush(self):
        if not self._queue:
            return
        batch, self._queue = self._queue, []
        items = [b[0] for b in batch]
        try:
            outs = self._fn(items)
            if inspect.isawaitable(outs):
                outs = await outs
            if len(outs) != len(items):
                raise ValueError(
                    f"batched fn returned {len(outs)} results for "
                    f"{len(items)} inputs"
                )
            for (_, fut), out in zip(batch, outs):
                if not fut.done():
                    fut.set_result(out)
        except Exception as e:  # propagate to every waiter
            for _, fut in batch:
                if not fut.done():
                    fut.set_exception(e)


def batch(fn=None, *, max_batch_size: int = 8,
          batch_wait_timeout_s: float = 0.01):
    """``@serve.batch``: N concurrent single-item calls → one list call
    (reference: ``python/ray/serve/batching.py``). Decorate an async method
    taking a list and returning an equal-length list."""

    def wrap(f):
        queues: Dict[int, _BatchQueue] = {}

        async def wrapper(self_or_item, *args):
            # methods: (self, item); free functions: (item,)
            if args:
                owner, item = id(self_or_item), args[0]
                bound = f.__get__(self_or_item)  # bind self
            else:
                owner, item = 0, self_or_item
                bound = f
            q = queues.get(owner)
            if q is None:
                q = queues[owner] = _BatchQueue(
                    bound, max_batch_size, batch_wait_timeout_s
                )
            return await q.submit(item)

        wrapper._is_serve_batch = True
        return wrapper

    if fn is not None:
        return wrap(fn)
    return wrap
