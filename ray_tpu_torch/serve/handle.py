"""Deployment handles + power-of-two-choices routing.

Reference analogs: ``python/ray/serve/handle.py`` (DeploymentHandle /
DeploymentResponse), ``_private/router.py:516`` + ``request_router/
pow_2_router.py:27`` (pick 2 random replicas, route to the lower queue
length). The router tracks its *own* in-flight counts per replica (no
per-request RPC to ask replicas their length; counts refresh lazily).

Counterpart of ``ray_tpu/serve/handle.py``,
over the port's runtime core.
"""
from __future__ import annotations

import logging
import random
import threading
import time
import uuid
from typing import Any, Dict, List, Optional

logger = logging.getLogger(__name__)


class ServeRetryableError(Exception):
    """Base for infra-level request failures the CLIENT may safely retry
    (the proxies map these to 503 + ``Retry-After`` / gRPC UNAVAILABLE,
    never a bare 500). Application exceptions raised by user code are NOT
    retryable and keep their own types (reference: Serve's retryable
    ``BackPressureError``/503 vs 500 semantics)."""

    retryable = True


class ReplicaDiedError(ServeRetryableError):
    """The replica died (or became unreachable) while this request may
    already have reached user code: the handle must not replay it
    transparently — re-execution safety is the caller's call. Surfaced
    as HTTP 503 + ``Retry-After`` (a terminal ``error`` event on open
    streams) so well-behaved clients retry (reference: RayActorError ->
    retryable 503 mapping in Serve's proxy)."""


def _is_infra_failure(e: BaseException) -> bool:
    """Replica-death / transport class, as opposed to an application
    error raised by user code (TaskError) or a deadline (GetTimeoutError,
    which the proxies map to 504, not 503)."""
    from ray_tpu_torch import exceptions as exc
    from ray_tpu_torch._private import protocol

    return isinstance(
        e,
        (
            exc.ActorError,
            exc.WorkerCrashedError,
            exc.NodeDiedError,
            exc.ObjectLostError,
            protocol.RpcError,
            ConnectionError,
        ),
    )


class _StreamIterator:
    """Pulls chunks of a replica-side generator (reference: streaming
    DeploymentResponses / StreamingResponse). Iterating drives
    ``next_chunks`` pulls; the router slot settles on exhaustion."""

    def __init__(self, replica, stream_id: str, settle, router=None,
                 replica_key=None):
        self._replica = replica
        self._stream_id = stream_id
        self._settle = settle
        self._router = router
        self._key = replica_key
        self._buf: list = []
        self._done = False

    def __iter__(self):
        return self

    def _pull_failed(self, e: BaseException):
        """Terminal bookkeeping for a failed chunk pull; returns the typed
        error to raise for infra failures (mid-stream replica death must
        surface retryably — never a hang, never an anonymous transport
        exception), or None to re-raise the original."""
        self._done = True
        if _is_infra_failure(e):
            if self._router is not None and self._key is not None:
                # evict ONLY, no settle: evict pops the count, and a
                # settle enqueued lock-free could outlive it and later
                # decrement the re-added replica's fresh count (_done
                # already blocks the close()/__del__ settle path)
                self._router.evict(self._key)
            else:
                self._settle()
            return ReplicaDiedError(
                f"stream {self._stream_id} lost its replica "
                f"mid-stream: {type(e).__name__}: {e}"
            )
        self._settle()
        return None

    def _ingest(self, chunks, done: bool):
        self._buf.extend(chunks)
        if done:
            self._done = True
            self._settle()

    def __next__(self):
        import ray_tpu_torch
        from ray_tpu_torch._private import faultpoints
        from ray_tpu_torch._private.config import rt_config

        while not self._buf:
            if self._done:
                raise StopIteration
            try:
                if faultpoints.ACTIVE:
                    faultpoints.fire(
                        "serve.replica.stream", err=ConnectionError
                    )
                chunks, done = ray_tpu_torch.get(
                    self._replica.next_chunks.remote(self._stream_id),
                    timeout=float(rt_config.serve_stream_chunk_timeout_s),
                )
            except Exception as e:
                mapped = self._pull_failed(e)
                if mapped is not None:
                    raise mapped from e
                raise
            self._ingest(chunks, done)
        return self._buf.pop(0)

    def __aiter__(self):
        return self

    async def __anext__(self):
        """Event-loop chunk pull (the ingress proxies): same semantics as
        ``__next__`` without parking an executor thread per open stream —
        N streams cost N coroutines, not N blocked threads."""
        import asyncio

        from ray_tpu_torch._private import faultpoints
        from ray_tpu_torch._private.config import rt_config
        from ray_tpu_torch._private.worker import get_global_worker

        while not self._buf:
            if self._done:
                raise StopAsyncIteration
            try:
                if faultpoints.ACTIVE:
                    faultpoints.fire(
                        "serve.replica.stream", err=ConnectionError
                    )
                w = get_global_worker()
                chunks, done = await asyncio.wait_for(
                    w.as_asyncio_future(
                        self._replica.next_chunks.remote(self._stream_id)
                    ),
                    float(rt_config.serve_stream_chunk_timeout_s),
                )
            except Exception as e:
                mapped = self._pull_failed(e)
                if mapped is not None:
                    raise mapped from e
                raise
            self._ingest(chunks, done)
        return self._buf.pop(0)

    def close(self):
        """Settle the router slot for a stream abandoned mid-iteration
        AND release the replica-side generator + its slot (a client
        disconnect must not leak capacity until the idle sweep);
        idempotent, best-effort on the replica RPC."""
        if self._done:
            return
        self._done = True
        self._settle()
        try:
            # deliberate fire-and-forget: close() runs on disconnect/GC
            # paths where blocking on the ack would stall teardown
            _ = self._replica.cancel_stream.remote(self._stream_id)
        except Exception as e:
            logger.debug("stream %s cancel not delivered: %s",
                         self._stream_id, e)

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class DeploymentResponse:
    """Future-like result of ``handle.remote()`` (reference:
    ``serve/handle.py DeploymentResponse``)."""

    def __init__(self, ref, router, replica_key, replica=None):
        self._ref = ref
        self._router = router
        self._key = replica_key
        self._replica = replica
        self._done = False

    def _failed(self, e: BaseException):
        """Settle + map an infra failure; returns the typed error to
        raise, or None to re-raise the original. The replica died while
        the request was (possibly) executing: evict it so the router
        reroutes its queue immediately, and surface the typed retryable
        class — transparent replay is NOT safe once user code may have
        run (reference: Serve only retries pre-execution failures;
        mid-execution death -> retryable 503)."""
        if _is_infra_failure(e):
            # evict ONLY (it pops the count): a settle enqueued lock-free
            # could outlive the eviction and later decrement the fresh
            # count of the same replica re-added by a refresh. _done
            # blocks the __del__ settle from re-introducing that.
            self._done = True
            self._router.evict(self._key)
            return ReplicaDiedError(
                f"replica died mid-request: {type(e).__name__}: {e}"
            )
        self._settle()
        return None

    def _finish(self, out):
        if (
            isinstance(out, dict)
            and "__rt_stream__" in out
            and self._replica is not None
        ):
            # generator deployment: hand back an iterator; the router slot
            # stays held until the stream drains
            self._done = True  # settling is the iterator's job now
            router, key = self._router, self._key
            return _StreamIterator(
                self._replica, out["__rt_stream__"],
                lambda: router.request_finished(key),
                router=router, replica_key=key,
            )
        self._settle()
        return out

    def result(self, timeout: Optional[float] = None):
        import ray_tpu_torch

        try:
            out = ray_tpu_torch.get(self._ref, timeout=timeout)
        except Exception as e:
            mapped = self._failed(e)
            if mapped is not None:
                raise mapped from e
            raise
        return self._finish(out)

    async def result_async(self, timeout: Optional[float] = None):
        """Awaitable ``result()`` for event-loop callers (the ingress
        proxies): identical settle/evict/typed-error semantics, but an
        in-flight request costs a coroutine, not a blocked executor
        thread — the proxy's concurrency is bounded by admission
        control, not by a thread pool."""
        import asyncio

        from ray_tpu_torch import exceptions as exc
        from ray_tpu_torch._private.worker import get_global_worker

        w = get_global_worker()
        try:
            out = await asyncio.wait_for(
                w.as_asyncio_future(self._ref),
                timeout if timeout and timeout > 0 else None,
            )
        except asyncio.TimeoutError:
            self._settle()
            raise exc.GetTimeoutError(
                f"request did not complete within {timeout}s"
            ) from None
        except Exception as e:
            mapped = self._failed(e)
            if mapped is not None:
                raise mapped from e
            raise
        return self._finish(out)

    def __iter__(self):
        out = self.result()
        if isinstance(out, _StreamIterator):
            return out
        return iter([out])

    def _settle(self):
        if not self._done:
            self._done = True
            self._router.request_finished(self._key)

    def __del__(self):
        # A response abandoned without result() must not strand its
        # router in-flight slot forever (fire-and-forget handle calls,
        # proxy aborts): settle best-effort — request_finished is safe
        # from __del__ (lock-free enqueue).
        try:
            self._settle()
        except Exception:
            pass

    @property
    def ref(self):
        """Underlying ObjectRef (compose into other task submissions)."""
        return self._ref


class BackPressureError(ServeRetryableError):
    """The handle's queue beyond replica capacity exceeds
    max_queued_requests: the caller should shed load (the HTTP proxy maps
    this to 503) rather than queue without bound (reference: Serve's
    BackPressureError)."""


class _PushRegistry:
    """Per-process fanout of serve replica-change pushes to live routers:
    ONE pubsub handler and ONE subscribe call per channel, routers held
    weakly (they churn with handle pickling)."""

    def __init__(self):
        import weakref

        self._lock = threading.Lock()
        self._channels: Dict[str, Any] = {}  # channel -> WeakSet of routers
        self._weakset = weakref.WeakSet

    def add(self, router: "_Router"):
        from ray_tpu_torch._private.worker import get_global_worker

        channel = f"serve_replicas:{router._deployment}"
        with self._lock:
            routers = self._channels.get(channel)
            first = routers is None
            if first:
                routers = self._channels[channel] = self._weakset()
            routers.add(router)
        if not first:
            return
        w = get_global_worker()

        def _invalidate(_data, _frames, _ch=channel):
            with self._lock:
                live = list(self._channels.get(_ch, ()))
            for r in live:
                r._invalidation_gen += 1
                r._fetched_at = -10.0  # next pick() re-fetches
            return None

        w.pubsub_handlers.setdefault(channel, []).append(_invalidate)
        w.run_sync(w.gcs.call("subscribe", {"channel": channel}))


_push_registry = _PushRegistry()


def _rkey(handle) -> str:
    """Stable routing key for a replica handle. Handles are NEW objects on
    every controller fetch (actor handles re-materialize over the wire),
    so ``id(handle)`` changes per refresh — keying in-flight counts on it
    either strands counts forever or silently zeroes them each refresh,
    permanently skewing power-of-2 routing. The actor id is the replica's
    identity."""
    return handle._actor_id


class _Router:
    def __init__(self, deployment: str, refresh_s: float = 5.0):
        self._deployment = deployment
        # Globally unique: routers are recreated on every handle unpickle and
        # live in many processes; id(self) would collide across them.
        self._router_id = uuid.uuid4().hex
        self._refresh_s = refresh_s
        self._replicas: List[Any] = []
        self._inflight: Dict[str, int] = {}
        self._settled: List[str] = []  # finished keys awaiting lock-drain
        self._fetched_at = -10.0
        self._lock = threading.Lock()
        # Multiplexing: model_id -> {replica key}; only populated once a
        # model-routed request has been seen (non-multiplexed deployments
        # pay nothing).
        self._multiplex = False
        self._model_map: Dict[str, set] = {}
        # Load-shed cap from the deployment config (-1 = unbounded) and
        # per-replica execution capacity (queued = inflight - capacity).
        self._max_queued = -1
        self._max_ongoing = 16
        # Bumped by push invalidations; a refresh only stamps itself fresh
        # when no invalidation arrived while its RPC was in flight.
        self._invalidation_gen = 0
        # Push invalidation (long-poll fan-out analog): once subscribed,
        # a controller replica-change message forces the next pick() to
        # re-fetch, so the poll interval can stay long.
        self._subscribed = False
        # Autoscaling signal: refs of requests this handle has issued that
        # haven't completed yet (queued + executing), pushed to the
        # controller (reference: handle-side metrics in _private/router.py →
        # autoscaling_state.py; replica-side polls undercount because queued
        # requests sit invisible in the actor mailbox).
        self._refs: Dict[int, Any] = {}
        self._metrics_thread = None
        # Set when the controller acks "does not autoscale"; soft latch — a
        # redeploy can enable autoscaling later, so retry after a while.
        self._metrics_disabled_at: Optional[float] = None
        self._controller_handle = None

    METRICS_RETRY_S = 60.0

    def _ensure_metrics_thread(self):
        with self._lock:
            if (self._metrics_disabled_at is not None
                    and time.monotonic() - self._metrics_disabled_at
                    < self.METRICS_RETRY_S):
                return
            self._metrics_disabled_at = None
            if (self._metrics_thread is not None
                    and self._metrics_thread.is_alive()):
                return
            self._metrics_thread = threading.Thread(
                target=self._metrics_loop, daemon=True,
                name=f"serve-handle-metrics-{self._deployment}",
            )
            self._metrics_thread.start()

    def _metrics_loop(self):
        import ray_tpu_torch
        from ray_tpu_torch._private.backoff import Backoff

        failures = 0
        last_pushed = -1
        pushes = 0
        # Jittered cadence: many handles pushing on the same fixed tick
        # would synchronize their controller RPCs; idle handles decay
        # toward the cap, active ones reset to the fast tick.
        cadence = Backoff(base=0.25, cap=1.0, jitter=0.3)
        try:
            while failures < 8:
                cadence.sleep()
                try:
                    with self._lock:
                        refs = list(self._refs.items())
                    if refs:
                        cadence.reset()  # live traffic: keep the fast tick
                        ready, _ = ray_tpu_torch.wait(
                            [r for _, r in refs],
                            num_returns=len(refs), timeout=0,
                        )
                        done = {id(r) for r in ready}
                        with self._lock:
                            for k, r in refs:
                                if id(r) in done:
                                    self._refs.pop(k, None)
                    with self._lock:
                        n = len(self._refs)
                    if n != last_pushed or n > 0:
                        ref = self._controller().record_handle_metrics.remote(
                            self._deployment, self._router_id, n
                        )
                        # Periodically read the ack: -1 means the deployment
                        # doesn't autoscale, so this thread is pure overhead
                        # — stop pushing for good (the latch also stops
                        # track_request from respawning us). 0 is transient
                        # (mid-redeploy / controller restart): keep pushing.
                        if pushes % 20 == 0:
                            if ray_tpu_torch.get(ref, timeout=5) == -1:
                                with self._lock:
                                    self._metrics_disabled_at = time.monotonic()
                                return
                        pushes += 1
                        last_pushed = n
                    failures = 0
                except Exception:
                    self._controller_handle = None  # re-resolve next time
                    failures += 1
        finally:
            # A dead thread must not pin result objects; the next
            # track_request restarts tracking.
            with self._lock:
                self._refs.clear()

    def track_request(self, ref):
        with self._lock:
            self._refs[id(ref)] = ref
        self._ensure_metrics_thread()

    def _controller(self):
        import ray_tpu_torch
        from ray_tpu_torch.serve.controller import CONTROLLER_NAME

        if self._controller_handle is None:
            self._controller_handle = ray_tpu_torch.get_actor(CONTROLLER_NAME)
        return self._controller_handle

    def _subscribe_push(self):
        """Register for controller replica-change pushes on the head
        pubsub (long-poll fan-out analog). Best-effort: without it the
        periodic poll still converges. One handler + one subscribe per
        (process, channel) — routers are re-created on every handle
        unpickle, so per-router subscriptions would leak handlers and
        duplicate head-side fanout; the registry holds routers weakly."""
        if self._subscribed:
            return
        self._subscribed = True
        try:
            _push_registry.add(self)
        except Exception:
            pass

    def _refresh(self, force: bool = False):
        now = time.monotonic()
        if not force and now - self._fetched_at < self._refresh_s:
            return
        import ray_tpu_torch

        self._subscribe_push()
        try:
            gen = self._invalidation_gen
            rinfo = ray_tpu_torch.get(
                self._controller().get_router_info.remote(self._deployment),
                timeout=30,
            )
            handles = rinfo["handles"]
            self._max_queued = rinfo.get("max_queued", -1)
            self._max_ongoing = rinfo.get("max_ongoing", 16)
        except Exception:
            self._controller_handle = None  # stale after controller restart
            raise
        model_map: Dict[str, set] = {}
        if self._multiplex and handles:
            try:
                ids_per_replica = ray_tpu_torch.get(
                    [h.multiplexed_ids.remote() for h in handles], timeout=10
                )
                for h, ids in zip(handles, ids_per_replica):
                    for m in ids:
                        model_map.setdefault(m, set()).add(_rkey(h))
            except Exception:
                model_map = {}  # affinity is an optimization, not required
        with self._lock:
            self._replicas = handles
            # Keys are stable actor ids, so counts SURVIVE a refresh for
            # replicas still in the set, and counts for replicas that left
            # (died, drained, scaled down) are cleared here — a replica
            # dying mid-request must not strand its in-flight count and
            # skew power-of-2 routing forever.
            live = {_rkey(h) for h in handles}
            self._inflight = {
                k: v for k, v in self._inflight.items() if k in live
            }
            for h in handles:
                self._inflight.setdefault(_rkey(h), 0)
            self._model_map = model_map
            # A push that landed while the fetch was in flight must win:
            # keep the invalidated timestamp so the next pick re-fetches.
            if self._invalidation_gen == gen:
                self._fetched_at = now

    def pick(self, model_id: Optional[str] = None):
        """Power-of-two-choices on locally tracked in-flight counts; with a
        model_id, replicas already holding that model are preferred
        (reference: model-multiplex-aware routing)."""
        from ray_tpu_torch._private.backoff import Backoff

        if model_id and not self._multiplex:
            self._multiplex = True
            self._fetched_at = -10.0  # force a refresh with model info
        # Jittered re-resolve: a controller restart (get_actor fails, the
        # cached handle went stale) or an empty replica set mid-redeploy
        # must not hot-loop or thundering-herd the head — back off,
        # re-resolving the controller each round. Two horizons: refresh
        # FAILURES give up after 10s (this path runs on proxy executor
        # threads — parking them 30s per call under a controller outage
        # starves the executor co-located replicas share), while an empty
        # replica set gets the full 30s a rolling redeploy may need. Both
        # surface the typed retryable class: mid-redeploy emptiness and a
        # restarting controller are exactly the 503-then-retry cases.
        fail_deadline = time.monotonic() + 10
        empty_deadline = time.monotonic() + 30
        poll = Backoff(base=0.05, cap=1.0)
        force = False
        while True:
            try:
                self._refresh(force=force)
            except Exception as e:
                if time.monotonic() > fail_deadline:
                    raise ServeRetryableError(
                        f"deployment '{self._deployment}': controller "
                        f"unreachable: {type(e).__name__}: {e}"
                    ) from e
                poll.sleep()
                force = True
                continue
            if self._replicas:
                with self._lock:
                    # re-checked UNDER the lock: a concurrent evict() can
                    # empty the set between the check above and here, and
                    # sampling an empty pool would surface an untyped
                    # ValueError instead of retrying / a typed 503
                    self._drain_settled_locked()  # deferred __del__ counts
                    if self._max_queued >= 0 and self._replicas:
                        # Reference semantics: the cap counts requests
                        # QUEUED beyond what the replicas can execute
                        # concurrently, not total in-flight — shedding
                        # must not trigger while free execution slots
                        # remain.
                        total = sum(self._inflight.values())
                        capacity = (
                            len(self._replicas) * max(self._max_ongoing, 1)
                        )
                        if total - capacity >= self._max_queued:
                            raise BackPressureError(
                                f"deployment '{self._deployment}': "
                                f"{total - capacity} queued beyond replica "
                                f"capacity {capacity} >= "
                                f"max_queued_requests={self._max_queued}"
                            )
                    pool = self._replicas
                    if model_id:
                        holders = self._model_map.get(model_id, ())
                        preferred = [r for r in pool if _rkey(r) in holders]
                        if preferred:
                            pool = preferred
                    if pool:
                        if len(pool) == 1:
                            chosen = pool[0]
                        else:
                            a, b = random.sample(pool, 2)
                            chosen = (
                                a if self._inflight.get(_rkey(a), 0)
                                <= self._inflight.get(_rkey(b), 0) else b
                            )
                        key = _rkey(chosen)
                        self._inflight[key] = (
                            self._inflight.get(key, 0) + 1
                        )
                        return chosen, key
            if time.monotonic() > empty_deadline:
                raise ServeRetryableError(
                    f"no replicas for deployment '{self._deployment}'"
                )
            poll.sleep()
            force = True

    def request_finished(self, key: str):
        """Decrement a replica's in-flight count. Lock-free enqueue + best-
        effort drain: this is reachable from __del__ (abandoned stream
        iterators), where blocking on the router lock could self-deadlock a
        thread that already holds it mid-GC."""
        self._settled.append(key)  # list.append is atomic under the GIL
        if self._lock.acquire(blocking=False):
            try:
                self._drain_settled_locked()
            finally:
                self._lock.release()

    def _drain_settled_locked(self):
        while True:
            try:
                key = self._settled.pop()
            except IndexError:
                return
            if self._inflight.get(key, 0) > 0:
                self._inflight[key] -= 1

    def evict(self, key: str):
        """Drop a replica that failed a request and clear its counters —
        the dead replica's queue reroutes immediately (its queued requests
        fail over / surface typed errors on their own paths; the counts
        must not survive to skew future picks). Next pick refreshes."""
        with self._lock:
            self._replicas = [r for r in self._replicas if _rkey(r) != key]
            self._inflight.pop(key, None)
        self._fetched_at = -10.0

    def inflight_snapshot(self) -> Dict[str, int]:
        """Per-replica in-flight counts after draining pending settles
        (tests assert zero stranded counts once traffic quiesces)."""
        with self._lock:
            self._drain_settled_locked()
            return dict(self._inflight)


class _MethodCaller:
    def __init__(self, handle: "DeploymentHandle", method: str):
        self._handle = handle
        self._method = method

    def remote(self, *args, **kwargs) -> DeploymentResponse:
        return self._handle._call(self._method, args, kwargs)


class DeploymentHandle:
    def __init__(self, deployment: str, _router: Optional[_Router] = None,
                 _multiplexed_model_id: str = "", _stream: bool = False):
        self._deployment = deployment
        self._router = _router or _Router(deployment)
        self._multiplexed_model_id = _multiplexed_model_id
        self._stream = _stream

    @property
    def deployment_name(self) -> str:
        return self._deployment

    def options(self, *, multiplexed_model_id: Optional[str] = None,
                stream: Optional[bool] = None) -> "DeploymentHandle":
        """Per-call options (reference: ``handle.options(...)``):
        ``multiplexed_model_id`` routes to replicas holding that model and
        is readable in the request via ``serve.get_multiplexed_model_id()``;
        ``stream=True`` returns an iterator over a generator deployment's
        chunks. The returned handle shares this handle's router state."""
        return DeploymentHandle(
            self._deployment,
            _router=self._router,
            _multiplexed_model_id=(
                self._multiplexed_model_id
                if multiplexed_model_id is None else multiplexed_model_id
            ),
            _stream=self._stream if stream is None else stream,
        )

    def _call(self, method: str, args, kwargs) -> DeploymentResponse:
        from ray_tpu_torch._private import faultpoints
        from ray_tpu_torch._private.backoff import Backoff
        from ray_tpu_torch._private.config import rt_config

        model_id = self._multiplexed_model_id
        # Transparent failover is safe ONLY here: a submission that fails
        # in this frame never reached user code, so replaying it on
        # another replica cannot double-execute anything. Bounded and
        # jittered; once the budget is gone the failure surfaces as the
        # typed retryable class (reference: Serve router retrying
        # pre-execution ActorUnavailable).
        attempts = max(int(rt_config.serve_failover_attempts), 0)
        retry = Backoff(base=0.05, cap=0.5)
        attempt = 0
        while True:
            replica, key = self._router.pick(model_id or None)
            try:
                if faultpoints.ACTIVE:
                    faultpoints.fire(
                        "serve.replica.call", err=ConnectionError
                    )
                if model_id or self._stream:
                    ref = replica.handle_request.remote(
                        method, args, kwargs,
                        model_id=model_id or None, stream=self._stream,
                    )
                else:
                    ref = replica.handle_request.remote(method, args, kwargs)
            except Exception as e:
                # evict alone pops the in-flight count; an extra settle
                # here could outlive the eviction in the lock-free queue
                # and later decrement a re-added replica's fresh count
                self._router.evict(key)
                if not _is_infra_failure(e):
                    raise
                if attempt >= attempts:
                    raise ReplicaDiedError(
                        f"deployment '{self._deployment}': submission "
                        f"failed on {attempt + 1} replica(s): "
                        f"{type(e).__name__}: {e}"
                    ) from e
                attempt += 1
                retry.sleep()
                continue
            self._router.track_request(ref)
            return DeploymentResponse(ref, self._router, key, replica=replica)

    def remote(self, *args, **kwargs) -> DeploymentResponse:
        return self._call("__call__", args, kwargs)

    def __getattr__(self, item) -> _MethodCaller:
        if item.startswith("_"):
            raise AttributeError(item)
        return _MethodCaller(self, item)

    def __reduce__(self):
        return (
            DeploymentHandle,
            (self._deployment, None, self._multiplexed_model_id,
             self._stream),
        )
