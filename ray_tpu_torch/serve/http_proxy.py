"""HTTP ingress proxy (reference: ``python/ray/serve/_private/proxy.py`` —
per-node ProxyActor routing HTTP to replicas via the router).

An aiohttp server inside an async actor. Routes come from the controller's
route table (longest-prefix match); request bodies pass to the ingress
deployment's ``__call__`` as a dict: ``{"body": bytes, "path": str,
"query": dict, "headers": dict, "method": str}`` — JSON responses are
serialized automatically.

Production semantics (reference: the proxy's request lifecycle):

- **Admission control**: a global in-flight cap (``rt_config.
  serve_max_inflight``) sheds excess load with 503 + ``Retry-After``
  before any routing work happens.
- **Deadlines**: per-request result deadline (``serve_request_timeout_s``)
  maps to 504 + ``Retry-After``; per-chunk stream deadline
  (``serve_stream_chunk_timeout_s``) bounds wedged streams.
- **Typed status mapping**: infra failures the client may retry
  (saturation, replica death mid-request) are 503 + ``Retry-After``;
  deadlines are 504; only APPLICATION errors are 500.
- **Streams fail loudly**: a mid-stream failure emits a terminal
  ``event: error`` SSE frame instead of silently truncating, and a client
  disconnect cancels the replica-side generator so its slot frees now.

Counterpart of ``ray_tpu/serve/http_proxy.py``,
over the port's runtime core.
"""
from __future__ import annotations

import asyncio
import json
import logging
import time
from typing import Dict, Optional

logger = logging.getLogger(__name__)

_ROUTE_TTL_S = 1.0  # controller route-table cache horizon


def _classify_error(e: BaseException) -> str:
    """'retryable' | 'deadline' | 'app' — the ONE classification both
    ingresses map from (HTTP 503/504/500, gRPC UNAVAILABLE/
    DEADLINE_EXCEEDED/INTERNAL). Retryable infra classes and deadlines
    never surface as bare application errors."""
    from ray_tpu_torch.exceptions import GetTimeoutError
    from ray_tpu_torch.serve.handle import ServeRetryableError

    if isinstance(e, ServeRetryableError):
        return "retryable"
    if isinstance(e, (GetTimeoutError, TimeoutError, asyncio.TimeoutError)):
        return "deadline"
    return "app"


def _error_status(e: BaseException):
    """(status, retry_after) for an exception escaping a handle call."""
    return {
        "retryable": (503, "1"),
        "deadline": (504, "1"),
        "app": (500, None),
    }[_classify_error(e)]


class ProxyBase:
    """Ingress-agnostic half of a serve proxy: route resolution with a
    short cache, admission counters, and stream teardown. Both the HTTP
    and gRPC proxies inherit it — the pieces live ONCE, with real `self`
    ownership of the state they touch (each proxy renders rejections in
    its own protocol)."""

    def __init__(self):
        # Admission control + observability counters (single event loop:
        # plain ints are race-free).
        self._inflight = 0
        self._shed = 0
        self._handles: Dict[str, object] = {}
        self._routes_cache = (-10.0, {})

    def stats(self) -> dict:
        """Live admission-control counters (bench/tests)."""
        return {"inflight": self._inflight, "shed": self._shed}

    def _over_cap(self) -> bool:
        """Admission check: True when the request must be shed (counts
        the shed); the caller renders the 503 / RESOURCE_EXHAUSTED."""
        from ray_tpu_torch._private.config import rt_config

        cap = int(rt_config.serve_max_inflight)
        if cap > 0 and self._inflight >= cap:
            self._shed += 1
            return True
        return False

    def _route_for(self, path: str) -> Optional[str]:
        import ray_tpu_torch
        from ray_tpu_torch._private import faultpoints
        from ray_tpu_torch.serve.controller import CONTROLLER_NAME

        if faultpoints.ACTIVE:
            faultpoints.fire("serve.proxy.route", err=ConnectionError)

        def fetch():
            routes = ray_tpu_torch.get(
                ray_tpu_torch.get_actor(CONTROLLER_NAME).get_routes.remote(),
                timeout=10,
            )
            self._routes_cache = (time.monotonic(), routes)
            return routes

        def match(routes):
            best = None
            for prefix, deployment in routes.items():
                if path.startswith(prefix) and (
                    best is None or len(prefix) > len(best[0])
                ):
                    best = (prefix, deployment)
            return None if best is None else best[1]

        fetched_at, routes = self._routes_cache
        fresh = time.monotonic() - fetched_at <= _ROUTE_TTL_S
        if not fresh:
            routes = fetch()
        found = match(routes)
        if found is None and fresh:
            # Miss on a warm cache: a route registered moments ago must
            # not 404 for the cache TTL — refetch once before giving up.
            found = match(fetch())
        return found

    def _close_stream(self, it):
        """Release the handle-side stream iterator (settles the router
        slot and cancels the replica generator); safe on non-stream
        iterators and None."""
        close = getattr(it, "close", None)
        if close is not None:
            try:
                close()
            except Exception as e:
                logger.debug("stream close raised: %s", e)


class HTTPProxy(ProxyBase):
    def __init__(self, host: str = "127.0.0.1", port: int = 8000):
        super().__init__()
        self._host = host
        self._port = port
        self._runner = None
        self._site = None

    async def start(self) -> int:
        from aiohttp import web

        app = web.Application()
        app.router.add_route("*", "/{tail:.*}", self._handle)
        self._runner = web.AppRunner(app, access_log=None)
        await self._runner.setup()
        self._site = web.TCPSite(self._runner, self._host, self._port)
        await self._site.start()
        port = self._site._server.sockets[0].getsockname()[1]
        self._port = port
        return port

    def port(self) -> int:
        return self._port

    async def _handle(self, request):
        from aiohttp import web
        from ray_tpu_torch._private.config import rt_config

        # Admission control: shed BEFORE any routing work. Saturation must
        # degrade to fast typed rejections, not queue collapse.
        if self._over_cap():
            return web.Response(
                status=503,
                text=f"proxy saturated: {self._inflight} requests in "
                     f"flight >= serve_max_inflight="
                     f"{int(rt_config.serve_max_inflight)}",
                headers={"Retry-After": "1"},
            )
        self._inflight += 1
        try:
            return await self._handle_admitted(request)
        finally:
            self._inflight -= 1

    async def _handle_admitted(self, request):
        from aiohttp import web

        loop = asyncio.get_running_loop()
        try:
            # The controller RPC blocks; keep it off the proxy event loop.
            deployment = await loop.run_in_executor(
                None, self._route_for, request.path
            )
        except Exception as e:
            # Route resolution is infra, not the app: a controller blip or
            # injected fault is a retryable 503, never a bare 500.
            return web.Response(
                status=503, text=f"route resolution failed: {e}",
                headers={"Retry-After": "1"},
            )
        if deployment is None:
            return web.Response(status=404, text="no route")
        from ray_tpu_torch.serve.handle import DeploymentHandle

        handle = self._handles.get(deployment)
        if handle is None:
            handle = self._handles[deployment] = DeploymentHandle(deployment)
        body = await request.read()
        payload = {
            "body": body,
            "path": request.path,
            "query": dict(request.query),
            "headers": dict(request.headers),
            "method": request.method,
        }
        # SSE streaming: a JSON body with "stream": true rides the serve
        # streaming protocol (replica-side generator) and is forwarded as
        # text/event-stream chunks (reference: Serve HTTP streaming
        # responses / OpenAI stream=true).
        wants_stream = False
        try:
            parsed = json.loads(body or b"{}")
            wants_stream = bool(
                isinstance(parsed, dict) and parsed.get("stream")
            )
        except json.JSONDecodeError:
            pass
        if wants_stream:
            return await self._handle_stream(
                request, handle.options(stream=True), payload, loop
            )
        from ray_tpu_torch._private.config import rt_config

        timeout = float(rt_config.serve_request_timeout_s)
        try:
            # Submission may briefly block (router pick / controller
            # refresh): keep it off the loop. The WAIT is fully async —
            # parking a blocked executor thread per in-flight request
            # starves co-located replicas (all actors in a worker process
            # share one default executor) and deadlocks under bursts.
            resp = await loop.run_in_executor(
                None, lambda: handle.remote(payload)
            )
            out = await resp.result_async(timeout)
        except Exception as e:
            status, retry_after = _error_status(e)
            headers = {"Retry-After": retry_after} if retry_after else None
            return web.Response(
                status=status, text=f"{type(e).__name__}: {e}",
                headers=headers,
            )
        if isinstance(out, (bytes, bytearray)):
            return web.Response(body=bytes(out))
        if isinstance(out, str):
            return web.Response(text=out)
        return web.json_response(out)

    async def _handle_stream(self, request, handle, payload, loop):
        from aiohttp import web
        from ray_tpu_torch._private.config import rt_config

        from ray_tpu_torch.serve.handle import _StreamIterator

        done = object()  # stream-exhausted sentinel
        # wait_for horizon sits ABOVE the handle's own per-chunk pull
        # deadline so the typed handle-side error wins over a raw timeout.
        chunk_timeout = float(rt_config.serve_stream_chunk_timeout_s) + 30

        async def _next():
            # __anext__ applies the handle-side per-chunk deadline and
            # maps replica death to the typed retryable class; the outer
            # wait_for is the backstop if the pull itself wedges.
            try:
                return await asyncio.wait_for(it.__anext__(), chunk_timeout)
            except StopAsyncIteration:
                return done

        it = None
        try:
            # Submission off-loop (may briefly block on the router); the
            # stream registration wait and every chunk pull are async —
            # an open stream costs a coroutine, not a blocked executor
            # thread (co-located replicas share the executor).
            gen = await loop.run_in_executor(
                None, lambda: handle.remote(payload)
            )
            # Registration (time-to-first-response) is bounded by the
            # REQUEST deadline like the unary path; only chunk pulls get
            # the longer streaming horizon.
            out = await gen.result_async(
                float(rt_config.serve_request_timeout_s)
            )
            if not isinstance(out, _StreamIterator):
                # The deployment chose not to stream (e.g. stream=true
                # with options the endpoint serves non-incrementally): a
                # plain response comes back shaped like the unary path,
                # not a broken SSE body.
                if isinstance(out, (bytes, bytearray)):
                    return web.Response(body=bytes(out))
                if isinstance(out, str):
                    return web.Response(text=out)
                return web.json_response(out)
            it = out
            first = await _next()
        except Exception as e:
            self._close_stream(it)
            status, retry_after = _error_status(e)
            headers = {"Retry-After": retry_after} if retry_after else None
            return web.Response(
                status=status, text=f"{type(e).__name__}: {e}",
                headers=headers,
            )
        resp = web.StreamResponse(headers={
            "Content-Type": "text/event-stream",
            "Cache-Control": "no-cache",
        })
        await resp.prepare(request)
        chunk = first
        try:
            while chunk is not done:
                if isinstance(chunk, str):
                    chunk = chunk.encode()
                elif not isinstance(chunk, (bytes, bytearray)):
                    # generic generator deployments may yield objects:
                    # frame them as JSON lines rather than dropping them
                    chunk = (json.dumps(chunk) + "\n").encode()
                await resp.write(chunk)
                chunk = await _next()
        except (ConnectionResetError, ConnectionError) as e:
            # CLIENT went away mid-stream: cancel the replica-side
            # generator so its slot frees now, not at the idle sweep.
            logger.debug("client left stream %s: %s", request.path, e)
        except Exception as e:
            # Mid-stream upstream failure: a silent truncation is
            # indistinguishable from success — emit a terminal typed
            # error event so the client KNOWS (and knows whether to
            # retry), then end the stream.
            logger.warning("stream to %s ended on error: %s: %s",
                           request.path, type(e).__name__, e)
            from ray_tpu_torch.serve.handle import ServeRetryableError

            frame = {
                "error": type(e).__name__,
                "message": str(e),
                "retryable": isinstance(
                    e, (ServeRetryableError, TimeoutError,
                        asyncio.TimeoutError)
                ),
            }
            try:
                await resp.write(
                    b"event: error\ndata: "
                    + json.dumps(frame).encode() + b"\n\n"
                )
            except Exception as we:
                logger.debug("terminal error frame not delivered: %s", we)
        finally:
            self._close_stream(it)
        try:
            await resp.write_eof()
        except Exception as e:
            logger.debug("eof after disconnect: %s", e)
        return resp

    async def stop(self) -> bool:
        if self._runner is not None:
            await self._runner.cleanup()
        return True
