"""gRPC ingress proxy (reference: ``python/ray/serve/_private/proxy.py:11``
— the reference ProxyActor serves HTTP *and* gRPC; this is the gRPC half).

Runs a ``grpc.aio`` server inside an async actor, sharing the SAME routing
machinery as the HTTP proxy (controller route table + DeploymentHandle's
power-of-two-choices router). The service is registered with *generic*
method handlers — no protoc codegen — and speaks msgpack payloads:

    service rayserve.v1.RayServe {
      rpc Predict(bytes) returns (bytes);            // unary
      rpc PredictStream(bytes) returns (stream bytes);  // generator apps
    }

Request payload (msgpack map):
    {"route": "/app", "method": "__call__"?, "data": <any>,
     "multiplexed_model_id": str?}
Response payload (msgpack): the deployment's return value. Errors map to
gRPC status codes (NOT_FOUND for unknown routes, INTERNAL for user errors),
matching the reference proxy's status semantics.

The ``serve-multiplexed-model-id`` request metadata key is honored like the
reference's gRPC proxy, taking precedence over the payload field.

Counterpart of ``ray_tpu/serve/grpc_proxy.py``,
over the port's runtime core.
"""
from __future__ import annotations

import asyncio
from typing import Dict, Optional

import msgpack

from ray_tpu_torch.serve.http_proxy import ProxyBase

SERVICE = "rayserve.v1.RayServe"


def _pack(obj) -> bytes:
    return msgpack.packb(obj, use_bin_type=True, default=str)


def _unpack(data: bytes):
    return msgpack.unpackb(data, raw=False)


class GRPCProxy(ProxyBase):
    """Async actor hosting the gRPC ingress (reference: ProxyActor's gRPC
    server sharing the Router with the HTTP side). Route resolution,
    admission counters, and stream teardown come from ProxyBase — shared
    with the HTTP proxy; only the protocol rendering differs."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        super().__init__()
        self._host = host
        self._port = port
        self._server = None

    async def start(self) -> int:
        import grpc

        proxy = self

        class _Handler(grpc.GenericRpcHandler):
            def service(self, handler_call_details):
                name = handler_call_details.method
                if name == f"/{SERVICE}/Predict":
                    return grpc.unary_unary_rpc_method_handler(
                        proxy._predict,
                        request_deserializer=None,
                        response_serializer=None,
                    )
                if name == f"/{SERVICE}/PredictStream":
                    return grpc.unary_stream_rpc_method_handler(
                        proxy._predict_stream,
                        request_deserializer=None,
                        response_serializer=None,
                    )
                return None

        self._server = grpc.aio.server()
        self._server.add_generic_rpc_handlers((_Handler(),))
        self._port = self._server.add_insecure_port(
            f"{self._host}:{self._port}"
        )
        await self._server.start()
        return self._port

    def port(self) -> int:
        return self._port

    # ------------------------------------------------------------- routing

    async def _handle_for(self, req: dict, context):
        """Resolve the deployment handle + per-request options, or abort."""
        import grpc

        route = req.get("route") or "/"
        try:
            # The controller RPC blocks; it must not stall the grpc.aio loop.
            deployment = await asyncio.get_running_loop().run_in_executor(
                None, self._route_for, route
            )
        except Exception as e:
            # Route resolution is infra: retryable UNAVAILABLE, not INTERNAL.
            context.set_code(grpc.StatusCode.UNAVAILABLE)
            context.set_details(f"route resolution failed: {e}")
            return None, None
        if deployment is None:
            context.set_code(grpc.StatusCode.NOT_FOUND)
            context.set_details(f"no route for {route!r}")
            return None, None
        from ray_tpu_torch.serve.handle import DeploymentHandle

        handle = self._handles.get(deployment)
        if handle is None:
            handle = self._handles[deployment] = DeploymentHandle(deployment)
        model_id = req.get("multiplexed_model_id") or ""
        for key, value in context.invocation_metadata() or ():
            if key == "serve-multiplexed-model-id" and value:
                model_id = value
        if model_id:
            handle = handle.options(multiplexed_model_id=model_id)
        return handle, req.get("method") or "__call__"

    def _admit(self, context) -> bool:
        """Global in-flight admission check (ProxyBase._over_cap); sheds
        with RESOURCE_EXHAUSTED — the gRPC analog of 503 + Retry-After."""
        import grpc

        from ray_tpu_torch._private.config import rt_config

        if self._over_cap():
            context.set_code(grpc.StatusCode.RESOURCE_EXHAUSTED)
            context.set_details(
                f"proxy saturated: {self._inflight} >= "
                f"serve_max_inflight={int(rt_config.serve_max_inflight)}"
            )
            return False
        return True

    @staticmethod
    def _status_for(e: BaseException):
        """Retryable infra -> UNAVAILABLE, deadline -> DEADLINE_EXCEEDED,
        application error -> INTERNAL: the gRPC rendering of the shared
        classification (one mapping to maintain, both ingresses agree)."""
        import grpc

        from ray_tpu_torch.serve.http_proxy import _classify_error

        return {
            "retryable": grpc.StatusCode.UNAVAILABLE,
            "deadline": grpc.StatusCode.DEADLINE_EXCEEDED,
            "app": grpc.StatusCode.INTERNAL,
        }[_classify_error(e)]

    async def _predict(self, request: bytes, context) -> bytes:
        import grpc

        from ray_tpu_torch._private.config import rt_config

        try:
            req = _unpack(request)
        except Exception as e:
            context.set_code(grpc.StatusCode.INVALID_ARGUMENT)
            context.set_details(f"bad msgpack request: {e}")
            return b""
        if not self._admit(context):
            return b""
        self._inflight += 1
        try:
            handle, method = await self._handle_for(req, context)
            if handle is None:
                return b""
            loop = asyncio.get_running_loop()
            try:
                caller = (
                    handle if method == "__call__"
                    else getattr(handle, method)
                )
                # Submission off-loop (router pick may briefly block);
                # the WAIT is fully async — a blocked executor thread per
                # in-flight request starves co-located replicas (shared
                # per-process default executor) and deadlocks under
                # bursts.
                resp = await loop.run_in_executor(
                    None, lambda: caller.remote(req.get("data"))
                )
                out = await resp.result_async(
                    float(rt_config.serve_request_timeout_s)
                )
            except Exception as e:
                context.set_code(self._status_for(e))
                context.set_details(f"{type(e).__name__}: {e}")
                return b""
            return _pack(out)
        finally:
            self._inflight -= 1

    async def _predict_stream(self, request: bytes, context):
        import grpc

        from ray_tpu_torch._private.config import rt_config

        try:
            req = _unpack(request)
        except Exception as e:
            context.set_code(grpc.StatusCode.INVALID_ARGUMENT)
            context.set_details(f"bad msgpack request: {e}")
            return
        if not self._admit(context):
            return
        self._inflight += 1
        it = None
        try:
            handle, method = await self._handle_for(req, context)
            if handle is None:
                return
            handle = handle.options(stream=True)
            loop = asyncio.get_running_loop()
            try:
                from ray_tpu_torch.serve.handle import _StreamIterator

                caller = (
                    handle if method == "__call__"
                    else getattr(handle, method)
                )
                # Submission off-loop; registration wait and chunk pulls
                # are async (see _predict: blocked executor threads
                # deadlock co-located replicas).
                gen = await loop.run_in_executor(
                    None, lambda: caller.remote(req.get("data"))
                )
                # Registration is bounded by the request deadline (unary
                # parity); chunk pulls get the streaming horizon.
                out = await gen.result_async(
                    float(rt_config.serve_request_timeout_s)
                )
                if isinstance(out, _StreamIterator):
                    it = out
                    async for chunk in it:
                        yield _pack(chunk)
                else:
                    # non-streaming result under stream=true: a single
                    # well-formed message, not an error
                    yield _pack(out)
            except Exception as e:
                # Typed terminal status, never a hang: UNAVAILABLE tells
                # the client a retry may succeed (replica died mid-stream).
                context.set_code(self._status_for(e))
                context.set_details(f"{type(e).__name__}: {e}")
        finally:
            # ProxyBase: settles the router slot + cancels the
            # replica-side generator
            self._close_stream(it)
            self._inflight -= 1

    async def stop(self) -> bool:
        if self._server is not None:
            await self._server.stop(grace=1.0)
            self._server = None
        return True
