"""Synchronous head-service client for out-of-band tools.

Used by the CLI, JobSubmissionClient, and the state API when there is no
initialized worker in the process (reference analog: the dashboard/state
tools talking straight to GCS RPC without a full ray.init()).
"""
from __future__ import annotations

import asyncio
import threading
from typing import Optional, Tuple

from ray_tpu_torch._private import protocol


class SyncHeadClient:
    def __init__(self, address: str):
        host, _, port = address.rpartition(":")
        self.addr: Tuple[str, int] = (host or "127.0.0.1", int(port))
        self._loop = asyncio.new_event_loop()
        self._conn: Optional[protocol.Connection] = None
        ready = threading.Event()
        self._thread = threading.Thread(
            target=self._run, args=(ready,), daemon=True,
            name="rt-sync-client",
        )
        self._thread.start()
        ready.wait(timeout=10)
        if self._conn is None:
            raise ConnectionError(f"cannot reach head at {address}")

    def _run(self, ready):
        asyncio.set_event_loop(self._loop)

        async def connect():
            try:
                self._conn = await protocol.connect(
                    self.addr, self._noop_handler, name="sync-client"
                )
            finally:
                ready.set()

        self._loop.run_until_complete(connect())
        if self._conn is not None:
            self._loop.run_forever()

    async def _noop_handler(self, method, header, frames, conn):
        return {}, []

    def call(self, method: str, header: dict, timeout: float = 30.0,
             frames: list = ()):
        fut = asyncio.run_coroutine_threadsafe(
            self._conn.call(method, header, frames), self._loop
        )
        return fut.result(timeout)

    def close(self):
        if self._conn is not None:
            asyncio.run_coroutine_threadsafe(
                self._conn.close(), self._loop
            ).result(timeout=5)
        self._loop.call_soon_threadsafe(self._loop.stop)
