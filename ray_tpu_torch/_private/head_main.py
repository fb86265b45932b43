"""Standalone head process entrypoint
(``python -m ray_tpu_torch._private.head_main``; the CLI's ``start --head``
is not ported yet).

Reference analog: ``gcs_server_main.cc`` + the head-node pieces of
``ray start --head`` (``scripts/scripts.py:799``): the head service, an
optional local worker node, and the dashboard, in one process tree. The
head address is published to a well-known file so drivers can
``init(address="auto")`` (reference: the bootstrap address file in the
session dir).
"""
from __future__ import annotations

import argparse
import asyncio
import json
import os
import signal
import sys
import tempfile


def address_file_path() -> str:
    d = os.path.join(tempfile.gettempdir(), "ray_tpu_torch")
    os.makedirs(d, exist_ok=True)
    return os.path.join(d, "head_address")


def read_address_file():
    try:
        with open(address_file_path()) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return None


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=0)
    parser.add_argument("--num-cpus", type=int, default=0,
                        help="CPUs for the colocated worker node (0 = none)")
    parser.add_argument("--resources", default="{}")
    parser.add_argument("--dashboard-port", type=int, default=-1,
                        help="-1 disables the dashboard; 0 picks a port")
    parser.add_argument("--no-address-file", action="store_true",
                        help="skip the global head_address file (cluster "
                             "launchers manage per-cluster info files; two "
                             "clusters must not fight over one global file)")
    parser.add_argument("--info-file", default=None,
                        help="also write the startup info JSON here "
                             "(atomic; for cluster launchers)")
    parser.add_argument("--state-file", default=None,
                        help="persist durable head state (KV, jobs) here; "
                             "restored on restart (GCS fault tolerance)")
    parser.add_argument("--state-save-interval", type=float, default=5.0)
    parser.add_argument("--log-level", default="WARNING")
    args = parser.parse_args(argv)

    import logging

    logging.basicConfig(level=getattr(logging, args.log_level.upper(), 30))

    from ray_tpu_torch._private import auth as _auth
    from ray_tpu_torch._private.config import rt_config
    from ray_tpu_torch._private.gcs import HeadService
    from ray_tpu_torch._private.ids import JobID
    from ray_tpu_torch._private.node import spawn_node

    # Cluster auth token, minted at head start (reference:
    # src/ray/rpc/authentication/): every node/driver/xfer connection must
    # present it first. Rides the env to spawned nodes and the (0600)
    # address/info files to drivers; RT_AUTH_TOKEN= (explicitly empty) is
    # the opt-out.
    _auth.ensure_cluster_token()

    loop = asyncio.new_event_loop()
    asyncio.set_event_loop(loop)
    head = HeadService()
    port = args.port
    if args.state_file:
        head.load_from_file(args.state_file)
        # Replay WAL over the snapshot: durable mutations since the last
        # snapshot write (reference: Redis-store per-mutation durability).
        try:
            n = head.replay_wal(args.state_file + ".wal")
            if n:
                logging.getLogger(__name__).info(
                    "replayed %d WAL records", n
                )
        except Exception:
            logging.getLogger(__name__).exception("WAL replay failed")
        # Rebind the previous port (unless one was given explicitly) so
        # live nodes/drivers holding the old address can rejoin — the
        # worker side retries its head connection on loss (live-cluster
        # rejoin; reference: GCS restarts behind a stable address).
        restored = getattr(head, "restored_addr", None)
        if port == 0 and restored:
            port = restored[1]
    try:
        addr = loop.run_until_complete(head.start(args.host, port))
    except OSError:
        if port == args.port:
            raise
        # Restored port taken (e.g. another service grabbed it while the
        # head was down): fall back to an ephemeral port rather than die.
        addr = loop.run_until_complete(head.start(args.host, args.port))

    if args.state_file:
        wal = head.attach_wal(args.state_file + ".wal")
        # In-flight off-loop snapshot write, visible to the shutdown path:
        # a stale write completing AFTER the final save would clobber it
        # (and the WAL is deleted by then — silent data loss).
        inflight = {"fut": None}

        def _write_state(blob):
            # one executor hop: old-generation fsync + snapshot write
            wal.sync_retired()
            head.write_snapshot(args.state_file, blob)

        async def _persist_loop():
            while True:
                await asyncio.sleep(args.state_save_interval)
                try:
                    # Rotate the WAL, then snapshot, both ON the loop (no
                    # op can fall between); write+fsync OFF it. Old WAL
                    # generations die only after the snapshot is durable.
                    old_gen = wal.rotate()
                    blob = head.snapshot()
                    inflight["fut"] = loop.run_in_executor(
                        None, _write_state, blob
                    )
                    await inflight["fut"]
                    inflight["fut"] = None
                    wal.delete_through(old_gen)
                except Exception:
                    logging.getLogger(__name__).exception(
                        "head state persistence failed; will retry"
                    )

        persist_task = loop.create_task(_persist_loop())

    dash_port = None
    dashboard = None
    if args.dashboard_port >= 0:
        raise NotImplementedError(
            "the dashboard is not ported to ray_tpu_torch yet (ROADMAP "
            "queue 1 item 12); pass --dashboard-port -1")

    node = None
    if args.num_cpus > 0:
        resources = {"CPU": float(args.num_cpus)}
        resources.update(json.loads(args.resources))
        node = spawn_node(addr, JobID.from_random(), resources, {}, None)

    info = {
        "address": f"{addr[0]}:{addr[1]}",
        "dashboard_port": dash_port,
        "head_pid": os.getpid(),
        "node_pids": [node.proc.pid] if node else [],
        "auth_token": rt_config.auth_token,
    }
    def _write_private(path: str, payload: dict):
        """0600 from CREATION (open-then-chmod leaves a window where
        another local user reads the token off the well-known path)."""
        fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o600)
        os.chmod(path, 0o600)  # a pre-existing 0644 file keeps its mode
        with os.fdopen(fd, "w") as f:
            json.dump(payload, f)

    if not args.no_address_file:
        _write_private(address_file_path(), info)
    if args.info_file:
        # atomic publish for launchers polling a private path (a cluster
        # launcher must not read another cluster's global address file)
        tmp = args.info_file + ".tmp"
        _write_private(tmp, info)
        os.replace(tmp, args.info_file)
    # Parseable by the CLI parent. REDACTED: stdout routinely lands in
    # 0644 log files (launchers redirect it); the token's distribution
    # channel is the 0600 files, never a log line.
    print(json.dumps(_auth.redacted(info)), flush=True)

    def term(*_):
        loop.stop()

    # loop.add_signal_handler, NOT signal.signal: a raw handler that calls
    # loop.stop() cannot wake a selector blocked on a long timeout — PEP
    # 475 retries the poll after the handler returns, so shutdown would
    # wait out the persist timer (observed: hung head with a 1h interval).
    # asyncio's handler rides the loop's self-pipe and wakes it instantly.
    try:
        loop.add_signal_handler(signal.SIGTERM, term)
        loop.add_signal_handler(signal.SIGINT, term)
    except (NotImplementedError, RuntimeError):  # non-main thread/platform
        signal.signal(signal.SIGTERM, term)
        signal.signal(signal.SIGINT, term)
    exit_code = 0
    try:
        loop.run_forever()
    except BaseException:  # crash must not report success to supervisors
        exit_code = 1
        raise
    finally:
        if args.state_file:
            try:
                # the persist task must not tick against a closed WAL while
                # the loop drains below
                persist_task.cancel()
                # join any in-flight executor snapshot write first: its
                # os.replace landing after the final save would roll the
                # state file back to a pre-shutdown blob
                fut = inflight.get("fut")
                if fut is not None and not fut.done():
                    try:
                        loop.run_until_complete(
                            asyncio.wait_for(asyncio.shield(fut), timeout=10)
                        )
                    except Exception:
                        pass
                head.save_to_file(args.state_file)
                from ray_tpu_torch._private.wal import delete_all

                head.wal.close()
                # clean shutdown: the snapshot covers everything
                delete_all(args.state_file + ".wal")
            except OSError:
                pass
        if node is not None:
            node.terminate()
        for coro in ([dashboard.stop()] if dashboard else []) + [head.close()]:
            try:
                loop.run_until_complete(asyncio.wait_for(coro, timeout=3))
            except Exception:
                pass
        if not args.no_address_file:
            try:
                os.remove(address_file_path())
            except OSError:
                pass
        os._exit(exit_code)  # no lingering non-daemon threads may block exit


if __name__ == "__main__":
    main()
