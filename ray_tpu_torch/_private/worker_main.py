"""Worker (node) process entrypoint.

Process-per-host model: one of these processes is one "node" — on a GPU
host it owns the cards its ``GPU`` resource grants, and its tasks and actors
run as threads that share one CUDA context; in tests many of them simulate a
cluster on one machine (reference analog: raylet + worker combined;
spawned like ``services.py start_raylet``).
"""
from __future__ import annotations

import argparse
import asyncio
import json
import logging
import math
import os
import signal
import sys


def _scope_cards(resources) -> None:
    """Scope this node's CUDA visibility before anything can import torch.

    A node without a ``GPU`` resource hides every card
    (``CUDA_VISIBLE_DEVICES=""``): only the nodes given cards may open a
    CUDA context on them. A node with ``GPU: n`` sees the first ceil(n) of
    the ids its accelerator manager finds (the driver's own visibility when
    it set one). Torch is not imported here: user code that needs it pays
    its import, a node that runs none never does.
    """
    from ray_tpu_torch._private.accelerators import GPUAcceleratorManager

    n = math.ceil(float(resources.get("GPU", 0) or 0))
    if n <= 0:
        os.environ["CUDA_VISIBLE_DEVICES"] = ""
        return
    ids = GPUAcceleratorManager.get_current_node_accelerator_ids()[:n]
    GPUAcceleratorManager.set_visible_accelerators(ids, os.environ)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--gcs-host", required=True)
    parser.add_argument("--gcs-port", type=int, required=True)
    parser.add_argument("--resources", default="{}")
    parser.add_argument("--labels", default="{}")
    parser.add_argument("--job-id", required=True)
    parser.add_argument("--node-id", default="")
    parser.add_argument("--log-level", default="WARNING")
    # Warm worker pool member: registers with the head but stays out of
    # the scheduler until activated (gcs._activate_standby).
    parser.add_argument("--standby", action="store_true")
    args = parser.parse_args(argv)

    logging.basicConfig(
        level=getattr(logging, args.log_level.upper(), logging.WARNING),
        format=f"[rt-worker {os.getpid()}] %(levelname)s %(name)s: %(message)s",
    )

    # SIGUSR1 → dump all thread stacks to stderr (debugging stuck workers;
    # reference analog: py-spy hooks in dashboard/modules/reporter).
    import faulthandler
    faulthandler.register(signal.SIGUSR1, all_threads=True)

    resources = json.loads(args.resources)
    # Log plane: point fds 1/2 at session-dir files BEFORE anything prints
    # (reference behavior: workers write redirected log files that a
    # monitor tails — _private/log_monitor.py). Skipped when no session
    # dir rides the env (standalone/manual runs keep inherited stdio).
    log_paths = []
    session_dir = os.environ.get("RT_SESSION_DIR")
    if session_dir:
        from ray_tpu_torch._private import log_monitor

        try:
            out_p, err_p = log_monitor.redirect_stdio(
                session_dir, args.node_id or str(os.getpid())
            )
            log_paths = [("stdout", out_p), ("stderr", err_p)]
        except OSError:
            pass  # unwritable session dir: keep inherited stdio
    _scope_cards(resources)

    from ray_tpu_torch._private import worker as worker_mod
    from ray_tpu_torch._private.ids import JobID
    from ray_tpu_torch._private.worker import CoreWorker

    core = CoreWorker(
        is_driver=False,
        gcs_addr=(args.gcs_host, args.gcs_port),
        job_id=JobID.from_hex(args.job_id),
        node_resources=resources,
        node_labels=json.loads(args.labels),
        standby=args.standby,
    )
    if args.node_id:
        core.node_id = args.node_id
    worker_mod.global_worker = core

    loop = asyncio.new_event_loop()
    asyncio.set_event_loop(loop)
    core.loop = loop
    loop.run_until_complete(core._async_setup())
    core._install_ref_hooks()
    if log_paths:
        from ray_tpu_torch._private import log_monitor

        monitor = log_monitor.LogMonitor(core, log_paths)
        monitor.start()

    def handle_term(*_):
        loop.stop()

    signal.signal(signal.SIGTERM, handle_term)
    # RT_PROFILE_DIR: dump a cProfile of this process's event-loop thread on
    # exit (perf investigation tool; reference analog: py-spy in the
    # reporter agent).
    profile_dir = os.environ.get("RT_PROFILE_DIR")
    prof = None
    if profile_dir:
        import cProfile

        prof = cProfile.Profile()
        prof.enable()
    try:
        loop.run_forever()
    finally:
        # A node stops here, on SIGTERM, without the driver's teardown: drop
        # the /dev/shm names of the rings it created to reach its peers
        # (the mappings go with the process; the names would stay).
        for rc in list(core._ring_peers.values()):
            if rc is not False:
                try:
                    rc.ring.unlink_name()
                except Exception:
                    pass
        if prof is not None:
            prof.disable()
            try:
                os.makedirs(profile_dir, exist_ok=True)
                prof.dump_stats(
                    os.path.join(profile_dir, f"worker-{os.getpid()}.pstats")
                )
            except Exception:
                pass
        sys.exit(0)


if __name__ == "__main__":
    main()
