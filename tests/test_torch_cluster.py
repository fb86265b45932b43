"""One program on both runtimes: ``ray_tpu`` and its port ``ray_tpu_torch``.

The program (``_program``) runs tasks with ref arguments, a 20-long task
chain, 200 parallel tasks, ``wait`` with ``num_returns`` and a timeout, an
actor's call order, a named actor through ``get_actor``, a task that raises
and ``kill``. Each runtime runs it on a cluster of its own (2 nodes of 2
CPUs), one after the other, never at once; the JAX side runs under
``RT_DEVICE_OBJECTS=0``, its byte-identical host path, and with its
pushers on the main loop (``_REFERENCE_ENV``). Both give equal results and
the same exception class names.

The port's cluster then carries a 4 MB CPU tensor through ``put``, a task and
``get``, and its node processes report what they loaded: no ``jax``,
``jaxlib``, ``ray_tpu`` or torch at spawn, and ``CUDA_VISIBLE_DEVICES=""``
(no node has a ``GPU`` resource here). After ``shutdown()`` no node process
is left.

The remote functions and actors are defined inside ``_program``, so
cloudpickle ships them by value: a node never imports this module (and so
never imports jax through it). Under pytest-xdist the whole session is
computed once, by the first worker that needs it
(``test_torch_ranks.shared_results``).
"""
import contextlib
import os
import time

import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu_torch
from tests.test_torch_ranks import shared_results


def _program(rt):
    """The shared program; ``rt`` is ``ray_tpu`` or ``ray_tpu_torch``."""
    out = {}

    @rt.remote
    def add(a, b):
        return a + b

    @rt.remote
    def square(x):
        return x * x

    @rt.remote
    def sleep_then(s, v):
        time.sleep(s)
        return v

    @rt.remote
    def boom(msg):
        raise ValueError(msg)

    @rt.remote
    class Log:
        def __init__(self, start):
            self.items = [start]

        def append(self, x):
            self.items.append(x)
            return len(self.items)

        def items_(self):
            return list(self.items)

    def error_name(ref):
        try:
            rt.get(ref, timeout=60)
        except Exception as e:   # the class name is what is compared
            return type(e).__name__, "ValueError" in str(e)
        return None

    # tasks with ref arguments: a put ref and a task's return ref
    out["ref_args"] = rt.get(add.remote(rt.put(40), add.remote(1, 1)))
    # a 20-long chain, each task on the previous one's return
    ref = add.remote(0, 1)
    for _ in range(19):
        ref = add.remote(ref, 1)
    out["chain"] = rt.get(ref)
    out["parallel"] = rt.get([square.remote(i) for i in range(200)])
    # wait: the 2 finished ones of 3, then a timeout that expires on the
    # slow one (which finished tasks a wait returns when more than
    # num_returns are ready depends on timing, so they finish first)
    quick = [sleep_then.remote(0, i) for i in range(2)]
    rt.get(quick)
    slow = sleep_then.remote(3.0, "late")
    ready, rest = rt.wait(quick + [slow], num_returns=2, timeout=30)
    out["wait_quick"] = (len(ready), len(rest), sorted(rt.get(ready)))
    ready, rest = rt.wait([slow], num_returns=1, timeout=0.1)
    out["wait_timeout"] = (len(ready), len(rest))
    # an actor's call order, and a named actor's shared state
    log = Log.options(name="log").remote(-1)
    lens = [log.append.remote(i) for i in range(30)]
    out["actor_order"] = (rt.get(lens), rt.get(log.items_.remote()))
    same = rt.get_actor("log")
    rt.get(same.append.remote("via-name"))
    out["named_actor"] = rt.get(log.items_.remote())[-1]
    out["task_raises"] = error_name(boom.remote("bad input"))
    rt.kill(log)
    deadline = time.monotonic() + 30
    out["after_kill"] = error_name(log.append.remote(0))
    while out["after_kill"] is None and time.monotonic() < deadline:
        out["after_kill"] = error_name(log.append.remote(0))
    out["slow_done"] = rt.get(slow)
    return out


def _port_extras(rt):
    """The port only: node processes' imports and card visibility, then a
    4 MB CPU tensor through put, a task and get."""
    from ray_tpu_torch.util.scheduling_strategies import (
        NodeAffinitySchedulingStrategy,
    )

    @rt.remote
    def loaded():
        import sys

        roots = {m.split(".")[0] for m in sys.modules}
        return (sorted(roots & {"jax", "jaxlib", "ray_tpu", "torch"}),
                os.environ.get("CUDA_VISIBLE_DEVICES"))

    @rt.remote
    def double(t):
        return t * 2, float(t.sum())

    nodes = [n["node_id"] for n in rt.nodes() if n["alive"]]
    out = {"nodes": rt.get([loaded.options(
        scheduling_strategy=NodeAffinitySchedulingStrategy(n)).remote()
        for n in nodes])}
    x = torch.from_numpy(
        np.random.default_rng(0).standard_normal(1 << 20).astype(np.float32))
    got, total = rt.get(double.remote(rt.put(x)))
    out["tensor"] = (got.numpy(), total, x.numpy())
    out["pids"] = [n.proc.pid for n in rt._internal_cluster().nodes]
    return out


# Both clusters' arenas are capped at 128 MiB (the default is 4 GiB, and an
# arena keeps up to 512 MiB of /dev/shm faulted in ahead of its use): the
# program stores a few MB, and the tier-1 run shares the host's memory.
_SMALL_ARENA = {"RT_ARENA_BYTES": str(128 << 20)}

# The JAX side's settings: its host path for device arrays, and pushers on
# the driver's main loop. With sharded pushers (the default on a host of 3
# or more cores) ray_tpu holds a pushed chunk's replies until the whole
# chunk has replied, so a task whose argument is a chunk-mate's return
# waits forever at the owner (``ref_args`` and ``chain`` below). The port
# settles what arrived before it waits (``CoreWorker._flush_settles``) and
# runs in its default mode.
_REFERENCE_ENV = {"RT_DEVICE_OBJECTS": "0", "RT_PUSHER_LOOP_SHARDS": "0"}


@contextlib.contextmanager
def _env(overrides):
    saved = {k: os.environ.get(k) for k in overrides}
    os.environ.update(overrides)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _session():
    out = {}
    with _env({**_SMALL_ARENA, **_REFERENCE_ENV}):
        try:
            ray_tpu.init(num_cpus=2, num_nodes=2)
            out["ray_tpu"] = _program(ray_tpu)
        finally:
            ray_tpu.shutdown()
    with _env(_SMALL_ARENA):
        try:
            ray_tpu_torch.init(num_cpus=2, num_nodes=2)
            out["port_extras"] = _port_extras(ray_tpu_torch)
            out["ray_tpu_torch"] = _program(ray_tpu_torch)
        finally:
            ray_tpu_torch.shutdown()
    time.sleep(0.5)
    out["alive_after"] = [p for p in out["port_extras"].pop("pids")
                          if _alive(p)]
    return out


def _alive(pid):
    try:
        with open(f"/proc/{pid}/status") as f:
            return "zombie" not in f.read()
    except OSError:
        return False


@pytest.fixture(scope="module")
def session(tmp_path_factory):
    return shared_results(tmp_path_factory, "torch_cluster", _session)


_KEYS = ["ref_args", "chain", "parallel", "wait_quick", "wait_timeout",
         "actor_order", "named_actor", "task_raises", "after_kill",
         "slow_done"]


@pytest.mark.parametrize("key", _KEYS)
def test_program_equal(session, key):
    """Each part of the program gives the same result, or the same
    exception class, on both runtimes."""
    assert session["ray_tpu_torch"][key] == session["ray_tpu"][key]


def test_program_values(session):
    """The shared results are the program's own (not just equal)."""
    r = session["ray_tpu_torch"]
    assert r["ref_args"] == 42 and r["chain"] == 20
    assert r["parallel"] == [i * i for i in range(200)]
    assert r["wait_quick"] == (2, 1, [0, 1])
    assert r["wait_timeout"] == (0, 1) and r["slow_done"] == "late"
    assert r["actor_order"] == (list(range(2, 32)), [-1, *range(30)])
    assert r["named_actor"] == "via-name"
    assert r["task_raises"] == ("TaskError", True)
    assert r["after_kill"] is not None and r["after_kill"][0].startswith(
        "Actor")


def test_tensor_through_a_task(session):
    """A 4 MB f32 CPU tensor crosses put, a task and get."""
    got, total, x = session["port_extras"]["tensor"]
    assert got.dtype == np.float32 and got.shape == (1 << 20,)
    assert np.array_equal(got, x * 2)
    assert total == pytest.approx(float(x.astype(np.float64).sum()), rel=1e-4)


def test_node_processes(session):
    """Every node process has loaded no jax, jaxlib, ray_tpu or torch at
    spawn and sees no card; none is left after shutdown()."""
    nodes = session["port_extras"]["nodes"]
    assert len(nodes) == 2
    assert all(n == ([], "") for n in nodes), nodes
    assert session["alive_after"] == []


_PULL_SCRIPT = """
import gc, os
import numpy as np
import ray_tpu_torch as rt
from ray_tpu_torch._private.worker import get_global_worker

def mapped(name):
    with open("/proc/self/maps") as f:
        return [l.split()[-2] if l.rstrip().endswith("(deleted)")
                else l.split()[-1] for l in f if name in l]

@rt.remote
def pull(meta, hex_):
    # what a node on another host does: fetch the object's bytes from the
    # owner's transfer server into a segment of its own
    import os
    from multiprocessing import shared_memory
    from ray_tpu_torch.native import xfer
    dest = f"rtpull_{os.getpid()}_{hex_[:12]}"
    got = xfer.fetch_to_segment(meta["xfer"][0], meta["xfer"][1], meta,
                                hex_, dest, 30.0)
    if got is not None:
        shared_memory.SharedMemory(name=dest).unlink()
    return None if got is None else got["size"]

rt.init(num_cpus=1, num_nodes=1)
name = f"rt_arena_{rt._internal_cluster().gcs_addr[1]}_{os.getuid()}"
ref = rt.put(np.arange(1 << 20, dtype=np.float32))
kind, meta = get_global_worker().memory_store[ref.hex()]
out = {"meta": sorted(meta),
       "in_arena": meta.get("arena", "").lstrip("/") == name}
out["pulled"] = rt.get(pull.remote(meta, ref.hex()), timeout=60)
out["before"] = len(mapped(name))
del ref
rt.shutdown()
gc.collect()
out["after"] = mapped(name)
print(out)
"""


def test_transfer_server_unmaps_arena_at_shutdown():
    """A node pulls an arena object from the driver's transfer server, as
    a node on another host would; after the driver's shutdown() its process
    maps no part of the session's arena (the server's attachment is
    detached with its last listener). In a subprocess: the mappings are the
    process's own."""
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo, RT_ARENA_BYTES=str(64 << 20))
    proc = subprocess.run([sys.executable, "-c", _PULL_SCRIPT], cwd=repo,
                          env=env, capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = eval(proc.stdout.strip().splitlines()[-1])
    assert out["in_arena"] and "xfer" in out["meta"], out
    assert out["pulled"] and out["pulled"] > 4 << 20, out
    assert out["before"] >= 2, out    # the store's mapping and the server's
    assert out["after"] == [], out
