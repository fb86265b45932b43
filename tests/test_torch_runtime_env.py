"""Runtime environments, the state API, ActorPool, Queue and the OTel bridge
on both runtimes: ``ray_tpu`` and its port ``ray_tpu_torch``.

One program (``_program``) runs the reference's cases on each runtime: those
of ``tests/test_runtime_env.py`` (pip venvs from a hand-rolled wheel, the
venv cached, ``py_modules``, ``env_vars``, a print in the venv child, per-call
``env_vars``, an unpicklable result, ``conda`` and ``image_uri`` validated
and gated, the worker-process setup hook once per process, its failure, its
module path, after ``env_vars``, in the venv child), the ``working_dir`` and
unknown-plugin cases of ``tests/test_aux.py``, the state listings and task
summary of ``tests/test_cluster_ops.py`` with ``memory_summary``, and
``util.actor_pool``/``util.queue``. Each runtime runs it on a cluster of its
own (1 node of 2 CPUs, 128 MiB arenas), one after the other; each part gives
the same result, or the same exception class, on both.

On the port's cluster a pip-venv task (in the executor child) and a
``py_modules`` task then run the tiny GPT-2 in f32 on the CPU, on weights
converted from the JAX init; their logits are held to the JAX package's
``gpt2.forward`` on the same tokens within 2e-5 + 2e-5|x|, the reference's
f32 forward bound.

Under pytest-xdist the session is computed once
(``test_torch_ranks.shared_results``). The remote functions, actors and
hooks are defined inside ``_program`` so that cloudpickle ships them by
value and no node imports this module (and JAX through it). The clusters
run with ``RT_LOG_TO_DRIVER=0`` and every subprocess here captures its
output, so nothing of theirs reaches the terminal; ``PIP_NO_INDEX=1`` keeps
pip to the local wheels. Each runtime's venvs and staged packages go under
the session's temporary directory (``RT_RUNTIME_ENV_DIR``).
"""
import dataclasses
import fcntl
import importlib
import os
import subprocess
import sys
import time
import zipfile

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import ray_tpu
import ray_tpu_torch
from ray_tpu.models import gpt2 as jgpt2
from tests.test_torch_cluster import (
    _REFERENCE_ENV,
    _SMALL_ARENA,
    _alive,
    _env,
)
from tests.test_torch_ranks import shared_results

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_QUIET = {"RT_LOG_TO_DRIVER": "0", "PIP_NO_INDEX": "1"}
# a venv build (python -m venv, then pip from a local wheel) and its first
# task; later calls reuse the venv's child
_BUILD_S = 120
_CALL_S = 60

# The helper that the GPT-2 tasks run: shipped as a py_modules package and
# installed from a wheel into a venv.
_HELPER = '''
MAGIC = "wheel-born"


def forward(np_params, tokens):
    """The tiny GPT-2's f32 logits on the CPU, from the JAX init's tree."""
    import dataclasses

    import torch

    from ray_tpu_torch.models import convert, gpt2

    cfg = dataclasses.replace(gpt2.GPT2_TINY, dtype=torch.float32,
                              attention_impl="xla")
    params = convert.params_from_numpy(np_params, cfg, device="cpu")
    with torch.no_grad():
        logits, _ = gpt2.forward(params, torch.from_numpy(tokens).long(), cfg)
    return logits.numpy()
'''


def _make_wheel(tmp_path, name="rt_envtest_pkg", version="0.1",
                body="MAGIC = 'wheel-born'\n"):
    """Hand-rolled wheel (a zip + dist-info), as the reference's
    tests/test_runtime_env.py builds it: fully offline."""
    whl = os.path.join(tmp_path, f"{name}-{version}-py3-none-any.whl")
    dist = f"{name}-{version}.dist-info"
    with zipfile.ZipFile(whl, "w") as z:
        z.writestr(f"{name}/__init__.py", body)
        z.writestr(
            f"{dist}/METADATA",
            f"Metadata-Version: 2.1\nName: {name}\nVersion: {version}\n",
        )
        z.writestr(
            f"{dist}/WHEEL",
            "Wheel-Version: 1.0\nGenerator: test\nRoot-Is-Purelib: true\n"
            "Tag: py3-none-any\n",
        )
        z.writestr(f"{dist}/RECORD", "")
    return whl


def _files(tmp):
    """The program's inputs on disk under ``tmp``: a wheel, a package to
    ship, a module holding a setup hook, and a working directory."""
    os.makedirs(tmp, exist_ok=True)
    mod = os.path.join(tmp, "shipped_mod")
    os.makedirs(mod, exist_ok=True)
    with open(os.path.join(mod, "__init__.py"), "w") as f:
        f.write("VALUE = 41\n")
    with open(os.path.join(mod, "extra.py"), "w") as f:
        f.write("def f():\n    return 1\n")
    hook = os.path.join(tmp, "rt_hookmod.py")
    with open(hook, "w") as f:
        f.write("def counter():\n    import os\n\n"
                "    os.environ['RT_TEST_HOOK_MOD'] = str(\n"
                "        int(os.environ.get('RT_TEST_HOOK_MOD', '0')) + 1)\n")
    wd = os.path.join(tmp, "wd_runtime_env")
    os.makedirs(wd, exist_ok=True)
    with open(os.path.join(wd, "marker.txt"), "w") as f:
        f.write("found me")
    return {"wheel": _make_wheel(tmp), "module": mod, "hook": hook,
            "working_dir": wd}


def _program(rt, files):
    """The shared program; ``rt`` is ``ray_tpu`` or ``ray_tpu_torch``."""
    renv_mod = importlib.import_module(rt.__name__ + "._private.runtime_env")
    conda = importlib.import_module(rt.__name__ + "._private.runtime_env.conda")
    state = importlib.import_module(rt.__name__ + ".util.state")
    pool_mod = importlib.import_module(rt.__name__ + ".util.actor_pool")
    queue_mod = importlib.import_module(rt.__name__ + ".util.queue")
    wheel = files["wheel"]
    out = {}

    def part(key, fn):
        try:
            out[key] = fn()
        except Exception as e:
            out[key] = ("raised", type(e).__name__)

    def raised(fn, match=None):
        """The exception class name a call raises, and whether its message
        holds ``match``."""
        try:
            fn()
        except Exception as e:
            return type(e).__name__, match is None or match in str(e)
        return None

    # test_runtime_env.py:43, a task runs with a package the driver lacks
    @rt.remote(runtime_env={"pip": [wheel]})
    def probe():
        import rt_envtest_pkg

        return rt_envtest_pkg.MAGIC

    def pip_absent():
        r = subprocess.run([sys.executable, "-c", "import rt_envtest_pkg"],
                           capture_output=True, timeout=60)
        return r.returncode != 0, rt.get(probe.remote(), timeout=_BUILD_S)

    part("pip_absent_package", pip_absent)

    # :62, the same spec reuses the cached venv
    @rt.remote(runtime_env={"pip": [wheel]})
    def pyexe():
        import sys as s

        return s.executable

    def venv_cached():
        first = rt.get(pyexe.remote(), timeout=_BUILD_S)
        second = rt.get(pyexe.remote(), timeout=_CALL_S)
        return first == second, first != sys.executable

    part("venv_cached", venv_cached)

    # :77, py_modules ships a local package
    @rt.remote(runtime_env={"py_modules": [files["module"]]})
    def use():
        import shipped_mod
        from shipped_mod.extra import f

        return shipped_mod.VALUE + f()

    part("py_modules", lambda: rt.get(use.remote(), timeout=_CALL_S))

    # :93, conda without its binary fails loudly
    @rt.remote(runtime_env={"conda": ["something"]})
    def nope():
        return 1

    part("conda_fails_loudly",
         lambda: raised(lambda: rt.get(nope.remote(), timeout=_CALL_S)))

    # :102, env_vars
    @rt.remote(runtime_env={"env_vars": {"RT_TEST_FLAG": "on"}})
    def read():
        return os.environ.get("RT_TEST_FLAG")

    part("env_vars", lambda: rt.get(read.remote(), timeout=_CALL_S))

    # :110, a print in the venv child leaves the result pipe clean
    @rt.remote(runtime_env={"pip": [wheel]})
    def chatty():
        print("this goes to stderr, not the protocol pipe")
        import rt_envtest_pkg

        return rt_envtest_pkg.MAGIC

    part("pip_print", lambda: rt.get(chatty.remote(), timeout=_BUILD_S))

    # :125, a cached executor does not keep the first task's env_vars
    def read_flag():
        return os.environ.get("RT_PIP_FLAG")

    def per_call():
        a = rt.remote(runtime_env={"pip": [wheel],
                                   "env_vars": {"RT_PIP_FLAG": "A"}})(read_flag)
        b = rt.remote(runtime_env={"pip": [wheel],
                                   "env_vars": {"RT_PIP_FLAG": "B"}})(read_flag)
        return (rt.get(a.remote(), timeout=_BUILD_S),
                rt.get(b.remote(), timeout=_CALL_S))

    part("pip_env_vars_per_call", per_call)

    # :142, an unpicklable result is a task error
    @rt.remote(runtime_env={"pip": [wheel]})
    def bad():
        import threading

        return threading.Lock()

    part("pip_unpicklable", lambda: raised(
        lambda: rt.get(bad.remote(), timeout=_BUILD_S), "serializable"))

    # :155, conda and image_uri validate, and fail without their binaries
    def gated():
        renv_mod.validate({"conda": ["scipy"]})
        renv_mod.validate({"image_uri": "python:3.12-slim"})
        bogus = raised(lambda: renv_mod.validate({"bogus_plugin": 1}),
                       "not supported")

        @rt.remote(runtime_env={"conda": ["scipy"]})
        def in_conda():
            return 1

        @rt.remote(runtime_env={"image_uri": "python:3.12-slim"})
        def in_container():
            return 1

        return (bogus,
                raised(lambda: rt.get(in_conda.remote(), timeout=_CALL_S),
                       "conda"),
                raised(lambda: rt.get(in_container.remote(),
                                      timeout=_CALL_S), "podman or docker"))

    part("conda_image_uri_gated", gated)

    # :189, the conda env key
    part("conda_env_key", lambda: (
        conda.conda_env_key(["a", "b"]) == conda.conda_env_key(["a", "b"]),
        conda.conda_env_key(["a"]) != conda.conda_env_key(["b"]),
        conda.conda_env_key({"dependencies": ["x"]})[:6]))

    # :205, a pickled setup hook runs once per worker process
    def hook_counter():
        import os

        os.environ["RT_TEST_HOOK_RAN"] = str(
            int(os.environ.get("RT_TEST_HOOK_RAN", "0")) + 1)

    @rt.remote
    def hook_probe():
        import os

        return os.environ.get("RT_TEST_HOOK_RAN")

    def hook_once():
        renv = {"worker_process_setup_hook": hook_counter}
        return (rt.get(hook_probe.options(runtime_env=renv).remote(),
                       timeout=_CALL_S),
                rt.get(hook_probe.options(runtime_env=renv).remote(),
                       timeout=_CALL_S))

    part("setup_hook_once", hook_once)

    # :222, a failing hook fails the task
    def boom():
        raise RuntimeError("hook exploded")

    @rt.remote
    def one():
        return 1

    part("setup_hook_failure", lambda: raised(lambda: rt.get(one.options(
        runtime_env={"worker_process_setup_hook": boom}).remote(),
        timeout=_CALL_S), "hook exploded"))

    # :236, a hook named by its module path (here a module that py_modules
    # ships: a node must not import this test module)
    @rt.remote
    def hook_mod_probe():
        import os

        return os.environ.get("RT_TEST_HOOK_MOD", "0")

    part("setup_hook_module_path", lambda: int(rt.get(hook_mod_probe.options(
        runtime_env={"py_modules": [files["hook"]],
                     "worker_process_setup_hook": "rt_hookmod.counter"}
    ).remote(), timeout=_CALL_S)) >= 1)

    # :250, the hook sees the env it was shipped with
    def env_hook():
        import os

        assert os.environ.get("HOOK_NEEDS_THIS") == "yes"
        os.environ["HOOK_SAW_ENV"] = "1"

    @rt.remote
    def env_probe():
        import os

        return os.environ.get("HOOK_SAW_ENV")

    part("setup_hook_after_env_vars", lambda: rt.get(env_probe.options(
        runtime_env={"env_vars": {"HOOK_NEEDS_THIS": "yes"},
                     "worker_process_setup_hook": env_hook}).remote(),
        timeout=_CALL_S))

    # :273, a pip task's hook runs in the venv child that runs the task
    def child_hook():
        import os

        os.environ["CHILD_HOOK"] = f"pid-{os.getpid()}"

    @rt.remote
    def child_probe():
        import os

        return os.environ.get("CHILD_HOOK"), os.getpid()

    def hook_in_child():
        marker, pid = rt.get(child_probe.options(runtime_env={
            "pip": [], "worker_process_setup_hook": child_hook}).remote(),
            timeout=_BUILD_S)
        return marker == f"pid-{pid}"

    part("setup_hook_in_venv_child", hook_in_child)

    # tests/test_aux.py:156, working_dir
    @rt.remote(runtime_env={"working_dir": files["working_dir"]})
    def read_marker():
        import os

        with open("marker.txt") as f:
            return os.path.basename(os.getcwd()), f.read()

    part("working_dir", lambda: rt.get(read_marker.remote(), timeout=_CALL_S))

    # tests/test_aux.py:175, an unknown plugin fails loudly
    @rt.remote(runtime_env={"container": {"image": "x"}})
    def unknown():
        return "should not run"

    part("unknown_plugin", lambda: raised(
        lambda: rt.get(unknown.remote(), timeout=_CALL_S)))

    # tests/test_cluster_ops.py:30, the state listings, and memory_summary
    @rt.remote
    def double(x):
        return x * 2

    @rt.remote(num_cpus=0)
    class Pinger:
        def ping(self):
            return "pong"

    def listings():
        a = Pinger.remote()
        got = (rt.get(a.ping.remote(), timeout=_CALL_S),
               rt.get([double.remote(i) for i in range(4)], timeout=_CALL_S))
        nodes = state.list_nodes()
        actors = state.list_actors()
        alive_only = state.list_actors(filters=[("state", "=", "ALIVE")])
        status = state.cluster_status()
        ref = rt.put(np.arange(1 << 16, dtype=np.float64))
        summary = state.memory_summary()
        listed = any(r["oid"] == ref.hex() for r in summary["rows"])
        rt.kill(a)
        return (got, len(nodes) >= 1 and all("resources" in n for n in nodes),
                any(x["state"] == "ALIVE" for x in actors),
                all(x["state"] == "ALIVE" for x in alive_only),
                status["nodes_alive"] >= 1,
                status["resources_total"].get("CPU", 0) >= 2,
                listed, summary["totals"]["objects"] >= 1,
                len(state.list_placement_groups()), type(state.list_jobs()))

    part("state_listings", listings)

    # tests/test_cluster_ops.py:55, the task summary (events flush
    # asynchronously: poll)
    @rt.remote
    def tracked():
        return 1

    def task_summary():
        rt.get([tracked.remote() for _ in range(3)], timeout=_CALL_S)
        deadline = time.monotonic() + 20
        while True:
            summary = state.summarize_tasks()
            done = summary["cluster"]["summary"].get(
                "tracked", {}).get("state_counts", {}).get("FINISHED", 0)
            if done >= 3 or time.monotonic() > deadline:
                break
            time.sleep(0.2)
        names = {t.get("name") for t in state.list_tasks()}
        return summary["cluster"]["total_tasks"] >= 1, done, "tracked" in names

    part("task_summary", task_summary)

    # util.actor_pool
    @rt.remote(num_cpus=0)
    class Doubler:
        def f(self, x):
            time.sleep(0.01 * (x % 3))
            return 2 * x

    def pool():
        actors = [Doubler.remote() for _ in range(2)]
        try:
            p = pool_mod.ActorPool(actors)
            ordered = list(p.map(lambda a, v: a.f.remote(v), range(6)))
            unordered = sorted(p.map_unordered(lambda a, v: a.f.remote(v),
                                               range(6)))
            p.submit(lambda a, v: a.f.remote(v), 10)
            p.submit(lambda a, v: a.f.remote(v), 11)
            nxt = (p.has_free(), p.get_next(timeout=_CALL_S),
                   p.get_next(timeout=_CALL_S), p.has_next())
            empty = raised(lambda: p.get_next())
        finally:
            for a in actors:
                rt.kill(a)
        return (ordered, unordered, nxt, empty,
                raised(lambda: pool_mod.ActorPool([])))

    part("actor_pool", pool)

    # util.queue
    @rt.remote
    def produce(q, n):
        for i in range(n):
            q.put(i, timeout=_CALL_S)
        return n

    def queue():
        q = queue_mod.Queue(maxsize=2)
        try:
            q.put(1, timeout=_CALL_S)
            q.put(2, timeout=_CALL_S)
            first = (q.qsize(), q.full(), q.empty(),
                     raised(lambda: q.put_nowait(3)),
                     raised(lambda: q.put(3, timeout=0.2)))
            got = (q.get(timeout=_CALL_S), q.get_nowait())
            empty = (raised(lambda: q.get_nowait()),
                     raised(lambda: q.get(timeout=0.2)), q.empty())
            done = produce.remote(q, 6)
            streamed = [q.get(timeout=_CALL_S) for _ in range(6)]
            return first, got, empty, streamed, rt.get(done, timeout=_CALL_S)
        finally:
            q.shutdown()

    part("queue", queue)
    return out


def _gpt2(rt, files, np_params, tokens):
    """The port's tiny GPT-2 from a pip-venv task (the helper installed
    from a wheel, run in the executor child) and from a py_modules task
    (the helper shipped as a package, run in the node process)."""
    helper = os.path.join(files["tmp"], "rt_gpt2_helper")
    os.makedirs(helper, exist_ok=True)
    with open(os.path.join(helper, "__init__.py"), "w") as f:
        f.write(_HELPER)
    wheel = _make_wheel(files["tmp"], name="rt_gpt2_wheel", body=_HELPER)
    params = rt.put(np_params)

    @rt.remote(runtime_env={"pip": [wheel]})
    def in_venv(params, tokens):
        import os
        import sys

        import rt_gpt2_wheel

        return rt_gpt2_wheel.forward(params, tokens), sys.executable, \
            os.getpid()

    @rt.remote(runtime_env={"py_modules": [helper]})
    def in_node(params, tokens):
        import os

        import rt_gpt2_helper

        return rt_gpt2_helper.forward(params, tokens), os.getpid()

    venv_logits, exe, child_pid = rt.get(in_venv.remote(params, tokens),
                                         timeout=_BUILD_S)
    node_logits, node_pid = rt.get(in_node.remote(params, tokens),
                                   timeout=_CALL_S)
    return {"venv": venv_logits, "py_modules": node_logits,
            "in_child": exe != sys.executable and child_pid != node_pid}


def _children_of(root):
    """Processes whose command line names a path under ``root`` (the venv
    executors of one runtime's env directory)."""
    found = []
    for pid in os.listdir("/proc"):
        if not pid.isdigit():
            continue
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                if root.encode() in f.read() and _alive(int(pid)):
                    found.append(int(pid))
        except OSError:
            pass
    return found


def _locks_held(root):
    """The venv build locks under ``root`` that some process holds."""
    held = []
    venvs = os.path.join(root, "venvs")
    for name in sorted(os.listdir(venvs)) if os.path.isdir(venvs) else ():
        if name.endswith(".lock"):
            with open(os.path.join(venvs, name), "w") as f:
                try:
                    fcntl.flock(f, fcntl.LOCK_EX | fcntl.LOCK_NB)
                    fcntl.flock(f, fcntl.LOCK_UN)
                except OSError:
                    held.append(name)
    return held


def _jax_gpt2():
    """The tiny GPT-2's JAX init (as numpy) and tokens from
    RandomState(14), and JAX's f32 logits on them."""
    jcfg = dataclasses.replace(jgpt2.GPT2_TINY, dtype=jnp.float32,
                               attention_impl="xla", remat=False)
    tree = jax.tree.map(np.asarray,
                        jgpt2.init_params(jcfg, jax.random.PRNGKey(0)))
    tokens = np.random.RandomState(14).randint(
        0, jcfg.vocab_size, (2, 48)).astype(np.int32)
    logits, _ = jgpt2.forward(tree, jnp.asarray(tokens), jcfg)
    return tree, tokens, np.asarray(logits)


def _session(basetemp):
    out = {}
    np_params, tokens, out["jax_logits"] = _jax_gpt2()
    for rt, extra in ((ray_tpu, _REFERENCE_ENV), (ray_tpu_torch, {})):
        tmp = os.path.join(basetemp, f"runtime_env_{rt.__name__}")
        files = dict(_files(tmp), tmp=tmp)
        root = os.path.join(tmp, "renv")
        with _env({**_SMALL_ARENA, **_QUIET, **extra,
                   "RT_RUNTIME_ENV_DIR": root}):
            pids = []
            try:
                rt.init(num_cpus=2, num_nodes=1)
                cluster = rt._internal_cluster()
                pids = [n.proc.pid for n in (*cluster.nodes, *cluster.warm)]
                out[rt.__name__] = _program(rt, files)
                if rt is ray_tpu_torch:
                    out["gpt2"] = _gpt2(rt, files, np_params, tokens)
                out["children_" + rt.__name__] = bool(_children_of(root))
            finally:
                rt.shutdown()
        deadline = time.monotonic() + 15
        while time.monotonic() < deadline and (
                any(_alive(p) for p in pids) or _children_of(root)):
            time.sleep(0.1)
        out["left_" + rt.__name__] = ([p for p in pids if _alive(p)],
                                      _children_of(root), _locks_held(root))
    return out


@pytest.fixture(scope="module")
def session(tmp_path_factory):
    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent            # shared by the session's workers
    return shared_results(tmp_path_factory, "torch_runtime_env",
                          lambda: _session(str(root)))


@pytest.mark.parametrize("key", [
    "pip_absent_package", "venv_cached", "py_modules", "conda_fails_loudly",
    "env_vars", "pip_print", "pip_env_vars_per_call", "pip_unpicklable",
    "conda_image_uri_gated", "conda_env_key", "setup_hook_once",
    "setup_hook_failure", "setup_hook_module_path",
    "setup_hook_after_env_vars", "setup_hook_in_venv_child", "working_dir",
    "unknown_plugin", "state_listings", "task_summary", "actor_pool",
    "queue"])
def test_program_equal(session, key):
    """Each part of the program gives the same result, or the same
    exception class, on both runtimes."""
    assert session["ray_tpu_torch"][key] == session["ray_tpu"][key]


def test_program_values(session):
    """The shared results are the reference tests' own (not just equal)."""
    r = session["ray_tpu_torch"]
    assert r["pip_absent_package"] == (True, "wheel-born")
    assert r["venv_cached"] == (True, True)
    assert r["py_modules"] == 42
    assert r["conda_fails_loudly"][0] in ("TaskError", "RayTpuError")
    assert r["env_vars"] == "on"
    assert r["pip_print"] == "wheel-born"
    assert r["pip_env_vars_per_call"] == ("A", "B")
    assert r["pip_unpicklable"][1] is True
    bogus, in_conda, in_container = r["conda_image_uri_gated"]
    assert bogus[1] and in_conda[1] and in_container[1]
    assert r["conda_env_key"] == (True, True, "conda-")
    assert r["setup_hook_once"] == ("1", "1")
    assert r["setup_hook_failure"][1] is True
    assert r["setup_hook_module_path"] is True
    assert r["setup_hook_after_env_vars"] == "1"
    assert r["setup_hook_in_venv_child"] is True
    assert r["working_dir"] == ("wd_runtime_env", "found me")
    assert r["unknown_plugin"][0] == "RayTpuError"
    listing = r["state_listings"]
    assert listing[0] == ("pong", [0, 2, 4, 6]) and all(listing[1:8])
    assert r["task_summary"] == (True, 3, True)
    assert r["actor_pool"] == (
        [0, 2, 4, 6, 8, 10], [0, 2, 4, 6, 8, 10], (False, 20, 22, False),
        ("StopIteration", True), ("ValueError", True))
    first, got, empty, streamed, produced = r["queue"]
    assert first == (2, True, False, ("Full", True), ("Full", True))
    assert got == (1, 2) and empty == (("Empty", True), ("Empty", True), True)
    assert streamed == list(range(6)) and produced == 6


@pytest.mark.parametrize("where", ["venv", "py_modules"])
def test_gpt2_in_runtime_env_matches_jax(session, where):
    """The tiny GPT-2 (f32, CPU) from a pip-venv task, run in the executor
    child, and from a py_modules task: logits within 2e-5 + 2e-5|x| of
    JAX's gpt2.forward on the same weights and tokens."""
    np.testing.assert_allclose(session["gpt2"][where], session["jax_logits"],
                               atol=2e-5, rtol=2e-5)
    assert session["gpt2"]["in_child"]


@pytest.mark.parametrize("rt", ["ray_tpu", "ray_tpu_torch"])
def test_nothing_left_after_shutdown(session, rt):
    """The venv executors ran while the cluster was up; after shutdown() no
    node process, no executor child and no venv build lock is left."""
    assert session["children_" + rt]
    assert session["left_" + rt] == ([], [], [])


def test_otel_bridge_matches_reference():
    """The OTel bridge over each package's metric registry: with the
    OpenTelemetry SDK, an in-memory reader collects the same points from
    both (as tests/test_events_otel.py:117 does for the reference);
    without it, both raise the same ImportError naming the dependency."""
    from ray_tpu.util import metrics_otel as jotel
    from ray_tpu_torch.util import metrics_otel as totel

    try:
        from opentelemetry.sdk.metrics import MeterProvider
        from opentelemetry.sdk.metrics.export import InMemoryMetricReader
    except ImportError:
        errs = []
        for mod in (jotel, totel):
            with pytest.raises(ImportError) as e:
                mod.OtelMetricsBridge()
            errs.append(str(e.value))
        assert errs[0] == errs[1] and "opentelemetry-sdk" in errs[0]
        return
    from ray_tpu.util import metrics as jmetrics
    from ray_tpu_torch.util import metrics as tmetrics

    points = []
    for metrics, mod in ((jmetrics, jotel), (tmetrics, totel)):
        metrics.Counter("otel_parity_total", "demo").inc(3.0, tags={"k": "v"})
        metrics.Gauge("otel_parity_gauge").set(7.5)
        bridge = mod.OtelMetricsBridge.__new__(mod.OtelMetricsBridge)
        reader = InMemoryMetricReader()
        bridge._provider = MeterProvider(metric_readers=[reader])
        bridge._meter = bridge._provider.get_meter("test")
        bridge._registered = set()
        bridge.refresh_instruments()
        data = reader.get_metrics_data()
        points.append(sorted(
            (m.name, dict(p.attributes), p.value)
            for rm in data.resource_metrics for sm in rm.scope_metrics
            for m in sm.metrics if m.name.startswith("otel_parity")
            for p in m.data.data_points))
        bridge._provider.shutdown()
    assert points[0] == points[1] and points[0]


def test_otel_callbacks_match_reference():
    """The observable-instrument callbacks against the OTel API alone
    (tests/test_events_otel.py:91), on both packages' registries."""
    pytest.importorskip("opentelemetry.metrics")
    from ray_tpu.util import metrics as jmetrics
    from ray_tpu.util.metrics_otel import OtelMetricsBridge as JBridge
    from ray_tpu_torch.util import metrics as tmetrics
    from ray_tpu_torch.util.metrics_otel import OtelMetricsBridge as TBridge

    got = []
    for metrics, cls in ((jmetrics, JBridge), (tmetrics, TBridge)):
        metrics.Counter("otel_cb_parity_total", "demo").inc(
            3.0, tags={"k": "v"})
        h = metrics.Histogram("otel_cb_parity_hist", boundaries=[1.0, 10.0])
        h.observe(0.5)
        h.observe(5.0)
        bridge = cls.__new__(cls)
        vals = bridge._value_callback("otel_cb_parity_total")(None)
        buckets = {o.attributes["le"]: o.value for o in
                   bridge._hist_callback("otel_cb_parity_hist", "bucket")(None)}
        got.append(([(dict(o.attributes), o.value) for o in vals], buckets))
    assert got[0] == got[1]
    assert got[1][0] == [({"k": "v"}, 3.0)] and got[1][1]["+Inf"] == 2


_IMPORT_PROBE = """
import os, sys, threading
import ray_tpu_torch._private.runtime_env.executor
import ray_tpu_torch._private.runtime_env.venv
import ray_tpu_torch._private.runtime_env.conda
import ray_tpu_torch._private.runtime_env.packaging
import ray_tpu_torch._private.sync_client
import ray_tpu_torch.util.state
import ray_tpu_torch.util.actor_pool
import ray_tpu_torch.util.queue
import ray_tpu_torch.util.metrics_otel
kids = []
for tid in os.listdir(f"/proc/{os.getpid()}/task"):
    with open(f"/proc/{os.getpid()}/task/{tid}/children") as f:
        kids += f.read().split()
print([t.name for t in threading.enumerate()], kids,
      sorted({m.split(".")[0] for m in sys.modules} & {"jax", "ray_tpu"}))
"""


def test_imports_start_nothing():
    """Importing the ported modules in a fresh interpreter starts no thread
    and no child process, and loads neither JAX nor ray_tpu."""
    proc = subprocess.run([sys.executable, "-c", _IMPORT_PROBE], cwd=REPO,
                          env=dict(os.environ, PYTHONPATH=REPO),
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().splitlines()[-1] == "['MainThread'] [] []"
