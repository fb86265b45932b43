"""Subprocess executor for tasks that run inside a runtime-env venv.

Reference analog: the worker-pool-per-runtime-env model (raylet worker pool
keyed by env hash; ``agent/runtime_env_agent.py`` prepares, workers launch
inside). The port's node process runs its tasks and actors as threads and
holds the card's CUDA context, so instead of recycling whole workers per
env, each distinct venv gets a lightweight executor subprocess: the parent
ships pickled (fn, args, kwargs) over a pipe, the child (running the venv's
python) executes and ships back the pickled result. The child sees the
venv's packages; numpy-style args flow both ways because the venv uses
--system-site-packages.

The child inherits the node's environment, ``CUDA_VISIBLE_DEVICES``
included, so it sees the card exactly when its node holds one, and opens a
CUDA context of its own. Tensors cross the pipe as host data, both ways, by
the port's serialization (``_private/serialization.py``): a CUDA tensor is
staged to the host by the pickler and lands on the reader's current CUDA
device, or raises where the reader has none.
"""
from __future__ import annotations

import logging
import os
import struct
import subprocess
import sys
import threading
from typing import Any, Dict, List, Optional, Tuple

logger = logging.getLogger(__name__)

_U32 = struct.Struct("<I")

# The child loop. Kept dependency-minimal: cloudpickle comes from the
# parent's site-packages (venvs are created with --system-site-packages).
_CHILD_SRC = r"""
import os, struct, sys, traceback
# The protocol channel is the ORIGINAL stdout fd, dup'd away before any
# user code runs; fd 1 is then pointed at stderr so task print() output
# cannot corrupt the length-prefixed wire framing.
_proto_fd = os.dup(1)
os.dup2(2, 1)
out = os.fdopen(_proto_fd, "wb")
# The parent's site-packages ride along as a FALLBACK (appended, so venv
# installs take precedence — except cloudpickle, pinned to the parent's
# copy below): `python -m venv` from a venv interpreter points system-site
# at the BASE prefix, losing the parent venv's packages (cloudpickle,
# numpy) that result shipping depends on.
_psite = [p for p in os.environ.get("RT_PARENT_SITE", "").split(os.pathsep) if p]
for _p in _psite:
    if _p not in sys.path:
        sys.path.append(_p)
# Protocol pin: the framed wire format is cloudpickle, and dumps/loads must
# run the SAME version on both ends (its reconstruction helpers are
# referenced by name; major-version gaps break loads). When the parent's
# site rides along, import ITS copy under the real module name — by-name
# references inside the stream then resolve to it too — instead of letting
# an image/venv-bundled older cloudpickle take over the protocol. This is
# the ONE package for which the env's own install does NOT win. Best-effort:
# if the parent's copy won't execute here (interpreter too old, mount
# unreadable), fall back to the env's own cloudpickle below.
import importlib.util as _ilu
for _p in _psite:
    _init = os.path.join(_p, "cloudpickle", "__init__.py")
    if os.path.exists(_init):
        try:
            _spec = _ilu.spec_from_file_location(
                "cloudpickle", _init,
                submodule_search_locations=[os.path.join(_p, "cloudpickle")])
            _mod = _ilu.module_from_spec(_spec)
            sys.modules["cloudpickle"] = _mod
            _spec.loader.exec_module(_mod)
        except BaseException:
            sys.modules.pop("cloudpickle", None)
            continue
        break
import cloudpickle

_U32 = struct.Struct("<I")
inp = sys.stdin.buffer


def dumps(value):
    # A result that holds torch tensors leaves by the port's pickler, which
    # stages CUDA tensors to the host; torch is loaded only if the task
    # loaded it.
    if "torch" in sys.modules:
        from ray_tpu_torch._private.serialization import _dumps

        return _dumps(value, None)
    return cloudpickle.dumps(value)

def read_exact(n):
    data = b""
    while len(data) < n:
        chunk = inp.read(n - len(data))
        if not chunk:
            raise SystemExit(0)
        data += chunk
    return data

while True:
    (n,) = _U32.unpack(read_exact(4))
    blob = read_exact(n)
    old_env, old_cwd = {}, None
    try:
        fn, args, kwargs, env_vars, cwd = cloudpickle.loads(blob)
        for k, v in (env_vars or {}).items():
            old_env[k] = os.environ.get(k)
            os.environ[k] = str(v)
        if cwd:
            old_cwd = os.getcwd()
            os.chdir(cwd)
        result = (True, fn(*args, **kwargs))
    except BaseException as e:
        result = (False, (repr(e), traceback.format_exc()))
    finally:
        if old_cwd is not None:
            try:
                os.chdir(old_cwd)
            except OSError:
                pass
        for k, v in old_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    try:
        reply = dumps(result)
    except BaseException as e:
        # unpicklable return value: a task failure, not an executor crash
        reply = cloudpickle.dumps(
            (False, (f"task result not serializable: {e!r}",
                     traceback.format_exc()))
        )
    out.write(_U32.pack(len(reply)))
    out.write(reply)
    out.flush()
"""


class EnvExecutor:
    """One venv subprocess; tasks run serially per executor (the parent's
    task-slot accounting still bounds concurrency — one slot drives one
    executor call at a time)."""

    def __init__(self, python: str, path_entries: Optional[List[str]] = None,
                 argv: Optional[List[str]] = None,
                 inherit_parent_site: bool = True):
        """``argv`` overrides the child command entirely (the container
        plugin launches the SAME child loop via ``docker run -i ... python
        -c``; the framed stdin/stdout protocol is transport-agnostic).
        ``inherit_parent_site=False`` for conda envs, which stay fully
        isolated (cloudpickle is seeded into them at creation —
        ``conda._seed_cloudpickle``). Containers instead receive a
        RT_PARENT_SITE tail-fallback set by ``conda.container_argv`` so
        minimal images can still import cloudpickle; the child appends it
        AFTER the image's own sys.path, so image packages win — with the
        single exception of cloudpickle itself, which the child pins to
        the parent's copy because it IS the wire protocol (see
        ``_CHILD_SRC``)."""
        self.python = python
        env = dict(os.environ)
        # The child must import ray_tpu_torch (its serialization, and the
        # kernels' wrappers for a task on the card) and any staged
        # py_modules; prepend rather than replace.
        extra = list(path_entries or [])
        repo_root = os.path.dirname(
            os.path.dirname(os.path.dirname(os.path.dirname(
                os.path.abspath(__file__)
            )))
        )
        extra.append(repo_root)
        prev = env.get("PYTHONPATH")
        env["PYTHONPATH"] = os.pathsep.join(
            extra + ([prev] if prev else [])
        )
        # Parent site-packages (appended by the child AFTER its own): see
        # _CHILD_SRC. sys.path is the honest source — site.getsitepackages
        # misses venv layouts.
        if inherit_parent_site:
            env["RT_PARENT_SITE"] = os.pathsep.join(
                p for p in sys.path if "site-packages" in p
            )
        self._lock = threading.Lock()
        # The task currently executing IN the child (set under _lock by
        # run()); the pressure killer's victim population.
        self.current_task: Optional[dict] = None
        self.proc = subprocess.Popen(
            argv or [python, "-u", "-c", _CHILD_SRC],
            stdin=subprocess.PIPE,
            stdout=subprocess.PIPE,
            env=env,
        )

    def alive(self) -> bool:
        return self.proc.poll() is None

    def run(self, fn, args, kwargs, env_vars: Optional[dict] = None,
            cwd: Optional[str] = None,
            task_info: Optional[dict] = None) -> Tuple[bool, Any]:
        """Returns (ok, result-or-(err_repr, traceback)). env_vars/cwd are
        applied PER CALL inside the child (executors are cached per venv, so
        per-task env differences must not bake into the process). Raises
        RuntimeError if the child died (caller treats as task failure and
        discards the executor). ``task_info`` is published as
        ``self.current_task`` ONLY while this call holds the child (inside
        the lock): the pressure killer must see the task actually running
        in the subprocess, not one queued behind it."""
        import cloudpickle

        from ray_tpu_torch._private.serialization import _dumps

        blob = _dumps((fn, args, kwargs, env_vars, cwd), None)
        with self._lock:
            self.current_task = task_info
            if not self.alive():
                self.current_task = None
                raise RuntimeError("runtime-env executor process died")
            try:
                self.proc.stdin.write(_U32.pack(len(blob)))
                self.proc.stdin.write(blob)
                self.proc.stdin.flush()
                hdr = self.proc.stdout.read(4)
                if len(hdr) < 4:
                    raise RuntimeError(
                        "runtime-env executor exited mid-task"
                    )
                (n,) = _U32.unpack(hdr)
                data = b""
                while len(data) < n:
                    chunk = self.proc.stdout.read(n - len(data))
                    if not chunk:
                        raise RuntimeError(
                            "runtime-env executor exited mid-reply"
                        )
                    data += chunk
            except (BrokenPipeError, OSError) as e:
                raise RuntimeError(f"runtime-env executor pipe: {e}")
            finally:
                self.current_task = None
        return cloudpickle.loads(data)

    def close(self):
        try:
            self.proc.stdin.close()
        except Exception:
            pass
        try:
            self.proc.terminate()
            self.proc.wait(timeout=3)
        except Exception:
            try:
                self.proc.kill()
            except Exception:
                pass
