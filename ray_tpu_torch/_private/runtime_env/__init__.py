"""Per-task/actor runtime environments.

Reference behavior being reproduced (not copied):
``python/ray/_private/runtime_env/`` — pip/uv create cached virtualenvs
(``pip.py``, ``uv.py``), ``py_modules``/``working_dir`` are packaged,
content-addressed, uploaded, and downloaded to per-node caches
(``packaging.py``), and workers start inside the prepared env (the per-node
runtime-env agent, ``agent/runtime_env_agent.py``).

Design differences: there is no separate env agent process — the node's
worker prepares environments lazily on first use (creation happens on the
task executor thread, which already represents the task's slot), venvs are
content-hashed and shared machine-wide, and pip/uv tasks execute in a
dedicated per-env subprocess (``executor.py``) instead of re-launching the
whole worker: the node process holds the card's CUDA context and its
threads' actors, and must not be recycled per env. The child inherits the
node's ``CUDA_VISIBLE_DEVICES``, so it sees the card exactly when its node
holds one, and opens a CUDA context of its own.

Supported plugins: env_vars, working_dir, py_modules, pip, uv, conda
(cached conda envs — ``conda.py``), image_uri (container executors),
worker_process_setup_hook (once-per-process init callable — reference
``setup_hook.py``).
Anything else fails loudly at execution time: a task must not silently run
without the environment it asked for.
"""
from __future__ import annotations

KNOWN_PLUGINS = ("env_vars", "working_dir", "py_modules", "pip", "uv",
                 "conda", "image_uri", "worker_process_setup_hook")


def validate(renv: dict):
    """Raise on unknown plugins — a task must not silently run without the
    environment it asked for."""
    from ray_tpu_torch import exceptions as exc

    unknown = [k for k in (renv or {}) if k not in KNOWN_PLUGINS]
    if unknown:
        raise exc.RayTpuError(
            f"runtime_env plugins {unknown!r} are not supported "
            f"(supported: {list(KNOWN_PLUGINS)})"
        )


# ---------------------------------------------------------------- setup hook

_SETUP_HOOKS_RAN = set()


def resolve_setup_hook(hook):
    """Hook spec -> callable: a submit-side pickled callable
    ({"__pickled_hook__": hex}) or a "module.attr" path."""
    if isinstance(hook, dict) and "__pickled_hook__" in hook:
        import cloudpickle

        return cloudpickle.loads(bytes.fromhex(hook["__pickled_hook__"]))
    import importlib

    mod, _, attr = str(hook).rpartition(".")
    if not mod:
        raise ValueError(
            f"worker_process_setup_hook {hook!r}: expected a callable or a "
            f"'module.attr' path"
        )
    return getattr(importlib.import_module(mod), attr)


def hook_key(hook) -> str:
    if isinstance(hook, dict) and "__pickled_hook__" in hook:
        return hook["__pickled_hook__"]
    return str(hook)


def run_setup_hook_once(hook) -> None:
    """Run the hook once per PROCESS (worker or env-executor child).
    Failures propagate — a task must not run half-initialized."""
    key = hook_key(hook)
    if key in _SETUP_HOOKS_RAN:
        return
    resolve_setup_hook(hook)()
    _SETUP_HOOKS_RAN.add(key)


class SetupHookTask:
    """Wraps a venv/conda/container-routed task so the env's setup hook
    runs inside the CHILD process (the process that executes the task)
    before the user function — the parent's once-per-process bookkeeping
    cannot cover a different process."""

    def __init__(self, hook, fn):
        self.hook = hook
        self.fn = fn

    def __call__(self, *args, **kwargs):
        run_setup_hook_once(self.hook)
        return self.fn(*args, **kwargs)
