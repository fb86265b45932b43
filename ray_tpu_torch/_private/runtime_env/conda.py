"""Conda + container (image_uri) runtime-env plugins.

Reference analogs: ``python/ray/_private/runtime_env/conda.py`` (cached
conda env creation keyed by the spec hash) and ``image_uri.py`` (worker
runs inside a container). Both reuse the venv plugins' executor-subprocess
model: the prepared interpreter runs the framed child loop from
``executor.py``; for containers the loop simply launches through
``docker run -i`` (or podman) — the stdin/stdout protocol is
transport-agnostic.

Both plugins fail LOUDLY when their binary (conda / docker / podman) is
absent: a task must not silently run outside the environment it asked for.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import subprocess
from typing import Any, Dict, List, Optional, Union

from ray_tpu_torch._private.runtime_env.venv import _env_root as _cache_root


def conda_env_key(spec: Union[List[str], Dict[str, Any]]) -> str:
    blob = json.dumps(spec, sort_keys=True).encode()
    return "conda-" + hashlib.sha256(blob).hexdigest()[:16]


def ensure_conda_env(spec: Union[List[str], Dict[str, Any]]) -> str:
    """Create (or reuse) a cached conda env; returns its python path.

    ``spec``: a package list (``{"conda": ["scipy=1.11"]}``) or a full
    environment dict (``{"dependencies": [...], "channels": [...]}``) —
    the same two shapes the reference accepts.
    """
    conda = shutil.which("conda") or shutil.which("mamba") \
        or shutil.which("micromamba")
    if conda is None:
        raise RuntimeError(
            "runtime_env 'conda' requires a conda/mamba binary on PATH; "
            "none found (use the 'pip' plugin for venv-based envs)"
        )
    root = _cache_root()
    prefix = os.path.join(root, conda_env_key(spec))
    python = os.path.join(prefix, "bin", "python")
    if os.path.exists(python):
        # Idempotent: envs cached before cloudpickle seeding existed (or
        # whose seed was wiped) must still heal on reuse — the executor
        # child cannot start without it.
        _seed_cloudpickle(prefix)
        return python
    tmp_prefix = prefix + ".tmp"
    shutil.rmtree(tmp_prefix, ignore_errors=True)
    if isinstance(spec, dict):
        import tempfile

        with tempfile.NamedTemporaryFile(
            "w", suffix=".yml", delete=False
        ) as f:
            try:
                import yaml

                yaml.safe_dump(spec, f)
            except ImportError:
                json.dump(spec, f)  # conda accepts JSON env files
            env_file = f.name
        cmd = [conda, "env", "create", "-p", tmp_prefix, "-f", env_file,
               "--yes"]
    else:
        cmd = [conda, "create", "-p", tmp_prefix, "--yes", "python",
               *list(spec)]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=1800)
    if res.returncode != 0:
        shutil.rmtree(tmp_prefix, ignore_errors=True)
        raise RuntimeError(
            f"conda env creation failed:\n{res.stderr[-2000:]}"
        )
    _seed_cloudpickle(tmp_prefix)
    os.replace(tmp_prefix, prefix)
    return python


def _seed_cloudpickle(prefix: str) -> None:
    """Copy the host's cloudpickle (pure python) into the env's
    site-packages: the executor child loop imports it before any task runs,
    and a newly created conda env does not ship it. Copying just this one
    package keeps the env isolated — no host site-packages fallback that
    would silently satisfy imports the declared env is missing.

    Also runs as a heal on cache hits, so it must be atomic and
    race-tolerant: copy to a temp name, rename into place (losers of a
    concurrent race just discard their temp), and treat a dir missing
    ``__init__.py`` — an interrupted earlier copy — as absent."""
    import glob

    import cloudpickle

    src = os.path.dirname(cloudpickle.__file__)
    for site in glob.glob(
        os.path.join(prefix, "lib", "python*", "site-packages")
    ):
        dst = os.path.join(site, "cloudpickle")
        if os.path.exists(os.path.join(dst, "__init__.py")):
            continue
        tmp = f"{dst}.tmp{os.getpid()}"
        shutil.rmtree(tmp, ignore_errors=True)
        shutil.copytree(src, tmp)
        shutil.rmtree(dst, ignore_errors=True)  # partial leftover, if any
        try:
            os.replace(tmp, dst)
        except OSError:  # a concurrent seeder won the rename
            shutil.rmtree(tmp, ignore_errors=True)


def container_argv(image_uri: str, child_src: str,
                   path_entries: Optional[List[str]] = None,
                   working_dir: Optional[str] = None) -> List[str]:
    """argv that runs the executor child loop inside a container
    (reference: ``image_uri.py`` — podman-launched workers). The repo,
    staged py_modules, and the task's working_dir are bind-mounted at
    their HOST paths so cloudpickled functions, sys.path entries, and
    os.chdir targets resolve inside the container; PYTHONPATH is set
    in-container (the docker client's env never crosses the boundary)."""
    runtime = shutil.which("podman") or shutil.which("docker")
    if runtime is None:
        raise RuntimeError(
            "runtime_env 'image_uri' requires podman or docker on PATH; "
            "neither found"
        )
    import sys

    repo_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))
    )))
    entries = [os.path.abspath(e) for e in (path_entries or ())]
    # Host site-packages ride along read-only as a TAIL fallback so the
    # child loop can import cloudpickle (pure-python) even in minimal
    # images. They go through RT_PARENT_SITE — which the child loop appends
    # AFTER the image interpreter's own sys.path — never PYTHONPATH, whose
    # entries would precede the image's site-packages and silently shadow
    # the very packages image_uri was asked to provide.
    host_site = [p for p in sys.path if "site-packages" in p]
    pythonpath = os.pathsep.join([*entries, repo_root])
    argv = [runtime, "run", "--rm", "-i",
            "-v", f"{repo_root}:{repo_root}:ro",
            "-e", f"PYTHONPATH={pythonpath}",
            "-e", f"RT_PARENT_SITE={os.pathsep.join(host_site)}"]
    for e in entries:
        argv += ["-v", f"{e}:{e}:ro"]
    for sp in host_site:
        argv += ["-v", f"{sp}:{sp}:ro"]
    if working_dir:
        wd = os.path.abspath(working_dir)
        argv += ["-v", f"{wd}:{wd}"]
    argv += [image_uri, "python", "-u", "-c", child_src]
    return argv
