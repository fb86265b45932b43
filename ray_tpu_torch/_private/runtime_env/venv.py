"""Cached virtualenv creation for runtime_env pip/uv plugins.

Reference analog: ``python/ray/_private/runtime_env/pip.py`` / ``uv.py`` —
one venv per unique requirement set, content-hash keyed, created once per
machine and reused (deleting/rebuilding per task would dwarf task runtimes).
Creation is serialized by an exclusive file lock so N workers racing on the
same env build it once.
"""
from __future__ import annotations

import hashlib
import json
import logging
import os
import shutil
import subprocess
import sys
import tempfile
from typing import List, Optional

logger = logging.getLogger(__name__)


def _env_root() -> str:
    return os.environ.get("RT_RUNTIME_ENV_DIR") or os.path.join(
        tempfile.gettempdir(), f"rt_runtime_env_{os.getuid()}"
    )


def env_key(packages: List[str], use_uv: bool) -> str:
    blob = json.dumps(
        {"pkgs": sorted(packages), "uv": use_uv,
         "py": sys.version_info[:2]},
        sort_keys=True,
    )
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def ensure_venv(packages: List[str], use_uv: bool = False,
                timeout: float = 600.0) -> str:
    """Create (or reuse) a venv with ``packages`` installed; returns the
    venv's python executable path. ``--system-site-packages`` keeps the
    framework's own deps (cloudpickle, numpy, ...) importable inside."""
    import fcntl

    key = env_key(packages, use_uv)
    root = os.path.join(_env_root(), "venvs")
    os.makedirs(root, exist_ok=True)
    path = os.path.join(root, key)
    python = os.path.join(path, "bin", "python")
    marker = os.path.join(path, ".rt_ready")
    if os.path.exists(marker):
        return python
    with open(os.path.join(root, f".{key}.lock"), "w") as lockf:
        fcntl.flock(lockf, fcntl.LOCK_EX)
        if os.path.exists(marker):
            return python  # another worker built it while we waited
        if os.path.exists(path):
            shutil.rmtree(path, ignore_errors=True)  # half-built leftover
        uv = shutil.which("uv") if use_uv else None
        if use_uv and not uv:
            # Fail loudly: pip's resolver can produce different installs
            # than the uv env the user tested with.
            raise RuntimeError(
                "runtime_env {'uv': ...} requested but the uv binary is "
                "not installed on this node (use {'pip': ...} instead)"
            )
        try:
            if uv:
                subprocess.run(
                    [uv, "venv", "--system-site-packages", path],
                    check=True, capture_output=True, timeout=timeout,
                )
                install = [uv, "pip", "install", "--python", python]
            else:
                subprocess.run(
                    [sys.executable, "-m", "venv",
                     "--system-site-packages", path],
                    check=True, capture_output=True, timeout=timeout,
                )
                install = [python, "-m", "pip", "install",
                           "--disable-pip-version-check"]
            if packages:
                res = subprocess.run(
                    install + list(packages),
                    capture_output=True, text=True, timeout=timeout,
                )
                if res.returncode != 0:
                    raise RuntimeError(
                        f"package install failed:\n{res.stderr[-2000:]}"
                    )
            with open(marker, "w") as f:
                f.write("ok")
        except Exception:
            shutil.rmtree(path, ignore_errors=True)
            raise
    return python
