"""py_modules / working_dir packaging: zip, content-address, stage in the
head's KV, download + unpack into a per-machine cache.

Reference analog: ``python/ray/_private/runtime_env/packaging.py`` —
``gcs://_ray_pkg_<hash>.zip`` URIs with local caches. Here the head KV is
the package store (runtime-env packages are code, i.e. small; a size cap
keeps datasets out of the control plane).
"""
from __future__ import annotations

import hashlib
import io
import logging
import os
import tempfile
import zipfile
from typing import List

logger = logging.getLogger(__name__)

PKG_NS = "_renv_pkgs"
MAX_PKG_BYTES = 64 * 1024 * 1024


def _zip_path(path: str) -> bytes:
    """Deterministic zip of a file or directory (stable order, no mtimes —
    the hash must be content-only)."""
    buf = io.BytesIO()
    base = os.path.basename(os.path.normpath(path))
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as z:
        if os.path.isfile(path):
            z.writestr(base, open(path, "rb").read())
        else:
            for root, dirs, files in os.walk(path):
                dirs.sort()
                for f in sorted(files):
                    if f.endswith(".pyc") or "__pycache__" in root:
                        continue
                    full = os.path.join(root, f)
                    rel = os.path.join(
                        base, os.path.relpath(full, path)
                    )
                    zi = zipfile.ZipInfo(rel)  # zeroed date_time
                    z.writestr(zi, open(full, "rb").read())
    data = buf.getvalue()
    if len(data) > MAX_PKG_BYTES:
        raise ValueError(
            f"py_modules package {path!r} is {len(data)/1e6:.0f}MB; "
            f"cap is {MAX_PKG_BYTES/1e6:.0f}MB (ship data via the object "
            f"store, not the code path)"
        )
    return data


def stage_modules(worker, paths: List[str]) -> List[dict]:
    """Driver side: upload each local module path once; returns wire
    descriptors [{"hash", "name"}]. Already-staged hashes are skipped (the
    head KV is the cache)."""
    out = []
    for path in paths:
        if isinstance(path, dict):  # already staged (actor restart replay)
            out.append(path)
            continue
        data = _zip_path(path)
        h = hashlib.sha256(data).hexdigest()[:24]
        key = f"pkg_{h}"
        cached = getattr(worker, "_staged_renv_pkgs", None)
        if cached is None:
            cached = worker._staged_renv_pkgs = set()
        if h not in cached:
            hdr, _ = worker.run_sync(
                worker.gcs.call(
                    "kv_exists", {"ns": PKG_NS, "key": key}
                )
            )
            if not hdr.get("exists"):
                worker.run_sync(
                    worker.gcs.call(
                        "kv_put",
                        {"ns": PKG_NS, "key": key},
                        [data],
                    )
                )
            cached.add(h)
        out.append({
            "hash": h, "name": os.path.basename(os.path.normpath(path)),
        })
    return out


def fetch_modules(worker, descriptors: List[dict]) -> List[str]:
    """Executor side: ensure each package is unpacked locally; returns
    sys.path entries. Cache dir is content-addressed so concurrent fetches
    of the same package are idempotent (tempdir + atomic rename)."""
    root = os.environ.get("RT_RUNTIME_ENV_DIR") or os.path.join(
        tempfile.gettempdir(), f"rt_runtime_env_{os.getuid()}"
    )
    pkg_root = os.path.join(root, "pkgs")
    os.makedirs(pkg_root, exist_ok=True)
    entries = []
    for d in descriptors:
        dest = os.path.join(pkg_root, d["hash"])
        if not os.path.isdir(dest):
            hdr, frames = worker.run_sync(
                worker.gcs.call(
                    "kv_get", {"ns": PKG_NS, "key": f"pkg_{d['hash']}"}
                )
            )
            if not hdr.get("found"):
                raise RuntimeError(
                    f"py_modules package {d['hash']} missing from the head"
                )
            tmp = tempfile.mkdtemp(dir=pkg_root)
            with zipfile.ZipFile(io.BytesIO(bytes(frames[0]))) as z:
                z.extractall(tmp)
            try:
                os.rename(tmp, dest)
            except OSError:
                import shutil

                shutil.rmtree(tmp, ignore_errors=True)  # lost the race
        entries.append(dest)
    return entries
