"""Checkpoints: directory-based user checkpoints, the top-K retention
manager, and the train state's persistence.

Counterpart of ``ray_tpu/train/checkpoint.py`` (reference analogs:
``python/ray/train/_checkpoint.py``, Checkpoint = a directory;
``train/v2/_internal/execution/checkpoint/checkpoint_manager.py:93``, top-K
retention keyed on a score attribute; storage is a path every host sees).

``Checkpoint`` and ``CheckpointManager`` are the reference's. Where the
reference persists a pytree of ``jax.Array`` with orbax,
:func:`save_pytree` / :func:`load_pytree` persist the port's train state,
``{"params", "opt_state", "step"}``, with ``torch.distributed.checkpoint``
in its single-process mode (``no_dist=True``): the writer holds every
tensor whole (a DTensor leaf is gathered with ``full_tensor()``), as the
reference's loop saves from rank 0 only. Dtypes are kept, bf16 included.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
import threading
import warnings
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import torch
from torch import nn

from ray_tpu_torch.train.config import CheckpointConfig


class Checkpoint:
    """A directory of state produced by (or handed to) a train_fn."""

    def __init__(self, path: str):
        self.path = os.path.abspath(path)

    @classmethod
    def from_directory(cls, path: str) -> "Checkpoint":
        if not os.path.isdir(path):
            raise ValueError(f"checkpoint path {path} is not a directory")
        return cls(path)

    def to_directory(self, dest: Optional[str] = None) -> str:
        """Copy checkpoint contents into ``dest`` (or a temp dir)."""
        dest = dest or tempfile.mkdtemp(prefix="rt_ckpt_")
        os.makedirs(dest, exist_ok=True)
        shutil.copytree(self.path, dest, dirs_exist_ok=True)
        return dest

    @contextmanager
    def as_directory(self):
        """Read-only access to the checkpoint directory (no copy: storage is
        a host-visible filesystem path)."""
        yield self.path

    def __repr__(self):
        return f"Checkpoint({self.path})"

    def __reduce__(self):
        return (Checkpoint, (self.path,))


@dataclass
class _Tracked:
    checkpoint: Checkpoint
    metrics: Dict[str, Any]
    index: int


@dataclass
class TrainingReport:
    """One ``report()`` call's payload as seen by the controller."""

    metrics: Dict[str, Any]
    checkpoint_path: Optional[str] = None
    rank: int = 0


class CheckpointManager:
    """Registers persisted checkpoints, retains top-K, deletes the rest."""

    def __init__(self, config: CheckpointConfig, run_dir: str):
        self._config = config
        self._run_dir = run_dir
        self._tracked: List[_Tracked] = []
        self._counter = 0
        self._lock = threading.Lock()
        os.makedirs(run_dir, exist_ok=True)

    @property
    def run_dir(self) -> str:
        return self._run_dir

    def register(self, path: str, metrics: Dict[str, Any]) -> Checkpoint:
        """Track a persisted checkpoint directory; evict beyond top-K."""
        ckpt = Checkpoint(path)
        with self._lock:
            self._tracked.append(_Tracked(ckpt, dict(metrics), self._counter))
            self._counter += 1
            self._evict_locked()
            self._write_index_locked()
        return ckpt

    def _score(self, t: _Tracked):
        attr = self._config.checkpoint_score_attribute
        if attr is None:
            return t.index  # recency
        v = t.metrics.get(attr)
        if v is None:
            return float("-inf") if self._config.checkpoint_score_order == "max" \
                else float("inf")
        return v

    def _evict_locked(self):
        k = self._config.num_to_keep
        if k is None or len(self._tracked) <= k:
            return
        reverse = self._config.checkpoint_score_order == "max"
        ranked = sorted(self._tracked, key=self._score, reverse=reverse)
        keep = ranked[:k]
        # never evict the most recent checkpoint — it's the resume point
        latest = max(self._tracked, key=lambda t: t.index)
        if latest not in keep:
            keep = keep[:-1] + [latest]
        for t in self._tracked:
            if t not in keep:
                shutil.rmtree(t.checkpoint.path, ignore_errors=True)
        self._tracked = [t for t in self._tracked if t in keep]

    def _write_index_locked(self):
        index = [
            {"path": t.checkpoint.path, "metrics": t.metrics, "index": t.index}
            for t in sorted(self._tracked, key=lambda t: t.index)
        ]
        tmp = os.path.join(self._run_dir, ".ckpt_index.tmp")
        with open(tmp, "w") as f:
            json.dump(index, f)
        os.replace(tmp, os.path.join(self._run_dir, "ckpt_index.json"))

    @property
    def latest_checkpoint(self) -> Optional[Checkpoint]:
        with self._lock:
            if not self._tracked:
                return None
            return max(self._tracked, key=lambda t: t.index).checkpoint

    @property
    def best_checkpoint(self) -> Optional[Checkpoint]:
        with self._lock:
            if not self._tracked:
                return None
            reverse = self._config.checkpoint_score_order == "max"
            return sorted(self._tracked, key=self._score, reverse=reverse)[0].checkpoint

    @property
    def checkpoints(self) -> List[Checkpoint]:
        with self._lock:
            return [t.checkpoint for t in sorted(self._tracked, key=lambda t: t.index)]

    @classmethod
    def restore_index(cls, config: CheckpointConfig, run_dir: str) -> "CheckpointManager":
        """Rebuild a manager from ``ckpt_index.json`` (controller restart)."""
        mgr = cls(config, run_dir)
        idx_path = os.path.join(run_dir, "ckpt_index.json")
        if os.path.exists(idx_path):
            with open(idx_path) as f:
                for entry in json.load(f):
                    if os.path.isdir(entry["path"]):
                        mgr._tracked.append(
                            _Tracked(Checkpoint(entry["path"]), entry["metrics"],
                                     entry["index"])
                        )
                        mgr._counter = max(mgr._counter, entry["index"] + 1)
        return mgr


# ---------------------------------------------------------------------------
# the train state's persistence (torch.distributed.checkpoint)
# ---------------------------------------------------------------------------

def _tensors(tree: Any, gather: bool = True) -> Any:
    """``tree`` with each module replaced by its ``state_dict()`` (tensors
    that share the parameters' storage) and each DTensor by its whole
    tensor (``full_tensor()``: a collective over the DTensor's mesh), or,
    without ``gather``, refused (a load would fill a copy)."""
    from torch.distributed.tensor import DTensor

    if isinstance(tree, nn.Module):
        return _tensors(tree.state_dict(), gather)
    if isinstance(tree, DTensor):
        if not gather:
            raise TypeError("load_pytree loads into whole tensors: build the "
                            "target without a mesh, then distribute it")
        return tree.full_tensor()
    if isinstance(tree, dict):
        return {k: _tensors(v, gather) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tensors(v, gather) for v in tree]
    return tree


def _flatten(tree: Any, prefix: str, flat: Dict[str, Any]) -> Any:
    """Fill ``flat`` with ``tree``'s leaves under path keys ("params/wte.
    weight", "opt_state/exp_avg/0") and return its structure as JSON: a
    dict, a list, or a leaf, ``{"tensor": key, "shape", "dtype"}`` or
    ``{"value": key}``."""
    if isinstance(tree, dict):
        return {"dict": {k: _flatten(v, f"{prefix}{k}/", flat)
                         for k, v in tree.items()}}
    if isinstance(tree, (list, tuple)):
        return {"list": [_flatten(v, f"{prefix}{i}/", flat)
                         for i, v in enumerate(tree)]}
    key = prefix[:-1]
    flat[key] = tree
    if isinstance(tree, torch.Tensor):
        return {"tensor": key, "shape": list(tree.shape),
                "dtype": str(tree.dtype).removeprefix("torch.")}
    return {"value": key}


def _unflatten(spec: Any, flat: Dict[str, Any]) -> Any:
    if "dict" in spec:
        return {k: _unflatten(v, flat) for k, v in spec["dict"].items()}
    if "list" in spec:
        return [_unflatten(v, flat) for v in spec["list"]]
    return flat[spec.get("tensor", spec.get("value"))]


def _placeholders(spec: Any, flat: Dict[str, Any]) -> None:
    """Fill ``flat`` with an empty CPU tensor for each tensor leaf of
    ``spec`` and None for each plain value, for a load to fill."""
    if "dict" in spec or "list" in spec:
        for v in (spec["dict"].values() if "dict" in spec else spec["list"]):
            _placeholders(v, flat)
    elif "tensor" in spec:
        flat[spec["tensor"]] = torch.empty(
            spec["shape"], dtype=getattr(torch, spec["dtype"]))
    else:
        flat[spec["value"]] = None


def _dcp(fn, state_dict: Dict[str, Any], path: str) -> None:
    with warnings.catch_warnings():
        # no_dist=True is the intent, not a fallback
        warnings.filterwarnings("ignore", message=".*single process.*")
        fn(state_dict, checkpoint_id=path, no_dist=True)


def save_pytree(state: Any, path: Optional[str]) -> None:
    """Persist ``state`` (the train state, or any nest of dicts, lists,
    modules, tensors and plain values) under the directory ``path``: its
    leaves, flat, with ``torch.distributed.checkpoint`` in ``state/``, and
    its structure in ``tree.json``.

    Every tensor is written whole, from this process. Where ``state`` holds
    DTensors, every rank of their mesh must call ``save_pytree`` (the
    gathers are collectives); a rank that passes ``path=None`` takes part in
    them and writes nothing.
    """
    import torch.distributed.checkpoint as dcp

    flat: Dict[str, Any] = {}
    spec = _flatten(_tensors(state), "", flat)
    if path is None:
        return
    root = os.path.abspath(path)
    target = os.path.join(root, "state")
    if os.path.exists(target):
        shutil.rmtree(target)
    os.makedirs(target)
    _dcp(dcp.save, flat, target)
    with open(os.path.join(root, "tree.json"), "w") as f:
        json.dump(spec, f)


def load_pytree(path: str, target: Any = None) -> Any:
    """Restore what :func:`save_pytree` saved under ``path``.

    With ``target`` (a freshly built state of the same structure, for
    example ``create_train_state``'s on its device) every tensor is loaded
    in place into the target's, and the target is returned with its plain
    values (``step``) read back. Without it, a nest of dicts and lists of
    CPU tensors and plain values (a module's parameters as a dict by name),
    built from ``tree.json``.
    """
    import torch.distributed.checkpoint as dcp

    root = os.path.abspath(path)
    flat: Dict[str, Any] = {}
    if target is None:
        with open(os.path.join(root, "tree.json")) as f:
            spec = json.load(f)
        _placeholders(spec, flat)
    else:
        spec = _flatten(_tensors(target, gather=False), "", flat)
    _dcp(dcp.load, flat, os.path.join(root, "state"))
    if target is None:
        return _unflatten(spec, flat)

    def plain(tree, spec):
        """``tree`` with the plain values loaded into ``flat`` (the tensors
        were loaded in place)."""
        if isinstance(tree, nn.Module):
            return tree
        if isinstance(tree, dict):
            return {k: plain(v, spec["dict"][k]) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [plain(v, x) for v, x in zip(tree, spec["list"])]
        if isinstance(tree, torch.Tensor):
            return tree
        return flat[spec["value"]]

    return plain(target, spec)
