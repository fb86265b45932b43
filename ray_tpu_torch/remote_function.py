"""@remote functions (reference: ``python/ray/remote_function.py``)."""
from __future__ import annotations

import functools
import os
from typing import Any, Dict, Optional

from ray_tpu_torch._private.worker import get_global_worker

# The static-analysis gate (the reference's ``lint`` package) is not
# ported yet.
_LINT_TODO = ("RAY_TPU_TORCH_LINT is set, but lint is not ported to "
              "ray_tpu_torch yet (ROADMAP queue 1 item 12)")

# Option names accepted by .options() / @remote(**...), mirroring the
# reference's option surface (``python/ray/_private/ray_option_utils.py``).
_TASK_OPTIONS = {
    "num_cpus",
    "num_gpus",
    "resources",
    "num_returns",
    "max_retries",
    "name",
    "scheduling_strategy",
    "runtime_env",
    "label_selector",
}


def _build_resources(opts: Dict[str, Any]) -> Dict[str, float]:
    resources = dict(opts.get("resources") or {})
    if opts.get("num_cpus") is not None:
        resources["CPU"] = float(opts["num_cpus"])
    resources.setdefault("CPU", 1.0)
    if opts.get("num_gpus"):
        resources["GPU"] = float(opts["num_gpus"])
    # zero-cpu tasks still need a slot marker so leases terminate
    if resources.get("CPU") == 0:
        resources.pop("CPU")
        resources.setdefault("node:slot", 0.001)
    return resources


def _build_strategy(opts: Dict[str, Any]) -> dict:
    strategy: dict = {}
    ss = opts.get("scheduling_strategy")
    if ss is not None:
        if isinstance(ss, str):
            if ss == "SPREAD":
                strategy["spread"] = True
        else:  # strategy object from util.scheduling_strategies
            strategy.update(ss.to_dict())
    if opts.get("label_selector"):
        strategy["labels"] = dict(opts["label_selector"])
    return strategy


class RemoteFunction:
    def __init__(self, fn, options: Optional[Dict[str, Any]] = None):
        self._fn = fn
        self._options = dict(options or {})
        functools.update_wrapper(self, fn)
        # Opt-in decoration-time static analysis (RAY_TPU_TORCH_LINT=1).
        if os.environ.get("RAY_TPU_TORCH_LINT"):
            raise NotImplementedError(_LINT_TODO)

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Remote function '{self._fn.__name__}' cannot be called directly; "
            f"use {self._fn.__name__}.remote()."
        )

    def options(self, **opts) -> "RemoteFunction":
        bad = set(opts) - _TASK_OPTIONS
        if bad:
            raise ValueError(f"unknown task options: {sorted(bad)}")
        merged = dict(self._options)
        merged.update(opts)
        return RemoteFunction(self._fn, merged)

    def remote(self, *args, **kwargs):
        worker = get_global_worker()
        opts = self._options
        num_returns = opts.get("num_returns", 1)
        refs = worker.submit_task(
            self._fn,
            args,
            kwargs,
            num_returns=num_returns,
            resources=_build_resources(opts),
            strategy=_build_strategy(opts),
            max_retries=opts.get("max_retries", 3),
            name=opts.get("name", ""),
            runtime_env=opts.get("runtime_env"),
        )
        if num_returns == "streaming":
            return refs  # a StreamingObjectRefGenerator
        if num_returns == 1:
            return refs[0]
        return refs

    @property
    def underlying_function(self):
        return self._fn
