"""Scaling policies: fixed and elastic world-size decisions.

Counterpart of ``ray_tpu/train/scaling_policy.py``. Reference analogs:
``train/v2/_internal/execution/scaling_policy/fixed.py:13`` and
``elastic.py:29`` (decisions :165/:198). An elastic resize starts a new
worker group, which forms a new process group over the surviving workers
and compiles its step again, so decisions are made only at (re)start
boundaries, not mid-run.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

from ray_tpu_torch.train.config import ScalingConfig


@dataclass
class ScalingDecision:
    world_size: int


class ScalingPolicy:
    def __init__(self, scaling: ScalingConfig):
        self.scaling = scaling

    def initial_decision(self) -> ScalingDecision:
        raise NotImplementedError

    def recovery_decision(self) -> Optional[ScalingDecision]:
        """World size for a restart after failure; None = cannot restart."""
        raise NotImplementedError


class FixedScalingPolicy(ScalingPolicy):
    def initial_decision(self) -> ScalingDecision:
        return ScalingDecision(self.scaling.num_workers)

    def recovery_decision(self) -> Optional[ScalingDecision]:
        return ScalingDecision(self.scaling.num_workers)


class ElasticScalingPolicy(ScalingPolicy):
    """Restart with as many workers as currently fit in the cluster,
    clamped to [min_workers, num_workers]."""

    def _available_worlds(self) -> int:
        import ray_tpu_torch

        per = self.scaling.worker_resources()
        avail = ray_tpu_torch.available_resources()
        fits = math.inf
        for k, need in per.items():
            if need <= 0:
                continue
            fits = min(fits, avail.get(k, 0.0) / need)
        return int(fits) if fits is not math.inf else self.scaling.num_workers

    def initial_decision(self) -> ScalingDecision:
        n = min(self.scaling.num_workers, max(self._available_worlds(), 1))
        n = max(n, self.scaling.min_workers or 1)
        return ScalingDecision(n)

    def recovery_decision(self) -> Optional[ScalingDecision]:
        lo = self.scaling.min_workers or 1
        n = min(self.scaling.num_workers, self._available_worlds())
        if n < lo:
            return None
        return ScalingDecision(n)

    def grow_decision(self, current: int) -> Optional[ScalingDecision]:
        """Mid-run grow check (reference: elastic.py resize decisions —
        a returned node grows the world back toward num_workers). The
        running workers' resources are already acquired, so free capacity
        counts EXTRA worlds on top of ``current``."""
        if current >= self.scaling.num_workers:
            return None
        extra = self._available_worlds()
        n = min(self.scaling.num_workers, current + extra)
        if n > current:
            return ScalingDecision(n)
        return None


def make_scaling_policy(scaling: ScalingConfig) -> ScalingPolicy:
    return (
        ElasticScalingPolicy(scaling) if scaling.elastic
        else FixedScalingPolicy(scaling)
    )
