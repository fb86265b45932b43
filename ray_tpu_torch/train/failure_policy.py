"""Failure policy: retry-or-raise after a worker-group failure.

Counterpart of ``ray_tpu/train/failure_policy.py``. Reference analog:
``train/v2/_internal/execution/failure_handling/`` —
``FailurePolicy.make_decision`` consuming ``FailureConfig.max_failures``.
"""
from __future__ import annotations

from enum import Enum

from ray_tpu_torch.train.config import FailureConfig


class FailureDecision(Enum):
    RETRY = "retry"
    RAISE = "raise"


class FailurePolicy:
    def __init__(self, config: FailureConfig):
        self.config = config
        self.failures = 0

    def make_decision(self, error: str) -> FailureDecision:
        self.failures += 1
        if self.config.max_failures < 0:
            return FailureDecision.RETRY
        if self.failures <= self.config.max_failures:
            return FailureDecision.RETRY
        return FailureDecision.RAISE
