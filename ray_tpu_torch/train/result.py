"""Training result handed back from ``Trainer.fit``.

Counterpart of ``ray_tpu/train/result.py`` (reference:
``python/ray/air/result.py`` Result)."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from ray_tpu_torch.train.checkpoint import Checkpoint


@dataclass
class Result:
    metrics: Dict[str, Any] = field(default_factory=dict)
    # the trial's hyperparameters (reference: Result.config — how users
    # read the winning configuration off get_best_result())
    config: Dict[str, Any] = field(default_factory=dict)
    checkpoint: Optional[Checkpoint] = None
    best_checkpoint: Optional[Checkpoint] = None
    path: Optional[str] = None
    error: Optional[str] = None
    metrics_history: List[Dict[str, Any]] = field(default_factory=list)
