"""Training of the port: the train step on one card and on a mesh.

Counterpart of ``ray_tpu/train/step.py``: ``OptimizerConfig``,
``param_shardings``, ``create_train_state``, ``make_train_step`` and
``make_eval_step``. The rest of ``ray_tpu.train`` (trainers, worker groups,
checkpoints) comes with the runtime slice.
"""
from ray_tpu_torch.train.step import (
    ClipAdamW,
    OptimizerConfig,
    create_train_state,
    make_eval_step,
    make_train_step,
    param_shardings,
)

__all__ = [
    "ClipAdamW", "OptimizerConfig", "create_train_state", "make_eval_step",
    "make_train_step", "param_shardings",
]
