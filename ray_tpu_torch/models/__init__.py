"""Model zoo of the port: PyTorch model families sharing one interface.

Counterpart of ``ray_tpu/models/__init__.py``. Each model module exposes a
frozen ``*Config`` dataclass, ``PRESETS``, ``init_params``, ``forward``,
``forward_cached``, ``init_kv_cache``, ``loss_fn`` (the training loss that
``train.step`` differentiates), ``count_params`` and ``flops_per_token``.
Only GPT-2 is ported so far; llama waits for its slice.
"""
from __future__ import annotations

from typing import Any


def module_for(config: Any):
    """Return the model module that owns this config object."""
    from ray_tpu_torch.models import gpt2

    if isinstance(config, gpt2.GPT2Config):
        return gpt2
    raise TypeError(
        f"unknown model config type: {type(config).__name__} (the port has "
        "gpt2 only; llama is not ported yet)"
    )


def get_preset(name: str):
    """Look up a preset config by name."""
    from ray_tpu_torch.models import gpt2

    if name in gpt2.PRESETS:
        return gpt2.PRESETS[name]
    if name.startswith("llama"):
        raise NotImplementedError(f"preset {name!r}: llama is not ported yet")
    raise KeyError(
        f"unknown model preset {name!r}; known: {sorted(gpt2.PRESETS)}"
    )
