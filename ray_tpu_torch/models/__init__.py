"""Model zoo of the port: PyTorch model families sharing one interface.

Counterpart of ``ray_tpu/models/__init__.py``. Each model module exposes a
frozen ``*Config`` dataclass, ``PRESETS``, ``param_shapes``,
``init_params``, ``forward``, ``forward_cached``, ``init_kv_cache``,
``loss_fn`` (the training loss that ``train.step`` differentiates),
``count_params`` and ``flops_per_token``. The families: GPT-2
(``models/gpt2.py``) and Llama (``models/llama.py``).
"""
from __future__ import annotations

from typing import Any


def module_for(config: Any):
    """Return the model module that owns this config object."""
    from ray_tpu_torch.models import gpt2, llama

    if isinstance(config, llama.LlamaConfig):
        return llama
    if isinstance(config, gpt2.GPT2Config):
        return gpt2
    raise TypeError(f"unknown model config type: {type(config).__name__}")


def get_preset(name: str):
    """Look up a preset config by name across all families."""
    from ray_tpu_torch.models import gpt2, llama

    for mod in (gpt2, llama):
        if name in mod.PRESETS:
            return mod.PRESETS[name]
    known = sorted(list(gpt2.PRESETS) + list(llama.PRESETS))
    raise KeyError(f"unknown model preset {name!r}; known: {known}")
