"""Weights carried across from the JAX package.

``params_from_numpy`` turns a GPT-2 or Llama parameter tree of numpy
arrays (dense or MoE), named and laid out as the JAX ``init_params`` makes
it, into the port's ``GPT2`` or ``Llama`` module. The conversion from JAX
arrays to numpy (``jax.tree.map(np.asarray, params)``) happens on the
caller's side: this package never imports JAX.
The engine's pickled ``model_source`` bundles load through it as well.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from ray_tpu_torch._private.device import DeviceLike, resolve_device
from ray_tpu_torch.models import gpt2, llama, module_for
from ray_tpu_torch.parallel.moe import MoEConfig

_CONFIGS = {"gpt2": gpt2.GPT2Config, "llama": llama.LlamaConfig}

_TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(x: Any) -> torch.dtype:
    """A torch dtype from a torch dtype, a numpy dtype or a dtype name
    (JAX's ``jnp.bfloat16`` pickles as the numpy extension type of that
    name)."""
    if isinstance(x, torch.dtype):
        return x
    name = x if isinstance(x, str) else getattr(x, "__name__", None) or str(
        np.dtype(x))
    try:
        return _TORCH_DTYPES[name]
    except KeyError:
        raise TypeError(f"unsupported dtype {x!r}") from None


def tensor_from_numpy(arr: Any) -> torch.Tensor:
    """A CPU tensor holding ``arr``'s values. bfloat16 arrays (the numpy
    extension type JAX uses) are read through their 16-bit pattern, so no
    JAX or ml_dtypes import is needed."""
    a = np.ascontiguousarray(np.asarray(arr))
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def params_from_numpy(tree: Dict[str, Any], config,
                      device: DeviceLike = "cuda",
                      dtype: Optional[torch.dtype] = None):
    """JAX GPT-2 or Llama tree of numpy arrays -> the port's module
    (``GPT2`` or ``Llama``, by the config's type) on ``device``, each tensor
    in ``dtype`` (default ``config.param_dtype``). Names and layouts carry
    over unchanged, the MoE leaves under ``blocks.moe`` included; a missing
    leaf or a wrong shape raises."""
    dev = resolve_device(device)
    dtype = dtype or config.param_dtype
    mod = module_for(config)
    cls = llama.Llama if mod is llama else gpt2.GPT2

    def conv(sub, shapes, prefix):
        out = {}
        for name, shape in shapes.items():
            if name not in sub:
                raise KeyError(f"parameter {prefix}{name} missing from the tree")
            out[name] = (conv(sub[name], shape, f"{prefix}{name}.")
                         if isinstance(shape, dict)
                         else tensor_from_numpy(sub[name]).to(dtype))
        return out

    return cls(config, conv(tree, mod.param_shapes(config), ""), device=dev)


def config_from_kwargs(kwargs: Dict[str, Any], family: str = "gpt2"):
    """``GPT2Config`` or ``LlamaConfig`` (by ``family``) from a bundle's
    saved config kwargs, dtypes mapped to torch and a saved ``moe`` dict of
    ``MoEConfig``'s fields to a ``MoEConfig``."""
    if family not in _CONFIGS:
        raise ValueError(f"unknown model family {family!r} (gpt2 | llama)")
    kw = dict(kwargs)
    for name in ("dtype", "param_dtype"):
        if name in kw:
            kw[name] = torch_dtype(kw[name])
    if isinstance(kw.get("moe"), dict):
        kw["moe"] = MoEConfig(**kw["moe"])
    return _CONFIGS[family](**kw)
