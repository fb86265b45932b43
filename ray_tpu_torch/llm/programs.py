"""The engine's device functions as programs over static buffers.

Counterpart of ``jax.jit`` in ``ray_tpu/llm/engine.py``: XLA compiles each
of the engine's functions once for its static shapes; here each is
captured once into a ``torch.cuda.CUDAGraph`` and replayed, so one replay
launches a whole forward with no Python between its kernels.

A ``Program`` reads its inputs from static buffers that it owns: a call
copies the host arrays it is given into them, runs, and returns copies of
the outputs, which the caller owns (the next call overwrites the graph's
own outputs). Anything else the function touches (weights, a KV cache it
writes in place) it captures by address, so those tensors must stay put.
On the CPU the function runs eagerly on the same buffers: only the capture
differs.
"""
from __future__ import annotations

from typing import Any, Callable, Dict

import numpy as np
import torch

from ray_tpu_torch.ops import attention

# Eager calls before capture, as CUDA's graph recipe asks: they run lazy
# initialisation (cuBLAS handles and workspaces) outside the capture.
_WARMUP = 3


def _owned(out: Any) -> Any:
    """A copy of ``out`` (a tensor, or a dict, tuple or list of them)."""
    if isinstance(out, torch.Tensor):
        return out.clone()
    if isinstance(out, dict):
        return {k: _owned(v) for k, v in out.items()}
    return type(out)(_owned(v) for v in out)


class Program:
    """``fn(**buffers)`` on static input buffers; a CUDA graph on a CUDA
    device (captured here, at construction), eager on the CPU.

    ``buffers`` are the inputs, by name, at their fixed shapes and dtypes;
    their values at construction are the ones warm-up and capture run on.
    A capture that fails raises: nothing falls back to eager calls on the
    card. ``replays`` counts the graph's replays; ``launches`` holds the
    hand-written kernels' launches that one replay makes, which each replay
    adds to ``attention.launches``."""

    def __init__(self, fn: Callable[..., Any],
                 buffers: Dict[str, torch.Tensor]):
        self.fn = fn
        self.buffers = buffers
        self.graph = None
        self.replays = 0
        self.launches = {}
        device = next(iter(buffers.values())).device
        if device.type == "cuda":
            self._capture()

    @torch.no_grad()
    def _capture(self) -> None:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(_WARMUP):
                self.fn(**self.buffers)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        # Its own memory pool (the default), so replays in any order never
        # overwrite another graph's outputs; thread-local capture, so CUDA
        # calls of other threads (another engine's loop) cannot void it.
        with attention.recorded() as self.launches, torch.cuda.graph(
                graph, capture_error_mode="thread_local"):
            self._out = self.fn(**self.buffers)
        self.graph = graph

    @torch.no_grad()
    def __call__(self, **inputs: Any) -> Any:
        """Copy ``inputs`` (numpy arrays or tensors, by buffer name) into
        the buffers, run, and return copies of the outputs."""
        for name, value in inputs.items():
            if isinstance(value, np.ndarray):
                value = torch.from_numpy(value)
            self.buffers[name].copy_(value)
        if self.graph is None:
            return _owned(self.fn(**self.buffers))
        self.graph.replay()
        self.replays += 1
        attention.count_replay(self.launches)
        return _owned(self._out)
