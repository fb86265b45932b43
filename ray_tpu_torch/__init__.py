"""ray_tpu_torch: the PyTorch/CUDA port of ray_tpu, for NVIDIA Hopper.

A package of its own beside ``ray_tpu``, which stays the reference. It
imports ``torch`` and never ``jax``, nor anything of ``ray_tpu``. So far
it serves and trains GPT-2 and Llama on one card, their attention through
hand-written CUDA flash-attention kernels:

- ``ray_tpu_torch.ops.attention``: dense and blockwise plain versions, and
  the kernels' wrappers;
- ``ray_tpu_torch.models``: GPT-2, Llama and the conversion of JAX weights;
- ``ray_tpu_torch.parallel``: the Mixture-of-Experts layer, on one card;
- ``ray_tpu_torch.llm``: ``LLMConfig``, ``DecodeEngine``, sampling;
- ``ray_tpu_torch.train``: the train step.

Entry points take ``device=`` (default ``"cuda"``) and raise when CUDA is
absent unless the caller asks for ``"cpu"``.
"""
from ray_tpu_torch.llm import (
    ByteTokenizer,
    DecodeEngine,
    GenerationResult,
    LLMConfig,
    SamplingParams,
)

__all__ = [
    "ByteTokenizer", "DecodeEngine", "GenerationResult", "LLMConfig",
    "SamplingParams",
]
