"""LLM layer configuration.

Counterpart of ``ray_tpu/llm/config.py``: ``LLMConfig`` (same fields and
defaults), ``ByteTokenizer`` and ``load_tokenizer``. ``model_config()``
gives the port's ``GPT2Config`` or ``LlamaConfig`` with torch dtypes,
mapped as the JAX ``model_config()`` maps them.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Sequence

import torch


@dataclass
class LLMConfig:
    model_id: str = "gpt2-scratch"
    # Model: either explicit architecture numbers (fresh weights) or a path
    # to a pickled {"family": ..., "config": config kwargs, "params": tree of
    # numpy arrays} bundle ("family" defaults to gpt2).
    model_source: Optional[str] = None
    model_family: str = "gpt2"  # "gpt2" | "llama"
    vocab_size: int = 512
    max_seq_len: int = 1024
    num_layers: int = 4
    num_heads: int = 4
    num_kv_heads: Optional[int] = None  # llama GQA; None = num_heads (MHA)
    embed_dim: int = 256
    dtype: str = "bfloat16"
    # Mixture-of-Experts (Mixtral-style, SwiGLU experts, for llama; GELU
    # experts for gpt2): number of routed experts, 0 = dense. Decode routes
    # each token through its top-k experts (parallel/moe.py).
    moe_num_experts: int = 0
    moe_top_k: int = 2

    # Engine knobs
    max_batch_slots: int = 8
    prefill_buckets: Sequence[int] = (64, 128, 256)
    tensor_parallel_size: int = 1  # reserved: mesh "tensor" axis size
    # Prompt-lookup speculative decoding for greedy requests; k = max draft
    # tokens proposed per step, 0 disables.
    speculative_ngram_k: int = 0
    # Automatic prefix caching: LRU of completed prompt prefills, 0
    # disables. Each entry pins a full [L, 1, max_seq_len, H, D] cache.
    prefix_cache_size: int = 0

    # Serving
    max_new_tokens_default: int = 64
    tokenizer: str = "byte"  # "byte" | local HF tokenizer dir

    accelerator_type: Optional[str] = None
    deployment_config: Dict[str, Any] = field(default_factory=dict)

    def model_config(self):
        """The model's config. As in JAX, llama takes ``LlamaConfig``'s
        defaults for ``rope_theta`` and ``mlp_dim``, and the attention is
        the dense "xla" version."""
        dtype = torch.bfloat16 if self.dtype == "bfloat16" else torch.float32
        moe = None
        if self.moe_num_experts:
            from ray_tpu_torch.parallel.moe import MoEConfig

            moe = MoEConfig(
                num_experts=self.moe_num_experts,
                top_k=self.moe_top_k,
                activation=(
                    "swiglu" if self.model_family == "llama" else "gelu"
                ),
            )
        common = dict(
            vocab_size=self.vocab_size,
            max_seq_len=self.max_seq_len,
            num_layers=self.num_layers,
            num_heads=self.num_heads,
            embed_dim=self.embed_dim,
            dtype=dtype,
            attention_impl="xla",
            moe=moe,
        )
        if self.model_family == "llama":
            from ray_tpu_torch.models.llama import LlamaConfig

            return LlamaConfig(
                num_kv_heads=self.num_kv_heads or self.num_heads, **common
            )
        if self.model_family == "gpt2":
            from ray_tpu_torch.models.gpt2 import GPT2Config

            return GPT2Config(**common)
        raise ValueError(
            f"unknown model_family {self.model_family!r} (gpt2 | llama)"
        )

    def to_dict(self) -> dict:
        d = dict(self.__dict__)
        d["prefill_buckets"] = list(self.prefill_buckets)
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "LLMConfig":
        return cls(**d)


class ByteTokenizer:
    """Self-contained UTF-8 byte tokenizer (ids = byte + 2; 0=pad, 1=eos).

    Stands in for a model tokenizer where no vocabulary files are at hand;
    real checkpoints bring their own tokenizer dir (``tokenizer`` config
    field pointing at local HF files).
    """

    pad_id = 0
    eos_id = 1
    vocab_floor = 258

    def encode(self, text: str):
        return [b + 2 for b in text.encode("utf-8")]

    def decode(self, ids) -> str:
        # Total over any model vocab: ids beyond the byte range (the model
        # may have vocab_size > 258) decode to nothing rather than raising.
        return bytes(
            i - 2 for i in ids if 2 <= i <= 257
        ).decode("utf-8", errors="replace")


def load_tokenizer(config: LLMConfig):
    if config.tokenizer == "byte":
        return ByteTokenizer()
    from transformers import AutoTokenizer

    return AutoTokenizer.from_pretrained(config.tokenizer)
