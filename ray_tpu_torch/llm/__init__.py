"""LLM layer of the port: the decode engine, the OpenAI serving surface and
batch inference.

Counterpart of ``ray_tpu/llm/``. ``DecodeEngine`` captures its prefill,
decode and speculative programs as CUDA graphs when it is built on a card
(``llm/programs.py``) and runs them eagerly on the CPU. ``LLMServer``
(completions, chat, streaming, logprobs), the prefill/decode servers and
``PDIngress`` (``llm/serving_patterns.py``), and the batch ``Processor``
are plain Python over the engine; they take ``device=`` for their
engines. ``build_openai_app``, ``serve_llm``, ``build_dp_openai_app`` and
``build_pd_openai_app`` deploy them through ``ray_tpu_torch.serve``.
"""
from ray_tpu_torch.llm.batch import Processor, build_llm_processor
from ray_tpu_torch.llm.config import ByteTokenizer, LLMConfig, load_tokenizer
from ray_tpu_torch.llm.engine import (
    DecodeEngine,
    GenerationResult,
    SamplingParams,
)
from ray_tpu_torch.llm.serving import LLMServer, build_openai_app, serve_llm
from ray_tpu_torch.llm.serving_patterns import (
    build_dp_openai_app,
    build_pd_openai_app,
)

__all__ = [
    "LLMConfig", "ByteTokenizer", "load_tokenizer",
    "DecodeEngine", "SamplingParams", "GenerationResult",
    "LLMServer", "build_openai_app", "serve_llm",
    "build_dp_openai_app", "build_pd_openai_app",
    "Processor", "build_llm_processor",
]
