"""Prefill/decode disaggregation over the port's decode engine.

Counterpart of ``ray_tpu/llm/serving_patterns.py`` (reference analog:
``python/ray/llm/_internal/serve/serving_patterns/prefill_decode/``):
separate prefill and decode replicas, the prompt's KV state handed from
one to the other. ``PrefillServer`` and ``DecodeServer`` each hold one
engine; ``PDIngress`` routes a request through the two handles it is
given, calling ``handle.<method>.remote(...).result(timeout)`` on them, so
any object with that shape serves (a Serve handle once the runtime is
ported, or an in-process stand-in). The transferred state is a dict of CPU
tensors (``DecodeEngine.prefill_only``). The Serve app functions
(``build_dp_openai_app``, ``build_pd_openai_app``) wait for that runtime.
"""
from __future__ import annotations

import json

from ray_tpu_torch._private.device import DeviceLike
from ray_tpu_torch.llm.config import LLMConfig, load_tokenizer
from ray_tpu_torch.llm.engine import DecodeEngine, SamplingParams
from ray_tpu_torch.llm.serving import completion_response, extract_sampling


class PrefillServer:
    """Prefill pool replica: prompts in, transferable KV states out."""

    def __init__(self, config_dict: dict, params=None,
                 device: DeviceLike = "cuda"):
        self.config = LLMConfig.from_dict(config_dict)
        self.engine = DecodeEngine(self.config, params=params, device=device)

    def prefill(self, prompt_ids, sampling: dict) -> dict:
        return self.engine.prefill_only(
            list(prompt_ids), SamplingParams(**sampling)
        )

    def health_check(self) -> bool:
        return True


class DecodeServer:
    """Decode pool replica: continues generation from transferred states."""

    def __init__(self, config_dict: dict, params=None,
                 device: DeviceLike = "cuda"):
        self.config = LLMConfig.from_dict(config_dict)
        self.engine = DecodeEngine(self.config, params=params, device=device)

    def decode(self, prefilled: dict, sampling: dict):
        return self.engine.submit_prefilled(
            prefilled, SamplingParams(**sampling)
        ).result(600)

    def health_check(self) -> bool:
        return True


class PDIngress:
    """OpenAI-surface ingress routing prompt->prefill pool->decode pool. It
    holds no engine (only the tokenizer), so it takes no device."""

    def __init__(self, config_dict: dict, prefill_handle, decode_handle):
        self.config = LLMConfig.from_dict(config_dict)
        self.tokenizer = load_tokenizer(self.config)
        self._prefill = prefill_handle
        self._decode = decode_handle

    def __call__(self, request: dict) -> dict:
        if "body" in request:  # HTTP proxy envelope
            try:
                payload = json.loads(request["body"] or b"{}")
            except json.JSONDecodeError:
                return {"error": {"message": "invalid JSON body"}}
        else:
            payload = request
        prompt = payload.get("prompt", "")
        sampling = dict(extract_sampling(payload, self.config).__dict__)
        ids = self.tokenizer.encode(prompt)
        if not ids:
            return {"error": {"message": "prompt must be non-empty"}}
        prefilled = self._prefill.prefill.remote(ids, sampling).result(600)
        out = self._decode.decode.remote(prefilled, sampling).result(600)
        text = self.tokenizer.decode(out)
        return completion_response(
            self.config, len(ids), out, text, disaggregated=True
        )

    def health_check(self) -> bool:
        return True
