"""LLM serving patterns: data-parallel and prefill/decode disaggregation.

Counterpart of ``ray_tpu/llm/serving_patterns.py`` (reference analog:
``python/ray/llm/_internal/serve/serving_patterns/`` -
``data_parallel/dp_server.py:221``, N identical engine replicas behind the
router, and ``prefill_decode/builder.py:184``, separate prefill and decode
replica pools). ``PrefillServer`` and ``DecodeServer`` each hold one
engine; ``PDIngress`` routes a request through the two handles it is
given, calling ``handle.<method>.remote(...).result(timeout)`` on them, so
a Serve handle or an in-process stand-in serves. The transferred state is
a dict of CPU tensors (``DecodeEngine.prefill_only``) that rides the
object store between replicas."""
from __future__ import annotations

import json

from ray_tpu_torch._private.device import DeviceLike, resolve_device
from ray_tpu_torch.llm.config import LLMConfig, load_tokenizer
from ray_tpu_torch.llm.engine import SamplingParams
from ray_tpu_torch.llm.serving import (
    EngineServer,
    build_openai_app,
    completion_response,
    extract_sampling,
)


def build_dp_openai_app(config: LLMConfig, *, num_replicas: int = 2,
                        params=None, device: DeviceLike = "cuda"):
    """Data-parallel serving: N engine replicas, power-of-two routed
    (reference: dp_server.py)."""
    return build_openai_app(config, num_replicas=num_replicas, params=params,
                            device=device)


class PrefillServer(EngineServer):
    """Prefill pool replica: prompts in, transferable KV states out."""

    def prefill(self, prompt_ids, sampling: dict) -> dict:
        return self.engine.prefill_only(
            list(prompt_ids), SamplingParams(**sampling)
        )


class DecodeServer(EngineServer):
    """Decode pool replica: continues generation from transferred states."""

    def decode(self, prefilled: dict, sampling: dict):
        return self.engine.submit_prefilled(
            prefilled, SamplingParams(**sampling)
        ).result(600)


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


def build_pd_openai_app(config: LLMConfig, *, num_prefill: int = 1,
                        num_decode: int = 1, params=None,
                        device: DeviceLike = "cuda"):
    """Prefill/decode-disaggregated app for ``serve.run`` (reference:
    prefill_decode/builder.py:184). Weights must be shared: pass ``params``
    (or a config.model_source checkpoint) so both pools load identical
    models. The prefill and decode replicas build their engines on
    ``device`` and take ``config.deployment_config["ray_actor_options"]``
    (``{"num_gpus": 0.5}`` puts both on one card); the ingress holds no
    engine and takes neither."""
    from ray_tpu_torch import serve

    dev = str(resolve_device(device))
    actor_options = dict(
        config.deployment_config.get("ray_actor_options") or {})
    prefill_dep = serve.deployment(
        name="pd_prefill", num_replicas=num_prefill,
        max_ongoing_requests=config.max_batch_slots,
        ray_actor_options=actor_options,
    )(PrefillServer)
    decode_dep = serve.deployment(
        name="pd_decode", num_replicas=num_decode,
        max_ongoing_requests=config.max_batch_slots,
        ray_actor_options=actor_options,
    )(DecodeServer)
    ingress = serve.deployment(
        name="pd_ingress", max_ongoing_requests=64,
    )(PDIngress)
    cfg = config.to_dict()
    return ingress.bind(
        cfg,
        prefill_dep.bind(cfg, params, dev),
        decode_dep.bind(cfg, params, dev),
    )
