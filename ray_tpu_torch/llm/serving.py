"""OpenAI-compatible serving surface over the port's decode engine.

Counterpart of ``ray_tpu/llm/serving.py`` (reference analog: ``ray.serve.llm``
``LLMServer``, ``python/ray/llm/_internal/serve/``): the request mapping
(``extract_sampling``), the response envelopes and ``LLMServer`` with
/v1/completions, /v1/chat/completions, SSE streaming and logprobs, key for
key the reference's. ``LLMServer`` is plain Python over one
``DecodeEngine``; it can be called directly or deployed as a Serve
replica (``build_openai_app``, ``serve_llm``).
"""
from __future__ import annotations

import json
import time
import uuid
from typing import List

from ray_tpu_torch._private.device import DeviceLike, resolve_device
from ray_tpu_torch.llm.config import LLMConfig
from ray_tpu_torch.llm.engine import DecodeEngine, SamplingParams


def extract_sampling(payload: dict, config: LLMConfig) -> SamplingParams:
    """OpenAI request fields → SamplingParams (shared by every ingress)."""
    stop = payload.get("stop") or ()
    if isinstance(stop, str):
        stop = (stop,)
    return SamplingParams(
        max_new_tokens=int(
            payload.get("max_tokens", config.max_new_tokens_default)
        ),
        temperature=float(payload.get("temperature", 0.0)),
        top_k=int(payload.get("top_k", 0)),
        top_p=float(payload.get("top_p", 1.0)),
        min_p=float(payload.get("min_p", 0.0)),
        repetition_penalty=float(payload.get("repetition_penalty", 1.0)),
        presence_penalty=float(payload.get("presence_penalty", 0.0)),
        frequency_penalty=float(payload.get("frequency_penalty", 0.0)),
        logprobs=int(payload.get("logprobs") or 0),
        seed=(int(payload["seed"]) if payload.get("seed") is not None
              else None),
        stop=tuple(stop),
    )


def _logprobs_block(completion_ids) -> dict:
    """OpenAI-style logprobs payload from a GenerationResult (token ids
    stand in for token strings — the engine's ids ARE its vocabulary)."""
    entries = getattr(completion_ids, "logprobs", None) or []
    return {
        "tokens": [e["token"] for e in entries],
        "token_logprobs": [e["logprob"] for e in entries],
        "top_logprobs": [
            {str(t): lp for t, lp in e["top_logprobs"]} for e in entries
        ],
    }


def completion_response(config: LLMConfig, prompt_tokens: int,
                        completion_ids, text: str, **extra) -> dict:
    """OpenAI text_completion envelope (shared by every ingress)."""
    choice = {"index": 0, "text": text, "finish_reason": "stop"}
    if getattr(completion_ids, "logprobs", None):
        choice["logprobs"] = _logprobs_block(completion_ids)
    return {
        "id": f"cmpl-{uuid.uuid4().hex[:24]}",
        "object": "text_completion",
        "created": int(time.time()),
        "model": config.model_id,
        "choices": [choice],
        "usage": {
            "prompt_tokens": prompt_tokens,
            "completion_tokens": len(completion_ids),
            "total_tokens": prompt_tokens + len(completion_ids),
        },
        **extra,
    }


class EngineServer:
    """A Serve deployment target over one ``DecodeEngine`` on ``device``,
    which it shuts down when its replica stops."""

    def __init__(self, config_dict: dict, params=None,
                 device: DeviceLike = "cuda"):
        self.config = LLMConfig.from_dict(config_dict)
        self.engine = DecodeEngine(self.config, params=params, device=device)

    def __del__(self):
        # the replica's stop (Replica.prepare_for_shutdown) or garbage
        # collection: the engine's loop stops, and its weights, caches and
        # graphs go with it
        engine = self.__dict__.pop("engine", None)
        if engine is not None:
            engine.shutdown()

    def health_check(self) -> bool:
        return True


class LLMServer(EngineServer):
    """One engine replica behind the OpenAI surface; the Serve deployment
    target of ``build_openai_app``. ``device`` is the engine's."""

    # serve ingress entry: HTTP payloads from the proxy, or direct dicts
    # from DeploymentHandle calls.
    def __call__(self, request: dict) -> dict:
        if "body" in request:  # HTTP proxy envelope
            path = request.get("path", "")
            try:
                payload = json.loads(request["body"] or b"{}")
            except json.JSONDecodeError:
                return {"error": {"message": "invalid JSON body"}}
            if payload.get("stream") and not payload.get("stop"):
                # OpenAI stream=true -> generator of SSE lines (the serve
                # replica registers it; the HTTP proxy forwards as SSE).
                # String stops need the full output for trimming, so they
                # fall through to the non-streaming path.
                chat = path.endswith("/chat/completions") or (
                    "messages" in payload
                )
                return self.completions_stream(payload, chat=chat)
            if path.endswith("/chat/completions"):
                return self.chat_completions(payload)
            return self.completions(payload)
        if request.get("stream") and not request.get("stop"):
            return self.completions_stream(
                request, chat="messages" in request
            )
        if "messages" in request:
            return self.chat_completions(request)
        return self.completions(request)

    # ----------------------------------------------------------- endpoints

    def _sampling(self, payload: dict) -> SamplingParams:
        return extract_sampling(payload, self.config)

    def completions(self, payload: dict) -> dict:
        prompt = payload.get("prompt", "")
        ids = self.engine.tokenizer.encode(prompt)
        out = self.engine.submit(ids, self._sampling(payload)).result(600)
        text = self.engine.tokenizer.decode(out)
        return completion_response(self.config, len(ids), out, text)

    def chat_completions(self, payload: dict) -> dict:
        prompt = self._chat_prompt(payload.get("messages", []))
        ids = self.engine.tokenizer.encode(prompt)
        out = self.engine.submit(ids, self._sampling(payload)).result(600)
        text = self.engine.tokenizer.decode(out)
        choice = {
            "index": 0,
            "message": {"role": "assistant", "content": text},
            "finish_reason": "stop",
        }
        if getattr(out, "logprobs", None):
            choice["logprobs"] = _logprobs_block(out)
        return {
            "id": f"chatcmpl-{uuid.uuid4().hex[:24]}",
            "object": "chat.completion",
            "created": int(time.time()),
            "model": self.config.model_id,
            "choices": [choice],
            "usage": {
                "prompt_tokens": len(ids),
                "completion_tokens": len(out),
                "total_tokens": len(ids) + len(out),
            },
        }

    def _chat_prompt(self, messages) -> str:
        return "".join(
            f"<{m.get('role', 'user')}>{m.get('content', '')}\n"
            for m in messages
        ) + "<assistant>"

    def completions_stream(self, payload: dict, *, chat: bool = False):
        """Generator of OpenAI SSE chunk lines (stream=true). Deltas are
        detokenized incrementally; the final line is ``data: [DONE]``
        (reference: ray.llm / vLLM streaming responses)."""
        if chat:
            prompt = self._chat_prompt(payload.get("messages", []))
        else:
            prompt = payload.get("prompt", "")
        ids = self.engine.tokenizer.encode(prompt)
        rid = (f"chatcmpl-{uuid.uuid4().hex[:24]}" if chat
               else f"cmpl-{uuid.uuid4().hex[:24]}")
        created = int(time.time())
        obj = "chat.completion.chunk" if chat else "text_completion"
        produced: List[int] = []
        prev_text = ""
        for tok in self.engine.submit_stream(ids, self._sampling(payload)):
            produced.append(tok)
            text = self.engine.tokenizer.decode(produced)
            # Hold back trailing replacement chars: a partial multi-byte
            # sequence decodes to U+FFFD that the next byte will fix —
            # emitting it would bake the wrong char into the stream.
            emit = text.rstrip("\ufffd")
            delta, prev_text = emit[len(prev_text):], emit
            if not delta:
                continue  # partial multi-byte/merge: hold until decodable
            if chat:
                choice = {"index": 0, "delta": {"content": delta},
                          "finish_reason": None}
            else:
                choice = {"index": 0, "text": delta, "finish_reason": None}
            yield "data: " + json.dumps({
                "id": rid, "object": obj, "created": created,
                "model": self.config.model_id, "choices": [choice],
            }) + "\n\n"
        # flush anything held back (a genuinely invalid trailing byte in
        # the final output emits as U+FFFD here, matching non-streaming)
        tail = self.engine.tokenizer.decode(produced)[len(prev_text):]
        if tail:
            tc = ({"index": 0, "delta": {"content": tail},
                   "finish_reason": None} if chat else
                  {"index": 0, "text": tail, "finish_reason": None})
            yield "data: " + json.dumps({
                "id": rid, "object": obj, "created": created,
                "model": self.config.model_id, "choices": [tc],
            }) + "\n\n"
        final = ({"index": 0, "delta": {}, "finish_reason": "stop"}
                 if chat else
                 {"index": 0, "text": "", "finish_reason": "stop"})
        yield "data: " + json.dumps({
            "id": rid, "object": obj, "created": created,
            "model": self.config.model_id, "choices": [final],
        }) + "\n\n"
        yield "data: [DONE]\n\n"


def build_openai_app(config: LLMConfig, *, num_replicas: int = 1,
                     params=None, device: DeviceLike = "cuda"):
    """Application for ``serve.run(...)`` exposing the OpenAI surface at
    /v1 (reference: ``ray.serve.llm.build_openai_app``). Each replica
    builds its engine on ``device``; ``"cuda"`` raises here when CUDA is
    absent, and a replica that cannot reach the card fails to start, so
    nothing serves on the CPU unless it is asked for. A replica takes the
    card through ``config.deployment_config["ray_actor_options"]``
    (``{"num_gpus": 1}``)."""
    from ray_tpu_torch import serve

    dev = resolve_device(device)
    deployment = serve.deployment(
        num_replicas=num_replicas,
        max_ongoing_requests=config.max_batch_slots,
        **config.deployment_config,
    )(LLMServer)
    return deployment.bind(config.to_dict(), params, str(dev))


def serve_llm(config: LLMConfig, *, name: str = "llm", params=None,
              route_prefix: str = "/v1", device: DeviceLike = "cuda"):
    """Deploy ``build_openai_app(config)`` and return its handle."""
    from ray_tpu_torch import serve

    app = build_openai_app(config, params=params, device=device)
    return serve.run(app, name=name, route_prefix=route_prefix)
