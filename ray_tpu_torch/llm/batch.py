"""Batch LLM inference over a dataset.

Counterpart of ``ray_tpu/llm/batch.py`` (reference analog: ``ray.data.llm``
processors, ``python/ray/llm/_internal/batch/processor/``): a processor
that maps a dataset of prompts through an engine stage with
preprocess/postprocess hooks. The stage holds one decode engine per
process and feeds its continuous-batching queue the whole batch at once.
``Processor`` only calls ``dataset.map`` and ``dataset.map_batches``, so
any dataset with those two methods serves (the runtime's Data layer once
it is ported).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from ray_tpu_torch._private.device import DeviceLike
from ray_tpu_torch.llm.config import LLMConfig
from ray_tpu_torch.llm.engine import DecodeEngine, SamplingParams


class _EngineStage:
    """Callable applied via ``map_batches``; the engine is built lazily
    once per process, per config and device, and reused across batches."""

    _engine_cache: Dict[tuple, DecodeEngine] = {}

    def __init__(self, config_dict: dict, sampling: dict,
                 prompt_column: str, output_column: str,
                 device: DeviceLike = "cuda"):
        self.config_dict = config_dict
        self.sampling = sampling
        self.prompt_column = prompt_column
        self.output_column = output_column
        self.device = torch.device(device)

    def _engine(self) -> DecodeEngine:
        key = (repr(sorted(self.config_dict.items())), str(self.device))
        eng = self._engine_cache.get(key)
        if eng is None:
            eng = DecodeEngine(LLMConfig.from_dict(self.config_dict),
                               device=self.device)
            self._engine_cache[key] = eng
        return eng

    def __call__(self, batch: Dict[str, list]) -> Dict[str, list]:
        eng = self._engine()
        params = SamplingParams(**self.sampling)
        prompts = batch[self.prompt_column]
        # Submit ALL rows first so the engine's slots fill (continuous
        # batching across the whole data batch), then collect in order.
        futs = [
            eng.submit(eng.tokenizer.encode(str(p)), params) for p in prompts
        ]
        outs = [eng.tokenizer.decode(f.result(600)) for f in futs]
        return {**batch, self.output_column: outs}


class Processor:
    def __init__(self, config: LLMConfig, *,
                 preprocess: Optional[Callable] = None,
                 postprocess: Optional[Callable] = None,
                 sampling: Optional[SamplingParams] = None,
                 prompt_column: str = "prompt",
                 output_column: str = "generated_text",
                 batch_size: int = 64,
                 device: DeviceLike = "cuda"):
        self._config = config
        self._pre = preprocess
        self._post = postprocess
        self._sampling = sampling or SamplingParams()
        self._prompt_column = prompt_column
        self._output_column = output_column
        self._batch_size = batch_size
        self._device = str(device)

    def __call__(self, dataset):
        if self._pre is not None:
            dataset = dataset.map(self._pre)
        # Class-based map_batches: the engine stage runs on a stateful
        # actor pool, so the engine (and its captured programs) is built
        # once per actor and reused across every block (reference:
        # vllm_engine_stage on the actor-pool map operator).
        dataset = dataset.map_batches(
            _EngineStage,
            batch_size=self._batch_size,
            concurrency=1,
            fn_constructor_args=(
                self._config.to_dict(),
                dict(self._sampling.__dict__),
                self._prompt_column,
                self._output_column,
                self._device,
            ),
        )
        if self._post is not None:
            dataset = dataset.map(self._post)
        return dataset


def build_llm_processor(config: LLMConfig, **kwargs) -> Processor:
    """(reference: ``ray.data.llm.build_llm_processor``)"""
    return Processor(config, **kwargs)
