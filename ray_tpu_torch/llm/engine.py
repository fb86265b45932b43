"""Decode engine: slot-based continuous batching on static shapes.

Counterpart of ``ray_tpu/llm/engine.py``, in PyTorch:

- The KV cache is one static [L, B, S, H, D] pair of tensors (H: the kv
  heads for a GQA llama); every decode tick is one replay of the decode
  program over ALL slots, not a per-request loop.
- Prompts prefill at bucketed lengths into a batch=1 cache, then an insert
  copies it into the slot's row: requests join and leave the running batch
  without changing any shape (the "continuous" part).
- Sampling happens host-side on the [B, V] logits of the tick (greedy /
  temperature / top-k / top-p / min-p), copied as is from the JAX engine.

Where the JAX engine jits ``prefill``, ``decode`` and the speculative
``decode_all``, this one captures each as a CUDA graph when it is built
(``llm/programs.py``): one decode program, one prefill program per bucket
and, with speculation, one ``decode_all`` program. They run on a run-time
copy of the weights in which every matrix the forward casts to the
activation dtype at each use is cast once (same values); the norms' gains
and the MoE router stay f32, as the forward uses them. On the CPU the same
programs run eagerly on the same static buffers.

Where the JAX engine leans on immutable arrays, this one copies: the
forward writes K/V into its cache in place, so every prefill runs in one
static slot cache (zeroed, or loaded with a prefix-cache entry for a
partial hit) whose result is cloned out, and the batch cache is updated in
place by insert and decode (what JAX did by donation).
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ray_tpu_torch._private.backoff import Backoff
from ray_tpu_torch._private.device import DeviceLike, resolve_device
from ray_tpu_torch.llm.config import LLMConfig, load_tokenizer
from ray_tpu_torch.llm.programs import Program

# Leaves the forward casts to the activation dtype at every use (matrices,
# their biases, the embeddings and the head): the engine casts them once.
# Norm gains and biases and the MoE router are used in f32 and stay so.
_CAST_AT_USE = frozenset({
    "wte", "wpe", "lm_head",
    "qkv_w", "qkv_b", "proj_w", "proj_b", "fc_w", "fc_b", "out_w", "out_b",
    "wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
    "expert_fc", "expert_gate", "expert_out",
})


def precast_params(params, dtype: torch.dtype) -> Dict[str, Any]:
    """A nested dict of ``params``'s leaves (a model module or a dict,
    indexed as the forward indexes it) in which each leaf of
    ``_CAST_AT_USE`` is cast to ``dtype``; the rest share their storage.
    The forward's own casts of those leaves are then no-ops, so its
    results are unchanged."""
    if isinstance(params, (dict, torch.nn.ParameterDict)):
        items = list(params.items())
    else:
        items = [*params.named_parameters(recurse=False),
                 *params.named_children()]
    out = {}
    with torch.no_grad():
        for name, leaf in items:
            if not isinstance(leaf, torch.Tensor):
                out[name] = precast_params(leaf, dtype)
            elif name in _CAST_AT_USE:
                out[name] = leaf.detach().to(dtype)
            else:
                out[name] = leaf.detach()
    return out


@dataclass
class SamplingParams:
    """Per-request sampling controls (reference: vLLM SamplingParams —
    the engine_kwargs surface ray/llm passes through)."""

    max_new_tokens: int = 64
    temperature: float = 0.0   # 0 = greedy
    top_k: int = 0             # 0 = no top-k cut
    top_p: float = 1.0         # nucleus: smallest set with cumprob >= top_p
    min_p: float = 0.0         # keep tokens with prob >= min_p * max_prob
    repetition_penalty: float = 1.0   # HF-style, over prompt + generated
    presence_penalty: float = 0.0     # flat penalty on seen generated ids
    frequency_penalty: float = 0.0    # per-count penalty on generated ids
    logprobs: int = 0          # >0: return chosen + top-N logprobs/token
    seed: Optional[int] = None  # per-request determinism
    stop_token_ids: Sequence[int] = field(default_factory=tuple)
    stop: Sequence[str] = field(default_factory=tuple)  # string stops


class GenerationResult(list):
    """Generated token ids; quacks as the plain list older callers expect,
    with per-token logprob entries riding along when requested."""

    def __init__(self, token_ids, logprobs=None):
        super().__init__(token_ids)
        self.logprobs = logprobs or []


@dataclass
class _Slot:
    active: bool = False
    token_ids: List[int] = field(default_factory=list)
    prompt_len: int = 0
    produced: int = 0
    params: SamplingParams = field(default_factory=SamplingParams)
    future: Optional[Future] = None
    last_token: int = 0
    length: int = 0  # current absolute position (== tokens in cache)
    prompt_ids: List[int] = field(default_factory=list)  # penalties
    logprobs: List[dict] = field(default_factory=list)
    rng: Optional[Any] = None  # per-request RandomState when seed given
    stream_q: Optional[Any] = None  # queue.Queue for token streaming


class DecodeEngine:
    def __init__(self, config: LLMConfig, params=None, seed: int = 0,
                 device: DeviceLike = "cuda"):
        from ray_tpu_torch.models import convert, module_for

        self.device = resolve_device(device)
        self.config = config
        self.model_config = config.model_config()
        if params is None and config.model_source:
            import pickle

            with open(config.model_source, "rb") as f:
                bundle = pickle.load(f)
            if "config" in bundle:
                # checkpoint architecture wins over LLMConfig defaults: a
                # mismatch would allocate a KV cache with the wrong layout
                self.model_config = convert.config_from_kwargs(
                    bundle["config"],
                    bundle.get("family", self.config.model_family),
                )
            params = convert.params_from_numpy(
                bundle["params"], self.model_config, self.device
            )
        if getattr(self.model_config, "moe", None) is not None:
            # Inference routes dropless: capacity-queue drops depend on the
            # rest of the batch, so prefill and per-step decode would
            # disagree (and with the full forward) on dropped tokens.
            self.model_config = dataclasses.replace(
                self.model_config,
                moe=dataclasses.replace(self.model_config.moe, dropless=True),
            )
        model = module_for(self.model_config)
        self.tokenizer = load_tokenizer(config)
        if params is None:
            params = model.init_params(
                self.model_config, torch.Generator().manual_seed(seed),
                self.device,
            )
        self.params = params
        B, S = config.max_batch_slots, config.max_seq_len
        cfg = self.model_config
        dev = self.device
        run = self._run_params = precast_params(params, cfg.dtype)
        cache = self._cache = model.init_kv_cache(cfg, B, S, device=dev)
        slot_cache = self._slot_cache = model.init_kv_cache(
            cfg, 1, S, device=dev
        )
        self._rng = np.random.RandomState(seed)

        # Each program's inputs are static buffers; the caches are written
        # in place at fixed addresses. Warm-up and capture run at position
        # 0: decode's write lands at position 0 of batch rows that the next
        # insert overwrites whole, prefill's in the slot cache, which every
        # full prefill zeroes first.
        def prefill(tokens, start):
            # a new prompt at position 0: it attends to itself, causally,
            # through K1 on the card
            return model.forward_cached(run, tokens, slot_cache, start, cfg,
                                        fresh=True)

        def prefill_from(tokens, start):
            # start > 0 = continuation from a cached prefix: only the
            # prompt's tail runs through the model, attending the cache.
            return model.forward_cached(run, tokens, slot_cache, start, cfg)

        def decode(tokens, lens):
            logits, _ = model.forward_cached(run, tokens, cache, lens, cfg)
            return logits[:, -1]

        def decode_all(tokens, lens):
            # speculation verify: logits at EVERY position (position j's
            # row predicts the token after input j)
            return model.forward_cached(run, tokens, cache, lens, cfg)[0]

        def inputs(rows, width, pos_name):
            return {"tokens": torch.zeros((rows, width), dtype=torch.long,
                                          device=dev),
                    pos_name: torch.zeros((rows,), dtype=torch.long,
                                          device=dev)}

        self._spec_k = max(
            0, int(getattr(config, "speculative_ngram_k", 0) or 0)
        )  # negatives = disabled, never a half-armed dispatch path
        self._prefill = {
            b: Program(prefill, inputs(1, b, "start"))
            for b in config.prefill_buckets
        }
        # Only a partial prefix-cache hit continues a prompt past position
        # 0: its bucket's program is captured at the first such hit.
        self._prefill_from = {}
        self._new_prefill_from = lambda b: Program(
            prefill_from, inputs(1, b, "start"))
        self._decode = Program(decode, inputs(B, 1, "lens"))
        self._decode_spec = (
            Program(decode_all, inputs(B, 1 + self._spec_k, "lens"))
            if self._spec_k > 0 else None
        )

        self._slots = [_Slot() for _ in range(B)]
        self._pending: "queue.Queue" = queue.Queue()
        self._loop_thread: Optional[threading.Thread] = None
        self._stopped = False
        self._lock = threading.Lock()
        # Automatic prefix cache: prompt-token tuple -> {"cache": slot cache
        # (never written after it is stored: a partial hit prefills from a
        # copy of it in the static slot cache), "logits_row": final-position
        # logits for per-request sampling}. LRU-bounded; entries are whole
        # completed prefills.
        from collections import OrderedDict

        self._prefix_cache: "OrderedDict[tuple, dict]" = OrderedDict()
        self.stats = {
            "requests": 0, "tokens_generated": 0, "ticks": 0,
            "prefix_hits": 0, "prefix_partial_hits": 0,
            "spec_proposed": 0, "spec_accepted": 0,
        }

    @torch.no_grad()
    def _insert(self, slot_cache, b: int) -> None:
        """Copy a batch-1 cache into row ``b`` of the batch cache (two
        in-place copies: a program would replay the same two launches)."""
        for name, c in self._cache.items():
            c[:, b:b + 1].copy_(slot_cache[name])

    # ------------------------------------------------------------- sampling

    def _rng_for(self, p: SamplingParams):
        return (np.random.RandomState(p.seed) if p.seed is not None
                else self._rng)

    def _sample(self, logits_row: np.ndarray, p: SamplingParams,
                prompt_ids: Sequence[int] = (),
                generated: Sequence[int] = (), rng=None):
        """(next_token, logprob_entry|None). Penalties -> temperature ->
        logprobs snapshot -> top-k/top-p/min-p truncation -> draw (the
        reported distribution is pre-truncation, vLLM's convention)."""
        logits = logits_row.astype(np.float64, copy=True)
        if p.repetition_penalty != 1.0:
            union = set(prompt_ids) | set(generated)
            seen = np.fromiter(union, dtype=np.int64, count=len(union))
            if seen.size:
                vals = logits[seen]
                logits[seen] = np.where(
                    vals > 0, vals / p.repetition_penalty,
                    vals * p.repetition_penalty,
                )
        if (p.presence_penalty or p.frequency_penalty) and generated:
            ids, counts = np.unique(
                np.asarray(generated, np.int64), return_counts=True
            )
            logits[ids] -= (
                p.presence_penalty + p.frequency_penalty * counts
            )
        greedy = p.temperature <= 0
        if not greedy:
            logits = logits / max(p.temperature, 1e-5)
        lp_entry = None
        if p.logprobs > 0:
            shifted = logits - logits.max()
            logps = shifted - np.log(np.exp(shifted).sum())
            n = min(p.logprobs, logps.shape[0])
            top = np.argpartition(logps, -n)[-n:]
            top = top[np.argsort(logps[top])[::-1]]
            lp_entry = {
                "top": [(int(t), float(logps[t])) for t in top],
                "logps": logps,  # chosen-token logprob filled by caller
            }
        if greedy:
            nxt = int(np.argmax(logits))
        else:
            k = min(p.top_k, logits.shape[0])  # request-controlled: clamp
            if k > 0:
                kth = np.partition(logits, -k)[-k]
                logits = np.where(logits < kth, -np.inf, logits)
            shifted = logits - logits.max()
            probs = np.exp(shifted)
            probs /= probs.sum()
            if p.top_p < 1.0:
                order = np.argsort(probs)[::-1]
                cum = np.cumsum(probs[order])
                # smallest prefix reaching top_p (always keep the head)
                cut = int(np.searchsorted(cum, p.top_p)) + 1
                mask = np.zeros_like(probs, dtype=bool)
                mask[order[:cut]] = True
                probs = np.where(mask, probs, 0.0)
                probs /= probs.sum()
            if p.min_p > 0.0:
                keep = probs >= p.min_p * probs.max()
                probs = np.where(keep, probs, 0.0)
                probs /= probs.sum()
            nxt = int((rng or self._rng).choice(len(probs), p=probs))
        if lp_entry is not None:
            lp_entry = {
                "token": nxt,
                "logprob": float(lp_entry["logps"][nxt]),
                "top_logprobs": lp_entry["top"],
            }
        return nxt, lp_entry

    # ------------------------------------------------------------ lifecycle

    def _bucket(self, n: int) -> int:
        for b in self.config.prefill_buckets:
            if n <= b:
                return b
        raise ValueError(
            f"prompt length {n} exceeds largest prefill bucket "
            f"{max(self.config.prefill_buckets)}"
        )

    def _prefix_lookup_locked(self, prompt_ids):
        """(entry, matched_len): exact entry, the longest cached strict
        prefix, or (None, 0)."""
        key = tuple(prompt_ids)
        entry = self._prefix_cache.get(key)
        if entry is not None:
            self._prefix_cache.move_to_end(key)
            return entry, len(prompt_ids)
        best, best_len, best_key = None, 0, None
        for k, e in self._prefix_cache.items():
            n = len(k)
            if best_len < n < len(prompt_ids) and key[:n] == k:
                best, best_len, best_key = e, n, k
        if best_key is not None:
            # a hot shared prefix must stay resident under LRU pressure
            self._prefix_cache.move_to_end(best_key)
        return best, best_len

    def _prefix_store_locked(self, prompt_ids, cache1, logits_np, base):
        """Store the full prompt AND its bucket-boundary prefixes (system
        prompts shared by many requests match through these). All entries
        share the same cache tensors, which nothing writes once stored;
        ``logits_np`` rows cover absolute positions base..base+rows-1."""
        cap = self.config.prefix_cache_size
        if cap <= 0:
            return
        n = len(prompt_ids)
        lengths = {n}
        for b in self.config.prefill_buckets:
            if base < b < n:
                lengths.add(b)
        for ln in lengths:
            row_idx = ln - base - 1
            if not (0 <= row_idx < logits_np.shape[0]):
                continue
            key = tuple(prompt_ids[:ln])
            self._prefix_cache[key] = {
                "cache": cache1,
                # copy: a view would pin the whole [Tpad, vocab] buffer
                "logits_row": logits_np[row_idx].copy(),
            }
            self._prefix_cache.move_to_end(key)
        while len(self._prefix_cache) > cap:
            self._prefix_cache.popitem(last=False)

    def _prefill_locked(self, prompt_ids, params, rng=None):
        """(slot_cache dict of tensors, first_token, first_logprob). Caller
        holds the lock.
        Consults the prefix cache: an exact hit skips the model entirely; a
        strict-prefix hit prefills only the tail from the cached KV state."""
        n = len(prompt_ids)
        self._bucket(n)  # uniform length limit: acceptance must not depend
        # on transient prefix-cache residency
        entry, matched = (
            self._prefix_lookup_locked(prompt_ids)
            if self.config.prefix_cache_size > 0
            else (None, 0)
        )
        if entry is not None and matched == n:
            self.stats["prefix_hits"] += 1
            first, lp = self._sample(
                entry["logits_row"], params, prompt_ids, (), rng
            )
            return entry["cache"], first, lp
        if entry is not None and (
            matched + self._bucket(n - matched) > self.config.max_seq_len
        ):
            # the padded tail write would clamp (forward_cached keeps JAX's
            # clamped start) and corrupt valid prefix KV: full prefill
            entry, matched = None, 0
        if entry is not None:
            self.stats["prefix_partial_hits"] += 1
            base = matched
            rem = prompt_ids[matched:]
            Tpad = self._bucket(len(rem))
            toks = np.zeros((1, Tpad), np.int64)
            toks[0, : len(rem)] = rem
            prog = self._prefill_from.get(Tpad)
            if prog is None:   # its capture writes the slot cache: first
                prog = self._prefill_from[Tpad] = self._new_prefill_from(Tpad)
            # The entry's cache is shared by every entry of that prefill
            # (and may be in use by an exact hit): the program runs in the
            # static slot cache, loaded with a copy of it.
            with torch.no_grad():
                for k, v in self._slot_cache.items():
                    v.copy_(entry["cache"][k])
            logits, cache1 = prog(
                tokens=toks, start=np.full((1,), matched, np.int64)
            )
            logits_np = logits.cpu().numpy()[0]
            row = logits_np[len(rem) - 1]
        else:
            base = 0
            Tpad = self._bucket(n)
            toks = np.zeros((1, Tpad), np.int64)
            toks[0, :n] = prompt_ids
            # a fresh cache, as JAX's init_kv_cache is
            with torch.no_grad():
                for v in self._slot_cache.values():
                    v.zero_()
            logits, cache1 = self._prefill[Tpad](
                tokens=toks, start=np.zeros((1,), np.int64)
            )
            logits_np = logits.cpu().numpy()[0]
            row = logits_np[n - 1]
        self._prefix_store_locked(prompt_ids, cache1, logits_np, base)
        first, lp = self._sample(row, params, prompt_ids, (), rng)
        return cache1, first, lp

    def _activate_slot_locked(self, b, cache1, first, prompt_len, params,
                              fut, prompt_ids=(), first_lp=None, rng=None):
        self._insert(cache1, b)
        slot = self._slots[b]
        slot.active = True
        slot.token_ids = [first]
        slot.prompt_len = prompt_len
        slot.params = params
        slot.produced = 1
        slot.future = fut
        slot.last_token = first
        slot.length = prompt_len
        slot.prompt_ids = list(prompt_ids)
        slot.logprobs = [first_lp] if first_lp is not None else []
        slot.rng = rng
        slot.stream_q = getattr(fut, "_rt_stream_q", None)
        if slot.stream_q is not None:
            slot.stream_q.put(first)
        self.stats["requests"] += 1
        self._finish_if_done_locked(b)

    def _admit_locked(self):
        free = [i for i, s in enumerate(self._slots) if not s.active]
        while free and not self._pending.empty():
            try:
                item = self._pending.get_nowait()
            except queue.Empty:
                break
            b = free.pop(0)
            try:
                rng = None
                if item[0] == "prefilled":
                    # PD disaggregation: the prompt's KV was computed by a
                    # prefill server; insert its transferred cache directly.
                    _, prefilled, params, fut = item
                    cache1 = {
                        k: torch.as_tensor(v).to(self.device)
                        for k, v in prefilled["cache"].items()
                    }
                    first = int(prefilled["first_token"])
                    prompt_len = int(prefilled["prompt_len"])
                    prompt_ids = tuple(prefilled.get("prompt_ids", ()))
                    first_lp = prefilled.get("first_logprob")
                    if params.seed is not None:
                        rng = self._rng_for(params)
                        if params.temperature > 0:
                            # the prefill server consumed one draw from
                            # this seed sampling the first token; skip it
                            # or token 2 reuses token 1's random value
                            rng.random_sample()
                else:
                    _, prompt_ids, params, fut = item
                    if params.seed is not None:
                        rng = self._rng_for(params)
                    cache1, first, first_lp = self._prefill_locked(
                        prompt_ids, params, rng
                    )
                    prompt_len = len(prompt_ids)
                if prompt_len <= 0:
                    raise ValueError("prompt must be non-empty")
                self._activate_slot_locked(
                    b, cache1, first, prompt_len, params, fut,
                    prompt_ids=prompt_ids, first_lp=first_lp, rng=rng,
                )
            except Exception as e:
                # Admission failure (bad bucket, mismatched transferred
                # cache shapes, ...) surfaces on the caller's future, never
                # on other slots or the scheduler loop.
                fut.set_exception(e)
                free.insert(0, b)
                continue

    def _finish_if_done_locked(self, b: int):
        slot = self._slots[b]
        stop = set(slot.params.stop_token_ids) | {self.tokenizer.eos_id}
        out = None
        done = (
            slot.produced >= slot.params.max_new_tokens
            or slot.last_token in stop
            or slot.length + 1 >= self.config.max_seq_len
        )
        if slot.params.stop:
            # Runs even when another criterion already fired: the final
            # token can both complete a stop needle and hit max_new_tokens,
            # and the needle must still be trimmed. String stops match on
            # the DECODED text (a stop may span token boundaries);
            # O(len^2) worst case over a request, bounded by
            # max_new_tokens.
            text = self.tokenizer.decode(slot.token_ids)
            for needle in slot.params.stop:
                idx = text.find(needle)
                if idx >= 0:
                    # trim to the tokens whose decode stays before the stop
                    keep = len(slot.token_ids)
                    while keep > 0 and len(
                        self.tokenizer.decode(slot.token_ids[:keep])
                    ) > idx:
                        keep -= 1
                    out = slot.token_ids[:keep]
                    done = True
                    break
        if done:
            if out is None:
                out = slot.token_ids
                if out and out[-1] in stop:
                    out = out[:-1]
            if slot.stream_q is not None:
                slot.stream_q.put(("__done__", len(out)))
            if slot.future is not None:
                slot.future.set_result(GenerationResult(
                    out, slot.logprobs[: len(out)]
                ))
            slot.active = False
            slot.future = None

    def _tick_locked(self) -> bool:
        if self._spec_k:
            return self._tick_spec_locked()
        return self._tick_plain_locked()

    # ------------------------------------------- prompt-lookup speculation

    def _propose_draft(self, slot, k: int):
        """Prompt-lookup proposal (vLLM "[ngram]" speculator): find the
        most recent earlier occurrence of the current 2-gram (then 1-gram)
        in prompt+generated history and copy its continuation."""
        hist = slot.prompt_ids + slot.token_ids
        # bounded lookback (vLLM [ngram] caps this too): an O(full-history)
        # scan per token would serialize long-context decode on the host
        window = 512
        if len(hist) > window:
            hist = hist[-window:]
        L = len(hist)
        for n in (2, 1):
            if L <= n:
                continue
            pat = hist[-n:]
            for i in range(L - n - 1, -1, -1):
                if hist[i:i + n] == pat:
                    # i <= L-n-1 guarantees a non-empty continuation
                    return hist[i + n:i + n + k]
        return []

    def _tick_spec_locked(self) -> bool:
        """Speculative tick: verify up to k drafted tokens per GREEDY slot
        in ONE dispatch (accepted prefix + one corrected token all come
        from the same logits). Stochastic slots ride along with draft
        length 0. Cache safety: forward_cached writes K/V before
        attending and masks keys beyond each query position, and later
        writes overwrite rejected-draft positions — stale KV can never
        be attended."""
        active = [i for i, s in enumerate(self._slots) if s.active]
        if not active:
            return False
        K = self._spec_k
        S = self.config.max_seq_len
        if any(self._slots[i].length + 1 + K > S for i in active):
            # near the sequence end the [B, 1+K] write would CLAMP (as
            # JAX's dynamic_update_slice does) and overwrite valid KV:
            # plain ticks finish the tail
            return self._tick_plain_locked()
        drafts: Dict[int, list] = {}
        for i in active:
            slot = self._slots[i]
            if slot.params.temperature <= 0:
                d = self._propose_draft(slot, K)
                if d:
                    drafts[i] = d
                    self.stats["spec_proposed"] += len(d)
        if not drafts:
            # nothing to verify: the (1+K)-wide dispatch would pay ~K x
            # attention/logits cost for zero benefit
            return self._tick_plain_locked()
        B = len(self._slots)
        toks = np.zeros((B, 1 + K), np.int64)
        lens = np.zeros((B,), np.int64)
        for i in active:
            slot = self._slots[i]
            toks[i, :] = slot.last_token
            lens[i] = slot.length
            if i in drafts:
                d = drafts[i]
                toks[i, 1:1 + len(d)] = d
        logits = self._decode_spec(tokens=toks, lens=lens).cpu().numpy()
        for i in active:
            slot = self._slots[i]
            draft = drafts.get(i, [])
            for j in range(len(draft) + 1):
                nxt, lp = self._sample(
                    logits[i, j], slot.params, slot.prompt_ids,
                    slot.token_ids, slot.rng,
                )
                self._emit_token_locked(i, nxt, lp)
                if not slot.active:
                    break  # finished mid-run (stop/max/length)
                if j < len(draft):
                    if nxt != draft[j]:
                        break  # mismatch: later logits had wrong context
                    self.stats["spec_accepted"] += 1
        self.stats["ticks"] += 1
        return True

    def _emit_token_locked(self, i: int, nxt: int, lp) -> None:
        """Shared per-token bookkeeping for plain and speculative ticks."""
        slot = self._slots[i]
        slot.token_ids.append(nxt)
        if lp is not None:
            slot.logprobs.append(lp)
        if slot.stream_q is not None:
            slot.stream_q.put(nxt)
        slot.last_token = nxt
        slot.produced += 1
        slot.length += 1
        self.stats["tokens_generated"] += 1
        self._finish_if_done_locked(i)

    def _tick_plain_locked(self) -> bool:
        active = [i for i, s in enumerate(self._slots) if s.active]
        if not active:
            return False
        B = len(self._slots)
        toks = np.zeros((B, 1), np.int64)
        lens = np.zeros((B,), np.int64)
        for i in active:
            toks[i, 0] = self._slots[i].last_token
            lens[i] = self._slots[i].length
        # Inactive slots decode too, at position 0: their row's write lands
        # at position 0 of a row that the next insert overwrites whole.
        logits = self._decode(tokens=toks, lens=lens).cpu().numpy()
        for i in active:
            slot = self._slots[i]
            nxt, lp = self._sample(
                logits[i], slot.params, slot.prompt_ids, slot.token_ids,
                slot.rng,
            )
            self._emit_token_locked(i, nxt, lp)
        self.stats["ticks"] += 1
        return True

    # ------------------------------------------------------------- public

    def submit(self, prompt_ids: List[int],
               params: Optional[SamplingParams] = None) -> Future:
        """Continuous-batching entry: returns a Future of generated ids."""
        if not prompt_ids:
            raise ValueError("prompt must be non-empty")
        fut: Future = Future()
        self._pending.put(
            ("prompt", list(prompt_ids), params or SamplingParams(), fut)
        )
        self._ensure_loop()
        return fut

    def prefill_only(self, prompt_ids: List[int],
                     params: Optional[SamplingParams] = None) -> dict:
        """Prefill-server half of PD disaggregation (reference:
        ``serving_patterns/prefill_decode/builder.py``): compute the
        prompt's KV cache + first token WITHOUT occupying a decode slot.
        Returns a transferable dict a decode engine resumes from."""
        if not prompt_ids:
            raise ValueError("prompt must be non-empty")
        params = params or SamplingParams()
        with self._lock:
            cache1, first, lp = self._prefill_locked(
                list(prompt_ids), params, self._rng_for(params)
            )
            # CPU tensors, not numpy: numpy has no bfloat16.
            return {
                "cache": {k: v.cpu() for k, v in cache1.items()},
                "first_token": first,
                "prompt_len": len(prompt_ids),
                "first_logprob": lp,
                # penalties need the prompt on the DECODE side too
                "prompt_ids": list(prompt_ids),
            }

    def submit_prefilled(self, prefilled: dict,
                         params: Optional[SamplingParams] = None) -> Future:
        """Decode-server half of PD disaggregation: continue generation from
        a transferred prefill state."""
        fut: Future = Future()
        self._pending.put(
            ("prefilled", prefilled, params or SamplingParams(), fut)
        )
        self._ensure_loop()
        return fut

    def submit_stream(self, prompt_ids: List[int],
                      params: Optional[SamplingParams] = None):
        """Token-level streaming (reference: vLLM streaming generation /
        OpenAI stream=true). Yields generated token ids as the decode loop
        produces them; raises the request's error if admission fails.

        Stop-token trimming is reflected (the trimmed token is simply not
        yielded); string stops are NOT supported here — their trim point
        is only known at the end, so such requests must use submit()
        (the serving layer enforces this split)."""
        if params and params.stop:
            raise ValueError(
                "string stops are not streamable; use submit()"
            )
        import queue as _q

        fut: Future = Future()
        q: "_q.Queue" = _q.Queue()
        fut._rt_stream_q = q
        self._pending.put(
            ("prompt", list(prompt_ids), params or SamplingParams(), fut)
        )
        self._ensure_loop()

        def gen():
            while True:
                if fut.done() and fut.exception() is not None:
                    raise fut.exception()
                try:
                    item = q.get(timeout=1.0)
                except _q.Empty:
                    continue
                if isinstance(item, tuple) and item[0] == "__done__":
                    return
                # a stop TOKEN ends the request without being part of the
                # output; the done marker's kept-length already excludes
                # it, so check before yielding
                stop = set((params.stop_token_ids if params else ())
                           ) | {self.tokenizer.eos_id}
                if item in stop:
                    continue  # await the done marker
                yield item

        return gen()

    def generate(self, prompt_ids: List[int],
                 params: Optional[SamplingParams] = None) -> List[int]:
        """Synchronous single-request generation (batch path)."""
        return self.submit(prompt_ids, params).result(timeout=600)

    def generate_text(self, prompt: str,
                      params: Optional[SamplingParams] = None) -> str:
        ids = self.tokenizer.encode(prompt)
        out = self.generate(ids, params)
        return self.tokenizer.decode(out)

    def _ensure_loop(self):
        # Fast path, without the lock: the loop re-takes the lock as soon as
        # it drops it while work flows, so a submit() that waited for it
        # would trickle in behind whole ticks. A loop that parks re-checks
        # the queue after it lets go of the thread (see _loop).
        t = self._loop_thread
        if t is not None and t.is_alive():
            return
        with self._lock:
            if self._loop_thread is not None and self._loop_thread.is_alive():
                return
            self._stopped = False
            self._loop_thread = threading.Thread(
                target=self._loop, daemon=True, name="rt-llm-engine"
            )
            self._loop_thread.start()

    def _loop(self):
        idle_since = None
        # Jittered tick: 2ms while work flows (reset below), backing
        # off to 20ms when idle so the park check isn't a busy spin.
        tick = Backoff(base=0.002, cap=0.02)
        while not self._stopped:
            try:
                with self._lock:
                    self._admit_locked()
                    busy = self._tick_locked()
            except Exception as e:
                # Never die holding unresolved futures: fail every in-flight
                # request, clear the slots, keep serving.
                with self._lock:
                    for slot in self._slots:
                        if slot.active and slot.future is not None:
                            slot.future.set_exception(e)
                        slot.active = False
                        slot.future = None
                busy = False
            if busy or not self._pending.empty():
                idle_since = None
                tick.reset()
                continue
            if idle_since is None:
                idle_since = time.monotonic()
            elif time.monotonic() - idle_since > 30:
                # Park. _ensure_loop's fast path reads the thread without the
                # lock, so a submit() may queue after the first check and
                # still see this thread alive: re-check once the thread is
                # cleared, and take it back if anything came in.
                with self._lock:
                    if self._pending.empty():
                        self._loop_thread = None
                        if self._pending.empty():
                            return
                        self._loop_thread = threading.current_thread()
                idle_since = None
            tick.sleep()

    def shutdown(self):
        self._stopped = True
        t = self._loop_thread
        if t is not None:
            t.join(timeout=5)
