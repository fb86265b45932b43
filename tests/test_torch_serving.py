"""The port's OpenAI surface (ray_tpu_torch.llm.serving, serving_patterns,
batch) against the JAX package's, on the CPU, in f32, with no cluster.

Both sides run the same converted weights (the JAX init with the block
projections x3, as tests/test_torch_engine.py), so greedy tokens are
identical and the responses must be equal key for key, apart from ``id``
and ``created``; logprob values agree within f32 rounding (1e-5). The
vocabulary (300) reaches past the byte range, so generations hold bytes
that decode to U+FFFD and ids that decode to nothing: the stream's
hold-back is exercised.
"""
import json
import pickle
from concurrent.futures import Future, ThreadPoolExecutor
from types import SimpleNamespace

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from ray_tpu.llm import LLMConfig as JaxLLMConfig
from ray_tpu.llm import LLMServer as JaxLLMServer
from ray_tpu.llm import batch as jbatch
from ray_tpu.llm import serving_patterns as jpatterns
from ray_tpu.models import gpt2 as jgpt2
from ray_tpu_torch.llm import LLMConfig, LLMServer, SamplingParams
from ray_tpu_torch.llm import batch as tbatch
from ray_tpu_torch.llm import serving_patterns as tpatterns
from ray_tpu_torch.llm.serving import extract_sampling
from ray_tpu_torch.models import convert

_SMALL = dict(
    vocab_size=300, max_seq_len=128, num_layers=2, num_heads=2,
    embed_dim=64, dtype="float32", max_batch_slots=4,
    prefill_buckets=(16, 32, 64),
)


@pytest.fixture(scope="module")
def np_params():
    cfg = JaxLLMConfig(**_SMALL).model_config()
    tree = jax.tree.map(np.array, jgpt2.init_params(cfg, jax.random.PRNGKey(0)))
    for name in ("qkv_w", "proj_w", "fc_w", "out_w"):
        tree["blocks"][name] *= 3.0
    tree["wpe"] *= 3.0
    return tree


def _torch_params(np_params):
    return convert.params_from_numpy(
        np_params, LLMConfig(**_SMALL).model_config(), "cpu")


@pytest.fixture(scope="module")
def servers(np_params):
    """(JAX LLMServer, port LLMServer) on the same weights."""
    jsrv = JaxLLMServer(dict(_SMALL), jax.tree.map(jnp.asarray, np_params))
    tsrv = LLMServer(dict(_SMALL), _torch_params(np_params), device="cpu")
    yield jsrv, tsrv
    jsrv.engine.shutdown()
    tsrv.engine.shutdown()


def _strip(resp: dict) -> dict:
    return {k: v for k, v in resp.items() if k not in ("id", "created")}


def _chunks(lines):
    """SSE lines -> (parsed chunks without id/created, final line)."""
    lines = list(lines)
    return [_strip(json.loads(l[len("data: "):])) for l in lines[:-1]], lines[-1]


def test_completions_and_chat_match_jax(servers):
    jsrv, tsrv = servers
    assert tsrv.engine.device.type == "cpu" and tsrv.health_check()
    for payload in ({"prompt": "Hello there", "max_tokens": 8},
                    {"prompt": "abc", "max_tokens": 5, "temperature": 0.8,
                     "top_k": 20, "seed": 3}):
        j, t = jsrv.completions(payload), tsrv.completions(payload)
        assert t["id"].startswith("cmpl-") and isinstance(t["created"], int)
        assert _strip(t) == _strip(j)
        assert t["usage"]["completion_tokens"] >= 1
    chat = {"messages": [{"role": "system", "content": "Be short."},
                         {"role": "user", "content": "Hi"}],
            "max_tokens": 6}
    assert tsrv._chat_prompt(chat["messages"]) == jsrv._chat_prompt(
        chat["messages"])
    j, t = jsrv.chat_completions(chat), tsrv.chat_completions(chat)
    assert t["id"].startswith("chatcmpl-")
    assert _strip(t) == _strip(j)
    assert t["object"] == "chat.completion"


def test_stream_deltas_join_to_the_text_and_match_jax(servers):
    jsrv, tsrv = servers
    payload = {"prompt": "Stream me", "max_tokens": 10}
    text = tsrv.completions(payload)["choices"][0]["text"]
    chunks, last = _chunks(tsrv.completions_stream(payload))
    jchunks, jlast = _chunks(jsrv.completions_stream(payload))
    assert last == jlast == "data: [DONE]\n\n"
    assert chunks == jchunks
    assert "".join(c["choices"][0]["text"] for c in chunks) == text
    assert chunks[-1]["choices"][0]["finish_reason"] == "stop"
    chat = {"messages": [{"role": "user", "content": "Hey"}], "max_tokens": 8}
    chunks, _ = _chunks(tsrv.completions_stream(chat, chat=True))
    jchunks, _ = _chunks(jsrv.completions_stream(chat, chat=True))
    assert chunks == jchunks
    assert "".join(c["choices"][0]["delta"].get("content", "")
                   for c in chunks) == \
        tsrv.chat_completions(chat)["choices"][0]["message"]["content"]


def test_logprobs_block_matches_jax(servers):
    jsrv, tsrv = servers
    payload = {"prompt": "hi", "max_tokens": 6, "logprobs": 3}
    j, t = jsrv.completions(payload), tsrv.completions(payload)
    lp, jlp = t["choices"][0]["logprobs"], j["choices"][0]["logprobs"]
    n = t["usage"]["completion_tokens"]
    assert lp["tokens"] == jlp["tokens"] and len(lp["tokens"]) == n
    np.testing.assert_allclose(lp["token_logprobs"], jlp["token_logprobs"],
                               atol=1e-5, rtol=1e-5)
    assert all(v <= 0 for v in lp["token_logprobs"])
    assert [list(d) for d in lp["top_logprobs"]] == \
        [list(d) for d in jlp["top_logprobs"]]
    assert all(len(d) == 3 for d in lp["top_logprobs"])
    for d, jd in zip(lp["top_logprobs"], jlp["top_logprobs"]):
        np.testing.assert_allclose(list(d.values()), list(jd.values()),
                                   atol=1e-5, rtol=1e-5)
    a, b = _strip(t), _strip(j)
    for r in (a, b):
        del r["choices"][0]["logprobs"]
    assert a == b


def test_http_envelope_routing_matches_jax(servers):
    jsrv, tsrv = servers
    for request in (
            {"body": json.dumps({"prompt": "ab", "max_tokens": 4}).encode(),
             "path": "/v1/completions"},
            {"body": json.dumps({"messages": [{"role": "user", "content": "x"}],
                                 "max_tokens": 4}),
             "path": "/v1/chat/completions"},
            # stream with string stops: no SSE, the plain completion
            {"body": json.dumps({"prompt": "ab", "max_tokens": 4,
                                 "stream": True, "stop": ["zz"]}),
             "path": "/v1/completions"},
            {"messages": [{"role": "user", "content": "direct"}],
             "max_tokens": 3},
            {"prompt": "direct", "max_tokens": 3}):
        assert _strip(tsrv(request)) == _strip(jsrv(request))
    bad = {"body": b"{not json", "path": "/v1/completions"}
    assert tsrv(bad) == jsrv(bad) == {"error": {"message": "invalid JSON body"}}
    empty = {"body": b"", "path": "/v1/completions"}     # body "" -> {}
    for srv in (tsrv, jsrv):          # an empty prompt: the engine refuses
        with pytest.raises(ValueError, match="non-empty"):
            srv(empty)
    streamed = {"body": json.dumps({"prompt": "ab", "max_tokens": 4,
                                    "stream": True}),
                "path": "/v1/chat/completions"}
    assert _chunks(tsrv(streamed)) == _chunks(jsrv(streamed))
    assert _chunks(tsrv({"prompt": "ab", "max_tokens": 4, "stream": True})) \
        == _chunks(jsrv({"prompt": "ab", "max_tokens": 4, "stream": True}))


def test_extract_sampling_maps_openai_fields():
    cfg = LLMConfig(**_SMALL)
    p = extract_sampling({"max_tokens": 7, "temperature": 0.5, "top_k": 4,
                          "top_p": 0.9, "min_p": 0.1, "logprobs": None,
                          "seed": 5, "stop": "END",
                          "repetition_penalty": 1.1}, cfg)
    assert p == SamplingParams(max_new_tokens=7, temperature=0.5, top_k=4,
                               top_p=0.9, min_p=0.1, seed=5, stop=("END",),
                               repetition_penalty=1.1)
    assert extract_sampling({}, cfg).max_new_tokens == cfg.max_new_tokens_default


def _handle(target):
    """In-process stand-in for a deployment handle:
    ``handle.method.remote(*args).result(timeout)``."""
    def method(name):
        def remote(*args, **kwargs):
            fut = Future()
            fut.set_result(getattr(target, name)(*args, **kwargs))
            return fut
        return SimpleNamespace(remote=remote)
    return SimpleNamespace(prefill=method("prefill"), decode=method("decode"))


def test_pd_ingress_matches_jax_and_the_monolithic_engine(np_params, servers):
    _, tsrv = servers
    jp = jax.tree.map(jnp.asarray, np_params)
    jpre = jpatterns.PrefillServer(dict(_SMALL), jp)
    jdec = jpatterns.DecodeServer(dict(_SMALL), jp)
    tpre = tpatterns.PrefillServer(dict(_SMALL), _torch_params(np_params),
                                   device="cpu")
    tdec = tpatterns.DecodeServer(dict(_SMALL), _torch_params(np_params),
                                  device="cpu")
    try:
        jing = jpatterns.PDIngress(dict(_SMALL), _handle(jpre), _handle(jdec))
        ting = tpatterns.PDIngress(dict(_SMALL), _handle(tpre), _handle(tdec))
        assert ting.health_check() and tpre.health_check() and tdec.health_check()
        seeded = {"prompt": "Split me", "max_tokens": 8, "temperature": 0.7,
                  "seed": 11}
        for request in (seeded, {"prompt": "greedy", "max_tokens": 6},
                        {"body": json.dumps(seeded)}):
            t = ting(request)
            assert t["disaggregated"] is True
            assert _strip(t) == _strip(jing(request))
        mono = tsrv.completions(seeded)
        split = ting(seeded)
        assert split["choices"] == mono["choices"]
        assert split["usage"] == mono["usage"]
        assert ting({"prompt": ""}) == jing({"prompt": ""}) == \
            {"error": {"message": "prompt must be non-empty"}}
        assert ting({"body": b"{"}) == {"error": {"message": "invalid JSON body"}}
    finally:
        for s in (jpre, jdec, tpre, tdec):
            s.engine.shutdown()


class _RecordingDataset:
    """A dataset with the two methods ``Processor`` calls, applied in
    process; every call is recorded."""

    def __init__(self, rows, calls=None):
        self.rows = rows
        self.calls = [] if calls is None else calls

    def map(self, fn):
        self.calls.append(("map", fn))
        return _RecordingDataset([fn(r) for r in self.rows], self.calls)

    def map_batches(self, cls, *, batch_size, concurrency,
                    fn_constructor_args):
        self.calls.append(("map_batches", cls, batch_size, concurrency,
                           fn_constructor_args))
        stage = cls(*fn_constructor_args)
        out = []
        for i in range(0, len(self.rows), batch_size):
            chunk = self.rows[i:i + batch_size]
            res = stage({k: [r[k] for r in chunk] for k in chunk[0]})
            out += [dict(zip(res, vals)) for vals in zip(*res.values())]
        return _RecordingDataset(out, self.calls)


@pytest.fixture
def bundle_config(np_params, tmp_path):
    """An LLM config whose weights load from a pickled numpy bundle, so the
    JAX and port stages build their engines on the same weights; the
    engines they cache are shut down and dropped afterwards."""
    path = tmp_path / "bundle.pkl"
    with open(path, "wb") as f:
        pickle.dump({"family": "gpt2", "params": np_params}, f)
    before = (set(jbatch._EngineStage._engine_cache),
              set(tbatch._EngineStage._engine_cache))
    yield {**_SMALL, "model_source": str(path)}
    for cache, seen in zip((jbatch._EngineStage._engine_cache,
                            tbatch._EngineStage._engine_cache), before):
        for key in set(cache) - seen:
            cache.pop(key).shutdown()


_PROMPTS = ["one", "two words", "three little words", "Ünïcode", "5", "six"]


def test_engine_stage_matches_jax(bundle_config):
    sampling = dict(SamplingParams(max_new_tokens=6).__dict__)
    batch = {"prompt": _PROMPTS, "id": list(range(len(_PROMPTS)))}
    j = jbatch._EngineStage(bundle_config, sampling, "prompt", "out")(batch)
    stage = tbatch._EngineStage(bundle_config, sampling, "prompt", "out",
                                device="cpu")
    t = stage(batch)
    assert t == j and t["id"] == batch["id"] and len(t["out"]) == len(_PROMPTS)
    # one engine per config and device, reused across batches
    eng = stage._engine()
    assert tbatch._EngineStage(bundle_config, sampling, "prompt", "out",
                               device="cpu")._engine() is eng
    assert eng.device.type == "cpu"


def test_processor_over_a_recording_dataset_matches_jax(bundle_config):
    rows = [{"q": p} for p in _PROMPTS]

    def pre(r):
        return {"prompt": "Q: " + r["q"]}

    def post(r):
        return {"prompt": r["prompt"], "answer": r["generated_text"]}

    sp = dict(sampling=SamplingParams(max_new_tokens=5), batch_size=4,
              preprocess=pre, postprocess=post)
    jds = _RecordingDataset(rows)
    jout = jbatch.build_llm_processor(JaxLLMConfig(**bundle_config),
                                      **sp)(jds)
    tds = _RecordingDataset(rows)
    tout = tbatch.build_llm_processor(LLMConfig(**bundle_config),
                                      device="cpu", **sp)(tds)
    assert tout.rows == jout.rows and len(tout.rows) == len(rows)
    assert [c[0] for c in tds.calls] == ["map", "map_batches", "map"]
    _, cls, batch_size, concurrency, args = tds.calls[1]
    assert cls is tbatch._EngineStage and (batch_size, concurrency) == (4, 1)
    assert args[:4] == jds.calls[1][4] and args[4] == "cpu"


def test_concurrent_completions_are_independent(servers):
    """Requests in flight together share the engine's slots; each answer
    equals the same request made alone."""
    _, tsrv = servers
    payloads = [{"prompt": p, "max_tokens": 5} for p in _PROMPTS]
    alone = [tsrv.completions(p)["choices"] for p in payloads]
    with ThreadPoolExecutor(len(payloads)) as pool:
        together = [r["choices"] for r in pool.map(tsrv.completions, payloads)]
    assert together == alone
