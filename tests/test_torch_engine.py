"""The port's decode engine (ray_tpu_torch.llm.engine) against the JAX
package's (ray_tpu.llm.engine) and against its own full forward, on the
CPU, in f32, at the ``_SMALL`` size of tests/test_llm.py. Also: the port
imports no JAX, and its entry points refuse a missing card.

Greedy tokens must be identical: both engines run the same converted
weights, and f32 logits that agree to ~1e-6 pick the same argmax.
"""
import os
import pickle
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ray_tpu.llm import DecodeEngine as JaxEngine
from ray_tpu.llm import LLMConfig as JaxLLMConfig
from ray_tpu.llm import SamplingParams as JaxSamplingParams
from ray_tpu.models import gpt2 as jgpt2
from ray_tpu_torch.llm import DecodeEngine, LLMConfig, SamplingParams
from ray_tpu_torch.llm.programs import Program
from ray_tpu_torch.models import convert, module_for
from ray_tpu_torch.models import gpt2 as tgpt2

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SMALL = dict(
    vocab_size=128, max_seq_len=128, num_layers=2, num_heads=2,
    embed_dim=64, dtype="float32", max_batch_slots=4,
    prefill_buckets=(16, 32),
)

PROMPTS = [[5, 9, 17, 33, 2, 7], [3, 1, 4], [1, 5, 9, 2, 6, 5, 3, 5],
           [6, 5], list(range(2, 20))]


@pytest.fixture(scope="module")
def np_params():
    """The JAX init, with the block projections and wpe scaled x3: at the
    plain init greedy decoding only repeats the prompt's last token (the
    tied head sees mostly its own embedding), which a broken cache or a
    wrong batch row would reproduce just as well."""
    cfg = JaxLLMConfig(**_SMALL).model_config()
    tree = jax.tree.map(np.array, jgpt2.init_params(cfg, jax.random.PRNGKey(0)))
    for name in ("qkv_w", "proj_w", "fc_w", "out_w"):
        tree["blocks"][name] *= 3.0
    tree["wpe"] *= 3.0
    return tree


@pytest.fixture(scope="module")
def jax_params(np_params):
    return jax.tree.map(jnp.asarray, np_params)


def _engine(np_params, **over):
    config = LLMConfig(**{**_SMALL, **over})
    params = convert.params_from_numpy(np_params, config.model_config(), "cpu")
    return DecodeEngine(config, params=params, device="cpu")


def _run(eng, prompts, p):
    try:
        futs = [eng.submit(pr, p) for pr in prompts]
        return [list(f.result(120)) for f in futs]
    finally:
        eng.shutdown()


def test_greedy_tokens_match_jax_engine(jax_params, np_params):
    p = dict(max_new_tokens=10)
    jeng = JaxEngine(JaxLLMConfig(**_SMALL), params=jax_params)
    try:
        expect = [list(jeng.generate(pr, JaxSamplingParams(**p)))
                  for pr in PROMPTS]
    finally:
        jeng.shutdown()
    got = _run(_engine(np_params), PROMPTS, SamplingParams(**p))
    assert got == expect


def test_cached_decode_matches_full_forward(np_params):
    """Greedy tokens through the KV cache equal argmax over the full
    forward, re-run per step (tests/test_llm.py's yardstick)."""
    eng = _engine(np_params)
    prompt, n_new = PROMPTS[0], 12
    try:
        got = eng.generate(prompt, SamplingParams(max_new_tokens=n_new))
    finally:
        eng.shutdown()
    cfg, seq, expect = eng.model_config, list(prompt), []
    with torch.no_grad():
        for _ in range(n_new):
            logits, _ = tgpt2.forward(eng.params, torch.tensor([seq]), cfg)
            nxt = int(logits[0, -1].argmax())
            expect.append(nxt)
            if nxt == eng.tokenizer.eos_id:
                break
            seq.append(nxt)
    assert got == [t for t in expect if t != eng.tokenizer.eos_id][: len(got)]
    assert len(got) >= 1


def test_continuous_batching_matches_sequential(np_params):
    p = SamplingParams(max_new_tokens=8)
    batched = _run(_engine(np_params), PROMPTS, p)   # all in flight together
    eng = _engine(np_params, max_batch_slots=1)
    try:
        sequential = [list(eng.generate(pr, p)) for pr in PROMPTS]
    finally:
        eng.shutdown()
    assert batched == sequential


def test_prefix_cache_partial_hit_leaves_entry_unchanged(np_params):
    """The aliasing trap: a partial hit prefills from the cached entry's
    KV. The port's forward writes in place, so the engine must prefill
    into a clone: the output equals an uncached engine's AND the stored
    entry is bit-for-bit what it was."""
    base = list(range(2, 18))           # 16 tokens: fills bucket 16
    longer = base + [30, 31, 32, 33]
    p = SamplingParams(max_new_tokens=6)
    ref = _engine(np_params)
    try:
        expected = ref.generate(longer, p)
    finally:
        ref.shutdown()
    eng = _engine(np_params, prefix_cache_size=4)
    try:
        eng.generate(base, p)           # seeds the prefix cache
        entry = eng._prefix_cache[tuple(base)]
        snap = {k: v.clone() for k, v in entry["cache"].items()}
        out = eng.generate(longer, p)
        assert eng.stats["prefix_partial_hits"] == 1
        assert out == expected
        for k in ("k", "v"):
            assert torch.equal(entry["cache"][k], snap[k])
        again = eng.generate(base, p)   # exact hit on the untouched entry
        assert eng.stats["prefix_hits"] == 1
        assert again == _run(_engine(np_params), [base], p)[0]
    finally:
        eng.shutdown()


def test_speculative_ngram_matches_plain_greedy(np_params):
    prompts = [[5, 6, 7, 5, 6, 7, 5, 6], [9, 9, 9, 9], PROMPTS[2], PROMPTS[4]]
    p = SamplingParams(max_new_tokens=12)
    plain = _run(_engine(np_params), prompts, p)
    eng = _engine(np_params, speculative_ngram_k=3)
    spec = _run(eng, prompts, p)
    assert spec == plain
    assert eng.stats["spec_accepted"] > 0


def test_seeded_sampling_reproducible(np_params):
    p = SamplingParams(max_new_tokens=8, temperature=0.9, top_p=0.9, seed=7)
    a = _run(_engine(np_params), [PROMPTS[1]], p)
    b = _run(_engine(np_params), [PROMPTS[1]], p)
    assert a == b and len(a[0]) >= 1


def test_prefill_decode_split_matches_monolithic(np_params):
    """prefill_only hands over CPU tensors (numpy has no bf16), which
    survive pickling; submit_prefilled resumes from them."""
    prompt, p = [7, 3, 11, 19], SamplingParams(max_new_tokens=8)
    expect = _run(_engine(np_params), [prompt], p)[0]
    pre = _engine(np_params).prefill_only(prompt, p)
    assert all(t.device.type == "cpu" for t in pre["cache"].values())
    pre = pickle.loads(pickle.dumps(pre))
    got = _run_prefilled(_engine(np_params), pre, p)
    assert got == expect


def _run_prefilled(eng, pre, p):
    try:
        return list(eng.submit_prefilled(pre, p).result(120))
    finally:
        eng.shutdown()


def test_stream_and_model_source_bundle(np_params, tmp_path):
    """Streaming yields the generated tokens; a pickled bundle of numpy
    params (model_source) loads through params_from_numpy."""
    path = tmp_path / "bundle.pkl"
    cfg = LLMConfig(**_SMALL).model_config()
    with open(path, "wb") as f:
        pickle.dump({"family": "gpt2", "params": np_params, "config": dict(
            vocab_size=cfg.vocab_size, max_seq_len=cfg.max_seq_len,
            num_layers=cfg.num_layers, num_heads=cfg.num_heads,
            embed_dim=cfg.embed_dim, dtype="float32")}, f)
    eng = DecodeEngine(LLMConfig(**{**_SMALL, "model_source": str(path)}),
                       device="cpu")
    p = SamplingParams(max_new_tokens=6)
    try:
        streamed = list(eng.submit_stream(PROMPTS[0], p))
        whole = list(eng.generate(PROMPTS[0], p))
    finally:
        eng.shutdown()
    assert streamed == whole == _run(_engine(np_params), [PROMPTS[0]], p)[0]


def test_submit_does_not_wait_for_the_loop_lock(np_params):
    """A running loop holds the engine's lock for a whole tick and takes it
    again at once: submit() hands over without that lock, so a burst is
    queued while a tick runs and does not trickle in behind ticks."""
    p = SamplingParams(max_new_tokens=4)
    eng = _engine(np_params)
    futs = []
    try:
        eng.generate(PROMPTS[0], p)    # the loop is up, and stays up idle
        with eng._lock:                # as a tick in progress holds it
            th = threading.Thread(target=lambda: futs.extend(
                eng.submit(pr, p) for pr in PROMPTS), daemon=True)
            th.start()
            th.join(10)
            queued = not th.is_alive()
        assert queued, "submit() waited for the loop's lock"
        got = [list(f.result(120)) for f in futs]
    finally:
        eng.shutdown()
    assert got == _run(_engine(np_params), PROMPTS, p)


def test_prompt_too_long_rejected(np_params):
    eng = _engine(np_params)
    try:
        with pytest.raises(ValueError):
            eng.generate(list(range(2, 60)), SamplingParams(max_new_tokens=2))
    finally:
        eng.shutdown()


def test_static_slot_cache_aliasing_matches_jax(jax_params, np_params):
    """Every prefill runs in the engine's one static slot cache and its
    result is cloned out: prompt A, then B through the same slot cache,
    then an exact and a partial prefix-cache hit on A give the JAX
    engine's tokens, and A's stored entry is untouched by B."""
    a = [5, 9, 17, 33, 2, 7, 11, 13, 3, 4, 6, 8, 10, 12, 14, 15]   # bucket 16
    b = [40, 41, 42]
    prompts = [a, b, a, a + [20, 21, 22]]
    p = dict(max_new_tokens=6)
    jeng = JaxEngine(JaxLLMConfig(**_SMALL), params=jax_params)
    try:
        expect = [list(jeng.generate(pr, JaxSamplingParams(**p)))
                  for pr in prompts]
    finally:
        jeng.shutdown()
    eng = _engine(np_params, prefix_cache_size=4)
    try:
        got = [list(eng.generate(prompts[0], SamplingParams(**p)))]
        entry = eng._prefix_cache[tuple(a)]["cache"]
        snap = {k: v.clone() for k, v in entry.items()}
        got += [list(eng.generate(pr, SamplingParams(**p)))
                for pr in prompts[1:]]
        assert all(torch.equal(entry[k], snap[k]) for k in snap)
        assert all(entry[k].data_ptr() != eng._slot_cache[k].data_ptr()
                   for k in snap)
    finally:
        eng.shutdown()
    assert eng.stats["prefix_hits"] == 1
    assert eng.stats["prefix_partial_hits"] == 1
    assert got == expect


def test_program_outputs_survive_the_next_call(np_params):
    """A program returns copies: the first call's outputs (and a buffer it
    returns, such as the slot cache) keep their values through a second
    call. On the CPU nothing is captured."""
    prog = Program(lambda x, y: {"sum": x + y, "x": x},
                   {"x": torch.zeros(3), "y": torch.zeros(3)})
    first = prog(x=np.ones(3, np.float32), y=np.full(3, 2.0, np.float32))
    second = prog(x=torch.full((3,), 5.0), y=np.zeros(3, np.float32))
    assert torch.equal(first["sum"], torch.full((3,), 3.0))
    assert torch.equal(first["x"], torch.ones(3))
    assert torch.equal(second["sum"], torch.full((3,), 5.0))
    assert prog.graph is None and prog.replays == 0

    eng = _engine(np_params)
    prefill = eng._prefill[16]
    toks = np.zeros((1, 16), np.int64)
    start = np.zeros((1,), np.int64)
    toks[0, :4] = [5, 9, 17, 33]
    logits1, cache1 = prefill(tokens=toks, start=start)
    snap = {k: v.clone() for k, v in cache1.items()}
    toks[0, :4] = [40, 41, 42, 43]
    logits2, cache2 = prefill(tokens=toks, start=start)
    assert all(torch.equal(cache1[k], snap[k]) for k in snap)
    assert not torch.equal(cache1["k"], cache2["k"])
    assert not torch.equal(logits1, logits2)


_TINY = dict(vocab_size=128, max_seq_len=64, num_layers=2, num_heads=4,
             embed_dim=64, dtype="bfloat16", max_batch_slots=2,
             prefill_buckets=(16,))


@pytest.mark.parametrize("family", ["gpt2", "llama", "moe-llama"])
def test_precast_weights_give_bitwise_equal_bf16_logits(family):
    """The engine's run-time weights (matrices cast to bf16 once) give
    bf16 logits and caches torch.equal to forward_cached on the f32
    parameters, which casts at every use; norms and the router stay f32."""
    over = {"gpt2": {}, "llama": dict(model_family="llama", num_kv_heads=2),
            "moe-llama": dict(model_family="llama", num_kv_heads=2,
                              moe_num_experts=4)}[family]
    config = LLMConfig(**{**_TINY, **over})
    mod = module_for(config.model_config())
    g = torch.Generator().manual_seed(0)
    params = mod.init_params(config.model_config(), g, "cpu")
    with torch.no_grad():   # gains and biases off their exact 1s and 0s
        for w in params.parameters():
            w.add_(0.05 * torch.randn(w.shape, generator=g))
    eng = DecodeEngine(config, params=params, device="cpu")
    cfg = eng.model_config
    run = eng._run_params

    def leaves(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from leaves(v, prefix + k + ".")
            else:
                yield prefix + k, k, v

    used_in_f32 = {"ln1_g", "ln1_b", "ln2_g", "ln2_b", "ln_f_g", "ln_f_b",
                   "attn_norm", "mlp_norm", "norm_f", "router_w"}
    for path, name, leaf in leaves(run):
        want = torch.float32 if name in used_in_f32 else torch.bfloat16
        assert leaf.dtype == want, path
    assert ("router_w" in run["blocks"].get("moe", {})) == (family == "moe-llama")
    toks = torch.randint(2, 128, (2, 8), generator=g)
    caches = [mod.init_kv_cache(cfg, 2, 64, device="cpu") for _ in range(2)]
    with torch.no_grad():
        for tokens, start in ((toks, torch.tensor([0, 3])),
                              (toks[:, :1], torch.tensor([8, 11]))):
            la, _ = mod.forward_cached(run, tokens, caches[0], start, cfg)
            lb, _ = mod.forward_cached(eng.params, tokens, caches[1], start,
                                       cfg)
            assert la.dtype == torch.float32 and torch.equal(la, lb)
            assert all(torch.equal(caches[0][k], caches[1][k]) for k in "kv")


_PORT_MODULES = [
    "ray_tpu_torch", "ray_tpu_torch._private.backoff",
    "ray_tpu_torch._private.device", "ray_tpu_torch.ops.attention",
    "ray_tpu_torch.ops._build", "ray_tpu_torch.models",
    "ray_tpu_torch.models.gpt2", "ray_tpu_torch.models.convert",
    "ray_tpu_torch.llm", "ray_tpu_torch.llm.config",
    "ray_tpu_torch.llm.engine", "ray_tpu_torch.ops.xent",
    "ray_tpu_torch.train", "ray_tpu_torch.train.step",
    "ray_tpu_torch.models.llama", "ray_tpu_torch.models.common",
    "ray_tpu_torch.parallel", "ray_tpu_torch.parallel.moe",
    "ray_tpu_torch.llm.programs", "ray_tpu_torch.llm.serving",
    "ray_tpu_torch.llm.serving_patterns", "ray_tpu_torch.llm.batch",
    "ray_tpu_torch.parallel.mesh", "ray_tpu_torch.parallel.sharding",
    "ray_tpu_torch.parallel.ring_attention", "ray_tpu_torch.parallel.pipeline",
    "ray_tpu_torch.parallel.dryrun", "ray_tpu_torch.parallel._collectives",
    # the runtime core
    "ray_tpu_torch.exceptions", "ray_tpu_torch.object_ref",
    "ray_tpu_torch.remote_function", "ray_tpu_torch.actor",
    "ray_tpu_torch.runtime_context", "ray_tpu_torch._private.asyncio_util",
    "ray_tpu_torch._private.auth", "ray_tpu_torch._private.cgroups",
    "ray_tpu_torch._private.config", "ray_tpu_torch._private.devstore",
    "ray_tpu_torch._private.faultpoints", "ray_tpu_torch._private.flight",
    "ray_tpu_torch._private.gcs", "ray_tpu_torch._private.head_main",
    "ray_tpu_torch._private.ids", "ray_tpu_torch._private.log_monitor",
    "ray_tpu_torch._private.memory_monitor", "ray_tpu_torch._private.memtrack",
    "ray_tpu_torch._private.node", "ray_tpu_torch._private.object_store",
    "ray_tpu_torch._private.protocol", "ray_tpu_torch._private.ringconn",
    "ray_tpu_torch._private.serialization", "ray_tpu_torch._private.specframe",
    "ray_tpu_torch._private.spill", "ray_tpu_torch._private.taskpath",
    "ray_tpu_torch._private.usage_stats", "ray_tpu_torch._private.wal",
    "ray_tpu_torch._private.worker", "ray_tpu_torch._private.worker_main",
    "ray_tpu_torch._private.accelerators",
    "ray_tpu_torch._private.accelerators.accelerator",
    "ray_tpu_torch._private.accelerators.gpu", "ray_tpu_torch.native",
    "ray_tpu_torch.native.arena", "ray_tpu_torch.native.ring",
    "ray_tpu_torch.native.sched", "ray_tpu_torch.native.xfer",
    "ray_tpu_torch.util", "ray_tpu_torch.util.metrics",
    "ray_tpu_torch.util.events", "ray_tpu_torch.util.tracing",
    "ray_tpu_torch.util.tracing.tracing_helper",
    "ray_tpu_torch.util.scheduling_strategies",
    # the train layer
    "ray_tpu_torch.train.config", "ray_tpu_torch.train.checkpoint",
    "ray_tpu_torch.train.result", "ray_tpu_torch.train.context",
    "ray_tpu_torch.train.failure_policy", "ray_tpu_torch.train.scaling_policy",
    "ray_tpu_torch.train.collective", "ray_tpu_torch.train.worker_group",
    "ray_tpu_torch.train.controller", "ray_tpu_torch.train.trainer",
    "ray_tpu_torch.train.torch",
    # Serve and placement groups
    "ray_tpu_torch.util.placement_group", "ray_tpu_torch.serve",
    "ray_tpu_torch.serve.deployment", "ray_tpu_torch.serve.multiplex",
    "ray_tpu_torch.serve.replica", "ray_tpu_torch.serve.handle",
    "ray_tpu_torch.serve.controller", "ray_tpu_torch.serve.http_proxy",
    "ray_tpu_torch.serve.grpc_proxy", "ray_tpu_torch.serve.local_testing",
]


def test_port_imports_neither_jax_nor_ray_tpu():
    """In a fresh interpreter, importing the port and each of its modules
    loads no jax and no ray_tpu module."""
    code = (
        "import importlib, sys\n"
        f"for m in {_PORT_MODULES!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'ray_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {**os.environ, "PYTHONPATH": REPO}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_default_device_raises_without_cuda():
    """Entry points default to device='cuda' and refuse to run on the CPU
    unasked."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    config = LLMConfig(**_SMALL)
    with pytest.raises(RuntimeError, match="CUDA"):
        DecodeEngine(config)
    with pytest.raises(RuntimeError, match="CUDA"):
        tgpt2.init_params(config.model_config())
    with pytest.raises(RuntimeError, match="CUDA"):
        tgpt2.init_kv_cache(config.model_config(), 1, 16)
