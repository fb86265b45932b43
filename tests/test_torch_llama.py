"""Parity of the port's Llama (ray_tpu_torch.models.llama) with the JAX
package's (ray_tpu.models.llama), on the CPU, in f32.

Two configurations: ``LLAMA_TINY`` (H=4 query heads over KV=2 kv heads)
and a GQA-4 variant (H=8 over KV=2, E=128, so D=16 as in the tiny one).
Both packages run the same weights, the JAX ``init_params`` tree
converted with ``params_from_numpy``, on numpy-seeded tokens. The JAX
flash kernel runs in interpret mode (``flash_interpret``), the port's
``flash_interpret``/``flash`` run its plain blockwise versions. Bounds:
the reference's own, 2e-5 for an f32 forward and 2e-4 for f32 gradients
(tests/test_attention.py). JAX feeds attention repeated K/V
(``_repeat_kv``); the port feeds the KV heads and the attention reads
kv head h // (H / KV) in place, so the parity also holds that mapping.
"""
import dataclasses
import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ray_tpu.llm import DecodeEngine as JaxEngine
from ray_tpu.llm import LLMConfig as JaxLLMConfig
from ray_tpu.llm import SamplingParams as JaxSamplingParams
from ray_tpu.models import llama as jllama
from ray_tpu.train import step as jstep
from ray_tpu_torch.llm import DecodeEngine, LLMConfig, SamplingParams
from ray_tpu_torch.models import convert
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.ops import attention as tattn
from ray_tpu_torch.parallel import moe as tmoe
from ray_tpu_torch.train import (
    OptimizerConfig,
    create_train_state,
    make_train_step,
)

TOL = dict(atol=2e-5, rtol=2e-5)
GRAD_TOL = dict(atol=2e-4, rtol=2e-4)

SHAPES = {
    "tiny": {},                                         # H=4, KV=2, E=64
    "gqa4": dict(num_heads=8, num_kv_heads=2, embed_dim=128),
}


def _configs(shape="tiny", impl="xla", remat=False, policy="dots"):
    over = dict(SHAPES[shape], attention_impl=impl, remat=remat,
                remat_policy=policy)
    jcfg = dataclasses.replace(jllama.LLAMA_TINY, dtype=jnp.float32, **over)
    tcfg = dataclasses.replace(tllama.LLAMA_TINY, dtype=torch.float32, **over)
    return jcfg, tcfg


@pytest.fixture(scope="module")
def np_trees():
    """JAX init of each shape as numpy arrays."""
    init = jax.jit(jllama.init_params, static_argnums=0)
    return {s: jax.tree.map(np.asarray, init(_configs(s)[0],
                                             jax.random.PRNGKey(0)))
            for s in SHAPES}


def _port(np_tree, tcfg):
    return convert.params_from_numpy(np_tree, tcfg, device="cpu")


def _tokens(B, T, V=512, seed=0):
    return np.random.RandomState(seed).randint(0, V, (B, T)).astype(np.int32)


def _named_grads(params, jax_grads):
    """(name, port grad, JAX grad) for every parameter of the module."""
    for name, p in params.named_parameters():
        g = jax_grads
        for part in name.split("."):
            g = g[part]
        yield name, p.grad, np.asarray(g)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("theta", [10000.0, 500000.0])
def test_rms_norm_and_rope_match_jax(dtype, theta):
    """Positions up to and past max_seq_len (128): RoPE has no table, so
    any position works. f32 at 2e-5. bf16: both sides cast cos/sin to bf16
    before the products and round each product and sum to bf16, so they
    agree to a bf16 rounding or two (1e-2 absolute and relative), and the
    result stays bf16."""
    r = np.random.RandomState(1)
    x = r.randn(2, 5, 3, 16).astype(np.float32)
    g = (1.0 + 0.1 * r.randn(16)).astype(np.float32)
    pos = np.array([[0, 1, 2, 3, 4], [123, 124, 126, 127, 200]], np.int32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    tol = TOL if dtype == "float32" else dict(atol=1e-2, rtol=1e-2)
    rope_j = jllama._rope(jnp.asarray(x, jdt), jnp.asarray(pos), theta)
    rope_t = tllama._rope(torch.from_numpy(x).to(tdt), torch.from_numpy(pos),
                          theta)
    norm_j = jllama._rms_norm(jnp.asarray(x, jdt), jnp.asarray(g), 1e-5)
    norm_t = tllama._rms_norm(torch.from_numpy(x).to(tdt), torch.from_numpy(g),
                              1e-5)
    for t, j in ((rope_t, rope_j), (norm_t, norm_j)):
        assert t.dtype == tdt
        np.testing.assert_allclose(t.float().numpy(),
                                   np.asarray(j.astype(jnp.float32)), **tol)


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("impl_j,impl_t", [
    ("xla", "xla"),
    ("flash_interpret", "flash_interpret"),   # blockwise version per layer
    ("flash_interpret", "flash"),             # the wrapper's CPU path
])
def test_forward_matches_jax(np_trees, shape, impl_j, impl_t):
    jcfg, _ = _configs(shape, impl_j)
    _, tcfg = _configs(shape, impl_t)
    params = _port(np_trees[shape], tcfg)
    toks = _tokens(2, 70)
    lj, _ = jax.jit(jllama.forward, static_argnums=2)(
        jax.tree.map(jnp.asarray, np_trees[shape]), jnp.asarray(toks), jcfg)
    with torch.no_grad():
        lt, aux = tllama.forward(params, torch.from_numpy(toks), tcfg)
    assert lt.dtype == torch.float32 and float(aux) == 0.0
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)


@pytest.mark.parametrize("shape", list(SHAPES))
def test_forward_cached_matches_jax(np_trees, shape):
    """Prefill at start 0, a decode step at ragged starts, then a 4-token
    chunk at starts near the end, where JAX clamps the cache write to
    start' = min(start, S - T) while RoPE and the mask keep the true
    positions: logits and the GQA caches [L, B, S, KV, D] after each."""
    jcfg, tcfg = _configs(shape)
    jp = jax.tree.map(jnp.asarray, np_trees[shape])
    params = _port(np_trees[shape], tcfg)
    B, S = 2, 64
    jc = jllama.init_kv_cache(jcfg, B, S)
    tc = tllama.init_kv_cache(tcfg, B, S, device="cpu")
    assert tuple(tc["k"].shape) == (2, B, S, tcfg.num_kv_heads, 16)
    steps = [(_tokens(B, 16, seed=1), [0, 0]), (_tokens(B, 1, seed=2), [16, 9]),
             (_tokens(B, 4, seed=3), [62, 17])]
    for toks, start in steps:
        start = np.array(start, np.int32)
        lj, jc = jax.jit(jllama.forward_cached, static_argnums=4)(
            jp, jnp.asarray(toks), jc, jnp.asarray(start), jcfg)
        with torch.no_grad():
            lt, tc = tllama.forward_cached(params, torch.from_numpy(toks), tc,
                                           torch.from_numpy(start), tcfg)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
        for name in ("k", "v"):
            np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]),
                                       **TOL)


def _batch(B=2, T=40, seed=0):
    r = np.random.RandomState(seed)
    return {"tokens": r.randint(0, 512, (B, T + 1)).astype(np.int32),
            "mask": (r.rand(B, T) < 0.7).astype(np.float32)}


@pytest.fixture(scope="module")
def jax_grads(np_trees):
    """JAX loss and gradients of each shape through the flash kernel in
    interpret mode (a remat policy changes what is recomputed, not the
    arithmetic)."""
    out = {}
    for shape in SHAPES:
        jcfg, _ = _configs(shape, "flash_interpret", remat=True)
        out[shape] = jax.jit(jax.value_and_grad(jllama.loss_fn),
                             static_argnums=2)(
            jax.tree.map(jnp.asarray, np_trees[shape]),
            jax.tree.map(jnp.asarray, _batch()), jcfg)
    return out


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("remat,policy", [(False, "dots"), (True, "dots"),
                                          (True, "full")])
def test_loss_fn_and_grads_match_jax(np_trees, jax_grads, shape, remat, policy):
    loss_j, grads_j = jax_grads[shape]
    _, tcfg = _configs(shape, "flash_interpret", remat, policy)
    params = _port(np_trees[shape], tcfg)
    loss_t = tllama.loss_fn(params, _batch(), tcfg)
    loss_t.backward()
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=2e-4)
    for name, gt, gj in _named_grads(params, grads_j):
        np.testing.assert_allclose(gt.numpy(), gj, err_msg=name, **GRAD_TOL)


@pytest.mark.parametrize("policy,per_layer", [("dots", 1), ("full", 2)])
def test_remat_policy_keeps_flash_forward(np_trees, monkeypatch, policy,
                                          per_layer):
    """JAX's llama policy: "full", else "dots". Under "dots" the flash
    forward with lse (K2 on the card) runs once per layer in a forward and
    backward, under "full" twice: the launches per step chip_smoke.py
    counts."""
    calls = []
    ref = tattn.flash_attention_ref

    def counted(*a, **kw):
        calls.append(kw.get("with_lse", False))
        return ref(*a, **kw)

    monkeypatch.setattr(tattn, "flash_attention_ref", counted)
    _, tcfg = _configs("gqa4", "flash", remat=True, policy=policy)
    tllama.loss_fn(_port(np_trees["gqa4"], tcfg), _batch(), tcfg).backward()
    assert calls == [True] * (per_layer * tcfg.num_layers)


def test_train_steps_match_jax(np_trees):
    """Three steps of make_train_step (GQA-4, flash, remat "dots") against
    JAX's from one init and batch: loss and grad_norm at 2e-4 relative."""
    oc = dict(learning_rate=1e-3, warmup_steps=1, total_steps=10)
    jcfg, _ = _configs("gqa4", "flash_interpret", remat=True)
    _, tcfg = _configs("gqa4", "flash", remat=True)
    jopt = jstep.OptimizerConfig(**oc).build()
    params = jax.tree.map(jnp.asarray, np_trees["gqa4"])
    jstate = {"params": params, "opt_state": jopt.init(params), "step": 0}
    jfn = jstep.make_train_step(jcfg, jopt, donate=False)
    opt = OptimizerConfig(**oc).build()
    state = create_train_state(tcfg, opt, params=_port(np_trees["gqa4"], tcfg))
    tfn = make_train_step(tcfg, opt)
    batch = _batch(seed=3)
    for _ in range(3):
        jstate, jm = jfn(jstate, jax.tree.map(jnp.asarray, batch))
        state, tm = tfn(state, batch)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=2e-4)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=2e-4)


_ENGINE = dict(model_family="llama", vocab_size=300, max_seq_len=128,
               num_layers=2, num_heads=4, num_kv_heads=2, embed_dim=64,
               dtype="float32", max_batch_slots=2, prefill_buckets=(16, 32))
PROMPTS = [[5, 9, 17, 33, 2, 7], [3, 1, 4], list(range(2, 20))]


@pytest.fixture(scope="module")
def engine_tree():
    """JAX init of the engine's llama, projections x3 so greedy decoding
    does not just repeat the prompt."""
    cfg = JaxLLMConfig(**_ENGINE).model_config()
    tree = jax.tree.map(np.array, jax.jit(jllama.init_params, static_argnums=0)(
        cfg, jax.random.PRNGKey(0)))
    for name in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
        tree["blocks"][name] *= 3.0
    return tree


def _run(eng, prompts, p):
    try:
        futs = [eng.submit(pr, p) for pr in prompts]
        return [list(f.result(120)) for f in futs]
    finally:
        eng.shutdown()


def test_engine_greedy_tokens_match_jax(engine_tree):
    """LLMConfig(model_family="llama") maps as JAX maps it (GQA, default
    rope_theta and mlp_dim), and the engine's greedy tokens over the GQA
    cache, with speculation and a prefix cache on, are JAX's."""
    p = dict(max_new_tokens=10)
    jeng = JaxEngine(JaxLLMConfig(**_ENGINE),
                     params=jax.tree.map(jnp.asarray, engine_tree))
    try:
        expect = [list(jeng.generate(pr, JaxSamplingParams(**p)))
                  for pr in PROMPTS]
    finally:
        jeng.shutdown()
    for over in ({}, {"speculative_ngram_k": 3, "prefix_cache_size": 4}):
        config = LLMConfig(**_ENGINE, **over)
        tcfg = config.model_config()
        assert isinstance(tcfg, tllama.LlamaConfig)
        assert (tcfg.num_kv_heads, tcfg.rope_theta, tcfg.hidden_dim,
                tcfg.attention_impl) == (2, 10000.0, 256, "xla")
        eng = DecodeEngine(config, params=_port(engine_tree, tcfg),
                           device="cpu")
        assert _run(eng, PROMPTS, SamplingParams(**p)) == expect


@pytest.mark.parametrize("moe", [False, True])
def test_llama_bundle_round_trip(engine_tree, tmp_path, moe):
    """A pickled {"family": "llama", "config", "params"} bundle of numpy
    leaves loads into the engine; the bundle's architecture (here 2 kv
    heads where the LLMConfig asks for none, i.e. 4) wins. A saved "moe"
    dict becomes the port's MoEConfig, which the engine routes dropless."""
    path = tmp_path / "llama.pkl"
    kw = dict(vocab_size=300, max_seq_len=128, num_layers=2, num_heads=4,
              num_kv_heads=2, embed_dim=64, dtype="float32")
    over, tree = {}, engine_tree
    expect_cfg = dataclasses.replace(tllama.LLAMA_TINY, vocab_size=300,
                                     dtype=torch.float32)
    if moe:
        over = dict(moe_num_experts=4)
        kw["moe"] = dict(num_experts=4, top_k=2, activation="swiglu")
        cfg = LLMConfig(**_ENGINE, **over).model_config()
        tree = _numpy_tree(tllama.init_params(
            cfg, torch.Generator().manual_seed(0), "cpu"))
        expect_cfg = dataclasses.replace(expect_cfg, moe=tmoe.MoEConfig(
            num_experts=4, top_k=2, activation="swiglu", dropless=True))
    with open(path, "wb") as f:
        pickle.dump({"family": "llama", "config": kw, "params": tree}, f)
    eng = DecodeEngine(LLMConfig(**{**_ENGINE, **over, "num_kv_heads": None,
                                    "model_source": str(path)}), device="cpu")
    assert eng.model_config == expect_cfg
    p = SamplingParams(max_new_tokens=6)
    got = _run(eng, PROMPTS[:1], p)
    direct = DecodeEngine(LLMConfig(**_ENGINE, **over), params=_port(
        tree, eng.model_config), device="cpu")
    assert got == _run(direct, PROMPTS[:1], p)


def _numpy_tree(module):
    """The module's parameters as the nested dict of numpy arrays a bundle
    holds."""
    tree = {}
    for name, p in module.named_parameters():
        *path, leaf = name.split(".")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = p.detach().numpy()
    return tree


def test_params_layout_counts_and_unported_options(np_trees):
    jcfg, tcfg = _configs("gqa4")
    params = _port(np_trees["gqa4"], tcfg)
    b = params["blocks"]
    assert tuple(b["wq"].shape) == (2, 128, 8, 16)
    assert tuple(b["wk"].shape) == (2, 128, 2, 16)
    assert tuple(params["lm_head"].shape) == (512, 128)   # untied
    assert tllama.count_params(params) == jllama.count_params(np_trees["gqa4"])
    assert tllama.flops_per_token(tcfg) == jllama.flops_per_token(jcfg)
    assert tllama.flops_per_token(tllama.LLAMA_1B) == jllama.flops_per_token(
        jllama.LLAMA_1B)
    for name, pj in jllama.PRESETS.items():
        pt = tllama.PRESETS[name]
        assert (pt.num_layers, pt.num_heads, pt.num_kv_heads, pt.embed_dim,
                pt.hidden_dim, pt.vocab_size, pt.rope_theta) == (
            pj.num_layers, pj.num_heads, pj.num_kv_heads, pj.embed_dim,
            pj.hidden_dim, pj.vocab_size, pj.rope_theta)
    fresh = tllama.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    assert tllama.count_params(fresh) == tllama.count_params(params)
    for name, ref in (("wq", 0.02), ("w_down", 0.02 / 2.0)):
        std = float(fresh["blocks"][name].detach().std())
        assert abs(std - ref) < 0.1 * ref, (name, std)
    tree = jax.tree.map(np.array, np_trees["gqa4"])
    del tree["blocks"]["w_up"]
    with pytest.raises(KeyError):
        convert.params_from_numpy(tree, tcfg, device="cpu")
    with pytest.raises(ValueError):
        convert.params_from_numpy(np_trees["tiny"], tcfg, device="cpu")
    # the parallel layer is ported: without a mesh, Ulysses attention and
    # the pipelined path (one stage) are the one-device model
    toks = torch.from_numpy(_batch()["tokens"][:, :-1]).long()
    uly = dataclasses.replace(tcfg, attention_impl="ulysses")
    with torch.no_grad():
        ref, _ = tllama.forward(params, toks, tcfg)
        out, _ = tllama.forward(params, toks, uly)
        piped, _ = tllama.forward_pipelined(params, toks, tcfg)
        loss = tllama.loss_fn(params, _batch(), tcfg)
        loss_piped = tllama.loss_fn(params, _batch(), tcfg,
                                    pipeline_microbatches=2)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(piped.numpy(), ref.numpy(), atol=2e-5,
                               rtol=2e-5)
    np.testing.assert_allclose(float(loss_piped), float(loss), rtol=1e-5)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tllama.init_params(tcfg)
