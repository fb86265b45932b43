"""Parity of the port's GPT-2 (ray_tpu_torch.models.gpt2) with the JAX
package's (ray_tpu.models.gpt2), on the CPU, in f32.

Both run the same weights: the JAX ``init_params`` tree, converted with
``params_from_numpy``. Bound: 2e-5 on the logits, the reference's f32
forward tolerance; the logits here are O(0.1-1), so the bound is also
about 2e-5 relative.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ray_tpu.models import gpt2 as jgpt2
from ray_tpu_torch.models import convert, get_preset, module_for
from ray_tpu_torch.models import gpt2 as tgpt2

TOL = dict(atol=2e-5, rtol=2e-5)


def _configs(impl_j="xla", impl_t="xla"):
    jcfg = dataclasses.replace(jgpt2.GPT2_TINY, dtype=jnp.float32,
                               attention_impl=impl_j, remat=False)
    tcfg = dataclasses.replace(tgpt2.GPT2_TINY, dtype=torch.float32,
                               attention_impl=impl_t)
    return jcfg, tcfg


@pytest.fixture(scope="module")
def jax_params():
    jcfg, _ = _configs()
    return jgpt2.init_params(jcfg, jax.random.PRNGKey(0))


def _port_params(jax_params, tcfg):
    tree = jax.tree.map(np.asarray, jax_params)
    return convert.params_from_numpy(tree, tcfg, device="cpu")


def _tokens(B, T, V, seed=0):
    return np.random.RandomState(seed).randint(0, V, size=(B, T)).astype(np.int32)


@pytest.mark.parametrize("impl_j,impl_t", [
    ("xla", "xla"),
    ("flash_interpret", "flash_interpret"),   # blockwise version per layer
    ("flash_interpret", "flash"),             # the wrapper's CPU path
])
def test_forward_matches_jax(jax_params, impl_j, impl_t):
    jcfg, tcfg = _configs(impl_j, impl_t)
    params = _port_params(jax_params, tcfg)
    toks = _tokens(2, 100, jcfg.vocab_size)
    lj, _ = jgpt2.forward(jax_params, jnp.asarray(toks), jcfg)
    with torch.no_grad():
        lt, aux = tgpt2.forward(params, torch.from_numpy(toks), tcfg)
    assert lt.dtype == torch.float32 and float(aux) == 0.0
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)


def test_forward_cached_matches_jax(jax_params):
    """Prefill (start 0) then one decode step per row at ragged starts,
    logits and caches both."""
    jcfg, tcfg = _configs()
    params = _port_params(jax_params, tcfg)
    B, S = 2, 64
    jc = jgpt2.init_kv_cache(jcfg, B, S)
    tc = tgpt2.init_kv_cache(tcfg, B, S, device="cpu")
    prompt = _tokens(B, 16, jcfg.vocab_size, seed=1)
    step = _tokens(B, 1, jcfg.vocab_size, seed=2)
    lj, jc = jgpt2.forward_cached(jax_params, jnp.asarray(prompt), jc,
                                  jnp.zeros((B,), jnp.int32), jcfg)
    with torch.no_grad():
        lt, tc = tgpt2.forward_cached(params, torch.from_numpy(prompt), tc,
                                      torch.zeros(B, dtype=torch.long), tcfg)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    start = np.array([16, 9], np.int32)
    lj, jc = jgpt2.forward_cached(jax_params, jnp.asarray(step), jc,
                                  jnp.asarray(start), jcfg)
    with torch.no_grad():
        lt, tc = tgpt2.forward_cached(params, torch.from_numpy(step), tc,
                                      torch.from_numpy(start), tcfg)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]), **TOL)


def test_forward_cached_clamps_like_jax(jax_params):
    """Starts near the end: JAX clamps the cache write to start' =
    min(start, S - T) and the wpe gather to its last row, while the mask
    uses the true positions. The port reproduces all three."""
    jcfg, tcfg = _configs()
    params = _port_params(jax_params, tcfg)
    S = jcfg.max_seq_len            # 128: positions past it clamp in wpe
    toks = _tokens(2, 4, jcfg.vocab_size, seed=3)
    start = np.array([126, 30], np.int32)
    jc = jgpt2.init_kv_cache(jcfg, 2, S)
    tc = tgpt2.init_kv_cache(tcfg, 2, S, device="cpu")
    fill = np.random.RandomState(4).randn(*tc["k"].shape).astype(np.float32)
    jc = {"k": jnp.asarray(fill), "v": jnp.asarray(-fill)}
    tc = {"k": torch.from_numpy(fill.copy()), "v": torch.from_numpy(-fill)}
    lj, jc = jgpt2.forward_cached(jax_params, jnp.asarray(toks), jc,
                                  jnp.asarray(start), jcfg)
    with torch.no_grad():
        lt, tc = tgpt2.forward_cached(params, torch.from_numpy(toks), tc,
                                      torch.from_numpy(start), tcfg)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]), **TOL)


def test_forward_cached_writes_in_place(jax_params):
    """Documented divergence from JAX: the cache dict comes back as the
    same tensors, written in place (callers that must keep a cache clone
    it first)."""
    _, tcfg = _configs()
    params = _port_params(jax_params, tcfg)
    cache = tgpt2.init_kv_cache(tcfg, 1, 32, device="cpu")
    k_before = cache["k"]
    with torch.no_grad():
        _, out = tgpt2.forward_cached(params, torch.tensor([[3, 4, 5]]), cache,
                                      torch.zeros(1, dtype=torch.long), tcfg)
    assert out["k"] is k_before
    assert k_before[:, 0, :3].abs().sum() > 0
    assert k_before[:, 0, 3:].abs().sum() == 0


def test_params_layout_and_counts_match_jax(jax_params):
    jcfg, tcfg = _configs()
    params = _port_params(jax_params, tcfg)
    assert tuple(params["blocks"]["qkv_w"].shape) == (2, 64, 3, 2, 32)
    assert tuple(params["blocks"]["proj_w"].shape) == (2, 2, 32, 64)
    assert tgpt2.count_params(params) == jgpt2.count_params(jax_params)
    assert tgpt2.flops_per_token(tcfg) == jgpt2.flops_per_token(jcfg)
    # a fresh torch init has the same tree and the same init scales
    fresh = tgpt2.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    assert tgpt2.count_params(fresh) == tgpt2.count_params(params)
    for name, ref in (("qkv_w", 0.02), ("out_w", 0.02 / 2.0)):
        std = float(fresh["blocks"][name].detach().std())
        assert abs(std - ref) < 0.1 * ref, (name, std)
    with pytest.raises(ValueError):
        tgpt2.GPT2(dataclasses.replace(tcfg, num_layers=3),
                   jax.tree.map(lambda a: torch.from_numpy(np.array(a)),
                                jax_params), device="cpu")


def test_bf16_bundle_leaves_convert():
    """JAX bf16 arrays (numpy's bfloat16 extension type) convert through
    their bit pattern, value for value."""
    a = np.asarray(jnp.asarray([1.5, -2.25, 3.0e-3], jnp.bfloat16))
    t = convert.tensor_from_numpy(a)
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(), a.astype(np.float32))
    assert convert.torch_dtype(jnp.bfloat16) == torch.bfloat16
    assert convert.torch_dtype(np.float32) == torch.float32


def test_presets_and_unported_options():
    assert get_preset("gpt2-small") == tgpt2.GPT2_SMALL
    assert module_for(tgpt2.GPT2_SMALL) is tgpt2
    small = tgpt2.GPT2_SMALL
    assert (small.num_layers, small.num_heads, small.embed_dim,
            small.head_dim, small.vocab_size) == (12, 12, 768, 64, 50304)
    # llama is ported: its presets resolve to the port's configs
    from ray_tpu_torch.models import llama as tllama
    assert get_preset("llama-tiny") == tllama.LLAMA_TINY
    assert module_for(tllama.LLAMA_1B) is tllama
    with pytest.raises(KeyError):
        get_preset("nope")
    # ring and Ulysses attention are ported (tests/test_torch_ring.py)
    for impl in ("ring", "ulysses"):
        assert tgpt2.GPT2Config(attention_impl=impl).attention_impl == impl
