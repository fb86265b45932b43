"""Sequence parallelism of the port against the JAX package's.

The JAX side runs in this process on the virtual 8-device CPU mesh; the
port's side on 4 gloo ranks (``ray_tpu_torch.parallel.dryrun.run_ranks``;
the bodies in tests/test_torch_ranks.py, which imports no JAX),
one spawn for all cases, each rank returning its chunk of every output.
Inputs are numpy-seeded, f32; the bounds are the reference's own
(tests/test_attention.py, tests/test_model_train.py).
"""
import concurrent.futures

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from ray_tpu.models import gpt2 as jgpt2
from ray_tpu.models import llama as jllama
from ray_tpu.ops.attention import attention_xla as j_attention_xla
from ray_tpu.parallel.mesh import MeshConfig as JMeshConfig
from ray_tpu.parallel.ring_attention import (
    ring_attention as j_ring_attention,
    ulysses_attention as j_ulysses_attention,
)
from ray_tpu.train.step import (
    OptimizerConfig as JOptimizerConfig,
    make_train_step as j_make_train_step,
)
from ray_tpu_torch.parallel.dryrun import run_ranks
from tests.test_torch_ranks import (
    ATTN_CASES,
    GPT2_RING,
    LLAMA_SEQ,
    N,
    ring_body,
    shared_results,
)

FWD_TOL = dict(atol=2e-5, rtol=2e-5)
GRAD_TOL = dict(atol=2e-4, rtol=2e-4)
MODEL_TOL = dict(atol=3e-4, rtol=3e-4)


def _qkv(B=2, T=128, H=4, Hkv=4, D=16, seed=0):
    r = np.random.RandomState(seed)
    return tuple(r.randn(B, T, h, D).astype(np.float32) for h in (H, Hkv, Hkv,
                                                                  H))


def _tokens(B, T, seed=0, V=512):
    return np.random.RandomState(seed).randint(0, V, (B, T)).astype(np.int32)


# ----------------------------------------------------------- JAX side

def _jax_attention(impl, causal, q, k, v, do):
    """JAX ring/Ulysses (seq=4) of q against k/v repeated to q's heads, and
    the gradients of sum(out * do) with respect to the unrepeated k/v."""
    mesh = JMeshConfig(data=1, seq=N).build(jax.devices()[:N])
    spec = P(None, "seq", None, None)
    rep = q.shape[2] // k.shape[2]
    fn = j_ring_attention if impl == "ring" else j_ulysses_attention

    def f(q, k, v):
        k, v = (jnp.repeat(x, rep, axis=2) for x in (k, v))
        return fn(q, k, v, mesh=mesh, axis="seq", causal=causal,
                  qkv_spec=spec)

    o = jax.jit(f)(q, k, v)
    grads = jax.jit(jax.grad(lambda *a: (f(*a) * do).sum(),
                             argnums=(0, 1, 2)))(q, k, v)
    return [np.asarray(x) for x in (o, *grads)]


def _results():
    data = {"qkv": {h: _qkv(Hkv=h) for h in (4, 2)},
            "dtensor_qkv": _qkv(B=4, T=64, H=4, Hkv=4, seed=3),
            "tokens": _tokens(4, 64, seed=1),
            "train_tokens": _tokens(4, 65, seed=2)}
    gcfg = jgpt2.GPT2Config(**GPT2_RING, dtype=jnp.float32)
    lcfg = jllama.LlamaConfig(**LLAMA_SEQ, dtype=jnp.float32)
    data["gpt2"] = jax.tree.map(np.asarray,
                                jgpt2.init_params(gcfg, jax.random.PRNGKey(1)))
    data["llama"] = jax.tree.map(np.asarray,
                                 jllama.init_params(lcfg, jax.random.PRNGKey(2)))
    # the ranks run while this process computes JAX's side
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(run_ranks, ring_body, N, data)
        ref = {case: _jax_attention(*case[:2], *data["qkv"][case[2]])
               for case in ATTN_CASES}
        ref["ring_train"] = _jax_ring_train(data["gpt2"], data["train_tokens"])
        return data, ref, ranks.result()


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return shared_results(tmp_path_factory, "torch_ring", _results)


def _assemble(ranks, key, part=None, idx_of=lambda r: r, n=N, dim=1):
    """The whole tensor from the ranks' chunks along ``dim``."""
    chunks = {}
    for r, res in enumerate(ranks):
        x = res[key] if part is None else res[key][part]
        chunks[idx_of(r)] = x
    return np.concatenate([chunks[i] for i in range(n)], axis=dim)


@pytest.mark.parametrize("impl,causal,hkv", ATTN_CASES)
def test_ring_and_ulysses_match_jax(results, impl, causal, hkv):
    """The port's ring (K2 pieces merged by lse; K4/K3 backward with the
    chunk's dK/dV travelling home) and Ulysses on seq=4 against JAX's on
    its seq=4 mesh: out within 2e-5, dq/dk/dv within 2e-4. GQA (Hkv=2):
    the port rotates 2 kv heads, JAX repeats them to 4 first."""
    data, ref, ranks = results
    ref = ref[(impl, causal, hkv)]
    for part, tol in zip(range(4), (FWD_TOL, GRAD_TOL, GRAD_TOL, GRAD_TOL)):
        got = _assemble(ranks, (impl, causal, hkv), part)
        np.testing.assert_allclose(got, ref[part], err_msg=f"part {part}",
                                   **tol)


def test_ulysses_heads_not_divisible_raise(results):
    _, _, ranks = results
    assert all("not divisible by seq=4" in r["ulysses_heads_error"]
               for r in ranks)


@pytest.mark.parametrize("dim", [0, 2])
def test_custom_ops_on_dtensors(results, dim):
    """K1, K2 and K4+K3's ops on DTensors sharded on batch (dim 0) or heads
    (dim 2) run locally on each shard: out (with and without a gradient to
    record) and dq/dk/dv equal dense attention's within 2e-5 / 2e-4."""
    data, _, ranks = results
    q, k, v, do = data["dtensor_qkv"]
    out = ranks[0][("dtensor", dim)]

    def f(q, k, v):
        return j_attention_xla(q, k, v, causal=True)

    ref = np.asarray(f(q, k, v))
    grads = jax.grad(lambda *a: (f(*a) * do).sum(), argnums=(0, 1, 2))(q, k, v)
    np.testing.assert_allclose(out[0], ref, **FWD_TOL)
    np.testing.assert_allclose(out[1], ref, **FWD_TOL)
    for got, want in zip(out[2:], grads):
        np.testing.assert_allclose(got, np.asarray(want), **GRAD_TOL)


@pytest.mark.parametrize("name", ["gpt2-ring", "llama-ring", "llama-ulysses"])
def test_sequence_parallel_model_logits_match_jax(results, name):
    """Tiny GPT-2 and llama (GQA 2) on data=2 x seq=2, each rank a quarter
    of the tokens (rows over data, sequence over seq), against the JAX
    model with the same attention on its data=2 x seq=2 mesh: logits within
    3e-4 (tests/test_model_train.py's ring bound)."""
    data, _, ranks = results
    mesh = JMeshConfig(data=2, seq=2).build(jax.devices()[:4])
    family, impl = name.split("-")
    if family == "gpt2":
        mod, cfg = jgpt2, jgpt2.GPT2Config(**GPT2_RING, dtype=jnp.float32)
    else:
        mod, cfg = jllama, jllama.LlamaConfig(**LLAMA_SEQ, attention_impl=impl,
                                             dtype=jnp.float32)
    tokens = jax.device_put(jnp.asarray(data["tokens"]),
                            NamedSharding(mesh, P("data", "seq")))
    ref, _ = jax.jit(lambda p, t: mod.forward(p, t, cfg, mesh))(
        data[family], tokens)
    ref = np.asarray(ref)
    # rank r = (data index, seq index) row-major over the 2 x 2 mesh
    rows = [np.concatenate([ranks[2 * b + s][name] for s in range(2)], axis=1)
            for b in range(2)]
    np.testing.assert_allclose(np.concatenate(rows, axis=0), ref, **MODEL_TOL)


def _jax_ring_train(params, tokens):
    """JAX's three steps of the ring GPT-2 on its data=2 x seq=2 mesh."""
    mesh = JMeshConfig(data=2, seq=2).build(jax.devices()[:4])
    cfg = jgpt2.GPT2Config(**GPT2_RING, dtype=jnp.float32)
    opt = JOptimizerConfig(learning_rate=1e-3).build()
    params = jax.tree.map(jnp.asarray, params)
    state = {"params": params, "opt_state": opt.init(params), "step": 0}
    step = j_make_train_step(cfg, opt, mesh)
    metrics = []
    for _ in range(3):
        state, m = step(state, {"tokens": jnp.asarray(tokens)})
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    return metrics


def test_ring_train_step_matches_jax(results):
    """Three train steps of the ring GPT-2 on data=2 x seq=2 (the ring's
    backward, the shards' positions and the loss over the whole batch)
    against JAX's step on its data=2 x seq=2 mesh: losses and grad norms
    within 2e-4."""
    _, ref, ranks = results
    for r in ranks:
        np.testing.assert_allclose(np.asarray(r["ring_train"]),
                                   np.asarray(ref["ring_train"]), rtol=2e-4)
