"""Parity of the port's one-card MoE layer (ray_tpu_torch.parallel.moe) and
of the models' MoE branches with the JAX package's, on the CPU, in f32.

Same numpy-seeded inputs and weights through both packages. Bounds: the
reference's own, 2e-5 for f32 outputs (and the aux loss) and 2e-4 for f32
gradients (tests/test_attention.py). ``jax.lax.top_k`` breaks ties toward
the lower index and ``torch.topk`` promises no order among ties, so every
input here is continuous random data: its router probabilities never tie.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ray_tpu.models import gpt2 as jgpt2
from ray_tpu.models import llama as jllama
from ray_tpu.parallel import moe as jmoe
from ray_tpu_torch.models import convert
from ray_tpu_torch.models import gpt2 as tgpt2
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.parallel import moe as tmoe
from ray_tpu_torch.train import OptimizerConfig, create_train_state, make_train_step

TOL = dict(atol=2e-5, rtol=2e-5)
GRAD_TOL = dict(atol=2e-4, rtol=2e-4)


def _moe_inputs(activation, seed=0, B=2, T=16, D=32, M=48, E=4):
    """x, the JAX-initialised expert weights (numpy) and a fixed cotangent."""
    cfg = jmoe.MoEConfig(num_experts=E, activation=activation)
    params = jax.tree.map(np.asarray, jmoe.init_moe_params(
        jax.random.PRNGKey(seed), D, M, cfg))
    # a larger router so the top-k choice is decided by clear margins
    params["router_w"] = params["router_w"] * 20.0
    r = np.random.RandomState(seed)
    return (r.randn(B, T, D).astype(np.float32), params,
            r.randn(B, T, D).astype(np.float32))


@pytest.mark.parametrize("activation", ["gelu", "swiglu"])
@pytest.mark.parametrize("dropless,capacity_factor", [
    (False, 2.0),     # capacity with room for every routed token
    (False, 0.5),     # capacity 8 of ~16 routed a expert: tokens drop
    (True, 1.25),     # dropless: every expert on every token
])
def test_moe_layer_matches_jax(activation, dropless, capacity_factor):
    """Output and aux loss at 2e-5; gradients of <out, cotangent> + aux
    with respect to x and every expert weight at 2e-4."""
    x, params, ct = _moe_inputs(activation)
    kw = dict(num_experts=4, top_k=2, capacity_factor=capacity_factor,
              activation=activation, dropless=dropless)
    jcfg, tcfg = jmoe.MoEConfig(**kw), tmoe.MoEConfig(**kw)
    if capacity_factor < 1:
        # the case must really drop: some expert is chosen by more tokens
        # than its capacity
        logits = x.reshape(-1, 32) @ params["router_w"]
        top2 = np.argsort(-logits, axis=-1)[:, :2]
        capacity = max(int(32 * 2 * capacity_factor / 4), 2)
        assert np.bincount(top2.ravel(), minlength=4).max() > capacity

    def jloss(x, p):
        out, aux = jmoe.moe_layer(p, x, jcfg)
        return jnp.sum(out * ct) + aux, (out, aux)

    (_, (out_j, aux_j)), grads_j = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(
        jnp.asarray(x), jax.tree.map(jnp.asarray, params))
    xt = torch.from_numpy(x).requires_grad_()
    pt = {n: torch.from_numpy(a.copy()).requires_grad_()
          for n, a in params.items()}
    out_t, aux_t = tmoe.moe_layer(pt, xt, tcfg)
    assert aux_t.dtype == torch.float32 and float(aux_t.detach()) > 0.0
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j), **TOL)
    np.testing.assert_allclose(float(aux_t.detach()), float(aux_j), **TOL)
    (torch.sum(out_t * torch.from_numpy(ct)) + aux_t).backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(grads_j[0]),
                               **GRAD_TOL)
    for n, p in pt.items():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(grads_j[1][n]),
                                   err_msg=n, **GRAD_TOL)


def test_moe_config_and_init():
    with pytest.raises(ValueError):
        tmoe.MoEConfig(activation="relu")
    cfg = tmoe.MoEConfig(num_experts=4, activation="swiglu")
    p = tmoe.init_moe_params(torch.Generator().manual_seed(0), 32, 48, cfg,
                             num_layers=3)
    jp = jax.eval_shape(lambda k: jmoe.init_moe_params(k, 32, 48, jmoe.MoEConfig(
        num_experts=4, activation="swiglu"), num_layers=3), jax.random.PRNGKey(0))
    assert {n: tuple(a.shape) for n, a in p.items()} == {
        n: tuple(a.shape) for n, a in jp.items()}
    assert abs(float(p["expert_fc"].std()) - 0.02) < 0.002


def _moe_model_configs(family, dropless=False):
    """A tiny f32 MoE model of each family: llama with SwiGLU experts
    (Mixtral-style), GPT-2 with GELU experts."""
    act = "swiglu" if family == "llama" else "gelu"
    kw = dict(num_experts=4, top_k=2, activation=act, dropless=dropless)
    jmod, tmod = (jllama, tllama) if family == "llama" else (jgpt2, tgpt2)
    base = "LLAMA_TINY" if family == "llama" else "GPT2_TINY"
    jcfg = dataclasses.replace(getattr(jmod, base), dtype=jnp.float32,
                               remat=False, attention_impl="xla",
                               moe=jmoe.MoEConfig(**kw))
    tcfg = dataclasses.replace(getattr(tmod, base), dtype=torch.float32,
                               remat=False, attention_impl="xla",
                               moe=tmoe.MoEConfig(**kw))
    return jmod, tmod, jcfg, tcfg


@pytest.fixture(scope="module")
def moe_trees():
    out = {}
    for family in ("llama", "gpt2"):
        jmod, _, jcfg, _ = _moe_model_configs(family)
        out[family] = jax.tree.map(np.asarray, jax.jit(
            jmod.init_params, static_argnums=0)(jcfg, jax.random.PRNGKey(1)))
    return out


@pytest.mark.parametrize("family", ["llama", "gpt2"])
def test_moe_model_forward_and_loss_match_jax(moe_trees, family):
    """The capacity-routed forward (logits and aux), then loss_fn and its
    gradients through the experts."""
    jmod, tmod, jcfg, tcfg = _moe_model_configs(family)
    tree = moe_trees[family]
    params = convert.params_from_numpy(tree, tcfg, device="cpu")
    r = np.random.RandomState(2)
    toks = r.randint(0, 512, (2, 25)).astype(np.int32)
    jp = jax.tree.map(jnp.asarray, tree)
    lj, aux_j = jax.jit(jmod.forward, static_argnums=2)(
        jp, jnp.asarray(toks[:, :-1]), jcfg)
    with torch.no_grad():
        lt, aux_t = tmod.forward(params, torch.from_numpy(toks[:, :-1]), tcfg)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    np.testing.assert_allclose(float(aux_t), float(aux_j), **TOL)
    assert float(aux_t) > 0.0

    batch = {"tokens": toks}
    loss_j, grads_j = jax.jit(jax.value_and_grad(jmod.loss_fn),
                              static_argnums=2)(
        jp, {"tokens": jnp.asarray(toks)}, jcfg)
    loss_t = tmod.loss_fn(params, batch, tcfg)
    loss_t.backward()
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=2e-4)
    for name, p in params.named_parameters():
        g = grads_j
        for part in name.split("."):
            g = g[part]
        # GPT-2 keeps its dense MLP beside the experts, unused: no grad
        got = p.grad.numpy() if p.grad is not None else np.zeros(p.shape)
        np.testing.assert_allclose(got, np.asarray(g), err_msg=name, **GRAD_TOL)


@pytest.mark.parametrize("family", ["llama", "gpt2"])
def test_moe_model_forward_cached_matches_jax(moe_trees, family):
    """Dropless routing (the engine's) through prefill and a decode step
    of forward_cached: logits at 2e-5, against JAX's and against the
    port's own full forward."""
    jmod, tmod, jcfg, tcfg = _moe_model_configs(family, dropless=True)
    tree = moe_trees[family]
    params = convert.params_from_numpy(tree, tcfg, device="cpu")
    jp = jax.tree.map(jnp.asarray, tree)
    toks = np.random.RandomState(3).randint(0, 512, (2, 13)).astype(np.int32)
    jc = jmod.init_kv_cache(jcfg, 2, 32)
    tc = tmod.init_kv_cache(tcfg, 2, 32, device="cpu")
    logits = []
    for chunk, start in ((toks[:, :12], 0), (toks[:, 12:], 12)):
        s = np.full((2,), start, np.int32)
        lj, jc = jax.jit(jmod.forward_cached, static_argnums=4)(
            jp, jnp.asarray(chunk), jc, jnp.asarray(s), jcfg)
        with torch.no_grad():
            lt, tc = tmod.forward_cached(params, torch.from_numpy(chunk), tc,
                                         torch.from_numpy(s), tcfg)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
        logits.append(lt)
    with torch.no_grad():
        full, _ = tmod.forward(params, torch.from_numpy(toks), tcfg)
    np.testing.assert_allclose(torch.cat(logits, 1).numpy(), full.numpy(),
                               atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("family", ["llama", "gpt2"])
def test_moe_train_steps_match_jax(moe_trees, family):
    """Three capacity-routed steps of make_train_step (aux loss inside the
    loss) against JAX's: loss and grad_norm at 2e-4 relative. GPT-2 keeps
    its dense MLP beside the experts, unused: JAX's zero gradients still
    let AdamW decay it, and so does the port."""
    from ray_tpu.train import step as jstep

    jmod, tmod, jcfg, tcfg = _moe_model_configs(family)
    oc = dict(learning_rate=1e-3, warmup_steps=1, total_steps=10)
    jopt = jstep.OptimizerConfig(**oc).build()
    jp = jax.tree.map(jnp.asarray, moe_trees[family])
    jstate = {"params": jp, "opt_state": jopt.init(jp), "step": 0}
    jfn = jstep.make_train_step(jcfg, jopt, donate=False)
    opt = OptimizerConfig(**oc).build()
    state = create_train_state(tcfg, opt, params=convert.params_from_numpy(
        moe_trees[family], tcfg, "cpu"))
    tfn = make_train_step(tcfg, opt)
    batch = {"tokens": np.random.RandomState(5).randint(0, 512, (2, 25))}
    for _ in range(3):
        jstate, jm = jfn(jstate, jax.tree.map(jnp.asarray, batch))
        state, tm = tfn(state, batch)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=2e-4)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=2e-4)
    if family == "gpt2":
        np.testing.assert_allclose(
            state["params"]["blocks"]["fc_w"].detach().numpy(),
            np.asarray(jstate["params"]["blocks"]["fc_w"]), rtol=1e-6)
        assert not np.array_equal(np.asarray(jstate["params"]["blocks"]["fc_w"]),
                                  moe_trees[family]["blocks"]["fc_w"])


def test_router_jitter_is_seeded_and_replayed_under_remat(moe_trees):
    """With router jitter, the train step draws per-layer seeds from its
    generator; checkpointed blocks re-draw the same noise in the backward,
    so remat "dots" and "full" give the gradients of remat=False."""
    _, _, _, tcfg = _moe_model_configs("llama")
    tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(
        tcfg.moe, router_jitter=0.5))
    batch = {"tokens": np.random.RandomState(4).randint(0, 512, (2, 17))}
    norms = {}
    for remat, policy in ((False, "dots"), (True, "dots"), (True, "full")):
        cfg = dataclasses.replace(tcfg, remat=remat, remat_policy=policy)
        params = convert.params_from_numpy(moe_trees["llama"], cfg, "cpu")
        opt = OptimizerConfig().build()
        state = create_train_state(cfg, opt, params=params)
        _, m = make_train_step(cfg, opt, seed=5)(state, batch)
        norms[(remat, policy)] = (float(m["loss"]), float(m["grad_norm"]))
    ref = norms[(False, "dots")]
    for key, got in norms.items():
        np.testing.assert_allclose(got, ref, rtol=1e-5, err_msg=str(key))
    plain = dataclasses.replace(tcfg, moe=dataclasses.replace(
        tcfg.moe, router_jitter=0.0), remat=False)
    with torch.no_grad():
        params = convert.params_from_numpy(moe_trees["llama"], plain, "cpu")
        loss_plain = float(tllama.loss_fn(params, batch, plain))
    assert loss_plain != ref[0]
