"""Parity of the port's training path (ray_tpu_torch.ops.xent,
models.gpt2.loss_fn, train.step) with the JAX package's, on the CPU, in f32.

Both packages start from one JAX ``init_params`` tree (converted with
``params_from_numpy``) and one numpy-seeded batch. The JAX flash kernels run
in interpret mode; the port's ``flash_interpret`` runs its plain blockwise
forward and backward. Bounds: the reference's own (2e-4 for f32 gradients,
tests/test_attention.py; rtol 1e-5 on the loss and atol 1e-5 on the
gradients of the chunked cross entropy, tests/test_model_train.py).
"""
import dataclasses

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from ray_tpu.models import gpt2 as jgpt2
from ray_tpu.ops.xent import chunked_softmax_xent as jxent
from ray_tpu.train import step as jstep
from ray_tpu_torch.models import convert
from ray_tpu_torch.models import gpt2 as tgpt2
from ray_tpu_torch.ops import attention as tattn
from ray_tpu_torch.ops.xent import chunked_softmax_xent as txent
from ray_tpu_torch.train import (
    OptimizerConfig,
    create_train_state,
    make_eval_step,
    make_train_step,
)

GRAD_TOL = dict(atol=2e-4, rtol=2e-4)


def _configs(impl="xla", remat=False, policy="dots"):
    jcfg = dataclasses.replace(jgpt2.GPT2_TINY, dtype=jnp.float32,
                               attention_impl=impl, remat=bool(remat),
                               remat_policy=policy)
    tcfg = dataclasses.replace(tgpt2.GPT2_TINY, dtype=torch.float32,
                               attention_impl=impl, remat=bool(remat),
                               remat_policy=policy)
    return jcfg, tcfg


@pytest.fixture(scope="module")
def np_params():
    jcfg, _ = _configs()
    return jax.tree.map(np.asarray, jgpt2.init_params(jcfg, jax.random.PRNGKey(0)))


def _batch(B=2, T=40, V=512, seed=0, mask=False):
    r = np.random.RandomState(seed)
    batch = {"tokens": r.randint(0, V, (B, T + 1)).astype(np.int32)}
    if mask:
        batch["mask"] = (r.rand(B, T) < 0.7).astype(np.float32)
    return batch


def _leaves(tree):
    """(name, array) pairs of a GPT-2 parameter tree, in a fixed order."""
    out = [(n, tree[n]) for n in ("wte", "wpe", "ln_f_g", "ln_f_b")]
    return out + [(f"blocks.{n}", tree["blocks"][n]) for n in tgpt2.BLOCK_PARAMS]


@pytest.mark.parametrize("T,chunk,masked", [(48, 16, False), (50, 16, True),
                                            (30, 512, True)])
def test_chunked_xent_matches_jax(T, chunk, masked):
    """Values and gradients (x and the head weight), with and without a
    mask, with T a multiple of the chunk and not (the tail chunk padded with
    mask-0 rows)."""
    r = np.random.RandomState(1)
    B, E, V = 2, 16, 97
    x = r.randn(B, T, E).astype(np.float32)
    w = (r.randn(V, E) * 0.1).astype(np.float32)
    t = r.randint(0, V, (B, T)).astype(np.int32)
    m = (r.rand(B, T) < 0.6).astype(np.float32) if masked else None
    val_j, grads_j = jax.jit(jax.value_and_grad(
        lambda x, w: jxent(x, w, jnp.asarray(t),
                           None if m is None else jnp.asarray(m), chunk),
        argnums=(0, 1)))(jnp.asarray(x), jnp.asarray(w))
    xt, wt = (torch.from_numpy(a).requires_grad_() for a in (x, w))
    val_t = txent(xt, wt, torch.from_numpy(t),
                  None if m is None else torch.from_numpy(m), chunk)
    grads_t = torch.autograd.grad(val_t, (xt, wt))
    assert val_t.dtype == torch.float32 and val_t.shape == ()
    np.testing.assert_allclose(val_t.item(), float(val_j), rtol=1e-5)
    for gt, gj in zip(grads_t, grads_j):
        np.testing.assert_allclose(gt.numpy(), np.asarray(gj), atol=1e-5)


@pytest.fixture(scope="module")
def jax_loss_and_grads(np_params):
    """JAX loss and gradients per attention impl, under remat "dots" (a
    remat policy changes what is recomputed, not the arithmetic)."""
    out = {}
    batch = _batch(mask=True)
    for impl in ("xla", "flash_interpret"):
        jcfg, _ = _configs(impl, remat=True)
        params = jax.tree.map(jnp.asarray, np_params)
        out[impl] = jax.jit(jax.value_and_grad(jgpt2.loss_fn),
                            static_argnums=2)(
            params, jax.tree.map(jnp.asarray, batch), jcfg)
    return batch, out


@pytest.mark.parametrize("impl", ["xla", "flash_interpret"])
@pytest.mark.parametrize("remat,policy", [(False, "dots"), (True, "dots"),
                                          (True, "dots_all"), (True, "full")])
def test_loss_fn_and_grads_match_jax(np_params, jax_loss_and_grads, impl,
                                     remat, policy):
    batch, ref = jax_loss_and_grads
    loss_j, grads_j = ref[impl]
    _, tcfg = _configs(impl, remat, policy)
    params = convert.params_from_numpy(np_params, tcfg, device="cpu")
    loss_t = tgpt2.loss_fn(params, batch, tcfg)
    loss_t.backward()
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=2e-4)
    grads_j = jax.tree.map(np.asarray, grads_j)
    for (name, gj), (_, p) in zip(_leaves(grads_j), _leaves(params)):
        np.testing.assert_allclose(p.grad.numpy(), gj, err_msg=name, **GRAD_TOL)


def test_loss_fn_batch_forms_and_unported_options(np_params):
    """{"inputs", "targets"} equals {"tokens"}; without a mesh the pipelined
    path (one stage) is the same loss through whole logits."""
    _, tcfg = _configs()
    params = convert.params_from_numpy(np_params, tcfg, device="cpu")
    toks = _batch()["tokens"]
    with torch.no_grad():
        a = tgpt2.loss_fn(params, {"tokens": toks}, tcfg)
        b = tgpt2.loss_fn(params, {"inputs": toks[:, :-1],
                                   "targets": toks[:, 1:]}, tcfg)
        c = tgpt2.loss_fn(params, {"tokens": toks}, tcfg,
                          pipeline_microbatches=2)
    assert float(a) == float(b)
    np.testing.assert_allclose(float(c), float(a), rtol=1e-5)
    with pytest.raises(ValueError):
        tgpt2.GPT2Config(remat_policy="nope")


@pytest.mark.parametrize("policy,per_layer", [("dots", 1), ("full", 2)])
def test_remat_policy_keeps_flash_forward(np_params, monkeypatch, policy,
                                          per_layer):
    """Under "dots" the flash forward runs once per layer in a forward and
    backward (its out and lse are kept, as JAX keeps "flash_out"/
    "flash_lse"); under "full" the backward re-runs it. On the card these
    are K2's launches per step."""
    calls = []
    ref = tattn.flash_attention_ref

    def counted(*a, **kw):
        calls.append(kw.get("with_lse", False))
        return ref(*a, **kw)

    monkeypatch.setattr(tattn, "flash_attention_ref", counted)
    _, tcfg = _configs("flash", remat=True, policy=policy)
    params = convert.params_from_numpy(np_params, tcfg, device="cpu")
    tgpt2.loss_fn(params, _batch(), tcfg).backward()
    assert calls == [True] * (per_layer * tcfg.num_layers)


def test_optimizer_matches_optax_chain():
    """The schedule at every count (lr 0 at the first update), then four
    updates of the port's ClipAdamW against the JAX package's optax chain
    (clip_by_global_norm, adamw with weight decay) on the same parameters
    and gradients, below and above the clip: parameters, and the global norm
    reported before clipping. Bound 1e-5 relative: optax computes the
    schedule and the update in f32, the port the schedule in f64."""
    oc = dict(learning_rate=1e-2, warmup_steps=2, total_steps=10)
    opt = OptimizerConfig(**oc).build()
    ref = optax.warmup_cosine_decay_schedule(0.0, 1e-2, 2, 10)
    for n in range(14):   # optax evaluates in f32, the port in f64: 1e-5
        np.testing.assert_allclose(opt.schedule(n), float(ref(n)), rtol=1e-5,
                                   atol=1e-12)
    assert opt.schedule(0) == 0.0
    r = np.random.RandomState(2)
    params = [r.randn(5, 3).astype(np.float32), r.randn(7).astype(np.float32)]
    jopt = jstep.OptimizerConfig(**oc).build()
    jparams = [jnp.asarray(p) for p in params]
    jstate = jopt.init(jparams)
    module = torch.nn.ParameterList(
        [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params])
    state = opt.init(module)
    for count, scale in enumerate((0.01, 10.0, 0.01, 10.0)):
        grads = [(r.randn(*p.shape) * scale).astype(np.float32) for p in params]
        updates, jstate = jopt.update([jnp.asarray(g) for g in grads], jstate,
                                      jparams)
        jparams = optax.apply_updates(jparams, updates)
        for p, g in zip(module, grads):
            p.grad = torch.from_numpy(g.copy())
        norm = opt.update(state, module, count)
        np.testing.assert_allclose(float(norm), float(optax.global_norm(grads)),
                                   rtol=1e-6)
        for p, pj in zip(module, jparams):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(pj),
                                       rtol=1e-5, atol=1e-7)


def test_train_steps_match_jax(np_params):
    """Three steps through the slice's path (flash attention, plain forward
    and backward on both sides; remat "dots") from one init and batch: loss
    and grad_norm per step at 2e-4 relative, then the parameters. Adam turns
    a relative gradient error into an absolute step error of up to about lr
    (an element whose gradient is near its rounding noise moves by
    m/sqrt(v) ~ +-1 times lr), so no bound far below lr per step holds in
    general; on this init no element is such, the two agree to ~3e-6 after
    three steps, and the bound is 1e-2 lr per step. The optimizer's own
    arithmetic is held to optax at 1e-5 by test_optimizer_matches_optax_chain."""
    lr = 1e-3
    oc = dict(learning_rate=lr, warmup_steps=1, total_steps=10)
    jcfg, tcfg = _configs("flash_interpret", remat=True)
    jopt = jstep.OptimizerConfig(**oc).build()
    jstate = {"params": jax.tree.map(jnp.asarray, np_params),
              "opt_state": None, "step": 0}
    jstate["opt_state"] = jopt.init(jstate["params"])
    jfn = jstep.make_train_step(jcfg, jopt, donate=False)
    opt = OptimizerConfig(**oc).build()
    state = create_train_state(
        tcfg, opt, params=convert.params_from_numpy(np_params, tcfg, "cpu"))
    tfn = make_train_step(tcfg, opt)
    batch = _batch(seed=3)
    for i in range(3):
        jstate, jm = jfn(jstate, jax.tree.map(jnp.asarray, batch))
        state, tm = tfn(state, batch)
        assert tm["step"] == int(jm["step"]) == i + 1
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=2e-4)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                                   rtol=2e-4)
    jp = jax.tree.map(np.asarray, jstate["params"])
    for (name, pj), (_, pt) in zip(_leaves(jp), _leaves(state["params"])):
        np.testing.assert_allclose(pt.detach().numpy(), pj, atol=3e-2 * lr,
                                   err_msg=name)
    ev = make_eval_step(tcfg)(state["params"], batch)
    assert ev.requires_grad is False and np.isfinite(float(ev))


def test_train_step_defaults_and_unported_options():
    """A fresh state defaults to the card (and raises without one); the
    mesh steps' options are held in tests/test_torch_parallel.py."""
    _, tcfg = _configs()
    opt = OptimizerConfig().build()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            create_train_state(tcfg, opt)
    state = create_train_state(tcfg, opt, torch.Generator().manual_seed(0), "cpu")
    n = len(list(state["params"].parameters()))
    assert state["step"] == 0 and float(state["opt_state"]["lr"]) == 0.0
    assert all(len(state["opt_state"][k]) == n
               for k in ("step", "exp_avg", "exp_avg_sq"))
