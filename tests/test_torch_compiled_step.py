"""The port's train and eval steps as compiled programs (the analog of
``jax.jit``), on the CPU, against the eager port and the JAX package.

``backend="aot_eager"`` runs Dynamo and AOTAutograd (the joint graph and the
checkpoint partition) without generating code, so the graphs traced here
hold the ops the card's Inductor programs hold: K1, K2 and the K4+K3
backward as the custom ops ``ray_tpu_torch::flash_fwd``, ``flash_fwd_lse``
and ``flash_bwd``, whose CPU implementations run the plain blockwise
versions. Tiny configs (depth 2, T=40), f32, JAX weights converted.

Bounds. Compiled against eager: loss and grad_norm 1e-6 relative (the same
aten ops; the joint graph sums some gradients in another order).
Parameters 1e-6 relative, or 1e-2 lr absolute: Adam divides each gradient
element by its own magnitude, so an element that is small against the
rounding of the largest (the key bias's gradient is zero in exact
arithmetic, since the softmax ignores a shift shared by all keys) moves by
up to lr times its relative error, damped by eps = 1e-8 (observed: 8e-4
lr). Against JAX: ``tests/test_torch_train.py``'s bounds (2e-4 relative;
parameters 3e-2 lr), and 2e-5 for the eval loss (the reference's f32
forward bound).
"""
import dataclasses

import numpy as np
import pytest
import torch
import torch._dynamo

import jax
import jax.numpy as jnp

from ray_tpu.models import gpt2 as jgpt2
from ray_tpu.models import llama as jllama
from ray_tpu.train import step as jstep
from ray_tpu_torch.models import convert
from ray_tpu_torch.models import gpt2 as tgpt2
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.ops import attention as tattn
from ray_tpu_torch.parallel.moe import MoEConfig
from ray_tpu_torch.train import (
    OptimizerConfig,
    create_train_state,
    make_eval_step,
    make_train_step,
)

LR = 1e-3
OPT = dict(learning_rate=LR, warmup_steps=1, total_steps=10)
FAMILIES = {"gpt2": (jgpt2, tgpt2, "GPT2_TINY"),
            "llama": (jllama, tllama, "LLAMA_TINY")}


def _configs(family, policy="dots"):
    jmod, tmod, name = FAMILIES[family]
    over = dict(remat=True, remat_policy=policy)
    jcfg = dataclasses.replace(getattr(jmod, name), dtype=jnp.float32,
                               attention_impl="flash_interpret", **over)
    tcfg = dataclasses.replace(getattr(tmod, name), dtype=torch.float32,
                               attention_impl="flash", **over)
    return jcfg, tcfg


@pytest.fixture(scope="module")
def np_trees():
    """JAX init of each family as numpy arrays."""
    out = {}
    for family, (jmod, _, _) in FAMILIES.items():
        init = jax.jit(jmod.init_params, static_argnums=0)
        out[family] = jax.tree.map(np.asarray, init(_configs(family)[0],
                                                    jax.random.PRNGKey(0)))
    return out


@pytest.fixture
def kernel_calls(monkeypatch):
    """Calls of each custom op's real implementation, counted through the
    plain versions that the ops' CPU paths run (one call each)."""
    calls = {"flash_fwd": 0, "flash_fwd_lse": 0, "flash_bwd": 0}
    fwd, bwd = tattn.flash_attention_ref, tattn.flash_attention_bwd_ref

    def fwd_counted(*a, **kw):
        calls["flash_fwd_lse" if kw.get("with_lse") else "flash_fwd"] += 1
        return fwd(*a, **kw)

    def bwd_counted(*a, **kw):
        calls["flash_bwd"] += 1
        return bwd(*a, **kw)

    monkeypatch.setattr(tattn, "flash_attention_ref", fwd_counted)
    monkeypatch.setattr(tattn, "flash_attention_bwd_ref", bwd_counted)
    return calls


def _batch(seed=3, B=2, T=40, V=512):
    return {"tokens": np.random.RandomState(seed).randint(
        0, V, (B, T + 1)).astype(np.int32)}


def _jax_leaf(tree, name):
    for key in name.split("."):
        tree = tree[key]
    return np.asarray(tree)


def _snapshot(state):
    opt = state["opt_state"]
    return {n: p.detach().clone()
            for n, p in state["params"].named_parameters()}, {
        f"{k}.{i}": t.clone() for k in ("step", "exp_avg", "exp_avg_sq")
        for i, t in enumerate(opt[k])}


def _run(tcfg, state, backend, calls, donate=True, seed=0, steps=3):
    """``steps`` steps of make_train_step; Dynamo raises if any step after
    the first compiles again. Returns (state, [(loss, grad_norm)], [kernel
    calls per step])."""
    fn = make_train_step(tcfg, OptimizerConfig(**OPT).build(), donate=donate,
                         seed=seed, backend=backend)
    rows, counts = [], []
    for i in range(steps):
        before, kept = dict(calls), _snapshot(state)
        with torch._dynamo.config.patch(error_on_recompile=i > 0):
            new, m = fn(state, _batch())
        counts.append({n: calls[n] - before[n] for n in calls})
        rows.append((float(m["loss"]), float(m["grad_norm"])))
        assert m["step"] == new["step"] == i + 1
        if not donate:   # the input state's tensors are left as they were
            params, moments = _snapshot(state)
            assert new["params"] is not state["params"]
            for n, p in params.items():
                assert torch.equal(p, kept[0][n]), n
            assert len(moments) == len(kept[1])
            for k in moments:
                assert torch.equal(moments[k], kept[1][k]), k
        state = new
    return state, rows, counts


def _assert_params_close(a, b):
    pa, pb = dict(a.named_parameters()), dict(b.named_parameters())
    assert pa.keys() == pb.keys()
    for n in pa:
        np.testing.assert_allclose(pa[n].detach().numpy(),
                                   pb[n].detach().numpy(), rtol=1e-6,
                                   atol=1e-2 * LR, err_msg=n)


@pytest.mark.parametrize("case", ["gpt2-dots", "gpt2-full", "llama-dots"])
def test_compiled_train_step_matches_eager_and_jax(np_trees, kernel_calls,
                                                   case):
    """Three steps compiled (``aot_eager``, ``fullgraph``; ``donate=False``,
    so every step takes new parameters) against three eager steps
    (``donate=True``) and JAX's ``make_train_step(donate=False)``, from one
    init and batch. No step after the first compiles again. The custom ops
    run per step as on the card: K2 once a layer under "dots" (its outputs
    kept) and twice under "full" (re-run in the backward), the K4+K3
    backward once a layer, K1 never."""
    family, policy = case.split("-")
    jcfg, tcfg = _configs(family, policy)
    tree = np_trees[family]
    jopt = jstep.OptimizerConfig(**OPT).build()
    jparams = jax.tree.map(jnp.asarray, tree)
    jstate = {"params": jparams, "opt_state": jopt.init(jparams), "step": 0}
    jfn = jstep.make_train_step(jcfg, jopt, donate=False)
    jrows = []
    for _ in range(3):
        jstate, jm = jfn(jstate, jax.tree.map(jnp.asarray, _batch()))
        jrows.append((float(jm["loss"]), float(jm["grad_norm"])))

    runs = {}
    for backend, donate in ((None, True), ("aot_eager", False)):
        state = create_train_state(
            tcfg, OptimizerConfig(**OPT).build(),
            params=convert.params_from_numpy(tree, tcfg, "cpu"))
        runs[backend] = _run(tcfg, state, backend, kernel_calls, donate)
    (eager, eager_rows, eager_counts) = runs[None]
    (comp, comp_rows, comp_counts) = runs["aot_eager"]

    L = tcfg.num_layers
    want = {"flash_fwd": 0, "flash_fwd_lse": L * (2 if policy == "full" else 1),
            "flash_bwd": L}
    assert comp_counts == eager_counts == [want] * 3
    np.testing.assert_allclose(comp_rows, eager_rows, rtol=1e-6)
    np.testing.assert_allclose(comp_rows, jrows, rtol=2e-4)
    _assert_params_close(comp["params"], eager["params"])
    jp = jstate["params"]
    for n, p in comp["params"].named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), _jax_leaf(jp, n),
                                   atol=3e-2 * LR, err_msg=n)


def test_compiled_moe_step_with_router_jitter_matches_eager(kernel_calls):
    """A llama with 4 SwiGLU experts, top-2, router jitter 0.5, remat
    "dots": the noise is drawn outside the program and each checkpointed
    block takes its row as an input, so the compiled step (no graph break
    at the router) equals the eager one. The port and JAX draw different
    noise, so JAX is not compared here."""
    cfg = dataclasses.replace(
        tllama.LLAMA_TINY, dtype=torch.float32, attention_impl="flash",
        remat=True, remat_policy="dots",
        moe=MoEConfig(num_experts=4, top_k=2, activation="swiglu",
                      router_jitter=0.5))
    runs = {}
    for backend, donate in ((None, True), ("aot_eager", False)):
        state = create_train_state(cfg, OptimizerConfig(**OPT).build(),
                                   torch.Generator().manual_seed(0), "cpu")
        runs[backend] = _run(cfg, state, backend, kernel_calls, donate,
                             seed=5)
    np.testing.assert_allclose(runs["aot_eager"][1], runs[None][1], rtol=1e-6)
    _assert_params_close(runs["aot_eager"][0]["params"],
                         runs[None][0]["params"])
    no_jitter = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, router_jitter=0.0))
    state = create_train_state(no_jitter, OptimizerConfig(**OPT).build(),
                               torch.Generator().manual_seed(0), "cpu")
    _, rows, _ = _run(no_jitter, state, None, kernel_calls, steps=1)
    assert rows[0][0] != runs["aot_eager"][1][0][0]


def test_compiled_eval_step_matches_jax(np_trees, kernel_calls):
    """The compiled eval step (no gradient: K1, the custom op
    ``flash_fwd``, once a layer) against JAX's ``make_eval_step``, and
    against the eager port's."""
    jcfg, tcfg = _configs("gpt2")
    tree = np_trees["gpt2"]
    batch = _batch(seed=4)
    want = float(jstep.make_eval_step(jcfg)(jax.tree.map(jnp.asarray, tree),
                                            jax.tree.map(jnp.asarray, batch)))
    params = convert.params_from_numpy(tree, tcfg, "cpu")
    eager = make_eval_step(tcfg, backend=None)(params, batch)
    got = make_eval_step(tcfg, backend="aot_eager")(params, batch)
    assert got.requires_grad is False
    assert kernel_calls == {"flash_fwd": 2 * tcfg.num_layers,
                            "flash_fwd_lse": 0, "flash_bwd": 0}
    np.testing.assert_allclose(float(got), want, rtol=2e-5)
    np.testing.assert_allclose(float(got), float(eager), rtol=1e-6)


@pytest.mark.parametrize("family", ["gpt2", "llama"])
def test_block_region_is_traced_once(family):
    """Dynamo traces the block once and every layer calls that one region
    (the analog of the reference's ``lax.scan`` over layers), so the
    compile does not grow with the depth: the loss graph of a 3-layer
    model calls one ``invoke_subgraph`` three times."""
    _, tcfg = _configs(family)
    tcfg = dataclasses.replace(tcfg, num_layers=3)
    params = FAMILIES[family][1].init_params(
        tcfg, torch.Generator().manual_seed(0), "cpu")
    calls = []

    def record(gm, example_inputs):
        calls.extend(str(n.args[1]) for n in gm.graph.nodes
                     if n.op == "call_function"
                     and "invoke_subgraph" in str(n.target))
        return gm.forward

    loss = torch.compile(
        lambda tree, batch: FAMILIES[family][1].loss_fn(tree, batch, tcfg),
        backend=record, fullgraph=True)
    loss(params, _batch(T=16, V=tcfg.vocab_size))
    assert len(calls) == 3 and len(set(calls)) == 1, calls


def test_inductor_step_matches_eager(kernel_calls):
    """The card's backend, Inductor, here generating C++ for the CPU: two
    steps of GPT2_TINY (remat "dots", so each block is a checkpointed
    nested compile region) equal the eager step. Inductor's buffer reuse
    and in-place buffers, which the step turns off, corrupt the backward
    of a region called once per layer (gradients off by up to 100%).
    Bounds: loss and grad_norm 1e-5 relative (Inductor fuses and reorders
    f32 sums), parameters as against ``aot_eager``."""
    _, tcfg = _configs("gpt2")
    runs = {}
    for backend in (None, "inductor"):
        state = create_train_state(tcfg, OptimizerConfig(**OPT).build(),
                                   torch.Generator().manual_seed(0), "cpu")
        runs[backend] = _run(tcfg, state, backend, kernel_calls, steps=2)
    np.testing.assert_allclose(runs["inductor"][1], runs[None][1], rtol=1e-5)
    _assert_params_close(runs["inductor"][0]["params"],
                         runs[None][0]["params"])


def test_many_programs_in_one_process():
    """More compiled steps of distinct configs (vocabularies) in one
    process than Dynamo keeps programs per code object
    (``recompile_limit``; past it ``fullgraph`` raises): nine eval steps at
    the default limit of 8, and, since a train step traces for seconds,
    three train steps under a limit of 2. Each program compiles a code
    object of its own, so none raises. The last of each kind equals its
    eager step."""

    def cfg(i):
        return dataclasses.replace(
            tgpt2.GPT2_TINY, num_layers=1, remat=False, vocab_size=64 + 8 * i,
            dtype=torch.float32, attention_impl="flash")

    def state(c):
        return create_train_state(c, OptimizerConfig(**OPT).build(),
                                  torch.Generator().manual_seed(0), "cpu")

    def batch(c):
        return _batch(seed=c.vocab_size, T=8, V=c.vocab_size)

    for i in range(9):
        c = cfg(i)
        got = float(make_eval_step(c, backend="aot_eager")(
            state(c)["params"], batch(c)))
    np.testing.assert_allclose(got, float(make_eval_step(c, backend=None)(
        state(c)["params"], batch(c))), rtol=1e-6)
    with torch._dynamo.config.patch(recompile_limit=2):
        for i in range(3):
            c = cfg(i)
            rows = [make_train_step(c, OptimizerConfig(**OPT).build(),
                                    backend=backend)(state(c), batch(c))[1]
                    for backend in ("aot_eager", None)]
    np.testing.assert_allclose(
        [float(rows[0][k]) for k in ("loss", "grad_norm")],
        [float(rows[1][k]) for k in ("loss", "grad_norm")], rtol=1e-6)


def _op_inputs(grad: bool):
    r = np.random.RandomState(6)
    B, T, H, Hkv, D = 1, 24, 4, 2, 16
    q, k, v = (torch.from_numpy(r.randn(*s).astype(np.float32))
               for s in ((B, T, H, D), (B, T, Hkv, D), (B, T, Hkv, D)))
    if grad:
        q, k, v = (x.requires_grad_() for x in (q, k, v))
    return q, k, v


@pytest.mark.parametrize("op", ["flash_fwd", "flash_fwd_lse", "flash_bwd"])
def test_custom_ops_pass_opcheck(op):
    """Schema, fake implementation (shapes, dtypes and strides of the real
    CPU outputs, T=24 over 16-row blocks so the plain versions pad), the
    autograd registration of flash_fwd_lse and tracing through AOTAutograd
    with dynamic shapes."""
    if op == "flash_bwd":
        q, k, v = _op_inputs(grad=False)
        out, lse = tattn.flash_fwd_lse(q, k, v, True, 16, 16, False)
        do = torch.from_numpy(
            np.random.RandomState(7).randn(*q.shape).astype(np.float32))
        args = (q, k, v, out, lse, do, True, 16, 16, False)
    else:
        args = (*_op_inputs(grad=op == "flash_fwd_lse"), True, 16, 16, False)
    torch.library.opcheck(getattr(tattn, op), args)
