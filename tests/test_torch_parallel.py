"""The port's parallel layer against the JAX package's: the mesh, the
sharding rules, the GPipe loop, the expert axis and the sharded train step.

The JAX side runs in this process on the virtual 8-device CPU mesh; the
port's side on 4 gloo ranks (``ray_tpu_torch.parallel.dryrun.run_ranks``;
the bodies in tests/test_torch_ranks.py, which imports no JAX),
one spawn for every multi-rank case. Weights come from the JAX
``init_params`` through ``models/convert.py``; inputs are numpy-seeded; all
f32. Bounds are the reference's own: 2e-4 for a pipelined forward and for
sharded against sharded steps, 2e-3 for sharded against unsharded losses
(tests/test_model_train.py).
"""
import concurrent.futures
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from ray_tpu.models import gpt2 as jgpt2
from ray_tpu.models import llama as jllama
from ray_tpu.parallel import sharding as jsharding
from ray_tpu.parallel.mesh import MeshConfig as JMeshConfig
from ray_tpu.parallel.moe import MoEConfig as JMoEConfig
from ray_tpu.train.step import (
    OptimizerConfig as JOptimizerConfig,
    make_train_step as j_make_train_step,
)
from ray_tpu_torch.models import convert
from ray_tpu_torch.models import gpt2 as tgpt2
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.parallel import sharding as tsharding
from ray_tpu_torch.parallel.dryrun import dryrun_multirank, run_ranks
from ray_tpu_torch.parallel.mesh import AXES, MeshConfig
from ray_tpu_torch.parallel.moe import MoEConfig
from ray_tpu_torch.train.step import (
    OptimizerConfig,
    create_train_state,
    make_train_step,
)
from tests.test_torch_ranks import (
    MOE,
    MOE_DROP,
    N,
    PIPE,
    RULES,
    STEPS,
    TINY,
    TRAIN_CASES,
    parallel_body,
    shared_results,
    torch_cfg,
)

# the cases held to JAX's step on its mesh; every case is held to the
# port's step without a mesh (the MoE cases' losses are held to JAX's in
# test_moe_expert_axis_matches_jax)
JAX_STEPS = ("fsdp2-tensor2", "data4", "llama-data2-tensor2")


def _jcfg(family, kw):
    """JAX's f32 config of a case."""
    if family == "llama":
        return dataclasses.replace(jllama.LlamaConfig(**kw),
                                   dtype=jnp.float32)
    moe = {"gpt2-moe": JMoEConfig(**MOE),
           "gpt2-moe-drop": JMoEConfig(**MOE_DROP)}.get(family)
    return jgpt2.GPT2Config(**kw, moe=moe, dtype=jnp.float32)


def _tokens(B, T, seed):
    return np.random.RandomState(seed).randint(0, 512, (B, T)).astype(np.int32)


# ------------------------------------------------ no spawn: mesh and rules

def test_mesh_config_resolution_matches_jax():
    for kw, n in ((dict(), 8), (dict(fsdp=2, tensor=2), 8),
                  (dict(data=2, stage=2, expert=2), 8), (dict(seq=4), 4),
                  (dict(data=1, fsdp=-1, tensor=2), 8)):
        assert MeshConfig(**kw).resolve(n) == JMeshConfig(**kw).resolve(n)
    for kw, n in ((dict(data=-1, fsdp=-1), 8), (dict(tensor=3), 8),
                  (dict(data=2, tensor=2), 8)):
        with pytest.raises(ValueError) as jerr:
            JMeshConfig(**kw).resolve(n)
        with pytest.raises(ValueError, match=str(jerr.value).split(" ")[0]):
            MeshConfig(**kw).resolve(n)
    assert AXES == ("data", "fsdp", "stage", "tensor", "seq", "expert")


def _jax_leaves(tree):
    return jax.tree.leaves(tree, is_leaf=lambda x: isinstance(x, tuple))


def _port_leaves(tree):
    if isinstance(tree, tuple):
        return [tree]
    return [x for k in sorted(tree) for x in _port_leaves(tree[k])]


def _as_axes(spec, ndim):
    """A PartitionSpec as {mesh axis: tensor dim}."""
    out = {}
    for dim, entry in enumerate(tuple(spec) + (None,) * (ndim - len(spec))):
        for a in ((entry,) if isinstance(entry, str) else entry or ()):
            out[a] = dim
    return out


@pytest.mark.parametrize("rules", [None, {"embed": None, "kv": "tensor"},
                                   {"batch": ("data", "fsdp", "seq")}])
def test_placements_from_rules_match_partition_specs(rules):
    """Every parameter of GPT-2, MoE GPT-2 and llama, and the batch: a mesh
    axis is Shard(dim) in the port exactly where JAX's PartitionSpec puts
    it on dim, each axis used once, multi-axis entries in order."""
    trees = [(jgpt2.param_axes(jgpt2.GPT2_TINY),
              tgpt2.param_axes(tgpt2.GPT2_TINY)),
             (jgpt2.param_axes(dataclasses.replace(
                 jgpt2.GPT2_TINY, moe=JMoEConfig(activation="swiglu"))),
              tgpt2.param_axes(dataclasses.replace(
                  tgpt2.GPT2_TINY, moe=MoEConfig(activation="swiglu")))),
             (jllama.param_axes(jllama.LLAMA_TINY),
              tllama.param_axes(tllama.LLAMA_TINY))]
    pairs = [(j, t) for jt, tt in trees
             for j, t in zip(_jax_leaves(jt), _port_leaves(tt))]
    pairs.append((("batch", "seq"), ("batch", "seq")))
    for jaxes, taxes in pairs:
        assert jaxes == taxes
        want = _as_axes(jsharding.spec_from_logical(jaxes, rules), len(jaxes))
        got = tsharding.spec_from_logical(taxes, rules)
        assert len(got) == len(AXES)
        for axis, p in zip(AXES, got):
            if axis in want:
                assert p == tsharding.Shard(want[axis]), (jaxes, axis, p)
            else:
                assert p == tsharding.Replicate(), (jaxes, axis, p)
    with pytest.raises(ValueError, match="mesh order"):
        tsharding.spec_from_logical(("batch",), {"batch": ("fsdp", "data")})


# ---------------------------------------------------------- JAX side

def _jax_train(name, params):
    """JAX's three steps on its mesh from ``params``."""
    axes, family, kw, pm = TRAIN_CASES[name]
    mesh = JMeshConfig(**axes).build(jax.devices()[:N])
    cfg = _jcfg(family, kw)
    opt = JOptimizerConfig(learning_rate=1e-3).build()
    params = jax.tree.map(jnp.asarray, params)
    state = {"params": params, "opt_state": opt.init(params), "step": 0}
    step = j_make_train_step(cfg, opt, mesh, pipeline_microbatches=pm)
    batch = {"tokens": TRAIN_TOKENS}
    if pm is None:
        batch = jax.device_put(batch, {"tokens": NamedSharding(
            mesh, P(("data", "fsdp"), None))})
    metrics = []
    for _ in range(STEPS):
        state, m = step(state, batch)
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    return metrics


TRAIN_TOKENS = _tokens(8, 33, seed=5)


def _jax_refs(data):
    """JAX's side of every case but the train steps' no-mesh runs."""
    ref = {name: _jax_train(name, data[name]) for name in JAX_STEPS}
    mesh = JMeshConfig(data=1, stage=N).build(jax.devices()[:N])
    cfg = _jcfg("gpt2", PIPE)
    ref["pipe_logits"], _ = jax.jit(lambda p, t: jgpt2.forward_pipelined(
        p, t, cfg, mesh, num_microbatches=4))(data["gpt2-pipe"],
                                               data["pipe_tokens"])
    batch = {"tokens": TRAIN_TOKENS}
    mesh = JMeshConfig(data=1, expert=N).build(jax.devices()[:N])
    cfg = _jcfg("gpt2-moe", TINY)
    ref["moe_logits"], ref["moe_aux"] = jax.jit(
        lambda p, t: jgpt2.forward(p, t, cfg, mesh))(data["gpt2-moe"],
                                                      data["pipe_tokens"])
    ref["moe_loss"] = jax.jit(lambda p, b: jgpt2.loss_fn(p, b, cfg, mesh))(
        data["gpt2-moe"], batch)
    mesh = JMeshConfig(data=1, stage=2, expert=2).build(jax.devices()[:N])
    cfg = _jcfg("gpt2-moe", PIPE)
    ref["moe_pipe_logits"], ref["moe_pipe_aux"] = jax.jit(
        lambda p, t: jgpt2.forward_pipelined(p, t, cfg, mesh,
                                             num_microbatches=2))(
        data["gpt2-moe-pipe"], data["pipe_tokens"])
    ref["moe_pipe_loss"] = jax.jit(lambda p, b: jgpt2.loss_fn(
        p, b, cfg, mesh, pipeline_microbatches=2))(data["gpt2-moe-pipe"],
                                                   batch)
    mesh = JMeshConfig(data=2, stage=2).build(jax.devices()[:N])
    cfg = _jcfg("gpt2-moe-drop", PIPE)
    ref["moe_drop_logits"], ref["moe_drop_aux"] = jax.jit(
        lambda p, t: jgpt2.forward_pipelined(p, t, cfg, mesh,
                                             num_microbatches=2))(
        data["gpt2-moe-pipe"], data["pipe_tokens"])
    ref["moe_drop_loss"] = jax.jit(lambda p, b: jgpt2.loss_fn(
        p, b, cfg, mesh, pipeline_microbatches=2))(data["gpt2-moe-pipe"],
                                                   batch)
    ref["moe_drop3_logits"], ref["moe_drop3_aux"] = jax.jit(
        lambda p, t: jgpt2.forward_pipelined(p, t, cfg, mesh,
                                             num_microbatches=3))(
        data["gpt2-moe-pipe"], data["pipe12_tokens"])
    ref["moe_drop3_loss"], ref["moe_drop3_grads"] = jax.jit(
        jax.value_and_grad(lambda p, b: jgpt2.loss_fn(
            p, b, cfg, mesh, pipeline_microbatches=3)))(
        data["gpt2-moe-pipe"], {"tokens": data["train12_tokens"]})
    return jax.tree.map(np.asarray, ref)


def _results():
    data = {"pipe_tokens": _tokens(8, 32, seed=4),
            "train_tokens": TRAIN_TOKENS,
            "pipe12_tokens": _tokens(12, 32, seed=14),
            "train12_tokens": _tokens(12, 33, seed=15)}
    for key, family, kw in (("gpt2-pipe", "gpt2", PIPE),
                            ("gpt2-moe", "gpt2-moe", TINY),
                            ("gpt2-moe-pipe", "gpt2-moe", PIPE)):
        data[key] = jax.tree.map(np.asarray, jgpt2.init_params(
            _jcfg(family, kw), jax.random.PRNGKey(2)))
    for name, (axes, family, kw, _) in TRAIN_CASES.items():
        mod = jllama if family == "llama" else jgpt2
        data[name] = jax.tree.map(np.asarray, mod.init_params(
            _jcfg(family, kw), jax.random.PRNGKey(3)))
    # the ranks run while this process computes JAX's side
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(run_ranks, parallel_body, N, data)
        ref = _jax_refs(data)
        return data, ref, ranks.result()


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return shared_results(tmp_path_factory, "torch_parallel", _results)


def _port_steps(name, params):
    """The port's step without a mesh, from the same parameters."""
    axes, family, kw, pm = TRAIN_CASES[name]
    cfg = torch_cfg(family, kw)
    opt = OptimizerConfig(learning_rate=1e-3).build()
    state = create_train_state(cfg, opt, params=convert.params_from_numpy(
        params, cfg, device="cpu"))
    step = make_train_step(cfg, opt, pipeline_microbatches=pm)
    metrics = []
    for _ in range(STEPS):
        state, m = step(state, {"tokens": TRAIN_TOKENS})
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    return metrics


def test_forward_pipelined_matches_jax(results):
    """GPT-2 (4 layers) through the GPipe loop on stage=4 with M=4 against
    JAX's forward_pipelined on its data=1 x stage=4 mesh, within 2e-4."""
    _, ref, ranks = results
    for r in ranks:     # every stage returns the whole output
        np.testing.assert_allclose(r["pipe_logits"], ref["pipe_logits"],
                                   atol=2e-4, rtol=2e-4)


def test_pipeline_output_gradient_counted_once(results):
    """Every stage computes the loss from the broadcast output; the
    gradients through the GPipe loop (stage=4, M=4) equal the port's
    unpipelined ones within 2e-4: counted once, not once per stage."""
    data, _, ranks = results
    cfg = torch_cfg("gpt2", PIPE)
    params = convert.params_from_numpy(data["gpt2-pipe"], cfg, device="cpu")
    loss = tgpt2.loss_fn(params, {"tokens": data["train_tokens"]}, cfg)
    loss.backward()
    loss = float(loss.detach())
    for r in ranks:
        assert abs(r["pipe_loss"] - loss) <= 2e-4 * abs(loss)
        for n, p in params.named_parameters():
            np.testing.assert_allclose(r["pipe_grads"][n], p.grad.numpy(),
                                       atol=2e-4, rtol=2e-4, err_msg=n)


def test_moe_expert_axis_matches_jax(results):
    """A MoE GPT-2 with its 4 experts sharded over expert=4, and through
    the GPipe loop on stage=2 x expert=2 (M=2): logits, the positive aux
    loss and the loss against JAX's on its mesh within 2e-4."""
    _, ref, ranks = results
    for r in ranks:
        for key in ("moe_logits", "moe_aux", "moe_loss", "moe_pipe_logits",
                    "moe_pipe_aux", "moe_pipe_loss"):
            np.testing.assert_allclose(r[key], ref[key], atol=2e-4,
                                       rtol=2e-4, err_msg=key)
        assert float(r["moe_aux"]) > 0 and float(r["moe_pipe_aux"]) > 0


def test_moe_pipeline_over_data_matches_jax(results):
    """A MoE GPT-2 through the GPipe loop on data=2 x stage=2 (M=2), its
    capacity queues half the routed load so that tokens are dropped: each
    data rank's logits (its rows of the batch), the aux loss and the loss
    against JAX's on its mesh within 2e-4. The capacity queues rank the
    tokens of a microbatch, so each rank's microbatch must be its shard of
    JAX's microbatch of the whole batch."""
    _, ref, ranks = results
    rows = ref["moe_drop_logits"].shape[0] // 2
    for r in ranks:
        d = r["moe_drop_rank"]
        np.testing.assert_allclose(
            r["moe_drop_logits"], ref["moe_drop_logits"][d * rows:
                                                         (d + 1) * rows],
            atol=2e-4, rtol=2e-4)
        for key in ("moe_drop_aux", "moe_drop_loss"):
            np.testing.assert_allclose(r[key], ref[key], atol=2e-4,
                                       rtol=2e-4, err_msg=key)


def test_moe_pipeline_uneven_microbatches_match_jax(results):
    """The same MoE GPT-2 on data=2 x stage=2 over M=3 microbatches of a
    batch of 12: 3 is no multiple of data=2, so each rank's shard of
    every JAX microbatch reaches it through an exchange of uneven parts.
    Each data rank's logits, the aux loss, the loss and every gradient
    (back through the inverse exchange) against JAX's on its mesh within
    2e-4."""
    _, ref, ranks = results
    rows = ref["moe_drop3_logits"].shape[0] // 2
    for r in ranks:
        d = r["moe_drop_rank"]
        np.testing.assert_allclose(
            r["moe_drop3_logits"],
            ref["moe_drop3_logits"][d * rows:(d + 1) * rows],
            atol=2e-4, rtol=2e-4)
        for key in ("moe_drop3_aux", "moe_drop3_loss"):
            np.testing.assert_allclose(r[key], ref[key], atol=2e-4,
                                       rtol=2e-4, err_msg=key)
        for name, grad in r["moe_drop3_grads"].items():
            want = ref["moe_drop3_grads"]
            for part in name.split("."):
                want = want[part]
            if grad is None:      # a leaf off the MoE model's path
                grad = np.zeros_like(want)
            np.testing.assert_allclose(grad, want, atol=2e-4, rtol=2e-4,
                                       err_msg=name)


@pytest.mark.parametrize("name", list(TRAIN_CASES))
def test_train_step_matches_jax_and_unsharded(results, name):
    """Three steps on each mesh: losses and grad norms within 2e-3 of the
    port's step without a mesh and, for the dense meshes, within 2e-4 of
    JAX's step on its mesh; every rank reports the same."""
    data, ref, ranks = results
    unsharded = np.asarray(_port_steps(name, data[name]))
    for r in ranks:
        got = np.asarray(r[name])
        np.testing.assert_allclose(got, unsharded, rtol=2e-3)
        if name in JAX_STEPS:
            np.testing.assert_allclose(got, ref[name], rtol=2e-4)


def test_rules_place_the_parameters_before_the_step(results):
    """make_train_step(rules=...) on fsdp=2 x tensor=2 moves each parameter
    and its moments to the rules' placements, and the steps are the same
    function: losses and norms within 2e-4 of the default layout's."""
    _, _, ranks = results
    axes = tgpt2.param_axes(torch_cfg("gpt2", TINY))
    want = {}
    for path, names in (("", axes), ("blocks.", axes["blocks"])):
        for n, a in names.items():
            if isinstance(a, tuple):
                want[path + n] = tsharding.spec_from_logical(a, RULES)
    for r in ranks:
        for n, (param, moment) in r["rules_placements"].items():
            assert param == moment == want[n], n
        np.testing.assert_allclose(np.asarray(r["rules"]),
                                   np.asarray(r["fsdp2-tensor2"]), rtol=2e-4)


def test_mesh_step_compiles_where_the_model_does_not_communicate(results):
    """On data=4 the model computes on local tensors between the gathers
    and the reductions, so the step's programs trace (aot_eager here):
    three steps equal the eager mesh step's. A model that communicates on
    its mesh (the GPipe loop over stage=2 with experts over expert=2) runs
    eagerly, and asking to compile it raises."""
    _, _, ranks = results
    for r in ranks:
        np.testing.assert_allclose(np.asarray(r["data4-aot_eager"]),
                                   np.asarray(r["data4"]), rtol=2e-4)
        assert "runs eagerly" in r["communicating_compile"]


def test_mesh_shape_and_sharding_constraint(results):
    """mesh_shape names every axis; with_sharding_constraint places a plain
    tensor (the whole value on every rank) by the rules: rank r of data=4
    holds rows 2r, 2r+1 of the batch; replicated() is Replicate on every
    axis."""
    _, _, ranks = results
    x = np.arange(32.0).reshape(8, 4)
    for r, res in enumerate(ranks):
        assert res["mesh_shape"] == dict(data=1, fsdp=1, stage=2, tensor=1,
                                         seq=1, expert=2)
        local, placements = res["constrained"]
        np.testing.assert_array_equal(local, x[2 * r:2 * r + 2])
        assert placements == (tsharding.Replicate(),) * 6


def test_grad_norm_not_scaled_by_data_size(results):
    """On data=4 each rank's loss covers a quarter of the batch; the summed
    gradient is the whole batch's mean's, so the norm equals the unsharded
    step's (2e-4 here, the f32 sums' order aside), not 4x it."""
    data, _, ranks = results
    norms = np.asarray(_port_steps("data4", data["data4"]))[:, 1]
    got = np.asarray(ranks[0]["data4"])[:, 1]
    np.testing.assert_allclose(got, norms, rtol=2e-4)


def test_dryrun_multirank_exits_cleanly():
    """Legs 1-3 of the reference's dry run on 4 gloo ranks."""
    out = dryrun_multirank(N)
    assert len(out) == N and all(np.isfinite([o["loss"], o["loss2"]]).all()
                                 for o in out)
