"""The train layer of the port (``ray_tpu_torch.train``) against the JAX
package's (``ray_tpu.train``), on the CPU.

(a) One train program (``_program``) runs through ``ray_tpu.train`` on a
``ray_tpu`` cluster, then through ``ray_tpu_torch.train`` on a port
cluster (2 nodes of 2 CPUs each, 128 MiB arenas, one after the other):
two workers report their ranks, top-k checkpoints by score with
``ckpt_index.json``, a failure retried and resumed from its checkpoint,
failures exhausted, the train collectives, ``get_dataset_shard`` of a
list, the scaling policies' decisions and a 2-worker gloo ``TorchTrainer``
(its final parameters). Each part is compared key by key.

(b) In the port's session, ``SPMDTrainer``'s ``default_train_loop`` trains
tiny GPT-2 and Llama configs (f32, depth 2, ``device="cpu"``) for 3 steps
from a step-0 checkpoint of the JAX init (``ray_tpu.train.step.
create_train_state``, converted by ``params_from_numpy`` and registered
through the port's ``CheckpointManager``), which the controller resumes
from as on a restart. Its losses equal ``ray_tpu.train.step.
make_train_step``'s on the same state and the same numpy batches within
2e-4 relative (the reference's f32 gradient bound); (c) the same loop on 2
gloo workers with ``mesh={"data": 2}`` equals one worker within 2e-5.

(d) ``save_pytree``/``load_pytree`` round-trip a train state and a bf16
leaf bit for bit. (e) The arena of a session is unmapped at ``shutdown()``,
and a view kept past it stays readable until it is dropped.

The train functions are defined inside ``_program`` and ``_port_loops``,
so cloudpickle ships them by value and a port node never imports this
module (which imports jax). The sessions are computed once per test
session (``test_torch_ranks.shared_results``).
"""
import importlib
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import ray_tpu
import ray_tpu.train as rtrain
import ray_tpu.train.torch as rtorch
import ray_tpu_torch
import ray_tpu_torch.train as ptrain
import ray_tpu_torch.train.torch as ptorch
from ray_tpu.models.gpt2 import GPT2Config as JGPT2Config
from ray_tpu.models.llama import LlamaConfig as JLlamaConfig
from ray_tpu.train import step as jstep
from ray_tpu_torch.models import convert
from tests.test_torch_cluster import _REFERENCE_ENV, _SMALL_ARENA, _env
from tests.test_torch_ranks import shared_results

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (b)'s tiny configs, the kwargs that both packages' default loops take
MODELS = {
    "gpt2": dict(family="gpt2", vocab_size=128, max_seq_len=32, num_layers=2,
                 num_heads=2, embed_dim=32, dtype="float32",
                 attention_impl="xla"),
    "llama": dict(family="llama", vocab_size=128, max_seq_len=32,
                  num_layers=2, num_heads=4, num_kv_heads=2, embed_dim=32,
                  dtype="float32", attention_impl="xla"),
}
LOOP = dict(num_steps=3, batch_size=4, seq_len=16, data_seed=3,
            optimizer=dict(learning_rate=1e-2, warmup_steps=1, total_steps=3))


def _program(rt, train, tt, root):
    """The shared program; ``rt`` is ``ray_tpu`` or ``ray_tpu_torch``,
    ``train`` and ``tt`` its train and train.torch packages."""
    out = {}
    collective = importlib.import_module(train.__name__ + ".collective")
    scaling_policy = importlib.import_module(
        train.__name__ + ".scaling_policy")

    def run_config(name, **kw):
        return train.RunConfig(name=name, storage_path=root, **kw)

    def ranks_fn(config):
        ctx = train.get_context()
        train.report({"rank": ctx.get_world_rank(),
                      "world": ctx.get_world_size(), "cfg": config["x"]})

    # spread: both nodes import the train package at once, here
    r = train.DataParallelTrainer(
        ranks_fn, train_loop_config={"x": 41},
        scaling_config=train.ScalingConfig(num_workers=2,
                                           placement_strategy="SPREAD"),
        run_config=run_config("ranks")).fit()
    out["ranks"] = (r.metrics, r.error, len(r.metrics_history))

    def topk_fn(config):
        import tempfile

        for step in range(5):
            with tempfile.TemporaryDirectory() as d:
                with open(os.path.join(d, "step.txt"), "w") as f:
                    f.write(str(step))
                train.report({"score": (step * 3) % 5},
                             checkpoint=train.Checkpoint.from_directory(d))

    r = train.DataParallelTrainer(
        topk_fn, scaling_config=train.ScalingConfig(num_workers=1),
        run_config=run_config("topk", checkpoint_config=train.CheckpointConfig(
            num_to_keep=2, checkpoint_score_attribute="score"))).fit()
    run_dir = os.path.join(root, "topk")

    def step_of(ckpt):
        with open(os.path.join(ckpt.path, "step.txt")) as f:
            return f.read()

    with open(os.path.join(run_dir, "ckpt_index.json")) as f:
        import json

        index = json.load(f)
    out["topk"] = (
        sorted(d for d in os.listdir(run_dir) if d.startswith("checkpoint_")),
        step_of(r.checkpoint), step_of(r.best_checkpoint), r.metrics,
        [(e["index"], e["metrics"], os.path.basename(e["path"]))
         for e in index])

    def resume_fn(config):
        import tempfile

        start = 0
        ckpt = train.get_checkpoint()
        if ckpt is not None:
            with open(os.path.join(ckpt.path, "step.txt")) as f:
                start = int(f.read()) + 1
        for step in range(start, 6):
            with tempfile.TemporaryDirectory() as d:
                with open(os.path.join(d, "step.txt"), "w") as f:
                    f.write(str(step))
                train.report({"step": step, "resumed_from": start},
                             checkpoint=train.Checkpoint.from_directory(d))
            if step == 2 and not os.path.exists(config["marker"]):
                open(config["marker"], "w").close()
                raise RuntimeError("injected failure at step 2")

    r = train.DataParallelTrainer(
        resume_fn, train_loop_config={"marker": os.path.join(root, "marker")},
        scaling_config=train.ScalingConfig(num_workers=1),
        run_config=run_config("resume", failure_config=train.FailureConfig(
            max_failures=1))).fit()
    out["resume"] = (r.metrics, [m["step"] for m in r.metrics_history])

    def failing_fn(config):
        raise ValueError("always fails")

    try:
        train.DataParallelTrainer(
            failing_fn, scaling_config=train.ScalingConfig(num_workers=1),
            run_config=run_config("exhaust", failure_config=(
                train.FailureConfig(max_failures=1)))).fit()
        out["exhausted"] = None
    except Exception as e:   # the class name is what is compared
        out["exhausted"] = (type(e).__name__, "always fails" in str(e),
                            "after 1 retries" in str(e))

    def collectives_fn(config):
        ctx = train.get_context()
        rank = ctx.get_world_rank()
        got = collective.broadcast_from_rank_zero(
            {"master": "rank0-data"} if rank == 0 else None)
        gathered = collective.allgather(rank * 10 + 1)
        again = collective.allgather(f"r{rank}", name="second")
        collective.barrier()
        train.report({"got": got, "all": gathered, "again": again,
                      "rank": rank})

    r = train.DataParallelTrainer(
        collectives_fn, scaling_config=train.ScalingConfig(num_workers=2),
        run_config=run_config("collectives")).fit()
    out["collectives"] = r.metrics

    def shard_fn(config):
        shard = train.get_dataset_shard("train")
        train.report({"shards": collective.allgather(shard),
                      "missing": train.get_dataset_shard("eval")})

    r = train.DataParallelTrainer(
        shard_fn, scaling_config=train.ScalingConfig(num_workers=2),
        run_config=run_config("shards"),
        datasets={"train": list(range(11))}).fit()
    out["dataset_shard"] = r.metrics

    def ddp_fn(config):
        import torch

        ctx = train.get_context()
        torch.manual_seed(config["seed"])
        model = tt.prepare_model(torch.nn.Sequential(
            torch.nn.Linear(6, 8), torch.nn.Tanh(), torch.nn.Linear(8, 1)))
        opt = torch.optim.SGD(model.parameters(), lr=0.1)
        data = torch.Generator().manual_seed(ctx.get_world_rank())
        for _ in range(4):
            x = torch.randn(8, 6, generator=data)
            loss = model(x).pow(2).mean()
            opt.zero_grad()
            loss.backward()
            opt.step()
        train.report({"world": torch.distributed.get_world_size(),
                      "params": [p.detach().numpy().copy()
                                 for p in model.parameters()]})

    r = tt.TorchTrainer(
        ddp_fn, train_loop_config={"seed": 7},
        scaling_config=train.ScalingConfig(num_workers=2,
                                           placement_strategy="SPREAD"),
        run_config=run_config("ddp")).fit()
    out["torch_ddp"] = r.metrics

    # the scaling policies, once the finished groups' CPUs are back
    deadline = time.monotonic() + 30
    while (rt.available_resources().get("CPU", 0) < 4
           and time.monotonic() < deadline):
        time.sleep(0.05)
    fixed = scaling_policy.make_scaling_policy(train.ScalingConfig(
        num_workers=3))
    elastic = scaling_policy.make_scaling_policy(train.ScalingConfig(
        num_workers=8, min_workers=1, resources_per_worker={"CPU": 2}))
    short = scaling_policy.make_scaling_policy(train.ScalingConfig(
        num_workers=8, min_workers=3, resources_per_worker={"CPU": 2}))
    out["scaling"] = (
        type(fixed).__name__, fixed.initial_decision().world_size,
        fixed.recovery_decision().world_size, type(elastic).__name__,
        elastic.initial_decision().world_size,
        elastic.recovery_decision().world_size,
        elastic.grow_decision(1).world_size, elastic.grow_decision(8),
        short.recovery_decision(), short.initial_decision().world_size)
    return out


def _port_groups(root):
    """The port's process groups: two gloo workers retried on the same
    nodes after rank 1 fails while rank 0 is in a collective, or in a wait
    that outlasts the graceful stop (as a collective on a card does, which
    a peer's exit does not end: its group is aborted); and the rendezvous
    that ``DistributedConfig``'s fields set."""
    out = {}

    def retried_fn(config):
        import os
        import time

        import torch
        import torch.distributed as dist

        from ray_tpu_torch import train
        from ray_tpu_torch.train import collective

        rank = train.get_context().get_world_rank()
        pids = f"{config['marker']}{rank}"
        first = not os.path.exists(pids)
        with open(pids, "a") as f:
            f.write(f"{os.getpid()}\n")
        if first:
            if rank == 1:
                time.sleep(0.3)
                raise RuntimeError("rank 1 fails")
            if config["stuck_s"]:
                time.sleep(config["stuck_s"])   # no stop request ends it
                return
            dist.all_reduce(torch.ones(1))      # rank 1 never joins
        total = torch.full((1,), rank + 1.0)
        dist.all_reduce(total)
        train.report({"sum": float(total),
                      "pids": collective.allgather(os.getpid())})

    for case, stuck_s in (("collective", 0), ("stuck", 20)):
        marker = os.path.join(root, f"{case}-rank")
        r = ptrain.DataParallelTrainer(
            retried_fn, train_loop_config={"marker": marker,
                                           "stuck_s": stuck_s},
            scaling_config=ptrain.ScalingConfig(num_workers=2,
                                                placement_strategy="SPREAD"),
            run_config=ptrain.RunConfig(
                name=f"retried-{case}", storage_path=root,
                failure_config=ptrain.FailureConfig(max_failures=1)),
            backend_config=ptrain.DistributedConfig()).fit()
        attempts = []
        for rank in (0, 1):
            with open(f"{marker}{rank}") as f:
                attempts.append([int(p) for p in f.read().split()])
        out[f"retried-{case}"] = (r.metrics, r.error, attempts)

    def rendezvous_fn(config):
        import os

        import torch.distributed as dist

        from ray_tpu_torch import train

        up = dist.is_initialized()
        train.report({
            "group": up and [dist.get_backend(), dist.get_world_size()],
            "master": up and [os.environ["MASTER_ADDR"],
                              int(os.environ["MASTER_PORT"])],
            "env": os.environ.get("RT_TRAINER_TEST_FLAG")})

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    for case, dist_config in (
            ("pinned", ptrain.DistributedConfig(
                master_address="127.0.0.1", master_port=port,
                env_vars={"RT_TRAINER_TEST_FLAG": "set"})),
            ("off", ptrain.DistributedConfig(distributed_init=False))):
        r = ptrain.DataParallelTrainer(
            rendezvous_fn,
            scaling_config=ptrain.ScalingConfig(num_workers=2,
                                                placement_strategy="SPREAD"),
            run_config=ptrain.RunConfig(name=f"rendezvous-{case}",
                                        storage_path=root),
            backend_config=dist_config).fit()
        out[f"rendezvous-{case}"] = r.metrics
    out["port"] = port
    return out


def _seed_run(run_dir, np_params, family):
    """A step-0 checkpoint of the JAX init, as the port's train state,
    registered in ``run_dir``'s index."""
    kw = dict(MODELS[family])
    tcfg = convert.config_from_kwargs(kw, kw.pop("family"))
    opt = ptrain.OptimizerConfig(**LOOP["optimizer"]).build()
    params = convert.params_from_numpy(np_params, tcfg, device="cpu")
    state = ptrain.create_train_state(tcfg, opt, params=params, device="cpu")
    manager = ptrain.CheckpointManager(ptrain.CheckpointConfig(), run_dir)
    path = os.path.join(run_dir, "checkpoint_seed")
    ptrain.save_pytree(state, path)
    manager.register(path, {"step": 0})


def _port_loops(np_params, root):
    """(b) and (c): the default loop from the seeded checkpoint, on one
    worker and on two gloo workers over mesh data=2."""
    out = {}
    for family in MODELS:
        for label, workers, extra in (("one", 1, {}),
                                      ("mesh", 2, {"mesh": {"data": 2}})):
            name = f"{family}-{label}"
            _seed_run(os.path.join(root, name), np_params[family], family)
            r = ptrain.SPMDTrainer(
                train_loop_config=dict(LOOP, model=MODELS[family],
                                       device="cpu", **extra),
                scaling_config=ptrain.ScalingConfig(
                    num_workers=workers, placement_strategy="SPREAD"),
                run_config=ptrain.RunConfig(name=name, storage_path=root),
            ).fit()
            out[name] = ([m["loss"] for m in r.metrics_history],
                         [m["step"] for m in r.metrics_history],
                         int(ptrain.load_pytree(r.checkpoint.path)["step"]))
    return out


def _jax_reference():
    """Each family's JAX init (numpy) and the losses of 3 steps of
    ``make_train_step`` on the loop's numpy batches."""
    params, losses = {}, {}
    for family, kw in MODELS.items():
        kw = dict(kw)
        cls = JLlamaConfig if kw.pop("family") == "llama" else JGPT2Config
        cfg = cls(**dict(kw, dtype=jnp.dtype(kw["dtype"]).type))
        opt = jstep.OptimizerConfig(**LOOP["optimizer"]).build()
        state = jstep.create_train_state(cfg, opt, jax.random.PRNGKey(0))
        params[family] = jax.tree.map(np.asarray, state["params"])
        step = jstep.make_train_step(cfg, opt)
        rng = np.random.default_rng(LOOP["data_seed"])
        losses[family] = []
        for _ in range(LOOP["num_steps"]):
            toks = rng.integers(0, cfg.vocab_size, (LOOP["batch_size"],
                                                    LOOP["seq_len"] + 1),
                                dtype=np.int32)
            state, metrics = step(state, {"tokens": jnp.asarray(toks)})
            losses[family].append(float(metrics["loss"]))
    return params, losses


def _session():
    out = {}
    root = tempfile.mkdtemp(prefix="rt_trainer_test_")
    # the JAX steps compile while the reference's cluster runs its program
    jax_ref = ThreadPoolExecutor(1).submit(_jax_reference)
    try:
        with _env({**_SMALL_ARENA, **_REFERENCE_ENV}):
            try:
                ray_tpu.init(num_cpus=2, num_nodes=2)
                out["ray_tpu"] = _program(ray_tpu, rtrain, rtorch,
                                          os.path.join(root, "ref"))
            finally:
                ray_tpu.shutdown()
        np_params, out["jax_losses"] = jax_ref.result()
        with _env(_SMALL_ARENA):
            try:
                ray_tpu_torch.init(num_cpus=2, num_nodes=2)
                out["ray_tpu_torch"] = _program(
                    ray_tpu_torch, ptrain, ptorch, os.path.join(root, "port"))
                out["groups"] = _port_groups(os.path.join(root, "groups"))
                out["loops"] = _port_loops(np_params,
                                           os.path.join(root, "loops"))
            finally:
                ray_tpu_torch.shutdown()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


@pytest.fixture(scope="module")
def session(tmp_path_factory):
    return shared_results(tmp_path_factory, "torch_trainer", _session)


def _same(a, b):
    """Equal nests, numpy arrays bit for bit."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return (isinstance(a, np.ndarray) and isinstance(b, np.ndarray)
                and a.dtype == b.dtype and np.array_equal(a, b))
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return a == b


_KEYS = ["ranks", "topk", "resume", "exhausted", "collectives",
         "dataset_shard", "torch_ddp", "scaling"]


@pytest.mark.parametrize("key", _KEYS)
def test_program_equal(session, key):
    """Each part of the train program gives the same result, or the same
    exception class, through both packages."""
    assert _same(session["ray_tpu_torch"][key], session["ray_tpu"][key]), (
        session["ray_tpu_torch"][key], session["ray_tpu"][key])


def test_program_values(session):
    """The shared results are the program's own (not just equal)."""
    r = session["ray_tpu_torch"]
    assert r["ranks"] == ({"rank": 0, "world": 2, "cfg": 41}, None, 1)
    kept, latest, best, metrics, index = r["topk"]
    assert len(kept) == 2 and latest == "4" and best == "3"
    assert [(i, m["score"]) for i, m, _ in index] == [(3, 4), (4, 2)]
    assert r["resume"] == ({"step": 5, "resumed_from": 3},
                           [0, 1, 2, 3, 4, 5])
    assert r["exhausted"] == ("TrainingFailedError", True, True)
    assert r["collectives"] == {"got": {"master": "rank0-data"},
                                "all": [1, 11], "again": ["r0", "r1"],
                                "rank": 0}
    assert r["dataset_shard"] == {"shards": [[0, 2, 4, 6, 8, 10],
                                             [1, 3, 5, 7, 9]],
                                  "missing": None}
    assert r["torch_ddp"]["world"] == 2
    assert r["scaling"] == ("FixedScalingPolicy", 3, 3,
                            "ElasticScalingPolicy", 2, 2, 3, None, None, 3)


@pytest.mark.parametrize("case", ["collective", "stuck"])
def test_group_retried_on_the_same_nodes(session, case):
    """Rank 1 of two gloo workers fails while rank 0 is in a collective
    (which ends when rank 1 leaves the group), or in a wait that outlasts
    the graceful stop (its group is aborted under it): with
    max_failures=1 the group forms again in the same node processes and
    finishes."""
    metrics, error, attempts = session["groups"][f"retried-{case}"]
    assert error is None
    assert metrics["sum"] == 3.0
    for rank, pids in enumerate(attempts):
        assert len(pids) == 2 and pids[0] == pids[1] == metrics["pids"][rank]
    assert attempts[0][0] != attempts[1][0]


def test_distributed_config_rendezvous(session):
    """``master_address``/``master_port`` set the rendezvous, ``env_vars``
    reach the workers, and ``distributed_init=False`` forms no group."""
    groups = session["groups"]
    assert groups["rendezvous-pinned"] == {
        "group": ["gloo", 2], "master": ["127.0.0.1", groups["port"]],
        "env": "set"}
    assert groups["rendezvous-off"]["group"] is False


@pytest.mark.parametrize("family", list(MODELS))
def test_default_loop_matches_jax_step(session, family):
    """Three steps of the port's default loop, resumed from the JAX init,
    give the JAX step's losses within 2e-4 relative; the loop reports
    steps 1-3 and checkpoints step 3."""
    losses, steps, saved = session["loops"][f"{family}-one"]
    assert steps == [1, 2, 3] and saved == 3
    np.testing.assert_allclose(losses, session["jax_losses"][family],
                               rtol=2e-4)


@pytest.mark.parametrize("family", list(MODELS))
def test_default_loop_on_a_gloo_mesh(session, family):
    """Two gloo workers over mesh data=2 give one worker's losses within
    2e-5 relative."""
    one, steps, _ = session["loops"][f"{family}-one"]
    mesh, mesh_steps, saved = session["loops"][f"{family}-mesh"]
    assert mesh_steps == steps and saved == 3
    np.testing.assert_allclose(mesh, one, rtol=2e-5)


def test_pytree_round_trip(tmp_path):
    """A GPT-2 train state after a step (parameters, both AdamW moments,
    the per-parameter step counts, the step) and a bf16 leaf come back bit
    for bit, into a fresh state and without one."""
    kw = dict(MODELS["gpt2"])
    cfg = convert.config_from_kwargs(kw, kw.pop("family"))
    opt = ptrain.OptimizerConfig(**LOOP["optimizer"]).build()
    state = ptrain.create_train_state(cfg, opt,
                                      torch.Generator().manual_seed(0), "cpu")
    tokens = np.random.default_rng(0).integers(0, 128, (2, 17))
    state, _ = ptrain.make_train_step(cfg, opt)(state, {"tokens": tokens})
    state["extra"] = {"bf16": torch.randn(
        5, 3, generator=torch.Generator().manual_seed(1)).to(torch.bfloat16)}
    ptrain.save_pytree(state, str(tmp_path))

    fresh = ptrain.create_train_state(cfg, opt,
                                      torch.Generator().manual_seed(2), "cpu")
    fresh["extra"] = {"bf16": torch.zeros(5, 3, dtype=torch.bfloat16)}
    loaded = ptrain.load_pytree(str(tmp_path), target=fresh)
    raw = ptrain.load_pytree(str(tmp_path))
    assert loaded["params"] is fresh["params"]
    assert loaded["step"] == raw["step"] == state["step"] == 1
    want = dict(state["params"].named_parameters())
    got = dict(loaded["params"].named_parameters())
    assert got.keys() == want.keys() == raw["params"].keys()
    for n, p in want.items():
        assert torch.equal(got[n], p) and torch.equal(raw["params"][n], p)
    for kind in ("exp_avg", "exp_avg_sq", "step"):
        assert state["opt_state"][kind][0].abs().sum() > 0
        for x, y, z in zip(loaded["opt_state"][kind], raw["opt_state"][kind],
                           state["opt_state"][kind]):
            assert torch.equal(x, z) and torch.equal(y, z)
    for x in (loaded, raw):
        assert x["extra"]["bf16"].dtype == torch.bfloat16
        assert torch.equal(x["extra"]["bf16"], state["extra"]["bf16"])


_ARENA_SCRIPT = """
import gc, os, sys, weakref
import numpy as np
import ray_tpu_torch as rt

def mapped(name):
    with open("/proc/self/maps") as f:
        return [l.split()[-2] if l.rstrip().endswith("(deleted)")
                else l.split()[-1] for l in f if name in l]

mode = sys.argv[1]
rt.init(num_cpus=1, num_nodes=1)
name = f"rt_arena_{rt._internal_cluster().gcs_addr[1]}_{os.getuid()}"
ref = rt.put(np.arange(1 << 20, dtype=np.float32))
view = rt.get(ref)
out = {"before": len(mapped(name)) > 0, "aliases": view.base is not None}
if mode == "cycle":
    # two more views, unreachable in a reference cycle that only the
    # cyclic GC frees
    gc.disable()
    cycle = [rt.get(ref), rt.get(ref)]
    cycle.append(cycle)
    in_cycle = weakref.ref(cycle[0])
    del cycle
if mode == "drop":
    del view
del ref
rt.shutdown()
if mode == "cycle":
    out["cycle_alive"] = in_cycle() is not None
    # the GC starts on the next allocation, inside the finalizer of the
    # view that dies first, and frees the cycle's views there
    gc.set_threshold(1)
    gc.enable()
    del view
    out["cycle_freed"] = in_cycle() is None
    gc.set_threshold(700)
gc.collect()
out["after"] = mapped(name)
if mode == "keep":
    out["readable"] = float(view[12345])
    del view
    gc.collect()
    out["dropped"] = mapped(name)
print(out)
"""


@pytest.mark.parametrize("mode", ["drop", "keep", "cycle"])
def test_arena_unmapped_at_shutdown(mode):
    """After init, a put and a get, and shutdown(), the process maps no
    part of the session's arena; a view kept past shutdown() stays
    readable, and the mapping goes when it is dropped; views that the
    cyclic GC frees inside another view's finalizer neither deadlock it
    nor keep the mapping. In a subprocess: the mappings are the process's
    own."""
    env = dict(os.environ, PYTHONPATH=REPO, RT_ARENA_BYTES=str(64 << 20))
    proc = subprocess.run([sys.executable, "-c", _ARENA_SCRIPT, mode],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=60)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = eval(proc.stdout.strip().splitlines()[-1])
    assert out["before"] and out["aliases"]
    if mode == "keep":
        assert out["after"] and out["readable"] == 12345.0
        assert out["dropped"] == []
    else:
        assert out["after"] == []
    if mode == "cycle":
        assert out["cycle_alive"] and out["cycle_freed"]
