"""Serve and placement groups on both runtimes: ``ray_tpu`` and its port
``ray_tpu_torch``.

One program (``_program``) runs the behaviours of the reference's
``tests/test_serve.py`` and ``tests/test_serve_multiplex.py`` on each
runtime: deploy and call, a function deployment spread over replicas,
composition of handles, ``@serve.batch``, autoscaling up, a killed replica
replaced, the HTTP proxy, a gang deployment in a STRICT_PACK placement
group and its whole gang recycled when a member dies, local testing mode,
``max_queued_requests`` shedding, handles invalidated by a replica-change
push, multiplexed model ids, streams, the gRPC proxy (where ``grpc``
imports) and the placement-group API (``ready``, ``get_placement_group``,
``remove_placement_group``, bundle indexes that pin actors). Each runtime
runs it on a cluster of its own (2 nodes of 4 CPUs, 128 MiB arenas), one
after the other, with the reference's settings of
``tests/test_torch_cluster.py``; each part gives the same result, or the
same exception class, on both.

On the port's cluster the OpenAI apps then serve the tiny GPT-2 in f32 on
the CPU (``device="cpu"``), on weights converted from the JAX init: the
app over HTTP (a completion and a stream), the prefill/decode app and the
data-parallel app of 2 replicas. Their answers equal the JAX package's
in-process ``LLMServer`` on the same weights, apart from ``id`` and
``created``. Under pytest-xdist the session is computed once
(``test_torch_ranks.shared_results``); deployments are defined inside
``_program`` so that cloudpickle ships them by value and no node imports
this module (and JAX through it).
"""
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import ray_tpu
import ray_tpu_torch
from ray_tpu.llm import LLMConfig as JaxLLMConfig
from ray_tpu.llm import LLMServer as JaxLLMServer
from ray_tpu.models import gpt2 as jgpt2
from tests.test_torch_cluster import (
    _REFERENCE_ENV,
    _SMALL_ARENA,
    _alive,
    _env,
)
from tests.test_torch_ranks import shared_results

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _program(rt):
    """The shared program; ``rt`` is ``ray_tpu`` or ``ray_tpu_torch``."""
    import importlib
    import urllib.error
    import urllib.request

    serve = importlib.import_module(rt.__name__ + ".serve")
    pgs = importlib.import_module(rt.__name__ + ".util.placement_group")
    strategies = importlib.import_module(
        rt.__name__ + ".util.scheduling_strategies")
    controller_mod = importlib.import_module(rt.__name__ + ".serve.controller")
    out = {}

    def controller():
        return rt.get_actor(controller_mod.CONTROLLER_NAME)

    def wait_until(pred, limit=30.0):
        deadline = time.monotonic() + limit
        while time.monotonic() < deadline:
            if pred():
                return True
            time.sleep(0.1)
        return False

    def part(key, fn):
        try:
            out[key] = fn()
        except Exception as e:
            out[key] = ("raised", type(e).__name__)

    # deploy and call
    @serve.deployment(num_replicas=2)
    class Echo:
        def __call__(self, x):
            return {"echo": x}

        def shout(self, x):
            return str(x).upper()

    def deploy_call():
        h = serve.run(Echo.bind(), name="echo_app")
        got = (h.remote(41).result(timeout=30),
               h.shout.remote("hi").result(timeout=30),
               serve.status()["Echo"]["running"])
        serve.delete("echo_app")
        return got

    part("deploy_call", deploy_call)

    # a function deployment spread over replicas
    @serve.deployment(num_replicas=2)
    def where(x):
        import os
        import threading

        return x, f"{os.getpid()}:{threading.get_ident()}"

    def function_spread():
        h = serve.run(where.bind(), name="fn_app")
        got = [h.remote(i).result(timeout=30) for i in range(8)]
        serve.delete("fn_app")
        return [x for x, _ in got], len({w for _, w in got}) >= 1

    part("function_spread", function_spread)

    # composition of handles
    @serve.deployment
    class Adder:
        def __call__(self, x):
            return x + 1

    @serve.deployment
    class Chain:
        def __init__(self, adder):
            self.adder = adder

        def __call__(self, x):
            return self.adder.remote(x).result(timeout=30) * 10

    def composition():
        h = serve.run(Chain.bind(Adder.bind()), name="chain")
        got = h.remote(4).result(timeout=30)
        serve.delete("chain")
        return got

    part("composition", composition)

    # @serve.batch
    @serve.deployment
    class Batched:
        def __init__(self):
            self.sizes = []

        @serve.batch(max_batch_size=4, batch_wait_timeout_s=0.2)
        async def handle_batch(self, items):
            self.sizes.append(len(items))
            return [i * 2 for i in items]

        async def __call__(self, x):
            return await self.handle_batch(x)

        def batch_sizes(self):
            return self.sizes

    def batch():
        h = serve.run(Batched.bind(), name="batched")
        resps = [h.remote(i) for i in range(8)]
        got = [r.result(timeout=30) for r in resps]
        sizes = h.batch_sizes.remote().result(timeout=30)
        serve.delete("batched")
        return got, max(sizes) > 1, sum(sizes)

    part("batch", batch)

    # autoscaling up under a queue deeper than the target
    @serve.deployment(
        autoscaling_config={"min_replicas": 1, "max_replicas": 3,
                            "target_ongoing_requests": 1.0,
                            "upscale_delay_s": 0.1},
        num_replicas=1)
    class Slow:
        async def __call__(self, x):
            import asyncio

            await asyncio.sleep(0.5)
            return x

    def autoscale():
        h = serve.run(Slow.bind(), name="slow")
        resps = [h.remote(i) for i in range(8)]
        scaled = wait_until(lambda: serve.status()["Slow"]["running"] > 1, 20)
        got = [r.result(timeout=60) for r in resps]
        serve.delete("slow")
        return scaled, got

    part("autoscale_up", autoscale)

    # a killed replica is replaced by the reconcile loop
    @serve.deployment(num_replicas=2)
    class Fragile:
        def __call__(self, x):
            return x

    def replica_death():
        h = serve.run(Fragile.bind(), name="fragile")
        first = h.remote(1).result(timeout=30)
        before = rt.get(controller().get_replicas.remote("Fragile"),
                        timeout=30)
        rt.kill(rt.get(controller().get_handles.remote("Fragile"),
                       timeout=30)[0])
        replaced = wait_until(lambda: len(set(rt.get(
            controller().get_replicas.remote("Fragile"), timeout=30))
            - set(before)) >= 1 and serve.status()["Fragile"]["running"] == 2)
        got = [h.remote(i).result(timeout=30) for i in range(4)]
        serve.delete("fragile")
        return first, replaced, got

    part("replica_death", replica_death)

    # the HTTP proxy: a routed request, and 404 off the routes
    @serve.deployment
    class Api:
        def __call__(self, request):
            q = request["query"]
            return {"path": request["path"], "x": int(q.get("x", 0)) * 2}

    def http_proxy():
        serve.run(Api.bind(), name="api", route_prefix="/api")
        port = serve.start_http_proxy(port=0)
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/api/predict?x=21", timeout=30) as r:
            got = json.loads(r.read())
        try:
            urllib.request.urlopen(f"http://127.0.0.1:{port}/nope",
                                   timeout=30)
            code = 200
        except urllib.error.HTTPError as e:
            code = e.code
        serve.delete("api")
        return got, code

    part("http_proxy", http_proxy)

    # a gang replica in a STRICT_PACK placement group; a member's death
    # recycles the whole gang
    @serve.deployment(num_replicas=1, gang_size=2, gang_strategy="STRICT_PACK",
                      ray_actor_options={"num_cpus": 1})
    class GangModel:
        def __init__(self):
            self.ctx = serve.get_gang_context()

        def __call__(self, x):
            return {"rank": self.ctx.rank, "world_size": self.ctx.world_size,
                    "value": x * 2}

    def gang():
        h = serve.run(GangModel.bind(), name="gang_app")
        first = h.remote(21).result(timeout=60)
        from_worker = importlib.import_module(rt.__name__ + "._private.worker")
        w = from_worker.get_global_worker()
        groups = [(len(p["bundles"]), p["strategy"]) for p in w.run_sync(
            w.gcs.call("list_pgs", {}))[0]["pgs"] if p["state"] == "CREATED"]
        before = rt.get(controller().get_replicas.remote("GangModel"),
                        timeout=30)
        rt.kill(rt.get(controller().get_handles.remote("GangModel"),
                       timeout=30)[0])

        def recycled():
            now = rt.get(controller().get_replicas.remote("GangModel"),
                         timeout=30)
            if len(now) != 1 or now == before:
                return False
            try:
                return h.remote(2).result(timeout=10)["value"] == 4
            except Exception:
                return False

        again = wait_until(recycled, 60)
        last = h.remote(3).result(timeout=30)["value"]
        serve.delete("gang_app")
        return first, sorted(groups), again, last

    part("gang", gang)

    # local testing mode: the graph in this process, no actors
    def local_testing():
        @serve.deployment(user_config={"suffix": "!"})
        class Shouter:
            def __init__(self, downstream=None):
                self.suffix = ""
                self.downstream = downstream

            def reconfigure(self, cfg):
                self.suffix = cfg["suffix"]

            def __call__(self, text):
                if self.downstream is not None:
                    text = self.downstream.remote(text).result(timeout=30)
                return text.upper() + self.suffix

            def whisper(self, text):
                return text.lower()

        @serve.deployment(name="inner")
        class Inner:
            def __call__(self, text):
                return f"<{text}>"

        h = serve.run(Shouter.bind(Inner.bind()), local_testing_mode=True)
        return (h.remote("hey").result(timeout=30),
                h.whisper.remote("LOUD").result(timeout=30))

    part("local_testing", local_testing)

    # max_queued_requests sheds load at the handle
    @serve.deployment(num_replicas=1, max_ongoing_requests=1,
                      max_queued_requests=2)
    class Busy:
        def __call__(self, x):
            time.sleep(1.0)
            return x

    def shed():
        h = serve.run(Busy.bind(), name="busy_app")
        admitted = [h.remote(i) for i in range(2)]
        raised = None
        try:
            for i in range(10):
                admitted.append(h.remote(100 + i))
        except Exception as e:
            raised = (type(e).__name__, "max_queued" in str(e))
        got = admitted[0].result(timeout=30)
        for r in admitted[1:]:
            r.result(timeout=30)
        serve.delete("busy_app")
        return raised, got, len(admitted) < 12

    part("max_queued_shed", shed)

    # a replica-change push invalidates the handle's replica set
    @serve.deployment(num_replicas=1)
    def ident(x):
        return x

    def push():
        h = serve.run(ident.bind(), name="scale_app")
        first = h.remote(1).result(timeout=30)
        n0 = len(h._router._replicas)
        serve.run(ident.options(num_replicas=3).bind(), name="scale_app")
        deadline = time.monotonic() + 4.0
        while time.monotonic() < deadline and len(h._router._replicas) < 3:
            h.remote(2).result(timeout=30)
            time.sleep(0.1)
        got = (first, n0, len(h._router._replicas))
        serve.delete("scale_app")
        return got

    part("push_invalidate", push)

    # multiplexed model ids: the per-replica LRU, the request's id, and the
    # router sticking to the replica that holds a model
    @serve.deployment(num_replicas=1)
    class MultiModel:
        def __init__(self):
            self.loads = []

        @serve.multiplexed(max_num_models_per_replica=2)
        async def get_model(self, model_id: str):
            self.loads.append(model_id)
            return {"name": model_id}

        async def __call__(self, x):
            import os
            import threading

            model_id = serve.get_multiplexed_model_id()
            model = await self.get_model(model_id)
            return {"model": model["name"], "ctx": model_id,
                    "loads": list(self.loads), "x": x,
                    "where": (os.getpid(), id(self))}

    def multiplex():
        h = serve.run(MultiModel.bind(), name="mux")
        seen = []
        for i, mid in enumerate(["m1", "m1", "m2", "m3", "m1"]):
            o = h.options(multiplexed_model_id=mid).remote(i).result(
                timeout=30)
            seen.append((o["model"], o["ctx"], o["loads"], o["x"]))
        serve.delete("mux")
        h = serve.run(MultiModel.options(name="MultiModel2",
                                         num_replicas=2).bind(), name="mux2")
        first = h.options(multiplexed_model_id="m7").remote(0).result(
            timeout=30)
        # the router learns which replica holds m7 at its next refresh
        # (every 5 s, or at a replica-change push): now
        h._router._refresh(force=True)
        outs = [h.options(multiplexed_model_id="m7").remote(i).result(
            timeout=30) for i in range(8)]
        serve.delete("mux2")
        return (seen, all(o["loads"].count("m7") == 1 for o in outs),
                {o["where"] for o in outs} == {first["where"]})

    part("multiplex", multiplex)

    # streams: a generator method through the handle, a multiplexed one
    @serve.deployment
    class Streamer:
        @serve.multiplexed(max_num_models_per_replica=2)
        async def get_model(self, model_id: str):
            return model_id.upper()

        async def tokens(self, n: int):
            model = await self.get_model(serve.get_multiplexed_model_id())
            for i in range(n):
                yield f"{model}:{i}"

        def stream_sync(self, n: int):
            for i in range(n):
                yield {"i": i}

        async def stream_async(self, n: int):
            for i in range(n):
                yield i * 10

    def streams():
        h = serve.run(Streamer.bind(), name="streamer")
        mux = list(h.options(multiplexed_model_id="mA", stream=True)
                   .tokens.remote(3).result(timeout=30))
        sync = [c["i"] for c in h.options(stream=True).stream_sync.remote(
            40).result(timeout=30)]
        asy = list(h.stream_async.remote(5).result(timeout=30))
        serve.delete("streamer")
        return mux, sync, asy

    part("streams", streams)

    # the gRPC proxy: unary, a named method, status codes, a stream
    def grpc_proxy():
        import grpc
        import msgpack

        @serve.deployment
        class GApi:
            def __call__(self, data):
                return {"doubled": data["x"] * 2}

            def extra(self, data):
                return {"method": "extra", "x": data["x"]}

        @serve.deployment
        class Gen:
            def __call__(self, data):
                for i in range(int(data["n"])):
                    yield {"i": i}

        serve.run(GApi.bind(), name="gapi", route_prefix="/gapi")
        serve.run(Gen.bind(), name="ggen", route_prefix="/ggen")
        port = serve.start_grpc_proxy(port=0)
        chan = grpc.insecure_channel(f"127.0.0.1:{port}")
        try:
            predict = chan.unary_unary("/rayserve.v1.RayServe/Predict",
                                       request_serializer=lambda b: b,
                                       response_deserializer=lambda b: b)
            stream = chan.unary_stream("/rayserve.v1.RayServe/PredictStream",
                                       request_serializer=lambda b: b,
                                       response_deserializer=lambda b: b)

            def call(msg):
                try:
                    return msgpack.unpackb(predict(msgpack.packb(
                        msg, use_bin_type=True), timeout=60), raw=False)
                except grpc.RpcError as e:
                    return str(e.code())

            got = [call({"route": "/gapi", "data": {"x": 21}}),
                   call({"route": "/gapi", "method": "extra",
                         "data": {"x": 7}}),
                   call({"route": "/nope", "data": None}),
                   call({"route": "/gapi", "data": {}})]
            chunks = [msgpack.unpackb(c, raw=False) for c in stream(
                msgpack.packb({"route": "/ggen", "data": {"n": 4}},
                              use_bin_type=True), timeout=60)]
        finally:
            chan.close()
        serve.delete("gapi")
        serve.delete("ggen")
        return got, chunks

    part("grpc_proxy", grpc_proxy)

    # the placement-group API
    @rt.remote(num_cpus=1)
    class Where:
        def node(self):
            return rt.get_runtime_context().get_node_id()

    def placement():
        PG = strategies.PlacementGroupSchedulingStrategy
        got = {}
        for strategy in ("STRICT_PACK", "STRICT_SPREAD"):
            pg = pgs.placement_group([{"CPU": 1}, {"CPU": 1}],
                                     strategy=strategy)
            ready = pg.ready(timeout=30)
            found = pgs.get_placement_group(pg.id)
            actors = [Where.options(scheduling_strategy=PG(
                placement_group=pg, placement_group_bundle_index=i)).remote()
                for i in range(2)]
            nodes = rt.get([a.node.remote() for a in actors], timeout=30)
            for a in actors:
                rt.kill(a)
            pgs.remove_placement_group(pg)
            gone = pgs.get_placement_group(pg.id)
            got[strategy] = (
                ready, found.id == pg.id, found.strategy, found.bundles,
                nodes[0] == nodes[1],
                None if gone is None else gone.strategy,
                pg.ready(timeout=1))
        try:
            pgs.placement_group([], strategy="PACK")
        except Exception as e:
            got["empty"] = type(e).__name__
        return got

    part("placement_group", placement)
    serve.shutdown()
    return out


def _np_params(small):
    """The JAX init of the tiny GPT-2 with its block projections and wpe
    x3 (as tests/test_torch_serving.py), as numpy."""
    cfg = JaxLLMConfig(**small).model_config()
    tree = jax.tree.map(np.array, jgpt2.init_params(cfg, jax.random.PRNGKey(0)))
    for name in ("qkv_w", "proj_w", "fc_w", "out_w"):
        tree["blocks"][name] *= 3.0
    tree["wpe"] *= 3.0
    return tree


_SMALL = dict(vocab_size=300, max_seq_len=128, num_layers=2, num_heads=2,
              embed_dim=64, dtype="float32", max_batch_slots=4,
              prefill_buckets=(16, 32, 64))
_PAYLOADS = [{"prompt": "Hello there", "max_tokens": 8},
             {"prompt": "Serve on both", "max_tokens": 6, "logprobs": 2},
             {"prompt": "abc", "max_tokens": 5, "temperature": 0.8,
              "top_k": 20, "seed": 3}]


def _strip(resp):
    return {k: v for k, v in resp.items() if k not in ("id", "created")}


def _same(got, want, tol=1e-5):
    """Equal, apart from floats (the logprob values), which agree within
    f32 rounding, as in tests/test_torch_serving.py."""
    if isinstance(want, float):
        return isinstance(got, float) and abs(got - want) <= tol
    if isinstance(want, dict):
        return (isinstance(got, dict) and got.keys() == want.keys()
                and all(_same(got[k], want[k], tol) for k in want))
    if isinstance(want, (list, tuple)):
        return (type(got) is type(want) and len(got) == len(want)
                and all(_same(g, w, tol) for g, w in zip(got, want)))
    return got == want


def _sse(body):
    """SSE text -> (chunks without id/created, last line)."""
    lines = [ln + "\n\n" for ln in body.split("\n\n") if ln]
    return ([_strip(json.loads(ln[len("data: "):])) for ln in lines[:-1]],
            lines[-1])


def _llm_apps(rt, np_params):
    """The OpenAI apps on the port's cluster, on the CPU."""
    import urllib.request

    from ray_tpu_torch import serve
    from ray_tpu_torch.llm import (
        LLMConfig,
        build_dp_openai_app,
        build_openai_app,
        build_pd_openai_app,
    )
    from ray_tpu_torch.models import convert

    config = LLMConfig(**_SMALL)
    params = convert.params_from_numpy(np_params, config.model_config(), "cpu")
    out = {}

    def post(port, path, payload):
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}{path}",
            data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.headers.get("Content-Type", ""), r.read().decode()

    serve.run(build_openai_app(config, params=params, device="cpu"),
              name="llm", route_prefix="/v1")
    port = serve.start_http_proxy(port=0)
    out["http"] = [_strip(json.loads(post(port, "/v1/completions", p)[1]))
                   for p in _PAYLOADS]
    ctype, body = post(port, "/v1/completions",
                       dict(_PAYLOADS[0], stream=True))
    out["http_stream"] = (ctype.split(";")[0], _sse(body))
    serve.delete("llm")
    out["engines_after_delete"] = _engines_left(rt)

    h = serve.run(build_pd_openai_app(config, params=params, device="cpu"),
                  name="pd", route_prefix="/pd")
    out["pd"] = [_strip(h.remote(p).result(timeout=120)) for p in _PAYLOADS]
    serve.delete("pd")

    h = serve.run(build_dp_openai_app(config, num_replicas=2, params=params,
                                      device="cpu"),
                  name="dp", route_prefix="/dp")
    resps = [h.remote(p) for p in _PAYLOADS * 2]
    out["dp"] = [_strip(r.result(timeout=120)) for r in resps]
    out["dp_running"] = serve.status()["LLMServer"]["running"]
    serve.delete("dp")
    serve.shutdown()
    return out


def _engines_left(rt, limit=15.0):
    """The engines alive in the node processes (after a collection),
    polled until none is or ``limit`` seconds passed: less than the 30 s an
    idle engine's loop takes to park and let go of it."""
    from ray_tpu_torch.util.scheduling_strategies import (
        NodeAffinitySchedulingStrategy,
    )

    @rt.remote(num_cpus=0)
    def engines():
        import gc

        from ray_tpu_torch.llm.engine import DecodeEngine

        gc.collect()
        return sum(type(o) is DecodeEngine for o in gc.get_objects())

    nodes = [n["node_id"] for n in rt.nodes() if n["alive"]]
    deadline = time.monotonic() + limit
    while True:
        left = rt.get([engines.options(
            scheduling_strategy=NodeAffinitySchedulingStrategy(n)).remote()
            for n in nodes], timeout=60)
        if not any(left) or time.monotonic() > deadline:
            return left
        time.sleep(0.25)


def _jax_reference(np_params):
    """The JAX package's in-process LLMServer on the same weights."""
    srv = JaxLLMServer(dict(_SMALL), jax.tree.map(jnp.asarray, np_params))
    try:
        return {"completions": [_strip(srv.completions(p)) for p in _PAYLOADS],
                "stream": _sse("".join(srv.completions_stream(_PAYLOADS[0])))}
    finally:
        srv.engine.shutdown()


def _rings_of(pids):
    return sorted(n for n in os.listdir("/dev/shm")
                  if n.startswith(tuple(f"rtring_{p}_" for p in pids)))


def _session():
    out = {}
    with _env({**_SMALL_ARENA, **_REFERENCE_ENV}):
        try:
            ray_tpu.init(num_cpus=4, num_nodes=2)
            cluster = ray_tpu._internal_cluster()
            ref_pids = [n.proc.pid for n in (*cluster.nodes, *cluster.warm)]
            out["ray_tpu"] = _program(ray_tpu)
        finally:
            ray_tpu.shutdown()
    # the reference's nodes leave the names of the rings they made (the
    # port's fault, fixed in its worker_main): drop them here
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline and any(_alive(p) for p in ref_pids):
        time.sleep(0.1)
    for name in _rings_of(ref_pids):
        try:
            os.unlink(os.path.join("/dev/shm", name))
        except OSError:
            pass
    np_params = _np_params(_SMALL)
    with _env(_SMALL_ARENA):
        try:
            ray_tpu_torch.init(num_cpus=4, num_nodes=2)
            cluster = ray_tpu_torch._internal_cluster()
            pids = [n.proc.pid for n in (*cluster.nodes, *cluster.warm)]
            out["ray_tpu_torch"] = _program(ray_tpu_torch)
            out["llm"] = _llm_apps(ray_tpu_torch, np_params)
        finally:
            ray_tpu_torch.shutdown()
    out["jax_llm"] = _jax_reference(np_params)
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline and any(_alive(p) for p in pids):
        time.sleep(0.1)
    out["alive_after"] = [p for p in pids if _alive(p)]
    out["rings_after"] = _rings_of(pids)
    return out


@pytest.fixture(scope="module")
def session(tmp_path_factory):
    return shared_results(tmp_path_factory, "torch_serve", _session)


_KEYS = ["deploy_call", "function_spread", "composition", "batch",
         "autoscale_up", "replica_death", "http_proxy", "gang",
         "local_testing", "max_queued_shed", "push_invalidate", "multiplex",
         "streams", "grpc_proxy", "placement_group"]


@pytest.mark.parametrize("key", _KEYS)
def test_program_equal(session, key):
    """Each part of the program gives the same result, or the same
    exception class, on both runtimes."""
    if key == "grpc_proxy":
        pytest.importorskip("grpc")
    assert session["ray_tpu_torch"][key] == session["ray_tpu"][key]


def test_program_values(session):
    """The shared results are the program's own (not just equal)."""
    r = session["ray_tpu_torch"]
    assert r["deploy_call"] == ({"echo": 41}, "HI", 2)
    assert r["function_spread"] == (list(range(8)), True)
    assert r["composition"] == 50
    assert r["batch"] == ([i * 2 for i in range(8)], True, 8)
    assert r["autoscale_up"] == (True, list(range(8)))
    assert r["replica_death"] == (1, True, [0, 1, 2, 3])
    assert r["http_proxy"] == ({"path": "/api/predict", "x": 42}, 404)
    assert r["gang"] == ({"rank": 0, "world_size": 2, "value": 42},
                         [(2, "STRICT_PACK")], True, 6)
    assert r["local_testing"] == ("<HEY>!", "loud")
    assert r["max_queued_shed"] == (("BackPressureError", True), 0, True)
    assert r["push_invalidate"] == (1, 1, 3)
    seen, never_reloaded, sticky = r["multiplex"]
    assert [s[2] for s in seen] == [["m1"], ["m1"], ["m1", "m2"],
                                    ["m1", "m2", "m3"],
                                    ["m1", "m2", "m3", "m1"]]
    assert all(s[0] == s[1] for s in seen) and never_reloaded and sticky
    assert r["streams"] == (["MA:0", "MA:1", "MA:2"], list(range(40)),
                            [0, 10, 20, 30, 40])
    for strategy, together in (("STRICT_PACK", True), ("STRICT_SPREAD", False)):
        # a removed group stays in the head's table, and is never ready
        assert r["placement_group"][strategy] == (
            True, True, strategy, [{"CPU": 1.0}, {"CPU": 1.0}], together,
            strategy, False)
    assert r["placement_group"]["empty"] == "ValueError"


def test_grpc_proxy_values(session):
    pytest.importorskip("grpc")
    got, chunks = session["ray_tpu_torch"]["grpc_proxy"]
    assert got == [{"doubled": 42}, {"method": "extra", "x": 7},
                   "StatusCode.NOT_FOUND", "StatusCode.INTERNAL"]
    assert chunks == [{"i": i} for i in range(4)]


def test_openai_app_over_http_matches_jax(session):
    """``build_openai_app`` on a replica, through the HTTP proxy: each
    completion and the stream equal the JAX LLMServer's in process."""
    llm, ref = session["llm"], session["jax_llm"]
    assert _same(llm["http"], ref["completions"])
    assert llm["http"][0]["usage"]["completion_tokens"] >= 1
    ctype, (chunks, last) = llm["http_stream"]
    assert ctype == "text/event-stream" and last == "data: [DONE]\n\n"
    assert (chunks, last) == ref["stream"]
    assert "".join(c["choices"][0]["text"] for c in chunks) == \
        ref["completions"][0]["choices"][0]["text"]


def test_pd_app_matches_jax(session):
    """``build_pd_openai_app``: the prefill and decode replicas' answers
    equal the monolithic JAX LLMServer's, choice for choice."""
    llm, ref = session["llm"], session["jax_llm"]
    for got, want in zip(llm["pd"], ref["completions"]):
        assert got["disaggregated"] is True
        assert _same(got["choices"], want["choices"])
        assert got["usage"] == want["usage"]


def test_dp_app_matches_jax(session):
    """``build_dp_openai_app`` with 2 replicas: every answer equals the JAX
    LLMServer's."""
    llm, ref = session["llm"], session["jax_llm"]
    assert llm["dp_running"] == 2
    assert _same(llm["dp"], ref["completions"] * 2)


def test_deleted_replica_lets_go_of_its_engine(session):
    """``serve.delete`` stops the OpenAI app's replica, whose server shuts
    its engine down first: no engine (weights, caches, graphs) is left in
    any node process well before an idle engine would park."""
    assert not any(session["llm"]["engines_after_delete"])


def test_no_process_or_ring_left(session):
    """After serve.shutdown() and shutdown() no node process of the port's
    session runs (the replicas, proxies and controller are threads in
    them), and no shm ring that they made is left."""
    assert session["alive_after"] == []
    assert session["rings_after"] == []


def test_app_default_device_raises_without_cuda():
    """The LLM app functions default to the card and raise without CUDA,
    before anything is deployed."""
    import torch

    from ray_tpu_torch.llm import (
        LLMConfig,
        build_dp_openai_app,
        build_openai_app,
        build_pd_openai_app,
    )

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    config = LLMConfig(**_SMALL)
    for build in (build_openai_app, build_dp_openai_app, build_pd_openai_app):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            build(config)


_IMPORT_PROBE = """
import os, sys, threading
import ray_tpu_torch.serve
import ray_tpu_torch.util.placement_group
kids = []
for tid in os.listdir(f"/proc/{os.getpid()}/task"):
    with open(f"/proc/{os.getpid()}/task/{tid}/children") as f:
        kids += f.read().split()
print([t.name for t in threading.enumerate()], kids,
      sorted({m.split(".")[0] for m in sys.modules} & {"jax", "ray_tpu"}))
"""


def test_serve_import_starts_nothing():
    """Importing the port's serve and util.placement_group in a fresh
    interpreter starts no thread and no child process, and loads neither
    JAX nor ray_tpu."""
    proc = subprocess.run([sys.executable, "-c", _IMPORT_PROBE], cwd=REPO,
                          env=dict(os.environ, PYTHONPATH=REPO),
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().splitlines()[-1] == "['MainThread'] [] []"
