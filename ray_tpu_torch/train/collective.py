"""Control-plane collectives among train workers.

Counterpart of ``ray_tpu/train/collective.py``, over the port's head KV
(``get_global_worker().gcs``). Reference analog:
``python/ray/train/collective/collectives.py`` — ``broadcast_from_rank_zero``
(:16) and ``barrier`` (:59), used for
rendezvous-style coordination (master address exchange, phase sync) OUTSIDE
the data-plane collectives. Transport here is the head's KV (namespaced per
experiment + attempt + call sequence) — small control payloads only.
"""
from __future__ import annotations

import time
from typing import Any

import cloudpickle

from ray_tpu_torch.train.context import get_context

_POLL_S = 0.02


def _seq(ctx, name: str) -> int:
    seqs = getattr(ctx, "_collective_seqs", None)
    if seqs is None:
        seqs = ctx._collective_seqs = {}
    n = seqs.get(name, 0)
    seqs[name] = n + 1
    return n


def namespace(experiment_name: str, run_nonce: str) -> str:
    """KV namespace for one worker-group start (shutdown reclaims it)."""
    return f"__train_collective:{experiment_name}:{run_nonce}:"


def _ns(ctx) -> str:
    # run_nonce is fresh per worker-group start: re-runs and elastic
    # restarts can never observe a previous group's rendezvous keys. The
    # attempt lives in the key prefix (one namespace per group start, so
    # shutdown can reclaim it wholesale).
    nonce = getattr(ctx, "_run_nonce", "")
    return namespace(ctx.get_experiment_name(), nonce)


def _key(ctx, rest: str) -> str:
    return f"{ctx._attempt}:{rest}"



def broadcast_from_rank_zero(data: Any = None, *, name: str = "bcast",
                             timeout_s: float = 60.0) -> Any:
    """Rank 0's ``data`` returned on every rank. All ranks must call in the
    same order (per-name call sequence keys the rendezvous)."""
    from ray_tpu_torch._private.worker import get_global_worker

    ctx = get_context()
    w = get_global_worker()
    key = _key(ctx, f"{name}:{_seq(ctx, 'b:' + name)}")
    ns = _ns(ctx)
    if ctx.get_world_rank() == 0:
        w.run_sync(w.gcs.call(
            "kv_put", {"ns": ns, "key": key}, [cloudpickle.dumps(data)]
        ))
        return data
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        h, frames = w.run_sync(w.gcs.call("kv_get", {"ns": ns, "key": key}))
        if h.get("found"):
            return cloudpickle.loads(frames[0])
        time.sleep(_POLL_S)
    raise TimeoutError(f"broadcast_from_rank_zero({name}) timed out")


def allgather(data: Any = None, *, name: str = "allgather",
              timeout_s: float = 60.0) -> list:
    """Every rank's ``data``, rank-ordered, returned on every rank (used
    for rendezvous that needs all worker addresses, e.g. TF_CONFIG cluster
    specs). Same same-order contract as the other collectives."""
    from ray_tpu_torch._private.worker import get_global_worker

    ctx = get_context()
    w = get_global_worker()
    gen = _seq(ctx, "g:" + name)
    ns = _ns(ctx)
    prefix = _key(ctx, f"ag:{name}:{gen}:")
    w.run_sync(w.gcs.call(
        "kv_put", {"ns": ns, "key": f"{prefix}{ctx.get_world_rank()}"},
        [cloudpickle.dumps(data)],
    ))
    deadline = time.monotonic() + timeout_s
    world = ctx.get_world_size()
    while time.monotonic() < deadline:
        h, _ = w.run_sync(w.gcs.call("kv_keys", {"ns": ns, "prefix": prefix}))
        if len(h.get("keys", [])) >= world:
            out = []
            for r in range(world):
                hh, frames = w.run_sync(w.gcs.call(
                    "kv_get", {"ns": ns, "key": f"{prefix}{r}"}
                ))
                if not hh.get("found"):
                    raise RuntimeError(f"allgather({name}): rank {r} vanished")
                out.append(cloudpickle.loads(frames[0]))
            return out
        time.sleep(_POLL_S)
    raise TimeoutError(f"allgather({name}) timed out")


def barrier(*, name: str = "barrier", timeout_s: float = 60.0):
    """Blocks until every rank of the group arrives (same-order contract)."""
    from ray_tpu_torch._private.worker import get_global_worker

    ctx = get_context()
    w = get_global_worker()
    gen = _seq(ctx, "s:" + name)
    ns = _ns(ctx)
    prefix = _key(ctx, f"{name}:{gen}:")
    w.run_sync(w.gcs.call(
        "kv_put", {"ns": ns, "key": f"{prefix}{ctx.get_world_rank()}"}, [b""]
    ))
    deadline = time.monotonic() + timeout_s
    world = ctx.get_world_size()
    while time.monotonic() < deadline:
        h, _ = w.run_sync(w.gcs.call("kv_keys", {"ns": ns, "prefix": prefix}))
        if len(h.get("keys", [])) >= world:
            return
        time.sleep(_POLL_S)
    raise TimeoutError(f"barrier({name}) timed out")
