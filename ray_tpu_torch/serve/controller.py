"""Serve controller actor: deployment/replica state machines + autoscaling.

Reference analogs: ``python/ray/serve/_private/controller.py:126``
(ServeController, reconcile loop :506), ``deployment_state.py`` (replica
state machine), ``autoscaling_policy.py`` (+ ``_private/autoscaling_state``:
scale on ongoing-request metrics), ``_private/deployment_scheduler.py``.
Runs as a named actor; handles query it for the live replica set.

Counterpart of ``ray_tpu/serve/controller.py``,
over the port's runtime core.
"""
from __future__ import annotations

import asyncio
import logging
import time
from typing import Any, Dict, List, Optional

logger = logging.getLogger(__name__)

CONTROLLER_NAME = "__serve_controller"
# How long a replica's instance may take to let go of what it holds
# (``Replica.prepare_for_shutdown``) before the replica is killed.
_SHUTDOWN_HOOK_S = 10.0


class _DeploymentState:
    def __init__(self, name: str, spec: dict):
        self.name = name
        self.spec = spec             # serialized target + config fields
        self.replicas: List[dict] = []  # {"actor": handle, "id": str}
        # Replicas removed from the routable set but still finishing
        # in-flight requests (graceful drain); entries carry
        # "drain_deadline" and "drain_zero" (consecutive idle probes).
        self.draining: List[dict] = []
        self.target_replicas = spec["num_replicas"]
        self.counter = 0
        self.last_scale_up = 0.0
        self.last_scale_down = 0.0
        self.deleted = False


class ServeController:
    """Async actor: one reconcile loop drives every deployment."""

    HANDLE_METRIC_TTL_S = 3.0

    def __init__(self):
        self._deployments: Dict[str, _DeploymentState] = {}
        self._apps: Dict[str, List[str]] = {}  # app name -> deployment names
        self._routes: Dict[str, str] = {}      # route_prefix -> deployment
        # deployment -> {handle_id: (ongoing, monotonic ts)}; pushed by
        # handle routers (queued + executing requests they have issued).
        self._handle_metrics: Dict[str, Dict[str, tuple]] = {}
        self._loop_task = None
        self._running = True
        self._reconcile_lock = asyncio.Lock()
        # Serializes whole deploy() calls (incl. the post-reconcile-lock
        # reconfigure fan-out) so two concurrent deploys of one deployment
        # can't interleave reconfigure RPCs (last-deploy-wins, not
        # last-RPC-wins). Separate from _reconcile_lock on purpose: holding
        # THAT across the bounded 30s gather would stall health checks.
        self._deploy_lock = asyncio.Lock()

    def _ensure_loop(self):
        if self._loop_task is None:
            self._loop_task = asyncio.get_running_loop().create_task(
                self._reconcile_loop()
            )

    # ------------------------------------------------------------ deploy API

    async def deploy(self, app_name: str, deployments: List[dict],
                     route_prefix: Optional[str], ingress: str) -> dict:
        """deployments: [{name, serialized_target, init_args_ser,
        num_replicas, max_ongoing, actor_options, user_config,
        autoscaling (dict|None), version}]"""
        self._ensure_loop()
        async with self._deploy_lock:
            return await self._deploy_inner(
                app_name, deployments, route_prefix, ingress
            )

    async def _deploy_inner(self, app_name: str, deployments: List[dict],
                            route_prefix: Optional[str], ingress: str) -> dict:
        names = []
        to_reconfigure = []
        # Hold the reconcile lock: an in-flight reconcile pass may be mid
        # _start_replica and would append an old-version replica after the
        # teardown below. Replica reconfigure RPCs run AFTER release — they
        # can queue behind saturated replicas, and holding the lock across
        # that await would wedge the whole controller.
        async with self._reconcile_lock:
            for spec in deployments:
                name = spec["name"]
                names.append(name)
                existing = self._deployments.get(name)
                if existing is None:
                    self._deployments[name] = _DeploymentState(name, spec)
                else:
                    old_version = existing.spec.get("version")
                    existing.spec = spec
                    existing.target_replicas = spec["num_replicas"]
                    if spec.get("version") != old_version:
                        # rolling update: retire old-version replicas
                        # GRACEFULLY (stop routing now, let in-flight
                        # requests finish up to the drain deadline); the
                        # reconcile loop starts fresh ones immediately
                        for r in existing.replicas:
                            self._begin_drain(r)
                            existing.draining.append(r)
                        existing.replicas = []
                    elif spec.get("user_config") is not None:
                        to_reconfigure.extend(
                            (r, spec["user_config"])
                            for r in existing.replicas
                        )
        if to_reconfigure:
            async def _one(r, user_config):
                try:
                    await asyncio.wait_for(
                        self._call(r, "reconfigure", user_config), timeout=30
                    )
                except Exception:
                    pass

            await asyncio.gather(
                *(_one(r, cfg) for r, cfg in to_reconfigure)
            )
        self._apps[app_name] = names
        if route_prefix:
            self._routes[route_prefix] = ingress
        await self._reconcile_once()
        return {"ok": True, "deployments": names}

    async def delete_app(self, app_name: str) -> dict:
        for name in self._apps.pop(app_name, []):
            st = self._deployments.get(name)
            if st:
                st.deleted = True
                st.target_replicas = 0
        self._routes = {
            k: v for k, v in self._routes.items()
            if v in {d for ds in self._apps.values() for d in ds}
        }
        await self._reconcile_once()
        return {"ok": True}

    # ------------------------------------------------------------- query API

    def get_replicas(self, deployment: str) -> List[str]:
        st = self._deployments.get(deployment)
        if st is None:
            return []
        return [r["id"] for r in st.replicas]

    def get_handles(self, deployment: str) -> List[Any]:
        st = self._deployments.get(deployment)
        if st is None:
            return []
        return [r["actor"] for r in st.replicas]

    def get_router_info(self, deployment: str) -> dict:
        """Everything a handle router needs in ONE call: the replica
        handles plus routing config (load-shed cap)."""
        st = self._deployments.get(deployment)
        if st is None:
            return {"handles": [], "max_queued": -1, "max_ongoing": 16}
        mq = st.spec.get("max_queued")
        return {
            "handles": [r["actor"] for r in st.replicas],
            # no `or -1`: an explicit 0 (reject-all/drain) must survive
            "max_queued": -1 if mq is None else int(mq),
            "max_ongoing": int(st.spec.get("max_ongoing", 16)),
        }

    def _publish_replica_change(self, name: str):
        """Push-invalidate every handle's cached replica set (the
        long-poll fan-out analog, reference: serve/_private/long_poll.py
        — here a head pubsub message; handles re-fetch on receipt instead
        of polling at a tight interval)."""
        try:
            from ray_tpu_torch._private.worker import get_global_worker

            get_global_worker().gcs.notify(
                "publish",
                {"channel": f"serve_replicas:{name}", "data": {}},
            )
        except Exception as e:
            # push is an optimization; the poll fallback covers it
            logger.debug("replica-change publish for %s dropped: %s",
                         name, e)

    def get_routes(self) -> Dict[str, str]:
        return dict(self._routes)

    def status(self) -> dict:
        return {
            name: {
                "target": st.target_replicas,
                "running": len(st.replicas),
                "draining": len(st.draining),
                "deleted": st.deleted,
            }
            for name, st in self._deployments.items()
        }

    async def shutdown(self) -> bool:
        self._running = False
        async with self._reconcile_lock:  # wait out an in-flight pass
            for st in self._deployments.values():
                for r in st.replicas + st.draining:
                    await self._stop_replica(r)
                st.replicas = []
                st.draining = []
        return True

    # --------------------------------------------------------- reconcile

    async def _reconcile_loop(self):
        while self._running:
            try:
                await self._reconcile_once()
                await self._autoscale()
            except Exception:
                pass
            await asyncio.sleep(0.25)

    async def _reconcile_once(self):
        # Serialized: deploy() also reconciles, and two interleaved passes
        # would both see len < target and double-start replicas.
        async with self._reconcile_lock:
            await self._reconcile_inner()

    async def _reconcile_inner(self):
        if not self._running:
            # A pass queued behind shutdown() must not resurrect replicas
            # that shutdown just killed.
            return
        for st in list(self._deployments.values()):
            before = [r["id"] for r in st.replicas]
            while len(st.replicas) < st.target_replicas:
                r = await self._start_replica(st)
                if r is None:
                    break
                st.replicas.append(r)
            while len(st.replicas) > st.target_replicas:
                # Graceful scale-down: leave the routable set NOW (the
                # publish below makes handles re-fetch), finish in-flight
                # work, stop later — zero dropped requests.
                r = st.replicas.pop()
                self._begin_drain(r)
                st.draining.append(r)
            await self._process_draining(st)
            if st.deleted and not st.replicas and not st.draining:
                self._deployments.pop(st.name, None)
            if [r["id"] for r in st.replicas] != before:
                self._publish_replica_change(st.name)
        # health: drop dead replicas so the loop replaces them. A gang
        # replica is healthy only if EVERY member answers (scale-as-a-unit);
        # a failed gang is torn down whole so its surviving members and the
        # placement group's reservations don't leak.
        for st in self._deployments.values():
            alive = []
            for r in st.replicas:
                members = r.get("members") or [r["actor"]]
                try:
                    await asyncio.gather(*(
                        asyncio.wait_for(
                            self._await_ref(m.health_check.remote()),
                            timeout=5,
                        )
                        for m in members
                    ))
                    alive.append(r)
                except Exception:
                    await self._stop_replica(r)  # reconcile restarts it
            if len(alive) != len(st.replicas):
                self._publish_replica_change(st.name)
            st.replicas = alive

    def _begin_drain(self, r: dict):
        """Stamp the drain horizon (reference: proxy/replica draining —
        ``serve/_private/proxy_state.py`` is_drained + replica
        graceful_shutdown_timeout_s)."""
        from ray_tpu_torch._private.config import rt_config

        r["drain_deadline"] = (
            time.monotonic() + float(rt_config.serve_drain_deadline_s)
        )
        r["drain_zero"] = 0

    async def _process_draining(self, st: _DeploymentState):
        """Stop a draining replica once idle or past its deadline. A
        replica counts as idle only after TWO consecutive zero probes one
        reconcile tick apart: a request routed just before the handles saw
        the replica-change push can still be invisible in the actor
        mailbox on the first read."""
        async def _judge(r: dict) -> bool:
            """True when the replica should stop now (idle twice, dead, or
            past its deadline)."""
            if time.monotonic() > r["drain_deadline"]:
                return True
            try:
                probe = await asyncio.wait_for(
                    self._call(r, "drain"), timeout=5
                )
                if probe["ongoing"] == 0 and probe["streams"] == 0:
                    r["drain_zero"] += 1
                else:
                    r["drain_zero"] = 0
            except asyncio.TimeoutError:
                # SLOW is not DEAD: a replica busy past the probe window
                # (GIL-bound user code, big serialization) may still be
                # finishing real requests — cutting it here would drop
                # them. The drain deadline is the only slowness horizon.
                logger.debug("drain probe for %s timed out", r["id"])
                r["drain_zero"] = 0
            except Exception as e:
                logger.debug("drain probe for %s failed: %s", r["id"], e)
                return True  # replica dead/unreachable: nothing to wait for
            return r["drain_zero"] >= 2

        # Probe concurrently (style of _check_replicas): N unreachable
        # draining replicas must cost one 5s probe window per reconcile
        # pass, not N serialized timeouts stalling every deployment.
        verdicts = await asyncio.gather(
            *(_judge(r) for r in st.draining), return_exceptions=True
        )
        still: List[dict] = []
        for r, stop in zip(st.draining, verdicts):
            if isinstance(stop, BaseException) or stop:
                await self._stop_replica(r)
            else:
                still.append(r)
        st.draining = still

    async def _start_replica(self, st: _DeploymentState) -> Optional[dict]:
        import ray_tpu_torch
        from ray_tpu_torch.serve.replica import Replica

        spec = st.spec
        rid = f"{st.name}#{st.counter}"
        st.counter += 1
        opts = dict(spec.get("actor_options") or {})
        opts.setdefault("max_concurrency", max(spec["max_ongoing"], 2))
        # Health checks / queue-len polls ride their own executor lane so a
        # replica whose request slots are all busy still answers the
        # controller and router (reference: Serve replicas run control
        # methods on a dedicated concurrency group). Merged (not
        # setdefault): Replica's decorated methods hard-require "control",
        # so user-supplied groups must not clobber it.
        opts["concurrency_groups"] = {
            **(opts.get("concurrency_groups") or {}), "control": 2
        }
        gang = int(spec.get("gang_size") or 1)
        if gang > 1:
            return await self._start_gang_replica(st, rid, opts, gang)
        try:
            actor_cls = ray_tpu_torch.remote(Replica)
            actor = actor_cls.options(**opts).remote(
                spec["serialized_target"],
                spec.get("init_args", ()),
                spec.get("init_kwargs", {}),
                spec.get("user_config"),
            )
            # wait (bounded) for construction to finish or raise; a wedged
            # start must not stall the reconcile loop forever
            try:
                await asyncio.wait_for(
                    self._await_ref(actor.health_check.remote()), timeout=60
                )
            except BaseException:
                await self._stop_replica({"actor": actor})  # don't leak it
                raise
            return {"actor": actor, "id": rid}
        except Exception:
            return None

    async def _start_gang_replica(self, st, rid, opts, gang):
        """One replica = a gang of actors co-reserved via a placement group
        (reference: ``serve/gang.py:9 GangContext`` + gang autoscaling — a
        multi-host model replica, e.g. one NVLink domain, scales as a unit).
        Rank 0 serves requests; every member gets a GangContext."""
        import ray_tpu_torch
        from ray_tpu_torch.serve.replica import Replica
        from ray_tpu_torch.util.placement_group import (
            placement_group,
            remove_placement_group,
        )
        from ray_tpu_torch.util.scheduling_strategies import (
            PlacementGroupSchedulingStrategy,
        )

        from ray_tpu_torch.remote_function import _build_resources

        spec = st.spec
        # Bundles must reserve EXACTLY what the member actors will request
        # (num_gpus included), or the in-pg lease can never fit.
        bundle = _build_resources(opts)
        pg = None
        actors = []
        loop = asyncio.get_running_loop()
        try:
            # PACK by default (works single-host); multi-host gangs
            # pass gang_strategy="STRICT_SPREAD" to force one host per rank.
            # Both pg calls block in run_sync — keep them off this shared
            # async-actor loop.
            pg = await loop.run_in_executor(
                None,
                lambda: placement_group(
                    [dict(bundle) for _ in range(gang)],
                    strategy=spec.get("gang_strategy") or "PACK",
                ),
            )
            if not await loop.run_in_executor(None, pg.ready, 60.0):
                raise RuntimeError(f"gang pg for {rid} not placeable")
            actor_cls = ray_tpu_torch.remote(Replica)
            for rank in range(gang):
                a_opts = dict(opts)
                a_opts["scheduling_strategy"] = PlacementGroupSchedulingStrategy(
                    placement_group=pg, placement_group_bundle_index=rank
                )
                actors.append(actor_cls.options(**a_opts).remote(
                    spec["serialized_target"],
                    spec.get("init_args", ()),
                    spec.get("init_kwargs", {}),
                    spec.get("user_config"),
                    gang_ctx={
                        "rank": rank, "world_size": gang,
                        "replica_id": rid, "pg_id": pg.id,
                    },
                ))
            await asyncio.gather(*(
                asyncio.wait_for(
                    self._await_ref(a.health_check.remote()), timeout=60
                )
                for a in actors
            ))
            return {"actor": actors[0], "id": rid, "members": actors,
                    "pg": pg}
        except BaseException as e:
            for a in actors:
                try:
                    ray_tpu_torch.kill(a)
                except Exception:
                    pass
            if pg is not None:
                try:
                    await loop.run_in_executor(
                        None, remove_placement_group, pg
                    )
                except Exception:
                    pass
            if not isinstance(e, Exception):
                raise  # CancelledError etc. must propagate after cleanup
            return None

    async def _stop_replica(self, r: dict):
        import ray_tpu_torch

        members = r.get("members") or [r["actor"]]
        # Each member lets go of what its instance holds (an engine's
        # device memory) before the kill returns its resources; a dead or
        # wedged member is killed all the same.
        await asyncio.gather(*(
            asyncio.wait_for(
                self._await_ref(a.prepare_for_shutdown.remote()),
                timeout=_SHUTDOWN_HOOK_S,
            )
            for a in members
        ), return_exceptions=True)
        for actor in members:
            try:
                ray_tpu_torch.kill(actor)
            except Exception:
                pass
        if r.get("pg") is not None:
            try:
                from ray_tpu_torch.util.placement_group import (
                    remove_placement_group,
                )

                await asyncio.get_running_loop().run_in_executor(
                    None, remove_placement_group, r["pg"]
                )
            except Exception:
                pass

    async def _call(self, r: dict, method: str, *args):
        ref = getattr(r["actor"], method).remote(*args)
        return await self._await_ref(ref)

    async def _await_ref(self, ref):
        from ray_tpu_torch._private.worker import get_global_worker

        return await get_global_worker().as_asyncio_future(ref)

    # --------------------------------------------------------- autoscaling

    def record_handle_metrics(self, deployment: str, handle_id: str,
                              ongoing: int) -> int:
        """Ack codes: 1 = stored; 0 = deployment unknown (transient — e.g.
        mid-redeploy or controller restart; keep pushing); -1 = deployment
        doesn't autoscale (permanent — the handle stops pushing; nothing is
        stored, since unbounded handle-id churn would grow the map forever)."""
        st = self._deployments.get(deployment)
        if st is None:
            return 0
        if not st.spec.get("autoscaling"):
            self._handle_metrics.pop(deployment, None)
            return -1
        self._handle_metrics.setdefault(deployment, {})[handle_id] = (
            ongoing, time.monotonic()
        )
        return 1

    def _handle_reported_total(self, deployment: str) -> int:
        now = time.monotonic()
        metrics = self._handle_metrics.get(deployment, {})
        for hid in [h for h, (_, ts) in metrics.items()
                    if now - ts > self.HANDLE_METRIC_TTL_S]:
            metrics.pop(hid, None)
        return sum(n for n, _ in metrics.values())

    async def _autoscale(self):
        for st in self._deployments.values():
            asc = st.spec.get("autoscaling")
            if not asc or st.deleted or not st.replicas:
                continue
            # Replica-reported executing count can undercount (queued
            # requests are invisible in the actor mailbox), so take the max
            # with the handle-reported in-flight totals.
            total = 0
            for r in st.replicas:
                try:
                    total += await asyncio.wait_for(
                        self._call(r, "queue_len"), timeout=2
                    )
                except Exception:
                    pass
            total = max(total, self._handle_reported_total(st.name))
            import math

            desired = math.ceil(total / asc["target_ongoing_requests"]) or 1
            desired = min(max(desired, asc["min_replicas"]),
                          asc["max_replicas"])
            now = time.monotonic()
            if desired > st.target_replicas and (
                now - st.last_scale_up > asc["upscale_delay_s"]
            ):
                st.target_replicas = desired
                st.last_scale_up = now
            elif desired < st.target_replicas and (
                now - st.last_scale_down > asc["downscale_delay_s"]
            ):
                st.target_replicas = max(desired, asc["min_replicas"])
                st.last_scale_down = now
