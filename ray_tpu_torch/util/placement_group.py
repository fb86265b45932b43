"""Placement groups (reference: ``python/ray/util/placement_group.py`` +
GCS-side 2PC in ``gcs_placement_group_scheduler.h:115``).

Counterpart of ``ray_tpu/util/placement_group.py``,
over the port's runtime core.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional

from ray_tpu_torch._private.backoff import Backoff
from ray_tpu_torch._private.ids import PlacementGroupID
from ray_tpu_torch._private.worker import get_global_worker
from ray_tpu_torch.exceptions import PlacementGroupUnavailableError


class PlacementGroup:
    def __init__(self, pg_id: str, bundles: List[Dict[str, float]], strategy: str):
        self.id = pg_id
        self.bundles = bundles
        self.strategy = strategy

    @property
    def bundle_specs(self) -> List[Dict[str, float]]:
        return self.bundles

    def ready(self, timeout: float = 30.0) -> bool:
        w = get_global_worker()
        deadline = time.monotonic() + timeout
        poll = Backoff(base=0.01, cap=0.25)
        while time.monotonic() < deadline:
            h = w.run_sync(w._head_call("get_pg", {"pg_id": self.id}))[0]
            if h.get("found") and h["pg"]["state"] == "CREATED":
                return True
            if h.get("found") and h["pg"]["state"] == "REMOVED":
                return False
            poll.sleep()
        return False

    def wait(self, timeout_seconds: float = 30.0) -> bool:
        return self.ready(timeout_seconds)

    def __reduce__(self):
        return (PlacementGroup, (self.id, self.bundles, self.strategy))


def placement_group(
    bundles: List[Dict[str, float]],
    strategy: str = "PACK",
    name: str = "",
    lifetime: Optional[str] = None,
    timeout: float = 30.0,
) -> PlacementGroup:
    if strategy not in ("PACK", "SPREAD", "STRICT_PACK", "STRICT_SPREAD"):
        raise ValueError(f"invalid placement strategy {strategy}")
    if not bundles:
        raise ValueError("placement group requires at least one bundle")
    from ray_tpu_torch._private.config import rt_config

    w = get_global_worker()
    pg_id = PlacementGroupID.from_random().hex()
    # corr: a retried create_pg after a dropped reply must replay the
    # original outcome — re-running it would overwrite the registered
    # group and leak the first commit's bundle reservations. The run_sync
    # budget covers the full retry envelope (attempts x per-attempt
    # deadline plus backoff) so a configured retry is never cut short.
    attempt_s = timeout + 15
    attempts = int(rt_config.rpc_retries) + 1
    h = w.run_sync(
        w._head_call(
            "create_pg",
            {
                "pg_id": pg_id,
                "bundles": [{k: float(v) for k, v in b.items()} for b in bundles],
                "pg_strategy": strategy,
                "name": name,
                "timeout": timeout,
            },
            timeout=attempt_s,
            corr=True,
        ),
        timeout=attempts * (attempt_s + 2) + 10,
    )[0]
    pg = PlacementGroup(pg_id, bundles, strategy)
    if h.get("state") != "CREATED":
        # Stays PENDING server-side; caller can still .ready() poll.
        pass
    return pg


def remove_placement_group(pg: PlacementGroup):
    w = get_global_worker()
    w.run_sync(w._head_call("remove_pg", {"pg_id": pg.id}))


def get_placement_group(pg_id: str) -> Optional[PlacementGroup]:
    w = get_global_worker()
    h = w.run_sync(w._head_call("get_pg", {"pg_id": pg_id}))[0]
    if not h.get("found"):
        return None
    info = h["pg"]
    return PlacementGroup(info["placement_group_id"], info["bundles"], info["strategy"])
