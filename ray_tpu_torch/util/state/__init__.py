"""State API: cluster-wide listings and summaries.

Reference analog: ``python/ray/util/state/api.py`` — ``list_actors`` (:793),
``list_nodes`` (:885), ``list_tasks`` (:1020), ``list_objects`` (:1065),
``summarize_tasks`` (:1376), backed by GCS tables + the task-event store.
"""
from __future__ import annotations

from collections import Counter
from typing import Any, Dict, List, Optional


def _call(method: str, header: dict, address: Optional[str] = None,
          timeout: float = 30.0):
    if address is not None:
        from ray_tpu_torch._private.sync_client import SyncHeadClient

        client = SyncHeadClient(address)
        try:
            return client.call(method, header, timeout=timeout)[0]
        finally:
            client.close()
    from ray_tpu_torch._private.worker import get_global_worker

    w = get_global_worker()
    return w.run_sync(w.gcs.call(method, header), timeout)[0]


def flight_snapshot(address: Optional[str] = None,
                    drain: bool = True) -> List[dict]:
    """Cluster-wide flight-recorder drain: the head fans ``flight_drain``
    out to every node and returns clock-annotated per-process snapshots
    (see ``ray_tpu_torch._private.flight.merge_snapshots``)."""
    h = _call("flight_snapshot", {"drain": drain}, address, timeout=60.0)
    return h.get("snapshots", [])


def _apply_filters(rows: List[dict], filters) -> List[dict]:
    """filters: [(key, op, value)] with op in ("=", "!=")."""
    for key, op, value in filters or ():
        if op == "=":
            rows = [r for r in rows if str(r.get(key)) == str(value)]
        elif op == "!=":
            rows = [r for r in rows if str(r.get(key)) != str(value)]
        else:
            raise ValueError(f"unsupported filter op {op}")
    return rows


def list_nodes(address: Optional[str] = None, filters=None,
               limit: int = 1000) -> List[dict]:
    rows = _call("get_nodes", {}, address)["nodes"]
    return _apply_filters(rows, filters)[:limit]


def list_actors(address: Optional[str] = None, filters=None,
                limit: int = 1000) -> List[dict]:
    rows = _call("list_actors", {}, address)["actors"]
    return _apply_filters(rows, filters)[:limit]


def list_placement_groups(address: Optional[str] = None, filters=None,
                          limit: int = 1000) -> List[dict]:
    rows = _call("list_pgs", {}, address)["pgs"]
    return _apply_filters(rows, filters)[:limit]


def list_jobs(address: Optional[str] = None, filters=None,
              limit: int = 1000) -> List[dict]:
    rows = _call("list_jobs", {}, address)["jobs"]
    return _apply_filters(rows, filters)[:limit]


def list_objects(address: Optional[str] = None, filters=None,
                 limit: int = 1000) -> List[dict]:
    """Object-directory listing. Filters are applied SERVER-side (the
    head evaluates them over the flattened row — object_id/bytes/node/
    owner/spilled/task — before the limit slice, so a filtered listing
    is never starved by truncation); the local pass only covers heads
    predating the server-side path."""
    h = _call("list_objects", {
        "limit": limit,
        "filters": [list(f) for f in (filters or ())],
    }, address)
    return _apply_filters(h["objects"], filters)[:limit]


def memory_summary(address: Optional[str] = None,
                   group_by: Optional[str] = None,
                   grace_s: float = 5.0) -> Dict[str, Any]:
    """Cluster-wide object & memory accounting (the ``rt memory``
    surface): owner-attributed object rows {oid, bytes, kind, state,
    node, owner, task, fn}, per-node directory-vs-arena reconciliation,
    and leak candidates (directory entries past the grace window that no
    live process owns, stores, or borrows). See
    ``_private/memtrack.py``."""
    from ray_tpu_torch._private import memtrack

    return memtrack.memory_summary(
        address=address, group_by=group_by, grace_s=grace_s
    )


def list_logs(address: Optional[str] = None, node_id: Optional[str] = None,
              tail: int = 1000) -> List[dict]:
    """Buffered worker log lines from the head's log plane (reference:
    ``ray logs`` / dashboard log view; fed by _private/log_monitor.py)."""
    return _call(
        "get_logs", {"node_id": node_id, "tail": tail}, address
    )["lines"]


def list_events(address: Optional[str] = None,
                source_type: Optional[str] = None,
                event_type: Optional[str] = None,
                limit: int = 100) -> List[dict]:
    """Structured export events from the head's recorder (reference: the
    aggregator's event query surface; util/events.py)."""
    return _call("export_events", {
        "limit": limit, "source_type": source_type,
        "event_type": event_type,
    }, address)["events"]


def list_tasks(address: Optional[str] = None, filters=None,
               limit: int = 1000) -> List[dict]:
    rows = _call("list_task_events", {"limit": limit}, address)["events"]
    return _apply_filters(rows, filters)[:limit]


def summarize_tasks(address: Optional[str] = None,
                    phases: bool = False) -> Dict[str, Any]:
    """Counts by (name, state) (reference: ``api.py:1376``).

    ``phases=True`` additionally joins the flight recorder's task spans
    to the task events and attaches a per-function critical-path table
    (``{fn: {phase: {count, total_s, p50_ms, p99_ms}}}``) under
    ``cluster.phases`` — requires the flight recorder to be enabled
    (``RT_FLIGHT_ENABLED=1``); empty otherwise."""
    events = list_tasks(address, limit=100_000)
    by_name: Dict[str, Counter] = {}
    for e in events:
        name = e.get("name", "unknown")
        by_name.setdefault(name, Counter())[e.get("state", "UNKNOWN")] += 1
    out = {
        "cluster": {
            "summary": {
                name: {"state_counts": dict(c)} for name, c in by_name.items()
            },
            "total_tasks": len(events),
        }
    }
    if phases:
        from ray_tpu_torch._private import flight, taskpath

        merged = flight.merge_snapshots(
            flight_snapshot(address, drain=False)
        )
        out["cluster"]["phases"] = taskpath.phase_table(merged, events)
    return out


def task_breakdown(task_id: str, address: Optional[str] = None,
                   drain: bool = False) -> Optional[Dict[str, Any]]:
    """One task's critical path: named phase durations summing to the
    task's driver-observed wall time, residual explicit (the ``rt
    timeline --task`` surface). None when no flight span carries the id
    (recorder off, or the span aged out of the ring)."""
    from ray_tpu_torch._private import flight, taskpath

    merged = flight.merge_snapshots(flight_snapshot(address, drain=drain))
    events = list_tasks(address, limit=100_000)
    return taskpath.task_breakdown(merged, task_id, events)


def cluster_status(address: Optional[str] = None) -> Dict[str, Any]:
    """Autoscaler-style status: totals, availability, pending demand."""
    load = _call("cluster_load", {}, address)
    total: Dict[str, float] = {}
    avail: Dict[str, float] = {}
    alive = 0
    for n in load["nodes"]:
        if not n.get("alive"):
            continue
        alive += 1
        for k, v in n.get("resources", {}).items():
            total[k] = total.get(k, 0) + v
        for k, v in n.get("available", {}).items():
            avail[k] = avail.get(k, 0) + v
    return {
        "nodes_alive": alive,
        "resources_total": total,
        "resources_available": avail,
        "pending_demands": load["pending"],
        "pending_placement_groups": load["pending_pgs"],
    }
