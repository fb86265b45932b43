"""Object & memory observability plane: cluster-wide object accounting.

Reference shape: ``ray memory`` (``python/ray/_private/internal_api.py``
memory_summary over the ownership/refcount tables) joined to the plasma
store's per-node utilization counters. The RPC plane (flight recorder)
and the task plane (taskpath) are instrumented; this module covers the
third blind spot — the object plane — with the same design contract:

- **One-boolean gate.** Everything here is gated on the module attribute
  ``ENABLED`` (``rt_config.memtrack_enabled`` / ``RT_MEMTRACK_ENABLED``;
  ON by default — accounting is snapshot-time work, the put/get hot paths
  pay nothing either way). Disabled: metas stay unenriched, the 2s gauge
  tick skips, ``memstat_drain`` answers empty.
- **Snapshot-time accounting, not per-op bookkeeping.** A worker's object
  rows are derived from the structures the refcount plane already keeps
  (``owned`` / ``borrowed`` / ``memory_store`` / the arena's created
  index) when a drain or gauge tick asks — zero extra state on the
  put/free paths.
- **Owner-attributed bytes.** Each worker reports only objects it OWNS,
  so per-node sums across workers never double-count; arena-wide gauges
  (in_use/capacity/peak are one shared mapping per machine) roll up with
  ``max`` instead.

Surfaces: ``rt memory`` (``--group-by``, ``--leaks`` with nonzero exit
for CI), ``state.memory_summary()``, the dashboard objects page, and
``rt_object_store_bytes{node_id,kind}`` / ``rt_object_count{node_id,state}``
(+ spill/arena/graveyard/memory-pressure gauges) on the head's single
``/metrics`` scrape.

Leak model (the chaos matrices' zero-leaked-objects SLO): a directory
entry older than the grace window that no live process owns, holds in its
store, or borrows is a leak candidate — the owner died (or dropped its
record) and nothing keeps the object alive, yet the head still accounts
it. Borrower-held objects of a dead owner are NOT leaks: the borrow is
exactly what keeps them alive (``reference_counter.h`` semantics).
"""
from __future__ import annotations

import logging
import time
from typing import Any, Dict, List, Optional

logger = logging.getLogger(__name__)

# The pinned memory_summary row schema (PARITY.md Round-13; consumers:
# `rt memory`, the dashboard objects page, the chaos leak SLO).
ROW_FIELDS = (
    "oid", "bytes", "kind", "state", "node", "owner", "owner_node",
    "task", "fn", "count", "borrows",
)

OBJECT_KINDS = ("inline", "shm", "spilled", "device")
OBJECT_STATES = ("owned", "pinned", "pending", "error", "borrowed")

GROUP_KEYS = ("owner", "node", "fn", "state", "kind", "task")


def _load_enabled() -> bool:
    try:
        from ray_tpu_torch._private.config import rt_config

        return bool(rt_config.memtrack_enabled)
    except Exception as e:
        logger.debug("memtrack env config unavailable: %s", e)
        return True


# Hot-path gate: ``if memtrack.ENABLED: ...`` (same contract as
# flight.ENABLED — one attribute load and a false branch when off).
ENABLED = _load_enabled()


def enable():
    global ENABLED
    ENABLED = True


def disable():
    global ENABLED
    ENABLED = False


# ------------------------------------------------------------ worker side

def _device_staged_stats() -> Dict[str, int]:
    try:
        from ray_tpu_torch._private import devstore

        return devstore.host_staged_stats()
    except Exception as e:  # devstore never blocks accounting
        logger.debug("devstore staging stats unavailable: %s", e)
        return {"count": 0, "bytes": 0}


def _object_row(oid: str, rec: dict, entry, node_id: str) -> Dict[str, Any]:
    """One owner-side accounting row from the refcount record + the
    memory-store entry (None while a task return is still in flight)."""
    kind, nbytes, node = "pending", 0, node_id
    if entry is not None:
        k = entry[0]
        if k == "mem":
            kind = "inline"
            nbytes = sum(len(f) for f in entry[1])
        elif k == "shm":
            meta = entry[1] or {}
            kind = "spilled" if "spill" in meta else "shm"
            nbytes = int(meta.get("size") or 0)
            # shm rows attribute to the node whose arena holds the
            # segment (a task return lives where it executed), not the
            # owner's node.
            node = meta.get("node") or node
        else:
            kind = "error"
    return {
        "oid": oid, "bytes": nbytes, "kind": kind,
        "state": "pinned" if rec.get("borrows", 0) > 0 else "owned",
        "count": rec.get("count", 0),
        "borrows": rec.get("borrows", 0),
        "node": node,
    }


# Row cap per drained snapshot: a 1M-task burst leaves ~1M owned return
# records at the driver — shipping a row dict per object would be a
# multi-hundred-MB reply. Aggregates (bytes by kind/node, counts by
# state) stay EXACT in the same pass; only the per-object listing is
# truncated, and the drop is reported, never silent.
SNAPSHOT_MAX_ROWS = 50_000


def local_snapshot(worker,
                   max_rows: int = SNAPSHOT_MAX_ROWS) -> Dict[str, Any]:
    """This process's object accounting: owner-side rows (capped at
    ``max_rows`` with an honest dropped count; ``max_rows=0`` skips row
    building entirely — the gauge tick's aggregate-only mode), exact
    aggregates, borrow table, arena/graveyard/spill stats,
    created-object index, memory pressure. Dict reads are GIL-atomic
    snapshots (``list(d.items())`` never releases the GIL), so this is
    safe from the core loop or an executor thread."""
    from ray_tpu_torch._private import memory_monitor

    ms_get = worker.memory_store.get
    node_id = worker.node_id
    my_node = str(node_id)[:12]
    objects: List[dict] = []
    by_kind_node: Dict[tuple, int] = {}
    by_state = {s: 0 for s in OBJECT_STATES}
    total = 0
    for oid, rec in list(worker.owned.items()):
        total += 1
        entry = ms_get(oid)
        # Aggregate inline (no row dict on this path — the common case
        # during a burst is a huge owned map of pending returns).
        if entry is None:
            by_state["pending"] += 1
            if len(objects) < max_rows:
                objects.append(_object_row(oid, rec, None, node_id))
            continue
        k = entry[0]
        if k == "mem":
            kind, nbytes, node = "inline", 0, my_node
            for f in entry[1]:
                nbytes += len(f)
        elif k == "shm":
            meta = entry[1] or {}
            kind = "spilled" if "spill" in meta else "shm"
            nbytes = int(meta.get("size") or 0)
            node = str(meta.get("node") or my_node)[:12]
        else:
            by_state["error"] += 1
            if len(objects) < max_rows:
                objects.append(_object_row(oid, rec, entry, node_id))
            continue
        key = (kind, node)
        by_kind_node[key] = by_kind_node.get(key, 0) + nbytes
        by_state["pinned" if rec.get("borrows", 0) > 0 else "owned"] += 1
        if len(objects) < max_rows:
            objects.append(_object_row(oid, rec, entry, node_id))
    borrowed = [
        {"oid": oid, "count": b.get("count", 0),
         "owner": list(b.get("owner") or ())}
        for oid, b in list(worker.borrowed.items())
    ]
    by_state["borrowed"] = len(borrowed)
    snap: Dict[str, Any] = {
        "worker": worker.worker_id.hex(),
        "node": node_id,
        "addr": list(worker.addr or ()),
        "is_driver": bool(worker.is_driver),
        "objects": objects,
        "objects_total": total,
        "objects_dropped": max(total - len(objects), 0),
        "bytes_by_kind_node": [
            [k, n, v] for (k, n), v in by_kind_node.items()
        ],
        "counts_by_state": by_state,
        "borrowed": borrowed,
        "store_oids": [],
        "arena": None,
        "fallback": {"objects": 0, "bytes": 0},
        "graveyard": {"segments": 0, "bytes": 0},
        "spill": {},
        # Device arrays that went through HOST serialization anyway
        # (plane off / nested in containers): their bytes already count
        # in the inline/shm rows above — this ledger says how much of
        # that host traffic is really device payload.
        "device_host_staged": _device_staged_stats(),
        "mem_used_ratio": memory_monitor.used_ratio(),
        "now": time.time(),
    }
    store = worker._shm
    if store is not None:
        st = store.stats()
        snap["arena"] = st.get("arena")
        snap["fallback"] = st.get("fallback") or snap["fallback"]
        snap["graveyard"] = st.get("graveyard") or snap["graveyard"]
        snap["spill"] = st.get("spill") or {}
        snap["store_oids"] = store.created_oids()
    return snap


_gauges: Optional[dict] = None


def _gauge_set() -> Optional[dict]:
    """Lazily register the object-plane gauge family (idempotent: the
    metrics registry canonicalizes re-registrations into one series)."""
    global _gauges
    if _gauges is not None:
        return _gauges
    try:
        from ray_tpu_torch.util.metrics import Gauge

        _gauges = {
            "bytes": Gauge(
                "rt_object_store_bytes",
                description="Owner-accounted object bytes by kind "
                            "(inline|shm|spilled) and the node whose "
                            "store holds them",
                tag_keys=("kind", "node"),
            ),
            "count": Gauge(
                "rt_object_count",
                description="Owner-accounted object counts by ref state",
                tag_keys=("state",),
            ),
            "spill": Gauge(
                "rt_spill_bytes_total",
                description="Bytes spilled to external storage by this "
                            "process",
            ),
            "restore": Gauge(
                "rt_restore_bytes_total",
                description="Bytes restored from external storage by this "
                            "process",
            ),
            "arena": Gauge(
                "rt_arena_bytes",
                description="Native shm arena utilization (shared per "
                            "node; rolled up with max)",
                tag_keys=("what",),
            ),
            "grave_segs": Gauge(
                "rt_arena_graveyard_segments",
                description="Freed-but-mapped fallback segments "
                            "(deliberately unreclaimed; see object_store"
                            "._graveyard)",
            ),
            "grave_bytes": Gauge(
                "rt_arena_graveyard_bytes",
                description="Bytes held by freed-but-mapped fallback "
                            "segments",
            ),
            "mem_ratio": Gauge(
                "rt_node_memory_used_ratio",
                description="Node memory pressure (used/total; the OOM "
                            "admission threshold input)",
            ),
        }
    except Exception as e:
        logger.debug("memtrack gauges unavailable: %s", e)
    return _gauges


_prev_byte_keys: set = set()


def push_gauges(worker):
    """Refresh the object-plane gauges from a fresh local snapshot; they
    ride the existing metrics_push pipeline to the head's /metrics rollup.
    Every tag value is set each tick — and (kind, node) byte keys this
    process stopped reporting are zeroed explicitly — because stale gauge
    samples would otherwise report the last nonzero value forever."""
    global _prev_byte_keys
    g = _gauge_set()
    if g is None:
        return
    # Aggregate-only snapshot (max_rows=0): ONE pass over the owned map
    # with no row dicts — the 2s tick must stay cheap while a 1M-task
    # burst holds a million pending return records.
    snap = local_snapshot(worker, max_rows=0)
    # Bytes attribute to the node whose STORE holds the segment (the
    # sample-level "node" tag; the /metrics rollup groups on it) — a
    # task return is owned by the driver but its bytes sit in the
    # executing node's arena.
    my_node = str(worker.node_id)[:12]
    by_kind_node: Dict[tuple, float] = {
        (k, n): float(v) for k, n, v in snap["bytes_by_kind_node"]
    }
    by_state = {s: float(snap["counts_by_state"].get(s, 0))
                for s in OBJECT_STATES}
    for kind in OBJECT_KINDS:
        by_kind_node.setdefault((kind, my_node), 0.0)
    for key in _prev_byte_keys - set(by_kind_node):
        by_kind_node[key] = 0.0
    _prev_byte_keys = {k for k, v in by_kind_node.items() if v > 0.0}
    for (kind, node), v in by_kind_node.items():
        g["bytes"].set(v, tags={"kind": kind, "node": node})
    for state, v in by_state.items():
        g["count"].set(v, tags={"state": state})
    spill = snap.get("spill") or {}
    g["spill"].set(float(spill.get("spilled_bytes", 0)))
    g["restore"].set(float(spill.get("restored_bytes", 0)))
    arena = snap.get("arena")
    if arena:
        g["arena"].set(float(arena.get("bytes_in_use", 0)),
                       tags={"what": "in_use"})
        g["arena"].set(float(arena.get("capacity", 0)),
                       tags={"what": "capacity"})
        g["arena"].set(float(arena.get("peak_bytes", 0)),
                       tags={"what": "peak"})
    grave = snap.get("graveyard") or {}
    g["grave_segs"].set(float(grave.get("segments", 0)))
    g["grave_bytes"].set(float(grave.get("bytes", 0)))
    g["mem_ratio"].set(float(snap.get("mem_used_ratio", 0.0)))


# ------------------------------------------------------------- analysis

def build_summary(raw: Dict[str, Any], grace_s: float = 5.0,
                  now: Optional[float] = None) -> Dict[str, Any]:
    """Join the head's ``memory_summary`` verb reply (per-process
    snapshots + the object directory + the task-name map) into the
    cluster summary: object rows, per-node reconciliation, leak
    candidates, totals. Pure function of its input — unit-testable
    without a cluster."""
    snaps = raw.get("snapshots") or []
    directory = raw.get("directory") or []
    names = raw.get("tasks") or {}
    if now is None:
        now = float(raw.get("now") or time.time())
    rows: List[Dict[str, Any]] = []
    owned_at: Dict[str, dict] = {}
    borrow_count: Dict[str, int] = {}
    store_hold: set = set()
    agg_bytes: Dict[tuple, float] = {}  # (kind, node) exact, cap-proof
    rows_dropped = 0
    for s in snaps:
        addr = list(s.get("addr") or ())
        rows_dropped += int(s.get("objects_dropped") or 0)
        for o in s.get("objects") or ():
            tid = o["oid"][:48]
            row = {
                "oid": o["oid"], "bytes": int(o.get("bytes") or 0),
                "kind": o.get("kind") or "pending",
                "state": o.get("state") or "owned",
                "node": o.get("node") or s.get("node"),
                "owner": addr, "owner_node": s.get("node"),
                "task": tid, "fn": names.get(tid) or "",
                "count": o.get("count", 0), "borrows": o.get("borrows", 0),
            }
            rows.append(row)
            owned_at[o["oid"]] = row
        agg = s.get("bytes_by_kind_node")
        if agg is None:
            # Pre-aggregate snapshot shape: derive from the rows.
            agg = []
            for o in s.get("objects") or ():
                if o.get("kind") in OBJECT_KINDS:
                    agg.append([o["kind"],
                                str(o.get("node") or s.get("node"))[:12],
                                int(o.get("bytes") or 0)])
        for kind, node, v in agg:
            # Inline bytes live in the OWNER's memory, not a node store:
            # attribute them to the snapshot's node.
            key = (kind, str((s.get("node") if kind == "inline"
                              else node))[:12])
            agg_bytes[key] = agg_bytes.get(key, 0.0) + float(v)
        for b in s.get("borrowed") or ():
            borrow_count[b["oid"]] = (
                borrow_count.get(b["oid"], 0) + int(b.get("count") or 1)
            )
        store_hold.update(s.get("store_oids") or ())

    leaks: List[Dict[str, Any]] = []
    dir_bytes_by_node: Dict[str, Dict[str, float]] = {}
    for d in directory:
        oid, meta = d["oid"], d.get("meta") or {}
        node = str(meta.get("node") or "")[:12] or "?"
        if meta.get("device"):
            kind = "device"
        elif meta.get("spill"):
            kind = "spilled"
        else:
            kind = "shm"
        size = float(meta.get("size") or 0)
        pn = dir_bytes_by_node.setdefault(
            node, {"directory_shm_bytes": 0.0,
                   "directory_spilled_bytes": 0.0,
                   "directory_device_bytes": 0.0}
        )
        pn[f"directory_{kind}_bytes"] += size
        if oid in owned_at:
            owned_at[oid].setdefault("locations", []).append(node)
            continue
        if oid in store_hold or borrow_count.get(oid, 0) > 0:
            continue  # alive via a live store mapping or a borrower
        if not snaps or rows_dropped:
            # No accounting to judge liveness with (plane disabled), or
            # ownership listings were truncated (an unlisted owner row
            # would read as an orphan): flagging here would be noise,
            # not detection — leaks_truncated below says so.
            continue
        age = max(now - float(meta.get("_t") or now), 0.0)
        if age >= grace_s:
            tid = oid[:48]
            leaks.append({
                "oid": oid, "bytes": int(size), "kind": kind,
                "node": node, "owner": list(meta.get("owner") or ()),
                "task": tid, "fn": names.get(tid) or "", "age_s": age,
                "reason": "owner-gone",
            })

    reconcile: Dict[str, Dict[str, float]] = {}

    def pn(node) -> Dict[str, float]:
        return reconcile.setdefault(str(node or "?")[:12], {
            "owner_inline_bytes": 0.0, "owner_shm_bytes": 0.0,
            "owner_spilled_bytes": 0.0, "owner_device_bytes": 0.0,
            "directory_shm_bytes": 0.0, "directory_spilled_bytes": 0.0,
            "directory_device_bytes": 0.0, "arena_bytes_in_use": 0.0,
            "arena_peak_bytes": 0.0, "delta_shm_bytes": 0.0,
        })

    for (kind, node), v in agg_bytes.items():
        if kind == "inline":
            pn(node)["owner_inline_bytes"] += v
        elif kind == "shm":
            pn(node)["owner_shm_bytes"] += v
        elif kind == "spilled":
            pn(node)["owner_spilled_bytes"] += v
        elif kind == "device":
            pn(node)["owner_device_bytes"] += v
    for node, d in dir_bytes_by_node.items():
        rec = pn(node)
        rec["directory_shm_bytes"] += d["directory_shm_bytes"]
        rec["directory_spilled_bytes"] += d["directory_spilled_bytes"]
        rec["directory_device_bytes"] += d.get("directory_device_bytes", 0.0)
    for s in snaps:
        arena = s.get("arena")
        if not arena:
            continue
        rec = pn(s.get("node"))
        # The arena is ONE shared mapping per machine: every process on
        # the node reports the same counters, so max (not sum).
        rec["arena_bytes_in_use"] = max(
            rec["arena_bytes_in_use"], float(arena.get("bytes_in_use", 0))
        )
        rec["arena_peak_bytes"] = max(
            rec["arena_peak_bytes"], float(arena.get("peak_bytes", 0))
        )
    for rec in reconcile.values():
        rec["delta_shm_bytes"] = (
            rec["directory_shm_bytes"] - rec["owner_shm_bytes"]
        )

    totals = {
        "objects": len(rows) + rows_dropped,
        "inline_bytes": sum(
            v for (k, _n), v in agg_bytes.items() if k == "inline"
        ),
        "shm_bytes": sum(
            v for (k, _n), v in agg_bytes.items() if k == "shm"
        ),
        "spilled_bytes": sum(
            v for (k, _n), v in agg_bytes.items() if k == "spilled"
        ),
        "device_bytes": sum(
            v for (k, _n), v in agg_bytes.items() if k == "device"
        ),
        "directory_entries": int(
            raw.get("recorded") or len(directory)
        ),
        "arena_peak_bytes": sum(
            rec["arena_peak_bytes"] for rec in reconcile.values()
        ),
        "leak_candidates": len(leaks),
    }
    return {
        "enabled": bool(raw.get("enabled", bool(snaps))),
        "rows": rows,
        "rows_dropped": rows_dropped,
        # True when per-object listings were truncated: byte totals and
        # reconciliation above stay EXACT (single-pass aggregates), but
        # leak detection was skipped — an unlisted owner row would read
        # as an orphan.
        "leaks_truncated": bool(rows_dropped and snaps),
        "leaks": leaks,
        "reconcile": reconcile,
        "totals": totals,
        "directory_recorded": int(raw.get("recorded") or len(directory)),
        "directory_dropped": int(raw.get("dropped") or 0),
        "grace_s": grace_s,
    }


def group_rows(rows: List[Dict[str, Any]],
               by: str) -> Dict[str, Dict[str, Any]]:
    """Aggregate object rows by one of GROUP_KEYS (``rt memory
    --group-by``); owner groups render as host:port."""
    if by not in GROUP_KEYS:
        raise ValueError(f"group_by must be one of {GROUP_KEYS}, got {by!r}")
    out: Dict[str, Dict[str, Any]] = {}
    for r in rows:
        key = r.get(by)
        if by == "owner":
            key = ":".join(str(p) for p in (key or ())) or "?"
        key = str(key or "?")
        g = out.setdefault(key, {"objects": 0, "bytes": 0, "pinned": 0})
        g["objects"] += 1
        g["bytes"] += r["bytes"]
        if r.get("state") == "pinned":
            g["pinned"] += 1
    return out


def memory_summary(address: Optional[str] = None,
                   group_by: Optional[str] = None,
                   grace_s: float = 5.0) -> Dict[str, Any]:
    """Cluster-wide object/memory summary: the head fans ``memstat_drain``
    to every process, and the reply is joined client-side (works from a
    driver or a bare CLI via the sync head client)."""
    from ray_tpu_torch.util.state import _call

    raw = _call("memory_summary", {}, address, timeout=60.0)
    summary = build_summary(raw, grace_s=grace_s)
    if group_by:
        summary["groups"] = group_rows(summary["rows"], group_by)
        summary["group_by"] = group_by
    return summary


# ------------------------------------------------------------- rendering

def _fmt_bytes(n: float) -> str:
    n = float(n)
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(n) < 1024.0 or unit == "GiB":
            return (f"{n:.0f}{unit}" if unit == "B"
                    else f"{n:.1f}{unit}")
        n /= 1024.0
    return f"{n:.1f}GiB"


def format_summary(s: Dict[str, Any], limit: int = 30) -> str:
    """Fixed-width report for ``rt memory``: totals, per-node
    reconciliation, heaviest rows, leak candidates."""
    t = s["totals"]
    lines = [
        f"objects={t['objects']}  inline={_fmt_bytes(t['inline_bytes'])}  "
        f"shm={_fmt_bytes(t['shm_bytes'])}  "
        f"spilled={_fmt_bytes(t['spilled_bytes'])}  "
        f"device={_fmt_bytes(t.get('device_bytes', 0))}  "
        f"directory={t['directory_entries']} entr"
        f"{'y' if t['directory_entries'] == 1 else 'ies'}  "
        f"leak-candidates={t['leak_candidates']}",
        "",
        f"{'node':<14}{'inline':>10}{'shm':>10}{'spilled':>10}"
        f"{'directory':>11}{'delta':>9}{'arena':>10}{'peak':>10}",
    ]
    for node, rec in sorted(s["reconcile"].items()):
        lines.append(
            f"{node:<14}"
            f"{_fmt_bytes(rec['owner_inline_bytes']):>10}"
            f"{_fmt_bytes(rec['owner_shm_bytes']):>10}"
            f"{_fmt_bytes(rec['owner_spilled_bytes']):>10}"
            f"{_fmt_bytes(rec['directory_shm_bytes']):>11}"
            f"{_fmt_bytes(rec['delta_shm_bytes']):>9}"
            f"{_fmt_bytes(rec['arena_bytes_in_use']):>10}"
            f"{_fmt_bytes(rec['arena_peak_bytes']):>10}"
        )
    groups = s.get("groups")
    if groups:
        lines += ["", f"{'group (' + s['group_by'] + ')':<34}"
                      f"{'objects':>9}{'pinned':>8}{'bytes':>12}"]
        top = sorted(groups.items(), key=lambda kv: -kv[1]["bytes"])
        for key, g in top[:limit]:
            lines.append(f"{key[:33]:<34}{g['objects']:>9}{g['pinned']:>8}"
                         f"{_fmt_bytes(g['bytes']):>12}")
    else:
        lines += ["", f"{'object':<18}{'kind':<9}{'state':<9}{'bytes':>10}"
                      f"  {'node':<10}{'fn':<18}{'task':<14}"]
        top = sorted(s["rows"], key=lambda r: -r["bytes"])
        for r in top[:limit]:
            lines.append(
                f"{r['oid'][:16]:<18}{r['kind']:<9}{r['state']:<9}"
                f"{_fmt_bytes(r['bytes']):>10}  "
                f"{str(r['node'])[:8]:<10}{(r['fn'] or '-')[:17]:<18}"
                f"{r['task'][:12]:<14}"
            )
        if len(s["rows"]) > limit:
            lines.append(f"... {len(s['rows']) - limit} more rows "
                         f"(--json for all)")
    if s["leaks"]:
        lines += ["", "LEAK CANDIDATES (owner gone, no borrower, past "
                      f"{s['grace_s']}s grace):"]
        for lk in s["leaks"][:limit]:
            lines.append(
                f"  {lk['oid'][:16]}  {_fmt_bytes(lk['bytes'])}  "
                f"node={str(lk['node'])[:8]}  fn={lk['fn'] or '-'}  "
                f"age={lk['age_s']:.1f}s"
            )
    if s.get("leaks_truncated"):
        lines.append(f"\nNOTE: {s.get('rows_dropped', 0)} object rows "
                     f"truncated (SNAPSHOT_MAX_ROWS) — byte totals stay "
                     f"exact, leak detection skipped this pass")
    if not s.get("enabled", True):
        lines.append("\nNOTE: no process reported accounting — is the "
                     "plane off (RT_MEMTRACK_ENABLED=0)?")
    return "\n".join(lines)
