"""CoreWorker: the per-process runtime for drivers and workers.

Analog of the reference ``src/ray/core_worker/`` (``CoreWorker``
``core_worker.h:167``) plus the Python half (``python/ray/_private/worker.py``).
One instance lives in every process. It owns:

- the process's RPC service (tasks are *pushed directly* worker→worker, as in
  the reference's ``PushNormalTask``/``PushActorTask`` — the scheduler is out
  of the data path once a lease is granted),
- the in-process memory store for small objects (CoreWorkerMemoryStore),
- the shm store client for large objects (plasma analog),
- ownership + borrow refcounting (``reference_counter.h`` semantics, reduced:
  owner tracks local refs + outstanding task-arg borrows),
- lease caching per scheduling key (``normal_task_submitter.h:271``),
- actor submission with per-handle sequence numbers and restart-aware
  reconnect (``actor_task_submitter.cc:168/:582``),
- task execution with per-actor ordered queues and concurrency groups.

Threading model: a single asyncio "core loop" runs all networking (driver: a
daemon thread; worker: the main thread). User/task code runs in executor
threads and talks to the loop via run_coroutine_threadsafe — the analog of the
reference's io_service + task execution threads.
"""
from __future__ import annotations

import asyncio
import hashlib
import logging
import os
import threading
import time
import traceback
from concurrent.futures import (
    CancelledError as SyncCancelledError,
    Future as SyncFuture,
    ThreadPoolExecutor,
    TimeoutError as SyncTimeoutError,
)
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import cloudpickle

from ray_tpu_torch import exceptions as exc
from ray_tpu_torch._private import (
    faultpoints,
    flight,
    memtrack,
    protocol,
    serialization,
    specframe,
    taskpath,
)
from ray_tpu_torch._private.asyncio_util import spawn_logged, spawn_threadsafe
from ray_tpu_torch._private.backoff import Backoff
from ray_tpu_torch._private.ids import (
    ActorID,
    JobID,
    NodeID,
    ObjectID,
    TaskID,
    WorkerID,
)
from ray_tpu_torch.native.arena import HybridShmStore
from ray_tpu_torch._private.ringconn import MessageTooBig
from ray_tpu_torch._private.serialization import SerializationContext
from ray_tpu_torch.object_ref import ObjectRef, collect_refs_during

logger = logging.getLogger(__name__)

# In-flight marker for the actor-push corr-dedup cache (_apush_begin).
_APUSH_WIP = object()

# Reply-window dwell below this records no ``reply-window`` phase span:
# the ring hot path's normal dwell is one sink micro-batch (~1ms) and a
# per-result span there is pure instrumentation tax; the unrecorded
# sliver stays inside derived reply-ack (never disappears from the sum).
_WINDOW_DWELL_MIN_S = 0.002


def _lineage_bytes_limit() -> int:
    from ray_tpu_torch._private.config import rt_config

    return rt_config.lineage_bytes

_DEBUG_TODO = ("util.debug profiling is not ported to ray_tpu_torch yet "
               "(ROADMAP queue 1 item 6)")

INLINE_OBJECT_MAX = 100 * 1024  # small objects travel inline / live in memory store
FN_NS = "fn"

# Actor identity for async actor methods (sync methods use the thread-local
# CoreWorker.current_actor_id; coroutines need a contextvar instead).
import contextvars

_async_actor_id: contextvars.ContextVar = contextvars.ContextVar(
    "rt_async_actor_id", default=None
)
_async_task_id: contextvars.ContextVar = contextvars.ContextVar(
    "rt_async_task_id", default=None
)


def current_task_id_hex() -> Optional[str]:
    """Task ID of the currently-executing task/actor method, or None."""
    tid = _async_task_id.get()
    if tid is not None:
        return tid
    w = global_worker
    if w is None:
        return None
    tid = getattr(w.current_task_id, "value", None)
    return tid.hex() if tid is not None else None


def current_actor_id_hex() -> Optional[str]:
    """Actor ID of the currently-executing actor method/constructor, or None
    (reference: ``runtime_context.get_actor_id``)."""
    aid = _async_actor_id.get()
    if aid is not None:
        return aid
    w = global_worker
    if w is None:
        return None
    return getattr(w.current_actor_id, "value", None)


def _loads_maybe(frames):
    ctx = SerializationContext()
    return ctx.deserialize_frames(frames)


def _intern_worthy(a) -> bool:
    """Cheap pre-serialization shape test for per-arg framing: splitting
    an argument into its own frames costs one extra serialize per call,
    so only shapes that can plausibly repeat at or above
    ``arg_intern_min_bytes`` (the "same config dict to 10k tasks" shape)
    earn a section. Varying scalars and tiny strings stay inline in the
    skeleton — they would never intern anyway."""
    if isinstance(a, (dict, list, tuple, set, frozenset)):
        return bool(a)
    if isinstance(a, (str, bytes, bytearray)):
        return len(a) >= 64
    return not isinstance(a, (bool, int, float, complex, type(None)))


@dataclass(eq=False)  # identity eq: `slot in slots` must not field-compare
class _LeaseSlot:
    node_id: str
    addr: Tuple[str, int]
    busy: int = 0
    draining: bool = False  # evicted (e.g. OOM); release once in-flight done
    # When this slot last went idle: per-slot release (an idle slot pins a
    # whole CPU at the head — holding it while a sibling slot runs a long
    # task starves every other lease requester, e.g. nested tasks).
    idle_since: float = field(default_factory=time.monotonic)
    # Adaptive in-flight push window (specframe.PushWindow), created on
    # first push when rt_config.push_window is on; None = fixed fan-out.
    pwin: Any = None
    # Loop-side rendezvous for pushers parked on a full window: every
    # settle/release sets it, parked siblings re-check their grant.
    win_event: Any = None
    # Round 20: the pusher-shard loop this slot's pushers first ran on
    # (peer-address affinity invariant — the window/event above are only
    # single-loop-safe because a slot never migrates between shards).
    shard_loop: Any = None


class _LeaseSet:
    """Cached leases + pending queue for one scheduling key."""

    def __init__(self, resources: Dict[str, float], strategy: dict):
        self.resources = resources
        self.strategy = strategy
        self.slots: List[_LeaseSlot] = []
        # deque: pushers pop from the FRONT; a list's pop(0) memmoves the
        # whole backlog per task (O(n^2) across a queued-1M submission).
        self.pending: deque = deque()
        # Round 20: guards the peek+pop sections of the pack loop ONLY
        # when pushers run on sharded loops (two shards draining one
        # scheduling key would otherwise race the head item). The
        # single-loop path never takes it.
        self.plock = threading.Lock()
        self.requesting = False
        self.rr = 0  # rotating slot-pick cursor (see _pump_leases)
        # True after a full rotation found no pusher headroom; cleared when
        # any pusher finishes or the slot set changes. Skips the O(slots)
        # scan per queued item while the backlog is deep.
        self.saturated = False
        # node_id -> monotonic deadline: avoid leasing there (OOM backoff)
        self.avoid: Dict[str, float] = {}
        self.last_active = time.monotonic()
        self.reaper_running = False
        # Taskpath plane: when the last lease grant landed, and whether it
        # activated a warm-pool standby — names a queued task's wait
        # (submit-queue vs lease-wait vs warm-pool-hit) at pop time.
        self.last_grant_t = 0.0
        self.last_grant_warm = False


class _PendingActorCreate:
    """One deferred (batched) actor creation: wire payload until the
    batch flushes, rendezvous after. ``event`` serves caller threads
    (handle serialization, kill); ``fut`` serves coroutines and is
    created by the loop-side drain."""

    __slots__ = ("aid", "header", "frames", "borrows", "event", "fut",
                 "error")

    def __init__(self, aid: str, header: dict, frames: List[bytes],
                 borrows: list):
        self.aid = aid
        self.header = header
        self.frames = frames
        self.borrows = borrows
        self.event = threading.Event()
        self.fut: Optional[asyncio.Future] = None
        self.error: Optional[str] = None


class _ActorChannel:
    """Caller-side channel to one actor: ordered seq numbers + reconnect."""

    def __init__(self, actor_id: str, addr: Optional[Tuple[str, int]]):
        self.actor_id = actor_id
        self.addr = tuple(addr) if addr else None
        self.seq = 0
        self.epoch = 0  # bumps on every (re)connect: a fresh ordering domain
        self.conn: Optional[protocol.Connection] = None
        self.lock = asyncio.Lock()
        self.dead = False
        self.death_reason = ""


class _ActorInstance:
    """Executor-side state for one hosted actor.

    Concurrency groups (reference:
    ``core_worker/task_execution/concurrency_group_manager.h:38``): each
    named group gets its OWN executor pool and async semaphore, so a slow
    call in one group (a long "compute" step) cannot block calls routed to
    another (a "health" ping). The unnamed default group uses
    max_concurrency. Per-caller ordered admission stays global — order is
    decided at queue time, isolation at execution time."""

    def __init__(self, actor_id: str, instance, max_concurrency: int,
                 is_async: bool,
                 concurrency_groups: Optional[Dict[str, int]] = None):
        self.actor_id = actor_id
        self.instance = instance
        self.is_async = is_async
        self.max_concurrency = max_concurrency
        self.pool = ThreadPoolExecutor(
            max_workers=max_concurrency, thread_name_prefix=f"actor-{actor_id[:8]}"
        )
        self.groups: Dict[str, ThreadPoolExecutor] = {}
        # Coroutine methods execute on the dedicated async-actor loop, and
        # an asyncio.Semaphore binds to the loop that first acquires it —
        # concurrency gating for coroutines happens THERE, never on the
        # core loop (sync methods are bounded by their thread pools).
        self.async_sem = asyncio.Semaphore(max_concurrency)
        self.async_group_sems: Dict[str, asyncio.Semaphore] = {}
        for gname, limit in (concurrency_groups or {}).items():
            self.groups[gname] = ThreadPoolExecutor(
                max_workers=max(int(limit), 1),
                thread_name_prefix=f"actor-{actor_id[:8]}-{gname}",
            )
            self.async_group_sems[gname] = asyncio.Semaphore(
                max(int(limit), 1)
            )
        # per-caller ordered admission; seq_lock makes the cursor safe to
        # read/advance from the ring pump thread (fast dispatch) as well as
        # the event loop (slow path)
        self.seq_lock = threading.Lock()
        self.next_seq: Dict[str, int] = {}
        self.buffered: Dict[str, Dict[int, Any]] = {}
        self.num_executed = 0
        self.exiting = False

    def resolve_group(self, method, header) -> Optional[str]:
        """Group for this call: per-call override beats the method's
        declared group (reference: per-task concurrency_group_name in
        ``PushTask``). Returns None for the default group; raises KeyError
        for an unknown name."""
        gname = header.get("cg") or getattr(
            method, "_rt_concurrency_group", None
        )
        if gname is None:
            return None
        if gname not in self.groups:
            raise KeyError(gname)
        return gname

    def pool_for(self, gname: Optional[str]) -> ThreadPoolExecutor:
        return self.pool if gname is None else self.groups[gname]

    def async_sem_for(self, gname: Optional[str]) -> asyncio.Semaphore:
        return (
            self.async_sem if gname is None
            else self.async_group_sems[gname]
        )


class CoreWorker:
    def __init__(
        self,
        *,
        is_driver: bool,
        gcs_addr: Tuple[str, int],
        job_id: JobID,
        node_resources: Optional[Dict[str, float]] = None,
        node_labels: Optional[Dict[str, str]] = None,
        loop: Optional[asyncio.AbstractEventLoop] = None,
        head: Optional[object] = None,
        standby: bool = False,
    ):
        self.is_driver = is_driver
        # Warm worker pool membership: registered but unschedulable until
        # the head activates this node (see gcs._activate_standby).
        self.node_standby = standby
        self.gcs_addr = gcs_addr
        self.job_id = job_id
        self.worker_id = WorkerID.from_random()
        self.node_id = NodeID.from_random().hex()
        self.node_resources = dict(node_resources or {})
        # Slot marker backing zero-CPU tasks/actors (_build_resources maps
        # num_cpus=0 to 0.001 node:slot): every node advertises capacity for
        # 1000 of them.
        self.node_resources.setdefault("node:slot", 1.0)
        self.node_labels = node_labels or {}
        self.head = head  # in-process HeadService when this is the head driver

        self.loop = loop
        self.loop_thread: Optional[threading.Thread] = None
        self.server: Optional[protocol.RpcServer] = None
        self.addr: Optional[Tuple[str, int]] = None
        self.gcs: Optional[protocol.Connection] = None
        self.peers: Dict[Tuple[str, int], protocol.Connection] = {}
        self.peer_lock: Optional[asyncio.Lock] = None

        self.ctx = SerializationContext()
        # Built lazily (see .shm): the arena name is derived from the head
        # address, which for the in-process head is only known post-start.
        self._shm: Optional[HybridShmStore] = None
        # object hex -> ("mem", header, frames) | ("shm", meta) |
        # ("err", exception)
        self.memory_store: Dict[str, tuple] = {}
        self.store_events: Dict[str, asyncio.Event] = {}
        # ownership: object hex -> {"count": local refs, "borrows": int}
        self.owned: Dict[str, dict] = {}
        self.current_task_id = threading.local()
        self.current_actor_id = threading.local()
        self.put_counter = threading.local()

        self.fn_cache: Dict[str, Any] = {}
        self.exported_fns: set = set()
        # --- submission plane batching & caching (round 10) ---
        # Pre-framed push_task spec templates: (fkey, name, retries) ->
        # packed msgpack bytes spliced into each wire message as frame 0.
        self._spec_templates: Dict[tuple, bytes] = {}
        # Receiver-side decode cache for those spec frames.
        self._spec_cache = specframe.SpecCache()
        # Function-blob push-through: blobs we can piggyback on the first
        # push of an fkey to each peer (and per-peer coverage tracking).
        self._fn_push = specframe.FnPushLedger()
        # --- reply-plane batching & arg interning (round 15) ---
        from ray_tpu_torch._private.config import rt_config as _rtc

        # Gates cached once: these sit on per-task hot paths where an
        # env lookup per call would cost more than the feature saves.
        self._reply_batching = bool(_rtc.reply_batching)
        self._arg_interning = bool(_rtc.arg_interning)
        self._arg_intern_min = int(_rtc.arg_intern_min_bytes)
        self._arg_intern_max = int(_rtc.arg_intern_max_bytes)
        # Sender-side (peer, digest) coverage + executing-side byte-LRU
        # for interned argument frames (specframe siblings of
        # FnPushLedger/SpecCache).
        self._arg_ledger = specframe.ArgLedger()
        self._arg_intern = specframe.ArgInternCache(
            int(_rtc.arg_intern_cache_bytes)
        )
        # Connections with an open ReplyWindow (shutdown must flush them:
        # buffered results never die with the process).
        self._reply_windows: List[Any] = []
        # --- transit-plane pacing (round 16) ---
        # Adaptive in-flight push windows: per-slot AIMD congestion
        # control replacing the fixed 16x16 fan-out (gate + knobs cached
        # once — these sit in the per-chunk pack loop).
        self._push_window = bool(_rtc.push_window)
        self._pwin_initial = int(_rtc.push_window_initial)
        self._pwin_floor = int(_rtc.push_window_floor)
        self._pwin_ceiling = int(_rtc.push_window_ceiling)
        self._pwin_factor = float(_rtc.push_window_latency_factor)
        # Retired per-peer window stats (slots released by the reaper
        # fold their peak/grow/shrink counters here; bounded by peers).
        self._pwin_retired: Dict[str, dict] = {}
        # Hot-path caches: rt_config attribute reads parse the env per
        # call — far too dear for once-per-task sites (re-arm deadline,
        # dedup-cache trim horizon).
        self._push_deadline_s = float(_rtc.rpc_deadline_s)
        self._apush_horizon_s = 2.0 * self._push_deadline_s + 5.0
        self._apush_done_n = 0
        # --- driver loop scale-out (round 20) ---
        # Three planes, created in start_driver (driver-only; gates
        # cached here so hot paths pay one attribute read): the settle
        # plane moves reply splitting/future routing off the event loop,
        # the pack plane moves per-task submit accounting off the caller
        # hot path, and pusher shards move chunk packing + push pacing
        # onto dedicated loops keyed by peer address.
        # Settle auto stand-down on single-core hosts (the pusher-shard
        # auto discipline applied to the plane thread): with one CPU the
        # plane thread competes with the event loop for the GIL, so
        # every TCP reply handoff pays a scheduler round-trip with zero
        # parallel win (on one core the queued plane's reply dwell is
        # several times the inline settle's).
        # An EXPLICIT RT_DRIVER_SETTLE_THREAD setting wins either way
        # (tests pin the plane live on small hosts with =1). The pack
        # plane has no such guard: its win — O(drains) loop-enqueue
        # wakeups instead of O(tasks) — relieves the loop on any host.
        multi_core = (os.cpu_count() or 1) >= 2
        self._settle_thread = bool(_rtc.driver_settle_thread) and (
            multi_core or "RT_DRIVER_SETTLE_THREAD" in os.environ)
        self._submit_pack = bool(_rtc.submit_pack_thread)
        self._settle_plane: Optional[specframe.SettlePlane] = None
        self._pack_plane: Optional[specframe.PlaneQueue] = None
        if is_driver:
            # Created here (not in start_driver) so BOTH driver boot
            # paths — local cluster and explicit-address connect — have
            # the planes up before _async_setup attaches connections.
            if self._settle_thread:
                self._settle_plane = specframe.SettlePlane()
            if self._submit_pack:
                self._pack_plane = specframe.PlaneQueue(
                    "rt-submit-pack", worker=self._pack_drain,
                    maxsize=4096,
                )
        self._pusher_loops: List[Any] = []
        self._pusher_threads: List[threading.Thread] = []
        self._pusher_shard_stats: List[Dict[str, int]] = []
        # Function-table miss coalescing: fkey -> shared load future, plus
        # the keys queued for the next batched kv_get_batch.
        self._fn_loading: Dict[str, asyncio.Future] = {}
        self._fn_fetch_keys: List[str] = []
        self._fn_fetch_scheduled = False
        # Deferred (batched) actor creations: aid -> _PendingActorCreate
        # while the creation has not reached the head yet.
        self._actor_creating: Dict[str, _PendingActorCreate] = {}
        self._acreate_buf: List[_PendingActorCreate] = []
        self._acreate_lock = threading.Lock()
        self._acreate_scheduled = False
        self._acreate_inflight = False
        self.leases: Dict[tuple, _LeaseSet] = {}
        self.actor_channels: Dict[str, _ActorChannel] = {}
        self.hosted_actors: Dict[str, _ActorInstance] = {}
        self.task_executor: Optional[ThreadPoolExecutor] = None
        self.num_task_slots = int(self.node_resources.get("CPU", 1)) or 1
        # Native transfer-server address, set in start() when available.
        self.xfer_addr: Optional[Tuple[str, int]] = None
        # Streaming-generator tasks this worker submitted:
        # tid hex -> {"count": total or None, "event": asyncio.Event,
        #             "produced": int, "consumed": int, "abandoned": bool,
        #             "conn": producer connection (set on first item)}
        self._task_streams: Dict[str, dict] = {}
        # Streams this worker is EXECUTING: tid hex -> {"consumed": int,
        # "event": asyncio.Event} (owner credits; bounds in-flight items)
        self._stream_credits: Dict[str, dict] = {}
        self._shutdown = False
        self._stats = {"tasks_executed": 0, "tasks_submitted": 0,
                       "spec_templates_built": 0,
                       # reply-plane economics (tests assert O(bursts))
                       "reply_windows_flushed": 0,
                       "reply_results_coalesced": 0,
                       # arg-interning economics (bytes that stayed home)
                       "arg_frames_interned": 0,
                       "arg_intern_bytes_saved": 0,
                       "arg_blobs_pushed": 0,
                       "arg_intern_miss_retries": 0,
                       # transit-plane economics (round 16; tests assert
                       # O(drains) executor wakeups, not O(messages))
                       "pump_batch_calls": 0,
                       "pump_batch_items": 0,
                       "pump_exec_wakeups": 0,
                       "push_window_shrinks": 0,
                       "push_window_waits": 0,
                       # driver loop scale-out (round 20; must stay 0 —
                       # a break means slot affinity failed and a slot's
                       # window crossed shard loops)
                       "pusher_shard_affinity_breaks": 0}
        # Submission batching: driver threads enqueue dispatch coroutines
        # here; ONE call_soon_threadsafe wakes the loop per burst instead of
        # one per task (the self-pipe write is a syscall per call).
        self._submit_buf: List[tuple] = []
        self._submit_lock = threading.Lock()
        self._submit_scheduled = False
        # Same-host shm-ring transport (native/src/ring.cc): addr -> live
        # RingConnection, or False = known-unavailable. Rings we serve (we
        # attached as side B) are kept for teardown.
        self._ring_peers: Dict[Tuple[str, int], Any] = {}
        self._ring_seq = 0
        self._served_rings: List[Any] = []
        # Lineage: producing-task specs for owned return objects so a lost
        # object can be reconstructed by resubmitting its task (reference:
        # object_recovery_manager.h:41 + reference_counter lineage pinning).
        # Byte-bounded; eviction disables reconstruction for old tasks.
        # OrderedDict: eviction pops the OLDEST entry. A plain dict's
        # next(iter(...)) rescans every tombstoned front slot per eviction
        # (O(n^2) across a long run);
        # popitem(last=False) is the O(1) linked-list pop.
        self._lineage: "OrderedDict[str, dict]" = OrderedDict()
        self._lineage_bytes = 0
        # runtime-env venv executors: (env key, py_modules) -> subprocess;
        # builds serialize per key so cold installs don't stall other envs
        self._env_executors: Dict[tuple, Any] = {}
        self._env_exec_keylocks: Dict[tuple, threading.Lock] = {}
        self._env_exec_lock = threading.Lock()
        self._LINEAGE_MAX_BYTES = int(
            _lineage_bytes_limit()
        )
        self._reconstructing: set = set()
        self._task_events_buf: List[dict] = []
        # GC'd ObjectRef ids awaiting a refcount decrement on the core loop
        # (deque: appends are thread-safe under the GIL; drained in one
        # callback per burst — see _install_ref_hooks).
        self._release_queue: deque = deque()
        self._release_drain_scheduled = False
        # Borrower-side refcounts for refs we deserialized but do not own:
        # hex -> {"count": local live refs, "owner": addr}. A first
        # deserialize registers a borrow with the owner; the last local
        # release returns it (reference: borrow tracking in
        # ``reference_counter.h`` — the sender's credit only pins the ref
        # for the CONTAINER's lifetime, so holders must pin their own).
        self.borrowed: Dict[str, dict] = {}
        self._borrow_queue: deque = deque()
        self._borrow_drain_scheduled = False
        from ray_tpu_torch._private.memory_monitor import MemoryMonitor

        self._memory_monitor = MemoryMonitor()
        self.runtime_env: dict = {}
        self.pubsub_handlers: Dict[str, List[Any]] = {}
        # Correlation-id dedup for retried push_actor_task (mirrors the
        # head's _corr_replies, but thread-safe: the ring fast paths
        # execute and reply off-loop). corr -> _APUSH_WIP (executing) |
        # SyncFuture (a retry is waiting on the execution) |
        # (extras, frames) completed reply, in a bounded LRU. Only
        # successful replies are cached; failures are retried for real.
        self._apush_replies: "OrderedDict[str, Any]" = OrderedDict()
        self._apush_lock = threading.Lock()
        self._APUSH_CACHE = 256
        # Flight-recorder process label for merged cross-process traces.
        flight.set_label("driver" if is_driver else self.node_id[:8])

    @property
    def shm(self) -> HybridShmStore:
        """Session-scoped object store: every process on this machine maps the
        same native arena, named after the head address."""
        if self._shm is None:
            port = self.gcs_addr[1]
            arena = f"/rt_arena_{port}_{os.getuid()}" if port else None
            self._shm = HybridShmStore(arena)
            self._shm.spill_handler = self._spill_for_space
        return self._shm

    def _spill_for_space(self, need: int) -> int:
        """Free arena space by spilling this process's oldest sealed objects
        to disk (reference: ``local_object_manager.h:144`` SpillObjects).
        Returns bytes freed. Any process may spill its own objects — the
        arena's pin/delete protocol makes concurrent readers safe, and the
        head's directory entry is updated so every other process finds the
        disk copy on its next lookup."""
        arena = self._shm.arena if self._shm is not None else None
        if arena is None:
            return 0
        # Gather the batch first (oldest sealed objects up to `need`),
        # then write it in PARALLEL on the spill IO pool (reference:
        # SpillObjects batches; IO workers run the writes).
        batch = []
        batched = 0
        for hex_ in list(arena._created):  # insertion order = oldest first
            if batched >= need:
                break
            frames = arena.get_frames(hex_, {})
            if frames is None:
                continue
            batch.append((hex_, frames))
            batched += sum(len(f) for f in frames)
        metas = self._shm.spill.spill_many(batch)
        freed = 0
        regs = []
        for (hex_, _frames), meta in zip(batch, metas):
            if meta is None:
                continue  # write failed (storage unavailable); keep in arena
            arena.free(hex_)
            freed += meta["size"]
            # "addr" routes readers that cannot open the uri (other hosts,
            # different backend) to this worker's RPC service, which
            # serves the spilled bytes. "owner" keeps the directory entry
            # attributable after the spill flips its kind (leak detection
            # matches on it).
            meta = dict(
                meta, node=self.node_id,
                addr=list(self.addr) if self.addr else None,
                owner=list(self.addr or ()),
            )
            if hex_ in self.memory_store:
                self.memory_store[hex_] = ("shm", meta)
            regs.append((hex_, meta))
        # Read pins ride the frame views inside `batch`; dropping it lets
        # the finalizers release them so the freed blocks actually reclaim.
        del batch
        if regs:
            def register():
                for hex_, meta in regs:
                    try:
                        self.gcs.notify(
                            "object_register", {"oid": hex_, "meta": meta}
                        )
                    except protocol.ConnectionLost:
                        return
            try:
                self.loop.call_soon_threadsafe(register)
            except RuntimeError:
                pass
            logger.info("spilled %d object(s), %.1f MB freed",
                        len(regs), freed / 1e6)
        return freed

    # ------------------------------------------------------------------ setup

    def start_driver(self):
        """Start core loop thread + service and connect to the head."""
        ready = threading.Event()

        def runner():
            self.loop = asyncio.new_event_loop()
            asyncio.set_event_loop(self.loop)
            self.loop.run_until_complete(self._async_setup())
            ready.set()
            self.loop.run_forever()

        self.loop_thread = threading.Thread(
            target=runner, name="rt-core-loop", daemon=True
        )
        self.loop_thread.start()
        if not ready.wait(timeout=30):
            raise RuntimeError("core loop failed to start")
        self._start_pusher_shards()
        self._install_ref_hooks()

    def _start_pusher_shards(self):
        """Round 20: spin up the sharded pusher loops (driver-only).
        Lease slots hash by peer address onto these loops in
        _pump_leases; everything a pusher must touch on the MAIN loop
        (peer/ring connect, task-reply application, slot bookkeeping)
        marshals across explicitly in _slot_pusher."""
        from ray_tpu_torch._private.config import rt_config

        n = int(rt_config.pusher_loop_shards)
        if n < 0:
            n = min(2, (os.cpu_count() or 1) - 1)
        for i in range(max(n, 0)):
            ready = threading.Event()
            holder: Dict[str, Any] = {}

            def runner(ready=ready, holder=holder):
                loop = asyncio.new_event_loop()
                asyncio.set_event_loop(loop)
                holder["loop"] = loop
                ready.set()
                loop.run_forever()

            t = threading.Thread(
                target=runner, name=f"rt-pusher-{i}", daemon=True
            )
            t.start()
            if not ready.wait(timeout=10):
                logger.warning("pusher shard %d failed to start", i)
                continue
            self._pusher_loops.append(holder["loop"])
            self._pusher_threads.append(t)
            self._pusher_shard_stats.append({"chunks": 0, "tasks": 0})

    @staticmethod
    def _tune_gc():
        """Freeze the post-import heap out of the cyclic GC and raise the
        collection cadence (reference behavior: the C++ core never pays a
        tracing-GC pause on the task path; CPython must be told not to).
        With millions of live refs/lineage records, default thresholds make
        full collections O(heap) pauses every few thousand allocations.
        Cycles still collect, just less often. RT_GC_TUNING=0 opts
        out."""
        from ray_tpu_torch._private.config import rt_config

        if not rt_config.gc_tuning:
            return
        import gc

        gc.collect()
        gc.freeze()
        gc.set_threshold(50_000, 20, 20)

    async def _async_setup(self):
        self._tune_gc()
        self.peer_lock = asyncio.Lock()
        self.ring_lock = asyncio.Lock()
        if self.is_driver:
            # Create the session arena now so the *driver* owns it: the driver
            # is the one process guaranteed to run close_all at shutdown, so
            # the /dev/shm segment gets unlinked (workers die by SIGTERM).
            _ = self.shm
        self.task_executor = ThreadPoolExecutor(
            max_workers=max(self.num_task_slots, 4),
            thread_name_prefix="rt-task",
        )
        self.server = protocol.RpcServer(self._handle_rpc)
        self.addr = await self.server.start()
        # Native object-transfer server (reference: the object_manager data
        # plane, ``object_manager.h:128``): serves this worker's shm-backed
        # objects over TCP so remote hosts pull bulk payloads through C++
        # instead of the Python RPC plane. Binds the SAME host the RPC plane
        # advertises (no wider), and starts in an executor — the first call
        # may compile the library and must not stall the event loop.
        from ray_tpu_torch._private.config import rt_config
        if rt_config.native_xfer:
            try:
                from ray_tpu_torch.native import xfer as native_xfer

                port = await asyncio.get_running_loop().run_in_executor(
                    None, native_xfer.start_server, self.addr[0]
                )
                if port:
                    self.xfer_addr = (self.addr[0], port)
            except Exception:
                logger.debug("native xfer server unavailable", exc_info=True)
        # Object-free fan-out: evict borrowed copies when the owner frees.
        self.pubsub_handlers.setdefault("object_free", []).append(
            lambda data, frames: self._evict_freed(data.get("oids", []))
        )
        # Demand-driven lease return: the head asks when a placement can't
        # fit; cached idle slots go back NOW instead of after the reaper's
        # idle window (otherwise a task burst pins node CPUs for ~1s and a
        # placement-group create right behind it stalls).
        self.pubsub_handlers.setdefault("lease_reclaim", []).append(
            lambda data, frames: self._reclaim_idle_leases()
        )
        # Live worker-log echo (reference: print_worker_logs — remote task
        # prints appear on the driver, prefixed with worker/node). Job-
        # scoped: lines from other jobs' workers stay out of this driver's
        # terminal. RT_LOG_TO_DRIVER=0 silences the echo (files + rt logs
        # still capture everything).
        if self.is_driver and os.environ.get("RT_LOG_TO_DRIVER", "1") != "0":
            from ray_tpu_torch._private.log_monitor import print_worker_logs

            my_job = self.job_id.hex() if self.job_id else ""

            def _echo(data, frames):
                # Own-job lines, plus lines from shared workers (spawned
                # outside any driver job — rt start / autoscaler nodes).
                if data.get("shared") or data.get("job_id") in ("", my_job):
                    print_worker_logs(data)

            self.pubsub_handlers.setdefault("worker_logs", []).append(_echo)
        await self._connect_gcs()
        spawn_logged(self.loop, self._task_event_flusher(),
                     "worker.task_event_flusher")
        if not self.is_driver:
            from ray_tpu_torch._private.config import rt_config

            if rt_config.oom_kill:
                threading.Thread(
                    target=self._pressure_killer_loop, daemon=True,
                    name="rt-oomkill",
                ).start()

    async def _connect_gcs(self):
        """Connect + subscribe + (re-)register with the head. Shared by
        startup and the head-restart rejoin path (reference: raylets
        reconnect to a restarted GCS and re-register,
        ``gcs_init_data.cc`` replay)."""
        from ray_tpu_torch._private.config import rt_config

        tmo = float(rt_config.rpc_deadline_s)
        self.gcs = await protocol.connect(
            self.gcs_addr, self._handle_rpc, name="gcs-client"
        )
        self.gcs.settle_plane = self._settle_plane
        self.gcs.on_close = self._on_gcs_lost
        # Every registration call is deadline-bounded: a head that accepts
        # the TCP connection but drops replies must kick us back into the
        # reconnect loop, not wedge it forever mid-handshake.
        # Subscribe to EVERY channel with a registered handler (plus the
        # built-ins): a restarted head has an empty subscriber table, so
        # reconnect must restore late-registered channels too (e.g. serve
        # replica-change pushes), not just the boot-time set.
        for channel in {"object_free", "lease_reclaim",
                        *self.pubsub_handlers}:
            await asyncio.wait_for(
                self.gcs.call("subscribe", {"channel": channel}), tmo
            )
        # Cluster-wide config overrides (init(_system_config=...)) live in
        # the head KV; every process applies them at (re)connection —
        # the reference passes _system_config on raylet command lines.
        try:
            hh, frames = await asyncio.wait_for(
                self.gcs.call(
                    "kv_get", {"ns": "__rt", "key": "system_config"}
                ),
                tmo,
            )
            if hh.get("found") and frames:
                import json as _json

                from ray_tpu_torch._private.config import rt_config

                rt_config.apply_system_config(_json.loads(frames[0]))
        except (asyncio.TimeoutError, protocol.RpcError, ValueError) as e:
            logger.debug("system-config fetch failed, using defaults: %s", e)
        if self.is_driver:
            await asyncio.wait_for(
                self.gcs.call(
                    "register_job", {"job_id": self.job_id.hex()}
                ),
                tmo,
            )
        else:
            hosted = [
                {"actor_id": aid, **getattr(inst, "public_meta", {})}
                for aid, inst in self.hosted_actors.items()
                if not inst.exiting
            ]
            reg = {
                "node_id": self.node_id,
                "addr": list(self.addr),
                "resources": self.node_resources,
                "labels": self.node_labels,
                "hosted_actors": hosted,
            }
            if self.node_standby:
                # Warm pool: registered but unschedulable until activated.
                # Re-registration after a head restart keeps the flag only
                # if nothing was scheduled here yet (hosted actors imply
                # the head activated us before it restarted).
                reg["standby"] = not hosted
            await asyncio.wait_for(
                self.gcs.call("register_node", reg),
                tmo,
            )

    def _on_gcs_lost(self, conn):
        if self._shutdown or self.loop is None:
            return
        try:
            self.loop.call_soon_threadsafe(
                lambda: spawn_logged(self.loop, self._reconnect_gcs(),
                                     "worker.reconnect_gcs")
            )
        except RuntimeError:
            pass

    async def _reconnect_gcs(self):
        """Head connection lost: retry with backoff so a restarted head
        re-adopts this process (live-cluster rejoin). Cached leases are
        dropped first — a restarted head has no memory of granting them,
        and using them would dispatch onto capacity the new head already
        counts as free."""
        if self._shutdown:
            return
        # Single reconnect loop at a time: a connect that succeeds but dies
        # during subscribe fires on_close again; a second loop would race
        # this one and leak a registered connection.
        if getattr(self, "_gcs_reconnecting", False):
            return
        if self.gcs is not None and not self.gcs._closed:
            return  # already reconnected
        self._gcs_reconnecting = True
        try:
            await self._reconnect_gcs_inner()
        finally:
            self._gcs_reconnecting = False

    async def _reconnect_gcs_inner(self):
        from ray_tpu_torch._private.config import rt_config

        for lease_set in self.leases.values():
            lease_set.slots = [s for s in lease_set.slots if s.busy > 0]
        deadline = time.monotonic() + float(
            rt_config.head_reconnect_s
        )
        delay = 0.25
        while not self._shutdown and time.monotonic() < deadline:
            try:
                await self._connect_gcs()
                logger.info(
                    "reconnected to head at %s:%d", *self.gcs_addr
                )
                return
            except (asyncio.TimeoutError, OSError, protocol.ConnectionLost,
                    protocol.RpcError):
                # A handshake that died mid-way (e.g. subscribe deadline)
                # leaves an open half-registered connection: close it so
                # the next attempt starts clean instead of leaking one
                # connection per retry.
                if self.gcs is not None and not self.gcs._closed:
                    await self.gcs.close()
                await asyncio.sleep(delay)
                delay = min(delay * 2, 2.0)
        if not self._shutdown:
            logger.warning(
                "head at %s:%d did not come back within the rejoin window",
                *self.gcs_addr,
            )

    def _install_ref_hooks(self):
        worker = self

        def release(object_id: ObjectID):
            # Coalesce: a container GC can drop 10k+ refs back-to-back (one
            # __del__ per element); one loop callback per ref floods the
            # event loop for seconds and starves control RPCs (observed:
            # 150x pg-churn collapse right after a 10k-ref get). Queue the
            # ObjectID and schedule a single drain per burst — the hex
            # conversion happens on the loop thread, off the GC'ing
            # thread's critical path.
            if worker._shutdown or worker.loop is None:
                return
            worker._enqueue_ref_op(("dec", object_id))

        def on_deserialize(ref: ObjectRef):
            # A materialized ref must pin itself: the sender's credit dies
            # with the containing object, and the user may outlive it
            # (e.g. shuffle piece refs returned from a map task).
            if worker._shutdown or worker.loop is None:
                return
            owner = tuple(ref.owner_address or ())
            if not owner:
                return
            worker._borrow_queue.append((ref.id().hex(), owner))
            if worker._borrow_drain_scheduled:
                return
            worker._borrow_drain_scheduled = True
            try:
                worker.loop.call_soon_threadsafe(worker._drain_borrows)
            except RuntimeError:
                worker._borrow_drain_scheduled = False

        def on_deserialize_batch(refs):
            # One queue entry + one wakeup for a whole deserialized value,
            # however many refs it nests. Hex/owner-tuple bookkeeping for
            # every ref moves to the loop-side drain, off the deserializing
            # thread (the get-10k-refs hot path).
            if worker._shutdown or worker.loop is None:
                return
            worker._borrow_queue.append((None, refs))
            if worker._borrow_drain_scheduled:
                return
            worker._borrow_drain_scheduled = True
            try:
                worker.loop.call_soon_threadsafe(worker._drain_borrows)
            except RuntimeError:
                worker._borrow_drain_scheduled = False

        ObjectRef._release_hook = release
        ObjectRef._deserialize_hook = on_deserialize
        ObjectRef._deserialize_batch_hook = on_deserialize_batch

    def run_sync(self, coro, timeout=None):
        fut = asyncio.run_coroutine_threadsafe(coro, self.loop)
        try:
            return fut.result(timeout)
        except SyncTimeoutError:
            # The caller is giving up: the scheduled coroutine must not
            # keep running (and holding store events, RPC futures, borrow
            # pins) as an orphan on the core loop. cancel() no-ops if the
            # coroutine won the race and completed.
            fut.cancel()
            raise

    async def _head_call(self, method, extras=None, frames=(), *,
                         timeout=None, retries=None, corr=False):
        """Head RPC with a real per-attempt deadline and jittered retries.

        A dropped reply used to hang the calling verb forever (the bare
        ``gcs.call`` future only resolves on reply or connection
        teardown); here each attempt is bounded by ``timeout``
        (default ``rt_config.rpc_deadline_s``) and timeouts / connection
        losses / "unavailable" errors re-issue up to ``retries`` times
        with jittered backoff (reference: retryable_grpc_client.cc
        retrying UNAVAILABLE under a deadline).

        ``corr=True`` attaches a correlation id shared by every attempt of
        this logical request: the head replays the original reply for a
        retry whose predecessor was applied but unacknowledged, so
        non-idempotent verbs (lease, create_actor, create_pg) never
        double-apply.
        """
        from ray_tpu_torch._private.config import rt_config

        if timeout is None:
            timeout = float(rt_config.rpc_deadline_s)
        if retries is None:
            retries = int(rt_config.rpc_retries)
        extras = dict(extras or {})
        if corr:
            extras["corr"] = os.urandom(8).hex()
        fl = flight.ENABLED
        if fl and "corr" not in extras:
            # One flight id for every attempt of this logical request: the
            # head-side dispatch span joins on it.
            extras["fid"] = flight.next_id()
        fl_cid = extras.get("corr") or extras.get("fid")
        retry = Backoff(base=0.05, cap=2.0)
        attempt = 0
        while True:
            if fl:
                fl_t0 = time.monotonic()
            try:
                conn = self.gcs
                if conn is None or conn._closed:
                    raise protocol.ConnectionLost("head connection down")
                res = await asyncio.wait_for(
                    conn.call(method, extras, list(frames)), timeout
                )
                if fl:
                    flight.record(
                        f"head.{method}", fl_cid, "client", fl_t0,
                        time.monotonic(), 0,
                        "ok" if attempt == 0 else f"ok:attempt{attempt + 1}",
                    )
                return res
            except asyncio.TimeoutError as e:
                last: Exception = e
                if fl:
                    flight.record(f"head.{method}", fl_cid, "client",
                                  fl_t0, time.monotonic(), 0, "timeout")
            except (protocol.ConnectionLost, OSError) as e:
                last = e
                if fl:
                    flight.record(f"head.{method}", fl_cid, "client",
                                  fl_t0, time.monotonic(), 0,
                                  f"error:{type(e).__name__}")
            except protocol.RpcError as e:
                if fl:
                    flight.record(f"head.{method}", fl_cid, "client",
                                  fl_t0, time.monotonic(), 0,
                                  f"error:{type(e).__name__}")
                # Application errors are terminal; only the transient
                # unavailability class is worth re-issuing.
                if getattr(e, "code", None) != "unavailable":
                    raise
                last = e
            if attempt >= retries or self._shutdown:
                if isinstance(last, asyncio.TimeoutError):
                    raise protocol.RpcError(
                        f"head rpc {method!r} exceeded its {timeout}s "
                        f"deadline {attempt + 1} time(s)", code="deadline",
                    )
                raise last
            attempt += 1
            await asyncio.sleep(retry.next_delay())

    # ------------------------------------------------------------ connections

    async def get_peer(self, addr: Tuple[str, int]) -> protocol.Connection:
        addr = tuple(addr)
        conn = self.peers.get(addr)
        if conn is not None and not conn._closed:
            return conn
        async with self.peer_lock:
            conn = self.peers.get(addr)
            if conn is not None and not conn._closed:
                return conn
            conn = await protocol.connect(addr, self._handle_rpc, name=f"peer-{addr}")
            conn.settle_plane = self._settle_plane
            self.peers[addr] = conn
            return conn

    # ----------------------------------------------------- ring transport

    async def get_ring(self, addr):
        """Same-host shm-ring transport to the peer at ``addr``; None when
        unavailable (different host, native lib missing, or peer refused).
        The hot task/actor push path prefers this over TCP (reference: the
        C++ core worker's native submission plane,
        ``task_submission/normal_task_submitter.h:86``)."""
        from ray_tpu_torch.native import ring as ring_mod

        addr = tuple(addr)
        cached = self._ring_peers.get(addr)
        if cached is False:
            return None
        if cached is not None and not cached._closed:
            return cached
        if (
            not ring_mod.available()
            or self.addr is None
            or addr[0] != self.addr[0]  # other host: TCP plane
        ):
            return None
        from ray_tpu_torch._private.ringconn import RingConnection

        async with self.ring_lock:  # NOT peer_lock: get_peer acquires that
            cached = self._ring_peers.get(addr)
            if cached is False:
                return None
            if cached is not None and not cached._closed:
                return cached
            conn = await self.get_peer(addr)
            self._ring_seq += 1
            name = f"/rtring_{os.getpid()}_{self._ring_seq}"
            try:
                nring = ring_mod.NativeRing(name, create=True)
            except (OSError, RuntimeError):
                self._ring_peers[addr] = False
                return None
            try:
                await conn.call("ring_attach", {"name": name})
            except (protocol.RpcError, protocol.ConnectionLost):
                nring.detach()
                self._ring_peers[addr] = False
                return None
            rc = RingConnection(
                nring, self.loop, handler=self._handle_rpc,
                name=f"ring-{addr[1]}",
            )
            rc.settle_plane = self._settle_plane
            self._ring_peers[addr] = rc
            # Peer-process death is detected by the TCP conn: closing it
            # closes the ring too (the ring itself has no liveness probe).
            prev = conn.on_close

            def chained(c, _rc=rc, _prev=prev):
                _rc._teardown()
                if _prev is not None:
                    _prev(c)

            conn.on_close = chained
            return rc

    async def rpc_ring_attach(self, h, frames, conn):
        """Peer asks us to serve its shm ring (it created the segment)."""
        from ray_tpu_torch.native import ring as ring_mod

        if not ring_mod.available():
            raise protocol.RpcError("native ring unavailable", code="no_ring")
        from ray_tpu_torch._private.ringconn import RingConnection

        try:
            nring = ring_mod.NativeRing(h["name"], create=False)
        except OSError as e:
            raise protocol.RpcError(f"ring attach failed: {e}")
        rc = RingConnection(
            nring, asyncio.get_running_loop(), handler=self._handle_rpc,
            fast_dispatch=self._ring_fast_dispatch,
            fast_batch=self._ring_fast_dispatch_batch,
            name=f"ringsrv-{h['name']}",
        )
        # keep for teardown; prune dead ones so reconnect churn stays bounded
        self._served_rings = [
            r for r in self._served_rings if not r._closed
        ] + [rc]
        prev = conn.on_close

        def chained(c, _rc=rc, _prev=prev):
            _rc._teardown()
            if _prev is not None:
                _prev(c)

        conn.on_close = chained
        return {}, []

    def _ring_fast_dispatch(self, h, frames, rconn) -> bool:
        """Pump-thread fast path: a plain task whose function is cached and
        whose args carry no refs executes straight on the task executor —
        no event loop on either decode, execute, or (small-result) reply.
        Returns False to route anything non-trivial to the slow path, whose
        semantics (arg fetch, runtime envs, OOM rejection, streaming) are
        authoritative. Actor pushes get the same treatment when they are
        the caller's next in-order call (``_ring_actor_fast_dispatch``)."""
        if h.get("m") == "push_actor_task":
            return self._ring_actor_fast_dispatch(h, frames, rconn)
        if h.get("m") == "mrack":
            # Reply-window ack: clock the next coalesced flush right on
            # the pump thread (no loop hop — the flush itself is a ring
            # send this thread can make).
            w = getattr(rconn, "_rt_reply_window", None)
            if w is not None:
                w.on_ack()
            return True
        if h.get("m") != "push_task":
            return False
        if self.node_standby:
            # Mirrors rpc_push_task: work arriving over the ring fast path
            # also means the head activated this node — a later
            # re-registration must not claim standby.
            self.node_standby = False
        if "sp" in h or "fb" in h or "ai" in h or "aib" in h:
            # Pre-framed spec / piggybacked function / interned args:
            # expand here so the eligibility gates below see the FULL
            # header (a False return routes the ORIGINAL message to the
            # slow path, which expands again — cache hits both times).
            try:
                h, frames = self._expand_task_header(h, frames)
            except protocol.RpcError:
                # Interned-arg miss: the slow path raises it as the typed
                # error the pusher recovers from (blob re-sent).
                return False
        if (
            h.get("nret", 1) < 1          # streaming (-1) stays on the loop
            or h.get("argrefs")
            or h.get("borrows")
            or h.get("renv")
            or h.get("trace")
        ):
            return False
        fn = self.fn_cache.get(h["fkey"])
        if fn is None:
            return False
        if self._memory_monitor.is_pressing():
            return False  # slow path raises the structured oom rejection
        ex = self.task_executor
        if ex is None:
            return False
        ex.submit(self._ring_execute_task, fn, h, frames, rconn,
                  t_arr=time.monotonic())
        return True

    def _ring_fast_dispatch_batch(self, items, rconn):
        """Pump-thread fast path for a WHOLE batch wire message: the
        fast-eligible plain tasks in it are split into ≤ num_task_slots
        contiguous chunks, each chunk executing sequentially on one
        executor thread and answering with ONE batched reply — per-task
        submit/encode/send amortizes across the chunk while real
        parallelism still matches the node's task slots. Everything not
        eligible (actor pushes, refs, runtime envs, uncached functions) is
        returned for the per-item fast/slow paths, whose semantics are
        authoritative."""
        t_arr = time.monotonic()
        # Transit economics (tests assert O(drains) executor wakeups):
        # one call here per pump drain when pump_batch_drain is on, one
        # per batch wire message when off.
        self._stats["pump_batch_calls"] += 1
        self._stats["pump_batch_items"] += len(items)
        ex = self.task_executor
        if ex is None or self._memory_monitor.is_pressing():
            return items
        if self.node_standby and any(
            h.get("m") in ("push_task", "push_actor_task") for h, _ in items
        ):
            # Same activation signal as the per-item paths (which a fully
            # fast-path batch would never reach).
            self.node_standby = False
        eligible = []
        leftovers = []
        # Consecutive same-actor calls from one caller execute as ONE pool
        # submission with one batched reply (the n:n actor-burst shape);
        # anything the run path declines falls through per-item.
        items = self._coalesce_actor_runs(items, rconn)
        for h, frames in items:
            if h.get("m") == "push_task" and (
                "sp" in h or "fb" in h or "ai" in h or "aib" in h
            ):
                # Expanded view for eligibility + execution; leftovers keep
                # the ORIGINAL message (the slow path re-expands, cached).
                try:
                    eh, ef = self._expand_task_header(h, frames)
                except protocol.RpcError:
                    # Interned-arg miss: slow path raises the typed error.
                    leftovers.append((h, frames))
                    continue
            else:
                eh, ef = h, frames
            if (
                eh.get("m") != "push_task"
                or eh.get("nret", 1) < 1
                or eh.get("argrefs")
                or eh.get("borrows")
                or eh.get("renv")
                or eh.get("trace")
            ):
                leftovers.append((h, frames))
                continue
            fn = self.fn_cache.get(eh["fkey"])
            if fn is None:
                leftovers.append((h, frames))
                continue
            eligible.append((fn, eh, ef))
        if not eligible:
            return leftovers
        if self._reply_batching:
            # Claim the whole chunk's corr ids in ONE dedup pass;
            # duplicates of completed tasks answer as one replayed
            # multi-result frame right here on the pump thread.
            eligible = self._ring_claim_chunk(eligible, rconn)
            if not eligible:
                return leftovers
        # Work-stealing queue, not static chunks: N executor loops pop one
        # task at a time, so a slow task never serializes the fast tasks
        # behind it (head-of-line blocking) while sibling threads idle —
        # each loop still coalesces ITS completions into one batched reply.
        dq: deque = deque(eligible)
        nloops = min(len(eligible), max(self.num_task_slots, 1))
        for c in range(nloops):
            try:
                ex.submit(self._ring_execute_queue, dq, rconn, t_arr)
                self._stats["pump_exec_wakeups"] += 1
            except RuntimeError:
                # Executor shut down. Loops already submitted will drain
                # the whole queue, so leftovers only exist when NONE got
                # in; re-dispatching otherwise would double-execute.
                if c == 0:
                    # Release the dispatch-time corr claims: the slow
                    # path these re-route to runs its own dedup, and a
                    # stale WIP entry would wrongly attach it.
                    with self._apush_lock:
                        for _fn, h, _fr in dq:
                            corr = h.get("corr")
                            if (corr and self._apush_replies.get(corr)
                                    is _APUSH_WIP):
                                self._apush_replies.pop(corr, None)
                    leftovers.extend((h, fr) for _fn, h, fr in dq)
                    dq.clear()
                break
        return leftovers

    def _ring_claim_chunk(self, eligible, rconn):
        """Claim a fast-path chunk's corr ids in one dedup pass (pump
        thread). Items claimed "mine" return for execution; duplicates
        answer here — completed outcomes replay as ONE coalesced frame,
        in-flight twins attach to the execution's own reply."""
        corrs = [h.get("corr") for _fn, h, _f in eligible]
        if not any(corrs):
            # Pusher didn't arm the corr plane (mixed gates): nothing to
            # claim, nothing can replay.
            return eligible
        states = self._apush_begin_many(corrs)
        keep = []
        subs: List[dict] = []
        counts: List[int] = []
        flat: List[bytes] = []
        for item, (state, obj) in zip(eligible, states):
            if state == "mine":
                keep.append(item)
            elif state == "replay":
                extras, fr = obj
                subs.append({"i": item[1]["i"], **dict(extras)})
                counts.append(len(fr))
                flat.extend(fr)
            else:  # wait
                self._attach_dup_reply(obj, item[1]["i"], rconn)
        if subs:
            rconn.send_reply_batch(subs, counts, list(flat))
        return keep

    def _coalesce_actor_runs(self, items, rconn):
        """Group consecutive eligible actor calls (same actor, same
        caller, in-seq, plain sync method on a serial group-less actor)
        into single pool submissions with ONE batched reply each; returns
        the items NOT consumed by a run. Per-caller FIFO is preserved:
        a run executes sequentially on the actor's serial pool exactly as
        the per-item submissions would have."""
        out = []
        i = 0
        n = len(items)
        while i < n:
            h, fr = items[i]
            if h.get("m") != "push_actor_task":
                out.append(items[i])
                i += 1
                continue
            run = [items[i]]
            j = i + 1
            while j < n:
                h2 = items[j][0]
                if (
                    h2.get("m") != "push_actor_task"
                    or h2.get("aid") != h.get("aid")
                    or h2.get("caller") != h.get("caller")
                ):
                    break
                run.append(items[j])
                j += 1
            if len(run) >= 2 and self._try_submit_actor_run(run, rconn):
                i = j
            else:
                # Whole run falls to per-item dispatch: retrying suffixes
                # head-by-head would rescan the same headers O(n^2) on the
                # pump thread.
                out.extend(run)
                i = j
        return out

    @staticmethod
    def _actor_fast_inst_ok(inst) -> bool:
        """Instance-level fast-path gates shared by the per-item dispatch
        and the coalesced-run dispatch (they must never diverge — a gate
        added to one but not the other silently changes semantics
        depending on whether calls arrive as a burst)."""
        return not (
            inst is None or inst.exiting or inst.max_concurrency != 1
            or inst.groups
        )

    @staticmethod
    def _actor_fast_header_ok(h) -> bool:
        """Header-level fast-path gates (same sharing contract)."""
        return not (
            h.get("nret", 1) != 1
            or h.get("argrefs")
            or h.get("borrows")
            or h.get("trace")
            or h.get("cg")
            or h.get("method") == "__rt_apply__"
        )

    def _exec_actor_call(self, inst, method, h, frames):
        """Execute one admitted actor call: deserialize, set task context,
        run. Returns (ok, result) or the string "exited" after performing
        the clean-exit protocol (actor table removal + head notify) for
        SystemExit/exit_actor. Shared execution core of the per-item and
        coalesced fast paths."""
        try:
            arg_slots, plain, kwargs = self.ctx.deserialize_frames(frames)
            args = [plain[i] for _k, i in arg_slots]  # eligibility: no refs
            self.current_task_id.value = TaskID.from_hex(h["tid"])
            self.current_actor_id.value = h["aid"]
            self.put_counter.value = 0
            try:
                return True, method(*args, **kwargs)
            except SystemExit:
                self.hosted_actors.pop(h["aid"], None)
                inst.exiting = True
                self.gcs.notify(
                    "actor_exited",
                    {"actor_id": h["aid"], "clean": True,
                     "reason": "exit_actor"},
                )
                return "exited"
            except Exception as e:
                return False, (e, traceback.format_exc())
        except Exception as e:
            return False, (e, traceback.format_exc())

    def _try_submit_actor_run(self, run, rconn) -> bool:
        """Admit a whole same-(actor, caller) run atomically: every call
        must pass the per-item fast-path gates AND the seqs must be
        exactly consecutive from the caller's cursor. Any mismatch rejects
        the WHOLE run (per-item dispatch handles it) — partial admission
        would reorder."""
        h0 = run[0][0]
        inst = self.hosted_actors.get(h0.get("aid"))
        if not self._actor_fast_inst_ok(inst):
            return False
        if self._memory_monitor.is_pressing():
            return False  # same pressure gate as the per-item path
        methods = []
        for h, _fr in run:
            if not self._actor_fast_header_ok(h) or h.get("seq", 0) <= 0:
                return False
            method = getattr(inst.instance, h.get("method", ""), None)
            if method is None or asyncio.iscoroutinefunction(method):
                return False
            methods.append(method)
        caller = h0.get("caller", "")
        with inst.seq_lock:
            nxt = inst.next_seq.setdefault(caller, 1)
            for k, (h, _fr) in enumerate(run):
                if h.get("seq") != nxt + k:
                    return False
            try:
                inst.pool.submit(
                    self._ring_execute_actor_chunk, inst, methods, run,
                    rconn,
                )
            except RuntimeError:
                return False  # pool shut down (actor being killed)
            inst.next_seq[caller] = nxt + len(run)
            ev = inst.buffered.get(caller, {}).pop(nxt + len(run), None)
        if ev is not None:
            try:
                self.loop.call_soon_threadsafe(ev.set)
            except RuntimeError:
                pass
        return True

    def _ring_execute_actor_chunk(self, inst, methods, run, rconn):
        """Execute an admitted actor run sequentially on the actor's
        serial pool; small results coalesce into one batched reply.
        SystemExit (exit_actor) mid-run follows the per-item protocol for
        that call and fails the remainder the way per-item dispatch would
        have (actor exiting -> ActorMissing)."""
        subs = []
        counts = []
        out: List[bytes] = []
        exited = False
        for method, (h, frames) in zip(methods, run):
            corr = h.get("corr")
            state, obj = self._apush_begin(corr)
            if state != "mine":
                # Duplicate delivery inside an admitted run (should not
                # pass the consecutive-seq gate, but replay is always
                # safe; "wait" twins reply from their own path).
                if state == "replay":
                    extras, fr = obj
                    subs.append({"i": h["i"], **dict(extras)})
                    counts.append(len(fr))
                    out.extend(fr)
                continue
            # inst.exiting: a concurrent ray-kill must stop the rest of
            # the run the way it would have cancelled still-queued
            # per-item futures.
            if exited or inst.exiting:
                self._apush_fail(
                    corr, protocol.RpcError("ActorMissing: actor exited")
                )
                subs.append(
                    {"i": h["i"], "e": "ActorMissing: actor exited"}
                )
                counts.append(0)
                continue
            t0 = time.time()
            fl = flight.ENABLED
            if fl:
                tm0 = time.monotonic()
            res = self._exec_actor_call(inst, method, h, frames)
            if fl:
                taskpath.record_phase(
                    "exec", h["tid"], tm0, time.monotonic(),
                    fn=h["method"], phase="exec",
                )
            if res == "exited":
                self._apush_fail(
                    corr, protocol.RpcError("ActorMissing: actor exited")
                )
                subs.append(
                    {"i": h["i"], "e": "ActorMissing: actor exited"}
                )
                counts.append(0)
                exited = True
                continue
            ok, result = res
            try:
                rets, out_frames, big = self._package_result_parts(
                    h, ok, result
                )
            except Exception as e:
                logger.exception("actor chunk reply packaging failed")
                self._apush_fail(corr, e)
                subs.append(
                    {"i": h["i"], "e": f"reply packaging failed: {e!r}"}
                )
                counts.append(0)
                continue
            finally:
                inst.num_executed += 1
                self._record_task_event({
                    "task_id": h["tid"], "name": h["method"],
                    "type": "ACTOR_TASK", "actor_id": h["aid"],
                    "corr": h.get("corr"),
                    "state": "FINISHED" if ok else "FAILED",
                    "start_time": t0, "end_time": time.time(),
                    "node_id": self.node_id,
                })
            if big or self._reply_batching:
                # big → individual shm-registration path; small with
                # reply batching on → the connection's shared reply
                # window (cross-run coalescing + ack clocking).
                self._ring_reply_packaged(h, rets, out_frames, big, rconn)
            else:
                self._apush_done(corr, {"rets": rets}, out_frames)
                subs.append({"i": h["i"], "rets": rets})
                counts.append(len(out_frames))
                out.extend(out_frames)
        if subs:
            rconn.send_reply_batch(subs, counts, out)

    def _ring_execute_one(self, fn, h, frames):
        """The fast-path per-task execution core, shared by the batched and
        per-item paths (they must never diverge): deserialize ref-free
        args, set task-locals, run, two-level exception guard."""
        if faultpoints.ACTIVE:
            # delay/crash only (catalog): both behave identically to the
            # slow path's hook, so a chaos spec means the same thing on
            # either transport.
            faultpoints.fire("worker.task.exec")
        try:
            arg_slots, plain, kwargs, sep = self._decode_arg_frames(h, frames)
            args = [sep[i] if k == "sv" else plain[i]
                    for k, i in arg_slots]  # eligibility: no refs
            self.current_task_id.value = TaskID.from_hex(h["tid"])
            self.current_actor_id.value = None
            self.put_counter.value = 0
            try:
                return True, fn(*args, **kwargs)
            except Exception as e:
                return False, (e, traceback.format_exc())
        except Exception as e:
            return False, (e, traceback.format_exc())

    def _ring_finish_task(self, h, ok, t0):
        self._stats["tasks_executed"] += 1
        self._record_task_event({
            "task_id": h["tid"], "name": h.get("name") or h["fkey"],
            "type": "NORMAL_TASK",
            "state": "FINISHED" if ok else "FAILED",
            "start_time": t0, "end_time": time.time(),
            "node_id": self.node_id,
        })

    def _ring_execute_queue(self, dq: deque, rconn, t_arr=None):
        """One executor loop of the batched fast path: pop tasks until the
        shared queue drains. With reply batching on, each completion goes
        straight into the connection's self-clocking ReplyWindow — the
        first result flushes the moment it exists and chunk-mates ride
        the in-flight frame's ack, instead of every result waiting for
        the WHOLE queue drain before one end-of-loop batch reply. With
        the gate off, the pre-round-15 accumulate-then-reply shape is
        kept byte-identically; oversized results always fall back to the
        individual shm-reply path.

        ``t_arr`` is the pump's arrival stamp for this chunk: the serve
        span starts there (slow-path semantics), so the analyzer can
        carve executor queue wait (arrival → exec start) into its own
        ``exec-queue`` phase instead of leaving it inside reply-ack."""
        if self._reply_batching:
            # Small results collect in a local sink handed to the window
            # every few completions (or ~1ms, whichever first): one
            # window lock + at most one frame per micro-batch instead of
            # per result, without parking a slow task's result behind
            # the whole drain. Dedup bookkeeping batches the same way —
            # the chunk's corr ids were claimed in ONE pass at dispatch
            # (_ring_claim_chunk), completions record in one pass here
            # (_apush_done_many): per-task lock traffic was a measured
            # slice of the 1M-noop drain profile. The flight-off body is
            # flattened inline — the _ring_execute_task →
            # _ring_reply_result → _ring_reply_packaged chain showed up
            # as pure call overhead in the drain-thread profile at 100k
            # noops; the full helper keeps serving the instrumented and
            # edge paths.
            sink: List[tuple] = []
            dones: List[tuple] = []
            sink_t0 = 0.0
            while True:
                try:
                    fn, h, frames = dq.popleft()
                except IndexError:
                    if dones:
                        self._apush_done_many(dones)
                    if sink:
                        self._reply_window(rconn).add_many(sink)
                    return
                if flight.ENABLED:
                    self._ring_execute_task(fn, h, frames, rconn,
                                            sink=sink, dones=dones,
                                            claimed=True, t_arr=t_arr)
                else:
                    t0 = time.time()
                    ok, result = self._ring_execute_one(fn, h, frames)
                    try:
                        rets, out_frames, big = self._package_result_parts(
                            h, ok, result
                        )
                    except Exception as e:
                        logger.exception("ring task reply failed")
                        self._apush_fail(h.get("corr"), e)
                        rconn.send_reply(
                            {"i": h["i"], "r": 1,
                             "e": f"reply packaging failed: {e!r}"}, [],
                        )
                        self._ring_finish_task(h, ok, t0)
                        continue
                    if big:
                        self._ring_reply_packaged(h, rets, out_frames,
                                                  big, rconn)
                    else:
                        corr = h.get("corr")
                        if corr:
                            dones.append((corr, {"rets": rets},
                                          out_frames))
                        sink.append(({"i": h["i"], "rets": rets},
                                     out_frames, None))
                    self._ring_finish_task(h, ok, t0)
                if sink:
                    now = time.monotonic()
                    if sink_t0 == 0.0:
                        sink_t0 = now
                    if len(sink) >= 32 or (now - sink_t0) >= 0.001:
                        if dones:
                            self._apush_done_many(dones)
                            dones = []
                        self._reply_window(rconn).add_many(sink)
                        sink = []
                        sink_t0 = 0.0
        subs = []
        counts = []
        out: List[bytes] = []
        while True:
            try:
                fn, h, frames = dq.popleft()
            except IndexError:
                break
            corr = h.get("corr")
            if corr:
                # Mixed-gate safety: a pusher that arms per-task corr ids
                # must never double-execute here even with windows off.
                state, obj = self._apush_begin(corr)
                if state != "mine":
                    if state == "replay":
                        extras, fr = obj
                        subs.append({"i": h["i"], **dict(extras)})
                        counts.append(len(fr))
                        out.extend(fr)
                    elif state == "wait":
                        self._attach_dup_reply(obj, h["i"], rconn)
                    continue
            t0 = time.time()
            fl = flight.ENABLED
            if fl:
                tm0 = time.monotonic()
            ok, result = self._ring_execute_one(fn, h, frames)
            if fl:
                tm1 = time.monotonic()
                taskpath.record_phase(
                    "exec", h["tid"], tm0, tm1,
                    fn=h.get("name") or h.get("fkey", "")[:10],
                    outcome="ok" if ok else "error", phase="exec",
                )
            try:
                rets, out_frames, big = self._package_result_parts(
                    h, ok, result
                )
            except Exception as e:
                logger.exception("ring chunk reply packaging failed")
                self._apush_fail(h.get("corr"), e)
                subs.append(
                    {"i": h["i"], "e": f"reply packaging failed: {e!r}"}
                )
                counts.append(0)
                self._ring_finish_task(h, ok, t0)
                continue
            if big:
                # shm + head registration: individual async reply path,
                # reusing THIS packaging pass (a second one would register
                # nested-ref borrows twice and re-serialize the value)
                self._ring_reply_packaged(h, rets, out_frames, big, rconn)
            else:
                self._apush_done(h.get("corr"), {"rets": rets}, out_frames)
                subs.append({"i": h["i"], "rets": rets})
                counts.append(len(out_frames))
                out.extend(out_frames)
            if fl:
                now = time.monotonic()
                taskpath.record_phase(
                    "result", h["tid"], tm1, now,
                    fn=h.get("name") or h.get("fkey", "")[:10],
                    phase="result-push",
                )
                flight.record("task.serve", h["tid"], "task",
                              t_arr if t_arr is not None else tm0, now)
            self._ring_finish_task(h, ok, t0)
        if subs:
            rconn.send_reply_batch(subs, counts, out)

    def _ring_execute_task(self, fn, h, frames, rconn, sink=None,
                           dones=None, claimed=False, t_arr=None):
        if not claimed:
            corr = h.get("corr")
            if corr:
                # Plain tasks carry corr (= task id) when reply batching
                # arms deadline re-arm on the pusher: a re-delivered
                # duplicate (dropped window frame, deadline race) replays
                # the recorded outcome or attaches to the in-flight twin
                # — never runs the function a second time. Chunked
                # deliveries claim their corr ids in one pass at dispatch
                # (_ring_claim_chunk) and arrive here claimed.
                state, obj = self._apush_begin(corr)
                if state != "mine":
                    self._ring_reply_dup(state, obj, h, rconn)
                    return
        t0 = time.time()
        fl = flight.ENABLED
        if fl:
            tm0 = time.monotonic()
        ok, result = self._ring_execute_one(fn, h, frames)
        if fl:
            tm1 = time.monotonic()
            taskpath.record_phase(
                "exec", h["tid"], tm0, tm1,
                fn=h.get("name") or h.get("fkey", "")[:10],
                outcome="ok" if ok else "error", phase="exec",
            )
        self._ring_reply_result(h, ok, result, rconn, sink=sink,
                                dones=dones)
        if fl:
            now = time.monotonic()
            taskpath.record_phase(
                "result", h["tid"], tm1, now,
                fn=h.get("name") or h.get("fkey", "")[:10],
                phase="result-push",
            )
            flight.record("task.serve", h["tid"], "task",
                          t_arr if t_arr is not None else tm0, now)
        self._ring_finish_task(h, ok, t0)

    def _ring_reply_dup(self, state, obj, h, rconn):
        """Answer a duplicate ring delivery (dedup said not-"mine"):
        replay the recorded outcome, or attach to the in-flight twin."""
        if state == "replay":
            extras, fr = obj
            rconn.send_reply({"i": h["i"], "r": 1, **dict(extras)},
                             list(fr))
        elif state == "wait":
            self._attach_dup_reply(obj, h["i"], rconn)

    def _ring_reply_result(self, h, ok, result, rconn, sink=None,
                           dones=None):
        """Package + send an execution result from an executor thread
        (shared by the task and actor ring fast paths)."""
        try:
            rets, out_frames, big = self._package_result_parts(h, ok, result)
        except Exception as e:
            logger.exception("ring task reply failed")
            self._apush_fail(h.get("corr"), e)
            rconn.send_reply(
                {"i": h["i"], "r": 1, "e": f"reply packaging failed: {e!r}"},
                [],
            )
            return
        self._ring_reply_packaged(h, rets, out_frames, big, rconn, sink=sink,
                                  dones=dones)

    def _ring_reply_packaged(self, h, rets, out_frames, big, rconn,
                             sink=None, dones=None):
        """Send an ALREADY-packaged result (from an executor thread).
        Packaging must happen exactly once per execution — it registers
        nested-ref borrows, and a second pass would leak them."""
        try:
            if big:
                # Oversized values: write shm here (sync), but the head
                # registration is an RPC — finish on the loop, and only
                # reply once registered (the owner resolves meta via head).
                tid = TaskID.from_hex(h["tid"])
                regs = []
                for i, sobj, ret in big:
                    oid = ObjectID.for_return(tid, i).hex()
                    meta = self._with_xfer(
                        self.shm.put_frames(oid, sobj.to_frames(copy=False))
                    )
                    rets[i] = {**ret, "kind": "shm", "meta": meta}
                    regs.append((oid, meta))

                async def finish():
                    # Any failure must still produce a reply — a silent
                    # drop leaves the submitter's future hanging forever.
                    try:
                        for oid, meta in regs:
                            await self.gcs.call(
                                "object_register", {"oid": oid, "meta": meta}
                            )
                    except Exception as e:
                        self._apush_fail(h.get("corr"), e)
                        rconn.send_reply(
                            {"i": h["i"], "r": 1,
                             "e": f"result registration failed: {e!r}"},
                            [],
                        )
                        return
                    # Cache before send: the shm metas replay cheaply.
                    self._apush_done(h.get("corr"), {"rets": rets},
                                     out_frames)
                    rconn.send_reply(
                        {"i": h["i"], "r": 1, "rets": rets}, out_frames
                    )

                asyncio.run_coroutine_threadsafe(finish(), self.loop)
            else:
                corr = h.get("corr")
                if dones is not None and corr:
                    # Drain-loop micro-batch: the dedup record rides the
                    # sink flush (_apush_done_many, one lock) and is
                    # written before the window frame leaves.
                    dones.append((corr, {"rets": rets}, out_frames))
                else:
                    self._apush_done(corr, {"rets": rets}, out_frames)
                if self._reply_batching:
                    # Small result: coalesce into the connection's reply
                    # window — first result of an idle window flushes
                    # immediately, the rest ride the in-flight frame's
                    # ack (O(bursts) reply messages, and a chunk-mate
                    # never queues behind a sibling's ack). A drain loop
                    # passes a sink so many results share one window
                    # hand-off (add_many).
                    item = ({"i": h["i"], "rets": rets}, out_frames,
                            self._window_tag(h))
                    if sink is not None:
                        sink.append(item)
                    else:
                        self._reply_window(rconn).add(*item)
                else:
                    rconn.send_reply(
                        {"i": h["i"], "r": 1, "rets": rets}, out_frames
                    )
        except Exception as e:
            logger.exception("ring task reply failed")
            self._apush_fail(h.get("corr"), e)
            rconn.send_reply(
                {"i": h["i"], "r": 1, "e": f"reply packaging failed: {e!r}"},
                [],
            )

    # ------------------------------------------------ reply-plane batching

    def _attach_dup_reply(self, fut, rid, rconn):
        """A duplicate delivery raced a still-running execution (the
        pusher's deadline re-arm cancelled its earlier attempt, so the
        in-flight twin's own reply will land on a dead correlation id —
        THIS duplicate is the live one): answer its id the moment the
        execution finishes. Long-running tasks therefore deliver at
        completion, not one re-arm period later."""

        def _done(f, rid=rid, rconn=rconn):
            try:
                extras, fr = f.result()
            except BaseException as e:
                try:
                    rconn.send_reply(
                        {"i": rid, "r": 1,
                         "e": f"TaskError: delivery failed: {e!r}"}, [],
                    )
                except Exception as e2:
                    logger.debug("duplicate-attach error reply lost: %s", e2)
                return
            try:
                rconn.send_reply({"i": rid, "r": 1, **dict(extras)},
                                 list(fr))
            except Exception as e2:
                logger.debug("duplicate-attach reply lost: %s", e2)

        fut.add_done_callback(_done)

    def _reply_window(self, conn):
        """The connection's ReplyWindow, created on first use. One window
        per peer connection (ring or TCP): every execution path feeding
        results back over ``conn`` shares it, so coalescing crosses
        chunk/run boundaries. Ring windows run timer-clocked (gap-paced
        flushes, deferred tail flush on this worker's loop — no mrack
        traffic to contend with the pusher on the ring send lock); TCP
        windows keep the ack clock."""
        w = getattr(conn, "_rt_reply_window", None)
        if w is None:
            from ray_tpu_torch._private.config import rt_config
            from ray_tpu_torch._private.ringconn import RingConnection

            is_ring = isinstance(conn, RingConnection)

            def _defer(delay, cb):
                loop = self.loop
                try:
                    if asyncio.get_running_loop() is loop:
                        loop.call_later(delay, cb)  # on-loop: heap push
                        return
                except RuntimeError:
                    pass
                try:
                    loop.call_soon_threadsafe(loop.call_later, delay, cb)
                except RuntimeError:  # loop closed: flush inline
                    cb()

            w = specframe.ReplyWindow(
                lambda items, _c=conn, _a=not is_ring: (
                    self._reply_window_send(_c, items, ack=_a)
                ),
                max_items=int(rt_config.reply_window_max),
                max_bytes=int(rt_config.reply_window_bytes),
                horizon_s=float(rt_config.reply_window_horizon_s),
                gap_s=(float(rt_config.reply_window_gap_s)
                       if is_ring else None),
                defer=_defer if is_ring else None,
            )
            conn._rt_reply_window = w
            # Keep for the shutdown flush; prune dead connections so
            # churn stays bounded (same discipline as _served_rings).
            self._reply_windows = [
                c for c in self._reply_windows
                if not getattr(c, "_closed", True)
            ] + [conn]
        return w

    def _window_tag(self, h):
        """Per-result taskpath annotation carried through the window (the
        dwell becomes the task's ``reply-window`` phase). None when the
        recorder is off — the hot path then carries no tuple at all."""
        if not flight.ENABLED:
            return None
        return (h.get("tid"), time.monotonic(),
                h.get("name") or h.get("method")
                or h.get("fkey", "")[:10])

    def _reply_window_send(self, conn, items, ack=True):
        """Flush one coalesced multi-result frame: [(sub, frames, tag)]
        -> a single ``bh`` reply message, with the ``wa`` ack request
        that clocks ack-mode (TCP) windows; timer-mode (ring) flushes
        carry no ack request. Transport loss is the peer's problem to
        notice (its per-task deadlines re-arm and the corr-deduped
        re-push replays) — exactly like any other dropped reply."""
        fl = flight.ENABLED
        if fl:
            t0 = time.monotonic()
        counts, flat = protocol.pack_multi_frames(
            [list(f) for _s, f, _t in items]
        )
        subs = [s for s, _f, _t in items]
        nbytes = sum(len(f) for f in flat)
        if faultpoints.ACTIVE:
            try:
                act = faultpoints.fire(
                    "worker.reply.window", err=protocol.ConnectionLost
                )
            except protocol.ConnectionLost as e:
                logger.debug("injected reply-window loss: %s", e)
                act = "drop"
            if act == "drop":
                # The whole frame is lost in transit: every rider's push
                # deadline fires at the driver and the corr-tagged
                # re-push replays the recorded outcomes.
                if fl:
                    flight.record("worker.reply.window", None, "worker",
                                  t0, time.monotonic(), nbytes,
                                  f"drop:batch{len(subs)}")
                return
        try:
            conn.send_reply_batch(subs, counts, flat,
                                  extras={"wa": 1} if ack else None)
        except (protocol.ConnectionLost, OSError) as e:
            logger.debug("reply window flush dropped, peer gone: %s", e)
        self._stats["reply_windows_flushed"] += 1
        self._stats["reply_results_coalesced"] += len(subs)
        if fl:
            now = time.monotonic()
            flight.record("worker.reply.window", None, "worker", t0, now,
                          nbytes, f"ok:batch{len(subs)}")
            for _sub, _fr, tag in items:
                # Sub-threshold dwell (the ring hot path's normal case —
                # results leave with their micro-batch) is delivery
                # noise, not parking: skipping the span keeps the +1
                # record_phase/task tax off the drain loop and the
                # unrecorded sliver
                # lands in derived reply-ack, never vanishes. Genuinely
                # parked results (ack-clocked TCP windows, stragglers)
                # still get their truthful reply-window phase.
                if tag is not None and now - tag[1] >= _WINDOW_DWELL_MIN_S:
                    taskpath.record_phase(
                        "reply_window", tag[0], tag[1], now, fn=tag[2],
                        phase="reply-window",
                    )

    def _flush_reply_windows(self):
        """Drain every open reply window (shutdown / graceful node
        drain): buffered results must not die with the process — the
        tail-event flush discipline, applied to the reply plane."""
        for conn in self._reply_windows:
            w = getattr(conn, "_rt_reply_window", None)
            if w is None:
                continue
            try:
                w.flush()
            except Exception as e:
                logger.debug("reply-window flush at shutdown failed: %s", e)

    async def rpc_mrack(self, h, frames, conn):
        """Reply-window ack (oneway): the peer's pump settled our last
        coalesced frame — flush whatever completed behind it."""
        w = getattr(conn, "_rt_reply_window", None)
        if w is not None:
            w.on_ack()
        return {}, []

    def _ring_actor_fast_dispatch(self, h, frames, rconn) -> bool:
        """Pump-thread fast path for actor calls: a plain (non-async) method
        with ref-free args on a serial actor, arriving as the caller's next
        in-order sequence, is queued straight onto the actor's executor —
        FIFO pool order IS the admission order, so the seq cursor can
        advance immediately and the event loop never sees the call.
        Anything else (out-of-order arrival, refs, async methods,
        max_concurrency > 1) routes to the slow path, whose semantics are
        authoritative."""
        inst = self.hosted_actors.get(h.get("aid"))
        if not self._actor_fast_inst_ok(inst):
            return False
        if not self._actor_fast_header_ok(h):
            return False
        method = getattr(inst.instance, h.get("method", ""), None)
        if method is None:
            return False
        is_coro = asyncio.iscoroutinefunction(method)
        if self._memory_monitor.is_pressing():
            return False
        caller, seq = h.get("caller", ""), h.get("seq", 0)
        with inst.seq_lock:
            if seq > 0 and seq != inst.next_seq.setdefault(caller, 1):
                return False  # not next (or a retry duplicate): slow path
            if is_coro:
                # Coroutine methods: schedule straight onto the dedicated
                # async-actor loop from the pump thread — the core event
                # loop never sees the call. FIFO scheduling preserves
                # per-caller order; the async-side semaphore bounds
                # concurrency identically to the slow path.
                try:
                    asyncio.run_coroutine_threadsafe(
                        self._ring_run_async_actor_task(
                            inst, method, h, frames, rconn
                        ),
                        self._get_async_loop(),
                    )
                except RuntimeError:
                    return False  # loop shut down
            else:
                try:
                    inst.pool.submit(
                        self._ring_execute_actor_task, inst, method, h,
                        frames, rconn,
                    )
                except RuntimeError:
                    return False  # pool shut down (actor being killed)
            # Queued in order: admit the caller's next call right away.
            if seq > 0:
                inst.next_seq[caller] = seq + 1
                ev = inst.buffered.get(caller, {}).pop(seq + 1, None)
            else:
                ev = None
        if ev is not None:
            try:
                self.loop.call_soon_threadsafe(ev.set)
            except RuntimeError:
                pass
        return True

    def _ring_execute_actor_task(self, inst, method, h, frames, rconn):
        corr = h.get("corr")
        state, obj = self._apush_begin(corr)
        if state != "mine":
            # A duplicate delivery raced past the seq gate: replay the
            # finished outcome; an in-flight twin ("wait") will reply
            # itself — never execute the method a second time.
            if state == "replay":
                extras, fr = obj
                rconn.send_reply({"i": h["i"], "r": 1, **dict(extras)},
                                 list(fr))
            return
        t0 = time.time()
        fl = flight.ENABLED
        if fl:
            tm0 = time.monotonic()
        res = self._exec_actor_call(inst, method, h, frames)
        if fl:
            taskpath.record_phase(
                "exec", h["tid"], tm0, time.monotonic(), fn=h["method"],
                phase="exec",
            )
        if res == "exited":
            # exit_actor(): mirror the slow path's clean-exit protocol.
            self._apush_fail(
                corr, protocol.RpcError("ActorMissing: actor exited")
            )
            rconn.send_reply(
                {"i": h["i"], "r": 1, "e": "ActorMissing: actor exited"},
                [],
            )
            return
        ok, result = res
        self._ring_reply_result(h, ok, result, rconn)
        inst.num_executed += 1
        self._record_task_event({
            "task_id": h["tid"], "name": h["method"], "type": "ACTOR_TASK",
            "actor_id": h["aid"], "corr": h.get("corr"),
            "state": "FINISHED" if ok else "FAILED",
            "start_time": t0, "end_time": time.time(),
            "node_id": self.node_id,
        })

    async def _ring_run_async_actor_task(self, inst, method, h, frames,
                                         rconn):
        """Coroutine twin of _ring_execute_actor_task: runs ON the dedicated
        async-actor loop, gated by the async-side semaphore (shared with the
        slow path's coroutine branch)."""
        corr = h.get("corr")
        state, obj = self._apush_begin(corr)
        if state != "mine":
            if state == "replay":
                extras, fr = obj
                rconn.send_reply({"i": h["i"], "r": 1, **dict(extras)},
                                 list(fr))
            return
        t0 = time.time()
        fl = flight.ENABLED
        if fl:
            tm0 = time.monotonic()
        try:
            async with inst.async_sem:
                arg_slots, plain, kwargs = self.ctx.deserialize_frames(
                    frames
                )
                args = [plain[i] for _k, i in arg_slots]
                _async_actor_id.set(h["aid"])
                _async_task_id.set(h["tid"])
                try:
                    ok, result = True, await method(*args, **kwargs)
                except SystemExit:
                    self.hosted_actors.pop(h["aid"], None)
                    inst.exiting = True
                    self.gcs.notify(
                        "actor_exited",
                        {"actor_id": h["aid"], "clean": True,
                         "reason": "exit_actor"},
                    )
                    self._apush_fail(
                        corr,
                        protocol.RpcError("ActorMissing: actor exited"),
                    )
                    rconn.send_reply(
                        {"i": h["i"], "r": 1,
                         "e": "ActorMissing: actor exited"},
                        [],
                    )
                    return
                except Exception as e:
                    ok, result = False, (e, traceback.format_exc())
        except Exception as e:
            ok, result = False, (e, traceback.format_exc())
        if fl:
            taskpath.record_phase(
                "exec", h["tid"], tm0, time.monotonic(), fn=h["method"],
                phase="exec",
            )
        self._ring_reply_result(h, ok, result, rconn)
        inst.num_executed += 1
        self._record_task_event({
            "task_id": h["tid"], "name": h["method"], "type": "ACTOR_TASK",
            "actor_id": h["aid"], "corr": h.get("corr"),
            "state": "FINISHED" if ok else "FAILED",
            "start_time": t0, "end_time": time.time(),
            "node_id": self.node_id,
        })

    # ------------------------------------------------------- function export

    def export_function(self, fn) -> str:
        key = getattr(fn, "__rt_fn_key__", None)
        if key is not None and key in self.exported_fns:
            return key
        blob = cloudpickle.dumps(fn)
        key = hashlib.sha1(blob).hexdigest()
        if key not in self.exported_fns:
            self.run_sync(
                self.gcs.call("kv_put", {"ns": FN_NS, "key": key}, [blob])
            )
            self.exported_fns.add(key)
        # Keep the blob for push-through: the first push_task carrying this
        # fkey to each peer piggybacks it, so fresh workers skip kv_get.
        self._fn_push.store(key, blob)
        try:
            fn.__rt_fn_key__ = key
        except (AttributeError, TypeError):
            pass
        self.fn_cache[key] = fn
        return key

    def _install_function(self, key: str, fn, blob: Optional[bytes]):
        """A function became known here (kv fetch or piggybacked blob):
        cache it, and arm this worker to push it through on ITS nested
        submissions without re-exporting (the blob is already in the head
        KV — the original exporter put it there)."""
        self.fn_cache[key] = fn
        if blob is not None:
            self._fn_push.store(key, blob)
        self.exported_fns.add(key)
        try:
            fn.__rt_fn_key__ = key
        except (AttributeError, TypeError):
            pass

    async def _load_function(self, key: str):
        fn = self.fn_cache.get(key)
        if fn is not None:
            return fn
        # Miss coalescing: a burst of fresh tasks/actors of K distinct
        # functions issues ONE kv_get_batch, not one kv_get per slot —
        # concurrent misses for the same key share one future, distinct
        # keys queued in the same window ride one batched verb.
        fut = self._fn_loading.get(key)
        if fut is None:
            fut = asyncio.get_running_loop().create_future()
            # An abandoned waiter (cancelled task) must not surface a
            # never-retrieved warning for the shared future.
            fut.add_done_callback(
                lambda f: f.exception() if not f.cancelled() else None
            )
            self._fn_loading[key] = fut
            self._fn_fetch_keys.append(key)
            if not self._fn_fetch_scheduled:
                self._fn_fetch_scheduled = True
                asyncio.get_running_loop().call_soon(self._spawn_fn_fetch)
        return await asyncio.shield(fut)

    def _spawn_fn_fetch(self):
        """One batched fetch per miss window (loop callback)."""
        self._fn_fetch_scheduled = False
        keys = [k for k in self._fn_fetch_keys if k in self._fn_loading]
        self._fn_fetch_keys.clear()
        if keys:
            spawn_logged(self.loop, self._fetch_functions(keys),
                         "worker.fetch_functions")

    async def _fetch_functions(self, keys: List[str]):
        try:
            h, fr = await self._head_call(
                "kv_get_batch", {"ns": FN_NS, "keys": keys}
            )
        except Exception as e:
            for k in keys:
                fut = self._fn_loading.pop(k, None)
                if fut is not None and not fut.done():
                    fut.set_exception(
                        exc.RayTpuError(f"function table fetch failed: {e}")
                    )
            return
        try:
            found = list(h.get("found") or ())
            pos = 0
            for k, ok in zip(keys, found):
                blob = fr[pos] if ok and pos < len(fr) else None
                if ok:
                    pos += 1
                fut = self._fn_loading.pop(k, None)
                if fut is None or fut.done():
                    continue
                if blob is None:
                    fut.set_exception(exc.RayTpuError(
                        f"function {k} not found in function table"
                        if not ok else
                        f"function {k} missing from kv_get_batch reply"
                    ))
                    continue
                try:
                    fn = cloudpickle.loads(blob)
                except Exception as e:
                    fut.set_exception(exc.RayTpuError(
                        f"function {k} failed to load: {e!r}"
                    ))
                    continue
                self._install_function(k, fn, blob)
                fut.set_result(fn)
        finally:
            # Malformed/truncated reply (or any parse error above): a
            # leftover future must fail, never hang — it is shared by
            # every coalesced waiter and by all future misses of its key.
            for k in keys:
                fut = self._fn_loading.pop(k, None)
                if fut is not None and not fut.done():
                    fut.set_exception(exc.RayTpuError(
                        f"function {k} missing from kv_get_batch reply"
                    ))

    # -------------------------------------------------------------- ownership

    def _dec_ref_local(self, oid: str):
        rec = self.owned.get(oid)
        if rec is None:
            return
        rec["count"] -= 1
        self._maybe_free(oid)

    def _apply_borrow(self, oid: str, owner: tuple, my_addr: tuple,
                      to_notify: Dict[tuple, List[str]]):
        if owner == my_addr:
            rec = self.owned.get(oid)
            if rec is not None:
                rec["count"] += 1  # a local materialized copy
            return
        b = self.borrowed.get(oid)
        if b is None:
            self.borrowed[oid] = {"count": 1, "owner": owner}
            to_notify.setdefault(owner, []).append(oid)
        else:
            b["count"] += 1

    def _drain_borrows(self):
        """Register queued deserialize-time borrows (one loop callback per
        burst; one grouped add_borrow notify per owner). Entries are either
        (oid_hex, owner_tuple) from the per-ref hook, or (None, [ObjectRef])
        batches from the batched deserialize hook — the batch form defers
        hex/owner-tuple work to HERE, off the deserializing thread."""
        self._borrow_drain_scheduled = False
        q = self._borrow_queue
        to_notify: Dict[tuple, List[str]] = {}
        my_addr = tuple(self.addr or ())
        while q:
            oid, owner = q.popleft()
            if oid is None:
                for ref in owner:  # owner slot carries the ref batch
                    ro = ref.owner_address
                    if not ro:
                        continue
                    self._apply_borrow(
                        ref._id._bytes.hex(), tuple(ro), my_addr, to_notify
                    )
                continue
            self._apply_borrow(oid, owner, my_addr, to_notify)
        for owner, oids in to_notify.items():
            spawn_logged(
                self.loop,
                self._notify_owner_many(owner, "add_borrow", oids),
                "worker.notify_owner.add_borrow",
            )

    def _drain_releases(self):
        """Process every queued ObjectRef release in one loop callback.

        Shm frees are announced to the head as ONE grouped object_free
        notify instead of one per object (reference batches refcount
        traffic the same way: ``core_worker/reference_counter`` flushes
        deltas, not per-ref RPCs). Borrowed (foreign-owned) refs return
        their borrow to the owner when the last local copy dies."""
        self._release_drain_scheduled = False
        # adds queued in the same window must reach the owner first
        self._drain_borrows()
        q = self._release_queue
        freed: List[str] = []
        to_register: List[tuple] = []
        to_release: Dict[tuple, List[str]] = {}
        to_add: Dict[tuple, List[str]] = {}
        my_addr = tuple(self.addr or ())
        while q:
            kind, payload = q.popleft()
            if kind == "reg":
                to_register.append(payload)
                continue
            if kind == "pin":
                for oid, owner in payload:
                    rec = self.owned.get(oid)
                    if rec is not None:
                        rec["borrows"] += 1
                    elif owner and tuple(owner) != my_addr:
                        to_add.setdefault(tuple(owner), []).append(oid)
                continue
            # "dec": payload is the hex, or the ObjectID when the release
            # hook deferred the conversion off the GC'ing thread.
            oid = payload if type(payload) is str else payload._bytes.hex()
            b = self.borrowed.get(oid)
            if b is not None:
                b["count"] -= 1
                if b["count"] <= 0:
                    self.borrowed.pop(oid, None)
                    to_release.setdefault(tuple(b["owner"]), []).append(oid)
                continue
            rec = self.owned.get(oid)
            if rec is None:
                continue
            rec["count"] -= 1
            self._maybe_free(oid, free_sink=freed)
        for owner, oids in to_add.items():
            spawn_logged(
                self.loop,
                self._notify_owner_many(owner, "add_borrow", oids),
                "worker.notify_owner.add_borrow",
            )
        for owner, oids in to_release.items():
            spawn_logged(
                self.loop,
                self._notify_owner_many(owner, "release_borrow", oids),
                "worker.notify_owner.release_borrow",
            )
        # Registrations flush BEFORE frees: a register landing after the
        # free of the same (dying) object would leave the head directory
        # pointing at reclaimed arena memory forever. The reverse race —
        # a reconstruction's re-register popped by the old free in the
        # same batch — only costs a directory miss, which readers already
        # survive via pull-from-owner.
        if to_register:
            try:
                self.gcs.notify("object_register", {"items": to_register})
            except protocol.ConnectionLost as e:
                logger.debug("object_register batch dropped, head gone: %s", e)
        if freed:
            try:
                self.gcs.notify("object_free", {"oids": freed})
            except protocol.ConnectionLost as e:
                logger.debug("object_free batch dropped, head gone: %s", e)

    def _record_lineage(self, tid_hex, header, frames, resources, strategy,
                        nret):
        """Remember a task spec while any of its return refs is alive, so a
        lost output can be recomputed (deterministic ObjectIDs make the
        resubmitted task produce the same ids)."""
        nbytes = sum(len(f) for f in frames) + 512
        if nbytes > self._LINEAGE_MAX_BYTES:
            return  # a single huge-arg task never evicts everyone else
        self._lineage[tid_hex] = {
            "header": header, "frames": frames, "resources": resources,
            "strategy": strategy, "bytes": nbytes, "live": nret,
        }
        self._lineage_bytes += nbytes
        while self._lineage_bytes > self._LINEAGE_MAX_BYTES and self._lineage:
            old, rec = self._lineage.popitem(last=False)
            if old == tid_hex:  # never evict the entry just recorded
                self._lineage[old] = rec
                break
            self._lineage_bytes -= rec["bytes"]

    def _drop_lineage_for(self, oid: str):
        """Last live ref to a return object died → its slot no longer needs
        the producing-task spec."""
        if len(oid) != 56 or int(oid[48:56], 16) & 0x80000000:
            return  # put object (or foreign id): no lineage
        rec = self._lineage.get(oid[:48])
        if rec is None:
            return
        rec["live"] -= 1
        if rec["live"] <= 0:
            self._lineage_bytes -= rec["bytes"]
            self._lineage.pop(oid[:48], None)

    def _maybe_free(self, oid: str, free_sink: Optional[List[str]] = None):
        rec = self.owned.get(oid)
        if rec is None or rec["count"] > 0 or rec["borrows"] > 0:
            return
        self.owned.pop(oid, None)
        self._drop_lineage_for(oid)
        entry = self.memory_store.pop(oid, None)
        self.store_events.pop(oid, None)
        if entry is not None and entry[0] == "shm":
            self.shm.free(oid, entry[1])
            if free_sink is not None:
                free_sink.append(oid)  # caller sends one grouped notify
            else:
                try:
                    self.gcs.notify("object_free", {"oids": [oid]})
                except protocol.ConnectionLost as e:
                    logger.debug("object_free %s dropped, head gone: %s",
                                 oid, e)
        # Refs nested inside this value were pinned for its lifetime.
        if rec.get("nested"):
            self._release_borrows(rec["nested"])

    def _register_owned(self, oid: str, nested: Optional[list] = None):
        self.owned[oid] = {"count": 1, "borrows": 0, "nested": nested or []}

    def _enqueue_ref_op(self, op: tuple):
        """Append a refcount operation to the SINGLE ordered op queue and
        make sure one drain is pending. Pins and decrements MUST share a
        queue: with separate callbacks, a drain scheduled before a pin can
        consume decrements enqueued after it — freeing an object whose pin
        is still in flight (observed as vanishing shuffle pieces)."""
        self._release_queue.append(op)
        if self._release_drain_scheduled:
            return
        self._release_drain_scheduled = True
        try:
            # Short flush window (not next-tick): a sequential put/free
            # loop otherwise drains once per op, sending a 1-item head
            # notify each time. 5ms of latency on ref release is invisible
            # (arena reclaim + head directory tolerate it; remote readers
            # racing a free already handle miss-then-pull), while a burst
            # collapses to one notify + one pubsub fanout.
            self.loop.call_soon_threadsafe(
                lambda: self.loop.call_later(0.005, self._drain_releases)
            )
        except RuntimeError:
            self._release_drain_scheduled = False

    def _add_borrows(self, entries: List[tuple]):
        """entries: [(oid_hex, owner_addr_or_None)]. Local refs increment the
        borrow count; foreign refs notify their owner (reference: borrow
        registration in ``reference_counter.h``). Ordered through the shared
        ref-op queue so the pin always applies before any release enqueued
        after it, regardless of which thread enqueues what."""
        if not entries:
            return  # hot path: no-ref tasks must not pay a loop wakeup
        self._enqueue_ref_op(("pin", list(entries)))

    def _release_borrows(self, entries: List[tuple]):
        # Pending deserialize-time borrow registrations must land at the
        # owner before these container-credit releases do.
        self._drain_borrows()
        my_addr = tuple(self.addr or ())
        to_release: Dict[tuple, List[str]] = {}
        for oid, owner in entries:
            rec = self.owned.get(oid)
            if rec is not None:
                rec["borrows"] -= 1
                self._maybe_free(oid)
            elif owner and tuple(owner) != my_addr:
                to_release.setdefault(tuple(owner), []).append(oid)
        for owner, oids in to_release.items():
            spawn_logged(
                self.loop,
                self._notify_owner_many(owner, "release_borrow", oids),
                "worker.notify_owner.release_borrow",
            )

    async def _notify_owner(self, addr, method: str, oid: str):
        try:
            conn = await self.get_peer(addr)
            conn.notify(method, {"oid": oid})
        except (protocol.ConnectionLost, ConnectionRefusedError,
                OSError) as e:
            logger.debug("%s(%s) to owner %s dropped, owner gone: %s",
                         method, oid, addr, e)

    async def _notify_owner_many(self, addr, method: str, oids: List[str]):
        try:
            conn = await self.get_peer(addr)
            conn.notify(method, {"oids": oids})
        except (protocol.ConnectionLost, ConnectionRefusedError,
                OSError) as e:
            logger.debug("%s(%d oids) to owner %s dropped, owner gone: %s",
                         method, len(oids), addr, e)

    # ------------------------------------------------------------ put / get

    def _next_put_id(self) -> ObjectID:
        tid = getattr(self.current_task_id, "value", None)
        if tid is None:
            tid = TaskID.of()
            self.current_task_id.value = tid
        idx = getattr(self.put_counter, "value", 0) + 1
        self.put_counter.value = idx
        return ObjectID.for_put(tid, idx)

    def put(self, value: Any) -> ObjectRef:
        if isinstance(value, ObjectRef):
            raise TypeError("put() does not accept ObjectRef (matches reference)")
        sobj, nested_refs = collect_refs_during(
            lambda: self.ctx.serialize(value)
        )
        oid = self._next_put_id()
        nested = [
            (r.id().hex(), list(r.owner_address or ())) for r in nested_refs
        ]
        size = sobj.total_bytes()
        # Large values go straight into shm inside this call (one memcpy
        # from the raw buffer views — zero-copy is safe because the write
        # happens before put() returns); small inline values keep the
        # default copy since the memory store holds the frames while the
        # caller may mutate the source.
        frames = sobj.to_frames(copy=size <= INLINE_OBJECT_MAX)
        hex_ = oid.hex()
        # Store on the CALLER's thread: the arena create/copy/seal are
        # mutex'd native calls, and a run_sync round-trip costs more in
        # cross-thread handoff than the store itself for small/mid objects.
        # Concurrent readers are safe: a remote pull that races the dict
        # write long-polls store_events (rpc_pull_object -> _wait_local),
        # which the scheduled callback below signals. Ownership/borrow
        # records are created only after the store succeeds — a failed
        # store (e.g. /dev/shm exhausted) must not leak an owned record or
        # borrow pins for a ref that is never returned.
        if size <= INLINE_OBJECT_MAX:
            self._add_borrows(nested)  # pinned until this object is freed
            self._register_owned(hex_, nested=nested)
            self.memory_store[hex_] = ("mem", frames)
            self._signal_store_event(hex_)
        else:
            meta = self._with_xfer(self.shm.put_frames(hex_, frames))
            self._add_borrows(nested)  # pinned until this object is freed
            self._register_owned(hex_, nested=nested)
            self.memory_store[hex_] = ("shm", meta)
            self._signal_store_event(hex_)
            self._register_object_async(hex_, meta)
        return ObjectRef(oid, tuple(self.addr))

    def _register_object_async(self, hex_: str, meta: dict):
        """Queue a head directory registration on the SAME ordered ref-op
        queue the frees ride (a separate buffer/timer could flush a free
        BEFORE its object's registration, resurrecting a freed object as a
        stale directory entry — the split-queue reordering class
        _enqueue_ref_op documents). A put-burst flushes as ONE batched
        notify; a reader racing the 5ms window falls back to
        pull-from-owner (reference analog: owner-resolved locations,
        ownership_object_directory.h)."""
        self._enqueue_ref_op(("reg", (hex_, meta)))

    def _signal_store_event(self, hex_: str):
        """Wake any loop-side waiter (_wait_local) for an object stored from
        a non-loop thread. asyncio.Event is not thread-safe: the set must
        run on the loop."""
        ev = self.store_events.get(hex_)
        if ev is not None:
            try:
                self.loop.call_soon_threadsafe(ev.set)
            except RuntimeError:
                pass

    def put_raw_frames(self, frames: List[Any],
                       transient: bool = False) -> Tuple[str, dict]:
        """Store raw frames (no serialization envelope) in the shm store and
        register the location with the head; returns (oid hex, meta).

        Lifetime is the CALLER's to manage (e.g. the DAG device channels
        free via object_free once consumed) — no ownership record is
        created. ``transient``: consumers copy on read, so frees may fully
        unmap. Callable from any thread."""
        oid = self._next_put_id().hex()
        meta = self._with_xfer(
            self.shm.put_frames(oid, frames, transient=transient)
        )
        self.run_sync(
            self.gcs.call("object_register", {"oid": oid, "meta": meta})
        )
        return oid, meta

    def put_serialized(self, frames: List[bytes], total_bytes: int) -> ObjectRef:
        """Store pre-serialized frames as a new owned object (skips the
        second serialization a put(value) would do). Caller guarantees the
        value holds no nested ObjectRefs (no borrow pinning happens here)."""
        oid = self._next_put_id()
        hex_ = oid.hex()
        self.run_sync(self._store_object(hex_, frames, total_bytes))
        self._register_owned(hex_)
        return ObjectRef(oid, tuple(self.addr))

    async def _store_object(self, hex_: str, frames: List[bytes], size: int):
        if size <= INLINE_OBJECT_MAX:
            self.memory_store[hex_] = ("mem", frames)
        else:
            if size >= 8 * 1024 * 1024:
                # Big payload: copy on an executor thread so the event loop
                # keeps serving RPCs during the multi-ms memcpy (the native
                # arena's create/copy/seal are mutex'd and safe off-loop).
                loop = asyncio.get_running_loop()
                meta = await loop.run_in_executor(
                    None, self.shm.put_frames, hex_, frames
                )
                meta = self._with_xfer(meta)
            else:
                meta = self._with_xfer(self.shm.put_frames(hex_, frames))
            self.memory_store[hex_] = ("shm", meta)
            # Fire-and-forget: we are the OWNER, so any later object_free for
            # this oid leaves on the same head connection and is pipelined
            # behind this registration (in-order per connection). A reader
            # that races the registration misses the directory and falls back
            # to pull-from-owner (_fetch_remote), which we can always serve.
            # This keeps the head RTT out of every put() (reference analog:
            # plasma seals locally; location updates flow async via the
            # owner-resolved directory, ownership_object_directory.h).
            self.gcs.notify("object_register", {"oid": hex_, "meta": meta})
        ev = self.store_events.get(hex_)
        if ev is not None:
            ev.set()

    def _store_error(self, hex_: str, err: Exception):
        self.memory_store[hex_] = ("err", err)
        ev = self.store_events.get(hex_)
        if ev is not None:
            ev.set()

    def get(self, refs, timeout: Optional[float] = None):
        single = isinstance(refs, ObjectRef)
        if single:
            refs = [refs]
        values = self._try_get_local(refs)
        if values is None:
            values = self.run_sync(self._get_many(refs, timeout))
        return values[0] if single else values

    def _try_get_local(self, refs) -> Optional[list]:
        """Caller-thread fast path: when EVERY ref already resolves in the
        local store, deserialize right here — the loop round-trip
        (run_sync handoff + task + wakeups, ~6 epoll cycles measured) is
        pure overhead for an object that's already in hand. Any miss,
        stale shm meta, or error entry falls back to the authoritative
        async path (waiting, remote fetch, reconstruction). Store reads
        and arena gets are thread-safe; deserialize already runs on
        executor threads elsewhere."""
        # Two phases: resolve EVERY ref's frames first, deserialize after —
        # a miss on the last ref must not have already paid for (and then
        # discarded) the earlier refs' deserialization.
        resolved = []
        for ref in refs:
            entry = self.memory_store.get(ref.id().hex())
            if entry is None:
                return None
            kind = entry[0]
            if kind == "shm":
                frames = self.shm.get_frames(ref.id().hex(), entry[1])
                if frames is None:
                    return None  # spilled/moved: slow path refreshes
                resolved.append(("mem", frames))
            elif kind in ("mem", "err"):
                resolved.append(entry)
            else:
                return None
        out = []
        for kind, payload in resolved:
            try:
                if kind == "err":
                    raise payload
                out.append(self.ctx.deserialize_frames(payload))
            except exc.RayTpuError:
                raise
            except Exception:
                return None  # any decode hiccup: slow path is authoritative
        return out

    async def _get_many(self, refs: List[ObjectRef], timeout: Optional[float]):
        # ONE deadline for the whole call: the batch resolve and the
        # per-ref paths share it, so get(refs, timeout=T) surfaces
        # GetTimeoutError at ~T even when the batch phase consumed time.
        deadline = None if timeout is None else time.monotonic() + timeout
        prefetch = None
        if len(refs) > 1:
            prefetch = await self._batch_resolve(refs, deadline)
        results = await asyncio.gather(
            *(self._get_one(r, timeout, prefetch=prefetch,
                            deadline=deadline) for r in refs)
        )
        out = []
        for v in results:
            if isinstance(v, Exception):
                raise v
            out.append(v)
        return out

    async def _batch_resolve(self, refs, deadline) -> Optional[dict]:
        """Vectorized remote resolution for a multi-ref get: ONE directory
        round-trip for every unknown oid, then ONE pull RPC per distinct
        owner for whatever the directory misses (reference: batched
        location lookups + owner-grouped pulls, Wang et al. NSDI'21 §4).
        Returns {oid_hex: store entry} for what it resolved; refs left out
        fall back to the authoritative per-ref path, so errors/timeouts
        keep their exact single-ref semantics. Never raises."""
        my_addr = tuple(self.addr or ())
        unknown: Dict[str, tuple] = {}
        for ref in refs:
            hex_ = ref._id._bytes.hex()
            if hex_ in unknown or hex_ in self.memory_store:
                continue
            owner = tuple(ref.owner_address or ())
            if owner == my_addr:
                continue  # owned-but-pending: _wait_local handles it
            unknown[hex_] = owner
        if not unknown:
            return None
        resolved: Dict[str, tuple] = {}
        oids = list(unknown)
        try:
            tmo = None
            retries = None
            if deadline is not None:
                # The whole retry envelope must fit the caller's budget:
                # one attempt spanning the remaining time, no re-issues
                # (the per-ref fallback is the retry path here).
                tmo = max(deadline - time.monotonic(), 0.001)
                retries = 0
            h, _ = await self._head_call(
                "object_lookup_batch", {"oids": oids}, timeout=tmo,
                retries=retries,
            )
            for oid, meta in zip(oids, h.get("metas") or []):
                if meta is not None:
                    resolved[oid] = ("shm", meta)
        except (asyncio.TimeoutError, protocol.RpcError,
                protocol.ConnectionLost, OSError) as e:
            # Per-ref path retries the directory with full semantics.
            logger.debug("batched directory lookup (%d oids) failed, "
                         "falling back to per-ref: %s", len(oids), e)
        by_owner: Dict[tuple, List[str]] = {}
        for oid, owner in unknown.items():
            if oid not in resolved and owner:
                by_owner.setdefault(owner, []).append(oid)
        if by_owner:
            await asyncio.gather(*(
                self._pull_batch_from_owner(owner, oids_, deadline, resolved)
                for owner, oids_ in by_owner.items()
            ))
        return resolved

    async def _pull_batch_from_owner(self, owner, oids: List[str], deadline,
                                     resolved: Dict[str, tuple]):
        """Pull a whole owner's batch over a single RPC with multi-object
        frames. Failures leave the oids unresolved (the per-ref pull
        reproduces the exact error/timeout behavior). The attempt is
        always deadline-bounded: a dropped batch reply must hand over to
        the per-ref path, not pin the whole get() forever."""
        from ray_tpu_torch._private.config import rt_config

        fl = flight.ENABLED
        if fl:
            fl_t0 = time.monotonic()
            fl_fid = flight.next_id()
        try:
            if faultpoints.ACTIVE:
                if await faultpoints.async_fire("worker.pull") == "drop":
                    return  # reply lost; per-ref path takes over
            conn = await self.get_peer(owner)
            extras = {"oids": oids}
            if fl:
                extras["fid"] = fl_fid
            call = conn.call("pull_object_batch", extras)
            tmo = float(rt_config.rpc_deadline_s)
            if deadline is not None:
                tmo = min(tmo, max(deadline - time.monotonic(), 0))
            hh, frames = await asyncio.wait_for(call, tmo)
        except (asyncio.TimeoutError, protocol.RpcError,
                protocol.ConnectionLost, ConnectionRefusedError,
                OSError) as e:
            if fl:
                flight.record("worker.pull_batch", fl_fid, "worker", fl_t0,
                              time.monotonic(), 0,
                              f"error:{type(e).__name__}")
            return
        if fl:
            flight.record("worker.pull_batch", fl_fid, "worker", fl_t0,
                          time.monotonic(), sum(len(f) for f in frames),
                          "ok")
        res = hh.get("res") or []
        per_obj = protocol.unpack_multi_frames(
            [r.get("n", 0) for r in res], frames
        )
        for oid, r, fl in zip(oids, res, per_obj):
            kind = r.get("kind")
            if kind == "shm":
                resolved[oid] = ("shm", r["meta"])
            elif kind == "mem":
                resolved[oid] = ("mem", fl)
            elif kind == "err":
                resolved[oid] = ("err", _loads_maybe(fl))

    async def _get_one(self, ref: ObjectRef, timeout: Optional[float] = None,
                       prefetch: Optional[dict] = None, deadline=None):
        value = await self._get_one_attempt(ref, timeout, prefetch=prefetch,
                                            deadline=deadline)
        if isinstance(value, exc.ObjectLostError):
            initiated = self._try_reconstruct(ref)
            if initiated:
                tid_hex = ref.id().hex()[:48]
                try:
                    value = await self._get_one_attempt(ref, timeout)
                finally:
                    # Only the getter that STARTED the resubmission clears
                    # the in-flight guard; a waiter clearing it early would
                    # let a third getter double-submit the task.
                    if initiated == 2:
                        self._reconstructing.discard(tid_hex)
        return value

    def _try_reconstruct(self, ref: ObjectRef) -> int:
        """Resubmit the task that produced a lost owned object (reference:
        ``object_recovery_manager.h:41`` — recovery via deterministic object
        ids + lineage resubmit). Returns 0 when reconstruction is
        impossible, 1 when a resubmission by another getter is in flight
        (wait for it), 2 when THIS call started one (caller owns the
        guard)."""
        hex_ = ref.id().hex()
        if tuple(ref.owner_address or ()) != tuple(self.addr or ()):
            return 0  # only the owner reconstructs
        if len(hex_) != 56 or int(hex_[48:56], 16) & 0x80000000:
            return 0  # puts have no producing task
        tid_hex = hex_[:48]
        rec = self._lineage.get(tid_hex)
        if rec is None:
            return 0
        if tid_hex in self._reconstructing:
            return 1  # another get already resubmitted; just wait
        self._reconstructing.add(tid_hex)
        logger.warning(
            "object %s lost; reconstructing by resubmitting its task",
            hex_[:12],
        )
        tid = TaskID.from_hex(tid_hex)
        nret = rec["header"].get("nret", 1)
        for i in range(max(nret, 1)):
            o = ObjectID.for_return(tid, i).hex()
            self.memory_store.pop(o, None)
            ev = self.store_events.get(o)
            if ev is not None:
                ev.clear()
        # Borrows were already released when the first execution replied; a
        # second release would corrupt the counts.
        header = dict(rec["header"], borrows=[])
        self._enqueue_dispatch(
            self._dispatch_task_fast,
            (header, rec["frames"], rec["resources"], rec["strategy"], 2),
        )
        return 2

    async def _get_one_attempt(
        self, ref: ObjectRef, timeout: Optional[float] = None,
        prefetch: Optional[dict] = None, deadline=None,
    ):
        hex_ = ref.id().hex()
        if deadline is None:
            deadline = (
                None if timeout is None else time.monotonic() + timeout
            )
        entry = self.memory_store.get(hex_)
        if entry is None and tuple(ref.owner_address or ()) == tuple(self.addr):
            # We own it but it is not ready yet: wait for local completion.
            entry = await self._wait_local(hex_, deadline)
        if entry is None and prefetch is not None:
            # Resolved by the batched directory lookup / owner-coalesced
            # pull (_batch_resolve); a miss falls through to the per-ref
            # path, which is authoritative.
            entry = prefetch.get(hex_)
        if entry is None:
            entry = await self._fetch_remote(ref, deadline)
        kind = entry[0]
        if kind == "err":
            return entry[1]
        if kind == "mem":
            return self.ctx.deserialize_frames(entry[1])
        if kind == "shm":
            frames = await self._frames_for_meta(hex_, entry[1])
            if frames is None:
                # Our meta may be stale — e.g. another process spilled the
                # object to disk under memory pressure. The head's directory
                # entry is authoritative; refresh and retry locally.
                try:
                    hh, _ = await self._head_call(
                        "object_lookup", {"oid": hex_}
                    )
                except (protocol.RpcError, protocol.ConnectionLost, OSError):
                    hh = {}
                if hh.get("found") and hh["meta"] != entry[1]:
                    entry = ("shm", hh["meta"])
                    self.memory_store[hex_] = entry
                    frames = await self._frames_for_meta(hex_, hh["meta"])
            if frames is None:
                # Not mappable here: bulk-fetch through the native transfer
                # plane into a local segment (C++ end to end).
                frames = await self._native_fetch(hex_, entry[1], deadline)
            if frames is None:
                # Native plane unavailable (or object lost): fall back to
                # pulling the bytes over RPC — from the worker that spilled
                # the object (its meta carries that addr) or the owner.
                meta = entry[1] if isinstance(entry[1], dict) else {}
                spill_addr = meta.get("addr") if "spill" in meta else None
                if spill_addr and tuple(spill_addr) == tuple(self.addr or ()):
                    spill_addr = None  # we ARE the spiller; file is gone
                try:
                    entry = await self._pull_from_owner(
                        ref, deadline, inline=True,
                        addr=tuple(spill_addr) if spill_addr else None,
                    )
                except exc.RayTpuError as e:
                    return e
                if entry[0] == "err":
                    return entry[1]
                if entry[0] == "mem":
                    # Cache: repeated gets must not re-transfer the payload.
                    self.memory_store[hex_] = entry
                    return self.ctx.deserialize_frames(entry[1])
                return exc.ObjectLostError(hex_, "shm segment missing")
            return self.ctx.deserialize_frames(frames)
        return exc.ObjectLostError(hex_, f"bad store entry {kind}")

    async def _frames_for_meta(self, hex_: str, meta):
        """Loop-side frame resolution for one shm/spill meta. Spilled
        copies restore on the spill IO pool — a disk/bucket read must not
        block the event loop (reference: AsyncRestoreSpilledObject runs on
        IO workers); arena reads are sub-ms native calls and stay sync."""
        if isinstance(meta, dict) and "spill" in meta:
            raw = await self.shm.spill.read_async(meta, self.loop)
            return [memoryview(f) for f in raw] if raw is not None else None
        return self.shm.get_frames(hex_, meta)

    def _with_xfer(self, meta: dict) -> dict:
        """Stamp shm metadata with this worker's transfer-server address so
        any process that cannot map the segment can bulk-fetch it natively.

        When the memtrack plane is on, also stamp the storing node and
        owner address — every registration path funnels through here, so
        the head directory can attribute each entry to a node (for the
        per-node store gauges/reconciliation) and to an owner (for leak
        detection when that owner dies)."""
        if meta is not None and self.xfer_addr is not None:
            meta = dict(meta, xfer=list(self.xfer_addr))
        if memtrack.ENABLED and meta is not None:
            meta = dict(meta, node=self.node_id,
                        owner=list(self.addr or ()))
        return meta

    async def _native_fetch(self, hex_: str, meta: dict, deadline=None):
        """Fetch a remote shm object through the C++ transfer plane into a
        local per-object segment; returns zero-copy frames or None. The
        socket IO is bounded by the get() deadline."""
        xfer = meta.get("xfer") if isinstance(meta, dict) else None
        if not xfer:
            return None
        try:
            from ray_tpu_torch.native import xfer as native_xfer
        except Exception:
            return None
        timeout_s = None
        if deadline is not None:
            timeout_s = deadline - time.monotonic()
            if timeout_s <= 0:
                return None
        store = getattr(self.shm, "fallback", self.shm)
        dest = store.seg_name(hex_)
        loop = asyncio.get_running_loop()
        new_meta = await loop.run_in_executor(
            None, native_xfer.fetch_to_segment,
            xfer[0], xfer[1], meta, hex_, dest, timeout_s,
        )
        if new_meta is None:
            return None
        frames = store.get_frames(hex_, new_meta)
        if frames is not None:
            if new_meta.get("size", 0) > 0:
                # We materialized this local copy (size 0 = a complete copy
                # already existed): own its unlink on free/evict.
                store._created[hex_] = True
            # Repeat gets must resolve locally, not re-stream the payload
            # (the arena-meta miss would otherwise re-fetch every time).
            self.memory_store[hex_] = ("shm", dict(new_meta))
        return frames

    async def _wait_local(self, hex_: str, deadline):
        ev = self.store_events.get(hex_)
        if ev is None:
            ev = asyncio.Event()
            self.store_events[hex_] = ev
        entry = self.memory_store.get(hex_)
        if entry is not None:
            return entry
        try:
            if deadline is None:
                await ev.wait()
            else:
                await asyncio.wait_for(ev.wait(), max(deadline - time.monotonic(), 0))
        except asyncio.TimeoutError:
            raise exc.GetTimeoutError(f"get() timed out waiting for {hex_}")
        return self.memory_store.get(hex_)

    async def _fetch_remote(self, ref: ObjectRef, deadline):
        hex_ = ref.id().hex()
        # 1) check the shm directory (any process on this machine can attach)
        h, _ = await self._head_call("object_lookup", {"oid": hex_})
        if h.get("found"):
            return ("shm", h["meta"])
        # 2) pull from the owner
        return await self._pull_from_owner(ref, deadline)

    async def _pull_from_owner(self, ref: ObjectRef, deadline, inline=False,
                               addr=None):
        """Fetch from the owning worker. inline=True forces the owner to send
        the bytes over the wire even for shm-backed objects (used when this
        process cannot map the shared store). ``addr`` overrides the target
        (e.g. the worker that spilled the object holds its disk copy); such
        direct pulls do not long-poll ownership."""
        from ray_tpu_torch._private.config import rt_config

        hex_ = ref.id().hex()
        owner = tuple(addr or ref.owner_address or ())
        if not owner:
            raise exc.ObjectLostError(hex_, "no owner address on ref")
        # Re-armed long-poll: each attempt is bounded by the RPC deadline
        # even when get() has none, so a dropped pull reply re-issues the
        # pull instead of hanging this getter forever; transient connection
        # failures get a few jittered retries before ObjectLostError.
        attempt_s = float(rt_config.rpc_deadline_s)
        conn_failures = 0
        retry = Backoff(base=0.05, cap=1.0)
        pull_extras = {"oid": hex_, "inline": inline,
                       "direct": addr is not None}
        fl = flight.ENABLED
        if fl:
            # One join key for every re-armed attempt of this pull; the
            # owner's server-side span shares it.
            pull_extras["fid"] = flight.next_id()
        while True:
            if fl:
                fl_t0 = time.monotonic()
            try:
                if faultpoints.ACTIVE:
                    if await faultpoints.async_fire("worker.pull") == "drop":
                        # Reply lost in transit: behave exactly like the
                        # attempt-deadline expiring.
                        raise asyncio.TimeoutError()
                conn = await self.get_peer(owner)
                tmo = attempt_s
                if deadline is not None:
                    tmo = min(tmo, max(deadline - time.monotonic(), 0))
                hh, frames = await asyncio.wait_for(
                    conn.call("pull_object", pull_extras),
                    tmo,
                )
                if fl:
                    flight.record("worker.pull", pull_extras.get("fid"),
                                  "worker", fl_t0, time.monotonic(),
                                  sum(len(f) for f in frames), "ok")
                break
            except asyncio.TimeoutError:
                if fl:
                    flight.record("worker.pull", pull_extras.get("fid"),
                                  "worker", fl_t0, time.monotonic(), 0,
                                  "timeout")
                if deadline is not None and time.monotonic() >= deadline:
                    raise exc.GetTimeoutError(
                        f"get() timed out pulling {hex_}"
                    )
                await asyncio.sleep(retry.next_delay())
            except (protocol.ConnectionLost, ConnectionRefusedError,
                    OSError) as e:
                conn_failures += 1
                if conn_failures > int(rt_config.rpc_retries):
                    raise exc.ObjectLostError(
                        hex_, f"owner unreachable ({e})"
                    )
                if deadline is not None and time.monotonic() >= deadline:
                    raise exc.GetTimeoutError(
                        f"get() timed out pulling {hex_}"
                    )
                await asyncio.sleep(retry.next_delay())
            except protocol.RpcError as e:
                raise exc.ObjectLostError(hex_, str(e))
        if hh.get("kind") == "shm":
            return ("shm", hh["meta"])
        if hh.get("kind") == "err":
            return ("err", _loads_maybe(frames))
        return ("mem", frames)

    def wait(self, refs, num_returns=1, timeout=None, fetch_local=True):
        if num_returns > len(refs):
            raise ValueError("num_returns > len(refs)")
        # Caller-thread fast path: a ref whose entry is already in the local
        # store is ready by definition, and store reads are thread-safe. The
        # dominant wait() shape (all or enough refs already ready — pure
        # bookkeeping) answers with k dict probes and ZERO loop hops,
        # futures, or RPCs; only a genuinely pending tail pays the async
        # machinery.
        store = self.memory_store
        ready: List[ObjectRef] = []
        not_ready: List[ObjectRef] = []
        for r in refs:
            (ready if r._id._bytes.hex() in store else not_ready).append(r)
        if len(ready) >= num_returns or not not_ready:
            return ready, not_ready
        return self.run_sync(self._wait(refs, num_returns, timeout))

    async def _wait(self, refs, num_returns, timeout):
        # Partition synchronously first: probe futures are spawned ONLY for
        # genuinely pending refs (never one per ref), and every pending
        # remote ref shares one batched poller instead of polling the
        # directory per-ref.
        ready: List[ObjectRef] = []
        pending: List[ObjectRef] = []
        my_addr = tuple(self.addr or ())
        for r in refs:
            if r._id._bytes.hex() in self.memory_store:
                ready.append(r)
            else:
                pending.append(r)
        deadline = None if timeout is None else time.monotonic() + timeout
        tasks: Dict[Any, ObjectRef] = {}
        pollers: List[asyncio.Task] = []
        if len(ready) < num_returns and pending:
            # hex -> [futures]: duplicate refs in one wait() share the id
            # but need one future each (tasks is keyed by future).
            remote_futs: Dict[str, List[Any]] = {}
            by_owner: Dict[tuple, List[str]] = {}
            for r in pending:
                owner = tuple(r.owner_address or ())
                if owner == my_addr:
                    tasks[asyncio.ensure_future(
                        self._local_ready_probe(r)
                    )] = r
                else:
                    fut = self.loop.create_future()
                    hex_ = r._id._bytes.hex()
                    tasks[fut] = r
                    lst = remote_futs.get(hex_)
                    if lst is None:
                        remote_futs[hex_] = lst = []
                        by_owner.setdefault(owner, []).append(hex_)
                    lst.append(fut)
            if remote_futs:
                pollers.append(asyncio.ensure_future(
                    self._remote_ready_poll(remote_futs, by_owner)
                ))
        try:
            while len(ready) < num_returns and tasks:
                tmo = None if deadline is None else max(deadline - time.monotonic(), 0)
                done, _ = await asyncio.wait(
                    tasks.keys(), timeout=tmo, return_when=asyncio.FIRST_COMPLETED
                )
                if not done:
                    break
                for d in done:
                    ref = tasks.pop(d)
                    err = d.exception()
                    if err is not None:
                        # The probe failed (e.g. owner unreachable): surface it
                        # as a ready-with-error object so get() reports it.
                        self.memory_store.setdefault(
                            ref.id().hex(), ("err", err)
                        )
                    ready.append(ref)
        finally:
            for t in tasks:
                t.cancel()
            for p in pollers:
                p.cancel()
        ready_set = {id(r) for r in ready}
        not_ready = [r for r in refs if id(r) not in ready_set]
        return ready, not_ready

    async def _local_ready_probe(self, ref: ObjectRef):
        hex_ = ref.id().hex()
        if hex_ not in self.memory_store:
            await self._wait_local(hex_, None)
        return True

    async def _remote_ready_poll(self, remote_futs: Dict[str, List[Any]],
                                 by_owner: Dict[tuple, List[str]]):
        """ONE poller for every pending remote ref in a wait(): each cycle
        issues a single object_lookup_batch for all unresolved oids plus one
        contains_object_batch per owner still holding unresolved inline
        objects — O(owners) RPCs per cycle, not O(refs). Resolves the
        per-ref futures the wait loop selects on (duplicate refs share one
        remote_futs slot holding each copy's future). Must never die with
        futures unresolved — a probe failure becomes a ready-with-error
        result, matching the per-ref probe contract."""
        def settle(hex_, err=None):
            for fut in remote_futs.pop(hex_, []):
                if not fut.done():
                    if err is not None:
                        fut.set_exception(err)
                    else:
                        fut.set_result(True)

        try:
            await self._remote_ready_poll_inner(remote_futs, by_owner,
                                               settle)
        except asyncio.CancelledError:
            raise
        except Exception as e:
            # A poller crash must not strand the wait loop: surface the
            # failure on every remaining ref (the old per-ref probes
            # reported exceptions the same way, one ref at a time).
            for hex_ in list(remote_futs):
                settle(hex_, exc.ObjectLostError(hex_, f"probe failed: {e!r}"))

    async def _remote_ready_poll_inner(self, remote_futs, by_owner, settle):
        from ray_tpu_torch._private.config import rt_config

        while remote_futs:
            for hex_ in [h for h in remote_futs if h in self.memory_store]:
                settle(hex_)
            if not remote_futs:
                return
            oids = list(remote_futs)
            try:
                h, _ = await self._head_call(
                    "object_lookup_batch", {"oids": oids}
                )
                for oid, meta in zip(oids, h.get("metas") or []):
                    if meta is not None:
                        settle(oid)
            except (protocol.RpcError, protocol.ConnectionLost, OSError) as e:
                # Directory unavailable: owner probes still decide.
                logger.debug("wait() directory poll failed: %s", e)
            for owner, hexes in list(by_owner.items()):
                hexes = [x for x in hexes if x in remote_futs]
                by_owner[owner] = hexes
                if not hexes:
                    del by_owner[owner]
                    continue
                if not owner:
                    # No owner address to probe and the directory has no
                    # entry: nothing can ever report this ref ready.
                    for hex_ in hexes:
                        settle(hex_, exc.ObjectLostError(
                            hex_, "no owner address on ref"
                        ))
                    del by_owner[owner]
                    continue
                try:
                    conn = await self.get_peer(owner)
                    # Deadline-bounded probe: a dropped probe reply costs
                    # one cycle, not the whole wait() (next cycle re-asks).
                    hh, _ = await asyncio.wait_for(
                        conn.call(
                            "contains_object_batch", {"oids": hexes}
                        ),
                        float(rt_config.rpc_deadline_s),
                    )
                    for hex_, rdy in zip(hexes, hh.get("ready") or []):
                        if rdy:
                            settle(hex_)
                except asyncio.TimeoutError:
                    continue
                except (protocol.ConnectionLost, ConnectionRefusedError,
                        OSError):
                    for hex_ in hexes:
                        settle(hex_, exc.ObjectLostError(
                            hex_, "owner unreachable"
                        ))
                    del by_owner[owner]
                except protocol.RpcError as e:
                    # Owner can't answer the probe: surface as ready-with-
                    # error (the old per-ref probe let this propagate the
                    # same way) instead of spinning two failing RPCs every
                    # cycle forever.
                    for hex_ in hexes:
                        settle(hex_, exc.ObjectLostError(
                            hex_, f"owner probe failed: {e}"
                        ))
                    del by_owner[owner]
            if remote_futs:
                await asyncio.sleep(0.005)

    def as_future(self, ref: ObjectRef) -> SyncFuture:
        return asyncio.run_coroutine_threadsafe(self._get_one(ref, None), self.loop)

    def as_asyncio_future(self, ref: ObjectRef):
        """Awaitable from ANY event loop. _get_one must run on the core loop:
        its store_events Events are set() by the core loop, and a cross-loop
        Event.wait() never wakes once the waiter's loop goes idle."""
        async def _get():
            cfut = asyncio.run_coroutine_threadsafe(
                self._get_one(ref, None), self.loop
            )
            v = await asyncio.wrap_future(cfut)
            if isinstance(v, Exception):
                raise v
            return v
        return _get()

    # -------------------------------------------------------- task submission

    # Serialized ((), [], {}) — the no-arg call shape — computed once. Tasks
    # and actor calls with no arguments are the dominant control-plane shape
    # (reference microbenchmark shapes are all no-arg), and re-pickling an
    # empty tuple per call costs more than the whole wire framing.
    _EMPTY_ARGS_FRAMES: Optional[List[bytes]] = None

    def _serialize_args(self, args, kwargs, split: bool = False):
        """Top-level ObjectRef args are passed by reference and materialized by
        the executor (reference semantics); nested refs ride along as borrows.

        With ``split`` (plain-task submit while arg interning is on),
        plain args whose serialized form could plausibly repeat across
        tasks get their OWN frame section appended after the skeleton —
        the returned ``an`` lists each section's frame count (wire key
        ``an``). The shared config dict of a parameter sweep then
        produces byte-identical frames on every push, which is exactly
        what the per-peer :class:`specframe.ArgLedger` digests; varying
        scalars keep riding the skeleton inline."""
        if not args and not kwargs:
            frames = CoreWorker._EMPTY_ARGS_FRAMES
            if frames is None:
                frames = CoreWorker._EMPTY_ARGS_FRAMES = self.ctx.serialize(
                    ((), [], {})
                ).to_frames()
            return list(frames), [], [], None
        arg_slots = []
        ref_ids = []
        plain = []
        sep = []
        for a in args:
            if isinstance(a, ObjectRef):
                arg_slots.append(("ref", len(ref_ids)))
                ref_ids.append((a.id().hex(), list(a.owner_address or ())))
            elif split and _intern_worthy(a):
                arg_slots.append(("sv", len(sep)))
                sep.append(a)
            else:
                arg_slots.append(("val", len(plain)))
                plain.append(a)

        def _ser():
            sk = self.ctx.serialize((arg_slots, plain, kwargs))
            return sk, [self.ctx.serialize(a) for a in sep]

        ((sk, sobjs), nested) = collect_refs_during(_ser)
        frames = sk.to_frames()
        an = None
        if sobjs:
            an = []
            for so in sobjs:
                fr = so.to_frames()
                an.append(len(fr))
                frames.extend(fr)
        borrows = list(ref_ids) + [
            (r.id().hex(), list(r.owner_address or ())) for r in nested
        ]
        self._add_borrows(borrows)
        return frames, ref_ids, borrows, an

    def _spec_template(self, fn, fkey, name, retries) -> Optional[bytes]:
        """The pre-framed invariant spec for (function, options): packed
        ONCE, spliced into every push_task wire message as frame 0 so the
        per-call header carries only deltas (tid/fkey/nret/argrefs). None
        = caller uses the inline full-header path (template build failed,
        or this process has no address yet)."""
        key = (fkey, name, retries)
        tmpl = self._spec_templates.get(key)
        if tmpl is not None:
            return tmpl
        if self.addr is None:
            return None
        try:
            if faultpoints.ACTIVE:
                # error: framing degrades to the inline header — the spec
                # cache is an optimization, never a correctness gate.
                faultpoints.fire("worker.spec.frame")
            fl = flight.ENABLED
            if fl:
                fl_t0 = time.monotonic()
            tmpl = specframe.pack_spec({
                "owner": list(self.addr),
                "name": name or getattr(fn, "__name__", "task"),
                "renv": self._prepare_runtime_env(None),
                # executing side reads this for kill policy (a pressure
                # kill must prefer tasks the owner will actually retry)
                "retries": retries,
            })
        except Exception as e:
            logger.debug("spec template for %s failed (inline header): %s",
                         fkey[:8], e)
            return None
        if len(self._spec_templates) >= 512:
            self._spec_templates.clear()  # tiny + rebuildable
        self._spec_templates[key] = tmpl
        self._stats["spec_templates_built"] += 1
        if fl:
            flight.record("worker.spec.frame", fkey[:12], "worker", fl_t0,
                          time.monotonic(), len(tmpl), "ok")
        return tmpl

    def submit_task(
        self,
        fn,
        args,
        kwargs,
        *,
        num_returns=1,
        resources: Optional[Dict[str, float]] = None,
        strategy: Optional[dict] = None,
        max_retries: int = 3,
        name: str = "",
        runtime_env: Optional[dict] = None,
    ):
        """Returns a list of ObjectRefs, or a StreamingObjectRefGenerator
        when num_returns == "streaming" (reference: generator tasks,
        ``task_manager.h`` streaming returns)."""
        streaming = num_returns == "streaming"
        fl = flight.ENABLED
        if fl:
            fl_t0 = time.monotonic()
        fkey = self.export_function(fn)
        task_id = TaskID.of()
        # Per-arg framing rides only the plain-task push path (the one
        # _arg_intern_wire digests); actor calls keep the single skeleton.
        frames, ref_ids, borrow_ids, an = self._serialize_args(
            args, kwargs, split=self._arg_interning
        )
        if not resources and not strategy:
            # Hot path: the shared default dict + precomputed sched key skip
            # a dict copy and a sorted-tuple build per call. Never mutated
            # downstream (_LeaseSet holds it read-only).
            resources, strategy, skey = (
                self._DEFAULT_RESOURCES, {}, self._DEFAULT_SCHED_KEY
            )
        else:
            resources = dict(resources or {"CPU": 1})
            strategy = strategy or {}
            skey = None
        # Pre-framed spec fast path: everything invariant per (function,
        # options) rides a cached template frame; streaming and explicit
        # runtime envs keep the authoritative inline path.
        tmpl = (
            self._spec_template(fn, fkey, name, max_retries)
            if not streaming and runtime_env is None else None
        )
        if tmpl is not None:
            header = {
                "tid": task_id.hex(),
                "fkey": fkey,
                "nret": num_returns,
                "sp": 1,
            }
            if ref_ids:
                header["argrefs"] = ref_ids
            if borrow_ids:
                header["borrows"] = borrow_ids
            frames = [tmpl] + frames
        else:
            header = {
                "tid": task_id.hex(),
                "fkey": fkey,
                "nret": -1 if streaming else num_returns,
                "argrefs": ref_ids,
                "borrows": borrow_ids,
                "owner": list(self.addr),
                "name": name or getattr(fn, "__name__", "task"),
                "renv": self._prepare_runtime_env(runtime_env),
                "retries": max_retries,
            }
        if an:
            header["an"] = an
        from ray_tpu_torch.util.tracing import tracing_helper

        if tracing_helper.enabled():
            header["trace"] = tracing_helper.inject_context()
        if streaming:
            # A re-executed generator would re-emit items: no retries.
            max_retries = 0
            self._task_streams[task_id.hex()] = {"count": None, "produced": 0}
        pp = self._pack_plane
        refs = []
        if not streaming:
            for i in range(num_returns):
                oid = ObjectID.for_return(task_id, i)
                self._register_owned(oid.hex())
                refs.append(ObjectRef(oid, tuple(self.addr)))
            if pp is None:
                # Pack plane on -> lineage bookkeeping moves to the pack
                # thread (_pack_drain); it is already called from
                # arbitrary caller threads, so the thread home changes,
                # not the race discipline.
                self._record_lineage(
                    task_id.hex(), header, frames, resources, strategy,
                    num_returns,
                )
        self._stats["tasks_submitted"] += 1
        if fl:
            # Taskpath plane: the submit span (serialize/export/enqueue)
            # plus the queued stamp the pusher turns into a task.queued
            # span at pop time ("_tq" never reaches the wire — popped
            # there). The readable name rides the header so spec-framed
            # submissions still attribute per function.
            if "name" not in header:
                header["name"] = name or getattr(fn, "__name__", "task")
            now = time.monotonic()
            taskpath.record_phase(
                "submit", header["tid"], fl_t0, now,
                fn=header["name"], phase="submit",
            )
            header["_tq"] = now
        packed = False
        if pp is not None:
            # Round 20 pack plane: per-task wire-size accounting, lineage
            # bookkeeping and the dispatch enqueue leave this caller
            # thread; the plane feeds the loop whole pre-packed batches
            # (one loop wakeup and one lease pump per burst, not per
            # task). error/drop from the driver.submit.pack faultpoint —
            # and a full plane queue — degrade THIS submission to the
            # inline path below: the task is never lost, only
            # un-offloaded.
            ok = True
            if faultpoints.ACTIVE:
                try:
                    ok = faultpoints.fire("driver.submit.pack") != "drop"
                except Exception:
                    ok = False
            packed = ok and pp.offer(
                (header, frames, resources, strategy, max_retries, skey,
                 streaming, num_returns)
            )
        if not packed:
            if pp is not None and not streaming:
                # The plane rejected the handoff: make up the deferred
                # lineage record inline before dispatch.
                self._record_lineage(
                    task_id.hex(), header, frames, resources, strategy,
                    num_returns,
                )
            self._enqueue_dispatch(
                self._dispatch_task_fast, (header, frames, resources,
                                           strategy, max_retries, skey)
            )
        if streaming:
            from ray_tpu_torch.object_ref import StreamingObjectRefGenerator

            return StreamingObjectRefGenerator(self, task_id, tuple(self.addr))
        return refs

    def _enqueue_dispatch(self, coro_fn, args: tuple):
        """Queue (coro_fn, args) for task creation on the core loop, waking
        the loop at most once per burst of submissions."""
        with self._submit_lock:
            self._submit_buf.append((coro_fn, args))
            if self._submit_scheduled:
                return
            self._submit_scheduled = True
        self.loop.call_soon_threadsafe(self._drain_submits)

    def _drain_submits(self):
        try:
            while True:
                with self._submit_lock:
                    batch, self._submit_buf = self._submit_buf, []
                    if not batch:
                        self._submit_scheduled = False
                        return
                for coro_fn, args in batch:
                    try:
                        # NB: bound methods are re-created per attribute
                        # access: compare the underlying function.
                        if getattr(coro_fn, "__func__", None) is (
                            CoreWorker._dispatch_task_fast
                        ):
                            # Hot path: plain enqueue + callback; a retry
                            # coroutine is built only on failure.
                            coro_fn(*args)
                        else:
                            spawn_logged(self.loop, coro_fn(*args),
                                         "worker.submit_drain")
                    except Exception as e:
                        # One bad submission fails ITS task; it must not
                        # wedge the drain (a stuck _submit_scheduled flag
                        # would silently stop all future submissions).
                        try:
                            self._fail_task(
                                args[0], exc.RayTpuError(repr(e))
                            )
                        except Exception:
                            logger.exception("submit drain failure")
        except BaseException:
            with self._submit_lock:
                self._submit_scheduled = False
            raise

    _DEFAULT_RESOURCES = {"CPU": 1}
    _DEFAULT_SCHED_KEY = ((("CPU", 1),), ())

    def _dispatch_task_fast(self, header, frames, resources, strategy,
                            retries, skey=None):
        key = skey if skey is not None else self._sched_key(
            resources, strategy
        )
        lease_set = self.leases.get(key)
        if lease_set is None:
            lease_set = _LeaseSet(resources, strategy)
            self.leases[key] = lease_set
        fut = self.loop.create_future()
        # 4th element: wire-size estimate, computed ONCE at enqueue — the
        # pack loop used to re-sum the head item's frames on every peek
        # (O(frames) per loop iteration even when the first peek fit).
        lease_set.pending.append(
            (header, frames, fut, sum(len(fr) for fr in frames) + 4096)
        )
        self._pump_leases(key, lease_set)
        fut.add_done_callback(
            self._dispatch_retry_cb(header, frames, resources, strategy,
                                    retries)
        )

    def _dispatch_retry_cb(self, header, frames, resources, strategy,
                           retries):
        """Done-callback for a dispatch future: failure spawns the retry
        coroutine (shared by the inline fast path and the round-20
        pack-plane drain)."""

        def done(f):
            if f.cancelled():
                return
            e = f.exception()
            if e is not None:
                spawn_logged(
                    self.loop,
                    self._dispatch_retry(
                        header, frames, resources, strategy, retries, e
                    ),
                    "worker.dispatch_retry",
                )

        return done

    def _pack_drain(self, batch):
        """Pack-plane worker (round 20), PLANE-THREAD side: the per-task
        submit work that needs neither the caller nor the loop — wire-size
        estimation over every frame, lineage bookkeeping — happens here,
        and the whole batch re-enters the loop as ONE scheduled call."""
        out = []
        for (header, frames, resources, strategy, retries, skey,
             streaming, nret) in batch:
            if not streaming:
                self._record_lineage(header["tid"], header, frames,
                                     resources, strategy, nret)
            out.append(
                (header, frames, resources, strategy, retries, skey,
                 sum(len(fr) for fr in frames) + 4096)
            )
        try:
            self.loop.call_soon_threadsafe(self._drain_packed_on_loop, out)
        except RuntimeError:
            pass  # loop closed (shutdown); dispatch futures never existed

    def _drain_packed_on_loop(self, batch):
        """Loop-side apply of a pack-plane batch: create every dispatch
        future in one pass, then ONE lease pump per scheduling key — the
        inline path pumps once per task."""
        pumped = {}
        for header, frames, resources, strategy, retries, skey, size \
                in batch:
            key = skey if skey is not None else self._sched_key(
                resources, strategy
            )
            lease_set = self.leases.get(key)
            if lease_set is None:
                lease_set = _LeaseSet(resources, strategy)
                self.leases[key] = lease_set
            fut = self.loop.create_future()
            lease_set.pending.append((header, frames, fut, size))
            fut.add_done_callback(
                self._dispatch_retry_cb(header, frames, resources,
                                        strategy, retries)
            )
            pumped[key] = lease_set
        for key, lease_set in pumped.items():
            self._pump_leases(key, lease_set)

    async def _dispatch_retry(self, header, frames, resources, strategy,
                              retries, first_err):
        """Continue a failed first dispatch attempt: same retry policy as
        _dispatch_task_inner, entered only on failure."""
        try:
            err = first_err
            attempt = 0
            while (
                isinstance(err, exc.WorkerCrashedError) and attempt < retries
            ):
                if isinstance(err, exc.OutOfMemoryError):
                    await asyncio.sleep(min(0.5 * 2 ** attempt, 5.0))
                if faultpoints.ACTIVE:
                    await faultpoints.async_fire("worker.dispatch.retry")
                attempt += 1
                key = self._sched_key(resources, strategy)
                lease_set = self.leases.get(key)
                if lease_set is None:
                    lease_set = _LeaseSet(resources, strategy)
                    self.leases[key] = lease_set
                fut = self.loop.create_future()
                lease_set.pending.append(
                    (header, frames, fut,
                     sum(len(fr) for fr in frames) + 4096)
                )
                self._pump_leases(key, lease_set)
                try:
                    await fut
                    return
                except exc.RayTpuError as e:
                    err = e
            raise err
        except Exception as e:
            self._fail_task(
                header,
                e if isinstance(e, exc.RayTpuError) else exc.RayTpuError(
                    repr(e)
                ),
            )

    def _prepare_runtime_env(self, runtime_env: Optional[dict]) -> dict:
        """Submit-side runtime-env preparation: local py_modules paths are
        zipped and staged in the head KV once (content-addressed) so every
        executor fetches the same bits (reference: packaging.py upload)."""
        if not runtime_env:
            return {}
        from ray_tpu_torch._private import runtime_env as renv_mod

        renv_mod.validate(runtime_env)
        if runtime_env.get("py_modules"):
            from ray_tpu_torch._private.runtime_env import packaging

            runtime_env = dict(
                runtime_env,
                py_modules=packaging.stage_modules(
                    self, runtime_env["py_modules"]
                ),
            )
        hook = runtime_env.get("worker_process_setup_hook")
        if callable(hook):
            # Callables cannot ride the msgpack task header: pickle at
            # submit time (reference: setup_hook.py exports the hook via
            # the function table).
            import cloudpickle

            runtime_env = dict(
                runtime_env,
                worker_process_setup_hook={
                    "__pickled_hook__": cloudpickle.dumps(hook).hex()
                },
            )
        return runtime_env

    def _sched_key(self, resources, strategy):
        return (
            tuple(sorted(resources.items())),
            tuple(sorted((k, str(v)) for k, v in strategy.items())),
        )

    def _fail_task(self, header, err: Exception):
        tid = TaskID.from_hex(header["tid"])
        if header["nret"] == -1:
            # streaming: the failure becomes the final item so consumers
            # iterate up to it and then raise
            rec = self._task_streams.get(header["tid"])
            produced = rec.get("produced", 0) if rec else 0
            self._store_error(
                ObjectID.for_return(tid, produced).hex(), err
            )
            if rec is not None:
                rec["count"] = produced + 1
                rec["failed_idx"] = produced
                ev = rec.get("event")
                if ev is not None:
                    ev.set()
            self._release_borrows(header.get("borrows", []))
            return
        for i in range(header["nret"]):
            self._store_error(ObjectID.for_return(tid, i).hex(), err)
        self._release_borrows(header.get("borrows", []))

    # In-flight pushes per leased slot: depth 2 keeps the next task on the
    # wire while the current one executes (the worker's executor queues it),
    # hiding the push RPC latency. Depth 1 caps throughput at
    # slots/round-trip; real parallelism stays bounded by the worker's own
    # task slots (reference: pipelined task submission on leased workers).
    _PUSH_PIPELINE = 16

    def _pump_leases(self, key, lease_set: _LeaseSet):
        lease_set.last_active = time.monotonic()
        # Spawn long-lived pushers (≤ _PUSH_PIPELINE per slot), each draining
        # the pending queue — per-task create_task churn would dominate the
        # driver loop at high rates.
        # Spawn at most one new pusher per queued item this pass — but never
        # count busy pushers as capacity for NEW work: each is committed to
        # its in-flight task for that task's whole runtime, and treating it
        # as available would strand queued tasks while other slots idle
        # (deadlock for producer/consumer task patterns).
        # Slot pick is a rotating cursor, not min-by-busy: a min() scan is
        # O(slots) per queued item, and zero-resource tasks can hold dozens
        # of slots. The
        # cursor finds the first non-draining slot with pusher headroom;
        # one full rotation with no pick means every slot is saturated.
        spawn_budget = len(lease_set.pending)
        slots = lease_set.slots
        while spawn_budget > 0 and slots and not lease_set.saturated:
            n = len(slots)
            slot = None
            for off in range(n):
                s = slots[(lease_set.rr + off) % n]
                # With an adaptive window, pushers beyond what the
                # window can feed would only park on the rendezvous
                # event — cap spawn at window/chunk (+1 for ramp
                # headroom) so a shrunk slot runs 2-3 pushers, not 16
                # parked coroutines churning the loop.
                cap = self._PUSH_PIPELINE
                if s.pwin is not None:
                    cap = min(
                        cap, s.pwin.window // self._PUSH_BATCH + 1
                    )
                if not s.draining and s.busy < cap:
                    slot = s
                    lease_set.rr = (lease_set.rr + off + 1) % n
                    break
            if slot is None:
                lease_set.saturated = True
                break
            slot.busy += 1
            spawn_budget -= 1
            shard = self._shard_loop_for(slot)
            if shard is None:
                spawn_logged(self.loop,
                             self._slot_pusher(key, lease_set, slot),
                             "worker.slot_pusher")
            else:
                # Round 20: this slot's pushers live on its shard loop
                # (peer-address affinity — a slot's chunks never
                # interleave across loops, so its PushWindow and
                # win_event stay single-loop).
                spawn_threadsafe(shard,
                                 self._slot_pusher(key, lease_set, slot),
                                 "worker.slot_pusher")
        # Only the items NOT covered by a pusher spawned this pass warrant
        # new leases (requesting one per queued item would strand surplus
        # slots at the head until the reaper returns them — an idle surplus
        # slot pins a CPU and starves e.g. a nested task's lease).
        need = spawn_budget
        if need > 0 and not lease_set.requesting:
            lease_set.requesting = True
            spawn_logged(self.loop,
                         self._request_leases(key, lease_set, min(need, 64)),
                         "worker.request_leases")
        # Whenever slots are held, exactly one reaper must be alive to return
        # them once idle (grants can arrive after the queue already drained).
        if lease_set.slots and not lease_set.reaper_running:
            lease_set.reaper_running = True
            spawn_logged(self.loop, self._lease_reaper(key, lease_set),
                         "worker.lease_reaper")

    async def _request_leases(self, key, lease_set: _LeaseSet, count):
        from ray_tpu_torch._private.config import rt_config

        try:
            now = time.monotonic()
            lease_set.avoid = {
                n: t for n, t in lease_set.avoid.items() if t > now
            }
            # The head may block up to lease_request_timeout_s waiting for
            # resources, so the per-attempt RPC deadline sits above that
            # window. corr: a retry after a dropped GRANT reply replays
            # the original grants instead of double-acquiring capacity.
            wait_s = float(rt_config.lease_request_timeout_s)
            h, _ = await self._head_call(
                "lease",
                {
                    "resources": lease_set.resources,
                    "strategy": lease_set.strategy,
                    "count": count,
                    "timeout": wait_s,
                    "avoid": list(lease_set.avoid),
                },
                timeout=wait_s + max(float(rt_config.rpc_deadline_s), 2.0),
                corr=True,
            )
            for g in h.get("grants", []):
                lease_set.slots.append(
                    _LeaseSlot(g["node_id"], tuple(g["addr"]))
                )
            if h.get("grants"):
                lease_set.saturated = False
                lease_set.last_grant_t = time.monotonic()
                lease_set.last_grant_warm = any(
                    g.get("warm") for g in h["grants"]
                )
        except (protocol.RpcError, protocol.ConnectionLost, OSError) as e:
            logger.warning("lease request failed: %s", e)
            # fail pending tasks if nothing can ever be granted
            if not lease_set.slots:
                for item in lease_set.pending:
                    fut = item[2]
                    if not fut.done():
                        fut.set_exception(
                            exc.RayTpuError(f"lease request failed: {e}")
                        )
                lease_set.pending.clear()
        finally:
            lease_set.requesting = False
            self._pump_leases(key, lease_set)

    # Tasks per wire message on the ring transport: one encode/send/wakeup
    # amortizes the whole chunk (each sub-task still replies, fails, and
    # retries individually).
    _PUSH_BATCH = 16

    def _pusher_node_lost(self, lease_set, slot, futs):
        """Node died mid-push: drop its slots and fail the affected futures
        so their dispatch retries elsewhere. The dropped slots are RETURNED
        to the head: if the node really died the release is a tolerated
        no-op (its record is gone), but after a mere connection failure the
        head would otherwise count the capacity as leased forever — this
        driver's ledger only drains on disconnect."""
        doomed = [s for s in lease_set.slots if s.node_id == slot.node_id]
        lease_set.slots = [
            s for s in lease_set.slots if s.node_id != slot.node_id
        ]
        lease_set.saturated = False
        # A successor process at this address starts with an empty function
        # cache AND an empty interned-arg cache: both must be re-covered.
        self._fn_push.forget_peer(slot.addr)
        self._arg_ledger.forget_peer(slot.addr)
        for s in doomed:
            self._release_slot(lease_set, s)
        for fut in futs:
            if not fut.done():
                fut.set_exception(
                    exc.WorkerCrashedError(f"node {slot.node_id[:8]} lost")
                )

    def _pusher_rpc_error(self, lease_set, slot, fut, e) -> bool:
        """Handle a per-task RpcError; True when the slot must stop (oom)."""
        if fut.done():
            return False
        if getattr(e, "code", None) == "oom":
            # Memory-pressure rejection: retriable, and this node's slots
            # are RETURNED to the head (the node is alive — dropping them
            # silently would leak its resource accounting). Idle slots
            # release now; in-flight ones drain first (releasing a busy
            # slot would double-book the node).
            lease_set.avoid[slot.node_id] = time.monotonic() + 10.0
            keep = []
            for s in lease_set.slots:
                if s.node_id != slot.node_id:
                    keep.append(s)
                elif s.busy > 0:
                    s.draining = True
                    keep.append(s)
                else:
                    self._release_slot(lease_set, s)
            lease_set.slots = keep
            fut.set_exception(exc.OutOfMemoryError(str(e)))
            return True
        fut.set_exception(exc.RayTpuError(str(e)))
        return False

    def _fn_push_wire(self, addr, header, frames):
        """Function push-through: on the FIRST push of an fkey to this
        peer, splice the function blob into the wire message (flag ``fb``,
        frame after the spec) so the executing worker installs it from the
        push instead of round-tripping a kv_get to the head. Returns the
        (possibly augmented) wire header/frames; the queued originals are
        never mutated (a requeued task must re-decide for its next peer)."""
        fkey = header.get("fkey")
        if not fkey or "fb" in header:
            return header, frames
        blob = self._fn_push.blob_for(addr, fkey)
        if blob is None:
            return header, frames
        h2 = dict(header)
        h2["fb"] = 1
        if header.get("sp"):
            return h2, [frames[0], blob, *frames[1:]]
        return h2, [blob, *frames]

    def _arg_intern_wire(self, addr, header, frames):
        """Per-peer argument interning at wire-build time: each small arg
        frame is content-hashed; a digest this peer already holds is
        OMITTED from the wire (header key ``ai`` = [[pos, digest]...] in
        arg-frame positions) while a first-seen digest ships its bytes
        and asks the executor to intern them (``aib``). The queued
        originals are never mutated — a requeued task re-decides for its
        next peer, exactly like ``_fn_push_wire``."""
        if not self._arg_interning:
            return header, frames
        if faultpoints.ACTIVE:
            # error: this push degrades to full frames (interning is an
            # optimization, never a correctness gate). drop: the peer's
            # coverage is reset — every blob re-ships, exercising
            # re-cover exactly like a slot loss would.
            try:
                if faultpoints.fire("worker.arg.intern") == "drop":
                    self._arg_ledger.forget_peer(addr)
            except Exception as e:
                logger.debug("arg interning degraded to full frames: %s", e)
                return header, frames
        start = 1 if header.get("sp") else 0
        min_b, max_b = self._arg_intern_min, self._arg_intern_max
        ai = None
        aib = None
        wire = None
        for pos in range(start, len(frames)):
            f = frames[pos]
            n = len(f)
            if n < min_b or n > max_b:
                if wire is not None:
                    wire.append(f)
                continue
            digest = hashlib.blake2b(f, digest_size=16).digest()
            if wire is None:
                wire = list(frames[:pos])
            if self._arg_ledger.covered(addr, digest):
                # Peer holds these bytes: send the digest, keep the frame
                # home. O(unique args) arg bytes per (peer, burst).
                if ai is None:
                    ai = []
                ai.append([pos - start, digest])
                self._stats["arg_frames_interned"] += 1
                self._stats["arg_intern_bytes_saved"] += n
            else:
                if aib is None:
                    aib = []
                aib.append([pos - start, digest])
                wire.append(f)
                self._stats["arg_blobs_pushed"] += 1
        if wire is None or (ai is None and aib is None):
            return header, frames
        h2 = dict(header)
        if ai:
            h2["ai"] = ai
        if aib:
            h2["aib"] = aib
        return h2, wire

    def _task_wire(self, addr, header, frames):
        """Wire form of one queued push for one peer: interned argument
        frames first (positions are arg-relative, so the later splices
        don't disturb them), then the function push-through blob."""
        h2, f2 = self._arg_intern_wire(addr, header, frames)
        return self._fn_push_wire(addr, h2, f2)

    def _pop_pending(self, lease_set: _LeaseSet) -> tuple:
        """Pop the next pending task, turning its submit-time "_tq" stamp
        into a ``task.queued`` span whose outcome NAMES the wait: a grant
        that landed after enqueue means the task sat on a lease
        (lease-wait — cold worker spawns surface here too, the head
        blocks the grant until capacity exists), a warm-tagged grant
        names the warm-pool activation, otherwise it was plain
        submit-queue depth. The stamp never reaches the wire.

        Queue items carry a 4th element — the enqueue-time wire-size
        estimate the pack loop peeks at — which is dropped here: chunks
        stay (header, frames, fut) triples for every downstream path."""
        item = lease_set.pending.popleft()
        header = item[0]
        if self._reply_batching and "corr" not in header:
            # Per-task correlation id (the task id — already unique per
            # logical task): arms receiver-side dedup, so a deadline-
            # re-armed re-push after a dropped reply window replays the
            # recorded outcome instead of executing twice.
            header["corr"] = header["tid"]
        t_enq = header.pop("_tq", None)
        if t_enq is not None and flight.ENABLED:
            if lease_set.last_grant_t <= t_enq:
                tag = "submit-queue"
            elif lease_set.last_grant_warm:
                tag = "warm-pool-hit"
            else:
                tag = "lease-wait"
            taskpath.record_phase(
                "queued", header.get("tid"), t_enq, time.monotonic(),
                fn=header.get("name") or header.get("fkey", "")[:10],
                outcome=tag, phase=tag,
            )
        return item[:3] if len(item) > 3 else item

    async def _call_with_tcp_fallback(self, conn, addr, method, header, frames):
        """Issue an RPC on ``conn`` (usually a ring); when the encoded
        message exceeds the ring limit despite the caller's size
        pre-estimate, retry once over TCP to the same address. Server-side
        seq admission tolerates mixed transports. Callable from shard
        loops: ``_conn_call``/``_peer_on_loop`` marshal the TCP legs to
        the driver loop (round 20)."""
        try:
            return await self._conn_call(conn, method, header, frames)
        except MessageTooBig:
            tcp = await self._peer_on_loop(addr)
            return await self._conn_call(tcp, method, header, frames)

    async def _await_chunk_settled(self, rfs, conn, addr, chunk):
        """Settle EVERY reply future of one pushed chunk under a shared
        deadline: ONE ``asyncio.wait`` (one timer) covers the whole
        chunk per attempt window, instead of a per-task
        ``asyncio.wait_for`` — per-task timers were a measured drag on
        the saturated driver loop at 100k+ queued tasks, and chunk-mates
        settle together anyway (their replies ride coalesced frames).
        On a deadline, every straggler is cancelled and re-pushed under
        its SAME corr id with jittered backoff — receiver-side dedup
        replays or attaches, never re-executes. Returns the (possibly
        re-issued) future list; every entry is done. Per-item errors
        (incl. the typed ``arg_intern_miss``) stay in the futures for
        the caller's in-order processing."""
        rfs = list(rfs)
        pending_idx = [i for i, rf in enumerate(rfs) if not rf.done()]
        attempt_s = self._push_deadline_s
        rearm = None
        while pending_idx:
            await asyncio.wait({rfs[i] for i in pending_idx},
                               timeout=attempt_s)
            pending_idx = [i for i in pending_idx if not rfs[i].done()]
            if not pending_idx:
                break
            if rearm is None:
                rearm = Backoff(base=0.05, cap=2.0)
            await asyncio.sleep(rearm.next_delay())
            for i in pending_idx:
                rfs[i].cancel()  # the re-push's reply is the live one
                header, frames, _fut = chunk[i]
                wh, wf = self._task_wire(addr, header, frames)
                rfs[i] = asyncio.ensure_future(
                    self._call_with_tcp_fallback(
                        conn, addr, "push_task", wh, wf
                    )
                )
        return rfs

    async def _await_push_reply(self, rf, conn, addr, header, frames):
        """Await one push_task reply. Without a corr id (reply batching
        off) this is the plain unbounded wait. With one, the wait is
        deadline-bounded the way actor pushes already are: silence (a
        dropped coalesced reply frame, a lost push) re-issues the SAME
        corr with jittered backoff — receiver-side dedup replays the
        recorded outcome or attaches to the in-flight execution, never
        re-runs the task; a long-running task just keeps re-arming. A
        typed ``arg_intern_miss`` (receiver evicted an interned frame)
        resets the peer's coverage and re-pushes the exact bytes."""
        corr = header.get("corr")
        if not corr:
            return await rf
        attempt_s = self._push_deadline_s
        rearm = None
        while True:
            try:
                if asyncio.isfuture(rf) and rf.done():
                    # Chunk-mates settle together (their replies ride one
                    # coalesced frame), so by the time the in-order await
                    # loop reaches this item its reply usually already
                    # landed with a sibling's — skip the deadline timer;
                    # result() raises exactly what await would.
                    return rf.result()
                return await asyncio.wait_for(rf, attempt_s)
            except asyncio.TimeoutError:
                if rearm is None:
                    rearm = Backoff(base=0.05, cap=2.0)
                await asyncio.sleep(rearm.next_delay())
                wh, wf = self._task_wire(addr, header, frames)
                rf = self._call_with_tcp_fallback(
                    conn, addr, "push_task", wh, wf
                )
            except protocol.RpcError as e:
                if getattr(e, "code", None) != "arg_intern_miss":
                    raise
                self._stats["arg_intern_miss_retries"] += 1
                self._arg_ledger.forget_peer(addr)
                # Re-push with FULL argument frames (no interning): the
                # receiver re-interns from the ``aib``-less wire and the
                # bytes reaching deserialize are the submitter's exactly.
                wh, wf = self._fn_push_wire(addr, header, frames)
                rf = self._call_with_tcp_fallback(
                    conn, addr, "push_task", wh, wf
                )

    async def _win_acquire(self, lease_set, slot):
        """Acquire push-window capacity on ``slot`` before packing a
        chunk. Returns ``(max_tasks, win)``: ``win`` is None when pacing
        is off for this chunk (gate, or the ``worker.push.window``
        faultpoint degraded it to the fixed fan-out) and ``max_tasks``
        is then the static batch cap. A full window parks this pusher on
        the slot's rendezvous event — sibling settles/releases set it —
        with a short safety horizon re-check so a release lost to an
        error path can never park a pusher forever. Returns ``(0, win)``
        when the slot or queue went away while parked (the caller's
        loop re-checks its own conditions)."""
        if not self._push_window:
            return self._PUSH_BATCH, None
        if faultpoints.ACTIVE:
            try:
                act = await faultpoints.async_fire("worker.push.window")
            except Exception as e:
                # error kind: THIS chunk degrades to the fixed pre-pacing
                # fan-out — the window is an optimization, never a
                # correctness gate.
                logger.debug("push-window pacing degraded: %s", e)
                return self._PUSH_BATCH, None
            if act == "drop" and slot.pwin is not None:
                slot.pwin.reset()  # cold re-ramp from the floor
        win = slot.pwin
        if win is None:
            win = slot.pwin = specframe.PushWindow(
                initial=self._pwin_initial, floor=self._pwin_floor,
                ceiling=self._pwin_ceiling,
                latency_factor=self._pwin_factor,
            )
            slot.win_event = asyncio.Event()
        # Grant quantum: accept at least half a chunk (clamped by the
        # window itself) — a nearly-full window parks this pusher
        # instead of fragmenting the burst into 1-2 task messages.
        want = self._PUSH_BATCH
        min_g = min(want, max(1, win.window // 2))
        n = win.grant(want, min_g)
        while n <= 0:
            if (slot.draining or not lease_set.pending
                    or slot not in lease_set.slots):
                return 0, win
            ev = slot.win_event
            ev.clear()
            min_g = min(want, max(1, win.window // 2))
            n = win.grant(want, min_g)  # re-check: no missed wake
            if n > 0:
                break
            self._stats["push_window_waits"] += 1
            try:
                await asyncio.wait_for(ev.wait(), 1.0)
            except asyncio.TimeoutError:
                logger.debug("push window full on %s for 1s; re-checking",
                             slot.node_id[:8])
            min_g = min(want, max(1, win.window // 2))
            n = win.grant(want, min_g)
        return n, win

    def _win_settled(self, slot, win, n, latency_s):
        """One chunk settled: feed the AIMD update and wake any pusher
        parked on the slot's window."""
        if not win.on_settled(n, latency_s):
            self._stats["push_window_shrinks"] += 1
        ev = slot.win_event
        if ev is not None:
            ev.set()

    def _win_release(self, slot, win, n):
        """Return grant capacity without a pacing signal (chunk packed
        smaller than granted, transport error paths)."""
        if win is None or n <= 0:
            return
        win.release(n)
        ev = slot.win_event
        if ev is not None:
            ev.set()

    def _record_pump_queue(self, tid, h, now):
        """Driver-side ``pump-queue`` phase: a reply frame's dwell
        between transport arrival (the ``_fr`` stamp the ring pump /
        TCP recv loop writes on reply headers) and this settle — both
        ends on the driver's clock, skew-free. Under saturation this is
        the settle queueing that used to hide inside derived reply-ack;
        sub-threshold dwell stays there (same discipline as the
        reply-window phase: recording tax only where there is truth to
        record)."""
        arr = h.get("_fr")
        if arr is None:
            return
        sq = h.get("_sq")
        if sq is not None and sq > arr:
            # Round 20: the settle plane carved this dwell in two —
            # arrival->handoff is still transport-side pump queueing,
            # handoff->settle is the plane's own dwell (its queue depth
            # plus the cross-loop hop). Both carry the same recording
            # threshold; whichever halves stay sub-threshold land in
            # derived reply-ack exactly as before.
            if sq - arr >= _WINDOW_DWELL_MIN_S:
                taskpath.record_phase("pump_queue", tid, arr, sq,
                                      phase="pump-queue")
            if now - sq >= _WINDOW_DWELL_MIN_S:
                taskpath.record_phase("settle_dwell", tid, sq, now,
                                      phase="settle-dwell")
        elif now - arr >= _WINDOW_DWELL_MIN_S:
            taskpath.record_phase("pump_queue", tid, arr, now,
                                  phase="pump-queue")

    # ---------------------------------------------------------- round 20:
    # pusher-loop sharding. Slots hash onto N dedicated event loops by
    # peer address; everything a pusher touches that is driver-loop state
    # (lease bookkeeping, dispatch futures, TCP connections, the owned-
    # object store behind _handle_task_reply) marshals through the
    # helpers below. Slot affinity is the invariant that keeps the rest
    # single-loop: ONE peer's slots always land on ONE shard, so a
    # slot's push window, rendezvous event, and chunk ordering never
    # interleave across loops.

    def _shard_loop_for(self, slot):
        """Pick the pusher loop for ``slot`` by peer-address hash.
        Returns None when sharding is off (pushers stay on the driver
        loop). First pick is recorded on the slot; a later disagreement
        (the shard pool never changes mid-run, so this means a bug)
        counts ``pusher_shard_affinity_breaks`` and re-pins."""
        loops = self._pusher_loops
        if not loops:
            return None
        loop = loops[hash(slot.addr) % len(loops)]
        if slot.shard_loop is None:
            slot.shard_loop = loop
        elif slot.shard_loop is not loop:
            self._stats["pusher_shard_affinity_breaks"] += 1
            slot.shard_loop = loop
        return loop

    async def _main_coro(self, coro):
        """Await ``coro`` on the DRIVER loop from a shard loop. The
        cross-loop hop pair (schedule + wake) is the whole cost; results
        and exceptions propagate unchanged."""
        return await asyncio.wrap_future(
            asyncio.run_coroutine_threadsafe(coro, self.loop)
        )

    async def _main_sync(self, fn, *args):
        """Run a synchronous callable on the driver loop and await its
        return value from a shard loop (``_pusher_rpc_error`` needs the
        verdict before the pusher can decide to stop)."""
        cf: SyncFuture = SyncFuture()

        def _run():
            try:
                cf.set_result(fn(*args))
            except BaseException as e:  # propagate to the awaiting shard
                cf.set_exception(e)

        self.loop.call_soon_threadsafe(_run)
        return await asyncio.wrap_future(cf)

    async def _peer_on_loop(self, addr):
        """``get_peer`` from whatever loop the caller runs on: TCP
        connections live on the driver loop (their ``_pending`` map is
        loop-thread-only), so shard callers marshal the lookup."""
        if asyncio.get_running_loop() is self.loop:
            return await self.get_peer(addr)
        return await self._main_coro(self.get_peer(addr))

    async def _ring_on_loop(self, addr):
        """``get_ring`` with the same cross-loop discipline as
        ``_peer_on_loop`` (the ring cache and dial are driver-loop
        state; the returned ring itself is cross-loop-callable)."""
        if asyncio.get_running_loop() is self.loop:
            return await self.get_ring(addr)
        return await self._main_coro(self.get_ring(addr))

    async def _conn_call(self, conn, method, header, frames):
        """Issue ``conn.call`` from whatever loop the caller runs on.
        Ring connections are cross-loop-safe (pending under ``_plock``,
        reply futures settle on the calling loop); a TCP Connection's
        pending map is owned by the driver loop, so shard-loop callers
        marshal the whole call through it."""
        from ray_tpu_torch._private.ringconn import RingConnection

        if (asyncio.get_running_loop() is self.loop
                or isinstance(conn, RingConnection)):
            return await conn.call(method, header, frames)
        return await self._main_coro(conn.call(method, header, frames))

    def _pop_pending_locked(self, lease_set):
        """Pop one pending item under the lease set's pack lock, or None
        when the queue drained first. With sharded pushers, slots of ONE
        lease set can pack on different loops concurrently — the
        peek/pop in the pack loop must be atomic against siblings."""
        with lease_set.plock:
            if not lease_set.pending:
                return None
            return self._pop_pending(lease_set)

    def _flush_settles(self, settles):
        """Hand a shard pusher's collected chunk replies to the driver loop
        (one hop); returns the empty list the pusher collects into next.
        Called before the pusher waits on a reply that has not arrived, as
        well as at the end of the chunk: a task in the chunk may take its
        argument from a chunk-mate's return, and its executor waits at the
        owner until that return is settled here, so holding the settles
        until the whole chunk replied would deadlock."""
        self.loop.call_soon_threadsafe(self._chunk_settle_on_loop, settles)
        return []

    def _chunk_settle_on_loop(self, items):
        """Settle one pushed chunk's replies on the driver loop: shard
        pushers collect ``(header, reply_header, reply_frames, fut)``
        per chunk and flush them here in ONE cross-loop hop —
        ``_handle_task_reply``'s owned-object/stream bookkeeping and the
        dispatch futures are driver-loop state."""
        for header, h, rframes, fut in items:
            try:
                self._handle_task_reply(header, h, rframes)
            except Exception:
                logger.exception("task reply settle failed")
            if not fut.done():
                fut.set_result(None)

    def _pusher_exit_on_loop(self, key, lease_set, slot):
        """A pusher's exit bookkeeping (busy decrement, drain release,
        re-pump) — always on the driver loop; shard pushers marshal
        their outer ``finally`` here."""
        slot.busy = max(slot.busy - 1, 0)
        lease_set.saturated = False
        if slot.busy == 0:
            slot.idle_since = time.monotonic()
        if slot.draining and slot.busy == 0:
            if slot in lease_set.slots:
                lease_set.slots.remove(slot)
                self._release_slot(lease_set, slot)
        lease_set.last_active = time.monotonic()
        if lease_set.pending:
            self._pump_leases(key, lease_set)

    async def _slot_pusher(self, key, lease_set, slot):
        """Drains pending tasks onto one leased slot until the queue (or the
        slot) is gone; many tasks amortize one coroutine. On the ring
        transport a chunk of pending tasks rides one wire message.
        In-flight depth is paced by the slot's adaptive push window
        (``_win_acquire``): each packed chunk holds window capacity from
        push to settle, and the settle latency is the window's AIMD
        clock.

        Round 20: with ``pusher_loop_shards`` on, this coroutine runs on
        a SHARD loop (peer-address affinity). Transport I/O, window
        pacing, and reply awaiting all stay here; driver-loop state —
        lease bookkeeping, dispatch futures, TCP connections, reply
        settling — marshals through the ``*_on_loop`` helpers. A chunk's
        settles flush in ONE cross-loop hop (the per-iteration finally),
        so the driver loop pays O(chunks), not O(tasks)."""
        my_loop = asyncio.get_running_loop()
        on_shard = my_loop is not self.loop
        shard_idx = (self._pusher_loops.index(my_loop)
                     if on_shard and my_loop in self._pusher_loops else -1)
        try:
            while (lease_set.pending and slot in lease_set.slots
                   and not slot.draining):
                chunk: List[tuple] = []
                settles: List[tuple] = []  # shard mode: (hdr, h, fr, fut)
                fut = None
                win = None
                held = 0  # window capacity this pusher holds (releases
                # in the iteration's finally on every error path)
                fl_t0 = time.monotonic()  # refined once the chunk is built
                try:
                    ring = await self._ring_on_loop(slot.addr)
                    if not lease_set.pending:
                        break  # drained by a sibling pusher during the await
                    granted, win = await self._win_acquire(lease_set, slot)
                    if granted <= 0:
                        continue  # slot/queue changed while parked
                    if win is not None:
                        held = granted
                    if not lease_set.pending:
                        break  # drained while parked on the window
                    if ring is None:
                        conn = await self._peer_on_loop(slot.addr)
                        if not lease_set.pending:
                            break
                        it = self._pop_pending_locked(lease_set)
                        if it is not None:
                            chunk = [it]
                    else:
                        conn = ring
                        # Pack tasks up to the granted window, the batch
                        # count, and the ring's message budget; a task too
                        # big for the ring rides TCP instead (same node,
                        # same semantics). The whole peek/pop pass holds
                        # the pack lock (no awaits inside): sharded
                        # siblings of this lease set pack concurrently.
                        budget = ring.max_msg - 65536
                        size = 0
                        oversize = False
                        with lease_set.plock:
                            while (lease_set.pending
                                   and len(chunk) < granted):
                                it = lease_set.pending[0]
                                # Enqueue-time size estimate (4th element);
                                # the O(frames) re-sum per peek is gone.
                                sz = it[3] if len(it) > 3 else sum(
                                    len(fr) for fr in it[1]
                                ) + 4096
                                if sz > budget:
                                    oversize = not chunk
                                    break
                                if size + sz > budget and chunk:
                                    break
                                size += sz
                                chunk.append(self._pop_pending(lease_set))
                        if oversize:
                            conn = await self._peer_on_loop(slot.addr)
                            it = self._pop_pending_locked(lease_set)
                            if it is not None:
                                chunk = [it]
                    if not chunk:
                        continue
                    if shard_idx >= 0:
                        # Single-writer per shard (slot affinity): no lock.
                        st = self._pusher_shard_stats[shard_idx]
                        st["chunks"] += 1
                        st["tasks"] += len(chunk)
                    if held > len(chunk):
                        # Packed fewer than granted (queue drained, byte
                        # budget): the surplus goes back to siblings now.
                        self._win_release(slot, win, held - len(chunk))
                        held = len(chunk)
                    t_send = time.monotonic()
                    fl = flight.ENABLED
                    if fl:
                        fl_t0 = time.monotonic()
                        fl_bytes = sum(
                            len(fr) for _h, fs, _f in chunk for fr in fs
                        )
                    if faultpoints.ACTIVE:
                        # error = ConnectionLost into the outer handler:
                        # slots dropped + released, every chunk future
                        # fails as WorkerCrashedError, dispatch retries.
                        await faultpoints.async_fire(
                            "worker.task.push", err=protocol.ConnectionLost
                        )
                    if len(chunk) == 1:
                        header, frames, fut = chunk[0]
                        wh, wf = self._task_wire(slot.addr, header, frames)
                        h, rframes = await self._await_push_reply(
                            self._call_with_tcp_fallback(
                                conn, slot.addr, "push_task", wh, wf
                            ),
                            conn, slot.addr, header, frames,
                        )
                        if on_shard:
                            settles.append((header, h, rframes, fut))
                        else:
                            self._handle_task_reply(header, h, rframes)
                        t_now = time.monotonic()
                        if win is not None:
                            # AIMD clock: push -> reply ARRIVAL at the
                            # transport, not -> this coroutine running —
                            # a saturated driver loop's settle queueing
                            # is pump-queue, not executor congestion.
                            self._win_settled(
                                slot, win, 1,
                                (h.get("_fr") or t_now) - t_send,
                            )
                            held = 0
                        if not on_shard and not fut.done():
                            fut.set_result(None)
                        if fl:
                            # Span covers push → reply, i.e. dispatch +
                            # execution on the leased slot.
                            flight.record("worker.task.push",
                                          header.get("tid"), "worker",
                                          fl_t0, t_now, fl_bytes, "ok")
                            taskpath.record_phase(
                                "push", header.get("tid"), fl_t0, t_now,
                                nbytes=fl_bytes,
                            )
                            self._record_pump_queue(
                                header.get("tid"), h, t_now
                            )
                        continue

                    try:
                        rfuts = conn.call_batch(
                            "push_task",
                            [self._task_wire(slot.addr, h, f)
                             for h, f, _ in chunk],
                        )
                    except MessageTooBig:
                        # Frame-size estimate missed (oversized headers):
                        # push each task alone; singles that still exceed
                        # the ring ride TCP. Futures must never be dropped.
                        for i, (header, frames, fut) in enumerate(chunk):
                            try:
                                if settles:
                                    settles = self._flush_settles(settles)
                                h, rframes = await self._await_push_reply(
                                    self._call_with_tcp_fallback(
                                        conn, slot.addr, "push_task",
                                        header, frames,
                                    ),
                                    conn, slot.addr, header, frames,
                                )
                                if on_shard:
                                    settles.append(
                                        (header, h, rframes, fut)
                                    )
                                else:
                                    self._handle_task_reply(
                                        header, h, rframes
                                    )
                                if fl:
                                    taskpath.record_phase(
                                        "push", header.get("tid"), fl_t0,
                                        time.monotonic(),
                                    )
                                if not on_shard and not fut.done():
                                    fut.set_result(None)
                            except protocol.RpcError as e:
                                if on_shard:
                                    stop_now = await self._main_sync(
                                        self._pusher_rpc_error,
                                        lease_set, slot, fut, e,
                                    )
                                else:
                                    stop_now = self._pusher_rpc_error(
                                        lease_set, slot, fut, e
                                    )
                                if stop_now:
                                    # This slot is done (e.g. OOM eviction);
                                    # the rest of the chunk goes back to the
                                    # queue for other slots — their futures
                                    # must not be abandoned. Re-stamp the
                                    # enqueue-time size estimate the pack
                                    # loop peeks at.
                                    with lease_set.plock:
                                        lease_set.pending.extend(
                                            (h2, f2, fu2,
                                             sum(len(fr) for fr in f2)
                                             + 4096)
                                            for h2, f2, fu2 in chunk[i + 1:]
                                        )
                                    if on_shard:
                                        self.loop.call_soon_threadsafe(
                                            self._pump_leases,
                                            key, lease_set,
                                        )
                                    else:
                                        self._pump_leases(key, lease_set)
                                    return
                        if win is not None:
                            self._win_settled(slot, win, len(chunk),
                                              time.monotonic() - t_send)
                            held = 0
                        continue
                    stop = False
                    arr_max = 0.0  # latest reply ARRIVAL (AIMD clock)
                    for i, ((header, frames, fut), rf) in enumerate(
                        zip(chunk, rfuts)
                    ):
                        try:
                            if (asyncio.isfuture(rf) and rf.done()
                                    and not rf.cancelled()
                                    and rf.exception() is None):
                                # Chunk-mates settle together (coalesced
                                # reply frames): skip the await wrapper
                                # — and its coroutine — entirely for the
                                # common already-settled case. Errors
                                # keep the full path (deadline re-arm,
                                # intern-miss re-push).
                                h, rframes = rf.result()
                            else:
                                if settles:
                                    settles = self._flush_settles(settles)
                                h, rframes = await self._await_push_reply(
                                    rf, conn, slot.addr, header, frames
                                )
                        except protocol.ConnectionLost:
                            doomed = [c[2] for c in chunk[i:]]
                            if on_shard:
                                self.loop.call_soon_threadsafe(
                                    self._pusher_node_lost,
                                    lease_set, slot, doomed,
                                )
                            else:
                                self._pusher_node_lost(
                                    lease_set, slot, doomed
                                )
                            return
                        except protocol.RpcError as e:
                            if on_shard:
                                if await self._main_sync(
                                    self._pusher_rpc_error,
                                    lease_set, slot, fut, e,
                                ):
                                    stop = True
                            elif self._pusher_rpc_error(
                                lease_set, slot, fut, e
                            ):
                                stop = True
                            continue
                        if on_shard:
                            settles.append((header, h, rframes, fut))
                        else:
                            self._handle_task_reply(header, h, rframes)
                        arr = h.get("_fr")
                        if arr is not None and arr > arr_max:
                            arr_max = arr
                        if fl:
                            # Per-task push envelope (cid = task id): the
                            # chunk-level worker.task.push verb span stays
                            # for RPC attribution; this one anchors the
                            # task's driver-clock wall time.
                            t_now = time.monotonic()
                            taskpath.record_phase(
                                "push", header.get("tid"), fl_t0, t_now,
                            )
                            self._record_pump_queue(
                                header.get("tid"), h, t_now
                            )
                        if not on_shard and not fut.done():
                            fut.set_result(None)
                    if win is not None:
                        # AIMD clock: push -> last reply ARRIVAL; the
                        # arrival->settle dwell is driver-side queueing
                        # (pump-queue), not executor congestion.
                        self._win_settled(
                            slot, win, len(chunk),
                            (arr_max or time.monotonic()) - t_send,
                        )
                        held = 0
                    if fl:
                        flight.record("worker.task.push",
                                      chunk[0][0].get("tid"), "worker",
                                      fl_t0, time.monotonic(), fl_bytes,
                                      f"ok:batch{len(chunk)}")
                    if stop:
                        return
                except (protocol.ConnectionLost, ConnectionRefusedError,
                        OSError):
                    if flight.ENABLED and chunk:
                        flight.record("worker.task.push",
                                      chunk[0][0].get("tid"), "worker",
                                      fl_t0, time.monotonic(), 0,
                                      "error:ConnectionLost")
                    doomed = [c[2] for c in chunk]
                    if on_shard:
                        self.loop.call_soon_threadsafe(
                            self._pusher_node_lost, lease_set, slot, doomed
                        )
                    else:
                        self._pusher_node_lost(lease_set, slot, doomed)
                    return
                except protocol.RpcError as e:
                    if fut is not None:
                        if on_shard:
                            if await self._main_sync(
                                self._pusher_rpc_error,
                                lease_set, slot, fut, e,
                            ):
                                return
                        elif self._pusher_rpc_error(
                            lease_set, slot, fut, e
                        ):
                            return
                finally:
                    # Window capacity must not leak on ANY exit (errors,
                    # node loss, oversize fallback) — a leaked grant
                    # shrinks the slot's effective window forever.
                    if held:
                        self._win_release(slot, win, held)
                        held = 0
                    if settles:
                        # ONE cross-loop hop settles the whole chunk
                        # (shard mode only appends here). Ordering vs a
                        # node-lost marshal above is FIFO on the driver
                        # loop, and the two cover disjoint futures.
                        settles = self._flush_settles(settles)
        finally:
            if on_shard:
                self.loop.call_soon_threadsafe(
                    self._pusher_exit_on_loop, key, lease_set, slot
                )
            else:
                self._pusher_exit_on_loop(key, lease_set, slot)

    async def _lease_reaper(self, key, lease_set: _LeaseSet):
        """Return idle leases to the head (reference: lease idle timeout in
        NormalTaskSubmitter). One reaper per lease set. Release is
        PER-SLOT: a slot idle >0.5s goes back even while a sibling slot
        runs a long task — an idle surplus slot pins node resources the
        head could grant to someone else (nested tasks deadlock otherwise)."""
        try:
            while True:
                await asyncio.sleep(0.25)
                if not lease_set.slots and not lease_set.pending:
                    return
                if lease_set.pending:
                    continue
                now = time.monotonic()
                keep = []
                for s in lease_set.slots:
                    if (
                        s.busy == 0
                        and now - s.idle_since > 0.5
                        and now - lease_set.last_active > 0.5
                    ):
                        self._release_slot(lease_set, s)
                    else:
                        keep.append(s)
                lease_set.slots = keep
        finally:
            lease_set.reaper_running = False

    def _reclaim_idle_leases(self):
        """Head-requested lease reclamation (reference: raylet returns
        leased workers on demand when the cluster is resource-starved).
        Every cached slot with no in-flight task goes back immediately;
        sets with queued work keep theirs."""
        for lease_set in self.leases.values():
            if lease_set.pending:
                continue
            keep = []
            for s in lease_set.slots:
                if s.busy == 0:
                    self._release_slot(lease_set, s)
                else:
                    keep.append(s)
            lease_set.slots = keep

    def _release_slot(self, lease_set: _LeaseSet, slot: _LeaseSlot):
        if slot.pwin is not None:
            # Retire the slot's window stats so bench/tests still see
            # peak/grow/shrink economics after the lease reaper returns
            # the slot (bounded: one entry per peer address).
            self._fold_pwin_stats(slot)
        try:
            self.gcs.notify(
                "release_lease",
                {
                    "node_id": slot.node_id,
                    "resources": lease_set.resources,
                    "strategy": lease_set.strategy,
                },
            )
        except protocol.ConnectionLost as e:
            logger.debug("release_lease for node %s dropped, head gone: %s",
                         slot.node_id, e)

    def _fold_pwin_stats(self, slot):
        """Fold one released slot's push-window counters into the
        retired-per-peer table (max for window/peak, sums for the event
        counters)."""
        snap = slot.pwin.snapshot()
        peer = f"{slot.addr[0]}:{slot.addr[1]}"
        cur = self._pwin_retired.get(peer)
        if cur is None:
            self._pwin_retired[peer] = snap
            return
        cur["window"] = max(cur["window"], snap["window"])
        cur["peak"] = max(cur["peak"], snap["peak"])
        for k in ("grows", "shrinks", "settled"):
            cur[k] += snap[k]

    def transit_stats(self) -> dict:
        """Transit-plane pacing snapshot for bench/tests: per-peer push
        windows (live slots merged with retired ones), the ring pump's
        drain batch-size histogram (served rings — the executor side of
        every same-host peer), and frames-settled-per-recv-wakeup for
        the TCP driver loop. Pure snapshot-time reads; no locks beyond
        what the underlying counters already hold."""
        push: Dict[str, dict] = {
            peer: dict(snap) for peer, snap in self._pwin_retired.items()
        }
        for ls in self.leases.values():
            for s in ls.slots:
                if s.pwin is None:
                    continue
                snap = s.pwin.snapshot()
                peer = f"{s.addr[0]}:{s.addr[1]}"
                cur = push.get(peer)
                if cur is None:
                    push[peer] = snap
                    continue
                cur["window"] = max(cur["window"], snap["window"])
                cur["peak"] = max(cur["peak"], snap["peak"])
                for k in ("grows", "shrinks", "settled"):
                    cur[k] += snap[k]
        pump = {"drains": 0, "msgs": 0, "batch_hist": {}}
        rings = [r for r in self._served_rings if not r._closed]
        rings += [
            r for r in self._ring_peers.values()
            if r and not getattr(r, "_closed", True)
        ]
        for r in rings:
            st = getattr(r, "pump_stats", None)
            if not st:
                continue
            pump["drains"] += st.get("drains", 0)
            pump["msgs"] += st.get("msgs", 0)
            for k, v in st.get("batch_hist", {}).items():
                key = str(k)
                pump["batch_hist"][key] = (
                    pump["batch_hist"].get(key, 0) + v
                )
        settle = {"wakeups": 0, "frames": 0, "drained": 0, "max_batch": 0}
        conns = list(self.peers.values()) + rings
        if self.gcs is not None:
            conns.append(self.gcs)
        for c in conns:
            st = getattr(c, "settle_stats", None)
            if not st:
                continue
            settle["wakeups"] += st.get("wakeups", 0)
            settle["frames"] += st.get("frames", 0)
            settle["drained"] += st.get("drained", 0)
            settle["max_batch"] = max(
                settle["max_batch"], st.get("max_batch", 0)
            )
        out = {
            "node_id": self.node_id,
            "push_window": push,
            "pump": pump,
            "settle": settle,
        }
        # Round 20 planes: present only when the gate created them, so
        # gates-off snapshots stay byte-identical to round 19's.
        if self._settle_plane is not None:
            out["settle_plane"] = self._settle_plane.snapshot()
        if self._pack_plane is not None:
            out["pack_plane"] = self._pack_plane.snapshot()
        if self._pusher_shard_stats:
            out["pusher_shards"] = [
                dict(s) for s in self._pusher_shard_stats
            ]
        return out

    def _handle_task_reply(self, header, h, rframes):
        """Process a push_task reply: inline values, shm descriptors, errors."""
        tid = TaskID.from_hex(header["tid"])
        self._release_borrows(header.get("borrows", []))
        if h.get("stream"):
            rec = self._task_streams.get(header["tid"])
            if rec is not None:
                rec["count"] = h.get("count", 0)
                ev = rec.get("event")
                if ev is not None:
                    ev.set()
                if rec.get("abandoned"):
                    self._task_streams.pop(header["tid"], None)
            return
        rets = h.get("rets", [])
        cursor = 0
        for i, r in enumerate(rets):
            oid = ObjectID.for_return(tid, i).hex()
            if r["kind"] == "mem":
                n = r["nframes"]
                self.memory_store[oid] = ("mem", rframes[cursor : cursor + n])
                cursor += n
            elif r["kind"] == "shm":
                self.memory_store[oid] = ("shm", r["meta"])
            elif r["kind"] == "err":
                n = r["nframes"]
                err = self.ctx.deserialize_frames(rframes[cursor : cursor + n])
                cursor += n
                self.memory_store[oid] = ("err", err)
            nested = r.get("nested")
            if nested:
                # The executing worker pinned borrows for refs inside this
                # return value; freeing the return object must release
                # them (owned[oid]["nested"] rides the same path put()'s
                # nested refs do).
                rec = self.owned.get(oid)
                if rec is not None:
                    rec.setdefault("nested", [])
                    rec["nested"] = list(rec["nested"]) + [
                        (e[0], e[1]) for e in nested
                    ]
                else:
                    # Fire-and-forget: the caller already dropped the
                    # return ref. Re-registering would resurrect it with a
                    # count nobody decrements — release the executor's
                    # borrow credits instead.
                    self._release_borrows([(e[0], e[1]) for e in nested])
            ev = self.store_events.get(oid)
            if ev is not None:
                ev.set()

    # ---------------------------------------------------------------- actors

    def create_actor(
        self,
        cls,
        args,
        kwargs,
        *,
        resources: Optional[Dict[str, float]] = None,
        strategy: Optional[dict] = None,
        max_restarts: int = 0,
        max_concurrency: int = 1,
        concurrency_groups: Optional[Dict[str, int]] = None,
        method_meta: Optional[Dict[str, int]] = None,
        name: Optional[str] = None,
        namespace: str = "default",
        get_if_exists: bool = False,
        runtime_env: Optional[dict] = None,
        lifetime: Optional[str] = None,
    ):
        if lifetime not in (None, "detached"):
            raise ValueError(
                f"lifetime must be None or 'detached', got {lifetime!r}"
            )
        actor_id = ActorID.of(self.job_id)
        cls_key = self.export_function(cls)
        frames, ref_ids, borrows, _an = self._serialize_args(args, kwargs)
        header = {
            "actor_id": actor_id.hex(),
            "class_key": cls_key,
            "class_name": getattr(cls, "__name__", "Actor"),
            "resources": resources or {"CPU": 1},
            "strategy": strategy or {},
            "max_restarts": max_restarts,
            "max_concurrency": max_concurrency,
            "name": name,
            "namespace": namespace,
            "get_if_exists": get_if_exists,
            "lifetime": lifetime,
            "method_meta": method_meta or {},
            # env_vars/working_dir/py_modules apply to the hosted actor;
            # pip/uv actor isolation (a dedicated venv-worker per actor)
            # is not supported — validate() rejects unknown plugins and
            # construct() raises on pip/uv below.
            "renv": self._prepare_runtime_env(runtime_env),
        }
        # creation_frames replayed on restart: [spec-pickle, arg frames...].
        # argrefs live in the spec so restart replays resolve them again.
        spec = cloudpickle.dumps(
            {
                "class_key": cls_key,
                "max_concurrency": header["max_concurrency"],
                "concurrency_groups": concurrency_groups,
                "renv": header["renv"],
                "argrefs": ref_ids,
            }
        )
        from ray_tpu_torch._private.config import rt_config

        if (
            name is None
            and not get_if_exists
            and lifetime != "detached"
            and bool(rt_config.actor_create_batch)
        ):
            # Deferred batched creation (reference: async actor
            # registration — creation errors surface on the handle's
            # first use, not at .remote()): the caller gets the handle
            # immediately; a burst of N creations coalesces into
            # O(bursts) create_actor_batch head RPCs, and the batch
            # reply primes the actor channel's address so the first
            # method push skips the alive-polling round trips. Named /
            # get_if_exists / detached creations need their reply
            # synchronously and keep the per-actor verb.
            self._enqueue_actor_create(
                actor_id.hex(), header, [spec] + frames, borrows
            )
            return actor_id, None, False
        try:
            # Non-idempotent: corr-dedup at the head makes a retry after a
            # dropped reply return the FIRST creation's placement instead
            # of creating a second actor; a retry that beats a slow
            # schedule attaches to the in-flight execution.
            h = self.run_sync(
                self._head_call(
                    "create_actor", header, [spec] + frames, corr=True,
                )
            )[0]
        finally:
            # Creation args were materialized (or creation failed); drop the
            # borrow pins. Restart replay re-fetches refs best-effort — if the
            # owner freed them by then the restart fails (round-1 limitation;
            # the reference pins lineage for restartable actors instead).
            self.loop.call_soon_threadsafe(self._release_borrows, borrows)
        if "existing" in h:
            info = h["existing"]
            addr = tuple(info["addr"]) if info.get("addr") else None
            return ActorID.from_hex(info["actor_id"]), addr, True
        return actor_id, tuple(h["addr"]), False

    # Deferred creations per create_actor_batch RPC. Batches are
    # self-clocking: at most ONE batch RPC is in flight per worker, so the
    # first creation flushes at once (latency-optimal) and everything
    # enqueued during its round trip rides the next batch (throughput-
    # optimal) — same shape as the protocol layer's write coalescing.
    _ACREATE_BATCH = 256

    def _enqueue_actor_create(self, aid: str, header: dict,
                              frames: List[bytes], borrows: list):
        pc = _PendingActorCreate(aid, header, frames, borrows)
        self._actor_creating[aid] = pc
        with self._acreate_lock:
            self._acreate_buf.append(pc)
            if self._acreate_scheduled or self._acreate_inflight:
                return
            self._acreate_scheduled = True
        self.loop.call_soon_threadsafe(self._drain_actor_creates)

    def _drain_actor_creates(self):
        """Flush one batch of deferred creations (loop thread)."""
        with self._acreate_lock:
            self._acreate_scheduled = False
            if self._acreate_inflight or not self._acreate_buf:
                return
            batch = self._acreate_buf[: self._ACREATE_BATCH]
            del self._acreate_buf[: self._ACREATE_BATCH]
            self._acreate_inflight = True
        for pc in batch:
            pc.fut = self.loop.create_future()
        spawn_logged(self.loop, self._send_actor_create_batch(batch),
                     "worker.actor_create_batch")

    async def _send_actor_create_batch(self, batch):
        try:
            counts, flat = protocol.pack_multi_frames(
                [pc.frames for pc in batch]
            )
            # corr covers the WHOLE batch: a retry after a dropped reply
            # replays every item's original outcome (head dispatch dedup),
            # so no actor is ever created twice.
            h, _ = await self._head_call(
                "create_actor_batch",
                {"items": [pc.header for pc in batch], "fcounts": counts},
                flat, corr=True,
            )
            results = list(h.get("results") or ())
            for pc, res in zip(batch, results):
                if res.get("ok"):
                    addr = tuple(res.get("addr") or ()) or None
                    self._finish_actor_create(pc, addr=addr)
                else:
                    self._finish_actor_create(
                        pc, err=res.get("err") or "actor creation failed"
                    )
            for pc in batch[len(results):]:
                self._finish_actor_create(
                    pc, err="create_actor_batch reply truncated"
                )
        except Exception as e:
            for pc in batch:
                self._finish_actor_create(
                    pc, err=f"create_actor_batch failed: {e}"
                )
        finally:
            with self._acreate_lock:
                self._acreate_inflight = False
                more = bool(self._acreate_buf)
                if more:
                    self._acreate_scheduled = True
            if more:
                self.loop.call_soon(self._drain_actor_creates)

    def _finish_actor_create(self, pc: _PendingActorCreate,
                             addr=None, err: Optional[str] = None):
        """Resolve one deferred creation (loop thread): prime or poison
        the actor channel, release the arg borrows, wake every waiter."""
        ch = self.get_actor_channel(pc.aid, addr)
        if err is not None:
            ch.dead = True
            ch.death_reason = err
        elif addr is not None and ch.addr is None:
            ch.addr = tuple(addr)
        self._actor_creating.pop(pc.aid, None)
        self._release_borrows(pc.borrows)
        pc.error = err
        if pc.fut is not None and not pc.fut.done():
            pc.fut.set_result(None)
        pc.event.set()

    def ensure_actor_created(self, aid_hex: str, timeout: float = 30.0):
        """Block (caller threads only) until a locally-enqueued deferred
        creation for this actor has reached the head. Used before the
        handle crosses a process boundary (serialization) and before
        kill — a peer resolving the handle via the head must find the
        actor registered. No-op for non-pending actors; never blocks an
        event-loop thread (the receiver-side not-found grace covers the
        remaining window)."""
        pc = self._actor_creating.get(aid_hex)
        if pc is None:
            return
        try:
            asyncio.get_running_loop()
        except RuntimeError:
            pc.event.wait(timeout)

    def get_actor_channel(self, actor_id_hex: str, addr=None) -> _ActorChannel:
        ch = self.actor_channels.get(actor_id_hex)
        if ch is None:
            ch = _ActorChannel(actor_id_hex, addr)
            self.actor_channels[actor_id_hex] = ch
        return ch

    def submit_actor_task(
        self,
        actor_id_hex: str,
        method_name: str,
        args,
        kwargs,
        *,
        num_returns: int = 1,
        max_task_retries: int = 0,
        concurrency_group: Optional[str] = None,
    ) -> List[ObjectRef]:
        if num_returns == "streaming":
            raise ValueError(
                "num_returns='streaming' is not supported for actor "
                "methods (only plain tasks); return a list, or move the "
                "generator into a task"
            )
        fl = flight.ENABLED
        if fl:
            fl_t0 = time.monotonic()
        task_id = TaskID.of(ActorID.from_hex(actor_id_hex))
        frames, ref_ids, borrow_ids, _an = self._serialize_args(args, kwargs)
        header = {
            "tid": task_id.hex(),
            "aid": actor_id_hex,
            "method": method_name,
            "nret": num_returns,
            "argrefs": ref_ids,
            "borrows": borrow_ids,
            "owner": list(self.addr),
            "caller": self.worker_id.hex(),
        }
        if concurrency_group is not None:
            header["cg"] = concurrency_group
        refs = []
        for i in range(num_returns):
            oid = ObjectID.for_return(task_id, i)
            self._register_owned(oid.hex())
            refs.append(ObjectRef(oid, tuple(self.addr)))
        self._stats["tasks_submitted"] += 1
        if fl:
            # Taskpath plane: submit span + the queued stamp the dispatch
            # loop turns into a task.queued span at first push ("_tq" is
            # popped there, never sent).
            now = time.monotonic()
            taskpath.record_phase(
                "submit", header["tid"], fl_t0, now, fn=method_name,
                phase="submit",
            )
            header["_tq"] = now
        self._enqueue_dispatch(
            self._dispatch_actor_task, (header, frames, max_task_retries)
        )
        return refs

    async def _dispatch_actor_task(self, header, frames, retries):
        try:
            await self._dispatch_actor_task_inner(header, frames, retries)
        except Exception as e:
            # Nothing may escape unresolved: every return ref must settle.
            self._fail_task(
                header, e if isinstance(e, exc.RayTpuError) else exc.RayTpuError(repr(e))
            )

    async def _dispatch_actor_task_inner(self, header, frames, retries):
        from ray_tpu_torch._private.config import rt_config

        ch = self.get_actor_channel(header["aid"])
        # Submit-time queued stamp (popped here — must not ride the wire):
        # becomes the task.queued span once the first push goes out.
        t_enq = header.pop("_tq", None)
        # One correlation id per LOGICAL call, shared by every delivery
        # attempt: the hosting worker dedups on it, so a reply dropped
        # AFTER the method ran is replayed on retry — never re-applied
        # (same contract as the head's lease/create_actor corr dedup).
        header["corr"] = os.urandom(8).hex()
        # Per-attempt reply deadline: a lost push or dropped reply used to
        # hang until actor-liveness polling noticed; now each attempt is
        # bounded and re-issues with jittered backoff while the actor
        # stays ALIVE (long-running methods keep re-arming — the deadline
        # bounds silence detection, not method runtime).
        attempt_s = float(rt_config.rpc_deadline_s)
        rearm = Backoff(base=0.05, cap=2.0)
        sent_epoch = None
        attempt = 0
        while True:
            try:
                # One atomic critical section for connection resolution AND
                # sequence assignment: dispatch tasks are created in
                # submission order and asyncio.Lock wakes waiters FIFO, so
                # seq order == submission order. (Resolving the connection
                # outside the lock let every coroutine resuming from
                # get_peer re-run the `new connection => seq = 0` reset,
                # clobbering sequence numbers already handed out and
                # reordering actor calls under load.)
                async with ch.lock:
                    conn = await self._actor_conn(ch)
                    if sent_epoch != ch.epoch:
                        # First attempt on this ordering domain: take a
                        # seq. A timeout-retry on the SAME connection
                        # re-sends the SAME (caller, seq, corr) so the
                        # server's in-order admission and dedup both see
                        # one logical call.
                        ch.seq += 1
                        header["seq"] = ch.seq
                        # The ordering domain is (caller, connection
                        # epoch): a reconnect starts a fresh contiguous
                        # seq stream and the server must not mix it with
                        # the old stream's cursor.
                        header["caller"] = (
                            f"{self.worker_id.hex()}:{ch.epoch}"
                        )
                        sent_epoch = ch.epoch
                max_msg = getattr(conn, "max_msg", None)
                if (
                    max_msg is not None
                    and sum(len(f) for f in frames) + 4096 > max_msg
                ):
                    # Oversized for the ring: this call rides TCP. Server-side
                    # seq admission keeps ordering across the two transports.
                    conn = await self.get_peer(ch.addr)
                fl = flight.ENABLED
                if fl:
                    fl_t0 = time.monotonic()
                    if t_enq is not None:
                        # Actor queue time: channel resolution + creation
                        # wait before the first wire attempt.
                        taskpath.record_phase(
                            "queued", header["tid"], t_enq, fl_t0,
                            fn=header.get("method", ""),
                            outcome="actor-pending", phase="lease-wait",
                        )
                        t_enq = None
                if faultpoints.ACTIVE:
                    # drop: the push never reaches the actor worker — the
                    # reply deadline below fires and the corr-tagged retry
                    # re-delivers exactly once.
                    if await faultpoints.async_fire(
                        "worker.actor.push", err=protocol.ConnectionLost
                    ) == "drop":
                        raise asyncio.TimeoutError()
                h, rframes = await asyncio.wait_for(
                    self._call_with_tcp_fallback(
                        conn, ch.addr, "push_actor_task", header, frames
                    ),
                    attempt_s,
                )
                if fl:
                    t_now = time.monotonic()
                    flight.record("worker.actor.push", header["corr"],
                                  "worker", fl_t0, t_now, 0, "ok")
                    taskpath.record_phase(
                        "push", header["tid"], fl_t0, t_now,
                        fn=header.get("method", ""),
                    )
                self._handle_task_reply(header, h, rframes)
                return
            except asyncio.TimeoutError:
                if fl:
                    flight.record("worker.actor.push", header["corr"],
                                  "worker", fl_t0, time.monotonic(), 0,
                                  "timeout")
                # No reply inside the deadline: the request or its reply
                # was lost, or the method is still running. Either way a
                # re-issue is safe (receiver-side corr dedup attaches to
                # the in-flight execution or replays the finished reply),
                # so keep re-arming while the actor is ALIVE — liveness,
                # not a retry count, bounds this (long methods are legal).
                alive = await self._await_actor_alive(ch)
                if not alive:
                    self._fail_task(
                        header,
                        exc.ActorDiedError(
                            header["aid"], ch.death_reason or "died"
                        ),
                    )
                    return
                await asyncio.sleep(rearm.next_delay())
            except (protocol.ConnectionLost, ConnectionRefusedError, OSError):
                ch.conn = None
                alive = await self._await_actor_alive(ch)
                if not alive:
                    self._fail_task(
                        header,
                        exc.ActorDiedError(header["aid"], ch.death_reason or "died"),
                    )
                    return
                if attempt >= retries:
                    self._fail_task(
                        header,
                        exc.ActorUnavailableError(
                            f"actor {header['aid'][:8]} restarted; call was lost "
                            f"(set max_task_retries to resubmit)"
                        ),
                    )
                    return
                attempt += 1
            except protocol.RpcError as e:
                msg = str(e)
                if "ActorMissing" in msg:
                    # Actor no longer hosted there: consult the head for its
                    # fate (restarting elsewhere vs. dead).
                    ch.conn = None
                    alive = await self._await_actor_alive(ch)
                    if not alive:
                        self._fail_task(
                            header,
                            exc.ActorDiedError(
                                header["aid"], ch.death_reason or "actor died"
                            ),
                        )
                        return
                    if attempt >= retries:
                        self._fail_task(
                            header,
                            exc.ActorUnavailableError(
                                f"actor {header['aid'][:8]} restarted; call lost"
                            ),
                        )
                        return
                    attempt += 1
                    continue
                if msg.startswith("TaskError:"):
                    self._fail_task(header, exc.TaskError(msg))
                else:
                    self._fail_task(header, exc.RayTpuError(msg))
                return

    async def _actor_conn(self, ch: _ActorChannel) -> protocol.Connection:
        if ch.dead:
            raise exc.ActorDiedError(ch.actor_id, ch.death_reason)
        if ch.conn is not None and not ch.conn._closed:
            return ch.conn
        if ch.addr is None:
            if not await self._await_actor_alive(ch):
                raise exc.ActorDiedError(ch.actor_id, ch.death_reason)
        # One transport per ordering epoch: the ring (when available) or TCP,
        # never a mix — actor ordering rides the transport's FIFO.
        ring = await self.get_ring(ch.addr)
        ch.conn = ring if ring is not None else await self.get_peer(ch.addr)
        # New connection = new ordering domain for this caller. Callers hold
        # ch.lock across this reset and their own seq assignment.
        ch.seq = 0
        ch.epoch += 1
        return ch.conn

    async def _await_actor_alive(self, ch: _ActorChannel, timeout=60.0) -> bool:
        deadline = time.monotonic() + timeout
        pc = self._actor_creating.get(ch.actor_id)
        if pc is not None:
            # Deferred creation enqueued HERE hasn't reached the head yet:
            # wait for the batch reply (which primes ch.addr / ch.dead)
            # instead of polling a head that can't know the actor.
            while pc.fut is None and not pc.event.is_set():
                if time.monotonic() >= deadline:
                    return False
                await asyncio.sleep(0.001)  # drain callback races us
            if pc.fut is not None and not pc.event.is_set():
                try:
                    # Bounded, not the full deadline: the batch reply is a
                    # gather barrier at the head, so one batchmate stuck in
                    # scheduling (30s unschedulable wait) would hold THIS
                    # actor's already-granted address hostage. The handler
                    # registers each item before scheduling it, so after a
                    # short wait the head poll below can answer for this
                    # actor while the barrier is still up.
                    await asyncio.wait_for(
                        asyncio.shield(pc.fut),
                        min(1.0, max(deadline - time.monotonic(), 0.001)),
                    )
                except asyncio.TimeoutError:
                    pass
            if ch.dead:
                return False
            if ch.addr is not None:
                return True
        # Grace for not-found: a handle can cross a process boundary
        # moments before its deferred creation lands at the head; genuine
        # post-mortem queries still fail fast (dead actors keep a DEAD
        # record — only never-registered ids hit this path).
        grace = time.monotonic() + 2.0
        while time.monotonic() < deadline:
            h, _ = await self._head_call(
                "get_actor", {"actor_id": ch.actor_id}
            )
            if not h.get("found"):
                if (
                    ch.actor_id in self._actor_creating
                    or time.monotonic() < grace
                ):
                    await asyncio.sleep(0.05)
                    continue
                ch.dead = True
                ch.death_reason = "unknown actor"
                return False
            info = h["actor"]
            if info["state"] == "ALIVE":
                ch.addr = tuple(info["addr"])
                return True
            if info["state"] == "DEAD":
                ch.dead = True
                ch.death_reason = info.get("death_reason", "actor died")
                return False
            await asyncio.sleep(0.05)
        return False

    def kill_actor(self, actor_id_hex: str, no_restart: bool = True):
        # A deferred creation must land before the kill or the head would
        # see an unknown actor (and the creation would then leak it).
        self.ensure_actor_created(actor_id_hex)
        self.run_sync(
            self._head_call(
                "kill_actor",
                {"actor_id": actor_id_hex, "no_restart": no_restart},
            )
        )

    # -------------------------------------------------------------- execution

    async def _handle_rpc(self, method, header, frames, conn):
        fn = getattr(self, "rpc_" + method, None)
        if fn is None:
            raise protocol.RpcError(f"unknown worker rpc {method}")
        return await fn(header, frames, conn)

    async def rpc_ping(self, h, frames, conn):
        return {"t": time.time()}, []

    async def rpc_pubsub(self, h, frames, conn):
        for cb in self.pubsub_handlers.get(h["channel"], []):
            try:
                cb(h.get("data"), frames)
            except Exception:
                logger.exception("pubsub handler failed")
        return {}, []

    async def rpc_pull_object(self, h, frames, conn):
        """Serve an object we own (blocks until ready — long-poll pull).
        ``direct`` pulls target a non-owner holding a copy (e.g. this worker
        spilled it to its local disk): serve from the head's directory meta
        without waiting on ownership."""
        hex_ = h["oid"]
        entry = self.memory_store.get(hex_)
        if entry is None and h.get("direct"):
            hh, _ = await self._head_call("object_lookup", {"oid": hex_})
            if hh.get("found"):
                entry = ("shm", hh["meta"])
        elif entry is None:
            entry = await self._wait_local(hex_, None)
        if entry is None:
            raise protocol.RpcError(f"object {hex_} unknown to owner")
        kind = entry[0]
        if kind == "mem":
            return {"kind": "mem"}, list(entry[1])
        if kind == "shm":
            if h.get("inline"):
                frames = self.shm.get_frames(hex_, entry[1])
                if frames is None:
                    # Possibly spilled by another process since we recorded
                    # the meta: the head has the authoritative copy.
                    hh, _ = await self._head_call(
                        "object_lookup", {"oid": hex_}
                    )
                    if hh.get("found"):
                        self.memory_store[hex_] = entry = ("shm", hh["meta"])
                        frames = self.shm.get_frames(hex_, hh["meta"])
                if frames is None:
                    raise protocol.RpcError(f"object {hex_} lost at owner")
                return {"kind": "mem"}, [bytes(f) for f in frames]
            return {"kind": "shm", "meta": entry[1]}, []
        sobj = self.ctx.serialize(entry[1])
        return {"kind": "err"}, sobj.to_frames()

    async def rpc_contains_object(self, h, frames, conn):
        return {"ready": h["oid"] in self.memory_store}, []

    async def rpc_contains_object_batch(self, h, frames, conn):
        """Readiness flags for a whole oid batch (wait()'s remote poller:
        one RPC per owner per cycle instead of one per ref)."""
        store = self.memory_store
        return {"ready": [oid in store for oid in h["oids"]]}, []

    async def rpc_pull_object_batch(self, h, frames, conn):
        """Serve a batch of objects we own over ONE reply with multi-object
        frames (owner-coalesced pulls: a reader resolving N of our objects
        pays one round-trip, not N). Blocks until every requested object is
        ready — the caller's multi-ref get() waits for all of them anyway.
        Per-oid layout mirrors rpc_pull_object: shm objects return their
        meta (the reader maps the segment; ``inline`` forces bytes), mem
        objects return frames, error entries return the pickled exception."""
        oids = h["oids"]
        inline = h.get("inline")

        async def entry_for(hex_):
            entry = self.memory_store.get(hex_)
            if entry is None:
                entry = await self._wait_local(hex_, None)
            return entry

        entries = await asyncio.gather(*(entry_for(o) for o in oids))
        res = []
        frame_lists: List[List[bytes]] = []
        for hex_, entry in zip(oids, entries):
            if entry is None:
                res.append({"kind": "miss"})
                frame_lists.append([])
                continue
            kind = entry[0]
            if kind == "mem":
                res.append({"kind": "mem"})
                frame_lists.append(list(entry[1]))
            elif kind == "shm":
                if inline:
                    fl = self.shm.get_frames(hex_, entry[1])
                    if fl is None:
                        res.append({"kind": "miss"})
                        frame_lists.append([])
                        continue
                    res.append({"kind": "mem"})
                    frame_lists.append([bytes(f) for f in fl])
                else:
                    res.append({"kind": "shm", "meta": entry[1]})
                    frame_lists.append([])
            else:  # err
                res.append({"kind": "err"})
                frame_lists.append(self.ctx.serialize(entry[1]).to_frames())
        # The helper's counts ARE the wire contract for per-object frame
        # slicing — one source of truth with the flattened payload.
        counts, flat = protocol.pack_multi_frames(frame_lists)
        for r, n in zip(res, counts):
            r["n"] = n
        return {"res": res}, flat

    async def rpc_add_borrow(self, h, frames, conn):
        for oid in h.get("oids") or [h["oid"]]:
            rec = self.owned.get(oid)
            if rec is not None:
                rec["borrows"] += 1
        return {}, []

    async def rpc_release_borrow(self, h, frames, conn):
        freed: List[str] = []
        for oid in h.get("oids") or [h["oid"]]:
            rec = self.owned.get(oid)
            if rec is not None:
                rec["borrows"] -= 1
                self._maybe_free(oid, free_sink=freed)
        if freed:
            try:
                self.gcs.notify("object_free", {"oids": freed})
            except protocol.ConnectionLost as e:
                logger.debug("object_free (%d oids) on borrow release "
                             "dropped, head gone: %s", len(freed), e)
        return {}, []

    async def rpc_free_object(self, h, frames, conn):
        self._evict_freed(h["oids"])
        return {}, []

    def _evict_freed(self, oids):
        """Global free fan-out (via GCS pubsub): drop borrowed copies —
        cached inline pulls, pulled shm descriptors, local segment attaches.
        Owned entries are freed by _maybe_free, not here."""
        for oid in oids:
            if oid in self.owned:
                continue
            self.memory_store.pop(oid, None)
            if self._shm is not None:
                self._shm.free(oid)

    def _decode_arg_frames(self, header, frames):
        """Argument payload of one push back to
        ``(arg_slots, plain, kwargs, split_vals)``: the skeleton tuple,
        then one deserialize per per-arg section (header ``an`` = frame
        counts — the submit-side split that lets repeated args intern
        per peer)."""
        an = header.get("an")
        if not an:
            arg_slots, plain, kwargs = self.ctx.deserialize_frames(frames)
            return arg_slots, plain, kwargs, ()
        cut = len(frames) - sum(an)
        arg_slots, plain, kwargs = self.ctx.deserialize_frames(frames[:cut])
        sep = []
        for n in an:
            sep.append(self.ctx.deserialize_frames(frames[cut:cut + n]))
            cut += n
        return arg_slots, plain, kwargs, sep

    async def _materialize_args(self, header, frames):
        arg_slots, plain, kwargs, sep = self._decode_arg_frames(
            header, frames
        )
        ref_vals = []
        for rid, owner in header.get("argrefs", []):
            ref = ObjectRef(ObjectID.from_hex(rid), tuple(owner) if owner else None)
            ref_vals.append(ref)
        if ref_vals:
            fetched = await self._get_many(ref_vals, None)
        else:
            fetched = []
        args = []
        for kind, idx in arg_slots:
            if kind == "ref":
                args.append(fetched[idx])
            elif kind == "sv":
                args.append(sep[idx])
            else:
                args.append(plain[idx])
        return args, kwargs

    def _pressure_killer_loop(self):
        """Pressure-based task killing (reference behavior:
        ``src/ray/raylet/worker_killing_policy_group_by_owner.h`` driven by
        the memory monitor): while the node is over its memory threshold,
        pick the owner with the most running killable tasks, kill that
        group's NEWEST task (least progress lost), and let the owner's
        retry land elsewhere via the code="oom" node-avoid path. Killable
        = subprocess-backed (runtime-env executor) tasks — killing the
        child actually returns its memory; in-process thread tasks cannot
        be killed and stay guarded by admission rejection + spilling."""
        # Jittered poll: 1s ticks while pressure persists (kills stay
        # responsive), decaying to 4s when the node is calm so N workers'
        # monitors don't sample /proc in lockstep.
        poll = Backoff(base=1.0, cap=4.0, jitter=0.25)
        while not self._shutdown:
            poll.sleep()
            try:
                if not self._memory_monitor.is_pressing():
                    continue
                poll.reset()
                # Victims = tasks ACTUALLY executing inside an env child
                # right now (ex.current_task, set under the executor's
                # lock), and only RETRIABLE ones — killing a max_retries=0
                # task trades a survivable pressure spike for a permanent
                # user-visible failure.
                groups: Dict[tuple, list] = {}
                with self._env_exec_lock:
                    for ex in self._env_executors.values():
                        rec = ex.current_task
                        if rec and rec.get("retriable"):
                            groups.setdefault(rec["owner"], []).append(
                                (rec, ex)
                            )
                if not groups:
                    continue
                _owner, recs = max(groups.items(), key=lambda kv: len(kv[1]))
                victim, ex = max(recs, key=lambda r: r[0]["started"])
                if ex.current_task is not victim:
                    continue  # victim finished since the snapshot; a task
                    # that slipped in behind it may be non-retriable —
                    # re-evaluate next tick rather than kill blind
                ex.pressure_killed = True
                logger.warning(
                    "memory pressure (%s): killing task %s of owner %s "
                    "(retriable; owner will resubmit elsewhere)",
                    self._memory_monitor.usage_string(),
                    victim["tid"][:12], victim["owner"],
                )
                ex.close()
            except Exception:
                logger.exception("pressure killer iteration failed")

    def _run_in_env(self, renv: dict, fn, args, kwargs, owner=(),
                    retriable=False):
        """Execute a pip/uv task inside its cached venv subprocess
        (reference: worker-pool-per-runtime-env; here a per-env executor
        child — see runtime_env/executor.py). Runs on the executor thread;
        a cold venv build blocks only tasks of the SAME env (per-key lock),
        and per-task env_vars/working_dir apply inside the child.
        ``owner``/``retriable`` feed the pressure killer's policy."""
        from ray_tpu_torch._private import runtime_env as renv_mod
        from ray_tpu_torch._private.runtime_env import packaging, venv
        from ray_tpu_torch._private.runtime_env.executor import EnvExecutor

        renv_mod.validate(renv)
        hook = renv.get("worker_process_setup_hook")
        if hook:
            # the hook must run in the process that executes the task —
            # the env-executor CHILD, not this parent
            fn = renv_mod.SetupHookTask(hook, fn)
        use_uv = bool(renv.get("uv"))
        packages = list(renv.get("uv") or renv.get("pip") or ())
        entries = []
        if renv.get("py_modules"):
            entries = packaging.fetch_modules(self, renv["py_modules"])
        if packages and (renv.get("conda") or renv.get("image_uri")):
            raise exc.RayTpuError(
                "runtime_env cannot combine pip/uv with conda or "
                "image_uri: the venv packages would be silently ignored "
                "inside the isolated env (install them via the conda "
                "spec or bake them into the image)"
            )
        if renv.get("image_uri"):
            # working_dir is baked into the container argv as a bind
            # mount: it must key the executor cache too.
            ekey = "img-" + renv["image_uri"] + "@" + (
                renv.get("working_dir") or ""
            )
        elif renv.get("conda"):
            from ray_tpu_torch._private.runtime_env import conda as conda_mod

            ekey = conda_mod.conda_env_key(renv["conda"])
        else:
            ekey = venv.env_key(packages, use_uv)
        key = (ekey, tuple(entries))
        with self._env_exec_lock:
            ex = self._env_executors.get(key)
            if ex is not None and not ex.alive():
                ex.close()
                ex = None
                self._env_executors.pop(key, None)
            key_lock = self._env_exec_keylocks.setdefault(
                key, threading.Lock()
            )
        if ex is None:
            # Build under the PER-KEY lock: a minutes-long pip install of
            # one env must not stall tasks whose env is already built.
            with key_lock:
                with self._env_exec_lock:
                    ex = self._env_executors.get(key)
                if ex is None or not ex.alive():
                    if renv.get("image_uri"):
                        from ray_tpu_torch._private.runtime_env import (
                            conda as conda_mod,
                        )
                        from ray_tpu_torch._private.runtime_env import (
                            executor as exec_mod,
                        )

                        argv = conda_mod.container_argv(
                            renv["image_uri"], exec_mod._CHILD_SRC,
                            path_entries=entries,
                            working_dir=renv.get("working_dir"),
                        )
                        ex = EnvExecutor(
                            "container", path_entries=entries, argv=argv,
                            inherit_parent_site=False,
                        )
                    elif renv.get("conda"):
                        from ray_tpu_torch._private.runtime_env import (
                            conda as conda_mod,
                        )

                        python = conda_mod.ensure_conda_env(renv["conda"])
                        # The env is isolated (no host-site fallback);
                        # cloudpickle — the one package the child loop
                        # needs before user code — is seeded into the env
                        # at creation (conda.py _seed_cloudpickle).
                        ex = EnvExecutor(
                            python, path_entries=entries,
                            inherit_parent_site=False,
                        )
                    else:
                        python = venv.ensure_venv(packages, use_uv=use_uv)
                        ex = EnvExecutor(python, path_entries=entries)
                    with self._env_exec_lock:
                        self._env_executors[key] = ex
        # task_info feeds the pressure killer: only the task ACTUALLY
        # executing inside the child (published under the executor's lock)
        # is a victim candidate, never one queued behind it (reference:
        # worker_killing_policy_group_by_owner.h operates on running
        # workers).
        tid = getattr(self.current_task_id, "value", None)
        task_info = {
            "tid": tid.hex() if tid is not None else "",
            "owner": tuple(owner or ()),
            "started": time.monotonic(),
            "retriable": bool(retriable),
        }
        try:
            ok, result = ex.run(
                fn, args, kwargs,
                env_vars=renv.get("env_vars"),
                cwd=renv.get("working_dir"),
                task_info=task_info,
            )
        except RuntimeError as e:
            with self._env_exec_lock:
                if self._env_executors.get(key) is ex:
                    self._env_executors.pop(key, None)
            ex.close()
            if getattr(ex, "pressure_killed", False):
                # Retriable with node-avoid: the owner backs off this node
                # and resubmits elsewhere (same path as admission OOM).
                # Tasks queued behind the killed one land here too — they
                # were headed for a pressured node either way.
                raise exc.OutOfMemoryError(
                    f"task killed under memory pressure on node "
                    f"{self.node_id[:8]} ({self._memory_monitor.usage_string()})"
                )
            raise exc.WorkerCrashedError(f"runtime-env executor: {e}")
        if ok:
            return True, result
        err_repr, tb = result
        return False, (exc.TaskError(err_repr, tb), tb)
    # Serializes tasks that use working_dir: cwd is process-global, so two
    # concurrent chdir'ing tasks would corrupt each other's view (and the
    # restore). Tasks without working_dir never touch cwd and skip the lock.
    _cwd_lock = threading.Lock()

    def _run_setup_hook(self, renv: dict):
        """worker_process_setup_hook (reference:
        ``_private/runtime_env/setup_hook.py``): run ONCE per worker
        process before the first task using the env executes. Failures
        propagate — a task must not run half-initialized. Runs AFTER the
        rest of the env (env_vars/py_modules/working_dir) is in place so
        hooks may depend on it."""
        hook = (renv or {}).get("worker_process_setup_hook")
        if not hook:
            return
        from ray_tpu_torch._private import runtime_env as renv_mod

        renv_mod.run_setup_hook_once(hook)

    def _apply_runtime_env(self, renv: dict):
        """Per-task environment (reference: _private/runtime_env/ plugins).
        Applied on the executor thread: env_vars, working_dir (cwd is
        process-global, so working_dir tasks serialize on _cwd_lock),
        py_modules (content-addressed fetch + sys.path). pip/uv route the
        EXECUTION into a venv subprocess (see _run_in_env); unknown plugins
        raise — a task must not silently run without the environment it
        asked for."""
        from ray_tpu_torch._private import runtime_env as renv_mod

        renv = renv or {}
        renv_mod.validate(renv)
        inserted = []
        if renv.get("py_modules"):
            from ray_tpu_torch._private.runtime_env import packaging

            entries = packaging.fetch_modules(self, renv["py_modules"])
            import sys as _sys

            for e in reversed(entries):
                # scoped per task (removed in _restore_env): permanent
                # entries would let an older staged version shadow a newer
                # one on re-staged module updates
                if e not in _sys.path:
                    _sys.path.insert(0, e)
                    inserted.append(e)
        envs = renv.get("env_vars") or {}
        old = {}
        for k, v in envs.items():
            old[k] = os.environ.get(k)
            os.environ[k] = str(v)
        cwd = None
        locked = False
        if renv.get("working_dir"):
            self._cwd_lock.acquire()
            locked = True
            cwd = os.getcwd()
            try:
                os.chdir(renv["working_dir"])
            except OSError as e:
                logger.warning("working_dir %r: %s", renv["working_dir"], e)
                cwd = None
        state = {"env": old, "cwd": cwd, "locked": locked,
                 "sys_path": inserted}
        try:
            # after env_vars/py_modules/working_dir: hooks may import
            # staged modules or read the env they were shipped with
            self._run_setup_hook(renv)
        except BaseException:
            self._restore_env(state)
            raise
        return state

    def _restore_env(self, old):
        if old.get("sys_path"):
            import sys as _sys

            for e in old["sys_path"]:
                try:
                    _sys.path.remove(e)
                except ValueError:
                    pass
        if old.get("cwd") is not None:
            try:
                os.chdir(old["cwd"])
            except OSError:
                pass
        if old.get("locked"):
            self._cwd_lock.release()
        for k, v in old.get("env", {}).items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v

    def _record_task_event(self, event: dict):
        """Buffered task events for the state API (reference:
        ``core_worker/task_event_buffer.h`` batching to GcsTaskManager).

        Every event carries the flight-plane join keys: ``cid`` (the task
        id — the same key the ``task.*`` spans and per-task push spans
        record) and, for actor pushes, the RPC ``corr`` id — so
        ``taskpath.task_events_to_merged`` can stitch the event into the
        flight trace with flow links."""
        if not event.get("cid"):
            event["cid"] = event.get("task_id")
        if event.get("corr") is None:
            event.pop("corr", None)
        self._task_events_buf.append(event)

    async def _task_event_flusher(self):
        last_metrics = 0.0
        while not self._shutdown:
            await asyncio.sleep(0.25)
            if self._task_events_buf:
                batch, self._task_events_buf = self._task_events_buf, []
                try:
                    self.gcs.notify("task_events", {"events": batch})
                except protocol.ConnectionLost:
                    return
            now = time.monotonic()
            if now - last_metrics >= 2.0:
                last_metrics = now
                try:
                    from ray_tpu_torch.util.metrics import Gauge, registry

                    if self._shm is not None:
                        # Spill-plane counters ride the same pipeline
                        # (reference: spill stats in the metrics agent).
                        for k, v in self._shm.spill.stats_snapshot().items():
                            Gauge(
                                f"spill_{k}",
                                description="object spill counter",
                            ).set(float(v))
                    if self._push_window and self.leases:
                        # Live adaptive push window per peer slot (max
                        # across a peer's slots: the ramp level a reader
                        # cares about). Bounded cardinality: peers.
                        g = Gauge(
                            "rt_push_window",
                            description="adaptive in-flight push window "
                                        "per peer (tasks)",
                            tag_keys=("peer",),
                        )
                        agg: Dict[str, int] = {}
                        for ls in self.leases.values():
                            for s in ls.slots:
                                if s.pwin is not None:
                                    p = f"{s.addr[0]}:{s.addr[1]}"
                                    agg[p] = max(
                                        agg.get(p, 0), s.pwin.window
                                    )
                        for p, v in agg.items():
                            g.set(float(v), tags={"peer": p})
                    if self._settle_plane is not None:
                        # Settle-plane backlog (round 20): sustained
                        # depth near the handoff bound means reply
                        # settling, not the driver loop, is the choke.
                        Gauge(
                            "rt_settle_queue_depth",
                            description="reply frames queued at the "
                                        "driver settle plane",
                        ).set(float(self._settle_plane.q.depth()))
                    if memtrack.ENABLED:
                        # Object-plane gauges (store bytes by kind, ref
                        # states, arena/graveyard, memory pressure) ride
                        # the same push; the head /metrics rolls them up
                        # per node. On an executor thread: the aggregate
                        # pass is O(owned), and a 1M-task burst must not
                        # stall the core loop for its duration (GIL
                        # interleaving beats a solid loop stall).
                        await asyncio.get_running_loop().run_in_executor(
                            None, memtrack.push_gauges, self
                        )
                    snap = registry().snapshot()
                    if snap:
                        self.gcs.notify("metrics_push", {
                            "worker_id": self.worker_id.hex(),
                            "node_id": self.node_id,
                            "metrics": snap,
                        })
                except protocol.ConnectionLost:
                    return
                except Exception as e:
                    logger.debug("metrics_push failed, dropping sample: %s",
                                 e)

    def _expand_task_header(self, h, frames):
        """Undo submission-plane framing on the executing side: merge the
        pre-framed spec template (frame 0 when header flag ``sp``) back
        into the per-call header — one msgpack decode per DISTINCT spec,
        cached — install a piggybacked function blob (flag ``fb``) into
        the function cache so no kv_get is needed, and re-insert interned
        argument frames (keys ``ai``/``aib``) from the bounded LRU so
        ``deserialize_frames`` sees exactly the bytes the submitter
        framed. Returns the full header plus the (argument) frames.
        Idempotent across the ring fast path and the TCP slow path: a
        second expansion of the same message hits every cache (an ``aib``
        re-store is a no-op overwrite). An evicted ``ai`` digest raises
        the typed ``arg_intern_miss`` error — the pusher answers by
        re-sending the exact bytes."""
        idx = 0
        if h.get("sp"):
            spec = self._spec_cache.get(frames[0])
            merged = {**spec, **h}
            idx = 1
        else:
            merged = dict(h)
        merged.pop("sp", None)
        if merged.pop("fb", None):
            blob = frames[idx]
            idx += 1
            fkey = merged.get("fkey")
            if fkey and fkey not in self.fn_cache:
                try:
                    self._install_function(
                        fkey, cloudpickle.loads(blob), blob
                    )
                except Exception as e:
                    # Fall back to the function table (kv_get) — push-
                    # through is an optimization, never authoritative.
                    logger.debug("piggybacked function %s rejected: %s",
                                 fkey[:8], e)
        ai = merged.pop("ai", None)
        aib = merged.pop("aib", None)
        out = frames[idx:] if idx else frames
        if ai or aib:
            out = self._arg_intern_expand(ai, aib, out)
        return merged, out

    def _arg_intern_expand(self, ai, aib, frames):
        """Rebuild the full argument-frame list: wire frames fill the
        non-interned positions in order, ``ai`` positions come from the
        intern cache (miss => typed error, pusher re-sends), ``aib``
        frames are stored under their digest for the bursts behind this
        push."""
        if ai and faultpoints.ACTIVE:
            # error: force a miss even though the bytes are cached; drop:
            # REALLY evict them first — both funnel into the same typed
            # recovery (re-sent blob, byte-exact round trip).
            forced = False
            try:
                if faultpoints.fire("worker.arg.intern") == "drop":
                    self._arg_intern.purge([d for _p, d in ai])
            except Exception:
                forced = True
            if forced:
                raise protocol.RpcError(
                    "injected interned-arg loss", code="arg_intern_miss"
                )
        ai_map = {p: d for p, d in (ai or ())}
        aib_map = dict(aib) if aib else {}
        total = len(frames) + len(ai_map)
        out = []
        it = iter(frames)
        for pos in range(total):
            digest = ai_map.get(pos)
            if digest is not None:
                blob = self._arg_intern.get(digest)
                if blob is None:
                    raise protocol.RpcError(
                        f"interned arg frame missing at position {pos} "
                        f"(evicted or never covered)",
                        code="arg_intern_miss",
                    )
                out.append(blob)
                continue
            f = next(it)
            store = aib_map.get(pos)
            if store is not None:
                self._arg_intern.put(store, bytes(f))
            out.append(f)
        out.extend(it)
        return out

    async def rpc_push_task(self, h, frames, conn):
        """Execute a normal task (reference: ``CoreWorker::HandlePushTask``
        ``core_worker.cc:3341`` → ExecuteTask), with the round-15 reply
        plane wrapped around the execution core: per-task corr dedup (a
        deadline-re-armed re-push after a dropped coalesced reply frame
        replays the recorded outcome — exactly-once application, the
        ``rpc_push_actor_task`` contract extended to plain tasks) and
        small-result routing into the connection's ReplyWindow (the
        dispatcher sends nothing; the coalesced ``bh`` frame answers this
        correlation id). Big results — any shm-registered return — and
        streaming keep the direct per-task reply path."""
        corr = h.get("corr")
        if corr:
            state, obj = self._apush_begin(corr)
            if state == "replay":
                extras, rframes = obj
                return dict(extras), list(rframes)
            if state == "wait":
                extras, rframes = await asyncio.wrap_future(obj)
                return dict(extras), list(rframes)
        try:
            extras, rframes = await self._push_task_inner(h, frames, conn)
        except BaseException as e:
            # Failed deliveries are retried for real (only successes
            # replay); a DropReply injection lands here too — its retry
            # re-executes, same as the pre-corr contract.
            self._apush_fail(corr, e)
            raise
        self._apush_done(corr, extras, rframes)
        if (
            self._reply_batching
            and isinstance(extras, dict)
            and "rets" in extras
            and all(
                not (isinstance(r, dict) and r.get("kind") == "shm")
                for r in extras["rets"]
            )
        ):
            self._reply_window(conn).add(
                {"i": h["i"], **extras}, rframes, tag=self._window_tag(h)
            )
            return protocol.REPLY_HANDLED, []
        return extras, rframes

    async def _push_task_inner(self, h, frames, conn):
        if self.node_standby:
            # Work arriving means the head activated this node: a later
            # re-registration (blip, head restart) must not claim standby.
            self.node_standby = False
        fl = flight.ENABLED
        if fl:
            fl_srv0 = time.monotonic()
            fb_rode = "fb" in h
            f_cached = h.get("fkey") in self.fn_cache
        if "sp" in h or "fb" in h or "ai" in h or "aib" in h:
            h, frames = self._expand_task_header(h, frames)
        if self._memory_monitor.is_pressing():
            # Reject at admission so this node survives; the owner retries
            # (reference: worker-killing policies under the memory monitor).
            raise protocol.RpcError(
                f"node {self.node_id[:8]} over memory threshold "
                f"({self._memory_monitor.usage_string()})",
                code="oom",
            )
        if fl:
            fl_name = h.get("name") or h.get("fkey", "")[:10]
            t = time.monotonic()
        fn = await self._load_function(h["fkey"])
        if fl:
            # fn-push vs kv_get: the phase the submission-plane
            # push-through exists to eliminate.
            fn_out = (
                "push-through" if fb_rode
                else ("cached" if f_cached else "kv_get")
            )
            now = time.monotonic()
            taskpath.record_phase(
                "fn_load", h["tid"], t, now, fn=fl_name, outcome=fn_out,
                phase="kv-get" if fn_out == "kv_get" else "fn-push",
            )
            t = now
        args, kwargs = await self._materialize_args(h, frames)
        if fl:
            taskpath.record_phase(
                "arg_pull", h["tid"], t, time.monotonic(), fn=fl_name,
                nbytes=sum(len(f) for f in frames), phase="arg-pull",
            )
        if h.get("nret") == -1:
            return await self._execute_streaming_task(h, fn, args, kwargs, conn)
        loop = asyncio.get_running_loop()

        def run():
            from ray_tpu_torch.util.tracing import tracing_helper

            renv = h.get("renv") or {}
            tid = TaskID.from_hex(h["tid"])
            self.current_task_id.value = tid
            self.current_actor_id.value = None
            self.put_counter.value = 0
            # Key PRESENCE routes, not truthiness: {"pip": []} explicitly
            # asks for venv isolation (a subprocess executor) even with
            # nothing to install.
            if any(k in renv for k in ("pip", "uv", "conda", "image_uri")):
                # Whole env (incl. env_vars/working_dir/py_modules) applies
                # inside the venv/conda/container child — the parent
                # process must stay unpolluted.
                try:
                    with tracing_helper.span(
                        f"task::{h.get('name', 'task')}", h.get("trace"),
                        {"task_id": h["tid"], "node_id": self.node_id},
                    ):
                        return self._run_in_env(
                            renv, fn, args, kwargs,
                            owner=tuple(h.get("owner") or ()),
                            retriable=h.get("retries", 0) > 0,
                        )
                except Exception as e:
                    return False, (e, traceback.format_exc())
            try:
                old = self._apply_runtime_env(renv)
            except Exception as e:
                return False, (e, traceback.format_exc())
            try:
                with tracing_helper.span(
                    f"task::{h.get('name', 'task')}", h.get("trace"),
                    {"task_id": h["tid"], "node_id": self.node_id},
                ):
                    return True, fn(*args, **kwargs)
            except Exception as e:
                return False, (e, traceback.format_exc())
            finally:
                self._restore_env(old)

        if faultpoints.ACTIVE:
            # crash = this worker process dies mid-dispatch (after the
            # lease was consumed, before any reply) — the hard partial
            # failure the chaos matrix exercises.
            await faultpoints.async_fire("worker.task.exec")
        t0 = time.time()
        if fl:
            tm = time.monotonic()
        ok, result = await loop.run_in_executor(self.task_executor, run)
        self._stats["tasks_executed"] += 1
        if fl:
            taskpath.record_phase(
                "exec", h["tid"], tm, time.monotonic(), fn=fl_name,
                outcome="ok" if ok else "error", phase="exec",
            )
        self._record_task_event({
            "task_id": h["tid"], "name": h.get("name") or h["fkey"],
            "type": "NORMAL_TASK",
            "state": "FINISHED" if ok else "FAILED",
            "start_time": t0, "end_time": time.time(),
            "node_id": self.node_id,
        })
        if not ok and isinstance(result[0], exc.OutOfMemoryError):
            # Pressure-killed mid-run: surface as the SAME retriable
            # code="oom" rejection the admission path uses — the owner
            # backs off this node and resubmits elsewhere.
            raise protocol.RpcError(str(result[0]), code="oom")
        if not fl:
            return await self._package_result(h, ok, result)
        tm = time.monotonic()
        out = await self._package_result(h, ok, result)
        now = time.monotonic()
        taskpath.record_phase(
            "result", h["tid"], tm, now, fn=fl_name, phase="result-push",
        )
        # Serve envelope: arrival → reply ready; the driver derives
        # reply-ack (wire both ways) as its push span minus this.
        flight.record("task.serve", h["tid"], "task", fl_srv0, now)
        return out

    async def _execute_streaming_task(self, h, fn, args, kwargs, conn):
        """Run a generator task, pushing each yielded item to the owner as
        it is produced (reference: streaming generator returns — the owner
        can consume item i while item i+1 is still being computed). The
        bounded queue backpressures the producer against a slow consumer
        path; items ride oneway "stream_item" messages on the same
        connection, so they arrive before the final count reply."""
        import inspect

        loop = asyncio.get_running_loop()
        q: asyncio.Queue = asyncio.Queue(maxsize=8)
        tid = TaskID.from_hex(h["tid"])
        t0 = time.time()

        abandon = threading.Event()

        def qput(entry) -> bool:
            """Blocking put that stays abandonable: the pump (or its
            teardown) sets `abandon` and this producer thread unblocks
            within a second even if the event loop never drains the queue
            again (e.g. the pump task was cancelled)."""
            # Checked up front: once the pump abandons the stream it drains
            # the queue, so puts would keep succeeding and an infinite
            # generator would never stop producing.
            if abandon.is_set() or loop.is_closed():
                return False
            try:
                f = asyncio.run_coroutine_threadsafe(q.put(entry), loop)
            except RuntimeError:
                return False  # loop shut down under us
            # Never cancel the put: cancellation can race its completion and
            # a retry would enqueue the entry twice. Keep waiting on the SAME
            # future, bailing out between waits once abandoned (the dangling
            # put then lands, at worst, in a queue nobody reads again).
            while True:
                try:
                    f.result(timeout=1.0)
                    return True
                except SyncTimeoutError:
                    if abandon.is_set() or loop.is_closed():
                        return False
                except (SyncCancelledError, RuntimeError):
                    return False  # loop shut down under us

        def produce():
            old = self._apply_runtime_env(h.get("renv"))
            self.current_task_id.value = tid
            self.current_actor_id.value = None
            self.put_counter.value = 0
            try:
                gen = fn(*args, **kwargs)
                if not inspect.isgenerator(gen):
                    raise TypeError(
                        "num_returns='streaming' requires a generator "
                        f"function; {h.get('name', 'task')} returned "
                        f"{type(gen).__name__}"
                    )
                for item in gen:
                    if not qput(("item", item)):
                        return
                qput(("end", None))
            except Exception as e:
                tb = traceback.format_exc()
                qput(("err", (e, tb)))
            finally:
                self._restore_env(old)

        prod = loop.run_in_executor(self.task_executor, produce)
        credits = self._stream_credits[h["tid"]] = {
            "consumed": 0, "event": asyncio.Event(),
        }
        idx = 0
        failed = False
        sentinel = False  # saw the producer's final "end"/"err" entry
        try:
            while True:
                kind, payload = await q.get()
                if kind == "item":
                    try:
                        # Owner-side flow control: never run more than WINDOW
                        # items ahead of what the consumer acknowledged — a
                        # fast producer must not fill the owner's memory. A
                        # consumer silent for 10 minutes fails the stream
                        # rather than pinning this executor slot forever.
                        while idx >= credits["consumed"] + self._STREAM_WINDOW:
                            credits["event"].clear()
                            try:
                                await asyncio.wait_for(
                                    credits["event"].wait(), timeout=600
                                )
                            except asyncio.TimeoutError:
                                raise exc.RayTpuError(
                                    "stream consumer stalled >600s; aborting "
                                    "generator task"
                                )
                        await self._send_stream_item(
                            conn, h, tid, idx, payload
                        )
                        idx += 1
                    except Exception as e:
                        # The usual cause is the owner connection closing, so
                        # the error notification itself may fail — it must
                        # not skip the producer unblock below.
                        try:
                            await self._send_stream_error(
                                conn, h, tid, idx,
                                exc.TaskError(
                                    f"stream item send failed: {e!r}"
                                ),
                            )
                        except Exception:
                            pass
                        idx += 1
                        failed = True
                        break
                elif kind == "err":
                    e, tb = payload
                    sentinel = True
                    try:
                        await self._send_stream_error(
                            conn, h, tid, idx,
                            exc.TaskError(repr(e), tb, cause=e),
                        )
                    except Exception:
                        pass
                    idx += 1
                    failed = True
                    break
                else:
                    sentinel = True
                    break
        finally:
            # Runs on every exit — send failure, handler cancellation at
            # teardown, unexpected errors — and must always unblock the
            # producer thread (queue maxsize is small; a stuck producer
            # permanently leaks a task_executor slot).
            self._stream_credits.pop(h["tid"], None)
            if not sentinel:
                abandon.set()  # timed puts in the producer observe this
            try:
                while not sentinel and not prod.done():
                    try:
                        q.get_nowait()
                    except asyncio.QueueEmpty:
                        await asyncio.sleep(0.05)
                await prod
            except BaseException:
                # Re-cancelled during teardown: the abandon event still
                # guarantees the producer exits within its put timeout.
                if not abandon.is_set():
                    abandon.set()
                raise
        self._stats["tasks_executed"] += 1
        self._record_task_event({
            "task_id": h["tid"], "name": h.get("name") or h["fkey"],
            "type": "NORMAL_TASK",
            "state": "FAILED" if failed else "FINISHED",
            "start_time": t0, "end_time": time.time(),
            "node_id": self.node_id,
        })
        return {"stream": 1, "count": idx}, []

    async def _send_stream_item(self, conn, h, tid, idx, value):
        sobj = self.ctx.serialize(value)
        base = {"tid": h["tid"], "idx": idx}
        if sobj.total_bytes() <= INLINE_OBJECT_MAX:
            conn.notify(
                "stream_item", {**base, "kind": "mem"}, sobj.to_frames()
            )
        else:
            oid = ObjectID.for_return(tid, idx).hex()
            meta = self._with_xfer(
                self.shm.put_frames(oid, sobj.to_frames(copy=False))
            )
            await self.gcs.call("object_register", {"oid": oid, "meta": meta})
            conn.notify("stream_item", {**base, "kind": "shm", "meta": meta})

    # Max items a generator may run ahead of its consumer's acknowledgments.
    _STREAM_WINDOW = 16

    async def rpc_stream_credit(self, h, frames, conn):
        """Executor side: the consumer acknowledged items up to `consumed`
        (or abandoned the stream — consumed jumps effectively unbounded so
        the producer drains to completion instead of hanging)."""
        rec = self._stream_credits.get(h["tid"])
        if rec is not None:
            rec["consumed"] = max(rec["consumed"], int(h["consumed"]))
            rec["event"].set()
        return {}, []

    def _send_stream_credit(self, tid_hex: str, consumed: int):
        """Owner side: fire a credit on the stream's producer connection."""
        rec = self._task_streams.get(tid_hex)
        conn = rec.get("conn") if rec else None
        if conn is None:
            return
        try:
            conn.notify(
                "stream_credit", {"tid": tid_hex, "consumed": consumed}
            )
        except Exception as e:
            # Producer gone: nothing left to throttle.
            logger.debug("stream_credit for %s dropped: %s", tid_hex, e)

    def _abandon_stream(self, tid_hex: str, next_index: int):
        """The consumer dropped its generator: free arrived-but-unconsumed
        items, discard future arrivals, and un-throttle the producer so the
        executing task can run to completion."""
        rec = self._task_streams.get(tid_hex)
        if rec is None:
            return
        rec["abandoned"] = True
        tid = TaskID.from_hex(tid_hex)
        for i in range(next_index, rec.get("produced", 0)):
            self._dec_ref_local(ObjectID.for_return(tid, i).hex())
        self._send_stream_credit(tid_hex, 1 << 60)
        if rec.get("count") is not None:
            self._task_streams.pop(tid_hex, None)

    async def _send_stream_error(self, conn, h, tid, idx, err):
        try:
            fr = self.ctx.serialize(err).to_frames()
        except Exception:
            fr = self.ctx.serialize(
                exc.TaskError(f"unserializable stream error: {err!r}")
            ).to_frames()
        conn.notify(
            "stream_item", {"tid": h["tid"], "idx": idx, "kind": "err"}, fr
        )

    def _drop_stream_item(self, h):
        """Discard an unwanted stream item, releasing its shm registration
        (abandoned consumer, or a late arrival after the stream's length was
        finalized)."""
        if h["kind"] == "shm":
            oid = ObjectID.for_return(
                TaskID.from_hex(h["tid"]), h["idx"]
            ).hex()
            try:
                self.gcs.notify("object_free", {"oids": [oid]})
            except Exception as e:
                logger.debug("object_free for dropped stream item %s "
                             "failed: %s", oid, e)

    async def rpc_stream_item(self, h, frames, conn):
        """Owner side: one streamed item landed (stored like a task return;
        an "err" item raises on get, ending consumption with the failure)."""
        rec = self._task_streams.get(h["tid"])
        if rec is not None:
            rec["conn"] = conn  # credit/abandon messages ride this
        if rec is None or rec.get("abandoned"):
            # consumer is gone: discard, and free any shm registration
            self._drop_stream_item(h)
            return {}, []
        count = rec.get("count")
        if count is not None and (
            h["idx"] >= count or h["idx"] == rec.get("failed_idx", -1)
        ):
            # The stream's length is already finalized: a late in-flight item
            # at/after that index — or at the slot where _fail_task stored
            # the failure — must not overwrite the recorded outcome.
            self._drop_stream_item(h)
            return {}, []
        oid = ObjectID.for_return(
            TaskID.from_hex(h["tid"]), h["idx"]
        ).hex()
        if h["kind"] == "mem":
            entry = ("mem", frames)
        elif h["kind"] == "shm":
            entry = ("shm", h["meta"])
        else:
            entry = ("err", self.ctx.deserialize_frames(frames))
        self.memory_store[oid] = entry
        self._register_owned(oid)
        ev = self.store_events.get(oid)
        if ev is not None:
            ev.set()
        rec["produced"] = max(rec.get("produced", 0), h["idx"] + 1)
        sev = rec.get("event")
        if sev is not None:
            sev.set()
        return {}, []

    def _package_result_parts(self, h, ok, result):
        """Sync result packaging. Returns (rets, out_frames, big) where
        ``big`` holds (index, serialized) for values too large to inline —
        their rets entries are placeholders the caller must fill after the
        shm write + head registration."""
        nret = h.get("nret", 1)
        rets: List[Any] = []
        out_frames: List[bytes] = []
        if not ok:
            e, tb = result
            err = exc.TaskError(repr(e), tb, cause=e)
            try:
                sobj = self.ctx.serialize(err)
            except Exception:
                sobj = self.ctx.serialize(exc.TaskError(repr(e), tb))
            fr = sobj.to_frames()
            for _ in range(nret):
                rets.append({"kind": "err", "nframes": len(fr)})
                out_frames.extend(fr)
            return rets, out_frames, []
        values = (
            list(result)
            if nret > 1 and isinstance(result, (tuple, list))
            else [result]
        )
        if nret > 1 and len(values) != nret:
            err = exc.TaskError(
                f"task declared num_returns={nret} but returned {len(values)} values"
            )
            fr = self.ctx.serialize(err).to_frames()
            for _ in range(nret):
                rets.append({"kind": "err", "nframes": len(fr)})
                out_frames.extend(fr)
            return rets, out_frames, []
        big = []
        for i, v in enumerate(values[:nret]):
            # Refs nested in a return value must be pinned exactly like
            # put() pins them (reference: borrow registration on value
            # serialization, reference_counter.h): this worker holds a
            # borrow until the CALLER frees the return object and sends
            # release_borrow back. Without this, a task returning
            # [ray.put(...), ...] frees the pieces the moment its locals
            # are GC'd — the distributed-shuffle map->reduce handoff.
            sobj, nested_refs = collect_refs_during(
                lambda v=v: self.ctx.serialize(v)
            )
            nested = [
                (r.id().hex(), list(r.owner_address or ()))
                for r in nested_refs
            ]
            ret: Dict[str, Any] = {}
            if nested:
                self._add_borrows(nested)
                ret["nested"] = nested
            if sobj.total_bytes() <= INLINE_OBJECT_MAX:
                fr = sobj.to_frames()
                rets.append({**ret, "kind": "mem", "nframes": len(fr)})
                out_frames.extend(fr)
            else:
                # placeholder: filled after shm write (nested carried over)
                rets.append(None)
                big.append((i, sobj, ret))
        return rets, out_frames, big

    async def _package_result(self, h, ok, result):
        rets, out_frames, big = self._package_result_parts(h, ok, result)
        tid = TaskID.from_hex(h["tid"])
        for i, sobj, ret in big:
            oid = ObjectID.for_return(tid, i).hex()
            # written into shm before this call returns: zero-copy safe
            meta = self._with_xfer(
                self.shm.put_frames(oid, sobj.to_frames(copy=False))
            )
            await self.gcs.call("object_register", {"oid": oid, "meta": meta})
            rets[i] = {**ret, "kind": "shm", "meta": meta}
        return {"rets": rets}, out_frames

    # actor hosting ---------------------------------------------------------

    async def rpc_create_actor(self, h, frames, conn):
        """Instantiate an actor here (pushed by the head's actor scheduler)."""
        if self.node_standby:
            # Placement arriving means the head activated this node.
            self.node_standby = False
        spec = cloudpickle.loads(frames[0])
        cls = await self._load_function(spec["class_key"])
        real_cls = getattr(cls, "__rt_wrapped_cls__", cls)
        args, kwargs = await self._materialize_args(
            {"argrefs": spec.get("argrefs", [])}, frames[1:]
        )
        loop = asyncio.get_running_loop()

        def construct():
            renv = spec.get("renv") or {}
            if any(k in renv for k in ("pip", "uv", "conda", "image_uri")):
                return False, (
                    exc.RayTpuError(
                        "actors with pip/uv/conda/image_uri runtime envs "
                        "are not supported: "
                        "the actor would live outside the node process "
                        "that holds the card's CUDA context "
                        "(use py_modules, or run a task instead)"
                    ),
                    "",
                )
            try:
                old = self._apply_runtime_env(renv)
            except Exception as e:
                return False, (e, traceback.format_exc())
            self.current_actor_id.value = h["actor_id"]
            try:
                return True, real_cls(*args, **kwargs)
            except Exception as e:
                return False, (e, traceback.format_exc())
            finally:
                self._restore_env(old)

        ok, result = await loop.run_in_executor(self.task_executor, construct)
        if not ok:
            e, tb = result
            raise protocol.RpcError(f"TaskError: actor __init__ failed: {e!r}\n{tb}")
        is_async = any(
            asyncio.iscoroutinefunction(getattr(real_cls, m, None))
            for m in dir(real_cls)
            if not m.startswith("_")
        )
        inst = _ActorInstance(
            h["actor_id"], result, spec.get("max_concurrency", 1) or 1,
            is_async,
            concurrency_groups=spec.get("concurrency_groups"),
        )
        # Re-reported to a restarted head so live actors survive head loss
        # (see _reconnect_gcs / rpc_register_node hosted_actors).
        inst.public_meta = dict(h.get("meta") or {})
        self.hosted_actors[h["actor_id"]] = inst
        return {}, []

    async def rpc_kill_actor(self, h, frames, conn):
        inst = self.hosted_actors.pop(h["actor_id"], None)
        if inst is not None:
            inst.exiting = True
            inst.pool.shutdown(wait=False, cancel_futures=True)
            for pool in inst.groups.values():
                pool.shutdown(wait=False, cancel_futures=True)
        return {}, []

    # Correlation-id dedup for actor-call pushes. The sender retries a
    # push whose reply missed its deadline; the retry re-delivers the same
    # (corr, caller, seq). In-order admission routes such duplicates off
    # the ring fast path (seq < cursor), so they always land in
    # rpc_push_actor_task — which must replay the original outcome, never
    # run the method twice.

    def _apush_begin(self, corr):
        """Dedup gate. Returns ("mine", None) for a first delivery (caller
        executes, then _apush_done/_apush_fail), ("replay", (extras,
        frames)) for a duplicate of a completed call, or ("wait", fut) for
        a duplicate of a still-executing call (a SyncFuture resolved by
        the executing path). Thread-safe: the ring fast paths call this
        from pump/executor threads."""
        if not corr:
            return ("mine", None)
        with self._apush_lock:
            e = self._apush_replies.get(corr)
            if e is None:
                self._apush_replies[corr] = _APUSH_WIP
                return ("mine", None)
            if e is _APUSH_WIP:
                fut = SyncFuture()
                self._apush_replies[corr] = fut
                return ("wait", fut)
            if isinstance(e, SyncFuture):
                return ("wait", e)
            return ("replay", (e[1], e[2]))

    def _apush_trim_locked(self):
        """Evict completed entries (oldest first) — but never one younger
        than the sender's retry horizon (its duplicate may still be in
        flight; evicting it would re-execute a non-idempotent method),
        and never an in-flight marker (skipped by rotation, so one
        long-running call cannot wedge eviction behind it and grow the
        cache without bound). Beyond the hard cap, age no longer
        protects: memory wins over an already-pathological retry.
        Called every 32nd completion (plus at the hard cap) — per-call
        it was a measurable slice of the task hot path once plain tasks
        joined the corr plane. Hard-cap evictions drain a full
        ``_APUSH_CACHE`` band in one pass: evicting a single entry would
        leave the cache AT the cap, re-firing the trim on every
        subsequent completion (the equilibrium that put this function at
        ~1 call/task in the drain-thread profile)."""
        horizon = self._apush_horizon_s
        hard_lo = 7 * self._APUSH_CACHE
        now = time.monotonic()
        scanned = 0
        while (len(self._apush_replies) > self._APUSH_CACHE
               and scanned < 512):
            k = next(iter(self._apush_replies))
            v = self._apush_replies[k]
            scanned += 1
            if v is _APUSH_WIP or isinstance(v, SyncFuture):
                self._apush_replies.move_to_end(k)
                continue
            if (now - v[0] < horizon
                    and len(self._apush_replies) < hard_lo):
                break
            self._apush_replies.pop(k, None)

    def _apush_done(self, corr, extras, frames):
        """Cache a successful reply and wake any attached retry."""
        if not corr:
            return
        with self._apush_lock:
            e = self._apush_replies.get(corr)
            # Stored by reference: every caller hands a freshly built
            # frame list it never mutates, and replay sites copy at send.
            self._apush_replies[corr] = (time.monotonic(), extras, frames)
            self._apush_done_n += 1
            if (self._apush_done_n & 31) == 0 or (
                len(self._apush_replies) >= 8 * self._APUSH_CACHE
            ):
                self._apush_trim_locked()
        if isinstance(e, SyncFuture) and not e.done():
            e.set_result((extras, frames))

    def _apush_begin_many(self, corrs):
        """One-lock batch of :meth:`_apush_begin` for a chunk's corr ids
        (``None``/empty entries yield ``("mine", None)`` untouched) —
        per-task begin/done lock traffic was a measured slice of the
        drain profile once plain tasks joined the corr plane."""
        out = []
        with self._apush_lock:
            replies = self._apush_replies
            for corr in corrs:
                if not corr:
                    out.append(("mine", None))
                    continue
                e = replies.get(corr)
                if e is None:
                    replies[corr] = _APUSH_WIP
                    out.append(("mine", None))
                elif e is _APUSH_WIP:
                    fut = SyncFuture()
                    replies[corr] = fut
                    out.append(("wait", fut))
                elif isinstance(e, SyncFuture):
                    out.append(("wait", e))
                else:
                    out.append(("replay", (e[1], e[2])))
        return out

    def _apush_done_many(self, entries):
        """One-lock batch of :meth:`_apush_done`: ``entries`` =
        [(corr, extras, frames)]. Attached retries wake outside the
        lock; the trim check amortizes over the whole batch."""
        if not entries:
            return
        wake = []
        now = time.monotonic()
        with self._apush_lock:
            replies = self._apush_replies
            for corr, extras, frames in entries:
                e = replies.get(corr)
                replies[corr] = (now, extras, frames)
                if isinstance(e, SyncFuture):
                    wake.append((e, extras, frames))
            self._apush_done_n += len(entries)
            if (self._apush_done_n & 31) < len(entries) or (
                len(replies) >= 8 * self._APUSH_CACHE
            ):
                self._apush_trim_locked()
        for fut, extras, frames in wake:
            if not fut.done():
                fut.set_result((extras, frames))

    def _apush_fail(self, corr, err):
        """A failed delivery is retried for real (only successes replay);
        attached retries observe the failure."""
        if not corr:
            return
        with self._apush_lock:
            e = self._apush_replies.pop(corr, None)
        if isinstance(e, SyncFuture) and not e.done():
            e.set_exception(err)

    async def _admit_in_order(self, inst: _ActorInstance, caller: str, seq: int):
        if seq <= 0:
            return
        with inst.seq_lock:
            nxt = inst.next_seq.setdefault(caller, 1)
            if seq <= nxt:
                return
            waiters = inst.buffered.setdefault(caller, {})
            ev = asyncio.Event()
            waiters[seq] = ev
        await ev.wait()

    def _advance_seq(self, inst: _ActorInstance, caller: str, seq: int):
        if seq <= 0:
            return
        with inst.seq_lock:
            if inst.next_seq.get(caller, 1) != seq:
                return
            inst.next_seq[caller] = seq + 1
            ev = inst.buffered.get(caller, {}).pop(seq + 1, None)
        if ev is not None:
            # asyncio.Event.set is loop-affine and the fast path advances
            # from the ring pump thread; call_soon_threadsafe is legal from
            # the loop thread too, so use it unconditionally.
            try:
                self.loop.call_soon_threadsafe(ev.set)
            except RuntimeError:
                pass  # loop closing; waiter is being cancelled anyway

    async def rpc_push_actor_task(self, h, frames, conn):
        """Execute an actor method (reference: direct PushActorTask gRPC +
        ordered TaskReceiver queues ``task_execution/*_queue.h``), with
        correlation-id dedup: a retried delivery (reply dropped or
        deadline-raced) replays the original outcome or attaches to the
        in-flight execution — exactly-once application per corr id."""
        corr = h.get("corr")
        state, obj = self._apush_begin(corr)
        if state == "replay":
            extras, rframes = obj
            return dict(extras), list(rframes)
        if state == "wait":
            extras, rframes = await asyncio.wrap_future(obj)
            return dict(extras), list(rframes)
        try:
            extras, rframes = await self._push_actor_task_inner(
                h, frames, conn
            )
        except BaseException as e:
            self._apush_fail(corr, e)
            raise
        self._apush_done(corr, extras, rframes)
        if (
            self._reply_batching
            and isinstance(extras, dict)
            and "rets" in extras
            and all(
                not (isinstance(r, dict) and r.get("kind") == "shm")
                for r in extras["rets"]
            )
        ):
            # Small actor results coalesce the same way task results do;
            # shm-registered returns keep the direct per-call reply.
            self._reply_window(conn).add(
                {"i": h["i"], **extras}, rframes, tag=self._window_tag(h)
            )
            return protocol.REPLY_HANDLED, []
        return extras, rframes

    async def _push_actor_task_inner(self, h, frames, conn):
        inst = self.hosted_actors.get(h["aid"])
        if inst is None:
            raise protocol.RpcError(f"ActorMissing: actor {h['aid']} not hosted here")
        if inst.exiting:
            raise protocol.RpcError("ActorMissing: actor exiting")
        # Ordered admission per caller BEFORE any fallible work, so a failed
        # call (bad method, lost arg) still advances the sequence and cannot
        # wedge later calls (reference: SequentialActorSubmitQueue semantics).
        caller, seq = h.get("caller", ""), h.get("seq", 0)
        await self._admit_in_order(inst, caller, seq)
        loop = asyncio.get_running_loop()
        ev_start = time.time()
        fl = flight.ENABLED
        if fl:
            tm0 = time.monotonic()
        try:
            if h["method"] == "__rt_apply__":
                # Generic dispatch: run fn(instance, *args) on this actor.
                # Used by compiled graphs to install per-actor exec loops
                # (reference analog: compiled_dag_node.py:185 exec loop tasks
                # submitted onto the DAG's actors).
                def method(fn, *a, **kw):
                    return fn(inst.instance, *a, **kw)
            else:
                method = getattr(inst.instance, h["method"], None)
            if method is None:
                raise protocol.RpcError(
                    f"TaskError: actor has no method '{h['method']}'"
                )
            try:
                cg = inst.resolve_group(method, h)
            except KeyError as e:
                raise protocol.RpcError(
                    f"TaskError: unknown concurrency group {e.args[0]!r} "
                    f"(declared: {sorted(inst.groups)})"
                )
            args, kwargs = await self._materialize_args(h, frames)
            if asyncio.iscoroutinefunction(method):
                # Run on the dedicated async-actor loop, NOT the core loop:
                # a blocking ray_tpu_torch.get() inside the method would otherwise
                # deadlock the whole process. Concurrency is gated by the
                # ASYNC-side semaphore (acquired on that loop) so the fast
                # ring path and this path share one limit; admission order
                # is the FIFO scheduling order onto the async loop, so seq
                # advances at scheduling time.
                async def _run_with_ctx():
                    async with inst.async_sem_for(cg):
                        _async_actor_id.set(h["aid"])
                        _async_task_id.set(h["tid"])
                        return await method(*args, **kwargs)

                afut = asyncio.run_coroutine_threadsafe(
                    _run_with_ctx(), self._get_async_loop()
                )
                self._advance_seq(inst, caller, seq)
                try:
                    result, ok = await asyncio.wrap_future(afut), True
                except (Exception, SystemExit) as e:
                    result, ok = (e, traceback.format_exc()), False
            else:
                def run():
                    tid = TaskID.from_hex(h["tid"])
                    self.current_task_id.value = tid
                    self.current_actor_id.value = h["aid"]
                    self.put_counter.value = 0
                    return method(*args, **kwargs)

                fut = loop.run_in_executor(inst.pool_for(cg), run)
                # Pool admission happened in seq order; later seqs may now queue.
                self._advance_seq(inst, caller, seq)
                try:
                    result, ok = await fut, True
                except (Exception, SystemExit) as e:
                    result, ok = (e, traceback.format_exc()), False
        finally:
            self._advance_seq(inst, caller, seq)
        inst.num_executed += 1
        if fl:
            taskpath.record_phase(
                "exec", h["tid"], tm0, time.monotonic(), fn=h["method"],
                outcome="ok" if ok else "error", phase="exec",
            )
        self._record_task_event({
            "task_id": h["tid"], "name": h["method"], "type": "ACTOR_TASK",
            "actor_id": h["aid"], "corr": h.get("corr"),
            "state": "FINISHED" if ok else "FAILED",
            "start_time": ev_start, "end_time": time.time(),
            "node_id": self.node_id,
        })
        if not ok:
            e, tb = result if isinstance(result, tuple) else (result, "")
            if isinstance(e, SystemExit):
                # exit_actor(): report clean exit to the head
                self.hosted_actors.pop(h["aid"], None)
                self.gcs.notify(
                    "actor_exited",
                    {"actor_id": h["aid"], "clean": True, "reason": "exit_actor"},
                )
                raise protocol.RpcError("ActorMissing: actor exited")
            return await self._package_result(h, False, (e, tb))
        return await self._package_result(h, True, result)

    # ------------------------------------------------------------------ misc

    _async_loop_lock = threading.Lock()

    def _get_async_loop(self) -> asyncio.AbstractEventLoop:
        """Dedicated event loop thread for async actor method bodies
        (reference: per-actor asyncio loops in the Python worker). Keeping
        user coroutines off the core loop means blocking calls inside them
        (get/put/wait) cannot deadlock the process's networking. Called
        from the core loop AND the ring pump thread — locked so two racing
        callers cannot spawn two loops."""
        loop = getattr(self, "_async_actor_loop", None)
        if loop is not None:
            return loop
        with self._async_loop_lock:
            loop = getattr(self, "_async_actor_loop", None)
            if loop is not None:
                return loop
            return self._spawn_async_loop()

    def _spawn_async_loop(self) -> asyncio.AbstractEventLoop:
        ready = threading.Event()
        holder = {}

        def runner():
            l = asyncio.new_event_loop()
            asyncio.set_event_loop(l)
            holder["loop"] = l
            ready.set()
            l.run_forever()

        t = threading.Thread(target=runner, name="rt-async-actors", daemon=True)
        t.start()
        ready.wait(timeout=10)
        self._async_actor_loop = holder["loop"]
        return self._async_actor_loop

    async def rpc_flight_drain(self, h, frames, conn):
        """Hand this process's flight-recorder ring to the head (the
        ``flight_snapshot`` fan-out). The reply carries our wall clock so
        the head can offset-correct our spans onto its own."""
        snap = flight.drain() if h.get("drain", True) else flight.snapshot()
        return {"flight": snap, "enabled": flight.ENABLED}, []

    async def rpc_memstat_drain(self, h, frames, conn):
        """Hand this process's object/memory accounting to the head (the
        ``memory_summary`` fan-out). Disabled plane answers without a
        payload — same contract as tool clients on ``flight_drain``. The
        snapshot pass is O(owned) and runs on an executor thread so an
        operator summary mid-burst never stalls the core loop."""
        if not memtrack.ENABLED:
            return {"enabled": False}, []
        snap = await asyncio.get_running_loop().run_in_executor(
            None, memtrack.local_snapshot, self
        )
        return {"memstat": snap, "enabled": True}, []

    # The debugging verbs (stack dump, tracemalloc, sampling CPU profile,
    # device profile: util/debug.py, with torch.profiler in place of the
    # XLA capture) are not ported yet.
    async def rpc_dump_stacks(self, h, frames, conn):
        raise NotImplementedError(_DEBUG_TODO)

    async def rpc_memory_profile(self, h, frames, conn):
        raise NotImplementedError(_DEBUG_TODO)

    async def rpc_cpu_profile(self, h, frames, conn):
        raise NotImplementedError(_DEBUG_TODO)

    async def rpc_device_profile(self, h, frames, conn):
        raise NotImplementedError(_DEBUG_TODO)

    async def rpc_run_control(self, h, frames, conn):
        """Run a pickled zero-arg callable on this process's control loop —
        internal hook for tests and the chaos killer."""
        fn = cloudpickle.loads(frames[0])
        res = fn()
        if asyncio.iscoroutine(res):
            res = await res
        return {}, [cloudpickle.dumps(res)]

    async def rpc_shutdown(self, h, frames, conn):
        self._shutdown = True
        loop = asyncio.get_running_loop()
        loop.call_later(0.05, loop.stop)
        return {}, []

    def shutdown(self):
        self._shutdown = True
        # Round 20 planes drain BEFORE transports tear down: a queued
        # reply frame still settles (its futures fail later with the
        # connections if the peer is already gone), and a queued packed
        # submit either dispatches or fails with the loop — never lost
        # silently in a worker thread.
        if self._pack_plane is not None:
            self._pack_plane.close()
            self._pack_plane = None
        if self._settle_plane is not None:
            for c in list(self.peers.values()):
                c.settle_plane = None
            for rc in list(self._ring_peers.values()):
                if rc is not False:
                    rc.settle_plane = None
            if self.gcs is not None:
                self.gcs.settle_plane = None
            self._settle_plane.close()
            self._settle_plane = None
        # Reply windows first, while every transport is still up: results
        # buffered behind an in-flight ack (short-lived executors, a
        # graceful remove_node drain) must reach their submitters before
        # connections start tearing down.
        self._flush_reply_windows()
        ObjectRef._release_hook = None
        with self._env_exec_lock:
            for ex in self._env_executors.values():
                ex.close()
            self._env_executors.clear()
        if self.xfer_addr is not None:
            try:
                from ray_tpu_torch.native import xfer as native_xfer

                native_xfer.stop_server(self.xfer_addr[1])
            except Exception:
                pass
            self.xfer_addr = None
        if self.loop is None:
            return

        async def _close():
            if self.gcs is not None and self._task_events_buf:
                # Clean-shutdown flush: a short-lived driver's tail events
                # (< one 0.25s flusher tick old) must reach the head's
                # ring before the connection drops. A call (not notify)
                # so delivery is confirmed before teardown proceeds.
                batch, self._task_events_buf = self._task_events_buf, []
                try:
                    await asyncio.wait_for(
                        self.gcs.call("task_events", {"events": batch}),
                        timeout=2.0,
                    )
                except Exception as e:
                    logger.debug("final task-event flush failed: %s", e)
            try:
                for rc in list(self._ring_peers.values()):
                    if rc is not False:
                        rc._teardown()
                for rc in self._served_rings:
                    rc._teardown()
                for c in list(self.peers.values()):
                    await c.close()
                if self.gcs is not None:
                    await self.gcs.close()
                if self.server is not None:
                    await self.server.close()
            except Exception:
                pass
            if self._shm is not None:
                self._shm.close_all()
            # Quiet teardown: cancel stragglers (reapers, recv loops).
            me = asyncio.current_task()
            for t in asyncio.all_tasks():
                if t is not me:
                    t.cancel()

        try:
            fut = asyncio.run_coroutine_threadsafe(_close(), self.loop)
            fut.result(timeout=5)
        except Exception:
            pass
        for shard in self._pusher_loops:
            try:
                shard.call_soon_threadsafe(shard.stop)
            except RuntimeError:
                pass  # already stopped
        for t in self._pusher_threads:
            t.join(timeout=2)
        self._pusher_loops = []
        self._pusher_threads = []
        if self.loop_thread is not None:
            self.loop.call_soon_threadsafe(self.loop.stop)
            self.loop_thread.join(timeout=5)


# The process-global worker (reference: ``python/ray/_private/worker.py``
# global_worker). Set by ``ray_tpu_torch.init`` / worker_main.
global_worker: Optional[CoreWorker] = None


def get_global_worker() -> CoreWorker:
    if global_worker is None:
        raise exc.RayTpuError(
            "ray_tpu_torch has not been initialized; call ray_tpu_torch.init() first"
        )
    return global_worker
