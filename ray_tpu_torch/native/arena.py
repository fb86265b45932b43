"""Python client for the native shm arena store (plasma-analog client).

Exposes the same interface as ``_private/object_store.LocalShmStore`` so the
worker can swap backends: ``put_frames``/``get_frames``/``contains``/``free``/
``close_all``. Objects are stored with the identical frame layout
([u32 nframes][u64 len]*n, 8-aligned payloads) so serialization code sees no
difference; the payload just lives in one node-wide arena instead of one shm
segment per object.

Semantics mirrored from the reference store
(src/ray/object_manager/plasma/store.cc): create→write→seal by the producer,
get pins, delete defers reclamation until the last pin drops. The Python side
tracks this process's pins and its created objects so ``free`` maps onto
release (reader) or delete (owner).
"""
from __future__ import annotations

import ctypes
import logging
import os
import struct
import threading
import time
import weakref
from typing import List, Optional

from ray_tpu_torch import native as _native
from ray_tpu_torch._private.backoff import Backoff as _Backoff
from ray_tpu_torch._private.object_store import LocalShmStore

logger = logging.getLogger(__name__)

_ALIGN = 8
_HDR_COUNT = struct.Struct("<I")
_HDR_LEN = struct.Struct("<Q")

# 4 GiB virtual default: pages are faulted on demand by the native
# prefault watermark, so an idle session costs ~nothing — while put-heavy
# multi-client workloads stop spilling into cold per-object fallback
# segments (the round-2 multi_client_put collapse). _shm_budget still caps
# this below what /dev/shm can actually hold.
DEFAULT_CAPACITY = int(os.environ.get("RT_ARENA_BYTES", 4 << 30))
INDEX_SLOTS = 1 << 15


# Frames at/above this size take the native copy path (GIL released; NT
# streaming stores from 16MB by auto-probe — RT_STREAM_MIN_MB overrides —
# and one extra copy thread per 4MB up to the coordinated budget).
_PARALLEL_COPY_MIN = 1024 * 1024


def _buffer_address(b) -> Optional[int]:
    """Stable address of a bytes/writable-buffer payload for the duration of
    the copy (the caller keeps ``b`` alive); None when not obtainable
    zero-copy (e.g. a read-only non-bytes view)."""
    if isinstance(b, bytes):
        return ctypes.cast(ctypes.c_char_p(b), ctypes.c_void_p).value
    try:
        mv = memoryview(b)
        if not mv.c_contiguous:
            return None
        if mv.readonly:
            return None
        arr = (ctypes.c_char * mv.nbytes).from_buffer(mv)
        return ctypes.addressof(arr)
    except (TypeError, ValueError):
        return None


def _align(n: int) -> int:
    return (n + _ALIGN - 1) & ~(_ALIGN - 1)


def _shm_budget(requested: int) -> int:
    """Cap the arena below what /dev/shm can actually hold."""
    try:
        st = os.statvfs("/dev/shm")
        free = st.f_bavail * st.f_frsize
        return max(min(requested, int(free * 0.4)), 1 << 24)
    except OSError:
        return requested


class NativeArenaStore:
    """ctypes client for one named arena. Raises RuntimeError if the native
    library is unavailable or the arena cannot be created/attached."""

    def __init__(self, name: str, capacity: Optional[int] = None,
                 create: bool = True, index_slots: int = INDEX_SLOTS):
        lib = _native.load_library()
        if lib is None:
            raise RuntimeError("native library unavailable")
        if capacity is None:
            # resolved at call time so tests/env can size a fresh session's
            # arena without re-importing the module
            from ray_tpu_torch._private.config import rt_config

            capacity = rt_config.arena_bytes
        self._lib = lib
        self.name = name
        self.created_arena = False
        h = lib.rt_arena_attach(name.encode())
        if h < 0 and create:
            cap = _shm_budget(capacity)
            h = lib.rt_arena_create(name.encode(), cap, index_slots)
            if h >= 0:
                self.created_arena = True
            elif h == -17:  # EEXIST: lost the creation race
                h = lib.rt_arena_attach(name.encode())
        # The creator publishes the header magic last; an attach landing in
        # its init window (file exists, magic unset → EPROTO/EINVAL) must
        # wait it out, not fall back for the process's whole lifetime.
        deadline = time.monotonic() + 5.0
        attach_poll = _Backoff(base=0.01, cap=0.1)
        while h < 0 and h != -2 and time.monotonic() < deadline:  # -2=ENOENT
            attach_poll.sleep()
            h = lib.rt_arena_attach(name.encode())
        if h < 0:
            raise RuntimeError(f"arena {name}: errno {-h}")
        self._h = h
        self._base = lib.rt_arena_base(h)
        # Objects this process created (free() maps to delete for these).
        # Reader pins are owned by the buffers themselves: get_frames attaches
        # a finalizer to the mapping window so the pin drops only when the
        # last zero-copy view dies (plasma client-buffer semantics).
        # Insertion-ordered (dict): creation order doubles as the
        # spill-eviction order (oldest first).
        self._created: dict = {}
        # Windows that get_frames exported and that are still alive, and
        # whether close_all ran: the mapping is unmapped once both say so.
        # The lock guards only these counters: no call into the library is
        # made under it. It is reentrant because a view's finalizer can run
        # inside another's (the cyclic GC may start on any allocation).
        self._views = 0
        self._closed = False
        self._detached = False
        self._views_lock = threading.RLock()

    # -- store interface ----------------------------------------------------

    def put_frames(self, object_hex: str, frames: List[bytes]) -> Optional[dict]:
        """Returns meta, or None when the arena is full (caller falls back)."""
        total = _HDR_COUNT.size + _HDR_LEN.size * len(frames)
        offsets = []
        for f in frames:
            total = _align(total)
            offsets.append(total)
            total += len(f)
        off = self._lib.rt_obj_create(self._h, object_hex.encode(), max(total, 1))
        if off < 0:
            if off in (-28, -23):  # ENOSPC / ENFILE
                return None
            raise RuntimeError(f"obj_create({object_hex}): errno {-off}")
        buf = self._view(off, total)
        _HDR_COUNT.pack_into(buf, 0, len(frames))
        pos = _HDR_COUNT.size
        for f in frames:
            _HDR_LEN.pack_into(buf, pos, len(f))
            pos += _HDR_LEN.size
        for o, f in zip(offsets, frames):
            n = len(f)
            if n >= _PARALLEL_COPY_MIN:
                src = _buffer_address(f)
                if src is not None:
                    # native streaming copy, thread budget shared across
                    # every process putting into this arena concurrently
                    rc = self._lib.rt_arena_copy(self._h, off + o, src, n)
                    if rc != 0:
                        # Never seal an unwritten payload (readers would get
                        # garbage) — and delete the created entry so the id
                        # isn't wedged in kCreated holding its allocation.
                        self._lib.rt_obj_delete(self._h, object_hex.encode())
                        raise RuntimeError(
                            f"arena_copy({object_hex}): errno {-rc}"
                        )
                    continue
            buf[o : o + n] = f
        rc = self._lib.rt_obj_seal(self._h, object_hex.encode())
        if rc != 0:
            # Same leak class as a failed copy: never leave the id wedged
            # in kCreated holding its allocation.
            self._lib.rt_obj_delete(self._h, object_hex.encode())
            raise RuntimeError(f"obj_seal({object_hex}): errno {-rc}")
        # Value is the sealed size (truthy — callers only gate on presence):
        # per-process created-bytes accounting for the memtrack plane.
        self._created[object_hex] = total
        return {"arena": self.name, "size": total}

    def get_frames(self, object_hex: str, meta: dict) -> Optional[List[memoryview]]:
        size = ctypes.c_uint64()
        off = self._lib.rt_obj_get(self._h, object_hex.encode(), ctypes.byref(size))
        if off < 0:
            return None
        arr = (ctypes.c_char * size.value).from_address(self._base + off)
        # The pin taken by rt_obj_get is released when the last view into this
        # window is GC'd — deserialized arrays alias arena memory, so the
        # block must not be reused while any of them is alive. (Reference:
        # plasma client buffers release on destruction.) The window is also
        # counted: after close_all the mapping stays until the last one dies.
        # atexit=False: at interpreter exit the arena is torn down wholesale
        # anyway.
        with self._views_lock:
            self._views += 1
        fin = weakref.finalize(arr, self._view_died, object_hex.encode())
        fin.atexit = False
        buf = memoryview(arr).cast("B")
        nframes = _HDR_COUNT.unpack_from(buf, 0)[0]
        lens = []
        pos = _HDR_COUNT.size
        for _ in range(nframes):
            lens.append(_HDR_LEN.unpack_from(buf, pos)[0])
            pos += _HDR_LEN.size
        out = []
        for ln in lens:
            pos = _align(pos)
            out.append(buf[pos : pos + ln])
            pos += ln
        return out

    def contains(self, object_hex: str) -> bool:
        return bool(self._lib.rt_obj_contains(self._h, object_hex.encode()))

    def free(self, object_hex: str, meta: Optional[dict] = None):
        enc = object_hex.encode()
        if object_hex in self._created:
            self._created.pop(object_hex, None)
            self._lib.rt_obj_delete(self._h, enc)
        elif meta is not None:
            # Owner-side free of an object this process didn't create (e.g.
            # the creator died and the head reassigned ownership). Drops the
            # (possibly leaked) creator pin and marks the block deletable.
            self._lib.rt_obj_delete(self._h, enc)
        # Reader-side free (meta=None, not creator) is a no-op: get-pins are
        # released by the buffer finalizers when the views die.

    def close_all(self):
        """Session teardown: delete this process's objects, unlink the
        arena if this process created it, and unmap it, at once when no
        window that ``get_frames`` exported is alive, else when the last one
        dies (a view kept past ``shutdown()`` stays readable)."""
        for hex_ in list(self._created):
            self.free(hex_)
        if self.created_arena:
            self._lib.rt_arena_unlink(self.name.encode())
        with self._views_lock:
            self._closed = True
            detach = self._take_detach_locked()
        if detach:
            self._lib.rt_arena_detach(self._h)

    def _view_died(self, object_hex: bytes) -> None:
        # The view still counts while its pin is released, so the arena
        # cannot be unmapped under the release.
        self._lib.rt_obj_release(self._h, object_hex)
        with self._views_lock:
            self._views -= 1
            detach = self._take_detach_locked()
        if detach:
            self._lib.rt_arena_detach(self._h)

    def _take_detach_locked(self) -> bool:
        """Whether the caller is to unmap the arena now (once, after
        close_all, with no view alive)."""
        if self._closed and self._views == 0 and not self._detached:
            self._detached = True
            return True
        return False

    # -- helpers ------------------------------------------------------------

    def _view(self, off: int, size: int) -> memoryview:
        arr = (ctypes.c_char * size).from_address(self._base + off)
        return memoryview(arr).cast("B")

    def created_stats(self) -> dict:
        """This process's contribution to the shared arena: objects it
        created (and still holds) with their sealed sizes."""
        n = b = 0
        for v in list(self._created.values()):
            n += 1
            b += int(v)
        return {"objects": n, "bytes": b}

    def created_oids(self) -> List[str]:
        return list(self._created)

    def stats(self) -> dict:
        used = ctypes.c_uint64()
        nobj = ctypes.c_uint64()
        cap = ctypes.c_uint64()
        peak = ctypes.c_uint64()
        self._lib.rt_arena_stats(
            self._h, ctypes.byref(used), ctypes.byref(nobj),
            ctypes.byref(cap), ctypes.byref(peak),
        )
        return {
            "bytes_in_use": used.value,
            "num_objects": nobj.value,
            "capacity": cap.value,
            "peak_bytes": peak.value,
        }


class HybridShmStore:
    """Arena-first store with per-object-segment fallback.

    Mirrors plasma's fallback allocation (create_request_queue falling back to
    filesystem-backed mmap when the main arena is exhausted): puts go to the
    native arena; on arena-full (or no native toolchain) they land in a
    per-object POSIX shm segment via the portable store. Reads dispatch on the
    meta descriptor ("arena" vs "seg" key).
    """

    def __init__(self, arena_name: Optional[str], prefix: str = "rt"):
        self.fallback = LocalShmStore(prefix=prefix)
        self.arena: Optional[NativeArenaStore] = None
        # Disk spilling (reference: local_object_manager SpillObjects /
        # AsyncRestoreSpilledObject). spill_handler is installed by the
        # CoreWorker: called with the byte count needed, returns bytes it
        # freed from the arena by spilling sealed objects to disk.
        from ray_tpu_torch._private.spill import SpillManager

        self.spill = SpillManager(session=(arena_name or "anon").strip("/"))
        self.spill_handler = None
        from ray_tpu_torch._private.config import rt_config

        if arena_name and not rt_config.disable_native_store:
            try:
                self.arena = NativeArenaStore(arena_name)
            except (RuntimeError, OSError) as e:
                logger.debug("native arena unavailable (%s); portable store", e)

    @property
    def native_enabled(self) -> bool:
        return self.arena is not None

    def put_frames(self, object_hex: str, frames: List[bytes],
                   transient: bool = False) -> dict:
        if self.arena is not None:
            # arena blocks reclaim for real on delete: transient is only
            # meaningful for the per-segment fallback store
            meta = self.arena.put_frames(object_hex, frames)
            if meta is None and self.spill_handler is not None:
                # Arena full: spill cold sealed objects to disk, retry once.
                need = sum(len(f) for f in frames) + 4096
                try:
                    freed = self.spill_handler(need)
                except Exception:
                    logger.exception("spill handler failed")
                    freed = 0
                if freed > 0:
                    meta = self.arena.put_frames(object_hex, frames)
            if meta is not None:
                return meta
        return self.fallback.put_frames(object_hex, frames,
                                        transient=transient)

    def get_frames(self, object_hex: str, meta: dict) -> Optional[List[memoryview]]:
        if "spill" in meta:
            frames = self.spill.read(meta)
            return (
                [memoryview(f) for f in frames] if frames is not None else None
            )
        if "arena" in meta:
            if self.arena is None:
                return None
            return self.arena.get_frames(object_hex, meta)
        return self.fallback.get_frames(object_hex, meta)

    def contains(self, object_hex: str) -> bool:
        if self.arena is not None and self.arena.contains(object_hex):
            return True
        return self.fallback.contains(object_hex)

    def free(self, object_hex: str, meta: Optional[dict] = None):
        if meta is not None and "spill" in meta:
            self.spill.delete(meta)
            return
        if meta is not None and "seg" in meta:
            self.fallback.free(object_hex, meta)
            return
        if self.arena is not None:
            self.arena.free(object_hex, meta)
            # The owner's meta can be stale (a sibling process spilled the
            # object after the owner cached the arena meta): also drop any
            # spilled copy, or frees leak spill objects for the session's
            # life (key_uri: scheme-aware — file path or bucket uri).
            self.spill.delete({"spill": self.spill.key_uri(object_hex)})
        if meta is None:
            self.fallback.free(object_hex)

    def stats(self) -> dict:
        """Store-plane accounting for the memtrack gauges: node-wide arena
        counters (None without the native toolchain), this process's
        fallback-segment and graveyard bytes, and the spill counters."""
        from ray_tpu_torch._private.object_store import graveyard_stats

        return {
            "arena": self.arena.stats() if self.arena is not None else None,
            "arena_created": (
                self.arena.created_stats() if self.arena is not None
                else {"objects": 0, "bytes": 0}
            ),
            "fallback": self.fallback.created_stats(),
            "graveyard": graveyard_stats(),
            "spill": self.spill.stats_snapshot(),
        }

    def created_oids(self) -> List[str]:
        """Objects this process created and still holds in either store —
        the 'a live mapping still backs this directory entry' signal the
        leak detector checks before flagging an orphan."""
        oids = self.fallback.created_oids()
        if self.arena is not None:
            oids += self.arena.created_oids()
        return oids

    def close_all(self):
        if self.arena is not None:
            if self.arena.created_arena:
                # Session teardown (we created the arena → we are the
                # session's first process): remove the spill directory too.
                self.spill.cleanup()
            self.arena.close_all()
        self.fallback.close_all()
