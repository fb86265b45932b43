// Native object-transfer plane: bulk object fetch between hosts.
//
// TPU-era equivalent of the reference's object_manager data plane
// (src/ray/object_manager/: ObjectManager object_manager.h:128, chunked
// PushManager/PullManager, ObjectBufferPool) — the path that moves object
// payloads BETWEEN machines. Intra-host sharing stays zero-copy through the
// shm arena / per-object segments; this server exposes those same bytes
// over TCP so a remote host's fetch never touches the Python RPC plane.
//
// Protocol (little-endian):
//   request:  u32 magic "RTX2" | u8 kind (0 = shm segment, 1 = arena object)
//             u16 len1, name1   (kind 0: segment name; kind 1: arena name)
//             u16 len2, name2   (kind 1: object hex; else empty)
//             u16 len3, token   (cluster auth token; empty = auth off)
//   response: u8 status (0 ok, 1 not found, 2 error) | u64 len | payload
//
// The payload is the segment's/object's raw bytes — the store's
// [u32 nframes][u64 len]*n | frames layout — so the fetching side writes it
// into a local segment verbatim and reads it with the normal store code.
//
// Server: one accept thread feeding a bounded fd queue drained by a fixed
// worker pool (2x cores, max 32) — bulk transfers keep the blocking write
// loop, but thread count and per-connection churn stay bounded at the
// many-node envelope. Arena attachments are cached per arena name until
// the name is unlinked or the last listener stops (then detached).
// Serving pins arena objects via rt_obj_get/rt_obj_release; plain segments
// stay readable through the mmap even if unlinked mid-transfer.

#include <arpa/inet.h>
#include <fcntl.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <poll.h>
#include <sys/mman.h>
#include <sys/socket.h>
#include <sys/stat.h>
#include <unistd.h>

#include <atomic>
#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <condition_variable>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>

// Exported by arena_store.cc (linked into this same .so).
extern "C" {
int rt_arena_attach(const char* name);
int rt_arena_detach(int handle);
void* rt_arena_base(int handle);
int64_t rt_obj_get(int handle, const char* object_hex, uint64_t* size_out);
int rt_obj_release(int handle, const char* object_hex);
}

namespace {

constexpr uint32_t kMagic = 0x32585452;  // "RTX2" (v2 adds the auth token)

// Cluster auth token (reference behavior: src/ray/rpc/authentication/
// token auth): cached from RT_AUTH_TOKEN at first use; the request's
// token field must match or the connection is dropped before any
// object bytes move. Empty env = auth disabled.
// Token storage: initialized from the env at library load (single
// threaded), updated through rt_xfer_set_token by the Python side on
// re-init/shutdown. NOT per-call getenv: serving threads racing a
// setenv/unsetenv from Python is POSIX-undefined (environ may be
// realloc'd mid-walk).
std::mutex g_token_mu;
std::string g_token = [] {
  const char* t = getenv("RT_AUTH_TOKEN");
  return std::string(t ? t : "");
}();

std::string expected_token() {
  std::lock_guard<std::mutex> lk(g_token_mu);
  return g_token;
}

// Only framework-owned shm names are served (segments "rt*", arenas "/rt*"):
// the server must not let a peer read arbitrary host shared memory.
bool AllowedName(const std::string& name) {
  size_t i = (!name.empty() && name[0] == '/') ? 1 : 0;
  return name.size() >= i + 2 && name[i] == 'r' && name[i + 1] == 't';
}

std::string ShmPath(const std::string& name) {
  std::string n = name;
  while (!n.empty() && n[0] == '/') n.erase(0, 1);
  return "/dev/shm/" + n;
}

void SetIoTimeout(int fd, int timeout_ms) {
  if (timeout_ms <= 0) return;
  struct timeval tv;
  tv.tv_sec = timeout_ms / 1000;
  tv.tv_usec = (timeout_ms % 1000) * 1000;
  setsockopt(fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));
  setsockopt(fd, SOL_SOCKET, SO_SNDTIMEO, &tv, sizeof(tv));
}

bool ReadFull(int fd, void* buf, size_t n) {
  char* p = static_cast<char*>(buf);
  while (n > 0) {
    ssize_t r = read(fd, p, n);
    if (r <= 0) {
      if (r < 0 && errno == EINTR) continue;
      return false;
    }
    p += r;
    n -= r;
  }
  return true;
}

bool WriteFull(int fd, const void* buf, size_t n) {
  const char* p = static_cast<const char*>(buf);
  while (n > 0) {
    ssize_t r = write(fd, p, n);
    if (r <= 0) {
      if (r < 0 && errno == EINTR) continue;
      return false;
    }
    p += r;
    n -= r;
  }
  return true;
}

bool SendResponse(int fd, uint8_t status, const void* payload, uint64_t len) {
  if (!WriteFull(fd, &status, 1)) return false;
  if (!WriteFull(fd, &len, 8)) return false;
  if (len > 0 && !WriteFull(fd, payload, len)) return false;
  return true;
}

// Arena attachments, cached per arena name. A serving thread holds its
// entry (users > 0) while it reads the mapping. An entry leaves the cache
// when its name is found unlinked (the owner closed the arena: its session
// is over) or when this process stops its last listener; the mapping is
// detached as soon as it has left the cache and its last user is done, so
// no attachment outlives the session in a process that keeps running.
struct ArenaRef {
  int handle;
  int users;
  bool cached;
};

std::mutex g_arena_mu;
std::unordered_map<std::string, ArenaRef*> g_arenas;  // arena name -> entry
int g_live_listeners = 0;  // under g_arena_mu; see rt_xfer_serve/stop

void DetachIfUnusedLocked(ArenaRef* r) {
  if (!r->cached && r->users == 0) {
    rt_arena_detach(r->handle);
    delete r;
  }
}

void UncacheLocked(const std::string& name, ArenaRef* r) {
  auto it = g_arenas.find(name);
  if (it != g_arenas.end() && it->second == r) g_arenas.erase(it);
  r->cached = false;
  DetachIfUnusedLocked(r);
}

bool NameLinked(const std::string& name) {
  int fd = shm_open(name.c_str(), O_RDONLY, 0);
  if (fd < 0) return errno != ENOENT;
  close(fd);
  return true;
}

// The arena's entry with one more user, or nullptr if it cannot be
// attached (or was unlinked since it was cached). Pair with ReleaseArena.
ArenaRef* AcquireArena(const std::string& name) {
  std::lock_guard<std::mutex> lock(g_arena_mu);
  auto it = g_arenas.find(name);
  if (it != g_arenas.end()) {
    ArenaRef* r = it->second;
    if (NameLinked(name)) {
      r->users++;
      return r;
    }
    UncacheLocked(name, r);
    return nullptr;
  }
  int h = rt_arena_attach(name.c_str());
  if (h < 0) return nullptr;
  ArenaRef* r = new ArenaRef{h, 1, true};
  g_arenas.emplace(name, r);
  return r;
}

void ReleaseArena(const std::string& name, ArenaRef* r) {
  std::lock_guard<std::mutex> lock(g_arena_mu);
  r->users--;
  if (g_live_listeners == 0 && r->cached) {
    // served from the queue after the last listener stopped
    UncacheLocked(name, r);
  } else {
    DetachIfUnusedLocked(r);
  }
}

void UncacheAllLocked() {
  while (!g_arenas.empty()) {
    auto it = g_arenas.begin();
    UncacheLocked(it->first, it->second);
  }
}

bool ReadName(int fd, std::string* out) {
  uint16_t len;
  if (!ReadFull(fd, &len, 2)) return false;
  if (len > 4096) return false;
  out->resize(len);
  return len == 0 || ReadFull(fd, out->data(), len);
}

void ServeSegment(int fd, const std::string& name) {
  std::string path = name;
  int sfd = shm_open(path.c_str(), O_RDONLY, 0);
  if (sfd < 0) {
    SendResponse(fd, 1, nullptr, 0);
    return;
  }
  struct stat st;
  if (fstat(sfd, &st) != 0 || st.st_size <= 0) {
    close(sfd);
    SendResponse(fd, 2, nullptr, 0);
    return;
  }
  void* base = mmap(nullptr, st.st_size, PROT_READ, MAP_SHARED, sfd, 0);
  close(sfd);
  if (base == MAP_FAILED) {
    SendResponse(fd, 2, nullptr, 0);
    return;
  }
  SendResponse(fd, 0, base, static_cast<uint64_t>(st.st_size));
  munmap(base, st.st_size);
}

void ServeArenaObject(int fd, const std::string& arena,
                      const std::string& hex) {
  ArenaRef* r = AcquireArena(arena);
  if (r == nullptr) {
    SendResponse(fd, 1, nullptr, 0);
    return;
  }
  int h = r->handle;
  uint64_t size = 0;
  int64_t off = rt_obj_get(h, hex.c_str(), &size);
  if (off < 0) {
    SendResponse(fd, 1, nullptr, 0);
  } else {
    const char* base = static_cast<const char*>(rt_arena_base(h)) + off;
    SendResponse(fd, 0, base, size);
    rt_obj_release(h, hex.c_str());
  }
  ReleaseArena(arena, r);
}

void HandleConn(int fd) {
  uint32_t magic;
  uint8_t kind;
  std::string name1, name2;
  SetIoTimeout(fd, 120000);  // a wedged peer must not pin a thread forever
  std::string token;
  if (ReadFull(fd, &magic, 4) && magic == kMagic && ReadFull(fd, &kind, 1) &&
      ReadName(fd, &name1) && ReadName(fd, &name2) && ReadName(fd, &token)) {
    if (!expected_token().empty() && token != expected_token()) {
      // wrong/missing token: close without a response (an attacker learns
      // nothing about which objects exist)
    } else if (!AllowedName(name1)) {
      SendResponse(fd, 2, nullptr, 0);
    } else if (kind == 0) {
      ServeSegment(fd, name1);
    } else if (kind == 1) {
      ServeArenaObject(fd, name1, name2);
    } else {
      SendResponse(fd, 2, nullptr, 0);
    }
  }
  close(fd);
}

// Fixed worker pool draining a bounded fd queue. Transfers are bulk (the
// blocking write loop IS the right IO model for GB/s payloads); the pool
// bounds thread count and removes per-connection thread churn — a 250-node
// fetch storm costs queueing, not 250 thread spawns. Queue overflow sheds
// load by closing the connection: the fetcher falls back to the RPC pull
// path, which is the correct behavior under overload.
struct ServePool {
  std::mutex mu;
  std::condition_variable cv;
  std::deque<int> fds;
  uint64_t epoch = 0;  // bumped on stop: workers of older epochs drain+exit
  unsigned workers = 0;
};

constexpr size_t kServeQueueMax = 256;

ServePool& pool() {
  // Intentionally leaked: pool workers block on the condvar, and a static
  // ServePool's destructor would run pthread_cond_destroy at process exit,
  // which blocks until all waiters wake — wedging interpreter shutdown for
  // any process that ever served a transfer. Detached workers die with the
  // process; the kernel reclaims the memory.
  static ServePool* p = new ServePool();
  return *p;
}

void PoolWorker(uint64_t my_epoch) {
  ServePool& p = pool();
  for (;;) {
    int fd;
    {
      std::unique_lock<std::mutex> lock(p.mu);
      p.cv.wait(lock, [&] {
        return p.epoch != my_epoch || !p.fds.empty();
      });
      if (p.fds.empty()) return;  // epoch advanced and nothing queued
      fd = p.fds.front();
      p.fds.pop_front();
    }
    HandleConn(fd);
  }
}

void EnsurePoolStarted() {
  ServePool& p = pool();
  std::lock_guard<std::mutex> lock(p.mu);
  if (p.workers > 0) return;
  unsigned hw = std::thread::hardware_concurrency();
  unsigned n = hw > 1 ? (hw * 2 < 32 ? hw * 2 : 32) : 2;
  for (unsigned i = 0; i < n; i++) {
    std::thread(PoolWorker, p.epoch).detach();
  }
  p.workers = n;
}

void StopPoolIfIdleListeners() {
  // Called with g_serve_mu held and g_listeners empty: quiesce the worker
  // pool (workers drain the queue, then exit); a later serve restarts it.
  ServePool& p = pool();
  {
    std::lock_guard<std::mutex> lock(p.mu);
    p.epoch++;
    p.workers = 0;
  }
  p.cv.notify_all();
}

void AcceptLoop(int listen_fd) {
  for (;;) {
    int fd = accept(listen_fd, nullptr, nullptr);
    if (fd < 0) {
      if (errno == EINTR) continue;
      return;  // listen socket closed
    }
    int one = 1;
    setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
    ServePool& p = pool();
    {
      std::lock_guard<std::mutex> lock(p.mu);
      if (p.fds.size() >= kServeQueueMax) {
        close(fd);  // shed load; fetcher falls back to the RPC pull
        continue;
      }
      p.fds.push_back(fd);
    }
    p.cv.notify_one();
  }
}

int Connect(const char* host, int port, int timeout_ms) {
  int fd = socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) return -errno;
  struct sockaddr_in addr;
  std::memset(&addr, 0, sizeof(addr));
  addr.sin_family = AF_INET;
  addr.sin_port = htons(static_cast<uint16_t>(port));
  if (inet_pton(AF_INET, host, &addr.sin_addr) != 1) {
    close(fd);
    return -EINVAL;
  }
  if (timeout_ms > 0) {
    // bounded connect: non-blocking + poll, then back to blocking IO with
    // SO_RCVTIMEO/SO_SNDTIMEO (get(timeout=...) must not hang on a wedged
    // owner host)
    int flags = fcntl(fd, F_GETFL, 0);
    fcntl(fd, F_SETFL, flags | O_NONBLOCK);
    int rc = connect(fd, reinterpret_cast<struct sockaddr*>(&addr),
                     sizeof(addr));
    if (rc != 0 && errno == EINPROGRESS) {
      // poll, not select: long-lived workers can hold >FD_SETSIZE
      // descriptors, where FD_SET is a stack overflow
      struct pollfd pfd;
      pfd.fd = fd;
      pfd.events = POLLOUT;
      rc = poll(&pfd, 1, timeout_ms);
      if (rc <= 0) {
        close(fd);
        return rc == 0 ? -ETIMEDOUT : -errno;
      }
      int err = 0;
      socklen_t elen = sizeof(err);
      getsockopt(fd, SOL_SOCKET, SO_ERROR, &err, &elen);
      if (err != 0) {
        close(fd);
        return -err;
      }
    } else if (rc != 0) {
      int e = errno;
      close(fd);
      return -e;
    }
    fcntl(fd, F_SETFL, flags);
    SetIoTimeout(fd, timeout_ms);
  } else if (connect(fd, reinterpret_cast<struct sockaddr*>(&addr),
                     sizeof(addr)) != 0) {
    int e = errno;
    close(fd);
    return -e;
  }
  int one = 1;
  setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  return fd;
}

bool SendName(int fd, const std::string& s) {
  uint16_t len = static_cast<uint16_t>(s.size());
  return WriteFull(fd, &len, 2) && (len == 0 || WriteFull(fd, s.data(), len));
}

}  // namespace

namespace {
// Live listen sockets by bound port (for rt_xfer_stop).
std::mutex g_serve_mu;
std::unordered_map<int, int> g_listeners;  // port -> listen fd
}  // namespace

extern "C" {

// Start the transfer server on host:port (port 0 = ephemeral). Returns the
// bound port, or -errno. The accept thread runs until rt_xfer_stop.
int rt_xfer_serve(const char* host, int port) {
  int fd = socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) return -errno;
  int one = 1;
  setsockopt(fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  struct sockaddr_in addr;
  std::memset(&addr, 0, sizeof(addr));
  addr.sin_family = AF_INET;
  addr.sin_port = htons(static_cast<uint16_t>(port));
  if (inet_pton(AF_INET, host, &addr.sin_addr) != 1) {
    close(fd);
    return -EINVAL;
  }
  if (bind(fd, reinterpret_cast<struct sockaddr*>(&addr), sizeof(addr)) != 0 ||
      listen(fd, 64) != 0) {
    int e = errno;
    close(fd);
    return -e;
  }
  socklen_t alen = sizeof(addr);
  if (getsockname(fd, reinterpret_cast<struct sockaddr*>(&addr), &alen) != 0) {
    int e = errno;
    close(fd);
    return -e;
  }
  int bound = ntohs(addr.sin_port);
  {
    std::lock_guard<std::mutex> lock(g_serve_mu);
    g_listeners[bound] = fd;
  }
  {
    std::lock_guard<std::mutex> lock(g_arena_mu);
    g_live_listeners++;
  }
  EnsurePoolStarted();
  std::thread(AcceptLoop, fd).detach();
  return bound;
}

// Stop a server started by rt_xfer_serve: closing the listen socket makes
// the accept loop exit (in-flight transfers finish on their own threads).
// A worker shutdown must not leave a listener serving this host's shm, nor
// an arena mapped: the last stop detaches every cached arena (each once
// its in-flight transfers are done).
int rt_xfer_stop(int port) {
  int fd = -1;
  bool last = false;
  {
    std::lock_guard<std::mutex> lock(g_serve_mu);
    auto it = g_listeners.find(port);
    if (it == g_listeners.end()) return -ENOENT;
    fd = it->second;
    g_listeners.erase(it);
    last = g_listeners.empty();
  }
  shutdown(fd, SHUT_RDWR);
  close(fd);
  {
    std::lock_guard<std::mutex> lock(g_arena_mu);
    g_live_listeners--;
    if (g_live_listeners == 0) UncacheAllLocked();
  }
  if (last) StopPoolIfIdleListeners();
  return 0;
}

// Fetch an object from a remote transfer server into local shm segment
// `dest_name`. kind 0: name1 = segment name; kind 1: name1 = arena name,
// name2 = object hex. The payload lands in a temp segment and is published
// to `dest_name` by atomic rename, so a segment under its final name is
// always complete — concurrent fetchers that find it existing may read it
// immediately. timeout_ms <= 0 means no IO bound. Returns the payload
// size, -EEXIST if a complete copy already exists locally, or -errno.
void rt_xfer_set_token(const char* token) {
  std::lock_guard<std::mutex> lk(g_token_mu);
  g_token = token ? token : "";
}

int64_t rt_xfer_fetch(const char* host, int port, int kind, const char* name1,
                      const char* name2, const char* dest_name,
                      int timeout_ms) {
  int pre = shm_open(dest_name, O_RDONLY, 0);
  if (pre >= 0) {
    close(pre);
    return -EEXIST;  // complete by the rename-publication invariant
  }
  int fd = Connect(host, port, timeout_ms);
  if (fd < 0) return fd;
  uint8_t k = static_cast<uint8_t>(kind);
  if (!WriteFull(fd, &kMagic, 4) || !WriteFull(fd, &k, 1) ||
      !SendName(fd, name1) || !SendName(fd, name2 ? name2 : "") ||
      !SendName(fd, expected_token())) {
    close(fd);
    return -EIO;
  }
  uint8_t status;
  uint64_t len;
  if (!ReadFull(fd, &status, 1) || !ReadFull(fd, &len, 8)) {
    close(fd);
    return -EIO;
  }
  if (status != 0) {
    close(fd);
    return status == 1 ? -ENOENT : -EIO;
  }
  // The temp name must be unique per *call*, not just per process: two
  // threads fetching the same object would collide on O_EXCL and the loser's
  // -EEXIST would be indistinguishable from "published copy exists" — it
  // would report completion while the segment is still mid-write.
  static std::atomic<uint64_t> fetch_seq{0};
  std::string tmp = std::string(dest_name) + ".t" +
                    std::to_string(getpid()) + "." +
                    std::to_string(fetch_seq.fetch_add(1));
  int dfd = shm_open(tmp.c_str(), O_RDWR | O_CREAT | O_EXCL, 0600);
  if (dfd < 0) {
    int e = errno;
    close(fd);
    return -e;
  }
  int64_t result = -EIO;
  void* base = MAP_FAILED;
  if (ftruncate(dfd, static_cast<off_t>(len ? len : 1)) == 0) {
    base = mmap(nullptr, len ? len : 1, PROT_WRITE, MAP_SHARED, dfd, 0);
  }
  close(dfd);
  if (base != MAP_FAILED) {
    bool ok = len == 0 || ReadFull(fd, base, len);
    munmap(base, len ? len : 1);
    if (ok) {
      // Atomic publication (POSIX shm lives in /dev/shm on Linux): readers
      // can never observe a half-written segment under the final name.
      if (rename(ShmPath(tmp).c_str(), ShmPath(dest_name).c_str()) == 0) {
        result = static_cast<int64_t>(len);
      } else {
        result = -errno;
      }
    }
  }
  close(fd);
  if (result < 0) shm_unlink(tmp.c_str());
  return result;
}

}  // extern "C"
