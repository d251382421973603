// The fabric's same-host tiers: the BULK conn and the SHM ring.
//
// The port's copy of the bulk and shm half of the reference datapath
// (brpc_tpu's native/fabric.cpp), with its symbols under the port's
// prefix (brpc_tpu_torch_fab_*, brpc_tpu_torch_shm_*).  Host C++, not a
// kernel.  Build: g++ -O2 -fPIC -shared -pthread -fvisibility=hidden
// -Wl,-Bsymbolic (brpc_tpu_torch/butil/native.py does it at first use):
// hidden visibility keeps every registry of this library its own, even in
// a process that also loaded the reference's datapath.
//
// The bulk conn mirrors the RDMA data path (rdma_endpoint.cpp:771,926):
// payload bytes move OUT-OF-BAND from the control channel over one
// dedicated connection per fabric socket pair (an abstract AF_UNIX socket
// between processes of one host, TCP otherwise), as uuid-tagged frames
//
//     <u64 uuid><u64 len><len payload bytes>        (little-endian)
//
// * Sender custody: brpc_tpu_torch_fab_send writes synchronously (ctypes
//   drops the GIL for the duration): when it returns, the kernel owns a
//   copy and the caller may reuse its buffer.
// * Receiver: a per-connection reader thread parks frames in a uuid-keyed
//   map; Python claims each with brpc_tpu_torch_fab_recv (blocking,
//   timed) when the control-channel descriptor for that uuid arrives:
//   the two channels race, so the claim by uuid tolerates either order.
// * Memory bound: parked frames are bounded by the fabric socket's credit
//   window (attachments) or by each stream's own window (stream frames).
//
// Setup handshake: the connector sends <u32 keylen><key> right after the
// connect; the acceptor parks the connection under that key and
// brpc_tpu_torch_fab_accept(key) claims it.  The control channel's HELLO
// carries the same key, binding the two planes (the GID/QPN exchange of
// rdma_endpoint.h:37).
//
// The shm ring (below, namespace nshm): one mmap'd /dev/shm segment per
// socket pair holding an SPSC ring per direction (or N striped pairs), a
// sender copy into shared memory, zero-copy claims retired on release
// (consume-to-release credit) and futex doorbells.  Its layout is the
// reference's byte for byte, so either library can attach to a segment
// the other created.
#include "tsan_compat.h"

#include <arpa/inet.h>
#include <fcntl.h>
#include <netdb.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <poll.h>
#include <sys/mman.h>
#include <sys/socket.h>
#include <sys/stat.h>
#include <sys/types.h>
#include <sys/uio.h>
#include <sys/un.h>
#include <unistd.h>
#ifdef __linux__
#include <linux/futex.h>
#include <sys/syscall.h>
#endif

#include <deque>

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <chrono>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

#include "flat_map.h"

namespace nfab {

// Frames larger than this are a protocol error (fat-finger guard; the
// Python plane chunks at the credit window, far below this).
static constexpr uint64_t kMaxFrame = 1ull << 34;  // 16 GB

static void set_nodelay(int fd) {
  int one = 1;
  setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
}

// Thread-safe IPv4 resolution (gethostbyname returns a static buffer —
// two threads dialing different hosts could read each other's result).
static bool resolve_ipv4(const char* host, struct in_addr* out) {
  if (::inet_pton(AF_INET, host, out) == 1) return true;
  struct addrinfo hints{};
  hints.ai_family = AF_INET;
  hints.ai_socktype = SOCK_STREAM;
  struct addrinfo* res = nullptr;
  if (::getaddrinfo(host, nullptr, &hints, &res) != 0 || res == nullptr)
    return false;
  *out = ((struct sockaddr_in*)res->ai_addr)->sin_addr;
  ::freeaddrinfo(res);
  return true;
}

// Explicit 768 KB socket buffers on the UNIX-domain bulk plane, both
// directions.  UDS buffers do NOT autotune (they sit at
// net.core.*mem_default, ~208 KB here), so a 256 KB streaming frame
// could never leave the sender's writev without the receiver draining
// in lock-step — two forced context switches per frame on a shared
// core (measured 494 MB/s on the stream tier).  768 KB decouples
// writer from reader (682-715 MB/s) while keeping the in-flight
// cold-data footprint small enough not to regress the 8 MB-chunk tier
// (1.89-1.97 GB/s vs 1.72 autotuned; 8 MB explicit buffers measured
// ~10% SLOWER there — the cache-cold-slab effect the TCP plane hit,
// see rpc.cpp set_nodelay).  TCP conns (the cross-host path) keep
// kernel autotuning: a fixed SO_RCVBUF would cap the receive window at
// ~rcvbuf/RTT, a regression on any link whose BDP exceeds it (review
// finding).
static void set_bulk_buffers(int fd, bool uds) {
  if (!uds) return;
  int sz = 768 * 1024;
  setsockopt(fd, SOL_SOCKET, SO_SNDBUF, &sz, sizeof(sz));
  setsockopt(fd, SOL_SOCKET, SO_RCVBUF, &sz, sizeof(sz));
}

static bool read_full(int fd, uint8_t* p, uint64_t n) {
  while (n > 0) {
    ssize_t r = ::read(fd, p, n);
    if (r > 0) {
      p += r;
      n -= (uint64_t)r;
    } else if (r < 0 && (errno == EINTR)) {
      continue;
    } else {
      return false;  // EOF or hard error
    }
  }
  return true;
}

static bool write_full_iov(int fd, struct iovec* iov, int iovcnt) {
  // writev rejects more than IOV_MAX segments per call (EINVAL) — the
  // gather send path can exceed it with a many-block IOBuf frame
  static constexpr int kIovBatch = 1024;  // <= IOV_MAX everywhere
  int cur = 0;
  while (cur < iovcnt) {
    ssize_t w = ::writev(fd, iov + cur, std::min(iovcnt - cur, kIovBatch));
    if (w < 0) {
      if (errno == EINTR) continue;
      return false;
    }
    size_t n = (size_t)w;
    while (cur < iovcnt && n >= iov[cur].iov_len) {
      n -= iov[cur].iov_len;
      ++cur;
    }
    if (cur < iovcnt && n > 0) {
      iov[cur].iov_base = (char*)iov[cur].iov_base + n;
      iov[cur].iov_len -= n;
    }
  }
  return true;
}

struct Frame {
  uint8_t* data;
  uint64_t len;
};

struct BulkConn {
  int fd = -1;
  std::mutex wmu;  // serializes writers (frames must not interleave)
  std::mutex mu;   // guards frames / dead
  std::condition_variable cv;
  nbase::FlatMap64<Frame> frames;   // parked bulk frames by uuid
  bool dead = false;
  std::thread reader;
  std::atomic<uint64_t> bytes_in{0}, bytes_out{0};
  // per-pair registry tag: the peer process id this conn serves, set by
  // the owning FabricSocket at attach (-1 = untagged).  Lets the pod
  // observability layer aggregate the N-member fabric's planes by pair
  // without walking Python socket state.
  std::atomic<int32_t> peer{-1};
  // ---- deterministic chaos knobs (brpc_tpu_torch_fab_chaos) ----
  // payload-byte watermark after which the NEXT write severs the conn
  // mid-writev (truncated frame on the wire); -1 = off
  std::atomic<int64_t> chaos_sever_after{-1};
  // drop the next N fully-received frames (bytes vanish before parking)
  std::atomic<int64_t> chaos_drop_frames{0};
  // park each received frame only after this many milliseconds
  std::atomic<int64_t> chaos_delay_park_ms{0};
  // Receive-buffer pool: steady-state bulk traffic is uniform-sized
  // multi-MB frames, and a fresh malloc per frame costs ~2k page faults
  // per 8 MB — measurable against the send pump on a shared core.
  // Entries are exact-size (read_loop mallocs exactly frame-len, so a
  // released buffer's len IS its capacity).
  static constexpr size_t kPoolMax = 6;
  std::mutex pool_mu;
  std::vector<Frame> pool;

  uint8_t* take_buf(uint64_t need) {
    {
      std::lock_guard<std::mutex> g(pool_mu);
      for (size_t i = 0; i < pool.size(); ++i) {
        if (pool[i].len == need) {
          uint8_t* p = pool[i].data;
          pool.erase(pool.begin() + i);
          return p;
        }
      }
    }
    return (uint8_t*)malloc(need ? need : 1);
  }

  // false -> caller should free() instead
  bool give_buf(uint8_t* p, uint64_t cap) {
    std::lock_guard<std::mutex> g(pool_mu);
    if (dead_pool || pool.size() >= kPoolMax) return false;
    pool.push_back(Frame{p, cap});
    return true;
  }

  bool dead_pool = false;  // guarded by pool_mu: no re-pooling after close

  void drain_pool() {
    std::lock_guard<std::mutex> g(pool_mu);
    dead_pool = true;
    for (auto& f : pool) free(f.data);
    pool.clear();
  }

  ~BulkConn() {
    // destructible without an explicit close (process-exit teardown of
    // the handle registries): wake and join the reader first — a
    // joinable std::thread reaching its destructor aborts the process
    if (reader.joinable()) {
      ::shutdown(fd, SHUT_RDWR);
      reader.join();
    }
    if (fd >= 0) ::close(fd);
    frames.for_each([](uint64_t, Frame& f) { free(f.data); });
    drain_pool();
  }

  void start_reader() {
    reader = std::thread([this] { read_loop(); });
  }

  void read_loop() {
    uint8_t hdr[16];
    for (;;) {
      if (!read_full(fd, hdr, 16)) break;
      uint64_t uuid, len;
      memcpy(&uuid, hdr, 8);
      memcpy(&len, hdr + 8, 8);
      if (len > kMaxFrame) break;
      uint8_t* buf = take_buf(len);
      if (buf == nullptr) break;
      if (len && !read_full(fd, buf, len)) {
        free(buf);
        break;
      }
      bytes_in.fetch_add(len, std::memory_order_relaxed);
      if (chaos_drop_frames.load(std::memory_order_relaxed) > 0) {
        // chaos: the frame vanishes after full receipt — its descriptor
        // will arrive on the control channel but the claim never finds it
        chaos_drop_frames.fetch_sub(1, std::memory_order_relaxed);
        free(buf);
        continue;
      }
      int64_t delay = chaos_delay_park_ms.load(std::memory_order_relaxed);
      if (delay > 0)
        std::this_thread::sleep_for(std::chrono::milliseconds(delay));
      std::lock_guard<std::mutex> g(mu);
      // duplicate uuid would leak the old buffer — replace defensively
      Frame* old = frames.seek(uuid);
      if (old != nullptr) free(old->data);
      frames[uuid] = Frame{buf, len};
      cv.notify_all();
    }
    std::lock_guard<std::mutex> g(mu);
    dead = true;
    cv.notify_all();
  }

  // Chaos sever-mid-write: when the configured payload-byte watermark
  // lands inside this frame, write the header plus only the allowed
  // prefix, then sever — the peer's reader sees a truncated frame and
  // marks the conn dead, exactly the kernel-reset shape.  Caller holds
  // wmu.  Returns true when the chaos path consumed the write.
  bool chaos_truncate_write(uint64_t uuid, uint64_t len,
                            const struct iovec* payload, int pcount) {
    int64_t watermark = chaos_sever_after.load(std::memory_order_relaxed);
    if (watermark < 0) return false;
    int64_t out = (int64_t)bytes_out.load(std::memory_order_relaxed);
    uint64_t allowed =
        out >= watermark ? 0 : (uint64_t)(watermark - out);
    if (allowed >= len) return false;  // frame fits under the watermark
    uint8_t hdr[16];
    memcpy(hdr, &uuid, 8);
    memcpy(hdr + 8, &len, 8);
    std::vector<struct iovec> iov;
    iov.push_back({hdr, 16});
    uint64_t left = allowed;
    for (int i = 0; i < pcount && left > 0; ++i) {
      size_t take = std::min<uint64_t>(left, payload[i].iov_len);
      if (take) iov.push_back({payload[i].iov_base, take});
      left -= take;
    }
    write_full_iov(fd, iov.data(), (int)iov.size());
    ::shutdown(fd, SHUT_RDWR);
    std::lock_guard<std::mutex> g2(mu);
    dead = true;
    cv.notify_all();
    return true;
  }

  // 0 ok; -1 connection dead/failed.
  int send(uint64_t uuid, const uint8_t* data, uint64_t len) {
    uint8_t hdr[16];
    memcpy(hdr, &uuid, 8);
    memcpy(hdr + 8, &len, 8);
    struct iovec iov[2] = {{hdr, 16}, {(void*)data, (size_t)len}};
    std::lock_guard<std::mutex> g(wmu);
    {
      std::lock_guard<std::mutex> g2(mu);
      if (dead) return -1;
    }
    if (chaos_truncate_write(uuid, len, iov + 1, len ? 1 : 0)) return -1;
    if (!write_full_iov(fd, iov, len ? 2 : 1)) {
      std::lock_guard<std::mutex> g2(mu);
      dead = true;
      cv.notify_all();
      return -1;
    }
    bytes_out.fetch_add(len, std::memory_order_relaxed);
    return 0;
  }

  // Gather variant of send(): one uuid frame assembled from n segments
  // without a caller-side join — the streaming fast path hands the
  // payload's IOBuf blocks over as-is (zero-copy all the way to the
  // kernel).  Same custody contract as send().
  int sendv(uint64_t uuid, const uint8_t* const* ptrs, const uint64_t* lens,
            int n) {
    uint64_t total = 0;
    for (int i = 0; i < n; ++i) total += lens[i];
    if (total > kMaxFrame) return -1;
    uint8_t hdr[16];
    memcpy(hdr, &uuid, 8);
    memcpy(hdr + 8, &total, 8);
    std::vector<struct iovec> iov;
    iov.reserve((size_t)n + 1);
    iov.push_back({hdr, 16});
    for (int i = 0; i < n; ++i)
      if (lens[i]) iov.push_back({(void*)ptrs[i], (size_t)lens[i]});
    std::lock_guard<std::mutex> g(wmu);
    {
      std::lock_guard<std::mutex> g2(mu);
      if (dead) return -1;
    }
    if (chaos_truncate_write(uuid, total, iov.data() + 1,
                             (int)iov.size() - 1))
      return -1;
    if (!write_full_iov(fd, iov.data(), (int)iov.size())) {
      std::lock_guard<std::mutex> g2(mu);
      dead = true;
      cv.notify_all();
      return -1;
    }
    bytes_out.fetch_add(total, std::memory_order_relaxed);
    return 0;
  }

  // 0 ok (ownership of *out transfers to caller — free with
  // free()); -1 timeout; -2 connection dead and the frame
  // never arrived.  A frame that arrived BEFORE death is still claimable
  // after it (the control descriptor may lag the bulk bytes).
  int recv(uint64_t uuid, int64_t timeout_us, uint8_t** out,
           uint64_t* out_len) {
    std::unique_lock<std::mutex> lk(mu);
    auto deadline = std::chrono::steady_clock::now() +
                    std::chrono::microseconds(timeout_us);
    for (;;) {
      Frame f;
      if (frames.take(uuid, &f)) {
        *out = f.data;
        *out_len = f.len;
        return 0;
      }
      if (dead) return -2;
      if (timeout_us >= 0) {
        if (nbase::cv_wait_until(cv, lk, deadline)
                == std::cv_status::timeout &&
            frames.seek(uuid) == nullptr && !dead)
          return -1;
      } else {
        cv.wait(lk);
      }
    }
  }

  void shutdown_fd() {
    ::shutdown(fd, SHUT_RDWR);
  }

  void close_join() {
    shutdown_fd();   // unblocks the reader AND any writer parked in writev
    if (reader.joinable()) reader.join();
    {
      // exclude an in-flight send(): closing the fd while a writer that
      // already passed its dead-check is about to writev would let the
      // kernel recycle the fd number under it — the
      // writer would then corrupt an unrelated connection's stream
      std::lock_guard<std::mutex> g(wmu);
      std::lock_guard<std::mutex> g2(mu);
      dead = true;
      ::close(fd);
      fd = -1;
    }
    cv.notify_all();
    drain_pool();
  }
};

struct Listener {
  int fd = -1;    // TCP (cross-host peers)
  int ufd = -1;   // abstract AF_UNIX (same-host peers: ~3x the loopback
                  // TCP bandwidth on this class of host — 8 vs 2.5 GB/s
                  // measured — because the frames skip the IP stack)
  int port = 0;
  std::string uds_name;  // without the leading NUL ('@' convention)
  std::thread acceptor, uacceptor;

  ~Listener() {
    if (acceptor.joinable() || uacceptor.joinable()) stop();
  }
  std::mutex mu;
  std::condition_variable cv;
  std::unordered_map<std::string, std::shared_ptr<BulkConn>> pending;
  bool stopped = false;
  // set first by stop(): the acceptors poll for it, since a shutdown() of
  // a listening socket does not wake a blocked accept() on every kernel
  // (some kernels leave it parked forever)
  std::atomic<bool> closing{false};
  // chaos: refuse the next N key handshakes (the parked conn is closed
  // right after its binding header, so the claim never finds it)
  std::atomic<int64_t> chaos_refuse{0};

  void accept_loop(int afd, bool tcp) {
    for (;;) {
      if (closing.load(std::memory_order_acquire)) break;
      struct pollfd pfd{afd, POLLIN, 0};
      int pr = ::poll(&pfd, 1, 200);
      if (pr < 0 && errno != EINTR) break;
      if (pr <= 0) continue;
      int cfd = ::accept(afd, nullptr, nullptr);
      if (cfd < 0) {
        if (errno == EINTR || errno == EAGAIN) continue;
        break;  // listener closed
      }
      if (tcp) set_nodelay(cfd);
      set_bulk_buffers(cfd, !tcp);
      // key handshake with a bound (a wedged connector must not stall
      // the acceptor forever; fabric peers are trusted, so inline with
      // a 15 s receive timeout is enough)
      struct timeval tv{15, 0};
      setsockopt(cfd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));
      uint8_t klen_b[4];
      if (!read_full(cfd, klen_b, 4)) {
        ::close(cfd);
        continue;
      }
      uint32_t klen;
      memcpy(&klen, klen_b, 4);
      if (klen == 0 || klen > 4096) {
        ::close(cfd);
        continue;
      }
      std::string key(klen, '\0');
      if (!read_full(cfd, (uint8_t*)key.data(), klen)) {
        ::close(cfd);
        continue;
      }
      tv = {0, 0};  // back to blocking for the data phase
      setsockopt(cfd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));
      if (chaos_refuse.load(std::memory_order_relaxed) > 0) {
        chaos_refuse.fetch_sub(1, std::memory_order_relaxed);
        ::close(cfd);
        continue;
      }
      auto conn = std::make_shared<BulkConn>();
      conn->fd = cfd;
      conn->start_reader();
      std::lock_guard<std::mutex> g(mu);
      if (stopped) {
        conn->close_join();
        return;
      }
      pending[key] = conn;
      cv.notify_all();
    }
    // fall out on listener close; `stopped` is stop()'s to set — with
    // two acceptors (tcp + uds) one dying must not abort claims the
    // other could still satisfy
  }

  std::shared_ptr<BulkConn> claim(const std::string& key,
                                  int64_t timeout_us) {
    std::unique_lock<std::mutex> lk(mu);
    auto deadline = std::chrono::steady_clock::now() +
                    std::chrono::microseconds(timeout_us);
    for (;;) {
      auto it = pending.find(key);
      if (it != pending.end()) {
        auto c = it->second;
        pending.erase(it);
        return c;
      }
      if (stopped) return nullptr;
      if (nbase::cv_wait_until(cv, lk, deadline)
              == std::cv_status::timeout)
        return nullptr;
    }
  }

  void stop() {
    closing.store(true, std::memory_order_release);
    {
      std::lock_guard<std::mutex> g(mu);
      stopped = true;
      cv.notify_all();
    }
    ::shutdown(fd, SHUT_RDWR);
    if (ufd >= 0) ::shutdown(ufd, SHUT_RDWR);
    // the fds close only once no acceptor can touch them: a number
    // closed under a polling thread could be reused by another socket
    if (acceptor.joinable()) acceptor.join();
    if (uacceptor.joinable()) uacceptor.join();
    if (fd >= 0) ::close(fd);
    if (ufd >= 0) ::close(ufd);
    fd = ufd = -1;
    for (auto& kv : pending) kv.second->close_join();
    pending.clear();
  }
};

static std::mutex g_mu;
static std::atomic<uint64_t> g_next{1};
// Heap-allocated and intentionally never freed: running these maps'
// static destructors at process exit would destruct BulkConn/Listener
// objects — joining (or terminating on) reader/acceptor threads that
// may be mid-read — concurrently with whatever other threads exit()
// left running.  Leaking the registry sidesteps the static-destruction
// race entirely; the OS reclaims the fds and memory.
static auto& g_conns =
    *new std::unordered_map<uint64_t, std::shared_ptr<BulkConn>>();
static auto& g_listeners =
    *new std::unordered_map<uint64_t, std::shared_ptr<Listener>>();

static std::shared_ptr<BulkConn> find_conn(uint64_t h) {
  std::lock_guard<std::mutex> g(g_mu);
  auto it = g_conns.find(h);
  return it == g_conns.end() ? nullptr : it->second;
}

static std::shared_ptr<Listener> find_listener(uint64_t h) {
  std::lock_guard<std::mutex> g(g_mu);
  auto it = g_listeners.find(h);
  return it == g_listeners.end() ? nullptr : it->second;
}

// Sends the <u32 keylen><key> binding header on a fresh client fd and
// registers the connection; 0 on failure.
static uint64_t finish_connect(int fd, const char* key, bool uds) {
  uint32_t klen = (uint32_t)strlen(key);
  uint8_t hdr[4];
  memcpy(hdr, &klen, 4);
  struct iovec iov[2] = {{hdr, 4}, {(void*)key, klen}};
  if (!write_full_iov(fd, iov, 2)) {
    ::close(fd);
    return 0;
  }
  set_bulk_buffers(fd, uds);
  auto c = std::make_shared<BulkConn>();
  c->fd = fd;
  c->start_reader();
  uint64_t h = g_next.fetch_add(1);
  std::lock_guard<std::mutex> g(g_mu);
  g_conns[h] = c;
  return h;
}

}  // namespace nfab

// ======================================================================
// Same-host SHARED-MEMORY bulk tier (the third bulk plane).
//
// One mmap'd /dev/shm segment per fabric socket pair, created by the
// dialing side at handshake and attached by the acceptor, holding TWO
// single-producer single-consumer byte rings (one per direction).  The
// uuid-frame contract is identical to the socket bulk tier above —
// descriptors (uuid, len) ride the fabric CONTROL channel, the receiver
// claims by uuid — but the bytes cross with ONE copy (sender memcpy
// into the ring) and ZERO receiver copies: a claim returns a pointer
// straight into the mapped ring, wrapped by Python into a USER-block
// IOBuf, and the ring space is retired only when that buffer is
// RELEASED (consume-to-release credit: a slow consumer exerts
// backpressure on the producer through ring occupancy, never unbounded
// memory).  No syscalls move payload bytes; wakeups are futex
// doorbells on the shared ring header (FUTEX_WAIT/WAKE on the mapped
// words — the butex-over-shared-memory shape) with a timed-poll
// fallback where the futex syscall is unavailable, so neither side
// ever spins.
//
// Ring frame layout (all cursors and footprints multiples of 16, so a
// 16-byte wrap-marker header always fits in any end-of-ring remainder):
//
//     <u64 uuid><u64 len><len payload bytes><pad to 16>
//
// uuid == ~0 is the wrap marker: the producer could not fit the frame
// before the end of the ring, the remainder is dead space and the
// frame starts at offset 0.  Frames are CONTIGUOUS by construction —
// that is what makes the zero-copy claim possible.
//
// Publish protocol: the producer copies header+payload into the ring,
// then advances `tail` with a release store and rings the data
// doorbell; the consumer reads `tail` with acquire, so everything
// below it is fully written.  A producer that dies mid-copy simply
// never advances tail — the receiver never observes a torn frame (the
// crash-mid-slot shape; the control channel's death resolves the
// stranded claim).
//
// Teardown: either side stores `dead` and wakes every doorbell.  The
// mapping is unmapped only once every claimed-but-unreleased buffer
// has been returned (Python may hold zero-copy views past close), so
// a claim handed out is ALWAYS safe to read.
namespace nshm {

#ifdef __SSE2__
#include <emmintrin.h>
// Streaming (non-temporal) copy into the ring for LARGE payloads: the
// ring destination is cache-cold by construction (the write cursor
// cycles through tens of MB), so a plain memcpy pays a read-for-
// ownership on every destination line — ~1.5x the memory traffic.  NT
// stores skip the RFO and keep the producer's working set out of the
// cache the consumer is about to need.  Measured on this host:
// 11.7 -> 14.8 GB/s hot, and a larger relative win cold.
static constexpr uint64_t kNtMin = 256 * 1024;
static void ring_copy(uint8_t* dst, const uint8_t* src, uint64_t n,
                      bool big) {
  if (!big || n < 4096) {
    memcpy(dst, src, n);
    return;
  }
  while (((uintptr_t)dst & 15) && n) {
    *dst++ = *src++;
    --n;
  }
  uint64_t blocks = n / 64;
  for (uint64_t i = 0; i < blocks; ++i) {
    __m128i a = _mm_loadu_si128((const __m128i*)(src + 0));
    __m128i b = _mm_loadu_si128((const __m128i*)(src + 16));
    __m128i c = _mm_loadu_si128((const __m128i*)(src + 32));
    __m128i d = _mm_loadu_si128((const __m128i*)(src + 48));
    _mm_stream_si128((__m128i*)(dst + 0), a);
    _mm_stream_si128((__m128i*)(dst + 16), b);
    _mm_stream_si128((__m128i*)(dst + 32), c);
    _mm_stream_si128((__m128i*)(dst + 48), d);
    src += 64;
    dst += 64;
  }
  memcpy(dst + 0, src, n - blocks * 64);
}
// the publishing tail store is release-ordered, but NT stores are
// weakly ordered even against that — fence before publish
static void ring_copy_fence() { _mm_sfence(); }
#else
static constexpr uint64_t kNtMin = ~0ull;   // never: plain memcpy
static void ring_copy(uint8_t* dst, const uint8_t* src, uint64_t n,
                      bool) {
  memcpy(dst, src, n);
}
static void ring_copy_fence() {}
#endif

static constexpr uint32_t kShmMagic = 0x53484d31;   // "SHM1"
static constexpr uint32_t kShmVersion = 1;
static constexpr uint64_t kWrapUuid = ~0ull;
static constexpr uint64_t kAlign = 16;

static inline uint64_t pad16(uint64_t n) { return (n + 15) & ~15ull; }

// Futex doorbell on a shared-memory word.  The SHARED (non-PRIVATE)
// ops: the two waiters live in different processes.  Falls back to a
// bounded sleep when the syscall is unavailable (sandboxed kernels) —
// correctness never depends on the wakeup, only latency does, because
// every wait re-checks its condition on a timed loop.
static bool g_futex_ok_init = false;
static std::atomic<bool> g_futex_ok{true};

static void shm_futex_wake(std::atomic<uint32_t>* w) {
#ifdef SYS_futex
  if (g_futex_ok.load(std::memory_order_relaxed))
    syscall(SYS_futex, reinterpret_cast<uint32_t*>(w), FUTEX_WAKE,
            INT32_MAX, nullptr, nullptr, 0);
#else
  (void)w;
#endif
}

// Wait until *w != expect, a wake, or timeout_ns — whichever first.
static void shm_futex_wait(std::atomic<uint32_t>* w, uint32_t expect,
                           int64_t timeout_ns) {
#ifdef SYS_futex
  if (g_futex_ok.load(std::memory_order_relaxed)) {
    struct timespec ts;
    ts.tv_sec = timeout_ns / 1000000000ll;
    ts.tv_nsec = timeout_ns % 1000000000ll;
    long rc = syscall(SYS_futex, reinterpret_cast<uint32_t*>(w),
                      FUTEX_WAIT, expect, &ts, nullptr, 0);
    if (rc == -1 && (errno == ENOSYS || errno == EPERM)) {
      // kernel/sandbox without futex: demote ALL doorbells to polling
      g_futex_ok.store(false, std::memory_order_relaxed);
      (void)g_futex_ok_init;
    } else {
      return;            // woken, value changed, EINTR or timeout
    }
  }
#endif
  // poll fallback: bounded sleep, capped at 1ms so a lost wakeup costs
  // at most a millisecond of latency, never a spin
  struct timespec ts;
  int64_t ns = timeout_ns < 1000000ll ? timeout_ns : 1000000ll;
  if (ns < 1000) ns = 1000;
  ts.tv_sec = 0;
  ts.tv_nsec = ns;
  nanosleep(&ts, nullptr);
  (void)expect;
}

struct RingHdr {
  std::atomic<uint64_t> tail;       // bytes produced (monotonic cursor)
  std::atomic<uint64_t> head;       // bytes retired (monotonic cursor)
  std::atomic<uint32_t> data_seq;   // doorbell: producer rings on publish
  std::atomic<uint32_t> space_seq;  // doorbell: consumer rings on retire
};

struct SegHdr {
  std::atomic<uint32_t> magic;      // stored LAST by the creator (release)
  uint32_t version;
  uint64_t ring_bytes;              // per-direction data capacity
  std::atomic<uint32_t> dead;       // either side; futex-woken on both rings
  std::atomic<uint32_t> attached;
  RingHdr rings[2];                 // [0] creator->attacher, [1] reverse
};

// STRIPED segment header (v2): same leading fields as SegHdr
// (an attacher reads the shared 24-byte prefix to pick the layout by
// magic), then nstripes, then RingHdr[2 * nstripes] and the per-stripe
// data regions (stripe s: ring 2s = creator->attacher, 2s+1 reverse).
// ring_bytes stays PER-DIRECTION PER-STRIPE: a frame must fit one
// stripe's ring, exactly the v1 capacity contract, so the Python route
// screen is unchanged.  Created only when nstripes > 1 — a 1-stripe
// segment is ALWAYS the v1 layout, byte-identical to the single-ring layout.
static constexpr uint32_t kShmMagic2 = 0x53484d32;  // "SHM2"
struct SegHdrS {
  std::atomic<uint32_t> magic;
  uint32_t version;
  uint64_t ring_bytes;
  std::atomic<uint32_t> dead;
  std::atomic<uint32_t> attached;
  uint32_t nstripes;
  uint32_t _pad;
};
static inline uint64_t pad64(uint64_t n) { return (n + 63) & ~63ull; }
static inline uint64_t seg2_data_off(uint32_t nstripes) {
  return pad64(sizeof(SegHdrS) + 2ull * nstripes * sizeof(RingHdr));
}
static inline uint64_t seg2_total(uint64_t ring_bytes, uint32_t nstripes) {
  return seg2_data_off(nstripes) + 2ull * nstripes * ring_bytes;
}

static_assert(std::atomic<uint64_t>::is_always_lock_free,
              "shm rings need address-free atomics");

enum SlotState { kParked = 0, kClaimed = 1, kRetired = 2 };

struct ShmSlot {
  uint64_t start;        // absolute cursor at frame start
  uint64_t footprint;    // header + padded payload (or wrap remainder)
  uint8_t* data;         // payload pointer into the ring (null for wrap)
  uint64_t len;
  int state;
};

// One stripe = one SPSC ring pair + the receiver-side bookkeeping for
// it.  A v1 segment is exactly one stripe; a v2 segment holds N, each
// with its OWN tx/rx locks so concurrent Python sender/claimer threads
// on different stripes never serialize on a shared mutex — that is the
// multi-core win the striping exists for.  Health stays SEGMENT-wide
// (the shared dead word): one dead stripe degrades the whole plane
// in-frame, exactly like the single ring.
struct ShmStripe {
  RingHdr* tx = nullptr;
  uint8_t* txd = nullptr;          // tx ring data
  RingHdr* rx = nullptr;
  uint8_t* rxd = nullptr;
  // Process-local serialization: the ring itself is SPSC per direction;
  // these locks make the many-threaded Python side look like one
  // producer / one consumer PER STRIPE.
  std::mutex tx_mu;
  std::mutex rx_mu;                // guards scan/claim/retire bookkeeping
  uint64_t scan_cursor = 0;        // guarded by rx_mu
  std::deque<ShmSlot> slots;       // ring order; guarded by rx_mu
  nbase::FlatMap64<ShmSlot*> parked;                 // uuid -> slot (rx_mu)
  std::unordered_map<uintptr_t, ShmSlot*> claimed;   // ptr -> slot (rx_mu)
  std::atomic<uint64_t> bytes_in{0}, bytes_out{0};
  std::atomic<uint64_t> db_waits_send{0}, db_waits_recv{0};
};

struct ShmConn {
  void* base = nullptr;
  size_t map_len = 0;
  SegHdr* hdr = nullptr;           // v1 header (null on a v2 segment)
  SegHdrS* hdr2 = nullptr;         // v2 header (null on a v1 segment)
  std::atomic<uint32_t>* dead_w = nullptr;   // shared death word
  RingHdr* rings_base = nullptr;   // all 2*nstripes ring headers
  uint64_t ring_bytes = 0;         // per direction PER STRIPE
  uint32_t nstripes = 1;
  int side = 0;                    // 0 creator, 1 attacher
  std::vector<std::unique_ptr<ShmStripe>> stripes;
  std::atomic<bool> closed{false};
  std::atomic<uint64_t> bytes_in{0}, bytes_out{0};   // conn totals
  // chaos knobs (brpc_tpu_torch_shm_chaos)
  std::atomic<int64_t> chaos_sever_after{-1};  // tx payload-byte watermark
  std::atomic<int64_t> chaos_drop_frames{0};   // rx: drop next N at scan
  std::atomic<int64_t> chaos_kill_stripe{-1};  // next send on stripe dies

  ~ShmConn() {
    if (base != nullptr) ::munmap(base, map_len);
  }

  void bind(void* b, size_t len, int s) {
    base = b;
    map_len = len;
    hdr = reinterpret_cast<SegHdr*>(b);
    side = s;
    dead_w = &hdr->dead;
    rings_base = hdr->rings;
    ring_bytes = hdr->ring_bytes;
    nstripes = 1;
    uint8_t* d0 = reinterpret_cast<uint8_t*>(b) + sizeof(SegHdr);
    uint8_t* d1 = d0 + hdr->ring_bytes;
    auto st = std::make_unique<ShmStripe>();
    st->tx = &hdr->rings[s];
    st->txd = s == 0 ? d0 : d1;
    st->rx = &hdr->rings[1 - s];
    st->rxd = s == 0 ? d1 : d0;
    stripes.clear();
    stripes.push_back(std::move(st));
  }

  void bind2(void* b, size_t len, int s) {
    base = b;
    map_len = len;
    hdr2 = reinterpret_cast<SegHdrS*>(b);
    side = s;
    dead_w = &hdr2->dead;
    ring_bytes = hdr2->ring_bytes;
    nstripes = hdr2->nstripes;
    rings_base = reinterpret_cast<RingHdr*>(
        reinterpret_cast<uint8_t*>(b) + sizeof(SegHdrS));
    uint8_t* data0 = reinterpret_cast<uint8_t*>(b) +
                     seg2_data_off(nstripes);
    stripes.clear();
    for (uint32_t i = 0; i < nstripes; ++i) {
      auto st = std::make_unique<ShmStripe>();
      RingHdr* fwd = &rings_base[2 * i];       // creator -> attacher
      RingHdr* rev = &rings_base[2 * i + 1];
      uint8_t* fwd_d = data0 + (2ull * i) * ring_bytes;
      uint8_t* rev_d = data0 + (2ull * i + 1) * ring_bytes;
      st->tx = s == 0 ? fwd : rev;
      st->txd = s == 0 ? fwd_d : rev_d;
      st->rx = s == 0 ? rev : fwd;
      st->rxd = s == 0 ? rev_d : fwd_d;
      stripes.push_back(std::move(st));
    }
  }

  void mark_dead() {
    dead_w->store(1, std::memory_order_release);
    // wake EVERY doorbell, every stripe, both directions so parked
    // waiters re-check
    for (uint32_t r = 0; r < 2 * nstripes; ++r) {
      rings_base[r].data_seq.fetch_add(1, std::memory_order_release);
      rings_base[r].space_seq.fetch_add(1, std::memory_order_release);
      shm_futex_wake(&rings_base[r].data_seq);
      shm_futex_wake(&rings_base[r].space_seq);
    }
  }

  bool is_dead() const {
    return dead_w->load(std::memory_order_acquire) != 0;
  }

  ShmStripe* stripe(uint32_t i) {
    return i < stripes.size() ? stripes[i].get() : nullptr;
  }

  // 0 ok; -1 dead/severed/timeout (the caller degrades the shm plane);
  // -3 frame can never fit this ring (route elsewhere, plane healthy).
  int send(uint32_t stripe_idx, uint64_t uuid, const uint8_t* const* ptrs,
           const uint64_t* lens, int n, int64_t timeout_us) {
    ShmStripe* st = stripe(stripe_idx);
    if (st == nullptr) return -1;
    if (chaos_kill_stripe.load(std::memory_order_relaxed) ==
        (int64_t)stripe_idx) {
      // stripe-targeted chaos: THIS stripe's next send dies, and the
      // shared death word takes the whole plane with it — the
      // stripe-kill shape the tests pin (health is segment-wide)
      chaos_kill_stripe.store(-1, std::memory_order_relaxed);
      mark_dead();
      return -1;
    }
    uint64_t total = 0;
    for (int i = 0; i < n; ++i) total += lens[i];
    uint64_t ring = ring_bytes;
    uint64_t footprint = kAlign + pad16(total);
    if (footprint > ring) return -3;
    auto deadline = std::chrono::steady_clock::now() +
                    std::chrono::microseconds(timeout_us);
    std::lock_guard<std::mutex> g(st->tx_mu);
    // tail is ours (tx_mu held), so the placement — and with it the
    // wrap cost — is FIXED for the whole call: when the frame must
    // wrap, need = remainder + footprint, and if that exceeds the ring
    // it can NEVER fit at this position no matter how far the consumer
    // drains — return -3 (route elsewhere, plane healthy) instead of
    // parking out the full timeout and letting the caller declare a
    // healthy ring dead ( frames ≤ ring/2 never hit
    // this, which is what the Python route screen guarantees).
    uint64_t tail = st->tx->tail.load(std::memory_order_relaxed);
    uint64_t pos = tail % ring;
    uint64_t to_end = ring - pos;
    uint64_t need = footprint <= to_end ? footprint : to_end + footprint;
    if (need > ring) return -3;
    for (;;) {
      if (is_dead()) return -1;
      uint32_t seen = st->tx->space_seq.load(std::memory_order_acquire);
      uint64_t head = st->tx->head.load(std::memory_order_acquire);
      if (need <= ring - (tail - head)) break;
      if (std::chrono::steady_clock::now() >= deadline) return -1;
      st->db_waits_send.fetch_add(1, std::memory_order_relaxed);
      shm_futex_wait(&st->tx->space_seq, seen, 50 * 1000000ll);
    }
    // chaos: the configured payload-byte watermark lands inside this
    // frame — copy only the allowed prefix and die WITHOUT advancing
    // tail: the peer never sees the frame (the producer-crash-mid-slot
    // shape; its claim resolves through conn death, not a torn read)
    int64_t watermark = chaos_sever_after.load(std::memory_order_relaxed);
    if (watermark >= 0) {
      int64_t out = (int64_t)bytes_out.load(std::memory_order_relaxed);
      uint64_t allowed = out >= watermark ? 0 : (uint64_t)(watermark - out);
      if (allowed < total) {
        uint8_t* p = st->txd + (footprint <= to_end ? pos : 0);
        memcpy(p, &uuid, 8);
        memcpy(p + 8, &total, 8);
        uint64_t left = allowed;
        uint8_t* w = p + kAlign;
        for (int i = 0; i < n && left > 0; ++i) {
          uint64_t take = lens[i] < left ? lens[i] : left;
          memcpy(w, ptrs[i], take);
          w += take;
          left -= take;
        }
        mark_dead();
        return -1;
      }
    }
    if (footprint > to_end) {
      // wrap marker: remainder is dead space, frame starts at offset 0
      uint8_t* m = st->txd + pos;
      uint64_t wrap = kWrapUuid, zero = 0;
      memcpy(m, &wrap, 8);
      memcpy(m + 8, &zero, 8);
      pos = 0;
    }
    uint8_t* p = st->txd + pos;
    memcpy(p, &uuid, 8);
    memcpy(p + 8, &total, 8);
    uint8_t* w = p + kAlign;
    bool big = total >= kNtMin;
    for (int i = 0; i < n; ++i) {
      if (lens[i]) ring_copy(w, ptrs[i], lens[i], big);
      w += lens[i];
    }
    if (big) ring_copy_fence();
    st->tx->tail.store(tail + need, std::memory_order_release);
    st->tx->data_seq.fetch_add(1, std::memory_order_release);
    shm_futex_wake(&st->tx->data_seq);
    st->bytes_out.fetch_add(total, std::memory_order_relaxed);
    bytes_out.fetch_add(total, std::memory_order_relaxed);
    return 0;
  }

  // Caller holds st->rx_mu.  Parks every frame published since the last
  // scan; chaos-dropped frames retire immediately (bytes vanish — the
  // descriptor's claim can never be satisfied).
  void scan_locked(ShmStripe* st) {
    uint64_t ring = ring_bytes;
    uint64_t tail = st->rx->tail.load(std::memory_order_acquire);
    bool dropped = false;
    while (st->scan_cursor < tail) {
      uint64_t pos = st->scan_cursor % ring;
      uint8_t* p = st->rxd + pos;
      uint64_t uuid, len;
      memcpy(&uuid, p, 8);
      memcpy(&len, p + 8, 8);
      uint64_t footprint;
      if (uuid == kWrapUuid) {
        footprint = ring - pos;
        st->slots.push_back(ShmSlot{st->scan_cursor, footprint, nullptr,
                                    0, kRetired});
      } else {
        footprint = kAlign + pad16(len);
        if (chaos_drop_frames.load(std::memory_order_relaxed) > 0) {
          chaos_drop_frames.fetch_sub(1, std::memory_order_relaxed);
          st->slots.push_back(ShmSlot{st->scan_cursor, footprint, nullptr,
                                      len, kRetired});
          dropped = true;
        } else {
          st->slots.push_back(ShmSlot{st->scan_cursor, footprint,
                                      p + kAlign, len, kParked});
          ShmSlot* sp = &st->slots.back();
          // duplicate uuid: keep the NEWER frame claimable (mirror of
          // the socket tier's replace-defensively rule); the older one
          // can still retire through its slot record
          ShmSlot** old = st->parked.seek(uuid);
          if (old != nullptr) (*old)->state = kRetired;
          st->parked[uuid] = sp;
        }
      }
      st->scan_cursor += footprint;
    }
    if (dropped) retire_locked(st);
  }

  // Caller holds st->rx_mu: advance head over the retired prefix and
  // ring the space doorbell — the consume-to-release credit return.
  void retire_locked(ShmStripe* st) {
    bool advanced = false;
    while (!st->slots.empty() && st->slots.front().state == kRetired) {
      st->rx->head.fetch_add(st->slots.front().footprint,
                             std::memory_order_release);
      st->slots.pop_front();
      advanced = true;
    }
    if (advanced) {
      st->rx->space_seq.fetch_add(1, std::memory_order_release);
      shm_futex_wake(&st->rx->space_seq);
    }
  }

  // 0 ok (*out points INTO the ring; release with brpc_tpu_torch_shm_release
  // — ownership of the SLOT transfers, the memory stays ring-owned);
  // -1 timeout; -2 dead/closed and the frame never arrived.
  int recv(uint32_t stripe_idx, uint64_t uuid, int64_t timeout_us,
           uint8_t** out, uint64_t* out_len) {
    ShmStripe* st = stripe(stripe_idx);
    if (st == nullptr) return -2;
    auto deadline = std::chrono::steady_clock::now() +
                    std::chrono::microseconds(timeout_us);
    for (;;) {
      uint32_t seen;
      {
        std::lock_guard<std::mutex> g(st->rx_mu);
        if (closed.load(std::memory_order_acquire)) return -2;
        // doorbell value FIRST, then scan: a publish racing the scan
        // changes the word, so the wait below returns immediately
        seen = st->rx->data_seq.load(std::memory_order_acquire);
        scan_locked(st);
        ShmSlot** sp = st->parked.seek(uuid);
        if (sp != nullptr) {
          ShmSlot* s = *sp;
          st->parked.erase(uuid);
          s->state = kClaimed;
          st->claimed[(uintptr_t)s->data] = s;
          *out = s->data;
          *out_len = s->len;
          st->bytes_in.fetch_add(s->len, std::memory_order_relaxed);
          bytes_in.fetch_add(s->len, std::memory_order_relaxed);
          return 0;
        }
        if (is_dead()) return -2;
      }
      if (timeout_us >= 0 &&
          std::chrono::steady_clock::now() >= deadline)
        return -1;
      st->db_waits_recv.fetch_add(1, std::memory_order_relaxed);
      shm_futex_wait(&st->rx->data_seq, seen, 50 * 1000000ll);
    }
  }

  // True when the conn should be dropped from the registry (closed and
  // every claimed buffer returned — the deferred-unmap gate).  The
  // owning stripe is found by pointer (claims are infrequent relative
  // to bytes, and nstripes is tiny).
  // The stripe that owns an rx-ring pointer, derived from the mapping
  // layout (data regions are contiguous per ring) — release must not
  // scan stripes under their claim-hot rx_mu locks (
  // that would re-introduce exactly the cross-stripe contention the
  // striping removes).  Returns nullptr for a pointer outside any rx
  // data region.
  ShmStripe* stripe_of_ptr(const uint8_t* p) {
    if (nstripes == 1) return stripes[0].get();
    const uint8_t* data0 = reinterpret_cast<const uint8_t*>(base) +
                           seg2_data_off(nstripes);
    if (p < data0) return nullptr;
    uint64_t ring_idx = (uint64_t)(p - data0) / ring_bytes;
    if (ring_idx >= 2ull * nstripes) return nullptr;
    return stripes[ring_idx / 2].get();
  }

  bool release(uint8_t* p, bool* drained) {
    ShmStripe* st = stripe_of_ptr(p);
    if (st == nullptr) return false;
    {
      std::lock_guard<std::mutex> g(st->rx_mu);
      auto it = st->claimed.find((uintptr_t)p);
      if (it == st->claimed.end()) return false;
      it->second->state = kRetired;
      st->claimed.erase(it);
      retire_locked(st);
    }
    // drained check AFTER the stripe lock dropped: each stripe is
    // re-locked in index order (concurrent releasers on different
    // stripes must never hold one rx_mu while waiting on another)
    *drained = closed.load(std::memory_order_acquire) && this->drained();
    return true;
  }

  void close() {
    closed.store(true, std::memory_order_release);
    mark_dead();
  }

  bool drained() {
    for (auto& stp : stripes) {
      ShmStripe* st = stp.get();
      std::lock_guard<std::mutex> g(st->rx_mu);
      if (!st->claimed.empty()) return false;
    }
    return true;
  }
};

static std::mutex g_shm_mu;
// Leaked like the socket registries (see the comment there): static
// destructors must never race live claim holders at exit.
static auto& g_shm_conns =
    *new std::unordered_map<uint64_t, std::shared_ptr<ShmConn>>();

static std::shared_ptr<ShmConn> find_shm(uint64_t h) {
  std::lock_guard<std::mutex> g(g_shm_mu);
  auto it = g_shm_conns.find(h);
  return it == g_shm_conns.end() ? nullptr : it->second;
}

// Segment names live in /dev/shm; reject anything that could escape it.
static bool shm_path(const char* name, char* out, size_t cap) {
  if (name == nullptr || name[0] == '\0') return false;
  for (const char* p = name; *p; ++p)
    if (*p == '/' || (*p == '.' && p[1] == '.')) return false;
  int n = snprintf(out, cap, "/dev/shm/%s", name);
  return n > 0 && (size_t)n < cap;
}

static uint64_t register_shm(std::shared_ptr<ShmConn> c) {
  uint64_t h = nfab::g_next.fetch_add(1);
  std::lock_guard<std::mutex> g(g_shm_mu);
  g_shm_conns[h] = c;
  return h;
}

}  // namespace nshm

#pragma GCC visibility push(default)
extern "C" {

// Starts BOTH planes: a TCP listener on `host` (cross-host peers) and an
// abstract AF_UNIX listener (same-host peers — measured ~3x loopback TCP
// here).  uds_out (>= 108 bytes) receives the abstract name WITHOUT its
// leading NUL byte; empty string when the unix plane failed to bind.
uint64_t brpc_tpu_torch_fab_listen(const char* host, int* port_out,
                             char* uds_out, int uds_out_len) {
  if (uds_out != nullptr && uds_out_len > 0) uds_out[0] = '\0';
  int fd = ::socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) return 0;
  int one = 1;
  setsockopt(fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  struct sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_port = 0;
  if (!nfab::resolve_ipv4(host, &addr.sin_addr)) {
    ::close(fd);
    return 0;
  }
  if (::bind(fd, (struct sockaddr*)&addr, sizeof(addr)) != 0 ||
      ::listen(fd, 64) != 0) {
    ::close(fd);
    return 0;
  }
  socklen_t alen = sizeof(addr);
  getsockname(fd, (struct sockaddr*)&addr, &alen);
  auto l = std::make_shared<nfab::Listener>();
  l->fd = fd;
  l->port = ntohs(addr.sin_port);
  // abstract unix listener, name unique per (pid, port)
  char uname[96];
  snprintf(uname, sizeof(uname), "brpc_tpu_torch_fab.%d.%d", (int)getpid(),
           l->port);
  int ufd = ::socket(AF_UNIX, SOCK_STREAM, 0);
  if (ufd >= 0) {
    struct sockaddr_un ua{};
    ua.sun_family = AF_UNIX;
    ua.sun_path[0] = '\0';  // abstract namespace: no fs entry, no unlink
    strncpy(ua.sun_path + 1, uname, sizeof(ua.sun_path) - 2);
    socklen_t ulen =
        (socklen_t)(offsetof(struct sockaddr_un, sun_path) + 1 +
                    strlen(uname));
    if (::bind(ufd, (struct sockaddr*)&ua, ulen) == 0 &&
        ::listen(ufd, 64) == 0) {
      l->ufd = ufd;
      l->uds_name = uname;
      if (uds_out != nullptr && (int)strlen(uname) < uds_out_len)
        strcpy(uds_out, uname);
    } else {
      ::close(ufd);
    }
  }
  l->acceptor = std::thread([lp = l.get()] { lp->accept_loop(lp->fd, true); });
  if (l->ufd >= 0)
    l->uacceptor =
        std::thread([lp = l.get()] { lp->accept_loop(lp->ufd, false); });
  *port_out = l->port;
  uint64_t h = nfab::g_next.fetch_add(1);
  std::lock_guard<std::mutex> g(nfab::g_mu);
  nfab::g_listeners[h] = l;
  return h;
}

// Same-host connect over the abstract unix plane.
uint64_t brpc_tpu_torch_fab_connect_uds(const char* name, const char* key) {
  int fd = ::socket(AF_UNIX, SOCK_STREAM, 0);
  if (fd < 0) return 0;
  struct sockaddr_un ua{};
  ua.sun_family = AF_UNIX;
  ua.sun_path[0] = '\0';
  strncpy(ua.sun_path + 1, name, sizeof(ua.sun_path) - 2);
  socklen_t ulen = (socklen_t)(offsetof(struct sockaddr_un, sun_path) + 1 +
                               strlen(name));
  if (::connect(fd, (struct sockaddr*)&ua, ulen) != 0) {
    ::close(fd);
    return 0;
  }
  return nfab::finish_connect(fd, key, /*uds=*/true);
}

uint64_t brpc_tpu_torch_fab_accept(uint64_t lh, const char* key,
                             int64_t timeout_us) {
  auto l = nfab::find_listener(lh);
  if (l == nullptr) return 0;
  auto c = l->claim(key, timeout_us);
  if (c == nullptr) return 0;
  uint64_t h = nfab::g_next.fetch_add(1);
  std::lock_guard<std::mutex> g(nfab::g_mu);
  nfab::g_conns[h] = c;
  return h;
}

uint64_t brpc_tpu_torch_fab_connect(const char* host, int port, const char* key) {
  int fd = ::socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) return 0;
  struct sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_port = htons((uint16_t)port);
  if (!nfab::resolve_ipv4(host, &addr.sin_addr)) {
    ::close(fd);
    return 0;
  }
  if (::connect(fd, (struct sockaddr*)&addr, sizeof(addr)) != 0) {
    ::close(fd);
    return 0;
  }
  nfab::set_nodelay(fd);
  return nfab::finish_connect(fd, key, /*uds=*/false);
}

int brpc_tpu_torch_fab_send(uint64_t h, uint64_t uuid, const uint8_t* data,
                      uint64_t len) {
  auto c = nfab::find_conn(h);
  if (c == nullptr) return -1;
  return c->send(uuid, data, len);
}

// Gather send: one uuid frame from n (ptr, len) segments — the stream
// DATA fast path posts an IOBuf's blocks without joining them first.
int brpc_tpu_torch_fab_sendv(uint64_t h, uint64_t uuid, const uint8_t* const* ptrs,
                       const uint64_t* lens, int n) {
  auto c = nfab::find_conn(h);
  if (c == nullptr) return -1;
  return c->sendv(uuid, ptrs, lens, n);
}

int brpc_tpu_torch_fab_recv(uint64_t h, uint64_t uuid, int64_t timeout_us,
                      uint8_t** out, uint64_t* out_len) {
  *out = nullptr;
  *out_len = 0;
  auto c = nfab::find_conn(h);
  if (c == nullptr) return -2;
  return c->recv(uuid, timeout_us, out, out_len);
}

// Return a claimed receive buffer for reuse (the exact (ptr, len) pair
// brpc_tpu_torch_fab_recv handed out).  Falls back to free() when the conn is
// gone or its pool is full — callers may use this unconditionally in
// place of free() for fab_recv buffers.
void brpc_tpu_torch_fab_buf_release(uint64_t h, uint8_t* p, uint64_t len) {
  if (p == nullptr) return;
  auto c = nfab::find_conn(h);
  if (c == nullptr || !c->give_buf(p, len)) free(p);
}

uint64_t brpc_tpu_torch_fab_bytes(uint64_t h, int dir) {
  auto c = nfab::find_conn(h);
  if (c == nullptr) return 0;
  return dir == 0 ? c->bytes_in.load(std::memory_order_relaxed)
                  : c->bytes_out.load(std::memory_order_relaxed);
}

// 1 while the connection can still move frames, 0 once its reader or a
// writer observed death.  The degradation path polls this BEFORE posting
// a descriptor so a dead bulk plane is detected at a frame boundary —
// the frame then falls back inline instead of stranding a descriptor
// whose bytes can never arrive.
int brpc_tpu_torch_fab_alive(uint64_t h) {
  auto c = nfab::find_conn(h);
  if (c == nullptr) return 0;
  std::lock_guard<std::mutex> g(c->mu);
  return c->dead ? 0 : 1;
}

// Deterministic fault injection on one bulk connection (the chaos
// harness behind rpc/fault_injection.py).  Modes:
//   0 clear all knobs
//   1 sever after `arg` total payload bytes written (mid-writev when the
//     watermark lands inside a frame — the truncated-frame shape)
//   2 drop the next `arg` fully-received frames before parking
//   3 delay parking every received frame by `arg` ms
//   4 sever now (shutdown both directions; reader marks dead)
int brpc_tpu_torch_fab_chaos(uint64_t h, int mode, int64_t arg) {
  auto c = nfab::find_conn(h);
  if (c == nullptr) return -1;
  switch (mode) {
    case 0:
      c->chaos_sever_after.store(-1, std::memory_order_relaxed);
      c->chaos_drop_frames.store(0, std::memory_order_relaxed);
      c->chaos_delay_park_ms.store(0, std::memory_order_relaxed);
      return 0;
    case 1:
      c->chaos_sever_after.store(arg, std::memory_order_relaxed);
      return 0;
    case 2:
      c->chaos_drop_frames.store(arg, std::memory_order_relaxed);
      return 0;
    case 3:
      c->chaos_delay_park_ms.store(arg, std::memory_order_relaxed);
      return 0;
    case 4:
      c->shutdown_fd();
      return 0;
    default:
      return -1;
  }
}

// Refuse the next `refuse_n` key handshakes on the listener: the fresh
// conn is closed right after its <klen><key> header, so the matching
// claim (initial HELLO binding or a BULK_REESTABLISH) times out — the
// deterministic "refuse a handshake" chaos hook.
int brpc_tpu_torch_fab_chaos_listener(uint64_t lh, int64_t refuse_n) {
  auto l = nfab::find_listener(lh);
  if (l == nullptr) return -1;
  l->chaos_refuse.store(refuse_n, std::memory_order_relaxed);
  return 0;
}

void brpc_tpu_torch_fab_conn_close(uint64_t h) {
  std::shared_ptr<nfab::BulkConn> c;
  {
    std::lock_guard<std::mutex> g(nfab::g_mu);
    auto it = nfab::g_conns.find(h);
    if (it == nfab::g_conns.end()) return;
    c = it->second;
    nfab::g_conns.erase(it);
  }
  c->close_join();
}

void brpc_tpu_torch_fab_listener_close(uint64_t lh) {
  std::shared_ptr<nfab::Listener> l;
  {
    std::lock_guard<std::mutex> g(nfab::g_mu);
    auto it = nfab::g_listeners.find(lh);
    if (it == nfab::g_listeners.end()) return;
    l = it->second;
    nfab::g_listeners.erase(it);
  }
  l->stop();
}

// ---- per-pair plane registry (pod observability) ----------------------

// Tag a conn with the peer process id it serves; -1 clears the tag.
void brpc_tpu_torch_fab_set_peer(uint64_t h, int32_t peer) {
  auto c = nfab::find_conn(h);
  if (c != nullptr) c->peer.store(peer, std::memory_order_relaxed);
}

// Aggregate the live planes bound to `peer` (live = registered and not
// dead): conn count + cumulative bytes each way.  Returns 0; outputs may
// be null.
int brpc_tpu_torch_fab_pair_stats(int32_t peer, uint64_t* conns,
                            uint64_t* bytes_in, uint64_t* bytes_out) {
  uint64_t n = 0, bi = 0, bo = 0;
  std::vector<std::shared_ptr<nfab::BulkConn>> snapshot;
  {
    std::lock_guard<std::mutex> g(nfab::g_mu);
    for (auto& kv : nfab::g_conns) snapshot.push_back(kv.second);
  }
  for (auto& c : snapshot) {
    if (c->peer.load(std::memory_order_relaxed) != peer) continue;
    {
      std::lock_guard<std::mutex> g(c->mu);
      if (c->dead) continue;
    }
    ++n;
    bi += c->bytes_in.load(std::memory_order_relaxed);
    bo += c->bytes_out.load(std::memory_order_relaxed);
  }
  if (conns != nullptr) *conns = n;
  if (bytes_in != nullptr) *bytes_in = bi;
  if (bytes_out != nullptr) *bytes_out = bo;
  return 0;
}

// Distinct live peer tags (untagged conns excluded); returns the number
// written into peers_out (capped at cap).
int brpc_tpu_torch_fab_peer_list(int32_t* peers_out, int cap) {
  std::vector<std::shared_ptr<nfab::BulkConn>> snapshot;
  {
    std::lock_guard<std::mutex> g(nfab::g_mu);
    for (auto& kv : nfab::g_conns) snapshot.push_back(kv.second);
  }
  std::vector<int32_t> peers;
  for (auto& c : snapshot) {
    int32_t p = c->peer.load(std::memory_order_relaxed);
    if (p < 0) continue;
    {
      std::lock_guard<std::mutex> g(c->mu);
      if (c->dead) continue;
    }
    bool seen = false;
    for (int32_t q : peers) seen = seen || (q == p);
    if (!seen) peers.push_back(p);
  }
  int n = 0;
  for (int32_t p : peers) {
    if (n >= cap) break;
    peers_out[n++] = p;
  }
  return n;
}

// ---- same-host shared-memory ring tier (nshm) -------------------------

// Create the segment as the DIALING side: /dev/shm/<name>, two rings of
// ring_bytes each.  Returns a handle bound to side 0; 0 on failure
// (no /dev/shm, EEXIST, bad name — the caller degrades to the socket
// bulk tier).  The creator's peer attaches by name; whoever finishes
// the handshake unlinks, so a crash between create and attach leaks at
// most one file until the next boot clears /dev/shm.
uint64_t brpc_tpu_torch_shm_create(const char* name, uint64_t ring_bytes) {
  char path[256];
  if (!nshm::shm_path(name, path, sizeof(path))) return 0;
  ring_bytes = nshm::pad16(ring_bytes);
  if (ring_bytes < 64 * 1024) ring_bytes = 64 * 1024;
  size_t total = sizeof(nshm::SegHdr) + 2 * ring_bytes;
  int fd = ::open(path, O_CREAT | O_EXCL | O_RDWR, 0600);
  if (fd < 0) return 0;
  // RESERVE the pages, don't just size the file: ftruncate on tmpfs is
  // sparse and always succeeds, so an undersized /dev/shm (Docker's
  // default is 64 MB, smaller than one default segment) would pass the
  // capability probe and then SIGBUS the process on first touch.
  // posix_fallocate allocates the blocks up front and fails with
  // ENOSPC instead — the caller degrades to the socket bulk tier.
  if (::posix_fallocate(fd, 0, (off_t)total) != 0) {
    ::close(fd);
    ::unlink(path);
    return 0;
  }
  void* base = ::mmap(nullptr, total, PROT_READ | PROT_WRITE, MAP_SHARED,
                      fd, 0);
  ::close(fd);
  if (base == MAP_FAILED) {
    ::unlink(path);
    return 0;
  }
  // pre-fault the (already reserved) pages into this mapping: taking
  // the soft faults inside the first pass's NT-copy loop measured ~4x
  // slower than a sweep here, where nobody is timing bytes.
  for (size_t off = 0; off < total; off += 4096)
    reinterpret_cast<volatile uint8_t*>(base)[off] = 0;
  auto* hdr = reinterpret_cast<nshm::SegHdr*>(base);
  // fresh-file pages are zero; publish the header with magic LAST so an
  // attacher racing the create never sees a half-initialized segment
  hdr->version = nshm::kShmVersion;
  hdr->ring_bytes = ring_bytes;
  hdr->magic.store(nshm::kShmMagic, std::memory_order_release);
  auto c = std::make_shared<nshm::ShmConn>();
  c->bind(base, total, 0);
  return nshm::register_shm(c);
}

// STRIPED create: nstripes independent SPSC ring pairs in
// ONE segment (v2 layout), each ring_bytes per direction, each with its
// own futex doorbells — same create-side custody and failure semantics
// as brpc_tpu_torch_shm_create.  nstripes <= 1 delegates to the v1 creator so
// the single-ring file format (and every byte of its behavior) is
// untouched on 1-core hosts.
uint64_t brpc_tpu_torch_shm_create2(const char* name, uint64_t ring_bytes,
                              uint32_t nstripes) {
  if (nstripes <= 1) return brpc_tpu_torch_shm_create(name, ring_bytes);
  if (nstripes > 64) nstripes = 64;
  char path[256];
  if (!nshm::shm_path(name, path, sizeof(path))) return 0;
  ring_bytes = nshm::pad16(ring_bytes);
  if (ring_bytes < 64 * 1024) ring_bytes = 64 * 1024;
  size_t total = (size_t)nshm::seg2_total(ring_bytes, nstripes);
  int fd = ::open(path, O_CREAT | O_EXCL | O_RDWR, 0600);
  if (fd < 0) return 0;
  if (::posix_fallocate(fd, 0, (off_t)total) != 0) {
    ::close(fd);
    ::unlink(path);
    return 0;
  }
  void* base = ::mmap(nullptr, total, PROT_READ | PROT_WRITE, MAP_SHARED,
                      fd, 0);
  ::close(fd);
  if (base == MAP_FAILED) {
    ::unlink(path);
    return 0;
  }
  for (size_t off = 0; off < total; off += 4096)
    reinterpret_cast<volatile uint8_t*>(base)[off] = 0;
  auto* hdr = reinterpret_cast<nshm::SegHdrS*>(base);
  hdr->version = 2;
  hdr->ring_bytes = ring_bytes;
  hdr->nstripes = nstripes;
  hdr->magic.store(nshm::kShmMagic2, std::memory_order_release);
  auto c = std::make_shared<nshm::ShmConn>();
  c->bind2(base, total, 0);
  return nshm::register_shm(c);
}

// Attach the acceptor side to a segment the peer created.  Validates
// the header against the file size; 0 on any mismatch.
uint64_t brpc_tpu_torch_shm_attach(const char* name) {
  char path[256];
  if (!nshm::shm_path(name, path, sizeof(path))) return 0;
  int fd = ::open(path, O_RDWR);
  if (fd < 0) return 0;
  struct stat st;
  if (::fstat(fd, &st) != 0 || (size_t)st.st_size < sizeof(nshm::SegHdr)) {
    ::close(fd);
    return 0;
  }
  void* base = ::mmap(nullptr, (size_t)st.st_size, PROT_READ | PROT_WRITE,
                      MAP_SHARED, fd, 0);
  ::close(fd);
  if (base == MAP_FAILED) return 0;
  // the v1 and v2 headers share their leading fields: read the common
  // prefix, then validate against whichever layout the magic names
  auto* hdr = reinterpret_cast<nshm::SegHdr*>(base);
  uint32_t magic = hdr->magic.load(std::memory_order_acquire);
  if (magic == nshm::kShmMagic && hdr->version == nshm::kShmVersion &&
      sizeof(nshm::SegHdr) + 2 * hdr->ring_bytes == (size_t)st.st_size) {
    hdr->attached.store(1, std::memory_order_release);
    auto c = std::make_shared<nshm::ShmConn>();
    c->bind(base, (size_t)st.st_size, 1);
    return nshm::register_shm(c);
  }
  if (magic == nshm::kShmMagic2) {
    auto* hdr2 = reinterpret_cast<nshm::SegHdrS*>(base);
    uint32_t n = hdr2->nstripes;
    if (hdr2->version == 2 && n >= 2 && n <= 64 &&
        nshm::seg2_total(hdr2->ring_bytes, n) == (size_t)st.st_size) {
      hdr2->attached.store(1, std::memory_order_release);
      auto c = std::make_shared<nshm::ShmConn>();
      c->bind2(base, (size_t)st.st_size, 1);
      return nshm::register_shm(c);
    }
  }
  ::munmap(base, (size_t)st.st_size);
  return 0;
}

// Unlink the segment NAME (idempotent; both sides may call).  The
// mappings live on — this only removes the /dev/shm directory entry,
// which is exactly what makes a later process crash leak nothing.
int brpc_tpu_torch_shm_unlink(const char* name) {
  char path[256];
  if (!nshm::shm_path(name, path, sizeof(path))) return -1;
  return ::unlink(path) == 0 ? 0 : -1;
}

// Single-buffer send; custody contract matches brpc_tpu_torch_fab_send (the
// caller may reuse the buffer the moment this returns).  0 ok; -1 the
// ring is dead or stayed full past timeout_us (degrade the plane);
// -3 the frame can NEVER fit this ring (route it elsewhere).
int brpc_tpu_torch_shm_send(uint64_t h, uint64_t uuid, const uint8_t* data,
                      uint64_t len, int64_t timeout_us) {
  auto c = nshm::find_shm(h);
  if (c == nullptr) return -1;
  const uint8_t* ptrs[1] = {data};
  const uint64_t lens[1] = {len};
  return c->send(0, uuid, ptrs, lens, len ? 1 : 0, timeout_us);
}

// Gather send: one uuid frame assembled from n segments directly into
// the ring (the stream DATA fast path).
int brpc_tpu_torch_shm_sendv(uint64_t h, uint64_t uuid,
                       const uint8_t* const* ptrs, const uint64_t* lens,
                       int n, int64_t timeout_us) {
  auto c = nshm::find_shm(h);
  if (c == nullptr) return -1;
  return c->send(0, uuid, ptrs, lens, n, timeout_us);
}

// ---- striped variants: explicit stripe selection ----------
// The sender picks the stripe (stream-affinity / round-robin lives in
// Python); the descriptor carries it to the claimer.  An out-of-range
// stripe fails -1 (degrade) rather than silently aliasing stripe 0.

int brpc_tpu_torch_shm_send2(uint64_t h, uint32_t stripe, uint64_t uuid,
                       const uint8_t* data, uint64_t len,
                       int64_t timeout_us) {
  auto c = nshm::find_shm(h);
  if (c == nullptr) return -1;
  const uint8_t* ptrs[1] = {data};
  const uint64_t lens[1] = {len};
  return c->send(stripe, uuid, ptrs, lens, len ? 1 : 0, timeout_us);
}

int brpc_tpu_torch_shm_sendv2(uint64_t h, uint32_t stripe, uint64_t uuid,
                        const uint8_t* const* ptrs, const uint64_t* lens,
                        int n, int64_t timeout_us) {
  auto c = nshm::find_shm(h);
  if (c == nullptr) return -1;
  return c->send(stripe, uuid, ptrs, lens, n, timeout_us);
}

int brpc_tpu_torch_shm_recv2(uint64_t h, uint32_t stripe, uint64_t uuid,
                       int64_t timeout_us, uint8_t** out,
                       uint64_t* out_len) {
  *out = nullptr;
  *out_len = 0;
  auto c = nshm::find_shm(h);
  if (c == nullptr) return -2;
  return c->recv(stripe, uuid, timeout_us, out, out_len);
}

// Stripe count of the segment behind `h` (1 for a v1 segment; 0 for an
// unknown handle).  The claimer reads this once at attach to decode
// stripe-tagged descriptors.
uint32_t brpc_tpu_torch_shm_stripes(uint64_t h) {
  auto c = nshm::find_shm(h);
  return c == nullptr ? 0 : c->nstripes;
}

// Per-stripe observability: out[0..5] = bytes_out, bytes_in, tx
// occupancy, rx occupancy, doorbell sleeps (send+recv, this side),
// ring_bytes.  Returns the count written (0 on a bad handle/stripe).
int brpc_tpu_torch_shm_stripe_stats(uint64_t h, uint32_t stripe, uint64_t* out,
                              int cap) {
  auto c = nshm::find_shm(h);
  if (c == nullptr || out == nullptr || cap < 6) return 0;
  nshm::ShmStripe* st = c->stripe(stripe);
  if (st == nullptr) return 0;
  out[0] = st->bytes_out.load(std::memory_order_relaxed);
  out[1] = st->bytes_in.load(std::memory_order_relaxed);
  out[2] = st->tx->tail.load(std::memory_order_relaxed) -
           st->tx->head.load(std::memory_order_relaxed);
  out[3] = st->rx->tail.load(std::memory_order_relaxed) -
           st->rx->head.load(std::memory_order_relaxed);
  out[4] = st->db_waits_send.load(std::memory_order_relaxed) +
           st->db_waits_recv.load(std::memory_order_relaxed);
  out[5] = c->ring_bytes;
  return 6;
}

// Zero-copy claim: *out points INTO the mapped ring.  The slot's space
// is retired (credit returned to the producer) only when the caller
// releases it with brpc_tpu_torch_shm_release — consume-to-release.  0 ok;
// -1 timeout; -2 ring dead and the frame never arrived (a frame
// published BEFORE death is still claimable after it).
int brpc_tpu_torch_shm_recv(uint64_t h, uint64_t uuid, int64_t timeout_us,
                      uint8_t** out, uint64_t* out_len) {
  *out = nullptr;
  *out_len = 0;
  auto c = nshm::find_shm(h);
  if (c == nullptr) return -2;
  return c->recv(0, uuid, timeout_us, out, out_len);
}

// Return a claimed slot: the ring space becomes reclaimable once every
// earlier slot retired too (in-order head advance under out-of-order
// release).  After close(), the LAST release unmaps the segment.
void brpc_tpu_torch_shm_release(uint64_t h, uint8_t* p, uint64_t len) {
  (void)len;
  if (p == nullptr) return;
  auto c = nshm::find_shm(h);
  if (c == nullptr) return;
  bool drained = false;
  if (c->release(p, &drained) && drained) {
    std::lock_guard<std::mutex> g(nshm::g_shm_mu);
    nshm::g_shm_conns.erase(h);
  }
}

// 1 while the ring pair can move frames (peer attached or not-yet —
// the handshake gates use), 0 once either side marked it dead.
int brpc_tpu_torch_shm_alive(uint64_t h) {
  auto c = nshm::find_shm(h);
  if (c == nullptr) return 0;
  return c->is_dead() ? 0 : 1;
}

// Mark dead, wake every doorbell, and unregister — UNLESS claims are
// still out: the mapping must outlive every zero-copy view Python
// holds, so the handle stays registered (dead) until the last release.
void brpc_tpu_torch_shm_close(uint64_t h) {
  std::shared_ptr<nshm::ShmConn> c;
  {
    std::lock_guard<std::mutex> g(nshm::g_shm_mu);
    auto it = nshm::g_shm_conns.find(h);
    if (it == nshm::g_shm_conns.end()) return;
    c = it->second;
  }
  c->close();
  bool drained = c->drained();
  std::lock_guard<std::mutex> g(nshm::g_shm_mu);
  if (drained) nshm::g_shm_conns.erase(h);
}

// Mark the ring pair dead (both directions, every doorbell woken)
// WITHOUT unregistering: parked frames stay claimable, new sends fail,
// waits for frames that never arrived fail fast (-2).  The degradation
// path uses this to retire a ring from SENDING while the peer's
// already-announced descriptors can still claim their published bytes.
void brpc_tpu_torch_shm_mark_dead(uint64_t h) {
  auto c = nshm::find_shm(h);
  if (c != nullptr) c->mark_dead();
}

// Deterministic fault injection on one shm ring pair:
//   0 clear knobs
//   1 sever after `arg` total tx payload bytes — the write that crosses
//     the watermark copies a PARTIAL slot and dies without publishing
//     (the producer-crash-mid-slot shape)
//   2 drop the next `arg` received frames at scan (descriptor arrives,
//     claim never satisfied — the lost-frame shape)
//   4 kill now (both directions dead, every doorbell woken)
//   5 kill stripe `arg`: its NEXT send dies and takes the shared death
//     word with it — the stripe-kill shape (health is segment-wide, so
//     one dead stripe degrades the whole plane)
int brpc_tpu_torch_shm_chaos(uint64_t h, int mode, int64_t arg) {
  auto c = nshm::find_shm(h);
  if (c == nullptr) return -1;
  switch (mode) {
    case 0:
      c->chaos_sever_after.store(-1, std::memory_order_relaxed);
      c->chaos_drop_frames.store(0, std::memory_order_relaxed);
      c->chaos_kill_stripe.store(-1, std::memory_order_relaxed);
      return 0;
    case 1:
      c->chaos_sever_after.store(arg, std::memory_order_relaxed);
      return 0;
    case 2:
      c->chaos_drop_frames.store(arg, std::memory_order_relaxed);
      return 0;
    case 4:
      c->mark_dead();
      return 0;
    case 5:
      c->chaos_kill_stripe.store(arg, std::memory_order_relaxed);
      return 0;
    default:
      return -1;
  }
}

// Observability snapshot: out[0..5] = bytes_out, bytes_in,
// tx occupancy (produced-unretired), rx occupancy, doorbell sleeps
// (send+recv, THIS side), ring_bytes.  Returns the count written.
int brpc_tpu_torch_shm_stats(uint64_t h, uint64_t* out, int cap) {
  auto c = nshm::find_shm(h);
  if (c == nullptr || out == nullptr || cap < 6) return 0;
  out[0] = c->bytes_out.load(std::memory_order_relaxed);
  out[1] = c->bytes_in.load(std::memory_order_relaxed);
  uint64_t tx_occ = 0, rx_occ = 0, db = 0;
  for (auto& stp : c->stripes) {
    nshm::ShmStripe* st = stp.get();
    tx_occ += st->tx->tail.load(std::memory_order_relaxed) -
              st->tx->head.load(std::memory_order_relaxed);
    rx_occ += st->rx->tail.load(std::memory_order_relaxed) -
              st->rx->head.load(std::memory_order_relaxed);
    db += st->db_waits_send.load(std::memory_order_relaxed) +
          st->db_waits_recv.load(std::memory_order_relaxed);
  }
  out[2] = tx_occ;
  out[3] = rx_occ;
  out[4] = db;
  out[5] = c->ring_bytes;    // per-direction PER-STRIPE capacity: the
                             // max-frame contract the route screen uses
  return 6;
}

// Deterministic pre-exit quiesce: close and JOIN every live bulk conn
// and listener (acceptors first, so no fresh conn can appear behind the
// snapshot), then mark every shm ring dead (no threads to join there —
// rings with outstanding zero-copy claims stay mapped until released,
// or until the OS reclaims at exit).  The leaked registries keep static
// teardown race-free by never destructing; THIS is the ordered shutdown
// path — after it returns, no nfab thread is running, so interpreter
// exit cannot race one.  Called from Python's fabric atexit hook.
void brpc_tpu_torch_fab_quiesce() {
  std::vector<std::shared_ptr<nfab::Listener>> listeners;
  std::vector<std::shared_ptr<nfab::BulkConn>> conns;
  {
    std::lock_guard<std::mutex> g(nfab::g_mu);
    for (auto& kv : nfab::g_listeners) listeners.push_back(kv.second);
    nfab::g_listeners.clear();
    for (auto& kv : nfab::g_conns) conns.push_back(kv.second);
    nfab::g_conns.clear();
  }
  for (auto& l : listeners) l->stop();
  for (auto& c : conns) c->close_join();
  std::vector<std::pair<uint64_t, std::shared_ptr<nshm::ShmConn>>> shms;
  {
    std::lock_guard<std::mutex> g(nshm::g_shm_mu);
    for (auto& kv : nshm::g_shm_conns) shms.push_back(kv);
  }
  for (auto& kv : shms) {
    kv.second->close();
    bool drained = kv.second->drained();
    std::lock_guard<std::mutex> g(nshm::g_shm_mu);
    if (drained) nshm::g_shm_conns.erase(kv.first);
  }
}

}  // extern "C"
#pragma GCC visibility pop
