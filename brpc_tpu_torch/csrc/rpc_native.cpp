// The native TCP datapath of brpc_tpu_torch: NativeServer, NativeChannel
// with its call slots and async completion, and NativePool, with their C
// ABI and the bench entries that drive them.
//
// A copy of the reference's TCP half (native/rpc.cpp of the JAX package:
// the server's epoll loops and dispatch, the channel's correlation table
// and caller-becomes-reader election, the pooled channel), kept line for
// line, and of its raw epoll echo (native/core.cpp).  The frames come from
// the one codec of this library (trpc_codec.h), so they are byte-identical
// to policy/tpu_std.py's and to the reference core's: a port channel calls
// a reference server and the other way round.  Python reaches this file
// through ctypes only (butil/native.py, rpc/native_fabric.py).
//
// Built with ici_native.cpp into one library (butil/native.py): g++ -O2
// -fPIC -shared -pthread -fvisibility=hidden -Wl,-Bsymbolic.  Hidden
// visibility keeps its servers, channels and handle registries apart from
// the reference core's in a process that loads both; only the C ABI below
// is exported.

#include "tsan_compat.h"

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <map>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>

#include "flat_map.h"
#include <vector>

#ifdef __linux__
#include <arpa/inet.h>
#include <fcntl.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <poll.h>
#include <sys/epoll.h>
#include <sys/socket.h>
#include <sys/uio.h>
#include <unistd.h>
#include <algorithm>

namespace nrpc {

#include "trpc_codec.h"

// head + up-to-two payload segments as iovecs; returns the entry count
static int build_iov(struct iovec* iov, const std::string& head,
                     const void* data, size_t len, const void* att,
                     size_t att_len) {
  int n = 0;
  iov[n].iov_base = (void*)head.data();
  iov[n++].iov_len = head.size();
  if (len) {
    iov[n].iov_base = (void*)data;
    iov[n++].iov_len = len;
  }
  if (att_len) {
    iov[n].iov_base = (void*)att;
    iov[n++].iov_len = att_len;
  }
  return n;
}

// ====================================================================
// fd helpers
// ====================================================================

static void set_nonblock(int fd) {
  fcntl(fd, F_SETFL, fcntl(fd, F_GETFL, 0) | O_NONBLOCK);
}

static void set_nodelay(int fd) {
  int one = 1;
  setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  // socket buffer sizes stay kernel-autotuned: explicit 4 MB buffers
  // measured ~45% SLOWER for 1 MB echoes here (cache-cold slabs beat the
  // saved wakeups on a shared core)
}

// Scatter-gather bounded write: one syscall for header+meta+payload+
// attachment with no assembly copy (the zero-copy discipline of
// Socket::DoWrite's writev batching, socket.cpp:1790).  iov entries are
// consumed in place.  Polls through EAGAIN (callers already serialized
// per connection) but bounded: a peer that stops reading must not wedge
// the caller forever (the epoll thread calls this inline, so an
// unbounded loop would starve every connection on the loop and deadlock
// stop()).  ~5 s of refusal = dead.
static bool write_all_iov(int fd, struct iovec* iov, int iovcnt,
                          const std::atomic<bool>* abort_flag = nullptr,
                          int timeout_ms = 5000) {
  int waited_ms = 0;
  int cur = 0;
  while (cur < iovcnt) {
    if (abort_flag != nullptr &&
        abort_flag->load(std::memory_order_relaxed))
      return false;
    ssize_t w = ::writev(fd, iov + cur, iovcnt - cur);
    if (w > 0) {
      size_t n = (size_t)w;
      while (cur < iovcnt && n >= iov[cur].iov_len) {
        n -= iov[cur].iov_len;
        ++cur;
      }
      if (cur < iovcnt && n > 0) {
        iov[cur].iov_base = (char*)iov[cur].iov_base + n;
        iov[cur].iov_len -= n;
      }
    } else if (w < 0 && (errno == EAGAIN || errno == EWOULDBLOCK)) {
      if (waited_ms >= timeout_ms) return false;
      struct pollfd pfd{fd, POLLOUT, 0};
      ::poll(&pfd, 1, 100);
      waited_ms += 100;
    } else if (w < 0 && errno == EINTR) {
      continue;
    } else {
      return false;
    }
  }
  return true;
}

static bool write_all(int fd, const char* data, size_t len,
                      const std::atomic<bool>* abort_flag = nullptr,
                      int timeout_ms = 5000) {
  struct iovec iov{(void*)data, len};
  return write_all_iov(fd, &iov, 1, abort_flag, timeout_ms);
}

// Read up to `chunk` bytes straight into the tail of `s` — no intermediate
// stack buffer and no zero-fill (resize_and_overwrite leaves the new tail
// uninitialized for read() to fill).  For multi-chunk frames this halves
// userspace memory traffic vs buf-then-append.  Returns read() semantics.
static ssize_t read_into_string(int fd, std::string& s, size_t chunk) {
  size_t old = s.size();
  ssize_t got = 0;
#if defined(__cpp_lib_string_resize_and_overwrite)
  s.resize_and_overwrite(old + chunk, [&](char* p, size_t) {
    got = ::read(fd, p + old, chunk);
    return old + (got > 0 ? (size_t)got : 0);
  });
#else
  // pre-C++23 fallback: resize zero-fills the tail once per chunk — a
  // memset the reads immediately overwrite, still one copy fewer than
  // the stack-buffer-then-append path
  s.resize(old + chunk);
  got = ::read(fd, &s[old], chunk);
  s.resize(old + (got > 0 ? (size_t)got : 0));
#endif
  return got;
}

// If a frame header is already buffered, reserve the full frame so the
// growth path never re-copies accumulated bytes mid-frame.
static void reserve_for_frame(std::string& rbuf) {
  if (rbuf.size() < kHeaderSize) return;
  const uint8_t* p = (const uint8_t*)rbuf.data();
  if (memcmp(p, kMagic, 4) != 0) return;
  uint32_t meta_size = get_u32be(p + 4);
  uint32_t body_size = get_u32be(p + 8);
  if (meta_size > (1u << 26) || body_size > (1u << 31)) return;
  size_t total = kHeaderSize + (size_t)meta_size + body_size;
  if (total > rbuf.capacity()) rbuf.reserve(total);
}

// Read size for the next chunk: when the head of the buffer is a partial
// frame, read EXACTLY its remainder (capped) — one syscall instead of
// four per MB, and the buffer stays single-frame so bulk responses take
// the zero-copy dispatch path.
static size_t next_read_size(const std::string& rbuf) {
  static const size_t kChunk = 256 * 1024;
  if (rbuf.size() >= kHeaderSize &&
      memcmp(rbuf.data(), kMagic, 4) == 0) {
    uint32_t meta_size = get_u32be((const uint8_t*)rbuf.data() + 4);
    uint32_t body_size = get_u32be((const uint8_t*)rbuf.data() + 8);
    if (meta_size <= (1u << 26) && body_size <= (1u << 31)) {
      size_t total = kHeaderSize + (size_t)meta_size + body_size;
      if (total > rbuf.size())
        return std::min(total - rbuf.size(), (size_t)(8u << 20));
    }
  }
  return kChunk;
}


// ====================================================================
// NativeServer
// ====================================================================

// Python request hook: (token, method, payload, payload_len, att, att_len,
// log_id).  Respond via brpc_tpu_nserver_respond(token, ...) from any
// thread; each token must be answered exactly once.
typedef void (*py_request_fn)(uint64_t token, const char* method,
                              const uint8_t* payload, uint64_t payload_len,
                              const uint8_t* att, uint64_t att_len,
                              uint64_t log_id);

// Conns are shared_ptr-owned: the epoll thread, the conns_ map, and any
// in-flight respond() each hold a reference, so closing a connection can
// never free memory under another thread (the reference gets this from
// Socket's versioned-id ResourcePool; shared_ptr is the C++-idiomatic
// equivalent here).  After close, fd is -1 under wmu — respond() checks it
// so a recycled fd number is never written.
struct Conn {
  int fd = -1;
  std::string rbuf;
  std::mutex wmu;
  uint64_t id = 0;
  int loop = 0;       // owning epoll loop (reads are single-threaded per conn)
};
using ConnPtr = std::shared_ptr<Conn>;

struct PendingReply;

class NativeServer {
 public:
  // nloops: epoll loops (the reference's FLAGS_event_dispatcher_num,
  // event_dispatcher.cpp:30).  Loop 0 owns the listener; accepted conns
  // hash across loops so request processing scales past one core.
  bool start(int port, int nloops = 4) {
    listen_fd_ = ::socket(AF_INET, SOCK_STREAM, 0);
    int one = 1;
    setsockopt(listen_fd_, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
    sockaddr_in addr{};
    addr.sin_family = AF_INET;
    addr.sin_addr.s_addr = htonl(INADDR_ANY);
    addr.sin_port = htons((uint16_t)port);
    if (::bind(listen_fd_, (sockaddr*)&addr, sizeof(addr)) != 0) return false;
    socklen_t len = sizeof(addr);
    getsockname(listen_fd_, (sockaddr*)&addr, &len);
    port_ = ntohs(addr.sin_port);
    ::listen(listen_fd_, 128);
    set_nonblock(listen_fd_);
    nloops_ = nloops < 1 ? 1 : nloops;
    epfds_.resize(nloops_);
    for (int i = 0; i < nloops_; ++i) epfds_[i] = epoll_create1(0);
    epoll_event ev{};
    ev.events = EPOLLIN;                 // listen fd: level-triggered accept
    ev.data.u64 = 0;                     // 0 = listener
    epoll_ctl(epfds_[0], EPOLL_CTL_ADD, listen_fd_, &ev);
    for (int i = 0; i < nloops_; ++i)
      threads_.emplace_back([this, i] { run(i); });
    return true;
  }

  void stop();          // defined after the token registry (purges tokens)

  void set_handle(uint64_t h) { handle_ = h; }
  uint64_t handle() const { return handle_; }

  int port() const { return port_; }

  void register_echo(const std::string& full_method) {
    std::lock_guard<std::mutex> g(methods_mu_);
    echo_methods_.insert({full_method, true});
  }

  void set_py_handler(py_request_fn fn) { py_handler_ = fn; }

  uint64_t requests() const { return requests_.load(); }

  bool respond(uint64_t conn_id, uint64_t cid, uint64_t err,
               const std::string& err_text, const void* data, size_t len,
               const void* att, size_t att_len);

 private:
  void run(int loop) {
    epoll_event events[64];
    while (!stop_.load(std::memory_order_relaxed)) {
      int n = epoll_wait(epfds_[loop], events, 64, 50);
      for (int i = 0; i < n; ++i) {
        if (events[i].data.u64 == 0) {
          accept_all();
        } else {
          ConnPtr c = find_conn(events[i].data.u64);
          if (c != nullptr) handle_readable(c);
        }
      }
    }
  }

  void accept_all() {
    for (;;) {
      int fd = ::accept(listen_fd_, nullptr, nullptr);
      if (fd < 0) break;
      set_nonblock(fd);
      set_nodelay(fd);
      ConnPtr c = std::make_shared<Conn>();
      c->fd = fd;
      c->id = next_conn_id_.fetch_add(1) + 1;  // ids start at 1 (0=listener)
      c->loop = (int)(c->id % nloops_);        // conn pinned to one loop
      {
        std::lock_guard<std::mutex> g(conns_mu_);
        conns_[c->id] = c;
      }
      epoll_event ev{};
      ev.events = EPOLLIN | EPOLLET;           // edge-triggered data path
      ev.data.u64 = c->id;
      epoll_ctl(epfds_[c->loop], EPOLL_CTL_ADD, fd, &ev);
    }
  }

  ConnPtr find_conn(uint64_t id) {
    std::lock_guard<std::mutex> g(conns_mu_);
    auto it = conns_.find(id);
    return it == conns_.end() ? nullptr : it->second;
  }

  void close_conn(const ConnPtr& c) {
    {
      std::lock_guard<std::mutex> g(conns_mu_);
      conns_.erase(c->id);
    }
    std::lock_guard<std::mutex> wg(c->wmu);
    if (c->fd >= 0) {
      epoll_ctl(epfds_[c->loop], EPOLL_CTL_DEL, c->fd, nullptr);
      ::close(c->fd);
      c->fd = -1;     // respond() checks under wmu: no write to recycled fd
    }
  }

  void handle_readable(const ConnPtr& c) {
    for (;;) {                       // ET: drain until EAGAIN
      reserve_for_frame(c->rbuf);    // growth never re-copies mid-frame
      size_t chunk = next_read_size(c->rbuf);
      ssize_t r = read_into_string(c->fd, c->rbuf, chunk);
      if (r > 0) {
        // short read = socket buffer drained; data arriving after this
        // read raises a fresh edge, so skipping the EAGAIN round-trip is
        // safe and saves one syscall per request
        if ((size_t)r < chunk) break;
      } else if (r == 0) {
        close_conn(c);
        return;
      } else if (errno == EAGAIN || errno == EWOULDBLOCK) {
        break;
      } else if (errno == EINTR) {
        continue;
      } else {
        close_conn(c);
        return;
      }
    }
    // cut complete frames
    size_t off = 0;
    const std::string& rb = c->rbuf;
    while (rb.size() - off >= kHeaderSize) {
      const uint8_t* p = (const uint8_t*)rb.data() + off;
      if (memcmp(p, kMagic, 4) != 0) {  // protocol error: drop conn
        close_conn(c);
        return;
      }
      uint32_t meta_size = get_u32be(p + 4);
      uint32_t body_size = get_u32be(p + 8);
      if (meta_size > (1u << 26) || body_size > (1u << 31)) {
        close_conn(c);   // absurd frame sizes (tpu_std.py parse guard)
        return;
      }
      size_t total = kHeaderSize + (size_t)meta_size + body_size;
      if (rb.size() - off < total) break;
      process_frame(c, p + kHeaderSize, meta_size,
                    p + kHeaderSize + meta_size, body_size);
      off += total;
    }
    if (off > 0) c->rbuf.erase(0, off);
  }

  void process_frame(const ConnPtr& c, const uint8_t* meta_p,
                     size_t meta_len, const uint8_t* body, size_t body_len);

  int listen_fd_ = -1, port_ = 0;
  int nloops_ = 1;
  std::vector<int> epfds_;
  uint64_t handle_ = 0;
  std::vector<std::thread> threads_;
  std::atomic<bool> stop_{false};
  std::mutex conns_mu_;
  std::unordered_map<uint64_t, ConnPtr> conns_;
  std::atomic<uint64_t> next_conn_id_{0};
  std::mutex methods_mu_;
  std::unordered_map<std::string, bool> echo_methods_;
  py_request_fn py_handler_ = nullptr;
  std::atomic<uint64_t> requests_{0};
};

// Tokens for in-flight Python-handled requests.  A token stores the
// server's registry HANDLE, never a pointer: respond() re-resolves both
// the server (g_servers, shared_ptr) and the conn (conns_, shared_ptr) so
// replies after a disconnect or a server stop are dropped, not crashed —
// the reference's Socket::Address versioned-id discipline.
struct PendingReply {
  uint64_t server_handle;
  uint64_t conn_id;
  uint64_t cid;
};

static std::mutex g_tokens_mu;
// Heap-allocated and intentionally never freed (same discipline as
// fabric.cpp's conn registries): a static destructor would destroy this
// map — and the objects it pins — while server/channel reader threads
// another exiting thread left running may still be mid-access, which is
// the std::terminate-at-exit flake.  The OS reclaims everything.
static auto& g_tokens = *new nbase::FlatMap64<PendingReply>();
static std::atomic<uint64_t> g_next_token{1};

void NativeServer::stop() {
  stop_.store(true);
  for (auto& t : threads_)
    if (t.joinable()) t.join();
  threads_.clear();
  {
    // drop replies parked in Python for this server: their tokens must not
    // resolve once we're gone
    std::lock_guard<std::mutex> g(g_tokens_mu);
    std::vector<uint64_t> purge;
    g_tokens.for_each([&](uint64_t t, PendingReply& pr) {
      if (pr.server_handle == handle_) purge.push_back(t);
    });
    for (uint64_t t : purge) g_tokens.erase(t);
  }
  std::vector<ConnPtr> conns;
  {
    std::lock_guard<std::mutex> g(conns_mu_);
    for (auto& kv : conns_) conns.push_back(kv.second);
    conns_.clear();
  }
  for (auto& c : conns) {
    std::lock_guard<std::mutex> wg(c->wmu);
    if (c->fd >= 0) {
      ::close(c->fd);
      c->fd = -1;
    }
  }
  if (listen_fd_ >= 0) ::close(listen_fd_);
  for (int fd : epfds_)
    if (fd >= 0) ::close(fd);
  epfds_.clear();
  listen_fd_ = -1;
}

bool NativeServer::respond(uint64_t conn_id, uint64_t cid, uint64_t err,
                           const std::string& err_text, const void* data,
                           size_t len, const void* att, size_t att_len) {
  ConnPtr c = find_conn(conn_id);
  if (c == nullptr) return false;
  RpcMeta rmeta;
  rmeta.response.present = true;
  rmeta.response.error_code = err;
  rmeta.response.error_text = err_text;
  rmeta.correlation_id = cid;
  rmeta.attachment_size = att_len;
  std::string head = pack_head(rmeta, len + att_len);
  struct iovec iov[3];
  int iovcnt = build_iov(iov, head, data, len, att, att_len);
  bool ok;
  {
    std::lock_guard<std::mutex> g(c->wmu);
    ok = c->fd >= 0 &&               // closed while the handler ran?
         write_all_iov(c->fd, iov, iovcnt, &stop_);
  }
  // a timed-out/partial write leaves the stream desynced mid-frame: drop
  // the connection now (matching the echo path) instead of letting a
  // later respond() append after the truncation
  if (!ok) close_conn(c);
  return ok;
}

void NativeServer::process_frame(const ConnPtr& c, const uint8_t* meta_p,
                                 size_t meta_len, const uint8_t* body,
                                 size_t body_len) {
  RpcMeta meta;
  if (!decode_meta(meta_p, meta_p + meta_len, &meta)) {
    close_conn(c);
    return;
  }
  requests_.fetch_add(1, std::memory_order_relaxed);
  std::string full = meta.request.service_name + "." +
                     meta.request.method_name;
  bool is_echo;
  {
    std::lock_guard<std::mutex> g(methods_mu_);
    is_echo = echo_methods_.count(full) != 0;
  }  // released before any write: a stalled peer must not hold the
     // server-wide method table against other loops
  if (is_echo) {
    // native echo: response payload = request payload, attachment echoed;
    // payload goes out via writev straight from the read buffer (no copy)
    RpcMeta rmeta;
    rmeta.response.present = true;
    rmeta.correlation_id = meta.correlation_id;
    rmeta.attachment_size = meta.attachment_size;
    std::string head = pack_head(rmeta, body_len);
    struct iovec iov[3];
    int iovcnt = build_iov(iov, head, body, body_len, nullptr, 0);
    bool ok;
    {
      std::lock_guard<std::mutex> wg(c->wmu);
      ok = c->fd >= 0 && write_all_iov(c->fd, iov, iovcnt, &stop_);
    }
    if (!ok) close_conn(c);     // non-reading peer: drop it, free the loop
    return;
  }
  if (py_handler_ != nullptr) {
    uint64_t token = g_next_token.fetch_add(1);
    {
      std::lock_guard<std::mutex> g(g_tokens_mu);
      g_tokens[token] = PendingReply{handle_, c->id, meta.correlation_id};
    }
    size_t att = std::min((size_t)meta.attachment_size, body_len);
    size_t payload_len = body_len - att;
    py_handler_(token, full.c_str(), body, payload_len, body + payload_len,
                att, meta.request.log_id);
    return;
  }
  // ENOMETHOD (brpc_tpu/rpc/errors.py values mirror the reference's)
  RpcMeta rmeta;
  rmeta.response.present = true;
  rmeta.response.error_code = 1002;  // ENOMETHOD (rpc/errors.py)
  rmeta.response.error_text = "no method " + full;
  rmeta.correlation_id = meta.correlation_id;
  std::string frame = pack_frame(rmeta, nullptr, 0);
  bool ok;
  {
    std::lock_guard<std::mutex> wg(c->wmu);
    ok = c->fd >= 0 &&
         write_all(c->fd, frame.data(), frame.size(), &stop_);
  }
  if (!ok) close_conn(c);
}

// ====================================================================
// NativeChannel: correlation table + caller-becomes-reader election
// ====================================================================

// Slots are shared_ptr-owned: the caller, the slots_ map, and a reader
// mid-dispatch each hold a reference, so a timed-out caller erasing its
// slot can never free it under the reader (the review finding this fixes:
// dispatch_frame resolved a raw pointer, released slots_mu_, then locked
// the slot — a deleted slot in between was a use-after-free).
// async completion hook: (user, error_code, err_text, payload,
// payload_len, att, att_len); pointers valid only for the callback
typedef void (*nrpc_async_cb)(void* user, uint64_t error_code,
                              const char* err_text, const uint8_t* resp,
                              uint64_t resp_len, const uint8_t* att,
                              uint64_t att_len);

struct CallSlot {
  std::mutex mu;
  std::condition_variable cv;
  bool done = false;
  uint64_t error_code = 0;
  std::string error_text;
  // response bytes: `storage` owns them (for bulk responses the READER's
  // buffer is MOVED here — zero copy); payload/attachment are spans
  std::string storage;
  size_t p_off = 0, p_len = 0, a_off = 0, a_len = 0;
  // async completion (sync callers leave cb null and wait on cv)
  nrpc_async_cb cb = nullptr;
  void* cb_user = nullptr;
  int64_t deadline_ns = 0;       // async timeout, checked by the reader
};
using SlotPtr = std::shared_ptr<CallSlot>;

// Owning view of one completed call's response.
struct CallResult {
  std::string storage;
  size_t p_off = 0, p_len = 0, a_off = 0, a_len = 0;
  const uint8_t* payload() const {
    return (const uint8_t*)storage.data() + p_off;
  }
  const uint8_t* attachment() const {
    return (const uint8_t*)storage.data() + a_off;
  }
};

class NativeChannel : public std::enable_shared_from_this<NativeChannel> {
 public:
  ~NativeChannel() {
    closing_.store(true, std::memory_order_release);
    join_reader();
    // fd closes only here, once every in-flight call has dropped its
    // shared_ptr to this channel — an fd number is never recycled while a
    // caller could still write it
    if (fd_ >= 0) ::close(fd_);
  }

  bool connect_to(const char* host, int port) {
    fd_ = ::socket(AF_INET, SOCK_STREAM, 0);
    sockaddr_in addr{};
    addr.sin_family = AF_INET;
    addr.sin_port = htons((uint16_t)port);
    if (inet_pton(AF_INET, host, &addr.sin_addr) != 1) return false;
    if (::connect(fd_, (sockaddr*)&addr, sizeof(addr)) != 0) {
      ::close(fd_);
      fd_ = -1;
      return false;
    }
    set_nodelay(fd_);
    set_nonblock(fd_);   // readers use poll(); an exact-64KiB read burst
                         // must hit EAGAIN, not block holding read_mu_
    return true;
  }

  void close_ch() {
    closing_.store(true, std::memory_order_release);
    fail_all_pending();     // fd itself closes in the destructor
    join_reader();
  }

  void fail_all_pending() {
    // O(1) under the hot lock (same discipline as IciChannel::fail_all,
    // review finding: per-slot lock/notify sweeps under slots_mu_
    // stalled concurrent slot registration); the table is processed
    // outside it
    nbase::FlatMap64<SlotPtr> victims;
    {
      std::lock_guard<std::mutex> g(slots_mu_);
      victims.swap(slots_);
    }
    std::vector<std::pair<SlotPtr, uint64_t>> async_victims;
    victims.for_each([&](uint64_t cid, SlotPtr& sp) {
      std::lock_guard<std::mutex> sg(sp->mu);
      if (sp->done) return;             // delivered result stays delivered
      sp->done = true;
      sp->error_code = 1009;  // EFAILEDSOCKET (rpc/errors.py)
      sp->error_text = "channel closed";
      sp->cv.notify_all();
      if (sp->cb != nullptr) async_victims.push_back({sp, cid});
    });
    for (auto& [slot, cid] : async_victims)   // callbacks outside locks
      slot->cb(slot->cb_user, 1009, "channel closed", nullptr, 0, nullptr,
               0);
  }

  bool pack_and_write(const char* service_dot_method, const void* req,
                      size_t req_len, const void* att, size_t att_len,
                      int64_t timeout_us, uint64_t cid) {
    RpcMeta meta;
    meta.request.present = true;
    const char* dot = strrchr(service_dot_method, '.');
    if (dot == nullptr) {
      meta.request.method_name = service_dot_method;
    } else {
      meta.request.service_name.assign(service_dot_method,
                                       dot - service_dot_method);
      meta.request.method_name = dot + 1;
    }
    meta.correlation_id = cid;
    meta.attachment_size = att_len;
    if (timeout_us > 0)
      meta.request.timeout_ms = (uint64_t)(timeout_us / 1000);
    std::string head = pack_head(meta, req_len + att_len);
    struct iovec iov[3];
    int iovcnt = build_iov(iov, head, req, req_len, att, att_len);
    std::lock_guard<std::mutex> g(wmu_);
    return !closing_.load(std::memory_order_acquire) &&
           write_all_iov(fd_, iov, iovcnt);
  }

  // 0 ok; 1008 ERPCTIMEDOUT; 1009 broken socket; else server error code
  uint64_t call(const char* service_dot_method, const void* req,
                size_t req_len, const void* att, size_t att_len,
                int64_t timeout_us, CallResult* out,
                std::string* err_text) {
    if (fd_ < 0 || closing_.load(std::memory_order_acquire)) {
      *err_text = "channel not connected";
      return 1009;
    }
    uint64_t cid = next_cid_.fetch_add(1) + 1;
    SlotPtr slot = std::make_shared<CallSlot>();
    {
      std::lock_guard<std::mutex> g(slots_mu_);
      slots_[cid] = slot;
    }
    if (!pack_and_write(service_dot_method, req, req_len, att, att_len,
                        timeout_us, cid)) {
      erase_slot(cid);
      *err_text = "write failed";
      return 1009;
    }
    // wait: become the reader or wait for the reader to fill our slot
    auto deadline = std::chrono::steady_clock::now() +
                    std::chrono::microseconds(timeout_us > 0 ? timeout_us
                                                             : (int64_t)1e12);
    uint64_t rc = 0;
    for (;;) {
      {
        std::unique_lock<std::mutex> sl(slot->mu);
        if (slot->done) break;
      }
      if (read_mu_.try_lock()) {
        bool progressed = read_once(200);
        read_mu_.unlock();
        if (!progressed && closing_.load(std::memory_order_acquire)) {
          std::unique_lock<std::mutex> sl(slot->mu);
          if (!slot->done) {
            slot->done = true;
            slot->error_code = 1009;
            slot->error_text = "connection lost";
          }
          break;
        }
      } else {
        std::unique_lock<std::mutex> sl(slot->mu);
        nbase::cv_wait_for(slot->cv, sl, std::chrono::milliseconds(1));
        if (slot->done) break;
      }
      if (std::chrono::steady_clock::now() >= deadline) {
        erase_slot(cid);   // response arriving later finds no slot: dropped,
                           // exactly the stale-version drop of bthread_id
        *err_text = "rpc timeout";
        return 1008;       // ERPCTIMEDOUT (rpc/errors.py)
      }
    }
    rc = slot->error_code;
    *err_text = slot->error_text;
    out->storage = std::move(slot->storage);
    out->p_off = slot->p_off;
    out->p_len = slot->p_len;
    out->a_off = slot->a_off;
    out->a_len = slot->a_len;
    erase_slot(cid);
    return rc;
  }

  // Async completion: fire-and-forget write; `cb` runs on the channel's
  // reader thread when the response (or timeout/conn-death) arrives.
  // The reference's async CallMethod with done closure (client.cpp
  // examples); ours completes from the background reader the same way
  // brpc completes from the event dispatcher thread.
  uint64_t call_async(const char* service_dot_method, const void* req,
                      size_t req_len, const void* att, size_t att_len,
                      int64_t timeout_us, nrpc_async_cb cb, void* user) {
    if (fd_ < 0 || closing_.load(std::memory_order_acquire)) {
      cb(user, 1009, "channel not connected", nullptr, 0, nullptr, 0);
      return 1009;
    }
    uint64_t cid = next_cid_.fetch_add(1) + 1;
    SlotPtr slot = std::make_shared<CallSlot>();
    slot->cb = cb;
    slot->cb_user = user;
    slot->deadline_ns =
        now_steady_ns() + (timeout_us > 0 ? timeout_us * 1000
                                          : (int64_t)1e15);
    {
      std::lock_guard<std::mutex> g(slots_mu_);
      slots_[cid] = slot;
    }
    // pull the sweep forward if this deadline is the nearest (benign
    // race: worst case one 50ms-late sweep)
    int64_t cur = next_sweep_ns_.load(std::memory_order_relaxed);
    if (slot->deadline_ns < cur)
      next_sweep_ns_.store(slot->deadline_ns, std::memory_order_relaxed);
    ensure_reader();
    if (!pack_and_write(service_dot_method, req, req_len, att, att_len,
                        timeout_us, cid)) {
      erase_slot(cid);
      // a racing fail_all_pending / deadline sweep may already have
      // completed this slot: the callback fires EXACTLY once, gated on
      // slot->done like every other completion path
      bool fire = false;
      {
        std::lock_guard<std::mutex> sg(slot->mu);
        if (!slot->done) {
          slot->done = true;
          slot->error_code = 1009;
          fire = true;
        }
      }
      if (fire) cb(user, 1009, "write failed", nullptr, 0, nullptr, 0);
      return 1009;
    }
    return 0;
  }

 private:
  static int64_t now_steady_ns() {
    return std::chrono::duration_cast<std::chrono::nanoseconds>(
               std::chrono::steady_clock::now().time_since_epoch())
        .count();
  }

  void erase_slot(uint64_t cid) {
    std::lock_guard<std::mutex> g(slots_mu_);
    slots_.erase(cid);
  }

  // Background reader for async completions.  Sync callers still use
  // caller-becomes-reader; read_mu_ arbitrates.  Started on the first
  // async call, lives until close.
  void ensure_reader() {
    // reader_ construction and join are serialized by reader_mu_ — a
    // flag-then-assign publication would let a concurrent close_ch read
    // the std::thread object mid-move (UB)
    std::lock_guard<std::mutex> g(reader_mu_);
    if (reader_.joinable()) return;
    // the loop holds a self-reference: the destructor can never run
    // while the reader is mid-iteration (an async callback may drop the
    // last external ref)
    auto self = shared_from_this();
    reader_ = std::thread([self] {
      while (!self->closing_.load(std::memory_order_acquire)) {
        if (self->read_mu_.try_lock()) {
          self->read_once(50);
          self->read_mu_.unlock();
        } else {
          // a sync caller is the reader right now; it fills async slots
          // too, so just yield briefly
          std::this_thread::sleep_for(std::chrono::milliseconds(1));
        }
        // deadline sweep only when something can actually expire — a
        // per-iteration full slot scan would contend the dispatch path
        if (now_steady_ns() >=
            self->next_sweep_ns_.load(std::memory_order_relaxed))
          self->sweep_async_deadlines();
      }
    });
  }

  void join_reader() {
    std::thread t;
    {
      std::lock_guard<std::mutex> g(reader_mu_);
      t = std::move(reader_);
    }
    if (!t.joinable()) return;
    if (t.get_id() == std::this_thread::get_id()) {
      // close() called from inside an async completion callback (which
      // runs ON the reader thread): self-join would abort the process.
      // Detach — the loop exits right after the callback returns
      // (closing_ is set), and it holds its own shared_ptr, so no
      // use-after-free.
      t.detach();
      return;
    }
    t.join();
  }

  void sweep_async_deadlines() {
    int64_t now = now_steady_ns();
    int64_t next = now + 50 * 1000 * 1000;    // idle: re-check in 50ms
    std::vector<std::pair<uint64_t, SlotPtr>> expired;
    {
      std::lock_guard<std::mutex> g(slots_mu_);
      slots_.for_each([&](uint64_t cid, SlotPtr& sp) {
        if (sp->cb == nullptr) return;
        if (sp->deadline_ns <= now)
          expired.push_back({cid, sp});
        else
          next = std::min(next, sp->deadline_ns);
      });
      for (auto& kv : expired) slots_.erase(kv.first);
    }
    next_sweep_ns_.store(next, std::memory_order_relaxed);
    for (auto& [cid, slot] : expired) {
      bool fire = false;
      {
        std::lock_guard<std::mutex> sg(slot->mu);
        if (!slot->done) {
          slot->done = true;
          slot->error_code = 1008;
          fire = true;
        }
      }
      if (fire)
        slot->cb(slot->cb_user, 1008, "rpc timeout", nullptr, 0, nullptr,
                 0);
    }
  }

  // drain the socket into rbuf_ until EAGAIN/short read; sets *eof on
  // peer close (handled by the caller AFTER buffered frames dispatch, so
  // a response sharing a segment with FIN still reaches its slot);
  // returns the number of bytes read
  ssize_t drain_fd(bool* eof) {
    ssize_t got = 0;
    for (;;) {
      reserve_for_frame(rbuf_);
      size_t chunk = next_read_size(rbuf_);
      ssize_t r = read_into_string(fd_, rbuf_, chunk);
      if (r > 0) {
        got += r;
        if ((size_t)r < chunk) break;   // socket buffer drained
      } else if (r == 0) {
        *eof = true;
        break;
      } else {
        break;  // EAGAIN (fd is nonblocking)
      }
    }
    return got;
  }

  // Read whatever is available (one optimistic drain, else poll up to
  // timeout_ms and drain), dispatch complete frames into slots; returns
  // true if bytes were read.
  bool read_once(int timeout_ms) {
    // optimistic drain first: under pipelining/1-core scheduling the
    // response is often already buffered, making poll() a wasted syscall
    bool eof = false;
    ssize_t got = drain_fd(&eof);
    if (got == 0 && !eof) {
      struct pollfd pfd{fd_, POLLIN, 0};
      if (::poll(&pfd, 1, timeout_ms) <= 0) return false;
      got = drain_fd(&eof);
    }
    bool any = got > 0;
    size_t off = 0;
    while (rbuf_.size() - off >= kHeaderSize) {
      const uint8_t* p = (const uint8_t*)rbuf_.data() + off;
      uint32_t meta_size = get_u32be(p + 4);
      uint32_t body_size = get_u32be(p + 8);
      if (memcmp(p, kMagic, 4) != 0 || meta_size > (1u << 26) ||
          body_size > (1u << 31)) {
        // mid-frame desync is unrecoverable on a byte stream: fail the
        // channel so callers get 1009 now instead of timing out forever
        ::shutdown(fd_, SHUT_RDWR);
        closing_.store(true, std::memory_order_release);
        fail_all_pending();
        rbuf_.clear();
        return any;
      }
      size_t total = kHeaderSize + (size_t)meta_size + body_size;
      if (rbuf_.size() - off < total) break;
      if (off == 0 && total == rbuf_.size()) {
        // exactly one frame in the buffer: move it into the slot instead
        // of copying the body (bulk responses land here — the read
        // buffer was pre-reserved to the frame size)
        std::string whole;
        whole.swap(rbuf_);
        const uint8_t* wp = (const uint8_t*)whole.data();
        dispatch_frame(wp + kHeaderSize, meta_size,
                       wp + kHeaderSize + meta_size, body_size, &whole);
        off = 0;
        break;
      }
      dispatch_frame(p + kHeaderSize, meta_size, p + kHeaderSize + meta_size,
                     body_size);
      off += total;
    }
    if (off > 0) rbuf_.erase(0, off);
    if (eof) {
      // peer EOF — processed only after the dispatch loop above, so
      // responses riding the final segment were delivered.  shutdown
      // (not close) so the fd number cannot be recycled while concurrent
      // writers still reference it; the destructor does the close
      ::shutdown(fd_, SHUT_RDWR);
      closing_.store(true, std::memory_order_release);
      fail_all_pending();
    }
    return any;
  }

  // Fill a slot from a complete frame.  `owned` non-null hands the WHOLE
  // buffer to the slot (zero-copy: the reader's rbuf is moved when it
  // holds exactly one frame — the common shape for bulk responses, and
  // ~20% of per-byte CPU on the large-request path); otherwise the body
  // is copied out of the shared read buffer.
  void dispatch_frame(const uint8_t* meta_p, size_t meta_len,
                      const uint8_t* body, size_t body_len,
                      std::string* owned = nullptr) {
    RpcMeta meta;
    if (!decode_meta(meta_p, meta_p + meta_len, &meta)) return;
    SlotPtr slot;
    {
      std::lock_guard<std::mutex> g(slots_mu_);
      SlotPtr* p = slots_.seek(meta.correlation_id);
      if (p != nullptr) {
        slot = *p;                    // shared ref held past mu
        if (slot->cb != nullptr)
          slots_.erase(meta.correlation_id);         // async: done here
      }
    }
    if (slot == nullptr) return;  // timed out / stale: drop
    size_t att = std::min((size_t)meta.attachment_size, body_len);
    size_t payload_len = body_len - att;
    nrpc_async_cb cb = nullptr;
    void* cb_user = nullptr;
    {
      std::lock_guard<std::mutex> sg(slot->mu);
      if (slot->done) return;       // async timeout sweep beat us
      slot->error_code = meta.response.error_code;
      slot->error_text = meta.response.error_text;
      if (owned != nullptr) {
        size_t body_off = (const char*)body - owned->data();
        slot->storage = std::move(*owned);
        slot->p_off = body_off;
      } else {
        slot->storage.assign((const char*)body, body_len);
        slot->p_off = 0;
      }
      slot->p_len = payload_len;
      slot->a_off = slot->p_off + payload_len;
      slot->a_len = att;
      slot->done = true;
      slot->cv.notify_all();
      cb = slot->cb;
      cb_user = slot->cb_user;
    }
    if (cb != nullptr)              // async completion, outside slot->mu
      cb(cb_user, slot->error_code, slot->error_text.c_str(),
         (const uint8_t*)slot->storage.data() + slot->p_off, slot->p_len,
         (const uint8_t*)slot->storage.data() + slot->a_off, slot->a_len);
  }

  int fd_ = -1;
  std::atomic<bool> closing_{false};
  std::atomic<uint64_t> next_cid_{0};
  std::mutex wmu_;
  std::mutex read_mu_;
  std::string rbuf_;
  std::mutex slots_mu_;
  nbase::FlatMap64<SlotPtr> slots_;   // correlation hot path (flat_map.h)
  std::mutex reader_mu_;
  std::thread reader_;
  std::atomic<int64_t> next_sweep_ns_{0};
};

// Pooled multi-connection channel (reference: pooled sockets,
// src/brpc/socket.h:256-262) — N connections round-robined per call so
// large requests overlap in the kernel instead of serializing on one
// stream.  This is the reference's 2.3 GB/s "pooled large messages"
// deployment shape (docs/cn/benchmark.md:104).
class NativePool {
 public:
  bool connect_to(const char* host, int port, int nconns) {
    for (int i = 0; i < (nconns < 1 ? 1 : nconns); ++i) {
      auto c = std::make_shared<NativeChannel>();
      if (!c->connect_to(host, port)) return false;
      conns_.push_back(std::move(c));
    }
    return true;
  }

  std::shared_ptr<NativeChannel> pick() {
    return conns_[rr_.fetch_add(1, std::memory_order_relaxed)
                  % conns_.size()];
  }

  void close_all() {
    for (auto& c : conns_) c->close_ch();
  }

  size_t size() const { return conns_.size(); }

 private:
  std::vector<std::shared_ptr<NativeChannel>> conns_;
  std::atomic<uint64_t> rr_{0};
};


// ====================================================================
// handle registries.  shared_ptr ownership: a stop/close erases the map
// entry, but callers that already resolved the handle keep the object
// alive until they return — no free-under-caller (the registry is the
// versioned-id check; the shared_ptr is the reference count the C ABI
// can't express).
// ====================================================================

static std::mutex g_handles_mu;
// Leaked on purpose (as ici_native.cpp's listener registries): destructing
// NativeServer/NativeChannel from static teardown joins epoll/reader
// threads concurrently with process exit, the abort-at-exit flake.
static auto& g_servers =
    *new std::unordered_map<uint64_t, std::shared_ptr<NativeServer>>();
static auto& g_channels =
    *new std::unordered_map<uint64_t, std::shared_ptr<NativeChannel>>();
static auto& g_pools =
    *new std::unordered_map<uint64_t, std::shared_ptr<NativePool>>();
static std::atomic<uint64_t> g_next_handle{1};

static std::shared_ptr<NativeServer> find_server(uint64_t h) {
  std::lock_guard<std::mutex> g(g_handles_mu);
  auto it = g_servers.find(h);
  return it == g_servers.end() ? nullptr : it->second;
}

static std::shared_ptr<NativeChannel> find_channel(uint64_t h) {
  std::lock_guard<std::mutex> g(g_handles_mu);
  auto it = g_channels.find(h);
  return it == g_channels.end() ? nullptr : it->second;
}

static std::shared_ptr<NativePool> find_pool(uint64_t h) {
  std::lock_guard<std::mutex> g(g_handles_mu);
  auto it = g_pools.find(h);
  return it == g_pools.end() ? nullptr : it->second;
}

// Shared sync-call → C-ABI-outputs marshalling (channel and pool paths).
static uint64_t call_and_fill_outputs(
    const std::shared_ptr<NativeChannel>& c, const char* method,
    const uint8_t* req, uint64_t req_len, const uint8_t* att,
    uint64_t att_len, int64_t timeout_us, uint8_t** resp_out,
    uint64_t* resp_len, uint8_t** att_out, uint64_t* att_out_len,
    char** err_text_out) {
  CallResult out;
  std::string err_text;
  uint64_t rc = c->call(method, req, req_len, att, att_len, timeout_us,
                        &out, &err_text);
  if (out.p_len) {
    *resp_out = (uint8_t*)malloc(out.p_len);
    memcpy(*resp_out, out.payload(), out.p_len);
    *resp_len = out.p_len;
  }
  if (out.a_len) {
    *att_out = (uint8_t*)malloc(out.a_len);
    memcpy(*att_out, out.attachment(), out.a_len);
    *att_out_len = out.a_len;
  }
  if (!err_text.empty()) {
    *err_text_out = (char*)malloc(err_text.size() + 1);
    memcpy(*err_text_out, err_text.c_str(), err_text.size() + 1);
  }
  return rc;
}


}  // namespace nrpc

// ====================================================================
// the raw epoll echo (native/core.cpp): bytes in, the same bytes out
// ====================================================================

namespace core {

static void set_nonblock(int fd) {
  fcntl(fd, F_SETFL, fcntl(fd, F_GETFL, 0) | O_NONBLOCK);
}


struct EchoServer {
  int listen_fd{-1};
  int epfd{-1};
  int port{0};
  std::thread thread;
  std::atomic<bool> stop{false};
  std::atomic<uint64_t> messages{0};

  bool start() {
    listen_fd = socket(AF_INET, SOCK_STREAM, 0);
    int one = 1;
    setsockopt(listen_fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
    sockaddr_in addr{};
    addr.sin_family = AF_INET;
    addr.sin_addr.s_addr = htonl(INADDR_LOOPBACK);
    addr.sin_port = 0;
    if (bind(listen_fd, (sockaddr*)&addr, sizeof(addr)) != 0) return false;
    socklen_t len = sizeof(addr);
    getsockname(listen_fd, (sockaddr*)&addr, &len);
    port = ntohs(addr.sin_port);
    listen(listen_fd, 64);
    set_nonblock(listen_fd);
    epfd = epoll_create1(0);
    epoll_event ev{};
    ev.events = EPOLLIN;
    ev.data.fd = listen_fd;
    epoll_ctl(epfd, EPOLL_CTL_ADD, listen_fd, &ev);
    thread = std::thread([this] { run(); });
    return true;
  }

  void run() {
    epoll_event events[64];
    char buf[65536];
    while (!stop.load(std::memory_order_relaxed)) {
      int n = epoll_wait(epfd, events, 64, 100);
      for (int i = 0; i < n; ++i) {
        int fd = events[i].data.fd;
        if (fd == listen_fd) {
          for (;;) {
            int c = accept(listen_fd, nullptr, nullptr);
            if (c < 0) break;
            set_nonblock(c);
            int one = 1;
            setsockopt(c, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
            epoll_event cev{};
            cev.events = EPOLLIN;
            cev.data.fd = c;
            epoll_ctl(epfd, EPOLL_CTL_ADD, c, &cev);
          }
          continue;
        }
        for (;;) {  // echo until EAGAIN (edge-ish drain)
          ssize_t r = read(fd, buf, sizeof(buf));
          if (r > 0) {
            ssize_t off = 0;
            while (off < r) {
              ssize_t w = write(fd, buf + off, r - off);
              if (w <= 0) break;
              off += w;
            }
            messages.fetch_add(1, std::memory_order_relaxed);
          } else if (r == 0) {
            epoll_ctl(epfd, EPOLL_CTL_DEL, fd, nullptr);
            close(fd);
            break;
          } else {
            break;  // EAGAIN
          }
        }
      }
    }
  }

  void shutdown() {
    stop.store(true);
    if (thread.joinable()) thread.join();
    if (listen_fd >= 0) close(listen_fd);
    if (epfd >= 0) close(epfd);
  }
};

}  // namespace core

// ====================================================================
// C ABI (the TCP datapath and its bench entries)
// ====================================================================

#pragma GCC visibility push(default)
extern "C" {

uint64_t brpc_tpu_nserver_start(int port) {
  auto s = std::make_shared<nrpc::NativeServer>();
  if (!s->start(port)) return 0;
  uint64_t h = nrpc::g_next_handle.fetch_add(1);
  s->set_handle(h);
  std::lock_guard<std::mutex> g(nrpc::g_handles_mu);
  nrpc::g_servers[h] = s;
  return h;
}

int brpc_tpu_nserver_port(uint64_t h) {
  auto s = nrpc::find_server(h);
  return s == nullptr ? -1 : s->port();
}

int brpc_tpu_nserver_register_echo(uint64_t h, const char* full_method) {
  auto s = nrpc::find_server(h);
  if (s == nullptr) return -1;
  s->register_echo(full_method);
  return 0;
}

int brpc_tpu_nserver_set_handler(uint64_t h, nrpc::py_request_fn fn) {
  auto s = nrpc::find_server(h);
  if (s == nullptr) return -1;
  s->set_py_handler(fn);
  return 0;
}

uint64_t brpc_tpu_nserver_requests(uint64_t h) {
  auto s = nrpc::find_server(h);
  return s == nullptr ? 0 : s->requests();
}

int brpc_tpu_nserver_respond(uint64_t token, uint64_t err,
                             const char* err_text, const uint8_t* data,
                             uint64_t len, const uint8_t* att,
                             uint64_t att_len) {
  nrpc::PendingReply pr;
  {
    std::lock_guard<std::mutex> g(nrpc::g_tokens_mu);
    if (!nrpc::g_tokens.take(token, &pr)) return -1;
  }
  // resolve by handle: a stopped server no longer resolves (its tokens
  // were purged too; this is belt-and-braces for the in-between window)
  auto s = nrpc::find_server(pr.server_handle);
  if (s == nullptr) return -1;
  bool ok = s->respond(pr.conn_id, pr.cid, err, err_text ? err_text : "",
                       data, len, att, att_len);
  return ok ? 0 : -2;
}

void brpc_tpu_nserver_stop(uint64_t h) {
  std::shared_ptr<nrpc::NativeServer> s;
  {
    std::lock_guard<std::mutex> g(nrpc::g_handles_mu);
    auto it = nrpc::g_servers.find(h);
    if (it == nrpc::g_servers.end()) return;
    s = it->second;
    nrpc::g_servers.erase(it);
  }
  s->stop();   // frees when the last concurrent resolver drops its ref
}

uint64_t brpc_tpu_nchannel_connect(const char* host, int port) {
  auto c = std::make_shared<nrpc::NativeChannel>();
  if (!c->connect_to(host, port)) return 0;
  uint64_t h = nrpc::g_next_handle.fetch_add(1);
  std::lock_guard<std::mutex> g(nrpc::g_handles_mu);
  nrpc::g_channels[h] = c;
  return h;
}

// Returns error code (0 ok).  Response/attachment/error-text returned as
// malloc'd buffers the caller frees with brpc_tpu_buf_free.
uint64_t brpc_tpu_nchannel_call(uint64_t h, const char* method,
                                const uint8_t* req, uint64_t req_len,
                                const uint8_t* att, uint64_t att_len,
                                int64_t timeout_us, uint8_t** resp_out,
                                uint64_t* resp_len, uint8_t** att_out,
                                uint64_t* att_out_len, char** err_text_out) {
  *resp_out = nullptr; *resp_len = 0;
  *att_out = nullptr; *att_out_len = 0;
  *err_text_out = nullptr;
  auto c = nrpc::find_channel(h);    // shared ref: close can't free mid-call
  if (c == nullptr) return 1009;
  return nrpc::call_and_fill_outputs(c, method, req, req_len, att, att_len,
                                     timeout_us, resp_out, resp_len,
                                     att_out, att_out_len, err_text_out);
}

// Async call: `cb` fires exactly once from the channel's reader thread
// (response, timeout, or failure).  Returns 0 when the request was
// written; on synchronous failure the callback has already fired.
uint64_t brpc_tpu_nchannel_call_async(uint64_t h, const char* method,
                                      const uint8_t* req, uint64_t req_len,
                                      const uint8_t* att, uint64_t att_len,
                                      int64_t timeout_us,
                                      nrpc::nrpc_async_cb cb, void* user) {
  auto c = nrpc::find_channel(h);
  if (c == nullptr) {
    cb(user, 1009, "channel not found", nullptr, 0, nullptr, 0);
    return 1009;
  }
  return c->call_async(method, req, req_len, att, att_len, timeout_us, cb,
                       user);
}

// ---- pooled multi-connection channel ----

uint64_t brpc_tpu_npool_connect(const char* host, int port, int nconns) {
  auto p = std::make_shared<nrpc::NativePool>();
  if (!p->connect_to(host, port, nconns)) return 0;
  uint64_t h = nrpc::g_next_handle.fetch_add(1);
  std::lock_guard<std::mutex> g(nrpc::g_handles_mu);
  nrpc::g_pools[h] = p;
  return h;
}

uint64_t brpc_tpu_npool_call(uint64_t h, const char* method,
                             const uint8_t* req, uint64_t req_len,
                             const uint8_t* att, uint64_t att_len,
                             int64_t timeout_us, uint8_t** resp_out,
                             uint64_t* resp_len, uint8_t** att_out,
                             uint64_t* att_out_len, char** err_text_out) {
  *resp_out = nullptr; *resp_len = 0;
  *att_out = nullptr; *att_out_len = 0;
  *err_text_out = nullptr;
  auto p = nrpc::find_pool(h);
  if (p == nullptr) return 1009;
  return nrpc::call_and_fill_outputs(p->pick(), method, req, req_len, att,
                                     att_len, timeout_us, resp_out,
                                     resp_len, att_out, att_out_len,
                                     err_text_out);
}

void brpc_tpu_npool_close(uint64_t h) {
  std::shared_ptr<nrpc::NativePool> p;
  {
    std::lock_guard<std::mutex> g(nrpc::g_handles_mu);
    auto it = nrpc::g_pools.find(h);
    if (it == nrpc::g_pools.end()) return;
    p = it->second;
    nrpc::g_pools.erase(it);
  }
  p->close_all();
}


void brpc_tpu_nchannel_close(uint64_t h) {
  std::shared_ptr<nrpc::NativeChannel> c;
  {
    std::lock_guard<std::mutex> g(nrpc::g_handles_mu);
    auto it = nrpc::g_channels.find(h);
    if (it == nrpc::g_channels.end()) return;
    c = it->second;
    nrpc::g_channels.erase(it);
  }
  c->close_ch();   // destructor (and the fd close) runs when the last
                   // in-flight call drops its reference
}

// Full-native-stack echo benchmark: channel → frame → epoll server →
// dispatch → response → correlation wake, all in this library.  Measures
// per-call round trips the way example/echo_c++'s client does.  Returns
// p50 ns (-1 failure).
int64_t brpc_tpu_native_rpc_echo_p50_ns(int iters, int payload_len) {
  uint64_t sh = brpc_tpu_nserver_start(0);
  if (sh == 0) return -1;
  brpc_tpu_nserver_register_echo(sh, "EchoService.Echo");
  int port = brpc_tpu_nserver_port(sh);
  uint64_t ch = brpc_tpu_nchannel_connect("127.0.0.1", port);
  if (ch == 0) {
    brpc_tpu_nserver_stop(sh);
    return -1;
  }
  std::string payload(payload_len, 'x');
  std::vector<int64_t> lat;
  lat.reserve(iters);
  auto now_ns = [] {
    return std::chrono::duration_cast<std::chrono::nanoseconds>(
               std::chrono::steady_clock::now().time_since_epoch())
        .count();
  };
  auto c = nrpc::find_channel(ch);
  for (int i = 0; i < iters + 50; ++i) {
    nrpc::CallResult out;
    std::string err;
    int64_t t0 = now_ns();
    uint64_t rc = c->call("EchoService.Echo", payload.data(), payload.size(),
                          nullptr, 0, 5 * 1000 * 1000, &out, &err);
    int64_t t1 = now_ns();
    if (rc != 0 || out.p_len != payload.size()) {
      brpc_tpu_nchannel_close(ch);
      brpc_tpu_nserver_stop(sh);
      return -1;
    }
    if (i >= 50) lat.push_back(t1 - t0);
  }
  brpc_tpu_nchannel_close(ch);
  brpc_tpu_nserver_stop(sh);
  std::sort(lat.begin(), lat.end());
  return lat[lat.size() / 2];
}

// Multi-threaded native QPS benchmark (the multi_threaded_echo_c++ config):
// `threads` client threads, one connection each, run for duration_ms.
double brpc_tpu_native_rpc_qps(int threads, int duration_ms,
                               int payload_len) {
  uint64_t sh = brpc_tpu_nserver_start(0);
  if (sh == 0) return -1.0;
  brpc_tpu_nserver_register_echo(sh, "EchoService.Echo");
  int port = brpc_tpu_nserver_port(sh);
  std::atomic<uint64_t> count{0};
  std::atomic<bool> stop{false};
  std::vector<std::thread> ts;
  for (int t = 0; t < threads; ++t) {
    ts.emplace_back([&, t] {
      uint64_t ch = brpc_tpu_nchannel_connect("127.0.0.1", port);
      if (ch == 0) return;
      auto c = nrpc::find_channel(ch);
      std::string payload(payload_len, 'x');
      while (!stop.load(std::memory_order_relaxed)) {
        nrpc::CallResult out;
        std::string err;
        uint64_t rc = c->call("EchoService.Echo", payload.data(),
                              payload.size(), nullptr, 0, 5 * 1000 * 1000,
                              &out, &err);
        if (rc == 0) count.fetch_add(1, std::memory_order_relaxed);
      }
      brpc_tpu_nchannel_close(ch);
    });
  }
  auto t0 = std::chrono::steady_clock::now();
  std::this_thread::sleep_for(std::chrono::milliseconds(duration_ms));
  stop.store(true);
  for (auto& th : ts) th.join();
  double secs = std::chrono::duration<double>(
                    std::chrono::steady_clock::now() - t0)
                    .count();
  brpc_tpu_nserver_stop(sh);
  return count.load() / secs;
}

// Large-request throughput, 1 client → 1 server (the reference's headline
// "2.3 GB/s pooled large messages" config, docs/cn/benchmark.md:104).
// `threads` concurrent callers on separate connections keep the pipe
// full; reported number counts request payload bytes only (matching the
// reference, which measures request throughput).
double brpc_tpu_native_rpc_throughput_gbps(int threads, int duration_ms,
                                           int payload_len) {
  uint64_t sh = brpc_tpu_nserver_start(0);
  if (sh == 0) return -1.0;
  brpc_tpu_nserver_register_echo(sh, "EchoService.Echo");
  int port = brpc_tpu_nserver_port(sh);
  std::atomic<uint64_t> bytes{0};
  std::atomic<bool> stop{false};
  std::vector<std::thread> ts;
  for (int t = 0; t < threads; ++t) {
    ts.emplace_back([&] {
      uint64_t ch = brpc_tpu_nchannel_connect("127.0.0.1", port);
      if (ch == 0) return;
      auto c = nrpc::find_channel(ch);
      std::string payload(payload_len, 'x');
      while (!stop.load(std::memory_order_relaxed)) {
        nrpc::CallResult out;
        std::string err;
        uint64_t rc = c->call("EchoService.Echo", payload.data(),
                              payload.size(), nullptr, 0, 30 * 1000 * 1000,
                              &out, &err);
        if (rc == 0)
          bytes.fetch_add(payload.size(), std::memory_order_relaxed);
      }
      brpc_tpu_nchannel_close(ch);
    });
  }
  auto t0 = std::chrono::steady_clock::now();
  std::this_thread::sleep_for(std::chrono::milliseconds(duration_ms));
  stop.store(true);
  for (auto& th : ts) th.join();
  double secs = std::chrono::duration<double>(
                    std::chrono::steady_clock::now() - t0)
                    .count();
  brpc_tpu_nserver_stop(sh);
  return bytes.load() / secs / 1e9;
}

// Pipelined large-request throughput: ONE connection, `depth` requests
// in flight via the async API — the KeepWrite batching shape
// (socket.cpp:1685): the writer never waits for a response before
// sending the next request, so there is no ping-pong bubble.
double brpc_tpu_native_async_throughput_gbps(int depth, int duration_ms,
                                             int payload_len) {
  uint64_t sh = brpc_tpu_nserver_start(0);
  if (sh == 0) return -1.0;
  brpc_tpu_nserver_register_echo(sh, "EchoService.Echo");
  int port = brpc_tpu_nserver_port(sh);
  uint64_t ch = brpc_tpu_nchannel_connect("127.0.0.1", port);
  if (ch == 0) {
    brpc_tpu_nserver_stop(sh);
    return -1.0;
  }
  auto c = nrpc::find_channel(ch);
  struct Ctl {
    std::mutex mu;
    std::condition_variable cv;
    int inflight = 0;
    uint64_t bytes = 0;
    uint64_t errors = 0;
  } ctl;
  auto cb = +[](void* user, uint64_t err, const char*, const uint8_t*,
                uint64_t resp_len, const uint8_t*, uint64_t) {
    Ctl* ctl = (Ctl*)user;
    std::lock_guard<std::mutex> g(ctl->mu);
    ctl->inflight--;
    if (err == 0) ctl->bytes += resp_len;
    else ctl->errors++;
    ctl->cv.notify_all();
  };
  std::string payload(payload_len, 'x');
  auto t0 = std::chrono::steady_clock::now();
  auto stop_at = t0 + std::chrono::milliseconds(duration_ms);
  while (std::chrono::steady_clock::now() < stop_at) {
    {
      std::unique_lock<std::mutex> g(ctl.mu);
      nbase::cv_wait_for(ctl.cv, g, std::chrono::milliseconds(100),
                         [&] { return ctl.inflight < depth; });
      if (ctl.inflight >= depth) continue;
      ctl.inflight++;
    }
    c->call_async("EchoService.Echo", payload.data(), payload.size(),
                  nullptr, 0, 30 * 1000 * 1000, cb, &ctl);
  }
  {
    std::unique_lock<std::mutex> g(ctl.mu);
    nbase::cv_wait_for(ctl.cv, g, std::chrono::seconds(30),
                       [&] { return ctl.inflight == 0; });
  }
  double secs = std::chrono::duration<double>(
                    std::chrono::steady_clock::now() - t0)
                    .count();
  uint64_t bytes;
  {
    std::lock_guard<std::mutex> g(ctl.mu);
    bytes = ctl.bytes;
  }
  brpc_tpu_nchannel_close(ch);
  brpc_tpu_nserver_stop(sh);
  return bytes / secs / 1e9;
}

// Pooled large-request throughput: `threads` callers sharing ONE pool of
// `nconns` connections (round-robin per call) — the reference's pooled
// 2.3 GB/s configuration, docs/cn/benchmark.md:104.
double brpc_tpu_native_pooled_throughput_gbps(int nconns, int threads,
                                              int duration_ms,
                                              int payload_len) {
  uint64_t sh = brpc_tpu_nserver_start(0);
  if (sh == 0) return -1.0;
  brpc_tpu_nserver_register_echo(sh, "EchoService.Echo");
  int port = brpc_tpu_nserver_port(sh);
  uint64_t ph = brpc_tpu_npool_connect("127.0.0.1", port, nconns);
  if (ph == 0) {
    brpc_tpu_nserver_stop(sh);
    return -1.0;
  }
  auto pool = nrpc::find_pool(ph);
  std::atomic<uint64_t> bytes{0};
  std::atomic<bool> stop{false};
  std::vector<std::thread> ts;
  for (int t = 0; t < threads; ++t) {
    ts.emplace_back([&] {
      std::string payload(payload_len, 'x');
      while (!stop.load(std::memory_order_relaxed)) {
        auto c = pool->pick();
        nrpc::CallResult out;
        std::string err;
        uint64_t rc = c->call("EchoService.Echo", payload.data(),
                              payload.size(), nullptr, 0, 30 * 1000 * 1000,
                              &out, &err);
        if (rc == 0)
          bytes.fetch_add(payload.size(), std::memory_order_relaxed);
      }
    });
  }
  auto t0 = std::chrono::steady_clock::now();
  std::this_thread::sleep_for(std::chrono::milliseconds(duration_ms));
  stop.store(true);
  for (auto& th : ts) th.join();
  double secs = std::chrono::duration<double>(
                    std::chrono::steady_clock::now() - t0)
                    .count();
  brpc_tpu_npool_close(ph);
  brpc_tpu_nserver_stop(sh);
  return bytes.load() / secs / 1e9;
}

// Runs a native echo latency benchmark: starts the epoll echo server,
// does `iters` blocking round-trips of `payload` bytes, returns p50
// nanoseconds (-1 on failure).
int64_t brpc_tpu_native_echo_p50_ns(int iters, int payload) {
  core::EchoServer server;
  if (!server.start()) return -1;
  int fd = socket(AF_INET, SOCK_STREAM, 0);
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_addr.s_addr = htonl(INADDR_LOOPBACK);
  addr.sin_port = htons(server.port);
  if (connect(fd, (sockaddr*)&addr, sizeof(addr)) != 0) {
    server.shutdown();
    return -1;
  }
  int one = 1;
  setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  std::vector<char> buf(payload, 'x');
  std::vector<char> rbuf(payload);
  std::vector<int64_t> lat;
  lat.reserve(iters);
  auto now_ns = [] {
    return std::chrono::duration_cast<std::chrono::nanoseconds>(
               std::chrono::steady_clock::now().time_since_epoch())
        .count();
  };
  for (int i = 0; i < iters + 20; ++i) {
    int64_t t0 = now_ns();
    ssize_t w = write(fd, buf.data(), payload);
    (void)w;
    ssize_t got = 0;
    while (got < payload) {
      ssize_t r = read(fd, rbuf.data() + got, payload - got);
      if (r <= 0) break;
      got += r;
    }
    if (i >= 20) lat.push_back(now_ns() - t0);
  }
  close(fd);
  server.shutdown();
  if (lat.empty()) return -1;
  std::sort(lat.begin(), lat.end());
  return lat[lat.size() / 2];
}

}  // extern "C"
#pragma GCC visibility pop

#endif  // __linux__
