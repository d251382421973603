// The native ici:// datapath of brpc_tpu_torch: the in-process front door's
// framing, dispatch and correlation in C++.
//
// A trimmed copy of the reference fabric's C++ core (native/rpc.cpp of the
// JAX package), kept byte for byte where it is kept: the ici:// in-process
// plane (listeners, connections with their credit window, the batched
// request upcall, the native attachment-custody table, the respond path)
// and its C ABI, with the C++ echo loop.  The proto3 meta codec and the
// TRPC framing live in trpc_codec.h; the TCP server, channel and pool are
// rpc_native.cpp, linked into the same library.  Python reaches this file
// through ctypes only (butil/native.py); the one Python on the datapath is
// the relocation upcall, which moves a device ref that is not resident on
// the target rank.
//
// Build: g++ -O2 -fPIC -shared -pthread -fvisibility=hidden -Wl,-Bsymbolic
// with rpc_native.cpp at first use (butil/native.py), into
// brpc_tpu_torch/_build/.  Hidden
// visibility keeps every internal symbol (and every static registry) of
// this library its own, so a process that also loads the reference's
// core holds two separate sets of ici listeners.

#include "tsan_compat.h"

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
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
#include <sys/uio.h>
#include <unistd.h>
#include <algorithm>

namespace nrpc {

#include "trpc_codec.h"

// ====================================================================
// ici:// in-process plane: the native device-endpoint datapath.
//
// Analogue of the reference's RDMA endpoint (rdma_endpoint.cpp): control
// frames (TRPC header+meta+payload+host-attachment bytes) move through
// the native codec above; bulk device payloads ride a sidecar of
// "device refs" — {key, nbytes, resident-device} descriptors naming
// arrays held alive by a Python-side registry (the SGE list of a
// zero-copy post, rdma_endpoint.cpp:771 CutFromIOBufList).  The ONLY
// Python on the datapath is the relocation upcall, and only when a ref
// is not already resident on the target device (the HBM→HBM ICI
// device_put); a resident ref passes through with zero upcalls.
//
// Custody discipline for refs (mirrors the completion-driven _sbuf free,
// rdma_endpoint.cpp:926): a key entering native custody (call/respond)
// leaves it either INTO Python (an upcall or a returned response — the
// Python side takes it from the registry) or by an explicit release
// upcall on drop paths (timeout, dead peer, relocation).  Exactly one
// exit per key: the registry can never leak or free-under-use.
// ====================================================================

struct IciSegC {
  uint64_t key;      // registry key for device segs; unused for host segs
  uint64_t nbytes;   // logical byte length of this attachment segment
  int32_t dev;       // resident device id (device segs)
  int32_t is_dev;    // 1 = device ref, 0 = host bytes (span of att_host)
};

// (key, target_dev, err, err_cap) -> new key; 0 = failure, with the
// reason written NUL-terminated into err (at most err_cap bytes)
typedef uint64_t (*py_relocate_fn)(uint64_t key, int32_t target_dev,
                                   char* err, uint32_t err_cap);
typedef void (*py_release_fn)(uint64_t key);
// (token, method, payload, len, att_host, att_host_len, segs, nsegs,
//  log_id, peer_dev): the unbatched handler slot (null for the C++ echo
//  loop's echo-only listener)
typedef void (*py_ici_request_fn)(uint64_t token, const char* method,
                                  const uint8_t* payload,
                                  uint64_t payload_len,
                                  const uint8_t* att_host,
                                  uint64_t att_host_len,
                                  const IciSegC* segs, uint64_t nsegs,
                                  uint64_t log_id, int32_t peer_dev);

// ---- one-struct batched upcall ABI -------------------------------------
// The Python-handler tier's request boundary: ONE ctypes crossing hands
// the handler tier an array of packed request structs (method id,
// correlation token, deadline metadata, payload views), and one crossing
// takes an array of packed response structs back
// (brpc_tpu_ici_respond_batch).  Replaces the per-request 10-argument
// upcall + 9-argument respond chatter: under load the GIL acquisition
// and argument marshalling amortize over the whole batch.
struct IciReqC {
  uint64_t token;          // respond exactly once with this token
  const char* method;      // "Service.Method"
  const uint8_t* payload;  // request body (borrowed for the upcall)
  uint64_t payload_len;
  const uint8_t* att_host; // host-attachment bytes (borrowed)
  uint64_t att_host_len;
  const IciSegC* segs;     // device-ref sidecar; Python TAKES the keys
  uint64_t nsegs;
  uint64_t log_id;
  int64_t recv_ns;         // steady-clock enqueue stamp (queue stage)
  int32_t peer_dev;
  int32_t _pad;
  // admission-control propagation (appended: earlier fields keep their
  // offsets for the ctypes mirror).  priority stays WIRE-encoded
  // (0 = unset, 1..N = band 0..N-1); tenant is borrowed for the upcall.
  const char* tenant;
  uint64_t deadline_left_ms;
  int32_t priority;
  int32_t _pad2;
  // native attachment custody (appended): nonzero means the
  // device-seg list is PARKED in the native att table under this
  // handle instead of being taken by Python during the upcall.  Python
  // wraps it lazily and exits custody exactly once — pass the handle
  // back in IciRespC.att_handle (echo pass-through), take the keys via
  // brpc_tpu_ici_att_take at materialization, or dispose it
  // (brpc_tpu_ici_att_dispose) at Controller pool-recycle.  segs/nsegs
  // still point at the parked list (heap-stable while the handle
  // lives) for callers that need the full walk; seg0_* mirrors
  // segs[0] inline so the dominant one-seg shape is readable with
  // plain struct field loads instead of a ctypes pointer deref.
  uint64_t att_handle;
  uint64_t seg0_key;
  uint64_t seg0_nbytes;
  int32_t seg0_dev;
  int32_t _pad3;
};
// (reqs, n): process each request; every token answered exactly once
typedef void (*py_ici_batch_fn)(const IciReqC* reqs, uint64_t n);

struct IciRespC {
  uint64_t token;
  uint64_t err;            // 0 = success
  const char* err_text;    // may be null
  const uint8_t* data;     // response payload (borrowed for the call)
  uint64_t len;
  const uint8_t* att_host;
  uint64_t att_host_len;
  const IciSegC* segs;     // custody of device keys transfers to native
  uint64_t nsegs;
  uint64_t retry_after_ms; // admission shed hint, 0 = none
  // native custody pass-through (appended): nonzero names a
  // parked att-table entry whose seg list IS this response's device
  // attachment — the echo shape never walks segs in Python.  segs/
  // nsegs are ignored when set.
  uint64_t att_handle;
};

static inline int64_t ici_now_ns() {
  return std::chrono::duration_cast<std::chrono::nanoseconds>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

static std::atomic<py_relocate_fn> g_ici_relocate{nullptr};
static std::atomic<py_release_fn> g_ici_release{nullptr};

static void ici_release_segs(const std::vector<IciSegC>& segs) {
  py_release_fn rel = g_ici_release.load(std::memory_order_acquire);
  if (rel == nullptr) return;
  for (const auto& s : segs)
    if (s.is_dev) rel(s.key);
}

// ---- native-owned attachment custody table ----------------
// One entry parks a whole device-seg list under an opaque handle, so
// the Python handler tier never walks segs or touches its device-ref
// registry on the hot path: the handle moves with the structs
// (IciReqC.att_handle in, IciRespC.att_handle back out on the echo
// pass-through) and exits custody EXACTLY once — pass-back, take
// (Python assumed the keys), or dispose (keys released via the release
// upcall).  Entries are heap-allocated so IciReqC.segs pointers into
// them stay stable across table rehashes.
struct IciAttEntry {
  std::vector<IciSegC> segs;
};
static std::mutex g_ici_atts_mu;
// Leaked like the other registries (see g_ici_listeners): static
// teardown must never race live holders at exit.
// fablint: guarded-by(g_ici_atts_mu): g_ici_atts
static auto& g_ici_atts = *new nbase::FlatMap64<IciAttEntry*>();
static std::atomic<uint64_t> g_ici_next_att{1};

// Register a parked entry; `out_e` (optional) receives the heap entry
// so callers can point borrowed views (IciReqC.segs) at its stable
// seg storage.  EVERY registration goes through here — the protocol
// (alloc, counter, publish under the lock) has exactly one home.
static uint64_t ici_att_register(std::vector<IciSegC>&& segs,
                                 IciAttEntry** out_e = nullptr) {
  auto* e = new IciAttEntry{std::move(segs)};
  uint64_t h = g_ici_next_att.fetch_add(1);
  {
    std::lock_guard<std::mutex> g(g_ici_atts_mu);
    g_ici_atts[h] = e;
  }
  if (out_e != nullptr) *out_e = e;
  return h;
}

static IciAttEntry* ici_att_pop(uint64_t h) {
  std::lock_guard<std::mutex> g(g_ici_atts_mu);
  IciAttEntry* e = nullptr;
  if (!g_ici_atts.take(h, &e)) return nullptr;
  return e;
}

// A refused relocation fails its call with its own code, not 1009: it is
// no dead connection, so the channel keeps its binding and does not
// re-send the call on the Python plane (EINTERNAL, errors.py)
static constexpr uint64_t kERelocate = 2001;

// Move every non-resident device ref to target_dev via the Python
// upcall (the device plane's copy).  Returns false when the device
// plane can't relocate (caller fails the RPC with *why, the call's own
// error text).  The replaced key is released — its custody ends here.
static bool ici_relocate_segs(std::vector<IciSegC>& segs,
                              int32_t target_dev, std::string* why) {
  py_relocate_fn rf = g_ici_relocate.load(std::memory_order_acquire);
  py_release_fn rel = g_ici_release.load(std::memory_order_acquire);
  for (auto& s : segs) {
    if (!s.is_dev || s.dev == target_dev) continue;
    if (rf == nullptr) {
      *why = "ici relocation failed: no relocation hook";
      return false;
    }
    char err[256];
    err[0] = '\0';
    uint64_t nk = rf(s.key, target_dev, err, sizeof(err));
    if (nk == 0) {
      err[sizeof(err) - 1] = '\0';
      *why = "ici relocation failed";
      if (err[0] != '\0') *why += std::string(": ") + err;
      return false;
    }
    if (nk != s.key && rel != nullptr) rel(s.key);
    s.key = nk;
    s.dev = target_dev;
  }
  return true;
}

struct IciSlot {
  std::mutex mu;
  std::condition_variable cv;
  // lock-free fast-path check: the native echo tier delivers inline
  // before the caller ever reaches its wait, so `done` is usually
  // already true and the mutex/condvar is skipped entirely
  std::atomic<bool> done{false};
  bool abandoned = false;   // waiter timed out; deliver() must release
  uint64_t error_code = 0;
  std::string error_text;
  std::string payload, att_host;
  std::vector<IciSegC> segs;
  uint64_t retry_after_ms = 0;   // admission shed hint
};
using IciSlotPtr = std::shared_ptr<IciSlot>;

class IciServer;

class IciChannel {
 public:
  IciChannel(int32_t local_dev, int32_t remote_dev)
      : local_dev_(local_dev), remote_dev_(remote_dev) {}

  int32_t local_dev() const { return local_dev_; }
  int32_t remote_dev() const { return remote_dev_; }

  IciSlotPtr make_slot(uint64_t* cid) {
    *cid = next_cid_.fetch_add(1) + 1;
    auto slot = std::make_shared<IciSlot>();
    std::lock_guard<std::mutex> g(slots_mu_);
    slots_[*cid] = slot;
    return slot;
  }

  void erase_slot(uint64_t cid) {
    std::lock_guard<std::mutex> g(slots_mu_);
    slots_.erase(cid);
  }

  // Response delivery from the server worker (or respond()).  The slot
  // stays in the map — the WAITER erases it after consuming, so a
  // deliver/timeout race can never strand segs in a slot nobody reads
  // (erase-before-fill leaked device-ref custody and
  // turned an arrived response into a spurious timeout).  A missing or
  // abandoned slot drops the payload and releases ref custody.
  void deliver(uint64_t cid, uint64_t err, std::string err_text,
               std::string payload, std::string att_host,
               std::vector<IciSegC> segs, uint64_t retry_after_ms = 0) {
    IciSlotPtr slot;
    {
      std::lock_guard<std::mutex> g(slots_mu_);
      IciSlotPtr* p = slots_.seek(cid);
      if (p != nullptr) slot = *p;
    }
    if (slot == nullptr) {
      ici_release_segs(segs);
      return;
    }
    {
      std::lock_guard<std::mutex> g(slot->mu);
      if (slot->abandoned) {
        ici_release_segs(segs);
        return;
      }
      slot->error_code = err;
      slot->error_text = std::move(err_text);
      slot->payload = std::move(payload);
      slot->att_host = std::move(att_host);
      slot->segs = std::move(segs);
      slot->retry_after_ms = retry_after_ms;
      slot->done.store(true, std::memory_order_release);
    }
    slot->cv.notify_all();
  }

  void fail_all(uint64_t err, const char* text) {
    // O(1) under the hot lock (per-entry shared_ptr
    // copies stalled concurrent make_slot/deliver for the copy's
    // duration); the table is processed outside it
    nbase::FlatMap64<IciSlotPtr> victims;
    {
      std::lock_guard<std::mutex> g(slots_mu_);
      victims.swap(slots_);
    }
    // victims is private to this frame: process in place, no staging
    victims.for_each([&](uint64_t, IciSlotPtr& sp) {
      {
        std::lock_guard<std::mutex> g(sp->mu);
        if (sp->done.load(std::memory_order_acquire)) return;
        sp->error_code = err;
        sp->error_text = text;
        sp->done.store(true, std::memory_order_release);
      }
      sp->cv.notify_all();
    });
  }

 private:
  int32_t local_dev_, remote_dev_;
  std::atomic<uint64_t> next_cid_{0};
  std::mutex slots_mu_;
  // correlation table on the sub-microsecond path: contiguous
  // open-addressing slots, no per-node allocation (see flat_map.h)
  nbase::FlatMap64<IciSlotPtr> slots_;
};
using IciChannelPtr = std::shared_ptr<IciChannel>;

// One accepted connection: the client→server credit window lives here
// (requests are windowed; responses deliver into a waiting slot, so the
// reverse direction cannot queue unboundedly in-process).
struct IciConn {
  uint64_t id = 0;
  int32_t client_dev = 0;
  std::weak_ptr<IciChannel> client;
  std::shared_ptr<IciServer> server;
  std::mutex wmu;
  std::condition_variable wcv;
  int64_t window_left = 0;
  int64_t window_bytes = 0;
  std::atomic<bool> closed{false};

  void return_credits(int64_t n) {
    {
      std::lock_guard<std::mutex> g(wmu);
      window_left = std::min(window_bytes, window_left + n);
    }
    wcv.notify_all();
  }
};
using IciConnPtr = std::shared_ptr<IciConn>;

struct IciMsg {
  IciConnPtr conn;
  uint64_t cid = 0;
  std::string bytes;             // full TRPC frame (header+meta+payload+att)
  std::vector<IciSegC> segs;
  int64_t wire_bytes = 0;        // credits returned when consumed
};

// A Python-tier request parked in the server's batch queue: owns the
// frame bytes (the IciReqC views point into them) until the upcall
// consumes it.  Credits return when the upcall does.
struct IciBatchItem {
  uint64_t token = 0;
  std::string method;
  std::string bytes;             // full frame; payload/att are spans of it
  size_t payload_off = 0, payload_len = 0, att_len = 0;
  std::vector<IciSegC> segs;
  uint64_t log_id = 0;
  int32_t peer_dev = 0;
  int64_t enq_ns = 0;
  IciConnPtr conn;
  int64_t wire_bytes = 0;
  // admission-control metadata (wire-encoded priority: 0 = unset)
  uint64_t priority = 0;
  std::string tenant;
  uint64_t deadline_left_ms = 0;
};

// Dispatch discipline: the in-process transport's "IO thread" is the
// CALLER — ici_do_call runs the server's frame processing inline on the
// client thread (the reference's usercode-in-IO-thread default,
// baidu_rpc_protocol.cpp:312, specialized to a loopback transport; this
// box may have ONE core, where any thread-hop design serializes both
// sides' wakeups and loses ~100 µs/round).  Python-tier handlers keep
// their isolation anyway: the ServerBinding upcall parks user code on a
// tasklet unless the server opted into usercode_inline.
class IciServer : public std::enable_shared_from_this<IciServer> {
 public:
  // handler arrives at construction so the listener is never visible in
  // a half-initialized state (a racing call between listen and a later
  // set_handler would ENOMETHOD a method that exists)
  explicit IciServer(int32_t dev, py_ici_request_fn handler)
      : dev_(dev), handler_(handler) {}

  void start() {}

  void stop() {
    stop_.store(true, std::memory_order_release);
    // fail queued-but-undelivered Python-tier batch items first: their
    // device refs release and their callers get a specific error instead
    // of a parked request that nothing will ever drain
    std::deque<IciBatchItem> leftover;
    {
      std::lock_guard<std::mutex> g(bq_mu_);
      bq_stopped_ = true;
      leftover.swap(bq_);
    }
    for (auto& it : leftover)
      fail_batch_item(it, 1009, "ici server stopped");
    std::vector<IciConnPtr> conns;
    {
      std::lock_guard<std::mutex> g(conns_mu_);
      for (auto& kv : conns_) conns.push_back(kv.second);
      conns_.clear();
    }
    for (auto& c : conns) {
      c->closed.store(true, std::memory_order_release);
      c->wcv.notify_all();
      if (auto ch = c->client.lock())
        ch->fail_all(1009, "ici server stopped");
    }
  }

  int32_t dev() const { return dev_; }
  void set_handle(uint64_t h) { handle_ = h; }
  uint64_t handle() const { return handle_; }
  uint64_t requests() const { return requests_.load(); }

  void register_echo(const std::string& m) {
    std::lock_guard<std::mutex> g(mmu_);
    echo_methods_.insert({m, true});
  }

  void set_handler(py_ici_request_fn fn) {
    handler_.store(fn, std::memory_order_release);
  }

  void set_batch_handler(py_ici_batch_fn fn) {
    batch_handler_.store(fn, std::memory_order_release);
  }

  // Opt the batched upcall into native att custody (IciReqC.att_handle):
  // OFF by default so an older Python tier on a newer .so keeps the
  // take-during-upcall semantics byte-for-byte.
  void set_att_handles(bool on) {
    att_handles_.store(on, std::memory_order_relaxed);
  }

  void batch_stats(uint64_t* upcalls, uint64_t* requests,
                   uint64_t* max_batch) const {
    *upcalls = upcalls_.load(std::memory_order_relaxed);
    *requests = upcall_reqs_.load(std::memory_order_relaxed);
    *max_batch = batch_max_seen_.load(std::memory_order_relaxed);
  }

  IciConnPtr accept(const IciChannelPtr& ch, int32_t client_dev,
                    int64_t window_bytes) {
    auto c = std::make_shared<IciConn>();
    c->id = next_conn_id_.fetch_add(1) + 1;
    c->client_dev = client_dev;
    c->client = ch;
    c->server = shared_from_this();
    c->window_bytes = window_bytes;
    c->window_left = window_bytes;
    std::lock_guard<std::mutex> g(conns_mu_);
    conns_[c->id] = c;
    return c;
  }

  void drop_conn(uint64_t id) {
    std::lock_guard<std::mutex> g(conns_mu_);
    conns_.erase(id);
  }

  bool stopped() const { return stop_.load(std::memory_order_acquire); }

  // Inline dispatch entry: runs on the caller's thread; returns the
  // frame's credits to the connection when the frame is consumed.
  void dispatch(IciMsg&& m) {
    IciConnPtr conn = m.conn;
    int64_t credits = m.wire_bytes;
    // request frame consumed: return its credits (the piggybacked-ACK
    // of the RDMA window; the reference replenishes on completion).
    // process() returns false when the frame moved into the Python
    // batch queue — the batch upcall returns the credits then.
    if (process(m)) conn->return_credits(credits);
  }

 private:
  void reply_error(const IciMsg& msg, uint64_t cid, uint64_t err,
                   const std::string& text) {
    if (auto ch = msg.conn->client.lock())
      ch->deliver(cid, err, text, "", "", {});
  }

  // Returns true when the frame's credits may be returned by the caller
  // (consumed inline); false when the frame moved into the batch queue.
  bool process(IciMsg& msg) {
    const uint8_t* p = (const uint8_t*)msg.bytes.data();
    size_t sz = msg.bytes.size();
    if (sz < kHeaderSize || memcmp(p, kMagic, 4) != 0) {
      ici_release_segs(msg.segs);
      return true;                    // malformed: drop (framing guard)
    }
    uint32_t meta_size = get_u32be(p + 4);
    uint32_t body_size = get_u32be(p + 8);
    if (kHeaderSize + (size_t)meta_size + body_size != sz) {
      ici_release_segs(msg.segs);
      return true;
    }
    RpcMeta meta;
    if (!decode_meta(p + kHeaderSize, p + kHeaderSize + meta_size, &meta)) {
      ici_release_segs(msg.segs);
      return true;
    }
    requests_.fetch_add(1, std::memory_order_relaxed);
    const uint8_t* body = p + kHeaderSize + meta_size;
    // body = payload + host-attachment bytes; attachment_size in the meta
    // counts host attachment bytes only (device bytes ride the sidecar)
    size_t att = std::min((size_t)meta.attachment_size, (size_t)body_size);
    size_t payload_len = body_size - att;
    std::string full = meta.request.service_name + "." +
                       meta.request.method_name;
    uint64_t cid = meta.correlation_id;
    bool is_echo;
    {
      std::lock_guard<std::mutex> g(mmu_);
      is_echo = echo_methods_.count(full) != 0;
    }
    if (is_echo) {
      // native echo tier: refs pass through toward the client (resident
      // refs = zero upcalls, the pure-HBM round trip)
      std::string why;
      if (!ici_relocate_segs(msg.segs, msg.conn->client_dev, &why)) {
        ici_release_segs(msg.segs);
        reply_error(msg, cid, kERelocate, why);
        return true;
      }
      if (auto ch = msg.conn->client.lock()) {
        ch->deliver(cid, 0, "",
                    std::string((const char*)body, payload_len),
                    std::string((const char*)body + payload_len, att),
                    std::move(msg.segs));
      } else {
        ici_release_segs(msg.segs);
      }
      return true;
    }
    py_ici_batch_fn bh = batch_handler_.load(std::memory_order_acquire);
    py_ici_request_fn h = handler_.load(std::memory_order_acquire);
    if (bh != nullptr || h != nullptr) {
      // user-code tier: refs land resident on the SERVER device before
      // the handler sees them (the test contract: a handler observes its
      // attachment in local HBM)
      std::string why;
      if (!ici_relocate_segs(msg.segs, dev_, &why)) {
        ici_release_segs(msg.segs);
        reply_error(msg, cid, kERelocate, why);
        return true;
      }
      uint64_t token = register_token(msg.conn, cid);
      if (bh != nullptr) {
        IciBatchItem item;
        item.token = token;
        item.method = std::move(full);
        item.payload_off = kHeaderSize + meta_size;
        item.payload_len = payload_len;
        item.att_len = att;
        item.log_id = meta.request.log_id;
        item.peer_dev = msg.conn->client_dev;
        item.priority = meta.request.priority;
        item.tenant = std::move(meta.request.tenant);
        item.deadline_left_ms = meta.request.deadline_left_ms;
        item.enq_ns = ici_now_ns();
        item.conn = msg.conn;
        item.wire_bytes = msg.wire_bytes;
        item.bytes = std::move(msg.bytes);
        item.segs = std::move(msg.segs);
        enqueue_batch(std::move(item));
        return false;
      }
      // legacy single-request upcall ABI (no batch handler installed)
      h(token, full.c_str(), body, payload_len, body + payload_len, att,
        msg.segs.data(), msg.segs.size(), meta.request.log_id,
        msg.conn->client_dev);
      // the upcall TOOK the refs (Python popped them into its IOBuf):
      // native custody ends without release
      msg.segs.clear();
      return true;
    }
    ici_release_segs(msg.segs);
    reply_error(msg, cid, 1002, "no method " + full);
    return true;
  }

  // ---- Python batch queue (the batched-GIL-crossing core) ------------
  // Arrival discipline: the first enqueuer becomes the DRAINER and loops
  // delivering batches until the queue is empty; later arrivals just
  // enqueue (their requests ride the drainer's next batch — that is the
  // amortization) unless the oldest queued request has aged past
  // kBatchAgeNs, in which case the arrival STEALS the whole queue and
  // delivers it concurrently — p99 never pays more than the age bound
  // for batching, even with a drainer stuck in a slow inline handler.
  // An idle arrival is a batch of 1 delivered immediately: p50 pays no
  // batching delay at all.
  void enqueue_batch(IciBatchItem&& item) {
    std::vector<IciBatchItem> batch;
    bool owner = false;
    {
      std::lock_guard<std::mutex> g(bq_mu_);
      if (!bq_stopped_) {
        bq_.push_back(std::move(item));
        if (!bq_draining_) {
          bq_draining_ = true;
          owner = true;
          take_batch_locked(&batch);
        } else if (ici_now_ns() - bq_.front().enq_ns >= kBatchAgeNs) {
          take_batch_locked(&batch);   // steal: concurrent delivery
        } else {
          return;                      // the active drainer will take it
        }
      }
    }
    if (!owner && batch.empty()) {
      // enqueued after stop: fail it here (stop's sweep already ran)
      fail_batch_item(item, 1009, "ici server stopped");
      return;
    }
    for (;;) {
      deliver_batch(batch);
      if (!owner) return;
      {
        std::lock_guard<std::mutex> g(bq_mu_);
        if (bq_.empty() || bq_stopped_) {
          bq_draining_ = false;
          return;
        }
        batch.clear();
        take_batch_locked(&batch);
      }
    }
  }

  // fablint: lock-held(bq_mu_)
  void take_batch_locked(std::vector<IciBatchItem>* out) {
    uint64_t max_n = kBatchMax;
    while (!bq_.empty() && out->size() < max_n) {
      out->push_back(std::move(bq_.front()));
      bq_.pop_front();
    }
  }

  void deliver_batch(std::vector<IciBatchItem>& batch) {
    py_ici_batch_fn bh = batch_handler_.load(std::memory_order_acquire);
    if (bh == nullptr) {               // detached mid-flight
      for (auto& it : batch)
        fail_batch_item(it, 1009, "ici batch handler detached");
      return;
    }
    std::vector<IciReqC> reqs;
    reqs.reserve(batch.size());
    bool handles = att_handles_.load(std::memory_order_relaxed);
    for (auto& it : batch) {
      const uint8_t* base = (const uint8_t*)it.bytes.data();
      IciReqC r;
      r.token = it.token;
      r.method = it.method.c_str();
      r.payload = base + it.payload_off;
      r.payload_len = it.payload_len;
      r.att_host = base + it.payload_off + it.payload_len;
      r.att_host_len = it.att_len;
      r.log_id = it.log_id;
      r.recv_ns = it.enq_ns;
      r.peer_dev = it.peer_dev;
      r._pad = 0;
      r.tenant = it.tenant.empty() ? nullptr : it.tenant.c_str();
      r.deadline_left_ms = it.deadline_left_ms;
      r.priority = (int32_t)it.priority;
      r._pad2 = 0;
      r.att_handle = 0;
      r.seg0_key = 0;
      r.seg0_nbytes = 0;
      r.seg0_dev = 0;
      r._pad3 = 0;
      if (handles && it.att_len == 0 && !it.segs.empty()) {
        // native custody: the seg list PARKS in the att table; Python
        // receives a ready handle + an inline mirror of segs[0] and
        // never walks the list on the hot path.  Host-mixed
        // attachments keep the legacy take-during-upcall walk (the
        // host spans interleave with device segs positionally).
        IciAttEntry* e = nullptr;
        r.att_handle = ici_att_register(std::move(it.segs), &e);
        r.segs = e->segs.data();     // heap-stable while the handle lives
        r.nsegs = e->segs.size();
        r.seg0_key = e->segs[0].key;
        r.seg0_nbytes = e->segs[0].nbytes;
        r.seg0_dev = e->segs[0].dev;
      } else {
        r.segs = it.segs.data();
        r.nsegs = it.segs.size();
        if (!it.segs.empty()) {
          r.seg0_key = it.segs[0].key;
          r.seg0_nbytes = it.segs[0].nbytes;
          r.seg0_dev = it.segs[0].dev;
        }
      }
      reqs.push_back(r);
    }
    upcalls_.fetch_add(1, std::memory_order_relaxed);
    upcall_reqs_.fetch_add(batch.size(), std::memory_order_relaxed);
    uint64_t n = batch.size();
    uint64_t seen = batch_max_seen_.load(std::memory_order_relaxed);
    while (n > seen && !batch_max_seen_.compare_exchange_weak(
                           seen, n, std::memory_order_relaxed)) {
    }
    bh(reqs.data(), reqs.size());
    // the upcall TOOK every request's seg keys (Python popped them into
    // its IOBufs): native custody ends without release.  Credits return
    // now — the frames are consumed.
    for (auto& it : batch) {
      it.segs.clear();
      it.conn->return_credits(it.wire_bytes);
    }
  }

  void fail_batch_item(IciBatchItem& it, uint64_t err, const char* text);

  uint64_t register_token(const IciConnPtr& conn, uint64_t cid);

  int32_t dev_;
  uint64_t handle_ = 0;
  std::atomic<bool> stop_{false};
  std::mutex conns_mu_;
  std::unordered_map<uint64_t, IciConnPtr> conns_;
  std::atomic<uint64_t> next_conn_id_{0};
  std::mutex mmu_;
  std::unordered_map<std::string, bool> echo_methods_;
  std::atomic<py_ici_request_fn> handler_{nullptr};
  std::atomic<py_ici_batch_fn> batch_handler_{nullptr};
  std::atomic<uint64_t> requests_{0};
  // batch queue state (guarded by bq_mu_; see enqueue_batch)
  std::mutex bq_mu_;
  std::deque<IciBatchItem> bq_;
  bool bq_draining_ = false;
  bool bq_stopped_ = false;
  // requests per batched upcall (one GIL crossing), and the age of a
  // queued request past which an arrival steals the queue from a busy
  // drainer (bounds batching's p99 cost)
  static constexpr uint64_t kBatchMax = 64;
  static constexpr int64_t kBatchAgeNs = 50 * 1000;
  std::atomic<bool> att_handles_{false};   // native att custody opt-in
  std::atomic<uint64_t> upcalls_{0};
  std::atomic<uint64_t> upcall_reqs_{0};
  std::atomic<uint64_t> batch_max_seen_{0};
};
using IciServerPtr = std::shared_ptr<IciServer>;

struct IciPending {
  std::weak_ptr<IciConn> conn;
  uint64_t cid = 0;
};

static std::mutex g_ici_mu;
// Leaked on purpose: these registries own IciServer/IciChannel objects,
// and destroying them from static teardown would race whatever threads
// exit() left inside them.  The deterministic shutdown path is Python's
// atexit quiesce (ici/native_plane.py quiesce: every listener unlistened,
// every channel closed, while the interpreter still runs its threads).
static auto& g_ici_listeners =
    *new std::unordered_map<int32_t, IciServerPtr>();
static auto& g_ici_servers =
    *new std::unordered_map<uint64_t, IciServerPtr>();  // by handle
static auto& g_ici_channels =
    *new std::unordered_map<uint64_t, std::pair<IciChannelPtr, IciConnPtr>>();
static std::mutex g_ici_tokens_mu;
static auto& g_ici_tokens = *new nbase::FlatMap64<IciPending>();
static std::atomic<uint64_t> g_ici_next_token{1};

uint64_t IciServer::register_token(const IciConnPtr& conn, uint64_t cid) {
  uint64_t token = g_ici_next_token.fetch_add(1);
  std::lock_guard<std::mutex> g(g_ici_tokens_mu);
  g_ici_tokens[token] = IciPending{conn, cid};
  return token;
}

// Drop path for a queued Python-tier request that will never reach the
// upcall (server stopped / handler detached): release ref custody, take
// the token so a late respond can't double-deliver, error the caller,
// and return the frame's credits.
void IciServer::fail_batch_item(IciBatchItem& it, uint64_t err,
                                const char* text) {
  ici_release_segs(it.segs);
  it.segs.clear();
  IciPending pr;
  bool had = false;
  {
    std::lock_guard<std::mutex> g(g_ici_tokens_mu);
    had = g_ici_tokens.take(it.token, &pr);
  }
  if (had) {
    if (auto conn = pr.conn.lock()) {
      if (auto ch = conn->client.lock())
        ch->deliver(pr.cid, err, text, "", "", {});
    }
  }
  if (it.conn != nullptr) it.conn->return_credits(it.wire_bytes);
}

// The client-side unary call: window reservation → TRPC frame encode →
// relocation toward the server → queue hop → slot wait (spin, then park).
static uint64_t ici_do_call(const IciChannelPtr& ch, const IciConnPtr& conn,
                            const char* service_dot_method,
                            const uint8_t* req, uint64_t req_len,
                            const uint8_t* att_host, uint64_t att_host_len,
                            std::vector<IciSegC> segs, int64_t timeout_us,
                            IciSlot* out, std::string* err_text,
                            int64_t priority_wire = 0,
                            const char* tenant = nullptr,
                            int64_t deadline_left_ms = 0) {
  IciServerPtr srv = conn->server;
  auto deadline = std::chrono::steady_clock::now() +
                  std::chrono::microseconds(timeout_us > 0 ? timeout_us
                                                           : (int64_t)1e12);
  // ---- encode the frame (the same codec the TCP path uses) ----
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
  uint64_t cid;
  IciSlotPtr slot = ch->make_slot(&cid);
  meta.correlation_id = cid;
  meta.attachment_size = att_host_len;
  if (timeout_us > 0) meta.request.timeout_ms = (uint64_t)(timeout_us / 1000);
  if (priority_wire > 0) meta.request.priority = (uint64_t)priority_wire;
  if (tenant != nullptr && tenant[0] != '\0') meta.request.tenant = tenant;
  if (deadline_left_ms > 0)
    meta.request.deadline_left_ms = (uint64_t)deadline_left_ms;
  std::string frame = pack_head(meta, req_len + att_host_len);
  if (req_len) frame.append((const char*)req, req_len);
  if (att_host_len) frame.append((const char*)att_host, att_host_len);
  int64_t dev_bytes = 0;
  for (const auto& s : segs)
    if (s.is_dev) dev_bytes += (int64_t)s.nbytes;
  int64_t wire = (int64_t)frame.size() + dev_bytes;

  // ---- window reservation (check-and-reserve under one lock — the
  // AppendIfNotFull discipline, stream.cpp:274) ----
  if (wire > conn->window_bytes) {
    // can NEVER fit: fail now instead of burning the whole rpc deadline
    ch->erase_slot(cid);
    ici_release_segs(segs);
    *err_text = "frame larger than the ici send window";
    return 1011;  // EOVERCROWDED (rpc/errors.py)
  }
  {
    std::unique_lock<std::mutex> g(conn->wmu);
    while (conn->window_left < wire) {
      if (conn->closed.load(std::memory_order_acquire) || srv->stopped()) {
        g.unlock();
        ch->erase_slot(cid);
        ici_release_segs(segs);
        *err_text = "ici peer closed while window full";
        return 1009;
      }
      if (nbase::cv_wait_until(conn->wcv, g, deadline)
              == std::cv_status::timeout) {
        g.unlock();
        ch->erase_slot(cid);
        ici_release_segs(segs);
        *err_text = "ici send window stalled (peer not consuming)";
        return 1011;  // EOVERCROWDED (rpc/errors.py)
      }
    }
    conn->window_left -= wire;
  }
  if (conn->closed.load(std::memory_order_acquire) || srv->stopped()) {
    ch->erase_slot(cid);
    ici_release_segs(segs);
    conn->return_credits(wire);
    *err_text = "ici peer closed";
    return 1009;
  }
  // ---- relocate toward the server's device (HBM→HBM; resident = noop),
  // then hand the frame to the server queue ----
  if (!ici_relocate_segs(segs, srv->dev(), err_text)) {
    ch->erase_slot(cid);
    ici_release_segs(segs);
    conn->return_credits(wire);
    return nrpc::kERelocate;
  }
  IciMsg msg;
  msg.conn = conn;
  msg.cid = cid;
  msg.bytes = std::move(frame);
  msg.segs = std::move(segs);
  msg.wire_bytes = wire;
  srv->dispatch(std::move(msg));   // inline: caller is the IO thread

  // ---- wait.  The native echo tier already delivered synchronously
  // (the common case: done before we get here, zero parks).  A Python
  // handler completes from its tasklet thread → park on the condvar.
  if (!slot->done.load(std::memory_order_acquire)) {
    std::unique_lock<std::mutex> g(slot->mu);
    while (!slot->done.load(std::memory_order_acquire)) {
      if (nbase::cv_wait_until(slot->cv, g, deadline)
              == std::cv_status::timeout) {
        // the deadline and the response can race: `done` is the truth,
        // re-checked under the lock.  Abandoning under the SAME lock
        // guarantees a later deliver() sees it and releases custody.
        if (slot->done.load(std::memory_order_acquire)) break;
        slot->abandoned = true;
        g.unlock();
        ch->erase_slot(cid);
        *err_text = "rpc timeout";
        return 1008;
      }
    }
  }
  {
    std::lock_guard<std::mutex> g(slot->mu);
    out->error_code = slot->error_code;
    out->error_text = std::move(slot->error_text);
    out->payload = std::move(slot->payload);
    out->att_host = std::move(slot->att_host);
    out->segs = std::move(slot->segs);
    out->retry_after_ms = slot->retry_after_ms;
  }
  ch->erase_slot(cid);       // waiter owns slot lifetime (see deliver)
  *err_text = out->error_text;
  return out->error_code;
}


// handle numbers of listeners and connections (the C ABI's ids)
static std::atomic<uint64_t> g_next_handle{1};

}  // namespace nrpc

// ====================================================================
// C ABI (the ici:// plane only)
// ====================================================================

#pragma GCC visibility push(default)
extern "C" {

void brpc_tpu_buf_free(void* p) { free(p); }

// ---- ici:// plane ----

void brpc_tpu_ici_set_hooks(nrpc::py_relocate_fn relocate,
                            nrpc::py_release_fn release) {
  nrpc::g_ici_relocate.store(relocate, std::memory_order_release);
  nrpc::g_ici_release.store(release, std::memory_order_release);
}

// Returns a server handle; 0 when the device id is already listening.
// The Python handler (may be null for echo-only servers) is installed
// BEFORE the listener becomes visible — no half-initialized window.
uint64_t brpc_tpu_ici_listen(int32_t dev, nrpc::py_ici_request_fn handler) {
  auto s = std::make_shared<nrpc::IciServer>(dev, handler);
  {
    std::lock_guard<std::mutex> g(nrpc::g_ici_mu);
    if (nrpc::g_ici_listeners.count(dev)) return 0;
    uint64_t h = nrpc::g_next_handle.fetch_add(1);
    s->set_handle(h);
    nrpc::g_ici_listeners[dev] = s;
    nrpc::g_ici_servers[h] = s;
  }
  s->start();
  return s->handle();
}

int brpc_tpu_ici_register_echo(uint64_t h, const char* full_method) {
  std::lock_guard<std::mutex> g(nrpc::g_ici_mu);
  auto it = nrpc::g_ici_servers.find(h);
  if (it == nrpc::g_ici_servers.end()) return -1;
  it->second->register_echo(full_method);
  return 0;
}

// Batched one-struct upcall variant of brpc_tpu_ici_listen: the handler
// receives (IciReqC*, n) — see the ABI comment at IciReqC.
uint64_t brpc_tpu_ici_listen_batch(int32_t dev, nrpc::py_ici_batch_fn fn) {
  uint64_t h = brpc_tpu_ici_listen(dev, nullptr);
  if (h == 0) return 0;
  std::lock_guard<std::mutex> g(nrpc::g_ici_mu);
  auto it = nrpc::g_ici_servers.find(h);
  if (it != nrpc::g_ici_servers.end()) it->second->set_batch_handler(fn);
  return h;
}

int brpc_tpu_ici_batch_stats(uint64_t h, uint64_t* upcalls,
                             uint64_t* requests, uint64_t* max_batch) {
  std::lock_guard<std::mutex> g(nrpc::g_ici_mu);
  auto it = nrpc::g_ici_servers.find(h);
  if (it == nrpc::g_ici_servers.end()) return -1;
  it->second->batch_stats(upcalls, requests, max_batch);
  return 0;
}

uint64_t brpc_tpu_ici_requests(uint64_t h) {
  std::lock_guard<std::mutex> g(nrpc::g_ici_mu);
  auto it = nrpc::g_ici_servers.find(h);
  return it == nrpc::g_ici_servers.end() ? 0 : it->second->requests();
}

// 1 when a native listener exists for this device id.
int brpc_tpu_ici_has_listener(int32_t dev) {
  std::lock_guard<std::mutex> g(nrpc::g_ici_mu);
  return nrpc::g_ici_listeners.count(dev) ? 1 : 0;
}

void brpc_tpu_ici_unlisten(uint64_t h) {
  nrpc::IciServerPtr s;
  {
    std::lock_guard<std::mutex> g(nrpc::g_ici_mu);
    auto it = nrpc::g_ici_servers.find(h);
    if (it == nrpc::g_ici_servers.end()) return;
    s = it->second;
    nrpc::g_ici_servers.erase(it);
    nrpc::g_ici_listeners.erase(s->dev());
  }
  {
    // purge this server's in-flight Python-handler tokens
    std::lock_guard<std::mutex> g(nrpc::g_ici_tokens_mu);
    std::vector<uint64_t> purge;
    nrpc::g_ici_tokens.for_each([&](uint64_t t, nrpc::IciPending& pr) {
      auto conn = pr.conn.lock();
      if (conn == nullptr || conn->server == s) purge.push_back(t);
    });
    for (uint64_t t : purge) nrpc::g_ici_tokens.erase(t);
  }
  s->stop();
}

// Connect local_dev → the native listener at remote_dev; returns a
// channel handle (0 = no listener).
uint64_t brpc_tpu_ici_connect(int32_t local_dev, int32_t remote_dev,
                              int64_t window_bytes) {
  nrpc::IciServerPtr srv;
  {
    std::lock_guard<std::mutex> g(nrpc::g_ici_mu);
    auto it = nrpc::g_ici_listeners.find(remote_dev);
    if (it == nrpc::g_ici_listeners.end()) return 0;
    srv = it->second;
  }
  auto ch = std::make_shared<nrpc::IciChannel>(local_dev, remote_dev);
  auto conn = srv->accept(ch, local_dev,
                          window_bytes > 0 ? window_bytes : (4 << 20));
  std::lock_guard<std::mutex> g(nrpc::g_ici_mu);
  uint64_t h = nrpc::g_next_handle.fetch_add(1);
  nrpc::g_ici_channels[h] = {ch, conn};
  return h;
}

void brpc_tpu_ici_close(uint64_t h) {
  std::pair<nrpc::IciChannelPtr, nrpc::IciConnPtr> entry;
  {
    std::lock_guard<std::mutex> g(nrpc::g_ici_mu);
    auto it = nrpc::g_ici_channels.find(h);
    if (it == nrpc::g_ici_channels.end()) return;
    entry = it->second;
    nrpc::g_ici_channels.erase(it);
  }
  entry.second->closed.store(true, std::memory_order_release);
  entry.second->server->drop_conn(entry.second->id);
  entry.first->fail_all(1009, "channel closed");
}

int64_t brpc_tpu_ici_window_left(uint64_t h) {
  std::lock_guard<std::mutex> g(nrpc::g_ici_mu);
  auto it = nrpc::g_ici_channels.find(h);
  if (it == nrpc::g_ici_channels.end()) return -1;
  std::lock_guard<std::mutex> wg(it->second.second->wmu);
  return it->second.second->window_left;
}

// Single-output-struct out-block for the unary ici call (see call2/call3):
// one reusable pointer instead of seven byref temporaries.
struct IciCallOut {
  uint8_t* resp;
  uint64_t resp_len;
  uint8_t* att;
  uint64_t att_len;
  nrpc::IciSegC* segs;
  uint64_t nsegs;
  char* err_text;
  uint64_t retry_after_ms;   // admission shed hint on ELIMIT rejections
  // native custody outputs (appended; filled by call4 only):
  // nonzero att_handle parks the response seg list in the att table —
  // the caller wraps it lazily and exits custody exactly once (take at
  // materialization / dispose when the view dies).  seg0_* mirrors the
  // first seg inline; for the dominant 1-seg shape segs stays NULL
  // (nothing to free), >1 segs are additionally malloc'd into segs so
  // the caller can read metadata without another crossing.
  uint64_t att_handle;
  uint64_t seg0_key;
  uint64_t seg0_nbytes;
  int32_t seg0_dev;
  int32_t _pad;
};

// Shared unary-call body: outputs are malloc'd (brpc_tpu_buf_free);
// response device refs land in out->segs (caller takes their keys).
static uint64_t ici_call_fill(uint64_t h, const char* method,
                              const uint8_t* req, uint64_t req_len,
                              const uint8_t* att_host,
                              uint64_t att_host_len,
                              const nrpc::IciSegC* segs, uint64_t nsegs,
                              int64_t timeout_us, int64_t priority_wire,
                              const char* tenant, int64_t deadline_left_ms,
                              IciCallOut* o, int want_handle = 0) {
  memset(o, 0, sizeof(*o));
  std::pair<nrpc::IciChannelPtr, nrpc::IciConnPtr> entry;
  {
    std::lock_guard<std::mutex> g(nrpc::g_ici_mu);
    auto it = nrpc::g_ici_channels.find(h);
    if (it != nrpc::g_ici_channels.end()) entry = it->second;
  }
  std::vector<nrpc::IciSegC> seg_vec(segs, segs + nsegs);
  if (entry.first == nullptr) {
    nrpc::ici_release_segs(seg_vec);
    return 1009;
  }
  nrpc::IciSlot out;
  std::string err_text;
  uint64_t rc = nrpc::ici_do_call(entry.first, entry.second, method, req,
                                  req_len, att_host, att_host_len,
                                  std::move(seg_vec), timeout_us, &out,
                                  &err_text, priority_wire, tenant,
                                  deadline_left_ms);
  if (!out.payload.empty()) {
    o->resp = (uint8_t*)malloc(out.payload.size());
    memcpy(o->resp, out.payload.data(), out.payload.size());
    o->resp_len = out.payload.size();
  }
  if (!out.att_host.empty()) {
    o->att = (uint8_t*)malloc(out.att_host.size());
    memcpy(o->att, out.att_host.data(), out.att_host.size());
    o->att_len = out.att_host.size();
  }
  if (want_handle && rc != 0 && !out.segs.empty()) {
    // handle-mode error path: a handler that failed the RPC may still
    // have shipped response segs — release them HERE so the Python
    // caller's error path needs no custody walk at all
    nrpc::ici_release_segs(out.segs);
    out.segs.clear();
  }
  if (!out.segs.empty()) {
    if (want_handle && out.att_host.empty()) {
      // native custody: park the seg list under a handle; the caller
      // builds a lazy view.  seg0 rides inline; >1 segs additionally
      // get the malloc'd metadata copy (the caller reads it during
      // THIS call — it is freed with the other outputs).
      o->seg0_key = out.segs[0].key;
      o->seg0_nbytes = out.segs[0].nbytes;
      o->seg0_dev = out.segs[0].dev;
      o->nsegs = out.segs.size();
      if (out.segs.size() > 1) {
        o->segs = (nrpc::IciSegC*)malloc(out.segs.size() *
                                         sizeof(nrpc::IciSegC));
        memcpy(o->segs, out.segs.data(),
               out.segs.size() * sizeof(nrpc::IciSegC));
      }
      o->att_handle = nrpc::ici_att_register(std::move(out.segs));
    } else {
      o->segs = (nrpc::IciSegC*)malloc(out.segs.size() *
                                       sizeof(nrpc::IciSegC));
      memcpy(o->segs, out.segs.data(),
             out.segs.size() * sizeof(nrpc::IciSegC));
      o->nsegs = out.segs.size();
    }
  }
  if (!err_text.empty()) {
    o->err_text = (char*)malloc(err_text.size() + 1);
    memcpy(o->err_text, err_text.c_str(), err_text.size() + 1);
  }
  o->retry_after_ms = out.retry_after_ms;
  return rc;
}

// call2 + admission-control metadata: wire-encoded priority (0 = unset,
// 1..N = band 0..N-1), tenant, and the sender's remaining deadline
// budget.  out->retry_after_ms carries the shed hint back on ELIMIT.
uint64_t brpc_tpu_ici_call3(uint64_t h, const char* method,
                            const uint8_t* req, uint64_t req_len,
                            const uint8_t* att_host, uint64_t att_host_len,
                            const nrpc::IciSegC* segs, uint64_t nsegs,
                            int64_t timeout_us, int64_t priority_wire,
                            const char* tenant, int64_t deadline_left_ms,
                            IciCallOut* out) {
  return ici_call_fill(h, method, req, req_len, att_host, att_host_len,
                       segs, nsegs, timeout_us, priority_wire, tenant,
                       deadline_left_ms, out);
}

// call3 + native att custody on the RESPONSE: device-only response
// attachments come back as out->att_handle (+ seg0 inline; >1 segs
// also malloc'd as metadata) instead of owned seg copies the caller
// must walk and take.  Error-path response segs are released natively.
uint64_t brpc_tpu_ici_call4(uint64_t h, const char* method,
                            const uint8_t* req, uint64_t req_len,
                            const uint8_t* att_host, uint64_t att_host_len,
                            const nrpc::IciSegC* segs, uint64_t nsegs,
                            int64_t timeout_us, int64_t priority_wire,
                            const char* tenant, int64_t deadline_left_ms,
                            IciCallOut* out) {
  return ici_call_fill(h, method, req, req_len, att_host, att_host_len,
                       segs, nsegs, timeout_us, priority_wire, tenant,
                       deadline_left_ms, out, /*want_handle=*/1);
}

// ---- native att custody handle ops ----
// Exactly-one-exit per handle: pass-back (IciRespC.att_handle), take,
// or dispose.  Each op consumes the handle.

// Python assumed custody of every key in the entry (it pulled them
// from its registry itself): drop the entry WITHOUT releasing.
// Returns the seg count, -1 for an unknown handle.
int64_t brpc_tpu_ici_att_take(uint64_t handle) {
  nrpc::IciAttEntry* e = nrpc::ici_att_pop(handle);
  if (e == nullptr) return -1;
  int64_t n = (int64_t)e->segs.size();
  delete e;
  return n;
}

// Drop path: release every parked key via the release upcall (the
// registry forgets them) and free the entry.  -1 unknown handle.
int brpc_tpu_ici_att_dispose(uint64_t handle) {
  nrpc::IciAttEntry* e = nrpc::ici_att_pop(handle);
  if (e == nullptr) return -1;
  nrpc::ici_release_segs(e->segs);
  delete e;
  return 0;
}

// Live parked entries — the census/leak-detection surface.
uint64_t brpc_tpu_ici_att_count() {
  std::lock_guard<std::mutex> g(nrpc::g_ici_atts_mu);
  return nrpc::g_ici_atts.size();
}

// Opt a listener's batched upcall into IciReqC.att_handle delivery.
int brpc_tpu_ici_set_att_handles(uint64_t h, int on) {
  std::lock_guard<std::mutex> g(nrpc::g_ici_mu);
  auto it = nrpc::g_ici_servers.find(h);
  if (it == nrpc::g_ici_servers.end()) return -1;
  it->second->set_att_handles(on != 0);
  return 0;
}

// Batched write-back half of the one-struct ABI: one ctypes crossing
// delivers every ready response the Python side accumulated (symmetric
// with the batched request upcall).  Native releases seg custody on
// every failure path (including a vanished token): the batch caller gets
// no per-item return code, so it must never need one.
int brpc_tpu_ici_respond_batch(const nrpc::IciRespC* rs, uint64_t n) {
  for (uint64_t i = 0; i < n; ++i) {
    const nrpc::IciRespC& r = rs[i];
    nrpc::IciPending pr;
    bool had;
    {
      std::lock_guard<std::mutex> g(nrpc::g_ici_tokens_mu);
      had = nrpc::g_ici_tokens.take(r.token, &pr);
    }
    std::vector<nrpc::IciSegC> seg_vec;
    if (r.att_handle != 0) {
      // native-custody pass-through: the parked request att IS the
      // response attachment — custody continues into delivery without
      // Python ever walking the segs.  A vanished handle (double
      // pass-back would be a caller bug) degrades to an empty att.
      nrpc::IciAttEntry* e = nrpc::ici_att_pop(r.att_handle);
      if (e != nullptr) {
        seg_vec = std::move(e->segs);
        delete e;
      }
    } else {
      seg_vec.assign(r.segs, r.segs + r.nsegs);
    }
    if (!had) {
      nrpc::ici_release_segs(seg_vec);
      continue;
    }
    auto conn = pr.conn.lock();
    if (conn == nullptr) {
      nrpc::ici_release_segs(seg_vec);
      continue;
    }
    std::string why;
    if (!nrpc::ici_relocate_segs(seg_vec, conn->client_dev, &why)) {
      nrpc::ici_release_segs(seg_vec);
      if (auto ch = conn->client.lock())
        ch->deliver(pr.cid, nrpc::kERelocate, std::move(why), "", "", {});
      continue;
    }
    auto ch = conn->client.lock();
    if (ch == nullptr) {
      nrpc::ici_release_segs(seg_vec);
      continue;
    }
    ch->deliver(pr.cid, r.err, r.err_text ? r.err_text : "",
                r.len ? std::string((const char*)r.data, r.len)
                      : std::string(),
                r.att_host_len
                    ? std::string((const char*)r.att_host, r.att_host_len)
                    : std::string(),
                std::move(seg_vec), r.retry_after_ms);
  }
  return 0;
}

// Native-loop ici echo benchmark: the C++ client loop of the reference's
// rdma_performance client.  dev_key names a pre-registered device array
// (borrowed for the duration — never released here); dev_nbytes 0 runs
// the host-only frame.  Returns p50 ns (-1 on failure).
int64_t brpc_tpu_ici_echo_p50_ns(int iters, int payload_len,
                                 uint64_t dev_key, uint64_t dev_nbytes,
                                 int32_t dev) {
  uint64_t sh = brpc_tpu_ici_listen(dev, nullptr);
  if (sh == 0) return -1;
  brpc_tpu_ici_register_echo(sh, "EchoService.Echo");
  uint64_t ch = brpc_tpu_ici_connect(dev, dev, 0);
  if (ch == 0) {
    brpc_tpu_ici_unlisten(sh);
    return -1;
  }
  std::pair<nrpc::IciChannelPtr, nrpc::IciConnPtr> entry;
  {
    std::lock_guard<std::mutex> g(nrpc::g_ici_mu);
    entry = nrpc::g_ici_channels[ch];
  }
  std::string payload(payload_len, 'x');
  std::vector<int64_t> lat;
  lat.reserve(iters);
  auto now_ns = [] {
    return std::chrono::duration_cast<std::chrono::nanoseconds>(
               std::chrono::steady_clock::now().time_since_epoch())
        .count();
  };
  bool ok = true;
  for (int i = 0; i < iters + 50 && ok; ++i) {
    std::vector<nrpc::IciSegC> segs;
    if (dev_nbytes > 0)
      segs.push_back(nrpc::IciSegC{dev_key, dev_nbytes, dev, 1});
    nrpc::IciSlot out;
    std::string err;
    int64_t t0 = now_ns();
    uint64_t rc = nrpc::ici_do_call(
        entry.first, entry.second, "EchoService.Echo",
        (const uint8_t*)payload.data(), payload.size(), nullptr, 0,
        std::move(segs), 5 * 1000 * 1000, &out, &err);
    int64_t t1 = now_ns();
    ok = (rc == 0 && out.payload.size() == payload.size() &&
          out.segs.size() == (dev_nbytes > 0 ? 1u : 0u));
    if (ok && i >= 50) lat.push_back(t1 - t0);
  }
  brpc_tpu_ici_close(ch);
  brpc_tpu_ici_unlisten(sh);
  if (!ok || lat.empty()) return -1;
  std::sort(lat.begin(), lat.end());
  return lat[lat.size() / 2];
}

// Large-request throughput, 1 client → 1 server (the reference's headline
// "2.3 GB/s pooled large messages" config, docs/cn/benchmark.md:104).
// `threads` concurrent callers on separate connections keep the pipe
// full; reported number counts request payload bytes only (matching the

// ---- codec probes (tests hold the framing against the reference's) ----

// One TRPC frame from meta fields and a body: a request frame when
// `service` is non-null, else a response frame.  *out is malloc'd (free
// with brpc_tpu_buf_free).  Returns the frame length.
uint64_t brpc_tpu_ici_codec_pack(const char* service, const char* method,
                                 uint64_t cid, uint64_t log_id,
                                 uint64_t timeout_ms, uint64_t priority_wire,
                                 const char* tenant,
                                 uint64_t deadline_left_ms, uint64_t err,
                                 const char* err_text,
                                 uint64_t retry_after_ms,
                                 uint64_t attachment_size,
                                 const uint8_t* body, uint64_t body_len,
                                 uint8_t** out) {
  nrpc::RpcMeta meta;
  if (service != nullptr) {
    meta.request.present = true;
    meta.request.service_name = service;
    meta.request.method_name = method ? method : "";
    meta.request.log_id = log_id;
    meta.request.timeout_ms = timeout_ms;
    meta.request.priority = priority_wire;
    if (tenant != nullptr) meta.request.tenant = tenant;
    meta.request.deadline_left_ms = deadline_left_ms;
  } else {
    meta.response.present = true;
    meta.response.error_code = err;
    if (err_text != nullptr) meta.response.error_text = err_text;
    meta.response.retry_after_ms = retry_after_ms;
  }
  meta.correlation_id = cid;
  meta.attachment_size = attachment_size;
  std::string frame = nrpc::pack_frame(meta, body, body_len);
  *out = (uint8_t*)malloc(frame.size() ? frame.size() : 1);
  memcpy(*out, frame.data(), frame.size());
  return frame.size();
}

// Decode one frame's header and meta.  fields[] receives, in order:
// meta size, body size, correlation id, attachment size, log id,
// timeout_ms, priority (wire), deadline_left_ms, error code,
// retry_after_ms, has_stream_settings.  *names (malloc'd) receives
// "service\0method\0tenant\0error_text\0".  Returns 0, or -1 when the
// frame does not parse.
int brpc_tpu_ici_codec_unpack(const uint8_t* frame, uint64_t len,
                              uint64_t* fields, char** names) {
  using namespace nrpc;
  if (len < kHeaderSize || memcmp(frame, kMagic, 4) != 0) return -1;
  uint32_t meta_size = get_u32be(frame + 4);
  uint32_t body_size = get_u32be(frame + 8);
  if (kHeaderSize + (uint64_t)meta_size > len) return -1;
  RpcMeta meta;
  if (!decode_meta(frame + kHeaderSize, frame + kHeaderSize + meta_size,
                   &meta))
    return -1;
  uint64_t f[11] = {meta_size, body_size, meta.correlation_id,
                    meta.attachment_size, meta.request.log_id,
                    meta.request.timeout_ms, meta.request.priority,
                    meta.request.deadline_left_ms, meta.response.error_code,
                    meta.response.retry_after_ms,
                    meta.has_stream_settings ? 1u : 0u};
  memcpy(fields, f, sizeof(f));
  std::string s = meta.request.service_name;
  s.push_back('\0');
  s += meta.request.method_name;
  s.push_back('\0');
  s += meta.request.tenant;
  s.push_back('\0');
  s += meta.response.error_text;
  s.push_back('\0');
  *names = (char*)malloc(s.size());
  memcpy(*names, s.data(), s.size());
  return 0;
}

}  // extern "C"
#pragma GCC visibility pop

#endif  // __linux__
