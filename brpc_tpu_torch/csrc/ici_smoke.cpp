// ici-plane smoke of the port's ici_native.cpp (with rpc_native.cpp, one
// library) for sanitizer builds: tests/test_torch_sanitizers.py builds it
// with -fsanitize=thread and with -fsanitize=address against a sanitized
// libici_native and runs it with halt_on_error=1.
//
// The BATCHED one-struct upcall ABI under the exact concurrency the
// Python handler tier drives — concurrent client threads calling
// brpc_tpu_ici_call3 (concurrent arrivals form real multi-request
// batches), a batch handler answering half its requests
// inline via brpc_tpu_ici_respond_batch and handing the other half to a
// separate responder thread (cross-thread token take + deliver), then
// an unlisten with calls still in flight (the stop-drain sweep that
// fails queued batch items).  Under TSan this covers the batch-queue
// lock discipline and the token table; under ASan the IciReqC view
// lifetimes (frame bytes owned by the queue across the upcall) and the
// respond-path custody.
#include <atomic>
#include <cassert>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

// ABI mirror of ici_native.cpp (kept in sync by hand, like the ctypes
// side in brpc_tpu_torch/butil/native.py)
struct IciSegC {
  uint64_t key;
  uint64_t nbytes;
  int32_t dev;
  int32_t is_dev;
};
struct IciReqC {
  uint64_t token;
  const char* method;
  const uint8_t* payload;
  uint64_t payload_len;
  const uint8_t* att_host;
  uint64_t att_host_len;
  const IciSegC* segs;
  uint64_t nsegs;
  uint64_t log_id;
  int64_t recv_ns;
  int32_t peer_dev;
  int32_t _pad;
  const char* tenant;          // admission meta (ici_native.cpp IciReqC)
  uint64_t deadline_left_ms;
  int32_t priority;
  int32_t _pad2;
  uint64_t att_handle;         // native att custody (IciReqC)
  uint64_t seg0_key;
  uint64_t seg0_nbytes;
  int32_t seg0_dev;
  int32_t _pad3;
};
struct IciRespC {
  uint64_t token;
  uint64_t err;
  const char* err_text;
  const uint8_t* data;
  uint64_t len;
  const uint8_t* att_host;
  uint64_t att_host_len;
  const IciSegC* segs;
  uint64_t nsegs;
  uint64_t retry_after_ms;     // admission shed hint
  uint64_t att_handle;         // native att custody pass-through
};
struct IciCallOut {
  uint8_t* resp;
  uint64_t resp_len;
  uint8_t* att;
  uint64_t att_len;
  IciSegC* segs;
  uint64_t nsegs;
  char* err_text;
  uint64_t retry_after_ms;     // admission shed hint
  uint64_t att_handle;         // native att custody (call4)
  uint64_t seg0_key;
  uint64_t seg0_nbytes;
  int32_t seg0_dev;
  int32_t _pad;
};

extern "C" {
uint64_t brpc_tpu_ici_listen_batch(int32_t dev,
                                   void (*fn)(const IciReqC*, uint64_t));
int brpc_tpu_ici_set_att_handles(uint64_t h, int on);
int brpc_tpu_ici_batch_stats(uint64_t h, uint64_t* upcalls,
                             uint64_t* requests, uint64_t* max_batch);
int brpc_tpu_ici_respond_batch(const IciRespC* rs, uint64_t n);
uint64_t brpc_tpu_ici_connect(int32_t local_dev, int32_t remote_dev,
                              int64_t window_bytes);
uint64_t brpc_tpu_ici_call3(uint64_t h, const char* method,
                            const uint8_t* req, uint64_t req_len,
                            const uint8_t* att_host, uint64_t att_host_len,
                            const IciSegC* segs, uint64_t nsegs,
                            int64_t timeout_us, int64_t priority_wire,
                            const char* tenant, int64_t deadline_left_ms,
                            IciCallOut* out);
uint64_t brpc_tpu_ici_call4(uint64_t h, const char* method,
                            const uint8_t* req, uint64_t req_len,
                            const uint8_t* att_host, uint64_t att_host_len,
                            const IciSegC* segs, uint64_t nsegs,
                            int64_t timeout_us, int64_t priority_wire,
                            const char* tenant, int64_t deadline_left_ms,
                            IciCallOut* out);
void brpc_tpu_ici_set_hooks(uint64_t (*relocate)(uint64_t, int32_t, char*,
                                                 uint32_t),
                            void (*release)(uint64_t));
int64_t brpc_tpu_ici_att_take(uint64_t handle);
int brpc_tpu_ici_att_dispose(uint64_t handle);
uint64_t brpc_tpu_ici_att_count();
void brpc_tpu_ici_close(uint64_t h);
void brpc_tpu_ici_unlisten(uint64_t h);
void brpc_tpu_buf_free(void* p);
}

namespace {

struct Pending {
  uint64_t token;
  std::string payload;
};

std::mutex g_mu;
std::condition_variable g_cv;
std::deque<Pending> g_q;
bool g_stop = false;
std::atomic<uint64_t> g_handled{0};

// The "Python handler tier": even-length payloads echo inline through
// ONE respond_batch call for the whole batch slice; odd-length ones go
// to the responder thread.
void batch_handler(const IciReqC* reqs, uint64_t n) {
  std::vector<IciRespC> inline_resps;
  std::vector<std::string> keep;
  inline_resps.reserve(n);
  keep.reserve(n);
  for (uint64_t i = 0; i < n; ++i) {
    const IciReqC& r = reqs[i];
    g_handled.fetch_add(1, std::memory_order_relaxed);
    if (r.payload_len % 2 == 0) {
      keep.emplace_back((const char*)r.payload, r.payload_len);
      IciRespC resp;
      memset(&resp, 0, sizeof(resp));
      resp.token = r.token;
      resp.data = (const uint8_t*)keep.back().data();
      resp.len = keep.back().size();
      inline_resps.push_back(resp);
    } else {
      std::lock_guard<std::mutex> g(g_mu);
      g_q.push_back(Pending{r.token,
                            std::string((const char*)r.payload,
                                        r.payload_len)});
      g_cv.notify_one();
    }
  }
  if (!inline_resps.empty())
    brpc_tpu_ici_respond_batch(inline_resps.data(), inline_resps.size());
}

void responder_main() {
  for (;;) {
    Pending p;
    {
      std::unique_lock<std::mutex> g(g_mu);
      g_cv.wait(g, [] { return g_stop || !g_q.empty(); });
      if (g_q.empty()) {
        if (g_stop) return;
        continue;
      }
      p = std::move(g_q.front());
      g_q.pop_front();
    }
    IciRespC resp;
    memset(&resp, 0, sizeof(resp));
    resp.token = p.token;
    resp.data = (const uint8_t*)p.payload.data();
    resp.len = p.payload.size();
    brpc_tpu_ici_respond_batch(&resp, 1);
  }
}

// ---- resolved-seg ABI section ----------------------------------------

std::atomic<uint64_t> g_released{0};
std::atomic<uint64_t> g_relocates{0};

uint64_t hook_relocate(uint64_t key, int32_t, char*, uint32_t) {
  g_relocates.fetch_add(1, std::memory_order_relaxed);
  return key;                  // "already resident": same key
}

void hook_release(uint64_t key) {
  (void)key;
  g_released.fetch_add(1, std::memory_order_relaxed);
}

// Handler: every seg-carrying request must arrive with att_handle + the
// seg0 mirror; pass the handle back (echo pass-through).
std::atomic<uint64_t> g_att_errs{0};

void att_batch_handler(const IciReqC* reqs, uint64_t n) {
  std::vector<IciRespC> resps(n);
  std::vector<std::string> keep;
  keep.reserve(n);
  for (uint64_t i = 0; i < n; ++i) {
    const IciReqC& r = reqs[i];
    memset(&resps[i], 0, sizeof(resps[i]));
    resps[i].token = r.token;
    keep.emplace_back((const char*)r.payload, r.payload_len);
    resps[i].data = (const uint8_t*)keep.back().data();
    resps[i].len = keep.back().size();
    if (r.nsegs) {
      if (r.att_handle == 0 || r.seg0_key == 0 ||
          r.seg0_nbytes == 0 || r.segs == nullptr ||
          r.segs[0].key != r.seg0_key) {
        g_att_errs.fetch_add(1);
        continue;
      }
      resps[i].att_handle = r.att_handle;   // pass-through
    }
  }
  brpc_tpu_ici_respond_batch(resps.data(), n);
}

void att_custody_smoke() {
  brpc_tpu_ici_set_hooks(hook_relocate, hook_release);
  uint64_t sh = brpc_tpu_ici_listen_batch(78, att_batch_handler);
  assert(sh != 0);
  assert(brpc_tpu_ici_set_att_handles(sh, 1) == 0);
  std::atomic<uint64_t> next_key{1000};
  std::atomic<uint64_t> keys_issued{0}, keys_taken{0};
  std::atomic<int> errs{0};
  std::vector<std::thread> callers;
  for (int c = 0; c < 4; ++c) {
    callers.emplace_back([&, c] {
      uint64_t ch = brpc_tpu_ici_connect(78, 78, 0);
      assert(ch != 0);
      std::string payload(24, 'q');
      for (int i = 0; i < 100; ++i) {
        IciSegC seg;
        seg.key = next_key.fetch_add(1);
        seg.nbytes = 4096;
        seg.dev = 78;                 // resident: no relocate upcall
        seg.is_dev = 1;
        keys_issued.fetch_add(1);
        IciCallOut out;
        memset(&out, 0, sizeof(out));
        uint64_t rc = brpc_tpu_ici_call4(
            ch, "Echo.Svc", (const uint8_t*)payload.data(),
            payload.size(), nullptr, 0, &seg, 1, 10 * 1000 * 1000, 0,
            nullptr, 0, &out);
        if (rc != 0 || out.att_handle == 0 || out.nsegs != 1 ||
            out.seg0_key != seg.key || out.seg0_nbytes != 4096 ||
            out.segs != nullptr) {    // 1-seg shape: no malloc'd segs
          errs.fetch_add(1);
        } else if ((i + c) % 2 == 0) {
          // dispose: the release upcall must fire for the key
          if (brpc_tpu_ici_att_dispose(out.att_handle) != 0)
            errs.fetch_add(1);
          // consumed handles never resolve again
          if (brpc_tpu_ici_att_dispose(out.att_handle) != -1)
            errs.fetch_add(1);
        } else {
          // take (the caller owns the key); a taken handle never
          // resolves again
          if (brpc_tpu_ici_att_take(out.att_handle) != 1)
            errs.fetch_add(1);
          else
            keys_taken.fetch_add(1);
          if (brpc_tpu_ici_att_take(out.att_handle) != -1)
            errs.fetch_add(1);
        }
        if (out.resp) brpc_tpu_buf_free(out.resp);
        if (out.att) brpc_tpu_buf_free(out.att);
        if (out.err_text) brpc_tpu_buf_free(out.err_text);
      }
      brpc_tpu_ici_close(ch);
    });
  }
  for (auto& t : callers) t.join();
  brpc_tpu_ici_unlisten(sh);
  assert(errs.load() == 0);
  assert(g_att_errs.load() == 0);
  // exactly-one-exit balance: every issued key either released (via
  // dispose) or taken; nothing parked
  assert(g_released.load() + keys_taken.load() == keys_issued.load());
  assert(brpc_tpu_ici_att_count() == 0);
  printf("ici att custody ok (%llu keys, %llu released, %llu taken)\n",
         (unsigned long long)keys_issued.load(),
         (unsigned long long)g_released.load(),
         (unsigned long long)keys_taken.load());
}

}  // namespace

static const int kCallers = 4;
static const int kCallsPer = 150;

int main() {
  uint64_t sh = brpc_tpu_ici_listen_batch(77, batch_handler);
  assert(sh != 0);
  std::thread responder(responder_main);

  std::atomic<int> errs{0};
  std::vector<std::thread> callers;
  for (int c = 0; c < kCallers; ++c) {
    callers.emplace_back([&, c] {
      uint64_t ch = brpc_tpu_ici_connect(77, 77, 0);
      assert(ch != 0);
      std::string payload;
      for (int i = 0; i < kCallsPer; ++i) {
        payload.assign(16 + ((c * kCallsPer + i) % 33), 'a' + (c & 7));
        IciCallOut out;
        memset(&out, 0, sizeof(out));
        uint64_t rc = brpc_tpu_ici_call3(
            ch, "Echo.Svc", (const uint8_t*)payload.data(), payload.size(),
            nullptr, 0, nullptr, 0, 10 * 1000 * 1000, 0, nullptr, 0, &out);
        if (rc != 0 || out.resp_len != payload.size() ||
            memcmp(out.resp, payload.data(), payload.size()) != 0) {
          errs.fetch_add(1);
        }
        if (out.resp) brpc_tpu_buf_free(out.resp);
        if (out.att) brpc_tpu_buf_free(out.att);
        if (out.segs) brpc_tpu_buf_free(out.segs);
        if (out.err_text) brpc_tpu_buf_free(out.err_text);
      }
      brpc_tpu_ici_close(ch);
    });
  }
  for (auto& t : callers) t.join();
  assert(errs.load() == 0);
  assert(g_handled.load() == (uint64_t)kCallers * kCallsPer);
  printf("ici batched ABI ok (%llu requests)\n",
         (unsigned long long)g_handled.load());

  // stop-drain: calls racing an unlisten must fail cleanly (1009) or
  // succeed — never hang, leak, or double-free
  std::thread racer([&] {
    uint64_t ch = brpc_tpu_ici_connect(77, 77, 0);
    if (ch == 0) return;
    std::string payload(20, 'z');
    for (int i = 0; i < 50; ++i) {
      IciCallOut out;
      memset(&out, 0, sizeof(out));
      brpc_tpu_ici_call3(ch, "Echo.Svc", (const uint8_t*)payload.data(),
                         payload.size(), nullptr, 0, nullptr, 0,
                         2 * 1000 * 1000, 0, nullptr, 0, &out);
      if (out.resp) brpc_tpu_buf_free(out.resp);
      if (out.att) brpc_tpu_buf_free(out.att);
      if (out.segs) brpc_tpu_buf_free(out.segs);
      if (out.err_text) brpc_tpu_buf_free(out.err_text);
    }
    brpc_tpu_ici_close(ch);
  });
  brpc_tpu_ici_unlisten(sh);
  racer.join();

  {
    std::lock_guard<std::mutex> g(g_mu);
    g_stop = true;
  }
  g_cv.notify_all();
  responder.join();

  // ---- resolved-seg ABI (native att custody) ---------------------------
  // Concurrent callers ship device segs through call4; the handler sees
  // att_handle + the seg0 inline mirror and passes the handle straight
  // back (the echo pass-through).  The caller then exits custody by
  // dispose (release upcall must fire) or take (no release) — the
  // exactly-one-exit balance is asserted at the end, and the table must
  // drain to zero.  Under TSan this covers the att-table lock; under
  // ASan the entry lifetime across pass-through and pop.
  att_custody_smoke();

  printf("ALL ICI SMOKE PASSED\n");
  return 0;
}
