// Fabric-plane smoke of the port's fabric_native.cpp for sanitizer builds
// (tests/test_torch_sanitizers.py builds it with -fsanitize=thread and
// with -fsanitize=address against a sanitized libfabric_native and runs
// it with halt_on_error=1).
//
// Exercises exactly the concurrency the Python fabric drives: a
// listener with a parked-connection claim, several sender threads
// pushing uuid-tagged frames (send + gather-sendv) while the per-conn
// reader thread parks them, concurrent blocking claims with buffer
// releases, the liveness probe, and a full quiesce — the thread-owning
// teardown path behind exit-race aborts.  Run under TSan this covers
// the frame-map and registry locking; under ASan it proves buffer
// custody (claim/release exactly once, no use-after-free on teardown).
#include <atomic>
#include <cassert>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

extern "C" {
uint64_t brpc_tpu_torch_shm_create(const char* name, uint64_t ring_bytes);
uint64_t brpc_tpu_torch_shm_attach(const char* name);
int brpc_tpu_torch_shm_unlink(const char* name);
int brpc_tpu_torch_shm_send(uint64_t h, uint64_t uuid, const uint8_t* data,
                      uint64_t len, int64_t timeout_us);
int brpc_tpu_torch_shm_sendv(uint64_t h, uint64_t uuid,
                       const uint8_t* const* ptrs, const uint64_t* lens,
                       int n, int64_t timeout_us);
int brpc_tpu_torch_shm_recv(uint64_t h, uint64_t uuid, int64_t timeout_us,
                      uint8_t** out, uint64_t* out_len);
void brpc_tpu_torch_shm_release(uint64_t h, uint8_t* p, uint64_t len);
int brpc_tpu_torch_shm_alive(uint64_t h);
void brpc_tpu_torch_shm_close(uint64_t h);
int brpc_tpu_torch_shm_stats(uint64_t h, uint64_t* out, int cap);
uint64_t brpc_tpu_torch_shm_create2(const char* name, uint64_t ring_bytes,
                              uint32_t nstripes);
int brpc_tpu_torch_shm_send2(uint64_t h, uint32_t stripe, uint64_t uuid,
                       const uint8_t* data, uint64_t len,
                       int64_t timeout_us);
int brpc_tpu_torch_shm_sendv2(uint64_t h, uint32_t stripe, uint64_t uuid,
                        const uint8_t* const* ptrs, const uint64_t* lens,
                        int n, int64_t timeout_us);
int brpc_tpu_torch_shm_recv2(uint64_t h, uint32_t stripe, uint64_t uuid,
                       int64_t timeout_us, uint8_t** out,
                       uint64_t* out_len);
uint32_t brpc_tpu_torch_shm_stripes(uint64_t h);
int brpc_tpu_torch_shm_stripe_stats(uint64_t h, uint32_t stripe, uint64_t* out,
                              int cap);
int brpc_tpu_torch_shm_chaos(uint64_t h, int mode, int64_t arg);
uint64_t brpc_tpu_torch_fab_listen(const char* host, int* port_out,
                             char* uds_out, int uds_cap);
uint64_t brpc_tpu_torch_fab_connect(const char* host, int port, const char* key);
uint64_t brpc_tpu_torch_fab_accept(uint64_t lh, const char* key,
                             int64_t timeout_us);
int brpc_tpu_torch_fab_send(uint64_t h, uint64_t uuid, const uint8_t* data,
                      uint64_t len);
int brpc_tpu_torch_fab_sendv(uint64_t h, uint64_t uuid, const uint8_t* const* ptrs,
                       const uint64_t* lens, int n);
int brpc_tpu_torch_fab_recv(uint64_t h, uint64_t uuid, int64_t timeout_us,
                      uint8_t** out, uint64_t* out_len);
void brpc_tpu_torch_fab_buf_release(uint64_t h, uint8_t* p, uint64_t len);
int brpc_tpu_torch_fab_alive(uint64_t h);
uint64_t brpc_tpu_torch_fab_bytes(uint64_t h, int dir);
void brpc_tpu_torch_fab_conn_close(uint64_t h);
void brpc_tpu_torch_fab_listener_close(uint64_t lh);
void brpc_tpu_torch_fab_quiesce();
}

static const int kSenders = 4;
static const int kFramesPerSender = 32;
static const uint64_t kFrameLen = 64 * 1024;

int main() {
  int port = 0;
  char uds[108];
  uint64_t lh = brpc_tpu_torch_fab_listen("127.0.0.1", &port, uds, sizeof(uds));
  assert(lh != 0 && port > 0);

  uint64_t cli = brpc_tpu_torch_fab_connect("127.0.0.1", port, "smoke-key");
  assert(cli != 0);
  uint64_t srv = brpc_tpu_torch_fab_accept(lh, "smoke-key", 5 * 1000 * 1000);
  assert(srv != 0);
  assert(brpc_tpu_torch_fab_alive(cli) && brpc_tpu_torch_fab_alive(srv));

  // concurrent senders (client -> server), one uuid range per sender;
  // even frames go out as one buffer, odd ones as a 3-part gather
  std::vector<std::thread> senders;
  std::atomic<int> send_errs{0};
  for (int s = 0; s < kSenders; ++s) {
    senders.emplace_back([&, s] {
      std::vector<uint8_t> buf(kFrameLen);
      for (int i = 0; i < kFramesPerSender; ++i) {
        uint64_t uuid = (uint64_t)(s + 1) << 32 | (uint64_t)i;
        memset(buf.data(), (s * kFramesPerSender + i) & 0xFF, buf.size());
        int rc;
        if (i % 2 == 0) {
          rc = brpc_tpu_torch_fab_send(cli, uuid, buf.data(), buf.size());
        } else {
          const uint8_t* ptrs[3] = {buf.data(), buf.data() + 1000,
                                    buf.data() + 50000};
          const uint64_t lens[3] = {1000, 49000, kFrameLen - 50000};
          rc = brpc_tpu_torch_fab_sendv(cli, uuid, ptrs, lens, 3);
        }
        if (rc != 0) send_errs.fetch_add(1);
      }
    });
  }

  // concurrent claimers on the server conn: one thread per sender's
  // uuid range, blocking claims racing the parking reader
  std::vector<std::thread> claimers;
  std::atomic<int> claim_errs{0};
  std::atomic<uint64_t> claimed_bytes{0};
  for (int s = 0; s < kSenders; ++s) {
    claimers.emplace_back([&, s] {
      for (int i = 0; i < kFramesPerSender; ++i) {
        uint64_t uuid = (uint64_t)(s + 1) << 32 | (uint64_t)i;
        uint8_t* p = nullptr;
        uint64_t n = 0;
        int rc = brpc_tpu_torch_fab_recv(srv, uuid, 10 * 1000 * 1000, &p, &n);
        if (rc != 0 || n != kFrameLen) {
          claim_errs.fetch_add(1);
          continue;
        }
        uint8_t want = (uint8_t)((s * kFramesPerSender + i) & 0xFF);
        if (p[0] != want || p[n - 1] != want) claim_errs.fetch_add(1);
        claimed_bytes.fetch_add(n);
        brpc_tpu_torch_fab_buf_release(srv, p, n);
      }
    });
  }

  for (auto& t : senders) t.join();
  for (auto& t : claimers) t.join();
  assert(send_errs.load() == 0);
  assert(claim_errs.load() == 0);
  assert(claimed_bytes.load() ==
         (uint64_t)kSenders * kFramesPerSender * kFrameLen);
  printf("fabric transfer ok (%llu bytes)\n",
         (unsigned long long)claimed_bytes.load());

  // a claim for a frame that never arrives on a dying conn fails fast
  // instead of stranding the claimer: close the client while a recv is
  // parked server-side
  std::thread late_claim([&] {
    uint8_t* p = nullptr;
    uint64_t n = 0;
    int rc = brpc_tpu_torch_fab_recv(srv, 0xDEAD, 10 * 1000 * 1000, &p, &n);
    assert(rc != 0);
  });
  brpc_tpu_torch_fab_conn_close(cli);
  late_claim.join();
  printf("dead-conn claim fails fast ok\n");

  brpc_tpu_torch_fab_conn_close(srv);
  brpc_tpu_torch_fab_listener_close(lh);

  // ---- shm ring tier: the same concurrency the Python fabric drives —
  // several producer threads gather-sending into one ring (serialized
  // by the conn's tx lock) racing several claimers, a SMALL ring so
  // wraparound and full-ring doorbell blocking fire constantly, then
  // teardown mid-transfer with parked claims outstanding.  TSan covers
  // the scan/claim/retire bookkeeping locks + the cross-"process"
  // publish protocol (two mappings of the same pages); ASan proves slot
  // custody (claim/release exactly once, deferred unmap after close).
  {
    const char* seg = "brpc_tpu_torch_shm_smoke";
    brpc_tpu_torch_shm_unlink(seg);
    uint64_t ha = brpc_tpu_torch_shm_create(seg, 256 * 1024);  // small: wraps
    assert(ha != 0);
    uint64_t hb = brpc_tpu_torch_shm_attach(seg);
    assert(hb != 0);
    assert(brpc_tpu_torch_shm_unlink(seg) == 0);
    assert(brpc_tpu_torch_shm_alive(ha) && brpc_tpu_torch_shm_alive(hb));

    const int kShmSenders = 4, kShmFrames = 64;
    const uint64_t kShmLen = 24 * 1024;   // 4 in flight ~ fills the ring
    std::vector<std::thread> sthreads, cthreads;
    std::atomic<int> serrs{0}, cerrs{0};
    std::atomic<uint64_t> cbytes{0};
    for (int s = 0; s < kShmSenders; ++s) {
      sthreads.emplace_back([&, s] {
        std::vector<uint8_t> buf(kShmLen);
        for (int i = 0; i < kShmFrames; ++i) {
          uint64_t uuid = (uint64_t)(s + 1) << 32 | (uint64_t)i;
          memset(buf.data(), (s * kShmFrames + i) & 0xFF, buf.size());
          int rc;
          if (i % 2 == 0) {
            rc = brpc_tpu_torch_shm_send(ha, uuid, buf.data(), buf.size(),
                                   10 * 1000 * 1000);
          } else {
            const uint8_t* ptrs[3] = {buf.data(), buf.data() + 512,
                                      buf.data() + 9000};
            const uint64_t lens[3] = {512, 8488, kShmLen - 9000};
            rc = brpc_tpu_torch_shm_sendv(ha, uuid, ptrs, lens, 3,
                                    10 * 1000 * 1000);
          }
          if (rc != 0) serrs.fetch_add(1);
        }
      });
    }
    for (int s = 0; s < kShmSenders; ++s) {
      cthreads.emplace_back([&, s] {
        for (int i = 0; i < kShmFrames; ++i) {
          uint64_t uuid = (uint64_t)(s + 1) << 32 | (uint64_t)i;
          uint8_t* p = nullptr;
          uint64_t n = 0;
          int rc = brpc_tpu_torch_shm_recv(hb, uuid, 10 * 1000 * 1000, &p, &n);
          if (rc != 0 || n != kShmLen) {
            cerrs.fetch_add(1);
            continue;
          }
          uint8_t want = (uint8_t)((s * kShmFrames + i) & 0xFF);
          if (p[0] != want || p[n - 1] != want) cerrs.fetch_add(1);
          cbytes.fetch_add(n);
          brpc_tpu_torch_shm_release(hb, p, n);
        }
      });
    }
    for (auto& t : sthreads) t.join();
    for (auto& t : cthreads) t.join();
    assert(serrs.load() == 0);
    assert(cerrs.load() == 0);
    assert(cbytes.load() == (uint64_t)kShmSenders * kShmFrames * kShmLen);
    uint64_t st[6];
    assert(brpc_tpu_torch_shm_stats(ha, st, 6) == 6);
    assert(st[0] == cbytes.load());
    printf("shm ring transfer ok (%llu bytes, %llu doorbell waits)\n",
           (unsigned long long)cbytes.load(), (unsigned long long)st[4]);

    // teardown mid-transfer: a claim parked on a frame that never
    // arrives fails fast when the ring dies; a CLAIMED buffer stays
    // readable after close (deferred unmap) until released
    uint8_t one[64];
    memset(one, 0x5A, sizeof(one));
    assert(brpc_tpu_torch_shm_send(ha, 0x777, one, sizeof(one),
                             1000 * 1000) == 0);
    uint8_t* held = nullptr;
    uint64_t held_n = 0;
    assert(brpc_tpu_torch_shm_recv(hb, 0x777, 1000 * 1000, &held, &held_n) == 0);
    std::thread parked([&] {
      uint8_t* p = nullptr;
      uint64_t n = 0;
      int rc = brpc_tpu_torch_shm_recv(hb, 0xBEEF, 10 * 1000 * 1000, &p, &n);
      assert(rc == -2);
    });
    brpc_tpu_torch_shm_close(ha);
    parked.join();
    assert(!brpc_tpu_torch_shm_alive(hb));
    assert(held[0] == 0x5A && held[held_n - 1] == 0x5A);
    brpc_tpu_torch_shm_close(hb);              // claims out: unmap deferred
    assert(held[0] == 0x5A);             // still mapped until release
    brpc_tpu_torch_shm_release(hb, held, held_n);   // last release unmaps
    printf("shm teardown mid-transfer ok\n");
  }

  // ---- STRIPED shm rings: concurrent sender+claimer pairs
  // on DISTINCT stripes of one v2 segment — the per-stripe lock split
  // is exactly what TSan must bless (no shared tx/rx mutex between
  // stripes), with small rings so wrap + doorbell blocking fire inside
  // each stripe.  Then the stripe-kill chaos path: one stripe's send
  // dies and the SHARED death word degrades the whole plane, while a
  // claimed buffer on another stripe stays readable until released
  // (deferred unmap across stripes).
  {
    const char* seg = "brpc_tpu_torch_shm_smoke_striped";
    brpc_tpu_torch_shm_unlink(seg);
    const uint32_t kStripes = 4;
    uint64_t ha = brpc_tpu_torch_shm_create2(seg, 128 * 1024, kStripes);
    assert(ha != 0);
    uint64_t hb = brpc_tpu_torch_shm_attach(seg);   // layout auto-detected
    assert(hb != 0);
    assert(brpc_tpu_torch_shm_unlink(seg) == 0);
    assert(brpc_tpu_torch_shm_stripes(ha) == kStripes);
    assert(brpc_tpu_torch_shm_stripes(hb) == kStripes);

    const int kFrames = 48;
    const uint64_t kLen = 20 * 1024;
    std::vector<std::thread> sthreads, cthreads;
    std::atomic<int> serrs{0}, cerrs{0};
    std::atomic<uint64_t> cbytes{0};
    for (uint32_t s = 0; s < kStripes; ++s) {
      sthreads.emplace_back([&, s] {
        std::vector<uint8_t> buf(kLen);
        for (int i = 0; i < kFrames; ++i) {
          uint64_t uuid = (uint64_t)(s + 1) << 32 | (uint64_t)i;
          memset(buf.data(), (s * kFrames + i) & 0xFF, buf.size());
          int rc;
          if (i % 2 == 0) {
            rc = brpc_tpu_torch_shm_send2(ha, s, uuid, buf.data(), buf.size(),
                                    10 * 1000 * 1000);
          } else {
            const uint8_t* ptrs[2] = {buf.data(), buf.data() + 700};
            const uint64_t lens[2] = {700, kLen - 700};
            rc = brpc_tpu_torch_shm_sendv2(ha, s, uuid, ptrs, lens, 2,
                                     10 * 1000 * 1000);
          }
          if (rc != 0) serrs.fetch_add(1);
        }
      });
      cthreads.emplace_back([&, s] {
        for (int i = 0; i < kFrames; ++i) {
          uint64_t uuid = (uint64_t)(s + 1) << 32 | (uint64_t)i;
          uint8_t* p = nullptr;
          uint64_t n = 0;
          int rc = brpc_tpu_torch_shm_recv2(hb, s, uuid, 10 * 1000 * 1000,
                                      &p, &n);
          if (rc != 0 || n != kLen) {
            cerrs.fetch_add(1);
            continue;
          }
          uint8_t want = (uint8_t)((s * kFrames + i) & 0xFF);
          if (p[0] != want || p[n - 1] != want) cerrs.fetch_add(1);
          cbytes.fetch_add(n);
          brpc_tpu_torch_shm_release(hb, p, n);
        }
      });
    }
    for (auto& t : sthreads) t.join();
    for (auto& t : cthreads) t.join();
    assert(serrs.load() == 0);
    assert(cerrs.load() == 0);
    assert(cbytes.load() == (uint64_t)kStripes * kFrames * kLen);
    uint64_t st[6];
    // per-stripe truth: every stripe moved exactly its share
    for (uint32_t s = 0; s < kStripes; ++s) {
      assert(brpc_tpu_torch_shm_stripe_stats(ha, s, st, 6) == 6);
      assert(st[0] == (uint64_t)kFrames * kLen);
    }
    // conn aggregate matches
    assert(brpc_tpu_torch_shm_stats(ha, st, 6) == 6);
    assert(st[0] == cbytes.load());
    printf("shm striped transfer ok (%llu bytes over %u stripes)\n",
           (unsigned long long)cbytes.load(), kStripes);

    // stripe-kill: park a claimed buffer on stripe 0, then kill via
    // stripe 2's send — the whole plane reads dead (shared death word),
    // a parked claim on stripe 3 fails fast, and the stripe-0 claim
    // stays readable until released
    uint8_t one[64];
    memset(one, 0xA5, sizeof(one));
    assert(brpc_tpu_torch_shm_send2(ha, 0, 0x701, one, sizeof(one),
                              1000 * 1000) == 0);
    uint8_t* held = nullptr;
    uint64_t held_n = 0;
    assert(brpc_tpu_torch_shm_recv2(hb, 0, 0x701, 1000 * 1000, &held,
                              &held_n) == 0);
    std::thread parked([&] {
      uint8_t* p = nullptr;
      uint64_t n = 0;
      int rc = brpc_tpu_torch_shm_recv2(hb, 3, 0xBEEF, 10 * 1000 * 1000, &p,
                                  &n);
      assert(rc == -2);
    });
    assert(brpc_tpu_torch_shm_chaos(ha, 5, 2) == 0);     // arm stripe-2 kill
    assert(brpc_tpu_torch_shm_send2(ha, 2, 0x702, one, sizeof(one),
                              1000 * 1000) == -1);
    assert(!brpc_tpu_torch_shm_alive(ha));
    assert(!brpc_tpu_torch_shm_alive(hb));
    parked.join();
    assert(held[0] == 0xA5 && held[held_n - 1] == 0xA5);
    brpc_tpu_torch_shm_close(ha);
    brpc_tpu_torch_shm_close(hb);              // claim out: unmap deferred
    assert(held[0] == 0xA5);
    brpc_tpu_torch_shm_release(hb, held, held_n);
    printf("shm stripe-kill degrade ok\n");
  }

  // the exit-race teardown path: close + join every reader thread
  brpc_tpu_torch_fab_quiesce();
  printf("ALL FABRIC SMOKE PASSED\n");
  return 0;
}
