// FlatMap64: open-addressing hash map for u64 keys on the datapath hot
// paths (correlation tables, pending-token maps, bulk-frame parking).
//
// The reference keeps a purpose-built flat_map (src/butil/containers/
// flat_map.h) precisely for these maps: one contiguous slot array, no
// per-node allocation, no pointer chasing on lookup — properties
// std::unordered_map (node-based, allocator-heavy) lacks.  This is an
// independent design with the same goals: linear probing over a
// power-of-two slot array, tombstone deletion, rehash at 0.7 combined
// (live + tombstone) load.  Keys are arbitrary u64 (0 is a valid key:
// occupancy is a state byte, not a sentinel key).
//
// Not thread-safe; callers hold their own mutex (all current users
// already serialize access with the lock that guarded their
// unordered_map).
#pragma once

#include <cstddef>
#include <cstdint>
#include <utility>
#include <vector>

namespace nbase {

template <typename V>
class FlatMap64 {
  enum State : uint8_t { kEmpty = 0, kFull = 1, kDel = 2 };
  struct Slot {
    uint64_t key;
    V value;
    State state;
  };

 public:
  // initial_slots: requested slot COUNT (rounded up to a power of two),
  // not an exponent.
  explicit FlatMap64(size_t initial_slots = 16) {
    slots_.resize(initial_slots < 4 ? 4 : round_up_pow2(initial_slots));
    for (auto& s : slots_) s.state = kEmpty;
  }

  size_t size() const { return size_; }
  size_t capacity() const { return slots_.size(); }
  bool empty() const { return size_ == 0; }

  // Pointer to the value for `key`, or nullptr.  Never allocates.
  V* seek(uint64_t key) {
    Slot* s = find_slot(key);
    return s == nullptr ? nullptr : &s->value;
  }

  // Insert or overwrite; returns the value slot.
  V& operator[](uint64_t key) {
    maybe_grow();
    size_t mask = slots_.size() - 1;
    size_t i = hash(key) & mask;
    size_t first_del = (size_t)-1;
    for (;;) {
      Slot& s = slots_[i];
      if (s.state == kFull && s.key == key) return s.value;
      if (s.state == kDel && first_del == (size_t)-1) first_del = i;
      if (s.state == kEmpty) {
        size_t at = first_del != (size_t)-1 ? first_del : i;
        Slot& t = slots_[at];
        if (t.state != kDel) ++used_;
        t.key = key;
        t.state = kFull;
        t.value = V();
        ++size_;
        return t.value;
      }
      i = (i + 1) & mask;
    }
  }

  // 1 if erased, 0 if absent.  The value is destroyed (reset) in place.
  size_t erase(uint64_t key) {
    Slot* s = find_slot(key);
    if (s == nullptr) return 0;
    s->value = V();          // release held resources (shared_ptrs etc.)
    s->state = kDel;
    --size_;
    return 1;
  }

  // Erase-and-return: common correlation idiom (find+take under lock).
  bool take(uint64_t key, V* out) {
    Slot* s = find_slot(key);
    if (s == nullptr) return false;
    *out = std::move(s->value);
    s->value = V();
    s->state = kDel;
    --size_;
    return true;
  }

  template <typename F>
  void for_each(F f) {
    for (auto& s : slots_)
      if (s.state == kFull) f(s.key, s.value);
  }

  void clear() {
    for (auto& s : slots_) {
      if (s.state == kFull) s.value = V();
      s.state = kEmpty;
    }
    size_ = used_ = 0;
  }

  // O(1) content exchange — fail_all-style paths take the whole table
  // out under a hot lock and process it outside.
  void swap(FlatMap64& other) {
    slots_.swap(other.slots_);
    std::swap(size_, other.size_);
    std::swap(used_, other.used_);
  }

 private:
  Slot* find_slot(uint64_t key) {
    size_t mask = slots_.size() - 1;
    size_t i = hash(key) & mask;
    for (;;) {
      Slot& s = slots_[i];
      if (s.state == kEmpty) return nullptr;
      if (s.state == kFull && s.key == key) return &s;
      i = (i + 1) & mask;
    }
  }

  static size_t round_up_pow2(size_t n) {
    size_t p = 4;
    while (p < n) p <<= 1;
    return p;
  }

  static size_t hash(uint64_t key) {
    // splitmix64 finalizer: sequential cids (the common key pattern)
    // must not cluster into probe chains
    uint64_t z = key + 0x9e3779b97f4a7c15ull;
    z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ull;
    z = (z ^ (z >> 27)) * 0x94d049bb133111ebull;
    return (size_t)(z ^ (z >> 31));
  }

  void maybe_grow() {
    if ((used_ + 1) * 10 < slots_.size() * 7) return;
    // Size the new table from LIVE entries, not used_ (live +
    // tombstones): the dominant workload here is a correlation table —
    // insert cid, take cid, unique keys forever — whose live size stays
    // tiny while tombstones accumulate.  Doubling on tombstone load
    // grew capacity linearly with total call count
    // (measured ~150 MB after 10M insert/take cycles with live<=1); a
    // same-capacity rehash clears the tombstones instead, and capacity
    // doubles only when live entries actually demand it.
    size_t want = slots_.size();
    if ((size_ + 1) * 10 >= want * 5) want *= 2;
    std::vector<Slot> old;
    old.swap(slots_);
    slots_.resize(want);
    for (auto& s : slots_) s.state = kEmpty;
    size_ = used_ = 0;
    for (auto& s : old)
      if (s.state == kFull) (*this)[s.key] = std::move(s.value);
  }

  std::vector<Slot> slots_;
  size_t size_ = 0;  // live entries
  size_t used_ = 0;  // live + tombstones (drives rehash)
};

}  // namespace nbase
