// SPSC record ring for the port's TensorRing (host code, not a kernel).
//
// The port's counterpart of the JAX package's native/src/spsc_ring.cpp: a
// single-producer / single-consumer ring of fixed-size record slots, with
// two differences.
//
// - The arena is the caller's.  The Python side allocates it (a
//   page-locked tensor on the card route, so a claimed batch copies to
//   the card straight from its slots) and keeps it alive for the ring's
//   lifetime; this code never allocates or frees it.
// - The producer does not copy.  It submits a record as one pointer per
//   field; a copier thread that this ring owns copies each row into its
//   field's region (the SoA layout the caller passes) and publishes the
//   slot.  The producer is an interpreter thread whose copies, made
//   there, hold or give up the interpreter lock that the dispatch lanes
//   need; the copier never touches the interpreter.
//
// Counters (all monotone record counts): submitted (producer), copied
// (copier: every slot below it holds its rows), head (consumer: slots
// below it are free).  The consumer may claim slots that are submitted
// and not yet copied, and must wait for them (ring_wait_copied) before it
// reads them.  The producer submits into a slot only after the consumer
// released it, and the consumer releases only slots it read, so a slot
// is never written under a reader.  The caller keeps a submitted record's
// buffers alive until it is copied.
//
// Build: any C++17 host compiler, e.g.
//   c++ -std=c++17 -O2 -shared -fPIC -o libspsc_ring.so spsc_ring.cpp

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <new>
#include <thread>
#include <vector>

namespace {

struct Ring {
  uint64_t n_slots;     // power of two
  uint64_t mask;        // n_slots - 1
  uint8_t* arena;       // the SoA regions, owned by the caller
  uint64_t n_fields;
  std::vector<uint64_t> offsets;    // per field: its region's offset in the arena
  std::vector<uint64_t> row_bytes;  // per field: bytes of one record's row
  std::vector<const void*> src;     // per slot, per field: the submitted row
  alignas(64) std::atomic<uint64_t> head{0};
  alignas(64) std::atomic<uint64_t> submitted{0};
  alignas(64) std::atomic<uint64_t> copied{0};
  std::mutex mu;
  std::condition_variable work;     // the copier waits for submissions
  std::condition_variable done;     // ring_wait_copied waits for copies
  bool stop = false;
  std::thread copier;
};

void copy_loop(Ring* r) {
  uint64_t next = 0;
  std::unique_lock<std::mutex> lk(r->mu);
  for (;;) {
    r->work.wait(lk, [&] {
      return r->stop || r->submitted.load(std::memory_order_acquire) > next;
    });
    uint64_t end = r->submitted.load(std::memory_order_acquire);
    if (end == next) return;  // stopped, every submission copied
    lk.unlock();
    for (; next < end; ++next) {
      uint64_t slot = next & r->mask;
      const void* const* rows = &r->src[slot * r->n_fields];
      for (uint64_t f = 0; f < r->n_fields; ++f) {
        std::memcpy(r->arena + r->offsets[f] + slot * r->row_bytes[f], rows[f],
                    r->row_bytes[f]);
      }
      r->copied.store(next + 1, std::memory_order_release);
    }
    lk.lock();
    r->done.notify_all();
  }
}

}  // namespace

extern "C" {

// A ring of n_slots (rounded up to a power of two) slots over the
// caller's arena, whose n_fields regions start at offsets[f] and hold the
// rounded count of rows of row_bytes[f] bytes each; starts its copier
// thread.  Returns nullptr on a null arena or a failure.
Ring* ring_create(uint64_t n_slots, uint8_t* arena, uint64_t n_fields,
                  const uint64_t* offsets, const uint64_t* row_bytes) {
  if (!arena || n_fields == 0) return nullptr;
  uint64_t pow2 = 1;
  while (pow2 < n_slots) pow2 <<= 1;
  Ring* r = new (std::nothrow) Ring();
  if (!r) return nullptr;
  try {
    r->n_slots = pow2;
    r->mask = pow2 - 1;
    r->arena = arena;
    r->n_fields = n_fields;
    r->offsets.assign(offsets, offsets + n_fields);
    r->row_bytes.assign(row_bytes, row_bytes + n_fields);
    r->src.assign(pow2 * n_fields, nullptr);
    r->copier = std::thread(copy_loop, r);
  } catch (...) {
    delete r;
    return nullptr;
  }
  return r;
}

// Copies what was submitted, stops the copier and frees the ring (not
// the arena, which stays the caller's).
void ring_destroy(Ring* r) {
  if (!r) return;
  {
    std::lock_guard<std::mutex> lk(r->mu);
    r->stop = true;
  }
  r->work.notify_all();
  r->copier.join();
  delete r;
}

uint64_t ring_capacity(Ring* r) { return r->n_slots; }

// Producer: submit one record, src[f] being field f's row (row_bytes[f]
// bytes, alive until ring_copied passes the record).  Returns its slot,
// or -1 when the ring is full.
int64_t ring_submit(Ring* r, const void* const* src) {
  uint64_t s = r->submitted.load(std::memory_order_relaxed);
  if (s - r->head.load(std::memory_order_acquire) >= r->n_slots) return -1;
  uint64_t slot = s & r->mask;
  std::memcpy(&r->src[slot * r->n_fields], src, r->n_fields * sizeof(const void*));
  {
    std::lock_guard<std::mutex> lk(r->mu);
    r->submitted.store(s + 1, std::memory_order_release);
  }
  r->work.notify_one();
  return static_cast<int64_t>(slot);
}

// Records copied so far: the slots below it hold their rows.
uint64_t ring_copied(Ring* r) { return r->copied.load(std::memory_order_acquire); }

// Consumer: records submitted and not yet released.
uint64_t ring_poppable(Ring* r) {
  return r->submitted.load(std::memory_order_acquire) -
         r->head.load(std::memory_order_relaxed);
}

// Consumer: wait until the first `upto` records are copied.
void ring_wait_copied(Ring* r, uint64_t upto) {
  if (r->copied.load(std::memory_order_acquire) >= upto) return;
  std::unique_lock<std::mutex> lk(r->mu);
  r->done.wait(lk, [&] { return r->copied.load(std::memory_order_acquire) >= upto; });
}

// Consumer: free the OLDEST count slots for reuse (claims live in the
// Python layer; releases follow claim order, and only of copied slots).
void ring_pop_release(Ring* r, uint64_t count) {
  r->head.fetch_add(count, std::memory_order_release);
}

}  // extern "C"
