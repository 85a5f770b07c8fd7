// Native IO core of paddle_tpu_torch: a copy of the JAX package's
// paddle_tpu/native/src/io_core.cpp (the C++ data path the reference keeps
// in paddle/fluid/framework/data_feed* and the DataLoader C workers), so
// both packages shuffle, gather and queue the same batches.
//
// The card consumes large host batches; the Python overhead that matters is
// index shuffling, per-sample gathering, and keeping the next batch ready
// while the card runs. All three live here, off the GIL (ctypes releases it
// for the call duration; the prefetcher's producer runs on its own
// std::thread).
//
// C ABI only, bound via ctypes.
//
//   ptio_shuffle        deterministic Fisher-Yates over an index array
//   ptio_gather         multithreaded fixed-size-record gather
//   ptio_prefetcher_*   background producer of shuffled, gathered batches
//                       into a bounded queue (epoch-based, reusable)

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <mutex>
#include <thread>
#include <vector>

namespace {

// splitmix64: tiny, seedable, high-quality enough for shuffling
static inline uint64_t splitmix64(uint64_t& state) {
  uint64_t z = (state += 0x9e3779b97f4a7c15ull);
  z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ull;
  z = (z ^ (z >> 27)) * 0x94d049bb133111ebull;
  return z ^ (z >> 31);
}

// unbiased bounded draw (Lemire)
static inline uint64_t bounded(uint64_t& state, uint64_t n) {
  uint64_t x = splitmix64(state);
  __uint128_t m = (__uint128_t)x * (__uint128_t)n;
  uint64_t l = (uint64_t)m;
  if (l < n) {
    uint64_t t = -n % n;
    while (l < t) {
      x = splitmix64(state);
      m = (__uint128_t)x * (__uint128_t)n;
      l = (uint64_t)m;
    }
  }
  return (uint64_t)(m >> 64);
}

void shuffle_indices(int64_t* idx, int64_t n, uint64_t seed) {
  uint64_t state = seed ^ 0xdeadbeefcafef00dull;
  for (int64_t i = n - 1; i > 0; --i) {
    uint64_t j = bounded(state, (uint64_t)(i + 1));
    int64_t tmp = idx[i];
    idx[i] = idx[j];
    idx[j] = tmp;
  }
}

void gather_records(const uint8_t* src, const int64_t* indices,
                    int64_t n_idx, int64_t record_bytes, uint8_t* dst,
                    int32_t n_threads) {
  if (n_threads <= 1 || n_idx < n_threads * 4) {
    for (int64_t i = 0; i < n_idx; ++i)
      std::memcpy(dst + i * record_bytes, src + indices[i] * record_bytes,
                  (size_t)record_bytes);
    return;
  }
  std::vector<std::thread> threads;
  int64_t chunk = (n_idx + n_threads - 1) / n_threads;
  for (int32_t t = 0; t < n_threads; ++t) {
    int64_t lo = t * chunk;
    int64_t hi = std::min(lo + chunk, n_idx);
    if (lo >= hi) break;
    threads.emplace_back([=]() {
      for (int64_t i = lo; i < hi; ++i)
        std::memcpy(dst + i * record_bytes, src + indices[i] * record_bytes,
                    (size_t)record_bytes);
    });
  }
  for (auto& th : threads) th.join();
}

struct Batch {
  std::vector<std::vector<uint8_t>> bufs;  // one per array
  int64_t size = 0;                        // records in this batch
};

struct Prefetcher {
  // dataset: n_arrays parallel arrays sharing the leading dim
  std::vector<const uint8_t*> srcs;
  std::vector<int64_t> record_bytes;
  int64_t n_records = 0;
  int64_t batch_size = 0;
  bool drop_last = false;
  bool shuffle = false;
  int32_t capacity = 2;
  int32_t n_threads = 1;

  std::vector<int64_t> order;
  std::deque<Batch> queue;
  std::mutex mu;
  std::condition_variable cv_push, cv_pop;
  std::thread producer;
  std::atomic<bool> stop{false};
  bool epoch_done = true;  // producer finished current epoch

  void produce(uint64_t seed) {
    if (shuffle) shuffle_indices(order.data(), n_records, seed);
    int64_t pos = 0;
    while (pos < n_records && !stop.load(std::memory_order_relaxed)) {
      int64_t bs = std::min(batch_size, n_records - pos);
      if (bs < batch_size && drop_last) break;
      Batch b;
      b.size = bs;
      b.bufs.resize(srcs.size());
      for (size_t a = 0; a < srcs.size(); ++a) {
        b.bufs[a].resize((size_t)(bs * record_bytes[a]));
        gather_records(srcs[a], order.data() + pos, bs, record_bytes[a],
                       b.bufs[a].data(), n_threads);
      }
      pos += bs;
      std::unique_lock<std::mutex> lk(mu);
      cv_push.wait(lk, [&] {
        return (int32_t)queue.size() < capacity ||
               stop.load(std::memory_order_relaxed);
      });
      if (stop.load(std::memory_order_relaxed)) break;
      queue.push_back(std::move(b));
      cv_pop.notify_one();
    }
    // EVERY exit path must mark the epoch done and wake readers —
    // otherwise a reader blocked in ptio_prefetcher_next survives destroy
    // and wakes on a freed condvar
    std::lock_guard<std::mutex> lk(mu);
    epoch_done = true;
    cv_pop.notify_all();
  }
};

}  // namespace

extern "C" {

void ptio_shuffle(int64_t* idx, int64_t n, uint64_t seed) {
  shuffle_indices(idx, n, seed);
}

void ptio_gather(const uint8_t* src, const int64_t* indices, int64_t n_idx,
                 int64_t record_bytes, uint8_t* dst, int32_t n_threads) {
  gather_records(src, indices, n_idx, record_bytes, dst, n_threads);
}

void* ptio_prefetcher_create(const uint8_t** srcs,
                             const int64_t* record_bytes, int32_t n_arrays,
                             int64_t n_records, int64_t batch_size,
                             int32_t drop_last, int32_t shuffle,
                             int32_t capacity, int32_t n_threads) {
  if (n_arrays <= 0 || n_records <= 0 || batch_size <= 0) return nullptr;
  auto* p = new Prefetcher();
  p->srcs.assign(srcs, srcs + n_arrays);
  p->record_bytes.assign(record_bytes, record_bytes + n_arrays);
  p->n_records = n_records;
  p->batch_size = batch_size;
  p->drop_last = drop_last != 0;
  p->shuffle = shuffle != 0;
  p->capacity = capacity > 0 ? capacity : 2;
  p->n_threads = n_threads > 0 ? n_threads : 1;
  p->order.resize(n_records);
  for (int64_t i = 0; i < n_records; ++i) p->order[i] = i;
  return p;
}

// Begin one pass over the data: joins any previous epoch, clears the
// queue, reshuffles (when enabled) with epoch_seed, starts the producer.
void ptio_prefetcher_start_epoch(void* h, uint64_t epoch_seed) {
  auto* p = static_cast<Prefetcher*>(h);
  if (p->producer.joinable()) {
    p->stop.store(true);
    p->cv_push.notify_all();
    p->producer.join();
    p->stop.store(false);
  }
  {
    std::lock_guard<std::mutex> lk(p->mu);
    p->queue.clear();
    p->epoch_done = false;
  }
  p->producer = std::thread([p, epoch_seed] { p->produce(epoch_seed); });
}

// Copies the next batch into caller buffers (one per array, each at least
// batch_size * record_bytes[a]). Returns the record count, or 0 at epoch
// end, or -1 on error (no epoch started).
int64_t ptio_prefetcher_next(void* h, uint8_t** dsts) {
  auto* p = static_cast<Prefetcher*>(h);
  std::unique_lock<std::mutex> lk(p->mu);
  p->cv_pop.wait(lk, [&] {
    return !p->queue.empty() || p->epoch_done ||
           p->stop.load(std::memory_order_relaxed);
  });
  if (p->queue.empty()) return 0;  // epoch done/stopped and drained
  Batch b = std::move(p->queue.front());
  p->queue.pop_front();
  p->cv_push.notify_one();
  lk.unlock();
  for (size_t a = 0; a < b.bufs.size(); ++a)
    std::memcpy(dsts[a], b.bufs[a].data(), b.bufs[a].size());
  return b.size;
}

void ptio_prefetcher_destroy(void* h) {
  auto* p = static_cast<Prefetcher*>(h);
  p->stop.store(true);
  {
    std::lock_guard<std::mutex> lk(p->mu);
    p->cv_push.notify_all();
    p->cv_pop.notify_all();
  }
  if (p->producer.joinable()) p->producer.join();
  delete p;
}

}  // extern "C"
