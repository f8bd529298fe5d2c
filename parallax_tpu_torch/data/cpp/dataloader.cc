// Native token-stream data loader.
//
// The reference's input pipeline rides TF's C++ runtime: Stage/Unstage,
// FIFOQueue + QueueRunner threads, tf.data iterators (reference:
// graph_transform_lib.py:775-859 discovers exactly those ops to
// replicate). This is the TPU-native equivalent: an mmap'd token file
// with a background prefetch thread producing fixed-shape [batch,
// steps+1] windows into a bounded ring buffer, so the host input side
// overlaps fully with device steps.
//
// Shard semantics mirror the framework's shard API (mod-filter:
// window_index % num_shards == shard_id), windows are reshuffled each
// epoch with a per-epoch seeded PRNG for determinism across restarts.
//
// C ABI (driven from python via ctypes; see ../loader.py):
//   pl_open(path)                         -> handle (nullptr on error)
//   pl_num_tokens(handle)                 -> token count
//   pl_start(handle, batch, steps, num_shards, shard_id, seed, depth)
//   pl_next(handle, out_buf)              -> fills [batch*(steps+1)] i32,
//                                            returns epoch number
//   pl_close(handle)

#include <algorithm>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <fcntl.h>
#include <mutex>
#include <random>
#include <sys/mman.h>
#include <sys/stat.h>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

struct Batch {
  std::vector<int32_t> tokens;
  long epoch;
};

struct Loader {
  int fd = -1;
  size_t file_bytes = 0;
  const int32_t* data = nullptr;
  size_t n_tokens = 0;

  long batch = 0, steps = 0, num_shards = 1, shard_id = 0, seed = 0;
  size_t depth = 4;

  std::thread worker;
  std::mutex mu;
  std::condition_variable cv_push, cv_pop;
  std::deque<Batch> queue;
  bool stop = false;
  bool started = false;

  ~Loader() {
    {
      std::lock_guard<std::mutex> lk(mu);
      stop = true;
    }
    cv_push.notify_all();
    cv_pop.notify_all();
    if (worker.joinable()) worker.join();
    if (data) munmap(const_cast<int32_t*>(data), file_bytes);
    if (fd >= 0) close(fd);
  }

  void run() {
    const long window = steps + 1;
    const size_t n_windows_total = n_tokens / window;
    // this shard's windows: index % num_shards == shard_id
    std::vector<size_t> mine;
    for (size_t w = shard_id; w < n_windows_total;
         w += static_cast<size_t>(num_shards))
      mine.push_back(w);
    if (mine.empty() || static_cast<long>(mine.size()) < batch) return;

    long epoch = 0;
    std::vector<size_t> order(mine);
    while (true) {
      std::mt19937_64 prng(static_cast<uint64_t>(seed) * 1000003u +
                           static_cast<uint64_t>(epoch));
      std::shuffle(order.begin(), order.end(), prng);
      for (size_t off = 0; off + batch <= order.size();
           off += static_cast<size_t>(batch)) {
        Batch b;
        b.epoch = epoch;
        b.tokens.resize(static_cast<size_t>(batch) * window);
        for (long i = 0; i < batch; ++i) {
          const size_t w = order[off + i];
          std::memcpy(b.tokens.data() + i * window, data + w * window,
                      sizeof(int32_t) * window);
        }
        std::unique_lock<std::mutex> lk(mu);
        cv_push.wait(lk,
                     [&] { return stop || queue.size() < depth; });
        if (stop) return;
        queue.push_back(std::move(b));
        cv_pop.notify_one();
      }
      ++epoch;
    }
  }
};

}  // namespace

extern "C" {

void* pl_open(const char* path) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0 || st.st_size < (long)sizeof(int32_t)) {
    close(fd);
    return nullptr;
  }
  void* mem = mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
  if (mem == MAP_FAILED) {
    close(fd);
    return nullptr;
  }
  madvise(mem, st.st_size, MADV_SEQUENTIAL);
  auto* l = new Loader();
  l->fd = fd;
  l->file_bytes = st.st_size;
  l->data = static_cast<const int32_t*>(mem);
  l->n_tokens = st.st_size / sizeof(int32_t);
  return l;
}

long pl_num_tokens(void* h) {
  return static_cast<Loader*>(h)->n_tokens;
}

int pl_start(void* h, long batch, long steps, long num_shards,
             long shard_id, long seed, long depth) {
  auto* l = static_cast<Loader*>(h);
  if (l->started || batch <= 0 || steps <= 0 || num_shards <= 0 ||
      shard_id < 0 || shard_id >= num_shards)
    return -1;
  const long window = steps + 1;
  // this shard's actual window count (mirror of the python fallback's
  // len(arange(shard_id, n_windows, num_shards)) so both backends accept
  // exactly the same configurations)
  const long total_windows = static_cast<long>(l->n_tokens / window);
  const long shard_windows =
      total_windows > shard_id
          ? (total_windows - shard_id + num_shards - 1) / num_shards
          : 0;
  if (shard_windows < batch) return -2;  // not enough data for one batch
  l->batch = batch;
  l->steps = steps;
  l->num_shards = num_shards;
  l->shard_id = shard_id;
  l->seed = seed;
  l->depth = depth > 0 ? static_cast<size_t>(depth) : 4;
  l->started = true;
  l->worker = std::thread([l] { l->run(); });
  return 0;
}

int pl_next(void* h, int32_t* out) {
  auto* l = static_cast<Loader*>(h);
  if (!l->started) return -1;
  Batch b;
  {
    std::unique_lock<std::mutex> lk(l->mu);
    l->cv_pop.wait(lk, [&] { return l->stop || !l->queue.empty(); });
    if (l->stop && l->queue.empty()) return -2;
    b = std::move(l->queue.front());
    l->queue.pop_front();
  }
  l->cv_push.notify_one();
  std::memcpy(out, b.tokens.data(), b.tokens.size() * sizeof(int32_t));
  return static_cast<int>(b.epoch);
}

void pl_close(void* h) { delete static_cast<Loader*>(h); }

}  // extern "C"
