// Native host store: mmap + madvise streaming of checkpoint files.
//
// The disk -> host-memory half of weight streaming, with a plain C
// interface loaded through ctypes (dnet_tpu_torch/utils/native_store.py):
//
//   - hs_open / hs_close        mmap a safetensors file read-only
//   - hs_addr / hs_size         base pointer and size, for zero-copy views
//   - hs_prefetch               madvise(MADV_WILLNEED) on page-aligned spans
//                               (a fit load's readahead of whole tensors)
//   - hs_prefetch_async         the same, then a background thread touches
//                               one byte a page, so the read happens there,
//                               overlapped with device compute, and not at
//                               first use on the hot path
//   - hs_release                madvise(MADV_DONTNEED): drop an evicted
//                               layer's pages from the mapping
//
// Thread-safe: a handle table under one mutex, one detached worker draining
// a condition-variable queue.  The table holds each mapping by reference
// count: the worker keeps its own reference while it touches a span, so
// hs_close only drops the table's and the unmap waits for the worker.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <deque>
#include <memory>
#include <mutex>
#include <thread>
#include <unordered_map>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

// Unmapped and closed when the last reference drops.
struct Mapping {
  void* base;
  uint64_t size;
  int fd;
  Mapping(void* b, uint64_t n, int f) : base(b), size(n), fd(f) {}
  Mapping(const Mapping&) = delete;
  Mapping& operator=(const Mapping&) = delete;
  ~Mapping() {
    munmap(base, static_cast<size_t>(size));
    close(fd);
  }
};
using MappingRef = std::shared_ptr<const Mapping>;

struct Span {
  int handle;
  uint64_t off;
  uint64_t len;
};

// Leaked on purpose: the detached worker may still wait on the queue when
// exit() runs static destructors, and destroying a condition variable with
// a waiter (or a mutex it then locks) would hang or crash the exit.
std::mutex& g_mu = *new std::mutex();
std::unordered_map<int, MappingRef>& g_maps = *new std::unordered_map<int, MappingRef>();
int g_next_handle = 1;

std::mutex& g_q_mu = *new std::mutex();
std::condition_variable& g_q_cv = *new std::condition_variable();
std::deque<Span>& g_queue = *new std::deque<Span>();
std::atomic<bool> g_worker_up{false};

uint64_t page_size() {
  static const uint64_t ps = static_cast<uint64_t>(sysconf(_SC_PAGESIZE));
  return ps;
}

// Clamp [off, off + len) to the mapping and widen it to whole pages.
bool aligned_span(const Mapping& m, uint64_t off, uint64_t len, char** start, size_t* n) {
  if (off >= m.size || len == 0) return false;
  if (off + len > m.size) len = m.size - off;
  const uint64_t ps = page_size();
  const uint64_t a = off / ps * ps;
  uint64_t b = (off + len + ps - 1) / ps * ps;
  if (b > m.size) b = m.size;
  *start = static_cast<char*>(m.base) + a;
  *n = static_cast<size_t>(b - a);
  return true;
}

// The mapping's reference (null once closed).
MappingRef lookup(int h) {
  std::lock_guard<std::mutex> lk(g_mu);
  auto it = g_maps.find(h);
  return it == g_maps.end() ? nullptr : it->second;
}

void worker_main() {
  for (;;) {
    Span s;
    {
      std::unique_lock<std::mutex> lk(g_q_mu);
      g_q_cv.wait(lk, [] { return !g_queue.empty(); });
      s = g_queue.front();
      g_queue.pop_front();
    }
    char* start;
    size_t n;
    // held until the span is touched: a concurrent hs_close cannot unmap it
    const MappingRef m = lookup(s.handle);
    if (m && aligned_span(*m, s.off, s.len, &start, &n)) {
      madvise(start, n, MADV_WILLNEED);
      // WILLNEED is a hint; touching each page makes the read happen now
      volatile char sink = 0;
      for (size_t i = 0; i < n; i += static_cast<size_t>(page_size())) sink ^= start[i];
      (void)sink;
    }
  }
}

void ensure_worker() {
  bool expected = false;
  if (g_worker_up.compare_exchange_strong(expected, true)) std::thread(worker_main).detach();
}

}  // namespace

extern "C" {

int hs_open(const char* path) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return -1;
  struct stat st;
  if (fstat(fd, &st) != 0 || st.st_size <= 0) {
    close(fd);
    return -1;
  }
  void* base = mmap(nullptr, static_cast<size_t>(st.st_size), PROT_READ, MAP_SHARED, fd, 0);
  if (base == MAP_FAILED) {
    close(fd);
    return -1;
  }
  // the kernel's default readahead stays on: a fit load copies whole
  // tensors, and streamed layers are prefetched a window ahead
  auto m = std::make_shared<const Mapping>(base, static_cast<uint64_t>(st.st_size), fd);
  std::lock_guard<std::mutex> lk(g_mu);
  const int h = g_next_handle++;
  g_maps[h] = std::move(m);
  return h;
}

// Drops the table's reference; the file is unmapped now, or when the
// worker finishes the span it is touching.
void hs_close(int handle) {
  MappingRef m;
  {
    std::lock_guard<std::mutex> lk(g_mu);
    auto it = g_maps.find(handle);
    if (it == g_maps.end()) return;
    m = std::move(it->second);
    g_maps.erase(it);
  }
  // m drops here, outside the lock
}

uint64_t hs_size(int handle) {
  const MappingRef m = lookup(handle);
  return m ? m->size : 0;
}

void* hs_addr(int handle) {
  const MappingRef m = lookup(handle);
  return m ? m->base : nullptr;
}

int hs_prefetch(int handle, uint64_t off, uint64_t len) {
  const MappingRef m = lookup(handle);
  char* start;
  size_t n;
  if (!m || !aligned_span(*m, off, len, &start, &n)) return -1;
  return madvise(start, n, MADV_WILLNEED);
}

int hs_prefetch_async(int handle, uint64_t off, uint64_t len) {
  if (!lookup(handle)) return -1;
  ensure_worker();
  {
    std::lock_guard<std::mutex> lk(g_q_mu);
    g_queue.push_back(Span{handle, off, len});
  }
  g_q_cv.notify_one();
  return 0;
}

int hs_release(int handle, uint64_t off, uint64_t len) {
  const MappingRef m = lookup(handle);
  char* start;
  size_t n;
  if (!m || !aligned_span(*m, off, len, &start, &n)) return -1;
  return madvise(start, n, MADV_DONTNEED);
}

}  // extern "C"
