// Native data loader for voicecraft_tpu_torch (a copy of the JAX package's
// voicecraft_tpu/native/dataio.cpp).
//
// Training reads thousands of small per-utterance text files (K rows of
// space-separated codec codes, reference data/gigaspeech.py:41-62).  This
// small C library (mmap, branch-light integer parsing, a std::thread pool)
// loads one file or a whole batch of them in parallel, bound to Python with
// ctypes (voicecraft_tpu_torch/native/__init__.py).  It runs on the host.
//
// Build: g++ -O3 -std=c++17 -shared -fPIC dataio.cpp -o libvcdataio.so -lpthread

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

// Parse one code file: n_codebooks rows of space-separated non-negative
// ints.  Writes row-major [n_codebooks, max_t] into `out`; returns the
// number of frames T (min across rows), or -1 on error / overflow.
int parse_codes(const char* data, size_t size, int n_codebooks,
                int32_t* out, int max_t) {
  const char* p = data;
  const char* end = data + size;
  int row = 0;
  int min_t = -1;
  while (row < n_codebooks) {
    int t = 0;
    while (p < end && *p != '\n') {
      // skip spaces
      while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
      if (p >= end || *p == '\n') break;
      int32_t v = 0;
      bool any = false;
      while (p < end && *p >= '0' && *p <= '9') {
        v = v * 10 + (*p - '0');
        ++p;
        any = true;
      }
      if (!any) return -1;  // non-numeric garbage
      if (t >= max_t) return -1;
      out[(size_t)row * max_t + t] = v;
      ++t;
    }
    if (p < end) ++p;  // consume '\n'
    if (t == 0) return -1;
    min_t = (min_t < 0 || t < min_t) ? t : min_t;
    ++row;
    if (row < n_codebooks && p >= end) return -1;  // fewer rows than K
  }
  return min_t;
}

int load_one(const char* path, int n_codebooks, int32_t* out, int max_t) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return -1;
  struct stat st;
  if (fstat(fd, &st) != 0 || st.st_size == 0) {
    close(fd);
    return -1;
  }
  void* mem = mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
  close(fd);
  if (mem == MAP_FAILED) return -1;
  int t = parse_codes(static_cast<const char*>(mem), st.st_size, n_codebooks,
                      out, max_t);
  munmap(mem, st.st_size);
  return t;
}

}  // namespace

extern "C" {

// Load a single code file.  Returns T (frames) or -1.
int vc_load_codes(const char* path, int n_codebooks, int32_t* out,
                  int max_t) {
  return load_one(path, n_codebooks, out, max_t);
}

// Load `n` code files in parallel.  paths: array of C strings.
// out: [n, n_codebooks, max_t] int32, row-major.  lens: [n] int32 out
// (frames per file, -1 on per-file failure).  n_threads <= 0 picks
// hardware_concurrency.  Returns the number of successfully loaded files.
int vc_load_codes_batch(const char** paths, int n, int n_codebooks,
                        int32_t* out, int max_t, int32_t* lens,
                        int n_threads) {
  if (n_threads <= 0) {
    n_threads = static_cast<int>(std::thread::hardware_concurrency());
    if (n_threads <= 0) n_threads = 4;
  }
  if (n_threads > n) n_threads = n;
  std::atomic<int> next(0);
  std::atomic<int> ok(0);
  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) return;
      int t = load_one(paths[i], n_codebooks,
                       out + (size_t)i * n_codebooks * max_t, max_t);
      lens[i] = t;
      if (t >= 0) ok.fetch_add(1);
    }
  };
  std::vector<std::thread> threads;
  threads.reserve(n_threads);
  for (int i = 0; i < n_threads; ++i) threads.emplace_back(worker);
  for (auto& th : threads) th.join();
  return ok.load();
}

}  // extern "C"
