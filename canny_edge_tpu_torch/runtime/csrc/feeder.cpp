// Native runtime of the PyTorch port: threaded frame feeder (a copy of the
// JAX package's runtime/feeder.cpp).
//
// The reference's input path is a blocking OpenCV webcam loop on the main
// thread (src/main.cpp:78-115).  The GPU pipeline consumes frames far faster
// than a synchronous decoder can produce them, so this component provides a
// producer thread + ring buffer: frames are generated/read ahead of the
// consumer into preallocated slots, and the Python side acquires zero-copy
// views (copied, then staged onto the card while the producer fills the next
// slots).
//
// Modes:
//   0 synthetic: deterministic xorshift pattern frames (benchmarking)
//   1 raw8:      packed H*W uint8 frames streamed from a file
//   2 pgm_dir:   numbered binary PGM (P5) files from a directory
//
// Plain C ABI for ctypes.  Built with g++ on first use by
// canny_edge_tpu_torch/runtime/__init__.py.

#include <atomic>
#include <cctype>
#include <chrono>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Slot {
  std::vector<uint8_t> data;
  uint64_t index = 0;
};

struct Feeder {
  int h = 0, w = 0, capacity = 0, mode = 0;
  uint64_t count = 0;   // frames to produce (0 = until source exhausted)
  uint64_t seed = 0;
  std::string path;

  std::vector<Slot> slots;
  // ring state: [tail, head) filled; acquired = consumer-held slot or -1
  uint64_t head = 0, tail = 0;
  int64_t acquired = -1;
  bool done = false, stop = false;

  std::atomic<uint64_t> produced{0}, consumed{0};
  std::atomic<uint64_t> producer_waits{0}, consumer_waits{0};
  // source frames that existed but failed to parse/read — distinguishes a
  // corrupt stream from normal end-of-stream in feeder_stats
  std::atomic<uint64_t> read_errors{0};

  std::mutex mu;
  std::condition_variable cv_space, cv_data;
  std::thread worker;

  FILE* raw = nullptr;
};

void synth_frame(Feeder* f, uint8_t* dst, uint64_t idx) {
  // deterministic structured pattern: cheap xorshift noise + gradient bands
  uint64_t s = f->seed * 0x9E3779B97F4A7C15ull + (idx + 1) * 0xBF58476D1CE4E5B9ull;
  const int h = f->h, w = f->w;
  for (int r = 0; r < h; ++r) {
    uint8_t base = static_cast<uint8_t>((r * 3 + idx * 7) & 0xFF);
    uint8_t* row = dst + static_cast<size_t>(r) * w;
    for (int c = 0; c < w; ++c) {
      s ^= s << 13; s ^= s >> 7; s ^= s << 17;
      uint8_t noise = static_cast<uint8_t>(s & 0x1F);
      uint8_t disc = (((r - h / 2) * (r - h / 2) + (c - w / 2) * (c - w / 2))
                      < (h / 3) * (h / 3)) ? 64 : 0;
      row[c] = static_cast<uint8_t>(base + disc + noise + ((c >> 5) & 1) * 32);
    }
  }
}

bool read_raw_frame(Feeder* f, uint8_t* dst) {
  if (!f->raw) return false;
  size_t need = static_cast<size_t>(f->h) * f->w;
  size_t got = fread(dst, 1, need, f->raw);
  if (got == need) return true;
  // a partial frame is a corrupt/truncated source, not a clean EOF —
  // count it so feeder_stats can distinguish the two (the consumer only
  // sees "stream ended" either way)
  if (got != 0) f->read_errors.fetch_add(1, std::memory_order_relaxed);
  return false;
}

// Skip whitespace and '#...' comment lines between PGM header tokens (many
// writers emit comments, which plain fscanf("%d") chokes on).
bool pgm_skip_separators(FILE* fp) {
  int c;
  for (;;) {
    c = fgetc(fp);
    if (c == EOF) return false;
    if (c == '#') {
      while ((c = fgetc(fp)) != EOF && c != '\n') {}
      if (c == EOF) return false;
    } else if (!isspace(c)) {
      ungetc(c, fp);
      return true;
    }
  }
}

bool pgm_read_int(FILE* fp, int* out) {
  return pgm_skip_separators(fp) && fscanf(fp, "%d", out) == 1;
}

enum PgmResult { PGM_OK = 0, PGM_NOT_FOUND = 1, PGM_BAD = 2 };

PgmResult read_pgm(const std::string& file, int h, int w, uint8_t* dst) {
  FILE* fp = fopen(file.c_str(), "rb");
  if (!fp) return PGM_NOT_FOUND;
  char magic[3] = {0};
  int fw = 0, fh = 0, maxv = 0;
  if (fscanf(fp, "%2s", magic) != 1 || strcmp(magic, "P5") != 0 ||
      !pgm_read_int(fp, &fw) || !pgm_read_int(fp, &fh) ||
      !pgm_read_int(fp, &maxv) ||
      fw != w || fh != h || maxv <= 0 || maxv > 255) {
    fclose(fp);
    return PGM_BAD;
  }
  fgetc(fp);  // single whitespace after header
  size_t need = static_cast<size_t>(h) * w;
  bool ok = fread(dst, 1, need, fp) == need;
  fclose(fp);
  return ok ? PGM_OK : PGM_BAD;
}

void producer_loop(Feeder* f) {
  uint64_t idx = 0;
  for (;;) {
    if (f->count && idx >= f->count) break;
    {
      std::unique_lock<std::mutex> lk(f->mu);
      while (!f->stop && f->head - f->tail == static_cast<uint64_t>(f->capacity)) {
        f->producer_waits.fetch_add(1, std::memory_order_relaxed);
        f->cv_space.wait(lk);
      }
      if (f->stop) break;
    }
    Slot& slot = f->slots[f->head % f->capacity];
    bool ok = true;
    switch (f->mode) {
      case 0: synth_frame(f, slot.data.data(), idx); break;
      case 1: ok = read_raw_frame(f, slot.data.data()); break;
      case 2: {
        char name[64];
        snprintf(name, sizeof(name), "/frame_%06llu.pgm",
                 static_cast<unsigned long long>(idx));
        PgmResult r = read_pgm(f->path + name, f->h, f->w, slot.data.data());
        if (r == PGM_BAD) f->read_errors.fetch_add(1, std::memory_order_relaxed);
        ok = (r == PGM_OK);
        break;
      }
      default: ok = false;
    }
    if (!ok) break;
    slot.index = idx++;
    {
      std::lock_guard<std::mutex> lk(f->mu);
      ++f->head;
    }
    f->produced.fetch_add(1, std::memory_order_relaxed);
    f->cv_data.notify_one();
  }
  {
    std::lock_guard<std::mutex> lk(f->mu);
    f->done = true;
  }
  f->cv_data.notify_all();
}

}  // namespace

extern "C" {

void* feeder_create(int h, int w, int capacity, int mode, const char* path,
                    uint64_t count, uint64_t seed) {
  if (h <= 0 || w <= 0 || capacity < 2) return nullptr;
  auto* f = new Feeder;
  f->h = h; f->w = w; f->capacity = capacity; f->mode = mode;
  f->count = count; f->seed = seed;
  f->path = path ? path : "";
  if (mode == 1) {
    f->raw = fopen(f->path.c_str(), "rb");
    if (!f->raw) { delete f; return nullptr; }
  }
  f->slots.resize(capacity);
  for (auto& s : f->slots) s.data.resize(static_cast<size_t>(h) * w);
  f->worker = std::thread(producer_loop, f);
  return f;
}

// Acquire a zero-copy pointer to the oldest ready frame.  Returns the frame
// index (>= 0), -1 when the stream is exhausted, -2 on timeout.  The slot
// stays owned by the consumer until feeder_release.
int64_t feeder_acquire(void* handle, uint8_t** out_ptr, int timeout_ms) {
  auto* f = static_cast<Feeder*>(handle);
  std::unique_lock<std::mutex> lk(f->mu);
  auto pred = [f] { return f->head != f->tail || f->done; };
  if (!pred()) {
    f->consumer_waits.fetch_add(1, std::memory_order_relaxed);
    if (timeout_ms < 0) {
      f->cv_data.wait(lk, pred);
    } else if (!f->cv_data.wait_for(lk, std::chrono::milliseconds(timeout_ms),
                                    pred)) {
      return -2;
    }
  }
  if (f->head == f->tail) return -1;  // done and drained
  Slot& slot = f->slots[f->tail % f->capacity];
  f->acquired = static_cast<int64_t>(f->tail);
  *out_ptr = slot.data.data();
  return static_cast<int64_t>(slot.index);
}

void feeder_release(void* handle) {
  auto* f = static_cast<Feeder*>(handle);
  std::lock_guard<std::mutex> lk(f->mu);
  if (f->acquired >= 0) {
    f->acquired = -1;
    ++f->tail;
    f->consumed.fetch_add(1, std::memory_order_relaxed);
    f->cv_space.notify_one();
  }
}

void feeder_stats(void* handle, uint64_t* produced, uint64_t* consumed,
                  uint64_t* producer_waits, uint64_t* consumer_waits,
                  uint64_t* read_errors) {
  auto* f = static_cast<Feeder*>(handle);
  if (produced) *produced = f->produced.load();
  if (consumed) *consumed = f->consumed.load();
  if (producer_waits) *producer_waits = f->producer_waits.load();
  if (consumer_waits) *consumer_waits = f->consumer_waits.load();
  if (read_errors) *read_errors = f->read_errors.load();
}

void feeder_destroy(void* handle) {
  auto* f = static_cast<Feeder*>(handle);
  {
    std::lock_guard<std::mutex> lk(f->mu);
    f->stop = true;
  }
  f->cv_space.notify_all();
  f->cv_data.notify_all();
  if (f->worker.joinable()) f->worker.join();
  if (f->raw) fclose(f->raw);
  delete f;
}

// Fast min-max normalize to uint8 (the reference's -s display transform,
// src/utils.cpp:444-445) — native helper for the IO path.
void minmax_normalize_u8(const int16_t* src, uint8_t* dst, int64_t n) {
  if (n <= 0) return;
  int16_t lo = src[0], hi = src[0];
  for (int64_t i = 1; i < n; ++i) {
    if (src[i] < lo) lo = src[i];
    if (src[i] > hi) hi = src[i];
  }
  if (hi == lo) {
    memset(dst, 0, static_cast<size_t>(n));
    return;
  }
  double scale = 255.0 / (hi - lo);
  for (int64_t i = 0; i < n; ++i) {
    // round-half-even, matching io.imageio.minmax_normalize_u8 (np.rint)
    double v = std::nearbyint((src[i] - lo) * scale);
    dst[i] = static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
  }
}

}  // extern "C"
