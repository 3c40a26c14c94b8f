// sampledb: memory-mapped sample store + multithreaded batch prefetcher.
//
// The training input pipeline's host-side hot path: gather shuffled samples
// from a decoded-once uint8 store, augment (flips, rotation), convert to
// float32 and normalize — all in native threads so Python never touches
// per-sample data. Exposed via a C ABI consumed with ctypes
// (vq_vae_gan_diffusion_torch/data/native_loader.py).
//
// The port's copy of the JAX package's native/sampledb.cpp, with the same
// arithmetic and RNG: each sample's std::mt19937_64 and the epoch shuffle are
// unchanged, so a batch is bit for bit the same. One difference: the
// prefetcher hands batches out in batch order, whatever the number of
// threads (the JAX copy hands them out as they finish), so a seeded epoch is
// the same sequence on every run.
//
// Store format (little-endian):
//   magic   u64  0x53444231334C4456  ("VDL31BDS")
//   n, h, w, c  u64 each
//   data    u8[n*h*w*c]
//
// Build: at first use by vq_vae_gan_diffusion_torch/ops/_build.py
//        ($CXX or c++ -O3 -march=native -std=c++17 -fPIC -pthread -shared)

#include <atomic>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <map>
#include <mutex>
#include <random>
#include <sys/mman.h>
#include <sys/stat.h>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

constexpr uint64_t kMagic = 0x53444231334C4456ULL;

struct Store {
  int fd = -1;
  const uint8_t* base = nullptr;   // mmap base
  size_t mapped = 0;
  uint64_t n = 0, h = 0, w = 0, c = 0;
  const uint8_t* data() const { return base + 5 * sizeof(uint64_t); }
  size_t sample_bytes() const { return h * w * c; }
};

struct AugmentSpec {
  float mean[8];
  float std[8];
  float p_hflip = 0.f;
  float p_vflip = 0.f;
  float p_rot = 0.f;     // probability of a random rotation
  float max_deg = 0.f;   // rotation drawn uniform in [-max_deg, max_deg]
};

// gather + augment + normalize one sample into out (float32 HWC).
//
// Augmentation order matches the Python recipe (transforms.py
// random_flips_and_rotation): hflip → vflip → rotate. Rotation is inverse-
// mapped bilinear about the pixel-center image center with zero (black)
// fill applied BEFORE normalization, like PIL's rotate(deg, BILINEAR) on the
// uint8 image — same distribution/geometry as the Python path, not
// bit-identical to PIL's resampler (documented divergence; augmentations are
// random draws either way).
void materialize(const Store& s, uint64_t idx, const AugmentSpec& spec,
                 uint64_t seed, float* out) {
  const uint8_t* src = s.data() + idx * s.sample_bytes();
  const int64_t H = (int64_t)s.h, W = (int64_t)s.w, C = (int64_t)s.c;
  std::mt19937_64 rng(seed ^ (0x9E3779B97F4A7C15ULL * (idx + 1)));
  std::uniform_real_distribution<float> uni(0.f, 1.f);
  const bool hflip = spec.p_hflip > 0.f && uni(rng) < spec.p_hflip;
  const bool vflip = spec.p_vflip > 0.f && uni(rng) < spec.p_vflip;
  const bool rot = spec.p_rot > 0.f && uni(rng) < spec.p_rot;
  float deg = 0.f;
  if (rot) {
    std::uniform_real_distribution<float> ang(-spec.max_deg, spec.max_deg);
    deg = ang(rng);
  }

  float inv_std[8], neg_mean[8];
  for (int64_t k = 0; k < C && k < 8; ++k) {
    inv_std[k] = 1.f / spec.std[k];
    neg_mean[k] = spec.mean[k];
  }
  if (!rot) {
    for (int64_t y = 0; y < H; ++y) {
      const int64_t sy = vflip ? H - 1 - y : y;
      for (int64_t x = 0; x < W; ++x) {
        const int64_t sx = hflip ? W - 1 - x : x;
        const uint8_t* px = src + (sy * W + sx) * C;
        float* dst = out + (y * W + x) * C;
        for (int64_t k = 0; k < C; ++k) {
          dst[k] = (px[k] * (1.f / 255.f) - neg_mean[k & 7]) * inv_std[k & 7];
        }
      }
    }
    return;
  }
  // rotation path: fetch taps from the (virtually) flipped image
  const double th = (double)deg * 3.14159265358979323846 / 180.0;
  const float ct = (float)std::cos(th), st = (float)std::sin(th);
  const float cx = (W - 1) * 0.5f, cy = (H - 1) * 0.5f;
  auto tap = [&](int64_t ty, int64_t tx, int64_t k) -> float {
    if (ty < 0 || ty >= H || tx < 0 || tx >= W) return 0.f;  // black fill
    const int64_t sy = vflip ? H - 1 - ty : ty;
    const int64_t sx = hflip ? W - 1 - tx : tx;
    return (float)src[(sy * W + sx) * C + k];
  };
  for (int64_t y = 0; y < H; ++y) {
    const float dy = (float)y - cy;
    for (int64_t x = 0; x < W; ++x) {
      const float dx = (float)x - cx;
      const float fx = ct * dx + st * dy + cx;
      const float fy = -st * dx + ct * dy + cy;
      const int64_t x0 = (int64_t)std::floor(fx);
      const int64_t y0 = (int64_t)std::floor(fy);
      const float ax = fx - (float)x0, ay = fy - (float)y0;
      const float w00 = (1.f - ax) * (1.f - ay), w01 = ax * (1.f - ay);
      const float w10 = (1.f - ax) * ay, w11 = ax * ay;
      float* dst = out + (y * W + x) * C;
      for (int64_t k = 0; k < C; ++k) {
        const float v = w00 * tap(y0, x0, k) + w01 * tap(y0, x0 + 1, k) +
                        w10 * tap(y0 + 1, x0, k) + w11 * tap(y0 + 1, x0 + 1, k);
        dst[k] = (v * (1.f / 255.f) - neg_mean[k & 7]) * inv_std[k & 7];
      }
    }
  }
}

struct Batch {
  std::vector<float> buf;
};

struct Prefetcher {
  const Store* store = nullptr;
  AugmentSpec spec;
  uint64_t batch_size = 0;
  uint64_t seed = 0;
  uint64_t n_limit = 0;  // 0 = whole store; else epoch = first n_limit samples
  bool shuffle = true;
  bool drop_last = true;
  int epoch = 0;

  std::vector<std::thread> workers;
  std::mutex mu;
  std::condition_variable cv_ready, cv_space;
  // finished batches by batch index; next_serve is the next one handed out.
  // A worker may queue batch b only while b < next_serve + max_ready, so the
  // batch next_serve always has room and the window never deadlocks.
  std::map<uint64_t, Batch*> ready;
  uint64_t next_serve = 0;
  uint64_t max_ready = 4;
  std::atomic<bool> stop{false};

  // work queue: batch start offsets of the current epoch. All epoch state
  // (order/epoch/batches_per_epoch/next_batch) is guarded by mu; `generation`
  // increments on every reset so in-flight workers can detect that the batch
  // they materialized belongs to an abandoned epoch and must be dropped
  // (otherwise a stale batch could be served as the first batch of the new
  // epoch).
  std::vector<uint64_t> order;
  uint64_t next_batch = 0;
  uint64_t batches_per_epoch = 0;
  uint64_t generation = 0;
};

void worker_loop(Prefetcher* p) {
  const Store& s = *p->store;
  const size_t elems = p->batch_size * s.sample_bytes();
  std::vector<uint64_t> idxs;
  while (!p->stop.load()) {
    uint64_t gen, epoch, count, b;
    {
      // claim a batch and snapshot its sample indices under the lock so a
      // concurrent reset() reshuffle can't be observed mid-read
      std::unique_lock<std::mutex> lk(p->mu);
      if (p->next_batch >= p->batches_per_epoch) {
        // wait until reset() starts a new epoch
        p->cv_space.wait_for(lk, std::chrono::milliseconds(20));
        continue;
      }
      b = p->next_batch++;
      gen = p->generation;
      epoch = (uint64_t)p->epoch;
      const uint64_t start = b * p->batch_size;
      count = std::min<uint64_t>(p->batch_size, p->order.size() - start);
      idxs.assign(p->order.begin() + start, p->order.begin() + start + count);
    }
    Batch* out = new Batch();
    out->buf.resize(elems);
    for (uint64_t i = 0; i < count; ++i) {
      materialize(s, idxs[i], p->spec,
                  p->seed * 1000003ULL + epoch * 7919ULL,
                  out->buf.data() + i * s.sample_bytes());
    }
    // pad final partial batch by repeating the last sample
    for (uint64_t i = count; i < p->batch_size; ++i) {
      std::memcpy(out->buf.data() + i * s.sample_bytes(),
                  out->buf.data() + (count - 1) * s.sample_bytes(),
                  s.sample_bytes() * sizeof(float));
    }
    std::unique_lock<std::mutex> lk(p->mu);
    p->cv_space.wait(lk, [p, b, gen] {
      return b < p->next_serve + p->max_ready || p->generation != gen ||
             p->stop.load(); });
    if (p->stop.load()) { delete out; return; }
    if (p->generation != gen) { delete out; continue; }  // epoch was reset
    p->ready[b] = out;
    p->cv_ready.notify_all();
  }
}

}  // namespace

extern "C" {

void* sdb_open(const char* path) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) { ::close(fd); return nullptr; }
  // reject truncated/corrupt files (e.g. an interrupted build_sample_store)
  // before dereferencing the header or trusting its sizes
  if (st.st_size < (off_t)(5 * sizeof(uint64_t))) { ::close(fd); return nullptr; }
  void* base = mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
  if (base == MAP_FAILED) { ::close(fd); return nullptr; }
  const uint64_t* hdr = reinterpret_cast<const uint64_t*>(base);
  if (hdr[0] != kMagic) { munmap(base, st.st_size); ::close(fd); return nullptr; }
  const uint64_t n = hdr[1], h = hdr[2], w = hdr[3], c = hdr[4];
  // overflow-safe n*h*w*c check against the actual file size
  const uint64_t avail = (uint64_t)st.st_size - 5 * sizeof(uint64_t);
  bool ok = h > 0 && w > 0 && c > 0;
  if (ok) {
    const uint64_t sb_max = n ? avail / n : avail;
    ok = h <= sb_max && (h == 0 || w <= sb_max / h) &&
         (h * w == 0 || c <= sb_max / (h * w)) && n * h * w * c <= avail;
  }
  if (!ok) { munmap(base, st.st_size); ::close(fd); return nullptr; }
  Store* s = new Store();
  s->fd = fd;
  s->base = reinterpret_cast<const uint8_t*>(base);
  s->mapped = st.st_size;
  s->n = n; s->h = h; s->w = w; s->c = c;
  return s;
}

void sdb_close(void* handle) {
  Store* s = reinterpret_cast<Store*>(handle);
  if (!s) return;
  munmap(const_cast<uint8_t*>(s->base), s->mapped);
  ::close(s->fd);
  delete s;
}

void sdb_shape(void* handle, uint64_t* out4) {
  Store* s = reinterpret_cast<Store*>(handle);
  out4[0] = s->n; out4[1] = s->h; out4[2] = s->w; out4[3] = s->c;
}

// Synchronous gather: indices[n] → out float32 [n, h, w, c]
void sdb_gather(void* handle, const uint64_t* indices, uint64_t n,
                const float* mean, const float* stdv, uint64_t c_stats,
                float p_hflip, float p_vflip, float p_rot, float max_deg,
                uint64_t seed, float* out) {
  Store* s = reinterpret_cast<Store*>(handle);
  AugmentSpec spec;
  for (uint64_t k = 0; k < 8; ++k) {
    spec.mean[k] = mean[k < c_stats ? k : c_stats - 1];
    spec.std[k] = stdv[k < c_stats ? k : c_stats - 1];
  }
  spec.p_hflip = p_hflip; spec.p_vflip = p_vflip;
  spec.p_rot = p_rot; spec.max_deg = max_deg;
  const size_t sb = s->sample_bytes();
  const unsigned hw = std::max(1u, std::thread::hardware_concurrency());
  const uint64_t per = (n + hw - 1) / hw;
  std::vector<std::thread> ts;
  for (unsigned t = 0; t < hw; ++t) {
    const uint64_t lo = t * per, hi = std::min<uint64_t>(n, lo + per);
    if (lo >= hi) break;
    ts.emplace_back([=, &spec] {
      for (uint64_t i = lo; i < hi; ++i)
        materialize(*s, indices[i], spec, seed, out + i * sb);
    });
  }
  for (auto& t : ts) t.join();
}

void* sdb_prefetcher_create(void* handle, uint64_t batch_size,
                            const float* mean, const float* stdv,
                            uint64_t c_stats, float p_hflip, float p_vflip,
                            float p_rot, float max_deg,
                            uint64_t seed, int shuffle, int drop_last,
                            int num_threads, uint64_t n_limit) {
  Store* s = reinterpret_cast<Store*>(handle);
  Prefetcher* p = new Prefetcher();
  p->store = s;
  for (uint64_t k = 0; k < 8; ++k) {
    p->spec.mean[k] = mean[k < c_stats ? k : c_stats - 1];
    p->spec.std[k] = stdv[k < c_stats ? k : c_stats - 1];
  }
  p->spec.p_hflip = p_hflip; p->spec.p_vflip = p_vflip;
  p->spec.p_rot = p_rot; p->spec.max_deg = max_deg;
  p->batch_size = batch_size;
  p->seed = seed;
  p->n_limit = n_limit;
  p->shuffle = shuffle != 0;
  p->drop_last = drop_last != 0;
  p->batches_per_epoch = 0;  // idle until reset
  const int nt = num_threads > 0 ? num_threads
                                 : (int)std::thread::hardware_concurrency();
  for (int i = 0; i < nt; ++i) p->workers.emplace_back(worker_loop, p);
  return p;
}

// start a new epoch; returns number of batches it will produce
uint64_t sdb_prefetcher_reset(void* handle, int epoch) {
  Prefetcher* p = reinterpret_cast<Prefetcher*>(handle);
  std::unique_lock<std::mutex> lk(p->mu);
  // invalidate any batch a worker is materializing right now (it will be
  // dropped at push time when its generation no longer matches), then drain
  // already-queued leftovers from the abandoned epoch
  p->generation++;
  for (auto& kv : p->ready) delete kv.second;
  p->ready.clear();
  p->next_serve = 0;
  p->epoch = epoch;
  // honor max_samples: the epoch covers the first n_limit store indices,
  // matching the Python DataLoader's subset semantics (pipeline.py)
  uint64_t n = p->store->n;
  if (p->n_limit > 0 && p->n_limit < n) n = p->n_limit;
  p->order.resize(n);
  for (uint64_t i = 0; i < n; ++i) p->order[i] = i;
  if (p->shuffle && n > 1) {
    std::mt19937_64 rng(p->seed + (uint64_t)epoch);
    for (uint64_t i = n - 1; i > 0; --i) {
      std::uniform_int_distribution<uint64_t> d(0, i);
      std::swap(p->order[i], p->order[d(rng)]);
    }
  }
  p->batches_per_epoch = p->drop_last ? n / p->batch_size
                                      : (n + p->batch_size - 1) / p->batch_size;
  p->next_batch = 0;
  p->cv_space.notify_all();
  return p->batches_per_epoch;
}

// blocking pop of the epoch's next batch, in batch order, into out
// (caller-sized)
int sdb_prefetcher_next(void* handle, float* out, uint64_t out_elems) {
  Prefetcher* p = reinterpret_cast<Prefetcher*>(handle);
  std::unique_lock<std::mutex> lk(p->mu);
  p->cv_ready.wait(lk, [p] { return p->ready.count(p->next_serve) ||
                                    p->stop.load(); });
  if (p->stop.load()) return -1;
  auto it = p->ready.find(p->next_serve);
  Batch* b = it->second;
  p->ready.erase(it);
  p->next_serve++;
  p->cv_space.notify_all();
  lk.unlock();
  const uint64_t n = std::min<uint64_t>(out_elems, b->buf.size());
  std::memcpy(out, b->buf.data(), n * sizeof(float));
  delete b;
  return (int)0;
}

void sdb_prefetcher_destroy(void* handle) {
  Prefetcher* p = reinterpret_cast<Prefetcher*>(handle);
  p->stop.store(true);
  p->cv_space.notify_all();
  p->cv_ready.notify_all();
  for (auto& t : p->workers) t.join();
  for (auto& kv : p->ready) delete kv.second;
  delete p;
}

}  // extern "C"
