// Host IO engine: threaded event -> padded COO batch assembly, the native
// HDF5 voxel-slab reader and the threaded window-plan builder.
//
// Copied from sparseeventid_tpu/io/_hostio.cpp (fill_event, the threaded
// assemble_sparse_batch, the dlopen HDF5 reader, build_window_plans with
// its per-event pool; the builder itself is hostio_core.h) behind a plain
// C interface that io/hostio.py loads with ctypes.  Python owns every
// buffer: the caller allocates the outputs and passes their pointers,
// nothing is allocated across the boundary.  ctypes releases the
// interpreter lock for the call, so a prefetch thread assembling, reading
// or building plans overlaps the main thread.
//
// Build (io/hostio.py does it at first use):
//   g++ -O3 -std=c++17 -pthread -shared -fPIC -o hostio.so hostio.cpp -ldl

#include <dlfcn.h>

#include <algorithm>
#include <atomic>
#include <chrono>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <random>
#include <thread>
#include <vector>

#include "hostio_core.h"

namespace {

// Peak number of workers inside the per-event plan builder at once since
// the last read (seid_plan_pool_peak_concurrency): 1 under
// SEID_PLAN_THREADS=1; above 1 shows the pool runs the real builder
// concurrently, with no lock serializing it.
std::atomic<int64_t> g_plan_inflight(0);
std::atomic<int64_t> g_plan_peak(0);

// Workers of the plan pool: one a hardware thread, or SEID_PLAN_THREADS;
// at most one an event.
unsigned plan_threads(int64_t batch) {
  int64_t n = std::max(1u, std::thread::hardware_concurrency());
  if (const char* env = std::getenv("SEID_PLAN_THREADS")) {
    const long v = std::strtol(env, nullptr, 10);
    if (v > 0) n = v;
  }
  return unsigned(std::max<int64_t>(std::min(n, batch), 1));
}

// Output buffers of one plan across the batch (see seid_build_window_plans).
struct PlanOut {
  int32_t* start;
  int32_t* src;
  int32_t* dst;
  int32_t* kk;
  uint8_t* valid;
  int32_t* dropped;
  int64_t n_start;  // tiles * K of an event
  int64_t width;    // list entries of an event
};

void pack_plan(const seid_plans::PlanResult& pr, const PlanOut& o, int64_t i) {
  std::memcpy(o.start + i * o.n_start, pr.start.data(),
              sizeof(int32_t) * size_t(o.n_start));
  const int64_t n = int64_t(pr.list.src.size());
  int32_t* sp = o.src + i * o.width;
  int32_t* dp = o.dst + i * o.width;
  int32_t* kp = o.kk + i * o.width;
  uint8_t* vp = o.valid + i * o.width;
  for (int64_t s = 0; s < o.width; ++s) {
    sp[s] = s < n ? pr.list.src[size_t(s)] : 0;
    dp[s] = s < n ? pr.list.dst[size_t(s)] : 0;
    kp[s] = s < n ? pr.list.kk[size_t(s)] : 0;
    vp[s] = s < n;
  }
  o.dropped[i] = int32_t(std::max<int64_t>(pr.list.total - n, 0));
}

struct EventRef {
  const uint64_t* ids;
  const float* vals;
  int64_t n;
};

struct AugmentParams {
  bool enabled = false;
  bool mirror = true;
  float blur_sigma = 0.05f;
  int translate[3] = {0, 0, 0};
  uint64_t seed = 0;
};

// One event -> one padded row block of the output: -999 fill, per-event
// normalization (mean 1.0, std 0.5 over all the event's voxels, before
// truncation) and optional mirror / jitter / translate.
void fill_event(const EventRef& ev, float* out, int64_t max_voxels,
                const int64_t* dims, int ndim, bool normalize,
                const AugmentParams& aug, uint64_t event_index) {
  const int64_t row_w = ndim + 1;
  for (int64_t i = 0; i < max_voxels * row_w; ++i) out[i] = -999.0f;

  int64_t n = std::min(ev.n, max_voxels);
  if (n <= 0) return;

  float mean = 0.f, std = 1.f;
  if (normalize && ev.n > 1) {
    double s1 = 0., s2 = 0.;
    for (int64_t i = 0; i < ev.n; ++i) {
      s1 += ev.vals[i];
      s2 += double(ev.vals[i]) * ev.vals[i];
    }
    mean = float(s1 / ev.n);
    double var = s2 / ev.n - double(mean) * mean;
    std = float(std::sqrt(var > 0 ? var : 0) + 1e-6);
  }

  std::mt19937_64 rng(aug.seed * 0x9E3779B97F4A7C15ULL + event_index);
  std::normal_distribution<float> jitter(0.f, aug.blur_sigma);
  bool flip[3] = {false, false, false};
  long shift[3] = {0, 0, 0};
  if (aug.enabled) {
    for (int d = 0; d < ndim; ++d) {
      if (aug.mirror) flip[d] = (rng() & 1) != 0;
      if (aug.translate[d] > 0) {
        std::uniform_int_distribution<long> u(-aug.translate[d],
                                              aug.translate[d]);
        shift[d] = u(rng);
      }
    }
  }

  int64_t w = 0;
  for (int64_t i = 0; i < n; ++i) {
    uint64_t id = ev.ids[i];
    long coord[3];
    for (int d = ndim - 1; d >= 0; --d) {
      coord[d] = long(id % uint64_t(dims[d]));
      id /= uint64_t(dims[d]);
    }
    bool ok = true;
    for (int d = 0; d < ndim && ok; ++d) {
      long c = coord[d];
      if (aug.enabled) {
        if (flip[d]) c = dims[d] - 1 - c;
        if (aug.blur_sigma > 0)
          c = long(std::lround(float(c) + jitter(rng)));
        c += shift[d];
      }
      coord[d] = c;
      if (c < 0 || c >= dims[d]) ok = false;
    }
    if (!ok) continue;
    float* row = out + w * row_w;
    for (int d = 0; d < ndim; ++d) row[d] = float(coord[d]);
    float v = ev.vals[i];
    if (normalize) v = (v - mean) / std * 0.5f + 1.0f;
    row[ndim] = v;
    ++w;
  }
}

// ---------------------------------------------------------------------------
// Native HDF5 voxel-slab reader.  No HDF5 headers are needed: the stable
// HDF5 1.x C API is bound through dlopen of a runtime library that the
// caller names (a system soname, or the path of h5py's bundled copy).
// Serial HDF5 is not thread-safe, so every HDF5 call runs under one mutex.
// ---------------------------------------------------------------------------

namespace h5 {

using hid_t = int64_t;
using herr_t = int;
using hsize_t = unsigned long long;

constexpr unsigned kAccRdonly = 0u;
constexpr hid_t kDefault = 0;
constexpr int kSelectSet = 0;
constexpr int kCompound = 6;

struct Api {
  herr_t (*H5open)();
  hid_t (*H5Fopen)(const char*, unsigned, hid_t);
  herr_t (*H5Fclose)(hid_t);
  hid_t (*H5Dopen2)(hid_t, const char*, hid_t);
  herr_t (*H5Dclose)(hid_t);
  hid_t (*H5Dget_space)(hid_t);
  herr_t (*H5Sclose)(hid_t);
  hid_t (*H5Screate_simple)(int, const hsize_t*, const hsize_t*);
  herr_t (*H5Sselect_hyperslab)(hid_t, int, const hsize_t*, const hsize_t*,
                                const hsize_t*, const hsize_t*);
  herr_t (*H5Dread)(hid_t, hid_t, hid_t, hid_t, hid_t, void*);
  hid_t (*H5Tcreate)(int, size_t);
  herr_t (*H5Tinsert)(hid_t, const char*, size_t, hid_t);
  herr_t (*H5Tclose)(hid_t);
  hid_t native_ullong = -1;
  hid_t native_float = -1;
};

std::mutex mu;

#pragma pack(push, 1)
struct VoxelRow {
  uint64_t id;
  float value;
};
#pragma pack(pop)
static_assert(sizeof(VoxelRow) == 12, "packed voxel row");

}  // namespace h5

}  // namespace

extern "C" {

// events: ids / vals concatenated, event i at [offsets[i], offsets[i+1]).
// out: float32[b, max_voxels, ndim + 1], written in full.  n_threads 0:
// one per hardware thread.  Returns the number of threads used.
int seid_assemble_sparse_batch(const uint64_t* ids, const float* vals,
                               const int64_t* offsets, int64_t b,
                               int64_t max_voxels, const int64_t* dims,
                               int ndim, int normalize, int augment,
                               float blur_sigma, const int32_t* translate,
                               uint64_t seed, int n_threads, float* out) {
  if (ndim < 1 || ndim > 3 || b < 0 || max_voxels < 0) return -1;
  AugmentParams aug;
  aug.enabled = augment != 0;
  aug.blur_sigma = blur_sigma;
  aug.seed = seed;
  for (int d = 0; d < ndim && translate; ++d) aug.translate[d] = translate[d];
  std::vector<EventRef> events(static_cast<size_t>(b));
  for (int64_t i = 0; i < b; ++i)
    events[size_t(i)] = {ids + offsets[i], vals + offsets[i],
                         offsets[i + 1] - offsets[i]};
  const int64_t stride = max_voxels * (ndim + 1);
  unsigned want = n_threads > 0 ? unsigned(n_threads)
                                : std::max(1u, std::thread::hardware_concurrency());
  unsigned threads = unsigned(std::min<int64_t>(want, std::max<int64_t>(b, 1)));
  auto fill = [&](int64_t i) {
    fill_event(events[size_t(i)], out + i * stride, max_voxels, dims, ndim,
               normalize != 0, aug, uint64_t(i));
  };
  if (threads <= 1) {
    for (int64_t i = 0; i < b; ++i) fill(i);
    return 1;
  }
  std::atomic<int64_t> next(0);
  std::vector<std::thread> pool;
  for (unsigned t = 0; t < threads; ++t) {
    pool.emplace_back([&]() {
      for (;;) {
        int64_t i = next.fetch_add(1);
        if (i >= b) return;
        fill(i);
      }
    });
  }
  for (auto& th : pool) th.join();
  return int(threads);
}

// Binds the HDF5 C library `lib` (a soname or a path).  Returns a handle for
// seid_read_voxel_slabs, or null if the library or a symbol is missing.
// The handle lives as long as the process.
void* seid_hdf5_load(const char* lib) {
  void* h = dlopen(lib, RTLD_NOW | RTLD_LOCAL);
  if (!h) return nullptr;
  auto* x = new h5::Api{};
  auto sym = [&](const char* n) { return dlsym(h, n); };
#define H5BIND(name)                   \
  *(void**)(&x->name) = sym(#name);    \
  if (!x->name) {                      \
    delete x;                          \
    return nullptr;                    \
  }
  H5BIND(H5open)
  H5BIND(H5Fopen)
  H5BIND(H5Fclose)
  H5BIND(H5Dopen2)
  H5BIND(H5Dclose)
  H5BIND(H5Dget_space)
  H5BIND(H5Sclose)
  H5BIND(H5Screate_simple)
  H5BIND(H5Sselect_hyperslab)
  H5BIND(H5Dread)
  H5BIND(H5Tcreate)
  H5BIND(H5Tinsert)
  H5BIND(H5Tclose)
#undef H5BIND
  std::lock_guard<std::mutex> lock(h5::mu);
  x->H5open();
  auto* ull = (h5::hid_t*)sym("H5T_NATIVE_ULLONG_g");
  auto* flt = (h5::hid_t*)sym("H5T_NATIVE_FLOAT_g");
  if (!ull || !flt) {
    delete x;
    return nullptr;
  }
  x->native_ullong = *ull;
  x->native_float = *flt;
  return x;
}

// Reads n_slabs slabs (first[i], count[i]) of the compound voxel dataset
// `dataset` (fields matched by name: id u64, value f32) of the file `path`
// into ids / vals, concatenated in slab order.  0 on success, -1 if the
// file, the dataset or a read fails.
int seid_read_voxel_slabs(void* handle, const char* path, const char* dataset,
                          const uint64_t* first, const uint64_t* count,
                          int64_t n_slabs, uint64_t* ids, float* vals) {
  auto& H = *static_cast<h5::Api*>(handle);
  std::vector<h5::VoxelRow> rows;
  std::lock_guard<std::mutex> lock(h5::mu);
  h5::hid_t f = H.H5Fopen(path, h5::kAccRdonly, h5::kDefault);
  if (f < 0) return -1;
  bool fail = false;
  h5::hid_t d = H.H5Dopen2(f, dataset, h5::kDefault);
  h5::hid_t memtype = H.H5Tcreate(h5::kCompound, sizeof(h5::VoxelRow));
  if (d < 0 || memtype < 0) fail = true;
  if (!fail) {
    H.H5Tinsert(memtype, "id", 0, H.native_ullong);
    H.H5Tinsert(memtype, "value", 8, H.native_float);
  }
  int64_t pos = 0;
  for (int64_t i = 0; !fail && i < n_slabs; ++i) {
    h5::hsize_t start = first[i], n = count[i];
    if (n == 0) continue;
    rows.resize(size_t(n));
    h5::hid_t fspace = H.H5Dget_space(d);
    H.H5Sselect_hyperslab(fspace, h5::kSelectSet, &start, nullptr, &n,
                          nullptr);
    h5::hid_t mspace = H.H5Screate_simple(1, &n, nullptr);
    if (H.H5Dread(d, memtype, mspace, fspace, h5::kDefault, rows.data()) < 0)
      fail = true;
    H.H5Sclose(mspace);
    H.H5Sclose(fspace);
    for (size_t j = 0; !fail && j < rows.size(); ++j) {
      ids[pos + int64_t(j)] = rows[j].id;
      vals[pos + int64_t(j)] = rows[j].value;
    }
    pos += int64_t(n);
  }
  if (memtype >= 0) H.H5Tclose(memtype);
  if (d >= 0) H.H5Dclose(d);
  H.H5Fclose(f);
  return fail ? -1 : 0;
}

// Window plans of a batch.  coords: i32[b, cap0, 3], -1 padded, unsorted.
// caps, ov_caps, window_r_series: depth + 1 entries; ov_caps_down: depth;
// series_kernels: [depth + 1, 3].  outputs: the caller's buffers, in this
// order:
//   for each level l = 0..depth: coords i32[b, caps[l], 3], n_active i32[b],
//     site_dropped i32[b];
//   for each plan, in the order initial, series 0..depth, down_f
//     0..depth-1, down_r 0..depth-1: start i32[b, tiles, K], ov_src,
//     ov_dst, ov_k i32[b, S], ov_valid u8[b, S], ov_dropped i32[b]
//   (tiles = cdiv(query capacity, 128); S the plan's list width: ov_caps[l]
//   for series l, ov_cap_initial, ov_caps_down[l] for both plans of level
//   l).
// The events are shared out among plan_threads(b) workers, each building
// and packing whole events; SEID_PLAN_TEST_DELAY_US makes each event sleep
// first (tests of the pool on hosts with few cores).  Returns the number of
// workers, or -1 if the arguments are refused.
int64_t seid_build_window_plans(
    const int32_t* coords, int64_t b, int64_t cap0, const int64_t* grid,
    int64_t depth, const int64_t* caps, const int64_t* initial_kernel,
    const int64_t* series_kernels, const int64_t* stride,
    const int64_t* window_r_series, int64_t window_r_initial,
    int64_t window_r_down, int64_t window_r_rev, const int64_t* ov_caps,
    int64_t ov_cap_initial, const int64_t* ov_caps_down,
    void* const* outputs) {
  if (b < 0 || depth < 0 || cap0 < 0 || caps[0] < cap0) return -1;
  seid_plans::Geometry g;
  g.depth = depth;
  g.grids.resize(size_t((depth + 1) * 3));
  for (int d = 0; d < 3; ++d) {
    g.grids[size_t(d)] = grid[d];
    g.initial_kernel[d] = initial_kernel[d];
    g.stride[d] = stride[d];
    if (stride[d] < 1 || grid[d] < 1) return -1;
  }
  for (int64_t l = 1; l <= depth; ++l)
    for (int d = 0; d < 3; ++d)
      g.grids[size_t(l * 3 + d)] =
          (g.grids[size_t((l - 1) * 3 + d)] + stride[d] - 1) / stride[d];
  g.caps.assign(caps, caps + depth + 1);
  g.series_kernels.assign(series_kernels, series_kernels + (depth + 1) * 3);
  g.initial = {window_r_initial, ov_cap_initial};
  for (int64_t l = 0; l <= depth; ++l)
    g.series.push_back({window_r_series[l], ov_caps[l]});
  for (int64_t l = 0; l < depth; ++l)
    g.down.push_back({window_r_down, ov_caps_down[l]});
  g.window_r_rev = window_r_rev;

  auto tiles = [](int64_t cap) {
    return (cap + seid_plans::kTileT - 1) / seid_plans::kTileT;
  };
  auto n_offsets = [](const int64_t* k) { return k[0] * k[1] * k[2]; };
  const int64_t kd = n_offsets(stride);
  size_t pos = size_t(3 * (depth + 1));
  auto next_plan = [&](int64_t n_start, int64_t width) {
    PlanOut o{static_cast<int32_t*>(outputs[pos]),
              static_cast<int32_t*>(outputs[pos + 1]),
              static_cast<int32_t*>(outputs[pos + 2]),
              static_cast<int32_t*>(outputs[pos + 3]),
              static_cast<uint8_t*>(outputs[pos + 4]),
              static_cast<int32_t*>(outputs[pos + 5]), n_start, width};
    pos += 6;
    return o;
  };
  const PlanOut initial_out =
      next_plan(tiles(caps[0]) * n_offsets(initial_kernel), ov_cap_initial);
  std::vector<PlanOut> series_out, down_f_out, down_r_out;
  for (int64_t l = 0; l <= depth; ++l)
    series_out.push_back(next_plan(
        tiles(caps[l]) * n_offsets(series_kernels + l * 3), ov_caps[l]));
  for (int64_t l = 0; l < depth; ++l)
    down_f_out.push_back(next_plan(tiles(caps[l + 1]) * kd, ov_caps_down[l]));
  for (int64_t l = 0; l < depth; ++l)
    down_r_out.push_back(next_plan(tiles(caps[l]) * kd, ov_caps_down[l]));

  int64_t delay_us = 0;
  if (const char* env = std::getenv("SEID_PLAN_TEST_DELAY_US"))
    delay_us = std::atol(env);

  auto one_event = [&](int64_t i) {
    seid_plans::EventPlans ev;
    seid_plans::build_event_plans(coords + i * cap0 * 3, cap0, g, &ev);
    for (int64_t l = 0; l <= depth; ++l) {
      const seid_plans::LevelData& lv = ev.levels[size_t(l)];
      const int64_t cap = caps[l], n = int64_t(lv.keys.size());
      int32_t* c = static_cast<int32_t*>(outputs[3 * l]) + i * cap * 3;
      std::memcpy(c, lv.coords.data(), sizeof(int32_t) * size_t(n * 3));
      std::fill(c + n * 3, c + cap * 3, -1);
      static_cast<int32_t*>(outputs[3 * l + 1])[i] = int32_t(n);
      static_cast<int32_t*>(outputs[3 * l + 2])[i] = int32_t(lv.dropped);
    }
    pack_plan(ev.initial, initial_out, i);
    for (int64_t l = 0; l <= depth; ++l)
      pack_plan(ev.series[size_t(l)], series_out[size_t(l)], i);
    for (int64_t l = 0; l < depth; ++l) {
      pack_plan(ev.down_f[size_t(l)], down_f_out[size_t(l)], i);
      pack_plan(ev.down_r[size_t(l)], down_r_out[size_t(l)], i);
    }
  };

  const unsigned n_threads = plan_threads(b);
  std::atomic<int64_t> next(0);
  auto work = [&]() {
    for (;;) {
      const int64_t i = next.fetch_add(1);
      if (i >= b) return;
      if (delay_us > 0)
        std::this_thread::sleep_for(std::chrono::microseconds(delay_us));
      const int64_t now = g_plan_inflight.fetch_add(1) + 1;
      int64_t peak = g_plan_peak.load();
      while (now > peak && !g_plan_peak.compare_exchange_weak(peak, now)) {
      }
      one_event(i);
      g_plan_inflight.fetch_sub(1);
    }
  };
  if (n_threads <= 1) {
    work();
  } else {
    std::vector<std::thread> pool;
    for (unsigned t = 0; t < n_threads; ++t) pool.emplace_back(work);
    for (auto& th : pool) th.join();
  }
  return int64_t(n_threads);
}

// The plan pool's concurrency watermark since the last call; resets it.
int64_t seid_plan_pool_peak_concurrency() { return g_plan_peak.exchange(0); }

}  // extern "C"
