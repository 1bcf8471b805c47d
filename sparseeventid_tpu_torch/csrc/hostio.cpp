// Host IO engine: threaded event -> padded COO batch assembly and the
// native HDF5 voxel-slab reader.
//
// Copied from sparseeventid_tpu/io/_hostio.cpp (fill_event, the threaded
// assemble_sparse_batch, the dlopen HDF5 reader) behind a plain C
// interface that io/hostio.py loads with ctypes.  The host plan builder of
// that file is not here.  Python owns every buffer: the caller allocates
// the outputs and passes their pointers, nothing is allocated across the
// boundary.  ctypes releases the interpreter lock for the call, so a
// prefetch thread assembling or reading overlaps the main thread.
//
// Build (io/hostio.py does it at first use):
//   g++ -O3 -std=c++17 -pthread -shared -fPIC -o hostio.so hostio.cpp -ldl

#include <dlfcn.h>

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <mutex>
#include <random>
#include <thread>
#include <vector>

namespace {

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

}  // extern "C"
