// Shared pieces of the window kernels (forward conv, backward, dW): the one
// definition of which (query, offset) pairs are IN-WINDOW, so that forward
// and backward cannot disagree on the pair set the overflow list
// complements; the float conversions; the numbering of the live query
// tiles that the dW kernels share out among their blocks; and the tile
// outer-product sum of window_dw.cu.  Nothing here adds with atomics.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <climits>
#include <stdint.h>

namespace seid {

constexpr int kTile = 128;  // queries per tile (the plan's tile)
constexpr int kMaxK = 128;  // most offsets a kernel takes
constexpr int kChunk = 32;  // channels staged per step (rows of 33 floats)
constexpr int kThreads = 256;

struct Offsets {
  int dkey[kMaxK];  // key delta per query column
  int col[kMaxK];   // query column (meta bit and start column) per slot
};

inline void fill_offsets(Offsets& offs, const int* dkeys, const int* cols,
                         int K) {
  for (int k = 0; k < K; ++k) {
    offs.dkey[k] = dkeys[k];
    offs.col[k] = cols[k];
  }
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float v) {
  return __float2bfloat16(v);
}

// Query tiles a kernel computes: those with a live row, inside the static
// row bound.  Tiles past it are dead (their outputs are 0).
__device__ __forceinline__ int live_tiles(int q_active, int m_bound) {
  const int live = (q_active + kTile - 1) / kTile;
  const int bound_tiles = (m_bound + kTile - 1) / kTile;
  return live < bound_tiles ? live : bound_tiles;
}

// The live query tiles of all events, numbered in event order: their
// count, and the (event, tile) of number g.  B is a batch, so a scan of it
// per tile is cheap; sharing out live tiles (not all tiles) keeps the
// blocks' loads even.
__device__ __forceinline__ int event_tiles(const int* q_active, int b,
                                           int m_bound, int m_tiles) {
  const int n = live_tiles(q_active[b], m_bound);
  return n < m_tiles ? n : m_tiles;
}

__device__ __forceinline__ int count_live(const int* q_active, int B,
                                          int m_bound, int m_tiles) {
  int n = 0;
  for (int b = 0; b < B; ++b) n += event_tiles(q_active, b, m_bound, m_tiles);
  return n;
}

__device__ __forceinline__ void live_tile(const int* q_active, int m_bound,
                                          int m_tiles, int g, int& b,
                                          int& tile) {
  b = 0;
  for (int n; g >= (n = event_tiles(q_active, b, m_bound, m_tiles)); ++b)
    g -= n;
  tile = g;
}

// The plan window of a query tile at one column: table rows [lo, end),
// the window [s, s + window_r) clamped to the table.
__device__ __forceinline__ void window_rows(long long s, int window_r,
                                            int n_in, long long& lo,
                                            long long& end) {
  lo = s > 0 ? s : 0;
  end = s + window_r;
  end = end < n_in ? end : n_in;
}

// Position of key q in the sorted, unique keys[lo, end), or -1 (a lower
// bound, then an equality test).  Key arithmetic is in 64 bits.
__device__ __forceinline__ long long find_key(const int* keys, long long lo,
                                              long long end, long long q) {
  long long hi = end;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if ((long long)keys[mid] < q) lo = mid + 1; else hi = mid;
  }
  return (lo < end && (long long)keys[lo] == q) ? lo : -1;
}

// find_key over [0, n) of a window staged in shared memory, for N keys at
// once (independent searches interleaved, N loads in flight), in 32 bits:
// a key outside the int range matches nothing, and each lower bound is
// taken by binary lifting, the same number of steps for every lane.
template <int N>
__device__ __forceinline__ void find_keys_staged(const int* keys, int n,
                                                 const long long (&q)[N],
                                                 int (&pos)[N]) {
  int qi[N], lo[N];  // lo: keys below qi
  bool fits[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    fits[i] = q[i] >= INT_MIN && q[i] <= INT_MAX;
    qi[i] = (int)q[i];
    lo[i] = 0;
  }
  for (int step = n > 0 ? 1 << (31 - __clz(n)) : 0; step > 0; step >>= 1)
#pragma unroll
    for (int i = 0; i < N; ++i)
      if (lo[i] + step <= n && keys[lo[i] + step - 1] < qi[i]) lo[i] += step;
#pragma unroll
  for (int i = 0; i < N; ++i)
    pos[i] = (fits[i] && lo[i] < n && keys[lo[i]] == qi[i]) ? lo[i] : -1;
}

// Table row matched by query row mq at query column col, or -1.  The query
// is live only where bit col of the packed validity words is set; its key
// base + dkey is searched only inside the plan window (window_rows) of the
// sorted, unique keys.  A match outside the window is NOT a match here: it
// is on the plan's overflow list.  A kernel that stages the window's keys
// in shared memory searches its copy with find_keys_staged over
// [0, end - lo) and adds lo: the same pair set.
__device__ __forceinline__ int match_row(const int* __restrict__ keys_b,
                                         int n_in,
                                         const int* __restrict__ meta_b,
                                         int M, long long mq, int base,
                                         int col, int dkey, long long s,
                                         int window_r) {
  const int word = meta_b[(long long)(1 + (col >> 5)) * M + mq];
  if (!((word >> (col & 31)) & 1)) return -1;
  long long lo, end;
  window_rows(s, window_r, n_in, lo, end);
  return (int)find_key(keys_b, lo, end, (long long)base + dkey);
}

// The thread layout of a 32 x 32 outer-product tile: four adjacent lanes
// share one 4 x 4 output tile (rows ci0.., columns oj0..) and split the
// tile's rows (r = grp + 4 rr).  All kThreads threads take part.
struct OuterTile {
  int grp, ci0, oj0;
  __device__ __forceinline__ OuterTile() {
    const int t = threadIdx.x;
    const int id = t >> 2;  // 0..63
    grp = t & 3;
    ci0 = (id >> 3) * 4;  // same for the 8 tiles of a warp
    oj0 = (id & 7) * 4;
  }
};

// s[i][j] += sum over this thread's rows r < rows of a[r][ci0 + i] *
// g[r][oj0 + j], for a warp whose rows start below cw (the others add
// nothing).  With the 33-float row pitch every shared-memory read is
// conflict-free.
__device__ __forceinline__ void tile_outer_acc(
    const OuterTile& ot, const float (*a)[kChunk + 1],
    const float (*g)[kChunk + 1], int cw, int rows, float (&s)[4][4]) {
  if (ot.ci0 >= cw) return;  // warp-uniform
  for (int r = ot.grp; r < rows; r += 4) {
    float av[4], gv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = a[r][ot.ci0 + i];
#pragma unroll
    for (int j = 0; j < 4; ++j) gv[j] = g[r][ot.oj0 + j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] += av[i] * gv[j];
  }
}

// A stable counting sort of the block's kThreads items by key, key in
// [0, n_keys) (n_keys <= kThreads), key < 0 left out: returns the item's
// place in key order, list (thread) order within a key, or -1, and leaves in
// start[0 .. n_keys] the first place of each key and their end.  hist:
// kThreads / 32 * n_keys ints, wsum: kThreads / 32 ints, both scratch.
// Every thread calls it; start is visible to all on return.  No atomics:
// each warp's count of a key comes from __match_any_sync.
__device__ __forceinline__ int bucket_place(int key, int n_keys, int* hist,
                                            int* start, int* wsum) {
  constexpr int kW = kThreads / 32;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  for (int i = t; i < kW * n_keys; i += kThreads) hist[i] = 0;
  const unsigned peers = __match_any_sync(0xffffffffu, key);
  const int rank = __popc(peers & ((1u << lane) - 1u));
  __syncthreads();  // hist is zero
  if (key >= 0 && rank == 0) hist[warp * n_keys + key] = __popc(peers);
  __syncthreads();
  int tot = 0;  // key t's items; hist becomes the warps' prefix
  if (t < n_keys)
    for (int w = 0; w < kW; ++w) {
      const int cnt = hist[w * n_keys + t];
      hist[w * n_keys + t] = tot;
      tot += cnt;
    }
  if (warp * 32 < n_keys) {  // inclusive scan of tot over the keys
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, tot, d);
      if (lane >= d) tot += v;
    }
    if (lane == 31) wsum[warp] = tot;
  }
  __syncthreads();
  if (t < n_keys) {
    for (int w = 0; w < warp; ++w) tot += wsum[w];
    start[t + 1] = tot;
  }
  if (t == 0) start[0] = 0;
  __syncthreads();
  return key >= 0 ? start[key] + hist[warp * n_keys + key] + rank : -1;
}

// The four row groups' partial sums reduced by shuffles: lane group 0
// holds the tile's sums afterwards.  Whole warps call it.
__device__ __forceinline__ void tile_outer_reduce(float (&s)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      s[i][j] += __shfl_xor_sync(0xffffffffu, s[i][j], 1);
      s[i][j] += __shfl_xor_sync(0xffffffffu, s[i][j], 2);
    }
}

}  // namespace seid

// out[e] = part[0, e] + part[1, e] + ... in that order: the second pass of
// the dW kernels whose blocks each write their partial sums once to a row of
// a float32 scratch [n_parts, n] (window_bwd.cu, overflow_dw.cu), so that dW
// has the same bits on every run.  A block takes `cols` outputs (a power of
// two dividing kThreads); its kThreads / cols thread groups sum the rows
// p = g, g + groups, ... in order, and the groups' sums are added in the
// order g = 0, 1, ...  ordered_sum picks cols so that a small dW still
// spreads over the card.
namespace {

__global__ void __launch_bounds__(seid::kThreads)
ordered_sum_kernel(float* __restrict__ out, const float* __restrict__ part,
                   int n_parts, long long n, int cols) {
  __shared__ float sums[seid::kThreads];
  const int col = threadIdx.x % cols;
  const int g = threadIdx.x / cols;
  const int groups = seid::kThreads / cols;
  const long long e = (long long)blockIdx.x * cols + col;
  float sum = 0.f;
  if (e < n) {
#pragma unroll 4
    for (int p = g; p < n_parts; p += groups)
      sum += part[(long long)p * n + e];
  }
  sums[threadIdx.x] = sum;
  __syncthreads();
  if (g != 0 || e >= n) return;
  float total = sums[col];
  for (int i = 1; i < groups; ++i) total += sums[i * cols + col];
  out[e] = total;
}

// ordered_sum_kernel over n outputs on stream st: 64 outputs a block, or
// fewer (down to 8) while that leaves under about 264 blocks.
inline cudaError_t ordered_sum(float* out, const float* part, int n_parts,
                               long long n, cudaStream_t st) {
  int cols = 64;
  while (cols > 8 && (n + cols - 1) / cols < 264) cols /= 2;
  ordered_sum_kernel<<<(unsigned)((n + cols - 1) / cols), seid::kThreads, 0,
                       st>>>(out, part, n_parts, n, cols);
  return cudaGetLastError();
}
}  // namespace
