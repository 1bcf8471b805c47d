// Shared pieces of the window kernels (forward conv, fused backward, dW):
// the one definition of which (query, offset) pairs are IN-WINDOW, so that
// forward and backward cannot disagree on the pair set the overflow list
// complements; the float conversions; and the tile outer-product reduction
// the two backward kernels use for dW.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
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

// Table row matched by query row mq at query column col, or -1.  The query
// is live only where bit col of the packed validity words is set; its key
// base + dkey is searched only inside the plan window [s, s + window_r) of
// the sorted, unique keys.  A match outside the window is NOT a match here:
// it is on the plan's overflow list.  Key arithmetic is in 64 bits.
__device__ __forceinline__ int match_row(const int* __restrict__ keys_b,
                                         int n_in,
                                         const int* __restrict__ meta_b,
                                         int M, long long mq, int base,
                                         int col, int dkey, long long s,
                                         int window_r) {
  const int word = meta_b[(long long)(1 + (col >> 5)) * M + mq];
  if (!((word >> (col & 31)) & 1)) return -1;
  const long long q = (long long)base + dkey;
  long long lo = s > 0 ? s : 0;
  long long end = s + window_r;
  end = end < n_in ? end : n_in;
  long long hi = end;
  while (lo < hi) {  // lower bound of q in keys[s, end)
    const long long mid = (lo + hi) >> 1;
    if ((long long)keys_b[mid] < q) lo = mid + 1; else hi = mid;
  }
  return (lo < end && (long long)keys_b[lo] == q) ? (int)lo : -1;
}

// dw[ci, oj] += sum_r a[r][ci] * g[r][oj] over the 128 rows of a tile, for
// ci < cw, oj < ow, added atomically (float32) onto dw_k (row stride ld).
// All kThreads threads call it.  Four adjacent lanes share one 4 x 4 output
// tile and split the rows (r = lane_group + 4 rr), then reduce by shuffles;
// with the 33-float row pitch every shared-memory read is conflict-free.
__device__ __forceinline__ void tile_outer_add(
    const float (*a)[kChunk + 1], const float (*g)[kChunk + 1], int cw,
    int ow, float* __restrict__ dw_k, int ld) {
  const int t = threadIdx.x;
  const int grp = t & 3;
  const int id = t >> 2;        // 0..63
  const int ci0 = (id >> 3) * 4;  // same for the 8 tiles of a warp
  const int oj0 = (id & 7) * 4;
  if (ci0 >= cw) return;  // warp-uniform
  float s[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
  for (int r = grp; r < kTile; r += 4) {
    float av[4], gv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = a[r][ci0 + i];
#pragma unroll
    for (int j = 0; j < 4; ++j) gv[j] = g[r][oj0 + j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] += av[i] * gv[j];
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float v = s[i][j];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      if (grp == 0 && ci0 + i < cw && oj0 + j < ow && v != 0.f)
        atomicAdd(dw_k + (long long)(ci0 + i) * ld + oj0 + j, v);
    }
}

}  // namespace seid
