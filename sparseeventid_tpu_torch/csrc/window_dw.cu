// Windowed sparse convolution, weight gradient over the in-window pairs of
// a plan:
//   dw[k, c, o] += sum_b sum_t feats[b, n(b, t, k), c] * gy[b, t, o]
// where n(b, t, k) is the table row matched by query row t at query column
// k' = kmap[k] inside the plan window (window_match.cuh: the same pair set
// as the forward conv, whose complement is the plan's overflow list).
// Dead tiles and rows at or past m_bound add nothing.
//
// Replaces: sparseeventid_tpu/ops/pallas/window_conv.py, window_dw (Pallas
// kernel _dw_kernel).
//
// Bound on the H100: bytes (keys, table, query meta and gy read once; dw is
// K * C * CO floats).  On the main path it serves the initial 5^3 conv
// (K = 125, C = 1, CO = 32): dw is 4000 floats and the work is the 125
// searches per query, so the kernel is bound by the matching's latency.
// Design: one block per (b, 128-query tile), 256 threads.  Per offset the
// first 128 threads match their query (skip the offset if none matched);
// then, 32 x 32 channels at a time, the matched table rows and the tile's
// gy rows are staged in shared memory and their outer-product sum over the
// tile is reduced inside the block (tile_outer_add) and added to dw with
// float32 atomicAdd.  The order of the atomic sums is not fixed, so dw is
// bit-reproducible only where float32 addition is exact.

#include "window_match.cuh"

namespace {

using namespace seid;

template <typename T>
__global__ void __launch_bounds__(kThreads, 3)
dw_kernel(const int* __restrict__ keys, int n_in,
          const T* __restrict__ feats, int C,
          const int* __restrict__ qmeta, int nw, int M,
          const int* __restrict__ start, int n_tiles, int K,
          const T* __restrict__ gy, int CO,
          const int* __restrict__ q_active, int m_bound, int window_r,
          float* __restrict__ dw, Offsets offs) {
  __shared__ int nbr[kTile];
  __shared__ float xg[kTile][kChunk + 1];  // matched table rows, c0..c0+32
  __shared__ float gs[kTile][kChunk + 1];  // the tile's gy rows, o0..o0+32
  const int tile = blockIdx.x;
  const int b = blockIdx.y;
  const int t = threadIdx.x;
  const long long m0 = (long long)tile * kTile;
  if (tile >= live_tiles(q_active[b], m_bound)) return;  // block-uniform

  const int* meta_b = qmeta + (long long)b * (1 + nw) * M;
  const int* keys_b = keys + (long long)b * n_in;
  const int* start_t = start + ((long long)b * n_tiles + tile) * K;
  const T* feats_b = feats + (long long)b * n_in * C;
  int base = 0;
  const long long mq = m0 + t;
  const bool q_in = t < kTile && mq < M && mq < m_bound;
  if (q_in) base = meta_b[mq];
  int gs_o0 = -1;  // the gy chunk gs holds (block-uniform)
  for (int k = 0; k < K; ++k) {
    const int col = offs.col[k];
    if (t < kTile) {
      int row = -1;
      if (q_in)
        row = match_row(keys_b, n_in, meta_b, M, mq, base, col,
                        offs.dkey[col], start_t[col], window_r);
      nbr[t] = row;
    }
    const int any = __syncthreads_or(t < kTile && nbr[t] >= 0);
    if (!any) continue;  // uniform: no query of this tile matched
    for (int c0 = 0; c0 < C; c0 += kChunk) {
      const int cw = (C - c0) < kChunk ? (C - c0) : kChunk;
      for (int idx = t; idx < kTile * kChunk; idx += kThreads) {
        const int r = idx / kChunk;
        const int cc = idx - r * kChunk;
        const int row = nbr[r];
        xg[r][cc] = (row >= 0 && cc < cw)
            ? to_f(feats_b[(long long)row * C + c0 + cc]) : 0.f;
      }
      for (int o0 = 0; o0 < CO; o0 += kChunk) {
        const int ow = (CO - o0) < kChunk ? (CO - o0) : kChunk;
        if (gs_o0 != o0) {
          for (int idx = t; idx < kTile * kChunk; idx += kThreads) {
            const int r = idx / kChunk;
            const int oo = idx - r * kChunk;
            const long long m = m0 + r;
            gs[r][oo] = (oo < ow && m < M && m < m_bound)
                ? to_f(gy[((long long)b * M + m) * CO + o0 + oo]) : 0.f;
          }
          gs_o0 = o0;
        }
        __syncthreads();
        tile_outer_add(xg, gs, cw, ow,
                       dw + ((long long)k * C + c0) * CO + o0, CO);
        __syncthreads();
      }
    }
  }
}

template <typename T>
int launch(const void* keys, int n_in, const void* feats, int C,
           const void* qmeta, int nw, int M, const void* start, int n_tiles,
           int K, const void* gy, int CO, const void* q_active, int m_bound,
           int window_r, void* dw, const int* dkeys, const int* cols, int B,
           void* stream) {
  if (K > kMaxK) return (int)cudaErrorInvalidValue;
  Offsets offs;
  fill_offsets(offs, dkeys, cols, K);
  const int m_tiles = (M + kTile - 1) / kTile;
  if (m_tiles > 0 && B > 0 && C > 0 && CO > 0) {
    dim3 grid(m_tiles, B);
    dw_kernel<T><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const int*)keys, n_in, (const T*)feats, C, (const int*)qmeta, nw, M,
        (const int*)start, n_tiles, K, (const T*)gy, CO,
        (const int*)q_active, m_bound, window_r, (float*)dw, offs);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// keys i32[B, n_in] sorted; feats T[B, n_in, C]; qmeta i32[B, 1+nw, M];
// start i32[B, n_tiles, K'] (K' >= every cols[k] + 1); gy T[B, M, CO];
// q_active i32[B]; dw f32[K, C, CO], ZEROED by the caller (the kernel adds
// onto it).  dkeys and cols are HOST arrays of K ints.  Returns the
// launch's cudaError_t.
#define SEID_DW_ENTRY(NAME, T)                                                \
  extern "C" int NAME(const void* keys, int n_in, const void* feats, int C,   \
                      const void* qmeta, int nw, int M, const void* start,    \
                      int n_tiles, int K, const void* gy, int CO,             \
                      const void* q_active, int m_bound, int window_r,        \
                      void* dw, const int* dkeys, const int* cols, int B,     \
                      void* stream) {                                         \
    return launch<T>(keys, n_in, feats, C, qmeta, nw, M, start, n_tiles, K,   \
                     gy, CO, q_active, m_bound, window_r, dw, dkeys, cols, B, \
                     stream);                                                 \
  }

SEID_DW_ENTRY(seid_window_dw_f32, float)
SEID_DW_ENTRY(seid_window_dw_bf16, __nv_bfloat16)
