// Windowed sparse convolution, forward: the in-window part of
//   out[b, m, :] = sum_k  feats[b, row(b, m, k), :] @ W[k]
// where row(b, m, k) is the table row whose key equals base[m] + dkey[k'],
// searched only inside the plan window [start[b, m / 128, k'], + window_r),
// with k' = kmap[k] (identity without a kmap).  The query is live only where
// bit k' of the packed validity words is set.  Matches outside the window
// are NOT counted here: they are on the plan's overflow list, which the
// sidecar kernel applies; counting them here would count them twice.
// Tiles at or past ceil(q_active / 128), and rows at or past m_bound, are 0.
//
// Replaces: sparseeventid_tpu/ops/pallas/window_conv.py, window_conv_apply
// (Pallas kernel _conv_kernel).
//
// Bound on the H100: bytes.  At the dune3d shapes the table, the query meta
// and the output are tens of MB, against 2 * pairs * C * CO flops (a few
// GFLOP) that the tensor cores would take a few microseconds for.  This
// first kernel is far from that bound: it is limited by float32 FMAs on
// the CUDA cores and by two barriers per offset and channel chunk, which
// matters most at the deep levels (few pairs, C up to 192).  wgmma tiles
// and TMA staging are later work.
// Design: one block per (b, 128-query tile, 32 output channels), 256
// threads.  For each offset the first 128 threads binary-search their
// query's key in the window (keys are sorted and unique), the block skips
// the offset when no query of the tile matched, and otherwise stages the
// 128 matched rows and W[k] in shared memory, 32 input channels at a time,
// as a small GEMM with a 4 x 4 register tile per thread.  Accumulation is
// float32 over k and C; the output is cast once to the feature type.
// The matching itself (validity bit, 64-bit key arithmetic, the search in
// the window) is window_match.cuh's, shared with the backward kernels.

#include "window_match.cuh"

namespace {

using namespace seid;

constexpr int kCo = kChunk;  // output channels per block
constexpr int kCc = kChunk;  // input channels staged per step

template <typename T>
__global__ void __launch_bounds__(kThreads)
conv_kernel(const int* __restrict__ keys, int n_in,
            const T* __restrict__ feats, int C,
            const int* __restrict__ qmeta, int nw, int M,
            const int* __restrict__ start, int n_tiles, int K,
            const T* __restrict__ w, int CO,
            const int* __restrict__ q_active, int m_bound, int window_r,
            T* __restrict__ out, Offsets offs) {
  __shared__ int nbr[kTile];
  __shared__ float xs[kTile][kCc + 1];
  __shared__ float ws[kCc][kCo + 1];
  const int tile = blockIdx.x;
  const int b = blockIdx.y;
  const int co0 = blockIdx.z * kCo;
  const int t = threadIdx.x;
  const int tx = t & 7;   // output columns tx + 8 j
  const int ty = t >> 3;  // output rows ty + 32 i
  const long long m0 = (long long)tile * kTile;

  const int live = live_tiles(q_active[b], m_bound);

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  if (tile < live) {  // block-uniform
    const int* meta_b = qmeta + (long long)b * (1 + nw) * M;
    const int* keys_b = keys + (long long)b * n_in;
    const int* start_t = start + ((long long)b * n_tiles + tile) * K;
    int base = 0;
    const long long mq = m0 + t;
    const bool q_in = t < kTile && mq < M && mq < m_bound;
    if (q_in) base = meta_b[mq];
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
      const T* wk = w + (long long)k * C * CO;
      for (int c0 = 0; c0 < C; c0 += kCc) {
        const int cw = (C - c0) < kCc ? (C - c0) : kCc;
        for (int idx = t; idx < kTile * cw; idx += kThreads) {
          const int r = idx / cw;
          const int cc = idx - r * cw;
          const int row = nbr[r];
          xs[r][cc] = row >= 0
              ? to_f(feats[((long long)b * n_in + row) * C + c0 + cc])
              : 0.f;
        }
        for (int idx = t; idx < cw * kCo; idx += kThreads) {
          const int ci = idx / kCo;
          const int oj = idx - ci * kCo;
          const int o = co0 + oj;
          ws[ci][oj] = o < CO ? to_f(wk[(long long)(c0 + ci) * CO + o]) : 0.f;
        }
        __syncthreads();
        for (int ci = 0; ci < cw; ++ci) {
          float a[4], bv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) a[i] = xs[ty + 32 * i][ci];
#pragma unroll
          for (int j = 0; j < 4; ++j) bv[j] = ws[ci][tx + 8 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] += a[i] * bv[j];
        }
        __syncthreads();
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long m = m0 + ty + 32 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int o = co0 + tx + 8 * j;
      if (o < CO) out[((long long)b * M + m) * CO + o] = from_f<T>(acc[i][j]);
    }
  }
}

template <typename T>
int launch(const void* keys, int n_in, const void* feats, int C,
           const void* qmeta, int nw, int M, const void* start, int n_tiles,
           int K, const void* w, int CO, const void* q_active, int m_bound,
           int window_r, void* out, const int* dkeys, const int* cols, int B,
           void* stream) {
  if (K > kMaxK) return (int)cudaErrorInvalidValue;
  Offsets offs;
  fill_offsets(offs, dkeys, cols, K);
  const int m_tiles = (M + kTile - 1) / kTile;
  if (m_tiles > 0 && B > 0 && CO > 0) {
    dim3 grid(m_tiles, B, (CO + kCo - 1) / kCo);
    conv_kernel<T><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const int*)keys, n_in, (const T*)feats, C, (const int*)qmeta, nw, M,
        (const int*)start, n_tiles, K, (const T*)w, CO,
        (const int*)q_active, m_bound, window_r, (T*)out, offs);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// keys i32[B, n_in] sorted; feats T[B, n_in, C]; qmeta i32[B, 1+nw, M];
// start i32[B, n_tiles, K'] (K' >= every cols[k] + 1); w T[K, C, CO];
// q_active i32[B]; out T[B, M, CO] (fully written).  dkeys and cols are
// HOST arrays of K ints.  Returns the launch's cudaError_t.
#define SEID_CONV_ENTRY(NAME, T)                                              \
  extern "C" int NAME(const void* keys, int n_in, const void* feats, int C,   \
                      const void* qmeta, int nw, int M, const void* start,    \
                      int n_tiles, int K, const void* w, int CO,              \
                      const void* q_active, int m_bound, int window_r,        \
                      void* out, const int* dkeys, const int* cols, int B,    \
                      void* stream) {                                         \
    return launch<T>(keys, n_in, feats, C, qmeta, nw, M, start, n_tiles, K,   \
                     w, CO, q_active, m_bound, window_r, out, dkeys, cols, B, \
                     stream);                                                 \
  }

SEID_CONV_ENTRY(seid_window_conv_f32, float)
SEID_CONV_ENTRY(seid_window_conv_bf16, __nv_bfloat16)
