// Windowed sparse convolution, fused backward: from ONE gather of the output
// cotangent gy through a plan whose queries are the INPUT rows,
//   dx[b, t, c]  = sum_k sum_o w[k, c, o] * gy[b, n(b, t, k), o]
//   dw[k, c, o] += sum_b sum_t x[b, t, c] * gy[b, n(b, t, k), o]
// where n(b, t, k) is the row of the gy table whose key equals
// base[t] + dkey[k'], searched only inside the plan window (k' = kmap[k];
// window_match.cuh).  Pairs outside the window are the overflow list's:
// the dX and dW sidecars add them.  For a strided conv the plan is the
// reverse plan (one live column per input row); for a submanifold conv it
// is the forward plan with w[perm], and the caller reorders dw by [perm].
// Dead tiles and rows at or past m_bound give dx = 0 and add nothing to dw.
//
// Replaces: sparseeventid_tpu/ops/pallas/window_conv.py, window_bwd_strided
// (Pallas kernel _bwd_strided_kernel; window_bwd_subm is a thin call of it).
//
// Bound on the H100: bytes (gy, x, the query meta and dx are tens of MB at
// level 0; 4 * pairs * C * CO flops are a few GFLOP).  This first kernel
// is far from that bound: float32 FMAs on the CUDA cores, and the float32
// atomics onto dw.  wgmma tiles and TMA staging are later work.
// Design: one block per (b, 128-query tile, 32 input channels), 256
// threads.  The block keeps its x tile in shared memory.  Per offset the
// first 128 threads match their query (skip the offset if none matched);
// then, 32 output channels at a time, the matched gy rows and w[k] are
// staged once and used twice: a 128 x 32 x 32 GEMM into the dx registers
// (4 x 4 per thread, float32 over every k and o, one cast at the end), and
// the 32 x 32 outer-product sum over the tile's rows (tile_outer_add),
// which is reduced inside the block and then added to dw with float32
// atomicAdd, one per (tile, k, c, o) that is not 0.  The order of those
// atomic sums is not fixed, so dw is bit-reproducible only where float32
// addition is exact (integer-valued data); dx has a fixed order.

#include "window_match.cuh"

namespace {

using namespace seid;

template <typename T>
__global__ void __launch_bounds__(kThreads)
bwd_kernel(const int* __restrict__ keys_out, int n_out,
           const T* __restrict__ gy, int CO,
           const T* __restrict__ feats, int C,
           const int* __restrict__ rq, int nw, int M,
           const int* __restrict__ rs, int n_tiles, int K,
           const T* __restrict__ w,
           const int* __restrict__ r_active, int m_bound, int window_r,
           T* __restrict__ dx, float* __restrict__ dw, Offsets offs) {
  __shared__ int nbr[kTile];
  __shared__ float xs[kTile][kChunk + 1];  // the tile's x rows, c0..c0+32
  __shared__ float gs[kTile][kChunk + 1];  // matched gy rows, o0..o0+32
  __shared__ float ws[kChunk][kChunk + 1];  // w[k][c0 + ci][o0 + oj]
  const int tile = blockIdx.x;
  const int b = blockIdx.y;
  const int c0 = blockIdx.z * kChunk;
  const int cw = (C - c0) < kChunk ? (C - c0) : kChunk;
  const int t = threadIdx.x;
  const int tx = t & 7;   // dx channels tx + 8 j
  const int ty = t >> 3;  // dx rows ty + 32 i
  const long long m0 = (long long)tile * kTile;
  const int live = live_tiles(r_active[b], m_bound);

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  if (tile < live) {  // block-uniform
    const int* meta_b = rq + (long long)b * (1 + nw) * M;
    const int* keys_b = keys_out + (long long)b * n_out;
    const int* start_t = rs + ((long long)b * n_tiles + tile) * K;
    const T* gy_b = gy + (long long)b * n_out * CO;
    for (int idx = t; idx < kTile * kChunk; idx += kThreads) {
      const int r = idx / kChunk;
      const int cc = idx - r * kChunk;
      const long long m = m0 + r;
      xs[r][cc] = (cc < cw && m < M && m < m_bound)
          ? to_f(feats[((long long)b * M + m) * C + c0 + cc]) : 0.f;
    }
    int base = 0;
    const long long mq = m0 + t;
    const bool q_in = t < kTile && mq < M && mq < m_bound;
    if (q_in) base = meta_b[mq];
    for (int k = 0; k < K; ++k) {
      const int col = offs.col[k];
      if (t < kTile) {
        int row = -1;
        if (q_in)
          row = match_row(keys_b, n_out, meta_b, M, mq, base, col,
                          offs.dkey[col], start_t[col], window_r);
        nbr[t] = row;
      }
      // also orders the xs stores and the last chunk's reads
      const int any = __syncthreads_or(t < kTile && nbr[t] >= 0);
      if (!any) continue;  // uniform: no query of this tile matched
      const T* wk = w + (long long)k * C * CO;
      float* dw_k = dw + ((long long)k * C + c0) * CO;
      for (int o0 = 0; o0 < CO; o0 += kChunk) {
        const int ow = (CO - o0) < kChunk ? (CO - o0) : kChunk;
        for (int idx = t; idx < kTile * kChunk; idx += kThreads) {
          const int r = idx / kChunk;
          const int oo = idx - r * kChunk;
          const int row = nbr[r];
          gs[r][oo] = (row >= 0 && oo < ow)
              ? to_f(gy_b[(long long)row * CO + o0 + oo]) : 0.f;
        }
        for (int idx = t; idx < kChunk * kChunk; idx += kThreads) {
          const int ci = idx / kChunk;
          const int oj = idx - ci * kChunk;
          ws[ci][oj] = (ci < cw && oj < ow)
              ? to_f(wk[(long long)(c0 + ci) * CO + o0 + oj]) : 0.f;
        }
        __syncthreads();
        for (int oo = 0; oo < ow; ++oo) {
          float a[4], bv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) a[i] = gs[ty + 32 * i][oo];
#pragma unroll
          for (int j = 0; j < 4; ++j) bv[j] = ws[tx + 8 * j][oo];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] += a[i] * bv[j];
        }
        tile_outer_add(xs, gs, cw, ow, dw_k + o0, CO);
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
      const int c = c0 + tx + 8 * j;
      if (c < C) dx[((long long)b * M + m) * C + c] = from_f<T>(acc[i][j]);
    }
  }
}

template <typename T>
int launch(const void* keys_out, int n_out, const void* gy, int CO,
           const void* feats, int C, const void* rq, int nw, int M,
           const void* rs, int n_tiles, int K, const void* w,
           const void* r_active, int m_bound, int window_r, void* dx,
           void* dw, const int* dkeys, const int* cols, int B, void* stream) {
  if (K > kMaxK) return (int)cudaErrorInvalidValue;
  Offsets offs;
  fill_offsets(offs, dkeys, cols, K);
  const int m_tiles = (M + kTile - 1) / kTile;
  if (m_tiles > 0 && B > 0 && C > 0) {
    dim3 grid(m_tiles, B, (C + kChunk - 1) / kChunk);
    bwd_kernel<T><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const int*)keys_out, n_out, (const T*)gy, CO, (const T*)feats, C,
        (const int*)rq, nw, M, (const int*)rs, n_tiles, K, (const T*)w,
        (const int*)r_active, m_bound, window_r, (T*)dx, (float*)dw, offs);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// keys_out i32[B, n_out] sorted; gy T[B, n_out, CO]; feats T[B, M, C];
// rq i32[B, 1+nw, M]; rs i32[B, n_tiles, K'] (K' >= every cols[k] + 1);
// w T[K, C, CO]; r_active i32[B]; dx T[B, M, C] (fully written);
// dw f32[K, C, CO], ZEROED by the caller (the kernel adds onto it).
// dkeys and cols are HOST arrays of K ints.  Returns the cudaError_t.
#define SEID_BWD_ENTRY(NAME, T)                                               \
  extern "C" int NAME(const void* keys_out, int n_out, const void* gy,        \
                      int CO, const void* feats, int C, const void* rq,       \
                      int nw, int M, const void* rs, int n_tiles, int K,      \
                      const void* w, const void* r_active, int m_bound,       \
                      int window_r, void* dx, void* dw, const int* dkeys,     \
                      const int* cols, int B, void* stream) {                 \
    return launch<T>(keys_out, n_out, gy, CO, feats, C, rq, nw, M, rs,        \
                     n_tiles, K, w, r_active, m_bound, window_r, dx, dw,      \
                     dkeys, cols, B, stream);                                 \
  }

SEID_BWD_ENTRY(seid_window_bwd_f32, float)
SEID_BWD_ENTRY(seid_window_bwd_bf16, __nv_bfloat16)
