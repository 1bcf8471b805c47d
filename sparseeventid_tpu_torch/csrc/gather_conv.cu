// Gather-GEMM sparse convolution over a rulebook:
//   out[b, m, :] = sum_k  feats[b, idx[b, m, k], :] @ W[k]
// where idx holds, per output row and kernel offset, the input row of the
// neighbour, and any value outside [0, N) is a miss that contributes
// nothing.  Accumulation is float32 over k and C; the result is cast once to
// the feature type.
//
// Replaces: sparseeventid_tpu/ops/pallas/gather_conv.py, gather_conv_single
// (Pallas kernel _gather_matmul_kernel), with the batch inside the kernel
// where the JAX package maps it over events.  The TPU kernel appends a zero
// row for misses and does one dot over K * C; here a miss is skipped and
// the offsets are looped, so the two agree bit for bit only where float32
// addition is exact.
//
// Bound on the H100: bytes at the shallow levels (the index array alone is
// B * M * K ints), operations only if the tensor cores were used; this
// first kernel runs float32 FMAs on the CUDA cores, as window_conv.cu does
// after its match, and is far from either bound.
// Design: one block per (b, 128 output rows, 32 output channels), 256
// threads.  Per offset the first 128 threads read their row's index (the
// block skips an offset none of its rows hit); the 128 gathered rows and
// W[k] are staged in shared memory, 32 input channels at a time, and each
// thread accumulates a 4 x 4 register tile.

#include "window_match.cuh"

namespace {

using namespace seid;

constexpr int kCo = kChunk;  // output channels per block
constexpr int kCc = kChunk;  // input channels staged per step

template <typename T>
__global__ void __launch_bounds__(kThreads)
gather_conv_kernel(const T* __restrict__ feats, int N, int C,
                   const int* __restrict__ idx, int M, int K,
                   const T* __restrict__ w, int CO, T* __restrict__ out) {
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
  const T* feats_b = feats + (long long)b * N * C;
  const int* idx_b = idx + (long long)b * M * K;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k = 0; k < K; ++k) {
    if (t < kTile) {
      int row = -1;
      if (m0 + t < M) {
        const int v = idx_b[(m0 + t) * K + k];
        if (v >= 0 && v < N) row = v;
      }
      nbr[t] = row;
    }
    const int any = __syncthreads_or(t < kTile && nbr[t] >= 0);
    if (!any) continue;  // uniform: no row of this tile has a neighbour at k
    const T* wk = w + (long long)k * C * CO;
    for (int c0 = 0; c0 < C; c0 += kCc) {
      const int cw = (C - c0) < kCc ? (C - c0) : kCc;
      for (int i = t; i < kTile * cw; i += kThreads) {
        const int r = i / cw;
        const int cc = i - r * cw;
        const int row = nbr[r];
        xs[r][cc] = row >= 0 ? to_f(feats_b[(long long)row * C + c0 + cc])
                             : 0.f;
      }
      for (int i = t; i < cw * kCo; i += kThreads) {
        const int ci = i / kCo;
        const int oj = i - ci * kCo;
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
int launch(const void* feats, int N, int C, const void* idx, int M, int K,
           const void* w, int CO, void* out, int B, void* stream) {
  const int m_tiles = (M + kTile - 1) / kTile;
  if (m_tiles > 0 && B > 0 && CO > 0) {
    dim3 grid(m_tiles, B, (CO + kCo - 1) / kCo);
    gather_conv_kernel<T><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const T*)feats, N, C, (const int*)idx, M, K, (const T*)w, CO,
        (T*)out);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// feats T[B, N, C]; idx i32[B, M, K] (a value outside [0, N) is a miss);
// w T[K, C, CO]; out T[B, M, CO] (fully written).  Returns the launch's
// cudaError_t.
#define SEID_GATHER_CONV_ENTRY(NAME, T)                                       \
  extern "C" int NAME(const void* feats, int N, int C, const void* idx,       \
                      int M, int K, const void* w, int CO, void* out, int B,  \
                      void* stream) {                                         \
    return launch<T>(feats, N, C, idx, M, K, w, CO, out, B, stream);          \
  }

SEID_GATHER_CONV_ENTRY(seid_gather_conv_f32, float)
SEID_GATHER_CONV_ENTRY(seid_gather_conv_bf16, __nv_bfloat16)
