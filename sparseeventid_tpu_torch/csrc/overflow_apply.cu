// Overflow sidecar: the exact out-of-window remainder of a windowed conv,
//   out[b, dst[s]] += table[b, src[s]] @ W[kk[s]]
// over the valid entries s < n_bound[b] of the compacted pair list, in list
// order, IN PLACE on the conv output.  Each entry adds its float32
// contribution to the row and rounds to the output type, as a serial walk
// does, so duplicate dst rows accumulate exactly as in the reference.
// Device-built lists can hold invalid entries in the middle of their
// prefix, so validity is checked per entry.
//
// Replaces: sparseeventid_tpu/ops/pallas/window_conv.py, overflow_apply
// (Pallas kernel _ov_apply_kernel) and
// sparseeventid_tpu/ops/pallas/window_sidecar.py, overflow_apply_batched
// (Pallas kernel _ov_apply_v2_kernel): one contract, one kernel.
//
// Bound on the H100: bytes and latency.  Per entry it reads one table row
// (C values) and W[kk] (C x CO values, L2-resident) and updates one output
// row; with a few hundred entries per batch element the useful bytes are
// well under a MB, so the launch is latency-bound.
// Design: one block per batch element.  Entries are taken kChunk at a time:
// the block computes the chunk's contributions in parallel (one thread per
// (entry, output channel), float32 over C) into shared memory, then one
// thread per output channel applies them in list order.  Each output
// column is owned by one thread, so the serial order needs no atomics and
// the result does not depend on scheduling.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 16;

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
overflow_kernel(T* __restrict__ out, int M, int CO,
                const T* __restrict__ table, int N, int C,
                const T* __restrict__ w, int K,
                const int* __restrict__ src, const int* __restrict__ dst,
                const int* __restrict__ kk, const uint8_t* __restrict__ valid,
                const int* __restrict__ n_bound, int S) {
  extern __shared__ float contrib[];  // [kChunk][CO]
  __shared__ int e_src[kChunk], e_dst[kChunk], e_k[kChunk], e_ok[kChunk];
  const int b = blockIdx.x;
  const int t = threadIdx.x;
  int nb = n_bound[b];
  nb = nb < S ? nb : S;
  const long long lb = (long long)b * S;
  T* out_b = out + (long long)b * M * CO;
  const T* table_b = table + (long long)b * N * C;
  for (int e0 = 0; e0 < nb; e0 += kChunk) {
    if (t < kChunk) {
      const int e = e0 + t;
      int ok = 0, s_ = 0, d_ = 0, k_ = 0;
      if (e < nb && valid[lb + e]) {
        s_ = src[lb + e];
        d_ = dst[lb + e];
        k_ = kk[lb + e];
        ok = s_ >= 0 && s_ < N && d_ >= 0 && d_ < M && k_ >= 0 && k_ < K;
      }
      e_ok[t] = ok;
      e_src[t] = s_;
      e_dst[t] = d_;
      e_k[t] = k_;
    }
    __syncthreads();
    for (int idx = t; idx < kChunk * CO; idx += kThreads) {
      const int e = idx / CO;
      const int o = idx - e * CO;
      float a = 0.f;
      if (e_ok[e]) {
        const T* x = table_b + (long long)e_src[e] * C;
        const T* wk = w + (long long)e_k[e] * C * CO + o;
        for (int c = 0; c < C; ++c) a += to_f(x[c]) * to_f(wk[(long long)c * CO]);
      }
      contrib[idx] = a;
    }
    __syncthreads();
    for (int o = t; o < CO; o += kThreads) {
      for (int e = 0; e < kChunk; ++e) {
        if (!e_ok[e]) continue;
        T* p = out_b + (long long)e_dst[e] * CO + o;
        *p = from_f<T>(to_f(*p) + contrib[e * CO + o]);
      }
    }
    __syncthreads();
  }
}

template <typename T>
int launch(void* out, int M, int CO, const void* table, int N, int C,
           const void* w, int K, const void* src, const void* dst,
           const void* kk, const void* valid, const void* n_bound, int S,
           int B, void* stream) {
  const size_t smem = sizeof(float) * kChunk * (size_t)CO;
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  if (B > 0 && CO > 0) {
    overflow_kernel<T><<<B, kThreads, smem, (cudaStream_t)stream>>>(
        (T*)out, M, CO, (const T*)table, N, C, (const T*)w, K,
        (const int*)src, (const int*)dst, (const int*)kk,
        (const uint8_t*)valid, (const int*)n_bound, S);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// out T[B, M, CO] (updated in place); table T[B, N, C]; w T[K, C, CO];
// src, dst, kk i32[B, S]; valid u8[B, S] (torch bool); n_bound i32[B]
// entries to walk per batch element.  Returns the launch's cudaError_t.
#define SEID_OV_ENTRY(NAME, T)                                                \
  extern "C" int NAME(void* out, int M, int CO, const void* table, int N,     \
                      int C, const void* w, int K, const void* src,           \
                      const void* dst, const void* kk, const void* valid,     \
                      const void* n_bound, int S, int B, void* stream) {      \
    return launch<T>(out, M, CO, table, N, C, w, K, src, dst, kk, valid,      \
                     n_bound, S, B, stream);                                  \
  }

SEID_OV_ENTRY(seid_overflow_apply_f32, float)
SEID_OV_ENTRY(seid_overflow_apply_bf16, __nv_bfloat16)
