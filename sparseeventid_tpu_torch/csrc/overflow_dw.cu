// Overflow sidecar of the weight gradient: the out-of-window remainder
//   dw[kk[s]] += x[b, src[s]] (outer) gy[b, dst[s]]
// over the valid entries s < n_bound[b] of the compacted pair list of
// every batch element, in float32.  Device-built lists can hold invalid
// entries in the middle of their prefix, so validity is checked per entry.
//
// Replaces: sparseeventid_tpu/ops/pallas/window_sidecar.py,
// overflow_dw_batched (Pallas kernel _ov_dw_v2_kernel) and
// sparseeventid_tpu/ops/pallas/window_conv.py, overflow_dw (Pallas kernel
// _ov_dw_kernel): one contract, one kernel.
//
// Bound on the H100: bytes and latency.  Per entry it reads one x row and
// one gy row; dw is K * C * CO floats.  With tens of thousands of entries
// at most, the useful bytes are a few MB.
// Design: the list of each batch element is cut into chunks of 128 entries
// and a [C, CO] panel of dw into runs of 1024 elements, one block per
// (chunk, b, run), so a long list and a wide conv both spread over the
// card; blocks past n_bound exit at once.  A block sorts its chunk by
// offset (a stable counting sort in shared memory), then for each offset
// present every thread sums its (c, o) elements over that offset's
// entries, in list order, and adds the sum to dw with one float32
// atomicAdd.  The sums inside a block have a fixed order; the atomic sums
// across blocks do not, so dw is bit-reproducible only where float32
// addition is exact.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kEntries = 128;  // list entries per block
constexpr int kRun = 1024;     // (c, o) elements of a dw panel per block
constexpr int kMaxK = 128;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
overflow_dw_kernel(float* __restrict__ dw, int K,
                   const T* __restrict__ x, int N, int C,
                   const T* __restrict__ gy, int M, int CO,
                   const int* __restrict__ src, const int* __restrict__ dst,
                   const int* __restrict__ kk,
                   const uint8_t* __restrict__ valid,
                   const int* __restrict__ n_bound, int S) {
  __shared__ int e_src[kEntries], e_dst[kEntries], e_k[kEntries];
  __shared__ int order[kEntries];
  __shared__ int cnt[kMaxK], off[kMaxK];
  const int b = blockIdx.y;
  const int t = threadIdx.x;
  int nb = n_bound[b];
  nb = nb < S ? nb : S;
  const int e0 = blockIdx.x * kEntries;
  if (e0 >= nb) return;  // block-uniform
  const long long lb = (long long)b * S;
  if (t < K) cnt[t] = 0;
  if (t < kEntries) {
    const int e = e0 + t;
    int k_ = -1, s_ = 0, d_ = 0;
    if (e < nb && valid[lb + e]) {
      s_ = src[lb + e];
      d_ = dst[lb + e];
      const int kv = kk[lb + e];
      if (s_ >= 0 && s_ < N && d_ >= 0 && d_ < M && kv >= 0 && kv < K)
        k_ = kv;
    }
    e_src[t] = s_;
    e_dst[t] = d_;
    e_k[t] = k_;
  }
  __syncthreads();
  if (t < kEntries && e_k[t] >= 0) atomicAdd(&cnt[e_k[t]], 1);
  __syncthreads();
  if (t == 0) {
    int run = 0;
    for (int k = 0; k < K; ++k) {
      off[k] = run;
      run += cnt[k];
    }
  }
  __syncthreads();
  if (t < kEntries && e_k[t] >= 0) {
    int rank = 0;  // earlier entries of the same offset: a stable sort
    for (int e = 0; e < t; ++e) rank += (e_k[e] == e_k[t]);
    order[off[e_k[t]] + rank] = t;
  }
  __syncthreads();
  const T* x_b = x + (long long)b * N * C;
  const T* gy_b = gy + (long long)b * M * CO;
  const int n_out = C * CO;
  const int run0 = blockIdx.z * kRun;
  const int run1 = (run0 + kRun) < n_out ? (run0 + kRun) : n_out;
  for (int k = 0; k < K; ++k) {
    const int n = cnt[k];
    if (n == 0) continue;  // uniform
    const int first = off[k];
    float* dw_k = dw + (long long)k * n_out;
    for (int idx = run0 + t; idx < run1; idx += kThreads) {
      const int ci = idx / CO;
      const int oj = idx - ci * CO;
      float a = 0.f;
      for (int i = 0; i < n; ++i) {
        const int e = order[first + i];
        a += to_f(x_b[(long long)e_src[e] * C + ci])
            * to_f(gy_b[(long long)e_dst[e] * CO + oj]);
      }
      if (a != 0.f) atomicAdd(dw_k + idx, a);
    }
  }
}

template <typename T>
int launch(void* dw, int K, const void* x, int N, int C, const void* gy,
           int M, int CO, const void* src, const void* dst, const void* kk,
           const void* valid, const void* n_bound, int S, int B,
           void* stream) {
  if (K > kMaxK) return (int)cudaErrorInvalidValue;
  const int chunks = (S + kEntries - 1) / kEntries;
  if (B > 0 && chunks > 0 && C > 0 && CO > 0) {
    dim3 grid(chunks, B, (C * CO + kRun - 1) / kRun);
    overflow_dw_kernel<T><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (float*)dw, K, (const T*)x, N, C, (const T*)gy, M, CO,
        (const int*)src, (const int*)dst, (const int*)kk,
        (const uint8_t*)valid, (const int*)n_bound, S);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// dw f32[K, C, CO], ZEROED by the caller (the kernel adds onto it);
// x T[B, N, C]; gy T[B, M, CO]; src, dst, kk i32[B, S]; valid u8[B, S]
// (torch bool); n_bound i32[B] entries to walk per batch element.
// Returns the launch's cudaError_t.
#define SEID_OV_DW_ENTRY(NAME, T)                                             \
  extern "C" int NAME(void* dw, int K, const void* x, int N, int C,           \
                      const void* gy, int M, int CO, const void* src,         \
                      const void* dst, const void* kk, const void* valid,     \
                      const void* n_bound, int S, int B, void* stream) {      \
    return launch<T>(dw, K, x, N, C, gy, M, CO, src, dst, kk, valid,          \
                     n_bound, S, B, stream);                                  \
  }

SEID_OV_DW_ENTRY(seid_overflow_dw_f32, float)
SEID_OV_DW_ENTRY(seid_overflow_dw_bf16, __nv_bfloat16)
