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
// PRECONDITION: over the walked prefix s < n_bound[b], dst[b, s] is
// non-decreasing, invalid holes included.  Every list of the port comes from
// ops/window/engine._compact_overflow, where the entries are the uncovered
// flat positions pos = row * K + k in ascending order and dst = pos // K,
// so the entries of one output row are contiguous (at most K of them).  A
// list that breaks this gives a row to two blocks, whose unordered updates
// of it race: a builder that reorders lists must sort them by dst first.
//
// Bound on the H100: bytes and latency.  Per entry it reads one table row
// (C values) and W[kk] (C x CO values, L2-resident) and updates one output
// row; the useful bytes of a list are well under a MB (a few hundred ns of
// HBM time), so the launch is latency-bound and the design is about
// parallelism.
// Design: the lists of all events are cut into spans of up to 32 entries
// (fewer where C * CO is large); a grid of (up to 128 per event, B) blocks
// strides over them, and a block whose span starts at or past n_bound[b]
// does nothing.  Each span is aligned to row boundaries: its start moves
// forward to the first entry that begins a new dst row, its end forward
// past the last entry of the row it cuts (two warps find the two).  Each
// output row is then owned by exactly one block: no atomics, and a result
// that does not depend on scheduling.  A block takes its entries kChunk at
// a time: one thread per (entry, output channel) computes the float32
// contributions into shared memory, then one thread per (row run, output
// channel) reads the row once, adds its entries in list order with one
// rounding each, and writes it once.  A run cut by a chunk boundary goes on
// in the next chunk, after a barrier.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 32;       // entries computed together: one warp's lanes
constexpr int kSpanWork = 32 * 32 * 32;  // multiply-adds a span aims at
constexpr int kMaxSpanBlocks = 128;  // blocks per event; they stride over spans
constexpr unsigned kFull = 0xffffffffu;

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

// First s >= s0 (s0 >= 1) that starts a new dst row, or nb: one warp, 32
// entries a step.  Reads no entry at or past nb.
__device__ __forceinline__ int row_start(const int* __restrict__ dst_b, int s0,
                                         int nb, int lane) {
  for (int s = s0;; s += 32) {
    const int e = s + lane;
    const bool edge = e >= nb || dst_b[e] != dst_b[e - 1];
    const unsigned m = __ballot_sync(kFull, edge);
    if (m) return s + __ffs(m) - 1;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
overflow_kernel(T* __restrict__ out, int M, int CO,
                const T* __restrict__ table, int N, int C,
                const T* __restrict__ w, int K,
                const int* __restrict__ src, const int* __restrict__ dst,
                const int* __restrict__ kk, const uint8_t* __restrict__ valid,
                const int* __restrict__ n_bound, int S, int span_len) {
  extern __shared__ float contrib[];  // [kChunk][CO]
  __shared__ int e_src[kChunk], e_dst[kChunk], e_k[kChunk], e_ok[kChunk];
  __shared__ int run_head[kChunk + 1];  // chunk-relative run starts, then n
  __shared__ int n_runs;
  __shared__ int span[2];
  const int b = blockIdx.y;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  int nb = n_bound[b];
  nb = nb < S ? nb : S;
  const long long lb = (long long)b * S;
  const int* dst_b = dst + lb;
  T* out_b = out + (long long)b * M * CO;
  const T* table_b = table + (long long)b * N * C;

  // entries [c0, c0 + 32) below nb into the entry arrays, with their
  // checks, and the starts of their runs of equal dst (warp 0): four
  // independent loads a lane
  auto load_chunk = [&](int c0) {
    const int e = c0 + lane;
    const bool in = e < nb;
    int ok = 0, s_ = 0, d_ = 0, k_ = 0;
    if (in) {
      d_ = dst_b[e];
      s_ = src[lb + e];
      k_ = kk[lb + e];
      ok = valid[lb + e] && s_ >= 0 && s_ < N && d_ >= 0 && d_ < M
           && k_ >= 0 && k_ < K;
    }
    e_ok[lane] = ok;
    e_src[lane] = s_;
    e_dst[lane] = d_;
    e_k[lane] = k_;
    const int prev = __shfl_up_sync(kFull, d_, 1);
    const bool head = in && (lane == 0 || d_ != prev);
    const unsigned hm = __ballot_sync(kFull, head);
    if (head) run_head[__popc(hm & ((1u << lane) - 1u))] = lane;
    if (lane == 0) {
      n_runs = __popc(hm);
      run_head[__popc(hm)] = nb - c0 < kChunk ? nb - c0 : kChunk;
    }
  };

  for (int e0 = blockIdx.x * span_len; e0 < nb; e0 += gridDim.x * span_len) {
    // the span's entries, aligned to row boundaries (block-uniform): warp
    // 0 finds the start and loads the first chunk, warp 1 finds the end
    const int e1 = e0 + span_len < nb ? e0 + span_len : nb;
    if (warp == 0) {
      const int lo = e0 == 0 ? 0 : row_start(dst_b, e0, nb, lane);
      if (lane == 0) span[0] = lo;
      if (lo < e1) load_chunk(lo);
    } else if (warp == 1) {
      const int hi = row_start(dst_b, e1, nb, lane);
      if (lane == 0) span[1] = hi;
    }
    __syncthreads();
    const int lo = span[0], hi = span[1];
    // no row starts in [e0, e1): the rows here belong to an earlier span
    if (lo >= e1) {
      __syncthreads();  // span[] is rewritten by the next span
      continue;
    }
    for (int c0 = lo; c0 < hi; c0 += kChunk) {
      if (c0 != lo) {  // a row that runs on past the first chunk
        if (warp == 0) load_chunk(c0);
        __syncthreads();
      }
      const int n = hi - c0 < kChunk ? hi - c0 : kChunk;
      for (int idx = t; idx < n * CO; idx += kThreads) {
        const int e = idx / CO;
        const int o = idx - e * CO;
        float a = 0.f;
        if (e_ok[e]) {
          const T* x = table_b + (long long)e_src[e] * C;
          const T* wk = w + (long long)e_k[e] * C * CO + o;
          // unrolled so that sixteen (x, w) loads are in flight at a time;
          // the sum keeps its order
#pragma unroll 16
          for (int c = 0; c < C; ++c)
            a += to_f(x[c]) * to_f(wk[(long long)c * CO]);
        }
        contrib[idx] = a;
      }
      __syncthreads();
      // one thread per (run, output channel): the row read once, its
      // entries added in list order with one rounding each, written once
      const int nr = n_runs;
      for (int idx = t; idx < nr * CO; idx += kThreads) {
        const int r = idx / CO;
        const int o = idx - r * CO;
        const int end = run_head[r + 1] < n ? run_head[r + 1] : n;
        T* p = nullptr;
        float v = 0.f;
        for (int e = run_head[r]; e < end; ++e) {
          if (!e_ok[e]) continue;
          if (p == nullptr) {
            p = out_b + (long long)e_dst[e] * CO + o;
            v = to_f(*p);
          }
          v = to_f(from_f<T>(v + contrib[e * CO + o]));
        }
        if (p != nullptr) *p = from_f<T>(v);
      }
      // the next chunk rewrites the entry arrays and may continue a run
      // whose row this chunk wrote
      __syncthreads();
    }
  }
}

template <typename T>
int launch(void* out, int M, int CO, const void* table, int N, int C,
           const void* w, int K, const void* src, const void* dst,
           const void* kk, const void* valid, const void* n_bound, int S,
           int B, void* stream) {
  const size_t smem = sizeof(float) * kChunk * (size_t)CO;
  if (smem > 48 * 1024) {
    int dev = 0, optin = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                           dev);
    // room for the static arrays beside the contributions
    if (smem + 1024 > (size_t)optin) return (int)cudaErrorInvalidValue;
    const cudaError_t err = cudaFuncSetAttribute(
        overflow_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  if (B > 0 && CO > 0 && S > 0) {
    // a chunk of entries a span, fewer where an entry's product is large,
    // so that the blocks share the multiply-adds of the deep levels
    int span_len = kChunk;
    while (span_len > 1 && (long long)span_len * C * CO > kSpanWork)
      span_len >>= 1;
    const int spans = (S + span_len - 1) / span_len;
    dim3 grid(spans < kMaxSpanBlocks ? spans : kMaxSpanBlocks, B);
    overflow_kernel<T><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
        (T*)out, M, CO, (const T*)table, N, C, (const T*)w, K,
        (const int*)src, (const int*)dst, (const int*)kk,
        (const uint8_t*)valid, (const int*)n_bound, S, span_len);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// out T[B, M, CO] (updated in place); table T[B, N, C]; w T[K, C, CO];
// src, dst, kk i32[B, S]; valid u8[B, S] (torch bool); n_bound i32[B]
// entries to walk per batch element, over which dst must be non-decreasing
// (see the top of this file).  Returns the launch's cudaError_t.
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
