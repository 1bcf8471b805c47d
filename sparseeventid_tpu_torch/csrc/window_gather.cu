// Windowed gather: the neighbour matrix of a plan,
//   g[b, m, k * C : (k + 1) * C] = feats[b, row(b, m, k), :]   (else 0)
// where row(b, m, k) is the table row matched by query row m at query column
// k' = kmap[k] inside the plan window [start[b, m / 128, k'], + window_r)
// (window_match.cuh: the same pair set as the forward conv, the fused
// backward and window_dw, so the plan's overflow list stays its complement).
// Unmatched slots, and every row of a tile at or past ceil(q_active / 128),
// are 0.  The kernel copies rows and does no arithmetic, so it is bit-equal
// to its plain version on any data.
//
// Replaces: sparseeventid_tpu/ops/pallas/window_conv.py, window_gather
// (Pallas kernel _gather_kernel).  It is the first half of the two-step dW
// (gather, then one float32 product outside the kernel).
//
// Bound on the H100: bytes, dominated by the output (B * M * K * C values,
// 0.4-0.7 GB at the deconv's and the level-0 series' shapes, against a
// 50 MB L2), plus the distinct table rows read; there are no flops.
// Design: one block of 8 warps per (event, 128-query tile).  A live tile
// is matched once, all K slots, by window_tc.cuh's stage_queries and
// search_slots (each warp copies its slots' plan windows to shared memory
// with cp.async and searches them there, 32 queries a lane-step:
// match_row's pair set), leaving a 16-bit window position per (slot,
// query); a dead tile skips the search.  The tile's output is one
// contiguous span of 128 * K * C values, copied in units: where
// C * sizeof(T) is a multiple of 16 bytes a unit is 16 bytes, inside one
// (row, slot), so consecutive threads load 16 bytes of the matched row (or
// take zeros) and store 16 bytes to consecutive addresses, 512 bytes a warp
// instruction, with a streaming store (st.global.cs: the output does not
// fit the L2, the table rows it re-reads do); other C take one value a
// unit.  A thread walks its units a block stride apart, stepping its
// (piece, slot, row) by additions (no division per unit), with four loads
// in flight before their stores.  Every output value is written exactly
// once, so the output needs no memset.

#include "window_tc.cuh"

namespace {

using namespace seid;

constexpr int kPosPitch = kTile + 2;  // shorts: the slots of one query lie
                                      // in distinct banks
constexpr int kBatch = 4;             // units a thread has in flight

__device__ __forceinline__ uint4 load_unit(const uint4* p) { return __ldg(p); }
__device__ __forceinline__ float load_unit(const float* p) { return __ldg(p); }
__device__ __forceinline__ __nv_bfloat16 load_unit(const __nv_bfloat16* p) {
  return *p;
}
__device__ __forceinline__ void store_unit(uint4* p, uint4 v) { __stcs(p, v); }
template <typename U>
__device__ __forceinline__ void store_unit(U* p, U v) { *p = v; }
template <typename U> __device__ __forceinline__ U zero_unit();
template <> __device__ __forceinline__ uint4 zero_unit<uint4>() {
  return make_uint4(0u, 0u, 0u, 0u);
}
template <> __device__ __forceinline__ float zero_unit<float>() { return 0.f; }
template <> __device__ __forceinline__ __nv_bfloat16 zero_unit<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

// The tile's output span dst[0 .. total) in units of U, upc a (row, slot):
// unit u is piece j = u % upc of pair p = u / upc, i.e. of query row
// r = p / K at slot k = p % K, and comes from table row
// max(st[k], 0) + pos[k * kPosPitch + r] of src (rows of upc units), or is
// 0 where that position is -1 or the tile is not live.
template <typename U>
__device__ __forceinline__ void copy_span(const U* __restrict__ src, int upc,
                                          U* __restrict__ dst, int total,
                                          int K, const short* pos,
                                          const int* st, bool live) {
  const int t = threadIdx.x;
  int j = t % upc;
  int r = t / upc;
  int k = r % K;
  r /= K;
  // a step of kThreads units: dp pairs and dj pieces, dp = dr rows + dk slots
  const int dp = kThreads / upc;
  const int dj = kThreads - dp * upc;
  const int dr = dp / K;
  const int dk = dp - dr * K;
  const U zero = zero_unit<U>();
  for (int u0 = t; u0 < total; u0 += kBatch * kThreads) {
    U v[kBatch];
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      long long row = -1;
      if (live && u0 + q * kThreads < total) {
        const int p = pos[k * kPosPitch + r];
        if (p >= 0) row = (long long)max(st[k], 0) + p;
      }
      v[q] = row >= 0 ? load_unit(src + row * upc + j) : zero;
      j += dj;
      k += dk;
      r += dr;
      if (j >= upc) { j -= upc; ++k; }
      if (k >= K) { k -= K; ++r; }
    }
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      const int u = u0 + q * kThreads;
      if (u < total) store_unit(dst + u, v[q]);
    }
  }
}

// Shared memory: the warps' window buffers, the window positions
// [K][kPosPitch], the ballots, the query meta and the window starts.
__host__ __device__ inline size_t gather_smem(int K, int nw, int window_r) {
  return sizeof(int) * (size_t)kWarps * kWinBufs * window_r
      + sizeof(short) * (size_t)K * kPosPitch
      + sizeof(int) * ((size_t)K * kQ + (size_t)(1 + nw) * kTile + K);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 4)
gather_kernel(const int* __restrict__ keys, int n_in,
              const T* __restrict__ feats, int C,
              const int* __restrict__ qmeta, int nw, int M,
              const int* __restrict__ start, int n_tiles, int K,
              const int* __restrict__ q_active, int window_r,
              T* __restrict__ out, Offsets offs, bool vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int* wbuf = reinterpret_cast<int*>(smem_raw);
  short* pos = reinterpret_cast<short*>(wbuf + kWarps * kWinBufs * window_r);
  unsigned* hits = reinterpret_cast<unsigned*>(pos + K * kPosPitch);
  int* qm = reinterpret_cast<int*>(hits + K * kQ);
  int* st = qm + (1 + nw) * kTile;
  const int tile = blockIdx.x;
  const int b = blockIdx.y;
  const long long m0 = (long long)tile * kTile;
  const int rows = (int)min((long long)kTile, M - m0);
  const bool live = tile < live_tiles(q_active[b], M);  // block-uniform
  if (live) {
    stage_queries(qmeta + (long long)b * (1 + nw) * M, nw, M, m0, M,
                  start + ((long long)b * n_tiles + tile) * K, offs, 0, K, qm,
                  st);
    __syncthreads();
    search_slots(keys + (long long)b * n_in, n_in, qm, st, offs, 0, K,
                 window_r, wbuf, pos, kPosPitch, hits);
    __syncthreads();
  }
  const T* feats_b = feats + (long long)b * n_in * C;
  T* out_t = out + ((long long)b * M + m0) * K * C;
  if (vec) {  // C * sizeof(T) % 16 == 0, 16-byte aligned bases
    const int upc = C * (int)sizeof(T) / 16;
    copy_span(reinterpret_cast<const uint4*>(feats_b), upc,
              reinterpret_cast<uint4*>(out_t), rows * K * upc, K, pos, st,
              live);
  } else {
    copy_span(feats_b, C, out_t, rows * K * C, K, pos, st, live);
  }
}

template <typename T>
int launch(const void* keys, int n_in, const void* feats, int C,
           const void* qmeta, int nw, int M, const void* start, int n_tiles,
           int K, const void* q_active, int window_r, void* out,
           const int* dkeys, const int* cols, int B, void* stream) {
  if (K > kMaxK || window_r < 0 || window_r > 32767)
    return (int)cudaErrorInvalidValue;
  Offsets offs;
  fill_offsets(offs, dkeys, cols, K);
  const int m_tiles = (M + kTile - 1) / kTile;
  if (m_tiles > 0 && B > 0 && C > 0 && K > 0) {
    const size_t smem = gather_smem(K, nw, window_r);
    const cudaError_t err = fit_smem(gather_kernel<T>, smem);
    if (err != cudaSuccess) return (int)err;
    const bool vec = (C * sizeof(T)) % 16 == 0
        && ((uintptr_t)feats & 15) == 0 && ((uintptr_t)out & 15) == 0;
    gather_kernel<T><<<dim3(m_tiles, B), kThreads, smem,
                       (cudaStream_t)stream>>>(
        (const int*)keys, n_in, (const T*)feats, C, (const int*)qmeta, nw, M,
        (const int*)start, n_tiles, K, (const int*)q_active, window_r,
        (T*)out, offs, vec);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// keys i32[B, n_in] sorted; feats T[B, n_in, C]; qmeta i32[B, 1+nw, M];
// start i32[B, n_tiles, K'] (K' >= every cols[k] + 1); q_active i32[B];
// out T[B, M, K * C] (fully written).  dkeys is a HOST array indexed by
// query column (K' ints), cols a HOST array of K ints.  Returns the
// launch's cudaError_t.
#define SEID_GATHER_ENTRY(NAME, T)                                            \
  extern "C" int NAME(const void* keys, int n_in, const void* feats, int C,   \
                      const void* qmeta, int nw, int M, const void* start,    \
                      int n_tiles, int K, const void* q_active,               \
                      int window_r, void* out, const int* dkeys,              \
                      const int* cols, int B, void* stream) {                 \
    return launch<T>(keys, n_in, feats, C, qmeta, nw, M, start, n_tiles, K,   \
                     q_active, window_r, out, dkeys, cols, B, stream);        \
  }

SEID_GATHER_ENTRY(seid_window_gather_f32, float)
SEID_GATHER_ENTRY(seid_window_gather_bf16, __nv_bfloat16)
