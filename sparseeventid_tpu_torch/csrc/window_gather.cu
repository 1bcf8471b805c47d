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
// Bound on the H100: bytes, dominated by the output (B * M * K * C values)
// plus the distinct table rows read; there are no flops.
// Design: one block per (b, 128-query tile), 8 warps.  The tile's
// 128 * K (row, slot) pairs lie in output order, so 32 consecutive pairs
// cover 32 * C consecutive output values.  A warp takes 32 pairs: each lane
// matches one (one binary search per pair, not per value), then the lanes
// walk the 32 * C values together, fetching each value's matched row from
// its pair's lane by a shuffle.  Writes are coalesced for any C and every
// output value is written exactly once, so the output needs no memset.

#include "window_match.cuh"

namespace {

using namespace seid;

template <typename T>
__global__ void __launch_bounds__(kThreads)
gather_kernel(const int* __restrict__ keys, int n_in,
              const T* __restrict__ feats, int C,
              const int* __restrict__ qmeta, int nw, int M,
              const int* __restrict__ start, int n_tiles, int K,
              const int* __restrict__ q_active, int window_r,
              T* __restrict__ out, Offsets offs) {
  __shared__ int s_dkey[kMaxK];
  __shared__ int s_col[kMaxK];
  const int tile = blockIdx.x;
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  constexpr int kWarps = kThreads / 32;
  for (int k = threadIdx.x; k < K; k += kThreads) {
    s_dkey[k] = offs.dkey[k];
    s_col[k] = offs.col[k];
  }
  __syncthreads();

  const long long m0 = (long long)tile * kTile;
  const int rows = (M - m0) < kTile ? (int)(M - m0) : kTile;
  const int pairs = rows * K;
  const bool live = tile < live_tiles(q_active[b], M);  // block-uniform
  const int* meta_b = qmeta + (long long)b * (1 + nw) * M;
  const int* keys_b = keys + (long long)b * n_in;
  const int* start_t = start + ((long long)b * n_tiles + tile) * K;
  const T* feats_b = feats + (long long)b * n_in * C;
  T* out_t = out + ((long long)b * M + m0) * K * C;
  const T zero = from_f<T>(0.f);

  for (int p0 = warp * 32; p0 < pairs; p0 += kWarps * 32) {  // warp-uniform
    const int p = p0 + lane;
    int row = -1;
    if (live && p < pairs) {
      const int r = p / K;
      const int col = s_col[p - r * K];
      const long long mq = m0 + r;
      row = match_row(keys_b, n_in, meta_b, M, mq, meta_b[mq], col,
                      s_dkey[col], start_t[col], window_r);
    }
    const int np = (pairs - p0) < 32 ? (pairs - p0) : 32;
    const int n_el = np * C;
    T* dst = out_t + (long long)p0 * C;
    for (int e0 = 0; e0 < n_el; e0 += 32) {  // every lane joins each shuffle
      const int e = e0 + lane;
      const int j = e < n_el ? e / C : 0;
      const int src = __shfl_sync(0xffffffffu, row, j);
      if (e < n_el)
        dst[e] = src >= 0 ? feats_b[(long long)src * C + (e - j * C)] : zero;
    }
  }
}

template <typename T>
int launch(const void* keys, int n_in, const void* feats, int C,
           const void* qmeta, int nw, int M, const void* start, int n_tiles,
           int K, const void* q_active, int window_r, void* out,
           const int* dkeys, const int* cols, int B, void* stream) {
  if (K > kMaxK) return (int)cudaErrorInvalidValue;
  Offsets offs;
  fill_offsets(offs, dkeys, cols, K);
  const int m_tiles = (M + kTile - 1) / kTile;
  if (m_tiles > 0 && B > 0 && C > 0 && K > 0) {
    dim3 grid(m_tiles, B);
    gather_kernel<T><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const int*)keys, n_in, (const T*)feats, C, (const int*)qmeta, nw, M,
        (const int*)start, n_tiles, K, (const int*)q_active, window_r,
        (T*)out, offs);
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
