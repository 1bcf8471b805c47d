// Window plan: the exact 16-aligned window start of every (batch element,
// 128-query tile, kernel offset), plus the mask of queries whose match lies
// outside [start, start + r_conv) and so belongs to the overflow sidecar.
//
// Replaces: sparseeventid_tpu/ops/pallas/window_conv.py, window_plan
// (Pallas kernel _plan_kernel).  The result is bit-equal to it.
//
// What it computes, per (b, tile, k), over the tile's 128 queries q
// (INVALID_QUERY = -2 and out-of-range rows are invalid):
//   bl     = (#anchors keys[a * 128] with anchor <= q) - 1
//   coarse = min over valid queries with bl >= 0 of bl * 128, clamped to
//            [0, min(npad - PLAN_R, align128(max_start))]
//   pos    = lower bound of q inside keys[coarse, coarse + PLAN_R)
//   hit    = keys[pos] == q inside that window;  cov = anchor block of q
//            lies inside the plan window
//   start  = align16(min over valid, covered hits of pos), clamped to
//            coarse + PLAN_R - r_conv, to coarse and to max_start
//            (2^30 is the "no hit" sentinel carried through the clamps)
//   uncov  = valid && bl >= 0 && !(hit && start <= pos < start + r_conv)
//            && (hit || !cov)
// Dead tiles (tile >= ceil(n_active / 128)) give start = 0 and uncov = 0.
//
// Bound on the H100: bytes.  It reads the query keys once (K int32 per
// query) and writes the uncovered mask (K int32 per query); the key table
// and anchors are a few hundred KB per batch element and stay in L2.  Its
// work is two binary searches of <= 9 steps per (query, offset).
// Design: one block per (b, tile), one thread per query, a loop over k.
// The two per-tile minima are warp shuffles plus a 4-entry shared-memory
// reduction; binary searches replace the TPU kernel's [rows x 128]
// compare-and-count, because on this card a gather is cheap.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 128;
constexpr int kAnchor = 128;
constexpr int kPlanR = 384;
constexpr int kAlign = 16;
constexpr int kInvalidKey = 2147483647;
constexpr int kInvalidQuery = -2;
constexpr long long kBig = 1LL << 30;

__device__ __forceinline__ long long block_min(long long v, long long* sh) {
  for (int off = 16; off > 0; off >>= 1) {
    long long o = __shfl_xor_sync(0xffffffffu, v, off);
    v = o < v ? o : v;
  }
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) sh[warp] = v;
  __syncthreads();
  long long r = sh[0];
  for (int w = 1; w < kTile / 32; ++w) r = sh[w] < r ? sh[w] : r;
  __syncthreads();  // sh is reused by the next reduction
  return r;
}

__global__ void __launch_bounds__(kTile)
plan_kernel(const int* __restrict__ keys, int npad,
            const int* __restrict__ qkeys, int n, int K,
            const int* __restrict__ n_active, int n_tiles,
            int* __restrict__ start, int* __restrict__ uncov,
            int r_conv, int max_start) {
  __shared__ long long sh[kTile / 32];
  const int tile = blockIdx.x;
  const int b = blockIdx.y;
  const int t = threadIdx.x;
  const long long m = (long long)tile * kTile + t;
  int live = (n_active[b] + kTile - 1) / kTile;
  live = live < n_tiles ? live : n_tiles;
  int* start_row = start + ((long long)b * n_tiles + tile) * K;
  int* uncov_row = uncov + ((long long)b * n + m) * K;
  if (tile >= live) {  // block-uniform branch
    for (int k = t; k < K; k += kTile) start_row[k] = 0;
    if (m < n)
      for (int k = 0; k < K; ++k) uncov_row[k] = 0;
    return;
  }
  const int* kb = keys + (long long)b * npad;
  const int n_anchor = npad / kAnchor;
  long long coarse_cap = npad - kPlanR;
  const long long ms_aligned = (long long)(max_start / kAnchor) * kAnchor;
  coarse_cap = coarse_cap < ms_aligned ? coarse_cap : ms_aligned;
  const int* qrow = qkeys + ((long long)b * n + m) * K;

  for (int k = 0; k < K; ++k) {
    const int q = m < n ? qrow[k] : kInvalidQuery;
    const bool valid = q >= 0;
    // anchors are non-decreasing with INVALID_KEY last, so
    // "anchor != INVALID_KEY && anchor <= q" holds on a prefix
    int lo = 0, hi = n_anchor;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      const int a = kb[(long long)mid * kAnchor];
      if (a != kInvalidKey && a <= q) lo = mid + 1; else hi = mid;
    }
    const int bl = lo - 1;
    const long long pos_blk = (long long)bl * kAnchor;
    long long coarse = block_min((valid && bl >= 0) ? pos_blk : kBig, sh);
    coarse = coarse < coarse_cap ? coarse : coarse_cap;
    coarse = coarse > 0 ? coarse : 0;
    const bool cov = bl >= 0 && pos_blk >= coarse &&
                     pos_blk + kAnchor <= coarse + kPlanR;
    // pos = coarse + #(window keys < q): the lower bound inside the window
    long long wlo = coarse, whi = coarse + kPlanR;
    while (wlo < whi) {
      const long long mid = (wlo + whi) >> 1;
      if (kb[mid] < q) wlo = mid + 1; else whi = mid;
    }
    const long long pos = wlo;
    const bool hit = pos < coarse + kPlanR && kb[pos] == q;
    const long long live_min =
        block_min((valid && cov && hit) ? pos : kBig, sh);
    long long s = (live_min / kAlign) * kAlign;
    const long long hi_clamp = coarse + kPlanR - r_conv;
    s = s < hi_clamp ? s : hi_clamp;
    s = s > coarse ? s : coarse;
    s = s < (long long)max_start ? s : (long long)max_start;
    const bool inwin = hit && pos >= s && pos < s + r_conv;
    const bool unc = valid && bl >= 0 && !inwin && (hit || !cov);
    if (t == 0) start_row[k] = (int)s;
    if (m < n) uncov_row[k] = unc ? 1 : 0;
  }
}

}  // namespace

// keys: i32[B, npad] (sorted, INVALID_KEY padded, npad = round128(n) + 384
// or more); qkeys: i32[B, n, K]; n_active: i32[B] live rows on the query
// side; start: i32[B, n_tiles, K] out; uncov: i32[B, n, K] out.
// Returns the launch's cudaError_t.
extern "C" int seid_window_plan(const void* keys, int npad, const void* qkeys,
                                int n, int K, const void* n_active,
                                void* start, void* uncov, int B, int n_tiles,
                                int r_conv, int max_start, void* stream) {
  if (n_tiles > 0 && B > 0) {
    dim3 grid(n_tiles, B);
    plan_kernel<<<grid, kTile, 0, (cudaStream_t)stream>>>(
        (const int*)keys, npad, (const int*)qkeys, n, K,
        (const int*)n_active, n_tiles, (int*)start, (int*)uncov, r_conv,
        max_start);
  }
  return (int)cudaGetLastError();
}
