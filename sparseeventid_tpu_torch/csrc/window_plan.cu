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
// and anchors are a few hundred KB per batch element and stay in L2.  What
// a simple kernel is bound by instead is the latency of its searches: one
// thread per query walking the K offsets in turn is a chain of 2K
// dependent binary searches in device memory and 2K block-wide minima.
// Design: one block of 8 warps per (b, tile, group of G offsets), G set by
// the wrapper (kernels._plan_group) so that the small levels still spread
// over the card.  The offsets are independent, so a warp owns one offset
// at a time, for all 128 queries of the tile (4 a lane), and both per-tile
// minima are warp reductions: no block barrier inside the offset loop.
// The anchor pass takes one search a warp, not one a query: bl is
// non-decreasing in q, so coarse is bl of the smallest candidate, and a
// query's cov is one compare with the anchor after the plan window.  The
// window pass copies the 384 keys from coarse to the warp's shared memory
// and finds the four lower bounds there by binary lifting, interleaved.
// The block stages the event's anchors and, with coalesced loads, the
// tile's [128, G] block of query keys, and writes uncov back through the
// same buffer.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 128;
constexpr int kAnchor = 128;
constexpr int kPlanR = 384;
constexpr int kAlign = 16;
constexpr int kInvalidKey = 2147483647;
constexpr int kInvalidQuery = -2;
constexpr int kBig = 1 << 30;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kQ = kTile / 32;  // queries a lane owns
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxGroup = 32;   // offsets a block takes, at most

__device__ __forceinline__ int warp_min(int v) {
  return __reduce_min_sync(kFull, v);
}

// "anchor != INVALID_KEY && anchor <= q": it holds on a prefix of the
// anchors (non-decreasing, INVALID_KEY last), whose length less one is bl.
__device__ __forceinline__ bool below(int anchor, int q) {
  return anchor != kInvalidKey && anchor <= q;
}

// Shared memory: the anchors, then the query block [kTile][G + 1] (an odd
// pitch: a warp reading one column touches 32 banks), then each warp's
// plan window.
__global__ void __launch_bounds__(kThreads)
plan_kernel(const int* __restrict__ keys, int npad,
            const int* __restrict__ qkeys, int n, int K, int G,
            const int* __restrict__ n_active, int n_tiles,
            int* __restrict__ start, int* __restrict__ uncov,
            int r_conv, int max_start) {
  extern __shared__ int smem[];
  const int n_anchor = npad / kAnchor;
  const int pitch = G + 1;
  int* anchors = smem;
  int* qs = anchors + n_anchor;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  int* win = qs + kTile * pitch + warp * kPlanR;

  const int k0 = blockIdx.x * G;
  const int tile = blockIdx.y;
  const int b = blockIdx.z;
  const int gw = (K - k0) < G ? (K - k0) : G;  // offsets of this block
  const long long m0 = (long long)tile * kTile;
  const int rows = (n - m0) < kTile ? (int)(n - m0) : kTile;
  int live = (n_active[b] + kTile - 1) / kTile;
  live = live < n_tiles ? live : n_tiles;
  int* start_row = start + ((long long)b * n_tiles + tile) * K + k0;
  int* uncov_tile = uncov + ((long long)b * n + m0) * K + k0;
  if (tile >= live) {  // block-uniform branch
    for (int j = t; j < gw; j += kThreads) start_row[j] = 0;
    for (int idx = t; idx < rows * gw; idx += kThreads) {
      const int r = idx / gw;
      uncov_tile[(long long)r * K + idx - r * gw] = 0;
    }
    return;
  }
  const int* kb = keys + (long long)b * npad;
  for (int a = t; a < n_anchor; a += kThreads) anchors[a] = kb[(long long)a * kAnchor];
  // the tile's query keys: each row's gw offsets are contiguous in memory
  const int* q_tile = qkeys + ((long long)b * n + m0) * K + k0;
  for (int idx = t; idx < kTile * gw; idx += kThreads) {
    const int r = idx / gw;
    const int j = idx - r * gw;
    qs[r * pitch + j] = r < rows ? q_tile[(long long)r * K + j] : kInvalidQuery;
  }
  __syncthreads();

  const int coarse_cap = min(npad - kPlanR, (max_start / kAnchor) * kAnchor);
  const int a_step0 = 1 << (31 - __clz(n_anchor));
  const int a0 = anchors[0];
  for (int j = warp; j < gw; j += kWarps) {
    int q[kQ];
    bool valid[kQ];
    int qmin = kInvalidKey;
    bool any = false;
#pragma unroll
    for (int i = 0; i < kQ; ++i) {
      q[i] = qs[(lane + 32 * i) * pitch + j];
      // valid with bl >= 0: a candidate of the coarse minimum
      valid[i] = q[i] >= 0 && below(a0, q[i]);
      if (valid[i]) qmin = min(qmin, q[i]);
      any |= valid[i];
    }
    // bl is non-decreasing in q, so the minimum of bl over the candidates
    // is bl(smallest candidate): one search, the same for every lane
    qmin = warp_min(qmin);
    int coarse = kBig;
    if (__any_sync(kFull, any)) {
      int cnt = 0;
      for (int step = a_step0; step > 0; step >>= 1)
        if (cnt + step <= n_anchor && below(anchors[cnt + step - 1], qmin))
          cnt += step;
      coarse = (cnt - 1) * kAnchor;
    }
    coarse = min(coarse, coarse_cap);
    coarse = max(coarse, 0);
    // cov: bl >= 0 and bl * 128 in [coarse, coarse + PLAN_R - 128].  The
    // lower end holds for every candidate (coarse <= the minimum); the
    // upper end is bl <= coarse / 128 + 2, i.e. the anchor after that
    // block is not below q.
    const int ca = coarse / kAnchor + kPlanR / kAnchor;
    const int a_hi = ca < n_anchor ? anchors[ca] : kInvalidKey;
    __syncwarp();  // the previous offset's window is read
#pragma unroll
    for (int i = lane; i < kPlanR; i += 32) win[i] = kb[coarse + i];
    __syncwarp();
    // pos - coarse = #(window keys < q), by binary lifting over 384 keys
    int lo[kQ];
#pragma unroll
    for (int i = 0; i < kQ; ++i) lo[i] = 0;
#pragma unroll
    for (int step = 256; step > 0; step >>= 1) {
#pragma unroll
      for (int i = 0; i < kQ; ++i)
        if (lo[i] + step <= kPlanR && win[lo[i] + step - 1] < q[i]) lo[i] += step;
    }
    bool hit[kQ], cov[kQ];
    int live_cand = kBig;
#pragma unroll
    for (int i = 0; i < kQ; ++i) {
      hit[i] = lo[i] < kPlanR && win[lo[i]] == q[i];
      cov[i] = valid[i] && !below(a_hi, q[i]);
      if (cov[i] && hit[i]) live_cand = min(live_cand, coarse + lo[i]);
    }
    const int live_min = warp_min(live_cand);
    int s = (live_min / kAlign) * kAlign;
    s = min(s, coarse + kPlanR - r_conv);
    s = max(s, coarse);
    s = min(s, max_start);
#pragma unroll
    for (int i = 0; i < kQ; ++i) {
      const int pos = coarse + lo[i];
      const bool inwin = hit[i] && pos >= s && pos < s + r_conv;
      const bool unc = valid[i] && !inwin && (hit[i] || !cov[i]);
      qs[(lane + 32 * i) * pitch + j] = unc ? 1 : 0;  // this warp's column
    }
    if (lane == 0) start_row[j] = s;
  }
  __syncthreads();
  for (int idx = t; idx < rows * gw; idx += kThreads) {
    const int r = idx / gw;
    const int j = idx - r * gw;
    uncov_tile[(long long)r * K + j] = qs[r * pitch + j];
  }
}

}  // namespace

// keys: i32[B, npad] (sorted, INVALID_KEY padded, npad = round128(n) + 384
// or more); qkeys: i32[B, n, K]; n_active: i32[B] live rows on the query
// side; start: i32[B, n_tiles, K] out; uncov: i32[B, n, K] out; G: offsets
// a block takes (1..32).  Returns the launch's cudaError_t.
extern "C" int seid_window_plan(const void* keys, int npad, const void* qkeys,
                                int n, int K, const void* n_active,
                                void* start, void* uncov, int B, int n_tiles,
                                int r_conv, int max_start, int G,
                                void* stream) {
  if (G < 1 || G > kMaxGroup || npad % kAnchor || npad < kPlanR)
    return (int)cudaErrorInvalidValue;
  if (n_tiles <= 0 || B <= 0 || K <= 0) return (int)cudaGetLastError();
  const size_t smem = sizeof(int) * ((size_t)(npad / kAnchor)
      + (size_t)kTile * (G + 1) + (size_t)kWarps * kPlanR);
  if (smem > 48 * 1024) {
    int dev = 0, optin = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (smem > (size_t)optin) return (int)cudaErrorInvalidValue;
    const cudaError_t err = cudaFuncSetAttribute(
        plan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((K + G - 1) / G, n_tiles, B);
  plan_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const int*)keys, npad, (const int*)qkeys, n, K, G,
      (const int*)n_active, n_tiles, (int*)start, (int*)uncov, r_conv,
      max_start);
  return (int)cudaGetLastError();
}
