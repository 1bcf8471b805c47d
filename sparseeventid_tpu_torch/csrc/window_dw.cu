// Windowed sparse convolution, weight gradient over the in-window pairs of
// a plan:
//   dw[k, c, o] += sum_b sum_t feats[b, n(b, t, k), c] * gy[b, t, o]
// where n(b, t, k) is the table row matched by query row t at query column
// k' = kmap[k] inside the plan window (window_match.cuh: the same pair set
// as the forward conv, whose complement is the plan's overflow list).
// Dead tiles and rows at or past m_bound add nothing.
//
// Replaces: sparseeventid_tpu/ops/pallas/window_conv.py, window_dw (Pallas
// kernel _dw_kernel).
//
// Bound on the H100: bytes (keys, table, query meta and gy read once; dw is
// K * C * CO floats).  On the main path it serves the initial 5^3 conv
// (K = 125, C = 1, CO = 32): dw is 4000 floats, the products are few, and
// the work is the 125 window searches per query, so the kernel is bound by
// the matching's latency.
// Design: the live query tiles of all events are shared out among n_parts
// persistent blocks (block p takes tiles p, p + n_parts, ...); each block
// sums its tiles on chip and writes its partial dW once, to row p of a
// float32 scratch [n_parts, K * C * CO]; a second pass adds the rows up in
// order p = 0, 1, ... per element.  No atomics anywhere, so dw is the same
// bit for bit from run to run for a given n_parts.
// The searches dominate, and a search that walks device memory is a chain
// of dependent L2 loads (the 125 windows of a tile do not stay in L1), so
// each (tile, offset) window's keys are first copied to shared memory with
// coalesced loads and searched there (find_keys_staged: the pair set
// of match_row), a lane's searches interleaved.
//   C == 1, CO <= 32 (dw_c1_kernel): each warp owns the offsets k = warp,
//   warp + 8, ...  and each lane the output channel o = lane, with its
//   partial dw[k, 0, o] in registers.  Per tile the block stages the
//   tile's gy rows and query meta in shared memory once; per offset the
//   warp copies its window's keys and feats values, then per group of 32
//   queries the lanes search, a ballot names the matched ones and a
//   shuffle hands each matched value to every lane, which adds value *
//   gy[query, o].  No block barrier per offset, no staging of unused
//   channels.
//   Otherwise (dw_tile_kernel): a block owns one (k, 32-channel, 32-output)
//   piece of dw and keeps it in registers over its tiles: per tile it
//   copies the window, matches the 128 queries for its offset, compacts
//   the matched ones (a strided plan matches a query at one offset of K),
//   stages their table rows and gy rows (32 channels each) and adds their
//   outer product (tile_outer_acc over the matched rows only).
// Four blocks an SM (launch bounds) is what the wrapper's n_parts assumes.

#include "window_match.cuh"

namespace {

using namespace seid;

constexpr int kWarps = kThreads / 32;
constexpr int kSlots = kMaxK / kWarps;  // offsets a warp owns, at most
constexpr int kGroups = kTile / 32;     // queries a lane takes in a tile
constexpr unsigned kFull = 0xffffffffu;

// The live query tiles of all events, numbered in event order: their
// count, and the (event, tile) of number g.  B is a batch, so a scan of it
// per tile is cheap; sharing out live tiles (not all tiles) keeps the
// blocks' loads even.
__device__ __forceinline__ int event_tiles(const int* q_active, int b,
                                           int m_bound, int m_tiles) {
  const int n = live_tiles(q_active[b], m_bound);
  return n < m_tiles ? n : m_tiles;
}

__device__ __forceinline__ int count_live(const int* q_active, int B,
                                          int m_bound, int m_tiles) {
  int n = 0;
  for (int b = 0; b < B; ++b) n += event_tiles(q_active, b, m_bound, m_tiles);
  return n;
}

__device__ __forceinline__ void live_tile(const int* q_active, int m_bound,
                                          int m_tiles, int g, int& b,
                                          int& tile) {
  b = 0;
  for (int n; g >= (n = event_tiles(q_active, b, m_bound, m_tiles)); ++b)
    g -= n;
  tile = g;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 4)
dw_c1_kernel(const int* __restrict__ keys, int n_in,
             const T* __restrict__ feats,
             const int* __restrict__ qmeta, int nw, int M,
             const int* __restrict__ start, int n_tiles, int K,
             const T* __restrict__ gy, int CO,
             const int* __restrict__ q_active, int m_bound, int window_r,
             float* __restrict__ part, Offsets offs, int B) {
  extern __shared__ float smem[];
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  // the tile's gy rows; its query meta (base, then the validity words; 0
  // for rows past M or m_bound); each warp's copy of one plan window
  float (*gs)[32] = reinterpret_cast<float (*)[32]>(smem);
  int* qm = reinterpret_cast<int*>(smem + kTile * 32);
  int* wkey = qm + (1 + nw) * kTile + warp * window_r;
  float* wx = reinterpret_cast<float*>(qm + (1 + nw) * kTile
                                       + kWarps * window_r) + warp * window_r;
  const int m_tiles = (M + kTile - 1) / kTile;
  float acc[kSlots];  // dw[warp + kWarps * i, 0, lane]
#pragma unroll
  for (int i = 0; i < kSlots; ++i) acc[i] = 0.f;

  const int n_live = count_live(q_active, B, m_bound, m_tiles);
  for (int g = blockIdx.x; g < n_live; g += gridDim.x) {
    int b, tile;
    live_tile(q_active, m_bound, m_tiles, g, b, tile);
    const long long m0 = (long long)tile * kTile;
    const int* meta_b = qmeta + (long long)b * (1 + nw) * M;
    __syncthreads();  // the previous tile's gs and qm are read
    for (int idx = t; idx < kTile * 32; idx += kThreads) {
      const int r = idx / 32;
      const int o = idx - r * 32;
      const long long m = m0 + r;
      gs[r][o] = (o < CO && m < M && m < m_bound)
          ? to_f(gy[((long long)b * M + m) * CO + o]) : 0.f;
    }
    for (int idx = t; idx < (1 + nw) * kTile; idx += kThreads) {
      const int w = idx / kTile;
      const long long m = m0 + (idx - w * kTile);
      qm[idx] = (m < M && m < m_bound) ? meta_b[(long long)w * M + m] : 0;
    }
    __syncthreads();
    const int* keys_b = keys + (long long)b * n_in;
    const int* start_t = start + ((long long)b * n_tiles + tile) * K;
    const T* feats_b = feats + (long long)b * n_in;
#pragma unroll
    for (int i = 0; i < kSlots; ++i) {
      const int k = warp + kWarps * i;
      if (k >= K) break;  // warp-uniform
      const int col = offs.col[k];
      long long lo, end;
      window_rows(start_t[col], window_r, n_in, lo, end);
      const int n_win = end > lo ? (int)(end - lo) : 0;
      __syncwarp();  // the previous offset's window is read
      for (int j = lane; j < n_win; j += 32) {
        wkey[j] = keys_b[lo + j];
        wx[j] = to_f(feats_b[lo + j]);
      }
      __syncwarp();
      // the lane's four queries (rows lane, lane + 32, ...) searched together
      const int* bits = qm + (1 + (col >> 5)) * kTile;
      const long long dkey = offs.dkey[col];
      long long q[kGroups];
      int pos[kGroups];
#pragma unroll
      for (int gq = 0; gq < kGroups; ++gq)
        q[gq] = (long long)qm[32 * gq + lane] + dkey;
      find_keys_staged(wkey, n_win, q, pos);
#pragma unroll
      for (int gq = 0; gq < kGroups; ++gq) {
        if (!((bits[32 * gq + lane] >> (col & 31)) & 1)) pos[gq] = -1;
        const float x = pos[gq] >= 0 ? wx[pos[gq]] : 0.f;
        for (unsigned hit = __ballot_sync(kFull, pos[gq] >= 0); hit;
             hit &= hit - 1) {
          const int qr = __ffs(hit) - 1;
          acc[i] += __shfl_sync(kFull, x, qr) * gs[32 * gq + qr][lane];
        }
      }
    }
  }
  float* part_p = part + (long long)blockIdx.x * K * CO;
#pragma unroll
  for (int i = 0; i < kSlots; ++i) {
    const int k = warp + kWarps * i;
    if (k >= K) break;
    if (lane < CO) part_p[(long long)k * CO + lane] = acc[i];
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 4)
dw_tile_kernel(const int* __restrict__ keys, int n_in,
               const T* __restrict__ feats, int C,
               const int* __restrict__ qmeta, int nw, int M,
               const int* __restrict__ start, int n_tiles, int K,
               const T* __restrict__ gy, int CO,
               const int* __restrict__ q_active, int m_bound, int window_r,
               float* __restrict__ part, Offsets offs, int B) {
  extern __shared__ int wkey[];  // the tile's plan window, window_r keys
  __shared__ int m_row[kTile];     // the matched queries, compacted in order:
  __shared__ int m_query[kTile];   // table row and query row in the tile
  __shared__ int w_count[kTile / 32];
  __shared__ float xg[kTile][kChunk + 1];  // their table rows, c0..c0+32
  __shared__ float gs[kTile][kChunk + 1];  // their gy rows, o0..o0+32
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int m_tiles = (M + kTile - 1) / kTile;
  // this block's piece of dw: offset k, channels c0.., outputs o0..
  const int n_c = (C + kChunk - 1) / kChunk;
  const int n_o = (CO + kChunk - 1) / kChunk;
  const int k = blockIdx.y / (n_c * n_o);
  const int c0 = (blockIdx.y / n_o - k * n_c) * kChunk;
  const int o0 = (blockIdx.y % n_o) * kChunk;
  const int cw = (C - c0) < kChunk ? (C - c0) : kChunk;
  const int ow = (CO - o0) < kChunk ? (CO - o0) : kChunk;
  const int col = offs.col[k];
  const long long dkey = offs.dkey[col];
  const OuterTile ot;
  float s[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;

  const int n_live = count_live(q_active, B, m_bound, m_tiles);
  for (int g = blockIdx.x; g < n_live; g += gridDim.x) {
    int b, tile;
    live_tile(q_active, m_bound, m_tiles, g, b, tile);
    const long long m0 = (long long)tile * kTile;
    const int* meta_b = qmeta + (long long)b * (1 + nw) * M;
    // the window's keys and each query's key and validity bit: independent
    // loads before one barrier
    long long lo, end;
    window_rows(start[((long long)b * n_tiles + tile) * K + col], window_r,
                n_in, lo, end);
    const int n_win = end > lo ? (int)(end - lo) : 0;
    for (int j = t; j < n_win; j += kThreads)
      wkey[j] = keys[(long long)b * n_in + lo + j];
    bool live = false;
    long long q = 0;
    const long long mq = m0 + t;
    if (t < kTile && mq < M && mq < m_bound) {
      live = (meta_b[(long long)(1 + (col >> 5)) * M + mq] >> (col & 31)) & 1;
      q = (long long)meta_b[mq] + dkey;
    }
    __syncthreads();
    const long long qs[1] = {q};
    int found[1];
    find_keys_staged(wkey, n_win, qs, found);
    const int pos = live ? found[0] : -1;
    // compact the matched queries (a block-wide prefix count): the product
    // below runs over them only
    const unsigned hit = __ballot_sync(0xffffffffu, pos >= 0);
    if (lane == 0 && warp < kTile / 32) w_count[warp] = __popc(hit);
    __syncthreads();
    int before = 0, n_m = 0;
#pragma unroll
    for (int w = 0; w < kTile / 32; ++w) {
      before += w < warp ? w_count[w] : 0;
      n_m += w_count[w];
    }
    if (n_m == 0) continue;  // block-uniform
    if (pos >= 0) {
      const int i = before + __popc(hit & ((1u << lane) - 1u));
      m_row[i] = (int)(lo + pos);
      m_query[i] = t;
    }
    __syncthreads();
    const T* feats_b = feats + (long long)b * n_in * C;
    for (int idx = t; idx < n_m * kChunk; idx += kThreads) {
      const int i = idx / kChunk;
      const int cc = idx - i * kChunk;
      xg[i][cc] = cc < cw
          ? to_f(feats_b[(long long)m_row[i] * C + c0 + cc]) : 0.f;
      gs[i][cc] = cc < ow
          ? to_f(gy[((long long)b * M + m0 + m_query[i]) * CO + o0 + cc]) : 0.f;
    }
    __syncthreads();
    tile_outer_acc(ot, xg, gs, cw, n_m, s);
    __syncthreads();  // the shared arrays are rewritten by the next tile
  }
  if (ot.ci0 >= cw) return;  // warp-uniform: no rows of dw here
  tile_outer_reduce(s);
  if (ot.grp != 0) return;
  float* part_p = part + (long long)blockIdx.x * K * C * CO;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (ot.ci0 + i < cw && ot.oj0 + j < ow)
        part_p[((long long)k * C + c0 + ot.ci0 + i) * CO + o0 + ot.oj0 + j] =
            s[i][j];
}

// dw[e] += sum over p = 0, 1, ... of part[p, e]: the fixed-order reduction
// of the blocks' partials.
__global__ void dw_reduce_kernel(float* __restrict__ dw,
                                 const float* __restrict__ part, int n_parts,
                                 long long n) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float sum = 0.f;
  for (int p = 0; p < n_parts; ++p) sum += part[(long long)p * n + e];
  dw[e] += sum;
}

// Opt a kernel in to `smem` bytes of dynamic shared memory beside `fixed`
// static bytes; an error where the card has not that much.
template <typename F>
cudaError_t fit_smem(F* kernel, size_t smem, size_t fixed) {
  if (smem + fixed <= 48 * 1024) return cudaSuccess;
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (smem + fixed > (size_t)optin) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <typename T>
int launch(const void* keys, int n_in, const void* feats, int C,
           const void* qmeta, int nw, int M, const void* start, int n_tiles,
           int K, const void* gy, int CO, const void* q_active, int m_bound,
           int window_r, void* dw, const int* dkeys, const int* cols, int B,
           void* part, int n_parts, void* stream) {
  if (K > kMaxK || n_parts < 1 || window_r < 0) return (int)cudaErrorInvalidValue;
  Offsets offs;
  fill_offsets(offs, dkeys, cols, K);
  const long long n = (long long)K * C * CO;
  if (M <= 0 || B <= 0 || n <= 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  if (C == 1 && CO <= 32) {
    const size_t smem = sizeof(float) * ((size_t)kTile * 32
        + (size_t)(1 + nw) * kTile + 2 * (size_t)kWarps * window_r);
    err = fit_smem(dw_c1_kernel<T>, smem, 0);
    if (err != cudaSuccess) return (int)err;
    dw_c1_kernel<T><<<n_parts, kThreads, smem, st>>>(
        (const int*)keys, n_in, (const T*)feats, (const int*)qmeta, nw, M,
        (const int*)start, n_tiles, K, (const T*)gy, CO, (const int*)q_active,
        m_bound, window_r, (float*)part, offs, B);
    err = cudaGetLastError();
  } else {
    const int pieces = K * ((C + kChunk - 1) / kChunk)
        * ((CO + kChunk - 1) / kChunk);
    if (pieces > 65535) return (int)cudaErrorInvalidValue;
    const size_t smem = sizeof(int) * (size_t)window_r;
    const size_t fixed = sizeof(int) * (2 * kTile + kTile / 32)
        + 2 * sizeof(float) * kTile * (kChunk + 1);
    err = fit_smem(dw_tile_kernel<T>, smem, fixed);
    if (err != cudaSuccess) return (int)err;
    dw_tile_kernel<T><<<dim3(n_parts, pieces), kThreads, smem, st>>>(
        (const int*)keys, n_in, (const T*)feats, C, (const int*)qmeta, nw, M,
        (const int*)start, n_tiles, K, (const T*)gy, CO,
        (const int*)q_active, m_bound, window_r, (float*)part, offs, B);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess) return (int)err;
  dw_reduce_kernel<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0,
                     st>>>((float*)dw, (const float*)part, n_parts, n);
  return (int)cudaGetLastError();
}

}  // namespace

// keys i32[B, n_in] sorted; feats T[B, n_in, C]; qmeta i32[B, 1+nw, M];
// start i32[B, n_tiles, K'] (K' >= every cols[k] + 1); gy T[B, M, CO];
// q_active i32[B]; dw f32[K, C, CO], ZEROED by the caller (the kernel adds
// onto it); part f32[n_parts, K * C * CO] scratch, n_parts >= 1 blocks
// sharing out the query tiles (its contents are overwritten).  dkeys and
// cols are HOST arrays of K ints.  Returns the launches' cudaError_t.
#define SEID_DW_ENTRY(NAME, T)                                                \
  extern "C" int NAME(const void* keys, int n_in, const void* feats, int C,   \
                      const void* qmeta, int nw, int M, const void* start,    \
                      int n_tiles, int K, const void* gy, int CO,             \
                      const void* q_active, int m_bound, int window_r,        \
                      void* dw, const int* dkeys, const int* cols, int B,     \
                      void* part, int n_parts, void* stream) {                \
    return launch<T>(keys, n_in, feats, C, qmeta, nw, M, start, n_tiles, K,   \
                     gy, CO, q_active, m_bound, window_r, dw, dkeys, cols, B, \
                     part, n_parts, stream);                                  \
  }

SEID_DW_ENTRY(seid_window_dw_f32, float)
SEID_DW_ENTRY(seid_window_dw_bf16, __nv_bfloat16)
