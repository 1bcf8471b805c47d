// Windowed sparse convolution, weight gradient over the in-window pairs of
// a plan:
//   dw[k, c, o] = sum_b sum_t feats[b, n(b, t, k), c] * gy[b, t, o]
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
// persistent block columns (column p takes tiles p, p + n_parts, ...); each
// block sums its tiles on chip and writes its partial dW once, to row p of a
// float32 scratch [n_parts, K * C * CO]; ordered_sum_kernel
// (window_match.cuh) adds the rows up in order p = 0, 1, ... per element
// and writes dw.  No atomics anywhere, so dw is the same bit for bit from
// run to run for a given n_parts (kernels._dw_parts).
//   C == 1, CO <= 32 (dw_c1_kernel, the forward's C == 1 machinery of
//   window_tc.cuh run backwards): a block takes a group of kg of the K
//   offsets (groups of them split K where the live tiles are too few to
//   fill the card, as in a SimCLR view), and per tile it stages the query
//   meta (stage_queries) and the tile's gy rows (cp.async), searches its
//   offsets' plan windows (search_slots: each warp's windows staged by
//   cp.async, the next two in flight while it searches; match_row's pair
//   set), turns the matches into a [kg x 128] value tile (c1_gather) and
//   adds the partial dW = values x gy_tile ([kg x 128] x [128 x 32]) to its
//   registers: bf16 on the tensor cores (mma.sync m16n8k16, the values by
//   ldmatrix, gy by ldmatrix.trans), fp32 as a lane per output summing the
//   tile's rows in order on the CUDA cores.
//   Otherwise (dw_tile_kernel): a block owns one (k, 32-channel, 32-output)
//   piece of dw and keeps it in registers over its tiles: per tile it
//   copies the window, matches the 128 queries for its offset, compacts
//   the matched ones (a strided plan matches a query at one offset of K),
//   stages their table rows and gy rows (32 channels each) and adds their
//   outer product (tile_outer_acc over the matched rows only).

#include "window_tc.cuh"

namespace {

using namespace seid;

// The C == 1 route: block (p, g) takes live tiles p, p + n_parts, ... and
// the offsets k0 = g * kg .. k0 + kg; per tile the search of window_tc.cuh
// gives the [Kp x 128] values of its slots, and warp w adds the product of
// slot rows 16 w .. 16 w + 15 (if any) with the tile's gy rows to acc.
template <typename T>
__global__ void __launch_bounds__(kThreads, 3)
dw_c1_kernel(const int* __restrict__ keys, int n_in,
             const T* __restrict__ feats,
             const int* __restrict__ qmeta, int nw, int M,
             const int* __restrict__ start, int n_tiles, int K,
             const T* __restrict__ gy, int CO,
             const int* __restrict__ q_active, int m_bound, int window_r,
             float* __restrict__ part, Offsets offs, int B, int kg, bool vec) {
  extern __shared__ __align__(16) unsigned char smem_dw[];
  const int kp = C1Smem<T>::rows(kg);
  const int kt = kp * kValPitch;
  short* pos = reinterpret_cast<short*>(smem_dw);
  T* val = C1Smem<T>::kInPlace
      ? reinterpret_cast<T*>(smem_dw)
      : reinterpret_cast<T*>(smem_dw + (size_t)kt * sizeof(short));
  T* gs = val + kt;  // [kTile][kWsPitch] the tile's gy rows, 0 past CO
  int* qm = reinterpret_cast<int*>(gs + kTile * kWsPitch);
  int* st = qm + (1 + nw) * kTile;
  unsigned* hits = reinterpret_cast<unsigned*>(st + kg);
  int* wbuf = reinterpret_cast<int*>(hits + kg * kQ);
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int k0 = blockIdx.y * kg;
  const int nk = min(kg, K - k0);
  const int m_tiles = (M + kTile - 1) / kTile;
  constexpr bool kMma = sizeof(T) == 2;
  // bf16: the warp's 16 slot rows x 32 outputs in 4 mma tiles (acc[4 nj ..]:
  // rows lane / 4 (+ 8), columns 8 nj + 2 (lane % 4) (+ 1)); fp32: slot row
  // 16 warp + i, output lane
  float acc[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i] = 0.f;

  const int n_live = count_live(q_active, B, m_bound, m_tiles);
  for (int g = blockIdx.x; g < n_live && nk > 0; g += gridDim.x) {
    int b, tile;
    live_tile(q_active, m_bound, m_tiles, g, b, tile);
    const long long m0 = (long long)tile * kTile;
    __syncthreads();  // the previous tile's values and gy rows are read
    stage_queries(qmeta + (long long)b * (1 + nw) * M, nw, M, m0, m_bound,
                  start + ((long long)b * n_tiles + tile) * K, offs, k0, nk,
                  qm, st);
    const T* gy_t = gy + ((long long)b * M + m0) * CO;
    if (kMma && vec) {  // 16-byte copies, zero-filled past M, m_bound and CO
      for (int idx = t; idx < kTile * 4; idx += kThreads) {
        const int r = idx >> 2;
        const int o = (idx & 3) << 3;
        const bool on = m0 + r < M && m0 + r < m_bound && o < CO;
        cp_async16(gs + r * kWsPitch + o, on ? gy_t + r * CO + o : gy,
                   on ? 16 : 0);
      }
      cp_async_commit();
    } else {
      for (int idx = t; idx < kTile * 32; idx += kThreads) {
        const int r = idx >> 5;
        const int o = idx & 31;
        gs[r * kWsPitch + o] = (m0 + r < M && m0 + r < m_bound && o < CO)
            ? gy_t[r * CO + o] : from_f<T>(0.f);
      }
    }
    for (int idx = nk * kValPitch + t; idx < kt; idx += kThreads) pos[idx] = -1;
    __syncthreads();
    search_slots(keys + (long long)b * n_in, n_in, qm, st, offs, k0, nk,
                 window_r, wbuf, pos, kValPitch, hits);
    __syncthreads();
    c1_gather(pos, val, st, feats + (long long)b * n_in, kt);
    cp_async_wait<0>();
    __syncthreads();
    if (warp * 16 < kp) {  // warp-uniform
      if constexpr (kMma) {
#pragma unroll
        for (int r0 = 0; r0 < kTile; r0 += 16) {
          unsigned a[4];
          ldsm_x4(a, val + (warp * 16 + (lane & 15)) * kValPitch + r0
                         + ((lane >> 4) << 3));
#pragma unroll
          for (int np = 0; np < 2; ++np) {
            unsigned bb[4];
            ldsm_x4_t(bb, gs + (r0 + (lane & 15)) * kWsPitch + np * 16
                              + ((lane >> 4) << 3));
            mma_bf16(*reinterpret_cast<float(*)[4]>(acc + 8 * np), a, bb[0],
                     bb[1]);
            mma_bf16(*reinterpret_cast<float(*)[4]>(acc + 8 * np + 4), a,
                     bb[2], bb[3]);
          }
        }
      } else {
        const T* v = val + warp * 16 * kValPitch;
        for (int r = 0; r < kTile; ++r) {
          const float gv = to_f(gs[r * kWsPitch + lane]);
#pragma unroll
          for (int i = 0; i < 16; ++i)
            acc[i] = fmaf(to_f(v[i * kValPitch + r]), gv, acc[i]);
        }
      }
    }
  }
  if (warp * 16 >= nk) return;  // no slot of this block in the warp's rows
  float* part_p = part + (long long)blockIdx.x * K * CO;
  if constexpr (kMma) {
#pragma unroll
    for (int nj = 0; nj < 4; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k = warp * 16 + (lane >> 2) + ((e >> 1) << 3);
        const int o = nj * 8 + ((lane & 3) << 1) + (e & 1);
        if (k < nk && o < CO) part_p[(long long)(k0 + k) * CO + o] = acc[4 * nj + e];
      }
  } else {
    if (lane >= CO) return;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int k = warp * 16 + i;
      if (k < nk) part_p[(long long)(k0 + k) * CO + lane] = acc[i];
    }
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

template <typename T>
int launch(const void* keys, int n_in, const void* feats, int C,
           const void* qmeta, int nw, int M, const void* start, int n_tiles,
           int K, const void* gy, int CO, const void* q_active, int m_bound,
           int window_r, void* dw, const int* dkeys, const int* cols, int B,
           void* part, int n_parts, int groups, void* stream) {
  if (K > kMaxK || n_parts < 1 || groups < 1 || window_r < 0)
    return (int)cudaErrorInvalidValue;
  Offsets offs;
  fill_offsets(offs, dkeys, cols, K);
  const long long n = (long long)K * C * CO;
  cudaStream_t st = (cudaStream_t)stream;
  if (n <= 0) return (int)cudaGetLastError();
  if (M <= 0 || B <= 0)  // no pairs: dw is 0
    return (int)cudaMemsetAsync(dw, 0, sizeof(float) * n, st);
  cudaError_t err;
  if (C == 1 && CO <= 32) {
    const int kg = (K + groups - 1) / groups;
    const size_t smem = C1Smem<T>::bytes(kg, nw, window_r, kTile);
    err = fit_smem(dw_c1_kernel<T>, smem);
    if (err != cudaSuccess) return (int)err;
    const bool vec = sizeof(T) == 2 && CO % 8 == 0 && ((uintptr_t)gy & 15) == 0;
    dw_c1_kernel<T><<<dim3(n_parts, (K + kg - 1) / kg), kThreads, smem, st>>>(
        (const int*)keys, n_in, (const T*)feats, (const int*)qmeta, nw, M,
        (const int*)start, n_tiles, K, (const T*)gy, CO, (const int*)q_active,
        m_bound, window_r, (float*)part, offs, B, kg, vec);
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
  return (int)ordered_sum((float*)dw, (const float*)part, n_parts, n, st);
}

}  // namespace

// keys i32[B, n_in] sorted; feats T[B, n_in, C]; qmeta i32[B, 1+nw, M];
// start i32[B, n_tiles, K'] (K' >= every cols[k] + 1); gy T[B, M, CO];
// q_active i32[B]; dw f32[K, C, CO], fully written; part f32[n_parts,
// K * C * CO] scratch, n_parts >= 1 block columns sharing out the query
// tiles (its contents are overwritten); groups >= 1: the C == 1 route
// splits the K offsets among that many blocks a column (the other route
// takes 1).  dkeys and cols are HOST arrays of K ints.  Returns the
// launches' cudaError_t.
#define SEID_DW_ENTRY(NAME, T)                                                \
  extern "C" int NAME(const void* keys, int n_in, const void* feats, int C,   \
                      const void* qmeta, int nw, int M, const void* start,    \
                      int n_tiles, int K, const void* gy, int CO,             \
                      const void* q_active, int m_bound, int window_r,        \
                      void* dw, const int* dkeys, const int* cols, int B,     \
                      void* part, int n_parts, int groups, void* stream) {    \
    return launch<T>(keys, n_in, feats, C, qmeta, nw, M, start, n_tiles, K,   \
                     gy, CO, q_active, m_bound, window_r, dw, dkeys, cols, B, \
                     part, n_parts, groups, stream);                          \
  }

SEID_DW_ENTRY(seid_window_dw_f32, float)
SEID_DW_ENTRY(seid_window_dw_bf16, __nv_bfloat16)
