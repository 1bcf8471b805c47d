// The tensor-core machinery of the window kernels, shared by the forward
// conv (window_conv.cu) and the backward's dX (window_bwd.cu, which runs the
// same conv through the backward plan with transposed weights): the cp.async,
// ldmatrix and mma.sync wrappers; the tile's search (stage_queries,
// search_slots: each warp stages its offsets' plan windows with cp.async and
// searches them with find_keys_staged, match_row's pair set), which
// window_gather.cu uses too; the three conv routes (conv_c1_kernel,
// conv_tc_kernel, conv_f32_kernel) and their launch (conv_launch).
// conv_tc_kernel's GEMM (tc_product: the ring, ldmatrix, mma) and its
// store (tc_store, with the cluster sum through distributed shared memory
// in a fixed order) take their rows from a row source, so gather_conv.cu's
// tensor-core kernel runs the same GEMM on a rulebook's rows.
// window_conv.cu's head comment describes the design.
//
// Replaces: sparseeventid_tpu/ops/pallas/window_conv.py, window_conv_apply
// (Pallas kernel _conv_kernel), and the dX half of window_bwd_strided
// (_bwd_strided_kernel; window_bwd_subm is a thin call of it).
//
// Bound on the H100: bytes at the recipes' shapes (the table, the query
// meta and the output are tens of MB at level 0, against a few GFLOP that
// the tensor cores take microseconds for); operations only where every
// query matches at every offset (a dense block).  Every output element is
// written once: the cluster route adds its blocks' partial tiles in the
// fixed order 0, 1, .., G - 1, so the result has the same bits on every
// run.
//
// Role is a tag type, FwdConv or BwdDx: each file instantiates the kernels
// with its own, so a profile tells the backward's dX launches from the
// forward's.  Nothing else depends on it.

#pragma once

#include <cooperative_groups.h>

#include <type_traits>
#include <utility>

#include "window_match.cuh"

namespace seid {
struct FwdConv {};
struct BwdDx {};
}  // namespace seid

// (kernels in a top-level anonymous namespace: nvcc's host stubs do not
// take one nested in a named namespace)
namespace {

using namespace seid;
namespace cg = cooperative_groups;

constexpr int kWarps = kThreads / 32;  // 8
constexpr int kQ = kTile / 32;         // queries a lane searches
constexpr unsigned kFull = 0xffffffffu;
constexpr int kKc = 64;                // GEMM depth a stage holds
constexpr int kMaxSlab = 192;          // output columns a tensor-core block holds

// ---- asynchronous copies, ldmatrix and mma (sm_80+ PTX) -------------------

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(smem_u32(dst)), "l"(src) : "memory");
}
// 16 bytes to shared memory: the first src_bytes from src, the rest zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)) : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)) : "memory");
}
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---- the matching, shared by the two new routes --------------------------

// The tile's query meta, [1 + nw][kTile] (base key row, then the validity
// words; 0 for rows past M or m_bound, which are then never live), and the
// window start of each of the K slots k0, k0 + 1, ...  All threads; no
// barrier.
__device__ __forceinline__ void stage_queries(
    const int* __restrict__ meta_b, int nw, int M, long long m0, int m_bound,
    const int* __restrict__ start_t, const Offsets& offs, int k0, int K,
    int* qm, int* st) {
  for (int idx = threadIdx.x; idx < (1 + nw) * kTile; idx += kThreads) {
    const int w = idx / kTile;
    const long long m = m0 + (idx - w * kTile);
    qm[idx] = (m < M && m < m_bound) ? meta_b[(long long)w * M + m] : 0;
  }
  for (int k = threadIdx.x; k < K; k += kThreads) st[k] = start_t[offs.col[k0 + k]];
}

// For every slot k < K (offset k0 + k): pos[k * pitch + r] = the position
// inside its window
// (window_rows(st[k], ...)) of the table row query r of the tile matches,
// or -1, and hits[k][i] = the ballot of queries r = lane + 32 i that
// matched.  Warp w owns k = w, w + 8, ...; its kWinBufs window buffers
// (wbuf, window_r ints each) rotate, so the copies of the next two
// offsets' keys are in flight while the current one is searched.  qm and
// st must be visible (a barrier before); pos and hits are, after the next.
constexpr int kWinBufs = 3;

__device__ __forceinline__ void search_slots(
    const int* __restrict__ keys_b, int n_in, const int* qm, const int* st,
    const Offsets& offs, int k0, int K, int window_r, int* wbuf,
    short* pos_out, int pitch, unsigned* hits) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int* bufs = wbuf + warp * kWinBufs * window_r;
  auto copy = [&](int k, int slot) {
    if (k < K) {
      long long lo, end;
      window_rows(st[k], window_r, n_in, lo, end);
      const int n = end > lo ? (int)(end - lo) : 0;
      const int* src = keys_b + lo;
      int* dst = bufs + slot * window_r;
      for (int i = lane; i < n; i += 32) cp_async4(dst + i, src + i);
    }
    cp_async_commit();
  };
  copy(warp, 0);
  copy(warp + kWarps, 1);
  for (int it = 0, k = warp; k < K; ++it, k += kWarps) {
    copy(k + 2 * kWarps, (it + 2) % kWinBufs);
    cp_async_wait<kWinBufs - 1>();
    __syncwarp();
    long long lo, end;
    window_rows(st[k], window_r, n_in, lo, end);
    const int n_win = end > lo ? (int)(end - lo) : 0;
    const int col = offs.col[k0 + k];
    const long long dkey = offs.dkey[col];
    const int* bits = qm + (1 + (col >> 5)) * kTile;
    long long q[kQ];
    int pos[kQ];
#pragma unroll
    for (int i = 0; i < kQ; ++i) q[i] = (long long)qm[lane + 32 * i] + dkey;
    find_keys_staged(bufs + (it % kWinBufs) * window_r, n_win, q, pos);
#pragma unroll
    for (int i = 0; i < kQ; ++i) {
      const int r = lane + 32 * i;
      if (!((bits[r] >> (col & 31)) & 1)) pos[i] = -1;
      pos_out[k * pitch + r] = (short)pos[i];
      const unsigned hit = __ballot_sync(kFull, pos[i] >= 0);
      if (lane == 0) hits[k * kQ + i] = hit;
    }
    __syncwarp();  // this buffer is read: the copy kWinBufs offsets on reuses it
  }
  cp_async_wait<0>();
}

// ---- C == 1, CO <= 32 ----------------------------------------------------

constexpr int kRowsPerWarp = kTile / kWarps;  // 16
constexpr int kGatherBatch = 8;
constexpr int kValPitch = kTile + 8;  // 16 * odd bytes a bf16 row: ldmatrix
constexpr int kWsPitch = 32 + 8;      // is free of bank conflicts

// Shared memory of conv_c1_kernel: [Kp][kValPitch] window positions, then
// their values (in place where T is 2 bytes wide), W as [Kp][kWsPitch]
// (Kp = K rounded up to 16, the rows past K zero), the query meta, the
// slots' window starts, the ballots and the warps' windows.
template <typename T>
struct C1Smem {
  static constexpr bool kInPlace = sizeof(T) == sizeof(short);
  __host__ __device__ static int rows(int K) { return (K + 15) / 16 * 16; }
  static size_t bytes(int K, int nw, int window_r) {
    const size_t kt = (size_t)rows(K) * kValPitch;
    return kt * sizeof(short) + (kInPlace ? 0 : kt * sizeof(T))
        + (size_t)rows(K) * kWsPitch * sizeof(T)
        + sizeof(int) * ((size_t)(1 + nw) * kTile + K + (size_t)K * kQ
                         + (size_t)kWarps * kWinBufs * window_r);
  }
};

template <class Role, typename T>
__global__ void __launch_bounds__(kThreads, 3)
conv_c1_kernel(const int* __restrict__ keys, int n_in,
               const T* __restrict__ feats,
               const int* __restrict__ qmeta, int nw, int M,
               const int* __restrict__ start, int n_tiles, int K,
               const T* __restrict__ w, int CO,
               const int* __restrict__ q_active, int m_bound, int window_r,
               T* __restrict__ out, Offsets offs) {
  extern __shared__ __align__(16) unsigned char smem_c1[];
  const int kp = C1Smem<T>::rows(K);
  const int kt = kp * kValPitch;
  short* pos = reinterpret_cast<short*>(smem_c1);
  T* val = C1Smem<T>::kInPlace
      ? reinterpret_cast<T*>(smem_c1)
      : reinterpret_cast<T*>(smem_c1 + (size_t)kt * sizeof(short));
  T* ws = val + kt;
  int* qm = reinterpret_cast<int*>(ws + kp * kWsPitch);
  int* st = qm + (1 + nw) * kTile;
  unsigned* hits = reinterpret_cast<unsigned*>(st + K);
  int* wbuf = reinterpret_cast<int*>(hits + K * kQ);
  const int tile = blockIdx.x;
  const int b = blockIdx.y;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int r0 = warp * kRowsPerWarp;  // the warp's queries
  const long long m0 = (long long)tile * kTile;
  constexpr bool kMma = sizeof(T) == 2;
  // bf16: the tile's [128 x Kp] values times W's [Kp x 32] on the tensor
  // cores, a warp's 16 rows in 4 mma tiles; fp32: a lane's output channel
  float acc[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) acc[r] = 0.f;

  if (tile < live_tiles(q_active[b], m_bound)) {  // block-uniform
    stage_queries(qmeta + (long long)b * (1 + nw) * M, nw, M, m0, m_bound,
                  start + ((long long)b * n_tiles + tile) * K, offs, 0, K, qm,
                  st);
    for (int idx = t; idx < kp * kWsPitch; idx += kThreads) {
      const int k = idx / kWsPitch;
      const int o = idx - k * kWsPitch;
      ws[idx] = (k < K && o < CO) ? w[(long long)k * CO + o] : from_f<T>(0.f);
    }
    for (int idx = K * kValPitch + t; idx < kt; idx += kThreads) pos[idx] = -1;
    __syncthreads();
    search_slots(keys + (long long)b * n_in, n_in, qm, st, offs, 0, K,
                 window_r, wbuf, pos, kValPitch, hits);
    __syncthreads();
    // window positions -> values, kGatherBatch loads in flight a thread;
    // in place, each thread rewriting the entries it read
    const T* feats_b = feats + (long long)b * n_in;
    for (int base = t; base < kt; base += kThreads * kGatherBatch) {
      long long row[kGatherBatch];
      T x[kGatherBatch];
#pragma unroll
      for (int u = 0; u < kGatherBatch; ++u) {
        const int idx = base + u * kThreads;
        const int k = idx / kValPitch;
        const int p = (idx < kt && idx - k * kValPitch < kTile) ? pos[idx] : -1;
        row[u] = p >= 0 ? (long long)max(st[k], 0) + p : -1;
      }
#pragma unroll
      for (int u = 0; u < kGatherBatch; ++u)
        x[u] = row[u] >= 0 ? feats_b[row[u]] : from_f<T>(0.f);
#pragma unroll
      for (int u = 0; u < kGatherBatch; ++u) {
        const int idx = base + u * kThreads;
        if (idx < kt) val[idx] = x[u];
      }
    }
    __syncthreads();
    if constexpr (kMma) {
      for (int k0 = 0; k0 < kp; k0 += 16) {
        unsigned a[4];
        ldsm_x4_t(a, val + (k0 + (lane & 7) + ((lane >> 4) << 3)) * kValPitch
                         + r0 + (((lane >> 3) & 1) << 3));
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          unsigned bb[4];
          ldsm_x4_t(bb, ws + (k0 + (lane & 15)) * kWsPitch + np * 16
                            + ((lane >> 4) << 3));
          mma_bf16(*reinterpret_cast<float(*)[4]>(acc + 8 * np), a, bb[0], bb[1]);
          mma_bf16(*reinterpret_cast<float(*)[4]>(acc + 8 * np + 4), a, bb[2], bb[3]);
        }
      }
    } else {
      const int grp = r0 >> 5;
      const int shift = r0 & 31;
      for (int k = 0; k < K; ++k) {
        if (!((hits[k * kQ + grp] >> shift) & 0xffffu)) continue;  // uniform
        const float wv = to_f(ws[k * kWsPitch + lane]);
        const T* v = val + k * kValPitch + r0;
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r)
          acc[r] = fmaf(to_f(v[r]), wv, acc[r]);
      }
    }
  }
  if constexpr (kMma) {
    // mma tile nj (acc[4 nj ..]): rows lane / 4 (+ 8), columns 8 nj + 2 (lane % 4) (+ 1)
#pragma unroll
    for (int nj = 0; nj < 4; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const long long m = m0 + r0 + (lane >> 2) + ((e >> 1) << 3);
        const int o = nj * 8 + ((lane & 3) << 1) + (e & 1);
        if (m < M && o < CO)
          out[((long long)b * M + m) * CO + o] = from_f<T>(acc[4 * nj + e]);
      }
  } else {
    if (lane >= CO) return;
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const long long m = m0 + r0 + r;
      if (m < M) out[((long long)b * M + m) * CO + lane] = from_f<T>(acc[r]);
    }
  }
}

// ---- bf16, tensor cores ---------------------------------------------------

constexpr int kApitch = kKc + 8;  // bf16; a row of 16 * odd bytes keeps
                                  // ldmatrix free of bank conflicts

// Stages of the ring: three, where a block holds the SM alone anyway; two
// for the narrowest slab, which fits three blocks an SM that way.
__host__ __device__ constexpr int stages(int nt) { return nt <= 2 ? 2 : 3; }

// Where a tensor-core block's rows come from.  rows.at(k) is slot k of the
// block (offset k0 + k); rows.at(k)(r) is the table row that row r of the
// tile reads at that offset, or -1 (a miss: zeros).
//   WindowRows (the window conv): the tile's search, a 16-bit position in
//   the slot's plan window (pos [kg][kTile], -1 unmatched) past the
//   window's first row max(st[k], 0).
//   IndexRows (the gather conv): the tile's staged index block, row r's
//   entry at nbr[r * pitch + k], already -1 where it missed.
struct WindowRows {
  const short* pos;
  const int* st;
  struct At {
    const short* p;
    long long lo;
    __device__ __forceinline__ long long operator()(int r) const {
      const int v = p[r];
      return v >= 0 ? lo + v : -1;
    }
  };
  __device__ __forceinline__ At at(int k) const {
    return At{pos + k * kTile, (long long)max(st[k], 0)};
  }
};

struct IndexRows {
  const int* nbr;
  int pitch;
  struct At {
    const int* p;
    int pitch;
    __device__ __forceinline__ long long operator()(int r) const {
      return p[r * pitch];
    }
  };
  __device__ __forceinline__ At at(int k) const { return At{nbr + k, pitch}; }
};

// The block's slots k < nk that any row of the tile hits, in order, into
// act[0 .. act[kg]); hits[k * kQ + i] is slot k's ballot of rows
// lane + 32 i.  Warp 0 alone; the caller synchronises before and after.
__device__ __forceinline__ void list_active(const unsigned* hits, int nk,
                                            int kg, int* act) {
  const int lane = threadIdx.x & 31;
  int cnt = 0;
  for (int base = 0; base < nk; base += 32) {
    const int k = base + lane;
    bool on = false;
    if (k < nk)
#pragma unroll
      for (int i = 0; i < kQ; ++i) on |= hits[k * kQ + i] != 0u;
    const unsigned m = __ballot_sync(kFull, on);
    if (on) act[cnt + __popc(m & ((1u << lane) - 1u))] = k;
    cnt += __popc(m);
  }
  if (lane == 0) act[kg] = cnt;
}

// The tile's product on the tensor cores, the GEMM of both tensor-core
// kernels: acc += the tile's rows at the listed slots act[0 .. n_act) (W of
// offset k0 + slot) times the [.., 16 * NT] slab of W at columns n0 ...
// NT: 8-column mma tiles a warp holds (8 warps: 4 row groups of 32 x 2
// column groups of 8 * NT); acc is the warp's piece.  The GEMM depth (the
// listed slots times C, flattened slot-major) is walked in chunks of kKc
// through a ring of stages(NT) cp.async stages in `ring`: a chunk may hold
// the end of one slot and the start of the next, and small C packs several
// slots into one chunk.  vec: C % 8 == 0, CO % 8 == 0 and 16-byte aligned
// bases (16-byte copies, zero-filled at a miss); else element by element.
template <int NT, class Rows>
__device__ __forceinline__ void tc_product(
    __nv_bfloat16* ring, const int* act, int n_act, const Rows& rows,
    const __nv_bfloat16* __restrict__ feats_b,
    const __nv_bfloat16* __restrict__ feats, int C,
    const __nv_bfloat16* __restrict__ w, int k0, int CO, int n0, bool vec,
    float (&acc)[2][NT][4]) {
  constexpr int kSlab = 16 * NT;
  constexpr int kStages = stages(NT);
  constexpr int kBpitch = kSlab + 8;
  constexpr int kStageElems = kTile * kApitch + kKc * kBpitch;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int wr = warp & 3;   // rows wr * 32 ..
  const int wc = warp >> 2;  // columns wc * 8 * NT ..
  const int n_steps = (n_act * C + kKc - 1) / kKc;

  // stage `step` (depth f0 = step * kKc ..) into ring slot `slot`:
  // depth f is channel f % C of listed slot f / C
  auto load_stage = [&](int step, int slot) {
    const int f0 = step * kKc;
    const int a0 = f0 / C;
    const int c0 = f0 - a0 * C;
    __nv_bfloat16* as = ring + slot * kStageElems;
    __nv_bfloat16* bs = as + kTile * kApitch;
    if (vec && c0 + kKc <= C) {  // the chunk lies inside one slot
      const int k = act[a0];  // the block's slot; offset k0 + k
      const auto src_rows = rows.at(k);
      const int seg = (t & 7) << 3;
      const __nv_bfloat16* src = feats_b + c0 + seg;
      for (int r = t >> 3; r < kTile; r += kThreads / 8) {
        const long long row = src_rows(r);
        cp_async16(as + r * kApitch + seg,
                   row >= 0 ? src + row * C : feats, row >= 0 ? 16 : 0);
      }
      constexpr int bsegs = kSlab >> 3;
      const __nv_bfloat16* wk = w + ((long long)(k0 + k) * C + c0) * CO + n0;
      for (int idx = t; idx < kKc * bsegs; idx += kThreads) {
        const int ci = idx / bsegs;
        const int o = (idx - ci * bsegs) << 3;
        const int bytes = max(0, min(16, 2 * (CO - n0 - o)));
        cp_async16(bs + ci * kBpitch + o,
                   bytes ? wk + (long long)ci * CO + o : w, bytes);
      }
    } else if (vec) {  // C % 8 == 0, CO % 8 == 0, 16-byte aligned bases
      // this thread's 8-channel segment of rows r = t / 8 + 32 j
      const int seg = (t & 7) << 3;
      int a = a0, c = c0 + seg;
      while (c >= C) { c -= C; ++a; }
      const bool on = a < n_act;
      const auto src_rows = rows.at(on ? act[a] : 0);
      for (int r = t >> 3; r < kTile; r += kThreads / 8) {
        const long long row = on ? src_rows(r) : -1;
        cp_async16(as + r * kApitch + seg,
                   row >= 0 ? feats_b + row * C + c : feats,
                   row >= 0 ? 16 : 0);
      }
      constexpr int bsegs = kSlab >> 3;
      for (int idx = t; idx < kKc * bsegs; idx += kThreads) {
        const int ci = idx / bsegs;
        const int o = (idx - ci * bsegs) << 3;
        int ab = a0, cb = c0 + ci;
        while (cb >= C) { cb -= C; ++ab; }
        const int bytes = ab < n_act ? max(0, min(16, 2 * (CO - n0 - o))) : 0;
        cp_async16(bs + ci * kBpitch + o,
                   bytes ? w + ((long long)(k0 + act[ab]) * C + cb) * CO + n0 + o
                         : w,
                   bytes);
      }
    } else {  // element by element, zero-filled the same way
      const __nv_bfloat16 zero = __float2bfloat16(0.f);
      for (int idx = t; idx < kTile * kKc; idx += kThreads) {
        const int r = idx / kKc;
        const int e = idx - r * kKc;
        const int f = f0 + e;
        const int a = f / C;
        __nv_bfloat16 v = zero;
        if (a < n_act) {
          const long long row = rows.at(act[a])(r);
          if (row >= 0) v = feats_b[row * C + f - a * C];
        }
        as[r * kApitch + e] = v;
      }
      for (int idx = t; idx < kKc * kSlab; idx += kThreads) {
        const int ci = idx / kSlab;
        const int o = idx - ci * kSlab;
        const int f = f0 + ci;
        const int a = f / C;
        bs[ci * kBpitch + o] = (a < n_act && n0 + o < CO)
            ? w[((long long)(k0 + act[a]) * C + f - a * C) * CO + n0 + o]
            : zero;
      }
    }
  };

#pragma unroll
  for (int p = 0; p < kStages - 1; ++p) {
    if (p < n_steps) load_stage(p, p);
    cp_async_commit();
  }
  for (int s = 0; s < n_steps; ++s) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // step s is in; every warp is done with step s - 1
    const int nx = s + kStages - 1;
    if (nx < n_steps) load_stage(nx, nx % kStages);
    cp_async_commit();
    const __nv_bfloat16* as = ring + (s % kStages) * kStageElems;
    const __nv_bfloat16* bs = as + kTile * kApitch;
#pragma unroll
    for (int kk = 0; kk < kKc; kk += 16) {
      unsigned a[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldsm_x4(a[mi], as + (wr * 32 + mi * 16 + (lane & 15)) * kApitch + kk
                           + ((lane >> 4) << 3));
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        unsigned bb[4];
        ldsm_x4_t(bb, bs + (kk + (lane & 15)) * kBpitch + wc * 8 * NT
                          + np * 16 + ((lane >> 4) << 3));
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          mma_bf16(acc[mi][2 * np], a[mi], bb[0], bb[1]);
          mma_bf16(acc[mi][2 * np + 1], a[mi], bb[2], bb[3]);
        }
      }
    }
  }
  cp_async_wait<0>();
}

// Write the tile's [128, slab] output (columns n0 ..) of batch element b,
// cast to bf16 once.  groups == 1: each warp writes its accumulators.
// Otherwise the block is rank grp of a cluster of G = groups blocks that
// share the tile's offsets: each leaves its fp32 partial tile in its own
// ring (smem_raw), and block g adds rows [g * 128 / G, ..) of the G
// partials, read through distributed shared memory in the order 0, 1, ..,
// G - 1, and writes them: the same sums on every run, no atomics.  live
// must be cluster-uniform; a tile that is not writes zeros.
template <int NT>
__device__ __forceinline__ void tc_store(
    const float (&acc)[2][NT][4], unsigned char* smem_raw, bool live,
    int groups, int grp, long long m0, int M, int b, int CO, int n0,
    __nv_bfloat16* __restrict__ out) {
  constexpr int kSlab = 16 * NT;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int wr = warp & 3;
  const int wc = warp >> 2;
  // accumulator (mi, nj): rows lane / 4 (+ 8), columns 2 (lane % 4) (+ 1)
  const bool pairs = (CO & 1) == 0;
  if (groups == 1) {
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long m = m0 + wr * 32 + mi * 16 + (lane >> 2) + 8 * h;
        if (m >= M) continue;
        __nv_bfloat16* orow = out + ((long long)b * M + m) * CO;
#pragma unroll
        for (int nj = 0; nj < NT; ++nj) {
          const int o = n0 + wc * 8 * NT + nj * 8 + ((lane & 3) << 1);
          const float v0 = acc[mi][nj][2 * h], v1 = acc[mi][nj][2 * h + 1];
          if (pairs && o + 1 < CO) {
            *reinterpret_cast<__nv_bfloat162*>(orow + o) =
                __floats2bfloat162_rn(v0, v1);
          } else {
            if (o < CO) orow[o] = __float2bfloat16(v0);
            if (o + 1 < CO) orow[o + 1] = __float2bfloat16(v1);
          }
        }
      }
    return;
  }
  // the cluster's sum: partial tiles [kTile][kPpitch] in each block's ring
  constexpr int kPpitch = kSlab + 4;
  float* part = reinterpret_cast<float*>(smem_raw);
  cg::cluster_group cluster = cg::this_cluster();
  if (live) {
    __syncthreads();  // every warp is done with the ring
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int nj = 0; nj < NT; ++nj) {
          const int r = wr * 32 + mi * 16 + (lane >> 2) + 8 * h;
          const int o = wc * 8 * NT + nj * 8 + ((lane & 3) << 1);
          *reinterpret_cast<float2*>(part + r * kPpitch + o) =
              make_float2(acc[mi][nj][2 * h], acc[mi][nj][2 * h + 1]);
        }
    cluster.sync();
  }
  const int rows = (kTile + groups - 1) / groups;
  const int r_lo = grp * rows;
  const int r_hi = min(kTile, r_lo + rows);
  for (int idx = t; idx < (r_hi - r_lo) * (kSlab / 4); idx += kThreads) {
    const int r = r_lo + idx / (kSlab / 4);
    const int o = (idx % (kSlab / 4)) * 4;
    const long long m = m0 + r;
    if (m >= M) continue;
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
    if (live) {
      sum = *reinterpret_cast<const float4*>(
          cluster.map_shared_rank(part, 0) + r * kPpitch + o);
      for (int g = 1; g < groups; ++g) {
        const float4 v = *reinterpret_cast<const float4*>(
            cluster.map_shared_rank(part, g) + r * kPpitch + o);
        sum.x += v.x; sum.y += v.y; sum.z += v.z; sum.w += v.w;
      }
    }
    __nv_bfloat16* orow = out + ((long long)b * M + m) * CO + n0;
    const float v[4] = {sum.x, sum.y, sum.z, sum.w};
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (n0 + o + e < CO) orow[o + e] = __float2bfloat16(v[e]);
  }
  if (live) cluster.sync();  // the other blocks are done reading this one
}

// The window conv on the tensor cores: one block (or a cluster of
// `groups`, each taking kg = ceil(K / G) of the offsets; the last ones may
// get fewer, or none) per (tile, slab).  The tile's search (search_slots)
// gives each query's window position per offset; the offsets with any
// match are listed, then tc_product and tc_store.
template <class Role, int NT>
__global__ void __launch_bounds__(kThreads, NT <= 2 ? 3 : NT <= 6 ? 2 : 1)
conv_tc_kernel(const int* __restrict__ keys, int n_in,
               const __nv_bfloat16* __restrict__ feats, int C,
               const int* __restrict__ qmeta, int nw, int M,
               const int* __restrict__ start, int n_tiles, int K,
               const __nv_bfloat16* __restrict__ w, int CO,
               const int* __restrict__ q_active, int m_bound, int window_r,
               __nv_bfloat16* __restrict__ out, Offsets offs,
               int ring_bytes, bool vec, int groups) {
  constexpr int kSlab = 16 * NT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the stage ring (the warps' window buffers while searching, the partial
  // tile at the end), then the window positions [kg][kTile], the ballots,
  // the list of offsets with a match and its length, the query meta and
  // the window starts
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  int* wbuf = reinterpret_cast<int*>(smem_raw);
  const int kg = (K + groups - 1) / groups;  // offsets a block takes
  short* pos = reinterpret_cast<short*>(smem_raw + ring_bytes);
  unsigned* hits = reinterpret_cast<unsigned*>(
      smem_raw + ring_bytes + ((kg * kTile * sizeof(short) + 15) & ~15));
  int* act = reinterpret_cast<int*>(hits + kg * kQ);
  int* qm = act + kg + 1;
  int* st = qm + (1 + nw) * kTile;

  const int tile = blockIdx.x;
  const int b = blockIdx.y;
  const int grp = blockIdx.z % groups;  // the block's rank in its cluster
  const int n0 = blockIdx.z / groups * kSlab;
  const int k0 = grp * kg;
  const int nk = min(kg, K - k0);
  const int warp = threadIdx.x >> 5;
  const long long m0 = (long long)tile * kTile;

  float acc[2][NT][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  // cluster-uniform: the blocks of a cluster share the tile
  const bool live = tile < live_tiles(q_active[b], m_bound);
  if (live) {
    stage_queries(qmeta + (long long)b * (1 + nw) * M, nw, M, m0, m_bound,
                  start + ((long long)b * n_tiles + tile) * K, offs, k0, nk,
                  qm, st);
    __syncthreads();
    search_slots(keys + (long long)b * n_in, n_in, qm, st, offs, k0, nk,
                 window_r, wbuf, pos, kTile, hits);
    __syncthreads();
    if (warp == 0) list_active(hits, nk, kg, act);  // the offsets with any match
    __syncthreads();  // also: every window buffer is read; the ring is free
    tc_product<NT>(ring, act, act[kg], WindowRows{pos, st},
                   feats + (long long)b * n_in * C, feats, C, w, k0, CO, n0,
                   vec, acc);
  }
  tc_store<NT>(acc, smem_raw, live, groups, grp, m0, M, b, CO, n0, out);
}

// ---- float32, C > 1: float32 FMAs on the CUDA cores ----------------------

constexpr int kCo = kChunk;  // output channels per block
constexpr int kCc = kChunk;  // input channels staged per step

template <class Role>
__global__ void __launch_bounds__(kThreads)
conv_f32_kernel(const int* __restrict__ keys, int n_in,
                const float* __restrict__ feats, int C,
                const int* __restrict__ qmeta, int nw, int M,
                const int* __restrict__ start, int n_tiles, int K,
                const float* __restrict__ w, int CO,
                const int* __restrict__ q_active, int m_bound, int window_r,
                float* __restrict__ out, Offsets offs) {
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

  const int live = live_tiles(q_active[b], m_bound);

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  if (tile < live) {  // block-uniform
    const int* meta_b = qmeta + (long long)b * (1 + nw) * M;
    const int* keys_b = keys + (long long)b * n_in;
    const int* start_t = start + ((long long)b * n_tiles + tile) * K;
    int base = 0;
    const long long mq = m0 + t;
    const bool q_in = t < kTile && mq < M && mq < m_bound;
    if (q_in) base = meta_b[mq];
    for (int k = 0; k < K; ++k) {
      const int col = offs.col[k];
      if (t < kTile) {
        int row = -1;
        if (q_in)
          row = match_row(keys_b, n_in, meta_b, M, mq, base, col,
                          offs.dkey[col], start_t[col], window_r);
        nbr[t] = row;
      }
      const int any = __syncthreads_or(t < kTile && nbr[t] >= 0);
      if (!any) continue;  // uniform: no query of this tile matched
      const float* wk = w + (long long)k * C * CO;
      for (int c0 = 0; c0 < C; c0 += kCc) {
        const int cw = (C - c0) < kCc ? (C - c0) : kCc;
        for (int idx = t; idx < kTile * cw; idx += kThreads) {
          const int r = idx / cw;
          const int cc = idx - r * cw;
          const int row = nbr[r];
          xs[r][cc] = row >= 0
              ? feats[((long long)b * n_in + row) * C + c0 + cc] : 0.f;
        }
        for (int idx = t; idx < cw * kCo; idx += kThreads) {
          const int ci = idx / kCo;
          const int oj = idx - ci * kCo;
          const int o = co0 + oj;
          ws[ci][oj] = o < CO ? wk[(long long)(c0 + ci) * CO + o] : 0.f;
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
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long m = m0 + ty + 32 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int o = co0 + tx + 8 * j;
      if (o < CO) out[((long long)b * M + m) * CO + o] = acc[i][j];
    }
  }
}

// ---- launch ---------------------------------------------------------------

// Opt a kernel in to `smem` bytes of dynamic shared memory; an error where
// the card has not that much.
template <typename F>
cudaError_t fit_smem(F* kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (smem > (size_t)optin) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

// Bytes at the head of a tensor-core block's shared memory: the largest of
// the ring's stages, `other` (what the kernel keeps there before the
// product) and the cluster's fp32 partial tile, rounded to 16.
template <int NT>
size_t tc_ring_bytes(size_t other) {
  const int slab = 16 * NT;
  const size_t ring = (size_t)stages(NT) * 2
      * ((size_t)kTile * kApitch + (size_t)kKc * (slab + 8));
  const size_t partial = sizeof(float) * kTile * (size_t)(slab + 4);
  const size_t bytes = ring > other ? ring : other;
  return ((bytes > partial ? bytes : partial) + 15) / 16 * 16;
}

// The slab of a tensor-core block, all of CO up to kMaxSlab columns in
// 16-column steps (an even number of 8-column tiles a warp): calls
// f(std::integral_constant<int, NT>) with the block's NT.
template <class F>
int with_slab(int CO, F&& f) {
  const int n_slabs = (CO + kMaxSlab - 1) / kMaxSlab;
  const int per = (CO + n_slabs - 1) / n_slabs;
  switch (((per + 31) / 32) * 2) {
    case 2: return f(std::integral_constant<int, 2>());
    case 4: return f(std::integral_constant<int, 4>());
    case 6: return f(std::integral_constant<int, 6>());
    case 8: return f(std::integral_constant<int, 8>());
    case 10: return f(std::integral_constant<int, 10>());
    default: return f(std::integral_constant<int, 12>());
  }
}

// Launch a tensor-core kernel on `grid`, its z blocks grouped into clusters
// of `groups` (the blocks that share a tile's offsets), with `smem` bytes
// of dynamic shared memory.
template <typename... P, typename... A>
cudaError_t launch_clusters(void (*kernel)(P...), dim3 grid, size_t smem,
                            int groups, cudaStream_t st, A&&... args) {
  cudaError_t err = fit_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = 1;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = groups;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, std::forward<A>(args)...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

struct Args {
  const void *keys, *feats, *qmeta, *start, *w, *q_active;
  void* out;
  int n_in, C, nw, M, n_tiles, K, CO, m_bound, window_r, B, groups;
};

template <class Role, int NT>
int launch_tc(const Args& a, const Offsets& offs, cudaStream_t st) {
  const int m_tiles = (a.M + kTile - 1) / kTile;
  const int slab = 16 * NT;
  const int groups = a.groups < 1 ? 1 : a.groups > 8 ? 8 : a.groups;
  const int kg = (a.K + groups - 1) / groups;
  const size_t ring_bytes = tc_ring_bytes<NT>(
      sizeof(int) * kWarps * kWinBufs * (size_t)a.window_r);
  const size_t smem = ring_bytes
      + ((size_t)kg * kTile * sizeof(short) + 15) / 16 * 16
      + sizeof(int) * ((size_t)kg * kQ + kg + 1
                       + (size_t)(1 + a.nw) * kTile + kg);
  const bool vec = a.C % 8 == 0 && a.CO % 8 == 0
      && ((uintptr_t)a.feats & 15) == 0 && ((uintptr_t)a.w & 15) == 0;
  return (int)launch_clusters(
      conv_tc_kernel<Role, NT>,
      dim3(m_tiles, a.B, (a.CO + slab - 1) / slab * groups), smem, groups, st,
      (const int*)a.keys, a.n_in, (const __nv_bfloat16*)a.feats, a.C,
      (const int*)a.qmeta, a.nw, a.M, (const int*)a.start, a.n_tiles, a.K,
      (const __nv_bfloat16*)a.w, a.CO, (const int*)a.q_active, a.m_bound,
      a.window_r, (__nv_bfloat16*)a.out, offs, (int)ring_bytes, vec, groups);
}

template <class Role, typename T>
int conv_launch(const Args& a, const Offsets& offs, cudaStream_t st) {
  const int m_tiles = (a.M + kTile - 1) / kTile;
  if (a.C == 1 && a.CO <= 32) {
    const size_t smem = C1Smem<T>::bytes(a.K, a.nw, a.window_r);
    const cudaError_t err = fit_smem(conv_c1_kernel<Role, T>, smem);
    if (err != cudaSuccess) return (int)err;
    conv_c1_kernel<Role, T><<<dim3(m_tiles, a.B), kThreads, smem, st>>>(
        (const int*)a.keys, a.n_in, (const T*)a.feats, (const int*)a.qmeta,
        a.nw, a.M, (const int*)a.start, a.n_tiles, a.K, (const T*)a.w, a.CO,
        (const int*)a.q_active, a.m_bound, a.window_r, (T*)a.out, offs);
    return (int)cudaGetLastError();
  }
  if constexpr (sizeof(T) == 2) {
    return with_slab(a.CO, [&](auto nt) {
      return launch_tc<Role, decltype(nt)::value>(a, offs, st);
    });
  } else {
    conv_f32_kernel<Role><<<dim3(m_tiles, a.B, (a.CO + kCo - 1) / kCo),
                            kThreads, 0, st>>>(
        (const int*)a.keys, a.n_in, (const float*)a.feats, a.C,
        (const int*)a.qmeta, a.nw, a.M, (const int*)a.start, a.n_tiles, a.K,
        (const float*)a.w, a.CO, (const int*)a.q_active, a.m_bound,
        a.window_r, (float*)a.out, offs);
    return (int)cudaGetLastError();
  }
}
}  // namespace
