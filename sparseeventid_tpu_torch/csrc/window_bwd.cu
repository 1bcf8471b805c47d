// Windowed sparse convolution, backward through a plan whose queries are the
// INPUT rows:
//   dx[b, t, c]  = sum_k sum_o w[k, c, o] * gy[b, n(b, t, k), o]
//   dw[k, c, o]  = sum_b sum_t x[b, t, c] * gy[b, n(b, t, k), o]
// where n(b, t, k) is the row of the gy table whose key equals
// base[t] + dkey[k'], searched only inside the plan window (k' = kmap[k];
// window_match.cuh).  Pairs outside the window are the overflow list's:
// the dX and dW sidecars add them.  For a strided conv the plan is the
// reverse plan (one live column per input row); for a submanifold conv it
// is the forward plan with w[perm], and the caller reorders dw by [perm].
// Dead tiles and rows at or past m_bound give dx = 0 and add nothing to dw.
//
// Replaces: sparseeventid_tpu/ops/pallas/window_conv.py, window_bwd_strided
// (Pallas kernel _bwd_strided_kernel; window_bwd_subm is a thin call of it).
//
// Bound on the H100: bytes at level 0, the downsamples and dune2d's level 2
// (gy, x, the query meta and dx are tens of MB at level 0), operations at
// dune3d's levels 2-5 and dune2d's 4-5 (4 * pairs * C * CO flops in bf16,
// chip_smoke.py's count); either way a few to tens of microseconds.
// What the kernels wait on is the matching (a window search per query and
// offset) and the row gathers it feeds.
// Design: the two products want opposite owners, so one call launches two
// kernels on the stream.
//   dX is the forward conv through the backward plan with transposed
//   weights: dx[t] = sum_k gy[n(t, k)] @ w_t[k], w_t = [K, CO, C] (the
//   wrapper builds it).  It runs window_tc.cuh's conv as it is (bf16: one
//   block of 8 warps per (event, 128-row tile), one search per tile on
//   windows staged by cp.async, the matched offsets' depth in 64-deep
//   chunks through a cp.async ring into mma.sync m16n8k16 with the fp32
//   accumulator in registers, one cast; at the deep levels a thread-block
//   cluster shares a tile's offsets and sums its partial tiles through
//   distributed shared memory in a fixed order; fp32: float32 FMAs on the
//   CUDA cores).  Each dx element is written once: no atomics.
//   dW (bwd_dw_kernel): a WARP owns a piece of dw, offset k and up to
//   32 x 32 of [C, CO], and walks the live tiles of all events in a fixed
//   order (the warps of block column p of n_parts take tiles p,
//   p + n_parts, ...) with no block barrier, so an SM keeps 24 such chains
//   in flight.  Per tile the warp copies the offset's plan window to its
//   shared memory with cp.async (the lanes' query keys and validity bits
//   loaded meanwhile), matches the tile's 128 queries there (four a lane,
//   find_keys_staged: match_row's pair set), compacts the matched ones by
//   ballot, stages their x rows and gy rows 32 at a time with 16-byte
//   cp.async copies and adds X^T G to its registers: bf16 on the tensor
//   cores (mma.sync m16n8k16, X^T read by ldmatrix.trans), fp32 as a lane
//   per output summing the rows in order on the CUDA cores (TF32 would not
//   meet the fp32 checks' limits).  Each warp writes its piece once, to
//   row p of a float32 scratch [n_parts, K * C * CO] that the wrapper
//   allocates (kernels._bwd_dw_parts, from the SM count and the shape), and
//   ordered_sum_kernel adds the rows in the order p = 0, 1, ...; with one
//   part the warps write dw themselves.  (A block owning a 64 x 64 piece,
//   its 8 warps synchronised four times a tile, kept only four chains an
//   SM and was slower than the dX conv at level 0.)
// No float atomics anywhere: for a given card and shape dx and dw are the
// same bits on every run.

#include "window_tc.cuh"

namespace {

using namespace seid;

constexpr int kWp = 32;  // input channels and outputs of dw a warp owns

// Shared memory of a warp of bwd_dw_kernel: a chunk of 32 matched rows' x
// and gy pieces, [32][pitch] each (a row of 16 * odd bytes keeps ldmatrix
// free of bank conflicts), the tile's matches (table row and query of
// each, in query order) and the plan window.  Rounded to 16 bytes.
template <typename T>
struct DwWarpSmem {
  static constexpr int kPitch = kWp + 16 / sizeof(T);
  __host__ __device__ static size_t bytes(int window_r) {
    const size_t b = 2 * sizeof(T) * kWp * kPitch
        + sizeof(int) * (2 * (size_t)kTile + (size_t)window_r);
    return (b + 15) / 16 * 16;
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads, 3)
bwd_dw_kernel(const int* __restrict__ keys_out, int n_out,
              const T* __restrict__ gy, int CO,
              const T* __restrict__ feats, int C,
              const int* __restrict__ rq, int nw, int M,
              const int* __restrict__ rs, int n_tiles, int K,
              const int* __restrict__ r_active, int m_bound, int window_r,
              float* __restrict__ out, Offsets offs, int B, bool vec) {
  constexpr int kPitch = DwWarpSmem<T>::kPitch;
  constexpr int kSeg = 16 / sizeof(T);  // elements of a 16-byte copy
  constexpr bool kMma = sizeof(T) == 2;
  extern __shared__ __align__(16) unsigned char smem_dw[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // this warp's piece of dw: offset k, channels c0.., outputs o0..
  const int n_c = (C + kWp - 1) / kWp;
  const int n_o = (CO + kWp - 1) / kWp;
  const int piece = blockIdx.y * kWarps + warp;
  if (piece >= K * n_c * n_o) return;  // warp-uniform; no block barriers
  const int k = piece / (n_c * n_o);
  const int c0 = (piece / n_o - k * n_c) * kWp;
  const int o0 = (piece % n_o) * kWp;
  const int cw = min(kWp, C - c0);
  const int ow = min(kWp, CO - o0);
  const int col = offs.col[k];
  const long long dkey = offs.dkey[col];
  unsigned char* mine = smem_dw + warp * DwWarpSmem<T>::bytes(window_r);
  T* xs = reinterpret_cast<T*>(mine);
  T* gs = xs + kWp * kPitch;
  int* m_row = reinterpret_cast<int*>(gs + kWp * kPitch);
  int* m_query = m_row + kTile;
  int* wkey = m_query + kTile;
  // bf16: two m16 tiles of channels x four n8 tiles of outputs,
  // acc[16 mi + 4 nj + e]; fp32: channel c of output o0 + lane, acc[c]
  float acc[kWp];
#pragma unroll
  for (int i = 0; i < kWp; ++i) acc[i] = 0.f;

  const int m_tiles = (M + kTile - 1) / kTile;
  const int n_live = count_live(r_active, B, m_bound, m_tiles);
  for (int g = blockIdx.x; g < n_live; g += gridDim.x) {
    int b, tile;
    live_tile(r_active, m_bound, m_tiles, g, b, tile);
    const long long m0 = (long long)tile * kTile;
    const int* meta_b = rq + (long long)b * (1 + nw) * M;
    // the window's keys (cp.async) and the lane's four queries' keys and
    // validity bits, all in flight together
    long long lo, end;
    window_rows(rs[((long long)b * n_tiles + tile) * K + col], window_r,
                n_out, lo, end);
    const int n_win = end > lo ? (int)(end - lo) : 0;
    const int* keys_b = keys_out + (long long)b * n_out + lo;
    for (int j = lane; j < n_win; j += 32) cp_async4(wkey + j, keys_b + j);
    cp_async_commit();
    long long q[kQ];
    bool live[kQ];
#pragma unroll
    for (int i = 0; i < kQ; ++i) {
      const long long mq = m0 + lane + 32 * i;
      live[i] = false;
      q[i] = 0;
      if (mq < M && mq < m_bound) {
        const int word = meta_b[(long long)(1 + (col >> 5)) * M + mq];
        live[i] = (word >> (col & 31)) & 1;
        q[i] = (long long)meta_b[mq] + dkey;
      }
    }
    cp_async_wait<0>();
    __syncwarp();
    int pos[kQ];
    find_keys_staged(wkey, n_win, q, pos);
    // the matched queries, compacted in query order
    int n_m = 0;
#pragma unroll
    for (int i = 0; i < kQ; ++i) {
      const bool on = live[i] && pos[i] >= 0;
      const unsigned hit = __ballot_sync(kFull, on);
      if (on) {
        const int j = n_m + __popc(hit & ((1u << lane) - 1u));
        m_row[j] = (int)(lo + pos[i]);
        m_query[j] = lane + 32 * i;
      }
      n_m += __popc(hit);
    }
    __syncwarp();
    const T* x_b = feats + (long long)b * M * C;
    const T* gy_b = gy + (long long)b * n_out * CO;
    for (int r0 = 0; r0 < n_m; r0 += kWp) {
      const int nr = min(kWp, n_m - r0);
      // 32 rows' pieces, zero past the piece's edge and past the matches
      if (vec) {  // C, CO multiples of kSeg, 16-byte aligned bases
        constexpr int segs = kWp / kSeg;
        for (int idx = lane; idx < kWp * segs; idx += 32) {
          const int r = idx / segs;
          const int e = (idx - r * segs) * kSeg;
          const bool xc = r < nr && e < cw, gc = r < nr && e < ow;
          cp_async16(xs + r * kPitch + e,
                     xc ? x_b + (m0 + m_query[r0 + r]) * C + c0 + e : feats,
                     xc ? 16 : 0);
          cp_async16(gs + r * kPitch + e,
                     gc ? gy_b + (long long)m_row[r0 + r] * CO + o0 + e : gy,
                     gc ? 16 : 0);
        }
        cp_async_commit();
        cp_async_wait<0>();
      } else {
        const T zero = from_f<T>(0.f);
        for (int r = 0; r < kWp; ++r) {
          const bool in = r < nr;
          xs[r * kPitch + lane] = in && lane < cw
              ? x_b[(m0 + m_query[r0 + r]) * C + c0 + lane] : zero;
          gs[r * kPitch + lane] = in && lane < ow
              ? gy_b[(long long)m_row[r0 + r] * CO + o0 + lane] : zero;
        }
      }
      __syncwarp();
      if constexpr (kMma) {
        for (int kk = 0; kk < nr; kk += 16) {  // depth: the matched rows
          unsigned a[2][4];  // X^T: channels 16 mi.., rows kk..
#pragma unroll
          for (int mi = 0; mi < 2; ++mi)
            ldsm_x4_t(a[mi], xs + (kk + (lane & 7) + ((lane >> 4) << 3))
                                      * kPitch
                                 + 16 * mi + (((lane >> 3) & 1) << 3));
#pragma unroll
          for (int np = 0; np < 2; ++np) {
            unsigned bb[4];  // G: rows kk.., outputs 16 np..
            ldsm_x4_t(bb, gs + (kk + (lane & 15)) * kPitch + np * 16
                              + ((lane >> 4) << 3));
#pragma unroll
            for (int mi = 0; mi < 2; ++mi) {
              float* d = acc + 16 * mi + 8 * np;
              mma_bf16(*reinterpret_cast<float(*)[4]>(d), a[mi], bb[0], bb[1]);
              mma_bf16(*reinterpret_cast<float(*)[4]>(d + 4), a[mi], bb[2],
                       bb[3]);
            }
          }
        }
      } else {
        for (int r = 0; r < nr; ++r) {  // in row order
          const float gv = to_f(gs[r * kPitch + lane]);
#pragma unroll
          for (int c = 0; c < kWp; ++c)
            acc[c] = fmaf(to_f(xs[r * kPitch + c]), gv, acc[c]);
        }
      }
      __syncwarp();  // the staged rows are rewritten next
    }
  }
  float* out_p = out + (long long)blockIdx.x * K * C * CO
      + ((long long)k * C + c0) * CO + o0;
#pragma unroll
  for (int i = 0; i < kWp; ++i) {
    // mma tile (mi, nj) = acc[16 mi + 4 nj ..]: rows lane / 4 (+ 8),
    // columns 2 (lane % 4) (+ 1)
    const int mi = i >> 4, nj = (i >> 2) & 3, e = i & 3;
    const int r = kMma ? 16 * mi + (lane >> 2) + 8 * (e >> 1) : i;
    const int o = kMma ? 8 * nj + 2 * (lane & 3) + (e & 1) : lane;
    if (r < cw && o < ow) out_p[(long long)r * CO + o] = acc[i];
  }
}

struct BwdArgs {
  const void *keys_out, *gy, *feats, *rq, *rs, *w_t, *r_active;
  void *dx, *dw, *part;
  int n_out, CO, C, nw, M, n_tiles, K, m_bound, window_r, B, groups, n_parts;
};

template <typename T>
int launch(const BwdArgs& a, const Offsets& offs, cudaStream_t st) {
  // dX: the conv of gy through the backward plan with w_t [K, CO, C]
  const Args conv{a.keys_out, a.gy, a.rq, a.rs, a.w_t, a.r_active, a.dx,
                  a.n_out, a.CO, a.nw, a.M, a.n_tiles, a.K, a.C, a.m_bound,
                  a.window_r, a.B, a.groups};
  int err = conv_launch<BwdDx, T>(conv, offs, st);
  if (err != 0) return err;
  // dW: a warp a piece of dw, summed over parts of the live tiles, then in
  // order
  const int pieces = a.K * ((a.C + kWp - 1) / kWp) * ((a.CO + kWp - 1) / kWp);
  const int groups = (pieces + kWarps - 1) / kWarps;
  if (groups > 65535) return (int)cudaErrorInvalidValue;
  const size_t smem = kWarps * DwWarpSmem<T>::bytes(a.window_r);
  cudaError_t e = fit_smem(bwd_dw_kernel<T>, smem);
  if (e != cudaSuccess) return (int)e;
  const bool vec = a.C % (16 / (int)sizeof(T)) == 0
      && a.CO % (16 / (int)sizeof(T)) == 0
      && ((uintptr_t)a.feats & 15) == 0 && ((uintptr_t)a.gy & 15) == 0;
  float* out = (float*)(a.n_parts == 1 ? a.dw : a.part);
  bwd_dw_kernel<T><<<dim3(a.n_parts, groups), kThreads, smem, st>>>(
      (const int*)a.keys_out, a.n_out, (const T*)a.gy, a.CO,
      (const T*)a.feats, a.C, (const int*)a.rq, a.nw, a.M,
      (const int*)a.rs, a.n_tiles, a.K, (const int*)a.r_active, a.m_bound,
      a.window_r, out, offs, a.B, vec);
  e = cudaGetLastError();
  if (e != cudaSuccess || a.n_parts == 1) return (int)e;
  return (int)ordered_sum((float*)a.dw, (const float*)a.part, a.n_parts,
                          (long long)a.K * a.C * a.CO, st);
}

}  // namespace

// keys_out i32[B, n_out] sorted; gy T[B, n_out, CO]; feats T[B, M, C];
// rq i32[B, 1+nw, M]; rs i32[B, n_tiles, K'] (K' >= every cols[k] + 1);
// w_t T[K, CO, C] (the weights transposed); r_active i32[B]; dx T[B, M, C]
// and dw f32[K, C, CO], both fully written.  groups (1..8): the blocks, one
// cluster, that share a tile's offsets in dX (window_conv's argument);
// part f32[n_parts, K * C * CO] scratch for dW's n_parts >= 1 warps a
// piece (unused when n_parts is 1).  dkeys and cols are HOST arrays of K
// ints.  Returns the launches' cudaError_t.
#define SEID_BWD_ENTRY(NAME, T)                                               \
  extern "C" int NAME(const void* keys_out, int n_out, const void* gy,        \
                      int CO, const void* feats, int C, const void* rq,       \
                      int nw, int M, const void* rs, int n_tiles, int K,      \
                      const void* w_t, const void* r_active, int m_bound,     \
                      int window_r, void* dx, void* dw, const int* dkeys,     \
                      const int* cols, int B, int groups, void* part,         \
                      int n_parts, void* stream) {                            \
    if (K > kMaxK || window_r < 0 || window_r > 32767 || n_parts < 1)         \
      return (int)cudaErrorInvalidValue;                                      \
    if (M <= 0 || B <= 0 || C <= 0 || CO <= 0) return (int)cudaGetLastError(); \
    Offsets offs;                                                             \
    fill_offsets(offs, dkeys, cols, K);                                       \
    const BwdArgs a{keys_out, gy, feats, rq, rs, w_t, r_active, dx, dw, part, \
                    n_out, CO, C, nw, M, n_tiles, K, m_bound, window_r, B,    \
                    groups, n_parts};                                         \
    return launch<T>(a, offs, (cudaStream_t)stream);                          \
  }

SEID_BWD_ENTRY(seid_window_bwd_f32, float)
SEID_BWD_ENTRY(seid_window_bwd_bf16, __nv_bfloat16)
