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
// at most, the useful bytes are a few MB, so a call is its latency: a few
// dependent rounds of loads and the launches.
// Design: a persistent grid of n_parts x pieces blocks, sized by the
// wrapper from the SM count and the shape (kernels._ov_dw_parts), never by
// the list's capacity.  Each block reads n_bound on the device, numbers
// the walked entries of all events in order (event-major, list order) and
// takes the p-th of n_parts equal runs of them.  A piece is a range of
// offsets and input channels, [kr, cr, CO] of dw, held in shared memory as
// float32 (at most 16 KB, kernels._ov_dw_piece).  The threads form groups
// (a power of two; one warp a group where a [cr, CO] panel is small, as at
// C = 1); group g owns the piece's offsets g, g + G, ... (dealt round, as
// a list's entries crowd onto neighbouring offsets), and in each of them
// every thread of the group owns 4 outputs (one at the recipes' shallow
// widths).  The block walks its run 256 entries at a time: the valid
// entries whose offset lies in the piece are bucketed by a stable counting
// sort (match_any ranks inside a warp, a scan over the offsets), so each
// group's entries lie together, by offset and in list order; their x and
// gy rows are staged in shared memory in the feature type, every 16-byte
// cp.async of a sub-batch in flight at once (value by value where C or CO
// are not multiples of 16 bytes); then each thread sums its outputs over
// an offset's run of entries in registers, in list order, and adds the
// run to the piece.  Each block stores its piece once, to row p of a
// float32 scratch [n_parts, K * C * CO] (dw itself when n_parts is 1), and
// ordered_sum_kernel adds the rows in the order p = 0, 1, ...  No atomics:
// for a given card and shape dw is the same bits on every run.

#include "window_tc.cuh"

namespace {

using namespace seid;

constexpr int kBatch = kThreads;   // list entries filtered per round
constexpr int kPieceFloats = 4096; // shared-memory dw of a block
constexpr int kRowBytes = 24576;   // staged x and gy rows of a block
constexpr int kMaxQuads = kPieceFloats / 4 / kThreads;  // a thread's, 4

// Shared memory: the piece (float32, rows padded to cop = round4(CO)), the
// staged rows in the feature type (x: xp = cr rounded up to a 16-byte
// copy; gy: gp = CO rounded up to 16 bytes and to 4), the selected entries
// (x row, gy row, offset in the piece), the events' first walked entry
// numbers and the warps' counts.
template <typename T>
struct OvSmem {
  static constexpr int kSeg = 16 / sizeof(T);
  int kr, cr, cop, xp, gp, sb;
  __host__ __device__ OvSmem(int kr_, int cr_, int co)
      : kr(kr_), cr(cr_), cop((co + 3) & ~3),
        xp((cr_ + kSeg - 1) / kSeg * kSeg),
        gp((co + kSeg - 1) / kSeg * kSeg), sb(0) {
    if (gp < cop) gp = cop;
    sb = kRowBytes / (int)((xp + gp) * sizeof(T));
    if (sb > kBatch) sb = kBatch;
  }
  __host__ __device__ int piece() const { return kr * cr * cop; }
  __host__ __device__ size_t bytes(int B) const {
    return sizeof(float) * (size_t)piece()
        + sizeof(T) * (size_t)sb * (xp + gp)
        + sizeof(long long) * (2 * (size_t)kBatch + B + 1)
        + sizeof(int) * (kBatch + (kThreads / 32 + 1) * (kr + kThreads / 32) + 1
                         + kThreads / 32);
  }
};

// four consecutive values of T in shared memory (8- or 16-byte aligned)
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  // a bf16 is the high half of its float32
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(v.x << 16),
                     __uint_as_float(v.x & 0xffff0000u),
                     __uint_as_float(v.y << 16),
                     __uint_as_float(v.y & 0xffff0000u));
}

// n values of a row (src) to shared memory (dst), segment s of kSeg: a
// 16-byte cp.async where vec (zero-filled past n), else value by value
template <typename T>
__device__ __forceinline__ void stage_seg(T* dst, const T* src, int n, int s,
                                          bool vec) {
  constexpr int kSeg = 16 / sizeof(T);
  const int e = s * kSeg;
  if (vec) {
    const int bytes = (int)sizeof(T) * max(0, min(kSeg, n - e));
    cp_async16(dst + e, bytes ? src + e : src, bytes);
  } else {
#pragma unroll
    for (int i = 0; i < kSeg; ++i)
      dst[e + i] = e + i < n ? src[e + i] : from_f<T>(0.f);
  }
}

// QJ: the most quads a thread owns, 1 where a group's width covers the
// panel (every recipe list but the deep levels'), else kMaxQuads
template <typename T, int QJ>
__global__ void __launch_bounds__(kThreads, 2)
overflow_dw_kernel(float* __restrict__ out, int K,
                   const T* __restrict__ x, int N, int C,
                   const T* __restrict__ gy, int M, int CO,
                   const int* __restrict__ src, const int* __restrict__ dst,
                   const int* __restrict__ kk,
                   const uint8_t* __restrict__ valid,
                   const int* __restrict__ n_bound, int S, int B, int kr,
                   int cr, bool vx, bool vg) {
  const OvSmem<T> sm(kr, cr, CO);
  extern __shared__ __align__(16) unsigned char smem_ov[];
  float* acc = reinterpret_cast<float*>(smem_ov);  // [kr][cr][cop]
  T* xs = reinterpret_cast<T*>(acc + sm.piece());  // [sb][xp]
  T* gs = xs + sm.sb * sm.xp;                      // [sb][gp]
  long long* e_x = reinterpret_cast<long long*>(gs + sm.sb * sm.gp);
  long long* e_g = e_x + kBatch;
  long long* ev0 = e_g + kBatch;  // [B + 1] first entry number of event b
  int* e_k = reinterpret_cast<int*>(ev0 + B + 1);
  int* hist = e_k + kBatch;  // [warp][key] entries, then their prefix
  int* kstart = hist + kWarps * (kr + kWarps);  // [key] its first row
  int* wsum = kstart + kr + kWarps + 1;  // [kWarps] for the scan over keys
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  // the piece: offsets k0.., channels c0..
  const int n_cr = (C + cr - 1) / cr;
  const int k0 = blockIdx.y / n_cr * kr;
  const int c0 = blockIdx.y % n_cr * cr;
  const int nk = min(kr, K - k0);
  const int nc = min(cr, C - c0);
  // thread groups (powers of two): group g owns the offsets kl = g,
  // g + n_groups, ... of the piece (dealt round, as a list's entries
  // crowd onto neighbouring offsets), and in each its thread i the quads
  // q = i, i + width, ... of the [cr, cop] panel (4 outputs a quad).  The
  // sort key of offset kl puts a group's offsets next to each other:
  // key = (kl % n_groups) kpg + kl / n_groups.
  const int quads = cr * sm.cop / 4;
  int width = 32;
  while (width < quads && width < kThreads) width *= 2;
  const int n_groups = kThreads / width;
  const int grp = t / width;
  const int gi = t % width;
  const int kpg = (nk + n_groups - 1) / n_groups;
  const int n_keys = n_groups * kpg;  // < nk + n_groups
  const int lg = __ffs(n_groups) - 1;
  const int xsegs = sm.xp / OvSmem<T>::kSeg;
  const int segs = xsegs + sm.gp / OvSmem<T>::kSeg;
  const int cop = sm.cop, xp = sm.xp, gp = sm.gp;
  // the thread's quads q = gi + j width: channel, output, place in a panel
  int q_c[QJ], q_o[QJ];
  int n_q = 0;
#pragma unroll
  for (int j = 0; j < QJ; ++j) {
    const int q = gi + j * width;
    q_c[j] = q / (cop / 4);
    q_o[j] = (q - q_c[j] * (cop / 4)) * 4;
    n_q += q < quads;
  }

  for (int i = t; i < sm.piece(); i += kThreads) acc[i] = 0.f;
  if (t == 0) {
    long long run = 0;
    for (int b = 0; b < B; ++b) {
      ev0[b] = run;
      run += max(0, min(n_bound[b], S));
    }
    ev0[B] = run;
  }
  __syncthreads();
  const long long total = ev0[B];
  const long long beg = total * blockIdx.x / gridDim.x;
  const long long fin = total * (blockIdx.x + 1) / gridDim.x;
  for (long long base = beg; base < fin; base += kBatch) {
    // this round's entries of the piece
    const long long n = base + t;
    int kl = -1;
    long long xr = 0, gr = 0;
    if (n < fin) {
      int lo = 0, hi = B;  // the event b with ev0[b] <= n < ev0[b + 1]
      while (hi - lo > 1) {
        const int mid = (lo + hi) >> 1;
        if (ev0[mid] <= n) lo = mid; else hi = mid;
      }
      const long long s = (long long)lo * S + (n - ev0[lo]);
      const bool v = valid[s];
      const int sv = src[s], dv = dst[s], kv = kk[s];
      if (v && sv >= 0 && sv < N && dv >= 0 && dv < M && kv >= k0
          && kv < k0 + nk) {
        kl = kv - k0;
        xr = (long long)lo * N + sv;
        gr = (long long)lo * M + dv;
      }
    }
    // a stable counting sort by key: the rows of a key follow those of the
    // keys before it, in list order
    const int key = kl >= 0 ? ((kl & (n_groups - 1)) * kpg + (kl >> lg)) : -1;
    const int i = bucket_place(key, n_keys, hist, kstart, wsum);
    if (i >= 0) {
      e_k[i] = kl;
      e_x[i] = xr;
      e_g[i] = gr;
    }
    const int n_sel = kstart[n_keys];
    const int g_lo = kstart[grp * kpg], g_hi = kstart[(grp + 1) * kpg];
    __syncthreads();
    for (int r0 = 0; r0 < n_sel; r0 += sm.sb) {
      const int nr = min(sm.sb, n_sel - r0);
      // the rows' x channels c0.. and gy rows, all copies in flight at once
      for (int idx = t; idx < nr * segs; idx += kThreads) {
        const int r = idx / segs;
        const int sg = idx - r * segs;
        if (sg < xsegs)
          stage_seg(xs + r * xp, x + e_x[r0 + r] * C + c0, nc, sg, vx);
        else
          stage_seg(gs + r * gp, gy + e_g[r0 + r] * CO, CO, sg - xsegs, vg);
      }
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      // this thread group's rows of the sub-batch, by offset and in list
      // order: each offset's run summed in registers, then added to the
      // piece
      float4 run[QJ];
      int cur = -1;
      for (int r = max(g_lo, r0) - r0; r < min(g_hi, r0 + nr) - r0; ++r) {
        const int k = e_k[r0 + r];
        if (k != cur) {  // uniform in the group
          if (cur >= 0) {
            float* acc_k = acc + cur * cr * cop;
#pragma unroll
            for (int j = 0; j < QJ; ++j)
              if (j < n_q) {
                float4* a =
                    reinterpret_cast<float4*>(acc_k + q_c[j] * cop + q_o[j]);
                float4 v = *a;
                v.x += run[j].x; v.y += run[j].y;
                v.z += run[j].z; v.w += run[j].w;
                *a = v;
              }
          }
          cur = k;
#pragma unroll
          for (int j = 0; j < QJ; ++j)
            run[j] = make_float4(0.f, 0.f, 0.f, 0.f);
        }
        const T* xr_s = xs + r * xp;
        const T* gr_s = gs + r * gp;
#pragma unroll
        for (int j = 0; j < QJ; ++j)
          if (j < n_q) {
            const float xv = to_f(xr_s[q_c[j]]);
            const float4 g = load4(gr_s + q_o[j]);
            run[j].x = fmaf(xv, g.x, run[j].x);
            run[j].y = fmaf(xv, g.y, run[j].y);
            run[j].z = fmaf(xv, g.z, run[j].z);
            run[j].w = fmaf(xv, g.w, run[j].w);
          }
      }
      if (cur >= 0) {
        float* acc_k = acc + cur * cr * cop;
#pragma unroll
        for (int j = 0; j < QJ; ++j)
          if (j < n_q) {
            float4* a =
                reinterpret_cast<float4*>(acc_k + q_c[j] * cop + q_o[j]);
            float4 v = *a;
            v.x += run[j].x; v.y += run[j].y;
            v.z += run[j].z; v.w += run[j].w;
            *a = v;
          }
      }
      __syncthreads();  // the staged rows and entries are rewritten next
    }
  }
  // the piece, once, to row blockIdx.x of the partials
  float* out_p = out + (long long)blockIdx.x * K * C * CO;
  for (int i = t; i < nk * nc * CO; i += kThreads) {
    const int k = i / (nc * CO);
    const int c = (i - k * nc * CO) / CO;
    const int o = i - k * nc * CO - c * CO;
    out_p[((long long)(k0 + k) * C + c0 + c) * CO + o] =
        acc[(k * cr + c) * cop + o];
  }
}

template <typename T>
int launch(void* dw, int K, const void* x, int N, int C, const void* gy,
           int M, int CO, const void* src, const void* dst, const void* kk,
           const void* valid, const void* n_bound, int S, int B, void* part,
           int n_parts, int kr, int cr, void* stream) {
  if (K > kMaxK || n_parts < 1 || kr < 1 || cr < 1 || cr > C)
    return (int)cudaErrorInvalidValue;
  const OvSmem<T> sm(kr, cr, CO);
  if (sm.piece() > kPieceFloats || sm.sb < 1) return (int)cudaErrorInvalidValue;
  const long long n = (long long)K * C * CO;
  if (B <= 0 || n <= 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  const size_t smem = sm.bytes(B);
  cudaError_t err;
  // 16-byte copies: rows and pieces start on 16 bytes
  constexpr int kSeg = OvSmem<T>::kSeg;
  const bool vx = C % kSeg == 0 && (cr % kSeg == 0 || cr >= C)
      && ((uintptr_t)x & 15) == 0;
  const bool vg = CO % kSeg == 0 && ((uintptr_t)gy & 15) == 0;
  const int pieces = (K + kr - 1) / kr * ((C + cr - 1) / cr);
  if (pieces > 65535) return (int)cudaErrorInvalidValue;
  float* out = (float*)(n_parts == 1 ? dw : part);
  auto kernel = cr * sm.cop / 4 <= kThreads ? overflow_dw_kernel<T, 1>
                                             : overflow_dw_kernel<T, kMaxQuads>;
  err = fit_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(n_parts, pieces), kThreads, smem, st>>>(
      out, K, (const T*)x, N, C, (const T*)gy, M, CO, (const int*)src,
      (const int*)dst, (const int*)kk, (const uint8_t*)valid,
      (const int*)n_bound, S, B, kr, cr, vx, vg);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_parts == 1) return (int)err;
  return (int)ordered_sum((float*)dw, (const float*)part, n_parts, n, st);
}

}  // namespace

// dw f32[K, C, CO], fully written; x T[B, N, C]; gy T[B, M, CO]; src, dst,
// kk i32[B, S]; valid u8[B, S] (torch bool); n_bound i32[B] entries to walk
// per batch element; part f32[n_parts, K * C * CO] scratch for the n_parts
// runs of the walked entries (unused when n_parts is 1); a block's piece of
// dw is kr offsets x cr input channels x CO (kr * cr * round4(CO) <= 4096).
// Returns the launches' cudaError_t.
#define SEID_OV_DW_ENTRY(NAME, T)                                             \
  extern "C" int NAME(void* dw, int K, const void* x, int N, int C,           \
                      const void* gy, int M, int CO, const void* src,         \
                      const void* dst, const void* kk, const void* valid,     \
                      const void* n_bound, int S, int B, void* part,          \
                      int n_parts, int kr, int cr, void* stream) {            \
    return launch<T>(dw, K, x, N, C, gy, M, CO, src, dst, kk, valid,          \
                     n_bound, S, B, part, n_parts, kr, cr, stream);           \
  }

SEID_OV_DW_ENTRY(seid_overflow_dw_f32, float)
SEID_OV_DW_ENTRY(seid_overflow_dw_bf16, __nv_bfloat16)
