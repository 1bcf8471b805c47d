// Gather-GEMM sparse convolution over a rulebook:
//   out[b, m, :] = sum_k  feats[b, idx[b, m, k], :] @ W[k]
// where idx holds, per output row and kernel offset, the input row of the
// neighbour, and any value outside [0, N) is a miss that contributes
// nothing.  Accumulation is float32; the result is cast once to the
// feature type.  The backward's dX is the same call with the index columns
// mirrored and W transposed (ops/gather_conv.py).
//
// Replaces: sparseeventid_tpu/ops/pallas/gather_conv.py, gather_conv_single
// (Pallas kernel _gather_matmul_kernel), with the batch inside the kernel
// where the JAX package maps it over events.  The TPU kernel appends a zero
// row for misses and does one dot over K * C; here a miss is a zero row of
// the tile and the sum runs in another order, so the two agree bit for bit
// where float32 addition is exact (integer-valued data).
//
// Bound on the H100: bytes at the shallow levels (the index block alone is
// B * M * K ints, and the output B * M * CO values), operations where C and
// CO are wide and most offsets hit (2 * pairs * C * CO flops).
// Design, bf16 (gather_tc_kernel): the GEMM of the window conv
// (window_tc.cuh's tc_product and tc_store), fed by the rulebook instead
// of a window search.  One block of 8 warps per (event, 128-row tile,
// slab of up to 192 output columns), so at CO <= 192 each gathered row is
// read once per tile.  The block copies the tile's index block
// idx[b, m0 .. m0 + 128, :] (one contiguous span of 128 K ints) to shared
// memory with cp.async, 16 bytes at a time where aligned; one ballot per
// (offset, 32 rows) marks the misses and the offsets with any hit are
// listed (a tile with none writes zeros).  The listed offsets' depth
// (offsets x C, offset-major) is walked in 64-deep chunks through a
// cp.async ring: the tile's 128 gathered rows (16-byte copies, zero-filled
// at a miss) and the [64, slab] rows of W, then ldmatrix and
// mma.sync.m16n8k16 (bf16 in, fp32 accumulate) with a warp's 32 x slab/2
// accumulator in registers; each output value is written once.  At the
// deep levels, where few tiles would leave most SMs idle, G blocks (a
// thread-block cluster; the wrapper's gather_groups) take ceil(K / G)
// offsets each and add their fp32 partial tiles through distributed shared
// memory in the fixed order 0 .. G - 1: the same bits on every run.  C or
// CO not a multiple of 8, or unaligned bases, take the ring element by
// element.
// fp32 (gather_f32_kernel): float32 FMAs on the CUDA cores (TF32 would not
// keep engine_ops' exact checks), one block per (event, 128 rows, 32 output
// columns), rows and W staged 32 channels at a time, a 4 x 4 register
// tile a thread; exact on integer-valued fp32 data.

#include "window_tc.cuh"

namespace {

using namespace seid;

// The bf16 route.  Shared memory: the ring (the partial tile at the end),
// then the index block [kTile][K] (row r's entry k at r * K + k: -1 where
// it missed), the ballots [kg][kQ] and the list of slots with a hit.
template <int NT>
__global__ void __launch_bounds__(kThreads, NT <= 2 ? 3 : NT <= 6 ? 2 : 1)
gather_tc_kernel(const __nv_bfloat16* __restrict__ feats, int N, int C,
                 const int* __restrict__ idx, int M, int K,
                 const __nv_bfloat16* __restrict__ w, int CO,
                 __nv_bfloat16* __restrict__ out, int ring_bytes, bool vec,
                 int groups) {
  constexpr int kSlab = 16 * NT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int kg = (K + groups - 1) / groups;  // offsets a block takes
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  int* nbr = reinterpret_cast<int*>(smem_raw + ring_bytes);
  unsigned* hits = reinterpret_cast<unsigned*>(nbr + kTile * K);
  int* act = reinterpret_cast<int*>(hits + kg * kQ);

  const int tile = blockIdx.x;
  const int b = blockIdx.y;
  const int grp = blockIdx.z % groups;  // the block's rank in its cluster
  const int n0 = blockIdx.z / groups * kSlab;
  const int k0 = grp * kg;
  const int nk = min(kg, K - k0);
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const long long m0 = (long long)tile * kTile;
  const int n = (int)min((long long)kTile, M - m0) * K;

  // the index block: rows past M are misses
  const int* src = idx + ((long long)b * M + m0) * K;
  int n16 = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    n16 = n & ~3;
    for (int i = 4 * t; i < n16; i += 4 * kThreads)
      cp_async16(nbr + i, src + i, 16);
  }
  for (int i = n16 + t; i < n; i += kThreads) cp_async4(nbr + i, src + i);
  cp_async_commit();
  for (int i = n + t; i < kTile * K; i += kThreads) nbr[i] = -1;
  cp_async_wait<0>();
  __syncthreads();
  // the block's slots: an index outside [0, N) becomes -1, one ballot per
  // (slot, 32 rows); warp w takes slots w, w + 8, ...
  for (int k = warp; k < nk; k += kWarps) {
#pragma unroll
    for (int i = 0; i < kQ; ++i) {
      int* e = nbr + (lane + 32 * i) * K + k0 + k;
      const int v = *e;
      const bool hit = v >= 0 && v < N;
      if (!hit) *e = -1;
      const unsigned m = __ballot_sync(kFull, hit);
      if (lane == 0) hits[k * kQ + i] = m;
    }
  }
  __syncthreads();
  if (warp == 0) list_active(hits, nk, kg, act);
  __syncthreads();

  float acc[2][NT][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  tc_product<NT>(ring, act, act[kg], IndexRows{nbr + k0, K},
                 feats + (long long)b * N * C, feats, C, w, k0, CO, n0, vec,
                 acc);
  tc_store<NT>(acc, smem_raw, true, groups, grp, m0, M, b, CO, n0, out);
}

template <int NT>
int launch_gather_tc(const void* feats, int N, int C, const void* idx, int M,
                     int K, const void* w, int CO, void* out, int B,
                     int groups, cudaStream_t st) {
  const int slab = 16 * NT;
  groups = groups < 1 ? 1 : groups > 8 ? 8 : groups;
  const int kg = (K + groups - 1) / groups;
  const size_t ring_bytes = tc_ring_bytes<NT>(0);
  const size_t smem = ring_bytes
      + sizeof(int) * ((size_t)kTile * K + (size_t)kg * kQ + kg + 1);
  const bool vec = C % 8 == 0 && CO % 8 == 0
      && ((uintptr_t)feats & 15) == 0 && ((uintptr_t)w & 15) == 0;
  return (int)launch_clusters(
      gather_tc_kernel<NT>,
      dim3((M + kTile - 1) / kTile, B, (CO + slab - 1) / slab * groups), smem,
      groups, st, (const __nv_bfloat16*)feats, N, C, (const int*)idx, M, K,
      (const __nv_bfloat16*)w, CO, (__nv_bfloat16*)out, (int)ring_bytes, vec,
      groups);
}

// The fp32 route (kCo output columns a block, kCc channels a step).
__global__ void __launch_bounds__(kThreads)
gather_f32_kernel(const float* __restrict__ feats, int N, int C,
                  const int* __restrict__ idx, int M, int K,
                  const float* __restrict__ w, int CO, float* __restrict__ out) {
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
  const float* feats_b = feats + (long long)b * N * C;
  const int* idx_b = idx + (long long)b * M * K;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k = 0; k < K; ++k) {
    if (t < kTile) {
      int row = -1;
      if (m0 + t < M) {
        const int v = idx_b[(m0 + t) * K + k];
        if (v >= 0 && v < N) row = v;
      }
      nbr[t] = row;
    }
    const int any = __syncthreads_or(t < kTile && nbr[t] >= 0);
    if (!any) continue;  // uniform: no row of this tile has a neighbour at k
    const float* wk = w + (long long)k * C * CO;
    for (int c0 = 0; c0 < C; c0 += kCc) {
      const int cw = (C - c0) < kCc ? (C - c0) : kCc;
      for (int i = t; i < kTile * cw; i += kThreads) {
        const int r = i / cw;
        const int cc = i - r * cw;
        const int row = nbr[r];
        xs[r][cc] = row >= 0 ? feats_b[(long long)row * C + c0 + cc] : 0.f;
      }
      for (int i = t; i < cw * kCo; i += kThreads) {
        const int ci = i / kCo;
        const int oj = i - ci * kCo;
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

}  // namespace

// feats T[B, N, C]; idx i32[B, M, K] (a value outside [0, N) is a miss);
// w T[K, C, CO]; out T[B, M, CO] (fully written).  groups (1..8): the
// blocks, one cluster, that share a tile's offsets on the bf16 route (the
// fp32 route takes the tile in one block).  Returns the launch's
// cudaError_t; bf16 takes K <= 128.
extern "C" int seid_gather_conv_bf16(const void* feats, int N, int C,
                                     const void* idx, int M, int K,
                                     const void* w, int CO, void* out, int B,
                                     int groups, void* stream) {
  if (K > kMaxK) return (int)cudaErrorInvalidValue;
  if (M <= 0 || B <= 0 || CO <= 0) return (int)cudaGetLastError();
  return with_slab(CO, [&](auto nt) {
    return launch_gather_tc<decltype(nt)::value>(
        feats, N, C, idx, M, K, w, CO, out, B, groups, (cudaStream_t)stream);
  });
}

extern "C" int seid_gather_conv_f32(const void* feats, int N, int C,
                                    const void* idx, int M, int K,
                                    const void* w, int CO, void* out, int B,
                                    int groups, void* stream) {
  (void)groups;
  const int m_tiles = (M + kTile - 1) / kTile;
  if (m_tiles > 0 && B > 0 && CO > 0) {
    dim3 grid(m_tiles, B, (CO + kCo - 1) / kCo);
    gather_f32_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)feats, N, C, (const int*)idx, M, K, (const float*)w, CO,
        (float*)out);
  }
  return (int)cudaGetLastError();
}
