// Exact k-nearest-neighbour indices of a batch of point clouds, for the
// dynamic graph CNN's edge convs (models/dgcnn.py):
//   seid_knn_topk_f32: x f32[N, P, F] (F a multiple of 4), mask u8[N, P]
//   -> idx i64[N, P, k], each point's k nearest points of its own cloud,
//   itself included, by squared euclidean distance in float32
//       direct:    d(i, j) = sum_f (x_if - x_jf)^2          (F <= 16)
//       expanded:  d(i, j) = (|x_i|^2 - 2 <x_i, x_j>) + |x_j|^2
//   a padded candidate at d = 1e9, ascending by distance and, among equal
//   distances, by index: the rule of ops/knn_kernels.knn_topk_plain (the
//   same distances and a stable sort of the whole row), with which it
//   agrees exactly wherever every sum is exact, as on integer-valued
//   inputs.  A cloud with fewer than k valid points fills its rows with the
//   lowest padded indices.  Narrow clouds (the first stage's coordinates up
//   to 1280 and charge) take the direct form: there the expansion rounds
//   |x|^2 ~ 3e6 to 0.25, and picks among near-tied neighbours by it.
//
// Replaces no TPU kernel: the JAX package's knn_indices (sparseeventid_tpu/
// models/dgcnn.py) is an einsum and lax.top_k that XLA lowers.  The port's
// PyTorch version built the whole float32 distance matrix [N, P, P] and
// stable-sorted every row of it (2 GiB of distances and a 4 GiB int64 index
// tensor a stage at P = 8192, N = 8).
//
// Bound on the H100: operations (2 P^2 F a cloud in float32 FMAs outside
// the tensor cores, against P F reads), plus the compares of the selection.
// Design: a block is kQueries threads, one query each, the query features
// held in shared memory transposed [F][kQueries + 1] (a thread reads its own
// column without bank conflicts).  The candidates stream through shared
// memory kTile at a time, rows of F + 4 floats (16-byte aligned for the
// broadcast float4 reads, conflict-free for the norm pass); each thread
// keeps kTile dot products (direct: sums of squared differences) in
// registers, accumulated in feature order, and its K best (distance,
// index) pairs in registers, sorted, inserting a candidate only when it
// beats the K-th.  Candidates arrive in ascending
// index order and an equal distance never displaces an earlier one, so ties
// keep the lower index.  No P x P tensor is written; the output is the only
// store.  K is a template (the smallest of 8, 16, 20, 32 that holds k).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kQueries = 128;  // threads a block, one query each
constexpr int kTile = 32;      // candidates a tile (dot products a thread)
constexpr int kDirectFeatures = 16;  // at most this many: the direct form

template <int K, bool kDirect>
__global__ void __launch_bounds__(kQueries)
knn_topk_kernel(const float* __restrict__ x, const uint8_t* __restrict__ mask,
                int P, int F, int k, int64_t* __restrict__ out) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int cstride = F + 4;                 // a candidate row, in floats
  float* cs = smem;                          // [kTile][F + 4]
  float* csq = cs + kTile * cstride;         // [kTile] squared norms
  float* cpen = csq + kTile;                 // [kTile] 0 valid, 1 padded, 2 none
  float* qs = cpen + kTile;                  // [F][kQueries + 1]
  const int qstride = kQueries + 1;

  const int n = blockIdx.y;
  const int q0 = blockIdx.x * kQueries;
  const int t = threadIdx.x;
  const int q = q0 + t;
  const float* xe = x + (size_t)n * P * F;
  const uint8_t* me = mask + (size_t)n * P;

  // the block's queries, transposed; the thread's own squared norm (unused
  // by the direct form)
  for (int e = t; e < kQueries * F; e += kQueries) {
    const int qi = e / F, f = e - qi * F;
    qs[f * qstride + qi] = (q0 + qi < P) ? xe[(size_t)(q0 + qi) * F + f] : 0.f;
  }
  __syncthreads();
  float sqi = 0.f;
  for (int f = 0; f < F; ++f) {
    const float v = qs[f * qstride + t];
    sqi += v * v;
  }

  float best[K];
  int bidx[K];
#pragma unroll
  for (int s = 0; s < K; ++s) {
    best[s] = INFINITY;
    bidx[s] = 0x7fffffff;
  }

  const int f4s = F / 4;
  for (int j0 = 0; j0 < P; j0 += kTile) {
    // the tile's candidate rows, float4 by float4
    for (int e = t; e < kTile * f4s; e += kQueries) {
      const int r = e / f4s, c4 = e - r * f4s;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (j0 + r < P)
        v = reinterpret_cast<const float4*>(xe + (size_t)(j0 + r) * F)[c4];
      reinterpret_cast<float4*>(cs + r * cstride)[c4] = v;
    }
    __syncthreads();
    if (t < kTile && !kDirect) {
      const float4* row = reinterpret_cast<const float4*>(cs + t * cstride);
      float s = 0.f;
      for (int c4 = 0; c4 < f4s; ++c4) {
        const float4 v = row[c4];
        s += v.x * v.x;
        s += v.y * v.y;
        s += v.z * v.z;
        s += v.w * v.w;
      }
      csq[t] = s;
    }
    if (t < kTile) cpen[t] = (j0 + t >= P) ? 2.f : (me[j0 + t] ? 0.f : 1.f);
    __syncthreads();

    float acc[kTile];
#pragma unroll
    for (int j = 0; j < kTile; ++j) acc[j] = 0.f;
#pragma unroll 2
    for (int c4 = 0; c4 < f4s; ++c4) {
      const float a0 = qs[(4 * c4 + 0) * qstride + t];
      const float a1 = qs[(4 * c4 + 1) * qstride + t];
      const float a2 = qs[(4 * c4 + 2) * qstride + t];
      const float a3 = qs[(4 * c4 + 3) * qstride + t];
#pragma unroll
      for (int j = 0; j < kTile; ++j) {
        const float4 c = reinterpret_cast<const float4*>(cs + j * cstride)[c4];
        float a = acc[j];
        if (kDirect) {
          const float e0 = a0 - c.x, e1 = a1 - c.y, e2 = a2 - c.z,
                      e3 = a3 - c.w;
          a = fmaf(e0, e0, a);
          a = fmaf(e1, e1, a);
          a = fmaf(e2, e2, a);
          a = fmaf(e3, e3, a);
        } else {
          a = fmaf(a0, c.x, a);
          a = fmaf(a1, c.y, a);
          a = fmaf(a2, c.z, a);
          a = fmaf(a3, c.w, a);
        }
        acc[j] = a;
      }
    }

#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      const float pen = cpen[j];
      float d = kDirect ? acc[j]
                        : __fadd_rn(__fsub_rn(sqi, 2.f * acc[j]), csq[j]);
      if (pen != 0.f) d = pen == 1.f ? 1e9f : INFINITY;
      if (d < best[K - 1]) {
        const int jj = j0 + j;
#pragma unroll
        for (int s = K - 1; s > 0; --s) {
          if (d < best[s - 1]) {
            best[s] = best[s - 1];
            bidx[s] = bidx[s - 1];
          } else if (d < best[s]) {
            best[s] = d;
            bidx[s] = jj;
          }
        }
        if (d < best[0]) {
          best[0] = d;
          bidx[0] = jj;
        }
      }
    }
    __syncthreads();  // the tile is read by all before the next overwrites it
  }

  if (q < P) {
    int64_t* o = out + ((size_t)n * P + q) * k;
#pragma unroll
    for (int s = 0; s < K; ++s)
      if (s < k) o[s] = bidx[s];
  }
}

template <int K, bool kDirect>
int launch_as(const float* x, const uint8_t* mask, int N, int P, int F, int k,
              int64_t* out, cudaStream_t stream) {
  const size_t bytes =
      sizeof(float) * ((size_t)kTile * (F + 4) + 2 * kTile +
                       (size_t)F * (kQueries + 1));
  cudaError_t err = cudaFuncSetAttribute(
      knn_topk_kernel<K, kDirect>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((P + kQueries - 1) / kQueries, N);
  knn_topk_kernel<K, kDirect><<<grid, kQueries, bytes, stream>>>(
      x, mask, P, F, k, out);
  return (int)cudaGetLastError();
}

template <int K>
int launch(const float* x, const uint8_t* mask, int N, int P, int F, int k,
           int64_t* out, cudaStream_t stream) {
  return F <= kDirectFeatures
             ? launch_as<K, true>(x, mask, N, P, F, k, out, stream)
             : launch_as<K, false>(x, mask, N, P, F, k, out, stream);
}

}  // namespace

extern "C" int seid_knn_topk_f32(const void* x, const void* mask, int N,
                                 int P, int F, int k, void* out,
                                 void* stream) {
  const float* xp = static_cast<const float*>(x);
  const uint8_t* mp = static_cast<const uint8_t*>(mask);
  int64_t* op = static_cast<int64_t*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N <= 0 || P <= 0) return 0;
  if (k < 1 || k > 32 || k > P || F < 4 || F % 4) return (int)cudaErrorInvalidValue;
  if (k <= 8) return launch<8>(xp, mp, N, P, F, k, op, s);
  if (k <= 16) return launch<16>(xp, mp, N, P, F, k, op, s);
  if (k <= 20) return launch<20>(xp, mp, N, P, F, k, op, s);
  return launch<32>(xp, mp, N, P, F, k, op, s);
}
