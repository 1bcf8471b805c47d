// The dynamic graph CNN's edge convolution after its neighbour search
// (models/dgcnn.EdgeConv through ops/edge_conv_kernels.edge_conv), float32,
// with no [N, P, k, C] edge tensor in device memory:
//   seid_edge_conv_fwd_f32: edge_select_kernel + edge_sum_kernel +
//     edge_apply_kernel.  ab f32[N, P, 2C] = [A, Bp] (A = x W_d^T, Bp =
//     x (W_i - W_d)^T, one matrix product by the wrapper), idx i64[N, P, k]
//     (neighbours in the point's own cloud), mask u8[N, P].  An edge is
//     h = A[j] + Bp[i], added in registers.  The select pass keeps per
//     valid point and channel max_k h where scale >= 0 and min_k h where
//     scale < 0 (the normalised, scaled, offset leaky ReLU is monotone in h
//     through every rounding, so its max over the edges is its value at
//     that extreme), and, in training, the block's float64 sums of h and
//     h^2 over the valid edges and their count; the sum pass adds the
//     blocks' rows in a fixed order; the apply pass forms mean, var and
//     rstd, moves the running averages (block 0) and writes
//     out = leaky(((extreme - mean) rstd) scale + offset), 0 at the padded
//     points, and saved [mean, rstd, gate, count].
//   seid_edge_conv_bwd_f32: edge_bwd_reduce_kernel + edge_sum_kernel +
//     edge_bwd_point_kernel + edge_bwd_scatter_kernel + edge_bwd_join_kernel.
//     The reduce pass recomputes every edge of a valid point, finds the
//     edges whose y equals the output (the max's gradient is split evenly
//     among them, torch.amax's rule), and writes per point and channel the
//     share g = dy / ties, the sum of the edges' shares through the leaky
//     ReLU (dn) and the sum of xhat over the k edges, and the block's
//     float64 sums of dn and dn xhat.  With a = scale rstd, c1 = -a (sum dn)
//     / count and c2 = -a gate (sum dn xhat) / count (0 and 0 in eval mode),
//     an edge's gradient is dh = a dn + c1 + c2 xhat; the point pass writes
//     dBp = a (sum_k dn) + k c1 + c2 (sum_k xhat) per point, and dA, the
//     sum of dh over the edges pointing at a point, is taken from the
//     wrapper's reverse index (a stable sort of the neighbour lists) in
//     edge order: the scatter pass cuts it into chunks of a fixed number of
//     edges, one a group, so that a point many edges point at (a hub of
//     the graph) is shared among groups, and writes the points whose edges
//     lie in one chunk; the join pass adds the chunks' partial sums of the
//     others, in chunk order.  No float atomics: the same bits every run.
// Every rounding is an explicit _rn intrinsic, so the forward, the backward
// and the plain version (ops/edge_conv_kernels) round each edge alike and
// the backward's ties are the forward's.
//
// Replaces no TPU kernel: the JAX package's edge features, Dense, batch
// norm, leaky ReLU and max (sparseeventid_tpu/models/dgcnn.py) are jnp that
// XLA fuses.  The port's PyTorch composition of them wrote and kept the
// [N, P, k, 2F] edge features and several [N, P, k, C] float32 edge tensors
// a stage (1.34 GB each at N = 8, P = 8192, k = 20, C = 256) and ran some
// twenty elementwise and reduce passes over them, forward and backward.
//
// Bound on the H100: bytes.  Per stage the forward reads k rows of A a
// valid point (gathered, C floats each) and writes [N, P, C] twice; the
// backward reads k rows of A a point in the reduce pass, and, for each
// edge, the source's Bp, output and share rows in the scatter pass.
// Design: as csrc/masked_norm.cu, a block is lanes (C / 4) x groups
// threads, a thread owning 4 consecutive channels (one 16-byte access) of
// every groups-th point of the block's run of points (a fixed partition
// from the wrapper), or of one chunk of edges, its per-channel constants in
// registers; a gathered row is read by the lanes of one group together, so
// each gather is coalesced.  C % 4 != 0 takes one channel a thread.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // threads a block at most: lanes x groups
constexpr int kSumCols = 32;   // edge_sum_kernel: columns a block
constexpr int kSumRows = 8;    // edge_sum_kernel: partial rows read at once

template <int V>
__device__ __forceinline__ void load_vec(const float* __restrict__ p,
                                         float (&v)[V]) {
  if constexpr (V == 4) {
    const float4 r = *reinterpret_cast<const float4*>(p);
    v[0] = r.x;
    v[1] = r.y;
    v[2] = r.z;
    v[3] = r.w;
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = p[i];
  }
}

template <int V>
__device__ __forceinline__ void store_vec(float* __restrict__ p,
                                          const float (&v)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) p[i] = v[i];
  }
}

// flax's leaky ReLU: slope 1 at 0
__device__ __forceinline__ float leaky(float v, float slope) {
  return v >= 0.f ? v : __fmul_rn(slope, v);
}

// the normalised edge and its pre-activation, rounded as the plain version
__device__ __forceinline__ void transform(float h, float mu, float rs,
                                          float sc, float of, float& xhat,
                                          float& pre) {
  xhat = __fmul_rn(__fsub_rn(h, mu), rs);
  pre = __fadd_rn(__fmul_rn(xhat, sc), of);
}

// The block's per-thread float64 sums a[V], b[V] (channels lane * V ...)
// and, with extra, the count of thread 0 of each group, over its groups in
// group order, to row blockIdx.x of part [grid, 2C (+ 1)].
template <int V>
__device__ __forceinline__ void block_sums(double* sh, const double (&a)[V],
                                           const double (&b)[V], double cnt,
                                           int extra, int c, int lane, int g,
                                           int groups,
                                           double* __restrict__ part) {
  const int width = 2 * c + extra;
  double* mine = sh + (long long)g * width;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    mine[lane * V + i] = a[i];
    mine[c + lane * V + i] = b[i];
  }
  if (extra && lane == 0) mine[2 * c] = cnt;
  __syncthreads();
  double* row = part + (long long)blockIdx.x * width;
  for (int j = threadIdx.x; j < width; j += blockDim.x) {
    double acc = 0.0;
    for (int k = 0; k < groups; ++k) acc = __dadd_rn(acc, sh[k * width + j]);
    row[j] = acc;
  }
}

template <int V>
__global__ void __launch_bounds__(kThreads)
    edge_select_kernel(const float* __restrict__ ab,
                       const int64_t* __restrict__ idx,
                       const uint8_t* __restrict__ mask, int P, int C, int K,
                       long long total, int per_block,
                       const float* __restrict__ scale, int stats,
                       float* __restrict__ chosen,
                       double* __restrict__ part) {
  extern __shared__ double shd[];  // [groups][2C + 1]
  const int lanes = C / V, groups = blockDim.x / lanes;
  const int lane = threadIdx.x % lanes, g = threadIdx.x / lanes;
  const int c0 = lane * V;
  const long long lo = (long long)blockIdx.x * per_block;
  const long long hi = lo + per_block < total ? lo + per_block : total;
  bool up[V];
  double s1[V], s2[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    up[i] = scale[c0 + i] >= 0.f;
    s1[i] = s2[i] = 0.0;
  }
  double cnt = 0.0;
  const long long row = 2LL * C;
  for (long long r = lo + g; r < hi; r += groups) {
    if (!mask[r]) continue;
    const long long base = r / P * P;
    const int64_t* nb = idx + r * K;
    float bp[V], best[V];
    load_vec<V>(ab + r * row + C + c0, bp);
#pragma unroll 4
    for (int s = 0; s < K; ++s) {
      float a[V];
      load_vec<V>(ab + (base + nb[s]) * row + c0, a);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float h = __fadd_rn(a[i], bp[i]);
        if (s == 0 || (up[i] ? h > best[i] : h < best[i])) best[i] = h;
        if (stats) {
          const double hd = h;  // h * h is exact in float64
          s1[i] = __dadd_rn(s1[i], hd);
          s2[i] = __dadd_rn(s2[i], __dmul_rn(hd, hd));
        }
      }
    }
    store_vec<V>(chosen + r * C + c0, best);
    cnt = __dadd_rn(cnt, (double)K);
  }
  if (stats) block_sums<V>(shd, s1, s2, cnt, 1, C, lane, g, groups, part);
}

// out[j] = the sum over p = 0, 1, ... of part[p, j] in float64, in a fixed
// order (thread t of a column sums the rows t, t + 8, ... in order, then
// the 8 sums are added in order)
__global__ void __launch_bounds__(kSumCols* kSumRows)
    edge_sum_kernel(const double* __restrict__ part, int parts, int width,
                    double* __restrict__ out) {
  __shared__ double sh[kSumRows][kSumCols + 1];
  const int tx = threadIdx.x % kSumCols, ty = threadIdx.x / kSumCols;
  const int j = blockIdx.x * kSumCols + tx;
  double acc = 0.0;
  if (j < width)
    for (int p = ty; p < parts; p += kSumRows)
      acc = __dadd_rn(acc, part[(long long)p * width + j]);
  sh[ty][tx] = acc;
  __syncthreads();
  if (ty == 0 && j < width) {
    double s = 0.0;
    for (int k = 0; k < kSumRows; ++k) s = __dadd_rn(s, sh[k][tx]);
    out[j] = s;
  }
}

template <int V>
__global__ void __launch_bounds__(kThreads)
    edge_apply_kernel(const float* __restrict__ chosen,
                      const uint8_t* __restrict__ mask, int C,
                      long long total, int per_block,
                      const double* __restrict__ stats, float* run_mean,
                      float* run_var, const float* __restrict__ scale,
                      const float* __restrict__ bias, float eps, float keep,
                      float take, float slope, float* __restrict__ out,
                      float* __restrict__ saved) {
  extern __shared__ float sh[];  // mean [C], rstd [C]
  for (int j = threadIdx.x; j < C; j += blockDim.x) {
    float mean, var, gate = 0.f;
    double count = 0.0;
    if (stats != nullptr) {
      count = stats[2 * C] < 1.0 ? 1.0 : stats[2 * C];
      const double m = __ddiv_rn(stats[j], count);
      const double raw =
          __dsub_rn(__ddiv_rn(stats[C + j], count), __dmul_rn(m, m));
      gate = raw >= 0.0 ? 1.f : 0.f;
      mean = (float)m;
      var = (float)(raw < 0.0 ? 0.0 : raw);
    } else {
      mean = run_mean[j];
      var = run_var[j];
    }
    const float rstd = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var, eps)));
    sh[j] = mean;
    sh[C + j] = rstd;
    if (blockIdx.x == 0) {
      saved[j] = mean;
      saved[C + j] = rstd;
      saved[2 * C + j] = gate;
      if (j == 0) saved[3 * C] = (float)count;
      if (stats != nullptr) {
        run_mean[j] = __fadd_rn(__fmul_rn(run_mean[j], keep),
                                __fmul_rn(take, mean));
        run_var[j] = __fadd_rn(__fmul_rn(run_var[j], keep),
                               __fmul_rn(take, var));
      }
    }
  }
  __syncthreads();
  const int lanes = C / V, groups = blockDim.x / lanes;
  const int lane = threadIdx.x % lanes, g = threadIdx.x / lanes;
  const int c0 = lane * V;
  float mu[V], rs[V], sc[V], of[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    mu[i] = sh[c0 + i];
    rs[i] = sh[C + c0 + i];
    sc[i] = scale[c0 + i];
    of[i] = bias[c0 + i];
  }
  const long long lo = (long long)blockIdx.x * per_block;
  const long long hi = lo + per_block < total ? lo + per_block : total;
  for (long long r = lo + g; r < hi; r += groups) {
    float v[V];
    if (mask[r]) {
      load_vec<V>(chosen + r * C + c0, v);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        float xhat, pre;
        transform(v[i], mu[i], rs[i], sc[i], of[i], xhat, pre);
        v[i] = leaky(pre, slope);
      }
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) v[i] = 0.f;
    }
    store_vec<V>(out + r * C + c0, v);
  }
}

// the backward's inputs beside ab, idx and mask
struct Bwd {
  const float* dy;      // [N, P, C]
  const float* out;     // [N, P, C], the forward's
  const float* saved;   // [3C + 1] = [mean, rstd, gate, count]
  const float* scale;   // [C]
  const float* bias;    // [C]
  float* share;         // [N, P, C]: dy / ties (scratch)
  float* dn_sum;        // [N, P, C]: sum over the tied edges of dn
  float* xhat_sum;      // [N, P, C]: sum over the k edges of xhat
};

template <int V>
__global__ void __launch_bounds__(kThreads)
    edge_bwd_reduce_kernel(const float* __restrict__ ab,
                           const int64_t* __restrict__ idx,
                           const uint8_t* __restrict__ mask, int P, int C,
                           int K, long long total, int per_block, Bwd b,
                           float slope, double* __restrict__ part) {
  extern __shared__ double shd[];  // [groups][2C]
  const int lanes = C / V, groups = blockDim.x / lanes;
  const int lane = threadIdx.x % lanes, g = threadIdx.x / lanes;
  const int c0 = lane * V;
  float mu[V], rs[V], sc[V], of[V];
  double s1[V], s2[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    mu[i] = b.saved[c0 + i];
    rs[i] = b.saved[C + c0 + i];
    sc[i] = b.scale[c0 + i];
    of[i] = b.bias[c0 + i];
    s1[i] = s2[i] = 0.0;
  }
  const long long lo = (long long)blockIdx.x * per_block;
  const long long hi = lo + per_block < total ? lo + per_block : total;
  const long long row = 2LL * C;
  for (long long r = lo + g; r < hi; r += groups) {
    if (!mask[r]) continue;
    const long long base = r / P * P;
    const int64_t* nb = idx + r * K;
    float bp[V], o[V], dy[V], xs[V], pu[V], pd[V];
    int ties[V], ups[V];
    load_vec<V>(ab + r * row + C + c0, bp);
    load_vec<V>(b.out + r * C + c0, o);
    load_vec<V>(b.dy + r * C + c0, dy);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      xs[i] = pu[i] = pd[i] = 0.f;
      ties[i] = ups[i] = 0;
    }
#pragma unroll 4
    for (int s = 0; s < K; ++s) {
      float a[V];
      load_vec<V>(ab + (base + nb[s]) * row + c0, a);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        float xhat, pre;
        transform(__fadd_rn(a[i], bp[i]), mu[i], rs[i], sc[i], of[i], xhat,
                  pre);
        xs[i] = __fadd_rn(xs[i], xhat);
        if (leaky(pre, slope) == o[i]) {
          ++ties[i];
          if (pre >= 0.f) {
            ++ups[i];
            pu[i] = __fadd_rn(pu[i], xhat);
          } else {
            pd[i] = __fadd_rn(pd[i], xhat);
          }
        }
      }
    }
    float sh_[V], dn[V];
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const float gi = ties[i] > 0 ? __fdiv_rn(dy[i], (float)ties[i]) : 0.f;
      const float gd = __fmul_rn(gi, slope);
      sh_[i] = gi;
      dn[i] = __fadd_rn(__fmul_rn((float)ups[i], gi),
                        __fmul_rn((float)(ties[i] - ups[i]), gd));
      const float t = __fadd_rn(__fmul_rn(gi, pu[i]), __fmul_rn(gd, pd[i]));
      s1[i] = __dadd_rn(s1[i], (double)dn[i]);
      s2[i] = __dadd_rn(s2[i], (double)t);
    }
    store_vec<V>(b.share + r * C + c0, sh_);
    store_vec<V>(b.dn_sum + r * C + c0, dn);
    store_vec<V>(b.xhat_sum + r * C + c0, xs);
  }
  block_sums<V>(shd, s1, s2, 0.0, 0, C, lane, g, groups, part);
}

// The backward's per-channel constants a = scale rstd, c1 and c2 into
// shared memory sh [3C]; block 0 also writes the float32 sums (the offset's
// and the scale's gradients).
__device__ __forceinline__ void bwd_consts(const Bwd& b,
                                           const double* __restrict__ sums,
                                           int training, int C, float* sh,
                                           float* __restrict__ sums_f) {
  const float count = b.saved[3 * C];
  for (int j = threadIdx.x; j < C; j += blockDim.x) {
    const float a = __fmul_rn(b.scale[j], b.saved[C + j]);
    float c1 = 0.f, c2 = 0.f;
    if (training) {
      const float m1 = (float)__ddiv_rn(sums[j], (double)count);
      const float m2 = (float)__ddiv_rn(sums[C + j], (double)count);
      c1 = -__fmul_rn(a, m1);
      c2 = -__fmul_rn(a, __fmul_rn(b.saved[2 * C + j], m2));
    }
    sh[j] = a;
    sh[C + j] = c1;
    sh[2 * C + j] = c2;
    if (sums_f != nullptr && blockIdx.x == 0) {
      sums_f[j] = (float)sums[j];
      sums_f[C + j] = (float)sums[C + j];
    }
  }
  __syncthreads();
}

// dBp of every point (0 at the padded ones), and dA = 0 where no edge
// points at the point
template <int V>
__global__ void __launch_bounds__(kThreads)
    edge_bwd_point_kernel(const uint8_t* __restrict__ mask, int C, int K,
                          long long total, int per_block, Bwd b,
                          const double* __restrict__ sums, int training,
                          const int64_t* __restrict__ starts,
                          float* __restrict__ sums_f,
                          float* __restrict__ dab) {
  extern __shared__ float sh[];  // a [C], c1 [C], c2 [C]
  bwd_consts(b, sums, training, C, sh, sums_f);
  const int lanes = C / V, groups = blockDim.x / lanes;
  const int lane = threadIdx.x % lanes, g = threadIdx.x / lanes;
  const int c0 = lane * V;
  float a[V], c1[V], c2[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    a[i] = sh[c0 + i];
    c1[i] = sh[C + c0 + i];
    c2[i] = sh[2 * C + c0 + i];
  }
  const long long lo = (long long)blockIdx.x * per_block;
  const long long hi = lo + per_block < total ? lo + per_block : total;
  const long long row = 2LL * C;
  const float kf = (float)K;
  for (long long r = lo + g; r < hi; r += groups) {
    float dbp[V];
    if (mask[r]) {
      float dsum[V], xsum[V];
      load_vec<V>(b.dn_sum + r * C + c0, dsum);
      load_vec<V>(b.xhat_sum + r * C + c0, xsum);
#pragma unroll
      for (int i = 0; i < V; ++i)
        dbp[i] = __fadd_rn(
            __fadd_rn(__fmul_rn(a[i], dsum[i]), __fmul_rn(kf, c1[i])),
            __fmul_rn(c2[i], xsum[i]));
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) dbp[i] = 0.f;
    }
    store_vec<V>(dab + r * row + C + c0, dbp);
    if (starts[r] == starts[r + 1]) {
      float z[V];
#pragma unroll
      for (int i = 0; i < V; ++i) z[i] = 0.f;
      store_vec<V>(dab + r * row + c0, z);
    }
  }
}

// The reverse index cut into chunks of `chunk` consecutive edges, one a
// group: the edges' dh summed in edge order, segment by segment (a segment
// being the edges that point at one point j).  A segment inside the chunk
// is written to dA[j]; the one that began before the chunk goes to
// head[chunk], the one that goes on past it to tail[chunk], for the join.
template <int V>
__global__ void __launch_bounds__(kThreads)
    edge_bwd_scatter_kernel(const float* __restrict__ ab, int C, int K,
                            long long n_edges, int chunk, long long chunks,
                            Bwd b, const double* __restrict__ sums,
                            int training, float slope,
                            const int64_t* __restrict__ keys,
                            const int64_t* __restrict__ edges,
                            const int64_t* __restrict__ starts,
                            float* __restrict__ head,
                            float* __restrict__ tail,
                            float* __restrict__ dab) {
  extern __shared__ float sh[];  // a [C], c1 [C], c2 [C]
  bwd_consts(b, sums, training, C, sh, nullptr);
  const int lanes = C / V, groups = blockDim.x / lanes;
  const int lane = threadIdx.x % lanes, g = threadIdx.x / lanes;
  const long long ch = (long long)blockIdx.x * groups + g;
  if (ch >= chunks) return;
  const int c0 = lane * V;
  float mu[V], rs[V], sc[V], of[V], a[V], c1[V], c2[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    mu[i] = b.saved[c0 + i];
    rs[i] = b.saved[C + c0 + i];
    sc[i] = b.scale[c0 + i];
    of[i] = b.bias[c0 + i];
    a[i] = sh[c0 + i];
    c1[i] = sh[C + c0 + i];
    c2[i] = sh[2 * C + c0 + i];
  }
  const long long total = n_edges / K;  // points; keys[e] == total: invalid
  const long long row = 2LL * C;
  const long long e0 = ch * chunk;
  const long long e1 = e0 + chunk < n_edges ? e0 + chunk : n_edges;
  long long j = -1;
  float aj[V], acc[V];
  auto flush = [&]() {
    float* dst;
    if (starts[j] < e0)
      dst = head + ch * C;
    else if (starts[j + 1] > e1)
      dst = tail + ch * C;
    else
      dst = dab + j * row;
    store_vec<V>(dst + c0, acc);
  };
  for (long long e = e0; e < e1; ++e) {
    const long long t = keys[e];
    if (t >= total) break;  // the padded points' edges, sorted last
    if (t != j) {
      if (j >= 0) flush();
      j = t;
      load_vec<V>(ab + j * row + c0, aj);
#pragma unroll
      for (int i = 0; i < V; ++i) acc[i] = 0.f;
    }
    const long long src = edges[e] / K;
    float bp[V], o[V], gi[V];
    load_vec<V>(ab + src * row + C + c0, bp);
    load_vec<V>(b.out + src * C + c0, o);
    load_vec<V>(b.share + src * C + c0, gi);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      float xhat, pre;
      transform(__fadd_rn(aj[i], bp[i]), mu[i], rs[i], sc[i], of[i], xhat,
                pre);
      float dn = 0.f;
      if (leaky(pre, slope) == o[i])
        dn = pre >= 0.f ? gi[i] : __fmul_rn(gi[i], slope);
      acc[i] = __fadd_rn(acc[i],
                         __fadd_rn(__fadd_rn(__fmul_rn(a[i], dn), c1[i]),
                                   __fmul_rn(c2[i], xhat)));
    }
  }
  if (j >= 0) flush();
}

// dA of each segment that begins in a chunk and goes on past it: its tail
// there, then the heads of the chunks it covers, in chunk order
template <int V>
__global__ void __launch_bounds__(kThreads)
    edge_bwd_join_kernel(int C, int K, long long n_edges, int chunk,
                         long long chunks, const int64_t* __restrict__ keys,
                         const int64_t* __restrict__ starts,
                         const float* __restrict__ head,
                         const float* __restrict__ tail,
                         float* __restrict__ dab) {
  const int lanes = C / V, groups = blockDim.x / lanes;
  const int lane = threadIdx.x % lanes, g = threadIdx.x / lanes;
  const long long ch = (long long)blockIdx.x * groups + g;
  if (ch >= chunks) return;
  const int c0 = lane * V;
  const long long total = n_edges / K;
  const long long e0 = ch * chunk;
  const long long e1 = e0 + chunk < n_edges ? e0 + chunk : n_edges;
  const long long j = keys[e1 - 1];
  if (j >= total || starts[j] < e0 || starts[j + 1] <= e1) return;
  float acc[V];
  load_vec<V>(tail + ch * C + c0, acc);
  for (long long c = ch + 1; c * chunk < starts[j + 1]; ++c) {
    float v[V];
    load_vec<V>(head + c * C + c0, v);
#pragma unroll
    for (int i = 0; i < V; ++i) acc[i] = __fadd_rn(acc[i], v[i]);
  }
  store_vec<V>(dab + j * 2LL * C + c0, acc);
}

bool aligned(const void* p) { return ((uintptr_t)p & 15) == 0; }

bool valid_shape(int N, int P, int C, int K, int vec, int threads,
                 int per_block, int grid) {
  if (N <= 0 || P <= 0 || C <= 0 || K < 1 || K > 32 || K > P) return false;
  if (vec != 1 && vec != 4) return false;
  if (C % vec || threads <= 0 || threads > kThreads || threads % (C / vec))
    return false;
  return per_block > 0 && grid > 0 &&
         (long long)grid * per_block >= (long long)N * P;
}

cudaError_t sum_rows(const double* part, int parts, int width, double* out,
                     cudaStream_t st) {
  const int blocks = (width + kSumCols - 1) / kSumCols;
  edge_sum_kernel<<<blocks, kSumCols * kSumRows, 0, st>>>(part, parts, width,
                                                          out);
  return cudaGetLastError();
}

template <int V>
int forward(const float* ab, const int64_t* idx, const uint8_t* mask, int N,
            int P, int C, int K, int threads, int per_block, int grid,
            const float* scale, const float* bias, float* run_mean,
            float* run_var, float eps, float keep, float take, int training,
            float slope, float* chosen, double* part,
            double* stats, float* out, float* saved, cudaStream_t st) {
  const long long total = (long long)N * P;
  const size_t smem = training ? (size_t)threads / (C / V) * (2 * C + 1) *
                                     sizeof(double)
                               : 0;
  edge_select_kernel<V><<<grid, threads, smem, st>>>(
      ab, idx, mask, P, C, K, total, per_block, scale, training, chosen,
      part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (training) {
    err = sum_rows(part, grid, 2 * C + 1, stats, st);
    if (err != cudaSuccess) return (int)err;
  }
  edge_apply_kernel<V><<<grid, threads, 2 * (size_t)C * sizeof(float), st>>>(
      chosen, mask, C, total, per_block, training ? stats : nullptr,
      run_mean, run_var, scale, bias, eps, keep, take, slope, out, saved);
  return (int)cudaGetLastError();
}

template <int V>
int backward(const float* ab, const int64_t* idx, const uint8_t* mask, int N,
             int P, int C, int K, int threads, int per_block, int grid,
             const Bwd& b, int training, float slope, const int64_t* keys,
             const int64_t* edges, const int64_t* starts, int chunk,
             float* head, float* tail, double* part, double* sums64,
             float* sums, float* dab, cudaStream_t st) {
  const long long total = (long long)N * P;
  const size_t smem = (size_t)threads / (C / V) * 2 * C * sizeof(double);
  edge_bwd_reduce_kernel<V><<<grid, threads, smem, st>>>(
      ab, idx, mask, P, C, K, total, per_block, b, slope, part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = sum_rows(part, grid, 2 * C, sums64, st);
  if (err != cudaSuccess) return (int)err;
  const size_t consts = 3 * (size_t)C * sizeof(float);
  edge_bwd_point_kernel<V><<<grid, threads, consts, st>>>(
      mask, C, K, total, per_block, b, sums64, training, starts, sums, dab);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long n_edges = total * K;
  const long long chunks = (n_edges + chunk - 1) / chunk;
  const int groups = threads / (C / V);
  const long long blocks = (chunks + groups - 1) / groups;
  edge_bwd_scatter_kernel<V><<<(unsigned)blocks, threads, consts, st>>>(
      ab, C, K, n_edges, chunk, chunks, b, sums64, training, slope, keys,
      edges, starts, head, tail, dab);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  edge_bwd_join_kernel<V><<<(unsigned)blocks, threads, 0, st>>>(
      C, K, n_edges, chunk, chunks, keys, starts, head, tail, dab);
  return (int)cudaGetLastError();
}

}  // namespace

// Shapes: ab f32[N, P, 2C]; idx i64[N, P, K] (K <= 32); mask u8[N, P];
// vec channels a thread (4 or 1), threads a block, grid runs of per_block
// points (ops/norm_kernels.norm_geometry); scale, bias, run_mean, run_var
// f32[C]; keep = momentum and take = 1 - momentum as float32; chosen
// f32[N, P, C] scratch; part f64[grid, 2C + 1] scratch; stats f64[2C + 1]
// = [sum h, sum h^2, count]; out f32[N, P, C]; saved f32[3C + 1] = [mean,
// rstd, gate, count].  training: the batch's statistics, the running
// averages moved; else the running statistics.
extern "C" int seid_edge_conv_fwd_f32(
    const void* ab, const void* idx, const void* mask, int N, int P, int C,
    int K, int vec, int threads, int per_block, int grid, const void* scale,
    const void* bias, void* run_mean, void* run_var, float eps, float keep,
    float take, int training, float slope, void* chosen,
    void* part, void* stats, void* out, void* saved, void* stream) {
  if (!valid_shape(N, P, C, K, vec, threads, per_block, grid) ||
      (vec == 4 && !(aligned(ab) && aligned(chosen) && aligned(out))))
    return (int)cudaErrorInvalidValue;
  auto run = vec == 4 ? forward<4> : forward<1>;
  return run((const float*)ab, (const int64_t*)idx, (const uint8_t*)mask, N,
             P, C, K, threads, per_block, grid, (const float*)scale,
             (const float*)bias, (float*)run_mean, (float*)run_var, eps, keep,
             take, training, slope, (float*)chosen, (double*)part,
             (double*)stats, (float*)out, (float*)saved,
             (cudaStream_t)stream);
}

// Shapes as the forward's, and dy, out f32[N, P, C]; keys, edges i64[N P K]
// and starts i64[N P + 1], the reverse index (edge e = point * K + slot of
// the valid points, grouped by neighbour (keys, N P for the padded points'
// edges, last) in ascending e; point j's edges at starts[j] ...
// starts[j + 1] - 1); scratch f32[3, N, P, C]; chunk edges a group in the
// scatter pass, and head, tail f32[ceil(N P K / chunk), C] its partial sums;
// part f64[grid, 2C]; sums64 f64[2C] and sums f32[2C] = [sum dn, sum dn
// xhat] (the offset's and the scale's gradients); dab f32[N, P, 2C] = [dA,
// dBp].
extern "C" int seid_edge_conv_bwd_f32(
    const void* dy, const void* ab, const void* idx, const void* mask,
    const void* out, const void* saved, const void* scale, const void* bias,
    int N, int P, int C, int K, int vec, int threads, int per_block, int grid,
    int training, float slope, const void* keys, const void* edges,
    const void* starts, int chunk, void* head, void* tail, void* scratch,
    void* part, void* sums64, void* sums, void* dab, void* stream) {
  if (!valid_shape(N, P, C, K, vec, threads, per_block, grid) || chunk < 1 ||
      (vec == 4 && !(aligned(dy) && aligned(ab) && aligned(out) &&
                     aligned(scratch) && aligned(dab) && aligned(head) &&
                     aligned(tail))))
    return (int)cudaErrorInvalidValue;
  const long long plane = (long long)N * P * C;
  float* s = (float*)scratch;
  const Bwd b{(const float*)dy,    (const float*)out,   (const float*)saved,
              (const float*)scale, (const float*)bias,  s,
              s + plane,           s + 2 * plane};
  auto run = vec == 4 ? backward<4> : backward<1>;
  return run((const float*)ab, (const int64_t*)idx, (const uint8_t*)mask, N,
             P, C, K, threads, per_block, grid, b, training, slope,
             (const int64_t*)keys, (const int64_t*)edges,
             (const int64_t*)starts, chunk, (float*)head, (float*)tail,
             (double*)part, (double*)sums64, (float*)sums, (float*)dab,
             (cudaStream_t)stream);
}
