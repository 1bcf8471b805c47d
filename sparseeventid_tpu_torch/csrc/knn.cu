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
//   seid_knn_topk_counts_f32 is the same search that also writes, for each
//   query, the candidates that passed its filter and the merges it took
//   (i32[N, P, 2]); training never launches it.
//
// Replaces no TPU kernel: the JAX package's knn_indices (sparseeventid_tpu/
// models/dgcnn.py) is an einsum and lax.top_k that XLA lowers.  The port's
// PyTorch version built the whole float32 distance matrix [N, P, P] and
// stable-sorted every row of it (2 GiB of distances and a 4 GiB int64 index
// tensor a stage at P = 8192, N = 8).
//
// Bound on the H100: operations, 2 P^2 F a cloud in float32 FMAs outside
// the tensor cores (66.9 TFLOP/s), against P F reads; at F = 4 the
// selection's compares.  Design:
// - Distances as a register-blocked product.  A block is kWarps warps of
//   kTQ queries each, its queries' features in shared memory for the whole
//   scan; the candidates stream through shared memory kTile at a time,
//   kChunk features a chunk, through a ring of kStages cp.async stages.  A
//   lane holds a kTQ x kTC micro-tile of sums (its warp's queries against
//   candidates lane + 32 c): four features take kTQ broadcast and kTC
//   float4 loads for 4 kTQ kTC FMAs.  The loads, not the FMAs, bound it
//   (PERF.md §6 row 12: at 8 x 4 a lane reads 48 floats for 128 FMAs,
//   where the H100 feeds 4 FMAs a float).  Each sum is the float32 chain
//   of the one-thread-a-query design before it: fmaf in ascending feature
//   order from 0 (direct: of e = x_i - x_j), the norms as running sums in
//   feature order, the expansion as __fadd_rn(__fsub_rn(|x_i|^2, 2 acc),
//   |x_j|^2), so the lists are that design's bit for bit.
// - Selection by threshold.  Each query keeps a sorted list of 32
//   (distance, index) pairs, one a lane, in shared memory, and a threshold
//   from its k-th pair.  A candidate that does not pass it costs one
//   compare.  Those that do go to the query's queue of 32 slots, at offsets
//   from __ballot_sync and __popc (no atomics); when a step of 32
//   candidates would overflow a queue, and at the end, the warp sorts the
//   queue (bitonic, shuffles), merges it into the list (the 32 first of
//   both, bitonic again) and takes the new threshold.  Pairs compare by
//   (distance, index), so the list is the first k of the row ordered so,
//   whatever the order the candidates come in.
// - The scan starts at the tile that holds the block's queries: on clouds
//   stored track by track their neighbours come first, and the thresholds
//   fall at once (on the cell's events 125 candidates a query pass, 1.5%
//   of the pairs, against about 650 in index order).
// No P x P tensor is written and nothing is allocated: the output is the
// only store.  One launch a search; the form (direct or expanded) and its
// shape come from F, the grid from N and P.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kList = 32;                  // a list's and a queue's slots
constexpr int kDirectFeatures = 16;        // at most this many: the direct form
constexpr unsigned kFull = 0xffffffffu;
constexpr int kNone = 0x7fffffff;          // the index of an empty slot

// The launch shape of each form: warps a block, queries a warp (the rows of
// a lane's micro-tile), candidates a lane a tile (its columns), features a
// chunk of the candidate tile, chunks in flight, blocks an SM the registers
// are cut for: the fastest of the shapes timed on the H100 (PERF.md §6).
// Both forms take 8 x 4 micro-tiles; the direct form, whose arithmetic is
// light, two blocks of 8 warps an SM, the expanded form one block of 16
// warps and 32-feature chunks.
template <bool kDirect>
struct Shape {
  static constexpr int kWarps = 8, kTQ = 8, kTC = 4, kChunk = 16, kStages = 3,
                       kBlocks = 2;
};
template <>
struct Shape<false> {
  static constexpr int kWarps = 16, kTQ = 8, kTC = 4, kChunk = 32, kStages = 2,
                       kBlocks = 1;
};

template <bool kDirect>
struct Dims {
  using S = Shape<kDirect>;
  static constexpr int kWarps = S::kWarps, kTQ = S::kTQ, kTC = S::kTC;
  static constexpr int kChunk = S::kChunk, kStages = S::kStages;
  static constexpr int kBlocks = S::kBlocks;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kQueries = kWarps * kTQ;      // a block's
  static constexpr int kTile = 32 * kTC;             // candidates a tile
  // float4s a chunk row: the cp.async writes of a quarter warp (8 threads,
  // kChunk / 4 float4s of a row each) on distinct bank groups
  static constexpr int kPitch = kTile + 8 / (kChunk / 4);
  static constexpr int kBuf = (kChunk / 4) * kPitch;  // float4s a stage
  // a thread's 16-byte copies of a whole chunk
  static constexpr int kCopies = kTile * (kChunk / 4) / kThreads;
  // a warp's state, in 4-byte words: lists and queues (distances, indices),
  // then each query's threshold, queue length and (counting) passes, merges
  static constexpr int kWarpWords = 4 * kTQ * kList + 4 * kTQ;
  static_assert(kChunk % 4 == 0 && kChunk <= 32 && kStages >= 2, "shape");
  // a thread owns at most one candidate of the tile (its norm and penalty)
  // and copies whole float4s of every chunk
  static_assert(kTile <= kThreads && kCopies * kThreads == kTile * (kChunk / 4),
                "shape");

  static size_t smem_bytes(int F) {
    return sizeof(float4) * kStages * kBuf +
           sizeof(float) * ((size_t)kQueries * F + 2 * kTile + kQueries +
                            (size_t)kWarps * kWarpWords);
  }
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"((unsigned)__cvta_generic_to_shared(dst)), "l"(src),
                  "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// (a, ai) before (b, bi): by distance, then by index
__device__ __forceinline__ bool before(float a, int ai, float b, int bi) {
  return a < b || (a == b && ai < bi);
}

// one compare-exchange of a bitonic network across the warp: the lane keeps
// the first of its pair with the lane ^ stride if keep_first, else the last
__device__ __forceinline__ void exchange(float& d, int& j, int stride,
                                         bool keep_first) {
  const float od = __shfl_xor_sync(kFull, d, stride);
  const int oj = __shfl_xor_sync(kFull, j, stride);
  if (before(od, oj, d, j) == keep_first) {
    d = od;
    j = oj;
  }
}

// The bound a candidate's distance must stay under to pass a query's filter,
// from the k-th pair (dk, jk) of its list: a candidate that does not come
// before that pair (by distance, then index) cannot be among the k first.
// Before the scan wraps, every candidate's index is above every listed one,
// so a tie never passes (d < dk); after it, a tie passes where the k-th pair
// came before the wrap (jk >= wrap: d <= dk, as d < the next float).  An
// infinite distance never passes.
__device__ __forceinline__ float threshold(float dk, int jk, int wrap) {
  return jk >= wrap ? nextafterf(dk, INFINITY) : dk;
}

// Merge a query's queue (its slots beyond the length hold empty pairs) into
// its sorted list, empty the queue, and return the new threshold (see
// threshold()).
__device__ __forceinline__ float merge_queue(float* ld, int* lj, float* qd,
                                             int* qj, int lane, int k,
                                             int wrap) {
  float d = qd[lane];
  int j = qj[lane];
  qd[lane] = INFINITY;
  qj[lane] = kNone;
#pragma unroll
  for (int size = 2; size <= kList; size <<= 1)
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1)
      exchange(d, j, stride, ((lane & size) == 0) == ((lane & stride) == 0));
  // the 32 first of list and queue: the list ascending against the queue
  // descending, pair by pair, is a bitonic sequence that holds them
  float a = ld[lane];
  int ai = lj[lane];
  const float od = __shfl_sync(kFull, d, kList - 1 - lane);
  const int oj = __shfl_sync(kFull, j, kList - 1 - lane);
  if (before(od, oj, a, ai)) {
    a = od;
    ai = oj;
  }
#pragma unroll
  for (int stride = kList >> 1; stride > 0; stride >>= 1)
    exchange(a, ai, stride, (lane & stride) == 0);
  ld[lane] = a;
  lj[lane] = ai;
  return threshold(__shfl_sync(kFull, a, k - 1), __shfl_sync(kFull, ai, k - 1),
                   wrap);
}

// Four features of the warp's micro-tile: kTQ broadcast loads of its queries,
// kTC loads of the lane's candidates, 4 kTQ kTC FMAs.
template <bool kDirect, int kTQ, int kTC>
__device__ __forceinline__ void step(float (&acc)[kTQ][kTC],
                                     const float4* cand, const float4* qc) {
  float4 cv[kTC];
#pragma unroll
  for (int c = 0; c < kTC; ++c) cv[c] = cand[32 * c];
#pragma unroll
  for (int q = 0; q < kTQ; ++q) {
    const float4 a = qc[q];
#pragma unroll
    for (int c = 0; c < kTC; ++c) {
      float s = acc[q][c];
      if (kDirect) {
        const float e0 = a.x - cv[c].x, e1 = a.y - cv[c].y,
                    e2 = a.z - cv[c].z, e3 = a.w - cv[c].w;
        s = fmaf(e0, e0, s);
        s = fmaf(e1, e1, s);
        s = fmaf(e2, e2, s);
        s = fmaf(e3, e3, s);
      } else {
        s = fmaf(a.x, cv[c].x, s);
        s = fmaf(a.y, cv[c].y, s);
        s = fmaf(a.z, cv[c].z, s);
        s = fmaf(a.w, cv[c].w, s);
      }
      acc[q][c] = s;
    }
  }
}

// Four more features of the squared norm of the thread's candidate of the
// tile (threads past the tile have none), summed in feature order.
template <class D>
__device__ __forceinline__ void add_norm(float& norm, const float4* row,
                                         int t) {
  if (t >= D::kTile) return;
  const float4 v = row[t];
  norm += v.x * v.x;
  norm += v.y * v.y;
  norm += v.z * v.z;
  norm += v.w * v.w;
}

template <bool kDirect, bool kCount>
__global__ void __launch_bounds__(Dims<kDirect>::kThreads, Dims<kDirect>::kBlocks)
knn_topk_kernel(const float* __restrict__ x, const uint8_t* __restrict__ mask,
                int P, int F, int k, int64_t* __restrict__ out,
                int* __restrict__ counts) {
  using D = Dims<kDirect>;
  constexpr int kTQ = D::kTQ, kTC = D::kTC, kTile = D::kTile;
  constexpr int kThreads = D::kThreads, kQueries = D::kQueries;
  constexpr int kChunk = D::kChunk, kStages = D::kStages, kPitch = D::kPitch;
  extern __shared__ float4 smem4[];
  float4* cand = smem4;                           // [kStages][kChunk / 4][kPitch]
  float4* qs = cand + kStages * D::kBuf;          // [F / 4][kQueries]
  float* csq = reinterpret_cast<float*>(qs + (size_t)kQueries * (F / 4));
                                                  // [kTile] squared norms
  float* pen = csq + kTile;                       // [kTile] 0 valid, 1 padded, 2 none
  float* sqi = pen + kTile;                       // [kQueries] squared norms

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  float* wd = sqi + kQueries + warp * D::kWarpWords;
  float* list_d = wd;                             // [kTQ][kList]
  int* list_j = reinterpret_cast<int*>(list_d + kTQ * kList);
  float* queue_d = reinterpret_cast<float*>(list_j + kTQ * kList);
  int* queue_j = reinterpret_cast<int*>(queue_d + kTQ * kList);
  float* thr_s = reinterpret_cast<float*>(queue_j + kTQ * kList);  // [kTQ]
  int* len_s = reinterpret_cast<int*>(thr_s + kTQ);                // [kTQ]
  int* passed_s = len_s + kTQ;                                     // [kTQ]
  int* merges_s = passed_s + kTQ;                                  // [kTQ]

  const int n = blockIdx.y;
  const int q0 = blockIdx.x * kQueries;
  const float* xe = x + (size_t)n * P * F;
  const uint8_t* me = mask + (size_t)n * P;
  const int f4s = F / 4;

  // the block's queries (zeros past P), four features by kQueries
  for (int e = t; e < kQueries * f4s; e += kThreads) {
    const int qi = e / f4s, c4 = e - qi * f4s;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + qi < P)
      v = reinterpret_cast<const float4*>(xe + (size_t)(q0 + qi) * F)[c4];
    qs[c4 * kQueries + qi] = v;
  }
#pragma unroll
  for (int q = 0; q < kTQ; ++q) {
    list_d[q * kList + lane] = INFINITY;
    list_j[q * kList + lane] = kNone;
    queue_d[q * kList + lane] = INFINITY;
    queue_j[q * kList + lane] = kNone;
  }
  if (lane < kTQ) {
    thr_s[lane] = INFINITY;
    len_s[lane] = passed_s[lane] = merges_s[lane] = 0;
  }

  // The scan starts at the tile that holds the block's queries and wraps
  // around (see the design note); the lists do not depend on the order.
  const int n_tiles = (P + kTile - 1) / kTile;
  const int first = q0 / kTile;
  const int wrap_at = n_tiles - first;  // the scan's first tile below `first`
  const int n_chunks = (F + kChunk - 1) / kChunk;
  const int total = n_tiles * n_chunks;
  // chunk `it` of the scan to stage it % kStages (zeros past P)
  auto issue = [&](int it) {
    if (it < total) {
      const int i = it / n_chunks, f0 = (it - i * n_chunks) * kChunk;
      const int j0 = (first + i) % n_tiles * kTile;
      const int w4 = min(kChunk, F - f0) / 4;
      float4* buf = cand + (it % kStages) * D::kBuf;
      auto copy = [&](int r, int c4) {
        const int j = j0 + r;
        cp_async16(buf + c4 * kPitch + r,
                   xe + (size_t)min(j, P - 1) * F + f0 + 4 * c4,
                   j < P ? 16 : 0);
      };
      if (w4 == kChunk / 4) {
#pragma unroll
        for (int u = 0; u < D::kCopies; ++u) {
          const int e = t + u * kThreads;
          copy(e / (kChunk / 4), e % (kChunk / 4));
        }
      } else {
        for (int e = t; e < kTile * w4; e += kThreads) copy(e / w4, e % w4);
      }
    }
    cp_async_commit();  // an empty group past the end keeps the count
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) issue(s);
  __syncthreads();
  if (!kDirect && t < kQueries) {
    float s = 0.f;
    for (int c4 = 0; c4 < f4s; ++c4) {
      const float4 v = qs[c4 * kQueries + t];
      s += v.x * v.x;
      s += v.y * v.y;
      s += v.z * v.z;
      s += v.w * v.w;
    }
    sqi[t] = s;
  }

  float acc[kTQ][kTC];
  float norm = 0.f, my_pen = 0.f;  // the thread's candidate of the tile
  const float4* qrow = qs + warp * kTQ;

  for (int it = 0; it < total; ++it) {
    const int i = it / n_chunks, ch = it - i * n_chunks;
    const int j0 = (first + i) % n_tiles * kTile, f0 = ch * kChunk;
    const int w4 = min(kChunk, F - f0) / 4;
    if (ch == 0) {
      const int j = j0 + t;
      my_pen = j >= P ? 2.f : (me[j] ? 0.f : 1.f);
      norm = 0.f;
#pragma unroll
      for (int q = 0; q < kTQ; ++q)
#pragma unroll
        for (int c = 0; c < kTC; ++c) acc[q][c] = 0.f;
    }
    cp_async_wait<kStages - 2>();
    __syncthreads();  // chunk it is in; the stage it refills is free
    issue(it + kStages - 1);
    const float4* buf = cand + (it % kStages) * D::kBuf;
    const float4* qc = qrow + (f0 / 4) * kQueries;
    if (w4 == kChunk / 4) {
#pragma unroll
      for (int c4 = 0; c4 < kChunk / 4; ++c4) {
        step<kDirect>(acc, buf + c4 * kPitch + lane, qc + c4 * kQueries);
        if (!kDirect) add_norm<D>(norm, buf + c4 * kPitch, t);
      }
    } else {
      for (int c4 = 0; c4 < w4; ++c4) {
        step<kDirect>(acc, buf + c4 * kPitch + lane, qc + c4 * kQueries);
        if (!kDirect) add_norm<D>(norm, buf + c4 * kPitch, t);
      }
    }
    if (ch != n_chunks - 1) continue;

    // ---- the tile's distances and their selection
    if (t < kTile) {
      csq[t] = norm;
      pen[t] = my_pen;
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < kTC; ++c) {
      const float cs = csq[lane + 32 * c], pn = pen[lane + 32 * c];
#pragma unroll
      for (int q = 0; q < kTQ; ++q) {
        float d = kDirect ? acc[q][c]
                          : __fadd_rn(__fsub_rn(sqi[warp * kTQ + q],
                                                2.f * acc[q][c]), cs);
        if (pn != 0.f) d = pn == 1.f ? 1e9f : INFINITY;
        acc[q][c] = d;
      }
    }
    // A candidate under its query's threshold goes to the queue; one that is
    // not cannot be among the k first of the row.
    // past the wrap, pairs merged before it come after every candidate
    const int wrap = i >= wrap_at ? first * kTile : kNone;
    if (i == wrap_at && first > 0) {
      if (lane < kTQ)
        thr_s[lane] = threshold(list_d[lane * kList + k - 1],
                                list_j[lane * kList + k - 1], wrap);
      __syncwarp();
    }
    float th[kTQ];
    bool any = false;
#pragma unroll
    for (int q = 0; q < kTQ; ++q) {
      th[q] = thr_s[q];
#pragma unroll
      for (int c = 0; c < kTC; ++c) any |= acc[q][c] < th[q];
    }
    if (!__any_sync(kFull, any)) continue;
    const unsigned below = (1u << lane) - 1u;
    int len[kTQ];
#pragma unroll
    for (int q = 0; q < kTQ; ++q) len[q] = len_s[q];
#pragma unroll
    for (int c = 0; c < kTC; ++c) {
      unsigned m[kTQ];
      unsigned over = 0;
#pragma unroll
      for (int q = 0; q < kTQ; ++q) {
        m[q] = __ballot_sync(kFull, acc[q][c] < th[q]);
        if (len[q] + __popc(m[q]) > kList) over |= 1u << q;
      }
      if (over) {  // merge the queues this step would overflow, then refilter
        __syncwarp();
        for (unsigned b = over; b; b &= b - 1) {
          const int q = __ffs(b) - 1;
          const float th_q = merge_queue(list_d + q * kList, list_j + q * kList,
                                         queue_d + q * kList,
                                         queue_j + q * kList, lane, k, wrap);
          if (lane == 0) {
            thr_s[q] = th_q;
            if (kCount) ++merges_s[q];
          }
        }
        __syncwarp();
#pragma unroll
        for (int q = 0; q < kTQ; ++q)
          if (over >> q & 1) {
            len[q] = 0;
            th[q] = thr_s[q];
            m[q] = __ballot_sync(kFull, acc[q][c] < th[q]);
          }
      }
      const int j = j0 + 32 * c + lane;
#pragma unroll
      for (int q = 0; q < kTQ; ++q) {
        if (m[q] >> lane & 1) {
          const int at = q * kList + len[q] + __popc(m[q] & below);
          queue_d[at] = acc[q][c];
          queue_j[at] = j;
        }
        len[q] += __popc(m[q]);
        if (kCount && lane == 0) passed_s[q] += __popc(m[q]);
      }
    }
    if (lane == 0) {
#pragma unroll
      for (int q = 0; q < kTQ; ++q) len_s[q] = len[q];
    }
  }
  cp_async_wait<0>();

  // the queues' rest, then the lists' first k
  __syncwarp();
  for (int q = 0; q < kTQ; ++q) {
    if (len_s[q] > 0) {
      merge_queue(list_d + q * kList, list_j + q * kList, queue_d + q * kList,
                  queue_j + q * kList, lane, k, 0);
      if (kCount && lane == 0) ++merges_s[q];
    }
    const int qq = q0 + warp * kTQ + q;
    if (qq < P && lane < k)
      out[((size_t)n * P + qq) * k + lane] = list_j[q * kList + lane];
  }
  if (kCount) {
    __syncwarp();
    const int qq = q0 + warp * kTQ + lane;
    if (lane < kTQ && qq < P) {
      counts[((size_t)n * P + qq) * 2] = passed_s[lane];
      counts[((size_t)n * P + qq) * 2 + 1] = merges_s[lane];
    }
  }
}

template <bool kDirect, bool kCount>
int launch_as(const float* x, const uint8_t* mask, int N, int P, int F, int k,
              int64_t* out, int* counts, cudaStream_t stream) {
  using D = Dims<kDirect>;
  const size_t bytes = D::smem_bytes(F);
  cudaError_t err = cudaFuncSetAttribute(
      knn_topk_kernel<kDirect, kCount>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((P + D::kQueries - 1) / D::kQueries, N);
  knn_topk_kernel<kDirect, kCount><<<grid, D::kThreads, bytes, stream>>>(
      x, mask, P, F, k, out, counts);
  return (int)cudaGetLastError();
}

template <bool kCount>
int launch(const void* x, const void* mask, int N, int P, int F, int k,
           void* out, int* counts, void* stream) {
  const float* xp = static_cast<const float*>(x);
  const uint8_t* mp = static_cast<const uint8_t*>(mask);
  int64_t* op = static_cast<int64_t*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N <= 0 || P <= 0) return 0;
  if (k < 1 || k > kList || k > P || F < 4 || F % 4)
    return (int)cudaErrorInvalidValue;
  return F <= kDirectFeatures
             ? launch_as<true, kCount>(xp, mp, N, P, F, k, op, counts, s)
             : launch_as<false, kCount>(xp, mp, N, P, F, k, op, counts, s);
}

}  // namespace

extern "C" int seid_knn_topk_f32(const void* x, const void* mask, int N,
                                 int P, int F, int k, void* out,
                                 void* stream) {
  return launch<false>(x, mask, N, P, F, k, out, nullptr, stream);
}

extern "C" int seid_knn_topk_counts_f32(const void* x, const void* mask, int N,
                                        int P, int F, int k, void* out,
                                        void* counts, void* stream) {
  return launch<true>(x, mask, N, P, F, k, out, static_cast<int*>(counts),
                      stream);
}
