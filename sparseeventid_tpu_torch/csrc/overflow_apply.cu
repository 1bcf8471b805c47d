// Overflow sidecar: the exact out-of-window remainder of a windowed conv,
//   out[b, dst[s]] += table[b, src[s]] @ W[kk[s]]
// over the valid entries s < n_bound[b] of the compacted pair list, in list
// order, IN PLACE on the conv output.  Each entry adds its float32
// contribution to the row and rounds to the output type, as a serial walk
// does, so duplicate dst rows accumulate exactly as in the reference.
// Device-built lists can hold invalid entries in the middle of their
// prefix, so validity is checked per entry.
//
// Replaces: sparseeventid_tpu/ops/pallas/window_conv.py, overflow_apply
// (Pallas kernel _ov_apply_kernel) and
// sparseeventid_tpu/ops/pallas/window_sidecar.py, overflow_apply_batched
// (Pallas kernel _ov_apply_v2_kernel): one contract, one kernel.
//
// PRECONDITION: over the walked prefix s < n_bound[b], dst[b, s] is
// non-decreasing, invalid holes included.  Every list of the port comes from
// ops/window/engine._compact_overflow, where the entries are the uncovered
// flat positions pos = row * K + k in ascending order and dst = pos // K,
// so the entries of one output row are contiguous (at most K of them).  A
// list that breaks this gives a row to two tasks, whose unordered updates
// of it race: a builder that reorders lists must sort them by dst first.
//
// Bound on the H100: bytes and latency.  The useful bytes of a list (its
// entries, each distinct table row, W once, each output row read and
// written once) are well under a MB at the recipes' shapes, a few hundred ns
// of HBM time.  What a walk pays is W and latency: a row's entries all have
// distinct offsets, so an entry-at-a-time walk reads a whole C x CO slice
// of W per entry (72 KB at C = CO = 192), tens of MB from L2 per call at
// the deep levels; and a short list's call is a chain of dependent loads,
// each a few hundred ns, so the design counts the loads that wait on
// others and keeps every lane's loads in flight together.
// Design: the walked entries of all events are numbered in order
// (event-major, list order) and cut into chunks of kSpan; a task is one
// chunk and one slab of output columns, and a persistent grid (sized by the
// wrapper from the list's capacity and the SM count,
// kernels._ov_geometry) strides over the tasks.  A task owns the rows whose
// first entry lies in its chunk, so its entries run from the first row
// start in the chunk to the first row start past it: each output row
// belongs to one task (per slab), no atomics, and a result that does not
// depend on scheduling.  A task loads kWin entries at once (one a thread);
// then
//   bf16, C % 16 == 0, CO % 8 == 0 (every conv of the recipes but the
//   initial one): the valid entries are bucketed by offset (a stable
//   counting sort, bucket_place), the buckets cut into m-tiles of 16
//   entries, and each warp takes m-tiles: it copies the slab of its
//   offset's W to its own shared memory with 16-byte cp.async while the
//   tile's x rows go straight from L2 into mma.sync m16n8k16 A fragments,
//   then reads the B fragments by ldmatrix.trans and accumulates in
//   float32; so a chunk reads an offset's W slab once a tile, not once an
//   entry.  The slab is 8, 16 or 32 columns (narrower as C grows), so the
//   deep levels' short lists still spread over many blocks;
//   otherwise (float32, and the C = 1 initial conv): one lane per (entry,
//   column) sums its dot product over C in order on the CUDA cores, a
//   warp's lanes on neighbouring columns, four entries a lane at once.
// The contributions go to shared memory; then one lane per (row run,
// column), four runs a lane at once, reads the rows together, adds each
// run's entries in list order with one rounding each, and writes the row
// once.  A row that runs past the loaded entries (longer than kWin -
// kSpan) goes on in the next load of the same task.

#include "window_tc.cuh"

namespace {

using namespace seid;

constexpr int kSpan = 128;     // entries whose rows a task owns
constexpr int kWin = kThreads; // entries a task loads at once: one a thread
constexpr int kMaxTiles = kWin / 16 + kMaxK;  // m-tiles of a load, at most

// ldmatrix.x2.trans: the B fragment (b0, b1) of one 8-column mma tile from
// 16 rows of shared memory (lanes 0-15 give the row addresses)
__device__ __forceinline__ void ldsm_x2_t(unsigned (&r)[2], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1]) : "r"(smem_u32(p)) : "memory");
}

// A warp's staged slab of W[k]: C rows of 8 NT bf16 (16-byte segments),
// the row pitch 16 * odd bytes so that ldmatrix reads are free of bank
// conflicts.
template <int NT>
struct WSlab {
  static constexpr int kPitch = NT == 1 ? 8 : 8 * NT + 8;  // elements
  __host__ __device__ static size_t bytes(int C) {
    return sizeof(__nv_bfloat16) * (size_t)C * kPitch;
  }
};

// Shared memory of overflow_kernel: the contributions [kWin][slab]
// (float); each warp's staged slab of W (the tensor-core route; ws bytes a
// warp, 16-byte units); the events' first entry numbers [B + 1]; then
// ints: per loaded entry its output row b * M + dst, table row b * N + src,
// offset (-1: adds nothing) and dst; the entries in offset order; the run
// starts; the counting sort's scratch and offset starts; the m-tiles
// (first sorted row, offset); the warps' boundary finds and counts.
struct OvLayout {
  int slab, K, B;
  size_t ws;
  __host__ __device__ size_t contrib() const {
    return sizeof(float) * (size_t)kWin * slab;
  }
  __host__ __device__ size_t wslabs() const { return kWarps * ws; }
  __host__ __device__ size_t ints() const {
    return 4 * (size_t)kWin + kWin + (kWin + 1) + kWarps * (size_t)K + K + 1
        + kWarps + 2 * (size_t)kMaxTiles + 3 * kWarps + 1;
  }
  __host__ __device__ size_t bytes() const {
    return contrib() + wslabs() + sizeof(long long) * (B + 1)
        + sizeof(int) * ints();
  }
};

// Bytes of a warp's slab of W for a kernel instance.
template <bool TC, int NT>
__host__ __device__ size_t warp_slab_bytes(int C) {
  return TC ? (WSlab<NT>::bytes(C) + 15) / 16 * 16 : 0;
}

// The contributions of one m-tile on the tensor cores: rows r0 .. r0 + 15
// of the offset order, those below r_end of offset k, times the slab of
// W[k] at columns n0 .. n0 + 8 NT, into contrib[entry][column].  A warp:
// it copies the slab of W to its buffer ws with 16-byte cp.async while the
// tile's x rows are read straight into mma.sync A fragments (C % 16 == 0,
// 4-byte aligned rows, all loads of KS k-steps in flight), then reads the
// B fragments by ldmatrix.trans.
template <int NT>
__device__ __forceinline__ void tile_product(
    const __nv_bfloat16* __restrict__ table, int C,
    const __nv_bfloat16* __restrict__ w, int CO, int k, int n0,
    const int* order, const int* e_src, int r0, int r_end, float* contrib,
    int slab, __nv_bfloat16* ws) {
  constexpr int KS = NT == 1 ? 12 : NT == 2 ? 8 : 4;  // k-steps a batch
  constexpr int kPitch = WSlab<NT>::kPitch;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // fragment row (A, D)
  const int q = lane & 3;   // fragment depth pair
  const int ea = r0 + g < r_end ? order[r0 + g] : -1;
  const int eb = r0 + g + 8 < r_end ? order[r0 + g + 8] : -1;
  const unsigned* xa = reinterpret_cast<const unsigned*>(
      table + (long long)e_src[max(ea, 0)] * C + 2 * q);
  const unsigned* xb = reinterpret_cast<const unsigned*>(
      table + (long long)e_src[max(eb, 0)] * C + 2 * q);
  // the slab: row c, segment sg = columns n0 + 8 sg .. (zeros past CO)
  const __nv_bfloat16* wk = w + (long long)k * C * CO + n0;
  for (int i = lane; i < C * NT; i += 32) {
    const int c = i / NT;
    const int sg = i - c * NT;
    const bool on = n0 + 8 * sg < CO;
    cp_async16(ws + c * kPitch + 8 * sg,
               on ? wk + (long long)c * CO + 8 * sg : w, on ? 16 : 0);
  }
  cp_async_commit();
  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  for (int c0 = 0; c0 < C; c0 += 16 * KS) {
    unsigned a[KS][4];
#pragma unroll
    for (int s = 0; s < KS; ++s) {
      const int c = c0 + 16 * s;
      const bool la = c < C && ea >= 0, lb = c < C && eb >= 0;
      a[s][0] = la ? xa[c / 2] : 0u;
      a[s][1] = lb ? xb[c / 2] : 0u;
      a[s][2] = la ? xa[c / 2 + 4] : 0u;
      a[s][3] = lb ? xb[c / 2 + 4] : 0u;
    }
    if (c0 == 0) {
      cp_async_wait<0>();
      __syncwarp();
    }
#pragma unroll
    for (int s = 0; s < KS; ++s) {
      const int c = c0 + 16 * s;
      if (c >= C) break;  // warp-uniform
      const __nv_bfloat16* row = ws + (c + (lane & 15)) * kPitch;
      if constexpr (NT == 1) {
        unsigned bb[2];
        ldsm_x2_t(bb, row);
        mma_bf16(acc[0], a[s], bb[0], bb[1]);
      } else {
#pragma unroll
        for (int jp = 0; jp < NT / 2; ++jp) {
          unsigned bb[4];
          ldsm_x4_t(bb, row + jp * 16 + ((lane >> 4) << 3));
          mma_bf16(acc[2 * jp], a[s], bb[0], bb[1]);
          mma_bf16(acc[2 * jp + 1], a[s], bb[2], bb[3]);
        }
      }
    }
  }
  __syncwarp();  // ws is read: the warp's next tile rewrites it
  // accumulator j: rows g (e 0, 1) and g + 8 (e 2, 3), columns 2q (+1)
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int col = 8 * j + 2 * q;
    if (n0 + col >= CO) continue;
    if (ea >= 0) {
      contrib[ea * slab + col] = acc[j][0];
      contrib[ea * slab + col + 1] = acc[j][1];
    }
    if (eb >= 0) {
      contrib[eb * slab + col] = acc[j][2];
      contrib[eb * slab + col + 1] = acc[j][3];
    }
  }
}

// TC: the tensor-core route (bf16; NT 8-column tiles a slab); else the
// CUDA-core route.
template <typename T, bool TC, int NT>
__global__ void __launch_bounds__(kThreads, 2)
overflow_kernel(T* __restrict__ out, int M, int CO,
                const T* __restrict__ table, int N, int C,
                const T* __restrict__ w, int K,
                const int* __restrict__ src, const int* __restrict__ dst,
                const int* __restrict__ kk, const uint8_t* __restrict__ valid,
                const int* __restrict__ n_bound, int S, int B, int slab) {
  extern __shared__ __align__(16) unsigned char smem_ov[];
  const OvLayout lay{slab, K, B, warp_slab_bytes<TC, NT>(C)};
  float* contrib = reinterpret_cast<float*>(smem_ov);
  // this warp's staged slab of W (TC)
  __nv_bfloat16* ws = reinterpret_cast<__nv_bfloat16*>(
      smem_ov + lay.contrib() + (threadIdx.x >> 5) * lay.ws);
  long long* ev0 = reinterpret_cast<long long*>(smem_ov + lay.contrib()
                                                + lay.wslabs());
  int* e_row = reinterpret_cast<int*>(ev0 + B + 1);
  int* e_src = e_row + kWin;
  int* e_k = e_src + kWin;
  int* e_dst = e_k + kWin;
  int* order = e_dst + kWin;       // [kWin] entries by offset (TC)
  int* run_head = order + kWin;    // [kWin + 1]
  int* hist = run_head + kWin + 1; // [kWarps * K] (TC)
  int* kstart = hist + kWarps * K; // [K + 1] (TC)
  int* wsum = kstart + K + 1;      // [kWarps] (TC)
  int* tile_r0 = wsum + kWarps;    // [kMaxTiles] (TC)
  int* tile_k = tile_r0 + kMaxTiles;
  int* w_lo = tile_k + kMaxTiles;  // [kWarps] per warp: first row start found
  int* w_hi = w_lo + kWarps;       // [kWarps] ... past the chunk
  int* w_cnt = w_hi + kWarps;      // [kWarps] run starts
  int* n_tiles = w_cnt + kWarps;   // [1] (TC)
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int n_slabs = (CO + slab - 1) / slab;
  // the (row, column) loops below put a row's columns on neighbouring lanes:
  // a warp takes rpw rows at once, lane = sub * ncp + column (ncp: the
  // slab's width rounded up to a power of two)
  const int ncp = slab <= 8 ? 8 : slab <= 16 ? 16 : 32;
  const int rpw = 32 / ncp;
  const int sub = lane / ncp;
  const int col = lane & (ncp - 1);
  const int row_step = kWarps * rpw;

  // the events' first entry numbers: every thread sums n_bound itself (B
  // loads of one line), so that a block with no task leaves at once
  long long total = 0;
#pragma unroll 8
  for (int b = 0; b < B; ++b) {
    const int nbb = max(0, min(n_bound[b], S));
    if ((b & (kThreads - 1)) == t) ev0[b] = total;
    total += nbb;
  }
  if (t == 0) ev0[B] = total;
  const long long tasks = (total + kSpan - 1) / kSpan * n_slabs;
  if (blockIdx.x >= tasks) return;  // block-uniform, before any barrier
  __syncthreads();
  for (long long task = blockIdx.x; task < tasks; task += gridDim.x) {
    const long long e0 = task / n_slabs * kSpan;
    const int n0 = (int)(task % n_slabs) * slab;
    const int ncol = min(slab, CO - n0);
    const long long e_nom = min(e0 + kSpan, total);  // its rows start below
    long long lo = -1;  // the task's first entry, found in its first load
    for (long long w0 = e0;; w0 += kWin) {
      // ---- entry w0 + t: its rows, offset and validity; a run starts at
      // an event's first entry and wherever dst changes (holes included)
      const long long n = w0 + t;
      bool head = false;
      if (n < total) {
        int b = 0, hi_b = B;  // the event with ev0[b] <= n < ev0[b + 1]
        while (hi_b - b > 1) {
          const int mid = (b + hi_b) >> 1;
          if (ev0[mid] <= n) b = mid; else hi_b = mid;
        }
        const long long s = (long long)b * S + (n - ev0[b]);
        const int d = dst[s], sv = src[s], kv = kk[s];
        const bool ok = valid[s] && sv >= 0 && sv < N && d >= 0 && d < M
            && kv >= 0 && kv < K;
        head = n == ev0[b] || (t == 0 && d != dst[s - 1]);
        e_dst[t] = d;
        e_row[t] = b * M + d;
        e_src[t] = b * N + sv;
        e_k[t] = ok ? kv : -1;
      }
      __syncthreads();
      if (n < total && t > 0 && !head) head = e_dst[t] != e_dst[t - 1];
      // the first row start at or past e0 (first load) and past e_nom
      const unsigned lo_m = __ballot_sync(kFull, head && n >= e0 && n < e_nom);
      const unsigned hi_m = __ballot_sync(
          kFull, (head && n >= e_nom && n < total) || n == total);
      if (lane == 0) {
        w_lo[warp] = lo_m ? warp * 32 + __ffs(lo_m) - 1 : kWin;
        w_hi[warp] = hi_m ? warp * 32 + __ffs(hi_m) - 1 : kWin;
      }
      __syncthreads();
      int lo_i = kWin, hi_i = kWin;
#pragma unroll
      for (int v = 0; v < kWarps; ++v) {
        lo_i = min(lo_i, w_lo[v]);
        hi_i = min(hi_i, w_hi[v]);
      }
      if (w0 == e0) {
        if (lo_i == kWin) break;  // no row starts in the chunk (uniform)
        lo = e0 + lo_i;
      }
      // this load's part of the task: [pa, pb), local
      const int pa = (int)(max(lo, w0) - w0);
      const int pb = hi_i;
      const bool in = t >= pa && t < pb;
      // ---- the runs: a row start in the part, or the part's first entry
      // (a row that goes on from the previous load)
      const bool starts = in && (head || t == pa);
      const unsigned rm = __ballot_sync(kFull, starts);
      if (lane == 0) w_cnt[warp] = __popc(rm);
      // ---- the products
      if constexpr (TC) {
        const int i = bucket_place(in ? e_k[t] : -1, K, hist, kstart, wsum);
        if (i >= 0) order[i] = t;
        if (warp == 0) {  // the m-tiles: each offset's entries, 16 a tile
          int base = 0;
          for (int k0 = 0; k0 < K; k0 += 32) {
            const int key = k0 + lane;
            const int cnt = key < K ? kstart[key + 1] - kstart[key] : 0;
            const int nt = (cnt + 15) >> 4;
            int inc = nt;
#pragma unroll
            for (int d = 1; d < 32; d <<= 1) {
              const int v = __shfl_up_sync(kFull, inc, d);
              if (lane >= d) inc += v;
            }
            for (int j = 0, f = base + inc - nt; j < nt; ++j) {
              tile_r0[f + j] = kstart[key] + 16 * j;
              tile_k[f + j] = key;
            }
            base += __shfl_sync(kFull, inc, 31);
          }
          if (lane == 0) *n_tiles = base;
        }
        __syncthreads();  // order, the tiles and w_cnt are written
        for (int j = warp; j < *n_tiles; j += kWarps) {
          const int k = tile_k[j];
          tile_product<NT>(
              reinterpret_cast<const __nv_bfloat16*>(table), C,
              reinterpret_cast<const __nv_bfloat16*>(w), CO, k, n0, order,
              e_src, tile_r0[j], kstart[k + 1], contrib, slab, ws);
        }
      } else {
        __syncthreads();  // w_cnt is written
        // one lane per (entry, column), each sum over C in order; four
        // entries a lane at once, so that their loads are in flight together
        const bool on = col < ncol;
        for (int i0 = warp * rpw + sub; i0 < pb - pa; i0 += 4 * row_step) {
          float a[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int e = pa + i0 + u * row_step;
            const int k = e < pb && on ? e_k[e] : -1;
            const T* x = table + (long long)e_src[min(e, kWin - 1)] * C;
            const T* wk = w + (long long)max(k, 0) * C * CO + n0 + col;
            float sum = 0.f;
#pragma unroll 4
            for (int c = 0; c < C; ++c)
              sum += (k >= 0 ? to_f(x[c]) : 0.f)
                  * (k >= 0 ? to_f(wk[(long long)c * CO]) : 0.f);
            a[u] = sum;
          }
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int e = pa + i0 + u * row_step;
            if (e < pb && on) contrib[e * slab + col] = a[u];
          }
        }
      }
      // the run starts in order (block-wide compaction of the ballots)
      if (starts) {
        int before = __popc(rm & ((1u << lane) - 1u));
        for (int v = 0; v < warp; ++v) before += w_cnt[v];
        run_head[before] = t;
      }
      int n_runs = 0;
#pragma unroll
      for (int v = 0; v < kWarps; ++v) n_runs += w_cnt[v];
      if (t == 0) run_head[n_runs] = pb;
      __syncthreads();  // contributions and runs are written
      // one lane per (run, column), four runs a lane at once: their rows
      // read together, then each run's entries added in list order with
      // one rounding each, and the row written once
      for (int r0 = warp * rpw + sub; r0 < n_runs; r0 += 4 * row_step) {
        int e_first[4];
        float v[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {  // the run's first valid entry
          const int r = r0 + u * row_step;
          int e = kWin;
          if (r < n_runs && col < ncol) {
            for (e = run_head[r]; e < run_head[r + 1] && e_k[e] < 0; ++e) {}
            if (e == run_head[r + 1]) e = kWin;
          }
          e_first[u] = e;
        }
#pragma unroll
        for (int u = 0; u < 4; ++u)
          v[u] = e_first[u] < kWin
              ? to_f(out[(long long)e_row[e_first[u]] * CO + n0 + col]) : 0.f;
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (e_first[u] == kWin) continue;
          const int r = r0 + u * row_step;
          for (int e = e_first[u]; e < run_head[r + 1]; ++e)
            if (e_k[e] >= 0) v[u] = to_f(from_f<T>(v[u] + contrib[e * slab + col]));
          out[(long long)e_row[e_first[u]] * CO + n0 + col] = from_f<T>(v[u]);
        }
      }
      // the next load rewrites the entry arrays and may continue a run
      // whose row this one wrote
      __syncthreads();
      if (hi_i < kWin) break;  // the task's last row ended in this load
    }
  }
}

template <typename T, bool TC, int NT>
cudaError_t launch_one(T* out, int M, int CO, const T* table, int N, int C,
                       const T* w, int K, const int* src, const int* dst,
                       const int* kk, const uint8_t* valid,
                       const int* n_bound, int S, int B, int slab, int grid,
                       cudaStream_t st) {
  const size_t smem =
      OvLayout{slab, K, B, warp_slab_bytes<TC, NT>(C)}.bytes();
  cudaError_t err = fit_smem(overflow_kernel<T, TC, NT>, smem);
  if (err != cudaSuccess) return err;
  overflow_kernel<T, TC, NT><<<grid, kThreads, smem, st>>>(
      out, M, CO, table, N, C, w, K, src, dst, kk, valid, n_bound, S, B, slab);
  return cudaGetLastError();
}

template <typename T>
int launch(void* out, int M, int CO, const void* table, int N, int C,
           const void* w, int K, const void* src, const void* dst,
           const void* kk, const void* valid, const void* n_bound, int S,
           int B, int slab, int grid, void* stream) {
  if (K < 1 || K > kMaxK || slab < 1 || slab > 32 || grid < 1
      || (long long)B * M >= INT_MAX || (long long)B * N >= INT_MAX)
    return (int)cudaErrorInvalidValue;
  if (B <= 0 || CO <= 0 || S <= 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  T* o = (T*)out;
  const T* x = (const T*)table;
  const T* wt = (const T*)w;
  const int *s_ = (const int*)src, *d_ = (const int*)dst, *k_ = (const int*)kk;
  const uint8_t* v_ = (const uint8_t*)valid;
  const int* nb = (const int*)n_bound;
  if constexpr (sizeof(T) == 2) {
    // the tensor-core route: kernels._ov_tensor_cores and _ov_slab pick
    // the same shapes and slab
    if (C % 16 == 0 && CO % 8 == 0 && ((uintptr_t)table & 3) == 0
        && ((uintptr_t)w & 15) == 0) {
      if (slab == 8)
        return (int)launch_one<T, true, 1>(o, M, CO, x, N, C, wt, K, s_, d_,
                                           k_, v_, nb, S, B, slab, grid, st);
      if (slab == 16)
        return (int)launch_one<T, true, 2>(o, M, CO, x, N, C, wt, K, s_, d_,
                                           k_, v_, nb, S, B, slab, grid, st);
      if (slab == 32)
        return (int)launch_one<T, true, 4>(o, M, CO, x, N, C, wt, K, s_, d_,
                                           k_, v_, nb, S, B, slab, grid, st);
    }
  }
  return (int)launch_one<T, false, 1>(o, M, CO, x, N, C, wt, K, s_, d_, k_,
                                      v_, nb, S, B, slab, grid, st);
}

}  // namespace

// out T[B, M, CO] (updated in place); table T[B, N, C]; w T[K, C, CO];
// src, dst, kk i32[B, S]; valid u8[B, S] (torch bool); n_bound i32[B]
// entries to walk per batch element, over which dst must be non-decreasing
// (see the top of this file); slab: output columns a task takes (<= 32;
// 8, 16 or 32 for the tensor-core route); grid: blocks.  Returns the
// launch's cudaError_t.
#define SEID_OV_ENTRY(NAME, T)                                                \
  extern "C" int NAME(void* out, int M, int CO, const void* table, int N,     \
                      int C, const void* w, int K, const void* src,           \
                      const void* dst, const void* kk, const void* valid,     \
                      const void* n_bound, int S, int B, int slab, int grid,  \
                      void* stream) {                                         \
    return launch<T>(out, M, CO, table, N, C, w, K, src, dst, kk, valid,      \
                     n_bound, S, B, slab, grid, stream);                      \
  }

SEID_OV_ENTRY(seid_overflow_apply_f32, float)
SEID_OV_ENTRY(seid_overflow_apply_bf16, __nv_bfloat16)
