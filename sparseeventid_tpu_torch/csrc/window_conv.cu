// Windowed sparse convolution, forward: the in-window part of
//   out[b, m, :] = sum_k  feats[b, row(b, m, k), :] @ W[k]
// where row(b, m, k) is the table row whose key equals base[m] + dkey[k'],
// searched only inside the plan window [start[b, m / 128, k'], + window_r),
// with k' = kmap[k] (identity without a kmap).  The query is live only where
// bit k' of the packed validity words is set.  Matches outside the window
// are NOT counted here: they are on the plan's overflow list, which the
// sidecar kernel applies; counting them here would count them twice.
// Tiles at or past ceil(q_active / 128), and rows at or past m_bound, are 0.
//
// Replaces: sparseeventid_tpu/ops/pallas/window_conv.py, window_conv_apply
// (Pallas kernel _conv_kernel).
//
// Bound on the H100: bytes.  At the dune3d shapes the table, the query meta
// and the output are tens of MB, against 2 * pairs * C * CO flops (a few
// GFLOP) that the tensor cores take a few microseconds for.  What a block
// waits on is the matching (K window searches a query), the row gathers it
// feeds, and at the deep levels (C, CO up to 192) the products of the
// whole tile, matched or not: 2 * 128 * K * C * CO flops a tile.
// Design: one block of 8 warps per (b, 128-query tile, output slab); the
// slab is all of CO up to 192 columns, so each tile is searched and
// gathered once.  Every route starts the same way (search_slots): the
// tile's query meta and window starts are staged in shared memory; each
// warp owns offsets k = warp, warp + 8, ...; it copies the offset's plan
// window (window_r keys) to shared memory with cp.async, the copies of
// its next two offsets in flight while it searches the current one there
// (window_match.cuh's find_keys_staged, a lane's four queries interleaved:
// match_row's pair set), and records each query's match as a 16-bit
// position in the window.
//   bf16, C > 1 (conv_tc_kernel): the offsets with any match are listed,
//   and the GEMM depth (those offsets x C, offset-major) is walked in
//   64-deep chunks through a cp.async ring (two stages for a 32-column
//   slab, which then fits three blocks an SM, three otherwise): the tile's
//   128 matched rows (16-byte copies, zero-filled where unmatched) and the
//   [64, slab] rows of W, the next step's copies in flight while a step
//   multiplies.  Small C packs several offsets into one chunk (C = 32:
//   two).  The product runs on the tensor cores (mma.sync m16n8k16, bf16
//   in, fp32 accumulate; ldmatrix from padded rows, free of bank
//   conflicts): the 8 warps split the 128 x slab tile 4 x 2, and each
//   keeps its 32 x slab/2 fp32 accumulator in registers over all chunks;
//   the output is cast to bf16 once.
//   C == 1, CO <= 32 (conv_c1_kernel): no depth in C, so the depth is the
//   offsets.  One block-wide gather, many loads in flight, turns the
//   matched positions into values [K, 128]; in bf16 the tensor cores then
//   take the tile's [128, K] x [K, 32] product (K padded to 16), and in
//   fp32 a lane owns an output channel and sums x * W[k, 0, lane] over k
//   in fp32 registers.
//   fp32, C > 1 (conv_f32_kernel): the float32 path of fp32_compare and
//   the gradient checks, kept as float32 FMAs on the CUDA cores (TF32
//   would not meet their 1e-3 limits): one block per (b, tile, 32 outputs)
//   stages rows and W 32 channels at a time as a small register-tiled GEMM.
// At C = CO = 192 conv_tc_kernel takes about 140 KB of shared memory
// (three stages of 128 x 64 rows and 64 x 192 weights), so the launch opts
// in to dynamic shared memory above 48 KB (cudaFuncSetAttribute).
// The kernels and their launch live in window_tc.cuh, which the backward's
// dX (window_bwd.cu) instantiates too; this file holds the entry points.

#include "window_tc.cuh"

using namespace seid;

// keys i32[B, n_in] sorted; feats T[B, n_in, C]; qmeta i32[B, 1+nw, M];
// start i32[B, n_tiles, K'] (K' >= every cols[k] + 1); w T[K, C, CO];
// q_active i32[B]; out T[B, M, CO] (fully written).  dkeys and cols are
// HOST arrays of K ints.  groups (1..8): the blocks, one cluster, that
// share a tile's offsets on the bf16 tensor-core route (the other routes
// take the whole tile in one block).  Returns the launch's cudaError_t.
#define SEID_CONV_ENTRY(NAME, T)                                              \
  extern "C" int NAME(const void* keys, int n_in, const void* feats, int C,   \
                      const void* qmeta, int nw, int M, const void* start,    \
                      int n_tiles, int K, const void* w, int CO,              \
                      const void* q_active, int m_bound, int window_r,        \
                      void* out, const int* dkeys, const int* cols, int B,    \
                      int groups, void* stream) {                             \
    if (K > kMaxK || window_r < 0 || window_r > 32767)                        \
      return (int)cudaErrorInvalidValue;                                      \
    if (M <= 0 || B <= 0 || CO <= 0) return (int)cudaGetLastError();         \
    Offsets offs;                                                             \
    fill_offsets(offs, dkeys, cols, K);                                       \
    const Args a{keys, feats, qmeta, start, w, q_active, out, n_in, C, nw, M, \
                 n_tiles, K, CO, m_bound, window_r, B, groups};               \
    return conv_launch<FwdConv, T>(a, offs, (cudaStream_t)stream);            \
  }

SEID_CONV_ENTRY(seid_window_conv_f32, float)
SEID_CONV_ENTRY(seid_window_conv_bf16, __nv_bfloat16)
