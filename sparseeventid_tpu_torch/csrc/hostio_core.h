// Host window-plan builder: the site pyramid and every window plan of one
// event, a pure function of its coordinates, in plain C++ (no Python, no
// CUDA).  Included by hostio.cpp, which runs it per event on a thread pool.
//
// The port's own copy of sparseeventid_tpu/io/_hostio_core.h.  Geometry
// mirrors ops/window/query.py: TILE_T = 128 query rows a tile, starts
// aligned to 16, the window of R rows clamped so start + R never passes
// the conv's table length (conv_max_start).
//
// One deliberate difference: each overflow list is emitted in (dst, k)
// order, where the JAX builder appends offset-major.  The sidecar kernel
// (csrc/overflow_apply.cu) gives each output row to one block and needs
// dst non-decreasing over the walked prefix; (dst, k) is also the order of
// the lists built on the device (ops/window/engine._compact_overflow, flat
// position dst * K + k), so an output row receives its pairs in the same
// sequence from either plan source.  `total` counts every out-of-window
// pair as in JAX; a list longer than its width keeps its first `cap` pairs
// in that order.
#pragma once

#include <algorithm>
#include <cstdint>
#include <utility>
#include <vector>

namespace seid_plans {

constexpr int64_t kTileT = 128;
constexpr int64_t kStartAlign = 16;

struct PlanShape {
  int64_t window_r;
  int64_t overflow_cap;
};

// A level's live sites: sorted unique linear keys and their coordinates.
struct LevelData {
  std::vector<int64_t> keys;
  std::vector<int32_t> coords;  // [n, 3]
  int64_t dropped = 0;          // unique sites lost to the level capacity
};

struct PairList {
  std::vector<int32_t> src, dst, kk;
  int64_t total = 0;  // out-of-window pairs before the width clamp
};

struct PlanResult {
  std::vector<int32_t> start;  // [tiles, K]
  PairList list;
};

// Everything one event needs: the pyramid and all plans.
struct EventPlans {
  std::vector<LevelData> levels;
  PlanResult initial;              // level 0, initial kernel
  std::vector<PlanResult> series;  // depth + 1
  std::vector<PlanResult> down_f;  // depth: queries = child, table = parent
  std::vector<PlanResult> down_r;  // depth: parent rows into the child table
};

inline int64_t round_up(int64_t x, int64_t m) { return (x + m - 1) / m * m; }

// Largest window start the conv may use: its table is the level's
// [B, cap, C] tensor (16-rounded), so start + r <= max(r16(cap), r16(r)).
// Clamping left keeps the plan exact: matches sit below n_active <= cap,
// and the in-window test runs after the clamp.
inline int64_t conv_max_start(int64_t table_cap, int64_t window_r) {
  return std::max(round_up(table_cap, 16), round_up(window_r, 16)) - window_r;
}

// One offset column: mpos[i] is query i's row in the table (-1: none).
// Writes the exact start of every tile (the smallest match, aligned down
// to 16, clamped) and appends the pairs outside [start, start + r).
inline void column_starts(const std::vector<int64_t>& mpos, int64_t n_q,
                          int64_t n_tiles, int64_t k, int64_t kk,
                          int64_t window_r, int64_t max_start,
                          int32_t* start, PairList* pairs) {
  for (int64_t t = 0; t < n_tiles; ++t) {
    const int64_t lo = t * kTileT, hi = std::min(lo + kTileT, n_q);
    int64_t mn = -1;
    for (int64_t i = lo; i < hi; ++i)
      if (mpos[size_t(i)] >= 0 && (mn < 0 || mpos[size_t(i)] < mn))
        mn = mpos[size_t(i)];
    int64_t st = 0;
    if (mn >= 0) st = std::max<int64_t>(
        std::min(mn / kStartAlign * kStartAlign, max_start), 0);
    start[t * k + kk] = int32_t(st);
    if (mn < 0) continue;
    for (int64_t i = lo; i < hi; ++i) {
      const int64_t p = mpos[size_t(i)];
      if (p < 0 || (p >= st && p < st + window_r)) continue;
      pairs->src.push_back(int32_t(p));
      pairs->dst.push_back(int32_t(i));
      pairs->kk.push_back(int32_t(kk));
    }
  }
}

// The pairs were appended offset by offset, each offset's in ascending
// dst: a stable counting sort by dst gives (dst, k) order.  Then the width
// clamp.
inline void finish_list(int64_t n_q, int64_t cap, PairList* pairs) {
  const size_t n = pairs->src.size();
  pairs->total = int64_t(n);
  std::vector<int64_t> first(size_t(n_q) + 1, 0);
  for (size_t e = 0; e < n; ++e) ++first[size_t(pairs->dst[e]) + 1];
  for (int64_t i = 0; i < n_q; ++i) first[size_t(i) + 1] += first[size_t(i)];
  PairList out;
  out.src.resize(n);
  out.dst.resize(n);
  out.kk.resize(n);
  for (size_t e = 0; e < n; ++e) {
    const size_t to = size_t(first[size_t(pairs->dst[e])]++);
    out.src[to] = pairs->src[e];
    out.dst[to] = pairs->dst[e];
    out.kk[to] = pairs->kk[e];
  }
  const size_t keep = std::min(n, size_t(std::max<int64_t>(cap, 0)));
  out.src.resize(keep);
  out.dst.resize(keep);
  out.kk.resize(keep);
  out.total = pairs->total;
  *pairs = std::move(out);
}

// Row of key q in the sorted keys, -1 if absent.  Queries of one offset
// are monotone, so j walks forward; a query below keys[j - 1] (never for
// sorted input) falls back to a binary search.
inline int64_t walk_find(const std::vector<int64_t>& keys, int64_t q,
                         int64_t* j) {
  const int64_t n = int64_t(keys.size());
  if (*j > 0 && keys[size_t(*j - 1)] >= q)
    *j = std::lower_bound(keys.begin(), keys.end(), q) - keys.begin();
  while (*j < n && keys[size_t(*j)] < q) ++*j;
  return (*j < n && keys[size_t(*j)] == q) ? *j : -1;
}

// A plan whose queries are q_coords * scale + offset, looked up in `table`
// (a submanifold plan: scale 1, queries = table sites; a forward
// downsample plan: the child sites scaled by the stride into the parent).
inline void build_plan(const LevelData& table, const int64_t* grid,
                       const int32_t* q_coords, int64_t n_q, int64_t q_cap,
                       const std::vector<int64_t>& offs, const int64_t* scale,
                       const PlanShape& ps, int64_t table_cap,
                       PlanResult* out) {
  const int64_t k = int64_t(offs.size() / 3);
  const int64_t n_tiles = (q_cap + kTileT - 1) / kTileT;
  const int64_t max_start = conv_max_start(table_cap, ps.window_r);
  out->start.assign(size_t(n_tiles * k), 0);
  std::vector<int64_t> mpos(static_cast<size_t>(n_q));
  for (int64_t kk = 0; kk < k; ++kk) {
    const int64_t* d = offs.data() + kk * 3;
    int64_t j = 0;
    for (int64_t i = 0; i < n_q; ++i) {
      const int32_t* c = q_coords + i * 3;
      int64_t q[3];
      bool inside = c[0] >= 0;
      for (int a = 0; a < 3; ++a) {
        q[a] = int64_t(c[a]) * scale[a] + d[a];
        inside = inside && q[a] >= 0 && q[a] < grid[a];
      }
      mpos[size_t(i)] =
          inside ? walk_find(table.keys, (q[0] * grid[1] + q[1]) * grid[2] + q[2], &j)
                 : -1;
    }
    column_starts(mpos, n_q, n_tiles, k, kk, ps.window_r, max_start,
                  out->start.data(), &out->list);
  }
  finish_list(n_q, ps.overflow_cap, &out->list);
}

// The reverse plan of a strided conv: one live column per parent row (its
// intra-cell offset), the query its cell's key in the child table.
inline void build_reverse_plan(const LevelData& parent, const LevelData& child,
                               const int64_t* child_grid, const int64_t* stride,
                               int64_t kd, int64_t q_cap, int64_t child_cap,
                               const PlanShape& ps, PlanResult* out) {
  const int64_t n_tiles = (q_cap + kTileT - 1) / kTileT;
  const int64_t max_start = conv_max_start(child_cap, ps.window_r);
  const int64_t n_par = int64_t(parent.keys.size());
  out->start.assign(size_t(n_tiles * kd), 0);
  std::vector<int64_t> mpos(static_cast<size_t>(n_par));
  for (int64_t kk = 0; kk < kd; ++kk) {
    int64_t j = 0;
    for (int64_t i = 0; i < n_par; ++i) {
      const int32_t* c = parent.coords.data() + i * 3;
      const int64_t off_id =
          ((c[0] % stride[0]) * stride[1] + c[1] % stride[1]) * stride[2] +
          c[2] % stride[2];
      if (off_id != kk) {
        mpos[size_t(i)] = -1;
        continue;
      }
      const int64_t q =
          (int64_t(c[0] / stride[0]) * child_grid[1] + c[1] / stride[1]) *
              child_grid[2] +
          c[2] / stride[2];
      mpos[size_t(i)] = walk_find(child.keys, q, &j);
    }
    column_starts(mpos, n_par, n_tiles, kd, kk, ps.window_r, max_start,
                  out->start.data(), &out->list);
  }
  finish_list(n_par, ps.overflow_cap, &out->list);
}

// Offsets of a kernel, row-major: centered (-k/2 .. k/2) or from 0.
inline std::vector<int64_t> kernel_offsets(const int64_t* ksize, bool centered) {
  int64_t lo[3], hi[3];
  for (int d = 0; d < 3; ++d) {
    lo[d] = centered ? -(ksize[d] / 2) : 0;
    hi[d] = centered ? ksize[d] / 2 : ksize[d] - 1;
  }
  std::vector<int64_t> out;
  for (int64_t a = lo[0]; a <= hi[0]; ++a)
    for (int64_t b = lo[1]; b <= hi[1]; ++b)
      for (int64_t c = lo[2]; c <= hi[2]; ++c) out.insert(out.end(), {a, b, c});
  return out;
}

// The sorted level-0 site list of a padded coords block (a row with a
// negative coordinate is padding).
inline LevelData level0_from_coords(const int32_t* coords, int64_t cap,
                                    const int64_t* grid) {
  std::vector<std::pair<int64_t, int64_t>> rows;
  rows.reserve(size_t(cap));
  for (int64_t i = 0; i < cap; ++i) {
    const int32_t* c = coords + i * 3;
    if (c[0] < 0 || c[1] < 0 || c[2] < 0) continue;
    rows.emplace_back((int64_t(c[0]) * grid[1] + c[1]) * grid[2] + c[2], i);
  }
  std::sort(rows.begin(), rows.end());
  LevelData out;
  out.keys.reserve(rows.size());
  out.coords.reserve(rows.size() * 3);
  for (const auto& kv : rows) {
    out.keys.push_back(kv.first);
    const int32_t* c = coords + kv.second * 3;
    out.coords.insert(out.coords.end(), {c[0], c[1], c[2]});
  }
  return out;
}

// unique(coords // stride) under the child capacity: the lowest keys stay,
// the rest are counted in `dropped`.
inline LevelData downsample_level(const LevelData& parent, const int64_t* stride,
                                  const int64_t* child_grid, int64_t child_cap) {
  std::vector<int64_t> child;
  child.reserve(parent.keys.size());
  const int64_t n = int64_t(parent.coords.size() / 3);
  for (int64_t i = 0; i < n; ++i) {
    const int32_t* c = parent.coords.data() + i * 3;
    child.push_back((int64_t(c[0] / stride[0]) * child_grid[1] +
                     c[1] / stride[1]) * child_grid[2] + c[2] / stride[2]);
  }
  std::sort(child.begin(), child.end());
  child.erase(std::unique(child.begin(), child.end()), child.end());
  LevelData out;
  out.dropped = std::max<int64_t>(int64_t(child.size()) - child_cap, 0);
  if (int64_t(child.size()) > child_cap) child.resize(size_t(child_cap));
  out.keys = child;
  out.coords.reserve(child.size() * 3);
  for (int64_t key : child) {
    const int32_t c2 = int32_t(key % child_grid[2]);
    key /= child_grid[2];
    const int32_t c1 = int32_t(key % child_grid[1]);
    out.coords.insert(out.coords.end(), {int32_t(key / child_grid[1]), c1, c2});
  }
  return out;
}

// The geometry shared by every event of a batch.
struct Geometry {
  int64_t depth;
  std::vector<int64_t> grids;    // [depth + 1, 3]: each level's grid
  std::vector<int64_t> caps;     // [depth + 1]
  int64_t initial_kernel[3];
  std::vector<int64_t> series_kernels;  // [depth + 1, 3]
  int64_t stride[3];
  PlanShape initial;
  std::vector<PlanShape> series;  // depth + 1
  std::vector<PlanShape> down;    // depth: forward (and the list width of
                                  // the reverse)
  int64_t window_r_rev;
};

inline void build_event_plans(const int32_t* coords0, int64_t cap0,
                              const Geometry& g, EventPlans* ev) {
  const int64_t one[3] = {1, 1, 1};
  const int64_t depth = g.depth;
  ev->levels.resize(size_t(depth + 1));
  ev->levels[0] = level0_from_coords(coords0, cap0, g.grids.data());
  for (int64_t l = 1; l <= depth; ++l)
    ev->levels[size_t(l)] = downsample_level(
        ev->levels[size_t(l - 1)], g.stride, g.grids.data() + l * 3,
        g.caps[size_t(l)]);

  const std::vector<int64_t> d_offs = kernel_offsets(g.stride, false);
  const int64_t kd = int64_t(d_offs.size() / 3);
  ev->series.resize(size_t(depth + 1));
  ev->down_f.resize(size_t(depth));
  ev->down_r.resize(size_t(depth));
  for (int64_t l = 0; l <= depth; ++l) {
    const LevelData& lv = ev->levels[size_t(l)];
    const int64_t cap = g.caps[size_t(l)];
    const int64_t* grid = g.grids.data() + l * 3;
    const int64_t n = int64_t(lv.keys.size());
    if (l == 0)
      build_plan(lv, grid, lv.coords.data(), n, cap,
                 kernel_offsets(g.initial_kernel, true), one, g.initial, cap,
                 &ev->initial);
    build_plan(lv, grid, lv.coords.data(), n, cap,
               kernel_offsets(g.series_kernels.data() + l * 3, true), one,
               g.series[size_t(l)], cap, &ev->series[size_t(l)]);
    if (l == depth) continue;
    const LevelData& ch = ev->levels[size_t(l + 1)];
    const int64_t ch_cap = g.caps[size_t(l + 1)];
    build_plan(lv, grid, ch.coords.data(), int64_t(ch.keys.size()), ch_cap,
               d_offs, g.stride, g.down[size_t(l)], cap,
               &ev->down_f[size_t(l)]);
    build_reverse_plan(lv, ch, g.grids.data() + (l + 1) * 3, g.stride, kd, cap,
                       ch_cap, {g.window_r_rev, g.down[size_t(l)].overflow_cap},
                       &ev->down_r[size_t(l)]);
  }
}

}  // namespace seid_plans
