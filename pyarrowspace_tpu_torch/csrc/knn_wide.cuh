// The route of lists past the narrow limit: a split walk whose survivors
// are staged, sorted and merged into partial lists in device memory, and a
// second launch that merges the splits.  K1's lists past 128 (knn.cu, and
// K1t's in knn_t.cu) and K2's past 128 (scan_topk.cu) take all of it; K7's
// wide lists (scan_int8.cu) take its keys, its sort, its in-place merge,
// its per-query staging (below) and its split merge, under their own walk;
// K6's lists past 256 (ivf_scan.cu) its keys, sort, merge and per-query
// staging, merged into the output rows.
//
// Two orders, one key each (below): Asc, K1's ascending (distance, id),
// the empty entry (2.0, -1); Desc, K2's, K6's and K7's descending score
// with ascending ids, the empty entry (-3e38, -1).  A list is the k least
// keys of its candidates, the lexicographic top-k on any data.
//
// Launch 1 (scan_kernel): one block of 256 threads per (128-row block,
// column split).  The splits are contiguous ranges of the block's walk of
// 128-column tiles (from col_start, rotated for diag_start), planned by the
// caller (knn.py / scan_topk.py plan_splits) so that row blocks times
// splits fill a wave of SMs.  Per tile: ffma_tile.cuh's register-tiled fp32
// product (each value one fmaf chain over ascending features, the bits of
// the narrow routes), the epilogue's value (Epi: K1's masked distance, K2's
// blend with ids >= n masked) into a shared 128 x 136 tile that also flags
// each row holding a candidate that beats the row's filter (its partial
// list's kth, or the better kth another split of the row has reached: a
// shared bound), then one warp per flagged row appends the survivors, as
// 64-bit keys, to the row's buffer of 128 in shared memory.  A buffer that
// cannot take them spills, unsorted, to the row's staging row in device
// memory (about k keys, 128 to 896); a staging row that could not take
// another spill is merged at the end of the tile, when the epilogue's region
// is free: staged and buffered keys sorted there by the row's warp and merged into
// the row's sorted partial list in device memory in one pass (merge_into),
// which gives the new kth.  What is left is merged at the end of the split.
//
// Launch 2 (merge_kernel): one warp per row merges the S partial lists, in
// split order, into the output row, which holds the row's seed list (K1's
// col_start + seed), its own walk's list (K1's symmetric route, whose one
// partial list a row is its transposed list), or empty entries (written
// first when asked: K2, K7):
// any row-major or slot-major output (K1, K1t), and rows placed by perm.
//
// The keys.  Asc: order_key(d) << 32 | id ^ 0x80000000 (select.cuh's
// order_key, which folds -0.0 into +0.0 as the float compares of the filter
// do; a distance computed here is never -0.0, since 1 - x rounds to +0.0,
// so the key decodes to the distance's own bits).  Desc: ~order_key(s) <<
// 32 | id << 1 | (s is -0.0): a larger score sorts first, then a smaller id
// (ids of survivors lie in [0, 2^31)), and the low bit keeps a -0.0 score's
// sign, which the fold loses, so the key decodes to the score's own bits.
// Every list of K1, K2 and K7 holds distinct ids, the columns of different
// splits and tiles differ, and a seed's ids lie outside the walk's columns,
// so there a survivor's key never equals a list entry's.  K6's probe table
// may name a cluster twice; its rows are then offered twice, and equal keys
// meet in the merge, which places a list entry before an equal staged key
// (merge_into's counts), so every slot is written once and the list stays
// sorted: the top-k of the candidates counted with their repeats, as the
// narrow insertion and the plain version keep them.  The filter in front of
// the keys is the order's strict lexicographic compare against the kth
// (tile_common.cuh MinLex / MaxLex), so the empty entry never enters, nor a
// masked value (K1's 2.0, K2's and K6's -3e38), nor a NaN, which fails
// every compare.
//
// What bounds it: the products, as the narrow routes (2 R N F fp32
// multiply-adds).  A row's survivors number about k (1 + ln(C / k)) over a
// split of C columns, and each merge is one pass over the list from its
// first changed slot, of device-memory traffic (at k 1,024 on 2,048 rows
// the partial lists take 134 MB, past L2): staging about k survivors before
// a merge makes those passes few (about log2 of the walk's tiles a split,
// against about k (1 + ln(C / k)) / 128 with the buffer alone), in place of
// a warp-wide ballot and shift for every survivor, the insertion the
// narrow lists keep (tile_common.cuh offer).

#pragma once

#include <cuda_runtime.h>

#include <climits>
#include <cstddef>
#include <cstdint>
#include <type_traits>

#include "ffma_tile.cuh"
#include "select.cuh"
#include "tile_common.cuh"

namespace knn_wide {

constexpr int BUF = 128;      // survivors a row buffers in shared memory
constexpr int STAGE = 896;    // and then stages in device memory, at most
constexpr int SCRATCH = 1024; // keys of a warp's merge source, sorted
// The epilogue region of launch 1: the tile's values, then the warps'
// sorted keys.
constexpr int EPI_BYTES = regtile::RES_BYTES > regtile::WARPS * SCRATCH * 8
                              ? regtile::RES_BYTES
                              : regtile::WARPS * SCRATCH * 8;
static_assert(STAGE + BUF <= SCRATCH,
              "a row's sorted keys fit its warp's part of the region");
constexpr int MERGE_WARPS = 8;
constexpr unsigned FULL = 0xffffffffu;

// One entry of a list in device memory.
struct alignas(8) Ent {
  float v;
  int id;
};

// Ascending (distance, id): K1.
struct Asc {
  static constexpr float EMPTY = 2.0f;
  static __device__ __forceinline__ uint64_t key(float d, int id) {
    return (uint64_t)sel::order_key(d) << 32 | ((uint32_t)id ^ 0x80000000u);
  }
  static __device__ __forceinline__ Ent unkey(uint64_t k) {
    return Ent{sel::key_value((uint32_t)(k >> 32)),
               (int)((uint32_t)k ^ 0x80000000u)};
  }
  static __device__ __forceinline__ bool better(float v, int i, float w,
                                                int j) {
    return tile::MinLex::better(v, i, w, j);
  }
};

// Descending score, ascending id: K2 and K7.
struct Desc {
  static constexpr float EMPTY = tile::NEG_SCORE;
  static __device__ __forceinline__ uint64_t key(float s, int id) {
    const uint32_t neg_zero = __float_as_uint(s) == 0x80000000u;
    return (uint64_t)(~sel::order_key(s)) << 32 |
           ((uint32_t)id << 1 | neg_zero);
  }
  static __device__ __forceinline__ Ent unkey(uint64_t k) {
    const uint32_t lo = (uint32_t)k;
    const float s = sel::key_value(~(uint32_t)(k >> 32));
    return Ent{(lo & 1u) ? -0.0f : s, (int)(lo >> 1)};
  }
  static __device__ __forceinline__ bool better(float v, int i, float w,
                                                int j) {
    return tile::MaxLex::better(v, i, w, j);
  }
};

// A list of k entries in a partial-list row.
struct PartList {
  Ent* p;
  __device__ __forceinline__ Ent get(int s) const { return p[s]; }
  __device__ __forceinline__ void put(int s, Ent e) const { p[s] = e; }
};

// A list in the output: slot s of the row at v[s * stride], i[s * stride].
struct OutList {
  float* v;
  int* i;
  size_t stride;
  __device__ __forceinline__ Ent get(int s) const {
    return Ent{v[s * stride], i[s * stride]};
  }
  __device__ __forceinline__ void put(int s, Ent e) const {
    v[s * stride] = e.v;
    i[s * stride] = e.id;
  }
};

// Sorted sources of a merge: keys (in shared or device memory), or a
// partial list.
template <class O>
struct KeySrc {
  const uint64_t* k;
  __device__ __forceinline__ uint64_t key_at(int i) const { return k[i]; }
  __device__ __forceinline__ Ent at(int i) const { return O::unkey(k[i]); }
};
template <class O>
struct PartSrc {
  const Ent* p;
  __device__ __forceinline__ uint64_t key_at(int i) const {
    const Ent e = p[i];
    return O::key(e.v, e.id);
  }
  __device__ __forceinline__ Ent at(int i) const { return p[i]; }
};

// The number of src[0..m) keys below x (src ascending).
template <class Src>
__device__ __forceinline__ int count_below(const Src& src, int m,
                                           uint64_t x) {
  int lo = 0, hi = m;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (src.key_at(mid) < x)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// count_below for U keys at once, in one loop of fixed trip count (m is
// the same for all), so that the U searches overlap.
template <int U, class Src>
__device__ __forceinline__ void count_below(const Src& src, int m,
                                            const uint64_t (&x)[U],
                                            int (&pos)[U]) {
  int step = 1;
  while (step * 2 <= m) step *= 2;
#pragma unroll
  for (int u = 0; u < U; ++u) pos[u] = 0;
  for (; step > 0; step >>= 1) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int p = pos[u] + step;
      if (p <= m && src.key_at(p - 1) < x[u]) pos[u] = p;
    }
  }
}

// Entries g + 32 u + lane of L (u < U), the empty entry past k.
template <class O, int U, class List>
__device__ __forceinline__ void read_window(const List& L, int k, int g,
                                            int lane, Ent (&e)[U]) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int j = g + 32 * u + lane;
    e[u] = j < k ? L.get(j) : Ent{O::EMPTY, -1};
  }
}

// Merge the m ascending entries of src into the ascending list L[0..k) in
// place, keeping the k least.  List entry j goes to j + (src entries below
// it), src entry i to i + (list entries below or equal to it): a list entry
// comes before an equal src entry, so equal keys (K6's repeated probes) still
// fill every slot once.  The list is walked in windows of 32 U slots from the
// top down, lane l holding slots g + 32 u + l: every write lands at or above
// its window, so the window below, read ahead during this one, is still
// unchanged, and no barrier waits for that read.  The src entries between
// slots j - 1 and j are written by the lane that holds j, those below a
// window's first slot g by the lane that holds g - 1, in the next window.
// Stops below the first slot that changes.  Called by all 32 lanes of one
// warp.
template <class O, class List, class Src>
__device__ __forceinline__ void merge_into(const List& L, int k,
                                           const Src& src, int m, int lane) {
  constexpr int U = 4;
  constexpr int WIN = 32 * U;
  if (m == 0) return;
  int g = (k - 1) / WIN * WIN;
  Ent e[U];
  read_window<O, U>(L, k, g, lane, e);
  int pend = m;   // src entries below slot g + WIN
  while (true) {
    uint64_t x[U];
#pragma unroll
    for (int u = 0; u < U; ++u)   // a slot past k counts every src entry
      x[u] = g + 32 * u + lane < k ? O::key(e[u].v, e[u].id) : ~0ull;
    int hi[U];
    count_below<U>(src, m, x, hi);
    // Every lane has read its slots of the window before this exchange,
    // and writes them only after it.
    const int top = __shfl_sync(FULL, hi[0], 0);   // src entries below slot g
    const bool last = top == 0 || g == 0;
    Ent next[U];
    if (!last) read_window<O, U>(L, k, g - WIN, lane, next);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = g + 32 * u + lane;
      int lo = __shfl_up_sync(FULL, hi[u], 1);
      const int below = __shfl_sync(FULL, hi[u > 0 ? u - 1 : 0], 31);
      if (lane == 0) lo = u > 0 ? below : g == 0 ? 0 : hi[0];
      if (j < k && j + hi[u] < k) L.put(j + hi[u], e[u]);
      for (int i = lo; i < hi[u] && i + j < k; ++i) L.put(i + j, src.at(i));
    }
    if (lane == 31) {   // the src entries below the window above
      const int j = g + WIN;
      for (int i = hi[U - 1]; i < pend && i + j < k; ++i)
        L.put(i + j, src.at(i));
    }
    if (last) break;
    pend = top;
    g -= WIN;
#pragma unroll
    for (int u = 0; u < U; ++u) e[u] = next[u];
  }
  __syncwarp();
}

// Sort keys[0..P) ascending by the 32 lanes of one warp: a bitonic sort in
// shared memory, a step's P / 64 compare-exchanges a lane taken 4 at a
// time, unrolled, so that their loads overlap.
template <int P>
__device__ __forceinline__ void sort_keys(uint64_t* keys, int lane) {
  constexpr int PAIRS = P / 64, GROUP = PAIRS < 4 ? PAIRS : 4;
#pragma unroll 1
  for (int kk = 2; kk <= P; kk <<= 1) {
#pragma unroll 1
    for (int j = kk >> 1; j > 0; j >>= 1) {
#pragma unroll
      for (int u0 = 0; u0 < PAIRS; u0 += GROUP) {
        uint64_t x[GROUP], y[GROUP];
        int at[GROUP];
#pragma unroll
        for (int u = 0; u < GROUP; ++u) {
          const int t = lane + 32 * (u0 + u);
          at[u] = ((t & ~(j - 1)) << 1) | (t & (j - 1));
          x[u] = keys[at[u]];
          y[u] = keys[at[u] + j];
        }
#pragma unroll
        for (int u = 0; u < GROUP; ++u) {
          if (((at[u] & kk) == 0) == (x[u] > y[u])) {
            keys[at[u]] = y[u];
            keys[at[u] + j] = x[u];
          }
        }
      }
      __syncwarp();
    }
  }
}

// Gather n <= P keys (the first `staged` from stage, the rest from buf)
// into keys[0..P), the rest padded with all ones, and sort them.
template <int P>
__device__ __forceinline__ void gather_sorted(const uint64_t* stage,
                                              int staged,
                                              const uint64_t* buf, int n,
                                              uint64_t* keys, int lane) {
  for (int e = lane; e < P; e += 32)
    keys[e] = e < staged ? stage[e] : e < n ? buf[e - staged] : ~0ull;
  __syncwarp();
  sort_keys<P>(keys, lane);
}

// Sort cnt <= P keys (the first `staged` from stage, the rest from buf) in
// the warp's scratch of P keys, in the narrowest power of two from MIN_P
// that holds them, and merge them into the list l of k (PartList, OutList)
// in one pass; returns the list's new kth.  Called by all 32 lanes of one
// warp.
template <class O, int P, int MIN_P = 128, class List>
__device__ __forceinline__ Ent sort_merge(const uint64_t* stage, int staged,
                                          const uint64_t* buf, int cnt,
                                          uint64_t* scratch, const List& l,
                                          int k, int lane) {
  if constexpr (P > MIN_P) {
    if (cnt <= P / 2)
      return sort_merge<O, P / 2, MIN_P>(stage, staged, buf, cnt, scratch, l,
                                         k, lane);
  }
  gather_sorted<P>(stage, staged, buf, cnt, scratch, lane);
  merge_into<O>(l, k, KeySrc<O>{scratch}, cnt, lane);
  const Ent kth = l.get(k - 1);
  __syncwarp();
  return kth;
}

// The state launch 1 keeps for each row of its block in shared memory.
struct Rows {
  int fill[regtile::TILE];      // keys in the row's buffer
  int staged[regtile::TILE];    // keys in the row's staging row
  int hit[regtile::TILE];       // the tile holds a survivor for the row
  int due[regtile::TILE];       // the staging row is to be merged
  float thr_v[regtile::TILE];   // the filter: the partial list's kth, or
  int thr_i[regtile::TILE];     // the row's shared bound when better
  int any_due;                  // a row of the block is due
};

// Make (v, id) row rr's filter if it is better.
template <class O>
__device__ __forceinline__ void lower_filter(Rows& rows, int rr, float v,
                                             int id) {
  if (O::better(v, id, rows.thr_v[rr], rows.thr_i[rr])) {
    rows.thr_v[rr] = v;
    rows.thr_i[rr] = id;
  }
}

// Merge row rr's staged and buffered keys into its partial list: sorted in
// the warp's scratch in shared memory, then merged in one pass; the list's
// new kth tightens the row's filter and, across splits, its shared bound.
// Called by all 32 lanes of one warp.
template <class O>
__device__ __forceinline__ void flush(const uint64_t* stage,
                                      const uint64_t* buf, uint64_t* scratch,
                                      Ent* list, int k, Rows& rows, int rr,
                                      unsigned long long* bound, int lane) {
  const int staged = rows.staged[rr], cnt = staged + rows.fill[rr];
  const Ent kth = sort_merge<O, SCRATCH>(stage, staged, buf, cnt, scratch,
                                         PartList{list}, k, lane);
  if (lane == 0) {
    rows.fill[rr] = rows.staged[rr] = rows.due[rr] = 0;
    lower_filter<O>(rows, rr, kth.v, kth.id);
    if (bound) atomicMin(bound, (unsigned long long)O::key(kth.v, kth.id));
  }
  __syncwarp();
}

// -- per-query staging: K6's and K7's wide lists, under their own walks --
//
// Each query stages its survivors, as Desc keys, in a row of SROW keys in
// device memory, and keeps a filter (WideRow: its list's kth, refreshed at
// each merge, or its shared bound across splits when better); a staging
// row that could not take the walk's next tile or step is sorted in the
// warp's scratch of SROW keys (4 KB) and merged into the query's list in
// one pass (flush_row).

constexpr int SROW = 512;   // keys a query stages before a merge

// A wide list's query in shared memory: its staged keys and its filter.
struct WideRow {
  int staged;    // keys in the query's staging row
  float thr_v;   // the filter: the list's kth, or the query's shared
  int thr_i;     // bound when better
};

// Empty lists [n_rows][k] (lists.put(e, ...) for e < n_rows * k: a
// PartList or an OutList of stride 1) and rows [n_state].  Called by every
// thread of the block; a barrier follows.
template <class Lists>
__device__ __forceinline__ void wide_start(const Lists& lists, int n_rows,
                                           int k, WideRow* rows, int n_state,
                                           int tid, int threads) {
  for (int e = tid; e < n_rows * k; e += threads)
    lists.put(e, Ent{Desc::EMPTY, -1});
  for (int r = tid; r < n_state; r += threads)
    rows[r] = WideRow{0, Desc::EMPTY, -1};
}

// Tighten a query's filter to its shared bound b (read from L2).
__device__ __forceinline__ void refresh(WideRow& w, unsigned long long b) {
  if (b < Desc::key(w.thr_v, w.thr_i)) {
    const Ent e = Desc::unkey(b);
    w.thr_v = e.v;
    w.thr_i = e.id;
  }
}

// Sort a query's w.staged keys (stage) in the warp's scratch of SROW keys
// (in the narrowest power of two from MIN_P that holds them) and merge them
// into its list; the list's new kth tightens the query's filter and its
// shared bound (null for none).  Called by all 32 lanes of one warp.
template <int MIN_P = 128, class List>
__device__ __forceinline__ void flush_row(const uint64_t* stage,
                                          uint64_t* scratch, const List& list,
                                          int k, WideRow& w,
                                          unsigned long long* bound,
                                          int lane) {
  const int staged = w.staged;
  const Ent kth = sort_merge<Desc, SROW, MIN_P>(stage, staged, nullptr,
                                                staged, scratch, list, k,
                                                lane);
  if (lane == 0) {
    w.staged = 0;
    if (Desc::better(kth.v, kth.id, w.thr_v, w.thr_i)) {
      w.thr_v = kth.v;
      w.thr_i = kth.id;
    }
    if (bound) atomicMin(bound, (unsigned long long)Desc::key(kth.v, kth.id));
  }
  __syncwarp();
}

// K1's epilogue: d = 1 - max(0, x_i . x_j), self, columns >= n and d > eps
// masked to 2.0.
struct KnnEpi {
  using Order = Asc;
  float eps;
  __device__ __forceinline__ void load(int, int, int, int) {}
  __device__ __forceinline__ float value(float acc, int, int, int row,
                                         int col, int n) const {
    const float d = 1.0f - fmaxf(acc, 0.0f);
    return col == row || col >= n || d > eps ? Asc::EMPTY : d;
  }
};

// Launch 1 (see the top of this file): rows [row_start, row_start +
// row_count) of a against the columns [col_start, n) of b, both [*, f] of
// T (float, or bf16 converted exactly), with Epi's values and order.
// part: [splits, row_count, k] partial lists; bound (null for one split):
// row_count keys, each the least kth key any split of the row has reached
// (all ones at the start); stage: [splits, row_count, STAGE] keys, of which
// a row fills stage_keys before they are merged.  ops: the row view of a
// from row_start and the column view of b from col_start; Ring: the
// product's loader over the shared memory laid out by pl.
// Any split's kth bounds the row's final kth, and an entry of the final
// list beats every such kth when it is offered (its key differs from every
// listed one), so a split may filter against the best: each partial list
// still holds every final entry of its columns, and the merge gives the
// same list whatever the order in which the splits ran.
template <class Ring, class Epi>
__global__ void __launch_bounds__(regtile::THREADS, 1)
    scan_kernel(const __grid_constant__ regtile::Operands<
                    typename Ring::Elem> ops,
                const Epi epi, const regtile::Plan pl, int n, int row_start,
                int row_count, int k, int col_start, int diag_start,
                const int* __restrict__ perm, int tiles_per_split, Ent* part,
                unsigned long long* bound, uint64_t* stage, int stage_keys) {
  using namespace regtile;
  using O = typename Epi::Order;
  extern __shared__ __align__(1024) char ffma_smem[];
  // The tile's values [128][RES_LD] in the epilogue region; a warp's sorted
  // keys there too, between a tile's merge and the next tile's epilogue.
  float* Vs = reinterpret_cast<float*>(ffma_smem + pl.epi);
  uint64_t* scratch = reinterpret_cast<uint64_t*>(ffma_smem + pl.epi) +
                      (threadIdx.x >> 5) * SCRATCH;
  uint64_t* bufs = reinterpret_cast<uint64_t*>(ffma_smem + pl.rest);
  Rows& rows = *reinterpret_cast<Rows*>(bufs + TILE * BUF);
  int* col_ids = reinterpret_cast<int*>(&rows + 1);   // the ids offered (perm)

  const int tid = threadIdx.x;
  const int tx = thread_x(), ty = thread_y();
  const int lane = tid & 31, warp = tid >> 5;
  const int r0 = row_start + blockIdx.x * TILE;
  const int r_end = row_start + row_count;
  const int n_rows = min(TILE, r_end - r0);
  const size_t row0 = (size_t)blockIdx.y * row_count + (r0 - row_start);
  Ent* lists = part + row0 * k;
  stage += row0 * STAGE;
  if (bound) bound += r0 - row_start;
  for (int e = tid; e < n_rows * k; e += THREADS)
    lists[e] = Ent{O::EMPTY, -1};
  if (tid < TILE) {
    rows.fill[tid] = rows.staged[tid] = rows.hit[tid] = rows.due[tid] = 0;
    rows.thr_v[tid] = O::EMPTY;
    rows.thr_i[tid] = -1;
  }
  if (tid == 0) rows.any_due = 0;
  Ring ring(ffma_smem, pl, ops, r0 - row_start);
  ring.start();   // its barrier orders these writes before any merge
  // Lanes 0..15 of warp w refresh the filters of its rows w + 8 lane.
  const int own = warp + WARPS * lane;
  const bool refresh = bound && lane < TILE / WARPS && own < n_rows;

  const int n_tiles = (n - col_start + TILE - 1) / TILE;
  int t0 = 0;
  if (diag_start && r0 >= col_start) t0 = ((r0 - col_start) / TILE) % n_tiles;
  // The first column of the s-th tile of the walk.
  auto tile_c0 = [&](int s) {
    const int t = t0 + s < n_tiles ? t0 + s : t0 + s - n_tiles;
    return col_start + t * TILE;
  };
  const int s_begin = blockIdx.y * tiles_per_split;
  const int s_end = min(n_tiles, s_begin + tiles_per_split);
  for (int s = s_begin; s < s_end; ++s) {
    const int c0 = tile_c0(s);
    const int nb = s + 1 < s_end ? tile_c0(s + 1) - col_start : -1;
    if (perm && tid < TILE)
      col_ids[tid] = c0 + tid < n ? perm[c0 + tid] : INT_MAX;
    // The other splits' bounds, read under the product (from L2).
    const unsigned long long shared_kth = refresh ? __ldcg(bound + own) : 0;
    float acc[MICRO][MICRO];
    ring.product(c0 - col_start, nb, acc);
    // The values into Vs; a row whose thread holds a candidate that beats
    // the row's filter is flagged (the filters do not change before the
    // merge).  Rows past the end are flagged at most, never merged.
    Epi ep = epi;
    ep.load(r0, r_end, c0, n);
#pragma unroll
    for (int i = 0; i < MICRO; ++i) {
      const int rr = ty + 16 * i;
      const float tv = rows.thr_v[rr];
      const int ti = rows.thr_i[rr];
      bool hit = false;
#pragma unroll
      for (int j = 0; j < MICRO; ++j) {
        const int col = c0 + tx + 16 * j;
        const float v = ep.value(acc[i][j], i, j, r0 + rr, col, n);
        Vs[rr * RES_LD + tx + 16 * j] = v;
        hit |= O::better(v, perm ? col_ids[tx + 16 * j] : col, tv, ti);
      }
      if (hit) rows.hit[rr] = 1;
    }
    __syncthreads();
    for (int rr = warp; rr < n_rows; rr += WARPS) {
      if (!rows.hit[rr]) continue;
      const float* vrow = Vs + rr * RES_LD;
      const float tv = rows.thr_v[rr];
      const int ti = rows.thr_i[rr];
      float v[4];
      int id[4];
      unsigned bal[4];
      int m = 0;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int c = lane + 32 * q;
        v[q] = vrow[c];
        id[q] = perm ? col_ids[c] : c0 + c;
        bal[q] = __ballot_sync(FULL, O::better(v[q], id[q], tv, ti));
        m += __popc(bal[q]);
      }
      // The ballots order every lane's read of the flag before it is
      // cleared.
      if (lane == 0) rows.hit[rr] = 0;
      if (m == 0) continue;
      uint64_t* buf = bufs + rr * BUF;
      int cnt = rows.fill[rr];
      if (cnt + m > BUF) {
        // Spill the buffer to the staging row; a staging row that could
        // not take the next spill is merged at the end of the tile.
        const int staged = rows.staged[rr];
        uint64_t* dst = stage + (size_t)rr * STAGE + staged;
        for (int e = lane; e < cnt; e += 32) dst[e] = buf[e];
        __syncwarp();
        if (lane == 0) {
          rows.staged[rr] = staged + cnt;
          if (staged + cnt > stage_keys - BUF)
            rows.due[rr] = rows.any_due = 1;
        }
        cnt = 0;
      }
      int base = cnt;
      const unsigned below = (1u << lane) - 1u;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if ((bal[q] >> lane) & 1u)
          buf[base + __popc(bal[q] & below)] = O::key(v[q], id[q]);
        base += __popc(bal[q]);
      }
      __syncwarp();
      if (lane == 0) rows.fill[rr] = cnt + m;
    }
    __syncthreads();
    if (rows.any_due) {   // the region is free until the next epilogue
      for (int rr = warp; rr < n_rows; rr += WARPS)
        if (rows.due[rr])
          flush<O>(stage + (size_t)rr * STAGE, bufs + rr * BUF, scratch,
                   lists + (size_t)rr * k, k, rows, rr,
                   bound ? bound + rr : nullptr, lane);
      __syncthreads();
      if (tid == 0) rows.any_due = 0;
    }
    if (refresh && shared_kth < O::key(rows.thr_v[own], rows.thr_i[own])) {
      const Ent e = O::unkey(shared_kth);
      rows.thr_v[own] = e.v;
      rows.thr_i[own] = e.id;
    }
  }
  __syncthreads();
  for (int rr = warp; rr < n_rows; rr += WARPS)
    if (rows.staged[rr] + rows.fill[rr] > 0)
      flush<O>(stage + (size_t)rr * STAGE, bufs + rr * BUF, scratch,
               lists + (size_t)rr * k, k, rows, rr,
               bound ? bound + rr : nullptr, lane);
}

// Launch 2: one warp per row merges the row's S partial lists into its
// output row, in split order: the row's seed entries, or (fill) empty
// entries written first.  Row r of the launch is output row perm[row_start
// + r], or r; a row's slot s lies at out + row * row_stride + s *
// slot_stride.
template <class O>
__global__ void __launch_bounds__(MERGE_WARPS * 32)
    merge_kernel(const Ent* __restrict__ part, int row_start, int row_count,
                 int k, int splits, const int* __restrict__ perm,
                 float* out_v, int* out_i, size_t row_stride,
                 size_t slot_stride, int fill) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * MERGE_WARPS + (threadIdx.x >> 5);
  if (r >= row_count) return;   // whole warp leaves together
  const size_t row = perm ? (size_t)perm[row_start + r] : (size_t)r;
  const OutList list{out_v + row * row_stride, out_i + row * row_stride,
                     slot_stride};
  if (fill) {
    for (int s = lane; s < k; s += 32) list.put(s, Ent{O::EMPTY, -1});
    __syncwarp();
  }
  for (int s = 0; s < splits; ++s) {
    const PartSrc<O> src{part + ((size_t)s * row_count + r) * k};
    const Ent kth = list.get(k - 1);
    // The entries that beat the kth form a prefix of the partial list.
    merge_into<O>(list, k, src, count_below(src, k, O::key(kth.v, kth.id)),
                  lane);
  }
}

// Launch 2 alone (K1's narrow split walk and symmetric route, K7's wide
// lists, and below).
template <class O>
inline int merge(const Ent* lists, int row_start, int row_count, int k,
                 int splits, const int* perm, float* out_v, int* out_i,
                 size_t row_stride, size_t slot_stride, int fill,
                 cudaStream_t st) {
  merge_kernel<O><<<(row_count + MERGE_WARPS - 1) / MERGE_WARPS,
                    MERGE_WARPS * 32, 0, st>>>(lists, row_start, row_count, k,
                                               splits, perm, out_v, out_i,
                                               row_stride, slot_stride, fill);
  return (int)cudaGetLastError();
}

// Keys a row stages before they are merged: about k, from BUF to STAGE.
// Each merge is a pass over the list, and staging keeps the filter stale
// for longer, so short lists merge more often.
inline int stage_cap(int k) {
  return k < BUF ? BUF : k / BUF * BUF < STAGE ? k / BUF * BUF : STAGE;
}

// Launch 1's other shared memory: the row buffers, the rows' state and
// the tile's ids.
constexpr size_t REST_BYTES = (size_t)regtile::TILE * BUF * sizeof(uint64_t) +
                              sizeof(Rows) + regtile::TILE * sizeof(int);

// Launch 1's shared memory with the TMA loader (tma) or the register-staged
// one.
inline regtile::Plan scan_plan(bool tma) {
  return regtile::plan(EPI_BYTES, REST_BYTES, tma);
}

// Both launches for rows [row_start, row_start + row_count) of a against
// the columns [col_start, n) of b, split into `splits` ranges of the walk,
// the product's operands staged by TMA (tma) or the register-staged loader.
// part holds, in 8-byte words, the partial lists [splits, row_count, k],
// row_count bounds and [splits, row_count, STAGE] staging rows.  out holds
// each row's seed list or empty entries, or (fill) is filled with empty
// entries first.  Returns a CUDA error code.
template <class T, class Epi>
inline int launch(const T* a, const T* b, const Epi& epi, int n, int f,
                  int row_start, int row_count, int k, int col_start,
                  int diag_start, const int* perm, int splits, void* part,
                  float* out_v, int* out_i, size_t row_stride,
                  size_t slot_stride, int fill, int tma, int device,
                  cudaStream_t st) {
  const int n_tiles = (n - col_start + regtile::TILE - 1) / regtile::TILE;
  if (splits < 1 || part == nullptr) return (int)cudaErrorInvalidValue;
  const int tiles_per_split = (n_tiles + splits - 1) / splits;
  if ((splits - 1) * tiles_per_split >= n_tiles)  // every split non-empty
    return (int)cudaErrorInvalidValue;
  const regtile::Plan pl = scan_plan(tma != 0);
  int smem_max = 0;
  cudaError_t err = cudaDeviceGetAttribute(
      &smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return (int)err;
  if (pl.stages == 0 || pl.bytes > smem_max) return (int)cudaErrorInvalidValue;
  regtile::Operands<T> ops;
  int e = regtile::make_operands(&ops, a + (size_t)row_start * f, row_count,
                                 b + (size_t)col_start * f, n - col_start, f,
                                 tma != 0);
  if (e != 0) return e;
  // part: the lists, then (several splits) the rows' shared bounds, then
  // the staging rows.
  Ent* lists = static_cast<Ent*>(part);
  unsigned long long* bound = reinterpret_cast<unsigned long long*>(
      lists + (size_t)splits * row_count * k);
  uint64_t* stage = reinterpret_cast<uint64_t*>(bound + row_count);
  if (splits > 1) {
    err = cudaMemsetAsync(bound, 0xff, (size_t)row_count * sizeof(*bound),
                          st);
    if (err != cudaSuccess) return (int)err;
  } else {
    bound = nullptr;   // one split needs none
  }
  const dim3 grid((row_count + regtile::TILE - 1) / regtile::TILE, splits);
  e = regtile::with_ring<T>(pl, tma != 0, [&](auto* ring) {
    auto scan = &scan_kernel<std::remove_pointer_t<decltype(ring)>, Epi>;
    cudaError_t r = cudaFuncSetAttribute(
        scan, cudaFuncAttributeMaxDynamicSharedMemorySize, pl.bytes);
    if (r != cudaSuccess) return (int)r;
    scan<<<grid, regtile::THREADS, pl.bytes, st>>>(
        ops, epi, pl, n, row_start, row_count, k, col_start, diag_start,
        perm, tiles_per_split, lists, bound, stage, stage_cap(k));
    return (int)cudaGetLastError();
  });
  if (e != 0) return e;
  return merge<typename Epi::Order>(lists, row_start, row_count, k, splits,
                                    perm, out_v, out_i, row_stride,
                                    slot_stride, fill, st);
}

// K1's route: rows [row_start, row_start + row_count) of the unit corpus xu
// [n, f] against its columns [col_start, n), out already holding each row's
// seed list or (2.0, -1) entries.  A template, so that K1's kernels are
// compiled only where it is called (knn.cu, knn_t.cu), not in every file
// that includes this header.
template <class Epi = KnnEpi>
inline int launch(const float* xu, int n, int f, int row_start,
                  int row_count, float eps, int k, int col_start,
                  int diag_start, const int* perm, int splits, void* part,
                  float* out_d, int* out_i, size_t row_stride,
                  size_t slot_stride, int tma, int device, cudaStream_t st) {
  return launch<float>(xu, xu, Epi{eps}, n, f, row_start, row_count, k,
                       col_start, diag_start, perm, splits, part, out_d,
                       out_i, row_stride, slot_stride, 0, tma, device, st);
}

}  // namespace knn_wide
