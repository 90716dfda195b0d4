// The tensor-core scan with a running top-k, generic over the operand type
// and the epilogue: K7's tensor-core route (scan_int8.cu, int8 rows,
// wgmma m64n128k32 s32.s8.s8, the scales and the blend) and K2's over bf16
// rows (scan_topk.cu, wgmma m64n128k16 f32.bf16.bf16, the blend alone).
//
// For every query it keeps the k largest scores epi gives its sums, in
// (score desc, id asc) order; corpus ids >= n never enter a list, nor a NaN
// or a score at or below -3e38 (the strict MaxLex compare against the
// empty slot (-3e38, -1)); rows come out descending.
//
// The block.  One block of two consumer warpgroups and a producer warp per
// (128-query block, corpus split).  The queries are A, the corpus rows B:
// warpgroup g multiplies its 64 queries against each 128-item tile over
// the features in ascending 128-byte stages (wgmma_tile.cuh's mma_stage),
// and its thread then holds the sums of two query rows and 32 items.  The
// corpus streams through a ring of 2 to 6 stages that the producer keeps
// full by TMA; both warpgroups read each stage, so a stage is released when
// both are done with it.  The block's queries either stay resident in
// shared memory (loaded once by TMA: 16 KB a stage) or, where they do not
// fit beside the ring (STREAM: a bf16 row past 640 features), ride each
// ring slot beside the corpus stage, read again from L2 for every tile:
// twice the bytes into the SM a tile, the price of a 128-query block at
// large F (64-query blocks would read the corpus twice as often, the same
// bytes).  When the ring holds a whole tile the two warpgroups take turns
// on the tensor cores (two named barriers), so that one's epilogue runs
// under the other's products; else they run in step.
//
// The epilogue runs in place in the accumulators: Epi::load reads the
// tile's item operands (32 items a thread, and whether every lambda of the
// warp lies in the fast reciprocal's range), Epi::score turns each sum into
// its score (tile::blend_fast, or tile::blend where a lambda is out of
// range) and sets bit i where sum i's score reaches its query's current
// kth (read once a tile) and the item is < n.  A warp owns the lists of its
// 16 queries, so the merge needs no block barrier.  Narrow lists (k <= 256
// when they fit beside two stages) live in shared memory: the survivors
// are compacted by ballot into the warp's buffer (256 entries, 2 KB) and
// offered to them one by one, MaxLex (the walk does not deliver a query's
// items in ascending order).  Wide lists take knn_wide.cuh's keys, sort
// and merge: each survivor that beats its query's filter (the strict
// (score, id) compare against its partial list's kth, or the best kth
// another split has reached) goes, as a descending key, onto the query's
// staging row of SROW (512) keys in device memory, at a place taken by a
// shared-memory atomic; a staging row that could not take another tile is
// sorted in the warp's scratch of SROW keys (4 KB) and merged into the
// query's partial list in device memory in one pass.
//
// The plan (tc_plan, from F and k alone; ops/cuda/scan_topk.py::tc_plan
// and scan_int8.py::wide_lists mirror it): the queries resident unless the
// route may stream them and they do not fit beside two stages with wide
// lists; the lists narrow when 128 of them fit beside two stages, else
// wide; then the deepest ring, up to 6 stages, that fits 232,448 bytes.
// K7 never streams (its F <= 1,024 int8 features are 128 KB at most).
//
// A second launch merges the splits' partial lists in split order:
// tile::merge_splits for narrow lists, knn_wide.cuh's split merge for wide
// ones.  Split s holds items before split s + 1's, so equal scores keep the
// smaller id.

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

#include "knn_wide.cuh"
#include "tile_common.cuh"
#include "wgmma_tile.cuh"

namespace tcscan {

using knn_wide::Desc;
using knn_wide::Ent;
using knn_wide::flush_row;
using knn_wide::PartList;
using knn_wide::refresh;
using knn_wide::SROW;               // keys a wide list's query stages
using knn_wide::wide_start;
using knn_wide::WideRow;

// -- the scratch and the split merge (also K7's SIMT route) ---------------

// The scratch of a launch: narrow partial lists [splits, q, k] (scores s,
// ids i), or a wide list's partial lists [splits, q, k], the queries'
// shared bounds [q] (null for one split) and staging rows [splits, q,
// SROW].
struct Part {
  float* s;
  int* i;
  Ent* lists;
  unsigned long long* bound;
  uint64_t* stage;
};

inline Part part_layout(void* part, int splits, int q, int k, bool wide) {
  Part p{};
  const size_t lists = (size_t)splits * q * k;
  if (!wide) {
    p.s = static_cast<float*>(part);
    p.i = reinterpret_cast<int*>(p.s + lists);
  } else {
    p.lists = static_cast<Ent*>(part);
    p.bound = reinterpret_cast<unsigned long long*>(p.lists + lists);
    p.stage = reinterpret_cast<uint64_t*>(p.bound + q);
    if (splits == 1) p.bound = nullptr;
  }
  return p;
}

// The second launch: the splits' partial lists merged into out_s / out_i
// [q, k].
inline int launch_merge(const Part& p, bool wide, int q, int k, int splits,
                        float* out_s, int* out_i, cudaStream_t st) {
  if (wide)
    return knn_wide::merge<Desc>(p.lists, 0, q, k, splits, nullptr, out_s,
                                 out_i, (size_t)k, 1, 1, st);
  const int words = tile::list_words(k);
  auto merge = words == 2   ? &tile::merge_splits<2>
               : words == 4 ? &tile::merge_splits<4>
                            : &tile::merge_splits<8>;
  const size_t smem = (size_t)tile::WARPS * k * (sizeof(float) + sizeof(int));
  merge<<<(q + tile::WARPS - 1) / tile::WARPS, tile::THREADS, smem, st>>>(
      p.s, p.i, q, k, splits, out_s, out_i);
  return (int)cudaGetLastError();
}

// A wide list's shared bounds start at all ones (no split has a kth yet).
inline int start_bounds(const Part& p, int q, cudaStream_t st) {
  if (p.bound == nullptr) return 0;
  return (int)cudaMemsetAsync(p.bound, 0xff, (size_t)q * sizeof(*p.bound),
                              st);
}

// -- the block ------------------------------------------------------------

constexpr int QB = 2 * wg::M;                     // queries a block
constexpr int NB = 128;                           // items a tile
constexpr int CONSUMERS = 2 * wg::THREADS;        // a warpgroup each 64
constexpr int THREADS = CONSUMERS + 32;           // and a producer warp
constexpr int WARPS = CONSUMERS / 32;
constexpr int A_STAGE_BYTES = QB * wg::ROW_BYTES;   // 16 KB
constexpr int B_STAGE_BYTES = NB * wg::ROW_BYTES;   // 16 KB
constexpr int BUF = 256;                          // survivors a warp stages
constexpr int MAX_STAGES = 6;
constexpr size_t SMEM_LIMIT = 232448;             // a block's most, sm_90

// Bytes of a ring slot: the corpus stage, after the queries' stage when
// the queries stream.
__host__ __device__ constexpr int slot_bytes(bool stream) {
  return stream ? A_STAGE_BYTES + B_STAGE_BYTES : B_STAGE_BYTES;
}

// Shared memory of a block: the resident queries (nk stages, none when
// streamed), the ring, the warps' buffers (narrow lists: BUF survivors
// each; wide lists: a sort scratch of SROW keys each), the narrow lists or
// the wide lists' rows, the barriers.
struct TcLayout {
  int stages;
  bool turns;      // the warpgroups take turns (the ring holds a tile)
  size_t warp_buf;   // bytes of a warp's buffer
  size_t ring, buf, lists, bars, total;
};

inline TcLayout tc_layout(int nk, int stages, bool wide, size_t list_bytes,
                          bool stream) {
  TcLayout l;
  l.stages = stages;
  l.turns = stages >= nk;
  l.warp_buf = wide ? SROW * sizeof(uint64_t)
                    : BUF * (sizeof(float) + sizeof(int));
  l.ring = stream ? 0 : (size_t)nk * A_STAGE_BYTES;
  l.buf = l.ring + (size_t)stages * slot_bytes(stream);
  l.lists = l.buf + (size_t)WARPS * l.warp_buf;
  l.bars = l.lists + list_bytes;
  l.total = l.bars + (1 + 2 * (size_t)stages) * sizeof(uint64_t);
  return l;
}

// The lists of a block in shared memory: 128 narrow lists of k, or 128
// wide lists' rows.
inline size_t list_bytes(bool wide, int k) {
  return wide ? (size_t)QB * sizeof(WideRow)
              : (size_t)QB * k * (sizeof(float) + sizeof(int));
}

struct TcPlan {
  bool wide;
  bool stream;    // the queries' stages ride the ring
  TcLayout lay;   // lay.total > SMEM_LIMIT: nothing fits
};

// The plan of a launch at nk stages of features with lists of k; the
// queries may be streamed only when may_stream.
inline TcPlan tc_plan(int nk, int k, bool may_stream) {
  const bool stream =
      may_stream &&
      tc_layout(nk, 2, true, list_bytes(true, k), false).total > SMEM_LIMIT;
  const bool wide =
      tile::list_words(k) == 0 ||
      tc_layout(nk, 2, false, list_bytes(false, k), stream).total >
          SMEM_LIMIT;
  const size_t lists = list_bytes(wide, k);
  int stages = MAX_STAGES;
  while (stages > 2 &&
         tc_layout(nk, stages, wide, lists, stream).total > SMEM_LIMIT)
    --stages;
  return TcPlan{wide, stream, tc_layout(nk, stages, wide, lists, stream)};
}

// The two warpgroups take turns on the tensor cores, tile by tile, so that
// one's epilogue runs under the other's products: warpgroup g waits on
// named barrier 1 + g, which the other warpgroup arrives at when its own
// products of the tile are issued (not yet done: the next warpgroup's
// products queue behind them, with no idle gap at the hand-off).  A warpgroup's turn consumes all nk
// stages of a tile before the other releases any of them, so the turns
// need a ring of at least nk stages (TcLayout::turns); a shallower ring
// runs the two in step.
__device__ __forceinline__ void turn_wait(int g) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + g), "n"(CONSUMERS)
               : "memory");
}
__device__ __forceinline__ void turn_pass(int g) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(2 - g), "n"(CONSUMERS)
               : "memory");
}

// Offer the warp's count buffered survivors (score, key) to their queries'
// narrow lists: key = item offset in the tile | (the query's row among the
// warp's 16) << 8.  All 32 lanes read the same entry.
template <int W>
__device__ __noinline__ void drain(const float* bv, const int* bk,
                                   int count, int c0, float* run_s,
                                   int* run_i, int k, int row0, int lane) {
  for (int e = 0; e < count; ++e) {
    const int key = bk[e];
    const size_t row = (size_t)(row0 + (key >> 8)) * k;
    tile::offer<tile::MaxLex, W>(run_s + row, run_i + row, k, bv[e],
                                 c0 + (key & 255), lane);
  }
  __syncwarp();
}

// A score the epilogue wrote in place of a sum, as a float.
__device__ __forceinline__ float as_score(float v) { return v; }
__device__ __forceinline__ float as_score(int v) { return __int_as_float(v); }

// Epi: the epilogue of a sum type Acc, with
//   Rows rows(qa, qb, ok_a, ok_b): a thread's state of its two queries;
//   bool load(Cols&, col0, rows): the item operands of its 32 items (items
//     col0 + 8 j + h, j < 16, h < 2), and whether they allow the fast blend;
//   template <bool FAST> unsigned long long score(acc, cols, rows, col0, n,
//     kth_a, kth_b, ok_a, ok_b): the scores in place, and the bits.
// Lists: [128][k] in shared memory (W > 0), or a wide list's (W == 0) in
// part, with its rows in shared memory.
template <class E, class Epi, int W, bool STREAM>
__global__ void __launch_bounds__(THREADS, 1)
    scan_kernel(const __grid_constant__ CUtensorMap map_x,
                const __grid_constant__ CUtensorMap map_q, const Epi epi,
                int n, int nk, TcLayout lay, int q, int k,
                int tiles_per_split, Part part) {
  using MMA = wg::Mma<E, NB>;
  static_assert(MMA::B_BYTES == B_STAGE_BYTES, "a 128-item stage");
  extern __shared__ __align__(1024) uint8_t tc_smem[];
  uint8_t* ring = tc_smem + lay.ring;
  uint64_t* a_full = reinterpret_cast<uint64_t*>(tc_smem + lay.bars);
  uint64_t* full = a_full + 1;
  uint64_t* empty = full + lay.stages;

  const int tid = threadIdx.x;
  const int grp = tid / wg::THREADS, wtid = tid % wg::THREADS;
  const int warp = wtid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * QB;
  const int split = blockIdx.y;
  const int n_tiles = (n + NB - 1) / NB;
  const int t_begin = split * tiles_per_split;
  const int t_end = min(n_tiles, t_begin + tiles_per_split);
  const int n_rows = min(QB, q - q0);
  const size_t row0_all = (size_t)split * q + q0;

  float* run_s = reinterpret_cast<float*>(tc_smem + lay.lists);
  int* run_i = reinterpret_cast<int*>(run_s + QB * k);
  WideRow* rows = reinterpret_cast<WideRow*>(tc_smem + lay.lists);
  Ent* lists = part.lists + row0_all * k;
  uint64_t* stage = part.stage + row0_all * SROW;
  unsigned long long* bound = part.bound ? part.bound + q0 : nullptr;
  if constexpr (W == 0) {
    wide_start(PartList{lists}, n_rows, k, rows, QB, tid, THREADS);
  } else {
    for (int e = tid; e < n_rows * k; e += THREADS) {
      run_s[e] = tile::NEG_SCORE;
      run_i[e] = -1;
    }
  }
  if (tid == 0) {
    wg::bar_init(a_full, 1);
    for (int i = 0; i < lay.stages; ++i) {
      wg::bar_init(&full[i], 1);
      wg::bar_init(&empty[i], 2);
    }
    wg::bar_init_fence();
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    // The producer: the block's queries once (resident), then load ld =
    // stage kb of tile t_begin + ld / nk into slot ld % stages (streamed:
    // the queries' stage kb beside it), once both warpgroups have released
    // the slot's previous use.
    if (tid == CONSUMERS) {
      if constexpr (!STREAM) {
        wg::bar_expect(a_full, nk * A_STAGE_BYTES);
        for (int kb = 0; kb < nk; ++kb)
          wg::tma_load(tc_smem + kb * A_STAGE_BYTES, &map_q, a_full,
                       kb * MMA::KSTAGE, q0);
      }
      const int total = (t_end - t_begin) * nk;
      for (int ld = 0; ld < total; ++ld) {
        const int slot = ld % lay.stages;
        if (ld >= lay.stages)
          wg::bar_wait(&empty[slot], ((ld / lay.stages) + 1) & 1);
        const int feat = (ld % nk) * MMA::KSTAGE;
        const int item = (t_begin + ld / nk) * NB;
        if constexpr (STREAM) {
          uint8_t* dst = ring + slot * slot_bytes(true);
          wg::bar_expect(&full[slot], A_STAGE_BYTES + B_STAGE_BYTES);
          wg::tma_load(dst, &map_q, &full[slot], feat, q0);
          wg::tma_load(dst + A_STAGE_BYTES, &map_x, &full[slot], feat, item);
        } else {
          wg::bar_expect(&full[slot], B_STAGE_BYTES);
          wg::tma_load(ring + slot * B_STAGE_BYTES, &map_x, &full[slot], feat,
                       item);
        }
      }
    }
    return;
  }

  // This thread's rows of the block: r_a and r_b = r_a + 8.
  const int row0 = grp * wg::M + 16 * warp;      // the warp's first row
  const int r_a = row0 + (lane >> 2), r_b = r_a + 8;
  const bool ok_a = r_a < n_rows, ok_b = r_b < n_rows;
  const typename Epi::Rows er = epi.rows(q0 + r_a, q0 + r_b, ok_a, ok_b);
  // The warp's buffer: BUF scores, then BUF keys (narrow lists), or a
  // sort scratch of SROW keys (wide lists).
  float* bv = reinterpret_cast<float*>(tc_smem + lay.buf +
                                       (tid >> 5) * lay.warp_buf);
  int* bk = reinterpret_cast<int*>(bv + BUF);
  uint64_t* scratch = reinterpret_cast<uint64_t*>(bv);
  const uint32_t a_addr = wg::smem_addr(tc_smem + grp * wg::A_BYTES);
  const unsigned lane_lt = (1u << lane) - 1u;

  if constexpr (!STREAM) wg::bar_wait(a_full, 0);
  if (lay.turns && grp == 1) turn_pass(1);   // warpgroup 0 goes first
  int cons = 0;
  for (int t = t_begin; t < t_end; ++t) {
    typename MMA::Acc acc[MMA::ACC];
    if (lay.turns) turn_wait(grp);
    for (int kb = 0; kb < nk; ++kb, ++cons) {
      const int slot = cons % lay.stages;
      wg::bar_wait(&full[slot], (cons / lay.stages) & 1);
      __syncwarp();
      if constexpr (STREAM) {
        const uint32_t s = wg::smem_addr(ring + slot * slot_bytes(true));
        wg::mma_stage<E, NB>(acc, s + grp * wg::A_BYTES, s + A_STAGE_BYTES,
                             kb == 0);
      } else {
        wg::mma_stage<E, NB>(acc, a_addr + kb * A_STAGE_BYTES,
                             wg::smem_addr(ring + slot * B_STAGE_BYTES),
                             kb == 0);
      }
      wg::wait<1>();
      if (kb > 0 && wtid == 0)
        wg::bar_arrive(&empty[(cons - 1) % lay.stages]);
    }
    // The turn passes once this warpgroup's last products are issued, so
    // that the other's queue behind them on the tensor cores.
    if (lay.turns && (grp == 0 || t + 1 < t_end)) turn_pass(grp);
    wg::wait<0>();
    if (wtid == 0) wg::bar_arrive(&empty[(cons - 1) % lay.stages]);

    // The epilogue, in place in the sums.
    const int c0 = t * NB;
    const int col0 = c0 + 2 * (lane & 3);          // item of cols j - 8 j
    typename Epi::Cols ec;
    const bool fast = epi.load(ec, col0, er);
    float kth_a, kth_b;
    if constexpr (W == 0) {
      if (bound && lane < 16 && row0 + lane < n_rows)
        refresh(rows[row0 + lane], __ldcg(bound + row0 + lane));
      __syncwarp();
      kth_a = ok_a ? rows[r_a].thr_v : 0.0f;
      kth_b = ok_b ? rows[r_b].thr_v : 0.0f;
    } else {
      kth_a = ok_a ? run_s[(size_t)r_a * k + k - 1] : 0.0f;
      kth_b = ok_b ? run_s[(size_t)r_b * k + k - 1] : 0.0f;
    }
    const unsigned long long bits =
        __all_sync(tile::FULL, fast)
            ? epi.template score<true>(acc, ec, er, col0, n, kth_a, kth_b,
                                       ok_a, ok_b)
            : epi.template score<false>(acc, ec, er, col0, n, kth_a, kth_b,
                                        ok_a, ok_b);
    if (!__any_sync(tile::FULL, bits != 0)) continue;
    if constexpr (W == 0) {
      // Each survivor that beats its query's filter goes, as a key, onto
      // the query's staging row, at a place taken by a shared-memory atomic
      // (a row's 128 items lie with 4 lanes); then the staging rows that
      // could not take another tile are merged, sorted in the warp's
      // buffer.
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const unsigned nib = (unsigned)(bits >> (4 * j)) & 15u;
        if (__ballot_sync(tile::FULL, nib != 0) == 0) continue;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e < 2 ? r_a : r_b;
          const float v = as_score(acc[4 * j + e]);
          const int id = col0 + 8 * j + (e & 1);
          if (((nib >> e) & 1u) &&
              Desc::better(v, id, rows[r].thr_v, rows[r].thr_i))
            stage[(size_t)r * SROW + atomicAdd(&rows[r].staged, 1)] =
                Desc::key(v, id);
        }
      }
      __syncwarp();
      const int mine = row0 + (lane & 15);
      unsigned due = __ballot_sync(
          tile::FULL, lane < 16 && mine < n_rows &&
                          rows[mine].staged > SROW - NB);
      while (due) {
        const int r = row0 + __ffs(due) - 1;
        due &= due - 1;
        flush_row(stage + (size_t)r * SROW, scratch,
                  PartList{lists + (size_t)r * k}, k, rows[r],
                  bound ? bound + r : nullptr, lane);
      }
    } else {
      // Survivors, compacted by ballot in groups of 4 sums (one column
      // pair of both rows), offered whenever the buffer may not take the
      // next group.
      int count = 0;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const unsigned nib = (unsigned)(bits >> (4 * j)) & 15u;
        if (__ballot_sync(tile::FULL, nib != 0) == 0) continue;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool p = (nib >> e) & 1u;
          const unsigned m = __ballot_sync(tile::FULL, p);
          if (p) {
            const int pos = count + __popc(m & lane_lt);
            bv[pos] = as_score(acc[4 * j + e]);
            bk[pos] = (8 * j + 2 * (lane & 3) + (e & 1)) |
                      (((lane >> 2) + 8 * (e >> 1)) << 8);
          }
          count += __popc(m);
        }
        if (count > BUF - 4 * 32) {
          __syncwarp();
          drain<W>(bv, bk, count, c0, run_s, run_i, k, row0, lane);
          count = 0;
        }
      }
      __syncwarp();
      drain<W>(bv, bk, count, c0, run_s, run_i, k, row0, lane);
    }
  }

  if constexpr (W == 0) {
    for (int r = row0; r < row0 + 16 && r < n_rows; ++r)
      if (rows[r].staged > 0)
        flush_row(stage + (size_t)r * SROW, scratch,
                  PartList{lists + (size_t)r * k}, k, rows[r],
                  bound ? bound + r : nullptr, lane);
  } else {
    // The warp's 16 lists to the partial lists.
    for (int r = row0; r < row0 + 16 && r < n_rows; ++r) {
      float* o_s = part.s + (row0_all + r) * k;
      int* o_i = part.i + (row0_all + r) * k;
      for (int e = lane; e < k; e += 32) {
        o_s[e] = run_s[(size_t)r * k + e];
        o_i[e] = run_i[(size_t)r * k + e];
      }
    }
  }
}

// The kernel of a plan: its lists' words a lane (0: wide) and STREAM.
template <class E, class Epi, bool STREAM>
inline auto kernel_of(int words) {
  return words == 2   ? &scan_kernel<E, Epi, 2, STREAM>
         : words == 4 ? &scan_kernel<E, Epi, 4, STREAM>
         : words == 8 ? &scan_kernel<E, Epi, 8, STREAM>
                      : &scan_kernel<E, Epi, 0, STREAM>;
}

// Both launches: queries qs [q, f] against the corpus x [n, f] (rows of a
// multiple of 16 bytes, 16-byte-aligned bases), part scratch as
// part_layout lays it out for the plan's lists.  MAY_STREAM: the route may
// stream the queries (K2 over bf16 rows; K7 keeps them resident).  Returns
// the CUDA error code; a plan that does not fit or a tensor map that fails
// to encode refuses the launch.
template <class E, bool MAY_STREAM, class Epi>
inline int launch(const E* x, const E* qs, const Epi& epi, int n, int f,
                  int q, int k, int splits, void* part, float* out_s,
                  int* out_i, cudaStream_t st) {
  if (!wg::route_ok<E>(x, qs, f)) return (int)cudaErrorInvalidValue;
  const int n_tiles = (n + NB - 1) / NB;
  const int tiles_per_split = (n_tiles + splits - 1) / splits;
  if ((splits - 1) * tiles_per_split >= n_tiles)  // every split non-empty
    return (int)cudaErrorInvalidValue;
  const int nk = (f + wg::Mma<E>::KSTAGE - 1) / wg::Mma<E>::KSTAGE;
  const TcPlan pl = tc_plan(nk, k, MAY_STREAM);
  const TcLayout& lay = pl.lay;
  if (lay.total > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  CUtensorMap map_x, map_q;
  if (!wg::make_map<E>(&map_x, x, n, f, NB) ||
      !wg::make_map<E>(&map_q, qs, q, f, QB))
    return (int)cudaErrorInvalidValue;
  const int words = pl.wide ? 0 : tile::list_words(k);
  auto scan = kernel_of<E, Epi, false>(words);
  if constexpr (MAY_STREAM) {
    if (pl.stream) scan = kernel_of<E, Epi, true>(words);
  }
  cudaError_t err = cudaFuncSetAttribute(
      scan, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)lay.total);
  if (err != cudaSuccess) return (int)err;
  const Part p = part_layout(part, splits, q, k, pl.wide);
  int e = start_bounds(p, q, st);
  if (e != 0) return e;
  const dim3 grid((q + QB - 1) / QB, splits);
  scan<<<grid, THREADS, lay.total, st>>>(map_x, map_q, epi, n, nk, lay, q, k,
                                         tiles_per_split, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_merge(p, pl.wide, q, k, splits, out_s, out_i, st);
}

}  // namespace tcscan
