// K7: the int8 candidate scan of search_batch(mode="int8").
//
// Replaces the TPU kernel pyarrowspace_tpu/ops/pallas/scan_topk.py:113
// `_scan_kernel_int8` (driven by `_scan_pallas_int8`, entered through
// `lambda_search_quantized`).  The corpus is int8 rows xq with one float
// scale a row (srow), the queries int8 rows qq with one scale a query
// (qscale), both from ops/quantize.py.  For every query q it keeps the k
// largest
//   acc   = qq_q . xq_i                                   (exact, int32)
//   cos   = (float(acc) * qscale_q) * srow_i
//   score = tau * cos + (1 - tau) / (1 + |lam_i - lamq_q|)
// over the corpus, ties to the smallest id, corpus ids >= n masked to
// -3e38; rows come out descending by score.
//
// The int32 sums are exact in any order, and the epilogue rounds op by op
// in the order above (__fmul_rn, then tile::blend or its branch-free twin
// tile::blend_fast: no fma contraction), so both routes equal the plain
// version (ops/cuda/scan_int8.py) bit for bit, ids and scores.
//
// What bounds it on the H100: the products.  At 313,841 x 384 and 4,096
// queries they are 4.9e11 int8 multiply-adds: 0.5 ms on the int8 tensor
// cores, against 0.04 ms for the corpus read (120 MB).  Beside them each
// of the 1.3e9 scores needs about 15 SIMT instructions of epilogue (one
// int-to-float conversion and one reciprocal among them, both on the
// quarter-rate pipe), comparable to the products' tensor time, and each
// query's running list takes about k ln(n / k) insertions a corpus split.
//
// Two routes, chosen by the wrapper from shapes and pointers alone
// (ops/cuda/scan_int8.py::tensor_core_route); a failed build or launch
// raises, and neither route falls back to the other.
//
// The tensor-core route (F % 16 == 0, F <= 1,024, 16-byte-aligned bases):
// the products run as wgmma m64n128k32 s32.s8.s8 on wgmma_tile.cuh's
// stages, the tile K3 and K5 use for bf16 (a 128-feature int8 stage is one
// 128-byte row, as a 64-feature bf16 stage is).  One block of two consumer
// warpgroups and a producer warp per (128-query block, corpus split): the
// block's queries are loaded once by TMA into shared memory (A: 16 KB a
// stage, 48 KB at F 384), and the corpus streams through a ring of 128-row
// stages (B), 2 to 6 deep, that the producer keeps full by TMA; both
// warpgroups read each stage, so a stage is released when both are done
// with it.  Warpgroup g multiplies its 64 queries against each 128-item
// tile, the two taking turns on the tensor cores when the ring holds a
// whole tile (two named barriers), so that one's epilogue runs under the
// other's products; its thread then holds the int32 sums of two query
// rows and 32 items, and the epilogue runs in place in those registers:
// the scales
// and the blend on every element (the fast reciprocal when every lambda
// of the warp's elements is under 2^62 in magnitude, else tile::blend),
// items >= n masked, and a score goes on only if it reaches its query's
// current kth (read once a tile).  A warp owns the lists of its 16
// queries, so the merge needs no block barrier.  Narrow lists (k <= 256
// when they fit beside the stages: up to 130 at F 384, 82 at F 768) live
// in shared memory: the survivors are compacted by ballot into the warp's
// buffer (256 entries, 2 KB) and offered to them one by one, MaxLex (the
// walk does not deliver a query's items in ascending order); there the
// merge, not the products, is most of the time, each offer a warp-wide
// step whose latency nothing hides.  Wide lists take knn_wide.cuh's keys,
// sort and merge: each survivor that beats its query's filter (the strict
// (score, id) compare against its partial list's kth, or the best kth
// another split has reached) goes, as a descending key, onto the query's
// staging row of SROW (512) keys in device memory, at a place taken by a
// shared-memory atomic (no compaction); a staging row that could not take
// another tile is sorted in the warp's buffer, here a scratch of SROW
// keys (4 KB), and merged into the query's partial list in device memory
// in one pass.  The trade: the sort scratch replaces the survivor buffer,
// so the wide route keeps six ring stages at F 384 and at F 768 (the
// warpgroups taking turns) and fits beside them at F 768 with 1.4 KB to
// spare; the price is a filter that lags up to 384 survivors a query
// behind its list, and merges of 385 to 512 keys, about k (1 + ln(C / k))
// / 384 of them a query over a split of C items.  A 1,024-key scratch
// (8 KB a warp) would cost three of the six stages at F 768, and with them
// the turns; a 256-key one merges twice as often, and each merge's cost
// is mostly its fixed round trips to device memory.  What is left beside
// the narrow route's time: the merges, and the staging of the extra
// survivors the lagging filter passes.  On an H100 80GB HBM3 at 700 W
// (chip_smoke.py phases 7 and 10): pools 200 / 400 over 313,841 x 384,
// Q 4,096, 9.98 / 13.83 ms against pool 60's 6.94; pool 200 over
// 1,000,000 x 768, Q 16,384, 69.16 ms against pool 60's 50.74.
//
// The SIMT route (ragged F, unaligned bases, F > 1,024): the first
// version's kernel, kept as the in-tree witness of the int32 sums.  One
// block of 256 threads per (64-query block, corpus split); per 64-item
// tile, a shared-memory tiled product of 4 x 4 int32 accumulators a thread
// as __dp4a over 32-bit words (F padded with zeros to a multiple of 4 by
// the caller), the epilogue into a shared 64 x 64 score tile, and one warp
// per query merges the improving scores: offered to a narrow running list
// (Max, items in ascending order), or, for a wide list (k > 256), staged,
// sorted and merged as on the tensor-core route, each warp with a sort
// scratch of SROW keys of its own.
//
// On both routes a second launch merges the splits' partial lists in split
// order: tile::merge_splits for narrow lists, knn_wide.cuh's split merge
// for wide ones.

#include <cstdint>

#include <cuda_runtime.h>

#include "knn_wide.cuh"
#include "tile_common.cuh"
#include "wgmma_tile.cuh"

namespace {

using knn_wide::Desc;
using knn_wide::Ent;
using knn_wide::flush_row;
using knn_wide::PartList;
using knn_wide::refresh;
using knn_wide::SROW;               // keys a wide list's query stages
using knn_wide::wide_start;
using knn_wide::WideRow;

constexpr int WSLAB = tile::SLAB;   // 32-bit words (4 features) per slab

// acc[i][j] = sum over words w of dp4a(A[a0 + ty + 16 i][w],
// B[b0 + tx + 16 j][w]) for rows of fw words; rows at or past a_end / b_end
// load as zeros.  Ends with every thread past its last shared read.
__device__ __forceinline__ void tile_product_i8(
    const int* __restrict__ a, int a0, int a_end,
    const int* __restrict__ b, int b0, int b_end, int fw,
    int (*As)[tile::PAD], int (*Bs)[tile::PAD], int acc[4][4]) {
  using namespace tile;
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;
  for (int w0 = 0; w0 < fw; w0 += WSLAB) {
    // 64 rows x 32 words per slab, 8 words a thread; neighbouring threads
    // read neighbouring words of one row.
#pragma unroll
    for (int e = 0; e < (TILE * WSLAB) / THREADS; ++e) {
      const int idx = e * THREADS + tid;
      const int r = idx >> 5, c = idx & 31;
      const int word = w0 + c;
      const int ra = a0 + r, rb = b0 + r;
      As[c][r] = (ra < a_end && word < fw) ? a[(size_t)ra * fw + word] : 0;
      Bs[c][r] = (rb < b_end && word < fw) ? b[(size_t)rb * fw + word] : 0;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < WSLAB; ++kk) {
      int av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
}

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

template <int W>
__global__ void __launch_bounds__(tile::THREADS)
    scan_int8_kernel(const int* __restrict__ xq,
                     const float* __restrict__ srow,
                     const float* __restrict__ lam, int n, int fw,
                     const int* __restrict__ qq,
                     const float* __restrict__ qscale,
                     const float* __restrict__ lamq, int q, float tau, int k,
                     int tiles_per_split, Part part) {
  using namespace tile;
  extern __shared__ float smem[];
  auto As = reinterpret_cast<int(*)[PAD]>(smem);
  auto Bs = reinterpret_cast<int(*)[PAD]>(smem + WSLAB * PAD);
  auto Ss = reinterpret_cast<float(*)[PAD]>(smem + 2 * WSLAB * PAD);

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * TILE;
  const int split = blockIdx.y;
  const int c_begin = split * tiles_per_split * TILE;
  const int c_stop = min(n, c_begin + tiles_per_split * TILE);
  const int n_rows = min(TILE, q - q0);
  const size_t row0 = (size_t)split * q + q0;

  // Narrow lists [n_rows][k] in shared memory; or a wide list's rows, each
  // warp's sort scratch and its rows' staging rows, lists and bounds.
  float* run_s = smem + TILE_FLOATS;
  int* run_i = reinterpret_cast<int*>(run_s + TILE * k);
  uint64_t* scratch =
      reinterpret_cast<uint64_t*>(smem + TILE_FLOATS) + warp * SROW;
  WideRow* rows = reinterpret_cast<WideRow*>(
      reinterpret_cast<uint64_t*>(smem + TILE_FLOATS) + WARPS * SROW);
  Ent* lists = part.lists + row0 * k;
  uint64_t* stage = part.stage + row0 * SROW;
  unsigned long long* bound = part.bound ? part.bound + q0 : nullptr;
  if constexpr (W == 0) {
    wide_start(PartList{lists}, n_rows, k, rows, TILE, tid, THREADS);
  } else {
    for (int e = tid; e < n_rows * k; e += THREADS) {
      run_s[e] = NEG_SCORE;
      run_i[e] = -1;
    }
  }
  float lq[4], qs[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    lq[i] = qi < q ? lamq[qi] : 0.0f;
    qs[i] = qi < q ? qscale[qi] : 0.0f;
  }
  const float one_minus_tau = 1.0f - tau;
  __syncthreads();

  for (int c0 = c_begin; c0 < c_stop; c0 += TILE) {
    int acc[4][4];
    tile_product_i8(qq, q0, q, xq, c0, n, fw, As, Bs, acc);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = c0 + tx + 16 * j;
      const float lc = col < n ? lam[col] : 0.0f;
      const float sc = col < n ? srow[col] : 0.0f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float cos =
            __fmul_rn(__fmul_rn(__int2float_rn(acc[i][j]), qs[i]), sc);
        float s = blend(tau, one_minus_tau, cos, lc, lq[i]);
        if (col >= n) s = NEG_SCORE;
        Ss[ty + 16 * i][tx + 16 * j] = s;
      }
    }
    __syncthreads();
    for (int rr = warp; rr < n_rows; rr += WARPS) {
      if constexpr (W != 0) {
        merge_row<Max, W>(Ss[rr], c0, run_s + (size_t)rr * k,
                          run_i + (size_t)rr * k, k, lane);
      } else {
        // The row's survivors, as keys, onto its staging row; a staging row
        // that could not take another tile is merged.
        WideRow& w = rows[rr];
        if (bound && lane == 0) refresh(w, __ldcg(bound + rr));
        __syncwarp();
        const float tv = w.thr_v;
        const int ti = w.thr_i, base = w.staged;
        const float v0 = Ss[rr][lane], v1 = Ss[rr][lane + 32];
        const bool p0 = MaxLex::better(v0, c0 + lane, tv, ti);
        const bool p1 = MaxLex::better(v1, c0 + lane + 32, tv, ti);
        const unsigned m0 = __ballot_sync(FULL, p0);
        const unsigned m1 = __ballot_sync(FULL, p1);
        if ((m0 | m1) == 0) continue;
        const unsigned below = (1u << lane) - 1u;
        uint64_t* dst = stage + (size_t)rr * SROW + base;
        if (p0) dst[__popc(m0 & below)] = Desc::key(v0, c0 + lane);
        if (p1)
          dst[__popc(m0) + __popc(m1 & below)] = Desc::key(v1, c0 + lane + 32);
        __syncwarp();
        if (lane == 0) w.staged = base + __popc(m0) + __popc(m1);
        __syncwarp();
        if (w.staged > SROW - TILE)
          flush_row(stage + (size_t)rr * SROW, scratch,
                    PartList{lists + (size_t)rr * k}, k, w,
                    bound ? bound + rr : nullptr, lane);
      }
    }
    __syncthreads();
  }

  if constexpr (W == 0) {
    for (int rr = warp; rr < n_rows; rr += WARPS)
      if (rows[rr].staged > 0)
        flush_row(stage + (size_t)rr * SROW, scratch,
                  PartList{lists + (size_t)rr * k}, k, rows[rr],
                  bound ? bound + rr : nullptr, lane);
  } else {
    float* o_s = part.s + row0 * k;
    int* o_i = part.i + row0 * k;
    for (int e = tid; e < n_rows * k; e += THREADS) {
      o_s[e] = run_s[e];
      o_i[e] = run_i[e];
    }
  }
}

// The second launch of both routes: the splits' partial lists merged into
// out_s / out_i [q, k].
int launch_merge(const Part& p, bool wide, int q, int k, int splits,
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
int start_bounds(const Part& p, int q, cudaStream_t st) {
  if (p.bound == nullptr) return 0;
  return (int)cudaMemsetAsync(p.bound, 0xff, (size_t)q * sizeof(*p.bound),
                              st);
}

// -- the tensor-core route -------------------------------------------------

using I8 = wg::Mma<int8_t>;
constexpr int TC_QB = 2 * wg::M;                  // queries a block
constexpr int TC_NB = I8::N;                      // items a tile
constexpr int TC_CONSUMERS = 2 * wg::THREADS;     // a warpgroup each 64
constexpr int TC_THREADS = TC_CONSUMERS + 32;     // and a producer warp
constexpr int TC_WARPS = TC_CONSUMERS / 32;
constexpr int A_STAGE_BYTES = TC_QB * wg::ROW_BYTES;   // 16 KB
constexpr int TC_MAX_F = 1024;                    // queries resident: 128 KB
constexpr int BUF = 256;                          // survivors a warp stages
constexpr int MAX_STAGES = 6;
constexpr size_t SMEM_LIMIT = 232448;             // a block's most, sm_90

// Shared memory of a block: the queries (nk stages), the ring, the warps'
// buffers (narrow lists: BUF survivors each; wide lists: a sort scratch of
// SROW keys each), the narrow lists or the wide lists' rows, the barriers.
struct TcLayout {
  int stages;
  bool turns;      // the warpgroups take turns (the ring holds a tile)
  size_t warp_buf;   // bytes of a warp's buffer
  size_t ring, buf, lists, bars, total;
};

inline TcLayout tc_layout(int nk, int stages, bool wide, size_t list_bytes) {
  TcLayout l;
  l.stages = stages;
  l.turns = stages >= nk;
  l.warp_buf = wide ? SROW * sizeof(uint64_t)
                    : BUF * (sizeof(float) + sizeof(int));
  l.ring = (size_t)nk * A_STAGE_BYTES;
  l.buf = l.ring + (size_t)stages * I8::B_BYTES;
  l.lists = l.buf + (size_t)TC_WARPS * l.warp_buf;
  l.bars = l.lists + list_bytes;
  l.total = l.bars + (1 + 2 * (size_t)stages) * sizeof(uint64_t);
  return l;
}

// The two warpgroups take turns on the tensor cores, tile by tile, so that
// one's epilogue runs under the other's products: warpgroup g waits on
// named barrier 1 + g, which the other warpgroup arrives at when its own
// products of the tile are done.  A warpgroup's turn consumes all nk
// stages of a tile before the other releases any of them, so the turns
// need a ring of at least nk stages (TcLayout::turns); a shallower ring
// (F 768 beside narrow lists) runs the two in step.
__device__ __forceinline__ void turn_wait(int g) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + g), "n"(TC_CONSUMERS)
               : "memory");
}
__device__ __forceinline__ void turn_pass(int g) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(2 - g), "n"(TC_CONSUMERS)
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

// The blended scores of a thread's two rows (sums acc[i], rows r_a for
// i % 4 < 2, r_b otherwise) against the tile's 32 items of the thread,
// written back in place as float bits; bit i of the result is set where
// the score reaches its row's kth (and the item is < n, the row real).
template <bool FAST>
__device__ __forceinline__ unsigned long long score_tile(
    int (&acc)[I8::ACC], const float4 (&cv)[16], int col0, int n,
    float tau, float omt, float qs_a, float qs_b, float lq_a, float lq_b,
    float kth_a, float kth_b, bool ok_a, bool ok_b) {
  unsigned long long bits = 0;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float sr = h ? cv[j].z : cv[j].x;
      const float lc = h ? cv[j].w : cv[j].y;
      const bool in = col0 + 8 * j + h < n;
      const int ia = 4 * j + h, ib = 4 * j + 2 + h;
      const float ca =
          __fmul_rn(__fmul_rn(__int2float_rn(acc[ia]), qs_a), sr);
      const float cb =
          __fmul_rn(__fmul_rn(__int2float_rn(acc[ib]), qs_b), sr);
      const float sa = FAST ? tile::blend_fast(tau, omt, ca, lc, lq_a)
                            : tile::blend(tau, omt, ca, lc, lq_a);
      const float sb = FAST ? tile::blend_fast(tau, omt, cb, lc, lq_b)
                            : tile::blend(tau, omt, cb, lc, lq_b);
      acc[ia] = __float_as_int(sa);
      acc[ib] = __float_as_int(sb);
      bits |= (unsigned long long)(in && ok_a && sa >= kth_a) << ia;
      bits |= (unsigned long long)(in && ok_b && sb >= kth_b) << ib;
    }
  }
  return bits;
}

// cols: [n_tiles * 64] float4, item pairs (srow_c, lam_c, srow_c+1,
// lam_c+1), zeros past n.  Lists: [128][k] in shared memory (W > 0), or a
// wide list's (W == 0) in part, with its rows in shared memory.
template <int W>
__global__ void __launch_bounds__(TC_THREADS, 1)
    scan_int8_tc_kernel(const __grid_constant__ CUtensorMap map_x,
                        const __grid_constant__ CUtensorMap map_q,
                        const float4* __restrict__ cols, int n, int nk,
                        TcLayout lay, const float* __restrict__ qscale,
                        const float* __restrict__ lamq, int q, float tau,
                        int k, int tiles_per_split, Part part) {
  extern __shared__ __align__(1024) uint8_t tc_smem[];
  uint8_t* ring = tc_smem + lay.ring;
  uint64_t* a_full = reinterpret_cast<uint64_t*>(tc_smem + lay.bars);
  uint64_t* full = a_full + 1;
  uint64_t* empty = full + lay.stages;

  const int tid = threadIdx.x;
  const int grp = tid / wg::THREADS, wtid = tid % wg::THREADS;
  const int warp = wtid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * TC_QB;
  const int split = blockIdx.y;
  const int n_tiles = (n + TC_NB - 1) / TC_NB;
  const int t_begin = split * tiles_per_split;
  const int t_end = min(n_tiles, t_begin + tiles_per_split);
  const int n_rows = min(TC_QB, q - q0);
  const size_t row0_all = (size_t)split * q + q0;

  float* run_s = reinterpret_cast<float*>(tc_smem + lay.lists);
  int* run_i = reinterpret_cast<int*>(run_s + TC_QB * k);
  WideRow* rows = reinterpret_cast<WideRow*>(tc_smem + lay.lists);
  Ent* lists = part.lists + row0_all * k;
  uint64_t* stage = part.stage + row0_all * SROW;
  unsigned long long* bound = part.bound ? part.bound + q0 : nullptr;
  if constexpr (W == 0) {
    wide_start(PartList{lists}, n_rows, k, rows, TC_QB, tid,
               TC_THREADS);
  } else {
    for (int e = tid; e < n_rows * k; e += TC_THREADS) {
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

  if (tid >= TC_CONSUMERS) {
    // The producer: the block's queries once, then load ld = stage kb of
    // tile t_begin + ld / nk into slot ld % stages, once both warpgroups
    // have released the slot's previous use.
    if (tid == TC_CONSUMERS) {
      wg::bar_expect(a_full, nk * A_STAGE_BYTES);
      for (int kb = 0; kb < nk; ++kb)
        wg::tma_load(tc_smem + kb * A_STAGE_BYTES, &map_q, a_full,
                     kb * I8::KSTAGE, q0);
      const int total = (t_end - t_begin) * nk;
      for (int ld = 0; ld < total; ++ld) {
        const int slot = ld % lay.stages;
        if (ld >= lay.stages)
          wg::bar_wait(&empty[slot], ((ld / lay.stages) + 1) & 1);
        wg::bar_expect(&full[slot], I8::B_BYTES);
        wg::tma_load(ring + slot * I8::B_BYTES, &map_x, &full[slot],
                     (ld % nk) * I8::KSTAGE, (t_begin + ld / nk) * TC_NB);
      }
    }
    return;
  }

  // This thread's rows of the block: r_a and r_b = r_a + 8.
  const int row0 = grp * wg::M + 16 * warp;      // the warp's first row
  const int r_a = row0 + (lane >> 2), r_b = r_a + 8;
  const bool ok_a = r_a < n_rows, ok_b = r_b < n_rows;
  const float qs_a = ok_a ? qscale[q0 + r_a] : 0.0f;
  const float qs_b = ok_b ? qscale[q0 + r_b] : 0.0f;
  const float lq_a = ok_a ? lamq[q0 + r_a] : 0.0f;
  const float lq_b = ok_b ? lamq[q0 + r_b] : 0.0f;
  const bool lq_fast = fabsf(lq_a) < 0x1p62f && fabsf(lq_b) < 0x1p62f;
  const float omt = __fsub_rn(1.0f, tau);
  // The warp's buffer: BUF scores, then BUF keys (narrow lists), or a
  // sort scratch of SROW keys (wide lists).
  float* bv = reinterpret_cast<float*>(tc_smem + lay.buf +
                                       (tid >> 5) * lay.warp_buf);
  int* bk = reinterpret_cast<int*>(bv + BUF);
  uint64_t* scratch = reinterpret_cast<uint64_t*>(bv);
  const uint32_t a_addr = wg::smem_addr(tc_smem + grp * wg::A_BYTES);
  const unsigned lane_lt = (1u << lane) - 1u;

  wg::bar_wait(a_full, 0);
  if (lay.turns && grp == 1) turn_pass(1);   // warpgroup 0 goes first
  int cons = 0;
  for (int t = t_begin; t < t_end; ++t) {
    int acc[I8::ACC];
    if (lay.turns) turn_wait(grp);
    for (int kb = 0; kb < nk; ++kb, ++cons) {
      const int slot = cons % lay.stages;
      wg::bar_wait(&full[slot], (cons / lay.stages) & 1);
      __syncwarp();
      wg::mma_stage<int8_t>(acc, a_addr + kb * A_STAGE_BYTES,
                            wg::smem_addr(ring + slot * I8::B_BYTES),
                            kb == 0);
      wg::wait<1>();
      if (kb > 0 && wtid == 0)
        wg::bar_arrive(&empty[(cons - 1) % lay.stages]);
    }
    wg::wait<0>();
    if (wtid == 0) wg::bar_arrive(&empty[(cons - 1) % lay.stages]);
    if (lay.turns && (grp == 0 || t + 1 < t_end)) turn_pass(grp);

    // The epilogue, in place in the sums.
    const int c0 = t * TC_NB;
    const int col0 = c0 + 2 * (lane & 3);          // item of cv[j].x - 8 j
    float4 cv[16];
    bool lam_fast = lq_fast;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      cv[j] = __ldg(cols + (col0 >> 1) + 4 * j);
      lam_fast &= fabsf(cv[j].y) < 0x1p62f && fabsf(cv[j].w) < 0x1p62f;
    }
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
    // Lambdas under 2^62 keep 1 + |lam_i - lam_q| below 2^64, the fast
    // reciprocal's range; otherwise the warp blends with tile::blend.
    const unsigned long long bits =
        __all_sync(tile::FULL, lam_fast)
            ? score_tile<true>(acc, cv, col0, n, tau, omt, qs_a, qs_b, lq_a,
                               lq_b, kth_a, kth_b, ok_a, ok_b)
            : score_tile<false>(acc, cv, col0, n, tau, omt, qs_a, qs_b,
                                lq_a, lq_b, kth_a, kth_b, ok_a, ok_b);
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
          const float v = __int_as_float(acc[4 * j + e]);
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
                          rows[mine].staged > SROW - TC_NB);
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
            bv[pos] = __int_as_float(acc[4 * j + e]);
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

// Whether the tensor-core route keeps lists of k in place of narrow ones:
// past 256, or when 128 narrow lists do not fit beside two ring stages.
inline bool tc_wide(int nk, int k) {
  return tile::list_words(k) == 0 ||
         tc_layout(nk, 2, false,
                   (size_t)TC_QB * k * (sizeof(float) + sizeof(int)))
                 .total > SMEM_LIMIT;
}

int launch_tc(const int8_t* xq, const float4* cols, int n, int f,
              const int8_t* qq, const float* qscale, const float* lamq, int q,
              float tau, int k, int splits, void* part, float* out_s,
              int* out_i, cudaStream_t st) {
  if (!wg::route_ok<int8_t>(xq, qq, f) || f > TC_MAX_F ||
      reinterpret_cast<uintptr_t>(cols) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int n_tiles = (n + TC_NB - 1) / TC_NB;
  const int tiles_per_split = (n_tiles + splits - 1) / splits;
  if ((splits - 1) * tiles_per_split >= n_tiles)  // every split non-empty
    return (int)cudaErrorInvalidValue;
  const int nk = (f + I8::KSTAGE - 1) / I8::KSTAGE;
  // Narrow lists in shared memory when they fit beside two stages, with
  // as deep a ring as fits; else wide lists, their rows in shared memory.
  const bool wide = tc_wide(nk, k);
  const size_t lists =
      wide ? (size_t)TC_QB * sizeof(WideRow)
           : (size_t)TC_QB * k * (sizeof(float) + sizeof(int));
  int stages = MAX_STAGES;
  while (stages > 2 && tc_layout(nk, stages, wide, lists).total > SMEM_LIMIT)
    --stages;
  const TcLayout lay = tc_layout(nk, stages, wide, lists);
  if (lay.total > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  CUtensorMap map_x, map_q;
  if (!wg::make_map<int8_t>(&map_x, xq, n, f, TC_NB) ||
      !wg::make_map<int8_t>(&map_q, qq, q, f, TC_QB))
    return (int)cudaErrorInvalidValue;
  const int words = wide ? 0 : tile::list_words(k);
  auto scan = words == 2   ? &scan_int8_tc_kernel<2>
              : words == 4 ? &scan_int8_tc_kernel<4>
              : words == 8 ? &scan_int8_tc_kernel<8>
                           : &scan_int8_tc_kernel<0>;
  cudaError_t err = cudaFuncSetAttribute(
      scan, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)lay.total);
  if (err != cudaSuccess) return (int)err;
  const Part p = part_layout(part, splits, q, k, wide);
  int e = start_bounds(p, q, st);
  if (e != 0) return e;
  const dim3 grid((q + TC_QB - 1) / TC_QB, splits);
  scan<<<grid, TC_THREADS, lay.total, st>>>(map_x, map_q, cols, n, nk, lay,
                                            qscale, lamq, q, tau, k,
                                            tiles_per_split, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_merge(p, wide, q, k, splits, out_s, out_i, st);
}

}  // namespace

extern "C" {

// Queries qq [q, fw] (int8 rows packed as fw 32-bit words) with scales
// qscale [q] and lambdas lamq [q] against the corpus xq [n, fw] (packed
// likewise) with row scales srow [n] and lambdas lam [n] -> out_s / out_i
// [q, k].  part is scratch of 8-byte words: [splits, q, k] for a narrow
// list (k <= 256); for a wide one [splits, q, k + SROW] and q more.  Runs on
// the given device and stream; returns the CUDA error code (0 on success).
int scan_int8_launch(const int* xq, const float* srow, const float* lam,
                     int n, int fw, const int* qq, const float* qscale,
                     const float* lamq, int q, float tau, int k, int splits,
                     void* part, float* out_s, int* out_i, int device,
                     void* stream) {
  const int words = tile::list_words(k);
  if (n <= 0 || fw <= 0 || q <= 0 || words < 0 || k > n || splits <= 0)
    return (int)cudaErrorInvalidValue;
  const int n_tiles = (n + tile::TILE - 1) / tile::TILE;
  const int tiles_per_split = (n_tiles + splits - 1) / splits;
  if ((splits - 1) * tiles_per_split >= n_tiles)  // every split non-empty
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const bool wide = words == 0;
  // Narrow: the lists; wide: each warp's sort scratch and the rows.
  const size_t extra =
      wide ? tile::WARPS * SROW * sizeof(uint64_t) +
                 tile::TILE * sizeof(WideRow)
           : tile::TILE * (size_t)k * (sizeof(float) + sizeof(int));
  const size_t smem = (size_t)tile::TILE_FLOATS * sizeof(float) + extra;
  auto scan = words == 2   ? &scan_int8_kernel<2>
              : words == 4 ? &scan_int8_kernel<4>
              : words == 8 ? &scan_int8_kernel<8>
                           : &scan_int8_kernel<0>;
  err = cudaFuncSetAttribute(
      scan, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  const Part p = part_layout(part, splits, q, k, wide);
  int e = start_bounds(p, q, st);
  if (e != 0) return e;
  const dim3 grid((q + tile::TILE - 1) / tile::TILE, splits);
  scan<<<grid, tile::THREADS, smem, st>>>(xq, srow, lam, n, fw, qq, qscale,
                                          lamq, q, tau, k, tiles_per_split,
                                          p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_merge(p, wide, q, k, splits, out_s, out_i, st);
}

// The tensor-core route: int8 rows xq [n, f] and qq [q, f] (f % 16 == 0,
// f <= 1,024, 16-byte-aligned bases), the item pairs cols [ceil(n / 128)
// * 64] float4 (srow, lam of an even item, then of the next; zeros past
// n), qscale and lamq [q] -> out_s / out_i [q, k]; part is scratch as
// scan_int8_launch's, the list wide when scan_int8_tc_wide says so.  Runs
// on the given device and stream; returns the CUDA error code (0 on
// success).
int scan_int8_tc_launch(const void* xq, const void* cols, int n, int f,
                        const void* qq, const float* qscale,
                        const float* lamq, int q, float tau, int k,
                        int splits, void* part, float* out_s, int* out_i,
                        int device, void* stream) {
  if (n <= 0 || f <= 0 || q <= 0 || tile::list_words(k) < 0 || k > n ||
      splits <= 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return launch_tc(static_cast<const int8_t*>(xq),
                   static_cast<const float4*>(cols), n, f,
                   static_cast<const int8_t*>(qq), qscale, lamq, q, tau, k,
                   splits, part, out_s, out_i, (cudaStream_t)stream);
}

// Whether the tensor-core route at f features keeps lists of k wide.
int scan_int8_tc_wide(int f, int k) {
  return tc_wide((f + I8::KSTAGE - 1) / I8::KSTAGE, k);
}

const char* scan_int8_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
