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
// tc_scan.cuh's block, the scan it shares with K2 over bf16 rows, on
// wgmma m64n128k32 s32.s8.s8 over wgmma_tile.cuh's stages (a 128-feature
// int8 stage is one 128-byte row, as a 64-feature bf16 stage is), with
// I8Epi below as its epilogue: the scales and the blend on every element
// (the fast reciprocal when every lambda of the warp's elements is under
// 2^62 in magnitude, else tile::blend).  The block's queries stay resident
// (16 KB a 128 features, 48 KB at F 384), the corpus streams through a
// ring of 2 to 6 stages, and the two warpgroups take turns on the tensor
// cores when the ring holds a tile.  Narrow lists (k <= 256 when they fit
// beside two stages: up to 130 at F 384, 82 at F 768) live in shared
// memory, each survivor offered one by one (MaxLex); there the merge, not
// the products, is most of the time, each offer a warp-wide step whose
// latency nothing hides.  Wide lists take knn_wide.cuh's keys, sort and
// merge: survivors staged as descending keys, SROW (512) a query in device
// memory, sorted in a 4 KB warp scratch that replaces the survivor buffer
// (so the wide route keeps six ring stages at F 384 and at F 768, the
// warpgroups taking turns, with 1.4 KB to spare at F 768), merged into the
// query's partial list; the filter lags up to 384 survivors a query behind
// its list, and merges of 385 to 512 keys come about k (1 + ln(C / k)) /
// 384 times a query over a split of C items.  A 1,024-key scratch (8 KB a
// warp) would cost three of the six stages at F 768, and with them the
// turns; a 256-key one merges twice as often, and each merge's cost is
// mostly its fixed round trips to device memory.  On an H100 80GB HBM3 at
// 700 W (chip_smoke.py phases 7 and 10): pools 200 / 400 over 313,841 x
// 384, Q 4,096, 9.98 / 13.83 ms against pool 60's 6.94; pool 200 over
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
#include "tc_scan.cuh"
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

using tcscan::launch_merge;
using tcscan::Part;
using tcscan::part_layout;
using tcscan::start_bounds;

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

// -- the tensor-core route -------------------------------------------------

// K7's epilogue on tc_scan.cuh's block: the int32 sums of a thread's two
// query rows (rows r_a for sums i % 4 < 2, r_b otherwise) against its 32
// items, scaled and blended in place.  cols: [n_tiles * 64] float4, item
// pairs (srow_c, lam_c, srow_c+1, lam_c+1), zeros past n.
struct I8Epi {
  const float4* __restrict__ cols;
  const float* __restrict__ qscale;
  const float* __restrict__ lamq;
  float tau;

  struct Rows {
    float qs_a, qs_b, lq_a, lq_b, omt;
    bool lq_fast;
  };
  struct Cols {
    float4 cv[16];
  };

  __device__ __forceinline__ Rows rows(int qa, int qb, bool ok_a,
                                       bool ok_b) const {
    Rows r;
    r.qs_a = ok_a ? qscale[qa] : 0.0f;
    r.qs_b = ok_b ? qscale[qb] : 0.0f;
    r.lq_a = ok_a ? lamq[qa] : 0.0f;
    r.lq_b = ok_b ? lamq[qb] : 0.0f;
    r.lq_fast = fabsf(r.lq_a) < 0x1p62f && fabsf(r.lq_b) < 0x1p62f;
    r.omt = __fsub_rn(1.0f, tau);
    return r;
  }

  // Lambdas under 2^62 keep 1 + |lam_i - lam_q| below 2^64, the fast
  // reciprocal's range; otherwise the warp blends with tile::blend.
  __device__ __forceinline__ bool load(Cols& c, int col0,
                                       const Rows& r) const {
    bool lam_fast = r.lq_fast;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      c.cv[j] = __ldg(cols + (col0 >> 1) + 4 * j);
      lam_fast &= fabsf(c.cv[j].y) < 0x1p62f && fabsf(c.cv[j].w) < 0x1p62f;
    }
    return lam_fast;
  }

  // The blended scores, written back in place as float bits; bit i of the
  // result is set where the score reaches its row's kth (and the item is
  // < n, the row real).
  template <bool FAST>
  __device__ __forceinline__ unsigned long long score(
      int (&acc)[wg::Mma<int8_t>::ACC], const Cols& c, const Rows& r,
      int col0, int n, float kth_a, float kth_b, bool ok_a,
      bool ok_b) const {
    unsigned long long bits = 0;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float sr = h ? c.cv[j].z : c.cv[j].x;
        const float lc = h ? c.cv[j].w : c.cv[j].y;
        const bool in = col0 + 8 * j + h < n;
        const int ia = 4 * j + h, ib = 4 * j + 2 + h;
        const float ca =
            __fmul_rn(__fmul_rn(__int2float_rn(acc[ia]), r.qs_a), sr);
        const float cb =
            __fmul_rn(__fmul_rn(__int2float_rn(acc[ib]), r.qs_b), sr);
        const float sa = FAST ? tile::blend_fast(tau, r.omt, ca, lc, r.lq_a)
                              : tile::blend(tau, r.omt, ca, lc, r.lq_a);
        const float sb = FAST ? tile::blend_fast(tau, r.omt, cb, lc, r.lq_b)
                              : tile::blend(tau, r.omt, cb, lc, r.lq_b);
        acc[ia] = __float_as_int(sa);
        acc[ib] = __float_as_int(sb);
        bits |= (unsigned long long)(in && ok_a && sa >= kth_a) << ia;
        bits |= (unsigned long long)(in && ok_b && sb >= kth_b) << ib;
      }
    }
    return bits;
  }
};

constexpr int TC_MAX_F = 1024;   // queries resident: 128 KB

// Whether the tensor-core route keeps lists of k in place of narrow ones.
inline bool tc_wide(int nk, int k) {
  return tcscan::tc_plan(nk, k, false).wide;
}

int launch_tc(const int8_t* xq, const float4* cols, int n, int f,
              const int8_t* qq, const float* qscale, const float* lamq, int q,
              float tau, int k, int splits, void* part, float* out_s,
              int* out_i, cudaStream_t st) {
  if (f > TC_MAX_F || reinterpret_cast<uintptr_t>(cols) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  return tcscan::launch<int8_t, false>(xq, qq,
                                       I8Epi{cols, qscale, lamq, tau}, n, f,
                                       q, k, splits, part, out_s, out_i, st);
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
  return tc_wide((f + wg::Mma<int8_t>::KSTAGE - 1) / wg::Mma<int8_t>::KSTAGE,
                 k);
}

const char* scan_int8_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
