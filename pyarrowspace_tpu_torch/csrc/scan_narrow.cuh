// The SIMT scan with a running top-k of K2 (scan_topk.cu) and K8
// (scan_energy.cu), over the register-tiled fp32 product of ffma_tile.cuh,
// with the epilogue as a template argument: the two kernels differ only in
// how a cross term becomes a score.
//
// Launch 1: one block per (128-query block, corpus split); the splits are
// contiguous ranges of 128-item tiles, planned by the caller
// (ops/cuda/scan_topk.py::plan_splits).  A block runs the product over its
// split's tiles in ascending order, turns each tile's products into scores
// with the epilogue, and keeps running lists by the length of k:
//   - k <= 128 (narrow): lists in shared memory (2 or 4 words a lane),
//     merged 64 columns at a time (tile::merge_row), written to the partial
//     lists [S, Q, k]; launch 2 (tile::merge_splits) merges them in split
//     order, one warp a query, with the same insertion rule.
//   - k > 128 (wide): knn_wide.cuh's route with the same epilogue and the
//     descending key.
// A score enters a list only if it beats the empty slot (-3e38, -1); ties
// go to the smaller id.
//
// The epilogue Epi (the descending order, knn_wide::Desc) has, for the
// narrow kernel:
//   size_t row_bytes() const      (host) the shared memory it takes a
//                                 query row;
//   void rows(q0, q_end, smem)    once a block, before the tiles: the
//                                 block's query terms (smem: row_bytes()
//                                 x 128 bytes; a block barrier follows);
//   void cols(c0, n)              a tile's item terms;
//   float value(acc, i, j, row, col, n) const
//                                 the score of the thread's product (i, j);
// and, for knn_wide.cuh's scan, load(q0, q_end, c0, n): the query and item
// terms of one tile.

#pragma once

#include <cuda_runtime.h>

#include <type_traits>

#include "ffma_tile.cuh"
#include "knn_wide.cuh"
#include "tile_common.cuh"

namespace narrow {

// ops: the queries (A) and the corpus (B); Ring: the product's loader over
// the shared memory laid out by pl.
template <class Ring, int W, class Epi>
__global__ void __launch_bounds__(regtile::THREADS, 1)
    scan_kernel(const __grid_constant__ regtile::Operands<
                    typename Ring::Elem> ops,
                const regtile::Plan pl, const Epi epi, int n, int q, int k,
                int tiles_per_split, float* part_s, int* part_i) {
  using namespace regtile;
  extern __shared__ __align__(1024) char ffma_smem[];
  // The tile's scores [128][RES_LD], in the epilogue region.
  float* Ss = reinterpret_cast<float*>(ffma_smem + pl.epi);

  const int tid = threadIdx.x;
  const int tx = thread_x(), ty = thread_y();
  const int lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * TILE;
  const int split = blockIdx.y;
  const int c_begin = split * tiles_per_split * TILE;
  const int c_stop = min(n, c_begin + tiles_per_split * TILE);
  const int n_rows = min(TILE, q - q0);

  // The block's lists [n_rows][k] in shared memory, the rows with a
  // candidate to offer, then the epilogue's rows.
  float* run_s = reinterpret_cast<float*>(ffma_smem + pl.rest);
  int* run_i = reinterpret_cast<int*>(run_s + TILE * k);
  int* row_hit = run_i + TILE * k;
  for (int e = tid; e < n_rows * k; e += THREADS) {
    run_s[e] = tile::NEG_SCORE;
    run_i[e] = -1;
  }
  if (tid < TILE) row_hit[tid] = 0;
  Epi ep = epi;
  ep.rows(q0, q, reinterpret_cast<char*>(row_hit + TILE));
  Ring ring(ffma_smem, pl, ops, q0);
  ring.start();   // its barrier orders these writes before any read

  for (int c0 = c_begin; c0 < c_stop; c0 += TILE) {
    float acc[MICRO][MICRO];
    ring.product(c0, c0 + TILE < c_stop ? c0 + TILE : -1, acc);
    // The scores into Ss; a row whose thread holds a score above the row's
    // kth is flagged for the merge (the lists do not change before it).
    ep.cols(c0, n);
#pragma unroll
    for (int i = 0; i < MICRO; ++i) {
      const int rr = ty + 16 * i;
      const float kth =
          rr < n_rows ? run_s[(size_t)rr * k + k - 1] : 3.0e38f;
      bool hit = false;
#pragma unroll
      for (int j = 0; j < MICRO; ++j) {
        const float s = ep.value(acc[i][j], i, j, 0, c0 + tx + 16 * j, n);
        Ss[rr * RES_LD + tx + 16 * j] = s;
        hit |= s > kth;
      }
      if (hit) row_hit[rr] = 1;
    }
    __syncthreads();
    for (int rr = warp; rr < n_rows; rr += WARPS) {
      if (!row_hit[rr]) continue;
      const float* srow = Ss + rr * RES_LD;
      float* rs = run_s + (size_t)rr * k;
      int* ri = run_i + (size_t)rr * k;
      // Two halves of 64 columns, in ascending column order.  Their
      // ballots order every lane's read of the flag before it is cleared.
      tile::merge_row<tile::Max, W>(srow, c0, rs, ri, k, lane);
      tile::merge_row<tile::Max, W>(srow + 64, c0 + 64, rs, ri, k, lane);
      if (lane == 0) row_hit[rr] = 0;
    }
    __syncthreads();
  }

  float* o_s = part_s + ((size_t)split * q + q0) * k;
  int* o_i = part_i + ((size_t)split * q + q0) * k;
  for (int e = tid; e < n_rows * k; e += THREADS) {
    o_s[e] = run_s[e];
    o_i[e] = run_i[e];
  }
}

// The narrow kernel's shared memory: its lists, flags and the epilogue's
// rows (row_bytes a query) beside the ring and the scores tile.
inline regtile::Plan plan(int k, bool tma, size_t row_bytes) {
  return regtile::plan(regtile::RES_BYTES,
                       (size_t)regtile::TILE * k * 8 +
                           regtile::TILE * (sizeof(int) + row_bytes),
                       tma);
}

// Queries qs [q, f] against the corpus x [n, f] (T: float, or bf16
// converted exactly) with Epi's scores -> out_s / out_i [q, k].  part is
// scratch of 8-byte words: [splits, q, k] for a narrow list (k <= 128);
// for a wide one [splits, q, k + knn_wide::STAGE] and q more.
template <class T, class Epi>
int launch(const T* qs, const T* x, const Epi& epi, int n, int f, int q,
           int k, int splits, void* part, float* out_s, int* out_i, int tma,
           int device, cudaStream_t st) {
  if (regtile::list_words(k) == 0)
    return knn_wide::launch<T>(qs, x, epi, n, f, 0, q, k, 0, 0, nullptr,
                               splits, part, out_s, out_i, (size_t)k, 1, 1,
                               tma, device, st);
  const int n_tiles = (n + regtile::TILE - 1) / regtile::TILE;
  const int tiles_per_split = (n_tiles + splits - 1) / splits;
  if ((splits - 1) * tiles_per_split >= n_tiles)  // every split non-empty
    return (int)cudaErrorInvalidValue;
  // The ring and the lists take more than the 48 KB a launch gets without
  // opting in.
  const regtile::Plan pl = plan(k, tma != 0, epi.row_bytes());
  int smem_max = 0;
  cudaError_t err = cudaDeviceGetAttribute(
      &smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return (int)err;
  if (pl.stages == 0 || pl.bytes > smem_max) return (int)cudaErrorInvalidValue;
  regtile::Operands<T> ops;
  int e = regtile::make_operands<T>(&ops, qs, q, x, n, f, tma != 0);
  if (e != 0) return e;
  // The partial lists: [splits, q, k] scores, then as many ids.
  float* part_s = static_cast<float*>(part);
  int* part_i = reinterpret_cast<int*>(part_s + (size_t)splits * q * k);
  const dim3 grid((q + regtile::TILE - 1) / regtile::TILE, splits);
  e = regtile::with_ring<T>(pl, tma != 0, [&](auto* ring) {
    using Ring = std::remove_pointer_t<decltype(ring)>;
    auto scan = regtile::list_words(k) == 2 ? &scan_kernel<Ring, 2, Epi>
                                            : &scan_kernel<Ring, 4, Epi>;
    cudaError_t r = cudaFuncSetAttribute(
        scan, cudaFuncAttributeMaxDynamicSharedMemorySize, pl.bytes);
    if (r != cudaSuccess) return (int)r;
    scan<<<grid, regtile::THREADS, pl.bytes, st>>>(
        ops, pl, epi, n, q, k, tiles_per_split, part_s, part_i);
    return (int)cudaGetLastError();
  });
  if (e != 0) return e;
  // The merge keeps tile_common.cuh's narrow list layouts.
  const int words = tile::list_words(k);
  auto merge = words == 2 ? &tile::merge_splits<2> : &tile::merge_splits<4>;
  const size_t smem2 = tile::WARPS * (size_t)k * (sizeof(float) + sizeof(int));
  merge<<<(q + tile::WARPS - 1) / tile::WARPS, tile::THREADS, smem2, st>>>(
      part_s, part_i, q, k, splits, out_s, out_i);
  return (int)cudaGetLastError();
}

}  // namespace narrow
