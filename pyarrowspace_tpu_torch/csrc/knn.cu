// K1: fused exact eps/k-NN scan over unit rows.
//
// Replaces the TPU kernel pyarrowspace_tpu/ops/pallas/knn.py
// `_knn_block_kernel` (driven by `_knn_pallas_all`, entered through
// `knn_graph_candidates_pallas`), with its `sub` and `diag_start` options,
// and the projection-sorted walk of `_knn_pallas_all_reordered`.  For every
// row i of a row range it keeps the k smallest d(i, j) = 1 - max(0,
// x_i . x_j) over the columns j of [col_start, n), with self, columns >= n
// and d > eps masked to 2.0 before the merge; missing entries stay (2.0,
// -1).  Rows come out ascending by (distance, id).
//
// What bounds it on the H100: the products.  At 313,841 x 384 the scan is
// 313,841^2 x 384 x 2 = 75.6 TFLOP of fp32 multiply-adds, against 67
// TFLOP/s of fp32 outside the tensor cores; the merge touches each of the
// N^2 candidates once (a compare against the row's kth) and inserts only
// about k (1 + ln(N / k)) times per row.
//
// The simple design: one block of 256 threads per 64-row block; the block
// walks the 64-column tiles (nothing carries between blocks on a GPU, so
// the TPU's sequential grid axis becomes this loop).  Per tile: a
// shared-memory tiled fp32 product with feature slabs of 32 and 4 x 4
// accumulators a thread (tile_common.cuh), the mask epilogue into a shared
// 64 x 64 tile, then one warp per row offers the improving candidates to
// the row's running list.  The result is exact in fp32, and d(i, j) ==
// d(j, i) bitwise.  Lists of k <= 256 live in shared memory, as templates
// on words per lane (2, 4, 8; the launcher takes the narrowest that holds
// k); lists of k > 256 would take 64 x k x 8 bytes of shared memory (512 KB
// at k 1,024), so they are kept in place in the output rows and shifted
// there (tile_common.cuh offer_wide).  wgmma, TMA and pipelining are later
// work.
//
// Launch options, each keeping the one fmaf chain per pair (tile_product),
// so every distance stays bitwise the default scan's:
//   - col_start and seeded: the walk covers [col_start, n) only, its first
//     tile starting at col_start itself (no column before it is offered),
//     and each list starts from the sorted list already in its output row.
//     The incremental extend seeds old rows with their stored lists; the new
//     column ids exceed every stored id, so the Min rule stays exact.
//   - diag_start: block b walks the tiles from the one holding its own rows,
//     then wraps around (the TPU kernel's locality walk).  Ids then arrive
//     out of order, so the lists use MinLex.
//   - perm (reorder): xu is the corpus permuted by perm; the kernel offers
//     the original ids perm[c] and writes row r's list to output row
//     perm[r], with MinLex, so the result is the default scan's on any data,
//     ties included.
// The TPU kernel's `sub` (per-slice products and merges) has nothing to add
// here: every 64-column tile is already merged in one slice, each row's
// slice gated by a ballot against its kth entry.

#include <cuda_runtime.h>

#include <climits>

#include "tile_common.cuh"

namespace {

constexpr float INF_DIST = 2.0f;

template <class Order, int W>
__global__ void __launch_bounds__(tile::THREADS)
    knn_kernel(const float* __restrict__ xu, int n, int f, int row_start,
               int row_count, float eps, int k, int col_start, int diag_start,
               const int* __restrict__ perm, int seeded, float* out_d,
               int* out_i) {
  using namespace tile;
  extern __shared__ float smem[];
  auto As = reinterpret_cast<float(*)[PAD]>(smem);
  auto Bs = reinterpret_cast<float(*)[PAD]>(smem + SLAB * PAD);
  auto Ds = reinterpret_cast<float(*)[PAD]>(smem + 2 * SLAB * PAD);
  __shared__ int col_ids[TILE];   // the ids offered for the tile (perm only)

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int lane = tid & 31, warp = tid >> 5;
  const int r0 = row_start + blockIdx.x * TILE;
  const int r_end = row_start + row_count;
  const int n_rows = min(TILE, r_end - r0);

  // Output row of block row rr: r0 + rr - row_start, or perm[r0 + rr].
  auto out_row = [&](int rr) -> size_t {
    return perm ? (size_t)perm[r0 + rr] : (size_t)(r0 + rr - row_start);
  };

  // The block's lists [n_rows][k]: in shared memory, or in place in the
  // output rows for a wide list.
  float* run_d = smem + TILE_FLOATS;
  int* run_i = reinterpret_cast<int*>(run_d + TILE * k);
  for (int e = tid; e < n_rows * k; e += THREADS) {
    const int rr = e / k, s = e - rr * k;
    const size_t o = out_row(rr) * k + s;
    if (W != 0) {
      run_d[e] = seeded ? out_d[o] : INF_DIST;
      run_i[e] = seeded ? out_i[o] : -1;
    } else if (!seeded) {
      out_d[o] = INF_DIST;
      out_i[o] = -1;
    }
  }
  // The first barrier inside tile_product orders these writes before any
  // merge reads them.

  const int n_tiles = (n - col_start + TILE - 1) / TILE;
  int t0 = 0;
  if (diag_start && r0 >= col_start) t0 = ((r0 - col_start) / TILE) % n_tiles;
  for (int s = 0; s < n_tiles; ++s) {
    const int t = t0 + s < n_tiles ? t0 + s : t0 + s - n_tiles;
    const int c0 = col_start + t * TILE;
    if (perm && tid < TILE)
      col_ids[tid] = c0 + tid < n ? perm[c0 + tid] : INT_MAX;
    float acc[4][4];
    tile_product(xu, r0, r_end, xu, c0, n, f, As, Bs, acc);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = r0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = c0 + tx + 16 * j;
        float d = 1.0f - fmaxf(acc[i][j], 0.0f);
        if (col == row || col >= n || d > eps) d = INF_DIST;
        Ds[ty + 16 * i][tx + 16 * j] = d;
      }
    }
    __syncthreads();
    for (int rr = warp; rr < n_rows; rr += WARPS) {
      float* rd = W == 0 ? out_d + out_row(rr) * k : run_d + rr * k;
      int* ri = W == 0 ? out_i + out_row(rr) * k : run_i + rr * k;
      merge_row<Order, W>(Ds[rr], c0, rd, ri, k, lane,
                          perm ? col_ids : nullptr);
    }
    __syncthreads();
  }

  if (W != 0) {
    for (int e = tid; e < n_rows * k; e += THREADS) {
      const int rr = e / k, s = e - rr * k;
      out_d[out_row(rr) * k + s] = run_d[e];
      out_i[out_row(rr) * k + s] = run_i[e];
    }
  }
}

template <class Order>
auto pick(int words) {
  if (words == 2) return &knn_kernel<Order, 2>;
  if (words == 4) return &knn_kernel<Order, 4>;
  if (words == 8) return &knn_kernel<Order, 8>;
  return &knn_kernel<Order, 0>;
}

}  // namespace

extern "C" {

// Rows [row_start, row_start + row_count) of the unit corpus xu [n, f]
// against the columns [col_start, n) -> out_d / out_i, on the given device
// and stream.  Without perm, out is [row_count, k] in row order; with perm
// (xu permuted by it) out is [n, k] indexed by original row, and only the
// rows perm[row_start .. row_start + row_count) are written.  With seeded
// != 0, out already holds each row's sorted starting list.  Returns the
// CUDA error code of the launch (0 on success).
int knn_launch(const float* xu, int n, int f, int row_start, int row_count,
               float eps, int k, int col_start, int diag_start,
               const int* perm, int seeded, float* out_d, int* out_i,
               int device, void* stream) {
  const int words = tile::list_words(k);
  if (n <= 0 || f <= 0 || row_count <= 0 || words < 0 || row_start < 0 ||
      row_start + row_count > n || col_start < 0 || col_start >= n)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  // At k = 256 the lists take 128 KB: above the 48 KB a launch gets
  // without opting in.  Wide lists take no shared memory.
  const size_t smem =
      (size_t)tile::TILE_FLOATS * sizeof(float) +
      (words == 0 ? 0 : (size_t)tile::TILE * k * (sizeof(float) + sizeof(int)));
  // A rotated or permuted walk offers ids out of order: MinLex.
  auto kernel = (diag_start || perm) ? pick<tile::MinLex>(words)
                                     : pick<tile::Min>(words);
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (row_count + tile::TILE - 1) / tile::TILE;
  kernel<<<blocks, tile::THREADS, smem, (cudaStream_t)stream>>>(
      xu, n, f, row_start, row_count, eps, k, col_start, diag_start, perm,
      seeded, out_d, out_i);
  return (int)cudaGetLastError();
}

const char* knn_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
