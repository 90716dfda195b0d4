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
// What bounds it on the H100: the products.  At 313,841 x 384 the scan
// computes 313,841^2 x 384 x 2 = 75.6 TFLOP of fp32 multiply-adds, against
// 67 TFLOP/s of fp32 outside the tensor cores (1.129 s); since d(i, j) ==
// d(j, i) bit for bit, the function needs only half of them (0.564 s: a
// walk over one triangle is not built yet).  The merge touches
// each of the N^2 candidates once (a compare against the row's kth) and
// inserts only about k (1 + ln(N / k)) times per row.
//
// The design: one block of 256 threads per 128-row block; the block walks
// the 128-column tiles (nothing carries between blocks on a GPU, so the
// TPU's sequential grid axis becomes this loop).  Per tile: the
// register-tiled fp32 product of ffma_tile.cuh (8 x 8 outputs a thread,
// a two-stage ring of 32-feature slabs fed by register prefetch), the mask
// epilogue into a shared 128 x 128 tile, then one warp per row offers the
// improving candidates to the row's running list, 64 columns at a time in
// ascending column order.  The result is exact in fp32, and d(i, j) ==
// d(j, i) bitwise.  Lists of k <= 128 live in shared memory (2 or 4 words
// a lane); longer lists would take 128 x k x 8 bytes (256 KB at k 256, past
// the 227 KB a block may have with the ring), so they take the wide route
// of knn_wide.cuh: the column walk split across blocks when the row blocks
// leave SMs idle, each tile's survivors buffered, sorted and merged into
// partial lists in device memory, and a second launch merging the splits.
//
// Launch options, each keeping the one fmaf chain per pair, so every
// distance stays bitwise the default scan's:
//   - col_start and seeded: the walk covers [col_start, n) only, its first
//     tile starting at col_start itself (no column before it is offered),
//     and each list starts from the sorted list already in its output row.
//     A seeded list merges with MinLex: the incremental extend's seeds hold
//     ids below col_start (MinLex then keeps what Min would), a ring step
//     of the sharded build (parallel/sharded.py) seeds lists of any ids.
//   - diag_start: block b walks the 128-column tiles from the one holding
//     its own rows, then wraps around (the TPU kernel's locality walk).  Ids
//     then arrive out of order, so the lists use MinLex.
//   - perm (reorder): xu is the corpus permuted by perm; the kernel offers
//     the original ids perm[c] and writes row r's list to output row
//     perm[r], with MinLex, so the result is the default scan's on any data,
//     ties included.
// The TPU kernel's `sub` (per-slice products and merges) has nothing to add
// here: every 64-column half of a tile is merged on its own, each row's
// half gated by a ballot against its kth entry.

#include <cuda_runtime.h>

#include <climits>

#include "ffma_tile.cuh"
#include "knn_wide.cuh"
#include "tile_common.cuh"

namespace {

constexpr float INF_DIST = 2.0f;

template <class Order, int W>
__global__ void __launch_bounds__(regtile::THREADS, 1)
    knn_kernel(const float* __restrict__ xu, int n, int f, int vec,
               int row_start, int row_count, float eps, int k, int col_start,
               int diag_start, const int* __restrict__ perm, int seeded,
               int tiles_per_split, knn_wide::Ent* part, float* out_d,
               int* out_i) {
  using namespace regtile;
  extern __shared__ __align__(16) float ffma_smem[];
  float* ring = ffma_smem;
  float* Ds = ffma_smem;   // the tile's distances [128][RES_LD], in the ring
  __shared__ int col_ids[TILE];          // the ids offered for the tile (perm)
  __shared__ int row_hit[TILE];          // rows with a candidate to offer

  const int tid = threadIdx.x;
  const int tx = thread_x(), ty = thread_y();
  const int lane = tid & 31, warp = tid >> 5;
  const int r0 = row_start + blockIdx.x * TILE;
  const int r_end = row_start + row_count;
  const int n_rows = min(TILE, r_end - r0);

  // Output row of block row rr: r0 + rr - row_start, or perm[r0 + rr].
  auto out_row = [&](int rr) -> size_t {
    return perm ? (size_t)perm[r0 + rr] : (size_t)(r0 + rr - row_start);
  };

  // The block's lists [n_rows][k] in shared memory.
  float* run_d = ffma_smem + RING_FLOATS;
  int* run_i = reinterpret_cast<int*>(run_d + TILE * k);
  // A split (part != null) starts from empty lists: the merge of the
  // splits starts from the seed.
  const bool from_out = seeded && !part;
  for (int e = tid; e < n_rows * k; e += THREADS) {
    const int rr = e / k, s = e - rr * k;
    const size_t o = out_row(rr) * k + s;
    run_d[e] = from_out ? out_d[o] : INF_DIST;
    run_i[e] = from_out ? out_i[o] : -1;
  }
  if (tid < TILE) row_hit[tid] = 0;
  // The first barrier inside regtile::product orders these writes before any
  // merge reads them.
  auto list_d = [&](int rr) { return run_d + rr * k; };
  auto list_i = [&](int rr) { return run_i + rr * k; };

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
    if (perm && tid < TILE)
      col_ids[tid] = c0 + tid < n ? perm[c0 + tid] : INT_MAX;
    float acc[MICRO][MICRO];
    product(xu, r0, r_end, xu, c0, n, f, vec != 0, ring, acc);
    // The masked distances into Ds; a row whose thread holds a candidate
    // better than the row's kth entry is flagged for the merge (the lists
    // do not change before it).
#pragma unroll
    for (int i = 0; i < MICRO; ++i) {
      const int rr = ty + 16 * i;
      float kth = -1.0f;   // no candidate beats it: a row past the end
      int kth_id = -1;
      if (rr < n_rows) {
        kth = list_d(rr)[k - 1];
        kth_id = list_i(rr)[k - 1];
      }
      bool hit = false;
#pragma unroll
      for (int j = 0; j < MICRO; ++j) {
        const int col = c0 + tx + 16 * j;
        float d = 1.0f - fmaxf(acc[i][j], 0.0f);
        if (col == r0 + rr || col >= n || d > eps) d = INF_DIST;
        Ds[rr * RES_LD + tx + 16 * j] = d;
        hit |= Order::better(d, perm ? col_ids[tx + 16 * j] : col, kth,
                             kth_id);
      }
      if (hit) row_hit[rr] = 1;
    }
    __syncthreads();
    for (int rr = warp; rr < n_rows; rr += WARPS) {
      if (!row_hit[rr]) continue;
      const float* drow = Ds + rr * RES_LD;
      // Two halves of 64 columns, in ascending column order.  Their
      // ballots order every lane's read of the flag before it is cleared.
      tile::merge_row<Order, W>(drow, c0, list_d(rr), list_i(rr), k, lane,
                                perm ? col_ids : nullptr);
      tile::merge_row<Order, W>(drow + 64, c0 + 64, list_d(rr), list_i(rr),
                                k, lane, perm ? col_ids + 64 : nullptr);
      if (lane == 0) row_hit[rr] = 0;
    }
    __syncthreads();
  }

  if (part) {   // the split's partial lists [splits, row_count, k]
    knn_wide::Ent* lists =
        part + ((size_t)blockIdx.y * row_count + (r0 - row_start)) * k;
    for (int e = tid; e < n_rows * k; e += THREADS)
      lists[e] = knn_wide::Ent{run_d[e], run_i[e]};
    return;
  }
  for (int e = tid; e < n_rows * k; e += THREADS) {
    const int rr = e / k, s = e - rr * k;
    out_d[out_row(rr) * k + s] = run_d[e];
    out_i[out_row(rr) * k + s] = run_i[e];
  }
}

}  // namespace

extern "C" {

// Rows [row_start, row_start + row_count) of the unit corpus xu [n, f]
// against the columns [col_start, n) -> out_d / out_i, on the given device
// and stream.  Without perm, out is [row_count, k] in row order; with perm
// (xu permuted by it) out is [n, k] indexed by original row, and only the
// rows perm[row_start .. row_start + row_count) are written.  With seeded
// != 0, out already holds each row's sorted starting list.  With splits >
// 1 the column walk is cut into that many ranges, each writing partial
// lists into part (scratch of [splits, row_count, k] entries of 8 bytes,
// and row_count more for a wide list), which a second launch merges into
// out as it is: each row's seed or (2.0, -1) entries; a wide list (k > 128)
// always takes that second launch.  Returns the CUDA error code of the
// launch (0 on success).
int knn_launch(const float* xu, int n, int f, int row_start, int row_count,
               float eps, int k, int col_start, int diag_start,
               const int* perm, int seeded, int splits, void* part,
               float* out_d, int* out_i, int device, void* stream) {
  const int words = regtile::list_words(k);
  if (n <= 0 || f <= 0 || row_count <= 0 || words < 0 || row_start < 0 ||
      row_start + row_count > n || col_start < 0 || col_start >= n ||
      splits < 1 || (splits > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (words == 0)
    return knn_wide::launch(xu, n, f, row_start, row_count, eps, k,
                            col_start, diag_start, perm, splits, part, out_d,
                            out_i, (size_t)k, 1, device,
                            (cudaStream_t)stream);
  // The ring takes 72 KB and the lists up to 128 KB more: above the 48 KB
  // a launch gets without opting in.
  const size_t smem = regtile::smem_bytes(k);
  int smem_max = 0;
  err = cudaDeviceGetAttribute(&smem_max,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               device);
  if (err != cudaSuccess) return (int)err;
  if (smem > (size_t)smem_max) return (int)cudaErrorInvalidValue;
  // A rotated or permuted walk, or a seed list of any ids, offers ids out
  // of order: MinLex.
  const bool lex = diag_start || perm || seeded;
  auto kernel = lex ? &knn_kernel<tile::MinLex, 2> : &knn_kernel<tile::Min, 2>;
  if (words == 4)
    kernel = lex ? &knn_kernel<tile::MinLex, 4> : &knn_kernel<tile::Min, 4>;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int n_tiles = (n - col_start + regtile::TILE - 1) / regtile::TILE;
  const int tiles_per_split = (n_tiles + splits - 1) / splits;
  if ((splits - 1) * tiles_per_split >= n_tiles)  // every split non-empty
    return (int)cudaErrorInvalidValue;
  knn_wide::Ent* lists =
      splits > 1 ? static_cast<knn_wide::Ent*>(part) : nullptr;
  const int vec = regtile::can_vectorize<float>(xu, f);
  const dim3 grid((row_count + regtile::TILE - 1) / regtile::TILE, splits);
  cudaStream_t st = (cudaStream_t)stream;
  kernel<<<grid, regtile::THREADS, smem, st>>>(
      xu, n, f, vec, row_start, row_count, eps, k, col_start, diag_start,
      perm, seeded, tiles_per_split, lists, out_d, out_i);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  return knn_wide::merge<knn_wide::Asc>(lists, row_start, row_count, k,
                                        splits, perm, out_d, out_i,
                                        (size_t)k, 1, 0, st);
}

const char* knn_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
