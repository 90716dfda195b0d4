// K1: fused exact eps/k-NN scan over unit rows.
//
// Replaces the TPU kernel pyarrowspace_tpu/ops/pallas/knn.py
// `_knn_block_kernel` (driven by `_knn_pallas_all`, entered through
// `knn_graph_candidates_pallas`).  For every row i of a row range it keeps
// the k smallest d(i, j) = 1 - max(0, x_i . x_j) over all columns j, with
// self, columns >= n and d > eps masked to 2.0 before the merge; missing
// entries stay (2.0, -1).  Rows come out ascending by (distance, id).
//
// What bounds it on the H100: the products.  At 313,841 x 384 the scan is
// 313,841^2 x 384 x 2 = 75.6 TFLOP of fp32 multiply-adds, against 67
// TFLOP/s of fp32 outside the tensor cores; the merge touches each of the
// N^2 candidates once (a compare against the row's kth) and inserts only
// about k (1 + ln(N / k)) times per row.
//
// The simple design: one block of 256 threads per 64-row block; the block
// walks every 64-column tile in ascending order (nothing carries between
// blocks on a GPU, so the TPU's sequential grid axis becomes this loop).
// Per tile: a shared-memory tiled fp32 product with feature slabs of 32
// and 4 x 4 accumulators a thread (tile_common.cuh), the mask epilogue into
// a shared 64 x 64 tile, then one warp per row offers the improving
// candidates to the row's running list.  The result is exact in fp32, and
// d(i, j) == d(j, i) bitwise.  Lists of k <= 256 live in shared memory, as
// templates on words per lane (2, 4, 8; the launcher takes the narrowest
// that holds k); lists of k > 256 would take 64 x k x 8 bytes of
// shared memory (512 KB at k 1,024), so they are kept in place in the
// output rows and shifted there (tile_common.cuh offer_wide).  wgmma, TMA
// and pipelining are later work.

#include <cuda_runtime.h>

#include "tile_common.cuh"

namespace {

constexpr float INF_DIST = 2.0f;

template <int W>
__global__ void __launch_bounds__(tile::THREADS)
    knn_kernel(const float* __restrict__ xu, int n, int f, int row_start,
               int row_count, float eps, int k, float* out_d, int* out_i) {
  using namespace tile;
  extern __shared__ float smem[];
  auto As = reinterpret_cast<float(*)[PAD]>(smem);
  auto Bs = reinterpret_cast<float(*)[PAD]>(smem + SLAB * PAD);
  auto Ds = reinterpret_cast<float(*)[PAD]>(smem + 2 * SLAB * PAD);

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int lane = tid & 31, warp = tid >> 5;
  const int r0 = row_start + blockIdx.x * TILE;
  const int r_end = row_start + row_count;
  const int n_rows = min(TILE, r_end - r0);

  // The block's lists [n_rows][k]: in shared memory, or the output rows.
  float* run_d = smem + TILE_FLOATS;
  int* run_i = reinterpret_cast<int*>(run_d + TILE * k);
  if (W == 0) {
    run_d = out_d + (size_t)(r0 - row_start) * k;
    run_i = out_i + (size_t)(r0 - row_start) * k;
  }
  for (int e = tid; e < n_rows * k; e += THREADS) {
    run_d[e] = INF_DIST;
    run_i[e] = -1;
  }
  // The first barrier inside tile_product orders these writes before any
  // merge reads them.

  for (int c0 = 0; c0 < n; c0 += TILE) {
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
    for (int rr = warp; rr < TILE && r0 + rr < r_end; rr += WARPS)
      merge_row<Min, W>(Ds[rr], c0, run_d + rr * k, run_i + rr * k, k,
                        lane);
    __syncthreads();
  }

  if (W != 0) {
    float* o_d = out_d + (size_t)(r0 - row_start) * k;
    int* o_i = out_i + (size_t)(r0 - row_start) * k;
    for (int e = tid; e < n_rows * k; e += THREADS) {
      o_d[e] = run_d[e];
      o_i[e] = run_i[e];
    }
  }
}

}  // namespace

extern "C" {

// Rows [row_start, row_start + row_count) of the unit corpus xu [n, f]
// against all n columns -> out_d / out_i [row_count, k], on the given
// device and stream.  Returns the CUDA error code of the launch (0 on
// success).
int knn_launch(const float* xu, int n, int f, int row_start, int row_count,
               float eps, int k, float* out_d, int* out_i, int device,
               void* stream) {
  const int words = tile::list_words(k);
  if (n <= 0 || f <= 0 || row_count <= 0 || words < 0 || row_start < 0 ||
      row_start + row_count > n)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  // At k = 256 the lists take 128 KB: above the 48 KB a launch gets
  // without opting in.  Wide lists take no shared memory.
  const size_t smem =
      (size_t)tile::TILE_FLOATS * sizeof(float) +
      (words == 0 ? 0 : (size_t)tile::TILE * k * (sizeof(float) + sizeof(int)));
  auto kernel = &knn_kernel<0>;
  if (words == 2) kernel = &knn_kernel<2>;
  if (words == 4) kernel = &knn_kernel<4>;
  if (words == 8) kernel = &knn_kernel<8>;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (row_count + tile::TILE - 1) / tile::TILE;
  kernel<<<blocks, tile::THREADS, smem, (cudaStream_t)stream>>>(
      xu, n, f, row_start, row_count, eps, k, out_d, out_i);
  return (int)cudaGetLastError();
}

const char* knn_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
