// K1t: the exact eps/k-NN scan with a transposed, thread-owned merge.
//
// Replaces the TPU kernel pyarrowspace_tpu/ops/pallas/knn.py
// `_knn_block_kernel_t` (driven by `_knn_pallas_all_t`, entered through
// `knn_graph_candidates_pallas(variant="transposed")`).  It computes K1's
// function (csrc/knn.cu): for every row i of a row range, the k smallest
// d(i, j) = 1 - max(0, x_i . x_j) over all columns j, self, columns >= n
// and d > eps masked to 2.0; missing entries (2.0, -1); ascending by
// (distance, id).  The outputs are transposed, [k, row_count], as the TPU
// kernel's [k_pad, N] are; the wrapper transposes them once.
//
// On the TPU the variant put candidates on sublanes and rows on lanes, so
// the merge's reductions ran over sublanes without cross-lane shuffles.
// The GPU meaning of that layout: one thread owns one row's running list,
// kept slot-major ([k][64 rows] in shared memory, so the 32 threads of a
// warp touch 32 consecutive words), with the row's kth distance in a
// register.  The thread walks the tile's 64 distances in ascending column
// order and inserts an improving one by a shift inside its own list: no
// ballot, no shuffle.  Columns arrive in ascending order and an entry
// enters only if strictly below the kth, after every entry below or equal
// to it, so the list is the lexicographic (distance, id) top-k (the Min
// rule of tile_common.cuh).  Lists of k > 256 live in place in the
// [k, row_count] output, which is slot-major and coalesced already.
//
// What bounds it on the H100: the products, as K1 (2 R N F fp32
// multiply-adds).  The product is tile_product, so every distance is
// bitwise K1's.  In this simple design 64 of the block's 256 threads merge
// while the other 192 wait at the barrier.

#include <cuda_runtime.h>

#include "tile_common.cuh"

namespace {

constexpr float INF_DIST = 2.0f;

__global__ void __launch_bounds__(tile::THREADS)
    knn_t_kernel(const float* __restrict__ xu, int n, int f, int row_start,
                 int row_count, float eps, int k, int wide, float* out_d,
                 int* out_i) {
  using namespace tile;
  extern __shared__ float smem[];
  auto As = reinterpret_cast<float(*)[PAD]>(smem);
  auto Bs = reinterpret_cast<float(*)[PAD]>(smem + SLAB * PAD);
  // The distance tile, candidates major: Ds[column][row].
  auto Ds = reinterpret_cast<float(*)[PAD]>(smem + 2 * SLAB * PAD);

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int r0 = row_start + blockIdx.x * TILE;
  const int r_end = row_start + row_count;
  const int n_rows = min(TILE, r_end - r0);
  const size_t out0 = (size_t)(r0 - row_start);

  // Slot s of block row rr lives at list[s * stride + rr].
  float* list_d = smem + TILE_FLOATS;
  int* list_i = reinterpret_cast<int*>(list_d + TILE * k);
  size_t stride = TILE;
  if (wide) {
    list_d = out_d + out0;
    list_i = out_i + out0;
    stride = (size_t)row_count;
  }
  for (int e = tid; e < k * TILE; e += THREADS) {
    const int s = e / TILE, rr = e - s * TILE;
    if (rr < n_rows) {
      list_d[s * stride + rr] = INF_DIST;
      list_i[s * stride + rr] = -1;
    }
  }
  // The first barrier inside tile_product orders these writes before the
  // merge reads them.

  float kth = INF_DIST;   // the owning thread's kth distance
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
        Ds[tx + 16 * j][ty + 16 * i] = d;
      }
    }
    __syncthreads();
    if (tid < n_rows) {
      float* ld = list_d + tid;
      int* li = list_i + tid;
      for (int c = 0; c < TILE; ++c) {
        const float v = Ds[c][tid];
        if (!(v < kth)) continue;
        // Shift the entries above v up one slot (the kth falls off), then
        // put (v, c0 + c) after every entry below or equal to it.
        int j = k - 1;
        while (j > 0) {
          const float w = ld[(j - 1) * stride];
          if (!(w > v)) break;
          ld[j * stride] = w;
          li[j * stride] = li[(j - 1) * stride];
          --j;
        }
        ld[j * stride] = v;
        li[j * stride] = c0 + c;
        kth = ld[(k - 1) * stride];
      }
    }
    __syncthreads();
  }

  if (!wide) {
    for (int e = tid; e < k * TILE; e += THREADS) {
      const int s = e / TILE, rr = e - s * TILE;
      if (rr < n_rows) {
        out_d[s * (size_t)row_count + out0 + rr] = list_d[e];
        out_i[s * (size_t)row_count + out0 + rr] = list_i[e];
      }
    }
  }
}

}  // namespace

extern "C" {

// Rows [row_start, row_start + row_count) of the unit corpus xu [n, f]
// against all n columns -> out_d / out_i [k, row_count] (slot-major), on
// the given device and stream.  Returns the CUDA error code of the launch
// (0 on success).
int knn_t_launch(const float* xu, int n, int f, int row_start, int row_count,
                 float eps, int k, float* out_d, int* out_i, int device,
                 void* stream) {
  if (n <= 0 || f <= 0 || row_count <= 0 || k < 1 || row_start < 0 ||
      row_start + row_count > n)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  // Lists of up to 256 entries in shared memory (128 KB at 256, above the
  // 48 KB a launch gets without opting in); longer ones in the output.
  const int wide = k > tile::MAX_NARROW;
  const size_t smem =
      (size_t)tile::TILE_FLOATS * sizeof(float) +
      (wide ? 0 : (size_t)tile::TILE * k * (sizeof(float) + sizeof(int)));
  err = cudaFuncSetAttribute(
      knn_t_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (row_count + tile::TILE - 1) / tile::TILE;
  knn_t_kernel<<<blocks, tile::THREADS, smem, (cudaStream_t)stream>>>(
      xu, n, f, row_start, row_count, eps, k, wide, out_d, out_i);
  return (int)cudaGetLastError();
}

const char* knn_t_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
