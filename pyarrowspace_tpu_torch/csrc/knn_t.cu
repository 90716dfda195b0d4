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
// The GPU meaning of that layout: a thread owns a row's running list, kept
// slot-major in shared memory (the 32 threads of a warp touch 32
// consecutive words), with the list's kth distance in a register; it walks
// its columns of the tile in ascending order and inserts an improving one
// by a shift inside its own list: no ballot, no shuffle.  Columns arrive in
// ascending order and an entry enters only if strictly below the kth,
// after every entry below or equal to it, so each list is the
// lexicographic (distance, id) top-k of its columns (the Min rule of
// tile_common.cuh).
//
// What bounds it on the H100: the products, as K1 (2 R N F fp32
// multiply-adds).  The design is K1's product: one block of 256 threads per
// 128 rows walks the 128-column tiles with ffma_tile.cuh's register-tiled
// product (8 x 8 a thread, the two-stage ring), so every distance is
// bitwise K1's, and writes the masked distances into the ring candidates
// major, Ds[column][row] (a column stride of 132 floats: the epilogue's
// stores and the owners' reads are both conflict-free).  Then every thread
// merges:
//   - k <= 64: two threads a row, each owning a partial list over one half
//     of every tile's columns (256 x k x 8 bytes, 128 KB at k 64, beside the
//     72 KB ring); the two lists of a row are merged once at the end by
//     (distance, id), their ids being distinct;
//   - k 65 to 128: one thread a row over all 128 columns (the two partial
//     lists would pass the 227 KB a block may have); the other 128 threads
//     wait at the barrier;
//   - k > 128: the wide route of knn_wide.cuh, K1's own, writing the
//     slot-major output.

#include <cuda_runtime.h>

#include "ffma_tile.cuh"
#include "knn_wide.cuh"
#include "tile_common.cuh"

namespace {

constexpr float INF_DIST = 2.0f;
constexpr int T_LD = regtile::TILE + 4;   // column stride of Ds
constexpr int HALVES_MAX_K = 64;          // two owners a row up to here
static_assert(regtile::TILE * T_LD <= regtile::RING_FLOATS,
              "the transposed tile lives in the ring");

// OWNERS list owners: 2 TILE (two a row) or TILE (one a row).
template <int OWNERS>
__global__ void __launch_bounds__(regtile::THREADS, 1)
    knn_t_kernel(const float* __restrict__ xu, int n, int f, int vec,
                 int row_start, int row_count, float eps, int k,
                 float* out_d, int* out_i) {
  using namespace regtile;
  constexpr int COLS = TILE * TILE / OWNERS;   // an owner's columns a tile
  extern __shared__ __align__(16) float ffma_smem[];
  float* ring = ffma_smem;
  float* Ds = ffma_smem;   // Ds[column * T_LD + row], in the ring
  // Slot s of owner t lives at list[s * OWNERS + t].
  float* list_d = ffma_smem + RING_FLOATS;
  int* list_i = reinterpret_cast<int*>(list_d + (size_t)OWNERS * k);

  const int tid = threadIdx.x;
  const int tx = thread_x(), ty = thread_y();
  const int r0 = row_start + blockIdx.x * TILE;
  const int r_end = row_start + row_count;
  const int n_rows = min(TILE, r_end - r0);
  const size_t out0 = (size_t)(r0 - row_start);
  for (int e = tid; e < k * OWNERS; e += THREADS) {
    list_d[e] = INF_DIST;
    list_i[e] = -1;
  }
  // The first barrier inside regtile::product orders these writes before
  // the merge reads them.

  const int rr = tid % TILE;              // the owner's row
  const int cb = (tid / TILE) * COLS;     // and its first column of a tile
  const bool owner = tid < OWNERS && rr < n_rows;
  float kth = INF_DIST;   // the owner's kth distance
  for (int c0 = 0; c0 < n; c0 += TILE) {
    float acc[MICRO][MICRO];
    product(xu, r0, r_end, xu, c0, n, f, vec != 0, ring, acc);
#pragma unroll
    for (int i = 0; i < MICRO; ++i) {
      const int row = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < MICRO; ++j) {
        const int col = c0 + tx + 16 * j;
        float d = 1.0f - fmaxf(acc[i][j], 0.0f);
        if (col == r0 + row || col >= n || d > eps) d = INF_DIST;
        Ds[(tx + 16 * j) * T_LD + row] = d;
      }
    }
    __syncthreads();
    if (owner) {
      float* ld = list_d + tid;
      int* li = list_i + tid;
      for (int c = cb; c < cb + COLS; ++c) {
        const float v = Ds[c * T_LD + rr];
        if (!(v < kth)) continue;
        // Shift the entries above v up one slot (the kth falls off), then
        // put (v, c0 + c) after every entry below or equal to it.
        int j = k - 1;
        while (j > 0) {
          const float w = ld[(j - 1) * OWNERS];
          if (!(w > v)) break;
          ld[j * OWNERS] = w;
          li[j * OWNERS] = li[(j - 1) * OWNERS];
          --j;
        }
        ld[j * OWNERS] = v;
        li[j * OWNERS] = c0 + c;
        kth = ld[(k - 1) * OWNERS];
      }
    }
    __syncthreads();
  }

  if (tid >= n_rows) return;
  float* od = out_d + out0 + tid;
  int* oi = out_i + out0 + tid;
  if (OWNERS == TILE) {
    for (int s = 0; s < k; ++s) {
      od[s * (size_t)row_count] = list_d[s * OWNERS + tid];
      oi[s * (size_t)row_count] = list_i[s * OWNERS + tid];
    }
    return;
  }
  // The row's two partial lists, merged by (distance, id).
  int a = 0, b = 0;
  for (int s = 0; s < k; ++s) {
    const float da = list_d[a * OWNERS + tid];
    const int ia = list_i[a * OWNERS + tid];
    const float db = list_d[b * OWNERS + TILE + tid];
    const int ib = list_i[b * OWNERS + TILE + tid];
    const bool take_a = tile::MinLex::better(da, ia, db, ib) ||
                        !tile::MinLex::better(db, ib, da, ia);
    od[s * (size_t)row_count] = take_a ? da : db;
    oi[s * (size_t)row_count] = take_a ? ia : ib;
    a += take_a;
    b += !take_a;
  }
}

template <int OWNERS>
int launch_narrow(const float* xu, int n, int f, int row_start,
                  int row_count, float eps, int k, float* out_d, int* out_i,
                  int device, cudaStream_t st) {
  const size_t smem = (size_t)regtile::RING_FLOATS * sizeof(float) +
                      (size_t)OWNERS * k * (sizeof(float) + sizeof(int));
  int smem_max = 0;
  cudaError_t err = cudaDeviceGetAttribute(
      &smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return (int)err;
  if (smem > (size_t)smem_max) return (int)cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(knn_t_kernel<OWNERS>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int vec = regtile::can_vectorize<float>(xu, f);
  const int blocks = (row_count + regtile::TILE - 1) / regtile::TILE;
  knn_t_kernel<OWNERS><<<blocks, regtile::THREADS, smem, st>>>(
      xu, n, f, vec, row_start, row_count, eps, k, out_d, out_i);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Rows [row_start, row_start + row_count) of the unit corpus xu [n, f]
// against all n columns -> out_d / out_i, slot-major: slot s of launch row
// r at s * out_ld + r, on the given device and stream.  Lists of k > 128
// (K1's wide route) read out as it is, (2.0, -1) entries, and take `splits`
// column splits with part as scratch of [splits, row_count, k] entries of 8
// bytes (k <= 128: splits 1, part unused).  Returns the CUDA error code of
// the launch (0 on success).
int knn_t_launch(const float* xu, int n, int f, int row_start, int row_count,
                 float eps, int k, int splits, void* part, float* out_d,
                 int* out_i, int out_ld, int device, void* stream) {
  if (n <= 0 || f <= 0 || row_count <= 0 || k < 1 || row_start < 0 ||
      row_start + row_count > n || out_ld < row_count ||
      (k <= regtile::MAX_NARROW && splits != 1))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  if (k > regtile::MAX_NARROW)
    return knn_wide::launch(xu, n, f, row_start, row_count, eps, k, 0, 0,
                            nullptr, splits, part, out_d, out_i, 1,
                            (size_t)out_ld, device, st);
  if (row_count != out_ld) return (int)cudaErrorInvalidValue;
  return k <= HALVES_MAX_K
             ? launch_narrow<2 * regtile::TILE>(xu, n, f, row_start,
                                                row_count, eps, k, out_d,
                                                out_i, device, st)
             : launch_narrow<regtile::TILE>(xu, n, f, row_start, row_count,
                                            eps, k, out_d, out_i, device,
                                            st);
}

const char* knn_t_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
