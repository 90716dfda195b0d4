// K2: fused cosine + lambda-proximity scan with a running top-k.
//
// Replaces the TPU kernel pyarrowspace_tpu/ops/pallas/scan_topk.py
// `_scan_kernel` (driven by `_scan_pallas`, entered through
// `lambda_search_pallas`).  For every query q it keeps the k largest
//   score(q, i) = tau * (qn_q . xu_i) + (1 - tau) / (1 + |lam_i - lamq_q|)
// over the corpus, ties to the smallest id, with corpus ids >= n masked
// to -3e38; rows come out descending by score.  A score enters a list only
// if it beats the empty slot (-3e38, -1): a NaN or a score at or below
// -3e38 never does.  The corpus and queries are float32, or both bfloat16
// (the as_serving view: the caller rounds the queries to bf16 as the JAX
// package does); bf16 values are converted to float exactly on load and
// every score is one float32 fmaf chain.
//
// What bounds it on the H100: the products, Q x N x F x 2 = 0.99 TFLOP a
// batch of 4,096 queries over 313,841 x 384 in fp32 outside the tensor
// cores (14.7 ms at 67 TFLOP/s); every query block of 128 reads the
// corpus once (32 passes of 482 MB, mostly from L2 across the blocks that
// scan a split together).
//
// The design.  Launch 1: one block per (128-query block, corpus split);
// the splits are contiguous ranges of 128-item tiles, and the caller picks
// the fewest whose grid fills its last wave of blocks to 90% or more (one
// block an SM runs at a time; at Q 4,096 on 132 SMs, 4 splits: one wave of
// 128 blocks, where two blocks an SM would take three waves).  A block runs
// the register-tiled fp32 product of ffma_tile.cuh over its split's tiles
// in ascending order and blends (tile::blend), masking ids >= n.  Then, by
// the length of the lists:
//   - k <= 128 (narrow): running lists in shared memory (2 or 4 words a
//     lane; 200 KB a block with the ring at k 128), merged 64 columns at a
//     time, written to the partial lists [S, Q, k]; launch 2
//     (tile::merge_splits) merges them in split order, one warp a query,
//     with the same insertion rule.
//   - k > 128 (wide): the route of knn_wide.cuh, K1's, with this epilogue
//     (BlendEpi) and the descending key: each tile's survivors (the strict
//     (score, id) compare against the row's filter) buffered as keys,
//     staged in device memory, sorted and merged into the partial lists in
//     one pass, the splits sharing each query's best kth; launch 2 is its
//     split merge.  The lists of 129 to 256 would take 256 KB of shared
//     memory beside the ring, past a block's 227 KB.  What bounds this
//     route is what bounds the narrow one, the products, plus about k (1 +
//     ln(C / k)) survivors a query over a split of C items, each sorted and
//     merged a few times at most; any k the caller's scratch holds.  On
//     an H100 80GB HBM3 at 700 W (chip_smoke.py phase 2): k 200 at Q
//     4,096 38.15 ms against k 15's 30.01; k 1,024 at Q 1,024 20.85 ms.
// Both give the exact top-k in (score desc, id asc) order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "ffma_tile.cuh"
#include "knn_wide.cuh"
#include "tile_common.cuh"

namespace {

template <class T, int W>
__global__ void __launch_bounds__(regtile::THREADS, 1)
    scan_kernel(const T* __restrict__ xu, const float* __restrict__ lam,
                int n, int f, const T* __restrict__ qn,
                const float* __restrict__ lamq, int q, int vec, float tau,
                int k, int tiles_per_split, float* part_s, int* part_i) {
  using namespace regtile;
  extern __shared__ __align__(16) float ffma_smem[];
  float* ring = ffma_smem;
  float* Ss = ffma_smem;   // the tile's scores [128][RES_LD], in the ring
  __shared__ int row_hit[TILE];          // rows with a candidate to offer

  const int tid = threadIdx.x;
  const int tx = thread_x(), ty = thread_y();
  const int lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * TILE;
  const int split = blockIdx.y;
  const int c_begin = split * tiles_per_split * TILE;
  const int c_stop = min(n, c_begin + tiles_per_split * TILE);
  const int n_rows = min(TILE, q - q0);

  // The block's lists [n_rows][k] in shared memory.
  float* run_s = ffma_smem + RING_FLOATS;
  int* run_i = reinterpret_cast<int*>(run_s + TILE * k);
  for (int e = tid; e < n_rows * k; e += THREADS) {
    run_s[e] = tile::NEG_SCORE;
    run_i[e] = -1;
  }
  if (tid < TILE) row_hit[tid] = 0;
  float lq[MICRO];
#pragma unroll
  for (int i = 0; i < MICRO; ++i) {
    const int qi = q0 + ty + 16 * i;
    lq[i] = qi < q ? lamq[qi] : 0.0f;
  }
  const float one_minus_tau = 1.0f - tau;
  // The first barrier inside regtile::product orders the list writes before
  // any merge reads them.

  for (int c0 = c_begin; c0 < c_stop; c0 += TILE) {
    float acc[MICRO][MICRO];
    product(qn, q0, q, xu, c0, n, f, vec != 0, ring, acc);
    // The blended scores into Ss; a row whose thread holds a score above
    // the row's kth is flagged for the merge (the lists do not change
    // before it).
    float lc[MICRO];
#pragma unroll
    for (int j = 0; j < MICRO; ++j) {
      const int col = c0 + tx + 16 * j;
      lc[j] = col < n ? lam[col] : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < MICRO; ++i) {
      const int rr = ty + 16 * i;
      const float kth =
          rr < n_rows ? run_s[(size_t)rr * k + k - 1] : 3.0e38f;
      bool hit = false;
#pragma unroll
      for (int j = 0; j < MICRO; ++j) {
        float s = tile::blend(tau, one_minus_tau, acc[i][j], lc[j], lq[i]);
        if (c0 + tx + 16 * j >= n) s = tile::NEG_SCORE;
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

// The wide route's epilogue: the blended score, ids >= n masked to -3e38.
struct BlendEpi {
  using Order = knn_wide::Desc;
  const float* lam;
  const float* lamq;
  float tau, omt;
  float lq[regtile::MICRO], lc[regtile::MICRO];
  __device__ __forceinline__ void load(int q0, int q_end, int c0, int n) {
    using namespace regtile;
    const int tx = thread_x(), ty = thread_y();
#pragma unroll
    for (int i = 0; i < MICRO; ++i) {
      const int qi = q0 + ty + 16 * i;
      lq[i] = qi < q_end ? lamq[qi] : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < MICRO; ++j) {
      const int col = c0 + tx + 16 * j;
      lc[j] = col < n ? lam[col] : 0.0f;
    }
  }
  __device__ __forceinline__ float value(float acc, int i, int j, int,
                                         int col, int n) const {
    return col >= n ? tile::NEG_SCORE : tile::blend(tau, omt, acc, lc[j],
                                                      lq[i]);
  }
};

template <class T>
int launch(const void* xu, const float* lam, int n, int f, const void* qn,
           const float* lamq, int q, float tau, int k, int splits,
           void* part, float* out_s, int* out_i, int device,
           cudaStream_t st) {
  const T* x = static_cast<const T*>(xu);
  const T* qs = static_cast<const T*>(qn);
  if (regtile::list_words(k) == 0)
    return knn_wide::launch<T>(qs, x, BlendEpi{lam, lamq, tau, 1.0f - tau},
                               n, f, 0, q, k, 0, 0, nullptr, splits, part,
                               out_s, out_i, (size_t)k, 1, 1, device, st);
  const int n_tiles = (n + regtile::TILE - 1) / regtile::TILE;
  const int tiles_per_split = (n_tiles + splits - 1) / splits;
  if ((splits - 1) * tiles_per_split >= n_tiles)  // every split non-empty
    return (int)cudaErrorInvalidValue;
  // The ring takes 72 KB and the lists up to 128 KB more: above the 48 KB
  // a launch gets without opting in.
  const size_t smem = regtile::smem_bytes(k);
  int smem_max = 0;
  cudaError_t err = cudaDeviceGetAttribute(
      &smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return (int)err;
  if (smem > (size_t)smem_max) return (int)cudaErrorInvalidValue;
  auto scan = regtile::list_words(k) == 2 ? &scan_kernel<T, 2>
                                          : &scan_kernel<T, 4>;
  err = cudaFuncSetAttribute(
      scan, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int vec =
      regtile::can_vectorize<T>(xu, f) && regtile::can_vectorize<T>(qn, f);
  // The partial lists: [splits, q, k] scores, then as many ids.
  float* part_s = static_cast<float*>(part);
  int* part_i = reinterpret_cast<int*>(part_s + (size_t)splits * q * k);
  const dim3 grid((q + regtile::TILE - 1) / regtile::TILE, splits);
  scan<<<grid, regtile::THREADS, smem, st>>>(x, lam, n, f, qs, lamq, q, vec,
                                             tau, k, tiles_per_split, part_s,
                                             part_i);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // The merge keeps tile_common.cuh's narrow list layouts.
  const int words = tile::list_words(k);
  auto merge = words == 2 ? &tile::merge_splits<2> : &tile::merge_splits<4>;
  const size_t smem2 = tile::WARPS * (size_t)k * (sizeof(float) + sizeof(int));
  merge<<<(q + tile::WARPS - 1) / tile::WARPS, tile::THREADS, smem2, st>>>(
      part_s, part_i, q, k, splits, out_s, out_i);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Queries qn [q, f] (unit rows) with lambdas lamq [q] against the corpus
// xu [n, f] with lambdas lam [n] -> out_s / out_i [q, k].  xu and qn are
// both float (dtype 0) or both bf16 (dtype 1).  part is scratch of 8-byte
// words: [splits, q, k] for a narrow list (k <= 128); for a wide one
// [splits, q, k + knn_wide::STAGE] and q more.  Runs on the given device
// and stream.  Returns the CUDA error code (0 on success).
int scan_topk_launch(const void* xu, int dtype, const float* lam, int n,
                     int f, const void* qn, const float* lamq, int q,
                     float tau, int k, int splits, void* part, float* out_s,
                     int* out_i, int device, void* stream) {
  if (n <= 0 || f <= 0 || q <= 0 || regtile::list_words(k) < 0 || k > n ||
      splits <= 0 || dtype < 0 || dtype > 1)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  auto fn = dtype == 1 ? &launch<__nv_bfloat16> : &launch<float>;
  return fn(xu, lam, n, f, qn, lamq, q, tau, k, splits, part, out_s, out_i,
            device, st);
}

const char* scan_topk_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
