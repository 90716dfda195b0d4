// K2: fused cosine + lambda-proximity scan with a running top-k.
//
// Replaces the TPU kernel pyarrowspace_tpu/ops/pallas/scan_topk.py
// `_scan_kernel` (driven by `_scan_pallas`, entered through
// `lambda_search_pallas`).  For every query q it keeps the k largest
//   score(q, i) = tau * (qn_q . xu_i) + (1 - tau) / (1 + |lam_i - lamq_q|)
// over the corpus, ties to the smallest id, with corpus ids >= n masked
// to -3e38; rows come out descending by score.  The corpus and queries are
// float32, or both bfloat16 (the as_serving view: the caller rounds the
// queries to bf16 as the JAX package does); bf16 values are converted to
// float exactly on load and every score is one float32 fmaf chain.
//
// What bounds it on the H100: every query block of 64 reads the whole
// corpus once (4,096 queries over 313,841 x 384 fp32: 64 passes of 482 MB),
// and the products are Q x N x F x 2 = 0.99 TFLOP a batch of 4,096 in
// fp32 outside the tensor cores.
//
// The simple design.  Launch 1: one block per (64-query block, corpus
// split); the splits are contiguous ranges of 64-item tiles, and the
// caller picks their number so that the grid holds at least about two
// blocks per SM even for a single query.  A block runs the tiled fp32
// product of tile_common.cuh over its split's tiles in ascending order,
// blends, masks, and merges into running lists in shared memory, then
// writes its partial lists [S, Q, k].  Launch 2 (tile::merge_splits): one
// warp per query merges the S partial lists in split order with the same
// insertion rule, so the result is the exact top-k in (score desc, id asc)
// order.  Lists of k <= 256 live in shared memory, as templates on words
// per lane (2, 4, 8; the launcher takes the narrowest that holds k; at k
// 256 they take 161 KB with the tiles).  Longer lists stay in place in the
// partial lists (launch 1) and in the output rows (launch 2), shifted there
// (tile_common.cuh offer_wide): any k the caller's scratch holds.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tile_common.cuh"

namespace {

template <class T, int W>
__global__ void __launch_bounds__(tile::THREADS)
    scan_kernel(const T* __restrict__ xu, const float* __restrict__ lam,
                int n, int f, const T* __restrict__ qn,
                const float* __restrict__ lamq, int q, float tau, int k,
                int tiles_per_split, float* part_s, int* part_i) {
  using namespace tile;
  extern __shared__ float smem[];
  auto As = reinterpret_cast<float(*)[PAD]>(smem);
  auto Bs = reinterpret_cast<float(*)[PAD]>(smem + SLAB * PAD);
  auto Ss = reinterpret_cast<float(*)[PAD]>(smem + 2 * SLAB * PAD);

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * TILE;
  const int split = blockIdx.y;
  const int c_begin = split * tiles_per_split * TILE;
  const int c_stop = min(n, c_begin + tiles_per_split * TILE);
  const int n_rows = min(TILE, q - q0);

  // The block's lists [n_rows][k]: in shared memory, or its partial lists.
  float* run_s = smem + TILE_FLOATS;
  int* run_i = reinterpret_cast<int*>(run_s + TILE * k);
  if (W == 0) {
    run_s = part_s + ((size_t)split * q + q0) * k;
    run_i = part_i + ((size_t)split * q + q0) * k;
  }
  for (int e = tid; e < n_rows * k; e += THREADS) {
    run_s[e] = NEG_SCORE;
    run_i[e] = -1;
  }
  float lq[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    lq[i] = qi < q ? lamq[qi] : 0.0f;
  }
  const float one_minus_tau = 1.0f - tau;
  __syncthreads();

  for (int c0 = c_begin; c0 < c_stop; c0 += TILE) {
    float acc[4][4];
    tile_product(qn, q0, q, xu, c0, n, f, As, Bs, acc);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = c0 + tx + 16 * j;
      const float lc = col < n ? lam[col] : 0.0f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float s = blend(tau, one_minus_tau, acc[i][j], lc, lq[i]);
        if (col >= n) s = NEG_SCORE;
        Ss[ty + 16 * i][tx + 16 * j] = s;
      }
    }
    __syncthreads();
    for (int rr = warp; rr < TILE && q0 + rr < q; rr += WARPS)
      merge_row<Max, W>(Ss[rr], c0, run_s + (size_t)rr * k,
                        run_i + (size_t)rr * k, k, lane);
    __syncthreads();
  }

  if (W != 0) {
    float* o_s = part_s + ((size_t)split * q + q0) * k;
    int* o_i = part_i + ((size_t)split * q + q0) * k;
    for (int e = tid; e < n_rows * k; e += THREADS) {
      o_s[e] = run_s[e];
      o_i[e] = run_i[e];
    }
  }
}

template <class T>
int launch(const void* xu, const float* lam, int n, int f, const void* qn,
           const float* lamq, int q, float tau, int k, int splits,
           float* part_s, int* part_i, float* out_s, int* out_i,
           cudaStream_t st) {
  const int words = tile::list_words(k);
  const int n_tiles = (n + tile::TILE - 1) / tile::TILE;
  const int tiles_per_split = (n_tiles + splits - 1) / splits;
  if ((splits - 1) * tiles_per_split >= n_tiles)  // every split non-empty
    return (int)cudaErrorInvalidValue;
  // At k = 256 the lists take 128 KB (161 KB with the tiles): above the
  // 48 KB a launch gets without opting in.  Wide lists take none.
  const size_t list_bytes =
      words == 0 ? 0 : (size_t)k * (sizeof(float) + sizeof(int));
  const size_t smem =
      (size_t)tile::TILE_FLOATS * sizeof(float) + tile::TILE * list_bytes;
  auto scan = &scan_kernel<T, 0>;
  auto merge = &tile::merge_splits<0>;
  if (words == 2) {
    scan = &scan_kernel<T, 2>;
    merge = &tile::merge_splits<2>;
  } else if (words == 4) {
    scan = &scan_kernel<T, 4>;
    merge = &tile::merge_splits<4>;
  } else if (words == 8) {
    scan = &scan_kernel<T, 8>;
    merge = &tile::merge_splits<8>;
  }
  cudaError_t err = cudaFuncSetAttribute(
      scan, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((q + tile::TILE - 1) / tile::TILE, splits);
  scan<<<grid, tile::THREADS, smem, st>>>(
      static_cast<const T*>(xu), lam, n, f, static_cast<const T*>(qn), lamq,
      q, tau, k, tiles_per_split, part_s, part_i);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t smem2 = tile::WARPS * list_bytes;
  merge<<<(q + tile::WARPS - 1) / tile::WARPS, tile::THREADS, smem2, st>>>(
      part_s, part_i, q, k, splits, out_s, out_i);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Queries qn [q, f] (unit rows) with lambdas lamq [q] against the corpus
// xu [n, f] with lambdas lam [n] -> out_s / out_i [q, k].  xu and qn are
// both float (dtype 0) or both bf16 (dtype 1).  part_s / part_i are
// scratch of [splits, q, k].  Runs on the given device and stream.
// Returns the CUDA error code (0 on success).
int scan_topk_launch(const void* xu, int dtype, const float* lam, int n,
                     int f, const void* qn, const float* lamq, int q,
                     float tau, int k, int splits, float* part_s, int* part_i,
                     float* out_s, int* out_i, int device, void* stream) {
  if (n <= 0 || f <= 0 || q <= 0 || tile::list_words(k) < 0 || k > n ||
      splits <= 0 || dtype < 0 || dtype > 1)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  auto fn = dtype == 1 ? &launch<__nv_bfloat16> : &launch<float>;
  return fn(xu, lam, n, f, qn, lamq, q, tau, k, splits, part_s, part_i,
            out_s, out_i, st);
}

const char* scan_topk_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
