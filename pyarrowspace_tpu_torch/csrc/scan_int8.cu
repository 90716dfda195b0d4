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
// in the order above (__fmul_rn, tile::blend: no fma contraction), so the
// kernel equals its plain version (ops/cuda/scan_int8.py) bit for bit, ids
// and scores.  That also frees a later version to move the product to the
// int8 tensor cores (mma.sync / wgmma on s8) without changing one result.
//
// What bounds it on the H100: the products.  At 313,841 x 384 and 4,096
// queries they are 4.9e11 int8 multiply-adds; the int8 tensor cores would
// take 0.5 ms for them and the corpus read (120 MB) 0.04 ms.  This first
// version runs them as __dp4a (four multiply-adds an instruction) outside
// the tensor cores, fed by 32-bit shared-memory loads: a right and simple
// kernel, not yet a fast one.
//
// The design is K2's (scan_topk.cu).  Launch 1: one block of 256 threads per
// (64-query block, corpus split); per 64-item tile, a shared-memory tiled
// product of 4 x 4 int32 accumulators a thread over slabs of 32 words
// (128 features: rows are packed as 32-bit words, F padded with zeros to a
// multiple of 4 by the caller), the epilogue into a shared 64 x 64 score
// tile, and one warp per query offers the improving scores to its running
// list (tile_common.cuh; narrow lists in shared memory, wide ones in place
// in the partial lists).  Launch 2 (tile::merge_splits) merges the splits'
// partial lists in split order.

#include <cuda_runtime.h>

#include "tile_common.cuh"

namespace {

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

template <int W>
__global__ void __launch_bounds__(tile::THREADS)
    scan_int8_kernel(const int* __restrict__ xq,
                     const float* __restrict__ srow,
                     const float* __restrict__ lam, int n, int fw,
                     const int* __restrict__ qq,
                     const float* __restrict__ qscale,
                     const float* __restrict__ lamq, int q, float tau, int k,
                     int tiles_per_split, float* part_s, int* part_i) {
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

}  // namespace

extern "C" {

// Queries qq [q, fw] (int8 rows packed as fw 32-bit words) with scales
// qscale [q] and lambdas lamq [q] against the corpus xq [n, fw] (packed
// likewise) with row scales srow [n] and lambdas lam [n] -> out_s / out_i
// [q, k].  part_s / part_i are scratch of [splits, q, k].  Runs on the
// given device and stream; returns the CUDA error code (0 on success).
int scan_int8_launch(const int* xq, const float* srow, const float* lam,
                     int n, int fw, const int* qq, const float* qscale,
                     const float* lamq, int q, float tau, int k, int splits,
                     float* part_s, int* part_i, float* out_s, int* out_i,
                     int device, void* stream) {
  const int words = tile::list_words(k);
  if (n <= 0 || fw <= 0 || q <= 0 || words < 0 || k > n || splits <= 0)
    return (int)cudaErrorInvalidValue;
  const int n_tiles = (n + tile::TILE - 1) / tile::TILE;
  const int tiles_per_split = (n_tiles + splits - 1) / splits;
  if ((splits - 1) * tiles_per_split >= n_tiles)  // every split non-empty
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t list_bytes =
      words == 0 ? 0 : (size_t)k * (sizeof(float) + sizeof(int));
  const size_t smem =
      (size_t)tile::TILE_FLOATS * sizeof(float) + tile::TILE * list_bytes;
  auto scan = &scan_int8_kernel<0>;
  auto merge = &tile::merge_splits<0>;
  if (words == 2) {
    scan = &scan_int8_kernel<2>;
    merge = &tile::merge_splits<2>;
  } else if (words == 4) {
    scan = &scan_int8_kernel<4>;
    merge = &tile::merge_splits<4>;
  } else if (words == 8) {
    scan = &scan_int8_kernel<8>;
    merge = &tile::merge_splits<8>;
  }
  err = cudaFuncSetAttribute(
      scan, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((q + tile::TILE - 1) / tile::TILE, splits);
  cudaStream_t st = (cudaStream_t)stream;
  scan<<<grid, tile::THREADS, smem, st>>>(xq, srow, lam, n, fw, qq, qscale,
                                          lamq, q, tau, k, tiles_per_split,
                                          part_s, part_i);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t smem2 = tile::WARPS * list_bytes;
  merge<<<(q + tile::WARPS - 1) / tile::WARPS, tile::THREADS, smem2, st>>>(
      part_s, part_i, q, k, splits, out_s, out_i);
  return (int)cudaGetLastError();
}

const char* scan_int8_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
