// K4a and K4b: per-row top-m extraction of subtile serving.
//
// Replaces the TPU kernels pyarrowspace_tpu/ops/pallas/subtile_scan.py
// `_extract_iota_kernel_t` (K4b, driven by `_extract_ids_pallas_t`: the
// one-level top-S subtile select, ids are column numbers) and
// `_extract_kernel` (K4a, driven by `_extract_pool_pallas`: the pool cut
// and the two-level select, ids come from a cand array).  The TPU kernels
// extract m times: take the row's max, ties to the smallest id, eliminate
// that id.  Under their contract (distinct ids in a row, every value above
// the elimination value -3e38) that sequence is the top-m in
// lexicographic (value desc, id asc) order, which is what these kernels
// compute: out[r, 0..m) in that order.
//
// What bounds it on the H100: reading the rows once (Q x M floats; the
// select reads the 1 GB of K3's maxima at 1M rows and Q 16,384), and the
// latency of the few insertions a row makes (about m (1 + ln(M / m))).
//
// The simple design: one warp per row, with the row's running list in
// shared memory (tile_common.cuh's insertion, 2, 4 or 8 words a lane for
// m <= 256), or for m > 256 in place in the output row (the ids)
// and a scratch row (the values), shifted there (offer_wide: the subtile
// select at topk 1,024 keeps m 1,024 subtiles and a pool of 2,048).  The
// warp reads its row 128 values at a time (4 coalesced
// loads a lane in flight), keeps the values strictly better than the
// list's current mth by ballot, and offers them one by one.  K4b offers
// ids in ascending order with the Max order (ties to the earlier, smaller
// id); K4a's cand ids come in no order, so it compares (value, id) pairs
// with MaxLex.

#include <climits>

#include <cuda_runtime.h>
#include <math_constants.h>

#include "tile_common.cuh"

namespace {

constexpr int UNROLL = 4;

template <class Order, int W, bool kIota>
__global__ void __launch_bounds__(tile::THREADS)
    extract_kernel(const float* __restrict__ score,
                   const int* __restrict__ cand, int rows, int len, int m,
                   float* scratch, int* out) {
  using namespace tile;
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r = blockIdx.x * WARPS + warp;
  if (r >= rows) return;   // whole warp leaves together
  float* vals = W == 0 ? scratch + (size_t)r * m : smem + warp * m;
  int* ids = W == 0 ? out + (size_t)r * m
                    : reinterpret_cast<int*>(smem + WARPS * m) + warp * m;

  for (int j = lane; j < m; j += 32) {
    vals[j] = -CUDART_INF_F;
    ids[j] = INT_MAX;
  }
  __syncwarp();
  const float* row = score + (size_t)r * len;
  const int* cand_row = kIota ? nullptr : cand + (size_t)r * len;
  for (int base = 0; base < len; base += 32 * UNROLL) {
    float v[UNROLL];
    int id[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int j = base + 32 * u + lane;
      v[u] = j < len ? row[j] : -CUDART_INF_F;
      id[u] = kIota ? j : (j < len ? cand_row[j] : INT_MAX);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      unsigned hit = __ballot_sync(
          FULL, base + 32 * u + lane < len &&
                    Order::better(v[u], id[u], vals[m - 1], ids[m - 1]));
      while (hit) {
        const int src = __ffs(hit) - 1;
        hit &= hit - 1;
        const float sv = __shfl_sync(FULL, v[u], src);
        const int sid = __shfl_sync(FULL, id[u], src);
        offer<Order, W>(vals, ids, m, sv, sid, lane);
      }
    }
  }
  if (W != 0)
    for (int j = lane; j < m; j += 32) out[(size_t)r * m + j] = ids[j];
}

template <class Order, bool kIota>
int launch(const float* score, const int* cand, int rows, int len, int m,
           float* scratch, int* out, cudaStream_t st) {
  const int words = tile::list_words(m);
  auto kernel = &extract_kernel<Order, 0, kIota>;
  if (words == 2) kernel = &extract_kernel<Order, 2, kIota>;
  if (words == 4) kernel = &extract_kernel<Order, 4, kIota>;
  if (words == 8) kernel = &extract_kernel<Order, 8, kIota>;
  const size_t smem =
      words == 0 ? 0 : (size_t)tile::WARPS * m * (sizeof(float) + sizeof(int));
  kernel<<<(rows + tile::WARPS - 1) / tile::WARPS, tile::THREADS, smem, st>>>(
      score, cand, rows, len, m, scratch, out);
  return (int)cudaGetLastError();
}

int check(int rows, int len, int m, const float* scratch, int device) {
  const int words = tile::list_words(m);
  if (rows <= 0 || len <= 0 || m > len || words < 0 ||
      (words == 0 && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  return (int)cudaSetDevice(device);
}

}  // namespace

extern "C" {

// K4b: out [rows, m] = per row of score [rows, len], the columns of the m
// largest values, ties to the smaller column.  scratch is [rows, m] floats
// for m > 256 (may be null otherwise).  Returns the CUDA error code (0 on
// success).
int extract_ids_launch(const float* score, int rows, int len, int m,
                       float* scratch, int* out, int device, void* stream) {
  const int err = check(rows, len, m, scratch, device);
  if (err != 0) return err;
  return launch<tile::Max, true>(score, nullptr, rows, len, m, scratch, out,
                                 (cudaStream_t)stream);
}

// K4a: out [rows, m] = per row of score / cand [rows, len] (ids distinct
// within a row), the ids of the m largest values, ties to the smaller id.
// scratch as for K4b.  Returns the CUDA error code (0 on success).
int extract_pool_launch(const float* score, const int* cand, int rows,
                        int len, int m, float* scratch, int* out, int device,
                        void* stream) {
  const int err = check(rows, len, m, scratch, device);
  if (err != 0) return err;
  return launch<tile::MaxLex, false>(score, cand, rows, len, m, scratch, out,
                                     (cudaStream_t)stream);
}

const char* extract_topm_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
