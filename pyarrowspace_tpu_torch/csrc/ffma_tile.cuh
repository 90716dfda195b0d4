// The register-tiled fp32 product of K1 (knn.cu, knn_wide.cuh), K1t
// (knn_t.cu) and K2 (scan_topk.cu):
// 128 rows against 128 rows per block of 256 threads, each thread holding
// an 8 x 8 micro-tile of the result in registers.
//
// The bits are tile_common.cuh's: each output element is ONE dot_step
// (fmaf) chain over features 0..F-1 in ascending order, starting from
// +0.0, with the features past F entering as zeros.  The accumulator never
// becomes -0.0 (it starts at +0.0, and a sum rounds to -0.0 only when both
// addends are -0.0), so the trailing fmaf(0, 0, acc) steps leave it as it
// is, and the element equals tile::tile_product's bit for bit whatever the
// two products' slab widths.  K5's SIMT route (gather_score.cu, on float32
// operands) keeps tile_product's chain and is the witness of this on the
// card (ops/cuda/compare.py: k5_distance for K1, k5_blend for K2).
// The feature sum is never split across threads, warps or stages.
//
// What bounds the product on the H100: the fp32 FMA pipe (67 TFLOP/s; no
// tensor-core format keeps the bits).  The design feeds it from registers:
//   - Thread (tx, ty) (thread_x, thread_y below) owns rows ty + 16 i and
//     columns tx + 16 j, i, j = 0..7.  Each step of 4 features loads its 8
//     rows and its 8 columns as 16-byte LDS.128 (4 consecutive features of
//     a row each): 16 shared-memory loads per 256 FMAs, against 8 per 16
//     in tile_product.
//   - Slabs are staged row-major ([128 rows][32 features], row stride LD =
//     36 floats), so a row's 4 features are one aligned 16-byte word.  The
//     8 tx of a warp read 8 rows 36 floats apart: bank groups (tx + step)
//     mod 8, all different, so the B reads are conflict-free; its 4 ty
//     read 4 A rows, each a broadcast to the lanes that share it.
//   - The staging is a two-stage ring fed by register prefetch: while a
//     slab is multiplied, the next slab's global loads (16-byte LDG when
//     F % 4 == 0 and the rows are aligned, else one value a load, masked,
//     in the same kernel) are in flight; they are converted to float
//     (bf16 exactly) and stored after the multiply.  One barrier a slab.
//
// Shared memory of a block: the ring (2 x 2 x 128 x 36 floats, 72 KB) and
// the running lists.  The 128 x 136 result tile of the epilogue (68 KB)
// lives in the ring, which is free between product() and the next tile's
// product (a barrier ends each).  A narrow list takes 128 k 8 bytes: 2
// words a lane up to k 64 (136 KB in all), 4 words up to k 128 (200 KB,
// under the 227 KB a block may opt into).  The next layout, k 129 to 256,
// would take 256 KB for the lists alone, so K1's and K2's lists of k > 128
// take the route of knn_wide.cuh: survivors buffered as keys beside the
// ring, staged, sorted in the ring and merged into partial lists in device
// memory, bounded by the products and about k (1 + ln(C / k)) survivors a
// row over a split of C columns.  ptxas gives 254
// registers a thread and no spills (sm_90a): one block of 8 warps an SM,
// whose 64 independent chains a thread keep the FMA pipe busy.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "tile_common.cuh"

namespace regtile {

constexpr int TILE = 128;         // rows per block and columns per tile
constexpr int THREADS = 256;      // 16 x 16 threads
constexpr int WARPS = THREADS / 32;
constexpr int MICRO = 8;          // a thread's rows, and its columns
constexpr int SLAB = 32;          // features per stage
constexpr int LD = SLAB + 4;      // row stride of a staged slab (floats)
constexpr int RES_LD = TILE + 8;  // row stride of the result tile
constexpr int STAGE_FLOATS = 2 * TILE * LD;   // A rows, then B rows
constexpr int RING_FLOATS = 2 * STAGE_FLOATS;
constexpr int RES_FLOATS = TILE * RES_LD;
constexpr int MAX_NARROW = 128;   // longest list kept in shared memory
static_assert(RES_FLOATS <= RING_FLOATS, "the result tile lives in the ring");

// Words per lane of a list of k entries: 2 or 4 for a narrow list, 0 for a
// wide one, -1 when k is out of range.
inline int list_words(int k) {
  return k < 1 ? -1 : k <= 64 ? 2 : k <= MAX_NARROW ? 4 : 0;
}

// Dynamic shared memory of a block of K1 or K2 with lists of k.
inline size_t smem_bytes(int k) {
  const size_t lists =
      list_words(k) > 0 ? (size_t)TILE * k * (sizeof(float) + sizeof(int))
                        : 0;
  return (size_t)RING_FLOATS * sizeof(float) + lists;
}

// 16-byte (float) or 8-byte (bf16) loads need F % 4 == 0 and aligned rows.
template <class T>
inline bool can_vectorize(const void* p, int f) {
  return f % 4 == 0 &&
         reinterpret_cast<std::uintptr_t>(p) % (4 * sizeof(T)) == 0;
}

// Four consecutive features of one row, as loaded.
template <class T>
struct Quad {
  alignas(4 * sizeof(T)) T v[4];
};

template <class T>
__device__ __forceinline__ T zero_value();
template <>
__device__ __forceinline__ float zero_value<float>() {
  return 0.0f;
}
template <>
__device__ __forceinline__ __nv_bfloat16 zero_value<__nv_bfloat16>() {
  return __ushort_as_bfloat16((unsigned short)0);
}

// Features feat .. feat + 3 of row `row` of base [*, f]; zeros for a row
// at or past row_end and for features at or past f.
template <class T>
__device__ __forceinline__ void load_quad(const T* __restrict__ base,
                                          int row, int row_end, int feat,
                                          int f, bool vec, Quad<T>& q) {
  const bool row_ok = row < row_end;
  if (vec) {
    if (row_ok && feat < f) {
      const T* src = base + (size_t)row * f + feat;
      if constexpr (sizeof(T) == 4)
        *reinterpret_cast<float4*>(q.v) =
            __ldg(reinterpret_cast<const float4*>(src));
      else
        *reinterpret_cast<uint2*>(q.v) =
            __ldg(reinterpret_cast<const uint2*>(src));
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) q.v[e] = zero_value<T>();
    }
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      q.v[e] = (row_ok && feat + e < f) ? base[(size_t)row * f + feat + e]
                                        : zero_value<T>();
  }
}

// A thread's share of one stage: chunks tid + 256 p (p < PASSES) of the A
// and B slabs, chunk c being features 4 (c % CPR) .. 4 (c % CPR) + 3 of
// row c / CPR.
constexpr int CPR = SLAB / 4;                    // chunks a row
constexpr int PASSES = TILE * CPR / THREADS;     // chunks a thread
template <class T>
struct Stager {
  Quad<T> a[PASSES], b[PASSES];

  __device__ __forceinline__ void load(const T* __restrict__ pa, int a0,
                                       int a_end, const T* __restrict__ pb,
                                       int b0, int b_end, int f, int f0,
                                       bool vec) {
    const int feat = f0 + 4 * (threadIdx.x % CPR);
#pragma unroll
    for (int p = 0; p < PASSES; ++p) {
      const int row = threadIdx.x / CPR + (THREADS / CPR) * p;
      load_quad(pa, a0 + row, a_end, feat, f, vec, a[p]);
      load_quad(pb, b0 + row, b_end, feat, f, vec, b[p]);
    }
  }

  __device__ __forceinline__ void store(float* __restrict__ stage) const {
    const int part = 4 * (threadIdx.x % CPR);
#pragma unroll
    for (int p = 0; p < PASSES; ++p) {
      const int row = threadIdx.x / CPR + (THREADS / CPR) * p;
      *reinterpret_cast<float4*>(stage + row * LD + part) =
          make_float4(tile::to_float(a[p].v[0]), tile::to_float(a[p].v[1]),
                      tile::to_float(a[p].v[2]), tile::to_float(a[p].v[3]));
      *reinterpret_cast<float4*>(stage + (TILE + row) * LD + part) =
          make_float4(tile::to_float(b[p].v[0]), tile::to_float(b[p].v[1]),
                      tile::to_float(b[p].v[2]), tile::to_float(b[p].v[3]));
    }
  }
};

// Thread tid's place (tx, ty) in the 16 x 16 grid: warp w covers tx
// 8 (w % 2) .. + 7 and ty 4 (w / 2) .. + 3, so one shared-memory load of a
// warp touches 8 rows of B and 4 rows of A.
__device__ __forceinline__ int thread_x() {
  return ((threadIdx.x >> 5) & 1) * 8 + (threadIdx.x & 7);
}
__device__ __forceinline__ int thread_y() {
  return (threadIdx.x >> 6) * 4 + ((threadIdx.x >> 3) & 3);
}

// acc[i][j] advanced by the SLAB features of one staged slab, in
// ascending feature order for every element.
__device__ __forceinline__ void slab_product(const float* __restrict__ stage,
                                             int tx, int ty,
                                             float acc[MICRO][MICRO]) {
  const float* As = stage;
  const float* Bs = stage + TILE * LD;
#pragma unroll
  for (int kq = 0; kq < SLAB; kq += 4) {
    float4 a[MICRO];
#pragma unroll
    for (int i = 0; i < MICRO; ++i)
      a[i] = *reinterpret_cast<const float4*>(As + (ty + 16 * i) * LD + kq);
#pragma unroll
    for (int j = 0; j < MICRO; ++j) {
      const float4 b =
          *reinterpret_cast<const float4*>(Bs + (tx + 16 * j) * LD + kq);
#pragma unroll
      for (int i = 0; i < MICRO; ++i) {
        float c = acc[i][j];
        c = tile::dot_step(a[i].x, b.x, c);
        c = tile::dot_step(a[i].y, b.y, c);
        c = tile::dot_step(a[i].z, b.z, c);
        c = tile::dot_step(a[i].w, b.w, c);
        acc[i][j] = c;
      }
    }
  }
}

// acc[i][j] = sum_f A[a0 + ty + 16 i][f] * B[b0 + tx + 16 j][f] over all
// features, as one fmaf chain per element; T is float or bf16 (converted
// exactly).  Rows at or past a_end / b_end load as zeros.  `ring` is the
// block's RING_FLOATS of shared memory, free on entry; returns with every
// thread past its last read of it.
template <class T>
__device__ __forceinline__ void product(const T* __restrict__ a, int a0,
                                        int a_end, const T* __restrict__ b,
                                        int b0, int b_end, int f, bool vec,
                                        float* __restrict__ ring,
                                        float acc[MICRO][MICRO]) {
  const int tx = thread_x(), ty = thread_y();
#pragma unroll
  for (int i = 0; i < MICRO; ++i)
#pragma unroll
    for (int j = 0; j < MICRO; ++j) acc[i][j] = 0.0f;
  Stager<T> st;
  st.load(a, a0, a_end, b, b0, b_end, f, 0, vec);
  st.store(ring);
  __syncthreads();
  const int n_slabs = (f + SLAB - 1) / SLAB;
  for (int s = 0; s < n_slabs; ++s) {
    const bool more = s + 1 < n_slabs;
    // The next slab's loads are in flight during this slab's multiply;
    // its stage was last read before the previous barrier.
    if (more) st.load(a, a0, a_end, b, b0, b_end, f, (s + 1) * SLAB, vec);
    slab_product(ring + (s & 1) * STAGE_FLOATS, tx, ty, acc);
    if (more) st.store(ring + ((s + 1) & 1) * STAGE_FLOATS);
    __syncthreads();
  }
}

}  // namespace regtile
