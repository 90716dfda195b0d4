// K2: fused cosine + lambda-proximity scan with a running top-k.
//
// Replaces the TPU kernel pyarrowspace_tpu/ops/pallas/scan_topk.py
// `_scan_kernel` (driven by `_scan_pallas`, entered through
// `lambda_search_pallas`).  For every query q it keeps the k largest
//   score(q, i) = tau * (qn_q . xu_i) + (1 - tau) / (1 + |lam_i - lamq_q|)
// over the corpus, ties to the smallest id, with corpus ids >= n masked;
// rows come out descending by score.  A score enters a list only if it
// beats the empty slot (-3e38, -1): a NaN or a score at or below -3e38
// never does.  The corpus and queries are float32, or both bfloat16 (the
// as_serving view: the caller rounds the queries to bf16 as the JAX
// package does).  Both routes give the exact top-k of their own scores in
// (score desc, id asc) order.
//
// Two routes, picked by the wrapper (ops/cuda/scan_topk.py) from dtype, F
// and alignment alone, before any launch; a launch that fails raises, and
// neither route falls back to the other.
//
// The tensor-core route: bf16 rows and queries with F % 8 == 0 and
// 16-byte-aligned bases, the predicate K3 and K5 take
// (ops/cuda/subtile_max.py::tensor_core_route).  As the TPU kernel does on
// the MXU (a bf16 x bf16 dot_general with float32 sums,
// scan_topk.py:91-92), the products run on the bf16 tensor cores: wgmma
// m64n128k16 f32.bf16.bf16, the queries as A and the corpus rows as B,
// over features in ascending 64-feature stages, zero-padded past F, the
// first k step with scale-d 0 (K3's and K5's sequence, wgmma_tile.cuh).
// Every bf16 x bf16 product is exact in float32; the tensor core's sums
// differ from the fmaf chain's only in order and rounding, and equal K5's
// tensor-core sums bit for bit (compare.py::k5_blend).  The block is
// tc_scan.cuh's, K7's (two consumer warpgroups and a producer warp a
// 128-query block and corpus split, the corpus on a TMA ring, narrow or
// wide lists, the split merge), with BlendTc below as its epilogue: the
// float sum straight into tile::blend_fast (or tile::blend where a lambda
// lies outside the fast reciprocal's range), op by op as tile::blend
// rounds.  The queries stay resident in shared memory up to 640 features
// (96 KB at F 384: six ring stages, 128 narrow lists of 15 and the warps'
// buffers fit beside them, and the warpgroups take turns); past that they
// ride each ring slot beside the corpus stage (tc_scan.cuh's STREAM).
// What bounds it on the H100: the bf16 products, Q x N x F x 2 = 0.99
// TFLOP a batch of 4,096 queries over 313,841 x 384 (1.00 ms at 989
// TFLOP/s); beside them each score's epilogue (about 15 SIMT instructions)
// and the merges.
//
// The SIMT route: float32 rows, and bf16 rows the tensor-core route does not
// take (ragged F, unaligned bases); scan_narrow.cuh's kernel, shared with K8
// (scan_energy.cu), with BlendEpi below.  What bounds it: the products, Q x N x
// F x 2 = 0.99 TFLOP a batch of 4,096 queries over 313,841 x 384 in fp32
// outside the tensor cores (14.7 ms at 67 TFLOP/s).  Launch 1: one block per
// (128-query block, corpus split); the splits are contiguous ranges of 128-item
// tiles, and the caller picks the fewest whose grid fills its last wave of
// blocks to 90% or more (one block an SM runs at a time; at Q 4,096 on 132 SMs,
// 4 splits: one wave of 128 blocks).  A block runs the register-tiled fp32
// product of ffma_tile.cuh over its split's tiles in ascending order (float32
// rows: a TMA-fed ring, the next tile loading during this one's epilogue at k
// 15; bf16 rows and ragged float32 rows: the register-staged loader, bf16
// converted exactly when read), so every score is one float32 fmaf chain, and
// blends (tile::blend), masking ids >= n.  Then, by the length of the lists:
//   - k <= 128 (narrow): running lists in shared memory (2 or 4 words a
//     lane), merged 64 columns at a time, written to the partial lists [S,
//     Q, k]; launch 2 (tile::merge_splits) merges them in split order, one
//     warp a query, with the same insertion rule.
//   - k > 128 (wide): the route of knn_wide.cuh, K1's, with this epilogue
//     (BlendEpi) and the descending key: each tile's survivors buffered as
//     keys, staged in device memory, sorted and merged into the partial
//     lists in one pass, the splits sharing each query's best kth; launch 2
//     is its split merge.  On an H100 80GB HBM3 at 700 W (chip_smoke.py
//     phase 2): k 200 at Q 4,096 34.38 ms against k 15's 26.56; k 1,024 at
//     Q 1,024 19.96 ms.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "ffma_tile.cuh"
#include "knn_wide.cuh"
#include "scan_narrow.cuh"
#include "tc_scan.cuh"
#include "tile_common.cuh"
#include "wgmma_tile.cuh"

namespace {

// The SIMT route's epilogue: the blended score, ids >= n masked to -3e38.
// rows() keeps the thread's query lambdas in registers for the block's
// tiles; load() is knn_wide.cuh's per-tile entry.
struct BlendEpi {
  using Order = knn_wide::Desc;
  const float* lam;
  const float* lamq;
  float tau, omt;
  float lq[regtile::MICRO], lc[regtile::MICRO];
  size_t row_bytes() const { return 0; }
  __device__ __forceinline__ void rows(int q0, int q_end, char* = nullptr) {
    using namespace regtile;
    const int ty = thread_y();
#pragma unroll
    for (int i = 0; i < MICRO; ++i) {
      const int qi = q0 + ty + 16 * i;
      lq[i] = qi < q_end ? lamq[qi] : 0.0f;
    }
  }
  __device__ __forceinline__ void cols(int c0, int n) {
    using namespace regtile;
    const int tx = thread_x();
#pragma unroll
    for (int j = 0; j < MICRO; ++j) {
      const int col = c0 + tx + 16 * j;
      lc[j] = col < n ? lam[col] : 0.0f;
    }
  }
  __device__ __forceinline__ void load(int q0, int q_end, int c0, int n) {
    rows(q0, q_end);
    cols(c0, n);
  }
  __device__ __forceinline__ float value(float acc, int i, int j, int,
                                         int col, int n) const {
    const float s = tile::blend(tau, omt, acc, lc[j], lq[i]);
    return col >= n ? tile::NEG_SCORE : s;
  }
};

template <class T>
int launch(const void* xu, const float* lam, int n, int f, const void* qn,
           const float* lamq, int q, float tau, int k, int splits,
           void* part, float* out_s, int* out_i, int tma, int device,
           cudaStream_t st) {
  return narrow::launch<T>(static_cast<const T*>(qn),
                           static_cast<const T*>(xu),
                           BlendEpi{lam, lamq, tau, 1.0f - tau}, n, f, q, k,
                           splits, part, out_s, out_i, tma, device, st);
}

// The tensor-core route's epilogue on tc_scan.cuh's block: the float32
// sums of a thread's two query rows (r_a for sums i % 4 < 2, r_b
// otherwise) against its 32 items, blended in place.  cols: the lambdas in
// item pairs (lam_c, lam_c+1), [n_tiles * 64] float2, zeros past n.
struct BlendTc {
  const float2* __restrict__ cols;
  const float* __restrict__ lamq;
  float tau;

  struct Rows {
    float lq_a, lq_b, omt;
    bool lq_fast;
  };
  struct Cols {
    float2 cv[16];
  };

  __device__ __forceinline__ Rows rows(int qa, int qb, bool ok_a,
                                       bool ok_b) const {
    Rows r;
    r.lq_a = ok_a ? lamq[qa] : 0.0f;
    r.lq_b = ok_b ? lamq[qb] : 0.0f;
    r.lq_fast = fabsf(r.lq_a) < 0x1p62f && fabsf(r.lq_b) < 0x1p62f;
    r.omt = __fsub_rn(1.0f, tau);
    return r;
  }

  // Lambdas under 2^62 keep 1 + |lam_i - lam_q| below 2^64, the fast
  // reciprocal's range; otherwise the warp blends with tile::blend.
  __device__ __forceinline__ bool load(Cols& c, int col0,
                                       const Rows& r) const {
    bool lam_fast = r.lq_fast;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      c.cv[j] = __ldg(cols + (col0 >> 1) + 4 * j);
      lam_fast &= fabsf(c.cv[j].x) < 0x1p62f && fabsf(c.cv[j].y) < 0x1p62f;
    }
    return lam_fast;
  }

  // The blended scores in place; bit i of the result is set where the
  // score reaches its row's kth (and the item is < n, the row real).
  template <bool FAST>
  __device__ __forceinline__ unsigned long long score(
      float (&acc)[wg::Mma<__nv_bfloat16, tcscan::NB>::ACC], const Cols& c,
      const Rows& r, int col0, int n, float kth_a, float kth_b, bool ok_a,
      bool ok_b) const {
    unsigned long long bits = 0;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float lc = h ? c.cv[j].y : c.cv[j].x;
        const bool in = col0 + 8 * j + h < n;
        const int ia = 4 * j + h, ib = 4 * j + 2 + h;
        const float sa = FAST ? tile::blend_fast(tau, r.omt, acc[ia], lc,
                                                 r.lq_a)
                              : tile::blend(tau, r.omt, acc[ia], lc, r.lq_a);
        const float sb = FAST ? tile::blend_fast(tau, r.omt, acc[ib], lc,
                                                 r.lq_b)
                              : tile::blend(tau, r.omt, acc[ib], lc, r.lq_b);
        acc[ia] = sa;
        acc[ib] = sb;
        bits |= (unsigned long long)(in && ok_a && sa >= kth_a) << ia;
        bits |= (unsigned long long)(in && ok_b && sb >= kth_b) << ib;
      }
    }
    return bits;
  }
};

}  // namespace

extern "C" {

// The SIMT route: queries qn [q, f] (unit rows) with lambdas lamq [q]
// against the corpus xu [n, f] with lambdas lam [n] -> out_s / out_i [q,
// k].  xu and qn are both float (dtype 0) or both bf16 (dtype 1).  part is
// scratch of 8-byte words: [splits, q, k] for a narrow list (k <= 128);
// for a wide one [splits, q, k + knn_wide::STAGE] and q more.  With tma !=
// 0 the product's operands reach shared memory by TMA (float32 rows of a
// multiple of 16 bytes, 16-byte-aligned bases; refused for bf16), else by
// the register-staged loader.  Runs on the given device and stream.
// Returns the CUDA error code (0 on success).
int scan_topk_launch(const void* xu, int dtype, const float* lam, int n,
                     int f, const void* qn, const float* lamq, int q,
                     float tau, int k, int splits, void* part, float* out_s,
                     int* out_i, int tma, int device, void* stream) {
  if (n <= 0 || f <= 0 || q <= 0 || regtile::list_words(k) < 0 || k > n ||
      splits <= 0 || dtype < 0 || dtype > 1)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  auto fn = dtype == 1 ? &launch<__nv_bfloat16> : &launch<float>;
  return fn(xu, lam, n, f, qn, lamq, q, tau, k, splits, part, out_s, out_i,
            tma, device, st);
}

// The shared memory of a launch with lists of k (narrow, or the wide
// route) with the TMA loader (tma) or the register-staged one: out =
// {stages, carry, bytes}.  Returns 0, or 1 when nothing fits.
int scan_topk_plan(int k, int tma, int* out) {
  const regtile::Plan pl = regtile::list_words(k) == 0
                               ? knn_wide::scan_plan(tma != 0)
                               : narrow::plan(k, tma != 0, 0);
  out[0] = pl.stages;
  out[1] = pl.carry;
  out[2] = pl.bytes;
  return pl.stages == 0;
}

// The tensor-core route: bf16 rows xu [n, f] and queries qs [q, f] (f % 8
// == 0, 16-byte-aligned bases), the lambdas in item pairs cols [ceil(n /
// 128) * 64] float2 (zeros past n, 8-byte aligned) and lamq [q] -> out_s /
// out_i [q, k].  part is scratch of 8-byte words: [splits, q, k] for
// narrow lists; for wide ones (scan_topk_tc_plan) [splits, q, k + 512]
// and q more.  Runs on the given device and stream; returns the CUDA error
// code (0 on success).
int scan_topk_tc_launch(const void* xu, const void* cols, int n, int f,
                        const void* qs, const float* lamq, int q, float tau,
                        int k, int splits, void* part, float* out_s,
                        int* out_i, int device, void* stream) {
  if (n <= 0 || f <= 0 || q <= 0 || tile::list_words(k) < 0 || k > n ||
      splits <= 0 || reinterpret_cast<uintptr_t>(cols) % 8 != 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return tcscan::launch<__nv_bfloat16, true>(
      static_cast<const __nv_bfloat16*>(xu),
      static_cast<const __nv_bfloat16*>(qs),
      BlendTc{static_cast<const float2*>(cols), lamq, tau}, n, f, q, k,
      splits, part, out_s, out_i, (cudaStream_t)stream);
}

// The tensor-core route's plan at f features with lists of k: out = {wide,
// stream, stages, turns, bytes}.  Returns 0, or 1 when nothing fits.
int scan_topk_tc_plan(int f, int k, int* out) {
  const int nk = (f + wg::Mma<__nv_bfloat16>::KSTAGE - 1) /
                 wg::Mma<__nv_bfloat16>::KSTAGE;
  const tcscan::TcPlan p = tcscan::tc_plan(nk, k, true);
  out[0] = p.wide;
  out[1] = p.stream;
  out[2] = p.lay.stages;
  out[3] = p.lay.turns;
  out[4] = (int)p.lay.total;
  return p.lay.total > tcscan::SMEM_LIMIT;
}

const char* scan_topk_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
