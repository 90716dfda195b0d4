// K8: the energy scan with a running top-k, routed by a per-query bitmap.
//
// Serves search_energy / search_energy_batch (core/space.py) and
// ops/search.py's energy_topk_batch and energy_routed_topk_batch.  For
// every query q it keeps the k largest
//   D(q, i)  = max(e_q + e_i - 2 (qL_q . x_i), 0)
//   D'(q, i) = D / (D + max(tau*, 1e-10))
//   score    = w_l / (1 + |lam_i - lam_q|) + w_d / (1 + D')
// (energy_topk's formula, rounded op by op in the order of its PyTorch
// expression `w_l * (1 / (1 + |lam_i - lam_q|)) + w_d / (1 + D')`), with
// qL = q L_f the query's row of the feature Laplacian product, e the RAW
// energies x^T L_f x, over the items its route admits, ties to the
// smallest id; rows come out descending.  A score enters a list only if it
// beats the empty slot (-3e38, -1): a NaN never does, and a list short of
// k admitted items ends in (-3e38, -1).
//
// The route.  Each item carries one key (keys [n] int32): its centroid c
// in [0, K) when it sits in the centroid's bucket (its rank in the
// centroid is under the bucket cap), else K, the shared tail.  Each query
// carries a bitmap (bitmap [q, bm_bytes] uint8, bit c of byte c / 8 at
// c % 8) of the centroids its probed energy nodes came from, and the
// tail's bit K.  An item whose key's bit is clear scores nothing (it
// enters no list).  The admitted items are exactly the routed pool of the
// candidate-pool search (ops/search.py::energy_route builds the bitmap);
// an all-ones bitmap admits every item, and keys == nullptr skips the
// test: the exact energy scan.  One kernel serves both.
//
// The product and the lists are K2's SIMT route (scan_narrow.cuh, shared
// with scan_topk.cu): the register-tiled fp32 product of ffma_tile.cuh (a
// TMA-fed ring for float32 rows of a multiple of 16 bytes, else the
// register-staged loader), every cross term one float32 fmaf chain over
// the features in ascending order, no TF32: D cancels (e_q + e_i against
// 2 qL . x_i, each ~1e6 on the CVE corpus), so the product keeps
// float32's 24 bits; K2's split plan (scan_topk.py::plan_splits), narrow
// lists up to k 128 and knn_wide.cuh's past it.  EnergyEpi below is the
// epilogue.  On the narrow route a block stages its 128 queries' terms
// (lam_q, e_q) and bitmaps, as 64-bit words, in shared memory once, before
// its tiles (the product holds the registers: K2's kernel already uses
// 254), so a tile's route test reads one word a row where the bitmap has
// at most 64 keys; the wide route reads them from global memory each tile.
// What bounds it on the H100: the products, 2 Q N F fp32 multiply-adds (a
// batch of 10,000 queries over 313,841 x 384 is 2.41 TFLOP, 36.0 ms at 67
// TFLOP/s) whatever the route admits; beside them the epilogue's two IEEE
// divisions and a reciprocal (times in PERF.md's kernel table).

#include <cuda_runtime.h>

#include "scan_narrow.cuh"
#include "tile_common.cuh"

namespace {

// The energy score of one (query, item) pair from its cross term.  The
// proximity's reciprocal is tile::recip_rn, __fdiv_rn(1, x) bit for bit
// for x = 1 + |lam_i - lam_q| < 2^64 (taumode lambdas lie in [0, 1]; a NaN
// stays a NaN) without the division's branch to its slow path: 4.5% of
// K8's time at the CVE shape (PERF.md).
__device__ __forceinline__ float energy_score(float cross, float lam_i,
                                              float e_i, float lam_q,
                                              float e_q, float ts, float wl,
                                              float wd) {
  float d = __fsub_rn(__fadd_rn(e_q, e_i), __fmul_rn(2.0f, cross));
  d = d < 0.0f ? 0.0f : d;   // clamp_min(d, 0): a NaN stays a NaN
  const float db = __fdiv_rn(d, __fadd_rn(d, ts));
  const float prox =
      tile::recip_rn(__fadd_rn(1.0f, fabsf(__fsub_rn(lam_i, lam_q))));
  return __fadd_rn(__fmul_rn(wl, prox), __fdiv_rn(wd, __fadd_rn(1.0f, db)));
}

// The epilogue of both routes: a thread's 8 x 8 cross terms into scores,
// items past n and items outside the query's route masked to -3e38.
// pass: bit 8 i + j set where row i admits item j.
struct EnergyEpi {
  using Order = knn_wide::Desc;
  const float* __restrict__ lam;
  const float* __restrict__ e;
  const int* __restrict__ keys;            // nullptr: every item
  const float* __restrict__ lamq;
  const float* __restrict__ eq;
  const unsigned char* __restrict__ bitmap;
  const float* __restrict__ tau_star;      // 0-dim, on the device
  int bm_bytes;
  float wl, wd;
  float ts;
  const float2* qt;                   // narrow: the block's (lam_q, e_q)
  const unsigned long long* words;    // narrow: its bitmaps, n_words a row
  float lq[regtile::MICRO], eqv[regtile::MICRO];
  float lc[regtile::MICRO], ec[regtile::MICRO];
  unsigned long long pass;

  __host__ __device__ int n_words() const {
    return keys ? (bm_bytes + 7) / 8 : 0;
  }

  size_t row_bytes() const { return sizeof(float2) + 8 * n_words(); }

  // The narrow route, once a block: tau*, and each query row's terms and
  // bitmap words into smem (threads 0..127, a row each).
  __device__ __forceinline__ void rows(int q0, int q_end, char* smem) {
    ts = fmaxf(__ldg(tau_star), 1e-10f);
    float2* t = reinterpret_cast<float2*>(smem);
    unsigned long long* w =
        reinterpret_cast<unsigned long long*>(t + regtile::TILE);
    const int nw = n_words();
    const int r = threadIdx.x;
    if (r < regtile::TILE) {
      const int qi = q0 + r;
      const bool ok = qi < q_end;
      t[r] = make_float2(ok ? __ldg(lamq + qi) : 0.0f,
                         ok ? __ldg(eq + qi) : 0.0f);
      const unsigned char* row = bitmap + (size_t)qi * bm_bytes;
      for (int wi = 0; wi < nw; ++wi) {
        unsigned long long v = 0;
        for (int b = 0; ok && b < 8 && 8 * wi + b < bm_bytes; ++b)
          v |= (unsigned long long)__ldg(row + 8 * wi + b) << (8 * b);
        w[r * nw + wi] = v;
      }
    }
    qt = t;
    words = w;
  }

  // A tile's item terms and route keys (key 0 past n or without keys).
  __device__ __forceinline__ void items(int c0, int n,
                                        int (&key)[regtile::MICRO]) {
    const int tx = regtile::thread_x();
#pragma unroll
    for (int j = 0; j < regtile::MICRO; ++j) {
      const int col = c0 + tx + 16 * j;
      const bool in = col < n;
      lc[j] = in ? __ldg(lam + col) : 0.0f;
      ec[j] = in ? __ldg(e + col) : 0.0f;
      key[j] = in && keys ? __ldg(keys + col) : 0;
    }
  }

  // The narrow route, each tile: the query terms and bitmap words from
  // shared memory.
  __device__ __forceinline__ void cols(int c0, int n) {
    using namespace regtile;
    const int ty = thread_y();
    int key[MICRO];
    items(c0, n, key);
#pragma unroll
    for (int i = 0; i < MICRO; ++i) {
      const float2 t = qt[ty + 16 * i];
      lq[i] = t.x;
      eqv[i] = t.y;
    }
    const int nw = n_words();
    pass = keys ? 0ull : ~0ull;
    if (nw == 1) {
#pragma unroll
      for (int i = 0; i < MICRO; ++i) {
        const unsigned long long w = words[ty + 16 * i];
#pragma unroll
        for (int j = 0; j < MICRO; ++j)
          pass |= ((w >> key[j]) & 1ull) << (MICRO * i + j);
      }
    } else if (nw > 1) {
#pragma unroll
      for (int i = 0; i < MICRO; ++i) {
        const unsigned long long* w = words + (ty + 16 * i) * nw;
#pragma unroll
        for (int j = 0; j < MICRO; ++j)
          pass |= ((w[key[j] >> 6] >> (key[j] & 63)) & 1ull)
                  << (MICRO * i + j);
      }
    }
  }

  // knn_wide.cuh's route, each tile: every term from global memory.
  __device__ __forceinline__ void load(int q0, int q_end, int c0, int n) {
    using namespace regtile;
    const int ty = thread_y();
    ts = fmaxf(__ldg(tau_star), 1e-10f);
    int key[MICRO];
    items(c0, n, key);
    pass = keys ? 0ull : ~0ull;
#pragma unroll
    for (int i = 0; i < MICRO; ++i) {
      const int qi = q0 + ty + 16 * i;
      const bool ok = qi < q_end;
      lq[i] = ok ? __ldg(lamq + qi) : 0.0f;
      eqv[i] = ok ? __ldg(eq + qi) : 0.0f;
      if (keys && ok) {
        const unsigned char* row = bitmap + (size_t)qi * bm_bytes;
#pragma unroll
        for (int j = 0; j < MICRO; ++j)
          pass |= (unsigned long long)((__ldg(row + (key[j] >> 3)) >>
                                        (key[j] & 7)) & 1u)
                  << (MICRO * i + j);
      }
    }
  }

  __device__ __forceinline__ float value(float acc, int i, int j, int,
                                         int col, int n) const {
    if (col >= n || !((pass >> (regtile::MICRO * i + j)) & 1ull))
      return tile::NEG_SCORE;
    return energy_score(acc, lc[j], ec[j], lq[i], eqv[i], ts, wl, wd);
  }
};

}  // namespace

extern "C" {

// Queries' rows of the feature Laplacian product ql [q, f] with their
// lambdas lamq [q] and RAW energies eq [q], against the float32 corpus x
// [n, f] with lambdas lam [n] and RAW energies e [n] -> out_s / out_i [q,
// k].  keys [n] and bitmap [q, bm_bytes] route each query (keys nullptr:
// every item); tau_star points to tau* on the device.  part is scratch of
// 8-byte words: [splits, q, k] for a narrow list (k <= 128); for a wide
// one [splits, q, k + knn_wide::STAGE] and q more.  With tma != 0 the
// product's operands reach shared memory by TMA (rows of a multiple of 16
// bytes, 16-byte-aligned bases), else by the register-staged loader.  Runs
// on the given device and stream.  Returns the CUDA error code (0 on
// success).
int scan_energy_launch(const float* x, const float* lam, const float* e,
                       const int* keys, int n, int f, const float* ql,
                       const float* lamq, const float* eq,
                       const unsigned char* bitmap, int bm_bytes, int q,
                       const float* tau_star, float wl, float wd, int k,
                       int splits, void* part, float* out_s, int* out_i,
                       int tma, int device, void* stream) {
  if (n <= 0 || f <= 0 || q <= 0 || regtile::list_words(k) < 0 || k > n ||
      splits <= 0 || (keys && (bitmap == nullptr || bm_bytes <= 0)))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  EnergyEpi epi{};
  epi.lam = lam;
  epi.e = e;
  epi.keys = keys;
  epi.lamq = lamq;
  epi.eq = eq;
  epi.bitmap = bitmap;
  epi.tau_star = tau_star;
  epi.bm_bytes = bm_bytes;
  epi.wl = wl;
  epi.wd = wd;
  return narrow::launch<float>(ql, x, epi, n, f, q, k, splits, part, out_s,
                               out_i, tma, device, (cudaStream_t)stream);
}

const char* scan_energy_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
