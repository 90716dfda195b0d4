// K6: the blocked-IVF probe scan of ivf_block and certified serving.
//
// Replaces the TPU kernel pyarrowspace_tpu/ops/pallas/ivf_scan.py:231
// `_ivf_kernel` (driven by `_ivf_scan`, called from `_route_scan_core`).
// The corpus lies cluster-contiguous in slabs of `cap` rows; queries are
// sorted by their top centroid and cut into blocks of qb, and each block
// has its own n_probe probed clusters (a probe table [n_blocks, n_probe]).
// For every query q of block b it keeps the k best
//   score(q, i) = tau * (qn_q . slab_i) + (1 - tau) / (1 + |lam_i - lamq_q|)
// over the rows i of the block's probed slabs, rows with id < 0 (slab
// padding) scored -3e38, in lexicographic (score desc, id asc) order;
// unfilled slots stay (-3e38, -1), as the TPU kernel leaves them.
//
// Precision is part of the contract: the certificates of certified serving
// assume the scan scores are f32 products of f32 queries and exactly
// upcast slab rows (ivf_scan.py:494-499 and 585-603).  Slabs of bf16 or
// f16 are converted to float on load, queries stay f32, and each output is
// one fmaf chain over features in ascending order (tile::dot_step), then
// tile::blend: no TF32 or bf16 tensor cores here.
//
// What bounds it on the H100: the fp32 FMA pipe (67 TFLOP/s; no tensor-core
// format keeps the bits the certificates assume) over the rows that hold
// an item.  The slab layout pads every cluster to cap rows (about half of
// every slab), and a padded row scores -3e38 with id -1, so it never
// displaces an unfilled slot (-3e38, -1): the kernel walks only the 64-row
// tiles up to each probed cluster's last real row (the per-cluster tile
// counts `tiles`, ops/cuda/ivf_scan.py::slab_tiles), which changes no
// output.  At 313,841 x 384, 4,096 queries x 8 probes that is about 45
// GFLOP (0.7 ms at the fp32 rate) against 90 at cap, and the probed
// tiles' bytes, read once, about a fifth of that time; on the 1M x 768
// mixture (16,384 queries, f32 slabs) the bytes bound it (1.0 ms).
//
// The design: one block of 256 threads per query block (qb <= 32), which
// carries its running lists across its probes (the TPU's sequential probe
// axis and its scalar prefetch become a walk over the block's own probe
// row).  The block's real tiles, probe by probe, are taken 4 at a time: a
// step of 256 slab rows.  Per step the product is register-tiled as in
// ffma_tile.cuh: warp w owns rows 32 w .. 32 w + 31 of the step, lane
// (r, g) = (lane % 8, lane / 8) rows 32 w + r + 8 j (j < 4) and queries g
// + 4 i (i < qb_pad / 4); per 4 features a thread loads its 4 rows and
// its qb_pad / 4 queries as 16-byte LDS.128 (the 8 rows of a load are 36
// floats apart, so conflict-free; a query load is a broadcast), 8 loads
// for 64 multiply-adds at qb 16.  Slab rows and the query block are staged
// together a 32-feature slab at a time (so any F fits) in a two-stage ring
// fed by register prefetch (16-byte loads where rows are 16-byte aligned),
// converted to float on the way (bf16 and f16 exactly), one barrier a
// slab; the next step's first slab is in flight under this step's last.
// Each score is one fmaf chain over features 0..F-1 in ascending order
// (tile::dot_step; the zero features past F leave it as it is, as in
// ffma_tile.cuh), then tile::blend: the first version's bits.  The step's
// scores go to a shared [qb][256] tile with their ids.  Lists of k <= 256
// live in shared memory: one warp per query merges the tile into its list
// 64 at a time (tile::merge_row: a ballot against the list's kth, then only
// the improving scores are offered), MaxLex: slab ids arrive in slab
// order, not ascending.
//
// Longer lists (the rescored certificate's pool doubles with every
// widening round: topk 65 scans a pool of 260) take knn_wide.cuh's staged,
// sorted merge, in the output rows, which start as empty entries.  Each
// query keeps a filter, its list's kth as of its last merge (WideRow, in
// shared memory after the score tile), the strict MaxLex compare, so the
// empty entry, a padding row and a NaN score never pass it.  Per step the
// query's warp ballots its 256 scores against the filter and writes each
// survivor, as a descending key, onto the query's staging row of SROW (512)
// keys in device memory (the wrapper allocates the rows); a staging row
// that could not take the next step's 256 rows is sorted and merged into
// the list in one pass (knn_wide::flush_row on an OutList of stride 1),
// which gives the new kth; what is left at the end of the walk too.  The
// sort scratch (a warp's 4 KB, 32 KB a block) lies in the ring's stage that
// holds no slab during the merges, so the route adds no shared memory
// beside the rows' state (2 blocks an SM at qb 16, as the narrow route);
// the price is one more block barrier a step, before the next step's
// first slab is stored there.  A query merges about (its survivors) / 256
// to / 384 times.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include "knn_wide.cuh"
#include "tile_common.cuh"

namespace {

using knn_wide::Desc;
using knn_wide::OutList;
using knn_wide::SROW;
using knn_wide::WideRow;

constexpr float NEG_INF = -3.0e38f;
constexpr int THREADS = tile::THREADS;         // 256
constexpr int TILE = tile::TILE;               // 64 slab rows
constexpr int STEP_TILES = 4;
constexpr int STEP = STEP_TILES * TILE;        // 256 rows a step
constexpr int SLAB = 32;                       // features a stage
constexpr int LD = SLAB + 4;                   // row stride of a stage
constexpr int CPR = SLAB / 4;                  // 16-byte chunks a row
constexpr int ROW_CHUNKS = STEP * CPR / THREADS;   // 8 a thread
constexpr int SLD = STEP + 8;                  // row stride of the score tile
constexpr int MAX_QB = 32;
constexpr size_t SMEM_LIMIT = 232448;          // a block's most, sm_90
static_assert((STEP + 8) * LD * sizeof(float) >=
                  tile::WARPS * SROW * sizeof(uint64_t),
              "a block's sort scratch fits one stage of the ring");

// Four consecutive features of one row.
template <class T>
struct Quad {
  alignas(4 * sizeof(T)) T v[4];
};

template <class T>
__device__ __forceinline__ T zero_value() {
  return T(0.0f);
}
template <>
__device__ __forceinline__ __nv_bfloat16 zero_value<__nv_bfloat16>() {
  return __ushort_as_bfloat16((unsigned short)0);
}
template <>
__device__ __forceinline__ __half zero_value<__half>() {
  return __ushort_as_half((unsigned short)0);
}

// Features feat .. feat + 3 of the row at src (the row's feature 0), zeros
// when !ok or past f.  VEC: one 16-byte (float) or 8-byte (bf16, f16) load.
template <class T, bool VEC>
__device__ __forceinline__ void load_quad(const T* __restrict__ src, bool ok,
                                          int feat, int f, Quad<T>& q) {
  if (VEC && ok && feat < f) {
    if constexpr (sizeof(T) == 4)
      *reinterpret_cast<float4*>(q.v) =
          __ldg(reinterpret_cast<const float4*>(src + feat));
    else
      *reinterpret_cast<uint2*>(q.v) =
          __ldg(reinterpret_cast<const uint2*>(src + feat));
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      q.v[e] = (ok && feat + e < f) ? src[feat + e] : zero_value<T>();
  }
}

// The block's walk over its real tiles: tile t of probe p next; `tiles`
// of the current probe's cluster.  Every thread keeps the same cursor.
struct Cursor {
  int p, t, tiles;
};

// The first row of the cursor's next tile, or -1 when the walk is done.
__device__ __forceinline__ int next_tile(Cursor& c, const int* probe_row,
                                         const int* __restrict__ tiles,
                                         int n_probe, int cap) {
  while (c.p < n_probe && c.t >= c.tiles) {
    ++c.p;
    c.t = 0;
    c.tiles = c.p < n_probe ? tiles[probe_row[c.p]] : 0;
  }
  if (c.p >= n_probe) return -1;
  return probe_row[c.p] * cap + TILE * c.t++;
}

// A thread's share of one stage: 8 chunks of the step's slab rows and, for
// the first QT * CPR threads, one chunk of the query block.
template <class T, int QT, bool VEC>
struct Stager {
  Quad<T> r[ROW_CHUNKS];
  Quad<float> q;

  __device__ __forceinline__ void load(const T* __restrict__ slabs,
                                       const int (&base)[STEP_TILES],
                                       const float* __restrict__ qn,
                                       size_t q0, int qb, int f, int f0) {
    const int tid = threadIdx.x;
    const int feat = f0 + 4 * (tid % CPR);
#pragma unroll
    for (int p = 0; p < ROW_CHUNKS; ++p) {
      const int row = tid / CPR + (THREADS / CPR) * p;   // of the step
      const int b = base[row / TILE];
      load_quad<T, VEC>(slabs + (size_t)(b < 0 ? 0 : b + row % TILE) * f,
                        b >= 0, feat, f, r[p]);
    }
    if (tid < QT * CPR) {
      const int qr = tid / CPR;
      load_quad<float, VEC>(qn + (q0 + (qr < qb ? qr : 0)) * f, qr < qb,
                             feat, f, q);
    }
  }

  __device__ __forceinline__ void store(float* __restrict__ stage) const {
    const int tid = threadIdx.x;
    const int part = 4 * (tid % CPR);
#pragma unroll
    for (int p = 0; p < ROW_CHUNKS; ++p) {
      const int row = tid / CPR + (THREADS / CPR) * p;
      *reinterpret_cast<float4*>(stage + row * LD + part) =
          make_float4(tile::to_float(r[p].v[0]), tile::to_float(r[p].v[1]),
                      tile::to_float(r[p].v[2]), tile::to_float(r[p].v[3]));
    }
    if (tid < QT * CPR)
      *reinterpret_cast<float4*>(stage + (STEP + tid / CPR) * LD + part) =
          make_float4(q.v[0], q.v[1], q.v[2], q.v[3]);
  }
};

// acc[i][j] advanced by the SLAB features of a staged slab: query g + 4 i
// of the stage's query rows against row 32 w + r + 8 j of its slab rows,
// features in ascending order.
template <int QPT>
__device__ __forceinline__ void slab_product(const float* __restrict__ stage,
                                             int row0, int g,
                                             float (&acc)[QPT][4]) {
  const float* rs = stage + row0 * LD;
  const float* qs = stage + (STEP + g) * LD;
#pragma unroll
  for (int kq = 0; kq < SLAB; kq += 4) {
    float4 x[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      x[j] = *reinterpret_cast<const float4*>(rs + 8 * j * LD + kq);
#pragma unroll
    for (int i = 0; i < QPT; ++i) {
      const float4 a = *reinterpret_cast<const float4*>(qs + 4 * i * LD + kq);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float c = acc[i][j];
        c = tile::dot_step(a.x, x[j].x, c);
        c = tile::dot_step(a.y, x[j].y, c);
        c = tile::dot_step(a.z, x[j].z, c);
        c = tile::dot_step(a.w, x[j].w, c);
        acc[i][j] = c;
      }
    }
  }
}

// Merge a query's w.staged keys (keys) into its list (out_s / out_i, k
// entries), sorted in the warp's scratch in 256 or 512 keys, whichever
// holds them: a staging row is merged once it holds more than 256 keys, or
// at the end of the walk, and each sort width compiled into each of the
// route's 18 kernels adds to the library's build time.  (On an H100 a 128
// floor was no faster and a 512 one 20% slower at pools 260 and 1,040.)
// Called by all 32 lanes of one warp.
__device__ __forceinline__ void flush(const uint64_t* keys, uint64_t* scratch,
                                      float* out_s, int* out_i, int k,
                                      WideRow& w, int lane) {
  knn_wide::flush_row<256>(keys, scratch, OutList{out_s, out_i, 1}, k, w,
                           nullptr, lane);
}

// QT: the query block padded to a multiple of 4 (8, 16 or 32); W: the
// words a lane of a narrow list (2, 4, 8), or 0 for wide lists, whose
// queries stage their keys in stage_rows [n_blocks * qb, SROW] and count
// their merges into merges (when not null).
template <class T, int QT, int W, bool VEC>
__global__ void __launch_bounds__(THREADS, QT > 16 ? 1 : 2)
    ivf_kernel(const T* __restrict__ slabs, const float* __restrict__ slab_lam,
               const int* __restrict__ slab_ids,
               const int* __restrict__ tiles, int f, int cap,
               const float* __restrict__ qn, const float* __restrict__ lamq,
               const int* __restrict__ probe, int n_probe, int qb, float tau,
               int k, float* out_s, int* out_i, uint64_t* stage_rows,
               int* merges) {
  constexpr int QPT = QT / 4;
  constexpr int STAGE_FLOATS = (STEP + QT) * LD;
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;                                  // 2 stages
  float* Ss = ring + 2 * STAGE_FLOATS;                 // [QT][SLD]
  int* Is = reinterpret_cast<int*>(Ss + QT * SLD);     // [STEP]
  float* lists = reinterpret_cast<float*>(Is + STEP);  // [qb][k] x 2
  WideRow* rows = reinterpret_cast<WideRow*>(Is + STEP);   // or [QT]
  int* merged = reinterpret_cast<int*>(rows + QT);         // and [QT]

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int r = lane & 7, g = lane >> 3;
  const int row0 = 32 * warp + r;                      // j = 0's step row
  const size_t q0 = (size_t)blockIdx.x * qb;
  const int* my_probe = probe + (size_t)blockIdx.x * n_probe;

  float lq[QPT];
#pragma unroll
  for (int i = 0; i < QPT; ++i)
    lq[i] = g + 4 * i < qb ? lamq[q0 + g + 4 * i] : 0.0f;
  float* run_s = lists;
  int* run_i = reinterpret_cast<int*>(lists + (size_t)qb * k);
  if constexpr (W == 0) {
    knn_wide::wide_start(OutList{out_s + q0 * k, out_i + q0 * k, 1}, qb, k,
                         rows, qb, tid, THREADS);
    for (int qq = tid; qq < qb; qq += THREADS) merged[qq] = 0;
  } else {
    for (int e = tid; e < qb * k; e += THREADS) {
      run_s[e] = NEG_INF;
      run_i[e] = -1;
    }
  }
  const float omt = 1.0f - tau;

  Cursor cur{0, 0, n_probe > 0 ? tiles[my_probe[0]] : 0};
  int base[STEP_TILES], next[STEP_TILES];
#pragma unroll
  for (int t = 0; t < STEP_TILES; ++t)
    base[t] = next_tile(cur, my_probe, tiles, n_probe, cap);
  const int n_slabs = (f + SLAB - 1) / SLAB;
  Stager<T, QT, VEC> st;
  if (base[0] >= 0) {
    st.load(slabs, base, qn, q0, qb, f, 0);
    st.store(ring);
  }
  __syncthreads();

  int stage = 0;
  while (base[0] >= 0) {
#pragma unroll
    for (int t = 0; t < STEP_TILES; ++t)
      next[t] = next_tile(cur, my_probe, tiles, n_probe, cap);
    float acc[QPT][4];
#pragma unroll
    for (int i = 0; i < QPT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
    for (int s = 0; s < n_slabs; ++s) {
      // The next slab (of this step, or the next step's first) is in
      // flight during this slab's multiply; its stage was last read before
      // the previous barrier.
      const bool more = s + 1 < n_slabs || next[0] >= 0;
      if (more) {
        if (s + 1 < n_slabs)
          st.load(slabs, base, qn, q0, qb, f, (s + 1) * SLAB);
        else
          st.load(slabs, next, qn, q0, qb, f, 0);
      }
      slab_product<QPT>(ring + stage * STAGE_FLOATS, row0, g, acc);
      if (more) st.store(ring + (stage ^ 1) * STAGE_FLOATS);
      __syncthreads();
      stage ^= 1;
    }

    // Blend and mask this thread's 4 rows x QPT queries into the score
    // tile; the rows of tile warp / 2 (or none past the walk's end).
    const int b = base[warp >> 1];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int srow = row0 + 8 * j;
      const size_t row = (size_t)(b < 0 ? 0 : b) + srow % TILE;
      const int id = b < 0 ? -1 : slab_ids[row];
      const float lam = b < 0 ? 0.0f : slab_lam[row];
      if (g == 0) Is[srow] = id;
#pragma unroll
      for (int i = 0; i < QPT; ++i)
        Ss[(g + 4 * i) * SLD + srow] =
            id < 0 ? NEG_INF : tile::blend(tau, omt, acc[i][j], lam, lq[i]);
    }
    __syncthreads();
    if constexpr (W == 0) {
      // Stage each query's survivors; a staging row that could not take
      // the next step's rows is merged, sorted in the ring's stage that
      // holds no slab (stage ^ 1: its slab was consumed before the last
      // barrier, and the next step stores there after its first product).
      uint64_t* scratch =
          reinterpret_cast<uint64_t*>(ring + (stage ^ 1) * STAGE_FLOATS) +
          warp * SROW;
      const unsigned below = (1u << lane) - 1u;
      for (int qq = warp; qq < qb; qq += tile::WARPS) {
        WideRow& w = rows[qq];
        const float tv = w.thr_v;
        const int ti = w.thr_i;
        uint64_t* keys = stage_rows + (q0 + qq) * SROW;
        const float* srow = Ss + qq * SLD;
        int n = w.staged;
#pragma unroll
        for (int c = 0; c < STEP / 32; ++c) {
          const float v = srow[lane + 32 * c];
          const int id = Is[lane + 32 * c];
          const bool pass = tile::MaxLex::better(v, id, tv, ti);
          const unsigned m = __ballot_sync(tile::FULL, pass);
          if (pass) keys[n + __popc(m & below)] = Desc::key(v, id);
          n += __popc(m);
        }
        __syncwarp();
        if (lane == 0) w.staged = n;
        __syncwarp();
        if (n > SROW - STEP) {
          flush(keys, scratch, out_s + (q0 + qq) * k, out_i + (q0 + qq) * k,
                k, w, lane);
          if (lane == 0) ++merged[qq];
        }
      }
      __syncthreads();
    } else {
      for (int qq = warp; qq < qb; qq += tile::WARPS)
#pragma unroll
        for (int c = 0; c < STEP_TILES; ++c)
          tile::merge_row<tile::MaxLex, W>(
              Ss + qq * SLD + c * TILE, 0, run_s + (size_t)qq * k,
              run_i + (size_t)qq * k, k, lane, Is + c * TILE);
    }
    // The next write of Ss and Is comes after at least one barrier of the
    // next step's slabs.
#pragma unroll
    for (int t = 0; t < STEP_TILES; ++t) base[t] = next[t];
  }

  if constexpr (W == 0) {
    // What is left staged; the ring is free (the last step's barrier, or
    // no step at all: the barrier before the walk).
    uint64_t* scratch = reinterpret_cast<uint64_t*>(ring) + warp * SROW;
    for (int qq = warp; qq < qb; qq += tile::WARPS) {
      if (rows[qq].staged > 0) {
        flush(stage_rows + (q0 + qq) * SROW, scratch, out_s + (q0 + qq) * k,
              out_i + (q0 + qq) * k, k, rows[qq], lane);
        if (lane == 0) ++merged[qq];
      }
      if (merges && lane == 0) merges[q0 + qq] = merged[qq];
    }
  } else {
    __syncthreads();
    for (int e = tid; e < qb * k; e += THREADS) {
      out_s[q0 * k + e] = run_s[e];
      out_i[q0 * k + e] = run_i[e];
    }
  }
}

// Shared memory of a block besides its lists: the ring, the score tile and
// its ids.
constexpr size_t fixed_smem(int qt) {
  return sizeof(float) * (2 * (size_t)(STEP + qt) * LD + (size_t)qt * SLD) +
         sizeof(int) * STEP;
}
static_assert(fixed_smem(MAX_QB) + (size_t)MAX_QB * tile::MAX_NARROW *
                                       (sizeof(float) + sizeof(int)) <=
                  SMEM_LIMIT,
              "narrow lists fit beside the stages at every qb");

// Whether lists of k take the wide route: past 256 (narrow lists fit at
// every qb, above).
bool lists_wide(int k) { return tile::list_words(k) == 0; }

// The kernel of a launch and its shared memory.
template <class T, int QT, bool VEC>
auto pick(int qb, int k, size_t* smem) {
  const bool wide = lists_wide(k);
  const int words = wide ? 0 : tile::list_words(k);
  *smem = fixed_smem(QT) +
          (wide ? QT * (sizeof(WideRow) + sizeof(int))
                : (size_t)qb * k * (sizeof(float) + sizeof(int)));
  return words == 2   ? &ivf_kernel<T, QT, 2, VEC>
         : words == 4 ? &ivf_kernel<T, QT, 4, VEC>
         : words == 8 ? &ivf_kernel<T, QT, 8, VEC>
                      : &ivf_kernel<T, QT, 0, VEC>;
}

template <class T, int QT, bool VEC>
int launch_t(const void* slabs, const float* slab_lam, const int* slab_ids,
             const int* tiles, int f, int cap, const float* qn,
             const float* lamq, const int* probe, int n_blocks, int n_probe,
             int qb, float tau, int k, float* out_s, int* out_i,
             uint64_t* stage_rows, int* merges, cudaStream_t st) {
  if (lists_wide(k) && stage_rows == nullptr)
    return (int)cudaErrorInvalidValue;
  size_t smem = 0;
  auto kernel = pick<T, QT, VEC>(qb, k, &smem);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<n_blocks, THREADS, smem, st>>>(
      static_cast<const T*>(slabs), slab_lam, slab_ids, tiles, f, cap, qn,
      lamq, probe, n_probe, qb, tau, k, out_s, out_i, stage_rows, merges);
  return (int)cudaGetLastError();
}

// Resident blocks an SM of the (vectorized) kernel of lists of k for
// blocks of qb, or a negated CUDA error code.
template <class T>
int blocks_per_sm(int qb, int k) {
  size_t smem = 0;
  auto kernel = qb <= 8    ? pick<T, 8, true>(qb, k, &smem)
                : qb <= 16 ? pick<T, 16, true>(qb, k, &smem)
                           : pick<T, 32, true>(qb, k, &smem);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int n = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, THREADS,
                                                        smem);
  return err == cudaSuccess ? n : -(int)err;
}

// VEC: 16-byte (float) or 8-byte (bf16, f16) loads of four features, for
// F % 4 == 0 with slab rows and query rows so aligned; else one value a
// load.
template <class T, int QT>
int launch_q(const void* slabs, const float* slab_lam, const int* slab_ids,
             const int* tiles, int f, int cap, const float* qn,
             const float* lamq, const int* probe, int n_blocks, int n_probe,
             int qb, float tau, int k, float* out_s, int* out_i,
             uint64_t* stage_rows, int* merges, cudaStream_t st) {
  const bool vec =
      f % 4 == 0 &&
      reinterpret_cast<std::uintptr_t>(slabs) % (4 * sizeof(T)) == 0 &&
      reinterpret_cast<std::uintptr_t>(qn) % 16 == 0;
  auto fn = vec ? &launch_t<T, QT, true> : &launch_t<T, QT, false>;
  return fn(slabs, slab_lam, slab_ids, tiles, f, cap, qn, lamq, probe,
            n_blocks, n_probe, qb, tau, k, out_s, out_i, stage_rows, merges,
            st);
}

template <class T>
int launch(const void* slabs, const float* slab_lam, const int* slab_ids,
           const int* tiles, int f, int cap, const float* qn,
           const float* lamq, const int* probe, int n_blocks, int n_probe,
           int qb, float tau, int k, float* out_s, int* out_i,
           uint64_t* stage_rows, int* merges, cudaStream_t st) {
  auto fn = qb <= 8    ? &launch_q<T, 8>
            : qb <= 16 ? &launch_q<T, 16>
                       : &launch_q<T, 32>;
  return fn(slabs, slab_lam, slab_ids, tiles, f, cap, qn, lamq, probe,
            n_blocks, n_probe, qb, tau, k, out_s, out_i, stage_rows, merges,
            st);
}

}  // namespace

extern "C" {

// Slabs [n_clusters * cap, f] (dtype 0 float, 1 bf16, 2 f16) with their
// lambdas and ids [n_clusters * cap] and each cluster's count of 64-row
// tiles up to its last real row, tiles [n_clusters] (every real row of
// cluster c lies in its first tiles[c] tiles), queries qn [n_blocks * qb,
// f] and lamq [n_blocks * qb] (float), the probe table [n_blocks, n_probe]
// -> out_s / out_i [n_blocks * qb, k].  Each probe lies in [0,
// n_clusters), and a block's probes are distinct clusters, as the routing
// makes them (each block's n_probe best): then every id of a block's walk
// is distinct.  A repeated probe walks its cluster again, and its rows
// enter a list once for each time they are probed (the plain version's
// lists, on both routes: the wide route's merge places a list entry
// before an equal staged key).  cap is a multiple of 64, qb <= 32, k >= 1.
// When k > 256 (the wide route), stage_rows is [n_blocks * qb, 512] 8-byte
// words of scratch, and merges (null for none) [n_blocks * qb] receives
// each query's count of merges.  Runs on the given device and stream;
// returns the CUDA error code (0 on success).
int ivf_scan_launch(const void* slabs, int dtype, const float* slab_lam,
                    const int* slab_ids, const int* tiles, int f, int cap,
                    const float* qn, const float* lamq, const int* probe,
                    int n_blocks, int n_probe, int qb, float tau, int k,
                    float* out_s, int* out_i, void* stage_rows, int* merges,
                    int device, void* stream) {
  if (f <= 0 || cap <= 0 || cap % tile::TILE != 0 || n_blocks <= 0 ||
      n_probe <= 0 || qb <= 0 || qb > MAX_QB || tile::list_words(k) < 0 ||
      dtype < 0 || dtype > 2)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  uint64_t* rows = static_cast<uint64_t*>(stage_rows);
  if (dtype == 1)
    return launch<__nv_bfloat16>(slabs, slab_lam, slab_ids, tiles, f, cap, qn,
                                 lamq, probe, n_blocks, n_probe, qb, tau, k,
                                 out_s, out_i, rows, merges, st);
  if (dtype == 2)
    return launch<__half>(slabs, slab_lam, slab_ids, tiles, f, cap, qn, lamq,
                          probe, n_blocks, n_probe, qb, tau, k, out_s, out_i,
                          rows, merges, st);
  return launch<float>(slabs, slab_lam, slab_ids, tiles, f, cap, qn, lamq,
                       probe, n_blocks, n_probe, qb, tau, k, out_s, out_i,
                       rows, merges, st);
}

// Resident blocks an SM of the launch of lists of k for blocks of qb over
// slabs of dtype (as ivf_scan_launch's), or a negated CUDA error code.
int ivf_scan_blocks_per_sm(int qb, int k, int dtype, int device) {
  if (qb <= 0 || qb > MAX_QB || tile::list_words(k) < 0 || dtype < 0 ||
      dtype > 2)
    return -(int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return -(int)err;
  return dtype == 1   ? blocks_per_sm<__nv_bfloat16>(qb, k)
         : dtype == 2 ? blocks_per_sm<__half>(qb, k)
                      : blocks_per_sm<float>(qb, k);
}

const char* ivf_scan_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
