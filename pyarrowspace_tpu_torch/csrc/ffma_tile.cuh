// The register-tiled fp32 product of K1 (knn.cu, knn_wide.cuh), K1t
// (knn_t.cu) and K2 (scan_topk.cu): 128 rows against 128 rows per block of
// 256 threads, thread (tx, ty) (thread_x, thread_y below) holding the 8 x 8
// micro-tile of rows ty + 16 i and columns tx + 16 j in registers.
//
// The bits are tile_common.cuh's: each output element is ONE dot_step
// (fmaf) chain over features 0..F-1 in ascending order, starting from
// +0.0, with the features past F entering as zeros.  The accumulator never
// becomes -0.0 (it starts at +0.0, and a sum rounds to -0.0 only when both
// addends are -0.0), so the trailing fmaf(0, 0, acc) steps leave it as it
// is, and the element equals tile::tile_product's bit for bit whatever the
// slab width.  K5's SIMT route (gather_score.cu, on float32 operands) keeps
// tile_product's chain and is the witness of this on the card
// (ops/cuda/compare.py: k5_distance for K1, k5_blend for K2).  The feature
// sum is never split across threads, warps, stages or blocks; no TF32, bf16
// or 3xTF32 product keeps these bits, so the product runs on the fp32 FMA
// pipe (67 TFLOP/s on the H100, 128 FMAs a clock an SM).
//
// What bounds it: that pipe, if the instructions beside the FMAs and the
// waits leave it busy.  Per step of 4 features a thread issues 256 FFMAs
// beside 16 shared-memory loads (its 8 rows and 8 columns, 16 bytes each
// for float32); one block of 8 warps an SM (up to 254 registers a thread),
// so 2 warps a scheduler, and every wait that the other warp does not
// cover idles the pipe.  So no block barrier waits inside the feature
// loop, no registers hold staged loads through the multiply (they double-
// buffer the fragments instead), and no tile starts on an exposed load
// where shared memory allows: the float32 mainloop is 2,048 FFMAs in
// ~2,290 instructions a slab (89%), a tile visit at 384 features ~71,500
// cycles against the 49,152 of the pipe (PERF.md).
//
//   - The ring (TmaRing, float32 rows): S stages (a template parameter, 2
//     to 4) of one slab each, a slab being 128 bytes of features (32
//     float32) of the 128 A rows, then of the 128 B rows: 16 KB + 16 KB.  Thread 0
//     fills a stage with two cp.async.bulk.tensor.2d copies (the tensor
//     maps of wgmma_tile.cuh, over each operand's row view, so rows past
//     the view and features past F arrive as zeros) counted on the stage's
//     full mbarrier; every warp waits on that barrier's phase parity,
//     multiplies, and arrives on the stage's empty mbarrier (8 arrivals
//     free it).  At the top of slab g thread 0 issues slab g + S - 1 into
//     the stage slab g - 1 has left, waiting on its empty barrier: S - 1
//     slabs stay in flight, and warp 0, which issues, stays within a slab
//     of the others.  No block barrier inside the feature loop.  (On an
//     H100 80GB HBM3 at 700 W, testing the empty barrier without waiting
//     let warp 0 fall behind and the other warps starve: K1 on 16,384 rows
//     163 ms against 104; PERF.md.)
//   - The layout: stage rows are 128 bytes, dense, with the 128-byte
//     swizzle TMA writes (CU_TENSOR_MAP_SWIZZLE_128B): 16-byte chunk c of
//     row r at chunk c ^ (r % 8), the ring 1,024-byte aligned.  A warp's 8
//     tx read 8 B rows (tx0 .. tx0 + 7, plus 16 j): 8 distinct r % 8, so 8
//     distinct chunks, 32 distinct banks, conflict-free; its 4 ty read 4 A
//     rows, each a broadcast to the 8 lanes of that ty, 4 distinct chunks.
//     Row r = ty + 16 i keeps r % 8 = ty % 8 for every i, so a thread's
//     swizzle is one XOR a step for all its rows.
//   - The fragments: the rows and columns of features kq + 4 are loaded
//     while those of kq are multiplied (two register sets; 0 spills).
//     bf16 rows (K2's over ragged or unaligned bf16 rows, on RegRing) stay
//     bf16 in the stage (64 features a 128-byte row) and are converted
//     when read (bits << 16: exact).
//   - The tiles: a block walks many tiles.  Where shared memory holds the
//     epilogue's region (the 128 x 136 result tile, 68 KB) beside the ring
//     ("carry"), the stages of the walk's next tile are issued while this
//     tile's last slabs are multiplied and land during the epilogue and the
//     merges, so no tile starts on an exposed load.  Where it does not (the
//     region over the ring, "drain"), the ring empties at the end of each
//     tile and the next tile's product starts by issuing its first stages
//     (after a proxy fence and a block barrier: TMA writes where the
//     epilogue wrote and read).
//   - The budget: a block may have 232,448 bytes.  plan() picks, for the
//     kernel's other shared memory (its lists: 128 k 8 bytes for lists of k
//     <= 128; the symmetric route's transposed-list copies and filters; the
//     wide route's 128 KB of row buffers; K1t's owners' lists), the deepest
//     carry ring of 4 or 3 stages that fits, else the deepest drain ring of
//     4 to 2 (the region needs 68 KB: at least 2 stages).  At k 25 (the
//     build) and 15 (serving): 4 stages, carry.  At k 128 on the symmetric
//     route (140,816 bytes of lists and filters): 2 stages, drain.
//     tests/test_torch_product_layout.py mirrors the plan for every route
//     and k.
//   - The second loader (RegRing): TMA needs 16-byte row strides and
//     aligned bases (F % 4 == 0 for float32).  Other shapes, and bf16 rows
//     (which take tc_scan.cuh's tensor-core route wherever TMA could read
//     them, so only ragged or unaligned ones reach this product), keep the
//     register-staged loader: a two-stage ring in the same
//     swizzled layout, filled by 16-byte chunks loaded into registers
//     during the multiply and stored after it, one block barrier a slab.
//     The wrappers pick the loader from F and alignment alone
//     (ops/cuda/ffma_tile.py) and the route names it; a tensor map that
//     fails to encode raises.
//
// Lists of k > 128 take knn_wide.cuh's route: survivors buffered as keys
// beside the ring, staged, sorted in the drained ring and merged into
// partial lists in device memory.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "tile_common.cuh"
#include "wgmma_tile.cuh"

namespace regtile {

constexpr int TILE = 128;         // rows per block and columns per tile
constexpr int THREADS = 256;      // 16 x 16 threads
constexpr int WARPS = THREADS / 32;
constexpr int MICRO = 8;          // a thread's rows, and its columns
constexpr int ROW_BYTES = 128;    // one staged row of a slab
constexpr int BOX_BYTES = TILE * ROW_BYTES;    // one operand of a stage
constexpr int STAGE_BYTES = 2 * BOX_BYTES;     // A rows, then B rows
constexpr int MIN_STAGES = 2;
constexpr int MAX_STAGES = 4;
constexpr int CARRY_MIN_STAGES = 3;
constexpr int REG_STAGES = 2;     // the register-staged loader's ring
constexpr int RES_LD = TILE + 8;  // row stride of the result tile (floats)
constexpr int RES_BYTES = TILE * RES_LD * 4;   // the result tile: 69,632
constexpr int BAR_BYTES = 2 * MAX_STAGES * 8;  // full and empty mbarriers
constexpr int SMEM_LIMIT = 232448;             // a block's shared memory
constexpr int MAX_NARROW = 128;   // longest list kept in shared memory

// Features of a slab: one 128-byte row.
template <class T>
__host__ __device__ constexpr int slab() {
  return ROW_BYTES / (int)sizeof(T);
}

// Words per lane of a list of k entries: 2 or 4 for a narrow list, 0 for a
// wide one, -1 when k is out of range.
inline int list_words(int k) {
  return k < 1 ? -1 : k <= 64 ? 2 : k <= MAX_NARROW ? 4 : 0;
}

// The shared memory of a block (byte offsets into the dynamic shared
// memory, the ring at 0): its stages, whether the epilogue's region lies
// beside the ring (carry) or over it, the mbarriers and the kernel's other
// memory (rest).  stages 0: nothing fits.
struct Plan {
  int stages, carry, epi, bars, rest, bytes;
};

// The plan of a kernel whose epilogue region takes epi_bytes and whose
// other memory takes rest_bytes: TMA, the deepest carry ring that fits,
// else the deepest drain ring; the register-staged loader, its two stages,
// drain.
inline Plan plan(int epi_bytes, size_t rest_bytes, bool tma) {
  auto at = [&](int s, bool carry) {
    const int ring = s * STAGE_BYTES;
    const int region =
        carry ? ring + epi_bytes : (ring > epi_bytes ? ring : epi_bytes);
    const int bars = (region + 15) / 16 * 16;
    const int rest = bars + BAR_BYTES;
    return Plan{s, carry ? 1 : 0, carry ? ring : 0, bars, rest,
                rest + (int)rest_bytes};
  };
  if (!tma) {
    const Plan p = at(REG_STAGES, false);
    return p.bytes <= SMEM_LIMIT ? p : Plan{0, 0, 0, 0, 0, 0};
  }
  for (int s = MAX_STAGES; s >= CARRY_MIN_STAGES; --s)
    if (at(s, true).bytes <= SMEM_LIMIT) return at(s, true);
  for (int s = MAX_STAGES; s >= MIN_STAGES; --s)
    if (at(s, false).bytes <= SMEM_LIMIT) return at(s, false);
  return Plan{0, 0, 0, 0, 0, 0};
}

// 8-byte (bf16) or 16-byte (float) loads of the register-staged loader
// need F % 4 == 0 and aligned rows.
template <class T>
inline bool can_vectorize(const void* p, int f) {
  return f % 4 == 0 &&
         reinterpret_cast<std::uintptr_t>(p) % (4 * sizeof(T)) == 0;
}

// The two operands of a product: row views of [*, f] matrices of T (a's
// rows [0, a_rows), b's [0, b_rows)), and for the TMA loader their tensor
// maps (boxes of one 128-byte slab x 128 rows, 128-byte swizzled, zeros
// past the view's rows and past f).  A kernel takes it as a
// __grid_constant__ parameter, so the maps stay in parameter space.
template <class T>
struct Operands {
  CUtensorMap map_a, map_b;
  const T* a;
  const T* b;
  int a_rows, b_rows, f, vec;
};

// The operands of a launch; with tma, their tensor maps, encoded once on
// the host.  Returns 0, or a CUDA error code when tma is asked for on a
// shape TMA cannot describe, on bf16 rows (where TMA can read them they
// take tc_scan.cuh's tensor-core route) or a map fails to encode (the
// caller raises: no other loader is taken).
template <class T>
inline int make_operands(Operands<T>* o, const T* a, int a_rows, const T* b,
                         int b_rows, int f, bool tma) {
  *o = Operands<T>{};
  o->a = a;
  o->b = b;
  o->a_rows = a_rows;
  o->b_rows = b_rows;
  o->f = f;
  o->vec = can_vectorize<T>(a, f) && can_vectorize<T>(b, f);
  if (!tma) return 0;
  if (sizeof(T) != 4 || !wg::route_ok<T>(a, b, f))
    return (int)cudaErrorInvalidValue;
  if (!wg::make_map_2d(&o->map_a, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, sizeof(T),
                       a, (uint64_t)a_rows, (uint64_t)f, slab<T>(), TILE) ||
      !wg::make_map_2d(&o->map_b, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, sizeof(T),
                       b, (uint64_t)b_rows, (uint64_t)f, slab<T>(), TILE))
    return (int)cudaErrorInvalidValue;
  return 0;
}

// Thread tid's place (tx, ty) in the 16 x 16 grid: warp w covers tx
// 8 (w % 2) .. + 7 and ty 4 (w / 2) .. + 3, so one shared-memory load of a
// warp touches 8 rows of B and 4 rows of A.
__device__ __forceinline__ int thread_x() {
  return ((threadIdx.x >> 5) & 1) * 8 + (threadIdx.x & 7);
}
__device__ __forceinline__ int thread_y() {
  return (threadIdx.x >> 6) * 4 + ((threadIdx.x >> 3) & 3);
}

// Four consecutive features of one staged row, as loaded, and as floats.
template <class T>
struct Frag;
template <>
struct Frag<float> {
  float4 v;
  __device__ __forceinline__ void load(const char* p) {
    v = *reinterpret_cast<const float4*>(p);
  }
  __device__ __forceinline__ float4 f() const { return v; }
};
template <>
struct Frag<__nv_bfloat16> {
  uint2 v;   // feature 2 e in the low half of word e, 2 e + 1 in the high
  __device__ __forceinline__ void load(const char* p) {
    v = *reinterpret_cast<const uint2*>(p);
  }
  __device__ __forceinline__ float4 f() const {
    return make_float4(__uint_as_float(v.x << 16),
                       __uint_as_float(v.x & 0xffff0000u),
                       __uint_as_float(v.y << 16),
                       __uint_as_float(v.y & 0xffff0000u));
  }
};

// The fragments of features kq .. kq + 3 of a thread's 8 A rows (ty + 16 i)
// and 8 B rows (tx + 16 j) of a swizzled stage.
template <class T>
__device__ __forceinline__ void fetch(const char* __restrict__ as,
                                      const char* __restrict__ bs, int sa,
                                      int sb, int kq, Frag<T> (&a)[MICRO],
                                      Frag<T> (&b)[MICRO]) {
  const int byte = kq * (int)sizeof(T);
  const int chunk = byte >> 4, within = byte & 15;
  const int oa = ((chunk ^ sa) << 4) | within;
  const int ob = ((chunk ^ sb) << 4) | within;
#pragma unroll
  for (int i = 0; i < MICRO; ++i) a[i].load(as + i * 16 * ROW_BYTES + oa);
#pragma unroll
  for (int j = 0; j < MICRO; ++j) b[j].load(bs + j * 16 * ROW_BYTES + ob);
}

// acc[i][j] advanced by 4 features, in ascending order.
template <class T>
__device__ __forceinline__ void step4(const Frag<T> (&a)[MICRO],
                                      const Frag<T> (&b)[MICRO],
                                      float acc[MICRO][MICRO]) {
  float4 af[MICRO];
#pragma unroll
  for (int i = 0; i < MICRO; ++i) af[i] = a[i].f();
#pragma unroll
  for (int j = 0; j < MICRO; ++j) {
    const float4 bf = b[j].f();
#pragma unroll
    for (int i = 0; i < MICRO; ++i) {
      float c = acc[i][j];
      c = tile::dot_step(af[i].x, bf.x, c);
      c = tile::dot_step(af[i].y, bf.y, c);
      c = tile::dot_step(af[i].z, bf.z, c);
      c = tile::dot_step(af[i].w, bf.w, c);
      acc[i][j] = c;
    }
  }
}

// 4-feature steps a loop iteration of a slab's multiply: the whole float32
// slab (8 steps, 2,300 instructions); bf16's 16 steps, with their
// conversions, in iterations of 2, so the loop stays small in the
// instruction cache.
template <class T>
struct Steps {
  static constexpr int value = sizeof(T) == 4 ? slab<T>() / 4 : 2;
};

// acc[i][j] advanced by the slab<T>() features of one staged slab, in
// ascending feature order for every element; the fragments of features kq
// + 4 are loaded while those of kq are multiplied.
template <class T>
__device__ __forceinline__ void slab_product(const char* __restrict__ stage,
                                             int tx, int ty,
                                             float acc[MICRO][MICRO]) {
  constexpr int SLAB = slab<T>(), STEPS = Steps<T>::value;
  static_assert(STEPS % 2 == 0 && SLAB % (4 * STEPS) == 0, "slab steps");
  const char* as = stage + ty * ROW_BYTES;
  const char* bs = stage + BOX_BYTES + tx * ROW_BYTES;
  const int sa = ty & 7, sb = tx & 7;
  Frag<T> a0[MICRO], b0[MICRO], a1[MICRO], b1[MICRO];
  fetch<T>(as, bs, sa, sb, 0, a0, b0);
#pragma unroll 1
  for (int kq = 0; kq < SLAB; kq += 4 * STEPS) {
#pragma unroll
    for (int s = 0; s < STEPS; s += 2) {
      const int k = kq + 4 * s;
      fetch<T>(as, bs, sa, sb, k + 4, a1, b1);
      step4<T>(a0, b0, acc);
      if (k + 8 < SLAB) fetch<T>(as, bs, sa, sb, k + 8, a0, b0);
      step4<T>(a1, b1, acc);
    }
  }
}

__device__ __forceinline__ void zero(float acc[MICRO][MICRO]) {
#pragma unroll
  for (int i = 0; i < MICRO; ++i)
#pragma unroll
    for (int j = 0; j < MICRO; ++j) acc[i][j] = 0.0f;
}

// The TMA loader.  A block's products share one ring: g counts the slabs
// the block has consumed, fed those issued (both the same in every
// thread); slab g lies in stage g % S, its full barrier's phase (g / S) &
// 1.  At the top of slab g, thread 0 issues slab g + S - 1 into the stage
// slab g - 1 has left, waiting until every warp has left it (warp 0 is
// then at most one slab ahead of the others, and S - 1 slabs are in
// flight).  In carry mode the slabs issued past a tile are the walk's next
// tile's.
template <class T, int S>
struct TmaRing {
  using Elem = T;
  static constexpr int STAGES = S;
  char* stages;
  uint64_t* full;
  uint64_t* empty;
  const CUtensorMap* map_a;
  const CUtensorMap* map_b;
  int a0, n_slabs, carry;
  uint32_t g, fed;

  // Over dynamic shared memory smem (1,024-byte aligned) laid out by pl,
  // for the block's A rows from a_row of ops' A view.  start() must follow
  // before the first product.
  __device__ __forceinline__ TmaRing(char* smem, const Plan& pl,
                                     const Operands<T>& ops, int a_row)
      : stages(smem),
        full(reinterpret_cast<uint64_t*>(smem + pl.bars)),
        empty(reinterpret_cast<uint64_t*>(smem + pl.bars) + MAX_STAGES),
        map_a(&ops.map_a),
        map_b(&ops.map_b),
        a0(a_row),
        n_slabs((ops.f + slab<T>() - 1) / slab<T>()),
        carry(pl.carry),
        g(0),
        fed(0) {}

  // The barriers, initialised by thread 0; ends with a block barrier, which
  // also orders the caller's writes before it ahead of every product.
  __device__ __forceinline__ void start() {
    if (threadIdx.x == 0) {
      for (int s = 0; s < S; ++s) {
        wg::bar_init(full + s, 1);
        wg::bar_init(empty + s, WARPS);
      }
      wg::bar_init_fence();
    }
    __syncthreads();
  }

  // One thread: slab p into its stage, once the slab before it there (p -
  // S) has been left by every warp; B rows from b0 within this tile (its
  // first slab g0), from nb past it.
  __device__ __forceinline__ void load(uint32_t p, uint32_t g0, int b0,
                                       int nb) {
    const int st = (int)(p % S);
    if (p >= (uint32_t)S) wg::bar_wait(empty + st, ((p / S) + 1) & 1);
    const uint32_t rel = p - g0;
    const bool here = rel < (uint32_t)n_slabs;
    const int feat = (int)(here ? rel : rel - n_slabs) * slab<T>();
    char* dst = stages + st * STAGE_BYTES;
    wg::bar_expect(full + st, STAGE_BYTES);
    wg::tma_load(dst, map_a, full + st, feat, a0);
    wg::tma_load(dst + BOX_BYTES, map_b, full + st, feat, here ? b0 : nb);
  }

  // acc[i][j] = sum_f A[a0 + ty + 16 i][f] * B[b0 + tx + 16 j][f] over all
  // features, one fmaf chain per element; nb: the B row of the walk's next
  // tile (-1: none).  Returns after a block barrier, with every thread past
  // its last read of the ring and of what the caller wrote before the call.
  __device__ __forceinline__ void product(int b0, int nb,
                                          float acc[MICRO][MICRO]) {
    const int tx = thread_x(), ty = thread_y();
    const uint32_t g0 = g;
    // Slabs that may be issued in this call: this tile's, and carrying,
    // the next tile's.
    const uint32_t cap =
        g0 + n_slabs + (carry && nb >= 0 ? (uint32_t)n_slabs : 0u);
    if (!carry) {
      // The epilogue region overlaps the ring: its generic writes and
      // reads are ordered before the TMA writes that follow.
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();
    }
    // The first S - 1 slabs not yet issued (the kernel's first tile, or a
    // drained ring).
    const uint32_t fill = min(g0 + S - 1, cap);
    if (threadIdx.x == 0)
      for (uint32_t p = fed; p < fill; ++p) load(p, g0, b0, nb);
    fed = max(fed, fill);
    zero(acc);
    for (int i = 0; i < n_slabs; ++i) {
      const uint32_t p = g + S - 1;
      if (p < cap && p >= fed) {
        if (threadIdx.x == 0) load(p, g0, b0, nb);
        fed = p + 1;
      }
      const int st = (int)(g % S);
      wg::bar_wait(full + st, (g / S) & 1);
      slab_product<T>(stages + st * STAGE_BYTES, tx, ty, acc);
      __syncwarp();
      if ((threadIdx.x & 31) == 0) wg::bar_arrive(empty + st);
      ++g;
    }
    __syncthreads();
  }
};

// The register-staged loader: 16-byte chunks of a stage, chunk c of row r
// being features c E .. c E + E - 1 (E = 16 / sizeof(T)); thread tid takes
// chunk tid % 8 of rows tid / 8 + 32 p, p < 4, of A and of B.
template <class T>
__device__ __forceinline__ uint4 load_chunk(const T* __restrict__ base,
                                            int row, int rows, int feat,
                                            int f, bool vec) {
  uint4 out = make_uint4(0u, 0u, 0u, 0u);
  if (row >= rows) return out;
  const T* src = base + (size_t)row * f + feat;
  if (vec) {
    // f % 4 == 0 and 4-element-aligned rows: 4 features at a time.
    if constexpr (sizeof(T) == 4) {
      if (feat < f)
        out = __ldg(reinterpret_cast<const uint4*>(src));
    } else {
      if (feat < f) {
        const uint2 lo = __ldg(reinterpret_cast<const uint2*>(src));
        out.x = lo.x;
        out.y = lo.y;
      }
      if (feat + 4 < f) {
        const uint2 hi = __ldg(reinterpret_cast<const uint2*>(src + 4));
        out.z = hi.x;
        out.w = hi.y;
      }
    }
    return out;
  }
  uint32_t w[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if constexpr (sizeof(T) == 4) {
      w[e] = feat + e < f ? __float_as_uint(src[e]) : 0u;
    } else {
      const uint32_t lo =
          feat + 2 * e < f ? __bfloat16_as_ushort(src[2 * e]) : 0u;
      const uint32_t hi =
          feat + 2 * e + 1 < f ? __bfloat16_as_ushort(src[2 * e + 1]) : 0u;
      w[e] = lo | hi << 16;
    }
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

template <class T>
struct RegRing {
  using Elem = T;
  static constexpr int STAGES = REG_STAGES;
  static constexpr int PASSES = TILE * (ROW_BYTES / 16) / THREADS;
  char* stages;
  const Operands<T>* ops;
  int a0, n_slabs;

  __device__ __forceinline__ RegRing(char* smem, const Plan&,
                                     const Operands<T>& o, int a_row)
      : stages(smem),
        ops(&o),
        a0(a_row),
        n_slabs((o.f + slab<T>() - 1) / slab<T>()) {}

  __device__ __forceinline__ void start() { __syncthreads(); }

  __device__ __forceinline__ void load(int b0, int s, uint4 (&ra)[PASSES],
                                       uint4 (&rb)[PASSES]) const {
    const int feat = s * slab<T>() + (threadIdx.x & 7) * (16 / sizeof(T));
#pragma unroll
    for (int q = 0; q < PASSES; ++q) {
      const int row = (threadIdx.x >> 3) + (THREADS / 8) * q;
      ra[q] = load_chunk(ops->a, a0 + row, ops->a_rows, feat, ops->f,
                         ops->vec != 0);
      rb[q] = load_chunk(ops->b, b0 + row, ops->b_rows, feat, ops->f,
                         ops->vec != 0);
    }
  }

  __device__ __forceinline__ void store(char* stage,
                                        const uint4 (&ra)[PASSES],
                                        const uint4 (&rb)[PASSES]) const {
    const int c = threadIdx.x & 7;
#pragma unroll
    for (int q = 0; q < PASSES; ++q) {
      const int row = (threadIdx.x >> 3) + (THREADS / 8) * q;
      const uint32_t off = wg::swizzle_offset(row, c);
      *reinterpret_cast<uint4*>(stage + off) = ra[q];
      *reinterpret_cast<uint4*>(stage + BOX_BYTES + off) = rb[q];
    }
  }

  // As TmaRing::product; the ring is free on entry (the callers end each
  // tile with a block barrier).
  __device__ __forceinline__ void product(int b0, int,
                                          float acc[MICRO][MICRO]) {
    const int tx = thread_x(), ty = thread_y();
    zero(acc);
    uint4 ra[PASSES], rb[PASSES];
    load(b0, 0, ra, rb);
    store(stages, ra, rb);
    __syncthreads();
    for (int s = 0; s < n_slabs; ++s) {
      const bool more = s + 1 < n_slabs;
      // The next slab's loads are in flight during this slab's multiply;
      // its stage was last read before the previous barrier.
      if (more) load(b0, s + 1, ra, rb);
      slab_product<T>(stages + (s & 1) * STAGE_BYTES, tx, ty, acc);
      if (more) store(stages + ((s + 1) & 1) * STAGE_BYTES, ra, rb);
      __syncthreads();
    }
  }
};

// Launch `fn` with the ring type of a plan: TmaRing<T, S> for the TMA
// loader's S stages (float32 rows only), RegRing<T> for the
// register-staged loader.
template <class T, class Fn>
inline int with_ring(const Plan& pl, bool tma, Fn&& fn) {
  if (!tma) return fn((RegRing<T>*)nullptr);
  if constexpr (sizeof(T) != 4) {
    return (int)cudaErrorInvalidValue;
  } else {
    switch (pl.stages) {
      case 2:
        return fn((TmaRing<T, 2>*)nullptr);
      case 3:
        return fn((TmaRing<T, 3>*)nullptr);
      case 4:
        return fn((TmaRing<T, 4>*)nullptr);
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
}

}  // namespace regtile
