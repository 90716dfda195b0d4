// K1: fused exact eps/k-NN scan over unit rows.
//
// Replaces the TPU kernel pyarrowspace_tpu/ops/pallas/knn.py
// `_knn_block_kernel` (driven by `_knn_pallas_all`, entered through
// `knn_graph_candidates_pallas`), with its `sub` and `diag_start` options,
// and the projection-sorted walk of `_knn_pallas_all_reordered`.  For every
// row i of a row range it keeps the k smallest d(i, j) = 1 - max(0,
// x_i . x_j) over the columns j of [col_start, n), with self, columns >= n
// and d > eps masked to 2.0 before the merge; missing entries stay (2.0,
// -1).  Rows come out ascending by (distance, id).
//
// What bounds it on the H100: the products.  At 313,841 x 384 a walk of
// every row block over every column tile computes 313,841^2 x 384 x 2 =
// 75.6 TFLOP of fp32 multiply-adds, against 67 TFLOP/s of fp32 outside the
// tensor cores (1.129 s); since d(i, j) == d(j, i) bit for bit, the function
// needs only half of them (0.564 s), which the symmetric route below
// computes.  The merge touches each candidate once (a compare against the
// row's kth) and inserts only about k (1 + ln(N / k)) times per row.
//
// The design: one block of 256 threads per 128-row block; the block walks
// the 128-column tiles (nothing carries between blocks on a GPU, so the
// TPU's sequential grid axis becomes this loop).  Per tile: the
// register-tiled fp32 product of ffma_tile.cuh (8 x 8 outputs a thread, a
// TMA-fed ring of 128-byte slabs on mbarriers, the walk's next tile loading
// during this one's epilogue where shared memory allows; the
// register-staged loader where F % 4 != 0 or the rows are unaligned), the
// mask epilogue into a shared 128 x 128 tile, then one warp per row offers the
// improving candidates to the row's running list, 64 columns at a time in
// ascending column order.  The result is exact in fp32, and d(i, j) ==
// d(j, i) bitwise.  Lists of k <= 128 live in shared memory (2 or 4 words
// a lane); longer lists would take 128 x k x 8 bytes (256 KB at k 256, past
// the 227 KB a block may have with the ring), so they take the wide route
// of knn_wide.cuh: the column walk split across blocks when the row blocks
// leave SMs idle, each tile's survivors buffered, sorted and merged into
// partial lists in device memory, and a second launch merging the splits.
//
// The symmetric route ("sym": ops/cuda/knn.py::route_name picks it, for
// the self-join of a whole corpus: all rows against all columns, no seed,
// rotation or permutation, k <= 128; this launcher refuses it elsewhere).
// Block b walks only the column tiles t >= b, so the walk computes each
// d(i, j) once: its diagonal tile first, then the others in a strided order
// of its own (at the walk below).  The diagonal tile holds both (i, j) and
// (j, i) and is merged into the block's own lists as above.  Every other
// tile is merged twice from the same masked distances: row-wise into the
// block's own lists, and column-wise, the transposed tile (row r0 + rr
// offered to the list of row c0 + c), into the transposed lists of the
// tile's rows: partial lists [N, k] of knn_wide::Ent in device memory,
// allocated by the wrapper, in which each row gathers the rows of the
// blocks below its own.
//   - The lock: a tile's transposed lists are merged under a spin lock of
//     that tile in device memory (a compare-and-swap with acquire
//     semantics, __nanosleep in the spin, a release store after a block
//     barrier).  A block holds one lock at a time, so nothing deadlocks;
//     the strided walks make blocks meet on a tile rarely, and part soon
//     when they do.
//   - The filter: each column's transposed kth, copied into shared memory
//     under the tile's product (cp.async, without the lock: any kth the
//     list ever had bounds its final one, so a stale copy lets more
//     through, never fewer), compared in the epilogue from registers.  A
//     flagged column is merged, under the lock, against its list as it is
//     then; a warp loads up to 4 of its flagged columns' lists at once.
//   - The end: a second launch merges each row's own list (in the output)
//     with its transposed list (knn_wide::merge, as the split walk's
//     partial lists); rows of block 0 have empty ones.
// Own and transposed merges take MinLex, so each list is the lexicographic
// (distance, id) top-k whatever the order in which blocks reach a tile:
// every list is the full walk's bit for bit.  Hazards:
//   - the distances tile Ds lies in the epilogue region (over the ring when
//     the lists leave no room beside it), so the transposed merge ends (a
//     block barrier) before the next tile's epilogue or product overwrites
//     it: it lies on the critical path, beside the row-wise merge;
//   - a column of Ds is strided by RES_LD = 136 floats, so a warp reading
//     32 rows of one column meets 8-way bank conflicts: the filter runs on
//     the epilogue's registers, and only a flagged column's merge reads a
//     column (4 conflicted reads a lane, then broadcasts);
//   - transposed ids arrive in no fixed order: both merges take MinLex, so
//     a tie at the kth goes to the smaller id whatever the order of arrival;
//   - a transposed list is read and written around L1 (ld.cg / st.cg), so
//     no block reads another block's older copy of it from its SM's L1.
//
// Launch options, each keeping the one fmaf chain per pair, so every
// distance stays bitwise the default scan's:
//   - col_start and seeded: the walk covers [col_start, n) only, its first
//     tile starting at col_start itself (no column before it is offered),
//     and each list starts from the sorted list already in its output row.
//     A seeded list merges with MinLex: the incremental extend's seeds hold
//     ids below col_start (MinLex then keeps what Min would), a ring step
//     of the sharded build (parallel/sharded.py) seeds lists of any ids.
//   - diag_start: block b walks the 128-column tiles from the one holding
//     its own rows, then wraps around (the TPU kernel's locality walk).  Ids
//     then arrive out of order, so the lists use MinLex.
//   - perm (reorder): xu is the corpus permuted by perm; the kernel offers
//     the original ids perm[c] and writes row r's list to output row
//     perm[r], with MinLex, so the result is the default scan's on any data,
//     ties included.
// The TPU kernel's `sub` (per-slice products and merges) has nothing to add
// here: every 64-column half of a tile is merged on its own, each row's
// half gated by a ballot against its kth entry.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <type_traits>

#include "ffma_tile.cuh"
#include "knn_wide.cuh"
#include "tile_common.cuh"

namespace {

constexpr float INF_DIST = 2.0f;

// A list entry as the 64 bits of a knn_wide::Ent: the distance's bits low,
// the id high.
__device__ __forceinline__ unsigned long long ent_bits(float v, int id) {
  return (unsigned long long)__float_as_uint(v) |
         (unsigned long long)(unsigned)id << 32;
}

// The symmetric route's lock of a column tile: taken by one thread of the
// block, released by one thread after a block barrier (the pattern of a
// serial split-K semaphore), so the block's list writes before the barrier
// are visible to the next holder.
__device__ __forceinline__ void lock_tile(int* lock) {
  int old;
  do {
    asm volatile("atom.acquire.gpu.global.cas.b32 %0, [%1], %2, %3;\n"
                 : "=r"(old)
                 : "l"(lock), "r"(0), "r"(1)
                 : "memory");
    if (old != 0) __nanosleep(256);
  } while (old != 0);
}

__device__ __forceinline__ void unlock_tile(int* lock) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;\n" ::"l"(lock), "r"(0)
               : "memory");
}

// Merge the warp's flagged columns of the tile (c = warp + 8 i with
// col_hit[c] set; col_hit cleared) into the transposed lists of the tile's
// rows (lists + c k, sorted in device memory), MinLex, since the blocks
// reach the tile in any order.  Up to BATCH columns at a time: their lists
// are loaded together, so the warp waits on device memory once a batch;
// each is then copied into the warp's (vals, ids) in shared memory, its
// rows (row r0 + rr at Ds[rr * RES_LD + c], rr < n_rows) ballotted against
// its kth, the survivors offered and the list written back if it changed.
// Called by all 32 lanes of one warp while the block holds the tile's
// lock.  The ballot's reads of a column are 8-way bank conflicts (RES_LD =
// 136); only columns that the epilogue flagged come here.
template <int W>
__device__ __forceinline__ void merge_columns(const float* Ds, int* col_hit,
                                              int r0, int n_rows,
                                              knn_wide::Ent* lists, int k,
                                              float* vals, int* ids,
                                              int warp, int lane) {
  using regtile::RES_LD;
  constexpr int BATCH = 4, MINE = regtile::TILE / regtile::WARPS;
  unsigned todo = __ballot_sync(
      tile::FULL, lane < MINE && col_hit[warp + regtile::WARPS * lane]);
  if (lane < MINE) col_hit[warp + regtile::WARPS * lane] = 0;
  while (todo) {
    int col[BATCH];
    unsigned long long e[BATCH][W];
#pragma unroll
    for (int b = 0; b < BATCH; ++b) {
      col[b] = -1;
      if (todo) {
        col[b] = warp + regtile::WARPS * (__ffs(todo) - 1);
        todo &= todo - 1;
      }
      const auto* bits = reinterpret_cast<const unsigned long long*>(
          lists + (size_t)max(col[b], 0) * k);
#pragma unroll
      for (int w = 0; w < W; ++w) {
        const int s = lane + 32 * w;
        e[b][w] = col[b] >= 0 && s < k ? __ldcg(bits + s) : 0ull;
      }
    }
#pragma unroll
    for (int b = 0; b < BATCH; ++b) {
      if (col[b] < 0) break;
#pragma unroll
      for (int w = 0; w < W; ++w) {
        const int s = lane + 32 * w;
        if (s < k) {
          vals[s] = __uint_as_float((unsigned)e[b][w]);
          ids[s] = (int)(e[b][w] >> 32);
        }
      }
      __syncwarp();
      const float* c_d = Ds + col[b];
      const float kth = vals[k - 1];
      const int kth_id = ids[k - 1];
      unsigned m[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int rr = lane + 32 * q;
        m[q] = __ballot_sync(tile::FULL,
                             rr < n_rows && tile::MinLex::better(
                                                c_d[rr * RES_LD], r0 + rr,
                                                kth, kth_id));
      }
      if (m[0] | m[1] | m[2] | m[3]) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          while (m[q]) {
            const int rr = 32 * q + __ffs(m[q]) - 1;
            m[q] &= m[q] - 1;
            tile::offer<tile::MinLex, W>(vals, ids, k, c_d[rr * RES_LD],
                                         r0 + rr, lane);
          }
        }
        auto* out = reinterpret_cast<unsigned long long*>(
            lists + (size_t)col[b] * k);
        for (int s = lane; s < k; s += 32)
          __stcg(out + s, ent_bits(vals[s], ids[s]));
      }
      __syncwarp();
    }
  }
}

// The stride of a symmetric walk over len tiles: the first integer from
// 0.618 len (at least 1) that is coprime with len.
__device__ __forceinline__ int sym_stride(int len) {
  int g = max(1, (int)(0.618034f * len));
  while (true) {
    int a = g, b = len;
    while (b) {
      const int r = a % b;
      a = b;
      b = r;
    }
    if (a == 1) return g;
    ++g;
  }
}

// Shared memory of a block beside the product's ring and the distances
// tile: the lists, and the tile's ids and flagged rows; on the symmetric
// route also a warp's copy of a transposed list, each column's filter (8
// bytes) and flag, and the block's flag.
inline size_t rest_bytes(int k, bool sym) {
  return (size_t)regtile::TILE * k * 8 + 2 * regtile::TILE * sizeof(int) +
         (sym ? (size_t)regtile::WARPS * k * 8 + regtile::TILE * (8 + 4) + 16
              : 0);
}

inline regtile::Plan block_plan(int k, bool sym, bool tma) {
  return regtile::plan(regtile::RES_BYTES, rest_bytes(k, sym), tma);
}

// The symmetric route's transposed lists, empty: (2.0, -1) entries.
__global__ void empty_lists(knn_wide::Ent* lists, size_t count) {
  for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < count;
       e += (size_t)gridDim.x * blockDim.x)
    lists[e] = knn_wide::Ent{INF_DIST, -1};
}

// SYM: the symmetric route (the top of this file); part then holds the
// transposed lists [n, k] and locks one int a column tile.  ops: the rows
// from row_start and the columns from col_start; Ring: the product's loader
// over the shared memory laid out by pl.
template <class Ring, class Order, int W, bool SYM>
__global__ void __launch_bounds__(regtile::THREADS, 1)
    knn_kernel(const __grid_constant__ regtile::Operands<float> ops,
               const regtile::Plan pl, int n, int row_start, int row_count,
               float eps, int k, int col_start, int diag_start,
               const int* __restrict__ perm, int seeded, int tiles_per_split,
               knn_wide::Ent* part, int* locks, float* out_d, int* out_i) {
  using namespace regtile;
  extern __shared__ __align__(1024) char ffma_smem[];
  // The tile's distances [128][RES_LD], in the epilogue region.
  float* Ds = reinterpret_cast<float*>(ffma_smem + pl.epi);

  const int tid = threadIdx.x;
  const int tx = thread_x(), ty = thread_y();
  const int lane = tid & 31, warp = tid >> 5;
  const int r0 = row_start + blockIdx.x * TILE;
  const int r_end = row_start + row_count;
  const int n_rows = min(TILE, r_end - r0);

  // Output row of block row rr: r0 + rr - row_start, or perm[r0 + rr].
  auto out_row = [&](int rr) -> size_t {
    return perm ? (size_t)perm[r0 + rr] : (size_t)(r0 + rr - row_start);
  };

  // The block's lists [n_rows][k] in shared memory.
  float* run_d = reinterpret_cast<float*>(ffma_smem + pl.rest);
  int* run_i = reinterpret_cast<int*>(run_d + TILE * k);
  // SYM: the warp's copy of a transposed list, each column's filter (the
  // 64 bits of an Ent), each column's flag and the block's.
  float* tr_d = reinterpret_cast<float*>(run_i + TILE * k) + warp * k;
  int* tr_i = run_i + TILE * k + WARPS * k + warp * k;
  auto* col_kth =
      reinterpret_cast<unsigned long long*>(run_i + TILE * k + 2 * WARPS * k);
  int* col_hit = reinterpret_cast<int*>(col_kth + TILE);
  int* col_any = col_hit + TILE;
  // The ids offered for the tile (perm) and the rows with a candidate.
  int* col_ids = SYM ? col_any + 4 : run_i + TILE * k;
  int* row_hit = col_ids + TILE;
  // A split (part != null) starts from empty lists: the merge of the
  // splits starts from the seed.
  const bool from_out = seeded && !part;
  for (int e = tid; e < n_rows * k; e += THREADS) {
    const int rr = e / k, s = e - rr * k;
    const size_t o = out_row(rr) * k + s;
    run_d[e] = from_out ? out_d[o] : INF_DIST;
    run_i[e] = from_out ? out_i[o] : -1;
  }
  if (tid < TILE) row_hit[tid] = 0;
  if (SYM && tid < TILE) col_hit[tid] = 0;
  if (SYM && tid == 0) *col_any = 0;
  Ring ring(ffma_smem, pl, ops, r0 - row_start);
  ring.start();   // its barrier orders these writes before any merge
  auto list_d = [&](int rr) { return run_d + rr * k; };
  auto list_i = [&](int rr) { return run_i + rr * k; };

  const int n_tiles = (n - col_start + TILE - 1) / TILE;
  int t0 = 0;
  if (diag_start && r0 >= col_start) t0 = ((r0 - col_start) / TILE) % n_tiles;
  // The first column of the s-th tile of the walk.
  auto tile_c0 = [&](int s) {
    const int t = t0 + s < n_tiles ? t0 + s : t0 + s - n_tiles;
    return col_start + t * TILE;
  };
  // SYM: block b walks its L = n_tiles - b tiles as b + (s g mod L), s = 0
  // .. L - 1, from its diagonal tile, g coprime with L near 0.618 L.  An
  // ascending walk would put the blocks of every wave after the first in
  // step (a block that starts as another ends reaches each tile together
  // with the blocks started before it), all queueing for one tile's lock;
  // with these strides (near 0.618 L, so a walk wraps about every other
  // step, at its own L), two blocks that meet on a tile part within a step
  // or two (tests/test_torch_knn_sym.py bounds how often a pair meets).
  const int sym_len = n_tiles - (int)blockIdx.x;
  const int sym_g = SYM ? sym_stride(sym_len) : 1;
  const int s_begin = SYM ? 0 : blockIdx.y * tiles_per_split;
  const int s_end = SYM ? sym_len : min(n_tiles, s_begin + tiles_per_split);
  // SYM: the column tile of step s.
  auto sym_tile = [&](int s) {
    return (int)blockIdx.x + (int)((long long)s * sym_g % sym_len);
  };
  for (int s = s_begin; s < s_end; ++s) {
    const int t = SYM ? sym_tile(s) : 0;
    const int c0 = SYM ? t * TILE : tile_c0(s);
    // The walk's next tile, whose slabs the ring may load under this one.
    const int nb = s + 1 >= s_end ? -1
                   : SYM          ? sym_tile(s + 1) * TILE
                                  : tile_c0(s + 1) - col_start;
    // SYM, past the diagonal: the tile is merged into its rows' transposed
    // lists too.  Their filters come into shared memory under the product.
    const bool trans = SYM && s > 0;
    if (trans && tid < TILE) {
      if (c0 + tid < n) {
        asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                         (unsigned)__cvta_generic_to_shared(col_kth + tid)),
                     "l"(part + (size_t)(c0 + tid) * k + k - 1)
                     : "memory");
      } else {
        col_kth[tid] = ent_bits(INF_DIST, -1);   // no row: nothing beats it
      }
    }
    if (perm && tid < TILE)
      col_ids[tid] = c0 + tid < n ? perm[c0 + tid] : INT_MAX;
    float acc[MICRO][MICRO];
    ring.product(c0 - col_start, nb, acc);
    if (trans) {   // the filters, for every thread of the epilogue
      asm volatile("cp.async.wait_all;\n" ::: "memory");
      __syncthreads();
    }
    // The masked distances into Ds; a row whose thread holds a candidate
    // better than the row's kth entry is flagged for the merge (the lists
    // do not change before it), and (SYM) a column whose thread holds a row
    // better than the column's filter.
    unsigned col_bits = 0;
#pragma unroll
    for (int i = 0; i < MICRO; ++i) {
      const int rr = ty + 16 * i;
      float kth = -1.0f;   // no candidate beats it: a row past the end
      int kth_id = -1;
      if (rr < n_rows) {
        kth = list_d(rr)[k - 1];
        kth_id = list_i(rr)[k - 1];
      }
      bool hit = false;
#pragma unroll
      for (int j = 0; j < MICRO; ++j) {
        const int col = c0 + tx + 16 * j;
        float d = 1.0f - fmaxf(acc[i][j], 0.0f);
        if (col == r0 + rr || col >= n || d > eps) d = INF_DIST;
        Ds[rr * RES_LD + tx + 16 * j] = d;
        hit |= Order::better(d, perm ? col_ids[tx + 16 * j] : col, kth,
                             kth_id);
        if (trans && rr < n_rows) {
          const unsigned long long fk = col_kth[tx + 16 * j];
          if (tile::MinLex::better(d, r0 + rr, __uint_as_float((unsigned)fk),
                                   (int)(fk >> 32)))
            col_bits |= 1u << j;
        }
      }
      if (hit) row_hit[rr] = 1;
    }
    if (col_bits) {
#pragma unroll
      for (int j = 0; j < MICRO; ++j)
        if ((col_bits >> j) & 1u) col_hit[tx + 16 * j] = 1;
      *col_any = 1;
    }
    __syncthreads();
    // SYM: lane 0 of warp 0 takes the tile's lock (its warp waiting for it)
    // while the other warps merge their own rows; the barrier after those
    // merges orders it before the transposed merges.
    const bool trans_merge = trans && *col_any;
    if (trans_merge && warp == 0) {
      if (lane == 0) lock_tile(locks + t);
      __syncwarp();
    }
    for (int rr = warp; rr < n_rows; rr += WARPS) {
      if (!row_hit[rr]) continue;
      const float* drow = Ds + rr * RES_LD;
      // Two halves of 64 columns, in ascending column order.  Their
      // ballots order every lane's read of the flag before it is cleared.
      tile::merge_row<Order, W>(drow, c0, list_d(rr), list_i(rr), k, lane,
                                perm ? col_ids : nullptr);
      tile::merge_row<Order, W>(drow + 64, c0 + 64, list_d(rr), list_i(rr),
                                k, lane, perm ? col_ids + 64 : nullptr);
      if (lane == 0) row_hit[rr] = 0;
    }
    __syncthreads();
    if (trans_merge) {
      merge_columns<W>(Ds, col_hit, r0, n_rows, part + (size_t)c0 * k, k,
                       tr_d, tr_i, warp, lane);
      // Every list written, and Ds read, before the lock goes and the next
      // tile overwrites Ds.
      __syncthreads();
      if (tid == 0) {
        *col_any = 0;
        unlock_tile(locks + t);
      }
    }
  }

  if (part && !SYM) {   // the split's partial lists [splits, row_count, k]
    knn_wide::Ent* lists =
        part + ((size_t)blockIdx.y * row_count + (r0 - row_start)) * k;
    for (int e = tid; e < n_rows * k; e += THREADS)
      lists[e] = knn_wide::Ent{run_d[e], run_i[e]};
    return;
  }
  for (int e = tid; e < n_rows * k; e += THREADS) {
    const int rr = e / k, s = e - rr * k;
    out_d[out_row(rr) * k + s] = run_d[e];
    out_i[out_row(rr) * k + s] = run_i[e];
  }
}

}  // namespace

extern "C" {

// Rows [row_start, row_start + row_count) of the unit corpus xu [n, f]
// against the columns [col_start, n) -> out_d / out_i, on the given device
// and stream.  Without perm, out is [row_count, k] in row order; with perm
// (xu permuted by it) out is [n, k] indexed by original row, and only the
// rows perm[row_start .. row_start + row_count) are written.  With seeded
// != 0, out already holds each row's sorted starting list.  With splits >
// 1 the column walk is cut into that many ranges, each writing partial
// lists into part (scratch of [splits, row_count, k] entries of 8 bytes,
// and row_count more for a wide list), which a second launch merges into
// out as it is: each row's seed or (2.0, -1) entries; a wide list (k > 128)
// always takes that second launch.  With sym != 0, the symmetric route:
// only for all n rows against all n columns, without seed, diag_start or
// perm, one split, k <= 128; part then holds n k entries of 8 bytes (the
// transposed lists) and an int a 128-column tile (the locks), and a second
// launch merges the transposed lists into out.  With tma != 0 the product's
// operands reach shared memory by TMA (F % 4 == 0, 16-byte-aligned rows),
// else by the register-staged loader; a tensor map that fails to encode
// fails the launch.  Returns the CUDA error code of the launch (0 on
// success).
int knn_launch(const float* xu, int n, int f, int row_start, int row_count,
               float eps, int k, int col_start, int diag_start,
               const int* perm, int seeded, int splits, int sym, void* part,
               float* out_d, int* out_i, int tma, int device, void* stream) {
  const int words = regtile::list_words(k);
  if (n <= 0 || f <= 0 || row_count <= 0 || words < 0 || row_start < 0 ||
      row_start + row_count > n || col_start < 0 || col_start >= n ||
      splits < 1 || (splits > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  if (sym && (row_start != 0 || row_count != n || col_start != 0 ||
              diag_start || perm || seeded || splits != 1 || words == 0 ||
              part == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (words == 0)
    return knn_wide::launch(xu, n, f, row_start, row_count, eps, k,
                            col_start, diag_start, perm, splits, part, out_d,
                            out_i, (size_t)k, 1, tma, device,
                            (cudaStream_t)stream);
  // The ring and the lists take more than the 48 KB a launch gets without
  // opting in.
  const regtile::Plan pl = block_plan(k, sym != 0, tma != 0);
  int smem_max = 0;
  err = cudaDeviceGetAttribute(&smem_max,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               device);
  if (err != cudaSuccess) return (int)err;
  if (pl.stages == 0 || pl.bytes > smem_max) return (int)cudaErrorInvalidValue;
  const int n_tiles = (n - col_start + regtile::TILE - 1) / regtile::TILE;
  const int tiles_per_split = (n_tiles + splits - 1) / splits;
  if ((splits - 1) * tiles_per_split >= n_tiles)  // every split non-empty
    return (int)cudaErrorInvalidValue;
  regtile::Operands<float> ops;
  int e = regtile::make_operands<float>(
      &ops, xu + (size_t)row_start * f, row_count, xu + (size_t)col_start * f,
      n - col_start, f, tma != 0);
  if (e != 0) return e;
  cudaStream_t st = (cudaStream_t)stream;
  knn_wide::Ent* lists = static_cast<knn_wide::Ent*>(part);
  int* locks = nullptr;
  if (sym) {
    // The transposed lists start empty and every lock free; block b (the
    // blocks start in ascending order, the longest walks first) walks
    // n_tiles - b tiles.
    locks = reinterpret_cast<int*>(lists + (size_t)n * k);
    empty_lists<<<1024, 256, 0, st>>>(lists, (size_t)n * k);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    err = cudaMemsetAsync(locks, 0, (size_t)n_tiles * sizeof(int), st);
    if (err != cudaSuccess) return (int)err;
  } else if (splits == 1) {
    lists = nullptr;
  }
  // A rotated or permuted walk, a seed list of any ids, or the transposed
  // half of the symmetric route offers ids out of order: MinLex.
  const bool lex = diag_start || perm || seeded;
  const dim3 grid(
      sym ? n_tiles : (row_count + regtile::TILE - 1) / regtile::TILE,
      splits);
  e = regtile::with_ring<float>(pl, tma != 0, [&](auto* ring) {
    using Ring = std::remove_pointer_t<decltype(ring)>;
    auto kernel = lex ? &knn_kernel<Ring, tile::MinLex, 2, false>
                      : &knn_kernel<Ring, tile::Min, 2, false>;
    if (words == 4)
      kernel = lex ? &knn_kernel<Ring, tile::MinLex, 4, false>
                   : &knn_kernel<Ring, tile::Min, 4, false>;
    if (sym)
      kernel = words == 4 ? &knn_kernel<Ring, tile::MinLex, 4, true>
                          : &knn_kernel<Ring, tile::MinLex, 2, true>;
    cudaError_t r = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, pl.bytes);
    if (r != cudaSuccess) return (int)r;
    kernel<<<grid, regtile::THREADS, pl.bytes, st>>>(
        ops, pl, n, row_start, row_count, eps, k, col_start, diag_start,
        perm, seeded, sym ? n_tiles : tiles_per_split, lists, locks, out_d,
        out_i);
    return (int)cudaGetLastError();
  });
  if (e != 0) return e;
  if (sym)
    return knn_wide::merge<knn_wide::Asc>(lists, 0, n, k, 1, nullptr, out_d,
                                          out_i, (size_t)k, 1, 0, st);
  if (splits == 1) return 0;
  return knn_wide::merge<knn_wide::Asc>(lists, row_start, row_count, k,
                                        splits, perm, out_d, out_i,
                                        (size_t)k, 1, 0, st);
}

// The shared memory of a launch of k-lists (sym: the symmetric route; a
// wide list: the wide route) with the TMA loader (tma) or the register-
// staged one: out = {stages, carry, bytes}.  Returns 0, or 1 when nothing
// fits.
int knn_plan(int k, int sym, int tma, int* out) {
  const regtile::Plan pl = regtile::list_words(k) == 0
                               ? knn_wide::scan_plan(tma != 0)
                               : block_plan(k, sym != 0, tma != 0);
  out[0] = pl.stages;
  out[1] = pl.carry;
  out[2] = pl.bytes;
  return pl.stages == 0;
}

const char* knn_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
