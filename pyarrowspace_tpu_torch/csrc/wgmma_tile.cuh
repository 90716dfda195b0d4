// The tensor-core products of the port on Hopper's warpgroup MMA, generic
// over the operand type and the width of B: bf16 (K3, subtile_max.cu; K5,
// gather_score.cu: m64n256k16, fp32 sums; K2 over bf16 rows, scan_topk.cu:
// m64n128k16) and int8 (K7's tensor-core route, scan_int8.cu: m64n128k32,
// int32 sums).  All keep the same shared-memory stages: one 128-byte row
// a stage (64 bf16 or 128 int8 features), four 32-byte k steps over
// ascending features, the same descriptors, TMA tensor maps, swizzle and
// mbarrier ring; only the instruction, the descriptors' element type, the
// width N and the accumulators' type differ (Mma<E, N> below).
//
// The block-max guarantee of subtile serving needs K3's maximum of a
// subtile to equal, bit for bit, the best score K5 + the blend give inside
// it.  Both kernels therefore compute every (row, query) element with the
// same instruction sequence on the same operands:
//   - A: 64 corpus rows (the subtile), K-major, from xu_scan [N_pad, F];
//   - B: N queries, K-major (K3: a contiguous block of the batch; K5: the
//     queries that selected the subtile, gathered);
//   - features in stages of 64 (one 128-byte row a stage), padded with
//     zeros past F to the next multiple of 64;
//   - per stage four wgmma.mma_async m64n256k16 f32.bf16.bf16 steps over
//     ascending features, the very first step with scale-d 0.
// An element's sum depends only on its A row and its B column, not on the
// column's position in B (K3 and K5 place a query at different columns):
// the tensor core computes each output element on its own.  K2 over bf16
// rows runs the same k steps with the roles swapped (queries as A, corpus
// rows as B, m64n128k16); compare.py::k5_blend holds its scores to K5's bit
// for bit on the card.  K7's int32 sums are exact, so its products are the
// plain version's in any order.
//
// Shared-memory operand layout: rows of 128 bytes with the 128-byte
// swizzle (16-byte chunk c of row r stored at chunk c ^ (r % 8)), 8-row
// groups 1,024 bytes apart, every tile 1,024-byte aligned: the layout TMA
// writes with CU_TENSOR_MAP_SWIZZLE_128B and that cp.async copies write by
// hand (swizzle_offset).  wgmma takes both 8-bit operands K-major only,
// which corpus rows and query rows ([rows, F], row-major) are.
//
// Accumulator fragment of m64nNkK (PTX ISA, "wgmma D fragment", the same
// for fp32 and int32 sums): thread t of the warpgroup (warp w = t / 32,
// lane l) holds d[i], i < N / 2, for
//   row 16 w + l / 4 + 8 ((i / 2) % 2),  column 8 (i / 4) + 2 (l % 4) + i % 2.

#pragma once

#include <cstdint>

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace wg {

constexpr int M = 64;              // rows of A
constexpr int ROW_BYTES = 128;     // a stage: one 128-byte row of A and B
constexpr int A_BYTES = M * ROW_BYTES;   // 8 KB
constexpr int THREADS = 128;       // one warpgroup

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of the 16-byte chunk c of row r in a 128-byte-swizzled tile.
__device__ __forceinline__ uint32_t swizzle_offset(int r, int c) {
  return static_cast<uint32_t>(r * ROW_BYTES + ((c ^ (r & 7)) << 4));
}

// Matrix descriptor of a K-major, 128-byte-swizzled tile at shared address
// addr (1,024-byte aligned, or advanced by a multiple of 32 bytes within
// the row for a later k step): stride 1,024 bytes between 8-row groups.
__device__ __forceinline__ uint64_t descriptor(uint32_t addr) {
  uint64_t d = (addr & 0x3FFFF) >> 4;
  d |= uint64_t(1) << 16;                 // leading offset (unused here)
  d |= uint64_t(1024 >> 4) << 32;         // stride offset
  d |= uint64_t(1) << 62;                 // 128-byte swizzle
  return d;
}

__device__ __forceinline__ void fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int PENDING>
__device__ __forceinline__ void wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(PENDING)
               : "memory");
}

// The product of one operand type E and B width N (by default 256 for
// bf16, 128 for int8): its accumulators (Acc, ACC a thread), the features
// a stage (KSTAGE), the bytes of a B stage, the tensor maps' element type,
// and one 32-byte k step d (+)= A[64 x k] * B[k x N]^T (scale_d 0
// overwrites d).
template <class E, int N = sizeof(E) == 1 ? 128 : 256>
struct Mma;

template <>
struct Mma<__nv_bfloat16, 256> {
  using Acc = float;
  static constexpr int N = 256;
  static constexpr int ACC = N / 2;
  static constexpr int KSTAGE = ROW_BYTES / 2;
  static constexpr int B_BYTES = N * ROW_BYTES;   // 32 KB
  static constexpr CUtensorMapDataType MAP_TYPE =
      CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;

  static __device__ __forceinline__ void step(float (&d)[ACC], uint64_t da,
                                              uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, "
        "%88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, "
        "%104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, "
        "%120, %121, %122, %123, %124, %125, %126, %127}, "
        "%128, %129, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
          "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
          "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
          "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
          "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
          "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
          "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
          "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
          "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
          "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
          "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <>
struct Mma<__nv_bfloat16, 128> {
  using Acc = float;
  static constexpr int N = 128;
  static constexpr int ACC = N / 2;
  static constexpr int KSTAGE = ROW_BYTES / 2;
  static constexpr int B_BYTES = N * ROW_BYTES;   // 16 KB
  static constexpr CUtensorMapDataType MAP_TYPE =
      CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;

  static __device__ __forceinline__ void step(float (&d)[ACC], uint64_t da,
                                              uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <>
struct Mma<int8_t, 128> {
  using Acc = int;
  static constexpr int N = 128;
  static constexpr int ACC = N / 2;
  static constexpr int KSTAGE = ROW_BYTES;
  static constexpr int B_BYTES = N * ROW_BYTES;   // 16 KB
  static constexpr CUtensorMapDataType MAP_TYPE =
      CU_TENSOR_MAP_DATA_TYPE_UINT8;

  // Integer wgmma has no scale or transpose immediates: both operands
  // K-major.
  static __device__ __forceinline__ void step(int (&d)[ACC], uint64_t da,
                                              uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
          "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
          "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
          "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
          "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
          "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
          "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
          "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
          "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
          "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
          "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
          "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

// The shared mainloop step: one stage (one 128-byte row of A and of B), A
// at shared address a (64 rows), B at b (N rows), both 128-byte swizzled.
// The four 32-byte k steps go in ascending feature order; the first step
// of the first stage (first_stage) starts the sums from zero.  Issues and
// commits one group; the caller waits for it.
template <class E, int N = Mma<E>::N>
__device__ __forceinline__ void mma_stage(
    typename Mma<E, N>::Acc (&d)[Mma<E, N>::ACC], uint32_t a, uint32_t b,
    bool first_stage) {
  fence();
#pragma unroll
  for (int k = 0; k < ROW_BYTES / 32; ++k)
    Mma<E, N>::step(d, descriptor(a + 32 * k), descriptor(b + 32 * k),
                    (first_stage && k == 0) ? 0 : 1);
  commit();
}

// -- mbarriers and TMA ---------------------------------------------------

__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void bar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}
__device__ __forceinline__ void bar_expect(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}
// Wait until the barrier's phase with the given parity has completed.
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}
// TMA: the box at (feature, row) of map into shared memory dst, counted
// against bar's transaction bytes.  Rows and features past the tensor's
// end arrive as zeros.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int feature,
                                         int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)),
      "r"(feature), "r"(row)
      : "memory");
}

// -- thread-block clusters -----------------------------------------------
//
// A launch with no cluster attribute is a cluster of one block: rank 0 of
// size 1, and every helper below works there too.

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
// Every thread of the cluster that has not exited: the writes before it
// (barrier inits included) are visible to the cluster after it.
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release;\nbarrier.cluster.wait.acquire;\n" ::
          : "memory");
}
// Arrive on the barrier at bar's offset in the shared memory of block cta
// of the cluster (this block's own when cta is its rank), with bar_arrive's
// semantics (a release at the scope of the block: one at the cluster's
// scope, after each stage, stalled K3's products in flight).
__device__ __forceinline__ void bar_arrive_cluster(uint64_t* bar,
                                                   uint32_t cta) {
  asm volatile(
      "{\n.reg .b32 remote;\nmapa.shared::cluster.u32 remote, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [remote];\n}\n" ::"r"(
          smem_addr(bar)),
      "r"(cta)
      : "memory");
}
// tma_load into dst's offset in the shared memory of every block of the
// cluster in cta_mask (bit r: rank r), each copy counted against the
// barrier at bar's offset in its own block.
__device__ __forceinline__ void tma_load_multicast(void* dst,
                                                   const CUtensorMap* map,
                                                   uint64_t* bar, int feature,
                                                   int row,
                                                   uint16_t cta_mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.multicast::cluster [%0], [%1, {%3, %4}], [%2], %5;\n" ::"r"(
          smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)),
      "r"(feature), "r"(row), "h"(cta_mask)
      : "memory");
}

// -- host: tensor maps ---------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the runtime's entry-point
// query (the libraries link only cudart); null where it is missing.
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &res);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &res);
#endif
    if (err == cudaSuccess && res == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A tensor map of the matrix [rows, f] of elements of `type` (elem bytes
// each; row-major, f * elem a multiple of 16, base 16-byte aligned) read in
// boxes of box_rows rows x box_cols elements (128 bytes: one stage),
// 128-byte swizzled, zeros past the ends.  Returns false on failure.
inline bool make_map_2d(CUtensorMap* map, CUtensorMapDataType type,
                        size_t elem, const void* base, uint64_t rows,
                        uint64_t f, uint32_t box_cols, uint32_t box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {f, rows};
  const cuuint64_t strides[1] = {f * elem};
  const cuuint32_t box[2] = {box_cols, box_rows};
  const cuuint32_t el[2] = {1, 1};
  return fn(map, type, 2, const_cast<void*>(base), dims, strides, box, el,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// make_map_2d for the operands of Mma<E>: boxes of one stage.
template <class E>
inline bool make_map(CUtensorMap* map, const void* base, uint64_t rows,
                     uint64_t f, uint32_t box_rows) {
  return make_map_2d(map, Mma<E>::MAP_TYPE, sizeof(E), base, rows, f,
                     static_cast<uint32_t>(Mma<E>::KSTAGE), box_rows);
}

// The route's conditions on the host: rows of f values of E a multiple of
// 16 bytes (TMA's stride rule) and 16-byte-aligned bases.
template <class E>
inline bool route_ok(const void* a, const void* b, int f) {
  return f > 0 && (f * sizeof(E)) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(b) % 16 == 0;
}

}  // namespace wg
