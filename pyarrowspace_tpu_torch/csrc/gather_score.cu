// K5: the gather and score of the selected subtiles (phase b of subtile
// serving).
//
// Replaces the TPU kernel pyarrowspace_tpu/ops/pallas/subtile_scan.py
// `_gather_score_kernel` (driven by `_gather_score_pallas`).  For every
// query q and each of its S selected subtiles sel[q, s] it writes the dot
// of the query with the subtile's 64 whole rows:
//   out[q, 64 s + r] = qn_q . xu[64 sel[q, s] + r],   r = 0..63.
// The lambda blend stays outside, in PyTorch, as it did on the TPU.
//
// Each output must be bitwise the product K3 (subtile_max.cu) computes for
// the same (row, query), so that the best blended score phase b finds in a
// subtile equals K3's maximum for it: the block-max guarantee of the
// routing.  Two routes, chosen by K3's predicate
// (ops/cuda/subtile_max.py::tensor_core_route), so the two kernels never
// route one state differently:
//
// The tensor-core route, a read-once grouped product over the buckets of
// sel (ops/cuda/gather_score.py::buckets): for each subtile the (query,
// slot) pairs that selected it.  The wrapper sorts the pairs by subtile
// and gives each bucket's range (its edges); one block a subtile takes its
// bucket in chunks of at most 256 pairs: it loads the subtile's 64 rows (A)
// and gathers the chunk's queries (B; a short chunk's rows past its end
// keep stale values, which reach only columns that are never written out)
// with cp.async into the 128-byte-swizzled layout, two 64-feature
// stages deep, and runs wgmma_tile.cuh's mainloop step: K3's instruction,
// N, k order and padding, so each element's bits are K3's.  Bound on the
// H100 by reading the selected rows once (the corpus's touched subtiles,
// 0.24 GB at 313k) and writing the Q x S x 64 cosines; the padded
// products are ~0.06 TFLOP.
//
// The SIMT route (a float32 scan state, ragged F, unaligned bases): K3's
// SIMT product, the same dot_step chain over features 0..F-1 in ascending
// order as tile_product, slab padding included.  One block of 256 threads
// per query; the block takes its subtiles four at a time, and thread t
// owns row t % 64 of subtile t / 64.  Per 32-feature slab the block stages
// the four blocks' slab in shared memory (16-byte loads when the rows are
// 16-byte aligned) and each thread advances its row's chain by 32 steps.
// It also serves compare.py::k5_blend, the witness of K2's scores, which
// passes float32 rows (bf16 rows upcast exactly).

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tile_common.cuh"
#include "wgmma_tile.cuh"

namespace {

using TC = wg::Mma<__nv_bfloat16>;   // the bf16 product K3 and K5 share

constexpr int SUBTILE = tile::TILE;
constexpr int GROUP = tile::THREADS / SUBTILE;   // subtiles per pass

// Stage the slab [f0, f0 + 32) of the GROUP subtiles g0.. into Xs as
// floats, zeros past f or past s_keep.  VEC: 16-byte loads (f * sizeof(T)
// and xu 16-byte aligned); otherwise one value a load.
template <class T, bool VEC>
__device__ __forceinline__ void stage_slab(
    const T* __restrict__ xu, int f, const int* __restrict__ my_sel,
    int s_keep, int g0, int f0, float (*Xs)[tile::SLAB][tile::PAD]) {
  using namespace tile;
  constexpr int V = VEC ? 16 / sizeof(T) : 1;   // values a load
  constexpr int PER_ROW = SLAB / V;
  constexpr int LOADS = GROUP * SUBTILE * PER_ROW;
#pragma unroll
  for (int e = 0; e < LOADS / THREADS; ++e) {
    const int idx = e * THREADS + threadIdx.x;
    const int g = idx / (SUBTILE * PER_ROW);
    const int r = (idx / PER_ROW) % SUBTILE;
    const int c = (idx % PER_ROW) * V;
    alignas(16) T v[V];
    if (g0 + g < s_keep && f0 + c < f) {
      const T* src =
          xu + ((size_t)my_sel[g0 + g] * SUBTILE + r) * f + f0 + c;
      if constexpr (VEC)
        *reinterpret_cast<uint4*>(v) = *reinterpret_cast<const uint4*>(src);
      else
        v[0] = *src;
#pragma unroll
      for (int j = 0; j < V; ++j) Xs[g][c + j][r] = to_float(v[j]);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) Xs[g][c + j][r] = 0.0f;
    }
  }
}

// At least 4 blocks an SM (64 registers a thread): the kernel is bound by
// the rows it reads, so it needs warps in flight more than registers.
template <class T, bool VEC>
__global__ void __launch_bounds__(tile::THREADS, 4)
    gather_score_kernel(const T* __restrict__ xu, int f,
                        const T* __restrict__ qn,
                        const int* __restrict__ sel, int s_keep,
                        float* __restrict__ out) {
  using namespace tile;
  __shared__ float Xs[GROUP][SLAB][PAD];
  __shared__ float Qs[SLAB];
  const int tid = threadIdx.x;
  const int qi = blockIdx.x;
  const int mine = tid / SUBTILE, row = tid % SUBTILE;
  const int* my_sel = sel + (size_t)qi * s_keep;
  const T* q_row = qn + (size_t)qi * f;

  for (int g0 = 0; g0 < s_keep; g0 += GROUP) {
    float acc = 0.0f;
    for (int f0 = 0; f0 < f; f0 += SLAB) {
      stage_slab<T, VEC>(xu, f, my_sel, s_keep, g0, f0, Xs);
      if (tid < SLAB)
        Qs[tid] = f0 + tid < f ? to_float(q_row[f0 + tid]) : 0.0f;
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < SLAB; ++kk)
        acc = dot_step(Qs[kk], Xs[mine][kk][row], acc);
      __syncthreads();
    }
    if (g0 + mine < s_keep)
      out[((size_t)qi * s_keep + g0 + mine) * SUBTILE + row] = acc;
  }
}

template <class T>
int launch(const void* xu, int f, const void* qn, const int* sel, int q,
           int s_keep, float* out, cudaStream_t st) {
  const bool vec = (f * sizeof(T)) % 16 == 0 &&
                   reinterpret_cast<std::uintptr_t>(xu) % 16 == 0;
  auto kernel = vec ? &gather_score_kernel<T, true>
                    : &gather_score_kernel<T, false>;
  kernel<<<q, tile::THREADS, 0, st>>>(static_cast<const T*>(xu), f,
                                      static_cast<const T*>(qn), sel, s_keep,
                                      out);
  return (int)cudaGetLastError();
}

// -- the tensor-core route -------------------------------------------------

constexpr int TC_STAGES = 2;
constexpr int TC_STAGE_BYTES = wg::A_BYTES + TC::B_BYTES;   // 40 KB
constexpr size_t TC_SMEM = (size_t)TC_STAGES * TC_STAGE_BYTES +
                           2 * TC::N * sizeof(int);

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

// Stage kb of a chunk into A / B: the subtile's 64 rows and the chunk's
// len queries qrow[0..len), zeros past f.  B's rows past len are not
// loaded: each output column depends on its own B row only, and the
// columns past len are never written out.
__device__ __forceinline__ void load_stage(
    const __nv_bfloat16* __restrict__ xu, const __nv_bfloat16* __restrict__ qn,
    int f, int s, const int* qrow, int len, int kb, uint8_t* a, uint8_t* b) {
  constexpr int CHUNKS = wg::ROW_BYTES / 16;       // 8 a row
  const int tid = threadIdx.x;
#pragma unroll
  for (int e = 0; e < wg::M * CHUNKS / wg::THREADS; ++e) {
    const int idx = e * wg::THREADS + tid;
    const int r = idx / CHUNKS, c = idx % CHUNKS;
    const int feat = kb * TC::KSTAGE + c * 8;
    const bool in = feat < f;
    const __nv_bfloat16* src =
        in ? xu + ((size_t)s * wg::M + r) * f + feat : xu;
    cp_async16(wg::smem_addr(a + wg::swizzle_offset(r, c)), src,
               in ? 16 : 0);
  }
  for (int idx = tid; idx < len * CHUNKS; idx += wg::THREADS) {
    const int r = idx / CHUNKS, c = idx % CHUNKS;
    const int feat = kb * TC::KSTAGE + c * 8;
    const bool in = feat < f;
    const __nv_bfloat16* src = in ? qn + (size_t)qrow[r] * f + feat : qn;
    cp_async16(wg::smem_addr(b + wg::swizzle_offset(r, c)), src,
               in ? 16 : 0);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// One block a subtile s: its bucket is the pairs order[edges[s] ..
// edges[s + 1]); chunk by chunk of at most N pairs, the mainloop over the
// subtile's rows and the chunk's queries, then out[q, 64 slot + r] for each
// pair (q, slot).
__global__ void __launch_bounds__(wg::THREADS)
    gather_score_tc_kernel(const __nv_bfloat16* __restrict__ xu, int f,
                           const __nv_bfloat16* __restrict__ qn, int s_keep,
                           const int64_t* __restrict__ edges,
                           const int64_t* __restrict__ order,
                           float* __restrict__ out) {
  extern __shared__ __align__(1024) uint8_t smem[];
  int* qrow = reinterpret_cast<int*>(smem + TC_STAGES * TC_STAGE_BYTES);
  int* ocol = qrow + TC::N;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int s = blockIdx.x;
  const int lo = (int)edges[s], hi = (int)edges[s + 1];
  const int nk = (f + TC::KSTAGE - 1) / TC::KSTAGE;
  const size_t row_len = (size_t)s_keep * wg::M;
  const int r_a = 16 * warp + (lane >> 2);

  for (int c0 = lo; c0 < hi; c0 += TC::N) {
    const int len = min(TC::N, hi - c0);
    for (int i = tid; i < len; i += wg::THREADS) {
      const int64_t p = order[c0 + i];
      qrow[i] = (int)(p / s_keep);
      ocol[i] = (int)(p % s_keep) * wg::M;
    }
    __syncthreads();

    float acc[TC::ACC];
    load_stage(xu, qn, f, s, qrow, len, 0, smem, smem + wg::A_BYTES);
    for (int kb = 0; kb < nk; ++kb) {
      uint8_t* stage = smem + (kb % TC_STAGES) * TC_STAGE_BYTES;
      if (kb + 1 < nk) {
        uint8_t* next = smem + ((kb + 1) % TC_STAGES) * TC_STAGE_BYTES;
        load_stage(xu, qn, f, s, qrow, len, kb + 1, next,
                   next + wg::A_BYTES);
        asm volatile("cp.async.wait_group 1;\n" ::: "memory");
      } else {
        asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      }
      // This thread's copies and stores are done; make them visible to
      // the tensor cores' (async) reads, then wait for everyone's.
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();
      wg::mma_stage<__nv_bfloat16>(acc, wg::smem_addr(stage),
                                   wg::smem_addr(stage + wg::A_BYTES),
                                   kb == 0);
      wg::wait<0>();
      __syncthreads();   // the stage is free for the load after next
    }

#pragma unroll
    for (int j = 0; j < TC::ACC / 4; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = 8 * j + 2 * (lane & 3) + h;
        if (col < len) {
          float* o = out + (size_t)qrow[col] * row_len + ocol[col];
          o[r_a] = acc[4 * j + h];
          o[r_a + 8] = acc[4 * j + 2 + h];
        }
      }
    }
    __syncthreads();   // qrow and ocol are refilled for the next chunk
  }
}

int launch_tc(const void* xu, int f, const void* qn, int s_keep, int n_sub,
              const int64_t* edges, const int64_t* order, float* out,
              cudaStream_t st) {
  if (!wg::route_ok<__nv_bfloat16>(xu, qn, f) || n_sub <= 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      gather_score_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)TC_SMEM);
  if (err != cudaSuccess) return (int)err;
  gather_score_tc_kernel<<<n_sub, wg::THREADS, TC_SMEM, st>>>(
      static_cast<const __nv_bfloat16*>(xu), f,
      static_cast<const __nv_bfloat16*>(qn), s_keep, edges, order, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Padded scan corpus xu [n_sub * 64, f], queries qn [q, f] (both bf16 when
// is_bf16, else float) and the selected subtiles sel [q, s_keep] (each in
// [0, n_sub)) -> out [q, s_keep * 64].  Runs on the given device and
// stream; returns the CUDA error code (0 on success).
int gather_score_launch(const void* xu, int f, const void* qn,
                        const int* sel, int q, int s_keep, int is_bf16,
                        float* out, int device, void* stream) {
  if (f <= 0 || q <= 0 || s_keep <= 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  return is_bf16 ? launch<__nv_bfloat16>(xu, f, qn, sel, q, s_keep, out, st)
                 : launch<float>(xu, f, qn, sel, q, s_keep, out, st);
}

// The tensor-core route: bf16 xu [n_sub * 64, f] and qn [q, f] (f % 8 ==
// 0, 16-byte-aligned bases), and sel [q, s_keep] as its buckets: the q *
// s_keep pair ids q * s_keep + slot sorted stably by their subtile, order,
// and edges [n_sub + 1], subtile s's pairs being order[edges[s] ..
// edges[s + 1]) (ops/cuda/gather_score.py::buckets) -> out [q, s_keep * 64].
int gather_score_tc_launch(const void* xu, int f, const void* qn, int s_keep,
                           int n_sub, const int64_t* edges,
                           const int64_t* order, float* out, int device,
                           void* stream) {
  if (f <= 0 || s_keep <= 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return launch_tc(xu, f, qn, s_keep, n_sub, edges, order, out,
                   (cudaStream_t)stream);
}

const char* gather_score_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
