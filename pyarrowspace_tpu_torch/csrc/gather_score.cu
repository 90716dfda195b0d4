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
// Each output is the same dot_step chain over features 0..F-1 in ascending
// order as the tile product of subtile_max.cu (K3), slab padding included,
// so the best blended score phase b finds in a subtile equals K3's
// maximum for it bit for bit: the block-max guarantee of the routing.
//
// What bounds it on the H100: reading the selected rows, Q x S x 64 x F
// values (1.5 MB a query at S 16, F 768 in bf16; 25.8 GB at Q 16,384),
// against 2 flops a value.  Each block reads whole 64-row blocks, which
// are contiguous in memory.
//
// The simple design: one block of 256 threads per query; the block takes
// its subtiles four at a time, and thread t owns row t % 64 of subtile
// t / 64.  Per 32-feature slab the block stages the four blocks' slab in
// shared memory, with 16-byte loads when the rows are 16-byte aligned
// (neighbouring threads read neighbouring pieces of a row), and each
// thread advances its row's chain by 32 steps.  No tensor cores: the
// chain must stay the one K3 runs.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tile_common.cuh"

namespace {

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

const char* gather_score_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
