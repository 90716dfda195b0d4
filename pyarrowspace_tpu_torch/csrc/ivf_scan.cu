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
// What bounds it on the H100: each block reads n_probe x cap x F slab
// values (12.6 MB in f32 at n_probe 8, cap 512, F 768); neighbouring sorted
// blocks probe many of the same slabs, so much of that comes from L2.  At
// 1M x 768, Q 16,384 the scan is about 1e11 flop, bound by bytes and
// latency more than by the fp32 rate.
//
// The simple design: one block of 256 threads per query block, so the
// running lists are carried inside the block across its probes (the TPU's
// sequential probe axis and its scalar prefetch become a loop that reads
// the block's own probe row).  The block's qb <= 32 queries sit in shared
// memory transposed, [F][4 * qpt] floats (48 KB at qb 16, F 768); when that
// does not fit beside the tiles (F above 3,434 at qb 16), only the current
// 32-feature slab of them does, [32][4 * qpt], staged beside the slab rows.
// Per probe it walks the slab 64 rows at a time; per 32-feature slab it
// stages the 64 rows in shared memory (16-byte loads when the rows are
// 16-byte aligned), and thread t advances row t % 64's chains for its qpt
// queries (t / 64) * qpt.. by 32 steps.  Either staging feeds each chain
// the same products in the same order, so the scores are the same bits.  Then the scores of the 64 rows go to a
// shared tile and one warp per query offers the improving ones to the
// query's list (MaxLex: slab ids arrive in slab order, not ascending).
// Lists of k <= 256 live in shared memory; longer ones (the rescored
// certificate's pool doubles with every widening round) stay in place in
// the output rows (tile_common.cuh offer_wide).

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include "tile_common.cuh"

namespace {

constexpr float NEG_INF = -3.0e38f;
constexpr int MAX_QPT = 8;                     // queries a thread
constexpr int GROUPS = tile::THREADS / tile::TILE;
constexpr int MAX_QB = GROUPS * MAX_QPT;       // 32 queries a block
constexpr size_t SMEM_LIMIT = 232448;          // a block's most, sm_90

// Stage features [f0, f0 + 32) of the 64 slab rows from row0 into Bs as
// floats, zeros past f.  VEC: 16-byte loads (f * sizeof(T) and the slabs
// 16-byte aligned); otherwise one value a load.
template <class T, bool VEC>
__device__ __forceinline__ void stage_rows(const T* __restrict__ slabs,
                                           int f, size_t row0, int f0,
                                           float (*Bs)[tile::PAD]) {
  using namespace tile;
  constexpr int V = VEC ? 16 / sizeof(T) : 1;   // values a load
  constexpr int PER_ROW = SLAB / V;
  constexpr int LOADS = TILE * PER_ROW;
#pragma unroll
  for (int e = 0; e < LOADS / THREADS; ++e) {
    const int idx = e * THREADS + threadIdx.x;
    const int r = idx / PER_ROW;
    const int c = (idx % PER_ROW) * V;
    alignas(16) T v[V];
    if (f0 + c < f) {
      const T* src = slabs + (row0 + r) * f + f0 + c;
      if constexpr (VEC)
        *reinterpret_cast<uint4*>(v) = *reinterpret_cast<const uint4*>(src);
      else
        v[0] = *src;
#pragma unroll
      for (int j = 0; j < V; ++j) Bs[c + j][r] = to_float(v[j]);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) Bs[c + j][r] = 0.0f;
    }
  }
}

// Q_SLAB: the query block is staged one 32-feature slab at a time (a
// template parameter: the whole-block path carries no branch for it).
template <class T, int W, bool VEC, bool Q_SLAB>
__global__ void __launch_bounds__(tile::THREADS)
    ivf_kernel(const T* __restrict__ slabs, const float* __restrict__ slab_lam,
               const int* __restrict__ slab_ids, int f, int cap,
               const float* __restrict__ qn, const float* __restrict__ lamq,
               const int* __restrict__ probe, int n_probe, int qb, float tau,
               int k, float* out_s, int* out_i) {
  using namespace tile;
  extern __shared__ float smem[];
  const int qpt = (qb + GROUPS - 1) / GROUPS;
  const int qstride = GROUPS * qpt;
  auto Bs = reinterpret_cast<float(*)[PAD]>(smem);    // [SLAB][PAD]
  float* Qt = smem + SLAB * PAD;   // [f][qstride], or [SLAB][qstride]
  float* Ss = Qt + (size_t)(Q_SLAB ? SLAB : f) * qstride;   // [qb][TILE]
  int* Is = reinterpret_cast<int*>(Ss + qb * TILE);   // [TILE]
  float* lists = reinterpret_cast<float*>(Is + TILE); // [qb][k] x 2

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int r = tid % TILE, q_first = (tid / TILE) * qpt;
  const size_t q0 = (size_t)blockIdx.x * qb;
  const int* my_probe = probe + (size_t)blockIdx.x * n_probe;

  if (!Q_SLAB) {
    for (int e = tid; e < f * qstride; e += THREADS) {
      const int feat = e / qstride, qq = e % qstride;
      Qt[e] = qq < qb ? qn[(q0 + qq) * f + feat] : 0.0f;
    }
  }
  float lq[MAX_QPT];
#pragma unroll
  for (int j = 0; j < MAX_QPT; ++j)
    lq[j] = (j < qpt && q_first + j < qb) ? lamq[q0 + q_first + j] : 0.0f;
  float* run_s = W == 0 ? out_s + q0 * k : lists;
  int* run_i = W == 0 ? out_i + q0 * k
                      : reinterpret_cast<int*>(lists + (size_t)qb * k);
  for (int e = tid; e < qb * k; e += THREADS) {
    run_s[e] = NEG_INF;
    run_i[e] = -1;
  }
  const float omt = 1.0f - tau;
  __syncthreads();

  for (int p = 0; p < n_probe; ++p) {
    const size_t base = (size_t)my_probe[p] * cap;
    for (int r0 = 0; r0 < cap; r0 += TILE) {
      float acc[MAX_QPT];
#pragma unroll
      for (int j = 0; j < MAX_QPT; ++j) acc[j] = 0.0f;
      for (int f0 = 0; f0 < f; f0 += SLAB) {
        stage_rows<T, VEC>(slabs, f, base + r0, f0, Bs);
        if (Q_SLAB) {
          for (int e = tid; e < SLAB * qstride; e += THREADS) {
            const int feat = f0 + e / qstride, qq = e % qstride;
            Qt[e] = (qq < qb && feat < f) ? qn[(q0 + qq) * f + feat] : 0.0f;
          }
        }
        __syncthreads();
        const int nf = min(SLAB, f - f0);
        const float* qcol =
            Qt + (Q_SLAB ? (size_t)0 : (size_t)f0 * qstride) + q_first;
#pragma unroll 4
        for (int kk = 0; kk < nf; ++kk) {
          const float x = Bs[kk][r];
#pragma unroll
          for (int j = 0; j < MAX_QPT; ++j)
            if (j < qpt) acc[j] = dot_step(qcol[kk * qstride + j], x, acc[j]);
        }
        __syncthreads();
      }
      const size_t row = base + r0 + r;
      const int id = slab_ids[row];
      const float lam = slab_lam[row];
#pragma unroll
      for (int j = 0; j < MAX_QPT; ++j) {
        const int qq = q_first + j;
        if (j < qpt && qq < qb)
          Ss[qq * TILE + r] =
              id < 0 ? NEG_INF : blend(tau, omt, acc[j], lam, lq[j]);
      }
      if (tid < TILE) Is[r] = id;
      __syncthreads();
      for (int qq = warp; qq < qb; qq += WARPS)
        merge_row<MaxLex, W>(Ss + qq * TILE, 0, run_s + (size_t)qq * k,
                             run_i + (size_t)qq * k, k, lane, Is);
      __syncthreads();
    }
  }

  if (W != 0) {
    for (int e = tid; e < qb * k; e += THREADS) {
      out_s[q0 * k + e] = run_s[e];
      out_i[q0 * k + e] = run_i[e];
    }
  }
}

// Shared memory of a block besides its lists: the slab tile, q_rows
// feature rows of the transposed query block, the score tile and its ids.
size_t fixed_smem(int qb, int q_rows) {
  using namespace tile;
  const int qpt = (qb + GROUPS - 1) / GROUPS;
  return sizeof(float) * (SLAB * PAD + (size_t)q_rows * GROUPS * qpt +
                          (size_t)qb * TILE) +
         sizeof(int) * TILE;
}

template <class T, bool VEC, bool Q_SLAB>
int launch_t(const void* slabs, const float* slab_lam, const int* slab_ids,
             int f, int cap, const float* qn, const float* lamq,
             const int* probe, int n_blocks, int n_probe, int qb, float tau,
             int k, float* out_s, int* out_i, cudaStream_t st) {
  using namespace tile;
  const size_t fixed = fixed_smem(qb, Q_SLAB ? SLAB : f);
  const size_t narrow = (size_t)qb * k * (sizeof(float) + sizeof(int));
  int words = list_words(k);
  // Narrow lists that do not fit beside the queries go wide.
  if (words > 0 && fixed + narrow > SMEM_LIMIT) words = 0;
  const size_t smem = fixed + (words == 0 ? 0 : narrow);
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  auto kernel = &ivf_kernel<T, 0, VEC, Q_SLAB>;
  if (words == 2) kernel = &ivf_kernel<T, 2, VEC, Q_SLAB>;
  if (words == 4) kernel = &ivf_kernel<T, 4, VEC, Q_SLAB>;
  if (words == 8) kernel = &ivf_kernel<T, 8, VEC, Q_SLAB>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<n_blocks, THREADS, smem, st>>>(
      static_cast<const T*>(slabs), slab_lam, slab_ids, f, cap, qn, lamq,
      probe, n_probe, qb, tau, k, out_s, out_i);
  return (int)cudaGetLastError();
}

template <class T>
int launch(const void* slabs, const float* slab_lam, const int* slab_ids,
           int f, int cap, const float* qn, const float* lamq,
           const int* probe, int n_blocks, int n_probe, int qb, float tau,
           int k, float* out_s, int* out_i, cudaStream_t st) {
  const bool vec = (f * sizeof(T)) % 16 == 0 &&
                   reinterpret_cast<std::uintptr_t>(slabs) % 16 == 0;
  // The whole query block when it fits beside the tiles, else one slab.
  const bool q_slab = fixed_smem(qb, f) > SMEM_LIMIT;
  auto fn = vec ? (q_slab ? &launch_t<T, true, true>
                          : &launch_t<T, true, false>)
                : (q_slab ? &launch_t<T, false, true>
                          : &launch_t<T, false, false>);
  return fn(slabs, slab_lam, slab_ids, f, cap, qn, lamq, probe, n_blocks,
            n_probe, qb, tau, k, out_s, out_i, st);
}

}  // namespace

extern "C" {

// Slabs [n_clusters * cap, f] (dtype 0 float, 1 bf16, 2 f16) with their
// lambdas and ids [n_clusters * cap], queries qn [n_blocks * qb, f] and
// lamq [n_blocks * qb] (float), the probe table [n_blocks, n_probe] (each
// entry in [0, n_clusters)) -> out_s / out_i [n_blocks * qb, k].  cap is a
// multiple of 64, qb <= 32, k >= 1.  Runs on the given device and
// stream; returns the CUDA error code (0 on success).
int ivf_scan_launch(const void* slabs, int dtype, const float* slab_lam,
                    const int* slab_ids, int f, int cap, const float* qn,
                    const float* lamq, const int* probe, int n_blocks,
                    int n_probe, int qb, float tau, int k, float* out_s,
                    int* out_i, int device, void* stream) {
  if (f <= 0 || cap <= 0 || cap % tile::TILE != 0 || n_blocks <= 0 ||
      n_probe <= 0 || qb <= 0 || qb > MAX_QB || tile::list_words(k) < 0 ||
      dtype < 0 || dtype > 2)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1)
    return launch<__nv_bfloat16>(slabs, slab_lam, slab_ids, f, cap, qn, lamq,
                                 probe, n_blocks, n_probe, qb, tau, k, out_s,
                                 out_i, st);
  if (dtype == 2)
    return launch<__half>(slabs, slab_lam, slab_ids, f, cap, qn, lamq, probe,
                          n_blocks, n_probe, qb, tau, k, out_s, out_i, st);
  return launch<float>(slabs, slab_lam, slab_ids, f, cap, qn, lamq, probe,
                       n_blocks, n_probe, qb, tau, k, out_s, out_i, st);
}

const char* ivf_scan_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
