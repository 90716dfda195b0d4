// K4a and K4b: per-row top-m extraction of subtile serving.
//
// Replaces the TPU kernels pyarrowspace_tpu/ops/pallas/subtile_scan.py
// `_extract_iota_kernel_t` (K4b, driven by `_extract_ids_pallas_t`: the
// one-level top-S subtile select, ids are column numbers) and
// `_extract_kernel` (K4a, driven by `_extract_pool_pallas`: the pool cut
// and the two-level select, ids come from a cand array).  The TPU kernels
// extract m times: take the row's max, ties to the smallest id, eliminate
// that id.  These kernels compute what that sequence computes on its
// contract (distinct ids in a row, every value above -3e38), for any float
// row: out[r, 0..m) holds the ids of the row's m greatest entries in the
// order (value desc, id asc), -0.0 equal to +0.0, ±inf ordinary values and
// NaN below every number (select.cuh).
//
// What bounds it on the H100: reading each row once (Q x M floats: 82 MB
// for K4b at 313k, Q 4,096; 1 GB of K3's maxima at 1M rows and Q 16,384).
// The first design offered each candidate to a sorted list, one warp-wide
// insertion at a time, about m (1 + ln(M / m)) latency-bound insertions a
// row.  This one is a threshold select (select.cuh) by persistent blocks,
// each walking rows blockIdx.x, + gridDim.x, ... (64 threads for rows of
// at most 2,048 entries, so that up to 32 rows are in flight on an SM, else
// 256).  A row comes into shared memory once (a 1-D bulk copy on an
// mbarrier where the rows are 16-byte aligned and a multiple of 16 bytes
// long, else 4-byte loads), with the next row's copy in flight where a
// second slot costs no resident block; then only shared-memory passes: for
// narrow m a group-maximum threshold, a float compare and a register sort
// of the few candidates, for wider m (or heavy ties) a radix select of the
// keys, a compaction and a bitonic sort of the m survivors.  A row whose
// floats and buffer do not fit in shared memory takes the radix select
// through device memory, one block a row: each pass reads the row again
// and the buffer is a scratch row.  A row costs a few thousand cycles of
// latency-bound passes behind block barriers, so the more rows an SM
// holds, the closer the select comes to its bytes.
//
// Routes (extract.route_name, the one predicate; the launchers check it):
//   0 narrow: shared memory, m <= NARROW_MAX (the path's 16 and 30);
//   1 radix:  shared memory, larger m;
//   2 device: the row and its buffer past shared memory.

#include <algorithm>
#include <cstdint>

#include <cuda_runtime.h>

#include "select.cuh"

namespace {

enum Route { NARROW = 0, RADIX = 1, DEVICE = 2 };

constexpr int WIDE = 256;        // threads a block, for rows past SHORT_ROW
constexpr int SHORT_ROW = 2048;

// Dynamic shared memory a block may take (232,448 bytes on the H100, less
// the static Scratch and a margin).
constexpr int MAX_DYNAMIC = 232448 - 4096;

// Buffer entries of a row: m rounded up to a power of two (the bitonic
// sort's size), at least the narrow route's candidates.
int buffer_entries(int m, int route) {
  const int p = sel::pow2_at_least(m);
  return route == NARROW && p < sel::NARROW_CAP ? sel::NARROW_CAP : p;
}

size_t shared_bytes(int len, int m, int route) {
  return 4 * (size_t)((len + 3) & ~3) + 8 * (size_t)buffer_entries(m, route);
}

int route_of(int len, int m) {
  const int r = m <= sel::NARROW_MAX ? NARROW : RADIX;
  return shared_bytes(len, m, r) <= (size_t)MAX_DYNAMIC ? r : DEVICE;
}

// The m greatest entries of one row, written to out_row in order.  With
// kShared the row's floats are in shared memory (vals, 16-byte aligned,
// padded with NaN to a multiple of 4) and buf is a shared buffer; else the
// row is read from device memory (row) at each pass and buf is a scratch
// row.  Every thread of the block calls it; it ends with a barrier, after
// which vals, buf and sh may be reused.
template <bool kPool, bool kShared, int THREADS>
__device__ void select_row(float* vals, const float* __restrict__ row,
                           const int* __restrict__ ids, int len, int m,
                           int cap, bool narrow, bool ids_vec, uint64_t* buf,
                           int* out_row, sel::Scratch<THREADS>& sh) {
  using namespace sel;
  const int tid = threadIdx.x;
  uint32_t* keys = reinterpret_cast<uint32_t*>(vals);
  auto id_at = [&](int j) { return kPool ? ids[j] : j; };
  auto key_at = [&](int j, uint32_t& k) {
    k = kShared ? keys[j] : order_key(__ldg(row + j));
    return true;
  };
  if (tid == 0) sh.fill = 0;

  if (kShared && narrow) {
    const int len4 = (len + 3) >> 2;
    const float4* v4 = reinterpret_cast<const float4*>(vals);
    // K4a's ids of a thread's first AHEAD float4s, read ahead where the id
    // rows are 16-byte aligned: their latency hides under the first pass
    // and the threshold.
    constexpr int AHEAD = 2;
    int4 ahead[AHEAD];
#pragma unroll
    for (int r = 0; r < AHEAD; ++r) {
      const int q = tid + r * THREADS;
      ahead[r] = kPool && ids_vec && q < len4
                     ? __ldg(reinterpret_cast<const int4*>(ids) + q)
                     : make_int4(0, 0, 0, 0);
    }
    // Each thread's floats are a group: fmaxf skips NaN, and an empty or
    // all-NaN group keeps NaN, key 0.
    float g = __uint_as_float(0x7fffffffu);
#pragma unroll 4
    for (int q = tid; q < len4; q += THREADS) {
      const float4 x = v4[q];
      g = fmaxf(g, fmaxf(fmaxf(x.x, x.y), fmaxf(x.z, x.w)));
    }
    sh.group_max[tid] = order_key(g);
    __syncthreads();
    if (tid < 32) {
      const uint32_t t = group_threshold(sh, m);
      if (tid == 0) sh.threshold = t;
    }
    __syncthreads();
    // The candidates: keys >= tau, a float compare (a NaN never passes;
    // -0.0 >= +0.0).  tau is NaN's key only when fewer than m groups hold
    // a number: such rows go to the radix select.
    const uint32_t tau = sh.threshold;
    const float tf = key_value(tau);
    auto candidates = [&](int q, int4 idv, bool have) {
      const float4 x = q < len4 ? v4[q] : make_float4(0.f, 0.f, 0.f, 0.f);
      const bool any = q < len4 && (x.x >= tf || x.y >= tf || x.z >= tf ||
                                    x.w >= tf);
      if (!__any_sync(FULL, any)) return;
      // The rare warp with a candidate: one slot claim for the warp.
      const float xs[4] = {x.x, x.y, x.z, x.w};
      const int is[4] = {idv.x, idv.y, idv.z, idv.w};
      bool take[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        take[i] = any && xs[i] >= tf && 4 * q + i < len;
      int pos = warp_claim(take[0] + take[1] + take[2] + take[3], &sh.fill);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (take[i] && pos < cap)
          buf[pos] = entry(order_key(xs[i]),
                           kPool && have ? is[i] : id_at(4 * q + i));
        pos += take[i];
      }
    };
    if (tau != 0) {
      int q0 = 0;
#pragma unroll
      for (int r = 0; r < AHEAD; ++r, q0 += THREADS)
        if (q0 < len4) candidates(q0 + tid, ahead[r], ids_vec);
#pragma unroll 4
      for (; q0 < len4; q0 += THREADS)
        candidates(q0 + tid, make_int4(0, 0, 0, 0), false);
    }
    __syncthreads();
    const int n = tau != 0 ? sh.fill : cap + 1;
    if (n <= 64) {
      // The usual case: a sort in warp 0's registers.
      if (tid < 32) {
        if (n <= 32) {
          uint64_t v[1] = {tid < n ? buf[tid] : 0};
          warp_sort_desc<1>(v);
          if (tid < m) out_row[tid] = entry_id(v[0]);
        } else {
          uint64_t v[2] = {buf[tid], tid + 32 < n ? buf[tid + 32] : 0};
          warp_sort_desc<2>(v);
          if (tid < m) out_row[tid] = entry_id(v[0]);
          if (tid + 32 < m) out_row[tid + 32] = entry_id(v[1]);
        }
      }
      __syncthreads();
      return;
    }
    if (n <= cap) {
      const int p = pow2_at_least(n);
      for (int i = n + tid; i < p; i += THREADS) buf[i] = 0;
      __syncthreads();
      sort_desc<THREADS>(buf, p);
      __syncthreads();
      for (int i = tid; i < m; i += THREADS) out_row[i] = entry_id(buf[i]);
      __syncthreads();
      return;
    }
    // Heavy ties: more candidates than the buffer holds.  Every thread has
    // read the count; block_and_or's barriers order the reset.
    __syncthreads();
    if (tid == 0) sh.fill = 0;
  }

  // The radix select: the keys (in place in shared memory) with their AND
  // and OR.
  uint32_t a = FULL, o = 0;
  for (int j = tid; j < len; j += THREADS) {
    const uint32_t k = order_key(kShared ? vals[j] : __ldg(row + j));
    if (kShared) keys[j] = k;
    a &= k;
    o |= k;
  }
  block_and_or(a, o, sh);   // also orders the keys' writes before reads
  const Cut c = radix_select(key_at, len, m, len, a, o, sh);
  auto emit = [&](bool take, uint32_t k, int j) {
    const int pos = warp_claim(take, &sh.fill);
    if (take && pos < cap) buf[pos] = entry(k, id_at(j));
  };
  if (c.all_ge) {
    for (int j0 = 0; j0 < len; j0 += THREADS) {
      const int j = j0 + tid;
      uint32_t k = 0;
      if (j < len) key_at(j, k);
      emit(j < len && k >= c.t, k, j);
    }
  } else if (!kPool) {
    // Every key above T, then the first c.need ties in column order: each
    // thread counts the ties of its own run of columns.
    for (int j0 = 0; j0 < len; j0 += THREADS) {
      const int j = j0 + tid;
      uint32_t k = 0;
      if (j < len) key_at(j, k);
      emit(j < len && k > c.t, k, j);
    }
    const int run = (len + THREADS - 1) / THREADS;
    const int lo = min(len, tid * run), hi = min(len, lo + run);
    int ties = 0;
    for (int j = lo; j < hi; ++j) {
      uint32_t k;
      key_at(j, k);
      ties += k == c.t;
    }
    int rank = block_exclusive_scan(ties, sh);
    for (int j = lo; j < hi && rank < c.need; ++j) {
      uint32_t k;
      key_at(j, k);
      if (k == c.t) {
        const int pos = atomicAdd(&sh.fill, 1);
        if (pos < cap) buf[pos] = entry(k, j);
        ++rank;
      }
    }
  } else {
    // Every key above T, then the c.need smallest ids among the ties: a
    // second select, on the ties' id keys.
    auto tie_key = [&](int j, uint32_t& k2) {
      uint32_t k;
      key_at(j, k);
      if (k != c.t) return false;
      k2 = id_key(ids[j]);
      return true;
    };
    uint32_t a2 = FULL, o2 = 0;
    for (int j = tid; j < len; j += THREADS) {
      uint32_t k2;
      if (tie_key(j, k2)) {
        a2 &= k2;
        o2 |= k2;
      }
    }
    block_and_or(a2, o2, sh);
    const Cut c2 = radix_select(tie_key, len, c.need, c.eq, a2, o2, sh);
    for (int j0 = 0; j0 < len; j0 += THREADS) {
      const int j = j0 + tid;
      uint32_t k = 0;
      if (j < len) key_at(j, k);
      emit(j < len && (k > c.t || (k == c.t && id_key(ids[j]) >= c2.t)), k,
           j);
    }
  }
  __syncthreads();
  const int p = pow2_at_least(m);
  for (int i = m + tid; i < p; i += THREADS) buf[i] = 0;
  __syncthreads();
  sort_desc<THREADS>(buf, p);
  __syncthreads();
  for (int i = tid; i < m; i += THREADS) out_row[i] = entry_id(buf[i]);
  __syncthreads();
}

// The shared-memory routes: persistent blocks, each walking rows blockIdx.x,
// + gridDim.x, ...; with `slots` 2 the next row's bulk copy is in flight
// while a row is selected.  Rows that are not 16-byte aligned (bulk 0) are
// loaded by the block itself.
template <bool kPool, int THREADS>
__global__ void __launch_bounds__(THREADS)
    select_shared(const float* __restrict__ score,
                  const int* __restrict__ cand, int rows, int len, int m,
                  int cap, int narrow, int bulk, int ids_vec, int slots,
                  int* __restrict__ out) {
  using namespace sel;
  __shared__ Scratch<THREADS> sh;
  extern __shared__ __align__(16) unsigned char dyn[];
  const int tid = threadIdx.x;
  const int stride = (len + 3) & ~3;
  float* slot0 = reinterpret_cast<float*>(dyn);
  uint64_t* buf = reinterpret_cast<uint64_t*>(slot0 + slots * stride);
  const int first = blockIdx.x, step = gridDim.x;
  if (bulk && tid == 0) {
    bulk_init(&sh.bar[0]);
    bulk_init(&sh.bar[1]);
    for (int s = 0; s < slots; ++s) {
      const int r = first + s * step;
      if (r < rows)
        bulk_copy(slot0 + s * stride, score + (size_t)r * len, 4 * len,
                  &sh.bar[s]);
    }
  }
  __syncthreads();   // the barriers' init before any wait
  int i = 0;
  for (int r = first; r < rows; r += step, ++i) {
    const int s = i % slots;
    float* vals = slot0 + s * stride;
    const float* row = score + (size_t)r * len;
    if (bulk) {
      bulk_wait(&sh.bar[s], (i / slots) & 1);
    } else {
      for (int j = tid; j < stride; j += THREADS)
        vals[j] = j < len ? __ldg(row + j) : __uint_as_float(0x7fffffffu);
      __syncthreads();
    }
    select_row<kPool, true, THREADS>(vals, row, kPool ? cand + (size_t)r * len : nullptr,
                            len, m, cap, narrow != 0, ids_vec != 0, buf,
                            out + (size_t)r * m, sh);
    const int next = r + slots * step;
    if (bulk && tid == 0 && next < rows) {
      bulk_fence();
      bulk_copy(vals, score + (size_t)next * len, 4 * len, &sh.bar[s]);
    }
  }
}

// The device route: one block of WIDE a row, its buffer a scratch row.
template <bool kPool>
__global__ void __launch_bounds__(WIDE)
    select_device(const float* __restrict__ score,
                  const int* __restrict__ cand, int len, int m, int cap,
                  unsigned long long* scratch, int* __restrict__ out) {
  __shared__ sel::Scratch<WIDE> sh;
  const size_t r = blockIdx.x;
  select_row<kPool, false, WIDE>(
      nullptr, score + r * len, kPool ? cand + r * len : nullptr, len, m,
      cap, false, false, reinterpret_cast<uint64_t*>(scratch) + r * cap,
      out + r * m, sh);
}

// The shared routes' launch with blocks of THREADS.  A second row slot
// (the next row's copy in flight during a select) only where it costs no
// resident block: the selects are latency-bound, and more rows in flight on
// an SM hide more of it.
template <bool kPool, int THREADS>
int launch_shared(const float* score, const int* cand, int rows, int len,
                  int m, int route, int* out, cudaStream_t st) {
  const int cap = buffer_entries(m, route);
  const int bulk =
      len % 4 == 0 && reinterpret_cast<uintptr_t>(score) % 16 == 0;
  const int ids_vec =
      len % 4 == 0 && reinterpret_cast<uintptr_t>(cand) % 16 == 0;
  auto kernel = &select_shared<kPool, THREADS>;
  const size_t one = shared_bytes(len, m, route);
  const size_t two = one + 4 * (size_t)((len + 3) & ~3);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)(two <= (size_t)MAX_DYNAMIC ? two : one));
  int per_one = 0, per_two = 0, sms = 0, device = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_one, kernel,
                                                        THREADS, one);
  if (err == cudaSuccess && two <= (size_t)MAX_DYNAMIC)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_two, kernel,
                                                        THREADS, two);
  if (err != cudaSuccess) return (int)err;
  const int slots = per_two == per_one ? 2 : 1;
  const int per_sm = slots == 2 ? per_two : per_one;
  const size_t smem = slots == 2 ? two : one;
  const int grid =
      (int)std::min<long long>(rows, (long long)std::max(1, per_sm) * sms);
  kernel<<<grid, THREADS, smem, st>>>(score, cand, rows, len, m, cap,
                                      route == NARROW, bulk, ids_vec, slots,
                                      out);
  return (int)cudaGetLastError();
}

// Rows of at most SHORT_ROW entries go to blocks of 64 threads (up to 32
// rows in flight on an SM instead of 8), longer ones to blocks of WIDE.
template <bool kPool>
int launch(const float* score, const int* cand, int rows, int len, int m,
           int route, unsigned long long* scratch, int* out,
           cudaStream_t st) {
  if (route == DEVICE) {
    select_device<kPool><<<rows, WIDE, 0, st>>>(
        score, cand, len, m, buffer_entries(m, route), scratch, out);
    return (int)cudaGetLastError();
  }
  return len <= SHORT_ROW
             ? launch_shared<kPool, 64>(score, cand, rows, len, m, route, out,
                                        st)
             : launch_shared<kPool, WIDE>(score, cand, rows, len, m, route,
                                          out, st);
}

int check(int rows, int len, int m, int route,
          const unsigned long long* scratch, int device) {
  if (rows <= 0 || len <= 0 || m < 1 || m > len ||
      route != route_of(len, m) || (route == DEVICE && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  return (int)cudaSetDevice(device);
}

}  // namespace

extern "C" {

// K4b: out [rows, m] = per row of score [rows, len], the columns of the m
// greatest values in (value desc, column asc) order.  route must be
// route_of(len, m) (extract.route_name); scratch is [rows, pow2(m)] 64-bit
// words for the device route (may be null otherwise).  Returns the CUDA error code
// (0 on success).
int extract_ids_launch(const float* score, int rows, int len, int m,
                       int route, unsigned long long* scratch, int* out,
                       int device, void* stream) {
  const int err = check(rows, len, m, route, scratch, device);
  if (err != 0) return err;
  return launch<false>(score, nullptr, rows, len, m, route, scratch, out,
                       (cudaStream_t)stream);
}

// K4a: out [rows, m] = per row of score / cand [rows, len] (ids distinct
// within a row), the ids of the m greatest values in (value desc, id asc)
// order.  route and scratch as for K4b.  Returns the CUDA error code (0 on
// success).
int extract_pool_launch(const float* score, const int* cand, int rows,
                        int len, int m, int route,
                        unsigned long long* scratch, int* out, int device,
                        void* stream) {
  const int err = check(rows, len, m, route, scratch, device);
  if (err != 0) return err;
  return launch<true>(score, cand, rows, len, m, route, scratch, out,
                      (cudaStream_t)stream);
}

const char* extract_topm_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
