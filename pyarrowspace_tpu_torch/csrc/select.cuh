// A block-wide threshold select of a row's m greatest entries: count, then
// compact (extract_topm.cu's K4a and K4b).
//
// The order.  Every value maps once to a 32-bit unsigned key whose order is
// the contract's: -0.0 and +0.0 are one key, -inf and +inf are ordinary
// values, and every NaN takes key 0, below every number (-inf's key is
// 0x007fffff).  Raw float bits would put +0.0 above -0.0; the key folds
// -0.0 into +0.0 first.  An entry is the 64-bit word (key << 32 | ~id'),
// id' the id with its sign bit flipped, so that a larger entry is a larger
// value or an equal value with a smaller (signed) id: a total order on the
// distinct ids of a row, the order of the output.
//
// The select.  The m-th greatest key T is found by a radix select over
// digits of 8 bits from the top, histograms in shared memory, each pass
// counting only the keys that still share the chosen digits; the bits that
// every key shares (the block's AND and OR of the keys) are skipped, and
// the select stops at the first digit whose keys are exactly the ones
// still needed.  The entries above T, and the ties at T that the order
// takes (the smallest ids: for column ids the first in column order, by a
// block-wide prefix count; for any ids a second radix select, on the tied
// entries' ids), are then compacted into a buffer of m entries, sorted by a
// bitonic sort and written out.
//
// The narrow route (m <= NARROW_MAX) reads the row's floats as they
// arrived.  Each thread's floats are a group (fmaxf skips NaN); for m <= 32
// the threads' groups make 64, else each is one of the block's.  The
// m-th greatest of the group maxima, tau (a sort of their keys in warp 0's
// registers), is reached by at least m entries, so every entry of the
// answer has a key >= tau.  One float compare and a warp vote a float4
// find those candidates (about m + m^2 / 128 on unordered data), one claim
// a warp places them in the buffer, and warp 0 sorts them in registers (up
// to 64; up to NARROW_CAP, the block's bitonic sort).  More of them (heavy
// ties), or a tau that is NaN's key, send the row on to the radix select.
//
// The buffer and the row live in shared memory, or, for a row too long for
// it, the keys are recomputed from device memory at each pass and the
// buffer lies in a device scratch row (extract_topm.cu's routes).

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace sel {

constexpr int DIGIT_BITS = 8;
constexpr int BINS = 1 << DIGIT_BITS;
constexpr int NARROW_MAX = 64;     // m of the narrow route
constexpr int NARROW_CAP = 256;    // candidates it sorts; a power of two
constexpr unsigned FULL = 0xffffffffu;

// The unsigned order key of a float (see the top of this file).
__device__ __forceinline__ uint32_t order_key(float v) {
  uint32_t b = v == 0.0f ? 0u : __float_as_uint(v);
  b = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  return v != v ? 0u : b;
}

// The 64-bit entry of (key, id), and its id back.
__device__ __forceinline__ uint64_t entry(uint32_t key, int id) {
  return (uint64_t)key << 32 | ((uint32_t)id ^ 0x7fffffffu);
}
__device__ __forceinline__ int entry_id(uint64_t e) {
  return (int)((uint32_t)e ^ 0x7fffffffu);
}
// The tie key of an id: larger for a smaller signed id.
__device__ __forceinline__ uint32_t id_key(int id) {
  return (uint32_t)id ^ 0x7fffffffu;
}

__host__ __device__ __forceinline__ int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// Shared scratch of one block of THREADS threads (64 or 256: a multiple of
// 64, so that the narrow route's 64 groups split the threads evenly).
template <int THREADS>
struct Scratch {
  static_assert(THREADS % 64 == 0, "64 groups of threads");
  uint32_t hist[BINS];
  uint32_t group_max[THREADS];
  uint32_t warp_a[THREADS / 32], warp_b[THREADS / 32];
  int fill;            // entries compacted into the buffer so far
  uint32_t threshold;  // the narrow route's tau
  int digit, need, bin_count;
  alignas(8) unsigned long long bar[2];
};

// The result of a radix select over the keys a functor includes: take
// every included key above t and `need` of those equal to t (`eq` of
// them), or, when all_ge, every included key >= t (exactly the wanted
// number).
struct Cut {
  uint32_t t;
  int need, eq;
  bool all_ge;
};

// -- block primitives (every thread of the block calls them) ---------------

// The block's AND of a and OR of o, in place.
template <int THREADS>
__device__ __forceinline__ void block_and_or(uint32_t& a, uint32_t& o,
                                             Scratch<THREADS>& sh) {
  a = __reduce_and_sync(FULL, a);
  o = __reduce_or_sync(FULL, o);
  if ((threadIdx.x & 31) == 0) {
    sh.warp_a[threadIdx.x >> 5] = a;
    sh.warp_b[threadIdx.x >> 5] = o;
  }
  __syncthreads();
#pragma unroll
  for (int w = 0; w < THREADS / 32; ++w) {
    a &= sh.warp_a[w];
    o |= sh.warp_b[w];
  }
  __syncthreads();
}

// The sum of v over the threads before this one.
template <int THREADS>
__device__ __forceinline__ int block_exclusive_scan(int v,
                                                    Scratch<THREADS>& sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl += t;
  }
  if (lane == 31) sh.warp_a[warp] = (uint32_t)incl;
  __syncthreads();
  int base = 0;
  for (int w = 0; w < warp; ++w) base += (int)sh.warp_a[w];
  __syncthreads();
  return base + incl - v;
}

// The first of c slots in the buffer for each lane (all 32 lanes call):
// one claim for the warp.
__device__ __forceinline__ int warp_claim(int c, int* fill) {
  const int lane = threadIdx.x & 31;
  int incl = c;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl += t;
  }
  int base = 0;
  if (lane == 31) base = atomicAdd(fill, incl);
  return __shfl_sync(FULL, base, 31) + incl - c;
}

// The float whose order key is k (k >= 1: a number's key).
__device__ __forceinline__ float key_value(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// Sort the warp's 32 W entries descending (entry i = lane + 32 w in v[w]),
// a bitonic sort in registers.
template <int W, class T>
__device__ __forceinline__ void warp_sort_desc(T (&v)[W]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 2; k <= 32 * W; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      T p[W];
#pragma unroll
      for (int w = 0; w < W; ++w)
        p[w] = j >= 32 ? v[w ^ (j >> 5)] : __shfl_xor_sync(FULL, v[w], j);
#pragma unroll
      for (int w = 0; w < W; ++w) {
        const int i = lane + 32 * w;
        const bool keep_max = ((i & j) == 0) == ((i & k) == 0);
        v[w] = keep_max == (v[w] > p[w]) ? v[w] : p[w];
      }
    }
  }
}

// By warp 0: a key tau that at least m entries reach, from the THREADS
// per-thread group maxima in sh.group_max: the m-th greatest of 64 groups
// (each THREADS / 64 threads' elements) for m <= 32, a sort of two keys a
// lane, which still leaves about m + m^2 / 128 candidates; else of the
// THREADS groups.
template <int THREADS>
__device__ __forceinline__ uint32_t group_threshold(
    const Scratch<THREADS>& sh, int m) {
  const int lane = threadIdx.x & 31;
  if (m <= 32) {
    uint32_t v[2];
#pragma unroll
    for (int w = 0; w < 2; ++w) {
      v[w] = 0;
#pragma unroll
      for (int t = lane + 32 * w; t < THREADS; t += 64)
        v[w] = max(v[w], sh.group_max[t]);
    }
    warp_sort_desc<2>(v);
    return __shfl_sync(FULL, v[0], m - 1);
  }
  constexpr int PER = THREADS / 32;
  uint32_t v[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) v[i] = sh.group_max[lane + 32 * i];
  warp_sort_desc<PER>(v);
  uint32_t t = 0;
#pragma unroll
  for (int i = 0; i < PER; ++i)
    if (i == (m - 1) >> 5) t = v[i];
  return __shfl_sync(FULL, t, (m - 1) & 31);
}

// The need-th greatest of the `count` keys that key(j, k) includes among
// j in [0, n), whose AND and OR are a and o (count >= need >= 1).
template <int THREADS, class KeyFn>
__device__ Cut radix_select(KeyFn key, int n, int need, int count,
                            uint32_t a, uint32_t o, Scratch<THREADS>& sh) {
  const int tid = threadIdx.x, lane = tid & 31;
  if (a == o) return Cut{a, need, count, need == count};
  const int hb = 31 - __clz(a ^ o);
  uint32_t above = ~((2u << hb) - 1u);   // the bits already chosen
  uint32_t prefix = a & above;
  int lo = hb + 1;
  while (true) {
    const int hi = lo - 1;
    lo = hi >= DIGIT_BITS - 1 ? hi - (DIGIT_BITS - 1) : 0;
    const uint32_t dmask = (1u << (hi - lo + 1)) - 1u;
    for (int i = tid; i < BINS; i += THREADS) sh.hist[i] = 0;
    __syncthreads();
    for (int j0 = 0; j0 < n; j0 += THREADS) {
      const int j = j0 + tid;
      uint32_t k;
      if (j < n && key(j, k) && (k & above) == prefix)
        atomicAdd(&sh.hist[(k >> lo) & dmask], 1u);
    }
    __syncthreads();
    if (tid < 32) {
      // The digit d whose bin holds the need-th greatest: the bins above
      // it hold fewer than need keys, with it at least need.
      constexpr int PER = BINS / 32;
      uint32_t h[PER];
      int s = 0;
#pragma unroll
      for (int b = 0; b < PER; ++b) {
        h[b] = sh.hist[lane * PER + b];
        s += (int)h[b];
      }
      int incl = s;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int t = __shfl_down_sync(FULL, incl, off);
        if (lane + off < 32) incl += t;
      }
      int over = incl - s;
#pragma unroll
      for (int b = PER - 1; b >= 0; --b) {
        if (over < need && over + (int)h[b] >= need) {
          sh.digit = lane * PER + b;
          sh.need = need - over;
          sh.bin_count = (int)h[b];
        }
        over += (int)h[b];
      }
    }
    __syncthreads();
    need = sh.need;
    const int in_bin = sh.bin_count;
    prefix |= (uint32_t)sh.digit << lo;
    above |= dmask << lo;
    if (in_bin == need) return Cut{prefix, need, in_bin, true};
    if (lo == 0) return Cut{prefix, need, in_bin, false};
  }
}

// Sort buf[0..p) descending, p a power of two: by the whole block of
// THREADS, or by warp 0 alone when p <= 64 (the others return at once; the
// caller's next __syncthreads orders the result).
template <int THREADS>
__device__ __forceinline__ void sort_desc(uint64_t* buf, int p) {
  const bool one_warp = p <= 64;
  if (one_warp && threadIdx.x >= 32) return;
  const int step = one_warp ? 32 : THREADS;
  for (int k = 2; k <= p; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int t = threadIdx.x; t < p / 2; t += step) {
        const int i = ((t & ~(j - 1)) << 1) | (t & (j - 1));
        const int l = i + j;
        const uint64_t x = buf[i], y = buf[l];
        if ((i & k) == 0 ? x < y : x > y) {
          buf[i] = y;
          buf[l] = x;
        }
      }
      if (one_warp)
        __syncwarp();
      else
        __syncthreads();
    }
  }
}

// -- the 1-D bulk copy of a row into shared memory -------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// By one thread: init the barrier (one arrival) and make it visible to the
// copy engine.
__device__ __forceinline__ void bulk_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   smem_addr(bar))
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// By one thread: copy `bytes` (a multiple of 16, both addresses 16-byte
// aligned) from src to dst, completing on bar.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          int bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Wait for the barrier's phase of the given parity to complete.
__device__ __forceinline__ void bulk_wait(unsigned long long* bar,
                                          uint32_t parity) {
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

// By the thread that issues the next copy, after a barrier: order the
// block's earlier accesses of shared memory before the copy engine's.
__device__ __forceinline__ void bulk_fence() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

}  // namespace sel
