// Exact order statistics per row by 8-bit radix select.
//
// Replaces order_stats_select (pydeseq2_tpu/ops/select.py:65), the JAX
// package's MSB-first radix bisection over monotone unsigned keys. Rows are
// the columns of the (G, N) log-ratio tile, transposed by the wrapper so a
// row is contiguous: x is (C, L), one block per row, and each row asks for
// two ranks (k_lo, k_hi). Each pass histograms the next 8 key bits of the
// keys that still match the resolved prefix of a rank, in shared memory,
// and one thread per rank walks the 256 bins to pick the digit. Four passes
// resolve a float key, eight a double key; the decoded key is the element a
// sort puts at that rank, so the result is bit-identical to a sort.
//
// Bound on the H100 by the bytes it reads (each pass re-reads the row) and
// by shared-memory atomics where many keys share a digit (log-ratios share
// their sign and exponent bits); warp-aggregated atomics (__match_any_sync)
// make that one add per distinct digit per warp.
#include "common.cuh"

using namespace pdt;

namespace {

template <typename T> struct KeyOf;
template <> struct KeyOf<float> {
  using K = uint32_t;
  static constexpr int BITS = 32;
  static __device__ __forceinline__ K key(float v) {
    uint32_t u = __float_as_uint(v);
    return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  }
  static __device__ __forceinline__ float val(K k) {
    uint32_t u = (k & 0x80000000u) ? (k ^ 0x80000000u) : ~k;
    return __uint_as_float(u);
  }
};
template <> struct KeyOf<double> {
  using K = unsigned long long;
  static constexpr int BITS = 64;
  static __device__ __forceinline__ K key(double v) {
    K u = (K)__double_as_longlong(v);
    const K top = 0x8000000000000000ull;
    return (u & top) ? ~u : (u | top);
  }
  static __device__ __forceinline__ double val(K k) {
    const K top = 0x8000000000000000ull;
    K u = (k & top) ? (k ^ top) : ~k;
    return __longlong_as_double((long long)u);
  }
};

constexpr int THREADS = 512;

template <typename T>
__global__ void __launch_bounds__(THREADS) select_kernel(const T* __restrict__ x, int L,
                                                         const int* __restrict__ k_lo,
                                                         const int* __restrict__ k_hi,
                                                         T* __restrict__ out_lo,
                                                         T* __restrict__ out_hi) {
  using KO = KeyOf<T>;
  using K = typename KO::K;
  __shared__ unsigned hist[2][256];
  __shared__ int s_digit[2];
  __shared__ int s_rank[2];

  const T* row = x + (size_t)blockIdx.x * L;
  const int lane = threadIdx.x & (WARP - 1);
  K prefix[2] = {0, 0};
  K mask = 0;
  int rank[2] = {k_lo[blockIdx.x], k_hi[blockIdx.x]};

  for (int shift = KO::BITS - 8; shift >= 0; shift -= 8) {
    for (int i = threadIdx.x; i < 2 * 256; i += THREADS) (&hist[0][0])[i] = 0u;
    __syncthreads();
    // Whole warps iterate together so the ballot and match see every lane.
    for (int base = 0; base < L; base += THREADS) {
      const int i = base + threadIdx.x;
      const bool in = i < L;
      const K key = in ? KO::key(row[i]) : K(0);
      const unsigned digit = (unsigned)((key >> shift) & K(0xFF));
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const bool m = in && ((key & mask) == prefix[r]);
        const unsigned act = __ballot_sync(FULL, m);
        if (m) {
          const unsigned peers = __match_any_sync(act, digit);
          if (lane == __ffs(peers) - 1) atomicAdd(&hist[r][digit], (unsigned)__popc(peers));
        }
      }
    }
    __syncthreads();
    if (threadIdx.x < 2) {
      const int r = threadIdx.x;
      const int k = rank[r];
      unsigned cum = 0;
      int d = 255;
      for (int b = 0; b < 256; ++b) {
        const unsigned c = hist[r][b];
        if ((unsigned)k < cum + c) {
          d = b;
          break;
        }
        cum += c;
      }
      s_digit[r] = d;
      s_rank[r] = k - (int)cum;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      prefix[r] |= (K)s_digit[r] << shift;
      rank[r] = s_rank[r];
    }
    mask |= K(0xFF) << shift;
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    out_lo[blockIdx.x] = KO::val(prefix[0]);
    out_hi[blockIdx.x] = KO::val(prefix[1]);
  }
}

}  // namespace

extern "C" int order_stats_select_launch(int is_f64, const void* x, int C, int L, const void* k_lo,
                                         const void* k_hi, void* out_lo, void* out_hi,
                                         void* stream) {
  if (C <= 0 || L <= 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_f64) {
    select_kernel<double><<<C, THREADS, 0, s>>>((const double*)x, L, (const int*)k_lo,
                                                (const int*)k_hi, (double*)out_lo,
                                                (double*)out_hi);
  } else {
    select_kernel<float><<<C, THREADS, 0, s>>>((const float*)x, L, (const int*)k_lo,
                                               (const int*)k_hi, (float*)out_lo,
                                               (float*)out_hi);
  }
  return (int)cudaGetLastError();
}
