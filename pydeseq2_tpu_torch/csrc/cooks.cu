// Cook's distances and the Cook's outlier flag, one warp per gene.
//
// Replaces the trimmed moments of the Cook's robust dispersion
// (pydeseq2_tpu/ops/stats.py:88,108 trimmed_variance and
// trimmed_cell_variance, with ops/select.py:166 trimmed_mean_select) and the
// elementwise block after them (fused.py:702-716).
//
// For each cohort (a list of sample indices) the warp computes
//   rm  = trimmed mean of y/sf, dropping floor(n trim) at each end,
//   v_c = scale_c * trimmed mean of (y/sf - rm)^2,
// and v = max_c v_c. A trimmed mean takes its two boundary order statistics
// by MSB-first bisection over the monotone integer keys of the values (the
// k-th smallest key is the largest prefix with at most k keys below it): one
// warp-wide count per key bit, both ranks in the same pass. The interior is
// then summed directly and copies of the boundary values are counted
// exactly, so the kept multiset is the sort's. The values are recomputed
// from the gene's row on every pass (L1-resident), not stored, so any N
// works without shared memory.
//
// Then m = mean of y/sf over all N samples, disp_c = max((v - m)/m^2, 0.04),
// and per sample cooks = (y - mu)^2 / ((mu + disp_c mu^2) P) * H / (1 - H)^2.
// A gene is flagged when a use_for_max sample's distance exceeds the cutoff
// and fewer than 3 samples have a count above that of the sample with the
// largest distance (the first argmax over ALL samples, a NaN counting as
// the largest); outlier = flagged & non_zero, and cooks is NaN where the gene
// is not non_zero.
//
// Bound on the H100 by its bytes: counts, mu and H read and cooks written,
// 4 x G x N values; the bisection's re-reads of the row hit L1.
#include "common.cuh"

using namespace pdt;

namespace {

constexpr int THREADS = 256;

template <typename T> struct KeyOf;
template <> struct KeyOf<float> {
  using U = uint32_t;
  static constexpr int BITS = 32;
  static __device__ __forceinline__ U key(float x) {
    U u = __float_as_uint(x);
    return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  }
  static __device__ __forceinline__ float value(U k) {
    return __uint_as_float((k & 0x80000000u) ? (k ^ 0x80000000u) : ~k);
  }
};
template <> struct KeyOf<double> {
  using U = unsigned long long;
  static constexpr int BITS = 64;
  static __device__ __forceinline__ U key(double x) {
    U u = (U)__double_as_longlong(x);
    return (u & 0x8000000000000000ull) ? ~u : (u | 0x8000000000000000ull);
  }
  static __device__ __forceinline__ double value(U k) {
    return __longlong_as_double(
        (long long)((k & 0x8000000000000000ull) ? (k ^ 0x8000000000000000ull) : ~k));
  }
};

__device__ __forceinline__ int warp_sum_i(int v) {
#pragma unroll
  for (int o = WARP / 2; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// Trimmed mean of the n values val(i), i = 0..n-1, dropping k at each end.
template <typename T, typename F>
__device__ T trimmed_mean(F val, int n, int k, int lane) {
  using K = KeyOf<T>;
  using U = typename K::U;
  if (k == 0) {
    T s = T(0);
    for (int i = lane; i < n; i += WARP) s += val(i);
    return warp_sum(s) / T(n);
  }
  const int k_hi = n - 1 - k;
  U t_lo = 0, t_hi = 0;
  for (int b = K::BITS - 1; b >= 0; --b) {
    const U c_lo = t_lo | ((U)1 << b);
    const U c_hi = t_hi | ((U)1 << b);
    int n_lo = 0, n_hi = 0;
    for (int i = lane; i < n; i += WARP) {
      const U kk = K::key(val(i));
      n_lo += kk < c_lo;
      n_hi += kk < c_hi;
    }
    n_lo = warp_sum_i(n_lo);
    n_hi = warp_sum_i(n_hi);
    if (n_lo <= k) t_lo = c_lo;
    if (n_hi <= k_hi) t_hi = c_hi;
  }
  const T lo = K::value(t_lo);
  const T hi = K::value(t_hi);
  T strict = T(0);
  int c_le_lo = 0, c_lt_hi = 0;
  for (int i = lane; i < n; i += WARP) {
    const T x = val(i);
    if (x > lo && x < hi) strict += x;
    c_le_lo += x <= lo;
    c_lt_hi += x < hi;
  }
  strict = warp_sum(strict);
  c_le_lo = warp_sum_i(c_le_lo);
  c_lt_hi = warp_sum_i(c_lt_hi);
  // kept ranks are [k, n-1-k]; copies of each boundary value inside them
  const T copies_lo = T(c_le_lo - k);
  const T copies_hi = T(n - k - c_lt_hi);
  const T total = strict + lo * copies_lo + hi * copies_hi;
  return lo == hi ? lo : total / T(n - 2 * k);
}

// (value, index) of the first maximum, a NaN counting as the largest
// (jnp.argmax): does (vb, ib) beat (va, ia)?
template <typename T> __device__ __forceinline__ bool beats(T vb, int ib, T va, int ia) {
  const bool na = va != va, nb = vb != vb;
  if (na || nb) return nb && (!na || ib < ia);
  return vb > va || (vb == va && ib < ia);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    cooks_kernel(int G, int N, int P, const T* __restrict__ counts, const T* __restrict__ sf,
                 const T* __restrict__ mu_g, const T* __restrict__ H_g,
                 const unsigned char* __restrict__ non_zero, const unsigned char* __restrict__ ufm,
                 const T* __restrict__ cutoff_p, int C, const int* __restrict__ perm,
                 const int* __restrict__ offsets, const int* __restrict__ ntrim,
                 const T* __restrict__ scale, T* __restrict__ cooks_out,
                 unsigned char* __restrict__ outlier_out, T* __restrict__ disp_out) {
  const int gi = (int)(((size_t)blockIdx.x * THREADS + threadIdx.x) / WARP);
  const int lane = threadIdx.x & (WARP - 1);
  if (gi >= G) return;
  const T* y = counts + (size_t)gi * N;
  const T* mu = mu_g + (size_t)gi * N;
  const T* H = H_g + (size_t)gi * N;

  // ---- robust dispersion: max over cohorts of the trimmed variance ----
  T v = T(0);
  for (int c = 0; c < C; ++c) {
    const int* idx = perm + offsets[c];
    const int n = offsets[c + 1] - offsets[c];
    const int k = ntrim[c];
    auto normed = [&](int i) {
      const int s = __ldg(idx + i);
      return y[s] / __ldg(sf + s);
    };
    const T rm = trimmed_mean<T>(normed, n, k, lane);
    auto sqerr = [&](int i) {
      const T d = normed(i) - rm;
      return d * d;
    };
    const T vc = scale[c] * trimmed_mean<T>(sqerr, n, k, lane);
    v = c == 0 ? vc : m_max(v, vc);
  }
  T msum = T(0);
  for (int n = lane; n < N; n += WARP) msum += y[n] / __ldg(sf + n);
  const T m = warp_sum(msum) / T(N);
  const T disp_c = m_max((v - m) / (m * m), T(0.04));

  // ---- Cook's distances, cutoff test, first argmax ----
  const bool nz = non_zero[gi] != 0;
  const T cutoff = *cutoff_p;
  const T nan = Lim<T>::inf() - Lim<T>::inf();
  T* out = cooks_out + (size_t)gi * N;
  bool flagged = false;
  T best = -Lim<T>::inf();
  int best_i = 0x7fffffff;
  for (int n = lane; n < N; n += WARP) {
    const T mun = mu[n];
    const T Hn = H[n];
    const T V = mun + disp_c * (mun * mun);
    const T r = y[n] - mun;
    const T sp = r * r / (V * T(P));
    const T omh = T(1) - Hn;
    const T cd = sp * Hn / (omh * omh);
    flagged = flagged || (ufm[n] != 0 && cd > cutoff);
    if (beats(cd, n, best, best_i)) {
      best = cd;
      best_i = n;
    }
    out[n] = nz ? cd : nan;
  }
  flagged = __any_sync(FULL, flagged);
#pragma unroll
  for (int o = WARP / 2; o > 0; o >>= 1) {
    const T vb = __shfl_xor_sync(FULL, best, o);
    const int ib = __shfl_xor_sync(FULL, best_i, o);
    if (beats(vb, ib, best, best_i)) {
      best = vb;
      best_i = ib;
    }
  }
  const T max_count = y[best_i];
  int above = 0;
  for (int n = lane; n < N; n += WARP) above += y[n] > max_count;
  above = warp_sum_i(above);
  if (lane == 0) {
    outlier_out[gi] = (flagged && above < 3 && nz) ? 1 : 0;
    disp_out[gi] = disp_c;
  }
}

template <typename T>
int launch(int G, int N, int P, const void* counts, const void* sf, const void* mu, const void* H,
           const void* non_zero, const void* ufm, const void* cutoff, int C, const void* perm,
           const void* offsets, const void* ntrim, const void* scale, void* cooks, void* outlier,
           void* disp, cudaStream_t s) {
  const unsigned blocks = (unsigned)(((size_t)G * WARP + THREADS - 1) / THREADS);
  cooks_kernel<T><<<blocks, THREADS, 0, s>>>(
      G, N, P, (const T*)counts, (const T*)sf, (const T*)mu, (const T*)H,
      (const unsigned char*)non_zero, (const unsigned char*)ufm, (const T*)cutoff, C,
      (const int*)perm, (const int*)offsets, (const int*)ntrim, (const T*)scale, (T*)cooks,
      (unsigned char*)outlier, (T*)disp);
  return 0;
}

}  // namespace

extern "C" int cooks_launch(int is_f64, int G, int N, int P, const void* counts, const void* sf,
                            const void* mu, const void* H, const void* non_zero, const void* ufm,
                            const void* cutoff, int C, const void* perm, const void* offsets,
                            const void* ntrim, const void* scale, void* cooks, void* outlier,
                            void* disp, void* stream) {
  if (G <= 0) return (int)cudaSuccess;
  if (N <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_f64) {
    launch<double>(G, N, P, counts, sf, mu, H, non_zero, ufm, cutoff, C, perm, offsets, ntrim,
                   scale, cooks, outlier, disp, s);
  } else {
    launch<float>(G, N, P, counts, sf, mu, H, non_zero, ufm, cutoff, C, perm, offsets, ntrim,
                  scale, cooks, outlier, disp, s);
  }
  return (int)cudaGetLastError();
}
