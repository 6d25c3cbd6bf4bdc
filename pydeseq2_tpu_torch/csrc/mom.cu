// Method-of-moments dispersions and the OLS mu init, one warp per gene.
//
// Replaces pydeseq2_tpu/ops/linreg.py:23 fit_lin_mu_batch, :52
// fit_rough_dispersions_batch and :76 fit_moments_dispersions_batch as the
// pipelines chain them (fused.py:360-380, fused_stream.py:287-305 and the
// refit tile :576-594): one (G, N) @ (N, P) product against pinv(X) gives
// the per-gene OLS coefficients, and everything else is per-gene work over
// the same normalised row.
//
// Pass 1 over the gene's row forms y_n = counts_n / sf_n, the coefficients
// b_p = sum_n y_n pinv[p, n] and the row mean. Pass 2 recomputes y_n and
// the fitted value x_n . b (in coefficient order), and sums
//   rough:   ((y - max(x.b, 1))^2 - max(x.b, 1)) / ((N - P) max(x.b, 1)^2),
//   moments: (y - mean)^2,
// then rough = max(rough, 0) and moments = nan_to_num(((sum / (N - 1)) -
// mean(1/sf) mean) / mean^2): NaN -> 0, +-inf -> +-the largest finite value
// (an all-zero row gives 0/0). With mu_out it also writes
// mu_n = max(sf_n x.b, min_mu). pinv(X) (P x N) and X are shared by every
// gene and read through L1/L2: at N = 10000, P = 8 they are 640 KB in f64,
// more than shared memory holds.
//
// With normed set, the counts operand already holds y = counts / sf (the
// class API's Inference methods hand over normalised counts, and a product
// normed x sf would not give the raw counts back to the bit): y_n is read
// as it is, and sf enters only mean(1/sf) and mu.
//
// Bound on the H100 by its bytes: the counts read once (the second pass
// re-reads the row from L1) and mu written when asked, 24 + 24 MB at
// 100 x 60000 f32.
#include "common.cuh"

using namespace pdt;

namespace {

constexpr int THREADS = 256;

template <typename T> struct Finite;
template <> struct Finite<float> {
  static __device__ __forceinline__ float max() { return 3.40282346638528859812e+38f; }
};
template <> struct Finite<double> {
  static __device__ __forceinline__ double max() { return 1.7976931348623157e308; }
};

// jnp.nan_to_num / torch.nan_to_num with their defaults.
template <typename T> __device__ __forceinline__ T nan_to_num(T x) {
  if (x != x) return T(0);
  if (x == Lim<T>::inf()) return Finite<T>::max();
  if (x == -Lim<T>::inf()) return -Finite<T>::max();
  return x;
}

template <int P, typename T>
__global__ void __launch_bounds__(THREADS)
    mom_kernel(int G, int N, const T* __restrict__ counts, const T* __restrict__ sf,
               const T* __restrict__ X, const T* __restrict__ pinv,
               const T* __restrict__ s_mean_inv_p, T min_mu, int normed, T* __restrict__ rough_out,
               T* __restrict__ moments_out, T* __restrict__ coef_out, T* __restrict__ mu_out) {
  const int gi = (int)(((size_t)blockIdx.x * THREADS + threadIdx.x) / WARP);
  const int lane = threadIdx.x & (WARP - 1);
  if (gi >= G) return;
  const T* y = counts + (size_t)gi * N;

  T b[P];
#pragma unroll
  for (int p = 0; p < P; ++p) b[p] = T(0);
  T s = T(0);
  for (int n = lane; n < N; n += WARP) {
    const T v = normed ? y[n] : y[n] / __ldg(sf + n);
    s += v;
#pragma unroll
    for (int p = 0; p < P; ++p) b[p] += v * __ldg(pinv + (size_t)p * N + n);
  }
#pragma unroll
  for (int p = 0; p < P; ++p) b[p] = warp_sum(b[p]);
  const T mean = warp_sum(s) / T(N);

  const T dof = T(N - P);
  T r = T(0), d = T(0);
  for (int n = lane; n < N; n += WARP) {
    const T sfn = __ldg(sf + n);
    const T v = normed ? y[n] : y[n] / sfn;
    T xv[P];
    const T xb = lin_pred<P, T>(X, n, b, xv);
    const T yh = m_max(xb, T(1));
    const T e = v - yh;
    r += (e * e - yh) / (dof * (yh * yh));
    const T dv = v - mean;
    d += dv * dv;
    if (mu_out != nullptr) mu_out[(size_t)gi * N + n] = m_max(sfn * xb, min_mu);
  }
  r = warp_sum(r);
  d = warp_sum(d);
  if (lane == 0) {
    rough_out[gi] = m_max(r, T(0));
    const T sigma = d / T(N - 1);
    moments_out[gi] = nan_to_num((sigma - *s_mean_inv_p * mean) / (mean * mean));
#pragma unroll
    for (int p = 0; p < P; ++p) coef_out[(size_t)gi * P + p] = b[p];
  }
}

template <int P, typename T>
int launch(int G, int N, const void* counts, const void* sf, const void* X, const void* pinv,
           const void* s_mean_inv, double min_mu, int normed, void* rough, void* moments, void* coef,
           void* mu, cudaStream_t s) {
  const unsigned blocks = (unsigned)(((size_t)G * WARP + THREADS - 1) / THREADS);
  mom_kernel<P, T><<<blocks, THREADS, 0, s>>>(G, N, (const T*)counts, (const T*)sf, (const T*)X,
                                              (const T*)pinv, (const T*)s_mean_inv, (T)min_mu, normed,
                                              (T*)rough, (T*)moments, (T*)coef, (T*)mu);
  return 0;
}

}  // namespace

// mu may be NULL (no mu written). normed: counts holds counts / sf.
extern "C" int mom_launch(int is_f64, int P, int G, int N, const void* counts, const void* sf,
                          const void* X, const void* pinv, const void* s_mean_inv, double min_mu,
                          int normed, void* rough, void* moments, void* coef, void* mu, void* stream) {
  if (G <= 0) return (int)cudaSuccess;
  if (N <= P) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_f64) {
    PDT_DISPATCH_P(P, launch<PP, double>(G, N, counts, sf, X, pinv, s_mean_inv, min_mu, normed, rough,
                                         moments, coef, mu, s));
  } else {
    PDT_DISPATCH_P(P, launch<PP, float>(G, N, counts, sf, X, pinv, s_mean_inv, min_mu, normed, rough,
                                        moments, coef, mu, s));
  }
  return (int)cudaGetLastError();
}
