// The independent-filtering lowess and cutoff pick, one block of 64 threads.
//
// Replaces pydeseq2_tpu/ops/stats.py:218 lowess_device (tricube-weighted
// robust local linear regression over the 50 filtering quantiles, 3
// robustifying rounds) and the pick that follows it in device_padj
// (pydeseq2_tpu/fused.py:763-768): thresh = max(fit) - sqrt(nanmean of the
// squared residuals where num_rej > 0), j = the first row with
// num_rej > thresh (0 if none), and j = 0 when max(num_rej) <= 10.
//
// Thread i owns point i. Its bandwidth h_i is the r-th smallest of its n
// distances (r = ceil(frac n)), found by counting ranks (ties broken by
// index), which is the element a sort puts at r. In each round thread i
// sums its local fit's weights over j in index order; the median of
// |resid| (mean of the middle pair, NaN if any entry is NaN) is found the
// same way. Expressions follow the plain version term by term
// (--fmad=false), and every sum runs over the points in index order, as the
// plain version's do, so the two agree to the bit: each local determinant
// sw swff - swf^2 cancels ~100x over a 10-point window.
//
// Bound on the H100 by launch latency: 3 rounds of 50 x 50 weighted sums
// (~50,000 operations) and under 2 KB of data.
#include "common.cuh"

using namespace pdt;

namespace {

constexpr int THREADS = 64;

// x at rank r among v[0..n) (ties by index): each thread tests its own i.
template <typename T> __device__ __forceinline__ bool is_rank(const T* v, int n, int i, int r) {
  const T x = v[i];
  int rank = 0;
  for (int j = 0; j < n; ++j) rank += (v[j] < x) || (v[j] == x && j < i);
  return rank == r;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    lowess_kernel(int n, int r, int iters, const T* __restrict__ f_g,
                  const long long* __restrict__ rej, T* __restrict__ yest_out,
                  long long* __restrict__ j_out) {
  __shared__ T f[THREADS], y[THREADS], h[THREADS], delta[THREADS], ares[THREADS], ye[THREADS];
  __shared__ T med[2];
  const int i = threadIdx.x;
  const bool own = i < n;
  if (own) {
    f[i] = f_g[i];
    y[i] = T(rej[i]);
    delta[i] = T(1);
  }
  __syncthreads();

  if (own) {
    // the r-th smallest distance from point i (row i of the distance matrix)
    T hv = T(0);
    for (int k = 0; k < n; ++k) {
      const T dk = m_abs(f[i] - f[k]);
      int rank = 0;
      for (int m = 0; m < n; ++m) {
        const T dm = m_abs(f[i] - f[m]);
        rank += (dm < dk) || (dm == dk && m < k);
      }
      if (rank == r) hv = dk;
    }
    h[i] = m_max(hv, T(1e-12));
  }
  __syncthreads();

  T yest = T(0);
  for (int round = 0; round < iters; ++round) {
    T resid = T(0);
    if (own) {
      T sw = T(0), swf = T(0), swff = T(0), b0 = T(0), b1 = T(0);
      for (int j = 0; j < n; ++j) {
        // w[j][i] = (1 - clip(|f_j - f_i| / h_i, 0, 1)^3)^3, times delta_j
        const T u = m_min(m_max(m_abs(f[j] - f[i]) / h[i], T(0)), T(1));
        const T c = T(1) - u * u * u;
        const T wt = delta[j] * (c * c * c);
        sw += wt;
        swf += wt * f[j];
        swff += wt * (f[j] * f[j]);
        b0 += wt * y[j];
        b1 += wt * (y[j] * f[j]);
      }
      const T det = sw * swff - swf * swf;
      const T beta0 = (b0 * swff - b1 * swf) / det;
      const T beta1 = (sw * b1 - swf * b0) / det;
      yest = beta0 + beta1 * f[i];
      resid = y[i] - yest;
      ares[i] = m_abs(resid);
    }
    const int any_nan = __syncthreads_or(own && ares[i] != ares[i]);
    if (own) {
      if (is_rank(ares, n, i, (n - 1) / 2)) med[0] = ares[i];
      if (is_rank(ares, n, i, n / 2)) med[1] = ares[i];
    }
    __syncthreads();
    if (own) {
      const T s = any_nan ? Lim<T>::inf() - Lim<T>::inf() : (med[0] + med[1]) / T(2);
      T d = s == T(0) ? (m_abs(resid) > T(0) ? T(1) : T(0))
                      : m_min(m_max(resid / (T(6) * s), T(-1)), T(1));
      const T e = T(1) - d * d;
      delta[i] = e * e;
    }
    __syncthreads();
  }

  if (own) {
    ye[i] = yest;
    yest_out[i] = yest;
  }
  __syncthreads();
  if (i == 0) {
    T top = ye[0], ssum = T(0);
    long long rmax = rej[0];
    int cnt = 0;
    for (int k = 0; k < n; ++k) {
      top = m_max(top, ye[k]);
      rmax = rej[k] > rmax ? rej[k] : rmax;
      if (rej[k] > 0) {
        const T e = y[k] - ye[k];
        const T e2 = e * e;
        if (e2 == e2) {
          ssum += e2;
          ++cnt;
        }
      }
    }
    const T thresh = top - m_sqrt(ssum / T(cnt));  // cnt == 0: 0/0, NaN, nothing above it
    long long j = 0;
    for (int k = 0; k < n; ++k) {
      if (y[k] > thresh) {
        j = k;
        break;
      }
    }
    j_out[0] = rmax <= 10 ? 0 : j;
  }
}

template <typename T>
int launch(int n, int r, int iters, const void* f, const void* rej, void* yest, void* j,
           cudaStream_t s) {
  lowess_kernel<T><<<1, THREADS, 0, s>>>(n, r, iters, (const T*)f, (const long long*)rej,
                                         (T*)yest, (long long*)j);
  return 0;
}

}  // namespace

extern "C" int lowess_launch(int is_f64, int n, int r, int iters, const void* features,
                             const void* num_rej, void* yest, void* j, void* stream) {
  if (n <= 0 || n > THREADS || r < 0 || r >= n) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_f64) {
    launch<double>(n, r, iters, features, num_rej, yest, j, s);
  } else {
    launch<float>(n, r, iters, features, num_rej, yest, j, s);
  }
  return (int)cudaGetLastError();
}
