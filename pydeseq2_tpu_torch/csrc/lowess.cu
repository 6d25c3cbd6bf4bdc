// The independent-filtering lowess and cutoff pick, one block: the
// bandwidths' rank counts spread over the block, the tricube weights staged
// once.
//
// Replaces pydeseq2_tpu/ops/stats.py:218 lowess_device (tricube-weighted
// robust local linear regression over the 50 filtering quantiles, 3
// robustifying rounds) and the pick that follows it in device_padj
// (pydeseq2_tpu/fused.py:763-768): thresh = max(fit) - sqrt(nanmean of the
// squared residuals where num_rej > 0), j = the first row with
// num_rej > thresh (0 if none), and j = 0 when max(num_rej) <= 10.
//
// The n x n distances |f_i - f_k| are staged in shared memory (a 64 x 64
// layout whatever n, so a slot's pair comes by shifts). Point i's
// bandwidth h_i is the r-th smallest of row i (r = ceil(frac n)), ties
// broken by index, which is the element a sort puts at r: the block's
// threads take the n^2 (i, k) pairs and each counts the rank of its
// distance in its row. The weights w[j][i] = (1 - clip(|f_j - f_i| / h_i,
// 0, 1)^3)^3 then replace the distances in place, once: they do not depend
// on the round. In each round thread i sums its local fit's terms
// delta_j w[j][i] (1, f_j, f_j^2, y_j, y_j f_j) over j in index order, and
// the median of |resid| (mean of the middle pair, NaN if any entry is NaN)
// is a rank count on each point. Expressions follow the plain version term
// by term (--fmad=false), and every sum runs over the points in index
// order, as the plain version's do, so the two agree to the bit: each local
// determinant sw swff - swf^2 cancels ~100x over a 10-point window.
//
// Bound on the H100 by launch latency: ~n^3 / 2 compares for the
// bandwidths, 3 rounds of n^2 weighted terms and under 2 KB of data; the
// weights stage 32 KB (n = 64, float64).
#include "common.cuh"

using namespace pdt;

namespace {

constexpr int MAXN = 64;
constexpr int THREADS = 1024;

template <typename T>
__global__ void __launch_bounds__(THREADS)
    lowess_kernel(int n, int r, int iters, const T* __restrict__ f_g,
                  const long long* __restrict__ rej, T* __restrict__ yest_out,
                  long long* __restrict__ j_out) {
  __shared__ T w[MAXN * MAXN];  // distances, then weights: w[j * MAXN + i], point j's in the fit at i
  __shared__ T f[MAXN], y[MAXN], ff[MAXN], yf[MAXN], h[MAXN], delta[MAXN], ares[MAXN], ye[MAXN];
  __shared__ int hk[MAXN];
  __shared__ T med[2];
  const int t = threadIdx.x;
  const bool own = t < n;
  if (own) {
    f[t] = f_g[t];
    y[t] = T(rej[t]);
    delta[t] = T(1);
    hk[t] = -1;
  }
  __syncthreads();
  if (own) {
    ff[t] = f[t] * f[t];
    yf[t] = y[t] * f[t];
  }
  // slot p of w is the pair (p / MAXN, p % MAXN); pairs past n are skipped
  for (int p = t; p < MAXN * MAXN; p += THREADS) {
    if (p / MAXN < n && p % MAXN < n) w[p] = m_abs(f[p / MAXN] - f[p % MAXN]);
  }
  __syncthreads();

  // the r-th smallest distance of each row: the pair (i, k) whose rank in
  // row i is r (the last such k, as a loop over k would keep)
  for (int p = t; p < MAXN * MAXN; p += THREADS) {
    const int i = p / MAXN, k = p % MAXN;
    if (i >= n || k >= n) continue;
    const T dk = w[p];
    const T* row = w + i * MAXN;
    int rank = 0;
    for (int m = 0; m < n; ++m) {
      const T dm = row[m];
      rank += (dm < dk) || (dm == dk && m < k);
    }
    if (rank == r) atomicMax(&hk[i], k);
  }
  __syncthreads();
  if (own) h[t] = m_max(hk[t] >= 0 ? w[t * MAXN + hk[t]] : T(0), T(1e-12));
  __syncthreads();
  for (int p = t; p < MAXN * MAXN; p += THREADS) {
    if (p / MAXN >= n || p % MAXN >= n) continue;
    const T u = m_min(m_max(w[p] / h[p % MAXN], T(0)), T(1));
    const T c = T(1) - u * u * u;
    w[p] = c * c * c;
  }
  __syncthreads();

  T yest = T(0);
  for (int round = 0; round < iters; ++round) {
    T resid = T(0);
    if (own) {
      T sw = T(0), swf = T(0), swff = T(0), b0 = T(0), b1 = T(0);
      for (int j = 0; j < n; ++j) {
        const T wt = delta[j] * w[j * MAXN + t];
        sw += wt;
        swf += wt * f[j];
        swff += wt * ff[j];
        b0 += wt * y[j];
        b1 += wt * yf[j];
      }
      const T det = sw * swff - swf * swf;
      const T beta0 = (b0 * swff - b1 * swf) / det;
      const T beta1 = (sw * b1 - swf * b0) / det;
      yest = beta0 + beta1 * f[t];
      resid = y[t] - yest;
      ares[t] = m_abs(resid);
    }
    const int any_nan = __syncthreads_or(own && ares[t] != ares[t]);
    if (own) {  // the two middle ranks of |resid| (ties by index)
      const T x = ares[t];
      int rank = 0;
      for (int k = 0; k < n; ++k) rank += (ares[k] < x) || (ares[k] == x && k < t);
      if (rank == (n - 1) / 2) med[0] = x;
      if (rank == n / 2) med[1] = x;
    }
    __syncthreads();
    if (own) {
      const T s = any_nan ? Lim<T>::inf() - Lim<T>::inf() : (med[0] + med[1]) / T(2);
      T d = s == T(0) ? (m_abs(resid) > T(0) ? T(1) : T(0))
                      : m_min(m_max(resid / (T(6) * s), T(-1)), T(1));
      const T e = T(1) - d * d;
      delta[t] = e * e;
    }
    __syncthreads();
  }

  if (own) {
    ye[t] = yest;
    yest_out[t] = yest;
  }
  __syncthreads();
  if (t == 0) {
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
  if (n <= 0 || n > MAXN || r < 0 || r >= n) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_f64) {
    launch<double>(n, r, iters, features, num_rej, yest, j, s);
  } else {
    launch<float>(n, r, iters, features, num_rej, yest, j, s);
  }
  return (int)cudaGetLastError();
}
