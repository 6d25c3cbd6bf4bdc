// Hat diagonals and the Wald test of the fitted NB GLM, one warp per gene.
//
// Replaces hat_diagonals (pydeseq2_tpu/ops/irls.py:444) followed by
// wald_test_batch (pydeseq2_tpu/ops/wald.py:28). Pass 1 over the gene's N
// samples builds two packed Gram matrices at once, reduced by warp shuffle:
//   X^T diag(W_thr) X, W_thr = mu_thr / (1 + mu_thr disp), mu_thr =
//     max(sf e^{x b}, min_mu)  (the hat matrix's weights);
//   X^T diag(W) X,     W = mu / (1 + mu disp) on the UNthresholded mu, which
//     is what the JAX pipeline hands wald_test_batch (fused.py:484-490).
// The two P x P inverses (ridge 1e-6 I), the contrast SE sqrt(Hc^T M Hc)
// with Hc = (M + 1e-6 I)^-1 c, the statistic and the p-value of the chosen
// alternative hypothesis (ops/wald.py:68-96) are scalar work in registers,
// done redundantly by every lane. Pass 2 recomputes mu and writes
// H_n = W_thr,n x_n^T (M_thr + 1e-6 I)^-1 x_n and mu_n. The counts are never
// read.
//
// Bound on the H100 by its writes, 2 x G x N values; the exp of pass 1 is
// recomputed in pass 2 rather than stored, which costs operations, not
// bytes.
#include "common.cuh"

using namespace pdt;

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float m_erfc(float x) { return erfcf(x); }
__device__ __forceinline__ double m_erfc(double x) { return erfc(x); }
// fmax/fmin drop a NaN operand (jnp.fmax / torch.fmax semantics).
__device__ __forceinline__ float m_fmax(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double m_fmax(double a, double b) { return fmax(a, b); }
__device__ __forceinline__ float m_fmin(float a, float b) { return fminf(a, b); }
__device__ __forceinline__ double m_fmin(double a, double b) { return fmin(a, b); }

template <typename T> __device__ __forceinline__ T norm_sf(T x) {
  return T(0.5) * m_erfc(x / m_sqrt(T(2)));
}

// alt_hypothesis codes (ops/wald.py:ALT_CODES)
enum { ALT_NONE = 0, ALT_GREATER_ABS = 1, ALT_LESS_ABS = 2, ALT_GREATER = 3, ALT_LESS = 4 };

// sum_p fmax((lfc_p - null) / se, 0) c_p  and its p-value
template <int P, typename T>
__device__ __forceinline__ void greater(const T* lfc, const T* c, T se, T null, T& stat, T& pval) {
  T s = T(0);
#pragma unroll
  for (int p = 0; p < P; ++p) s = s + m_fmax((lfc[p] - null) / se, T(0)) * c[p];
  stat = s;
  pval = norm_sf(s);
}

template <int P, typename T>
__device__ __forceinline__ void less(const T* lfc, const T* c, T se, T null, T& stat, T& pval) {
  T s = T(0);
#pragma unroll
  for (int p = 0; p < P; ++p) s = s + m_fmin((lfc[p] - null) / se, T(0)) * c[p];
  stat = s;
  pval = norm_sf(m_abs(s));
}

template <int P, typename T>
__global__ void __launch_bounds__(THREADS)
    hat_wald_kernel(int G, int N, const T* __restrict__ beta_g, const T* __restrict__ disp_g,
                    const T* __restrict__ sf, const T* __restrict__ X,
                    const T* __restrict__ contrast, const T* __restrict__ lfc_null_p, T min_mu,
                    int alt, T* __restrict__ H_out, T* __restrict__ mu_out,
                    T* __restrict__ pval_out, T* __restrict__ stat_out, T* __restrict__ se_out) {
  const int gi = (int)(((size_t)blockIdx.x * THREADS + threadIdx.x) / WARP);
  const int lane = threadIdx.x & (WARP - 1);
  if (gi >= G) return;
  const T disp = disp_g[gi];
  T b[P], c[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    b[p] = beta_g[(size_t)gi * P + p];
    c[p] = __ldg(contrast + p);
  }

  // ---- pass 1: both Gram matrices ----
  T gram_thr[NTRI<P>], gram[NTRI<P>];
#pragma unroll
  for (int i = 0; i < NTRI<P>; ++i) {
    gram_thr[i] = T(0);
    gram[i] = T(0);
  }
  for (int n = lane; n < N; n += WARP) {
    const T* xn = X + (size_t)n * P;
    T xv[P];
    T xb = T(0);
#pragma unroll
    for (int p = 0; p < P; ++p) {
      xv[p] = __ldg(xn + p);
      xb = xb + b[p] * xv[p];
    }
    const T mu = __ldg(sf + n) * m_exp(xb);
    const T mu_thr = m_max(mu, min_mu);
    const T w_thr = mu_thr / (T(1) + mu_thr * disp);
    const T w = mu / (T(1) + mu * disp);
#pragma unroll
    for (int p = 0; p < P; ++p) {
#pragma unroll
      for (int q = p; q < P; ++q) {
        const T xx = xv[p] * xv[q];
        gram_thr[tri_idx<P>(p, q)] += w_thr * xx;
        gram[tri_idx<P>(p, q)] += w * xx;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < NTRI<P>; ++i) {
    gram_thr[i] = warp_sum(gram_thr[i]);
    gram[i] = warp_sum(gram[i]);
  }

  // ---- the two inverses ----
  T ridged[NTRI<P>], minv[P * P], hinv[P * P];
#pragma unroll
  for (int i = 0; i < NTRI<P>; ++i) ridged[i] = gram_thr[i];
#pragma unroll
  for (int p = 0; p < P; ++p) ridged[tri_idx<P>(p, p)] = ridged[tri_idx<P>(p, p)] + T(1e-6);
  sym_inv<T, P>(ridged, minv);
#pragma unroll
  for (int i = 0; i < NTRI<P>; ++i) ridged[i] = gram[i];
#pragma unroll
  for (int p = 0; p < P; ++p) ridged[tri_idx<P>(p, p)] = ridged[tri_idx<P>(p, p)] + T(1e-6);
  sym_inv<T, P>(ridged, hinv);

  // ---- pass 2: hat diagonals and mu ----
  T* Hrow = H_out + (size_t)gi * N;
  T* murow = mu_out + (size_t)gi * N;
  for (int n = lane; n < N; n += WARP) {
    const T* xn = X + (size_t)n * P;
    T xv[P];
    T xb = T(0);
#pragma unroll
    for (int p = 0; p < P; ++p) {
      xv[p] = __ldg(xn + p);
      xb = xb + b[p] * xv[p];
    }
    const T mu = __ldg(sf + n) * m_exp(xb);
    const T mu_thr = m_max(mu, min_mu);
    const T w_thr = mu_thr / (T(1) + mu_thr * disp);
    T xmx = T(0);
#pragma unroll
    for (int p = 0; p < P; ++p) {
      T row = T(0);
#pragma unroll
      for (int q = 0; q < P; ++q) row = row + minv[p * P + q] * xv[q];
      xmx = xmx + xv[p] * row;
    }
    Hrow[n] = w_thr * xmx;
    murow[n] = mu;
  }

  // ---- Wald statistic (all lanes hold the same values; lane 0 writes) ----
  if (lane != 0) return;
  T hc[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    T s = T(0);
#pragma unroll
    for (int q = 0; q < P; ++q) s = s + hinv[p * P + q] * c[q];
    hc[p] = s;
  }
  T quad = T(0);
#pragma unroll
  for (int p = 0; p < P; ++p) {
    T s = T(0);
#pragma unroll
    for (int q = 0; q < P; ++q) s = s + gram[tri_idx<P>(p, q)] * hc[q];
    quad = quad + hc[p] * s;
  }
  const T se = m_sqrt(quad);
  const T null = *lfc_null_p;
  T stat, pval;
  if (alt == ALT_GREATER) {
    greater<P, T>(b, c, se, null, stat, pval);
  } else if (alt == ALT_LESS) {
    less<P, T>(b, c, se, null, stat, pval);
  } else if (alt == ALT_GREATER_ABS) {
    T s = T(0);
#pragma unroll
    for (int p = 0; p < P; ++p) s = s + m_sign(b[p]) * m_fmax((m_abs(b[p]) - null) / se, T(0)) * c[p];
    stat = s;
    pval = T(2) * norm_sf(m_abs(s));
  } else if (alt == ALT_LESS_ABS) {
    T s_above, p_above, s_below, p_below;
    greater<P, T>(b, c, se, -m_abs(null), s_above, p_above);
    less<P, T>(b, c, se, m_abs(null), s_below, p_below);
    stat = m_abs(s_above) < m_abs(s_below) ? s_above : s_below;
    pval = m_max(p_above, p_below);
  } else {
    T dot = T(0), csum = T(0);
#pragma unroll
    for (int p = 0; p < P; ++p) {
      dot = dot + b[p] * c[p];
      csum = csum + c[p];
    }
    stat = (dot - null * csum) / se;
    pval = T(2) * norm_sf(m_abs(stat));
  }
  pval_out[gi] = pval;
  stat_out[gi] = stat;
  se_out[gi] = se;
}

template <int P, typename T>
int launch(int G, int N, const void* beta, const void* disp, const void* sf, const void* X,
           const void* contrast, const void* lfc_null, double min_mu, int alt, void* H, void* mu,
           void* pval, void* stat, void* se, cudaStream_t s) {
  const unsigned blocks = (unsigned)(((size_t)G * WARP + THREADS - 1) / THREADS);
  hat_wald_kernel<P, T><<<blocks, THREADS, 0, s>>>(
      G, N, (const T*)beta, (const T*)disp, (const T*)sf, (const T*)X, (const T*)contrast,
      (const T*)lfc_null, (T)min_mu, alt, (T*)H, (T*)mu, (T*)pval, (T*)stat, (T*)se);
  return 0;
}

}  // namespace

extern "C" int hat_wald_launch(int is_f64, int P, int G, int N, const void* beta, const void* disp,
                               const void* sf, const void* X, const void* contrast,
                               const void* lfc_null, double min_mu, int alt, void* H, void* mu,
                               void* pval, void* stat, void* se, void* stream) {
  if (G <= 0) return (int)cudaSuccess;
  if (alt < ALT_NONE || alt > ALT_LESS) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_f64) {
    PDT_DISPATCH_P(P, launch<PP, double>(G, N, beta, disp, sf, X, contrast, lfc_null, min_mu, alt,
                                         H, mu, pval, stat, se, s));
  } else {
    PDT_DISPATCH_P(P, launch<PP, float>(G, N, beta, disp, sf, X, contrast, lfc_null, min_mu, alt,
                                        H, mu, pval, stat, se, s));
  }
  return (int)cudaGetLastError();
}
