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
//
// Two more entries serve the class API, which calls the two halves apart
// (models/dataset.py fit_LFC, models/stats.py run_wald_test):
//   hat_launch  (hat_diagonals alone): pass 1 builds only X^T W_thr X, pass
//     2 writes H and mu; bound by the same 2 G N writes.
//   wald_launch (wald_test_batch alone): reads the caller's (G, N) mu
//     instead of forming it, and the caller's (P, P) ridge (DeseqStats
//     passes diag(1 / prior_LFC_var^2) or 1e-6 I) instead of 1e-6 I; it
//     writes no (G, N) value, so it is bound by reading mu, G x N values.
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
// what a launch computes
enum { MODE_FUSED = 0, MODE_HAT = 1, MODE_WALD = 2 };

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

// MODE_FUSED: both passes and the test; MODE_HAT: no test (contrast,
// lfc_null, the test's outputs unused); MODE_WALD: mu_in read, ridge (P, P)
// added, no hat pass (sf, H_out, mu_out unused).
template <int P, typename T, int MODE>
__global__ void __launch_bounds__(THREADS)
    hat_wald_kernel(int G, int N, const T* __restrict__ beta_g, const T* __restrict__ disp_g,
                    const T* __restrict__ sf, const T* __restrict__ X,
                    const T* __restrict__ contrast, const T* __restrict__ lfc_null_p, T min_mu,
                    int alt, const T* __restrict__ mu_in, const T* __restrict__ ridge,
                    T* __restrict__ H_out, T* __restrict__ mu_out,
                    T* __restrict__ pval_out, T* __restrict__ stat_out, T* __restrict__ se_out) {
  constexpr bool HAT = MODE != MODE_WALD;
  constexpr bool TEST = MODE != MODE_HAT;
  const int gi = (int)(((size_t)blockIdx.x * THREADS + threadIdx.x) / WARP);
  const int lane = threadIdx.x & (WARP - 1);
  if (gi >= G) return;
  const T disp = disp_g[gi];
  T b[P], c[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    b[p] = beta_g[(size_t)gi * P + p];
    c[p] = TEST ? __ldg(contrast + p) : T(0);
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
    const T mu = MODE == MODE_WALD ? mu_in[(size_t)gi * N + n] : __ldg(sf + n) * m_exp(xb);
    const T mu_thr = m_max(mu, min_mu);
    const T w_thr = mu_thr / (T(1) + mu_thr * disp);
    const T w = mu / (T(1) + mu * disp);
#pragma unroll
    for (int p = 0; p < P; ++p) {
#pragma unroll
      for (int q = p; q < P; ++q) {
        const T xx = xv[p] * xv[q];
        if (HAT) gram_thr[tri_idx<P>(p, q)] += w_thr * xx;
        if (TEST) gram[tri_idx<P>(p, q)] += w * xx;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < NTRI<P>; ++i) {
    if (HAT) gram_thr[i] = warp_sum(gram_thr[i]);
    if (TEST) gram[i] = warp_sum(gram[i]);
  }

  // ---- the two inverses ----
  T ridged[NTRI<P>], minv[P * P], hinv[P * P];
  if (HAT) {
#pragma unroll
    for (int i = 0; i < NTRI<P>; ++i) ridged[i] = gram_thr[i];
#pragma unroll
    for (int p = 0; p < P; ++p) ridged[tri_idx<P>(p, p)] = ridged[tri_idx<P>(p, p)] + T(1e-6);
    sym_inv<T, P>(ridged, minv);
  }
  if (TEST) {
#pragma unroll
    for (int i = 0; i < NTRI<P>; ++i) ridged[i] = gram[i];
    if (MODE == MODE_WALD) {
#pragma unroll
      for (int p = 0; p < P; ++p) {
#pragma unroll
        for (int q = p; q < P; ++q) ridged[tri_idx<P>(p, q)] = ridged[tri_idx<P>(p, q)] + __ldg(ridge + p * P + q);
      }
    } else {
#pragma unroll
      for (int p = 0; p < P; ++p) ridged[tri_idx<P>(p, p)] = ridged[tri_idx<P>(p, p)] + T(1e-6);
    }
    sym_inv<T, P>(ridged, hinv);
  }

  // ---- pass 2: hat diagonals and mu ----
  T* Hrow = H_out + (size_t)gi * N;
  T* murow = mu_out + (size_t)gi * N;
  for (int n = lane; HAT && n < N; n += WARP) {
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
  if (!TEST || lane != 0) return;
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

template <int P, typename T, int MODE>
int launch(int G, int N, const void* beta, const void* disp, const void* sf, const void* X,
           const void* contrast, const void* lfc_null, double min_mu, int alt, const void* mu_in,
           const void* ridge, void* H, void* mu, void* pval, void* stat, void* se, cudaStream_t s) {
  const unsigned blocks = (unsigned)(((size_t)G * WARP + THREADS - 1) / THREADS);
  hat_wald_kernel<P, T, MODE><<<blocks, THREADS, 0, s>>>(
      G, N, (const T*)beta, (const T*)disp, (const T*)sf, (const T*)X, (const T*)contrast,
      (const T*)lfc_null, (T)min_mu, alt, (const T*)mu_in, (const T*)ridge, (T*)H, (T*)mu, (T*)pval,
      (T*)stat, (T*)se);
  return 0;
}

template <int MODE>
int dispatch(int is_f64, int P, int G, int N, const void* beta, const void* disp, const void* sf,
             const void* X, const void* contrast, const void* lfc_null, double min_mu, int alt,
             const void* mu_in, const void* ridge, void* H, void* mu, void* pval, void* stat, void* se,
             void* stream) {
  if (G <= 0) return (int)cudaSuccess;
  if (alt < ALT_NONE || alt > ALT_LESS) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_f64) {
    PDT_DISPATCH_P(P, (launch<PP, double, MODE>(G, N, beta, disp, sf, X, contrast, lfc_null, min_mu, alt,
                                                mu_in, ridge, H, mu, pval, stat, se, s)));
  } else {
    PDT_DISPATCH_P(P, (launch<PP, float, MODE>(G, N, beta, disp, sf, X, contrast, lfc_null, min_mu, alt,
                                               mu_in, ridge, H, mu, pval, stat, se, s)));
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int hat_wald_launch(int is_f64, int P, int G, int N, const void* beta, const void* disp,
                               const void* sf, const void* X, const void* contrast,
                               const void* lfc_null, double min_mu, int alt, void* H, void* mu,
                               void* pval, void* stat, void* se, void* stream) {
  return dispatch<MODE_FUSED>(is_f64, P, G, N, beta, disp, sf, X, contrast, lfc_null, min_mu, alt, nullptr,
                              nullptr, H, mu, pval, stat, se, stream);
}

extern "C" int hat_launch(int is_f64, int P, int G, int N, const void* beta, const void* disp, const void* sf,
                          const void* X, double min_mu, void* H, void* mu, void* stream) {
  return dispatch<MODE_HAT>(is_f64, P, G, N, beta, disp, sf, X, nullptr, nullptr, min_mu, ALT_NONE, nullptr,
                            nullptr, H, mu, nullptr, nullptr, nullptr, stream);
}

extern "C" int wald_launch(int is_f64, int P, int G, int N, const void* lfc, const void* disp, const void* mu,
                           const void* X, const void* ridge, const void* contrast, const void* lfc_null, int alt,
                           void* pval, void* stat, void* se, void* stream) {
  return dispatch<MODE_WALD>(is_f64, P, G, N, lfc, disp, nullptr, X, contrast, lfc_null, 0.0, alt, mu, ridge,
                             nullptr, nullptr, pval, stat, se, stream);
}
