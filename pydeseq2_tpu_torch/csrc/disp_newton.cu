// Dispersion Newton polish: (f, g, h) in log-alpha and the safeguarded
// Newton steps, all in one launch.
//
// Replaces fgh_closed + newton_body (pydeseq2_tpu/ops/dispersion.py:313,
// 361) with nb_nll_centered_fgh (ops/nb.py:283). One warp per gene; per
// evaluation the lanes stride the gene's row of N samples and reduce the NB
// value/gradient/curvature sums and the three Cox-Reid Grams
// M = X^T W X, M' and M'' (W = mu/(1 + mu a), W' = -a W^2,
// W'' = W' (1 - 2 a W)) by warp shuffle. r = exp(-la) is one value per
// gene, so each gene evaluates one branch: the Stirling-difference form
// for r >= 8, the plain form with lgamma, psi and psi' of y + r below it
// (Stirling-8 forms in float, the library lgamma and the series psi/psi'
// of common.cuh in double). The Newton acceptance logic (step clip,
// gradient-contraction gate, strict-descent fallback) is per-gene scalar
// work that every lane runs on the same values.
//
// Bound on the H100 by the transcendentals (log1p of y/r and mu/r per
// sample and evaluation, and lgamma/psi/psi' below r = 8): 5 evaluations
// per gene, each a pass over its row, which stays in L1/L2 after the first.
#include "common.cuh"

using namespace pdt;

namespace {

constexpr int THREADS = 256;

template <int P, typename T>
__device__ __forceinline__ void fgh(const T* __restrict__ y, const T* __restrict__ m,
                                    const T* __restrict__ X, int N, int lane, T la, int cr_reg,
                                    int prior_reg, T lah, T pdv, T& f, T& g, T& h) {
  const T r = m_exp(-la);
  const bool plain = r < T(R_SWITCH);
  const T ir = T(1) / r;
  const T ir3 = ir * ir * ir;
  T log_r = T(0), lg_r = T(0), psi_r = T(0), tri_r = T(0);
  if (plain) {
    log_r = m_log(r);
    lg_r = m_lgamma(r);
    psi_fast(r, psi_r, tri_r);
  }
  const T a = m_exp(la);

  T fs = T(0), gs = T(0), hs = T(0);
  T M0[NTRI<P>], M1[NTRI<P>], M2[NTRI<P>];
#pragma unroll
  for (int i = 0; i < NTRI<P>; ++i) M0[i] = M1[i] = M2[i] = T(0);

  for (int n = lane; n < N; n += WARP) {
    const T yv = y[n];
    const T mv = m[n];
    const T v = mv / r;
    const T l1p_v = m_log1p(v);
    const T yr = yv + r;
    const T mr = mv + r;
    const T s_v = mv / mr;
    if (!plain) {
      const T u = yv / r;
      const T l1p_u = m_log1p(u);
      const T s_u = yv / yr;
      const T q_u = yv * r / (yr * yr);
      const T q_v = mv * r / (mr * mr);
      const T iyr = T(1) / yr;
      const T iyr2 = iyr * iyr;
      fs += -r * (l1p_u - u) - (yv - T(0.5)) * l1p_u + r * (l1p_v - v) + yv * l1p_v +
            yv * ir * iyr / T(12) + (iyr2 * iyr - ir3) / T(360);
      const T dT5 = yv * (yv + T(2) * r) * ir * iyr2 / T(12);
      const T dT6 = (r * iyr2 * iyr2 - ir3) / T(120);
      gs += r * (l1p_u - s_u) - (yv - T(0.5)) * s_u - r * (l1p_v - s_v) + yv * s_v + dT5 + dT6;
      const T d2T5 =
          yv * (yv * yv + T(3) * r * yv + T(4) * r * r) * ir * iyr2 * iyr / T(12);
      const T d2T6 =
          (-r * iyr2 * iyr2 + T(4) * r * r * iyr2 * iyr2 * iyr - T(3) * ir3) / T(120);
      hs += -r * (l1p_u - s_u) + r * (s_u - q_u) - (yv - T(0.5)) * q_u + r * (l1p_v - s_v) -
            r * (s_v - q_v) + yv * q_v + d2T5 + d2T6;
    } else {
      const T lg_yr = lgamma_fast(yr);
      T psi_yr, tri_yr;
      psi_fast(yr, psi_yr, tri_yr);
      fs += -r * log_r - lg_yr + lg_r + yr * (log_r + l1p_v) - mv;
      const T yr_over = yr / mr;
      gs += r * (T(1) + psi_yr - psi_r - l1p_v - yr_over);
      hs += r * (l1p_v - T(1) - s_v + psi_r - psi_yr) + r * r * (tri_r - tri_yr) +
            r * (yv + T(2) * r) / mr - r * r * yr / (mr * mr);
    }
    if (cr_reg) {
      const T W = mv / (T(1) + mv * a);
      const T Wd1 = -a * W * W;
      const T Wd2 = Wd1 * (T(1) - T(2) * a * W);
      const T* xn = X + (size_t)n * P;
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const T xp = __ldg(xn + p);
#pragma unroll
        for (int q = p; q < P; ++q) {
          const T xpq = xp * __ldg(xn + q);
          M0[tri_idx<P>(p, q)] += W * xpq;
          M1[tri_idx<P>(p, q)] += Wd1 * xpq;
          M2[tri_idx<P>(p, q)] += Wd2 * xpq;
        }
      }
    }
  }
  f = warp_sum(fs);
  g = warp_sum(gs);
  h = warp_sum(hs);
  if (cr_reg) {
#pragma unroll
    for (int i = 0; i < NTRI<P>; ++i) {
      M0[i] = warp_sum(M0[i]);
      M1[i] = warp_sum(M1[i]);
      M2[i] = warp_sum(M2[i]);
    }
    T Minv[P * P], F1[P * P], F2[P * P];
    sym_inv<T, P>(M0, Minv);
    unpack<T, P>(M1, F1);
    unpack<T, P>(M2, F2);
    T A[P * P];
#pragma unroll
    for (int p = 0; p < P; ++p)
#pragma unroll
      for (int s = 0; s < P; ++s) {
        T acc = T(0);
#pragma unroll
        for (int q = 0; q < P; ++q) acc += Minv[p * P + q] * F1[q * P + s];
        A[p * P + s] = acc;
      }
    T tr_a = T(0), tr_m2 = T(0), tr_aa = T(0);
#pragma unroll
    for (int p = 0; p < P; ++p) {
      tr_a += A[p * P + p];
#pragma unroll
      for (int q = 0; q < P; ++q) {
        tr_m2 += Minv[p * P + q] * F2[q * P + p];
        tr_aa += A[p * P + q] * A[q * P + p];
      }
    }
    f = f + T(0.5) * sym_logdet<T, P>(M0);
    g = g + T(0.5) * tr_a;
    h = h + T(0.5) * (tr_m2 - tr_aa);
  }
  if (prior_reg) {
    const T d = la - lah;
    f = f + d * d / (T(2) * pdv);
    g = g + d / pdv;
    h = h + T(1) / pdv;
  }
}

template <int P, typename T>
__global__ void __launch_bounds__(THREADS)
    disp_newton_kernel(int G, int N, const T* __restrict__ counts, const T* __restrict__ mu,
                       const T* __restrict__ X, const T* __restrict__ la0,
                       const T* __restrict__ la_hat, const T* __restrict__ pdv_p, T lo, T hi,
                       T clipw, T step2, int iters, int cr_reg, int prior_reg,
                       T* __restrict__ la_out, T* __restrict__ f_out, T* __restrict__ g_out,
                       T* __restrict__ h_out) {
  const int gi = (int)(((size_t)blockIdx.x * THREADS + threadIdx.x) / WARP);
  const int lane = threadIdx.x & (WARP - 1);
  if (gi >= G) return;
  const T* y = counts + (size_t)gi * N;
  const T* m = mu + (size_t)gi * N;
  const T pdv = *pdv_p;
  const T lah = prior_reg ? la_hat[gi] : T(0);

  T la = la0[gi];
  T f, g, h;
  fgh<P, T>(y, m, X, N, lane, la, cr_reg, prior_reg, lah, pdv, f, g, h);
  for (int it = 0; it < iters; ++it) {
    const T raw = h > T(0) ? g / h : m_sign(g) * step2;
    const T step = m_min(m_max(raw, -clipw), clipw);
    const T cand = m_min(m_max(la - step, lo), hi);
    T fc, gc, hc;
    fgh<P, T>(y, m, X, N, lane, cand, cr_reg, prior_reg, lah, pdv, fc, gc, hc);
    // Gradient-contraction gate for small positive-curvature steps, strict
    // descent otherwise (pydeseq2_tpu/ops/dispersion.py:384-387).
    const bool contraction = (h > T(0)) && (m_abs(raw) <= clipw) && (m_abs(gc) <= m_abs(g));
    if (contraction || fc < f) {
      la = cand;
      f = fc;
      g = gc;
      h = hc;
    }
  }
  if (lane == 0) {
    la_out[gi] = la;
    f_out[gi] = f;
    g_out[gi] = g;
    h_out[gi] = h;
  }
}

template <int P, typename T>
int launch(int G, int N, const void* counts, const void* mu, const void* X, const void* la0,
           const void* la_hat, const void* pdv, double lo, double hi, double clipw,
           double step2, int iters, int cr_reg, int prior_reg, void* la_out, void* f_out,
           void* g_out, void* h_out, cudaStream_t s) {
  const unsigned blocks = (unsigned)(((size_t)G * WARP + THREADS - 1) / THREADS);
  disp_newton_kernel<P, T><<<blocks, THREADS, 0, s>>>(
      G, N, (const T*)counts, (const T*)mu, (const T*)X, (const T*)la0, (const T*)la_hat,
      (const T*)pdv, (T)lo, (T)hi, (T)clipw, (T)step2, iters, cr_reg, prior_reg, (T*)la_out,
      (T*)f_out, (T*)g_out, (T*)h_out);
  return 0;
}

__global__ void psi_f64_kernel(const double* __restrict__ x, int n, double* __restrict__ psi,
                               double* __restrict__ tri) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) {
    psi[i] = digamma_f64(x[i]);
    tri[i] = trigamma_f64(x[i]);
  }
}

}  // namespace

extern "C" int disp_newton_launch(int is_f64, int P, int G, int N, const void* counts,
                                  const void* mu, const void* X, const void* la0,
                                  const void* la_hat, const void* pdv, double lo, double hi,
                                  double clipw, double step2, int iters, int cr_reg,
                                  int prior_reg, void* la_out, void* f_out, void* g_out,
                                  void* h_out, void* stream) {
  if (G <= 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_f64) {
    PDT_DISPATCH_P(P, launch<PP, double>(G, N, counts, mu, X, la0, la_hat, pdv, lo, hi, clipw,
                                         step2, iters, cr_reg, prior_reg, la_out, f_out,
                                         g_out, h_out, s));
  } else {
    PDT_DISPATCH_P(P, launch<PP, float>(G, N, counts, mu, X, la0, la_hat, pdv, lo, hi, clipw,
                                        step2, iters, cr_reg, prior_reg, la_out, f_out,
                                        g_out, h_out, s));
  }
  return (int)cudaGetLastError();
}

// The float64 psi and psi' of common.cuh, elementwise, for checking them
// against torch.digamma / torch.polygamma(1, .) on the card.
extern "C" int psi_f64_launch(const void* x, int n, void* psi, void* tri, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  psi_f64_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>((const double*)x, n,
                                                                      (double*)psi,
                                                                      (double*)tri);
  return (int)cudaGetLastError();
}
