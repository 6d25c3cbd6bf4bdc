// Masked-lane IRLS for the NB GLM, one persistent loop per gene.
//
// Replaces irls_core (pydeseq2_tpu/ops/irls.py:45), a lax.while_loop that
// advances all genes until the slowest stops. Here one warp owns one gene
// and leaves its loop when the gene stops: while a gene is active its trip
// count is the JAX loop's global `it`, so stops, fallback flags and
// iterates are those of the masked loop, lane for lane. Each trip is one
// pass over the gene's row of N samples: mu, log(mu) and log(mu/sf) from
// the linear predictor of the new coefficients, the mu-part of the
// deviance (y + r) log1p(mu/r) - y log(mu) (the lgamma constant nll_const
// is computed once outside), and X^T W X and X^T W z for the next trip,
// reduced by warp shuffle. The P x P solve (closed forms for P <= 3,
// unrolled Cholesky to 8) is scalar work in registers. With step_tol > 0
// (float32) the loop stops after two consecutive steps below it, and the
// 2-step exact-Newton polish of the ridged NLL follows, kept only where it
// lowers the gradient sup-norm.
//
// Bound on the H100 by the transcendentals (exp and log1p per sample and
// trip) and by the trip-count tail: most genes stop within a few trips and
// their warps finish early instead of running masked to the slowest.
#include "common.cuh"

using namespace pdt;

namespace {

constexpr int THREADS = 256;

// One pass at coefficients b: the deviance mu-part and, for the next trip,
// the packed X^T W X (without ridge) and X^T W z.
template <int P, typename T>
__device__ __forceinline__ void irls_pass(const T* __restrict__ y, const T* __restrict__ sf,
                                          const T* __restrict__ log_sf,
                                          const T* __restrict__ X, int N, int lane,
                                          const T* b, T disp, T r, T min_mu, T log_min_mu,
                                          T* gram, T* rhs, T& mu_part) {
#pragma unroll
  for (int i = 0; i < NTRI<P>; ++i) gram[i] = T(0);
#pragma unroll
  for (int p = 0; p < P; ++p) rhs[p] = T(0);
  T dev = T(0);
  for (int n = lane; n < N; n += WARP) {
    const T* xn = X + (size_t)n * P;
    T xv[P];
    T xb = T(0);
#pragma unroll
    for (int p = 0; p < P; ++p) {
      xv[p] = __ldg(xn + p);
      xb = xb + b[p] * xv[p];
    }
    const T raw = __ldg(sf + n) * m_exp(xb);
    const bool clamped = raw < min_mu;
    const T mu = clamped ? min_mu : raw;
    const T lsf = __ldg(log_sf + n);
    const T log_mu = clamped ? log_min_mu : xb + lsf;
    const T log_mu_sf = clamped ? log_min_mu - lsf : xb;
    const T yv = y[n];
    dev += (yv + r) * m_log1p(mu / r) - (yv > T(0) ? yv * log_mu : T(0));
    const T W = mu / (T(1) + mu * disp);
    const T z = log_mu_sf + (yv - mu) / mu;
    const T Wz = W * z;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const T wp = W * xv[p];
#pragma unroll
      for (int q = p; q < P; ++q) gram[tri_idx<P>(p, q)] += wp * xv[q];
      rhs[p] += Wz * xv[p];
    }
  }
  mu_part = warp_sum(dev);
#pragma unroll
  for (int i = 0; i < NTRI<P>; ++i) gram[i] = warp_sum(gram[i]);
#pragma unroll
  for (int p = 0; p < P; ++p) rhs[p] = warp_sum(rhs[p]);
}

// Ridged NLL gradient at b and, with want_h, the packed exact Hessian
// X^T diag(mu (1 + a y)/(1 + a mu)^2) X (without ridge).
template <int P, typename T>
__device__ __forceinline__ void grad_pass(const T* __restrict__ y, const T* __restrict__ sf,
                                          const T* __restrict__ X, int N, int lane,
                                          const T* b, T disp, T inv_disp, T min_mu,
                                          bool want_h, T* grad, T* hess) {
#pragma unroll
  for (int p = 0; p < P; ++p) grad[p] = T(0);
#pragma unroll
  for (int i = 0; i < NTRI<P>; ++i) hess[i] = T(0);
  for (int n = lane; n < N; n += WARP) {
    const T* xn = X + (size_t)n * P;
    T xv[P];
    T xb = T(0);
#pragma unroll
    for (int p = 0; p < P; ++p) {
      xv[p] = __ldg(xn + p);
      xb = xb + b[p] * xv[p];
    }
    const T mu = m_max(__ldg(sf + n) * m_exp(xb), min_mu);
    const T yv = y[n];
    const T t = (inv_disp + yv) * mu / (inv_disp + mu);
#pragma unroll
    for (int p = 0; p < P; ++p) grad[p] += (t - yv) * xv[p];
    if (want_h) {
      const T den = T(1) + disp * mu;
      const T w = mu * (T(1) + disp * yv) / (den * den);
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const T wp = w * xv[p];
#pragma unroll
        for (int q = p; q < P; ++q) hess[tri_idx<P>(p, q)] += wp * xv[q];
      }
    }
  }
#pragma unroll
  for (int p = 0; p < P; ++p) grad[p] = warp_sum(grad[p]) + T(1e-6) * b[p];
  if (want_h) {
#pragma unroll
    for (int i = 0; i < NTRI<P>; ++i) hess[i] = warp_sum(hess[i]);
  }
}

template <int P, typename T>
__device__ __forceinline__ void add_ridge(T* M) {
#pragma unroll
  for (int p = 0; p < P; ++p) M[tri_idx<P>(p, p)] = M[tri_idx<P>(p, p)] + T(1e-6);
}

template <int P, typename T>
__device__ __forceinline__ T sup_norm(const T* v) {
  T s = m_abs(v[0]);
#pragma unroll
  for (int p = 1; p < P; ++p) s = m_max(s, m_abs(v[p]));
  return s;
}

template <int P, typename T>
__global__ void __launch_bounds__(THREADS)
    irls_kernel(int G, int N, const T* __restrict__ counts, const T* __restrict__ sf,
                const T* __restrict__ log_sf, const T* __restrict__ X,
                const T* __restrict__ disp_g, const T* __restrict__ beta_init,
                const T* __restrict__ nll_const_g, T min_mu, T beta_tol, T max_beta,
                T step_tol, T polish_cap, int maxiter, int polish_iters,
                T* __restrict__ beta_out, unsigned char* __restrict__ needs_fb_out,
                int* __restrict__ trips_out) {
  const int gi = (int)(((size_t)blockIdx.x * THREADS + threadIdx.x) / WARP);
  const int lane = threadIdx.x & (WARP - 1);
  if (gi >= G) return;
  const T* y = counts + (size_t)gi * N;
  const T disp = disp_g[gi];
  const T r = T(1) / disp;
  const T nll_const = nll_const_g[gi];
  const T log_min_mu = m_log(min_mu);

  T beta[P];
#pragma unroll
  for (int p = 0; p < P; ++p) beta[p] = beta_init[(size_t)gi * P + p];

  T gram[NTRI<P>], rhs[P], mu_part;
  irls_pass<P, T>(y, sf, log_sf, X, N, lane, beta, disp, r, min_mu, log_min_mu, gram, rhs,
                  mu_part);
  T dev = T(1000);
  bool active = true, needs_fb = false, prev_small = false;
  int it = 0;
  while (active && it < maxiter) {
    add_ridge<P, T>(gram);
    T beta_hat[P];
    sym_solve<T, P>(gram, rhs, beta_hat);
    ++it;
    bool diverged = false;
#pragma unroll
    for (int p = 0; p < P; ++p) diverged = diverged || (m_abs(beta_hat[p]) > max_beta);
    const bool new_fb = diverged || (it >= maxiter);
    const bool step_ok = !new_fb;

    T new_beta[P], dstep[P];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      new_beta[p] = step_ok ? beta_hat[p] : beta[p];
      dstep[p] = beta_hat[p] - beta[p];
    }
    irls_pass<P, T>(y, sf, log_sf, X, N, lane, new_beta, disp, r, min_mu, log_min_mu, gram,
                    rhs, mu_part);
    const T new_dev = T(-2) * (nll_const + mu_part);
    const T dev_ratio = m_abs(new_dev - dev) / (m_abs(new_dev) + T(0.1));
    bool still_active = step_ok && (dev_ratio > beta_tol);
    bool step_small = false;
    if (step_tol > T(0)) {
      step_small = sup_norm<P, T>(dstep) <= step_tol;
      still_active = still_active && !(step_small && prev_small);
    }
    if (step_ok) dev = new_dev;
#pragma unroll
    for (int p = 0; p < P; ++p) beta[p] = new_beta[p];
    active = still_active;
    needs_fb = needs_fb || new_fb;
    prev_small = step_small;
  }
  needs_fb = needs_fb || active;

  if (step_tol > T(0) && polish_iters > 0) {
    const T inv_disp = T(1) / disp;
    T g[P], H[NTRI<P>], b[P];
    grad_pass<P, T>(y, sf, X, N, lane, beta, disp, inv_disp, min_mu, true, g, H);
    const T g_old = sup_norm<P, T>(g);
#pragma unroll
    for (int p = 0; p < P; ++p) b[p] = beta[p];
    for (int i = 0; i < polish_iters; ++i) {
      if (i > 0) grad_pass<P, T>(y, sf, X, N, lane, b, disp, inv_disp, min_mu, true, g, H);
      add_ridge<P, T>(H);
      T d[P], cand[P];
      sym_solve<T, P>(H, g, d);
      bool ok = true;
      T move = T(0);
#pragma unroll
      for (int p = 0; p < P; ++p) {
        cand[p] = b[p] - d[p];
        ok = ok && isfinite(cand[p]) && (m_abs(cand[p]) <= max_beta);
        move = p == 0 ? m_abs(cand[p] - b[p]) : m_max(move, m_abs(cand[p] - b[p]));
      }
      ok = ok && (move <= polish_cap);
      if (ok) {
#pragma unroll
        for (int p = 0; p < P; ++p) b[p] = cand[p];
      }
    }
    grad_pass<P, T>(y, sf, X, N, lane, b, disp, inv_disp, min_mu, false, g, H);
    if (sup_norm<P, T>(g) < g_old) {
#pragma unroll
      for (int p = 0; p < P; ++p) beta[p] = b[p];
    }
  }

  if (lane == 0) {
#pragma unroll
    for (int p = 0; p < P; ++p) beta_out[(size_t)gi * P + p] = beta[p];
    needs_fb_out[gi] = needs_fb ? 1 : 0;
    trips_out[gi] = it;
  }
}

template <int P, typename T>
int launch(int G, int N, const void* counts, const void* sf, const void* log_sf, const void* X,
           const void* disp, const void* beta_init, const void* nll_const, double min_mu,
           double beta_tol, double max_beta, double step_tol, int maxiter, int polish_iters,
           void* beta_out, void* needs_fb, void* trips, cudaStream_t s) {
  const unsigned blocks = (unsigned)(((size_t)G * WARP + THREADS - 1) / THREADS);
  irls_kernel<P, T><<<blocks, THREADS, 0, s>>>(
      G, N, (const T*)counts, (const T*)sf, (const T*)log_sf, (const T*)X, (const T*)disp,
      (const T*)beta_init, (const T*)nll_const, (T)min_mu, (T)beta_tol, (T)max_beta,
      (T)step_tol, (T)(100.0 * step_tol), maxiter, polish_iters, (T*)beta_out,
      (unsigned char*)needs_fb, (int*)trips);
  return 0;
}

}  // namespace

extern "C" int irls_launch(int is_f64, int P, int G, int N, const void* counts, const void* sf,
                           const void* log_sf, const void* X, const void* disp,
                           const void* beta_init, const void* nll_const, double min_mu,
                           double beta_tol, double max_beta, double step_tol, int maxiter,
                           int polish_iters, void* beta_out, void* needs_fb, void* trips,
                           void* stream) {
  if (G <= 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_f64) {
    PDT_DISPATCH_P(P, launch<PP, double>(G, N, counts, sf, log_sf, X, disp, beta_init,
                                         nll_const, min_mu, beta_tol, max_beta, step_tol,
                                         maxiter, polish_iters, beta_out, needs_fb, trips, s));
  } else {
    PDT_DISPATCH_P(P, launch<PP, float>(G, N, counts, sf, log_sf, X, disp, beta_init,
                                        nll_const, min_mu, beta_tol, max_beta, step_tol,
                                        maxiter, polish_iters, beta_out, needs_fb, trips, s));
  }
  return (int)cudaGetLastError();
}
