// apeGLM MAP shrinkage fit, one warp per gene.
//
// Replaces nbinom_glm_batch (pydeseq2_tpu/ops/shrink.py:101), a masked
// while_loop of damped Newton steps over every gene with 16-halving
// backtracking, a 2-step gradient-gated polish and the inverse Hessian. One
// warp runs one gene's fit in the JAX order:
// - cnst = max(f(0), 1), the optimisation scale (shrink.py:142-147), and the
//   scale-aware start (intercept log max(mean(y e^-offset), 0.1), the other
//   coefficients +/-0.1);
// - the Newton loop on f / cnst: gradient and Hessian in one pass over the
//   row, the solve of H / cnst + 1e-10 I in registers, then candidates
//   beta - t step for t = 1, 1/2, ..., 2^-15, one pass each, stopping at the
//   first that lowers f (the JAX loop evaluates the rest but never replaces
//   a captured step). The gene freezes where no t improves or where two
//   consecutive decreases are below ftol (|f| + 1), ftol = 10 eps(dtype).
//   Freezing is per gene and the JAX loop ends when every gene is frozen or
//   after 60 steps, so a warp leaving at its own freeze gives the same
//   iterate;
// - the polish (two exact Newton steps, each kept only where it lowers the
//   gradient sup-norm), the converged flag |g| < 1e-6 and the inverse of
//   the unscaled Hessian (closed forms for P <= 3, Cholesky to 8).
// The Hessian keeps the JAX expression (y + s) s e / (s + e)^2, e =
// e^{xb + offset}, which is 0 in float32 where (s + e)^2 overflows.
//
// Bound on the H100 by the transcendentals of the objective passes (exp,
// log1p and exp again per sample and pass) and by the per-gene number of
// steps: most genes freeze within a few steps, and their warps free the
// slot for the next gene.
#include "common.cuh"

using namespace pdt;

namespace {

constexpr int THREADS = 256;

// One gene's row and its apeGLM constants; si is the shrunk coefficient.
template <int P, typename T> struct Gene {
  const T* y;
  const T* off;
  const T* X;
  int N, lane, si;
  T s, log_s, pns, ps;

  // nbinom_fn_batch (shrink.py:23-53): prior minus log-likelihood.
  __device__ T fn(const T* b) const {
    T ll = T(0);
    for (int n = lane; n < N; n += WARP) {
      T xv[P];
      const T xb = lin_pred<P, T>(X, n, b, xv);
      const T yv = y[n];
      ll += apeglm_ll_term(yv, yv + s, xb, __ldg(off + n), log_s);
    }
    ll = warp_sum(ll);
    T ss = T(0);
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const T v = p == si ? b[p] * T(0) : b[p];
      ss = p == 0 ? v * v : ss + v * v;
    }
    const T q = b[si] / ps;
    const T prior = ss / (T(2) * (pns * pns)) + m_log1p(q * q);
    return prior - ll;
  }

  // _grad (shrink.py:56-70) and, with want_h, _hess (:73-91), unscaled;
  // the Hessian packed.
  __device__ void grad_hess(const T* b, bool want_g, bool want_h, T* g, T* H) const {
#pragma unroll
    for (int p = 0; p < P; ++p) g[p] = T(0);
#pragma unroll
    for (int i = 0; i < NTRI<P>; ++i) H[i] = T(0);
    for (int n = lane; n < N; n += WARP) {
      T xv[P];
      const T xb = lin_pred<P, T>(X, n, b, xv);
      const T yv = y[n];
      const T o = __ldg(off + n);
      const T yps = yv + s;
      if (want_g) {
        const T d = yv - yps / (T(1) + s * m_exp(-xb - o));
#pragma unroll
        for (int p = 0; p < P; ++p) g[p] += d * xv[p];
      }
      if (want_h) {
        const T e = m_exp(xb + o);
        const T se = s + e;
        const T frac = yps * s * e / (se * se);
#pragma unroll
        for (int p = 0; p < P; ++p) {
          const T fp = frac * xv[p];
#pragma unroll
          for (int q = p; q < P; ++q) H[tri_idx<P>(p, q)] += fp * xv[q];
        }
      }
    }
    const T bs = b[si];
    const T den = ps * ps + bs * bs;
    if (want_g) {
      // b nsm / pns^2 + 2 b sm / (ps^2 + bs^2): one of the two terms is 0
      const T pns2 = pns * pns;
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const T d_neg_prior = p == si ? (T(2) * b[p]) / den : b[p] / pns2;
        g[p] = d_neg_prior - warp_sum(g[p]);
      }
    }
    if (want_h) {
      const T h11 = T(1) / (pns * pns);
      const T h22 = T(2) * (ps * ps - bs * bs) / (den * den);
#pragma unroll
      for (int i = 0; i < NTRI<P>; ++i) H[i] = warp_sum(H[i]);
#pragma unroll
      for (int p = 0; p < P; ++p) H[tri_idx<P>(p, p)] = H[tri_idx<P>(p, p)] + (p == si ? h22 : h11);
    }
  }
};

template <int M, typename T> __device__ __forceinline__ void scale(T* v, T c) {
#pragma unroll
  for (int i = 0; i < M; ++i) v[i] = v[i] / c;
}

template <int P, typename T>
__global__ void __launch_bounds__(THREADS)
    shrink_kernel(int G, int N, const T* __restrict__ counts, const T* __restrict__ size,
                  const T* __restrict__ offset, const T* __restrict__ X, T pns, T ps, int si,
                  int maxiter, T ftol, T* __restrict__ beta_out, T* __restrict__ ih_out,
                  unsigned char* __restrict__ conv_out, int* __restrict__ trips_out,
                  int* __restrict__ passes_out) {
  const int gi = (int)(((size_t)blockIdx.x * THREADS + threadIdx.x) / WARP);
  const int lane = threadIdx.x & (WARP - 1);
  if (gi >= G) return;
  Gene<P, T> gene;
  gene.y = counts + (size_t)gi * N;
  gene.off = offset;
  gene.X = X;
  gene.N = N;
  gene.lane = lane;
  gene.si = si;
  gene.s = size[gi];
  gene.log_s = m_log(gene.s);
  gene.pns = pns;
  gene.ps = ps;

  // Optimisation scale and start (shrink.py:132-147).
  T beta[P];
#pragma unroll
  for (int p = 0; p < P; ++p) beta[p] = T(0);
  const T cnst = m_max(gene.fn(beta), T(1));
  T acc = T(0);
  for (int n = lane; n < N; n += WARP) acc += gene.y[n] * m_exp(-__ldg(offset + n));
  beta[0] = m_log(m_max(warp_sum(acc) / T(N), T(0.1)));
#pragma unroll
  for (int p = 1; p < P; ++p) beta[p] = (p & 1) ? -T(0.1) : T(0.1);
  T f = gene.fn(beta) / cnst;
  int passes = 3;

  T g[P], H[NTRI<P>];
  int it = 0;
  bool done = false, prev_small = false;
  while (!done && it < maxiter) {
    gene.grad_hess(beta, true, true, g, H);
    ++passes;
    scale<P, T>(g, cnst);
    scale<NTRI<P>, T>(H, cnst);
    add_diag<P, T>(H, T(1e-10));
    T step[P];
    sym_solve<T, P>(H, g, step);
    T t = T(1);
    bool improved = false;
    T f_new = f;
    for (int j = 0; j < 16 && !improved; ++j) {
      T cand[P];
#pragma unroll
      for (int p = 0; p < P; ++p) cand[p] = beta[p] - t * step[p];
      const T fc = gene.fn(cand) / cnst;
      ++passes;
      if (fc < f) {
        improved = true;
        f_new = fc;
#pragma unroll
        for (int p = 0; p < P; ++p) beta[p] = cand[p];
      }
      t = t * T(0.5);
    }
    const bool small = (f - f_new) < ftol * (m_abs(f_new) + T(1));
    done = !improved || (small && prev_small);
    prev_small = small;
    f = f_new;
    ++it;
  }

  // Polish (shrink.py:225-250), on the scaled gradient.
  T gs[P];
  gene.grad_hess(beta, true, false, gs, H);
  ++passes;
  scale<P, T>(gs, cnst);
  for (int i = 0; i < 2; ++i) {
    gene.grad_hess(beta, false, true, g, H);
    scale<NTRI<P>, T>(H, cnst);
    add_diag<P, T>(H, T(1e-10));
    T d[P], cand[P], gc[P];
    sym_solve<T, P>(H, gs, d);
    bool ok = true;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      cand[p] = beta[p] - d[p];
      ok = ok && isfinite(cand[p]) && (m_abs(cand[p]) <= T(30));
    }
    gene.grad_hess(cand, true, false, gc, H);
    passes += 2;
    scale<P, T>(gc, cnst);
    if (ok && sup_norm<P, T>(gc) < sup_norm<P, T>(gs)) {
#pragma unroll
      for (int p = 0; p < P; ++p) {
        beta[p] = cand[p];
        gs[p] = gc[p];
      }
    }
  }
  bool conv = sup_norm<P, T>(gs) < T(1e-6);
#pragma unroll
  for (int p = 0; p < P; ++p) conv = conv && isfinite(beta[p]);

  gene.grad_hess(beta, false, true, g, H);
  ++passes;
  T inv[P * P];
  sym_inv<T, P>(H, inv);
  if (lane == 0) {
#pragma unroll
    for (int p = 0; p < P; ++p) beta_out[(size_t)gi * P + p] = beta[p];
#pragma unroll
    for (int i = 0; i < P * P; ++i) ih_out[(size_t)gi * P * P + i] = inv[i];
    conv_out[gi] = conv ? 1 : 0;
    trips_out[gi] = it;
    passes_out[gi] = passes;
  }
}

template <int P, typename T>
int launch(int G, int N, const void* counts, const void* size, const void* offset, const void* X,
           double pns, double ps, int si, int maxiter, double ftol, void* beta, void* ih,
           void* conv, void* trips, void* passes, cudaStream_t s) {
  const unsigned blocks = (unsigned)(((size_t)G * WARP + THREADS - 1) / THREADS);
  shrink_kernel<P, T><<<blocks, THREADS, 0, s>>>(
      G, N, (const T*)counts, (const T*)size, (const T*)offset, (const T*)X, (T)pns, (T)ps, si,
      maxiter, (T)ftol, (T*)beta, (T*)ih, (unsigned char*)conv, (int*)trips, (int*)passes);
  return 0;
}

}  // namespace

extern "C" int shrink_launch(int is_f64, int P, int G, int N, const void* counts,
                             const void* size, const void* offset, const void* X, double pns,
                             double ps, int shrink_index, int maxiter, double ftol, void* beta,
                             void* ih, void* conv, void* trips, void* passes, void* stream) {
  if (G <= 0) return (int)cudaSuccess;
  if (shrink_index < 0 || shrink_index >= P) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_f64) {
    PDT_DISPATCH_P(P, launch<PP, double>(G, N, counts, size, offset, X, pns, ps, shrink_index,
                                         maxiter, ftol, beta, ih, conv, trips, passes, s));
  } else {
    PDT_DISPATCH_P(P, launch<PP, float>(G, N, counts, size, offset, X, pns, ps, shrink_index,
                                        maxiter, ftol, beta, ih, conv, trips, passes, s));
  }
  return (int)cudaGetLastError();
}
