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
//   row, the solve of H / cnst + 1e-10 I in registers, then the candidates
//   beta - t step, t = 2^-j for j = 0 .. 15, keeping the least j whose f is
//   below the current one (the JAX loop evaluates all 16 and captures the
//   first that improves). With rounds of M = 1 the candidates take a pass
//   each and the search stops at the first that improves. With M > 1, t = 1
//   takes a pass alone, as most steps keep it, and then rounds of M
//   candidates share one read of the row: each lane adds every candidate's
//   terms of its samples (each candidate's sum in the lane-strided order and
//   warp tree of a single pass, so its f has the bits of a pass of its own),
//   lane c forms candidate c's prior and f, and a ballot picks the least
//   improving j; the search stops at the first round that holds one, so the
//   step where no t improves, where the gene freezes, costs 1 + 15 / M
//   reads of the row, not 16. The gene freezes where no t improves or where
//   two consecutive decreases are below ftol (|f| + 1), ftol = 10
//   eps(dtype). Freezing is per gene and the JAX loop ends when every gene
//   is frozen or after 60 steps, so a warp leaving at its own freeze gives
//   the same iterate, whatever M;
// - the polish (two exact Newton steps, each kept only where it lowers the
//   gradient sup-norm), the converged flag |g| < 1e-6 and the inverse of
//   the unscaled Hessian (closed forms for P <= 3, Cholesky to 8).
// The Hessian keeps the JAX expression (y + s) s e / (s + e)^2, e =
// e^{xb + offset}, which is 0 in float32 where (s + e)^2 overflows.
//
// Bound on the H100 by the issue of the objective's terms (the precise exp
// and log1p of jnp.logaddexp per sample and candidate; PERF.md section 6
// gives the SASS count) and by the per-gene number of steps: most genes
// freeze within a few steps, and their warps free the slot for the next
// gene. A round of M candidates saves the reads of the row and the
// per-candidate prior, division and test, and costs the candidates a step
// that stops early never needed and M accumulators' registers, which the
// launch bound keeps at one candidate a pass's occupancy (rounds exist for
// P <= 3 only). passes_out counts the evaluations over the row that the
// JAX order needs (as rounds of one make them), evals_out those made,
// rounds_out the reads of the row.
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

  // The prior of nbinom_fn_batch (shrink.py:23-53) at b.
  __device__ __forceinline__ T prior(const T* b) const {
    T ss = T(0);
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const T v = p == si ? b[p] * T(0) : b[p];
      ss = p == 0 ? v * v : ss + v * v;
    }
    const T q = b[si] / ps;
    return ss / (T(2) * (pns * pns)) + m_log1p(q * q);
  }

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
    return prior(b) - ll;
  }

  // The candidates beta - t_c step, t_c = t0 2^-c, c = 0 .. M - 1, in one
  // read of the row: each lane sums every candidate's terms of its samples
  // in the order fn does; then lane c (< M) returns candidate c's f / cnst
  // (other lanes +inf). Each candidate's f has fn's bits.
  template <int M>
  __device__ T fn_round(const T* beta, const T* step, T t0, T cnst) const {
    T cb[M][P], ll[M];
    T t = t0;
#pragma unroll
    for (int c = 0; c < M; ++c) {
#pragma unroll
      for (int p = 0; p < P; ++p) cb[c][p] = beta[p] - t * step[p];
      ll[c] = T(0);
      t = t * T(0.5);
    }
    for (int n = lane; n < N; n += WARP) {
      T xv[P];
      const T* xn = X + (size_t)n * P;
#pragma unroll
      for (int p = 0; p < P; ++p) xv[p] = __ldg(xn + p);
      const T yv = y[n], o = __ldg(off + n), yps = yv + s;
#pragma unroll
      for (int c = 0; c < M; ++c) {
        T xb = T(0);
#pragma unroll
        for (int p = 0; p < P; ++p) xb = xb + cb[c][p] * xv[p];
        ll[c] += apeglm_ll_term(yv, yps, xb, o, log_s);
      }
    }
    T mine = T(0), cand[P];
#pragma unroll
    for (int c = 0; c < M; ++c) {
      const T v = warp_sum(ll[c]);
      if (lane == c) {
        mine = v;
#pragma unroll
        for (int p = 0; p < P; ++p) cand[p] = cb[c][p];
      }
    }
    if (lane >= M) return Lim<T>::inf();
    return (prior(cand) - mine) / cnst;
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

// Blocks an SM must hold: for P <= 2, and for rounds of M > 1, those of one
// candidate a pass at P = 2 (4 in float32, 3 in float64: 64 and 80
// registers), so that neither a round's accumulators nor the compiler's
// choice cut the warps an SM runs; wider designs take what they need.
template <int P, typename T, int M> constexpr int min_blocks() {
  return (P <= 2 || M > 1) ? (sizeof(T) == 8 ? 3 : 4) : 1;
}

// Rounds of M candidates after t = 1.
template <int P, typename T, int M>
__global__ void __launch_bounds__(THREADS, min_blocks<P, T, M>())
    shrink_kernel(int G, int N, const T* __restrict__ counts, const T* __restrict__ size,
                  const T* __restrict__ offset, const T* __restrict__ X, T pns, T ps, int si,
                  int maxiter, T ftol, T* __restrict__ beta_out, T* __restrict__ ih_out,
                  unsigned char* __restrict__ conv_out, int* __restrict__ trips_out,
                  int* __restrict__ passes_out, int* __restrict__ evals_out, int* __restrict__ rounds_out) {
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
  // passes as the JAX order needs them; a round's evaluations beyond those,
  // and the passes it folds into its one read of the row
  int passes = 3, spec = 0, merged = 0;

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
    if constexpr (M == 1) {
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
    } else {
      // t = 1 alone, then rounds j0 .. j0 + M - 1: the least j whose f is
      // below f, from the first round that holds one.
      int j = -1;
      {
        T cand[P];
#pragma unroll
        for (int p = 0; p < P; ++p) cand[p] = beta[p] - step[p];
        const T fc = gene.fn(cand) / cnst;
        ++passes;
        if (fc < f) {
          j = 0;
          f_new = fc;
        }
      }
      T t0 = T(0.5);
      for (int j0 = 1; j0 < 16 && j < 0; j0 += M) {
        const T fc = gene.template fn_round<M>(beta, step, t0, cnst);
        const unsigned hit = __ballot_sync(FULL, fc < f);
        const int need = hit != 0u ? __ffs(hit) : M;
        if (hit != 0u) {
          j = j0 + need - 1;
          f_new = __shfl_sync(FULL, fc, need - 1);
        }
        passes += need;
        spec += M - need;
        merged += need - 1;
#pragma unroll
        for (int c = 0; c < M; ++c) t0 = t0 * T(0.5);
      }
      if (j >= 0) {
        improved = true;
#pragma unroll 1
        for (int k = 0; k < j; ++k) t = t * T(0.5);
#pragma unroll
        for (int p = 0; p < P; ++p) beta[p] = beta[p] - t * step[p];
      }
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
    evals_out[gi] = passes + spec;
    rounds_out[gi] = passes - merged;
  }
}

template <int P, typename T, int M>
int launch(int G, int N, const void* counts, const void* size, const void* offset, const void* X,
           double pns, double ps, int si, int maxiter, double ftol, void* beta, void* ih,
           void* conv, void* trips, void* passes, void* evals, void* rounds, cudaStream_t s) {
  const unsigned blocks = (unsigned)(((size_t)G * WARP + THREADS - 1) / THREADS);
  shrink_kernel<P, T, M><<<blocks, THREADS, 0, s>>>(
      G, N, (const T*)counts, (const T*)size, (const T*)offset, (const T*)X, (T)pns, (T)ps, si,
      maxiter, (T)ftol, (T*)beta, (T*)ih, (unsigned char*)conv, (int*)trips, (int*)passes,
      (int*)evals, (int*)rounds);
  return 0;
}

// Candidates a round after t = 1 takes (ops/shrink.py:_shrink_round): 1, or
// 3 where P <= 3.
template <int P, typename T>
int launch_m(int M, int G, int N, const void* counts, const void* size, const void* offset,
             const void* X, double pns, double ps, int si, int maxiter, double ftol, void* beta,
             void* ih, void* conv, void* trips, void* passes, void* evals, void* rounds,
             cudaStream_t s) {
  if (M == 1)
    return launch<P, T, 1>(G, N, counts, size, offset, X, pns, ps, si, maxiter, ftol, beta, ih,
                           conv, trips, passes, evals, rounds, s);
  if constexpr (P <= 3) {
    if (M == 3)
      return launch<P, T, 3>(G, N, counts, size, offset, X, pns, ps, si, maxiter, ftol, beta, ih,
                             conv, trips, passes, evals, rounds, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int shrink_launch(int is_f64, int P, int G, int N, const void* counts,
                             const void* size, const void* offset, const void* X, double pns,
                             double ps, int shrink_index, int maxiter, double ftol, int M,
                             void* beta, void* ih, void* conv, void* trips, void* passes,
                             void* evals, void* rounds, void* stream) {
  if (G <= 0) return (int)cudaSuccess;
  if (shrink_index < 0 || shrink_index >= P) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int rc = 0;
  if (is_f64) {
    PDT_DISPATCH_P(P, rc = launch_m<PP, double>(M, G, N, counts, size, offset, X, pns, ps,
                                                shrink_index, maxiter, ftol, beta, ih, conv, trips,
                                                passes, evals, rounds, s));
  } else {
    PDT_DISPATCH_P(P, rc = launch_m<PP, float>(M, G, N, counts, size, offset, X, pns, ps,
                                               shrink_index, maxiter, ftol, beta, ih, conv, trips,
                                               passes, evals, rounds, s));
  }
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}
