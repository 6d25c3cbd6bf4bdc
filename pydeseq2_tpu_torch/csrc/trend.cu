// The parametric dispersion trend with its gene-exclusion rounds, one block;
// and one standalone gamma-GLM fit on a caller's mask (trend_fit_launch).
//
// Replaces pydeseq2_tpu/fused.py:212 fit_fused_trend's parametric branch
// (the exclusion while_loop, :264-292) and, inside each round,
// pydeseq2_tpu/ops/trend.py:22 gamma_glm_trend_fit (the projected
// Fisher-scoring fit of mu = a0 + a1 x, x = 1/base_mean, minimising
// mean(y/mu + log mu) over the valid genes, with backtracking, :71-129).
//
// A single block of 1024 threads runs every round and every Newton and
// backtracking trip: the loop conditions are read on the card, so the
// host reads none of them. Each loss, gradient and Fisher sum over the G
// genes is one block reduction in a fixed order (each thread's strided
// lanes in order, a warp xor tree, then the 32 warp sums by a second xor
// tree that every warp runs), and every thread ends with the same bits, so
// all threads take the same branches. Each term is computed in T and summed
// in double, the total rounded to T, as the plain version does: in float32
// a 60000-term sum in another order would move by more than the stall
// tolerance, and the two fits would stop after different trips. The per-gene mask of the current
// round lives in a scratch byte array; each thread reads and writes only
// its own lanes. Expressions follow the plain version term by term
// (--fmad=false): the clamped-lane gradient factor (1 above 1e-12, 1/2 at
// the tie, 0 below), the 1e-12 ridge on the Fisher matrix, the 2 x 2 solve
// by LU with partial pivoting as LAPACK factors it (multiplier by the
// reciprocal of the pivot), the stall test 10 eps (|f| + 1) and the
// decrement test 1e3 eps (|f| + 1).
//
// Output: coefficients, the failed flag (a round whose fit did not
// converge or has a coefficient <= 1e-10), the number of rounds, and
// fitted = failed ? mean_disp : a0 + a1 / base_mean for every gene.
//
// trend_fit runs the same fit (gamma_fit below, the same block sums) once
// on the caller's covariates, targets and mask and writes the coefficients,
// the predictions a0 + a1 x of every lane and the converged flag: the class
// API's exclusion loop (models/dataset.py) reads only that, once a round.
// Lanes outside the mask are skipped, not multiplied by zero as in the
// plain version; the two differ only where such a lane is non-finite, which
// no caller passes.
//
// Bound on the H100 by its operations and its serial chain of block
// reductions: ~40 operations per gene per Fisher step over data (0.54 MB at
// 60000 genes) that stays in L2.
#include "common.cuh"

using namespace pdt;

namespace {

constexpr int THREADS = 1024;
constexpr int NWARP = THREADS / WARP;
constexpr double LOWER = 1e-12;

template <typename T> struct Eps;
template <> struct Eps<float> {
  static constexpr double v = 1.1920928955078125e-07;  // 2^-23
};
template <> struct Eps<double> {
  static constexpr double v = 2.220446049250313e-16;  // 2^-52
};

// Block-wide sum of K values per thread; every thread gets the totals.
template <int K> __device__ __forceinline__ void block_sum(double (&v)[K], double* shm) {
  const int warp = threadIdx.x / WARP, lane = threadIdx.x & (WARP - 1);
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = warp_sum(v[k]);
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) shm[k * NWARP + warp] = v[k];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = warp_sum(shm[k * NWARP + lane]);
  __syncthreads();  // shm is reused by the next reduction
}

template <typename T> struct Lane {
  T x, t;  // covariate and target, both 0 outside the initial mask
};

template <typename T>
__device__ __forceinline__ Lane<T> lane_of(const T* bm, const T* gm, const unsigned char* nz, int i,
                                           bool& valid0) {
  const T cov = T(1) / bm[i];
  const T g = gm[i];
  valid0 = nz[i] != 0 && isfinite(cov) && isfinite(g);
  return {valid0 ? cov : T(0), valid0 ? g : T(0)};
}

// mean over valid lanes of t/mu + log mu, mu = max(c0 + c1 x, 1e-12);
// lanes(i) gives lane i's covariate and target
template <typename T, typename L>
__device__ T loss(T c0, T c1, int G, const L& lanes, const unsigned char* valid, T n, double* shm) {
  double s[1] = {0.0};
  for (int i = threadIdx.x; i < G; i += THREADS) {
    if (!valid[i]) continue;
    const Lane<T> l = lanes(i);
    const T ms = m_max(c0 + l.x * c1, T(LOWER));
    const T per = l.t / ms + m_log(ms);
    s[0] += double(per);
  }
  block_sum<1>(s, shm);
  return T(s[0]) / n;
}

// gradient (g0, g1) and Fisher matrix (F00, F01, F11), each divided by n
template <typename T, typename L>
__device__ void grad_fisher(T c0, T c1, int G, const L& lanes, const unsigned char* valid, T n, double* shm,
                            T* g, T* F) {
  double s[5] = {0.0, 0.0, 0.0, 0.0, 0.0};
  for (int i = threadIdx.x; i < G; i += THREADS) {
    if (!valid[i]) continue;
    const Lane<T> l = lanes(i);
    const T mu = c0 + l.x * c1;
    const T ms = m_max(mu, T(LOWER));
    const T dper = -l.t / (ms * ms) + T(1) / ms;
    const T dmax = mu > T(LOWER) ? T(1) : (mu == T(LOWER) ? T(0.5) : T(0));
    const T gmu = dper * dmax / n;
    const T wm = T(1) / (ms * ms);
    const T xgmu = l.x * gmu, wmx = wm * l.x, xwmx = (l.x * wm) * l.x;
    s[0] += double(gmu);
    s[1] += double(xgmu);
    s[2] += double(wm);
    s[3] += double(wmx);
    s[4] += double(xwmx);
  }
  block_sum<5>(s, shm);
  g[0] = T(s[0]);
  g[1] = T(s[1]);
  F[0] = T(s[2]) / n + T(LOWER);
  F[1] = T(s[3]) / n;
  F[2] = T(s[4]) / n + T(LOWER);
}

// Solve [[a, b], [b', d]] x = r by LU with partial pivoting (getrf/getrs).
template <typename T> __device__ __forceinline__ void solve2(const T* F, const T* r, T* x) {
  T a = F[0], b = F[1], c = F[1], d = F[2], r0 = r[0], r1 = r[1];
  if (m_abs(c) > m_abs(a)) {
    T t = a; a = c; c = t;
    t = b; b = d; d = t;
    t = r0; r0 = r1; r1 = t;
  }
  const T l = c * (T(1) / a);
  const T u11 = d - l * b;
  const T y1 = r1 - l * r0;
  x[1] = y1 / u11;
  x[0] = (r0 - x[1] * b) / a;
}

// One gamma_glm_trend_fit (ops/trend.py:22) on the lanes marked in valid,
// n of them (at least 1): projected Fisher scoring from (1, 1) with up to
// 20 halvings a step, stopping when no halving improves the loss or the
// gain is below 10 eps (|f| + 1); converged = the projected Newton
// decrement at the final point is below 1e3 eps (|f| + 1).
template <typename T, typename L>
__device__ void gamma_fit(int G, int maxiter, const L& lanes, const unsigned char* valid, T n, double* shm,
                          T& c0, T& c1, bool& converged) {
  const T tiny_f = T(10.0 * Eps<T>::v);
  const T ftol = T(1e3 * Eps<T>::v);
  const T at_bound_c = T(LOWER * (1 + 1e-9));
  c0 = T(1);
  c1 = T(1);
  T f_val = loss(c0, c1, G, lanes, valid, n, shm);
  for (int it = 0; it < maxiter; ++it) {
    T g[2], F[3], step[2];
    grad_fisher(c0, c1, G, lanes, valid, n, shm, g, F);
    solve2(F, g, step);
    T t = T(1);
    T best0 = c0, best1 = c1, best_f = f_val;
    bool improved = false;
    for (int j = 0; j < 20; ++j) {
      const T k0 = m_max(c0 - t * step[0], T(LOWER));
      const T k1 = m_max(c1 - t * step[1], T(LOWER));
      const T f_cand = loss(k0, k1, G, lanes, valid, n, shm);
      if (f_cand < best_f) {
        best0 = k0;
        best1 = k1;
        best_f = f_cand;
        improved = true;
        break;
      }
      t = t * T(0.5);
    }
    const T tiny = tiny_f * (m_abs(f_val) + T(1));
    const bool stalled = !improved || (f_val - best_f <= tiny);
    c0 = best0;
    c1 = best1;
    f_val = best_f;
    if (stalled) break;
  }
  // projected Newton decrement at the final point
  T g[2], F[3], sol[2];
  grad_fisher(c0, c1, G, lanes, valid, n, shm, g, F);
  T pg[2];
  pg[0] = (c0 <= at_bound_c && g[0] > T(0)) ? T(0) : g[0];
  pg[1] = (c1 <= at_bound_c && g[1] > T(0)) ? T(0) : g[1];
  solve2(F, pg, sol);
  const T decrement = (T(0.5) * pg[0]) * sol[0] + (T(0.5) * pg[1]) * sol[1];
  converged = isfinite(f_val) && decrement <= ftol * (m_abs(f_val) + T(1));
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    trend_kernel(int G, int max_rounds, int maxiter, const T* __restrict__ bm,
                 const T* __restrict__ gm, const unsigned char* __restrict__ nz,
                 const T* __restrict__ mean_disp_p, unsigned char* __restrict__ valid,
                 T* __restrict__ fitted, T* __restrict__ coeffs_out,
                 unsigned char* __restrict__ failed_out, int* __restrict__ rounds_out) {
  __shared__ double shm[5 * NWARP];

  for (int i = threadIdx.x; i < G; i += THREADS) {
    bool v0;
    lane_of(bm, gm, nz, i, v0);
    valid[i] = v0 ? 1 : 0;
  }

  T coeffs[2] = {T(1), T(1)};
  bool failed = false;
  T drift = Lim<T>::inf();
  int rounds = 0;
  while (!failed && drift >= T(1e-6) && rounds < max_rounds) {
    double cnt[1] = {0.0};
    for (int i = threadIdx.x; i < G; i += THREADS) cnt[0] += valid[i] ? 1.0 : 0.0;
    block_sum<1>(cnt, shm);
    const T n = m_max(T(cnt[0]), T(1));

    // ---- gamma_glm_trend_fit on the current mask ----
    const auto lanes = [&](int i) {
      bool v0;
      return lane_of(bm, gm, nz, i, v0);
    };
    T c0, c1;
    bool converged;
    gamma_fit(G, maxiter, lanes, valid, n, shm, c0, c1, converged);

    // ---- the exclusion round (fused.py:276-283) ----
    failed = !converged || c0 <= T(1e-10) || c1 <= T(1e-10);
    const T l0 = m_log(m_abs(c0 / coeffs[0]));
    const T l1 = m_log(m_abs(c1 / coeffs[1]));
    drift = l0 * l0 + l1 * l1;
    for (int i = threadIdx.x; i < G; i += THREADS) {
      if (!valid[i]) continue;
      bool v0;
      const Lane<T> l = lane_of(bm, gm, nz, i, v0);
      const T ratio = gm[i] / (c0 + l.x * c1);
      valid[i] = (ratio >= T(1e-4) && ratio < T(15)) ? 1 : 0;
    }
    coeffs[0] = c0;
    coeffs[1] = c1;
    ++rounds;
  }

  const T mean_disp = *mean_disp_p;
  for (int i = threadIdx.x; i < G; i += THREADS)
    fitted[i] = failed ? mean_disp : coeffs[0] + coeffs[1] / bm[i];
  if (threadIdx.x == 0) {
    coeffs_out[0] = coeffs[0];
    coeffs_out[1] = coeffs[1];
    failed_out[0] = failed ? 1 : 0;
    rounds_out[0] = rounds;
  }
}

// One standalone fit on the caller's mask (the class API's exclusion loop
// runs on the host and calls this once a round): coefficients, the
// predictions c0 + c1 x of every lane, and the converged flag.
template <typename T>
__global__ void __launch_bounds__(THREADS)
    trend_fit_kernel(int G, int maxiter, const T* __restrict__ cov, const T* __restrict__ tar,
                     const unsigned char* __restrict__ valid, T* __restrict__ coeffs_out,
                     T* __restrict__ pred, unsigned char* __restrict__ converged_out) {
  __shared__ double shm[5 * NWARP];
  double cnt[1] = {0.0};
  for (int i = threadIdx.x; i < G; i += THREADS) cnt[0] += valid[i] ? 1.0 : 0.0;
  block_sum<1>(cnt, shm);
  const T n = m_max(T(cnt[0]), T(1));
  const auto lanes = [&](int i) { return Lane<T>{cov[i], tar[i]}; };
  T c0, c1;
  bool converged;
  gamma_fit(G, maxiter, lanes, valid, n, shm, c0, c1, converged);
  for (int i = threadIdx.x; i < G; i += THREADS) pred[i] = c0 + cov[i] * c1;
  if (threadIdx.x == 0) {
    coeffs_out[0] = c0;
    coeffs_out[1] = c1;
    converged_out[0] = converged ? 1 : 0;
  }
}

template <typename T>
int launch(int G, int max_rounds, int maxiter, const void* bm, const void* gm, const void* nz,
           const void* mean_disp, void* valid, void* fitted, void* coeffs, void* failed,
           void* rounds, cudaStream_t s) {
  trend_kernel<T><<<1, THREADS, 0, s>>>(G, max_rounds, maxiter, (const T*)bm, (const T*)gm,
                                        (const unsigned char*)nz, (const T*)mean_disp,
                                        (unsigned char*)valid, (T*)fitted, (T*)coeffs,
                                        (unsigned char*)failed, (int*)rounds);
  return 0;
}

}  // namespace

extern "C" int trend_launch(int is_f64, int G, int max_rounds, int maxiter, const void* base_mean,
                            const void* genewise_m, const void* non_zero, const void* mean_disp,
                            void* valid, void* fitted, void* coeffs, void* failed, void* rounds,
                            void* stream) {
  if (G <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_f64) {
    launch<double>(G, max_rounds, maxiter, base_mean, genewise_m, non_zero, mean_disp, valid,
                   fitted, coeffs, failed, rounds, s);
  } else {
    launch<float>(G, max_rounds, maxiter, base_mean, genewise_m, non_zero, mean_disp, valid,
                  fitted, coeffs, failed, rounds, s);
  }
  return (int)cudaGetLastError();
}

extern "C" int trend_fit_launch(int is_f64, int G, int maxiter, const void* covariates, const void* targets,
                                const void* valid, void* coeffs, void* predictions, void* converged,
                                void* stream) {
  if (G <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_f64) {
    trend_fit_kernel<double><<<1, THREADS, 0, s>>>(G, maxiter, (const double*)covariates, (const double*)targets,
                                                   (const unsigned char*)valid, (double*)coeffs,
                                                   (double*)predictions, (unsigned char*)converged);
  } else {
    trend_fit_kernel<float><<<1, THREADS, 0, s>>>(G, maxiter, (const float*)covariates, (const float*)targets,
                                                  (const unsigned char*)valid, (float*)coeffs,
                                                  (float*)predictions, (unsigned char*)converged);
  }
  return (int)cudaGetLastError();
}
