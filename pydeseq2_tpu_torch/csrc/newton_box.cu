// Projected-Newton rescue of the NB GLM coefficients in the [-30, 30]^P box,
// one warp per selected lane.
//
// Replaces newton_box_nbglm (pydeseq2_tpu/ops/irls.py:272), a fori_loop of
// 60 Newton steps, each with 13 backtracking halvings, over every lane of
// the compacted rescue tile. Only the lanes the caller selects are used
// (1-2 of the 937-lane tile at 100 x 60000), so a warp whose lane is not
// selected writes beta_init and "no success" and leaves. A selected lane's
// warp runs the steps in order: one pass over the row for the ridged
// gradient and the exact Hessian, the damped solve (H + 1e-6 I + 1e-8 I) in
// registers, then the backtracking t = 1, 1/2, ..., 2^-12 on the
// lgamma-free objective sum (y + r) log1p(mu/r) - y log mu + ridge
// (irls.py:308-317), one pass per candidate. The search stops at the first
// improving t: the JAX loop evaluates the later t too but never replaces a
// captured step, so the iterate is the same. A step whose 13 halvings find
// no improvement leaves beta and f as they were, and every later step would
// repeat it exactly, so the lane leaves the loop there. The exit test is
// the projected-gradient sup-norm < 1e-5 of irls.py:366-370.
//
// Bound on the H100: for the selected lanes only, ~(1 + 13) passes of ~20
// operations per sample and step at most, far below a microsecond; the
// launch and the serial dependence of the steps (each pass ends in a warp
// reduction) set its time.
#include "common.cuh"

using namespace pdt;

namespace {

constexpr int THREADS = 256;

// Backtracking objective at b (the lgamma bulk cancels in comparisons).
template <int P, typename T>
__device__ __forceinline__ T box_objective(const T* __restrict__ y, const T* __restrict__ sf,
                                           const T* __restrict__ log_sf,
                                           const T* __restrict__ X, int N, int lane,
                                           const T* b, T r, T min_mu, T log_min_mu) {
  T acc = T(0);
  for (int n = lane; n < N; n += WARP) {
    T xv[P];
    const T xb = lin_pred<P, T>(X, n, b, xv);
    const T raw = __ldg(sf + n) * m_exp(xb);
    const bool clamped = raw < min_mu;
    const T mu = clamped ? min_mu : raw;
    const T log_mu = clamped ? log_min_mu : xb + __ldg(log_sf + n);
    const T yv = y[n];
    acc += (yv + r) * m_log1p(mu / r) - (yv > T(0) ? yv * log_mu : T(0));
  }
  T ss = b[0] * b[0];
#pragma unroll
  for (int p = 1; p < P; ++p) ss = ss + b[p] * b[p];
  return warp_sum(acc) + T(0.5) * T(1e-6) * ss;
}

template <int P, typename T>
__global__ void __launch_bounds__(THREADS)
    newton_box_kernel(int K, int N, const T* __restrict__ counts, const T* __restrict__ sf,
                      const T* __restrict__ log_sf, const T* __restrict__ X,
                      const T* __restrict__ disp_g, const T* __restrict__ beta_init,
                      const unsigned char* __restrict__ sel, T min_mu, T max_beta, T lo_edge,
                      T hi_edge, int maxiter, T* __restrict__ beta_out,
                      unsigned char* __restrict__ ok_out, int* __restrict__ passes_out) {
  const int gi = (int)(((size_t)blockIdx.x * THREADS + threadIdx.x) / WARP);
  const int lane = threadIdx.x & (WARP - 1);
  if (gi >= K) return;
  T beta[P];
#pragma unroll
  for (int p = 0; p < P; ++p) beta[p] = beta_init[(size_t)gi * P + p];
  int passes = 0;
  bool ok = false;
  if (sel == nullptr || sel[gi]) {
    const T* y = counts + (size_t)gi * N;
    const T disp = disp_g[gi];
    const T r = T(1) / disp;
    const T log_min_mu = m_log(min_mu);
    T f = box_objective<P, T>(y, sf, log_sf, X, N, lane, beta, r, min_mu, log_min_mu);
    passes = 1;
    T g[P], H[NTRI<P>];
    for (int it = 0; it < maxiter; ++it) {
      grad_pass<P, T>(y, sf, X, N, lane, beta, disp, r, min_mu, true, g, H);
      ++passes;
      add_diag<P, T>(H, T(1e-6));
      add_diag<P, T>(H, T(1e-8));
      T step[P];
      sym_solve<T, P>(H, g, step);
      T t = T(1);
      bool improved = false;
      for (int j = 0; j < 13 && !improved; ++j) {
        T cand[P];
#pragma unroll
        for (int p = 0; p < P; ++p) cand[p] = m_min(m_max(beta[p] - t * step[p], -max_beta), max_beta);
        const T fc = box_objective<P, T>(y, sf, log_sf, X, N, lane, cand, r, min_mu, log_min_mu);
        ++passes;
        if (fc < f) {
          improved = true;
          f = fc;
#pragma unroll
          for (int p = 0; p < P; ++p) beta[p] = cand[p];
        }
        t = t * T(0.5);
      }
      if (!improved) break;  // a fixed point: every later step is this one
    }
    grad_pass<P, T>(y, sf, X, N, lane, beta, disp, r, min_mu, false, g, H);
    ++passes;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const bool pinned = (beta[p] <= lo_edge && g[p] > T(0)) || (beta[p] >= hi_edge && g[p] < T(0));
      if (pinned) g[p] = T(0);
    }
    ok = sup_norm<P, T>(g) < T(1e-5);
  }
  if (lane == 0) {
#pragma unroll
    for (int p = 0; p < P; ++p) beta_out[(size_t)gi * P + p] = beta[p];
    ok_out[gi] = ok ? 1 : 0;
    passes_out[gi] = passes;
  }
}

template <int P, typename T>
int launch(int K, int N, const void* counts, const void* sf, const void* log_sf, const void* X,
           const void* disp, const void* beta_init, const void* sel, double min_mu,
           double max_beta, int maxiter, void* beta_out, void* ok_out, void* passes,
           cudaStream_t s) {
  const unsigned blocks = (unsigned)(((size_t)K * WARP + THREADS - 1) / THREADS);
  // The edges are rounded to T as the JAX comparison rounds its weakly
  // typed bounds (-30 and 30 in float32).
  newton_box_kernel<P, T><<<blocks, THREADS, 0, s>>>(
      K, N, (const T*)counts, (const T*)sf, (const T*)log_sf, (const T*)X, (const T*)disp,
      (const T*)beta_init, (const unsigned char*)sel, (T)min_mu, (T)max_beta,
      (T)(-max_beta + 1e-12), (T)(max_beta - 1e-12), maxiter, (T*)beta_out,
      (unsigned char*)ok_out, (int*)passes);
  return 0;
}

}  // namespace

extern "C" int newton_box_launch(int is_f64, int P, int K, int N, const void* counts,
                                 const void* sf, const void* log_sf, const void* X,
                                 const void* disp, const void* beta_init, const void* sel,
                                 double min_mu, double max_beta, int maxiter, void* beta_out,
                                 void* ok_out, void* passes, void* stream) {
  if (K <= 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_f64) {
    PDT_DISPATCH_P(P, launch<PP, double>(K, N, counts, sf, log_sf, X, disp, beta_init, sel,
                                         min_mu, max_beta, maxiter, beta_out, ok_out, passes, s));
  } else {
    PDT_DISPATCH_P(P, launch<PP, float>(K, N, counts, sf, log_sf, X, disp, beta_init, sel,
                                        min_mu, max_beta, maxiter, beta_out, ok_out, passes, s));
  }
  return (int)cudaGetLastError();
}
