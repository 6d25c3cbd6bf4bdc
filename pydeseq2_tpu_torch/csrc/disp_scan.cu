// Coarse dispersion scan: the NB objective at the static grid points.
//
// Replaces scan_coarse (pydeseq2_tpu/ops/dispersion.py:196), with
// nb_nll_centered (ops/nb.py:135) and the Cox-Reid sym_logdet. One warp per
// gene: for each grid point la_k the lanes stride the gene's contiguous row
// of N samples, sum the centred NB terms and the P(P+1)/2 entries of
// X^T diag(mu/(1 + mu alpha)) X, and reduce them by warp shuffle; every lane
// then holds the same sums and evaluates the point's objective, the strict
// first-minimum rule and the argmin redundantly. The branch per point is
// the JAX scan's: the stable form below bnd_start, the plain form from
// bnd_end on, and r < 8 per gene in the straddling chunk (the "auto" form,
// whose plain part shares log(r) + log1p(mu/r)).
//
// Bound on the H100 by the transcendentals (two log1p per sample and point
// in the stable form, lgamma and log in the plain form); the counts and mu
// rows are read from device memory once and then hit L1/L2 for the other
// 31 points. Writes the (K, G) objective cache and the argmin.
#include "common.cuh"

using namespace pdt;

namespace {

constexpr int THREADS = 256;
enum Form { STABLE = 0, AUTO_PLAIN = 1, PLAIN = 2 };

template <typename T>
__device__ __forceinline__ T stable_term(T y, T mu, T r) {
  const T u = y / r;
  const T v = mu / r;
  const T l1p_u = m_log1p(u);
  const T l1p_v = m_log1p(v);
  const T yr = y + r;
  return -r * (l1p_u - u) - (y - T(0.5)) * l1p_u + r * (l1p_v - v) + y * l1p_v +
         y / (T(12) * r * yr) + (T(1) / (yr * yr * yr) - T(1) / (r * r * r)) / T(360);
}

template <int P, typename T>
__global__ void __launch_bounds__(THREADS)
    disp_scan_kernel(int G, int N, const T* __restrict__ counts, const T* __restrict__ mu,
                     const T* __restrict__ X, const T* __restrict__ la_grid, int K,
                     int bnd_start, int bnd_end, T la_init, int cr_reg, int prior_reg,
                     const T* __restrict__ la_hat, const T* __restrict__ pdv_p,
                     T* __restrict__ best_la_out, T* __restrict__ coarse) {
  const int g = (int)(((size_t)blockIdx.x * THREADS + threadIdx.x) / WARP);
  const int lane = threadIdx.x & (WARP - 1);
  if (g >= G) return;  // whole warps leave together
  const T* y = counts + (size_t)g * N;
  const T* m = mu + (size_t)g * N;
  const T pdv = *pdv_p;
  const T lah = prior_reg ? la_hat[g] : T(0);

  T best_f = Lim<T>::inf();
  T best_la = la_init;
  for (int k = 0; k < K; ++k) {
    const T la = la_grid[k];
    const T alpha = m_exp(la);
    const T r = T(1) / alpha;
    const int form =
        k < bnd_start ? STABLE : (k < bnd_end ? (r < T(R_SWITCH) ? AUTO_PLAIN : STABLE) : PLAIN);
    const T log_r = m_log(r);
    const T lg_r = m_lgamma(r);

    T acc = T(0);
    T gram[NTRI<P>];
#pragma unroll
    for (int i = 0; i < NTRI<P>; ++i) gram[i] = T(0);

    for (int n = lane; n < N; n += WARP) {
      const T yv = y[n];
      const T mv = m[n];
      T per;
      if (form == STABLE) {
        per = stable_term(yv, mv, r);
      } else if (form == AUTO_PLAIN) {
        const T yr = yv + r;
        per = -r * log_r - lgamma_fast(yr) + lg_r + yr * (log_r + m_log1p(mv / r)) - mv;
      } else {
        per = -r * log_r - lgamma_fast(yv + r) + lg_r + (yv + r) * m_log(mv + r) - mv;
      }
      acc += per;
      if (cr_reg) {
        const T W = mv / (T(1) + mv * alpha);
        const T* xn = X + (size_t)n * P;
#pragma unroll
        for (int p = 0; p < P; ++p) {
          const T wp = W * __ldg(xn + p);
#pragma unroll
          for (int q = p; q < P; ++q) gram[tri_idx<P>(p, q)] += wp * __ldg(xn + q);
        }
      }
    }
    T f = warp_sum(acc);
    if (cr_reg) {
#pragma unroll
      for (int i = 0; i < NTRI<P>; ++i) gram[i] = warp_sum(gram[i]);
      f = f + T(0.5) * sym_logdet<T, P>(gram);
    }
    if (prior_reg) {
      const T d = la - lah;
      f = f + d * d / (T(2) * pdv);
    }
    if (lane == 0) coarse[(size_t)k * G + g] = f;
    if (f < best_f) {
      best_f = f;
      best_la = la;
    }
  }
  if (lane == 0) best_la_out[g] = best_la;
}

template <int P, typename T>
int launch(int G, int N, const void* counts, const void* mu, const void* X, const void* la_grid,
           int K, int bnd_start, int bnd_end, double la_init, int cr_reg, int prior_reg,
           const void* la_hat, const void* pdv, void* best_la, void* coarse, cudaStream_t s) {
  const unsigned blocks = (unsigned)(((size_t)G * WARP + THREADS - 1) / THREADS);
  disp_scan_kernel<P, T><<<blocks, THREADS, 0, s>>>(
      G, N, (const T*)counts, (const T*)mu, (const T*)X, (const T*)la_grid, K, bnd_start,
      bnd_end, (T)la_init, cr_reg, prior_reg, (const T*)la_hat, (const T*)pdv, (T*)best_la,
      (T*)coarse);
  return 0;
}

}  // namespace

extern "C" int disp_scan_launch(int is_f64, int P, int G, int N, const void* counts,
                                const void* mu, const void* X, const void* la_grid, int K,
                                int bnd_start, int bnd_end, double la_init, int cr_reg,
                                int prior_reg, const void* la_hat, const void* pdv,
                                void* best_la, void* coarse, void* stream) {
  if (G <= 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_f64) {
    PDT_DISPATCH_P(P, launch<PP, double>(G, N, counts, mu, X, la_grid, K, bnd_start, bnd_end,
                                         la_init, cr_reg, prior_reg, la_hat, pdv, best_la,
                                         coarse, s));
  } else {
    PDT_DISPATCH_P(P, launch<PP, float>(G, N, counts, mu, X, la_grid, K, bnd_start, bnd_end,
                                        la_init, cr_reg, prior_reg, la_hat, pdv, best_la,
                                        coarse, s));
  }
  return (int)cudaGetLastError();
}
