// Masked-lane IRLS for the NB GLM: lane groups in a persistent grid.
//
// Replaces irls_core (pydeseq2_tpu/ops/irls.py:45), a lax.while_loop that
// advances all genes until the slowest stops. Here a group of S lanes (4,
// 8 or 32; or a block of 256 threads at atlas widths: the plan's,
// ops/irls.py:_irls_plan) owns one gene and leaves its loop when the gene
// stops: while a gene is active its trip count is the JAX loop's global
// `it`, so stops, fallback flags and iterates are those of the masked
// loop, lane for lane. Lane l of a group takes samples l, l + S, ...; the
// split and every reduction's order depend on S alone.
//
// Each trip is one pass over the gene's row: mu, log(mu) and log(mu/sf)
// from the linear predictor of the new coefficients, the mu-part of the
// deviance (y + r) log1p(mu/r) - y log(mu), and X^T W X and X^T W z for
// the next trip, all summed in the working type as the JAX loop sums them
// (a float64 mu-part stopped the slowest lane two trips before the plain
// loop: in float32 the stop compares deviances that round to 1/16). The 1 + P + P(P+1)/2
// sums of a pass are reduced together: recursive halving over the group's
// lanes (each lane keeps half of the values it holds and sends the other
// half, log2 S rounds), then one shuffle a value from the lane that holds
// its total, so every lane holds the same bits. The P x P solve (closed
// forms for P <= 3, unrolled Cholesky to 8) is scalar work in registers,
// repeated by each lane of the group. With step_tol > 0 (float32) the loop
// stops after two consecutive steps below it, and the 2-step exact-Newton
// polish of the ridged NLL follows, kept only where it lowers the gradient
// sup-norm; its passes take the same code path (mode flags pick the
// weights), so a warp's groups stay in step whatever pass each one runs.
//
// The kernel first computes every gene's deviance constant nll_const =
// nb_nll(y, mu0) - mu_part(mu0) at beta_init, a warp a gene over the whole
// grid, with the forms of ops/nb.py:nb_nll_terms (the r = 1/alpha < 8
// switch, the library lgamma), each sample's difference summed in float64
// and rounded once; then a barrier of the whole grid (a cooperative launch,
// every block resident). No (G, N) pass runs outside the kernel, and the
// constant's transcendentals, ~4x a trip's, run in every lane at once
// instead of in one group while its warp's other groups wait.
//
// The grid is persistent: as many blocks as the card holds at once (the
// occupancy API), each group starting on gene (its index) and taking the
// next from a global counter when its gene stops, so a group is never idle
// while genes remain. A gene's arithmetic depends only on its row and S, so
// the order in which genes are taken moves no bit. Each trip reads the
// gene's row of counts and the per-sample factors (sf, log sf, X) again,
// from L1 or L2: a kernel_bench sweep found copies of either in shared
// memory no faster.
//
// Bound on the H100 by the issue rate of each sample's exp, log1p and
// divisions, and by the trip-count tail: most genes stop within a few trips
// and their groups take new genes instead of running masked to the slowest.
#include <type_traits>

#include "common.cuh"

using namespace pdt;

namespace {

constexpr int THREADS = 256;
constexpr int BLOCK_LANES = THREADS;  // S of a block a gene

enum : int { M_INIT = 0, M_TRIP = 1, M_POLISH_H = 2, M_POLISH_G = 3 };

template <typename T> struct IrlsArgs {
  int G, N;
  const T* counts;
  const T* sf;
  const T* log_sf;
  const T* X;
  const T* disp;
  const T* beta_init;
  T min_mu, beta_tol, max_beta, step_tol, polish_cap;
  int maxiter, polish_iters;
  int* counter;     // [0] genes handed out past the first, [1] blocks past the constants (zero at launch)
  T* nll_const;     // (G,) workspace: each gene's deviance constant
  T* beta_out;
  unsigned char* needs_fb_out;
  int* trips_out;
};

// One sample's share of nll_const: nb_nll_terms(y, mu, 1/r) minus the
// mu-part (y + r) log1p(mu/r) - y log_mu, in the forms and order of
// ops/nb.py (plain where r < 8, the Stirling difference above).
template <typename T>
__device__ __forceinline__ double const_term(T y, T mu, T log_mu, T r, bool plain, T lgr, T nrlogr) {
  const T ylogmu = y > T(0) ? y * m_log(mu) : T(0);
  const T lgy1 = m_lgamma(y + T(1));
  T nll;
  if (plain) {
    const T logbinom = m_lgamma(y + r) - lgy1 - lgr;
    nll = nrlogr - logbinom + (y + r) * m_log(mu + r) - ylogmu;
  } else {
    const T l1y = m_log1p(y / r);
    const T l1m = m_log1p(mu / r);
    const T yr = y + r;
    nll = lgy1 + y - (yr - T(0.5)) * l1y + yr * l1m - ylogmu + y / (T(12) * r * yr) +
          (T(1) / (yr * yr * yr) - T(1) / (r * r * r)) / T(360);
  }
  const T mup = (y + r) * m_log1p(mu / r) - (y > T(0) ? y * log_mu : T(0));
  return (double)nll - (double)mup;
}

template <int P, typename T, int S>
__global__ void __launch_bounds__(THREADS) irls_kernel(IrlsArgs<T> a) {
  constexpr int NT = NTRI<P>;
  constexpr int V = 1 + NT + P;  // mu-part, packed gram, rhs
  constexpr bool BLOCK = S > WARP;
  constexpr int GPB = BLOCK ? 1 : THREADS / S;  // groups a block
  const int N = a.N;
  __shared__ T s_red[BLOCK ? (THREADS / WARP) * V : 1];
  __shared__ int s_gene;

  const T* sf = a.sf;
  const T* log_sf = a.log_sf;
  const T* X = a.X;
  const int grp = BLOCK ? 0 : (int)threadIdx.x / S;
  const int gl = BLOCK ? (int)threadIdx.x : (int)threadIdx.x & (S - 1);
  const unsigned mask =
      (BLOCK || S == WARP) ? FULL : (((1u << S) - 1u) << ((threadIdx.x & (WARP - 1)) & ~(unsigned)(S - 1)));
  const int n_groups = (int)gridDim.x * GPB;
  const T log_min_mu = m_log(a.min_mu);
  const bool polish = a.step_tol > T(0) && a.polish_iters > 0;

  auto next_gene = [&]() -> int {
    if constexpr (BLOCK) {
      __syncthreads();  // every thread has read s_gene
      if (threadIdx.x == 0) s_gene = n_groups + atomicAdd(a.counter, 1);
      __syncthreads();
      return s_gene;
    } else {
      int g = 0;
      if (gl == 0) g = n_groups + atomicAdd(a.counter, 1);
      return __shfl_sync(mask, g, 0, S);
    }
  };

  // -- every gene's deviance constant, a warp a gene, then the barrier ----
  {
    const int lane = threadIdx.x & (WARP - 1);
    const int warps = (int)gridDim.x * (THREADS / WARP);
    for (int g = (int)(blockIdx.x * (THREADS / WARP) + threadIdx.x / WARP); g < a.G; g += warps) {
      const T dg = a.disp[g];
      const T rg = T(1) / dg;
      const bool plain = rg < T(R_SWITCH);
      const T lgr = m_lgamma(rg), nrlogr = -rg * m_log(rg);
      T b0[P];
#pragma unroll
      for (int p = 0; p < P; ++p) b0[p] = a.beta_init[(size_t)g * P + p];
      const T* yg = a.counts + (size_t)g * N;
      double cst = 0.0;
      for (int n = lane; n < N; n += WARP) {
        T xb = T(0);
#pragma unroll
        for (int p = 0; p < P; ++p) xb = xb + b0[p] * X[(size_t)n * P + p];
        const T raw = sf[n] * m_exp(xb);
        const bool clamped = raw < a.min_mu;
        const T mu = clamped ? a.min_mu : raw;
        const T log_mu = clamped ? log_min_mu : xb + log_sf[n];
        cst += const_term<T>(yg[n], mu, log_mu, rg, plain, lgr, nrlogr);
      }
      cst = warp_sum(cst);
      if (lane == 0) a.nll_const[g] = (T)cst;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      __threadfence();
      atomicAdd(a.counter + 1, 1);
      while (atomicAdd(a.counter + 1, 0) < (int)gridDim.x) __nanosleep(64);
      __threadfence();
    }
    __syncthreads();
  }

  // The group's gene and its state (the same in every lane of the group).
  int gene = (int)blockIdx.x * GPB + grp;
  int mode = M_INIT, it = 0, pol_i = 0;
  T disp = T(0), r = T(0), nll_const = T(0), dev = T(1000), g_old = T(0);
  bool active = true, needs_fb = false, prev_small = false, step_ok = false, new_fb = false, step_small = false;
  T beta[P], bev[P], bpol[P];
  const T* y = nullptr;

  auto start = [&]() {
    disp = a.disp[gene];
    r = T(1) / disp;
    nll_const = __ldcg(a.nll_const + gene);  // written by another block before the barrier
#pragma unroll
    for (int p = 0; p < P; ++p) {
      beta[p] = a.beta_init[(size_t)gene * P + p];
      bev[p] = beta[p];
    }
    y = a.counts + (size_t)gene * N;
    mode = M_INIT;
    it = 0;
    dev = T(1000);
    active = true;
    needs_fb = prev_small = false;
  };

  if (gene < a.G) start();
  while (gene < a.G) {
    // -- one pass over the row at bev --------------------------------------
    T acc[V];
#pragma unroll
    for (int i = 0; i < V; ++i) acc[i] = T(0);
    const bool irls = mode <= M_TRIP;
    for (int n = gl; n < N; n += S) {
      T xv[P];
      T xb = T(0);
#pragma unroll
      for (int p = 0; p < P; ++p) {
        xv[p] = X[(size_t)n * P + p];
        xb = xb + bev[p] * xv[p];
      }
      const T raw = sf[n] * m_exp(xb);
      const bool clamped = raw < a.min_mu;
      const T mu = clamped ? a.min_mu : raw;
      const T yv = y[n];
      T wgt, tgt;
      if (irls) {
        const T lsf = log_sf[n];
        const T log_mu = clamped ? log_min_mu : xb + lsf;
        const T log_mu_sf = clamped ? log_min_mu - lsf : xb;
        acc[0] += (yv + r) * m_log1p(mu / r) - (yv > T(0) ? yv * log_mu : T(0));
        wgt = mu / (T(1) + mu * disp);
        const T z = log_mu_sf + (yv - mu) / mu;
        tgt = wgt * z;
      } else {
        const T t = (r + yv) * mu / (r + mu);
        tgt = t - yv;
        const T den = T(1) + disp * mu;
        wgt = mu * (T(1) + disp * yv) / (den * den);
      }
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const T wp = wgt * xv[p];
#pragma unroll
        for (int q = p; q < P; ++q) acc[1 + tri_idx<P>(p, q)] += wp * xv[q];
        acc[1 + NT + p] += tgt * xv[p];
      }
    }
    if constexpr (BLOCK) {
      block_sum<THREADS, V>(acc, s_red);
    } else {
      group_sum<S, V>(acc, mask, gl);
    }
    T* gram = acc + 1;
    const T* rhs = acc + 1 + NT;

    // -- the group's scalar step ------------------------------------------
    bool done = false;
    if (mode == M_TRIP) {
      const T new_dev = T(-2) * (nll_const + acc[0]);
      const T dev_ratio = m_abs(new_dev - dev) / (m_abs(new_dev) + T(0.1));
      bool still_active = step_ok && (dev_ratio > a.beta_tol);
      if (a.step_tol > T(0)) still_active = still_active && !(step_small && prev_small);
      if (step_ok) dev = new_dev;
#pragma unroll
      for (int p = 0; p < P; ++p) beta[p] = bev[p];
      active = still_active;
      needs_fb = needs_fb || new_fb;
      prev_small = step_small;
    }
    if (mode == M_INIT || mode == M_TRIP) {
      if (active && it < a.maxiter) {
        add_diag<P, T>(gram, T(1e-6));
        T beta_hat[P];
        sym_solve<T, P>(gram, rhs, beta_hat);
        ++it;
        bool diverged = false;
#pragma unroll
        for (int p = 0; p < P; ++p) diverged = diverged || (m_abs(beta_hat[p]) > a.max_beta);
        new_fb = diverged || (it >= a.maxiter);
        step_ok = !new_fb;
        T dstep[P];
#pragma unroll
        for (int p = 0; p < P; ++p) {
          bev[p] = step_ok ? beta_hat[p] : beta[p];
          dstep[p] = beta_hat[p] - beta[p];
        }
        step_small = a.step_tol > T(0) && sup_norm<P, T>(dstep) <= a.step_tol;
        mode = M_TRIP;
      } else {
        needs_fb = needs_fb || active;
        if (polish) {
          pol_i = 0;
          mode = M_POLISH_H;  // bev == beta
        } else {
          done = true;
        }
      }
    } else if (mode == M_POLISH_H) {
      T g[P], d[P];
#pragma unroll
      for (int p = 0; p < P; ++p) g[p] = rhs[p] + T(1e-6) * bev[p];
      if (pol_i == 0) {
        g_old = sup_norm<P, T>(g);
#pragma unroll
        for (int p = 0; p < P; ++p) bpol[p] = beta[p];
      }
      add_diag<P, T>(gram, T(1e-6));
      sym_solve<T, P>(gram, g, d);
      bool ok = true;
      T move = T(0);
      T cand[P];
#pragma unroll
      for (int p = 0; p < P; ++p) {
        cand[p] = bpol[p] - d[p];
        ok = ok && isfinite(cand[p]) && (m_abs(cand[p]) <= a.max_beta);
        move = p == 0 ? m_abs(cand[p] - bpol[p]) : m_max(move, m_abs(cand[p] - bpol[p]));
      }
      ok = ok && (move <= a.polish_cap);
#pragma unroll
      for (int p = 0; p < P; ++p) {
        if (ok) bpol[p] = cand[p];
        bev[p] = bpol[p];
      }
      ++pol_i;
      mode = pol_i < a.polish_iters ? M_POLISH_H : M_POLISH_G;
    } else {  // M_POLISH_G: the gradient at the polished point
      T g[P];
#pragma unroll
      for (int p = 0; p < P; ++p) g[p] = rhs[p] + T(1e-6) * bev[p];
      if (sup_norm<P, T>(g) < g_old) {
#pragma unroll
        for (int p = 0; p < P; ++p) beta[p] = bpol[p];
      }
      done = true;
    }

    if (done) {
      if (gl == 0) {
#pragma unroll
        for (int p = 0; p < P; ++p) a.beta_out[(size_t)gene * P + p] = beta[p];
        a.needs_fb_out[gene] = needs_fb ? 1 : 0;
        a.trips_out[gene] = it;
      }
      gene = next_gene();
      if (gene < a.G) start();
    }
  }
}

template <int P, typename T, int S> int launch_s(const IrlsArgs<T>& a, cudaStream_t st) {
  auto kern = irls_kernel<P, T, S>;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, THREADS, 0);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  constexpr int GPB = S > WARP ? 1 : THREADS / S;
  const long long want = ((long long)a.G + GPB - 1) / GPB;
  const int blocks = (int)(want < (long long)per_sm * sms ? want : (long long)per_sm * sms);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeCooperative;  // every block resident: the constants' barrier
  attr.val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks);
  cfg.blockDim = dim3((unsigned)THREADS);
  cfg.stream = st;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, kern, a);
}

// f(std::integral_constant<int, S>{}) for the group size S = `lanes`:
// 4 for P <= 3 (the pipelines' designs), 8, 32 and a block for every P.
template <int P, typename F> int with_lanes(int lanes, F f) {
  switch (lanes) {
    case 4: if constexpr (P <= 3) return f(std::integral_constant<int, 4>{}); break;
    case 8: return f(std::integral_constant<int, 8>{});
    case 32: return f(std::integral_constant<int, 32>{});
    case BLOCK_LANES: return f(std::integral_constant<int, BLOCK_LANES>{});
    default: break;
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T> int per_sm(int P, int lanes, int* out) {
  PDT_DISPATCH_P(P, return with_lanes<PP>(lanes, [&](auto sz) {
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, irls_kernel<PP, T, decltype(sz)::value>, THREADS, 0);
  }));
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int launch_typed(int P, int G, int N, const void* counts, const void* sf, const void* log_sf, const void* X,
                 const void* disp, const void* beta_init, double min_mu, double beta_tol, double max_beta,
                 double step_tol, int maxiter, int polish_iters, int lanes, void* counter, void* nll_const,
                 void* beta_out, void* needs_fb, void* trips, cudaStream_t s) {
  IrlsArgs<T> a;
  a.G = G;
  a.N = N;
  a.counts = (const T*)counts;
  a.sf = (const T*)sf;
  a.log_sf = (const T*)log_sf;
  a.X = (const T*)X;
  a.disp = (const T*)disp;
  a.beta_init = (const T*)beta_init;
  a.min_mu = (T)min_mu;
  a.beta_tol = (T)beta_tol;
  a.max_beta = (T)max_beta;
  a.step_tol = (T)step_tol;
  a.polish_cap = (T)(100.0 * step_tol);
  a.maxiter = maxiter;
  a.polish_iters = polish_iters;
  a.counter = (int*)counter;
  a.nll_const = (T*)nll_const;
  a.beta_out = (T*)beta_out;
  a.needs_fb_out = (unsigned char*)needs_fb;
  a.trips_out = (int*)trips;
  PDT_DISPATCH_P(P, return with_lanes<PP>(lanes, [&](auto sz) { return launch_s<PP, T, decltype(sz)::value>(a, s); }));
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// IRLS for G genes of N samples on groups of `lanes` lanes a gene (4, 8,
// 32, or 256: a block); counter is two int32 that are 0 at launch,
// nll_const a (G,) workspace.
extern "C" int irls_launch(int is_f64, int P, int G, int N, const void* counts, const void* sf,
                           const void* log_sf, const void* X, const void* disp, const void* beta_init,
                           double min_mu, double beta_tol, double max_beta, double step_tol, int maxiter,
                           int polish_iters, int lanes, void* counter, void* nll_const,
                           void* beta_out, void* needs_fb, void* trips, void* stream) {
  if (G <= 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  const int rc = is_f64
      ? launch_typed<double>(P, G, N, counts, sf, log_sf, X, disp, beta_init, min_mu, beta_tol, max_beta, step_tol,
                             maxiter, polish_iters, lanes, counter, nll_const, beta_out, needs_fb, trips, s)
      : launch_typed<float>(P, G, N, counts, sf, log_sf, X, disp, beta_init, min_mu, beta_tol, max_beta, step_tol,
                            maxiter, polish_iters, lanes, counter, nll_const, beta_out, needs_fb, trips, s);
  return rc != 0 ? rc : (int)cudaGetLastError();
}

// out[0] = the blocks of the kernel for P coefficients and `lanes` a gene
// that an SM holds at once: the occupancy API, as the launch sizes its
// grid (no launch).
extern "C" int irls_per_sm(int is_f64, int P, int lanes, int* out, void* stream) {
  (void)stream;
  return is_f64 ? per_sm<double>(P, lanes, out) : per_sm<float>(P, lanes, out);
}
