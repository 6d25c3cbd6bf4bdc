// The parametric dispersion trend with its gene-exclusion rounds, one cluster;
// and one standalone gamma-GLM fit on a caller's mask (trend_fit_launch).
//
// Replaces pydeseq2_tpu/fused.py:212 fit_fused_trend's parametric branch
// (the exclusion while_loop, :264-292) and, inside each round,
// pydeseq2_tpu/ops/trend.py:22 gamma_glm_trend_fit (the projected
// Fisher-scoring fit of mu = a0 + a1 x, x = 1/base_mean, minimising
// mean(y/mu + log mu) over the valid genes, with backtracking, :71-129).
//
// One thread-block cluster of K <= 16 blocks of 1024 threads runs every
// round and every Newton and backtracking trip: the loop conditions are read
// on the card, so the host reads none of them. Block q of the cluster owns
// the genes [q ceil(G / K), (q + 1) ceil(G / K)); where they fit, it loads
// their lanes once into shared memory (x = 1/base_mean, the target, the
// valid byte) and every pass reads them there, else it reads them from
// global memory each pass (the streamed mode). The plan (K, mode) comes
// from the host (ops/trend.py:_trend_plan); K = 1 is one block, as for a
// few hundred genes. Each loss, gradient and Fisher sum over the genes is
// one cluster reduction in a fixed order: each thread's strided lanes in
// order, a warp xor tree, the block's 32 warp sums by a second xor tree
// that every warp runs, then the K block totals, read through distributed
// shared memory after one cluster barrier (one remote read a total and
// block), by a third xor tree over the ranks. Every thread of
// every block ends with the same bits, so all threads take the same
// branches. Each term is computed in T and summed
// in double, the total rounded to T, as the plain version does: in float32
// a 60000-term sum in another order would move by more than the stall
// tolerance, and the two fits would stop after different trips. The per-gene mask of the current
// round lives in shared memory, or in a scratch byte array in the streamed
// mode; each thread reads and writes only its own lanes. Expressions follow
// the plain version term by term
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
// trend_fit runs the same fit (gamma_fit below, the same cluster sums) once
// on the caller's covariates, targets and mask and writes the coefficients,
// the predictions a0 + a1 x of every lane and the converged flag: the class
// API's exclusion loop (models/dataset.py) reads only that, once a round.
// Lanes outside the mask are skipped, not multiplied by zero as in the
// plain version; the two differ only where such a lane is non-finite, which
// no caller passes.
//
// Bound on the H100 by its serial chain of reductions (a pass over the
// lanes, two barriers and the cluster's remote reads each), not by its ~40
// operations per gene per Fisher step over 0.54 MB at 60000 genes.
#include <cooperative_groups.h>

#include "common.cuh"

using namespace pdt;
namespace cg = cooperative_groups;

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

constexpr int NSUM = 5;  // the widest reduction: gradient (2) and Fisher (3)
// float64 words before the lanes: the warp sums (2 buffers x NSUM x NWARP),
// the block totals (2 buffers x NSUM) that the cluster reads, and the K
// blocks' totals gathered (MAX_CLUSTER x NSUM)
constexpr int RED_WORDS = 2 * NSUM * NWARP + 2 * NSUM + MAX_CLUSTER * NSUM;

// Dynamic shared memory of one block (ops/trend.py:_trend_smem_bytes
// repeats it): the reduction buffers, and in the shared-memory mode x and
// the target (T each) and the valid byte of each of the block's lanes.
__host__ __device__ constexpr size_t trend_smem_bytes(int rows, int isz, bool shared) {
  return 8 * (size_t)RED_WORDS + (shared ? (size_t)rows * (2 * isz + 1) : 0);
}

// Cluster-wide sum of NV values per thread; every thread of every block gets
// the same totals. A block's warp sums, then its total; after the cluster
// barrier, K x NV threads fetch the K blocks' totals (one remote read each)
// into shared memory, and every warp adds them by an xor tree over the
// ranks. The warp sums and block totals alternate between two buffers, so
// that a block (or warp) that runs ahead never overwrites values another is
// still reading; a cluster of one block stops at its total, one barrier a
// reduction.
struct ClusterSum {
  double* warp_buf;   // [2][NSUM][NWARP]
  double* block_buf;  // [2][NSUM]
  double* gathered;   // [MAX_CLUSTER][NSUM]
  int K;
  int parity;

  template <int NV> __device__ __forceinline__ void operator()(double (&v)[NV]) {
    cg::cluster_group cluster = cg::this_cluster();
    const int warp = threadIdx.x / WARP, lane = threadIdx.x & (WARP - 1);
    double* ws = warp_buf + parity * NSUM * NWARP;
    double* bs = block_buf + parity * NSUM;  // before the flip below
#pragma unroll
    for (int k = 0; k < NV; ++k) v[k] = warp_sum(v[k]);
    if (lane == 0) {
#pragma unroll
      for (int k = 0; k < NV; ++k) ws[k * NWARP + warp] = v[k];
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < NV; ++k) v[k] = warp_sum(ws[k * NWARP + lane]);
    parity ^= 1;
    if (K == 1) return;  // one block: its total is the sum (the tree below adds zeros to it)
    if (threadIdx.x == 0) {
#pragma unroll
      for (int k = 0; k < NV; ++k) bs[k] = v[k];
    }
    cluster.sync();  // every block's totals are visible
    if ((int)threadIdx.x < K * NV) {
      const int q = threadIdx.x / NV, k = threadIdx.x - q * NV;
      gathered[q * NSUM + k] = cluster.map_shared_rank(bs, (unsigned)q)[k];
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < NV; ++k) v[k] = warp_sum(lane < K ? gathered[lane * NSUM + k] : 0.0);
  }
};

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

// A block's lanes: in shared memory (x, t, valid of local lane i), or read
// from global memory (the streamed mode) through `from` and `valid_g`.
template <typename T, bool SHARED, typename F> struct Lanes {
  int rows;
  T* xs;
  T* ts;
  unsigned char* vs;
  F from;                  // local lane -> Lane<T> (streamed mode)
  unsigned char* valid_g;  // the block's valid bytes (streamed mode)

  __device__ __forceinline__ Lane<T> operator()(int i) const {
    if constexpr (SHARED) return {xs[i], ts[i]};
    else return from(i);
  }
  __device__ __forceinline__ bool valid(int i) const { return SHARED ? vs[i] != 0 : valid_g[i] != 0; }
  __device__ __forceinline__ void set_valid(int i, bool v) const {
    if constexpr (SHARED) vs[i] = v ? 1 : 0;
    else valid_g[i] = v ? 1 : 0;
  }
};

// mean over valid lanes of t/mu + log mu, mu = max(c0 + c1 x, 1e-12)
template <typename T, typename L>
__device__ T loss(T c0, T c1, const L& lanes, T n, ClusterSum& cs) {
  double s[1] = {0.0};
  for (int i = threadIdx.x; i < lanes.rows; i += THREADS) {
    if (!lanes.valid(i)) continue;
    const Lane<T> l = lanes(i);
    const T ms = m_max(c0 + l.x * c1, T(LOWER));
    const T per = l.t / ms + m_log(ms);
    s[0] += double(per);
  }
  cs(s);
  return T(s[0]) / n;
}

// gradient (g0, g1) and Fisher matrix (F00, F01, F11), each divided by n
template <typename T, typename L>
__device__ void grad_fisher(T c0, T c1, const L& lanes, T n, ClusterSum& cs, T* g, T* F) {
  double s[5] = {0.0, 0.0, 0.0, 0.0, 0.0};
  for (int i = threadIdx.x; i < lanes.rows; i += THREADS) {
    if (!lanes.valid(i)) continue;
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
  cs(s);
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
__device__ void gamma_fit(int maxiter, const L& lanes, T n, ClusterSum& cs, T& c0, T& c1, bool& converged) {
  const T tiny_f = T(10.0 * Eps<T>::v);
  const T ftol = T(1e3 * Eps<T>::v);
  const T at_bound_c = T(LOWER * (1 + 1e-9));
  c0 = T(1);
  c1 = T(1);
  T f_val = loss(c0, c1, lanes, n, cs);
  for (int it = 0; it < maxiter; ++it) {
    T g[2], F[3], step[2];
    grad_fisher(c0, c1, lanes, n, cs, g, F);
    solve2(F, g, step);
    T t = T(1);
    T best0 = c0, best1 = c1, best_f = f_val;
    bool improved = false;
    for (int j = 0; j < 20; ++j) {
      const T k0 = m_max(c0 - t * step[0], T(LOWER));
      const T k1 = m_max(c1 - t * step[1], T(LOWER));
      const T f_cand = loss(k0, k1, lanes, n, cs);
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
  grad_fisher(c0, c1, lanes, n, cs, g, F);
  T pg[2];
  pg[0] = (c0 <= at_bound_c && g[0] > T(0)) ? T(0) : g[0];
  pg[1] = (c1 <= at_bound_c && g[1] > T(0)) ? T(0) : g[1];
  solve2(F, pg, sol);
  const T decrement = (T(0.5) * pg[0]) * sol[0] + (T(0.5) * pg[1]) * sol[1];
  converged = isfinite(f_val) && decrement <= ftol * (m_abs(f_val) + T(1));
}

// This block's share of the genes: [g0, g0 + rows), at most per = ceil(G / K).
__device__ __forceinline__ void block_rows(int G, int& g0, int& rows, int& per) {
  cg::cluster_group cluster = cg::this_cluster();
  const int K = (int)cluster.num_blocks();
  per = (G + K - 1) / K;
  g0 = min(G, (int)cluster.block_rank() * per);
  rows = min(G, g0 + per) - g0;
}

// The reduction buffers and, in the shared-memory mode, the lane arrays of
// `per` lanes, carved out of the dynamic shared memory.
template <typename T> struct TrendSmem {
  ClusterSum cs;
  T* xs;
  T* ts;
  unsigned char* vs;
};

template <typename T> __device__ __forceinline__ TrendSmem<T> carve(double* smem, int per) {
  TrendSmem<T> m;
  m.cs = {smem, smem + 2 * NSUM * NWARP, smem + 2 * NSUM * NWARP + 2 * NSUM, (int)cg::this_cluster().num_blocks(),
          0};
  m.xs = reinterpret_cast<T*>(smem + RED_WORDS);
  m.ts = m.xs + per;
  m.vs = reinterpret_cast<unsigned char*>(m.ts + per);
  return m;
}

template <typename T, bool SHARED>
__global__ void __launch_bounds__(THREADS, 1)
    trend_kernel(int G, int max_rounds, int maxiter, const T* __restrict__ bm,
                 const T* __restrict__ gm, const unsigned char* __restrict__ nz,
                 const T* __restrict__ mean_disp_p, unsigned char* __restrict__ valid,
                 T* __restrict__ fitted, T* __restrict__ coeffs_out,
                 unsigned char* __restrict__ failed_out, int* __restrict__ rounds_out) {
  extern __shared__ double smem[];
  int g0, rows, per;
  block_rows(G, g0, rows, per);
  TrendSmem<T> m = carve<T>(smem, per);
  const auto from = [&](int i) {
    bool v0;
    return lane_of(bm, gm, nz, g0 + i, v0);
  };
  const Lanes<T, SHARED, decltype(from)> lanes{rows, m.xs, m.ts, m.vs, from, valid + g0};

  for (int i = threadIdx.x; i < rows; i += THREADS) {
    bool v0;
    const Lane<T> l = lane_of(bm, gm, nz, g0 + i, v0);
    if constexpr (SHARED) {
      m.xs[i] = l.x;
      m.ts[i] = l.t;
    }
    lanes.set_valid(i, v0);
  }
  // (the first reduction's barriers order these writes before any read)

  T coeffs[2] = {T(1), T(1)};
  bool failed = false;
  T drift = Lim<T>::inf();
  int rounds = 0;
  while (!failed && drift >= T(1e-6) && rounds < max_rounds) {
    double cnt[1] = {0.0};
    for (int i = threadIdx.x; i < rows; i += THREADS) cnt[0] += lanes.valid(i) ? 1.0 : 0.0;
    m.cs(cnt);
    const T n = m_max(T(cnt[0]), T(1));

    // ---- gamma_glm_trend_fit on the current mask ----
    T c0, c1;
    bool converged;
    gamma_fit(maxiter, lanes, n, m.cs, c0, c1, converged);

    // ---- the exclusion round (fused.py:276-283) ----
    failed = !converged || c0 <= T(1e-10) || c1 <= T(1e-10);
    const T l0 = m_log(m_abs(c0 / coeffs[0]));
    const T l1 = m_log(m_abs(c1 / coeffs[1]));
    drift = l0 * l0 + l1 * l1;
    for (int i = threadIdx.x; i < rows; i += THREADS) {
      if (!lanes.valid(i)) continue;
      const Lane<T> l = lanes(i);  // a valid lane's target is its genewise dispersion
      const T ratio = l.t / (c0 + l.x * c1);
      lanes.set_valid(i, ratio >= T(1e-4) && ratio < T(15));
    }
    coeffs[0] = c0;
    coeffs[1] = c1;
    ++rounds;
  }

  const T mean_disp = *mean_disp_p;
  for (int i = threadIdx.x; i < rows; i += THREADS)
    fitted[g0 + i] = failed ? mean_disp : coeffs[0] + coeffs[1] / bm[g0 + i];
  if (cg::this_cluster().block_rank() == 0 && threadIdx.x == 0) {
    coeffs_out[0] = coeffs[0];
    coeffs_out[1] = coeffs[1];
    failed_out[0] = failed ? 1 : 0;
    rounds_out[0] = rounds;
  }
  cg::this_cluster().sync();  // no block exits while another may still read its totals
}

// One standalone fit on the caller's mask (the class API's exclusion loop
// runs on the host and calls this once a round): coefficients, the
// predictions c0 + c1 x of every lane, and the converged flag.
template <typename T, bool SHARED>
__global__ void __launch_bounds__(THREADS, 1)
    trend_fit_kernel(int G, int maxiter, const T* __restrict__ cov, const T* __restrict__ tar,
                     const unsigned char* __restrict__ valid, T* __restrict__ coeffs_out,
                     T* __restrict__ pred, unsigned char* __restrict__ converged_out) {
  extern __shared__ double smem[];
  int g0, rows, per;
  block_rows(G, g0, rows, per);
  TrendSmem<T> m = carve<T>(smem, per);
  const auto from = [&](int i) { return Lane<T>{cov[g0 + i], tar[g0 + i]}; };
  // the caller's mask is only read
  const Lanes<T, SHARED, decltype(from)> lanes{rows, m.xs, m.ts, m.vs, from,
                                               const_cast<unsigned char*>(valid) + g0};
  double cnt[1] = {0.0};
  for (int i = threadIdx.x; i < rows; i += THREADS) {
    if constexpr (SHARED) {
      m.xs[i] = cov[g0 + i];
      m.ts[i] = tar[g0 + i];
      m.vs[i] = valid[g0 + i];
    }
    cnt[0] += valid[g0 + i] ? 1.0 : 0.0;
  }
  m.cs(cnt);
  const T n = m_max(T(cnt[0]), T(1));
  T c0, c1;
  bool converged;
  gamma_fit(maxiter, lanes, n, m.cs, c0, c1, converged);
  for (int i = threadIdx.x; i < rows; i += THREADS) pred[g0 + i] = c0 + cov[g0 + i] * c1;
  if (cg::this_cluster().block_rank() == 0 && threadIdx.x == 0) {
    coeffs_out[0] = c0;
    coeffs_out[1] = c1;
    converged_out[0] = converged ? 1 : 0;
  }
  cg::this_cluster().sync();  // no block exits while another may still read its totals
}

// Launch kernel F on one cluster of K blocks with `smem` bytes of dynamic
// shared memory each.
template <auto F, typename... Args> int cluster_launch(int K, size_t smem, cudaStream_t s, Args... args) {
  if (K < 1 || K > MAX_CLUSTER || smem > SMEM_BLOCK_MAX) return (int)cudaErrorInvalidValue;
  const cudaError_t e = cluster_opt_in<F>();
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(1, K, THREADS, smem, s, &attr);
  const cudaError_t l = cudaLaunchKernelEx(&cfg, F, args...);
  if (l != cudaSuccess) return (int)l;
  return (int)cudaGetLastError();
}

template <typename T>
int launch(int G, int max_rounds, int maxiter, int K, int shared, const void* bm, const void* gm, const void* nz,
           const void* mean_disp, void* valid, void* fitted, void* coeffs, void* failed, void* rounds,
           cudaStream_t s) {
  const size_t smem = trend_smem_bytes((G + K - 1) / K, (int)sizeof(T), shared != 0);
#define PDT_TREND_ARGS                                                                                  \
  K, smem, s, G, max_rounds, maxiter, (const T*)bm, (const T*)gm, (const unsigned char*)nz, (const T*)mean_disp, \
      (unsigned char*)valid, (T*)fitted, (T*)coeffs, (unsigned char*)failed, (int*)rounds
  return shared ? cluster_launch<trend_kernel<T, true>>(PDT_TREND_ARGS)
                : cluster_launch<trend_kernel<T, false>>(PDT_TREND_ARGS);
#undef PDT_TREND_ARGS
}

template <typename T>
int fit_launch(int G, int maxiter, int K, int shared, const void* cov, const void* tar, const void* valid,
               void* coeffs, void* pred, void* converged, cudaStream_t s) {
  const size_t smem = trend_smem_bytes((G + K - 1) / K, (int)sizeof(T), shared != 0);
#define PDT_FIT_ARGS \
  K, smem, s, G, maxiter, (const T*)cov, (const T*)tar, (const unsigned char*)valid, (T*)coeffs, (T*)pred, \
      (unsigned char*)converged
  return shared ? cluster_launch<trend_fit_kernel<T, true>>(PDT_FIT_ARGS)
                : cluster_launch<trend_fit_kernel<T, false>>(PDT_FIT_ARGS);
#undef PDT_FIT_ARGS
}

}  // namespace

// The trend with its exclusion rounds on one cluster of K blocks (K <= 16,
// at most G), the lanes in shared memory when `shared`.
extern "C" int trend_launch(int is_f64, int G, int max_rounds, int maxiter, int K, int shared,
                            const void* base_mean, const void* genewise_m, const void* non_zero,
                            const void* mean_disp, void* valid, void* fitted, void* coeffs, void* failed,
                            void* rounds, void* stream) {
  if (G <= 0 || K > G) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_f64)
    return launch<double>(G, max_rounds, maxiter, K, shared, base_mean, genewise_m, non_zero, mean_disp, valid,
                          fitted, coeffs, failed, rounds, s);
  return launch<float>(G, max_rounds, maxiter, K, shared, base_mean, genewise_m, non_zero, mean_disp, valid,
                       fitted, coeffs, failed, rounds, s);
}

extern "C" int trend_fit_launch(int is_f64, int G, int maxiter, int K, int shared, const void* covariates,
                                const void* targets, const void* valid, void* coeffs, void* predictions,
                                void* converged, void* stream) {
  if (G <= 0 || K > G) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_f64)
    return fit_launch<double>(G, maxiter, K, shared, covariates, targets, valid, coeffs, predictions, converged, s);
  return fit_launch<float>(G, maxiter, K, shared, covariates, targets, valid, coeffs, predictions, converged, s);
}
