// Method-of-moments dispersions and the OLS mu init: lane groups that
// compute each quotient once.
//
// Replaces pydeseq2_tpu/ops/linreg.py:23 fit_lin_mu_batch, :52
// fit_rough_dispersions_batch and :76 fit_moments_dispersions_batch as the
// pipelines chain them (fused.py:360-380, fused_stream.py:287-305 and the
// refit tile :576-594): one (G, N) @ (N, P) product against pinv(X) gives
// the per-gene OLS coefficients, and everything else is per-gene work over
// the same normalised row.
//
// A group of S lanes owns a gene (the plan's, ops/linreg.py:_mom_plan: 4
// lanes to 64 samples, 8 to 128, 32 below 2048 samples, else a block of
// 256), so that at 100 samples the lanes are full and a sum takes a
// 3-step shuffle tree instead of a warp's 5. Lane l of a group takes
// samples l, l + S, ...; the split and every sum's order depend on S alone.
//
// Pass 1 over the gene's row forms y_n = counts_n / sf_n (one IEEE
// division a sample), the coefficients b_p = sum_n y_n pinv[p, n] and the
// row sum. Each y_n is kept for pass 2: in registers where a lane holds at
// most 16 samples (the register plans), else in shared memory, the first
// `staged` samples of each row; samples past them (rows too wide for the
// block's shared memory) are divided again in pass 2, so shared memory
// never caps N. Pass 2 forms the fitted value x_n . b (in coefficient
// order) and sums
//   rough:   ((y - max(x.b, 1))^2 - max(x.b, 1)) / ((N - P) max(x.b, 1)^2),
//   moments: (y - mean)^2,
// then rough = max(rough, 0) and moments = nan_to_num(((sum / (N - 1)) -
// mean(1/sf) mean) / mean^2): NaN -> 0, +-inf -> +-the largest finite value
// (an all-zero row gives 0/0). With mu_out it also writes
// mu_n = max(sf_n x.b, min_mu). The P + 1 sums of pass 1 and the 2 of pass
// 2 are each reduced together (recursive halving, common.cuh group_sum).
//
// Every sum (the coefficients, the row sum, rough, moments, mean(1/sf)) is
// accumulated in float64 over terms formed in the working type as the plain
// version forms them (the staged plans add partial sums of 8 terms), and
// rounded once: in float32 the moment estimate
// cancels (sigma / mean^2 against mean(1/sf) / mean at low counts), and
// float32 sums in a tree order missed the stated 1e-5 against the plain
// version on an H100. x_n . b is summed in float64 from the rounded
// coefficients and rounded once.
//
// The grid is persistent (as many blocks as the card holds at once); each
// block first sums 1/sf_n in a fixed order, the same bits in every block,
// for mean(1/sf). The register plans copy pinv(X) and X (as float64) and sf
// into shared memory; the staged plans read them through L1/L2.
//
// With normed set, the counts operand already holds y = counts / sf (the
// class API's Inference methods hand over normalised counts, and a product
// normed x sf would not give the raw counts back to the bit): y_n is read
// as it is, and sf enters only mean(1/sf) and mu.
//
// Bound on the H100 by its bytes: the counts read once and mu written when
// asked, 24 + 24 MB at 100 x 60000 f32; with pass 2 reading y from
// registers, what is left is each sample's division and the sums' issue.
#include "common.cuh"

using namespace pdt;

namespace {

constexpr int THREADS = 256;
constexpr int BLOCK_LANES = THREADS;  // S of a block a gene
constexpr int REG_ITEMS = 16;         // samples a lane holds in registers
constexpr int FLUSH = 8;              // staged plans: terms a working-type partial sum takes

template <typename T> struct Finite;
template <> struct Finite<float> {
  static __device__ __forceinline__ float max() { return 3.40282346638528859812e+38f; }
};
template <> struct Finite<double> {
  static __device__ __forceinline__ double max() { return 1.7976931348623157e308; }
};

// jnp.nan_to_num / torch.nan_to_num with their defaults.
template <typename T> __device__ __forceinline__ T nan_to_num(T x) {
  if (x != x) return T(0);
  if (x == Lim<T>::inf()) return Finite<T>::max();
  if (x == -Lim<T>::inf()) return -Finite<T>::max();
  return x;
}

// a / b, the IEEE quotient. A zero dividend over a positive finite divisor
// is its own quotient (the same signed zero) and skips the division, whose
// range check would send it down the slow path: zero counts, and rough
// terms at max(x.b, 1) = 1 where the count is 0, are common.
template <typename T> __device__ __forceinline__ T quot(T a, T b) {
  return (a == T(0) && b > T(0) && b <= Finite<T>::max()) ? a : a / b;
}

template <typename T> struct MomArgs {
  int G, N, staged, normed;
  const T* counts;
  const T* sf;
  const T* X;
  const T* pinv;
  T min_mu;
  T* rough;
  T* moments;
  T* coef;
  T* mu;  // may be null
};

// The register plans stage the design in shared memory: pinv (P, N) and X
// (N, P) as float64, sf (N) in the working type. The staged plans read it
// through L1/L2 and keep shared memory for their rows (staging it too cost
// them an SM's fourth block: 0.41 against 0.37 ms at 1000 x 60000 on an
// H100).
template <typename T> __host__ __device__ constexpr size_t design_bytes(int P, int N) {
  return (size_t)(2 * P) * (size_t)N * sizeof(double) + (size_t)N * sizeof(T);
}

// S lanes a gene; REG: y kept in registers (N <= REG_ITEMS S), else the
// first a.staged samples of each row in shared memory. The register plans
// add each term, formed in the working type as the plain version forms it,
// to a float64 sum; the staged plans, whose lanes hold many samples, sum
// FLUSH terms in the working type and add that partial to the float64 sum
// (every term in float64 took 0.37 ms at 1000 x 60000 on an H100, the
// parent's float32 sums 0.32). Every total is rounded once.
template <int P, typename T, int S, bool REG>
__global__ void __launch_bounds__(THREADS) mom_kernel(MomArgs<T> a) {
  constexpr bool BLOCK = S > WARP;
  constexpr int GPB = BLOCK ? 1 : THREADS / S;  // groups a block
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ double s_red[(THREADS / WARP) * (P + 1)];
  const int N = a.N;

  // -- the design and sf, then mean(1/sf) ------------------------------
  double* s_pinv = reinterpret_cast<double*>(smem_raw);  // (P, N)
  double* s_X = s_pinv + (size_t)P * N;                   // (N, P)
  const T* sf = a.sf;
  T* stage = reinterpret_cast<T*>(smem_raw);  // staged plans: GPB rows of a.staged
  if constexpr (REG) {
    T* s_sf = reinterpret_cast<T*>(s_X + (size_t)N * P);
    for (int i = threadIdx.x; i < P * N; i += THREADS) {
      s_pinv[i] = (double)a.pinv[i];
      s_X[i] = (double)a.X[i];
    }
    for (int i = threadIdx.x; i < N; i += THREADS) s_sf[i] = a.sf[i];
    sf = s_sf;
  }
  double s_inv[1] = {0.0};
  for (int n = threadIdx.x; n < N; n += THREADS) s_inv[0] += (double)(T(1) / a.sf[n]);
  block_sum<THREADS, 1>(s_inv, s_red);  // ends with a barrier: the design is in place
  const T s_mean_inv = T(s_inv[0]) / T(N);

  const int grp = BLOCK ? 0 : (int)threadIdx.x / S;
  const int gl = BLOCK ? (int)threadIdx.x : (int)threadIdx.x & (S - 1);
  const unsigned mask =
      (BLOCK || S == WARP) ? FULL : (((1u << S) - 1u) << ((threadIdx.x & (WARP - 1)) & ~(unsigned)(S - 1)));
  T* ys = REG ? nullptr : stage + (size_t)grp * a.staged;
  const T dof = T(N - P);
  const int stride = (int)gridDim.x * GPB;

  for (int gene = (int)blockIdx.x * GPB + grp; gene < a.G; gene += stride) {
    const T* row = a.counts + (size_t)gene * N;

    // -- pass 1: y, the coefficients and the row sum ---------------------
    double acc[P + 1];
#pragma unroll
    for (int i = 0; i <= P; ++i) acc[i] = 0.0;
    T yr[REG ? REG_ITEMS : 1];
    if constexpr (REG) {
#pragma unroll
      for (int j = 0; j < REG_ITEMS; ++j) {
        const int n = gl + j * S;
        yr[j] = n < N ? row[n] : T(0);
      }
#pragma unroll
      for (int j = 0; j < REG_ITEMS; ++j) {
        const int n = gl + j * S;
        if (n < N) {
          if (!a.normed) yr[j] = quot(yr[j], sf[n]);
          const double vd = (double)yr[j];
#pragma unroll
          for (int p = 0; p < P; ++p) acc[p] += vd * s_pinv[(size_t)p * N + n];
          acc[P] += vd;
        }
      }
    } else {
      for (int n0 = gl; n0 < N; n0 += FLUSH * S) {
        T part[P + 1];
#pragma unroll
        for (int i = 0; i <= P; ++i) part[i] = T(0);
#pragma unroll
        for (int k = 0; k < FLUSH; ++k) {
          const int n = n0 + k * S;
          if (n < N) {
            const T v = a.normed ? row[n] : quot(row[n], sf[n]);
            if (n < a.staged) ys[n] = v;
#pragma unroll
            for (int p = 0; p < P; ++p) part[p] += v * __ldg(a.pinv + (size_t)p * N + n);
            part[P] += v;
          }
        }
#pragma unroll
        for (int i = 0; i <= P; ++i) acc[i] += (double)part[i];
      }
    }
    if constexpr (BLOCK) {
      block_sum<THREADS, P + 1>(acc, s_red);
    } else {
      group_sum<S, P + 1>(acc, mask, gl);
    }
    T coef[P];
    double coef_d[P];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      coef[p] = T(acc[p]);
      coef_d[p] = (double)coef[p];
    }
    const T mean = T(acc[P]) / T(N);

    // -- pass 2: the rough and moment sums, mu ---------------------------
    double sums[2] = {0.0, 0.0};
    T* mu_row = a.mu != nullptr ? a.mu + (size_t)gene * N : nullptr;
    // The rough and moment terms of sample n at its fitted value xb.
    auto terms = [&](int n, T v, T xb, T& rough_t, T& dev_t) {
      const T yh = m_max(xb, T(1));
      const T e = v - yh;
      rough_t = quot(e * e - yh, dof * (yh * yh));
      const T dv = v - mean;
      dev_t = dv * dv;
      if (mu_row != nullptr) mu_row[n] = m_max(sf[n] * xb, a.min_mu);
    };
    if constexpr (REG) {
#pragma unroll
      for (int j = 0; j < REG_ITEMS; ++j) {
        const int n = gl + j * S;
        if (n < N) {
          double xbd = 0.0;  // x_n . b of the rounded coefficients, in coefficient order, rounded once
#pragma unroll
          for (int p = 0; p < P; ++p) xbd += coef_d[p] * s_X[(size_t)n * P + p];
          T rt, dt;
          terms(n, yr[j], T(xbd), rt, dt);
          sums[0] += (double)rt;
          sums[1] += (double)dt;
        }
      }
    } else {
      for (int n0 = gl; n0 < N; n0 += FLUSH * S) {
        T part[2] = {T(0), T(0)};
#pragma unroll
        for (int k = 0; k < FLUSH; ++k) {
          const int n = n0 + k * S;
          if (n < N) {
            const T v = n < a.staged ? ys[n] : (a.normed ? row[n] : quot(row[n], sf[n]));
            T xb = T(0);  // x_n . b in coefficient order
#pragma unroll
            for (int p = 0; p < P; ++p) xb = xb + coef[p] * __ldg(a.X + (size_t)n * P + p);
            T rt, dt;
            terms(n, v, xb, rt, dt);
            part[0] += rt;
            part[1] += dt;
          }
        }
        sums[0] += (double)part[0];
        sums[1] += (double)part[1];
      }
    }
    if constexpr (BLOCK) {
      block_sum<THREADS, 2>(sums, s_red);
    } else {
      group_sum<S, 2>(sums, mask, gl);
    }
    if (gl == 0) {
      a.rough[gene] = m_max(T(sums[0]), T(0));
      const T sigma = T(sums[1]) / T(N - 1);
      a.moments[gene] = nan_to_num((sigma - s_mean_inv * mean) / (mean * mean));
#pragma unroll
      for (int p = 0; p < P; ++p) a.coef[(size_t)gene * P + p] = coef[p];
    }
  }
}

template <int P, typename T, int S, bool REG> int launch_plan(const MomArgs<T>& a, cudaStream_t st) {
  constexpr auto kern = mom_kernel<P, T, S, REG>;
  constexpr int GPB = S > WARP ? 1 : THREADS / S;
  const size_t smem = REG ? design_bytes<T>(P, a.N) : (size_t)GPB * (size_t)a.staged * sizeof(T);
  if (smem + sizeof(double) * (THREADS / WARP) * (P + 1) > SMEM_BLOCK_MAX) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = smem_opt_in<kern>(smem);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, THREADS, smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long want = ((long long)a.G + GPB - 1) / GPB;
  const int blocks = (int)(want < (long long)per_sm * sms ? want : (long long)per_sm * sms);
  kern<<<blocks, THREADS, smem, st>>>(a);
  return 0;
}

template <int P, typename T>
int launch(const MomArgs<T>& a, int lanes, cudaStream_t st) {
  if (a.staged == 0) {  // registers: at most REG_ITEMS samples a lane
    if (a.N > REG_ITEMS * lanes) return (int)cudaErrorInvalidValue;
    switch (lanes) {
      case 4: return launch_plan<P, T, 4, true>(a, st);
      case 8: return launch_plan<P, T, 8, true>(a, st);
      case 32: return launch_plan<P, T, 32, true>(a, st);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (a.staged < 0 || a.staged > a.N) return (int)cudaErrorInvalidValue;
  switch (lanes) {
    case 32: return launch_plan<P, T, 32, false>(a, st);
    case BLOCK_LANES: return launch_plan<P, T, BLOCK_LANES, false>(a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int launch_typed(int P, int G, int N, const void* counts, const void* sf, const void* X, const void* pinv,
                 double min_mu, int normed, int lanes, int staged, void* rough, void* moments, void* coef,
                 void* mu, cudaStream_t st) {
  MomArgs<T> a;
  a.G = G;
  a.N = N;
  a.staged = staged;
  a.normed = normed;
  a.counts = (const T*)counts;
  a.sf = (const T*)sf;
  a.X = (const T*)X;
  a.pinv = (const T*)pinv;
  a.min_mu = (T)min_mu;
  a.rough = (T*)rough;
  a.moments = (T*)moments;
  a.coef = (T*)coef;
  a.mu = (T*)mu;
  PDT_DISPATCH_P(P, return launch<PP, T>(a, lanes, st));
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// mu may be NULL (no mu written). normed: counts holds counts / sf. The
// plan: `lanes` a gene (4, 8, 32 with staged = 0: y in registers, N <=
// 16 lanes; 32 or 256 with 1 <= staged <= N: the first `staged` samples of
// each row in shared memory).
extern "C" int mom_launch(int is_f64, int P, int G, int N, const void* counts, const void* sf,
                          const void* X, const void* pinv, double min_mu, int normed, int lanes, int staged,
                          void* rough, void* moments, void* coef, void* mu, void* stream) {
  if (G <= 0) return (int)cudaSuccess;
  if (N <= P) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int rc = is_f64 ? launch_typed<double>(P, G, N, counts, sf, X, pinv, min_mu, normed, lanes, staged, rough,
                                               moments, coef, mu, s)
                        : launch_typed<float>(P, G, N, counts, sf, X, pinv, min_mu, normed, lanes, staged, rough,
                                              moments, coef, mu, s);
  return rc != 0 ? rc : (int)cudaGetLastError();
}
