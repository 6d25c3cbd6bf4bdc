// Derivative of the NB negative log-likelihood in the dispersion alpha.
//
// Replaces dnb_nll (pydeseq2_tpu/ops/nb.py:381), the reference's digamma
// form (pydeseq2/utils.py:237-270):
//   d NLL / d alpha = -alpha^-2 sum_n [psi(1/alpha) - psi(y_n + 1/alpha)
//                                      + log1p(mu_n alpha)
//                                      + (y_n - mu_n) / (mu_n + 1/alpha)],
// one value per row of (R, N) counts and means, in that expression order.
//
// psi: the port's dtype-gated psi of ops/nb.py:_digamma_fast, on both sides
// (kernel and plain version): the Stirling-8 form in float (digamma_st8),
// the shifted asymptotic series in double (digamma_f64, ~1e-15 relative).
// CUDA's math library has no digamma, and the port's f32 dispersion code
// already evaluates psi this way, so kernel and plain version compute the
// same terms and differ only in the order of the sum; the JAX package's
// library digamma differs from both by its own rounding (the tests state
// that tolerance). As alpha -> 0 the difference psi(1/alpha) - psi(y +
// 1/alpha) cancels and alpha^-2 amplifies it: the JAX formula is computed
// as it stands, ill-conditioned there in float32 exactly as in JAX.
//
// What bounds it on the H100: the issue of each cell's terms, not its
// bytes. A float32 cell is psi(y + 1/alpha) (nine IEEE divisions and a log
// in digamma_st8), a log1p and a division: 200-217 SASS instructions a
// trip of the cell loop (`kernel_bench --detail`, sass_loops) against 8
// bytes of counts and mu. At 100 x 60000 the 48 MB read once take 0.0145
// ms, the cells' issue ~0.036 ms; the kernel measured 0.049 (a warp a row
// with a float32 sum, the earlier design, 0.067; PERF.md row 17).
//
// Design: a group of S lanes owns a row (the plan's, ops/nb.py:_dnb_plan:
// 4 lanes to 48 samples, 8 to 256, 32 below 4096, in blocks of 128
// threads, else a block of 256 a row), so that short rows leave few lanes
// idle. One thread a row forms alpha, 1/alpha and psi(1/alpha) into
// shared memory before the cells, so no lane repeats that pass. Lane l of
// a group adds the terms of samples l, l + S, ... in index order to a
// float64 sum, loading the next sample's count and mean before the
// current terms (a loop unrolled further would send the lanes with one
// sample fewer down its remainder loop apart); the group joins its lanes
// by a fixed tree (common.cuh group_sum, or block_sum for a block) and
// rounds once. The sum's order depends on S alone: a plan repeats bit for
// bit. alpha comes as a row vector (alpha_step 1), one value on the card
// (step 0) or, with no pointer, by value from the host: a Python float
// costs no copy.
#include "common.cuh"

using namespace pdt;

namespace {

constexpr int THREADS = 256;
constexpr int BLOCK_LANES = THREADS;  // S of a block a row
constexpr int GROUP_THREADS = 128;    // a block of the lane-group plans (4-32 lanes a row)

__device__ __forceinline__ float psi_only(float z) { return digamma_st8(z); }
__device__ __forceinline__ double psi_only(double z) { return digamma_f64(z); }

template <typename T> struct DnbArgs {
  int R, N;
  const T* counts;
  const T* mu;
  const T* alpha;  // null: alpha_value for every row
  int alpha_step;  // 1: a value a row, 0: one value
  T alpha_value;
  T* out;
};

template <typename T, int S>
__global__ void __launch_bounds__(THREADS) dnb_nll_kernel(DnbArgs<T> a) {
  constexpr bool BLOCK = S > WARP;
  constexpr int GPB = BLOCK ? 1 : GROUP_THREADS / S;  // rows a block
  // each row's alpha, 1/alpha and psi(1/alpha), formed once by one thread
  __shared__ T s_a[GPB], s_r[GPB], s_psi[GPB];
  __shared__ double s_red[BLOCK ? THREADS / WARP : 1];
  const int row0 = (int)blockIdx.x * GPB;
  if ((int)threadIdx.x < GPB && row0 + (int)threadIdx.x < a.R) {
    const T av = a.alpha != nullptr ? a.alpha[(size_t)(row0 + threadIdx.x) * a.alpha_step] : a.alpha_value;
    const T r = T(1) / av;
    s_a[threadIdx.x] = av;
    s_r[threadIdx.x] = r;
    s_psi[threadIdx.x] = psi_only(r);
  }
  __syncthreads();
  const int grp = BLOCK ? 0 : (int)threadIdx.x / S;
  const int gl = BLOCK ? (int)threadIdx.x : (int)threadIdx.x & (S - 1);
  const int row = row0 + grp;
  if (row >= a.R) return;  // whole groups leave together (a block's rows are all < R)
  const unsigned mask =
      (BLOCK || S == WARP) ? FULL : (((1u << S) - 1u) << ((threadIdx.x & (WARP - 1)) & ~(unsigned)(S - 1)));
  const int N = a.N;
  const T* y = a.counts + (size_t)row * N;
  const T* m = a.mu + (size_t)row * N;
  const T av = s_a[grp], r = s_r[grp], psi_r = s_psi[grp];
  double s[1] = {0.0};
  T yv = gl < N ? y[gl] : T(0), mv = gl < N ? m[gl] : T(0);
#pragma unroll 1
  for (int n = gl; n < N; n += S) {
    const int nx = n + S;
    const T yn = nx < N ? y[nx] : T(0), mn = nx < N ? m[nx] : T(0);
    s[0] += (double)(psi_r - psi_only(yv + r) + m_log1p(mv * av) + (yv - mv) / (mv + r));
    yv = yn;
    mv = mn;
  }
  if constexpr (BLOCK) {
    block_sum<THREADS, 1>(s, s_red);
  } else {
    group_sum<S, 1>(s, mask, gl);
  }
  if (gl == 0) a.out[row] = -((T(1) / (av * av)) * T(s[0]));
}

template <typename T, int S> void launch(const DnbArgs<T>& a, cudaStream_t st) {
  constexpr int GPB = S > WARP ? 1 : GROUP_THREADS / S;
  const unsigned blocks = (unsigned)((a.R + GPB - 1) / GPB);
  constexpr int NT = S > WARP ? THREADS : GROUP_THREADS;
  dnb_nll_kernel<T, S><<<blocks, NT, 0, st>>>(a);
}

template <typename T>
int launch_lanes(int lanes, const DnbArgs<T>& a, cudaStream_t st) {
  switch (lanes) {
    case 4: launch<T, 4>(a, st); break;
    case 8: launch<T, 8>(a, st); break;
    case 32: launch<T, 32>(a, st); break;
    case BLOCK_LANES: launch<T, BLOCK_LANES>(a, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <typename T>
int run(int R, int N, int lanes, const void* counts, const void* mu, const void* alpha, int alpha_step,
        double alpha_value, void* out, cudaStream_t st) {
  const DnbArgs<T> a{R, N, (const T*)counts, (const T*)mu, (const T*)alpha, alpha_step, (T)alpha_value, (T*)out};
  return launch_lanes<T>(lanes, a, st);
}

}  // namespace

// lanes: the plan's lanes a row (4, 8, 32, or 256: a block a row).
extern "C" int dnb_nll_launch(int is_f64, int R, int N, int lanes, const void* counts, const void* mu,
                              const void* alpha, int alpha_step, double alpha_value, void* out, void* stream) {
  if (R <= 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  return is_f64 ? run<double>(R, N, lanes, counts, mu, alpha, alpha_step, alpha_value, out, st)
                : run<float>(R, N, lanes, counts, mu, alpha, alpha_step, alpha_value, out, st);
}
