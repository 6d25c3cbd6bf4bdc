// Exact trimmed means and trimmed (cell) variances by key bisection.
//
// Replaces pydeseq2_tpu/ops/select.py:166 trimmed_mean_select inside
// pydeseq2_tpu/ops/stats.py:28 trimmed_mean, :88 trimmed_variance and
// :108 trimmed_cell_variance, as the class API calls them: the robust MoM
// dispersions of Cook's distances (a cohort's trimmed variance, the max over
// cohorts) and scipy_style_trim_mean of the mean trend (one column of ~G
// values).
//
// Each row of x (R, N) is reduced by one group of threads: a warp where the
// rows are short (the cohorts of a sample axis), a block of 256 where they
// are long (a column of 60000 dispersions), so both keep every thread busy.
// A trimmed mean drops k values at each end: the two boundary order
// statistics (ranks k and n-1-k) come from MSB-first bisection over the
// monotone keys of common.cuh (one group-wide count per key bit, both ranks
// per pass, the two counts packed in one 64-bit sum), the interior is then
// summed and the copies of each boundary value inside the kept ranks are
// counted exactly, so the kept multiset is a sort's; lo == hi gives lo. The
// kept sum is taken in float64 and rounded once to T, as the plain version
// (ops/stats.py) does on both its sort and select paths, so in float32 the
// two agree to the bit but for rounding ties of the float64 sum. Values are
// re-read on every pass (the row stays in L1/L2); nothing is staged.
//
// mode 0: out[r] = trimmed_mean(x[r, :], k[0]).
// mode 1: out[r] = max over cohorts c of scale[c] * trimmed_mean((v - m)^2,
//   k[c]), m = trimmed_mean(v, k[c]), v = x[r, members[off[c]:off[c+1]]].
//
// Bound on the H100 by operations: each of the 32 or 64 bisection passes
// re-reads the row from cache, so a row of n costs ~2 x 64 n compares and
// key maps in float64; the bytes (the row once, one value out) are far less.
#include "common.cuh"

using namespace pdt;

namespace {

constexpr int THREADS = 256;
constexpr int NWARP = THREADS / WARP;
typedef unsigned long long u64;

// One warp per row.
struct WarpGroup {
  int rank;
  static constexpr int size = WARP;
  __device__ __forceinline__ double sum(double v) const { return warp_sum(v); }
  __device__ __forceinline__ u64 sum(u64 v) const {
#pragma unroll
    for (int o = WARP / 2; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
    return v;
  }
};

// One block per row: warp trees, then the NWARP warp sums added in warp
// order by every thread (every thread ends with the same bits).
struct BlockGroup {
  int rank;
  double* dsh;
  u64* ush;
  static constexpr int size = THREADS;
  template <typename V> __device__ __forceinline__ V reduce(V v, V* sh) const {
#pragma unroll
    for (int o = WARP / 2; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
    if ((rank & (WARP - 1)) == 0) sh[rank / WARP] = v;
    __syncthreads();
    V s = V(0);
#pragma unroll
    for (int w = 0; w < NWARP; ++w) s += sh[w];
    __syncthreads();  // sh is reused by the next reduction
    return s;
  }
  __device__ __forceinline__ double sum(double v) const { return reduce(v, dsh); }
  __device__ __forceinline__ u64 sum(u64 v) const { return reduce(v, ush); }
};

// Trimmed mean of val(0..n-1) dropping k at each end; every thread of the
// group returns it.
template <typename T, typename Grp, typename F>
__device__ T tmean(F val, int n, int k, const Grp& g) {
  using K = KeyOf<T>;
  using U = typename K::U;
  if (k == 0) {
    double s = 0.0;
    for (int i = g.rank; i < n; i += Grp::size) s += double(val(i));
    return T(g.sum(s)) / T(n);
  }
  const int k_hi = n - 1 - k;
  U t_lo = 0, t_hi = 0;
  for (int b = K::BITS - 1; b >= 0; --b) {
    const U c_lo = t_lo | ((U)1 << b);
    const U c_hi = t_hi | ((U)1 << b);
    u64 cnt = 0;  // low half: keys below c_lo; high half: keys below c_hi
    for (int i = g.rank; i < n; i += Grp::size) {
      const U kk = K::key(val(i));
      cnt += (u64)(kk < c_lo) + ((u64)(kk < c_hi) << 32);
    }
    cnt = g.sum(cnt);
    if ((int)(cnt & 0xffffffffull) <= k) t_lo = c_lo;
    if ((int)(cnt >> 32) <= k_hi) t_hi = c_hi;
  }
  const T lo = K::value(t_lo);
  const T hi = K::value(t_hi);
  double strict = 0.0;
  u64 cnt = 0;  // low half: values <= lo; high half: values < hi
  for (int i = g.rank; i < n; i += Grp::size) {
    const T x = val(i);
    if (x > lo && x < hi) strict += double(x);
    cnt += (u64)(x <= lo) + ((u64)(x < hi) << 32);
  }
  strict = g.sum(strict);
  cnt = g.sum(cnt);
  // kept ranks are [k, n-1-k]; the copies of each boundary value inside them
  const double copies_lo = double((long long)(cnt & 0xffffffffull) - k);
  const double copies_hi = double((long long)n - k - (long long)(cnt >> 32));
  const double total = strict + double(lo) * copies_lo + double(hi) * copies_hi;
  return lo == hi ? lo : T(total) / T(n - 2 * k);
}

template <typename T, typename Grp>
__device__ T row_stat(const T* __restrict__ row, int N, int mode, const int* __restrict__ members,
                      const int* __restrict__ off, int n_cohorts, const int* __restrict__ ks,
                      const T* __restrict__ scales, const Grp& g) {
  if (mode == 0) return tmean<T>([&](int i) { return row[i]; }, N, ks[0], g);
  T out = T(0);
  for (int c = 0; c < n_cohorts; ++c) {
    const int* mem = members + off[c];
    const int n = off[c + 1] - off[c];
    const int k = ks[c];
    const T m = tmean<T>([&](int i) { return row[mem[i]]; }, n, k, g);
    const T v = scales[c] * tmean<T>([&](int i) {
      const T d = row[mem[i]] - m;
      return d * d;
    }, n, k, g);
    out = c == 0 ? v : m_max(out, v);
  }
  return out;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    trimmed_warp_kernel(int R, int N, int mode, const T* __restrict__ x, const int* __restrict__ members,
                        const int* __restrict__ off, int n_cohorts, const int* __restrict__ ks,
                        const T* __restrict__ scales, T* __restrict__ out) {
  const int r = (int)(((size_t)blockIdx.x * THREADS + threadIdx.x) / WARP);
  if (r >= R) return;
  const WarpGroup g{(int)(threadIdx.x & (WARP - 1))};
  const T s = row_stat<T>(x + (size_t)r * N, N, mode, members, off, n_cohorts, ks, scales, g);
  if (g.rank == 0) out[r] = s;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    trimmed_block_kernel(int N, int mode, const T* __restrict__ x, const int* __restrict__ members,
                         const int* __restrict__ off, int n_cohorts, const int* __restrict__ ks,
                         const T* __restrict__ scales, T* __restrict__ out) {
  __shared__ double dsh[NWARP];
  __shared__ u64 ush[NWARP];
  const BlockGroup g{(int)threadIdx.x, dsh, ush};
  const T s = row_stat<T>(x + (size_t)blockIdx.x * N, N, mode, members, off, n_cohorts, ks, scales, g);
  if (g.rank == 0) out[blockIdx.x] = s;
}

template <typename T>
int launch(int R, int N, int mode, int per_block, const void* x, const void* members, const void* off,
           int n_cohorts, const void* ks, const void* scales, void* out, cudaStream_t s) {
  if (per_block) {
    trimmed_block_kernel<T><<<(unsigned)R, THREADS, 0, s>>>(
        N, mode, (const T*)x, (const int*)members, (const int*)off, n_cohorts, (const int*)ks,
        (const T*)scales, (T*)out);
  } else {
    const unsigned blocks = (unsigned)(((size_t)R * WARP + THREADS - 1) / THREADS);
    trimmed_warp_kernel<T><<<blocks, THREADS, 0, s>>>(
        R, N, mode, (const T*)x, (const int*)members, (const int*)off, n_cohorts, (const int*)ks,
        (const T*)scales, (T*)out);
  }
  return 0;
}

}  // namespace

// x (R, N) contiguous. mode 0: ks[0] only (members, off, scales may be
// NULL). mode 1: members (off[n_cohorts],) sample indices grouped by
// cohort, off (n_cohorts + 1,), ks and scales (n_cohorts,). per_block: one
// block of 256 per row instead of one warp.
extern "C" int trimmed_var_launch(int is_f64, int R, int N, int mode, int per_block, const void* x,
                                  const void* members, const void* off, int n_cohorts,
                                  const void* ks, const void* scales, void* out, void* stream) {
  if (R <= 0) return (int)cudaSuccess;
  if (N <= 0 || (mode != 0 && mode != 1) || (mode == 1 && n_cohorts <= 0)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_f64) {
    launch<double>(R, N, mode, per_block, x, members, off, n_cohorts, ks, scales, out, s);
  } else {
    launch<float>(R, N, mode, per_block, x, members, off, n_cohorts, ks, scales, out, s);
  }
  return (int)cudaGetLastError();
}
