// Exact trimmed means and trimmed (cell) variances over staged keys.
//
// Replaces pydeseq2_tpu/ops/select.py:166 trimmed_mean_select inside
// pydeseq2_tpu/ops/stats.py:28 trimmed_mean, :88 trimmed_variance and
// :108 trimmed_cell_variance, as the class API calls them: the robust MoM
// dispersions of Cook's distances (a cohort's trimmed variance, the max over
// cohorts) and scipy_style_trim_mean of the mean trend (one column of ~G
// values).
//
// Each row of x (R, N) is reduced by one group of threads, as the launch
// plan (ops/stats.py:_trim_plan) says: a warp where the cohorts are short
// (the cohorts of a sample axis, 8 rows a block), a block where they are long
// (a column of 60000 dispersions: one block of 1024), so both keep every
// thread busy. The group gathers a cohort's values once as keys into its
// staging buffer (shared memory, or the plan's global workspace where a
// cohort does not fit), takes the trimmed mean by trimmed.cuh's rank count
// or radix select, forms the squared errors from the staged keys in place
// and takes their trimmed mean. The kept sums are taken in float64 and
// rounded once to T, as the plain version (ops/stats.py) does on both its
// sort and select paths, so in float32 the two agree to the bit but for
// rounding ties of the float64 sum.
//
// mode 0: out[r] = trimmed_mean(x[r, :], k[0]).
// mode 1: out[r] = max over cohorts c of scale[c] * trimmed_mean((v - m)^2,
//   k[c]), m = trimmed_mean(v, k[c]), v = x[r, members[off[c]:off[c+1]]].
//
// Bound on the H100 by its bytes (the row read once, one value written):
// the selection runs on the staged keys, n compares a key for the rank
// count, 4 (float32) or 8 (float64) histogram passes for the radix select.
#include "trimmed.cuh"

using namespace pdt;

namespace {

struct TrimArgs {
  int R, N, mode;
  const int* members;
  const int* off;
  int n_cohorts;
  const int* ks;
  int rank_max, n_max;
};

template <typename T, typename Grp>
__device__ T row_stat(const TrimArgs& a, const T* __restrict__ row, const T* __restrict__ scales,
                      typename KeyOf<T>::U* ck, unsigned* hist, typename KeyOf<T>::U* bnd, const Grp& g) {
  using K = KeyOf<T>;
  const int me = g.rank(), step = g.size();
  if (a.mode == 0) {
    for (int i = me; i < a.N; i += step) ck[i] = K::key(row[i]);
    g.sync();
    return trimmed_mean_keys<T>(ck, a.N, __ldg(a.ks), a.rank_max, hist, bnd, g);
  }
  T out = T(0);
  for (int c = 0; c < a.n_cohorts; ++c) {
    const int* mem = a.members + __ldg(a.off + c);
    const int n = __ldg(a.off + c + 1) - __ldg(a.off + c);
    const int k = __ldg(a.ks + c);
    for (int i = me; i < n; i += step) ck[i] = K::key(row[__ldg(mem + i)]);
    g.sync();
    const T m = trimmed_mean_keys<T>(ck, n, k, a.rank_max, hist, bnd, g);
    for (int i = me; i < n; i += step) {
      const T d = K::value(ck[i]) - m;
      ck[i] = K::key(d * d);
    }
    g.sync();
    const T v = __ldg(scales + c) * trimmed_mean_keys<T>(ck, n, k, a.rank_max, hist, bnd, g);
    out = c == 0 ? v : m_max(out, v);
  }
  return out;
}

template <typename T>
__global__ void __launch_bounds__(TRIM_WARPS * WARP)
    trimmed_warp_kernel(const TrimArgs a, const T* __restrict__ x, const T* __restrict__ scales, T* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int w = threadIdx.x / WARP;
  using U = typename KeyOf<T>::U;
  const bool radix = a.n_max > a.rank_max;
  const size_t group = trim_group_bytes(a.n_max, (int)sizeof(T), radix, true, false);
  const TrimSlice<U> sl(smem + w * group, a.n_max, radix, true, false, nullptr);
  const WarpGroup g{};
  for (int r = blockIdx.x * TRIM_WARPS + w; r < a.R; r += gridDim.x * TRIM_WARPS) {
    const T s = row_stat<T>(a, x + (size_t)r * a.N, scales, sl.keys, sl.hist, sl.bnd, g);
    if (g.rank() == 0) out[r] = s;
  }
}

// A block a row; the grid loops over the rows. shared: the keys in dynamic
// shared memory, else in the block's slice of the workspace ws
// (trim_ws_len values a block).
template <typename T>
__global__ void __launch_bounds__(TRIM_BLOCK_MAX)
    trimmed_block_kernel(const TrimArgs a, const T* __restrict__ x, const T* __restrict__ scales, T* __restrict__ out,
                         bool shared, T* ws) {
  extern __shared__ __align__(16) unsigned char smem[];
  using U = typename KeyOf<T>::U;
  const bool radix = a.n_max > a.rank_max;
  U* slice = shared ? nullptr : (U*)ws + blockIdx.x * trim_ws_len(a.n_max, (int)sizeof(T));
  const TrimSlice<U> sl(smem, a.n_max, radix, shared, true, slice);
  const BlockGroup g{sl.red, sl.redi};
  for (int r = blockIdx.x; r < a.R; r += gridDim.x) {
    const T s = row_stat<T>(a, x + (size_t)r * a.N, scales, sl.keys, sl.hist, sl.bnd, g);
    if (g.rank() == 0) out[r] = s;
    g.sync();
  }
}

template <typename T>
int launch(const TrimArgs& a, const void* x, const void* scales, void* out, int block, int threads, int shared,
           int blocks, void* ws, cudaStream_t s) {
  const bool radix = a.n_max > a.rank_max;
  const size_t group = trim_group_bytes(a.n_max, (int)sizeof(T), radix, shared != 0, block != 0);
  if (!block) {
    const size_t smem = TRIM_WARPS * group;
    if (!shared || smem > SMEM_BLOCK_MAX) return (int)cudaErrorInvalidValue;
    cudaError_t e = smem_opt_in<trimmed_warp_kernel<T>>(SMEM_BLOCK_MAX);
    if (e != cudaSuccess) return (int)e;
    const unsigned grid = (unsigned)((a.R + TRIM_WARPS - 1) / TRIM_WARPS);
    trimmed_warp_kernel<T><<<grid, TRIM_WARPS * WARP, smem, s>>>(a, (const T*)x, (const T*)scales, (T*)out);
    return (int)cudaGetLastError();
  }
  if (threads < BlockGroup::MIN_SIZE || threads > TRIM_BLOCK_MAX || threads % WARP != 0 || group > SMEM_BLOCK_MAX ||
      (!shared && (ws == nullptr || blocks < 1)))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = smem_opt_in<trimmed_block_kernel<T>>(SMEM_BLOCK_MAX);
  if (e != cudaSuccess) return (int)e;
  const unsigned grid = (unsigned)(shared ? a.R : (blocks < a.R ? blocks : a.R));
  trimmed_block_kernel<T><<<grid, threads, group, s>>>(a, (const T*)x, (const T*)scales, (T*)out, shared != 0,
                                                       (T*)ws);
  return (int)cudaGetLastError();
}

}  // namespace

// x (R, N) contiguous. mode 0: ks[0] only (members, off, scales may be
// NULL). mode 1: members (off[n_cohorts],) sample indices grouped by
// cohort, off (n_cohorts + 1,), ks and scales (n_cohorts,). The plan
// (ops/stats.py:TrimPlan): block (a block of `threads` a row, else a warp),
// rank_max (cohorts of at most this many members take the rank count,
// <= 128), shared (staged keys in shared memory, else in ws: `blocks`
// slices of trim_ws_len(n_max) values, the grid then `blocks` blocks), n_max the longest
// cohort (N in mode 0).
extern "C" int trimmed_var_launch(int is_f64, int R, int N, int mode, const void* x, const void* members,
                                  const void* off, int n_cohorts, const void* ks, const void* scales, void* out,
                                  int block, int threads, int rank_max, int shared, int blocks, int n_max, void* ws,
                                  void* stream) {
  if (R <= 0) return (int)cudaSuccess;
  if (N <= 0 || (mode != 0 && mode != 1) || (mode == 1 && n_cohorts <= 0) || n_max < 1 || n_max > N ||
      (mode == 0 && n_max != N) || rank_max < 0 || rank_max > RANK_CAP)
    return (int)cudaErrorInvalidValue;
  const TrimArgs a{R, N, mode, (const int*)members, (const int*)off, n_cohorts, (const int*)ks, rank_max, n_max};
  cudaStream_t s = (cudaStream_t)stream;
  if (is_f64) return launch<double>(a, x, scales, out, block, threads, shared, blocks, ws, s);
  return launch<float>(a, x, scales, out, block, threads, shared, blocks, ws, s);
}
