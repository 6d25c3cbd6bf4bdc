// Cook's outlier imputation of the refit tile, on the trimmed-moment plans.
//
// Replaces the imputation step of pydeseq2_tpu/fused_stream.py:561-575
// (refit_pipeline_streamed; reference pydeseq2/dds.py:1331-1390): unpack
// the row's exceed bits (bit k of word w: sample 32 w + k), take the
// trimmed mean (trim 0.2, ops/stats.py:28, ops/select.py:166 at
// N >= 1024) of the normalised counts y/sf, and write
//   imputed_n = (replaceable_n and exceeds_n) ? floor(trim02 sf_n) : y_n,
// and new_all_zero = every imputed count is 0, on rows of the tile mask.
// Every row of the tile is computed, padding rows included.
//
// The launch plan is the Cook's kernel's (ops/stats.py:_trim_plan, one
// cohort of N members): a warp a row, 8 rows a block, each warp staging its
// row's keys in its own slice of shared memory, where eight slices fit
// (100 and 1000 samples in float32); else a block a row with the keys in
// shared memory (the atlas tile, 10000 samples), or in the block's slice of
// a global workspace past 227 KB. A row of at most rank_max samples takes
// trimmed.cuh's rank count, a longer one its radix select; both keep the
// sort's multiset, summed in float64 and rounded once as the plain version
// does, so a product trim02 sf_n within an ulp of an integer may still
// floor to the neighbouring count where that sum rounds the other way.
//
// Bound on the H100 by its bytes: the tile read and the imputed tile
// written, 2 x K x N values. The selection runs on the staged keys, so the
// row is read from device memory once for the keys and once (from L1/L2)
// for the output.
#include "trimmed.cuh"

using namespace pdt;

namespace {

__device__ __forceinline__ float m_floor(float x) { return floorf(x); }
__device__ __forceinline__ double m_floor(double x) { return floor(x); }

template <typename T> struct ImputeArgs {
  int K, N, ntrim;
  const T* counts;
  const int* packed;
  const unsigned char* repl;
  const T* sf;
  const unsigned char* tile_mask;
  T* imputed;
  unsigned char* new_all_zero;
  int rank_max;
};

// Row gi on one group; keys (N) is the group's staging buffer, hist and bnd
// its trimmed-mean scratch.
template <typename T, typename Grp>
__device__ void impute_row(const ImputeArgs<T>& a, int gi, typename KeyOf<T>::U* keys, unsigned* hist,
                           typename KeyOf<T>::U* bnd, const Grp& g) {
  using K = KeyOf<T>;
  const int N = a.N, me = g.rank(), step = g.size();
  const T* y = a.counts + (size_t)gi * N;
  const int* words = a.packed + (size_t)gi * ((N + WARP - 1) / WARP);
  T* out = a.imputed + (size_t)gi * N;
  for (int n = me; n < N; n += step) keys[n] = K::key(y[n] / __ldg(a.sf + n));
  g.sync();
  // ends with the group synchronised: the next row may restage at once
  const T trim02 = trimmed_mean_keys<T>(keys, N, a.ntrim, a.rank_max, hist, bnd, g);

  bool nonzero = false;
  for (int n = me; n < N; n += step) {
    const bool exceeds = ((__ldg(words + n / WARP) >> (n % WARP)) & 1) != 0;
    const T v = (__ldg(a.repl + n) != 0 && exceeds) ? m_floor(trim02 * __ldg(a.sf + n)) : y[n];
    out[n] = v;
    nonzero = nonzero || v != T(0);
  }
  nonzero = g.any(nonzero);
  if (me == 0) a.new_all_zero[gi] = (!nonzero && a.tile_mask[gi] != 0) ? 1 : 0;
}

// A warp a row, TRIM_WARPS rows a block, each warp its own slice of the
// dynamic shared memory.
template <typename T>
__global__ void __launch_bounds__(TRIM_WARPS * WARP) impute_warp_kernel(const ImputeArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  using U = typename KeyOf<T>::U;
  const int w = threadIdx.x / WARP;
  const bool radix = a.N > a.rank_max;
  const size_t group = trim_group_bytes(a.N, (int)sizeof(T), radix, true, false);
  const TrimSlice<U> sl(smem + w * group, a.N, radix, true, false, nullptr);
  const WarpGroup g{};
  for (int gi = blockIdx.x * TRIM_WARPS + w; gi < a.K; gi += gridDim.x * TRIM_WARPS)
    impute_row<T>(a, gi, sl.keys, sl.hist, sl.bnd, g);
}

// A block a row; the grid loops over the rows. shared: the keys in dynamic
// shared memory, else in the block's slice of the workspace ws
// (trim_ws_len values a block).
template <typename T>
__global__ void __launch_bounds__(TRIM_BLOCK_MAX) impute_block_kernel(const ImputeArgs<T> a, bool shared, T* ws) {
  extern __shared__ __align__(16) unsigned char smem[];
  using U = typename KeyOf<T>::U;
  const bool radix = a.N > a.rank_max;
  U* slice = shared ? nullptr : (U*)ws + blockIdx.x * trim_ws_len(a.N, (int)sizeof(T));
  const TrimSlice<U> sl(smem, a.N, radix, shared, true, slice);
  const BlockGroup g{sl.red, sl.redi};
  for (int gi = blockIdx.x; gi < a.K; gi += gridDim.x) {
    impute_row<T>(a, gi, sl.keys, sl.hist, sl.bnd, g);
    g.sync();  // the staged keys are rewritten by the next row
  }
}

template <typename T>
int launch(const ImputeArgs<T>& a, int block, int threads, int shared, int blocks, void* ws, cudaStream_t s) {
  const bool radix = a.N > a.rank_max;
  const size_t group = trim_group_bytes(a.N, (int)sizeof(T), radix, shared != 0, block != 0);
  if (!block) {
    const size_t smem = TRIM_WARPS * group;
    if (!shared || smem > SMEM_BLOCK_MAX) return (int)cudaErrorInvalidValue;
    cudaError_t e = smem_opt_in<impute_warp_kernel<T>>(SMEM_BLOCK_MAX);
    if (e != cudaSuccess) return (int)e;
    const unsigned grid = (unsigned)((a.K + TRIM_WARPS - 1) / TRIM_WARPS);
    impute_warp_kernel<T><<<grid, TRIM_WARPS * WARP, smem, s>>>(a);
    return (int)cudaGetLastError();
  }
  if (threads < BlockGroup::MIN_SIZE || threads > TRIM_BLOCK_MAX || threads % WARP != 0 || group > SMEM_BLOCK_MAX ||
      (!shared && (ws == nullptr || blocks < 1)))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = smem_opt_in<impute_block_kernel<T>>(SMEM_BLOCK_MAX);
  if (e != cudaSuccess) return (int)e;
  const unsigned grid = (unsigned)(shared ? a.K : (blocks < a.K ? blocks : a.K));
  impute_block_kernel<T><<<grid, threads, group, s>>>(a, shared != 0, (T*)ws);
  return (int)cudaGetLastError();
}

}  // namespace

// counts, imputed (K, N); packed (K, ceil(N / 32)) int32; replaceable (N,)
// and tile_mask, new_all_zero (K,) bytes (0 or 1). The plan
// (ops/stats.py:TrimPlan for one cohort of N): block (a block of `threads`
// a row, else a warp), rank_max (rows of at most this many samples take the
// rank count, <= 128), shared (staged keys in shared memory, else in ws:
// `blocks` slices of trim_ws_len(N) values, the grid then `blocks` blocks).
extern "C" int impute_launch(int is_f64, int K, int N, int ntrim, const void* counts, const void* packed,
                             const void* replaceable, const void* sf, const void* tile_mask, void* imputed,
                             void* new_all_zero, int block, int threads, int rank_max, int shared, int blocks,
                             void* ws, void* stream) {
  if (K <= 0) return (int)cudaSuccess;
  if (N <= 0 || ntrim < 0 || 2 * ntrim >= N || rank_max < 0 || rank_max > RANK_CAP) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_f64) {
    const ImputeArgs<double> a{K, N, ntrim, (const double*)counts, (const int*)packed,
                               (const unsigned char*)replaceable, (const double*)sf,
                               (const unsigned char*)tile_mask, (double*)imputed,
                               (unsigned char*)new_all_zero, rank_max};
    return launch<double>(a, block, threads, shared, blocks, ws, s);
  }
  const ImputeArgs<float> a{K, N, ntrim, (const float*)counts, (const int*)packed, (const unsigned char*)replaceable,
                            (const float*)sf, (const unsigned char*)tile_mask, (float*)imputed,
                            (unsigned char*)new_all_zero, rank_max};
  return launch<float>(a, block, threads, shared, blocks, ws, s);
}
