// Cook's outlier imputation of the refit tile, one warp per row.
//
// Replaces the imputation step of pydeseq2_tpu/fused_stream.py:561-575
// (refit_pipeline_streamed; reference pydeseq2/dds.py:1331-1390): unpack
// the row's exceed bits (bit k of word w: sample 32 w + k), take the
// trimmed mean (trim 0.2, ops/stats.py:28, ops/select.py:166 at
// N >= 1024) of the normalised counts y/sf, and write
//   imputed_n = (replaceable_n and exceeds_n) ? floor(trim02 sf_n) : y_n,
// and new_all_zero = every imputed count is 0, on rows of the tile mask.
// The trimmed mean is common.cuh's exact key bisection, shared with the
// Cook's kernel: the kept multiset is a sort's and only the order of its
// sum differs, so a product trim02 sf_n within an ulp of an integer may
// floor to the neighbouring count.
//
// Bound on the H100 by its bytes: the tile read and the imputed tile
// written, 2 x K x N values; the bisection's re-reads of the row hit L1.
#include "common.cuh"

using namespace pdt;

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float m_floor(float x) { return floorf(x); }
__device__ __forceinline__ double m_floor(double x) { return floor(x); }

template <typename T>
__global__ void __launch_bounds__(THREADS)
    impute_kernel(int K, int N, int ntrim, const T* __restrict__ counts,
                  const int* __restrict__ packed, const unsigned char* __restrict__ repl,
                  const T* __restrict__ sf, const unsigned char* __restrict__ tile_mask,
                  T* __restrict__ imputed, unsigned char* __restrict__ new_all_zero) {
  const int gi = (int)(((size_t)blockIdx.x * THREADS + threadIdx.x) / WARP);
  const int lane = threadIdx.x & (WARP - 1);
  if (gi >= K) return;  // whole warps leave together
  const T* y = counts + (size_t)gi * N;
  const int* words = packed + (size_t)gi * ((N + WARP - 1) / WARP);
  auto normed = [&](int i) { return y[i] / __ldg(sf + i); };
  const T trim02 = trimmed_mean<T>(normed, N, ntrim, lane);

  bool nonzero = false;
  T* out = imputed + (size_t)gi * N;
  for (int n = lane; n < N; n += WARP) {
    const bool exceeds = ((words[n / WARP] >> (n % WARP)) & 1) != 0;
    const T v = (repl[n] != 0 && exceeds) ? m_floor(trim02 * __ldg(sf + n)) : y[n];
    out[n] = v;
    nonzero = nonzero || v != T(0);
  }
  nonzero = __any_sync(FULL, nonzero);
  if (lane == 0) new_all_zero[gi] = (!nonzero && tile_mask[gi] != 0) ? 1 : 0;
}

template <typename T>
int launch(int K, int N, int ntrim, const void* counts, const void* packed, const void* repl,
           const void* sf, const void* tile_mask, void* imputed, void* naz, cudaStream_t s) {
  const unsigned blocks = (unsigned)(((size_t)K * WARP + THREADS - 1) / THREADS);
  impute_kernel<T><<<blocks, THREADS, 0, s>>>(
      K, N, ntrim, (const T*)counts, (const int*)packed, (const unsigned char*)repl,
      (const T*)sf, (const unsigned char*)tile_mask, (T*)imputed, (unsigned char*)naz);
  return 0;
}

}  // namespace

extern "C" int impute_launch(int is_f64, int K, int N, int ntrim, const void* counts,
                             const void* packed, const void* replaceable, const void* sf,
                             const void* tile_mask, void* imputed, void* new_all_zero,
                             void* stream) {
  if (K <= 0) return (int)cudaSuccess;
  if (N <= 0 || ntrim < 0 || 2 * ntrim >= N) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_f64) {
    launch<double>(K, N, ntrim, counts, packed, replaceable, sf, tile_mask, imputed, new_all_zero, s);
  } else {
    launch<float>(K, N, ntrim, counts, packed, replaceable, sf, tile_mask, imputed, new_all_zero, s);
  }
  return (int)cudaGetLastError();
}
