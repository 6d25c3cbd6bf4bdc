// The variance-stabilising transform, one elementwise pass over (G, N).
//
// Replaces the transform of pydeseq2_tpu/fused.py:886-912 (vst_pipeline)
// and pydeseq2_tpu/fused_stream.py:1249-1273 (vst_pipeline_streamed): with
// v = counts / sf_n, either the parametric closed form
//   log((1 + a1 + 2 a0 v + 2 sqrt(a0 v (1 + a1 + a0 v))) / (4 a0)) / log 2
// or the mean form
//   (2 asinh(sqrt(d v)) - log d - log 4) / log 2,  d = the mean dispersion,
// chosen by the trend type and, for the parametric trend, by its
// used_mean flag (the in-program fallback), read on the device; NaN rows
// where the gene is masked out. jnp.log2(x) lowers to log(x) / log(2), so
// the division is spelled out. The trend's coefficients, flag and mean
// dispersion are read through the read-only cache.
//
// Bound on the H100 by its bytes: the counts read once and the result
// written once, 24 + 24 MB at 100 x 60000 f32. One thread per cell in a
// grid-stride loop, neighbouring threads on neighbouring cells, the cell's
// gene found by a 32-bit divide where the index fits.
#include "common.cuh"

using namespace pdt;

namespace {

constexpr int THREADS = 256;

template <typename T> __device__ __forceinline__ T m_asinh(T x);
template <> __device__ __forceinline__ float m_asinh(float x) { return asinhf(x); }
template <> __device__ __forceinline__ double m_asinh(double x) { return asinh(x); }

// I: the cell index type, 32-bit where G N < 2^32 (a 64-bit divide by N
// costs several times a 32-bit one).
template <typename T, typename I>
__global__ void __launch_bounds__(THREADS)
    vst_kernel(int G, int N, int mean_only, const T* __restrict__ counts,
               const T* __restrict__ sf, const T* __restrict__ coeffs,
               const uint8_t* __restrict__ used_mean, const T* __restrict__ mean_disp,
               const uint8_t* __restrict__ gene_mask, T* __restrict__ out) {
  const T ln2 = T(0.6931471805599453);
  const T ln4 = T(1.3862943611198906);
  const bool use_mean = mean_only || __ldg(used_mean);
  const T d = __ldg(mean_disp);
  const T log_d = m_log(d);
  const T a0 = use_mean ? T(0) : __ldg(coeffs);
  const T a1 = use_mean ? T(0) : __ldg(coeffs + 1);
  const I total = (I)G * (I)N;
  const I n_cols = (I)N;
  for (I i = (I)blockIdx.x * THREADS + threadIdx.x; i < total; i += (I)gridDim.x * THREADS) {
    const I gi = i / n_cols;
    const I n = i - gi * n_cols;
    if (!__ldg(gene_mask + gi)) {
      out[i] = Lim<T>::inf() - Lim<T>::inf();  // NaN
      continue;
    }
    const T v = counts[i] / __ldg(sf + n);
    T res;
    if (use_mean) {
      res = ((T(2) * m_asinh(m_sqrt(d * v)) - log_d) - ln4) / ln2;
    } else {
      const T one_a1 = T(1) + a1;
      const T a0v = a0 * v;
      const T num = (one_a1 + (T(2) * a0) * v) + T(2) * m_sqrt(a0v * (one_a1 + a0v));
      res = m_log(num / (T(4) * a0)) / ln2;
    }
    out[i] = res;
  }
}

template <typename T>
int launch(int G, int N, int mean_only, const void* counts, const void* sf, const void* coeffs,
           const void* used_mean, const void* mean_disp, const void* gene_mask, void* out,
           cudaStream_t st) {
  const size_t total = (size_t)G * N;
  const size_t want = (total + THREADS - 1) / THREADS;
  const unsigned blocks = (unsigned)(want < 132 * 64 ? want : 132 * 64);
  // The grid-stride index stays below total + grid threads.
  if (total + (size_t)blocks * THREADS <= 0xffffffffull) {
    vst_kernel<T, uint32_t><<<blocks, THREADS, 0, st>>>(
        G, N, mean_only, (const T*)counts, (const T*)sf, (const T*)coeffs,
        (const uint8_t*)used_mean, (const T*)mean_disp, (const uint8_t*)gene_mask, (T*)out);
  } else {
    vst_kernel<T, size_t><<<blocks, THREADS, 0, st>>>(
        G, N, mean_only, (const T*)counts, (const T*)sf, (const T*)coeffs,
        (const uint8_t*)used_mean, (const T*)mean_disp, (const uint8_t*)gene_mask, (T*)out);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// out (G, N). mean_only = 1 for the mean trend (coeffs and used_mean may
// then be NULL); otherwise the parametric coefficients (2,) and the
// used_mean flag (one byte) choose the form.
extern "C" int vst_launch(int is_f64, int G, int N, int mean_only, const void* counts,
                          const void* sf, const void* coeffs, const void* used_mean,
                          const void* mean_disp, const void* gene_mask, void* out, void* stream) {
  if (G <= 0 || N <= 0) return (int)cudaSuccess;
  if (!mean_only && (coeffs == nullptr || used_mean == nullptr)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (is_f64)
    return launch<double>(G, N, mean_only, counts, sf, coeffs, used_mean, mean_disp, gene_mask,
                          out, st);
  return launch<float>(G, N, mean_only, counts, sf, coeffs, used_mean, mean_disp, gene_mask, out,
                       st);
}
