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
// What bounds it on the H100: the special-function units and the FP32 pipe
// on psi(y + 1/alpha): eight reciprocals, a reciprocal and a log in
// digamma_st8, a log1p and a division per sample (~12 SFU operations, ~45
// floating-point operations), against 8-16 bytes of counts and mu. At 100 x
// 60000 f32 the 48 MB read once take 0.014 ms; the SFU work ~0.02 ms.
// Design: a warp per row, lanes striding the row (coalesced), psi(1/alpha)
// and alpha^-2 once per row, one warp reduction. Sum order: lane l sums
// samples l, l + 32, ... in index order, then the xor butterfly.
#include "common.cuh"

using namespace pdt;

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float psi_only(float z) { return digamma_st8(z); }
__device__ __forceinline__ double psi_only(double z) { return digamma_f64(z); }

template <typename T>
__global__ void __launch_bounds__(THREADS)
    dnb_nll_kernel(int R, int N, const T* __restrict__ counts, const T* __restrict__ mu,
                   const T* __restrict__ alpha, T* __restrict__ out) {
  const int row = (int)(((size_t)blockIdx.x * THREADS + threadIdx.x) / WARP);
  const int lane = threadIdx.x & (WARP - 1);
  if (row >= R) return;  // whole warps leave together
  const T* y = counts + (size_t)row * N;
  const T* m = mu + (size_t)row * N;
  const T a = alpha[row];
  const T r = T(1) / a;
  const T psi_r = psi_only(r);
  T s = T(0);
  for (int n = lane; n < N; n += WARP) {
    const T yv = y[n];
    const T mv = m[n];
    s += psi_r - psi_only(yv + r) + m_log1p(mv * a) + (yv - mv) / (mv + r);
  }
  s = warp_sum(s);
  if (lane == 0) out[row] = -((T(1) / (a * a)) * s);
}

template <typename T>
void launch(int R, int N, const void* counts, const void* mu, const void* alpha, void* out,
            cudaStream_t s) {
  const unsigned blocks = (unsigned)(((size_t)R * WARP + THREADS - 1) / THREADS);
  dnb_nll_kernel<T><<<blocks, THREADS, 0, s>>>(R, N, (const T*)counts, (const T*)mu,
                                              (const T*)alpha, (T*)out);
}

}  // namespace

extern "C" int dnb_nll_launch(int is_f64, int R, int N, const void* counts, const void* mu,
                              const void* alpha, void* out, void* stream) {
  if (R <= 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_f64) {
    launch<double>(R, N, counts, mu, alpha, out, s);
  } else {
    launch<float>(R, N, counts, mu, alpha, out, s);
  }
  return (int)cudaGetLastError();
}
