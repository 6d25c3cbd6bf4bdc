// Cook's distances and the Cook's outlier flag, one warp per gene, with the
// outputs of the Cook's-refit mode.
//
// Replaces the trimmed moments of the Cook's robust dispersion
// (pydeseq2_tpu/ops/stats.py:88,108 trimmed_variance and
// trimmed_cell_variance, with ops/select.py:166 trimmed_mean_select), the
// elementwise block after them (fused.py:702-716) and the refit-mode bits
// of the streamed pipeline (fused_stream.py:422-445).
//
// For each cohort (a list of sample indices) the warp computes
//   rm  = trimmed mean of y/sf, dropping floor(n trim) at each end,
//   v_c = scale_c * trimmed mean of (y/sf - rm)^2,
// and v = max_c v_c, each trimmed mean by common.cuh's exact key bisection
// (the kept multiset is the sort's). The values are recomputed from the
// gene's row on every pass (L1-resident), not stored, so any N works
// without shared memory.
//
// Then m = mean of y/sf over all N samples, disp_c = max((v - m)/m^2, 0.04),
// and per sample cooks = (y - mu)^2 / ((mu + disp_c mu^2) P) * H / (1 - H)^2.
// A gene is flagged when a use_for_max sample's distance exceeds the cutoff
// and fewer than 3 samples have a count above that of the sample with the
// largest distance (the first argmax over ALL samples, a NaN counting as
// the largest); outlier = flagged & non_zero, and cooks (written only when
// asked) is NaN where the gene is not non_zero.
//
// Refit mode (a replaceable mask is given): the last pass also writes the
// per-cell bits cooks > cutoff packed 32 to a word, bit k of word w for
// sample 32 w + k; the warp walks the row 32 samples at a time, so lane k
// holds sample 32 w + k and one ballot is the word. replaced = any bit &
// non_zero, and outlier_refit = (a use_for_max, non-replaceable sample
// exceeds the cutoff) & the same count veto & non_zero.
//
// Bound on the H100 by its bytes: counts, mu and H read and cooks written,
// 4 x G x N values (3 without the distances, plus G N / 8 bytes of bits);
// the bisection's re-reads of the row hit L1.
#include "common.cuh"

using namespace pdt;

namespace {

constexpr int THREADS = 256;

// (value, index) of the first maximum, a NaN counting as the largest
// (jnp.argmax): does (vb, ib) beat (va, ia)?
template <typename T> __device__ __forceinline__ bool beats(T vb, int ib, T va, int ia) {
  const bool na = va != va, nb = vb != vb;
  if (na || nb) return nb && (!na || ib < ia);
  return vb > va || (vb == va && ib < ia);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    cooks_kernel(int G, int N, int P, const T* __restrict__ counts, const T* __restrict__ sf,
                 const T* __restrict__ mu_g, const T* __restrict__ H_g,
                 const unsigned char* __restrict__ non_zero, const unsigned char* __restrict__ ufm,
                 const T* __restrict__ cutoff_p, int C, const int* __restrict__ perm,
                 const int* __restrict__ offsets, const int* __restrict__ ntrim,
                 const T* __restrict__ scale, const unsigned char* __restrict__ repl,
                 T* __restrict__ cooks_out, unsigned char* __restrict__ outlier_out,
                 T* __restrict__ disp_out, int* __restrict__ packed_out,
                 unsigned char* __restrict__ replaced_out,
                 unsigned char* __restrict__ refit_out) {
  const int gi = (int)(((size_t)blockIdx.x * THREADS + threadIdx.x) / WARP);
  const int lane = threadIdx.x & (WARP - 1);
  if (gi >= G) return;  // whole warps leave together: gi is one per warp
  const T* y = counts + (size_t)gi * N;
  const T* mu = mu_g + (size_t)gi * N;
  const T* H = H_g + (size_t)gi * N;

  // ---- robust dispersion: max over cohorts of the trimmed variance ----
  T v = T(0);
  for (int c = 0; c < C; ++c) {
    const int* idx = perm + offsets[c];
    const int n = offsets[c + 1] - offsets[c];
    const int k = ntrim[c];
    auto normed = [&](int i) {
      const int s = __ldg(idx + i);
      return y[s] / __ldg(sf + s);
    };
    const T rm = trimmed_mean<T>(normed, n, k, lane);
    auto sqerr = [&](int i) {
      const T d = normed(i) - rm;
      return d * d;
    };
    const T vc = scale[c] * trimmed_mean<T>(sqerr, n, k, lane);
    v = c == 0 ? vc : m_max(v, vc);
  }
  T msum = T(0);
  for (int n = lane; n < N; n += WARP) msum += y[n] / __ldg(sf + n);
  const T m = warp_sum(msum) / T(N);
  const T disp_c = m_max((v - m) / (m * m), T(0.04));

  // ---- Cook's distances, cutoff tests, exceed bits, first argmax ----
  const bool nz = non_zero[gi] != 0;
  const T cutoff = *cutoff_p;
  const T nan = Lim<T>::inf() - Lim<T>::inf();
  const bool refit = repl != nullptr;
  const int W = (N + WARP - 1) / WARP;
  bool flagged = false, flagged_nr = false, any_exceeds = false;
  T best = -Lim<T>::inf();
  int best_i = 0x7fffffff;
  for (int base = 0; base < N; base += WARP) {
    const int n = base + lane;
    bool exceeds = false;
    if (n < N) {
      const T mun = mu[n];
      const T Hn = H[n];
      const T V = mun + disp_c * (mun * mun);
      const T r = y[n] - mun;
      const T sp = r * r / (V * T(P));
      const T omh = T(1) - Hn;
      const T cd = sp * Hn / (omh * omh);
      exceeds = cd > cutoff;
      flagged = flagged || (ufm[n] != 0 && exceeds);
      if (beats(cd, n, best, best_i)) {
        best = cd;
        best_i = n;
      }
      if (cooks_out != nullptr) cooks_out[(size_t)gi * N + n] = nz ? cd : nan;
      if (refit) flagged_nr = flagged_nr || (ufm[n] != 0 && repl[n] == 0 && exceeds);
    }
    if (refit) {
      const unsigned word = __ballot_sync(FULL, exceeds);
      any_exceeds = any_exceeds || word != 0u;
      if (lane == 0) packed_out[(size_t)gi * W + base / WARP] = (int)word;
    }
  }
  flagged = __any_sync(FULL, flagged);
  flagged_nr = __any_sync(FULL, flagged_nr);
#pragma unroll
  for (int o = WARP / 2; o > 0; o >>= 1) {
    const T vb = __shfl_xor_sync(FULL, best, o);
    const int ib = __shfl_xor_sync(FULL, best_i, o);
    if (beats(vb, ib, best, best_i)) {
      best = vb;
      best_i = ib;
    }
  }
  const T max_count = y[best_i];
  int above = 0;
  for (int n = lane; n < N; n += WARP) above += y[n] > max_count;
  above = warp_sum_i(above);
  if (lane == 0) {
    outlier_out[gi] = (flagged && above < 3 && nz) ? 1 : 0;
    disp_out[gi] = disp_c;
    if (refit) {
      replaced_out[gi] = (any_exceeds && nz) ? 1 : 0;
      refit_out[gi] = (flagged_nr && above < 3 && nz) ? 1 : 0;
    }
  }
}

template <typename T>
int launch(int G, int N, int P, const void* counts, const void* sf, const void* mu, const void* H,
           const void* non_zero, const void* ufm, const void* cutoff, int C, const void* perm,
           const void* offsets, const void* ntrim, const void* scale, const void* repl,
           void* cooks, void* outlier, void* disp, void* packed, void* replaced, void* refit,
           cudaStream_t s) {
  const unsigned blocks = (unsigned)(((size_t)G * WARP + THREADS - 1) / THREADS);
  cooks_kernel<T><<<blocks, THREADS, 0, s>>>(
      G, N, P, (const T*)counts, (const T*)sf, (const T*)mu, (const T*)H,
      (const unsigned char*)non_zero, (const unsigned char*)ufm, (const T*)cutoff, C,
      (const int*)perm, (const int*)offsets, (const int*)ntrim, (const T*)scale,
      (const unsigned char*)repl, (T*)cooks, (unsigned char*)outlier, (T*)disp, (int*)packed,
      (unsigned char*)replaced, (unsigned char*)refit);
  return 0;
}

}  // namespace

// cooks may be NULL (no distances written); repl NULL switches the refit
// outputs (packed, replaced, refit) off, else all three must be given.
extern "C" int cooks_launch(int is_f64, int G, int N, int P, const void* counts, const void* sf,
                            const void* mu, const void* H, const void* non_zero, const void* ufm,
                            const void* cutoff, int C, const void* perm, const void* offsets,
                            const void* ntrim, const void* scale, const void* repl, void* cooks,
                            void* outlier, void* disp, void* packed, void* replaced, void* refit,
                            void* stream) {
  if (G <= 0) return (int)cudaSuccess;
  if (N <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  if (repl != nullptr && (packed == nullptr || replaced == nullptr || refit == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_f64) {
    launch<double>(G, N, P, counts, sf, mu, H, non_zero, ufm, cutoff, C, perm, offsets, ntrim,
                   scale, repl, cooks, outlier, disp, packed, replaced, refit, s);
  } else {
    launch<float>(G, N, P, counts, sf, mu, H, non_zero, ufm, cutoff, C, perm, offsets, ntrim,
                  scale, repl, cooks, outlier, disp, packed, replaced, refit, s);
  }
  return (int)cudaGetLastError();
}
