// Hat diagonals and the Wald test of the fitted NB GLM: lane groups that
// compute each sample's exp and weight once.
//
// Replaces hat_diagonals (pydeseq2_tpu/ops/irls.py:444) followed by
// wald_test_batch (pydeseq2_tpu/ops/wald.py:28). Pass 1 over the gene's N
// samples builds two packed Gram matrices at once:
//   X^T diag(W_thr) X, W_thr = mu_thr / (1 + mu_thr disp), mu_thr =
//     max(sf e^{x b}, min_mu)  (the hat matrix's weights);
//   X^T diag(W) X,     W = mu / (1 + mu disp) on the UNthresholded mu, which
//     is what the JAX pipeline hands wald_test_batch (fused.py:484-490).
// Where mu >= min_mu the two weights are one quotient (the same expression
// on the same value), and where mu < min_mu W_thr is min_mu / (1 + min_mu
// disp), one quotient a gene, so a sample costs one exp and one division.
// Pass 1 writes mu and keeps W_thr for pass 2, which writes H_n = W_thr,n
// x_n^T (M_thr + 1e-6 I)^-1 x_n without forming mu or the weight again. The
// counts are never read.
//
// A group of S lanes owns a gene (the plan's, ops/wald.py:_hat_wald_plan: 4
// lanes to 64 samples, 8 to 128, 32 below 2048, else a block of 256), as
// mom.cu and irls.cu split their rows: at 100 samples the lanes are full and
// a warp holds 4 genes, so the per-gene tail (the reductions, the two
// inverses, the test) is issued once for 4 genes. Lane l of a group takes
// samples l, l + S, ..., so a group's stores of H and mu cover consecutive
// samples. W_thr is kept in shared memory for the first `staged` samples of
// each row (the whole row but at atlas widths and past 1024 float32 / 512
// float64 samples on 32 lanes); past them pass 2 reads back the mu it wrote
// and divides again, so shared memory never caps N. Each lane reads back
// only what it wrote, so the passes need no barrier. (Registers in place of
// shared memory meant a 16-fold unrolled pass in every instantiation: the
// source took 317 s to build.)
//
// Each lane sums its samples' Gram terms in the working type, in sample
// order; the lanes' partials are joined in float64 by a fixed tree
// (common.cuh group_sum / block_sum) and rounded once, so every plan repeats
// its bits and each sum's order depends on S alone.
//
// The tail (group_inverses): each ridged matrix is inverted once a group.
// For P <= 3 each lane pair forms both closed forms in one stream of
// instructions (even lanes the hat matrix, odd lanes the Wald one) and swaps
// them by one shuffle; for P >= 4 each lane factors its matrix and solves
// only its share of the identity's columns (sym_inv solves all P on every
// lane: 60 IEEE divisions a lane at P = 5), and the lanes gather the
// columns by shuffles, the same bits. Every lane then evaluates the
// contrast SE sqrt(Hc^T M Hc), Hc = (M + 1e-6 I)^-1 c, the statistic and
// the p-value of the chosen alternative (ops/wald.py:68-96), so the erfc of
// a warp's genes is one instruction stream; lane 0 of the group writes
// them.
//
// Without H and mu buffers (the streamed refit wants the test alone) the
// fused entry runs pass 1 for the Wald matrix only: no hat matrix, no store,
// no pass 2. Its p, statistic and SE are those of the full launch bit for
// bit: the same terms in the same order.
//
// Bound on the H100 by its writes, 2 x G x N values (48 MB at 100 x 60000
// f32, 0.0143 ms).
//
// Two more entries serve the class API, which calls the two halves apart
// (models/dataset.py fit_LFC, models/stats.py run_wald_test):
//   hat_launch  (hat_diagonals alone): pass 1 builds only X^T W_thr X, pass
//     2 writes H; bound by the same 2 G N writes.
//   wald_launch (wald_test_batch alone): reads the caller's (G, N) mu
//     instead of forming it, and the caller's (P, P) ridge (DeseqStats
//     passes diag(1 / prior_LFC_var^2) or 1e-6 I) instead of 1e-6 I; it
//     writes no (G, N) value, so it is bound by reading mu, G x N values.
#include "common.cuh"

using namespace pdt;

namespace {

constexpr int THREADS = 256;
constexpr int BLOCK_LANES = THREADS;  // S of a block a gene

__device__ __forceinline__ float m_erfc(float x) { return erfcf(x); }
__device__ __forceinline__ double m_erfc(double x) { return erfc(x); }
// fmax/fmin drop a NaN operand (jnp.fmax / torch.fmax semantics).
__device__ __forceinline__ float m_fmax(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double m_fmax(double a, double b) { return fmax(a, b); }
__device__ __forceinline__ float m_fmin(float a, float b) { return fminf(a, b); }
__device__ __forceinline__ double m_fmin(double a, double b) { return fmin(a, b); }

template <typename T> __device__ __forceinline__ T norm_sf(T x) {
  return T(0.5) * m_erfc(x / m_sqrt(T(2)));
}

// alt_hypothesis codes (ops/wald.py:ALT_CODES)
enum { ALT_NONE = 0, ALT_GREATER_ABS = 1, ALT_LESS_ABS = 2, ALT_GREATER = 3, ALT_LESS = 4 };
// what a launch computes: both halves; the hat diagonals alone; the test
// alone (on the caller's mu and ridge, or on sf e^{x b} and 1e-6 I)
enum { MODE_FUSED = 0, MODE_HAT = 1, MODE_TEST = 2 };

// sum_p fmax((lfc_p - null) / se, 0) c_p (greater) or fmin (less)
template <int P, typename T, bool GREATER>
__device__ __forceinline__ T one_sided(const T* lfc, const T* c, T se, T null) {
  T s = T(0);
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const T z = (lfc[p] - null) / se;
    s = s + (GREATER ? m_fmax(z, T(0)) : m_fmin(z, T(0))) * c[p];
  }
  return s;
}

// The contrast SE, statistic and p-value of the alternative `alt` from the
// Wald matrix M (packed, unridged) and its ridged inverse, each expression
// as ops/wald.py:_wald_plain forms it. The p-value is fac * norm_sf(z), or
// for lessAbs the larger of two, so erfc has two call sites, not one per
// alternative.
template <int P, typename T>
__device__ __forceinline__ void wald_stat(const T* b, const T* c, const T* gram, const T* hinv, T null, int alt,
                                          T& pval, T& stat, T& se) {
  T hc[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    T s = T(0);
#pragma unroll
    for (int q = 0; q < P; ++q) s = s + hinv[p * P + q] * c[q];
    hc[p] = s;
  }
  T quad = T(0);
#pragma unroll
  for (int p = 0; p < P; ++p) {
    T s = T(0);
#pragma unroll
    for (int q = 0; q < P; ++q) s = s + gram[tri_idx<P>(p, q)] * hc[q];
    quad = quad + hc[p] * s;
  }
  se = m_sqrt(quad);
  T z = T(0), z2 = T(0), fac = T(1);
  if (alt == ALT_GREATER) {
    stat = one_sided<P, T, true>(b, c, se, null);
    z = stat;
  } else if (alt == ALT_LESS) {
    stat = one_sided<P, T, false>(b, c, se, null);
    z = m_abs(stat);
  } else if (alt == ALT_GREATER_ABS) {
    T s = T(0);
#pragma unroll
    for (int p = 0; p < P; ++p) s = s + m_sign(b[p]) * m_fmax((m_abs(b[p]) - null) / se, T(0)) * c[p];
    stat = s;
    z = m_abs(s);
    fac = T(2);
  } else if (alt == ALT_LESS_ABS) {
    const T above = one_sided<P, T, true>(b, c, se, -m_abs(null));
    const T below = one_sided<P, T, false>(b, c, se, m_abs(null));
    stat = m_abs(above) < m_abs(below) ? above : below;
    z = above;
    z2 = m_abs(below);
  } else {
    T dot = T(0), csum = T(0);
#pragma unroll
    for (int p = 0; p < P; ++p) {
      dot = dot + b[p] * c[p];
      csum = csum + c[p];
    }
    stat = (dot - null * csum) / se;
    z = m_abs(stat);
    fac = T(2);
  }
  const T p1 = norm_sf(z);
  pval = alt == ALT_LESS_ABS ? m_max(p1, norm_sf(z2)) : fac * p1;
}

template <typename T> struct HwArgs {
  int G, N, staged, alt;
  const T* beta;
  const T* disp;
  const T* sf;
  const T* X;
  const T* contrast;
  const T* lfc_null;
  T min_mu;
  const T* mu_in;  // MODE_TEST: the caller's mu, or null (sf e^{x b})
  const T* ridge;  // MODE_TEST: the caller's (P, P) ridge, or null (1e-6 I)
  T* H;
  T* mu;
  T* pval;
  T* stat;
  T* se;
};

// Elements of shared memory between two groups' staged rows: the least
// count >= staged that is S modulo 32 where groups share a warp, so a
// warp's 32 lanes hit 32 banks.
template <int S> __host__ __device__ constexpr int stage_stride(int staged) {
  return S >= WARP ? staged : staged + ((S - staged) & (WARP - 1));
}

// The ridged inverses (row-major P x P) of a group's NM packed matrices r,
// each formed once: NM = 2 puts the hat matrix on even lanes and the Wald
// one on odd lanes, NM = 1 one matrix on every lane. For P <= 3 each lane
// forms its matrix's closed form and the pair swaps them; above, each lane
// factors its matrix and solves only the columns of the identity assigned
// to it, and the lanes gather the columns by shuffles. wl is a lane's place
// in a segment of SW <= 32 lanes that all hold the same matrices. The bits
// are sym_inv's (common.cuh): the same factor and the same column solves,
// a zero dividend its own quotient (div_z) as the division would give.
template <int P, typename T, int SW, int NM>
__device__ __forceinline__ void group_inverses(const T* r, unsigned mask, int wl, T* inv0, T* inv1) {
  const bool odd = NM == 2 && (wl & 1);
  if constexpr (P <= 3) {
    T inv[P * P];
    sym_inv<T, P>(r, inv);
#pragma unroll
    for (int i = 0; i < P * P; ++i) {
      if constexpr (NM == 2) {
        const T other = __shfl_xor_sync(mask, inv[i], 1);
        inv0[i] = odd ? other : inv[i];
        inv1[i] = odd ? inv[i] : other;
      } else {
        inv0[i] = inv[i];
      }
    }
  } else {
    constexpr int LPM = SW / NM;            // lanes a matrix
    constexpr int K = (P + LPM - 1) / LPM;  // columns a lane solves
    Chol<T, P> ch;
    chol<T, P, true>(r, ch);
    T col[K][P];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int j = wl / NM + k * LPM;  // past P: a solve of zeros, never gathered
      T e[P];
#pragma unroll
      for (int i = 0; i < P; ++i) e[i] = i == j ? T(1) : T(0);
      chol_solve<T, P, true>(ch, e, col[k]);
    }
#pragma unroll
    for (int j = 0; j < P; ++j) {
#pragma unroll
      for (int i = 0; i < P; ++i) {
        inv0[i * P + j] = __shfl_sync(mask, col[j / LPM][i], (j % LPM) * NM, SW);
        if constexpr (NM == 2) inv1[i * P + j] = __shfl_sync(mask, col[j / LPM][i], (j % LPM) * NM + 1, SW);
      }
    }
  }
}

// S lanes a gene; W_thr of the first a.staged samples of each row in shared
// memory (MODE_TEST keeps nothing).
template <int P, typename T, int S, int MODE>
__global__ void __launch_bounds__(THREADS) hat_wald_kernel(HwArgs<T> a) {
  constexpr bool HAT = MODE != MODE_TEST;
  constexpr bool TEST = MODE != MODE_HAT;
  constexpr bool BLOCK = S > WARP;
  constexpr int SW = BLOCK ? WARP : S;          // lanes a segment that holds one gene's values
  constexpr int GPB = BLOCK ? 1 : THREADS / S;  // genes a block
  constexpr int NT = NTRI<P>;
  constexpr int HOFF = 0, WOFF = HAT ? NT : 0;  // the two triangles' places among the sums
  constexpr int NV = (HAT ? NT : 0) + (TEST ? NT : 0);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ double s_red[BLOCK ? (THREADS / WARP) * NV : 1];

  const int N = a.N;
  const int grp = BLOCK ? 0 : (int)threadIdx.x / S;
  const int gl = BLOCK ? (int)threadIdx.x : (int)threadIdx.x & (S - 1);
  const unsigned mask =
      (BLOCK || S == WARP) ? FULL : (((1u << S) - 1u) << ((threadIdx.x & (WARP - 1)) & ~(unsigned)(S - 1)));
  const int gene = (int)blockIdx.x * GPB + grp;
  if (gene >= a.G) return;  // a whole group (a block plan's grid is G)

  const T disp = a.disp[gene];
  T b[P];
#pragma unroll
  for (int p = 0; p < P; ++p) b[p] = a.beta[(size_t)gene * P + p];
  // W_thr of a clamped sample (mu < min_mu, so mu_thr = min_mu): one
  // quotient a gene, the same bits as forming it a sample
  const T w_min = a.min_mu / (T(1) + a.min_mu * disp);
  T* mu_row = HAT ? a.mu + (size_t)gene * N : nullptr;
  const T* mu_in = (MODE == MODE_TEST && a.mu_in != nullptr) ? a.mu_in + (size_t)gene * N : nullptr;
  T* ws = reinterpret_cast<T*>(smem_raw) + grp * stage_stride<S>(a.staged);
  const int staged = HAT ? a.staged : 0;  // 0 <= a.staged <= N (launch)

  // ---- pass 1: mu, the weights, both Gram triangles ----
  T tri[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) tri[i] = T(0);
  // Not unrolled: unrolled by the compiler (same registers) the fused entry
  // took 0.0756 against 0.0364 ms at 100 x 60000 f32 on an H100.
#pragma unroll 1
  for (int n = gl; n < N; n += S) {
    const T* xr = a.X + n * P;
    T xv[P], mu;
    if (MODE == MODE_TEST && mu_in != nullptr) {
#pragma unroll
      for (int p = 0; p < P; ++p) xv[p] = __ldg(xr + p);
      mu = mu_in[n];
    } else {
      mu = __ldg(a.sf + n) * m_exp(lin_pred<P, T>(xr, 0, b, xv));
    }
    // mu_thr = max(mu, min_mu): min_mu where mu < min_mu, else mu (NaN included)
    const T w = mu / (T(1) + mu * disp);
    T w_thr = w;
    if constexpr (HAT) {
      mu_row[n] = mu;
      w_thr = mu < a.min_mu ? w_min : w;
      if (n < staged) ws[n] = w_thr;
    }
#pragma unroll
    for (int p = 0; p < P; ++p) {
#pragma unroll
      for (int q = p; q < P; ++q) {
        const T xx = xv[p] * xv[q];
        if (HAT) tri[HOFF + tri_idx<P>(p, q)] += w_thr * xx;
        if (TEST) tri[WOFF + tri_idx<P>(p, q)] += w * xx;
      }
    }
  }
  double acc[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) acc[i] = (double)tri[i];
  if constexpr (BLOCK) {
    block_sum<THREADS, NV>(acc, s_red);
  } else {
    group_sum<S, NV>(acc, mask, gl);
  }
#pragma unroll
  for (int i = 0; i < NV; ++i) tri[i] = T(acc[i]);

  // ---- the ridged inverses, each once a group ----
  T minv[HAT ? P * P : 1], hinv[TEST ? P * P : 1];
  {
    const int wl = gl & (SW - 1);
    const bool odd = HAT && TEST && (wl & 1);
    T r[NT];
#pragma unroll
    for (int i = 0; i < NT; ++i) r[i] = (TEST && (odd || !HAT)) ? tri[WOFF + i] : tri[HOFF + i];
    if (MODE == MODE_TEST && a.ridge != nullptr) {
#pragma unroll
      for (int p = 0; p < P; ++p) {
#pragma unroll
        for (int q = p; q < P; ++q) r[tri_idx<P>(p, q)] = r[tri_idx<P>(p, q)] + __ldg(a.ridge + p * P + q);
      }
    } else {
#pragma unroll
      for (int p = 0; p < P; ++p) r[tri_idx<P>(p, p)] = r[tri_idx<P>(p, p)] + T(1e-6);
    }
    if constexpr (HAT && TEST) {
      group_inverses<P, T, SW, 2>(r, BLOCK ? FULL : mask, wl, minv, hinv);
    } else if constexpr (HAT) {
      group_inverses<P, T, SW, 1>(r, BLOCK ? FULL : mask, wl, minv, nullptr);
    } else {
      group_inverses<P, T, SW, 1>(r, BLOCK ? FULL : mask, wl, hinv, nullptr);
    }
  }

  // ---- pass 2: the hat diagonals ----
  if constexpr (HAT) {
    T* Hrow = a.H + (size_t)gene * N;
    auto hat = [&](int n, T w_thr) {
      T xv[P];
#pragma unroll
      for (int p = 0; p < P; ++p) xv[p] = __ldg(a.X + n * P + p);
      T xmx = T(0);
#pragma unroll
      for (int p = 0; p < P; ++p) {
        T row = T(0);
#pragma unroll
        for (int q = 0; q < P; ++q) row = row + minv[p * P + q] * xv[q];
        xmx = xmx + xv[p] * row;
      }
      Hrow[n] = w_thr * xmx;
    };
    int n = gl;
    for (; n < staged; n += S) hat(n, ws[n]);
#pragma unroll 1
    for (; n < N; n += S) {  // past the staged samples: the quotient again, from the mu this lane wrote
      const T mu = mu_row[n];
      hat(n, mu < a.min_mu ? w_min : mu / (T(1) + mu * disp));
    }
  }

  // ---- the Wald test (every lane holds the same values; lane 0 writes) ----
  if constexpr (TEST) {
    T c[P];
#pragma unroll
    for (int p = 0; p < P; ++p) c[p] = __ldg(a.contrast + p);
    T pval, stat, se;
    wald_stat<P, T>(b, c, tri + WOFF, hinv, *a.lfc_null, a.alt, pval, stat, se);
    if (gl == 0) {
      a.pval[gene] = pval;
      a.stat[gene] = stat;
      a.se[gene] = se;
    }
  }
}

template <int P, typename T, int S, int MODE> int launch_plan(const HwArgs<T>& a, cudaStream_t st) {
  constexpr auto kern = hat_wald_kernel<P, T, S, MODE>;
  constexpr int GPB = S > WARP ? 1 : THREADS / S;
  const size_t smem = MODE == MODE_TEST ? 0 : (size_t)GPB * (size_t)stage_stride<S>(a.staged) * sizeof(T);
  if (smem + sizeof(double) * (THREADS / WARP) * 2 * NTRI<P> > SMEM_BLOCK_MAX) return (int)cudaErrorInvalidValue;
  if (smem > 0) {
    const cudaError_t e = smem_opt_in<kern>(smem);
    if (e != cudaSuccess) return (int)e;
  }
  const unsigned blocks = (unsigned)(((long long)a.G + GPB - 1) / GPB);
  kern<<<blocks, THREADS, smem, st>>>(a);
  return 0;
}

template <int P, typename T, int MODE> int launch(const HwArgs<T>& a, int lanes, cudaStream_t st) {
  if (a.staged < 0 || a.staged > a.N) return (int)cudaErrorInvalidValue;
  switch (lanes) {
    case 4: return launch_plan<P, T, 4, MODE>(a, st);
    case 8: return launch_plan<P, T, 8, MODE>(a, st);
    case 32: return launch_plan<P, T, 32, MODE>(a, st);
    case BLOCK_LANES: return launch_plan<P, T, BLOCK_LANES, MODE>(a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <int MODE>
int dispatch(int is_f64, int P, int G, int N, const void* beta, const void* disp, const void* sf, const void* X,
             const void* contrast, const void* lfc_null, double min_mu, int alt, const void* mu_in,
             const void* ridge, int lanes, int staged, void* H, void* mu, void* pval, void* stat, void* se,
             void* stream) {
  if (G <= 0) return (int)cudaSuccess;
  if (alt < ALT_NONE || alt > ALT_LESS) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  auto run = [&](auto zero) -> int {
    using T = decltype(zero);
    HwArgs<T> a;
    a.G = G;
    a.N = N;
    a.staged = staged;
    a.alt = alt;
    a.beta = (const T*)beta;
    a.disp = (const T*)disp;
    a.sf = (const T*)sf;
    a.X = (const T*)X;
    a.contrast = (const T*)contrast;
    a.lfc_null = (const T*)lfc_null;
    a.min_mu = (T)min_mu;
    a.mu_in = (const T*)mu_in;
    a.ridge = (const T*)ridge;
    a.H = (T*)H;
    a.mu = (T*)mu;
    a.pval = (T*)pval;
    a.stat = (T*)stat;
    a.se = (T*)se;
    PDT_DISPATCH_P(P, return launch<PP, T, MODE>(a, lanes, s));
    return (int)cudaErrorInvalidValue;
  };
  const int rc = is_f64 ? run(0.0) : run(0.0f);
  return rc != 0 ? rc : (int)cudaGetLastError();
}

}  // namespace

// H and mu both NULL: the test alone (no pass 2, nothing written but p,
// stat, se). The plan: `lanes` a gene (4, 8, 32 or 256) and 0 <= staged <=
// N, the samples of each row whose W_thr is kept in shared memory (the
// test alone ignores it).
extern "C" int hat_wald_launch(int is_f64, int P, int G, int N, const void* beta, const void* disp,
                               const void* sf, const void* X, const void* contrast,
                               const void* lfc_null, double min_mu, int alt, int lanes, int staged, void* H,
                               void* mu, void* pval, void* stat, void* se, void* stream) {
  if ((H == nullptr) != (mu == nullptr)) return (int)cudaErrorInvalidValue;
  if (H == nullptr) {
    return dispatch<MODE_TEST>(is_f64, P, G, N, beta, disp, sf, X, contrast, lfc_null, min_mu, alt, nullptr,
                               nullptr, lanes, 0, nullptr, nullptr, pval, stat, se, stream);
  }
  return dispatch<MODE_FUSED>(is_f64, P, G, N, beta, disp, sf, X, contrast, lfc_null, min_mu, alt, nullptr,
                              nullptr, lanes, staged, H, mu, pval, stat, se, stream);
}

extern "C" int hat_launch(int is_f64, int P, int G, int N, const void* beta, const void* disp, const void* sf,
                          const void* X, double min_mu, int lanes, int staged, void* H, void* mu, void* stream) {
  return dispatch<MODE_HAT>(is_f64, P, G, N, beta, disp, sf, X, nullptr, nullptr, min_mu, ALT_NONE, nullptr,
                            nullptr, lanes, staged, H, mu, nullptr, nullptr, nullptr, stream);
}

extern "C" int wald_launch(int is_f64, int P, int G, int N, const void* lfc, const void* disp, const void* mu,
                           const void* X, const void* ridge, const void* contrast, const void* lfc_null, int alt,
                           int lanes, void* pval, void* stat, void* se, void* stream) {
  if (mu == nullptr || ridge == nullptr) return (int)cudaErrorInvalidValue;
  return dispatch<MODE_TEST>(is_f64, P, G, N, lfc, disp, nullptr, X, contrast, lfc_null, 0.0, alt, mu, ridge,
                             lanes, 0, nullptr, nullptr, pval, stat, se, stream);
}
