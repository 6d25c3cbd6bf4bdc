// Dispersion Newton polish: (f, g, h) in log-alpha and the safeguarded
// Newton steps, all in one launch.
//
// Replaces fgh_closed + newton_body (pydeseq2_tpu/ops/dispersion.py:313,
// 361) with nb_nll_centered_fgh (ops/nb.py:283). Per evaluation a gene sums
// the NB value/gradient/curvature terms and the three Cox-Reid Grams
// M = X^T W X, M' and M'' (W = mu/(1 + mu a), W' = -a W^2,
// W'' = W' (1 - 2 a W)) over its N samples, then inverts M for the
// log-determinant's derivatives. r = exp(-la) is one value per gene, so each
// gene evaluates one branch: the Stirling-difference form for r >= 8, the
// plain form with lgamma, psi and psi' of y + r below it (Stirling-8 forms
// in float, the library lgamma and the series psi/psi' of common.cuh in
// double). The Newton acceptance logic (step clip, gradient-contraction
// gate, strict-descent fallback) follows each evaluation.
//
// What bounds it on the H100: the instruction issue rate on the
// transcendentals, as in the scan. Per sample and evaluation the stable form
// costs two log1p and 13 IEEE divisions (~85 floating-point operations as the
// kernel table counts them, ~16 on the special-function units); the plain
// form lgamma_st8, psi_st8 and psi'_st8 besides (~127 operations, ~30 SFU).
// Five evaluations read each row once if it is staged; the 48 MB of rows at
// 100 x 60000 f32 take 0.015 ms.
//
// The design (PERF.md section 6, PR 7, says what it replaced and why):
//   - L lanes per gene, chosen at launch from N (4 up to 64 samples, 8 up to
//     128, 16 up to 256, 32 beyond), so a lane sums >= ~12 samples and a
//     warp holds 32 / L genes; then doubled, up to 32, while the blocks
//     would not fill one wave of the card (the SMs times the blocks an SM
//     holds at once by the occupancy API, which counts this P's registers
//     and the staged rows), since a short gene list otherwise leaves SMs
//     idle or short of warps. The sums are reduced by a segmented xor
//     butterfly of log2 L shuffles; every lane of a gene ends with the same
//     bits, so the epilogue and the acceptance step run on the gene's own
//     lanes with no broadcast, and one warp instruction serves 32 / L genes.
//   - The block's rows (256 / L genes) and the design are staged once into
//     shared memory when they fit in 100 KB (N = 100: 32 genes, 35 KB f32,
//     71 KB f64) and all five evaluations read them there; the row stride is
//     padded to L mod 32 so the L lanes of the 32 / L genes of a warp hit 32
//     distinct banks. Longer rows are read from device memory by each
//     evaluation, L = 32 lanes coalesced (the rows of a block do
//     not fit, and every evaluation needs the whole row). Plain loads stage
//     the rows: TMA would need 16-byte aligned row strides, which N does not
//     give, and other resident blocks hide the one load.
//   - Genes of one warp may take different branches (r < 8 or not) and the
//     warp then runs both: with 32 / L genes a warp, most warps are mixed
//     where the dispersions sit near alpha = 1/8. The wrapper hands the
//     kernel the genes grouped by the branch at their start (an order
//     array; each gene's results land at its own index), and the branch test
//     sits inside the sample loop, so a warp that is mixed all the same
//     runs the shared part of a sample (mu / r, the Grams) once.
//     pydeseq2_tpu_torch/disp_bench.py --detail times the launch on rows
//     ordered by their final branch beside the wrapper's order.
//   - One fgh call site: the first evaluation and the iters Newton steps
//     are one loop.
// Sum order, per gene and evaluation: lane l of the gene's L sums the value,
// gradient and curvature terms of samples l, l + L, l + 2L, ... in index
// order in float64, the L lane sums are combined by the xor butterfly
// (offsets L/2, ..., 1) in float64, and the total is rounded once to the
// working type, as the plain version (ops/nb.py:_sum_f64) sums them. The
// Grams: the same order in the working type.
#include "common.cuh"

using namespace pdt;

namespace {

constexpr int THREADS = 256;
constexpr size_t STAGE_MAX = 100 * 1024;  // shared memory for staged rows

template <typename T> __device__ __forceinline__ T seg_sum(T v, int L) {
  for (int o = L >> 1; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// (f, g, h) of one gene at la; y, m, X may point to shared or device memory.
template <int P, typename T>
__device__ __forceinline__ void fgh(const T* y, const T* m, const T* X, int N, int sub, int L,
                                    T la, int cr_reg, int prior_reg, T lah, T pdv, T& f, T& g,
                                    T& h) {
  const T r = m_exp(-la);
  const bool plain = r < T(R_SWITCH);
  const T ir = T(1) / r;
  const T ir3 = ir * ir * ir;
  T log_r = T(0), lg_r = T(0), psi_r = T(0), tri_r = T(0);
  if (plain) {
    log_r = m_log(r);
    lg_r = m_lgamma(r);
    psi_fast(r, psi_r, tri_r);
  }
  const T a = m_exp(la);

  // The value, gradient and curvature terms cancel to totals far below
  // their sizes: they are summed in float64 and rounded once, as the plain
  // version sums them.
  double fs = 0.0, gs = 0.0, hs = 0.0;
  T M0[NTRI<P>], M1[NTRI<P>], M2[NTRI<P>];
#pragma unroll
  for (int i = 0; i < NTRI<P>; ++i) M0[i] = M1[i] = M2[i] = T(0);

  for (int n = sub; n < N; n += L) {
    const T yv = y[n];
    const T mv = m[n];
    const T v = mv / r;
    const T l1p_v = m_log1p(v);
    const T yr = yv + r;
    const T mr = mv + r;
    const T s_v = mv / mr;
    if (!plain) {
      const T u = yv / r;
      const T l1p_u = m_log1p(u);
      const T s_u = yv / yr;
      const T q_u = yv * r / (yr * yr);
      const T q_v = mv * r / (mr * mr);
      const T iyr = T(1) / yr;
      const T iyr2 = iyr * iyr;
      fs += (double)(-r * (l1p_u - u) - (yv - T(0.5)) * l1p_u + r * (l1p_v - v) + yv * l1p_v +
                     yv * ir * iyr / T(12) + (iyr2 * iyr - ir3) / T(360));
      const T dT5 = yv * (yv + T(2) * r) * ir * iyr2 / T(12);
      const T dT6 = (r * iyr2 * iyr2 - ir3) / T(120);
      gs += (double)(r * (l1p_u - s_u) - (yv - T(0.5)) * s_u - r * (l1p_v - s_v) + yv * s_v + dT5 +
                     dT6);
      const T d2T5 =
          yv * (yv * yv + T(3) * r * yv + T(4) * r * r) * ir * iyr2 * iyr / T(12);
      const T d2T6 =
          (-r * iyr2 * iyr2 + T(4) * r * r * iyr2 * iyr2 * iyr - T(3) * ir3) / T(120);
      hs += (double)(-r * (l1p_u - s_u) + r * (s_u - q_u) - (yv - T(0.5)) * q_u +
                     r * (l1p_v - s_v) - r * (s_v - q_v) + yv * q_v + d2T5 + d2T6);
    } else {
      const T lg_yr = lgamma_fast(yr);
      T psi_yr, tri_yr;
      psi_fast(yr, psi_yr, tri_yr);
      fs += (double)(-r * log_r - lg_yr + lg_r + yr * (log_r + l1p_v) - mv);
      const T yr_over = yr / mr;
      gs += (double)(r * (T(1) + psi_yr - psi_r - l1p_v - yr_over));
      hs += (double)(r * (l1p_v - T(1) - s_v + psi_r - psi_yr) + r * r * (tri_r - tri_yr) +
                     r * (yv + T(2) * r) / mr - r * r * yr / (mr * mr));
    }
    if (cr_reg) {
      const T W = mv / (T(1) + mv * a);
      const T Wd1 = -a * W * W;
      const T Wd2 = Wd1 * (T(1) - T(2) * a * W);
      const T* xn = X + (size_t)n * P;
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const T xp = xn[p];
#pragma unroll
        for (int q = p; q < P; ++q) {
          const T xpq = xp * xn[q];
          M0[tri_idx<P>(p, q)] += W * xpq;
          M1[tri_idx<P>(p, q)] += Wd1 * xpq;
          M2[tri_idx<P>(p, q)] += Wd2 * xpq;
        }
      }
    }
  }
  f = (T)seg_sum(fs, L);
  g = (T)seg_sum(gs, L);
  h = (T)seg_sum(hs, L);
  if (cr_reg) {
#pragma unroll
    for (int i = 0; i < NTRI<P>; ++i) {
      M0[i] = seg_sum(M0[i], L);
      M1[i] = seg_sum(M1[i], L);
      M2[i] = seg_sum(M2[i], L);
    }
    T Minv[P * P], F1[P * P], F2[P * P];
    sym_inv<T, P>(M0, Minv);
    unpack<T, P>(M1, F1);
    unpack<T, P>(M2, F2);
    T A[P * P];
#pragma unroll
    for (int p = 0; p < P; ++p)
#pragma unroll
      for (int s = 0; s < P; ++s) {
        T acc = T(0);
#pragma unroll
        for (int q = 0; q < P; ++q) acc += Minv[p * P + q] * F1[q * P + s];
        A[p * P + s] = acc;
      }
    T tr_a = T(0), tr_m2 = T(0), tr_aa = T(0);
#pragma unroll
    for (int p = 0; p < P; ++p) {
      tr_a += A[p * P + p];
#pragma unroll
      for (int q = 0; q < P; ++q) {
        tr_m2 += Minv[p * P + q] * F2[q * P + p];
        tr_aa += A[p * P + q] * A[q * P + p];
      }
    }
    f = f + T(0.5) * sym_logdet<T, P>(M0);
    g = g + T(0.5) * tr_a;
    h = h + T(0.5) * (tr_m2 - tr_aa);
  }
  if (prior_reg) {
    const T d = la - lah;
    f = f + d * d / (T(2) * pdv);
    g = g + d / pdv;
    h = h + T(1) / pdv;
  }
}

// stride > 0: the block's rows and X are staged in dynamic shared memory,
// row r of the block at r * stride; stride == 0: read from device memory.
template <int P, typename T>
__global__ void __launch_bounds__(THREADS)
    disp_newton_kernel(int G, int N, int L, int stride, const int* __restrict__ order,
                       const T* __restrict__ counts,
                       const T* __restrict__ mu, const T* __restrict__ X,
                       const T* __restrict__ la0, const T* __restrict__ la_hat,
                       const T* __restrict__ pdv_p, T lo, T hi, T clipw, T step2, int iters,
                       int cr_reg, int prior_reg, T* __restrict__ la_out, T* __restrict__ f_out,
                       T* __restrict__ g_out, T* __restrict__ h_out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int gpb = THREADS / L;
  const int gl = threadIdx.x / L;
  const int sub = threadIdx.x - gl * L;
  const int g0 = blockIdx.x * gpb;
  const int ng = min(gpb, G - g0);
  // A lane past the last gene evaluates the block's first gene (its warp
  // must take part in the shuffles) and writes nothing.
  const bool live = gl < ng;
  // Position p of the launch takes gene order[p] (the genes grouped by
  // branch).
  const int gi = order[g0 + (live ? gl : 0)];

  const T* y;
  const T* m;
  const T* Xs;
  if (stride > 0) {
    T* s_y = reinterpret_cast<T*>(smem_raw);
    T* s_m = s_y + (size_t)gpb * stride;
    T* s_x = s_m + (size_t)gpb * stride;
    for (int e = threadIdx.x; e < ng * N; e += THREADS) {
      const int row = e / N;
      const int n = e - row * N;
      const size_t src = (size_t)order[g0 + row] * N + n;
      s_y[row * stride + n] = counts[src];
      s_m[row * stride + n] = mu[src];
    }
    if (cr_reg) {
      for (int e = threadIdx.x; e < N * P; e += THREADS) s_x[e] = X[e];
    }
    __syncthreads();
    y = s_y + (live ? gl : 0) * stride;
    m = s_m + (live ? gl : 0) * stride;
    Xs = s_x;
  } else {
    y = counts + (size_t)gi * N;
    m = mu + (size_t)gi * N;
    Xs = X;
  }
  const T pdv = *pdv_p;
  const T lah = prior_reg ? la_hat[gi] : T(0);

  T la = la0[gi];
  T f = T(0), g = T(0), h = T(0);
  T cand = la;
  T raw = T(0);
  for (int it = -1; it < iters; ++it) {
    if (it >= 0) {
      raw = h > T(0) ? g / h : m_sign(g) * step2;
      const T step = m_min(m_max(raw, -clipw), clipw);
      cand = m_min(m_max(la - step, lo), hi);
    }
    T fn, gn, hn;
    fgh<P, T>(y, m, Xs, N, sub, L, cand, cr_reg, prior_reg, lah, pdv, fn, gn, hn);
    if (it < 0) {
      f = fn;
      g = gn;
      h = hn;
      continue;
    }
    // Gradient-contraction gate for small positive-curvature steps, strict
    // descent otherwise (pydeseq2_tpu/ops/dispersion.py:384-387).
    const bool contraction = (h > T(0)) && (m_abs(raw) <= clipw) && (m_abs(gn) <= m_abs(g));
    if (contraction || fn < f) {
      la = cand;
      f = fn;
      g = gn;
      h = hn;
    }
  }
  if (live && sub == 0) {
    la_out[gi] = la;
    f_out[gi] = f;
    g_out[gi] = g;
    h_out[gi] = h;
  }
}

// Row stride of the staged rows for L lanes a gene (0: not staged) and the
// dynamic shared memory it takes.
template <typename T>
void stage_layout(int N, int P, int L, int& stride, size_t& bytes) {
  stride = (N + WARP - 1) / WARP * WARP + L % WARP;
  bytes = ((size_t)2 * (THREADS / L) * stride + (size_t)N * P) * sizeof(T);
  if (bytes > STAGE_MAX) {
    stride = 0;
    bytes = 0;
  }
}

template <int P, typename T>
int launch(int G, int N, const void* order, const void* counts, const void* mu,
           const void* X, const void* la0,
           const void* la_hat, const void* pdv, double lo, double hi, double clipw,
           double step2, int iters, int cr_reg, int prior_reg, void* la_out, void* f_out,
           void* g_out, void* h_out, cudaStream_t s) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(disp_newton_kernel<P, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)STAGE_MAX);
  if (e != cudaSuccess) return (int)e;
  int L = N <= 64 ? 4 : (N <= 128 ? 8 : (N <= 256 ? 16 : 32));
  int stride;
  size_t bytes;
  for (;; L *= 2) {
    stage_layout<T>(N, P, L, stride, bytes);
    if (L == WARP) break;
    int per_sm = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, disp_newton_kernel<P, T>, THREADS,
                                                      bytes);
    if (e != cudaSuccess) return (int)e;
    const int gpb = THREADS / L;
    if ((long long)(G + gpb - 1) / gpb >= (long long)per_sm * sms) break;
  }
  const int gpb = THREADS / L;
  const unsigned blocks = (unsigned)((G + gpb - 1) / gpb);
  disp_newton_kernel<P, T><<<blocks, THREADS, bytes, s>>>(
      G, N, L, stride, (const int*)order, (const T*)counts, (const T*)mu, (const T*)X, (const T*)la0,
      (const T*)la_hat, (const T*)pdv, (T)lo, (T)hi, (T)clipw, (T)step2, iters, cr_reg,
      prior_reg, (T*)la_out, (T*)f_out, (T*)g_out, (T*)h_out);
  return 0;
}

__global__ void psi_f64_kernel(const double* __restrict__ x, int n, double* __restrict__ psi,
                               double* __restrict__ tri) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) {
    psi[i] = digamma_f64(x[i]);
    tri[i] = trigamma_f64(x[i]);
  }
}

}  // namespace

extern "C" int disp_newton_launch(int is_f64, int P, int G, int N, const void* order,
                                  const void* counts,
                                  const void* mu, const void* X, const void* la0,
                                  const void* la_hat, const void* pdv, double lo, double hi,
                                  double clipw, double step2, int iters, int cr_reg,
                                  int prior_reg, void* la_out, void* f_out, void* g_out,
                                  void* h_out, void* stream) {
  if (G <= 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  int rc = 0;
  if (is_f64) {
    PDT_DISPATCH_P(P, rc = launch<PP, double>(G, N, order, counts, mu, X, la0, la_hat, pdv, lo, hi,
                                              clipw, step2, iters, cr_reg, prior_reg, la_out,
                                              f_out, g_out, h_out, s));
  } else {
    PDT_DISPATCH_P(P, rc = launch<PP, float>(G, N, order, counts, mu, X, la0, la_hat, pdv, lo, hi,
                                             clipw, step2, iters, cr_reg, prior_reg, la_out,
                                             f_out, g_out, h_out, s));
  }
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}

// The float64 psi and psi' of common.cuh, elementwise, for checking them
// against torch.digamma / torch.polygamma(1, .) on the card.
extern "C" int psi_f64_launch(const void* x, int n, void* psi, void* tri, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  psi_f64_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>((const double*)x, n,
                                                                      (double*)psi,
                                                                      (double*)tri);
  return (int)cudaGetLastError();
}
