// Dispersion scans: the NB objective at K grid points per gene, and the
// strict first minimum.
//
// Replaces two programs of pydeseq2_tpu/ops/dispersion.py, both built on
// nb_nll_centered (ops/nb.py:135) and the Cox-Reid sym_logdet:
//   - scan_coarse (:196), the static grid la_k = lo + k step1 shared by every
//     gene, which also writes the (K, G) objective cache (disp_scan_launch);
//   - scan_grid (:170-194), the fine scan of alpha_mle_batch(fine_length > 0):
//     a per-gene grid clip(center_g - hw + k step, lo, hi), the "auto" branch
//     per (gene, point), no cache, the first minimum starting from
//     (center_g, +inf) (disp_scan_fine_launch).
// Both modes are one kernel; only the point set-up and the form choice
// differ.
//
// What bounds it on the H100: the instruction issue rate on the
// transcendentals. Each (gene, point, sample) costs two log1p and five IEEE
// divisions in the stable form (lgamma_st8's three logs and a division,
// plus a log1p or a log, in the plain forms): ~30-40 floating-point
// operations as the kernel table counts them, but a few hundred issued
// instructions, since a correctly rounded division or log1p is a sequence
// around one special-function-unit operation. The counts and mu (8 or 16
// bytes a sample) are reused by every point, so bytes do not bound it:
// the table's max(bytes, operations) bound (0.13 ms at 100 x 60000 f32, 32
// points) and the special-function units (~7 operations a sample and point,
// ~0.34 ms there at 16 a clock per SM) both sit below the issue rate.
//
// The design (PERF.md section 6, PR 7, says what it replaced and why):
//   - A block takes a tile of 32 genes (lane = gene) and W warps, warp w the
//     grid point w of the current group of W points (W = min(K, 32) for
//     P <= 2, at most 16 / 8 for wider designs, whose Gram takes more
//     registers). Each thread sums its own (gene, point) over the samples,
//     so no sum crosses lanes and nothing is shuffled.
//   - The per-point scalars (la, alpha, r, log r, lgamma r, the form) are
//     computed once per thread, and sym_logdet, the prior and the cache
//     store once per (gene, point). The cache store of a warp is one
//     coalesced row of 32 genes; the argmin is one pass per gene by warp 0
//     over the group's objectives in shared memory.
//   - The tile's counts and mu are staged into shared memory in chunks of
//     CH samples (128 f32, 64 f64), transposed with a padded row so that
//     lane = gene reads and the coalesced row-major writes are both free
//     of bank conflicts; the design rows of the chunk sit beside them and
//     are read as broadcasts. Every device-memory byte is read once per
//     point group (once for K = 32 at P <= 2) and reused by all its points.
//     Plain loads fill the chunk (TMA would need 16-byte aligned row
//     strides, which N does not give); the staging is a few percent of a
//     chunk's compute.
//   - The form is fixed per thread, so the sample loop is one form's code.
//     In the static mode it is the same for every lane of a warp; in the
//     fine mode it is per lane, so a warp whose genes straddle r = 8 runs
//     both forms, as the JAX auto branch computes both everywhere.
//   - Where the tiles leave the card underfilled (fewer than ~4 blocks per
//     SM), the rows are split over S segments of at least 32 samples
//     (gridDim.y): each block writes the sums of its segment to a float64
//     scratch buffer the wrapper allocates, and the last block of a tile to
//     finish (a counter per tile, after a fence) adds the S sums in segment
//     order and runs the epilogue. At 5000 genes x 10000 samples that is
//     157 tiles x 4 segments.
//   - No tensor cores: the Cox-Reid Gram sum_n W x_n x_n^T is a product,
//     but in f32 the tensor cores would run it in TF32, which the port's
//     precision rules forbid.
// Sum order, per (gene, point): the NB terms in index order into a float64
// sum, rounded once to the working type, as the plain version
// (ops/nb.py:_sum_f64) sums them; the terms are the plain version's own
// expressions, so float32 results agree to the last bit or nearly. (A
// float32 sum of a 10000-sample row, whose terms of ~4 cancel to a total of
// ~2, is off by ~3e-5 of the total in any order.) The Gram: samples in index
// order within a chunk, chunk sums added in chunk order, in the working
// type; with S > 1 each segment so, the segment sums added in float64 in
// segment order.
#include "common.cuh"

using namespace pdt;

namespace {

constexpr int TILE = 32;  // genes per block, one per lane
constexpr int TILE_PAD = TILE + 1;
enum Form { STABLE = 0, AUTO_PLAIN = 1, PLAIN = 2 };

template <typename T> struct Chunk {
  static constexpr int value = sizeof(T) == 4 ? 128 : 64;
};
// Warps (grid points) per block: the Gram's accumulators grow as P(P+1)/2,
// so wide designs take fewer threads and more registers each.
template <int P> struct WMax {
  static constexpr int value = P <= 2 ? 32 : (P <= 4 ? 16 : 8);
};

template <typename T>
__device__ __forceinline__ T stable_term(T y, T mu, T r) {
  const T u = y / r;
  const T v = mu / r;
  const T l1p_u = m_log1p(u);
  const T l1p_v = m_log1p(v);
  const T yr = y + r;
  return -r * (l1p_u - u) - (y - T(0.5)) * l1p_u + r * (l1p_v - v) + y * l1p_v +
         y / (T(12) * r * yr) + (T(1) / (yr * yr * yr) - T(1) / (r * r * r)) / T(360);
}

// One sample's centred NB term in form F (nb_nll_centered's "stable", the
// plain part of "auto", "plain").
template <int F, typename T>
__device__ __forceinline__ T nb_term(T yv, T mv, T r, T log_r, T lg_r) {
  if constexpr (F == STABLE) {
    return stable_term(yv, mv, r);
  } else if constexpr (F == AUTO_PLAIN) {
    const T yr = yv + r;
    return -r * log_r - lgamma_fast(yr) + lg_r + yr * (log_r + m_log1p(mv / r)) - mv;
  } else {
    return -r * log_r - lgamma_fast(yv + r) + lg_r + (yv + r) * m_log(mv + r) - mv;
  }
}

// One staged chunk of cnt samples for one (gene, point) in form F: the NB
// terms into the float64 sum, the Cox-Reid Gram into cgram. The form is
// fixed for the whole loop, so two samples' terms interleave.
template <int F, int P, typename T>
__device__ __forceinline__ void chunk_sums(int cnt, int lane, const T (*s_y)[TILE_PAD], const T (*s_m)[TILE_PAD],
                                           const T* s_x, T r, T alpha, T log_r, T lg_r,
                                           int cr_reg, double& acc, T* cgram) {
#pragma unroll 2
  for (int n = 0; n < cnt; ++n) {
    const T yv = s_y[n][lane];
    const T mv = s_m[n][lane];
    acc += (double)nb_term<F>(yv, mv, r, log_r, lg_r);
    if (cr_reg) {
      const T Wn = mv / (T(1) + mv * alpha);
      const T* xn = s_x + n * P;
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const T wp = Wn * xn[p];
#pragma unroll
        for (int q = p; q < P; ++q) cgram[tri_idx<P>(p, q)] += wp * xn[q];
      }
    }
  }
}

template <typename T> struct Grid {
  const T* la_grid;  // static mode: (K,)
  const T* center;   // fine mode: (G,)
  T hw, step, lo, hi;
  int K, bnd_start, bnd_end;
};

// log-alpha of point k for a gene whose centre is c (fine mode:
// jnp.clip(center - halfwidth + k * step, lo, hi), in that rounding order).
template <typename T>
__device__ __forceinline__ T point_la(const Grid<T>& gr, int k, T c) {
  if (gr.center == nullptr) return gr.la_grid[k];
  return m_min(m_max((c - gr.hw) + T(k) * gr.step, gr.lo), gr.hi);
}

// blockDim.x = 32 W: lane = gene of the tile, warp = grid point of the
// current group of W points.
template <int P, typename T>
__global__ void __launch_bounds__(TILE * WMax<P>::value)
    disp_scan_kernel(int G, int N, const T* __restrict__ counts, const T* __restrict__ mu,
                     const T* __restrict__ X, Grid<T> gr, T la_init, int cr_reg, int prior_reg,
                     const T* __restrict__ la_hat, const T* __restrict__ pdv_p,
                     double* __restrict__ partial, int* __restrict__ done,
                     T* __restrict__ best_la_out, T* __restrict__ coarse) {
  constexpr int CH = Chunk<T>::value;
  constexpr int NT = NTRI<P>;
  constexpr int NACC = 1 + NT;
  __shared__ T s_y[CH][TILE_PAD];
  __shared__ T s_m[CH][TILE_PAD];
  __shared__ T s_x[CH * P];
  __shared__ T s_f[WMax<P>::value][TILE];
  __shared__ int s_last;

  const int K = gr.K;
  const int S = gridDim.y;
  const int W = blockDim.x / TILE;
  const int tile = blockIdx.x;
  const int seg = blockIdx.y;
  const int lane = threadIdx.x & (WARP - 1);
  const int warp = threadIdx.x / WARP;
  const int g0 = tile * TILE;
  const int g = g0 + lane;
  const bool live = g < G;
  const bool fine = gr.center != nullptr;
  const int seg_len = (N + S - 1) / S;
  const int n_lo = min(N, seg * seg_len);
  const int n_hi = min(N, n_lo + seg_len);
  const T pdv = *pdv_p;
  const T lah = (prior_reg && live) ? la_hat[g] : T(0);
  const T ctr = (fine && live) ? gr.center[g] : T(0);
  const int ngroups = (K + W - 1) / W;

  // Warp 0 keeps the running strict first minimum of its lane's gene.
  T best_f = Lim<T>::inf();
  T best_la = fine ? ctr : la_init;

  // Epilogue of point k of group grp from its sums: the objective, its
  // cache row (32 genes, one store), then warp 0's argmin over the group's
  // points in order.
  auto finish = [&](int grp, int k, T la, double acc, const T* gram) {
    T f = (T)acc;
    if (cr_reg) f = f + T(0.5) * sym_logdet<T, P>(gram);
    if (prior_reg) {
      const T d = la - lah;
      f = f + d * d / (T(2) * pdv);
    }
    __syncthreads();  // the previous group's argmin has read s_f
    s_f[warp][lane] = f;
    if (coarse != nullptr && live && k < K) coarse[(size_t)k * G + g] = f;
    __syncthreads();
    if (warp == 0) {
      const int kn = min(W, K - grp * W);
      for (int kk = 0; kk < kn; ++kk) {
        const T fk = s_f[kk][lane];
        if (fk < best_f) {
          best_f = fk;
          best_la = point_la(gr, grp * W + kk, ctr);
        }
      }
    }
  };

  for (int grp = 0; grp < ngroups; ++grp) {
    // This thread's point: la, alpha, r, log r, lgamma r and the form.
    const int k = grp * W + warp;
    const int kc = min(k, K - 1);
    const T la = point_la(gr, kc, ctr);
    const T alpha = m_exp(la);
    const T r = T(1) / alpha;
    int form;
    if (fine) {
      form = r < T(R_SWITCH) ? AUTO_PLAIN : STABLE;
    } else {
      form = kc < gr.bnd_start ? STABLE
                               : (kc < gr.bnd_end ? (r < T(R_SWITCH) ? AUTO_PLAIN : STABLE) : PLAIN);
    }
    const T log_r = form == STABLE ? T(0) : m_log(r);
    const T lg_r = form == STABLE ? T(0) : m_lgamma(r);

    // The NB terms cancel to a total far below their sizes: they are summed
    // in float64 and rounded once, as the plain version sums them.
    double acc = 0.0;
    T gram[NT];
#pragma unroll
    for (int i = 0; i < NT; ++i) gram[i] = T(0);
    for (int c0 = n_lo; c0 < n_hi; c0 += CH) {
      const int cnt = min(CH, n_hi - c0);
      __syncthreads();  // the previous chunk is consumed
      for (int e = threadIdx.x; e < TILE * CH; e += blockDim.x) {
        const int gl = e / CH;
        const int n = e - gl * CH;
        if (n < cnt) {
          const int gg = g0 + gl;
          const bool ok = gg < G;
          s_y[n][gl] = ok ? counts[(size_t)gg * N + c0 + n] : T(0);
          s_m[n][gl] = ok ? mu[(size_t)gg * N + c0 + n] : T(1);
        }
      }
      if (cr_reg) {
        for (int e = threadIdx.x; e < cnt * P; e += blockDim.x) s_x[e] = X[(size_t)c0 * P + e];
      }
      __syncthreads();

      T cgram[NT];
#pragma unroll
      for (int i = 0; i < NT; ++i) cgram[i] = T(0);
      if (form == STABLE) {
        chunk_sums<STABLE, P, T>(cnt, lane, s_y, s_m, s_x, r, alpha, log_r, lg_r, cr_reg, acc, cgram);
      } else if (form == AUTO_PLAIN) {
        chunk_sums<AUTO_PLAIN, P, T>(cnt, lane, s_y, s_m, s_x, r, alpha, log_r, lg_r, cr_reg, acc, cgram);
      } else {
        chunk_sums<PLAIN, P, T>(cnt, lane, s_y, s_m, s_x, r, alpha, log_r, lg_r, cr_reg, acc, cgram);
      }
#pragma unroll
      for (int i = 0; i < NT; ++i) gram[i] += cgram[i];
    }

    if (S > 1) {
      if (k < K) {
        double* dst = partial + (((size_t)(tile * S + seg) * K + k) * NACC) * TILE + lane;
        dst[0] = acc;
#pragma unroll
        for (int i = 0; i < NT; ++i) dst[(size_t)(1 + i) * TILE] = (double)gram[i];
      }
      continue;
    }
    finish(grp, k, la, acc, gram);
  }

  if (S > 1) {
    // The last block of the tile to finish adds the segments' sums.
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) s_last = atomicAdd(done + tile, 1) == S - 1;
    __syncthreads();
    if (!s_last) return;
    __threadfence();
    for (int grp = 0; grp < ngroups; ++grp) {
      const int k = grp * W + warp;
      const int kc = min(k, K - 1);
      const T la = point_la(gr, kc, ctr);
      double acc = 0.0;
      double gsum[NT];
#pragma unroll
      for (int i = 0; i < NT; ++i) gsum[i] = 0.0;
      for (int s = 0; s < S; ++s) {
        const double* src = partial + (((size_t)(tile * S + s) * K + kc) * NACC) * TILE + lane;
        acc += __ldcg(src);
#pragma unroll
        for (int i = 0; i < NT; ++i) gsum[i] += __ldcg(src + (size_t)(1 + i) * TILE);
      }
      T gram[NT];
#pragma unroll
      for (int i = 0; i < NT; ++i) gram[i] = (T)gsum[i];
      finish(grp, k, la, acc, gram);
    }
  }
  if (warp == 0 && live) best_la_out[g] = best_la;
}

template <int P, typename T>
int launch(int G, int N, const void* counts, const void* mu, const void* X, Grid<T> gr,
           double la_init, int cr_reg, int prior_reg, const void* la_hat, const void* pdv,
           int segments, void* partial, void* done, void* best_la, void* coarse,
           cudaStream_t s) {
  if (segments < 1 || (segments > 1 && (partial == nullptr || done == nullptr)))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((G + TILE - 1) / TILE), (unsigned)segments);
  const int warps = gr.K < WMax<P>::value ? gr.K : WMax<P>::value;
  disp_scan_kernel<P, T><<<grid, TILE * warps, 0, s>>>(
      G, N, (const T*)counts, (const T*)mu, (const T*)X, gr, (T)la_init, cr_reg, prior_reg,
      (const T*)la_hat, (const T*)pdv, (double*)partial, (int*)done, (T*)best_la, (T*)coarse);
  return 0;
}

template <typename T>
int dispatch(int P, int G, int N, const void* counts, const void* mu, const void* X,
             Grid<T> gr, double la_init, int cr_reg, int prior_reg, const void* la_hat,
             const void* pdv, int segments, void* partial, void* done, void* best_la,
             void* coarse, cudaStream_t s) {
  int rc = 0;
  PDT_DISPATCH_P(P, rc = launch<PP, T>(G, N, counts, mu, X, gr, la_init, cr_reg, prior_reg,
                                       la_hat, pdv, segments, partial, done, best_la, coarse,
                                       s));
  return rc;
}

}  // namespace

// The static grid: best_la (G,) and the (K, G) objective cache.
extern "C" int disp_scan_launch(int is_f64, int P, int G, int N, const void* counts,
                                const void* mu, const void* X, const void* la_grid, int K,
                                int bnd_start, int bnd_end, double la_init, int cr_reg,
                                int prior_reg, const void* la_hat, const void* pdv,
                                int segments, void* partial, void* done, void* best_la,
                                void* coarse, void* stream) {
  if (G <= 0) return (int)cudaSuccess;
  if (K <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int rc;
  if (is_f64) {
    const Grid<double> gr{(const double*)la_grid, nullptr, 0.0, 0.0, 0.0, 0.0, K, bnd_start, bnd_end};
    rc = dispatch<double>(P, G, N, counts, mu, X, gr, la_init, cr_reg, prior_reg, la_hat, pdv,
                          segments, partial, done, best_la, coarse, s);
  } else {
    const Grid<float> gr{(const float*)la_grid, nullptr, 0.f, 0.f, 0.f, 0.f, K, bnd_start, bnd_end};
    rc = dispatch<float>(P, G, N, counts, mu, X, gr, la_init, cr_reg, prior_reg, la_hat, pdv,
                         segments, partial, done, best_la, coarse, s);
  }
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}

// The fine scan: K per-gene points clip(center - halfwidth + k step, lo, hi),
// best_la (G,) only.
extern "C" int disp_scan_fine_launch(int is_f64, int P, int G, int N, const void* counts,
                                     const void* mu, const void* X, const void* center,
                                     double halfwidth, double step, double lo, double hi,
                                     int K, int cr_reg, int prior_reg, const void* la_hat,
                                     const void* pdv, int segments, void* partial, void* done,
                                     void* best_la, void* stream) {
  if (G <= 0) return (int)cudaSuccess;
  if (K <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int rc;
  if (is_f64) {
    const Grid<double> gr{nullptr, (const double*)center, halfwidth, step, lo, hi, K, 0, 0};
    rc = dispatch<double>(P, G, N, counts, mu, X, gr, 0.0, cr_reg, prior_reg, la_hat, pdv,
                          segments, partial, done, best_la, nullptr, s);
  } else {
    const Grid<float> gr{nullptr, (const float*)center, (float)halfwidth, (float)step,
                         (float)lo, (float)hi, K, 0, 0};
    rc = dispatch<float>(P, G, N, counts, mu, X, gr, 0.0, cr_reg, prior_reg, la_hat, pdv,
                         segments, partial, done, best_la, nullptr, s);
  }
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}
