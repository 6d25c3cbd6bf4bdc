// Coarse-to-fine 2-D grid searches for P == 2 designs, one block per
// selected lane: grid_nb and grid_apeglm.
//
// grid_nb replaces grid_fit_beta_batch (pydeseq2_tpu/ops/irls.py:375), the
// last IRLS rescue tier: the full NB NLL (ops/nb.py:84, lgamma terms and the
// r < 8 branch switch included) plus 0.5e-6 |beta|^2 at 60 x 60 points of
// [-30, 30]^2, then at 60 x 60 points of a per-lane fine grid of half-width
// one coarse step around the coarse winner. grid_apeglm replaces
// grid_fit_shrink_beta_batch (pydeseq2_tpu/ops/shrink.py:258), the same two
// passes on the apeGLM objective scaled by the caller's per-lane constant.
//
// A block stages its lane's counts, design rows and the per-sample terms
// that do not depend on beta through shared memory, CHUNK samples at a time,
// so any number of samples fits (for the NB NLL the lgamma-bearing part of
// either branch, each hoisted whole as the leading subexpression, so its
// rounding is the plain version's). Each thread holds the running sums of up
// to RPW x CPL grid points (its warp's rows, its lane's columns) and adds the
// chunk's samples to each in sample order, so every point's sum runs over
// n = 0 .. N-1 in order whatever the chunking. A grid wider than 64 points
// takes several 64 x 64 tiles. Each row ends in a warp argmin with
// jnp.argmin's rule (first minimum, a NaN wins), and the rows are combined
// as the JAX code combines them:
// - grid_nb's coarse pass is one flat argmin over the x-major grid, so the
//   rows combine by the same rule (a NaN anywhere wins);
// - grid_nb's fine pass and both grid_apeglm passes keep a row only where
//   its minimum is strictly below the best so far, which starts at +inf:
//   a row whose argmin is NaN never enters, and ties go to the earlier row.
// Lanes the caller does not select do nothing and get NaN.
//
// Bound on the H100: 7200 objective evaluations of N samples per selected
// lane (~40 operations and 3 transcendentals each); at 1-2 lanes the launch
// and the 60-row serial dependence inside a block set the time.
#include "common.cuh"

using namespace pdt;

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / WARP;
constexpr int NONE = 0x7fffffff;
constexpr int CHUNK = 512;          // samples staged in shared memory at a time
constexpr int RPW = 8;              // grid rows a warp holds per tile
constexpr int CPL = 2;              // grid columns a lane holds per tile
constexpr int TILE_R = WARPS * RPW;  // 64
constexpr int TILE_C = WARP * CPL;   // 64

enum Rule { FLAT = 0, ROWS = 1 };

// A grid candidate (value, flat index) and jnp.argmin's order on them: a
// NaN comes first (the lowest index among NaNs), then the smaller value,
// then the lower index. It is a total order, so any reduction tree gives
// the same winner.
template <typename T> struct Cand {
  T v;
  int i;
};
template <typename T> __device__ __forceinline__ bool argmin_before(Cand<T> a, Cand<T> b) {
  const bool an = a.v != a.v, bn = b.v != b.v;
  if (an != bn) return an;
  if (!an && a.v != b.v) return a.v < b.v;
  return a.i < b.i;
}
template <typename T> __device__ __forceinline__ Cand<T> warp_argmin(Cand<T> c) {
#pragma unroll
  for (int o = WARP / 2; o > 0; o >>= 1) {
    Cand<T> other{__shfl_xor_sync(FULL, c.v, o), __shfl_xor_sync(FULL, c.i, o)};
    if (argmin_before(other, c)) c = other;
  }
  return c;
}

// The NB objective of one lane: its inputs, and the staged chunk (ARRAYS
// arrays of CHUNK samples: y, sf, x0, x1, the hoisted lead term, y + r, and
// the two Stirling corrections of the stable branch).
template <typename T> struct NbLane {
  static constexpr int ARRAYS = 8;
  const T *row, *sf, *X;
  T* sm;
  T r, min_mu;
  bool plain;

  __device__ void stage(int n0, int m) const {
    for (int i = threadIdx.x; i < m; i += THREADS) {
      const int n = n0 + i;
      const T yv = row[n];
      const T lgy1 = m_lgamma(yv + T(1));
      const T yr = yv + r;
      sm[i] = yv;
      sm[CHUNK + i] = sf[n];
      sm[2 * CHUNK + i] = X[2 * n];
      sm[3 * CHUNK + i] = X[2 * n + 1];
      sm[5 * CHUNK + i] = yr;
      if (plain) {
        // -r log r - logbinom, logbinom = lgamma(y + r) - lgamma(y + 1) - lgamma(r)
        const T logbinom = (m_lgamma(yr) - lgy1) - m_lgamma(r);
        sm[4 * CHUNK + i] = (-r) * m_log(r) - logbinom;
        sm[6 * CHUNK + i] = T(0);
        sm[7 * CHUNK + i] = T(0);
      } else {
        const T l1y = m_log1p(yv / r);
        sm[4 * CHUNK + i] = (lgy1 + yv) - (yr - T(0.5)) * l1y;
        sm[6 * CHUNK + i] = yv / ((T(12) * r) * yr);
        sm[7 * CHUNK + i] = (T(1) / ((yr * yr) * yr) - T(1) / ((r * r) * r)) / T(360);
      }
    }
  }

  // nb_nll's term of staged sample i at (bx, by), irls.py:393-401.
  __device__ __forceinline__ T term(int i, T bx, T by) const {
    const T xb = bx * sm[2 * CHUNK + i] + by * sm[3 * CHUNK + i];
    const T mu = m_max(sm[CHUNK + i] * m_exp(xb), min_mu);
    const T yv = sm[i];
    const T ylogmu = yv > T(0) ? yv * m_log(mu) : T(0);
    if (plain) return (sm[4 * CHUNK + i] + sm[5 * CHUNK + i] * m_log(mu + r)) - ylogmu;
    return (((sm[4 * CHUNK + i] + sm[5 * CHUNK + i] * m_log1p(mu / r)) - ylogmu) + sm[6 * CHUNK + i]) +
           sm[7 * CHUNK + i];
  }

  // nb_nll + 0.5 * (1e-6 x^2 + 1e-6 y^2) (coarse) or + 0.5e-6 (x^2 + y^2)
  // (fine), irls.py:393-401 and :418-427.
  __device__ __forceinline__ T finish(T acc, T bx, T by, bool coarse) const {
    const T reg = coarse ? T(0.5) * (T(1e-6) * (bx * bx) + T(1e-6) * (by * by))
                         : T(0.5e-6) * (bx * bx + by * by);
    return acc + reg;
  }
};

// The scaled apeGLM objective of one lane; the staged chunk holds y, the
// offset, x0, x1 and y + size.
template <typename T> struct ApeLane {
  static constexpr int ARRAYS = 5;
  const T *row, *offset, *X;
  T* sm;
  T s, log_s, pns2x2, ps, cnst;
  int shrink_index;

  __device__ void stage(int n0, int m) const {
    for (int i = threadIdx.x; i < m; i += THREADS) {
      const int n = n0 + i;
      const T yv = row[n];
      sm[i] = yv;
      sm[CHUNK + i] = offset[n];
      sm[2 * CHUNK + i] = X[2 * n];
      sm[3 * CHUNK + i] = X[2 * n + 1];
      sm[4 * CHUNK + i] = yv + s;
    }
  }

  __device__ __forceinline__ T term(int i, T bx, T by) const {
    const T xb = bx * sm[2 * CHUNK + i] + by * sm[3 * CHUNK + i];
    return apeglm_ll_term(sm[i], sm[4 * CHUNK + i], xb, sm[CHUNK + i], log_s);
  }

  // nbinom_fn_batch(beta = (bx, by)) / cnst, shrink.py:23-53 and :281-292.
  __device__ __forceinline__ T finish(T ll, T bx, T by, bool) const {
    const T vx = shrink_index == 0 ? bx * T(0) : bx;
    const T vy = shrink_index == 1 ? by * T(0) : by;
    const T q = (shrink_index == 0 ? bx : by) / ps;
    const T prior = (vx * vx + vy * vy) / pns2x2 + m_log1p(q * q);
    return (prior - ll) / cnst;
  }
};

// One pass over the L x L grid (x_k = xg[k] + xs, y_j = yg[j] + ys):
// returns the winning flat index k * L + j, or NONE where no row entered.
// Every thread of the block calls it (it stages chunks and synchronises).
template <typename T, typename Lane>
__device__ int grid_pass(const Lane& c, int N, const T* __restrict__ xg, const T* __restrict__ yg,
                         T xs, T ys, int L, bool coarse, Rule rule, Cand<T>* scratch) {
  const int warp = threadIdx.x / WARP;
  const int lane = threadIdx.x & (WARP - 1);
  Cand<T> best{Lim<T>::inf(), NONE};
  for (int k0 = 0; k0 < L; k0 += TILE_R) {
    Cand<T> row[RPW];
    T bx[RPW];
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const int k = k0 + warp + r * WARPS;
      row[r] = Cand<T>{Lim<T>::inf(), NONE};
      bx[r] = k < L ? xs + xg[k] : T(0);
    }
    for (int j0 = 0; j0 < L; j0 += TILE_C) {
      T by[CPL], acc[RPW][CPL];
#pragma unroll
      for (int q = 0; q < CPL; ++q) {
        const int j = j0 + lane + q * WARP;
        by[q] = j < L ? ys + yg[j] : T(0);
#pragma unroll
        for (int r = 0; r < RPW; ++r) acc[r][q] = T(0);
      }
      for (int n0 = 0; n0 < N; n0 += CHUNK) {
        const int m = min(CHUNK, N - n0);
        __syncthreads();  // the previous chunk is no longer read
        c.stage(n0, m);
        __syncthreads();
        for (int i = 0; i < m; ++i) {
#pragma unroll
          for (int r = 0; r < RPW; ++r) {
            if (k0 + warp + r * WARPS >= L) continue;
#pragma unroll
            for (int q = 0; q < CPL; ++q)
              if (j0 + lane + q * WARP < L) acc[r][q] += c.term(i, bx[r], by[q]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        const int k = k0 + warp + r * WARPS;
#pragma unroll
        for (int q = 0; q < CPL; ++q) {
          const int j = j0 + lane + q * WARP;
          if (k >= L || j >= L) continue;
          Cand<T> o{c.finish(acc[r][q], bx[r], by[q], coarse), k * L + j};
          if (argmin_before(o, row[r])) row[r] = o;
        }
      }
    }
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const Cand<T> rc = warp_argmin(row[r]);  // the row's jnp.argmin
      const bool enters = rule == FLAT || (rc.v == rc.v && rc.v < Lim<T>::inf());
      if (k0 + warp + r * WARPS < L && enters && argmin_before(rc, best)) best = rc;
    }
  }
  if (lane == 0) scratch[warp] = best;
  __syncthreads();
  Cand<T> out = scratch[0];
  for (int w = 1; w < WARPS; ++w)
    if (argmin_before(scratch[w], out)) out = scratch[w];
  __syncthreads();
  return out.i;
}

template <typename T, typename Lane>
__device__ void two_passes(const Lane& c, int N, const T* __restrict__ base,
                           const T* __restrict__ offs, int L, bool nb, Cand<T>* scratch,
                           T* out) {
  // Coarse: the flat argmin (grid_nb) or the row rule from (0, 0) (apeGLM).
  const int ic = grid_pass<T>(c, N, base, base, T(0), T(0), L, true, nb ? FLAT : ROWS, scratch);
  T bx = T(0), by = T(0);
  if (ic != NONE) {
    bx = base[ic / L];
    by = base[ic % L];
  }
  // Fine: the row rule around the coarse winner; grid_nb keeps the coarse
  // winner where no row enters, the apeGLM search starts again from (0, 0).
  const int jf = grid_pass<T>(c, N, offs, offs, bx, by, L, false, ROWS, scratch);
  T fx = nb ? bx : T(0), fy = nb ? by : T(0);
  if (jf != NONE) {
    fx = bx + offs[jf / L];
    fy = by + offs[jf % L];
  }
  if (threadIdx.x == 0) {
    out[0] = fx;
    out[1] = fy;
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    grid_nb_kernel(int N, const T* __restrict__ counts, const T* __restrict__ sf,
                   const T* __restrict__ X, const T* __restrict__ disp,
                   const unsigned char* __restrict__ sel, const T* __restrict__ base,
                   const T* __restrict__ offs, int L, T min_mu, T* __restrict__ beta_out) {
  const int gi = blockIdx.x;
  T* out = beta_out + (size_t)gi * 2;
  if (sel != nullptr && !sel[gi]) {
    if (threadIdx.x < 2) out[threadIdx.x] = T(NAN);
    return;
  }
  __shared__ T sm[NbLane<T>::ARRAYS * CHUNK];
  __shared__ Cand<T> scratch[WARPS];
  NbLane<T> c;
  c.row = counts + (size_t)gi * N;
  c.sf = sf;
  c.X = X;
  c.sm = sm;
  c.r = T(1) / disp[gi];
  c.min_mu = min_mu;
  c.plain = c.r < T(R_SWITCH);
  two_passes<T>(c, N, base, offs, L, true, scratch, out);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    grid_apeglm_kernel(int N, const T* __restrict__ counts, const T* __restrict__ offset,
                       const T* __restrict__ X, const T* __restrict__ size,
                       const T* __restrict__ cnst, const unsigned char* __restrict__ sel,
                       const T* __restrict__ base, const T* __restrict__ offs, int L, T pns,
                       T ps, int shrink_index, T* __restrict__ beta_out) {
  const int gi = blockIdx.x;
  T* out = beta_out + (size_t)gi * 2;
  if (sel != nullptr && !sel[gi]) {
    if (threadIdx.x < 2) out[threadIdx.x] = T(NAN);
    return;
  }
  __shared__ T sm[ApeLane<T>::ARRAYS * CHUNK];
  __shared__ Cand<T> scratch[WARPS];
  ApeLane<T> c;
  c.row = counts + (size_t)gi * N;
  c.offset = offset;
  c.X = X;
  c.sm = sm;
  c.s = size[gi];
  c.log_s = m_log(c.s);
  c.pns2x2 = T(2) * (pns * pns);
  c.ps = ps;
  c.cnst = cnst[gi];
  c.shrink_index = shrink_index;
  two_passes<T>(c, N, base, offs, L, false, scratch, out);
}

template <typename T>
void launch_nb(int K, int N, const void* counts, const void* sf, const void* X, const void* disp,
               const void* sel, const void* base, const void* offs, int L, double min_mu,
               void* beta_out, cudaStream_t s) {
  grid_nb_kernel<T><<<K, THREADS, 0, s>>>(N, (const T*)counts, (const T*)sf, (const T*)X,
                                          (const T*)disp, (const unsigned char*)sel,
                                          (const T*)base, (const T*)offs, L, (T)min_mu,
                                          (T*)beta_out);
}

template <typename T>
void launch_ape(int K, int N, const void* counts, const void* offset, const void* X,
                const void* size, const void* cnst, const void* sel, const void* base,
                const void* offs, int L, double pns, double ps, int shrink_index, void* beta_out,
                cudaStream_t s) {
  grid_apeglm_kernel<T><<<K, THREADS, 0, s>>>(
      N, (const T*)counts, (const T*)offset, (const T*)X, (const T*)size, (const T*)cnst,
      (const unsigned char*)sel, (const T*)base, (const T*)offs, L, (T)pns, (T)ps, shrink_index,
      (T*)beta_out);
}

}  // namespace

extern "C" int grid_nb_launch(int is_f64, int K, int N, const void* counts, const void* sf,
                              const void* X, const void* disp, const void* sel, const void* base,
                              const void* offs, int L, double min_mu, void* beta_out,
                              void* stream) {
  if (K <= 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_f64)
    launch_nb<double>(K, N, counts, sf, X, disp, sel, base, offs, L, min_mu, beta_out, s);
  else
    launch_nb<float>(K, N, counts, sf, X, disp, sel, base, offs, L, min_mu, beta_out, s);
  return (int)cudaGetLastError();
}

extern "C" int grid_apeglm_launch(int is_f64, int K, int N, const void* counts,
                                  const void* offset, const void* X, const void* size,
                                  const void* cnst, const void* sel, const void* base,
                                  const void* offs, int L, double pns, double ps,
                                  int shrink_index, void* beta_out, void* stream) {
  if (K <= 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_f64)
    launch_ape<double>(K, N, counts, offset, X, size, cnst, sel, base, offs, L, pns, ps,
                       shrink_index, beta_out, s);
  else
    launch_ape<float>(K, N, counts, offset, X, size, cnst, sel, base, offs, L, pns, ps,
                      shrink_index, beta_out, s);
  return (int)cudaGetLastError();
}
