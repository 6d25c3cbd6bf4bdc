// Coarse-to-fine 2-D grid searches for P == 2 designs: grid_nb (one block
// per selected lane) and grid_apeglm (a thread-block cluster per selected
// lane).
//
// grid_nb replaces grid_fit_beta_batch (pydeseq2_tpu/ops/irls.py:375), the
// last IRLS rescue tier: the full NB NLL (ops/nb.py:84, lgamma terms and the
// r < 8 branch switch included) plus 0.5e-6 |beta|^2 at 60 x 60 points of
// [-30, 30]^2, then at 60 x 60 points of a per-lane fine grid of half-width
// one coarse step around the coarse winner. grid_apeglm replaces
// grid_fit_shrink_beta_batch (pydeseq2_tpu/ops/shrink.py:258), the same two
// passes on the apeGLM objective scaled by the caller's per-lane constant.
//
// grid_nb: a block stages its lane's counts, design rows and the per-sample
// terms that do not depend on beta through shared memory, CHUNK samples at a
// time, so any number of samples fits (for the NB NLL the lgamma-bearing
// part of either branch, each hoisted whole as the leading subexpression, so
// its rounding is the plain version's). Each thread holds the running sums
// of up to RPW x CPL grid points (its warp's rows, its lane's columns) and
// adds the chunk's samples to each in sample order, so every point's sum
// runs over n = 0 .. N-1 in order whatever the chunking. A grid wider than
// 64 points takes several 64 x 64 tiles.
//
// grid_apeglm: a cluster of K <= 16 blocks takes one selected lane, block
// rank q the grid rows [q L / K, (q + 1) L / K) of both passes, so that 1-16
// lanes still fill the card and a large selection splits into blocks small
// enough to leave no mostly idle second wave (ops/shrink.py:_grid_plan picks
// K and the chunk from the number of lanes and N). A block stages a chunk of
// the lane's samples sorted by design row, each class in sample order:
// - x1 = 0 (the reference group of an intercept-plus-indicator design): the
//   term does not depend on the column's by, since bx x0 + by 0 is bx x0,
//   so it is computed once per (row, sample) and added to the row's points;
// - x0 = 0: once per (column, sample);
// - every other sample at every point.
// The work of a chunk, (points, row or column totals) x samples of each
// class, is cut into items of about equal size, a point's slice of its
// class's samples, spread over the block's threads; each item sums its terms
// in float64 and the slices are added in slice order, so a point's total is
// the same on every run. A point's objective rounds the float64 total once.
//
// In both kernels each row ends in a warp argmin with jnp.argmin's rule
// (first minimum, a NaN wins), and the rows are combined as the JAX code
// combines them:
// - grid_nb's coarse pass is one flat argmin over the x-major grid, so the
//   rows combine by the same rule (a NaN anywhere wins);
// - grid_nb's fine pass and both grid_apeglm passes keep a row only where
//   its minimum is strictly below the best so far, which starts at +inf:
//   a row whose argmin is NaN never enters, and ties go to the earlier row.
//   That is the first row of least value among the rows whose minimum is
//   below +inf, so grid_apeglm's blocks each publish their best such row
//   and, after a cluster barrier, every block reads the K candidates
//   through distributed shared memory and picks the same winner.
// Lanes the caller does not select do nothing and get NaN.
//
// Bound on the H100: 7200 objective evaluations of N samples per selected
// lane (~40 operations and 3 transcendentals each); the precise expf and
// log1pf of jnp.logaddexp in every apeGLM term make it an issue-rate bound
// (PERF.md section 6 gives the SASS count). At 1-2 lanes grid_nb's launch
// and its 60-row serial dependence inside a block set its time.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

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
                           const T* __restrict__ offs, int L, Cand<T>* scratch, T* out) {
  // Coarse: the flat argmin over the x-major grid.
  const int ic = grid_pass<T>(c, N, base, base, T(0), T(0), L, true, FLAT, scratch);
  T bx = T(0), by = T(0);
  if (ic != NONE) {
    bx = base[ic / L];
    by = base[ic % L];
  }
  // Fine: the row rule around the coarse winner, which stays where no row
  // enters.
  const int jf = grid_pass<T>(c, N, offs, offs, bx, by, L, false, ROWS, scratch);
  T fx = bx, fy = by;
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
  two_passes<T>(c, N, base, offs, L, scratch, out);
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


// ---- grid_apeglm ------------------------------------------------------------
constexpr int AG_THREADS = 256;
constexpr int AG_WARPS = AG_THREADS / WARP;
// Sample classes by design row: the term needs bx alone (x1 = 0), by alone
// (x0 = 0), or both.
constexpr int CLS_A = 0, CLS_B = 1, CLS_C = 2;

template <typename T> struct ApeArgs {
  int N, L, chunk, shrink_index;
  const T* counts;
  const T* offset;
  const T* X;
  const T* size;
  const T* cnst;
  const unsigned char* sel;
  const T* base;
  const T* offs;
  T pns, ps;
  T* beta_out;
};

// The first grid row of block rank q of K (ops/shrink.py:_grid_rows).
__host__ __device__ constexpr int ag_row0(int q, int L, int K) { return (int)(((long long)q * L) / K); }

// Dynamic shared memory of one block (ops/shrink.py:_grid_smem_bytes
// repeats it): float64 totals of its points (R L), rows (R) and columns (L),
// R = ceil(L / K); float64 slice partials of the three classes (3 x
// AG_THREADS); the warps' class counts and the winner (ints); the two
// published candidates and the warps' (16 bytes each); the staged chunk (y,
// offset, x0, x1, y + size).
__host__ __device__ constexpr size_t ag_smem_bytes(int L, int K, int chunk, int isz) {
  return 8 * ((size_t)((L + K - 1) / K) * L + (L + K - 1) / K + L + 3 * AG_THREADS) +
         align16(4 * (3 * AG_WARPS + 1)) + 16 * (2 + AG_WARPS) + 5 * (size_t)chunk * isz;
}

template <typename T> struct AgSmem {
  double* tot;  // the points' totals, then the rows', then the columns'
  double* scr;  // [3][AG_THREADS] slice partials
  int* cnt;     // [AG_WARPS][3] class counts, then the winner
  Cand<T>* pub;    // [2]: the block's candidate of each pass, read by the cluster
  Cand<T>* wbest;  // [AG_WARPS]
  T *y, *off, *x0, *x1, *ys;
};

template <typename T> __device__ __forceinline__ int ag_class(T x0, T x1) {
  return x1 == T(0) ? CLS_A : (x0 == T(0) ? CLS_B : CLS_C);
}

// Stage samples n0 .. n0 + m - 1 of the lane, class A first, then B, then
// C, each in sample order: thread t classifies the V consecutive samples
// from t V, and a scan over the warps places them. n[k] gets class k's size.
template <typename T>
__device__ void ag_stage(const ApeArgs<T>& a, const T* __restrict__ row, T s, int n0, int m, int V,
                         const AgSmem<T>& sm, int n[3]) {
  const int tid = threadIdx.x, warp = tid / WARP, lane = tid & (WARP - 1);
  const int i0 = min(m, tid * V), i1 = min(m, i0 + V);
  const T* X = a.X + 2 * (size_t)n0;
  int c[3] = {0, 0, 0};
  for (int i = i0; i < i1; ++i) {
    const int k = ag_class(X[2 * i], X[2 * i + 1]);
    c[0] += k == CLS_A;
    c[1] += k == CLS_B;
    c[2] += k == CLS_C;
  }
  int pos[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    int v = c[k];
#pragma unroll
    for (int o = 1; o < WARP; o <<= 1) {
      const int u = __shfl_up_sync(FULL, v, o);
      if (lane >= o) v += u;
    }
    pos[k] = v - c[k];
    if (lane == WARP - 1) sm.cnt[warp * 3 + k] = v;
  }
  __syncthreads();
  int start = 0;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    int before = 0, total = 0;
    for (int w = 0; w < AG_WARPS; ++w) {
      const int x = sm.cnt[w * 3 + k];
      before += w < warp ? x : 0;
      total += x;
    }
    pos[k] += start + before;
    n[k] = total;
    start += total;
  }
  for (int i = i0; i < i1; ++i) {
    const T x0 = X[2 * i], x1 = X[2 * i + 1];
    const int k = ag_class(x0, x1);
    const int p = k == CLS_A ? pos[0]++ : (k == CLS_B ? pos[1]++ : pos[2]++);
    const T yv = row[n0 + i];
    sm.y[p] = yv;
    sm.off[p] = a.offset[n0 + i];
    sm.x0[p] = x0;
    sm.x1[p] = x1;
    sm.ys[p] = yv + s;
  }
}

// Slices of a class of n samples over pts totals, about tau terms an item;
// more than one only where pts x slices fits one scratch row.
__device__ __forceinline__ int ag_slices(int n, long long tau, int pts) {
  if (n == 0 || pts == 0) return 0;
  return (int)min((n + tau - 1) / tau, (long long)max(1, AG_THREADS / pts));
}

// nbinom_fn_batch(beta = (bx, by)) / cnst, shrink.py:23-53 and :281-292,
// from the log-likelihood ll.
template <typename T>
__device__ __forceinline__ T ag_finish(const ApeArgs<T>& a, T pns2x2, T cnst, T ll, T bx, T by) {
  const T vx = a.shrink_index == 0 ? bx * T(0) : bx;
  const T vy = a.shrink_index == 1 ? by * T(0) : by;
  const T q = (a.shrink_index == 0 ? bx : by) / a.ps;
  const T prior = (vx * vx + vy * vy) / pns2x2 + m_log1p(q * q);
  return (prior - ll) / cnst;
}

// One pass of the cluster over the L x L grid (x_k = xg[k] + xs, y_j = yg[j]
// + ys0), this block over rows k0 .. k0 + Rb - 1: the winning flat index k L
// + j, or NONE where no row entered; every block of the cluster returns the
// same. `pub` is this pass's published candidate.
template <typename T>
__device__ int ag_pass(const ApeArgs<T>& a, cg::cluster_group& cluster, const T* __restrict__ row, T s, T log_s,
                       T pns2x2, T cnst, const T* __restrict__ xg, const T* __restrict__ yg, T xs, T ys0, int k0,
                       int Rb, const AgSmem<T>& sm, Cand<T>* pub) {
  const int tid = threadIdx.x, warp = tid / WARP, lane = tid & (WARP - 1);
  const int L = a.L, P = Rb * L, V = a.chunk / AG_THREADS;
  double* totC = sm.tot;
  double* totA = totC + P;
  double* totB = totA + Rb;
  for (int q = tid; q < P + Rb + L; q += AG_THREADS) totC[q] = 0.0;
  for (int n0 = 0; n0 < a.N; n0 += a.chunk) {
    const int m = min(a.chunk, a.N - n0);
    __syncthreads();  // the previous chunk is no longer read, the totals are zeroed
    int n[3];
    ag_stage<T>(a, row, s, n0, m, V, sm, n);
    __syncthreads();
    const long long W = (long long)P * n[CLS_C] + (long long)Rb * n[CLS_A] + (long long)L * n[CLS_B];
    const long long tau = max(1LL, (W + AG_THREADS - 1) / AG_THREADS);
    const int SA = ag_slices(n[CLS_A], tau, Rb), SB = ag_slices(n[CLS_B], tau, L), SC = ag_slices(n[CLS_C], tau, P);
    const int iC = P * SC, iA = iC + Rb * SA, iB = iA + L * SB;
    for (int it = tid; it < iB; it += AG_THREADS) {
      double acc = 0.0;
      if (it < iC) {
        const int p = it % P, sl = it / P;
        const int len = (n[CLS_C] + SC - 1) / SC, first = n[CLS_A] + n[CLS_B];
        const int lo = first + sl * len, hi = first + min(n[CLS_C], (sl + 1) * len);
        const int r = p / L;
        const T bx = xs + xg[k0 + r], by = ys0 + yg[p - r * L];
#pragma unroll 4
        for (int i = lo; i < hi; ++i)
          acc += (double)apeglm_ll_term(sm.y[i], sm.ys[i], bx * sm.x0[i] + by * sm.x1[i], sm.off[i], log_s);
        if (SC == 1) totC[p] += acc;
        else sm.scr[2 * AG_THREADS + it] = acc;
      } else if (it < iA) {
        const int e = it - iC, p = e % Rb, sl = e / Rb;
        const int len = (n[CLS_A] + SA - 1) / SA;
        const int lo = sl * len, hi = min(n[CLS_A], (sl + 1) * len);
        const T bx = xs + xg[k0 + p];
#pragma unroll 4
        for (int i = lo; i < hi; ++i) acc += (double)apeglm_ll_term(sm.y[i], sm.ys[i], bx * sm.x0[i], sm.off[i], log_s);
        if (SA == 1) totA[p] += acc;
        else sm.scr[e] = acc;
      } else {
        const int e = it - iA, p = e % L, sl = e / L;
        const int len = (n[CLS_B] + SB - 1) / SB, first = n[CLS_A];
        const int lo = first + sl * len, hi = first + min(n[CLS_B], (sl + 1) * len);
        const T by = ys0 + yg[p];
#pragma unroll 4
        for (int i = lo; i < hi; ++i) acc += (double)apeglm_ll_term(sm.y[i], sm.ys[i], by * sm.x1[i], sm.off[i], log_s);
        if (SB == 1) totB[p] += acc;
        else sm.scr[AG_THREADS + e] = acc;
      }
    }
    __syncthreads();
    // the sliced classes' partials, in slice order
    for (int q = tid; q < P + Rb + L; q += AG_THREADS) {
      int p = q, S = SC, pts = P;
      const double* part = sm.scr + 2 * AG_THREADS;
      if (q >= P + Rb) {
        p = q - P - Rb, S = SB, pts = L;
        part = sm.scr + AG_THREADS;
      } else if (q >= P) {
        p = q - P, S = SA, pts = Rb;
        part = sm.scr;
      }
      if (S > 1) {
        double d = totC[q];
        for (int k = 0; k < S; ++k) d += part[k * pts + p];
        totC[q] = d;
      }
    }
  }
  __syncthreads();
  // Each row's jnp.argmin; the block's first row of least value among those
  // below +inf.
  Cand<T> wb{Lim<T>::inf(), NONE};
  for (int r = warp; r < Rb; r += AG_WARPS) {
    const int k = k0 + r;
    const T bx = xs + xg[k];
    Cand<T> best{Lim<T>::inf(), NONE};
    for (int j = lane; j < L; j += WARP) {
      const T ll = (T)((totA[r] + totB[j]) + totC[r * L + j]);
      const Cand<T> o{ag_finish(a, pns2x2, cnst, ll, bx, ys0 + yg[j]), k * L + j};
      if (argmin_before(o, best)) best = o;
    }
    best = warp_argmin(best);
    if (best.v == best.v && best.v < Lim<T>::inf() && argmin_before(best, wb)) wb = best;
  }
  if (lane == 0) sm.wbest[warp] = wb;
  __syncthreads();
  if (tid == 0) {
    Cand<T> b = sm.wbest[0];
    for (int w = 1; w < AG_WARPS; ++w)
      if (argmin_before(sm.wbest[w], b)) b = sm.wbest[w];
    *pub = b;
  }
  cluster.sync();  // every block's candidate of this pass is visible
  if (warp == 0) {
    const int K = (int)cluster.num_blocks();
    Cand<T> b{Lim<T>::inf(), NONE};
    if (lane < K) b = *cluster.map_shared_rank(pub, (unsigned)lane);
    b = warp_argmin(b);
    if (lane == 0) sm.cnt[3 * AG_WARPS] = b.i;
  }
  __syncthreads();
  return sm.cnt[3 * AG_WARPS];
}

template <typename T>
__global__ void __launch_bounds__(AG_THREADS) grid_apeglm_kernel(const ApeArgs<T> a) {
  cg::cluster_group cluster = cg::this_cluster();
  const int K = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int gi = (int)blockIdx.x / K;
  T* out = a.beta_out + (size_t)gi * 2;
  if (a.sel != nullptr && !a.sel[gi]) {  // the whole cluster leaves, before any barrier
    if (rank == 0 && threadIdx.x < 2) out[threadIdx.x] = T(NAN);
    return;
  }
  const int L = a.L, R = (L + K - 1) / K;
  const int k0 = ag_row0(rank, L, K), Rb = ag_row0(rank + 1, L, K) - k0;

  extern __shared__ double ag_smem[];
  AgSmem<T> sm;
  sm.tot = ag_smem;
  sm.scr = sm.tot + (size_t)R * L + R + L;
  sm.cnt = reinterpret_cast<int*>(sm.scr + 3 * AG_THREADS);
  sm.pub = reinterpret_cast<Cand<T>*>(reinterpret_cast<char*>(sm.cnt) + align16(4 * (3 * AG_WARPS + 1)));
  sm.wbest = reinterpret_cast<Cand<T>*>(reinterpret_cast<char*>(sm.pub) + 32);
  sm.y = reinterpret_cast<T*>(reinterpret_cast<char*>(sm.wbest) + 16 * AG_WARPS);
  sm.off = sm.y + a.chunk;
  sm.x0 = sm.off + a.chunk;
  sm.x1 = sm.x0 + a.chunk;
  sm.ys = sm.x1 + a.chunk;

  const T* row = a.counts + (size_t)gi * a.N;
  const T s = a.size[gi];
  const T log_s = m_log(s);
  const T cnst = a.cnst[gi];
  const T pns2x2 = T(2) * (a.pns * a.pns);
  // Coarse, then fine around the coarse winner; a search with no entering
  // row starts again from (0, 0).
  const int ic = ag_pass<T>(a, cluster, row, s, log_s, pns2x2, cnst, a.base, a.base, T(0), T(0), k0, Rb, sm, sm.pub);
  T bx = T(0), by = T(0);
  if (ic != NONE) {
    bx = a.base[ic / L];
    by = a.base[ic % L];
  }
  const int jf = ag_pass<T>(a, cluster, row, s, log_s, pns2x2, cnst, a.offs, a.offs, bx, by, k0, Rb, sm, sm.pub + 1);
  if (rank == 0 && threadIdx.x == 0) {
    T fx = T(0), fy = T(0);
    if (jf != NONE) {
      fx = bx + a.offs[jf / L];
      fy = by + a.offs[jf % L];
    }
    out[0] = fx;
    out[1] = fy;
  }
  cluster.sync();  // no block leaves while another may still read its candidate
}

template <typename T> int launch_ape(int lanes, int K, const ApeArgs<T>& a, cudaStream_t st) {
  constexpr auto kern = grid_apeglm_kernel<T>;
  const size_t smem = ag_smem_bytes(a.L, K, a.chunk, (int)sizeof(T));
  if (smem > SMEM_BLOCK_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t e = cluster_opt_in<kern>();
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = cluster_config(lanes, K, AG_THREADS, smem, st, &attr);
  e = cudaLaunchKernelEx(&cfg, kern, a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// Blocks of grid_apeglm_kernel<T> with `smem` bytes of dynamic shared
// memory that one SM holds at once, by the occupancy API (registers, shared
// memory and threads of this build).
template <typename T> cudaError_t ape_per_sm(size_t smem, int* per_sm) {
  constexpr auto kern = grid_apeglm_kernel<T>;
  cudaError_t e = cluster_opt_in<kern>();
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kern, AG_THREADS, smem);
  return e;
}

}  // namespace

// per_sm[0] = the grid_apeglm blocks with `smem` bytes of dynamic shared
// memory one SM holds at once (ops/shrink.py:_grid_plan's fill rule).
extern "C" int grid_apeglm_per_sm(int is_f64, int smem, int* per_sm, void* stream) {
  (void)stream;
  if (smem < 0 || (size_t)smem > SMEM_BLOCK_MAX) return (int)cudaErrorInvalidValue;
  return (int)(is_f64 ? ape_per_sm<double>((size_t)smem, per_sm) : ape_per_sm<float>((size_t)smem, per_sm));
}

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

// beta_out (lanes, 2) = the apeGLM grid winner of each selected lane (NaN
// elsewhere), on clusters of K <= 16 blocks a lane (K <= L), `chunk` samples
// (a multiple of 256) staged at a time.
extern "C" int grid_apeglm_launch(int is_f64, int lanes, int N, const void* counts,
                                  const void* offset, const void* X, const void* size,
                                  const void* cnst, const void* sel, const void* base,
                                  const void* offs, int L, double pns, double ps,
                                  int shrink_index, int K, int chunk, void* beta_out,
                                  void* stream) {
  if (lanes <= 0) return (int)cudaSuccess;
  if (L < 1 || K < 1 || K > MAX_CLUSTER || K > L || chunk < AG_THREADS || chunk % AG_THREADS != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_f64) {
    const ApeArgs<double> a{N, L, chunk, shrink_index, (const double*)counts, (const double*)offset,
                            (const double*)X, (const double*)size, (const double*)cnst,
                            (const unsigned char*)sel, (const double*)base, (const double*)offs, pns, ps,
                            (double*)beta_out};
    return launch_ape<double>(lanes, K, a, s);
  }
  const ApeArgs<float> a{N, L, chunk, shrink_index, (const float*)counts, (const float*)offset,
                         (const float*)X, (const float*)size, (const float*)cnst,
                         (const unsigned char*)sel, (const float*)base, (const float*)offs, (float)pns,
                         (float)ps, (float*)beta_out};
  return launch_ape<float>(lanes, K, a, s);
}
