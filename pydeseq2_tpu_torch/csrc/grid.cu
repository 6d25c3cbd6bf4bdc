// Coarse-to-fine 2-D grid searches for P == 2 designs, each selected lane on
// a thread-block cluster: grid_nb and grid_apeglm, two objectives of one
// search.
//
// grid_nb replaces grid_fit_beta_batch (pydeseq2_tpu/ops/irls.py:375), the
// last IRLS rescue tier: the full NB NLL (ops/nb.py:84, lgamma terms and the
// r < 8 branch switch included) plus 0.5e-6 |beta|^2 at 60 x 60 points of
// [-30, 30]^2, then at 60 x 60 points of a per-lane fine grid of half-width
// one coarse step around the coarse winner. grid_apeglm replaces
// grid_fit_shrink_beta_batch (pydeseq2_tpu/ops/shrink.py:258), the same two
// passes on the apeGLM objective scaled by the caller's per-lane constant.
//
// A launch runs C clusters of K <= 16 blocks. grid_nb's cluster c takes the
// selected lanes of slots c, c + C, ... (the selected lanes in lane order;
// every lane where the caller selects none), grid_apeglm's lane c (a launch
// of a cluster a lane), and block rank q the grid rows
// [q L / K, (q + 1) L / K) of both passes, so that one selected lane still
// spreads over K SMs and a large selection splits into blocks small enough to
// leave no mostly idle second wave (ops/shrink.py:_grid_plan picks K and the
// chunk from the number of selected lanes and N; grid_nb's wrapper takes C
// from the count its caller already read). The lanes not selected get NaN.
// A block stages a chunk of the lane's samples sorted by design row, each
// class in sample order:
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
// Besides the design row, a sample stages what its term needs that does not
// depend on beta: for the NB NLL the lgamma-bearing part of either branch,
// hoisted whole as the leading subexpression (so its rounding is the plain
// version's) and the Stirling corrections; for apeGLM y, the offset and
// y + size.
//
// Each row ends in a warp argmin with jnp.argmin's rule (first minimum, a
// NaN wins), and the rows are combined as the JAX code combines them:
// - grid_nb's coarse pass is one flat argmin over the x-major grid, so the
//   rows combine by the same rule (a NaN anywhere wins);
// - grid_nb's fine pass and both grid_apeglm passes keep a row only where
//   its minimum is strictly below the best so far, which starts at +inf:
//   a row whose argmin is NaN never enters, and ties go to the earlier row.
//   That is the first row of least value among the rows whose minimum is
//   below +inf.
// Both are total orders, so each block publishes its best candidate and,
// after a cluster barrier, every block reads the K candidates through
// distributed shared memory and picks the same winner.
//
// Bound on the H100: 7200 objective evaluations of N samples per selected
// lane (~40 operations and 3 transcendentals each), fewer where a design
// entry is 0; the precise library exp, log and log1p of every term make it
// an issue-rate bound (PERF.md section 6 gives the SASS counts).
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

using namespace pdt;

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / WARP;
constexpr int NONE = 0x7fffffff;
// Sample classes by design row: the term needs bx alone (x1 = 0), by alone
// (x0 = 0), or both.
constexpr int CLS_A = 0, CLS_B = 1, CLS_C = 2;
// The ints of a block: the warps' class counts, the winner, the lane of the
// slot being searched.
constexpr int INTS = 3 * WARPS + 2;
constexpr int I_WIN = 3 * WARPS, I_LANE = 3 * WARPS + 1;

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

// What both searches share: lanes (K, N) of counts, the design, the caller's
// selection (nullptr: every lane), the coarse grid and the fine offsets.
template <typename T> struct GridArgs {
  int lanes, N, L, chunk;
  const T* counts;
  const T* X;
  const unsigned char* sel;
  const T* base;
  const T* offs;
  T* beta_out;
};

// The staged chunk: ARRAYS arrays of `chunk` samples, x0 and x1 first, then
// the objective's own.

// grid_nb's objective: nb_nll + 0.5e-6 |beta|^2 (irls.py:393-401, :418-427).
// Staged: y, sf, the hoisted lead term, y + r, and the two Stirling
// corrections of the stable branch.
template <typename T> struct NbObj {
  static constexpr int ARRAYS = 8;
  static constexpr bool SLOTS = true;  // clusters take the selected lanes' slots
  static constexpr Rule COARSE = FLAT;
  static constexpr bool KEEP_COARSE = true;  // a fine pass with no entering row keeps the coarse point
  const T* sf;
  const T* disp;
  T min_mu;
  struct Lane {
    T r;
    bool plain;
  };

  __device__ __forceinline__ Lane lane(int gi) const {
    const T r = T(1) / disp[gi];
    return Lane{r, r < T(R_SWITCH)};
  }
  __device__ __forceinline__ void stage(const Lane& l, T* st, int c, int p, int n, T yv) const {
    const T r = l.r;
    const T lgy1 = m_lgamma(yv + T(1));
    const T yr = yv + r;
    st[2 * c + p] = yv;
    st[3 * c + p] = sf[n];
    st[5 * c + p] = yr;
    if (l.plain) {
      // -r log r - logbinom, logbinom = lgamma(y + r) - lgamma(y + 1) - lgamma(r)
      const T logbinom = (m_lgamma(yr) - lgy1) - m_lgamma(r);
      st[4 * c + p] = (-r) * m_log(r) - logbinom;
      st[6 * c + p] = T(0);
      st[7 * c + p] = T(0);
    } else {
      const T l1y = m_log1p(yv / r);
      st[4 * c + p] = (lgy1 + yv) - (yr - T(0.5)) * l1y;
      st[6 * c + p] = yv / ((T(12) * r) * yr);
      st[7 * c + p] = (T(1) / ((yr * yr) * yr) - T(1) / ((r * r) * r)) / T(360);
    }
  }
  // nb_nll's term of staged sample i at linear predictor xb.
  __device__ __forceinline__ T term(const Lane& l, const T* st, int c, int i, T xb) const {
    const T mu = m_max(st[3 * c + i] * m_exp(xb), min_mu);
    const T yv = st[2 * c + i];
    const T ylogmu = yv > T(0) ? yv * m_log(mu) : T(0);
    if (l.plain) return (st[4 * c + i] + st[5 * c + i] * m_log(mu + l.r)) - ylogmu;
    return (((st[4 * c + i] + st[5 * c + i] * m_log1p(mu / l.r)) - ylogmu) + st[6 * c + i]) + st[7 * c + i];
  }
  // nb_nll + 0.5 * (1e-6 x^2 + 1e-6 y^2) (coarse) or + 0.5e-6 (x^2 + y^2) (fine)
  __device__ __forceinline__ T finish(const Lane&, double tot, T bx, T by, bool coarse) const {
    const T reg = coarse ? T(0.5) * (T(1e-6) * (bx * bx) + T(1e-6) * (by * by)) : T(0.5e-6) * (bx * bx + by * by);
    return (T)tot + reg;
  }
};

// grid_apeglm's objective: nbinom_fn_batch(beta = (bx, by)) / cnst,
// shrink.py:23-53 and :281-292. Staged: y, the offset, y + size.
template <typename T> struct ApeObj {
  static constexpr int ARRAYS = 5;
  static constexpr bool SLOTS = false;  // a cluster a lane
  static constexpr Rule COARSE = ROWS;
  static constexpr bool KEEP_COARSE = false;  // a pass with no entering row gives (0, 0)
  const T* offset;
  const T* size;
  const T* cnst;
  T pns, ps;
  int shrink_index;
  struct Lane {
    T s, log_s, cn, pns2x2;
  };

  __device__ __forceinline__ Lane lane(int gi) const {
    const T s = size[gi];
    return Lane{s, m_log(s), cnst[gi], T(2) * (pns * pns)};
  }
  __device__ __forceinline__ void stage(const Lane& l, T* st, int c, int p, int n, T yv) const {
    st[2 * c + p] = yv;
    st[3 * c + p] = offset[n];
    st[4 * c + p] = yv + l.s;
  }
  __device__ __forceinline__ T term(const Lane& l, const T* st, int c, int i, T xb) const {
    return apeglm_ll_term(st[2 * c + i], st[4 * c + i], xb, st[3 * c + i], l.log_s);
  }
  // from the log-likelihood's float64 total
  __device__ __forceinline__ T finish(const Lane& l, double tot, T bx, T by, bool) const {
    const T ll = (T)tot;
    const T vx = shrink_index == 0 ? bx * T(0) : bx;
    const T vy = shrink_index == 1 ? by * T(0) : by;
    const T q = (shrink_index == 0 ? bx : by) / ps;
    const T prior = (vx * vx + vy * vy) / l.pns2x2 + m_log1p(q * q);
    return (prior - ll) / l.cn;
  }
};

// The first grid row of block rank q of K (ops/shrink.py:_grid_rows).
__host__ __device__ constexpr int row0(int q, int L, int K) { return (int)(((long long)q * L) / K); }

// Dynamic shared memory of one block (ops/shrink.py:_grid_smem_bytes
// repeats it): float64 totals of its points (R L), rows (R) and columns (L),
// R = ceil(L / K); float64 slice partials of the three classes (3 x
// THREADS); INTS ints; the two published candidates and the warps' (16 bytes
// each); the staged chunk, `arrays` values a sample.
__host__ __device__ constexpr size_t grid_smem_bytes(int L, int K, int chunk, int isz, int arrays) {
  return 8 * ((size_t)((L + K - 1) / K) * L + (L + K - 1) / K + L + 3 * THREADS) + align16(4 * INTS) +
         16 * (2 + WARPS) + (size_t)arrays * chunk * isz;
}

template <typename T> struct Smem {
  double* tot;     // the points' totals, then the rows', then the columns'
  double* scr;     // [3][THREADS] slice partials
  int* ints;       // [WARPS][3] class counts (first: the selection's warp counts), the winner, the lane
  Cand<T>* pub;    // [2]: the block's candidate of each pass, read by the cluster
  Cand<T>* wbest;  // [WARPS]
  T* st;           // the staged chunk
};

template <typename T> __device__ __forceinline__ int cls(T x0, T x1) {
  return x1 == T(0) ? CLS_A : (x0 == T(0) ? CLS_B : CLS_C);
}

// Inclusive sum of v over the lanes up to this one.
__device__ __forceinline__ int warp_scan(int v, int lane) {
#pragma unroll
  for (int o = 1; o < WARP; o <<= 1) {
    const int u = __shfl_up_sync(FULL, v, o);
    if (lane >= o) v += u;
  }
  return v;
}

// Stage samples n0 .. n0 + m - 1 of the lane, class A first, then B, then
// C, each in sample order: thread t classifies the V consecutive samples
// from t V, and a scan over the warps places them. n[k] gets class k's size.
template <typename T, typename Obj>
__device__ void stage(const GridArgs<T>& a, const Obj& o, const typename Obj::Lane& l, const T* __restrict__ row,
                      int n0, int m, int V, const Smem<T>& sm, int n[3]) {
  const int tid = threadIdx.x, warp = tid / WARP, lane = tid & (WARP - 1);
  const int i0 = min(m, tid * V), i1 = min(m, i0 + V);
  const T* X = a.X + 2 * (size_t)n0;
  int c[3] = {0, 0, 0};
  for (int i = i0; i < i1; ++i) {
    const int k = cls(X[2 * i], X[2 * i + 1]);
    c[0] += k == CLS_A;
    c[1] += k == CLS_B;
    c[2] += k == CLS_C;
  }
  int pos[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int v = warp_scan(c[k], lane);
    pos[k] = v - c[k];
    if (lane == WARP - 1) sm.ints[warp * 3 + k] = v;
  }
  __syncthreads();
  int start = 0;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    int before = 0, total = 0;
    for (int w = 0; w < WARPS; ++w) {
      const int x = sm.ints[w * 3 + k];
      before += w < warp ? x : 0;
      total += x;
    }
    pos[k] += start + before;
    n[k] = total;
    start += total;
  }
  for (int i = i0; i < i1; ++i) {
    const T x0 = X[2 * i], x1 = X[2 * i + 1];
    const int k = cls(x0, x1);
    const int p = k == CLS_A ? pos[0]++ : (k == CLS_B ? pos[1]++ : pos[2]++);
    sm.st[p] = x0;
    sm.st[a.chunk + p] = x1;
    o.stage(l, sm.st, a.chunk, p, n0 + i, row[n0 + i]);
  }
}

// Slices of a class of n samples over pts totals, about tau terms an item;
// more than one only where pts x slices fits one scratch row.
__device__ __forceinline__ int slices(int n, long long tau, int pts) {
  if (n == 0 || pts == 0) return 0;
  return (int)min((n + tau - 1) / tau, (long long)max(1, THREADS / pts));
}

// One pass of the cluster over the L x L grid (x_k = xg[k] + xs, y_j = yg[j]
// + ys0), this block over rows k0 .. k0 + Rb - 1, rows combined by `rule`:
// the winning flat index k L + j, or NONE where no row entered; every block
// of the cluster returns the same. `pub` is this pass's published candidate.
template <typename T, typename Obj>
__device__ int pass(const GridArgs<T>& a, const Obj& o, const typename Obj::Lane& l, cg::cluster_group& cluster,
                    const T* __restrict__ row,
                    const T* __restrict__ xg, const T* __restrict__ yg, T xs, T ys0, int k0, int Rb, bool coarse,
                    Rule rule, const Smem<T>& sm, Cand<T>* pub) {
  const int tid = threadIdx.x, warp = tid / WARP, lane = tid & (WARP - 1);
  const int L = a.L, P = Rb * L, V = a.chunk / THREADS, ch = a.chunk;
  double* totC = sm.tot;
  double* totA = totC + P;
  double* totB = totA + Rb;
  const T* st = sm.st;
  for (int q = tid; q < P + Rb + L; q += THREADS) totC[q] = 0.0;
  for (int n0 = 0; n0 < a.N; n0 += a.chunk) {
    const int m = min(a.chunk, a.N - n0);
    __syncthreads();  // the previous chunk is no longer read, the totals are zeroed
    int n[3];
    stage<T>(a, o, l, row, n0, m, V, sm, n);
    __syncthreads();
    const long long W = (long long)P * n[CLS_C] + (long long)Rb * n[CLS_A] + (long long)L * n[CLS_B];
    const long long tau = max(1LL, (W + THREADS - 1) / THREADS);
    const int SA = slices(n[CLS_A], tau, Rb), SB = slices(n[CLS_B], tau, L), SC = slices(n[CLS_C], tau, P);
    const int iC = P * SC, iA = iC + Rb * SA, iB = iA + L * SB;
    for (int it = tid; it < iB; it += THREADS) {
      double acc = 0.0;
      if (it < iC) {
        const int p = it % P, sl = it / P;
        const int len = (n[CLS_C] + SC - 1) / SC, first = n[CLS_A] + n[CLS_B];
        const int lo = first + sl * len, hi = first + min(n[CLS_C], (sl + 1) * len);
        const int r = p / L;
        const T bx = xs + xg[k0 + r], by = ys0 + yg[p - r * L];
#pragma unroll 4
        for (int i = lo; i < hi; ++i) acc += (double)o.term(l, st, ch, i, bx * st[i] + by * st[ch + i]);
        if (SC == 1) totC[p] += acc;
        else sm.scr[2 * THREADS + it] = acc;
      } else if (it < iA) {
        const int e = it - iC, p = e % Rb, sl = e / Rb;
        const int len = (n[CLS_A] + SA - 1) / SA;
        const int lo = sl * len, hi = min(n[CLS_A], (sl + 1) * len);
        const T bx = xs + xg[k0 + p];
#pragma unroll 4
        for (int i = lo; i < hi; ++i) acc += (double)o.term(l, st, ch, i, bx * st[i]);
        if (SA == 1) totA[p] += acc;
        else sm.scr[e] = acc;
      } else {
        const int e = it - iA, p = e % L, sl = e / L;
        const int len = (n[CLS_B] + SB - 1) / SB, first = n[CLS_A];
        const int lo = first + sl * len, hi = first + min(n[CLS_B], (sl + 1) * len);
        const T by = ys0 + yg[p];
#pragma unroll 4
        for (int i = lo; i < hi; ++i) acc += (double)o.term(l, st, ch, i, by * st[ch + i]);
        if (SB == 1) totB[p] += acc;
        else sm.scr[THREADS + e] = acc;
      }
    }
    __syncthreads();
    // the sliced classes' partials, in slice order
    for (int q = tid; q < P + Rb + L; q += THREADS) {
      int p = q, S = SC, pts = P;
      const double* part = sm.scr + 2 * THREADS;
      if (q >= P + Rb) {
        p = q - P - Rb, S = SB, pts = L;
        part = sm.scr + THREADS;
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
  // Each row's jnp.argmin; the block's winner among its rows by the rule.
  Cand<T> wb{Lim<T>::inf(), NONE};
  for (int r = warp; r < Rb; r += WARPS) {
    const int k = k0 + r;
    const T bx = xs + xg[k];
    Cand<T> best{Lim<T>::inf(), NONE};
    for (int j = lane; j < L; j += WARP) {
      const Cand<T> c{o.finish(l, (totA[r] + totB[j]) + totC[r * L + j], bx, ys0 + yg[j], coarse), k * L + j};
      if (argmin_before(c, best)) best = c;
    }
    best = warp_argmin(best);
    const bool enters = rule == FLAT || (best.v == best.v && best.v < Lim<T>::inf());
    if (enters && argmin_before(best, wb)) wb = best;
  }
  if (lane == 0) sm.wbest[warp] = wb;
  __syncthreads();
  if (tid == 0) {
    Cand<T> b = sm.wbest[0];
    for (int w = 1; w < WARPS; ++w)
      if (argmin_before(sm.wbest[w], b)) b = sm.wbest[w];
    *pub = b;
  }
  cluster.sync();  // every block's candidate of this pass is visible
  if (warp == 0) {
    const int K = (int)cluster.num_blocks();
    Cand<T> b{Lim<T>::inf(), NONE};
    if (lane < K) b = *cluster.map_shared_rank(pub, (unsigned)lane);
    b = warp_argmin(b);
    if (lane == 0) sm.ints[I_WIN] = b.i;
  }
  __syncthreads();
  return sm.ints[I_WIN];
}

// The selected lanes in lane order, block-wide: thread t counts those of
// [t V, (t + 1) V), V = ceil(lanes / THREADS), and a scan over the warps
// gives it the first slot of its range. `total` is the selected count.
struct SelScan {
  int first, count, total;
};

__device__ SelScan sel_scan(const unsigned char* __restrict__ sel, int lanes, int* warp_cnt) {
  const int tid = threadIdx.x, warp = tid / WARP, lane = tid & (WARP - 1);
  const int V = (lanes + THREADS - 1) / THREADS, i0 = min(lanes, tid * V), i1 = min(lanes, i0 + V);
  int c = 0;
  for (int i = i0; i < i1; ++i) c += sel[i] != 0;
  const int v = warp_scan(c, lane);
  if (lane == WARP - 1) warp_cnt[warp] = v;
  __syncthreads();
  int before = 0, total = 0;
  for (int w = 0; w < WARPS; ++w) {
    before += w < warp ? warp_cnt[w] : 0;
    total += warp_cnt[w];
  }
  __syncthreads();  // warp_cnt may be written again
  return SelScan{before + v - c, c, total};
}

// The lane of slot s: the thread whose range holds it finds it.
__device__ int sel_lane(const unsigned char* __restrict__ sel, int lanes, const SelScan& ss, int s, int* out) {
  if (s >= ss.first && s < ss.first + ss.count) {
    const int V = (lanes + THREADS - 1) / THREADS;
    int k = ss.first;
    for (int i = threadIdx.x * V;; ++i) {
      if (sel[i] && k++ == s) {
        *out = i;
        break;
      }
    }
  }
  __syncthreads();
  return *out;
}

// Both passes for lane gi, the cluster's result written by rank 0.
template <typename T, typename Obj>
__device__ __forceinline__ void search_lane(const GridArgs<T>& a, const Obj& o, cg::cluster_group& cluster, int gi,
                                            int k0, int Rb, const Smem<T>& sm) {
  const int L = a.L;
  const typename Obj::Lane l = o.lane(gi);
  const T* row = a.counts + (size_t)gi * a.N;
  // Coarse, then fine around the coarse winner (x-major flat indices).
  const int ic = pass<T>(a, o, l, cluster, row, a.base, a.base, T(0), T(0), k0, Rb, true, Obj::COARSE, sm, sm.pub);
  T bx = T(0), by = T(0);
  if (ic != NONE) {
    bx = a.base[ic / L];
    by = a.base[ic % L];
  }
  const int jf = pass<T>(a, o, l, cluster, row, a.offs, a.offs, bx, by, k0, Rb, false, ROWS, sm, sm.pub + 1);
  if (cluster.block_rank() == 0 && threadIdx.x == 0) {
    T fx = Obj::KEEP_COARSE ? bx : T(0), fy = Obj::KEEP_COARSE ? by : T(0);
    if (jf != NONE) {
      fx = bx + a.offs[jf / L];
      fy = by + a.offs[jf % L];
    }
    a.beta_out[2 * (size_t)gi] = fx;
    a.beta_out[2 * (size_t)gi + 1] = fy;
  }
}

// Both passes for each of the cluster's lanes: with Obj::SLOTS, the
// selected lanes of slots c, c + C, ... (the lanes not selected NaN, written
// by the clusters in turn), else lane c, or NaN where it is not selected.
template <typename T, typename Obj> __device__ void grid_search(const GridArgs<T>& a, const Obj& o) {
  cg::cluster_group cluster = cg::this_cluster();
  const int K = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int C = (int)gridDim.x / K, c = (int)blockIdx.x / K;
  if constexpr (!Obj::SLOTS) {
    if (a.sel != nullptr && !a.sel[c]) {  // the whole cluster leaves, before any barrier
      if (rank == 0 && threadIdx.x < 2) a.beta_out[2 * (size_t)c + threadIdx.x] = T(NAN);
      return;
    }
  } else if (a.sel != nullptr && rank == 0) {
    for (int gi = c + C * (int)threadIdx.x; gi < a.lanes; gi += C * THREADS)
      if (!a.sel[gi]) {
        a.beta_out[2 * (size_t)gi] = T(NAN);
        a.beta_out[2 * (size_t)gi + 1] = T(NAN);
      }
  }
  const int L = a.L, R = (L + K - 1) / K;
  const int k0 = row0(rank, L, K), Rb = row0(rank + 1, L, K) - k0;

  extern __shared__ double grid_smem[];
  Smem<T> sm;
  sm.tot = grid_smem;
  sm.scr = sm.tot + (size_t)R * L + R + L;
  sm.ints = reinterpret_cast<int*>(sm.scr + 3 * THREADS);
  sm.pub = reinterpret_cast<Cand<T>*>(reinterpret_cast<char*>(sm.ints) + align16(4 * INTS));
  sm.wbest = reinterpret_cast<Cand<T>*>(reinterpret_cast<char*>(sm.pub) + 32);
  sm.st = reinterpret_cast<T*>(reinterpret_cast<char*>(sm.wbest) + 16 * WARPS);

  if constexpr (Obj::SLOTS) {
    // Every block of the cluster counts the same selection, so the cluster
    // runs the same slots and meets every barrier together.
    SelScan ss{0, 0, a.lanes};
    if (a.sel != nullptr) ss = sel_scan(a.sel, a.lanes, sm.ints);
    for (int slot = c; slot < ss.total; slot += C) {
      const int gi = a.sel != nullptr ? sel_lane(a.sel, a.lanes, ss, slot, sm.ints + I_LANE) : slot;
      search_lane<T>(a, o, cluster, gi, k0, Rb, sm);
    }
  } else {
    search_lane<T>(a, o, cluster, c, k0, Rb, sm);
  }
  cluster.sync();  // no block leaves while another may still read its candidate
}

template <typename T>
__global__ void __launch_bounds__(THREADS) grid_nb_kernel(const GridArgs<T> a, const NbObj<T> o) {
  grid_search<T>(a, o);
}

template <typename T>
__global__ void __launch_bounds__(THREADS) grid_apeglm_kernel(const GridArgs<T> a, const ApeObj<T> o) {
  grid_search<T>(a, o);
}

template <auto Kern, typename T, typename Obj>
int launch(int clusters, int K, const GridArgs<T>& a, const Obj& o, cudaStream_t st) {
  if (clusters <= 0) return (int)cudaSuccess;
  if (a.L < 1 || K < 1 || K > MAX_CLUSTER || K > a.L || a.chunk < THREADS || a.chunk % THREADS != 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = grid_smem_bytes(a.L, K, a.chunk, (int)sizeof(T), Obj::ARRAYS);
  if (smem > SMEM_BLOCK_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t e = cluster_opt_in<Kern>();
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = cluster_config(clusters, K, THREADS, smem, st, &attr);
  e = cudaLaunchKernelEx(&cfg, Kern, a, o);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// Blocks of Kern with `smem` bytes of dynamic shared memory that one SM holds
// at once, by the occupancy API (registers, shared memory and threads of
// this build).
template <auto Kern> int per_sm(int smem, int* out) {
  if (smem < 0 || (size_t)smem > SMEM_BLOCK_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t e = cluster_opt_in<Kern>();
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, Kern, THREADS, (size_t)smem);
  return (int)e;
}

}  // namespace

// per_sm[0] = the blocks of each kernel with `smem` bytes of dynamic shared
// memory one SM holds at once (ops/shrink.py:_grid_plan's wave rule).
extern "C" int grid_apeglm_per_sm(int is_f64, int smem, int* out, void* stream) {
  (void)stream;
  return is_f64 ? per_sm<grid_apeglm_kernel<double>>(smem, out) : per_sm<grid_apeglm_kernel<float>>(smem, out);
}

extern "C" int grid_nb_per_sm(int is_f64, int smem, int* out, void* stream) {
  (void)stream;
  return is_f64 ? per_sm<grid_nb_kernel<double>>(smem, out) : per_sm<grid_nb_kernel<float>>(smem, out);
}

// beta_out (lanes, 2) = the NB grid winner of each selected lane (NaN
// elsewhere), on `clusters` clusters of K <= 16 blocks (K <= L), `chunk`
// samples (a multiple of 256) staged at a time.
extern "C" int grid_nb_launch(int is_f64, int lanes, int clusters, int N, const void* counts, const void* sf,
                              const void* X, const void* disp, const void* sel, const void* base, const void* offs,
                              int L, double min_mu, int K, int chunk, void* beta_out, void* stream) {
  if (lanes <= 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_f64) {
    const GridArgs<double> a{lanes, N, L, chunk, (const double*)counts, (const double*)X, (const unsigned char*)sel,
                             (const double*)base, (const double*)offs, (double*)beta_out};
    const NbObj<double> o{(const double*)sf, (const double*)disp, min_mu};
    return launch<grid_nb_kernel<double>>(clusters, K, a, o, s);
  }
  const GridArgs<float> a{lanes, N, L, chunk, (const float*)counts, (const float*)X, (const unsigned char*)sel,
                          (const float*)base, (const float*)offs, (float*)beta_out};
  const NbObj<float> o{(const float*)sf, (const float*)disp, (float)min_mu};
  return launch<grid_nb_kernel<float>>(clusters, K, a, o, s);
}

// beta_out (lanes, 2) = the apeGLM grid winner of each selected lane (NaN
// elsewhere), on a cluster of K <= 16 blocks a lane (K <= L), `chunk`
// samples (a multiple of 256) staged at a time.
extern "C" int grid_apeglm_launch(int is_f64, int lanes, int N, const void* counts, const void* offset,
                                  const void* X, const void* size, const void* cnst, const void* sel,
                                  const void* base, const void* offs, int L, double pns, double ps,
                                  int shrink_index, int K, int chunk, void* beta_out, void* stream) {
  if (lanes <= 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_f64) {
    const GridArgs<double> a{lanes, N, L, chunk, (const double*)counts, (const double*)X, (const unsigned char*)sel,
                             (const double*)base, (const double*)offs, (double*)beta_out};
    const ApeObj<double> o{(const double*)offset, (const double*)size, (const double*)cnst, pns, ps, shrink_index};
    return launch<grid_apeglm_kernel<double>>(lanes, K, a, o, s);
  }
  const GridArgs<float> a{lanes, N, L, chunk, (const float*)counts, (const float*)X, (const unsigned char*)sel,
                          (const float*)base, (const float*)offs, (float*)beta_out};
  const ApeObj<float> o{(const float*)offset, (const float*)size, (const float*)cnst, (float)pns, (float)ps,
                        shrink_index};
  return launch<grid_apeglm_kernel<float>>(lanes, K, a, o, s);
}
