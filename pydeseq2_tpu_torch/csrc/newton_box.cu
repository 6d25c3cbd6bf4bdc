// Projected-Newton rescue of the NB GLM coefficients in the [-30, 30]^P box,
// a block a selected lane, the 13 backtracking candidates in one pass.
//
// Replaces newton_box_nbglm (pydeseq2_tpu/ops/irls.py:272), a fori_loop of
// 60 Newton steps, each with 13 backtracking halvings, over every lane of
// the compacted rescue tile. Only the lanes the caller selects are used
// (1-2 of the 937-lane tile at 100 x 60000): the grid, at most the blocks
// the card holds at once, takes the selected lanes in lane order, block b
// the slots b, b + grid, ..., each block finding its lanes by a count over
// the tile's `sel` bytes (no count is read on the host). The lanes not
// selected get beta_init and "no success".
//
// A block stages its lane's y, sf, log sf and X (transposed) in shared
// memory, `stage` samples of them (the rest is read from device memory, so
// shared memory does not cap N), then runs the steps in order:
//  - the ridged gradient and the exact Hessian in one block-wide pass,
//    threads over samples, then a block reduction in a fixed tree (warp
//    trees, the warps' sums in warp order), so a second launch repeats the
//    first bit for bit; the damped solve (H + 1e-6 I + 1e-8 I) by every
//    thread;
//  - the 13 backtracking candidates t = 1, 1/2, ..., 2^-12 of the
//    lgamma-free objective sum (y + r) log1p(mu/r) - y log mu + ridge
//    (irls.py:308-317) in one pass, warp c evaluating candidate c over the
//    row in its own fixed tree (lanes strided over samples, then a warp
//    butterfly), and in the first step a 14th warp the start's objective
//    by the same tree. The step takes the first candidate whose objective
//    is below the current one: the sequential search's iterate (the JAX
//    loop evaluates every t but never replaces a captured step).
// A step whose 13 candidates find no improvement leaves beta and f as they
// were, and every later step would repeat it, so the lane leaves the loop
// there; its gradient at beta is that step's, so the exit test needs no
// further pass. The exit test is the projected-gradient sup-norm < 1e-5 of
// irls.py:366-370.
//
// passes counts the serial sweeps over the row (a gradient pass and a
// candidate pass a step, and the final gradient where the last step
// improved).
//
// Bound on the H100: for the selected lanes only, ~(1 + 13) evaluations of
// ~20 operations per sample and step at most, far below a microsecond. The
// serial dependence of the steps sets its time: per step two passes, each
// ending in a reduction, where a sequential search needs up to 14.
#include "common.cuh"

using namespace pdt;

namespace {

constexpr int CANDS = 13;                 // t = 1, 1/2, ..., 2^-12
constexpr int WARPS = CANDS + 1;          // a warp a candidate, one for the start's objective
constexpr int THREADS = WARPS * WARP;     // 448

template <typename T> struct BoxArgs {
  int K, N, stage;
  const T* counts;
  const T* sf;
  const T* log_sf;
  const T* X;
  const T* disp;
  const T* beta_init;
  const unsigned char* sel;
  T min_mu, max_beta, lo_edge, hi_edge;
  int maxiter;
  T* beta_out;
  unsigned char* ok_out;
  int* passes_out;
};

// The dynamic shared memory of a block (ops/irls.py:_box_smem_bytes), in
// this order: the block reduction's slots (WARPS x V values, V = P + NTRI),
// the candidates' objectives (WARPS values), WARPS + 1 ints (the selection
// scan's warp counts and the lane of a slot), the staged row (y, sf, log
// sf, then X column by column, `stage` samples each).
template <int P, typename T> __host__ __device__ constexpr size_t red_bytes() {
  return align16((size_t)WARPS * (P + NTRI<P>) * sizeof(T));
}
template <typename T> __host__ __device__ constexpr size_t obj_bytes() { return align16((size_t)WARPS * sizeof(T)); }
constexpr size_t INT_BYTES = align16((WARPS + 1) * sizeof(int));
template <int P, typename T> __host__ __device__ constexpr size_t smem_bytes(int stage) {
  return red_bytes<P, T>() + obj_bytes<T>() + INT_BYTES + align16((size_t)stage * (3 + P) * sizeof(T));
}

// One lane's row: samples below S from the stage, the rest from device memory.
template <int P, typename T> struct Row {
  const T* y;
  const T* sf;
  const T* lsf;
  const T* X;
  const T* st;  // y[S], sf[S], log sf[S], X[P][S]
  int N, S;
  __device__ __forceinline__ void sample(int n, T& yv, T& sfv, T& lsfv, T* xv) const {
    if (n < S) {
      yv = st[n];
      sfv = st[S + n];
      lsfv = st[2 * S + n];
#pragma unroll
      for (int p = 0; p < P; ++p) xv[p] = st[(3 + p) * S + n];
    } else {
      yv = y[n];
      sfv = __ldg(sf + n);
      lsfv = __ldg(lsf + n);
#pragma unroll
      for (int p = 0; p < P; ++p) xv[p] = __ldg(X + (size_t)n * P + p);
    }
  }
};

// x . b summed in coefficient order (common.cuh:lin_pred's order).
template <int P, typename T> __device__ __forceinline__ T dot(const T* xv, const T* b) {
  T xb = T(0);
#pragma unroll
  for (int p = 0; p < P; ++p) xb = xb + b[p] * xv[p];
  return xb;
}

// Backtracking objective at b, one warp (the lgamma bulk cancels in
// comparisons); every lane of the warp returns it.
template <int P, typename T>
__device__ __forceinline__ T objective(const Row<P, T>& row, const T* b, T r, T min_mu, T log_min_mu) {
  const int lane = threadIdx.x & (WARP - 1);
  T acc = T(0);
  for (int n = lane; n < row.N; n += WARP) {
    T yv, sfv, lsfv, xv[P];
    row.sample(n, yv, sfv, lsfv, xv);
    const T xb = dot<P, T>(xv, b);
    const T raw = sfv * m_exp(xb);
    const bool clamped = raw < min_mu;
    const T mu = clamped ? min_mu : raw;
    const T log_mu = clamped ? log_min_mu : xb + lsfv;
    acc += (yv + r) * m_log1p(mu / r) - (yv > T(0) ? yv * log_mu : T(0));
  }
  T ss = b[0] * b[0];
#pragma unroll
  for (int p = 1; p < P; ++p) ss = ss + b[p] * b[p];
  return warp_sum(acc) + T(0.5) * T(1e-6) * ss;
}

// Ridged NLL gradient at b and the packed exact Hessian X^T diag(mu (1 + a
// y)/(1 + a mu)^2) X, mu = max(sf e^{xb}, min_mu) (irls.py:214-221,319-330),
// block-wide; every thread ends with them.
template <int P, typename T>
__device__ __forceinline__ void grad_hess(const Row<P, T>& row, const T* b, T disp, T inv_disp, T min_mu, T* red,
                                          T* grad, T* hess) {
  constexpr int V = P + NTRI<P>;
  T v[V];
#pragma unroll
  for (int i = 0; i < V; ++i) v[i] = T(0);
  for (int n = threadIdx.x; n < row.N; n += THREADS) {
    T yv, sfv, lsfv, xv[P];
    row.sample(n, yv, sfv, lsfv, xv);
    const T mu = m_max(sfv * m_exp(dot<P, T>(xv, b)), min_mu);
    const T t = (inv_disp + yv) * mu / (inv_disp + mu);
    const T den = T(1) + disp * mu;
    const T w = mu * (T(1) + disp * yv) / (den * den);
#pragma unroll
    for (int p = 0; p < P; ++p) {
      v[p] += (t - yv) * xv[p];
      const T wp = w * xv[p];
#pragma unroll
      for (int q = p; q < P; ++q) v[P + tri_idx<P>(p, q)] += wp * xv[q];
    }
  }
  block_sum<THREADS, V>(v, red);
#pragma unroll
  for (int p = 0; p < P; ++p) grad[p] = v[p] + T(1e-6) * b[p];
#pragma unroll
  for (int i = 0; i < NTRI<P>; ++i) hess[i] = v[P + i];
}

// Candidate c of a step: clip(beta - 2^-c step, -max_beta, max_beta).
template <int P, typename T>
__device__ __forceinline__ void candidate(int c, const T* beta, const T* step, T max_beta, T* cand) {
  const T t = T(1.0 / (double)(1 << c));  // a power of two: the halvings' exact value
#pragma unroll
  for (int p = 0; p < P; ++p) cand[p] = m_min(m_max(beta[p] - t * step[p], -max_beta), max_beta);
}

// The selected lanes in lane order: thread t counts those of [t V, (t + 1)
// V), V = ceil(K / THREADS), and a scan over the warps gives it the first
// slot of its range. `total` is the selected count.
struct SelScan {
  int first, count, total;
};

__device__ SelScan sel_scan(const unsigned char* __restrict__ sel, int K, int* warp_cnt) {
  const int tid = threadIdx.x, w = tid / WARP, lane = tid & (WARP - 1);
  const int V = (K + THREADS - 1) / THREADS, i0 = min(K, tid * V), i1 = min(K, i0 + V);
  int c = 0;
  for (int i = i0; i < i1; ++i) c += sel[i] != 0;
  int v = c;
#pragma unroll
  for (int o = 1; o < WARP; o <<= 1) {
    const int t = __shfl_up_sync(FULL, v, o);
    if (lane >= o) v += t;
  }
  if (lane == WARP - 1) warp_cnt[w] = v;
  __syncthreads();
  int before = 0, total = 0;
  for (int j = 0; j < WARPS; ++j) {
    before += j < w ? warp_cnt[j] : 0;
    total += warp_cnt[j];
  }
  return SelScan{before + v - c, c, total};
}

// The lane of slot s: the thread whose range holds it finds it.
__device__ int sel_lane(const unsigned char* __restrict__ sel, int K, const SelScan& ss, int s, int* out) {
  if (s >= ss.first && s < ss.first + ss.count) {
    const int V = (K + THREADS - 1) / THREADS;
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

template <int P, typename T>
__global__ void __launch_bounds__(THREADS) newton_box_kernel(const BoxArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* red = (T*)smem;
  T* fc = (T*)(smem + red_bytes<P, T>());
  int* ints = (int*)(smem + red_bytes<P, T>() + obj_bytes<T>());
  T* st = (T*)(smem + red_bytes<P, T>() + obj_bytes<T>() + INT_BYTES);
  const int tid = threadIdx.x, w = tid / WARP, lane = tid & (WARP - 1);
  const int K = a.K, N = a.N, S = a.stage;

  // The lanes not selected keep their start, grid-strided.
  if (a.sel != nullptr) {
    for (int i = blockIdx.x * THREADS + tid; i < K; i += gridDim.x * THREADS) {
      if (!a.sel[i]) {
#pragma unroll
        for (int p = 0; p < P; ++p) a.beta_out[(size_t)i * P + p] = a.beta_init[(size_t)i * P + p];
        a.ok_out[i] = 0;
        a.passes_out[i] = 0;
      }
    }
  }
  SelScan ss{0, 0, K};
  if (a.sel != nullptr) ss = sel_scan(a.sel, K, ints);
  const T log_min_mu = m_log(a.min_mu);

  for (int slot = blockIdx.x; slot < ss.total; slot += gridDim.x) {
    const int gi = a.sel != nullptr ? sel_lane(a.sel, K, ss, slot, ints + WARPS) : slot;
    const T* y = a.counts + (size_t)gi * N;
    for (int n = tid; n < S; n += THREADS) {
      st[n] = y[n];
      st[S + n] = __ldg(a.sf + n);
      st[2 * S + n] = __ldg(a.log_sf + n);
#pragma unroll
      for (int p = 0; p < P; ++p) st[(3 + p) * S + n] = __ldg(a.X + (size_t)n * P + p);
    }
    __syncthreads();
    const Row<P, T> row{y, a.sf, a.log_sf, a.X, st, N, S};

    T beta[P];
#pragma unroll
    for (int p = 0; p < P; ++p) beta[p] = a.beta_init[(size_t)gi * P + p];
    const T disp = a.disp[gi];
    const T r = T(1) / disp;
    T f = T(0), g[P], H[NTRI<P>];
    bool have_f = false, fixed = false;
    int passes = 0;
    for (int it = 0; it < a.maxiter; ++it) {
      grad_hess<P, T>(row, beta, disp, r, a.min_mu, red, g, H);
      ++passes;
      add_diag<P, T>(H, T(1e-6));
      add_diag<P, T>(H, T(1e-8));
      T step[P];
      sym_solve<T, P>(H, g, step);
      // the candidates, and in the first step the start's objective
      if (w < CANDS || !have_f) {
        T cand[P];
        if (w < CANDS) {
          candidate<P, T>(w, beta, step, a.max_beta, cand);
        } else {
#pragma unroll
          for (int p = 0; p < P; ++p) cand[p] = beta[p];
        }
        const T val = objective<P, T>(row, cand, r, a.min_mu, log_min_mu);
        if (lane == 0) fc[w] = val;
      }
      __syncthreads();
      ++passes;
      if (!have_f) {
        f = fc[CANDS];
        have_f = true;
      }
      int j = CANDS;
      for (int c = CANDS - 1; c >= 0; --c)
        if (fc[c] < f) j = c;
      if (j == CANDS) {  // a fixed point: every later step is this one
        fixed = true;
        break;
      }
      f = fc[j];
      T cand[P];
      candidate<P, T>(j, beta, step, a.max_beta, cand);
#pragma unroll
      for (int p = 0; p < P; ++p) beta[p] = cand[p];
      // fc is written again only after the next gradient pass's barriers
    }
    if (!fixed) {
      grad_hess<P, T>(row, beta, disp, r, a.min_mu, red, g, H);
      ++passes;
    }
    // a fixed point has the final gradient from its last step
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const bool pinned = (beta[p] <= a.lo_edge && g[p] > T(0)) || (beta[p] >= a.hi_edge && g[p] < T(0));
      if (pinned) g[p] = T(0);
    }
    if (tid == 0) {
#pragma unroll
      for (int p = 0; p < P; ++p) a.beta_out[(size_t)gi * P + p] = beta[p];
      a.ok_out[gi] = sup_norm<P, T>(g) < T(1e-5) ? 1 : 0;
      a.passes_out[gi] = passes;
    }
    __syncthreads();  // the stage, fc and the slot's lane are rewritten for the next lane
  }
}

template <int P, typename T> int launch(const BoxArgs<T>& a, cudaStream_t s) {
  constexpr auto kern = newton_box_kernel<P, T>;
  const size_t smem = smem_bytes<P, T>(a.stage);
  if (smem > SMEM_BLOCK_MAX) return (int)cudaErrorInvalidValue;
  // The blocks the card holds at once, asked once per device and size: the
  // occupancy API costs host time on every launch.
  static size_t asked[32] = {};  // smem + 1 of the last question, 0 for none
  static int held[32] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 32) return (int)cudaErrorInvalidDevice;
  if (asked[dev] != smem + 1) {
    int sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess) e = smem_opt_in<kern>(smem);
    if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, THREADS, smem);
    if (e != cudaSuccess) return (int)e;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    held[dev] = per_sm * sms;
    asked[dev] = smem + 1;
  }
  // at most the blocks the card holds at once, at most one a lane
  const int blocks = a.K < held[dev] ? a.K : held[dev];
  kern<<<blocks, THREADS, smem, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// counts (K, N), sf and log_sf (N,), X (N, P), disp (K,), beta_init and
// beta_out (K, P); sel (K,) bytes or NULL (every lane); ok_out (K,) bytes,
// passes (K,) int32. stage: the samples staged in shared memory
// (0..N; ops/irls.py:_box_plan).
extern "C" int newton_box_launch(int is_f64, int P, int K, int N, int stage, const void* counts, const void* sf,
                                 const void* log_sf, const void* X, const void* disp, const void* beta_init,
                                 const void* sel, double min_mu, double max_beta, int maxiter, void* beta_out,
                                 void* ok_out, void* passes, void* stream) {
  if (K <= 0) return (int)cudaSuccess;
  if (N < 0 || stage < 0 || stage > N || maxiter < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  // The edges are rounded to T as the JAX comparison rounds its weakly
  // typed bounds (-30 and 30 in float32).
  if (is_f64) {
    const BoxArgs<double> a{K, N, stage, (const double*)counts, (const double*)sf, (const double*)log_sf,
                            (const double*)X, (const double*)disp, (const double*)beta_init,
                            (const unsigned char*)sel, min_mu, max_beta, -max_beta + 1e-12, max_beta - 1e-12,
                            maxiter, (double*)beta_out, (unsigned char*)ok_out, (int*)passes};
    PDT_DISPATCH_P(P, return launch<PP, double>(a, s));
  } else {
    const BoxArgs<float> a{K, N, stage, (const float*)counts, (const float*)sf, (const float*)log_sf,
                           (const float*)X, (const float*)disp, (const float*)beta_init, (const unsigned char*)sel,
                           (float)min_mu, (float)max_beta, (float)(-max_beta + 1e-12), (float)(max_beta - 1e-12),
                           maxiter, (float*)beta_out, (unsigned char*)ok_out, (int*)passes};
    PDT_DISPATCH_P(P, return launch<PP, float>(a, s));
  }
  return (int)cudaErrorInvalidValue;
}
