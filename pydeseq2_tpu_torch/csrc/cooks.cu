// Cook's distances and the Cook's outlier flag, a warp or a block per gene,
// with the outputs of the Cook's-refit mode.
//
// Replaces the trimmed moments of the Cook's robust dispersion
// (pydeseq2_tpu/ops/stats.py:88,108 trimmed_variance and
// trimmed_cell_variance, with ops/select.py:166 trimmed_mean_select), the
// elementwise block after them (fused.py:702-716) and the refit-mode bits
// of the streamed pipeline (fused_stream.py:422-445).
//
// For each gene the group (one warp, or one block on long rows: the launch
// plan, ops/stats.py:_trim_plan) first forms the normalised counts
// x_n = y_n / sf_n of its row once, sums them for m = mean_n x_n and stages
// the keys (trimmed.cuh) of the cohorts' members, cohort after cohort, in
// shared memory (or in the plan's global workspace where they do not fit).
// For each cohort it computes
//   rm  = trimmed mean of x, dropping floor(n trim) at each end,
//   v_c = scale_c * trimmed mean of (x - rm)^2, the squared errors formed
//         from the staged keys in place,
// and v = max_c v_c, each trimmed mean by trimmed.cuh's rank count (short
// cohorts) or radix select (long ones), summed in float64 and rounded once.
//
// Then disp_c = max((v - m)/m^2, 0.04), and per sample cooks = (y - mu)^2 /
// ((mu + disp_c mu^2) P) * H / (1 - H)^2. A gene is flagged when a
// use_for_max sample's distance exceeds the cutoff and fewer than 3 samples
// have a count above that of the sample with the largest distance (the
// first argmax over ALL samples, a NaN counting as the largest);
// outlier = flagged & non_zero, and cooks (written only when asked) is NaN
// where the gene is not non_zero.
//
// Refit mode (a replaceable mask is given): the last pass also writes the
// per-cell bits cooks > cutoff packed 32 to a word, bit k of word w for
// sample 32 w + k; each warp walks its 32-sample chunks, so lane k holds
// sample 32 w + k and one ballot is the word. replaced = any bit &
// non_zero, and outlier_refit = (a use_for_max, non-replaceable sample
// exceeds the cutoff) & the same count veto & non_zero.
//
// Bound on the H100 by its bytes: counts, mu and H read and cooks written,
// 4 x G x N values (3 without the distances, plus G N / 8 bytes of bits).
// The trimmed moments read only the staged row.
#include "trimmed.cuh"

using namespace pdt;

namespace {

// (value, index) of the first maximum, a NaN counting as the largest
// (jnp.argmax): does (vb, ib) beat (va, ia)?
template <typename T> __device__ __forceinline__ bool beats(T vb, int ib, T va, int ia) {
  const bool na = va != va, nb = vb != vb;
  if (na || nb) return nb && (!na || ib < ia);
  return vb > va || (vb == va && ib < ia);
}

// The group's first argmax; every thread returns it. (beats is a total
// order, so the warps' results may be folded in any order.)
template <typename T, typename Grp>
__device__ void group_argmax(const Grp& g, T& best, int& best_i) {
#pragma unroll
  for (int o = WARP / 2; o > 0; o >>= 1) {
    const T vb = __shfl_xor_sync(FULL, best, o);
    const int ib = __shfl_xor_sync(FULL, best_i, o);
    if (beats(vb, ib, best, best_i)) {
      best = vb;
      best_i = ib;
    }
  }
  if constexpr (Grp::BLOCK) {
    __syncthreads();
    if ((threadIdx.x & (WARP - 1)) == 0) {
      g.red[g.warp()] = double(best);  // exact, NaN included
      g.redi[g.warp()] = best_i;
    }
    __syncthreads();
    for (int w = 0; w < g.nwarps(); ++w) {
      const T vb = T(g.red[w]);
      if (beats(vb, g.redi[w], best, best_i)) {
        best = vb;
        best_i = g.redi[w];
      }
    }
  }
}

template <typename T> struct CooksArgs {
  int G, N, P;
  const T* counts;
  const T* sf;
  const T* mu;
  const T* H;
  const unsigned char* non_zero;
  const unsigned char* ufm;
  const T* cutoff;
  int C;
  const int* pos;
  const int* offsets;
  const int* ntrim;
  const T* scale;
  const unsigned char* repl;
  T* cooks;
  unsigned char* outlier;
  T* disp;
  int* packed;
  unsigned char* replaced;
  unsigned char* refit;
  int rank_max, n_max, n_members;
};

// One gene on one group; keys (n_members) is the group's staging buffer,
// hist and bnd its trimmed-mean scratch.
template <typename T, typename Grp>
__device__ void cooks_gene(const CooksArgs<T>& a, int gi, typename KeyOf<T>::U* keys, unsigned* hist,
                           typename KeyOf<T>::U* bnd, const Grp& g) {
  using K = KeyOf<T>;
  const int N = a.N, me = g.rank(), step = g.size();
  const int lane = threadIdx.x & (WARP - 1);
  const T* y = a.counts + (size_t)gi * N;
  const T* mu = a.mu + (size_t)gi * N;
  const T* H = a.H + (size_t)gi * N;

  // ---- y / sf once a sample: m = its mean over all N, and the keys of
  // the cohorts' members at their places pos[n], cohort after cohort ----
  double msum = 0.0;
  for (int n = me; n < N; n += step) {
    const T x = y[n] / __ldg(a.sf + n);
    msum += double(x);
    const int p = __ldg(a.pos + n);
    if (p >= 0) keys[p] = K::key(x);
  }
  const T m = T(g.sum(msum)) / T(N);
  g.sync();

  // ---- robust dispersion: max over cohorts of the trimmed variance ----
  T v = T(0);
  for (int c = 0; c < a.C; ++c) {
    typename K::U* ck = keys + __ldg(a.offsets + c);
    const int n = __ldg(a.offsets + c + 1) - __ldg(a.offsets + c);
    const int k = __ldg(a.ntrim + c);
    const T rm = trimmed_mean_keys<T>(ck, n, k, a.rank_max, hist, bnd, g);
    for (int i = me; i < n; i += step) {
      const T d = K::value(ck[i]) - rm;
      ck[i] = K::key(d * d);
    }
    g.sync();
    const T vc = __ldg(a.scale + c) * trimmed_mean_keys<T>(ck, n, k, a.rank_max, hist, bnd, g);
    v = c == 0 ? vc : m_max(v, vc);
  }
  const T disp_c = m_max((v - m) / (m * m), T(0.04));

  // ---- Cook's distances, cutoff tests, exceed bits, first argmax ----
  // Each warp walks the 32-sample chunks w = warp, warp + nwarps, ...
  const bool nz = a.non_zero[gi] != 0;
  const T cutoff = *a.cutoff;
  const T nan = Lim<T>::inf() - Lim<T>::inf();
  const bool refit = a.repl != nullptr;
  const int W = (N + WARP - 1) / WARP;
  bool flagged = false, flagged_nr = false, any_exceeds = false;
  T best = -Lim<T>::inf();
  int best_i = 0x7fffffff;
  for (int base = g.warp() * WARP; base < N; base += g.nwarps() * WARP) {
    const int n = base + lane;
    bool exceeds = false;
    if (n < N) {
      const T mun = mu[n];
      const T Hn = H[n];
      const T V = mun + disp_c * (mun * mun);
      const T r = y[n] - mun;
      const T sp = r * r / (V * T(a.P));
      const T omh = T(1) - Hn;
      const T cd = sp * Hn / (omh * omh);
      exceeds = cd > cutoff;
      flagged = flagged || (a.ufm[n] != 0 && exceeds);
      if (beats(cd, n, best, best_i)) {
        best = cd;
        best_i = n;
      }
      if (a.cooks != nullptr) a.cooks[(size_t)gi * N + n] = nz ? cd : nan;
      if (refit) flagged_nr = flagged_nr || (a.ufm[n] != 0 && a.repl[n] == 0 && exceeds);
    }
    if (refit) {
      const unsigned word = __ballot_sync(FULL, exceeds);
      any_exceeds = any_exceeds || word != 0u;
      if (lane == 0) a.packed[(size_t)gi * W + base / WARP] = (int)word;
    }
  }
  flagged = g.any(flagged);
  flagged_nr = g.any(flagged_nr);
  any_exceeds = g.any(any_exceeds);
  group_argmax(g, best, best_i);
  const T max_count = y[best_i];
  int above = 0;
  for (int n = me; n < N; n += step) above += y[n] > max_count;
  above = g.sum(above);
  if (me == 0) {
    a.outlier[gi] = (flagged && above < 3 && nz) ? 1 : 0;
    a.disp[gi] = disp_c;
    if (refit) {
      a.replaced[gi] = (any_exceeds && nz) ? 1 : 0;
      a.refit[gi] = (flagged_nr && above < 3 && nz) ? 1 : 0;
    }
  }
  g.sync();  // the staging buffers are reused by the next gene
}

// A warp a gene, TRIM_WARPS genes a block, each warp its own slice of the
// dynamic shared memory.
template <typename T>
__global__ void __launch_bounds__(TRIM_WARPS * WARP) cooks_warp_kernel(const CooksArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int w = threadIdx.x / WARP;
  using U = typename KeyOf<T>::U;
  const bool radix = a.n_max > a.rank_max;
  const size_t group = trim_group_bytes(a.n_members, (int)sizeof(T), radix, true, false);
  const TrimSlice<U> sl(smem + w * group, a.n_members, radix, true, false, nullptr);
  const WarpGroup g{};
  for (int gi = blockIdx.x * TRIM_WARPS + w; gi < a.G; gi += gridDim.x * TRIM_WARPS)
    cooks_gene<T>(a, gi, sl.keys, sl.hist, sl.bnd, g);
}

// A block a gene; the grid loops over the genes. shared: the keys in
// dynamic shared memory, else in the block's slice of the workspace ws
// (trim_ws_len values a block).
template <typename T>
__global__ void __launch_bounds__(TRIM_BLOCK_MAX) cooks_block_kernel(const CooksArgs<T> a, bool shared, T* ws) {
  extern __shared__ __align__(16) unsigned char smem[];
  using U = typename KeyOf<T>::U;
  const bool radix = a.n_max > a.rank_max;
  U* slice = shared ? nullptr : (U*)ws + blockIdx.x * trim_ws_len(a.n_members, (int)sizeof(T));
  const TrimSlice<U> sl(smem, a.n_members, radix, shared, true, slice);
  const BlockGroup g{sl.red, sl.redi};
  for (int gi = blockIdx.x; gi < a.G; gi += gridDim.x) cooks_gene<T>(a, gi, sl.keys, sl.hist, sl.bnd, g);
}

template <typename T>
int launch(const CooksArgs<T>& a, int block, int threads, int shared, int blocks, void* ws, cudaStream_t s) {
  const bool radix = a.n_max > a.rank_max;
  const size_t group = trim_group_bytes(a.n_members, (int)sizeof(T), radix, shared != 0, block != 0);
  if (!block) {
    const size_t smem = TRIM_WARPS * group;
    if (!shared || smem > SMEM_BLOCK_MAX) return (int)cudaErrorInvalidValue;
    cudaError_t e = smem_opt_in<cooks_warp_kernel<T>>(SMEM_BLOCK_MAX);
    if (e != cudaSuccess) return (int)e;
    const unsigned grid = (unsigned)((a.G + TRIM_WARPS - 1) / TRIM_WARPS);
    cooks_warp_kernel<T><<<grid, TRIM_WARPS * WARP, smem, s>>>(a);
    return (int)cudaGetLastError();
  }
  if (threads < BlockGroup::MIN_SIZE || threads > TRIM_BLOCK_MAX || threads % WARP != 0 || group > SMEM_BLOCK_MAX ||
      (!shared && (ws == nullptr || blocks < 1)))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = smem_opt_in<cooks_block_kernel<T>>(SMEM_BLOCK_MAX);
  if (e != cudaSuccess) return (int)e;
  const unsigned grid = (unsigned)(shared ? a.G : (blocks < a.G ? blocks : a.G));
  cooks_block_kernel<T><<<grid, threads, group, s>>>(a, shared != 0, (T*)ws);
  return (int)cudaGetLastError();
}

}  // namespace

// cooks may be NULL (no distances written); repl NULL switches the refit
// outputs (packed, replaced, refit) off, else all three must be given.
// pos (N,): the place of each sample among the cohorts' members (cohort 0's
// members in sample order, then cohort 1's, ...; -1 outside every cohort),
// offsets (C + 1,) the cohorts' first places, n_members = offsets[C].
// The plan (ops/stats.py:TrimPlan): block (a block of `threads` a gene,
// else a warp), rank_max (cohorts of at most this many members take the
// rank count, <= 128), shared (staged keys in shared memory, else in ws:
// `blocks` slices of trim_ws_len(n_members) values, the grid then `blocks`
// blocks), n_max the longest cohort.
extern "C" int cooks_launch(int is_f64, int G, int N, int P, const void* counts, const void* sf,
                            const void* mu, const void* H, const void* non_zero, const void* ufm,
                            const void* cutoff, int C, const void* pos, const void* offsets,
                            const void* ntrim, const void* scale, const void* repl, void* cooks,
                            void* outlier, void* disp, void* packed, void* replaced, void* refit,
                            int block, int threads, int rank_max, int shared, int blocks, int n_max, int n_members,
                            void* ws, void* stream) {
  if (G <= 0) return (int)cudaSuccess;
  if (N <= 0 || C <= 0 || n_max < 1 || n_max > n_members || n_members > N || rank_max < 0 || rank_max > RANK_CAP)
    return (int)cudaErrorInvalidValue;
  if (repl != nullptr && (packed == nullptr || replaced == nullptr || refit == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_f64) {
    const CooksArgs<double> a{G, N, P, (const double*)counts, (const double*)sf, (const double*)mu,
                              (const double*)H, (const unsigned char*)non_zero, (const unsigned char*)ufm,
                              (const double*)cutoff, C, (const int*)pos, (const int*)offsets, (const int*)ntrim,
                              (const double*)scale, (const unsigned char*)repl, (double*)cooks,
                              (unsigned char*)outlier, (double*)disp, (int*)packed, (unsigned char*)replaced,
                              (unsigned char*)refit, rank_max, n_max, n_members};
    return launch<double>(a, block, threads, shared, blocks, ws, s);
  }
  const CooksArgs<float> a{G, N, P, (const float*)counts, (const float*)sf, (const float*)mu, (const float*)H,
                           (const unsigned char*)non_zero, (const unsigned char*)ufm, (const float*)cutoff, C,
                           (const int*)pos, (const int*)offsets, (const int*)ntrim, (const float*)scale,
                           (const unsigned char*)repl, (float*)cooks, (unsigned char*)outlier, (float*)disp,
                           (int*)packed, (unsigned char*)replaced, (unsigned char*)refit, rank_max, n_max, n_members};
  return launch<float>(a, block, threads, shared, blocks, ws, s);
}
