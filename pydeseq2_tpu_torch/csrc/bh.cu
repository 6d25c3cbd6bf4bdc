// Benjamini-Hochberg over one shared order, as its callers use it: the
// rejection counts of every cutoff row (bh_count), and the adjusted values
// of the one row they pick (bh_adjust).
//
// Replaces the shared-order path of bh_adjust_masked
// (pydeseq2_tpu/ops/stats.py:145, lines 175-190) as device_padj runs it
// (fused.py:748-768): row j of the (rows, G) sweep adjusts p under the mask
// base_mean >= cutoffs[j] & valid & !isnan(p) (just valid & !isnan(p) when
// no cutoffs are given). With `order` the ascending stable order of p and
// n_valid the row's mask count, the masked element at sorted position i
// has rank r_i (the masked count up to i), its scaled value is
// c_i = p * n_valid / max(r_i, 1), and its adjusted value is the minimum of
// the scaled values from i to the end, clipped at 1. The products and
// quotients are those of the plain version and min is exact, so the two
// agree bit for bit.
//
// bh_count. Row j rejects where the adjusted value is below alpha, and the
// adjusted values only grow along the order, so num_rej[j] is the rank of
// the last masked position whose min(c_i, 1) < alpha (0 if none): no
// suffix minimum and no (rows, G) matrix. The rows' masks are nested once
// the cutoffs are sorted (NaN cutoffs last: they mask everything), so a
// gene is fully described by k, the number of sorted cutoffs at or below
// its base mean (0 when it is not valid): it lies in sorted rows 0..k-1.
// Two launches split the order into chunks of `chunk` positions, one a
// block. The first gathers p, valid and base_mean through the order once
// for all rows, stores p and k in sorted order, and counts each row's
// masked genes in its chunk (a histogram of k). The second sums the
// chunks' counts before its own (the rank offsets) and in all (n_valid),
// then walks its chunk 512 positions at a time, a warp a sorted row: a warp
// ballot of k > row gives the ranks from the row's running count, and the
// last rank that rejects is kept. One atomic max a row and block leaves
// num_rej.
//
// bh_adjust. One row (its index read from the card, so a caller's pick
// needs no host read), or every row, each on a thread-block cluster of K
// blocks (the fewest that cover G in one round, at most 16): the order is
// walked from the end in rounds of K x 4096 positions, block b of the
// cluster taking the b-th chunk from the end of the round; n_valid is the
// round's total where one round covers G, else a first sweep counts it. Each block scans
// its chunk's mask counts and scaled minima (block-wide exclusive scans) and
// exchanges the chunk totals through distributed shared memory, so every
// position gets its rank and suffix minimum; results go back to gene order
// through the order, NaN outside the mask.
//
// Bound on the H100 by the gathers through the order (p, order, valid,
// base_mean: 21 B a gene in float64) and, for bh_adjust, one row written.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;
using namespace pdt;

namespace {

// ---- bh_count ---------------------------------------------------------------
constexpr int CT = 512;             // threads of the count kernels, positions a tile
constexpr int CNW = CT / WARP;      // their warps
constexpr int MAX_ROWS = 256;       // rows a launch (the wrapper batches more)

// The order of the cutoffs: ascending, NaN last (all NaN equal).
template <typename T> __device__ __forceinline__ bool cut_less(T a, T b) {
  if (a != a) return false;
  if (b != b) return true;
  return a < b;
}

// s_cut: the R cutoffs ascending (ties in row order), s_row: their rows;
// s_tmp holds R values. Ends with a barrier.
template <typename T>
__device__ void sort_cutoffs(const T* cutoffs, int R, T* s_tmp, T* s_cut, int* s_row) {
  for (int r = threadIdx.x; r < R; r += blockDim.x) s_tmp[r] = cutoffs[r];
  __syncthreads();
  for (int r = threadIdx.x; r < R; r += blockDim.x) {
    const T c = s_tmp[r];
    int pos = 0;
    for (int q = 0; q < R; ++q) {
      const T d = s_tmp[q];
      pos += cut_less(d, c) || (!cut_less(c, d) && q < r);
    }
    s_cut[pos] = c;
    s_row[pos] = r;
  }
  __syncthreads();
}

// Whether min(q / rank, 1) < alpha, for q = p * n_valid as the plain
// version forms it, with the quotient's IEEE division made only where the
// sign of alpha rank - q (one fused multiply-add, rounded once: its sign is
// exact) leaves it open. With u the unit roundoff of T, a gap above
// 32 u alpha rank puts q / rank below alpha (1 - 16 u), so the rounded
// quotient lies below alpha; a negative gap puts it at or above alpha.
template <typename T> __device__ __forceinline__ bool rejects(T q, int rank, T alpha) {
  if (alpha > T(1)) return true;  // min(., 1) <= 1 < alpha (q is not NaN: p is masked in)
  const T r = T(rank);
  const T gap = fma(alpha, r, -q);
  const T k = sizeof(T) == 4 ? T(1.9073486328125e-06) : T(3.552713678800501e-15);  // 2^-19, 2^-48
  if (gap > alpha * r * k) return true;
  if (gap < T(0) || gap != gap) return false;
  const T c = q / r;
  return (c > T(1) ? T(1) : c) < alpha;
}

// The sorted cutoffs at or below bm (bm >= cut is a prefix of the sorted
// rows; a NaN on either side is never at or below).
template <typename T> __device__ __forceinline__ int rows_at_or_below(const T* s_cut, int R, T bm) {
  int lo = 0, hi = R;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (s_cut[mid] <= bm) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// Phase 1: gather through the order, stage p and k in sorted order, count
// each sorted row's masked genes in the block's chunk (cnt[row][block]).
template <typename T>
__global__ void __launch_bounds__(CT)
    bh_gather_kernel(int G, int R, int chunk, const T* __restrict__ p, const int* __restrict__ order,
                     const unsigned char* __restrict__ valid, const T* __restrict__ base_mean,
                     const T* __restrict__ cutoffs, T* __restrict__ p_sorted,
                     unsigned short* __restrict__ k_sorted, int* __restrict__ cnt,
                     long long* __restrict__ num_rej) {
  __shared__ T s_tmp[MAX_ROWS];
  __shared__ T s_cut[MAX_ROWS];
  __shared__ int s_row[MAX_ROWS];
  __shared__ int s_hist[MAX_ROWS + 1];
  for (int r = threadIdx.x; r <= R; r += CT) s_hist[r] = 0;
  if (blockIdx.x == 0)
    for (int r = threadIdx.x; r < R; r += CT) num_rej[r] = 0;
  if (base_mean != nullptr) sort_cutoffs(cutoffs, R, s_tmp, s_cut, s_row);
  else __syncthreads();
  const int start = (int)blockIdx.x * chunk;
  const int end = min(start + chunk, G);
  for (int i = start + (int)threadIdx.x; i < end; i += CT) {
    const int g = order[i];
    const T pg = p[g];  // the three gathers issued together
    const unsigned char vg = valid[g];
    const T bm = base_mean != nullptr ? base_mean[g] : T(0);
    const bool ok = vg != 0 && !(pg != pg);
    const int k = !ok ? 0 : (base_mean == nullptr ? 1 : rows_at_or_below(s_cut, R, bm));
    p_sorted[i] = pg;
    k_sorted[i] = (unsigned short)k;
    atomicAdd(&s_hist[k], 1);
  }
  __syncthreads();
  const int nb = (G + chunk - 1) / chunk;
  for (int r = threadIdx.x; r < R; r += CT) {
    int c = 0;
    for (int k = r + 1; k <= R; ++k) c += s_hist[k];
    cnt[(size_t)r * nb + blockIdx.x] = c;
  }
}

// Phase 2: each warp owns sorted rows w, w + 16, ... and walks the chunk
// 32 positions at a time for each: a ballot of k > row gives the ranks from
// the row's running count (the chunks before this one to start with), and
// the last rank that rejects is kept; one atomic max a row and block.
constexpr int ROWS_PER_WARP = MAX_ROWS / CNW;

template <typename T>
__global__ void __launch_bounds__(CT)
    bh_count_kernel(int G, int R, int chunk, const T* __restrict__ cutoffs, T alpha,
                    const T* __restrict__ p_sorted, const unsigned short* __restrict__ k_sorted,
                    const int* __restrict__ cnt, long long* __restrict__ num_rej) {
  __shared__ T s_tmp[MAX_ROWS];
  __shared__ T s_cut[MAX_ROWS];
  __shared__ int s_row[MAX_ROWS];
  __shared__ T s_p[CT];               // the tile's p, in sorted order
  __shared__ unsigned short s_k[CT];  // and k
  const int lane = threadIdx.x & (WARP - 1), w = threadIdx.x / WARP;
  const unsigned lt = (1u << lane) - 1u;
  if (cutoffs != nullptr) {
    sort_cutoffs(cutoffs, R, s_tmp, s_cut, s_row);
  } else if (threadIdx.x == 0) {
    s_row[0] = 0;
  }
  // The warp's rows: their masked counts before this chunk and in all.
  const int nb = (G + chunk - 1) / chunk;
  int running[ROWS_PER_WARP], best[ROWS_PER_WARP];
  T nv[ROWS_PER_WARP];
#pragma unroll
  for (int q = 0; q < ROWS_PER_WARP; ++q) {
    const int r = w + q * CNW;
    int before = 0, all = 0;
    if (r < R) {
      for (int b = lane; b < nb; b += WARP) {
        const int v = cnt[(size_t)r * nb + b];
        all += v;
        before += b < (int)blockIdx.x ? v : 0;
      }
    }
    running[q] = warp_sum_i(before);
    nv[q] = T(warp_sum_i(all));
    best[q] = 0;
  }

  const int start = (int)blockIdx.x * chunk;
  const int end = min(start + chunk, G);
  for (int base = start; base < end; base += CT) {
    const int i = base + (int)threadIdx.x;
    __syncthreads();  // the previous tile is read
    s_p[threadIdx.x] = i < end ? p_sorted[i] : T(0);
    s_k[threadIdx.x] = i < end ? k_sorted[i] : (unsigned short)0;
    __syncthreads();
    const int n = min(CT, end - base);
    for (int s = 0; s < n; s += WARP) {
      const T pg = s_p[s + lane];
      const int k = s + lane < n ? (int)s_k[s + lane] : 0;
#pragma unroll
      for (int q = 0; q < ROWS_PER_WARP; ++q) {
        const int r = w + q * CNW;
        if (r >= R) break;
        const bool m = r < k;
        const unsigned bits = __ballot_sync(FULL, m);
        const int rank = running[q] + __popc(bits & lt) + 1;
        if (m && rejects(pg * nv[q], rank, alpha)) best[q] = rank;  // ranks grow along the order
        running[q] += __popc(bits);
      }
    }
  }
#pragma unroll
  for (int q = 0; q < ROWS_PER_WARP; ++q) {
    const int r = w + q * CNW;
    int b = best[q];
#pragma unroll
    for (int o = WARP / 2; o > 0; o >>= 1) b = max(b, __shfl_xor_sync(FULL, b, o));
    if (r < R && lane == 0 && b > 0) atomicMax((unsigned long long*)(num_rej + s_row[r]), (unsigned long long)b);
  }
}

template <typename T>
int launch_count(int rows, int G, int chunk, const void* p, const void* order, const void* valid,
                 const void* base_mean, const void* cutoffs, double alpha, void* p_sorted, void* k_sorted,
                 void* cnt, void* num_rej, cudaStream_t s) {
  const int nb = (G + chunk - 1) / chunk;
  bh_gather_kernel<T><<<nb, CT, 0, s>>>(G, rows, chunk, (const T*)p, (const int*)order,
                                         (const unsigned char*)valid, (const T*)base_mean, (const T*)cutoffs,
                                         (T*)p_sorted, (unsigned short*)k_sorted, (int*)cnt, (long long*)num_rej);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  bh_count_kernel<T><<<nb, CT, 0, s>>>(G, rows, chunk, (const T*)cutoffs, (T)alpha, (const T*)p_sorted,
                                        (const unsigned short*)k_sorted, (const int*)cnt, (long long*)num_rej);
  return 0;
}

// ---- bh_adjust ---------------------------------------------------------------
constexpr int AT = 1024;
constexpr int ITEMS = 4;
constexpr int CHUNK = AT * ITEMS;
constexpr int ANW = AT / WARP;

struct SumOp {
  template <typename V> __device__ __forceinline__ V operator()(V a, V b) const { return a + b; }
};
struct MinOp {
  template <typename V> __device__ __forceinline__ V operator()(V a, V b) const {
    return b < a ? b : a;
  }
};

// Exclusive block scan of one value per thread (``identity`` for thread
// 0); also returns the block total. `smem` holds ANW values.
template <typename V, typename Op>
__device__ __forceinline__ V block_scan(V x, Op op, V identity, V* smem, V& total) {
  const int lane = threadIdx.x & (WARP - 1);
  const int warp = threadIdx.x / WARP;
#pragma unroll
  for (int o = 1; o < WARP; o <<= 1) {
    const V y = __shfl_up_sync(FULL, x, o);
    if (lane >= o) x = op(y, x);
  }
  V excl = __shfl_up_sync(FULL, x, 1);
  if (lane == 0) excl = identity;
  if (lane == WARP - 1) smem[warp] = x;
  __syncthreads();
  if (warp == 0) {
    V v = smem[lane];
#pragma unroll
    for (int o = 1; o < ANW; o <<= 1) {
      const V y = __shfl_up_sync(FULL, v, o);
      if (lane >= o) v = op(y, v);
    }
    smem[lane] = v;
  }
  __syncthreads();
  if (warp > 0) excl = op(smem[warp - 1], excl);
  total = smem[ANW - 1];
  __syncthreads();
  return excl;
}

// Warp 0 reads slot `src` of every block of the cluster: `before` combines
// those of the blocks below this one, `all` of every block (results in
// thread 0's registers; other threads get garbage).
template <typename V, typename Op>
__device__ __forceinline__ void cluster_gather(cg::cluster_group& cluster, V* src, Op op, V identity, V& before,
                                               V& all) {
  const int K = (int)cluster.num_blocks(), kb = (int)cluster.block_rank();
  if (threadIdx.x < WARP) {
    const int lane = threadIdx.x;
    const V v = lane < K ? *cluster.map_shared_rank(src, lane) : identity;
    V b = lane < kb ? v : identity;
    V a = v;
#pragma unroll
    for (int o = WARP / 2; o > 0; o >>= 1) {
      b = op(b, __shfl_xor_sync(FULL, b, o));
      a = op(a, __shfl_xor_sync(FULL, a, o));
    }
    before = b;
    all = a;
  }
}

template <typename T>
__global__ void __launch_bounds__(AT)
    bh_adjust_kernel(int G, int rows, const T* __restrict__ p, const int* __restrict__ order,
                     const unsigned char* __restrict__ valid, const T* __restrict__ base_mean,
                     const T* __restrict__ cutoffs, const long long* __restrict__ row_j, T* __restrict__ adj_out) {
  cg::cluster_group cluster = cg::this_cluster();
  const int K = (int)cluster.num_blocks(), kb = (int)cluster.block_rank();
  __shared__ int s_int[ANW];
  __shared__ T s_val[ANW];
  __shared__ int s_nv_slot;        // this block's mask count, for n_valid
  __shared__ int s_cnt_slot[2];    // this block's chunk count, by round parity
  __shared__ T s_min_slot[2];      // this block's chunk minimum, by round parity
  __shared__ int s_bc[2];          // counts: the blocks below, all blocks
  __shared__ T s_bm[2];            // minima: the blocks below, all blocks

  const int ci = (int)blockIdx.x / K;
  const long long jrow = row_j != nullptr ? *row_j : (long long)ci;
  const bool row_ok = jrow >= 0 && jrow < rows;
  T* adj = adj_out + (row_j != nullptr ? (size_t)0 : (size_t)ci * G);
  const T cut = (base_mean != nullptr && row_ok) ? cutoffs[jrow] : T(0);
  // The gathers of a gene issued together (no short circuit between them).
  auto in_mask = [&](int g, T& pg) {
    pg = p[g];
    const unsigned char vg = valid[g];
    const T bm = base_mean != nullptr ? base_mean[g] : T(0);
    return row_ok && vg != 0 && !(pg != pg) && (base_mean == nullptr || bm >= cut);
  };

  // n_valid of this row: counted over the cluster first where the order
  // takes more than one round; in one round it is the round's own total.
  const bool one_round = G <= K * CHUNK;
  int n_valid = 0;
  if (!one_round) {
    int cnt = 0;
    for (int g = kb * AT + (int)threadIdx.x; g < G; g += K * AT) {
      T pg;
      cnt += in_mask(g, pg);
    }
    int block_cnt;
    block_scan(cnt, SumOp(), 0, s_int, block_cnt);
    if (threadIdx.x == 0) s_nv_slot = block_cnt;
    cluster.sync();
    int unused, n_valid_all;
    cluster_gather(cluster, &s_nv_slot, SumOp(), 0, unused, n_valid_all);
    if (threadIdx.x == 0) s_bc[1] = n_valid_all;
    __syncthreads();
    n_valid = s_bc[1];
  }

  const T nan = Lim<T>::inf() - Lim<T>::inf();
  int carry_cnt = 0;            // masked count after the current round
  T carry_min = Lim<T>::inf();  // min scaled value after the current round
  int parity = 0;
  for (int end = G; end > 0; end -= K * CHUNK, parity ^= 1) {
    // Block kb takes sorted positions [end - (kb + 1) CHUNK, end - kb CHUNK);
    // thread t the reversed offsets t ITEMS + q, descending within a thread.
    const int sub_end = end - kb * CHUNK;
    int gs[ITEMS];
    bool ms[ITEMS];
    T ps[ITEMS];
    int local = 0;
#pragma unroll
    for (int q = 0; q < ITEMS; ++q) {
      const int i = sub_end - 1 - ((int)threadIdx.x * ITEMS + q);
      gs[q] = i >= 0 ? order[i] : -1;
    }
#pragma unroll
    for (int q = 0; q < ITEMS; ++q) {
      ms[q] = gs[q] >= 0 && in_mask(gs[q], ps[q]);
      local += ms[q];
    }
    int chunk_total;
    int after = block_scan(local, SumOp(), 0, s_int, chunk_total);
    if (threadIdx.x == 0) s_cnt_slot[parity] = chunk_total;
    cluster.sync();
    int cnt_before, cnt_all;
    cluster_gather(cluster, &s_cnt_slot[parity], SumOp(), 0, cnt_before, cnt_all);
    if (threadIdx.x == 0) {
      s_bc[0] = cnt_before;
      s_bc[1] = cnt_all;
    }
    __syncthreads();
    after += carry_cnt + s_bc[0];  // masked count after the thread's first element
    carry_cnt += s_bc[1];
    if (one_round) n_valid = s_bc[1];
    const T nv = T(n_valid);
    T scaled[ITEMS];
    T tmin = Lim<T>::inf();
#pragma unroll
    for (int q = 0; q < ITEMS; ++q) {
      if (ms[q]) {
        const T rank = T(n_valid - after);
        scaled[q] = ps[q] * nv / (rank < T(1) ? T(1) : rank);
        ++after;
      } else {
        scaled[q] = Lim<T>::inf();
      }
      tmin = MinOp()(tmin, scaled[q]);
    }
    T chunk_min;
    T run = block_scan(tmin, MinOp(), Lim<T>::inf(), s_val, chunk_min);
    if (threadIdx.x == 0) s_min_slot[parity] = chunk_min;
    cluster.sync();
    T min_before, min_all;
    cluster_gather(cluster, &s_min_slot[parity], MinOp(), Lim<T>::inf(), min_before, min_all);
    if (threadIdx.x == 0) {
      s_bm[0] = min_before;
      s_bm[1] = min_all;
    }
    __syncthreads();
    run = MinOp()(MinOp()(carry_min, s_bm[0]), run);  // suffix minimum after the thread's first element
    carry_min = MinOp()(carry_min, s_bm[1]);
#pragma unroll
    for (int q = 0; q < ITEMS; ++q) {
      if (gs[q] < 0) continue;
      run = MinOp()(run, scaled[q]);
      adj[gs[q]] = ms[q] ? (run > T(1) ? T(1) : run) : nan;  // clip at 1
    }
    __syncthreads();  // s_bc and s_bm are rewritten in the next round
  }
  cluster.sync();  // no block leaves while another reads its shared memory
}

template <typename T>
int launch_adjust(int rows, int G, const void* p, const void* order, const void* valid, const void* base_mean,
                  const void* cutoffs, const void* row_j, int n_out, int K, void* adj, cudaStream_t s) {
  auto kern = bh_adjust_kernel<T>;
  static unsigned opted = 0;  // a bit per device: 16-block clusters allowed
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess && dev < 32 && !((opted >> dev) & 1u)) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e == cudaSuccess) opted |= 1u << dev;
  }
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(n_out, K, AT, 0, s, &attr);
  return (int)cudaLaunchKernelEx(&cfg, kern, G, rows, (const T*)p, (const int*)order, (const unsigned char*)valid,
                                 (const T*)base_mean, (const T*)cutoffs, (const long long*)row_j, (T*)adj);
}

}  // namespace

// The rejection counts num_rej (rows,) int64 of `rows` <= 256 cutoff rows
// (one row, valid & !isnan(p), when base_mean and cutoffs are NULL), in
// two launches over chunks of `chunk` positions; p_sorted (G,) of p's
// type, k_sorted (G,) uint16 and cnt (ceil(G / chunk) x rows,) int32 are
// the launches' workspace.
extern "C" int bh_count_launch(int is_f64, int rows, int G, int chunk, const void* p, const void* order,
                               const void* valid, const void* base_mean, const void* cutoffs, double alpha,
                               void* p_sorted, void* k_sorted, void* cnt, void* num_rej, void* stream) {
  if (rows <= 0) return (int)cudaSuccess;
  if ((base_mean == nullptr) != (cutoffs == nullptr)) return (int)cudaErrorInvalidValue;
  if (rows > MAX_ROWS || (base_mean == nullptr && rows != 1) || chunk <= 0 || chunk % CT != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (G <= 0) return (int)cudaMemsetAsync(num_rej, 0, sizeof(long long) * (size_t)rows, s);
  const int rc = is_f64 ? launch_count<double>(rows, G, chunk, p, order, valid, base_mean, cutoffs, alpha, p_sorted,
                                               k_sorted, cnt, num_rej, s)
                        : launch_count<float>(rows, G, chunk, p, order, valid, base_mean, cutoffs, alpha, p_sorted,
                                              k_sorted, cnt, num_rej, s);
  return rc != 0 ? rc : (int)cudaGetLastError();
}

// The adjusted values adj: with row_j (a 0-d int64 on the card) the one
// row *row_j of `rows`, into adj (G,); else rows 0..n_out - 1, into adj
// (n_out, G). Each row on a cluster of `cluster` blocks (1-16; 0: the
// fewest that cover G in one round). A row index outside [0, rows) gives a
// row of NaN.
extern "C" int bh_adjust_launch(int is_f64, int rows, int G, const void* p, const void* order, const void* valid,
                                const void* base_mean, const void* cutoffs, const void* row_j, int n_out,
                                int cluster, void* adj, void* stream) {
  if (n_out <= 0 || G <= 0) return (int)cudaSuccess;
  if ((base_mean == nullptr) != (cutoffs == nullptr)) return (int)cudaErrorInvalidValue;
  if ((row_j != nullptr && n_out != 1) || (row_j == nullptr && n_out > rows)) return (int)cudaErrorInvalidValue;
  int K = cluster;
  if (K == 0) {
    const long long need = ((long long)G + CHUNK - 1) / CHUNK;
    K = (int)(need < MAX_CLUSTER ? need : MAX_CLUSTER);
  }
  if (K < 1 || K > MAX_CLUSTER) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int rc = is_f64 ? launch_adjust<double>(rows, G, p, order, valid, base_mean, cutoffs, row_j, n_out, K, adj, s)
                        : launch_adjust<float>(rows, G, p, order, valid, base_mean, cutoffs, row_j, n_out, K, adj, s);
  return rc != 0 ? rc : (int)cudaGetLastError();
}
