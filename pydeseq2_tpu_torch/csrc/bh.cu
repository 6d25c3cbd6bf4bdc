// Batched Benjamini-Hochberg sweep over one shared order, one block per row.
//
// Replaces the shared-order path of bh_adjust_masked
// (pydeseq2_tpu/ops/stats.py:145, lines 175-190) as device_padj runs it
// (fused.py:748-762): row j of the (rows, G) sweep adjusts p under the mask
// base_mean >= cutoffs[j] & valid & !isnan(p) (just valid & !isnan(p) when
// no cutoffs are given), and the masks are evaluated here, never stored.
//
// With `order` the ascending stable order of p and n_valid the row's mask
// count, the masked element at sorted position i has rank
// n_valid - (masked count after i), its scaled value is
// p * n_valid / max(rank, 1), and its adjusted value is the minimum of the
// scaled values from i to the end, clipped at 1. So one walk from the end of
// the order gives everything: the block takes the sorted positions in
// chunks of THREADS x ITEMS from the back, and two block-wide exclusive
// scans per chunk (a sum of the mask, then a min of the scaled values, each
// carried across chunks) produce ranks and suffix minima. Results go back to
// gene order through the order; entries outside the mask are NaN, and the
// row's count of adjusted values below alpha is its num_rej.
//
// The products and quotients are those of the plain version and min is
// exact, so the two agree bit for bit. Per row it reads the order and
// gathers p, valid and base_mean through it (L2-resident at 60000 genes):
// bound by those gathers and the scans' barriers, not by the card's bytes.
#include "common.cuh"

using namespace pdt;

namespace {

constexpr int THREADS = 1024;
constexpr int ITEMS = 4;
constexpr int CHUNK = THREADS * ITEMS;
constexpr int NWARPS = THREADS / WARP;

struct SumOp {
  template <typename V> __device__ __forceinline__ V operator()(V a, V b) const { return a + b; }
};
struct MinOp {
  template <typename V> __device__ __forceinline__ V operator()(V a, V b) const {
    return b < a ? b : a;
  }
};

// Exclusive block scan of one value per thread (``identity`` for thread
// 0); also returns the block total. `smem` holds NWARPS values.
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
    V w = smem[lane];
#pragma unroll
    for (int o = 1; o < NWARPS; o <<= 1) {
      const V y = __shfl_up_sync(FULL, w, o);
      if (lane >= o) w = op(y, w);
    }
    smem[lane] = w;
  }
  __syncthreads();
  if (warp > 0) excl = op(smem[warp - 1], excl);
  total = smem[NWARPS - 1];
  __syncthreads();
  return excl;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    bh_kernel(int G, const T* __restrict__ p, const int* __restrict__ order,
              const unsigned char* __restrict__ valid, const T* __restrict__ base_mean,
              const T* __restrict__ cutoffs, T alpha, T* __restrict__ adj_out,
              long long* __restrict__ num_rej) {
  __shared__ int s_int[NWARPS];
  __shared__ T s_val[NWARPS];
  const int row = blockIdx.x;
  const T cut = base_mean ? cutoffs[row] : T(0);
  auto in_mask = [&](int g) {
    const T pg = p[g];
    return valid[g] != 0 && !(pg != pg) && (!base_mean || base_mean[g] >= cut);
  };

  // n_valid of this row
  int cnt = 0;
  for (int g = threadIdx.x; g < G; g += THREADS) cnt += in_mask(g);
  int n_valid;
  block_scan(cnt, SumOp(), 0, s_int, n_valid);
  const T nv = T(n_valid);

  T* adj = adj_out + (size_t)row * G;
  const T nan = Lim<T>::inf() - Lim<T>::inf();
  int carry_cnt = 0;           // masked count after the current chunk
  T carry_min = Lim<T>::inf();  // min scaled value after the current chunk
  int rejected = 0;
  for (int end = G; end > 0; end -= CHUNK) {
    // Thread t takes reversed positions r = t * ITEMS + k, i.e. sorted
    // positions i = end - 1 - r (descending within the thread).
    int gs[ITEMS];
    bool ms[ITEMS];
    T ps[ITEMS];
    int local = 0;
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      const int i = end - 1 - (threadIdx.x * ITEMS + k);
      gs[k] = i >= 0 ? order[i] : -1;
      ms[k] = gs[k] >= 0 && in_mask(gs[k]);
      ps[k] = ms[k] ? p[gs[k]] : T(0);
      local += ms[k];
    }
    int chunk_total;
    // masked count after the thread's first element
    int after = carry_cnt + block_scan(local, SumOp(), 0, s_int, chunk_total);
    T scaled[ITEMS];
    T tmin = Lim<T>::inf();
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      if (ms[k]) {
        const T rank = T(n_valid - after);
        scaled[k] = ps[k] * nv / (rank < T(1) ? T(1) : rank);
        ++after;
      } else {
        scaled[k] = Lim<T>::inf();
      }
      tmin = MinOp()(tmin, scaled[k]);
    }
    T chunk_min;
    // suffix minimum after the thread's first element
    T run = MinOp()(carry_min, block_scan(tmin, MinOp(), Lim<T>::inf(), s_val, chunk_min));
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      if (gs[k] < 0) continue;
      run = MinOp()(run, scaled[k]);
      if (ms[k]) {
        const T a = run > T(1) ? T(1) : run;  // clip at 1
        adj[gs[k]] = a;
        rejected += a < alpha;
      } else {
        adj[gs[k]] = nan;
      }
    }
    carry_cnt += chunk_total;
    carry_min = MinOp()(carry_min, chunk_min);
  }
  int total_rej;
  block_scan(rejected, SumOp(), 0, s_int, total_rej);
  if (threadIdx.x == 0) num_rej[row] = total_rej;
}

template <typename T>
int launch(int rows, int G, const void* p, const void* order, const void* valid,
           const void* base_mean, const void* cutoffs, double alpha, void* adj, void* num_rej,
           cudaStream_t s) {
  bh_kernel<T><<<rows, THREADS, 0, s>>>(G, (const T*)p, (const int*)order,
                                        (const unsigned char*)valid, (const T*)base_mean,
                                        (const T*)cutoffs, (T)alpha, (T*)adj,
                                        (long long*)num_rej);
  return 0;
}

}  // namespace

extern "C" int bh_launch(int is_f64, int rows, int G, const void* p, const void* order,
                         const void* valid, const void* base_mean, const void* cutoffs,
                         double alpha, void* adj, void* num_rej, void* stream) {
  if (rows <= 0) return (int)cudaSuccess;
  if ((base_mean == nullptr) != (cutoffs == nullptr)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_f64) {
    launch<double>(rows, G, p, order, valid, base_mean, cutoffs, alpha, adj, num_rej, s);
  } else {
    launch<float>(rows, G, p, order, valid, base_mean, cutoffs, alpha, adj, num_rej, s);
  }
  return (int)cudaGetLastError();
}
