// Exact order statistics per column by radix select over a thread-block
// cluster.
//
// Replaces order_stats_select (pydeseq2_tpu/ops/select.py:65), the JAX
// package's MSB-first radix bisection over monotone unsigned keys. x is
// read where it lies: C columns of L values, value (c, i) at x[c sC + i sL]
// (the (G, N) log-ratio tile reduced over axis 0 has sC = 1, sL = N; a
// column of a (L, 1) view sC = sL = 1). Each column asks for two ranks
// (k_lo, k_hi), resolved together.
//
// A launch runs one cluster of K blocks a group of B adjacent columns (the
// plan's, ops/select.py:_select_plan, B <= 2): block q of the cluster takes
// rows [q R, q R + R) of the group's columns, loaded with consecutive
// threads on a row's adjacent columns. In shared mode a block maps its values
// to keys once, into shared memory; every pass then reads shared memory,
// never x again. A pass histograms the next 8-bit digit of the keys that match a rank's resolved prefix, for both
// ranks of each column; from the second pass on it also compacts those keys
// in place, so a pass visits only the keys that still match. The K blocks
// add their integer histograms over distributed shared memory (each block
// totals a slice of the bins, then every block gathers the totals), and
// every block picks the same digit: 4 passes for f32 keys, 8 for f64
// (a kernel_bench sweep found 9-11-bit digits slower at every shape, the
// scan of their bins and the exchange outweighing a pass over the
// compacted candidates). A warp's
// lanes take one column's keys; where they all fall in one bin, one lane
// adds their count, else each key adds one. Where the keys do not fit K <= 16
// blocks' shared memory (streamed mode), each pass reads the block's share
// from x again, with no compaction. The decoded key is the element a sort
// puts at that rank, so the result is bit-identical to a sort, and integer
// counts make it the same in every launch.
//
// Bound on the H100 by the bytes it reads (each value once in shared mode)
// and, at small tiles, by the fixed cost of a pass (two cluster barriers,
// the bins' exchange and scan); log-ratios share their sign and exponent
// bits, so the first passes' digits collide on a few bins, where the
// shared-memory atomics serialise.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;
using namespace pdt;

namespace {

template <typename T> struct KeyOf;
template <> struct KeyOf<float> {
  using K = uint32_t;
  static constexpr int BITS = 32;
  static __device__ __forceinline__ K key(float v) {
    uint32_t u = __float_as_uint(v);
    return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  }
  static __device__ __forceinline__ float val(K k) {
    uint32_t u = (k & 0x80000000u) ? (k ^ 0x80000000u) : ~k;
    return __uint_as_float(u);
  }
};
template <> struct KeyOf<double> {
  using K = unsigned long long;
  static constexpr int BITS = 64;
  static __device__ __forceinline__ K key(double v) {
    K u = (K)__double_as_longlong(v);
    const K top = 0x8000000000000000ull;
    return (u & top) ? ~u : (u | top);
  }
  static __device__ __forceinline__ double val(K k) {
    const K top = 0x8000000000000000ull;
    K u = (k & top) ? (k ^ top) : ~k;
    return __longlong_as_double((long long)u);
  }
};

constexpr int THREADS = 512;
constexpr int MAX_B = 2;  // columns a group (8 bytes of a row)
constexpr int DIGIT = 8;  // bits a pass
constexpr int NB = 1 << DIGIT;  // bins of a (column, rank)
constexpr size_t STATE_BYTES = 512;  // the columns' prefixes, ranks, counts and flags
constexpr int PER = 4;                // keys a thread takes at once (loads in flight, keys a round)

template <typename T> struct SelArgs {
  const T* x;
  long long sC, sL;  // element strides of a column and of a row
  int C, L;
  int B;          // columns a group
  int R, Rp;      // rows a block, and their stride in shared memory
  bool staged;    // keys in shared memory (else re-read from x each pass)
  const int* k_lo;
  const int* k_hi;
  T* out_lo;
  T* out_hi;
};

// Bytes of the three bin arrays (two histogram buffers, one of gathered
// totals), each B x 2 ranks x NB 32-bit counts.
__host__ __device__ inline size_t bins_bytes(int B) { return 3 * align16((size_t)B * 2 * NB * 4); }

template <typename T>
__global__ void __launch_bounds__(THREADS) select_kernel(SelArgs<T> a) {
  using KO = KeyOf<T>;
  using K = typename KO::K;
  cg::cluster_group cluster = cg::this_cluster();
  const int Kc = (int)cluster.num_blocks();
  const int q = (int)cluster.block_rank();
  const int c0 = (int)(blockIdx.x / (unsigned)Kc) * a.B;
  const int Bg = min(a.B, a.C - c0);
  const int r0 = q * a.R;
  const int Rq = max(0, min(a.R, a.L - r0));
  const int tid = threadIdx.x, lane = tid & (WARP - 1), warp = tid / WARP;
  const int HB = a.B * 2 * NB;  // words of one bin array
  const size_t hb_bytes = align16((size_t)HB * 4);

  // All of it dynamic (a static array would lower the 227 KB a block may
  // opt in to): the columns' state, then the bins, then the keys.
  extern __shared__ __align__(16) unsigned char smem[];
  K(*s_prefix)[2] = (K(*)[2])smem;                                  // [MAX_B][2]
  int(*s_rank)[2] = (int(*)[2])(smem + MAX_B * 2 * sizeof(K));      // [MAX_B][2]
  int* s_n = (int*)(smem + MAX_B * 2 * (sizeof(K) + sizeof(int)));  // candidates of a column here
  int* s_cnt = s_n + MAX_B;                                         // the compaction's next slot
  int* s_same = s_cnt + MAX_B;  // the column's two ranks share their prefix: one histogram serves both
  unsigned char* bins = smem + STATE_BYTES;
  unsigned* hist[2] = {(unsigned*)bins, (unsigned*)(bins + hb_bytes)};
  unsigned* tot = (unsigned*)(bins + 2 * hb_bytes);
  K* keys = (K*)(bins + bins_bytes(a.B));

  // columns adjacent in memory: consecutive threads take one row's columns
  const bool cols_fast = a.sC == 1 && a.B > 1;
  auto addr = [&](int col, int row) -> const T* {
    return a.x + (long long)(c0 + col) * a.sC + (long long)(r0 + row) * a.sL;
  };

  for (int i = tid; i < 2 * HB; i += THREADS) (i < HB ? hist[0] : hist[1])[i % HB] = 0u;
  if (tid < MAX_B) {
    const bool in = tid < Bg;
    s_rank[tid][0] = in ? a.k_lo[c0 + tid] : 0;
    s_rank[tid][1] = in ? a.k_hi[c0 + tid] : 0;
    s_prefix[tid][0] = s_prefix[tid][1] = K(0);
    s_n[tid] = Rq;
    s_same[tid] = 1;
  }
  const int n_items = Bg * Rq;
  // item i of the block's share: (column, row), adjacent columns fastest
  // where they are adjacent in memory
  auto item = [&](int i, int& col, int& row) {
    col = cols_fast ? i % Bg : i / Rq;
    row = cols_fast ? i / Bg : i % Rq;
  };
  if (a.staged) {
    // PER loads in flight a thread, then their keys to shared memory
    for (int base = 0; base < n_items; base += PER * THREADS) {
      T v[PER];
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        const int i = base + j * THREADS + tid;
        int col = 0, row = 0;
        if (i < n_items) item(i, col, row);
        v[j] = i < n_items ? *addr(col, row) : T(0);
      }
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        const int i = base + j * THREADS + tid;
        int col = 0, row = 0;
        if (i < n_items) {
          item(i, col, row);
          keys[(size_t)col * a.Rp + row] = KO::key(v[j]);
        }
      }
    }
  }
  __syncthreads();

  K mask = 0;
  int buf = 0;
  for (int shift = KO::BITS - DIGIT; shift >= 0; shift -= DIGIT) {
    const unsigned dmask = NB - 1u;
    unsigned* h = hist[buf];
    const bool compact = a.staged && mask != K(0);

    // -- this block's histogram of the candidates' next digit -------------
    // (whole warps call it: the ballots see every lane)
    auto count = [&](int col, K key, bool in) {
      const unsigned digit = (unsigned)((key >> shift) & K(dmask));
      const bool same = in && s_same[col];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const bool m = in && !(r == 1 && same) && ((key & mask) == s_prefix[col][r]);
        const unsigned act = __ballot_sync(FULL, m);
        if (act == 0u) continue;
        const unsigned bin = (unsigned)((col * 2 + r) * NB) + digit;
        // one add for a warp whose matching keys share their bin, else one
        // a key (the counts are integers: the order does not matter)
        const int first = __ffs(act) - 1;
        const unsigned lead = __shfl_sync(FULL, bin, first);
        if (__all_sync(FULL, !m || bin == lead)) {
          if (lane == first) atomicAdd(&h[bin], (unsigned)__popc(act));
        } else if (m) {
          atomicAdd(&h[bin], 1u);
        }
      }
    };
    if (!compact) {
      // every key of the share, from shared memory or from x
      for (int base = 0; base < n_items; base += PER * THREADS) {
        K kk[PER];
        int cc[PER];
#pragma unroll
        for (int j = 0; j < PER; ++j) {
          // staged: a warp's lanes on one column's rows, so that the
          // warp's matching digits add as one; from x: the load's order
          const int i = base + j * THREADS + tid;
          int col = 0, row = 0;
          if (i < n_items) {
            if (a.staged) {
              col = i / Rq;
              row = i % Rq;
            } else {
              item(i, col, row);
            }
          }
          cc[j] = col;
          kk[j] = i >= n_items ? K(0) : (a.staged ? keys[(size_t)col * a.Rp + row] : KO::key(*addr(col, row)));
        }
#pragma unroll
        for (int j = 0; j < PER; ++j) count(cc[j], kk[j], base + j * THREADS + tid < n_items);
      }
    } else {
      if (tid < MAX_B) s_cnt[tid] = 0;
      __syncthreads();
      for (int col = 0; col < Bg; ++col) {
        K* ck = keys + (size_t)col * a.Rp;
        const int n = s_n[col];
        // Rounds of PER x THREADS keys: every key of a round is read before
        // any is written back, and a kept key goes to a slot below the
        // round's end, so the compaction in place loses none.
        for (int base = 0; base < n; base += PER * THREADS) {
          K kk[PER];
          bool keep[PER];
#pragma unroll
          for (int j = 0; j < PER; ++j) {
            const int i = base + j * THREADS + tid;
            kk[j] = i < n ? ck[i] : K(0);
          }
#pragma unroll
          for (int j = 0; j < PER; ++j) {
            const bool in = base + j * THREADS + tid < n;
            count(col, kk[j], in);
            keep[j] = in && (((kk[j] & mask) == s_prefix[col][0]) || ((kk[j] & mask) == s_prefix[col][1]));
          }
          int slot[PER];
#pragma unroll
          for (int j = 0; j < PER; ++j) {
            const unsigned kb = __ballot_sync(FULL, keep[j]);
            int s0 = 0;
            if (lane == 0 && kb) s0 = atomicAdd(&s_cnt[col], __popc(kb));
            slot[j] = __shfl_sync(FULL, s0, 0) + __popc(kb & ((1u << lane) - 1u));
          }
          __syncthreads();
#pragma unroll
          for (int j = 0; j < PER; ++j)
            if (keep[j]) ck[slot[j]] = kk[j];
        }
        __syncthreads();
        if (tid == 0) s_n[col] = s_cnt[col];
      }
    }

    // -- the cluster's totals: block q sums its slice of the bins -------
    cluster.sync();  // every block's histogram of this pass is complete
    const int sl = (HB + Kc - 1) / Kc;
    for (int i = q * sl + tid; i < min(HB, (q + 1) * sl); i += THREADS) {
      unsigned s = 0;
      for (int j = 0; j < Kc; ++j) s += cluster.map_shared_rank(h, (unsigned)j)[i];
      h[i] = s;  // only this block reads its own slice
    }
    // the other buffer's remote reads (the last pass's gather) are done
    for (int i = tid; i < HB; i += THREADS) hist[buf ^ 1][i] = 0u;
    cluster.sync();  // the totals stand, slice by slice
    for (int i = tid; i < HB; i += THREADS) tot[i] = cluster.map_shared_rank(h, (unsigned)(i / sl))[i];
    __syncthreads();

    // -- one warp a (column, rank): the digit where the rank falls --------
    if (warp < Bg * 2) {
      const int col = warp >> 1, r = warp & 1;
      const unsigned* t = tot + (col * 2 + (s_same[col] ? 0 : r)) * NB;
      const unsigned k = (unsigned)s_rank[col][r];
      unsigned cum = 0;
      int d = NB - 1;
      unsigned before = 0;
      bool found = false;
      for (int b0 = 0; b0 < NB && !found; b0 += WARP) {
        const unsigned c = t[b0 + lane];
        unsigned incl = c;
#pragma unroll
        for (int o = 1; o < WARP; o <<= 1) {
          const unsigned v = __shfl_up_sync(FULL, incl, o);
          if (lane >= o) incl += v;
        }
        const unsigned hit = __ballot_sync(FULL, k < cum + incl);
        if (hit) {
          const int L = __ffs(hit) - 1;
          d = b0 + L;
          before = cum + __shfl_sync(FULL, incl - c, L);
          found = true;
        } else {
          cum += __shfl_sync(FULL, incl, WARP - 1);
        }
      }
      if (!found) before = cum;  // a rank past the count: the last digit
      if (lane == 0) {
        s_prefix[col][r] |= (K)d << shift;
        s_rank[col][r] = (int)(k - before);
      }
    }
    mask |= K(dmask) << shift;
    buf ^= 1;
    __syncthreads();
    if (tid < Bg) s_same[tid] = s_prefix[tid][0] == s_prefix[tid][1];
    __syncthreads();
  }
  cluster.sync();  // no block leaves while another may read its bins
  if (q == 0 && tid < Bg) {
    a.out_lo[c0 + tid] = KO::val(s_prefix[tid][0]);
    a.out_hi[c0 + tid] = KO::val(s_prefix[tid][1]);
  }
}

template <typename T> size_t smem_bytes(const SelArgs<T>& a) {
  using K = typename KeyOf<T>::K;
  return STATE_BYTES + bins_bytes(a.B) + (a.staged ? align16((size_t)a.B * a.Rp * sizeof(K)) : 0);
}

template <typename T>
int launch(const void* x, long long sC, long long sL, int C, int L, const void* k_lo, const void* k_hi,
           void* out_lo, void* out_hi, int B, int K, int staged, cudaStream_t st) {
  if (B < 1 || B > MAX_B || K < 1 || K > MAX_CLUSTER) return (int)cudaErrorInvalidValue;
  SelArgs<T> a;
  a.x = (const T*)x;
  a.sC = sC;
  a.sL = sL;
  a.C = C;
  a.L = L;
  a.B = B;
  a.R = (L + K - 1) / K;
  a.Rp = a.R | 1;  // odd: a group's columns fall in different banks
  a.staged = staged != 0;
  a.k_lo = (const int*)k_lo;
  a.k_hi = (const int*)k_hi;
  a.out_lo = (T*)out_lo;
  a.out_hi = (T*)out_hi;
  const size_t smem = smem_bytes(a);
  if (smem > SMEM_BLOCK_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t e = cluster_opt_in<select_kernel<T>>();
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr;
  const int groups = (C + B - 1) / B;
  cudaLaunchConfig_t cfg = cluster_config(groups, K, THREADS, smem, st, &attr);
  return (int)cudaLaunchKernelEx(&cfg, select_kernel<T>, a);
}

template <typename T> int max_clusters(int K, int smem, int* out) {
  cudaError_t e = cluster_opt_in<select_kernel<T>>();
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = cluster_config(K, K, THREADS, (size_t)smem, nullptr, &attr);
  return (int)cudaOccupancyMaxActiveClusters(out, select_kernel<T>, &cfg);
}

// ---------------------------------------------------------------- select_hist
// One radix pass of a select whose keys are spread over several ranks of a
// gene mesh (ops/select.py:sharded_masked_median). Replaces no TPU kernel on
// its own: it is order_stats_select's histogram pass (select_kernel above)
// taken out of the cluster, so that the ranks can add their histograms with
// an all-reduce between passes, as the cluster adds its blocks' over
// distributed shared memory. For each column and each of its two ranks, the
// digit at pass `pass` of the keys that match the prefix resolved so far
// (`digits`, (C, 2, npass) bytes, MSB first) is counted into out (C, 2, NB)
// 32-bit counts, which the caller zeroes. A block takes HIST_COLS adjacent
// columns and `rows` rows of them, counts in shared memory (a warp's lanes
// with the same bin add once, __match_any_sync) and adds its non-zero bins
// to out with atomics: integer counts, so the sum is the same in any order.
// Bound by the bytes of one read of the local keys (each pass reads x
// again: the ranks' totals decide the next prefix between two launches).
constexpr int HIST_THREADS = 256;
constexpr int HIST_COLS = 16;  // columns a block

template <typename T>
__global__ void __launch_bounds__(HIST_THREADS)
    select_hist_kernel(const T* x, long long sC, long long sL, int C, int L, int rows, const unsigned char* digits,
                       int npass, int pass, unsigned* out) {
  using KO = KeyOf<T>;
  using K = typename KO::K;
  __shared__ unsigned hist[HIST_COLS * 2 * NB];
  __shared__ K s_prefix[HIST_COLS][2];
  __shared__ int s_same[HIST_COLS];
  const int tid = threadIdx.x, lane = tid & (WARP - 1);
  const int c0 = (int)blockIdx.x * HIST_COLS;
  const int Bc = min(HIST_COLS, C - c0);
  const int r0 = (int)blockIdx.y * rows;
  const int Rb = max(0, min(rows, L - r0));
  const int shift = KO::BITS - DIGIT * (pass + 1);
  const K mask = pass == 0 ? K(0) : ~K(0) << (KO::BITS - DIGIT * pass);

  for (int i = tid; i < HIST_COLS * 2 * NB; i += HIST_THREADS) hist[i] = 0u;
  if (tid < HIST_COLS * 2) {
    const int col = tid >> 1, r = tid & 1;
    K p = 0;
    if (col < Bc)
      for (int j = 0; j < pass; ++j)
        p |= (K)digits[((size_t)(c0 + col) * 2 + r) * npass + j] << (KO::BITS - DIGIT * (j + 1));
    s_prefix[col][r] = p;
  }
  __syncthreads();
  if (tid < HIST_COLS) s_same[tid] = s_prefix[tid][0] == s_prefix[tid][1];
  __syncthreads();

  // item i of the block's share: (column, row), adjacent columns fastest
  // where they are adjacent in memory, else a column's rows
  const bool cols_fast = sC == 1;
  const int n = Bc * Rb;
  auto add = [&](unsigned bin) {
    const unsigned peers = __match_any_sync(FULL, bin);
    if (bin != ~0u && lane == __ffs(peers) - 1) atomicAdd(&hist[bin], (unsigned)__popc(peers));
  };
  for (int base = 0; base < n; base += PER * HIST_THREADS) {
    K kk[PER];
    int cc[PER];
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int i = base + j * HIST_THREADS + tid;
      int col = 0, row = 0;
      if (i < n) {
        col = cols_fast ? i % Bc : i / Rb;
        row = cols_fast ? i / Bc : i % Rb;
      }
      cc[j] = col;
      kk[j] = i < n ? KO::key(x[(long long)(c0 + col) * sC + (long long)(r0 + row) * sL]) : K(0);
    }
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const bool in = base + j * HIST_THREADS + tid < n;
      const int col = cc[j];
      const unsigned d = (unsigned)((kk[j] >> shift) & K(NB - 1));
      const K km = kk[j] & mask;
      const bool m0 = in && km == s_prefix[col][0];
      const bool m1 = in && !s_same[col] && km == s_prefix[col][1];
      add(m0 ? (unsigned)(col * 2 * NB) + d : ~0u);
      add(m1 ? (unsigned)((col * 2 + 1) * NB) + d : ~0u);
    }
  }
  __syncthreads();
  for (int i = tid; i < Bc * 2 * NB; i += HIST_THREADS) {
    const int col = i / (2 * NB), r = (i / NB) & 1, b = i % NB;
    const unsigned v = hist[(col * 2 + (s_same[col] ? 0 : r)) * NB + b];
    if (v) atomicAdd(&out[((size_t)(c0 + col) * 2 + r) * NB + b], v);
  }
}

template <typename T>
int hist_launch(const void* x, long long sC, long long sL, int C, int L, const void* digits, int npass, int pass,
                int rows, void* out, cudaStream_t st) {
  if (npass != KeyOf<T>::BITS / DIGIT || pass < 0 || pass >= npass || rows < 1) return (int)cudaErrorInvalidValue;
  const long long splits = ((long long)L + rows - 1) / rows;
  if (splits > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((C + HIST_COLS - 1) / HIST_COLS), (unsigned)splits);
  select_hist_kernel<T><<<grid, HIST_THREADS, 0, st>>>((const T*)x, sC, sL, C, L, rows,
                                                       (const unsigned char*)digits, npass, pass, (unsigned*)out);
  return (int)cudaGetLastError();
}

}  // namespace

// The k_lo-th and k_hi-th smallest of each of C columns of L values (value
// (c, i) at x[c sC + i sL]), on clusters of K blocks a group of B columns,
// the keys staged in shared memory or streamed.
extern "C" int order_stats_select_launch(int is_f64, const void* x, int C, int L, long long sC, long long sL,
                                         const void* k_lo, const void* k_hi, void* out_lo, void* out_hi, int B,
                                         int K, int staged, void* stream) {
  if (C <= 0 || L <= 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  const int rc = is_f64 ? launch<double>(x, sC, sL, C, L, k_lo, k_hi, out_lo, out_hi, B, K, staged, s)
                        : launch<float>(x, sC, sL, C, L, k_lo, k_hi, out_lo, out_hi, B, K, staged, s);
  return rc != 0 ? rc : (int)cudaGetLastError();
}

// out[0] = the clusters of K blocks with `smem` bytes each that the card
// holds at once (the occupancy API; no launch), 0 where none fits.
extern "C" int select_max_clusters(int is_f64, int K, int smem, int* out, void* stream) {
  (void)stream;
  return is_f64 ? max_clusters<double>(K, smem, out) : max_clusters<float>(K, smem, out);
}

// One radix pass over the local keys of C columns of L values (value (c, i)
// at x[c sC + i sL]): out (C, 2, 256) += the counts of pass `pass`'s digit
// of the keys matching each (column, rank)'s prefix in `digits` (C, 2,
// npass), blocks of `rows` rows.
extern "C" int select_hist_launch(int is_f64, const void* x, int C, int L, long long sC, long long sL,
                                  const void* digits, int npass, int pass, int rows, void* out, void* stream) {
  if (C <= 0 || L <= 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  return is_f64 ? hist_launch<double>(x, sC, sL, C, L, digits, npass, pass, rows, out, s)
                : hist_launch<float>(x, sC, sL, C, L, digits, npass, pass, rows, out, s);
}
