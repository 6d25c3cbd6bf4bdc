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
// One radix pass of a select whose keys are spread over the ranks of a gene
// mesh (ops/select.py:sharded_masked_median), and the pick that resolves
// the pass's digit from the ranks' summed counts. They replace no TPU kernel
// on their own: they are order_stats_select's histogram pass and digit pick
// (select_kernel above) taken out of the cluster, so that the ranks can add
// their counts with an all-reduce between a pass and its pick, as the
// cluster adds its blocks' over distributed shared memory.
//
// select_hist counts, for each column and each of its two ranks, the digit
// at pass `pass` of the keys that match the prefix resolved so far
// (`digits`, (C, 2, npass) bytes, MSB first) into out (C, 2, NB) 32-bit
// counts, which the caller zeroes. A block of 16 warps takes HIST_COLS
// adjacent columns and `rows` rows of them. Where the columns are adjacent
// in memory (the (G, N) log-ratio tile, sC = 1) it reads chunks of
// HIST_CHUNK rows coalesced (16-byte loads where the row stride and the
// pointer allow), the next chunk's loads in flight while it counts this
// one, and stages the keys in shared memory column by column (rows padded
// so that the staging stores miss no bank); a column view (sC != 1, or one
// column) is read from x where it lies, a warp on one column's rows. Either
// way a warp walks ONE column, 32 consecutive rows a step, so the lanes
// whose keys share a bin are in one warp (log-ratios share their top
// bytes): warp w takes column w % Bc and every (16 / Bc)-th step of it, and
// counts into bins of its own (2 ranks x NB words), so no two warps add to
// one shared word. A step where no lane's key matches a prefix costs a
// read, a compare and a vote; the rank-1 half is skipped where a column's
// two ranks share their prefix (always at pass 0). A matching lane adds
// with a shared atomic to its warp's bins: on an H100 that beat one add a
// distinct bin (__match_any_sync) and one add a warp where all lanes share
// a bin at every shape and pass measured.
//
// Past pass 0 most keys match no prefix (at 100 x 60000 f32 ~35% in pass
// 1, 0.3% in pass 2, 0.003% in pass 3), and there the staging's barriers
// only expose the loads' latency. So a staged block first counts its
// threads with a match in the first chunk: below one in HIST_SPARSE_SHARE
// it goes sparse, each thread testing the keys it loaded where it holds
// them, with no staging and no barrier, the few matches adding to their
// column's first warp's bins with shared atomics (the one place two warps
// may add to one word, rarely). (A ring of cp.async copies in shared
// memory, to hold more loads in flight than registers allow, measured no
// faster on an H100 and slowed the dense passes.) The block then adds the
// non-zero sums of its columns' bins to out with atomics: integer counts,
// the same sum in any order. (Row-split blocks summing their bins over a
// thread-block cluster first, for fewer global atomics, measured slower.)
// Bound by the bytes of one read of the local keys: each pass reads x
// again, as the ranks' totals decide the next prefix between two launches.
//
// select_pick: a warp a (column, rank) finds the first bin whose running
// count passes the rank (a rank past the count: digit 255 and the rank less
// the count before bin 255, as ops/select.py:radix_pick) and writes the
// digit and, in place, the rank within its bin; after the last pass it
// decodes the two keys and writes the median, NaN where the column has no
// valid entry.
// Pass 0 takes its ranks, the two middle ones, from the valid counts. (The
// pick run as the next pass's prologue, each block resolving its own
// columns, measured no faster at 100 columns and slower at 8000.)
constexpr int HIST_THREADS = 512;
constexpr int HIST_WARPS = HIST_THREADS / WARP;  // 16: a warp a column of a full block
constexpr int HIST_COLS = 16;                    // columns a block
constexpr int HIST_CHUNK = 256;                  // rows a staged chunk
constexpr int HIST_LOADS = HIST_COLS * HIST_CHUNK / HIST_THREADS;  // values a thread stages a chunk
constexpr int HIST_UNROLL = 4;                   // keys a lane reads before it counts them (column view)
constexpr int HIST_SPARSE_SHARE = 4;  // sparse below one thread in 4 with a match in the first chunk

// Row stride of a staged column in shared memory, in keys, padded by 2: a
// warp's staging stores (8 rows of 4 columns, 4 of 8 or 2 of 16) then fall
// in distinct banks (64-bit keys: two wavefronts, the least a warp's 256
// bytes take).
constexpr int HIST_RP = HIST_CHUNK + 2;

// Dynamic shared memory: every warp's bins, then the staged keys.
template <typename T> size_t hist_smem(bool staged) {
  using K = typename KeyOf<T>::K;
  return (size_t)HIST_WARPS * 2 * NB * 4 + (staged ? (size_t)HIST_COLS * HIST_RP * sizeof(K) : 0);
}

template <typename T> struct HistArgs {
  const T* x;
  long long sC, sL;  // element strides of a column and of a row
  int C, L, rows;    // rows a block
  bool staged;       // columns adjacent in memory: chunks staged in shared memory
  bool vec;          // staged by 16-byte loads (sC = 1, sL and the pointer aligned; full blocks)
  const unsigned char* digits;  // (C, 2, npass), 4-byte aligned
  int npass, pass;
  unsigned* out;  // (C, 2, NB): this pass's counts
};

// Four floats or two doubles by one 16-byte load (p 16-byte aligned).
__device__ __forceinline__ void load16(const float* p, float* v) {
  const float4 w = *reinterpret_cast<const float4*>(p);
  v[0] = w.x;
  v[1] = w.y;
  v[2] = w.z;
  v[3] = w.w;
}
__device__ __forceinline__ void load16(const double* p, double* v) {
  const double2 w = *reinterpret_cast<const double2*>(p);
  v[0] = w.x;
  v[1] = w.y;
}

template <typename T> __device__ __forceinline__ T canonical_nan();
template <> __device__ __forceinline__ float canonical_nan<float>() { return __int_as_float(0x7fc00000); }
template <> __device__ __forceinline__ double canonical_nan<double>() {
  return __longlong_as_double(0x7ff8000000000000LL);
}

// The rank of a column's median half r among its n valid entries.
__device__ __forceinline__ long long mid_rank(long long n, int r) { return r == 0 ? (n > 0 ? (n - 1) / 2 : 0) : n / 2; }

// The digit of one (column, rank) from its NB totals t: the first bin whose
// running count passes `rank` (none: NB - 1), and the count before it (none:
// the count before bin NB - 1). Called by a whole warp.
__device__ __forceinline__ void pick_digit(const unsigned* t, long long rank, int lane, int& d, long long& before) {
  long long cum = 0;
  for (int b0 = 0; b0 < NB; b0 += WARP) {
    const long long c = t[b0 + lane];
    long long incl = c;
#pragma unroll
    for (int o = 1; o < WARP; o <<= 1) {
      const long long v = __shfl_up_sync(FULL, incl, o);
      if (lane >= o) incl += v;
    }
    const unsigned hit = __ballot_sync(FULL, rank < cum + incl);
    if (hit) {
      const int first = __ffs(hit) - 1;
      d = b0 + first;
      before = cum + __shfl_sync(FULL, incl - c, first);
      return;
    }
    cum += __shfl_sync(FULL, incl, WARP - 1);
  }
  d = NB - 1;
  before = cum - (long long)t[NB - 1];
}

// The digits of a (column, rank) at d (npass bytes, MSB first) as the high
// bits of a key, by 4-byte loads (d 4-byte aligned); the caller masks off
// the digits not resolved yet.
__device__ __forceinline__ void digits_key(const unsigned char* d, unsigned& k) {
  k = __byte_perm(*reinterpret_cast<const unsigned*>(d), 0u, 0x0123);
}
__device__ __forceinline__ void digits_key(const unsigned char* d, unsigned long long& k) {
  const unsigned* w = reinterpret_cast<const unsigned*>(d);
  k = ((unsigned long long)__byte_perm(w[0], 0u, 0x0123) << 32) | __byte_perm(w[1], 0u, 0x0123);
}

// Float32: three blocks an SM (42 registers a thread); float64 two.
template <typename T>
__global__ void __launch_bounds__(HIST_THREADS, sizeof(T) == 4 ? 3 : 2) select_hist_kernel(HistArgs<T> a) {
  using KO = KeyOf<T>;
  using K = typename KO::K;
  constexpr int RP = HIST_RP;
  constexpr int VEC = 16 / (int)sizeof(T);  // values a 16-byte load
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned* bins = (unsigned*)smem;                        // [HIST_WARPS][2][NB]
  K* keys = (K*)(smem + (size_t)HIST_WARPS * 2 * NB * 4);  // [HIST_COLS][RP]
  __shared__ K s_prefix[HIST_COLS][2];
  __shared__ int s_same[HIST_COLS];
  const int tid = threadIdx.x, lane = tid & (WARP - 1), warp = tid / WARP;
  const int c0 = (int)blockIdx.x * HIST_COLS;
  const int Bc = min(HIST_COLS, a.C - c0);
  const int r0 = (int)blockIdx.y * a.rows;
  const int Rb = max(0, min(a.rows, a.L - r0));
  const int shift = KO::BITS - DIGIT * (a.pass + 1);
  const K mask = a.pass == 0 ? K(0) : ~K(0) << (KO::BITS - DIGIT * a.pass);

  // -- a staged block's loads: where the block is full and aligned, thread t
  // takes VEC adjacent columns of a row by one 16-byte load (TPR threads a
  // row, RPR rows a round), else one column of a row (16 columns x 32 rows
  // a round, the columns past Bc idle); HIST_LOADS values a chunk either
  // way. The first chunk's are issued before anything else.
  constexpr int TPR = HIST_COLS / VEC, RPR = HIST_THREADS / TPR;
  constexpr int SPR = HIST_THREADS / HIST_COLS;  // rows a scalar round
  const bool vec = a.staged && a.vec && Bc == HIST_COLS;
  const int vc = (tid % TPR) * VEC, vr = tid / TPR;      // 16-byte loads: first column, row
  const int sc = tid % HIST_COLS, sr = tid / HIST_COLS;  // scalar loads
  const int tc = vec ? vc : sc;                          // this thread's (first) column
  T v[HIST_LOADS] = {};
  auto load = [&](int base) {
    const int n_rows = min(HIST_CHUNK, Rb - base);
    const T* xb = a.x + (long long)(c0 + tc) * a.sC + (long long)(r0 + base) * a.sL;
    if (vec) {
#pragma unroll
      for (int j = 0; j < HIST_LOADS / VEC; ++j) {
        const int row = vr + j * RPR;
        if (row < n_rows) load16(xb + (long long)row * a.sL, &v[j * VEC]);
      }
    } else {
#pragma unroll
      for (int e = 0; e < HIST_LOADS; ++e) {
        const int row = sr + e * SPR;
        if (sc < Bc && row < n_rows) v[e] = xb[(long long)row * a.sL];
      }
    }
  };
  if (a.staged && Rb > 0) load(0);

  if (tid < 2 * HIST_COLS) {
    const int col = tid >> 1, r = tid & 1;
    K p = 0;
    if (col < Bc && a.pass > 0) {
      digits_key(a.digits + ((size_t)(c0 + col) * 2 + r) * a.npass, p);
      p &= mask;
    }
    s_prefix[col][r] = p;
    const unsigned same = __ballot_sync(FULL, p == __shfl_xor_sync(FULL, p, 1));
    if (r == 0) s_same[col] = (same >> lane) & 1u;
  }
  __syncthreads();

  // -- this warp's column, its share of the steps, its bins ----------------
  const int S = HIST_WARPS / Bc;  // warps a column
  const bool active = warp < S * Bc;
  const int col = active ? warp % Bc : 0, share = warp / Bc;
  const K p0 = s_prefix[col][0], p1 = s_prefix[col][1];
  const bool two = !s_same[col];  // the column's ranks count apart
  unsigned* h = bins + (size_t)warp * 2 * NB;
  if (active)
    for (int i = lane; i < (two ? 2 : 1) * NB; i += WARP) h[i] = 0u;
  __syncwarp();
  // a step of 32 of the column's keys (whole warps call it: the votes see every lane)
  auto count = [&](K key, bool in) {
    const K km = key & mask;
    const bool m0 = in && km == p0;
    const bool m1 = in && two && km == p1;
    if (!__any_sync(FULL, m0 || m1)) return;
    const unsigned d = (unsigned)(key >> shift) & (unsigned)(NB - 1);
    if (m0) atomicAdd(&h[d], 1u);
    if (m1) atomicAdd(&h[NB + d], 1u);
  };

  if (a.staged) {
    // this thread's columns (VEC adjacent ones, or one) and their prefixes
    K tp0[VEC], tp1[VEC];
    bool tt[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const int c = min(tc + i, HIST_COLS - 1);
      tp0[i] = s_prefix[c][0];
      tp1[i] = s_prefix[c][1];
      tt[i] = !s_same[c];
    }
    // value e of a chunk: its column's slot i among this thread's, its row
    auto slot = [&](int e) { return vec ? e % VEC : 0; };
    auto row_of = [&](int e) { return vec ? vr + (e / VEC) * RPR : sr + e * SPR; };
    auto valid = [&](int e, int n_rows) { return (vec || sc < Bc) && row_of(e) < n_rows; };
    const int nch = (Rb + HIST_CHUNK - 1) / HIST_CHUNK;
    // Dense or sparse: pass 0 matches every key; later passes count the
    // threads with a match in the first chunk (which also orders the bins'
    // zeroing before any add from another warp).
    bool dense = true;
    if (a.pass > 0) {
      bool any = false;
#pragma unroll
      for (int e = 0; e < HIST_LOADS; ++e) {
        const K km = KO::key(v[e]) & mask;
        const int i = slot(e);
        any |= valid(e, min(HIST_CHUNK, Rb)) && (km == tp0[i] || (tt[i] && km == tp1[i]));
      }
      dense = __syncthreads_count(any) > HIST_THREADS / HIST_SPARSE_SHARE;
    }
    if (!dense) {
      // Sparse: each thread tests the values it loaded where it holds them
      // (no staging, no barrier); the few keys that match add to their
      // column's first warp's bins.
      for (int ch = 0; ch < nch; ++ch) {
        const int base = ch * HIST_CHUNK, n_rows = min(HIST_CHUNK, Rb - base);
        if (ch > 0) load(base);
#pragma unroll
        for (int e = 0; e < HIST_LOADS; ++e) {
          const K key = KO::key(v[e]), km = key & mask;
          const int i = slot(e);
          const bool m0 = km == tp0[i], m1 = tt[i] && km == tp1[i];
          if (valid(e, n_rows) && (m0 || m1)) {
            const unsigned d = (unsigned)(key >> shift) & (unsigned)(NB - 1);
            unsigned* hc = bins + (size_t)(tc + i) * 2 * NB;
            if (m0) atomicAdd(&hc[d], 1u);
            if (m1) atomicAdd(&hc[NB + d], 1u);
          }
        }
      }
    } else {
      for (int ch = 0; ch < nch; ++ch) {
        const int base = ch * HIST_CHUNK, n_rows = min(HIST_CHUNK, Rb - base);
#pragma unroll
        for (int e = 0; e < HIST_LOADS; ++e)
          if (valid(e, n_rows)) keys[(tc + slot(e)) * RP + row_of(e)] = KO::key(v[e]);
        __syncthreads();
        if (ch + 1 < nch) load(base + HIST_CHUNK);  // in flight while this chunk is counted
        if (active) {
          const K* ck = keys + col * RP;
          const int nsteps = (n_rows + WARP - 1) / WARP;
          for (int k = share; k < nsteps; k += S) {
            const int row = k * WARP + lane;
            count(row < n_rows ? ck[row] : K(0), row < n_rows);
          }
        }
        __syncthreads();
      }
    }
  } else if (active) {
    const T* xc = a.x + (long long)(c0 + col) * a.sC + (long long)r0 * a.sL;
    const int nsteps = (Rb + WARP - 1) / WARP;
    for (int k0 = share; k0 < nsteps; k0 += S * HIST_UNROLL) {
      K kk[HIST_UNROLL];
#pragma unroll
      for (int u = 0; u < HIST_UNROLL; ++u) {
        const int row = (k0 + u * S) * WARP + lane;
        kk[u] = row < Rb ? KO::key(xc[(long long)row * a.sL]) : K(0);
      }
#pragma unroll
      for (int u = 0; u < HIST_UNROLL; ++u) count(kk[u], (k0 + u * S) * WARP + lane < Rb);
    }
  }

  // -- the block's columns: its warps' bins summed, four bins a thread at a
  // time; the non-zero sums added to out, to both ranks where they share
  // their prefix (rank 0's bins then serve both)
  __syncthreads();
  for (int i = tid; i < Bc * 2 * NB / 4; i += HIST_THREADS) {
    const int c = i / (2 * NB / 4), r = (i / (NB / 4)) & 1, b = (i % (NB / 4)) * 4;
    const bool same = s_same[c];
    if (same && r == 1) continue;
    unsigned nn[4] = {0u, 0u, 0u, 0u};
    for (int s = 0; s < S; ++s) {
      const uint4 m = *reinterpret_cast<const uint4*>(&bins[((size_t)(c + s * Bc) * 2 + r) * NB + b]);
      nn[0] += m.x;
      nn[1] += m.y;
      nn[2] += m.z;
      nn[3] += m.w;
    }
    unsigned* o = a.out + ((size_t)(c0 + c) * 2 + r) * NB + b;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (nn[j]) {
        atomicAdd(o + j, nn[j]);
        if (same) atomicAdd(o + NB + j, nn[j]);
      }
  }
}

template <typename T>
int hist_launch(const void* x, long long sC, long long sL, int C, int L, const void* digits, int npass, int pass,
                int rows, int staged, void* out, cudaStream_t st) {
  if (npass != KeyOf<T>::BITS / DIGIT || pass < 0 || pass >= npass || rows < 1 || (uintptr_t)digits % 4)
    return (int)cudaErrorInvalidValue;
  const long long splits = ((long long)L + rows - 1) / rows;
  if (splits > 65535) return (int)cudaErrorInvalidValue;
  HistArgs<T> a;
  a.x = (const T*)x;
  a.sC = sC;
  a.sL = sL;
  a.C = C;
  a.L = L;
  a.rows = rows;
  a.staged = staged != 0;
  a.vec = a.staged && sC == 1 && sL % (16 / (long long)sizeof(T)) == 0 && (uintptr_t)x % 16 == 0;
  a.digits = (const unsigned char*)digits;
  a.npass = npass;
  a.pass = pass;
  a.out = (unsigned*)out;
  const size_t smem = hist_smem<T>(a.staged);
  const cudaError_t e = smem_opt_in<select_hist_kernel<T>>(smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)((C + HIST_COLS - 1) / HIST_COLS), (unsigned)splits);
  select_hist_kernel<T><<<grid, HIST_THREADS, smem, st>>>(a);
  return (int)cudaGetLastError();
}

template <typename T> int hist_per_sm(int staged, int* out) {
  const size_t smem = hist_smem<T>(staged != 0);
  const cudaError_t e = smem_opt_in<select_hist_kernel<T>>(smem);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, select_hist_kernel<T>, HIST_THREADS, smem);
}

constexpr int PICK_THREADS = 256;
constexpr int PICK_COLS = PICK_THREADS / WARP / 2;  // a warp a (column, rank)

template <typename T>
__global__ void __launch_bounds__(PICK_THREADS)
    select_pick_kernel(int C, int npass, int pass, const unsigned* counts, const long long* n_valid,
                       long long n_stride, int* rank, unsigned char* digits, T* out) {
  using KO = KeyOf<T>;
  using K = typename KO::K;
  __shared__ K s_key[PICK_COLS][2];
  const int lane = threadIdx.x & (WARP - 1), warp = threadIdx.x / WARP;
  const int col = (int)blockIdx.x * PICK_COLS + (warp >> 1), r = warp & 1;
  if (col < C) {
    const size_t cr = (size_t)col * 2 + r;
    const long long k = pass == 0 ? mid_rank(n_valid[(long long)col * n_stride], r) : rank[cr];
    int d;
    long long before;
    pick_digit(counts + cr * NB, k, lane, d, before);
    if (lane == 0) {
      digits[cr * npass + pass] = (unsigned char)d;
      rank[cr] = (int)(k - before);
      K k = (K)d << (KO::BITS - DIGIT * (pass + 1));
      for (int j = 0; j < pass; ++j) k |= (K)digits[cr * npass + j] << (KO::BITS - DIGIT * (j + 1));
      s_key[warp >> 1][r] = k;
    }
  }
  if (out == nullptr) return;
  __syncthreads();
  const int c = (int)blockIdx.x * PICK_COLS + (int)threadIdx.x;
  if (threadIdx.x < PICK_COLS && c < C) {
    const T lo = KO::val(s_key[threadIdx.x][0]), hi = KO::val(s_key[threadIdx.x][1]);
    out[c] = n_valid[(long long)c * n_stride] > 0 ? (lo + hi) / T(2) : canonical_nan<T>();
  }
}

template <typename T>
int pick_launch(int C, int npass, int pass, const void* counts, const void* n_valid, long long n_stride, void* rank,
                void* digits, void* out, cudaStream_t st) {
  if (npass != KeyOf<T>::BITS / DIGIT || pass < 0 || pass >= npass || !n_valid || !rank || (out && pass != npass - 1))
    return (int)cudaErrorInvalidValue;
  select_pick_kernel<T><<<(C + PICK_COLS - 1) / PICK_COLS, PICK_THREADS, 0, st>>>(
      C, npass, pass, (const unsigned*)counts, (const long long*)n_valid, n_stride, (int*)rank, (unsigned char*)digits,
      (T*)out);
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
// npass; 4-byte aligned), blocks of `rows` rows, staged (adjacent columns)
// or read in place.
extern "C" int select_hist_launch(int is_f64, const void* x, int C, int L, long long sC, long long sL,
                                  const void* digits, int npass, int pass, int rows, int staged, void* out,
                                  void* stream) {
  if (C <= 0 || L <= 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  return is_f64 ? hist_launch<double>(x, sC, sL, C, L, digits, npass, pass, rows, staged, out, s)
                : hist_launch<float>(x, sC, sL, C, L, digits, npass, pass, rows, staged, out, s);
}

// The digit of pass `pass` of each (column, rank) of C columns from the
// ranks' totals `counts` (C, 2, 256) into digits (C, 2, npass), and the
// rank within its bin into rank (C, 2) int32, which holds the ranks
// entering the pass (at pass 0 they come from the two middle ranks of
// n_valid[c n_stride], int64). With `out` (the last pass only): the median
// of each column, NaN where n_valid is 0.
extern "C" int select_pick_launch(int is_f64, int C, int npass, int pass, const void* counts, const void* n_valid,
                                  long long n_stride, void* rank, void* digits, void* out, void* stream) {
  if (C <= 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  return is_f64 ? pick_launch<double>(C, npass, pass, counts, n_valid, n_stride, rank, digits, out, s)
                : pick_launch<float>(C, npass, pass, counts, n_valid, n_stride, rank, digits, out, s);
}

// out[0] = the select_hist blocks an SM holds, staged or not (the occupancy
// API; no launch).
extern "C" int select_hist_per_sm(int is_f64, int staged, int* out, void* stream) {
  (void)stream;
  return is_f64 ? hist_per_sm<double>(staged, out) : hist_per_sm<float>(staged, out);
}
