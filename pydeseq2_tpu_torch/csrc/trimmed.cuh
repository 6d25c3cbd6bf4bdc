// Exact trimmed means over values staged once, shared by cooks.cu (the
// Cook's robust dispersion), trimmed.cu (the class API's trimmed means and
// cohort variances) and impute.cu (the refit imputation's trimmed mean).
//
// Replaces the order statistics of pydeseq2_tpu/ops/select.py:166
// trimmed_mean_select inside pydeseq2_tpu/ops/stats.py:28,88,108. A trimmed
// mean of n values dropping k at each end keeps the ranks k..n-1-k of the
// sorted values: copies of a boundary value are counted exactly, so the
// kept multiset is a sort's, and lo == hi gives lo. The caller stages the
// values once as monotone integer keys (KeyOf: x < y <=> key(x) < key(y)),
// in shared memory or in a global workspace, so no selection pass
// recomputes a value; the squared errors of a trimmed variance are formed
// from the staged keys in place. The two boundary keys come one of two
// ways, chosen per call by n against the launch plan's rank_max:
//
//  - rank count (short cohorts, n <= rank_max <= RANK_CAP): every thread
//    ranks the keys it owns against all n staged keys,
//      rank_i = #{j : key_j < key_i} + #{j < i : key_j == key_i},
//    a permutation of 0..n-1, so the keys of ranks k..n-1-k are the kept
//    ones and those of ranks k and n-1-k the boundaries: n compares a key,
//    broadcast reads from shared memory, no reduction chain;
//  - radix select (long cohorts): MSB first, 8 bits a pass, a 256-bin
//    shared-memory histogram of the keys that still share the prefix found
//    for each rank (two histograms once the two prefixes part), both ranks
//    in every pass: 4 passes in float32, 8 in float64. A warp whose 32 keys fall in one bin (the leading
//    digits of a gene's counts, a run of zeros) adds to it once. After the
//    last pass the histograms give the copies of each boundary inside the
//    kept ranks, so one more pass sums the interior.
//
// The kept values are summed in float64, thread-strided, then by the
// group's fixed tree, and rounded once to T, as the plain versions
// (ops/stats.py) sum in float64 and round once: in float32 the two agree
// but for rounding ties of that sum, and a second launch repeats the first
// bit for bit (histogram counts are exact integers in any order).
//
// A group is one warp (a row a warp, a warp-private slice of shared memory)
// or one block (a row a block).
#pragma once

#include "common.cuh"

namespace pdt {

// Monotone integer keys: negative values bit-complemented, the sign bit set
// on the others.
template <typename T> struct KeyOf;
template <> struct KeyOf<float> {
  using U = uint32_t;
  static constexpr int BITS = 32;
  static __device__ __forceinline__ U key(float x) {
    U u = __float_as_uint(x);
    return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  }
  static __device__ __forceinline__ float value(U k) {
    return __uint_as_float((k & 0x80000000u) ? (k ^ 0x80000000u) : ~k);
  }
};
template <> struct KeyOf<double> {
  using U = unsigned long long;
  static constexpr int BITS = 64;
  static __device__ __forceinline__ U key(double x) {
    U u = (U)__double_as_longlong(x);
    return (u & 0x8000000000000000ull) ? ~u : (u | 0x8000000000000000ull);
  }
  static __device__ __forceinline__ double value(U k) {
    return __longlong_as_double(
        (long long)((k & 0x8000000000000000ull) ? (k ^ 0x8000000000000000ull) : ~k));
  }
};

constexpr int RADIX = 256;      // bins of one 8-bit digit
constexpr int RANK_CAP = 128;   // the longest cohort the rank count takes
constexpr int TRIM_WARPS = 8;   // rows of a block in the warp mode (256 threads)
constexpr int TRIM_BLOCK_MAX = 1024;

constexpr size_t TRIM_RED_BYTES = (TRIM_BLOCK_MAX / WARP) * (sizeof(double) + sizeof(int));

__host__ __device__ constexpr size_t pad16(size_t b) { return (b + 15) / 16 * 16; }

// The dynamic shared memory of one group's trimmed moments (ops/stats.py:
// _trim_group_bytes), in this order: a block's reduction slots (a double and
// an int a warp, blocks only), the staged keys (buf_len of them), the two
// radix histograms (where a cohort is longer than rank_max), the two
// boundary keys. In the streamed mode the keys live in the global workspace
// instead.
__host__ __device__ constexpr size_t trim_group_bytes(int buf_len, int isz, bool radix, bool shared, bool block) {
  return (block ? TRIM_RED_BYTES : 0) + (shared ? pad16((size_t)buf_len * isz) : 0) +
         (radix ? 2 * RADIX * sizeof(unsigned) : 0) + 16;
}

// Values in one group's slice of the streamed workspace (ops/stats.py:
// _trim_ws_len): the keys, 16-byte aligned.
__host__ __device__ constexpr size_t trim_ws_len(int buf_len, int isz) {
  return pad16((size_t)buf_len * isz) / isz;
}

// The group's places in its slice of dynamic shared memory (laid out as
// trim_group_bytes counts it); keys point into the workspace slice ws where
// not shared.
template <typename U> struct TrimSlice {
  double* red;
  int* redi;
  U* keys;
  unsigned* hist;
  U* bnd;
  __device__ TrimSlice(unsigned char* p, int buf_len, bool radix, bool shared, bool block, U* ws) {
    red = (double*)p;
    redi = (int*)(p + (TRIM_BLOCK_MAX / WARP) * sizeof(double));
    if (block) p += TRIM_RED_BYTES;
    keys = shared ? (U*)p : ws;
    if (shared) p += pad16((size_t)buf_len * sizeof(U));
    hist = (unsigned*)p;
    bnd = (U*)(p + (radix ? 2 * RADIX * sizeof(unsigned) : 0));
  }
};

// One warp reduces a row.
struct WarpGroup {
  static constexpr bool BLOCK = false;
  static constexpr int MIN_SIZE = WARP;
  __device__ __forceinline__ int rank() const { return threadIdx.x & (WARP - 1); }
  __device__ __forceinline__ int size() const { return WARP; }
  __device__ __forceinline__ int warp() const { return 0; }
  __device__ __forceinline__ int nwarps() const { return 1; }
  __device__ __forceinline__ void sync() const { __syncwarp(); }
  __device__ __forceinline__ double sum(double v) const { return warp_sum(v); }
  __device__ __forceinline__ int sum(int v) const { return warp_sum_i(v); }
  __device__ __forceinline__ bool any(bool b) const { return __any_sync(FULL, b); }
};

// One block reduces a row: warp trees, then the warps' sums added in warp
// order by every thread (every thread ends with the same bits). red and redi
// hold a slot per warp in shared memory.
struct BlockGroup {
  static constexpr bool BLOCK = true;
  static constexpr int MIN_SIZE = 256;  // the plans' smallest block
  double* red;
  int* redi;
  __device__ __forceinline__ int rank() const { return threadIdx.x; }
  __device__ __forceinline__ int size() const { return blockDim.x; }
  __device__ __forceinline__ int warp() const { return threadIdx.x / WARP; }
  __device__ __forceinline__ int nwarps() const { return blockDim.x / WARP; }
  __device__ __forceinline__ void sync() const { __syncthreads(); }
  __device__ double sum(double v) const {
    v = warp_sum(v);
    __syncthreads();  // the slots may still be read by the last reduction
    if ((threadIdx.x & (WARP - 1)) == 0) red[warp()] = v;
    __syncthreads();
    double s = 0.0;
    for (int w = 0; w < nwarps(); ++w) s += red[w];
    return s;
  }
  __device__ int sum(int v) const {
    v = warp_sum_i(v);
    __syncthreads();
    if ((threadIdx.x & (WARP - 1)) == 0) redi[warp()] = v;
    __syncthreads();
    int s = 0;
    for (int w = 0; w < nwarps(); ++w) s += redi[w];
    return s;
  }
  __device__ __forceinline__ bool any(bool b) const { return sum((int)__any_sync(FULL, b)) != 0; }
};

// The digit of rank r in the 256-bin histogram h (16-byte aligned): the bin
// whose running count passes r, the count before it and its own. Every
// lane of the calling warp returns them; lane l scans bins 8l..8l+7.
__device__ __forceinline__ void find_digit(const unsigned* h, int r, int& digit, int& before, int& count) {
  const int lane = threadIdx.x & (WARP - 1);
  const uint4 a = reinterpret_cast<const uint4*>(h)[2 * lane];
  const uint4 b = reinterpret_cast<const uint4*>(h)[2 * lane + 1];
  const unsigned c[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  unsigned s = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) s += c[j];
  unsigned incl = s;
#pragma unroll
  for (int o = 1; o < WARP; o <<= 1) {
    const unsigned t = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl += t;
  }
  const unsigned ur = (unsigned)r;
  unsigned bef = incl - s, cnt = 0;
  const bool mine = bef <= ur && ur < incl;
  int d = 0;
  bool found = false;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (!found) {
      if (ur < bef + c[j]) {
        found = true;
        d = j;
        cnt = c[j];
      } else {
        bef += c[j];
      }
    }
  }
  const int src = __ffs(__ballot_sync(FULL, mine)) - 1;
  digit = __shfl_sync(FULL, lane * 8 + d, src);
  before = (int)__shfl_sync(FULL, bef, src);
  count = (int)__shfl_sync(FULL, cnt, src);
}

// (key_j, j) before (key_i, i) in a stable sort: the rank count's order.
// For float32 keys the pair is one 64-bit integer, one compare.
__device__ __forceinline__ bool precedes(uint32_t kj, int j, uint32_t ki, int i) {
  return ((uint64_t)kj << 32 | (uint32_t)j) < ((uint64_t)ki << 32 | (uint32_t)i);
}
__device__ __forceinline__ bool precedes(unsigned long long kj, int j, unsigned long long ki, int i) {
  return kj < ki || (kj == ki && j < i);
}

// The rank count for n <= OWN x the group's size: thread me owns keys me,
// me + step, ...; counts the keys before each against all n staged keys
// (read 16 bytes at a time, broadcast), writes the keys of ranks k and
// k_hi to bnd and returns its share of the kept values' sum.
template <int OWN, typename T, typename Grp>
__device__ __forceinline__ double rank_count(const typename KeyOf<T>::U* buf, int n, int k, int k_hi, typename KeyOf<T>::U* bnd,
                             const Grp& g) {
  using K = KeyOf<T>;
  using U = typename K::U;
  constexpr int VEC = 16 / sizeof(U);  // keys a 16-byte load
  const int me = g.rank(), step = g.size();
  U mine[OWN];
  int idx[OWN], cnt[OWN];
#pragma unroll
  for (int o = 0; o < OWN; ++o) {
    idx[o] = me + o * step;
    mine[o] = idx[o] < n ? buf[idx[o]] : U(0);
    cnt[o] = 0;
  }
  // scalar up to a 16-byte boundary (a cohort may start anywhere in the
  // staged keys), then 16 bytes a load
  const int head = (int)(((16 - ((uintptr_t)buf & 15)) & 15) / sizeof(U));
  int j = 0;
  for (; j < head && j < n; ++j) {
    const U kj = buf[j];
#pragma unroll
    for (int o = 0; o < OWN; ++o) cnt[o] += precedes(kj, j, mine[o], idx[o]);
  }
  for (; j + VEC <= n; j += VEC) {
    U kv[VEC];
    if constexpr (VEC == 4) {
      const uint4 v = *reinterpret_cast<const uint4*>(buf + j);
      kv[0] = v.x, kv[1] = v.y, kv[2] = v.z, kv[3] = v.w;
    } else {
      const ulonglong2 v = *reinterpret_cast<const ulonglong2*>(buf + j);
      kv[0] = v.x, kv[1] = v.y;
    }
#pragma unroll
    for (int t = 0; t < VEC; ++t) {
#pragma unroll
      for (int o = 0; o < OWN; ++o) cnt[o] += precedes(kv[t], j + t, mine[o], idx[o]);
    }
  }
  for (; j < n; ++j) {
    const U kj = buf[j];
#pragma unroll
    for (int o = 0; o < OWN; ++o) cnt[o] += precedes(kj, j, mine[o], idx[o]);
  }
  double s = 0.0;
#pragma unroll
  for (int o = 0; o < OWN; ++o) {
    if (idx[o] < n) {
      const int r = cnt[o];
      if (r == k) bnd[0] = mine[o];
      if (r == k_hi) bnd[1] = mine[o];
      if (r >= k && r <= k_hi) s += double(K::value(mine[o]));
    }
  }
  return s;
}

// Trimmed mean of the n staged keys buf[0..n), dropping k at each end; every
// thread of the group returns it. hist (2 x RADIX, 16-byte aligned) is used
// where n > rank_max, bnd (2 keys) where not; both belong to the group.
// Ends with the group synchronised: buf may be rewritten at once.
template <typename T, typename Grp>
__device__ __forceinline__ T trimmed_mean_keys(const typename KeyOf<T>::U* buf, int n, int k, int rank_max, unsigned* hist,
                               typename KeyOf<T>::U* bnd, const Grp& g) {
  using K = KeyOf<T>;
  using U = typename K::U;
  const int me = g.rank(), step = g.size();
  double s = 0.0;
  if (k == 0) {
    for (int i = me; i < n; i += step) s += double(K::value(buf[i]));
    const double total = g.sum(s);
    g.sync();
    return T(total) / T(n);
  }
  const int k_hi = n - 1 - k;
  U t_lo, t_hi;
  double copies_lo = 0.0, copies_hi = 0.0;
  if (n <= rank_max) {
    // ---- rank count, OWN keys a thread at compile time ----
    if constexpr (Grp::BLOCK) {
      s = rank_count<1, T>(buf, n, k, k_hi, bnd, g);  // n <= RANK_CAP <= the block's threads
    } else {
      const int own = (n + WARP - 1) / WARP;
      if (own <= 1) {
        s = rank_count<1, T>(buf, n, k, k_hi, bnd, g);
      } else if (own <= 2) {
        s = rank_count<2, T>(buf, n, k, k_hi, bnd, g);
      } else if (own <= 3) {
        s = rank_count<3, T>(buf, n, k, k_hi, bnd, g);
      } else {
        s = rank_count<RANK_CAP / WARP, T>(buf, n, k, k_hi, bnd, g);
      }
    }
    g.sync();
    t_lo = bnd[0];
    t_hi = bnd[1];
  } else {
    // ---- radix select, both ranks a pass ----
    U p_lo = 0, p_hi = 0;
    int r_lo = k, r_hi = k_hi, c_lo = 0;
    const int n_pad = (n + WARP - 1) & ~(WARP - 1);  // whole warps reach the votes
#pragma unroll 1
    for (int shift = K::BITS - 8; shift >= 0; shift -= 8) {
      const int above = shift + 8;  // the bits found so far
      const bool same = p_lo == p_hi;
      for (int b = me; b < 2 * RADIX; b += step) hist[b] = 0u;
      g.sync();
      for (int i = me; i < n_pad; i += step) {
        int bin = -1;
        if (i < n) {
          const U key = buf[i];
          const int d = (int)((key >> shift) & U(RADIX - 1));
          if (above >= K::BITS || (key >> above) == (p_lo >> above)) {
            bin = d;  // shares the lower rank's prefix (and the upper's, while they agree)
          } else if (!same && (key >> above) == (p_hi >> above)) {
            bin = RADIX + d;
          }
        }
        // a warp whose keys share one bin (the leading digits of counts,
        // runs of ties) adds once; else each key adds its own
        const int first = __shfl_sync(FULL, bin, 0);
        if (__all_sync(FULL, bin == first)) {
          if ((threadIdx.x & (WARP - 1)) == 0 && first >= 0) atomicAdd(hist + first, (unsigned)WARP);
        } else if (bin >= 0) {
          atomicAdd(hist + bin, 1u);
        }
      }
      g.sync();
      int d, before, count;
      find_digit(hist, r_lo, d, before, count);
      p_lo |= (U)d << shift;
      r_lo -= before;
      c_lo = count;
      find_digit(hist + (same ? 0 : RADIX), r_hi, d, before, count);
      p_hi |= (U)d << shift;
      r_hi -= before;
      g.sync();  // every warp has read the histograms before they are cleared
    }
    t_lo = p_lo;
    t_hi = p_hi;
    // r_lo keys below t_lo's copies are kept ranks short of k; the kept
    // ranks end r_hi places into t_hi's copies
    copies_lo = double(c_lo - r_lo);
    copies_hi = double(r_hi + 1);
    for (int i = me; i < n; i += step) {
      const U key = buf[i];
      if (key > t_lo && key < t_hi) s += double(K::value(key));
    }
  }
  const T lo = K::value(t_lo);
  const T hi = K::value(t_hi);
  const double total = g.sum(s) + double(lo) * copies_lo + double(hi) * copies_hi;
  g.sync();
  return lo == hi ? lo : T(total) / T(n - 2 * k);
}

}  // namespace pdt
