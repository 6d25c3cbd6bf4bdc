// The variance-stabilising transform, one elementwise pass over (G, N).
//
// Replaces the transform of pydeseq2_tpu/fused.py:886-912 (vst_pipeline)
// and pydeseq2_tpu/fused_stream.py:1249-1273 (vst_pipeline_streamed): with
// v = counts / sf_n, either the parametric closed form
//   log((1 + a1 + 2 a0 v + 2 sqrt(a0 v (1 + a1 + a0 v))) / (4 a0)) / log 2
// or the mean form
//   (2 asinh(sqrt(d v)) - log d - log 4) / log 2,  d = the mean dispersion,
// chosen by the trend type and, for the parametric trend, by its
// used_mean flag (the in-program fallback), read on the device; NaN rows
// where the gene is masked out. jnp.log2(x) lowers to log(x) / log(2), so
// the division is spelled out, and the three divisions stay IEEE
// divisions: the result is the plain version's to the bit.
//
// Bound on the H100 by its bytes: the counts read once and the result
// written once, 24 + 24 MB at 100 x 60000 f32 (0.0143 ms at 3.35 TB/s).
// The issue cost is close behind: three divisions, a sqrt and a log a
// cell are ~50-70 float32 instructions (~0.01 ms over 6 M cells; float64
// runs its double log and divisions at half the float32 rate). So the
// design spends nothing else a cell:
//   - A 2-D grid of row tiles that know their genes: blockIdx.x a tile of
//     `rows` genes, blockIdx.y a tile of `cols` columns of their rows. The
//     block stages its columns' size factors and its genes' mask bytes in
//     shared memory once; a masked gene's cells are written NaN without
//     reading its counts. No cell divides its index by N to find its gene:
//     a thread's vector index within the tile is split into (row, vector)
//     by a multiply-high with the tile's reciprocal (exact for index x
//     vectors-a-row < 2^32, which the plan keeps).
//   - 16 bytes a thread (float4 / double2) where the row length and both
//     pointers allow it (vec = 16 / sizeof(T)), scalar otherwise; streaming
//     loads and stores (read and written once); ITEMS vectors in flight a
//     thread, then the next ITEMS of the tile.
//   - The tile comes from ops/vst.py:_vst_plan (shape, pointer alignment,
//     the card's SMs), the fastest of the sizes kernel_bench measured: at
//     most 4096 bytes of row; 16 vectors a thread where that leaves two
//     waves of blocks, else 4, one in flight; single elements 8, two in
//     flight. (Staging costs each block a barrier: tiles of one vector a
//     thread ran 10-20% slower at 1000 samples. Two designs measured
//     slower and went: a grid of ~8 blocks an SM walking the row tiles,
//     and reciprocals of the divisors with the division's fast-path
//     correction, as sf_newton takes them, whose range checks and slow
//     path both stay in the code.)
#include "common.cuh"

using namespace pdt;

namespace {

constexpr int THREADS = 256;
// Full occupancy: at most 32 registers a thread. The float64 forms spill a
// few bytes, and still measured faster than at their 48-58 registers.
constexpr int BLOCKS_PER_SM = 8;

template <typename T, int VEC> struct VecOf { using type = T; };
template <> struct VecOf<float, 4> { using type = float4; };
template <> struct VecOf<double, 2> { using type = double2; };

template <typename T> __device__ __forceinline__ T m_asinh(T x);
template <> __device__ __forceinline__ float m_asinh(float x) { return asinhf(x); }
template <> __device__ __forceinline__ double m_asinh(double x) { return asinh(x); }

template <typename T> struct Form {
  bool use_mean;
  T a0, a1, d, log_d;
};

// One cell from its count y and size factor s, in the plain version's
// expression order.
template <typename T>
__device__ __forceinline__ T vst_cell(T y, T s, const Form<T>& f) {
  const T ln2 = T(0.6931471805599453);
  const T ln4 = T(1.3862943611198906);
  const T v = y / s;
  if (f.use_mean) return ((T(2) * m_asinh(m_sqrt(f.d * v)) - f.log_d) - ln4) / ln2;
  const T one_a1 = T(1) + f.a1;
  const T a0v = f.a0 * v;
  const T num = (one_a1 + (T(2) * f.a0) * v) + T(2) * m_sqrt(a0v * (one_a1 + a0v));
  return m_log(num / (T(4) * f.a0)) / ln2;
}

template <typename T, int VEC, int ITEMS>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
    vst_kernel(int G, int N, int rows, int cols, int mean_only, const T* __restrict__ counts,
               const T* __restrict__ sf, const T* __restrict__ coeffs,
               const uint8_t* __restrict__ used_mean, const T* __restrict__ mean_disp,
               const uint8_t* __restrict__ gene_mask, T* __restrict__ out) {
  using V = typename VecOf<T, VEC>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  T* s_sf = reinterpret_cast<T*>(smem);
  uint8_t* s_keep = smem + (size_t)cols * sizeof(T);

  // The tile: its genes' mask bytes and its columns' size factors, staged
  // once; the form's scalars.
  const int r0 = blockIdx.x * rows;
  const int c0 = blockIdx.y * cols;
  const int nr = min(rows, G - r0);
  const int nc = min(cols, N - c0);
  for (int i = threadIdx.x; i < nc; i += THREADS) s_sf[i] = sf[c0 + i];
  for (int i = threadIdx.x; i < nr; i += THREADS) s_keep[i] = gene_mask[r0 + i];
  Form<T> f;
  f.use_mean = mean_only || __ldg(used_mean);
  f.d = __ldg(mean_disp);
  f.log_d = f.use_mean ? m_log(f.d) : T(0);
  f.a0 = f.use_mean ? T(0) : __ldg(coeffs);
  f.a1 = f.use_mean ? T(0) : __ldg(coeffs + 1);
  // (row, vector) of tile index j: row = j / vt by a multiply-high, exact
  // while j vt < 2^32 (the plan keeps rows vt^2 below it).
  const unsigned vt = (unsigned)(nc / VEC);
  const unsigned magic = vt > 1 ? 0xffffffffu / vt + 1u : 0u;
  const unsigned total = (unsigned)nr * vt;
  const T nan = Lim<T>::inf() - Lim<T>::inf();
  __syncthreads();

  for (unsigned base = threadIdx.x; base < total; base += THREADS * ITEMS) {
    V buf[ITEMS];
    unsigned row[ITEMS], vec[ITEMS];
#pragma unroll
    for (int it = 0; it < ITEMS; ++it) {
      const unsigned j = base + it * THREADS;
      row[it] = vt > 1 ? __umulhi(j, magic) : j;
      vec[it] = j - row[it] * vt;
      if (j < total && s_keep[row[it]])
        buf[it] = __ldcs(reinterpret_cast<const V*>(counts + (size_t)(r0 + row[it]) * N + c0) + vec[it]);
    }
#pragma unroll
    for (int it = 0; it < ITEMS; ++it) {
      const unsigned j = base + it * THREADS;
      if (j >= total) continue;
      T* y = reinterpret_cast<T*>(&buf[it]);
      if (s_keep[row[it]]) {
        const V sv = reinterpret_cast<const V*>(s_sf)[vec[it]];
        const T* s = reinterpret_cast<const T*>(&sv);
#pragma unroll
        for (int k = 0; k < VEC; ++k) y[k] = vst_cell(y[k], s[k], f);
      } else {
#pragma unroll
        for (int k = 0; k < VEC; ++k) y[k] = nan;
      }
      __stcs(reinterpret_cast<V*>(out + (size_t)(r0 + row[it]) * N + c0) + vec[it], buf[it]);
    }
  }
}

template <typename T, int VEC, int ITEMS>
int launch(int G, int N, int rows, int cols, int mean_only, const void* counts, const void* sf,
           const void* coeffs, const void* used_mean, const void* mean_disp, const void* gene_mask, void* out,
           cudaStream_t st) {
  const dim3 grid((unsigned)((G + rows - 1) / rows), (unsigned)((N + cols - 1) / cols));
  const size_t smem = (size_t)cols * sizeof(T) + rows;
  vst_kernel<T, VEC, ITEMS><<<grid, THREADS, smem, st>>>(
      G, N, rows, cols, mean_only, (const T*)counts, (const T*)sf, (const T*)coeffs,
      (const uint8_t*)used_mean, (const T*)mean_disp, (const uint8_t*)gene_mask, (T*)out);
  return (int)cudaGetLastError();
}

template <typename T, int VEC>
int launch_items(int items, int G, int N, int rows, int cols, int mean_only, const void* counts, const void* sf,
                 const void* coeffs, const void* used_mean, const void* mean_disp, const void* gene_mask,
                 void* out, cudaStream_t st) {
  switch (items) {
    case 1: return launch<T, VEC, 1>(G, N, rows, cols, mean_only, counts, sf, coeffs, used_mean, mean_disp,
                                     gene_mask, out, st);
    case 2: return launch<T, VEC, 2>(G, N, rows, cols, mean_only, counts, sf, coeffs, used_mean, mean_disp,
                                     gene_mask, out, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// out (G, N). mean_only = 1 for the mean trend (coeffs and used_mean may
// then be NULL); otherwise the parametric coefficients (2,) and the
// used_mean flag (one byte, a bool tensor's) choose the form. gene_mask:
// G bytes (a bool tensor's). The plan: vec (1, or 16 / sizeof(T) with N a
// multiple of it and counts, out 16-byte aligned), rows and cols of a tile
// (cols a multiple of vec, rows x (cols / vec)^2 < 2^32), and the vectors
// a thread has in flight (1 or 2).
extern "C" int vst_launch(int is_f64, int G, int N, int mean_only, const void* counts,
                          const void* sf, const void* coeffs, const void* used_mean,
                          const void* mean_disp, const void* gene_mask, void* out, int vec,
                          int rows, int cols, int items, void* stream) {
  if (G <= 0 || N <= 0) return (int)cudaSuccess;
  if (!mean_only && (coeffs == nullptr || used_mean == nullptr)) return (int)cudaErrorInvalidValue;
  const int wide = is_f64 ? 2 : 4;
  if (rows < 1 || cols < 1 || (vec != 1 && vec != wide) || N % vec != 0 || cols % vec != 0 ||
      (double)rows * (cols / vec) * (cols / vec) >= 4294967296.0 ||
      (vec > 1 && (((uintptr_t)counts | (uintptr_t)out) & 15) != 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (is_f64)
    return vec == 1 ? launch_items<double, 1>(items, G, N, rows, cols, mean_only, counts, sf, coeffs, used_mean,
                                              mean_disp, gene_mask, out, st)
                    : launch_items<double, 2>(items, G, N, rows, cols, mean_only, counts, sf, coeffs, used_mean,
                                              mean_disp, gene_mask, out, st);
  return vec == 1 ? launch_items<float, 1>(items, G, N, rows, cols, mean_only, counts, sf, coeffs, used_mean,
                                           mean_disp, gene_mask, out, st)
                  : launch_items<float, 4>(items, G, N, rows, cols, mean_only, counts, sf, coeffs, used_mean,
                                           mean_disp, gene_mask, out, st);
}
