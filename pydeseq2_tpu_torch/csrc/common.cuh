// Shared device code of the pydeseq2_tpu_torch kernels.
//
// - math overloads on float/double (full-precision libm, no fast-math);
// - warp reductions (xor butterfly: every lane ends with the same bits,
//   because each lane adds the same tree with commuted operands, so all 32
//   lanes can run a gene's scalar logic redundantly without divergence);
// - the exact warp-wide trimmed mean by key bisection (Cook's, refit);
// - the NB forms of pydeseq2_tpu/ops/nb.py and their Stirling-8
//   lgamma/psi/psi' (float only, as the JAX package gates them by dtype);
// - a float64 psi and psi' (CUDA's math library has neither): shift by the
//   recurrence to x >= 10, then the asymptotic series;
// - the small symmetric solves of pydeseq2_tpu/ops/smalllinalg.py: closed
//   forms for P <= 3, unrolled Cholesky for P <= 8;
// - the NB GLM gradient/Hessian pass of the IRLS polish and the Newton
//   rescue, and the apeGLM log-likelihood term and jnp.logaddexp.
//
// The kernels are compiled with --fmad=false and write each expression in
// the JAX package's order, so that they round as the plain PyTorch
// versions do, term by term; only the order of the sums over samples
// differs (warp tree here, vectorised loops there).
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace pdt {

constexpr int WARP = 32;
constexpr unsigned FULL = 0xffffffffu;

// ---- math overloads --------------------------------------------------------
__device__ __forceinline__ float m_log(float x) { return logf(x); }
__device__ __forceinline__ double m_log(double x) { return log(x); }
__device__ __forceinline__ float m_log1p(float x) { return log1pf(x); }
__device__ __forceinline__ double m_log1p(double x) { return log1p(x); }
__device__ __forceinline__ float m_exp(float x) { return expf(x); }
__device__ __forceinline__ double m_exp(double x) { return exp(x); }
__device__ __forceinline__ float m_lgamma(float x) { return lgammaf(x); }
__device__ __forceinline__ double m_lgamma(double x) { return lgamma(x); }
__device__ __forceinline__ float m_sqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double m_sqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float m_abs(float x) { return fabsf(x); }
__device__ __forceinline__ double m_abs(double x) { return fabs(x); }

template <typename T> struct Lim;
template <> struct Lim<float> {
  static __device__ __forceinline__ float tiny() { return 1.17549435082228750797e-38f; }
  static __device__ __forceinline__ float inf() { return __int_as_float(0x7f800000); }
};
template <> struct Lim<double> {
  static __device__ __forceinline__ double tiny() { return 2.2250738585072013831e-308; }
  static __device__ __forceinline__ double inf() { return __longlong_as_double(0x7ff0000000000000LL); }
};

// jnp.maximum / jnp.clip semantics for the clamps used here (NaN-propagating
// like XLA's max/min).
template <typename T> __device__ __forceinline__ T m_max(T a, T b) {
  return (a != a) ? a : ((b != b) ? b : (a > b ? a : b));
}
template <typename T> __device__ __forceinline__ T m_min(T a, T b) {
  return (a != a) ? a : ((b != b) ? b : (a < b ? a : b));
}
template <typename T> __device__ __forceinline__ T m_sign(T x) {
  return x > T(0) ? T(1) : (x < T(0) ? T(-1) : x);  // sign(0)=0, sign(NaN)=NaN
}

// ---- warp reductions ---------------------------------------------------------
template <typename T> __device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = WARP / 2; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

__device__ __forceinline__ int warp_sum_i(int v) {
#pragma unroll
  for (int o = WARP / 2; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// ---- exact trimmed mean over one warp (pydeseq2_tpu/ops/select.py:166) -------
// Monotone integer keys: x < y <=> key(x) < key(y) (negative values
// bit-complemented, the sign bit set on the others).
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

// Trimmed mean of the n values val(i), i = 0..n-1, dropping k at each end,
// one warp (every lane returns it). The two boundary order statistics come
// from MSB-first bisection over the keys (the k-th smallest key is the
// largest prefix with at most k keys below it): one warp-wide count per key
// bit, both ranks in the same pass. The interior is then summed directly
// and copies of the boundary values are counted exactly, so the kept
// multiset is a sort's; only the order of the sum differs. val(i) is
// recomputed on every pass (the caller's row stays in L1), so any n works
// without shared memory.
template <typename T, typename F>
__device__ T trimmed_mean(F val, int n, int k, int lane) {
  using K = KeyOf<T>;
  using U = typename K::U;
  if (k == 0) {
    T s = T(0);
    for (int i = lane; i < n; i += WARP) s += val(i);
    return warp_sum(s) / T(n);
  }
  const int k_hi = n - 1 - k;
  U t_lo = 0, t_hi = 0;
  for (int b = K::BITS - 1; b >= 0; --b) {
    const U c_lo = t_lo | ((U)1 << b);
    const U c_hi = t_hi | ((U)1 << b);
    int n_lo = 0, n_hi = 0;
    for (int i = lane; i < n; i += WARP) {
      const U kk = K::key(val(i));
      n_lo += kk < c_lo;
      n_hi += kk < c_hi;
    }
    n_lo = warp_sum_i(n_lo);
    n_hi = warp_sum_i(n_hi);
    if (n_lo <= k) t_lo = c_lo;
    if (n_hi <= k_hi) t_hi = c_hi;
  }
  const T lo = K::value(t_lo);
  const T hi = K::value(t_hi);
  T strict = T(0);
  int c_le_lo = 0, c_lt_hi = 0;
  for (int i = lane; i < n; i += WARP) {
    const T x = val(i);
    if (x > lo && x < hi) strict += x;
    c_le_lo += x <= lo;
    c_lt_hi += x < hi;
  }
  strict = warp_sum(strict);
  c_le_lo = warp_sum_i(c_le_lo);
  c_lt_hi = warp_sum_i(c_lt_hi);
  // kept ranks are [k, n-1-k]; copies of each boundary value inside them
  const T copies_lo = T(c_le_lo - k);
  const T copies_hi = T(n - k - c_lt_hi);
  const T total = strict + lo * copies_lo + hi * copies_hi;
  return lo == hi ? lo : total / T(n - 2 * k);
}

// ---- Stirling-8 forms (pydeseq2_tpu/ops/nb.py:34,232,253) -------------------
constexpr double HALF_LOG_2PI = 0.9189385332046727;
constexpr double R_SWITCH = 8.0;

template <typename T> __device__ __forceinline__ T lgamma_st8(T z) {
  T p1 = z * (z + T(1)) * (z + T(2)) * (z + T(3));
  T p2 = (z + T(4)) * (z + T(5)) * (z + T(6)) * (z + T(7));
  T w = z + T(8);
  T iw = T(1) / w;
  T iw2 = iw * iw;
  T series = iw * (T(1.0 / 12.0) - iw2 * (T(1.0 / 360.0) - iw2 * T(1.0 / 1260.0)));
  return (w - T(0.5)) * m_log(w) - w + T(HALF_LOG_2PI) + series - m_log(p1) - m_log(p2);
}

template <typename T> __device__ __forceinline__ T digamma_st8(T z) {
  T w = z + T(8);
  T iw = T(1) / w;
  T iw2 = iw * iw;
  T recip = T(1) / z + T(1) / (z + T(1)) + T(1) / (z + T(2)) + T(1) / (z + T(3)) +
            T(1) / (z + T(4)) + T(1) / (z + T(5)) + T(1) / (z + T(6)) + T(1) / (z + T(7));
  T series = iw2 * (T(1.0 / 12.0) - iw2 * (T(1.0 / 120.0) - iw2 * T(1.0 / 252.0)));
  return m_log(w) - T(0.5) * iw - series - recip;
}

template <typename T> __device__ __forceinline__ T sq(T x) { return x * x; }

template <typename T> __device__ __forceinline__ T trigamma_st8(T z) {
  T w = z + T(8);
  T iw = T(1) / w;
  T iw2 = iw * iw;
  T recip2 = T(1) / sq(z) + T(1) / sq(z + T(1)) + T(1) / sq(z + T(2)) + T(1) / sq(z + T(3)) +
             T(1) / sq(z + T(4)) + T(1) / sq(z + T(5)) + T(1) / sq(z + T(6)) +
             T(1) / sq(z + T(7));
  T series = iw * iw2 * (T(1.0 / 6.0) - iw2 * (T(1.0 / 30.0) - iw2 * T(1.0 / 42.0)));
  return iw + T(0.5) * iw2 + series + recip2;
}

// ---- float64 psi and psi' -----------------------------------------------------
// Recurrence psi(x) = psi(x+1) - 1/x, psi'(x) = psi'(x+1) + 1/x^2 up to x >= 10
// (at most 10 shifts for x > 0), then the asymptotic series through the
// x^-14 term: truncation error < 1e-16 relative at x = 10.
__device__ __forceinline__ double digamma_f64(double x) {
  double acc = 0.0;
  for (int i = 0; i < 10 && x < 10.0; ++i) {
    acc -= 1.0 / x;
    x += 1.0;
  }
  double ix = 1.0 / x;
  double ix2 = ix * ix;
  double series =
      ix2 * (1.0 / 12.0 -
             ix2 * (1.0 / 120.0 -
                    ix2 * (1.0 / 252.0 -
                           ix2 * (1.0 / 240.0 -
                                  ix2 * (1.0 / 132.0 - ix2 * (691.0 / 32760.0 - ix2 * (1.0 / 12.0)))))));
  return acc + (log(x) - 0.5 * ix - series);
}

__device__ __forceinline__ double trigamma_f64(double x) {
  double acc = 0.0;
  for (int i = 0; i < 10 && x < 10.0; ++i) {
    acc += 1.0 / (x * x);
    x += 1.0;
  }
  double ix = 1.0 / x;
  double ix2 = ix * ix;
  // 1/x + 1/(2x^2) + sum_k B_2k / x^(2k+1)
  double series =
      ix * ix2 *
      (1.0 / 6.0 -
       ix2 * (1.0 / 30.0 -
              ix2 * (1.0 / 42.0 -
                     ix2 * (1.0 / 30.0 -
                            ix2 * (5.0 / 66.0 - ix2 * (691.0 / 2730.0 - ix2 * (7.0 / 6.0)))))));
  return acc + (ix + 0.5 * ix2 + series);
}

// Dtype gates of pydeseq2_tpu/ops/nb.py:66-70 and :272-280.
__device__ __forceinline__ float lgamma_fast(float z) { return lgamma_st8(z); }
__device__ __forceinline__ double lgamma_fast(double z) { return lgamma(z); }
__device__ __forceinline__ void psi_fast(float z, float& psi, float& tri) {
  psi = digamma_st8(z);
  tri = trigamma_st8(z);
}
__device__ __forceinline__ void psi_fast(double z, double& psi, double& tri) {
  psi = digamma_f64(z);
  tri = trigamma_f64(z);
}

// ---- small symmetric systems (pydeseq2_tpu/ops/smalllinalg.py) ---------------
// Packed upper triangle of a symmetric P x P matrix: index of (i, j), i <= j.
template <int P> __host__ __device__ constexpr int tri_idx(int i, int j) {
  return i <= j ? i * P - (i * (i - 1)) / 2 + (j - i) : tri_idx<P>(j, i);
}
template <int P> constexpr int NTRI = P * (P + 1) / 2;

template <typename T, int P> struct Chol {
  T L[P][P];
};

template <typename T, int P> __device__ __forceinline__ void chol(const T* M, Chol<T, P>& c) {
#pragma unroll
  for (int j = 0; j < P; ++j) {
    T s = M[tri_idx<P>(j, j)];
#pragma unroll
    for (int k = 0; k < j; ++k) s = s - c.L[j][k] * c.L[j][k];
    c.L[j][j] = m_sqrt(m_max(s, Lim<T>::tiny()));
#pragma unroll
    for (int i = j + 1; i < P; ++i) {
      T t = M[tri_idx<P>(i, j)];
#pragma unroll
      for (int k = 0; k < j; ++k) t = t - c.L[i][k] * c.L[j][k];
      c.L[i][j] = t / c.L[j][j];
    }
  }
}

template <typename T, int P>
__device__ __forceinline__ void chol_solve(const Chol<T, P>& c, const T* b, T* x) {
  T y[P];
#pragma unroll
  for (int i = 0; i < P; ++i) {
    T s = b[i];
#pragma unroll
    for (int k = 0; k < i; ++k) s = s - c.L[i][k] * y[k];
    y[i] = s / c.L[i][i];
  }
#pragma unroll
  for (int i = P - 1; i >= 0; --i) {
    T s = y[i];
#pragma unroll
    for (int k = i + 1; k < P; ++k) s = s - c.L[k][i] * x[k];
    x[i] = s / c.L[i][i];
  }
}

// Full inverse, row-major P x P.
template <typename T, int P> __device__ __forceinline__ void sym_inv(const T* M, T* inv) {
  if constexpr (P == 1) {
    inv[0] = T(1) / M[0];
  } else if constexpr (P == 2) {
    T a = M[0], c = M[1], d = M[2];
    T det = a * d - c * c;
    inv[0] = d / det;
    inv[1] = -c / det;
    inv[2] = -c / det;
    inv[3] = a / det;
  } else if constexpr (P == 3) {
    T a = M[0], b_ = M[1], c = M[2], d = M[3], e = M[4], f = M[5];
    T A = d * f - e * e;
    T B = c * e - b_ * f;
    T C = b_ * e - c * d;
    T D = a * f - c * c;
    T E = b_ * c - a * e;
    T F = a * d - b_ * b_;
    T det = a * A + b_ * B + c * C;
    inv[0] = A / det; inv[1] = B / det; inv[2] = C / det;
    inv[3] = B / det; inv[4] = D / det; inv[5] = E / det;
    inv[6] = C / det; inv[7] = E / det; inv[8] = F / det;
  } else {
    Chol<T, P> c;
    chol<T, P>(M, c);
#pragma unroll
    for (int j = 0; j < P; ++j) {
      T e[P], col[P];
#pragma unroll
      for (int i = 0; i < P; ++i) e[i] = (i == j) ? T(1) : T(0);
      chol_solve<T, P>(c, e, col);
#pragma unroll
      for (int i = 0; i < P; ++i) inv[i * P + j] = col[i];
    }
  }
}

// Solve M x = b (M packed upper triangle).
template <typename T, int P>
__device__ __forceinline__ void sym_solve(const T* M, const T* b, T* x) {
  if constexpr (P == 1) {
    x[0] = b[0] / M[0];
  } else if constexpr (P == 2) {
    T a = M[0], c = M[1], d = M[2];
    T det = a * d - c * c;
    x[0] = (d * b[0] - c * b[1]) / det;
    x[1] = (a * b[1] - c * b[0]) / det;
  } else if constexpr (P == 3) {
    T inv[9];
    sym_inv<T, 3>(M, inv);
#pragma unroll
    for (int i = 0; i < 3; ++i) x[i] = inv[i * 3 + 0] * b[0] + inv[i * 3 + 1] * b[1] + inv[i * 3 + 2] * b[2];
  } else {
    Chol<T, P> c;
    chol<T, P>(M, c);
    chol_solve<T, P>(c, b, x);
  }
}

template <typename T, int P> __device__ __forceinline__ T sym_logdet(const T* M) {
  if constexpr (P == 1) {
    return m_log(m_max(M[0], Lim<T>::tiny()));
  } else if constexpr (P == 2) {
    T a = M[0], c = M[1], d = M[2];
    return m_log(m_max(a * d - c * c, Lim<T>::tiny()));
  } else if constexpr (P == 3) {
    T a = M[0], b_ = M[1], c = M[2], d = M[3], e = M[4], f = M[5];
    T det = a * (d * f - e * e) + b_ * (c * e - b_ * f) + c * (b_ * e - c * d);
    return m_log(m_max(det, Lim<T>::tiny()));
  } else {
    Chol<T, P> c;
    chol<T, P>(M, c);
    T out = T(0);
#pragma unroll
    for (int j = 0; j < P; ++j) out = out + m_log(c.L[j][j]);
    return T(2) * out;
  }
}

// Unpack a packed symmetric matrix into row-major P x P.
template <typename T, int P> __device__ __forceinline__ void unpack(const T* Mp, T* M) {
#pragma unroll
  for (int i = 0; i < P; ++i)
#pragma unroll
    for (int j = 0; j < P; ++j) M[i * P + j] = Mp[tri_idx<P>(i, j)];
}

template <int P, typename T> __device__ __forceinline__ void add_diag(T* M, T v) {
#pragma unroll
  for (int p = 0; p < P; ++p) M[tri_idx<P>(p, p)] = M[tri_idx<P>(p, p)] + v;
}

// max_p |v_p|, NaN-propagating like jnp.abs(v).max().
template <int P, typename T> __device__ __forceinline__ T sup_norm(const T* v) {
  T s = m_abs(v[0]);
#pragma unroll
  for (int p = 1; p < P; ++p) s = m_max(s, m_abs(v[p]));
  return s;
}

// Linear predictor x_n . b of sample n, summed in coefficient order; the
// row of X is left in xv.
template <int P, typename T>
__device__ __forceinline__ T lin_pred(const T* __restrict__ X, int n, const T* b, T* xv) {
  const T* xn = X + (size_t)n * P;
  T xb = T(0);
#pragma unroll
  for (int p = 0; p < P; ++p) {
    xv[p] = __ldg(xn + p);
    xb = xb + b[p] * xv[p];
  }
  return xb;
}

// ---- NB GLM passes over one gene's row, one warp (pydeseq2_tpu/ops/irls.py) --
// Ridged NLL gradient at b and, with want_h, the packed exact Hessian
// X^T diag(mu (1 + a y)/(1 + a mu)^2) X (without ridge), mu = max(sf e^{xb},
// min_mu): ridged_grad / hess_fn of irls.py:214-221,319-330.
template <int P, typename T>
__device__ __forceinline__ void grad_pass(const T* __restrict__ y, const T* __restrict__ sf,
                                          const T* __restrict__ X, int N, int lane,
                                          const T* b, T disp, T inv_disp, T min_mu,
                                          bool want_h, T* grad, T* hess) {
#pragma unroll
  for (int p = 0; p < P; ++p) grad[p] = T(0);
#pragma unroll
  for (int i = 0; i < NTRI<P>; ++i) hess[i] = T(0);
  for (int n = lane; n < N; n += WARP) {
    T xv[P];
    const T xb = lin_pred<P, T>(X, n, b, xv);
    const T mu = m_max(__ldg(sf + n) * m_exp(xb), min_mu);
    const T yv = y[n];
    const T t = (inv_disp + yv) * mu / (inv_disp + mu);
#pragma unroll
    for (int p = 0; p < P; ++p) grad[p] += (t - yv) * xv[p];
    if (want_h) {
      const T den = T(1) + disp * mu;
      const T w = mu * (T(1) + disp * yv) / (den * den);
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const T wp = w * xv[p];
#pragma unroll
        for (int q = p; q < P; ++q) hess[tri_idx<P>(p, q)] += wp * xv[q];
      }
    }
  }
#pragma unroll
  for (int p = 0; p < P; ++p) grad[p] = warp_sum(grad[p]) + T(1e-6) * b[p];
  if (want_h) {
#pragma unroll
    for (int i = 0; i < NTRI<P>; ++i) hess[i] = warp_sum(hess[i]);
  }
}

// jnp.logaddexp: max(a, b) + log1p(exp(-|a - b|)), a + b where a - b is NaN.
template <typename T> __device__ __forceinline__ T m_logaddexp(T a, T b) {
  const T delta = a - b;
  return (delta != delta) ? a + b : m_max(a, b) + m_log1p(m_exp(-m_abs(delta)));
}

// One sample's share of the apeGLM log-likelihood (pydeseq2_tpu/ops/
// shrink.py:48-52): y xb - (y + s) logaddexp(xb + offset, log s).
template <typename T>
__device__ __forceinline__ T apeglm_ll_term(T y, T y_plus_s, T xb, T off, T log_s) {
  return y * xb - y_plus_s * m_logaddexp(xb + off, log_s);
}

// Dispatch a templated launcher over P = 1..8 (the statement after P may
// hold commas: it is variadic); P > 8 is refused.
#define PDT_DISPATCH_P(P_RUNTIME, ...)                   \
  switch (P_RUNTIME) {                                   \
    case 1: { constexpr int PP = 1; __VA_ARGS__; break; } \
    case 2: { constexpr int PP = 2; __VA_ARGS__; break; } \
    case 3: { constexpr int PP = 3; __VA_ARGS__; break; } \
    case 4: { constexpr int PP = 4; __VA_ARGS__; break; } \
    case 5: { constexpr int PP = 5; __VA_ARGS__; break; } \
    case 6: { constexpr int PP = 6; __VA_ARGS__; break; } \
    case 7: { constexpr int PP = 7; __VA_ARGS__; break; } \
    case 8: { constexpr int PP = 8; __VA_ARGS__; break; } \
    default: return (int)cudaErrorInvalidValue;          \
  }

}  // namespace pdt
