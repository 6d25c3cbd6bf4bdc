"""The plain DESeq2 refit route that decides a run's ``correct``.

A frozen copy of the plain PyTorch versions of the port's streamed summary
with Cook's outlier replacement and refit (``run_summary_streamed(...,
refit_cooks=True)``, ratio size factors, one process, no gene mesh), taken
as they stood when the benchmark was written. Each CUDA kernel of the port
is replaced here by the plain version beside it in the port's source, so
the arithmetic is the same, summed in the same order, rounded at the same
points. Two changes that leave each gene's answer as it was: the IRLS
rescue tiers run on the lanes they rescue only (each lane is independent),
and the fine dispersion scan, which the route does not run, is left out.

Imports torch, numpy, pandas and scipy; nothing of the program and nothing
of JAX. The counts go through in gene blocks, so the temporaries stay at
~20 (block, N) tensors whatever G is.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# ------------------------------------------------------------ ops.nb
_R_SWITCH = 8.0  # Stirling-difference form is used for r = 1/alpha >= 8

_HALF_LOG_2PI = 0.9189385332046727

def _lgamma_stirling8(z: torch.Tensor) -> torch.Tensor:
    """log Gamma(z), z > 0, by an 8-step shift and the Stirling series."""
    p1 = z * (z + 1.0) * (z + 2.0) * (z + 3.0)
    p2 = (z + 4.0) * (z + 5.0) * (z + 6.0) * (z + 7.0)
    w = z + 8.0
    iw = 1.0 / w
    iw2 = iw * iw
    series = iw * ((1.0 / 12.0) - iw2 * ((1.0 / 360.0) - iw2 * (1.0 / 1260.0)))
    return (
        (w - 0.5) * torch.log(w)
        - w
        + _HALF_LOG_2PI
        + series
        - torch.log(p1)
        - torch.log(p2)
    )

def _lgamma_fast(z: torch.Tensor) -> torch.Tensor:
    """Dtype-gated lgamma: Stirling-shift form in f32, library in f64."""
    if z.dtype == torch.float32:
        return _lgamma_stirling8(z)
    return torch.lgamma(z)

def _digamma_stirling8(z: torch.Tensor) -> torch.Tensor:
    """psi(z), the derivative of :func:`_lgamma_stirling8`."""
    w = z + 8.0
    iw = 1.0 / w
    iw2 = iw * iw
    recip = (
        1.0 / z
        + 1.0 / (z + 1.0)
        + 1.0 / (z + 2.0)
        + 1.0 / (z + 3.0)
        + 1.0 / (z + 4.0)
        + 1.0 / (z + 5.0)
        + 1.0 / (z + 6.0)
        + 1.0 / (z + 7.0)
    )
    series = iw2 * ((1.0 / 12.0) - iw2 * ((1.0 / 120.0) - iw2 * (1.0 / 252.0)))
    return torch.log(w) - 0.5 * iw - series - recip

def _trigamma_stirling8(z: torch.Tensor) -> torch.Tensor:
    """psi'(z), the derivative of :func:`_digamma_stirling8`."""
    w = z + 8.0
    iw = 1.0 / w
    iw2 = iw * iw
    recip2 = (
        1.0 / z**2
        + 1.0 / (z + 1.0) ** 2
        + 1.0 / (z + 2.0) ** 2
        + 1.0 / (z + 3.0) ** 2
        + 1.0 / (z + 4.0) ** 2
        + 1.0 / (z + 5.0) ** 2
        + 1.0 / (z + 6.0) ** 2
        + 1.0 / (z + 7.0) ** 2
    )
    series = iw * iw2 * ((1.0 / 6.0) - iw2 * ((1.0 / 30.0) - iw2 * (1.0 / 42.0)))
    return iw + 0.5 * iw2 + series + recip2

def _psi_series_f64(z: torch.Tensor):
    """(psi, psi') in float64, z > 0: shift by the recurrence to z >= 10
    (at most 10 steps), then the asymptotic series through z^-15.

    The same evaluation as the CUDA kernels' (csrc/common.cuh); accurate to
    ~1e-15 relative. ``torch.polygamma(1, .)`` is not: it keeps three
    Bernoulli terms after six shifts, ~1e-9 relative, on the CPU and the
    card alike.
    """
    acc_psi = torch.zeros_like(z)
    acc_tri = torch.zeros_like(z)
    x = z
    for _ in range(10):
        low = x < 10.0
        acc_psi = torch.where(low, acc_psi - 1.0 / x, acc_psi)
        acc_tri = torch.where(low, acc_tri + 1.0 / (x * x), acc_tri)
        x = torch.where(low, x + 1.0, x)
    ix = 1.0 / x
    ix2 = ix * ix
    s_psi = ix2 * (1.0 / 12.0 - ix2 * (1.0 / 120.0 - ix2 * (1.0 / 252.0 - ix2 * (
        1.0 / 240.0 - ix2 * (1.0 / 132.0 - ix2 * (691.0 / 32760.0 - ix2 * (1.0 / 12.0)))))))
    s_tri = ix * ix2 * (1.0 / 6.0 - ix2 * (1.0 / 30.0 - ix2 * (1.0 / 42.0 - ix2 * (
        1.0 / 30.0 - ix2 * (5.0 / 66.0 - ix2 * (691.0 / 2730.0 - ix2 * (7.0 / 6.0)))))))
    return acc_psi + (torch.log(x) - 0.5 * ix - s_psi), acc_tri + (ix + 0.5 * ix2 + s_tri)

def _digamma_fast(z: torch.Tensor):
    """Dtype-gated (psi, psi'): Stirling-shift forms in f32; accurate
    float64 forms in f64 (the JAX package's library digamma/polygamma)."""
    if z.dtype == torch.float32:
        return _digamma_stirling8(z), _trigamma_stirling8(z)
    return _psi_series_f64(z)

def nb_nll(counts: torch.Tensor, mu: torch.Tensor, alpha) -> torch.Tensor:
    """Per-lane NB negative log-likelihood, summed over the last axis.

    counts (..., N); mu broadcastable to counts; alpha broadcastable to the
    leading axes. Plain form for r < 8, Stirling-difference form above.
    """
    return nb_nll_terms(counts, mu, alpha).sum(-1)

def nb_nll_terms(counts: torch.Tensor, mu: torch.Tensor, alpha) -> torch.Tensor:
    """The per-sample terms of :func:`nb_nll`, before the sum."""
    alpha = torch.as_tensor(alpha, dtype=mu.dtype, device=mu.device)
    r = 1.0 / alpha[..., None]

    ylogmu = torch.where(counts > 0, counts * torch.log(mu), 0.0)
    lgy1 = torch.lgamma(counts + 1.0)

    logbinom = torch.lgamma(counts + r) - lgy1 - torch.lgamma(r)
    plain = -r * torch.log(r) - logbinom + (counts + r) * torch.log(mu + r) - ylogmu

    l1y = torch.log1p(counts / r)
    l1m = torch.log1p(mu / r)
    yr = counts + r
    stable = (
        lgy1
        + counts
        - (yr - 0.5) * l1y
        + yr * l1m
        - ylogmu
        + counts / (12.0 * r * yr)
        + (1.0 / yr**3 - 1.0 / r**3) / 360.0
    )
    return torch.where(r < _R_SWITCH, plain, stable)

def _sum_f64(per: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis accumulated in float64, rounded once to the
    terms' dtype: the centred terms cancel to totals far below their sizes
    (at 10000 samples, terms of ~4 summing to ~2), so a float32 sum in any
    order is off by ~1e-5 of the total, enough to move the dispersion
    scan's argmin and the Newton acceptance. The kernels (csrc/disp_scan.cu,
    csrc/disp_newton.cu) accumulate in float64 too."""
    return per.sum(-1, dtype=torch.float64).to(per.dtype)

def nb_nll_centered(
    counts: torch.Tensor, mu: torch.Tensor, alpha, branch: str = "auto"
) -> torch.Tensor:
    """``nb_nll`` minus its alpha-independent Poisson-limit constant.

    ``branch``: "plain" (every lane has r < 8), "stable" (every lane has
    r >= 8) or "auto" (per element, with the transcendentals shared between
    the two forms exactly as the JAX package shares them). r is computed as
    ``1/alpha`` (``alpha = exp(la)`` upstream) — keep it so: near r = 8 the
    branch choice depends on the rounding. The terms are summed in float64
    and rounded once (:func:`_sum_f64`).
    """
    alpha = torch.as_tensor(alpha, dtype=mu.dtype, device=mu.device)
    r = 1.0 / alpha[..., None]

    if branch == "plain":
        per = (
            -r * torch.log(r)
            - _lgamma_fast(counts + r)
            + torch.lgamma(r)
            + (counts + r) * torch.log(mu + r)
            - mu
        )
    elif branch == "stable":
        u = counts / r
        v = mu / r
        l1p_u = torch.log1p(u)
        l1p_v = torch.log1p(v)
        yr = counts + r
        per = (
            -r * (l1p_u - u)
            - (counts - 0.5) * l1p_u
            + r * (l1p_v - v)
            + counts * l1p_v
            + counts / (12.0 * r * yr)
            + (1.0 / yr**3 - 1.0 / r**3) / 360.0
        )
    else:
        u = counts / r
        v = mu / r
        l1p_u = torch.log1p(u)
        l1p_v = torch.log1p(v)
        yr = counts + r
        log_r = torch.log(r)
        plain = -r * log_r - _lgamma_fast(yr) + torch.lgamma(r) + yr * (log_r + l1p_v) - mu
        stable = (
            -r * (l1p_u - u)
            - (counts - 0.5) * l1p_u
            + r * (l1p_v - v)
            + counts * l1p_v
            + counts / (12.0 * r * yr)
            + (1.0 / yr**3 - 1.0 / r**3) / 360.0
        )
        per = torch.where(r < _R_SWITCH, plain, stable)
    return _sum_f64(per)

def nb_nll_centered_fgh(
    counts: torch.Tensor, mu: torch.Tensor, la: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Value, gradient and curvature of :func:`nb_nll_centered` in log-alpha.

    One pass, both branches, selected per element at r < 8. Here r is
    ``exp(-la)`` (not ``1/exp(la)``), as in the JAX package. Each sum is
    accumulated in float64 and rounded once (:func:`_sum_f64`).
    """
    r = torch.exp(-la)[..., None]
    y = counts

    u = y / r
    v = mu / r
    l1p_u = torch.log1p(u)
    l1p_v = torch.log1p(v)
    yr = y + r
    s_u = y / yr
    s_v = mu / (mu + r)
    q_u = y * r / yr**2
    q_v = mu * r / (mu + r) ** 2

    iyr = 1.0 / yr
    iyr2 = iyr * iyr
    ir = 1.0 / r
    ir3 = ir * ir * ir
    f_st = (
        -r * (l1p_u - u)
        - (y - 0.5) * l1p_u
        + r * (l1p_v - v)
        + y * l1p_v
        + y * ir * iyr / 12.0
        + (iyr2 * iyr - ir3) / 360.0
    )
    dT5 = y * (y + 2.0 * r) * ir * iyr2 / 12.0
    dT6 = (r * iyr2 * iyr2 - ir3) / 120.0
    g_st = (
        r * (l1p_u - s_u)
        - (y - 0.5) * s_u
        - r * (l1p_v - s_v)
        + y * s_v
        + dT5
        + dT6
    )
    d2T5 = y * (y * y + 3.0 * r * y + 4.0 * r * r) * ir * iyr2 * iyr / 12.0
    d2T6 = (-r * iyr2 * iyr2 + 4.0 * r * r * iyr2 * iyr2 * iyr - 3.0 * ir3) / 120.0
    h_st = (
        -r * (l1p_u - s_u)
        + r * (s_u - q_u)
        - (y - 0.5) * q_u
        + r * (l1p_v - s_v)
        - r * (s_v - q_v)
        + y * q_v
        + d2T5
        + d2T6
    )

    log_r = torch.log(r)
    lg_yr = _lgamma_fast(yr)
    lg_r = torch.lgamma(r)
    psi_yr, tri_yr = _digamma_fast(yr)
    psi_r, tri_r = _digamma_fast(r)
    f_pl = -r * log_r - lg_yr + lg_r + yr * (log_r + l1p_v) - mu
    yr_over = yr / (mu + r)
    g_pl = r * (1.0 + psi_yr - psi_r - l1p_v - yr_over)
    h_pl = (
        r * (l1p_v - 1.0 - s_v + psi_r - psi_yr)
        + r * r * (tri_r - tri_yr)
        + r * (y + 2.0 * r) / (mu + r)
        - r * r * yr / (mu + r) ** 2
    )

    sel = r < _R_SWITCH
    f = _sum_f64(torch.where(sel, f_pl, f_st))
    g = _sum_f64(torch.where(sel, g_pl, g_st))
    h = _sum_f64(torch.where(sel, h_pl, h_st))
    return f, g, h


# ------------------------------------------------------------ ops.smalllinalg
_UNROLL_MAX = 8

def _chol_unrolled(M: torch.Tensor) -> dict:
    """Unrolled Cholesky factors {(i, j): L_ij} (i >= j) of batched M."""
    P = M.shape[-1]
    tiny = torch.finfo(M.dtype).tiny
    L: dict = {}
    for j in range(P):
        s = M[..., j, j]
        for k in range(j):
            s = s - L[(j, k)] * L[(j, k)]
        L[(j, j)] = torch.sqrt(torch.clamp(s, min=tiny))
        for i in range(j + 1, P):
            s = M[..., i, j]
            for k in range(j):
                s = s - L[(i, k)] * L[(j, k)]
            L[(i, j)] = s / L[(j, j)]
    return L

def _chol_solve_unrolled(L: dict, b: torch.Tensor) -> torch.Tensor:
    """Solve L L^T x = b given unrolled factors. b: (..., P)."""
    P = b.shape[-1]
    y = []
    for i in range(P):
        s = b[..., i]
        for k in range(i):
            s = s - L[(i, k)] * y[k]
        y.append(s / L[(i, i)])
    x = [None] * P
    for i in reversed(range(P)):
        s = y[i]
        for k in range(i + 1, P):
            s = s - L[(k, i)] * x[k]
        x[i] = s / L[(i, i)]
    return torch.stack(x, dim=-1)

def sym_solve(M: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve M x = b for symmetric M, batched. b: (..., P) -> (..., P)."""
    P = M.shape[-1]
    if P == 1:
        return b / M[..., 0, 0:1]
    if P == 2:
        a, c = M[..., 0, 0], M[..., 0, 1]
        d = M[..., 1, 1]
        det = a * d - c * c
        x0 = (d * b[..., 0] - c * b[..., 1]) / det
        x1 = (a * b[..., 1] - c * b[..., 0]) / det
        return torch.stack([x0, x1], dim=-1)
    if P == 3:
        return (sym_inv(M) @ b[..., None])[..., 0]
    if P <= _UNROLL_MAX:
        return _chol_solve_unrolled(_chol_unrolled(M), b)
    return torch.linalg.solve(M, b[..., None])[..., 0]

def sym_inv(M: torch.Tensor) -> torch.Tensor:
    """Inverse of symmetric M, batched (..., P, P)."""
    P = M.shape[-1]
    if P == 1:
        return 1.0 / M
    if P == 2:
        a, c = M[..., 0, 0], M[..., 0, 1]
        d = M[..., 1, 1]
        det = a * d - c * c
        inv = torch.stack(
            [torch.stack([d, -c], dim=-1), torch.stack([-c, a], dim=-1)], dim=-2
        )
        return inv / det[..., None, None]
    if P == 3:
        a, b_, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
        d, e = M[..., 1, 1], M[..., 1, 2]
        f = M[..., 2, 2]
        A = d * f - e * e
        B = c * e - b_ * f
        C = b_ * e - c * d
        D = a * f - c * c
        E = b_ * c - a * e
        F = a * d - b_ * b_
        det = a * A + b_ * B + c * C
        inv = torch.stack(
            [
                torch.stack([A, B, C], dim=-1),
                torch.stack([B, D, E], dim=-1),
                torch.stack([C, E, F], dim=-1),
            ],
            dim=-2,
        )
        return inv / det[..., None, None]
    if P <= _UNROLL_MAX:
        L = _chol_unrolled(M)
        eye = torch.eye(P, dtype=M.dtype, device=M.device)
        cols = [
            _chol_solve_unrolled(L, eye[j].expand(M.shape[:-1])) for j in range(P)
        ]
        return torch.stack(cols, dim=-1)
    return torch.linalg.inv(M)

def sym_logdet(M: torch.Tensor) -> torch.Tensor:
    """log |det M| for symmetric PSD M, batched (..., P, P) -> (...)."""
    P = M.shape[-1]
    tiny = torch.finfo(M.dtype).tiny
    if P == 1:
        return torch.log(torch.clamp(M[..., 0, 0], min=tiny))
    if P == 2:
        a, c = M[..., 0, 0], M[..., 0, 1]
        d = M[..., 1, 1]
        return torch.log(torch.clamp(a * d - c * c, min=tiny))
    if P == 3:
        a, b_, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
        d, e = M[..., 1, 1], M[..., 1, 2]
        f = M[..., 2, 2]
        det = a * (d * f - e * e) + b_ * (c * e - b_ * f) + c * (b_ * e - c * d)
        return torch.log(torch.clamp(det, min=tiny))
    if P <= _UNROLL_MAX:
        L = _chol_unrolled(M)
        out = 0.0
        for j in range(P):
            out = out + torch.log(L[(j, j)])
        return 2.0 * out
    return torch.linalg.slogdet(M)[1]

def weighted_gram(X: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """(..., P, P) Gram matrices X^T diag(W) X for weights W of shape (..., N).

    One (..., N) @ (N, P*P) product against the per-sample outer products,
    as the JAX package's ``einsum("gn,np,nq->gpq")`` leaves it to a dot.
    """
    N, P = X.shape
    XX = (X[:, :, None] * X[:, None, :]).reshape(N, P * P)
    return (W @ XX).reshape(W.shape[:-1] + (P, P))


# ------------------------------------------------------------ ops.select
def _monotone_key(x: torch.Tensor) -> torch.Tensor:
    """Signed integer keys with x < y  <=>  key(x) < key(y) (sign-flip map).

    The map is an involution on the bit patterns, so :func:`_key_to_float`
    applies it again. It orders like the JAX package's unsigned keys (the
    two differ only in the top bit).
    """
    if x.dtype == torch.float32:
        i = x.view(torch.int32)
        return i ^ ((i >> 31) & 0x7FFFFFFF)
    if x.dtype == torch.float64:
        i = x.view(torch.int64)
        return i ^ ((i >> 63) & 0x7FFFFFFFFFFFFFFF)
    raise TypeError(f"unsupported dtype {x.dtype}")

def _key_to_float(key: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    bits = 31 if dtype == torch.float32 else 63
    mask = (1 << bits) - 1
    return (key ^ ((key >> bits) & mask)).view(dtype)

def order_stats_select_plain(
    x: torch.Tensor, ranks: tuple[torch.Tensor, ...], axis: int = 0
) -> tuple[torch.Tensor, ...]:
    """Plain version: sort the keys along ``axis`` and gather each rank."""
    keys = _monotone_key(x).movedim(axis, 0)
    red_shape = keys.shape[1:]
    srt = keys.sort(dim=0).values
    out = []
    for k in ranks:
        k = torch.as_tensor(k, dtype=torch.int64, device=x.device).expand(red_shape)
        out.append(_key_to_float(srt.gather(0, k[None]).squeeze(0), x.dtype))
    return tuple(out)

def order_stats_select(
    x: torch.Tensor, ranks: tuple[torch.Tensor, ...], axis: int = 0
) -> tuple[torch.Tensor, ...]:
    """Exact k-th smallest elements of ``x`` along ``axis``, one per rank.

    ``x`` is float32/float64 with excluded entries encoded as +inf; ``ranks``
    are 0-based integer ranks broadcastable to the reduced shape, within the
    valid count. Returns values bit-identical to ``sort(x, axis)[k]``.
    """
    if x.shape[axis] == 0:
        red = x.movedim(axis, 0).shape[1:]
        return tuple(torch.full(red, float("nan"), dtype=x.dtype, device=x.device) for _ in ranks)
    return order_stats_select_plain(x, ranks, axis)

def masked_median_select(
    values: torch.Tensor, n_valid: torch.Tensor, axis: int = 0
) -> torch.Tensor:
    """Median over the valid entries of ``values`` along ``axis``.

    ``values`` holds +inf at excluded entries and ``n_valid`` the per-column
    count of valid ones. Averages the two middle order statistics as
    ``np.median`` does; columns with ``n_valid == 0`` give NaN.
    """
    n_valid = torch.as_tensor(n_valid, dtype=torch.int64, device=values.device)
    k_lo = torch.clamp((n_valid - 1) // 2, min=0)
    k_hi = n_valid // 2
    v_lo, v_hi = order_stats_select(values, (k_lo, k_hi), axis=axis)
    med = (v_lo + v_hi) / 2.0
    return torch.where(n_valid > 0, med, torch.full_like(med, float("nan")))


# ------------------------------------------------------------ ops.stats
# JAX's trimmed_mean switches from the sort path to the select path here
# (pydeseq2_tpu/ops/stats.py:46).
_SELECT_MIN_N = 1024

def _kept_sum_mean(total64: torch.Tensor, n_kept: int, dtype) -> torch.Tensor:
    """The kept values' float64 sum rounded once to ``dtype``, over their
    count (the ``trimmed_var`` kernel's last step). The count is a 0-d
    tensor: a Python scalar divisor on the card becomes a product with its
    reciprocal."""
    return total64.to(dtype) / torch.tensor(n_kept, dtype=dtype, device=total64.device)

def _trimmed_mean_plain(x: torch.Tensor, trim: float, axis: int) -> torch.Tensor:
    """JAX's two paths (``pydeseq2_tpu/ops/stats.py:28``): the sort slice
    below n = 1024, ``trimmed_mean_select``'s kept multiset by order
    statistics at or above it; both sum the kept values in float64."""
    n = x.shape[axis]
    k = math.floor(n * trim)
    xm = x.movedim(axis, 0)
    if k == 0:
        return _kept_sum_mean(xm.sum(0, dtype=torch.float64), n, x.dtype)
    if n < _SELECT_MIN_N:
        kept = torch.sort(xm, dim=0).values[k:n - k]
        return _kept_sum_mean(kept.sum(0, dtype=torch.float64), n - 2 * k, x.dtype)
    lo, hi = order_stats_select_plain(xm, (k, n - 1 - k), axis=0)
    strict = torch.where((xm > lo) & (xm < hi), xm, torch.zeros_like(xm)).sum(0, dtype=torch.float64)
    copies_lo = ((xm <= lo).sum(0) - k).to(torch.float64)
    copies_hi = (n - k - (xm < hi).sum(0)).to(torch.float64)
    total = strict + lo.to(torch.float64) * copies_lo + hi.to(torch.float64) * copies_hi
    return torch.where(lo == hi, lo, _kept_sum_mean(total, n - 2 * k, x.dtype))

def _trimmed_variance_plain(x: torch.Tensor, trim: float, axis: int) -> torch.Tensor:
    rm = _trimmed_mean_plain(x, trim, axis)
    sqerror = (x - rm.unsqueeze(axis)) ** 2
    return 1.51 * _trimmed_mean_plain(sqerror, trim, axis)

# (trim ratio, scale) by cohort-size bin: n < 3.5, n < 23.5, n >= 23.5
# (reference pydeseq2/utils.py:622-645).
_COHORT_TRIM_RATIOS = (1.0 / 3.0, 1.0 / 4.0, 1.0 / 8.0)

_COHORT_SCALES = (2.04, 1.86, 1.51)

def cohort_bin(n: int) -> int:
    return 2 if n >= 23.5 else 1 if n >= 3.5 else 0

def _cohorts(cells):
    """Sample indices of each cohort (levels in first-seen order) and its
    size bin."""
    cells = [int(c) for c in cells]
    cohorts = [[i for i, c in enumerate(cells) if c == lvl] for lvl in dict.fromkeys(cells)]
    return cohorts, [cohort_bin(len(idx)) for idx in cohorts]

def _trimmed_cell_variance_plain(counts: torch.Tensor, cells) -> torch.Tensor:
    var_ests = []
    for idx, b in zip(*_cohorts(cells)):
        trim, scale = _COHORT_TRIM_RATIOS[b], _COHORT_SCALES[b]
        sub = counts[torch.tensor(idx, device=counts.device), :]
        cell_means = _trimmed_mean_plain(sub, trim, 0)
        sqerror = (sub - cell_means[None, :]) ** 2
        var_ests.append(scale * _trimmed_mean_plain(sqerror, trim, 0))
    return torch.stack(var_ests, dim=0).amax(dim=0)

def trimmed_mean_masked(values: torch.Tensor, sel: torch.Tensor, cut: float) -> torch.Tensor:
    """Trimmed mean over a dynamic lane selection (the mean-trend fallback).

    Deselected lanes sort to +inf and a rank-range mask replaces the slice,
    as in ``pydeseq2_tpu/ops/stats.py:67`` (scipy.stats.trim_mean semantics).
    """
    G = values.shape[0]
    inf = torch.full_like(values, float("inf"))
    sorted_vals = torch.sort(torch.where(sel, values, inf)).values
    n_sel = sel.sum()
    ntrim = torch.floor(n_sel.to(torch.float64) * cut).to(torch.int64)
    idx = torch.arange(G, device=values.device)
    in_range = (idx >= ntrim) & (idx < n_sel - ntrim)
    zero = torch.zeros_like(sorted_vals)
    safe = torch.where(torch.isinf(sorted_vals), zero, sorted_vals)
    return torch.where(in_range, safe, zero).sum() / torch.clamp(in_range.sum(), min=1)

def nanmedian(x: torch.Tensor) -> torch.Tensor:
    """Median of the non-NaN entries of a 1-D tensor (NaN if there are none).

    ``torch.nanmedian`` returns the LOWER middle value for an even count;
    ``jnp.nanmedian``, which the JAX pipeline uses for the dispersion prior
    (pydeseq2_tpu/fused.py:450-451), averages the two. This runs the exact
    order-statistic select on one column instead.
    """
    nan = torch.isnan(x)
    vals = torch.where(nan, torch.full_like(x, float("inf")), x)
    return masked_median_select(vals[:, None], (~nan).sum(), axis=0)[0]

def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` rounded once, as a fused multiply-add rounds it.

    float32 is evaluated in float64 (the product is exact there); float64
    takes Dekker's exact product and a compensated sum, which rounds as an
    FMA except in halfway cases of the last bit.
    """
    if a.dtype == torch.float32:
        return (a.double() * b.double() + c.double()).float()
    split = 134217729.0  # 2**27 + 1

    def halves(x):
        t = split * x
        hi = t - (t - x)
        return hi, x - hi

    p = a * b
    ah, al = halves(a)
    bh, bl = halves(b)
    err = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    s = p + c
    bb = s - p
    return s + (((p - (s - bb)) + (c - bb)) + err)

def nanquantile(x: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """``jnp.nanquantile(x, q)`` ("linear") of a 1-D tensor, with its rounding.

    JAX forms ``lo * (1 - w) + hi * w`` at JAX's positions, and XLA
    contracts it to ``fma(hi, w, lo * (1 - w))``; ``torch.nanquantile``
    interpolates with ``lerp``, which rounds differently. One ulp of a
    cutoff moves a gene across ``base_mean >= cutoff`` (tied base means sit
    exactly on it), so the contraction is reproduced. Positions are computed
    in the dtype of ``q`` as JAX computes them.
    """
    s = torch.sort(x).values  # NaN sorts last
    counts = (~torch.isnan(s)).sum().to(q.dtype)
    pos = q * (counts - 1)
    low = torch.floor(pos)
    high = torch.ceil(pos)
    high_w = pos - low
    low_w = 1 - high_w
    top = counts - 1
    low = torch.clamp(torch.minimum(low, top), min=0).to(torch.int64)
    high = torch.clamp(torch.minimum(high, top), min=0).to(torch.int64)
    return _fma(s[high].to(q.dtype), high_w, s[low].to(q.dtype) * low_w).to(x.dtype)

def _bh_shared_order(p: torch.Tensor, order: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """BH of a 1-D ``p`` under each row of ``mask`` (..., G), sharing one
    ascending order of ``p``: NaN outside the mask. Each row's masked subset
    keeps its relative order under the shared sort, so its rank is a cumsum
    of the sorted mask (pydeseq2_tpu/ops/stats.py:175-190)."""
    n_valid = mask.sum(dim=-1, keepdim=True)
    p_sorted = p[order]
    mask_sorted = mask[..., order]
    ranks = torch.cumsum(mask_sorted.to(p.dtype), dim=-1)
    scaled = torch.where(
        mask_sorted,
        p_sorted * n_valid / torch.clamp(ranks, min=1.0),
        torch.full_like(ranks, float("inf")),
    )
    adj_sorted = torch.clamp(cummin_reverse(scaled), max=1.0)
    adj = torch.empty_like(adj_sorted)
    adj[..., order] = adj_sorted
    return torch.where(mask, adj, torch.full_like(adj, float("nan")))

def cummin_reverse(x: torch.Tensor) -> torch.Tensor:
    """Running minimum from the right along the last axis."""
    return torch.flip(torch.cummin(torch.flip(x, (-1,)), dim=-1).values, (-1,))

def _bh_masks(p, valid, base_mean, cutoffs) -> torch.Tensor:
    """(rows, G) masks: ``base_mean >= cutoffs[j] & valid & ~isnan(p)``, one
    row of ``valid & ~isnan(p)`` without cutoffs."""
    masks = valid[None, :] if base_mean is None else (base_mean[None, :] >= cutoffs[:, None]) & valid[None, :]
    return masks & ~torch.isnan(p)

def _bh_count_plain(p, order, valid, base_mean, cutoffs, alpha):
    """Each row's count of adjusted values below ``alpha`` as the rank of its
    last masked position whose clipped scaled value is below ``alpha``."""
    masks = _bh_masks(p, valid, base_mean, cutoffs)
    if p.shape[0] == 0:
        return torch.zeros(masks.shape[0], dtype=torch.int64, device=p.device)
    n_valid = masks.sum(dim=-1, keepdim=True)
    mask_sorted = masks[:, order]
    ranks = torch.cumsum(mask_sorted.to(p.dtype), dim=-1)
    scaled = p[order] * n_valid / torch.clamp(ranks, min=1.0)
    hit = mask_sorted & (torch.clamp(scaled, max=1.0) < alpha)
    return torch.where(hit, ranks, torch.zeros_like(ranks)).amax(dim=-1).to(torch.int64)

def _bh_adjust_plain(p, order, valid, base_mean, cutoffs, j):
    """Row ``j`` (a 0-d integer tensor) of the sweep, (1, G); every row,
    (rows, G), when ``j`` is None."""
    if cutoffs is not None and j is not None:
        cutoffs = cutoffs.index_select(0, j.reshape(1).to(torch.int64))
    return _bh_shared_order(p, order, _bh_masks(p, valid, base_mean, cutoffs))

def bh_rejections(
    p: torch.Tensor,
    order: torch.Tensor,
    valid: torch.Tensor,
    base_mean: torch.Tensor | None = None,
    cutoffs: torch.Tensor | None = None,
    alpha: float = 0.05,
) -> torch.Tensor:
    """The rejection counts ``num_rej`` (rows,) int64 of :func:`bh_sweep`,
    ``(adj < alpha).sum(1)``, without the adjusted matrix."""
    return _bh_count_plain(p, order, valid, base_mean, cutoffs, alpha)

def bh_adjust_row(
    p: torch.Tensor,
    order: torch.Tensor,
    valid: torch.Tensor,
    base_mean: torch.Tensor | None = None,
    cutoffs: torch.Tensor | None = None,
    j: torch.Tensor | None = None,
) -> torch.Tensor:
    """Row ``j`` (G,) of :func:`bh_sweep`'s adjusted values: ``j`` a 0-d
    integer tensor on ``p``'s device (the lowess pick's, no host read), row
    0 when None (the one row without cutoffs)."""
    if j is None and cutoffs is not None:
        j = torch.zeros((), dtype=torch.int64, device=p.device)
    return _bh_adjust_plain(p, order, valid, base_mean, cutoffs, j)[0]

def _median_nan(x: torch.Tensor) -> torch.Tensor:
    """``jnp.median`` of a 1-D tensor: the mean of the middle pair, NaN if
    any entry is NaN."""
    return torch.where(torch.isnan(x).any(), torch.full_like(x[0], float("nan")), nanmedian(x))

def _sum_in_order(m: torch.Tensor) -> torch.Tensor:
    """Sum over dim 0 one row at a time, in index order: the order in which
    the ``lowess`` kernel's thread for each point adds its terms."""
    acc = m[0]
    for row in m[1:]:
        acc = acc + row
    return acc

def lowess_device(
    features: torch.Tensor, targets: torch.Tensor, frac: float = 2.0 / 3.0, it: int = 3
) -> torch.Tensor:
    """Tricube-weighted robust local linear regression over a small grid
    (the 50 independent-filtering cutoffs): closed-form 2x2 weighted least
    squares per point and ``it`` robustifying rounds. Port of
    ``pydeseq2_tpu/ops/stats.py:218`` (reference pydeseq2/utils.py:1379-1443).
    The weighted sums run over the points in index order, as the kernel's
    do: each local determinant sw swff - swf^2 cancels ~100x over a 10-point
    window, so another order would move the fit well above eps."""
    f = features
    y = targets.to(f.dtype)
    n = f.shape[0]
    r = int(math.ceil(frac * n))
    dists = torch.abs(f[:, None] - f[None, :])
    h = torch.clamp(torch.sort(dists, dim=1).values[:, r], min=1e-12)
    w = torch.clamp(dists / h[None, :], 0.0, 1.0)
    w = (1.0 - w**3) ** 3  # column i: weights of the local fit at i

    delta = torch.ones(n, dtype=f.dtype, device=f.device)
    for _ in range(it):
        weights = delta[:, None] * w
        terms = torch.stack([weights, weights * f[:, None], weights * (f * f)[:, None], weights * y[:, None],
                             weights * (y * f)[:, None]], dim=1)
        sw, swf, swff, b0, b1 = _sum_in_order(terms)
        det = sw * swff - swf**2
        beta0 = (b0 * swff - b1 * swf) / det
        beta1 = (sw * b1 - swf * b0) / det
        yest = beta0 + beta1 * f
        resid = y - yest
        s = _median_nan(torch.abs(resid))
        delta = torch.where(
            s == 0,
            (torch.abs(resid) > 0).to(f.dtype),
            torch.clamp(resid / (6.0 * s), -1.0, 1.0),
        )
        delta = (1.0 - delta**2) ** 2
    return yest

def _lowess_pick_plain(theta: torch.Tensor, num_rej: torch.Tensor, frac: float):
    rej = num_rej.to(theta.dtype)
    lo = lowess_device(theta, rej, frac=frac)
    nan = torch.tensor(float("nan"), dtype=theta.dtype, device=theta.device)
    sq = torch.where(num_rej > 0, rej - lo, nan) ** 2
    kept = ~torch.isnan(sq)
    # nanmean, summed in index order (0/0, NaN, when no count is positive)
    ssum = _sum_in_order(torch.where(kept, sq, torch.zeros_like(sq))[:, None])[0]
    thresh = lo.amax() - torch.sqrt(ssum / kept.sum().to(sq.dtype))
    above = num_rej > thresh
    j = torch.where(above.any(), torch.argmax(above.to(torch.uint8)), 0)
    return lo, torch.where(num_rej.amax() <= 10, 0, j)

def lowess_pick(theta: torch.Tensor, num_rej: torch.Tensor, frac: float = 1.0 / 5.0):
    """The independent-filtering cutoff: ``(yest (n,), j)``.

    :func:`lowess_device` (3 robust rounds) of the rejection counts
    ``num_rej`` (n,) int64 over the quantiles ``theta`` (n,), then the
    pick of ``pydeseq2_tpu/fused.py:763-768``: ``j`` (a 0-d int64 tensor)
    is the first row whose count exceeds max(yest) less the RMS of the
    residuals where the count is positive, 0 if none does (a NaN threshold
    included) or if no row has more than 10 rejections.
    """
    return _lowess_pick_plain(theta, num_rej, frac)


# ------------------------------------------------------------ ops.linreg
def ols_pinv(design_matrix: torch.Tensor) -> torch.Tensor:
    """Moore-Penrose pseudo-inverse of the design matrix (P, N), computed once."""
    return torch.linalg.pinv(design_matrix)

def fit_rough_dispersions_batch(
    normed_counts: torch.Tensor, design_matrix: torch.Tensor
) -> torch.Tensor:
    """(G,) residual-based rough dispersion estimates."""
    num_samples, num_vars = design_matrix.shape
    pinv = torch.linalg.pinv(design_matrix)
    y_hat = (normed_counts @ pinv.T) @ design_matrix.T
    y_hat = torch.clamp(y_hat, min=1.0)
    alpha_rde = (
        ((normed_counts - y_hat) ** 2 - y_hat) / ((num_samples - num_vars) * y_hat**2)
    ).sum(dim=1)
    return torch.clamp(alpha_rde, min=0.0)

def fit_moments_dispersions_batch(
    normed_counts: torch.Tensor, size_factors: torch.Tensor
) -> torch.Tensor:
    """(G,) method-of-moments dispersions (ddof=1 variance, NaN -> 0)."""
    n = normed_counts.shape[1]
    s_mean_inv = (1.0 / size_factors).mean()
    mu = normed_counts.mean(dim=1)
    sigma = ((normed_counts - mu[:, None]) ** 2).sum(dim=1) / (n - 1)
    raw = (sigma - s_mean_inv * mu) / mu**2
    return torch.nan_to_num(raw)

def mu_from_coef(beta_coef: torch.Tensor, size_factors: torch.Tensor, design_matrix: torch.Tensor,
                 min_mu: float) -> torch.Tensor:
    """(G, N) linear mu ``max(sf * (beta_coef @ X.T), min_mu)`` from the OLS
    coefficients (``pydeseq2_tpu/fused_stream.py:308-314``)."""
    return torch.clamp(size_factors[None, :] * (beta_coef @ design_matrix.T), min=min_mu)

def _mom_plain(counts, size_factors, X, pinv, min_mu, want_mu, normed=False):
    y = counts if normed else counts / size_factors[None, :]
    rough = fit_rough_dispersions_batch(y, X)
    moments = fit_moments_dispersions_batch(y, size_factors)
    coef = y @ pinv.T
    return rough, moments, coef, mu_from_coef(coef, size_factors, X, min_mu) if want_mu else None

def mom_and_mu_coef(
    counts: torch.Tensor,
    size_factors: torch.Tensor,
    design_matrix: torch.Tensor,
    pinv: torch.Tensor,
    min_mu: float = 0.5,
    want_mu: bool = True,
    normed: bool = False,
):
    """The method-of-moments inputs and the linear mu init in one pass:
    ``(rough (G,), moments (G,), beta_coef (G, P), mu_hat (G, N) or None)``.

    With y = counts / sf: ``rough`` is :func:`fit_rough_dispersions_batch`,
    ``moments`` :func:`fit_moments_dispersions_batch` (both unclamped),
    ``beta_coef = y @ pinv.T`` the OLS coefficients, and with ``want_mu``
    ``mu_hat = max(sf * (beta_coef @ X.T), min_mu)``, which is
    :func:`fit_lin_mu_batch`. ``pinv`` is :func:`ols_pinv` of the design.
    With ``normed``, ``counts`` already holds y (the class API's MoM
    methods receive normalised counts); ``size_factors`` then enter only
    ``moments`` (mean(1/sf)) and mu.
    """
    return _mom_plain(counts, size_factors, design_matrix, pinv, min_mu, want_mu, normed)


# ------------------------------------------------------------ ops.dispersion
def _alpha_objective(
    la: torch.Tensor,
    counts: torch.Tensor,
    X: torch.Tensor,
    mu: torch.Tensor,
    la_hat: torch.Tensor,
    pdv: torch.Tensor,
    cr_reg: bool,
    prior_reg: bool,
    branch: str = "auto",
) -> torch.Tensor:
    """Per-lane objective: centred NB NLL + Cox-Reid + optional prior."""
    alpha = torch.exp(la)
    obj = nb_nll_centered(counts, mu, alpha, branch=branch)
    if cr_reg:
        W = mu / (1.0 + mu * alpha[:, None])
        obj = obj + 0.5 * sym_logdet(weighted_gram(X, W))
    if prior_reg:
        obj = obj + (la - la_hat) ** 2 / (2.0 * pdv)
    return obj

def _scan_branches(grid_length: int, step1_f: float, lo_f: float) -> tuple[int, int]:
    """[0, bnd_start) stable, [bnd_start, bnd_end) per element, rest plain —
    the chunked regions of the JAX scan (4 points per chunk)."""
    la_threshold = -math.log(_R_SWITCH)
    k_split = int(math.floor((la_threshold - lo_f) / step1_f)) + 1
    k_split = max(0, min(grid_length, k_split))
    kpts = 4 if grid_length % 4 == 0 else 1
    return (k_split // kpts) * kpts, -(-k_split // kpts) * kpts

def scan_coarse_plain(counts, mu, X, la_grid, bnd_start, bnd_end, la_init, cr_reg, prior_reg, la_hat, pdv):
    """Plain version of the coarse scan: (best_la (G,), values (K, G))."""
    G = counts.shape[0]
    best_f = torch.full((G,), float("inf"), dtype=mu.dtype, device=mu.device)
    best_la = torch.full((G,), la_init, dtype=mu.dtype, device=mu.device)
    fs = []
    for k in range(la_grid.shape[0]):
        branch = "stable" if k < bnd_start else ("auto" if k < bnd_end else "plain")
        la = la_grid[k].expand(G)
        f = _alpha_objective(la, counts, X, mu, la_hat, pdv, cr_reg, prior_reg, branch)
        better = f < best_f
        best_f = torch.where(better, f, best_f)
        best_la = torch.where(better, la, best_la)
        fs.append(f)
    return best_la, torch.stack(fs)

def scan_coarse(counts, mu, X, la_grid, bnd_start, bnd_end, la_init, cr_reg, prior_reg, la_hat, pdv):
    """Coarse scan over the static grid ``la_grid``: the first strict
    minimum per gene (``la_init`` where no point is finite) and the
    objective at every point."""
    return scan_coarse_plain(counts, mu, X, la_grid, bnd_start, bnd_end, la_init, cr_reg, prior_reg, la_hat, pdv)

def fgh_closed(counts, mu, X, la, cr_reg, prior_reg, la_hat, pdv):
    """Objective, gradient and curvature in log-alpha of one point per gene."""
    f, g, h = nb_nll_centered_fgh(counts, mu, la)
    if cr_reg:
        # d logdet M = tr(M^-1 M'); d2 = tr(M^-1 M'') - tr((M^-1 M')^2), with
        # W = mu/(1 + mu a), dW/dla = -a W^2, d2W/dla2 = dW (1 - 2 a W).
        a = torch.exp(la)[:, None]
        W = mu / (1.0 + mu * a)
        Wd1 = -a * W * W
        Wd2 = Wd1 * (1.0 - 2.0 * a * W)
        M = weighted_gram(X, W)
        M1 = weighted_gram(X, Wd1)
        M2 = weighted_gram(X, Wd2)
        Minv = sym_inv(M)
        A = Minv @ M1
        f = f + 0.5 * sym_logdet(M)
        g = g + 0.5 * torch.diagonal(A, dim1=-2, dim2=-1).sum(-1)
        h = h + 0.5 * (
            (Minv * M2.transpose(-1, -2)).sum((-2, -1))
            - (A * A.transpose(-1, -2)).sum((-2, -1))
        )
    if prior_reg:
        d = la - la_hat
        f = f + d * d / (2.0 * pdv)
        g = g + d / pdv
        h = h + 1.0 / pdv
    return f, g, h

def newton_polish_plain(counts, mu, X, la, lo_f, hi_f, clip_f, step2_f, iters, cr_reg, prior_reg, la_hat, pdv):
    """Plain version of the safeguarded Newton polish: (la, f, g, h)."""
    lo, hi, clipw, step2 = (
        torch.tensor(v, dtype=mu.dtype, device=mu.device) for v in (lo_f, hi_f, clip_f, step2_f)
    )
    f, g, h = fgh_closed(counts, mu, X, la, cr_reg, prior_reg, la_hat, pdv)
    for _ in range(iters):
        raw = torch.where(h > 0, g / h, torch.sign(g) * step2)
        step = torch.clamp(raw, -clipw, clipw)
        cand = torch.clamp(la - step, lo, hi)
        fc, gc, hc = fgh_closed(counts, mu, X, cand, cr_reg, prior_reg, la_hat, pdv)
        # Gradient-contraction gate for small positive-curvature steps (near
        # the optimum f differences sit below the f32 noise floor), strict
        # descent otherwise — pydeseq2_tpu/ops/dispersion.py:384-387.
        contraction = (h > 0) & (torch.abs(raw) <= clipw) & (torch.abs(gc) <= torch.abs(g))
        better = contraction | (fc < f)
        la = torch.where(better, cand, la)
        f = torch.where(better, fc, f)
        g = torch.where(better, gc, g)
        h = torch.where(better, hc, h)
    return la, f, g, h

def newton_polish(counts, mu, X, la, lo_f, hi_f, clip_f, step2_f, iters, cr_reg, prior_reg, la_hat, pdv):
    """(f, g, h) at ``la`` and ``iters`` safeguarded Newton steps per gene,
    in [lo_f, hi_f] with steps clipped to ``clip_f`` (bounds and steps are
    Python floats, rounded to the working dtype as the JAX package rounds
    them)."""
    return newton_polish_plain(counts, mu, X, la, lo_f, hi_f, clip_f, step2_f, iters, cr_reg, prior_reg, la_hat, pdv)

def first_argmin(f: torch.Tensor) -> torch.Tensor:
    """Index of the first minimum along axis 0, a NaN counting as the
    minimum — ``jnp.argmin``'s rule (the first NaN wins where there is one)."""
    m = f.amin(0)  # NaN where the column holds one
    hit = (f == m[None]) | (torch.isnan(f) & torch.isnan(m)[None])
    K = f.shape[0]
    idx = torch.arange(K, device=f.device)[:, None].expand_as(f)
    return torch.where(hit, idx, torch.full_like(idx, K)).amin(0)

def alpha_mle_batch(
    counts: torch.Tensor,
    design_matrix: torch.Tensor,
    mu: torch.Tensor,
    alpha_hat: torch.Tensor,
    min_disp: float,
    max_disp: float,
    prior_disp_var: float | torch.Tensor | None = None,
    cr_reg: bool = True,
    prior_reg: bool = False,
    grid_length: int = 32,
    newton_iters: int = 4,
    return_coarse: bool = False,
    coarse_cache: torch.Tensor | None = None,
):
    """Per-gene dispersions by coarse grid + Newton polish.

    Returns ``(alpha, converged)``, plus the (grid_length, G) base objective
    (no prior) at the static grid points when ``return_coarse``. A later
    call on the same counts/mu/design can pass it as ``coarse_cache`` to
    skip its coarse scan (the MAP fit only adds a per-lane prior).
    See ``pydeseq2_tpu/ops/dispersion.py:78`` for the full contract.
    """
    dtype = mu.dtype
    dev = mu.device
    X = design_matrix
    lo_f = math.log(min_disp)
    hi_f = math.log(max_disp)
    lo = torch.tensor(lo_f, dtype=dtype, device=dev)
    hi = torch.tensor(hi_f, dtype=dtype, device=dev)
    la_hat = torch.log(torch.clamp(alpha_hat, min_disp, max_disp)).to(dtype)
    pdv = torch.as_tensor(1.0 if prior_disp_var is None else prior_disp_var, dtype=dtype, device=dev)

    step1_f = (hi_f - lo_f) / (grid_length - 1)
    # The fine spacing: without the fine scan the 8-point one, so the
    # plateau-lane flag |g| step2 keeps the same resolution.
    step2_f = step1_f / 3.5
    step1 = torch.tensor(step1_f, dtype=dtype, device=dev)
    la_grid = lo + torch.arange(grid_length, dtype=dtype, device=dev) * step1
    prior = (la_grid[:, None] - la_hat[None, :]) ** 2 / (2.0 * pdv) if prior_reg else None

    coarse_vals = None
    if coarse_cache is not None:
        f_all = coarse_cache + prior if prior_reg else coarse_cache
        la1 = la_grid[first_argmin(f_all)]
    else:
        bnd_start, bnd_end = _scan_branches(grid_length, step1_f, lo_f)
        la1, emitted = scan_coarse(
            counts, mu, X, la_grid, bnd_start, bnd_end, (lo_f + hi_f) / 2.0,
            cr_reg, prior_reg, la_hat, pdv,
        )
        if return_coarse:
            coarse_vals = emitted - prior if prior_reg else emitted

    la_fit, f_fit, g_fin, h_fin = newton_polish(
        counts, mu, X, la1, lo_f, hi_f, step1_f, step2_f, newton_iters, cr_reg, prior_reg, la_hat, pdv
    )
    step2 = torch.tensor(step2_f, dtype=dtype, device=dev)

    alpha = torch.exp(la_fit)
    # Projected-Newton stationarity flag (pydeseq2_tpu/ops/dispersion.py:410-422).
    zero = torch.zeros_like(g_fin)
    pg = torch.where((la_fit <= lo) & (g_fin > 0), zero, g_fin)
    pg = torch.where((la_fit >= hi) & (pg < 0), zero, pg)
    decrement = torch.where(h_fin > 0, pg * pg / (2.0 * torch.abs(h_fin)), torch.abs(pg) * step2)
    ftol = max(1e3 * torch.finfo(dtype).eps, 1e-9)
    converged = torch.isfinite(f_fit) & (decrement <= ftol * (torch.abs(f_fit) + 1.0))
    if return_coarse:
        return alpha, converged, coarse_vals
    return alpha, converged


# ------------------------------------------------------------ ops.irls
def _mu_from_xb(beta, X, size_factors, log_sf, min_mu, log_min_mu):
    """mu = max(sf e^{Xb}, min_mu) plus log(mu) and log(mu/sf) from the
    linear predictor (only min_mu-clamped entries need the constants)."""
    xb = beta @ X.T
    raw = size_factors[None, :] * torch.exp(xb)
    clamped = raw < min_mu
    mu = torch.where(clamped, min_mu, raw)
    log_mu = torch.where(clamped, log_min_mu, xb + log_sf)
    log_mu_sf = torch.where(clamped, log_min_mu - log_sf, xb)
    return mu, log_mu, log_mu_sf

def _mu_part(counts, y_plus_r, r, mu, log_mu):
    ylogmu = torch.where(counts > 0, counts * log_mu, torch.zeros_like(log_mu))
    return (y_plus_r * torch.log1p(mu / r) - ylogmu).sum(-1)

def _ridged_grad(b, counts, X, size_factors, disp, min_mu):
    mu = torch.clamp(size_factors[None, :] * torch.exp(b @ X.T), min=min_mu)
    inv_disp = (1.0 / disp)[:, None]
    t = (inv_disp + counts) * mu / (inv_disp + mu)
    return (t - counts) @ X + 1e-6 * b, mu

def _irls_plain(counts, size_factors, X, disp, beta_init, nll_const, log_sf, min_mu,
                log_min_mu, beta_tol, max_beta, maxiter, step_tol, polish_iters):
    G = counts.shape[0]
    P = X.shape[1]
    dtype = beta_init.dtype
    dev = counts.device
    ridge = 1e-6 * torch.eye(P, dtype=dtype, device=dev)
    r = 1.0 / disp[:, None]
    y_plus_r = counts + r

    beta = beta_init
    mu, _, log_mu_sf = _mu_from_xb(beta, X, size_factors, log_sf, min_mu, log_min_mu)
    dev_ = torch.full((G,), 1000.0, dtype=dtype, device=dev)
    active = torch.ones(G, dtype=torch.bool, device=dev)
    needs_fb = torch.zeros(G, dtype=torch.bool, device=dev)
    prev_small = torch.zeros(G, dtype=torch.bool, device=dev)
    it = 0
    # Host-evaluated while_loop condition (irls.py:175-177).
    while it < maxiter and bool(active.any()):
        W = mu / (1.0 + mu * disp[:, None])
        z = log_mu_sf + (counts - mu) / mu
        M = weighted_gram(X, W) + ridge
        rhs = (W * z) @ X
        beta_hat = sym_solve(M, rhs)

        it += 1
        diverged = (torch.abs(beta_hat) > max_beta).any(dim=1)
        new_fb = active & (diverged | (it >= maxiter))
        step_ok = active & ~new_fb

        new_beta = torch.where(step_ok[:, None], beta_hat, beta)
        new_mu, new_log_mu, new_log_mu_sf = _mu_from_xb(
            new_beta, X, size_factors, log_sf, min_mu, log_min_mu
        )
        new_dev = -2.0 * (nll_const + _mu_part(counts, y_plus_r, r, new_mu, new_log_mu))
        dev_ratio = torch.abs(new_dev - dev_) / (torch.abs(new_dev) + 0.1)
        still_active = step_ok & (dev_ratio > beta_tol)
        step_small = torch.zeros(G, dtype=torch.bool, device=dev)
        if step_tol > 0.0:
            step_small = torch.abs(beta_hat - beta).amax(dim=1) <= step_tol
            still_active = still_active & ~(step_small & prev_small)

        dev_ = torch.where(step_ok, new_dev, dev_)
        beta, mu, log_mu_sf = new_beta, new_mu, new_log_mu_sf
        active, needs_fb, prev_small = still_active, needs_fb | new_fb, step_small
    needs_fb = needs_fb | active
    n_iter = torch.tensor(it, dtype=torch.int32, device=dev)

    if step_tol > 0.0 and polish_iters > 0:
        polish_cap = 100.0 * step_tol
        b = beta
        for _ in range(polish_iters):
            g, mu = _ridged_grad(b, counts, X, size_factors, disp, min_mu)
            w = mu * (1.0 + disp[:, None] * counts) / (1.0 + disp[:, None] * mu) ** 2
            H = weighted_gram(X, w) + ridge
            cand = b - sym_solve(H, g)
            ok = (
                torch.isfinite(cand).all(dim=1)
                & (torch.abs(cand) <= max_beta).all(dim=1)
                & (torch.abs(cand - b).amax(dim=1) <= polish_cap)
            )
            b = torch.where(ok[:, None], cand, b)
        g_new = torch.abs(_ridged_grad(b, counts, X, size_factors, disp, min_mu)[0]).amax(dim=1)
        g_old = torch.abs(_ridged_grad(beta, counts, X, size_factors, disp, min_mu)[0]).amax(dim=1)
        beta = torch.where((g_new < g_old)[:, None], b, beta)
    return beta, needs_fb, n_iter

def irls_core(
    counts: torch.Tensor,
    size_factors: torch.Tensor,
    design_matrix: torch.Tensor,
    disp: torch.Tensor,
    beta_init: torch.Tensor,
    min_mu: float = 0.5,
    beta_tol: float = 1e-8,
    max_beta: float = 30.0,
    maxiter: int = 250,
    step_tol: float | None = None,
    polish_iters: int = 2,
    return_iters: bool = False,
):
    """Masked-lane batched IRLS: ``(beta, needs_fallback, converged)``, plus
    the trip count of the slowest lane (JAX's ``n_iter``) with
    ``return_iters``. ``step_tol=None`` is 1e-5 in f32 and off in f64. Contract:
    ``pydeseq2_tpu/ops/irls.py:45``.
    """
    X = design_matrix
    dtype = beta_init.dtype
    if step_tol is None:
        step_tol = 1e-5 if dtype == torch.float32 else 0.0
    # The lgamma part of the deviance is hoisted out of the loop: the
    # stop compares deviance differences, in which it cancels exactly.
    log_sf = torch.log(size_factors)[None, :]
    log_min_mu = torch.log(torch.tensor(min_mu, dtype=dtype, device=counts.device))
    mu0, log_mu0, _ = _mu_from_xb(beta_init, X, size_factors, log_sf, min_mu, log_min_mu)
    r = 1.0 / disp[:, None]
    nll_const = nb_nll(counts, mu0, disp) - _mu_part(counts, counts + r, r, mu0, log_mu0)
    beta, needs_fb, n_iter = _irls_plain(
        counts, size_factors, X, disp, beta_init, nll_const, log_sf, min_mu,
        log_min_mu, beta_tol, max_beta, maxiter, step_tol, polish_iters,
    )
    if return_iters:
        return beta, needs_fb, ~needs_fb, n_iter
    return beta, needs_fb, ~needs_fb

def irls_beta_init(
    counts: torch.Tensor, size_factors: torch.Tensor, design_matrix: torch.Tensor, full_rank: bool = True
) -> torch.Tensor:
    """Initial coefficients: QR least squares of log(y/sf + 0.1) on X for a
    full-rank design; otherwise zeros with a log-mean intercept (reference
    pydeseq2/utils.py:348-357, ``pydeseq2_tpu/ops/irls.py:248``).
    ``full_rank`` is a host-side property of the design."""
    if not full_rank:
        beta = torch.zeros((counts.shape[0], design_matrix.shape[1]), dtype=counts.dtype, device=counts.device)
        beta[:, 0] = torch.log(counts / size_factors[None, :]).mean(dim=1)
        return beta
    y = torch.log(counts / size_factors[None, :] + 0.1)
    Q, R = torch.linalg.qr(design_matrix)
    rhs = y @ Q
    return torch.linalg.solve_triangular(R, rhs.T, upper=True).T

def _newton_box_plain(counts, size_factors, X, disp, beta_init, min_mu, max_beta, maxiter):
    G = counts.shape[0]
    P = X.shape[1]
    dtype = beta_init.dtype
    dev = counts.device
    eye = torch.eye(P, dtype=dtype, device=dev)
    r = (1.0 / disp)[:, None]
    y_plus_r = counts + r
    log_sf = torch.log(size_factors)[None, :]
    log_min_mu = torch.log(torch.tensor(min_mu, dtype=dtype, device=dev))

    def objective(beta):
        mu, log_mu, _ = _mu_from_xb(beta, X, size_factors, log_sf, min_mu, log_min_mu)
        return _mu_part(counts, y_plus_r, r, mu, log_mu) + 0.5 * 1e-6 * (beta**2).sum(-1)

    beta = beta_init
    f_val = objective(beta)
    for _ in range(maxiter):
        g, mu = _ridged_grad(beta, counts, X, size_factors, disp, min_mu)
        w = mu * (1.0 + disp[:, None] * counts) / (1.0 + disp[:, None] * mu) ** 2
        H = weighted_gram(X, w) + 1e-6 * eye
        step = sym_solve(H + 1e-8 * eye, g)
        t = torch.ones(G, dtype=dtype, device=dev)
        best_beta, best_f = beta, f_val
        done = torch.zeros(G, dtype=torch.bool, device=dev)
        for _ in range(13):
            cand = torch.clamp(beta - t[:, None] * step, -max_beta, max_beta)
            f_cand = objective(cand)
            improve = (f_cand < best_f) & ~done
            best_beta = torch.where(improve[:, None], cand, best_beta)
            best_f = torch.where(improve, f_cand, best_f)
            done = done | improve
            t = t * 0.5
        beta, f_val = best_beta, best_f

    g, _ = _ridged_grad(beta, counts, X, size_factors, disp, min_mu)
    at_lo = (beta <= -max_beta + 1e-12) & (g > 0)
    at_hi = (beta >= max_beta - 1e-12) & (g < 0)
    pg = torch.where(at_lo | at_hi, torch.zeros_like(g), g)
    return beta, torch.abs(pg).amax(dim=1) < 1e-5

def newton_box_nbglm(
    counts: torch.Tensor,
    size_factors: torch.Tensor,
    design_matrix: torch.Tensor,
    disp: torch.Tensor,
    beta_init: torch.Tensor,
    min_mu: float = 0.5,
    max_beta: float = 30.0,
    maxiter: int = 60,
):
    """Projected Newton on the ridged NB NLL in the [-30, 30]^P box with
    13-halving backtracking: ``(beta, success)``, success = projected
    gradient sup-norm < 1e-5. Port of ``pydeseq2_tpu/ops/irls.py:272``.
    """
    return _newton_box_plain(counts, size_factors, design_matrix, disp, beta_init, min_mu, max_beta, maxiter)

def _linspace(start, stop, num: int, dtype, device) -> torch.Tensor:
    """``jnp.linspace`` with its rounding: start*(1-s) + stop*s, s = i/(num-1)."""
    div = num - 1
    s = torch.arange(div, dtype=dtype, device=device) / div
    start = torch.as_tensor(start, dtype=dtype, device=device)
    stop = torch.as_tensor(stop, dtype=dtype, device=device)
    return torch.cat([start * (1 - s) + stop * s, stop.reshape(1)])

def grid_axes(min_beta: float, max_beta: float, num: int, dtype, device):
    """The coarse grid and the fine grid's offsets of the 2-D searches, as
    ``jnp.linspace`` rounds them: ``(base, offs)``, offs spanning one
    coarse step either side."""
    base = _linspace(min_beta, max_beta, num, dtype, device)
    delta = base[1] - base[0]
    return base, _linspace(-delta, delta, num, dtype, device)

def _grid_fit_beta_plain(counts, size_factors, X, disp, min_mu, grid_length, min_beta, max_beta):
    dtype = counts.dtype
    dev = counts.device
    G = counts.shape[0]

    def search(x_grid, y_grid):
        rows = []
        for xv in x_grid:  # one x value per pass bounds memory at (G, K, N)
            betas = torch.stack([xv.expand(y_grid.shape), y_grid], dim=1)
            mu = torch.clamp(size_factors[None, None, :] * torch.exp(betas @ X.T)[None], min=min_mu)
            nll = nb_nll(counts[:, None, :], mu, disp[:, None])
            rows.append(nll + 0.5 * (1e-6 * betas**2).sum(1)[None, :])
        ll = torch.stack(rows, dim=1)  # (G, Kx, Ky)
        flat = first_argmin(ll.reshape(G, -1).T)
        return x_grid[flat // y_grid.shape[0]], y_grid[flat % y_grid.shape[0]]

    base, offs = grid_axes(min_beta, max_beta, grid_length, dtype, dev)
    bx, by = search(base, base)

    best_f = torch.full((G,), float("inf"), dtype=dtype, device=dev)
    best_x, best_y = bx, by
    for i in range(grid_length):
        x_val = bx + offs[i]
        y_vals = by[:, None] + offs[None, :]
        xb = x_val[:, None, None] * X[None, None, :, 0] + y_vals[..., None] * X[None, None, :, 1]
        mu = torch.clamp(size_factors[None, None, :] * torch.exp(xb), min=min_mu)
        nll = nb_nll(counts[:, None, :], mu, disp[:, None])
        f = nll + 0.5e-6 * (x_val[:, None] ** 2 + y_vals**2)
        j = first_argmin(f.T)
        f_best = f.gather(1, j[:, None])[:, 0]
        better = f_best < best_f
        best_f = torch.where(better, f_best, best_f)
        best_x = torch.where(better, x_val, best_x)
        best_y = torch.where(better, y_vals.gather(1, j[:, None])[:, 0], best_y)
    return torch.stack([best_x, best_y], dim=1)

def grid_fit_beta_batch(
    counts: torch.Tensor,
    size_factors: torch.Tensor,
    design_matrix: torch.Tensor,
    disp: torch.Tensor,
    min_mu: float = 0.5,
    grid_length: int = 60,
    min_beta: float = -30.0,
    max_beta: float = 30.0,
) -> torch.Tensor:
    """Coarse then fine 2-D grid search for P == 2 designs. Port of
    ``pydeseq2_tpu/ops/irls.py:375``.
    """
    return _grid_fit_beta_plain(counts, size_factors, design_matrix, disp, min_mu, grid_length, min_beta, max_beta)

def _hat_plain(size_factors, X, disp, beta, min_mu):
    P = X.shape[1]
    xb = beta @ X.T
    mu_thr = torch.clamp(size_factors[None, :] * torch.exp(xb), min=min_mu)
    W = mu_thr / (1.0 + mu_thr * disp[:, None])
    M = weighted_gram(X, W) + 1e-6 * torch.eye(P, dtype=beta.dtype, device=beta.device)
    Minv = sym_inv(M)
    xmx = torch.einsum("np,gpq,nq->gn", X, Minv, X)
    return W * xmx, size_factors[None, :] * torch.exp(xb)


# ------------------------------------------------------------ ops.trend
_LOWER = 1e-12

def _design(covariates: torch.Tensor) -> torch.Tensor:
    return torch.stack([torch.ones_like(covariates), covariates], dim=1)

def _sum(v: torch.Tensor) -> torch.Tensor:
    """Sum over genes, accumulated in float64, rounded to ``v``'s dtype."""
    return v.sum(0, dtype=torch.float64).to(v.dtype)

def _mu(c, x):
    """a0 + a1 x for the design ``x = [1, x]`` (the kernel's expression)."""
    return c[0] + x[:, 1] * c[1]

def trend_loss(c, x, targets, valid, n):
    """mean over valid genes of y/mu + log mu, mu = max(x @ c, 1e-12)."""
    mu_safe = torch.clamp(_mu(c, x), min=_LOWER)
    per = targets / mu_safe + torch.log(mu_safe)
    return _sum(torch.where(valid, per, torch.zeros_like(per))) / n

def trend_grad(c, x, targets, valid, n):
    """Closed-form gradient of :func:`trend_loss`.

    The JAX package takes ``jax.grad`` of the loss, which differentiates
    ``maximum(mu, 1e-12)`` as 1 above the bound, 1/2 at a tie and 0 below;
    this reproduces that factor, so a lane clamped at the bound contributes
    no gradient.
    """
    mu = _mu(c, x)
    mu_safe = torch.clamp(mu, min=_LOWER)
    dper = -targets / (mu_safe * mu_safe) + 1.0 / mu_safe
    one = torch.ones_like(mu)
    dmax = torch.where(mu > _LOWER, one, torch.where(mu == _LOWER, 0.5 * one, 0.0 * one))
    gmu = torch.where(valid, dper * dmax, torch.zeros_like(dper)) / n
    return torch.stack([_sum(gmu), _sum(x[:, 1] * gmu)])

def _fisher(c, x, w, n):
    # Expected information of the gamma GLM with identity link (always PSD),
    # plus the 1e-12 ridge: (F00, F01, F11).
    mu = torch.clamp(_mu(c, x), min=_LOWER)
    wm = w / mu**2
    xw = x[:, 1] * wm
    return _sum(wm) / n + _LOWER, _sum(wm * x[:, 1]) / n, _sum(xw * x[:, 1]) / n + _LOWER

def _solve2(F, r):
    """Solve [[F00, F01], [F01, F11]] s = r by LU with partial pivoting, as
    LAPACK's getrf/getrs do for 2 x 2 (multiplier by the pivot's
    reciprocal)."""
    a, b, d = F
    swap = torch.abs(b) > torch.abs(a)
    p, q = torch.where(swap, b, a), torch.where(swap, d, b)  # pivot row
    o, e = torch.where(swap, a, b), torch.where(swap, b, d)  # other row
    r0, r1 = torch.where(swap, r[1], r[0]), torch.where(swap, r[0], r[1])
    m = o * (1.0 / p)
    s1 = (r1 - m * r0) / (e - m * q)
    return torch.stack([(r0 - s1 * q) / p, s1])

def _trend_fit_plain(covariates, targets, valid, maxiter):
    dtype = targets.dtype
    dev = targets.device
    x = _design(covariates)
    w = valid.to(dtype)
    n = torch.clamp(w.sum(), min=1.0)
    eps = torch.finfo(dtype).eps

    def loss(c):
        return trend_loss(c, x, targets, valid, n)

    def grad(c):
        return trend_grad(c, x, targets, valid, n)

    c = torch.ones(2, dtype=dtype, device=dev)
    f_val = loss(c)
    for _ in range(maxiter):
        step = _solve2(_fisher(c, x, w, n), grad(c))
        t = 1.0
        best_c, best_f = c, f_val
        improved = False
        # Host-evaluated backtracking while_loop (trend.py:71-104).
        for _ in range(20):
            cand = torch.clamp(c - t * step, min=_LOWER)
            f_cand = loss(cand)
            if bool(f_cand < best_f):
                best_c, best_f = cand, f_cand
                improved = True
                break
            t = t * 0.5
        tiny = 10.0 * eps * (torch.abs(f_val) + 1.0)
        stalled = (not improved) or bool(f_val - best_f <= tiny)
        c, f_val = best_c, best_f
        # Host-evaluated outer while_loop condition (trend.py:75-77).
        if stalled:
            break

    predictions = _mu(c, x)
    g_final = grad(c)
    at_bound = (c <= _LOWER * (1 + 1e-9)) & (g_final > 0)
    pg = torch.where(at_bound, torch.zeros_like(g_final), g_final)
    sol = _solve2(_fisher(c, x, w, n), pg)
    decrement = (0.5 * pg[0]) * sol[0] + (0.5 * pg[1]) * sol[1]
    converged = torch.isfinite(f_val) & (decrement <= 1e3 * eps * (torch.abs(f_val) + 1.0))
    return c, predictions, converged

def _trend_inputs(base_mean, genewise_m, non_zero):
    """Covariates 1/base_mean and targets, zeroed outside the initial mask
    of finite non-zero genes (fused.py:251-258), and that mask."""
    covariates = 1.0 / base_mean
    valid = non_zero & torch.isfinite(covariates) & torch.isfinite(genewise_m)
    zero = torch.zeros_like(covariates)
    return torch.where(valid, covariates, zero), torch.where(valid, torch.nan_to_num(genewise_m), zero), valid

def _parametric_trend_plain(base_mean, genewise_m, non_zero, mean_disp, max_rounds):
    covariates, targets, valid = _trend_inputs(base_mean, genewise_m, non_zero)
    coeffs = torch.ones(2, dtype=base_mean.dtype, device=base_mean.device)
    failed = torch.tensor(False, device=base_mean.device)
    rounds = 0
    for _ in range(max_rounds):
        new_coeffs, preds, glm_ok = _trend_fit_plain(covariates, targets, valid, 60)
        failed = ~glm_ok | (new_coeffs <= 1e-10).any()
        drift = torch.sum(torch.log(torch.abs(new_coeffs / coeffs)) ** 2)
        ratio = genewise_m / preds
        valid = valid & (ratio >= 1e-4) & (ratio < 15.0)
        coeffs = new_coeffs
        rounds += 1
        # Host-evaluated while_loop condition (fused.py:264-266).
        if bool(failed) or not bool(drift >= 1e-6):
            break
    fitted = torch.where(failed, mean_disp, coeffs[0] + coeffs[1] / base_mean)
    return fitted, coeffs, failed, torch.tensor(rounds, dtype=torch.int32, device=base_mean.device)

def parametric_trend(
    base_mean: torch.Tensor,
    genewise_m: torch.Tensor,
    non_zero: torch.Tensor,
    mean_disp: torch.Tensor,
    max_rounds: int = 20,
):
    """The parametric dispersion trend with gene exclusion:
    ``(fitted (G,), coeffs (2,), failed, rounds)``.

    Rounds of :func:`gamma_glm_trend_fit` of alpha = a0 + a1 / base_mean on
    the finite ``non_zero`` genes, each dropping the genes whose genewise
    dispersion over the fit's prediction leaves [1e-4, 15), until a fit
    fails (not converged, or a coefficient <= 1e-10), the coefficients move
    less than 1e-6 in squared log distance, or ``max_rounds`` is reached
    (``pydeseq2_tpu/fused.py:250-292``). ``fitted`` is ``mean_disp`` (a 0-d
    tensor) where the trend failed, else a0 + a1 / base_mean, for every
    gene. ``rounds`` is a 0-d int32 tensor.
    """
    return _parametric_trend_plain(base_mean, genewise_m, non_zero, mean_disp, max_rounds)


# ------------------------------------------------------------ ops.wald
# alt_hypothesis -> the kernel's branch code
ALT_CODES = {None: 0, "greaterAbs": 1, "lessAbs": 2, "greater": 3, "less": 4}

def norm_sf(x: torch.Tensor) -> torch.Tensor:
    """Standard normal survival function via erfc."""
    return 0.5 * torch.special.erfc(x / torch.sqrt(torch.tensor(2.0, dtype=x.dtype, device=x.device)))

def _wald_plain(X, disp, lfc, mu, ridge_factor, contrast, lfc_null, alt_hypothesis):
    W = mu / (1.0 + mu * disp[:, None])
    M = weighted_gram(X, W)
    Hinv = sym_inv(M + ridge_factor[None])
    Hc = Hinv @ contrast
    se = torch.sqrt(torch.einsum("gp,gpq,gq->g", Hc, M, Hc))
    lfc_null = torch.as_tensor(lfc_null, dtype=lfc.dtype, device=lfc.device)
    zero = torch.zeros((), dtype=lfc.dtype, device=lfc.device)

    # fmax/fmin/sign apply PER COEFFICIENT before the contrast product
    # (reference pydeseq2/utils.py:778-796).
    def greater(null):
        stat = torch.fmax((lfc - null) / se[:, None], zero) @ contrast
        return stat, norm_sf(stat)

    def less(null):
        stat = torch.fmin((lfc - null) / se[:, None], zero) @ contrast
        return stat, norm_sf(torch.abs(stat))

    if alt_hypothesis == "greater":
        stat, pval = greater(lfc_null)
    elif alt_hypothesis == "less":
        stat, pval = less(lfc_null)
    elif alt_hypothesis == "greaterAbs":
        stat = (torch.sign(lfc) * torch.fmax((torch.abs(lfc) - lfc_null) / se[:, None], zero)) @ contrast
        pval = 2.0 * norm_sf(torch.abs(stat))
    elif alt_hypothesis == "lessAbs":
        stat_above, pval_above = greater(-torch.abs(lfc_null))
        stat_below, pval_below = less(torch.abs(lfc_null))
        stat = torch.where(torch.abs(stat_above) < torch.abs(stat_below), stat_above, stat_below)
        pval = torch.maximum(pval_above, pval_below)
    elif alt_hypothesis is None:
        stat = (lfc @ contrast - lfc_null * contrast.sum()) / se
        pval = 2.0 * norm_sf(torch.abs(stat))
    else:
        raise ValueError(f"unknown alt_hypothesis {alt_hypothesis!r}")
    return pval, stat, se

def _hat_wald_plain(beta, disp, size_factors, X, contrast, lfc_null, min_mu, alt_hypothesis, want_hat=True):
    H, mu = _hat_plain(size_factors, X, disp, beta, min_mu) if want_hat else (None, None)
    mu_w = mu if want_hat else size_factors[None, :] * torch.exp(beta @ X.T)  # _hat_plain's mu
    ridge = 1e-6 * torch.eye(X.shape[1], dtype=beta.dtype, device=beta.device)
    pval, stat, se = _wald_plain(X, disp, beta, mu_w, ridge, contrast, lfc_null, alt_hypothesis)
    return H, mu, pval, stat, se

def hat_wald(
    beta: torch.Tensor,
    disp: torch.Tensor,
    size_factors: torch.Tensor,
    design_matrix: torch.Tensor,
    contrast: torch.Tensor,
    lfc_null: torch.Tensor | float,
    min_mu: float = 0.5,
    alt_hypothesis: str | None = None,
    want_hat: bool = True,
):
    """Hat diagonals and the Wald test from the fitted coefficients:
    ``(H (G, N), mu (G, N), p_values, statistics, se)``.

    H = W_thr x_n^T (X^T W_thr X + 1e-6 I)^-1 x_n on the min_mu-thresholded
    mu; mu is the UNthresholded sf e^{X beta}, which the Wald covariance
    uses. With ``want_hat`` False, H and mu are None and nothing of size
    (G, N) is written; the test's outputs are the same.
    """
    if alt_hypothesis not in ALT_CODES:
        raise ValueError(f"unknown alt_hypothesis {alt_hypothesis!r}")
    return _hat_wald_plain(beta, disp, size_factors, design_matrix, contrast, lfc_null, min_mu, alt_hypothesis, want_hat)


# ------------------------------------------------------------ ops.cooks
def first_argmax(x: torch.Tensor) -> torch.Tensor:
    """Index of the first maximum along axis 1, a NaN counting as the
    maximum (``jnp.argmax``'s rule)."""
    m = x.amax(1)  # NaN where the row holds one
    hit = (x == m[:, None]) | (torch.isnan(x) & torch.isnan(m)[:, None])
    N = x.shape[1]
    idx = torch.arange(N, device=x.device)[None, :].expand_as(x)
    return torch.where(hit, idx, torch.full_like(idx, N)).amin(1)

def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(G, N) bools -> (G, ceil(N/32)) int32 words, bit k of word w holding
    sample 32 w + k: the JAX package's uint32 words (fused_stream.py:427-433)
    as the same bit pattern in int32, which has the operators PyTorch lacks
    for uint32."""
    G, N = bits.shape
    W = -(-N // 32)
    padded = torch.zeros((G, W * 32), dtype=torch.int64, device=bits.device)
    padded[:, :N] = bits.to(torch.int64)
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    words = (padded.reshape(G, W, 32) << shifts).sum(-1)
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)

def unpack_bits(words: torch.Tensor, N: int) -> torch.Tensor:
    """Inverse of :func:`pack_bits`: (G, W) int32 words -> (G, N) bools.
    The arithmetic shift of a word with bit 31 set fills with ones, so the
    bit is taken with ``& 1``."""
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    bits = (words[:, :, None] >> shifts) & 1
    return bits.reshape(words.shape[0], -1)[:, :N].bool()

def _cooks_plain(counts, size_factors, mu, H, non_zero, P, cohort_ids, use_for_max, cutoff,
                 replaceable=None, want_distances=True):
    normed = counts / size_factors[None, :]
    if cohort_ids is not None:
        idx = torch.tensor([i for i, u in enumerate(use_for_max) if u], device=counts.device)
        v = _trimmed_cell_variance_plain(normed[:, idx].T, cohort_ids)
    else:
        v = _trimmed_variance_plain(normed.T, 0.125, 0)
    m = normed.mean(dim=1)
    disp_c = torch.clamp((v - m) / m**2, min=0.04)
    V = mu + disp_c[:, None] * mu**2
    squared_pearson = (counts - mu) ** 2 / (V * P)
    cooks = squared_pearson * H / (1.0 - H) ** 2

    ufm = torch.as_tensor(use_for_max, dtype=torch.bool, device=counts.device)
    neg_inf = torch.full_like(cooks, float("-inf"))
    flagged = (torch.where(ufm[None, :], cooks, neg_inf) > cutoff).any(dim=1)
    # Un-flag genes where >= 3 samples exceed the max-cooks sample's count
    # (reference pydeseq2/dds.py:1097-1101): argmax and count over ALL samples.
    max_count = counts.gather(1, first_argmax(cooks)[:, None])
    veto = (counts > max_count).sum(dim=1) < 3
    outlier = flagged & veto & non_zero
    out = (
        torch.where(non_zero[:, None], cooks, torch.full_like(cooks, float("nan"))) if want_distances else None,
        outlier,
        disp_c,
    )
    if replaceable is None:
        return out
    # Refit mode (fused_stream.py:422-445): the exceed bits of every cell,
    # and the flag a refitted gene keeps, from its use_for_max samples that
    # are not replaceable, with the veto on the original distances.
    exceeds = cooks > cutoff
    repl = torch.as_tensor(replaceable, dtype=torch.bool, device=counts.device)
    flagged_nr = (torch.where((ufm & ~repl)[None, :], cooks, neg_inf) > cutoff).any(dim=1)
    return out + (pack_bits(exceeds), exceeds.any(dim=1) & non_zero, flagged_nr & veto & non_zero)

def cooks_outliers(
    counts: torch.Tensor,
    size_factors: torch.Tensor,
    mu: torch.Tensor,
    H: torch.Tensor,
    non_zero: torch.Tensor,
    P: int,
    cohort_ids: tuple[int, ...] | None,
    use_for_max: tuple[bool, ...],
    cutoff: torch.Tensor,
    replaceable: tuple[bool, ...] | None = None,
    want_distances: bool = True,
):
    """Cook's distances and outliers: ``(cooks (G, N), cooks_outlier (G,),
    robust dispersion (G,))``, and in refit mode three more outputs.

    counts, mu (unthresholded) and H are (G, N); ``cohort_ids`` (the cohort
    of each ``use_for_max`` sample, or None for one trimmed variance over
    all samples) and ``use_for_max`` (N,) come from ``summary_host_inputs``;
    a gene is flagged when a ``use_for_max`` sample's distance exceeds
    ``cutoff`` (a 0-d tensor, the F(0.99, P, N - P) quantile). ``cooks`` is
    NaN on genes that are not ``non_zero``.

    With ``want_distances=False`` the first output is None and no (G, N)
    array is written. ``replaceable`` (N,), the samples in cohorts of at
    least ``min_replicates``, switches on the refit mode of
    ``pydeseq2_tpu/fused_stream.py:422-445``, which appends
    ``exceeds_packed`` (G, ceil(N/32)) int32 (bit k of word w: sample
    32 w + k has a distance above the cutoff, NaN distances never),
    ``replaced`` (G,) (any bit set, on non_zero genes) and
    ``cooks_outlier_refit`` (G,) (the flag a refitted gene keeps: a
    ``use_for_max`` sample that is not replaceable exceeds the cutoff, with
    the count veto of the original distances).
    """
    return _cooks_plain(counts, size_factors, mu, H, non_zero, P, cohort_ids, use_for_max, cutoff, replaceable,
              want_distances)


# ------------------------------------------------------------ ops.refit
TRIM = 0.2

def _impute_plain(counts, exceeds_packed, replaceable, size_factors, tile_mask):
    N = counts.shape[1]
    repl = torch.as_tensor(replaceable, dtype=torch.bool, device=counts.device)
    swap = repl[None, :] & unpack_bits(exceeds_packed, N)
    trim02 = _trimmed_mean_plain(counts / size_factors[None, :], TRIM, 1)
    # .astype(int) truncation of the reference; counts are >= 0, so floor.
    imputed = torch.where(swap, torch.floor(trim02[:, None] * size_factors[None, :]), counts)
    return imputed, (imputed == 0).all(dim=1) & tile_mask

def impute_outliers(
    counts: torch.Tensor,
    exceeds_packed: torch.Tensor,
    replaceable: tuple[bool, ...],
    size_factors: torch.Tensor,
    tile_mask: torch.Tensor,
):
    """Imputed refit tile: ``(imputed (K, N), new_all_zero (K,))``.

    counts (K, N) raw counts of the genes to refit; ``exceeds_packed``
    (K, ceil(N/32)) int32, their Cook's exceed bits from
    :func:`~pydeseq2_tpu_torch.ops.cooks.cooks_outliers`; ``replaceable``
    (N,) the samples in cohorts of at least ``min_replicates``; tile_mask
    (K,) bool, False on padding rows. A cell whose bit is set in a
    replaceable sample becomes floor(trimmed_mean_0.2(counts / sf) * sf_n);
    ``new_all_zero`` marks masked-in rows left all zero.
    """
    return _impute_plain(counts, exceeds_packed, replaceable, size_factors, tile_mask)


# ------------------------------------------------------------ the pipeline
def _irls_with_rescue(counts, size_factors, design_matrix, disp, beta_init, min_mu, beta_tol, phase1_iters=8):
    """Two-phase IRLS with the rescue cascade: ``(beta, converged, overflow)``.

    Phase 1 runs ``phase1_iters`` trips over every lane; the unfinished
    lanes continue from their iterate on a compacted tile of K = max(512,
    G/64) lanes, flagged first by a stable argsort, or at full width when
    more than K are unfinished. Lanes still flagged then take the projected
    Newton rescue and, for P == 2, the 2-D grid, the first K flagged lanes
    only. ``overflow`` counts flagged lanes beyond the K tile. Each tier
    runs here on the lanes it rescues, which gives each of them the answer
    it gets on the whole tile."""
    X = design_matrix
    beta, needs_fb, converged = irls_core(
        counts, size_factors, X, disp, beta_init, min_mu=min_mu, beta_tol=beta_tol, maxiter=phase1_iters,
    )
    G = counts.shape[0]
    dev = counts.device
    K = min(G, max(512, G // 64))
    idx1 = torch.argsort((~needs_fb).to(torch.int8), stable=True)[:K]
    n_unfinished = int(needs_fb.sum()) if phase1_iters < 250 else 0
    if n_unfinished > K:
        b2, nfb2, conv2 = irls_core(
            counts, size_factors, X, disp, beta, min_mu=min_mu, beta_tol=beta_tol, maxiter=250 - phase1_iters,
        )
        beta = torch.where(needs_fb[:, None], b2, beta)
        converged = torch.where(needs_fb, conv2, converged)
        needs_fb = torch.where(needs_fb, nfb2, needs_fb)
    elif n_unfinished > 0:
        sel1 = needs_fb[idx1]
        b2, nfb2, conv2 = irls_core(
            counts[idx1], size_factors, X, disp[idx1], beta[idx1],
            min_mu=min_mu, beta_tol=beta_tol, maxiter=250 - phase1_iters,
        )
        beta, needs_fb, converged = beta.clone(), needs_fb.clone(), converged.clone()
        beta[idx1] = torch.where(sel1[:, None], b2, beta[idx1])
        converged[idx1] = torch.where(sel1, conv2, converged[idx1])
        needs_fb[idx1] = torch.where(sel1, nfb2, needs_fb[idx1])

    overflow = torch.clamp(needs_fb.sum() - K, min=0)
    idx = torch.argsort((~needs_fb).to(torch.int8), stable=True)[:K]
    lanes = idx[needs_fb[idx]]
    if len(lanes):
        b_fb, ok = newton_box_nbglm(counts[lanes], size_factors, X, disp[lanes], beta_init[lanes], min_mu=min_mu)
        beta, converged = beta.clone(), converged.clone()
        beta[lanes] = b_fb
        converged[lanes] = ok
    if X.shape[1] == 2:
        still_bad = needs_fb & ~converged
        lanes = idx[still_bad[idx]]
        if len(lanes):
            beta = beta.clone()
            beta[lanes] = grid_fit_beta_batch(counts[lanes], size_factors, X, disp[lanes], min_mu=min_mu)
    return beta, converged, overflow


def fit_fused_trend(base_mean, genewise_m, non_zero, min_disp, trend_type, max_rounds=20):
    """Dispersion trend with the mean fallback: ``(fitted, coeffs,
    used_mean, mean_disp)``; ``fitted`` is not non_zero-masked."""
    dtype = base_mean.dtype
    dev = base_mean.device
    sel = genewise_m > 10.0 * min_disp
    mean_disp = trimmed_mean_masked(genewise_m, sel, 0.001)
    if trend_type == "mean":
        G = base_mean.shape[0]
        return (mean_disp.expand(G).clone(), torch.zeros(2, dtype=dtype, device=dev),
                torch.tensor(True, device=dev), mean_disp)
    fitted, coeffs, failed, _ = parametric_trend(base_mean, genewise_m, non_zero, mean_disp, max_rounds)
    return fitted, coeffs, failed, mean_disp


def dispersion_prior(genewise_m, fitted_m, non_zero, min_disp, N, P):
    """``(squared_logres, prior_disp_var)``: the squared MAD of the log
    residuals off the trend over genes with genewise >= 100 min_disp, and
    the prior variance max(squared_logres - trigamma((N - P) / 2), 0.25)."""
    disp_resid = torch.log(genewise_m) - torch.log(fitted_m)
    above = genewise_m >= 100.0 * min_disp
    resid_sel = torch.where(above & non_zero, disp_resid, torch.full_like(disp_resid, float("nan")))
    center = nanmedian(resid_sel)
    mad = nanmedian(torch.abs(resid_sel - center)) / 0.6744897501960817
    squared_logres = mad**2
    half_df = torch.tensor((N - P) / 2.0, dtype=genewise_m.dtype, device=genewise_m.device)
    trigamma = _psi_series_f64(half_df)[1] if half_df.dtype == torch.float64 else torch.polygamma(1, half_df)
    return squared_logres, torch.clamp(squared_logres - trigamma, min=0.25)


def device_padj(p, base_mean, gene_mask, alpha, independent_filter):
    """Adjusted p-values (G,), float64: BH over the valid genes, or
    independent filtering (50 base-mean cutoffs, a lowess through their
    rejection counts, the picked row adjusted)."""
    dtype = base_mean.dtype
    dev = base_mean.device
    nan = torch.tensor(float("nan"), dtype=dtype, device=dev)
    valid = ~torch.isnan(p) & gene_mask
    p_filled = torch.nan_to_num(p, nan=1.0).to(torch.float64)
    order = torch.argsort(p_filled, stable=True)
    if not independent_filter:
        return bh_adjust_row(p_filled, order, valid)
    base_m = torch.where(gene_mask, base_mean, nan)
    n_zero = ((base_m == 0) & gene_mask).sum().to(torch.float64)
    lower_q = (n_zero / torch.clamp(gene_mask.sum(), min=1).to(torch.float64)).to(dtype)
    upper_q = torch.where(
        lower_q < 0.95, torch.tensor(0.95, dtype=dtype, device=dev), torch.tensor(1.0, dtype=dtype, device=dev)
    )
    theta = lower_q + (upper_q - lower_q) * _linspace(0.0, 1.0, 50, dtype, dev)
    cutoffs = nanquantile(base_m, theta)
    num_rej = bh_rejections(p_filled, order, valid, base_mean, cutoffs, alpha)
    _, j = lowess_pick(theta, num_rej, frac=1.0 / 5.0)
    return bh_adjust_row(p_filled, order, valid, base_mean, cutoffs, j)


def n_or_more_replicates(design_matrix, min_replicates: int):
    """Samples whose design-row combination occurs >= min_replicates times."""
    cohorts = design_matrix.apply(tuple, axis=1)
    return cohorts.map(cohorts.value_counts()) >= min_replicates


def summary_host_inputs(design_matrix, min_replicates: int = 7) -> dict:
    """The design-only inputs: the F(0.99, P, N - P) Cook's cutoff, the
    ``use_for_max`` mask of samples in >= 3-replicate cohorts, those
    samples' cohort ids in first-seen order, the ``replaceable`` mask of
    >= ``min_replicates``-replicate samples and the ``mu_init`` mode."""
    import pandas as pd
    from scipy.stats import f

    df = design_matrix if isinstance(design_matrix, pd.DataFrame) else pd.DataFrame(np.asarray(design_matrix))
    n, p = df.shape
    three_or_more = n_or_more_replicates(df, 3).to_numpy()
    if three_or_more.any():
        filtered = df.loc[three_or_more, :]
        cohort_ids = tuple(int(x) for x in filtered.groupby(filtered.columns.tolist()).ngroup())
    else:
        cohort_ids = None
    return {
        "cooks_cutoff": float(f.ppf(0.99, p, n - p)),
        "use_for_max": tuple(bool(b) for b in three_or_more),
        "cohort_ids": cohort_ids,
        "replaceable": tuple(bool(b) for b in n_or_more_replicates(df, min_replicates).to_numpy()),
        "mu_init": "linear" if len(df.value_counts()) == p else "irls",
    }


# The ~4 GB device budget of the block sizing: ~20 live (block, N)
# temporaries of <= 8 bytes (80 bytes a cell).
_BLOCK_BUDGET_BYTES = 4_000_000_000


def _auto_gene_block(G: int, N: int) -> int:
    """G split evenly into blocks whose ~20 live (block, N) temporaries of
    <= 8 bytes fit the ~4 GB budget, rounded up to 8."""
    raw = int(max(1024, min(G, _BLOCK_BUDGET_BYTES // (80 * N))))
    n_blocks = -(-G // raw)
    return ((-(-G // n_blocks) + 7) // 8) * 8


def _to_host(tensors: dict) -> dict:
    """Numpy copies of a dict of tensors, each in its own dtype."""
    return {k: v.cpu().numpy() for k, v in tensors.items()}


def _block_starts(N: int, sample_block: int) -> list[int]:
    """Column-block starts; the last block's start is clamped to N - block."""
    return [min(b * sample_block, N - sample_block) for b in range(-(-N // sample_block))]


def _streamed_size_factors(counts, gene_mask, logmeans, sample_block=None):
    """Median-of-ratios size factors over the genes with finite log-means,
    a column block at a time (each column's median depends on it alone)."""
    filtered = ~torch.isinf(logmeans) & gene_mask
    m = filtered.sum()

    def med_of_cols(cols):
        ratios = torch.where(filtered[:, None], torch.log(cols) - logmeans[:, None],
                             torch.full_like(cols, float("inf")))
        return masked_median_select(ratios, m, axis=0)

    N = counts.shape[1]
    if sample_block is None or sample_block >= N:
        return torch.exp(med_of_cols(counts))
    med = torch.zeros(N, dtype=counts.dtype, device=counts.device)
    for s in _block_starts(N, sample_block):
        med[s:s + sample_block] = med_of_cols(counts[:, s:s + sample_block])
    return torch.exp(med)


def _log_stats(counts, gene_mask, gene_block):
    """Per-gene log-means (-inf where a gene has a zero) and the non-zero mask."""
    logmeans, non_zero = [], []
    for b in range(0, counts.shape[0], gene_block):
        c = counts[b:b + gene_block]
        logmeans.append(torch.log(c).mean(dim=1))
        non_zero.append((c > 0).any(dim=1) & gene_mask[b:b + gene_block])
    return torch.cat(logmeans), torch.cat(non_zero)


def _mu_init(c, sf, X, pinv, min_mu, min_disp, max_disp, beta_tol, mu_init):
    """MoM dispersions, the mu-init coefficients and mu of one tile: ``(mom,
    beta_coef, mu_hat, overflow)``, by OLS ("linear") or IRLS with rescue."""
    linear = mu_init != "irls"
    rough, moments, coef, mu_hat = mom_and_mu_coef(c, sf, X, pinv, min_mu, want_mu=linear)
    mom = torch.clamp(torch.minimum(rough, moments), min_disp, max_disp)
    if linear:
        return mom, coef, mu_hat, torch.zeros((), dtype=torch.int64, device=c.device)
    coef, _, overflow = _irls_with_rescue(c, sf, X, mom, irls_beta_init(c, sf, X), min_mu=min_mu, beta_tol=beta_tol)
    return mom, coef, _mu_hat(coef, sf, X, min_mu, mu_init), overflow


def _mu_hat(coef, sf, X, min_mu, mu_init):
    """mu from the init coefficients: unthresholded sf e^{X b} after the
    IRLS init, else the clamped OLS fit."""
    if mu_init == "irls":
        return sf[None, :] * torch.exp(coef @ X.T)
    return mu_from_coef(coef, sf, X, min_mu)


def _genewise_pass(counts, sf, X, pinv, gene_block, min_mu, min_disp, max_disp, beta_tol, mu_init):
    """Pass 1: per block, base means, the mu init and the genewise
    dispersion MLE with its coarse-grid objective cache."""
    base_mean, genewise, coarse, coefs, overflow = [], [], [], [], []
    for b in range(0, counts.shape[0], gene_block):
        c = counts[b:b + gene_block]
        base_mean.append((c / sf[None, :]).mean(dim=1))
        mom, coef, mu_hat, of = _mu_init(c, sf, X, pinv, min_mu, min_disp, max_disp, beta_tol, mu_init)
        gw, _, cache = alpha_mle_batch(c, X, mu_hat, mom, min_disp, max_disp, cr_reg=True, prior_reg=False,
                                       return_coarse=True)
        genewise.append(torch.clamp(gw, min_disp, max_disp))
        coarse.append(cache)
        coefs.append(coef)
        overflow.append(of)
    return torch.cat(base_mean), torch.cat(genewise), coarse, coefs, torch.stack(overflow).sum()


def _shrunk_dispersions(c, X, mu_hat, genewise, fitted, cache, prior_disp_var, squared_logres, min_disp, max_disp):
    """MAP dispersions from the cached coarse scan, and the dispersions the
    LFC fit uses (genewise where the gene is a shrinkage outlier)."""
    map_disp, _ = alpha_mle_batch(c, X, mu_hat, torch.nan_to_num(fitted, nan=0.5), min_disp, max_disp,
                                  prior_disp_var=prior_disp_var, cr_reg=True, prior_reg=True, coarse_cache=cache)
    map_disp = torch.clamp(map_disp, min_disp, max_disp)
    shrink_outlier = torch.log(genewise) > torch.log(fitted) + 2.0 * torch.sqrt(squared_logres)
    return map_disp, torch.where(shrink_outlier, genewise, map_disp)


def _analyse_pass(counts, non_zero, sf, X, contrast, lfc_null, cooks_cutoff, genewise_m, fitted_m, coarse, coefs,
                  prior_disp_var, squared_logres, *, gene_block, cohort_ids, use_for_max, replaceable, min_mu,
                  min_disp, max_disp, beta_tol, alt_hypothesis, mu_init):
    """Pass 2: per block, MAP dispersions, IRLS with rescue, hat diagonals +
    Wald and the Cook's flags in refit mode."""
    P = X.shape[1]
    blocks = []
    for k, b in enumerate(range(0, counts.shape[0], gene_block)):
        sl = slice(b, b + gene_block)
        c, nz = counts[sl], non_zero[sl]
        nan = torch.full((c.shape[0],), float("nan"), dtype=c.dtype, device=c.device)
        map_disp, dispersions = _shrunk_dispersions(
            c, X, _mu_hat(coefs[k], sf, X, min_mu, mu_init), genewise_m[sl], fitted_m[sl], coarse[k],
            prior_disp_var, squared_logres, min_disp, max_disp)
        dispersions = torch.where(nz, dispersions, nan)
        disp_safe = torch.nan_to_num(dispersions, nan=0.5)
        beta, converged, lfc_overflow = _irls_with_rescue(c, sf, X, disp_safe, irls_beta_init(c, sf, X),
                                                          min_mu=min_mu, beta_tol=beta_tol)
        H, mu, pv, st, se = hat_wald(beta, disp_safe, sf, X, contrast, lfc_null, min_mu=min_mu,
                                     alt_hypothesis=alt_hypothesis)
        flags = cooks_outliers(c, sf, mu, H, nz, P, cohort_ids, use_for_max, cooks_cutoff,
                               replaceable=replaceable, want_distances=False)
        blocks.append({
            "dispersions": dispersions,
            "MAP_dispersions": torch.where(nz, map_disp, nan),
            "lfc": torch.where(nz[:, None], beta, nan[:, None]),
            "p_values": torch.where(nz, pv, nan),
            "statistics": torch.where(nz, st, nan),
            "se": torch.where(nz, se, nan),
            "irls_converged": converged,
            "cooks_outlier": flags[1],
            "exceeds_packed": flags[3],
            "replaced": flags[4],
            "cooks_outlier_refit": flags[5],
            "_lfc_overflow": lfc_overflow,
        })
    lfc_overflow = torch.stack([blk.pop("_lfc_overflow") for blk in blocks]).sum()
    return {k: torch.cat([blk[k] for blk in blocks]) for k in blocks[0]}, lfc_overflow


def _main_pass(counts, X, contrast, lfc_null, cooks_cutoff, gene_mask, *, gene_block, sample_block, cohort_ids,
               use_for_max, replaceable, min_mu, min_disp, max_disp, beta_tol, trend_type, alt_hypothesis,
               mu_init):
    """The main pass in refit mode: size factors, pass 1, trend and prior,
    pass 2; no padj (the caller merges the refit first)."""
    G, N = counts.shape
    P = X.shape[1]
    logmeans, non_zero = _log_stats(counts, gene_mask, gene_block)
    sf = _streamed_size_factors(counts, gene_mask, logmeans, sample_block)
    base_mean, genewise, coarse, coefs, mu_overflow = _genewise_pass(
        counts, sf, X, ols_pinv(X), gene_block, min_mu, min_disp, max_disp, beta_tol, mu_init)
    genewise_m = torch.where(non_zero, genewise, torch.full_like(genewise, float("nan")))
    fitted, trend_coeffs, trend_used_mean, mean_disp = fit_fused_trend(base_mean, genewise_m, non_zero, min_disp,
                                                                       trend_type, max_rounds=20)
    fitted_m = torch.where(non_zero, fitted, torch.full_like(fitted, float("nan")))
    squared_logres, prior_disp_var = dispersion_prior(genewise_m, fitted_m, non_zero, min_disp, N, P)
    flat, lfc_overflow = _analyse_pass(
        counts, non_zero, sf, X, contrast, lfc_null, cooks_cutoff, genewise_m, fitted_m, coarse, coefs,
        prior_disp_var, squared_logres, gene_block=gene_block, cohort_ids=cohort_ids, use_for_max=use_for_max,
        replaceable=replaceable, min_mu=min_mu, min_disp=min_disp, max_disp=max_disp, beta_tol=beta_tol,
        alt_hypothesis=alt_hypothesis, mu_init=mu_init)
    return {
        "rescue_overflow": mu_overflow + lfc_overflow,
        "size_factors": sf,
        "base_mean": base_mean,
        "genewise_dispersions": genewise_m,
        "fitted_dispersions": fitted_m,
        "trend_coeffs": trend_coeffs,
        "trend_used_mean": trend_used_mean,
        "mean_disp": mean_disp,
        "squared_logres": squared_logres,
        "prior_disp_var": prior_disp_var,
        **flat,
    }


def refit_tile(counts_tile, exceeds_packed, tile_mask, sf, X, contrast, lfc_null, trend_coeffs, trend_used_mean,
               mean_disp, prior_disp_var, squared_logres, *, refit_block, replaceable, alt_hypothesis, min_mu,
               min_disp, max_disp, beta_tol, mu_init):
    """Impute the Cook's outlier counts of the flagged genes and refit them,
    ``refit_block`` tile rows at a time, with the main pass's trend, prior
    and size factors."""
    K, N = counts_tile.shape
    pinv = ols_pinv(X)
    blocks = []
    for b in range(0, K, refit_block):
        sl = slice(b, b + refit_block)
        m = tile_mask[sl]
        imputed, new_all_zero = impute_outliers(counts_tile[sl], exceeds_packed[sl], replaceable, sf, m)
        live = m & ~new_all_zero
        base_mean2 = (imputed / sf[None, :]).mean(dim=1)
        mom, _, mu_hat, of0 = _mu_init(imputed, sf, X, pinv, min_mu, min_disp, max_disp, beta_tol, mu_init)
        genewise2, _, coarse = alpha_mle_batch(imputed, X, mu_hat, mom, min_disp, max_disp,
                                               cr_reg=True, prior_reg=False, return_coarse=True)
        genewise2 = torch.clamp(genewise2, min_disp, max_disp)
        # The parent trend at the new normed means (reference dds.py:1421-1433).
        fitted2 = torch.where(trend_used_mean, mean_disp, trend_coeffs[0] + trend_coeffs[1] / base_mean2)
        map2, dispersions2 = _shrunk_dispersions(imputed, X, mu_hat, genewise2, fitted2, coarse, prior_disp_var,
                                                 squared_logres, min_disp, max_disp)
        disp_safe = torch.nan_to_num(dispersions2, nan=0.5)
        beta2, converged2, of1 = _irls_with_rescue(imputed, sf, X, disp_safe, irls_beta_init(imputed, sf, X),
                                                   min_mu=min_mu, beta_tol=beta_tol)
        _, _, pv2, st2, se2 = hat_wald(beta2, disp_safe, sf, X, contrast, lfc_null, min_mu=min_mu,
                                       alt_hypothesis=alt_hypothesis, want_hat=False)
        nan = torch.full_like(base_mean2, float("nan"))

        def nanl(a):
            return torch.where(live, a, nan)

        blocks.append({
            "new_all_zero": new_all_zero,
            "base_mean": torch.where(m, base_mean2, nan),
            "genewise_dispersions": nanl(genewise2),
            "fitted_dispersions": nanl(fitted2),
            "MAP_dispersions": nanl(map2),
            "dispersions": nanl(dispersions2),
            "lfc": torch.where(live[:, None], beta2, nan[:, None]),
            "p_values": nanl(pv2),
            "statistics": nanl(st2),
            "se": nanl(se2),
            "irls_converged": converged2,
        })
    return {k: torch.cat([blk[k] for blk in blocks]) for k in blocks[0]}


def _refit_block_size(N: int) -> int:
    """Rows per refit block: the main pass's ~4 GB budget, 256 to 4096 rows,
    rounded up to 8."""
    block = int(min(4096, max(256, _BLOCK_BUDGET_BYTES // (80 * N))))
    return ((block + 7) // 8) * 8


_REFIT_COLUMNS = ("base_mean", "genewise_dispersions", "fitted_dispersions", "MAP_dispersions", "dispersions",
                  "p_values", "statistics", "se")


def refit_summary(counts, design_matrix, contrast, lfc_null: float = 0.0, min_replicates: int = 7, alpha=0.05,
                  cooks_filter=True, independent_filter=True, min_mu=0.5, min_disp=1e-8, max_disp=10.0,
                  beta_tol=1e-8, trend_type="parametric", alt_hypothesis=None, tf32: bool = False) -> dict:
    """Counts -> padj with Cook's outlier replacement and refit, on the
    device and in the dtype of ``counts`` (G, N), gene-major. The design
    (N, P) is a numpy array or DataFrame, ``contrast`` (P,). Returns the
    per-gene results as numpy arrays (``size_factors`` (N,), ``lfc`` (G,
    P)), with ``replaced`` and ``refitted``, and the main pass's base means
    and genewise dispersions (``main_base_mean``,
    ``main_genewise_dispersions``), the trend's inputs.

    float32 products run in full precision: TF32 is off for the call, as the
    program runs them. ``tf32=True`` turns it on instead, the lower precision
    of the float32 control."""
    cuda_mm, cudnn = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    precision = torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    torch.set_float32_matmul_precision("high" if tf32 else "highest")
    try:
        return _refit_summary(counts, design_matrix, contrast, lfc_null, min_replicates, alpha, cooks_filter,
                              independent_filter, min_mu, min_disp, max_disp, beta_tol, trend_type, alt_hypothesis)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = cuda_mm, cudnn
        torch.set_float32_matmul_precision(precision)


def _refit_summary(counts, design_matrix, contrast, lfc_null, min_replicates, alpha, cooks_filter,
                   independent_filter, min_mu, min_disp, max_disp, beta_tol, trend_type, alt_hypothesis) -> dict:
    dev, dtype = counts.device, counts.dtype
    G, N = counts.shape
    gene_block = _auto_gene_block(G, N)
    padded_G = math.ceil(G / gene_block) * gene_block
    if padded_G != G:
        counts = torch.cat([counts, counts.new_zeros((padded_G - G, N))])
    if not bool((counts[:G] > 0).all(dim=1).any()):
        raise ValueError("every gene has a zero: the ratio size factors are undefined")
    host = summary_host_inputs(design_matrix, min_replicates)
    if not any(host["replaceable"]):
        raise ValueError("no sample is replaceable: the refit route does not run")
    gene_mask = torch.arange(padded_G, device=dev) < G
    sample_block = min(N, 1024) if G * N * counts.element_size() > 1_000_000_000 else None

    def on_dev(a):
        return torch.tensor(np.asarray(a, dtype=np.float64), device=dev).to(dtype).contiguous()

    X = on_dev(getattr(design_matrix, "values", design_matrix))
    contrast_t, lfc_null_t = on_dev(contrast), on_dev(lfc_null)
    knobs = dict(min_mu=min_mu, min_disp=min_disp, max_disp=max_disp, beta_tol=beta_tol, mu_init=host["mu_init"])
    out = _main_pass(counts, X, contrast_t, lfc_null_t, on_dev(host["cooks_cutoff"]), gene_mask,
                     gene_block=gene_block, sample_block=sample_block, cohort_ids=host["cohort_ids"],
                     use_for_max=host["use_for_max"], replaceable=host["replaceable"], trend_type=trend_type,
                     alt_hypothesis=alt_hypothesis, **knobs)
    res = _to_host({k: v for k, v in out.items() if k != "exceeds_packed"})
    res = {k: v[:G] if k != "size_factors" and v.ndim >= 1 and v.shape[0] == padded_G else v for k, v in res.items()}
    # The main pass's inputs to the trend, before the refit replaces them.
    res["main_base_mean"] = np.array(res["base_mean"])
    res["main_genewise_dispersions"] = np.array(res["genewise_dispersions"])

    idx = np.where(res["replaced"])[0]
    refitted = np.zeros(G, dtype=bool)
    if len(idx) > 0:
        refit_block = _refit_block_size(N)
        K = math.ceil(len(idx) / refit_block) * refit_block
        gather = torch.as_tensor(np.pad(idx, (0, K - len(idx))), device=dev)
        tile_mask = torch.arange(K, device=dev) < len(idx)
        r = refit_tile(counts.index_select(0, gather), out["exceeds_packed"].index_select(0, gather), tile_mask,
                       out["size_factors"], X, contrast_t, lfc_null_t, out["trend_coeffs"], out["trend_used_mean"],
                       out["mean_disp"], out["prior_disp_var"], out["squared_logres"], refit_block=refit_block,
                       replaceable=host["replaceable"], alt_hypothesis=alt_hypothesis, **knobs)
        rnp = {k: v[:len(idx)] for k, v in _to_host(r).items()}
        live = ~rnp["new_all_zero"]
        naz = idx[~live]
        refitted[idx[live]] = True
        for col in _REFIT_COLUMNS + ("lfc", "irls_converged"):
            res[col] = np.array(res[col])
            res[col][idx[live]] = rnp[col][live]
        # genes left all zero (reference dds.py:1381-1384, ds.py:356-360)
        res["base_mean"][naz] = 0.0
        res["lfc"][naz] = 0.0
        res["se"][naz] = 0.0
        res["statistics"][naz] = 0.0
        res["p_values"][naz] = 1.0
    res["refitted"] = refitted
    outlier = np.where(refitted, res.pop("cooks_outlier_refit"), res["cooks_outlier"])
    res["cooks_outlier"] = outlier
    p = np.array(res["p_values"])
    if cooks_filter:
        p[outlier] = np.nan
        res["p_values"] = p
    res["padj"] = device_padj(
        torch.as_tensor(p, device=dev), torch.as_tensor(res["base_mean"].astype(p.dtype), device=dev),
        torch.ones(G, dtype=torch.bool, device=dev), alpha, independent_filter,
    ).cpu().numpy()
    return res
