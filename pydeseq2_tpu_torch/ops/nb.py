"""Negative-binomial log-likelihood forms, batched over genes.

Port of ``pydeseq2_tpu/ops/nb.py``; expression for expression, so the plain
PyTorch path matches the JAX package. NB(mu, alpha) with variance
mu + alpha mu^2; counts/mu are (..., N) tiles and alpha broadcasts over the
leading (gene) axes.

For r = 1/alpha >= 8 (``_R_SWITCH``) the cancellation-free
Stirling-difference forms are used; below it the plain forms. The switch,
both forms and the dtype gates of the Stirling-8 lgamma/psi/psi' (float32
only; float64 keeps the library functions) are kept as in the JAX package:
near r = 8 the branch choice decides the value, and the f32 lgamma must be
the Stirling form or the port does not match the JAX f32 reference. The
CUDA kernels (``csrc/common.cuh``) carry the same forms.

:func:`dnb_nll`, the derivative in alpha, launches ``csrc/dnb_nll.cu`` on
CUDA tensors.
"""

from __future__ import annotations

import numbers

import torch

from pydeseq2_tpu_torch import kernels

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


def _psi_fast(z: torch.Tensor) -> torch.Tensor:
    """psi alone, gated by dtype as :func:`_digamma_fast`."""
    if z.dtype == torch.float32:
        return _digamma_stirling8(z)
    return _psi_series_f64(z)[0]


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


def _dnb_nll_plain(counts: torch.Tensor, mu: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`dnb_nll` (alpha already a tensor)."""
    r = 1.0 / alpha[..., None]
    term = _psi_fast(r) - _psi_fast(counts + r) + torch.log1p(mu * alpha[..., None]) + (counts - mu) / (mu + r)
    return -((1.0 / alpha**2) * term.sum(-1))


_DNB_BLOCK = 256  # lanes of a block a row (csrc/dnb_nll.cu THREADS)
# (most samples, lanes a row) of the lane-group plans; a block a row above
_DNB_GROUPS = ((48, 4), (256, 8), (4_095, 32))


def _dnb_plan(N: int, itemsize: int) -> int:
    """The lanes a row of ``dnb_nll`` takes for rows of N samples of
    ``itemsize`` bytes, from the shape alone (no read of the card): 4 lanes
    to 48 samples, 8 to 256, 32 below 4096, then a block a row.

    A ``kernel_bench --detail`` sweep on an H100 set the edges (f32 device
    ms, x 60000 rows unless stated): 32 samples 4 lanes 0.0167 (8: 0.0171),
    48 a tie (0.0235 / 0.0233), 64 8 lanes 0.0297 (4: 0.0305); 129 8 lanes
    0.0586 (32: 0.0711), 256 a tie (0.1053 / 0.1052), 1000 32 lanes 0.3633
    (8: 0.3733); 2048 x 30000 32 lanes 0.3243 (a block 0.3484), 4096 x
    15000 a tie (0.2950 / 0.2901), the atlas block 5000 x 10000 a block
    0.2983 (32: 0.3573). Wider groups read whole 32-byte sectors of a row,
    narrower ones idle fewer lanes. The edges are the same in both types
    (``itemsize``): at 100 samples float64 32 lanes ran 1-3% ahead of 8,
    within the spread of the float64 readings."""
    for most, lanes in _DNB_GROUPS:
        if N <= most:
            return lanes
    return _DNB_BLOCK


def dnb_nll(counts: torch.Tensor, mu: torch.Tensor, alpha) -> torch.Tensor:
    """Batched gradient of :func:`nb_nll` with respect to ``alpha``.

    Port of ``pydeseq2_tpu/ops/nb.py:dnb_nll`` (the reference's digamma
    form): -alpha^-2 sum_n [psi(1/alpha) - psi(y + 1/alpha) + log1p(mu alpha)
    + (y - mu)/(mu + 1/alpha)]. counts and mu (..., N), alpha broadcasting
    over the leading axes; the result has their broadcast leading shape.
    psi is the port's dtype-gated one (:func:`_psi_fast`: Stirling-8 in
    float32, the series in float64), the same on the card; the JAX package
    takes the library digamma. As alpha -> 0 the psi difference cancels and
    the float32 result is ill-conditioned, as JAX's is. CUDA tensors launch
    ``dnb_nll`` once (:func:`_dnb_nll_cuda`: a group of 4-32 lanes or a
    block a row by :func:`_dnb_plan`, a float64 row sum in a fixed order).
    """
    if not mu.is_cuda:
        return _dnb_nll_plain(counts, mu, torch.as_tensor(alpha, dtype=mu.dtype, device=mu.device))
    return _dnb_nll_cuda(counts, mu, alpha)


def _dnb_nll_cuda(counts: torch.Tensor, mu: torch.Tensor, alpha, lanes: int | None = None) -> torch.Tensor:
    """Launch ``dnb_nll`` once on the broadcast rows; ``lanes`` overrides
    :func:`_dnb_plan`. Counts and mu of mu's dtype laid out as the rows go
    in as they are. alpha: a number, or a one-value tensor on the host, goes
    to the launcher by value (no copy to the card); one value on the card
    is read by every row; else one value a row."""
    dtype, dev = mu.dtype, mu.device
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"dnb_nll: mu is {dtype}; the kernel takes float32 or float64")
    a, value, step = None, 0.0, 0
    if isinstance(alpha, torch.Tensor) and (alpha.is_cuda or alpha.numel() != 1):
        a = alpha.to(device=dev, dtype=dtype)
    elif not isinstance(alpha, (torch.Tensor, numbers.Real)):
        a = torch.as_tensor(alpha, dtype=dtype, device=dev)
    else:  # one value on the host
        value = float(alpha)
    lead = torch.broadcast_shapes(counts.shape[:-1], mu.shape[:-1], getattr(alpha if a is None else a, "shape", ()))
    N = torch.broadcast_shapes(counts.shape[-1:], mu.shape[-1:])[0]
    y = counts.to(dtype).expand(lead + (N,)).reshape(-1, N).contiguous()
    m = mu.expand(lead + (N,)).reshape(-1, N).contiguous()
    if a is not None:
        a, step = (a.reshape(()), 0) if a.numel() == 1 else (a.expand(lead).reshape(-1).contiguous(), 1)
    out = torch.empty(lead, dtype=dtype, device=dev)
    if lanes is None:
        lanes = _dnb_plan(N, mu.element_size())
    if lanes not in (4, 8, 32, _DNB_BLOCK):
        raise ValueError(f"dnb_nll: {lanes} lanes a row; the kernel takes 4, 8, 32 or {_DNB_BLOCK}")
    kernels.check_cuda_operands("dnb_nll", y, m, a, out)
    kernels.launch(
        "dnb_nll",
        [int(dtype == torch.float64), out.numel(), N, lanes, y.data_ptr(), m.data_ptr(), kernels.ptr(a), step, value,
         out.data_ptr()],
        dev,
    )
    return out
