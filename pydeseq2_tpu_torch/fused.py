"""The DESeq2 Wald and summary pipelines on a gene-major (G, N) counts tile.

Port of ``pydeseq2_tpu/fused.py``. ``wald_pipeline``: size factors -> MoM
dispersions -> mu init -> genewise dispersions -> trend -> prior -> MAP
dispersions -> IRLS LFCs -> hat diagonals + Wald test. ``summary_pipeline``
adds Cook's distances, the Cook's outlier mask and the adjusted p-values
(BH, or independent filtering), counts -> padj. PyTorch runs eagerly, so
the ``lax.cond``/``lax.switch``/``while_loop`` conditions of the single JAX
program become Python branches on values read from the device; each such
read is marked where it happens. The Cook's block and ``device_padj`` make
none.
"""

from __future__ import annotations

import torch

from pydeseq2_tpu_torch.convert import resolve_device
from pydeseq2_tpu_torch.ops.dispersion import alpha_mle_batch
from pydeseq2_tpu_torch.ops.irls import (
    _linspace,
    grid_fit_beta_batch,
    irls_beta_init,
    irls_core,
    newton_box_nbglm,
)
from pydeseq2_tpu_torch.ops.cooks import cooks_outliers
from pydeseq2_tpu_torch.ops.linreg import mom_and_mu_coef, ols_pinv
from pydeseq2_tpu_torch.ops.select import masked_median_select
from pydeseq2_tpu_torch.ops.nb import _psi_series_f64
from pydeseq2_tpu_torch.ops.stats import (
    bh_sweep,
    lowess_pick,
    nanmedian,
    nanquantile,
    trimmed_mean_masked,
)
from pydeseq2_tpu_torch.ops.trend import parametric_trend
from pydeseq2_tpu_torch.ops.vst import vst_transform
from pydeseq2_tpu_torch.ops.wald import hat_wald


def _irls_with_rescue(counts, size_factors, design_matrix, disp, beta_init, min_mu, beta_tol, phase1_iters=8):
    """Two-phase IRLS with the rescue cascade: ``(beta, converged, overflow)``.

    Phase 1 runs ``phase1_iters`` trips over every lane; the unfinished
    lanes continue from their iterate on a compacted tile of K = max(512,
    G/64) lanes, flagged first by a STABLE argsort, or at full width when
    more than K are unfinished (``phase1_iters=250``: one phase, the whole
    budget at once). Lanes still flagged then take the projected
    Newton rescue and, for P == 2, the 2-D grid; each tier is told which
    lanes of the tile it rescues (``sel``), and its kernel works on those
    only. ``overflow`` counts flagged lanes beyond the K tile. See
    ``pydeseq2_tpu/fused.py:51``.
    """
    X = design_matrix
    beta, needs_fb, converged = irls_core(
        counts, size_factors, X, disp, beta_init,
        min_mu=min_mu, beta_tol=beta_tol, maxiter=phase1_iters,
    )
    G = counts.shape[0]
    K = min(G, max(512, G // 64))
    # Flagged lanes first; ties keep ascending lane order (stable sort).
    idx1 = torch.argsort((~needs_fb).to(torch.int8), stable=True)[:K]

    # Host-evaluated lax.switch branch (fused.py:154-160); with
    # phase1_iters = 250 (one phase, as the class API's backend runs it)
    # there is nothing to continue.
    n_unfinished = int(needs_fb.sum()) if phase1_iters < 250 else 0
    if n_unfinished > K:
        b2, nfb2, conv2 = irls_core(
            counts, size_factors, X, disp, beta,
            min_mu=min_mu, beta_tol=beta_tol, maxiter=250 - phase1_iters,
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
    sel = needs_fb[idx]
    # Host-evaluated lax.cond (fused.py:183-185).
    if bool(needs_fb.any()):
        b_fb, ok = newton_box_nbglm(
            counts[idx], size_factors, X, disp[idx], beta_init[idx], min_mu=min_mu, sel=sel
        )
        beta, converged = beta.clone(), converged.clone()
        beta[idx] = torch.where(sel[:, None], b_fb, beta[idx])
        converged[idx] = torch.where(sel, ok, converged[idx])

    if X.shape[1] == 2:
        still_bad = needs_fb & ~converged
        sel_grid = still_bad[idx]
        # Host-evaluated lax.cond (fused.py:206-208).
        if bool(still_bad.any()):
            b_grid = grid_fit_beta_batch(counts[idx], size_factors, X, disp[idx], min_mu=min_mu, sel=sel_grid)
            beta = beta.clone()
            beta[idx] = torch.where(sel_grid[:, None], b_grid, beta[idx])
    return beta, converged, overflow


def fit_fused_trend(base_mean, genewise_m, non_zero, min_disp, trend_type, max_rounds=20):
    """Dispersion trend with the mean fallback: ``(fitted, coeffs,
    used_mean, mean_disp)``; ``fitted`` is not non_zero-masked. The
    parametric branch is :func:`~pydeseq2_tpu_torch.ops.trend.parametric_trend`
    (the ``trend`` kernel on CUDA tensors: no host read). See
    ``pydeseq2_tpu/fused.py:212``."""
    dtype = base_mean.dtype
    dev = base_mean.device
    sel = genewise_m > 10.0 * min_disp
    mean_disp = trimmed_mean_masked(genewise_m, sel, 0.001)

    if trend_type == "mean":
        G = base_mean.shape[0]
        return (
            mean_disp.expand(G).clone(),
            torch.zeros(2, dtype=dtype, device=dev),
            torch.tensor(True, device=dev),
            mean_disp,
        )

    fitted, coeffs, failed, _ = parametric_trend(base_mean, genewise_m, non_zero, mean_disp, max_rounds)
    return fitted, coeffs, failed, mean_disp


def dispersion_prior(genewise_m, fitted_m, non_zero, min_disp, N, P):
    """``(squared_logres, prior_disp_var)``: the squared MAD of the log
    residuals off the trend over genes with genewise >= 100 min_disp, and
    the prior variance max(squared_logres - trigamma((N - P) / 2), 0.25)
    (reference dds.py:840-884; ``pydeseq2_tpu/fused.py:447-458``)."""
    disp_resid = torch.log(genewise_m) - torch.log(fitted_m)
    above = genewise_m >= 100.0 * min_disp
    resid_sel = torch.where(above & non_zero, disp_resid, torch.full_like(disp_resid, float("nan")))
    # jnp.nanmedian averages the two middle values; torch.nanmedian does not.
    center = nanmedian(resid_sel)
    mad = nanmedian(torch.abs(resid_sel - center)) / 0.6744897501960817
    squared_logres = mad**2
    half_df = torch.tensor((N - P) / 2.0, dtype=genewise_m.dtype, device=genewise_m.device)
    # torch.polygamma(1, .) is ~1e-9 relative off in float64; the series is
    # ~1e-15 (the JAX package's polygamma is within 2e-16).
    trigamma = _psi_series_f64(half_df)[1] if half_df.dtype == torch.float64 else torch.polygamma(1, half_df)
    return squared_logres, torch.clamp(squared_logres - trigamma, min=0.25)


def _size_factors(counts: torch.Tensor, gene_mask: torch.Tensor):
    """Median-of-ratios size factors: ``(sf (N,), filtered (G,))``."""
    log_counts = torch.log(counts)  # -inf where zero
    logmeans = log_counts.mean(dim=1)
    filtered = ~torch.isinf(logmeans) & gene_mask
    inf = torch.full_like(log_counts, float("inf"))
    log_ratios = torch.where(filtered[:, None], log_counts - logmeans[:, None], inf)
    log_medians = masked_median_select(log_ratios, filtered.sum(), axis=0)
    return torch.exp(log_medians), filtered


def _poscounts_size_factors(counts: torch.Tensor, gene_mask: torch.Tensor) -> torch.Tensor:
    """Poscounts size factors (zero-rich data; reference dds.py:656-679)."""
    pos = counts > 0
    log_pos = torch.log(torch.where(pos, counts, torch.ones_like(counts)))
    logmeans = torch.where(pos, log_pos, torch.zeros_like(log_pos)).mean(dim=1)
    usable = torch.isfinite(logmeans) & (logmeans > 0) & gene_mask
    in_med = usable[:, None] & pos
    ratios = torch.where(in_med, log_pos - logmeans[:, None], torch.full_like(log_pos, float("inf")))
    sf = torch.exp(masked_median_select(ratios, in_med.sum(dim=0), axis=0))
    return sf / torch.exp(torch.mean(torch.log(sf)))


def _wald_impl(
    counts, design_matrix, contrast, lfc_null, gene_mask=None, size_factors=None,
    min_mu=0.5, min_disp=1e-8, max_disp=10.0, beta_tol=1e-8, trend_type="parametric",
    trend_rounds=8, alt_hypothesis=None, mu_init="linear", sf_fit_type="ratio",
):
    G, N = counts.shape
    P = design_matrix.shape[1]
    dtype = counts.dtype
    dev = counts.device
    X = design_matrix
    nan = torch.tensor(float("nan"), dtype=dtype, device=dev)

    if gene_mask is None:
        gene_mask = torch.ones(G, dtype=torch.bool, device=dev)

    # --- normalization ----------------------------------------------------
    if size_factors is not None:
        sf = size_factors
    elif sf_fit_type == "poscounts":
        sf = _poscounts_size_factors(counts, gene_mask)
    else:
        sf, _ = _size_factors(counts, gene_mask)
    base_mean = (counts / sf[None, :]).mean(dim=1)
    non_zero = ~(counts == 0).all(dim=1) & gene_mask

    # --- MoM dispersions and the linear mu init (one mom launch) ----------
    rde, mde, _, mu_lin = mom_and_mu_coef(counts, sf, X, ols_pinv(X), min_mu, want_mu=mu_init != "irls")
    mom = torch.clamp(torch.minimum(rde, mde), min_disp, max_disp)

    # --- mu init + genewise dispersion MLE --------------------------------
    if mu_init == "irls":
        beta_mom, _, mu_overflow = _irls_with_rescue(
            counts, sf, X, mom, irls_beta_init(counts, sf, X), min_mu=min_mu, beta_tol=beta_tol
        )
        mu_hat = sf[None, :] * torch.exp(beta_mom @ X.T)
    else:
        mu_overflow = torch.zeros((), dtype=torch.int64, device=dev)
        mu_hat = mu_lin
    genewise, _, coarse_cache = alpha_mle_batch(
        counts, X, mu_hat, mom, min_disp, max_disp, cr_reg=True, prior_reg=False, return_coarse=True
    )
    genewise = torch.clamp(genewise, min_disp, max_disp)
    genewise_m = torch.where(non_zero, genewise, nan)

    # --- trend --------------------------------------------------------------
    fitted, trend_coeffs, trend_used_mean, _ = fit_fused_trend(
        base_mean, genewise_m, non_zero, min_disp, trend_type, max_rounds=max(trend_rounds, 20)
    )
    fitted_m = torch.where(non_zero, fitted, nan)
    squared_logres, prior_disp_var = dispersion_prior(genewise_m, fitted_m, non_zero, min_disp, N, P)

    # --- MAP dispersions ------------------------------------------------------
    map_disp, _ = alpha_mle_batch(
        counts, X, mu_hat, torch.nan_to_num(fitted_m, nan=0.5), min_disp, max_disp,
        prior_disp_var=prior_disp_var, cr_reg=True, prior_reg=True, coarse_cache=coarse_cache,
    )
    map_disp = torch.clamp(map_disp, min_disp, max_disp)
    outlier = torch.log(genewise_m) > torch.log(fitted_m) + 2.0 * torch.sqrt(squared_logres)
    dispersions = torch.where(outlier, genewise_m, map_disp)
    dispersions = torch.where(non_zero, dispersions, nan)

    # --- LFC via IRLS -----------------------------------------------------------
    disp_safe = torch.nan_to_num(dispersions, nan=0.5)
    beta_init = irls_beta_init(counts, sf, X)
    beta, converged, lfc_overflow = _irls_with_rescue(
        counts, sf, X, disp_safe, beta_init, min_mu=min_mu, beta_tol=beta_tol
    )

    # --- hat diagonals + Wald test (mu unthresholded) -----------------------
    H, mu, pvals, stats, se = hat_wald(
        beta, disp_safe, sf, X, contrast, lfc_null, min_mu=min_mu, alt_hypothesis=alt_hypothesis
    )

    def nanm(a):
        return torch.where(non_zero, a, nan)

    return {
        "trend_used_mean": trend_used_mean,
        "trend_coeffs": trend_coeffs,
        "squared_logres": squared_logres,
        "size_factors": sf,
        "base_mean": base_mean,
        "genewise_dispersions": genewise_m,
        "fitted_dispersions": fitted_m,
        "dispersions": dispersions,
        "prior_disp_var": prior_disp_var,
        "lfc": torch.where(non_zero[:, None], beta, nan),
        "mu": mu,
        "hat_diagonals": H,
        "p_values": nanm(pvals),
        "statistics": nanm(stats),
        "se": nanm(se),
        "irls_converged": converged,
        "rescue_overflow": mu_overflow + lfc_overflow,
        "_non_zero": non_zero,
    }


def wald_pipeline(
    counts,
    design_matrix,
    contrast,
    lfc_null,
    gene_mask=None,
    size_factors=None,
    min_mu: float = 0.5,
    min_disp: float = 1e-8,
    max_disp: float = 10.0,
    beta_tol: float = 1e-8,
    trend_type: str = "parametric",
    trend_rounds: int = 8,
    alt_hypothesis: str | None = None,
    mu_init: str = "linear",
    sf_fit_type: str = "ratio",
    device: str | torch.device = "cuda",
) -> dict:
    """One-call DESeq2 Wald pipeline on ``device`` (default ``"cuda"``).

    counts (G, N) float32/float64, gene-major; design_matrix (N, P);
    contrast (P,); lfc_null a natural-log scalar; gene_mask (G,) bool with
    False for padding lanes; size_factors (N,) to bypass the estimator.
    Tensors or arrays; every operand moves to ``device`` in the dtype of
    ``counts``. Raises if CUDA is requested and absent. Returns the dict of
    ``pydeseq2_tpu.fused.wald_pipeline`` (same keys) as tensors on
    ``device``; :func:`pydeseq2_tpu_torch.outputs_to_numpy` converts it.
    """
    dev = resolve_device(device)
    counts = torch.as_tensor(counts, device=dev).contiguous()
    dtype = counts.dtype

    def on_dev(a):
        return None if a is None else torch.as_tensor(a, dtype=dtype, device=dev).contiguous()

    if gene_mask is not None:
        gene_mask = torch.as_tensor(gene_mask, dtype=torch.bool, device=dev)
    out = _wald_impl(
        counts, on_dev(design_matrix), on_dev(contrast), on_dev(lfc_null), gene_mask,
        on_dev(size_factors), min_mu=min_mu, min_disp=min_disp, max_disp=max_disp,
        beta_tol=beta_tol, trend_type=trend_type, trend_rounds=trend_rounds,
        alt_hypothesis=alt_hypothesis, mu_init=mu_init, sf_fit_type=sf_fit_type,
    )
    out.pop("_non_zero")
    return out


def summary_pipeline(
    counts,
    design_matrix,
    contrast,
    lfc_null,
    cooks_cutoff,
    gene_mask=None,
    size_factors=None,
    *,
    cohort_ids: tuple[int, ...] | None = None,
    use_for_max: tuple[bool, ...] | None = None,
    alpha: float = 0.05,
    cooks_filter: bool = True,
    independent_filter: bool = True,
    min_mu: float = 0.5,
    min_disp: float = 1e-8,
    max_disp: float = 10.0,
    beta_tol: float = 1e-8,
    trend_type: str = "parametric",
    trend_rounds: int = 8,
    alt_hypothesis: str | None = None,
    mu_init: str = "linear",
    sf_fit_type: str = "ratio",
    device: str | torch.device = "cuda",
) -> dict:
    """Counts -> padj on ``device`` (default ``"cuda"``): the DESeq2
    ``deseq2()`` + ``summary()`` workflow with ``refit_cooks=False``.

    :func:`wald_pipeline`, then Cook's distances and the Cook's outlier
    mask (reference pydeseq2/dds.py:986-1110) and the adjusted p-values, BH
    with or without independent filtering (reference pydeseq2/ds.py:486-542).
    ``cooks_cutoff`` (the F(0.99, P, N - P) quantile), ``cohort_ids`` and
    ``use_for_max`` come from :func:`summary_host_inputs`; the other
    arguments are :func:`wald_pipeline`'s. Returns the dict of
    ``pydeseq2_tpu.fused.summary_pipeline``: the Wald keys plus ``cooks``
    (G, N), ``cooks_outlier`` (G,), the outlier-masked ``p_values`` and
    ``padj`` (float64 whatever the dtype of ``counts``, as the JAX package
    adjusts in float64). The Cook's block and :func:`device_padj` read
    nothing back to the host.
    """
    dev = resolve_device(device)
    counts = torch.as_tensor(counts, device=dev).contiguous()
    G, N = counts.shape
    dtype = counts.dtype

    def on_dev(a):
        return None if a is None else torch.as_tensor(a, dtype=dtype, device=dev).contiguous()

    if gene_mask is None:
        gene_mask = torch.ones(G, dtype=torch.bool, device=dev)
    gene_mask = torch.as_tensor(gene_mask, dtype=torch.bool, device=dev)
    if use_for_max is None:
        use_for_max = (True,) * N
    X = on_dev(design_matrix)
    P = X.shape[1]
    # The cutoff is compared in the dtype of the distances, as the JAX
    # program compares a weakly typed scalar.
    cutoff = on_dev(cooks_cutoff)
    out = _wald_impl(
        counts, X, on_dev(contrast), on_dev(lfc_null), gene_mask, on_dev(size_factors),
        min_mu=min_mu, min_disp=min_disp, max_disp=max_disp, beta_tol=beta_tol,
        trend_type=trend_type, trend_rounds=trend_rounds, alt_hypothesis=alt_hypothesis,
        mu_init=mu_init, sf_fit_type=sf_fit_type,
    )
    non_zero = out.pop("_non_zero")

    # --- Cook's distances and outlier mask (reference dds.py:986-1110) ------
    cooks, outlier, _ = cooks_outliers(
        counts, out["size_factors"], out["mu"], out["hat_diagonals"], non_zero, P,
        cohort_ids, tuple(bool(u) for u in use_for_max), cutoff,
    )

    p = out["p_values"]
    if cooks_filter:
        p = torch.where(outlier, torch.full_like(p, float("nan")), p)
        out["p_values"] = p
    padj = device_padj(p, out["base_mean"], gene_mask, alpha, independent_filter)

    out["cooks"] = cooks
    out["cooks_outlier"] = outlier
    out["padj"] = torch.where(gene_mask, padj, torch.full_like(padj, float("nan")))
    return out


def vst_pipeline(
    counts,
    gene_mask=None,
    min_mu: float = 0.5,
    min_disp: float = 1e-8,
    max_disp: float = 10.0,
    trend_type: str = "parametric",
    trend_rounds: int = 8,
    device: str | torch.device = "cuda",
) -> dict:
    """Blind variance-stabilising transform of a (G, N) counts tile on
    ``device`` (default ``"cuda"``; raises if CUDA is requested and absent).

    Port of ``pydeseq2_tpu/fused.py:828`` (reference pydeseq2/dds.py:349-514
    with ``use_design=False``): median-of-ratios size factors, the MoM
    dispersions and linear mu under the intercept-only design (one ``mom``
    launch), the genewise dispersion MLE, the parametric (or mean) trend,
    then the transform (the ``vst`` kernel, :mod:`~pydeseq2_tpu_torch.ops.vst`).
    counts float32/float64, a tensor or array; gene_mask (G,) bool, False on
    padding lanes. Returns tensors: ``vst_counts`` (G, N), ``size_factors``,
    ``base_mean``, ``genewise_dispersions``, and ``trend_coeffs`` with
    ``trend_used_mean`` (parametric) or ``mean_disp`` (mean).
    """
    dev = resolve_device(device)
    counts = torch.as_tensor(counts, device=dev).contiguous()
    G, N = counts.shape
    dtype = counts.dtype
    gene_mask = (torch.ones(G, dtype=torch.bool, device=dev) if gene_mask is None
                 else torch.as_tensor(gene_mask, dtype=torch.bool, device=dev))
    X = torch.ones((N, 1), dtype=dtype, device=dev)  # blind: intercept-only design

    sf, _ = _size_factors(counts, gene_mask)
    base_mean = (counts / sf[None, :]).mean(dim=1)
    non_zero = ~(counts == 0).all(dim=1) & gene_mask
    rde, mde, _, mu_hat = mom_and_mu_coef(counts, sf, X, ols_pinv(X), min_mu)
    mom = torch.clamp(torch.minimum(rde, mde), min_disp, max_disp)
    genewise, _ = alpha_mle_batch(counts, X, mu_hat, mom, min_disp, max_disp, cr_reg=True, prior_reg=False)
    genewise = torch.clamp(genewise, min_disp, max_disp)
    genewise_m = torch.where(non_zero, genewise, torch.full_like(genewise, float("nan")))
    _, coeffs, used_mean, mean_disp = fit_fused_trend(base_mean, genewise_m, non_zero, min_disp, trend_type,
                                                      max_rounds=max(trend_rounds, 20))
    out = {"size_factors": sf, "base_mean": base_mean, "genewise_dispersions": genewise_m}
    if trend_type == "parametric":
        out["trend_coeffs"] = coeffs
        out["trend_used_mean"] = used_mean
    else:
        out["mean_disp"] = mean_disp
    out["vst_counts"] = vst_transform(counts, sf, coeffs, used_mean, mean_disp, gene_mask, trend_type)
    return out


def device_padj(
    p: torch.Tensor,
    base_mean: torch.Tensor,
    gene_mask: torch.Tensor,
    alpha: float,
    independent_filter: bool,
) -> torch.Tensor:
    """Adjusted p-values (G,), float64: BH over the valid genes, or
    independent filtering, on the device with no host read.

    Independent filtering (reference pydeseq2/ds.py:486-542) sweeps 50
    base-mean cutoffs as one launch of the ``bh`` kernel over one shared
    order of the p-values, fits a lowess through the rejection counts and
    picks the first cutoff whose count clears the fit's maximum less its
    residual RMS (one launch of the ``lowess`` kernel). Port of
    ``pydeseq2_tpu/fused.py:731``.
    """
    dtype = base_mean.dtype
    dev = base_mean.device
    nan = torch.tensor(float("nan"), dtype=dtype, device=dev)
    valid = ~torch.isnan(p) & gene_mask
    # The JAX package adjusts in float64 (jnp.result_type(float) under its
    # x64 pin) whatever the dtype of p; one stable sort serves every row.
    p_filled = torch.nan_to_num(p, nan=1.0).to(torch.float64)
    order = torch.argsort(p_filled, stable=True)
    if not independent_filter:
        return bh_sweep(p_filled, order, valid, alpha=alpha)[0][0]

    base_m = torch.where(gene_mask, base_mean, nan)
    # int / int is float64 in JAX under x64; torch would give float32.
    n_zero = ((base_m == 0) & gene_mask).sum().to(torch.float64)
    lower_q = (n_zero / torch.clamp(gene_mask.sum(), min=1).to(torch.float64)).to(dtype)
    upper_q = torch.where(
        lower_q < 0.95, torch.tensor(0.95, dtype=dtype, device=dev), torch.tensor(1.0, dtype=dtype, device=dev)
    )
    theta = lower_q + (upper_q - lower_q) * _linspace(0.0, 1.0, 50, dtype, dev)
    cutoffs = nanquantile(base_m, theta)
    adj, num_rej = bh_sweep(p_filled, order, valid, base_mean, cutoffs, alpha)  # (50, G), (50,)
    _, j = lowess_pick(theta, num_rej, frac=1.0 / 5.0)
    return adj.index_select(0, j.reshape(1))[0]


def summary_host_inputs(design_matrix, min_replicates: int = 7) -> dict:
    """Host-side, design-only inputs of :func:`summary_pipeline`.

    From the design matrix (pandas DataFrame or array): the F(0.99, P,
    N - P) Cook's cutoff (scipy, reference pydeseq2/dds.py:1080), the
    ``use_for_max`` mask of samples in >= 3-replicate cohorts (reference
    pydeseq2/utils.py:888-911), the cohort ids of those samples in
    first-seen order (None when there are none), the ``replaceable`` mask
    of >= ``min_replicates``-replicate samples, and the ``mu_init`` mode
    ("linear" when the design rows group 1:1 onto its columns, else
    "irls"). Port of ``pydeseq2_tpu/fused.py:772``.
    """
    import numpy as np
    import pandas as pd
    from scipy.stats import f

    from pydeseq2_tpu_torch.utils import n_or_more_replicates

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
