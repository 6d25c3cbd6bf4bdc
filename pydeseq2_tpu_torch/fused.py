"""The DESeq2 Wald pipeline on a gene-major (G, N) counts tile.

Port of ``pydeseq2_tpu/fused.py:wald_pipeline``: size factors -> MoM
dispersions -> mu init -> genewise dispersions -> trend -> prior -> MAP
dispersions -> IRLS LFCs -> hat diagonals -> Wald test. PyTorch runs
eagerly, so the ``lax.cond``/``lax.switch``/``while_loop`` conditions of the
single JAX program become Python branches on values read from the device;
each such read is marked where it happens.
"""

from __future__ import annotations

import torch

from pydeseq2_tpu_torch.convert import resolve_device
from pydeseq2_tpu_torch.ops.dispersion import alpha_mle_batch
from pydeseq2_tpu_torch.ops.irls import (
    grid_fit_beta_batch,
    hat_diagonals,
    irls_beta_init,
    irls_core,
    newton_box_nbglm,
)
from pydeseq2_tpu_torch.ops.linreg import (
    fit_lin_mu_batch,
    fit_moments_dispersions_batch,
    fit_rough_dispersions_batch,
)
from pydeseq2_tpu_torch.ops.select import masked_median_select
from pydeseq2_tpu_torch.ops.stats import nanmedian, trimmed_mean_masked
from pydeseq2_tpu_torch.ops.trend import gamma_glm_trend_fit
from pydeseq2_tpu_torch.ops.wald import wald_test_batch


def _irls_with_rescue(counts, size_factors, design_matrix, disp, beta_init, min_mu, beta_tol, phase1_iters=8):
    """Two-phase IRLS with the rescue cascade: ``(beta, converged, overflow)``.

    Phase 1 runs ``phase1_iters`` trips over every lane; the unfinished
    lanes continue from their iterate on a compacted tile of K = max(512,
    G/64) lanes, flagged first by a STABLE argsort, or at full width when
    more than K are unfinished. Lanes still flagged then take the projected
    Newton rescue and, for P == 2, the 2-D grid. ``overflow`` counts flagged
    lanes beyond the K tile. See ``pydeseq2_tpu/fused.py:51``.
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

    # Host-evaluated lax.switch branch (fused.py:154-160).
    n_unfinished = int(needs_fb.sum())
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
            counts[idx], size_factors, X, disp[idx], beta_init[idx], min_mu=min_mu
        )
        beta, converged = beta.clone(), converged.clone()
        beta[idx] = torch.where(sel[:, None], b_fb, beta[idx])
        converged[idx] = torch.where(sel, ok, converged[idx])

    if X.shape[1] == 2:
        still_bad = needs_fb & ~converged
        sel_grid = still_bad[idx]
        # Host-evaluated lax.cond (fused.py:206-208).
        if bool(still_bad.any()):
            b_grid = grid_fit_beta_batch(counts[idx], size_factors, X, disp[idx], min_mu=min_mu)
            beta = beta.clone()
            beta[idx] = torch.where(sel_grid[:, None], b_grid, beta[idx])
    return beta, converged, overflow


def fit_fused_trend(base_mean, genewise_m, non_zero, min_disp, trend_type, max_rounds=20):
    """Dispersion trend with the mean fallback: ``(fitted, coeffs,
    used_mean, mean_disp)``; ``fitted`` is not non_zero-masked.
    See ``pydeseq2_tpu/fused.py:212``."""
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

    covariates = 1.0 / base_mean
    valid = non_zero & torch.isfinite(covariates) & torch.isfinite(genewise_m)
    zero = torch.zeros_like(covariates)
    covariates = torch.where(valid, covariates, zero)
    targets = torch.where(valid, torch.nan_to_num(genewise_m), zero)

    coeffs = torch.ones(2, dtype=dtype, device=dev)
    failed = torch.tensor(False, device=dev)
    for _ in range(max_rounds):
        new_coeffs, preds, glm_ok = gamma_glm_trend_fit(covariates, targets, valid)
        failed = ~glm_ok | (new_coeffs <= 1e-10).any()
        drift = torch.sum(torch.log(torch.abs(new_coeffs / coeffs)) ** 2)
        ratio = genewise_m / preds
        valid = valid & (ratio >= 1e-4) & (ratio < 15.0)
        coeffs = new_coeffs
        # Host-evaluated while_loop condition (fused.py:264-266).
        if bool(failed) or not bool(drift >= 1e-6):
            break

    parametric = coeffs[0] + coeffs[1] / base_mean
    fitted = torch.where(failed, mean_disp, parametric)
    return fitted, coeffs, failed, mean_disp


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
    normed = counts / sf[None, :]
    base_mean = normed.mean(dim=1)
    non_zero = ~(counts == 0).all(dim=1) & gene_mask

    # --- MoM dispersions --------------------------------------------------
    rde = fit_rough_dispersions_batch(normed, X)
    mde = fit_moments_dispersions_batch(normed, sf)
    mom = torch.clamp(torch.minimum(rde, mde), min_disp, max_disp)

    # --- mu init + genewise dispersion MLE --------------------------------
    if mu_init == "irls":
        beta_mom, _, mu_overflow = _irls_with_rescue(
            counts, sf, X, mom, irls_beta_init(counts, sf, X), min_mu=min_mu, beta_tol=beta_tol
        )
        mu_hat = sf[None, :] * torch.exp(beta_mom @ X.T)
    else:
        mu_overflow = torch.zeros((), dtype=torch.int64, device=dev)
        mu_hat = fit_lin_mu_batch(counts, sf, X, min_mu)
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

    # --- dispersion prior (reference dds.py:840-884) ------------------------
    disp_resid = torch.log(genewise_m) - torch.log(fitted_m)
    above = genewise_m >= 100.0 * min_disp
    resid_sel = torch.where(above & non_zero, disp_resid, nan)
    # jnp.nanmedian averages the two middle values; torch.nanmedian does not.
    center = nanmedian(resid_sel)
    mad = nanmedian(torch.abs(resid_sel - center)) / 0.6744897501960817
    squared_logres = mad**2
    trigamma = torch.polygamma(1, torch.tensor((N - P) / 2.0, dtype=dtype, device=dev))
    prior_disp_var = torch.clamp(squared_logres - trigamma, min=0.25)

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
    H, mu = hat_diagonals(counts, sf, X, disp_safe, beta, min_mu=min_mu)

    # --- Wald test --------------------------------------------------------------
    ridge = 1e-6 * torch.eye(P, dtype=dtype, device=dev)
    pvals, stats, se = wald_test_batch(X, disp_safe, beta, mu, ridge, contrast, lfc_null, alt_hypothesis)

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
    return _wald_impl(
        counts, on_dev(design_matrix), on_dev(contrast), on_dev(lfc_null), gene_mask,
        on_dev(size_factors), min_mu=min_mu, min_disp=min_disp, max_disp=max_disp,
        beta_tol=beta_tol, trend_type=trend_type, trend_rounds=trend_rounds,
        alt_hypothesis=alt_hypothesis, mu_init=mu_init, sf_fit_type=sf_fit_type,
    )
