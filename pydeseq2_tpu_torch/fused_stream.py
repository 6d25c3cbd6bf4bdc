"""Gene-streamed pipelines: the summary with Cook's outlier replacement and
refit, apeGLM LFC shrinkage and the blind VST, with O(gene_block x N)
temporaries.

Port of ``pydeseq2_tpu/fused_stream.py``: the streamed summary
(:func:`summary_pipeline_streamed`, ``:188``), the refit of the genes whose
Cook's outliers were replaced (:func:`refit_pipeline_streamed`, ``:504``),
their host wrapper :func:`run_summary_streamed` (``:783``, the default path
of ``api.run_deseq2``), and the shrinkage
(:func:`lfc_shrink_pipeline_streamed`, ``:975``, and
:func:`run_lfc_shrink_streamed`, ``:1085``) and the blind VST
(:func:`vst_pipeline_streamed`, ``:1184``, and :func:`run_vst_streamed`,
``:1285``). The raw counts stay on the
device once; every per-gene stage runs over ``gene_block`` row slices in a
Python loop (``lax.map`` in the JAX program), and the global reductions
(size factors, trend, prior, the BH sweep) run between the passes on O(G)
data, so each block sees the inputs the monolithic pipeline would give it.
The ``lax.cond``/``while_loop`` conditions that stay on the host are marked
where they are read. On zero-inflated counts :func:`run_summary_streamed`
switches to the iterative size factors (:mod:`~pydeseq2_tpu_torch.ops.sizefactors`).
"""

from __future__ import annotations

import math
import warnings

import numpy as np
import torch

from pydeseq2_tpu_torch.convert import resolve_device
from pydeseq2_tpu_torch.fused import (
    _irls_with_rescue,
    device_padj,
    dispersion_prior,
    fit_fused_trend,
    summary_host_inputs,
)
from pydeseq2_tpu_torch.models.stats import _apeglm_prior_variance
from pydeseq2_tpu_torch.ops.cooks import cooks_outliers
from pydeseq2_tpu_torch.ops.dispersion import alpha_mle_batch
from pydeseq2_tpu_torch.ops.irls import irls_beta_init
from pydeseq2_tpu_torch.ops.linreg import mom_and_mu_coef, mu_from_coef, ols_pinv
from pydeseq2_tpu_torch.ops.refit import impute_outliers
from pydeseq2_tpu_torch.ops.select import masked_median_select
from pydeseq2_tpu_torch.ops.sizefactors import iterative_size_factors, pick_sf_gene_block
from pydeseq2_tpu_torch.ops.shrink import _hess, grid_fit_shrink_beta_batch, nbinom_fn_batch, nbinom_glm_batch
from pydeseq2_tpu_torch.ops.smalllinalg import sym_inv
from pydeseq2_tpu_torch.ops.vst import vst_transform
from pydeseq2_tpu_torch.ops.wald import hat_wald

# The ~4 GB device budget of the JAX package's block sizing: ~20 live
# (block, N) temporaries of <= 8 bytes (80 bytes a cell).
_BLOCK_BUDGET_BYTES = 4_000_000_000
_NP_DTYPE = {torch.float32: np.float32, torch.float64: np.float64}


def _stage_counts(counts, dtype, n_genes, gene_block, dev):
    """The host wrappers' counts: on ``dev`` in ``dtype`` (a torch or numpy
    float dtype; a tensor already there is not copied), with zero rows
    appended up to a multiple of the gene block. ``n_genes`` is the number
    of leading real genes of pre-padded counts. ``gene_block=None`` splits
    them evenly into blocks whose ~20 live (block, N) temporaries of <= 8
    bytes fit the ~4 GB budget, rounded up to 8 (the whole gene axis up to
    ~1000 samples). Returns ``(counts, G, gene_block)``, G the real genes."""
    tdtype = dtype if isinstance(dtype, torch.dtype) else {np.dtype(np.float32): torch.float32,
                                                           np.dtype(np.float64): torch.float64}[np.dtype(dtype)]
    if isinstance(counts, torch.Tensor):
        counts = counts.to(device=dev, dtype=tdtype)
    else:
        counts = torch.tensor(np.asarray(counts, _NP_DTYPE[tdtype]), device=dev)
    G_phys, N = counts.shape
    G = G_phys
    if n_genes is not None:
        if not 0 < n_genes <= G:
            raise ValueError(f"n_genes={n_genes} outside (0, {G}]")
        G = n_genes
    if gene_block is None:
        raw = int(max(1024, min(G, _BLOCK_BUDGET_BYTES // (80 * N))))
        n_blocks = -(-G // raw)
        gene_block = ((-(-G // n_blocks) + 7) // 8) * 8
    padded_G = math.ceil(G_phys / gene_block) * gene_block
    if padded_G != G_phys:
        counts = torch.cat([counts, counts.new_zeros((padded_G - G_phys, N))])
    return counts.contiguous(), G, gene_block


def _to_host(tensors: dict) -> dict:
    """Numpy copies of a dict of tensors in ONE device-to-host copy: every
    tensor is widened to one dtype, joined, copied, split and cast back.
    The dtype is float32 where every tensor is float32 or bool (a (G, N)
    VST result then crosses at its own width), else float64 (exact for the
    bools, small integers, float32 and float64 held here)."""
    if not tensors:
        return {}
    narrow = all(v.dtype in (torch.float32, torch.bool) for v in tensors.values())
    wide = torch.float32 if narrow else torch.float64
    flat = torch.cat([v.reshape(-1).to(wide) for v in tensors.values()]).cpu().numpy()
    out, at = {}, 0
    for k, v in tensors.items():
        n = v.numel()
        out[k] = flat[at:at + n].reshape(tuple(v.shape)).astype(str(v.dtype).removeprefix("torch."))
        at += n
    return out


# ---------------------------------------------------------------- size factors
def _block_starts(N: int, sample_block: int) -> list[int]:
    """Column-block starts; the last block's start is clamped to N - block,
    so it overlaps the one before and recomputes a few columns (each
    column's median depends on that column only)."""
    return [min(b * sample_block, N - sample_block) for b in range(-(-N // sample_block))]


def _median_of_col_blocks(counts, med_of_cols, sample_block):
    N = counts.shape[1]
    if sample_block is None or sample_block >= N:
        return med_of_cols(counts)
    med = torch.zeros(N, dtype=counts.dtype, device=counts.device)
    for s in _block_starts(N, sample_block):
        med[s:s + sample_block] = med_of_cols(counts[:, s:s + sample_block])
    return med


def _streamed_size_factors(counts, gene_mask, logmeans, sample_block=None):
    """Median-of-ratios size factors over the genes with finite log-means,
    sample-blocked (``pydeseq2_tpu/fused_stream.py:64``): excluded genes sit
    at +inf and the two middle order statistics come from the ``select``
    kernel, a column block at a time."""
    filtered = ~torch.isinf(logmeans) & gene_mask
    m = filtered.sum()

    def med_of_cols(cols):
        ratios = torch.where(filtered[:, None], torch.log(cols) - logmeans[:, None],
                             torch.full_like(cols, float("inf")))
        return masked_median_select(ratios, m, axis=0)

    return torch.exp(_median_of_col_blocks(counts, med_of_cols, sample_block))


def _streamed_poscounts_size_factors(counts, usable, logmeans, sample_block=None):
    """Poscounts size factors, sample-blocked (``pydeseq2_tpu/fused_stream.py:117``):
    each sample's median runs over the usable genes positive in it, then the
    factors are rescaled to geometric mean 1."""

    def med_of_cols(cols):
        in_med = usable[:, None] & (cols > 0)
        ratios = torch.where(in_med, torch.log(torch.where(cols > 0, cols, torch.ones_like(cols))) - logmeans[:, None],
                             torch.full_like(cols, float("inf")))
        return masked_median_select(ratios, in_med.sum(dim=0), axis=0)

    sf = torch.exp(_median_of_col_blocks(counts, med_of_cols, sample_block))
    return sf / torch.exp(torch.mean(torch.log(sf)))


# ---------------------------------------------------------- streamed summary
def _log_stats(counts, gene_mask, gene_block, sf_fit_type):
    """The cheap full sweep: per-gene log-means (over positive counts with
    the full-N divisor for poscounts, -inf where a gene has a zero
    otherwise) and the non-zero mask (``fused_stream.py:255-270``)."""
    logmeans, non_zero = [], []
    for b in range(0, counts.shape[0], gene_block):
        c = counts[b:b + gene_block]
        if sf_fit_type == "poscounts":
            pos = c > 0
            logmeans.append(torch.where(pos, torch.log(torch.where(pos, c, torch.ones_like(c))),
                                        torch.zeros_like(c)).mean(dim=1))
        else:
            logmeans.append(torch.log(c).mean(dim=1))
        non_zero.append((c > 0).any(dim=1) & gene_mask[b:b + gene_block])
    return torch.cat(logmeans), torch.cat(non_zero)


def _mu_init(c, sf, X, pinv, min_mu, min_disp, max_disp, beta_tol, mu_init):
    """MoM dispersions, the mu-init coefficients and mu of one tile: ``(mom,
    beta_coef, mu_hat, overflow)``. The coefficients are the OLS fit
    ("linear", mu from the same ``mom`` launch) or the IRLS fit with rescue
    ("irls"); :func:`_mu_hat` rebuilds mu from them in a later pass
    (``fused_stream.py:287-314``)."""
    linear = mu_init != "irls"
    rough, moments, coef, mu_hat = mom_and_mu_coef(c, sf, X, pinv, min_mu, want_mu=linear)
    mom = torch.clamp(torch.minimum(rough, moments), min_disp, max_disp)
    if linear:
        return mom, coef, mu_hat, torch.zeros((), dtype=torch.int64, device=c.device)
    coef, _, overflow = _irls_with_rescue(c, sf, X, mom, irls_beta_init(c, sf, X), min_mu=min_mu, beta_tol=beta_tol)
    return mom, coef, _mu_hat(coef, sf, X, min_mu, mu_init), overflow


def _mu_hat(coef, sf, X, min_mu, mu_init):
    """mu from the init coefficients: UNthresholded sf e^{X b} after the
    IRLS init (the reference irls_solver's return), else the clamped OLS
    fit."""
    if mu_init == "irls":
        return sf[None, :] * torch.exp(coef @ X.T)
    return mu_from_coef(coef, sf, X, min_mu)


def _genewise_pass(counts, sf, X, pinv, gene_block, min_mu, min_disp, max_disp, beta_tol, mu_init):
    """Streamed pass 1: per block, base means, the mu init and the genewise
    dispersion MLE with its coarse-grid objective cache, which the MAP fit
    of pass 2 reuses (``fused_stream.py:316-332``)."""
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


def _trend_and_prior(base_mean, genewise_m, non_zero, min_disp, trend_type, N, P):
    """The global reductions between the passes: the dispersion trend (one
    ``trend`` launch) and the prior (``fused_stream.py:334-350``)."""
    fitted, coeffs, used_mean, mean_disp = fit_fused_trend(base_mean, genewise_m, non_zero, min_disp, trend_type)
    fitted_m = torch.where(non_zero, fitted, torch.full_like(fitted, float("nan")))
    squared_logres, prior_disp_var = dispersion_prior(genewise_m, fitted_m, non_zero, min_disp, N, P)
    return fitted_m, coeffs, used_mean, mean_disp, squared_logres, prior_disp_var


def _shrunk_dispersions(c, X, mu_hat, genewise, fitted, cache, prior_disp_var, squared_logres, min_disp, max_disp):
    """MAP dispersions from the cached coarse scan, and the dispersions the
    LFC fit uses (genewise where the gene is a shrinkage outlier):
    ``(map, dispersions)``."""
    map_disp, _ = alpha_mle_batch(c, X, mu_hat, torch.nan_to_num(fitted, nan=0.5), min_disp, max_disp,
                                  prior_disp_var=prior_disp_var, cr_reg=True, prior_reg=True, coarse_cache=cache)
    map_disp = torch.clamp(map_disp, min_disp, max_disp)
    shrink_outlier = torch.log(genewise) > torch.log(fitted) + 2.0 * torch.sqrt(squared_logres)
    return map_disp, torch.where(shrink_outlier, genewise, map_disp)


def _analyse_pass(counts, non_zero, sf, X, contrast, lfc_null, cooks_cutoff, genewise_m, fitted_m,
                  coarse, coefs, prior_disp_var, squared_logres, *, gene_block, cohort_ids, use_for_max,
                  replaceable, min_mu, min_disp, max_disp, beta_tol, alt_hypothesis, mu_init, stats_layer):
    """Streamed pass 2: per block, MAP dispersions, IRLS with rescue, hat
    diagonals + Wald and the Cook's flags (``fused_stream.py:352-460``). The
    Cook's distances live only inside the ``cooks`` launch; with
    ``replaceable`` it also emits the refit-mode outputs."""
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
        res = {
            "dispersions": dispersions,
            "MAP_dispersions": torch.where(nz, map_disp, nan),
            "lfc": torch.where(nz[:, None], beta, nan[:, None]),
            "p_values": torch.where(nz, pv, nan),
            "statistics": torch.where(nz, st, nan),
            "se": torch.where(nz, se, nan),
            "irls_converged": converged,
            "_lfc_overflow": lfc_overflow,
        }
        if stats_layer:
            flags = cooks_outliers(c, sf, mu, H, nz, P, cohort_ids, use_for_max, cooks_cutoff,
                                   replaceable=replaceable, want_distances=False)
            res["cooks_outlier"] = flags[1]
            if replaceable is not None:
                res["exceeds_packed"], res["replaced"], res["cooks_outlier_refit"] = flags[3:]
        blocks.append(res)
    lfc_overflow = torch.stack([blk.pop("_lfc_overflow") for blk in blocks]).sum()
    return {k: torch.cat([blk[k] for blk in blocks]) for k in blocks[0]}, lfc_overflow


def summary_pipeline_streamed(
    counts: torch.Tensor,
    design_matrix: torch.Tensor,
    contrast: torch.Tensor,
    lfc_null: torch.Tensor,
    cooks_cutoff: torch.Tensor,
    gene_mask: torch.Tensor | None = None,
    size_factors: torch.Tensor | None = None,
    *,
    gene_block: int = 8192,
    sample_block: int | None = None,
    cohort_ids: tuple[int, ...] | None = None,
    use_for_max: tuple[bool, ...] | None = None,
    replaceable: tuple[bool, ...] | None = None,
    alpha: float = 0.05,
    cooks_filter: bool = True,
    independent_filter: bool = True,
    min_mu: float = 0.5,
    min_disp: float = 1e-8,
    max_disp: float = 10.0,
    beta_tol: float = 1e-8,
    trend_type: str = "parametric",
    alt_hypothesis: str | None = None,
    mu_init: str = "linear",
    stats_layer: bool = True,
    refit_mode: bool = False,
    sf_fit_type: str = "ratio",
) -> dict:
    """Counts -> padj with O(gene_block x N) temporaries, on the device of
    ``counts``.

    The arguments and semantics of :func:`pydeseq2_tpu_torch.summary_pipeline`
    plus ``gene_block`` (G must be a multiple of it: pad with
    ``gene_mask=False`` lanes, as :func:`run_summary_streamed` does) and
    ``sample_block`` (size-factor medians over column blocks). Tensors of
    one float dtype on one device. ``stats_layer=False`` skips the Cook's
    flags and padj; ``size_factors`` (N,) skips the estimator.
    ``refit_mode=True`` (with ``replaceable``, the (N,) samples in cohorts
    of at least ``min_replicates``) prepares the Cook's refit instead of
    finishing: per-gene ``replaced``, the packed exceed bits
    ``exceeds_packed`` and ``cooks_outlier_refit``; p-value masking and
    padj are left to the caller, which merges the refit first. Returns the
    dict of ``pydeseq2_tpu/fused_stream.py:188`` as tensors; no (G, N)
    result.
    """
    G, N = counts.shape
    X = design_matrix
    P = X.shape[1]
    if gene_mask is None:
        gene_mask = torch.ones(G, dtype=torch.bool, device=counts.device)
    if use_for_max is None:
        use_for_max = (True,) * N
    if G % gene_block:
        raise ValueError(f"pad G={G} to a multiple of gene_block={gene_block}")
    if refit_mode and replaceable is None:
        raise ValueError("refit_mode needs the replaceable mask")

    logmeans, non_zero = _log_stats(counts, gene_mask, gene_block, sf_fit_type)
    if size_factors is not None:
        sf = size_factors
    elif sf_fit_type == "poscounts":
        usable = torch.isfinite(logmeans) & (logmeans > 0) & gene_mask
        sf = _streamed_poscounts_size_factors(counts, usable, logmeans, sample_block)
    else:
        sf = _streamed_size_factors(counts, gene_mask, logmeans, sample_block)

    base_mean, genewise, coarse, coefs, mu_overflow = _genewise_pass(
        counts, sf, X, ols_pinv(X), gene_block, min_mu, min_disp, max_disp, beta_tol, mu_init)
    genewise_m = torch.where(non_zero, genewise, torch.full_like(genewise, float("nan")))
    fitted_m, trend_coeffs, trend_used_mean, mean_disp, squared_logres, prior_disp_var = _trend_and_prior(
        base_mean, genewise_m, non_zero, min_disp, trend_type, N, P)

    flat, lfc_overflow = _analyse_pass(
        counts, non_zero, sf, X, contrast, lfc_null, cooks_cutoff, genewise_m, fitted_m, coarse, coefs,
        prior_disp_var, squared_logres, gene_block=gene_block, cohort_ids=cohort_ids,
        use_for_max=tuple(bool(u) for u in use_for_max), replaceable=replaceable if refit_mode else None,
        min_mu=min_mu, min_disp=min_disp, max_disp=max_disp, beta_tol=beta_tol, alt_hypothesis=alt_hypothesis,
        mu_init=mu_init, stats_layer=stats_layer)
    out = {
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
    if stats_layer and not refit_mode:
        p = out["p_values"]
        if cooks_filter:
            p = torch.where(out["cooks_outlier"], torch.full_like(p, float("nan")), p)
            out["p_values"] = p
        out["padj"] = _padj_program(p, base_mean, gene_mask, alpha, independent_filter)
    return out


# --------------------------------------------------------------- Cook's refit
def refit_pipeline_streamed(
    counts_tile: torch.Tensor,
    exceeds_packed: torch.Tensor,
    tile_mask: torch.Tensor,
    size_factors: torch.Tensor,
    design_matrix: torch.Tensor,
    contrast: torch.Tensor,
    lfc_null: torch.Tensor,
    trend_coeffs: torch.Tensor,
    trend_used_mean: torch.Tensor,
    mean_disp: torch.Tensor,
    prior_disp_var: torch.Tensor,
    squared_logres: torch.Tensor,
    *,
    refit_block: int = 4096,
    replaceable: tuple[bool, ...],
    alt_hypothesis: str | None = None,
    min_mu: float = 0.5,
    min_disp: float = 1e-8,
    max_disp: float = 10.0,
    beta_tol: float = 1e-8,
    mu_init: str = "linear",
) -> dict:
    """Impute the Cook's outlier counts of the flagged genes and refit them,
    a ``refit_block`` of tile rows at a time (``pydeseq2_tpu/fused_stream.py:504``).

    The (K, N) tile holds the genes whose ``replaced`` flag fired, padded to
    a multiple of ``refit_block`` with ``tile_mask=False`` rows. Per block:
    the ``impute`` kernel; genes left all zero are reported
    (``new_all_zero``), not refitted; then the genewise dispersion MLE (MoM
    and mu init), the PARENT trend at the new base means (not refitted),
    MAP shrinkage with the parent prior, IRLS and the Wald test (reference
    dds.py:1392-1441). The global inputs (trend, prior, size factors) come
    from the main pass, so the refit is gene-parallel.
    """
    K, N = counts_tile.shape
    X = design_matrix
    sf = size_factors
    if K % refit_block:
        raise ValueError(f"pad the refit tile K={K} to a multiple of refit_block={refit_block}")
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
        # The parent trend at the NEW normed means (reference dds.py:1421-1433).
        fitted2 = torch.where(trend_used_mean, mean_disp, trend_coeffs[0] + trend_coeffs[1] / base_mean2)
        map2, dispersions2 = _shrunk_dispersions(imputed, X, mu_hat, genewise2, fitted2, coarse, prior_disp_var,
                                                 squared_logres, min_disp, max_disp)
        disp_safe = torch.nan_to_num(dispersions2, nan=0.5)
        beta2, converged2, of1 = _irls_with_rescue(imputed, sf, X, disp_safe, irls_beta_init(imputed, sf, X),
                                                   min_mu=min_mu, beta_tol=beta_tol)
        _, _, pv2, st2, se2 = hat_wald(beta2, disp_safe, sf, X, contrast, lfc_null, min_mu=min_mu,
                                       alt_hypothesis=alt_hypothesis)
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
            "_overflow": of0 + of1,
        })
    overflow = torch.stack([blk.pop("_overflow") for blk in blocks]).sum()
    out = {k: torch.cat([blk[k] for blk in blocks]) for k in blocks[0]}
    out["rescue_overflow"] = overflow
    return out


def _padj_program(p, base_mean, gene_mask, alpha, independent_filter):
    """padj on the merged arrays (``fused_stream.py:661``), NaN off the mask."""
    padj = device_padj(p, base_mean, gene_mask, alpha, independent_filter)
    return torch.where(gene_mask, padj, torch.full_like(padj, float("nan")))


def _refit_block_size(N: int) -> int:
    """Rows per refit block: the main pass's ~4 GB budget, 256 to 4096 rows,
    rounded up to 8 (``fused_stream.py:701-702``)."""
    block = int(min(4096, max(256, _BLOCK_BUDGET_BYTES // (80 * N))))
    return ((block + 7) // 8) * 8


def _gather_refit_tile(counts_dev, exceeds_packed, idx, refit_block):
    """The compacted refit tile, gathered on the device: the flagged genes'
    rows and exceed words, padded to a multiple of ``refit_block`` with
    copies of row 0 masked out (``fused_stream.py:697-710``)."""
    n_rep = len(idx)
    K = math.ceil(n_rep / refit_block) * refit_block
    dev = counts_dev.device
    gather = torch.as_tensor(np.pad(idx, (0, K - n_rep)), device=dev)
    tile_mask = torch.arange(K, device=dev) < n_rep
    return counts_dev.index_select(0, gather), exceeds_packed.index_select(0, gather), tile_mask


_REFIT_COLUMNS = ("base_mean", "genewise_dispersions", "fitted_dispersions", "MAP_dispersions", "dispersions",
                  "p_values", "statistics", "se")


def _merge_refit(res, rnp, idx, G):
    """Overwrite the refitted genes' columns of the host result ``res`` with
    the refit's ``rnp`` (both numpy); genes left all zero get zero means and
    LFC and neutral Wald statistics (reference dds.py:1381-1384,
    ds.py:356-360). Returns (refitted, new_all_zeroes), (G,) bools."""
    refitted = np.zeros(G, dtype=bool)
    new_all_zero = np.zeros(G, dtype=bool)
    naz = rnp["new_all_zero"]
    live = ~naz
    refitted[idx[live]] = True
    new_all_zero[idx[naz]] = True
    for col in _REFIT_COLUMNS + ("lfc", "irls_converged"):
        res[col] = np.array(res[col])
        res[col][idx[live]] = rnp[col][live]
    res["base_mean"][idx[naz]] = 0.0
    res["lfc"][idx[naz]] = 0.0
    res["se"][idx[naz]] = 0.0
    res["statistics"][idx[naz]] = 0.0
    res["p_values"][idx[naz]] = 1.0
    res["rescue_overflow"] = res["rescue_overflow"] + rnp["rescue_overflow"]
    return refitted, new_all_zero


def _apply_streamed_refit(res, out, counts_dev, X, contrast, lfc_null, host, knobs, G):
    """Gather the flagged genes, refit them, merge, mask, adjust
    (``pydeseq2_tpu/fused_stream.py:670``; reference dds.py:1042-1064 then
    ds.py:223-301). ``res`` is the host result of the main pass, ``out``
    its device tensors; refitted genes keep ``cooks_outlier_refit``, and
    padj runs on the merged arrays over the G real genes."""
    # Host-evaluated: which genes to refit (the gather's index list).
    idx = np.where(res["replaced"])[0]
    refitted = np.zeros(G, dtype=bool)
    new_all_zero = np.zeros(G, dtype=bool)
    if len(idx) > 0:
        refit_block = _refit_block_size(X.shape[0])
        tile, packed, tile_mask = _gather_refit_tile(counts_dev, out["exceeds_packed"], idx, refit_block)
        r = refit_pipeline_streamed(
            tile, packed, tile_mask, out["size_factors"], X, contrast, lfc_null, out["trend_coeffs"],
            out["trend_used_mean"], out["mean_disp"], out["prior_disp_var"], out["squared_logres"],
            refit_block=refit_block, replaceable=host["replaceable"], alt_hypothesis=knobs.get("alt_hypothesis"),
            min_mu=knobs.get("min_mu", 0.5), min_disp=knobs.get("min_disp", 1e-8),
            max_disp=knobs.get("max_disp", 10.0), beta_tol=knobs.get("beta_tol", 1e-8),
            mu_init=knobs.get("mu_init", "linear"),
        )
        rnp = {k: v[:len(idx)] if v.ndim >= 1 else v for k, v in _to_host(r).items()}
        refitted, new_all_zero = _merge_refit(res, rnp, idx, G)
    res["refitted"] = refitted
    res["new_all_zeroes"] = new_all_zero
    outlier = np.where(refitted, res.pop("cooks_outlier_refit"), res["cooks_outlier"])
    res["cooks_outlier"] = outlier
    p = np.array(res["p_values"])
    if knobs.get("cooks_filter", True):
        p[outlier] = np.nan
        res["p_values"] = p
    dev = counts_dev.device
    res["padj"] = _padj_program(
        torch.as_tensor(p, device=dev), torch.as_tensor(res["base_mean"].astype(p.dtype), device=dev),
        torch.ones(G, dtype=torch.bool, device=dev), knobs.get("alpha", 0.05),
        knobs.get("independent_filter", True),
    ).cpu().numpy()
    return res


def run_summary_streamed(
    counts,
    design_matrix,
    contrast,
    lfc_null: float = 0.0,
    gene_block: int | None = None,
    dtype=np.float32,
    refit_cooks: bool = False,
    min_replicates: int = 7,
    n_genes: int | None = None,
    device: str | torch.device = "cuda",
    **knobs,
) -> dict:
    """Counts -> padj on ``device`` (default ``"cuda"``; raises if CUDA is
    requested and absent), streamed over gene blocks, with the Cook's
    outlier replacement and refit of R DESeq2's default pipeline when
    ``refit_cooks``. Port of ``pydeseq2_tpu/fused_stream.py:783``: the same
    arguments, and the same keys as numpy.

    counts (G, N) gene-major raw counts, a numpy array or a tensor (kept on
    its device when that is ``device``); design_matrix (N, P) array or
    DataFrame (cohorts come from its rows); contrast (P,); lfc_null in
    natural log; ``dtype`` a numpy or torch float dtype. ``gene_block=None``
    splits G evenly into blocks whose ~20 live (block, N) temporaries fit
    ~4 GB, rounded up to 8; the size-factor medians go over 1024-sample
    blocks once counts pass 1 GB. ``n_genes`` is the number of leading real
    genes of pre-padded counts. ``refit_cooks`` runs the main pass in refit
    mode, gathers the flagged genes on the device, refits them
    (:func:`refit_pipeline_streamed`), merges, masks and adjusts; it adds
    ``replaced``, ``refitted`` and ``new_all_zeroes``. ``min_replicates``
    is the cohort size from which a sample is replaceable. ``knobs`` go to
    :func:`summary_pipeline_streamed`.

    Where ratio size factors are asked for and every gene has a zero
    (median-of-ratios is undefined), it warns and switches to the iterative
    size factors, as with ``sf_fit_type="iterative"``
    (:func:`~pydeseq2_tpu_torch.ops.sizefactors.iterative_size_factors` on
    the device-resident counts, its dispersion fits over gene blocks past 1
    GB of counts); their result is injected as ``size_factors``.
    """
    dev = resolve_device(device)
    counts, G, gene_block = _stage_counts(counts, dtype, n_genes, gene_block, dev)
    padded_G, N = counts.shape
    np_dtype = _NP_DTYPE[counts.dtype]
    sf_req = knobs.get("sf_fit_type", "ratio")
    if knobs.get("size_factors") is None and sf_req in ("ratio", "iterative"):
        # Host-evaluated: does any gene have no zero (median-of-ratios defined)?
        ratio_undefined = sf_req == "ratio" and not bool((counts > 0).all(dim=1).any())
        if sf_req == "iterative" or ratio_undefined:
            if ratio_undefined:
                warnings.warn(
                    "Every gene contains at least one zero, cannot compute log geometric means. Switching to "
                    "iterative mode.",
                    UserWarning,
                    stacklevel=2,
                )
            # The iterative solver's own max_disp default is max(10, N),
            # not the pipeline's (fused_stream.py:871).
            knobs["size_factors"], _ = iterative_size_factors(
                counts, torch.arange(padded_G, device=dev) < G, min_disp=knobs.get("min_disp", 1e-8),
                max_disp=knobs.get("max_disp", float(max(10, N))), min_mu=knobs.get("min_mu", 0.5),
                gene_block=pick_sf_gene_block(padded_G, N, counts.dtype), device=dev)
            knobs["sf_fit_type"] = "ratio"  # unused once the factors are injected
    if isinstance(design_matrix, torch.Tensor):
        design_matrix = _host(design_matrix)
    host = summary_host_inputs(design_matrix, min_replicates)
    gene_mask = torch.arange(padded_G, device=dev) < G

    knobs.setdefault("mu_init", host["mu_init"])
    if "sample_block" not in knobs and G * N * np.dtype(np_dtype).itemsize > 1_000_000_000:
        knobs["sample_block"] = min(N, 1024)
    if isinstance(knobs.get("size_factors"), torch.Tensor):
        knobs["size_factors"] = knobs["size_factors"].to(device=dev, dtype=counts.dtype)
    elif knobs.get("size_factors") is not None:
        knobs["size_factors"] = torch.tensor(_host(knobs["size_factors"], np_dtype), device=dev)
    # Refitting runs only when some cohort can absorb a replacement
    # (reference dds.py:1315-1320: no replaceable sample, no refit).
    refit_active = refit_cooks and any(host["replaceable"])
    if refit_active:
        if not knobs.get("stats_layer", True):
            raise ValueError("refit_cooks needs the stats layer (Cook's flags)")
        knobs["refit_mode"] = True
        knobs["replaceable"] = host["replaceable"]

    def on_dev(a):
        return torch.tensor(np.asarray(a, np_dtype), device=dev)  # a copy: pandas arrays may be read-only

    X = on_dev(getattr(design_matrix, "values", design_matrix))  # a DataFrame's array
    contrast_t, lfc_null_t = on_dev(contrast), on_dev(lfc_null)
    out = summary_pipeline_streamed(
        counts, X, contrast_t, lfc_null_t, on_dev(host["cooks_cutoff"]), gene_mask, gene_block=gene_block,
        cohort_ids=host["cohort_ids"], use_for_max=host["use_for_max"], **knobs)
    # exceeds_packed stays on the device for the refit gather; the rest
    # comes to the host in one copy.
    res = _to_host({k: v for k, v in out.items() if k != "exceeds_packed"})
    res = {k: v[:G] if k != "size_factors" and v.ndim >= 1 and v.shape[0] == padded_G else v
           for k, v in res.items()}
    if refit_active:
        res = _apply_streamed_refit(res, out, counts, X, contrast_t, lfc_null_t, host, knobs, G)
    elif refit_cooks:
        for k in ("replaced", "refitted", "new_all_zeroes"):
            res[k] = np.zeros(G, dtype=bool)
    res["gene_block"] = gene_block
    if int(res.get("rescue_overflow", 0)) > 0:
        warnings.warn(
            f"{int(res['rescue_overflow'])} IRLS lanes still unconverged after the full 250-trip budget "
            "exceeded the compacted rescue tile: they skipped the Newton/grid rescue tiers and kept their "
            "final IRLS iterate (converged=False). This only happens when >~1.5% of genes fail to converge "
            "in IRLS.",
            UserWarning,
            stacklevel=2,
        )
    return res


# ----------------------------------------------------------- apeGLM shrinkage
def _grid_tile(c, s, m, conv, offset, X, prior_scale, pns, shrink_index):
    """The grid rescue's tile of a block (fused_stream.py:1031-1045): K =
    min(B, max(256, B/64)) lanes, failed lanes first (a stable sort keeps
    ascending lane order among ties). Returns ``(idx, counts, size,
    objective scale at 0, sel)``, ``sel`` marking the failed valid lanes."""
    B, P = c.shape[0], X.shape[1]
    K = min(B, max(256, B // 64))
    idx = torch.argsort(conv.to(torch.int8), stable=True)[:K]
    ci, si = c[idx], s[idx]
    zeros = torch.zeros((K, P), dtype=c.dtype, device=c.device)
    cnst = torch.clamp(nbinom_fn_batch(zeros, X, ci, si, offset, pns, prior_scale, shrink_index), min=1.0)
    return idx, ci, si, cnst, ~conv[idx] & m[idx]


def _shrink_block(c, s, m, offset, X, prior_scale, pns, shrink_index):
    """One gene block: Newton MAP fit, then for P == 2 the grid on the
    failed lanes of a compacted tile (fused_stream.py:1023-1072)."""
    beta, ih, conv = nbinom_glm_batch(X, c, s, offset, pns, prior_scale, shrink_index=shrink_index)
    # Host-evaluated lax.cond (fused_stream.py:1063-1065).
    if X.shape[1] == 2 and bool((~conv & m).any()):
        idx, ci, si, cnst, sel = _grid_tile(c, s, m, conv, offset, X, prior_scale, pns, shrink_index)
        b_grid = grid_fit_shrink_beta_batch(ci, offset, X, si, pns, prior_scale, cnst,
                                            shrink_index=shrink_index, sel=sel)
        new_b = torch.where(sel[:, None], b_grid, beta[idx])
        ih_g = sym_inv(_hess(new_b, X, ci, si, offset, pns, prior_scale, shrink_index))
        beta, ih = beta.clone(), ih.clone()
        beta[idx] = new_b
        ih[idx] = torch.where(sel[:, None, None], ih_g, ih[idx])
    se = torch.sqrt(torch.abs(ih[:, shrink_index, shrink_index]))
    nan = torch.tensor(float("nan"), dtype=c.dtype, device=c.device)
    return {"lfc": torch.where(m[:, None], beta, nan), "se": torch.where(m, se, nan), "converged": conv}


def lfc_shrink_pipeline_streamed(
    counts: torch.Tensor,
    size: torch.Tensor,
    offset: torch.Tensor,
    design_matrix: torch.Tensor,
    prior_scale: float,
    gene_mask: torch.Tensor,
    *,
    gene_block: int = 8192,
    shrink_index: int = 1,
    prior_no_shrink_scale: float = 15.0,
) -> dict:
    """apeGLM MAP shrinkage streamed over gene blocks, on the device of
    ``counts``.

    counts (G, N) gene-major raw counts, G a multiple of ``gene_block``;
    size (G,) NB size = 1/dispersion; offset (N,) log size factors;
    prior_scale min(sqrt(prior_var), 1); gene_mask (G,) bool. Returns
    ``lfc`` (G, P) MAP coefficients (natural log), ``se`` (G,) posterior SD
    of the shrunk coefficient and ``converged`` (G,), Newton's flag even
    where the grid replaced the coefficients. CUDA tensors launch the
    ``shrink`` and ``grid_apeglm`` kernels. Contract:
    ``pydeseq2_tpu/fused_stream.py:975``.
    """
    G = counts.shape[0]
    if G % gene_block:
        raise ValueError(f"pad G={G} to a multiple of gene_block={gene_block}")
    blocks = [
        _shrink_block(counts[b:b + gene_block], size[b:b + gene_block], gene_mask[b:b + gene_block], offset,
                      design_matrix, prior_scale, prior_no_shrink_scale, shrink_index)
        for b in range(0, G, gene_block)
    ]
    return {k: torch.cat([blk[k] for blk in blocks]) for k in blocks[0]}


def _host(a, dtype=None) -> np.ndarray:
    """A host numpy copy of an array or tensor."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, dtype=dtype)


def run_lfc_shrink_streamed(
    counts,
    design_matrix,
    coeff_idx: int,
    dispersions,
    size_factors,
    mle_lfc=None,
    mle_se=None,
    adapt: bool = True,
    gene_block: int | None = None,
    dtype=torch.float32,
    prior_no_shrink_scale: float = 15.0,
    n_genes: int | None = None,
    device: str | torch.device = "cuda",
) -> dict:
    """Host wrapper: apeGLM-shrink coefficient ``coeff_idx`` on ``device``
    (default ``"cuda"``; raises if CUDA is requested and absent).

    Feed it the outputs of ``summary_pipeline``: ``dispersions``,
    ``size_factors`` and, with ``adapt``, the MLE ``lfc`` column and ``se``
    that the adaptive prior variance is fitted from on the host (reference
    pydeseq2/ds.py:384-397). Arrays or tensors; ``dtype`` is a torch or
    numpy float dtype. ``n_genes`` is the number of leading valid lanes when
    ``counts`` was pre-padded. Genes with NaN dispersions return NaN.
    Returns numpy ``lfc`` (G, P), ``se``, ``converged``, plus
    ``prior_scale`` and ``gene_block``. Port of
    ``pydeseq2_tpu/fused_stream.py:1085``.
    """
    dev = resolve_device(device)
    counts, G, gene_block = _stage_counts(counts, dtype, n_genes, gene_block, dev)
    padded_G = counts.shape[0]
    np_dtype = _NP_DTYPE[counts.dtype]
    if not isinstance(design_matrix, torch.Tensor):
        design_matrix = getattr(design_matrix, "values", design_matrix)  # a DataFrame's array
    design = _host(design_matrix, np_dtype)
    prior_scale = 1.0
    if adapt:
        if mle_lfc is None or mle_se is None:
            raise ValueError("adapt=True needs mle_lfc and mle_se")
        prior_var = _apeglm_prior_variance(_host(mle_lfc, float), _host(mle_se, float))
        prior_scale = min(float(np.sqrt(prior_var)), 1.0)
    gene_mask = np.arange(padded_G) < G

    disp = _host(dispersions, np_dtype)
    ok = np.isfinite(disp) & (disp > 0)
    size = np.ones(padded_G, dtype=np_dtype)
    size[:G][ok] = 1.0 / disp[ok]
    gene_mask = gene_mask & np.pad(ok, (0, padded_G - G))

    def on_dev(a):
        return torch.tensor(a, device=dev)  # a copy: pandas arrays may be read-only

    out = lfc_shrink_pipeline_streamed(
        counts,
        on_dev(size),
        on_dev(np.log(_host(size_factors, np_dtype))),
        on_dev(design),
        prior_scale,
        on_dev(gene_mask),
        gene_block=gene_block,
        shrink_index=int(coeff_idx),
        prior_no_shrink_scale=prior_no_shrink_scale,
    )
    res = {k: v[:G].cpu().numpy() for k, v in out.items()}
    res["prior_scale"] = prior_scale
    res["gene_block"] = gene_block
    return res


# -------------------------------------------------------------- blind VST
def _vst_genewise_pass(counts, sf, X, pinv, gene_block, min_mu, min_disp, max_disp):
    """Streamed pass 1 of the VST: per block, base means and the genewise
    dispersion MLE at mu = max(sf base_mean, min_mu) (``fused_stream.py:
    1224-1239``; not the OLS mu)."""
    base_mean, genewise = [], []
    for b in range(0, counts.shape[0], gene_block):
        c = counts[b:b + gene_block]
        bm = (c / sf[None, :]).mean(dim=1)
        rough, moments, _, _ = mom_and_mu_coef(c, sf, X, pinv, min_mu, want_mu=False)
        mom = torch.clamp(torch.minimum(rough, moments), min_disp, max_disp)
        mu_hat = torch.clamp(sf[None, :] * bm[:, None], min=min_mu)
        gw, _ = alpha_mle_batch(c, X, mu_hat, mom, min_disp, max_disp, cr_reg=True, prior_reg=False)
        base_mean.append(bm)
        genewise.append(torch.clamp(gw, min_disp, max_disp))
    return torch.cat(base_mean), torch.cat(genewise)


def vst_pipeline_streamed(
    counts: torch.Tensor,
    gene_mask: torch.Tensor | None = None,
    *,
    gene_block: int = 8192,
    sample_block: int | None = None,
    min_mu: float = 0.5,
    min_disp: float = 1e-8,
    max_disp: float = 10.0,
    trend_type: str = "parametric",
) -> dict:
    """Blind variance-stabilising transform streamed over gene blocks, on
    the device of ``counts`` (G, N), G a multiple of ``gene_block``.

    Port of ``pydeseq2_tpu/fused_stream.py:1184``: the log-stats sweep,
    median-of-ratios size factors (over ``sample_block`` columns at a
    time), the genewise dispersions per block (:func:`_vst_genewise_pass`),
    one trend, then the transform per block (the ``vst`` kernel) into one
    (G, N) output. Returns tensors: ``vst_counts``, ``size_factors``,
    ``base_mean``, ``genewise_dispersions``, ``mean_disp`` and, for the
    parametric trend, ``trend_coeffs`` and ``trend_used_mean``.
    """
    G, N = counts.shape
    if gene_mask is None:
        gene_mask = torch.ones(G, dtype=torch.bool, device=counts.device)
    if G % gene_block:
        raise ValueError(f"pad G={G} to a multiple of gene_block={gene_block}")
    X = torch.ones((N, 1), dtype=counts.dtype, device=counts.device)

    logmeans, non_zero = _log_stats(counts, gene_mask, gene_block, "ratio")
    sf = _streamed_size_factors(counts, gene_mask, logmeans, sample_block)
    base_mean, genewise = _vst_genewise_pass(counts, sf, X, ols_pinv(X), gene_block, min_mu, min_disp, max_disp)
    genewise_m = torch.where(non_zero, genewise, torch.full_like(genewise, float("nan")))
    _, coeffs, used_mean, mean_disp = fit_fused_trend(base_mean, genewise_m, non_zero, min_disp, trend_type)

    vst = torch.empty_like(counts)
    for b in range(0, G, gene_block):
        sl = slice(b, b + gene_block)
        vst[sl] = vst_transform(counts[sl], sf, coeffs, used_mean, mean_disp, gene_mask[sl], trend_type)
    out = {"vst_counts": vst, "size_factors": sf, "base_mean": base_mean, "genewise_dispersions": genewise_m,
           "mean_disp": mean_disp}
    if trend_type == "parametric":
        out["trend_coeffs"] = coeffs
        out["trend_used_mean"] = used_mean
    return out


def run_vst_streamed(
    counts,
    gene_block: int | None = None,
    dtype=np.float32,
    n_genes: int | None = None,
    device: str | torch.device = "cuda",
    **knobs,
) -> dict:
    """Blind VST on ``device`` (default ``"cuda"``; raises if CUDA is
    requested and absent), streamed over gene blocks. Port of
    ``pydeseq2_tpu/fused_stream.py:1285``: the same arguments, and the same
    keys as numpy, plus ``gene_block``.

    counts (G, N) gene-major raw counts, a numpy array or a tensor (kept on
    its device when that is ``device``); ``dtype`` a numpy or torch float
    dtype; ``gene_block=None`` picks the streamed summary's even split;
    ``n_genes`` is the number of leading real genes of pre-padded counts;
    the size-factor medians go over 1024-sample blocks once counts pass 1
    GB. ``knobs`` go to :func:`vst_pipeline_streamed`. Every output comes to
    the host in one copy.
    """
    dev = resolve_device(device)
    counts, G, gene_block = _stage_counts(counts, dtype, n_genes, gene_block, dev)
    padded_G, N = counts.shape
    if "sample_block" not in knobs and G * N * counts.element_size() > 1_000_000_000:
        knobs["sample_block"] = min(N, 1024)
    out = vst_pipeline_streamed(counts, torch.arange(padded_G, device=dev) < G, gene_block=gene_block, **knobs)
    res = {k: v[:G] if k != "size_factors" and v.ndim >= 1 and v.shape[0] == padded_G else v
           for k, v in _to_host(out).items()}
    res["gene_block"] = gene_block
    return res
