"""The plain DESeq2 refit route on zero-inflated counts, which decides a
run's ``correct`` where every gene has a zero.

Median-of-ratios is undefined there; the port warns and switches to the
iterative size factors (PyDESeq2 0.5.3 ``dds.py:682-690``, the solver
``:1460-1548``; R DESeq2's ``estimateSizeFactors(type = "iterate")``), then
runs the refit route with those factors. This file holds a frozen copy of
the plain PyTorch path of the port's ``ops/sizefactors.py`` (the trimmed
NLL, the guarded Newton steps, the keep quantile and the rounds), taken as
it stood when the cell was written, and the refit route of
``dea_bench.reference.deseq2`` with the size factors given. Every other step
is imported from there, so the arithmetic is the port's plain path's,
summed in the same order and rounded at the same points.

Imports torch, numpy, pandas and scipy; nothing of the program and nothing
of JAX.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from dea_bench.reference.deseq2 import (
    _BLOCK_BUDGET_BYTES,
    _REFIT_COLUMNS,
    _analyse_pass,
    _auto_gene_block,
    _fma,
    _genewise_pass,
    _log_stats,
    _refit_block_size,
    _to_host,
    alpha_mle_batch,
    device_padj,
    dispersion_prior,
    fit_fused_trend,
    mom_and_mu_coef,
    mu_from_coef,
    nb_nll_terms,
    ols_pinv,
    order_stats_select,
    refit_tile,
    summary_host_inputs,
    trimmed_mean_masked,
)

# ------------------------------------------------------------ ops.sizefactors
# Outer rounds of the trimmed solve (a new keep set each) and Newton steps a round.
OUTER_ITERS = 6
NEWTON_ITERS = 8


def pick_sf_gene_block(G: int, N: int, dtype: torch.dtype) -> int | None:
    """None (whole G) up to 1 GB of counts, else blocks whose ~20 live
    (block, N) temporaries fit ~4 GB, split evenly and rounded up to 8."""
    itemsize = torch.finfo(dtype).bits // 8
    if G * N * itemsize <= 1_000_000_000:
        return None
    raw = int(max(1024, min(G, _BLOCK_BUDGET_BYTES // (20 * itemsize * N))))
    n_blocks = -(-G // raw)
    return ((-(-G // n_blocks) + 7) // 8) * 8


def _row_slices(G: int, gene_block: int | None) -> list[slice]:
    B = G if gene_block is None else max(1, min(int(gene_block), G))
    return [slice(b, b + B) for b in range(0, G, B)]


def _base_mu(coef, sf0, inv_sf0, min_mu):
    """Rows of max(sf0 coef, min_mu) / sf0."""
    return torch.clamp(sf0[None, :] * coef[:, None], min=min_mu) * inv_sf0[None, :]


def _sign(x: torch.Tensor) -> torch.Tensor:
    """The sign, NaN kept (``torch.sign`` gives 0)."""
    return torch.where(torch.isnan(x), x, torch.sign(x))


def _sf_nll_plain(counts, coef, sf0, inv_sf0, s, disp, mask, min_mu, gene_block=None):
    """(G,) NB NLL of each gene at log size factors ``s`` (+inf where
    ``mask`` is False), summed in float64 and rounded."""
    es = torch.exp(s)
    parts = []
    for sl in _row_slices(counts.shape[0], gene_block):
        mu = _base_mu(coef[sl], sf0, inv_sf0, min_mu) * es[None, :]
        parts.append(nb_nll_terms(counts[sl], mu, disp[sl]).sum(-1, dtype=torch.float64).to(counts.dtype))
    nll = torch.cat(parts)
    return torch.where(mask, nll, torch.full_like(nll, float("inf")))


def _sf_newton_plain(counts, coef, sf0, inv_sf0, s, disp, keep, min_mu, iters, gene_block=None):
    """``iters`` guarded Newton steps on the log size factors over the kept
    genes: per sample g = sum mu w - y and h = sum mu r w / (mu + r), w = (y +
    r) / (mu + r), in float64 then rounded, and s -= clip(h > 0 ? g / h :
    sign(g), -1, 1)."""
    dtype = counts.dtype
    slices = _row_slices(counts.shape[0], gene_block)
    for _ in range(iters):
        es = torch.exp(s)
        g = torch.zeros(s.shape, dtype=torch.float64, device=s.device)
        h = torch.zeros_like(g)
        for sl in slices:
            y = counts[sl]
            k = keep[sl][:, None]
            mu = _base_mu(coef[sl], sf0, inv_sf0, min_mu) * es[None, :]
            r = (1.0 / disp[sl])[:, None]
            w = (y + r) / (mu + r)
            g = g + torch.where(k, mu * w - y, 0.0).sum(0, dtype=torch.float64)
            h = h + torch.where(k, mu * r * w / (mu + r), 0.0).sum(0, dtype=torch.float64)
        g, h = g.to(dtype), h.to(dtype)
        step = torch.where(h > 0, g / h, _sign(g))
        s = s - torch.clamp(step, -1.0, 1.0)
    return s


def trim_quantile(nll: torch.Tensor, mask: torch.Tensor, quant: float) -> torch.Tensor:
    """The ``quant`` quantile (shape (1,)) of ``nll`` over the ``mask``
    lanes, linear between the order statistics at (n_valid - 1) quant, the
    interpolation rounded once as a fused multiply-add."""
    h = (mask.sum() - 1).to(nll.dtype) * quant
    lo = torch.floor(h)
    frac = h - lo
    last = nll.shape[0] - 1
    ranks = tuple(torch.clamp(k.to(torch.int64), 0, last) for k in (lo, torch.ceil(h)))
    s_lo, s_hi = order_stats_select(nll[:, None], ranks, axis=0)
    return _fma(s_lo, 1.0 - frac, s_hi * frac)


def keep_mask(nll: torch.Tensor, mask: torch.Tensor, quant: float) -> torch.Tensor:
    """The genes of ``mask`` strictly below :func:`trim_quantile`."""
    return (nll < trim_quantile(nll, mask, quant)) & mask


def _trimmed_sf_newton(counts, coef, disp, log_sf0, mask, quant, min_mu, outer_iters, newton_iters, gene_block):
    """``outer_iters`` rounds of a keep set below the NLL's ``quant``
    quantile and ``newton_iters`` Newton steps over it: ``(log_sf, keep)``."""
    sf0 = torch.exp(log_sf0)
    inv_sf0 = torch.exp(-log_sf0)
    s, keep = log_sf0, mask
    for _ in range(outer_iters):
        keep = keep_mask(_sf_nll_plain(counts, coef, sf0, inv_sf0, s, disp, mask, min_mu, gene_block), mask, quant)
        s = _sf_newton_plain(counts, coef, sf0, inv_sf0, s, disp, keep, min_mu, newton_iters, gene_block)
    return s, keep


def _iteration(counts, log_sf, non_zero, X, pinv, slices, quant, min_disp, max_disp, min_mu, gene_block):
    """One round: MoM and genewise dispersions, the constant trend, the MAD
    prior, MAP dispersions with the 2-sigma outlier rule, then the trimmed
    solve from ``log_sf``: ``(new log_sf, any_informative)``."""
    G, N = counts.shape
    sf = torch.exp(log_sf)
    genewise, coefs = [], []
    for sl in slices:
        c = counts[sl]
        rough, moments, coef, mu_hat = mom_and_mu_coef(c, sf, X, pinv, min_mu)
        mom = torch.clamp(torch.minimum(rough, moments), min_disp, max_disp)
        gw, _ = alpha_mle_batch(c, X, mu_hat, mom, min_disp, max_disp, cr_reg=True)
        genewise.append(torch.clamp(gw, min_disp, max_disp))
        coefs.append(coef[:, 0])
    genewise, coef = torch.cat(genewise), torch.cat(coefs)

    informative = (genewise > 10.0 * min_disp) & non_zero
    fitted = torch.clamp(trimmed_mean_masked(genewise, informative, 0.001), min=min_disp)
    squared_logres, prior_disp_var = dispersion_prior(genewise, fitted.expand(G), non_zero, min_disp, N, 1)
    outlier = torch.log(genewise) > torch.log(fitted) + 2.0 * torch.sqrt(squared_logres)

    map_disp = []
    for sl in slices:
        c = counts[sl]
        mu_hat = mu_from_coef(coef[sl, None], sf, X, min_mu)
        md, _ = alpha_mle_batch(c, X, mu_hat, fitted.expand(c.shape[0]), min_disp, max_disp,
                                prior_disp_var=prior_disp_var, cr_reg=True, prior_reg=True)
        map_disp.append(md)
    map_disp = torch.clamp(torch.cat(map_disp), min_disp, max_disp)
    disp = torch.where(outlier, genewise, map_disp)
    disp = torch.where(non_zero, disp, torch.ones_like(disp))  # masked lanes: any finite value

    raw, _ = _trimmed_sf_newton(counts, coef, disp, log_sf, non_zero, quant, min_mu, OUTER_ITERS, NEWTON_ITERS,
                                gene_block)
    return raw - raw.mean(), informative.any()


def iterative_size_factors(counts, gene_mask=None, niter: int = 10, quant: float = 0.95, min_disp: float = 1e-8,
                           max_disp: float = 10.0, min_mu: float = 0.5, gene_block: int | None = None):
    """Iterative size factors of (G, N) counts, on their device and in their
    dtype: ``(size_factors (N,), n_iters)``. Rounds under the intercept-only
    design from log size factors 0, each recentred to mean zero, until the
    squared update is below 1e-4 from the third round on, no gene is
    informative (genewise > 10 min_disp), or ``niter`` rounds. ``gene_mask``
    is False on padding lanes; ``gene_block`` runs the fits over row blocks."""
    G, N = counts.shape
    dtype, dev = counts.dtype, counts.device
    gene_mask = torch.ones(G, dtype=torch.bool, device=dev) if gene_mask is None else gene_mask
    X = torch.ones((N, 1), dtype=dtype, device=dev)
    pinv = ols_pinv(X)
    slices = _row_slices(G, gene_block)
    non_zero = torch.cat([(counts[sl] > 0).any(dim=1) for sl in slices]) & gene_mask
    log_sf = torch.zeros(N, dtype=dtype, device=dev)
    it = 0
    while it < niter:
        new_log_sf, any_informative = _iteration(counts, log_sf, non_zero, X, pinv, slices, quant, min_disp,
                                                 max_disp, min_mu, gene_block)
        delta = ((log_sf - new_log_sf) ** 2).sum()
        done = ~any_informative | ((delta < 1e-4) & (it > 1))
        log_sf = torch.where(any_informative, new_log_sf, log_sf)
        it += 1
        if bool(done):
            break
    return torch.exp(log_sf), it


# ------------------------------------------------------------ the refit route with given size factors
def _main_pass(counts, X, contrast, lfc_null, cooks_cutoff, gene_mask, sf, *, gene_block, cohort_ids, use_for_max,
               replaceable, min_mu, min_disp, max_disp, beta_tol, trend_type, alt_hypothesis, mu_init):
    """The main pass in refit mode at the size factors ``sf``: pass 1, trend
    and prior, pass 2; no padj (the caller merges the refit first)."""
    G, N = counts.shape
    P = X.shape[1]
    _, non_zero = _log_stats(counts, gene_mask, gene_block)
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


def iterative_refit_summary(counts, design_matrix, contrast, lfc_null: float = 0.0, min_replicates: int = 7,
                            alpha=0.05, cooks_filter=True, independent_filter=True, min_mu=0.5, min_disp=1e-8,
                            max_disp=10.0, beta_tol=1e-8, trend_type="parametric", alt_hypothesis=None,
                            tf32: bool = False) -> dict:
    """Counts in which every gene has a zero -> padj: the iterative size
    factors, then Cook's outlier replacement and refit, on the device and in
    the dtype of ``counts`` (G, N), gene-major. The arguments and result
    keys of :func:`dea_bench.reference.deseq2.refit_summary`; TF32 is off
    for the call, or on with ``tf32=True`` (the float32 control)."""
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
    if bool((counts[:G] > 0).all(dim=1).any()):
        raise ValueError("some gene has no zero: the ratio size factors are defined (refit_summary's route)")
    host = summary_host_inputs(design_matrix, min_replicates)
    if not any(host["replaceable"]):
        raise ValueError("no sample is replaceable: the refit route does not run")
    gene_mask = torch.arange(padded_G, device=dev) < G
    sf, _ = iterative_size_factors(counts, gene_mask, min_disp=min_disp, max_disp=max_disp, min_mu=min_mu,
                                   gene_block=pick_sf_gene_block(padded_G, N, dtype))

    def on_dev(a):
        return torch.tensor(np.asarray(a, dtype=np.float64), device=dev).to(dtype).contiguous()

    X = on_dev(getattr(design_matrix, "values", design_matrix))
    contrast_t, lfc_null_t = on_dev(contrast), on_dev(lfc_null)
    knobs = dict(min_mu=min_mu, min_disp=min_disp, max_disp=max_disp, beta_tol=beta_tol, mu_init=host["mu_init"])
    out = _main_pass(counts, X, contrast_t, lfc_null_t, on_dev(host["cooks_cutoff"]), gene_mask, sf,
                     gene_block=gene_block, cohort_ids=host["cohort_ids"], use_for_max=host["use_for_max"],
                     replaceable=host["replaceable"], trend_type=trend_type, alt_hypothesis=alt_hypothesis, **knobs)
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
                       sf, X, contrast_t, lfc_null_t, out["trend_coeffs"], out["trend_used_mean"],
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
