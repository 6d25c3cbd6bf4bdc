"""The stage helpers of the port's DESeq2 pipelines.

Ported from ``pydeseq2_tpu/fused.py``: what the per-tile passes of
:mod:`~pydeseq2_tpu_torch.fused_stream` and the class API's backend
(:mod:`~pydeseq2_tpu_torch.torch_inference`) share. IRLS with its rescue
tiers (:func:`_irls_with_rescue`); the dispersion trend with the mean
fallback and the prior over the whole gene axis (:func:`fit_fused_trend`,
:func:`_trend_prior`); the per-column median of the size factors
(:func:`_column_median`); the adjusted p-values (:func:`device_padj`,
:func:`_padj`); and the design's host inputs (:func:`summary_host_inputs`).
With ``mesh`` the global ones run over every rank's genes. PyTorch runs
eagerly, so the ``lax.cond``/``lax.switch``/``while_loop`` conditions of
the JAX program become Python branches on values read from the device;
each such read is marked where it happens. ``device_padj`` makes none.

Every pipeline, ``wald_pipeline``, ``summary_pipeline`` and
``vst_pipeline`` on one tile included, is in
:mod:`~pydeseq2_tpu_torch.fused_stream`; the kernels' wrappers and the
shrinkage step (:func:`~pydeseq2_tpu_torch.ops.dispersion.dispersion_prior`,
:func:`~pydeseq2_tpu_torch.ops.dispersion.map_dispersions`) are in ``ops/``.
"""

from __future__ import annotations

import torch

from pydeseq2_tpu_torch import kernels
from pydeseq2_tpu_torch.parallel.mesh import all_reduce_sum, gather_gene_dict, local_rows
from pydeseq2_tpu_torch.ops.dispersion import dispersion_prior
from pydeseq2_tpu_torch.ops.irls import (
    _linspace,
    grid_fit_beta_batch,
    irls_core,
    newton_box_nbglm,
)
from pydeseq2_tpu_torch.ops.select import masked_median_select, sharded_masked_median
from pydeseq2_tpu_torch.ops.stats import (
    bh_adjust_row,
    bh_rejections,
    lowess_pick,
    nanquantile,
    trimmed_mean_masked,
)
from pydeseq2_tpu_torch.ops.trend import parametric_trend
from pydeseq2_tpu_torch.tracing import read, traced


@traced("deseq2.irls")
def _irls_with_rescue(counts, size_factors, design_matrix, disp, beta_init, min_mu, beta_tol, phase1_iters=8,
                      group=None):
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

    The lanes that the phase-2 continuation and the grid tier take, counts
    the host already reads, add to ``kernels.STATS.rescue_lanes``.

    ``group`` (a :class:`~pydeseq2_tpu_torch.parallel.mesh.LaneGroup`)
    makes these lanes one rank's share of a tile split over ranks: K comes
    from the whole tile, the unfinished count that picks the phase-2 form
    is the tile's, and the rescue takes the tile's first K flagged lanes in
    lane order, so this rank rescues at most K less the flagged lanes of
    the ranks before it. Two exchanges of one integer a rank, reached
    whatever the data; ``overflow`` is then this rank's share.
    """
    X = design_matrix
    beta, needs_fb, converged = irls_core(
        counts, size_factors, X, disp, beta_init,
        min_mu=min_mu, beta_tol=beta_tol, maxiter=phase1_iters,
    )
    G = counts.shape[0]
    dev = counts.device
    lanes = G if group is None else group.lanes
    if group is not None:  # padding lanes are never flagged
        needs_fb = needs_fb & (torch.arange(G, device=dev) + group.offset(G) < lanes)
    K = min(lanes, max(512, lanes // 64))
    T = min(G, K)  # this rank's share of the compacted tile
    # Flagged lanes first; ties keep ascending lane order (stable sort).
    idx1 = torch.argsort((~needs_fb).to(torch.int8), stable=True)[:T]

    # Host-evaluated lax.switch branch (fused.py:154-160); with
    # phase1_iters = 250 (one phase, as the class API's backend runs it)
    # there is nothing to continue.
    n_unfinished = 0
    if phase1_iters < 250:  # the tile's count: with a group, one exchange
        with read("irls_unfinished"):
            n_unfinished = int(needs_fb.sum()) if group is None else sum(group.counts(needs_fb.sum()))
    if n_unfinished > 0:
        kernels.STATS.rescue_lanes["phase2"] += n_unfinished
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

    if group is None:
        quota = K  # the tile holds the first K flagged lanes
        overflow = torch.clamp(needs_fb.sum() - K, min=0)
        # Host-evaluated lax.cond (fused.py:183-185).
        with read("irls_rescue_any"):
            rescue = bool(needs_fb.any())
    else:
        # The tile's first K flagged lanes: this rank's first `quota`.
        with read("irls_rescue_any"):
            flagged = group.counts(needs_fb.sum())
        pos = group.position()
        quota = min(flagged[pos], max(0, K - sum(flagged[:pos])))
        overflow = torch.tensor(flagged[pos] - quota, dtype=torch.int64, device=dev)
        rescue = quota > 0
    idx = torch.argsort((~needs_fb).to(torch.int8), stable=True)[:T]
    in_quota = torch.arange(T, device=dev) < quota
    sel = needs_fb[idx] & in_quota
    if rescue:
        b_fb, ok = newton_box_nbglm(
            counts[idx], size_factors, X, disp[idx], beta_init[idx], min_mu=min_mu, sel=sel
        )
        beta, converged = beta.clone(), converged.clone()
        beta[idx] = torch.where(sel[:, None], b_fb, beta[idx])
        converged[idx] = torch.where(sel, ok, converged[idx])

    if X.shape[1] == 2:
        still_bad = needs_fb & ~converged
        sel_grid = still_bad[idx] & in_quota
        # Host-evaluated lax.cond (fused.py:206-208); the count it reads
        # sizes the grid kernel's launch.
        with read("irls_grid_count"):
            n_bad = int(still_bad.sum())
        if n_bad:
            kernels.STATS.rescue_lanes["grid"] += n_bad
            b_grid = grid_fit_beta_batch(counts[idx], size_factors, X, disp[idx], min_mu=min_mu, sel=sel_grid,
                                         n_sel=n_bad)
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


def _column_median(values: torch.Tensor, n_valid: torch.Tensor, mesh=None) -> torch.Tensor:
    """Per-column median over the genes of a (G, N) tile (+inf where
    excluded, ``n_valid`` the local counts of valid genes): the ``select``
    kernel, or with ``mesh`` the radix passes whose histograms and counts
    are summed over the ranks."""
    if mesh is None:
        return masked_median_select(values, n_valid, axis=0)
    n_all = all_reduce_sum(n_valid.reshape(-1).clone(), mesh).reshape(n_valid.shape)
    return sharded_masked_median(values, n_all, mesh, axis=0)


def _trend_prior(base_mean, genewise_m, non_zero, min_disp, trend_type, max_rounds, N, P, mesh=None):
    """The trend (:func:`fit_fused_trend`) and the prior
    (:func:`dispersion_prior`): ``(fitted_m, coeffs, used_mean, mean_disp,
    squared_logres, prior_disp_var)``, ``fitted_m`` NaN off ``non_zero``.
    With ``mesh`` the three per-gene vectors are gathered whole (one
    collective), every rank fits the same trend and prior on them, and
    keeps its rows of ``fitted_m``."""
    if mesh is not None:
        whole = gather_gene_dict({"b": base_mean, "g": genewise_m, "z": non_zero}, mesh)
        base_mean, genewise_m, non_zero = whole["b"], whole["g"], whole["z"]
    fitted, coeffs, used_mean, mean_disp = fit_fused_trend(base_mean, genewise_m, non_zero, min_disp, trend_type,
                                                           max_rounds=max_rounds)
    fitted_m = torch.where(non_zero, fitted, torch.full_like(fitted, float("nan")))
    squared_logres, prior_disp_var = dispersion_prior(genewise_m, fitted_m, non_zero, min_disp, N, P)
    if mesh is not None:
        fitted_m = local_rows(fitted_m, mesh)
    return fitted_m, coeffs, used_mean, mean_disp, squared_logres, prior_disp_var


def _padj(p, base_mean, gene_mask, alpha, independent_filter, mesh=None):
    """:func:`device_padj`; with ``mesh`` on the gathered p-values, base
    means and mask (one collective), whole on every rank, which keeps its
    rows."""
    if mesh is None:
        return device_padj(p, base_mean, gene_mask, alpha, independent_filter)
    whole = gather_gene_dict({"p": p, "b": base_mean, "m": gene_mask}, mesh)
    return local_rows(device_padj(whole["p"], whole["b"], whole["m"], alpha, independent_filter), mesh)


def device_padj(
    p: torch.Tensor,
    base_mean: torch.Tensor,
    gene_mask: torch.Tensor,
    alpha: float,
    independent_filter: bool,
) -> torch.Tensor:
    """Adjusted p-values (G,), float64: BH over the valid genes, or
    independent filtering, on the device with no host read.

    Independent filtering (reference pydeseq2/ds.py:486-542) counts the
    rejections at 50 base-mean cutoffs over one shared order of the
    p-values (one launch of the ``bh_count`` kernel), fits a lowess through
    the counts and picks the first cutoff whose count clears the fit's
    maximum less its residual RMS (one launch of the ``lowess`` kernel),
    then adjusts that one row (one launch of ``bh_adjust``, which reads the
    pick on the card); no (50, G) matrix is made. Port of
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
        return bh_adjust_row(p_filled, order, valid)

    base_m = torch.where(gene_mask, base_mean, nan)
    # int / int is float64 in JAX under x64; torch would give float32.
    n_zero = ((base_m == 0) & gene_mask).sum().to(torch.float64)
    lower_q = (n_zero / torch.clamp(gene_mask.sum(), min=1).to(torch.float64)).to(dtype)
    upper_q = torch.where(
        lower_q < 0.95, torch.tensor(0.95, dtype=dtype, device=dev), torch.tensor(1.0, dtype=dtype, device=dev)
    )
    theta = lower_q + (upper_q - lower_q) * _linspace(0.0, 1.0, 50, dtype, dev)
    cutoffs = nanquantile(base_m, theta)
    num_rej = bh_rejections(p_filled, order, valid, base_mean, cutoffs, alpha)  # (50,)
    _, j = lowess_pick(theta, num_rej, frac=1.0 / 5.0)
    return bh_adjust_row(p_filled, order, valid, base_mean, cutoffs, j)


@traced("deseq2.host_inputs")
def summary_host_inputs(design_matrix, min_replicates: int = 7) -> dict:
    """Host-side, design-only inputs of :func:`summary_pipeline`.

    From the design matrix (an array, a DataFrame or a tensor on the host):
    the F(0.99, P, N - P) Cook's cutoff (scipy, reference
    pydeseq2/dds.py:1080), the ``use_for_max`` mask of samples in
    >= 3-replicate cohorts (reference pydeseq2/utils.py:888-911), the cohort
    ids of those samples in sorted-row order (``groupby(columns).ngroup()``;
    None when there are none), the ``replaceable`` mask of
    >= ``min_replicates``-replicate samples, and the ``mu_init`` mode
    ("linear" when the design rows group 1:1 onto its columns, else
    "irls"). Port of ``pydeseq2_tpu/fused.py:772``, with one lexicographic
    sort of the rows in place of pandas' per-row tuples.
    """
    import numpy as np
    from scipy.stats import f

    X = np.asarray(design_matrix, dtype=np.float64)
    n, p = X.shape
    # Sort the rows once, first column as the primary key (lexsort's last):
    # a cohort is a run of equal rows, -0.0 and 0.0 alike.
    order = np.lexsort(X.T[::-1])
    ordered = X[order]
    starts = np.flatnonzero(np.r_[True, (ordered[1:] != ordered[:-1]).any(axis=1)])
    sizes = np.diff(np.r_[starts, n])
    cohort = np.empty(n, dtype=np.intp)
    cohort[order] = np.repeat(np.arange(len(starts)), sizes)
    three_or_more = (sizes >= 3)[cohort]
    if three_or_more.any():
        # ngroup over the kept rows: the kept cohorts renumbered in sorted order.
        renumber = np.cumsum(sizes >= 3) - 1
        cohort_ids = tuple(renumber[cohort[three_or_more]].tolist())
    else:
        cohort_ids = None
    return {
        "cooks_cutoff": float(f.ppf(0.99, p, n - p)),
        "use_for_max": tuple(three_or_more.tolist()),
        "cohort_ids": cohort_ids,
        "replaceable": tuple((sizes >= min_replicates)[cohort].tolist()),
        "mu_init": "linear" if len(starts) == p else "irls",
    }
