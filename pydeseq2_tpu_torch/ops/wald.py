"""Batched Wald tests for NB GLM contrasts.

Port of ``pydeseq2_tpu/ops/wald.py:wald_test_batch`` (reference
pydeseq2/utils.py:718-811): covariance, SE, statistic and p-values for all
four alternative hypotheses, in plain PyTorch.
"""

from __future__ import annotations

import torch

from pydeseq2_tpu_torch.ops.smalllinalg import sym_inv, weighted_gram


def norm_sf(x: torch.Tensor) -> torch.Tensor:
    """Standard normal survival function via erfc."""
    return 0.5 * torch.special.erfc(x / torch.sqrt(torch.tensor(2.0, dtype=x.dtype, device=x.device)))


def wald_test_batch(
    design_matrix: torch.Tensor,
    disp: torch.Tensor,
    lfc: torch.Tensor,
    mu: torch.Tensor,
    ridge_factor: torch.Tensor,
    contrast: torch.Tensor,
    lfc_null: torch.Tensor | float,
    alt_hypothesis: str | None = None,
):
    """``(p_values, statistics, se)``, three (G,) tensors.

    lfc (G, P) natural-log coefficients, mu (G, N), ridge_factor (P, P),
    contrast (P,), lfc_null a natural-log scalar; ``alt_hypothesis`` one of
    None, "greaterAbs", "lessAbs", "greater", "less".
    """
    X = design_matrix
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

