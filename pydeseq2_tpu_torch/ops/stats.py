"""Robust statistics of the Wald slice: the masked trimmed mean and a
NaN-aware median.

Port of the parts of ``pydeseq2_tpu/ops/stats.py`` the Wald pipeline uses.
"""

from __future__ import annotations

import torch

from pydeseq2_tpu_torch.ops.select import masked_median_select


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
