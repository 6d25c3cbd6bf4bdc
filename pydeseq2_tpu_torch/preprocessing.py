"""Median-of-ratios and poscounts normalisation as a fit/transform pair.

Port of ``pydeseq2_tpu/preprocessing.py`` (reference
pydeseq2/preprocessing.py:5-102). The per-sample medians run on the
``select`` kernel (``ops/select.py:masked_median_select``) for CUDA tensors.
The public functions take pandas DataFrames or arrays, run in float64 on
``device`` (default ``"cuda"``; raises if CUDA is requested and absent) and
return the reference's types; the ``*_t`` functions take and return
tensors, and ``models/dataset.py`` uses them to keep counts on the device.
"""

from __future__ import annotations

import numpy as np
import pandas as pd
import torch

from pydeseq2_tpu_torch.convert import resolve_device
from pydeseq2_tpu_torch.ops.select import masked_median_select


def _counts_t(counts, device) -> torch.Tensor:
    values = counts.to_numpy() if isinstance(counts, pd.DataFrame) else counts
    return torch.as_tensor(np.array(values, dtype=np.float64), device=resolve_device(device))


def norm_fit_t(x: torch.Tensor):
    """``(logmeans (G,), filtered_genes (G,))`` of (N, G) counts: genes with
    a zero have -inf log-mean and are left out of the medians."""
    logmeans = torch.log(x).mean(dim=0)
    return logmeans, ~torch.isinf(logmeans)


def norm_transform_t(x: torch.Tensor, logmeans: torch.Tensor, mask: torch.Tensor):
    """``(normed (N, G), size_factors (N,))``: each sample's median log
    ratio to the log-means over the genes of ``mask``."""
    log_ratios = torch.log(x[:, mask]) - logmeans[mask][None, :]
    log_medians = masked_median_select(log_ratios, log_ratios.shape[1], axis=1)
    size_factors = torch.exp(log_medians)
    return x / size_factors[:, None], size_factors


def poscounts_fit_t(x: torch.Tensor):
    """Log geometric means over the positive counts, divided by all N
    (DESeq2's poscounts, reference pydeseq2/dds.py:659-665), and the usable
    genes (finite and positive log-mean)."""
    pos = x > 0
    log_pos = torch.where(pos, torch.log(torch.where(pos, x, torch.ones_like(x))), torch.zeros_like(x))
    logmeans = log_pos.mean(dim=0)
    return logmeans, torch.isfinite(logmeans) & (logmeans > 0)


def poscounts_size_factors_t(x: torch.Tensor, logmeans: torch.Tensor, gene_mask: torch.Tensor) -> torch.Tensor:
    """Per-sample medians of the log ratios over the genes of ``gene_mask``
    that are positive in the sample (a ragged median: excluded entries are
    +inf, each row's count its own), rescaled to geometric mean 1."""
    in_median = gene_mask[None, :] & (x > 0)
    ratios = torch.where(
        in_median,
        torch.log(torch.where(x > 0, x, torch.ones_like(x))) - logmeans[None, :],
        torch.full_like(x, float("inf")),
    )
    sf = torch.exp(masked_median_select(ratios, in_median.sum(dim=1), axis=1))
    return sf / torch.exp(torch.mean(torch.log(sf)))


def deseq2_norm(counts, device: str | torch.device = "cuda"):
    """Normalised counts and size factors (median of ratios). Parity:
    reference pydeseq2/preprocessing.py:5-28."""
    logmeans, filtered_genes = deseq2_norm_fit(counts, device=device)
    return deseq2_norm_transform(counts, logmeans, filtered_genes, device=device)


def deseq2_norm_fit(counts, device: str | torch.device = "cuda"):
    """``(logmeans, filtered_genes)`` as numpy. Parity: reference
    pydeseq2/preprocessing.py:31-56."""
    logmeans, filtered = norm_fit_t(_counts_t(counts, device))
    return logmeans.cpu().numpy(), filtered.cpu().numpy()


def poscounts_norm_fit(counts, device: str | torch.device = "cuda"):
    """``(logmeans, usable_genes)`` over positive counts, as numpy."""
    logmeans, usable = poscounts_fit_t(_counts_t(counts, device))
    return logmeans.cpu().numpy(), usable.cpu().numpy()


def poscounts_size_factors(counts, logmeans, gene_mask, device: str | torch.device = "cuda"):
    """Poscounts size factors (N,) as numpy."""
    x = _counts_t(counts, device)
    sf = poscounts_size_factors_t(x, torch.as_tensor(np.array(logmeans), device=x.device),
                                  torch.as_tensor(np.array(gene_mask, bool), device=x.device))
    return sf.cpu().numpy()


def deseq2_norm_transform(counts, logmeans, filtered_genes, device: str | torch.device = "cuda"):
    """Normalise ``counts`` with previously fitted ``logmeans``; the mask may
    be restricted further (control genes, reference pydeseq2/dds.py:696-703).
    Parity: reference pydeseq2/preprocessing.py:59-102."""
    x = _counts_t(counts, device)
    normed, size_factors = norm_transform_t(
        x, torch.as_tensor(np.array(logmeans), device=x.device),
        torch.as_tensor(np.array(filtered_genes, bool), device=x.device))
    normed, size_factors = normed.cpu().numpy(), size_factors.cpu().numpy()
    if isinstance(counts, pd.DataFrame):
        return (pd.DataFrame(normed, index=counts.index, columns=counts.columns),
                pd.Series(size_factors, index=counts.index))
    return normed, size_factors
