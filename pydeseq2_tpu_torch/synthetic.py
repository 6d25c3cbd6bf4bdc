"""Synthetic single-factor bulk RNA-seq counts, the benchmark's generator,
with planted Cook's outliers or a zero in every gene on request.

A copy of ``make_data`` from ``benchmarks/reference_baseline.py`` (seed 0 by
default), kept here so the port and ``chip_smoke.py`` need neither that
module, which imports the reference package, nor the JAX package.
"""

from __future__ import annotations

import numpy as np


def make_data(n_samples: int, n_genes: int, seed: int = 0, lfc_sd: float = 0.5):
    """``(counts (N, G) float, design (N, 2))``: NB counts with lognormal
    means and dispersions and a random two-level condition. ``lfc_sd`` is
    the standard deviation of the natural-log fold changes (the
    benchmark's 0.5 by default; a smaller one draws a study with weak
    effects, whose fitted apeGLM prior is narrow)."""
    rng = np.random.default_rng(seed)
    base = rng.lognormal(3.0, 1.5, size=n_genes)
    lfc = rng.normal(0, lfc_sd, size=n_genes)
    cond = rng.integers(0, 2, n_samples)
    X = np.column_stack([np.ones(n_samples), cond]).astype(float)
    mu = base[None, :] * np.exp(cond[:, None] * lfc[None, :])
    disp = np.clip(rng.lognormal(-2.0, 1.0, size=n_genes), 1e-3, 5.0)
    counts = rng.negative_binomial(1 / disp[None, :], 1 / (1 + disp[None, :] * mu))
    return counts.astype(float), X


def plant_outliers(counts: np.ndarray, every: int = 100) -> np.ndarray:
    """A copy of gene-major (G, N) counts with one Cook's outlier planted in
    every ``every``-th gene: the cell of sample (g / every) mod N set to 20x
    the row's maximum."""
    counts = counts.copy()
    genes = np.arange(0, counts.shape[0], every)
    counts[genes, (genes // every) % counts.shape[1]] = 20.0 * counts[genes].max(axis=1)
    return counts


def zero_per_gene(counts: np.ndarray) -> np.ndarray:
    """A copy of gene-major (G, N) counts with one zero in every gene, at
    sample g mod N (the zero-inflated draw of the JAX package's tests):
    median-of-ratios is then undefined and the pipelines switch to the
    iterative size factors. Coverage of that documented switch, not a cited
    study."""
    counts = counts.copy()
    genes = np.arange(counts.shape[0])
    counts[genes, genes % counts.shape[1]] = 0.0
    return counts
