"""Synthetic single-factor bulk RNA-seq counts, the benchmark's generator.

A copy of ``make_data`` from ``benchmarks/reference_baseline.py`` (seed 0 by
default), kept here so the port and ``chip_smoke.py`` need neither that
module, which imports the reference package, nor the JAX package.
"""

from __future__ import annotations

import numpy as np


def make_data(n_samples: int, n_genes: int, seed: int = 0):
    """``(counts (N, G) float, design (N, 2))``: NB counts with lognormal
    means and dispersions and a random two-level condition."""
    rng = np.random.default_rng(seed)
    base = rng.lognormal(3.0, 1.5, size=n_genes)
    lfc = rng.normal(0, 0.5, size=n_genes)
    cond = rng.integers(0, 2, n_samples)
    X = np.column_stack([np.ones(n_samples), cond]).astype(float)
    mu = base[None, :] * np.exp(cond[:, None] * lfc[None, :])
    disp = np.clip(rng.lognormal(-2.0, 1.0, size=n_genes), 1e-3, 5.0)
    counts = rng.negative_binomial(1 / disp[None, :], 1 / (1 + disp[None, :] * mu))
    return counts.astype(float), X
