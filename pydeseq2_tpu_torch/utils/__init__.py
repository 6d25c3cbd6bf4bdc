"""Host-side helpers: validation, example data, small numpy statistics.

A copy of what the port needs from ``pydeseq2_tpu/utils/__init__.py``
(numpy, pandas and scipy only), kept here so the port does not import the
JAX package. ``load_example_data`` finds ``datasets/`` beside this package
and reads only the bundled files: it has no remote mirror.
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import Literal

import numpy as np
import pandas as pd

# File layout of the bundled example datasets.
_EXAMPLE_FILES: dict[str, dict[str, str]] = {
    "synthetic": {
        "raw_counts": "test_counts.csv",
        "metadata": "test_metadata.csv",
    },
}
DATASETS_DIR = Path(__file__).resolve().parent.parent.parent / "datasets"


def load_example_data(
    modality: Literal["raw_counts", "metadata"] = "raw_counts",
    dataset: Literal["synthetic"] = "synthetic",
    debug: bool = False,
    debug_seed: int = 42,
) -> pd.DataFrame:
    """Load a bundled example dataset (counts are returned samples x genes).

    Behavior parity: reference pydeseq2/utils.py:24-107 with the ``debug``
    subsampling knobs; raises ``FileNotFoundError`` where ``datasets/`` is
    not beside the package.
    """
    if dataset not in _EXAMPLE_FILES:
        raise AssertionError(
            f"The dataset argument must be one of: {sorted(_EXAMPLE_FILES)}."
        )
    if modality not in _EXAMPLE_FILES[dataset]:
        raise AssertionError(
            f"The modality argument must be one of: "
            f"{sorted(_EXAMPLE_FILES[dataset])}."
        )
    path = DATASETS_DIR / dataset / _EXAMPLE_FILES[dataset][modality]
    if not path.is_file():
        raise FileNotFoundError(f"bundled example data not found at {path}")

    df = pd.read_csv(path, sep=",", index_col=0)
    if modality == "raw_counts":
        df = df.T  # stored genes x samples; the API is samples x genes

    if debug:
        rng_kwargs = {"random_state": debug_seed}
        df = df.sample(n=10, axis=0, **rng_kwargs)
        if modality == "raw_counts":
            df = df.sample(n=100, axis="index", **rng_kwargs)
    return df


def test_valid_counts(counts) -> None:
    """Validate that counts are numeric, non-NaN, integer, non-negative.

    Behavior parity: reference pydeseq2/utils.py:110-133.
    """
    if isinstance(counts, pd.DataFrame):
        if counts.isna().any().any():
            raise ValueError("NaNs are not allowed in the count matrix.")
        values = counts.to_numpy()
    else:
        values = np.asarray(counts)
    if not np.issubdtype(values.dtype, np.number):
        raise ValueError("The count matrix should only contain numbers.")
    if not isinstance(counts, pd.DataFrame) and np.isnan(values).any():
        raise ValueError("NaNs are not allowed in the count matrix.")
    if np.any(np.mod(values, 1) != 0):
        raise ValueError("The count matrix should only contain integers.")
    if np.any(values < 0):
        raise ValueError("The count matrix should only contain non-negative values.")


test_valid_counts.__test__ = False  # a validator, not a pytest test


def dispersion_trend(normed_mean, coeffs):
    """Parametric trend evaluator a0 + a1 / mu (reference pydeseq2/utils.py:136-160)."""
    if isinstance(coeffs, pd.Series):
        return coeffs["a0"] + coeffs["a1"] / normed_mean
    return coeffs[0] + coeffs[1] / normed_mean


def n_or_more_replicates(design_matrix: pd.DataFrame, min_replicates: int) -> pd.Series:
    """Samples whose design-row combination occurs >= min_replicates times.

    Each sample's cohort is the tuple of its design-matrix row; a sample
    qualifies when its cohort has at least ``min_replicates`` members
    (reference pydeseq2/utils.py:888-911).
    """
    cohorts = design_matrix.apply(tuple, axis=1)
    cohort_sizes = cohorts.map(cohorts.value_counts())
    return cohort_sizes >= min_replicates


def trimmed_mean_numpy(x: np.ndarray, trim: float = 0.1, axis: int | None = None):
    """Sort-based trimmed mean on the host, for the small refit subset
    (reference pydeseq2/utils.py:567-599)."""
    assert trim <= 0.5
    x = np.asarray(x)
    if axis is not None:
        s = np.sort(x, axis=axis)
        n = x.shape[axis]
        ntrim = math.floor(n * trim)
        return np.take(s, np.arange(ntrim, n - ntrim), axis).mean(axis)
    n = len(x)
    s = np.sort(x)
    ntrim = math.floor(n * trim)
    return s[ntrim : n - ntrim].mean()


def nb_nll_numpy(counts: np.ndarray, mu: np.ndarray, alpha: np.ndarray) -> np.ndarray:
    """Per-gene NB negative log-likelihood on the host, for scipy's Powell
    search of the iterative size factors (reference pydeseq2/dds.py:1487-1497),
    which evaluates it many times on small data."""
    from scipy.special import gammaln

    counts = np.asarray(counts, dtype=float)
    mu = np.asarray(mu, dtype=float)
    alpha = np.asarray(alpha, dtype=float)
    alpha_neg1 = 1.0 / alpha
    logbinom = (
        gammaln(counts + alpha_neg1)
        - gammaln(counts + 1.0)
        - gammaln(alpha_neg1)
    )
    return (
        alpha_neg1 * np.log(alpha)
        - logbinom
        + (counts + alpha_neg1) * np.log(mu + alpha_neg1)
        - counts * np.log(mu)
    ).sum(0)
