"""Host-side design helpers (pandas only).

A copy of ``n_or_more_replicates`` from ``pydeseq2_tpu/utils/__init__.py``,
kept here so the port does not import the JAX package.
"""

from __future__ import annotations

import pandas as pd


def n_or_more_replicates(design_matrix: pd.DataFrame, min_replicates: int) -> pd.Series:
    """Samples whose design-row combination occurs >= min_replicates times.

    Each sample's cohort is the tuple of its design-matrix row; a sample
    qualifies when its cohort has at least ``min_replicates`` members
    (reference pydeseq2/utils.py:888-911).
    """
    cohorts = design_matrix.apply(tuple, axis=1)
    cohort_sizes = cohorts.map(cohorts.value_counts())
    return cohort_sizes >= min_replicates
