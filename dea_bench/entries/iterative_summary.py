"""The entry the window drives for a mix with ``"entry": "iterative_summary"``.

The program's call is ``entries/refit_summary.py``'s:
``run_summary_streamed(counts, design, contrast, dtype=..., refit_cooks=True)``
with ``run_deseq2``'s knobs on its refit route, ratio size factors asked
for. On counts in which every gene has a zero, median-of-ratios is
undefined: the program warns and switches to the iterative size factors.
The reference is ``dea_bench.reference.iterative.iterative_refit_summary``,
the plain iterative solve and then the refit route at its factors, with
the same inputs and knobs. The numbers compared, their quantities and
statistics are ``refit_summary``'s.
"""

from __future__ import annotations

from pathlib import Path

import torch

from dea_bench.cell import load_module

_REFIT = load_module(Path(__file__).resolve().parent / "refit_summary.py")

knobs = _REFIT.knobs
program = _REFIT.program
numbers = _REFIT.numbers
gaps = _REFIT.gaps
largest = _REFIT.largest
trend_stage = _REFIT.trend_stage
trend_inputs = _REFIT.trend_inputs
QUANTITIES = _REFIT.QUANTITIES
STATISTICS = _REFIT.STATISTICS
SUBSETS = _REFIT.SUBSETS


def reference(study, dtype: torch.dtype, kn: dict, tf32: bool = False) -> dict:
    """The same study through the plain reference, in ``dtype``."""
    from dea_bench.reference.iterative import iterative_refit_summary

    counts = study.counts if study.counts.dtype == dtype else study.counts.to(dtype)
    return iterative_refit_summary(counts, study.design, study.contrast, min_replicates=7, tf32=tf32, **kn)
