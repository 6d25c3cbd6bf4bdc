"""Host-side statistics (numpy only).

A copy of what the port needs from ``pydeseq2_tpu/models/stats.py``: the
apeGLM adaptive prior variance. The ``DeseqStats`` class is not ported yet.
"""

from __future__ import annotations

import numpy as np


def _apeglm_prior_variance(
    mle_lfc: np.ndarray,
    se: np.ndarray,
    lo: float = 1e-6,
    hi: float = 400.0,
    iters: int = 80,
) -> float:
    """apeGLM adaptive prior variance (reference pydeseq2/ds.py:552-588).

    Solves g(a) = sum_i w_i(a) (S_i - D_i) / sum_i w_i(a) - a = 0 with
    w_i = (a + D_i)^-2, where S = squared MLE LFCs and D = squared SEs, by
    bisection on [lo, hi] (g is continuous; g(lo) < 0 short-circuits to lo as
    in the reference). ~80 halvings reach ~1e-15 relative width. Port of
    ``pydeseq2_tpu/models/stats.py:110``.
    """
    ok = ~np.isnan(mle_lfc)
    S = np.square(mle_lfc[ok])
    D = np.square(se[ok])

    def resid(a: float) -> float:
        w = 1.0 / np.square(a + D)
        return float((w * (S - D)).sum() / w.sum()) - a

    if resid(lo) < 0:
        return lo
    a_lo, a_hi = lo, hi
    for _ in range(iters):
        mid = 0.5 * (a_lo + a_hi)
        if resid(mid) > 0:
            a_lo = mid
        else:
            a_hi = mid
    return 0.5 * (a_lo + a_hi)
