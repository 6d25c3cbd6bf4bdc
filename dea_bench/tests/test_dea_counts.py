"""The kernels' operation and byte counts, and the roofline share read
from them, against counts worked by hand."""

from __future__ import annotations

import pytest
import torch

from dea_bench.cell import HERE, load_module
from dea_bench.trace import Trace, count_span

SCAN = load_module(HERE / "counts" / "disp_scan.py")
NEWTON = load_module(HERE / "counts" / "disp_newton.py")
PEAKS = {"hbm_bytes_per_s": 1e12, "float32_ops_per_s": 1e13, "float64_ops_per_s": 5e12}


def test_scan_cost_by_hand():
    # G=2, N=3, P=2, K=4: point 0 stable (30), point 1 auto (38), points 2-3
    # plain (40); the Cox-Reid part 3 + 2 + 2 * 3 = 11 a point.
    assert SCAN.scan_cost(2, 3, 2, 4, 1, 2, 4) == (2 * 6 * 4 + 4 * 2 * 4, 6 * (30 + 38 + 80 + 4 * 11))
    assert SCAN.scan_cost(1, 1, 1, 1, 1, 1, 8) == (2 * 8 + 8, 30 + 3 + 1 + 2)


def test_newton_cost_by_hand():
    # P=2: 3 Gram entries, Cox-Reid 10 + 18 + 3 = 31; half the genes plain.
    assert NEWTON.newton_cost(2, 3, 2, 0.5, 8) == (2 * 6 * 8 + 5 * 2 * 8, 5 * 6 * (42.5 + 63.5 + 31))
    assert NEWTON.newton_cost(1, 1, 1, 0.0, 4) == (2 * 4 + 5 * 4, 5 * (85 + 10 + 6 + 1))


def test_scan_record_skips_the_fine_scan():
    counts = torch.zeros(5, 7, dtype=torch.float32)
    X = torch.zeros(7, 2)
    grid = (torch.zeros(32), 32, 8, 12, 0.0)
    assert SCAN.counted(("disp_scan", counts, counts, X, grid, 32), {})
    rec = SCAN.record(("disp_scan", counts, counts, X, grid, 32), {}, None)
    assert rec == dict(G=5, N=7, P=2, K=32, bnd_start=8, bnd_end=12, isz=4)
    assert not SCAN.counted(("disp_scan_fine", counts, counts, X, grid, 32), {})


def _trace(kernels, launches):
    return Trace(studies=1, window_s=1.0, busy_s=0.5, kernels=kernels, copies=[], launches=launches,
                 peaks=PEAKS)


def test_roofline_share():
    rec = dict(G=1000, N=100, P=2, K=32, bnd_start=8, bnd_end=12, isz=4)
    nbytes, ops = SCAN.scan_cost(1000, 100, 2, 32, 8, 12, 4)
    bound = max(nbytes / 1e12, ops / 1e13)
    inside = frozenset({count_span("disp_scan")})
    # the fine scan's launch of the same template, outside the count's span, is not timed
    kern = [("void disp_scan_kernel<2, float>(int)", 4 * bound, inside), ("other", 1.0, inside),
            ("void disp_scan_kernel<2, float>(int)", 9.0, frozenset())]
    assert _trace(kern, {"disp_scan": (SCAN, [rec])}).roofline_pct("disp_scan") == pytest.approx(25.0)
    la = torch.full((10,), -5.0)  # r = e^5 > 8: the stable form
    nrec = dict(G=10, N=100, P=2, isz=8, la=la)
    nb, no = NEWTON.newton_cost(10, 100, 2, 0.0, 8)
    tk = [("disp_newton_kernel<2, double>", 2 * max(nb / 1e12, no / 5e12), frozenset({count_span("disp_newton")}))]
    assert _trace(tk, {"disp_newton": (NEWTON, [nrec])}).roofline_pct("disp_newton") == pytest.approx(50.0)


def test_roofline_reads_nothing_without_launches():
    assert _trace([], {"disp_scan": (SCAN, [])}).roofline_pct("disp_scan") is None
    assert _trace([("x", 1.0, frozenset())], {}).roofline_pct("disp_scan") is None
