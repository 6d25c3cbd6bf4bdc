"""The launch plans of the cluster kernels ``sf_newton``
(``ops/sizefactors.py:_sf_plan``) and ``trend`` / ``trend_fit``
(``ops/trend.py:_trend_plan``), on the CPU: pure Python, no kernel runs.

Each plan splits the samples into chunks that cover every sample once, uses
at most 16 blocks a cluster, keeps what a block holds in shared memory
within one block's budget, and streams exactly where that would not fit.
"""

import pytest
import torch

from pydeseq2_tpu_torch import kernels
from pydeseq2_tpu_torch.ops import sizefactors as sz
from pydeseq2_tpu_torch.ops import trend as tr

torch.set_num_threads(1)  # xdist runs several workers on a few cores

SF_SHAPES = [
    # (G, N): the main width, the atlas, a transcript-level list, the edges
    (60_000, 100), (60_000, 1_000), (60_000, 10_000), (200_000, 100), (300_000, 100), (4_000, 100),
    (60_000, 3), (60_000, 1), (5, 100), (1, 100), (1, 1), (15, 7), (17, 2), (1_000_000, 12),
]


def _chunks(N: int, C: int) -> list[range]:
    return [range(c0, min(N, c0 + C)) for c0 in range(0, N, C)]


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("G,N", SF_SHAPES)
def test_sf_plan_covers_and_fits(G, N, itemsize):
    plan = sz._sf_plan(G, N, itemsize)
    assert plan.C >= 1 and plan.C & (plan.C - 1) == 0 and plan.C * itemsize <= 32
    assert 1 <= plan.K <= kernels.MAX_CLUSTER
    assert plan.K <= max(1, G)  # no cluster wider than the genes need
    # every sample is in exactly one chunk
    seen = [n for chunk in _chunks(N, plan.C) for n in chunk]
    assert seen == list(range(N))
    # every gene is in exactly one block of a cluster
    per = -(-G // plan.K)
    genes = [g for q in range(plan.K) for g in range(min(G, q * per), min(G, (q + 1) * per))]
    assert genes == list(range(G))
    c_max = min(32 // itemsize, 1 << max(0, (N - 1).bit_length()))  # one 32-byte sector, no wider than N needs
    fits = [c for c in (8, 4, 2, 1)
            if c <= c_max and sz._sf_smem_bytes(c, per, itemsize, True) <= kernels.SMEM_BLOCK_MAX]
    if plan.shared:
        # the widest chunk that fits
        assert plan.C == max(fits)
        assert sz._sf_smem_bytes(plan.C, per, itemsize, True) <= kernels.SMEM_BLOCK_MAX
        assert plan.max_clusters == 0
    else:
        # streamed exactly where not even one sample a chunk fits
        assert not fits
        assert plan.K == kernels.MAX_CLUSTER
        assert plan.max_clusters >= 1
        assert sz._sf_smem_bytes(plan.C, per, itemsize, False) <= kernels.SMEM_BLOCK_MAX
        # the clusters in flight hold at most half the L2 in counts, unless
        # one cluster alone is more
        assert plan.max_clusters * G * plan.C * itemsize <= kernels.L2_BYTES // 2 or plan.max_clusters == 1


def test_sf_plan_picks():
    """The plans of the shapes PERF.md reports: the main width and the
    atlas in shared memory (one 32-byte sector a gene row), the
    transcript-level float64 list streamed."""
    assert sz._sf_plan(60_000, 100, 4) == sz.SfPlan(8, 16, True, 0)
    assert sz._sf_plan(60_000, 100, 8) == sz.SfPlan(4, 16, True, 0)
    assert sz._sf_plan(60_000, 10_000, 4) == sz.SfPlan(8, 16, True, 0)
    streamed = sz._sf_plan(200_000, 100, 8)
    assert not streamed.shared and streamed.K == 16
    assert sz._sf_plan(200_000, 100, 4).shared
    assert sz._sf_plan(60_000, 3, 4).C == 4 and sz._sf_plan(60_000, 1, 4).C == 1
    assert sz._sf_plan(5, 100, 4).K == 1 and sz._sf_plan(1, 1, 8) == sz.SfPlan(1, 1, True, 0)


def test_sf_smem_bytes_layout():
    """The kernel's layout: 8 bytes for each of the warps' and the block's
    float64 partials, the chunk's s padded to 16, and in shared mode the
    slab padded to 16, r and coef, and a 16-bit index a row."""
    assert sz._sf_smem_bytes(8, 3750, 4, False) == 8 * (2 * 32 * 8 + 4 * 8) + 32
    assert sz._sf_smem_bytes(8, 3750, 4, True) == 8 * (2 * 32 * 8 + 4 * 8) + 32 + 120_000 + 8 * 3750 + 2 * 3750
    assert sz._sf_smem_bytes(1, 3, 8, True) == 8 * (2 * 32 + 4) + 16 + 32 + 48 + 6


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("G", [1, 2, 5, 300, 2_048, 2_049, 4_000, 60_000, 200_000, 216_000, 300_000, 1_000_000])
def test_trend_plan_covers_and_fits(G, itemsize):
    plan = tr._trend_plan(G, itemsize)
    assert 1 <= plan.K <= min(kernels.MAX_CLUSTER, G)
    per = -(-G // plan.K)
    genes = [g for q in range(plan.K) for g in range(min(G, q * per), min(G, (q + 1) * per))]
    assert genes == list(range(G))
    fits = tr._trend_smem_bytes(per, itemsize, True) <= kernels.SMEM_BLOCK_MAX
    assert plan.shared == fits
    assert tr._trend_smem_bytes(per, itemsize, plan.shared) <= kernels.SMEM_BLOCK_MAX
    assert plan.K & (plan.K - 1) == 0
    target = 4096 if itemsize == 4 else 512  # lanes a block before another is added
    assert per <= target or plan.K == kernels.MAX_CLUSTER
    assert plan.K == 1 or -(-G // (plan.K // 2)) > target  # the least such K
    if G <= 512:
        assert plan.K == 1  # one block, as for a few hundred genes


def test_trend_plan_picks():
    assert tr._trend_plan(300, 4) == tr.TrendPlan(1, True)
    assert tr._trend_plan(300, 8) == tr.TrendPlan(1, True)
    assert tr._trend_plan(4_000, 4) == tr.TrendPlan(1, True)
    assert tr._trend_plan(4_000, 8) == tr.TrendPlan(8, True)
    assert tr._trend_plan(60_000, 4) == tr.TrendPlan(16, True)
    assert tr._trend_plan(60_000, 8) == tr.TrendPlan(16, True)
    assert tr._trend_plan(200_000, 8) == tr.TrendPlan(16, True)
    assert tr._trend_plan(300_000, 8) == tr.TrendPlan(16, False)
    assert tr._trend_smem_bytes(10, 8, True) == 8 * (2 * 5 * 32 + 2 * 5 + 16 * 5) + 10 * 17
