"""The launch plans of the cluster kernels ``sf_newton``
(``ops/sizefactors.py:_sf_plan``), ``trend`` / ``trend_fit``
(``ops/trend.py:_trend_plan``) and ``grid_apeglm``
(``ops/shrink.py:_grid_plan``), of the trimmed moments of ``cooks`` and
``trimmed_var`` (``ops/stats.py:_trim_plan``), and of ``sf_nll``
(``ops/sizefactors.py:_nll_plan``), on the CPU: pure Python, no kernel
runs.

Each cluster plan splits the samples into chunks that cover every sample
once, uses at most 16 blocks a cluster, keeps what a block holds in shared
memory within one block's budget, and streams exactly where that would not
fit. Each trimmed-moment plan takes every cohort size from 1 to the row's
length, by rank count up to its rank_max and by radix select above, holds
its staged keys in one block's shared memory or streams them exactly where
they would not fit, and the wrappers hand the C launchers one value of the
right kind per argument. ``grid_apeglm``'s blocks take every grid row of
both passes once, and ``sf_nll``'s lane groups every gene and its chunks
every sample once, within a block's shared memory.
"""

import ctypes

import numpy as np
import pytest
import torch

from pydeseq2_tpu_torch import kernels
from pydeseq2_tpu_torch.ops import cooks as ck
from pydeseq2_tpu_torch.ops import shrink as sh
from pydeseq2_tpu_torch.ops import sizefactors as sz
from pydeseq2_tpu_torch.ops import stats as st
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


def _trim_bytes(plan: st.TrimPlan, buf_len: int, n_max: int, itemsize: int) -> int:
    """Dynamic shared memory of one launch block under ``plan``."""
    group = st._trim_group_bytes(buf_len, itemsize, n_max > plan.rank_max, plan.shared, plan.block)
    return group if plan.block else st._TRIM_WARPS * group


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("all_cohorts", [True, False])
@pytest.mark.parametrize("N", [1, 2, 3, 7, 50, 96, 97, 100, 400, 767, 1_000, 1_533, 3_000])
def test_trim_plan_covers_every_cohort_size(N, all_cohorts, itemsize):
    """One cohort of n and two of n and N - n, for every n from 1 to N: the
    staged keys fit one block's shared memory (a warp-mode block's
    _TRIM_WARP_SMEM), the rank count takes exactly the cohorts of at most
    rank_max <= 256 members, and a block has 256 or 1024 threads."""
    for n in range(1, N + 1):
        for sizes in ([n], [n, N - n] if n < N else [n]):
            plan = st._trim_plan(itemsize, sizes, 60_000, all_cohorts)
            buf_len = sum(sizes) if all_cohorts else max(sizes)
            assert buf_len >= n and 1 <= plan.rank_max <= st._TRIM_RANK_CAP
            assert plan.rank_max == st._TRIM_RANK_MAX[itemsize]
            limit = kernels.SMEM_BLOCK_MAX if plan.block else st._TRIM_WARP_SMEM
            assert _trim_bytes(plan, buf_len, max(sizes), itemsize) <= limit
            assert plan.shared and plan.blocks == 0 and plan.threads == 256


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("rows", [1, 64, 131, 132, 5_000, 60_000])
@pytest.mark.parametrize("n", [50, 1_532, 1_533, 28_750, 28_751, 57_500, 57_501, 59_038, 200_000, 1_000_000])
def test_trim_plan_streams_exactly_where_shared_memory_is_short(n, rows, itemsize):
    """A warp a row while eight slices fit _TRIM_WARP_SMEM, else a block a
    row (1024 threads where the rows are fewer than the SMs), its keys in
    shared memory exactly where they fit 227 KB, else in a workspace of at
    most two slices an SM whose slice holds every key, 16-byte aligned."""
    plan = st._trim_plan(itemsize, [n], rows, False, 132)
    radix = n > plan.rank_max
    warp_fits = st._TRIM_WARPS * st._trim_group_bytes(n, itemsize, radix, True, False) <= st._TRIM_WARP_SMEM
    assert plan.block == (not warp_fits)
    if not plan.block:
        return
    assert plan.threads == (1024 if rows < 132 else 256)
    fits = st._trim_group_bytes(n, itemsize, radix, True, True) <= kernels.SMEM_BLOCK_MAX
    assert plan.shared == fits
    assert st._trim_group_bytes(n, itemsize, radix, plan.shared, True) <= kernels.SMEM_BLOCK_MAX
    if not plan.shared:
        assert 1 <= plan.blocks <= min(rows, 2 * 132)
        ws = st._trim_ws_len(n, itemsize)
        assert ws >= n and (ws * itemsize) % 16 == 0


@pytest.mark.parametrize("itemsize", [4, 8])
def test_trim_plan_picks(itemsize):
    """The shapes PERF.md reports: Cook's cohorts of 50 (100 samples, 60000
    genes) by rank count, a warp a gene; the atlas block's cohorts of 5000
    (10000 samples) by radix select, a block of 256 a gene, in shared memory
    in float64 too; the class API's cohorts of 50; the mean trend's column
    of 59038 dispersions, one block of 1024, streamed."""
    cohorts50 = st._trim_plan(itemsize, [50, 50], 60_000, True)
    assert not cohorts50.block and cohorts50.shared and 50 <= cohorts50.rank_max
    atlas = st._trim_plan(itemsize, [5_000, 5_000], 5_000, True)
    assert atlas.block and atlas.threads == 256 and atlas.shared and 5_000 > atlas.rank_max
    assert st._trim_group_bytes(10_000, itemsize, True, True, True) <= kernels.SMEM_BLOCK_MAX
    assert st._trim_plan(itemsize, [10_000], 5_000, True).shared  # one cohort of all 10000 samples fits too
    assert st._trim_plan(itemsize, [50, 50], 60_000, False) == cohorts50
    column = st._trim_plan(itemsize, [59_038], 1, False)
    assert column == st.TrimPlan(True, 1024, st._TRIM_RANK_MAX[itemsize], False, 1)


def test_trim_group_bytes_layout():
    """The kernels' layout: a block's 32 double and 32 int reduction slots,
    the staged keys padded to 16 bytes, two 256-bin histograms, two
    boundary keys."""
    assert st._trim_group_bytes(100, 4, False, True, False) == 400 + 16
    assert st._trim_group_bytes(101, 4, True, True, False) == 416 + 2048 + 16
    assert st._trim_group_bytes(10_000, 8, True, True, True) == 384 + 80_000 + 2048 + 16
    assert st._trim_group_bytes(10_000, 8, True, False, True) == 384 + 2048 + 16
    assert st._trim_ws_len(101, 4) == 104 and st._trim_ws_len(3, 8) == 4


@pytest.fixture
def recorded(monkeypatch):
    """Launches recorded instead of made, on CPU tensors."""
    calls = []
    monkeypatch.setattr(kernels, "launch", lambda name, args, device: calls.append((name, args)))
    monkeypatch.setattr(kernels, "check_cuda_operands", lambda *a: None)
    monkeypatch.setattr(kernels, "sm_count", lambda device: 132)
    return calls


def _assert_marshalled(name, args):
    kinds = {ctypes.c_int: int, ctypes.c_double: float}
    want = kernels._ARGTYPES[kernels.KERNELS[name][1]]
    assert len(args) == len(want), name
    for a, w in zip(args, want):
        if w is ctypes.c_void_p:
            assert a is None or (isinstance(a, int) and not isinstance(a, bool)), (name, a)
        else:
            assert isinstance(a, kinds[w]) and not isinstance(a, bool), (name, a, w)


@pytest.mark.parametrize("N,cohort_ids", [(100, (0,) * 50 + (1,) * 50), (7, None), (30_000, (0,) * 30_000)])
def test_cooks_wrapper_marshals_its_plan(recorded, N, cohort_ids):
    """``_cooks_cuda`` hands the launcher its plan (warp or block, rank_max,
    shared or streamed with a workspace of ``blocks`` slices), the longest
    cohort and the members, in summary and refit mode."""
    G = 3
    x = torch.ones(G, N, dtype=torch.float64)
    args = (x, torch.ones(N, dtype=torch.float64), x, x * 0.1, torch.ones(G, dtype=torch.bool), 2, cohort_ids,
            (True,) * N, torch.tensor(4.8, dtype=torch.float64))
    ck._cooks_cuda(*args)
    ck._cooks_cuda(*args, (True,) * N, False)
    sizes = [N] if cohort_ids is None else [cohort_ids.count(c) for c in dict.fromkeys(cohort_ids)]
    plan = st._trim_plan(8, sizes, G, True)
    for name, a in recorded:
        _assert_marshalled(name, a)
        block, threads, rank_max, shared, blocks, n_max, n_members, ws = a[-8:]
        assert (bool(block), threads, rank_max, bool(shared), blocks) == tuple(plan)
        assert n_max == max(sizes) and n_members == N and (ws is None) == plan.shared
    assert recorded[1][1][21] is not None and recorded[0][1][21] is None  # refit outputs only in refit mode


def test_trimmed_rows_wrapper_marshals_its_plan(recorded):
    """``_trimmed_rows_cuda`` in mode 0 (a column) and mode 1 (cohorts): the
    plan, the longest cohort and the workspace where the plan streams."""
    column = torch.ones(1, 59_038, dtype=torch.float32)
    st._trimmed_rows_cuda(column, [59])
    x = torch.ones(40, 100, dtype=torch.float64)
    st._trimmed_rows_cuda(x, [6, 6], [1.51, 1.51], [list(range(50)), list(range(50, 100))])
    (_, a0), (_, a1) = recorded
    for a in (a0, a1):
        _assert_marshalled("trimmed_var", a)
    assert a0[3] == 0 and a0[-7:-1] == [1, 1024, 96, 0, 1, 59_038] and a0[-1] is not None
    assert a1[3] == 1 and a1[-7:-1] == [0, 256, 96, 1, 0, 50] and a1[-1] is None


GRID_CASES = [
    # (lanes, N, L): one lane, the wide checks' 16, the pipeline tiles of 256
    # and 937 lanes, a short grid, a long one, a tile wider than the card
    (1, 100, 60), (4, 8_000, 60), (16, 8_000, 60), (256, 100, 60), (494, 100, 60), (937, 100, 60),
    (4_096, 100, 60), (937, 1, 60), (16, 300, 5), (16, 100, 1), (16, 100, 2), (937, 100, 200), (937, 100, 600),
]


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("lanes,N,L", GRID_CASES)
def test_grid_plan_covers_and_fits(lanes, N, L, itemsize):
    plan = sh._grid_plan(lanes, N, L, itemsize)
    assert 1 <= plan.K <= min(kernels.MAX_CLUSTER, L) and plan.K & (plan.K - 1) == 0
    # every row of the grid (both passes use the same split) in exactly one block
    rows = [k for q in range(plan.K) for k in sh._grid_rows(L, plan.K, q)]
    assert rows == list(range(L))
    assert all(len(sh._grid_rows(L, plan.K, q)) >= 1 for q in range(plan.K))
    assert sh._grid_smem_bytes(L, plan.K, plan.chunk, itemsize) <= kernels.SMEM_BLOCK_MAX
    # chunks of a multiple of 256 samples, at most 1024, no more than N needs
    assert plan.chunk % 256 == 0 and 256 <= plan.chunk <= 1024
    assert plan.chunk == 256 or plan.chunk - 256 < N
    # the least K whose blocks reach two waves of the card (the blocks an SM
    # holds by registers and shared memory), at the cap, or forced by shared memory
    def waves2(K):
        return 2 * sh._grid_reg_per_sm(itemsize, sh._grid_smem_bytes(L, K, plan.chunk, itemsize)) * 132

    k_max = min(kernels.MAX_CLUSTER, 1 << (L.bit_length() - 1))
    assert lanes * plan.K >= waves2(plan.K) or plan.K == k_max
    smaller = plan.K // 2
    assert plan.K == 1 or lanes * smaller < waves2(smaller) or (
        sh._grid_smem_bytes(L, smaller, plan.chunk, itemsize) > kernels.SMEM_BLOCK_MAX)


def test_grid_plan_picks():
    """The plans of the shapes PERF.md reports, and a grid too large."""
    assert sh._grid_plan(1, 8_000, 60, 4) == sh.GridPlan(16, 1024)
    assert sh._grid_plan(16, 8_000, 60, 4) == sh.GridPlan(16, 1024)
    assert sh._grid_plan(16, 4_000, 60, 8) == sh.GridPlan(16, 1024)
    assert sh._grid_plan(937, 100, 60, 4) == sh.GridPlan(2, 256)
    assert sh._grid_plan(937, 100, 60, 8) == sh.GridPlan(1, 256)  # 3 blocks an SM: two waves are 792
    assert sh._grid_plan(256, 100, 60, 4) == sh.GridPlan(8, 256)
    assert sh._grid_plan(64, 100, 60, 4) == sh.GridPlan(16, 256)
    assert sh._grid_plan(4_096, 100, 60, 8) == sh.GridPlan(1, 256)
    assert sh._grid_plan(16, 100, 5, 4).K == 4
    assert sh._grid_plan(937, 100, 600, 8).K == 16  # shared memory forces it
    with pytest.raises(ValueError):
        sh._grid_plan(937, 100, 1_000, 8)


def test_grid_plan_follows_the_occupancy():
    """The blocks an SM holds set the two waves K must reach: the ptxas
    registers by default (4 blocks of 256 in float32, 3 in float64, fewer
    where shared memory binds), else what ``per_sm`` says of each K's
    shared memory."""
    assert sh._grid_reg_per_sm(4, 26_656) == 4 and sh._grid_reg_per_sm(8, 46_416) == 3
    assert sh._grid_reg_per_sm(4, 100_000) == 2 and sh._grid_reg_per_sm(8, 232_448) == 1
    seen = []

    def per_sm(smem):
        seen.append(smem)
        return 8

    assert sh._grid_plan(937, 100, 60, 4, per_sm=per_sm) == sh.GridPlan(4, 256)  # 2 x 8 x 132 = 2112
    assert seen and seen[-1] == sh._grid_smem_bytes(60, 4, 256, 4)
    assert sh._grid_plan(937, 100, 60, 4, sms=66, per_sm=lambda b: 4) == sh.GridPlan(1, 256)
    assert sh._grid_plan(1, 8_000, 60, 4, per_sm=lambda b: 1) == sh.GridPlan(16, 1024)


def test_grid_smem_bytes_layout():
    """The kernel's layout: float64 totals of a block's points, rows and
    columns, 3 x 256 float64 slice partials, 25 ints padded to 16, the two
    published candidates and the 8 warps' (16 bytes each), five staged
    values a sample."""
    assert sh._grid_smem_bytes(60, 2, 256, 4) == 8 * (30 * 60 + 30 + 60 + 768) + 112 + 160 + 5 * 256 * 4
    assert sh._grid_smem_bytes(60, 16, 1024, 8) == 8 * (4 * 60 + 4 + 60 + 768) + 112 + 160 + 5 * 1024 * 8
    assert [len(sh._grid_rows(60, 16, q)) for q in range(16)] == [3, 4, 4, 4] * 4


NLL_SHAPES = [(60_000, 100), (60_000, 1_000), (60_000, 10_000), (4_000, 3), (1, 1), (7, 64), (7, 65), (70, 256),
              (70, 257), (3, 4_074), (3, 4_075), (5, 2_037), (5, 2_038), (2, 100_000)]


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("G,N", NLL_SHAPES)
def test_nll_plan_covers_and_fits(G, N, itemsize):
    plan = sz._nll_plan(N, itemsize)
    assert plan.lanes in (4, 8, 16, 32)
    # at most 16 cells a lane, or a whole warp a gene
    assert -(-N // plan.lanes) <= 16 or plan.lanes == 32
    assert plan.lanes == 4 or -(-N // (plan.lanes // 2)) > 16  # the fewest such lanes
    # every gene in one lane group, every sample in one chunk
    per = 256 // plan.lanes
    blocks = -(-G // per)
    genes = [b * per + j for b in range(blocks) for j in range(per) if b * per + j < G]
    assert genes == list(range(G))
    seen = [n for c0 in range(0, N, plan.chunk) for n in range(c0, min(N, c0 + plan.chunk))]
    assert seen == list(range(N))
    assert plan.chunk <= max(N, 1)
    # the widest chunk that fits 48 KB, or all N
    assert sz._nll_smem_bytes(plan.chunk, itemsize) <= 49_152
    assert plan.chunk == N or sz._nll_smem_bytes(plan.chunk + 1, itemsize) > 49_152


def test_nll_plan_picks():
    assert sz._nll_plan(100, 4) == sz.NllPlan(8, 100)
    assert sz._nll_plan(100, 8) == sz.NllPlan(8, 100)
    assert sz._nll_plan(1_000, 4) == sz.NllPlan(32, 1_000)
    assert sz._nll_plan(10_000, 4) == sz.NllPlan(32, 4_074)
    assert sz._nll_plan(10_000, 8) == sz.NllPlan(32, 2_037)
    assert sz._nll_plan(3, 4) == sz.NllPlan(4, 3)
    assert sz._nll_smem_bytes(100, 4) == 1_200 + 256 and sz._nll_smem_bytes(100, 8) == 2_400 + 256


def test_grid_wrapper_marshals_its_plan(recorded, monkeypatch):
    """``_grid_shrink_cuda`` hands the launcher the lanes, the grid and the
    plan it picks (or is given); no selection, every lane."""
    asked = []

    def occupancy(name, args, device):
        asked.append((name, args[:2]))
        ctypes.c_int.from_address(args[2]).value = 4

    monkeypatch.setattr(kernels, "call_helper", occupancy)
    sh._grid_card_per_sm.cache_clear()
    K, N = 937, 100
    counts = torch.ones(K, N, dtype=torch.float32)
    X = torch.ones(N, 2, dtype=torch.float32)
    args = (counts, torch.zeros(N), X, torch.ones(K), 15.0, 0.5, torch.ones(K), 1, 60, -30.0, 30.0)
    sh._grid_shrink_cuda(*args)
    sh._grid_shrink_cuda(*args, plan=sh.GridPlan(4, 512))
    for name, a in recorded:
        assert name == "grid_apeglm"
        _assert_marshalled(name, a)
        assert a[:3] == [0, K, N] and a[11] == 60 and a[14] == 1
    assert recorded[0][1][15:17] == list(sh._grid_plan(K, N, 60, 4)) == [2, 256]
    assert recorded[1][1][15:17] == [4, 512]
    assert recorded[0][1][8] is None
    # the occupancy of each K the plan tried, asked once (then cached), none for a given plan
    assert asked == [("grid_apeglm_per_sm", [0, sh._grid_smem_bytes(60, k, 256, 4)]) for k in (1, 2)]
    sh._grid_card_per_sm.cache_clear()


def test_sf_nll_wrapper_marshals_its_plan(recorded, monkeypatch):
    """``_sf_nll_cuda`` hands the launcher its plan and the lgamma table,
    made once per device and dtype and kept."""
    monkeypatch.setattr(sz, "_lgamma_tables", {})
    G, N = 300, 100
    counts = torch.ones(G, N, dtype=torch.float64)
    v = torch.ones(N, dtype=torch.float64)
    g = torch.ones(G, dtype=torch.float64)
    args = (counts, g, v, v, v, g, torch.ones(G, dtype=torch.bool), 0.5)
    sz._sf_nll_cuda(*args)
    sz._sf_nll_cuda(*args, plan=sz.NllPlan(32, 50))
    (n0, a0), (n1, a1) = recorded
    for name, a in recorded:
        assert name == "sf_nll"
        _assert_marshalled(name, a)
        assert a[:3] == [1, G, N] and a[-2] == sz.LGAMMA_TABLE_LEN
    assert a0[3:5] == [8, 100] and a1[3:5] == [32, 50]
    table = sz._lgamma_tables[(torch.device("cpu"), torch.float64)]
    assert a0[-3] == table.data_ptr() == a1[-3]  # the same table


def test_lgamma_table_wrapper_marshals(recorded):
    """``_lgamma_table_cuda`` launches (and counts) ``lgamma_table`` on the
    table's length and pointer."""
    table = sz._lgamma_table_cuda(torch.float32, "cpu")
    assert table.shape == (sz.LGAMMA_TABLE_LEN,) and table.dtype == torch.float32
    ((name, a),) = recorded
    assert name == "lgamma_table"
    _assert_marshalled(name, a)
    assert a == [0, sz.LGAMMA_TABLE_LEN, table.data_ptr()]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_lgamma_table_plain(dtype):
    """The plain table is gammaln(i + 1), the NLL's lgamma(y + 1) of an
    integer count i (scipy's, rtol 1e-6 in float32, 1e-12 in float64),
    and lgamma(1) = 0 exactly, which the zero cells' short form needs."""
    from scipy.special import gammaln

    table = sz._lgamma_table_plain(dtype, "cpu")
    want = gammaln(np.arange(1, sz.LGAMMA_TABLE_LEN + 1, dtype=np.float64))
    np.testing.assert_allclose(table.double().numpy(), want, rtol=1e-6 if dtype == torch.float32 else 1e-12,
                               atol=1e-6 if dtype == torch.float32 else 1e-12)
    assert table[0].item() == 0.0 and table[1].item() == 0.0