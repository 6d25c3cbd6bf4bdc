"""The launch plans of the cluster kernels ``sf_newton``
(``ops/sizefactors.py:_sf_plan``), ``trend`` / ``trend_fit``
(``ops/trend.py:_trend_plan``), ``grid_apeglm`` and ``grid_nb``
(``ops/shrink.py:_grid_plan``), of the trimmed moments of ``cooks`` and
``trimmed_var`` (``ops/stats.py:_trim_plan``), of ``sf_nll``
(``ops/sizefactors.py:_nll_plan``), of ``shrink``'s candidate rounds
(``ops/shrink.py:_shrink_round``), of ``select`` (``ops/select.py:
_select_plan``) and of ``irls`` (``ops/irls.py:_irls_plan``), on the CPU:
pure Python, no kernel runs.

Each cluster plan splits the samples into chunks that cover every sample
once, uses at most 16 blocks a cluster, keeps what a block holds in shared
memory within one block's budget, and streams exactly where that would not
fit. Each trimmed-moment plan takes every cohort size from 1 to the row's
length, by rank count up to its rank_max and by radix select above, holds
its staged keys in one block's shared memory or streams them exactly where
they would not fit, and the wrappers hand the C launchers one value of the
right kind per argument. The grid kernels' blocks take every grid row of
both passes once, ``grid_nb``'s plan from the selected count its caller
read, with no host read of its own, and ``sf_nll``'s lane groups every
gene and its chunks every sample once, within a block's shared memory.
``select``'s clusters take every key of every column once within a
block's shared memory (streamed exactly where they cannot), and its
wrapper hands the kernel the tile where it lies; ``irls_core``'s CUDA
route makes no (G, N) tensor.
"""

import ctypes

import numpy as np
import pytest
import torch

from pydeseq2_tpu_torch import kernels, tracing
from pydeseq2_tpu_torch.ops import cooks as ck
from pydeseq2_tpu_torch.ops import irls as irl
from pydeseq2_tpu_torch.ops import select as sel
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
    monkeypatch.setattr(kernels, "check_cuda_device", lambda *a: None)
    monkeypatch.setattr(kernels, "sm_count", lambda device: 132)
    return calls


def _assert_marshalled(name, args):
    kinds = {ctypes.c_int: int, ctypes.c_double: float, ctypes.c_longlong: int}
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
    # the wave rule: of the powers of two up to the cap whose blocks fit,
    # the least K of least cost (an SM runs ceil(lanes K / 132) blocks in
    # rounds of the blocks it holds by registers and shared memory, a short
    # round counting at least 3/4 of a full one, each block 1/K of a lane
    # plus 1/32)
    k_max = min(kernels.MAX_CLUSTER, 1 << (L.bit_length() - 1))
    costs = {}
    for K in (1, 2, 4, 8, 16):
        smem = sh._grid_smem_bytes(L, K, plan.chunk, itemsize)
        if K <= k_max and smem <= kernels.SMEM_BLOCK_MAX:
            per_sm = sh._grid_reg_per_sm(itemsize, smem)
            n = -(-lanes * K // 132)
            rounds = [per_sm] * (n // per_sm) + ([max(n % per_sm, 0.75 * per_sm)] if n % per_sm else [])
            costs[K] = sum(rounds) * (1 / K + 1 / 32)
    assert costs[plan.K] == min(costs.values())
    assert all(costs[K] > costs[plan.K] for K in costs if K < plan.K)


def test_grid_plan_picks():
    """The plans of the shapes PERF.md reports (the best K of its sweep of
    K on the H100, or within 5% of it), and a grid too large."""
    assert sh._grid_plan(1, 8_000, 60, 4) == sh.GridPlan(16, 1024)
    assert sh._grid_plan(16, 8_000, 60, 4) == sh.GridPlan(16, 1024)
    assert sh._grid_plan(16, 4_000, 60, 8) == sh.GridPlan(16, 1024)
    assert sh._grid_plan(937, 100, 60, 4) == sh.GridPlan(2, 256)
    assert sh._grid_plan(937, 100, 60, 8) == sh.GridPlan(2, 256)  # 3 blocks an SM; K = 1 within 2.4%
    assert sh._grid_plan(256, 100, 60, 4) == sh.GridPlan(2, 256)
    assert sh._grid_plan(494, 100, 60, 4) == sh.GridPlan(1, 256)  # K = 2 best, 1.3% less
    assert sh._grid_plan(64, 100, 60, 4) == sh.GridPlan(8, 256)
    assert sh._grid_plan(4_096, 100, 60, 8) == sh.GridPlan(1, 256)
    assert sh._grid_plan(16, 100, 5, 4).K == 4
    assert sh._grid_plan(937, 100, 600, 8).K == 16  # shared memory forces it
    with pytest.raises(ValueError):
        sh._grid_plan(937, 100, 1_000, 8)


def test_grid_plan_follows_the_occupancy():
    """The blocks an SM holds set the floor of the blocks it runs: the
    ptxas registers by default (4 blocks of 256 in float32, 3 in float64,
    fewer where shared memory binds), else what ``per_sm`` says of each K's
    shared memory, asked once for every K that fits."""
    assert sh._grid_reg_per_sm(4, 26_656) == 4 and sh._grid_reg_per_sm(8, 46_416) == 3
    assert sh._grid_reg_per_sm(4, 100_000) == 2 and sh._grid_reg_per_sm(8, 232_448) == 1
    assert sh._grid_reg_per_sm(4, 26_656, "grid_nb") == 4 and sh._grid_reg_per_sm(8, 46_416, "grid_nb") == 3
    seen = []

    def per_sm(smem):
        seen.append(smem)
        return 8

    assert sh._grid_plan(937, 100, 60, 4, per_sm=per_sm) == sh.GridPlan(2, 256)
    assert seen == [sh._grid_smem_bytes(60, k, 256, 4) for k in (1, 2, 4, 8, 16)]
    # 24 blocks an SM held: 937 lanes run 8 a SM at K = 1, a round below 3/4 of 24
    assert sh._grid_plan(937, 100, 60, 4, per_sm=lambda b: 24) == sh.GridPlan(2, 256)
    # half the SMs: 15 blocks an SM at K = 1, whole rounds but the last
    assert sh._grid_plan(937, 100, 60, 4, sms=66, per_sm=lambda b: 4) == sh.GridPlan(1, 256)
    assert sh._grid_plan(1, 8_000, 60, 4, per_sm=lambda b: 1) == sh.GridPlan(16, 1024)


def test_grid_smem_bytes_layout():
    """The kernel's layout: float64 totals of a block's points, rows and
    columns, 3 x 256 float64 slice partials, 26 ints padded to 16, the two
    published candidates and the 8 warps' (16 bytes each), five staged
    values a sample (grid_apeglm) or eight (grid_nb)."""
    assert sh._grid_smem_bytes(60, 2, 256, 4) == 8 * (30 * 60 + 30 + 60 + 768) + 112 + 160 + 5 * 256 * 4
    assert sh._grid_smem_bytes(60, 16, 1024, 8) == 8 * (4 * 60 + 4 + 60 + 768) + 112 + 160 + 5 * 1024 * 8
    assert sh._grid_smem_bytes(60, 1, 256, 8, 8) == 8 * (60 * 60 + 60 + 60 + 768) + 112 + 160 + 8 * 256 * 8
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
    assert asked == [("grid_apeglm_per_sm", [0, sh._grid_smem_bytes(60, k, 256, 4)]) for k in (1, 2, 4, 8, 16)]
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

NB_CASES = [
    # (selected lanes, N): the pipeline's one lane and its tile, the wide
    # checks' 16 and 4 lanes, a tile wider than the card, one sample
    (1, 100), (2, 100), (16, 100), (64, 100), (256, 100), (494, 100), (937, 100), (4, 4_000), (16, 8_000),
    (4_096, 100), (937, 1),
]


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("lanes,N", NB_CASES)
def test_grid_nb_plan_covers_and_fits(lanes, N, itemsize):
    """``grid_nb``'s plan shares ``grid_apeglm``'s rule on its own staged
    chunk (eight values a sample): every row in one block, within a block's
    shared memory; one selected lane spreads over 16 blocks, and a large
    selection leaves no mostly idle last wave."""
    plan = sh._grid_plan(lanes, N, 60, itemsize, kernel="grid_nb")
    rows = [k for q in range(plan.K) for k in sh._grid_rows(60, plan.K, q)]
    assert rows == list(range(60))
    smem = sh._grid_smem_bytes(60, plan.K, plan.chunk, itemsize, 8)
    assert smem <= kernels.SMEM_BLOCK_MAX
    if lanes <= 16:
        assert plan.K == 16
    # the last round of blocks on an SM at least half full, or the only one
    per_sm = sh._grid_reg_per_sm(itemsize, smem, "grid_nb")
    n = -(-lanes * plan.K // 132)
    assert n <= per_sm or n % per_sm == 0 or n % per_sm >= per_sm / 2


def test_grid_nb_plan_picks():
    """The selected count, not the tile, sets the plan: 1 of a 937-lane
    tile takes 16 blocks, every lane 2."""
    assert sh._grid_plan(1, 100, 60, 4, kernel="grid_nb") == sh.GridPlan(16, 256)
    assert sh._grid_plan(937, 100, 60, 4, kernel="grid_nb") == sh.GridPlan(2, 256)
    assert sh._grid_plan(16, 8_000, 60, 4, kernel="grid_nb") == sh.GridPlan(16, 1024)
    assert sh._grid_plan(4, 4_000, 60, 8, kernel="grid_nb") == sh.GridPlan(16, 1024)
    assert sh._grid_plan(1, 100, 60, 8, kernel="grid_nb") == sh.GridPlan(16, 256)


def _nb_args(K, N, dtype=torch.float32):
    counts = torch.ones(K, N, dtype=dtype)
    X = torch.ones(N, 2, dtype=dtype)
    return (counts, torch.ones(N, dtype=dtype), X, torch.full((K,), 0.1, dtype=dtype), 0.5, 60, -30.0, 30.0)


@pytest.fixture
def nb_recorded(recorded, monkeypatch):
    """``grid_nb`` launches recorded on CPU tensors, the selection taken as
    it is, the occupancy of each K asked (4 blocks an SM)."""
    asked = []

    def occupancy(name, args, device):
        asked.append((name, args[:2]))
        ctypes.c_int.from_address(args[2]).value = 4

    monkeypatch.setattr(kernels, "call_helper", occupancy)
    monkeypatch.setattr(kernels, "check_sel", lambda name, sel, K: None if sel is None else sel.to(torch.uint8))
    sh._grid_card_per_sm.cache_clear()
    yield recorded, asked
    sh._grid_card_per_sm.cache_clear()


def test_grid_nb_wrapper_marshals_its_plan(nb_recorded):
    """``_grid_fit_beta_cuda`` hands the launcher the tile, the clusters
    (the selected count as its caller read it, at most the tile; the tile
    where none is given), the grid and the plan of that count, or the plan
    it is given; the selection's pointer where there is one."""
    from pydeseq2_tpu_torch.ops import irls as irl

    recorded, asked = nb_recorded
    K, N = 937, 100
    args = _nb_args(K, N)
    sel = torch.zeros(K, dtype=torch.bool)
    sel[5] = True
    irl._grid_fit_beta_cuda(*args, sel, 1)
    irl._grid_fit_beta_cuda(*args)
    irl._grid_fit_beta_cuda(*args, sel, 5_000)
    irl._grid_fit_beta_cuda(*args, sel, None, sh.GridPlan(4, 512))
    for name, a in recorded:
        assert name == "grid_nb"
        _assert_marshalled(name, a)
        assert a[0] == 0 and a[1] == K and a[3] == N and a[11] == 60 and a[12] == 0.5
    assert [a[2] for _, a in recorded] == [1, K, K, K]
    assert [a[13:15] for _, a in recorded] == [[16, 256], [2, 256], [2, 256], [4, 512]]
    assert recorded[0][1][8] is not None and recorded[1][1][8] is None
    # occupancy asked of grid_nb's own build, once for each K of each dtype
    assert {n for n, _ in asked} == {"grid_nb_per_sm"}
    assert asked == [("grid_nb_per_sm", [0, sh._grid_smem_bytes(60, k, 256, 4, 8)]) for k in (1, 2, 4, 8, 16)]


def test_grid_nb_wrapper_reads_nothing_from_the_card(nb_recorded, monkeypatch):
    """The plan comes from the count the caller hands over: the wrapper
    reads no tensor's value on the host (a counting stub on every way a
    tensor's value reaches Python)."""
    from pydeseq2_tpu_torch.ops import irls as irl

    reads = []
    for attr in ("__bool__", "__int__", "__float__", "__index__", "item", "tolist", "numpy", "cpu"):
        orig = getattr(torch.Tensor, attr)

        def counted(self, *a, _orig=orig, _attr=attr, **k):
            reads.append(_attr)
            return _orig(self, *a, **k)

        monkeypatch.setattr(torch.Tensor, attr, counted)
    K, N = 937, 100
    sel = torch.arange(K) % 7 == 0
    irl._grid_fit_beta_cuda(*_nb_args(K, N), sel, 134)
    assert reads == []
    assert nb_recorded[0][0][1][2] == 134


def test_grid_nb_caller_passes_its_count(monkeypatch):
    """``_irls_with_rescue`` (one phase) reads two values on the host, the
    box's branch and the count of lanes still failing, and hands the grid
    that count with its selection: the grid's plan costs no read of its
    own (a counting stub on every way a tensor's value reaches Python)."""
    from pydeseq2_tpu_torch import fused

    G, N = 40, 12
    calls = []

    def irls(counts, sf, X, disp, beta, **kw):
        return beta.clone(), torch.ones(G, dtype=torch.bool), torch.zeros(G, dtype=torch.bool)

    def box(counts, sf, X, disp, beta_init, min_mu=0.5, sel=None):
        ok = torch.zeros(counts.shape[0], dtype=torch.bool)
        ok[::3] = True
        return beta_init.clone(), ok

    def grid(counts, sf, X, disp, min_mu=0.5, sel=None, n_sel=None):
        calls.append((counts.shape[0], sel.clone(), n_sel))
        return torch.zeros(counts.shape[0], 2, dtype=counts.dtype)

    monkeypatch.setattr(fused, "irls_core", irls)
    monkeypatch.setattr(fused, "newton_box_nbglm", box)
    monkeypatch.setattr(fused, "grid_fit_beta_batch", grid)
    reads = []
    for attr in ("__bool__", "__int__", "__float__", "__index__", "item", "tolist", "numpy", "cpu"):
        orig = getattr(torch.Tensor, attr)

        def counted(self, *a, _orig=orig, _attr=attr, **k):
            reads.append(_attr)
            return _orig(self, *a, **k)

        monkeypatch.setattr(torch.Tensor, attr, counted)
    X = torch.stack([torch.ones(N), torch.arange(N) % 2], 1).double()
    fused._irls_with_rescue(torch.ones(G, N, dtype=torch.float64), torch.ones(N, dtype=torch.float64), X,
                            torch.full((G,), 0.1, dtype=torch.float64), torch.zeros(G, 2, dtype=torch.float64),
                            0.5, 1e-8, phase1_iters=250)
    assert reads == ["__bool__", "__int__"]
    ((lanes, sel, n_sel),) = calls
    assert lanes == G and int(sel.sum()) == n_sel == G - len(range(0, G, 3))  # the tile: every lane


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("cands", [None, 1, 3])
def test_shrink_wrapper_marshals_its_rounds(recorded, cands, dtype):
    """``_nbinom_glm_cuda`` hands the launcher the candidates a later
    backtracking round evaluates (``_shrink_round`` unless given) and seven
    output pointers, and returns the coefficients, inverse Hessians, flags,
    steps, the passes the JAX order needs, the evaluations made and the
    reads of the row."""
    G, N, P = 5, 12, 3
    X = torch.ones(N, P, dtype=dtype)
    args = (X, torch.ones(G, N, dtype=dtype), torch.ones(G, dtype=dtype), torch.zeros(N, dtype=dtype), 15.0, 0.5,
            1, 60)
    out = sh._nbinom_glm_cuda(*args) if cands is None else sh._nbinom_glm_cuda(*args, cands=cands)
    ((name, a),) = recorded
    assert name == "shrink"
    _assert_marshalled(name, a)
    assert a[:4] == [int(dtype == torch.float64), P, G, N] and a[10:13] == [1, 60, sh._ftol(dtype)]
    assert a[13] == (sh._shrink_round(dtype, P) if cands is None else cands)
    assert all(isinstance(p, int) for p in a[14:]) and len(set(a[14:])) == 7
    assert [t.shape for t in out] == [(G, P), (G, P, P), (G,), (G,), (G,), (G,), (G,)]
    assert out[2].dtype == torch.bool and out[4].dtype == out[5].dtype == out[6].dtype == torch.int32


def test_shrink_round_plan():
    """Rounds of 3 candidates in float32 at P <= 3, one candidate a pass
    otherwise (the rounds the card measured no slower)."""
    assert [sh._shrink_round(torch.float32, P) for P in range(1, 9)] == [3, 3, 3, 1, 1, 1, 1, 1]
    assert [sh._shrink_round(torch.float64, P) for P in range(1, 9)] == [1] * 8


@pytest.mark.parametrize("P,cands", [(2, 4), (2, 5), (4, 3), (8, 3)])
def test_shrink_wrapper_refuses_other_rounds(recorded, P, cands):
    """The kernel is built for rounds of 1 candidate, and of 3 where P <= 3."""
    X = torch.ones(4, P)
    args = (X, torch.ones(3, 4), torch.ones(3), torch.zeros(4), 15.0, 0.5, 1, 60)
    with pytest.raises(ValueError):
        sh._nbinom_glm_cuda(*args, cands=cands)
    assert recorded == []


SELECT_CASES = [
    # (C, L): the size-factor tile and its 1000-sample form, the prior's and
    # the keep quantile's column, a short column, columns shorter than a
    # block's rows, ragged groups, the streamed side of one and many columns
    (100, 60_000), (1_000, 60_000), (1, 60_000), (1, 1_000), (1, 777), (7, 3), (3, 100_000), (13, 5_001),
    (1, 729_000), (1, 2_000_000), (100, 1_000_000), (132, 1), (1, 1),
]


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("C,L", SELECT_CASES)
def test_select_plan_covers_and_fits(C, L, itemsize):
    """Every column in one group of B, every row of a group in one of its K
    blocks' shares, the staged keys within one block's shared
    memory, streamed exactly where not even 16 blocks hold them."""
    plan = sel._select_plan(C, L, itemsize)
    assert plan.B in (1, 2) and plan.B * itemsize <= 8 and plan.B <= max(1, C)
    assert 1 <= plan.K <= kernels.MAX_CLUSTER and plan.K & (plan.K - 1) == 0
    groups = -(-C // plan.B)
    cols = [c for g in range(groups) for c in range(g * plan.B, min(C, (g + 1) * plan.B))]
    assert cols == list(range(C))
    R = -(-L // plan.K)
    rows = [i for q in range(plan.K) for i in range(q * R, min(L, (q + 1) * R))]
    assert rows == list(range(L))
    fits16 = sel._select_smem_bytes(plan.B, -(-L // 16), itemsize, True) <= kernels.SMEM_BLOCK_MAX
    assert plan.staged == fits16
    assert sel._select_smem_bytes(plan.B, R, itemsize, plan.staged) <= kernels.SMEM_BLOCK_MAX
    # the groups' blocks cover the SMs where the rows allow 512 a block
    if plan.staged and groups * plan.K < 132:
        assert plan.K == 16 or -(-L // (2 * plan.K)) < 512
    # a block's keys within 64 KB where 16 blocks allow it, with the fewest blocks that do
    if plan.B * R * itemsize > 65_536:
        assert plan.K == 16
    elif plan.K > 1 and plan.B * -(-L // (plan.K // 2)) * itemsize <= 65_536:
        assert groups * (plan.K // 2) < 132 and -(-L // plan.K) >= 512


def test_select_plan_picks():
    """One column of 60000 spreads over a cluster of 16; the size-factor
    tile takes groups of 2 float32 (1 float64) columns on clusters of 8;
    8-block clusters where the card holds no 16; the staged/streamed edge."""
    assert sel._select_plan(1, 60_000, 4) == sel.SelectPlan(1, 16, True)
    assert sel._select_plan(1, 60_000, 4, k_max=8) == sel.SelectPlan(1, 8, True)
    assert sel._select_plan(100, 60_000, 4) == sel.SelectPlan(2, 8, True)
    assert sel._select_plan(1_000, 60_000, 4) == sel.SelectPlan(2, 8, True)
    assert sel._select_plan(100, 60_000, 8) == sel.SelectPlan(1, 8, True)
    assert sel._select_plan(100, 60_000, 4, adjacent=False) == sel.SelectPlan(1, 4, True)
    assert sel._select_plan(1, 1_000, 4) == sel.SelectPlan(1, 1, True)
    assert sel._select_plan(1, 2_048, 4) == sel.SelectPlan(1, 4, True)  # 512 rows a block
    edge = max(L for L in range(800_000, 1_000_000, 64)
               if sel._select_smem_bytes(1, -(-L // 16), 4, True) <= kernels.SMEM_BLOCK_MAX)
    assert sel._select_plan(1, edge, 4).staged and not sel._select_plan(1, edge + 64, 4).staged
    assert sel._select_smem_bytes(2, 7_500, 4, True) == 512 + 3 * 4_096 + 60_016  # 2 x 7501 keys, 16-aligned
    assert sel._select_smem_bytes(1, 3_750, 4, False) == 512 + 3 * 2_048


def _shapes_made(fn):
    """Run ``fn`` and return the element counts of every tensor an operator
    made on the way (TorchDispatchMode: every aten call, views included)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    made = []

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in out if isinstance(out, (tuple, list)) else (out,):
                if isinstance(t, torch.Tensor) and not func.is_view:
                    made.append(t.numel())
            return out

    with Record():
        fn()
    return made


@pytest.mark.parametrize("axis", [0, 1])
def test_select_wrapper_reads_the_tile_in_place(recorded, monkeypatch, axis):
    """``_order_stats_select_cuda`` hands the kernel the tile's own pointer
    and strides (columns adjacent for axis 0, rows for axis 1) and makes no
    tensor of the tile's size: no transposed copy."""
    monkeypatch.setattr(sel, "_select_k_max", lambda device, itemsize: 16)
    G, N = 6_000, 12
    x = torch.randn(G, N, dtype=torch.float32)
    if axis == 1:
        x = x.T.contiguous()  # (N, G), each sample's values contiguous
    ks = (torch.tensor(5), torch.tensor(6))
    made = _shapes_made(lambda: sel._order_stats_select_cuda(x, ks, axis))
    assert max(made) < G * N // 2
    ((name, a),) = recorded
    assert name == "select"
    _assert_marshalled(name, a)
    assert a[:4] == [0, x.data_ptr(), N, G]
    assert a[4:6] == ([1, N] if axis == 0 else [G, 1])
    plan = sel._select_plan(N, G, 4, adjacent=axis == 0)
    assert a[10:] == [plan.B, plan.K, int(plan.staged)]


def test_select_wrapper_one_column(recorded, monkeypatch):
    """A column (the prior's median, the keep quantile) goes to the kernel
    as it lies, on a cluster of more than one block; a given plan is
    handed on as it is."""
    monkeypatch.setattr(sel, "_select_k_max", lambda device, itemsize: 16)
    col = torch.randn(60_000, dtype=torch.float64)
    ks = (torch.tensor(29_999), torch.tensor(30_000))
    sel._order_stats_select_cuda(col[:, None], ks, 0)
    sel._order_stats_select_cuda(col[:, None], ks[:1], 0, plan=sel.SelectPlan(1, 4, False))
    (_, a0), (_, a1) = recorded
    assert a0[1] == col.data_ptr() and a0[2:4] == [1, 60_000] and a0[10] == 1 and a0[11] > 1
    assert a1[10:] == [1, 4, 0]


IRLS_CASES = [
    # (G, N, P): phase 1 and its phase-2 tile, wider rows, the atlas refit
    # block and its few hundred refitted genes, wide designs, the edges
    (60_000, 100, 2), (937, 100, 2), (60_000, 1_000, 2), (5_000, 10_000, 2), (600, 10_000, 2),
    (60_000, 100, 5), (60_000, 100, 8), (937, 100, 3), (1, 3, 1), (1, 1, 2), (4_000, 4_000, 2), (200_000, 12, 4),
]


@pytest.mark.parametrize("per_sm", [4, 2])
@pytest.mark.parametrize("G,N,P", IRLS_CASES)
def test_irls_plan_covers_and_fits(G, N, P, per_sm):
    """A group size built for the design: a block at atlas widths, else the
    fewest lanes of at most 16 samples each whose groups fill the card at
    ``per_sm`` blocks an SM (4 float32, fewer in float64), else 32."""
    plan = irl._irls_plan(G, N, P, per_sm=lambda lanes: per_sm)
    assert plan.lanes in irl._irls_lane_choices(P) + (irl._IRLS_BLOCK,)
    fits = [s for s in irl._irls_lane_choices(P) if s < 32 and G * s >= 132 * per_sm * 256 and -(-N // s) <= 16]
    assert plan.lanes == (irl._IRLS_BLOCK if N >= 2_048 else (fits[0] if fits else 32))


def test_irls_plan_picks():
    """8 lanes a gene at 100 x 60000, 4 at 12 and 50 samples, 32 at 200 and
    1000 samples and on the phase-2 tile, a block a gene at atlas widths."""
    assert irl._irls_plan(60_000, 100, 2) == irl.IrlsPlan(8)
    assert irl._irls_plan(60_000, 12, 2) == irl.IrlsPlan(4)
    assert irl._irls_plan(60_000, 50, 2) == irl.IrlsPlan(4)
    assert irl._irls_plan(60_000, 12, 5) == irl.IrlsPlan(8)
    assert irl._irls_plan(60_000, 200, 2) == irl.IrlsPlan(32)
    assert irl._irls_plan(937, 100, 2) == irl.IrlsPlan(32)
    assert irl._irls_plan(60_000, 1_000, 2) == irl.IrlsPlan(32)
    assert irl._irls_plan(600, 10_000, 2) == irl.IrlsPlan(256)
    assert irl._irls_plan(5_000, 10_000, 2) == irl.IrlsPlan(256)
    assert irl._irls_plan(60_000, 100, 5) == irl.IrlsPlan(8)


def test_irls_device_plan_asks_the_occupancy(monkeypatch):
    """The wrapper's plan fills the card by the blocks an SM holds as the
    occupancy helper reports them for the type, design and group size: at
    20000 genes of 100 samples 8 lanes fill 132 SMs of 2 blocks, not of 8."""
    calls = []

    def helper(name, args, device):
        calls.append((name, args))
        ctypes.c_int.from_address(args[-1]).value = per_sm

    monkeypatch.setattr(kernels, "call_helper", helper)
    monkeypatch.setattr(kernels, "sm_count", lambda device: 132)
    plans = {}
    for per_sm in (2, 8):
        irl._irls_card_per_sm.cache_clear()
        plans[per_sm] = irl._irls_device_plan(20_000, 100, 2, torch.float64, "cpu")
    irl._irls_card_per_sm.cache_clear()
    assert plans == {2: irl.IrlsPlan(8), 8: irl.IrlsPlan(32)}
    want = kernels._ARGTYPES[kernels.HELPERS["irls_per_sm"][1]]
    assert calls and all(name == "irls_per_sm" and len(args) == len(want) for name, args in calls)
    assert {tuple(args[:3]) for _, args in calls} == {(1, 2, 8)}


# disp_newton's row split (ops/dispersion.py:_newton_plan): (G, N, P, itemsize,
# blocks an SM holds on an H100, whether the plan splits). One warp a gene:
# brca.refit's gene blocks, the iterative size factors' P = 1 fits over a
# cohort's genes, chip_smoke.py's main draw and its float64 draw, an atlas's
# genes in one block; split: gtex.refit's gene blocks and its refit tile.
NEWTON_PLANS = [
    (30_336, 1_224, 2, 8, 2, False),
    (60_660, 1_224, 1, 8, 2, False),
    (60_000, 100, 2, 4, 3, False),
    (4_000, 100, 2, 8, 2, False),
    (56_200, 17_382, 2, 4, 3, False),
    (2_816, 17_382, 2, 4, 3, True),
    (2_880, 17_382, 2, 4, 3, True),
]


@pytest.mark.parametrize("G,N,P,itemsize,per_sm,split", NEWTON_PLANS)
def test_newton_plan_splits_where_the_card_is_short(G, N, P, itemsize, per_sm, split):
    """One warp a gene wherever the genes alone fill the card or the rows
    are short; several warps on short gene lists of wide rows; never fewer
    than the fewest samples a lane, never more warps than a block holds."""
    from pydeseq2_tpu_torch.ops import dispersion as dsp

    wg = dsp._newton_plan(G, N, 132, lambda w: per_sm)
    assert wg in dsp._NEWTON_WARPS
    assert (wg > 1) == split
    assert wg == 1 or N // (32 * wg) >= dsp._NEWTON_LANE_SAMPLES


@pytest.mark.parametrize("per_sm", [1, 2, 3, 4, 8])
def test_newton_plan_keeps_a_lane_samples_and_stops_once_filled(per_sm):
    """Over a grid of shapes: at least ``_NEWTON_LANE_SAMPLES`` samples a
    lane of a split row; one warp a gene where the unsplit blocks fill
    ``_NEWTON_WAVES`` waves; a split doubles only while the blocks of the
    split before it fell short of them."""
    from pydeseq2_tpu_torch.ops import dispersion as dsp

    slots = dsp._NEWTON_WAVES * 132 * per_sm
    for G in (1, 7, 100, 512, 2_816, 5_000, 12_671, 12_672, 30_336, 60_660):
        for N in (12, 100, 1_224, 4_095, 4_096, 8_192, 10_000, 16_383, 16_384, 17_382, 60_000):
            wg = dsp._newton_plan(G, N, 132, lambda w: per_sm)
            blocks = [-(-G // (dsp._NEWTON_BLOCK_WARPS // w)) for w in dsp._NEWTON_WARPS]
            assert wg == 1 or N // (32 * wg) >= dsp._NEWTON_LANE_SAMPLES, (G, N, wg)
            if blocks[0] >= slots:
                assert wg == 1, (G, N, wg)
            if wg > 1:
                assert blocks[dsp._NEWTON_WARPS.index(wg // 2)] < slots, (G, N, wg)
            if wg < dsp._NEWTON_WARPS[-1] and N >= 32 * 2 * wg * dsp._NEWTON_LANE_SAMPLES:
                assert blocks[dsp._NEWTON_WARPS.index(wg)] >= slots, (G, N, wg)


def test_newton_device_plan_asks_the_occupancy(monkeypatch):
    """The wrapper's plan asks the occupancy helper for the blocks an SM
    holds by type, design width, N and warps a gene, with one value a
    argtype: at 2816 x 17382 float32 the unsplit blocks fill 132 SMs of 1
    block four times over, not of 3."""
    from pydeseq2_tpu_torch.ops import dispersion as dsp

    calls = []

    def helper(name, args, device):
        calls.append((name, args))
        ctypes.c_int.from_address(args[-1]).value = per_sm

    monkeypatch.setattr(kernels, "call_helper", helper)
    monkeypatch.setattr(kernels, "sm_count", lambda device: 132)
    plans = {}
    for per_sm in (1, 3):
        dsp._newton_card_per_sm.cache_clear()
        plans[per_sm] = dsp._newton_device_plan(2_816, 17_382, 2, torch.float32, "cpu")
    dsp._newton_card_per_sm.cache_clear()
    assert plans == {1: 2, 3: 8}
    want = kernels._ARGTYPES[kernels.HELPERS["disp_newton_per_sm"][1]]
    assert calls and all(name == "disp_newton_per_sm" and len(args) == len(want) for name, args in calls)
    assert {tuple(args[:3]) for _, args in calls} == {(0, 2, 17_382)}
    assert {args[3] for _, args in calls} == {1, 2, 4}


def test_irls_core_cuda_route_makes_no_gn_tensor(recorded, monkeypatch):
    """``irls_core``'s CUDA route (``_irls_core_cuda``): the launcher gets its
    operands, the plan and a zeroed counter; nothing it runs makes a (G, N)
    tensor, and the PyTorch forms of the deviance constant are not called."""
    for name in ("nb_nll", "_mu_from_xb", "_mu_part"):
        monkeypatch.setattr(irl, name, lambda *a, **k: pytest.fail("a (G, N) PyTorch pass ran"))
    G, N, P = 300, 40, 2
    rng = np.random.default_rng(0)
    counts = torch.as_tensor(rng.poisson(20.0, (G, N)), dtype=torch.float32)
    X = torch.as_tensor(np.column_stack([np.ones(N), np.arange(N) % 2]), dtype=torch.float32)
    sf = torch.ones(N)
    disp = torch.full((G,), 0.1)
    beta0 = torch.zeros(G, P)
    monkeypatch.setattr(irl, "_irls_card_per_sm", lambda device, itemsize, P, lanes: irl._IRLS_PER_SM)
    kernels.STATS.reset()
    with tracing.enabled():  # the trips are recorded while tracing is on
        made = _shapes_made(lambda: irl._irls_core_cuda(counts, sf, X, disp, beta0, 0.5, 1e-6, 30.0, 8, 1e-5, 2))
    assert max(made) < G * N // 4
    ((name, a),) = recorded
    assert name == "irls"
    _assert_marshalled(name, a)
    assert a[:4] == [0, P, G, N] and a[4] == counts.data_ptr() and a[14:16] == [8, 2]
    assert a[16] == irl._irls_plan(G, N, P).lanes
    assert len(kernels.STATS.irls_trips) == 1


def test_irls_wrapper_refuses_unbuilt_groups(recorded):
    """A design past P = 3 has no 4-lane build: the wrapper raises."""
    G, N, P = 10, 20, 5
    x = torch.ones(G, N)
    with pytest.raises(ValueError, match="not built"):
        irl._irls_cuda(x, torch.ones(N), torch.ones(N, P), torch.ones(G), torch.zeros(G, P), torch.zeros(N), 0.5,
                       1e-6, 30.0, 8, 1e-5, 2, plan=irl.IrlsPlan(4))
    assert not recorded
