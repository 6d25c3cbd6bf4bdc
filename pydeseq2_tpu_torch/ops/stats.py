"""Robust statistics: trimmed moments, NaN-aware median and quantiles, BH
adjustment, lowess.

Port of ``pydeseq2_tpu/ops/stats.py``. The pipelines' Cook's-distance
trimmed moments run inside the ``cooks`` kernel (``ops/cooks.py``). The
independent filter's BH runs as the ``bh_count`` and ``bh_adjust`` kernels
through :func:`bh_rejections` and :func:`bh_adjust_row`.

Kernel (``csrc/trimmed.cu``): :func:`trimmed_mean`, :func:`trimmed_variance`
and :func:`trimmed_cell_variance` on CUDA tensors launch ``trimmed_var``,
which replaces ``trimmed_mean_select`` (pydeseq2_tpu/ops/select.py:166)
inside ``pydeseq2_tpu/ops/stats.py:28,88,108`` as the class API calls them
(the robust MoM dispersions of Cook's distances; the mean trend's trimmed
mean over a column of ~G dispersions). The launch plan (:func:`_trim_plan`,
shared with the ``cooks`` kernel) gives a warp or a block to each row: the
group stages each cohort's values once as monotone keys, in shared memory
or in a global workspace, and finds the two boundary order statistics by
counting ranks (short cohorts) or by an 8-bit radix select (long ones: 4
passes in float32, 8 in float64), then sums the kept values; the variances
form their squared errors from the staged keys and take the max over
cohorts in the same launch. The kept sum is taken in float64 and rounded
once, in the plain versions too, so in float32 kernel and plain version
agree to the bit but for rounding ties of that sum.

Kernels (``csrc/bh.cu``): replace the shared-order path of
``bh_adjust_masked`` (pydeseq2_tpu/ops/stats.py:145) as ``device_padj``
runs it, split the way its callers use it: one shared order of the
p-values (a stable ``torch.sort``, one library call), then the rejection
counts of every cutoff row (:func:`bh_rejections`, ``bh_count``) and the
adjusted values of the one row the lowess pick chooses
(:func:`bh_adjust_row`, ``bh_adjust``, its row index read on the card).
A row rejects where its adjusted value is below ``alpha``, and adjusted
values grow along the order, so a row's count is the rank of its last
masked position whose ``min(p * n_valid / rank, 1) < alpha``: the count
kernel gathers p, valid and base_mean through the order once for all rows,
in chunks over the whole card, and writes no (rows, G) matrix. The
adjusting kernel spreads one row over a thread-block cluster that walks
the order from the end with block-wide scans of the mask count (ranks)
and of the scaled values (suffix minima), exchanging chunk totals through
distributed shared memory. Both form the plain version's products and
quotients and min is exact, so they agree with it bit for bit.
:func:`bh_sweep` keeps the whole (rows, G) sweep, every row adjusted by
the same kernels.

Kernel (``csrc/lowess.cu``): :func:`lowess_pick` replaces ``lowess_device``
(pydeseq2_tpu/ops/stats.py:218) and the cutoff pick of ``device_padj``
(pydeseq2_tpu/fused.py:763-768) with one launch of one block: its threads
count the ranks of the n^2 staged distances for the bandwidths (the r-th
smallest of each row), the tricube weights replace the distances once,
then thread i owns filtering cutoff i, sums its local fit over the points
in index order each round and finds the median of |resid| by counting
ranks, and thread 0 picks the cutoff. Bound by launch latency (under 2 KB
of data), where the plain version is ~40 small launches.
"""

from __future__ import annotations

import itertools
import math
from typing import NamedTuple

import torch

from pydeseq2_tpu_torch import kernels
from pydeseq2_tpu_torch.ops.select import masked_median_select, order_stats_select_plain

# Phi^-1(0.75), the MAD's normal-consistency constant.
_NORM_PPF_075 = 0.6744897501960817


# JAX's trimmed_mean switches from the sort path to the select path here
# (pydeseq2_tpu/ops/stats.py:46).
_SELECT_MIN_N = 1024


def _kept_sum_mean(total64: torch.Tensor, n_kept: int, dtype) -> torch.Tensor:
    """The kept values' float64 sum rounded once to ``dtype``, over their
    count (the ``trimmed_var`` kernel's last step). The count is a 0-d
    tensor: a Python scalar divisor on the card becomes a product with its
    reciprocal."""
    return total64.to(dtype) / torch.tensor(n_kept, dtype=dtype, device=total64.device)


def _trimmed_mean_plain(x: torch.Tensor, trim: float, axis: int) -> torch.Tensor:
    """JAX's two paths (``pydeseq2_tpu/ops/stats.py:28``): the sort slice
    below n = 1024, ``trimmed_mean_select``'s kept multiset by order
    statistics at or above it; both sum the kept values in float64."""
    n = x.shape[axis]
    k = math.floor(n * trim)
    xm = x.movedim(axis, 0)
    if k == 0:
        return _kept_sum_mean(xm.sum(0, dtype=torch.float64), n, x.dtype)
    if n < _SELECT_MIN_N:
        kept = torch.sort(xm, dim=0).values[k:n - k]
        return _kept_sum_mean(kept.sum(0, dtype=torch.float64), n - 2 * k, x.dtype)
    lo, hi = order_stats_select_plain(xm, (k, n - 1 - k), axis=0)
    strict = torch.where((xm > lo) & (xm < hi), xm, torch.zeros_like(xm)).sum(0, dtype=torch.float64)
    copies_lo = ((xm <= lo).sum(0) - k).to(torch.float64)
    copies_hi = (n - k - (xm < hi).sum(0)).to(torch.float64)
    total = strict + lo.to(torch.float64) * copies_lo + hi.to(torch.float64) * copies_hi
    return torch.where(lo == hi, lo, _kept_sum_mean(total, n - 2 * k, x.dtype))


class TrimPlan(NamedTuple):
    """How the ``trimmed_var``, ``cooks`` and ``impute`` kernels reduce
    their rows (``csrc/trimmed.cuh``): one warp a row, 8 rows a 256-thread block, or
    with ``block`` one block of ``threads`` a row; a cohort of at most
    ``rank_max`` members takes the rank count, a longer one the radix
    select; the staged values in shared memory (``shared``), or in a global
    workspace of ``blocks`` slices, the grid then ``blocks`` blocks looping
    over the rows (``blocks`` 0 where shared)."""

    block: bool
    threads: int
    rank_max: int
    shared: bool
    blocks: int


_TRIM_WARPS = 8  # rows of a warp-mode block
_TRIM_RED_BYTES = 32 * (8 + 4)  # a block's reduction slots: a double and an int a warp, 32 warps
_TRIM_HIST_BYTES = 2 * 256 * 4  # the radix select's two 256-bin histograms
# The longest cohort the rank count takes, by itemsize: it costs n compares
# a key, the radix select 4 (float32) or 8 (float64) histogram passes. On
# the H100 the two tie near 96 members in both types (kernel_bench --detail
# --only cooks, PERF.md section 6).
_TRIM_RANK_MAX = {4: 96, 8: 96}
_TRIM_RANK_CAP = 128  # the kernels' limit of rank_max
# A warp-mode block's shared memory at most (3 blocks, 24 warps, an SM);
# rows whose slices need more take a block each.
_TRIM_WARP_SMEM = 64 * 1024


def _trim_group_bytes(buf_len: int, itemsize: int, radix: bool, shared: bool, block: bool) -> int:
    """Dynamic shared memory of one group (the kernels' ``trim_group_bytes``):
    a block's reduction slots, the ``buf_len`` staged keys where ``shared``,
    the radix histograms where ``radix``, two boundary keys."""
    staged = kernels.align16(buf_len * itemsize) if shared else 0
    return (_TRIM_RED_BYTES if block else 0) + staged + (_TRIM_HIST_BYTES if radix else 0) + 16


def _trim_plan(itemsize: int, sizes, rows: int, all_cohorts: bool, sms: int = 132) -> TrimPlan:
    """The plan for ``rows`` rows of ``itemsize``-byte values whose cohorts
    have ``sizes`` members; ``all_cohorts``: every cohort's keys are staged
    at once (``cooks``, and ``impute``'s one cohort of the row's N
    samples), else one cohort's at a time (``trimmed_var``).

    A warp a row where eight warps' slices fit ``_TRIM_WARP_SMEM``: short
    rows, many of them (100 samples, 60000 genes). Else a block a row, of
    1024 threads where the rows are fewer than the SMs (one column of
    dispersions), of 256 otherwise, with the staged keys in shared memory
    where they fit one block's 227 KB, else in a global workspace of one
    slice per block for at most two blocks an SM. Cohorts of at most
    ``_TRIM_RANK_MAX`` members take the rank count."""
    n_max = max(sizes)
    buf_len = sum(sizes) if all_cohorts else n_max
    rank_max = _TRIM_RANK_MAX[itemsize]
    radix = n_max > rank_max
    if _TRIM_WARPS * _trim_group_bytes(buf_len, itemsize, radix, True, False) <= _TRIM_WARP_SMEM:
        return TrimPlan(False, 32 * _TRIM_WARPS, rank_max, True, 0)
    threads = 1024 if rows < sms else 256
    if _trim_group_bytes(buf_len, itemsize, radix, True, True) <= kernels.SMEM_BLOCK_MAX:
        return TrimPlan(True, threads, rank_max, True, 0)
    return TrimPlan(True, threads, rank_max, False, min(rows, 2 * sms))


def _trim_ws_len(buf_len: int, itemsize: int) -> int:
    """Values in one block's slice of the streamed workspace (the kernels'
    ``trim_ws_len``): the keys, 16-byte aligned."""
    return kernels.align16(buf_len * itemsize) // itemsize


def _trim_plan_args(plan: TrimPlan, buf_len: int, dtype, device):
    """The kernels' plan arguments, and the workspace (``blocks`` slices of
    :func:`_trim_ws_len` values) where the plan streams, else None."""
    itemsize = torch.finfo(dtype).bits // 8
    ws = None if plan.shared else torch.empty(plan.blocks * _trim_ws_len(buf_len, itemsize), dtype=dtype,
                                              device=device)
    return [int(plan.block), plan.threads, plan.rank_max, int(plan.shared), plan.blocks], ws


def _trimmed_rows_cuda(rows: torch.Tensor, ks, scales=None, cohorts=None, plan=None) -> torch.Tensor:
    """Launch ``trimmed_var`` over the rows of ``rows`` (R, N): the trimmed
    mean dropping ``ks[0]`` at each end (``scales`` None), or the max over
    ``cohorts`` (lists of sample indices) of ``scales[c]`` times the
    cohort's trimmed variance dropping ``ks[c]``. ``plan`` (a
    :class:`TrimPlan`) overrides :func:`_trim_plan`."""
    R, N = rows.shape
    dev = rows.device
    rows = rows.contiguous()
    out = torch.empty(R, dtype=rows.dtype, device=dev)
    ks_t = torch.tensor(ks, dtype=torch.int32, device=dev)
    members = offsets = scales_t = None
    sizes = [N]
    if scales is not None:
        sizes = [len(c) for c in cohorts]
        members = torch.tensor([i for c in cohorts for i in c], dtype=torch.int32, device=dev)
        offsets = torch.tensor([0] + list(itertools.accumulate(sizes)), dtype=torch.int32, device=dev)
        scales_t = torch.tensor(scales, dtype=rows.dtype, device=dev)
    if plan is None:
        plan = _trim_plan(rows.element_size(), sizes, R, False, kernels.sm_count(dev))
    plan_args, ws = _trim_plan_args(plan, max(sizes), rows.dtype, dev)
    kernels.check_cuda_operands("trimmed_var", rows, scales_t, out, ks_t, members, offsets, ws)
    kernels.launch(
        "trimmed_var",
        [int(rows.dtype == torch.float64), R, N, int(scales is not None), rows.data_ptr(),
         kernels.ptr(members), kernels.ptr(offsets), 1 if cohorts is None else len(cohorts), ks_t.data_ptr(),
         kernels.ptr(scales_t), out.data_ptr(), *plan_args, max(sizes), kernels.ptr(ws)],
        dev,
    )
    return out


def _as_rows(x: torch.Tensor, axis: int):
    """``x`` with ``axis`` last, flattened to rows, and the shape of the rest."""
    xt = x.movedim(axis, -1)
    return xt.reshape(-1, xt.shape[-1]), xt.shape[:-1]


def trimmed_mean(x: torch.Tensor, trim: float = 0.1, axis: int = 0) -> torch.Tensor:
    """Mean after dropping ``floor(n * trim)`` entries at each end of the
    sorted axis (reference pydeseq2/utils.py:567-599).

    Port of ``pydeseq2_tpu/ops/stats.py:28``. CUDA tensors launch the
    ``trimmed_var`` kernel (the exact kept multiset by rank count or radix
    select, any n); CPU tensors take JAX's sort path below n = 1024 and its select
    semantics at or above it. Both sum the kept values in float64 and round
    once. Inputs must be finite: the select semantics drop a NaN where a
    sort would propagate it.
    """
    if not x.is_cuda:
        return _trimmed_mean_plain(x, trim, axis)
    rows, rest = _as_rows(x, axis)
    return _trimmed_rows_cuda(rows, [math.floor(rows.shape[1] * trim)]).reshape(rest)


def scipy_style_trim_mean(x: torch.Tensor, proportiontocut: float, axis: int = 0) -> torch.Tensor:
    """``scipy.stats.trim_mean`` as the mean trend calls it (reference
    pydeseq2/dds.py:505,1288): ``int(n * p)`` trimmed at each end, which is
    :func:`trimmed_mean` for the proportions used (0.001)."""
    return trimmed_mean(x, trim=proportiontocut, axis=axis)


def _trimmed_variance_plain(x: torch.Tensor, trim: float, axis: int) -> torch.Tensor:
    rm = _trimmed_mean_plain(x, trim, axis)
    sqerror = (x - rm.unsqueeze(axis)) ** 2
    return 1.51 * _trimmed_mean_plain(sqerror, trim, axis)


def trimmed_variance(x: torch.Tensor, trim: float = 0.125, axis: int = 0) -> torch.Tensor:
    """Trimmed variance with the 1.51 trimming-bias scale (reference
    pydeseq2/utils.py:653-679; ``pydeseq2_tpu/ops/stats.py:88``). CUDA
    tensors launch ``trimmed_var`` with one cohort of all entries."""
    if not x.is_cuda:
        return _trimmed_variance_plain(x, trim, axis)
    rows, rest = _as_rows(x, axis)
    n = rows.shape[1]
    return _trimmed_rows_cuda(rows, [math.floor(n * trim)], [1.51], [list(range(n))]).reshape(rest)


# (trim ratio, scale) by cohort-size bin: n < 3.5, n < 23.5, n >= 23.5
# (reference pydeseq2/utils.py:622-645).
_COHORT_TRIM_RATIOS = (1.0 / 3.0, 1.0 / 4.0, 1.0 / 8.0)
_COHORT_SCALES = (2.04, 1.86, 1.51)


def cohort_bin(n: int) -> int:
    return 2 if n >= 23.5 else 1 if n >= 3.5 else 0


def _cohorts(cells):
    """Sample indices of each cohort (levels in first-seen order) and its
    size bin."""
    cells = [int(c) for c in cells]
    cohorts = [[i for i, c in enumerate(cells) if c == lvl] for lvl in dict.fromkeys(cells)]
    return cohorts, [cohort_bin(len(idx)) for idx in cohorts]


def _trimmed_cell_variance_plain(counts: torch.Tensor, cells) -> torch.Tensor:
    var_ests = []
    for idx, b in zip(*_cohorts(cells)):
        trim, scale = _COHORT_TRIM_RATIOS[b], _COHORT_SCALES[b]
        sub = counts[torch.tensor(idx, device=counts.device), :]
        cell_means = _trimmed_mean_plain(sub, trim, 0)
        sqerror = (sub - cell_means[None, :]) ** 2
        var_ests.append(scale * _trimmed_mean_plain(sqerror, trim, 0))
    return torch.stack(var_ests, dim=0).amax(dim=0)


def _trimmed_cell_variance_cuda(counts: torch.Tensor, cells, plan=None) -> torch.Tensor:
    cohorts, bins = _cohorts(cells)
    ks = [math.floor(len(idx) * _COHORT_TRIM_RATIOS[b]) for idx, b in zip(cohorts, bins)]
    return _trimmed_rows_cuda(counts.T, ks, [_COHORT_SCALES[b] for b in bins], cohorts, plan)


def trimmed_cell_variance(counts: torch.Tensor, cells) -> torch.Tensor:
    """Max over cohorts of the cohort's trimmed variance.

    counts (N, G) sample-major; ``cells`` (N,) host cohort ids (levels in
    first-seen order). Reference pydeseq2/utils.py:602-650;
    ``pydeseq2_tpu/ops/stats.py:108``. CUDA tensors launch ``trimmed_var``
    once, one warp per gene over its cohorts; CPU tensors take the plain
    version.
    """
    fn = _trimmed_cell_variance_cuda if counts.is_cuda else _trimmed_cell_variance_plain
    return fn(counts, cells)


def mean_absolute_deviation(x: torch.Tensor) -> torch.Tensor:
    """Scaled median absolute deviation of a 1-D tensor (reference
    pydeseq2/utils.py:1210-1227; ``pydeseq2_tpu/ops/stats.py:136``), with
    ``jnp.median``'s NaN propagation. The medians run on the ``select``
    kernel for CUDA tensors."""
    center = _median_nan(x)
    return _median_nan(torch.abs(x - center)) / torch.tensor(_NORM_PPF_075, dtype=x.dtype, device=x.device)


def trimmed_mean_masked(values: torch.Tensor, sel: torch.Tensor, cut: float) -> torch.Tensor:
    """Trimmed mean over a dynamic lane selection (the mean-trend fallback).

    Deselected lanes sort to +inf and a rank-range mask replaces the slice,
    as in ``pydeseq2_tpu/ops/stats.py:67`` (scipy.stats.trim_mean semantics).
    """
    G = values.shape[0]
    inf = torch.full_like(values, float("inf"))
    sorted_vals = torch.sort(torch.where(sel, values, inf)).values
    n_sel = sel.sum()
    ntrim = torch.floor(n_sel.to(torch.float64) * cut).to(torch.int64)
    idx = torch.arange(G, device=values.device)
    in_range = (idx >= ntrim) & (idx < n_sel - ntrim)
    zero = torch.zeros_like(sorted_vals)
    safe = torch.where(torch.isinf(sorted_vals), zero, sorted_vals)
    return torch.where(in_range, safe, zero).sum() / torch.clamp(in_range.sum(), min=1)


def nanmedian(x: torch.Tensor) -> torch.Tensor:
    """Median of the non-NaN entries of a 1-D tensor (NaN if there are none).

    ``torch.nanmedian`` returns the LOWER middle value for an even count;
    ``jnp.nanmedian``, which the JAX pipeline uses for the dispersion prior
    (pydeseq2_tpu/fused.py:450-451), averages the two. This runs the exact
    order-statistic select on one column instead.
    """
    nan = torch.isnan(x)
    vals = torch.where(nan, torch.full_like(x, float("inf")), x)
    return masked_median_select(vals[:, None], (~nan).sum(), axis=0)[0]


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` rounded once, as a fused multiply-add rounds it.

    float32 is evaluated in float64 (the product is exact there); float64
    takes Dekker's exact product and a compensated sum, which rounds as an
    FMA except in halfway cases of the last bit.
    """
    if a.dtype == torch.float32:
        return (a.double() * b.double() + c.double()).float()
    split = 134217729.0  # 2**27 + 1

    def halves(x):
        t = split * x
        hi = t - (t - x)
        return hi, x - hi

    p = a * b
    ah, al = halves(a)
    bh, bl = halves(b)
    err = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    s = p + c
    bb = s - p
    return s + (((p - (s - bb)) + (c - bb)) + err)


def nanquantile(x: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """``jnp.nanquantile(x, q)`` ("linear") of a 1-D tensor, with its rounding.

    JAX forms ``lo * (1 - w) + hi * w`` at JAX's positions, and XLA
    contracts it to ``fma(hi, w, lo * (1 - w))``; ``torch.nanquantile``
    interpolates with ``lerp``, which rounds differently. One ulp of a
    cutoff moves a gene across ``base_mean >= cutoff`` (tied base means sit
    exactly on it), so the contraction is reproduced. Positions are computed
    in the dtype of ``q`` as JAX computes them.
    """
    s = torch.sort(x).values  # NaN sorts last
    counts = (~torch.isnan(s)).sum().to(q.dtype)
    pos = q * (counts - 1)
    low = torch.floor(pos)
    high = torch.ceil(pos)
    high_w = pos - low
    low_w = 1 - high_w
    top = counts - 1
    low = torch.clamp(torch.minimum(low, top), min=0).to(torch.int64)
    high = torch.clamp(torch.minimum(high, top), min=0).to(torch.int64)
    return _fma(s[high].to(q.dtype), high_w, s[low].to(q.dtype) * low_w).to(x.dtype)


def _bh_shared_order(p: torch.Tensor, order: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """BH of a 1-D ``p`` under each row of ``mask`` (..., G), sharing one
    ascending order of ``p``: NaN outside the mask. Each row's masked subset
    keeps its relative order under the shared sort, so its rank is a cumsum
    of the sorted mask (pydeseq2_tpu/ops/stats.py:175-190)."""
    n_valid = mask.sum(dim=-1, keepdim=True)
    p_sorted = p[order]
    mask_sorted = mask[..., order]
    ranks = torch.cumsum(mask_sorted.to(p.dtype), dim=-1)
    scaled = torch.where(
        mask_sorted,
        p_sorted * n_valid / torch.clamp(ranks, min=1.0),
        torch.full_like(ranks, float("inf")),
    )
    adj_sorted = torch.clamp(cummin_reverse(scaled), max=1.0)
    adj = torch.empty_like(adj_sorted)
    adj[..., order] = adj_sorted
    return torch.where(mask, adj, torch.full_like(adj, float("nan")))


def cummin_reverse(x: torch.Tensor) -> torch.Tensor:
    """Running minimum from the right along the last axis."""
    return torch.flip(torch.cummin(torch.flip(x, (-1,)), dim=-1).values, (-1,))


def _bh_masks(p, valid, base_mean, cutoffs) -> torch.Tensor:
    """(rows, G) masks: ``base_mean >= cutoffs[j] & valid & ~isnan(p)``, one
    row of ``valid & ~isnan(p)`` without cutoffs."""
    masks = valid[None, :] if base_mean is None else (base_mean[None, :] >= cutoffs[:, None]) & valid[None, :]
    return masks & ~torch.isnan(p)


def _bh_sweep_plain(p, order, valid, base_mean, cutoffs, alpha):
    adj = _bh_shared_order(p, order, _bh_masks(p, valid, base_mean, cutoffs))
    return adj, (adj < alpha).sum(dim=1)


def _bh_count_plain(p, order, valid, base_mean, cutoffs, alpha):
    """Each row's count of adjusted values below ``alpha`` as the rank of its
    last masked position whose clipped scaled value is below ``alpha``."""
    masks = _bh_masks(p, valid, base_mean, cutoffs)
    if p.shape[0] == 0:
        return torch.zeros(masks.shape[0], dtype=torch.int64, device=p.device)
    n_valid = masks.sum(dim=-1, keepdim=True)
    mask_sorted = masks[:, order]
    ranks = torch.cumsum(mask_sorted.to(p.dtype), dim=-1)
    scaled = p[order] * n_valid / torch.clamp(ranks, min=1.0)
    hit = mask_sorted & (torch.clamp(scaled, max=1.0) < alpha)
    return torch.where(hit, ranks, torch.zeros_like(ranks)).amax(dim=-1).to(torch.int64)


def _bh_adjust_plain(p, order, valid, base_mean, cutoffs, j):
    """Row ``j`` (a 0-d integer tensor) of the sweep, (1, G); every row,
    (rows, G), when ``j`` is None."""
    if cutoffs is not None and j is not None:
        cutoffs = cutoffs.index_select(0, j.reshape(1).to(torch.int64))
    return _bh_shared_order(p, order, _bh_masks(p, valid, base_mean, cutoffs))


class BhCountPlan(NamedTuple):
    """A launch of ``bh_count``: ``chunk`` sorted positions a block (a
    multiple of its 512 threads), ``blocks`` chunks."""

    chunk: int
    blocks: int


_BH_THREADS = 512  # threads of the count kernels, positions a tile (csrc/bh.cu CT)
_BH_MAX_ROWS = 256  # cutoff rows a count launch
_BH_BLOCKS_PER_SM = 2  # count blocks an SM takes at most: each block sums every chunk's counts


def _bh_count_plan(G: int, sms: int = 132) -> BhCountPlan:
    """One tile of 512 positions a block while that takes at most two
    blocks an SM (G <= 135168 on 132 SMs), else the tiles shared evenly
    over that many blocks: a block reads every block's row counts, so the
    blocks are kept few."""
    tiles = max(1, -(-G // _BH_THREADS))
    per_block = -(-tiles // (_BH_BLOCKS_PER_SM * sms))
    chunk = per_block * _BH_THREADS
    return BhCountPlan(chunk, max(1, -(-G // chunk)))


def _bh_operands(p, order, valid, base_mean, cutoffs):
    """The kernels' operands: base_mean and cutoffs widened to p's dtype
    (exact; the comparison keeps its result), int32 order, uint8 valid."""
    if base_mean is not None:
        base_mean = base_mean.to(p.dtype).contiguous()
        cutoffs = cutoffs.to(p.dtype).contiguous()
    ops = p.contiguous(), order.to(torch.int32).contiguous(), valid.to(torch.uint8).contiguous()
    return (*ops, base_mean, cutoffs)


def _bh_count_cuda(p, order, valid, base_mean, cutoffs, alpha):
    G = p.shape[0]
    rows = 1 if cutoffs is None else cutoffs.shape[0]
    p, order32, valid8, base_mean, cutoffs = _bh_operands(p, order, valid, base_mean, cutoffs)
    plan = _bh_count_plan(G, kernels.sm_count(p.device))
    num_rej = torch.empty(rows, dtype=torch.int64, device=p.device)
    p_sorted = torch.empty_like(p)
    k_sorted = torch.empty(G, dtype=torch.int16, device=p.device)
    cnt = torch.empty(plan.blocks * min(rows, _BH_MAX_ROWS), dtype=torch.int32, device=p.device)
    kernels.check_cuda_operands("bh_count", p, base_mean, cutoffs, order32, valid8, num_rej, k_sorted, cnt)
    for r0 in range(0, rows, _BH_MAX_ROWS):
        r1 = min(rows, r0 + _BH_MAX_ROWS)
        kernels.launch(
            "bh_count",
            [
                int(p.dtype == torch.float64), r1 - r0, G, plan.chunk,
                p.data_ptr(), order32.data_ptr(), valid8.data_ptr(),
                kernels.ptr(base_mean), None if cutoffs is None else cutoffs[r0:r1].data_ptr(), float(alpha),
                p_sorted.data_ptr(), k_sorted.data_ptr(), cnt.data_ptr(), num_rej[r0:r1].data_ptr(),
            ],
            p.device,
        )
    return num_rej


def _bh_adjust_cuda(p, order, valid, base_mean, cutoffs, j, cluster: int = 0):
    """Row ``j`` (a 0-d integer tensor on the card), (1, G), or every row,
    (rows, G), when ``j`` is None; ``cluster`` blocks a row (0: the
    kernel's choice, the fewest that cover G in one round)."""
    G = p.shape[0]
    rows = 1 if cutoffs is None else cutoffs.shape[0]
    p, order32, valid8, base_mean, cutoffs = _bh_operands(p, order, valid, base_mean, cutoffs)
    j64 = None if j is None else j.reshape(()).to(torch.int64).contiguous()
    n_out = 1 if j is not None else rows
    adj = torch.empty((n_out, G), dtype=p.dtype, device=p.device)
    kernels.check_cuda_operands("bh_adjust", p, base_mean, cutoffs, adj, order32, valid8, j64)
    kernels.launch(
        "bh_adjust",
        [
            int(p.dtype == torch.float64), rows, G,
            p.data_ptr(), order32.data_ptr(), valid8.data_ptr(), kernels.ptr(base_mean), kernels.ptr(cutoffs),
            kernels.ptr(j64), n_out, int(cluster), adj.data_ptr(),
        ],
        p.device,
    )
    return adj


def _bh_sweep_cuda(p, order, valid, base_mean, cutoffs, alpha):
    return (_bh_adjust_cuda(p, order, valid, base_mean, cutoffs, None),
            _bh_count_cuda(p, order, valid, base_mean, cutoffs, alpha))


def bh_rejections(
    p: torch.Tensor,
    order: torch.Tensor,
    valid: torch.Tensor,
    base_mean: torch.Tensor | None = None,
    cutoffs: torch.Tensor | None = None,
    alpha: float = 0.05,
) -> torch.Tensor:
    """The rejection counts ``num_rej`` (rows,) int64 of :func:`bh_sweep`,
    ``(adj < alpha).sum(1)``, without the adjusted matrix. CUDA tensors
    launch the ``bh_count`` kernel; CPU tensors take the plain version."""
    fn = _bh_count_cuda if p.is_cuda else _bh_count_plain
    return fn(p, order, valid, base_mean, cutoffs, alpha)


def bh_adjust_row(
    p: torch.Tensor,
    order: torch.Tensor,
    valid: torch.Tensor,
    base_mean: torch.Tensor | None = None,
    cutoffs: torch.Tensor | None = None,
    j: torch.Tensor | None = None,
) -> torch.Tensor:
    """Row ``j`` (G,) of :func:`bh_sweep`'s adjusted values: ``j`` a 0-d
    integer tensor on ``p``'s device (the lowess pick's, no host read), row
    0 when None (the one row without cutoffs). CUDA tensors launch the
    ``bh_adjust`` kernel; CPU tensors take the plain version."""
    if j is None and cutoffs is not None:
        j = torch.zeros((), dtype=torch.int64, device=p.device)
    fn = _bh_adjust_cuda if p.is_cuda else _bh_adjust_plain
    return fn(p, order, valid, base_mean, cutoffs, j)[0]


def bh_sweep(
    p: torch.Tensor,
    order: torch.Tensor,
    valid: torch.Tensor,
    base_mean: torch.Tensor | None = None,
    cutoffs: torch.Tensor | None = None,
    alpha: float = 0.05,
):
    """BH adjustment of ``p`` (G,) under one mask per row, sharing ``order``
    (a stable ascending sort of ``p``): ``(adj (rows, G), num_rej (rows,))``.

    Row j's mask is ``base_mean >= cutoffs[j] & valid`` (one row of
    ``valid`` when ``cutoffs`` is None); ``num_rej`` counts ``adj < alpha``.
    A NaN p inside the mask counts as unmasked; adjusted values are clipped
    at 1 and NaN outside the mask. This is the shared-order path of
    ``bh_adjust_masked`` (``pydeseq2_tpu/ops/stats.py:145``, scipy's
    ``false_discovery_control``). CUDA tensors launch ``bh_adjust`` over
    every row and ``bh_count``; CPU tensors take the plain version. The
    pipelines need one row of it: :func:`bh_rejections` and
    :func:`bh_adjust_row`.
    """
    if p.is_cuda:
        return _bh_sweep_cuda(p, order, valid, base_mean, cutoffs, alpha)
    return _bh_sweep_plain(p, order, valid, base_mean, cutoffs, alpha)


def _median_nan(x: torch.Tensor) -> torch.Tensor:
    """``jnp.median`` of a 1-D tensor: the mean of the middle pair, NaN if
    any entry is NaN."""
    return torch.where(torch.isnan(x).any(), torch.full_like(x[0], float("nan")), nanmedian(x))


def _sum_in_order(m: torch.Tensor) -> torch.Tensor:
    """Sum over dim 0 one row at a time, in index order: the order in which
    the ``lowess`` kernel's thread for each point adds its terms."""
    acc = m[0]
    for row in m[1:]:
        acc = acc + row
    return acc


def lowess_device(
    features: torch.Tensor, targets: torch.Tensor, frac: float = 2.0 / 3.0, it: int = 3
) -> torch.Tensor:
    """Tricube-weighted robust local linear regression over a small grid
    (the 50 independent-filtering cutoffs): closed-form 2x2 weighted least
    squares per point and ``it`` robustifying rounds. Port of
    ``pydeseq2_tpu/ops/stats.py:218`` (reference pydeseq2/utils.py:1379-1443).
    The weighted sums run over the points in index order, as the kernel's
    do: each local determinant sw swff - swf^2 cancels ~100x over a 10-point
    window, so another order would move the fit well above eps."""
    f = features
    y = targets.to(f.dtype)
    n = f.shape[0]
    r = int(math.ceil(frac * n))
    dists = torch.abs(f[:, None] - f[None, :])
    h = torch.clamp(torch.sort(dists, dim=1).values[:, r], min=1e-12)
    w = torch.clamp(dists / h[None, :], 0.0, 1.0)
    w = (1.0 - w**3) ** 3  # column i: weights of the local fit at i

    delta = torch.ones(n, dtype=f.dtype, device=f.device)
    for _ in range(it):
        weights = delta[:, None] * w
        terms = torch.stack([weights, weights * f[:, None], weights * (f * f)[:, None], weights * y[:, None],
                             weights * (y * f)[:, None]], dim=1)
        sw, swf, swff, b0, b1 = _sum_in_order(terms)
        det = sw * swff - swf**2
        beta0 = (b0 * swff - b1 * swf) / det
        beta1 = (sw * b1 - swf * b0) / det
        yest = beta0 + beta1 * f
        resid = y - yest
        s = _median_nan(torch.abs(resid))
        delta = torch.where(
            s == 0,
            (torch.abs(resid) > 0).to(f.dtype),
            torch.clamp(resid / (6.0 * s), -1.0, 1.0),
        )
        delta = (1.0 - delta**2) ** 2
    return yest


def _lowess_pick_plain(theta: torch.Tensor, num_rej: torch.Tensor, frac: float):
    rej = num_rej.to(theta.dtype)
    lo = lowess_device(theta, rej, frac=frac)
    nan = torch.tensor(float("nan"), dtype=theta.dtype, device=theta.device)
    sq = torch.where(num_rej > 0, rej - lo, nan) ** 2
    kept = ~torch.isnan(sq)
    # nanmean, summed in index order (0/0, NaN, when no count is positive)
    ssum = _sum_in_order(torch.where(kept, sq, torch.zeros_like(sq))[:, None])[0]
    thresh = lo.amax() - torch.sqrt(ssum / kept.sum().to(sq.dtype))
    above = num_rej > thresh
    j = torch.where(above.any(), torch.argmax(above.to(torch.uint8)), 0)
    return lo, torch.where(num_rej.amax() <= 10, 0, j)


def _lowess_pick_cuda(theta: torch.Tensor, num_rej: torch.Tensor, frac: float):
    n = theta.shape[0]
    theta = theta.contiguous()
    rej = num_rej.to(torch.int64).contiguous()
    yest = torch.empty_like(theta)
    j = torch.empty((), dtype=torch.int64, device=theta.device)
    kernels.check_cuda_operands("lowess", theta, rej, yest, j)
    if not 0 < n <= 64:
        raise ValueError(f"lowess: {n} points; the kernel takes 1 to 64")
    kernels.launch(
        "lowess",
        [int(theta.dtype == torch.float64), n, int(math.ceil(frac * n)), 3, theta.data_ptr(), rej.data_ptr(),
         yest.data_ptr(), j.data_ptr()],
        theta.device,
    )
    return yest, j


def lowess_pick(theta: torch.Tensor, num_rej: torch.Tensor, frac: float = 1.0 / 5.0):
    """The independent-filtering cutoff: ``(yest (n,), j)``.

    :func:`lowess_device` (3 robust rounds) of the rejection counts
    ``num_rej`` (n,) int64 over the quantiles ``theta`` (n,), then the
    pick of ``pydeseq2_tpu/fused.py:763-768``: ``j`` (a 0-d int64 tensor)
    is the first row whose count exceeds max(yest) less the RMS of the
    residuals where the count is positive, 0 if none does (a NaN threshold
    included) or if no row has more than 10 rejections. CUDA tensors launch
    the ``lowess`` kernel (n <= 64); CPU tensors take the plain version.
    """
    fn = _lowess_pick_cuda if theta.is_cuda else _lowess_pick_plain
    return fn(theta, num_rej, frac)
