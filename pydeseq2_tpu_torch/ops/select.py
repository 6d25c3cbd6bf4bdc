"""Exact order statistics per column — the size-factor medians.

Port of ``pydeseq2_tpu/ops/select.py``. Floats map to integer keys whose
order is the IEEE total order (negative values bit-complemented, NaN with
the sign bit clear above +inf), so the k-th smallest KEY decodes to exactly
the element a sort would put at rank k: ties, +/-inf, signed zeros and
excluded (+inf) entries included. Callers encode excluded entries as +inf
and restrict the ranks to the valid count, as in the JAX package.

Kernel (``csrc/select.cu``): replaces ``order_stats_select``
(pydeseq2_tpu/ops/select.py:65), the MSB-first radix bisection of the JAX
package. The wrapper hands the kernel the tile where it lies, with its
strides: no transposed copy. :func:`_select_plan` groups B adjacent
columns (8 bytes of a row) and splits a group's rows over a thread-block
cluster of K blocks, so that the groups' blocks cover the card's SMs and
each block's keys fit its shared memory: one column of 60000 takes a
cluster of 16 blocks, not one block on one SM. A block maps
its values to keys once, into shared memory; each pass histograms the next
8-bit digit of the keys that still match a rank's prefix (compacting them
in place from the second pass), the cluster adds its blocks' integer
histograms over distributed shared memory, and every block picks the same
digit: 4 passes in float32, 8 in float64 (a ``kernel_bench`` sweep of
8-11-bit digits found 8 the fastest at every shape: with the candidates
compacted, a pass costs little, and wider digits pay for the scan and
exchange of their bins). Where the keys do not fit 16 blocks,
each pass streams them from device memory again. The result is
bit-identical to a sort.

The plain version (CPU tensors only) sorts the keys and gathers the ranks.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from pydeseq2_tpu_torch import kernels


def _monotone_key(x: torch.Tensor) -> torch.Tensor:
    """Signed integer keys with x < y  <=>  key(x) < key(y) (sign-flip map).

    The map is an involution on the bit patterns, so :func:`_key_to_float`
    applies it again. It orders like the JAX package's unsigned keys (the
    two differ only in the top bit).
    """
    if x.dtype == torch.float32:
        i = x.view(torch.int32)
        return i ^ ((i >> 31) & 0x7FFFFFFF)
    if x.dtype == torch.float64:
        i = x.view(torch.int64)
        return i ^ ((i >> 63) & 0x7FFFFFFFFFFFFFFF)
    raise TypeError(f"unsupported dtype {x.dtype}")


def _key_to_float(key: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    bits = 31 if dtype == torch.float32 else 63
    mask = (1 << bits) - 1
    return (key ^ ((key >> bits) & mask)).view(dtype)


def order_stats_select_plain(
    x: torch.Tensor, ranks: tuple[torch.Tensor, ...], axis: int = 0
) -> tuple[torch.Tensor, ...]:
    """Plain version: sort the keys along ``axis`` and gather each rank."""
    keys = _monotone_key(x).movedim(axis, 0)
    red_shape = keys.shape[1:]
    srt = keys.sort(dim=0).values
    out = []
    for k in ranks:
        k = torch.as_tensor(k, dtype=torch.int64, device=x.device).expand(red_shape)
        out.append(_key_to_float(srt.gather(0, k[None]).squeeze(0), x.dtype))
    return tuple(out)


class SelectPlan(NamedTuple):
    """A launch of the ``select`` kernel: ``B`` adjacent columns a cluster
    (1 or 2), ``K`` blocks a cluster (each a 1/K share of the rows), the
    keys ``staged`` in shared memory (else streamed each pass)."""

    B: int
    K: int
    staged: bool


_SELECT_STATE_BYTES = 512  # the columns' prefixes, ranks, counts and flags (csrc/select.cu)
_SELECT_BINS = 256  # bins of a (column, rank): 8-bit digits
_SELECT_SPAN_BYTES = 8  # a group's share of a row
_SELECT_BLOCK_KEY_BYTES = 65_536  # a block's staged keys, at most, where K allows
_SELECT_MIN_ROWS = 512  # a block's share of the rows, at least (one per thread)


def _select_smem_bytes(B: int, R: int, itemsize: int, staged: bool) -> int:
    """Dynamic shared memory of a block of ``R`` rows: the columns' state,
    three bin arrays (two histogram buffers, the gathered totals) of B x 2
    ranks x 256 counts, and in shared mode the keys, B columns of R | 1."""
    bins = 3 * kernels.align16(B * 2 * _SELECT_BINS * 4)
    keys = kernels.align16(B * (R | 1) * itemsize) if staged else 0
    return _SELECT_STATE_BYTES + bins + keys


def _select_plan(C: int, L: int, itemsize: int, adjacent: bool = True, sms: int = 132,
                 k_max: int = kernels.MAX_CLUSTER) -> SelectPlan:
    """The plan for C columns of L values of ``itemsize`` bytes.

    B: where the columns are adjacent in memory, those in 8 bytes of a row
    (2 float32, 1 float64; fewer where C is smaller), else 1. A
    ``kernel_bench`` sweep on an H100 found 32-byte groups (8 float32
    columns, each row's span one sector) slower, 0.202 against 0.146 ms at
    100 x 60000 and 1.84 against 1.05 at 1000 x 60000: a block's work and
    shared memory grow with B, and the neighbouring groups read the rest of
    each sector from L2. K: the fewest blocks (a power of two, at
    most ``k_max``) whose share of the keys takes at most 64 KB, raised
    until the groups' blocks cover ``sms`` SMs while a block keeps at least
    512 rows: a column of 60000 takes 16. Staged where that share fits a
    block's shared memory, else streamed.
    """
    B = 1
    if adjacent and C > 1:
        while B * 2 <= min(_SELECT_SPAN_BYTES // itemsize, C):
            B *= 2
    groups = -(-C // B)
    k_cover = 1
    while k_cover < k_max and groups * k_cover < sms:
        k_cover *= 2
    k_rows = 1
    while k_rows < k_max and -(-L // (k_rows * 2)) >= _SELECT_MIN_ROWS:
        k_rows *= 2
    k_keys = 1
    while k_keys < k_max and B * -(-L // k_keys) * itemsize > _SELECT_BLOCK_KEY_BYTES:
        k_keys *= 2
    K = max(k_keys, min(k_cover, k_rows))
    staged = _select_smem_bytes(B, -(-L // K), itemsize, True) <= kernels.SMEM_BLOCK_MAX
    return SelectPlan(B, K, staged)


@functools.lru_cache(maxsize=None)
def _select_k_max(device: torch.device, itemsize: int) -> int:
    """16 where the card holds a cluster of 16 blocks of the most shared
    memory a block may have (the occupancy API for this build; no launch),
    else 8."""
    out = ctypes.c_int(0)
    kernels.call_helper("select_max_clusters", [int(itemsize == 8), kernels.MAX_CLUSTER, kernels.SMEM_BLOCK_MAX,
                                                ctypes.addressof(out)], device)
    return kernels.MAX_CLUSTER if out.value >= 1 else 8


def _select_device_plan(C: int, L: int, dtype, device, adjacent: bool = True) -> SelectPlan:
    """:func:`_select_plan` with the card's SMs and its largest cluster."""
    isz = torch.empty((), dtype=dtype).element_size()
    dev = torch.device(device)
    return _select_plan(C, L, isz, adjacent, kernels.sm_count(dev), _select_k_max(dev, isz))


def _order_stats_select_cuda(
    x: torch.Tensor, ranks: tuple[torch.Tensor, ...], axis: int, plan: SelectPlan | None = None
) -> tuple[torch.Tensor, ...]:
    """Launch the ``select`` kernel on ``x`` where it lies (its strides, no
    copy, wherever the reduced axes flatten to one as a view: every 2-D
    ``x``); ``plan`` overrides :func:`_select_device_plan`."""
    if len(ranks) not in (1, 2):
        raise ValueError("the select kernel resolves one or two ranks per column")
    if x.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"order_stats_select: unsupported dtype {x.dtype}")
    xt = x.movedim(axis, -1)
    red_shape = xt.shape[:-1]
    L = xt.shape[-1]
    cols = xt.reshape(-1, L)  # a view of x for a 2-D x (a copy only for N-d layouts that need one)
    C = cols.shape[0]
    s_col, s_row = cols.stride()
    ks = [
        torch.as_tensor(k, dtype=torch.int32, device=x.device)
        .expand(red_shape)
        .reshape(C)
        .contiguous()
        for k in ranks
    ]
    k_hi = ks[-1]
    out_lo = torch.empty(C, dtype=x.dtype, device=x.device)
    out_hi = torch.empty(C, dtype=x.dtype, device=x.device)
    kernels.check_cuda_operands("order_stats_select", out_lo, out_hi)
    kernels.check_cuda_device("order_stats_select", cols)
    if plan is None:
        plan = _select_device_plan(C, L, x.dtype, x.device, adjacent=s_col == 1)
    kernels.launch(
        "select",
        [
            int(x.dtype == torch.float64),
            cols.data_ptr(),
            C,
            L,
            s_col,
            s_row,
            ks[0].data_ptr(),
            k_hi.data_ptr(),
            out_lo.data_ptr(),
            out_hi.data_ptr(),
            plan.B,
            plan.K,
            int(plan.staged),
        ],
        x.device,
    )
    res = (out_lo.reshape(red_shape), out_hi.reshape(red_shape))
    return res[:1] if len(ranks) == 1 else res


def order_stats_select(
    x: torch.Tensor, ranks: tuple[torch.Tensor, ...], axis: int = 0
) -> tuple[torch.Tensor, ...]:
    """Exact k-th smallest elements of ``x`` along ``axis``, one per rank.

    ``x`` is float32/float64 with excluded entries encoded as +inf; ``ranks``
    are 0-based integer ranks broadcastable to the reduced shape, within the
    valid count. Returns values bit-identical to ``sort(x, axis)[k]``.
    CUDA tensors launch the radix-select kernel on ``x`` where it lies; CPU
    tensors take the plain version.
    """
    if x.shape[axis] == 0:
        red = x.movedim(axis, 0).shape[1:]
        return tuple(torch.full(red, float("nan"), dtype=x.dtype, device=x.device) for _ in ranks)
    if x.is_cuda:
        return _order_stats_select_cuda(x, ranks, axis)
    return order_stats_select_plain(x, ranks, axis)


def masked_median_select(
    values: torch.Tensor, n_valid: torch.Tensor, axis: int = 0
) -> torch.Tensor:
    """Median over the valid entries of ``values`` along ``axis``.

    ``values`` holds +inf at excluded entries and ``n_valid`` the per-column
    count of valid ones. Averages the two middle order statistics as
    ``np.median`` does; columns with ``n_valid == 0`` give NaN.
    """
    n_valid = torch.as_tensor(n_valid, dtype=torch.int64, device=values.device)
    k_lo = torch.clamp((n_valid - 1) // 2, min=0)
    k_hi = n_valid // 2
    v_lo, v_hi = order_stats_select(values, (k_lo, k_hi), axis=axis)
    med = (v_lo + v_hi) / 2.0
    return torch.where(n_valid > 0, med, torch.full_like(med, float("nan")))


# ------------------------------------------------------ the sharded median
# A radix select whose keys are spread over the ranks of a gene mesh: each
# pass histograms the next 8-bit digit of the local keys that match the
# prefix resolved so far (the ``select_hist`` kernel, ``csrc/select.cu``),
# the ranks add their integer histograms (an all-reduce), and every rank
# picks the same digit from the same totals. The keys are the unsigned
# ones of the kernels (a float's bits, the sign bit set on non-negatives,
# every bit flipped on negatives), digits MSB first.
_HIST_COLS = 16  # columns a select_hist block (csrc/select.cu)
_HIST_MIN_ROWS = 256  # rows a block, at least


def _passes(dtype: torch.dtype) -> int:
    return 4 if dtype == torch.float32 else 8


def _unsigned_key(x: torch.Tensor) -> torch.Tensor:
    """The kernels' unsigned keys as int64 bit patterns (float64: the
    pattern of the 64-bit key; float32: the 32-bit key, zero-extended)."""
    if x.dtype == torch.float32:
        u = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
        return torch.where(u >= 0x80000000, ~u & 0xFFFFFFFF, u | 0x80000000)
    if x.dtype == torch.float64:
        i = x.contiguous().view(torch.int64)
        return torch.where(i < 0, ~i, i ^ torch.iinfo(torch.int64).min)
    raise TypeError(f"unsupported dtype {x.dtype}")


def _prefix_of(digits: torch.Tensor, pass_: int) -> torch.Tensor:
    """(C, 2) int64: the value of the first ``pass_`` digits (MSB first)."""
    p = torch.zeros(digits.shape[:2], dtype=torch.int64, device=digits.device)
    for j in range(pass_):
        p = (p << 8) | digits[..., j].to(torch.int64)
    return p


def select_hist_plain(x: torch.Tensor, digits: torch.Tensor, pass_: int, axis: int = 0) -> torch.Tensor:
    """Plain version of ``select_hist``: (C, 2, 256) int32 counts of pass
    ``pass_``'s digit of the keys along ``axis`` that match each (column,
    rank)'s prefix, a ``torch.bincount`` of the masked digits."""
    keys = _unsigned_key(x).movedim(axis, -1)
    keys = keys.reshape(-1, keys.shape[-1])  # (C, L)
    C = keys.shape[0]
    bits = 32 if x.dtype == torch.float32 else 64
    shift = bits - 8 * (pass_ + 1)
    digit = (keys >> shift) & 0xFF
    if pass_:
        top = (keys >> (bits - 8 * pass_)) & ((1 << (8 * pass_)) - 1)
        match = top[:, None, :] == _prefix_of(digits, pass_)[:, :, None]  # (C, 2, L)
    else:
        match = torch.ones((C, 2, keys.shape[1]), dtype=torch.bool, device=x.device)
    bins = (torch.arange(C * 2, device=x.device).reshape(C, 2, 1) * 256 + digit[:, None, :])[match]
    return torch.bincount(bins, minlength=C * 2 * 256).reshape(C, 2, 256).to(torch.int32)


def _hist_rows(C: int, L: int, sms: int = 132) -> int:
    """Rows a ``select_hist`` block: split each 16-column group's rows so
    that the blocks cover the SMs four times, a block keeping at least 256
    rows."""
    groups = -(-C // _HIST_COLS)
    splits = max(1, min(-(-L // _HIST_MIN_ROWS), -(-4 * sms // groups)))
    return -(-L // splits)


def _select_hist_cuda(x: torch.Tensor, digits: torch.Tensor, pass_: int, axis: int = 0) -> torch.Tensor:
    """Launch ``select_hist`` on ``x`` where it lies (its strides; a view of
    a 2-D ``x``)."""
    if x.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"select_hist: unsupported dtype {x.dtype}")
    cols = x.movedim(axis, -1)
    cols = cols.reshape(-1, cols.shape[-1])
    C, L = cols.shape
    s_col, s_row = cols.stride()
    npass = _passes(x.dtype)
    if digits.shape != (C, 2, npass) or digits.dtype != torch.uint8:
        raise ValueError(f"select_hist: digits must be ({C}, 2, {npass}) uint8")
    digits = digits.contiguous()
    out = torch.zeros((C, 2, 256), dtype=torch.int32, device=x.device)
    kernels.check_cuda_device("select_hist", cols, digits)
    kernels.launch(
        "select_hist",
        [int(x.dtype == torch.float64), cols.data_ptr(), C, L, s_col, s_row, digits.data_ptr(), npass, pass_,
         _hist_rows(C, L, kernels.sm_count(x.device)), out.data_ptr()],
        x.device,
    )
    return out


def select_hist(x: torch.Tensor, digits: torch.Tensor, pass_: int, axis: int = 0) -> torch.Tensor:
    """One radix pass over the local keys of ``x`` along ``axis``: (C, 2,
    256) int32 counts of digit ``pass_`` (MSB first) of the keys matching
    each (column, rank)'s prefix, given by the first ``pass_`` of
    ``digits`` (C, 2, passes) uint8. CUDA tensors launch the ``select_hist``
    kernel; CPU tensors take the plain version."""
    if x.is_cuda:
        return _select_hist_cuda(x, digits, pass_, axis)
    return select_hist_plain(x, digits, pass_, axis)


def _decode(digits: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The floats whose keys are ``digits`` (..., passes), MSB first."""
    word = torch.int32 if dtype == torch.float32 else torch.int64
    k = digits.flip(-1).contiguous().view(word).squeeze(-1)  # little-endian bytes
    top = torch.iinfo(word).min
    return torch.where(k < 0, k ^ top, ~k).view(dtype)


def radix_pick(hist: torch.Tensor, rank: torch.Tensor, digits: torch.Tensor, pass_: int) -> torch.Tensor:
    """Resolve pass ``pass_``'s digit of each (column, rank) from the
    totals ``hist`` (C, 2, 256) into ``digits``; returns the ranks within
    the chosen bins. The digit is the first bin whose running count passes
    the rank (a rank past the count: the last digit)."""
    cum = hist.to(torch.int64).cumsum(-1)
    d = torch.clamp((cum <= rank[..., None]).sum(-1), max=255)
    before = torch.where(d > 0, cum.gather(-1, (d - 1).clamp(min=0)[..., None]).squeeze(-1), 0)
    digits[..., pass_] = d.to(torch.uint8)
    return rank - before


def sharded_masked_median(values: torch.Tensor, n_valid: torch.Tensor, mesh=None, axis: int = 0) -> torch.Tensor:
    """:func:`masked_median_select` over a reduced axis split over the ranks
    of ``mesh``: each rank holds its rows of ``values`` (+inf at excluded
    entries), and ``n_valid`` is the per-column count of valid entries over
    every rank. Each of the 4 (float32) or 8 (float64) radix passes is one
    ``select_hist`` launch and an all-reduce of its (C, 2, 256) int32
    counts; the decoded keys are the elements a sort of the whole axis puts
    at the two middle ranks, so the median is bit for bit the unsharded
    one. ``mesh=None`` runs the passes on one rank."""
    from pydeseq2_tpu_torch.parallel.mesh import all_reduce_sum

    dev = values.device
    n_valid = torch.as_tensor(n_valid, dtype=torch.int64, device=dev)
    red_shape = values.movedim(axis, -1).shape[:-1]
    n = n_valid.expand(red_shape).reshape(-1)
    rank = torch.stack([torch.clamp((n - 1) // 2, min=0), n // 2], dim=-1)  # (C, 2)
    npass = _passes(values.dtype)
    digits = torch.zeros(rank.shape + (npass,), dtype=torch.uint8, device=dev)
    for p in range(npass):
        rank = radix_pick(all_reduce_sum(select_hist(values, digits, p, axis), mesh), rank, digits, p)
    v = _decode(digits, values.dtype)  # (C, 2)
    med = ((v[:, 0] + v[:, 1]) / 2.0).reshape(red_shape)
    return torch.where(n_valid > 0, med, torch.full_like(med, float("nan")))
